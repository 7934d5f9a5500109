"""Interactive volume viewer (matplotlib).

Counterpart of the reference's ImageView-based `view` (reference:
src/view.jl:16; note the reference ships it disabled — the include is
commented out at src/Fibers.jl:7).  This implementation uses matplotlib
widgets: slice scrolling with arrow keys / mouse wheel, frame stepping,
and voxel-value readout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.mri import MRI
from .show import view_axes, vol_to_rgb

__all__ = ["view"]


def view(mri: MRI, plane: str = "a", title: Optional[str] = None,
         block: bool = False):
    """Open an interactive slice viewer.

    Scroll / up-down arrows change slice; left-right arrows change frame.
    Returns the matplotlib figure.
    """
    import matplotlib.pyplot as plt

    ax_pair = view_axes(mri.vox2ras, plane)
    ax1, ax2 = abs(ax_pair[0]), abs(ax_pair[1])
    flip1, flip2 = ax_pair[0] < 0, ax_pair[1] < 0
    ax3 = ({1, 2, 3} - {ax1, ax2}).pop()

    vol = mri.vol if mri.vol.ndim == 4 else mri.vol[..., None]
    nz = vol.shape[ax3 - 1]
    nt = vol.shape[3]

    pos = vol[vol > 0]
    maxint = float(np.quantile(pos, 0.999)) if pos.size else 1.0

    state = {"z": nz // 2, "t": 0}

    fig, axp = plt.subplots()
    axp.set_axis_off()

    def _slice_rgb():
        sl = np.take(vol, state["z"], axis=ax3 - 1)
        img = sl[..., 0:3] if (sl.shape[-1] == 3 and nt == 3) \
            else sl[..., state["t"]]
        rgb, _ = vol_to_rgb(img, maxint)
        if ax1 > ax2:
            rgb = np.transpose(rgb, (1, 0, 2))
        if flip1:
            rgb = rgb[::-1]
        if flip2:
            rgb = rgb[:, ::-1]
        return np.clip(rgb, 0, 1)

    im = axp.imshow(_slice_rgb())

    def _title():
        name = title if title is not None else mri.fspec
        axp.set_title(f"{name}  slice {state['z'] + 1}/{nz}  "
                      f"frame {state['t'] + 1}/{nt}")

    _title()

    def _redraw():
        im.set_data(_slice_rgb())
        _title()
        fig.canvas.draw_idle()

    def on_key(event):
        if event.key == "up":
            state["z"] = min(nz - 1, state["z"] + 1)
        elif event.key == "down":
            state["z"] = max(0, state["z"] - 1)
        elif event.key == "right":
            state["t"] = (state["t"] + 1) % nt
        elif event.key == "left":
            state["t"] = (state["t"] - 1) % nt
        else:
            return
        _redraw()

    def on_scroll(event):
        state["z"] = int(np.clip(state["z"] + (1 if event.button == "up"
                                               else -1), 0, nz - 1))
        _redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("scroll_event", on_scroll)

    if block:
        plt.show()
    return fig
