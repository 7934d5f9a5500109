"""Display utilities: LUT, header info, terminal slice display, matplotlib
slice viewer.

(reference: src/show.jl)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.geometry import vox2ras_to_orient
from ..core.mri import MRI

__all__ = ["LUT", "color_lut", "vol_to_rgb", "info", "disp", "view_axes",
           "show_slice"]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


@dataclass
class LUT:
    """Segmentation/tract look-up table.  (reference: src/show.jl:16-46)"""

    id: np.ndarray
    name: List[str]
    rgb: np.ndarray     # [n, 3] floats in [0, 1]

    @classmethod
    def from_file(cls, infile: str) -> "LUT":
        """Read a FreeSurferColorLUT.txt-format table."""
        if not os.path.isfile(infile):
            raise FileNotFoundError(f"{infile} is not a regular file")
        ids, names, rgb = [], [], []
        with open(infile) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) < 6:
                    continue
                ids.append(int(parts[0]))
                names.append(parts[1])
                rgb.append([int(parts[2]) / 255.0, int(parts[3]) / 255.0,
                            int(parts[4]) / 255.0])
        return cls(**_sorted_lut(np.asarray(ids), names,
                                 np.asarray(rgb, np.float64)))


def _sorted_lut(ids, names, rgb):
    """Sort by id so segmentation lookups can binary-search."""
    order = np.argsort(ids, kind="stable")
    return dict(id=ids[order], name=[names[i] for i in order],
                rgb=rgb[order])


def _load_default_lut() -> LUT:
    with np.load(os.path.join(_DATA_DIR, "fs_lut.npz")) as z:
        return LUT(**_sorted_lut(z["id"], [str(s) for s in z["name"]],
                                 z["rgb"].astype(np.float64) / 255.0))


color_lut = _load_default_lut()


def vol_to_rgb(vol: np.ndarray, maxint: Optional[float] = None):
    """Convert an image array to RGB (or grayscale) for display.

    Heuristics match the reference (src/show.jl:71-99): all-LUT-IDs ->
    segmentation colors; unit-norm size-3 axis -> vector map; otherwise
    grayscale.  Returns ([..., 3] RGB array, kind string).
    """
    # Segmentation detection needs np.unique over the volume — O(n log n)
    # on multi-GB inputs.  Gate on cheap necessary conditions first: LUT
    # ids are small non-negative integers, so any fractional/negative/
    # large value rules a segmentation out without the full sort.
    lut_max = float(color_lut.id[-1])
    could_be_seg = (np.issubdtype(np.asarray(vol).dtype, np.integer)
                    or vol.size <= (1 << 22))
    if not could_be_seg:
        probe = np.asarray(vol).reshape(-1)[:: max(1, vol.size // 4096)]
        could_be_seg = bool(((probe >= 0) & (probe <= lut_max)
                             & (probe == np.floor(probe))).all())
    if could_be_seg:
        vals = np.unique(vol)
        if np.isin(vals, color_lut.id).all():
            lut_idx = np.searchsorted(color_lut.id, vol.astype(np.int64))
            lut_idx = np.clip(lut_idx, 0, len(color_lut.id) - 1)
            return color_lut.rgb[lut_idx], "segmentation"

    for idim in np.nonzero(np.asarray(vol.shape) == 3)[0]:
        ss = (vol ** 2).sum(axis=idim, keepdims=True)
        zero = np.all(vol == 0, axis=idim, keepdims=True)
        if np.all(np.isclose(ss, 1, atol=1e-3) | zero):
            rgb = np.abs(np.moveaxis(vol, idim, -1))
            return rgb, "vector"

    if maxint is None:
        maxint = vol.max() if vol.max() > 0 else 1.0
    g = np.minimum(vol, maxint) / maxint
    return np.stack([g, g, g], axis=-1), "gray"


def info(mri: MRI) -> None:
    """Print basic header info.  (reference: src/show.jl:108-121)"""
    if mri.fspec:
        print("Read from: " + mri.fspec)
    shape = list(mri.vol.shape) if np.asarray(mri.vol).size \
        else [int(v) for v in mri.volsize[:3]] + [int(mri.nframes)]
    print("Volume dimensions: " + str(shape))
    print("Spatial resolution: " + str([float(v) for v in mri.volres]))
    if mri.bval is not None and len(mri.bval):
        print("b-values: " + str([float(v) for v in np.unique(mri.bval)]))
    if np.asarray(mri.vol).size:         # header-only reads skip payload
        print("Intensity range: " + str([float(mri.vol.min()),
                                         float(mri.vol.max())]))


def disp(mri: MRI, mrimod: Optional[MRI] = None) -> None:
    """Quick terminal display of the middle non-empty slice as ANSI
    half-block art, plus header info.  (reference: src/show.jl:135-219)"""
    vol = mri.vol if mri.vol.ndim == 4 else mri.vol[..., None]

    nonzero_z = np.nonzero(vol.any(axis=(0, 1, 3)))[0]
    if len(nonzero_z) == 0:
        print("(empty volume)")
        info(mri)
        return
    iz = nonzero_z[len(nonzero_z) // 2]

    sl = vol[:, :, iz, :]
    ys = np.nonzero(sl.any(axis=(0, 2)))[0]
    xs = np.nonzero(sl[:, ys, :].any(axis=(1, 2)))[0]
    sl = sl[xs[0]:xs[-1] + 1, ys[0]:ys[-1] + 1]

    cols = 80
    try:
        cols = os.get_terminal_size().columns
    except OSError:
        pass
    nsub = max(1, int(np.ceil(sl.shape[0] / cols)))
    sl = sl[::nsub, ::nsub]

    # 3-frame slices may be vector maps; otherwise display the first
    # frame, normalized by the slice's ALL-frame max like the reference
    # (vol_to_rgb runs on every frame before frame 1 is kept,
    # src/show.jl:169-172)
    if sl.shape[-1] == 3:
        rgb, kind = vol_to_rgb(sl)
    else:
        rgb, kind = vol_to_rgb(
            sl[..., 0], maxint=float(sl.max()) if sl.max() > 0 else None)

    # Zero voxels are transparent (alpha channel in the reference,
    # src/show.jl:188-191): render them as the terminal default colors
    # instead of black, and keep them transparent under modulation.
    alpha = (rgb != 0).any(axis=-1)

    if mrimod is not None:
        if mrimod.vol.shape[:3] != mri.vol.shape[:3]:
            raise ValueError(
                f"Dimension mismatch between main image "
                f"{mri.vol.shape[:3]} and modulation image "
                f"{mrimod.vol.shape[:3]}")
        mod = mrimod.vol[xs[0]:xs[-1] + 1:nsub, ys[0]:ys[-1] + 1:nsub, iz]
        mod = np.squeeze(mod) / max(float(mrimod.vol.max()), 1e-30)
        rgb = rgb * mod[..., None]

    _ansi_show(np.clip(rgb, 0, 1), alpha)
    print()
    info(mri)


def _ansi_show(rgb: np.ndarray, alpha: Optional[np.ndarray] = None) -> None:
    """Render a [w, h, 3] RGB array in the terminal with half blocks;
    cells with alpha False use the terminal's default colors
    (the transparency of the reference's RGBA compositing)."""
    img = np.transpose(rgb, (1, 0, 2))      # rows = h
    a = np.ones(img.shape[:2], bool) if alpha is None else alpha.T
    h, w, _ = img.shape
    for y in range(0, h - 1, 2):
        line = []
        for x in range(w):
            rt, gt, bt = (int(c * 255) for c in img[y, x])
            rb, gb, bb = (int(c * 255) for c in img[y + 1, x])
            fg = f"\x1b[38;2;{rt};{gt};{bt}m" if a[y, x] else "\x1b[39m"
            bg = f"\x1b[48;2;{rb};{gb};{bb}m" if a[y + 1, x] else "\x1b[49m"
            line.append(fg + bg + ("▀" if a[y, x] else " "))
        print("".join(line) + "\x1b[0m")


def view_axes(vox2ras: np.ndarray, plane: str):
    """Display axes (1-based, negative = flipped) for viewing `plane`
    ('a', 's', 'c').  (reference: src/show.jl:229-258)"""
    orient = vox2ras_to_orient(vox2ras)

    def find(letters):
        for i, c in enumerate(orient):
            if c in letters:
                return i + 1
        raise ValueError(f"No axis among {letters} in {orient}")

    if plane == "a":
        ax1 = find("AP")
        if orient[ax1 - 1] == "A":
            ax1 = -ax1
        ax2 = find("RL")
        if orient[abs(ax2) - 1] == "R":
            ax2 = -ax2
    elif plane == "s":
        ax1 = find("SI")
        if orient[ax1 - 1] == "S":
            ax1 = -ax1
        ax2 = find("AP")
        if orient[abs(ax2) - 1] == "P":
            ax2 = -ax2
    elif plane == "c":
        ax1 = find("SI")
        if orient[ax1 - 1] == "S":
            ax1 = -ax1
        ax2 = find("RL")
        if orient[abs(ax2) - 1] == "R":
            ax2 = -ax2
    else:
        raise ValueError("Valid viewing planes are: ('a', 's', 'c')")

    return [ax1, ax2]


def show_slice(mri: MRI, plane: str = "a", z: Optional[int] = None,
               t: Optional[int] = None, title: Optional[str] = None):
    """Matplotlib slice view with anatomical-direction annotations.

    Counterpart of the reference's Plots.jl `Base.show` overload
    (reference: src/show.jl:268-379).  Returns the matplotlib figure;
    requires matplotlib (gated import).
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    ax_pair = view_axes(mri.vox2ras, plane)
    ax1, ax2 = abs(ax_pair[0]), abs(ax_pair[1])
    flip1, flip2 = ax_pair[0] < 0, ax_pair[1] < 0

    if mri.ispermuted:
        ax1 = {1: 2, 2: 1}.get(ax1, ax1)
        ax2 = {1: 2, 2: 1}.get(ax2, ax2)

    ax3 = ({1, 2, 3} - {ax1, ax2}).pop()

    vol = mri.vol if mri.vol.ndim == 4 else mri.vol[..., None]
    nz = vol.shape[ax3 - 1]
    if z is None:
        z = nz // 2

    imslice = np.take(vol, z, axis=ax3 - 1)
    if t is None:
        t = 0
        imslice = imslice[..., 0:3] if imslice.shape[-1] == 3 \
            else imslice[..., 0]
    else:
        imslice = imslice[..., t]

    pos = vol[vol > 0]
    maxint = float(np.quantile(pos, 0.999)) if pos.size else 1.0

    rgb, _ = vol_to_rgb(imslice, maxint)
    if ax1 > ax2:
        rgb = np.transpose(rgb, (1, 0, 2))
    if flip1:
        rgb = rgb[::-1]
    if flip2:
        rgb = rgb[:, ::-1]

    labels = {"a": (["A", "P"], ["R", "L"]),
              "s": (["S", "I"], ["P", "A"]),
              "c": (["S", "I"], ["R", "L"])}[plane]

    fig, axp = plt.subplots()
    axp.imshow(np.clip(rgb, 0, 1))
    axp.set_axis_off()
    axp.set_title(title if title is not None
                  else os.path.basename(mri.fspec))
    h, w = rgb.shape[:2]
    axp.text(w * 0.5, h * 0.02, labels[0][0], ha="center", va="top")
    axp.text(w * 0.5, h * 0.98, labels[0][1], ha="center", va="bottom")
    axp.text(w * 0.02, h * 0.5, labels[1][0], ha="left", va="center")
    axp.text(w * 0.98, h * 0.5, labels[1][1], ha="right", va="center")

    blabel = ""
    if mri.bval is not None and len(mri.bval):
        blabel = f"b={int(round(float(mri.bval[t])))}"
    if mri.bvec is not None and np.asarray(mri.bvec).size:
        g = mri.bvec[t]
        blabel += (f"\ng=[{round(float(g[0]) * 100) / 100},"
                   f"{round(float(g[1]) * 100) / 100},"
                   f"{round(float(g[2]) * 100) / 100}]")
    if blabel:
        axp.text(w * 0.02, h * 0.02, blabel, color="white",
                 ha="left", va="top")

    return fig
