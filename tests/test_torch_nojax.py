"""The PyTorch port never imports jax.

The test process has jax loaded already (conftest.py), so the check runs
in a fresh interpreter: import the port, run DTI, GQI, RUMBA-SD and
tractography on a tiny phantom, and look at sys.modules.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import numpy as np
import fibers_tpu_torch as tt
from fibers_tpu_torch.utils.phantom import make_brain

dwi, mask, _ = make_brain(shape=(16, 16, 12), ndir=34)
b = tt.prepare_batch(dwi, mask, device="cpu")
dti = tt.dti_fit(dwi, mask, batch=b)
gqi = tt.gqi_rec(dwi, mask, tt.sphere_362, batch=b)
tr = tt.stream(tt.peaks_to_ovecs(gqi, device=True).first(1), fa=dti.fa,
               mask=mask, f_thresh=0.0)
assert np.isfinite(dti.fa.vol).all() and gqi.odf.vol.shape[-1] == 181
assert tr.n_count > 0
rum = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=3, device="cpu")
tr2 = tt.stream(tt.peaks_to_ovecs(rum, device=True), mask=mask)
assert np.isfinite(rum.gfa.vol).all() and tr2.n_count > 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib"))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout


def test_no_module_of_the_port_imports_jax():
    for path in (REPO / "fibers_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:2] == ["import", "jax"]
                        or (words[:1] == ["from"] and len(words) > 1
                            and words[1].split(".")[0] in ("jax", "jaxlib"))
                        or words[:2] == ["import", "jaxlib"]), (path, line)
