"""The PyTorch port never imports jax, nor the JAX package.

The test process has jax loaded already (conftest.py), so the check runs
in a fresh interpreter: import the port, run DTI, GQI, RUMBA-SD, DSI, the
structure tensor, the deterministic, LCM and microscopy tractography, the
volume and .trk writers and the CLI on tiny phantoms, and look at
sys.modules (tests/test_torch_selfcontained.py reads the same run for
`fibers_tpu`).
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
from fibers_tpu_torch.utils.phantom import (make_dsi_brain, make_lcm_field,
                                            make_micro_field)
ddwi, dmask, _ = make_dsi_brain(small=True)
dsi = tt.dsi_rec(ddwi, dmask, tt.sphere_362, device="cpu")
assert np.isfinite(dsi.qa[0].vol).all()
evec, evals = tt.st_recon(dwi.vol.mean(axis=3), 1.0, 2.0, device="cpu")
assert np.isfinite(evals).all()
ovecs, lcm, lmask = make_lcm_field((12, 12))
assert tt.stream(ovecs, mask=lmask, lcms=lcm, device="cpu").n_scalars == 1
mov, mmask = make_micro_field((12, 12, 2))
assert tt.stream(mov, mask=mmask, nsub=0, device="cpu").n_count > 0
from fibers_tpu_torch.__main__ import main
import os, tempfile
with tempfile.TemporaryDirectory() as d:
    tt.mri_write(dmask, os.path.join(d, "m.nii.gz"))
    tt.mri_write(dmask, os.path.join(d, "m.mgz"))
    tt.trk_write(tr, os.path.join(d, "t.trk"))
    assert tt.trk_read(os.path.join(d, "t.trk")).n_count == tr.n_count
    assert main(["info", os.path.join(d, "m.nii.gz")]) == 0
    assert main(["--device", "cpu", "structens", os.path.join(d, "m.mgz"),
                 os.path.join(d, "st")]) == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib"))
ref = sorted(m for m in sys.modules if m == "fibers_tpu"
             or m.startswith("fibers_tpu."))
print("JAX_MODULES", bad)
print("REFERENCE_MODULES", ref)
sys.exit(1 if bad or ref else 0)
"""


def run_child():
    """Every path of the port in a fresh interpreter; the finished
    process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_runs_without_importing_jax():
    proc = run_child()
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
