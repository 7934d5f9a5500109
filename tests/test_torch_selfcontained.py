"""The PyTorch port stands alone and runs on the card by default.

- No module of `fibers_tpu_torch`, and neither `chip_smoke.py` nor
  `probe_paths.py`, imports the JAX package `fibers_tpu` (AST scan), and
  a fresh interpreter that runs every path of the port leaves no
  `fibers_tpu` module in `sys.modules`.
- `device=None` means the card: without one every entry point raises
  and names `device="cpu"`; on the card (`cuda` marker) it runs there.
"""

import ast

import numpy as np
import pytest
import torch

import fibers_tpu_torch as tt
from fibers_tpu_torch import device as tdevice

from test_torch_nojax import REPO, run_child


def _sources():
    yield from sorted((REPO / "fibers_tpu_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"
    yield REPO / "probe_paths.py"


def _is_reference(name):
    return name == "fibers_tpu" or name.startswith("fibers_tpu.")


def _reference_imports(path):
    """(line, module) of every import of the JAX package in `path`:
    import statements and importlib/__import__ calls on a constant."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if _is_reference(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _is_reference(node.module or ""):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            arg = node.args[0]
            if (name in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and _is_reference(arg.value)):
                found.append((node.lineno, arg.value))
    return found


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    assert _reference_imports(path) == []


def test_the_scan_covers_the_parallel_package():
    """`parallel/` (the mesh, the process group, the fused step) is among
    the scanned sources."""
    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {f"fibers_tpu_torch/parallel/{m}.py"
            for m in ("mesh", "distributed", "pipeline")} <= names


def test_the_scan_sees_an_import_of_the_jax_package(tmp_path):
    """The scan is not blind: each spelling of an import is found."""
    src = tmp_path / "m.py"
    src.write_text("import fibers_tpu\nfrom fibers_tpu.io import trk\n"
                   "import importlib\n"
                   "importlib.import_module('fibers_tpu.core.mri')\n"
                   "from fibers_tpu_torch.core import mri\n")
    assert [m for _, m in _reference_imports(src)] == [
        "fibers_tpu", "fibers_tpu.io", "fibers_tpu.core.mri"]


def test_every_path_runs_without_the_jax_package():
    proc = run_child()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REFERENCE_MODULES []" in proc.stdout


def test_resolve_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdevice.resolve(None)
    assert tdevice.resolve("cpu") == torch.device("cpu")


def _inputs():
    from fibers_tpu_torch.utils.phantom import make_brain, make_dsi_brain
    dwi, mask, _ = make_brain(shape=(6, 6, 4), ndir=12)
    ddwi, dmask, _ = make_dsi_brain(small=True)
    ov = tt.MRI.like(mask, 3, np.float32)
    ov.vol = np.zeros(mask.vol.shape + (3,), np.float32)
    ov.vol[..., 0] = 1.0
    return dict(dwi=dwi, mask=mask, ddwi=ddwi, dmask=dmask, ov=ov)


ENTRY_POINTS = {
    "prepare_batch": lambda d: tt.prepare_batch(d["dwi"], d["mask"]),
    "dti_fit": lambda d: tt.dti_fit(d["dwi"], d["mask"]),
    "adc_fit": lambda d: tt.adc_fit(d["dwi"], d["mask"]),
    "gqi_rec": lambda d: tt.gqi_rec(d["dwi"], d["mask"], tt.sphere_362),
    "dsi_rec": lambda d: tt.dsi_rec(d["ddwi"], d["dmask"], tt.sphere_362),
    "rumba_rec": lambda d: tt.rumba_rec(d["dwi"], d["mask"], tt.sphere_362,
                                        niter=2),
    "st_recon": lambda d: tt.st_recon(np.asarray(d["dwi"].vol)[..., 0],
                                      1.0, 1.0),
    "stream": lambda d: tt.stream(d["ov"], mask=d["mask"], nsub=1),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_a_card(entry,
                                                          monkeypatch):
    """No silent fall back to the CPU: an entry point called without
    `device=` asks for the card and names the way to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry](_inputs())


@pytest.mark.cuda
def test_resolve_none_is_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert tdevice.resolve(None) == torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_device_runs_on_the_card(entry):
    """Each entry point called without `device=` allocates its work on
    the card (PyTorch's count of CUDA allocations grows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    data = _inputs()

    def allocations():
        return torch.cuda.memory_stats().get("allocation.all.allocated", 0)

    before = allocations()
    ENTRY_POINTS[entry](data)
    torch.cuda.synchronize()
    assert allocations() > before
