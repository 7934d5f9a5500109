"""The headline pipeline of the PyTorch port (batch -> DTI -> GQI ->
device peaks -> stream -> .trk) against the JAX package on one small
phantom, plus the port's batch, lazy-volume and handoff surface.

Tolerances as in test_torch_dti.py / test_torch_gqi.py /
test_torch_stream.py; here each package runs its whole chain, so the
stream inputs (FA mask, peaks) are each package's own.
"""

import os

import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu_torch.core.handoff import DevicePeaks, split_unit_amp

from phantom import make_phantom
from test_torch_stream import _compare_tracts, as_port


def _run(pkg, dwi, mask, trk, **kw):
    b = pkg.prepare_batch(dwi, mask, wire="f32", **kw)
    dti = pkg.dti_fit(dwi, mask, batch=b)
    gqi = pkg.gqi_rec(dwi, mask, pkg.sphere_642, batch=b)
    pk = pkg.peaks_to_ovecs(gqi, device=True).first(1)
    tr = pkg.stream(pk, fa=dti.fa, mask=mask, nsub=3, f_thresh=0.0,
                    wire="f32", trk_sink=trk)
    return dti, gqi, tr


@pytest.mark.parametrize("kind", ["phantom", "brain"])
def test_pipeline_matches_jax(tmp_path, kind):
    if kind == "phantom":
        dwi, mask, _, _ = make_phantom(shape=(12, 12, 12), ndir=30)
    else:
        from fibers_tpu_torch.utils.phantom import make_brain
        dwi, mask, _ = make_brain(shape=(20, 20, 14), ndir=34)
    dj, gj, tj = _run(ft, dwi, mask, str(tmp_path / "jax.trk"))
    dt, gt, tr = _run(tt, dwi, mask, str(tmp_path / "torch.trk"),
                      device="cpu")

    np.testing.assert_allclose(dt.fa.vol, dj.fa.vol, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dt.md.vol, dj.md.vol, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gt.qa[0].vol, gj.qa[0].vol, atol=1e-5,
                               rtol=0)
    valid = (gj.qa[0].vol > 0) & (gt.qa[0].vol > 0)
    assert np.array_equal(gt.peak[0].vol[valid], gj.peak[0].vol[valid])

    assert tj.n_count > 0
    back_t = tt.trk_read(str(tmp_path / "torch.trk"))
    back_j = ft.trk_read(str(tmp_path / "jax.trk"))
    assert back_t.n_count == tr.n_count
    assert np.array_equal(back_t.npts, tr.npts)
    # equal line counts, >= 99% of lines of equal length, and the points of
    # every line of equal length within atol=1e-4
    _compare_tracts(back_j, back_t)


def test_prepare_batch_matches_jax():
    dwi, mask, _, _ = make_phantom(shape=(6, 5, 4), ndir=30)
    bj = ft.prepare_batch(dwi, mask, wire="f32")
    bt = tt.prepare_batch(dwi, mask, wire="f32", device="cpu")
    assert np.array_equal(bt.idx, bj.idx)
    assert bt.n == bj.n and bt.n_pad == bj.n_pad == 1024
    assert np.array_equal(bt.signals.numpy(), np.asarray(bj.signals))
    assert bt.signals.dtype == torch.float32


@pytest.mark.parametrize("wire", ["u16", "u12", "u8", "auto8"])
def test_prepare_batch_quantized_wires_raise(wire):
    """The quantized wires no longer raise: the decoded batch is the
    reference's bit for bit (on its CPU backend "auto8" is exact)."""
    dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=12)
    bt = tt.prepare_batch(dwi, mask, wire=wire, device="cpu")
    bj = ft.prepare_batch(dwi, mask, wire=wire)
    assert bt.signals.dtype == torch.float32
    assert np.array_equal(bt.signals.numpy(), np.asarray(bj.signals))


def test_prepare_batch_rejects_mesh_and_unknown_wire():
    """A `mesh=` that is not a port `Mesh` (e.g. a jax one) and an
    unknown wire are refused."""
    dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=12)
    with pytest.raises(TypeError, match="Mesh"):
        tt.prepare_batch(dwi, mask, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="wire"):
        tt.prepare_batch(dwi, mask, wire="f16", device="cpu")


def test_lazy_volume_materializes_through_mri():
    from fibers_tpu_torch.core.lazy import LazyVolume
    idx = np.array([0, 5, 7])
    vals = torch.arange(8, dtype=torch.float32).reshape(4, 2)  # 1 pad row
    m = tt.MRI(vol=np.zeros((2, 2, 2), np.float32))
    m.vol = LazyVolume(vals, idx, (2, 2, 2), 2)
    v = m.vol
    assert isinstance(v, np.ndarray) and v.shape == (2, 2, 2, 2)
    flat = v.reshape(-1, 2)
    assert np.array_equal(flat[[0, 5, 7]], vals[:3].numpy())
    assert flat[[1, 2, 3, 4, 6]].sum() == 0


def test_device_peaks_first_and_split():
    dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=12)
    vecs = np.random.default_rng(0).standard_normal((27, 3, 3))
    pk = DevicePeaks.from_numpy(vecs, np.ones((27, 3)), np.arange(27), mask,
                                "cpu")
    one = pk.first(1)
    assert one.nvec == 1 and one.shape3 == (3, 3, 3)
    u, a = split_unit_amp(pk.vecs)
    np.testing.assert_allclose(torch.linalg.norm(u, dim=-1).numpy(), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.linalg.norm(vecs, axis=-1),
                               rtol=1e-6)


def test_write_results(tmp_path):
    dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
    base = str(tmp_path / "fit")
    tt.dti_write(tt.dti_fit(dwi, mask, device="cpu"), base + "_dti")
    tt.gqi_write(tt.gqi_rec(dwi, mask, ft.sphere_362, device="cpu"),
                 base + "_gqi")
    for f in ("dti_fa", "dti_eigvec1", "gqi_odf", "gqi_peak1", "gqi_qa3"):
        assert os.path.isfile(f"{base}_{f}.nii.gz"), f


def _reference_names():
    """Every public name of fibers_tpu/__init__.py: its imports and the
    names its lazy `__getattr__` resolves."""
    import ast
    import pathlib
    src = (pathlib.Path(ft.__file__)).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Name) and node.left.id == "name":
            for c in node.comparators:
                for e in ast.walk(c):
                    if isinstance(e, ast.Constant) and isinstance(e.value,
                                                                  str):
                        names.add(e.value)
    return sorted(n for n in names if not n.startswith("_")
                  and n != "annotations")


@pytest.mark.parametrize("name", _reference_names())
def test_every_reference_name_resolves(name):
    """The port resolves every public name of the JAX package; none
    raises NotImplementedError any more."""
    assert getattr(tt, name) is not None


def _mesh_cases():
    """One call per entry point that takes `mesh=`, each given an object
    that is not a port `Mesh`; the CLI with `--mesh 2` on the CPU."""
    from test_dsi import make_dsi_phantom
    from test_torch_modes import _lcm_corridor

    def st_recon():
        tt.st_recon(np.ones((4, 4, 4), np.float32), 1.0, 1.0, mesh=object(),
                    device="cpu")

    def dsi_rec():
        dwi, mask, _ = make_dsi_phantom(shape=(2, 2, 2))
        tt.dsi_rec(dwi, mask, mesh=object(), device="cpu")

    def stream_lcm():
        ov, mask, seed, lcmm = _lcm_corridor()
        tt.stream(as_port(ov), mask=mask, seed=seed, lcms=lcmm, mesh=object(),
                  device="cpu")

    def cli(tmp_path):
        from fibers_tpu_torch.__main__ import main
        dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=12)
        dp, mp = str(tmp_path / "d.nii.gz"), str(tmp_path / "m.nii.gz")
        tt.mri_write(as_port(dwi), dp)
        tt.mri_write(as_port(mask), mp)
        return main(["--device", "cpu", "pipeline", dp, mp,
                     str(tmp_path / "out"), "--mesh", "2"])

    return {"st_recon": st_recon, "dsi_rec": dsi_rec,
            "stream_lcm": stream_lcm, "cli": cli}


@pytest.mark.parametrize("entry", ["st_recon", "dsi_rec", "stream_lcm",
                                   "cli"])
def test_mesh_raises_naming_a13(entry, tmp_path):
    """`mesh=` is ported (ROADMAP A13 is done): an entry point refuses an
    object that is not a port `Mesh` with a TypeError naming it, and the
    CLI's `--mesh 2` runs on two CPU shards."""
    fn = _mesh_cases()[entry]
    if entry == "cli":
        assert fn(tmp_path) == 0
        assert os.path.isfile(str(tmp_path / "out" / "tracts.trk"))
        return
    with pytest.raises(TypeError, match="Mesh"):
        fn()


def test_device_resolution():
    """None means the card; without one it raises and names the way to
    ask for the CPU."""
    from fibers_tpu_torch import device
    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            device.resolve(None)
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.cuda
def test_pipeline_card_matches_cpu(tmp_path):
    """The whole slice on the card against the same slice on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from fibers_tpu_torch.ops.kernels.gqi_fused import gqi_fused
    from fibers_tpu_torch.utils.phantom import make_brain
    dwi, mask, _ = make_brain(shape=(20, 20, 14), ndir=34)
    before = gqi_fused.launches
    dg, gg, tg = _run(tt, dwi, mask, str(tmp_path / "g.trk"), device="cuda")
    assert gqi_fused.launches == before + 1
    dc, gc, tc = _run(tt, dwi, mask, str(tmp_path / "c.trk"), device="cpu")
    np.testing.assert_allclose(dg.fa.vol, dc.fa.vol, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gg.qa[0].vol, gc.qa[0].vol, atol=1e-4, rtol=0)
    assert abs(tg.n_count - tc.n_count) <= 0.005 * tc.n_count
