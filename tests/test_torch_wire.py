"""The quantized upload wires of the PyTorch port against the JAX package.

The host codecs (native/packio.c's gather_quant_*, or the numpy
expressions where the native library is missing) are copies of the
reference's, and the device decode multiplies by the scale rounded to
float32 as the reference does: u16, u12 and u8 batches are bit-equal to
`fibers_tpu.prepare_batch`'s on the same seeded volume, sharded or not.
RUMBA's fused signal producer quantizes the [0, 1] signal; its native b0
mean accumulates in double, so a row may sit one grid step from the
numpy expression's: the decoded rows are held to 0.5 grid steps of the
exact signal plus one float32 rounding of the decode (1e-6).
"""

import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.core import batch as ref_batch
from fibers_tpu_torch.core import batch as port_batch
from fibers_tpu_torch.models.rumba import _signal_host, _signal_wire
from fibers_tpu_torch.parallel.mesh import make_mesh

from phantom import make_phantom
from test_dsi import make_dsi_phantom

CODECS = ["u16", "u12", "u8"]


def _noisy(shape=(7, 6, 5), nvol=31, seed=0):
    """A volume with negative samples and a random mask (the codecs clip
    negatives to 0)."""
    rng = np.random.default_rng(seed)
    vol = (rng.standard_normal(shape + (nvol,)) * 40 + 60).astype(np.float32)
    dwi = ft.MRI(vol=vol)
    dwi.vox2ras0 = np.eye(4, dtype=np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = nvol
    dwi.set_geometry()
    mask = ft.MRI.like(dwi, 1, np.float32)
    mask.vol = (rng.random(shape) < 0.7).astype(np.float32)
    return dwi, mask


def _no_native(monkeypatch):
    from fibers_tpu_torch import native
    monkeypatch.setattr(native, "lib", lambda: None)


@pytest.mark.parametrize("nvol", [30, 31])
@pytest.mark.parametrize("wire", CODECS)
def test_batch_bit_equal_to_jax(wire, nvol):
    """Decoded batches equal the reference's bit for bit, an odd nvol
    (u12's pad field) included; on 8 CPU shards each shard decodes its
    own rows, and the whole equals the unsharded batch."""
    dwi, mask = _noisy(nvol=nvol)
    bj = ft.prepare_batch(dwi, mask, wire=wire)
    bt = tt.prepare_batch(dwi, mask, wire=wire, device="cpu")
    assert bt.signals.dtype == torch.float32 and bt.n_pad == bj.n_pad
    assert np.array_equal(bt.signals.numpy(), np.asarray(bj.signals))
    sh = tt.prepare_batch(dwi, mask, wire=wire,
                          mesh=make_mesh(8, device="cpu"))
    assert len(sh.signals.local()) == 8
    assert np.array_equal(sh.signals.numpy(), bt.signals.numpy())


@pytest.mark.parametrize("wire", CODECS)
def test_batch_error_bound(wire):
    """Each decoded sample is within half a grid step of the exact
    float32 row (negatives at 0), as tests/test_transfer.py bounds it."""
    dwi, mask = _noisy()
    exact = tt.prepare_batch(dwi, mask, wire="f32", device="cpu")
    q = tt.prepare_batch(dwi, mask, wire=wire, device="cpu")
    idx = exact.idx
    vmax = float(np.asarray(dwi.vol).reshape(-1, 31)[idx].max())
    scale = vmax / {"u16": 65535.0, "u12": 4095.0, "u8": 255.0}[wire]
    err = (q.signals - exact.signals.clamp_min(0)).abs().max()
    assert float(err) <= 0.51 * scale + 1e-6


def test_wire_scale_ignores_out_of_mask_artifacts():
    """The quantization range comes from the masked rows only
    (tests/test_transfer.py:test_wire_scale_ignores_out_of_mask_artifacts);
    the scale is the reference's."""
    dwi, mask, _, _ = make_phantom(shape=(8, 8, 6), ndir=12)
    vol = np.asarray(dwi.vol).copy()
    mv = np.asarray(mask.vol).copy()
    mv[0, 0, 0] = 0                       # exclude one corner voxel
    vol[0, 0, 0, :] = 1e6                 # ... and make it blinding
    flat = vol.reshape(-1, vol.shape[3])
    idx = np.flatnonzero(mv.reshape(-1) > 0)
    q, scale = port_batch._resolve_wire(flat, "u16", idx)
    assert (q, scale) == ref_batch._resolve_wire(flat, "u16", idx)
    assert scale <= flat[idx].max() / 65535.0 * 1.001
    _, scale_full = port_batch._resolve_wire(flat, "u16")
    assert scale_full > 10 * scale


@pytest.mark.parametrize("wire", CODECS)
def test_unquantizable_signal_raises(wire):
    """A volume with no finite positive maximum cannot set a scale."""
    dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=12)
    dwi.vol = np.zeros_like(np.asarray(dwi.vol))
    with pytest.raises(ValueError, match="positive"):
        tt.prepare_batch(dwi, mask, wire=wire, device="cpu")


@pytest.mark.parametrize("wire", CODECS + [None])
def test_native_gather_equals_numpy(wire, monkeypatch):
    """The OpenMP gather (+ quantize, + 12-bit pack) writes the bytes of
    the numpy expression, and a batch built without the native library
    equals one built with it."""
    from fibers_tpu_torch import native
    if native.lib() is None:
        pytest.skip("no C compiler: the native library did not build")
    dwi, mask = _noisy(nvol=31)
    flat = np.ascontiguousarray(np.asarray(dwi.vol).reshape(-1, 31))
    take = np.flatnonzero(np.asarray(mask.vol).reshape(-1) > 0)
    scale = float(flat[take].max()) / 4095.0
    nat = port_batch._gather_rows(flat, take, wire, scale)
    part = flat[take]
    ref = port_batch._quantize_rows(part, scale, wire) if wire else part
    assert nat.dtype == ref.dtype and np.array_equal(nat, ref)
    with_lib = tt.prepare_batch(dwi, mask, wire=wire or "f32", device="cpu")
    _no_native(monkeypatch)
    without = tt.prepare_batch(dwi, mask, wire=wire or "f32", device="cpu")
    assert np.array_equal(without.signals.numpy(), with_lib.signals.numpy())


def test_fits_on_a_u12_batch_match_jax():
    """DTI and GQI on the headline pipeline's u12 batch (bench.py) equal
    the reference's fits on its own u12 batch within the f32 tolerances
    of tests/test_torch_dti.py and test_torch_gqi.py.  The u12 fit's
    distance from the exact one is the reference's too: on the benchmark
    phantom's near-zero DWI samples a grid step moves FA by up to ~0.4
    on a few voxels."""
    from fibers_tpu_torch.utils.phantom import make_brain
    dwi, mask, _ = make_brain(shape=(20, 20, 14), ndir=34)
    bt = tt.prepare_batch(dwi, mask, wire="u12", device="cpu")
    bj = ft.prepare_batch(dwi, mask, wire="u12")
    dt, dj = (tt.dti_fit(dwi, mask, batch=bt),
              ft.dti_fit(dwi, mask, batch=bj))
    np.testing.assert_allclose(dt.fa.vol, dj.fa.vol, atol=1e-4, rtol=0)
    gt, gj = (tt.gqi_rec(dwi, mask, ft.sphere_362, batch=bt),
              ft.gqi_rec(dwi, mask, ft.sphere_362, batch=bj))
    np.testing.assert_allclose(np.asarray(gt.odf.vol),
                               np.asarray(gj.odf.vol), atol=1e-4, rtol=1e-6)
    exact = tt.dti_fit(dwi, mask, batch=tt.prepare_batch(
        dwi, mask, wire="f32", device="cpu"))
    m = mask.vol > 0
    d = np.abs(dt.fa.vol - exact.fa.vol)[m]
    assert np.percentile(d, 90) <= 1e-3


def _rumba_inputs():
    """(flat volume, masked rows, b0 flags) of the small config-4
    phantom; b0 as RUMBA's kernel takes it (the smallest b-value)."""
    from fibers_tpu_torch.utils.phantom import make_rumba_brain
    dwi, mask, _ = make_rumba_brain(small=True)
    vol = np.asarray(dwi.vol)
    flat = np.ascontiguousarray(vol.reshape(-1, vol.shape[3]), np.float32)
    idx = np.flatnonzero(np.asarray(mask.vol).reshape(-1) > 0)
    bval = np.asarray(dwi.bval, np.float32)
    return flat, idx, bval == bval.min()


def _signal_bytes(flat, idx, ib0, wire):
    """RUMBA's signal on its wire: the native producer's bytes, or the
    numpy expression's without the native library."""
    from fibers_tpu_torch import native
    exact = _signal_host(flat, idx, ib0)
    lib = native.lib()
    if lib is None:
        if wire == "u12":
            return port_batch._quantize_pack_u12(exact, 1.0 / 4095.0)
        return (exact * np.float32(65535.0) + np.float32(0.5)).astype(
            np.uint16)
    ncol = exact.shape[1]
    out = np.empty((len(idx), port_batch.u12_row_bytes(ncol)), np.uint8) \
        if wire == "u12" else np.empty((len(idx), ncol), np.uint16)
    ib0_i = np.flatnonzero(ib0).astype(np.int32)
    idwi_i = np.flatnonzero(~ib0).astype(np.int32)
    getattr(lib, f"rumba_signal_{wire}")(
        native.as_f32_ptr(flat), native.as_i64_ptr(idx.astype(np.int64)),
        len(idx), flat.shape[1], native.as_i32_ptr(ib0_i), len(ib0_i),
        native.as_i32_ptr(idwi_i), len(idwi_i),
        (native.as_u8_ptr if wire == "u12" else native.as_u16_ptr)(out))
    return out


@pytest.mark.parametrize("native_lib", [True, False])
@pytest.mark.parametrize("wire", ["u12", "u16"])
def test_rumba_signal_wire(wire, native_lib, monkeypatch):
    """RUMBA's signal through its upload wire: the rows the port decodes
    equal `fibers_tpu.core.batch._dequant12`/`_dequant` of the same
    bytes, lie within half a grid step (+1e-6) of the exact
    `_signal_host` matrix, and shard over a mesh with zero pad rows."""
    import jax.numpy as jnp
    from fibers_tpu_torch import native
    if not native_lib:
        _no_native(monkeypatch)
    elif native.lib() is None:
        pytest.skip("no C compiler: the native library did not build")
    flat, idx, ib0 = _rumba_inputs()
    got = _signal_wire(flat, idx, ib0, wire, "cpu")
    exact = _signal_host(flat, idx, ib0)
    step = 1.0 / (4095.0 if wire == "u12" else 65535.0)
    assert got.shape == exact.shape and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - exact).max()) <= 0.5 * step + 1e-6

    raw = _signal_bytes(flat, idx, ib0, wire)
    if wire == "u12":
        want = ref_batch._dequant12(jnp.asarray(raw), step, exact.shape[1])
    else:
        want = ref_batch._dequant(jnp.asarray(raw), step)
    assert np.array_equal(got.numpy(), np.asarray(want))

    sh = _signal_wire(flat, idx, ib0, wire, None,
                      mesh=make_mesh(8, device="cpu"))
    rows = sh.numpy()
    assert rows.shape[0] % 8 == 0 and not rows[len(idx):].any()
    assert np.array_equal(rows[:len(idx)], got.numpy())


def test_dsi_on_a_u8_batch():
    """DSI on u8 batches: the port's fit equals the reference's on its
    own u8 batch (tests/test_torch_dsi.py's tolerances), and stays within
    5e-3 of the ODF maximum and 2 degrees of peak 1 of the exact fit
    (tests/test_transfer.py:test_u8_dsi_peak_parity)."""
    dwi, mask, _ = make_dsi_phantom(shape=(5, 5, 5), axis=(1, 0.3, 0.1))
    bt = tt.prepare_batch(dwi, mask, wire="u8", device="cpu")
    d_q = tt.dsi_rec(dwi, mask, ft.sphere_362, batch=bt)
    d_j = ft.dsi_rec(dwi, mask, ft.sphere_362,
                     batch=ft.prepare_batch(dwi, mask, wire="u8"))
    d_f = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu")
    odf_q, odf_f = np.asarray(d_q.odf.vol), np.asarray(d_f.odf.vol)
    np.testing.assert_allclose(odf_q, np.asarray(d_j.odf.vol), atol=1e-6,
                               rtol=0)
    assert np.abs(odf_q - odf_f).max() <= 5e-3 * np.abs(odf_f).max()
    pk_f, pk_q = d_f.peak[0].vol, d_q.peak[0].vol
    nrm = np.linalg.norm(pk_f, axis=-1) * np.linalg.norm(pk_q, axis=-1)
    live = nrm > 0
    assert live.any()
    cosang = np.abs((pk_f * pk_q).sum(-1)[live]) / nrm[live]
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))).max() < 2.0


# ------------------------------------------------------------------ #
# On the card: the device decode and the 6-bit packing
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nvol", [30, 31])
def test_u12_decode_on_card_equals_cpu(cuda, nvol):
    raw = np.random.default_rng(nvol).integers(
        0, 256, (1000, port_batch.u12_row_bytes(nvol))).astype(np.uint8)
    cpu = port_batch._dequant12(torch.from_numpy(raw), 0.37 / 4095, nvol)
    card = port_batch._dequant12(torch.from_numpy(raw).to(cuda),
                                 0.37 / 4095, nvol)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", CODECS)
def test_batch_on_card_equals_cpu(cuda, wire):
    """The whole upload on the card (pinned buffer, one copy, decode)
    gives the CPU's batch bit for bit, sharded on one card too."""
    from fibers_tpu_torch.parallel.mesh import Mesh
    dwi, mask = _noisy(nvol=31)
    cpu = tt.prepare_batch(dwi, mask, wire=wire, device="cpu")
    card = tt.prepare_batch(dwi, mask, wire=wire, device=cuda)
    assert torch.equal(card.signals.cpu(), cpu.signals)
    mesh = Mesh(np.array([cuda, cuda], dtype=object), ("data",))
    sh = tt.prepare_batch(dwi, mask, wire=wire, mesh=mesh)
    assert torch.equal(sh.signals.cpu(), cpu.signals)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["u12", "u16"])
def test_rumba_signal_on_card_equals_cpu(cuda, wire):
    flat, idx, ib0 = _rumba_inputs()
    cpu = _signal_wire(flat, idx, ib0, wire, "cpu")
    card = _signal_wire(flat, idx, ib0, wire, cuda)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_pack6_on_card_equals_cpu(cuda):
    from fibers_tpu_torch.tract.stream import _pack6
    q = torch.from_numpy(np.random.default_rng(6).integers(
        -31, 32, 100_003).astype(np.int8))
    assert torch.equal(_pack6(q.to(cuda)).cpu(), _pack6(q))
