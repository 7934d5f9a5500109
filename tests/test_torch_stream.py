"""Deterministic tractography of the PyTorch port held against the JAX
package and the per-line oracle.

Both packages propagate in float32 with the same operations, but XLA may
fuse a multiply and an add into one rounding where PyTorch rounds twice,
so a position can differ in its last bit and, rarely, round to another
voxel.  Hence: equal line counts, equal per-line point counts on >= 99%
of lines, and points within atol=1e-4 voxel on lines of equal length.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu_torch.core.handoff import DevicePeaks
from fibers_tpu_torch.parallel.mesh import make_mesh
from fibers_tpu_torch.utils import prng

from phantom import make_phantom


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, -5])
@pytest.mark.parametrize("nsub", [1, 3, 8])
def test_threefry_jitter_is_bit_exact(seed, nsub):
    """The seed jitter equals the reference's jax.random.uniform draw
    (fibers_tpu/tract/stream.py:1113-1116) bit for bit."""
    got = prng.uniform(prng.prng_key(seed), (nsub, 3), -0.5 + 1e-6,
                       0.5 - 1e-6)
    want = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (nsub, 3), minval=-0.5 + 1e-6,
        maxval=0.5 - 1e-6))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1, -5])
@pytest.mark.parametrize("num", [1, 2, 7, 300])
def test_threefry_split_is_bit_exact(seed, num):
    """split equals jax.random.split word for word (the LCM driver's key
    schedule, fibers_tpu/tract/modes.py:218-243)."""
    got = prng.split(prng.prng_key(seed), num)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)


def test_threefry_raw_bits_match_jax():
    key = prng.prng_key(42)
    got = prng.random_bits(key, (4, 5))
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(42), (4, 5),
                                      dtype=np.uint32))
    assert np.array_equal(got, want)


def _rebuild(obj, src, dst):
    """An MRI of class `src` (or a list of them) rebuilt as class `dst`
    from its fields; anything else as it is."""
    if isinstance(obj, (list, tuple)):
        return [_rebuild(o, src, dst) for o in obj]
    if not isinstance(obj, src):
        return obj
    out = dst.__new__(dst)
    out.__dict__.update(obj.__dict__)
    out.vol = np.asarray(obj.vol)
    return out


def as_port(obj):
    """The reference's MRIs as the port's.  The two packages have their
    own MRI classes, and `stream` tells one volume from a list, and
    `mri_write` a volume from a result struct, by its own class."""
    return _rebuild(obj, ft.MRI, tt.MRI)


def as_ref(obj):
    """The port's MRIs as the reference's."""
    return _rebuild(obj, tt.MRI, ft.MRI)


def _compare_tracts(tj, tt_, min_equal=0.99):
    assert tt_.n_count == tj.n_count
    nj, nt = np.asarray(tj.npts), np.asarray(tt_.npts)
    same = nj == nt
    assert same.mean() >= min_equal, same.mean()
    off_j = np.concatenate([[0], np.cumsum(nj)])
    off_t = np.concatenate([[0], np.cumsum(nt)])
    for i in np.flatnonzero(same):
        a = tj.packed_xyz[off_j[i]:off_j[i + 1]]
        b = tt_.packed_xyz[off_t[i]:off_t[i + 1]]
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                   err_msg=f"line {i}")


def _field(kind):
    """(dwi, mask) of the test phantom (one random axis per voxel) or a
    small cut of the benchmark brain (a smooth field, long lines)."""
    if kind == "phantom":
        dwi, mask, _, _ = make_phantom(shape=(12, 12, 12), ndir=30)
    else:
        from fibers_tpu_torch.utils.phantom import make_brain
        dwi, mask, _ = make_brain(shape=(20, 20, 14), ndir=34)
    return dwi, mask


@pytest.mark.parametrize("kind", ["phantom", "brain"])
def test_stream_from_device_peaks_matches_jax(kind):
    """The same orientation field (the JAX fit's DevicePeaks carried
    across) through both engines, exact float32 points."""
    dwi, mask = _field(kind)
    b = ft.prepare_batch(dwi, mask, wire="f32")
    fa = ft.dti_fit(dwi, mask, batch=b).fa
    pj = ft.peaks_to_ovecs(ft.gqi_rec(dwi, mask, ft.sphere_642, batch=b),
                           device=True).first(1)
    pt = DevicePeaks.from_numpy(np.asarray(pj.vecs), np.asarray(pj.amp),
                                pj.idx, pj.ref, "cpu")
    kw = dict(fa=fa, mask=mask, nsub=3, f_thresh=0.0, wire="f32")
    tj = ft.stream(pj, **kw)
    tr = tt.stream(pt, **kw)
    assert tr.n_count > 100
    _compare_tracts(tj, tr)


def _smooth_field(shape3=(14, 12, 10)):
    x, y, z = np.meshgrid(*[np.linspace(0, 1, s) for s in shape3],
                          indexing="ij")
    th = 0.6 * x + 0.9 * y + 0.3 * z
    ov = np.stack([np.cos(th), np.sin(th), 0.1 * np.ones_like(th)], axis=-1)
    ov /= np.linalg.norm(ov, axis=-1, keepdims=True)
    ovm = ft.MRI(vol=ov.astype(np.float32))
    ovm.vox2ras0 = np.eye(4, dtype=np.float32)
    ovm.volsize = np.asarray(shape3)
    ovm.width, ovm.height, ovm.depth = shape3
    ovm.nframes = 3
    ovm.set_geometry()
    mask = np.ones(shape3, bool)
    mask[:2] = False
    maskm = ft.MRI.like(ovm, 1, np.float32)
    maskm.vol = mask.astype(np.float32)
    return ovm, maskm, mask


def test_stream_lines_match_oracle():
    """Every line of a host orientation field against the per-seed
    transliteration of the reference (tests/oracle.py)."""
    from oracle import stream_line_oracle

    ovm, maskm, mask = _smooth_field()
    tr = tt.stream(as_port(ovm), mask=maskm, nsub=0, device="cpu")
    ovecs = np.asarray(ovm.vol)[..., None, :] * mask[..., None, None]
    ref = []
    for sv in np.argwhere(mask):
        line = stream_line_oracle(sv, np.zeros(3), ovecs, mask,
                                  len_max=max(mask.shape))
        if len(line) >= 3:
            ref.append(line)
    assert tr.n_count == len(ref)
    off = np.concatenate([[0], np.cumsum(tr.npts)])
    for i, line in enumerate(ref):
        np.testing.assert_allclose(tr.packed_xyz[off[i]:off[i + 1]], line,
                                   atol=1e-4, rtol=0, err_msg=f"line {i}")


def test_stream_host_field_with_jitter_matches_jax():
    ovm, maskm, _ = _smooth_field()
    tj = ft.stream(ovm, mask=maskm, nsub=3, seed_rng=3, wire="f32")
    tr = tt.stream(as_port(ovm), mask=maskm, nsub=3, seed_rng=3, device="cpu")
    _compare_tracts(tj, tr)


def test_stream_chunks_do_not_change_lines():
    ovm, maskm, _ = _smooth_field()
    a = tt.stream(as_port(ovm), mask=maskm, nsub=2, device="cpu")
    b = tt.stream(as_port(ovm), mask=maskm, nsub=2, device="cpu", chunk=97)
    assert np.array_equal(a.npts, b.npts)
    assert np.array_equal(a.packed_xyz, b.packed_xyz)


def test_stream_trk_sink_matches_tract(tmp_path):
    ovm, maskm, _ = _smooth_field()
    tr = tt.stream(as_port(ovm), mask=maskm, nsub=2, device="cpu", chunk=200)
    path = str(tmp_path / "lines.trk")
    ts = tt.stream(as_port(ovm), mask=maskm, nsub=2, device="cpu", chunk=200,
                   trk_sink=path)
    assert ts.n_count == tr.n_count
    assert np.array_equal(ts.npts, tr.npts)
    back = tt.trk_read(path)
    assert back.n_count == tr.n_count
    assert np.array_equal(back.npts, tr.npts)
    np.testing.assert_allclose(back.packed_xyz, tr.packed_xyz, atol=1e-5)


def test_stream_empty_seed_set(tmp_path):
    ovm, maskm, _ = _smooth_field()
    seed = ft.MRI.like(maskm, 1, np.float32)
    seed.vol = np.zeros(maskm.vol.shape, np.float32)
    path = str(tmp_path / "empty.trk")
    tr = tt.stream(as_port(ovm), mask=maskm, seed=seed, device="cpu",
                   trk_sink=path)
    assert tr.n_count == 0
    assert tt.trk_read(path).n_count == 0


@pytest.mark.parametrize("kw,exc", [
    (dict(wire="i8"), None),
    (dict(wire="i6"), None),
    (dict(wire="i4"), ValueError),
    # the sharded path too
    (dict(wire="i6", mesh=make_mesh(2, device="cpu")), None),
    (dict(bogus=1), TypeError),
])
def test_stream_unported_options_raise(kw, exc):
    """An unknown wire or option raises.  The quantized point wires run,
    sharded too: without smoothing the port's positions are the
    reference's bit for bit, and so are its i8/i6 lines."""
    ovm, maskm, _ = _smooth_field()
    if exc is not None:
        with pytest.raises(exc):
            tt.stream(as_port(ovm), mask=maskm, device="cpu", **kw)
        return
    got = tt.stream(as_port(ovm), mask=maskm, device="cpu", smooth_coeff=0.0,
                    **kw)
    want = ft.stream(ovm, mask=maskm, smooth_coeff=0.0, wire=kw["wire"])
    assert got.n_count == want.n_count > 0
    assert np.array_equal(got.npts, want.npts)
    assert np.array_equal(got.packed_xyz, want.packed_xyz)


def test_stream_exact_points_overrides_quantized_wire():
    ovm, maskm, _ = _smooth_field()
    a = tt.stream(as_port(ovm), mask=maskm, nsub=0, device="cpu")
    b = tt.stream(as_port(ovm), mask=maskm, nsub=0, device="cpu", wire="i8",
                  exact_points=True)
    assert np.array_equal(a.packed_xyz, b.packed_xyz)


def test_stream_out_of_bounds_seeds_are_guarded():
    """Seeds at the volume's edge step outside it at once; torch indexing
    must never see an out-of-range voxel (JAX would clamp)."""
    ovm, maskm, _ = _smooth_field()
    seed = ft.MRI.like(maskm, 1, np.float32)
    sv = np.zeros(maskm.vol.shape, np.float32)
    sv[-1, -1, -1] = sv[-1, 0, 0] = 1
    seed.vol = sv
    tr = tt.stream(as_port(ovm), mask=maskm, seed=seed, nsub=3, device="cpu")
    tj = ft.stream(ovm, mask=maskm, seed=seed, nsub=3, wire="f32")
    _compare_tracts(tj, tr)


def test_peaks_to_ovecs_host_lists():
    dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
    g = tt.gqi_rec(dwi, mask, ft.sphere_362, device="cpu")
    ov, fs = tt.peaks_to_ovecs(g)
    assert len(ov) == 3 and len(fs) == 3
    with pytest.raises(ValueError, match="device-resident"):
        tt.peaks_to_ovecs(type("R", (), {"peak": []})(), device=True)
    assert isinstance(tt.peaks_to_ovecs(g, device=True).vecs, torch.Tensor)


# ------------------------------------------------------------------ #
# The f-range quantiles
# ------------------------------------------------------------------ #

def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("n", [1, 2, 7, 100_000])
def test_quantiles_match_jnp(n):
    """The port's quantile against `jnp.quantile` (the reference's
    `_amp_quantiles`), within 1 ulp: XLA may fuse the interpolation's
    multiply and add into one rounding."""
    import jax.numpy as jnp
    from fibers_tpu_torch.tract.stream import _quantiles
    a = np.random.default_rng(n).random(n).astype(np.float32)
    got = _quantiles(torch.from_numpy(a), (1e-5, 0.9))
    for g, q in zip(got, (1e-5, 0.9)):
        assert _ulps(g, float(jnp.quantile(jnp.asarray(a), q))) <= 1, (q, g)
    a[n // 2] = np.nan
    assert all(np.isnan(g) for g in _quantiles(torch.from_numpy(a), (0.5,)))
    assert np.isnan(float(jnp.quantile(jnp.asarray(a), 0.5)))


def test_quantiles_above_2_24_values():
    """2^24 + 1 values, where `torch.quantile` raises: a descending ramp
    over a constant, held against `jnp.quantile`'s rule written out in
    numpy float32 on the sorted values (the position q * (f32(n) - 1),
    its floor and ceil neighbours, the fraction as the weight)."""
    from fibers_tpu_torch.tract.stream import _quantiles
    n = (1 << 24) + 1
    a = (np.float32(0.25) + np.arange(n, dtype=np.float32)
         * np.float32(2.0 ** -26))[::-1].copy()
    t = torch.from_numpy(a)
    with pytest.raises(RuntimeError):
        torch.quantile(t, 0.9)
    got = _quantiles(t, (1e-5, 0.9))
    srt = a[::-1]
    for g, q in zip(got, (1e-5, 0.9)):
        pos = np.float32(q) * (np.float32(n) - np.float32(1))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        w = pos - np.floor(pos)
        want = srt[lo] * (np.float32(1) - w) + srt[hi] * w
        assert _ulps(g, want) <= 1, (q, g, want)
    assert srt[167] <= got[0] <= srt[168]


def test_stream_f_range_warning_uses_the_quantiles(capsys):
    """`stream` over DevicePeaks with f_thresh > 0 prints the reference's
    warning when the threshold lies outside the amplitudes' range."""
    dwi, mask = _field("phantom")
    g = tt.gqi_rec(as_port(dwi), as_port(mask), tt.sphere_362, device="cpu")
    pk = tt.peaks_to_ovecs(g, device=True)
    tt.stream(pk, mask=as_port(mask), nsub=1, f_thresh=1e6)
    assert "f_thresh" in capsys.readouterr().err


# ------------------------------------------------------------------ #
# No host synchronisation inside a step
# ------------------------------------------------------------------ #

class _NoTorchTensor:
    """`torch.tensor` raises inside the block: on a CUDA device it is a
    blocking host-to-device copy, which a step loop must not make."""

    def __enter__(self):
        self._real = torch.tensor

        def raiser(*a, **k):
            raise AssertionError("torch.tensor called inside a step loop")
        torch.tensor = raiser

    def __exit__(self, *exc):
        torch.tensor = self._real


class _SyncIsAnError:
    """Any host synchronisation with the card raises inside the block."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def _guard_launches(monkeypatch, guard):
    """Run every chunk's propagation (`launch` of `stream._drive`) of the
    three engines under `guard`; the compaction and the fetch around it
    run unguarded.  Returns the list of guarded launches made."""
    from fibers_tpu_torch.tract import modes, stream as stream_mod
    real, made = stream_mod._drive, []

    def drive(launch, *args, **kwargs):
        def guarded(lo):
            with guard:
                out = launch(lo)
            made.append(lo)
            return out
        return real(guarded, *args, **kwargs)

    monkeypatch.setattr(stream_mod, "_drive", drive)
    monkeypatch.setattr(modes, "_drive", drive)
    return made


def _run_three_engines(device, wire="auto"):
    """One small deterministic, LCM and microscopy run; their tracts."""
    from fibers_tpu_torch.utils.phantom import (make_lcm_field,
                                                make_micro_field)
    ovm, maskm, _ = _smooth_field()
    det = tt.stream(as_port(ovm), mask=as_port(maskm), nsub=2, device=device,
                    chunk=500, wire=wire)
    ovecs, lcm, lmask = make_lcm_field((24, 24))
    lcm_t = tt.stream(ovecs, mask=lmask, lcms=lcm, device=device, wire=wire)
    mov, mmask = make_micro_field((20, 18, 2))
    mic = tt.stream(mov, mask=mmask, search_dist=5, device=device, nsub=None,
                    ang_thresh=None, step_size=None, smooth_coeff=None,
                    wire=wire)
    return det, lcm_t, mic


def test_step_loops_build_no_tensor_from_the_host(monkeypatch):
    """No `torch.tensor` call inside a propagation step of the three
    engines, in a compaction or in `peak_mask`; the guarded runs give the
    lines of unguarded ones."""
    from fibers_tpu_torch.ops.peaks import build_neighbors, peak_mask
    from fibers_tpu_torch.tract.stream import _compact
    want = _run_three_engines("cpu")
    made = _guard_launches(monkeypatch, _NoTorchTensor())
    got = _run_three_engines("cpu")
    assert len(made) >= 4                    # two chunks, then one each
    for a, b in zip(want, got):      # the LCM draws are counter-based
        assert a.n_count == b.n_count > 0
        assert np.array_equal(a.packed_xyz, b.packed_xyz)

    rng = np.random.default_rng(0)
    _, _, faces0 = tt.core.odf.half_sphere(tt.sphere_362)
    nbr, ok = build_neighbors(faces0, tt.sphere_362.nvert_half)
    o = torch.from_numpy(rng.random((4, nbr.shape[0])).astype(np.float32))
    fwd = torch.from_numpy(rng.random((5, 3, 3)).astype(np.float32))
    cnt = torch.tensor([2, 0, 5], dtype=torch.int32)
    keep = torch.tensor([True, False, True])
    off = torch.tensor([0, 0, 4], dtype=torch.int64)
    with _NoTorchTensor():
        pm = peak_mask(o, torch.from_numpy(nbr), torch.from_numpy(ok))
        pts = _compact(fwd, fwd + 1, cnt, cnt, keep, off, 14)
    assert pm.any() and pts.shape == (14, 3)
    assert torch.equal(pts[:2], fwd[:2, 0].flip(0))
    assert torch.equal(pts[2:4], fwd[:2, 0] + 1)


@pytest.mark.cuda
def test_step_loops_do_not_sync_on_card(monkeypatch):
    """Every chunk's propagation of the deterministic, LCM and microscopy
    engines runs with `torch.cuda.set_sync_debug_mode("error")`: no
    blocking copy and no `.item()` between two steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync debug mode is CUDA's")
    made = _guard_launches(monkeypatch, _SyncIsAnError())
    det, lcm_t, mic = _run_three_engines("cuda")
    assert len(made) >= 4
    assert det.n_count > 0 and lcm_t.n_count > 0 and mic.n_count > 0
    # the guard itself works: a blocking copy raises under it
    with pytest.raises(RuntimeError):
        with _SyncIsAnError():
            torch.ones(3, device="cuda").cpu()


@pytest.mark.cuda
def test_i6_step_loops_do_not_sync_on_card(monkeypatch):
    """The three engines' step loops with the i6 quantizer run under the
    sync debug mode too, and their lines keep the float32 run's point
    counts within the wire's bound (micro: exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync debug mode is CUDA's")
    exact = _run_three_engines("cuda", "f32")
    made = _guard_launches(monkeypatch, _SyncIsAnError())
    got = _run_three_engines("cuda", "i6")
    assert len(made) >= 4
    for a, b in zip(got, exact):     # the LCM draws are counter-based
        assert a.n_count == b.n_count > 0
        assert np.array_equal(a.npts, b.npts)
    for a, b in zip(got[:2], exact[:2]):
        assert np.abs(a.packed_xyz - b.packed_xyz).max() <= \
            2.0 / _qscale("i6")
    assert np.array_equal(got[2].packed_xyz, exact[2].packed_xyz)


# ------------------------------------------------------------------ #
# Quantized point wires (i8, i6)
# ------------------------------------------------------------------ #

def _qscale(wire, step=0.5):
    return (31 if wire == "i6" else 127) / step


@pytest.mark.parametrize("wire", ["i8", "i6"])
def test_stream_wire_trk_bytes_equal_jax(wire, tmp_path):
    """Without smoothing both engines' positions are bit-equal, and so
    are the i8/i6 deltas, anchors, decoded lines and .trk bytes (the
    port's quantizer rounds its step as XLA's fused multiply-add does)."""
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=3, seed_rng=3, smooth_coeff=0.0, wire=wire)
    tj = ft.stream(ovm, **kw)
    tr = tt.stream(as_port(ovm), device="cpu", **kw)
    assert tr.n_count == tj.n_count > 0
    assert np.array_equal(tr.npts, tj.npts)
    assert np.array_equal(tr.packed_xyz, tj.packed_xyz)
    pj, pt = tmp_path / "j.trk", tmp_path / "t.trk"
    ft.stream(ovm, trk_sink=str(pj), **kw)
    tt.stream(as_port(ovm), device="cpu", trk_sink=str(pt), chunk=700, **kw)
    assert pj.read_bytes() == pt.read_bytes()


@pytest.mark.parametrize("wire", ["i8", "i6"])
def test_stream_wire_error_bound(wire):
    """With the default smoothing XLA fuses the EMA's multiply and add,
    so a position may differ in its last bit and a delta may round the
    other way: the port's lines are within 2/qscale of the reference's
    i8/i6 lines, and of its own float32 lines (the wire's bound at every
    point, no drift), with equal point counts."""
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=3, seed_rng=3)
    exact = tt.stream(as_port(ovm), device="cpu", wire="f32", **kw)
    got = tt.stream(as_port(ovm), device="cpu", wire=wire, **kw)
    want = ft.stream(ovm, wire=wire, **kw)
    bound = 2.0 / _qscale(wire)
    for other in (exact, want):
        assert got.n_count == other.n_count > 0
        assert np.array_equal(got.npts, other.npts)
        assert np.abs(got.packed_xyz - other.packed_xyz).max() <= bound


def _no_native(monkeypatch):
    """Run the numpy fallbacks of the wire: no native library."""
    from fibers_tpu_torch import native
    monkeypatch.setattr(native, "lib", lambda: None)


@pytest.mark.parametrize("native_lib", [True, False])
@pytest.mark.parametrize("wire", ["i8", "i6"])
def test_stream_wire_sink_matches_memory(wire, native_lib, tmp_path,
                                         monkeypatch):
    """The sink's fused native decode into .trk records writes the bytes
    `trk_write` writes for the lines decoded in memory; without the
    native library both go through the numpy decode."""
    if not native_lib:
        _no_native(monkeypatch)
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=3, wire=wire, device="cpu", chunk=700)
    fused, plain = tmp_path / "fused.trk", tmp_path / "plain.trk"
    tt.stream(as_port(ovm), trk_sink=str(fused), **kw)
    mem = tt.stream(as_port(ovm), **kw)
    tt.trk_write(mem, str(plain))
    assert mem.n_count > 0
    assert fused.read_bytes() == plain.read_bytes()
    if not native_lib:
        want = ft.stream(ovm, mask=maskm, nsub=3, wire=wire)
        assert np.array_equal(mem.npts, want.npts)
        assert np.abs(mem.packed_xyz - want.packed_xyz).max() <= \
            2.0 / _qscale(wire)


def test_stream_i6_zero_point_lines(tmp_path):
    """len_min=0 keeps the lines of no point (seeds whose first step
    leaves the mask): the i6 wire carries them as empty lines, in memory
    and in the .trk, as the reference does."""
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=2, len_min=0, smooth_coeff=0.0, wire="i6")
    seed = ft.MRI.like(maskm, 1, np.float32)
    sv = np.zeros(maskm.vol.shape, np.float32)
    sv[0] = 1                              # outside the mask
    sv[5:7] = 1
    seed.vol = sv
    got = tt.stream(as_port(ovm), device="cpu", seed=seed, **kw)
    want = ft.stream(ovm, seed=seed, **kw)
    assert (got.npts == 0).any() and (got.npts > 0).any()
    assert np.array_equal(got.npts, want.npts)
    assert np.array_equal(got.packed_xyz, want.packed_xyz)
    path = tmp_path / "z.trk"
    tt.stream(as_port(ovm), device="cpu", seed=seed, trk_sink=str(path),
              **kw)
    back = tt.trk_read(str(path))
    assert np.array_equal(back.npts, got.npts)


@pytest.mark.parametrize("native_lib", [True, False])
@pytest.mark.parametrize("n", [1, 16, 47, 3000])
def test_unpack6_round_trip(n, native_lib, monkeypatch):
    """`_pack6` -> uint32 words -> `_unpack6` gives the deltas back, the
    pad fields read as zero, and the reference's own `_unpack6` reads the
    port's words the same way."""
    from fibers_tpu.tract.stream import _unpack6 as ref_unpack6
    from fibers_tpu_torch.tract.stream import _pack6, _unpack6
    q = np.random.default_rng(n).integers(-31, 32, n).astype(np.int8)
    words = _pack6(torch.from_numpy(q)).numpy().view(np.uint32)
    assert len(words) == -(-n // 16) * 3
    want = np.concatenate([q, np.zeros(-n % 16, np.int8)])
    assert np.array_equal(ref_unpack6(words, n)[:len(want)], want)
    if not native_lib:
        _no_native(monkeypatch)
    assert np.array_equal(_unpack6(words, n)[:len(want)], want)


def test_stream_sharded_i6_equals_unsharded():
    """i6 lines on 8 CPU shards (tests/test_parallel.py's
    test_stream_sharded_i6_wire) equal the unsharded i6 lines."""
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=3, wire="i6", device="cpu")
    one = tt.stream(as_port(ovm), **kw)
    sh = tt.stream(as_port(ovm), mesh=make_mesh(8, device="cpu"), **kw)
    assert sh.n_count == one.n_count > 0
    assert np.array_equal(sh.npts, one.npts)
    assert np.array_equal(sh.packed_xyz, one.packed_xyz)


# ------------------------------------------------------------------ #
# The overlapped chunk driver: a writer thread for the .trk sink
# ------------------------------------------------------------------ #

def _ref_trk(tract, ref, path):
    """The JAX package's .trk writer on the port's in-memory lines."""
    tr = ft.Tract.from_ref(as_ref(ref))
    tr.set_packed(tract.packed_xyz, tract.npts, tract.packed_scalars)
    ft.trk_write(tr, str(path))
    return path.read_bytes()


def _writer_case(case):
    """(port kwargs, JAX kwargs or None, the orientation volume the
    Tract's header comes from) of each engine, at a chunk that makes
    four or more chunks.  LCM lines follow the port's counter-based draws
    (C8), so its .trk is held to the JAX package's writer on the port's
    lines instead of the JAX package's stream."""
    from fibers_tpu_torch.utils.phantom import (make_lcm_field,
                                                make_micro_field)
    if case == "lcm":
        ovecs, lcm, mask = make_lcm_field((24, 24))
        kw = dict(ovec=ovecs, mask=mask, lcms=lcm, nsub=1, seed_rng=2,
                  chunk=128)
        return kw, None, ovecs[0]
    if case == "micro":
        ov, mask = make_micro_field((32, 32, 2))
        kw = dict(mask=mask, search_dist=4, nsub=0)
        return dict(kw, ovec=ov, chunk=256), dict(kw, ovec=as_ref(ov)), ov
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=3, seed_rng=3, smooth_coeff=0.0, wire=case)
    return dict(kw, ovec=as_port(ovm), chunk=700), dict(kw, ovec=ovm), ovm


@pytest.mark.parametrize("case", ["f32", "i8", "i6", "lcm", "micro"])
def test_overlapped_driver_writes_the_reference_bytes(case, tmp_path,
                                                      monkeypatch):
    """Through the writer thread, over four or more chunks (two in flight
    on the writer), each engine's .trk is the JAX package's, byte for
    byte, and the Tract in memory holds the same lines; every chunk is
    appended on the writer thread."""
    from fibers_tpu_torch.tract import stream as stream_mod
    kw, ref_kw, ref = _writer_case(case)
    ovec = kw.pop("ovec")
    threads, real = [], stream_mod._append_lines

    def spy(*args):
        threads.append(threading.current_thread().name)
        return real(*args)

    monkeypatch.setattr(stream_mod, "_append_lines", spy)
    pt = tmp_path / "t.trk"
    ts = tt.stream(ovec, device="cpu", trk_sink=str(pt), **kw)
    mem = tt.stream(ovec, device="cpu", **kw)
    assert len(threads) >= 4
    assert all(t.startswith("trk-writer") for t in threads), threads
    assert ts.n_count == mem.n_count > 0
    assert np.array_equal(ts.npts, mem.npts)
    if ref_kw is None:
        want = _ref_trk(mem, ref, tmp_path / "j.trk")
    else:
        pj = tmp_path / "j.trk"
        ft.stream(ref_kw.pop("ovec"), trk_sink=str(pj), **ref_kw)
        want = pj.read_bytes()
        assert _ref_trk(mem, ref, tmp_path / "m.trk") == want
    assert pt.read_bytes() == want


def test_driver_launches_one_chunk_ahead(monkeypatch, tmp_path):
    """Chunk i+1 is launched before chunk i's counts are copied to the
    host (`_fetch_lines` starts with that copy), every chunk once and in
    order, and the writer never holds more than two chunks: a slow writer
    makes the loop wait for it."""
    from fibers_tpu_torch.tract import stream as stream_mod
    events, done = [], []
    real_drive, real_fetch = stream_mod._drive, stream_mod._fetch_lines
    real_append, real_submit = (stream_mod._append_lines,
                                stream_mod._Writer.submit)

    def drive(launch, *args, **kwargs):
        def logged(lo):
            events.append(("launch", lo))
            return launch(lo)
        return real_drive(logged, *args, **kwargs)

    def fetch(*args):
        events.append(("fetch", None))
        return real_fetch(*args)

    third = threading.Event()

    def slow_append(*args):
        # the first chunk is written only once the loop offers a third
        if not done:
            assert third.wait(30)
        real_append(*args)
        done.append(1)

    def submit(self, lines):
        submitted = sum(kind == "submit" for kind, _ in events) + 1
        if submitted == 3:
            third.set()
        real_submit(self, lines)
        events.append(("submit", submitted - len(done)))

    monkeypatch.setattr(stream_mod, "_drive", drive)
    monkeypatch.setattr(stream_mod, "_fetch_lines", fetch)
    monkeypatch.setattr(stream_mod, "_append_lines", slow_append)
    monkeypatch.setattr(stream_mod._Writer, "submit", submit)
    ovm, maskm, _ = _smooth_field()
    tr = tt.stream(as_port(ovm), mask=maskm, nsub=2, device="cpu",
                   chunk=500, trk_sink=str(tmp_path / "a.trk"))
    launches = [lo for kind, lo in events if kind == "launch"]
    n = len(launches)
    assert n >= 4 and tr.n_count > 0
    assert launches == list(range(0, n * 500, 500))
    seen = 0
    fetches = []
    for kind, _ in events:
        seen += kind == "launch"
        if kind == "fetch":
            fetches.append(seen)
    # the k-th chunk's fetch comes after launch k + 1 (the last: n)
    assert fetches == [min(k + 2, n) for k in range(n)]
    inflight = [m for kind, m in events if kind == "submit"]
    assert len(inflight) == n and max(inflight) == 2


@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_writer_error_reaches_the_caller(wire, tmp_path, monkeypatch):
    """A failure on the writer thread (the sink's append of the second
    chunk) is raised by `stream` on the calling thread, the loop does not
    hang, and the .trk file is closed."""
    from fibers_tpu_torch.io.trk import TrkSink
    name = "append" if wire == "f32" else "append_deltas6"
    real, calls, files = getattr(TrkSink, name), [], []

    def failing(self, *args, **kwargs):
        calls.append(threading.current_thread().name)
        files.append(self._f)
        if len(calls) == 2:
            raise RuntimeError("disk full")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(TrkSink, name, failing)
    ovm, maskm, _ = _smooth_field()
    with pytest.raises(RuntimeError, match="disk full"):
        tt.stream(as_port(ovm), mask=maskm, nsub=3, wire=wire, device="cpu",
                  chunk=500, trk_sink=str(tmp_path / "x.trk"))
    assert len(calls) >= 2 and calls[1].startswith("trk-writer")
    assert files and all(f.closed for f in files)


def test_overlapped_driver_on_a_mesh(tmp_path):
    """On 8 CPU shards, over four or more chunks, the lines, the counts
    and the .trk bytes are the unsharded run's and the JAX package's
    (no smoothing: bit-equal positions)."""
    ovm, maskm, _ = _smooth_field()
    kw = dict(mask=maskm, nsub=3, seed_rng=3, smooth_coeff=0.0, wire="f32")
    one = tt.stream(as_port(ovm), device="cpu", chunk=700, **kw)
    mesh = make_mesh(8, device="cpu")
    sh = tt.stream(as_port(ovm), mesh=mesh, chunk=700, **kw)
    assert sh.n_count == one.n_count > 0
    assert np.array_equal(sh.npts, one.npts)
    assert np.array_equal(sh.packed_xyz, one.packed_xyz)
    ps, pj = tmp_path / "s.trk", tmp_path / "j.trk"
    tt.stream(as_port(ovm), mesh=mesh, chunk=700, trk_sink=str(ps), **kw)
    ft.stream(ovm, trk_sink=str(pj), **kw)
    assert ps.read_bytes() == pj.read_bytes()
    assert _ref_trk(sh, ovm, tmp_path / "m.trk") == pj.read_bytes()
