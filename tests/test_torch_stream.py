"""Deterministic tractography of the PyTorch port held against the JAX
package and the per-line oracle.

Both packages propagate in float32 with the same operations, but XLA may
fuse a multiply and an add into one rounding where PyTorch rounds twice,
so a position can differ in its last bit and, rarely, round to another
voxel.  Hence: equal line counts, equal per-line point counts on >= 99%
of lines, and points within atol=1e-4 voxel on lines of equal length.
"""

import jax
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu_torch.core.handoff import DevicePeaks
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
    (dict(wire="i8"), NotImplementedError),
    (dict(wire="i6"), NotImplementedError),
    (dict(wire="i4"), ValueError),
    (dict(mesh=object()), NotImplementedError),
    (dict(bogus=1), TypeError),
])
def test_stream_unported_options_raise(kw, exc):
    ovm, maskm, _ = _smooth_field()
    with pytest.raises(exc):
        tt.stream(as_port(ovm), mask=maskm, device="cpu", **kw)


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
