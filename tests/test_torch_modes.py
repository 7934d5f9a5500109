"""The LCM and microscopy tractography modes and the single-line and
single-step stream API of the PyTorch port, held against the JAX package
and the per-line oracles of tests/oracle.py.

Tolerances:
- micro mode: jumps land on integer voxels and the seeds are integers,
  so the lines equal the JAX package's exactly (wire="f32");
- stream_new_point / stream_micro_new_point: numpy copies of the
  reference, so their oracle chains hold to atol=1e-5 as the JAX
  package's own tests (tests/test_stream.py:477,532) do;
- stream_new_line with smooth_coeff=0: every position is the previous
  one plus a unit input vector times a power of two, one rounding in
  either package, so the line equals the JAX package's exactly; with
  the default smoothing, within atol=1e-5 voxel;
- LCM: the seed jitter equals the JAX package's bit for bit; the
  categorical draws are the port's counter-based Philox uniforms
  (ops/kernels/propagate_lcm.py), so the line geometry matches only in
  distribution, held to the bound of
  tests/test_stream.py:236 (|p_hat - 0.3| < max(4 sigma, 0.05)).
"""

import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu_torch.core.handoff import DevicePeaks
from fibers_tpu_torch.utils.phantom import make_lcm_field, make_micro_field

from test_torch_stream import as_port, as_ref


def _mri(vol, volres=(1.0, 1.0, 1.0)):
    m = ft.MRI(vol=np.asarray(vol, np.float32))
    shape = m.vol.shape[:3]
    m.vox2ras0 = np.diag(list(volres) + [1.0]).astype(np.float32)
    m.volsize = np.asarray(shape)
    m.width, m.height, m.depth = shape
    m.nframes = 1 if m.vol.ndim == 3 else m.vol.shape[3]
    m.set_geometry()
    return m


def _vec_field(shape, direction, volres=(1.0, 1.0, 1.0)):
    v = np.zeros(shape + (3,), np.float32)
    d = np.asarray(direction, np.float32)
    v[...] = d / np.linalg.norm(d)
    return _mri(v, volres)


def _mask_mri(ref, arr):
    m = ft.MRI.like(ref, 1, np.float32)
    m.vol = arr.astype(np.float32)
    return m


def _assert_same_lines(a, b):
    assert a.n_count == b.n_count
    assert np.array_equal(np.asarray(a.npts), np.asarray(b.npts))
    assert np.array_equal(a.packed_xyz, b.packed_xyz)


# ------------------------------------------------------------------ #
# Microscopy mode
# ------------------------------------------------------------------ #

def _micro_corridor():
    """tests/test_stream.py's micro set-up: a +x field on 10 um voxels."""
    shape = (30, 9, 9)
    ov = _vec_field(shape, (1, 0, 0), (0.01, 0.01, 0.01))
    mask = np.zeros(shape, bool)
    mask[:, 3:6, 3:6] = True
    seedm = np.zeros(shape, bool)
    seedm[10:20, 4, 4] = True
    return ov, _mask_mri(ov, mask), _mask_mri(ov, seedm)


def _micro_random():
    """A random 3-D field biased along +x on 10 um voxels."""
    rng = np.random.default_rng(11)
    shape = (12, 10, 8)
    v = rng.standard_normal(shape + (3,)) + np.array([1.5, 0.0, 0.0])
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ov = _mri(v, (0.02, 0.02, 0.02))
    mask = np.ones(shape, bool)
    mask[0] = False
    return ov, _mask_mri(ov, mask), None


@pytest.mark.parametrize("case", ["corridor", "random", "angles"])
def test_micro_stream_matches_jax_exactly(case):
    if case == "corridor":
        ov, mask, seed = _micro_corridor()
        kw = dict(search_dist=3, len_max=100)
    elif case == "random":
        ov, mask, seed = _micro_random()
        kw = dict(search_dist=2, search_ang=30.0, ang_thresh=None,
                  step_size=None, smooth_coeff=None, nsub=None)
    else:
        ov, mask = make_micro_field((20, 18, 2))
        seed = None
        kw = dict(search_dist=4, nsub=0)
    tj = ft.stream(as_ref(ov), mask=mask, seed=seed, wire="f32", **kw)
    tr = tt.stream(as_port(ov), mask=mask, seed=seed, device="cpu", **kw)
    assert tr.n_count > 0
    _assert_same_lines(tj, tr)


def test_micro_lines_match_oracle():
    from oracle import stream_micro_line_oracle

    ov, mask, _ = _micro_random()
    m = mask.vol > 0
    kw = dict(search_dist=2, search_ang=30.0, step_size=1.0,
              ang_thresh=60.0, smooth_coeff=0.0)
    tr = tt.stream(as_port(ov), mask=mask, nsub=0, device="cpu", len_min=1,
                   len_max=8, **kw)
    vecs = np.asarray(ov.vol)[..., None, :] * m[..., None, None]
    off = np.concatenate([[0], np.cumsum(tr.npts)])
    seeds = np.argwhere(m)
    ref = [stream_micro_line_oracle(
        sv, vecs, m, (2, 2, 2), search_ang=30.0, step_size=1.0,
        ang_thresh=60.0, smooth_coeff=0.0, len_max=8) for sv in seeds]
    ref = [r for r in ref if len(r) >= 1]
    assert tr.n_count == len(ref) > 0
    for i, line in enumerate(ref):
        np.testing.assert_allclose(tr.packed_xyz[off[i]:off[i + 1]], line,
                                   atol=1e-5, rtol=0, err_msg=f"line {i}")


def test_micro_sink_matches_tract(tmp_path):
    ov, mask, seed = _micro_corridor()
    kw = dict(mask=mask, seed=seed, nsub=0, search_dist=3, len_max=100,
              device="cpu")
    mem = tt.stream(as_port(ov), **kw)
    out = str(tmp_path / "micro.trk")
    tt.stream(as_port(ov), trk_sink=out, **kw)
    back = tt.trk_read(out)
    assert back.n_count == mem.n_count > 0
    np.testing.assert_allclose(back.packed_xyz, mem.packed_xyz, atol=1e-5)


@pytest.mark.parametrize("wire", ["i8", "i6"])
def test_micro_quantized_wires_raise(wire):
    """An explicit i8/i6 with jittered seeds (nsub=3) cannot be carried
    by the micro mode's one-voxel integer wire: it warns, as the
    reference does, and the points are the exact float32 ones, equal to
    the reference's."""
    ov, mask, seed = _micro_corridor()
    kw = dict(mask=mask, seed=seed, wire=wire)
    with pytest.warns(RuntimeWarning, match="cannot represent"):
        got = tt.stream(as_port(ov), device="cpu", **kw)
    with pytest.warns(RuntimeWarning, match="cannot represent"):
        want = ft.stream(ov, **kw)
    exact = tt.stream(as_port(ov), device="cpu", mask=mask, seed=seed,
                      wire="f32")
    assert got.n_count == want.n_count > 0
    assert np.array_equal(got.packed_xyz, exact.packed_xyz)
    assert np.array_equal(got.packed_xyz, want.packed_xyz)


@pytest.mark.parametrize("wire", ["i8", "i6"])
@pytest.mark.parametrize("case", ["corridor", "angles"])
def test_micro_integer_wire_is_exact(case, wire, tmp_path):
    """With voxel-centre seeds (nsub=0) the micro mode's points ride the
    integer wire (one-voxel deltas, qscale = 1): the lines equal the
    float32 ones and the reference's i8/i6 lines exactly, in memory and
    in the .trk."""
    if case == "corridor":
        ov, mask, seed = _micro_corridor()
        kw = dict(search_dist=3, len_max=100)
    else:
        ov, mask = make_micro_field((20, 18, 2))
        seed = None
        kw = dict(search_dist=4)
    kw.update(mask=mask, seed=seed, nsub=0)
    exact = tt.stream(as_port(ov), device="cpu", wire="f32", **kw)
    got = tt.stream(as_port(ov), device="cpu", wire=wire, **kw)
    want = ft.stream(as_ref(ov), wire=wire, **kw)
    assert got.n_count == want.n_count == exact.n_count > 0
    for other in (exact, want):
        assert np.array_equal(got.npts, other.npts)
        assert np.array_equal(got.packed_xyz, other.packed_xyz)
    pt, pj = tmp_path / "t.trk", tmp_path / "j.trk"
    tt.stream(as_port(ov), device="cpu", wire=wire, trk_sink=str(pt), **kw)
    ft.stream(as_ref(ov), wire=wire, trk_sink=str(pj), **kw)
    assert pt.read_bytes() == pj.read_bytes()


# ------------------------------------------------------------------ #
# Single-line and single-step API
# ------------------------------------------------------------------ #

def _random_two_vec_field():
    rng = np.random.default_rng(5)
    shape = (12, 12, 12)
    v = rng.standard_normal(shape + (2, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = np.ones(shape, bool)
    mask[:2] = mask[-2:] = False
    ovs = [_mri(v[..., i, :]) for i in range(2)]
    return v, mask, ovs


def _chain(step, seed, vec0, work, len_max, cos_thr):
    """The reference's line driver over a single-step function."""
    strline = []
    npts = 0
    for fwd in (1, -1):
        pos = seed.astype(float)
        vec = vec0.astype(float) * fwd
        addpt = (lambda p: strline.insert(0, p)) if fwd == 1 else \
            strline.append
        while True:
            pos_next, vec_next, ok = step(pos, vec, work)
            if not ok:
                break
            addpt(pos.copy())
            npts += 1
            if float(vec @ vec_next) < cos_thr:
                break
            if npts > len_max:
                break
            pos, vec = pos_next, vec_next
    return np.asarray(strline)


def test_new_point_matches_oracle_chain():
    from oracle import stream_line_oracle

    v, mask, ovs = _random_two_vec_field()
    work = tt.StreamWork(as_port(ovs), mask=_mask_mri(ovs[0], mask),
                         smooth_coeff=0.0,
                         ang_thresh=90.0, device="cpu")
    ovecs_masked = v * mask[..., None, None]
    seed = np.array([6, 6, 6])
    cos_thr = np.cos(np.radians(90.0))
    want = stream_line_oracle(seed, np.zeros(3), ovecs_masked, mask,
                              smooth_coeff=0.0, cosang_thresh=cos_thr,
                              len_max=10)
    got = _chain(tt.stream_new_point, seed, ovecs_masked[6, 6, 6, 0], work,
                 10, cos_thr)
    assert len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_micro_new_point_matches_oracle_chain():
    from oracle import stream_micro_line_oracle

    rng = np.random.default_rng(7)
    shape = (16, 16, 16)
    v = rng.standard_normal(shape + (3,)) + np.array([1.5, 0, 0])
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(shape, bool)
    m = _mri(v)
    work = tt.StreamWork(as_port(m), mask=_mask_mri(m, mask), smooth_coeff=0.0,
                         ang_thresh=90.0, search_dist=3, search_ang=60.0,
                         step_size=1.0, device="cpu")
    seed = np.array([8, 8, 8])
    cos_thr = np.cos(np.radians(90.0))
    want = stream_micro_line_oracle(
        seed, v[..., None, :], mask, (3, 3, 3), search_ang=60.0,
        step_size=1.0, ang_thresh=90.0, smooth_coeff=0.0, len_max=6)
    got = _chain(tt.stream_micro_new_point, seed, v[8, 8, 8], work, 6,
                 cos_thr)
    assert len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("fn", ["stream_new_point",
                                "stream_micro_new_point"])
def test_single_step_matches_jax(fn):
    """Every in-mask voxel of the random field, one step each, in both
    packages: identical positions, vectors and flags."""
    v, mask, ovs = _random_two_vec_field()
    kw = dict(mask=_mask_mri(ovs[0], mask), search_dist=2)
    wj = ft.StreamWork(ovs, **kw)
    wt = tt.StreamWork(as_port(ovs), device="cpu", **kw)
    for sv in np.argwhere(mask)[::7]:
        vec = v[tuple(sv)][0]
        pj, vj, okj = getattr(ft, fn)(sv, vec, wj)
        pt, vt, okt = getattr(tt, fn)(sv, vec, wt)
        assert okj == okt
        assert np.array_equal(pj, pt) and np.array_equal(vj, vt)


@pytest.mark.parametrize("smooth", [0.0, 0.2])
def test_new_line_matches_jax(smooth):
    v, mask, ovs = _random_two_vec_field()
    kw = dict(mask=_mask_mri(ovs[0], mask), smooth_coeff=smooth,
              ang_thresh=80.0)
    wj = ft.StreamWork(ovs, **kw)
    wt = tt.StreamWork(as_port(ovs), device="cpu", **kw)
    for sv, sub in (((6, 6, 6), (0.0, 0.0, 0.0)),
                    ((4, 7, 5), (0.2, -0.3, 0.1)),
                    ((3, 3, 9), (-0.4, 0.4, 0.0))):
        lj = ft.stream_new_line(np.array(sv), np.array(sub), wj)
        lt = tt.stream_new_line(np.array(sv), np.array(sub), wt)
        assert lt.shape == lj.shape and lt.shape[0] == 3 and lt.shape[1] > 0
        if smooth == 0.0:
            assert np.array_equal(lt, lj)
        else:
            np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)


def test_new_line_matches_oracle():
    from oracle import stream_line_oracle

    v, mask, ovs = _random_two_vec_field()
    work = tt.StreamWork(as_port(ovs), mask=_mask_mri(ovs[0], mask),
                         device="cpu")
    want = stream_line_oracle(np.array([6, 6, 6]), np.zeros(3),
                              v * mask[..., None, None], mask)
    got = tt.stream_new_line(np.array([6, 6, 6]), np.zeros(3), work)
    np.testing.assert_allclose(got.T, want, atol=1e-5)


def test_new_line_outside_the_mask_matches_jax():
    """A seed outside the mask gives JAX's line: its shape and points."""
    v, mask, ovs = _random_two_vec_field()
    kw = dict(mask=_mask_mri(ovs[0], mask))
    sv = tuple(np.argwhere(~mask)[0])
    lj = ft.stream_new_line(np.array(sv), np.zeros(3), ft.StreamWork(ovs, **kw))
    wt = tt.StreamWork(as_port(ovs), device="cpu", **kw)
    lt = tt.stream_new_line(np.array(sv), np.zeros(3), wt)
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, atol=1e-5)


# ------------------------------------------------------------------ #
# LCM mode
# ------------------------------------------------------------------ #

def _lcm_corridor():
    """tests/test_stream.py's LCM set-up: a +x field, 4 rows of mask, the
    straight x connection open everywhere."""
    shape = (16, 16, 1)
    ov = _vec_field(shape, (1, 0, 0))
    mask = np.zeros(shape, bool)
    mask[:, 6:10, 0] = True
    seedm = np.zeros(shape, bool)
    seedm[6:10, 8, 0] = True
    lcm = np.zeros(shape + (10,), np.float32)
    lcm[..., 2] = 1.0
    return ov, _mask_mri(ov, mask), _mask_mri(ov, seedm), ft.MRI(vol=lcm)


def test_lcm_propagates_in_plane():
    ov, mask, seed, lcmm = _lcm_corridor()
    seedm = np.zeros(mask.vol.shape, np.float32)
    seedm[8, 8, 0] = 1
    tr = tt.stream(as_port(ov), mask=mask, seed=_mask_mri(ov, seedm),
                   lcms=lcmm,
                   nsub=0, step_size=1.0, len_max=100, device="cpu")
    assert tr.n_count == 1
    pts = tr.xyz[0].T
    assert pts[:, 0].max() - pts[:, 0].min() > 10
    assert np.allclose(pts[:, 1], 8, atol=0.5)
    assert tr.n_scalars == 1
    assert tr.scalars[0].shape[1] == pts.shape[0]


@pytest.mark.parametrize("seed_rng", [0, 5, 77])
def test_lcm_jitter_matches_jax_bit_for_bit(seed_rng):
    """The LCM driver draws its jitter from the second half of
    split(PRNGKey(seed_rng)) (fibers_tpu/tract/modes.py:218-223).  Every
    line saves its seed point twice (forward, then backward), so those
    duplicated points hold the jitter: they must equal the JAX package's
    bit for bit, whatever the categorical draws did after them."""
    ov, mask, seed, lcmm = _lcm_corridor()
    kw = dict(mask=mask, seed=seed, lcms=lcmm, nsub=3, step_size=0.25,
              len_max=6, len_min=1, seed_rng=seed_rng)
    tj = ft.stream(ov, wire="f32", **kw)
    tr = tt.stream(as_port(ov), device="cpu", **kw)

    def seed_points(t):
        off = np.concatenate([[0], np.cumsum(t.npts)])
        out = []
        for i in range(t.n_count):
            p = t.packed_xyz[off[i]:off[i + 1]]
            dup = np.flatnonzero(np.all(p[1:] == p[:-1], axis=1))
            out.append(p[dup[0]])
        return np.stack(out)

    assert tr.n_count == tj.n_count == 12
    got, want = seed_points(tr), seed_points(tj)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert len(np.unique(np.round(got - np.round(got), 5), axis=0)) == 3


def test_lcm_transition_frequencies():
    """Distributional parity (tests/test_stream.py:236): with an LCM that
    opens the straight x connection at weight 0.7 and the +y turn at 0.3,
    the observed per-entry turn frequency matches the weights."""
    nx, ny = 48, 200
    shape = (nx, ny, 1)
    vx = np.zeros(shape + (3,), np.float32)
    vx[..., 0] = 1.0
    vx[nx - 1, ny - 1, 0, 1] = 1e-3      # through-plane detected as z
    vy = np.zeros(shape + (3,), np.float32)
    vy[..., 1] = 1.0
    ovx, ovy = _mri(vx), _mri(vy)
    seedm = np.zeros(shape, bool)
    seedm[0, :, 0] = True
    lcm = np.zeros(shape + (10,), np.float32)
    lcm[..., 2] = 0.7
    lcm[..., 3] = 0.3
    lcm[..., 6] = 1.0
    tr = tt.stream(as_port([ovx, ovy]), mask=_mask_mri(ovx, np.ones(shape,
                   bool)),
                   seed=_mask_mri(ovx, seedm), lcms=_mri(lcm), nsub=0,
                   step_size=1.0, smooth_coeff=0.0, len_max=300,
                   seed_rng=3, device="cpu")
    turns = 0
    x_entries = 0
    for m in tr.xyz:
        p = np.asarray(m).T
        d = np.diff(p, axis=0)
        d = d[np.abs(d).sum(axis=1) > 1e-6]
        is_x = np.abs(d[:, 0]) > np.abs(d[:, 1])
        x_entries += int(is_x.sum())
        if is_x.any() and (~is_x).any():
            turns += 1
    assert x_entries > 400
    p_hat = turns / x_entries
    sigma = np.sqrt(0.3 * 0.7 / x_entries)
    assert abs(p_hat - 0.3) < max(4 * sigma, 0.05), \
        f"turn rate {p_hat:.3f} vs 0.3 (n={x_entries})"


def test_lcm_sink_scalars_match_tract(tmp_path):
    ov, mask, seed, lcmm = _lcm_corridor()
    kw = dict(mask=mask, seed=seed, lcms=lcmm, nsub=0, step_size=1.0,
              len_max=100, seed_rng=5, device="cpu")
    mem = tt.stream(as_port(ov), **kw)
    out = str(tmp_path / "lcm.trk")
    ts = tt.stream(as_port(ov), trk_sink=out, **kw)
    back = tt.trk_read(out)
    assert back.n_count == mem.n_count == ts.n_count > 0
    assert back.n_scalars == 1 and mem.n_scalars == 1
    # the packed Tract writes the same bytes as the per-line writer
    packed_f, line_f = str(tmp_path / "p.trk"), str(tmp_path / "l.trk")
    tt.trk_write(mem, packed_f)
    mem.materialize()
    tt.trk_write(mem, line_f)
    for i in range(mem.n_count):
        np.testing.assert_allclose(back.xyz[i], mem.xyz[i], atol=1e-5)
        np.testing.assert_array_equal(back.scalars[i], mem.scalars[i])
    with open(packed_f, "rb") as a, open(line_f, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("wire", ["i8", "i6"])
def test_lcm_wire_against_own_f32(wire, tmp_path):
    """LCM lines match the reference only in distribution (C8), so the
    quantized wire is held against the port's own float32 run with the
    same seed, whose draws are the same: equal point counts and flags,
    points within 2/qscale; the .trk (points and flags through the
    decode) reads back the same lines."""
    ovecs, lcm, mask = make_lcm_field((24, 24))
    kw = dict(mask=mask, lcms=lcm, nsub=1, seed_rng=2, device="cpu")
    exact = tt.stream(as_port(ovecs), wire="f32", **kw)
    got = tt.stream(as_port(ovecs), wire=wire, **kw)
    assert got.n_count == exact.n_count > 0
    assert np.array_equal(got.npts, exact.npts)
    assert np.array_equal(got.packed_scalars, exact.packed_scalars)
    qscale = (31 if wire == "i6" else 127) / 0.5
    assert np.abs(got.packed_xyz - exact.packed_xyz).max() <= 2.0 / qscale
    path = str(tmp_path / "lcm.trk")
    tt.stream(as_port(ovecs), wire=wire, trk_sink=path, **kw)
    back = tt.trk_read(path)
    assert np.array_equal(back.npts, got.npts) and back.n_scalars == 1
    got.materialize()
    for i in range(got.n_count):
        np.testing.assert_allclose(back.xyz[i], got.xyz[i], atol=1e-5)
        np.testing.assert_array_equal(back.scalars[i], got.scalars[i])


def test_lcm_field_against_jax_in_distribution():
    """The LCM phantom through both packages from the same seeds: line
    counts within 3% (a line shorter than len_min is dropped), mean line
    length within 5% and the share of method-difference flags within 8%
    (over five seeds the largest gaps seen were 1.3%, 1.0% and 3.3%)."""
    ovecs, lcm, mask = make_lcm_field((24, 24))
    kw = dict(mask=mask, lcms=lcm, nsub=1, seed_rng=2)
    tj = ft.stream(ovecs, wire="f32", **kw)
    tr = tt.stream(as_port(ovecs), device="cpu", **kw)
    assert tj.n_count > 300 and abs(tr.n_count / tj.n_count - 1) < 0.03
    assert abs(np.mean(tr.npts) / np.mean(tj.npts) - 1) < 0.05
    fj, fr = tj.packed_scalars.mean(), tr.packed_scalars.mean()
    assert 0.0 < fr < 1.0 and abs(fr / fj - 1) < 0.08
    assert set(np.unique(tr.packed_scalars)) <= {0.0, 1.0}


def test_lcm_empty_seed_set(tmp_path):
    ov, mask, _, lcmm = _lcm_corridor()
    none = _mask_mri(ov, np.zeros(mask.vol.shape, bool))
    out = str(tmp_path / "e.trk")
    tr = tt.stream(as_port(ov), mask=mask, seed=none, lcms=lcmm, device="cpu",
                   trk_sink=out)
    assert tr.n_count == 0 and tt.trk_read(out).n_count == 0
    tr = tt.stream(as_port(ov), mask=mask, seed=none, lcms=lcmm, device="cpu")
    assert tr.n_count == 0 and tr.n_scalars == 1


@pytest.mark.parametrize("mode", ["lcm", "micro"])
def test_modes_refuse_device_peaks(mode):
    ov, mask, seed, lcmm = _lcm_corridor()
    ref = ov if mode == "lcm" else _vec_field(
        mask.vol.shape, (1, 0, 0), (0.01, 0.01, 0.01))
    n = int(np.prod(mask.vol.shape))
    pk = DevicePeaks.from_numpy(np.tile([1.0, 0, 0], (n, 1, 1)),
                                np.ones((n, 1)), np.arange(n), ref, "cpu")
    if mode == "lcm":
        # LCM reads host orientation volumes; device peaks are refused
        with pytest.raises(ValueError, match="deterministic"):
            tt.stream(as_port(pk), mask=mask, lcms=lcmm)
        return
    # the microscopy mode takes device peaks, with the host route's lines
    got = tt.stream(as_port(pk), mask=mask, device="cpu")
    want = tt.stream(as_port(ref), mask=mask, device="cpu")
    assert got.n_count > 0
    _assert_same_lines(got, want)


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

@pytest.mark.cuda
def test_modes_card_matches_cpu():
    """Micro lines identical on the card and the CPU; LCM line counts
    within 3% and mean lengths within 5%, as against the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ov, mask = make_micro_field((40, 36, 2))
    a = tt.stream(as_port(ov), mask=mask, search_dist=4, device="cuda")
    b = tt.stream(as_port(ov), mask=mask, search_dist=4, device="cpu")
    _assert_same_lines(a, b)
    ovecs, lcm, lmask = make_lcm_field((32, 32))
    a = tt.stream(as_port(ovecs), mask=lmask, lcms=lcm, device="cuda")
    b = tt.stream(as_port(ovecs), mask=lmask, lcms=lcm, device="cpu")
    assert b.n_count > 0 and abs(a.n_count / b.n_count - 1) < 0.03
    assert abs(np.mean(a.npts) / np.mean(b.npts) - 1) < 0.05


@pytest.mark.cuda
def test_new_line_card_matches_cpu():
    """stream_new_line on the card gives the CPU's line exactly
    (smooth_coeff=0: one rounding per point in either)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    v, mask, ovs = _random_two_vec_field()
    kw = dict(mask=_mask_mri(ovs[0], mask), smooth_coeff=0.0,
              ang_thresh=80.0)
    lines = [tt.stream_new_line(np.array([4, 7, 5]), np.array([0.2, -0.3,
                                                               0.1]),
                                tt.StreamWork(as_port(ovs), device=dev, **kw))
             for dev in ("cuda", "cpu")]
    assert lines[0].shape[1] > 0
    assert np.array_equal(*lines)
