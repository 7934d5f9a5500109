"""The tractography propagation kernel's module
(fibers_tpu_torch/ops/kernels/propagate.py) held against the JAX package.

`propagate_dir_plain`, what a CPU tensor runs, is compared with
`fibers_tpu.tract.stream._propagate` (the jitted `lax.scan`) on the same
numpy inputs, both directions chained through `npts0` as
`propagate_chunk` chains them.  Without smoothing every output is
bit-equal.  With smoothing XLA fuses the EMA's multiply and add into one
FMA where torch rounds twice (and torch's CPU square root is not
correctly rounded), so a direction may differ in its last bit: the
point counts agree on >= 99% of the streams, and on those the points
within 1e-4 voxel and the decoded delta chains within 2/qscale, the
bounds of tests/test_torch_stream.py.

The `cuda` tests hold the CUDA kernel to the plain version on the card,
bit for bit on all four outputs, and `stream()` through the kernel (its
two-direction entry, `propagate_pair`) to `stream()` through the plain
loop, byte for byte in the .trk.
"""

import numpy as np
import pytest
import torch

from fibers_tpu.tract.stream import _propagate as jax_propagate
import fibers_tpu_torch as tt
from fibers_tpu_torch.ops.kernels import propagate as P
from fibers_tpu_torch.tract import stream as stream_mod

SHAPE3 = (10, 9, 8)
STEP = 0.5
COS45 = float(np.cos(np.radians(45.0)))
WIRES = {"f32": ("points", 254.0, 127), "i8": ("deltas", 127 / STEP, 127),
         "i6": ("deltas", 31 / STEP, 31)}


def _field(nvec, shape3=SHAPE3, seed=0, nan=False):
    """[nxyz, nvec, 3] float32: a smooth field plus noise (long lines), a
    mask cut (zero vectors), zero candidates, candidates mirrored (-v:
    tied |cos|) and repeated, and with `nan` NaN candidates."""
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*[np.linspace(0, 1, s) for s in shape3],
                          indexing="ij")
    th = 0.6 * x + 0.9 * y + 0.3 * z
    base = np.stack([np.cos(th), np.sin(th), 0.2 * np.ones_like(th)], -1)
    ov = base[..., None, :] + 0.35 * rng.standard_normal(
        shape3 + (nvec, 3))
    ov /= np.linalg.norm(ov, axis=-1, keepdims=True)
    ov = ov.reshape(-1, nvec, 3).astype(np.float32)
    n = len(ov)
    ov[rng.random(n) < 0.04] = 0.0                   # outside the mask
    if nvec > 1:
        ov[rng.random((n, nvec)) < 0.15] = 0.0       # zero candidates
        tie = rng.random(n) < 0.2
        ov[tie, 1] = -ov[tie, 0]
        rep = rng.random(n) < 0.1
        ov[rep, nvec - 1] = ov[rep, 0]
    if nan:
        ov[rng.random((n, nvec)) < 0.02, 0] = np.nan
    return ov


def _seeds(n, ov, shape3=SHAPE3, seed=1):
    """Start positions spread over the volume and past its edges, and
    each one's first vector: the first candidate of its voxel, as
    `propagate_chunk` takes it (zero outside the volume)."""
    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(-0.7, np.array(shape3) - 0.3, (n, 3)).astype(
        np.float32)
    ipos = np.rint(pos0).astype(np.int64)
    inb = ((ipos >= 0) & (ipos < np.array(shape3))).all(axis=1)
    flat = np.where(inb, np.ravel_multi_index(
        np.clip(ipos, 0, np.array(shape3) - 1).T, shape3), 0)
    return pos0, np.ascontiguousarray(ov[flat, 0])


def _both_directions(run, pos0, vec0, ov, nsteps, len_max, smooth, wire):
    """Forward from zero points, backward from the forward counts, as
    `propagate_chunk`: the outputs of both, as numpy arrays."""
    emit, qscale, dmax = WIRES[wire]
    args = (nsteps, SHAPE3, STEP, COS45, smooth, len_max, emit, qscale,
            dmax)
    zero = np.zeros(len(pos0), np.int32)
    fwd = [np.asarray(a) for a in run(pos0, vec0, zero, ov, *args)]
    bwd = [np.asarray(a) for a in run(pos0, -vec0, fwd[2], ov, *args)]
    return fwd + bwd


def _jax(pos0, vec0, npts0, ov, *args):
    return jax_propagate(pos0, vec0, npts0, ov, *args)


def _plain(pos0, vec0, npts0, ov, *args):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (pos0, vec0, npts0, ov)]
    return P.propagate_dir_plain(*t, *args)


def _decode(deltas, saved, anchor, qscale):
    """The quantizer's decoded chain at every saved step: the anchor less
    the deltas still to come, each step d * f32(1 / qscale) (float64)."""
    step = np.float64(np.float32(1.0 / qscale))
    d = deltas.astype(np.float64) * step
    rest = np.cumsum(d[::-1], axis=0)[::-1] - d
    return np.where(saved[..., None], anchor[None] - rest, 0.0)


@pytest.mark.parametrize("smooth", [0.0, 0.2])
@pytest.mark.parametrize("wire", ["f32", "i8", "i6"])
@pytest.mark.parametrize("nvec", [1, 3, 5])
def test_plain_matches_jax_propagate(nvec, wire, smooth):
    """Both directions of 600 streams: 24 steps with a budget of 16
    points, which cuts the longest lines."""
    ov = _field(nvec)
    pos0, vec0 = _seeds(600, ov)
    nsteps, len_max = 24, 16
    got = _both_directions(_plain, pos0, vec0, ov, nsteps, len_max, smooth,
                           wire)
    want = _both_directions(_jax, pos0, vec0, ov, nsteps, len_max, smooth,
                            wire)
    # the inputs exercise the stops: the budget cuts some lines, others
    # leave the volume or the mask at once, most run several steps
    total = got[6]
    assert (total > len_max).any() and (total <= 2).any()
    assert (total >= 8).mean() > 0.2
    if smooth == 0.0:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        return
    same = (got[2] == want[2]) & (got[6] == want[6])
    assert same.mean() >= 0.99, same.mean()
    emit, qscale, _ = WIRES[wire]
    for d in (0, 4):                                 # forward, backward
        out, saved, _, anchor = got[d:d + 4]
        out_w, saved_w, _, anchor_w = want[d:d + 4]
        assert np.array_equal(saved[:, same], saved_w[:, same])
        keep = saved[:, same]
        if emit == "points":
            np.testing.assert_allclose(out[:, same][keep],
                                       out_w[:, same][keep], atol=1e-4,
                                       rtol=0)
        else:
            a = _decode(out[:, same], keep, anchor[same], qscale)
            b = _decode(out_w[:, same], keep, anchor_w[same], qscale)
            assert np.abs(a - b).max() <= 2.0 / qscale


def test_plain_chains_npts_and_freezes_stopped_streams():
    """The saved steps form a prefix; the backward direction starts from
    the forward counts; a stopped stream writes its frozen position (that
    of its first unsaved step) or zero deltas for the steps left."""
    ov = _field(3)
    pos0, vec0 = _seeds(300, ov)
    nsteps = 24
    for wire in ("f32", "i6"):
        out, saved, nf, _, _, bsaved, nt, _ = _both_directions(
            _plain, pos0, vec0, ov, nsteps, 16, 0.2, wire)
        n = saved.sum(axis=0)
        assert np.array_equal(nf, n)
        assert np.array_equal(nt, nf + bsaved.sum(axis=0))
        steps = np.arange(nsteps)[:, None]
        assert np.array_equal(saved, steps < n[None])
        assert (n < nsteps).all() and (n > 1).any()
        if wire == "f32":
            first = out[n, np.arange(len(n))]
            frozen = np.broadcast_to(steps >= n[None], saved.shape)
            assert np.array_equal(out[frozen],
                                  np.broadcast_to(first, out.shape)[frozen])
        else:
            assert not out[~saved].any()


def _cpu_inputs(nvec=3, n=200):
    ov = _field(nvec)
    pos0, vec0 = _seeds(n, ov)
    return [torch.from_numpy(a) for a in (
        pos0, vec0, np.zeros(n, np.int32), ov)]


@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_wrapper_takes_cpu_tensors_to_plain(wire):
    emit, qscale, dmax = WIRES[wire]
    args = (20, SHAPE3, STEP, COS45, 0.2, 16, emit, qscale, dmax)
    t = _cpu_inputs()
    before = P.propagate_dir.launches
    got = P.propagate_dir(*t, *args)
    want = P.propagate_dir_plain(*t, *args)
    assert P.propagate_dir.launches == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_stream_on_cpu_launches_no_kernel():
    from fibers_tpu_torch.utils.phantom import make_brain
    dwi, mask, _ = make_brain(shape=(12, 12, 8), ndir=34)
    gqi = tt.gqi_rec(dwi, mask, tt.sphere_642, device="cpu")
    before = P.propagate_dir.launches, P.propagate_pair.launches
    tr = tt.stream(tt.peaks_to_ovecs(gqi, device=True).first(1), mask=mask,
                   nsub=2, f_thresh=0.0)
    assert tr.n_count > 0
    assert (P.propagate_dir.launches, P.propagate_pair.launches) == before \
        == (0, 0)


def _bad(case):
    pos0, vec0, npts0, ov = _cpu_inputs()
    if case == "pos0 float64":
        pos0 = pos0.double()
    elif case == "npts0 int64":
        npts0 = npts0.long()
    elif case == "vec0 not contiguous":
        vec0 = torch.cat([vec0, vec0], dim=1)[:, ::2]
    elif case == "field of another volume":
        ov = ov[:-1]
    elif case == "several devices":
        ov = ov.to("meta")
    elif case == "a device with no kernel":
        pos0, vec0, npts0, ov = (a.to("meta") for a in (pos0, vec0, npts0,
                                                        ov))
    elif case == "vec0 of another length":
        vec0 = vec0[1:]
    return pos0, vec0, npts0, ov


@pytest.mark.parametrize("case", [
    "pos0 float64", "npts0 int64", "vec0 not contiguous",
    "field of another volume", "several devices", "a device with no kernel",
    "vec0 of another length"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        P.propagate_dir(*_bad(case), 20, SHAPE3, STEP, COS45, 0.2, 16)


def test_wrapper_raises_on_an_unknown_emit_or_delta_range():
    with pytest.raises(ValueError):
        P.propagate_dir(*_cpu_inputs(), 20, SHAPE3, STEP, COS45, 0.2, 16,
                        "deltas", 62.0, 200)
    with pytest.raises(ValueError):
        P.propagate_dir(*_cpu_inputs(), 20, SHAPE3, STEP, COS45, 0.2, 16,
                        "pixels")


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the propagation kernel is CUDA")
    return torch.device("cuda")


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_sum3_order_on_card(cuda):
    """The kernel's sum of three products is torch's on the card."""
    assert P.sum3_selfcheck(1 << 20, cuda) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [0.0, 0.2])
@pytest.mark.parametrize("wire", ["f32", "i8", "i6"])
@pytest.mark.parametrize("S", [0, 1, 31, 33, 131_072])
def test_kernel_equals_plain_on_card(cuda, S, wire, smooth):
    """Both directions, 30 steps, nvec 3 with NaN candidates: the four
    outputs of each bit-equal; one launch per direction."""
    emit, qscale, dmax = WIRES[wire]
    shape3 = (40, 36, 30)
    ov = _field(3, shape3, nan=True)
    pos0, vec0 = _seeds(S, ov, shape3)
    args = (30, shape3, STEP, COS45, smooth, 24, emit, qscale, dmax)
    t = [torch.from_numpy(a).to(cuda) for a in (
        pos0, vec0, np.zeros(S, np.int32), ov)]
    before = P.propagate_dir.launches
    fwd = P.propagate_dir(*t, *args)
    bwd = P.propagate_dir(t[0], -t[1], fwd[2], t[3], *args)
    torch.cuda.synchronize()
    assert P.propagate_dir.launches - before == (2 if S else 0)
    fwd_p = P.propagate_dir_plain(*t, *args)
    bwd_p = P.propagate_dir_plain(t[0], -t[1], fwd_p[2], t[3], *args)
    for g, w in zip(fwd + bwd, fwd_p + bwd_p):
        assert _same_bits(g, w)
    if S == 131_072:
        assert int(bwd[2].max()) > 24 and bool(fwd[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_stream_trk_through_kernel_equals_plain_on_card(cuda, wire, tmp_path,
                                                        monkeypatch):
    """`stream()` from a GQI fit's device peaks into a .trk: through the
    two-direction kernel (one launch a chunk) and through the plain loop,
    the same bytes."""
    from fibers_tpu_torch.utils.phantom import make_brain
    dwi, mask, _ = make_brain(shape=(32, 32, 20), ndir=34)
    pk = tt.peaks_to_ovecs(tt.gqi_rec(dwi, mask, tt.sphere_642),
                           device=True).first(1)
    kw = dict(mask=mask, nsub=3, f_thresh=0.0, wire=wire, chunk=8192)
    kern, plain = tmp_path / "kernel.trk", tmp_path / "plain.trk"
    before = P.propagate_pair.launches
    tr = tt.stream(pk, trk_sink=str(kern), **kw)
    nchunks = -(-3 * int((mask.vol > 0).sum()) // 8192)
    assert P.propagate_pair.launches - before == nchunks
    monkeypatch.setattr(stream_mod, "propagate_pair", P.propagate_pair_plain)
    tt.stream(pk, trk_sink=str(plain), **kw)
    assert tr.n_count > 0
    assert kern.read_bytes() == plain.read_bytes()


@pytest.mark.cuda
def test_sharded_stream_launches_per_shard_on_card(cuda):
    """On a two-shard mesh of card 0 each chunk makes one launch per
    shard, both directions, and the lines equal the unsharded run's."""
    from fibers_tpu_torch.parallel.mesh import Mesh
    from fibers_tpu_torch.utils.phantom import make_brain
    dwi, mask, _ = make_brain(shape=(24, 24, 16), ndir=34)
    pk = tt.peaks_to_ovecs(tt.gqi_rec(dwi, mask, tt.sphere_642),
                           device=True).first(1)
    mesh = Mesh(np.array([cuda, cuda], dtype=object), ("data",))
    kw = dict(mask=mask, nsub=3, f_thresh=0.0, chunk=4096)
    one = tt.stream(pk, **kw)
    before = P.propagate_pair.launches
    sh = tt.stream(pk, mesh=mesh, **kw)
    nchunks = -(-3 * int((mask.vol > 0).sum()) // 4096)
    assert P.propagate_pair.launches - before == 2 * nchunks
    assert sh.n_count == one.n_count > 0
    assert np.array_equal(sh.npts, one.npts)
    assert np.array_equal(sh.packed_xyz, one.packed_xyz)
