"""The LCM and microscopy step-loop kernels' modules
(fibers_tpu_torch/ops/kernels/propagate_lcm.py, propagate_micro.py) held
against the JAX package and against numpy references.

Tolerances:
- micro: `propagate_micro_dir_plain`, what a CPU tensor runs, equals
  `fibers_tpu.tract.modes._propagate_micro` bit for bit on all four
  outputs of both directions, with float32 points and on the integer
  wire (qscale = 1): jumps land on integer voxels from integer seeds and
  there is no smoothing (the microscopy default), so no rounding can
  differ;
- LCM: the draws are counter-based Philox uniforms in the port and
  `jax.random.categorical` in the JAX package, so the lines match in
  distribution: over 4,096 streams of the LCM phantom the mean line
  length within 3%, the share of streams that reach the length budget
  within 0.03 and the share of method-difference flags within 5% (over
  four keys a side the largest gaps seen were 0.5%, 0.009 and 1.0%); the
  turn rate
  of an LCM that opens the straight connection at 0.7 and the turn at
  0.3 within max(4 sigma, 0.05) of 0.3 in both packages, the bound of
  tests/test_stream.py:236; the seed jitter bit for bit;
- the generator: the torch Philox4x32-10 equals Random123's known-answer
  vectors and a numpy uint64 implementation word for word; its uniforms
  pass a Kolmogorov-Smirnov test against U(0, 1) at p > 1e-3.

The `cuda` tests hold both kernels to their plain versions on the card,
bit for bit on every output (points, deltas, flags, counts, anchors),
the self-checks of their arithmetic to torch's, and `stream()` through the
kernels to `stream()` through the plain loops, byte for byte in the .trk.
"""

import jax
import numpy as np
import pytest
import scipy.stats
import torch

import fibers_tpu as ft
from fibers_tpu.tract import modes as jax_modes
import fibers_tpu_torch as tt
from fibers_tpu_torch.ops.kernels import propagate_lcm as PL
from fibers_tpu_torch.ops.kernels import propagate_micro as PM
from fibers_tpu_torch.tract import modes
from fibers_tpu_torch.tract.modes import _search_window
from fibers_tpu_torch.utils.phantom import make_lcm_field, make_micro_field

from test_torch_modes import _lcm_corridor, _mask_mri, _mri
from test_torch_stream import as_port

MICRO_WIRES = {"f32": ("points", 1.0, 127), "int": ("deltas", 1.0, 127)}
LCM_WIRES = {"f32": ("points", 254.0, 127), "i8": ("deltas", 127 / 0.5, 127),
             "i6": ("deltas", 31 / 0.5, 31)}
KEY = (0x2545F491, 0x9E3779B9)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ #
# Microscopy
# ------------------------------------------------------------------ #

# shifts of far window cells: each a copy of the window, its directions
# reversed, ahead of it
FAR = ((2 ** 32, 0, 0), (0, -2 ** 32, 0), (2 ** 29, 0, 0), (0, 0, -2 ** 31),
       (0, 2 ** 33, 0))


def _micro_inputs(case, shape3=None, nan=False, n_seeds=None, sd=None,
                  tie=False, search=None, no_mask=False, far=False):
    """(numpy) pos0, vec0, mask_flat, vec_first, win_off, win_dir and the
    step loop's scalars from nsteps to len_max: the microscopy phantom's
    angles with a 2-D window, or a random field biased along +x with a 3-D
    window; integer seeds, each with its voxel's first vector.  `sd`: the
    window's search distance; `tie`: every voxel's vector +x; `search`:
    the cone's half-angle in degrees; `no_mask`: the mask all false after
    the seeds are taken; `far`: copies of the window `FAR` away ahead of
    it, with reversed directions."""
    rng = np.random.default_rng(3)
    if case == "field":
        shape3 = shape3 or (40, 36, 2)
        ang, mask = make_micro_field(shape3)
        a = ang.vol.reshape(-1)
        vf = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], 1)
        m = (mask.vol > 0).reshape(-1)
        sd = sd or (6, 6, 0)
    else:
        shape3 = shape3 or (24, 20, 14)
        vf = rng.standard_normal((int(np.prod(shape3)), 3)) + [1.5, 0, 0]
        vf /= np.linalg.norm(vf, axis=1, keepdims=True)
        m = rng.random(len(vf)) < 0.9
        sd = sd or (2, 2, 2)
    if tie:
        vf[:] = [1.0, 0.0, 0.0]
    vf = (vf * m[:, None]).astype(np.float32)
    if nan:
        vf[rng.random(len(vf)) < 0.02] = np.nan
    off, wdir = _search_window(sd)
    if far:
        off = np.concatenate([off.astype(np.int64) + f for f in FAR]
                             + [off])
        wdir = np.concatenate([-wdir] * len(FAR) + [wdir])
    seeds = np.argwhere(m.reshape(shape3))[::2][:n_seeds].astype(np.float32)
    flat = np.ravel_multi_index(seeds.astype(np.int64).T, shape3)
    if no_mask:
        m = np.zeros_like(m)
    nsteps, len_max = 24, 20
    ang, cone = (20.0, 10.0) if case == "field" else (70.0, 30.0)
    cone = cone if search is None else search
    scal = (nsteps, shape3, 1.0, float(np.cos(np.radians(ang))),
            float(np.cos(np.radians(cone))), 0.0, len_max)
    return seeds, vf[flat], m, vf, off, wdir, scal


def _micro_long_lines(n_seeds=2000, shape3=(6000, 40, 2)):
    """`_micro_inputs` for lines whose lengths spread over every step of
    1,026: a +x field with 1 degree of in-plane jitter along a 6,000-voxel
    strip, the seeds anywhere on it, a 2-D window, len_max 1,024."""
    rng = np.random.default_rng(4)
    a = np.radians(rng.normal(0.0, 1.0, int(np.prod(shape3))))
    vf = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)],
                  1).astype(np.float32)
    m = np.ones(len(vf), bool)
    seeds = np.stack([rng.integers(0, n, n_seeds) for n in shape3],
                     1).astype(np.float32)
    flat = np.ravel_multi_index(seeds.astype(np.int64).T, shape3)
    off, wdir = _search_window((6, 6, 0))
    scal = (1026, shape3, 1.0, float(np.cos(np.radians(20.0))),
            float(np.cos(np.radians(10.0))), 0.0, 1024)
    return seeds, vf[flat], m, vf, off, wdir, scal


def _both_micro(run, inp, wire):
    """Forward from zero points, backward from the forward counts: the
    eight outputs as numpy arrays."""
    pos0, vec0, m, vf, off, wdir, scal = inp
    zero = np.zeros(len(pos0), np.int32)
    fwd = [np.asarray(a) for a in run(pos0, vec0, zero, m, vf, off, wdir,
                                      *scal, *MICRO_WIRES[wire])]
    bwd = [np.asarray(a) for a in run(pos0, -vec0, fwd[2], m, vf, off, wdir,
                                      *scal, *MICRO_WIRES[wire])]
    return fwd + bwd


def _micro_jax(pos0, vec0, npts0, m, vf, off, wdir, *rest):
    return jax_modes._propagate_micro(pos0, vec0, npts0, m, vf[:, None, :],
                                      off, wdir, *rest)


def _micro_plain(pos0, vec0, npts0, m, vf, off, wdir, *rest):
    return PM.propagate_micro_dir_plain(
        _t(pos0), _t(vec0), _t(npts0), _t(m), _t(vf),
        _t(off.astype(np.int64)), _t(wdir), *rest)


@pytest.mark.parametrize("wire", ["f32", "int"])
@pytest.mark.parametrize("case", ["field", "random"])
def test_micro_plain_equals_jax(case, wire):
    inp = _micro_inputs(case)
    got = _both_micro(_micro_plain, inp, wire)
    want = _both_micro(_micro_jax, inp, wire)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    total = got[6]
    # the lines jump several times; some reach the budget or stop at once
    assert total.max() > 8 and (total <= 2).any() and total.mean() > 3


@pytest.mark.parametrize("case", ["field", "random"])
def test_micro_plain_rows_depend_only_on_their_own_stream(case):
    """The plain loop over a permuted third of the streams gives those
    streams' rows of the whole run, bit for bit on all eight outputs: the
    premise of the kernel's persistent warps, which take the streams in
    any order, and of chip_smoke.py's check on the first streams of a
    chunk."""
    pos0, vec0, m, vf, off, wdir, scal = _micro_inputs(case)
    full = _both_micro(_micro_plain, (pos0, vec0, m, vf, off, wdir, scal),
                       "f32")
    idx = np.random.default_rng(5).permutation(len(pos0))[:len(pos0) // 3]
    part = _both_micro(_micro_plain, (pos0[idx], vec0[idx], m, vf, off,
                                      wdir, scal), "f32")
    for i, (f, p) in enumerate(zip(full, part)):
        want = f[:, idx] if i % 4 < 2 else f[idx]
        assert p.dtype == want.dtype and np.array_equal(p, want)
    assert full[6].max() > 8


@pytest.mark.parametrize("nwin", [748, 136, 20, 3000])
def test_micro_chunk_follows_the_step_function(nwin):
    """The kernel on the card takes the configured chunk; the plain loop
    on the CPU the reference's rule (fibers_tpu/tract/modes.py:441),
    which sizes its [S, W, 3] window tensors, and so does the plain loop
    on the card, where chip_smoke.py's `plain_loop` puts
    `_reference_chunk` in `_micro_chunk`'s place."""
    for cfg in (tt.StreamConfig(), tt.StreamConfig(chunk=10_000)):
        rule = max(256, cfg.chunk // max(1, nwin // 32))
        assert modes._reference_chunk(cfg, nwin) == rule
        assert modes._micro_chunk(cfg, nwin, torch.device("cpu")) == rule
        assert modes._micro_chunk(cfg, nwin,
                                  torch.device("cuda")) == cfg.chunk
    assert modes._reference_chunk(tt.StreamConfig(), 748) == 5698


@pytest.mark.parametrize("wire", ["f32", "i8"])
def test_micro_lines_do_not_depend_on_the_chunk(wire, tmp_path,
                                                monkeypatch):
    """stream() on the CPU at the reference's chunk (one chunk here) and
    at chunks of 150 streams: the same lines and the same .trk bytes.
    Micro lines have no draws (LCM's depend on the chunk: ROADMAP C16)."""
    ov, mask = make_micro_field((40, 36, 2))
    kw = dict(mask=mask, search_dist=6, len_max=30, nsub=None,
              ang_thresh=None, step_size=None, smooth_coeff=None, wire=wire,
              device="cpu")
    one = tt.stream(ov, **kw)
    tt.stream(ov, trk_sink=str(tmp_path / "one.trk"), **kw)
    monkeypatch.setattr(modes, "_micro_chunk", lambda *a: 150)
    calls = PM.propagate_micro_dir_plain
    seen = []
    monkeypatch.setattr(modes, "propagate_micro_dir",
                        lambda *a: seen.append(len(a[0])) or calls(*a))
    many = tt.stream(ov, **kw)
    tt.stream(ov, trk_sink=str(tmp_path / "many.trk"), **kw)
    assert len(seen) > 2 and max(seen) == 150
    assert one.n_count == many.n_count > 0
    assert np.array_equal(one.npts, many.npts)
    assert np.array_equal(one.packed_xyz, many.packed_xyz)
    assert ((tmp_path / "one.trk").read_bytes()
            == (tmp_path / "many.trk").read_bytes())


@pytest.mark.parametrize("shape3, bits", [
    ((1024, 1024, 2), 32), ((1290, 1290, 1290), 32),
    ((2048, 1024, 1024), 64), ((1291, 1291, 1291), 64),
    ((2 ** 29 - 1, 3, 1), 32), ((2 ** 29, 2, 1), 64), ((2 ** 31, 1, 1), 64)])
def test_micro_kernel_index_bits(shape3, bits):
    """The wrapper's choice of the kernel's index arithmetic: 32-bit below
    2^31 voxels with each dimension below 2^29, else 64-bit."""
    assert PM._index_bits(shape3) == bits


def _int32_wrap(off):
    """Offsets as an int32 cast would hold them."""
    return (off + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.parametrize("wire", ["f32", "int"])
@pytest.mark.parametrize("case", ["field", "random"])
def test_micro_far_cells_never_count(case, wire):
    """Window cells 2^29 to 2^33 voxels away (`_micro_inputs(far=True)`)
    change no output: from a voxel in the volume they lie outside it, and
    from one outside nothing is saved.  The kernel takes such a cell as
    padding.  Held as an int32 would hold them, they would land back in
    the volume and change the lines, which the `cuda` case "far" would
    catch."""
    near = _micro_inputs(case)
    far = _micro_inputs(case, far=True)
    assert len(far[4]) > len(near[4]) and np.abs(far[4]).max() >= 2 ** 32
    got = _both_micro(_micro_plain, far, wire)
    want = _both_micro(_micro_plain, near, wire)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    wrapped = far[:4] + (_int32_wrap(far[4]),) + far[5:]
    moved = _both_micro(_micro_plain, wrapped, wire)
    assert not all(np.array_equal(m, w) for m, w in zip(moved, want))


# ------------------------------------------------------------------ #
# LCM: the counter-based generator
# ------------------------------------------------------------------ #

def _philox_numpy(c, k):
    """Philox4x32-10 in numpy uint64 (products of two 32-bit words are
    exact there): counters c [..., 4] and keys k [..., 2] of uint32."""
    m32 = np.uint64(0xFFFFFFFF)
    c = [c[..., i].astype(np.uint64) for i in range(4)]
    k0, k1 = k[..., 0].astype(np.uint64), k[..., 1].astype(np.uint64)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & m32
        k1 = (k1 + np.uint64(0xBB67AE85)) & m32
    return np.stack(c, -1).astype(np.uint32)


def _uniforms_numpy(key, s, t):
    """The [s, 10] uniforms `lcm_uniforms` documents, from `_philox_numpy`:
    counter (i, t, j // 4, 0), word j % 4, top 24 bits times 2^-24,
    clamped at the smallest normal float."""
    i, blk = np.meshgrid(np.arange(s), np.arange(3), indexing="ij")
    c = np.stack([i, np.full_like(i, t), blk, np.zeros_like(i)], -1)
    w = _philox_numpy(c.astype(np.uint32),
                      np.broadcast_to(np.array(key, np.uint32), (s, 3, 2)))
    u = (w.reshape(s, 12)[:, :10] >> 8).astype(np.float32) * np.float32(
        2.0 ** -24)
    return np.maximum(u, np.finfo(np.float32).tiny)


# Random123's known-answer vectors for Philox4x32-10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                               0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("kat", range(len(KAT)))
def test_philox_known_answers(kat):
    c, k, want = KAT[kat]
    got = PL.philox4x32_10(*[torch.tensor([x], dtype=torch.int64)
                             for x in c], k)
    assert [int(w) for w in got] == list(want)
    assert _philox_numpy(np.array(c, np.uint32),
                         np.array(k, np.uint32)).tolist() == list(want)


def test_philox_equals_numpy_reference():
    """Random counters and keys, with the words' extremes: the torch
    version (int64, 16-bit halves) equals numpy's uint64 products."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2 ** 32, (4096, 4), dtype=np.uint64)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64)
    c[:4] = [[0] * 4, [2 ** 32 - 1] * 4, [1, 2 ** 31, 2 ** 16, 2 ** 32 - 2],
             [2 ** 32 - 1, 0, 2 ** 32 - 1, 0]]
    got = torch.stack(PL.philox4x32_10(*_t(c.astype(np.int64)).unbind(1),
                                       (int(k[0]), int(k[1]))), 1)
    want = _philox_numpy(c.astype(np.uint32), np.broadcast_to(
        k.astype(np.uint32), (len(c), 2)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("t", [0, 1, 1025])
def test_lcm_uniforms_equal_numpy_reference(t):
    got = PL.lcm_uniforms(KEY, 3000, t)
    assert got.dtype == torch.float32 and got.shape == (3000, 10)
    assert np.array_equal(got.numpy(), _uniforms_numpy(KEY, 3000, t))


def test_lcm_uniforms_are_uniform():
    """Each of the ten elements, and all of them over two keys and steps,
    against U(0, 1); neighbouring elements and steps uncorrelated."""
    a = PL.lcm_uniforms(KEY, 4096, 7).double().numpy()
    b = PL.lcm_uniforms((KEY[1], KEY[0]), 4096, 8).double().numpy()
    for u in [a[:, j] for j in range(10)] + [np.concatenate([a, b]).ravel()]:
        assert scipy.stats.kstest(u, "uniform").pvalue > 1e-3
    assert 0.0 < a.min() and a.max() < 1.0
    for x, y in ((a[:, :-1].ravel(), a[:, 1:].ravel()),
                 (a.ravel(), b.ravel())):
        assert abs(np.corrcoef(x, y)[0, 1]) < 0.02


# ------------------------------------------------------------------ #
# LCM: the plain loop against the JAX package
# ------------------------------------------------------------------ #

def _lcm_inputs(shape=(32, 32), nsub=2, neg=False, smooth=0.2):
    """The LCM phantom as `stream_lcm` hands it to the step loop: mask,
    the two orientation volumes' candidates, the thresholded LCM rows,
    dxyz, strdims (0, 1); jittered seeds and their first vectors."""
    ovecs, lcm, _ = make_lcm_field(shape)
    ov = np.stack([o.vol.reshape(-1, 3) for o in ovecs], 1).astype(
        np.float32)
    lv = lcm.vol.reshape(-1, 10).astype(np.float32)
    if neg:                         # a user's LCM with negative elements
        lv = lv - np.float32(0.12)
    thresh = -0.05 if neg else 0.099
    lv = lv * (lv >= thresh)
    rng = np.random.default_rng(1)
    vox = np.argwhere(np.ones(shape + (1,), bool)).astype(np.float32)
    subs = rng.uniform(-0.49, 0.49, (nsub, 3)).astype(np.float32)
    subs[:, 2] = 0.0
    seeds = np.repeat(vox, nsub, 0) + np.tile(subs, (len(vox), 1))
    flat = np.ravel_multi_index(np.rint(seeds).astype(np.int64).T,
                                shape + (1,))
    dxyz = np.zeros((3, 4), np.int64)
    dxyz[0] = [-1, 0, 1, 0]
    dxyz[1] = [0, -1, 0, 1]
    n = max(shape)
    return dict(pos0=seeds, vec0=ov[flat, 0], mask=np.ones(len(lv), bool),
                ov=ov, lv=lv, dxyz=dxyz, shape3=shape + (1,), nsteps=n + 2,
                len_max=n, smooth=smooth)


def _lcm_plain(d, wire="f32", key=KEY, device="cpu", run=None):
    """Both directions through `run` (default the plain loop): the ten
    outputs as tensors."""
    run = run or PL.propagate_lcm_dir_plain
    t = lambda a: _t(a).to(device)
    edget = torch.from_numpy(PL.EDGETYPE.astype(np.int64)).to(device)
    rest = (t(d["mask"]), t(d["ov"]), t(d["lv"]), t(d["dxyz"]), edget,
            [0, 1], d["nsteps"], d["shape3"], 0.5, d["smooth"], d["len_max"],
            *LCM_WIRES[wire])
    pos0, vec0 = t(d["pos0"]), t(d["vec0"])
    zero = torch.zeros(len(pos0), dtype=torch.int32, device=device)
    fwd = run(key, pos0, vec0, zero, *rest)
    bwd = run((key[1], key[0]), pos0, -vec0, fwd[3], *rest)
    return list(fwd) + list(bwd)


def _lcm_jax(d, seed):
    kf, kb = jax.random.split(jax.random.PRNGKey(seed))
    rest = (d["mask"], d["ov"], d["lv"], d["dxyz"].astype(np.int32),
            d["nsteps"], d["shape3"], 0.5, d["smooth"], d["len_max"])
    zero = np.zeros(len(d["pos0"]), np.int32)
    fwd = jax_modes._propagate_lcm(kf, d["pos0"], d["vec0"], zero, *rest)
    bwd = jax_modes._propagate_lcm(kb, d["pos0"], -d["vec0"], fwd[3], *rest)
    return [np.asarray(a) for a in list(fwd) + list(bwd)]


def _lcm_stats(outs, len_max):
    """Mean line length, share of lines that reach the budget, share of
    saved points flagged."""
    outs = [np.asarray(o) for o in outs]
    nflag = outs[2].astype(np.int64).sum() + outs[7].astype(np.int64).sum()
    total = outs[8]
    return (total.mean(), (total > len_max).mean(),
            nflag / (outs[1].sum() + outs[6].sum()))


def test_lcm_plain_matches_jax_in_distribution():
    d = _lcm_inputs((32, 32), nsub=4)
    mean_p, full_p, flag_p = _lcm_stats(_lcm_plain(d), d["len_max"])
    mean_j, full_j, flag_j = _lcm_stats(_lcm_jax(d, 5), d["len_max"])
    assert mean_p > 8 and 0.05 < full_p < 0.95 and 0.01 < flag_p < 0.9
    assert abs(mean_p / mean_j - 1) < 0.03
    assert abs(full_p - full_j) < 0.03
    assert abs(flag_p / flag_j - 1) < 0.05


def _turn_field():
    """tests/test_torch_modes.py's transition set-up: +x and +y vectors,
    the straight x connection at 0.7, the +y turn at 0.3."""
    nx, ny = 48, 64
    shape = (nx, ny, 1)
    vx = np.zeros(shape + (3,), np.float32)
    vx[..., 0] = 1.0
    vx[nx - 1, ny - 1, 0, 1] = 1e-3      # through-plane detected as z
    vy = np.zeros(shape + (3,), np.float32)
    vy[..., 1] = 1.0
    lcm = np.zeros(shape + (10,), np.float32)
    lcm[..., 2] = 0.7
    lcm[..., 3] = 0.3
    lcm[..., 6] = 1.0
    seedm = np.zeros(shape, bool)
    seedm[0, :, 0] = True
    ovx = _mri(vx)
    return ([ovx, _mri(vy)], _mask_mri(ovx, np.ones(shape, bool)),
            _mask_mri(ovx, seedm), _mri(lcm))


def _turn_rate(tract):
    turns = x_entries = 0
    for m in tract.xyz:
        p = np.asarray(m).T
        dp = np.diff(p, axis=0)
        dp = dp[np.abs(dp).sum(axis=1) > 1e-6]
        is_x = np.abs(dp[:, 0]) > np.abs(dp[:, 1])
        x_entries += int(is_x.sum())
        turns += bool(is_x.any() and (~is_x).any())
    return turns, x_entries


def test_lcm_transition_frequencies_match_jax():
    """The turn rate per x entry through the port's kernel module (the
    plain loop on the CPU) and the JAX package, each within the reference
    test's bound of the LCM's 0.3."""
    ovs, mask, seed, lcm = _turn_field()
    kw = dict(mask=mask, seed=seed, lcms=lcm, nsub=0, step_size=1.0,
              smooth_coeff=0.0, len_max=150, seed_rng=4)
    for tract in (tt.stream(as_port(ovs), device="cpu", **kw),
                  ft.stream(ovs, wire="f32", **kw)):
        turns, x_entries = _turn_rate(tract)
        assert x_entries > 150
        sigma = np.sqrt(0.3 * 0.7 / x_entries)
        assert abs(turns / x_entries - 0.3) < max(4 * sigma, 0.05)


def test_lcm_plain_keeps_the_jitter():
    """The forward direction saves each stream's (jittered) seed first,
    bit for bit, and the stream's seeds are the JAX package's."""
    d = _lcm_inputs((16, 16), nsub=3)
    outs = _lcm_plain(d)
    first, saved0 = outs[0][0], outs[1][0]
    assert saved0.float().mean() > 0.5
    assert torch.equal(first[saved0].view(torch.int32),
                       _t(d["pos0"])[saved0].view(torch.int32))
    ov, mask, seed, lcmm = _lcm_corridor()
    kw = dict(mask=mask, seed=seed, lcms=lcmm, nsub=3, step_size=0.25,
              len_max=6, len_min=1, seed_rng=11)
    tj = ft.stream(ov, wire="f32", **kw)
    tr = tt.stream(as_port(ov), device="cpu", **kw)
    assert tr.n_count == tj.n_count == 12
    dup = lambda t: np.stack([p[np.flatnonzero(np.all(p[1:] == p[:-1], 1))[0]]
                              for p in np.split(t.packed_xyz,
                                                np.cumsum(t.npts)[:-1])])
    assert np.array_equal(dup(tr).view(np.uint32), dup(tj).view(np.uint32))


def test_lcm_plain_draws_depend_only_on_key_stream_and_step():
    """The counter-based draws: the same key gives the same lines, a
    stream's line does not depend on the other streams of its chunk, and
    another key gives other lines."""
    d = _lcm_inputs((16, 16), nsub=2)
    a = _lcm_plain(d)
    assert all(torch.equal(x, y) for x, y in zip(a, _lcm_plain(d)))
    half = len(d["pos0"]) // 2
    other_seeds = dict(d, pos0=np.concatenate([d["pos0"][half:][::-1],
                                               d["pos0"][half:]]),
                       vec0=np.concatenate([d["vec0"][half:][::-1],
                                            d["vec0"][half:]]))
    b = _lcm_plain(other_seeds)
    for i, (x, y) in enumerate(zip(a, b)):  # streams half.. kept their index
        axis = 0 if i % 5 in (3, 4) else 1   # npts, anchor: [S], [S, 3]
        assert torch.equal(x.narrow(axis, half, half),
                           y.narrow(axis, half, half))
    assert not torch.equal(a[0][:, :half], b[0][:, :half])
    other = _lcm_plain(d, key=(KEY[0] + 1, KEY[1]))
    assert not torch.equal(a[0], other[0])


# ------------------------------------------------------------------ #
# The wrappers on the CPU
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("wire", ["f32", "int"])
def test_micro_wrapper_takes_cpu_tensors_to_plain(wire):
    pos0, vec0, m, vf, off, wdir, scal = _micro_inputs("field")
    args = (_t(pos0), _t(vec0), torch.zeros(len(pos0), dtype=torch.int32),
            _t(m), _t(vf), _t(off.astype(np.int64)), _t(wdir), *scal,
            *MICRO_WIRES[wire])
    before = PM.propagate_micro_dir.launches
    got = PM.propagate_micro_dir(*args)
    want = PM.propagate_micro_dir_plain(*args)
    assert PM.propagate_micro_dir.launches == before == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_lcm_wrapper_takes_cpu_tensors_to_plain(wire):
    d = _lcm_inputs((16, 16))
    before = PL.propagate_lcm_dir.launches
    got = _lcm_plain(d, wire, run=PL.propagate_lcm_dir)
    want = _lcm_plain(d, wire)
    assert PL.propagate_lcm_dir.launches == before == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_modes_on_cpu_launch_no_kernel():
    ovecs, lcm, lmask = make_lcm_field((12, 12))
    mov, mmask = make_micro_field((16, 14, 2))
    before = (PL.propagate_lcm_dir.launches, PM.propagate_micro_dir.launches)
    a = tt.stream(ovecs, mask=lmask, lcms=lcm, device="cpu")
    b = tt.stream(mov, mask=mmask, search_dist=4, device="cpu", nsub=None)
    assert a.n_count > 0 and b.n_count > 0
    assert (PL.propagate_lcm_dir.launches,
            PM.propagate_micro_dir.launches) == before == (0, 0)


def _micro_args():
    pos0, vec0, m, vf, off, wdir, scal = _micro_inputs("random",
                                                      n_seeds=40)
    return [_t(pos0), _t(vec0), torch.zeros(len(pos0), dtype=torch.int32),
            _t(m), _t(vf), _t(off.astype(np.int64)), _t(wdir)], list(scal)


def _lcm_args():
    d = _lcm_inputs((8, 8))
    t = [_t(d["pos0"]), _t(d["vec0"]),
         torch.zeros(len(d["pos0"]), dtype=torch.int32), _t(d["mask"]),
         _t(d["ov"]), _t(d["lv"]), _t(d["dxyz"]),
         torch.from_numpy(PL.EDGETYPE.astype(np.int64))]
    return t, [[0, 1], d["nsteps"], d["shape3"], 0.5, 0.2, d["len_max"]]


BAD = {
    "vec0 not contiguous": (1, lambda x: torch.cat([x, x], 1)[:, ::2]),
    "pos0 float64": (0, lambda x: x.double()),
    "npts0 int64": (2, lambda x: x.long()),
    "mask of another volume": (3, lambda x: x[:-1]),
    "mask not contiguous": (3, lambda x: torch.stack([x, x], 1)[:, 0]),
    "a table on another device": (4, lambda x: x.to("meta")),
}


@pytest.mark.parametrize("case", sorted(BAD))
@pytest.mark.parametrize("mode", ["micro", "lcm"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(mode, case):
    i, bad = BAD[case]
    t, rest = _micro_args() if mode == "micro" else _lcm_args()
    t[i] = bad(t[i])
    with pytest.raises((TypeError, ValueError)):
        if mode == "micro":
            PM.propagate_micro_dir(*t, *rest)
        else:
            PL.propagate_lcm_dir(KEY, *t, *rest)


@pytest.mark.parametrize("bad", ["emit", "dmax", "window", "strdims",
                                 "device"])
def test_wrappers_raise_on_bad_options(bad):
    t, rest = _micro_args()
    tl, restl = _lcm_args()
    with pytest.raises((TypeError, ValueError)):
        if bad == "emit":
            PM.propagate_micro_dir(*t, *rest, "pixels")
        elif bad == "dmax":
            PL.propagate_lcm_dir(KEY, *tl, *restl, "deltas", 62.0, 200)
        elif bad == "window":
            t[5], t[6] = t[5][:0], t[6][:0]
            PM.propagate_micro_dir(*t, *rest)
        elif bad == "strdims":
            restl[0] = [1, 1]
            PL.propagate_lcm_dir(KEY, *tl, *restl)
        else:
            PL.propagate_lcm_dir(KEY, *[x.to("meta") for x in tl], *restl)


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LCM and micro kernels are "
                    "CUDA")
    return torch.device("cuda")


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
def test_window_sums_order_on_card(cuda):
    """The micro kernel's window sums of three are torch's on the card,
    at W = 748 (search_dist 15 in 2-D) and in 3-D (W = 257)."""
    assert PM.window_selfcheck(device=cuda) == 0
    assert PM.window_selfcheck((4, 4, 4), 1024, device=cuda) == 0


@pytest.mark.cuda
def test_lcm_arithmetic_on_card(cuda):
    """logf, the Gumbel transform of every uniform, the sum of ten, the
    argmax, the uniforms and the pruned draw of the LCM kernel are torch's
    on the card, and no Gumbel term exceeds the draw's bound."""
    assert PL.lcm_selfcheck(1 << 20, device=cuda) == dict(
        log=0, gumbel=0, sum10=0, argmax10=0, uniforms=0, draw=0,
        gumbel_max=0)


MICRO_CARD = {
    "field": lambda: _micro_inputs("field", (200, 180, 2)),
    "budget": lambda: _micro_inputs("field", (200, 180, 2), n_seeds=33),
    "random": lambda: _micro_inputs("random", (30, 26, 20)),
    "nan": lambda: _micro_inputs("random", (30, 26, 20), nan=True),
    # lines ending at every step of 1,026
    "lengths": _micro_long_lines,
    # ~50k streams: more than the card holds warps, so warps take streams
    # as others stop
    "many": lambda: _micro_inputs("field", (300, 240, 2)),
    # a 3-D window of 2,552 cells: two shared-memory tiles, the second
    # ragged
    "tiled": lambda: _micro_inputs("random", (30, 26, 20), sd=(8, 8, 8),
                                   n_seeds=2000),
    "narrow": lambda: _micro_inputs("random", (30, 26, 20), sd=(1, 1, 1)),
    # every cell the same vector: the lowest cell wins
    "ties": lambda: _micro_inputs("random", (30, 26, 20), tie=True),
    "no_cone": lambda: _micro_inputs("random", (30, 26, 20), search=0.0),
    "no_mask": lambda: _micro_inputs("random", (30, 26, 20), no_mask=True),
    # window cells 2^29 to 2^33 voxels away, which never count
    "far": lambda: _micro_inputs("field", (200, 180, 2), far=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int"])
@pytest.mark.parametrize("case", sorted(MICRO_CARD))
def test_micro_kernel_equals_plain_on_card(cuda, case, wire):
    """Both directions: the eight outputs bit-equal; one launch each."""
    inp = MICRO_CARD[case]()
    pos0, vec0, m, vf, off, wdir, scal = inp
    t = [_t(a).to(cuda) for a in (pos0, vec0, m, vf, off.astype(np.int64),
                                  wdir)]
    if case == "budget":
        scal = scal[:-1] + (5,)         # the budget cuts most lines
    rest = (*t[2:], *scal, *MICRO_WIRES[wire])
    zero = torch.zeros(len(pos0), dtype=torch.int32, device=cuda)
    before = PM.propagate_micro_dir.launches
    fwd = PM.propagate_micro_dir(t[0], t[1], zero, *rest)
    bwd = PM.propagate_micro_dir(t[0], -t[1], fwd[2], *rest)
    torch.cuda.synchronize()
    assert PM.propagate_micro_dir.launches - before == 2
    fwd_p = PM.propagate_micro_dir_plain(t[0], t[1], zero, *rest)
    bwd_p = PM.propagate_micro_dir_plain(t[0], -t[1], fwd_p[2], *rest)
    for g, w in zip(fwd + bwd, fwd_p + bwd_p):
        assert _same_bits(g, w)
    if case in ("no_cone", "no_mask"):
        assert int(bwd[2].max()) == 0
    else:
        assert int(bwd[2].max()) > 3
    if case == "lengths":
        n = fwd[2]
        assert int(n.min()) < 20 and int(n.max()) > 900
    elif case == "many":
        assert len(pos0) >= 20_000
    elif case == "tiled":
        assert len(off) > 2048 and len(off) % 32
    elif case == "narrow":
        assert len(off) < 32


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [0.0, 0.2])
@pytest.mark.parametrize("wire", ["f32", "i8", "i6"])
@pytest.mark.parametrize("case", ["phantom", "negative", "one"])
def test_lcm_kernel_equals_plain_on_card(cuda, case, wire, smooth):
    """Both directions: the ten outputs (points or deltas, saved, flags,
    counts, anchors) bit-equal; one launch each."""
    d = _lcm_inputs((48, 48), nsub=3, neg=case == "negative",
                    smooth=smooth)
    if case == "one":
        d = dict(d, pos0=d["pos0"][:1], vec0=d["vec0"][:1])
    before = PL.propagate_lcm_dir.launches
    got = _lcm_plain(d, wire, device=cuda, run=PL.propagate_lcm_dir)
    torch.cuda.synchronize()
    assert PL.propagate_lcm_dir.launches - before == 2
    want = _lcm_plain(d, wire, device=cuda)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    assert int(got[8].max()) > 3
    if case != "one":
        assert bool(got[2].any())                # some flags set


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lcm", "micro"])
def test_stream_trk_through_kernels_equals_plain_on_card(cuda, mode,
                                                         tmp_path,
                                                         monkeypatch):
    """`stream()` into a .trk through the kernel (two launches a chunk)
    and through the plain loop: the same bytes."""
    if mode == "lcm":
        ovecs, lcm, mask = make_lcm_field((64, 64))
        kw = dict(mask=mask, lcms=lcm, nsub=3, chunk=5000)
        nchunks = -(-64 * 64 * 3 // 5000)
        fn, name = PL.propagate_lcm_dir, "propagate_lcm_dir"
        plain = PL.propagate_lcm_dir_plain
    else:
        ovecs, mask = make_micro_field((64, 60, 2))
        kw = dict(mask=mask, search_dist=15, nsub=None, ang_thresh=None,
                  step_size=None, smooth_coeff=None)
        nchunks = 1
        fn, name = PM.propagate_micro_dir, "propagate_micro_dir"
        plain = PM.propagate_micro_dir_plain
    kern, ref = tmp_path / "kernel.trk", tmp_path / "plain.trk"
    before = fn.launches
    tr = tt.stream(ovecs, trk_sink=str(kern), **kw)
    assert fn.launches - before == 2 * nchunks
    monkeypatch.setattr(modes, name, plain)
    tt.stream(ovecs, trk_sink=str(ref), **kw)
    assert tr.n_count > 0
    assert kern.read_bytes() == ref.read_bytes()
