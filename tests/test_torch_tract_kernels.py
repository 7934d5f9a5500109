"""The two thread-per-stream tractography kernels as redesigned for
Hopper: the deterministic integrator's two-direction entry
(fibers_tpu_torch/ops/kernels/propagate.py:propagate_pair) and the LCM
kernel's pruned draw (propagate_lcm.py, csrc/propagate_lcm.cu:draw), with
the step loops' point counts.

Tolerances:
- `propagate_pair_plain`, what a CPU tensor runs, equals two
  `propagate_dir_plain` calls bit for bit, and the JAX package's
  `_propagate` pair bit for bit without smoothing (with smoothing XLA's
  FMA moves last bits: tests/test_torch_propagate.py holds those), at a
  length budget that cuts many lines;
- the pruned draw, modelled in torch operations (`_pruned_draw`), picks
  the element that torch.argmax picks over all ten, exactly, on every row;
- a direction's point count, its npts less the npts it started from,
  equals its saved steps' sum exactly, in the three step loops.

The `cuda` tests hold the kernels to the plain versions on the card, bit
for bit on every output, at budgets that bind, for the compile-time
candidate counts (1, 3, 5) and the run-time loop (2), with and without
smoothing.
"""

import numpy as np
import pytest
import torch

from fibers_tpu.tract.stream import _propagate as jax_propagate
from fibers_tpu_torch.ops.kernels import propagate as P
from fibers_tpu_torch.ops.kernels import propagate_lcm as PL
from fibers_tpu_torch.ops.kernels import propagate_micro as PM

from test_torch_modes_kernels import (LCM_WIRES, MICRO_WIRES, _lcm_inputs,
                                      _lcm_plain, _micro_inputs, _t)
from test_torch_propagate import (COS45, SHAPE3, STEP, WIRES, _field,
                                  _same_bits, _seeds)


def _pair_args(nsteps, len_max, smooth, wire, shape3=SHAPE3):
    emit, qscale, dmax = WIRES[wire]
    return (nsteps, shape3, STEP, COS45, smooth, len_max, emit, qscale,
            dmax)


# ------------------------------------------------------------------ #
# Both directions in one call
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("smooth", [0.0, 0.2])
@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_pair_plain_is_two_directions(wire, smooth):
    """The backward direction from the forward counts: every output of
    the two `propagate_dir_plain` calls but the backward anchor."""
    ov = _field(3)
    pos0, vec0 = _seeds(500, ov)
    t = [torch.from_numpy(a) for a in (pos0, vec0, np.zeros(500, np.int32),
                                       ov)]
    args = _pair_args(24, 12, smooth, wire)
    got = P.propagate_pair_plain(*t, *args)
    fwd = P.propagate_dir_plain(*t, *args)
    bwd = P.propagate_dir_plain(t[0], -t[1], fwd[2], t[3], *args)
    assert len(got) == 7
    for g, w in zip(got, fwd + bwd[:3]):
        assert _same_bits(g, w)
    assert (got[6] > 12).any() and (got[6] - got[2] >= 1).any()


@pytest.mark.parametrize("wire", ["f32", "i8", "i6"])
@pytest.mark.parametrize("nvec", [1, 2, 3, 5])
def test_pair_plain_matches_jax_propagate_at_a_binding_budget(nvec, wire):
    """600 streams, 24 steps, a budget of 10 points: the forward and
    backward outputs equal the JAX package's two `_propagate` calls."""
    ov = _field(nvec)
    pos0, vec0 = _seeds(600, ov)
    args = _pair_args(24, 10, 0.0, wire)
    got = [g.numpy() for g in P.propagate_pair_plain(
        *(torch.from_numpy(a) for a in (pos0, vec0, np.zeros(600, np.int32),
                                        ov)), *args)]
    zero = np.zeros(600, np.int32)
    fwd = [np.asarray(a) for a in jax_propagate(pos0, vec0, zero, ov, *args)]
    bwd = [np.asarray(a) for a in jax_propagate(pos0, -vec0, fwd[2], ov,
                                                *args)]
    for g, w in zip(got, fwd + bwd[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the budget binds: the backward chain of some lines is cut short
    total, nf = got[6], got[2]
    assert (total == 11).sum() > 20 and ((total - nf) < (24 - nf)).any()


@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_pair_wrapper_takes_cpu_tensors_to_plain(wire):
    ov = _field(1)
    pos0, vec0 = _seeds(200, ov)
    t = [torch.from_numpy(a) for a in (pos0, vec0, np.zeros(200, np.int32),
                                       ov)]
    args = _pair_args(20, 16, 0.2, wire)
    before = (P.propagate_pair.launches, P.propagate_dir.launches)
    got = P.propagate_pair(*t, *args)
    want = P.propagate_pair_plain(*t, *args)
    assert (P.propagate_pair.launches, P.propagate_dir.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["pos0 float64", "npts0 int64",
                                  "field of another volume",
                                  "a device with no kernel"])
def test_pair_wrapper_raises_on_what_the_kernel_does_not_take(case):
    ov = _field(1)
    pos0, vec0 = _seeds(50, ov)
    pos0, vec0, npts0, ov = (torch.from_numpy(a) for a in (
        pos0, vec0, np.zeros(50, np.int32), ov))
    if case == "pos0 float64":
        pos0 = pos0.double()
    elif case == "npts0 int64":
        npts0 = npts0.long()
    elif case == "field of another volume":
        ov = ov[:-1]
    else:
        pos0, vec0, npts0, ov = (a.to("meta") for a in (pos0, vec0, npts0,
                                                        ov))
    with pytest.raises((TypeError, ValueError)):
        P.propagate_pair(pos0, vec0, npts0, ov, *_pair_args(20, 16, 0.2,
                                                            "f32"))


# ------------------------------------------------------------------ #
# The counts of each direction
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("loop", ["deterministic", "lcm", "micro"])
def test_direction_counts_are_npts_less_npts0(loop):
    """A save adds one to npts and nothing else does, so npts - npts0 is
    the direction's saved-step count (what the stream stage takes)."""
    if loop == "deterministic":
        ov = _field(3)
        pos0, vec0 = _seeds(400, ov)
        npts0 = np.random.default_rng(2).integers(0, 5, 400).astype(np.int32)
        t = [torch.from_numpy(a) for a in (pos0, vec0, npts0, ov)]
        out = P.propagate_dir_plain(*t, *_pair_args(24, 14, 0.2, "i6"))
        saved, npts = out[1], out[2]
    elif loop == "lcm":
        d = _lcm_inputs((24, 24), nsub=2)
        d = dict(d, len_max=9)
        outs = _lcm_plain(d, "f32")
        npts0 = outs[3].numpy()                  # the backward direction's
        saved, npts = outs[6], outs[8]
    else:
        pos0, vec0, m, vf, off, wdir, scal = _micro_inputs("random",
                                                           (30, 26, 20))
        npts0 = np.random.default_rng(3).integers(0, 4, len(pos0)).astype(
            np.int32)
        out = PM.propagate_micro_dir_plain(
            _t(pos0), _t(vec0), _t(npts0), _t(m), _t(vf),
            _t(off.astype(np.int64)), _t(wdir), *scal,
            *MICRO_WIRES["f32"])
        saved, npts = out[1], out[2]
    counts = npts - torch.from_numpy(np.asarray(npts0))
    assert torch.equal(counts, saved.sum(dim=0, dtype=torch.int32))
    assert int(counts.max()) > 2


# ------------------------------------------------------------------ #
# The LCM kernel's pruned draw, as a model in torch operations
# ------------------------------------------------------------------ #

_GUMBEL_MAX = 17.0          # csrc/propagate_lcm.cu:kGumbelMax


def _gumbel(u):
    return -torch.log(-torch.log(u))


def _values(m, keep, u):
    """The draw's ten values: log of the masked row clamped at 1e-30, plus
    the Gumbel term of each uniform."""
    masked = torch.where(keep, m, 0.0)
    return torch.log(torch.clamp_min(masked, 1e-30)) + _gumbel(u)


def _pruned_draw(m, keep, u):
    """The kernel's rule: the argmax over the kept elements alone (NaN
    wins, the lowest index among equals), taken when that best value is
    NaN or above L0 + kGumbelMax (L0 = log(1e-30)); else the argmax over
    all ten."""
    vals = _values(m, keep, u)
    kept = torch.where(keep, vals, -torch.inf)
    ib = torch.argmax(kept, dim=1)
    best = kept.gather(1, ib[:, None])[:, 0]
    l0 = torch.log(torch.tensor(1e-30, dtype=torch.float32))
    ceiling = l0 + torch.tensor(_GUMBEL_MAX, dtype=torch.float32)
    ok = keep.any(dim=1) & (torch.isnan(best) | (best > ceiling))
    return torch.where(ok, ib, torch.argmax(vals, dim=1)), ok


def _entry_keep(entry):
    e = torch.from_numpy(PL.EDGETYPE.astype(np.int64))
    return (e[0][None] == entry[:, None]) | (e[1][None] == entry[:, None])


_DRAW_CASES = ["phantom", "random", "tiny", "zero", "nan", "ties",
               "no_lcm", "uniform_ends", "random_keep"]


@pytest.mark.parametrize("case", _DRAW_CASES)
def test_lcm_pruned_draw_equals_the_full_argmax(case):
    """200,000 rows a case: the pruned rule's element is torch.argmax's
    over the ten values of the masked row, for LCM rows like the
    phantom's, random ones, values below the logits' clamp, zeros, NaNs,
    ties, rows with no LCM at all (havelcm false: the kernel then draws
    nothing, the rule still agrees), uniforms at both ends of their range,
    and masks other than an entry edge's."""
    g = torch.Generator().manual_seed(_DRAW_CASES.index(case))
    n = 200_000
    entry = torch.randint(0, 4, (n,), generator=g)
    keep = _entry_keep(entry)
    m = 0.1 + 0.15 * torch.rand((n, 10), generator=g)
    m[:, [0, 4, 7, 9]] = 0.0
    u = PL.lcm_uniforms((0x2545F491, _DRAW_CASES.index(case)), n, 3)
    r = torch.rand((n, 10), generator=g)
    if case == "random":
        m = torch.rand((n, 10), generator=g) * (r < 0.7)
    elif case == "tiny":
        m = torch.where(r < 0.5, 1e-35, torch.where(r < 0.8, 1e-25, m))
    elif case == "zero":
        m = torch.where(r < 0.6, 0.0, m)
    elif case == "nan":
        m = torch.where(r < 0.1, torch.nan, torch.where(r < 0.4, 1e-35, m))
    elif case == "ties":
        m = torch.where(r < 0.5, 0.25, 1e-35)
        u = torch.where(r < 0.5, u[:, :1].expand(-1, 10), u)
    elif case == "no_lcm":
        m = torch.zeros((n, 10))
    elif case == "uniform_ends":
        tiny = torch.finfo(torch.float32).tiny
        top = 1.0 - 2.0 ** -24
        u = torch.where(r < 0.3, tiny, torch.where(r < 0.6, top, u))
        m = torch.where(torch.rand((n, 10), generator=g) < 0.3, 1e-35, m)
    elif case == "random_keep":
        keep = torch.rand((n, 10), generator=g) < 0.4
    got, ok = _pruned_draw(m, keep, u)
    want = torch.argmax(_values(m, keep, u), dim=1)
    assert torch.equal(got, want)
    # the cases reach both the pruned rule and the fall-back
    if case in ("phantom", "random", "ties"):
        assert ok.float().mean() > 0.5
    if case in ("tiny", "no_lcm", "uniform_ends", "nan"):
        assert (~ok).any()


def test_gumbel_terms_stay_below_the_pruning_bound():
    """Every uniform a draw can give (k * 2^-24 clamped at the smallest
    normal float) has its Gumbel term below kGumbelMax, the largest at the
    top of the range (on the card: lcm_selfcheck's "gumbel_max")."""
    k = torch.arange(1 << 24, dtype=torch.float32) * 2.0 ** -24
    g = _gumbel(torch.clamp_min(k, torch.finfo(torch.float32).tiny))
    assert float(g.max()) < _GUMBEL_MAX
    assert int(torch.argmax(g)) >= (1 << 24) - 2


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tractography kernels are CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [0.0, 0.2])
@pytest.mark.parametrize("wire", ["f32", "i8", "i6"])
@pytest.mark.parametrize("nvec", [1, 2, 3, 5])
def test_pair_kernel_equals_plain_at_a_binding_budget_on_card(cuda, nvec,
                                                              wire, smooth):
    """40,000 streams, 30 steps, a budget of 12 points: the seven outputs
    of the two-direction kernel bit-equal to the plain version's, one
    launch; and the one-direction kernel's four outputs to its plain
    loop's."""
    shape3 = (40, 36, 30)
    ov = _field(nvec, shape3, nan=True)
    pos0, vec0 = _seeds(40_000, ov, shape3)
    t = [torch.from_numpy(a).to(cuda) for a in (
        pos0, vec0, np.zeros(len(pos0), np.int32), ov)]
    args = _pair_args(30, 12, smooth, wire, shape3)
    before = P.propagate_pair.launches
    got = P.propagate_pair(*t, *args)
    torch.cuda.synchronize()
    assert P.propagate_pair.launches - before == 1
    want = P.propagate_pair_plain(*t, *args)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    assert int((got[6] == 13).sum()) > 100       # the budget cut them
    one = P.propagate_dir(t[0], -t[1], want[2], t[3], *args)
    ref = P.propagate_dir_plain(t[0], -t[1], want[2], t[3], *args)
    for g, w in zip(one, ref):
        assert _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 33])
def test_pair_kernel_small_chunks_on_card(cuda, S):
    ov = _field(3, (40, 36, 30))
    pos0, vec0 = _seeds(S, ov, (40, 36, 30))
    t = [torch.from_numpy(a).to(cuda) for a in (
        pos0, vec0, np.zeros(S, np.int32), ov)]
    args = _pair_args(30, 6, 0.2, "f32", (40, 36, 30))
    for g, w in zip(P.propagate_pair(*t, *args),
                    P.propagate_pair_plain(*t, *args)):
        assert _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [0.0, 0.2])
@pytest.mark.parametrize("wire", ["f32", "i6"])
@pytest.mark.parametrize("rows", ["phantom", "nasty"])
def test_lcm_kernel_equals_plain_at_a_binding_budget_on_card(cuda, rows,
                                                             wire, smooth):
    """Both directions of the LCM phantom at 64^2 x 3 jitters with a
    budget of 8 points, its rows as they are or with values below the
    logits' clamp, NaNs and rows of zeros (the draw's fall-back and no
    draw at all): the ten outputs bit-equal."""
    d = _lcm_inputs((64, 64), nsub=3, smooth=smooth)
    d = dict(d, len_max=8)
    if rows == "nasty":
        rng = np.random.default_rng(5)
        lv, r = d["lv"].copy(), rng.random(d["lv"].shape)
        lv[r < 0.2] = 1e-35
        lv[(r >= 0.2) & (r < 0.23)] = np.nan
        lv[rng.random(len(lv)) < 0.05] = 0.0
        d = dict(d, lv=lv)
    got = _lcm_plain(d, wire, device=cuda, run=PL.propagate_lcm_dir)
    want = _lcm_plain(d, wire, device=cuda)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    assert int((got[8] == 9).sum()) > 100        # the budget cut them


@pytest.mark.cuda
def test_kernels_report_their_resident_threads_on_card(cuda):
    from fibers_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    for pair in (0, 1):
        for nvec in (1, 3, 5, 2):
            for deltas in (0, 1):
                assert lib.propagate_resident_threads(pair, nvec, deltas) \
                    >= 128
    assert min(lib.propagate_lcm_resident_threads(d) for d in (0, 1)) >= 128
