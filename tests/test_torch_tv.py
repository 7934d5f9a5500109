"""RUMBA-SD's TV kernels in the PyTorch port held against the JAX package.

The plain PyTorch versions (what a CPU tensor runs) are compared with the
reference stencil `_tv_stencil`, with the Pallas kernels run in interpret
mode, and with the per-volume oracle, on identical numpy inputs.

Tolerances: f32 results within rtol=1e-6, atol=1e-6, the bound of
tests/test_tv_pallas.py (XLA may rewrite 1/sqrt or contract a multiply
and an add where PyTorch rounds each op, so a few elements differ by an
ulp).  bf16 stacks: the port rounds each difference to bf16 as the TPU
kernel does (tv_stencil.py:52-55), but XLA on the CPU drops that rounding
when it fuses the subtraction with the cast to f32, so the interpret-mode
kernel computes f32 differences of the bf16 values; the two are compared
within the bf16 bound of tests/test_tv_pallas.py (rtol=2e-2, atol=2e-3),
and the port against a numpy oracle of its own rule within 1e-6.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fibers_tpu.models.rumba import _tv_stencil
from fibers_tpu.ops.pallas.tv_fused import build_tables as jax_build_tables
from fibers_tpu.ops.pallas.tv_fused import tv_fused as jax_tv_fused
from fibers_tpu.ops.pallas.tv_stencil import tv_multiplier as jax_tv
from fibers_tpu_torch.ops.kernels.tv_fused import (FusedTVTables,
                                                   build_tables, tv_fused,
                                                   tv_fused_plain)
from fibers_tpu_torch.ops.kernels.tv_stencil import (tv_multiplier,
                                                     tv_multiplier_plain)
from fibers_tpu_torch.ops.kernels.tv_variants import (tv_2slice,
                                                      tv_2slice_plain,
                                                      tv_dimsem,
                                                      tv_dimsem_plain)

from oracle import rumba_tv_oracle

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _stack(shape, seed, zero_frac=0.3):
    """A component stack with a zero margin and random interior zeros,
    like a masked embedding, and lam from the same seed."""
    rng = np.random.default_rng(seed)
    X, Y, Z, C = shape
    v = rng.standard_normal(shape).astype(np.float32)
    v[0] = 0
    v[rng.random((X, Y, Z)) < zero_frac] = 0
    lam = rng.uniform(0.001, 0.01, (X, Y, Z)).astype(np.float32)
    return v, lam


SHAPES = [(6, 5, 4, 8), (4, 3, 3, 16), (5, 2, 7, 3), (2, 6, 2, 5)]


@pytest.mark.parametrize("shape", SHAPES)
def test_multiplier_plain_matches_reference(shape):
    v, lam = _stack(shape, 1)
    want = np.asarray(_tv_stencil(jnp.asarray(v), jnp.asarray(lam)))
    pallas = np.asarray(jax_tv(jnp.asarray(v), jnp.asarray(lam),
                               cb=shape[3], interpret=True))
    got = tv_multiplier(torch.from_numpy(v), torch.from_numpy(lam))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def _bf16_oracle(vb, lam):
    """The port's bf16 rule in numpy: differences of the bf16 values
    rounded to bf16, everything else in f32."""
    v = vb.astype(np.float32)

    def fwd(ax):
        n = v.shape[ax]
        nxt = np.concatenate([np.take(v, range(1, n), ax),
                              np.take(v, [n - 1], ax)], ax)
        return (nxt - v).astype(ml_dtypes.bfloat16).astype(np.float32)

    gx, gy, gz = fwd(0), fwd(1), fwd(2)
    ninv = np.float32(1.0) / np.sqrt(gx * gx + gy * gy + gz * gz
                                     + np.float32(1e-7))
    return _from_grads(gx * ninv, gy * ninv, gz * ninv, lam)


def _from_grads(gx, gy, gz, lam):
    def back(g, ax):
        n = g.shape[ax]
        prev = np.concatenate([np.zeros_like(np.take(g, [0], ax)),
                               np.take(g, range(n - 1), ax)], ax)
        return g - prev

    div = back(gx, 0) + back(gy, 1) + back(gz, 2)
    return np.float32(1.0) / (np.abs(np.float32(1.0) - lam[..., None] * div)
                              + np.float32(1e-7))


@pytest.mark.parametrize("shape", [(5, 4, 4, 8), (3, 6, 5, 7)])
def test_multiplier_bf16(shape):
    rng = np.random.default_rng(2)
    v = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    lam = np.full(shape[:3], 0.004, np.float32)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    pallas = np.asarray(jax_tv(vb, jnp.asarray(lam), cb=shape[3],
                               interpret=True))
    got = tv_multiplier(torch.from_numpy(v).bfloat16(), torch.from_numpy(lam))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), _bf16_oracle(np.asarray(vb), lam), **TOL)


def test_dimsem_plain_matches_reference():
    v, lam = _stack((6, 5, 4, 8), 3)
    want = np.asarray(_tv_stencil(jnp.asarray(v), jnp.asarray(lam)))
    got = tv_dimsem(torch.from_numpy(v), torch.from_numpy(lam))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, tv_dimsem_plain(torch.from_numpy(v),
                                            torch.from_numpy(lam)))


@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (4, 2, 9, 5), (2, 11, 4, 5),
                                   (4, 13, 5, 6)])
def test_2slice_plain_matches_oracle(shape):
    """The two-slice variant divides by the norm three times, like the
    per-volume oracle (tests/oracle.py:rumba_tv_oracle)."""
    v, lam = _stack(shape, 4)
    want = np.stack([rumba_tv_oracle(v[..., c], lam)
                     for c in range(shape[3])], axis=-1)
    got = tv_2slice(torch.from_numpy(v), torch.from_numpy(lam))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), tv_multiplier_plain(
        torch.from_numpy(v), torch.from_numpy(lam)).numpy(), **TOL)


def test_2slice_needs_even_x():
    v, lam = _stack((5, 3, 3, 2), 5)
    with pytest.raises(ValueError, match="even"):
        tv_2slice(torch.from_numpy(v), torch.from_numpy(lam))
    with pytest.raises(ValueError, match="even"):
        tv_2slice_plain(torch.from_numpy(v), torch.from_numpy(lam))


def test_stencil_wrappers_check_arguments():
    v = torch.zeros((3, 3, 3, 4))
    with pytest.raises(ValueError, match="lam3"):
        tv_multiplier(v, torch.zeros((3, 3, 2)))
    with pytest.raises(TypeError, match="float32"):
        tv_multiplier(v.double(), torch.zeros((3, 3, 3)))
    with pytest.raises(TypeError, match="float32"):
        tv_dimsem(v.bfloat16(), torch.zeros((3, 3, 3)))
    with pytest.raises(ValueError, match="X, Y, Z, C"):
        tv_multiplier(v[0], torch.zeros((3, 3, 3)))


# ------------------------------------------------------------------ #
# Fused row-table TV
# ------------------------------------------------------------------ #

FUSED_CASES = [(5, 4, 32, 0.5), (4, 8, 16, 0.15), (6, 4, 32, 0.02),
               (7, 2, 64, 0.95), (4, 5, 26, 0.4), (3, 7, 9, 0.6), "empty"]


def _fused_problem(case, seed):
    """The mask, rows and lam of one case of tests/test_tv_pallas.py:
    132-188 (the six shapes and the empty-slice case)."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        X, Y, Z = 6, 4, 32
        yz = Y * Z
        m = np.zeros(X * yz, bool)
        m[:yz] = rng.random(yz) < 0.6            # slice 0 populated
        m[3 * yz:4 * yz] = rng.random(yz) < 0.6  # slices 1-2, 4-5 empty
        lam3 = np.full((X, Y, Z), 0.004, np.float32)
    else:
        X, Y, Z, frac = case
        yz = Y * Z
        m = rng.random(X * yz) < frac
        m[3] = True
        lam3 = rng.uniform(0.001, 0.01, (X, Y, Z)).astype(np.float32)
    idx_tv = np.flatnonzero(m)
    nmask = len(idx_tv)
    n_rows = max(yz, ((nmask + 7) // 8) * 8 + 16)
    rows = np.zeros((n_rows, 128), np.float32)
    rows[:nmask] = rng.random((nmask, 128)).astype(np.float32)
    return (X, Y, Z), idx_tv, rows, lam3


@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_fused_plain_matches_pallas_interpret(case):
    shape3, idx_tv, rows, lam3 = _fused_problem(case, 6)
    nmask, yz = len(idx_tv), shape3[1] * shape3[2]
    tabs_j = jax_build_tables(idx_tv, shape3, rows.shape[0])
    want = np.asarray(jax_tv_fused(
        jnp.asarray(rows), jnp.full((rows.shape[0] + yz, 128), 7.0,
                                    jnp.float32),
        jnp.asarray(lam3), tabs_j.lo, tabs_j.starts, tabs_j.gl,
        tabs_j.inmask, tabs_j.cellidx, shape3, cb=128, interpret=True))

    tabs = build_tables(idx_tv, shape3)
    out = torch.full((rows.shape[0], 128), 7.0)
    got = tv_fused(torch.from_numpy(rows), torch.from_numpy(lam3), tabs, out)
    assert got is out
    np.testing.assert_allclose(got.numpy()[:nmask], want[:nmask], **TOL)
    # rows past the mask rows keep the buffer's values
    assert (got.numpy()[nmask:] == 7.0).all()


@pytest.mark.parametrize("C", [1, 7, 130])
def test_fused_plain_any_width_matches_reference(C):
    """Any component count: embed -> reference stencil -> unembed."""
    shape3, idx_tv, rows, lam3 = _fused_problem((4, 5, 6, 0.5), 7)
    rng = np.random.default_rng(8)
    nmask = len(idx_tv)
    rows = np.zeros((nmask + 3, C), np.float32)
    rows[:nmask] = rng.random((nmask, C))
    grid = np.zeros((int(np.prod(shape3)), C), np.float32)
    grid[idx_tv] = rows[:nmask]
    want = np.asarray(_tv_stencil(jnp.asarray(grid.reshape(shape3 + (C,))),
                                  jnp.asarray(lam3))).reshape(-1, C)[idx_tv]
    got = tv_fused(torch.from_numpy(rows), torch.from_numpy(lam3),
                   build_tables(idx_tv, shape3))
    np.testing.assert_allclose(got.numpy()[:nmask], want, **TOL)
    assert (got.numpy()[nmask:] == 1.0).all()


def test_fused_tables_are_checked():
    shape3 = (3, 3, 3)
    idx_tv = np.array([0, 4, 13, 26])
    good = build_tables(idx_tv, shape3)
    assert good.nmask == 4
    cr = good.cellrow.clone()
    cr[1] = 2                          # a second cell claims row 2
    with pytest.raises(ValueError, match="inverse"):
        FusedTVTables(cellrow=cr, rowcell=good.rowcell, shape3=shape3)
    with pytest.raises(ValueError, match="rowcell out of range"):
        FusedTVTables(cellrow=good.cellrow,
                      rowcell=torch.tensor([0, 4, 13, 27], dtype=torch.int32),
                      shape3=shape3)
    with pytest.raises(TypeError, match="int32"):
        FusedTVTables(cellrow=good.cellrow.long(), rowcell=good.rowcell,
                      shape3=shape3)
    rows = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="rows for"):
        tv_fused(rows, torch.zeros(shape3), good)
    with pytest.raises(ValueError, match="lam3"):
        tv_fused(torch.zeros((4, 2)), torch.zeros((3, 3, 2)), good)


def test_fused_plain_equals_dense_composition():
    """tv_fused_plain is the embed, the dense plain stencil and the
    unembed, element for element."""
    shape3, idx_tv, rows, lam3 = _fused_problem((5, 4, 6, 0.6), 9)
    nmask = len(idx_tv)
    grid = np.zeros((int(np.prod(shape3)), 128), np.float32)
    grid[idx_tv] = rows[:nmask]
    dense = tv_multiplier_plain(torch.from_numpy(grid).reshape(
        shape3 + (128,)), torch.from_numpy(lam3)).reshape(-1, 128)
    got = tv_fused_plain(torch.from_numpy(rows), torch.from_numpy(lam3),
                         build_tables(idx_tv, shape3))
    assert torch.equal(got[:nmask], dense[torch.from_numpy(idx_tv)])


# ------------------------------------------------------------------ #
# On the card: each kernel against its plain version
# ------------------------------------------------------------------ #

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tv_multiplier", "tv_dimsem", "tv_2slice",
                                  "tv_multiplier_bf16"])
def test_stencil_kernels_match_plain_on_card(cuda, name):
    fn, plain = {"tv_multiplier": (tv_multiplier, tv_multiplier_plain),
                 "tv_multiplier_bf16": (tv_multiplier, tv_multiplier_plain),
                 "tv_dimsem": (tv_dimsem, tv_dimsem_plain),
                 "tv_2slice": (tv_2slice, tv_2slice_plain)}[name]
    for shape in ((8, 9, 10, 37), (6, 5, 3, 7)):
        v, lam = _stack(shape, 10)
        vd = torch.from_numpy(v).to(cuda)
        if name.endswith("bf16"):
            vd = vd.bfloat16()
        ld = torch.from_numpy(lam).to(cuda)
        before = fn.launches
        got = fn(vd, ld)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(got, plain(vd, ld), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_fused_kernel_matches_plain_on_card(cuda, case):
    shape3, idx_tv, rows, lam3 = _fused_problem(case, 11)
    tabs = build_tables(idx_tv, shape3, cuda)
    r, lam = torch.from_numpy(rows).to(cuda), torch.from_numpy(lam3).to(cuda)
    before = tv_fused.launches
    got = tv_fused(r, lam, tabs)
    torch.cuda.synchronize()
    assert tv_fused.launches == before + 1
    torch.testing.assert_close(got, tv_fused_plain(r, lam, tabs), **TOL)


# Shapes that cut the sweep kernels' 8 x 8 (y, z) tiles and 32-wide
# component chunks raggedly: Y and Z not multiples of 8, C in {7, 33, 364}
# (a 4-byte and a 16-byte row stride for f32; odd C gives bf16 rows no
# aligned copy at all), X = 1 and X = 2.  The last two (X = 2; X = 4 with
# Z < 8) are all prologue and epilogue of tv_2slice's two-slice ring.
RAGGED = [(1, 9, 11, 7), (2, 17, 10, 33), (5, 12, 19, 364), (3, 8, 8, 33),
          (2, 3, 5, 7), (4, 20, 9, 364), (2, 11, 4, 40), (4, 13, 5, 36)]


def ragged_mask(shape3, seed):
    """Mask cells of a crop with an empty x-slice, a whole 8 x 8 tile
    outside the mask in every slice, and a random rest."""
    rng = np.random.default_rng(seed)
    m = rng.random(shape3) < 0.6
    if shape3[0] > 2:
        m[1] = False
    m[:, :8, 8:16] = False
    return np.flatnonzero(m)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "fused", "dimsem",
                                  "2slice"])
@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_sweep_kernels_equal_plain_on_ragged_tiles(cuda, shape, kind):
    """tv_multiplier (f32 and bf16 stacks), tv_fused, tv_dimsem and
    tv_2slice (even X) are bit-equal to their plain versions where the
    tiles, chunks and mask are ragged."""
    v, lam = _stack(shape, 21)
    ld = torch.from_numpy(lam).to(cuda)
    if kind == "fused":
        cells = ragged_mask(shape[:3], 22)
        rows = np.random.default_rng(23).standard_normal(
            (len(cells) + 3, shape[3])).astype(np.float32)
        tabs = build_tables(cells, shape[:3], cuda)
        rd = torch.from_numpy(rows).to(cuda)
        out = torch.full_like(rd, 5.0)
        before = tv_fused.launches
        got = tv_fused(rd, ld, tabs, out)
        torch.cuda.synchronize()
        assert tv_fused.launches == before + 1
        want = tv_fused_plain(rd, ld, tabs, torch.full_like(rd, 5.0))
        assert torch.equal(got, want)
        return
    vd = torch.from_numpy(v).to(cuda)
    if kind == "bf16":
        vd = vd.bfloat16()
    fn, plain = {"dimsem": (tv_dimsem, tv_dimsem_plain),
                 "2slice": (tv_2slice, tv_2slice_plain)}.get(
                     kind, (tv_multiplier, tv_multiplier_plain))
    if kind == "2slice" and shape[0] % 2:
        with pytest.raises(ValueError, match="even"):
            fn(vd, ld)
        return
    before = fn.launches
    got = fn(vd, ld)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(vd, ld))


@pytest.mark.cuda
def test_branch_free_rounding_equals_the_intrinsics(cuda):
    """The sweep kernels' sqrt, 1/x and a/b equal __fsqrt_rn and
    __fdiv_rn where the kernels use them: all 2^32 bit patterns as the
    argument and as the quotient's denominator under 13 numerators, and
    2^31 random pairs."""
    from fibers_tpu_torch.ops.kernels.tv_stencil import rn_selfcheck
    assert rn_selfcheck(cuda) == 0


@pytest.mark.cuda
def test_sweep_instances_fit_two_blocks_per_sm(cuda):
    """The design counts on two blocks of every sweep instance per SM,
    tv_2slice's 112 KB of shared memory included."""
    from fibers_tpu_torch.ops.kernels.tv_stencil import sweep_blocks_per_sm
    assert all(n == 2 for n in sweep_blocks_per_sm().values())
