"""RUMBA-SD's Richardson-Lucy products in the reference's matrix-unit
arithmetic (fibers_tpu_torch/ops/kernels/rl_gemm.py), held to float64, to
the JAX package's `jnp.dot` and, on the card, the kernel to its plain
version.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  Operands are uniform on [0, 1), as RUMBA's are nonnegative, so
sum_k |a_ik| |b_kj| is the scale of every bound.  Tolerances, relative to
that scale:
- `split_bf16` reconstructs x within 2^-16 of |x| (lo's rounding leaves
  ~2^-17);
- each route's plain version against a float64 product of the same bf16
  parts: 2e-6, its f32 sums (STEP-deep chunks, as the kernel's, then a
  sum of up to 23 chunks, ceil(364 / STEP));
- the 3-pass route against fibers_tpu's `jnp.dot(precision=HIGH)`, which
  JAX's CPU computes in f32: 4e-6 (the dropped lo*lo term and lo's
  rounding, ~2^-17 a product, plus both f32 sums); the 1-pass route
  against `jnp.dot` of the bf16-rounded operands: 2e-6, the two f32
  sums;
- `cuda` tests (skipped without a card): the kernel against its plain
  version, 2e-6: the two take the same products of the same parts, add
  them to the f32 accumulator in the same STEP-deep chunks and differ only
  in the rounding of the sums within a chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.models import rumba as jr
from fibers_tpu_torch.models import rumba as tr
from fibers_tpu_torch.ops.kernels import rl_gemm as rl_module
from fibers_tpu_torch.ops.kernels.rl_gemm import (pack_rl, rl_gemm,
                                                  rl_gemm_plain, split_bf16)

from test_torch_rumba import _masked_phantom

SPLIT_RTOL = 2.0 ** -16
F32_SUM = 2e-6           # f32 sums of two routes in two orders
HIGH_VS_F32 = 4e-6       # the 3-pass route against the f32 product
# M x K x N: RUMBA's num/den (K = 253 signal, N = 364 fODF columns) and
# dodf products (the transpose), ragged against every tile, and a small
# odd one
SHAPES = [(1001, 253, 364), (1001, 364, 253), (37, 5, 3)]
SHAPE_IDS = ["num_den", "dodf", "small"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (m, k)).astype(np.float32),
            rng.uniform(0.0, 1.0, (k, n)).astype(np.float32))


def _scale(a, b):
    """sum_k |a_ik| |b_kj| in float64."""
    return np.abs(np.asarray(a, np.float64)) @ np.abs(np.asarray(b,
                                                                 np.float64))


def _rel(got, want, scale):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)) / scale))


def _parts64(x):
    hi, lo = split_bf16(torch.from_numpy(x))
    return hi.double().numpy(), lo.double().numpy()


# ------------------------------------------------------------------ #
# The plain versions on the CPU
# ------------------------------------------------------------------ #

def test_split_reconstructs_x():
    rng = np.random.default_rng(3)
    x = (rng.choice([-1.0, 1.0], 20000)
         * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, 1.0, 3.0, 1.0 / 3])])
    hi, lo = split_bf16(torch.from_numpy(x))
    for part in (hi, lo):
        assert torch.equal(part.bfloat16().float(), part)
    err = np.abs((hi.double() + lo.double()).numpy() - x)
    assert np.all(err <= SPLIT_RTOL * np.abs(x))
    hi, lo = split_bf16(torch.tensor([np.nan, np.inf, -np.inf]))
    assert torch.isnan(hi[0]) and torch.isnan(lo).all()
    assert torch.isinf(hi[1:]).all()


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("m,k,n", SHAPES, ids=SHAPE_IDS)
def test_plain_equals_float64_of_its_parts(m, k, n, passes):
    a, b = _operands(m, k, n)
    got = rl_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                        passes).numpy()
    (ah, al), (bh, bl) = _parts64(a), _parts64(b)
    want = ah @ bh if passes == 1 else al @ bh + ah @ bl + ah @ bh
    assert got.shape == (m, n) and got.dtype == np.float32
    assert _rel(got, want, _scale(a, b)) <= F32_SUM


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("m,k,n", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_plain_against_the_reference_dot(m, k, n, passes):
    """fibers_tpu's products on JAX's CPU (f32 at every precision), at
    RUMBA's K: the 3-pass route within HIGH_VS_F32 (the split's errors
    average over the K terms; a single product may be off by 3 x 2^-18),
    the 1-pass route equal to the dot of the bf16-rounded operands within
    F32_SUM."""
    a, b = _operands(m, k, n, seed=1)
    got = rl_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                        passes).numpy()
    if passes == 3:
        want = jnp.dot(jnp.asarray(a), jnp.asarray(b),
                       precision=jr._PRECISIONS["high"])
        bound = HIGH_VS_F32
    else:
        rounded = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
                   for x in (a, b))
        want = jnp.dot(*rounded, precision=jr._PRECISIONS["default"])
        bound = F32_SUM
    assert _rel(got, np.asarray(want), _scale(a, b)) <= bound


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("k", [5, 33, 253, 364])
def test_plain_chunks_at_the_kernels_promotion_depth(k, passes):
    """The plain version adds its products to the f32 accumulator in
    chunks of the depth the kernel sums in its tensor core (`STEP`, a k16
    step), bit for bit the chunked sum written out here."""
    a, b = (torch.from_numpy(x) for x in _operands(70, k, 9, seed=k))
    if passes == 3:
        (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    else:
        ah, bh = a.bfloat16().float(), b.bfloat16().float()
    depth, acc = rl_module.STEP, None
    for k0 in range(0, k, depth):
        s = slice(k0, k0 + depth)
        d = ah[:, s] @ bh[s]
        if passes == 3:
            d = (al[:, s] @ bh[s] + ah[:, s] @ bl[s]) + d
        acc = d if acc is None else acc + d
    assert torch.equal(rl_gemm_plain(a, b, passes), acc)


@pytest.mark.parametrize("passes", [1, 3])
def test_nan_row_stays_nan(passes):
    a, b = _operands(300, 253, 364, seed=2)
    a2 = a.copy()
    a[7, 100] = np.nan
    a2[11, 0] = np.nan
    packed = pack_rl(torch.from_numpy(b))
    c, c2 = rl_gemm(torch.from_numpy(a), packed, passes,
                    a2=torch.from_numpy(a2))
    for out, row in ((c, 7), (c2, 11)):
        assert torch.isnan(out[row]).all()
        assert torch.isfinite(out[torch.arange(300) != row]).all()


@pytest.mark.parametrize("passes", [1, 3])
def test_wrapper_on_cpu_is_the_plain_version(passes):
    """Both operands of a two-operand call, into `out` buffers."""
    a, b = _operands(129, 364, 253, seed=4)
    a2 = np.flipud(a).copy()
    ta, ta2, tb = (torch.from_numpy(x) for x in (a, a2, b))
    out, out2 = torch.empty(129, 253), torch.empty(129, 253)
    c, c2 = rl_gemm(ta, pack_rl(tb), passes, out=out, a2=ta2, out2=out2)
    assert c is out and c2 is out2
    assert torch.equal(c, rl_gemm_plain(ta, tb, passes))
    assert torch.equal(c2, rl_gemm_plain(ta2, tb, passes))


def test_mm_on_cpu_is_unchanged():
    """`_mm` on the CPU: "high" and "highest" are the f32 product (what
    JAX's CPU computes at every precision), "default" the product of the
    bf16-rounded operands, bit for bit."""
    a, b = (torch.from_numpy(x) for x in _operands(500, 253, 364, seed=5))
    for precision in ("high", "highest"):
        assert torch.equal(tr._mm(a, b, precision), torch.matmul(a, b))
    assert torch.equal(tr._mm(a, b, "default"),
                       torch.matmul(a.bfloat16().float(),
                                    b.bfloat16().float()))
    before = rl_gemm.launches
    tt.rumba_rec(*_masked_phantom(), ft.sphere_362, niter=3, device="cpu",
                 precision="default")
    assert rl_gemm.launches == before


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    a, b = (torch.from_numpy(x).to(device)
            for x in _operands(64, 253, 364, seed=6))
    packed = pack_rl(b)
    with pytest.raises(TypeError):
        rl_gemm(a.double(), packed, 3)
    with pytest.raises(TypeError):
        rl_gemm(a, b, 3)
    with pytest.raises(ValueError, match="does not match"):
        rl_gemm(a[:, :250].contiguous(), packed, 3)
    with pytest.raises(ValueError, match="contiguous"):
        rl_gemm(torch.empty(253, 64, device=device).T, packed, 1)
    with pytest.raises(ValueError, match="passes"):
        rl_gemm(a, packed, 2)
    with pytest.raises(ValueError, match="shape"):
        rl_gemm(a, packed, 3, out=torch.empty(64, 363, device=device))
    with pytest.raises(ValueError, match="overlaps"):
        buf = torch.empty(64 * 364 + 64 * 253, device=device)
        src = buf[:64 * 253].view(64, 253).copy_(a)
        rl_gemm(src, packed, 3, out=buf[100:100 + 64 * 364].view(64, 364))
    with pytest.raises(ValueError, match="rows"):
        rl_gemm(a, packed, 3, a2=a[:10].contiguous())
    with pytest.raises(ValueError, match="empty"):
        pack_rl(torch.zeros(5, 0, device=device))


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

def _hold(got, want, a, b):
    """Kernel against plain version on the card: within F32_SUM of the
    scale, NaN where NaN."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = _scale(a.cpu().numpy(), b.cpu().numpy())
    assert _rel(got[ok], want[ok], scale[ok]) <= F32_SUM


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("m,k,n", SHAPES + [(65_537, 253, 364),
                                            (65_537, 364, 253),
                                            (300, 64, 384), (200, 17, 9),
                                            (500, 120, 801)],
                         ids=SHAPE_IDS + ["config4_num_den", "config4_dodf",
                                          "aligned_384", "tiny",
                                          "three_column_blocks"])
def test_kernel_equals_plain_on_card(cuda, m, k, n, passes):
    """Both operands of the num/den launch, a NaN row in each, and the
    one-operand launch; each launch counted once."""
    a, b = (torch.from_numpy(x).to(cuda)
            for x in _operands(m, k, n, seed=m + k))
    a2 = torch.flip(a, dims=[0]).contiguous()
    a[m // 2, k // 3] = float("nan")
    a2[m - 1, k - 1] = float("nan")
    packed = pack_rl(b)
    before = rl_gemm.launches
    c, c2 = rl_gemm(a, packed, passes, a2=a2)
    one = rl_gemm(a2, packed, passes)
    torch.cuda.synchronize()
    assert rl_gemm.launches == before + 2
    assert torch.isnan(c[m // 2]).all() and torch.isnan(c2[m - 1]).all()
    _hold(c, rl_gemm_plain(a, b, passes), a, b)
    _hold(c2, rl_gemm_plain(a2, b, passes), a2, b)
    assert torch.equal(one.view(torch.int32), c2.view(torch.int32))


# M x K x N at the kernel's edges: 64-row tiles, the persistent grid (one
# block an SM, 132 on an H100) and its last wave, K past a multiple of the
# promotion depth, N past the wgmma tile and past one column block (368)
EDGES = [(63, 253, 364), (65, 364, 253), (64 * 132 + 1, 253, 364),
         (64 * 132 * 2 - 1, 364, 253), (64 * 132 * 3 + 1, 33, 364),
         (1000, 16, 250), (777, 364, 369), (130, 253, 801), (64, 1, 1)]
EDGE_IDS = ["one_tile_less_a_row", "one_tile_and_a_row", "one_wave_and_a_row",
            "two_waves_less_a_row", "three_waves_k33", "k16", "n369",
            "n801", "one_by_one"]


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("m,k,n", EDGES, ids=EDGE_IDS)
def test_kernel_edges_on_card(cuda, m, k, n, passes):
    """The two-operand launch at the kernel's edges, a NaN row in each
    operand (the first and the last), against the plain version."""
    a, b = (torch.from_numpy(x).to(cuda)
            for x in _operands(m, k, n, seed=m + 7 * k + n))
    a2 = (1.0 - a).contiguous()
    a[0, k - 1] = float("nan")
    a2[m - 1, 0] = float("nan")
    c, c2 = rl_gemm(a, pack_rl(b), passes, a2=a2)
    torch.cuda.synchronize()
    assert torch.isnan(c[0]).all() and torch.isnan(c2[m - 1]).all()
    _hold(c, rl_gemm_plain(a, b, passes), a, b)
    _hold(c2, rl_gemm_plain(a2, b, passes), a2, b)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("n", [364, 253])
def test_kernel_writes_unaligned_rows_of_a_live_buffer(cuda, n, passes):
    """`out` one float into a live buffer (so no tile of C starts on a
    16-byte boundary and the threads store it), `a` likewise: the results
    land there and nothing around them changes."""
    m, k = 1000, 617 - n
    a_np, b_np = _operands(m, k, n, seed=n)
    abuf = torch.empty(m * k + 1, device=cuda)
    a = abuf[1:].view(m, k).copy_(torch.from_numpy(a_np))
    b = torch.from_numpy(b_np).to(cuda)
    live = torch.full((m * n + 2,), -7.0, device=cuda)
    out = live[1:m * n + 1].view(m, n)
    c = rl_gemm(a, pack_rl(b), passes, out=out)
    torch.cuda.synchronize()
    assert c.data_ptr() == out.data_ptr()
    assert live[0] == -7.0 and live[-1] == -7.0
    _hold(c, rl_gemm_plain(a, b, passes), a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [1, 3])
def test_kernel_writes_into_a_live_buffer(cuda, passes):
    """`out` / `out2` inside one larger buffer: the results land there and
    nothing around them changes; an unaligned `a` (one float into its
    buffer) takes the 4-byte copies."""
    m, k, n = 4099, 253, 364
    a_np, b_np = _operands(m, k, n, seed=9)
    abuf = torch.empty(m * k + 1, device=cuda)
    a = abuf[1:].view(m, k).copy_(torch.from_numpy(a_np))
    b = torch.from_numpy(b_np).to(cuda)
    live = torch.full((3 * m * n,), -7.0, device=cuda)
    out = live[:m * n].view(m, n)
    out2 = live[2 * m * n:].view(m, n)
    c, c2 = rl_gemm(a, pack_rl(b), passes, out=out, a2=a, out2=out2)
    torch.cuda.synchronize()
    assert c.data_ptr() == out.data_ptr() and c2.data_ptr() == out2.data_ptr()
    assert (live[m * n:2 * m * n] == -7.0).all()
    assert torch.equal(c.view(torch.int32), c2.view(torch.int32))
    _hold(c, rl_gemm_plain(a, b, passes), a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,per_iter", [("high", 2), ("default", 2),
                                                ("highest", 0)])
def test_rumba_rec_launches_rl_gemm_on_card(cuda, precision, per_iter):
    """Ten iterations: rl_gemm twice an iteration ("high", "default"), never
    at "highest"; the fit matches the CPU's within test_torch_rumba's FIT
    at "high" and "highest"."""
    dwi, mask = _masked_phantom((8, 7, 6))
    before = rl_gemm.launches
    g = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, device="cuda",
                     signal_wire="f32", precision=precision)
    assert rl_gemm.launches - before == 10 * per_iter
    c = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, device="cpu",
                     signal_wire="f32", precision=precision)
    # "default": an ulp of difference between the card's and the CPU's
    # f32 operands can flip their bf16 rounding, which moves a product
    # term by 2^-8; the bound of test_torch_rumba's bf16 TV test
    tol = dict(rtol=1e-4, atol=1e-7) if precision != "default" else \
        dict(rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(g.fodf.vol, c.fodf.vol, **tol)


@pytest.mark.cuda
def test_rl_gemm_has_no_fallback(cuda, monkeypatch):
    """A failed build raises out of the wrapper on a CUDA tensor."""
    from fibers_tpu_torch.ops.kernels import _build

    def broken():
        raise RuntimeError("nvcc failed (stand-in)")

    monkeypatch.setattr(_build, "load_library", broken)
    b = torch.ones(5, 7, device=cuda)
    with pytest.raises(RuntimeError, match="stand-in"):
        pack_rl(b)
    with pytest.raises(RuntimeError, match="stand-in"):
        tr._mm(torch.ones(3, 5, device=cuda), b, "high")
