"""RUMBA-SD's row kernels (fibers_tpu_torch/ops/kernels/rumba_step.py)
and the card's f32 signal route, held to the port's earlier torch
composition and to the JAX package.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  Tolerances:
- the plain versions against the torch expressions the port ran before
  the kernels (`_OldStep` below, that code as it was): bit for bit,
  NaN rows included, over whole iterations too;
- against fibers_tpu's `_rumba_step` / `besseli_ratio` on JAX's CPU
  backend: test_torch_rumba.py's STEP (rtol 1e-5, atol 1e-9): PyTorch and
  XLA sum the noise variance's row in other orders;
- the card's f32 signal rows against `_signal_host`: atol 1e-6 on the
  [0, 1] signal (the b0 mean is summed in another order), every
  non-finite quotient 0 in both;
- `cuda` tests (skipped without a card): each kernel against its plain
  version on the card bit for bit, but for the noise variance, rtol 1e-6
  (the kernel sums the row in double, torch in float in its own order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.models import rumba as jr
from fibers_tpu_torch.models import rumba as tr
from fibers_tpu_torch.ops.kernels.rumba_step import (besseli_ratio,
                                                     rumba_refit,
                                                     rumba_refit_plain,
                                                     rumba_update,
                                                     rumba_update_plain)
from fibers_tpu_torch.parallel.mesh import make_mesh

from phantom import make_phantom
from test_torch_rumba import FIT, STEP, _masked_phantom, _step_inputs

# sphere_362's 181 half-sphere vertices + CSF + GM; an odd ndir
N, NDIR, NCOMP = 300, 61, 183
SIG2_RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _refit_inputs(seed=0, special=False, n=N, ndir=NDIR):
    """signal, dodf, the old dodf_sig and sig2; `special` puts a NaN
    signal sample, an inf dodf, a zero and a NaN sig2, a NaN and an inf
    ratio and an all-zero row into the first rows."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 1.0, (n, ndir)).astype(np.float32)
    d = rng.uniform(0.0, 1.2, (n, ndir)).astype(np.float32)
    ds = rng.uniform(0.0, 400.0, (n, ndir)).astype(np.float32)
    s2 = rng.uniform(1e-4, 2e-2, (n, 1)).astype(np.float32)
    if special:
        s[1, 0] = np.nan
        d[2, ndir - 1] = np.inf
        s2[3] = 0.0
        s2[4] = np.nan
        ds[5, min(3, ndir - 1)] = np.nan
        ds[6, min(2, ndir - 1)] = np.inf
        s[7], d[7], ds[7] = 0.0, 0.0, 0.0
    return tuple(torch.from_numpy(a) for a in (s, d, ds, s2))


def _update_inputs(seed=1, n=N, c=NCOMP, tv_width=None):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 0.02, (n, c)).astype(np.float32)
    num = rng.uniform(0.0, 3.0, (n, c)).astype(np.float32)
    den = rng.uniform(0.0, 3.0, (n, c)).astype(np.float32)
    f[0, 0], num[1, 1], den[2, 2], den[3, 3] = np.nan, np.inf, 0.0, -1e-7
    tv = None
    if tv_width is not None:
        tv = torch.from_numpy(rng.uniform(0.5, 1.5, (n, tv_width)).astype(
            np.float32))[:, :c]
    return (*(torch.from_numpy(a) for a in (f, num, den)), tv)


class _OldStep:
    """The port's iteration before the row kernels, as it was written
    (models/rumba.py:_rl, _refit, _rumba_step)."""

    @staticmethod
    def rl(dodf_sig, dodf, signal, kernel, n_order, precision):
        iratio = besseli_ratio(n_order, dodf_sig)
        rl_num = tr._mm(signal * iratio, kernel, precision)
        rl_den = tr._mm(dodf, kernel, precision) + 1e-7
        return iratio, rl_num / rl_den

    @classmethod
    def refit(cls, fodf, signal, sig2, iratio, kernel, n_order, precision):
        dodf = tr._mm(fodf, kernel.T, precision)
        return (dodf,) + cls.refit_rows(dodf, signal, sig2, iratio, n_order)

    @staticmethod
    def refit_rows(dodf, signal, sig2, iratio, n_order):
        """_refit after its product."""
        dodf_sig = (signal * dodf) / sig2
        resid = ((signal ** 2 + dodf ** 2) / 2
                 - (sig2 * dodf_sig) * iratio)
        ndir = signal.shape[1]
        sig2 = resid.sum(dim=1, keepdim=True) / (n_order * ndir)
        sig2 = torch.clamp(sig2, (1.0 / 80) ** 2, (1.0 / 8) ** 2)
        return dodf_sig, sig2

    @classmethod
    def step(cls, fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
             idx_mask, n_order, ipat_factor, use_tv, shape3, precision,
             tv_bf16):
        nmask = idx_mask.shape[0]
        iratio, rl = cls.rl(dodf_sig, dodf, signal, kernel, n_order,
                            precision)
        if use_tv:
            tabs = tr.build_tables(idx_mask.numpy(), shape3, fodf.device)
            tv = tr._tv_term(fodf, lam_flat.reshape(shape3), tabs, tv_bf16,
                             torch.ones_like(fodf))
            fodf = torch.clamp_min(fodf * rl * tv, 0.0)
        else:
            fodf = torch.clamp_min(fodf * rl, 0.0)
        dodf, dodf_sig, sig2 = cls.refit(fodf, signal, sig2, iratio, kernel,
                                         n_order, precision)
        if use_tv:
            if ipat_factor == 1:
                m = torch.clamp_min(sig2[:nmask].mean(), (1.0 / 30) ** 2)
                lam_flat = m.expand(lam_flat.shape).contiguous()
            else:
                lam_flat = torch.zeros_like(lam_flat).index_put_(
                    (idx_mask,), sig2[:nmask, 0])
        snr = 1.0 / torch.sqrt(sig2)
        return fodf, dodf, dodf_sig, sig2, lam_flat, snr


# ------------------------------------------------------------------ #
# Plain versions: the old expressions
# ------------------------------------------------------------------ #

def test_besseli_ratio_lives_with_the_kernels():
    assert tr.besseli_ratio is besseli_ratio is tt.besseli_ratio


@pytest.mark.parametrize("special", [False, True], ids=["random", "special"])
@pytest.mark.parametrize("n_order", [1, 2])
def test_refit_plain_is_the_old_composition(n_order, special):
    """rumba_refit_plain equals the old _refit and the next iteration's
    _rl operand bit for bit; the special rows stay NaN where the old
    composition gives NaN."""
    s, d, ds, s2 = _refit_inputs(special=special)
    iratio = besseli_ratio(n_order, ds)
    ds_old, s2_old = _OldStep.refit_rows(d, s, s2, iratio, n_order)
    x_old = s * besseli_ratio(n_order, ds_old)
    ds_new, s2_new, x_new = rumba_refit_plain(s, ds, n_order, d, s2)
    assert _same(ds_new, ds_old) and _same(s2_new, s2_old)
    assert _same(x_new, x_old)
    buf = torch.empty_like(s)
    x_out = rumba_refit(s, ds, n_order, d, s2, out=buf)[2]
    assert x_out is buf and _same(buf, x_old)
    if special:
        assert bool(torch.isnan(s2_new[[1, 3, 4]]).all())
        assert not bool(torch.isnan(s2_new[8:]).any())


@pytest.mark.parametrize("out", ["new", "num", "fodf"])
@pytest.mark.parametrize("use_tv", [True, False], ids=["tv", "no_tv"])
def test_update_plain_is_the_old_composition(use_tv, out):
    """rumba_update_plain equals the old clamp_min(fodf * rl * tv, 0)
    bit for bit, into a new tensor or over either input."""
    f, num, den, tv = _update_inputs(tv_width=NCOMP + 5 if use_tv else None)
    rl = num / (den + 1e-7)
    want = torch.clamp_min(f * rl * tv if use_tv else f * rl, 0.0)
    f2, num2 = f.clone(), num.clone()
    dest = {"new": None, "num": num2, "fodf": f2}[out]
    got = rumba_update_plain(f2, num2, den, tv, out=dest)
    assert _same(got, want)
    if dest is not None:
        assert got.data_ptr() == dest.data_ptr()
    assert bool(torch.isnan(got[0, 0]))
    assert float(got.nan_to_num().min()) >= 0.0


@pytest.mark.parametrize("n_order", [1, 2])
def test_first_iteration_x_is_the_old_rl_operand(n_order):
    """The first-iteration mode (a fresh start, a resumed checkpoint)
    gives the x the old _rl multiplied into its numerator product, and
    hands dodf_sig and sig2 back as they came."""
    s, _, ds, s2 = _refit_inputs(special=True)
    ds_out, s2_out, x = rumba_refit(s, ds, n_order)
    assert ds_out is ds and s2_out is None
    assert _same(x, s * besseli_ratio(n_order, ds))
    # the old _rl's numerator equals the product of this x
    k = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (NDIR, NCOMP)).astype(np.float32))
    iratio, _ = _OldStep.rl(ds, ds, s, k, n_order, "high")
    assert _same(tr._mm(x, k, "high"), tr._mm(s * iratio, k, "high"))


# ------------------------------------------------------------------ #
# Plain versions: the JAX package
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n_order", [1, 2])
def test_plain_versions_match_jax_step(n_order):
    """With the identity as the dictionary (num = x, den = dodf,
    dodf' = fodf'), fibers_tpu's _rumba_step (no TV) is exactly the update
    and the refit of _rumba_step_core: the plain versions match it, and x
    matches signal * jr.besseli_ratio of its dodf_sig."""
    s, _, ds, s2 = _refit_inputs(seed=4)
    rng = np.random.default_rng(5)
    fodf = torch.from_numpy(rng.uniform(0.0, 1.0, (N, NDIR)).astype(
        np.float32))
    dodf = fodf.clone()
    eye = np.eye(NDIR, dtype=np.float32)
    idx = np.arange(N)
    want = jr._rumba_step(*(jnp.asarray(a) for a in (
        fodf.numpy(), dodf.numpy(), ds.numpy(), s2.numpy(),
        np.zeros(N, np.float32), s.numpy(), eye, idx)),
        n_order, 1, False, (N, 1, 1), N)
    _, _, x = rumba_refit_plain(s, ds, n_order)
    f_new = rumba_update_plain(fodf, x, dodf)
    ds_new, s2_new, x_new = rumba_refit_plain(s, ds, n_order, f_new, s2)
    for got, w in ((f_new, want[0]), (f_new, want[1]), (ds_new, want[2]),
                   (s2_new, want[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **STEP)
    x_jax = s.numpy() * np.asarray(jr.besseli_ratio(n_order, want[2]))
    np.testing.assert_allclose(x_new.numpy(), x_jax, **STEP)


@pytest.mark.parametrize("n_order", [1, 2])
def test_update_plain_and_ratio_match_jax(n_order):
    """rumba_update_plain with a TV multiplier against _rumba_step_core's
    jnp.maximum(fodf * rl * tv, 0), and the first-iteration x against
    signal * jr.besseli_ratio."""
    f, num, den, tv = _update_inputs(seed=6, tv_width=NCOMP)
    f[0, 0] = 0.0                           # no NaN: XLA's max drops it
    got = rumba_update_plain(f, num, den, tv)
    fj, nj, dj, tj = (jnp.asarray(t.numpy()) for t in (f, num, den, tv))
    want = jnp.maximum(fj * (nj / (dj + 1e-7)) * tj, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    s, _, ds, _ = _refit_inputs(seed=7)
    _, _, x = rumba_refit(s, ds, n_order)
    np.testing.assert_allclose(
        x.numpy(), s.numpy() * np.asarray(jr.besseli_ratio(
            n_order, jnp.asarray(ds.numpy()))), **STEP)


# ------------------------------------------------------------------ #
# The iteration: bit for bit against the old one
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("use_tv,ipat,tv_bf16,precision", [
    (True, 1, False, "high"), (True, 2, False, "high"),
    (False, 1, False, "high"), (True, 1, True, "high"),
    (True, 1, False, "default")],
    ids=["tv", "ipat2", "no_tv", "tv_bf16", "precision_default"])
def test_step_equals_the_old_step(use_tv, ipat, tv_bf16, precision):
    """Three chained iterations of _rumba_step, each handing the next its
    x, equal the old step's bit for bit on every output, and leave their
    arguments as they were."""
    shape3 = (4, 4, 3)
    fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx = (
        torch.from_numpy(a) for a in _step_inputs(shape3))
    new = old = (fodf, dodf, dodf_sig, sig2, lam)
    keep = [t.clone() for t in new]
    x = None
    for _ in range(3):
        out = tr._rumba_step(*new, signal, kernel, idx, 1, ipat, use_tv,
                             shape3, precision, tv_bf16, x=x)
        ref = _OldStep.step(*old, signal, kernel, idx, 1, ipat, use_tv,
                            shape3, precision, tv_bf16)
        for a, b in zip(out[:6], ref):
            assert _same(a, b)
        new, x, old = out[:5], out[6], ref[:5]
    for a, b in zip((fodf, dodf, dodf_sig, sig2, lam), keep):
        assert _same(a, b)


# a fresh process: the TV term, exp and log on the CPU, each computed
# twice; every first call of the process is one of these
_FIRST_CALLS = """
import torch
from fibers_tpu_torch.ops.kernels.tv_stencil import stencil_plain
g = torch.Generator().manual_seed(int(__import__("sys").argv[1]))
v = torch.rand((4, 4, 3, 362), generator=g) * 0.02
lam3 = torch.full((4, 4, 3), 0.004)
x = torch.rand(4 * 4 * 3 * 362, generator=g) + 0.1
runs = [(stencil_plain(v, lam3), torch.exp(x), torch.log(x))
        for _ in range(2)]
print("SAME" if all(torch.equal(a, b) for a, b in zip(*runs)) else "DIFF")
"""


def test_first_cpu_math_in_a_process_equals_the_next():
    """In fresh processes, the first TV term, exp and log the CPU computes
    equal the second bit for bit: the package settles MKL's vector math
    when it is imported (`fibers_tpu_torch._settle_cpu_math`), where the
    first call from several threads at once otherwise now and then
    computed one thread's chunk at half precision (the TV term's sqrt
    moved whole voxel rows of `test_step_equals_the_old_step`)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..")
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALLS, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(6)]
    outs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert out.strip().endswith("SAME"), out[-3000:]


def test_resumed_fit_equals_the_uninterrupted_one(tmp_path):
    """A fit resumed from the port's checkpoint at iteration 4 of 8
    recomputes dodf, dodf_sig and x from the saved state, and ends bit
    for bit where the uninterrupted fit ends."""
    dwi, mask = _masked_phantom((4, 4, 4))
    full = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=8, device="cpu")
    ck = str(tmp_path / "rumba.ckpt.npz")
    tt.rumba_rec(dwi, mask, ft.sphere_362, niter=8, checkpoint_path=ck,
                 checkpoint_every=4, device="cpu")
    with np.load(ck) as z:
        state = dict(z)
    assert int(state["iteration"]) == 4
    ck4 = str(tmp_path / "at4.ckpt.npz")
    np.savez(ck4, **state)
    resumed = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=8,
                           checkpoint_path=ck4, device="cpu")
    for f in ("fodf", "var", "gfa"):
        assert np.array_equal(getattr(resumed, f).vol, getattr(full, f).vol)


# ------------------------------------------------------------------ #
# Wrapper checks
# ------------------------------------------------------------------ #

def _bad_refit(case):
    s, d, ds, s2 = _refit_inputs(n=8, ndir=6)
    return {
        "dtype": lambda: rumba_refit(s.double(), ds, 1, d, s2),
        "shape": lambda: rumba_refit(s, ds[:, :5].contiguous(), 1, d, s2),
        "sig2_shape": lambda: rumba_refit(s, ds, 1, d, s2[:4]),
        "contiguity": lambda: rumba_refit(s, ds, 1, d.t().contiguous().t(),
                                          s2),
        "device": lambda: rumba_refit(s.to("meta"), ds.to("meta"), 1),
        "devices": lambda: rumba_refit(s, ds.to("meta"), 1),
        "sig2_alone": lambda: rumba_refit(s, ds, 1, None, s2),
        "n_order": lambda: rumba_refit(s, ds, 0, d, s2),
        "out_shape": lambda: rumba_refit(s, ds, 1, d, s2,
                                         out=torch.empty(8, 5)),
        "out_input": lambda: rumba_refit(s, ds, 1, d, s2, out=ds),
    }[case]


@pytest.mark.parametrize("case,err", [
    ("dtype", TypeError), ("shape", ValueError), ("sig2_shape", ValueError),
    ("contiguity", ValueError), ("device", ValueError),
    ("devices", ValueError), ("sig2_alone", ValueError),
    ("n_order", ValueError), ("out_shape", ValueError),
    ("out_input", ValueError)])
def test_refit_wrapper_errors(case, err):
    with pytest.raises(err, match="rumba_refit"):
        _bad_refit(case)()


def _bad_update(case):
    f, num, den, _ = _update_inputs(n=8, c=6)
    tv = torch.ones(8, 6)
    return {
        "dtype": lambda: rumba_update(f, num.double(), den),
        "shape": lambda: rumba_update(f, num[:7].contiguous(), den),
        "contiguity": lambda: rumba_update(f, num, den.t().contiguous().t()),
        "out": lambda: rumba_update(f, num, den, out=torch.empty(8, 5)),
        "tv_rows": lambda: rumba_update(f, num, den, tv[:7]),
        "tv_columns": lambda: rumba_update(f, num, den, tv[:, :5]),
        "tv_stride": lambda: rumba_update(f, num, den,
                                          torch.ones(6, 8).t()),
        "device": lambda: rumba_update(f.to("meta"), num.to("meta"),
                                       den.to("meta")),
    }[case]


@pytest.mark.parametrize("case,err", [
    ("dtype", TypeError), ("shape", ValueError), ("contiguity", ValueError),
    ("out", ValueError), ("tv_rows", ValueError), ("tv_columns", ValueError),
    ("tv_stride", ValueError), ("device", ValueError)])
def test_update_wrapper_errors(case, err):
    with pytest.raises(err, match="rumba_update"):
        _bad_update(case)()


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU no kernel is built or counted."""
    before = rumba_update.launches, rumba_refit.launches
    dwi, mask = _masked_phantom((3, 3, 3))
    tt.rumba_rec(dwi, mask, ft.sphere_362, niter=3, device="cpu")
    assert (rumba_update.launches, rumba_refit.launches) == before


# ------------------------------------------------------------------ #
# The f32 signal route of the card, run here on CPU tensors
# ------------------------------------------------------------------ #

def _raw_signal(seed=0):
    """A two-b0 volume whose masked rows hold a NaN and an inf DWI sample,
    a zero b0 row, a NaN b0 sample, negative samples and an inf b0."""
    dwi, mask, _, _ = make_phantom(shape=(5, 4, 4), ndir=30)
    vol = np.array(dwi.vol, np.float32)
    bval = np.concatenate([[0.0, 0.0], np.asarray(dwi.bval)[2:]]).astype(
        np.float32)
    ib0 = bval == bval.min()
    idx = np.flatnonzero(np.asarray(mask.vol).reshape(-1) > 0)
    flat = vol.reshape(-1, vol.shape[3])
    r = idx[:6]
    flat[r[0], 5] = np.nan
    flat[r[1], 6] = np.inf
    flat[r[2], ib0] = 0.0
    flat[r[3], 0] = np.nan
    flat[r[4], 7:12] = -3.0
    flat[r[5], 1] = np.inf
    return np.ascontiguousarray(flat), idx, ib0


@pytest.mark.parametrize("native_lib", [True, False])
def test_signal_rows_follow_signal_host(native_lib, monkeypatch):
    """_signal_f32 (gather the raw rows, copy, normalise on the device)
    equals _signal_host's matrix within atol 1e-6, with its rule for
    non-finite quotients (0); _signal_from_batch, the batch route, keeps
    a NaN sample instead."""
    from fibers_tpu_torch import native
    if not native_lib:
        monkeypatch.setattr(native, "lib", lambda: None)
    flat, idx, ib0 = _raw_signal()
    exact = tr._signal_host(flat, idx, ib0)
    got = tr._signal_f32(flat, idx, ib0, "cpu")
    assert got.shape == exact.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)
    g = got.numpy()
    assert np.isfinite(g).all() and g.min() >= 0 and g.max() <= 1
    assert g[0, 1 + 3] == 0 and g[1, 1 + 4] == 0       # the NaN, the inf
    assert not g[2].any() and not g[3].any()            # no b0, a NaN b0
    assert g[5, 0] == 1 and not g[5, 1:].any()          # an inf b0
    batch = tr._signal_from_batch(
        torch.from_numpy(flat[idx]), torch.from_numpy(np.flatnonzero(ib0)),
        torch.from_numpy(np.flatnonzero(~ib0)))
    assert bool(torch.isnan(batch[0, 1 + 3]))


def test_signal_rows_shard_over_a_mesh():
    """Over a mesh: one copy and normalisation per shard, zero pad rows,
    the whole equal to the unsharded rows."""
    flat, idx, ib0 = _raw_signal(1)
    one = tr._signal_f32(flat, idx, ib0, "cpu")
    sh = tr._signal_f32(flat, idx, ib0, None, mesh=make_mesh(8, device="cpu"))
    rows = sh.numpy()
    assert rows.shape[0] % 8 == 0 and not rows[len(idx):].any()
    assert np.array_equal(rows[:len(idx)], one.numpy())


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

def _hold_refit(s, ds, n_order, d=None, s2=None):
    got = rumba_refit(s, ds, n_order, d, s2)
    want = rumba_refit_plain(s, ds, n_order, d, s2)
    assert _same(got[0], want[0]) and _same(got[2], want[2])
    if d is not None:
        torch.testing.assert_close(got[1], want[1], rtol=SIG2_RTOL, atol=0,
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_order", [1, 2])
@pytest.mark.parametrize("ndir,offset", [(253, 0), (61, 0), (64, 0),
                                         (61, 1), (3, 0)],
                         ids=["253", "61", "64", "61_unaligned", "3"])
def test_refit_kernel_equals_plain_on_card(cuda, ndir, offset, n_order):
    """Both modes, special rows included; `offset` starts every array one
    float into its buffer, which takes the kernel's unvectorised path."""
    def put(t):
        buf = torch.empty(t.numel() + offset, device=cuda)
        v = buf[offset:].view(t.shape)
        v.copy_(t)
        return v
    s, d, ds, s2 = (put(t) for t in _refit_inputs(
        seed=ndir, special=True, n=4099, ndir=ndir))
    before = rumba_refit.launches
    _hold_refit(s, ds, n_order)
    _hold_refit(s, ds, n_order, d, s2)
    buf = put(torch.zeros(s.shape))
    x = rumba_refit(s, ds, n_order, d, s2, out=buf)[2]
    assert x.data_ptr() == buf.data_ptr()
    assert _same(x, rumba_refit_plain(s, ds, n_order, d, s2)[2])
    assert rumba_refit.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["new", "num", "fodf"])
@pytest.mark.parametrize("c,tv_width", [(364, 364), (364, 368), (364, None),
                                        (183, 183), (183, 190)],
                         ids=["tv", "tv_strided", "no_tv", "odd", "odd_strided"])
def test_update_kernel_equals_plain_on_card(cuda, c, tv_width, out):
    f, num, den, tv = (None if t is None else t.to(cuda) for t in
                       _update_inputs(n=5003, c=c, tv_width=tv_width))
    want = rumba_update_plain(f, num, den, tv)
    f2, num2 = f.clone(), num.clone()
    dest = {"new": None, "num": num2, "fodf": f2}[out]
    before = rumba_update.launches
    got = rumba_update(f2, num2, den, tv, out=dest)
    assert rumba_update.launches == before + 1
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tv_bf16", [False, True])
def test_rumba_rec_launches_both_kernels_on_card(cuda, tv_bf16):
    """Ten iterations on the card: rumba_update ten times, rumba_refit ten
    times plus the first iteration's x; the fit matches the CPU's."""
    dwi, mask = _masked_phantom((8, 7, 6))
    before = rumba_update.launches, rumba_refit.launches
    g = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, tv_bf16=tv_bf16,
                     device="cuda", signal_wire="f32")
    assert rumba_update.launches - before[0] == 10
    assert rumba_refit.launches - before[1] == 11
    c = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, tv_bf16=tv_bf16,
                     device="cpu", signal_wire="f32")
    tol = dict(rtol=1e-3, atol=1e-4) if tv_bf16 else FIT
    np.testing.assert_allclose(g.fodf.vol, c.fodf.vol, **tol)


@pytest.mark.cuda
def test_f32_signal_route_on_card_skips_the_host_matrix(cuda, monkeypatch):
    """rumba_rec(signal_wire="f32") on the card never builds the host
    matrix, and its rows match _signal_host's within atol 1e-6."""
    flat, idx, ib0 = _raw_signal(2)
    exact = tr._signal_host(flat, idx, ib0)
    kept = {}
    real = tr._signal_f32

    def spy(*args, **kwargs):
        kept["rows"] = real(*args, **kwargs)
        return kept["rows"]

    def refuse(*args, **kwargs):
        raise AssertionError("the card's f32 route built the host matrix")

    monkeypatch.setattr(tr, "_signal_host", refuse)
    monkeypatch.setattr(tr, "_signal_f32", spy)
    dwi, mask, _, _ = make_phantom(shape=(5, 4, 4), ndir=30)
    dwi.vol = flat.reshape(np.asarray(dwi.vol).shape)
    dwi.bval = np.where(ib0, 0.0, dwi.bval).astype(np.float32)
    tt.rumba_rec(dwi, mask, ft.sphere_362, niter=2, device="cuda",
                 signal_wire="f32")
    rows = kept["rows"]
    assert rows.device.type == "cuda"
    np.testing.assert_allclose(rows.cpu().numpy(), exact, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_rumba_module_has_no_fallback(cuda, monkeypatch):
    """A failed build raises out of the wrapper on a CUDA tensor."""
    from fibers_tpu_torch.ops.kernels import _build

    def broken():
        raise RuntimeError("nvcc failed (stand-in)")

    monkeypatch.setattr(_build, "load_library", broken)
    s = torch.ones(4, 5, device=cuda)
    with pytest.raises(RuntimeError, match="stand-in"):
        rumba_refit(s, s, 1)
    with pytest.raises(RuntimeError, match="stand-in"):
        rumba_update(s, s, s)
