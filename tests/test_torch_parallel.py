"""`mesh=` in the PyTorch port against tests/test_parallel.py.

The same phantoms, seeds and shapes as the JAX package's sharding tests,
on a mesh of 8 CPU shards (`make_mesh(8, device="cpu")`, the counterpart
of the 8 virtual CPU devices of conftest.py), with `model_axis` 1 and 2,
a data-only `Mesh` and 6 shards for DSI's chunk rounding.  Each sharded
fit of the port is held against the port's unsharded fit and against
`fibers_tpu`'s sharded fit on its 8-device mesh, from the same numpy
inputs.  Tolerances are the reference test's: DTI FA and the GQI ODF
rtol=1e-4, atol=2e-5; RUMBA-SD's fODF and GFA rtol=1e-4, atol=1e-6, its
peaks rtol=1e-3, atol=1e-5 and snr_mean within 1e-2; DSI's ODF and PDF
rtol=1e-4, atol=1e-6 and its peaks and QA rtol=1e-3, atol=1e-5; stream
line lengths equal and points within atol=1e-6 (1e-4 through a .trk
file).  Against JAX the port's own cross-package tolerances apply where
they are wider: RUMBA-SD's fit tolerances of test_torch_rumba.py and the
tract comparison of test_torch_stream.py.
"""

import os

import jax
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.parallel.mesh import make_mesh as jmake_mesh
from fibers_tpu_torch.core.batch import VoxelBatch
from fibers_tpu_torch.core.handoff import DevicePeaks
from fibers_tpu_torch.ops.kernels import tv_fused as tvf_mod
from fibers_tpu_torch.ops.kernels import tv_stencil as tvs_mod
from fibers_tpu_torch.parallel.mesh import (Mesh, ShardedRows, as_tensor,
                                            components_to_rows, gather_rows,
                                            make_mesh, pad_to_multiple,
                                            put_batch, rows_to_components,
                                            shard_max, shard_sum)

from phantom import make_phantom
from test_torch_stream import _compare_tracts, as_port

CPU = torch.device("cpu")
FIT = dict(rtol=1e-4, atol=2e-5)          # test_parallel.py: DTI and GQI
RUMBA = dict(rtol=1e-4, atol=1e-6)        # test_parallel.py: RUMBA, DSI
PEAKS = dict(rtol=1e-3, atol=1e-5)


def _require_jax_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"the JAX side needs {n} devices, has "
                    f"{len(jax.devices())}")


def cpu_mesh(n=8, model_axis=1):
    return make_mesh(n, model_axis=model_axis, device="cpu")


def _field(shape, kind="curved"):
    """tests/test_parallel.py's orientation fields, as port MRIs."""
    if kind == "curved":
        x, y, _ = np.meshgrid(*[np.linspace(0, 1, s) for s in shape],
                              indexing="ij")
        th = 0.8 * x + 0.4 * y
        v = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], axis=-1)
    else:
        v = np.zeros(shape + (3,), np.float32)
        v[..., 0] = 1.0
    ov = tt.MRI(vol=v.astype(np.float32))
    ov.vox2ras0 = np.eye(4, dtype=np.float32)
    ov.volsize = np.asarray(shape)
    ov.width, ov.height, ov.depth = shape
    ov.nframes = 3
    ov.set_geometry()
    return ov


# ------------------------------------------------------------------ #
# The mesh and the cross-shard operations
# ------------------------------------------------------------------ #

class TestMesh:
    def test_make_mesh_shapes(self):
        m = cpu_mesh(8, model_axis=2)
        assert dict(m.shape) == {"data": 4, "model": 2}
        assert m.devices.size == 8 and m.axis_names == ("data", "model")
        assert dict(cpu_mesh(4).shape) == {"data": 4, "model": 1}
        with pytest.raises(ValueError, match="model_axis"):
            cpu_mesh(6, model_axis=4)
        one = Mesh(np.array([CPU, CPU]), ("data",))
        assert dict(one.shape) == {"data": 2} and one.size == 2
        with pytest.raises(ValueError, match="data"):
            Mesh(np.array([CPU]), ("model",))

    def test_make_mesh_spans_distinct_cards_only(self, monkeypatch):
        """device=None means the card: it raises without one and when
        fewer cards exist than asked for, as the reference's make_mesh
        does; it never falls back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make_mesh(2)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="Requested 2 devices, have 1"):
            make_mesh(2)
        m = make_mesh(1)
        assert m.flat_devices == [torch.device("cuda", 0)]

    def test_put_batch_pads_and_shards(self):
        _require_jax_devices(8)
        from fibers_tpu.parallel.mesh import put_batch as jput
        x = np.arange(10, dtype=np.float32)[:, None]
        mesh = cpu_mesh(8, model_axis=2)
        arr = put_batch(x, mesh)
        assert isinstance(arr, ShardedRows)
        assert arr.shape == (12, 1) and arr.rows == [3, 3, 3, 3]
        assert all(s.device == CPU for s in arr.shards)
        want = np.asarray(jput(x, jmake_mesh(8, model_axis=2)))
        assert np.array_equal(arr.numpy(), want)
        assert pad_to_multiple(10, 4) == 12
        # a row slice keeps every shard, empty where it ends
        part = arr[:5, 0]
        assert part.rows == [3, 2, 0, 0]
        assert np.array_equal(part.numpy(), np.arange(5, dtype=np.float32))

    def test_shardings_place_rows(self):
        from fibers_tpu_torch.parallel.mesh import (batch_model_sharding,
                                                    batch_sharding)
        mesh = cpu_mesh(8, model_axis=2)
        x = np.random.default_rng(0).random((8, 6)).astype(np.float32)
        for sh in (batch_sharding(mesh), batch_model_sharding(mesh)):
            assert np.array_equal(sh.place(x).numpy(), x)
        assert batch_model_sharding(mesh).spec == ("data", "model")

    @pytest.mark.parametrize("model_axis", [1, 2])
    def test_reshard_is_a_permutation(self, model_axis):
        """rows -> components -> rows against a plain permutation: device
        k holds every row of columns k*w:(k+1)*w, and the way back gives
        the rows again, bit for bit."""
        rng = np.random.default_rng(1)
        mesh = cpu_mesh(8, model_axis)
        w = 5
        x = rng.random((40, 8 * w)).astype(np.float32)
        xs = put_batch(x, mesh)
        blocks = rows_to_components(xs, w)
        assert sorted(blocks) == list(range(8))
        for k, b in blocks.items():
            assert np.array_equal(b.numpy(), x[:, k * w:(k + 1) * w])
        back = components_to_rows(blocks, xs)
        assert back.rows == xs.rows
        assert np.array_equal(back.numpy(), x)
        with pytest.raises(ValueError, match="columns"):
            rows_to_components(xs, w + 1)

    def test_reductions_and_gather(self):
        rng = np.random.default_rng(2)
        mesh = cpu_mesh(8)
        x = rng.standard_normal((64, 3)).astype(np.float32)
        xs = put_batch(x, mesh)
        sums = shard_sum([s.sum(dim=0) for s in xs.shards], mesh)
        assert len(sums) == 8
        np.testing.assert_allclose(sums[0].numpy(), x.sum(axis=0),
                                   rtol=1e-5, atol=1e-5)
        maxes = shard_max([s.max() for s in xs.shards], mesh)
        assert float(maxes[-1]) == x.max()
        assert np.array_equal(gather_rows(xs, CPU).numpy(), x)
        assert np.array_equal(as_tensor(xs[:10, 1]).numpy(), x[:10, 1])


# ------------------------------------------------------------------ #
# DTI and GQI over a sharded batch
# ------------------------------------------------------------------ #

def _dti_inputs():
    """tests/test_parallel.py:test_dti_kernel_sharded_equals_unsharded's
    inputs."""
    rng = np.random.default_rng(0)
    ndir = 12
    dirs = rng.standard_normal((ndir, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bval = np.concatenate([[0.0], np.full(ndir, 1000.0)]).astype(np.float32)
    bvec = np.concatenate([np.zeros((1, 3), np.float32), dirs])
    signals = np.abs(rng.standard_normal((64, ndir + 1))).astype(np.float32)
    return bval, bvec, signals


class TestShardedFitMatchesLocal:
    def test_dti_kernel_sharded_equals_unsharded(self):
        _require_jax_devices(8)
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from fibers_tpu.models.dti import _dti_kernel as jdti
        from fibers_tpu_torch.models.dti import (_design_dti, _dti_kernel,
                                                 _per_shard)
        bval, bvec, signals = _dti_inputs()
        A = _design_dti(bval, bvec)
        ib0 = (bval == 0).astype(np.float32)
        local = _dti_kernel(torch.from_numpy(signals), torch.from_numpy(A),
                            torch.from_numpy(ib0)).numpy()
        sharded = _per_shard(_dti_kernel, put_batch(signals, cpu_mesh(8)),
                             A, ib0)
        assert isinstance(sharded, ShardedRows)
        np.testing.assert_allclose(sharded.numpy(), local, **FIT)
        jm = jmake_mesh(8)
        want = jdti(jax.device_put(signals, NamedSharding(jm, P("data"))),
                    jnp.asarray(A), jnp.asarray(ib0))
        np.testing.assert_allclose(sharded.numpy(), np.asarray(want), **FIT)


class TestShardedBatchAPI:
    def test_prepare_batch_with_mesh_runs_fits(self, tmp_mri):
        """prepare_batch(mesh=...) makes dti_fit/gqi_rec run once per
        shard with no other code changes; QA takes the max over shards."""
        _require_jax_devices(8)
        mri, _ = tmp_mri
        mask = ft.MRI.like(mri, 1, np.float32)
        mask.vol[:] = 1
        mesh = cpu_mesh(8)
        batch = tt.prepare_batch(mri, mask, mesh=mesh)
        assert batch.signals.shape[0] % 8 == 0 and batch.mesh is mesh
        jb = ft.prepare_batch(mri, mask, mesh=jmake_mesh(8))
        assert batch.n_pad == jb.n_pad
        assert np.array_equal(batch.signals.numpy(), np.asarray(jb.signals))

        dti_s = tt.dti_fit(mri, mask, batch=batch)
        dti_l = tt.dti_fit(mri, mask, device="cpu")
        dti_j = ft.dti_fit(mri, mask, batch=jb)
        np.testing.assert_allclose(dti_s.fa.vol, dti_l.fa.vol, **FIT)
        np.testing.assert_allclose(dti_s.fa.vol, dti_j.fa.vol, **FIT)
        adc_s, s0_s = tt.adc_fit(mri, mask, batch=batch)
        adc_l, s0_l = tt.adc_fit(mri, mask, device="cpu")
        np.testing.assert_allclose(adc_s.vol, adc_l.vol, **FIT)
        np.testing.assert_allclose(s0_s.vol, s0_l.vol, **FIT)

        gqi_s = tt.gqi_rec(mri, mask, tt.sphere_362, batch=batch)
        gqi_l = tt.gqi_rec(mri, mask, tt.sphere_362, device="cpu")
        gqi_j = ft.gqi_rec(mri, mask, ft.sphere_362, batch=jb)
        for other in (gqi_l, gqi_j):
            np.testing.assert_allclose(np.asarray(gqi_s.odf.vol),
                                       np.asarray(other.odf.vol), **FIT)
            for a, b in zip(gqi_s.qa, other.qa):
                np.testing.assert_allclose(a.vol, b.vol, **FIT)
        # gqi_fused is row-independent: its shards are the unsharded rows
        for a, b in zip(gqi_s.peak, gqi_l.peak):
            assert np.array_equal(a.vol, b.vol)

    def test_voxel_batch_from_jax_rows(self, tmp_mri):
        """The JAX batch's own padded rows, sharded on the port's mesh."""
        _require_jax_devices(8)
        mri, _ = tmp_mri
        mask = ft.MRI.like(mri, 1, np.float32)
        mask.vol[:] = 1
        jb = ft.prepare_batch(mri, mask, mesh=jmake_mesh(8))
        b = VoxelBatch.from_numpy(jb.idx, np.asarray(jb.signals),
                                  mesh=cpu_mesh(8))
        assert b.mesh is not None and b.n == jb.n
        got = tt.dti_fit(mri, mask, batch=b)
        want = ft.dti_fit(mri, mask, batch=jb)
        np.testing.assert_allclose(got.fa.vol, want.fa.vol, **FIT)

    def test_quantized_wire_raises_on_the_mesh(self, tmp_mri):
        """The u12 wire on the mesh (test_parallel.py's
        test_prepare_batch_mesh_u12_equals_local_u12): each shard decodes
        its rows, bit-equal to the unsharded u12 batch and to the JAX
        package's sharded one."""
        _require_jax_devices(8)
        mri, _ = tmp_mri
        mask = ft.MRI.like(mri, 1, np.float32)
        mask.vol[:] = 1
        b = tt.prepare_batch(mri, mask, mesh=cpu_mesh(8), wire="u12")
        local = tt.prepare_batch(mri, mask, wire="u12", device="cpu")
        jb = ft.prepare_batch(mri, mask, mesh=jmake_mesh(8), wire="u12")
        assert b.mesh is not None and b.signals.dtype == torch.float32
        assert np.array_equal(b.signals.numpy(), local.signals.numpy())
        assert np.array_equal(b.signals.numpy(), np.asarray(jb.signals))


# ------------------------------------------------------------------ #
# RUMBA-SD: row-sharded state, component-resharded TV
# ------------------------------------------------------------------ #

class _Spy:
    """Counts the calls of a kernel wrapper's plain version (the CPU
    side of the kernel) while it runs."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, spy)


def _noisy_phantom():
    """An 8x8x6 crop of the port's small config-4 phantom, which carries
    Rician noise: sigma^2 stays inside its clamp, so its mean over the
    shards is what the fit follows."""
    from fibers_tpu_torch.core.mri import MRI
    from fibers_tpu_torch.utils.phantom import make_rumba_brain
    dwi, mask, _ = make_rumba_brain(small=True)
    sl = (slice(10, 18), slice(10, 18), slice(6, 12))
    d = MRI.like(dwi, dwi.vol.shape[3], np.float32)
    d.vol = np.ascontiguousarray(dwi.vol[sl])
    d.bval, d.bvec = dwi.bval, dwi.bvec
    m = MRI.like(mask, 1, np.float32)
    m.vol = np.ascontiguousarray(mask.vol[sl])
    return d, m


def _assert_rumba_close(a, b, fodf_tol=RUMBA):
    np.testing.assert_allclose(np.asarray(a.fodf.vol), np.asarray(b.fodf.vol),
                               **fodf_tol)
    np.testing.assert_allclose(a.gfa.vol, b.gfa.vol, **RUMBA)
    for pa, pb in zip(a.peak, b.peak):
        np.testing.assert_allclose(pa.vol, pb.vol, **PEAKS)
    assert abs(a.snr_mean - b.snr_mean) < 1e-2


class TestShardedRumba:
    def test_rumba_sharded_equals_local_with_tv(self, monkeypatch):
        """rumba_rec over a sharded batch on a (4, 2) mesh, with the TV
        term resharded over the components of all 8 devices: the dense
        stencil (`tv_multiplier`'s plain version on the CPU) runs once
        per device per iteration, `tv_fused` never."""
        _require_jax_devices(8)
        dwi, mask, _, _ = make_phantom(shape=(6, 5, 4), ndir=30)
        local = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=8,
                             device="cpu")
        dense = _Spy(monkeypatch, tvs_mod, "tv_multiplier_plain")
        fused = _Spy(monkeypatch, tvf_mod, "tv_fused_plain")
        mesh = cpu_mesh(8, model_axis=2)
        batch = tt.prepare_batch(dwi, mask, mesh=mesh)
        sharded = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=8,
                               batch=batch)
        assert dense.calls == 8 * 8 and fused.calls == 0
        _assert_rumba_close(sharded, local)
        jb = ft.prepare_batch(dwi, mask, mesh=jmake_mesh(8, model_axis=2))
        ref = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=8, batch=jb)
        _assert_rumba_close(sharded, ref, dict(rtol=1e-4, atol=1e-7))

    @pytest.mark.parametrize("ipat", [1, 2])
    def test_rumba_noisy_sharded_equals_local(self, ipat):
        """With noise sigma^2 is not clamped, so its mean over the real
        rows of every shard (ipat 1) or its scatter into the lambda volume
        (ipat 2) is what the fit follows."""
        dwi, mask = _noisy_phantom()
        local = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=20,
                             ipat_factor=ipat, device="cpu")
        sharded = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=20,
                               ipat_factor=ipat, mesh=cpu_mesh(8))
        var = np.asarray(local.var.vol)[np.asarray(mask.vol) > 0]
        assert (var < (1.0 / 8) ** 2).all() and local.snr_std > 0
        _assert_rumba_close(sharded, local)
        np.testing.assert_allclose(sharded.var.vol, local.var.vol, **RUMBA)
        assert abs(sharded.snr_std - local.snr_std) < 1e-2

    def test_rumba_verbose_on_the_mesh(self, capsys):
        """verbose=True on a mesh prints each iteration's SNR over the real
        rows of every shard: `fibers_tpu`'s on its 8-device mesh and the
        port's one-device fit's to rounding, and at the last iteration the
        fit's own snr_mean and snr_std."""
        _require_jax_devices(8)
        from test_torch_stream import as_ref
        dwi, mask = _noisy_phantom()

        def printed(rec):
            lines = [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("Estimated mean SNR")]
            return rec, [tuple(float(v) for v in
                               ln.split("= ")[1].split(" (+-) "))
                         for ln in lines]
        kw = dict(niter=5, verbose=True)
        _, ref = printed(ft.rumba_rec(as_ref(dwi), as_ref(mask),
                                      ft.sphere_362, mesh=jmake_mesh(8),
                                      **kw))
        _, local = printed(tt.rumba_rec(dwi, mask, tt.sphere_362,
                                        device="cpu", **kw))
        sharded, got = printed(tt.rumba_rec(dwi, mask, tt.sphere_362,
                                            mesh=cpu_mesh(8), **kw))
        assert len(got) == len(local) == len(ref) == 5
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        np.testing.assert_allclose(got, local, rtol=1e-5)
        assert got[-1] == (sharded.snr_mean, sharded.snr_std)
        assert sharded.snr_std > 0

    def test_rumba_data_only_mesh(self):
        """rumba_rec works on a mesh with only a 'data' axis."""
        _require_jax_devices(8)
        from jax.sharding import Mesh as JMesh
        dwi, mask, _, _ = make_phantom(shape=(4, 4, 3), ndir=30)
        mesh = Mesh(np.array([CPU] * 8), ("data",))
        batch = tt.prepare_batch(dwi, mask, mesh=mesh)
        local = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=6,
                             device="cpu")
        sharded = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=6,
                               batch=batch)
        np.testing.assert_allclose(np.asarray(sharded.fodf.vol),
                                   np.asarray(local.fodf.vol), **RUMBA)
        jmesh = JMesh(np.array(jax.devices()[:8]), ("data",))
        ref = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=6,
                           batch=ft.prepare_batch(dwi, mask, mesh=jmesh))
        np.testing.assert_allclose(np.asarray(sharded.fodf.vol),
                                   np.asarray(ref.fodf.vol), rtol=1e-4,
                                   atol=1e-7)

    def test_rumba_bf16_tv_on_the_mesh(self, monkeypatch):
        """tv_bf16 on a mesh runs the same reshard with bf16 stacks and
        gives the one-device bf16 fit."""
        dwi, mask, _, _ = make_phantom(shape=(4, 4, 3), ndir=30)
        local = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=6,
                             tv_bf16=True, device="cpu")
        seen = []
        real = tvs_mod.tv_multiplier_plain

        def spy(v, lam):
            seen.append(v.dtype)
            return real(v, lam)
        monkeypatch.setattr(tvs_mod, "tv_multiplier_plain", spy)
        sharded = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=6,
                               tv_bf16=True, mesh=cpu_mesh(4))
        assert seen == [torch.bfloat16] * 6 * 4
        np.testing.assert_allclose(np.asarray(sharded.fodf.vol),
                                   np.asarray(local.fodf.vol), **RUMBA)

    def test_tv_stacks_have_16_byte_rows(self, monkeypatch):
        """Each device's TV stack holds a multiple of 4 components (rows of
        16 bytes in f32, which the stencil kernel stages with its wide
        copies); the zero padding components do not change the fit."""
        from fibers_tpu_torch.models.rumba import mesh_tv_width
        assert [mesh_tv_width(364, 2), mesh_tv_width(364, 8),
                mesh_tv_width(5, 8), mesh_tv_width(183, 4)] == [184, 48, 4, 48]
        dwi, mask, _, _ = make_phantom(shape=(4, 4, 3), ndir=30)
        local = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=4, device="cpu")
        widths = []
        real = tvs_mod.tv_multiplier_plain

        def spy(v, lam):
            widths.append(v.shape[-1])
            return real(v, lam)
        monkeypatch.setattr(tvs_mod, "tv_multiplier_plain", spy)
        sharded = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=4,
                               mesh=cpu_mesh(4))
        assert widths == [48] * 4 * 4         # C = 183 over 4 devices
        np.testing.assert_allclose(np.asarray(sharded.fodf.vol),
                                   np.asarray(local.fodf.vol), **RUMBA)

    def test_rumba_checkpoint_resumes_on_the_mesh(self, tmp_path):
        """A checkpoint written on the mesh resumes there as the same
        checkpoint resumes on one device (the resumed dODF ratio takes the
        saved sigma^2, on both, as in the reference)."""
        dwi, mask = _noisy_phantom()
        runs = {}
        for name, kw in (("mesh", dict(mesh=cpu_mesh(4))),
                         ("local", dict(device="cpu"))):
            ck = str(tmp_path / f"{name}.npz")
            tt.rumba_rec(dwi, mask, tt.sphere_362, niter=6,
                         checkpoint_path=ck, checkpoint_every=3, **kw)
            assert os.path.isfile(ck)
            runs[name] = tt.rumba_rec(dwi, mask, tt.sphere_362, niter=6,
                                      checkpoint_path=ck, **kw)
        np.testing.assert_allclose(np.asarray(runs["mesh"].fodf.vol),
                                   np.asarray(runs["local"].fodf.vol),
                                   **RUMBA)


# ------------------------------------------------------------------ #
# DSI
# ------------------------------------------------------------------ #

def _assert_dsi_close(a, b):
    for name in ("odf", "pdf"):
        np.testing.assert_allclose(np.asarray(getattr(a, name).vol),
                                   np.asarray(getattr(b, name).vol), **RUMBA)
    for pa, pb in zip(a.peak, b.peak):
        np.testing.assert_allclose(pa.vol, pb.vol, **PEAKS)
    for qa, qb in zip(a.qa, b.qa):
        np.testing.assert_allclose(qa.vol, qb.vol, **PEAKS)


class TestShardedDSI:
    def test_dsi_sharded_equals_local(self):
        _require_jax_devices(8)
        dwi, mask, _, _ = make_phantom(shape=(5, 4, 3), ndir=40,
                                       bmax=4000.0, two_shell=True)
        local = tt.dsi_rec(dwi, mask, tt.sphere_362, hann_width=8,
                           device="cpu")
        batch = tt.prepare_batch(dwi, mask, mesh=cpu_mesh(8))
        sharded = tt.dsi_rec(dwi, mask, tt.sphere_362, hann_width=8,
                             batch=batch)
        assert isinstance(sharded._peak_dev.vecs, ShardedRows)
        _assert_dsi_close(sharded, local)
        jb = ft.prepare_batch(dwi, mask, mesh=jmake_mesh(8))
        ref = ft.dsi_rec(dwi, mask, ft.sphere_362, hann_width=8, batch=jb)
        _assert_dsi_close(sharded, ref)

    def test_dsi_mesh_chunk_rounds_to_data_axis(self, monkeypatch):
        """On a 6-shard mesh the chunk rounds to a multiple of 6 and each
        device takes chunk / 6 rows of its shard per step; every real row
        is computed once."""
        _require_jax_devices(8)
        from fibers_tpu_torch.models import dsi as dsi_mod
        dwi, mask, _, _ = make_phantom(shape=(4, 3, 3), ndir=40,
                                       bmax=4000.0, two_shell=True)
        sizes = []
        real = dsi_mod._dsi_kernel

        def spy(signals, *a, **k):
            sizes.append(signals.shape[0])
            return real(signals, *a, **k)
        monkeypatch.setattr(dsi_mod, "_dsi_kernel", spy)
        batch = tt.prepare_batch(dwi, mask, mesh=cpu_mesh(6))
        sharded = tt.dsi_rec(dwi, mask, tt.sphere_362, hann_width=8,
                             batch=batch, mem_budget=2e6, chunk=5)
        # chunk 5 per device -> 30 rows per sharded chunk, 5 per device
        assert max(sizes) <= 5 and sum(sizes) == batch.n
        monkeypatch.setattr(dsi_mod, "_dsi_kernel", real)
        local = tt.dsi_rec(dwi, mask, tt.sphere_362, hann_width=8,
                           device="cpu")
        np.testing.assert_allclose(np.asarray(sharded.odf.vol),
                                   np.asarray(local.odf.vol), **RUMBA)
        jb = ft.prepare_batch(dwi, mask, mesh=jmake_mesh(6))
        ref = ft.dsi_rec(dwi, mask, ft.sphere_362, hann_width=8, batch=jb,
                         mem_budget=2e6)
        np.testing.assert_allclose(np.asarray(sharded.odf.vol),
                                   np.asarray(ref.odf.vol), **RUMBA)

    def test_dsi_mesh_without_batch(self):
        dwi, mask, _, _ = make_phantom(shape=(4, 3, 3), ndir=40,
                                       bmax=4000.0, two_shell=True)
        local = tt.dsi_rec(dwi, mask, tt.sphere_362, hann_width=8,
                           device="cpu")
        sharded = tt.dsi_rec(dwi, mask, tt.sphere_362, hann_width=8,
                             mesh=cpu_mesh(3))
        _assert_dsi_close(sharded, local)


# ------------------------------------------------------------------ #
# Tractography: sharded seeds
# ------------------------------------------------------------------ #

class TestShardedStream:
    def test_stream_sharded_equals_local(self):
        _require_jax_devices(8)
        ov = _field((16, 12, 10))
        local = tt.stream(ov, nsub=2, seed_rng=7, device="cpu")
        sharded = tt.stream(ov, nsub=2, seed_rng=7, mesh=cpu_mesh(8))
        assert np.array_equal(local.npts, sharded.npts)
        np.testing.assert_allclose(sharded.packed_xyz, local.packed_xyz,
                                   atol=1e-6)
        ref = ft.stream(as_ref_mri(ov), nsub=2, seed_rng=7,
                        mesh=jmake_mesh(8))
        _compare_tracts(ref, sharded)

    def test_stream_mesh_chunk_not_divisible(self):
        """A chunk that is not a multiple of the data axis, and a seed
        count that is not a multiple of the chunk: both pads at once."""
        ov = _field((12, 10, 8), "straight")
        local = tt.stream(ov, nsub=1, chunk=100, device="cpu")
        sharded = tt.stream(ov, nsub=1, chunk=100, mesh=cpu_mesh(8))
        assert np.array_equal(local.npts, sharded.npts)
        np.testing.assert_allclose(sharded.packed_xyz, local.packed_xyz,
                                   atol=1e-6)

    def test_stream_mesh_with_sink(self, tmp_path):
        """Sharded propagation composes with the streaming .trk sink,
        lines in seed order."""
        ov = _field((10, 8, 6), "straight")
        mem = tt.stream(ov, nsub=1, device="cpu")
        out = str(tmp_path / "sharded.trk")
        tt.stream(ov, nsub=1, mesh=cpu_mesh(8), trk_sink=out, chunk=64)
        back = tt.trk_read(out)
        assert back.n_count == mem.n_count
        assert np.array_equal(np.asarray(back.npts), np.asarray(mem.npts))
        mem.materialize()
        for i in range(0, mem.n_count, max(1, mem.n_count // 10)):
            np.testing.assert_allclose(back.xyz[i], mem.xyz[i], atol=1e-4)

    def test_stream_steps_build_no_tensor_from_the_host(self, monkeypatch):
        """The interleaved step loops of the shards make no host-to-device
        copy inside a step, as the one-device loop (C15)."""
        from test_torch_stream import _NoTorchTensor, _guard_launches
        ov = _field((12, 10, 8))
        want = tt.stream(ov, nsub=2, device="cpu", chunk=300)
        made = _guard_launches(monkeypatch, _NoTorchTensor())
        got = tt.stream(ov, nsub=2, mesh=cpu_mesh(4), chunk=300)
        assert len(made) >= 2
        assert np.array_equal(want.packed_xyz, got.packed_xyz)


def as_ref_mri(ov):
    from test_torch_stream import as_ref
    return as_ref(ov)


class TestDevicePeaksSharded:
    def test_handoff_stream_sharded_equals_local(self):
        """Sharded GQI peaks stay sharded on the device; stream(mesh=)
        gathers them into one field, copies it to every device and gives
        the local lines."""
        _require_jax_devices(8)
        dwi, mask, _, _ = make_phantom(shape=(10, 10, 10), ndir=30)
        mesh = cpu_mesh(8)
        gqi_s = tt.gqi_rec(dwi, mask, tt.sphere_362,
                           batch=tt.prepare_batch(dwi, mask, mesh=mesh))
        pk_s = tt.peaks_to_ovecs(gqi_s, device=True)
        assert isinstance(pk_s.vecs, ShardedRows)
        gqi_l = tt.gqi_rec(dwi, mask, tt.sphere_362, device="cpu")
        pk_l = tt.peaks_to_ovecs(gqi_l, device=True)
        pmask = as_port(mask)
        local = tt.stream(pk_l, mask=pmask, nsub=1, f_thresh=0.0)
        sharded = tt.stream(pk_s, mask=pmask, nsub=1, f_thresh=0.0,
                            mesh=mesh)
        also = tt.stream(pk_s.first(1), mask=pmask, nsub=1, f_thresh=0.0)
        assert np.array_equal(local.npts, sharded.npts)
        np.testing.assert_allclose(sharded.packed_xyz, local.packed_xyz,
                                   atol=1e-6)
        assert also.n_count > 0
        jg = ft.gqi_rec(dwi, mask, ft.sphere_362)
        ref = ft.stream(ft.peaks_to_ovecs(jg, device=True), mask=mask,
                        nsub=1, f_thresh=0.0, mesh=jmake_mesh(8))
        _compare_tracts(ref, sharded)

    def test_device_peaks_from_numpy_on_a_mesh(self):
        """DevicePeaks over sharded rows: `nvec` and `first` work on the
        shards."""
        dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=12)
        vecs = np.random.default_rng(0).standard_normal(
            (27, 3, 3)).astype(np.float32)
        mesh = cpu_mesh(4)
        pk = DevicePeaks(vecs=put_batch(vecs, mesh),
                         amp=put_batch(np.ones((27, 3), np.float32), mesh),
                         idx=np.arange(27), ref=mask)
        assert isinstance(pk.vecs, ShardedRows) and pk.nvec == 3
        assert np.allclose(pk.first(1).vecs.numpy()[:27, 0], vecs[:, 0])


# ------------------------------------------------------------------ #
# Structure tensor and the fused step
# ------------------------------------------------------------------ #

class TestShardedStructureTensor:
    @pytest.mark.parametrize("n,sigma,rho", [(8, 1.0, 1.0), (4, 1.0, 2.0),
                                             (6, 1.5, 1.0), (5, 1.0, 2.0)])
    def test_st_recon_sharded_equals_local(self, n, sigma, rho):
        """Slabs along the first axis the data axis divides (none for 5
        shards: unsharded), each with its halo, against one device and
        against the JAX package's sharded run; eigenvalues within 1e-5 of
        the largest (test_torch_structens.py)."""
        _require_jax_devices(8)
        rng = np.random.default_rng(n)
        vol = rng.random((16, 12, 10)).astype(np.float32)
        ev_l, el_l = tt.st_recon(vol, sigma, rho, device="cpu")
        ev_s, el_s = tt.st_recon(vol, sigma, rho, mesh=cpu_mesh(n))
        tol = 1e-5 * np.abs(el_l).max()
        np.testing.assert_allclose(el_s, el_l, rtol=0, atol=tol)
        np.testing.assert_allclose(np.abs(ev_s), np.abs(ev_l), atol=1e-4)
        _, el_j = ft.st_recon(vol, sigma, rho, mesh=jmake_mesh(n))
        np.testing.assert_allclose(el_s, np.asarray(el_j), rtol=0, atol=tol)

    def test_st_recon_lazy_on_the_mesh(self):
        vol = np.sin(np.arange(16, dtype=np.float32) / 3.0)[:, None, None] \
            * np.ones((16, 8, 8), np.float32)
        ev, el = tt.st_recon(vol, 1.0, 1.0, lazy=True, mesh=cpu_mesh(8))
        assert el.shape == (16, 8, 8, 3) and np.isfinite(el).all()


def _tiny_problem(n=256, ndir=30):
    """__graft_entry__.py:_tiny_problem's inputs, built with the port."""
    from fibers_tpu_torch.parallel.pipeline import build_constants
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((ndir, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bval = np.concatenate([[0.0], np.full(ndir, 1000.0)]).astype(np.float32)
    bvec = np.concatenate([np.zeros((1, 3), np.float32), dirs])
    c = build_constants(bval, bvec, tt.sphere_362)
    signals = np.abs(rng.standard_normal((n, ndir + 1))).astype(np.float32)
    ncomp = c["kernel"].shape[1]
    fodf = np.full((n, ncomp), 1.0 / ncomp, np.float32)
    sig2 = np.full((n, 1), (1.0 / 15) ** 2, np.float32)
    rsig = np.clip(np.abs(rng.standard_normal(
        (n, c["kernel"].shape[0]))), 0, 1).astype(np.float32)
    tv_shape3 = (8, 8, max(8, -(-n // 64)))
    lam_flat = np.full(int(np.prod(tv_shape3)), (1.0 / 15) ** 2,
                       np.float32)
    tv_idx = np.arange(n, dtype=np.int32)
    shape3 = (8, 8, 8)
    mask_flat = np.ones(512, bool)
    ovecs = rng.standard_normal((512, 1, 3)).astype(np.float32)
    ovecs /= np.linalg.norm(ovecs, axis=2, keepdims=True)
    seeds = rng.uniform(1, 6, (n, 3)).astype(np.float32)
    seed_vecs = ovecs[
        np.ravel_multi_index(np.round(seeds).astype(int).T, shape3), 0]
    return (signals, rsig, fodf, sig2, lam_flat, tv_idx, seeds, seed_vecs,
            mask_flat, ovecs, c["A_dti"], c["ib0"], c["A_gqi"], c["kernel"],
            c["verts_first"], c["nbr"], c["nbr_ok"], shape3, tv_shape3)


class TestFullReconStep:
    @pytest.mark.parametrize("model_axis", [1, 2])
    def test_full_recon_step_sharded_equals_unsharded(self, model_axis,
                                                      monkeypatch):
        """One step of every path on a mesh of 8 CPU shards against one
        device (bit for bit here) and against the JAX package's unsharded
        step on the same inputs (FA, ODF, QA: the DTI/GQI tolerance; the
        RUMBA update: RUMBA's)."""
        from fibers_tpu_torch.parallel.pipeline import full_recon_step
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        import __graft_entry__ as g
        args = _tiny_problem()
        dense = _Spy(monkeypatch, tvs_mod, "tv_multiplier_plain")
        fused = _Spy(monkeypatch, tvf_mod, "tv_fused_plain")
        local = full_recon_step(*args, device="cpu")
        assert (fused.calls, dense.calls) == (1, 0)
        sharded = full_recon_step(*args,
                                  mesh=cpu_mesh(8, model_axis=model_axis))
        assert (fused.calls, dense.calls) == (1, 8)
        names = ("fa", "odf", "peaks", "qa", "fodf", "sig2", "lam", "pts",
                 "npts")
        for name, a, b in zip(names, local, sharded):
            b = b.cpu() if isinstance(b, ShardedRows) else b
            assert torch.equal(a, b), name
        fn, jargs = g.entry()
        want = jax.jit(fn)(*jargs)
        for name, a, w in zip(names, local, want):
            w = np.asarray(w)
            if name in ("fodf", "sig2", "lam"):
                np.testing.assert_allclose(a.numpy(), w, **RUMBA)
            elif name in ("pts", "npts"):
                np.testing.assert_allclose(a.numpy(), w, atol=1e-5)
            else:
                np.testing.assert_allclose(a.numpy(), w, **FIT)

    def test_full_recon_step_needs_even_rows(self):
        from fibers_tpu_torch.parallel.pipeline import full_recon_step
        args = list(_tiny_problem(n=20))
        with pytest.raises(ValueError, match="evenly"):
            full_recon_step(*args, mesh=cpu_mesh(8))
