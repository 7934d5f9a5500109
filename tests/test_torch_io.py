"""The port's own copies of the host modules against the JAX package's.

`fibers_tpu_torch` carries copies of the reference's host code (I/O,
geometry, transforms, coordinates, mask gather/scatter, sphere and LUT
tables, the native packer).  Each case feeds the same numpy inputs to
both and asks for the same result: files byte for byte, arrays and
headers exactly.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import fibers_tpu as ft
import fibers_tpu_torch as tt

from test_torch_stream import as_port


def _assert_same(a, b, where="obj"):
    """Exact equality of two host objects of the two packages: their
    fields, arrays (dtype and values) and header records."""
    if isinstance(a, np.void):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        assert type(a).__module__.replace("fibers_tpu.", "") == \
            type(b).__module__.replace("fibers_tpu_torch.", ""), where
        ka, kb = set(vars(a)), set(vars(b))
        assert ka == kb, where
        for k in sorted(ka):
            _assert_same(vars(a)[k], vars(b)[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _mod(pkg, name):
    """The module `name` of the package `pkg` (ft or tt)."""
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _volume(nframes, dtype, seed=3):
    """A reference MRI with an oblique vox2ras, and a DWI table when it
    has frames."""
    rng = np.random.default_rng(seed)
    shape = (7, 6, 5) + ((nframes,) if nframes > 1 else ())
    vol = (rng.standard_normal(shape) * 100).astype(dtype)
    m = ft.MRI(vol=vol)
    c, s = np.cos(0.3), np.sin(0.3)
    m.vox2ras0 = np.array([[-1.5 * c, 0, 1.5 * s, 10], [0, 2.0, 0, -8],
                           [1.5 * s, 0, 1.5 * c, 4], [0, 0, 0, 1]],
                          np.float32)
    if nframes > 1:
        m.bval = np.array([0] + [1000] * (nframes - 1), np.float32)
        m.bvec = ft.normalize_bvecs(
            rng.standard_normal((nframes, 3)).astype(np.float32))
    return m


VOLUMES = [(ext, nframes, dtype)
           for ext in ("mgh", "mgz", "nii", "nii.gz")
           for nframes, dtype in ((1, np.float32), (4, np.float32),
                                  (1, np.int16))]


@pytest.mark.parametrize("ext,nframes,dtype", VOLUMES,
                         ids=[f"{e}-{n}-{np.dtype(d).name}"
                              for e, n, d in VOLUMES])
def test_volume_files_are_byte_identical(tmp_path, ext, nframes, dtype):
    m = _volume(nframes, dtype)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj, pt = tmp_path / "j" / f"v.{ext}", tmp_path / "t" / f"v.{ext}"
    ft.mri_write(m, str(pj))
    tt.mri_write(as_port(m), str(pt))
    assert pj.read_bytes() == pt.read_bytes()
    for side in (".bvals", ".bvecs"):
        sj, st = tmp_path / "j" / f"v{side}", tmp_path / "t" / f"v{side}"
        assert sj.exists() == st.exists() == (nframes > 1)
        if nframes > 1:
            assert sj.read_bytes() == st.read_bytes()
    # the files are the same bytes: both packages read one of them
    rj, rt = ft.mri_read(str(pj)), tt.mri_read(str(pj))
    assert isinstance(rt, tt.MRI)
    _assert_same(rj, rt, f"read {ext}")
    hj, ht = ft.mri_read(str(pj), headeronly=True), tt.mri_read(
        str(pj), headeronly=True)
    _assert_same(hj, ht, f"header {ext}")


def _tract_inputs(scalars, seed=5):
    rng = np.random.default_rng(seed)
    npts = rng.integers(2, 12, 40).astype(np.int32)
    pts = rng.uniform(0, 6, (int(npts.sum()), 3)).astype(np.float32)
    sc = rng.random((len(pts), 1)).astype(np.float32) if scalars else None
    return npts, pts, sc


def _write_trk(pkg, ref, path, writer, scalars):
    npts, pts, sc = _tract_inputs(scalars)
    tr = pkg.Tract.from_ref(ref)
    if writer == "trk_write":
        tr.set_packed(pts, npts, sc)
        pkg.trk_write(tr, path)
        return
    if sc is not None:
        tr.n_scalars = 1
    cut, pcut = 17, int(npts[:17].sum())
    with _mod(pkg, "io.trk").TrkSink(path, tr, len(npts)) as sink:
        sink.append(pts[:pcut], npts[:cut],
                    None if sc is None else sc[:pcut])
        sink.append(pts[pcut:], npts[cut:],
                    None if sc is None else sc[pcut:])


@pytest.mark.parametrize("writer", ["trk_write", "TrkSink"])
@pytest.mark.parametrize("scalars", [False, True],
                         ids=["points", "scalars"])
def test_trk_files_are_byte_identical(tmp_path, writer, scalars):
    ft.mri_write(_volume(1, np.float32), str(tmp_path / "ref.nii.gz"))
    ref = ft.mri_read(str(tmp_path / "ref.nii.gz"))
    pj, pt = str(tmp_path / "j.trk"), str(tmp_path / "t.trk")
    _write_trk(ft, ref, pj, writer, scalars)
    _write_trk(tt, as_port(ref), pt, writer, scalars)
    with open(pj, "rb") as fj, open(pt, "rb") as fp:
        assert fj.read() == fp.read()
    tj, tr = ft.trk_read(pj), tt.trk_read(pj)
    assert isinstance(tr, tt.Tract) and tr.n_count == 40
    _assert_same(tj, tr, "trk")


def _host_cases():
    """name -> function(pkg) giving what both packages must agree on."""
    rng = np.random.default_rng(11)
    xyz = rng.standard_normal((3, 50))
    v2r = _volume(1, np.float32).vox2ras0

    def btables(pkg, tmp):
        bval = np.array([0, 1000, 1000, 2000, 2000], np.float32)
        bvec = rng.standard_normal((5, 3)).astype(np.float32)
        np.savetxt(tmp / "d.bvals", bval[None], fmt="%.6g")
        np.savetxt(tmp / "d.bvecs", bvec.T, fmt="%.9g")
        return (pkg.mri_read_bfiles(str(tmp / "d.bvals"),
                                    str(tmp / "d.bvecs")),
                pkg.normalize_bvecs(bvec))

    def xform(pkg, tmp):
        x = pkg.Xform()
        x.vox2vox = np.array([[0.9, -0.1, 0.05, 2], [0.1, 1.1, 0, -1],
                              [0, 0.02, 0.95, 0.5], [0, 0, 0, 1]],
                             np.float32)
        x.ras2ras = x.vox2vox.copy()
        x.voxrot = np.eye(3, dtype=np.float32)
        pts = np.rint(np.abs(xyz.T[:10]) * 4).astype(np.float32)
        inv = pkg.xfm_inv(x)
        both = pkg.xfm_compose(x, inv)
        return (pkg.xfm_apply(x, pts), pkg.xfm_apply(both, pts), inv,
                pkg.xfm_rotate(x, pts[0]),
                pkg.xfm_apply(x, pts.astype(np.int32)))

    def coords(pkg, tmp):
        x, y, z = xyz
        mask = rng.random((4, 4, 4)) > 0.5
        return (pkg.cart2pol(x, y), pkg.pol2cart(x, y), pkg.cart2sph(x, y, z),
                pkg.sph2cart(x, y, z), pkg.ang2rot(x[0], y[0]),
                [pkg.isinmask(p, mask) for p in ([1, 2, 3], [0.4, 1.6, 2.2],
                                                 [9, 0, 0])])

    def masked(pkg, tmp):
        m = _mod(pkg, "ops.masked")
        mask = rng.random((5, 4, 3)) > 0.4
        vol = rng.standard_normal((5, 4, 3, 2)).astype(np.float32)
        idx = m.mask_indices(mask)
        rows = m.gather_frames(vol, idx)
        return (idx, rows, m.scatter_frames(rows, idx, (5, 4, 3)),
                m.scatter_frames(rows[:, 0], idx, (5, 4, 3)),
                [m.padded_size(n) for n in (0, 1, 1024, 1025, 70_000)],
                m.pad_rows(rows, len(rows) + 5, fill=-1))

    def geometry(pkg, tmp):
        return (pkg.vox2ras_0to1(v2r), pkg.vox2ras_tkreg((7, 6, 5),
                                                         (1.5, 2.0, 1.5)),
                pkg.vox2ras_to_qform(v2r), pkg.vox2ras_to_orient(v2r))

    return dict(btables=btables, xform=xform, coords=coords, masked=masked,
                geometry=geometry)


@pytest.mark.parametrize("case", list(_host_cases()))
def test_host_functions_agree(tmp_path, case):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    # each package gets its own copy of the cases' random inputs
    _assert_same(_host_cases()[case](ft, tmp_path / "j"),
                 _host_cases()[case](tt, tmp_path / "t"), case)


@pytest.mark.parametrize("name", ["sphere_362", "sphere_642", "sphere_724",
                                  "fs_lut"])
def test_data_tables_are_equal(name):
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    with np.load(root / "fibers_tpu" / "data" / f"{name}.npz") as a, \
            np.load(root / "fibers_tpu_torch" / "data" / f"{name}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            _assert_same(a[k], b[k], f"{name}:{k}")
    if name.startswith("sphere"):
        _assert_same(getattr(ft, name), getattr(tt, name), name)
    else:
        _assert_same(ft.color_lut, tt.color_lut, name)


@pytest.mark.parametrize("nlines", [40, 12_000])
@pytest.mark.parametrize("ns", [0, 1, 2])
def test_packio_gives_the_numpy_path_bytes(monkeypatch, ns, nlines):
    """The port's native packer (its own build of packio.c, one line per
    OpenMP iteration, with `ns` per-point scalars) writes the record
    stream the numpy path writes, and the reference's bytes; lines of one
    point included, and 12,000 lines for a run over many threads."""
    from fibers_tpu.io import trk as jtrk
    from fibers_tpu_torch import native
    from fibers_tpu_torch.io import trk as ttrk
    assert native.lib() is not None, "packio.c did not build"
    rng = np.random.default_rng(nlines + ns)
    npts = rng.integers(1, 12, nlines).astype(np.int32)
    npts[::7] = 1
    pts = rng.uniform(-0.5, 60, (int(npts.sum()), 3)).astype(np.float32)
    sc = None if ns == 0 else \
        rng.standard_normal((len(pts), ns)).astype(np.float32)
    vsz = np.array([1.5, 2.0, 1.25], np.float32)
    fast = ttrk._pack_records(npts, pts, vsz, sc).copy()
    ref = jtrk._pack_records(npts, pts, vsz, sc).copy()
    monkeypatch.setattr(native, "lib", lambda: None)
    slow = ttrk._pack_records(npts, pts, vsz, sc).copy()
    assert len(fast) == nlines + (3 + ns) * len(pts)
    assert fast.tobytes() == slow.tobytes() == ref.tobytes()


@pytest.mark.parametrize("cc_has_openmp", [True, False])
def test_native_build_takes_openmp_from_the_system_cc(
        tmp_path, monkeypatch, cc_has_openmp):
    """The native helpers build with OpenMP from the first compiler that
    has it: a $CC without libgomp (its `-fopenmp` fails) gives way to the
    system cc; with no compiler that has it, a plain build."""
    import os
    import shutil
    import stat
    from fibers_tpu_torch import native
    fake = tmp_path / "gcc-without-omp"
    fake.write_text("#!/bin/sh\n"
                    "for a in \"$@\"; do\n"
                    "  [ \"$a\" = -fopenmp ] && exit 1\n"
                    "done\n"
                    "exec cc \"$@\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CC", str(fake))
    monkeypatch.setenv("FIBERS_NATIVE_CACHE", str(tmp_path / "cache"))
    if not cc_has_openmp:
        bindir = tmp_path / "bin"
        bindir.mkdir()
        (bindir / "cc").symlink_to(fake)
        real_cc = shutil.which("cc")
        fake.write_text(fake.read_text().replace("exec cc", f"exec {real_cc}"))
        monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    so = native._build()
    assert so is not None
    with open(so, "rb") as f:
        assert (b"GOMP_parallel" in f.read()) == cc_has_openmp


def test_lazy_volumes_materialize_the_eager_scatter():
    """The port's lazy volumes (its own copy of the reference's host
    classes, fetching through torch) give the reference's eager scatter,
    and `MRI.vol` recognises them."""
    import torch
    from fibers_tpu.ops.masked import scatter_frames
    from fibers_tpu_torch.core.lazy import LazyVolume, lazy_stack_volumes
    rng = np.random.default_rng(2)
    mask = rng.random((4, 3, 5)) > 0.5
    idx = np.flatnonzero(mask)
    rows = rng.standard_normal((len(idx) + 3, 2)).astype(np.float32)
    m = tt.MRI(vol=np.zeros(0, np.float32))
    m.vol = LazyVolume(torch.from_numpy(rows), idx, mask.shape, 2)
    assert np.array_equal(m.vol, scatter_frames(rows[:len(idx)], idx,
                                                mask.shape))
    stack = torch.from_numpy(np.ascontiguousarray(rows.T))
    for k, lv in enumerate(lazy_stack_volumes(stack, idx, mask.shape)):
        assert lv.shape == mask.shape
        assert np.array_equal(lv.materialize(), scatter_frames(
            rows[:len(idx), k], idx, mask.shape))
