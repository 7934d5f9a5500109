"""parallel/distributed.py against tests/test_distributed.py.

Single-process semantics on a mesh of 8 CPU devices, then two real
processes joined by a gloo process group on the CPU: each contributes its
half of the voxel batch, runs the DTI kernel on it and checks its rows
against the one-process result (which is held against the JAX package's
kernel), then the cross-process sum, max and gather and the RUMBA TV
reshard (`all_to_all_single`) against plain numpy.  Tolerances as
tests/test_distributed.py: rtol=1e-4, atol=2e-5 for the kernel, 1e-5
relative for the sums; the rest is exact.  Each child has a timeout, and
both are killed if either runs out.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fibers_tpu_torch.parallel.distributed import (global_mesh,
                                                   process_local_rows,
                                                   shard_voxel_batch)
from fibers_tpu_torch.parallel.mesh import ShardedRows, shard_sum

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_global_mesh_and_shard_batch(rng):
    import jax
    from fibers_tpu.parallel.distributed import \
        shard_voxel_batch as jshard

    mesh = global_mesh(model_axis=2, devices=["cpu"] * 8)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    assert dict(global_mesh().shape) == {"data": 1, "model": 1}

    n = 100
    local = rng.standard_normal((n, 6)).astype(np.float32)
    sl = process_local_rows(n)
    assert sl == slice(0, 100)

    arr = shard_voxel_batch(local, 104, mesh)       # padded to the mesh
    assert isinstance(arr, ShardedRows) and arr.shape == (104, 6)
    np.testing.assert_allclose(arr.numpy()[:n], local)
    np.testing.assert_allclose(arr.numpy()[n:], 0.0)
    if len(jax.devices()) >= 8:
        from fibers_tpu.parallel.distributed import global_mesh as jglobal
        want = np.asarray(jshard(local, 104, jglobal(model_axis=2)))
        assert np.array_equal(arr.numpy(), want)

    # a data-parallel reduction over the shards
    s = shard_sum([x.sum(dim=0) for _, x in arr.local()], mesh)[0]
    np.testing.assert_allclose(s.numpy(), local.sum(axis=0), rtol=1e-5,
                               atol=1e-4)


_CHILD_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

rank = int(sys.argv[1])
npz_path = sys.argv[2]
port = sys.argv[3]
out_path = sys.argv[4]

from fibers_tpu_torch.models.dti import _dti_kernel, _per_shard
from fibers_tpu_torch.parallel.distributed import (global_mesh, initialize,
                                                   process_local_rows,
                                                   shard_voxel_batch)
from fibers_tpu_torch.parallel.mesh import (components_to_rows,
                                            gather_rows, rows_to_components,
                                            shard_max, shard_sum)

initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
           process_id=rank, device="cpu")
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"

with np.load(npz_path) as z:
    signals, A, ib0, want = z["signals"], z["A"], z["ib0"], z["want"]

n = signals.shape[0]
mesh = global_mesh()
assert dict(mesh.shape) == {"data": 2, "model": 1} and mesh.multiprocess
sl = process_local_rows(n)
assert sl == slice(rank * n // 2, (rank + 1) * n // 2)
arr = shard_voxel_batch(signals[sl], n, mesh)
assert [s is not None for s in arr.shards] == [rank == 0, rank == 1]
out = _per_shard(_dti_kernel, arr, A, ib0)

# every local shard matches the one-process rows
checked = 0
for i, sh in out.local():
    o, r = out.offsets[i], out.rows[i]
    np.testing.assert_allclose(sh.numpy(), want[o:o + r], rtol=1e-4,
                               atol=2e-5)
    checked += r
assert checked == n // 2

# the global sum and max over both processes' shards
tot = shard_sum([s.sum(dim=0) for _, s in arr.local()], mesh)[0]
np.testing.assert_allclose(tot.numpy(), signals.sum(axis=0), rtol=1e-5,
                           atol=1e-4)
mx = shard_max([s.max() for _, s in arr.local()], mesh)[0]
assert float(mx) == float(signals.max())
assert np.array_equal(gather_rows(arr, "cpu").numpy(), signals)
assert np.array_equal(out.numpy(), gather_rows(out, "cpu").numpy())

# RUMBA's TV reshard across the processes: all rows of each process's
# columns, and back
x = np.ascontiguousarray(signals[:, :12])
xs = shard_voxel_batch(x[sl], n, mesh)
blocks = rows_to_components(xs, 6)
assert list(blocks) == [rank]
assert np.array_equal(blocks[rank].numpy(), x[:, rank * 6:(rank + 1) * 6])
back = components_to_rows(blocks, xs)
assert np.array_equal(back.shards[rank].numpy(), x[sl])

dist.destroy_process_group()
with open(out_path, "w") as f:
    f.write(f"OK {checked}")
"""


def test_two_process_distributed_dti(tmp_path):
    """Two gloo processes on the CPU, rendezvous on a free local port;
    each holds half of the batch (the multi-process branch of
    shard_voxel_batch) and runs the cross-process collectives."""
    import jax.numpy as jnp
    from fibers_tpu.models.dti import _dti_kernel as jdti
    from fibers_tpu_torch.models.dti import _design_dti, _dti_kernel

    rng = np.random.default_rng(11)
    ndir = 12
    dirs = rng.standard_normal((ndir, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bval = np.concatenate([[0.0], np.full(ndir, 1000.0)]).astype(np.float32)
    bvec = np.concatenate([np.zeros((1, 3), np.float32), dirs])
    A = _design_dti(bval, bvec)
    ib0 = (bval == 0).astype(np.float32)
    signals = np.abs(rng.standard_normal((64, ndir + 1))).astype(np.float32)

    want = _dti_kernel(torch.from_numpy(signals), torch.from_numpy(A),
                       torch.from_numpy(ib0)).numpy()
    np.testing.assert_allclose(
        want, np.asarray(jdti(jnp.asarray(signals), jnp.asarray(A),
                              jnp.asarray(ib0))), rtol=1e-4, atol=2e-5)

    npz = tmp_path / "dti_inputs.npz"
    np.savez(npz, signals=signals, A=A, ib0=ib0, want=want)
    script = tmp_path / "child.py"
    script.write_text(_CHILD_SCRIPT)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)

    procs, outs = [], []
    for rank in range(2):
        out = tmp_path / f"rank{rank}.ok"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(rank), str(npz), str(port),
             str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=240)
            logs.append(stdout.decode(errors="replace"))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"rank {rank} failed:\n{logs[rank][-3000:]}"
        assert out.read_text() == "OK 32"


@pytest.mark.cuda
def test_initialize_picks_nccl_on_the_card():
    """On the card the process group runs NCCL (one process here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist
    from fibers_tpu_torch.parallel.distributed import initialize
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = global_mesh()
        x = shard_voxel_batch(np.ones((8, 2), np.float32), 8, mesh)
        assert x.shards[0].device.type == "cuda"
        tot = shard_sum([x.shards[0].sum()], mesh)[0]
        assert float(tot) == 16.0
    finally:
        dist.destroy_process_group()
