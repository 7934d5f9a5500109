"""The work-counting functions against the hand counts of PERF.md's
kernel tables (bytes each input read once, each output written once)."""

import types

import pytest

from portbench import harness, phantoms
from portbench.reference import gqi as ref_gqi
from portbench.reference import rumba as ref_rumba


def metric(name):
    return harness.load_metric(name)


def test_gqi_fused_bytes_at_the_main_path():
    verts, faces = ref_gqi.sphere("sphere_642")
    n = len(verts) // 2
    maxdeg = ref_gqi.neighbours(faces, n).shape[1]
    nbytes, flops = metric("gqi_fused.roofline_pct").work(720_896, 198, n,
                                                          maxdeg)
    assert round(nbytes / 1e9, 3) == 1.763
    assert round(flops / 3 / 1e9, 1) == 91.6          # 3 TF32 passes


def test_rl_gemm_bytes_and_operations_at_config_4():
    nbytes, flops = metric("rl_gemm.roofline_pct").work(715_200, 253, 364,
                                                        3)
    assert round(nbytes / 1e9, 3) == 5.296
    assert round(flops / 1e9, 1) == 1185.6


def test_rumba_update_and_refit_bytes_at_config_4():
    m = metric("rumba_step.roofline_pct")
    assert round(m.work_update(715_200, 364)[0] / 1e9, 3) == 5.207
    assert round(m.work_refit(715_200, 253)[0] / 1e9, 3) == 3.625
    assert round(m.work_refit(715_200, 253)[1] / 1e9, 2) == 7.42


def test_tv_fused_bytes_at_config_4():
    _, _, _, mask, _ = phantoms.geometry((140, 140, 92), "cpu")
    _, crop = ref_rumba._crop(mask.numpy())
    x, y, z = crop
    n = int(mask.sum())
    assert n == 715_200
    nbytes = metric("tv_fused.roofline_pct").work(n, 364, x * y * z)
    assert round(nbytes / 1e9, 2) == 2.09


@pytest.mark.parametrize("name", ["gqi_fused.roofline_pct",
                                  "propagate.roofline_pct",
                                  "rl_gemm.roofline_pct",
                                  "rumba_step.roofline_pct",
                                  "tv_fused.roofline_pct"])
def test_a_roofline_without_its_kernel_reads_nothing(name):
    run = types.SimpleNamespace(
        trace=types.SimpleNamespace(op_seconds=lambda p: (0.0, 0)),
        facts={}, peaks={}, n=3)
    assert metric(name).read(run) is None


def test_propagate_bytes_follow_the_point_wire():
    w = metric("propagate.roofline_pct").work
    f32 = w(1000, 50_000, 2_000, 1, "f32")
    i6 = w(1000, 50_000, 2_000, 1, "i6")
    assert f32 - i6 == (12 - 2.25) * 50_000 - 12 * 1000
