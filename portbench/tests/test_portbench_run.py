"""A run's result line, its guards, and the control and faults that its
check has to catch, at a small size on the CPU (the program's plain
versions)."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness, run
from portbench.calibrate import readings

ROOT = harness.ROOT
# the main path into a .trk: a configuration and a traffic mix of the
# benchmark whose cell BENCHMARK.json does not list yet (PERF.md §7)
TRK = {"name": "dti_gqi_trk", "config": "hcp_mgh_dti_gqi", "traffic": "trk",
       "chips": 1}


def _run(bench, name, shrink, trace=0, seconds=0.4):
    cell = TRK if name == TRK["name"] else harness.find(
        bench["workloads"], name, "workload")
    cfg = shrink(harness.load_config(bench, cell["config"]))
    args = types.SimpleNamespace(seed=2 ** 33 + 5, seconds=seconds,
                                 trace=trace)
    return harness.run_cell(bench, cell, args, 0.0, "cpu", cfg)


@pytest.mark.parametrize("name", ["dti_gqi_maps", "rumba_trk"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line(bench, shrink, name, trace):
    result, checks = _run(bench, name, shrink, trace)
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    want = {m["name"] for m in harness.metric_names(bench, name, trace)}
    got = set(result["metrics"])
    assert got <= want
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    for k, v in result["metrics"].items():
        assert set(v) == {"value", "unit"} and v["unit"] == units[k]
        assert isinstance(v["value"], float)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert want == got
    assert [c[0] for c in checks] == list(result["checks"])
    json.dumps(result)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("jax.numpy", "jaxlib", "flax.linen", "fibers_tpu.io"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "fibers_tpu_torch.io",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert run.forbidden_modules() == ["fibers_tpu", "flax", "jax",
                                       "jaxlib"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness, run; import fibers_tpu_torch; "
            "from portbench.pipelines import dti_gqi, rumba_sd; "
            "print(run.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "dti_gqi_maps", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _limits_failed(cfg, got):
    return [n for n, lim in cfg["limits"].items()
            if n in got and not got[n] <= lim]


@pytest.mark.parametrize("config", ["hcp_mgh_dti_gqi", "hcp_rumba_sd"])
def test_the_control_fails_and_the_program_passes(bench, shrink, config,
                                                  tmp_path):
    """The control (one precision below the configuration's) fails the
    limits set at the cells' size; the program passes them here too."""
    cfg = shrink(harness.load_config(bench, config))
    traffic = harness.load_traffic("trk")
    rows = readings(cfg, traffic, cfg["pipeline"], [2 ** 34 + 1], 1,
                    str(tmp_path), "cpu")
    prog = [g for _, side, g in rows if side == "program"][0]
    ctl = [g for _, side, g in rows if side == "control"][0]
    assert _limits_failed(cfg, prog) == []
    assert _limits_failed(cfg, ctl) != []


def _alter_odf(monkeypatch):
    """An answer altered where it is produced: one voxel's ODF, 1% up."""
    import fibers_tpu_torch.models.gqi as gqi
    real = gqi.gqi_fused

    def fused(*a):
        odf, *rest = real(*a)
        odf = odf.clone()
        odf[7] *= 1.01
        return (odf, *rest)
    monkeypatch.setattr(gqi, "gqi_fused", fused)


def _alter_tensor(monkeypatch):
    """An answer altered where it is produced: one voxel's first
    eigenvalue, 1% up."""
    import fibers_tpu_torch.models.dti as dti
    real = dti._dti_kernel

    def kernel(*a):
        out = real(*a).clone()
        out[3, 1] *= 1.01
        return out
    monkeypatch.setattr(dti, "_dti_kernel", kernel)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the voxel rows
    never reach the fits."""
    import fibers_tpu_torch as tt
    real = tt.prepare_batch

    def prepare(*a, **k):
        b = real(*a, **k)
        b.signals[b.signals.shape[0] // 2:] = 0
        return b
    monkeypatch.setattr(tt, "prepare_batch", prepare)


def _alter_point(monkeypatch):
    """A token altered where it is produced: the first point of each
    chunk's records moved by 0.1 mm as the .trk sink writes them."""
    from fibers_tpu_torch.io.trk import TrkSink
    real = TrkSink._write

    def write(self, out):
        out = out.copy()
        out[1] += 0.1
        return real(self, out)
    monkeypatch.setattr(TrkSink, "_write", write)


def _still_step(monkeypatch):
    """A step that returns its state unchanged: every RUMBA-SD iteration
    hands back the fODF, variance and TV weight it was given."""
    import fibers_tpu_torch.models.rumba as rumba

    def step(fodf, dodf, dodf_sig, sig2, lam_flat, signal, *a, **k):
        x = k.get("x")
        if x is None:
            x = rumba._first_x(signal, dodf_sig, 1)
        return fodf, dodf, dodf_sig, sig2, lam_flat, 1.0 / sig2.sqrt(), x
    monkeypatch.setattr(rumba, "_rumba_step", step)


FAULTS = [("dti_gqi_trk", _alter_odf), ("dti_gqi_maps", _alter_odf),
          ("dti_gqi_trk", _alter_tensor), ("dti_gqi_maps", _alter_tensor),
          ("dti_gqi_trk", _half_batch), ("dti_gqi_maps", _half_batch),
          ("dti_gqi_trk", _alter_point), ("rumba_trk", _alter_point),
          ("rumba_trk", _still_step)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(bench, shrink, monkeypatch,
                                            name, fault):
    fault(monkeypatch)
    result, checks = _run(bench, name, shrink)
    assert result["correct"] is False, result["checks"]
