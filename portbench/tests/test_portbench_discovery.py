"""The harness finds every configuration, traffic mix, pipeline and metric
by the name BENCHMARK.json gives, and a new cell needs data files and
entries only."""

import json
import os
import shutil
import types

import pytest

from portbench import harness

BENCH = harness.BENCH


def test_every_name_resolves(bench):
    for cell in bench["workloads"]:
        cfg = harness.load_config(bench, cell["config"])
        assert cfg["name"] == cell["config"]
        harness.load_traffic(cell["traffic"])
        pipe = harness.load_pipeline(cfg["pipeline"])
        assert hasattr(pipe, "Cell")
        for traced in (False, True):
            names = harness.metric_names(bench, cell["name"], traced)
            assert names, (cell["name"], traced)
            for m in names:
                assert callable(harness.load_metric(m["name"]).read)


def test_each_cell_reports_setup_another_e2e_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.metric_names(bench, cell["name"],
                                                       False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_names(bench, cell["name"], True)


def test_config_files_lie_under_paths(bench):
    for c in bench["configs"]:
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])


@pytest.fixture
def copy_tree(tmp_path, monkeypatch, bench):
    """A checkout's copy of the benchmark in tmp_path, which the harness
    reads from instead of the repository's."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    monkeypatch.setattr(harness, "BENCH", str(tmp_path / "portbench"))
    return tmp_path


def test_a_new_cell_from_data_files_alone(copy_tree, shrink):
    """A configuration file, a traffic file and BENCHMARK.json entries make
    a cell that runs: no code is edited."""
    root = copy_tree
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/hcp_mgh_dti_gqi.json")
                     .read_text())
    cfg = shrink(cfg)
    cfg["name"] = "small_scan"
    cfg["scan"]["shells"] = [[1000, 30], [2000, 30]]
    (root / "portbench/configs/small_scan.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/burst.json").write_text(json.dumps(
        {"output": "maps", "subjects": 3, "checked": 1}))
    bench["configs"].append({"name": "small_scan", "source": "test",
                             "file": "portbench/configs/small_scan.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small_scan.burst",
                               "config": "small_scan", "traffic": "burst",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "dti_gqi_maps" in m["workloads"]:
            m["workloads"].append("small_scan.burst")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], "small_scan.burst", "workload")
    assert harness.load_traffic("burst")["subjects"] == 3
    args = types.SimpleNamespace(seed=2 ** 40 + 3, seconds=0.5, trace=0)
    result, checks = harness.run_cell(bench, cell, args, 0.0, "cpu")
    assert result["correct"] and result["attempted"] >= 2
    assert {"subject_s", "subject_p90_s", "setup_s"} <= set(
        result["metrics"])


def test_a_new_metric_is_a_file(copy_tree, bench):
    (copy_tree / "portbench/metrics/window.count.py").write_text(
        "def read(run):\n    return float(run.n)\n")
    mod = harness.load_metric("window.count")
    assert mod.read(types.SimpleNamespace(n=7)) == 7.0


def test_an_unknown_name_stops_the_run(bench):
    with pytest.raises(SystemExit):
        harness.find(bench["workloads"], "no_such_cell", "workload")
    assert os.path.isdir(os.path.join(BENCH, "metrics"))
