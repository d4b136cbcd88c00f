"""The harness finds cells, configurations, traffic, limits and metric
readers by name, and measures nothing without a card."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness, run


def test_temporary_workload_found_by_name(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (tiny_root / "benchmark/traffic/single-f32.json").read_text())
    traffic["batchsize"] = 3
    (tiny_root / "benchmark/traffic/added-mix.json").write_text(
        json.dumps(traffic))
    (tiny_root / "benchmark/limits/added-cell.json").write_text(
        json.dumps({"nsr": 0.5}))
    spec["workloads"].append({"name": "added-cell",
                              "config": "cascaded-2048-serve",
                              "traffic": "added-mix", "chips": 1,
                              "why": "found by name"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "serve-single-f32" in m.get("workloads", []):
            m["workloads"].append("added-cell")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    files = harness.cell_files("added-cell", tiny_root)
    assert files["traffic"]["batchsize"] == 3
    assert files["limits"] == {"nsr": 0.5}
    assert {m["name"] for m in files["end_to_end"]} == {"xrt", "setup_s"}
    assert "launches_per_min.serve" in {m["name"] for m in files["per_layer"]}
    assert "mfu_pct.train" not in {m["name"] for m in files["per_layer"]}


def test_per_layer_without_workloads_follows_its_moves(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "mfu_pct.serve", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "Whole step", "moves": "xrt"})
    spec["per_layer"] = spec["per_layer"][-1:]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert [m["name"] for m in harness.cell_files(
        "serve-single-f32", tiny_root)["per_layer"]] == ["mfu_pct.serve"]
    assert harness.cell_files("serve-dir-f32", tiny_root)["per_layer"] == []
    assert harness.cell_files("train-b4-f32", tiny_root)["per_layer"] == []


@pytest.mark.parametrize("name, base", [("mfu_pct.added", "mfu_pct"),
                                        ("xrt.added", "xrt"),
                                        ("setup_s", "setup_s")])
def test_metric_without_a_reader_of_its_own_takes_its_base(name, base):
    assert harness.reader(name).__file__.endswith(f"metrics/{base}.py")


def test_every_metric_and_driver_has_its_file():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    for w in spec["workloads"]:
        files = harness.cell_files(w["name"])
        assert callable(harness.driver(files["traffic"]["driver"]).run)
        assert set(files["limits"]) and all(
            v > 0 for v in files["limits"].values())


@pytest.mark.parametrize("cards, chips", [(0, 1), (1, 4)])
def test_no_measurement_without_the_cards(monkeypatch, capsys, cards, chips):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    real = harness.cell_files

    def asking(name, root=harness.ROOT):
        files = real(name, root)
        files["cell"] = {**files["cell"], "chips": chips}
        return files

    monkeypatch.setattr(harness, "cell_files", asking)
    rc = run.main(["--workload", "serve-single-f32", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
