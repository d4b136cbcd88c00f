"""Tests of the benchmark (not of the measured package). Tests that need
a card carry the `cuda` marker and decide inside the test whether one is
there. `tiny_root` is a checkout-like directory whose BENCHMARK.json and
data files name the real cells at sizes a CPU test can run."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"n_fft": 256, "hop_length": 128, "nout": 8, "nout_lstm": 16,
        "offset": 64, "sr": 8000}
TINY_SONGS = {"pool": 3, "median_s": 3.0, "sigma": 0.3, "min_s": 2.0,
              "max_s": 4.0, "tones": 4}
# limits for the tiny sizes on the CPU, not the cells': sound runs read
# nsr ~5e-11 (bfloat16 ~1e-8); a train step's leaves are a few hundred
# values here, so one rounding flip moves a gradient norm by percents
TINY_LIMITS = {"serve-single-f32": {"nsr": 1e-8},
               "serve-dir-f32": {"nsr": 1e-8},
               "train-b4-f32": {"loss1": 1e-4, "grad": 0.2, "change": 0.9,
                                "feed": 1e-3}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def make_tiny_root(path: Path) -> Path:
    """BENCHMARK.json of the checkout, with every configuration, traffic
    mix and limit file cut to tiny sizes under `path`."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (path / "benchmark").mkdir(parents=True)
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(ROOT / "benchmark" / sub, path / "benchmark" / sub)
    for c in spec["configs"]:
        f = path / c["file"]
        cfg = json.loads(f.read_text())
        cfg.update(TINY)
        if "batchsize" in cfg:
            cfg.update(batchsize=2, patches=2)
        f.write_text(json.dumps(cfg))
    for f in (path / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        if "songs" in tr:
            tr["songs"] = TINY_SONGS
            tr.update(bucket_s=1, cropsize=256, batchsize=2,
                      group=min(tr.get("group", 1), 2), order=[1, 2, 0])
            if "directory_songs" in tr:
                tr["directory_songs"] = 2
        else:
            tr["pairs"].update(count=2, song_s=5.0, tones=4, variants=2)
            tr.update(num_workers=2, trace_steps=2)
        f.write_text(json.dumps(tr))
    for cell, limits in TINY_LIMITS.items():
        (path / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return path


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return make_tiny_root(tmp_path / "root")
