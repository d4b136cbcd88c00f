"""A run judges what its timed path produced: on the CPU at a tiny size,
the whole of a run but the look for a card, sound and with the timed
path broken underneath; `correct` must come out true, then false."""

from __future__ import annotations

import pytest
import torch

from benchmark import faults, harness

CPU = torch.device("cpu")
SEED = 2**31 + 977  # larger than 32 signed bits hold


def run_cell(root, cell, trace=False):
    return harness.execute(cell, SEED, 0.3, trace, CPU, root=root)[0]


@pytest.mark.parametrize("cell", ["serve-single-f32", "serve-dir-f32",
                                  "train-b4-f32"])
def test_sound_run_is_correct(tiny_root, cell):
    result = run_cell(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_directory_window_short_of_every_candidate_is_judged(tiny_root):
    """A window that ends before any song drawn for the check: the
    window's first song is judged."""
    import json

    import numpy as np

    from benchmark import traffic, weights

    f = tiny_root / "benchmark/traffic/dir-f32.json"
    tr = json.loads(f.read_text())
    tr["songs"]["pool"], tr["directory_songs"] = 6, 1
    lengths = traffic.pool_lengths(tr["songs"], 8000)
    rng = np.random.default_rng(weights.sub_seed(SEED, 0xD1C))
    drawn = {int(np.argmax(lengths))} | {
        int(i) for i in rng.choice(6, tr["check_songs"] + 1, replace=False)}
    first = min(set(range(6)) - drawn)
    tr["order"] = [first] + [i for i in range(6) if i != first]
    f.write_text(json.dumps(tr))
    result = run_cell(tiny_root, "serve-dir-f32")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell, part", [("serve-single-f32", "serve"),
                                        ("serve-dir-f32", "dir")])
def test_traced_run_reports_its_layers(tiny_root, cell, part):
    result = run_cell(tiny_root, cell, trace=True)
    assert result["correct"]
    assert f"mfu_pct.{part}" in result["metrics"]
    assert not {"xrt", "xrt.dir"} & set(result["metrics"])
    assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])


@pytest.mark.parametrize("cell", ["serve-single-f32", "serve-dir-f32"])
def test_altered_stems_are_caught(tiny_root, cell, monkeypatch):
    """An answer altered where it is produced: the PCM16 conversion of
    the stems 1% loud."""
    from vocal_remover_tpu_torch.separate import separator

    real = separator.to_i16
    monkeypatch.setattr(separator, "to_i16", lambda w: real(w * 1.01))
    assert not run_cell(tiny_root, cell)["correct"]


def test_unchanged_state_is_caught(tiny_root, monkeypatch):
    """A step that returns its state unchanged: no optimizer step."""
    from vocal_remover_tpu_torch.train.step import Trainer

    monkeypatch.setattr(Trainer, "_apply", lambda self:
                        self.optimizer.zero_grad(set_to_none=True))
    result = run_cell(tiny_root, "train-b4-f32")
    assert not result["correct"]
    assert result["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(tiny_root):
    """Half of the batch left out, the mean taken over the rest."""
    with faults.half_batch():
        assert not run_cell(tiny_root, "train-b4-f32")["correct"]


def test_stale_staged_batch_is_caught(tiny_root):
    """A batch staged while another is in flight handed out stale: the
    checked steps run as the window's, several batches in flight."""
    with faults.stale_batch() as replaced:
        result = run_cell(tiny_root, "train-b4-f32")
    assert replaced, "no batch was staged with another in flight"
    assert not result["correct"]
    assert result["checks"]["feed"]["value"] > 1e-3
    assert result["checks"]["loss1"]["value"] <= 1e-4
