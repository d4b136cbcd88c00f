"""One run of one cell: find its files by name, run its driver, read its
metrics, judge `correct`, and build the result line.

What belongs to one configuration, one traffic mix or one metric lives in
files of its own, found by the names in BENCHMARK.json:
  * the cell: an entry of `workloads` (config, traffic, chips);
  * the configuration: the entry's `file` (benchmark/configs/<name>.json);
  * the traffic mix: benchmark/traffic/<traffic>.json, which names its
    driver (benchmark/drivers/<driver>.py) and holds every parameter;
  * the limits of `correct`: benchmark/limits/<cell>.json;
  * each metric: a reader, benchmark/metrics/<metric>.py, or for a
    metric named `<base>.<part>` without a file of its own the reader
    of `<base>` (metrics/<base>.py), whose `read(run)` returns the
    value, or None when the run has nothing for it to read (the metric
    is then left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _load_module(BENCH_DIR / "drivers" / f"{name}.py")


def reader(name: str):
    own = BENCH_DIR / "metrics" / f"{name}.py"
    if own.exists():
        return _load_module(own)
    return _load_module(BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py")


def cell_files(name: str, root: Path = ROOT) -> dict:
    """The cell `name` and what it names: {cell, config, traffic, limits,
    end_to_end, per_layer} (the metric entries that apply to it)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without `workloads` is every cell's that reports
    # the end-to-end metric it moves
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


class Run:
    """What one run of a cell knows: its inputs, and what its driver
    recorded for the metric readers and the check."""

    def __init__(self, files: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell = files["cell"]
        self.config = files["config"]
        self.traffic = files["traffic"]
        self.limits = files["limits"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.setup_s = None
        self.window_s = None
        self.work: dict = {}       # what the window completed
        self.counters: dict = {}   # the program's counters, read by the driver
        self.profile: dict | None = None  # trace.profile_slice's reduction
        self.peak_bytes = 0
        self.attempted = 0
        self.failed = 0
        self.checks: dict = {}     # compared number -> value

    def log(self, msg: str):
        """A progress line on standard error, seconds since the start."""
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {msg}",
              file=sys.stderr, flush=True)

    # the window ---------------------------------------------------------

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """Set-up ends here: sync, reset the memory peak; -> the deadline
        (perf_counter seconds)."""
        import torch

        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        self._t0 = now
        self._cpu0 = time.process_time()
        return now + self.seconds

    def close_window(self, t_end: float | None = None):
        """The window ends at `t_end` (default now, after a sync)."""
        import torch

        if t_end is None:
            self.sync()
            t_end = time.perf_counter()
        self.window_s = t_end - self._t0
        # this process's CPU seconds in the window: beside its wall time,
        # it tells a host whose cores ran slow from a run that waited
        self.counters["cpu_s"] = time.process_time() - self._cpu0
        if self.device.type == "cuda":
            self.sync()
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    # correctness --------------------------------------------------------

    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= self.limits[k]
            for k, v in self.checks.items()) and self.failed == 0


def read_metrics(run: Run, entries) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            root: Path = ROOT, t_start: float | None = None) -> tuple:
    """Run cell `name` once on `device`; -> (result dict, Run)."""
    files = cell_files(name, root)
    run = Run(files, seed, seconds, trace, device,
              time.perf_counter() if t_start is None else t_start)
    run.log(f"{name} seed {seed} on {device}: {run.traffic['driver']}")
    driver(run.traffic["driver"]).run(run)
    run.log(f"done: window {run.window_s} s, work {run.work}, counters "
            f"{run.counters}")
    if run.profile is not None:
        run.log("profile: " + json.dumps(
            {k: v for k, v in run.profile.items()
             if k not in ("device_ops", "idle_gaps")}))
    metrics = read_metrics(run, files["per_layer"] if trace
                           else files["end_to_end"])
    result = {"correct": run.correct(), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info(run)}
    if trace and run.profile is not None:
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": run.limits[k]}
                        for k, v in run.checks.items()}
    return result, run


def device_info(run: Run) -> dict:
    import torch

    if run.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(run.peak_bytes)
    if run.trace and run.profile is not None:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["slice_s"]
    return info


def report_checks(run: Run, stream=sys.stderr):
    for k, v in run.checks.items():
        print(f"check {k}: {v!r} (limit {run.limits[k]!r})", file=stream,
              flush=True)
