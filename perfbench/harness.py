"""One run of one cell: set-up, the measured window, the traced steps,
the check against the reference, and the result's line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``, whose
``reference`` names the plain reference ``reference/<name>.py``) and its
traffic mix (``traffic/<name>.json``); the limits of the check are in
``checks/<cell>.json``; each metric is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import checks, counts, feed, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that no process of a run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "semantic_embeddings_tpu")
#: steps of each rank's set-up before the window (the first are checked)
WARM_STEPS = 5
#: steps traced after the window in a traced run
TRACE_STEPS = 10


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: dict  # name -> BENCHMARK.json entry, the ones this run reports
    reference: object

    @property
    def dtype(self):
        return self.traffic["dtype"]


def load_cell(name, traced):
    """The cell ``name`` of ``BENCHMARK.json`` with its files, and the
    metrics a run reports: the end-to-end ones untraced, the per-layer ones
    traced, each where its ``workloads`` (if given) list the cell."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((HERE / "checks" / f"{name}.json").read_text())["limits"]
    listed = bench["per_layer" if traced else "end_to_end"]
    metrics = {m["name"]: m for m in listed if name in m.get("workloads", [name])}
    reference = importlib.import_module(f"{__package__}.reference.{config['reference']}")
    return Cell(name, entry["chips"], config, traffic, limits, metrics, reference)


def reader(metric):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """The forbidden top-level names (compared whole) in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _HostEvent:
    """A ``torch.cuda.Event`` stand-in on the CPU (the tests' runs)."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(cell, seed, seconds, traced, device, start, agree=None):
    """This process's part of a run on ``device``: set-up from ``start``
    (the run's ``time.time()`` at process start), the first steps with
    their readings, the window of ``seconds``, and ``TRACE_STEPS`` traced
    steps.  Returns the process's record.

    Over a group of ranks, ``agree(steps)`` returns the first rank's
    ``steps``: the ranks agree once, before the window, on the steps that
    fill ``seconds`` at the timed warm-up's pace, so that no exchange but
    the program's own runs inside the window."""
    from . import program

    tr = cell.traffic
    marks = [("imports", time.time())]
    shapes = cell.reference.shapes(cell.config, tr["classes"])
    weights = feed.make_weights(shapes, seed, device)
    data = feed.make_data(tr, seed, device)
    _sync(device)
    marks.append(("inputs", time.time()))
    port = program.Port(cell, weights, data, device, seed, marks)
    del data
    batches = feed.Batches(tr, seed)
    readings = port.first_steps(batches, weights, checks.CHECKED_STEPS)
    del weights
    marks.append(("first steps", time.time()))
    _sync(device)
    w0 = time.perf_counter()
    for k in range(checks.CHECKED_STEPS, WARM_STEPS):
        port.step(k, batches.batch(k))
    cuda = device.type == "cuda"
    Event = torch.cuda.Event if cuda else _HostEvent
    _sync(device)
    pace = (time.perf_counter() - w0) / (WARM_STEPS - checks.CHECKED_STEPS)
    fixed = agree(max(1, round(seconds / pace))) if agree else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = program.launch_counters()

    # the window: CUDA events between the steps, read once it has closed
    k, events, host = WARM_STEPS, [], []
    marks.append(("warm-up", time.time()))
    setup_s = marks[-1][1] - start
    print("set-up: " + ", ".join(f"{name} {t - prev:.2f} s" for (name, t), (_, prev)
                                 in zip(marks, [("", start)] + marks[:-1])),
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    first = Event(enable_timing=True)
    first.record()
    while True:
        h0 = time.perf_counter()
        port.step(k, batches.batch(k))
        host.append(time.perf_counter() - h0)
        event = Event(enable_timing=True)
        event.record()
        events.append(event)
        k += 1
        if len(events) == fixed or (fixed is None and time.perf_counter() - t0 >= seconds):
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = len(events)
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + events[:-1], events)]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = program.launch_counters()
    finite = bool(torch.isfinite(port.sums["loss"]))

    traced_record = None
    if traced:
        def run_steps(n):
            nonlocal k
            for _ in range(n):
                port.step(k, batches.batch(k))
                k += 1
        traced_record = trace.capture(run_steps, TRACE_STEPS, device)
    port.free()
    return {
        "setup_s": setup_s,
        "steps": steps,
        "window_s": window_s,
        "step_ms": step_ms,
        "host_ms_per_step": 1e3 * sum(host) / steps,
        "peak_bytes": peak,
        "finite": finite,
        "launches": {op: (after[op] - before[op]) / steps for op in after},
        "readings": readings,
        "trace": traced_record,
        "forbidden": forbidden_modules(),
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
    }


def merge(cell, ranks):
    """The run's record from its ranks' (rank 0 first): a step's time is the
    slowest rank's, the window, the set-up and the peak the largest."""
    tr = cell.traffic
    steps = ranks[0]["steps"]
    layers = counts.record_layers(cell.reference, cell.config, tr["classes"],
                                  tr["batch"] // len(ranks), tr["image_size"])
    return {
        "cell": cell,
        "chips": len(ranks),
        "global_batch": tr["batch"],
        "steps": steps,
        "window_s": max(r["window_s"] for r in ranks),
        "setup_s": max(r["setup_s"] for r in ranks),
        "step_ms": [max(r["step_ms"][i] for r in ranks) for i in range(steps)],
        "host_ms_per_step": max(r["host_ms_per_step"] for r in ranks),
        "peak_bytes": max(r["peak_bytes"] for r in ranks),
        "finite": all(r["finite"] for r in ranks),
        "device_kind": ranks[0]["device_kind"],
        "launches": ranks[0]["launches"],
        "layers": layers,
        "flops_per_step": counts.model_flops(layers) * len(ranks),
        "traces": [r["trace"] for r in ranks] if ranks[0]["trace"] else None,
    }


def result_line(cell, record, numbers, correct, traced):
    """The result's JSON object: the metrics this run reports (those whose
    reader finds something), the device, and the numbers compared last."""
    values = {}
    for name, entry in cell.metrics.items():
        value = reader(name)(record)
        if value is not None:
            values[name] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": record["device_kind"],
              "count": record["chips"], "memory_peak_bytes": record["peak_bytes"]}
    out = {"correct": correct, "attempted": record["steps"],
           "failed": 0 if record["finite"] else record["steps"],
           "metrics": values, "device": device}
    if traced:
        traces = record["traces"]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = max(t["window_s"] for t in traces)
        out["breakdown"] = trace.breakdown(traces[0])
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in numbers}
    return out


def check(cell, seed, device, readings):
    """The reference's readings on ``device`` and the numbers compared:
    ``(correct, [[name, value, limit], ...])``."""
    ref = checks.reference_readings(cell, seed, device)
    return checks.judge(checks.compare(readings, ref), cell.limits)


def report(cell, record, rows, correct, traced):
    """Prints the path's counters, the numbers compared (last on standard
    error) and the result's line (last on standard output)."""
    launches = ", ".join(f"{op} {n:g}" for op, n in record["launches"].items())
    print(f"kernel launches a step in the window: {launches}", flush=True)
    line = result_line(cell, record, rows, correct, traced)
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def fail_if_forbidden(found):
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)
    print(f"modules: none of {', '.join(FORBIDDEN)} is loaded", flush=True)


def cache_dirs():
    """Points the compilers' caches at fixed directories in the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))


def run(cell, seed, seconds, traced, start, device):
    """A run of a one-chip cell in this process on ``device`` (the CPU in
    the tests): ``(record, correct, rows)``."""
    ranks = [run_rank(cell, seed, seconds, traced, device, start)]
    return finish(cell, seed, ranks, device)


def run_group(cell, seed, seconds, traced, start, device_type="cuda", target=None):
    """A run of a cell over ``cell.chips`` cards: one rank a card, spawned
    by the port's own launcher and joined as its ``--gpus`` path joins them
    (NCCL, sync BatchNorm; gloo ranks on the CPU in the tests); the check
    runs here on the first device once they ended.  ``(record, correct,
    rows)``.  ``target`` replaces :func:`rank_main` (a test's fault)."""
    import tempfile

    from semantic_embeddings_torch import parallel

    with tempfile.TemporaryDirectory() as out:
        parallel.launch(target or rank_main, cell.chips, cell.name, cell.traffic, cell.chips,
                        seed, seconds, traced, start, out, device_type)
        ranks = [json.loads((Path(out) / f"rank{r}.json").read_text())
                 for r in range(cell.chips)]
    return finish(cell, seed, ranks, torch.device(device_type, 0))


def join_group(traffic, chips, device_type):
    """The context of one rank of a group run: the port's ``--gpus`` side
    (``cli/common.py::data_parallel``) with the run's global batch."""
    from types import SimpleNamespace

    from semantic_embeddings_torch.cli import common

    args = SimpleNamespace(gpus=chips, device=device_type, spatial=1, bn_per_replica=False,
                           batch_size=traffic["batch"])
    return common.data_parallel(args)


def rank_main(workload, traffic, chips, seed, seconds, traced, start, out, device_type):
    """One rank of :func:`run_group` of the cell ``workload`` under the
    traffic ``traffic`` on ``chips`` ranks: its record goes to ``out``."""
    from dataclasses import replace

    import torch.distributed as dist
    from semantic_embeddings_torch import parallel

    cell = replace(load_cell(workload, traced), traffic=traffic, chips=chips)
    with join_group(traffic, chips, device_type) as (device, _):
        # rank 0's pace sets the window's steps for all, on a host group
        group = dist.new_group(backend="gloo")

        def agree(steps):
            count = torch.tensor([steps], dtype=torch.int64)
            dist.broadcast(count, 0, group=group)
            return int(count)

        record = run_rank(cell, seed, seconds, traced, device, start, agree)
        rank = parallel.rank()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(record))


def finish(cell, seed, ranks, device):
    """The run's record, and the check of rank 0's readings against the
    reference, computed on ``device`` after every rank freed its state."""
    record = merge(cell, ranks)
    correct, rows = check(cell, seed, device, ranks[0]["readings"])
    record["forbidden"] = sorted(set().union(*(r["forbidden"] for r in ranks)))
    return record, correct, rows
