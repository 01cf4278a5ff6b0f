"""The device trace of a run: ``torch.profiler`` over CUDA activity alone
(kernels, copies and the CUDA runtime's calls) for a number of whole steps,
reduced to what the per-layer metrics read.  Host operations are not
recorded: at some 2,000 launches a step their records slowed the host until
the card waited on it, and the idle share read the tracer.

Every step launches the same kernels, so a kernel's launches a step are its
records over the steps.  The profiler now and then loses some records of a
window; a window whose records do not come out whole a step is taken again,
and after the last attempt each kernel's time is its mean record times its
launches a step (``rescaled``).
"""

from __future__ import annotations

import bisect
import math
import re
import time

import torch

NOT_KERNELS = ("Memcpy", "Memset")


def short_name(name):
    """A kernel's name up to its argument list, without ``void`` and the
    anonymous namespace."""
    return re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(")[0].split("<")[0]


def capture(run_steps, steps, device, attempts=3):
    """Runs one step under the profiler unrecorded (its own start-up), then
    ``run_steps(steps)`` recorded, after a synchronize and to one, and
    reduces the trace (see :func:`reduce`).  Takes the window again while
    records are lost, at most ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run_steps(1)
            torch.cuda.synchronize(device)
            prof.step()
            t0 = time.perf_counter()
            run_steps(steps)
            torch.cuda.synchronize(device)
            window = time.perf_counter() - t0
            prof.step()
        out = reduce(prof.events(), steps, window)
        if out["records_lost"] == 0 or attempt == attempts - 1:
            out["attempts"] = attempt + 1
            return out
    raise AssertionError("unreachable")


def reduce(events, steps, window_s):
    """From the profiler's events over ``steps`` steps: the kernels in the
    order they ran with their seconds (``sequence``), the busy seconds (the
    union of every device interval, so that overlapping streams count
    once), the launches and device seconds a step of each kernel by short
    name, the kernels a step, and the idle gaps by the host operation
    running at their middle (a CUDA runtime call, where one ran)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue  # a range such as ``nccl:all_reduce`` over the kernels it names
        if e.device_type == DeviceType.CUDA:
            device.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((e.time_range.start, e.time_range.end, e.name))
    device.sort()
    host.sort()
    if not device:
        raise RuntimeError("torch.profiler recorded no device activity")

    counts, times, sequence = {}, {}, []
    for start, end, name in device:
        if name.startswith(NOT_KERNELS):
            continue
        key = short_name(name)
        sequence.append((key, (end - start) * 1e-6))
        counts[key] = counts.get(key, 0) + 1
        times[key] = times.get(key, 0.0) + (end - start) * 1e-6
    per_step = {k: max(1, round(n / steps)) for k, n in counts.items()}
    lost = sum(max(0, per_step[k] * steps - n) for k, n in counts.items())
    kernels = {k: {"launches": per_step[k],
                   "seconds": times[k] / counts[k] * per_step[k]} for k in counts}

    # the union of the device intervals, and the gaps between its pieces
    first = device[0][0]
    last = max(end for _, end, _ in device)
    busy, gaps, reach = 0.0, [], first
    for start, end, _ in device:
        if start > reach:
            gaps.append((reach, start))
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    idle = {}
    starts = [s for s, _, _ in host]
    for a, b in gaps:
        label = _host_at(host, starts, (a + b) / 2)
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {
        "steps": steps,
        "window_s": window_s,
        "span_s": (last - first) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": kernels,
        "kernels_per_step": sum(per_step.values()),
        "sequence": sequence,
        "records_lost": lost,
        "idle_by_host": idle,
    }


def _host_at(host, starts, t, look_back=256):
    """The name of the innermost host operation running at time ``t``."""
    i = bisect.bisect_right(starts, t)
    best = None
    for start, end, name in host[max(0, i - look_back):i][::-1]:
        if end >= t:
            if best is None or start > best[0]:
                best = (start, name)
    return best[1] if best else "(no host operation)"


def kernel_seconds(trace, patterns):
    """Device seconds a step and launches a step of the kernels whose short
    name matches one of ``patterns`` (regular expressions)."""
    seconds = launches = 0
    for name, k in trace["kernels"].items():
        if any(re.search(p, name) for p in patterns):
            seconds += k["seconds"]
            launches += k["launches"]
    return seconds, launches


def breakdown(trace, top=10):
    """The device operations that took most time and the idle time by what
    the host was doing, each a list of at most ``top`` [name, seconds] over
    the traced window."""
    ops = sorted(((k, v["seconds"] * trace["steps"]) for k, v in trace["kernels"].items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def idle_pct(busy_s, window_s):
    return 100.0 * (1.0 - busy_s / window_s) if window_s > 0 else math.nan


def op_seconds(trace, main, helpers=(), shared=(), others=()):
    """Device seconds and launches a step of one op of the program that
    launches several kernels a call: its ``main`` kernels (counted as the
    launches) and ``helpers``, and each ``shared`` helper (a kernel two ops
    both launch) that runs after the last main kernel of ``others`` and
    before one of ``main``.  Names are short names."""
    seconds, launches, pending = 0.0, 0, 0.0
    for name, sec in trace["sequence"]:
        if name in shared:
            pending += sec
        elif name in main:
            seconds += sec + pending
            launches += 1
            pending = 0.0
        elif name in helpers:
            seconds += sec
        elif name in others:
            pending = 0.0
    return seconds / trace["steps"], launches / trace["steps"]


def conv3x3_roofline(record, main, helpers, others, work):
    """The roofline share (%) on rank 0 of one of the program's 3x3 conv ops
    (see :func:`op_seconds`; the repack into padded planes is the helper
    both ops share): the bound of ``work(layer, itemsize)`` over the
    reference's ``conv_b`` layers, over the op's device time a step.
    Nothing where no window is whole or the launches a step are not as
    many as those layers."""
    from . import counts

    traces = record["traces"]
    if not traces or traces[0]["records_lost"]:
        return None
    seconds, launches = op_seconds(traces[0], main, helpers, ("pad_planes_kernel",), others)
    layers = counts.conv3x3_shapes(record["layers"])
    if not launches or round(launches) != len(layers):
        return None
    dtype = record["cell"].dtype
    itemsize = 2 if dtype == "bfloat16" else 4
    return counts.roofline_pct([work(layer, itemsize) for layer in layers], seconds, dtype)
