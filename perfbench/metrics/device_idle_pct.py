"""``device_idle_pct`` (%; layer: device; moves ``train_img_per_s``): the
share of the traced window in which no operation runs on the card: one
minus the union of the device intervals (overlapping streams count once)
over the window, averaged over the ranks."""

from perfbench import trace


def read(record):
    traces = record["traces"]
    if not traces:
        return None
    return sum(trace.idle_pct(t["busy_s"], t["window_s"]) for t in traces) / len(traces)
