"""``step_gap_device_ms`` (ms; layer: train step, the loop around the step
call; moves ``train_img_per_s``): built as ``forward_device_ms``, from one
step's end to the next step's start, the device waiting on the loop between
steps, mean over the traced window's pairs of consecutive steps."""

from perfbench import phases


def read(record):
    return phases.phase_ms(record, "gap")
