"""``host_ms_per_step`` (ms; layer: train step; moves ``train_img_per_s``):
the host's clock around the step call, which enqueues the step's work
without waiting for it, as a mean over the window's steps; over several
ranks, the largest rank's mean."""


def read(record):
    return record["host_ms_per_step"]
