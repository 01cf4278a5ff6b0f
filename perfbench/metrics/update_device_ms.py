"""``update_device_ms`` (ms; layer: train step, ``train/trainer.py::
finish_step``, ``train/optimizer.py``; moves ``train_img_per_s``): built as
``forward_device_ms``, from a step's update start to its end (the exchange
in a group, the per-tensor clip and the SGD update)."""

from perfbench import phases


def read(record):
    return phases.phase_ms(record, "update")
