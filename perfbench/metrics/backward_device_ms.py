"""``backward_device_ms`` (ms; layer: model; moves ``train_img_per_s``):
built as ``forward_device_ms``, from a step's backward start to its update
start (``torch.autograd.grad`` in ``train/trainer.py::finish_step``)."""

from perfbench import phases


def read(record):
    return phases.phase_ms(record, "backward")
