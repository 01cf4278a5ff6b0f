"""``forward_device_ms`` (ms; layer: model, ``models/``, ``data/cifar.py``;
moves ``train_img_per_s``): the device time from a step's start to its
backward's start (prepare, forward, losses, L2 penalty, metrics), device
idle inside included, between the CUDA events of the port's span recorder
(``semantic_embeddings_torch/spans.py``), mean over the traced steps."""

from perfbench import phases


def read(record):
    return phases.phase_ms(record, "forward")
