"""``first_step_s`` (s; layer: train step; moves ``setup_s``; host clock):
the port's ``setup.first_step`` span (``semantic_embeddings_torch/
spans.py``), the first call of the train step: lazy initialization, the
kernels' load or build, and the first step's enqueue.  Read in traced
runs of one process."""

from perfbench import phases


def read(record):
    return phases.first_step_s(record)
