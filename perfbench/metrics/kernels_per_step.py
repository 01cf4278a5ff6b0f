"""``kernels_per_step`` (kernels; layer: model, ``models/``; moves
``train_img_per_s``): the GPU kernels a step launches (copies and memsets
left out), counted by the profiler over the traced steps on rank 0."""


def read(record):
    traces = record["traces"]
    return traces[0]["kernels_per_step"] if traces else None
