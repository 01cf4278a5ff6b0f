"""``step_mfu`` (%; layer: train step, ``train/trainer.py``; moves
``train_img_per_s``): the model's operations of a forward and backward,
counted from the reference's shapes (every conv, dense, BatchNorm,
pooling and loss op, whatever implements it), times the window's steps,
over the window's seconds and the peak of all the cell's chips in the
cell's precision (bf16 989 TFLOP/s; f32 495/3 TFLOP/s, the 3xTF32 rate)."""

from perfbench import counts


def read(record):
    cell = record["cell"]
    return counts.mfu_pct(record["flops_per_step"], record["steps"], record["window_s"],
                          cell.dtype, record["chips"])
