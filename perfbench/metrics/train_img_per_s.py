"""``train_img_per_s`` (img/s, higher is better; host clock): the images
trained in the window, over all ranks, over the window's seconds (from
the first step's launch to the device's end of the last)."""


def read(record):
    return record["steps"] * record["global_batch"] / record["window_s"]
