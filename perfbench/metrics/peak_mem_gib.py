"""``peak_mem_gib`` (GiB, lower is better; host clock, read from the
allocator): ``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` before it, the largest over the ranks."""


def read(record):
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
