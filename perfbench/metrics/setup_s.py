"""``setup_s`` (s, lower is better; host clock): the seconds from the run's
process start to its first timed step, the largest over the ranks:
imports, weights and data made on the card, kernels loaded (or built, in a
checkout's first run), the first steps and the warm-up."""


def read(record):
    return record["setup_s"]
