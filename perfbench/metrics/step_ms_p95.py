"""``step_ms_p95`` (ms, lower is better; device trace): the 95th percentile
of the window's step times.  A step's time is the interval between the
CUDA events recorded on the stream before and after it, read once the
window has closed; over several ranks, the slowest rank's."""

import numpy as np


def read(record):
    return float(np.percentile(record["step_ms"], 95))
