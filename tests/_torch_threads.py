"""This process's share of the host's cores, for torch's intra-op pool.

Every ``tests/test_torch_*.py`` imports this module first.  Under
``pytest -n N`` each of the N workers runs its own torch thread pool; at
the core count each, the workers' threads outnumber the cores N-fold and
every parallel region of thousands of small ops waits on descheduled
threads.  The share is the cores this process may run on divided by the
worker count (one worker without xdist).  ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS`` carry it to the processes the tests spawn (CLIs, gloo
ranks), which start with the same pool; ``parallel.launch`` divides a
rank's share by the world size.
"""

import os

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(THREADS)

import torch  # noqa: E402  (after the variables, so that its pool starts with them)

torch.set_num_threads(THREADS)
