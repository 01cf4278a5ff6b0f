"""The test processes' torch thread pools: each pytest worker runs its share
of the host's cores (``tests/_torch_threads.py``), the processes it spawns
start with that share, and ``parallel.launch`` divides a process's threads
among the ranks that share its cores."""

import _torch_threads  # noqa: F401  (first: the worker's share of the cores)

import subprocess
import sys

import torch

import _torch_parallel_common as ranks
from semantic_embeddings_torch import parallel


def test_this_process_and_its_children_run_the_workers_share():
    assert torch.get_num_threads() == _torch_threads.THREADS
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120, check=True)
    assert int(out.stdout) == _torch_threads.THREADS


def test_launch_divides_the_threads_among_the_ranks(tmp_path, monkeypatch):
    """Ranks spawned from a process whose pool is four threads run two each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "4")
    monkeypatch.setenv("MKL_NUM_THREADS", "4")
    parallel.launch(ranks.report_threads, 2, str(tmp_path))
    assert [(tmp_path / f"rank{r}").read_text() for r in range(2)] == ["2", "2"]
