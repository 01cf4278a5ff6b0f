"""A whole run of a cell on the card, as the benchmark's command runs it
(skips without one)."""

import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", "rn50-i224-f32-b128",
         "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) >= {"setup_s", "train_img_per_s"}
    assert list(line)[-1] == "checks"
