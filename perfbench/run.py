"""Runs one cell of the benchmark of the PyTorch and CUDA port once and
prints its result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is a fresh process: set-up (weights and data made on the card from
the seed, the kernels loaded from ``build/kernels/`` or built there, the
cell's own shapes warmed up), a window of ``--seconds`` of training steps,
with ``--trace 1`` some steps under ``torch.profiler`` after it, then the
check of the first steps against the plain reference.  Untraced runs report
the cell's end-to-end metrics, traced runs its per-layer metrics.
"""

import time

START = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the package's own directory would shadow the standard library's modules
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
sys.path.insert(0, str(ROOT))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    from perfbench import harness

    harness.cache_dirs()
    import torch

    cell = harness.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} present",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        record, correct, rows = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                                            START, device)
    else:
        record, correct, rows = harness.run_group(cell, args.seed, args.seconds,
                                                  bool(args.trace), START)
    harness.fail_if_forbidden(sorted(set(record["forbidden"]) |
                                     set(harness.forbidden_modules())))
    harness.report(cell, record, rows, correct, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
