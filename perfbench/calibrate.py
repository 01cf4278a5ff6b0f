"""The readings that a cell's limits are set from, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--controls 3]

For each seed the program's first steps (as a run's set-up takes them) and
the reference's are compared (the lower readings); for the first
``--controls`` seeds also the control, the reference computed in the
precision below the cell's (f32 -> TF32, bf16 -> fp8), and the faults:
half of each batch left out (the reference, trained on the first half, in
the program's place) and, on several chips, the exchange of the gradients
left out (planted in the program).  With ``--witness`` also the reference
in float64, against which the program and the f32 reference are read
alike, each with its worst leaf by name and the worst gap of each kind of
leaf: what f32 rounding alone reads.  One JSON line a seed; the
benchmark's runs never run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
sys.path.insert(0, str(ROOT))

#: the control's precision, one below the cell's
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def worst_leaves(got, ref, kinds):
    """The leaf whose change over the steps lies farthest from the
    reference's (``checks.compare``'s measure), and the worst gap of each
    kind of leaf (conv, dense, scale, bias, mean, var)."""
    from perfbench import checks

    names = list(ref["change"])
    gaps = dict(zip(names, checks._gaps(got["change"], ref["change"], names)))
    worst = max(gaps, key=gaps.get)
    by_kind = {}
    for name, gap in gaps.items():
        by_kind[kinds[name]] = max(by_kind.get(kinds[name], 0.0), gap)
    return {"leaf": worst, "gap": gaps[worst], "by_kind": by_kind}


def program_readings(cell, seed, device):
    from perfbench import checks, feed, program

    tr = cell.traffic
    weights = feed.make_weights(cell.reference.shapes(cell.config, tr["classes"]), seed, device)
    port = program.Port(cell, weights, feed.make_data(tr, seed, device), device, seed)
    readings = port.first_steps(feed.Batches(tr, seed), weights, checks.CHECKED_STEPS)
    port.free()
    return readings


def group_readings(workload, traffic, chips, seeds, out, exchange, device_type):
    """One rank of a group reading the program's first steps for every seed
    (rank 0 writes them to ``out``); ``exchange`` False plants the fault of
    the gradients' exchange left out."""
    import json
    from dataclasses import replace

    from perfbench import harness
    from semantic_embeddings_torch import parallel

    if not exchange:
        parallel.reduce_gradients = lambda grads: grads
    cell = replace(harness.load_cell(workload, False), traffic=traffic, chips=chips)
    with harness.join_group(traffic, chips, device_type) as (device, _):
        found = {seed: program_readings(cell, seed, device) for seed in seeds}
        if parallel.rank() == 0:
            Path(out).write_text(json.dumps(found))


def program_readings_all(cell, seeds, device, exchange=True):
    """The program's readings of each seed: in this process on one chip, in
    one group of ranks on several."""
    if cell.chips == 1:
        return {seed: program_readings(cell, seed, device) for seed in seeds}
    import json
    import tempfile

    from semantic_embeddings_torch import parallel

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "readings.json"
        parallel.launch(group_readings, cell.chips, cell.name, cell.traffic, cell.chips, seeds,
                        str(out), exchange, device.type)
        return {int(k): v for k, v in json.loads(out.read_text()).items()}


def main():
    import argparse
    import json
    import time

    import torch

    from perfbench import checks, harness

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dump", default=None, help="directory for every seed's raw readings")
    parser.add_argument("--witness", action="store_true",
                        help="also read the program and the f32 reference against float64")
    args = parser.parse_args()
    harness.cache_dirs()
    cell = harness.load_cell(args.workload, False)
    device = torch.device(args.device)
    half = slice(0, cell.traffic["batch"] // 2)
    seeds = [int(s) for s in args.seeds.split(",")]
    programs = program_readings_all(cell, seeds, device)
    faults = {}
    if cell.chips > 1:
        faults = program_readings_all(cell, seeds[:args.controls], device, exchange=False)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ref = checks.reference_readings(cell, seed, device)
        raw = {"reference": ref, "program": programs[seed]}
        if seed in faults:
            raw["no_exchange"] = faults[seed]
        if i < args.controls:
            raw["control"] = checks.reference_readings(cell, seed, device, CONTROL[cell.dtype])
            raw["half_batch"] = checks.reference_readings(cell, seed, device, rows=half)
        out = {"seed": seed}
        out.update({k: checks.compare(v, ref) for k, v in raw.items() if k != "reference"})
        if args.witness:
            f64 = checks.reference_readings(cell, seed, device, dtype=torch.float64)
            raw["reference_f64"] = f64
            kinds = {n: k for n, (_, k) in cell.reference.shapes(
                cell.config, cell.traffic["classes"]).items()}
            sides = {"program": raw["program"], "reference_f32": ref}
            out["against_f64"] = {k: dict(checks.compare(v, f64), worst=worst_leaves(v, f64, kinds))
                                  for k, v in sides.items()}
            out["program_worst"] = worst_leaves(raw["program"], ref, kinds)
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            (Path(args.dump) / f"{args.workload}-{seed}.json").write_text(json.dumps(raw))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
