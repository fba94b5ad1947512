"""Readings that the limits of a cell's check are set from.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... --control-seeds 101 102 103

For each of ``--seeds`` the program serves the cell's inputs of that seed
(and, for seeded models, its weights) through the cell's own entry point,
as many requests as a run compares (``retain``), and the check's numbers
are read against the float32 reference: the lower readings.  For each of
``--control-seeds`` the control, the reference with every convolution and
linear layer in float8 e4m3 (``reference.models``), is put in the
program's place on the same inputs and judged alike, and its readings go
through the verdict with the cell's committed limits: the upper readings,
each of which has to come out not correct.  One JSON line a seed on
standard output.  Runs on a CUDA device; ``--device cpu`` with
``--small`` rehearses it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(cell) -> None:
    """A size the CPU holds: two 512² frames a batch, 600×800 photos."""
    f = cell.traffic["frames"]
    if f["batch"] == 1:
        f.update(sizes=[[600, 800], [800, 600]], count=2, texture=256)
    else:
        f.update(count=4, batch=2)
    cell.traffic.update(warmup_rounds=1, retain=2)
    cell.config["dtype"] = "float32"


def control_readings(cell, seed: int, device) -> dict:
    """The control's readings on the cell's inputs of ``seed`` and its
    verdict under the cell's limits."""
    from benchmark.harness import check, session, spec, weights
    from benchmark.reference.pipeline import Reference

    seeded = weights.make(cell.config, seed, device)
    judging = spec.check(cell.traffic["check"])
    ref = Reference(cell.config, spec.ROOT, device, seeded=seeded)
    ctrl = Reference(cell.config, spec.ROOT, device, precision="fp8", seeded=seeded)
    inputs = session.make_inputs(cell.traffic, seed, device)
    judge = judging.Judge(ref)
    for i in range(cell.traffic["retain"]):
        k = i % len(inputs)
        frames = session.input_on(inputs[k], device)
        judge.add(k, frames, judging.control_outputs(ctrl, frames))
    readings = judge.readings()
    ok, checks = check.verdict(readings, cell.limits)
    return {**readings, "correct": ok, "over_limit": sorted(k for k, c in checks.items() if c["value"] > c["limit"])}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="CPU-sized inputs (rehearsal)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchmark.harness import loop, session, spec, weights
    from benchmark.reference.pipeline import Reference

    device = torch.device(args.device)
    cell = spec.load_cell(args.workload)
    if args.small:
        shrink(cell)
    n = cell.traffic["retain"]
    threshold = float(cell.config["engine"]["threshold"])
    judging = spec.check(cell.traffic["check"])
    cv = None
    for seed in args.seeds:
        seeded = weights.make(cell.config, seed, device)
        if cv is None or seeded:  # seeded models are the seed's own
            cv = loop.build(cell.config, spec.ROOT, device, seeded)
            warmed = False
        inputs = session.make_inputs(cell.traffic, seed, device)
        entry = spec.entry(cell.traffic["entry"])(cv, inputs, threshold, cell.traffic)
        if not warmed:
            session.warm_up(entry, cell.traffic, device)
            warmed = True
        keep = loop.Reservoir(n, np.random.default_rng([seed % (1 << 64), 1]))
        loop.closed_loop(entry, None, n, keep)
        entry.close()
        kept = [(k, entry.to_host(o)) for k, o in keep.kept]
        del keep, entry
        judge = judging.Judge(Reference(cell.config, spec.ROOT, device, seeded=seeded))
        for k, out in kept:
            judge.add(k, session.input_on(inputs[k], device), out)
        print(json.dumps({"cell": cell.name, "side": "program", "seed": seed, **judge.readings()}), flush=True)
        del judge, kept
        gc.collect()
    del cv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        print(json.dumps({"cell": cell.name, "side": "control", "seed": seed,
                          **control_readings(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
