"""Readings that a cell's limits are set from, many seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control] [--fault half_batch]

For each seed, one run of the cell (set-up, a window of ``--seconds``, the
comparison), printing as one JSON line the numbers that decide
``correct``, each beside its limit.  With ``--control`` the control (the
reference in TF32, see ``serving.py`` and ``kinds/train_steps.py``) stands
in the program's place in that comparison, so the line's ``correct``
should read false, and the program's own numbers are under ``readings``;
with ``--fault``, the run is made with that fault planted (``faults.py``).  The
lines also go to ``build/portbench/<cell>.jsonl``.  The benchmark's
own runs never run the control or a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch
    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out = ROOT / "build" / "portbench"
    out.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        with faults.planted(args.fault):
            run = harness.run_cell(cell, seed, args.seconds, False,
                                   torch.device("cuda:0"),
                                   control=args.control)
        line = {"cell": cell.name, "seed": seed, "fault": args.fault,
                "correct": run.correct, "e2e": run.e2e,
                "setup_s": run.setup_s, "attempted": run.attempted,
                "failed": run.failed, "peak_bytes": run.memory_peak,
                "checks": run.checks, "readings": run.readings,
                "seconds": time.monotonic() - t}
        print(json.dumps(line), flush=True)
        with open(out / f"{cell.name}.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
