"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's, and the program's with a planted fault.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--control] [--faults none,noop,half,answer,prior,prior_half]

For each fault (``none``: the program as it is; else one of
``benchmark/faults.py``, planted in the program) and each seed: one run of
the cell through ``run.run_cell`` with a window of one unit (a fit, or the
first bucket collected), at the cell's size and load. With ``--control``
the control, the reference computed in TF32 (the precision below the
configuration's) at the program's fitted parameters, is judged in the
program's place. One JSON line per answer judged: both sides' numbers and
the run's verdict. The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", default="none")
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import faults, run

    if not torch.cuda.is_available():
        sys.exit(f"{args.workload} needs a CUDA card")
    judge = "control" if args.control else "program"
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            record = []
            with contextlib.nullcontext() if fault == "none" \
                    else faults.FAULTS[fault]():
                result = run.run_cell(args.workload, seed, 0.0, False,
                                      judge=judge, record=record)
            for index, readings in enumerate(record):
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "answer": index, "fault": fault,
                                  "judge": judge,
                                  "correct": result["correct"],
                                  **readings}), flush=True)


if __name__ == "__main__":
    main()
