"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's, and the program's with a planted fault.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--control] [--faults none,noop,half,answer,exchange]

For each fault (``none``: the program as it is; else one of
``benchmark/faults.py``, planted in the program) and each seed: one run of
the cell through ``run.run_cell`` with a window of one unit (a fit, or the
first bucket collected), at the cell's size and load. With ``--control``
the control, the reference computed in TF32 (the precision below the
configuration's) at the program's fitted parameters, is judged in the
program's place. One JSON line per answer judged: both sides' numbers and
the run's verdict. A cell of several cards runs as its ranks
(``benchmark/ranks.py``), each with the fault planted; rank 0 prints. The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", default="none")
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import faults, ranks, run

    cell = run.load_json("workloads", args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.exit(f"{args.workload} needs {chips} CUDA card(s)")
    if chips > 1 and not ranks.launched():
        code, out = ranks.launch(chips, [__file__, *argv],
                                 t_start=time.time())
        sys.stdout.write(out)
        sys.exit(code)
    world = ranks.World() if chips > 1 else None
    judge = "control" if args.control else "program"
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            record = []
            with contextlib.nullcontext() if fault == "none" \
                    else faults.FAULTS[fault]():
                result = run.run_cell(args.workload, seed, 0.0, False,
                                      cell=cell, judge=judge, record=record,
                                      world=world)
            for index, readings in enumerate(record):
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "answer": index, "fault": fault,
                                  "judge": judge,
                                  "correct": result["correct"],
                                  **readings}), flush=True)
    if world is not None:
        world.close()


if __name__ == "__main__":
    main()
