"""The port's CLI entry point running the pipeline: a copy of
``lightcurver_tpu/scripts/run.py`` (``lc_run``).

Usage:
    python -m lightcurver_tpu_torch.scripts.run config.yaml [--start X]
        [--stop Y] [--device cuda|cpu] [--irfft-backend fft|matmul]

``--device`` (default ``cuda``) and ``--irfft-backend`` (default ``fft``)
go to the ``WorkflowManager``; without a card, pass ``--device cpu``.
PyYAML is imported when it runs.

On N cards of one host, the same arguments after
    torchrun --nproc-per-node N -m lightcurver_tpu_torch.scripts.run

When torchrun's ``WORLD_SIZE`` is above one, the process group is started
first (``parallel.distributed.initialize_distributed``: NCCL with a card
per local rank, else gloo) and ``--device cuda`` is the rank's own card.
The pipeline then runs once: the host tasks on rank 0 alone, the three fit
tasks sharded over every rank (``pipeline/workflow_manager.py``). A plain
launch is a world of one.
"""

import argparse
import os
from pathlib import Path

_DAG_PATH = (Path(__file__).parent.parent / "pipeline"
             / "pipeline_dependency_graph.yaml")


def run():
    import yaml

    with open(_DAG_PATH) as f:
        pipe_config = yaml.safe_load(f)
    task_list = "\n      - ".join(
        task["name"] for task in pipe_config["tasks"])
    docstring = f"""
    Run the lightcurver_tpu_torch pipeline (entirely, or between two steps).
    The pipeline is incremental: re-running it only processes new work.

    Step names for --start / --stop:
      - {task_list}
    """
    parser = argparse.ArgumentParser(
        description=docstring,
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("config_file", type=str,
                        help="Path to the config.yaml configuration file.")
    parser.add_argument("--start", type=str, default=None,
                        help="Step to start from (default: beginning).")
    parser.add_argument("--stop", type=str, default=None,
                        help="Step to stop at (default: end).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the numerical tasks (default: "
                             "cuda; cpu runs them on the CPU).")
    parser.add_argument("--irfft-backend", type=str, default="fft",
                        choices=("fft", "matmul"),
                        help="Render of the fits (default: fft).")
    args = parser.parse_args()

    os.environ["LIGHTCURVER_CONFIG"] = args.config_file
    sharded = int(os.environ.get("WORLD_SIZE", 1)) > 1
    if sharded:
        from ..parallel.distributed import initialize_distributed

        initialize_distributed()
    from ..pipeline.workflow_manager import WorkflowManager

    WorkflowManager(device=args.device,
                    irfft_backend=args.irfft_backend).run(
        start_step=args.start, stop_step=args.stop)
    if sharded:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    run()
