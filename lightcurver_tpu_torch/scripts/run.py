"""The port's CLI entry point running the pipeline: a copy of
``lightcurver_tpu/scripts/run.py`` (``lc_run``).

Usage:
    python -m lightcurver_tpu_torch.scripts.run config.yaml [--start X]
        [--stop Y] [--device cuda|cpu] [--irfft-backend fft|matmul]

``--device`` (default ``cuda``) and ``--irfft-backend`` (default ``fft``)
go to the ``WorkflowManager``; without a card, pass ``--device cpu``.
PyYAML is imported when it runs.
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
    from ..pipeline.workflow_manager import WorkflowManager

    WorkflowManager(device=args.device,
                    irfft_backend=args.irfft_backend).run(
        start_step=args.start, stop_step=args.stop)


if __name__ == "__main__":
    run()
