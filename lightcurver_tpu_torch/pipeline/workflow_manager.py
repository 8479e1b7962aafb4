"""WorkflowManager: config validation, task DAG, dispatch, post-checks. A
copy of ``lightcurver_tpu/pipeline/workflow_manager.py``.

The user config is checked key by key against the port's copy of the
example config, the 12-task DAG (the port's copy of
``pipeline_dependency_graph.yaml``) is sorted topologically, each task is
dispatched to the port's process function (the plate-solving strategy
chosen from the config) and the post-task checks run.

The differences from the JAX manager: there is no backend hook, and the
constructor takes ``device`` and ``irfft_backend``, which it passes to the
four tasks that run on the card (the PSF fits, the star photometry and the
ROI model take both, the ROI file preparation ``device``). The host tasks
take no argument, as in JAX. A CUDA device on a machine without one is
refused before any task runs: nothing falls back to the CPU. PyYAML is
imported by the functions that read YAML, so the module imports without it.

Under ``torchrun`` (a ``torch.distributed`` world of several ranks,
started by ``scripts/run.py``) the pipeline runs once, as JAX's runs once
over every chip of its host: the host tasks run on rank 0 alone, and the
three fit tasks (:data:`FIT_TASKS`) on every rank, where they shard their
fits over the ranks and rank 0 alone stores the results. After each task
every rank enters ``parallel.distributed.finish_task``, so a task that
fails on any rank makes every rank raise. Only rank 0 writes the session
log file. In a world of one every task runs, as before.
"""

import functools
import logging
import os
from collections import deque
from datetime import datetime
from pathlib import Path

import torch

from ..parallel.distributed import finish_task, is_writer
from ..structure.user_config import (get_user_config,
                                     compare_config_with_pipeline_delivered_one)
from ..structure.database import initialize_database
from ..structure.exceptions import TaskWasNotSuccessful
from ..processes.cutout_making import extract_all_stamps
from ..processes.star_querying import query_gaia_stars
from ..processes.psf_modelling import model_all_psfs
from ..processes.star_photometry import do_star_photometry
from ..processes.normalization_calculation import calculate_coefficient
from ..processes.roi_file_preparation import prepare_roi_file
from ..processes.roi_modelling import do_modelling_of_roi
from ..processes.alternate_plate_solving_with_gaia import \
    alternate_plate_solve_gaia
from ..processes.alternate_plate_solving_adapt_existing_wcs import \
    alternate_plate_solve_adapt_ref
from ..processes.absolute_zeropoint_calculation import calculate_zeropoints
from .task_wrappers import (read_convert_skysub_character_catalog,
                            plate_solve_all_frames,
                            calc_common_and_total_footprint_and_save)
from .state_checkers import check_plate_solving

_DAG_PATH = Path(__file__).parent / "pipeline_dependency_graph.yaml"

# the tasks that run on every rank, each sharding its fits over the ranks
# (the frames, the stars, the ROI's epochs); every other task is host work
# that runs on rank 0 alone
FIT_TASKS = ("psf_modeling", "star_photometry", "model_calibrated_cutouts")


def setup_base_logger():
    """The 'lightcurver' logger, with the session log file on rank 0."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    base_logger = logging.getLogger("lightcurver")
    base_logger.setLevel(logging.INFO)
    if not is_writer():
        return
    time_now = datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    log_dir = get_user_config()["workdir"] / "logs"
    log_dir.mkdir(parents=True, exist_ok=True)
    # constructing WorkflowManager repeatedly (notebook re-runs) must
    # not stack file handlers — every line would be written to every
    # previously opened session log
    for old in [h for h in base_logger.handlers
                if isinstance(h, logging.FileHandler)]:
        base_logger.removeHandler(old)
        old.close()
    handler = logging.FileHandler(str(log_dir / f"{time_now}.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    base_logger.addHandler(handler)


def _validate_config_keys():
    """Hard error on missing keys (with defaults printed); error on
    unknown keys unless LIGHTCURVER_RELAX_CONFIG_CHECK is set."""
    diff = compare_config_with_pipeline_delivered_one()
    if missing := diff["extra_keys_in_pipeline_config"]:
        defaults = diff["pipeline_extra_keys_values"]
        lines = ["You are missing the following parameters in your config "
                 "file:",
                 f"{'Parameter':<50} {'(Default value)':<50}",
                 f"{'-' * 50} {'-' * 50}"]
        for key in missing:
            value = defaults[key]
            lines.append(f"{key:<50} "
                         f"{'None (not set)' if value is None else value}")
        raise RuntimeError("\n".join(map(str, lines)))
    if extra := diff["extra_keys_in_user_config"]:
        message = (f"You have parameters in your config file that are not "
                   f"in the latest config version: {extra}.\nRemove them, "
                   "or set LIGHTCURVER_RELAX_CONFIG_CHECK=1 to ignore.")
        # value-aware: '=0' keeps the check strict
        if os.environ.get("LIGHTCURVER_RELAX_CONFIG_CHECK",
                          "").lower() in ("1", "true", "yes"):
            print("===== config check relaxed: =====")
            print(message)
        else:
            raise RuntimeError(message)


def _check_device(device):
    """Refuse a CUDA device on a machine that has none."""
    if torch.device(device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            f"WorkflowManager(device={device!r}): no CUDA device is "
            "available. Pass device=\"cpu\" (--device cpu) to run the "
            "pipeline on the CPU.")


class WorkflowManager:
    """Runs the pipeline tasks in dependency order, the numerical ones on
    ``device`` (the card unless the caller asks for ``"cpu"``), rendering
    with ``irfft_backend`` ("fft" or "matmul")."""

    def __init__(self, logger=None, *, device="cuda", irfft_backend="fft"):
        _check_device(device)
        _validate_config_keys()
        import yaml

        self.user_config = get_user_config()
        with open(_DAG_PATH) as f:
            self.pipe_config = yaml.safe_load(f)
        self.task_graph = {}
        self.build_dependency_graph()

        strategy = self.user_config["plate_solving_strategy"]
        plate_solve_function = {
            "plate_solve": plate_solve_all_frames,
            "alternate_gaia_solve": alternate_plate_solve_gaia,
            "adapt_wcs_from_reference": alternate_plate_solve_adapt_ref,
        }.get(strategy)
        if plate_solve_function is None:
            raise AssertionError(
                "The config's plate_solving_strategy should be "
                "plate_solve, alternate_gaia_solve or "
                "adapt_wcs_from_reference.")

        card = {"device": device, "irfft_backend": irfft_backend}
        self.task_attribution = {
            "initialize_database": initialize_database,
            "read_convert_skysub_character_catalog":
                read_convert_skysub_character_catalog,
            "plate_solving": plate_solve_function,
            "calculate_common_and_total_footprint":
                calc_common_and_total_footprint_and_save,
            "query_gaia_for_stars": query_gaia_stars,
            "stamp_extraction": extract_all_stamps,
            "psf_modeling": functools.partial(model_all_psfs, **card),
            "star_photometry":
                functools.partial(do_star_photometry, **card),
            "calculate_normalization_coefficient": calculate_coefficient,
            "calculate_absolute_zeropoints": calculate_zeropoints,
            "prepare_calibrated_cutouts":
                functools.partial(prepare_roi_file, device=device),
            "model_calibrated_cutouts":
                functools.partial(do_modelling_of_roi, **card),
        }
        self.post_task_attribution = {
            "plate_solving": check_plate_solving,
        }
        assert set(self.task_attribution) == {
            entry["name"] for entry in self.pipe_config["tasks"]}

        if logger is None:
            setup_base_logger()
            # inside the 'lightcurver' hierarchy, so that orchestration
            # lines reach the session FileHandler attached there
            logger = logging.getLogger("lightcurver.workflow_manager")
        self.logger = logger

    def build_dependency_graph(self):
        for task in self.pipe_config["tasks"]:
            name = task["name"]
            self.task_graph.setdefault(name, {"dependencies": set(),
                                              "next": []})
            self.task_graph[name]["dependencies"] = set(
                task["dependencies"])
            for dep in task["dependencies"]:
                self.task_graph.setdefault(dep, {"dependencies": set(),
                                                 "next": []})
                self.task_graph[dep]["next"].append(name)

    def topological_sort(self):
        """Kahn's algorithm; raises on cycles."""
        in_degree = {task: len(node["dependencies"])
                     for task, node in self.task_graph.items()}
        queue = deque(task for task, deg in in_degree.items() if deg == 0)
        ordered = []
        while queue:
            task = queue.popleft()
            ordered.append(task)
            for nxt in self.task_graph[task]["next"]:
                in_degree[nxt] -= 1
                if in_degree[nxt] == 0:
                    queue.append(nxt)
        if len(ordered) != len(self.task_graph):
            raise Exception("A cycle was detected in the task "
                            "dependencies, or a task is missing.")
        return ordered

    def run(self, start_step=None, stop_step=None):
        """Run tasks from start_step to stop_step (inclusive)."""
        self.logger.info(
            f"Workflow manager: tasks from {start_step or 'start'} to "
            f"{stop_step or 'end'}; workdir "
            f"{self.user_config['workdir']}.")
        ordered = self.topological_sort()
        for name in (start_step, stop_step):
            if name is not None and name not in ordered:
                raise ValueError(
                    f"Unknown pipeline step {name!r}. Valid steps, in "
                    f"order: {ordered}")
        start = ordered.index(start_step) if start_step else 0
        stop = ordered.index(stop_step) + 1 if stop_step else len(ordered)
        if start >= stop:
            raise ValueError(
                f"start_step {start_step!r} comes after stop_step "
                f"{stop_step!r} in the pipeline order {ordered}; "
                "nothing would run.")
        for task_name in ordered[start:stop]:
            error = None
            if task_name in FIT_TASKS or is_writer():
                try:
                    self.run_task(task_name)
                except BaseException as exc:
                    # raised again by finish_task, after every rank knows
                    error = exc
            finish_task(task_name, error)

    def run_task(self, task_name):
        """One task and its post-check, on this rank."""
        task = next((t for t in self.pipe_config["tasks"]
                     if t["name"] == task_name), None)
        if task:
            self.execute_task(task)
        post_check = self.post_task_attribution.get(task_name)
        if post_check:
            success, message = post_check()
            if not success:
                self.logger.error(
                    f"Post-check failed for {task_name}: {message}")
                raise TaskWasNotSuccessful(message)
            self.logger.info(f"Post-check OK for {task_name}: {message}")

    def execute_task(self, task):
        self.logger.info(f"Running task {task['name']}.")
        self.task_attribution[task["name"]]()

    def get_tasks(self):
        return sorted(self.task_attribution.keys())
