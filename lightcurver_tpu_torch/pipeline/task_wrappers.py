"""Task wrappers, the pending-work discovery and the host multiprocessing
fan-out: a copy of ``lightcurver_tpu/pipeline/task_wrappers.py``.

The per-frame host tasks (importation, plate solving, re-extraction) run
in a multiprocessing Pool with queue-based logging. SQLite writes from
workers are safe through WAL and busy timeouts
(``structure/database.py``). One failed job is logged and skipped; every
job failing raises ``TaskWasNotSuccessful``.
"""

import functools
import json
import logging
import logging.handlers
import os
from multiprocessing import Pool, Manager
from pathlib import Path

import numpy as np

from ..structure.user_config import get_user_config
from ..structure.database import get_pandas, execute_sqlite_query
from ..processes.frame_importation import process_new_frame
from ..processes.plate_solving import (
    solve_one_image_and_update_database, select_frames_needing_plate_solving)
from ..utilities.footprint import (
    calc_common_and_total_footprint, get_frames_hash,
    save_combined_footprints_to_db, identify_and_eliminate_bad_pointings)
from ..processes.star_extraction import extract_sources_from_sky_sub_image


class _RelayHandler(logging.Handler):
    """Re-dispatch a queued worker record through the parent's live
    logging hierarchy (the record's own logger, so level filtering and
    propagation apply normally)."""

    def emit(self, record):
        logging.getLogger(record.name).handle(record)


def worker_init(log_queue):
    """Route ALL worker logging through the queue.

    Workers log to ``Process-{pid}`` (log_process) and ``lightcurver.*``
    (the process modules), so the QueueHandler goes on the ROOT logger
    and the fork-inherited handlers are dropped — otherwise many
    processes append to the same session-file descriptor directly (and
    under the 'spawn' start method worker logs would be lost entirely).
    """
    root = logging.getLogger()
    for lg in (root, logging.getLogger("lightcurver")):
        lg.handlers = []
    root.setLevel(logging.INFO)
    root.addHandler(logging.handlers.QueueHandler(log_queue))


def log_process(func):
    """Log the frame identifier (last arg) then call func without it."""
    @functools.wraps(func)
    def wrapper(args):
        logger = logging.getLogger(f"Process-{os.getpid()}")
        logger.info(f"{func.__name__} .... processing item {args[-1]}")
        return func(*args[:-1])
    return wrapper


def _guarded(worker, job):
    """Run one job, containing its failure to that job.

    One corrupt frame (truncated FITS, unreadable header) must not
    abort the import/solve of every other frame in the batch: the
    failure is logged, the job is skipped, and — since the frame never
    reaches the DB — a later run retries it.
    """
    ident = job[-1] if isinstance(job, tuple) else job
    try:
        worker(job)
        return None
    except Exception as e:  # noqa: BLE001 — per-job isolation
        logging.getLogger("lightcurver.task_wrappers").exception(
            f"job {ident!r} failed: {e}")
        return (ident, f"{type(e).__name__}: {e}")


def _pool_run(worker, jobs):
    """Run jobs in a Pool with queue logging; serial for 1 process.

    Per-job failures are contained (see :func:`_guarded`); the task
    completes the surviving jobs and logs a summary of the failures.
    """
    logger = logging.getLogger("lightcurver.task_wrappers")
    user_config = get_user_config()
    n_proc = int(user_config.get("multiprocessing_cpu_count", 1) or 1)
    if n_proc <= 1 or len(jobs) <= 1:
        failures = [f for f in (_guarded(worker, job) for job in jobs)
                    if f is not None]
    else:
        log_queue = Manager().Queue()
        # a RELAY handler, not a snapshot of 'lightcurver'.handlers:
        # with a custom WorkflowManager logger (setup_base_logger never
        # ran) the snapshot is EMPTY and every worker record — incl.
        # per-frame failure tracebacks — would silently vanish.  The
        # relay re-dispatches each record through the live hierarchy,
        # honoring whatever handlers exist at consume time.
        listener = logging.handlers.QueueListener(log_queue,
                                                  _RelayHandler())
        listener.start()
        try:
            with Pool(processes=n_proc, initializer=worker_init,
                      initargs=(log_queue,)) as pool:
                failures = [f for f in pool.map(
                    functools.partial(_guarded, worker), jobs)
                    if f is not None]
        finally:
            listener.stop()
    if failures:
        summary = ("; ".join(f"{i!r} ({m})" for i, m in failures[:10])
                   + (" ..." if len(failures) > 10 else ""))
        if len(failures) == len(jobs):
            # EVERY job failing is a systematic error (missing binary,
            # unreadable raw_dirs, ...), not per-frame data trouble —
            # containment must not let the pipeline march on vacuously
            from ..structure.exceptions import TaskWasNotSuccessful

            raise TaskWasNotSuccessful(
                f"all {len(jobs)} jobs of this task failed — systematic "
                f"error, not bad frames: {summary}")
        logger.warning(
            f"{len(failures)}/{len(jobs)} jobs failed and were "
            f"skipped: {summary}")


@log_process
def process_new_frame_wrapper(*args):
    process_new_frame(*args)


def read_convert_skysub_character_catalog():
    """Import every raw frame not yet in the DB (anti-join on file stem)."""
    logger = logging.getLogger("lightcurver.importation")
    user_config = get_user_config()
    pattern = user_config.get("files_match_pattern", "*")
    available = sorted(sum(
        (list(raw_dir.glob(pattern)) for raw_dir in user_config["raw_dirs"]),
        start=[]))
    imported = get_pandas(columns=["original_image_path", "id"])
    if not imported.empty:
        imported_stems = {Path(p).stem
                          for p in imported["original_image_path"]}
    else:
        imported_stems = set()
    new_frames = [f for f in available if f.stem not in imported_stems]
    # the calibrated frame path is frames/<STEM>.fits, so the anti-join
    # and the dedup both key on the file STEM (not the name): 'a.fit'
    # and 'a.fits' are distinct names but would race writing the same
    # calibrated file and silently corrupt an epoch; keep the first,
    # refuse the rest LOUDLY
    seen_stems = {}
    deduped = []
    for f in new_frames:
        if f.stem in seen_stems:
            logger.error(
                f"Duplicate raw file stem {f.stem!r}: keeping "
                f"{seen_stems[f.stem]}, SKIPPING {f}. Rename one of "
                "them to import both.")
        else:
            seen_stems[f.stem] = f
            deduped.append(f)
    new_frames = deduped
    logger.info(f"Importing {len(new_frames)} new frames from "
                f"{user_config['raw_dirs']}.")
    _pool_run(process_new_frame_wrapper,
              [(frame, user_config, frame.name) for frame in new_frames])


@log_process
def solve_one_image_and_update_database_wrapper(*args):
    solve_one_image_and_update_database(*args)


def plate_solve_all_frames():
    """Plate-solve every frame selected by the config strategy."""
    logger = logging.getLogger("lightcurver.plate_solving")
    user_config = get_user_config()
    workdir = Path(user_config["workdir"])
    frames = select_frames_needing_plate_solving(user_config, logger)
    logger.info(f"Ready to plate solve {len(frames)} frames.")
    _pool_run(solve_one_image_and_update_database_wrapper, [
        (workdir / row["image_relpath"], workdir / row["sources_relpath"],
         user_config, row["id"], row["id"])
        for _, row in frames.iterrows()])


def calc_common_and_total_footprint_and_save():
    """Combine footprints (if not already done for this frame set)."""
    logger = logging.getLogger(
        "lightcurver.combined_footprint_calculation")
    identify_and_eliminate_bad_pointings()
    # the frame set MUST match what every downstream task hashes
    # (plate_solved + not eliminated + ROI in footprint): one unsolved
    # but tolerated frame would otherwise desynchronize the footprint
    # hashes, and downstream tasks would find zero stars
    rows = execute_sqlite_query(
        """SELECT frames.id, footprints.polygon FROM footprints
           JOIN frames ON footprints.frame_id = frames.id
           WHERE frames.eliminated != 1 AND frames.plate_solved = 1
             AND frames.roi_in_footprint = 1""")
    frames_hash = get_frames_hash([r[0] for r in rows])
    count = execute_sqlite_query(
        "SELECT COUNT(*) FROM combined_footprint WHERE hash = ?",
        params=(frames_hash,))[0][0]
    if count > 0:
        logger.info(f"Footprint {frames_hash} already calculated.")
        return
    polygons = [np.array(json.loads(r[1])) for r in rows]
    common, largest = calc_common_and_total_footprint(polygons)

    user_config = get_user_config()
    try:
        from ..plotting.footprint_plotting import plot_footprints

        plot_path = user_config["plots_dir"] / "footprints.jpg"
        plot_footprints(polygons, common, largest, save_path=plot_path)
        logger.info(f"Footprint plot saved at {plot_path}.")
    except Exception as e:
        logger.warning(f"Footprint plot failed: {e}")
    save_combined_footprints_to_db(frames_hash, common, largest)
    logger.info(f"Combined footprint {frames_hash} saved to DB.")


@log_process
def extract_sources_from_sky_sub_image_wrapper(*args):
    extract_sources_from_sky_sub_image(*args)


def source_extract_all_images(conditions=None):
    """Manual utility: re-extract sources of (a subset of) frames."""
    logger = logging.getLogger("lightcurver.source_extraction")
    user_config = get_user_config()
    workdir = Path(user_config["workdir"])
    frames = get_pandas(
        columns=["id", "image_relpath", "sources_relpath", "exptime",
                 "background_rms_electron_per_second"],
        conditions=conditions)
    logger.info(f"Extracting sources from {len(frames)} frames.")
    _pool_run(extract_sources_from_sky_sub_image_wrapper, [
        (workdir / row["image_relpath"], workdir / row["sources_relpath"],
         user_config["source_extraction_threshold"],
         user_config["source_extraction_min_area"],
         row["exptime"], row["background_rms_electron_per_second"],
         user_config["plots_dir"] / "source_extraction"
         / f"{Path(row['image_relpath']).stem}.jpg",
         row["id"]) for _, row in frames.iterrows()])
