"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``benchmark/workloads/<name>.json``: its configuration
(``benchmark/configs/<config>.json``, with the render), its traffic
(``benchmark/traffic/<traffic>.json``, which names the driver in
``benchmark/drivers/``), the chips it needs and the limits of its
correctness numbers. The metrics are those of ``BENCHMARK.json`` that
name the cell; a per-layer metric is read by
``benchmark/metrics/<metric name>.py``. A later cell, configuration,
traffic or metric is a file of its own, found here by its name.

A run builds the scene from the seed, warms up, measures for at least
``--seconds`` (whole units of work: the window ends with the last one),
reads the peak memory, frees the program's state, judges a sample of the
window's answers against the plain reference, and prints one JSON line;
with ``--trace 1`` the first units of the window run under
``torch.profiler`` and the line carries the per-layer metrics instead of
the end-to-end ones.

A cell of N > 1 cards runs as N ranks, one a card (``benchmark/ranks.py``):
the process started becomes the launcher, every rank runs the set-up and
the same units until rank 0 says the window is over, rank 0 alone traces,
judges and prints the line (``device.count`` N, the fullest card's peak),
and the launcher prints it as its own.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lightcurver_tpu")
# the program's hand-written kernels, whose launches a traced run prints
KERNELS = ("k2_forward_rows", "k2_backward_slab", "sum_middle",
           "starlet_bands")


def load_json(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_metric(name):
    """The reader of per-layer metric ``name``:
    ``benchmark/metrics/<name>.py``, whose ``read(summary, shapes)``
    returns the value or None when its window holds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loaded_forbidden():
    """Top-level names of the JAX stack in ``sys.modules``, compared
    whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def benchmark_metrics(workload, trace):
    """The metrics of ``BENCHMARK.json`` that the cell reports in a run
    with ``trace``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def run_cell(workload, seed, seconds, trace, *, device="cuda", cell=None,
             config=None, traffic=None, judge="program", record=None,
             world=None, t_start=T_START):
    """One run of a cell; returns the result line's dict, with ``checks``
    last. ``cell``, ``config`` and ``traffic`` default to the files of
    ``workload``; tests pass smaller ones. ``judge="control"`` puts the
    control (the reference in TF32) in the program's place: its answers
    are judged, and the run has to come out not correct. Each answer's
    readings (both sides' numbers) are appended to ``record`` if given.

    ``world``: this rank's ``ranks.World`` in a cell of several cards.
    Every rank sets up and runs the window's units until rank 0 says it is
    over; rank 0 alone traces, judges and returns the line, the others
    return None. ``t_start``: where ``setup_s`` counts from."""
    import torch

    from benchmark.tracewindow import Tracer

    cell = cell or load_json("workloads", workload)
    config = config or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    driver = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}").Driver(
            cell, config, traffic, seed, device)
    driver.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    if world is not None:
        world.barrier()
    setup_s = time.time() - t_start
    lead = world is None or world.rank == 0
    tracer = Tracer(traffic["trace_units"]) if trace and lead else None
    if world is None:
        units, window_s = driver.window(seconds, tracer)
    else:
        units, window_s = driver.window(seconds, tracer, world.agree)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
    forbidden = loaded_forbidden()
    if forbidden:
        raise SystemExit(f"the JAX stack was loaded: {forbidden}")
    if world is not None:
        counts, peaks = zip(*world.gather((units, int(peak))))
        if lead:
            print(f"ranks' units {list(counts)}, peak bytes {list(peaks)}",
                  file=sys.stderr)
        if len(set(counts)) != 1:
            raise SystemExit(f"the ranks ran different numbers of units: "
                             f"{list(counts)}")
        peak = max(peaks)
        if not lead:
            return None
    precision = {"program": "float64", "control": "tf32"}[judge]
    numbers = {}   # the worst of each number over the answers judged
    for index in driver.sample():
        readings = driver.readings(index, precision)
        if record is not None:
            record.append(readings)
        for name, value in readings[judge].items():
            numbers[name] = max(numbers.get(name, value), value)
    limits = cell["limits"]
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    unit = {m["name"]: m["unit"] for m in benchmark_metrics(workload, trace)}
    if not trace:
        values = {"setup_s": setup_s}
        name = traffic["metric"]
        values[name] = window_s / units if traffic["rate"] == "s_per_unit" \
            else units / window_s
        metrics = {k: {"value": values[k], "unit": unit[k]}
                   for k in unit if k in values}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1 if world is None else world.size,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        summary = tracer.summary
        shapes = driver.trace_shapes()
        for name in unit:
            value = load_metric(name).read(summary, shapes)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit[name]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        ops = sorted(summary.ops.items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[name, seconds] for name, (_, seconds) in ops],
            "idle_gaps": summary.gaps[:10]}
        kernels = {k: summary.kernels(k) for k in KERNELS}
        print(f"trace: reduced in {tracer.reduce_s:.3f} s; counters "
              f"{summary.counters}; kernels (launches, seconds) "
              f"{json.dumps(kernels)}", file=sys.stderr)
    result["checks"] = checks
    return result


def report(result):
    """Print a run's checks on standard error, last, and its line."""
    forbidden = loaded_forbidden()
    if forbidden:
        sys.exit(f"the JAX stack was loaded: {forbidden}")
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)


def run_ranked(workload, seed, seconds, trace, **kwargs):
    """This rank's part of a cell of several cards: ``run_cell`` in the
    world, rank 0's report, and the teardown. An exception leaves without
    the teardown: the launcher ends the other ranks."""
    from benchmark.ranks import World, launcher_start

    world = World()
    cell = kwargs.get("cell") or load_json("workloads", workload)
    if world.size != int(cell["chips"]):
        sys.exit(f"{workload} asks for {cell['chips']} ranks; the world "
                 f"has {world.size}")
    result = run_cell(workload, seed, seconds, trace, world=world,
                      t_start=launcher_start(), **kwargs)
    if result is not None:
        report(result)
    world.close()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # the checkout's root, in place of this folder: the benchmark's
    # modules are imported as the package ``benchmark``
    sys.path[0] = str(ROOT)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    import torch

    from benchmark import ranks

    cell = load_json("workloads", args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.exit(f"{args.workload} needs {chips} CUDA card(s); "
                 f"{torch.cuda.device_count()} visible")
    run = (args.workload, args.seed, args.seconds, bool(args.trace))
    if chips == 1:
        report(run_cell(*run, cell=cell))
    elif ranks.launched():
        run_ranked(*run, cell=cell)
    else:
        code, out = ranks.launch(chips, [__file__, *argv], t_start=T_START)
        forbidden = loaded_forbidden()
        if code or forbidden:
            sys.exit(code or f"the JAX stack was loaded: {forbidden}")
        sys.stdout.write(out)


if __name__ == "__main__":
    main()
