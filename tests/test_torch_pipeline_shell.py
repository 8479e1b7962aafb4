"""The port's pipeline shell against JAX's on the same inputs: the DAG and
the example config it reads, the config key check, the plate-solving
strategy, the step range of ``run``, the device and render that reach the
numerical tasks, the session log, and the CLI (``scripts/run.py``,
``scripts/initialize.py``).

The managers are built on a config made from the example config with a
temporary workdir; no task runs unless a test says so (the tasks are
replaced by recorders where one is dispatched).
"""

import logging
import os
import sys
from pathlib import Path

import pytest
import yaml

import lightcurver_tpu_torch.pipeline.workflow_manager as twm

REPO = Path(__file__).resolve().parents[1]
JAX_PIPELINE = REPO / "lightcurver_tpu" / "pipeline"
PORT_PIPELINE = REPO / "lightcurver_tpu_torch" / "pipeline"
TEMPLATE = Path("example_config_file") / "config.yaml"
DAG = "pipeline_dependency_graph.yaml"
# each task's function in the port's manager module, in the DAG's order
TASK_FUNCTIONS = {
    "initialize_database": "initialize_database",
    "read_convert_skysub_character_catalog":
        "read_convert_skysub_character_catalog",
    "plate_solving": "plate_solve_all_frames",
    "calculate_common_and_total_footprint":
        "calc_common_and_total_footprint_and_save",
    "query_gaia_for_stars": "query_gaia_stars",
    "stamp_extraction": "extract_all_stamps",
    "psf_modeling": "model_all_psfs",
    "star_photometry": "do_star_photometry",
    "calculate_normalization_coefficient": "calculate_coefficient",
    "calculate_absolute_zeropoints": "calculate_zeropoints",
    "prepare_calibrated_cutouts": "prepare_roi_file",
    "model_calibrated_cutouts": "do_modelling_of_roi",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_session_log_left():
    """Close the session FileHandler that a manager opens, after each
    test."""
    yield
    base = logging.getLogger("lightcurver")
    for handler in [h for h in base.handlers
                    if isinstance(h, logging.FileHandler)]:
        base.removeHandler(handler)
        handler.close()


def _write_config(tmp_path, **overrides):
    """The example config with its workdir in ``tmp_path``."""
    config = yaml.safe_load((PORT_PIPELINE / TEMPLATE).read_text())
    config.update(workdir=str(tmp_path / "work"),
                  raw_dirs=[str(tmp_path / "raw")], **overrides)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.dump(config))
    return path


@pytest.fixture()
def config(tmp_path, monkeypatch):
    path = _write_config(tmp_path)
    monkeypatch.setenv("LIGHTCURVER_CONFIG", str(path))
    monkeypatch.delenv("LIGHTCURVER_RELAX_CONFIG_CHECK", raising=False)
    return path


def _edit(path, drop=(), **values):
    cfg = yaml.safe_load(path.read_text())
    for key in drop:
        cfg.pop(key)
    cfg.update(values)
    path.write_text(yaml.dump(cfg))


def _jax_manager_module():
    import lightcurver_tpu.pipeline.workflow_manager as jwm

    return jwm


def _raised(fn):
    """(exception type, message) of what ``fn()`` raised."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


# ---------------------------------------------------------------------------
# the copies the shell reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [DAG, str(TEMPLATE)])
def test_yaml_copy_parses_as_the_jax_one(name):
    port = yaml.safe_load((PORT_PIPELINE / name).read_text())
    jax = yaml.safe_load((JAX_PIPELINE / name).read_text())
    assert port == jax


def test_key_diff_matches_jax(config):
    from lightcurver_tpu.structure.user_config import \
        compare_config_with_pipeline_delivered_one as jax_diff

    from lightcurver_tpu_torch.structure.user_config import \
        compare_config_with_pipeline_delivered_one as port_diff

    _edit(config, drop=("psf_do_plots", "ROI_size"), not_a_key=3)
    got, want = port_diff(), jax_diff()
    assert got == want
    assert got["extra_keys_in_user_config"] == {"not_a_key"}
    assert got["extra_keys_in_pipeline_config"] == {"psf_do_plots",
                                                    "ROI_size"}


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_key_check_raises_as_jax(config, change):
    if change == "missing":
        _edit(config, drop=("stamp_size_stars", "psf_n_iter_pixels"))
    else:
        _edit(config, definitely_a_typoed_key=1)
    got = _raised(twm._validate_config_keys)
    assert got == _raised(_jax_manager_module()._validate_config_keys)
    assert got[0] is RuntimeError
    # the whole manager refuses the config before anything else
    assert _raised(lambda: twm.WorkflowManager(device="cpu")) == got


@pytest.mark.parametrize("value", ["0", "1", "true", "yes"])
def test_relax_config_check_as_jax(config, monkeypatch, capsys, value):
    _edit(config, definitely_a_typoed_key=1)
    monkeypatch.setenv("LIGHTCURVER_RELAX_CONFIG_CHECK", value)
    outcomes = []
    for validate in (twm._validate_config_keys,
                     _jax_manager_module()._validate_config_keys):
        try:
            validate()
            outcomes.append(("relaxed", capsys.readouterr().out))
        except RuntimeError as e:
            outcomes.append(("strict", str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("strict" if value == "0" else "relaxed")


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy, function", [
    ("plate_solve", "plate_solve_all_frames"),
    ("alternate_gaia_solve", "alternate_plate_solve_gaia"),
    ("adapt_wcs_from_reference", "alternate_plate_solve_adapt_ref")])
def test_plate_solving_strategy_dispatch(config, strategy, function):
    _edit(config, plate_solving_strategy=strategy)
    port = twm.WorkflowManager(device="cpu")
    jax = _jax_manager_module().WorkflowManager()
    solver = port.task_attribution["plate_solving"]
    assert solver is getattr(twm, function)
    assert solver.__module__.startswith("lightcurver_tpu_torch.")
    assert jax.task_attribution["plate_solving"].__name__ == function
    assert port.post_task_attribution["plate_solving"].__module__ == \
        "lightcurver_tpu_torch.pipeline.state_checkers"
    assert port.get_tasks() == jax.get_tasks()


def test_unknown_plate_solving_strategy_as_jax(config):
    _edit(config, plate_solving_strategy="ask_a_friend")
    got = _raised(lambda: twm.WorkflowManager(device="cpu"))
    assert got == _raised(_jax_manager_module().WorkflowManager)
    assert got[0] is AssertionError


@pytest.mark.parametrize("steps", [
    {"start_step": "not_a_step"}, {"stop_step": "plate_soving"},
    {"start_step": "star_photometry", "stop_step": "psf_modeling"}])
def test_bad_step_range_as_jax(config, steps):
    port = twm.WorkflowManager(device="cpu")
    jax = _jax_manager_module().WorkflowManager()
    got = _raised(lambda: port.run(**steps))
    assert got == _raised(lambda: jax.run(**steps))
    assert got[0] is ValueError
    assert port.topological_sort() == jax.topological_sort()


def _recorders(monkeypatch):
    """Every task of the port's manager replaced by a recorder of its
    call: [(function name, args, kwargs)]."""
    calls = []
    for name in TASK_FUNCTIONS.values():
        def record(*args, _name=name, **kwargs):
            calls.append((_name, args, kwargs))
        monkeypatch.setattr(twm, name, record)
    monkeypatch.setattr(twm, "check_plate_solving", lambda: (True, "ok"))
    return calls


@pytest.mark.parametrize("kwargs, want", [
    ({}, {"device": "cuda", "irfft_backend": "fft"}),
    ({"device": "cpu", "irfft_backend": "matmul"},
     {"device": "cpu", "irfft_backend": "matmul"})])
def test_device_and_render_reach_the_numerical_tasks(config, monkeypatch,
                                                     kwargs, want):
    calls = _recorders(monkeypatch)
    if "device" not in kwargs:  # the default card, on a host without one
        monkeypatch.setattr(twm.torch.cuda, "is_available", lambda: True)
    manager = twm.WorkflowManager(**kwargs)
    manager.run()
    assert [c[0] for c in calls] == [
        TASK_FUNCTIONS[t] for t in manager.topological_sort()]
    for name, args, got in calls:
        assert args == ()
        if name == "prepare_roi_file":
            assert got == {"device": want["device"]}
        elif name in ("model_all_psfs", "do_star_photometry",
                      "do_modelling_of_roi"):
            assert got == want
        else:
            assert got == {}, name


def test_cuda_without_a_card_raises_before_any_task(config, monkeypatch):
    calls = _recorders(monkeypatch)
    monkeypatch.setattr(twm.torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"device": "cuda:0"}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            twm.WorkflowManager(**kwargs).run()
    assert calls == []
    assert not (config.parent / "work" / "logs").exists()


def test_two_managers_leave_one_file_handler(config):
    """JAX's manager, then the port's twice: one session log open."""
    _jax_manager_module().WorkflowManager()
    twm.WorkflowManager(device="cpu")
    twm.WorkflowManager(device="cpu")
    handlers = [h for h in logging.getLogger("lightcurver").handlers
                if isinstance(h, logging.FileHandler)]
    assert len(handlers) == 1
    assert Path(handlers[0].baseFilename).parent == \
        config.parent / "work" / "logs"


def test_manager_logs_into_the_session_file(config):
    manager = twm.WorkflowManager(device="cpu")
    assert manager.logger.name == "lightcurver.workflow_manager"
    manager.logger.info("a line for the session log")
    (handler,) = [h for h in logging.getLogger("lightcurver").handlers
                  if isinstance(h, logging.FileHandler)]
    handler.flush()
    assert "a line for the session log" in \
        Path(handler.baseFilename).read_text()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv, want", [
    (["--start", "psf_modeling", "--stop", "star_photometry"],
     {"start": "psf_modeling", "stop": "star_photometry", "device": "cuda",
      "irfft_backend": "fft"}),
    (["--stop", "query_gaia_for_stars", "--device", "cpu",
      "--irfft-backend", "matmul"],
     {"start": None, "stop": "query_gaia_for_stars", "device": "cpu",
      "irfft_backend": "matmul"})])
def test_run_sets_the_env_and_forwards_the_arguments(tmp_path, monkeypatch,
                                                     argv, want):
    from lightcurver_tpu_torch.scripts.run import run

    calls = {}

    class FakeManager:
        def __init__(self, *, device, irfft_backend):
            calls.update(device=device, irfft_backend=irfft_backend)

        def run(self, start_step=None, stop_step=None):
            calls.update(start=start_step, stop=stop_step)

    monkeypatch.setattr(twm, "WorkflowManager", FakeManager)
    monkeypatch.delenv("LIGHTCURVER_CONFIG", raising=False)
    config = tmp_path / "config.yaml"
    config.write_text("{}")
    monkeypatch.setattr(sys, "argv", ["run", str(config), *argv])
    run()
    assert os.environ["LIGHTCURVER_CONFIG"] == str(config)
    assert calls == want


def test_run_lists_the_steps_in_its_help(monkeypatch, capsys):
    from lightcurver_tpu_torch.scripts.run import run

    monkeypatch.setattr(sys, "argv", ["run", "--help"])
    with pytest.raises(SystemExit):
        run()
    out = capsys.readouterr().out
    tasks = yaml.safe_load((PORT_PIPELINE / DAG).read_text())["tasks"]
    for task in tasks:
        assert f"- {task['name']}" in out
    assert "--device" in out and "--irfft-backend" in out


@pytest.mark.parametrize("name", ["J0248", "NO", "2023", "M31 #field"])
def test_initialize_writes_what_jax_writes(tmp_path, monkeypatch, name):
    """The config and the header-parser stub, byte for byte, for the same
    answers in the same directory (names YAML would mis-parse unquoted
    included)."""
    from lightcurver_tpu.scripts.initialize import initialize as jax_init

    from lightcurver_tpu_torch.scripts.initialize import initialize

    workdir = tmp_path / "work"
    files = ("config.yaml", "header_parser/parse_header.py")
    written = []
    for init in (jax_init, initialize):
        monkeypatch.setattr(sys, "argv", [
            "init", "--workdir", str(workdir), "--roi_name", name,
            "--roi_ra", "42.2031", "--roi_dec", "19.22528",
            "--photom_band", "r_sdss"])
        init()
        written.append([(workdir / f).read_bytes() for f in files])
        for f in files:
            (workdir / f).unlink()
    assert written[0] == written[1]
    config = yaml.safe_load(written[1][0])
    assert config["ROI"] == {name: {"coordinates": [42.2031, 19.22528]}}
