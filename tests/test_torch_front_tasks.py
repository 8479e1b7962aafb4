"""Port parity for the front of the pipeline: the DB schema, frame import,
plate solving (the three strategies), the footprints, the Gaia star query
and stamp extraction.

One module-scoped fixture takes ``tests/test_e2e_pipeline.py``'s synthetic
scene (3 frames of 160 px, 8 stars, the Gaia fixture,
``already_plate_solved: 1``) through JAX's six front tasks, one
``WorkflowManager.run`` step at a time, and copies the workdir (database,
frames, sources, regions HDF5, config pointed at the copy) before the first
and after each one. Each port task then runs on a copy of the snapshot
before it and must give JAX's workdir after it: every table of the
database, the calibrated frames (data and header cards), the sources
CSVs and every dataset of ``regions.h5``. Integers, strings and stored
arrays are held equal to the bit, floats to a relative 1e-12 (the same
numpy code on the same inputs). A rerun of each port task changes
nothing, and the port's chain from the empty workdir, on its own
``initialize_database``, gives JAX's workdir after ``stamp_extraction``.

JAX's front runs its host C++ when it can build it; its own tests hold
that code to the numpy twins the port copies, so here it runs with the
C++ off, on those twins.

The adapt-WCS fault of ``tests/test_e2e_pipeline.py``, the Gaia-matched
solver on the scene of ``tests/test_gaia_plate_solve_e2e.py`` and the
astrometry.net wrappers of ``tests/test_plate_solving.py`` (a fake
``solve-field`` on PATH, a fake nova.astrometry.net on localhost) are held
to their JAX tests' bars and to JAX's results on the same inputs.
"""

import json
import os
import shutil
import sqlite3
import stat
import textwrap
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest
import yaml

from test_e2e_pipeline import (EXPTIME, FRAME_DITHER_PX, GAIN, N_FRAMES,
                               ROI_DEC, ROI_RA, SKY_E_PER_S, STAR_FLUXES_E_S,
                               STAR_OFFSETS, _make_wcs, _render_frame,
                               workdir)  # noqa: F401  (the scene fixture)
from test_gaia_plate_solve_e2e import DITHERS

from lightcurver_tpu_torch.io.fits import Header, read_fits, write_fits
from lightcurver_tpu_torch.io.wcs import TanWCS
from lightcurver_tpu_torch.pipeline import state_checkers as tcheck
from lightcurver_tpu_torch.pipeline import task_wrappers as twrap
from lightcurver_tpu_torch.processes import (
    alternate_plate_solving_adapt_existing_wcs as tadapt,
    alternate_plate_solving_with_gaia as tgaia, cutout_making as tcut,
    plate_solving as tsolve, star_querying as tquery)
from lightcurver_tpu_torch.processes.star_extraction import write_sources
from lightcurver_tpu_torch.structure import database as tdb

RTOL = 1e-12
MAX_PX = 0.3  # the JAX tests' bar on a re-solved frame's ROI position

FRONT = ["initialize_database", "read_convert_skysub_character_catalog",
         "plate_solving", "calculate_common_and_total_footprint",
         "query_gaia_for_stars", "stamp_extraction"]


def _port_plate_solving():
    """The port's plate-solving task and its post-check."""
    twrap.plate_solve_all_frames()
    ok, message = tcheck.check_plate_solving()
    assert ok, message


PORT_TASKS = dict(zip(FRONT, (
    tdb.initialize_database, twrap.read_convert_skysub_character_catalog,
    _port_plate_solving, twrap.calc_common_and_total_footprint_and_save,
    tquery.query_gaia_stars, tcut.extract_all_stamps)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_on_numpy_twins():
    """Both packages' background, extraction and cosmics on their numpy
    twins: the C++ libraries off, and both load caches reset for this
    module only."""
    import lightcurver_tpu.native as nat
    import lightcurver_tpu_torch.native as port_nat

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTCURVER_DISABLE_NATIVE", "1")
        for module in (nat, port_nat):
            mp.setattr(module, "_lib", None)
            mp.setattr(module, "_tried", False)
        yield


@contextmanager
def _config(path):
    old = os.environ.get("LIGHTCURVER_CONFIG")
    os.environ["LIGHTCURVER_CONFIG"] = str(path / "config.yaml")
    try:
        yield
    finally:
        if old is not None:
            os.environ["LIGHTCURVER_CONFIG"] = old
        else:
            os.environ.pop("LIGHTCURVER_CONFIG", None)


def _copy(src, dst, **config):
    """A copy of a workdir whose config names the copy (and ``config``'s
    overrides)."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("snap_*",
                                                            "port_*",
                                                            "jax_*"))
    cfg = yaml.safe_load((dst / "config.yaml").read_text())
    cfg.update(workdir=str(dst), **config)
    (dst / "config.yaml").write_text(yaml.dump(cfg))
    return dst


# ---------------------------------------------------------------------------
# workdir comparison
# ---------------------------------------------------------------------------

def _same_value(got, want, what):
    if isinstance(want, float) and isinstance(got, float):
        if np.isnan(want):
            assert np.isnan(got), what
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), what
    else:
        assert type(got) is type(want) and got == want, what


def _same_frame(got, want, what):
    """DataFrames: the same columns and dtypes; floats to RTOL, the rest
    equal."""
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for col in want.columns:
        g, w = got[col], want[col]
        assert g.dtype == w.dtype, f"{what}.{col}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0,
                                       err_msg=f"{what}.{col}")
        else:
            assert g.tolist() == w.tolist(), f"{what}.{col}"


def _tables(path):
    with sqlite3.connect(path / "database.sqlite3") as conn:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' "
            "ORDER BY name")]
        return {name: pd.read_sql_query(
            f"SELECT * FROM {name} ORDER BY rowid", conn) for name in names}


def _h5(path):
    import h5py

    out = {}
    if not path.exists():
        return out
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_workdir(mine, ref):
    """The database, calibrated frames, sources and regions of two
    workdirs agree (see the module docstring for the bars)."""
    got_tables, want_tables = _tables(mine), _tables(ref)
    assert got_tables.keys() == want_tables.keys()
    for name, want in want_tables.items():
        _same_frame(got_tables[name], want, name)

    def files(path, pattern):
        return sorted(p.relative_to(path) for p in path.glob(pattern))

    assert files(mine, "frames/*") == files(ref, "frames/*")
    for rel in files(ref, "frames/*.fits"):
        data, header = read_fits(mine / rel)
        want_data, want_header = read_fits(ref / rel)
        assert data.dtype == want_data.dtype
        np.testing.assert_array_equal(data, want_data, err_msg=str(rel))
        got_cards, want_cards = header.cards(), want_header.cards()
        assert len(got_cards) == len(want_cards), rel
        for g, w in zip(got_cards, want_cards):
            assert g[0] == w[0] and g[2] == w[2], (rel, g, w)
            _same_value(g[1], w[1], f"{rel}:{w[0]}")
    for rel in files(ref, "frames/*.csv"):
        _same_frame(pd.read_csv(mine / rel), pd.read_csv(ref / rel),
                    str(rel))

    got, want = _h5(mine / "regions.h5"), _h5(ref / "regions.h5")
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, bytes):  # a stamp's WCS cards, as JSON
            g, w = json.loads(got[key]), json.loads(value)
            assert g.keys() == w.keys(), key
            for card in w:
                _same_value(g[card], w[card], f"{key}:{card}")
        else:
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def _file_stamps(path):
    """(mtime, size) of the calibrated frames and sources: a rerun writes
    none. (The stamp task opens ``regions.h5`` for appending, which moves
    its mtime; its content is compared.)"""
    return {p: (p.stat().st_mtime_ns, p.stat().st_size)
            for p in path.glob("frames/*")}


# ---------------------------------------------------------------------------
# the e2e scene through JAX's front, one task at a time
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshots(workdir):  # noqa: F811
    """{'start': the empty workdir, task: the workdir after JAX's task}."""
    from lightcurver_tpu.pipeline.workflow_manager import WorkflowManager

    snaps = {"start": _copy(workdir, workdir / "snap_start")}
    with _config(workdir):
        manager = WorkflowManager()
        for name in FRONT:
            manager.run(start_step=name, stop_step=name)
            snaps[name] = _copy(workdir, workdir / f"snap_{name}")
    return snaps


@pytest.mark.parametrize("name", FRONT)
def test_port_task_matches_jax_and_reruns_idle(snapshots, name):
    index = FRONT.index(name)
    before = snapshots[FRONT[index - 1] if index else "start"]
    mine = _copy(before, before.parent / f"port_{name}")
    with _config(mine):
        PORT_TASKS[name]()
    _assert_same_workdir(mine, snapshots[name])
    stamps = _file_stamps(mine)
    with _config(mine):
        PORT_TASKS[name]()
    _assert_same_workdir(mine, snapshots[name])
    assert _file_stamps(mine) == stamps


def test_port_chain_from_the_empty_workdir_matches_jax(snapshots):
    """The port's six tasks, from its own schema to the stamps, against
    JAX's ``WorkflowManager`` run to ``stamp_extraction``."""
    mine = _copy(snapshots["start"], snapshots["start"].parent / "port_chain")
    with _config(mine):
        for name in FRONT:
            PORT_TASKS[name]()
    _assert_same_workdir(mine, snapshots["stamp_extraction"])
    frames = _tables(mine)["frames"]
    assert len(frames) == N_FRAMES
    assert (frames["plate_solved"] == 1).all()
    assert (frames["roi_in_footprint"] == 1).all()
    assert len(_tables(mine)["stars"]) == len(STAR_OFFSETS)


@pytest.mark.parametrize("strategy", ["common_footprint_stars",
                                      "stars_per_frame"])
def test_star_query_strategies_match_jax(snapshots, strategy):
    """The two footprint-polygon selections, which the scene's
    ``ROI_disk`` does not take, against JAX's on the same snapshot."""
    from lightcurver_tpu.processes.star_querying import \
        query_gaia_stars as jax_query

    snap = snapshots["calculate_common_and_total_footprint"]
    runs = {}
    for who, task in (("port", tquery.query_gaia_stars), ("jax", jax_query)):
        path = runs[who] = _copy(snap, snap.parent / f"{who}_{strategy}",
                                 star_selection_strategy=strategy)
        with _config(path):
            task()
    assert len(_tables(runs["port"])["stars"]) == len(STAR_OFFSETS)
    assert len(_tables(runs["port"])["stars_in_frames"]) > 0
    _assert_same_workdir(runs["port"], runs["jax"])


def test_duplicate_raw_stems_are_imported_once(snapshots, caplog):
    """Two raw directories that both hold ``frame_00.fits``: the first is
    imported, the second refused with an error, as JAX does."""
    from lightcurver_tpu.pipeline.task_wrappers import \
        read_convert_skysub_character_catalog as jax_import

    snap = snapshots["initialize_database"]
    raw = snap.parent / "raw"
    runs = {}
    for who, task in (("port", twrap.read_convert_skysub_character_catalog),
                      ("jax", jax_import)):
        dirs = [snap.parent / f"{who}_raw_a", snap.parent / f"{who}_raw_b"]
        shutil.copytree(raw, dirs[0])
        dirs[1].mkdir()
        shutil.copy(raw / "frame_00.fits", dirs[1])
        path = runs[who] = _copy(snap, snap.parent / f"{who}_dup_stems",
                                 raw_dirs=[str(d) for d in dirs])
        with _config(path):
            task()
    assert len(_tables(runs["port"])["frames"]) == N_FRAMES
    assert sum("Duplicate raw file stem 'frame_00'" in r.message
               for r in caplog.records) == 2
    # the raw paths differ by directory name only
    for who in runs:
        frames = _tables(runs[who])["frames"]
        assert all(f"{who}_raw_a" in p for p in frames["original_image_path"])
    port, jax = _tables(runs["port"])["frames"], _tables(runs["jax"])["frames"]
    port["original_image_path"] = jax["original_image_path"]
    _same_frame(port, jax, "frames")


def test_source_reextraction_task_matches_jax(snapshots):
    """``source_extract_all_images`` on the imported frames (electrons,
    the frames' exptime), against JAX's."""
    from lightcurver_tpu.pipeline.task_wrappers import \
        source_extract_all_images as jax_task

    snap = snapshots["read_convert_skysub_character_catalog"]
    runs = {}
    for who, task in (("port", twrap.source_extract_all_images),
                      ("jax", jax_task)):
        path = runs[who] = _copy(snap, snap.parent / f"{who}_reextract")
        with _config(path):
            task(conditions=["id >= 2"])
    first = "frames/frame_00_sources.csv"
    _same_frame(pd.read_csv(runs["port"] / first), pd.read_csv(snap / first),
                "untouched")
    assert not pd.read_csv(runs["port"] / "frames/frame_01_sources.csv") \
        .equals(pd.read_csv(snap / "frames/frame_01_sources.csv"))
    _assert_same_workdir(runs["port"], runs["jax"])


def test_footprint_helpers_match_jax(snapshots):
    """The stored-footprint getters and the per-frame ROI check, which no
    task calls, against JAX's on the stamped snapshot."""
    from lightcurver_tpu.utilities import footprint as jfoot

    from lightcurver_tpu_torch.utilities import footprint as tfoot

    snap = snapshots["stamp_extraction"]
    (footprint_hash,) = _tables(snap)["combined_footprint"]["hash"]
    runs = {}
    for who, module in (("port", tfoot), ("jax", jfoot)):
        path = runs[who] = _copy(snap, snap.parent / f"{who}_footprints")
        with _config(path):
            tdb.execute_sqlite_query("UPDATE frames SET roi_in_footprint = 0",
                                     is_select=False)
            module.check_in_footprint_for_all_images()
            polygons = [module.database_get_footprint(i)
                        for i in range(1, N_FRAMES + 1)]
            stored = module.load_combined_footprint_from_db(
                int(footprint_hash))
            assert module.load_combined_footprint_from_db(-1) is None
            with pytest.raises(RuntimeError, match="no combined footprint"):
                module.load_combined_footprint_from_db(-1, missing_ok=False)
        runs[who] = (path, polygons, stored)
    (port, polygons, stored), (jax, jax_polygons, jax_stored) = \
        runs["port"], runs["jax"]
    assert (_tables(port)["frames"]["roi_in_footprint"] == 1).all()
    for got, want in zip(polygons, jax_polygons):
        np.testing.assert_array_equal(got, want)
    assert stored == jax_stored and stored is not None
    _assert_same_workdir(port, jax)


@pytest.mark.parametrize("n_proc", [1, 2])
def test_pool_run_contains_failures(snapshots, n_proc, caplog, monkeypatch):
    """One failed job is logged and skipped; every job failing raises
    ``TaskWasNotSuccessful``; serially, and through the Pool with its
    workers' records relayed to the parent. (The Pool's workers are
    spawned here, not forked: this test process runs JAX's threads.)"""
    import multiprocessing

    from lightcurver_tpu_torch.structure.exceptions import \
        TaskWasNotSuccessful

    spawn = multiprocessing.get_context("spawn")
    monkeypatch.setattr(twrap, "Pool", spawn.Pool)
    monkeypatch.setattr(twrap, "Manager", spawn.Manager)
    snap = snapshots["start"]
    path = _copy(snap, snap.parent / f"port_pool_{n_proc}",
                 multiprocessing_cpu_count=n_proc)
    with _config(path):
        twrap._pool_run(int, ["1", "x", "3"])
        assert any("1/3 jobs failed" in r.message for r in caplog.records)
        assert any("job 'x' failed" in r.message for r in caplog.records)
        with pytest.raises(TaskWasNotSuccessful, match="all 2 jobs"):
            twrap._pool_run(int, ["x", "y"])


def _schema(path):
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT type, name, tbl_name, sql FROM "
                            "sqlite_master ORDER BY name").fetchall()


@pytest.mark.parametrize("start", ["empty", "older_frames_table"])
def test_port_schema_is_jax_schema(tmp_path, start):
    """The same SQL text in ``sqlite_master``, written on an empty file
    and on a database whose frames table predates the newer columns
    (the forward-compatible ALTER TABLE loop)."""
    from lightcurver_tpu.structure import database as jdb

    paths = {}
    for package, module in (("port", tdb), ("jax", jdb)):
        path = paths[package] = tmp_path / f"{package}.sqlite3"
        if start == "older_frames_table":
            with sqlite3.connect(path) as conn:
                conn.execute("CREATE TABLE frames (id INTEGER PRIMARY KEY, "
                             "mjd REAL, image_relpath TEXT UNIQUE)")
        module.initialize_database(path)
        module.initialize_database(path)  # idempotent
    assert _schema(paths["port"]) == _schema(paths["jax"])
    assert len(_schema(paths["port"])) >= 10


# ---------------------------------------------------------------------------
# the three plate-solving strategies
# ---------------------------------------------------------------------------

def _roi_pixel_error(path, frame_id, dither):
    """|ROI pixel| of the frame's stored WCS less the true WCS's."""
    rel = _tables(path)["frames"].set_index("id").loc[frame_id,
                                                      "image_relpath"]
    _, header = read_fits(path / rel, header_only=True)
    x, y = TanWCS.from_header(header).world_to_pixel(ROI_RA, ROI_DEC)
    xt, yt = _make_wcs(dither).world_to_pixel(ROI_RA, ROI_DEC)
    return abs(float(x) - float(xt)), abs(float(y) - float(yt))


def test_adapt_wcs_recovers_the_injected_fault(snapshots):
    """``tests/test_e2e_pipeline.py``'s fault: frame 2 flipped to unsolved,
    re-solved from frame 1 by source-pattern matching, within 0.3 px and
    with JAX's cards."""
    from lightcurver_tpu.processes.alternate_plate_solving_adapt_existing_wcs \
        import alternate_plate_solve_adapt_ref as jax_adapt

    snap = snapshots["stamp_extraction"]
    overrides = dict(plate_solve_frames="all_not_plate_solved",
                     reference_frame_for_wcs=1)
    runs = {}
    for who, solve in (("port", tadapt.alternate_plate_solve_adapt_ref),
                       ("jax", jax_adapt)):
        path = runs[who] = _copy(snap, snap.parent / f"{who}_adapt",
                                 **overrides)
        with _config(path):
            tdb.execute_sqlite_query(
                "UPDATE frames SET plate_solved = 0, attempted_plate_solve "
                "= 0 WHERE id = 2", is_select=False)
            solve()
    frames = _tables(runs["port"])["frames"].set_index("id")
    assert frames.loc[2, "plate_solved"] == 1
    assert max(_roi_pixel_error(runs["port"], 2, FRAME_DITHER_PX[1])) \
        < MAX_PX
    _assert_same_workdir(runs["port"], runs["jax"])


@pytest.fixture()
def gaia_scene(tmp_path, monkeypatch):
    """``tests/test_gaia_plate_solve_e2e.py``'s scene: two frames that
    arrive with no WCS, the Gaia fixture, ``alternate_gaia_solve``."""
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    rng = np.random.default_rng(7)
    stars = []
    for i, ((dx, dy), flux) in enumerate(zip(STAR_OFFSETS,
                                             STAR_FLUXES_E_S)):
        gmag = 20.0 - 2.5 * np.log10(flux)
        stars.append({
            "ra": ROI_RA + dx / 3600.0 / np.cos(np.radians(ROI_DEC)),
            "dec": ROI_DEC + dy / 3600.0, "source_id": 2000 + i,
            "phot_g_mean_mag": gmag, "phot_bp_mean_mag": gmag + 0.5,
            "phot_rp_mean_mag": gmag - 0.5, "pmra": 0.0, "pmdec": 0.0,
            "ref_epoch": 2016.0})
    fixture_csv = tmp_path / "gaia.csv"
    pd.DataFrame(stars).to_csv(fixture_csv, index=False)
    star_world = [((s["ra"], s["dec"]), f)
                  for s, f in zip(stars, STAR_FLUXES_E_S)]
    for k, dither in enumerate(DITHERS):
        clean = _render_frame(rng, 0, star_world, _make_wcs(dither))
        total = (clean + SKY_E_PER_S) * EXPTIME
        header = Header()
        header["MJD-OBS"] = 60100.0 + k
        header["EXPTIME"] = EXPTIME
        header["GAIN"] = GAIN
        write_fits(raw_dir / f"frame_{k:02d}.fits",
                   ((total + rng.normal(0, np.sqrt(total))) / GAIN
                    ).astype(np.float32), header)
    parser_dir = tmp_path / "scene" / "header_parser"
    parser_dir.mkdir(parents=True)
    (parser_dir / "parse_header.py").write_text(
        "def parse_header(header):\n"
        "    return {'mjd': header['MJD-OBS'], 'gain': header['GAIN'],\n"
        "            'exptime': header['EXPTIME']}\n")
    template = (os.path.dirname(os.path.dirname(__file__))
                + "/lightcurver_tpu/pipeline/example_config_file/config.yaml")
    with open(template) as f:
        config = yaml.safe_load(f)
    config.update({
        "workdir": str(tmp_path / "scene"), "raw_dirs": [str(raw_dir)],
        "already_plate_solved": 0,
        "plate_solving_strategy": "alternate_gaia_solve",
        "plate_scale_interval": [0.19, 0.21],
        "alternate_plate_solve_gaia_radius": 60,
        "multiprocessing_cpu_count": 1, "source_extraction_threshold": 3.0,
        "source_extraction_min_area": 5, "source_extraction_do_plots": 0,
        "min_number_stars": 5})
    (tmp_path / "scene" / "config.yaml").write_text(yaml.dump(config))
    monkeypatch.setenv("LIGHTCURVER_GAIA_FIXTURE", str(fixture_csv))
    return tmp_path / "scene"


def test_gaia_solver_recovers_the_wcs(gaia_scene):
    """The port's import and Gaia-matched solver: every frame solved, the
    ROI within 0.3 px, the pixel scale within 0.5 %, and JAX's workdir."""
    from lightcurver_tpu.pipeline.workflow_manager import WorkflowManager

    jax_dir = _copy(gaia_scene, gaia_scene.parent / "jax_gaia")
    with _config(jax_dir):
        WorkflowManager().run(stop_step="plate_solving")
    with _config(gaia_scene):
        tdb.initialize_database()
        twrap.read_convert_skysub_character_catalog()
        tgaia.alternate_plate_solve_gaia()
        ok, message = tcheck.check_plate_solving()
    assert ok, message
    frames = _tables(gaia_scene)["frames"]
    assert len(frames) == len(DITHERS)
    assert (frames["plate_solved"] == 1).all()
    for frame_id, dither in zip(frames["id"], DITHERS):
        assert max(_roi_pixel_error(gaia_scene, frame_id, dither)) < MAX_PX
    assert (frames["pixel_scale"] / 0.2 - 1).abs().max() < 5e-3
    _assert_same_workdir(gaia_scene, jax_dir)


# the fake binary of tests/test_plate_solving.py: a TAN WCS with the ROI at
# pixel (20.5, 20.5), written where solve-field writes its solution
_FAKE_SOLVE_FIELD = textwrap.dedent("""\
    #!/usr/bin/env python3
    import os, sys

    if os.environ.get("FAKESOLVE_FAIL"):
        sys.stderr.write("simulated failure")
        sys.exit(1)

    args = sys.argv[1:]
    out_dir = args[args.index("--dir") + 1]
    assert os.path.getsize(args[0]) >= 2880 * 3, "xyls too small"
    assert "--scale-low" in args and "--ra" in args

    cards = [
        ("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0"),
        ("CTYPE1", "'RA---TAN'"), ("CTYPE2", "'DEC--TAN'"),
        ("CRVAL1", "42.2031"), ("CRVAL2", "19.22528"),
        ("CRPIX1", "20.5"), ("CRPIX2", "20.5"),
        ("CD1_1", "-5.5555E-05"), ("CD1_2", "0.0"),
        ("CD2_1", "0.0"), ("CD2_2", "5.5555E-05"),
    ]
    text = "".join(f"{k:<8}= {v:>20}".ljust(80) for k, v in cards)
    text += "END".ljust(80)
    text += " " * (-len(text) % 2880)
    with open(os.path.join(out_dir, "sources.wcs"), "w") as f:
        f.write(text)
""")
_SOLVE_CONFIG = {"plate_scale_interval": [0.1, 0.3],
                 "ROI_ra_deg": ROI_RA, "ROI_dec_deg": ROI_DEC}


@pytest.fixture()
def fake_solver(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "solve-field"
    exe.write_text(_FAKE_SOLVE_FIELD)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}" + os.environ["PATH"])
    monkeypatch.delenv("FAKESOLVE_FAIL", raising=False)
    return exe


def _frame_and_sources(path):
    rng = np.random.default_rng(0)
    path.mkdir()
    header = Header()
    header["EXPTIME"] = 30.0
    write_fits(path / "frame.fits",
               rng.normal(0, 1, (40, 40)).astype(np.float32), header)
    write_sources(pd.DataFrame({
        "x": rng.uniform(0, 40, 25), "y": rng.uniform(0, 40, 25),
        "flux": rng.uniform(10, 100, 25)}), path / "sources.csv")
    return path / "frame.fits", path / "sources.csv"


def test_solve_one_image_with_a_fake_binary(fake_solver, tmp_path):
    """The solved WCS goes into the frame's header beside its other cards,
    as JAX's wrapper writes it."""
    from lightcurver_tpu.processes.plate_solving import \
        solve_one_image as jax_solve

    frames = {}
    for who, solve in (("port", tsolve.solve_one_image),
                       ("jax", jax_solve)):
        image, sources = _frame_and_sources(tmp_path / who)
        wcs = solve(image, sources, _SOLVE_CONFIG)
        assert wcs.crval1 == pytest.approx(ROI_RA)
        assert wcs.crval2 == pytest.approx(ROI_DEC)
        frames[who] = read_fits(image)
    (data, header), (want_data, want_header) = frames["port"], frames["jax"]
    assert header["CTYPE1"] == "RA---TAN"
    assert float(header["CRPIX1"]) == pytest.approx(20.5)
    assert float(header["EXPTIME"]) == pytest.approx(30.0)
    np.testing.assert_array_equal(data, want_data)
    assert header.cards() == want_header.cards()


@pytest.mark.parametrize("fault", ["solver_fails", "no_binary"])
def test_solve_one_image_refuses(fake_solver, tmp_path, monkeypatch, fault):
    image, sources = _frame_and_sources(tmp_path / "frame")
    if fault == "solver_fails":
        monkeypatch.setenv("FAKESOLVE_FAIL", "1")
        match = "solve-field failed"
    else:
        monkeypatch.setattr(tsolve, "solve_field_available", lambda: False)
        match = "not installed"
    with pytest.raises(tsolve.CouldNotSolveError, match=match):
        tsolve.solve_one_image(image, sources, _SOLVE_CONFIG)


def test_plate_solve_task_with_a_fake_binary_matches_jax(snapshots,
                                                         fake_solver):
    """``plate_solve_all_frames`` on the imported frames with
    ``already_plate_solved: 0``: every frame solved by the binary, then the
    post-solve steps, as JAX's task does them."""
    from lightcurver_tpu.pipeline.task_wrappers import \
        plate_solve_all_frames as jax_task

    snap = snapshots["read_convert_skysub_character_catalog"]
    runs = {}
    for who, task in (("port", twrap.plate_solve_all_frames),
                      ("jax", jax_task)):
        path = runs[who] = _copy(snap, snap.parent / f"{who}_solve_field",
                                 already_plate_solved=0)
        with _config(path):
            task()
    frames = _tables(runs["port"])["frames"]
    assert (frames["plate_solved"] == 1).all()
    assert (frames["attempted_plate_solve"] == 1).all()
    assert len(_tables(runs["port"])["footprints"]) == N_FRAMES
    _assert_same_workdir(runs["port"], runs["jax"])


def test_nova_api_solver_against_a_fake_server(tmp_path):
    """The whole client flow (login, xyls upload, polling, WCS fetch)
    against an in-process fake of the nova.astrometry.net API."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    true_wcs = TanWCS(150.1, 2.2, 33.0, 31.0,
                      [[-5.5e-5, 0.0], [0.0, 5.5e-5]])
    wcs_path = tmp_path / "solution.wcs"
    header = Header()
    header.update(true_wcs.to_header_cards())
    write_fits(wcs_path, np.zeros((1, 1), np.float32), header)
    wcs_bytes = wcs_path.read_bytes()
    seen = {"login": 0, "upload": 0}

    class FakeNova(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, obj):
            body = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            if self.path.endswith("/api/login"):
                seen["login"] += 1
                assert b"fake-key" in body
                self._json({"status": "success", "session": "s1"})
            elif self.path.endswith("/api/upload"):
                seen["upload"] += 1
                assert b"sources.xyls" in body and b"scale_lower" in body
                self._json({"status": "success", "subid": 77})
            else:
                self.send_response(404)
                self.end_headers()

        def do_GET(self):
            if self.path.endswith("/api/submissions/77"):
                self._json({"jobs": [123]})
            elif self.path.endswith("/api/jobs/123"):
                self._json({"status": "success"})
            elif self.path.endswith("/wcs_file/123"):
                self.send_response(200)
                self.end_headers()
                self.wfile.write(wcs_bytes)
            else:
                self.send_response(404)
                self.end_headers()

    server = HTTPServer(("127.0.0.1", 0), FakeNova)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        sources = pd.DataFrame({"x": [10.0, 20.0], "y": [12.0, 25.0],
                                "flux": [500.0, 300.0]})
        wcs = tsolve.solve_via_nova_api(
            sources, 160, 160,
            {"astrometry_net_api_key": "fake-key",
             "plate_scale_interval": [0.15, 0.25],
             "ROI_ra_deg": 150.1, "ROI_dec_deg": 2.2},
            api_url=f"http://127.0.0.1:{server.server_address[1]}/api/",
            poll_interval=0.01, timeout=10.0)
    finally:
        server.shutdown()
        server.server_close()
    assert seen == {"login": 1, "upload": 1}
    assert wcs.crval1 == pytest.approx(150.1)
    for x, y in ((32.0, 30.0), (0.0, 159.0)):
        np.testing.assert_allclose(wcs.pixel_to_world(x, y),
                                   true_wcs.pixel_to_world(x, y), atol=1e-9)
