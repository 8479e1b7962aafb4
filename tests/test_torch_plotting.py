"""The port's ``plotting/`` against JAX's: ``tests/test_plotting.py``'s nine
cases run on the port's functions with the same inputs, each image the
same size in bytes as JAX's from the same call (the same matplotlib code
on the same data), and the HTML light curve byte for byte JAX's.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

PORT, JAX = "lightcurver_tpu_torch", "lightcurver_tpu"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plotting(package, name):
    return importlib.import_module(f"{package}.plotting.{name}")


def _same_size(tmp_path, name):
    """The port's file exists, is not empty, and has JAX's size."""
    port, jax = tmp_path / PORT / name, tmp_path / JAX / name
    assert port.exists() and port.stat().st_size > 0
    assert port.stat().st_size == jax.stat().st_size, name


@pytest.fixture()
def out(tmp_path):
    """{package: its output directory}."""
    dirs = {package: tmp_path / package for package in (PORT, JAX)}
    for path in dirs.values():
        path.mkdir()
    return dirs


@pytest.fixture()
def stamps():
    rng = np.random.default_rng(0)
    data = rng.normal(0, 1, (4, 16, 16)).astype(np.float32) + 5.0
    noise = np.ones_like(data)
    return data, noise


def test_psf_diagnostic(stamps, out, tmp_path):
    data, noise = stamps
    for package, path in out.items():
        _plotting(package, "psf_plotting").plot_psf_diagnostic(
            datas=data, noisemaps=noise, residuals=0.1 * data,
            full_psf=data[0], loss_curve=np.linspace(10, 1, 50),
            masks=np.ones_like(data, dtype=bool), names=list("abcd"),
            diagnostic_text="test", save_path=path / "psf.jpg")
    _same_size(tmp_path, "psf.jpg")


def test_joint_modelling_diagnostic(stamps, out, tmp_path):
    data, noise = stamps
    for package, path in out.items():
        _plotting(package, "joint_modelling_plotting") \
            .plot_joint_modelling_diagnostic(
                datas=data, noisemaps=noise, residuals=0.1 * data,
                chi2_per_frame=np.array([1.0, 1.1, 0.9, 1.2]),
                loss_curve=np.linspace(10, 1, 50),
                starlet_background=data[0], save_path=path / "joint.jpg")
    _same_size(tmp_path, "joint.jpg")


def test_photometry_plot(out, tmp_path):
    rng = np.random.default_rng(1)
    mjd = np.concatenate([60000 + np.arange(20), 60200 + np.arange(20)])
    df = pd.DataFrame({
        "mjd": mjd,
        "A_mag": 18.0 + 0.1 * rng.normal(size=40),
        "A_d_mag": np.full(40, 0.05),
        "B_mag": 19.0 + 0.1 * rng.normal(size=40),
        "B_d_mag": np.full(40, 0.05),
    })
    port = _plotting(PORT, "photometry_plotting")
    jax = _plotting(JAX, "photometry_plotting")
    assert port.find_sources(df) == ["A", "B"]
    offsets = port.compute_offsets(df, ["A", "B"])
    assert offsets == jax.compute_offsets(df, ["A", "B"])
    assert offsets["A"] == 0.0
    assert offsets["B"] < 0.0
    for module, package in ((port, PORT), (jax, JAX)):
        module.plot_photometry(df, save_path=out[package] / "curves.jpg")
    _same_size(tmp_path, "curves.jpg")


def test_photometry_plot_seasons_and_scatter_columns(out, tmp_path):
    rng = np.random.default_rng(2)
    mjd = np.concatenate([60000 + np.arange(10), 60300 + np.arange(60),
                          60800 + np.arange(25)])
    n = len(mjd)
    df = pd.DataFrame({
        "mjd": mjd,
        "A_mag": 18.0 + 0.1 * rng.normal(size=n),
        "A_d_mag_down": np.full(n, 0.04),
        "A_d_mag_up": np.full(n, 0.06),
        "A_scatter_mag_down": np.full(n, 0.02),
        "A_scatter_mag_up": np.full(n, 0.02),
        "B_mag": 19.5 + 0.3 * rng.normal(size=n),
        "B_d_mag_down": np.full(n, 0.08),
        "B_d_mag_up": np.full(n, 0.08),
    })
    port = _plotting(PORT, "photometry_plotting")
    segments = port.find_segments(df["mjd"], gap_threshold=70.0)
    assert len(segments) == 3
    assert segments[0] == (60000.0, 60009.0)
    assert segments == _plotting(JAX, "photometry_plotting").find_segments(
        df["mjd"], gap_threshold=70.0)

    csv = tmp_path / "phot.csv"
    df.to_csv(csv, index=False)
    widths = {}
    for package, path in out.items():
        fig = _plotting(package, "photometry_plotting").plot_photometry(
            csv, save_path=path / "seasons.jpg", plot_title="demo")
        widths[package] = [ax.get_position().width for ax in fig.axes]
    assert len(widths[PORT]) == 3
    assert widths[PORT][1] > widths[PORT][2] > widths[PORT][0]
    assert widths[PORT] == widths[JAX]
    _same_size(tmp_path, "seasons.jpg")


def test_html_visualisation(out):
    df = pd.DataFrame({
        "mjd": [60000.0, 60001.0, 60002.0],
        "A_mag": [18.0, 18.1, np.nan],
        "A_d_mag": [0.05, 0.04, np.nan],
    })
    for package, path in out.items():
        _plotting(package, "html_visualisation").generate_lightcurve_html(
            df, path / "curves.html")
    html = (out[PORT] / "curves.html").read_text()
    assert "const DATA" in html
    assert "18.1" in html
    assert "null" in html  # NaN serialized as null
    assert (out[PORT] / "curves.html").read_bytes() == \
        (out[JAX] / "curves.html").read_bytes()


def test_html_template_is_the_jax_one():
    port = _plotting(PORT, "html_visualisation")._TEMPLATE_PATH
    jax = _plotting(JAX, "html_visualisation")._TEMPLATE_PATH
    assert port != jax
    assert port.read_bytes() == jax.read_bytes()


def test_footprint_and_sources_plots(out, tmp_path):
    polys = [np.array([[0, 0], [1, 0], [1, 1], [0, 1]]) + 0.1 * i
             for i in range(3)]
    rng = np.random.default_rng(2)
    image = rng.normal(0, 1, (50, 50))
    sources = pd.DataFrame({"x": [10.0, 30.0], "y": [20.0, 40.0]})
    stars = pd.DataFrame({"name": ["a", "roi"], "ra": [0.5, 0.6],
                          "dec": [0.5, 0.6]})
    for package, path in out.items():
        polygon = importlib.import_module(
            f"{package}.utilities.geometry").SimplePolygon
        common = polygon([[0.2, 0.2], [1, 0.2], [1, 1], [0.2, 1]])
        largest = polygon([[0, 0], [1.2, 0], [1.2, 1.2], [0, 1.2]])
        _plotting(package, "footprint_plotting").plot_footprints(
            polys, common, largest, save_path=path / "fp.jpg")
        plots = _plotting(package, "sources_plotting")
        plots.plot_sources(sources, image, save_path=path / "src.jpg")
        plots.plot_footprints_with_stars(polys, stars,
                                         save_path=path / "fps.jpg")
    for name in ("fp.jpg", "src.jpg", "fps.jpg"):
        _same_size(tmp_path, name)


def test_photometry_plot_degenerate_inputs(out, tmp_path):
    mjd = np.concatenate([np.linspace(60000, 60030, 10), [np.nan]])
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "mjd": mjd,
        "A_mag": 18.0 + 0.01 * rng.normal(size=11),
        "B_mag": np.full(11, np.nan),
        "C_mag": 19.0 + 0.01 * rng.normal(size=11),
        "C_d_mag": np.full(11, 0.02),
    })
    port = _plotting(PORT, "photometry_plotting")
    assert port.find_sources(df) == ["A", "B", "C"]
    offsets = port.compute_offsets(df, ["A", "B", "C"])
    assert np.isfinite(list(offsets.values())).all()
    assert offsets["B"] == 0.0
    for package, path in out.items():
        _plotting(package, "photometry_plotting").plot_photometry(
            df, save_path=path / "degenerate.jpg")
    _same_size(tmp_path, "degenerate.jpg")

    df_bad = df.copy()
    df_bad["mjd"] = np.nan
    with pytest.raises(ValueError, match="mjd"):
        port.plot_photometry(df_bad)


def test_joint_modelling_diagnostic_without_chi2(stamps):
    data, noise = stamps
    fig = _plotting(PORT, "joint_modelling_plotting") \
        .plot_joint_modelling_diagnostic(datas=data, noisemaps=noise,
                                         residuals=0.1 * data)
    titles = [ax.get_title() for ax in fig.axes]
    assert "epoch 0" in titles
    assert not any("worst" in t for t in titles)
    import matplotlib.pyplot as plt

    plt.close(fig)


def test_normalization_plot_survives_zero_coefficient(out, tmp_path,
                                                      monkeypatch):
    coeffs = pd.DataFrame({
        "frame_id": [1, 2, 3],
        "mjd": [60000.0, 60001.0, 60002.0],
        "coefficient": [1.0, 0.0, 1.1],
        "coefficient_uncertainty": [0.01, 0.01, 0.01],
    })
    fluxes = pd.DataFrame({
        "name": ["s1"] * 3 + ["s2"] * 3,
        "mjd": [60000.0, 60001.0, 60002.0] * 2,
        "flux": [100.0, 100.0, 110.0, 50.0, 55.0, 52.0],
        "flux_uncertainty": [1.0] * 6,
        "coefficient": [1.0, 0.0, 1.1] * 2,
    })
    figs = {}
    for package, path in out.items():
        module = _plotting(package, "normalization_plotting")
        results = [coeffs, fluxes]
        monkeypatch.setattr(module, "execute_sqlite_query",
                            lambda *a, **k: results.pop(0))
        figs[package] = module.plot_normalized_star_curves(
            "hash", save_path=path / "norm.jpg")
    _same_size(tmp_path, "norm.jpg")
    lo, hi = figs[PORT].axes[1].get_ylim()
    assert np.isfinite(lo) and np.isfinite(hi)
    assert (lo, hi) == figs[JAX].axes[1].get_ylim()


def test_plotting_selects_agg_when_it_plots():
    """The package imports no matplotlib; its ``pyplot`` selects Agg."""
    import subprocess

    code = ("import sys\n"
            "import lightcurver_tpu_torch.plotting.psf_plotting as p\n"
            "assert 'matplotlib' not in sys.modules\n"
            "from lightcurver_tpu_torch.plotting import pyplot\n"
            "import matplotlib\n"
            "pyplot()\n"
            "print(matplotlib.get_backend())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1].lower() == "agg"
