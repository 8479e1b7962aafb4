"""Port parity for the host helpers of the front tasks.

Seeded numpy inputs go through the JAX package's function and the port's
copy: the background mesh and its subtraction (with masks and NaNs), the
source extraction and its moments, the cosmic-ray and bad-column masks,
the pattern matcher, the polygons (the cases of
``tests/test_geometry_union.py``), the footprint combination, the
ephemeris and characterization, proper motions, star names, stamps and the
``solve-field`` source table. JAX's background, extraction and cosmics
run on their numpy twins (its C++ library off), which its own tests hold
to the C++. Equal to the bit, except where a bar is stated: the port's
source moments sum over each object's bounding box, not the frame, so
their float64 centroids and axes agree to a relative 1e-12.
"""

import numpy as np
import pandas as pd
import pytest

from lightcurver_tpu.io import fits as jfits
from lightcurver_tpu.io import wcs as jwcs
from lightcurver_tpu.processes import background_estimation as jbkg
from lightcurver_tpu.processes import cosmics as jcos
from lightcurver_tpu.processes import cutout_making as jcut
from lightcurver_tpu.processes import frame_characterization as jchar
from lightcurver_tpu.processes import plate_solving as jsolve
from lightcurver_tpu.processes import star_extraction as jext
from lightcurver_tpu.utilities import coordinates as jcoord
from lightcurver_tpu.utilities import ephemeris as jeph
from lightcurver_tpu.utilities import footprint as jfoot
from lightcurver_tpu.utilities import geometry as jgeo
from lightcurver_tpu.utilities import pattern_matching as jpm
from lightcurver_tpu.utilities import star_naming as jnames

from lightcurver_tpu_torch.io import fits as tfits
from lightcurver_tpu_torch.io import wcs as twcs
from lightcurver_tpu_torch.processes import background_estimation as tbkg
from lightcurver_tpu_torch.processes import cosmics as tcos
from lightcurver_tpu_torch.processes import cutout_making as tcut
from lightcurver_tpu_torch.processes import frame_characterization as tchar
from lightcurver_tpu_torch.processes import plate_solving as tsolve
from lightcurver_tpu_torch.processes import star_extraction as text
from lightcurver_tpu_torch.utilities import coordinates as tcoord
from lightcurver_tpu_torch.utilities import ephemeris as teph
from lightcurver_tpu_torch.utilities import footprint as tfoot
from lightcurver_tpu_torch.utilities import geometry as tgeo
from lightcurver_tpu_torch.utilities import pattern_matching as tpm
from lightcurver_tpu_torch.utilities import star_naming as tnames

MOMENTS_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_on_numpy_twins():
    """Both packages' C++ libraries off, their load caches reset for this
    module only."""
    import lightcurver_tpu.native as nat
    import lightcurver_tpu_torch.native as port_nat

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTCURVER_DISABLE_NATIVE", "1")
        for module in (nat, port_nat):
            mp.setattr(module, "_lib", None)
            mp.setattr(module, "_tried", False)
        yield


def _stars(shape, n, seed, fwhm=3.0, flux=(300.0, 3000.0), sky=0.0,
           noise=1.0):
    """A seeded frame of n Gaussian stars on noise; their (x, y)."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    image = sky + rng.normal(0.0, noise, shape)
    yy, xx = np.mgrid[0:ny, 0:nx]
    sigma = fwhm / 2.3548
    xy = rng.uniform(8, [nx - 8, ny - 8], (n, 2))
    for (x, y), f in zip(xy, rng.uniform(*flux, n)):
        image += f / (2 * np.pi * sigma**2) * np.exp(
            -0.5 * ((xx - x) ** 2 + (yy - y) ** 2) / sigma**2)
    return image.astype(np.float32), xy


# ---------------------------------------------------------------------------
# background
# ---------------------------------------------------------------------------

def _background_case(case):
    rng = np.random.default_rng({"gradient": 0, "stars": 1, "nans": 2,
                                 "masked": 3, "tiny": 4}[case])
    shape = (40, 40) if case == "tiny" else (150, 130)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    image = 5.0 + 0.01 * xx + 0.005 * yy + rng.normal(0, 0.3, shape)
    if case in ("stars", "masked", "nans"):
        image = image + _stars(shape, 6, seed=9, fwhm=8.0,
                               flux=(2e3, 5e3))[0]
    if case == "nans":
        image[:5, :7] = np.nan
        image[60:, 20] = np.nan
    mask = None
    if case == "masked":
        mask = np.zeros(shape, bool)
        mask[40:80, :] = True
    return image, mask


@pytest.mark.parametrize("case", ["gradient", "stars", "nans", "masked",
                                  "tiny"])
def test_background_mesh_matches_jax(case):
    image, mask = _background_case(case)
    for box in (16, 37):
        got = tbkg.Background(image, box, mask=mask)
        want = jbkg.Background(image, box, mask=mask)
        np.testing.assert_array_equal(got.back(), want.back())
        np.testing.assert_array_equal(got.rms(), want.rms())
        assert (got.globalback, got.globalrms) == (want.globalback,
                                                   want.globalrms)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("case", ["gradient", "stars", "nans"])
def test_subtract_background_matches_jax(case, two_pass):
    image, _ = _background_case(case)
    for n_boxes in (3, 5):
        got, bkg = tbkg.subtract_background(
            image, mask_sources_first=two_pass, n_boxes=n_boxes)
        want, jbk = jbkg.subtract_background(
            image, mask_sources_first=two_pass, n_boxes=n_boxes)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (bkg.globalback, bkg.globalrms) == (jbk.globalback,
                                                   jbk.globalrms)


# ---------------------------------------------------------------------------
# source extraction
# ---------------------------------------------------------------------------

def _same_sources(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        assert got[col].dtype == want[col].dtype, col
        if want[col].dtype.kind == "f" and col not in ("flux", "npix",
                                                       "peak"):
            np.testing.assert_allclose(got[col], want[col],
                                       rtol=MOMENTS_RTOL, atol=0.0,
                                       err_msg=col)
        else:
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)


@pytest.mark.parametrize("case", ["few", "crowded", "one", "none",
                                  "large_frame", "nan_pixels"])
def test_extract_stars_matches_jax(case):
    shape, n, seed = {"few": ((90, 110), 5, 1), "crowded": ((120, 120), 40, 2),
                      "one": ((60, 60), 1, 3), "none": ((50, 50), 0, 4),
                      "large_frame": ((600, 500), 25, 5),
                      "nan_pixels": ((90, 90), 6, 6)}[case]
    image, _ = _stars(shape, n, seed)
    if case == "nan_pixels":
        image[10:14, 30:60] = np.nan
    variance = np.ones_like(image) + np.abs(np.nan_to_num(image)) / 30.0
    for threshold, min_area in ((3.0, 5), (2.0, 10)):
        got = text.extract_stars(image, variance, threshold, min_area)
        want = jext.extract_stars(image, variance, threshold, min_area)
        _same_sources(got, want)
    if n > 1:
        assert len(got) > 1


def test_moments_match_jax_per_object():
    """The bounding-box sums against JAX's whole-frame sums: the flux,
    pixel count and peak to the bit, the rest to MOMENTS_RTOL."""
    image, _ = _stars((400, 380), 30, seed=11)
    labels, seg = text._segment(image, np.ones_like(image), 2.0, 5)
    want_labels, want_seg = jext._segment(image, np.ones_like(image), 2.0, 5)
    assert labels == want_labels
    np.testing.assert_array_equal(seg, want_seg)
    got = pd.DataFrame(text._moments(image, seg, labels))
    want = pd.DataFrame(jext._moments(image, seg, labels))
    assert len(want) >= 20
    for col in ("flux", "npix", "peak"):
        np.testing.assert_array_equal(got[col], want[col])
    for col in ("x", "y", "a", "b"):
        np.testing.assert_allclose(got[col], want[col], rtol=MOMENTS_RTOL,
                                   atol=0.0)


def test_sources_round_trip_and_reextraction(tmp_path):
    """write_sources / read_sources and the re-extraction of a stored,
    sky-subtracted frame, against JAX's."""
    image, _ = _stars((80, 90), 6, seed=12)
    header = tfits.Header()
    header["EXPTIME"] = 30.0
    tfits.write_fits(tmp_path / "frame.fits", image, header)
    for who, module in (("port", text), ("jax", jext)):
        module.extract_sources_from_sky_sub_image(
            tmp_path / "frame.fits", tmp_path / f"{who}.csv",
            detection_threshold=3.0, min_area=5, exptime=30.0,
            background_rms_electron_per_second=1.0, debug_plot_path=None)
    got, want = (text.read_sources(tmp_path / f"{who}.csv")
                 for who in ("port", "jax"))
    _same_sources(got, want)
    assert len(got) >= 4


# ---------------------------------------------------------------------------
# cosmics and bad columns
# ---------------------------------------------------------------------------

def _cosmic_case(case):
    """Noise, two stars in one case, and hits of 50-300 sigma."""
    image = _stars((48, 40), 2 if case == "star_and_hits" else 0, seed=5,
                   flux=(2e3, 4e3))[0].astype(float)
    rng = np.random.default_rng(len(case))
    n_hits = {"clean": 0, "dense": 30}.get(case, 4)
    ys, xs = rng.integers(2, 46, n_hits), rng.integers(2, 38, n_hits)
    image[ys, xs] += rng.uniform(50.0, 300.0, n_hits)
    return image


@pytest.mark.parametrize("params", [{}, {"sigclip": 6.0, "objlim": 5.0},
                                    {"sigclip": 4.5, "sigfrac": 0.3,
                                     "niter": 4}])
@pytest.mark.parametrize("case", ["hits", "star_and_hits", "clean", "dense"])
def test_detect_cosmics_matches_jax(case, params):
    image = _cosmic_case(case)
    variance = np.ones_like(image) + np.abs(image) / 50.0
    got_mask, got_clean = tcos.detect_cosmics(image, invar=variance,
                                              **params)
    want_mask, want_clean = jcos.detect_cosmics_numpy(image, invar=variance,
                                                      **params)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_clean, want_clean)
    if case in ("hits", "dense"):
        assert got_mask.any()
    got = tcos.detect_cosmics_numpy(image, sigclip=5.0)
    want = jcos.detect_cosmics_numpy(image, sigclip=5.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["column", "row", "both", "partial", "none"])
def test_bad_rows_and_columns_match_jax(case):
    image = np.random.default_rng(8).normal(10.0, 1.0, (32, 24))
    if case in ("column", "both"):
        image[:, 7] += 60.0
    if case in ("row", "both"):
        image[20, :] -= 60.0
    if case == "partial":  # not from end to end: kept
        image[5:20, 11] += 60.0
    got = tcos.mask_bad_rows_and_columns(image)
    np.testing.assert_array_equal(got, jcos.mask_bad_rows_and_columns(image))
    assert got.any() == (case in ("column", "row", "both"))


# ---------------------------------------------------------------------------
# pattern matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reflection", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_similarity_matches_jax(seed, reflection):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 100, (12, 2))
    dst = src @ np.array([[0.9, -0.3], [0.25, 1.1]]).T + rng.normal(
        0, 0.5, (12, 2))
    got = tpm.estimate_similarity(src, dst, allow_reflection=reflection)
    want = jpm.estimate_similarity(src, dst, allow_reflection=reflection)
    np.testing.assert_array_equal(got.params, want.params)
    assert (got.scale, got.rotation) == (want.scale, want.rotation)
    np.testing.assert_array_equal(got.inverse(dst), want.inverse(dst))


@pytest.mark.parametrize("case", ["shift", "rotate_scale", "outliers",
                                  "subset"])
def test_find_transform_matches_jax(case):
    rng = np.random.default_rng(["shift", "rotate_scale", "outliers",
                                 "subset"].index(case))
    src = rng.uniform(0, 500, (40, 2))
    angle, scale = {"shift": (0.0, 1.0)}.get(case, (0.3, 1.05))
    rot = scale * np.array([[np.cos(angle), -np.sin(angle)],
                            [np.sin(angle), np.cos(angle)]])
    dst = src @ rot.T + np.array([12.5, -7.25]) + rng.normal(0, 0.05,
                                                             src.shape)
    if case == "outliers":
        dst[::7] = rng.uniform(0, 500, dst[::7].shape)
    if case == "subset":
        dst = dst[rng.permutation(40)[:30]]
    got, (gs, gt) = tpm.find_transform(src, dst)
    want, (ws, wt) = jpm.find_transform(src, dst)
    np.testing.assert_array_equal(got.params, want.params)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gt, wt)
    assert len(gs) >= 20
    with pytest.raises(ValueError):
        tpm.find_transform(src[:2], dst)


# ---------------------------------------------------------------------------
# polygons and footprints
# ---------------------------------------------------------------------------

def sq(x0, y0, w=1.0, h=1.0):
    return np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]])


def _rotated_star(n_arms):
    base = np.array([[-1, -0.15], [1, -0.15], [1, 0.15], [-1, 0.15]])
    out = []
    for k in range(n_arms):
        th = np.pi * k / n_arms
        out.append(base @ np.array([[np.cos(th), np.sin(th)],
                                    [-np.sin(th), np.cos(th)]]))
    return out


def _random_quads(seed):
    rng = np.random.default_rng(seed)
    polys = []
    for _ in range(rng.integers(3, 20)):
        c = rng.normal(0, 0.3, 2)
        w, h = rng.uniform(0.8, 1.5, 2)
        th = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        q = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2],
                      [-w / 2, h / 2]]) @ rot.T + c
        if jgeo.SimplePolygon(q).contains(0.0, 0.0):
            polys.append(q)
    return polys


def _dithered(seed, n=40):
    rng = np.random.default_rng(seed)
    return [sq(150.0 + dx, 2.0 + dy, 0.1, 0.1)
            for dx, dy in rng.normal(0.0, 3e-4, (n, 2))]


# the cases of tests/test_geometry_union.py
POLYGON_CASES = {
    "l_shape": [sq(0, 0), sq(0.5, 0.5)],
    "duplicate": [sq(0, 0), sq(0, 0)],
    "shared_edge": [sq(0, 0), sq(1, 0)],
    "collinear_overlap": [sq(0, 0, 2, 1), sq(0.5, 1, 1, 1)],
    "vertex_touching": [sq(0, 0), sq(1, 1)],
    "plus": [sq(-1, -0.25, 2, 0.5), sq(-0.25, -1, 0.5, 2)],
    "star_3": _rotated_star(3), "star_5": _rotated_star(5),
    "star_8": _rotated_star(8),
    "dithered_stack": _dithered(42), "dithered_simplify": _dithered(3),
    "random_quads_0": _random_quads(7), "random_quads_1": _random_quads(8),
    "disjoint": [sq(0, 0), sq(5, 5)],
    "single": [sq(2, 3)],
}


@pytest.mark.parametrize("case", sorted(POLYGON_CASES))
def test_polygons_match_jax(case):
    polys = POLYGON_CASES[case]
    got = tgeo.polygon_union(polys)
    want = jgeo.polygon_union(polys)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert got.area == want.area
    assert got.mapping() == want.mapping()
    for tol in (1e-6, 1e-3):
        np.testing.assert_array_equal(got.simplify(tol).vertices,
                                      want.simplify(tol).vertices)
    a, b = tgeo.SimplePolygon(polys[0]), tgeo.SimplePolygon(polys[-1])
    ja, jb = jgeo.SimplePolygon(polys[0]), jgeo.SimplePolygon(polys[-1])
    inter, jinter = a.intersection(b), ja.intersection(jb)
    assert (inter is None) == (jinter is None)
    if inter is not None:
        np.testing.assert_array_equal(inter.vertices, jinter.vertices)
    np.testing.assert_array_equal(tgeo.convex_hull(np.vstack(polys)),
                                  jgeo.convex_hull(np.vstack(polys)))
    lo, hi = np.min(np.vstack(polys), 0), np.max(np.vstack(polys), 0)
    probes = np.random.default_rng(0).uniform(lo - 0.1, hi + 0.1, (60, 2))
    assert [got.contains(*p) for p in probes] == [want.contains(*p)
                                                  for p in probes]
    assert [a.buffered_contains(*p, 0.05) for p in probes] == \
        [ja.buffered_contains(*p, 0.05) for p in probes]


@pytest.mark.parametrize("case", ["dithered_stack", "two_offset", "ra_wrap",
                                  "disjoint"])
def test_footprint_combination_matches_jax(case):
    footprints = {
        "dithered_stack": _dithered(5, n=12),
        "two_offset": [sq(10.0, 5.0, 0.2, 0.2), sq(10.1, 5.1, 0.2, 0.2)],
        "ra_wrap": [sq(359.95, 1.0, 0.1, 0.1), sq(-0.03, 1.02, 0.1, 0.1)],
        "disjoint": [sq(10.0, 5.0, 0.1, 0.1), sq(20.0, 5.0, 0.1, 0.1)],
    }[case]
    common, largest = tfoot.calc_common_and_total_footprint(footprints)
    jcommon, jlargest = jfoot.calc_common_and_total_footprint(footprints)
    assert largest.mapping() == jlargest.mapping()
    assert (common is None) == (jcommon is None)
    if common is not None:
        assert common.mapping() == jcommon.mapping()
    ras = np.array([359.9, 0.1, 180.0, -10.0, 725.0])
    np.testing.assert_array_equal(tfoot.unwrap_ra(ras, 359.95),
                                  jfoot.unwrap_ra(ras, 359.95))


# ---------------------------------------------------------------------------
# ephemeris, characterization, coordinates, names
# ---------------------------------------------------------------------------

EPHEMERIS_CASES = [(60000.0, 42.2, 19.2, -70.4, -24.6),
                   (59000.37, 150.1, 2.2, 17.9, 28.8),
                   (61234.9, 300.0, -60.0, 116.1, -31.3),
                   (51544.5, 0.0, 89.0, 0.0, 0.0)]


@pytest.mark.parametrize("mjd, ra, dec, lon, lat", EPHEMERIS_CASES)
def test_ephemeris_matches_jax(mjd, ra, dec, lon, lat):
    for name in ("sun_position", "moon_illumination_percent", "gmst_deg",
                 "obliquity_deg", "julian_centuries"):
        assert getattr(teph, name)(mjd) == getattr(jeph, name)(mjd), name
    assert teph.moon_position(mjd) == jeph.moon_position(mjd)
    assert teph.moon_position(mjd, lat, lon) == \
        jeph.moon_position(mjd, lat, lon)
    assert teph.radec_to_altaz(ra, dec, mjd, lat, lon) == \
        jeph.radec_to_altaz(ra, dec, mjd, lat, lon)
    assert teph.ecliptic_to_equatorial(ra, dec / 3, mjd) == \
        jeph.ecliptic_to_equatorial(ra, dec / 3, mjd)
    assert teph.angular_separation(ra, dec, lon % 360, lat) == \
        jeph.angular_separation(ra, dec, lon % 360, lat)
    assert tchar.ephemeris(mjd, ra, dec, lon, lat, 2400.0) == \
        jchar.ephemeris(mjd, ra, dec, lon, lat, 2400.0)


def test_airmass_and_seeing_match_jax():
    alt = np.array([-5.0, 0.0, 1.0, 30.0, 60.0, 90.0, 95.0])
    np.testing.assert_array_equal(tchar.calculate_airmass(alt),
                                  jchar.calculate_airmass(alt))
    rng = np.random.default_rng(1)
    for fwhm in (rng.normal(3.0, 0.4, 200), rng.normal(3.0, 0.4, 8),
                 np.zeros(0), rng.uniform(1.0, 40.0, 50)):
        table = pd.DataFrame({"FWHM": fwhm})
        assert tchar.estimate_seeing(table) == jchar.estimate_seeing(table)


def test_coordinates_match_jax():
    rng = np.random.default_rng(2)
    ra, dec = rng.uniform(0, 360, 50), rng.uniform(-89, 89, 50)
    pm = rng.normal(0, 50, (2, 50))
    pm[0, ::9] = np.nan
    for mjd in (51544.5, 60000.0, np.full(50, 58000.25)):
        got = tcoord.apply_proper_motion(ra, dec, pm[0], pm[1], 2016.0, mjd)
        want = jcoord.apply_proper_motion(ra, dec, pm[0], pm[1], 2016.0, mjd)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tcoord.angular_separation_deg(ra, dec, ra[::-1], dec[::-1]),
        jcoord.angular_separation_deg(ra, dec, ra[::-1], dec[::-1]))
    assert tcoord.mjd_to_jyear(60000.0) == jcoord.mjd_to_jyear(60000.0)
    a, b = tcoord.SkyCoord(10.0, 20.0), tcoord.SkyCoord(10.1, 19.9)
    assert a.separation_arcsec(b) == jcoord.SkyCoord(10.0, 20.0) \
        .separation_arcsec(jcoord.SkyCoord(10.1, 19.9))


@pytest.mark.parametrize("n", [0, 1, 26, 27, 703, 1000])
def test_star_names_match_jax(n):
    names = tnames.generate_star_names(n)
    assert names == jnames.generate_star_names(n)
    assert len(set(names)) == n


# ---------------------------------------------------------------------------
# stamps and the solve-field source table
# ---------------------------------------------------------------------------

def _frame_wcs(module, sip):
    cd = [[-5.5e-5, 1.0e-6], [1.2e-6, 5.5e-5]]
    sip_a = sip_b = None
    if sip:
        sip_a = np.zeros((3, 3))
        sip_a[2, 0], sip_a[1, 1] = 2e-6, -1e-6
        sip_b = np.zeros((3, 3))
        sip_b[0, 2], sip_b[1, 1] = 1.5e-6, 3e-7
    return module.TanWCS(42.2031, 19.22528, 61.5, 54.0, cd, sip_a=sip_a,
                         sip_b=sip_b)


@pytest.mark.parametrize("sip", [False, True])
@pytest.mark.parametrize("where", ["centre", "edge", "outside"])
def test_extract_stamp_matches_jax(where, sip):
    image, _ = _stars((110, 120), 8, seed=21)
    pixel = {"centre": (60.3, 52.7), "edge": (3.2, 106.0),
             "outside": (-40.0, 20.0)}[where]
    outs = []
    for wcs_module, fits_module, cut in ((twcs, tfits, tcut),
                                         (jwcs, jfits, jcut)):
        wcs = _frame_wcs(wcs_module, sip)
        header = fits_module.Header()
        header.update(wcs.to_header_cards())
        ra, dec = wcs.pixel_to_world(*pixel)
        outs.append(cut.extract_stamp(image, header, 30.0,
                                      (float(ra), float(dec)), 24, 1.5))
    (stamp, noise, wcs_json, center), want = outs
    np.testing.assert_array_equal(stamp, want[0])
    np.testing.assert_array_equal(noise, want[1])
    assert wcs_json == want[2]
    np.testing.assert_array_equal(center, want[3])
    assert np.isnan(stamp).any() == (where != "centre")
    for columns, cosmics in ((True, True), (False, True), (True, False)):
        np.testing.assert_array_equal(
            tcut.mask_cutout(stamp, noise, columns, cosmics,
                             {"sigclip": 4.5, "sigfrac": 0.3}),
            jcut.mask_cutout(want[0], want[1], columns, cosmics,
                             {"sigclip": 4.5, "sigfrac": 0.3}))


@pytest.mark.parametrize("n", [0, 1, 25])
def test_write_xyls_matches_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    sources = pd.DataFrame({"x": rng.uniform(0, 40, n),
                            "y": rng.uniform(0, 40, n),
                            "flux": rng.uniform(10, 100, n)})
    tsolve._write_xyls(tmp_path / "port.xyls", sources, 40, 30)
    jsolve._write_xyls(tmp_path / "jax.xyls", sources, 40, 30)
    raw = (tmp_path / "port.xyls").read_bytes()
    assert raw == (tmp_path / "jax.xyls").read_bytes()
    assert len(raw) % 2880 == 0


def test_chip_smoke_front_phase_on_a_small_frame():
    """``chip_smoke.py`` phase 12 needs no card: its bodies and gates run
    here on a 1024 px frame of 81 stars (the card's run takes 2048 px and
    306), so a change that breaks them shows before a chip run."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    walls = smoke.phase_front(np, "cpu", size=1024, grid=(9, 9), n_hits=60)
    assert set(walls) == {"subtract_background", "segment_moments",
                          "find_transform", "stamps_and_masks"}
