"""Source extraction, thresholding and connected components: a copy of
``lightcurver_tpu/processes/star_extraction.py``, on its numpy path.

x/y centroids, flux, second-moment semi-axes a/b, the elongation filter,
the FWHM estimate 2 sqrt(ln2 (a^2 + b^2)), ellipticity, brightest first.
``extract_stars`` runs the host C++ extractor of ``native/`` when it
loads, else ``_segment`` and ``_moments``, which need numpy and scipy
only; the tests hold the two to the same catalogue. The tables are
pandas DataFrames, persisted as CSV, and pandas is imported by the
functions that make or read them.
"""

import numpy as np
from scipy import ndimage


def _segment(image, variance_map, threshold, min_area):
    """Label pixels above threshold*sigma; returns (labels_kept, seg_map).

    seg_map uses 0 for background, like sep's segmentation map.
    """
    sigma = np.sqrt(np.maximum(variance_map, 0.0))
    detect = image > threshold * sigma
    # 8-connectivity, as sep and the JAX package's C++ extractor label
    seg, n_raw = ndimage.label(detect, structure=np.ones((3, 3)))
    if n_raw == 0:
        return [], seg
    counts = ndimage.sum_labels(np.ones_like(seg), seg,
                                index=np.arange(1, n_raw + 1))
    kept = [lab for lab, c in zip(range(1, n_raw + 1), counts)
            if c >= min_area]
    return kept, seg


def _moments(image, seg, labels):
    """Per-object flux, flux-weighted centroid and second-moment axes.

    The JAX package's sums over the whole frame, taken on each object's
    bounding box: O(pixels) and not O(objects x pixels), which costs
    ~0.2 s an object on a 2048 px frame. The weight sum ``flux`` is still
    taken over a whole-frame array, as JAX's, so it keeps its float32
    bits; the float64 sums over the box equal the frame's to rounding.
    """
    rows = []
    boxes = ndimage.find_objects(seg)
    frame = None
    for lab in labels:
        box = boxes[lab - 1]
        sel = seg[box] == lab
        part = image[box]
        w = np.where(sel, np.maximum(part, 0.0), 0.0)
        if frame is None:
            frame = np.zeros(image.shape, w.dtype)
        frame[box] = w
        flux = frame.sum()
        frame[box] = 0
        if flux <= 0:
            continue
        yy, xx = np.mgrid[box]
        x = (w * xx).sum() / flux
        y = (w * yy).sum() / flux
        x2 = (w * (xx - x) ** 2).sum() / flux
        y2 = (w * (yy - y) ** 2).sum() / flux
        xy = (w * (xx - x) * (yy - y)).sum() / flux
        # principal axes of the 2nd-moment tensor (sep's a/b convention)
        t = 0.5 * (x2 + y2)
        d = np.sqrt(max(0.25 * (x2 - y2) ** 2 + xy**2, 0.0))
        a = np.sqrt(max(t + d, 1e-12))
        b = np.sqrt(max(t - d, 1e-12))
        rows.append({
            "x": x, "y": y, "flux": float(part[sel].sum()),
            "a": a, "b": b, "npix": int(sel.sum()),
            "peak": float(part[sel].max()),
        })
    return rows


def postprocess_detections(sources):
    """Star-likeness filter, derived columns, flux-descending order:
    centroid aliases, the ``elongation <= median + 3 std`` point-source
    filter, the ``FWHM = 2 sqrt(ln2 (a^2 + b^2))`` estimate, ellipticity.
    """
    sources = sources.copy()
    sources["xcentroid"] = sources["x"]
    sources["ycentroid"] = sources["y"]
    elongation = sources["a"] / sources["b"]
    sources["elongation"] = elongation
    if len(sources):
        # drop weirdly elongated detections (not star-like).  <= and not
        # the reference's strict < (reference star_extraction.py:37-41):
        # with a single detection (or all-equal elongations) std is 0
        # and the strict comparison discards EVERY source
        sources = sources[
            elongation <= elongation.median() + 3 * elongation.std(ddof=0)]
    sources["FWHM"] = 2.0 * np.sqrt(
        np.log(2.0) * (sources["a"] ** 2 + sources["b"] ** 2))
    sources["ellipticity"] = 1.0 - sources["b"] / sources["a"]
    return sources.sort_values(
        "flux", ascending=False).reset_index(drop=True)


def extract_stars(image_background_subtracted, variance_map,
                  detection_threshold=3, min_area=10, debug_plot_path=None):
    """Detect point-ish sources; returns a DataFrame, brightest first.

    The C++ flood-fill extractor of ``native/`` when it loads, else
    :func:`_segment` and :func:`_moments`. With ``debug_plot_path`` the
    image is plotted there with the sources circled.
    """
    import pandas as pd

    from ..native import extract_sources

    image = np.asarray(image_background_subtracted, dtype=np.float32)
    columns = ["x", "y", "flux", "a", "b", "npix", "peak"]
    rows = extract_sources(image, variance_map, detection_threshold,
                           min_area)
    if rows is not None:
        sources = pd.DataFrame(rows[:, :7], columns=columns)
    else:
        labels, seg = _segment(image, variance_map, detection_threshold,
                               min_area)
        sources = pd.DataFrame(_moments(image, seg, labels),
                               columns=columns)
    sources = postprocess_detections(sources)

    if debug_plot_path is not None:
        from ..plotting.sources_plotting import plot_sources

        debug_plot_path.parent.mkdir(exist_ok=True, parents=True)
        plot_sources(sources=sources, image=image,
                     save_path=debug_plot_path)
    return sources


def write_sources(sources, path):
    """Persist a sources table (CSV; the reference used FITS tables)."""
    sources.to_csv(path, index=False)


def read_sources(path):
    import pandas as pd

    return pd.read_csv(path)


def extract_sources_from_sky_sub_image(image_path, sources_path,
                                       detection_threshold, min_area,
                                       exptime,
                                       background_rms_electron_per_second,
                                       debug_plot_path):
    """Re-extraction on an already sky-subtracted stored frame.

    Works in electrons (exptime times the stored e-/s frame), while the
    import extracts on the e-/s frame: re-extracted fluxes differ from
    the import's by the frame's exptime. The sources' flux only orders
    them (brightest first), and the detection SNR does not depend on the
    scale.
    """
    from ..io.fits import read_fits

    data, _ = read_fits(image_path)
    image_electrons = exptime * np.asarray(data, dtype=float)
    rms_e = exptime * background_rms_electron_per_second
    variance_map = rms_e**2 + np.abs(image_electrons)
    sources = extract_stars(image_electrons, variance_map,
                            detection_threshold=detection_threshold,
                            min_area=min_area,
                            debug_plot_path=debug_plot_path)
    write_sources(sources, sources_path)
