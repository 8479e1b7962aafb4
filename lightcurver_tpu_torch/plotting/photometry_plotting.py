"""Publication-style multi-season light-curve plot: a copy of
``lightcurver_tpu/plotting/photometry_plotting.py``.

User-facing (not called by the pipeline), with feature parity with the
reference's plot (reference plotting/photometry_plotting.py:12-292):
scatter-weighted curve offsets, season panels with widths proportional
to season duration, hidden inner spines with axis-break indicators,
error bars optionally averaged with the nightly scatter columns, and
the legend placed in the longest season.
"""

import numpy as np

from . import pyplot

SEASON_PAD = 20.0  # days
COLOR_CYCLE = ["royalblue", "crimson", "darkorange", "forestgreen",
               "purple"]


def find_sources(df):
    """Source labels with magnitude (and error) columns in ``df``.

    A source qualifies with a ``{ps}_mag`` column.  Error columns (the
    asymmetric ``{ps}_d_mag_down``/``{ps}_d_mag_up`` pair of the
    pipeline CSV, utilities/lightcurves_postprocessing, or a symmetric
    ``{ps}_d_mag``) are optional — ``_errors`` falls back to zero-width
    bars, so error-less dataframes still plot.
    """
    # shared derived-column rule: count('_') == 1 (the reference's
    # heuristic, reference plotting/photometry_plotting.py:12) drops
    # underscore labels like 'QSO_A' that the rest of this pipeline
    # explicitly supports
    from ..utilities.lightcurves_postprocessing import _point_source_names

    return sorted(_point_source_names(df.columns, suffix="_mag"))


def measure_scatter(mags):
    """Robust scatter of a magnitude series: 90th - 10th percentile."""
    mags = np.asarray(mags, dtype=float)
    mags = mags[np.isfinite(mags)]
    if mags.size == 0:
        return 0.0
    return float(np.percentile(mags, 90) - np.percentile(mags, 10))


def compute_offsets(df, sources, separation=0.3):
    """Scatter-weighted vertical offsets separating the curves.

    The brightest source (lowest median magnitude) anchors at offset 0;
    each subsequent source is shifted below the previous one by the
    difference of medians plus ``separation`` times the sum of the two
    curves' scatters, cumulatively — curves never overlap even when
    their variability amplitudes differ (mirrors the reference's
    compute_offsets behavior).
    """
    medians = {}
    for ps in sources:
        mags = np.asarray(df[f"{ps}_mag"], dtype=float)
        if np.isfinite(mags).any():
            medians[ps] = float(np.nanmedian(mags))
    # sources with no finite magnitude at all have nothing to separate
    # from: keep them at offset 0 and leave them out of the chain (they
    # draw no points anyway)
    offsets = {ps: 0.0 for ps in sources}
    ordered = sorted(medians, key=medians.get)
    for prev, curr in zip(ordered[:-1], ordered[1:]):
        sep = separation * (measure_scatter(df[f"{prev}_mag"])
                            + measure_scatter(df[f"{curr}_mag"]))
        offsets[curr] = (medians[prev] - medians[curr]) + sep \
            + offsets[prev]
    return offsets


def find_segments(mjd, gap_threshold):
    """(start, end) MJD of each observing season, split at gaps.

    Non-finite epochs (a frame whose header lacked MJD) are ignored —
    they cannot be placed on the time axis.
    """
    mjd = np.asarray(mjd, dtype=float)
    mjd = np.sort(np.unique(mjd[np.isfinite(mjd)]))
    if mjd.size == 0:
        return []
    gaps = np.flatnonzero(np.diff(mjd) > gap_threshold)
    bounds = np.concatenate([[-1], gaps, [len(mjd) - 1]])
    return [(mjd[lo + 1], mjd[hi])
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def _add_break_indicator(ax, width_ratio, left=True, right=True):
    """Small gray diagonals marking a broken (elided) time axis."""
    d = 0.008
    dw = 0.4 * d / max(width_ratio, 1e-3)
    kwargs = dict(transform=ax.transAxes, color="gray", clip_on=False)
    if right:
        ax.plot((1 - dw, 1 + dw), (-d, +d), **kwargs)
        ax.plot((1 - dw, 1 + dw), (1 - d, 1 + d), **kwargs)
    if left:
        ax.plot((-dw, dw), (-d, +d), **kwargs)
        ax.plot((-dw, dw), (1 - d, 1 + d), **kwargs)


def _errors(segment, ps):
    """(down, up) error arrays; scatter-averaged when available."""
    if f"{ps}_d_mag_down" in segment.columns:
        down = np.asarray(segment[f"{ps}_d_mag_down"], dtype=float)
        up = np.asarray(segment[f"{ps}_d_mag_up"], dtype=float)
        # average the fit uncertainty with the nightly scatter when the
        # grouped CSV provides it (reference behavior)
        if f"{ps}_scatter_mag_down" in segment.columns:
            down = 0.5 * (down + np.asarray(
                segment[f"{ps}_scatter_mag_down"], dtype=float))
        if f"{ps}_scatter_mag_up" in segment.columns:
            up = 0.5 * (up + np.asarray(
                segment[f"{ps}_scatter_mag_up"], dtype=float))
        return np.nan_to_num(down), np.nan_to_num(up)
    if f"{ps}_d_mag" in segment.columns:
        err = np.nan_to_num(np.asarray(segment[f"{ps}_d_mag"],
                                       dtype=float))
        return err, err
    zeros = np.zeros(len(segment))
    return zeros, zeros


def plot_photometry(df, sources=None, offsets=None, season_gap_days=70.0,
                    save_path=None, figsize=None, plot_title=None):
    """Multi-season publication plot of the photometry DataFrame/CSV.

    Args:
        df: DataFrame, or path to the pipeline photometry CSV.
        sources: subset of source labels (default: all found).
        offsets: {source: magnitude offset} (default: scatter-weighted
            automatic offsets, brightest at 0).
        season_gap_days: gaps larger than this split the time axis into
            proportional-width panels with break indicators.
        save_path: written (and the figure closed) when given.
        figsize: default scales with the number of seasons.
        plot_title: optional suptitle.

    Returns:
        the matplotlib figure.
    """
    plt = pyplot()
    import matplotlib.gridspec as gridspec

    if isinstance(df, (str, bytes)) or hasattr(df, "__fspath__"):
        import pandas as pd

        df = pd.read_csv(df)
    if sources is None:
        sources = find_sources(df)
    if not sources:
        raise ValueError("no photometry sources found in the dataframe")
    if offsets is None:
        offsets = compute_offsets(df, sources)

    segments = find_segments(df["mjd"], season_gap_days)
    if not segments:
        raise ValueError("no finite 'mjd' values in the dataframe")
    durations = [max(end - start, 1.0) + 2 * SEASON_PAD
                 for start, end in segments]
    total = float(sum(durations))
    width_ratios = [dur / total for dur in durations]
    legend_at = int(np.argmax(durations))
    n_seg = len(segments)

    if figsize is None:
        figsize = (max(8.0, 3.0 + 3.0 * n_seg), 5.0)
    fig = plt.figure(figsize=figsize)
    gs = gridspec.GridSpec(1, n_seg, width_ratios=width_ratios,
                           figure=fig, wspace=0.06)
    ax0 = fig.add_subplot(gs[0])
    axes = [ax0] + [fig.add_subplot(gs[i], sharey=ax0)
                    for i in range(1, n_seg)]

    def _brightness(ps):
        mags = np.asarray(df[f"{ps}_mag"], dtype=float)
        if not np.isfinite(mags).any():
            return np.inf   # nothing to draw; order last
        return float(np.nanmedian(mags))

    ordered = sorted(sources, key=_brightness)
    for i, ((start, end), ax) in enumerate(zip(segments, axes)):
        mask = (df["mjd"] >= start) & (df["mjd"] <= end)
        segment = df[mask]
        for j, ps in enumerate(ordered):
            color = COLOR_CYCLE[j % len(COLOR_CYCLE)]
            mags = np.asarray(segment[f"{ps}_mag"], dtype=float) \
                + offsets[ps]
            down, up = _errors(segment, ps)
            ax.errorbar(np.asarray(segment["mjd"], dtype=float), mags,
                        yerr=[down, up], fmt="o", ms=3, color=color,
                        ecolor=color, alpha=0.7, elinewidth=0.4,
                        label=ps if i == legend_at else None)
        ax.set_xlim(start - SEASON_PAD, end + SEASON_PAD)
        ax.tick_params(direction="in", which="both", top=True)
        if n_seg == 1:
            ax.tick_params(right=True)
            ax.set_ylabel("magnitude (+ offsets)")
        else:
            # hide the inner spines; keep the outer ones, mark breaks
            ax.spines["left"].set_visible(False)
            ax.spines["right"].set_visible(False)
            ax.yaxis.set_visible(False)
            if i == 0:
                ax.spines["left"].set_visible(True)
                ax.yaxis.set_visible(True)
                ax.tick_params(axis="y", which="both", left=True)
                ax.set_ylabel("magnitude (+ offsets)")
                _add_break_indicator(ax, width_ratios[i], left=False)
            elif i == n_seg - 1:
                ax.spines["right"].set_visible(True)
                ax.tick_params(axis="y", which="both", right=True,
                               labelright=False, left=False)
                _add_break_indicator(ax, width_ratios[i], right=False)
            else:
                _add_break_indicator(ax, width_ratios[i])
            plt.setp(ax.get_yticklabels(), visible=(i == 0))
        ax.set_xlabel("MJD")
    ax0.invert_yaxis()
    axes[legend_at].legend(loc="best", fontsize=9)
    if plot_title:
        fig.suptitle(plot_title)
    if save_path is not None:
        fig.savefig(save_path, dpi=130, bbox_inches="tight")
        plt.close(fig)
    return fig
