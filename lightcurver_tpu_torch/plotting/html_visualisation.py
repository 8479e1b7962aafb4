"""Self-contained interactive HTML light-curve report: a copy of
``lightcurver_tpu/plotting/html_visualisation.py``.

Injects the photometry table as JSON into a vanilla-JS/SVG template
(``plot_curves_template.html``, byte for byte the JAX package's).
"""

import json
from pathlib import Path

import numpy as np

_TEMPLATE_PATH = Path(__file__).parent / "plot_curves_template.html"


def generate_lightcurve_html(df, out_path):
    """Write an interactive HTML plot of per-source magnitudes vs MJD."""
    # a single non-finite MJD would make the JS extent() NaN and blank
    # the whole SVG (the matplotlib path filters these too)
    df = df[np.isfinite(np.asarray(df["mjd"], dtype=float))]
    from ..utilities.lightcurves_postprocessing import _point_source_names

    sources = sorted(_point_source_names(df.columns, suffix="_mag"))
    payload = {"mjd": [float(v) for v in df["mjd"]], "sources": {}}
    for ps in sources:
        mags = [None if not np.isfinite(v) else float(v)
                for v in df[f"{ps}_mag"]]
        errs_col = f"{ps}_d_mag"
        errs = ([None if not np.isfinite(v) else float(v)
                 for v in df[errs_col]] if errs_col in df.columns
                else [None] * len(mags))
        payload["sources"][ps] = {"mag": mags, "err": errs}
    html = _TEMPLATE_PATH.read_text()
    html = html.replace("/*__LIGHTCURVE_DATA__*/",
                        f"const DATA = {json.dumps(payload)};")
    Path(out_path).write_text(html)
