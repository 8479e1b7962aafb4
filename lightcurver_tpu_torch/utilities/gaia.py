"""Gaia star-catalog queries, TAP/ADQL over HTTP: a copy of
``lightcurver_tpu/utilities/gaia.py``.

The provider choice (the Gaia archive or VizieR's TAP, with VizieR's
columns renamed) and the WHERE clauses of the config's quality cuts.
Results are pandas DataFrames with the Gaia archive's column names,
lowercased; pandas is imported when a query runs.

Offline: with ``LIGHTCURVER_GAIA_FIXTURE`` set to a CSV path, every query
returns that file's content and no request is made.
"""

import io
import os
import urllib.parse
import urllib.request
import warnings

import numpy as np

GAIA_TAP_URL = "https://gea.esac.esa.int/tap-server/tap/sync"
VIZIER_TAP_URL = "https://TAPVizieR.cds.unistra.fr/TAPVizieR/tap/sync"

vizier_to_gaia_column_mapping = {
    "RA_ICRS": "ra",
    "DE_ICRS": "dec",
    "Gmag": "phot_g_mean_mag",
    "RPmag": "phot_rp_mean_mag",
    "BPmag": "phot_bp_mean_mag",
    "pmRA": "pmra",
    "pmDE": "pmdec",
    "Source": "source_id",
    "sepsi": "astrometric_excess_noise_sig",
    "RFG": "phot_g_mean_flux_over_error",
}
gaia_to_vizier_column_mapping = {
    v: k for k, v in vizier_to_gaia_column_mapping.items()}


def construct_where_conditions(gaia_provider,
                               astrometric_excess_noise_max=None,
                               gmag_range=None,
                               min_phot_g_mean_flux_over_error=None):
    """WHERE fragments + table name for the quality cuts in the config."""
    gaia_provider = gaia_provider.lower()
    assert gaia_provider in ("gaia", "vizier"), \
        "gaia_provider must be either 'gaia' or 'vizier'"
    if gaia_provider == "gaia":
        query_table = "gaiadr3.gaia_source as gdr3 "
    else:
        query_table = '"I/355/gaiadr3" AS gdr3 '

    def col(name):
        return (gaia_to_vizier_column_mapping[name]
                if gaia_provider == "vizier" else name)

    where = []
    if astrometric_excess_noise_max is not None:
        where.append(f"gdr3.{col('astrometric_excess_noise_sig')} "
                     f"< {astrometric_excess_noise_max}")
    if gmag_range is not None:
        where.append(f"gdr3.{col('phot_g_mean_mag')} BETWEEN "
                     f"{gmag_range[0]} AND {gmag_range[1]}")
    if min_phot_g_mean_flux_over_error is not None:
        where.append(f"gdr3.{col('phot_g_mean_flux_over_error')} "
                     f"> {min_phot_g_mean_flux_over_error}")
    return where, query_table


def _tap_sync_csv(url, adql_query, timeout=120):
    """POST a synchronous TAP query, parse the CSV response."""
    import pandas as pd

    payload = urllib.parse.urlencode({
        "REQUEST": "doQuery", "LANG": "ADQL", "FORMAT": "csv",
        "QUERY": adql_query,
    }).encode()
    with urllib.request.urlopen(url, data=payload,
                                timeout=timeout) as response:
        return pd.read_csv(io.BytesIO(response.read()))


def run_query(gaia_provider, adql_query):
    """Run an ADQL query; returns a DataFrame in Gaia column conventions."""
    import pandas as pd

    fixture = os.environ.get("LIGHTCURVER_GAIA_FIXTURE")
    if fixture:
        return pd.read_csv(fixture)

    gaia_provider = gaia_provider.lower()
    if gaia_provider == "gaia":
        result = _tap_sync_csv(GAIA_TAP_URL, adql_query)
    elif gaia_provider == "vizier":
        result_vizier = _tap_sync_csv(VIZIER_TAP_URL, adql_query)
        result = pd.DataFrame()
        for vizier_col, gaia_col in vizier_to_gaia_column_mapping.items():
            if vizier_col in result_vizier.columns:
                result[gaia_col] = result_vizier[vizier_col]
        # VizieR does not provide the reference epoch; DR3 is 2016.0
        result["ref_epoch"] = np.full(len(result), 2016.0)
        if "gaiadr3" not in adql_query:
            # warn, do not raise: the reference raises FutureWarning here
            # (reference utilities/gaia.py:130), discarding a result the
            # network already delivered
            warnings.warn(
                "Using VizieR and 2016 as ref epoch, but not Gaia DR3.",
                FutureWarning)
    else:
        raise RuntimeError("gaia_provider must be 'gaia' or 'vizier'")
    return result


def find_gaia_stars(region_type, *args, **kwargs):
    """Query Gaia stars in a 'circle' or 'polygon' region."""
    if region_type.lower() == "circle":
        stars = find_gaia_stars_in_circle(*args, **kwargs)
    elif region_type.lower() == "polygon":
        stars = find_gaia_stars_in_polygon(*args, **kwargs)
    else:
        raise ValueError("region_type must be either 'Circle' or 'Polygon'")
    stars.columns = [c.lower() for c in stars.columns]
    return stars


def find_gaia_stars_in_circle(center_radius, gaia_provider="gaia",
                              astrometric_excess_noise_max=None,
                              gmag_range=None,
                              min_phot_g_mean_flux_over_error=None):
    """Cone query: center_radius = {'center': (ra, dec), 'radius': deg}."""
    where, table = construct_where_conditions(
        gaia_provider, astrometric_excess_noise_max, gmag_range,
        min_phot_g_mean_flux_over_error)
    (ra, dec), radius = center_radius["center"], center_radius["radius"]
    ra_col, dec_col = ("ra", "dec") if gaia_provider != "vizier" else (
        gaia_to_vizier_column_mapping["ra"],
        gaia_to_vizier_column_mapping["dec"])
    where.append(f"1=CONTAINS(POINT('ICRS', gdr3.{ra_col}, gdr3.{dec_col}),"
                 f" CIRCLE('ICRS', {ra}, {dec}, {radius}))")
    query = f"SELECT * FROM {table} WHERE {' AND '.join(where)}"
    return run_query(gaia_provider, query)


def find_gaia_stars_in_polygon(vertices, gaia_provider="gaia",
                               astrometric_excess_noise_max=None,
                               gmag_range=None,
                               min_phot_g_mean_flux_over_error=None):
    """Polygon query: vertices = [(ra, dec), ...]."""
    where, table = construct_where_conditions(
        gaia_provider, astrometric_excess_noise_max, gmag_range,
        min_phot_g_mean_flux_over_error)
    # footprint vertices may be unwrapped outside [0, 360) (continuous
    # around the field center, utilities/footprint.unwrap_ra); ADQL
    # POLYGON is spherical, so re-wrap for the service
    poly = ", ".join(f"{float(ra) % 360.0},{dec}" for ra, dec in vertices)
    ra_col, dec_col = ("ra", "dec") if gaia_provider != "vizier" else (
        gaia_to_vizier_column_mapping["ra"],
        gaia_to_vizier_column_mapping["dec"])
    where.append(f"1=CONTAINS(POINT('ICRS', gdr3.{ra_col}, gdr3.{dec_col}),"
                 f" POLYGON('ICRS', {poly}))")
    query = f"SELECT * FROM {table} WHERE {' AND '.join(where)}"
    return run_query(gaia_provider, query)
