"""User-config loading and the key check: a copy of ``get_user_config``
and ``compare_config_with_pipeline_delivered_one`` of
``lightcurver_tpu/structure/user_config.py``.

One YAML file, addressed by the ``LIGHTCURVER_CONFIG`` environment
variable and loaded fresh by every task, with the same derived keys and
defaults as the JAX package's. Its keys are checked against the port's
copy of the example config (``pipeline/example_config_file/config.yaml``).
PyYAML is imported when a config is read, so the module imports on a
machine without it.
"""

import os
from pathlib import Path

from .exceptions import NoConfigFilePathInEnvironment
from ..utilities.coordinates import SkyCoord

_GAIA_BANDS = ("r_sdss", "i_sdss", "g_sdss", "V", "R", "Ic", "B_T", "V_T")


def _as_name_list(value):
    """'abcd' -> ['a','b','c','d']; 'aa,ab' -> ['aa','ab'];
    lists/None pass through."""
    if isinstance(value, str):
        if "," in value:
            return [v.strip() for v in value.split(",") if v.strip()]
        return list(value)
    return value


def get_user_config():
    """Load, derive and return the configuration dictionary."""
    import yaml

    if "LIGHTCURVER_CONFIG" not in os.environ:
        raise NoConfigFilePathInEnvironment
    with open(os.environ["LIGHTCURVER_CONFIG"]) as f:
        config = yaml.safe_load(f)

    # ROI: single-entry mapping name -> {coordinates: [ra, dec]}
    roi_name = list(config["ROI"].keys())[0]
    config["roi_name"] = roi_name
    ra, dec = config["ROI"][roi_name]["coordinates"]
    config["ROI_ra_deg"] = ra
    config["ROI_dec_deg"] = dec
    config["ROI_SkyCoord"] = SkyCoord(ra, dec)

    if "raw_dirs" not in config:
        raise KeyError("config: 'raw_dirs' is missing")
    raw = config["raw_dirs"]
    config["raw_dirs"] = ([Path(p) for p in raw] if isinstance(raw, list)
                          else [Path(raw)])

    if "workdir" not in config:
        raise KeyError("config: 'workdir' is missing")
    workdir = Path(config["workdir"])
    config["workdir"] = workdir
    config["database_path"] = workdir / "database.sqlite3"
    config["plots_dir"] = workdir / "plots"
    config["logs_dir"] = workdir / "logs"
    config["frames_dir"] = workdir / "frames"
    config["regions_path"] = workdir / "regions.h5"
    config["psfs_path"] = workdir / "psfs.h5"
    # a user-provided override arrives as a YAML string
    if config.get("prepared_roi_cutouts_path"):
        config["prepared_roi_cutouts_path"] = Path(
            config["prepared_roi_cutouts_path"])
    for d in ("plots_dir", "logs_dir", "frames_dir"):
        config[d].mkdir(parents=True, exist_ok=True)

    for key in ("stars_to_use_psf", "stars_to_use_norm",
                "stars_to_exclude_psf", "stars_to_exclude_norm"):
        config[key] = _as_name_list(config[key])

    band = config["photometric_band"]
    if band in _GAIA_BANDS:
        config["reference_absolute_photometric_survey"] = "gaia"
    elif "panstarrs" in band:
        if dec < -30.5:
            raise RuntimeError(
                "With this declination, it is unlikely you will find "
                "pan-starrs magnitudes for absolute calibration.")
        config["reference_absolute_photometric_survey"] = "panstarrs"
    else:
        raise RuntimeError(
            f"Config check: not a photometric band we implemented: {band}")

    config.setdefault("constraints_on_frame_columns_for_roi", {})
    config.setdefault("constraints_on_normalization_coeff", {})
    config.setdefault("fix_point_source_astrometry", False)
    config.setdefault("deconv_checkpoint_every", 0)
    config.setdefault("psf_do_plots", 1)
    config.setdefault("star_fit_batch_size", 32)
    # absent key == null: the ROI tasks derive the workdir default
    config.setdefault("prepared_roi_cutouts_path", None)
    # the PSF fit's matmul-DFT padding: 16, or 4 s where s is larger
    config.setdefault(
        "psf_dft_pad", max(16, 4 * int(config.get("subsampling_factor", 2))))
    config["checkpoints_dir"] = workdir / "checkpoints"
    return config


def compare_config_with_pipeline_delivered_one():
    """Set-difference of user config keys vs the shipped example config."""
    import yaml

    if "LIGHTCURVER_CONFIG" not in os.environ:
        raise NoConfigFilePathInEnvironment
    with open(os.environ["LIGHTCURVER_CONFIG"]) as f:
        user = yaml.safe_load(f)

    template_path = (Path(__file__).parent.parent / "pipeline"
                     / "example_config_file" / "config.yaml")
    with open(template_path) as f:
        template = yaml.safe_load(f)

    user_keys, template_keys = set(user), set(template)
    missing = template_keys - user_keys
    return {
        "extra_keys_in_user_config": user_keys - template_keys,
        "extra_keys_in_pipeline_config": missing,
        "pipeline_extra_keys_values": {k: template[k] for k in missing},
    }
