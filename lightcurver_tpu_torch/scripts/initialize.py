"""Scaffold a working directory: a copy of
``lightcurver_tpu/scripts/initialize.py`` (``lc_init``), writing the port's
copy of the template config.

Usage:
    python -m lightcurver_tpu_torch.scripts.initialize --workdir DIR
        [--roi_name N --roi_ra RA --roi_dec DEC --photom_band B]

Copies the template config, writes a stub header parser, and fills in the
ROI interactively or from arguments. PyYAML is imported when it runs.
"""

import argparse
import json
import re
from pathlib import Path


def _q(value):
    """Quote a scalar for literal YAML splicing.

    json.dumps gives a double-quoted string that YAML 1.1 parses back
    verbatim — an UNQUOTED name like 'NO', '2023' or 'M31 #field'
    would otherwise come back as a boolean/int/comment-truncated key.
    """
    return json.dumps(str(value))


def _fill_template(text, workdir, roi_name, roi_ra, roi_dec, band):
    """Substitute the scaffold values into the template TEXT, keeping
    every comment intact (the reference uses a ruamel round-trip for
    the same reason, reference scripts/initialize.py:70-88; ruamel is
    not available here, so the few keys are edited in place)."""
    # replacements go through lambdas so user values are literal text,
    # never backreference patterns
    text, n = re.subn(r"(?m)^workdir:.*$",
                      lambda m: f"workdir: {_q(workdir)}", text, count=1)
    if n != 1:
        raise RuntimeError("template lost its workdir key")
    roi_block = (f"ROI:\n  {_q(roi_name)}:\n"
                 f"    coordinates: [{float(roi_ra)}, {float(roi_dec)}]"
                 "   # [ra, dec] degrees\n")
    text, n = re.subn(r"(?m)^ROI:\n(?:[ \t]+\S.*\n)+",
                      lambda m: roi_block, text, count=1)
    if n != 1:
        raise RuntimeError("template lost its ROI block")
    text, n = re.subn(r"(?m)^photometric_band:.*$",
                      lambda m: f"photometric_band: {_q(band)}",
                      text, count=1)
    if n != 1:
        raise RuntimeError("template lost its photometric_band key")
    return text

_TEMPLATE = (Path(__file__).parent.parent / "pipeline"
             / "example_config_file" / "config.yaml")

_HEADER_PARSER_STUB = '''\
def parse_header(header):
    raise RuntimeError('Adjust the header parser function at {path}')
    # example:
    # exptime = header['EXPTIME']
    # gain = header['GAIN']
    # mjd = header['MJD-OBS']
    # return {{'exptime': exptime, 'gain': gain, 'mjd': mjd}}
'''


def initialize():
    import yaml

    parser = argparse.ArgumentParser(
        description="Initialize a lightcurver_tpu working directory.")
    parser.add_argument("--workdir", type=str, default=".",
                        help="Path to the desired working directory.")
    parser.add_argument("--roi_name", type=str, default=None)
    parser.add_argument("--roi_ra", type=float, default=None)
    parser.add_argument("--roi_dec", type=float, default=None)
    parser.add_argument("--photom_band", type=str, default=None)
    args = parser.parse_args()

    workdir = Path(args.workdir).absolute()
    workdir.mkdir(exist_ok=True, parents=True)
    print(f"Initializing working directory at {workdir}")

    config_path = workdir / "config.yaml"
    config_path.write_text(_TEMPLATE.read_text())

    parser_dir = workdir / "header_parser"
    parser_dir.mkdir(exist_ok=True)
    parser_file = parser_dir / "parse_header.py"
    parser_file.write_text(_HEADER_PARSER_STUB.format(path=parser_file))

    if args.roi_name is None:
        args.roi_name = input("Name of the target? ").strip()
    if args.roi_ra is None:
        args.roi_ra = float(input("Right ascension of the target? "))
    if args.roi_dec is None:
        args.roi_dec = float(input("Declination of the target? "))
    if args.photom_band is None:
        args.photom_band = input(
            "Photometric band of the observations? ").strip()

    filled = _fill_template(_TEMPLATE.read_text(), workdir,
                            args.roi_name, args.roi_ra, args.roi_dec,
                            args.photom_band)
    # sanity: the comment-preserving substitution must still parse and
    # carry exactly the values the user gave.  Real raises, not asserts
    # (python -O would otherwise write a silently corrupted config)
    parsed = yaml.safe_load(filled)
    expected_roi = {args.roi_name:
                    {"coordinates": [args.roi_ra, args.roi_dec]}}
    if (parsed["workdir"] != str(workdir)
            or parsed["ROI"] != expected_roi
            or parsed["photometric_band"] != args.photom_band):
        raise RuntimeError(
            "filled config does not round-trip the given values "
            f"(got workdir={parsed['workdir']!r}, ROI={parsed['ROI']!r}, "
            f"band={parsed['photometric_band']!r}); config.yaml keeps "
            "the template values — fill it in manually")
    config_path.write_text(filled)
    print(f"Adapt the header parser at {parser_file}.")
    print(f"Prepared rough configuration at {config_path} -- refine it.")


if __name__ == "__main__":
    initialize()
