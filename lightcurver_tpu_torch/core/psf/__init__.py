"""Narrow-PSF fitting (twin of ``lightcurver_tpu/core/psf``).

Entry points: :func:`.build.build_psf` (one frame) and
:func:`.batched.build_psf_batched` (many frames at once);
:func:`.distortion.apply_distortion` evaluates a fitted field-varying PSF.
"""
