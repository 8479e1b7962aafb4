"""lightcurver_tpu_torch: the joint ROI deconvolution, the narrow-PSF fit
and the star-batched photometry in PyTorch, for CUDA, with the pipeline
tasks from PSF modelling to the ROI model.

A port of ``lightcurver_tpu`` (JAX) to PyTorch. The layout mirrors the
JAX package (``core/``, ``core/deconv/``, ``core/psf/``, ``ops/``,
``processes/``, ``io/``, ``structure/``, ``utilities/``); ``csrc/`` holds
the hand-written CUDA kernels. Each module names its JAX counterpart in
its docstring, and the tests hold every module against that counterpart
on the CPU. The host modules (``io/``, ``structure/``, most of
``utilities/``) are copies of only the functions the port calls.

At import the package needs torch, numpy, scipy and the standard library
only: never ``jax`` and never ``lightcurver_tpu``, so it runs on a machine
that has neither. The pipeline tasks import h5py, pandas and PyYAML when
they run.

Numerics: float32 throughout, with TF32 off for matmuls and cuDNN
(``ops.enforce_fp32``, called by every entry point).

Numbers: every time quoted in this package's comments and in PERF.md was
taken on an NVIDIA H100 and carries the card's name and power limit as
``nvidia-smi`` reports them. No TPU figure applies to this package.

Entry points, each on the card unless the caller passes ``device="cpu"``:

- the pipeline tasks, named as the JAX package's, from a workdir stamped
  up to ``stamp_extraction``:
  :func:`lightcurver_tpu_torch.processes.psf_modelling.model_all_psfs`,
  :func:`lightcurver_tpu_torch.processes.star_photometry.do_star_photometry`,
  ``normalization_calculation.calculate_coefficient`` and
  ``absolute_zeropoint_calculation.calculate_zeropoints`` (host only),
  :func:`lightcurver_tpu_torch.processes.roi_file_preparation.prepare_roi_file`
  and
  :func:`lightcurver_tpu_torch.processes.roi_modelling.do_modelling_of_roi`,
  the ROI task (config, prepared-ROI HDF5 in; light curves, astrometry
  and FITS products out);
- :func:`lightcurver_tpu_torch.processes.roi_modelling.fit_roi`, the
  joint ROI deconvolution on arrays, its stage 2 optionally checkpointed;
- :func:`lightcurver_tpu_torch.core.psf.build.build_psf`, the narrow PSF
  of one frame;
- :func:`lightcurver_tpu_torch.core.psf.batched.build_psf_batched`, the
  narrow PSFs of many frames at once;
- :func:`lightcurver_tpu_torch.core.deconv.batched.fit_stars_batched`, the
  joint photometry of a bucket of stars at once.
"""

__version__ = "0.1.0"
