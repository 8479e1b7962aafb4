"""lightcurver_tpu_torch: the joint ROI deconvolution, the narrow-PSF fit
and the star-batched photometry in PyTorch, for CUDA, with the whole
12-task pipeline around them, from raw frames to the light curves.

A port of ``lightcurver_tpu`` (JAX) to PyTorch. The layout mirrors the
JAX package (``core/``, ``core/deconv/``, ``core/psf/``, ``ops/``,
``parallel/``, ``pipeline/``, ``processes/``, ``io/``, ``structure/``,
``utilities/``, ``plotting/``, ``scripts/``);
``csrc/`` holds the hand-written CUDA kernels. Each module names its JAX
counterpart in its docstring, and the tests hold every module against
that counterpart on the CPU. The host modules (``io/``, ``structure/``,
``pipeline/``, ``plotting/``, ``scripts/``, most of ``utilities/``) are
copies of the functions the port calls; the front's numerics are the
numpy/scipy twins of the JAX package's host C++.

At import the package needs torch, numpy, scipy and the standard library
only: never ``jax`` and never ``lightcurver_tpu``, so it runs on a machine
that has neither. The pipeline tasks import h5py, pandas and PyYAML (and
the nova.astrometry.net client ``requests``) when they run, and the plots
matplotlib when they are made.

Numerics: float32 throughout, with TF32 off for matmuls and cuDNN
(``ops.enforce_fp32``, called by every entry point).

Numbers: every time quoted in this package's comments and in PERF.md was
taken on an NVIDIA H100 and carries the card's name and power limit as
``nvidia-smi`` reports them. No TPU figure applies to this package.

Entry points, each on the card unless the caller passes ``device="cpu"``:

- the pipeline, ``python -m lightcurver_tpu_torch.scripts.run config.yaml
  [--start X] [--stop Y] [--device cuda|cpu] [--irfft-backend
  fft|matmul]``, or
  :class:`lightcurver_tpu_torch.pipeline.workflow_manager.WorkflowManager`
  ``(device="cuda", irfft_backend="fft").run(start_step, stop_step)``:
  the twelve tasks below in the JAX package's order, with its config
  check, plate-solving strategy and post-check (``python -m
  lightcurver_tpu_torch.scripts.initialize`` scaffolds a workdir);
- the front's pipeline tasks, named as the JAX package's, host only, from
  raw FITS frames to the stamped ``regions.h5``:
  :func:`lightcurver_tpu_torch.structure.database.initialize_database`,
  :func:`lightcurver_tpu_torch.pipeline.task_wrappers.read_convert_skysub_character_catalog`,
  the plate solving (``task_wrappers.plate_solve_all_frames``, or
  ``processes.alternate_plate_solving_with_gaia.alternate_plate_solve_gaia``
  or ``processes.alternate_plate_solving_adapt_existing_wcs.alternate_plate_solve_adapt_ref``,
  then ``pipeline.state_checkers.check_plate_solving``),
  ``task_wrappers.calc_common_and_total_footprint_and_save``,
  :func:`lightcurver_tpu_torch.processes.star_querying.query_gaia_stars`
  and :func:`lightcurver_tpu_torch.processes.cutout_making.extract_all_stamps`;
- the calibration chain's pipeline tasks, named as the JAX package's,
  from a stamped workdir:
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
  joint photometry of a bucket of stars at once;
- the three fits above over several ranks (one process per card, under
  ``torchrun``, after
  :func:`lightcurver_tpu_torch.parallel.distributed.initialize_distributed`):
  their ``mesh="auto"`` shards ROI epochs, PSF frames and stars
  (``parallel/``).
"""

__version__ = "0.1.0"
