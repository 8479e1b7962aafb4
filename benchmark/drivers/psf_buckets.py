"""The PSF task's bucket stream: frames fitted 16 at a time through
``psf_modelling.run_pipelined_buckets``.

Each bucket's preparation runs on the pipeline's worker thread as the task
runs it: fresh noise on the bucket's frames, the task's
``mask_surrounding_stars`` on every star, the stars more than 40 % masked
dropped; then ``_dispatch_fit_jobs(fetch="device")`` queues the batched
fit (padded by the task's ``_pad_fit_jobs``) and ``_collect_fit_results``
fetches it, one bucket behind. Set-up renders the pool of frames and warms
up with one bucket at cut iteration counts. The window streams buckets
until its seconds are spent; it ends when the last dispatched bucket has
been collected, and counts every frame collected.
"""

import sys
import time

import numpy as np

from lightcurver_tpu_torch.processes.psf_modelling import (
    _collect_fit_results, _dispatch_fit_jobs, mask_surrounding_stars,
    run_pipelined_buckets)

from ..reference import psf as reference
from ..scenes import mix, psf_bucket, psf_scene

WARM_UP = 10**9   # the warm-up bucket's noise draw: no timed bucket has it


class WindowClosed(Exception):
    """Raised by the preparation of a bucket after the window closed."""


class Driver:
    def __init__(self, cell, cfg, traffic, seed, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = seed, device
        self.results = []   # (bucket index, jobs, results)

    def user_config(self, analytic=None, pixels=None):
        cfg = self.cfg
        return {"subsampling_factor": cfg["subsampling_factor"],
                "psf_n_iter_analytic": analytic or cfg["psf_n_iter_analytic"],
                "psf_n_iter_pixels": pixels or cfg["psf_n_iter_pixels"],
                "field_distortion": cfg["field_distortion"],
                "psf_dft_pad": cfg["psf_dft_pad"]}

    def jobs(self, index):
        """Bucket ``index`` prepared as the task prepares a frame."""
        sc = self.scene
        ids, data, sigma = psf_bucket(sc, index)
        jobs = []
        for f, frame_data, frame_sigma in zip(ids, data, sigma):
            k = sc["n_real"][f]
            d, n = frame_data[:k], frame_sigma[:k]
            masks = np.array([mask_surrounding_stars(x, y)
                              for x, y in zip(d, n)])
            keep = (~masks).sum(axis=(1, 2)) / masks[0].size <= 0.4
            jobs.append({"frame": {"seeing_pixels": sc["fwhm"][f]},
                         "pool_frame": f, "stars": np.flatnonzero(keep),
                         "data": d[keep], "noisemap": n[keep],
                         "masks": masks[keep],
                         "stamp_coords": np.zeros((keep.sum(), 2))})
        return jobs

    def dispatch(self, jobs, config):
        return _dispatch_fit_jobs(config, jobs, fetch="device",
                                  device=self.device,
                                  irfft_backend=self.cfg["irfft_backend"])

    def setup(self):
        self.scene = psf_scene(self.cfg, self.seed, self.device)
        warm = self.traffic["warm_up"]
        jobs = self.jobs(WARM_UP)
        _collect_fit_results(self.dispatch(jobs, self.user_config(
            warm["analytic_iters"], warm["pixel_iters"])), jobs)

    def window(self, seconds, tracer=None):
        """Streams buckets until ``seconds`` have passed; (frames, window
        seconds)."""
        config = self.user_config()
        closed = False
        dispatched, stored = [], []
        t0 = time.perf_counter()

        def prepare(index):
            if closed:
                raise WindowClosed
            return self.jobs(index)

        def dispatch(jobs):
            if tracer:
                tracer.begin(len(dispatched))
            dispatched.append(len(dispatched))
            return self.dispatch(jobs, config)

        def store(jobs, out, _):
            nonlocal closed
            results = _collect_fit_results(out, jobs)
            index = len(stored)
            self.results.append((index, jobs, results))
            stored.append(time.perf_counter())
            if tracer:
                tracer.end(index)
            closed = closed or stored[-1] - t0 >= seconds

        try:
            run_pipelined_buckets(range(10**6), prepare, dispatch, store)
        except WindowClosed:
            pass
        frames = sum(len(jobs) for _, jobs, _ in self.results)
        print("bucket collected at: " + " ".join(
            f"{t - t0:.4f}" for t in stored), file=sys.stderr)
        return frames, stored[-1] - t0

    def trace_shapes(self):
        """K1's shape in the pixel phase: the bucket's frames, the fine
        grid and its scales."""
        m = self.cfg["stamp_size_stars"] * self.cfg["subsampling_factor"]
        return {"k1": dict(m=m, batch=self.cfg["psf_fit_batch_size"],
                           n_scales=int(np.log2(m)))}

    def inputs(self, jobs):
        """One bucket's inputs as the reference takes them: per real star
        its data, sigma, mask, true clean stamp and frame."""
        sc = self.scene
        frame_of_star = np.concatenate([np.full(len(j["data"]), i)
                                        for i, j in enumerate(jobs)])
        clean = np.concatenate([sc["clean"][j["pool_frame"]][j["stars"]]
                                for j in jobs])
        return {"m": sc["m"], "s": sc["s"], "frame_of_star": frame_of_star,
                "frame_data": [j["data"] for j in jobs],
                "star_data": np.concatenate([j["data"] for j in jobs]),
                "star_sigma": np.concatenate([j["noisemap"] for j in jobs]),
                "star_masks": np.concatenate([j["masks"] for j in jobs]),
                "star_clean": clean}

    def sample(self):
        """The buckets judged: ``judge_buckets`` of them, drawn from the
        seed."""
        k = min(int(self.traffic["judge_buckets"]), len(self.results))
        rng = np.random.default_rng(mix(self.seed, 8))
        return sorted(rng.choice(len(self.results), k, replace=False))

    def readings(self, position, precision="float64"):
        """The numbers of the ``position``-th bucket collected: the
        program's, and with ``precision="tf32"`` also the control's."""
        _, jobs, results = self.results[position]
        fit = self.inputs(jobs)
        narrow, params, got = reference.fitted(fit, results, self.device)
        ref = reference.answers(fit, narrow, params, "float64", self.device)
        result = {"program": reference.numbers(fit, got, ref)}
        if precision == "tf32":
            ctrl = reference.answers(fit, narrow, params, "tf32",
                                     self.device)
            result["control"] = reference.numbers(fit, ctrl, ref)
        return result

