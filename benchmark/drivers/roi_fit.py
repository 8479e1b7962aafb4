"""Back-to-back joint ROI fits: ``fit_roi`` on a fresh noise draw each.

Set-up renders the scene once and warms up with one fit at the cell's
shapes and cut iteration counts (the libraries load, cuFFT makes its
plans, the allocator grows; every fit captures its own CUDA graphs
anyway). The window then calls ``fit_roi`` back to back, fit ``i`` on the
scene plus noise drawn from (seed, i), each with its results fetched to
the host as the ROI task takes them, until the window's seconds are
spent; the window ends with the last fit. On several cards every rank calls
``fit_roi(mesh="auto")`` on the same data, each fitting its share of the
epochs, and every rank stops after the fit that rank 0 says ends the
window.
"""

import sys
import time

import numpy as np

from lightcurver_tpu_torch.processes.roi_modelling import fit_roi

from ..reference import roi as reference
from ..scenes import mix, roi_fit_input, roi_scene

WARM_UP = 10**9   # the warm-up fit's noise draw: no timed fit has it
KEPT = ("fluxes", "flux_errors", "reduced_chi2", "residuals", "kwargs", "W",
        "loss_history_stage1")


def roi_config(cfg, translations_iters=None, all_iters=None):
    """The ROI section of the pipeline's configuration, as ``fit_roi``
    takes it."""
    return {
        "fix_point_source_astrometry": False,
        "starting_background": None,
        "further_optimize_background": True,
        "roi_model_regularization": dict(cfg["roi_model_regularization"]),
        "roi_deconv_translations_iters": int(
            translations_iters or cfg["roi_deconv_translations_iters"]),
        "roi_deconv_all_iters": int(all_iters or cfg["roi_deconv_all_iters"]),
    }


class Driver:
    def __init__(self, cell, cfg, traffic, seed, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = seed, device
        self.backend = cfg["irfft_backend"]
        self.results = []
        self.fit_s = []

    def fit(self, fit_input, config):
        sc = self.scene
        return fit_roi(fit_input["data"], sc["noisemap"], sc["psf"], sc["xs"],
                       sc["ys"], sc["s"], sc["seeings"], sc["pixel_scale"],
                       sc["angles"], config, device=self.device,
                       irfft_backend=self.backend, mesh="auto")

    def setup(self):
        self.scene = roi_scene(self.cfg, self.seed, self.device)
        warm = self.traffic["warm_up"]
        self.fit(roi_fit_input(self.scene, WARM_UP), roi_config(
            self.cfg, warm["translations_iters"], warm["all_iters"]))

    def window(self, seconds, tracer=None, agree=lambda done: done):
        """Fits until ``seconds`` have passed; (fits, window seconds).
        ``agree`` makes this process's verdict after each fit the one that
        every rank follows: on several cards, rank 0's (``World.agree``),
        so that each fit's collectives meet on every rank."""
        config = roi_config(self.cfg)
        t0 = time.perf_counter()
        i = 0
        while True:
            if tracer:
                tracer.begin(i)
            t_fit = time.perf_counter()
            out = self.fit(roi_fit_input(self.scene, len(self.results)),
                           config)
            self.results.append({k: out[k] for k in KEPT})
            del out
            end = time.perf_counter()
            self.fit_s.append(end - t_fit)
            if tracer:
                tracer.end(i)
            i += 1
            if agree(time.perf_counter() - t0 >= seconds):
                break
        print("fit seconds: " + " ".join(f"{t:.4f}" for t in self.fit_s[-i:]),
              file=sys.stderr)
        return i, end - t0

    def trace_shapes(self):
        """Shapes the kernel metrics need: K2's on one rank, whose share
        of the epochs (padded as the sharded fit pads them) is the epochs
        over the ranks, rounded up."""
        cfg = self.cfg
        n, s = cfg["stamp_size_ROI"], cfg["subsampling_factor"]
        L = 2 * n * s
        return {"k2": dict(N=-(-cfg["epochs"] // int(self.cell["chips"])),
                           C=2 * len(cfg["scene"]["source_x"]), L=L,
                           Lh=L // 2 + 1, n=n)}

    def sample(self):
        """The fits judged: ``judge_fits`` of them, drawn from the seed."""
        k = min(int(self.traffic["judge_fits"]), len(self.results))
        rng = np.random.default_rng(mix(self.seed, 3))
        return sorted(rng.choice(len(self.results), k, replace=False))

    def readings(self, index, precision="float64"):
        """The numbers of fit ``index``: the program's, and with
        ``precision="tf32"`` also the control's (the reference in TF32 put
        in the program's place, at the program's parameters)."""
        fit_input = roi_fit_input(self.scene, index)
        out = self.results[index]
        ref = reference.answers(self.scene, fit_input, out["kwargs"],
                                "float64")
        got = reference.program_answers(fit_input, out)
        result = {"program": reference.numbers(self.scene, fit_input, got,
                                               ref)}
        if precision == "tf32":
            ctrl = reference.answers(self.scene, fit_input, out["kwargs"],
                                     "tf32")
            result["control"] = reference.numbers(self.scene, fit_input,
                                                  ctrl, ref)
        return result

