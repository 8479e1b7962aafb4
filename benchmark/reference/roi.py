"""The plain reference of a joint ROI fit, and the numbers that judge one.

A fit's answers are its per-epoch model, reduced chi2, fluxes after the
exact GLS polish, their Fisher errors, the starlet noise weights W of its
background and the loss at its starting point. The reference works each
out again, at the fitted parameters the program returns, from the inputs
the benchmark made (data, noise, PSFs, the given source positions); the
fit's quality is judged against the true scene the benchmark rendered.
Nothing here imports the program.

All quantities are in the data's units, except W and the loss, which are
on the data divided by its maximum (the scale the program fits in, which
the reference takes again from the data).
"""

import numpy as np
import torch

from .render import Precision, Renderer, starlet

NUMBERS = ("render", "chi2", "flux", "flux_err", "noise_w", "loss0", "fit")


def _positions(kwargs, p):
    ka = kwargs["kwargs_analytic"]
    th = torch.deg2rad(p.t(ka["alpha"]))[:, None]
    cx, cy = p.t(ka["c_x"])[None, :], p.t(ka["c_y"])[None, :]
    px = torch.cos(th) * cx - torch.sin(th) * cy + p.t(ka["dx"])[:, None]
    py = torch.sin(th) * cx + torch.cos(th) * cy + p.t(ka["dy"])[:, None]
    return px, py


def aperture_start(data, xs, ys, seeings, pixel_scale):
    """The starting fluxes: aperture sums on the per-pixel median of the
    epochs, radius 0.66 mean seeing, positions in stamp pixels."""
    stack = np.nanmedian(np.asarray(data, np.float64), axis=0)
    good = np.asarray(seeings, float)
    good = good[np.isfinite(good) & (good > 0)]
    pixel_scale = float(np.nanmedian(pixel_scale))
    radius = 0.66 * (good.mean() if good.size else 3.0 * pixel_scale) \
        / pixel_scale
    yy, xx = np.mgrid[0:stack.shape[0], 0:stack.shape[1]]
    return np.array([np.nansum(stack[(xx - x) ** 2 + (yy - y) ** 2
                                     <= radius**2])
                     for x, y in zip(xs, ys)])


def noise_weights(renderer, psf, sigma, draws, n_scales, block=100):
    """Starlet noise weights (J + 1, m, m): per coefficient, the standard
    deviation (ddof 0) over the draws of the starlet of the noise pushed
    back through the model's adjoint (the transpose of the sum-pool, then
    a correlation with the epochs' mean point-source kernel t * r).
    ``sigma`` (n, n); ``draws`` (K, n, n) standard normal."""
    p, s = renderer.p, renderer.s
    tr, ti = [], []
    for lo in range(0, psf.shape[0], 125):
        r, i = renderer.psf_spectra(psf[lo:lo + 125])
        tr.append(r.sum(0))
        ti.append(i.sum(0))
    kr = torch.stack(tr).sum(0) / psf.shape[0] * renderer.r_hat
    ki = torch.stack(ti).sum(0) / psf.shape[0] * renderer.r_hat
    coeffs = []
    for lo in range(0, draws.shape[0], block):
        x = p.t(sigma) * p.t(draws[lo:lo + block])
        fine = x.repeat_interleave(s, -2).repeat_interleave(s, -1)
        fr, fi = renderer.spectrum(fine)
        back = renderer.inverse(fr * kr + fi * ki, fi * kr - fr * ki)
        coeffs.append(starlet(back, n_scales))
    coeffs = torch.cat(coeffs)
    return torch.clamp(coeffs.std(dim=0, correction=0), min=1e-12)


def answers(scene, fit_input, kwargs, precision, with_loss0=True):
    """The reference's answers at the program's fitted ``kwargs`` (numpy
    tree, on the scaled data), in ``precision`` ("float64", or "tf32" for
    the control). ``scene``: the benchmark's scene; ``fit_input``: one
    fit's inputs (its data)."""
    p = Precision(precision, scene["device"])
    rnd = Renderer(scene["m"], scene["s"], p)
    data = p.t(fit_input["data"])
    sig2 = p.t(scene["noisemap"]) ** 2
    scale = float(np.nanmax(fit_input["data"]))
    N, M = data.shape[0], len(scene["xs"])
    psf = scene["psf_dev"]
    kb = kwargs["kwargs_background"]
    h = p.t(kb["h"]).reshape(rnd.m, rnd.m)
    mean = p.t(kb["mean"])
    a = p.t(kwargs["kwargs_analytic"]["a"]).reshape(N, M)
    px, py = _positions(kwargs, p)
    model = rnd.render(psf, a, px, py, h, mean) * scale
    n2 = data.shape[-1] ** 2
    chi2 = torch.nansum((data - model) ** 2 / sig2, dim=(1, 2)) / n2

    # GLS polish: unit-flux images of each source, the flux-independent
    # part (background and mean), and the M x M normal equations per epoch
    basis = torch.stack([rnd.render(psf, torch.nn.functional.one_hot(
        torch.full((N,), j), M).to(p.dtype), px, py) for j in range(M)], 1)
    base = rnd.render(psf, torch.zeros_like(a), px, py, h, mean) * scale
    w = 1.0 / sig2
    bw = basis * w[:, None]
    gram = torch.einsum("nmyx,nkyx->nmk", bw, basis)
    rhs = torch.einsum("nmyx,nyx->nm", bw, data - base)
    flux = torch.linalg.solve(gram, rhs[..., None])[..., 0]
    flux_err = 1.0 / torch.sqrt((basis**2 * w[:, None]).sum(dim=(-2, -1)))

    m_sig = np.nanmedian(scene["noisemap"], axis=0) / scale
    W = noise_weights(rnd, psf, m_sig, scene["noise_draws"],
                      scene["n_scales"])
    out = {"model": model, "chi2": chi2, "flux": flux, "flux_err": flux_err,
           "noise_w": W}
    if with_loss0:
        out["loss0"] = loss0(scene, fit_input, rnd, scale)
    return out


def loss0(scene, fit_input, rnd, scale):
    """The first stage's loss at its start: half the chi2 of the scaled
    data, with the aperture fluxes of every epoch, the given positions and
    no background (the flux-uniformity term is zero there: every epoch
    starts from the same fluxes)."""
    p = rnd.p
    data = np.asarray(fit_input["data"], np.float64) / scale
    N, n = data.shape[0], data.shape[-1]
    a0 = aperture_start(data, scene["xs"], scene["ys"], scene["seeings"],
                        scene["pixel_scale"])
    c = (n - 1) / 2.0
    px = p.t(np.tile(np.asarray(scene["xs"], np.float64) - c, (N, 1)))
    py = p.t(np.tile(np.asarray(scene["ys"], np.float64) - c, (N, 1)))
    a = p.t(np.tile(a0, (N, 1)))
    model = rnd.render(scene["psf_dev"], a, px, py)
    sig2 = (p.t(scene["noisemap"]) / scale) ** 2
    return 0.5 * torch.nansum((p.t(data) - model) ** 2 / sig2)


def program_answers(fit_input, out):
    """The same answers, as the program returned them."""
    return {"model": np.asarray(fit_input["data"], np.float64)
            - np.asarray(out["residuals"], np.float64),
            "chi2": out["reduced_chi2"], "flux": out["fluxes"],
            "flux_err": out["flux_errors"], "noise_w": out["W"],
            "loss0": out["loss_history_stage1"][0]}


def numbers(scene, fit_input, got, ref):
    """The widest gap of each answer ``got`` to the reference's ``ref``,
    and the fit's chi2 excess over the true scene's, per epoch at worst:

    render   max |model - ref| over an epoch's pixels / that epoch's peak
    chi2     |chi2 - ref| / ref
    flux     |flux - ref| / ref flux error
    flux_err |error - ref| / ref
    noise_w  max |W - ref| over a starlet scale / that scale's largest
    loss0    |loss - ref| / ref, the first stage's first loss
    fit      (chi2 - chi2 of the true scene) / chi2 of the true scene
    """
    def d(x):
        if torch.is_tensor(x):
            return x.detach().to("cpu", torch.float64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    r = {k: d(v) for k, v in ref.items()}
    g = {k: d(v) for k, v in got.items()}
    peak = r["model"].abs().amax(dim=(1, 2))
    data = d(fit_input["data"])
    sig2 = d(scene["noisemap"]) ** 2
    n2 = data.shape[-1] ** 2
    chi2_true = torch.nansum((data - d(scene["clean"])) ** 2 / sig2,
                             dim=(1, 2)) / n2
    out = {
        "render": ((g["model"] - r["model"]).abs().amax(dim=(1, 2))
                   / peak).max(),
        "chi2": ((g["chi2"] - r["chi2"]).abs() / r["chi2"]).max(),
        "flux": ((g["flux"] - r["flux"]).abs() / r["flux_err"]).max(),
        "flux_err": ((g["flux_err"] - r["flux_err"]).abs()
                     / r["flux_err"]).max(),
        "noise_w": ((g["noise_w"] - r["noise_w"]).abs().amax(dim=(1, 2))
                    / r["noise_w"].amax(dim=(1, 2))).max(),
        "fit": ((g["chi2"] - chi2_true) / chi2_true).max(),
    }
    if "loss0" in g and "loss0" in r:
        out["loss0"] = (g["loss0"] - r["loss0"]).abs() / r["loss0"]
    return {k: float(v) for k, v in out.items()}
