"""The plain reference of the narrow-PSF fit, and the numbers that judge
one frame's fit.

The fit returns per frame its narrow PSF t (fine grid, unit sum), its
full PSF (t convolved with the target Gaussian r: a centred star on the
fine grid), the per-star reduced chi2 and the residuals; a star's model is
then ``a down(t * r(. - s p))`` for its flux a and offset p, which the fit
does not return. The reference renders the full PSF from the narrow one,
finds each star's (a, p) that reproduce the program's model of it (a
Gauss-Newton fit on that noiseless image, in float64), renders the star
from them, and takes its chi2 from the data, the noise and the masks the
fit was given. The fit's quality is judged against the true scene the
benchmark rendered. Nothing here imports the program.
"""

import numpy as np
import torch

from .render import Precision, Renderer

NUMBERS = ("full_psf", "star_model", "chi2", "fit")


def full_psf(rnd, narrow):
    """t * r on the fine grid (F, m, m), corner-cropped as the model's
    convolution is."""
    tr, ti = rnd.spectrum(rnd.p.t(narrow))
    return rnd.inverse(tr * rnd.r_hat, ti * rnd.r_hat)


def star_models(rnd, narrow, a, x0, y0):
    """Each star's data-grid model (K, n, n) from its frame's narrow PSF
    (K, m, m), flux and offset (K,)."""
    return rnd.render(narrow, a[:, None], x0[:, None], y0[:, None])


def star_parameters(rnd, narrow, target, iterations=12):
    """(a, x0, y0), each (K,), that reproduce the model images ``target``
    (K, n, n) with the PSFs ``narrow`` (K, m, m): Gauss-Newton from the
    image's sum and first moments."""
    n = target.shape[-1]
    idx = rnd.p.t(torch.arange(n)) - (n - 1) / 2.0
    total = target.sum(dim=(-2, -1))
    params = torch.stack([
        total, (target.sum(-2) * idx).sum(-1) / total,
        (target.sum(-1) * idx).sum(-1) / total], 1)

    def model(q):
        return star_models(rnd, narrow, q[:, 0], q[:, 1], q[:, 2])

    for _ in range(iterations):
        cols = [torch.func.jvp(model, (params,), (torch.nn.functional.
                                                  one_hot(torch.full(
                                                      (len(params),), j),
                                                      3).to(params),))
                for j in range(3)]
        resid = (target - cols[0][0]).reshape(len(params), -1)
        J = torch.stack([c[1].reshape(len(params), -1) for c in cols], -1)
        step = torch.linalg.solve(J.transpose(1, 2) @ J,
                                  (J.transpose(1, 2) @ resid[..., None]))
        params = params + step[..., 0]
    return params


def answers(fit, narrow_ref, params, precision, device):
    """The reference's answers for one bucket's real stars at
    ``precision``: the full PSFs, the stars' models at ``params`` (the
    (a, x0, y0) found in float64) and their chi2. ``fit``: the bucket's
    inputs (data, sigma, masks, the frame of each real star)."""
    p = Precision(precision, device)
    rnd = Renderer(fit["m"], fit["s"], p)
    full = full_psf(rnd, narrow_ref)
    star_psf = p.t(narrow_ref)[fit["frame_of_star"]]
    q = p.t(params)
    model = star_models(rnd, star_psf, q[:, 0], q[:, 1], q[:, 2])
    data, sig2 = p.t(fit["star_data"]), p.t(fit["star_sigma"]) ** 2
    mask = torch.as_tensor(fit["star_masks"], device=p.device)
    res2 = torch.where(mask, (data - model) ** 2 / sig2,
                       torch.zeros_like(data))
    chi2 = res2.sum(dim=(-2, -1)) / mask.sum(dim=(-2, -1)).clamp(min=1)
    return {"full_psf": full, "star_model": model, "chi2": chi2}


def fitted(fit, results, device):
    """The program's answers of one bucket's real stars and the star
    parameters the reference finds for them (float64)."""
    p = Precision("float64", device)
    rnd = Renderer(fit["m"], fit["s"], p)
    narrow = np.stack([r["narrow_psf"] for r in results])
    model = np.concatenate([fit_data - r["residuals"] for fit_data, r in
                            zip(fit["frame_data"], results)])
    params = star_parameters(rnd, p.t(narrow)[fit["frame_of_star"]],
                             p.t(model))
    got = {"full_psf": np.stack([r["full_psf"] for r in results]),
           "star_model": model,
           "chi2": np.concatenate([r["chi2_per_star"] for r in results])}
    return narrow, params, got


def numbers(fit, got, ref):
    """The widest gap of each answer to the reference's:

    full_psf    max |full - ref| over a frame / that frame's peak
    star_model  max |model - ref| over a star / that star's peak
    chi2        |chi2 - ref| / ref, per star
    fit         (chi2 - chi2 of the true scene) / that, per star
    """
    def d(x):
        if torch.is_tensor(x):
            return x.detach().to("cpu", torch.float64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    g = {k: d(v) for k, v in got.items()}
    r = {k: d(v) for k, v in ref.items()}
    mask = torch.as_tensor(fit["star_masks"])
    res2 = torch.where(mask, (d(fit["star_data"]) - d(fit["star_clean"])) ** 2
                       / d(fit["star_sigma"]) ** 2, torch.zeros(()))
    chi2_true = res2.sum(dim=(-2, -1)) / mask.sum(dim=(-2, -1)).clamp(min=1)

    def widest(key):
        peak = r[key].abs().amax(dim=(-2, -1))
        return ((g[key] - r[key]).abs().amax(dim=(-2, -1)) / peak).max()

    out = {"full_psf": widest("full_psf"),
           "star_model": widest("star_model"),
           "chi2": ((g["chi2"] - r["chi2"]).abs() / r["chi2"]).max(),
           "fit": ((g["chi2"] - chi2_true) / chi2_true).max()}
    return {k: float(v) for k, v in out.items()}
