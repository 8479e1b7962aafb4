"""PSF fit diagnostic: stars / noisemaps / residuals grid + loss + PSF
(a copy of ``lightcurver_tpu/plotting/psf_plotting.py``)."""

import numpy as np

from . import pyplot
from .image_plotting import asinh_stretch


def plot_psf_diagnostic(datas, noisemaps, residuals, full_psf,
                        loss_curve=None, masks=None, names=None,
                        diagnostic_text=None, save_path=None):
    plt = pyplot()
    n_stars = len(datas)
    n_cols = max(n_stars, 2)
    fig, axes = plt.subplots(4, n_cols, figsize=(2.2 * n_cols, 9.0))
    for i in range(n_stars):
        axes[0, i].imshow(asinh_stretch(datas[i]), origin="lower",
                          cmap="viridis")
        if names is not None and i < len(names):
            axes[0, i].set_title(str(names[i]), fontsize=9)
        axes[1, i].imshow(noisemaps[i], origin="lower", cmap="magma")
        res = residuals[i] / noisemaps[i]
        im = axes[2, i].imshow(res, origin="lower", cmap="coolwarm",
                               vmin=-4, vmax=4)
        if masks is not None:
            axes[2, i].contour(~masks[i], levels=[0.5], colors="k",
                               linewidths=0.5)
    for row in range(3):
        for i in range(n_cols):
            axes[row, i].axis("off")
    axes[3, 0].axis("on")
    if loss_curve is not None:
        axes[3, 0].plot(np.asarray(loss_curve))
        axes[3, 0].set_yscale("symlog")
        axes[3, 0].set_title("loss", fontsize=9)
    axes[3, 1].imshow(asinh_stretch(full_psf), origin="lower",
                      cmap="viridis")
    axes[3, 1].set_title("full PSF", fontsize=9)
    axes[3, 1].axis("off")
    for i in range(2, n_cols):
        axes[3, i].axis("off")
    if diagnostic_text:
        fig.suptitle(diagnostic_text, fontsize=9)
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=110)
        plt.close()
    return fig
