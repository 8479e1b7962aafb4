"""Joint-modelling diagnostic: data/residual stacks, loss, chi2 histogram
(a copy of ``lightcurver_tpu/plotting/joint_modelling_plotting.py``)."""

import numpy as np

from . import pyplot
from .image_plotting import asinh_stretch


def plot_joint_modelling_diagnostic(datas, noisemaps, residuals,
                                    chi2_per_frame=None, loss_curve=None,
                                    starlet_background=None,
                                    save_path=None):
    plt = pyplot()
    has_bkg = starlet_background is not None
    n_panels = 5 + (1 if has_bkg else 0)
    fig, axes = plt.subplots(1, n_panels, figsize=(3.2 * n_panels, 3.4))

    mean_data = np.nanmean(datas, axis=0)
    axes[0].imshow(asinh_stretch(mean_data), origin="lower", cmap="viridis")
    axes[0].set_title("mean data", fontsize=9)

    mean_res = np.nanmean(residuals / noisemaps, axis=0)
    vmax = max(abs(np.nanmin(mean_res)), abs(np.nanmax(mean_res)), 1e-6)
    axes[1].imshow(mean_res, origin="lower", cmap="coolwarm",
                   vmin=-vmax, vmax=vmax)
    axes[1].set_title("mean residual / noise", fontsize=9)

    # without a chi2 ranking there IS no 'worst' epoch — labelling the
    # epoch-0 fallback as worst would send a user triaging a bad joint
    # fit to the wrong frame
    if chi2_per_frame is not None:
        worst = int(np.argmax(chi2_per_frame))
        panel_title = f"worst epoch ({worst})"
    else:
        worst = 0
        panel_title = "epoch 0"
    axes[2].imshow(residuals[worst] / noisemaps[worst], origin="lower",
                   cmap="coolwarm", vmin=-5, vmax=5)
    axes[2].set_title(panel_title, fontsize=9)

    if loss_curve is not None:
        axes[3].plot(np.asarray(loss_curve))
        axes[3].set_yscale("symlog")
    axes[3].set_title("loss", fontsize=9)

    if chi2_per_frame is not None:
        axes[4].hist(np.asarray(chi2_per_frame), bins=20)
    axes[4].set_title("reduced chi2 / frame", fontsize=9)

    if has_bkg:
        axes[5].imshow(asinh_stretch(np.asarray(starlet_background)),
                       origin="lower", cmap="viridis")
        axes[5].set_title("starlet background", fontsize=9)

    for i, ax in enumerate(axes):
        if i not in (3, 4):
            ax.axis("off")
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=110)
        plt.close()
    return fig
