"""The reference's import location of ``get_flux_uncertainties``: a copy
of ``lightcurver_tpu/utilities/starred_utilities.py``, re-exporting the
port's own ``core/fisher.py`` function.

The reference refits 10 L-BFGS steps and takes a generic Fisher matrix;
the model being exactly linear in the fluxes, the closed-form diagonal
Fisher information replaces both steps.
"""

from ..core.fisher import get_flux_uncertainties

__all__ = ["get_flux_uncertainties"]
