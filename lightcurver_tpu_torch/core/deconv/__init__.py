"""Joint multi-epoch deconvolution: model and loss."""
