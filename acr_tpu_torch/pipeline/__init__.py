"""acr_tpu_torch.pipeline (see the package docstring)."""
