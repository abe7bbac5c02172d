"""acr_tpu_torch.io (see the package docstring)."""
