"""acr_tpu_torch.ops (see the package docstring)."""
