"""acr_tpu_torch.parser (see the package docstring)."""
