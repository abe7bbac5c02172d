"""Result writers used by the image path (copied from acr_tpu/io/writers.py)."""

from __future__ import annotations

import os
import pickle
from typing import Dict


def save_results(tag: str, output_dir: str, results_dict: Dict) -> str:
    """Persist results as pickle (reference: acr/utils.py:124-129)."""
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir,
                       os.path.basename(tag.rstrip("/")) + "_results.pkl")
    with open(out, "wb") as f:
        pickle.dump(results_dict, f)
    return out
