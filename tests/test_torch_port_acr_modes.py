"""acr_tpu_torch ACRNet in the 'offset' and 'replace' offset modes against
the canonical JAX ACRNet (the 'concat' mode is in test_torch_port_model.py).

Same weights (flax init, BN scale x 0.2) and inputs (numpy seed) as
test_torch_port_model.py; tolerance 1e-4 abs on every output map.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.models.acr import ACRNet as JaxACRNet
from test_torch_port_model import _golden_scale, check_acrnet

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    params = JaxACRNet().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
    return _golden_scale(params)["params"]


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(7)
    return (rng.rand(1, 64, 64, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("offset_mode", ["offset", "replace"])
def test_acrnet_offset_modes(tree, image, offset_mode):
    check_acrnet(tree, image, offset_mode)
