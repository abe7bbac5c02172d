"""Which convs the port quantizes, and ``calibrate_amax``, against JAX.

- The port's QuantConv sites are exactly the paths of JAX's ``kernel_q``
  params (``jax.eval_shape`` of the quantized flax init), per mode.
- ``calibrate_amax`` against JAX's observe run (``observe_r``, which
  records every site of every mode) on one 64 px frame from a numpy
  seed, the float weights ``init_params`` carried to flax: each site's
  per-input-channel amax within 1e-5 relative (measured 1.7e-6: the
  float activations differ in their last bits), the site set exactly
  JAX's, and two frames' amax the elementwise max of each frame's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io.params import flatten_params, unflatten_params
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu.ops import quant as jq
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.ops import quant as tq
from test_torch_port_quant import (  # noqa: F401 (fixtures)
    flat_jax_stats, image, quant_names, state_dict, to_flax)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["int8", "int8_pc", "int8_r"])
def test_quant_sites_are_jax_sites(mode):
    """The port quantizes exactly the convs whose JAX params are kernel_q
    ('int4w' builds 'int8''s network: only the weight grid differs)."""
    shapes = jax.eval_shape(JaxACRNet(quantize=mode).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.uint8))
    jax_sites = sorted(".".join(k.split("/")[:-1])
                       for k in flatten_params(jax.tree.map(
                           lambda s: np.zeros((), s.dtype), shapes))
                       if k.endswith("/kernel_q"))
    with torch.device("meta"):
        net = ACRNet(quantize=mode)
    assert quant_names(net) == jax_sites
    assert len(jax_sites) == (348 if mode.endswith("_r") else 338)
    pc = [m.ascale.shape for m in net.modules() if isinstance(m, tq.QuantConv)]
    assert all(s == ((s[0],) if mode == "int8_pc" else ()) for s in pc)


@pytest.fixture(scope="module")
def jax_observe_r(state_dict, image):
    """JAX's observe_r run (every site of every mode) on ``image``."""
    tree = unflatten_params(to_flax(state_dict))
    return flat_jax_stats(jq.calibrate_amax(
        JaxACRNet(quantize="observe_r"), tree, [image]))


@pytest.mark.parametrize("mode", ["int8", "int8_r"])
def test_calibrate_amax_matches_jax(state_dict, image, jax_observe_r, mode):
    net = ACRNet()
    net.load_state_dict(state_dict)
    net.eval()
    flipped = image[:, ::-1].copy()
    solo = tq.calibrate_amax(net, [image], mode)
    both = tq.calibrate_amax(net, [image, flipped], mode)
    other = tq.calibrate_amax(net, [flipped], mode)
    want = {k: v for k, v in jax_observe_r.items()
            if tq.is_quant_site(k, mode)}
    assert solo.keys() == both.keys() == want.keys()
    assert len(want) == (348 if mode == "int8_r" else 338)
    for key in want:
        assert solo[key].dtype == np.float32
        np.testing.assert_allclose(solo[key], want[key], rtol=1e-5,
                                   atol=1e-5 * want[key].max(), err_msg=key)
        # two frames: the elementwise max of their amax
        np.testing.assert_array_equal(both[key],
                                      np.maximum(solo[key], other[key]))
