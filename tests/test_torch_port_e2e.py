"""The port's whole chain reproduces the golden end-to-end fixture.

Same seed-0 flax weights (golden recipe) and frame as
tests/test_golden_e2e.py, carried over by ``from_flax``; the port builds
the canonical network (the JAX pipeline runs its space-to-depth
rewrites, which are exact). Tolerances are those of
tests/test_golden_e2e.py:39-51.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io.params import flatten_params
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.pipeline.infer import ACRPipeline

torch.set_num_threads(2)
HERE = os.path.dirname(__file__)
FIXTURE = os.path.join(HERE, "golden", "e2e_fixture.npz")
MANO_DIR = os.path.join(HERE, "..", "model_data", "mano")


def test_port_reproduces_golden_fixture():
    params = JaxACRNet().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3), jnp.uint8))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 0.2 if getattr(p[-1], "key", None) == "scale" else x,
        params)
    cfg = Config(input_size=128, mano_model_path=MANO_DIR, configs_yml="")
    pipe = ACRPipeline(cfg, params=from_flax(flatten_params(params)),
                       device="cpu")
    rng = np.random.RandomState(42)
    img = (rng.rand(1, 128, 128, 3) * 255).astype(np.uint8)
    off = np.array([[128, 128, 0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    out = {k: v.numpy() for k, v in pipe(img, off).items()}

    golden = np.load(FIXTURE)
    np.testing.assert_array_equal(out["detection_flag"], golden["detection_flag"])
    np.testing.assert_array_equal(out["centers"], golden["centers"])
    for key, tol in (("poses", 1e-4), ("betas", 1e-4), ("cam", 1e-4),
                     ("verts", 1e-4), ("j3d", 1e-4), ("pj2d", 1e-4)):
        np.testing.assert_allclose(out[key], golden[key], atol=tol, err_msg=key)
    # ill-conditioned LS solve on synthetic-weight predictions: pinned
    # loosely, as the golden test pins it
    np.testing.assert_allclose(out["cam_trans"], golden["cam_trans"],
                               rtol=5e-2, atol=0.1, err_msg="cam_trans")
    for key in ("verts_camed", "pj2d_org", "params", "centers_conf"):
        assert np.isfinite(out[key]).all(), key
