#!/usr/bin/env python
"""Regenerate the orbax fixtures under tests/golden/ (run from the repo
root; needs JAX and orbax):

    JAX_PLATFORMS=cpu python tests/golden/make_orbax_fixture.py [NAME ...]

NAME is one or more of ``orbax_small``, ``orbax_small_zarr3`` and
``orbax_sharded_zarr3``; without one, all three are written. Each
directory ``<NAME>/`` has its ``<NAME>.npz`` beside it:

* ``orbax_small/`` is what ``acr_tpu.io.params.save_params_orbax``
  writes for a small params tree (orbax's default layout: OCDBT with
  zstd, zarr v2 arrays).
* ``orbax_small_zarr3/`` is the same tree saved through
  ``ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True))``:
  OCDBT with zstd, each leaf a zarr v3 array of one ``sharding_indexed``
  shard (a crc32c index).
* ``orbax_sharded_zarr3/`` is the plain layout (``use_ocdbt=False,
  use_compression=False``) of zarr v3 arrays: the same tree and
  ``sharded``, a (64, 8) fp32 leaf laid over 2 host devices and saved
  with ``SaveArgs(chunk_byte_size=512)``, so that it is four shards
  ``c/0/0`` ... ``c/3/0`` of (16, 8). The script forces the 2 host
  devices itself (``--xla_force_host_platform_device_count=2``).

Each npz holds the same leaves under their '/'-joined paths. npz has no
bfloat16, so a bf16 leaf is stored as its uint16 bits and its path is
listed under ``BF16_KEY``. The PyTorch port reads the directories
without orbax (``acr_tpu_torch.io.orbax``) and is held to the npz, here
and on hosts that have no orbax. Every run writes new bytes (OCDBT file
names and the checkpoint metadata are random or dated), so regenerate
only the fixture that must change.
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from acr_tpu.io.params import flatten_params, save_params_orbax

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_KEY = "bfloat16_leaves"
SHARD_BYTES = 512             # chunk_byte_size of the sharded leaf


def fixture_tree():
    """fp32 (1-D, 2-D and a 4-D conv kernel), bf16, int8, int32, bool and
    0-d leaves; ``big/kernel`` compresses to more than orbax's 1024-byte
    inline limit, so its chunk lives in a data file, not in the node."""
    rng = np.random.RandomState(0)
    return {"params": {
        "conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                 "bias": rng.randn(4).astype(np.float32)},
        "dense": {"kernel": rng.randn(5, 3).astype(np.float32)},
        "big": {"kernel": rng.randn(16, 32).astype(np.float32)},
        "half": jnp.asarray(rng.randn(2, 7), jnp.bfloat16),
        "q": {"kernel_q": rng.randint(-128, 128, (3, 3, 2, 2)).astype(np.int8),
              "steps": np.arange(6, dtype=np.int32).reshape(2, 3)},
        "mask": rng.rand(9) > 0.5,
        "scale": np.float32(0.2),
    }}


def save_zarr3(path, tree, use_ocdbt=True, use_compression=True):
    """``tree`` as zarr v3 arrays through orbax's PyTreeCheckpointHandler,
    each leaf as a jax.Array, as ``save_params_orbax`` saves it; a leaf
    laid over several devices is saved in shards of ``SHARD_BYTES``."""
    import orbax.checkpoint as ocp
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    save_args = jax.tree_util.tree_map(
        lambda x: ocp.SaveArgs(chunk_byte_size=SHARD_BYTES)
        if len(getattr(x, "devices", lambda: ())()) > 1 else ocp.SaveArgs(),
        tree)
    handler = ocp.PyTreeCheckpointHandler(
        use_ocdbt=use_ocdbt, use_zarr3=True, use_compression=use_compression)
    ocp.Checkpointer(handler).save(
        os.path.abspath(path),
        args=ocp.args.PyTreeSave(tree, save_args=save_args), force=True)


def sharded_leaf():
    """A (64, 8) fp32 array laid over the first 2 devices by rows."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    value = np.random.RandomState(1).randn(64, 8).astype(np.float32)
    return jax.device_put(jnp.asarray(value),
                          NamedSharding(mesh, PartitionSpec("x")))


def write(name):
    out_dir = os.path.join(HERE, name)
    tree = fixture_tree()
    shutil.rmtree(out_dir, ignore_errors=True)
    if name == "orbax_small":
        save_params_orbax(out_dir, tree)
    elif name == "orbax_small_zarr3":
        save_zarr3(out_dir, tree)
    elif name == "orbax_sharded_zarr3":
        tree["params"]["sharded"] = sharded_leaf()
        save_zarr3(out_dir, tree, use_ocdbt=False, use_compression=False)
    else:
        raise SystemExit(f"unknown fixture {name!r}")
    flat = flatten_params(tree)
    bf16 = sorted(k for k, v in flat.items() if v.dtype == jnp.bfloat16)
    arrays = {k: (v.view(np.uint16) if k in bf16 else v)
              for k, v in flat.items()}
    arrays[BF16_KEY] = np.asarray(bf16)
    np.savez(out_dir + ".npz", **arrays)
    print(f"{name} regenerated:", sorted(flat))


def main(names):
    for name in names or ("orbax_small", "orbax_small_zarr3",
                          "orbax_sharded_zarr3"):
        write(name)


if __name__ == "__main__":
    main(sys.argv[1:])
