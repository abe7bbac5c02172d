"""The port's data parallelism (``acr_tpu_torch.parallel``) on CPU
replicas, against the JAX package's mesh and against one replica.

``make_mesh(n, device="cpu")`` stands in for the 8 forced host devices
of JAX's tests (tests/conftest.py). The flax weights of
``tests/test_torch_port_app.py`` (both hands plausible and inside the
frame), numpy-seeded frames at 64 px, render 64, both hands forced
detected. Tolerances are tests/test_parallel.py's: verts 2e-4 and
pj2d_org 2e-3 for the pipeline; for the chunk step ``_rgba`` 1.5/255,
``cam_trans`` 5e-3 (the LS solve amplifies the reassociation of sums
over another batch size), ``pj2d_org`` 2e-3 and every other leaf 2e-4;
the detection flags and the probe equal.
"""

import os

import numpy as np
import pytest
import torch

import jax

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import unflatten_params
from acr_tpu.pipeline.infer import ACRPipeline as JaxACRPipeline
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.parallel import mesh as pm
from acr_tpu_torch.pipeline.app import ACRApp
from acr_tpu_torch.pipeline.infer import ACRPipeline
from test_torch_port_app import MANO_DIR, flat  # noqa: F401 (fixture)
from test_torch_port_dp_cuda import assert_same_chunk
from test_torch_port_stream import state_leaves

torch.set_num_threads(2)
SIZE = 64


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, SIZE, SIZE, 3) * 255).astype(np.uint8)
    offs = np.tile(np.array([[SIZE, SIZE, 0, 0, 0, 0, 0, 0, 0, 0]],
                            np.float32), (n, 1))
    return imgs, offs


def _cfg(**over):
    kw = dict(input_size=SIZE, render_size=SIZE, mano_model_path=MANO_DIR,
              configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
              demo_mode="folder", val_batch_size=4)
    kw.update(over)
    return Config(**kw)


def _app(flat, tmp_path, name, **over):
    return ACRApp(_cfg(output_dir=str(tmp_path / name) + "/", **over),
                  params=from_flax(flat), device="cpu")


def _host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def test_make_mesh_counts(monkeypatch):
    mesh = pm.make_mesh(4, device="cpu")
    assert mesh.size == 4 and len(mesh.devices) == 4
    assert mesh.lead == torch.device("cpu") and mesh.local_shards() == range(4)
    # a device may be named twice: one card runs the sharded path
    twice = pm.make_mesh(2, devices=["cpu", "cpu"])
    assert twice.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        pm.make_mesh(3, devices=["cpu", "cpu"])
    # by default the first local cards: more replicas than cards raise
    # with JAX's message
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.make_mesh(2).devices == (torch.device("cuda", 0),
                                       torch.device("cuda", 1))
    with pytest.raises(ValueError, match="requested 10 devices, have 2"):
        pm.make_mesh(10)


def test_make_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pm.make_mesh(2)


def test_init_distributed_unconfigured_is_noop(monkeypatch):
    monkeypatch.delenv("ACR_COORDINATOR", raising=False)
    assert pm.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_pad_split_gather():
    x = torch.arange(5 * 3).reshape(5, 3)
    padded, pad = pm.pad_batch(x, 4)
    assert pad == 3 and padded.shape == (8, 3)
    assert torch.equal(padded[5:], x[-1:].expand(3, 3))
    assert pm.pad_batch(x, 5)[1] == 0
    shards = pm.split_batch(padded, 4)
    assert [s.shape[0] for s in shards] == [2] * 4
    with pytest.raises(ValueError, match="equal shards"):
        pm.split_batch(x, 2)
    mesh = pm.make_mesh(4, device="cpu")
    outs = [{"a": s, "b": s[:, 0] > 3} for s in shards]
    got = pm.gather_outputs(mesh, outs)
    assert torch.equal(got["a"], padded) and got["b"].dtype == torch.bool
    assert torch.equal(got["b"], padded[:, 0] > 3)


def test_dp_pipeline_matches_jax_and_single_replica(flat):
    """3 frames over 4 replicas (padded to 4, trimmed) against JAX's
    data_parallel=4 over 4 of its forced host devices and the port's one
    replica."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual JAX devices")
    imgs, offs = _frames(3)
    jcfg = JaxConfig(input_size=SIZE, mano_model_path=MANO_DIR,
                     configs_yml="", centermap_conf_thresh=-1e9,
                     data_parallel=4)
    want = JaxACRPipeline(jcfg, params=unflatten_params(flat))(imgs, offs)
    one = _host(ACRPipeline(_cfg(data_parallel=1), params=from_flax(flat),
                            device="cpu")(imgs, offs))
    pipe = ACRPipeline(_cfg(data_parallel=4), params=from_flax(flat),
                       device="cpu")
    assert pipe.mesh.size == 4 and len(pipe.replicas) == 4
    got = _host(pipe(imgs, offs))
    assert got["verts"].shape == (3, 2, 778, 3)
    for ref in (np.asarray(want["verts"]), one["verts"]):
        np.testing.assert_allclose(got["verts"], ref, atol=2e-4)
    for ref in (np.asarray(want["pj2d_org"]), one["pj2d_org"]):
        np.testing.assert_allclose(got["pj2d_org"], ref, atol=2e-3)
    np.testing.assert_array_equal(got["detection_flag"],
                                  np.asarray(want["detection_flag"]))
    np.testing.assert_array_equal(got["detection_flag"],
                                  one["detection_flag"])


@pytest.mark.parametrize("override", [
    dict(model_precision="bf16"),
    dict(quantize="int8"),
])
def test_replicas_copy_the_served_weights(flat, override):
    """One copy of the network per replica, made at load, in the dtype
    and quantization it serves; the MANO assets on each replica."""
    pipe = ACRPipeline(_cfg(data_parallel=2, **override),
                       params=from_flax(flat), device="cpu")
    lead, other = pipe.replicas
    assert lead.net is pipe.net and other.net is not pipe.net
    a, b = lead.net.state_dict(), other.net.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        assert a[k].data_ptr() != b[k].data_ptr(), k
    dtypes = {v.dtype for v in a.values()}
    assert (torch.bfloat16 in dtypes) == (override.get("model_precision")
                                          == "bf16")
    assert (torch.int8 in dtypes) == ("quantize" in override)
    assert type(other.mano_l) is type(pipe.mano_l)


@pytest.mark.parametrize("probe", [0, 1])
def test_dp_chunk_matches_single_replica(flat, tmp_path, probe):
    """The sharded chunk step (forward and render per replica, gathered,
    the probe reduced over the chunk) against one replica's."""
    imgs, offs = _frames(4, seed=1)
    outs = {}
    for dp in (1, 4):
        app = _app(flat, tmp_path, f"dp{dp}", data_parallel=dp,
                   raster_overflow_every=probe)
        assert app._fused_bypass_reason is None
        assert app._sharded_chunk == (dp > 1)
        outs[dp] = _host(app.chunk_step(imgs, offs))
    assert outs[4]["_rgba"].shape == (4, 4, SIZE, SIZE)
    assert outs[4]["_rgba"][:, 3].any()
    assert ("_raster_overflow" in outs[4]) == bool(probe)
    assert_same_chunk(outs[4], outs[1])


def test_dp_bypass_reasons(flat, tmp_path):
    """-t and a val_batch_size that does not divide the mesh take the
    per-stage path with JAX's reasons, and still equal one replica: the
    forward sharded, OneEuro, refine and render on the lead replica. The
    stream step's forward runs sharded too (its one frame padded)."""
    imgs, offs = _frames(3, seed=2)
    app_t = _app(flat, tmp_path, "t", data_parallel=4,
                 temporal_optimization=True)
    assert not app_t._sharded_chunk
    assert "OneEuro" in app_t._fused_bypass_reason
    app_bs = _app(flat, tmp_path, "bs", data_parallel=4, val_batch_size=3)
    assert not app_bs._sharded_chunk
    assert "divide" in app_bs._fused_bypass_reason
    one_t = _app(flat, tmp_path, "t1", temporal_optimization=True)
    for _ in range(2):                      # the filter state carries over
        assert_same_chunk(_host(app_t.chunk_step(imgs, offs)),
                          _host(one_t.chunk_step(imgs, offs)))
    for a, b in zip(state_leaves(app_t.filter_state),
                    state_leaves(one_t.filter_state)):
        np.testing.assert_allclose(a, b, atol=2e-4)
    one = _app(flat, tmp_path, "one", val_batch_size=3)
    assert_same_chunk(_host(app_bs.chunk_step(imgs, offs)),
                      _host(one.chunk_step(imgs, offs)))
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    meta = img_preprocess(imgs[0][:48], "f.jpg", input_size=SIZE)
    got = app_bs.unpack_stream(app_bs.stream_step(meta))
    assert_same_chunk(got, one.unpack_stream(one.stream_step(meta)))


def test_dp_folder_mode_end_to_end(flat, tmp_path):
    """run_folder on a 4-replica mesh: 3 frames padded to one chunk of 4
    take the sharded chunk step and write 3 rendered frames."""
    import cv2
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.RandomState(3)
    for i in range(3):
        cv2.imwrite(str(frames_dir / f"{i:06d}.jpg"),
                    (rng.rand(48, 64, 3) * 255).astype(np.uint8))
    app = _app(flat, tmp_path, "out", data_parallel=4,
               inputs=str(frames_dir))
    assert app._sharded_chunk, app._fused_bypass_reason
    results = app.run()
    assert len(results) == 3
    outs = os.listdir(app.output_dir)
    assert sum(o.endswith(".jpg") for o in outs) == 3
    assert app.last_output["_rgba"].shape == (3, 4, SIZE, SIZE)
