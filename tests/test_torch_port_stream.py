"""Port StreamingLoop and folder mode with -t against the JAX package.

Both apps run webcam (or folder) mode with OneEuro smoothing at 128 px
input and render, on the same flax weights (``visible_hands``: both
hands plausible and inside the frame) with both hands forced detected
(centermap_conf_thresh below every score). Per frame, the reference-
format results agree to float16 resolution and the RGBA renders as in
``tests/test_torch_port_app.py``: the same coverage, shading to 1e-3.
The OneEuro states agree to 1e-5. The port's loop also yields its
``SpanTimer`` spans, once per frame, into the records and a profiler's
trace while the timer records, and nothing while it does not. On the
CPU the loop reads each frame back through ``readback``: over eight
frames, with and without ``-t`` and render, it delivers what a plain
``stream_step`` and ``readback`` give, bit for bit, and ``READBACK``
counts a ``sync`` a frame and no ``event``.

When to deliver a frame (``DrainRule``): fed synthetic (block, wait)
sequences, the rule enters drain mode only after ``ENTER`` reads in a
row blocked longer than the wait by more than the margin, never while
the block is below the wait, stays while the reads still block, and
leaves at the first read that does not; ``TURNS`` counts each turn once.
Through the loop, a source whose read sleeps 20 ms drains once the rule
has its run of reads (each drained frame delivered before the next read)
and an unpaced one never does; either way the outputs and the OneEuro
state equal the in-flight loop's bit for bit, and JAX's loop as above.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import unflatten_params
from acr_tpu.pipeline.app import ACRApp as JaxACRApp
from acr_tpu.pipeline.streaming import StreamingLoop as JaxStreamingLoop
from acr_tpu.pipeline.streaming import SyntheticSource as JaxSyntheticSource
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.pipeline import app as app_mod
from acr_tpu_torch.pipeline.app import ACRApp, readback
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.pipeline.results import reorganize_results
from acr_tpu_torch.pipeline import streaming
from acr_tpu_torch.pipeline.streaming import (DrainRule, StreamingLoop,
                                              SyntheticSource)
from test_torch_port_app import MANO_DIR, flat  # noqa: F401 (fixture)

torch.set_num_threads(2)


def _kw(tmp_path, name, **over):
    kw = dict(input_size=128, render_size=128, mano_model_path=MANO_DIR,
              configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
              temporal_optimization=True, demo_mode="webcam",
              output_dir=str(tmp_path / name) + "/")
    kw.update(over)
    return kw


def assert_same_results(got, want):
    """Reference-format results dicts: float16 leaves to their
    resolution, the rest equal."""
    assert got.keys() == want.keys()
    for path in want:
        assert len(got[path]) == len(want[path]) == 2          # both hands
        for g, w in zip(got[path], want[path]):
            assert g.keys() == w.keys()
            for key in w:
                gv, wv = np.asarray(g[key]), np.asarray(w[key])
                assert gv.dtype == wv.dtype, key
                if gv.dtype == np.float16:
                    np.testing.assert_allclose(
                        gv.astype(np.float32), wv.astype(np.float32),
                        rtol=2e-3, atol=1e-3, err_msg=key)
                else:
                    np.testing.assert_array_equal(gv, wv, err_msg=key)


def state_leaves(state):
    """The leaves of a OneEuro state (NamedTuples of arrays), in order."""
    if isinstance(state, tuple):
        return [x for s in state for x in state_leaves(s)]
    return [np.asarray(state)]


def test_streaming_loop_matches_jax(flat, tmp_path):
    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax")),
                     params=unflatten_params(flat))
    app = ACRApp(Config(**_kw(tmp_path, "port")), params=from_flax(flat),
                 device="cpu")
    want, got = [], []
    n_j = JaxStreamingLoop(japp, on_result=lambda img, out: want.append(
        (img, out))).run(JaxSyntheticSource(4))
    n_t = StreamingLoop(app, on_result=lambda img, out: got.append(
        (img, out))).run(SyntheticSource(4))
    assert n_j == n_t == 4
    for k, ((w_img, w_out), (g_img, g_out)) in enumerate(zip(want, got)):
        assert g_out["detection_flag"].all()
        assert_same_results(reorganize_results(g_out, [str(k)]),
                            reorganize_results(w_out, [str(k)]))
        # JAX packs its RGBA to 8 bits for the readback; hold the port's
        # float RGBA against JAX's float render of its own outputs
        w_rgba = np.asarray(japp.visualizer.render_rgba_device(
            {key: jnp.asarray(w_out[key]) for key in
             ("verts", "cam_trans", "detection_flag")}))
        g_rgba = g_out["_rgba"]
        assert g_rgba.shape == w_rgba.shape == (4, 128, 128)
        assert g_rgba[3].sum() > 500
        np.testing.assert_array_equal(g_rgba[3], w_rgba[3])
        np.testing.assert_allclose(g_rgba, w_rgba, atol=1e-3)
        assert g_img.shape == w_img.shape == (96, 128, 3)
        assert np.abs(g_img.astype(int) - w_img.astype(int)).mean() < 1.0
    # the OneEuro state advanced and agrees leaf for leaf
    assert bool(app.filter_state.left.betas.initialized)
    g_state = state_leaves(app.filter_state)
    w_state = jax.tree.leaves(japp.filter_state)
    assert len(g_state) == len(w_state) == 24
    for g, w in zip(g_state, w_state):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


# the loop's spans and the step's, each once per frame
FRAME_SPANS = {"stream.preprocess": None, "stream.issue": None,
               "issue.forward": "stream.issue", "issue.smooth": "stream.issue",
               "issue.render": "stream.issue", "stream.readback": None,
               "stream.composite": None, "stream.deliver": None,
               "stream.frame": None}


def _span_app(flat, tmp_path):
    return ACRApp(Config(**_kw(tmp_path, "spans")), params=from_flax(flat),
                  device="cpu")


def test_streaming_loop_spans(flat, tmp_path):
    app = _span_app(flat, tmp_path)
    app.timer.recording = True
    got = []
    assert StreamingLoop(app, on_result=lambda img, out: got.append(
        img)).run(SyntheticSource(3)) == 3
    spans = app.timer.spans()
    # stream.read also times the read that ends the source
    assert [f for n, _, f, _, _ in spans if n == "stream.read"] == [0, 1, 2, 3]
    for name, parent in FRAME_SPANS.items():
        mine = [s for s in spans if s[0] == name]
        assert [f for _, _, f, _, _ in mine] == [0, 1, 2], name
        assert {p for _, p, _, _, _ in mine} == {parent}, name
    for k in range(3):
        (frame,) = [s for s in spans if s[0] == "stream.frame" and s[2] == k]
        for name, _, f, t0, t1 in spans:
            if f == k and name not in ("stream.read", "stream.frame"):
                assert frame[3] <= t0 <= t1 <= frame[4], name
    assert app.timer.report()["stream.frame"]["count"] == 3


def test_streaming_loop_spans_in_trace(flat, tmp_path):
    import json
    from acr_tpu_torch.utils.profiling import profile_trace
    app = _span_app(flat, tmp_path)
    d = tmp_path / "trace"
    with profile_trace(str(d), "cpu", app.timer):
        assert StreamingLoop(app).run(SyntheticSource(2)) == 2
    (name,) = os.listdir(d)
    with open(d / name) as f:
        events = json.load(f)["traceEvents"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    issues = [e for e in notes if e["name"] == "acr.stream.issue"]
    forwards = [e for e in notes if e["name"] == "acr.issue.forward"]
    assert len(issues) == len(forwards) == 2
    for outer, inner in zip(sorted(issues, key=lambda e: e["ts"]),
                            sorted(forwards, key=lambda e: e["ts"])):
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # stream.frame spans two turns: in memory only
    assert "acr.stream.frame" not in {e["name"] for e in notes}
    assert len([s for s in app.timer.spans() if s[0] == "stream.frame"]) == 2


def test_streaming_loop_off_records_nothing(flat, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with recording off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    app = _span_app(flat, tmp_path)
    loop = StreamingLoop(app, on_result=lambda img, out: None)
    assert loop.run(SyntheticSource(2)) == 2
    assert app.timer.spans() == []
    assert len(loop.latencies) == 2
    counts = {k: v["count"] for k, v in app.timer.report().items()}
    assert counts == {**{name: 2 for name in FRAME_SPANS}, "stream.read": 3}


@pytest.mark.parametrize("visual", [True, False], ids=["render", "no_render"])
@pytest.mark.parametrize("temporal", [True, False], ids=["t", "no_t"])
def test_streaming_loop_delivers_plain_readback(flat, tmp_path, temporal,
                                                visual):
    def make(name):
        return ACRApp(Config(**_kw(tmp_path, name,
                                   temporal_optimization=temporal,
                                   save_visualization_on_img=visual,
                                   raster_overflow_every=1)),
                      params=from_flax(flat), device="cpu")
    source = SyntheticSource(8)
    app_mod.READBACK.clear()
    got = []
    assert StreamingLoop(make("loop"), on_result=lambda img, out: got.append(
        out)).run(source) == 8
    assert dict(app_mod.READBACK) == {"sync": 8}
    plain = make("plain")
    for k, (frame, out) in enumerate(zip(source.frames, got)):
        want = readback(plain.stream_step(
            img_preprocess(frame, str(k), input_size=128)))
        want.pop("_raster_overflow", None)
        assert out.keys() == want.keys()
        assert ("_rgba" in out) == visual
        for key in want:
            assert out[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)


# --- when a frame is delivered ---

MS = 1e-3
ENTER = DrainRule.ENTER


def _jitter(i):
    return 0.01 * MS * (i % 3)


# (block ms, wait ms) per turn, and the first turn of each mode switch:
# the wait read back in a turn is seen from the next turn's read on
TURN_CASES = {
    # a run of ENTER blocked reads after the first turn, which has no wait
    "enters": ([(20, 5)] * 20, {1 + ENTER - 1: True}),
    # a read below the wait breaks the run; it starts again after it
    "run_broken": ([(20, 5)] * (ENTER - 2) + [(4, 5)] + [(20, 5)] * 14,
                   {2 * ENTER - 2: True}),
    # the drained turns still block, by less than before: it stays
    "stays": ([(20, 5)] * 12 + [(15, 5)] * 8, {ENTER: True}),
    # the first read that does not block leaves, and the run starts anew
    "leaves": ([(20, 5)] * 12 + [(0, 5)] + [(20, 5)] * 12,
               {ENTER: True, 12: False, 12 + ENTER: True}),
    # never while the read blocks less than the wait, however long
    "below_wait": ([(4, 5)] * 60, {}),
}


@pytest.mark.parametrize("case", TURN_CASES)
def test_drain_rule_enters_and_leaves(case):
    turns, switches = TURN_CASES[case]
    streaming.TURNS.clear()
    rule, got = DrainRule(), []
    for i, (blocked, wait) in enumerate(turns):
        got.append(rule.read(blocked * MS + _jitter(i)))
        rule.done(1 * MS + _jitter(i + 1), wait * MS)
    want, mode = [], False
    for i in range(len(turns)):
        mode = switches.get(i, mode)
        want.append(mode)
    assert got == want
    left = sum(1 for a, b in zip(want, want[1:]) if a and not b)
    assert dict(streaming.TURNS) == {
        k: v for k, v in (("drained", sum(want)),
                          ("inflight", len(want) - sum(want)),
                          ("left", left)) if v}


class Logged:
    """``SyntheticSource``'s frames from a read that sleeps ``sleep_s``
    first; logs each read."""

    def __init__(self, source, log, sleep_s):
        self.source, self.log, self.sleep_s = source, log, sleep_s

    def read(self):
        time.sleep(self.sleep_s)
        frame = self.source.read()
        if frame is not None:
            self.log.append(("read", self.source.idx - 1))
        return frame


@pytest.mark.parametrize("paced", [True, False], ids=["paced", "unpaced"])
def test_loop_drains_where_the_read_blocks(flat, tmp_path, paced):
    n = ENTER + 5

    def run(name, source, log):
        app = ACRApp(Config(**_kw(tmp_path, name)), params=from_flax(flat),
                     device="cpu")
        got = []

        def deliver(img, out):
            log.append(("deliver", len(got)))
            got.append((img, out))
        assert StreamingLoop(app, on_result=deliver).run(source) == n
        return app, got

    streaming.TURNS.clear()
    log = []
    app, got = run("loop", Logged(SyntheticSource(n), log,
                                  0.02 if paced else 0.0), log)
    turns = dict(streaming.TURNS)
    # the first turn has no wait, then ENTER reads make the run
    drained = n - ENTER - 1 if paced else 0
    assert turns == ({"drained": drained, "inflight": n - drained}
                     if drained else {"inflight": n})
    # each turn reads its frame, then delivers the frame before it, or,
    # drained, its own
    first, order = n - drained, []
    for k in range(n):
        order.append(("read", k))
        if 0 < k <= first:
            order.append(("deliver", k - 1))
        if k >= first:
            order.append(("deliver", k))
    if first == n:
        order.append(("deliver", n - 1))
    assert log == order
    # the in-flight loop's outputs and state, bit for bit
    ref_app, want = run("inflight", SyntheticSource(n), [])
    for (g_img, g_out), (w_img, w_out) in zip(got, want):
        np.testing.assert_array_equal(g_img, w_img)
        assert g_out.keys() == w_out.keys()
        for key in w_out:
            np.testing.assert_array_equal(g_out[key], w_out[key], err_msg=key)
    for g, w in zip(state_leaves(app.filter_state),
                    state_leaves(ref_app.filter_state)):
        np.testing.assert_array_equal(g, w)
    if not paced:
        return
    # and JAX's loop, as test_streaming_loop_matches_jax holds them
    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax")),
                     params=unflatten_params(flat))
    jax_out = []
    JaxStreamingLoop(japp, on_result=lambda img, out: jax_out.append(
        out)).run(JaxSyntheticSource(n))
    assert len(jax_out) == n
    for k, ((_, g_out), w_out) in enumerate(zip(got, jax_out)):
        assert_same_results(reorganize_results(g_out, [str(k)]),
                            reorganize_results(w_out, [str(k)]))
    for g, w in zip(state_leaves(app.filter_state),
                    jax.tree.leaves(japp.filter_state)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(7)
    for i in range(3):
        cv2.imwrite(str(d / f"{i:06d}.jpg"),
                    (rng.rand(96, 128, 3) * 255).astype(np.uint8))
    return str(d)


def test_folder_mode_matches_jax(flat, tmp_path, frames_dir):
    kw = dict(demo_mode="folder", inputs=frames_dir, save_dict_results=True,
              val_batch_size=1)
    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax", **kw)),
                     params=unflatten_params(flat))
    want = japp.run()
    app = ACRApp(Config(**_kw(tmp_path, "port", **kw)), params=from_flax(flat),
                 device="cpu")
    got = app.run()
    assert len(got) == 3
    assert_same_results(got, want)
    # the same files: three rendered frames, the results pickle, the video
    outs = sorted(os.listdir(app.output_dir))
    assert outs == sorted(os.listdir(japp.output_dir))
    assert sum(o.endswith(".jpg") for o in outs) == 3
    assert sum(o.endswith(".mp4") for o in outs) == 1
    pkls = [o for o in outs if o.endswith(".pkl")]
    assert len(pkls) == 1
    with open(os.path.join(app.output_dir, pkls[0]), "rb") as f:
        assert set(pickle.load(f)) == set(got)
    for a, b in zip(state_leaves(app.filter_state),
                    jax.tree.leaves(japp.filter_state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
