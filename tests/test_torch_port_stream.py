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

When a frame in flight lets the next frame be read (``PaceRule``): on a
virtual clock, the rule sleeps only after ``ENTER`` turns that each
waited beyond the margin, never more than the last of those waits less
the margin, and never where the host sets the pace, the waits stay under
the margin or the step has no event; after a late turn it paces from the
late issue's start and is not late itself; ``TURNS`` counts the paced and
late turns. Through the loop, a
stub device whose fake events pass 60 ms apart and a source that returns
the newest frame of a fast clock: paced, a frame's read-to-delivery time
falls by at least 40 % against the loop with the rule's sleep held at 0,
as many frames a second are delivered, in the order read, each with its
own frame's outputs. A source that blocks past the step reads the same
frames in the same order either way.
"""

import os
import pickle
import time
import types

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
from acr_tpu_torch.pipeline.app import ACRApp, StreamOutputs, readback
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.pipeline.results import reorganize_results
from acr_tpu_torch.pipeline import streaming
from acr_tpu_torch.pipeline.streaming import (DrainRule, PaceRule,
                                              StreamingLoop, SyntheticSource)
from acr_tpu_torch.utils.meters import SpanTimer
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


def drain_order(n, drained):
    """The log of ``n`` turns whose last ``drained`` drained: each turn
    reads its frame, then delivers the frame before it, or, drained, its
    own."""
    first, order = n - drained, []
    for k in range(n):
        order.append(("read", k))
        if 0 < k <= first:
            order.append(("deliver", k - 1))
        if k >= first:
            order.append(("deliver", k))
    if first == n:
        order.append(("deliver", n - 1))
    return order


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
    assert log == drain_order(n, drained)
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


# --- when a frame in flight lets the next frame be read ---

PACE_ENTER = PaceRule.ENTER


def _lead_jitter(i):
    return 0.2 * MS * (i % 4)


def _device_jitter(i):
    return 0.5 * MS * (i % 3)


# per case: turns, device ms a step, lead ms, extra issue ms by turn,
# whether the step has an event
PACE_CASES = {
    # the device sets the pace: paced once ENTER turns waited
    "device_bound": (40, 60.0, 10.0, {}, True),
    # an issue far over its quantile: the paced turn is late
    "late": (40, 60.0, 10.0, {20: 20.0, 31: 20.0}, True),
    # the host sets the pace: the frame in flight is done at every readback
    "host_bound": (40, 8.0, 10.0, {}, True),
    # the waits stay under the margin (leads spread by 4 ms)
    "under_margin": (40, 12.0, 10.0, {i: 4.0 * (i % 2) for i in range(40)},
                     True),
    # a synchronous step: no event, no wait
    "no_event": (40, 60.0, 10.0, {}, False),
}
ISSUE_MS = 2.0


def simulate_pacing(turns, device_ms, lead_ms, extra, event):
    """``PaceRule`` driven on a virtual clock: each turn sleeps what the
    rule says, then reads and preprocesses, then issues for the last
    ``ISSUE_MS`` of its lead and what ``extra`` adds; the frame's step
    starts when the device is free and the step's front is in, just after
    the issue began. The readback waits for the frame in flight, then
    delivers (0.5 ms). Returns per turn (sleep, margin, the last ENTER
    slacks, wait, late)."""
    streaming.TURNS.clear()
    rule, now, free, prev, log = PaceRule(), 0.0, 0.0, None, []
    for i in range(turns):
        margin = rule.margin() if len(rule.devices) >= 2 else 0.0
        recent = list(rule.slacks)[-PACE_ENTER:]
        slept = rule.sleep_s(now) if prev is not None else 0.0
        start = now + slept
        issue = start + (lead_ms - ISSUE_MS) * MS + _lead_jitter(i)
        issued = issue + (ISSUE_MS + extra.get(i, 0.0)) * MS
        device = device_ms * MS + _device_jitter(i)
        free = max(free, issue + 0.1 * MS) + device
        waited = 0.0
        if prev is not None:
            done_at, prev_device = prev
            if event and done_at > issued:
                waited = done_at - issued
            rule.done(issued - start, waited, prev_device if event else None,
                      done_at if waited else None, issue)
        log.append((slept, margin, recent, waited,
                    prev is not None and slept > 0 and not waited))
        now = issued + waited + 0.5 * MS
        prev = (free, device)
    return log


@pytest.mark.parametrize("case", PACE_CASES)
def test_pace_rule_sleeps_while_the_device_is_behind(case):
    turns, device_ms, lead_ms, extra, event = PACE_CASES[case]
    log = simulate_pacing(turns, device_ms, lead_ms, extra, event)
    paced = [i for i, (slept, *_) in enumerate(log) if slept]
    late = [i for i, (*_, was_late) in enumerate(log) if was_late]
    for i, (slept, margin, recent, _, _) in enumerate(log):
        if slept:
            # only after ENTER turns that each waited beyond the margin,
            # and never beyond the last of those waits less the margin
            assert len(recent) == PACE_ENTER and min(recent) > margin, i
            assert slept <= recent[-1] - margin + 1e-12, i
    assert dict(streaming.TURNS) == {
        k: v for k, v in (("paced", len(paced)), ("late", len(late))) if v}
    if case in ("host_bound", "under_margin", "no_event"):
        assert not paced
        return
    # after a late turn the next paces from the late issue's start, the
    # earliest the frame in flight can have started: it is not late
    for i in late:
        assert log[i + 1][0] and not log[i + 1][4], i + 1
    assert late == sorted(extra)
    assert len(paced) == turns - PACE_ENTER - 1, paced
    # paced, the frame in flight's wait falls to under a tenth of the
    # step's (until a window holds two late leads)
    waits = [w for (slept, _, _, w, _) in log if slept]
    assert (max(waits) if not extra else np.median(waits)) \
        < 0.1 * device_ms * MS, waits


class Clocked:
    """A fake CUDA event that passes at host time ``t``; as a CUDA event's
    does, its ``synchronize`` spins for the last of its wait."""

    def __init__(self, t):
        self.t = t

    def query(self):
        return time.perf_counter() >= self.t

    def synchronize(self):
        time.sleep(max(0.0, self.t - time.perf_counter() - 2 * MS))
        while not self.query():
            pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class StubDevice:
    """``ACRApp``'s stream interface over a fake device whose step takes
    ``step_s``: a frame's step starts when the step before it has ended,
    or at its issue, and its ``copied`` event passes ``step_s`` later.
    Its outputs are a function of the frame; the readback is the app's own
    ``unpack_stream``."""

    unpack_stream = ACRApp.unpack_stream
    _consume_overflow_probe = ACRApp._consume_overflow_probe

    def __init__(self, step_s):
        self.step_s, self.free = step_s, 0.0
        self.cfg = types.SimpleNamespace(input_size=2)
        self.timer, self.visualizer = SpanTimer(), None
        self.pipeline = self

    def preprocess(self, frame, name, input_size):
        return {"image": frame}

    def count(self, out):
        pass

    def stream_step(self, meta):
        frame = meta["image"]
        out = StreamOutputs(
            detection_flag=torch.ones(2, dtype=torch.bool),
            value=torch.from_numpy(frame.astype(np.float32) * 0.5 + 1.0))
        out.host = {k: v.clone() for k, v in out.items()}
        start = max(self.free, time.perf_counter())
        self.free = start + self.step_s
        out.started, out.copied = Clocked(start), Clocked(self.free)
        return out


class FastCamera:
    """The newest capture of a 1000 frames/s camera, never the same one
    twice; capture k's frame is filled with k."""

    def __init__(self, n):
        self.n, self.t0, self.last, self.reads = n, None, -1, []

    def read(self):
        if len(self.reads) == self.n:
            return None
        now = time.perf_counter()
        self.t0 = now if self.t0 is None else self.t0
        k = max(int((now - self.t0) * 1000.0), self.last + 1)
        time.sleep(max(0.0, self.t0 + k / 1000.0 - now))
        self.last = k
        self.reads.append(k)
        return np.full((2, 3), k, dtype=np.int64)


STEP_S = 0.06


def _stub_run(source):
    """The stub through ``StreamingLoop``: the frames delivered, their
    outputs, the delivery times and each frame's read-to-delivery ms."""
    got, at = [], []

    def deliver(img, out):
        got.append((int(img[0, 0]), out))
        at.append(time.perf_counter())
    loop = StreamingLoop(StubDevice(STEP_S), on_result=deliver)
    n = loop.run(source)
    assert n == len(got)
    return got, at, loop.latencies


def test_paced_loop_reads_later_and_keeps_the_rate(monkeypatch):
    n = 24
    streaming.TURNS.clear()
    paced, paced_at, paced_ms = _stub_run(FastCamera(n))
    turns = dict(streaming.TURNS)
    monkeypatch.setattr(PaceRule, "sleep_s", lambda self, now: 0.0)
    unpaced, unpaced_at, unpaced_ms = _stub_run(FastCamera(n))
    assert turns["inflight"] == n and "drained" not in turns
    # the first paced turn may be late: the unpaced turns' leads hold no
    # sleep's wake-up
    assert turns["paced"] >= n - PACE_ENTER - 6, turns
    assert turns.get("late", 0) <= turns["paced"] // 4, turns
    # after the entry turns each frame is read about one step later
    skip = PACE_ENTER + 2
    assert (np.median(paced_ms[skip:])
            <= 0.6 * np.median(unpaced_ms[skip:])), (paced_ms, unpaced_ms)
    # as many frames a second
    rate = (n - 1) / (paced_at[-1] - paced_at[0])
    unpaced_rate = (n - 1) / (unpaced_at[-1] - unpaced_at[0])
    assert abs(rate / unpaced_rate - 1.0) <= 0.05, (rate, unpaced_rate)
    # delivered in the order read, each with its own frame's outputs: those
    # the unpaced loop gave that frame, bit for bit
    for got in (paced, unpaced):
        ids = [k for k, _ in got]
        assert ids == sorted(set(ids))
    want = dict(unpaced)
    shared = [k for k, _ in paced if k in want]
    for k, out in paced:
        np.testing.assert_array_equal(
            out["value"], np.full((2, 3), k, np.float32) * 0.5 + 1.0)
        if k in want:
            assert out.keys() == want[k].keys()
            for key in out:
                np.testing.assert_array_equal(out[key], want[k][key])
    assert shared, "no frame read by both loops"


class SyntheticIds(SyntheticSource):
    """``SyntheticSource`` whose frame k is filled with k."""

    def __init__(self, n):
        self.frames = [np.full((2, 3), k, dtype=np.int64) for k in range(n)]
        self.idx = 0


def test_camera_paced_read_is_unpaced(monkeypatch):
    n = PACE_ENTER + 5
    logs = []
    for pacing in (True, False):
        if not pacing:
            monkeypatch.setattr(PaceRule, "sleep_s", lambda self, now: 0.0)
        streaming.TURNS.clear()
        log = []
        loop = StreamingLoop(StubDevice(STEP_S), on_result=lambda img, out:
                             log.append(("deliver", int(img[0, 0]))))
        assert loop.run(Logged(SyntheticIds(n), log, STEP_S + 0.02)) == n
        assert "paced" not in streaming.TURNS, dict(streaming.TURNS)
        logs.append(log)
    # the read blocks past the frame in flight's step: the same frames in
    # the same order as without pacing, drained once the rule has its run
    assert logs[0] == logs[1] == drain_order(n, n - ENTER - 1)


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
