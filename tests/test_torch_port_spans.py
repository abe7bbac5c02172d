"""``utils.meters.SpanTimer``: the port's stages as spans, and
``profile_trace`` carrying them into its Chrome trace.

The stream loop's spans are tested in ``tests/test_torch_port_stream.py``
on the small app built there.
"""

import json
import os

import pytest
import torch

from acr_tpu_torch.utils.meters import SpanTimer, StageTimer
from acr_tpu_torch.utils.profiling import profile_trace

FOLDER_STAGES = ("preprocess", "device_step", "render", "encode")


def no_record_function(monkeypatch):
    """Make any call of ``torch.profiler.record_function`` fail the test."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with recording off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_timer_records_nested_stages():
    timer = SpanTimer()
    timer.recording = True
    with timer.stage("outer", frame=7):
        with timer.stage("inner"):
            with timer.stage("leaf", frame=8):
                pass
        with timer.stage("inner"):
            pass
    with timer.stage("alone"):
        pass
    spans = timer.spans()
    # a record is appended when its stage closes: innermost first
    assert [(n, p, f) for n, p, f, _, _ in spans] == [
        ("leaf", "inner", 8), ("inner", "outer", 7), ("inner", "outer", 7),
        ("outer", None, 7), ("alone", None, None)]
    for _, _, _, t0, t1 in spans:
        assert t0 <= t1
    leaf, first, second, outer, alone = spans
    assert outer[3] <= first[3] <= leaf[3] <= leaf[4] <= first[4] \
        <= second[3] <= second[4] <= outer[4] <= alone[3]
    # the running averages are StageTimer's
    report = timer.report()
    assert report["inner"]["count"] == 2 and report["outer"]["count"] == 1
    assert report["outer"]["last_ms"] == pytest.approx(
        (outer[4] - outer[3]) * 1e3)
    timer.clear()
    assert timer.spans() == []
    assert timer._open == []


def test_span_timer_off_records_nothing(monkeypatch):
    no_record_function(monkeypatch)
    timer = SpanTimer()
    assert timer.recording is False
    with timer.stage("outer", frame=1):
        with timer.stage("inner"):
            pass
    timer.add_span("frame", 1.0, 1.25, frame=1)
    assert timer.spans() == []
    assert {k: v["count"] for k, v in timer.report().items()} == {
        "outer": 1, "inner": 1, "frame": 1}
    assert timer.report()["frame"]["avg_ms"] == pytest.approx(250.0)


def test_span_timer_limits_its_records(monkeypatch):
    monkeypatch.setattr(SpanTimer, "MAX_RECORDS", 3)
    timer = SpanTimer()
    timer.recording = True
    for k in range(5):
        with timer.stage("s", frame=k):
            pass
    assert [f for _, _, f, _, _ in timer.spans()] == [2, 3, 4]
    assert timer.report()["s"]["count"] == 5


@pytest.mark.parametrize("recording", [False, True])
def test_span_timer_reports_as_stage_timer(recording):
    # the folder readers and run_folder's log read these four stages
    old, new = StageTimer(), SpanTimer()
    new.recording = recording
    for timer in (old, new):
        for k, name in enumerate(FOLDER_STAGES):
            for _ in range(k + 1):
                with timer.stage(name):
                    pass
        timer.add("preprocess", 5.0)
    want, got = old.report(), new.report()
    assert list(got) == list(want) == list(FOLDER_STAGES)
    for name in FOLDER_STAGES:
        assert got[name]["count"] == want[name]["count"]
    assert got["preprocess"]["last_ms"] == want["preprocess"]["last_ms"] == 5.0
    assert len(new.spans()) == (10 if recording else 0)


def test_add_span_keeps_no_parent():
    timer = SpanTimer()
    timer.recording = True
    with timer.stage("open", frame=3):
        timer.add_span("frame", 2.0, 2.5, frame=2)
    assert timer.spans()[0] == ("frame", None, 2, 2.0, 2.5)
    assert timer.report()["frame"]["last_ms"] == pytest.approx(500.0)


def test_profile_trace_carries_the_spans(tmp_path):
    timer = SpanTimer()
    d = tmp_path / "trace"
    with profile_trace(str(d), "cpu", timer):
        assert timer.recording
        with timer.stage("outer", frame=0):
            with timer.stage("inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert timer.recording is False
    assert [n for n, _, _, _, _ in timer.spans()] == ["inner", "outer"]
    (name,) = os.listdir(d)
    with open(d / name) as f:
        events = json.load(f)["traceEvents"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    outer, inner = notes["acr.outer"], notes["acr.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_profile_trace_unset_leaves_recording_off(monkeypatch):
    no_record_function(monkeypatch)
    timer = SpanTimer()
    with profile_trace(None, "cpu", timer):
        with timer.stage("x"):
            pass
    assert timer.recording is False and timer.spans() == []
