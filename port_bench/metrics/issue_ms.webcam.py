"""Median host ms of ACRApp.stream_step, the frame's device work issued
(harness span)."""

from port_bench.harness.readers import median


def read(obs):
    return median(obs.spans.get("issue", []))
