"""Median host ms of Visualizer.compose_on_frame on the stream (harness
span)."""

from port_bench.harness.readers import median


def read(obs):
    return median(obs.spans.get("composite", []))
