"""Median capture-to-delivery ms over every frame delivered in the window."""

from port_bench.harness.readers import percentile


def read(obs):
    return percentile(obs.latencies_ms, 50)
