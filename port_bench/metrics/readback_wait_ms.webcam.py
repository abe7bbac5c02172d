"""Median host ms of ACRApp.unpack_stream: the wait for the device and the
one readback (harness span)."""

from port_bench.harness.readers import median


def read(obs):
    return median(obs.spans.get("readback", []))
