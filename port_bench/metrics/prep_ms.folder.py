"""Decode and preprocess ms per frame on the producer thread (ACRApp.timer
'preprocess', per chunk, over its frames)."""

from port_bench.harness.readers import timer_ms


def read(obs):
    return timer_ms(obs, "preprocess", per=obs.batch)
