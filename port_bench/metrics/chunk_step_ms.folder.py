"""Host ms per chunk of chunk_step and its readback (ACRApp.timer
'device_step')."""

from port_bench.harness.readers import timer_ms


def read(obs):
    return timer_ms(obs, "device_step")
