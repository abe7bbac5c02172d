"""Host ms per frame of the composite (ACRApp.timer 'render')."""

from port_bench.harness.readers import timer_ms


def read(obs):
    return timer_ms(obs, "render")
