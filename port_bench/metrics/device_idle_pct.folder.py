"""Share of the traced sub-window in which no kernel, copy or set ran on
the device, percent."""

from port_bench.harness.readers import idle_pct


def read(obs):
    return idle_pct(obs)
