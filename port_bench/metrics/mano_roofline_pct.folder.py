"""B4 (mano_split_kernel) at the chunk's hands per side: the least time of
its work over its mean device time, percent."""

from port_bench.harness.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "mano_split", "mano_bound_s")
