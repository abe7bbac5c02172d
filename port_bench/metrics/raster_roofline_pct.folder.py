"""B1 (raster_binned_kernel): the least time of its work on the reference's
geometry over its mean device time, percent."""

from port_bench.harness.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "raster_binned", "raster_bound_s")
