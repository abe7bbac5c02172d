"""Device ms per frame of the kernels launched inside the calls into
ACRPipeline (profiler trace)."""

from port_bench.harness.readers import forward_device_ms


def read(obs):
    return forward_device_ms(obs)
