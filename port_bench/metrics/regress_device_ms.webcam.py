"""Device ms per frame of the kernels launched inside ACRApp.stream_step and
outside the calls into ACRPipeline (profiler trace): with HaMeR, its regress
stage and OneEuro with HaMeR's tail."""


def read(obs):
    if obs.trace is None:
        return None
    a = obs.trace["annotations"].get("port_bench.issue")
    if not a or not a["count"] or not a["device_s"]:
        return None
    return 1e3 * a["device_s"] / a["count"]
