"""HaMeR's FLOPs for a frame's two crops (archs/hamer.py regressor_flops)
over regress_device_ms.webcam and the card's peak in the configuration's
precision, percent."""

from port_bench.harness import manifest


def read(obs):
    ms = manifest.load_reader("regress_device_ms.webcam")(obs)
    if not ms or obs.peaks is None:
        return None
    flops = manifest.load_arch("hamer").regressor_flops()
    return 100.0 * flops / (ms * 1e-3) / obs.peaks[obs.precision]
