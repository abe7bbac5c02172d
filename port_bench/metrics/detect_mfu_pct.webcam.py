"""The detector chain's FLOPs per frame at the published widths
(archs/hamer_vitdet.py detector_flops) over forward_device_ms.webcam
(on this cell, the device time of ViTDet-H, ViTPose-H and the hand
keypoints, pipeline/vitdet.py) and the card's peak in the
configuration's precision, percent."""

from port_bench.harness import manifest


def read(obs):
    ms = manifest.load_reader("forward_device_ms.webcam")(obs)
    if not ms or obs.peaks is None:
        return None
    flops = manifest.load_arch("hamer_vitdet").detector_flops()
    return 100.0 * flops / (ms * 1e-3) / obs.peaks[obs.precision]
