"""Kernel B6, the detector's ROIAlignV2 (csrc/detect.cu
acr_roi_align_kernel): a frame's launches' least time
(archs/hamer_vitdet.py roi_align_work) over their device time per frame,
percent. The frames are the traced calls into the app's pipeline."""

from port_bench.harness import manifest

KERNEL = "acr_roi_align_kernel"


def read(obs):
    if obs.trace is None or obs.peaks is None:
        return None
    a = obs.trace["annotations"].get("port_bench.forward")
    seconds = sum(v["seconds"] for k, v in obs.trace["kernels"].items() if KERNEL in k)
    if not a or not a["count"] or not seconds:
        return None
    arch = manifest.load_arch("hamer_vitdet")
    return 100.0 * arch.bound_s(arch.roi_align_work(), obs.peaks) / (seconds / a["count"])
