"""A frame's fp32 attention launches (the memory-efficient kernel that
scaled_dot_product_attention launches at head width 80: ViTDet-H's
windowed and global blocks with their relative-position bias, ViTPose-H's
and HaMeR's ViT): their least time (archs/hamer_vitdet.py attention_work)
over their device time per frame, percent. The frames are the traced
calls into the app's pipeline."""

from port_bench.harness import manifest

KERNEL = "fmha_cutlassF_f32_aligned_64x128"


def read(obs):
    if obs.trace is None or obs.peaks is None:
        return None
    a = obs.trace["annotations"].get("port_bench.forward")
    seconds = sum(v["seconds"] for k, v in obs.trace["kernels"].items() if KERNEL in k)
    if not a or not a["count"] or not seconds:
        return None
    arch = manifest.load_arch("hamer_vitdet")
    return 100.0 * arch.bound_s(arch.attention_work(), obs.peaks) / (seconds / a["count"])
