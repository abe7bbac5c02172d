"""HaMeR's ViT attention (the memory-efficient kernel that
scaled_dot_product_attention launches in fp32 at head dim 80; the
decoder's, at head dim 64, is the 64x64 variant and is not read): the
least time of one launch's work (archs/hamer.py attention_work) over the
kernel's mean device time, percent."""

from port_bench.harness import manifest
from port_bench.harness.trace import kernel_mean_s

KERNEL = "fmha_cutlassF_f32_aligned_64x128"


def read(obs):
    if obs.trace is None or obs.peaks is None:
        return None
    t = kernel_mean_s(obs.trace, KERNEL)
    if not t:
        return None
    work = manifest.load_arch("hamer").attention_work()
    bound = max(work["flops"] / obs.peaks["fp32"],
                work["bytes"] / obs.peaks["bytes_s"])
    return 100.0 * bound / t
