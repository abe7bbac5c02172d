"""The work counts of the yardstick, pinned."""

import torch

from port_bench.harness import manifest, work


def test_network_flops_per_frame_at_512():
    # FlopCounterMode over the frozen reference, 512 px, one frame
    acr = manifest.load_arch("acr")
    assert acr.flops_per_frame({"input_size": 512}) == 102119284736


def test_b1_bytes_once_and_edge_pairs():
    # 2 x 1538 faces padded to 3200, a 512 px frame: the face table read
    # once, fid + 2 barycentrics + 16 attribute planes written once
    faces = torch.tensor([[[10.2, 10.2], [13.7, 10.2], [10.2, 12.9]]])
    n_bytes, n_ops = work.raster_work(faces, 3200, 512)
    assert n_bytes == 4 * 26 * 3200 + 19 * 4 * 512 * 512 == 20255744
    # pixel centres 10.5 .. 13.5 across, 10.5 .. 12.5 down: 4 x 3
    assert n_ops == 23 * 12
    # a face off the image costs nothing
    off = torch.tensor([[[-9.0, -9.0], [-5.0, -9.0], [-9.0, -4.0]]])
    assert work.raster_work(off, 3200, 512)[1] == 0


def test_b4_work_at_eight_hands():
    n_bytes, n_ops = work.mano_work(8)
    assert n_bytes == 4 * (8 * 146 + 8 * 192 + 146 * 3 * 778 + 16 * 778
                           + 8 * 778 * 3) == 1498352
    assert n_ops == 8 * 778 * (2 * (146 * 3 + 12 * 16) + 18) == 7954272


def test_bound_takes_the_larger_time():
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    assert work.bound_s(3.35e12, 0, peaks) == 1.0
    assert work.bound_s(0, 66.9e12, peaks) == 1.0
