"""The traffic generators repeat for a seed; the paced camera's rules."""

import time

import numpy as np

from port_bench.harness import frames as F


def test_frames_repeat_for_a_seed_and_differ_across_seeds():
    big = 2 ** 31 + 12345                   # seeds beyond 32 signed bits
    a = F.smooth_frames(big, 10, 48, 64)
    b = F.smooth_frames(big, 10, 48, 64)
    c = F.smooth_frames(big + 1, 10, 48, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (48, 64, 3) and a[0].dtype == np.uint8
    # smooth content: neighbouring pixels differ far less than uniform
    # noise would (about 85 levels)
    assert np.abs(np.diff(a[0].astype(int), axis=1)).mean() < 20
    d = F.smooth_frames([big, 1], 4, 48, 64)
    e = F.smooth_frames([big, 1], 4, 48, 64)
    assert np.array_equal(d[3], e[3])


def test_clip_files_repeat(tmp_path):
    frames = F.smooth_frames(7, 3, 32, 48)
    n1 = F.write_clip(frames, str(tmp_path / "a"), 90)
    n2 = F.write_clip(frames, str(tmp_path / "b"), 90)
    assert n1 == n2 > 0
    assert (tmp_path / "a" / "000002.jpg").read_bytes() == \
        (tmp_path / "b" / "000002.jpg").read_bytes()


def test_paced_camera_never_repeats_and_drops_late_frames():
    pool = [np.full((2, 2, 3), i, np.uint8) for i in range(4)]
    t0 = time.perf_counter()
    cam = F.PacedCamera(pool, fps=200.0, t0=t0, deadline=t0 + 0.25)
    seen = []
    while True:
        f = cam.read()
        if f is None:
            break
        seen.append(cam.reads[-1].index)
        if len(seen) % 5 == 0:
            time.sleep(0.02)                # a slow loop turn: frames drop
    assert seen == sorted(set(seen))        # never the same frame twice
    assert max(np.diff(seen)) > 1           # the late turns skipped frames
    assert all(c.captured < t0 + 0.25 for c in cam.reads)
    assert len(cam.pending) == len(seen)
    # a reader faster than the camera waits for the next capture
    assert cam.reads[1].captured - cam.reads[0].captured >= 1 / 200.0 - 1e-9
