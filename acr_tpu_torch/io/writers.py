"""Host IO: image/video collection, frame splitting, result persistence.

Copies of the functions of ``acr_tpu/io/writers.py`` that the four demo
modes use (reference: acr/utils.py:110-141, 1393-1448); cv2 is imported
inside the functions that need it.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

# the reference's extension list (acr/utils.py:31-32): 19 unique
# extensions after dropping its redundant uppercase duplicates —
# matching here is case-insensitive
IMG_EXTS = (".bmp", ".dib", ".jpg", ".jpeg", ".jpe", ".png", ".webp",
            ".pbm", ".pgm", ".ppm", ".pxm", ".pnm", ".tiff", ".tif",
            ".sr", ".ras", ".exr", ".hdr", ".pic")


def collect_image_list(image_folder: str) -> List[str]:
    """Recursively collect images; numeric-name sort when possible."""
    files = []
    for root, _dirs, names in os.walk(image_folder):
        for n in names:
            if n.lower().endswith(IMG_EXTS):
                files.append(os.path.join(root, n))
    try:
        files = sorted(files,
                       key=lambda x: int(os.path.basename(x).split(".")[0]))
    except ValueError:
        files = sorted(files)
    return files


def split_frame(videopath: str, out_dir: Optional[str] = None) -> str:
    """Decode a video into numbered jpgs (reference: acr/utils.py:1393-1430)."""
    import cv2
    if not os.path.exists(videopath):
        raise FileNotFoundError(videopath)
    path = out_dir or os.path.splitext(videopath)[0]
    os.makedirs(path, exist_ok=True)
    vc = cv2.VideoCapture(videopath)
    idx = 0
    while True:
        ok, frame = vc.read()
        if not ok:
            break
        cv2.imwrite(os.path.join(path, f"{idx:06d}.jpg"), frame)
        idx += 1
    vc.release()
    return path


_AUX_SUFFIXES = ("_centermap", "_pj2d", "_j3d", "_org_img")


def _frame_sort_key(name: str):
    """ints-first stable sort that never mixes int/str comparisons."""
    stem = name.split(".")[0]
    return (0, int(stem), "") if stem.isdigit() else (1, 0, name)


def save_video(frames_dir: str, out_name: str, fps: int = 30) -> str:
    """Re-encode a directory of frames to mp4 (reference: utils.py:1432-1448).

    Auxiliary view frames (*_centermap etc.) and non-images are excluded.
    """
    import cv2
    names = [n for n in os.listdir(frames_dir)
             if n.lower().endswith(IMG_EXTS)
             and not any(n.split(".")[0].endswith(s) for s in _AUX_SUFFIXES)]
    names = sorted(names, key=_frame_sort_key)
    if not names:
        raise ValueError(f"no frames in {frames_dir}")
    first = cv2.imread(os.path.join(frames_dir, names[0]))
    h, w = first.shape[:2]
    out_path = out_name if out_name.endswith(".mp4") else out_name + ".mp4"
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    for n in names:
        img = cv2.imread(os.path.join(frames_dir, n))
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        writer.write(img)
    writer.release()
    return out_path


def save_results(tag: str, output_dir: str, results_dict: Dict) -> str:
    """Persist results as pickle (reference: acr/utils.py:124-129)."""
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir,
                       os.path.basename(tag.rstrip("/")) + "_results.pkl")
    with open(out, "wb") as f:
        pickle.dump(results_dict, f)
    return out
