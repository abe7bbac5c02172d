"""Host IO: image/video collection, frame splitting, result persistence.

Copies of the functions of ``acr_tpu/io/writers.py``: those the four
demo modes use (reference: acr/utils.py:110-141, 1393-1448) and the
library's exports (npz, JSON, YAML, OBJ, HDF5). cv2, yaml and h5py are
imported inside the functions that need them; ``save_h5`` returns None
where h5py is missing, as JAX's does.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

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


def save_npz_results(path: str, results_dict: Dict) -> str:
    # object arrays are pickled by default; np.savez has no allow_pickle
    # kwarg (passing one would be saved as a spurious array entry)
    np.savez(path, results=np.asarray([results_dict], dtype=object))
    return path


def save_json(path: str, obj) -> str:
    import json

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(obj, f, default=default)
    return path


def save_yaml(path: str, obj) -> str:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)
    return path


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    """Export a mesh as Wavefront OBJ (1-indexed faces).

    verts (V, 3), faces (F, 3) — e.g. a MANO hand (778/1538).
    """
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64) + 1
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
    return path


def load_obj(path: str):
    """Read an OBJ written by save_obj -> (verts (V,3), faces (F,3) 0-idx)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def save_h5(path: str, arrays: Dict[str, np.ndarray]) -> Optional[str]:
    """HDF5 result export; returns None when h5py is unavailable."""
    try:
        import h5py
    except ImportError:
        return None
    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=np.asarray(value))
    return path
