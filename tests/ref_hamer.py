"""HaMeR (Pavlakos et al., CVPR 2024, arXiv 2312.05251) as plain
functions: the crop of the demo's ``ViTDetDataset``, the ViT-H/16, the
transformer decoder, HaMeR's 6D rotations, right-hand MANO without the
mean pose or root alignment, and ``cam_crop_to_full``.

Plain PyTorch and NumPy, float32 networks with TF32 as the caller sets
it (``judge.fp32_math``), float64 geometry. It imports nothing of
``jax``, ``acr_tpu`` or ``acr_tpu_torch``, nor anything of this package,
so that a copy of it serves the program's tests as it is.

- ``boxes``: per hand the min/max box of its 21 keypoints (pixels), its
  centre, its size times 2.0 widened to the aspect 192:256
  (``expand_to_aspect_ratio``) and the larger side.
- ``crop``: where ``side / 256 / 2`` exceeds 1.1 the image is first
  blurred, a Gaussian of sigma ``(factor - 1) / 2`` along rows then
  columns (scipy's kernel: radius ``int(4 sigma + 0.5)``, nearest
  edges); then cv2's ``warpAffine`` of the box onto the 256 x 256 crop
  (the destination pixel (x, y) reads the source at ``centre + (x - 128,
  y - 128) * side / 256``, bilinear, zero outside), the image flipped
  for a left hand (its centre at ``width - 1 - cx``); the ImageNet
  normalisation, then columns 32:224.
- ``regress``: the ViT (patch 16, padding 2; ``pos[:, 1:] + pos[:, :1]``;
  pre-norm blocks with LayerNorm eps 1e-6, softmax(q k^T / sqrt(80)) v;
  exact GELU; last norm) and the decoder (a zero token through
  ``to_token_embedding`` plus its position; self-attention,
  cross-attention to the tokens and a feed-forward, each pre-norm with
  eps 1e-5; one step of ``decpose``, ``decshape``, ``deccam`` added to
  the mean parameters) -> (N, 109): 6D pose, betas, crop camera.
- ``mano_forward``: rotations (B, 16, 3, 3) and betas -> the mesh and the
  21 joints in MANO's frame.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class Dims(NamedTuple):
    crop: int = 256
    crop_w: int = 192
    patch: int = 16
    width: int = 1280
    depth: int = 32
    heads: int = 16
    mlp: int = 5120
    dec_width: int = 1024
    dec_depth: int = 6
    dec_heads: int = 8
    dec_head_dim: int = 64
    dec_mlp: int = 1024


DIMS = Dims()
FOCAL = 5000.0
MEAN = np.array([0.485, 0.456, 0.406]) * 255
STD = np.array([0.229, 0.224, 0.225]) * 255
PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIPS_RIGHT = (745, 317, 444, 556, 673)
ORDER_21 = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
            10, 11, 12, 19, 7, 8, 9, 20)


def param_shapes(d: Dims = DIMS) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name (HaMeR's checkpoint's) and shape."""
    tokens = (d.crop // d.patch) * (d.crop_w // d.patch)
    inner = d.dec_heads * d.dec_head_dim
    out = [("backbone.patch_embed.proj.weight", (d.width, 3, d.patch, d.patch)),
           ("backbone.patch_embed.proj.bias", (d.width,)),
           ("backbone.pos_embed", (1, tokens + 1, d.width))]
    for i in range(d.depth):
        b = f"backbone.blocks.{i}."
        out += [(b + "norm1.weight", (d.width,)), (b + "norm1.bias", (d.width,)),
                (b + "attn.qkv.weight", (3 * d.width, d.width)),
                (b + "attn.qkv.bias", (3 * d.width,)),
                (b + "attn.proj.weight", (d.width, d.width)),
                (b + "attn.proj.bias", (d.width,)),
                (b + "norm2.weight", (d.width,)), (b + "norm2.bias", (d.width,)),
                (b + "mlp.fc1.weight", (d.mlp, d.width)), (b + "mlp.fc1.bias", (d.mlp,)),
                (b + "mlp.fc2.weight", (d.width, d.mlp)), (b + "mlp.fc2.bias", (d.width,))]
    out += [("backbone.last_norm.weight", (d.width,)),
            ("backbone.last_norm.bias", (d.width,)),
            ("mano_head.transformer.to_token_embedding.weight", (d.dec_width, 1)),
            ("mano_head.transformer.to_token_embedding.bias", (d.dec_width,)),
            ("mano_head.transformer.pos_embedding", (1, 1, d.dec_width))]
    for i in range(d.dec_depth):
        b = f"mano_head.transformer.transformer.layers.{i}."
        for j in range(3):
            out += [(f"{b}{j}.norm.weight", (d.dec_width,)),
                    (f"{b}{j}.norm.bias", (d.dec_width,))]
            if j == 0:
                out.append((f"{b}0.fn.to_qkv.weight", (3 * inner, d.dec_width)))
            elif j == 1:
                out += [(f"{b}1.fn.to_kv.weight", (2 * inner, d.width)),
                        (f"{b}1.fn.to_q.weight", (inner, d.dec_width))]
            if j < 2:
                out += [(f"{b}{j}.fn.to_out.0.weight", (d.dec_width, inner)),
                        (f"{b}{j}.fn.to_out.0.bias", (d.dec_width,))]
            else:
                out += [(f"{b}2.fn.net.0.weight", (d.dec_mlp, d.dec_width)),
                        (f"{b}2.fn.net.0.bias", (d.dec_mlp,)),
                        (f"{b}2.fn.net.3.weight", (d.dec_width, d.dec_mlp)),
                        (f"{b}2.fn.net.3.bias", (d.dec_width,))]
    for name, n in (("decpose", 96), ("decshape", 10), ("deccam", 3)):
        out += [(f"mano_head.{name}.weight", (n, d.dec_width)),
                (f"mano_head.{name}.bias", (n,))]
    out += [("mano_head.init_hand_pose", (1, 96)), ("mano_head.init_betas", (1, 10)),
            ("mano_head.init_cam", (1, 3))]
    return out


def _ln(x, w, name, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w[name + ".weight"] + w[name + ".bias"]


def _linear(x, w, name, bias=True):
    y = x @ w[name + ".weight"].T
    return y + w[name + ".bias"] if bias else y


def _attend(q, k, v, heads):
    """(B, N, H*D), (B, M, H*D), (B, M, H*D) -> (B, N, H*D)."""
    b, n, c = q.shape
    split = lambda t: t.reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c // heads), dim=-1)
    return (a @ v).transpose(1, 2).reshape(b, n, c)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def vit(w, x, d: Dims = DIMS):
    """Normalised crops (N, 3, crop, crop_w) -> tokens (N, T, width)."""
    x = torch.nn.functional.conv2d(x, w["backbone.patch_embed.proj.weight"],
                                   w["backbone.patch_embed.proj.bias"],
                                   stride=d.patch, padding=2)
    x = x.flatten(2).transpose(1, 2)
    pos = w["backbone.pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    for i in range(d.depth):
        b = f"backbone.blocks.{i}."
        h = _ln(x, w, b + "norm1", 1e-6)
        q, k, v = _linear(h, w, b + "attn.qkv").chunk(3, -1)
        x = x + _linear(_attend(q, k, v, d.heads), w, b + "attn.proj")
        h = _ln(x, w, b + "norm2", 1e-6)
        x = x + _linear(_gelu(_linear(h, w, b + "mlp.fc1")), w, b + "mlp.fc2")
    return _ln(x, w, "backbone.last_norm", 1e-6)


def decoder(w, ctx, d: Dims = DIMS):
    """Tokens (N, T, width) -> the query token (N, dec_width)."""
    t = "mano_head.transformer."
    x = torch.zeros((ctx.shape[0], 1, 1), dtype=ctx.dtype, device=ctx.device)
    x = _linear(x, w, t + "to_token_embedding") + w[t + "pos_embedding"]
    for i in range(d.dec_depth):
        b = f"{t}transformer.layers.{i}."
        h = _ln(x, w, b + "0.norm", 1e-5)
        q, k, v = _linear(h, w, b + "0.fn.to_qkv", bias=False).chunk(3, -1)
        x = x + _linear(_attend(q, k, v, d.dec_heads), w, b + "0.fn.to_out.0")
        h = _ln(x, w, b + "1.norm", 1e-5)
        k, v = _linear(ctx, w, b + "1.fn.to_kv", bias=False).chunk(2, -1)
        q = _linear(h, w, b + "1.fn.to_q", bias=False)
        x = x + _linear(_attend(q, k, v, d.dec_heads), w, b + "1.fn.to_out.0")
        h = _ln(x, w, b + "2.norm", 1e-5)
        x = x + _linear(_gelu(_linear(h, w, b + "2.fn.net.0")), w, b + "2.fn.net.3")
    return x[:, 0]


def regress(w, crops, d: Dims = DIMS):
    """Normalised crops -> (N, 109): 6D pose (96), betas (10), camera (3)."""
    t = decoder(w, vit(w, crops, d), d)
    m = "mano_head."
    return torch.cat([_linear(t, w, m + "decpose") + w[m + "init_hand_pose"],
                      _linear(t, w, m + "decshape") + w[m + "init_betas"],
                      _linear(t, w, m + "deccam") + w[m + "init_cam"]], -1)


def rot6d_to_rotmat(x):
    """HaMeR's ``rot6d_to_rotmat``: ``x.view(-1, 2, 3).permute(0, 2, 1)``,
    Gram-Schmidt on the two columns, the third their cross product."""
    a = x.reshape(-1, 2, 3).permute(0, 2, 1)
    a1, a2 = a[:, :, 0], a[:, :, 1]
    b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = u / u.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -1
                       ).reshape(x.shape[:-1] + (3, 3))


def expand_to_aspect_ratio(w, h, target=(192, 256)):
    """HaMeR's: float64 (w, h) widened to the aspect ``target`` (w, h)."""
    w_t, h_t = target
    with np.errstate(divide="ignore", invalid="ignore"):
        if h / w < h_t / w_t:
            return w, max(w * h_t / w_t, h)
    return max(h * w_t / h_t, w), h


def boxes(kp_px: np.ndarray, d: Dims = DIMS) -> np.ndarray:
    """Keypoints (..., 21, 2) in pixels -> (..., 3): centre x, y, side."""
    kp = np.asarray(kp_px, np.float64)
    lo, hi = kp.min(-2), kp.max(-2)
    out = np.zeros(kp.shape[:-2] + (3,))
    for idx in np.ndindex(*kp.shape[:-2]):
        w, h = 2.0 * (hi[idx] - lo[idx])
        out[idx] = [*((lo[idx] + hi[idx]) / 2), max(expand_to_aspect_ratio(
            w, h, (d.crop_w, d.crop)))]
    return out


def _gaussian(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """(H, W, C) float64 through scipy's ``gaussian_filter`` (truncate 4,
    mode nearest) along rows, then columns."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 / sigma ** 2 * x ** 2)
    k = k / k.sum()
    for axis in (0, 1):
        n = image.shape[axis]
        idx = lambda o: torch.as_tensor(np.clip(np.arange(n) + o, 0, n - 1),
                                        device=image.device)
        image = sum(float(k[o + r]) * image.index_select(axis, idx(o))
                    for o in range(-r, r + 1))
    return image


def crop(image: np.ndarray, box, left: bool, d: Dims = DIMS, device="cpu"
         ) -> torch.Tensor:
    """RGB uint8 (S, S, 3) and one hand's box (cx, cy, side) -> the
    normalised crop (3, crop, crop_w), float32."""
    cx, cy, side = (float(v) for v in box)
    img = torch.as_tensor(image, dtype=torch.float64, device=device)
    # the demo's downsampling factor and blur, in float32 as it reaches them
    factor = float(np.float32(side) / np.float32(d.crop) / np.float32(2.0))
    if factor > np.float32(1.1):
        img = _gaussian(img, float(np.float32(factor - 1.0) / np.float32(2.0)))
    s_w = img.shape[1]
    if left:
        img = img.flip(1)
        cx = s_w - cx - 1
    k = side / d.crop
    ys = torch.arange(d.crop, dtype=torch.float64, device=device)
    xs = torch.arange(d.crop, dtype=torch.float64, device=device)
    sy = cy + (ys - d.crop / 2) * k
    sx = cx + (xs - d.crop / 2) * k
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[:, None, None], (sx - x0)[None, :, None]
    y0, x0 = y0.long(), x0.long()

    def px(yy, xx):
        ok = ((yy >= 0) & (yy < img.shape[0]))[:, None] & \
            ((xx >= 0) & (xx < img.shape[1]))[None, :]
        v = img[yy.clamp(0, img.shape[0] - 1)][:, xx.clamp(0, img.shape[1] - 1)]
        return v * ok[..., None]
    patch = ((1 - fy) * (1 - fx) * px(y0, x0) + (1 - fy) * fx * px(y0, x0 + 1)
             + fy * (1 - fx) * px(y0 + 1, x0) + fy * fx * px(y0 + 1, x0 + 1))
    patch = (patch - torch.as_tensor(MEAN, device=device)) / \
        torch.as_tensor(STD, device=device)
    cut = (d.crop - d.crop_w) // 2
    return patch.permute(2, 0, 1)[:, :, cut:cut + d.crop_w].float()


def cam_crop_to_full(cam, box, img_size: int, focal: float):
    """HaMeR's ``cam_crop_to_full``: (s, tx, ty) in the crop -> (tx, ty, tz)."""
    bs = box[..., 2] * cam[..., 0] + 1e-9
    return torch.stack([2 * (box[..., 0] - img_size / 2.0) / bs + cam[..., 1],
                        2 * (box[..., 1] - img_size / 2.0) / bs + cam[..., 2],
                        2 * focal / bs], -1)


def load_mano(mano_dir: str, device) -> Dict[str, torch.Tensor]:
    """The right MANO's arrays (float64) and faces."""
    with np.load(os.path.join(mano_dir, "mano_right.npz")) as z:
        m = {k: torch.as_tensor(np.asarray(z[k], np.float64), device=device)
             for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                       "weights")}
        m["faces"] = np.asarray(z["faces"], np.int64)
    return m


def mano_forward(m, rot, betas):
    """Rotations (B, 16, 3, 3), betas (B, 10) -> verts (B, 778, 3) and
    joints (B, 21, 3) in MANO's frame, float64: no mean pose is added
    (the rotations are given) and nothing is root-aligned."""
    rot, betas = rot.double(), betas.double()
    b = rot.shape[0]
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_shaped = m["v_template"] + torch.einsum("vct,bt->bvc", m["shapedirs"], betas)
    joints = torch.einsum("jv,bvc->bjc", m["J_regressor"], v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", m["posedirs"],
                                      (rot[:, 1:] - eye).reshape(b, 135))
    world = []
    for j, p in enumerate(PARENTS):
        local = torch.zeros((b, 4, 4), dtype=rot.dtype, device=rot.device)
        local[:, :3, :3] = rot[:, j]
        local[:, :3, 3] = joints[:, j] - (joints[:, p] if p >= 0 else 0)
        local[:, 3, 3] = 1
        world.append(local if p < 0 else world[p] @ local)
    g = torch.stack(world, 1)
    skin = g.clone()
    skin[..., :3, 3] -= torch.einsum("bjik,bjk->bji", g[..., :3, :3], joints)
    t = torch.einsum("vj,bjik->bvik", m["weights"], skin)
    verts = torch.einsum("bvik,bvk->bvi", t[..., :3, :3], v_posed) + t[..., :3, 3]
    tips = torch.as_tensor(TIPS_RIGHT, device=rot.device)
    j21 = torch.cat([g[:, :, :3, 3], verts[:, tips]], 1)[:, list(ORDER_21)]
    return verts, j21
