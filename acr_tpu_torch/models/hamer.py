"""HaMeR: a ViT-H/16 over a hand crop and a transformer decoder that
regresses right-hand MANO (Pavlakos et al., "Reconstructing Hands in 3D
with Transformers", CVPR 2024, arXiv 2312.05251).

* Backbone (ViTPose's ViT-H/16): the 256 x 192 crop through a 16 x 16
  patch convolution (stride 16, padding 2) into 16 x 12 = 192 tokens of
  width 1280, plus ``pos[:, 1:] + pos[:, :1]`` of a (1, 193, 1280)
  position table (there is no class token); 32 pre-norm blocks
  ``x += Attn(LN(x)); x += MLP(LN(x))`` (LayerNorm eps 1e-6, qkv 1280 ->
  3840 with bias, 16 heads of 80, MLP 1280 -> 5120 -> 1280 with exact
  GELU); a last LayerNorm. The tokens are the decoder's context.
* Head: one token, ``Linear(1, 1024)`` of a zero input plus a learned
  position, through 6 blocks ``x += SelfAttn(LN(x)); x += CrossAttn(LN(x),
  ctx); x += FF(LN(x))`` (LayerNorm eps 1e-5, 8 heads of 64, q/kv/qkv
  without bias, ``to_out`` 512 -> 1024, kv from the 1280-wide context,
  FF 1024 -> 1024 -> 1024 with GELU); then one IEF step: ``pose6d =
  decpose(t) + init_pose`` (96), ``betas = decshape(t) + init_betas``
  (10), ``cam = deccam(t) + init_cam`` (3, weak perspective in the crop).

The widths are HaMeR's, in ``DIMS``; the modules' names are those of
HaMeR's checkpoint (``backbone.*``, ``mano_head.*``). Every attention is
``F.scaled_dot_product_attention``. The ViT is also ViTPose-H's backbone
(``models/vitpose.py``), and its ``Block`` ViTDet-H's (``models/vitdet.py``)
with a window (``window_attention``) and decomposed relative positions
(``rel_pos_bias``, an additive bias); HaMeR's blocks have neither.

HaMeR's 6D layout differs from ACR's (``ops.rotations.rot6d_to_rotmat``):
the six numbers are two rows of three, ``x.view(-1, 2, 3).transpose(1,
2)``, whose columns seed the Gram-Schmidt basis (``rot6d_to_rotmat``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


class Dims(NamedTuple):
    """HaMeR's widths (defaults: the published model)."""
    crop: int = 256          # the square crop's side (IMAGE_SIZE)
    crop_w: int = 192        # the middle columns the ViT reads (BBOX_SHAPE 192:256)
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
N_POSE = 96              # 16 rotations in 6D
N_BETAS = 10
N_CAM = 3
N_PARAMS = N_POSE + N_BETAS + N_CAM


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HaMeR's 6D [..., 6] -> rotation [..., 3, 3]: the first three and
    the next three numbers are the two columns that Gram-Schmidt turns
    into the basis (b1, b2, b1 x b2), ``F.normalize``'s eps 1e-12."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = F.normalize(a1, dim=-1)
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


class PatchEmbed(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.proj = nn.Conv2d(3, d.width, kernel_size=d.patch, stride=d.patch,
                              padding=2)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


def rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                 side: int) -> torch.Tensor:
    """ViTDet's decomposed relative positions (detectron2
    ``add_decomposed_rel_pos``) as an additive attention bias: q (B, H, N,
    C) over a square grid of ``side`` (N = side^2), tables (2 side - 1,
    C) -> (B, H, N, N), ``bias[(i, j), (k, l)] = q[(i, j)] . rel_h[i - k +
    side - 1] + q[(i, j)] . rel_w[j - l + side - 1]``, from the unscaled q."""
    b, h, n, c = q.shape
    idx = torch.arange(side, device=q.device)
    idx = idx[:, None] - idx[None, :] + (side - 1)
    r_q = q.reshape(b, h, side, side, c)
    along_h = torch.einsum("bhyxc,ykc->bhyxk", r_q, rel_h[idx])
    along_w = torch.einsum("bhyxc,xkc->bhyxk", r_q, rel_w[idx])
    return (along_h[..., :, None] + along_w[..., None, :]).reshape(b, h, n, n)


class ViTAttention(nn.Module):
    """Multi-head self-attention; with ``rel_pos`` (the side of a square
    grid) ViTDet's decomposed relative-position tables ``rel_pos_h`` and
    ``rel_pos_w`` (2 rel_pos - 1, head width) add their bias."""

    def __init__(self, d: Dims, rel_pos: int = 0):
        super().__init__()
        self.heads = d.heads
        self.qkv = nn.Linear(d.width, 3 * d.width)
        self.proj = nn.Linear(d.width, d.width)
        self.rel_pos = rel_pos
        if rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_pos - 1,
                                                      d.width // d.heads))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_pos - 1,
                                                      d.width // d.heads))

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads
                                      ).permute(2, 0, 3, 1, 4)
        if self.rel_pos:
            bias = rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, self.rel_pos)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        else:
            out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


def window_attention(attn: nn.Module, x: torch.Tensor, hw, window: int
                     ) -> torch.Tensor:
    """``attn`` within ``window`` x ``window`` windows of the (H, W) grid of
    tokens x (B, H * W, C): the grid zero-padded at the bottom and right
    to whole windows, the padded tokens attended as keys, the result
    merged and cropped (detectron2 ``window_partition`` and
    ``window_unpartition``)."""
    b, n, c = x.shape
    h, w = hw
    ph, pw = (-h) % window, (-w) % window
    x = F.pad(x.view(b, h, w, c), (0, 0, 0, pw, 0, ph))
    gh, gw = (h + ph) // window, (w + pw) // window
    x = x.view(b, gh, window, gw, window, c).permute(0, 1, 3, 2, 4, 5)
    x = attn(x.reshape(b * gh * gw, window * window, c))
    x = x.view(b, gh, gw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h + ph, w + pw, c)[:, :h, :w].reshape(b, n, c)


class Mlp(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.fc1 = nn.Linear(d.width, d.mlp)
        self.fc2 = nn.Linear(d.mlp, d.width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """``x += attn(LN(x)); x += MLP(LN(x))``; with ``window`` the attention
    runs within windows of the token grid ``hw`` (``window_attention``),
    and with ``rel_pos`` it carries relative positions (``ViTAttention``):
    ViTDet's blocks. HaMeR's and ViTPose's have neither."""

    def __init__(self, d: Dims, window: int = 0, rel_pos: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(d.width, eps=1e-6)
        self.attn = ViTAttention(d, rel_pos)
        self.norm2 = nn.LayerNorm(d.width, eps=1e-6)
        self.mlp = Mlp(d)
        self.window = window

    def forward(self, x, hw=None):
        if self.window:
            x = x + window_attention(self.attn, self.norm1(x), hw, self.window)
        else:
            x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        tokens = (d.crop // d.patch) * (d.crop_w // d.patch)
        self.patch_embed = PatchEmbed(d)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, d.width))
        self.blocks = nn.ModuleList([Block(d) for _ in range(d.depth)])
        self.last_norm = nn.LayerNorm(d.width, eps=1e-6)

    def forward(self, x):
        """Normalised crops (N, 3, crop, crop_w) -> tokens (N, T, width)."""
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H * D) -> (B, H, N, D)."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H * D)."""
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


class SelfAttention(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        inner = d.dec_heads * d.dec_head_dim
        self.heads = d.dec_heads
        self.to_qkv = nn.Linear(d.dec_width, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, d.dec_width), nn.Identity())

    def forward(self, x):
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, -1))
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class CrossAttention(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        inner = d.dec_heads * d.dec_head_dim
        self.heads = d.dec_heads
        self.to_kv = nn.Linear(d.width, 2 * inner, bias=False)
        self.to_q = nn.Linear(d.dec_width, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, d.dec_width), nn.Identity())

    def forward(self, x, context):
        k, v = (_heads(t, self.heads) for t in self.to_kv(context).chunk(2, -1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class FeedForward(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(d.dec_width, d.dec_mlp), nn.GELU(),
                                 nn.Identity(), nn.Linear(d.dec_mlp, d.dec_width),
                                 nn.Identity())

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class CrossTransformer(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(d.dec_width, SelfAttention(d)),
            PreNorm(d.dec_width, CrossAttention(d)),
            PreNorm(d.dec_width, FeedForward(d))]) for _ in range(d.dec_depth)])

    def forward(self, x, context):
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, d.dec_width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, d.dec_width))
        self.transformer = CrossTransformer(d)

    def forward(self, context):
        token = context.new_zeros((context.shape[0], 1, 1))
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context)


class ManoHead(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.transformer = TransformerDecoder(d)
        self.decpose = nn.Linear(d.dec_width, N_POSE)
        self.decshape = nn.Linear(d.dec_width, N_BETAS)
        self.deccam = nn.Linear(d.dec_width, N_CAM)
        self.register_buffer("init_hand_pose", torch.zeros(1, N_POSE))
        self.register_buffer("init_betas", torch.zeros(1, N_BETAS))
        self.register_buffer("init_cam", torch.zeros(1, N_CAM))

    def forward(self, context):
        t = self.transformer(context)[:, 0]
        return torch.cat([self.decpose(t) + self.init_hand_pose,
                          self.decshape(t) + self.init_betas,
                          self.deccam(t) + self.init_cam], dim=-1)


class HaMeR(nn.Module):
    """Normalised crops (N, 3, crop, crop_w) -> (N, 109): the 6D pose
    (96), betas (10) and the crop's weak-perspective camera (3)."""

    def __init__(self, dims: Dims = None):
        super().__init__()
        self.dims = DIMS if dims is None else dims
        self.backbone = ViT(self.dims)
        self.mano_head = ManoHead(self.dims)

    def forward(self, crops):
        return self.mano_head(self.backbone(crops))


# stand-in mean parameters where no trained weights are given: identity
# rotations, zero betas and a camera that fills the crop with the hand
STAND_IN_CAM = (4.0, 0.0, 0.0)


def init_params(generator: torch.Generator, dims: Dims = None,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded random weights with HaMeR's initialisers (the ViT's and the
    decoder's linear weights truncated normal of std 0.02 at 2 std, the
    patch convolution's of std 1 / sqrt(fan-in), biases 0, LayerNorms 1
    and 0, position tables normal(0.02)), the output layers scaled by
    0.01, and the stand-in mean parameters."""
    with torch.device("meta"):
        net = HaMeR(dims)
    norms = {f"{name}.weight" for name, m in net.named_modules()
             if isinstance(m, nn.LayerNorm)}
    out: Dict[str, torch.Tensor] = {}
    for key, ref in net.state_dict().items():
        t = torch.zeros(ref.shape, dtype=torch.float32, device=device)
        if key.endswith("init_hand_pose"):
            t[:] = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=device).repeat(16)
        elif key.endswith("init_cam"):
            t[:] = torch.tensor(STAND_IN_CAM, device=device)
        elif key in norms:
            t.fill_(1.0)
        elif key.endswith((".weight", "pos_embed", "pos_embedding")):
            std = 0.02
            if t.dim() == 4:                      # the patch convolution
                std = 1.0 / math.sqrt(math.prod(t.shape[1:]))
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if key.startswith("mano_head.dec"):
                t *= 0.01
        out[key] = t
    return out
