"""DINOv2 Vision Transformer trunk, the port of
``patchrefinerv2_tpu/models/backbones/vit.py`` (``VIT_CONFIGS`` :26,
``INTERMEDIATE_LAYER_IDX`` :37, ``Attention`` :46, ``LayerScale`` :62,
``Mlp`` :74, ``Block`` :85, ``DinoViT`` :105).

Patch-14 embedding, cls token, the position embedding interpolated with
bicubic K2 and the DINO ``interpolate_offset`` scale-factor quirk
(dinov2.py:182-210), pre-LN blocks (K6) with LayerScale, exact attention
without a bias (K4, ``ops/attention``), the GELU MLP, and the taps with the
shared final norm (``get_intermediate_layers(..., norm=True)``). Key names
follow the DINOv2 state dict (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.{norm1, attn.{qkv, proj}, ls1.gamma, norm2,
mlp.{fc1, fc2}, ls2.gamma}``, ``norm``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.models.blocks.convs import ChannelLayerNorm, gelu, to_nhwc
from patchrefinerv2_torch.ops.attention import attention
from patchrefinerv2_torch.ops.resize import resize

VIT_CONFIGS = {
    # embed_dim, depth, num_heads (dinov2.py:340-395)
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24),
    # debug-tiny trunk for tests (not a reference size)
    "vitt": dict(embed_dim=96, depth=4, num_heads=2),
}

# DPT tap indices per trunk size (depth_anything_v2/dpt.py:163-168)
INTERMEDIATE_LAYER_IDX = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
    "vitt": [0, 1, 2, 3],
}


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.num_heads
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v, hd ** -0.5)
        return self.proj(o.transpose(1, 2).reshape(b, s, d))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = ChannelLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoViT(nn.Module):
    """``forward(x NCHW, taps=None)`` returns the (patch tokens (B, N, D),
    cls token (B, D)) pairs at the tap blocks, after the final norm."""

    def __init__(self, variant: str = "vits", patch_size: int = 14, pos_grid: int = 37,
                 interpolate_offset: float = 0.1):
        super().__init__()
        cfg = VIT_CONFIGS[variant]
        dim = cfg["embed_dim"]
        self.variant, self.patch_size, self.pos_grid = variant, patch_size, pos_grid
        self.interpolate_offset = interpolate_offset
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, cfg["num_heads"]) for _ in range(cfg["depth"]))
        self.norm = ChannelLayerNorm(dim)

    def interpolated_pos_embed(self, h0: int, w0: int) -> torch.Tensor:
        """(1, 1 + h0 * w0, D): the cls position and the patch grid resized
        bicubically with scale factors (g + 0.1) / pos_grid."""
        if (h0, w0) == (self.pos_grid, self.pos_grid):
            return self.pos_embed
        g, dim = self.pos_grid, self.pos_embed.shape[-1]
        grid = self.pos_embed[:, 1:].reshape(1, g, g, dim)
        scale = ((h0 + self.interpolate_offset) / g, (w0 + self.interpolate_offset) / g)
        grid = resize(grid, (h0, w0), "bicubic", False, scale_override=scale)
        return torch.cat([self.pos_embed[:, :1], grid.reshape(1, h0 * w0, dim)], dim=1)

    def forward(self, x, taps=None):
        taps = list(taps) if taps is not None else INTERMEDIATE_LAYER_IDX[self.variant]
        b, _, h, w = x.shape
        h0, w0 = h // self.patch_size, w // self.patch_size
        tok = to_nhwc(self.patch_embed.proj(x)).reshape(b, h0 * w0, -1)
        tok = torch.cat([self.cls_token.expand(b, -1, -1), tok], dim=1)
        tok = tok + self.interpolated_pos_embed(h0, w0)
        outputs = {}
        for i, blk in enumerate(self.blocks):
            tok = blk(tok)
            if i in taps:
                outputs[i] = tok
        result = []
        for i in taps:
            normed = self.norm(outputs[i])
            result.append((normed[:, 1:], normed[:, 0]))
        return result
