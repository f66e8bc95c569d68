"""BEiT-L/16 trunk + MiDaS DPT decoder ("DPT_BEiT_L_384"), the port of
``patchrefinerv2_tpu/models/backbones/beit.py`` (``relative_position_bias``
:46, ``BeitAttention`` :104, ``BeitBlock`` :156, ``BeitLarge`` :178,
``MidasDPTBEiT`` :210).

Key names follow the torch.hub MiDaS layout: the timm trunk under
``pretrained.model`` (``patch_embed.proj``, ``cls_token``,
``blocks.{i}.{norm1, attn.{qkv, q_bias, v_bias,
relative_position_bias_table, proj}, norm2, mlp.{fc1, fc2}, gamma_1,
gamma_2}``), the readouts under ``pretrained.act_postprocess{1..4}``
(``0.project.0`` readout linear, ``3`` 1x1 project, ``4`` resize) and the
decoder under ``scratch``.

K3 (attention with the relative-position bias) is plain PyTorch in this
port for now: ``torch.matmul`` with float32 logits and softmax, the bias
gathered from the table through the timm relative-position index.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.blocks.convs import (
    ChannelLayerNorm, gelu, interp, to_nchw,
)
from patchrefinerv2_torch.models.blocks.dpt import FeatureFusionBlock


def relative_position_index(h: int, w: int) -> np.ndarray:
    """timm BEiT relative_position_index for an h*w window plus the cls token."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    num_rel = (2 * h - 1) * (2 * w - 1)
    idx = np.zeros((h * w + 1, h * w + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


class BeitAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        gh, gw = grid
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * gh - 1) * (2 * gw - 1) + 3, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(gh, gw)), persistent=False)

    def relative_position_bias(self) -> torch.Tensor:
        s = self.relative_position_index.shape[0]
        rel = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        return rel.view(s, s, -1).permute(2, 0, 1)  # (heads, S, S)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias).reshape(b, s, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.matmul((q * hd ** -0.5).float(), k.float().transpose(-2, -1))
        att = torch.softmax(att + self.relative_position_bias().float()[None], dim=-1)
        o = torch.matmul(att.to(v.dtype), v)
        return self.proj(o.transpose(1, 2).reshape(b, s, d))


class BeitBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid, mlp_ratio: float = 4.0,
                 init_values: float = 1e-5):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = BeitAttention(dim, num_heads, grid)
        self.norm2 = ChannelLayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp.fc2(gelu(self.mlp.fc1(self.norm2(x))))


class Readout(nn.Module):
    """readout 'project': cat the cls token to every patch token, linear + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tok):
        patches = tok[:, 1:]
        h = torch.cat([patches, tok[:, :1].expand_as(patches)], dim=-1)
        return gelu(self.project[0](h))


class MidasDPTBEiT(nn.Module):
    """DPT_BEiT_L_384 graph. Input NCHW in [0, 1] of ``img_size``; returns
    (rel_depth (B, 1, H, W), [out_conv32, l4_rn, r4, r3, r2, r1])."""

    def __init__(self, img_size=(384, 512), features: int = 256,
                 out_channels=(256, 512, 1024, 1024), embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, taps=(5, 11, 17, 23), patch_size: int = 16):
        super().__init__()
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.taps = tuple(taps)
        model = nn.Module()
        model.patch_embed = nn.Module()
        model.patch_embed.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        model.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        model.blocks = nn.ModuleList(BeitBlock(embed_dim, num_heads, self.grid) for _ in range(depth))
        self.pretrained = nn.Module()
        self.pretrained.model = model
        oc = out_channels
        resizes = [nn.ConvTranspose2d(oc[0], oc[0], 4, 4), nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
                   nn.Identity(), nn.Conv2d(oc[3], oc[3], 3, 2, 1)]
        for i in range(4):
            setattr(self.pretrained, f"act_postprocess{i + 1}", nn.Sequential(
                Readout(embed_dim), nn.Identity(), nn.Identity(),
                nn.Conv2d(embed_dim, oc[i], 1), resizes[i]))
        s = nn.Module()
        for i, c in enumerate(oc):
            setattr(s, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, 1, 1, bias=False))
        for k in range(1, 5):
            setattr(s, f"refinenet{k}", FeatureFusionBlock(features, skip=(k != 4)))
        s.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, 1, 1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())
        self.scratch = s

    def forward(self, x):
        x = (x - 0.5) / 0.5
        m = self.pretrained.model
        b = x.shape[0]
        gh, gw = self.grid
        tok = m.patch_embed.proj(x).flatten(2).transpose(1, 2)
        tok = torch.cat([m.cls_token.expand(b, -1, -1).to(tok.dtype), tok], dim=1).contiguous()
        taps = []
        for i, blk in enumerate(m.blocks):
            tok = blk(tok)
            if i in self.taps:
                taps.append(tok)
        levels = []
        for i, t in enumerate(taps):
            ap = getattr(self.pretrained, f"act_postprocess{i + 1}")
            h = to_nchw(ap[0](t).reshape(b, gh, gw, -1))
            levels.append(ap[4](ap[3](h)))
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(lv) for i, lv in enumerate(levels))
        r4 = s.refinenet4(l4, size=l3.shape[2:])
        r3 = s.refinenet3(r4, l3, size=l2.shape[2:])
        r2 = s.refinenet2(r3, l2, size=l1.shape[2:])
        r1 = s.refinenet1(r2, l1)
        h = s.output_conv[0](r1)
        h = interp(h, (h.shape[2] * 2, h.shape[3] * 2))
        out_conv = F.relu(s.output_conv[2](h))
        rel = F.relu(s.output_conv[4](out_conv))
        return rel, [out_conv, l4, r4, r3, r2, r1]
