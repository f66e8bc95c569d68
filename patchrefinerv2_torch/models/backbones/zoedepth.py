"""ZoeDepth metric-bins head over the MiDaS BEiT core, the port of
``patchrefinerv2_tpu/models/backbones/zoedepth.py`` (attractors :39-170,
``log_binom``/``ConditionalLogBinomial`` :173-218, ``ZoeDepthHead`` :288)
and of ``ZoeDepthBEiT`` (``models/patchrefinerplus.py:64``).

Names follow zoedepth_v1.py: ``conv2``, ``seed_bin_regressor._net``,
``seed_projector._net``, ``projectors.{i}._net``, ``attractors.{i}._net``,
``conditional_log_binomial.mlp``, with the core under ``core.core``.

K8 (the bins-head per-pixel math: the attractor shifts and the
log-binomial depth) runs through ``ops/bins``, which also resizes the bin
centres that the reference resizes before that math (``_interp`` at
zoedepth.py:124, :159 and :375-376), and keeps the reference quirk: the
attractor layers compute with alpha 300 and gamma 2 whatever the config
says (the reference never forwards them).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from patchrefinerv2_torch.models.backbones.beit import MidasDPTBEiT
from patchrefinerv2_torch.models.blocks.convs import interp, to_nchw, to_nhwc
from patchrefinerv2_torch.ops.bins import attractor_update, log_binomial_depth


def _mlp(cin: int, hidden: int, out: int, final: nn.Module | None) -> nn.Sequential:
    layers = [nn.Conv2d(cin, hidden, 1), nn.ReLU(), nn.Conv2d(hidden, out, 1)]
    return nn.Sequential(*layers, *([final] if final is not None else []))


class _Net(nn.Module):
    """Holds an ``_net`` Sequential (the reference's attribute name)."""

    def __init__(self, net: nn.Sequential):
        super().__init__()
        self._net = net

    def forward(self, x):
        return self._net(x)


class AttractorLayer(nn.Module):
    """Unnormed (softplus attractor points) or normed (linear, bounded
    centers) attractor layer (attractor.py:60-208)."""

    def __init__(self, in_features: int, n_attractors: int, normed: bool, min_depth: float,
                 max_depth: float, kind: str = "mean", attractor_type: str = "inv",
                 mlp_dim: int = 128):
        super().__init__()
        self.normed, self.kind, self.attractor_type = normed, kind, attractor_type
        self.n_attractors = n_attractors
        self.min_depth, self.max_depth = min_depth, max_depth
        out = n_attractors * 2 if normed else n_attractors
        self._net = _mlp(in_features, mlp_dim, out, nn.ReLU() if normed else nn.Softplus())

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + interp(prev_b_embedding, x.shape[2:])
        net = self._net
        a = net[3](net[2](F.relu(net[0](x))))
        if self.normed:
            b, _, h, w = a.shape
            a = (a + 1e-3).reshape(b, self.n_attractors, 2, h, w)[:, :, 0]
        # b_prev is resized to x's size inside attractor_update
        b_new, centers = attractor_update(to_nhwc(a), to_nhwc(b_prev), self.kind,
                                          self.attractor_type, self.normed, self.min_depth,
                                          self.max_depth)
        return to_nchw(b_new), to_nchw(centers)


class ConditionalLogBinomial(nn.Module):
    """The log-binomial MLP (dist_layers.py:78-155) and the depth it gives:
    forward returns the expectation of the bin centres, which it takes at
    any size and resizes to x's (bilinear, align_corners)."""

    def __init__(self, in_features: int, n_classes: int, bottleneck: int, min_temp: float,
                 max_temp: float):
        super().__init__()
        self.n_classes = n_classes
        self.min_temp, self.max_temp = min_temp, max_temp
        self.mlp = nn.Sequential(nn.Conv2d(in_features, bottleneck, 1), nn.GELU(),
                                 nn.Conv2d(bottleneck, 4, 1), nn.Softplus())

    def forward(self, x, cond, b_centers):
        h = F.gelu(self.mlp[0](torch.cat([x, cond], dim=1)))
        pt = F.softplus(self.mlp[2](h))
        depth = log_binomial_depth(to_nhwc(pt), to_nhwc(b_centers), self.n_classes,
                                   self.min_temp, self.max_temp)
        return to_nchw(depth)


class ZoeDepthHead(nn.Module):
    """Metric-bins head over the core's (rel_depth, pyramid). Returns
    dict(metric_depth (B, 1, H, W), coarse_features = [x_d0, 4 decoder
    levels, midas_final_feat])."""

    def __init__(self, btl_ch: int, block_chs, n_midas_out: int = 32, n_bins: int = 64,
                 bin_centers_type: str = "softplus", bin_embedding_dim: int = 128,
                 min_depth: float = 1e-3, max_depth: float = 10.0, n_attractors=(16, 8, 4, 1),
                 attractor_kind: str = "sum", attractor_type: str = "exp",
                 min_temp: float = 5.0, max_temp: float = 50.0):
        super().__init__()
        self.normed = bin_centers_type in ("normed", "hybrid2")
        self.min_depth, self.max_depth = min_depth, max_depth
        self.conv2 = nn.Conv2d(btl_ch, btl_ch, 1)
        self.seed_bin_regressor = _Net(
            _mlp(btl_ch, 256, n_bins, nn.ReLU() if self.normed else nn.Softplus()))
        self.seed_projector = _Net(_mlp(btl_ch, 128, bin_embedding_dim, None))
        self.projectors = nn.ModuleList(
            _Net(_mlp(c, 128, bin_embedding_dim, None)) for c in block_chs)
        self.attractors = nn.ModuleList(
            AttractorLayer(bin_embedding_dim, n_attractors[i], self.normed, min_depth, max_depth,
                           attractor_kind, attractor_type) for i in range(len(block_chs)))
        self.conditional_log_binomial = ConditionalLogBinomial(
            n_midas_out + 1 + bin_embedding_dim, n_bins,
            (n_midas_out + 1 + bin_embedding_dim) // 2, min_temp, max_temp)

    def _seed(self, x_d0):
        net = self.seed_bin_regressor._net
        h = net[2](F.relu(net[0](x_d0)))
        if not self.normed:
            return F.softplus(h)
        b = F.relu(h) + 1e-3
        widths = (self.max_depth - self.min_depth) * b / b.sum(1, keepdim=True)
        widths = F.pad(widths, (0, 0, 0, 0, 1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return (centers - self.min_depth) / (self.max_depth - self.min_depth)

    def head_forward(self, rel_depth, pyramid):
        out_conv, btlnck, *x_blocks = pyramid
        x_d0 = self.conv2(btlnck)
        b_prev = self._seed(x_d0)
        prev_emb = self.seed_projector(x_d0)
        b_centers, b_embedding = b_prev, prev_emb
        for proj, attractor, x in zip(self.projectors, self.attractors, x_blocks):
            b_embedding = proj(x)
            b_prev, b_centers = attractor(b_embedding, b_prev, prev_emb)
            prev_emb = b_embedding
        last = out_conv
        size = last.shape[2:]
        last_cat = torch.cat([last, interp(rel_depth, size)], dim=1)
        depth = self.conditional_log_binomial(last_cat, interp(b_embedding, size), b_centers)
        return {"metric_depth": depth, "coarse_features": [x_d0, *x_blocks, last]}


class ZoeDepthBEiT(ZoeDepthHead):
    """'ZoeDepth' coarse type: the BEiT MiDaS core (``core.core``) and the
    bins head on the same module, as zoedepth_v1.py lays them out."""

    def __init__(self, img_size=(384, 512), embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, taps=(5, 11, 17, 23), features: int = 256,
                 out_channels=(256, 512, 1024, 1024), **head_kw):
        super().__init__(btl_ch=features, block_chs=[features] * 4, **head_kw)
        # channels of the 6 coarse levels, highest resolution first: the
        # MiDaS 32-channel out_conv, then 4 decoder levels and x_d0
        self.coarse_chl = [32] + [features] * 5
        self.core = nn.Module()
        self.core.core = MidasDPTBEiT(img_size, features, out_channels, embed_dim, depth,
                                      num_heads, taps)

    def forward(self, x):
        rel, pyramid = self.core.core(x)
        return self.head_forward(rel, pyramid)
