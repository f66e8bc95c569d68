"""BaselinePretrain, stage 1 of every training recipe: one depth network
(ZoeDepth over BEiT-L/16, or Depth-Anything-V2 over DINOv2-L) trained alone,
the port of ``patchrefinerv2_tpu/models/baseline_pretrain.py`` (``loss``
:76-94, the tiled inference :96-200).

``target="coarse"`` trains the config's ``coarse_branch`` on the
low-resolution image (``image_lr`` against ``depth_gt``); ``"fine"`` trains
its ``fine_branch`` on high-resolution crops (``crops_image_hr`` against
``crop_depths``). A Depth-Anything branch sees its input resized to sides
that are multiples of 14 (bilinear, align corners; ``backbones/dpt.da_round``,
JAX's ``_da_round``).
The loss is SILog.

Inference: the coarse target runs the network once on ``image_lr``. The
fine target tiles the raw frame as PatchRefinerPlus does, without coarse
conditioning: each regular pass (m1 one, m2 and rN four) crops and resizes
its patches (K2) into the network, chunk by chunk, and blends the depths
with the 0.1 blend mask (K7). rN then moves the canvases to the raw frame
and blends N chunks of ``process_num`` random patches there, each depth
resized back to its raw patch with nearest K2, under the raw mask + 1e-3.
N is the mode's number itself, not ``N // process_num`` as in
PatchRefinerPlus: the reference quirk that JAX keeps
(``baseline_pretrain.py:117-119``).

The module tree keeps the reference's names: the network is
``coarse_branch`` or ``fine_branch`` of :attr:`net`, so its ``torch.save``
checkpoints carry ``coarse_branch.*`` or ``fine_branch.*`` tensors, which
the later stages read through ``pretrain_coarse_model`` and
``pretrain_fine_model`` (``utils/checkpoint.py``).
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from patchrefinerv2_torch import resolve_device
from patchrefinerv2_torch.config import ConfigDict
from patchrefinerv2_torch.models.backbones.dpt import da_round
from patchrefinerv2_torch.models.blocks.convs import to_nchw, to_nhwc
from patchrefinerv2_torch.models.losses import build_loss
from patchrefinerv2_torch.models.patchrefinerplus import build_coarse_branch, init_random_
from patchrefinerv2_torch.models.tiling import TileCfg, random_pass_starts, regular_pass
from patchrefinerv2_torch.ops.blend import TileBlender
from patchrefinerv2_torch.ops.masks import generate_blend_mask
from patchrefinerv2_torch.ops.resize import crop_resize, resize

# the blend mask's border (``baseline_pretrain.py:121-122``; PatchRefinerPlus uses 0.15)
BORDER = 0.1


class BaselineNet(nn.Module):
    """The one depth network, held as ``coarse_branch`` or ``fine_branch``
    (``name``). ``forward(image NHWC)`` returns its metric depth (B, 1, H, W)."""

    def __init__(self, name: str, branch: nn.Module):
        super().__init__()
        self.branch_name = name
        setattr(self, name, branch)

    @property
    def branch(self) -> nn.Module:
        return getattr(self, self.branch_name)

    def forward(self, image):
        return self.branch(to_nchw(image))["metric_depth"]


class BaselinePretrain:
    """Config-built stage-1 model (the config's whole ``model`` dict) on one
    device (``device=None``: the card), random weights from ``seed``. The
    network starts in eval mode. ``Trainer`` trains every parameter
    (:attr:`frozen_prefixes` is empty) and reads no checkpoint key of the
    config (:func:`utils.checkpoint.apply_config_pretrained`)."""

    pretrain_stage = False
    frozen_prefixes = ()

    def __init__(self, config: dict, device=None, seed: int = 0):
        self.device = resolve_device(device)
        cfg = ConfigDict._wrap(dict(config))
        self.config = cfg
        self.target = cfg.get("target", "coarse")
        if self.target not in ("coarse", "fine"):
            raise ValueError(f"target must be 'coarse' or 'fine', got {self.target!r}")
        self.min_depth = float(cfg.get("min_depth", 1e-3))
        self.max_depth = float(cfg.get("max_depth", 80.0))
        self.patch_process_shape = tuple(cfg.get("patch_process_shape", (384, 512)))
        self.tile_cfg = TileCfg(tuple(cfg.get("image_raw_shape", (2160, 3840))),
                                tuple(cfg.get("patch_split_num", (4, 4))), self.patch_process_shape)
        self.branch_name = f"{self.target}_branch"
        branch_cfg = cfg.get(self.branch_name)
        if not branch_cfg:
            raise ValueError(f"target {self.target!r} trains the config's {self.branch_name}, "
                             "which is not set")
        self.is_da = branch_cfg["type"] == "DA2"
        branch = build_coarse_branch(branch_cfg, self.min_depth, self.max_depth,
                                     self.patch_input_shape)
        self.sigloss = build_loss(cfg.get("sigloss") or {"type": "SILogLoss"})
        net = BaselineNet(self.branch_name, branch)
        init_random_(net, torch.Generator().manual_seed(seed))
        self.net = net.to(self.device, memory_format=torch.channels_last).eval()

    @property
    def patch_input_shape(self) -> tuple[int, int]:
        """The network's input size for a patch: ``patch_process_shape``,
        rounded for a Depth-Anything branch."""
        return self.input_shape(self.patch_process_shape)

    def input_shape(self, shape) -> tuple[int, int]:
        return da_round(shape) if self.is_da else tuple(shape)

    def train(self, mode: bool = True) -> "BaselinePretrain":
        self.net.train(mode)
        return self

    def eval(self) -> "BaselinePretrain":
        return self.train(False)

    def _network_input(self, image):
        """``image`` (B, h, w, 3) resized to the network's input size when
        that differs (bilinear, align corners)."""
        size = self.input_shape(image.shape[1:3])
        if tuple(image.shape[1:3]) != size:
            image = resize(image, size, "bilinear", True)
        return image

    def loss(self, batch: dict, generator=None, update_stats: bool = False):
        """(loss_dict, aux) of a training batch (``baseline_pretrain.py:76-94``),
        NHWC tensors or arrays: SILog of the network's depth on ``image_lr``
        against ``depth_gt`` (``coarse_loss``) or on ``crops_image_hr``
        against ``crop_depths`` (``fine_loss``); ``total_loss`` is the same.
        The network has no BatchNorm: ``generator`` and ``update_stats`` are
        taken for ``Trainer`` and change nothing. aux: ``depth_pred``
        (B, h, w, 1) at the network's input size."""
        image_key, gt_key, name = (("image_lr", "depth_gt", "coarse_loss") if self.target == "coarse"
                                   else ("crops_image_hr", "crop_depths", "fine_loss"))
        dt = next(self.net.parameters()).dtype
        image = torch.as_tensor(batch[image_key]).to(self.device, dt)
        gt = torch.as_tensor(batch[gt_key]).to(self.device, dt)
        depth = to_nhwc(self.net(self._network_input(image)))
        loss = self.sigloss(depth, gt, self.min_depth, self.max_depth)
        return {name: loss, "total_loss": loss}, {"depth_pred": depth}

    def _tile(self, tile_cfg) -> TileCfg:
        return self.tile_cfg if tile_cfg is None else TileCfg(
            tuple(tile_cfg["image_raw_shape"]), tuple(tile_cfg["patch_split_num"]),
            self.patch_process_shape)

    def _depths(self, imgs):
        """(N, h, w) depths of NHWC patches at the network's input size."""
        return self.net(imgs)[:, 0]

    @torch.inference_mode()
    def infer(self, image_lr, image_hr, cai_mode: str = "m1", process_num: int = 4,
              tile_cfg: dict | None = None, generator: torch.Generator | None = None,
              random_starts=None):
        """Inference of ``image_lr`` (1, h, w, 3) and ``image_hr`` (1, H, W, 3)
        NHWC in [0, 1] (tensors or arrays).

        Coarse target: the network on ``image_lr`` (rounded for a
        Depth-Anything branch), whatever the mode; returns (depth (h', w'),
        depth (1, h', w', 1)).

        Fine target: the tiled inference of ``cai_mode`` m1, m2 or rN over
        ``image_hr`` at the config's tiling or ``tile_cfg``
        ({"image_raw_shape", "patch_split_num"}), ``process_num`` patches a
        chunk. rN draws its N x ``process_num`` random starts from the CPU
        ``generator`` (default: seed 0), or takes them from
        ``random_starts`` ((N, process_num, 2) int [h, w]). Returns (depth
        float32 on the reensemble canvas for m1 and m2, on the raw canvas
        for rN; None)."""
        dt = next(self.net.parameters()).dtype
        if self.target == "coarse":
            lr = torch.as_tensor(image_lr).to(self.device, dt).contiguous()
            depth = to_nhwc(self.net(self._network_input(lr))).float()
            return depth[0, :, :, 0], depth
        rn = re.fullmatch(r"r(\d+)", cai_mode)
        if cai_mode not in ("m1", "m2") and rn is None:
            raise NotImplementedError(f"cai_mode {cai_mode!r} is not ported (m1, m2, rN)")
        dev = self.device
        tc = self._tile(tile_cfg)
        pph, ppw = self.patch_process_shape
        prh, prw = tc.patch_raw_shape
        in_shape = self.patch_input_shape
        hr = torch.as_tensor(image_hr).to(dev, dt).contiguous()
        passes = [regular_pass(tc, off, process_num)
                  for off in ((0, 0),) + (((0, 1), (1, 0), (1, 1)) if cai_mode != "m1" else ())]
        n_random = int(rn.group(1)) if rn else 0
        if n_random:
            if random_starts is None:
                gen = generator if generator is not None else torch.Generator().manual_seed(0)
                random_starts = np.stack([random_pass_starts(gen, tc, process_num)
                                          for _ in range(n_random)])
            random_starts = np.asarray(random_starts, np.int32)
            if random_starts.shape != (n_random, process_num, 2):
                raise ValueError(f"{cai_mode} with process_num {process_num} takes random starts "
                                 f"of shape {(n_random, process_num, 2)}, got {random_starts.shape}")
        starts = np.concatenate([p.starts_raw for p in passes]
                                + ([random_starts.reshape(-1, 2)] if n_random else []))
        if starts.min() < 0 or (starts + np.array([prh, prw]) > np.array(hr.shape[1:3])).any():
            raise ValueError(f"the tile plan reaches outside the {tuple(hr.shape[1:3])} frame")
        blur = torch.from_numpy(generate_blend_mask((pph, ppw), border=BORDER)).to(dev)
        state = TileBlender.init(tc.patch_reensemble_shape, dev)
        for pi, p in enumerate(passes):
            n = p.starts_raw.shape[0]
            s_raw = torch.from_numpy(p.starts_raw).to(dev)
            s_place = torch.from_numpy(p.starts_process).to(dev)
            valid = torch.from_numpy((np.arange(n) < p.n_valid).astype(np.float32)).to(dev)
            for lo in range(0, n, process_num):
                sl = slice(lo, lo + process_num)
                preds = self._depths(crop_resize(hr[0], s_raw[sl], (prh, prw), in_shape))
                if tuple(preds.shape[1:]) != (pph, ppw):
                    preds = resize(preds[..., None], (pph, ppw), "bilinear", True)[..., 0]
                TileBlender.add_pass(state, preds, blur, s_place[sl], init_pass=pi == 0,
                                     valid=valid[sl])
        if n_random:
            state = TileBlender.resize(state, tc.image_raw_shape)
            blur_raw = torch.from_numpy(generate_blend_mask((prh, prw), border=BORDER) + 1e-3).to(dev)
            for rs in random_starts:
                s = torch.from_numpy(rs).to(dev)
                preds = self._depths(crop_resize(hr[0], s, (prh, prw), in_shape))
                preds = resize(preds[..., None], (prh, prw), mode="nearest")[..., 0]
                TileBlender.add_pass(state, preds, blur_raw, s)
        return TileBlender.finalize(state), None
