"""PatchRefinerPlus (the V2 flagship) tiled inference, the port of
``patchrefinerv2_tpu/models/patchrefinerplus.py`` (``ZoeDepthBEiT`` :64,
``build_coarse_branch`` :117, ``PRPlusNet.coarse_forward``/``_roi``/
``refine``/``infer_chunk`` :200-294, ``PatchRefinerPlus.infer`` :559-768)
for ``cai_mode`` m1, m2 and rN, with a ZoeDepth (BEiT) or a
Depth-Anything-V2 (DINOv2) coarse branch. With a DA2 coarse branch the
Depth-Anything resizer applies (``resizer_kind == "da"`` in the JAX
package): ``image_lr`` goes to the coarse branch resized (K2 bilinear,
align corners) to ``da_round`` of its sides, and the patches are
crop-resized to ``da_round`` of the process shape, their depths resized
back to it.

Per frame: the coarse branch once at the coarse resolution, then for every
chunk of patches: crop + resize (K2), roi_align of the six coarse levels and
the coarse depth (K1), the refiner (EfficientNet-B5 or MobileNetV4) and BiDirectionalFusion
(cuDNN convolutions, K2 upsamples, K6 LayerNorms, K5 gate tails), and
blending into the canvases (K7); rN then moves the canvases to the raw
resolution (K2, K7 finalize) and blends random chunks there, each
prediction resized back to its raw patch with nearest K2. The coarse
branch runs K3 (BEiT) or K4 (DINOv2) attention and, for ZoeDepth, the K8
bins head. ``lax.scan`` over chunks becomes a Python loop.

The module tree keeps the reference's torch state-dict names
(``coarse_branch``, ``refiner_fine_branch``, ``refiner_fusion_model``), so
``utils/jax_weights.load_jax_params`` can load the JAX package's variables.

Training (``PatchRefinerPlus.loss``): in the pretraining stage
(``pretrain_stage``, ``patchrefinerplus.py:316-336, 373-377, 503-519``) the
net has no coarse branch, and the loss runs the refiner with its decoder and
the fusion head on hacked coarse features, then SILog against the
full-resolution depth. Otherwise (stage 3, ``patchrefinerplus.py:296-314,
519-556``) it runs ``train_forward``: the coarse branch (ZoeDepth or DA2) on
``image_lr`` as the loader gives it (under no gradient when
``e2e_training`` is off, as ``stop_gradient`` cuts it there), roi_align of
its levels and depth at each crop's box (K1, whose
gradient reaches the coarse branch), the refiner and the fusion head on the
crops, then SILog and GradMatch against ``crop_depths``. The refiner and
the fusion head run under ``torch.utils.checkpoint`` when the config sets
``remat``.

The int8 serving mode (``patchrefinerplus.py:770-867`` and ``ops/quant.py``
in the JAX package) routes the convolutions that the gate selects to K10
(``models/int8.py``): calibrated (``calibrate_int8``, then ``set_int8``) or
dynamic (``set_int8(None, "dynamic")``, scales taken live).
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from patchrefinerv2_torch import resolve_device
from patchrefinerv2_torch.config import ConfigDict
from patchrefinerv2_torch.models.backbones.dpt import DepthAnythingV2, da_round
from patchrefinerv2_torch.models.backbones.encoders import arm_stat_updates
from patchrefinerv2_torch.models.backbones.vit import DinoViT
from patchrefinerv2_torch.models.backbones.zoedepth import ZoeDepthBEiT
from patchrefinerv2_torch.models.blocks.convs import to_nchw, to_nhwc
from patchrefinerv2_torch.models.blocks.dpt import SimpleDPTHead
from patchrefinerv2_torch.models.blocks.fusion import BiDirectionalFusion, FusionUnet
from patchrefinerv2_torch.models.blocks.refiner import LightWeightRefiner
from patchrefinerv2_torch.models.int8 import (
    MIN_HW, MIN_KC, SCALES, Int8Calibration, calibration, record, serve,
)
from patchrefinerv2_torch.models.losses import build_loss
from patchrefinerv2_torch.models.tiling import (
    _BATCH_GRANULE, TileCfg, merge_all_passes, random_pass_boxes, random_pass_starts, regular_pass,
)
from patchrefinerv2_torch.ops.blend import TileBlender
from patchrefinerv2_torch.ops.masks import generate_blend_mask
from patchrefinerv2_torch.ops.resize import crop_resize, resize
from patchrefinerv2_torch.ops.roi_align import roi_align

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_coarse_branch(cfg, min_depth: float, max_depth: float, img_size):
    """The coarse branch of the config: ``ZoeDepth`` (BEiT MiDaS core + bins
    head) or ``DA2`` (Depth-Anything-V2, patchrefinerplus.py:169-178)."""
    if cfg["type"] == "DA2":
        mc = cfg.get("model_cfg", {})
        return DepthAnythingV2(encoder=mc.get("encoder", "vitl"), features=mc.get("features", 256),
                               max_depth=max_depth)
    if cfg["type"] != "ZoeDepth":
        raise NotImplementedError(f"coarse branch {cfg['type']!r} is not ported (ZoeDepth, DA2 are)")
    trunk = cfg.get("trunk", {})  # test-size overrides; default BEiT-L/16
    return ZoeDepthBEiT(
        img_size=tuple(img_size),
        embed_dim=trunk.get("embed_dim", 1024),
        depth=trunk.get("depth", 24),
        num_heads=trunk.get("num_heads", 16),
        taps=tuple(trunk.get("taps", (5, 11, 17, 23))),
        features=trunk.get("features", 256),
        out_channels=tuple(trunk.get("out_channels", (256, 512, 1024, 1024))),
        n_bins=cfg.get("n_bins", 64),
        bin_centers_type=cfg.get("bin_centers_type", "softplus"),
        bin_embedding_dim=cfg.get("bin_embedding_dim", 128),
        min_depth=min_depth,
        max_depth=max_depth,
        n_attractors=tuple(cfg.get("n_attractors", [16, 8, 4, 1])),
        attractor_kind=cfg.get("attractor_kind", "mean"),
        attractor_type=cfg.get("attractor_type", "inv"),
        min_temp=cfg.get("min_temp", 0.0212),
        max_temp=cfg.get("max_temp", 50.0),
    )


class PRPlusNet(nn.Module):
    """The compute graph; the tiling orchestration lives in PatchRefinerPlus.
    In the pretraining stage it has no coarse branch: the refiner (with its
    decoder) and the fusion head run on hacked coarse features
    (:meth:`pretrain_forward`).

    ``v1``: PatchRefiner V1's graph (``patchrefinerv2_tpu/models/
    patchrefiner.py:23-75``): the fine branch is a whole depth network like
    the coarse one (ZoeDepth or DA2, built at the patch shape; it returns
    its 6 levels and its depth and ignores the coarse depth, as
    ``ZoeFineBranch`` does), the head FusionUnet, and the coarse branch
    never trains."""

    def __init__(self, cfg, v1: bool = False):
        super().__init__()
        self.min_depth, self.max_depth = cfg.min_depth, cfg.max_depth
        self.patch_process_shape = tuple(cfg.patch_process_shape)
        self.strategy_refiner_target = cfg.get("strategy_refiner_target", "offset_coarse")
        self.fusion_feat_level = cfg.get("fusion_feat_level", 6)
        self.remat = bool(cfg.get("remat", False))
        self.v1 = v1
        self.e2e_training = bool(cfg.get("e2e_training", False)) and not v1
        if v1:
            if cfg.get("pretrain_stage", False):
                raise NotImplementedError("PatchRefiner V1 has no pretraining stage")
            self.coarse_branch = build_coarse_branch(
                cfg.coarse_branch, self.min_depth, self.max_depth, self.patch_process_shape)
            fine, fus = dict(cfg.refiner.fine_branch), dict(cfg.refiner.fusion_model)
            if fine.get("type") not in ("ZoeDepth", "DA2") or fus.get("type") != "FusionUnet":
                raise NotImplementedError(
                    "PatchRefiner V1's fine branch is a ZoeDepth or DA2 depth network and its "
                    f"fusion model FusionUnet, got {fine.get('type')!r} and {fus.get('type')!r}")
            self.refiner_fine_branch = build_coarse_branch(
                fine, self.min_depth, self.max_depth, self.patch_process_shape)
            in_chl = [c + f for c, f in zip(self.coarse_branch.coarse_chl,
                                            self.refiner_fine_branch.coarse_chl)]
            self.refiner_fusion_model = FusionUnet(
                in_chl, **{k: tuple(v) for k, v in fus.items() if k in ("temp_chl", "dec_chl")})
            return
        if cfg.get("pretrain_stage", False):
            # the hacked coarse features' widths, highest resolution first
            # (patchrefinerplus.py:320-328)
            is_da2 = cfg.get("coarse_branch", {}).get("type") == "DA2"
            coarse_chl = [128 if is_da2 else 32] + [256] * 5
            self.hack_chl = coarse_chl[::-1]
        else:
            self.coarse_branch = build_coarse_branch(
                cfg.coarse_branch, self.min_depth, self.max_depth, self.patch_process_shape)
            coarse_chl = self.coarse_branch.coarse_chl
        fine = dict(cfg.refiner.fine_branch)
        if fine.pop("type") != "LightWeightRefiner":
            raise NotImplementedError("the port's refiner is LightWeightRefiner")
        self.refiner_fine_branch = LightWeightRefiner(
            encoder_name=fine.get("encoder_name", "tf_efficientnet_b5_ap"),
            coarse_condition=fine.get("coarse_condition", True),
            with_decoder=fine.get("with_decoder", False),
            encoder_spec=fine.get("encoder_spec"))
        fus = dict(cfg.refiner.fusion_model)
        if fus.pop("type") != "BiDirectionalFusion":
            raise NotImplementedError("the port's fusion model is BiDirectionalFusion")
        # the widths come from the stage: the coarse branch's levels or the
        # hacked ones, the encoder's levels or the decoder's
        self.refiner_fusion_model = BiDirectionalFusion(
            coarse_chl=coarse_chl,
            fine_chl=self.refiner_fine_branch.channels,
            fine_top_chl=self.refiner_fine_branch.top_channels,
            temp_chl=tuple(fus.get("temp_chl", (32, 64, 64, 128, 256, 512))),
            dec_chl=tuple(fus.get("dec_chl", (512, 256, 128, 64, 32))),
            coarse2fine=fus.get("coarse2fine", True),
            coarse2fine_type=fus.get("coarse2fine_type", "coarse-gated"),
            glb_att=fus.get("glb_att", False),
            c2f_features=fus.get("c2f_features", 256),
            head2_features=list(fus.get("coarse_chl", [32]))[0],
        )

    def _checkpointed(self, module, *args, **kwargs):
        """``module(*args, **kwargs)``, rematerialised in the backward when
        the config sets ``remat`` (the JAX package's ``nn.remat`` of the
        refiner and the fusion head, patchrefinerplus.py:382-402). A train-mode
        BatchNorm updates its statistics in the first forward only: the loss
        arms it once (``arm_stat_updates``), and the recompute finds it
        disarmed."""
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(module, *args, use_reentrant=False, **kwargs)
        return module(*args, **kwargs)

    def pretrain_forward(self, image_lr, hack_strategy: str, generator=None, coarse_features=None):
        """Refiner pretraining with hacked coarse features
        (patchrefinerplus.py:316-336): ``image_lr`` NHWC (B, h, w, 3) ->
        relu(fusion output) (B, 1, h, w). The refiner's BatchNorm runs in
        the module's mode (train mode in training). ``coarse_features``: the
        hacked levels (low -> high resolution, NCHW), else drawn here:
        ``mean_0_std_1`` normals from ``generator`` (on the image's device),
        ``constant`` ones."""
        feats, r_depth = self._checkpointed(self.refiner_fine_branch, to_nchw(image_lr))
        if coarse_features is None:
            coarse_features = []
            for f, c in zip(feats, self.hack_chl):
                b, _, h, w = f.shape
                if hack_strategy == "mean_0_std_1":
                    x = torch.randn((b, h, w, c), generator=generator, device=f.device, dtype=f.dtype)
                else:
                    x = torch.ones((b, h, w, c), device=f.device, dtype=f.dtype)
                coarse_features.append(to_nchw(x))
        pred1 = torch.zeros_like(r_depth)
        depth = self._checkpointed(self.refiner_fusion_model, list(coarse_features)[::-1],
                                   list(feats)[::-1], pred1, r_depth)
        return torch.relu(depth)

    def coarse_forward(self, image_lr):
        """image_lr NHWC -> (6 coarse levels, coarse depth), NCHW channels_last.
        Without ``e2e_training`` the branch runs under no gradient: its
        outputs are detached, as the JAX package's ``stop_gradient`` makes
        them (patchrefinerplus.py:200-207)."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.e2e_training):
            out = self.coarse_branch(to_nchw(image_lr))
        return out["coarse_features"], out["metric_depth"]

    def _roi(self, coarse_pred, coarse_feats, bboxes, box_idx):
        pph = self.patch_process_shape[0]
        rois = []
        for f in list(coarse_feats) + [coarse_pred]:
            h, w = f.shape[2:]
            rois.append(to_nchw(roi_align(to_nhwc(f), bboxes, box_idx, (h, w), h / pph)))
        return rois[:-1], rois[-1]

    def refine(self, imgs_crop, coarse_feat_rois, coarse_pred_roi):
        """Refiner + fusion on a batch of NCHW patches
        (patchrefinerplus.py:242-293). The refiner's BatchNorm runs in the
        module's mode; under a gradient with ``remat`` the refiner and the
        fusion head are rematerialised in the backward (``_checkpointed``),
        as :meth:`pretrain_forward` runs them."""
        cdt = imgs_crop.dtype
        coarse_pred_roi = coarse_pred_roi.to(cdt)
        coarse_feat_rois = [f.to(cdt) for f in coarse_feat_rois]
        if self.v1:
            out = self._checkpointed(self.refiner_fine_branch, imgs_crop)
            r_feats, r_depth = out["coarse_features"], out["metric_depth"]
        else:
            r_feats, r_depth = self._checkpointed(self.refiner_fine_branch, imgs_crop, coarse_pred_roi)
        update_base = {"offset_fine": r_depth, "offset_coarse": coarse_pred_roi}.get(
            self.strategy_refiner_target)
        L = self.fusion_feat_level
        depth = self._checkpointed(
            self.refiner_fusion_model, list(coarse_feat_rois)[-L:][::-1], list(r_feats)[-L:][::-1],
            coarse_pred_roi, r_depth, update_base=update_base)
        if self.strategy_refiner_target == "direct":
            depth = torch.sigmoid(depth) * self.max_depth
        return depth

    def infer_chunk(self, imgs_crop, coarse_pred, coarse_feats, bboxes):
        """imgs_crop NHWC (N, h, w, 3) -> depth (N, 1, h, w)."""
        idx = torch.zeros(bboxes.shape[0], dtype=torch.int32, device=bboxes.device)
        feat_rois, pred_roi = self._roi(coarse_pred, coarse_feats, bboxes, idx)
        return self.refine(to_nchw(imgs_crop), feat_rois, pred_roi)

    def train_forward(self, image_lr, crops, bboxes):
        """The training graph up to the depth (patchrefinerplus.py:296-314):
        ``image_lr`` NHWC (B, h, w, 3) through the coarse branch, the crops
        NHWC (B, h, w, 3) with one box (B, 4) each in their own image.
        Returns (depth (B, 1, h, w), coarse depth (B, 1, h, w))."""
        coarse_feats, coarse_pred = self.coarse_forward(image_lr)
        idx = torch.arange(bboxes.shape[0], dtype=torch.int32, device=bboxes.device)
        feat_rois, pred_roi = self._roi(coarse_pred, coarse_feats, bboxes, idx)
        return self.refine(to_nchw(crops), feat_rois, pred_roi), coarse_pred


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: every conv and linear weight
    uniform in +-1/sqrt(fan_in) and its bias zero, a DINOv2 position
    embedding normal with std 0.02 (as the JAX package initialises it), the
    refiner decoder's ``output_conv3`` normal with mean 1;
    norms, layer scales, the cls token, q/v biases and the relative-position
    tables keep their initial values (ones, 1e-5 or 1, and zeros)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * (2 * bound) - bound)
                if m.bias is not None:
                    m.bias.zero_()
            if isinstance(m, DinoViT):
                m.pos_embed.copy_(torch.randn(m.pos_embed.shape, generator=generator) * 0.02)
            if isinstance(m, SimpleDPTHead):
                m.init_output_conv3_(generator)
    return module


class PatchRefinerPlus:
    """Config-built orchestrator for tiled inference and the training loss
    (the pretraining stage, and stage 3 with a ZoeDepth or a DA2 coarse
    branch), on one device.

    ``device=None`` means the card, and raises when there is none. The
    network starts in eval mode; :meth:`train` switches it."""

    v1 = False  # PatchRefiner V1's graph (``PRPlusNet(cfg, v1=True)``)

    def __init__(self, config: dict, device=None, seed: int = 0):
        self.device = resolve_device(device)
        cfg = ConfigDict._wrap(dict(config))
        self.config = cfg
        self.patch_process_shape = tuple(cfg.patch_process_shape)
        self.tile_cfg = TileCfg(tuple(cfg.image_raw_shape), tuple(cfg.patch_split_num),
                                self.patch_process_shape)
        self.pretrain_stage = bool(cfg.get("pretrain_stage", False))
        self.hack_strategy = cfg.get("hack_strategy", "mean_0_std_1")
        if self.hack_strategy not in ("mean_0_std_1", "constant"):
            raise ValueError(f"unknown hack_strategy {self.hack_strategy!r}")
        if cfg.get("train_dtype", "float32") != "float32":
            raise NotImplementedError("the port trains in float32 only")
        self.min_depth, self.max_depth = cfg.min_depth, cfg.max_depth
        self.sigloss = build_loss(cfg.get("sigloss", {"type": "SILogLoss"}))
        self.gmloss = build_loss(cfg.get("gmloss", {"type": "GradMatchLoss"}))
        self.sigweight = float(cfg.get("sigweight", 1.0))
        self.pre_norm_bbox = bool(cfg.get("pre_norm_bbox", True))
        self.infer_dtype = _DTYPES[cfg.get("infer_dtype", "float32")]
        # the Depth-Anything resizer (``resizer_kind == "da"``,
        # patchrefinerplus.py:117-180): a DA2 coarse branch outside pretraining
        self.resizer_da = not self.pretrain_stage and cfg.coarse_branch.get("type") == "DA2"
        net = PRPlusNet(cfg, v1=self.v1)
        init_random_(net, torch.Generator().manual_seed(seed))
        self.net = net.to(self.device, memory_format=torch.channels_last).eval()
        if self.infer_dtype != torch.float32:
            self.net.to(self.infer_dtype)
        # (calibration or None, scales, force, min_kc, min_hw) while the int8 mode is set
        self._int8 = None

    @property
    def patch_input_shape(self) -> tuple[int, int]:
        """The patches' size at the refiner's input (``patchrefinerplus.py:440-445``):
        the process shape, rounded by the Depth-Anything resizer."""
        return self.coarse_input_shape(self.patch_process_shape)

    def coarse_input_shape(self, lr_shape) -> tuple[int, int]:
        """The coarse branch's input size for an ``image_lr`` of ``lr_shape``
        (``patchrefinerplus.py:447-449``)."""
        return da_round(lr_shape) if self.resizer_da else tuple(lr_shape)

    def _coarse_input(self, image_lr):
        """``image_lr`` NHWC resized (bilinear, align corners) to the coarse
        branch's input size where that differs (``patchrefinerplus.py:628-631``)."""
        size = self.coarse_input_shape(image_lr.shape[1:3])
        if tuple(image_lr.shape[1:3]) != size:
            image_lr = resize(image_lr, size, "bilinear", True)
        return image_lr

    def _check_coarse_map(self, coarse_pred) -> None:
        """The coarse depth's roi comes out at the coarse map's size
        (``_roi``, ``patchrefinerplus.py:209-221``): a coarse-conditioned
        refiner takes it beside the patch, and the ``offset_coarse`` target
        adds it to the patch's depth, so there the map must have the
        patches' size. The JAX package fails at that concatenation; the port
        says why before the patches run."""
        needs = getattr(self.net.refiner_fine_branch, "coarse_condition", False) or \
            self.net.strategy_refiner_target == "offset_coarse"
        if needs and tuple(coarse_pred.shape[2:]) != self.patch_input_shape:
            raise ValueError(
                f"the coarse map is {tuple(coarse_pred.shape[2:])} but the patches "
                f"{self.patch_input_shape}: the refiner takes the coarse depth's roi at the coarse "
                "map's size, so image_lr must come to the patches' size (after da_round with a "
                "Depth-Anything coarse branch), e.g. a loader's network_process_size of "
                f"{list(self.patch_process_shape)}")

    def _patches(self, image_hr, starts, patch_raw_shape):
        """The raw patches at ``starts`` crop-resized to the refiner's input size."""
        return crop_resize(image_hr[0], starts, patch_raw_shape, self.patch_input_shape)

    def set_infer_dtype(self, dtype: torch.dtype) -> None:
        """Cast the parameters (in place) and run inference in ``dtype``. A
        calibration made in another dtype is stale: serving with it raises
        until ``calibrate_int8`` and ``set_int8`` run again. The dynamic int8
        mode quantizes the cast weights anew."""
        self.infer_dtype = dtype
        self.net.to(dtype)
        self._attach_int8()

    def train(self, mode: bool = True) -> "PatchRefinerPlus":
        """Train mode (``mode``) or eval mode of the network: its BatchNorm
        normalises with the batch's moments in train mode."""
        self.net.train(mode)
        return self

    def eval(self) -> "PatchRefinerPlus":
        return self.train(False)

    def loss(self, batch: dict, generator: torch.Generator | None = None,
             update_stats: bool = False, coarse_features=None):
        """(loss_dict, aux) of a training batch (``patchrefinerplus.py:503-556``),
        NHWC tensors or arrays. The refiner's BatchNorm updates its running
        statistics once with ``update_stats`` (flax's
        ``mutable=["batch_stats"]``), which needs :meth:`train` first.

        Pretraining stage: the refiner and the fusion head on hacked coarse
        features (drawn from ``generator``, a generator on the model's
        device, or ``coarse_features`` as :meth:`PRPlusNet.pretrain_forward`
        takes them), ``relu`` of the fusion output as the depth, and SILog
        against ``depth_gt``. Its BatchNorm always runs in train mode, so
        without ``update_stats`` it raises, as the JAX package's immutable
        ``apply`` does. ``batch``: ``image_lr`` (B, h, w, 3), ``depth_gt``
        (B, H, W, 1). aux: ``depth_pred`` (B, h, w, 1).

        Otherwise (stage 3): :meth:`PRPlusNet.train_forward` of ``image_lr``
        (B, h, w, 3; a DA2 coarse branch takes it as it is, not resized, as
        in the JAX package, so its sides must be multiples of 14),
        ``crops_image_hr`` (B, h, w, 3) and ``bboxs`` (B, 4),
        scaled from the raw frame to the process frame unless
        ``pre_norm_bbox``; SILog and GradMatch of the depth against
        ``crop_depths`` (B, H, W, 1), ``total = sigweight * sig + (1 -
        sigweight) * gm`` (GradMatch computed at ``sigweight`` 1 too). Without
        ``update_stats`` BatchNorm runs on its running statistics, as JAX's
        ``train=bool(mutable)`` makes it. aux: ``depth_pred`` and
        ``coarse_prediction`` (B, h, w, 1)."""
        if update_stats and not self.net.training:
            raise RuntimeError("update_stats runs BatchNorm in train mode: call train() first")
        dt = next(self.net.parameters()).dtype

        def dev(key):
            return torch.as_tensor(batch[key]).to(self.device, dt)

        if self.pretrain_stage:
            if not update_stats:
                raise RuntimeError(
                    "the pretraining stage runs the refiner's BatchNorm in train mode, which updates "
                    "its running statistics: pass update_stats=True")
            arm_stat_updates(self.net)
            depth = self.net.pretrain_forward(dev("image_lr"), self.hack_strategy, generator,
                                              coarse_features)
            depth = to_nhwc(depth)
            sig = self.sigloss(depth, dev("depth_gt"), self.min_depth, self.max_depth)
            return {"sig_fine_loss": sig, "total_loss": sig}, {"depth_pred": depth}
        bboxes = torch.as_tensor(batch["bboxs"]).to(self.device, torch.float32)
        if not self.pre_norm_bbox:
            (rh, rw), (ph, pw) = self.tile_cfg.image_raw_shape, self.patch_process_shape
            bboxes = bboxes * torch.tensor([pw / rw, ph / rh, pw / rw, ph / rh],
                                           dtype=torch.float32, device=self.device)
        mode = self.net.training
        self.net.train(update_stats)
        try:
            if update_stats:
                arm_stat_updates(self.net)
            depth, coarse_pred = self.net.train_forward(dev("image_lr"), dev("crops_image_hr"), bboxes)
        finally:
            self.net.train(mode)
        # the JAX package takes the losses of float32 predictions
        depth, coarse_pred = to_nhwc(depth).float(), to_nhwc(coarse_pred).float()
        target = dev("crop_depths")
        sig = self.sigloss(depth, target, self.min_depth, self.max_depth)
        gm = self.gmloss(depth, target, self.min_depth, self.max_depth)
        total = self.sigweight * sig + (1.0 - self.sigweight) * gm
        return ({"sig_fine_loss": sig, "gm_loss": gm, "total_loss": total},
                {"depth_pred": depth, "coarse_prediction": coarse_pred})

    def _tile(self, tile_cfg) -> TileCfg:
        return self.tile_cfg if tile_cfg is None else TileCfg(
            tuple(tile_cfg["image_raw_shape"]), tuple(tile_cfg["patch_split_num"]),
            self.patch_process_shape)

    def _inputs(self, image_lr, image_hr):
        dev, dt = self.device, self.infer_dtype
        return (torch.as_tensor(image_lr).to(dev, dt).contiguous(),
                torch.as_tensor(image_hr).to(dev, dt).contiguous())

    @torch.inference_mode()
    def calibrate_int8(self, images, process_num: int = 16, tile_cfg: dict | None = None,
                       min_kc: int = MIN_KC, min_hw: int = MIN_HW) -> Int8Calibration:
        """Post-training calibration of the int8 serving mode
        (``patchrefinerplus.py:770-867``): the exact network in the current
        infer dtype over the m1 pass and the three shifted passes of every
        ``(image_lr, image_hr)`` in ``images``, chunk by chunk, each int8
        site taking the abs-max of its input per tensor and per input
        channel; then each site's weights quantized per output channel, as
        they are and with the per-channel scales folded in. Every site is
        calibrated; ``min_kc`` and ``min_hw`` are the gates serving applies.
        Returns the calibration, on the model's device."""
        tc = self._tile(tile_cfg)
        recs = record(self.net)
        try:
            for image_lr, image_hr in images:
                lr, hr = self._inputs(image_lr, image_hr)
                coarse_feats, coarse_pred = self.net.coarse_forward(self._coarse_input(lr))
                for off in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    p = regular_pass(tc, off, process_num)
                    s_raw = torch.from_numpy(p.starts_raw).to(self.device)
                    boxes = torch.from_numpy(p.bboxes).to(self.device)
                    for lo in range(0, s_raw.shape[0], process_num):
                        sl = slice(lo, lo + process_num)
                        imgs = self._patches(hr, s_raw[sl], tc.patch_raw_shape)
                        self.net.infer_chunk(imgs, coarse_pred, coarse_feats, boxes[sl])
        finally:
            self._attach_int8()
        return calibration(self.net, recs, min_kc, min_hw)

    def set_int8(self, calibration: Int8Calibration | None, scales: str = "perchan",
                 force: bool = False, min_kc: int = MIN_KC, min_hw: int = MIN_HW) -> None:
        """Serve the int8 sites that the gates select with K10: with the
        calibration's scales and gates, per input channel (``"perchan"``, the
        JAX bench's default) or per tensor (``"tensor"``); or, with no
        calibration and ``scales="dynamic"``, with one scale per site and
        chunk taken from the input's live abs-max (the reference's
        ``PRV2_INT8=1`` without ``quant_scales``, ``quant.py:330-337``), the
        weights quantized per output channel here, and the gates ``min_kc``
        and ``min_hw``. ``None`` with another ``scales`` switches the mode
        off. As in the reference (``quant.py:68-79``) the mode applies only
        to a 2-byte infer dtype (bfloat16) unless ``force``, the counterpart
        of ``PRV2_INT8_FORCE``."""
        if scales not in SCALES:
            raise ValueError(f"scales must be one of {SCALES}, got {scales!r}")
        if scales == "dynamic" and calibration is not None:
            raise ValueError("the dynamic int8 mode takes no calibration")
        on = calibration is not None or scales == "dynamic"
        self._int8 = (calibration, scales, force, min_kc, min_hw) if on else None
        self._attach_int8()

    def _attach_int8(self) -> None:
        """Serve the int8 sites while the mode applies (a 2-byte dtype or
        ``force``, and a calibration of this dtype or the dynamic mode), else
        run them exact."""
        if self._int8 is None:
            return serve(self.net, None)
        cal, scales, force, min_kc, min_hw = self._int8
        if not (torch.finfo(self.infer_dtype).bits == 16 or force) or (
                cal is not None and cal.dtype != self.infer_dtype):
            return serve(self.net, None)
        serve(self.net, cal, scales, min_kc, min_hw)

    def _plan(self, tc: TileCfg, cai_mode: str, process_num: int):
        """(patch stream, per-patch init flags or None, chunk, random
        iterations) of the mode: m1 is one init pass in chunks of
        ``process_num``; m2 and rN merge the init pass and the three shifted
        passes into one stream in chunks of ``min(process_num, 8)``; rN then
        runs ``N // process_num`` random chunks of ``process_num`` patches."""
        if cai_mode == "m1":
            return regular_pass(tc, (0, 0), process_num), None, process_num, 0
        rn = re.fullmatch(r"r(\d+)", cai_mode)
        if cai_mode != "m2" and rn is None:
            raise NotImplementedError(f"cai_mode {cai_mode!r} is not ported (m1, m2, rN)")
        chunk = min(process_num, _BATCH_GRANULE)
        stream, initv = merge_all_passes(
            [regular_pass(tc, off, process_num) for off in ((0, 0), (0, 1), (1, 0), (1, 1))], chunk)
        return stream, initv, chunk, (int(rn.group(1)) // process_num if rn else 0)

    @torch.inference_mode()
    def infer(self, image_lr, image_hr, cai_mode: str = "m1", process_num: int = 4,
              tile_cfg: dict | None = None, generator: torch.Generator | None = None,
              random_starts=None):
        """Tiled inference. ``image_lr`` (1, h, w, 3), ``image_hr`` (1, H, W, 3)
        NHWC in [0, 1] (tensors or arrays). ``tile_cfg`` ({"image_raw_shape",
        "patch_split_num"}) overrides the config's tiling. rN draws its random
        starts from the CPU ``generator`` (default: seed 0), or takes them
        from ``random_starts`` ((N // process_num, process_num, 2) int [h, w]).
        ``image_lr`` must come to the patches' size at the coarse branch
        (:meth:`_check_coarse_map`).
        Returns (depth float32 on the reensemble canvas (H', W') for m1 and
        m2, on the raw (H, W) canvas for rN; coarse depth (1, h, w, 1), at
        ``da_round`` of (h, w) with a DA2 coarse branch)."""
        if self.pretrain_stage:
            raise NotImplementedError("the pretraining stage builds no coarse branch to infer with")
        cal = self._int8[0] if self._int8 is not None else None
        if cal is not None and cal.dtype != self.infer_dtype:
            raise RuntimeError(f"the int8 calibration was made in {cal.dtype}, the model "
                               f"now infers in {self.infer_dtype}: calibrate again")
        dev = self.device
        tc = self._tile(tile_cfg)
        image_lr, image_hr = self._inputs(image_lr, image_hr)
        pph, ppw = self.patch_process_shape
        prh, prw = tc.patch_raw_shape
        stream, initv, chunk, n_random = self._plan(tc, cai_mode, process_num)
        if n_random:
            if random_starts is None:
                gen = generator if generator is not None else torch.Generator().manual_seed(0)
                random_starts = np.stack([random_pass_starts(gen, tc, process_num)
                                          for _ in range(n_random)])
            random_starts = np.asarray(random_starts, np.int32)
            if random_starts.shape != (n_random, process_num, 2):
                raise ValueError(f"{cai_mode} with process_num {process_num} takes random starts "
                                 f"of shape {(n_random, process_num, 2)}, got {random_starts.shape}")
        starts = stream.starts_raw
        if n_random:
            starts = np.concatenate([starts, random_starts.reshape(-1, 2)])
        if starts.min() < 0 or (starts + np.array([prh, prw]) > np.array(image_hr.shape[1:3])).any():
            raise ValueError(f"the tile plan reaches outside the {tuple(image_hr.shape[1:3])} frame")
        n = stream.starts_raw.shape[0]
        blur = torch.from_numpy(generate_blend_mask((pph, ppw), border=0.15)).to(dev)
        s_raw = torch.from_numpy(stream.starts_raw).to(dev)
        s_place = torch.from_numpy(stream.starts_process).to(dev)
        boxes = torch.from_numpy(stream.bboxes).to(dev)
        valid = torch.from_numpy((np.arange(n) < stream.n_valid).astype(np.float32)).to(dev)
        iv = None if initv is None else torch.from_numpy(initv).to(dev)
        coarse_feats, coarse_pred = self.net.coarse_forward(self._coarse_input(image_lr))
        self._check_coarse_map(coarse_pred)
        state = TileBlender.init(tc.patch_reensemble_shape, dev)
        for lo in range(0, n, chunk):
            sl = slice(lo, lo + chunk)
            imgs = self._patches(image_hr, s_raw[sl], (prh, prw))
            preds = self.net.infer_chunk(imgs, coarse_pred, coarse_feats, boxes[sl])[:, 0]
            if tuple(preds.shape[1:]) != (pph, ppw):  # patchrefinerplus.py:671-674
                preds = resize(preds[..., None], (pph, ppw), "bilinear", True)[..., 0]
            TileBlender.add_pass(state, preds, blur, s_place[sl], init_pass=iv is None,
                                 valid=valid[sl], initv=None if iv is None else iv[sl])
        if n_random:
            # rN (patchrefinerplus.py:683-700): collapse onto the raw canvas,
            # then blend each random chunk's predictions, resized back to the
            # raw patch with nearest, under the raw-size mask
            state = TileBlender.resize(state, tc.image_raw_shape)
            blur_raw = torch.from_numpy(generate_blend_mask((prh, prw), border=0.15) + 1e-3).to(dev)
            for rs in random_starts:
                s = torch.from_numpy(rs).to(dev)
                b = torch.from_numpy(random_pass_boxes(tc, rs)).to(dev)
                imgs = self._patches(image_hr, s, (prh, prw))
                preds = self.net.infer_chunk(imgs, coarse_pred, coarse_feats, b)[:, 0]
                preds = resize(preds[..., None], (prh, prw), mode="nearest")[..., 0]
                TileBlender.add_pass(state, preds, blur_raw, s)
        return TileBlender.finalize(state), to_nhwc(coarse_pred)
