"""PatchRefinerSemi, the port of ``patchrefinerv2_tpu/models/patchrefiner_semi.py``
(``_nan_guard`` :30, ``PatchRefinerSemi`` :38-217): PatchRefiner's
real-domain transfer stage. A student (a ``PatchRefinerPlus`` or a
PatchRefiner V1) trains on the real ground truth with its own stage-3 loss
plus an edge loss against pseudo labels, which a frozen teacher of either
kind predicts online at every step, or the dataset gives offline
(``batch["pseudo_label"]``).

The network is an ``nn.Module`` with ``student`` and ``teacher`` children,
so the parameter names carry those prefixes. The JAX tree is
``{"student", "teacher"}`` likewise, and the JAX trainer's frozen prefix
``("coarse",)`` and the configs' ``lr_mult`` keys match only at the root of
the tree: under Semi they match nothing, so every leaf, the teacher's and
the student's coarse branch included, is in the optimizer at the full
learning rate, and the leaves without a gradient decay by AdamW's
``lr * wd * p``. The port's names behave the same through
``training/optim.py``.

The edge loss by the config's type: ``ScaleAndShiftInvariantLoss`` and
``ScaleAndShiftInvariantDALoss`` (an all-ones mask, the crop depths as the
gt), ``SILogLoss``, or ``EdgeguidedRankingLoss`` (its samples drawn on the
step's generator, which nothing else of a stage-3 step draws from: it
stands for JAX's ``fold_in(rng, 7)``). A non-finite loss becomes ``0 *``
the prediction's first value (``_nan_guard``). ``mix_loss`` builds the
ranking and SSI losses and, as in JAX, uses neither. What raises (ROADMAP.md,
Queue 1): ``distill=True`` and ``ScaleAndShiftInvariantUncertLoss``, which
no config sets; a DA2 student's loss raises through its own stage-3 loss.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from patchrefinerv2_torch.config import ConfigDict
from patchrefinerv2_torch.models.losses import build_loss

SSI_LOSSES = ("ScaleAndShiftInvariantLoss", "ScaleAndShiftInvariantDALoss")


def _nan_guard(loss: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """``loss``, or ``0 * anchor`` where it is nan or inf (the graph stays
    connected, as in the reference)."""
    return torch.where(torch.isfinite(loss), loss, 0.0 * anchor)


class SemiNet(nn.Module):
    """The student's network and, online, the teacher's."""

    def __init__(self, student: nn.Module, teacher: nn.Module | None):
        super().__init__()
        self.student = student
        self.teacher = teacher


class PatchRefinerSemi:
    """Config-built PatchRefinerSemi on one device (``device=None``: the
    card). ``config`` is the config's ``model`` dict: ``model_cfg_student``,
    ``model_cfg_teacher`` (None: offline), ``teacher_pretrain``,
    ``edgeloss``, ``edge_loss_weight``, ``mix_loss`` and its losses. The
    student's weights come from ``seed``, the teacher's from ``seed + 1``.
    ``batch_keys``: the batch keys the loss reads beyond the config's
    ``collect_input_args`` (offline the pseudo label, which the configs
    leave out of that list, so that the JAX trainer drops it)."""

    def __init__(self, config: dict, device=None, seed: int = 0):
        from patchrefinerv2_torch.models.patchrefiner import build_model

        cfg = ConfigDict._wrap(dict(config))
        self.config = cfg
        if cfg.get("distill", False):
            raise NotImplementedError("PatchRefinerSemi's distill loss is not ported (ROADMAP.md, Queue 1)")
        edge_cfg = cfg.get("edgeloss") or {}
        self.edgeloss_type = edge_cfg.get("type", "")
        if self.edgeloss_type not in SSI_LOSSES + ("SILogLoss", "EdgeguidedRankingLoss"):
            raise NotImplementedError(f"edge loss {self.edgeloss_type!r} is not ported (ROADMAP.md, Queue 1)")
        self.student = build_model(cfg.model_cfg_student, device=device, seed=seed)
        teacher_cfg = cfg.get("model_cfg_teacher")
        self.teacher = build_model(teacher_cfg, device=device, seed=seed + 1) if teacher_cfg else None
        self.batch_keys = () if self.teacher else ("pseudo_label",)
        self.teacher_pretrain = cfg.get("teacher_pretrain")
        self.edge_loss_weight = float(cfg.get("edge_loss_weight", 1.0))
        self.edgeloss = build_loss(edge_cfg)
        if cfg.get("mix_loss", False):  # built and unused, as in the JAX package
            self.edgeloss_ranking = build_loss(cfg.edgeloss_ranking)
            self.edgeloss_ssi = build_loss(cfg.edgeloss_ssi)
        self.device = self.student.device
        self.min_depth, self.max_depth = self.student.min_depth, self.student.max_depth
        self.patch_process_shape = self.student.patch_process_shape
        self.tile_cfg = self.student.tile_cfg
        self.pretrain_stage = False
        self.net = SemiNet(self.student.net, self.teacher.net if self.teacher else None)

    def train(self, mode: bool = True) -> "PatchRefinerSemi":
        """Train or eval mode of both networks; the teacher's forward runs
        its BatchNorm on running statistics in either."""
        self.net.train(mode)
        return self

    def eval(self) -> "PatchRefinerSemi":
        return self.train(False)

    def loss(self, batch: dict, generator: torch.Generator | None = None, update_stats: bool = False,
             edge_samples: dict | None = None):
        """(loss_dict, aux) of a training batch (``patchrefiner_semi.py:128-201``):
        the teacher's stage-3 forward under no gradient with BatchNorm on
        its running statistics, its ``depth_pred`` the pseudo label (or
        ``batch["pseudo_label"]`` (B, h, w, 1) offline); the student's
        stage-3 loss with ``update_stats``; the edge loss of the student's
        depth against the pseudo label. The dict is the student's with
        ``edge_loss`` added and ``total_loss = student total +
        edge_loss_weight * edge_loss``, both guarded against nan. The
        ranking loss draws on ``generator`` unless ``edge_samples`` (its
        ``sample``'s dict) are given. aux: the student's, with
        ``pseudo_label``."""
        if self.teacher is not None:
            with torch.no_grad():
                _, aux_t = self.teacher.loss(batch)
            pseudo = aux_t["depth_pred"].detach()
        else:
            pseudo = torch.as_tensor(batch["pseudo_label"]).to(self.device, torch.float32)
        loss_s, aux_s = self.student.loss(batch, generator, update_stats)
        pred = aux_s["depth_pred"]

        def dev(key):
            v = batch.get(key)
            return None if v is None else torch.as_tensor(v).to(self.device, torch.float32)

        if self.edgeloss_type in SSI_LOSSES:
            mask = torch.ones_like(pseudo, dtype=torch.bool)
            edge = self.edgeloss(pred, pseudo, dev("crop_depths"), mask, self.min_depth, self.max_depth)
        elif self.edgeloss_type == "SILogLoss":
            edge = self.edgeloss(pred, pseudo, self.min_depth, self.max_depth)
        else:
            edge, _ = self.edgeloss(pred, pseudo, dev("crops_image_hr"), dev("crop_depths"),
                                    generator=generator, samples=edge_samples)
        anchor = pred[0, 0, 0, 0]
        edge = _nan_guard(edge, anchor)
        loss_dict = dict(loss_s)
        loss_dict["edge_loss"] = edge
        loss_dict["total_loss"] = _nan_guard(loss_s["total_loss"], anchor) + self.edge_loss_weight * edge
        aux = dict(aux_s, pseudo_label=pseudo)
        return loss_dict, aux

    def infer(self, *args, **kwargs):
        """The student's tiled inference (``PatchRefinerPlus.infer``)."""
        return self.student.infer(*args, **kwargs)
