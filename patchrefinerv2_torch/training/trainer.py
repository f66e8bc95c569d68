"""Trainer on one device, the port of
``patchrefinerv2_tpu/training/trainer.py`` (``Trainer`` :53-133, the train
step :148-171, ``_log_train_images`` :173-193, ``train_epoch`` :195-238,
``val_epoch`` and ``_default_val_evaluator`` :240-335, ``save`` :337-355,
``_resume`` :357-374, ``run`` :376-394).

A step: the model's loss in train mode with its BatchNorm statistics
updated once, ``backward``, then the optimizer of ``training/optim.py``.
The hacked coarse features of the pretraining stage are drawn from a
generator on the model's device seeded ``seed + 1``; like the JAX package's
``_rng`` it is not checkpointed, so a resumed run draws other features than
an uninterrupted one. Checkpoints hold the network's state (BatchNorm
statistics included), the optimizer's state, the epoch and the step. The
model's config may name checkpoints of earlier stages (``pretrained``,
``whole_pretrained``), merged into the network before the optimizer is
built (``utils/checkpoint.apply_config_pretrained``); a resume then
restores over them.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from patchrefinerv2_torch.training.optim import build_optimizer
from patchrefinerv2_torch.utils.checkpoint import (
    apply_config_pretrained, load_checkpoint, save_checkpoint,
)
from patchrefinerv2_torch.utils.logging import print_log
from patchrefinerv2_torch.utils.metrics_logger import MetricsLogger


class Trainer:
    def __init__(self, config, model, train_loader, val_loader=None,
                 val_evaluator: Callable | None = None, work_dir: str = "./work_dir"):
        self.config = config
        self.model = model
        self.device = model.device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.val_evaluator = val_evaluator
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        tc = config.get("train_cfg", {})
        self.max_epochs = int(tc.get("max_epochs", 24))
        self.val_interval = int(tc.get("val_interval", 2))
        self.val_type = tc.get("val_type", "epoch_base")
        self.eval_start = int(tc.get("eval_start", 0))
        self.early_stop_epoch = int(tc.get("early_stop_epoch", -1))
        self.save_interval = int(tc.get("save_checkpoint_interval", self.max_epochs))
        self.log_interval = int(tc.get("log_interval", 100))
        self.train_log_img_interval = int(tc.get("train_log_img_interval", 0))
        self.val_log_img_interval = int(tc.get("val_log_img_interval", 0))
        self.min_depth = float(config.get("min_depth", 1e-3))
        self.max_depth = float(config.get("max_depth", 80))

        total_steps = self.max_epochs * len(train_loader)
        # the config's checkpoints of earlier stages (patchrefinerplus.py:105-205)
        self.pretrained_report = apply_config_pretrained(model)
        mcfg = model.config
        frozen = ("coarse_branch",) if not (mcfg.get("e2e_training", False)
                                            or model.pretrain_stage) else ()
        self.optimizer, self.lr_schedule = build_optimizer(
            config.get("optim_wrapper", {}), config.get("param_scheduler", {}), total_steps,
            model.net.named_parameters(), frozen_prefixes=frozen)
        self.step = 0
        self.start_epoch = 1
        resume = config.get("resume_from")
        if resume:
            self._resume(resume)
        if self.val_loader is not None and self.val_evaluator is None:
            self.val_evaluator = self._default_val_evaluator()
        self.generator = torch.Generator(device=self.device).manual_seed(int(config.get("seed", 0)) + 1)
        self.metrics = MetricsLogger(work_dir)
        print_log(f"trainer on {self.device}: {total_steps} steps, float32 matmul TF32 "
                  f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 {torch.backends.cudnn.allow_tf32}")

    def device_batch(self, batch: dict) -> dict:
        """The config's ``collect_input_args`` of a loader batch, on the device."""
        collect = self.config.get("collect_input_args")
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()
                if isinstance(v, np.ndarray | torch.Tensor) and (not collect or k in collect)}

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a device batch; returns the (device) losses."""
        for p in self.model.net.parameters():
            p.grad = None
        loss_dict, _ = self.model.loss(batch, generator=self.generator, update_stats=True)
        loss_dict["total_loss"].backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    def _log_train_images(self, batch: dict) -> None:
        """A training image panel from one more forward at the updated
        weights, without updating the BatchNorm statistics: in the
        pretraining stage the model's loss raises there (train-mode
        BatchNorm must update), as the JAX package's non-mutable
        ``loss_jit`` does."""
        with torch.no_grad():
            _, aux = self.model.loss(batch)
        self.metrics.log_images(
            {"rgb": batch.get("crops_image_hr", batch.get("image_lr")), "depth_pred": aux["depth_pred"],
             "depth_gt": batch.get("crop_depths", batch.get("depth_gt"))},
            prefix="Train", min_depth=self.min_depth, max_depth=self.max_depth, step=self.step)

    def train_epoch(self, epoch: int) -> None:
        self.model.train()
        t0 = time.time()
        n = len(self.train_loader)
        for i, batch in enumerate(self.train_loader):
            batch = self.device_batch(batch)
            loss_dict = self.train_step(batch)
            if i % self.log_interval == 0:
                lr = float(self.lr_schedule(self.step))
                losses = {k: float(v) for k, v in loss_dict.items()}
                ips = (i + 1) * next(iter(batch.values())).shape[0] / (time.time() - t0)
                print_log(f"epoch {epoch} step {i}/{n} lr {lr:.2e} img/s {ips:.1f} "
                          + " ".join(f"{k}={v:.4f}" for k, v in losses.items()))
                if not np.isfinite(losses.get("total_loss", 0.0)):
                    print_log(f"WARNING: non-finite total_loss at step {self.step}: {losses}")
                self.metrics.log({"lr": lr, "imgs_per_sec": ips, **losses}, self.step)
            if self.train_log_img_interval > 0 and (i + 1) % self.train_log_img_interval == 0:
                self._log_train_images(batch)
            if self.val_type == "iter_base" and self.val_loader is not None \
                    and self.step % self.val_interval == 0:
                self.val_epoch()
                self.model.train()

    def _default_val_evaluator(self):
        """m1 tiled inference of each validation image and the dataset's
        metrics (reference val_epoch, trainer.py:152-178); returns (metrics,
        depth). The pretraining stage has no coarse branch: its ``infer``
        raises, as the JAX package's fails there."""
        tc = self.config.get("train_cfg", {})
        cai_mode = tc.get("val_cai_mode", "m1")
        process_num = int(tc.get("val_process_num", 4))
        dataset = getattr(self.val_loader, "dataset", None)

        def evaluate(model, batch):
            if "image_hr" not in batch or "depth_gt" not in batch:
                return None
            hr = np.asarray(batch["image_hr"])
            tile_cfg = {"image_raw_shape": list(hr.shape[1:3]),
                        "patch_split_num": list(model.tile_cfg.patch_split_num)}
            depth, _ = model.infer(batch["image_lr"], hr, cai_mode=cai_mode,
                                   process_num=process_num, tile_cfg=tile_cfg)
            depth = depth.cpu().numpy()
            if dataset is None or not hasattr(dataset, "get_metrics"):
                return None
            return dataset.get_metrics(np.asarray(batch["depth_gt"]), depth,
                                       disp_gt_edges=batch.get("boundary"),
                                       seg_image=batch.get("seg_image")), depth

        return evaluate

    def val_epoch(self) -> dict:
        if self.val_loader is None or self.val_evaluator is None:
            return {}
        self.model.eval()
        self._val_count = getattr(self, "_val_count", 0)
        metrics = []
        for idx, batch in enumerate(self.val_loader):
            out = self.val_evaluator(self.model, batch)
            depth_pred = None
            if isinstance(out, tuple):
                out, depth_pred = out
            if out is not None:
                metrics.append(out)
            self._val_count += 1
            if depth_pred is not None and self.val_log_img_interval > 0 \
                    and (idx + 1) % self.val_log_img_interval == 0:
                self.metrics.log_images(
                    {"rgb": batch.get("image_hr"), "depth_pred": depth_pred,
                     "depth_gt": batch.get("depth_gt")},
                    prefix="Val", min_depth=self.min_depth, max_depth=self.max_depth,
                    step=self._val_count)
        if not metrics:
            return {}
        dataset = getattr(self.val_loader, "dataset", None)
        if dataset is not None and hasattr(dataset, "evaluate"):
            agg = {k: float(v) for k, v in dataset.evaluate(metrics).items()}
        else:
            agg = {k: float(np.nanmean([m[k] for m in metrics])) for k in metrics[0]
                   if np.ndim(metrics[0][k]) == 0}
        print_log("val: " + " ".join(f"Val/{k}={v:.4f}" for k, v in agg.items()))
        self.metrics.log({f"Val/{k}": v for k, v in agg.items()}, self.step)
        return agg

    def state(self, epoch: int) -> dict:
        return {"state_dict": self.model.net.state_dict(), "optimizer": self.optimizer.state_dict(),
                "epoch": epoch, "step": self.step}

    def save(self, epoch: int) -> str:
        path = os.path.join(self.work_dir, f"checkpoint_{epoch:02d}")
        save_checkpoint(path, self.state(epoch))
        print_log(f"saved checkpoint to {path}")
        return path

    def _resume(self, path: str) -> None:
        """Restore the network, the optimizer, the step and the epoch."""
        ckpt = load_checkpoint(path, map_location=self.device)
        self.model.net.load_state_dict(ckpt["state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = int(ckpt["step"])
        self.start_epoch = int(ckpt["epoch"]) + 1
        print_log(f"resumed from {path} at epoch {self.start_epoch} step {self.step}")

    def run(self) -> None:
        for epoch in range(self.start_epoch, self.max_epochs + 1):
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)
            self.train_epoch(epoch)
            if self.val_type == "epoch_base" and epoch >= self.eval_start \
                    and epoch % self.val_interval == 0:
                self.val_epoch()
            if epoch % self.save_interval == 0 or epoch == self.max_epochs:
                self.save(epoch)
            if self.early_stop_epoch > 0 and epoch >= self.early_stop_epoch:
                print_log(f"early stop at epoch {epoch}")
                break
