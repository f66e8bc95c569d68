"""Evaluation harness, the port of ``patchrefinerv2_tpu/evaluation/tester.py``:
``Tester.run`` (:62-114) and ``generate_pl`` (:116-128) infer every image of
a loader tiled; ``run_consistency`` (:306-407) measures how far the
overlapping crops of a consistency-mode dataset disagree; ``benchmark``
(:130-170) and ``model_complexity`` (:188-235) time a frame and count its
operations and parameters; ``show_gts`` (:172-186) and ``vis_feat``
(:237-304) write the ground truth and feature maps as images."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from patchrefinerv2_torch.ops import _flops
from patchrefinerv2_torch.ops.resize import resize
from patchrefinerv2_torch.utils.color import save_colored, save_raw_16bit
from patchrefinerv2_torch.utils.logging import print_log


# the module types whose outputs ``vis_feat`` writes (the JAX package's
# ``capture_intermediates`` filter, tester.py:266-272)
FUSION_TYPES = ("BiDirectionalFusion", "FusionUnet", "GuidedFusion", "C2FModule", "C2FNOENCModule",
                "GatedFusionBlock", "FeatureFusionBlock")
# the keys of a consistency batch that a loss may read (tester.py:365-370)
CONSISTENCY_KEYS = ("image_lr", "crops_image_hr", "crop_depths", "bboxs")


def _maps(out):
    """The 4-D tensors of a module's output, nested lists and tuples flattened."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _maps(o)]
    return [out] if isinstance(out, torch.Tensor) and out.ndim == 4 else []


class Tester:
    """``save`` writes each image's depth into ``work_dir`` as
    ``{name}.png`` (colored) and ``{name}_uint16.png`` (depth x 256). The
    colormap: ``gray_r`` with ``gray_scale`` (between the 2nd and 95th
    percentiles), ``magma_r`` on Cityscapes, otherwise ``Spectral`` (both
    over the whole range)."""

    def __init__(self, config, model, dataloader, work_dir: str = "./work_dir", save: bool = False,
                 gray_scale: bool = False):
        self.config = config
        self.model = model
        self.dataloader = dataloader
        self.work_dir = work_dir
        self.save = save
        self.gray_scale = gray_scale
        name = getattr(getattr(dataloader, "dataset", None), "dataset_name", "")
        self.cmap = "gray_r" if gray_scale else "magma_r" if name == "cityscapes" else "Spectral"

    def _name(self, batch: dict, i: int) -> str:
        return batch.get("img_file_basename", [f"img_{i:05d}"])[0]

    def _save(self, depth: np.ndarray, name: str) -> None:
        os.makedirs(self.work_dir, exist_ok=True)
        percentiles = (2, 95) if self.gray_scale else (0, 100)
        save_colored(depth, os.path.join(self.work_dir, f"{name}.png"), self.cmap, *percentiles)
        save_raw_16bit(depth, os.path.join(self.work_dir, f"{name}_uint16.png"))

    def run(self, cai_mode="m1", process_num=4, image_raw_shape=(2160, 3840),
            patch_split_num=(4, 4)) -> dict:
        """Infer every image (one CPU generator per run draws the rN starts,
        image after image), save it with ``save``, and return the dataset's
        aggregate of the per-image metrics: ``{}`` without ground truth or
        without the dataset's ``get_metrics``, the nan-mean of each metric
        without its ``evaluate``."""
        results = []
        tile_cfg = {"image_raw_shape": list(image_raw_shape),
                    "patch_split_num": list(patch_split_num)}
        dataset = getattr(self.dataloader, "dataset", None)
        generator = torch.Generator().manual_seed(0)
        for i, batch in enumerate(self.dataloader):
            depth, _ = self.model.infer(batch["image_lr"], batch["image_hr"], cai_mode=cai_mode,
                                        process_num=process_num, tile_cfg=tile_cfg,
                                        generator=generator)
            if self.save:
                self._save(depth.cpu().numpy(), self._name(batch, i))
            if "depth_gt" in batch and hasattr(dataset, "get_metrics"):
                m = dataset.get_metrics(batch["depth_gt"], depth,
                                        disp_gt_edges=batch.get("boundary"),
                                        seg_image=batch.get("seg_image"))
                if m:
                    results.append(m)
        if not results:
            return {}
        if hasattr(dataset, "evaluate"):
            return dataset.evaluate(results)
        agg = {k: float(np.nanmean([r[k] for r in results])) for k in results[0]}
        print_log("metrics: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        return agg

    def generate_pl(self, cai_mode="m1", process_num=4) -> list:
        """Infer every image at the model's own tile geometry (one CPU
        generator per run, as ``run``) and write its depth as
        ``{name}_uint16.png`` (x 256) into ``work_dir``; returns the paths
        written."""
        os.makedirs(self.work_dir, exist_ok=True)
        generator = torch.Generator().manual_seed(0)
        written = []
        for i, batch in enumerate(self.dataloader):
            depth, _ = self.model.infer(batch["image_lr"], batch["image_hr"], cai_mode=cai_mode,
                                        process_num=process_num, generator=generator)
            written.append(os.path.join(self.work_dir, f"{self._name(batch, i)}_uint16.png"))
            save_raw_16bit(depth.cpu().numpy(), written[-1])
        print_log(f"pseudo labels written to {self.work_dir}")
        return written

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def benchmark(self, image_lr, image_hr, cai_mode="r32", process_num=4, iters=50, warmup=20,
                  repeats=10, tile_cfg=None) -> dict:
        """Frames per second of the tiled inference of one frame: ``repeats``
        times ``warmup`` frames, then ``iters`` frames timed on the host's
        clock; fps is the mean of the repeats' ``iters / seconds``, beside
        their variance. A frame is one ``model.infer`` and, on the card, a
        ``torch.cuda.synchronize`` (the JAX package's ``block_until_ready``);
        each frame draws its rN starts from a new generator seeded 0 (JAX
        reuses ``PRNGKey(0)``). Writes ``benchmark.txt`` (``cai_mode``,
        ``process_num``, ``fps_mean``, ``fps_variance``) into ``work_dir``."""
        def once():
            self.model.infer(image_lr, image_hr, cai_mode=cai_mode, process_num=process_num,
                             tile_cfg=tile_cfg, generator=torch.Generator().manual_seed(0))
            self._sync()

        fps_list = []
        for _ in range(repeats):
            for _ in range(warmup):
                once()
            t0 = time.perf_counter()
            for _ in range(iters):
                once()
            fps_list.append(iters / (time.perf_counter() - t0))
        fps, var = float(np.mean(fps_list)), float(np.var(fps_list))
        print_log(f"benchmark {cai_mode}: {fps:.3f} fps (var {var:.4f})")
        os.makedirs(self.work_dir, exist_ok=True)
        with open(os.path.join(self.work_dir, "benchmark.txt"), "w") as f:
            f.write(f"cai_mode: {cai_mode}\nprocess_num: {process_num}\n")
            f.write(f"fps_mean: {fps:.6f}\nfps_variance: {var:.6f}\n")
        return {"fps": fps, "fps_variance": var}

    def show_gts(self, out_dir=None) -> str:
        """Each image's ground truth as ``{name}_gt.png`` in the Tester's
        colormap over its whole range, into ``out_dir`` (default
        ``work_dir/gts``); images without ground truth are skipped. Returns
        the directory."""
        out_dir = out_dir or os.path.join(self.work_dir, "gts")
        os.makedirs(out_dir, exist_ok=True)
        for i, batch in enumerate(self.dataloader):
            if "depth_gt" not in batch:
                continue
            save_colored(np.asarray(batch["depth_gt"]).squeeze(),
                         os.path.join(out_dir, f"{self._name(batch, i)}_gt.png"), self.cmap, 0, 100)
        print_log(f"gt visualizations written to {out_dir}")
        return out_dir

    @torch.inference_mode()
    def model_complexity(self, image_lr_shape=(1, 384, 512, 3), image_hr_shape=(1, 2160, 3840, 3),
                         cai_mode="m1", process_num=4, tile_cfg=None) -> dict:
        """``params``: the elements of the network's parameters, JAX's count
        of the ``params`` leaves (BatchNorm's running statistics are buffers
        here and ``batch_stats`` there, in neither count).

        ``flops``: the port's own count of one tiled inference of zero
        images of the given shapes (rN's starts from a generator seeded 0),
        not JAX's, which is XLA's cost analysis of the compiled program and
        has no PyTorch counterpart: ``FlopCounterMode``'s count of the aten
        convolutions, linears and matrix products (2 a multiply-add), plus
        each kernel's own count of the products it computes (``ops/_flops``:
        K3/K4's two products, K5's 1x1, K9's and K10's convolutions; the
        other kernels compute none and count 0). The kernels' plain versions
        are not counted, so the total is the same on the card and on the
        CPU. JAX's ``bytes_accessed`` (XLA's measure) is left out. The model
        runs as it is: same device, same dtype, no compilation."""
        from torch.utils.flop_counter import FlopCounterMode

        dev = self.model.device
        lr, hr = torch.zeros(image_lr_shape, device=dev), torch.zeros(image_hr_shape, device=dev)
        with _flops.counting() as kernels, FlopCounterMode(display=False) as counter:
            self.model.infer(lr, hr, cai_mode=cai_mode, process_num=process_num, tile_cfg=tile_cfg,
                             generator=torch.Generator().manual_seed(0))
        self._sync()
        flops = float(counter.get_total_flops() + sum(kernels.values()))
        params = sum(p.numel() for p in self.model.net.parameters())
        print_log(f"complexity[{cai_mode}]: {flops / 1e9:.1f} GFLOPs/frame ({kernels} in the "
                  f"kernels), {params / 1e6:.1f} M params")
        return {"flops": flops, "params": params}

    @torch.inference_mode()
    def vis_feat(self, batch: dict, out_dir=None, max_maps: int = 32) -> str:
        """Feature maps as images in ``out_dir`` (default ``work_dir/featvis``):
        the channel mean of each level of the coarse branch on
        ``batch["image_lr"]`` (``coarse_lvl{i}_mean.png``, magma), its depth
        (``coarse_pred.png``); with ``crops_image_hr`` and ``bboxs`` in the
        batch, the channel mean of every 4-D output of the modules of
        ``FUSION_TYPES`` and of the bins head's inputs (``x``, ``cond``,
        ``b_centers``: the JAX head's sown intermediates) in the training
        forward of the crops, BatchNorm on its running statistics,
        ``fusion_{module path}.png``. At most ``max_maps`` maps besides the
        depth; every hook is removed afterwards. Returns the directory."""
        net = self.model.net
        if not hasattr(net, "coarse_forward"):
            raise ValueError(f"{type(self.model).__name__} has no coarse branch to visualise")
        out_dir = out_dir or os.path.join(self.work_dir, "featvis")
        os.makedirs(out_dir, exist_ok=True)
        dt = next(net.parameters()).dtype

        def dev(key):
            return torch.as_tensor(batch[key]).to(self.model.device, dt)

        def save(f, name):
            save_colored(f[0].float().mean(0).cpu().numpy(), os.path.join(out_dir, name), "magma",
                         0, 100)

        mode = net.training
        net.eval()
        try:
            feats, pred = net.coarse_forward(dev("image_lr"))
            count = 0
            for li, f in enumerate(feats):
                save(f, f"coarse_lvl{li}_mean.png")
                count += 1
                if count >= max_maps:
                    break
            save_colored(pred[0, 0].float().cpu().numpy(), os.path.join(out_dir, "coarse_pred.png"),
                         "Spectral_r", 0, 100)
            if "crops_image_hr" in batch and "bboxs" in batch:
                captured, hooks = [], []

                def output(name):
                    return lambda module, args, out: captured.append((name, out))

                def bins_inputs(name):
                    return lambda module, args: captured.extend(
                        (f"{name}_{k}", a) for k, a in zip(("x", "cond", "b_centers"), args))

                try:
                    for name, m in net.named_modules():
                        path = name.replace(".", "_")
                        if type(m).__name__ in FUSION_TYPES:
                            hooks.append(m.register_forward_hook(output(path)))
                        elif type(m).__name__ == "ConditionalLogBinomial":
                            hooks.append(m.register_forward_pre_hook(bins_inputs(path)))
                    bboxes = torch.as_tensor(batch["bboxs"]).to(self.model.device, torch.float32)
                    net.train_forward(dev("image_lr"), dev("crops_image_hr"), bboxes)
                finally:
                    for h in hooks:
                        h.remove()
                for name, out in captured:
                    for f in _maps(out):
                        if count >= max_maps:
                            break
                        save(f, f"fusion_{name}.png")
                        count += 1
        finally:
            net.train(mode)
        print_log(f"feature maps written to {out_dir}")
        return out_dir

    def _check_consistency_model(self) -> None:
        """Raise a ``ValueError`` for a model whose loss reads a key that a
        consistency batch does not carry (where the JAX package fails on the
        missing key, or for the pretraining stage on its train-mode
        BatchNorm first): the pretraining stage's and the coarse
        ``BaselinePretrain``'s ``depth_gt``, the offline Semi model's
        ``pseudo_label``."""
        m, kind = self.model, type(self.model).__name__
        if getattr(m, "pretrain_stage", False):
            reads = ("depth_gt (its pretraining stage trains the refiner on the whole frame, its "
                     "BatchNorm in train mode)")
        elif getattr(m, "target", None) == "coarse":
            reads = "depth_gt (the coarse target trains on the whole frame)"
        else:
            extra = [k for k in getattr(m, "batch_keys", ()) if k not in CONSISTENCY_KEYS]
            reads = f"{extra} (its offline pseudo label)" if extra else None
        if reads:
            raise ValueError(f"run_consistency runs the model's loss on the crops of a consistency "
                             f"batch ({', '.join(CONSISTENCY_KEYS)}); {kind}'s loss reads {reads}")

    def _check_consistency_input(self, image_lr) -> None:
        """A Depth-Anything-V2 coarse branch takes ``image_lr`` as the loader
        gives it (the loss does not resize it, as in the JAX package), and
        DINOv2 takes sides that are multiples of 14."""
        h, w = image_lr.shape[1:3]
        if getattr(self.model, "resizer_da", False) and (h % 14 or w % 14):
            raise ValueError(
                f"{type(self.model).__name__} with a Depth-Anything-V2 coarse branch runs the loss on "
                f"image_lr as the loader gives it, and DINOv2 takes sides that are multiples of 14: "
                f"got {(h, w)}; set the consistency loader's transform_cfg.network_process_size to "
                "multiples of 14, e.g. [448, 448]")

    @torch.inference_mode()
    def run_consistency(self, process_num=4, overlap=None) -> dict:
        """Patch-overlap consistency (the reference's tester.py:212-321) over
        a consistency-mode dataset (``consistency=True``: a fixed grid of
        overlapping crops, ``h_start_list`` x ``w_start_list``). The crops of
        each image run in chunks of ``process_num`` (its largest divisor of
        the crop count at most ``process_num``) through the model's training
        forward without statistics updates (``loss(batch,
        update_stats=False)``: BatchNorm on its running statistics), each
        beside the image's ``image_lr``; each crop's depth is resized
        (bilinear, align corners, K2) to ``patch_raw_shape``, and the image's
        error is the mean absolute difference over the ``overlap``-pixel
        strips that each crop shares with its upper and left neighbours.
        ``save`` writes the mosaic of the crops' centres as ``{name}.png``.
        Returns ``{"consistency": e, "consistency_error": e}``, ``e`` the
        dataset's ``evaluate_consistency`` of the images' errors."""
        dataset = getattr(self.dataloader, "dataset", None)
        if not hasattr(dataset, "h_start_list") or not hasattr(dataset, "evaluate_consistency"):
            raise ValueError(
                "run_consistency needs a consistency-mode dataset (consistency=True, e.g. "
                f"UnrealStereo4k) with its fixed grid of overlapping crops; {type(dataset).__name__} "
                "is not one (set the loader's dataset.consistency=True)")
        self._check_consistency_model()
        h_starts, w_starts = list(dataset.h_start_list), list(dataset.w_start_list)
        ph, pw = (int(s) for s in dataset.patch_raw_shape)
        ov = int(overlap if overlap is not None else getattr(dataset, "overlap", 270))
        half = ov // 2
        n_crops = len(h_starts) * len(w_starts)
        chunk = max(1, min(int(process_num), n_crops))
        while n_crops % chunk:
            chunk -= 1
        results = []
        for i, batch in enumerate(self.dataloader):
            self._check_consistency_input(batch["image_lr"])
            lr = np.repeat(np.asarray(batch["image_lr"][:1]), chunk, axis=0)
            preds = []
            for s in range(0, n_crops, chunk):
                sub = {"image_lr": lr, **{k: batch[k][0, s:s + chunk] for k in CONSISTENCY_KEYS[1:]}}
                _, aux = self.model.loss(sub, update_stats=False)
                depth = resize(aux["depth_pred"].float(), (ph, pw), "bilinear", True)
                preds.extend(depth[..., 0].cpu().numpy())
            # the upper and left neighbours' strips (tester.py:246-301): the
            # crop before in the row, the crop one row up; the corner has none
            mosaic = np.zeros(tuple(dataset.image_raw_shape), np.float32)
            errs = []
            for ii, x in enumerate(h_starts):
                for jj, y in enumerate(w_starts):
                    k = ii * len(w_starts) + jj
                    cur = preds[k]
                    mosaic[x + half:x + ph - half, y + half:y + pw - half] = \
                        cur[half:ph - half, half:pw - half]
                    if ii > 0:
                        errs.append(np.abs(preds[k - len(w_starts)][-ov:, :] - cur[:ov, :]).ravel())
                    if jj > 0:
                        errs.append(np.abs(preds[k - 1][:, -ov:] - cur[:, :ov]).ravel())
            results.append({"consistency_error": float(np.concatenate(errs).mean())})
            if self.save:
                os.makedirs(self.work_dir, exist_ok=True)
                name = batch.get("img_file_basename", ["consistency"])[0]
                save_colored(mosaic, os.path.join(self.work_dir, f"{name}.png"), self.cmap, 0, 100)
        ret = dataset.evaluate_consistency(results)
        return {"consistency": float(ret["consistency_error"]), **ret}
