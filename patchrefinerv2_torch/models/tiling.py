"""Static tile planning, the port of ``patchrefinerv2_tpu/models/tiling.py``
(``TileCfg`` :28, ``regular_pass`` :65, ``_BATCH_GRANULE`` :107,
``merge_all_passes`` :171, ``random_pass_starts`` :205). Its
``crop_resize_patches`` (:229) is ``patchrefinerv2_torch.ops.resize.crop_resize``
(K2, one launch).

The plan is host-side numpy: raw-space crop starts, reensemble-canvas
placement starts and bboxes pre-normalized to the patch-process frame. The
rN random starts come from a CPU ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# the regular stream's chunk is min(process_num, _BATCH_GRANULE), as in the
# reference's merged m2 stream
_BATCH_GRANULE = 8


@dataclass(frozen=True)
class TileCfg:
    image_raw_shape: tuple[int, int]
    patch_split_num: tuple[int, int]
    patch_process_shape: tuple[int, int]

    @property
    def patch_raw_shape(self) -> tuple[int, int]:
        return (self.image_raw_shape[0] // self.patch_split_num[0],
                self.image_raw_shape[1] // self.patch_split_num[1])

    @property
    def patch_reensemble_shape(self) -> tuple[int, int]:
        return (self.patch_process_shape[0] * self.patch_split_num[0],
                self.patch_process_shape[1] * self.patch_split_num[1])


@dataclass(frozen=True)
class RegularPass:
    starts_raw: np.ndarray  # (N, 2) int32 [h, w] crop origins in raw coords
    starts_process: np.ndarray  # (N, 2) int32 placement on the reensemble canvas
    bboxes: np.ndarray  # (N, 4) float32 [x1, y1, x2, y2] in process coords
    n_valid: int  # patches before padding


def bbox_normalize_factor(tile_cfg: TileCfg) -> np.ndarray:
    rh, rw = tile_cfg.image_raw_shape
    ph, pw = tile_cfg.patch_process_shape
    return np.array([pw / rw, ph / rh, pw / rw, ph / rh], np.float32)


def regular_pass(tile_cfg: TileCfg, offset_frac: tuple[int, int], process_num: int) -> RegularPass:
    """offset_frac in {0, 1}^2: 1 = half-patch offset (the m2 shifted passes)."""
    prh, prw = tile_cfg.patch_raw_shape
    pph, ppw = tile_cfg.patch_process_shape
    irh, irw = tile_cfg.image_raw_shape
    off_h, off_w = (prh // 2) * offset_frac[0], (prw // 2) * offset_frac[1]
    off_ph, off_pw = (pph // 2) * offset_frac[0], (ppw // 2) * offset_frac[1]
    n_h, n_w = (irh - off_h) // prh, (irw - off_w) // prw
    factor = bbox_normalize_factor(tile_cfg)
    starts_raw, starts_proc, bboxes = [], [], []
    for i in range(n_h):
        for j in range(n_w):
            hs, ws = off_h + i * prh, off_w + j * prw
            starts_raw.append((hs, ws))
            starts_proc.append((off_ph + i * pph, off_pw + j * ppw))
            bboxes.append(np.array([ws, hs, ws + prw, hs + prh], np.float32) * factor)
    n_valid = len(starts_raw)
    for _ in range((-n_valid) % process_num):  # pad with repeats, masked at blend time
        starts_raw.append(starts_raw[-1])
        starts_proc.append(starts_proc[-1])
        bboxes.append(bboxes[-1])
    return RegularPass(np.asarray(starts_raw, np.int32), np.asarray(starts_proc, np.int32),
                       np.asarray(bboxes, np.float32), n_valid)


def merge_all_passes(passes: list[RegularPass], chunk: int) -> tuple[RegularPass, np.ndarray]:
    """The valid patches of all passes (the init pass first) as one stream
    padded to a multiple of ``chunk`` with repeats of the last patch, and a
    per-patch init flag (1.0 for the init pass's patches)."""
    sr = np.concatenate([p.starts_raw[: p.n_valid] for p in passes])
    sp = np.concatenate([p.starts_process[: p.n_valid] for p in passes])
    bb = np.concatenate([p.bboxes[: p.n_valid] for p in passes])
    n = sr.shape[0]
    pad = -(-n // chunk) * chunk - n
    if pad:
        sr = np.concatenate([sr, np.repeat(sr[-1:], pad, 0)])
        sp = np.concatenate([sp, np.repeat(sp[-1:], pad, 0)])
        bb = np.concatenate([bb, np.repeat(bb[-1:], pad, 0)])
    initv = np.zeros(n + pad, np.float32)
    initv[: passes[0].n_valid] = 1.0
    stream = RegularPass(np.ascontiguousarray(sr, np.int32), np.ascontiguousarray(sp, np.int32),
                         np.ascontiguousarray(bb, np.float32), n)
    return stream, initv


def random_pass_boxes(tile_cfg: TileCfg, starts: np.ndarray) -> np.ndarray:
    """(N, 4) float32 bboxes in process coords of raw patches at ``starts``
    (N, 2) [h, w]."""
    prh, prw = tile_cfg.patch_raw_shape
    h, w = starts[:, 0], starts[:, 1]
    return np.stack([w, h, w + prw, h + prh], axis=-1).astype(np.float32) * bbox_normalize_factor(tile_cfg)


def random_pass_starts(generator: torch.Generator, tile_cfg: TileCfg, process_num: int) -> np.ndarray:
    """Random crop origins (process_num, 2) int32 [h, w] of one rN iteration
    (tiling.py:205-226; their boxes are ``random_pass_boxes``). The h starts
    are drawn in ``[0, irh - prh)``; one w start is shared by every patch of
    the call (the reference quirk, baseline_pretrain.py:160-161)."""
    prh, prw = tile_cfg.patch_raw_shape
    irh, irw = tile_cfg.image_raw_shape
    h = torch.randint(0, irh - prh, (process_num,), generator=generator)
    w = torch.randint(0, irw - prw, (1,), generator=generator).expand(process_num)
    return torch.stack([h, w], dim=-1).numpy().astype(np.int32)

