"""K7: tile blending into canvases, the counterpart of
``patchrefinerv2_tpu/ops/blend.py`` (``TileBlender.add_pass`` :54,
``resize`` :103, ``finalize`` :113).

Three float32 canvases replace the reference's running-average map:
``mosaic`` (the unweighted init-pass placement, what a pure m1 run
returns), ``sum_wp`` (sum of mask-weighted predictions) and ``sum_w`` (sum
of masks). ``finalize`` is ``where(sum_w > 0, sum_wp / sum_w, mosaic)``.

Unlike the functional JAX version, :meth:`TileBlender.add_pass` updates the
canvases in place (it returns the same state), which saves copying three
canvases per chunk. On CUDA canvases it launches ``csrc/blend.cu`` (a block
per canvas tile of ``TILE`` pixels, over the patches that overlap the tile,
listed in patch order ``LIST_CAP`` at a time); on CPU canvases it runs the
plain version, a loop over the patches in order.
``TileBlender.add_pass.launches`` and ``TileBlender.finalize.launches``
count the kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patchrefinerv2_torch.ops import _cuda, _flops
from patchrefinerv2_torch.ops.resize import resize

__all__ = ["BlendState", "TileBlender", "add_pass_plain", "finalize_plain"]

TILE = (32, 128)  # the add_pass kernel's canvas tile (rows, columns)
LIST_CAP = 32  # patches a tile's list holds; more are taken in pieces


class BlendState(NamedTuple):
    mosaic: torch.Tensor  # (H, W) float32
    sum_wp: torch.Tensor
    sum_w: torch.Tensor


def add_pass_plain(state: BlendState, preds, mask, starts, valid, initv) -> BlendState:
    """Plain PyTorch version of the add_pass kernel (any device): a loop over
    the patches in order, updating the canvases in place."""
    h, w = preds.shape[1:]
    mask = mask.float()
    for k, (y, x) in enumerate(starts.to("cpu").tolist()):
        p = preds[k].float()
        m = mask * valid[k]
        state.sum_wp[y:y + h, x:x + w] += p * m
        state.sum_w[y:y + h, x:x + w] += m
        if float(initv[k]) > 0:
            state.mosaic[y:y + h, x:x + w] = p
    return state


def finalize_plain(state: BlendState) -> torch.Tensor:
    return torch.where(state.sum_w > 0,
                       state.sum_wp / torch.clamp(state.sum_w, min=1e-12), state.mosaic)


class TileBlender:
    """Namespace of blend operations over a :class:`BlendState`."""

    @staticmethod
    def init(shape, device) -> BlendState:
        return BlendState(*(torch.zeros(tuple(shape), dtype=torch.float32, device=device)
                            for _ in range(3)))

    @staticmethod
    def add_pass(state: BlendState, preds, mask, starts, init_pass: bool = False,
                 valid=None, initv=None) -> BlendState:
        """Blend ``preds`` (N, h, w) with the shared ``mask`` (h, w) at
        ``starts`` (N, 2) int32 [h, w] canvas origins. ``valid`` (N,) 0/1
        masks padded patches; ``init_pass`` makes every patch an init patch
        (mosaic write), ``initv`` (N,) 0/1 marks init patches one by one."""
        n, h, w = preds.shape
        if tuple(mask.shape) != (h, w) or tuple(starts.shape) != (n, 2):
            raise ValueError(f"expected an ({h}, {w}) mask and ({n}, 2) starts, got "
                             f"{tuple(mask.shape)}, {tuple(starts.shape)}")
        dev = state.sum_w.device
        if valid is None:
            valid = torch.ones(n, dtype=torch.float32, device=dev)
        if initv is None or init_pass:
            initv = torch.full((n,), 1.0 if init_pass else 0.0, dtype=torch.float32, device=dev)
        if tuple(valid.shape) != (n,) or tuple(initv.shape) != (n,):
            raise ValueError(f"expected ({n},) valid and init flags, got {tuple(valid.shape)}, "
                             f"{tuple(initv.shape)}")
        if _cuda.on_cpu(state.sum_w):
            return _flops.plain(add_pass_plain, state, preds, mask, starts, valid.float(),
                                initv.float())
        preds = preds.contiguous()
        mask = mask.to(device=dev, dtype=torch.float32).contiguous()
        starts = starts.to(device=dev, dtype=torch.int32).contiguous()
        valid = valid.to(device=dev, dtype=torch.float32).contiguous()
        initv = initv.to(device=dev, dtype=torch.float32).contiguous()
        _cuda.require_cuda(state.mosaic, state.sum_wp, state.sum_w, preds, mask, starts, valid, initv)
        rh, rw = state.sum_w.shape
        if rh * rw >= 2 ** 31 or n * h * w >= 2 ** 31:
            raise ValueError(f"blend add_pass indexes with 32 bits: a ({rh}, {rw}) canvas and "
                             f"({n}, {h}, {w}) predictions are too large")
        fn = _cuda.bind("blend", "prv2_blend_add", 8, 5)
        rc = fn(_cuda.ptr(state.mosaic), _cuda.ptr(state.sum_wp), _cuda.ptr(state.sum_w),
                _cuda.ptr(preds), _cuda.ptr(mask), _cuda.ptr(starts), _cuda.ptr(valid),
                _cuda.ptr(initv), n, h, w, rh, rw, _cuda.dtype_code(preds.dtype),
                _cuda.stream_of(preds))
        _cuda.check(rc, "blend add_pass")
        TileBlender.add_pass.launches += 1
        return state

    @staticmethod
    def finalize(state: BlendState) -> torch.Tensor:
        if _cuda.on_cpu(state.sum_w):
            return _flops.plain(finalize_plain, state)
        _cuda.require_cuda(state.mosaic, state.sum_wp, state.sum_w)
        out = torch.empty_like(state.sum_w)
        fn = _cuda.bind("blend", "prv2_blend_finalize", 4, 1)
        rc = fn(_cuda.ptr(state.mosaic), _cuda.ptr(state.sum_wp), _cuda.ptr(state.sum_w),
                _cuda.ptr(out), out.numel(), 0, _cuda.stream_of(out))
        _cuda.check(rc, "blend finalize")
        TileBlender.finalize.launches += 1
        return out

    @staticmethod
    def resize(state: BlendState, shape) -> BlendState:
        """Collapse and resize at the m2 -> rN boundary: the average with
        nearest, the count with bilinear align_corners=True (the reference
        quirk, blend.py:103-110). Composed of K2 and finalize."""
        avg = TileBlender.finalize(state)
        avg_r = resize(avg[None, :, :, None], shape, mode="nearest")[0, :, :, 0]
        sum_w_r = resize(state.sum_w[None, :, :, None], shape, mode="bilinear",
                         align_corners=True)[0, :, :, 0]
        return BlendState(avg_r.contiguous(), (avg_r * sum_w_r).contiguous(), sum_w_r.contiguous())


TileBlender.add_pass.launches = 0
TileBlender.finalize.launches = 0
