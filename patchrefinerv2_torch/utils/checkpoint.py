"""Checkpoints of the port's training: ``torch.save`` of one dict in
``work_dir/checkpoint_NN`` (the counterpart of the JAX package's orbax
directories, ``patchrefinerv2_tpu/utils/checkpoint.py``): the network's
state dict (BatchNorm statistics included), the optimizer's state, the
epoch and the step. Reading the JAX package's orbax checkpoints is not
ported."""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` (tensors moved to the CPU) to ``path``, atomically."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x
