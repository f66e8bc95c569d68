"""PatchRefinerV2 in PyTorch with hand-written Hopper kernels.

The port of ``patchrefinerv2_tpu`` (the JAX reference, which this package
never imports). Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when there is none (no silent CPU
    fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)
