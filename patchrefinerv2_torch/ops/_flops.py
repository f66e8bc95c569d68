"""The kernels' own operation counts, for ``Tester.model_complexity``.

``torch.utils.flop_counter.FlopCounterMode`` counts the products that it
sees dispatched as aten ops (convolutions, linears, matrix products), 2 a
multiply-add. A kernel's launch is a ``ctypes`` call that it does not see,
and on the CPU a wrapper runs its plain version, whose aten ops it would
see. So while :func:`counting` is on, each wrapper whose kernel computes a
product adds that function's own count from its shapes, once, on either
route (:func:`add`): K3/K4's two products, K5's bias-free 1x1 and the
convolutions of K9 and K10. The plain versions run hidden from the counter
(:func:`plain`), and a wrapper that a plain version calls adds nothing, so
the total does not depend on the device. The kernels that compute no
product (K1, K2, K6, K7, K8, K11, K12) add nothing.
"""

from __future__ import annotations

import contextlib

_counts: dict | None = None  # kernel name -> operations, while counting
_hidden = 0  # the depth of plain versions running now


@contextlib.contextmanager
def counting():
    """Collect the kernels' counts into the dict it yields."""
    global _counts
    _counts = {}
    try:
        yield _counts
    finally:
        _counts = None


def add(name: str, operations: int) -> None:
    """Count ``operations`` for the kernel ``name``, unless a plain version
    is running (it is counted by its own wrapper's count) or nothing counts."""
    if _counts is not None and not _hidden:
        _counts[name] = _counts.get(name, 0) + int(operations)


def conv(n: int, h: int, w: int, cout: int, cin: int, k: int) -> int:
    """A stride-1 SAME k x k convolution's count: 2 a multiply-add."""
    return 2 * n * h * w * cout * cin * k * k


def plain(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; while counting, with every dispatch mode
    (the flop counter's) off, so that its aten ops are not counted."""
    global _hidden
    if _counts is None:
        return fn(*args, **kwargs)
    from torch.utils._python_dispatch import _disable_current_modes

    _hidden += 1
    try:
        with _disable_current_modes():
            return fn(*args, **kwargs)
    finally:
        _hidden -= 1
