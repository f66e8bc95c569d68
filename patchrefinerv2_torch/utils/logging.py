"""Console logging, the port of ``patchrefinerv2_tpu/utils/logging.py``
(``print_log``, the mmengine one's counterpart)."""

from __future__ import annotations

import logging
import sys

_NAME = "patchrefinerv2_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_NAME)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def print_log(msg: str, level: int = logging.INFO) -> None:
    get_logger().log(level, msg)
