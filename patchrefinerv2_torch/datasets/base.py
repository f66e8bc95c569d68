"""Dataset base and a single-process batch loader, the port of
``patchrefinerv2_tpu/datasets/base.py`` (``DepthDataset`` :17,
``default_collate`` :59, ``DataLoader`` :72 without prefetch threads and
process sharding: batches load in the calling thread). Batches are dicts of
NHWC numpy arrays."""

from __future__ import annotations

import random
from typing import Any, Iterator

import numpy as np

from patchrefinerv2_torch.evaluation.metrics import compute_metrics


class DepthDataset:
    """The common metric / evaluate surface."""

    min_depth: float = 1e-3
    max_depth: float = 80.0
    garg_crop: bool = False
    eigen_crop: bool = False
    dataset_name: str = ""

    def get_metrics(self, depth_gt, result, disp_gt_edges=None, **kwargs) -> dict:
        return compute_metrics(
            depth_gt, result, disp_gt_edges=disp_gt_edges, min_depth_eval=self.min_depth,
            max_depth_eval=self.max_depth, garg_crop=self.garg_crop, eigen_crop=self.eigen_crop,
            dataset=self.dataset_name)

    def evaluate(self, results: list[dict]) -> dict:
        """nanmean of each metric over the images; prints the summary."""
        keys = list(results[0].keys())
        agg = {k: float(np.nanmean([r[k] for r in results if k in r])) for k in keys}
        header = " | ".join(f"{k:>8}" for k in agg)
        values = " | ".join(f"{v:8.4f}" for v in agg.values())
        print("Evaluation Summary:\n" + header + "\n" + values, flush=True)
        return agg


def default_collate(samples: list[dict]) -> dict:
    out: dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


class DataLoader:
    """Batches of ``batch_size`` samples; with ``shuffle`` the order is
    ``random.Random(seed + epoch)``'s shuffle of the indices (the JAX
    loader's, ``set_epoch`` sets the epoch); ``drop_last`` drops a short
    last batch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, drop_last: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> list[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[:len(idx) // self.batch_size * self.batch_size]
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        for i in range(0, len(idx), self.batch_size):
            yield default_collate([self.dataset[j] for j in idx[i:i + self.batch_size]])
