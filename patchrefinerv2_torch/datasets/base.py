"""Dataset base and a single-process batch loader, the port of
``patchrefinerv2_tpu/datasets/base.py`` (``DepthDataset`` :17,
``default_collate`` :59, ``DataLoader`` :72 with batches of 1 and without
shuffling, prefetch threads and process sharding). Batches are dicts of NHWC
numpy arrays."""

from __future__ import annotations

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
    """One collated sample (a batch of 1) per step, loaded in the calling
    thread: ``PatchRefinerPlus.infer`` tiles one frame at a time."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self.dataset)):
            yield default_collate([self.dataset[i]])
