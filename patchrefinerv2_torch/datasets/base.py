"""Dataset base and the batch loader, the port of
``patchrefinerv2_tpu/datasets/base.py`` (``DepthDataset`` :17,
``default_collate`` :59, ``DataLoader`` :72). Batches are dicts of NHWC
numpy arrays."""

from __future__ import annotations

import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from patchrefinerv2_torch.evaluation.metrics import compute_metrics


class DepthDataset:
    """The common metric / evaluate surface (and ``evaluate_consistency``,
    ``Tester.run_consistency``'s aggregate)."""

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

    def evaluate_consistency(self, results: list[dict]) -> dict:
        """nanmean of the images' ``consistency_error``; prints the summary."""
        err = float(np.nanmean([r["consistency_error"] for r in results]))
        print(f"Consistency Summary:\nconsistency_error\n{err:.6f}", flush=True)
        return {"consistency_error": err}


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
    """Batches of ``batch_size`` samples. With ``shuffle`` the order is
    ``random.Random(seed + epoch)``'s shuffle of the indices (``set_epoch``
    sets the epoch); ``drop_last`` drops a short last batch.

    Batches load ahead of the consumer on ``num_workers`` threads and are
    yielded in order: ``PREFETCH`` finished batches wait while every thread
    loads one more (JAX's loader keeps its ``num_prefetch`` + 1 in flight
    whatever its thread count, which leaves threads idle when
    ``num_workers`` is larger). One worker loads the batches one after the
    other, so the readers' draws from the global RNGs come in batch order;
    with more, in the order the threads take them (as in JAX's loader).
    The readers' numpy, PIL and host library calls release the GIL, so the
    threads overlap."""

    PREFETCH = 2  # JAX's default num_prefetch

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = max(1, int(num_workers))

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

    def _load(self, batch: list[int]) -> dict:
        return default_collate([self.dataset[i] for i in batch])

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="loader")
        pending: deque = deque()
        todo = iter(batches)
        try:
            for b in todo:
                pending.append(pool.submit(self._load, b))
                if len(pending) >= self.PREFETCH + self.num_workers:
                    break
            while pending:
                done = pending.popleft()
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                yield done.result()
        finally:
            # a consumer that stops early cancels what has not started and
            # waits for what has: no load outlives the iteration
            pool.shutdown(wait=True, cancel_futures=True)
