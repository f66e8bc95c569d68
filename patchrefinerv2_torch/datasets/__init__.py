"""Datasets: the metric surface (``DepthDataset``, the Cityscapes metrics),
the synthetic frames and a single-process loader."""
