"""Checkpoints of the port's training: ``torch.save`` of one dict in
``work_dir/checkpoint_NN`` (the counterpart of the JAX package's orbax
directories, ``patchrefinerv2_tpu/utils/checkpoint.py``): the network's
state dict (BatchNorm statistics included), the optimizer's state, the
epoch and the step. Reading the JAX package's orbax checkpoints is not
ported.

The config's staged-training keys (``apply_config_pretrained``, the port of
``utils/checkpoint.py:58-81, 96-230``) read the port's own checkpoints:
``pretrain_coarse_model`` and ``pretrain_fine_model`` take the depth
network of a ``BaselinePretrain`` checkpoint, ``pretrained`` and
``whole_pretrained`` merge a checkpoint into the network; all by key and
shape, strict=False, running statistics included."""

from __future__ import annotations

import os

import torch

from patchrefinerv2_torch.utils.logging import print_log


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


def merge_pretrained(state: dict, pretrained: dict) -> tuple[dict, list, list]:
    """``torch``'s ``load_state_dict(strict=False)`` as the JAX package's
    ``merge_pretrained`` does it: each tensor of ``pretrained`` whose key and
    shape ``state`` has replaces it, everything else is kept. Returns (the
    merged state, the keys taken, the keys of ``pretrained`` skipped)."""
    merged, taken, skipped = dict(state), [], []
    for k, v in pretrained.items():
        if k in state and tuple(state[k].shape) == tuple(v.shape):
            merged[k] = v
            taken.append(k)
        else:
            skipped.append(k)
    return merged, taken, skipped


# where each stage-1 key puts the depth network of a BaselinePretrain
# checkpoint: the coarse branch, or PatchRefiner V1's fine depth network
STAGE1_KEYS = {"pretrain_coarse_model": "coarse_branch.", "pretrain_fine_model": "refiner_fine_branch."}
# the prefixes a BaselinePretrain checkpoint holds its network under, by target
STAGE1_PREFIXES = ("coarse_branch.", "fine_branch.")


def _stage1_network(sd: dict, key: str, path: str) -> dict:
    """The depth network's tensors of a BaselinePretrain state dict, the
    target's prefix (``coarse_branch.`` or ``fine_branch.``) taken off;
    raises when it holds neither."""
    for prefix in STAGE1_PREFIXES:
        net = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if net:
            return net
    raise ValueError(f"{key}={path} is not a BaselinePretrain checkpoint: it holds no "
                     f"{' or '.join(p + '*' for p in STAGE1_PREFIXES)} tensors")


def apply_config_pretrained(model) -> dict:
    """Honour the config's checkpoint keys on ``model`` (a
    ``PatchRefinerPlus`` or V1), strict=False, in the JAX package's order
    (patchrefinerplus.py:105-205, patchrefiner.py:129-147):

    - ``pretrain_coarse_model``: a ``BaselinePretrain`` checkpoint, its
      depth network (either target's) merged into ``coarse_branch.``;
    - ``pretrain_fine_model``: the same into PatchRefiner V1's fine depth
      network, ``refiner_fine_branch.`` (the configs point it at coarse
      stage-1 checkpoints too). This follows the reference: the JAX package
      merges the checkpoint into ``params["fine"]``, whose V1 network sits
      under ``inner``, so it takes no tensor;
    - ``pretrained``: a checkpoint of an earlier stage (the refiner's
      pretraining), merged by key and shape; with ``load_whole`` false its
      ``coarse_branch.`` tensors are dropped first;
    - ``whole_pretrained``: a checkpoint of the whole network, merged alike.

    A checkpoint is one of the port's (``state_dict`` of a training state,
    or a state dict). A missing or ``None`` path logs and keeps the random
    init. Returns, per key applied, the counts of tensors taken and kept.

    A ``PatchRefinerSemi`` recurses into its student and teacher (their
    reports under ``student.``/``teacher.``), then merges its
    ``teacher_pretrain`` checkpoint into the teacher alike
    (``patchrefinerv2_tpu/utils/checkpoint.py:118-145``). A
    ``BaselinePretrain`` reads no key, as in the JAX package (its
    ``apply_config_pretrained`` returns a model without ``config``
    unchanged): the branch's own ``pretrained`` is logged as not read."""
    if hasattr(model, "student"):
        return _apply_semi(model)
    if hasattr(model, "branch_name"):  # BaselinePretrain
        path = (model.config.get(model.branch_name) or {}).get("pretrained")
        if path:
            print_log(f"{model.branch_name}.pretrained={path} is not read: BaselinePretrain "
                      "applies no checkpoint key of its config; keeping random init")
        return {}
    cfg = model.config
    report = {}
    for key, prefix in STAGE1_KEYS.items():
        path = cfg.get(key)
        if not path:
            continue
        if not os.path.exists(path):
            print_log(f"{key}={path} not found; keeping random init")
            continue
        sd = load_checkpoint(path)
        net = _stage1_network(sd.get("state_dict", sd), key, path)
        report[key] = _merge_into(model.net, {prefix + k: v for k, v in net.items()}, key, path)
    for key in ("pretrained", "whole_pretrained"):
        path = cfg.get(key)
        if not path:
            continue
        if not os.path.exists(path):
            print_log(f"{key}={path} not found; keeping random init")
            continue
        sd = load_checkpoint(path)
        sd = sd.get("state_dict", sd)
        if key == "pretrained" and not cfg.get("load_whole", True):
            sd = {k: v for k, v in sd.items() if not k.startswith("coarse_branch.")}
        report[key] = _merge_into(model.net, sd, key, path)
    return report


def _merge_into(net, sd: dict, key: str, path: str) -> dict:
    """Merge the state dict ``sd`` into ``net`` by key and shape; returns
    and logs the counts."""
    own = net.state_dict()
    merged, taken, skipped = merge_pretrained(own, sd)
    net.load_state_dict(merged)
    print_log(f"loaded {key} from {path}: {len(taken)} tensors taken, {len(skipped)} of the "
              f"checkpoint's skipped, {len(own) - len(taken)} of the network's kept")
    return dict(taken=len(taken), skipped=len(skipped), kept=len(own) - len(taken))


def _apply_semi(model) -> dict:
    report = {}
    for who in ("student", "teacher"):
        sub = getattr(model, who)
        if sub is not None:
            report.update({f"{who}.{k}": v for k, v in apply_config_pretrained(sub).items()})
    path = model.teacher_pretrain
    if path and model.teacher is not None:
        if not os.path.exists(path):
            print_log(f"teacher_pretrain={path} not found; keeping random init")
        else:
            sd = load_checkpoint(path)
            report["teacher_pretrain"] = _merge_into(model.teacher.net, sd.get("state_dict", sd),
                                                     "teacher_pretrain", path)
    return report
