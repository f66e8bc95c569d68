"""PatchRefiner V1, the port of ``patchrefinerv2_tpu/models/patchrefiner.py``
(``ZoeFineBranch`` :23, ``PatchRefiner`` :35): a frozen coarse depth network,
a second whole depth network of the same kind run on every patch as the
fine branch, and the FusionUnet offset head
(``configs/patchrefiner_zoedepth/``, ``configs/patchrefiner_dav2/``).

It is :class:`PatchRefinerPlus` with ``PRPlusNet``'s V1 graph
(``PRPlusNet(cfg, v1=True)``): the tiled inference, the weights' layout
(``refiner_fine_branch`` holds the fine network under the reference's
keys) and the stage-3 loss are PatchRefinerPlus's. The JAX class builds
its parent around a placeholder ``mobilenetv3_large_100`` refiner and
swaps it out; the port builds the fine network directly.

Per chunk the fine branch runs the coarse branch's kernels at the chunk's
batch: K3 (BEiT) or K4 (DINOv2) attention, K6, K2 in the DPT neck, K8
(ZoeDepth); FusionUnet adds K2, K6 and K9 (``FusionUnet.kernel_calls``).

Training is SILog (``sigweight`` 1) with the GradMatch term still computed,
the coarse branch under no gradient and frozen; a ZoeDepth fine network
trains through K3's, K8's and K2's backwards, a DA2 one through K4's, K6's
and the bicubic K2's of its position embedding. With DA2 branches the
Depth-Anything resizer applies as in PatchRefinerPlus. What raises: the
int8 serving mode (the JAX package's would also quantize the fine
network's convolutions, sites the port does not have).
"""

from __future__ import annotations

from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus


class PatchRefiner(PatchRefinerPlus):
    """Config-built PatchRefiner V1 on one device (``device=None``: the
    card). PatchRefinerPlus's config defaults are the JAX class's: no
    pretraining stage, ``e2e_training`` off (the coarse branch frozen),
    ``sigweight`` 1 and a GradMatch ``gmloss``. Its loss is
    PatchRefinerPlus's stage-3 loss (``patchrefinerplus.py:519-556``): SILog
    and GradMatch of the fine depth (a ZoeDepth or a DA2 fine network on the
    crops) against ``crop_depths``, the coarse branch under no gradient."""

    v1 = True

    def calibrate_int8(self, *args, **kwargs):
        raise NotImplementedError(_NO_INT8)

    def set_int8(self, *args, **kwargs) -> None:
        raise NotImplementedError(_NO_INT8)


_NO_INT8 = ("PatchRefiner V1's int8 mode is not ported: the JAX package's would also quantize the "
            "fine depth network's DPT convolutions (conv_dispatch in blocks/dpt.py and "
            "blocks/convs.py), sites the port does not have")

MODELS = {"PatchRefinerPlus": PatchRefinerPlus, "PatchRefiner": PatchRefiner}


def build_model(model_cfg, device=None, seed: int = 0):
    """The model a config's ``model`` names (``type``, default
    ``PatchRefinerPlus``, and ``config``; ``PatchRefinerSemi`` and
    ``BaselinePretrain`` take the whole dict), random weights from ``seed``,
    on ``device`` (``None``: the card). Other types raise."""
    kind = model_cfg.get("type", "PatchRefinerPlus")
    if kind == "PatchRefinerSemi":
        from patchrefinerv2_torch.models.patchrefiner_semi import PatchRefinerSemi

        return PatchRefinerSemi(model_cfg, device=device, seed=seed)
    if kind == "BaselinePretrain":
        from patchrefinerv2_torch.models.baseline_pretrain import BaselinePretrain

        return BaselinePretrain(model_cfg, device=device, seed=seed)
    if kind not in MODELS:
        raise NotImplementedError(f"model {kind!r} is not ported ({', '.join(MODELS)}, "
                                  "PatchRefinerSemi and BaselinePretrain are)")
    return MODELS[kind](model_cfg["config"], device=device, seed=seed)
