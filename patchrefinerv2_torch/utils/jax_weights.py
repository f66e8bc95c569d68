"""Load the JAX package's variables into the port.

``load_jax_params(model, variables)`` takes the ``{"params", "batch_stats"}``
tree of the JAX ``PRPlusNet`` (as numpy arrays; PatchRefinerPlus's or
PatchRefiner V1's; ``part="PatchRefinerSemi"``: the student's and the
teacher's under ``{"student", "teacher"}``) and writes it into the port's
modules, whose parameter names are the reference's torch state-dict
keys. It is the inverse of the JAX package's checkpoint converter
(``convert_patchrefinerplus``): a conv kernel (kh, kw, I, O) becomes
(O, I, kh, kw), a dense kernel (I, O) becomes (O, I), a transposed-conv
kernel is flipped back spatially to (I, O, kh, kw), LayerNorm/BatchNorm
``scale`` becomes ``weight`` and the BatchNorm ``mean``/``var`` statistics
become ``running_mean``/``running_var``.

``load_jax_int8(model, variables)`` turns the JAX calibration (the
``quant_scales`` and ``quant_kq`` collections that the JAX
``calibrate_int8`` adds) into the port's ``Int8Calibration``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from patchrefinerv2_torch.models.int8 import MIN_HW, MIN_KC, Int8Calibration, sites_of

__all__ = ["load_jax_params", "jax_to_state_dict", "load_jax_int8"]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class _SD(dict):
    """The state dict being filled; ``nodes`` keeps the JAX params node of
    each conv by its port module name."""

    def __init__(self):
        super().__init__()
        self.nodes = {}

    def conv(self, key, node):
        self.nodes[key] = node
        self[key + ".weight"] = np.transpose(_a(node["kernel"]), (3, 2, 0, 1))
        if "bias" in node:
            self[key + ".bias"] = _a(node["bias"])

    def conv_t(self, key, node):
        self[key + ".weight"] = np.transpose(_a(node["kernel"])[::-1, ::-1], (2, 3, 0, 1))
        self[key + ".bias"] = _a(node["bias"])

    def linear(self, key, node):
        self[key + ".weight"] = _a(node["kernel"]).T
        if "bias" in node:
            self[key + ".bias"] = _a(node["bias"])

    def norm(self, key, node):
        self[key + ".weight"] = _a(node["scale"])
        self[key + ".bias"] = _a(node["bias"])

    def bn(self, key, params, stats):
        self.norm(key, params["BatchNorm_0"])
        self[key + ".running_mean"] = _a(stats["BatchNorm_0"]["mean"])
        self[key + ".running_var"] = _a(stats["BatchNorm_0"]["var"])


def _dpt_scratch(sd: _SD, s: str, P) -> None:
    """layer{k}_rn and the FeatureFusionBlocks refinenet{k} of a 4-level DPT
    decoder; refinenet4 has one input, so only its second unit."""
    for k in range(1, 5):
        sd.conv(f"{s}layer{k}_rn", P[f"layer{k}_rn"])
        _ffb(sd, f"{s}refinenet{k}", P[f"refinenet{k}"], single=k == 4)


def _ffb(sd: _SD, base: str, node, single: bool) -> None:
    """A FeatureFusionBlock: with one input only its second unit."""
    units = ("resConfUnit2",) if single else ("resConfUnit1", "resConfUnit2")
    for ui, unit in enumerate(units):
        rcu = node[f"ResidualConvUnit_{ui}"]
        sd.conv(f"{base}.{unit}.conv1", rcu["Conv_0"])
        sd.conv(f"{base}.{unit}.conv2", rcu["Conv_1"])
    sd.conv(base + ".out_conv", node["Conv_0"])


def _refiner_decoder(sd: _SD, s: str, P) -> None:
    """The refiner's SimpleDPTHead (``with_decoder``): Scratch projections,
    refinenet5 (one input) .. refinenet1 and the three output convs."""
    for k in range(1, 6):
        sd.conv(f"{s}layer{k}_rn", P["Scratch_0"][f"layer{k}_rn"])
        _ffb(sd, f"{s}refinenet{k}", P[f"refinenet{k}"], single=k == 5)
    sd.conv(s + "output_conv1", P["output_conv1"])
    sd.conv(s + "output_conv2.0", P["output_conv2"])
    sd.conv(s + "output_conv3.0", P["output_conv3"])


def _beit_midas(sd: _SD, p: str, P) -> None:
    t = p + "pretrained.model."
    tr = P["pretrained"]
    sd[t + "cls_token"] = _a(tr["cls_token"])
    sd.conv(t + "patch_embed.proj", tr["patch_embed"])
    for name, blk in tr.items():
        m = re.fullmatch(r"block(\d+)", name)
        if not m:
            continue
        b = f"{t}blocks.{m.group(1)}."
        sd[b + "gamma_1"], sd[b + "gamma_2"] = _a(blk["gamma_1"]), _a(blk["gamma_2"])
        sd.norm(b + "norm1", blk["norm1"])
        sd.norm(b + "norm2", blk["norm2"])
        at = blk["attn"]
        sd.linear(b + "attn.qkv", at["qkv"])
        for k in ("q_bias", "v_bias", "relative_position_bias_table"):
            sd[b + "attn." + k] = _a(at[k])
        sd.linear(b + "attn.proj", at["proj"])
        sd.linear(b + "mlp.fc1", blk["fc1"])
        sd.linear(b + "mlp.fc2", blk["fc2"])
    for i in range(4):
        ap = f"{p}pretrained.act_postprocess{i + 1}."
        sd.linear(ap + "0.project.0", P[f"readout{i}"])
        sd.conv(ap + "3", P[f"project{i}"])
    sd.conv_t(p + "pretrained.act_postprocess1.4", P["resize0"])
    sd.conv_t(p + "pretrained.act_postprocess2.4", P["resize1"])
    sd.conv(p + "pretrained.act_postprocess4.4", P["resize3"])
    _dpt_scratch(sd, p + "scratch.", P)
    sd.conv(p + "scratch.output_conv.0", P["output_conv1"])
    sd.conv(p + "scratch.output_conv.2", P["output_conv2_0"])
    sd.conv(p + "scratch.output_conv.4", P["output_conv2_1"])


def _dino_vit(sd: _SD, p: str, P) -> None:
    sd[p + "cls_token"] = _a(P["cls_token"])
    sd[p + "pos_embed"] = _a(P["pos_embed"])
    sd.conv(p + "patch_embed.proj", P["patch_embed"])
    for name, blk in P.items():
        m = re.fullmatch(r"block(\d+)", name)
        if not m:
            continue
        b = f"{p}blocks.{m.group(1)}."
        sd.norm(b + "norm1", blk["norm1"])
        sd.norm(b + "norm2", blk["norm2"])
        sd.linear(b + "attn.qkv", blk["attn"]["qkv"])
        sd.linear(b + "attn.proj", blk["attn"]["proj"])
        sd[b + "ls1.gamma"] = _a(blk["ls1"]["gamma"])
        sd[b + "ls2.gamma"] = _a(blk["ls2"]["gamma"])
        sd.linear(b + "mlp.fc1", blk["mlp"]["fc1"])
        sd.linear(b + "mlp.fc2", blk["mlp"]["fc2"])
    sd.norm(p + "norm", P["norm"])


def _da2_head(sd: _SD, p: str, P) -> None:
    for i in range(4):
        sd.conv(f"{p}projects.{i}", P[f"project{i}"])
    sd.conv_t(p + "resize_layers.0", P["resize0"])
    sd.conv_t(p + "resize_layers.1", P["resize1"])
    sd.conv(p + "resize_layers.3", P["resize3"])
    _dpt_scratch(sd, p + "scratch.", P)
    sd.conv(p + "scratch.output_conv1", P["output_conv1"])
    sd.conv(p + "scratch.output_conv2.0", P["output_conv2_0"])
    sd.conv(p + "scratch.output_conv2.2", P["output_conv2_1"])


def _da2(sd: _SD, p: str, P) -> None:
    _dino_vit(sd, p + "pretrained.", P["pretrained"])
    _da2_head(sd, p + "depth_head.", P["depth_head"])


def _zoe_head(sd: _SD, p: str, P) -> None:
    sd.conv(p + "conv2", P["conv2"])

    def seq(key, node):
        sd.conv(key + "._net.0", node["Conv_0"])
        sd.conv(key + "._net.2", node["Conv_1"])

    seq(p + "seed_bin_regressor", P["seed_bin_regressor"])
    seq(p + "seed_projector", P["seed_projector"])
    i = 0
    while f"projector{i}" in P:
        seq(f"{p}projectors.{i}", P[f"projector{i}"])
        seq(f"{p}attractors.{i}", P[f"attractor{i}"])
        i += 1
    sd.conv(p + "conditional_log_binomial.mlp.0", P["conditional_log_binomial"]["Conv_0"])
    sd.conv(p + "conditional_log_binomial.mlp.2", P["conditional_log_binomial"]["Conv_1"])


def _effnet(sd: _SD, p: str, P, S) -> None:
    sd.conv(p + "conv_stem", P["conv_stem"])
    sd.bn(p + "bn1", P["bn_stem"], S["bn_stem"])
    for name, node in P.items():
        m = re.fullmatch(r"blocks_(\d+)_(\d+)", name)
        if not m:
            continue
        b = f"{p}blocks.{m.group(1)}.{m.group(2)}."
        _mbconv(sd, b, node, S[name])


def _mbconv(sd: _SD, b: str, node, st) -> None:
    """An MBConv: the port's InvertedResidual, or DepthwiseSeparable when
    it has no expansion (``conv_pw``)."""
    if "conv_pw" in node:  # inverted residual
        sd.conv(b + "conv_pw", node["conv_pw"])
        sd.bn(b + "bn1", node["bn1"], st["bn1"])
        sd.conv(b + "conv_dw", node["conv_dw"])
        sd.bn(b + "bn2", node["bn2"], st["bn2"])
        sd.conv(b + "conv_pwl", node["conv_pwl"])
        sd.bn(b + "bn3", node["bn3"], st["bn3"])
    else:  # depthwise-separable (expansion 1)
        sd.conv(b + "conv_dw", node["conv_dw"])
        sd.bn(b + "bn1", node["bn2"], st["bn2"])
        sd.conv(b + "conv_pw", node["conv_pwl"])
        sd.bn(b + "bn2", node["bn3"], st["bn3"])
    sd.conv(b + "se.conv_reduce", node["se"]["reduce"])
    sd.conv(b + "se.conv_expand", node["se"]["expand"])


def _mnv4(sd: _SD, p: str, P, S) -> None:
    """MobileNetV4Features: the JAX rows ``b{stage}_{block}`` are the port's
    ``blocks.{stage}.{block}``, its ``conv_head`` the last stage's block."""
    _conv_bn(sd, p + "conv_stem", p + "bn1", P["conv_stem"], S["conv_stem"])
    rows = [(name, re.fullmatch(r"b(\d+)_(\d+)", name)) for name in P]
    rows = [(name, int(m.group(1)), int(m.group(2))) for name, m in rows if m]
    for name, si, bi in rows:
        _mnv4_block(sd, f"{p}blocks.{si}.{bi}.", P[name], S[name])
    stages = 1 + max(si for _, si, _ in rows)
    _mnv4_block(sd, f"{p}blocks.{stages}.0.", P["conv_head"], S["conv_head"])


def _conv_bn(sd: _SD, conv: str, bn: str, node, st) -> None:
    """A JAX ``ConvBN`` (``conv``, ``bn``) as the port's ``conv`` and ``bn``
    keys (the stem's ``conv_stem``/``bn1``, a ConvBnAct's ``conv``/``bn1``)."""
    sd.conv(conv, node["conv"])
    sd.bn(bn, node["bn"], st["bn"])


def _mnv4_block(sd: _SD, b: str, node, st) -> None:
    """A MobileNetV4 block: a UIB (``pw_exp``), an EdgeResidual
    (``conv_exp``) or a ConvBnAct."""
    if "pw_exp" in node:
        for child, bn in (("dw_start", "bn_s"), ("pw_exp", "bn_e"), ("dw_mid", "bn_m"),
                          ("pw_proj", "bn_p")):
            if child in node:
                sd.conv(f"{b}{child}.conv", node[child])
                sd.bn(f"{b}{child}.bn", node[bn], st[bn])
    elif "conv_exp" in node:
        for conv, bn in (("conv_exp", "bn1"), ("conv_pwl", "bn2")):
            sd.conv(b + conv, node[conv])
            sd.bn(b + bn, node[bn], st[bn])
    else:
        _conv_bn(sd, b + "conv", b + "bn1", node, st)


def _gated_unit(sd: _SD, p: str, node) -> None:
    """A GatedConvUnit; without fusion (the ``self-agg`` C2F) only its conv."""
    sd.conv(p + "conv", node["Conv_0"])
    if "Conv_1" in node:
        sd.conv(p + "fusion_conv.0", node["Conv_1"])
        sd.norm(p + "fusion_conv.1", node["LayerNorm_0"])
        sd.conv(p + "fusion_conv.3", node["Conv_2"])


def _gated_block(sd: _SD, p: str, node) -> None:
    """A GatedFusionBlock: two units with a skip input, else one."""
    units = ("GateresConfUnit1", "GateresConfUnit2") if "GatedConvUnit_1" in node else (
        "GateresConfUnit2",)
    for ui, unit in enumerate(units):
        _gated_unit(sd, f"{p}{unit}.", node[f"GatedConvUnit_{ui}"])
    sd.conv(p + "out_conv", node["Conv_0"])


def _single_conv(sd: _SD, p: str, node) -> None:
    sd.conv(p + "single_conv.0", node["Conv_0"])
    sd.norm(p + "single_conv.1", node["LayerNorm_0"])


def _double_conv(sd: _SD, p: str, node) -> None:
    sd.conv(p + "double_conv.0", node["Conv_0"])
    sd.conv(p + "double_conv.2", node["Conv_1"])


def _fusion_c2f(sd: _SD, p: str, c2f) -> None:
    s = p + "scratch."
    for k in range(1, 6):
        sd.conv(f"{s}layer{k}_rn", c2f["Scratch_0"][f"layer{k}_rn"])
        _gated_block(sd, f"{s}refinenet{k}.", c2f[f"refinenet{k}"])
    sd.conv(s + "output_conv1", c2f["output_conv1"])
    sd.conv(s + "output_conv2.0", c2f["output_conv2"])
    _gated_block(sd, s + "output_conv2_fusion.", c2f["output_conv2_fusion"])
    sd.conv(s + "output_conv3.0", c2f["output_conv3"])


def _fusion(sd: _SD, p: str, P) -> None:
    """BiDirectionalFusion; with ``coarse2fine=False`` it has no ``c2f``."""
    if "c2f" in P:
        _fusion_c2f(sd, p + "c2f.", P["c2f"])
    i = 0
    while f"fusion1_{i}" in P:
        for j in (1, 2):
            _single_conv(sd, f"{p}fusion_layers_{j}.{i}.", P[f"fusion{j}_{i}"])
        i += 1
    i = 0
    while f"f2r_agg_{i}" in P:
        _double_conv(sd, f"{p}f2r_agg.{i}.conv.", P[f"f2r_agg_{i}"]["DoubleConv_0"])
        i += 1
    sd.conv(p + "final_conv", P["final_conv"])


def _fusion_unet(sd: _SD, p: str, P) -> None:
    """FusionUnet (the inverse of ``convert_fusion_unet``): ``enc1_i``/
    ``enc2_i`` as ``encoder_layers_1/2.{i}``, ``dec_i`` as
    ``decoder_layers.{i}``, ``final_conv``."""
    i = 0
    while f"enc1_{i}" in P:
        for j in (1, 2):
            _single_conv(sd, f"{p}encoder_layers_{j}.{i}.", P[f"enc{j}_{i}"])
        i += 1
    i = 0
    while f"dec_{i}" in P:
        _double_conv(sd, f"{p}decoder_layers.{i}.conv.", P[f"dec_{i}"]["DoubleConv_0"])
        i += 1
    sd.conv(p + "final_conv", P["final_conv"])


def _depth_net(sd: _SD, p: str, P) -> None:
    """A ZoeDepth (the BEiT MiDaS core under ``core.core`` and the bins head)
    or a DepthAnythingV2 (``pretrained``, ``depth_head``) network: the
    coarse branch, and PatchRefiner V1's fine branch, whose JAX tree is
    ``ZoeFineBranch``'s ``inner`` (``convert_patchrefiner`` reads the
    ZoeDepth one under ``refiner_fine_branch.``)."""
    if "depth_head" in P:
        _da2(sd, p, P)
    else:
        _beit_midas(sd, p + "core.core.", P["core"])
        _zoe_head(sd, p, P["head"])


def _prplusnet(sd: _SD, P, S) -> None:
    """The whole net; in the pretraining stage it has no coarse branch and
    its refiner has a decoder. PatchRefiner V1's net has a depth network as
    its fine branch and FusionUnet as its head."""
    if "coarse" in P:
        _depth_net(sd, "coarse_branch.", P["coarse"])
    if "inner" in P["fine"]:
        _depth_net(sd, "refiner_fine_branch.", P["fine"]["inner"])
        _fusion_unet(sd, "refiner_fusion_model.", P["fusion"])
        return
    _refiner(sd, "refiner_fine_branch.", P["fine"], S["fine"])
    _fusion(sd, "refiner_fusion_model.", P["fusion"])


def _refiner(sd: _SD, p: str, P, S) -> None:
    """LightWeightRefiner: its encoder told by key presence, a ``pw_exp``
    meaning MobileNetV4 (as ``convert_patchrefinerplus`` tells them)."""
    enc = P["refiner_encoder"]
    mnv4 = any(isinstance(v, Mapping) and "pw_exp" in v for v in enc.values())
    (_mnv4 if mnv4 else _effnet)(sd, p + "refiner_encoder.", enc, S["refiner_encoder"])
    if "decoder" in P:
        _refiner_decoder(sd, p + "decoder.scratch.", P["decoder"])


def _semi(sd: _SD, P, S) -> None:
    """PatchRefinerSemi's ``{"student", "teacher"}`` trees (the teacher
    absent offline), each a ``PRPlusNet``'s, under ``student.`` and
    ``teacher.``."""
    for who in ("student", "teacher"):
        if who in P:
            sub = _SD()
            _prplusnet(sub, P[who], S.get(who) or {})
            sd.update({f"{who}.{k}": v for k, v in sub.items()})


# JAX module -> how its variables ({params}, {batch_stats}) fill the port's
# counterpart module's state dict
PARTS = {
    "PRPlusNet": _prplusnet,
    "PatchRefinerSemi": _semi,
    "MidasDPTBEiT": lambda sd, P, S: _beit_midas(sd, "", P),
    "ZoeDepthHead": lambda sd, P, S: _zoe_head(sd, "", P),
    "DinoViT": lambda sd, P, S: _dino_vit(sd, "", P),
    "DepthAnythingV2": lambda sd, P, S: _da2(sd, "", P),
    "EfficientNetB5Features": lambda sd, P, S: _effnet(sd, "", P, S),
    "MBConv": lambda sd, P, S: _mbconv(sd, "", P, S),
    "MobileNetV4Features": lambda sd, P, S: _mnv4(sd, "", P, S),
    "UIB": lambda sd, P, S: _mnv4_block(sd, "", P, S),
    "EdgeResidual": lambda sd, P, S: _mnv4_block(sd, "", P, S),
    "ConvBN": lambda sd, P, S: _conv_bn(sd, "conv", "bn1", P, S),
    "LightWeightRefiner": lambda sd, P, S: _refiner(sd, "", P, S),
    "SimpleDPTHead": lambda sd, P, S: _refiner_decoder(sd, "scratch.", P),
    "BiDirectionalFusion": lambda sd, P, S: _fusion(sd, "", P),
    "FusionUnet": lambda sd, P, S: _fusion_unet(sd, "", P),
    "ZoeFineBranch": lambda sd, P, S: _depth_net(sd, "", P["inner"]),
    # BaselinePretrain's tree is its one depth network (ZoeDepth or DA2)
    "DepthNet": lambda sd, P, S: _depth_net(sd, "", P),
    "C2FModule": lambda sd, P, S: _fusion_c2f(sd, "", P),
    "GatedConvUnit": lambda sd, P, S: _gated_unit(sd, "", P),
    "GatedFusionBlock": lambda sd, P, S: _gated_block(sd, "", P),
    "SingleConvCNNLN": lambda sd, P, S: _single_conv(sd, "", P),
    "DoubleConv": lambda sd, P, S: _double_conv(sd, "", P),
}


def jax_to_state_dict(variables, part: str = "PRPlusNet") -> dict[str, np.ndarray]:
    """The variables of the JAX module ``part`` (a key of :data:`PARTS`) as
    the state dict (numpy) of its counterpart in the port."""
    sd = _SD()
    PARTS[part](sd, variables["params"], variables.get("batch_stats", {}))
    return dict(sd)


def load_jax_params(model, variables, part: str = "PRPlusNet") -> None:
    """Copy the JAX variables into ``model``: a ``PatchRefinerPlus`` (or its
    ``net``) by default, or the port's counterpart of the JAX module
    ``part``. Raises when a key of either side has no counterpart, apart
    from BatchNorm's ``num_batches_tracked`` counters."""
    net = getattr(model, "net", model)
    sd = jax_to_state_dict(variables, part)
    own = net.state_dict()
    unexpected = sorted(set(sd) - set(own))
    missing = sorted(k for k in set(own) - set(sd) if not k.endswith("num_batches_tracked"))
    if unexpected or missing:
        raise KeyError(f"JAX tree and port disagree: unexpected {unexpected[:8]}, missing {missing[:8]}")
    with torch.no_grad():
        for k, v in sd.items():
            t = own[k]
            if tuple(t.shape) != v.shape:
                raise ValueError(f"shape mismatch at {k}: port {tuple(t.shape)}, JAX {v.shape}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(v)))


def _node_paths(tree, path=()) -> dict[int, tuple]:
    """id of every mapping in a JAX tree -> its key path."""
    out = {id(tree): path}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_node_paths(v, path + (k,)))
    return out


def _s2d_channels(split) -> np.ndarray:
    """(4, sum(split)): where channel c of pixel phase g lies on the channel
    axis of the reference's space-to-depth map ``cat(s2d(a), s2d(b), ...)``
    of parts of ``split`` channels (phase-group-major within each part,
    ``ops/s2d.py`` ``space_to_depth`` and ``_cat_perm``)."""
    pos, base = [], 0
    for cp in split:
        pos.append(4 * base + np.arange(4)[:, None] * cp + np.arange(cp)[None, :])
        base += cp
    return np.concatenate(pos, axis=1)


def _phased_kernel(k, layout: str, split) -> np.ndarray:
    """A reference int8 kernel of a head site, HWIO on the space-to-depth
    shapes, as the port's weights by output phase (4, Cout, Cin, 3, 3): at
    ``s2d`` the expanded (3, 3, 4Cin, 4Cout) (``s2d_same_kernel``, the input
    axis in ``cat(s2d(...))`` order), at ``s2d_down`` the stride-2 (4, 4,
    Cin, 4Cout) (``s2d_down_kernel``). Each tap lies once in each output
    phase's columns, so the inverse is exact."""
    k = np.asarray(k)
    co = k.shape[-1] // 4
    out = np.empty((4, co, k.shape[2] // (4 if layout == "s2d" else 1), 3, 3), k.dtype)
    pos = _s2d_channels(split) if layout == "s2d" else None
    for di in range(2):
        for dj in range(2):
            go = di * 2 + dj
            for du in range(3):
                for dv in range(3):
                    if layout == "s2d":
                        t, u = di + du - 1, dj + dv - 1
                        rows = k[t // 2 + 1, u // 2 + 1, pos[(t % 2) * 2 + u % 2]]
                    else:
                        rows = k[di + du, dj + dv]
                    out[go, :, :, du, dv] = rows[:, go * co:(go + 1) * co].T
    return out


def load_jax_int8(model, variables, part: str = "PRPlusNet", min_kc: int = MIN_KC,
                  min_hw: int = MIN_HW) -> Int8Calibration:
    """The calibration in the JAX variables (``quant_scales``: the
    ``qamax_<i>`` per-tensor and ``qc_qamax_<i>`` per-channel abs-maxes;
    ``quant_kq``: each site's ``kq``/``sw`` and ``kqc``/``swc``) as the
    port's ``Int8Calibration`` for ``model`` (a ``PatchRefinerPlus`` or its
    ``net`` by default, or the port's counterpart of the JAX module
    ``part``, a key of :data:`PARTS`), in its weights' dtype, on their
    device. A site's JAX scope is the module that holds the conv's params,
    found through the weight loader's walk (``GatedConvUnit_0/1`` <->
    ``GateresConfUnit1/2``, an expand-1 MBConv's ``conv_pwl`` <->
    ``conv_pw``); its name is the port conv's ``int8_site``. The unported
    K5 1x1 sites are left out. At the ``head`` sites, which the reference
    runs in space-to-depth form, its expanded kernels, group-major scales
    and abs-maxes become the port's: weights and dequant scales by output
    phase and abs-maxes by (pixel phase, channel) where the per-channel
    scales depend on the phase (``s2d``), the plain ones otherwise."""
    net = getattr(model, "net", model)
    sd = _SD()
    PARTS[part](sd, variables["params"], variables.get("batch_stats", {}))
    paths = _node_paths(variables["params"])
    dev = next(net.parameters()).device
    hwio = (3, 2, 0, 1)

    def t(x, dtype=None, perm=None):
        a = np.asarray(x, dtype)
        return torch.from_numpy(np.ascontiguousarray(a if perm is None else a.transpose(perm))).to(dev)

    def at(tree, scope):
        for k in scope:
            tree = tree[k]
        return tree

    f32 = np.float32
    cal = Int8Calibration(dtype=next(net.parameters()).dtype, min_kc=min_kc, min_hw=min_hw)
    for name, conv in sites_of(net).items():
        if conv.int8_unported:
            continue
        scope, site, layout = paths[id(sd.nodes[name])][:-1], conv.int8_site, conv.int8_layout
        scales, kq = at(variables["quant_scales"], scope), at(variables["quant_kq"], scope)[site]
        e = dict(amax=t(scales[site], f32), amax_c=t(scales["qc_" + site], f32),
                 kq=t(kq["kq"], perm=hwio), sw=t(kq["sw"], f32),
                 kqc=t(kq["kqc"], perm=hwio) if "kqc" in kq else None,
                 swc=t(kq["swc"], f32) if "swc" in kq else None, hw=None, layout=layout)
        if layout != "plain":
            # the head unit's fusion conv reads cat(out, c_feat), out having
            # Cout channels (s2d_same_kernel(k2, split=(features, cc)))
            cout, cin = conv.out_channels, conv.in_channels
            split = (cout, cin - cout) if site == "qamax_1" else (cin,)
            co = slice(0, cout)  # the per-tensor pair is the same in every phase
            e.update(kq=t(_phased_kernel(kq["kq"], layout, split)[0]), sw=t(np.asarray(kq["sw"], f32)[co]))
            if layout == "s2d":
                e.update(amax_c=t(np.asarray(scales["qc_" + site], f32)[_s2d_channels(split)]))
            if "kqc" in kq:
                kqc, swc = _phased_kernel(kq["kqc"], layout, split), np.asarray(kq["swc"], f32)
                if layout == "s2d":
                    e.update(kqc=t(kqc), swc=t(swc.reshape(4, cout)))
                else:
                    e.update(kqc=t(kqc[0]), swc=t(swc[co]))
        cal.sites[name] = e
    return cal
