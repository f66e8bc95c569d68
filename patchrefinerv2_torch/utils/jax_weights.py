"""Load the JAX package's variables into the port.

``load_jax_params(model, variables)`` takes the ``{"params", "batch_stats"}``
tree of the JAX ``PRPlusNet`` (as numpy arrays) and writes it into the
port's modules, whose parameter names are the reference's torch state-dict
keys. It is the inverse of the JAX package's checkpoint converter
(``convert_patchrefinerplus``): a conv kernel (kh, kw, I, O) becomes
(O, I, kh, kw), a dense kernel (I, O) becomes (O, I), a transposed-conv
kernel is flipped back spatially to (I, O, kh, kw), LayerNorm/BatchNorm
``scale`` becomes ``weight`` and the BatchNorm ``mean``/``var`` statistics
become ``running_mean``/``running_var``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["load_jax_params", "jax_to_state_dict"]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class _SD(dict):
    def conv(self, key, node):
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
    for k in range(1, 5):
        sd.conv(f"{p}scratch.layer{k}_rn", P[f"layer{k}_rn"])
        node, base = P[f"refinenet{k}"], f"{p}scratch.refinenet{k}"
        units = ("resConfUnit2",) if k == 4 else ("resConfUnit1", "resConfUnit2")
        for ui, unit in enumerate(units):
            rcu = node[f"ResidualConvUnit_{ui}"]
            sd.conv(f"{base}.{unit}.conv1", rcu["Conv_0"])
            sd.conv(f"{base}.{unit}.conv2", rcu["Conv_1"])
        sd.conv(base + ".out_conv", node["Conv_0"])
    sd.conv(p + "scratch.output_conv.0", P["output_conv1"])
    sd.conv(p + "scratch.output_conv.2", P["output_conv2_0"])
    sd.conv(p + "scratch.output_conv.4", P["output_conv2_1"])


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
        b, st = f"{p}blocks.{m.group(1)}.{m.group(2)}.", S[name]
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


def _gated_unit(sd: _SD, p: str, node) -> None:
    sd.conv(p + "conv", node["Conv_0"])
    sd.conv(p + "fusion_conv.0", node["Conv_1"])
    sd.norm(p + "fusion_conv.1", node["LayerNorm_0"])
    sd.conv(p + "fusion_conv.3", node["Conv_2"])


def _gated_block(sd: _SD, key: str, node, single: bool) -> None:
    units = ("GateresConfUnit2",) if single else ("GateresConfUnit1", "GateresConfUnit2")
    for ui, unit in enumerate(units):
        _gated_unit(sd, f"{key}.{unit}.", node[f"GatedConvUnit_{ui}"])
    sd.conv(key + ".out_conv", node["Conv_0"])


def _fusion_c2f(sd: _SD, p: str, c2f) -> None:
    s = p + "scratch."
    for k in range(1, 6):
        sd.conv(f"{s}layer{k}_rn", c2f["Scratch_0"][f"layer{k}_rn"])
        _gated_block(sd, f"{s}refinenet{k}", c2f[f"refinenet{k}"], single=(k == 5))
    sd.conv(s + "output_conv1", c2f["output_conv1"])
    sd.conv(s + "output_conv2.0", c2f["output_conv2"])
    _gated_block(sd, s + "output_conv2_fusion", c2f["output_conv2_fusion"], single=True)
    sd.conv(s + "output_conv3.0", c2f["output_conv3"])


def _fusion(sd: _SD, p: str, P) -> None:
    _fusion_c2f(sd, p + "c2f.", P["c2f"])
    i = 0
    while f"fusion1_{i}" in P:
        for j in (1, 2):
            node, key = P[f"fusion{j}_{i}"], f"{p}fusion_layers_{j}.{i}.single_conv"
            sd.conv(key + ".0", node["Conv_0"])
            sd.norm(key + ".1", node["LayerNorm_0"])
        i += 1
    i = 0
    while f"f2r_agg_{i}" in P:
        dc = P[f"f2r_agg_{i}"]["DoubleConv_0"]
        sd.conv(f"{p}f2r_agg.{i}.conv.double_conv.0", dc["Conv_0"])
        sd.conv(f"{p}f2r_agg.{i}.conv.double_conv.2", dc["Conv_1"])
        i += 1
    sd.conv(p + "final_conv", P["final_conv"])


def _prplusnet(sd: _SD, P, S) -> None:
    _beit_midas(sd, "coarse_branch.core.core.", P["coarse"]["core"])
    _zoe_head(sd, "coarse_branch.", P["coarse"]["head"])
    _effnet(sd, "refiner_fine_branch.refiner_encoder.", P["fine"]["refiner_encoder"],
            S["fine"]["refiner_encoder"])
    _fusion(sd, "refiner_fusion_model.", P["fusion"])


# JAX module -> how its variables ({params}, {batch_stats}) fill the port's
# counterpart module's state dict
PARTS = {
    "PRPlusNet": _prplusnet,
    "MidasDPTBEiT": lambda sd, P, S: _beit_midas(sd, "", P),
    "ZoeDepthHead": lambda sd, P, S: _zoe_head(sd, "", P),
    "EfficientNetB5Features": lambda sd, P, S: _effnet(sd, "", P, S),
    "LightWeightRefiner": lambda sd, P, S: _effnet(
        sd, "refiner_encoder.", P["refiner_encoder"], S["refiner_encoder"]),
    "BiDirectionalFusion": lambda sd, P, S: _fusion(sd, "", P),
    "C2FModule": lambda sd, P, S: _fusion_c2f(sd, "", P),
    "GatedConvUnit": lambda sd, P, S: _gated_unit(sd, "", P),
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
