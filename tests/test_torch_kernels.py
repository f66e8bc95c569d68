"""The plain versions of the port's K3/K4 (attention), K5 (GatedConvUnit
tail) and K8 (bins head) kernels against the JAX package on the CPU.

Inputs are numpy arrays from a seed handed to both sides; the port runs on
CPU tensors, so every kernel wrapper takes its plain version. Float32
throughout. Tolerances: attention max |port - JAX| / max |JAX| < 1e-5 (the
same float32 products and softmax, summed in another order); the
GatedConvUnit tail and the bins head atol 2e-5 / rtol 1e-5 relative to
values of order 1-10 (float32 in another order; the log-binomial softmax
divides its logits by temperatures down to 0.0212, which turns an ulp of a
logarithm into ~1e-5 of a probability).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.backbones.beit import relative_position_bias as j_rel_bias
from patchrefinerv2_tpu.models.backbones.zoedepth import (
    AttractorLayerNormed as JNormed,
    AttractorLayerUnnormed as JUnnormed,
    ConditionalLogBinomial as JCLB,
)
from patchrefinerv2_tpu.models.blocks.convs import relu as j_relu
from patchrefinerv2_tpu.models.blocks.dpt import _conv_same, _layer_norm
from patchrefinerv2_tpu.ops.attention import mha

from patchrefinerv2_torch.models.backbones.zoedepth import AttractorLayer, ConditionalLogBinomial
from patchrefinerv2_torch.ops.attention import attention, relative_position_bias
from patchrefinerv2_torch.ops.bins import attractor_update
from patchrefinerv2_torch.ops.gated import gate_tail
from tests.test_torch_modules import assert_close_nhwc, init_random, nchw

T = torch.from_numpy


def _max_rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------- K3 / K4
@pytest.mark.parametrize("b,h,s,d", [(1, 2, 17, 64), (2, 3, 50, 48), (1, 4, 9, 16)])
def test_attention_without_bias_matches_mha(b, h, s, d):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    ref = np.asarray(mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention(T(q), T(k), T(v), d ** -0.5).numpy()
    assert _max_rel(got, ref) < 1e-5


@pytest.mark.parametrize("grid", [(3, 4), (5, 7), (4, 4)])
def test_attention_beit_bias_matches_relative_position_bias_and_mha(grid):
    gh, gw = grid
    s, heads, d = gh * gw + 1, 3, 32
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, heads, s, d).astype(np.float32) for _ in range(3))
    table = rng.randn((2 * gh - 1) * (2 * gw - 1) + 3, heads).astype(np.float32)
    bias_j = np.asarray(j_rel_bias(jnp.asarray(table), gh, gw))
    np.testing.assert_array_equal(relative_position_bias(T(table), grid).numpy(), bias_j)
    ref = np.asarray(mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5,
                         jnp.asarray(bias_j)))
    got = attention(T(q), T(k), T(v), d ** -0.5, T(table), grid).numpy()
    assert _max_rel(got, ref) < 1e-5


def test_attention_takes_strided_heads_of_one_qkv():
    """q, k and v as views into one packed (B, S, 3, H, D) projection, as
    the BEiT and DINOv2 blocks pass them."""
    rng = np.random.RandomState(2)
    qkv = rng.randn(1, 13, 3, 2, 16).astype(np.float32)
    q, k, v = T(qkv).permute(2, 0, 3, 1, 4)
    ref = np.asarray(mha(*(jnp.asarray(np.ascontiguousarray(t.numpy())) for t in (q, k, v))))
    assert _max_rel(attention(q, k, v, 0.25).numpy(), ref) < 1e-5


# ---------------------------------------------------------------- K5
@pytest.mark.parametrize("c", [32, 256])
@pytest.mark.parametrize("gate", [True, False])
def test_gate_tail_matches_gated_conv_unit_tail(c, gate):
    """LN -> ReLU -> bias-free 1x1 -> out * sigmoid(.) as GatedConvUnit
    computes it after its fusion conv (blocks/dpt.py:188-193)."""
    rng = np.random.RandomState(3)
    f = (rng.randn(2, 5, 7, c) * 2 + 0.3).astype(np.float32)
    out = rng.randn(2, 5, 7, c).astype(np.float32)
    kern = (rng.randn(1, 1, c, c) / np.sqrt(c)).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    z = _conv_same(j_relu(_layer_norm(jnp.asarray(f), jnp.asarray(scale), jnp.asarray(bias))),
                   jnp.asarray(kern), None)
    ref = np.asarray(jnp.asarray(out) * jax.nn.sigmoid(z) if gate else z)
    weight = T(np.ascontiguousarray(np.transpose(kern, (3, 2, 0, 1))))  # (O, I, 1, 1)
    got = gate_tail(T(f), T(out) if gate else None, weight, T(scale), T(bias), 1e-6).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------- K8
def _mlp_state(node, key):
    """A JAX two-conv MLP ({Conv_0, Conv_1}) as the port's ``key.{0,2}`` weights."""
    sd = {}
    for i, name in ((0, "Conv_0"), (2, "Conv_1")):
        sd[f"{key}.{i}.weight"] = T(np.ascontiguousarray(
            np.transpose(np.asarray(node[name]["kernel"]), (3, 2, 0, 1))))
        sd[f"{key}.{i}.bias"] = T(np.asarray(node[name]["bias"]))
    return sd


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("attractor_type", ["inv", "exp"])
@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_attractor_layer_matches_jax(kind, attractor_type, normed):
    """The port's AttractorLayer (its MLP, then attractor_update) against
    JAX's AttractorLayerUnnormed / AttractorLayerNormed."""
    rng = np.random.RandomState(4)
    x = rng.randn(1, 6, 8, 16).astype(np.float32)
    prev = rng.randn(1, 3, 4, 16).astype(np.float32)
    b_prev = (rng.rand(1, 3, 4, 12) * (1.0 if normed else 3.0)).astype(np.float32)
    if normed:
        jm = JNormed(12, 5, 1e-3, 10.0, kind=kind, attractor_type=attractor_type, mlp_dim=32)
    else:
        jm = JUnnormed(12, 5, kind=kind, attractor_type=attractor_type, mlp_dim=32)
    args = (jnp.asarray(x), jnp.asarray(b_prev), jnp.asarray(prev))
    v = init_random(jm, 5, *args)
    b_j, c_j = jm.apply(v, *args)
    port = AttractorLayer(16, 5, normed, 1e-3, 10.0, kind, attractor_type, mlp_dim=32).eval()
    port.load_state_dict(_mlp_state(v["params"], "_net"))
    with torch.no_grad():
        b_new, centers = port(nchw(x), nchw(b_prev), nchw(prev))
    assert_close_nhwc(b_new, b_j, "b_new")
    assert_close_nhwc(centers, c_j, "centers")


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("attractor_type", ["inv", "exp"])
def test_attractor_layer_matches_jax_in_bfloat16(attractor_type, normed):
    """In bfloat16 the attractor math runs in the input dtype on both sides
    (zoedepth.py:126-131): the port's layer agrees with JAX's to a few
    bfloat16 roundings, max |port - JAX| < 1e-2 of max |JAX|."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 6, 8, 16).astype(np.float32)
    b_prev = (rng.rand(1, 6, 8, 12) * (1.0 if normed else 3.0)).astype(np.float32)
    if normed:
        jm = JNormed(12, 4, 1e-3, 10.0, attractor_type=attractor_type, mlp_dim=32)
    else:
        jm = JUnnormed(12, 4, attractor_type=attractor_type, mlp_dim=32)
    v = init_random(jm, 9, jnp.asarray(x), jnp.asarray(b_prev))
    bf = jnp.bfloat16
    v16 = jax.tree_util.tree_map(lambda p: p.astype(bf), v)
    outs_j = jm.apply(v16, jnp.asarray(x, bf), jnp.asarray(b_prev, bf))
    port = AttractorLayer(16, 4, normed, 1e-3, 10.0, "mean", attractor_type, mlp_dim=32).eval()
    port.load_state_dict(_mlp_state(v["params"], "_net"))
    port.to(torch.bfloat16)
    with torch.no_grad():
        outs = port(nchw(x).bfloat16(), nchw(b_prev).bfloat16())
    for name, got, ref in zip(("b_new", "centers"), outs, outs_j):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        assert _max_rel(got.float().permute(0, 2, 3, 1).numpy(), ref) < 1e-2, name


def test_attractor_update_rejects_unknown_kind():
    with pytest.raises(ValueError):
        attractor_update(torch.zeros(1, 2), torch.zeros(1, 4), kind="max")


@pytest.mark.parametrize("n_bins,min_temp", [(64, 0.0212), (16, 5.0)])
def test_log_binomial_depth_matches_conditional_log_binomial(n_bins, min_temp):
    """The port's ConditionalLogBinomial (MLP, then log_binomial_depth)
    against JAX's ConditionalLogBinomial and the expectation over the
    centres (zoedepth.py:368-376)."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 8, 12).astype(np.float32)
    cond = rng.randn(2, 6, 8, 8).astype(np.float32)
    centers = np.sort(rng.rand(2, 6, 8, n_bins) * 80, axis=-1).astype(np.float32)
    jm = JCLB(n_bins, bottleneck=10, min_temp=min_temp, max_temp=50.0)
    v = init_random(jm, 7, jnp.asarray(x), jnp.asarray(cond))
    probs = jm.apply(v, jnp.asarray(x), jnp.asarray(cond))
    ref = np.asarray(jnp.sum(probs * jnp.asarray(centers), axis=-1, keepdims=True))
    port = ConditionalLogBinomial(20, n_bins, 10, min_temp, 50.0).eval()
    port.load_state_dict(_mlp_state(v["params"], "mlp"))
    with torch.no_grad():
        got = port(nchw(x), nchw(cond), nchw(centers))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=2e-5)

