"""K9, the fusion head's full-resolution low-channel convolutions: the plain
version of the port's ``tail_conv`` against the JAX package's space-to-depth
functions (``patchrefinerv2_tpu/ops/s2d.py``), and the port's blocks in tail
form against the JAX blocks in their s2d form, on the CPU.

Inputs are numpy arrays from a seed in float32, handed to both sides; the
port runs on CPU tensors, so ``tail_conv`` takes its plain version. The s2d
form is an exact re-layout (its structural zeros contribute 0.0), so the two
sides compute the same float32 sums in another order: max |port - JAX| /
max |JAX| < 1e-5 for the functions, and the module bars of
``tests/test_torch_modules.py`` (atol 2e-4, rtol 1e-4) for the blocks. The
JAX blocks run with ``PRV2_S2D`` at its default (on), set inside each test
and restored after it.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patchrefinerv2_tpu.models.blocks.convs import DoubleConv as JDoubleConv
from patchrefinerv2_tpu.models.blocks.convs import SingleConvCNNLN as JSingle
from patchrefinerv2_tpu.models.blocks.convs import gelu as j_gelu
from patchrefinerv2_tpu.models.blocks.convs import relu as j_relu
from patchrefinerv2_tpu.models.blocks.dpt import C2FModule as JC2F
from patchrefinerv2_tpu.models.blocks.dpt import GatedFusionBlock as JGFB
from patchrefinerv2_tpu.models.blocks.dpt import _conv_same
from patchrefinerv2_tpu.models.blocks.fusion import BiDirectionalFusion as JFusion
from patchrefinerv2_tpu.ops import s2d

from patchrefinerv2_torch.models.blocks.convs import DoubleConv, SingleConvCNNLN
from patchrefinerv2_torch.models.blocks.dpt import C2FModule, GatedFusionBlock
from patchrefinerv2_torch.models.blocks.fusion import BiDirectionalFusion
from patchrefinerv2_torch.ops.tail_conv import (
    CHUNK, cout_pad, format_weight, launch_plan, tail_conv, tail_conv_plain,
)
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests.test_torch_modules import _COARSE, _FINE, assert_close_nhwc, init_random, nchw

T = torch.from_numpy


@pytest.fixture
def s2d_default():
    """``PRV2_S2D`` at its default (on) for the JAX side, restored after."""
    old = os.environ.pop("PRV2_S2D", None)
    os.environ["PRV2_S2D"] = "1"
    assert s2d.s2d_enabled()
    yield
    del os.environ["PRV2_S2D"]
    if old is not None:
        os.environ["PRV2_S2D"] = old


def _max_rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _kernel(rng, k, cin, cout):
    """A JAX (k, k, cin, cout) kernel and the port's (cout, cin, k, k) view."""
    kern = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    return kern, T(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))


def _s2d_conv(parts, kern, bias):
    """``depth_to_space(conv_same(cat(s2d(parts)), s2d_same_kernel(k, split)))``."""
    x = jnp.concatenate([s2d.space_to_depth(jnp.asarray(p)) for p in parts], axis=-1)
    split = tuple(p.shape[-1] for p in parts)
    y = _conv_same(x, s2d.s2d_same_kernel(jnp.asarray(kern), split=split),
                   s2d.tile_bias(None if bias is None else jnp.asarray(bias)))
    return s2d.depth_to_space(y)


# ---------------------------------------------------------------- the function
@pytest.mark.parametrize("split", [(32, 32), (32, 1, 1), (8, 8)])
def test_plain_matches_s2d_same_kernel_split(split):
    rng = np.random.RandomState(0)
    parts = [rng.randn(2, 6, 10, c).astype(np.float32) for c in split]
    kern, w = _kernel(rng, 3, sum(split), 16)
    bias = rng.randn(16).astype(np.float32)
    ref = _s2d_conv(parts, kern, bias)
    got = tail_conv_plain([T(p) for p in parts], w, T(bias))
    assert _max_rel(got, ref) < 1e-5
    # on a CPU tensor the wrapper is the plain version
    assert _max_rel(tail_conv([T(p) for p in parts], w, T(bias)), ref) < 1e-5


@pytest.mark.parametrize("cin,cout", [(128, 32), (16, 8)])
def test_plain_matches_conv_s2d_down_entry(cin, cout):
    """C2F ``output_conv2``: the segment's entry conv, then its ReLU."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 6, cin).astype(np.float32)
    kern, w = _kernel(rng, 3, cin, cout)
    bias = rng.randn(cout).astype(np.float32)
    ref = s2d.depth_to_space(j_relu(s2d.conv_s2d_down(jnp.asarray(x), jnp.asarray(kern),
                                                      jnp.asarray(bias))))
    got = tail_conv_plain([T(x)], w, T(bias), act="relu")
    assert _max_rel(got, ref) < 1e-5


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 1), (8, 1)])
def test_plain_matches_s2d_1x1_kernel(cin, cout):
    """GatedFusionBlock ``out_conv`` and C2F ``output_conv3`` (Cout = 1)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 8, cin).astype(np.float32)
    kern, w = _kernel(rng, 1, cin, cout)
    bias = rng.randn(cout).astype(np.float32)
    ref = s2d.depth_to_space(_conv_same(s2d.space_to_depth(jnp.asarray(x)),
                                        s2d.s2d_1x1_kernel(jnp.asarray(kern)),
                                        s2d.tile_bias(jnp.asarray(bias))))
    got = tail_conv_plain([T(x)], w, T(bias))
    assert _max_rel(got, ref) < 1e-5


@pytest.mark.parametrize("split", [(32, 32), (32, 1, 1)])
def test_plain_matches_layer_norm_s2d_and_gelu(split):
    """``fusion1_0`` / ``fusion2_0``: the conv, ``layer_norm_s2d`` and GELU."""
    rng = np.random.RandomState(3)
    parts = [rng.randn(2, 6, 8, c).astype(np.float32) for c in split]
    kern, w = _kernel(rng, 3, sum(split), 32)
    scale = (1.0 + 0.2 * rng.randn(32)).astype(np.float32)
    shift = (0.2 * rng.randn(32)).astype(np.float32)
    x = jnp.concatenate([s2d.space_to_depth(jnp.asarray(p)) for p in parts], axis=-1)
    y = _conv_same(x, s2d.s2d_same_kernel(jnp.asarray(kern), split=split), None)
    ref = s2d.depth_to_space(j_gelu(s2d.layer_norm_s2d(y, jnp.asarray(scale), jnp.asarray(shift))))
    got = tail_conv_plain([T(p) for p in parts], w, ln=(T(scale), T(shift)), act="gelu")
    assert _max_rel(got, ref) < 1e-5


def test_plain_matches_gated_unit_residual_and_relu_prologue():
    """The GatedConvUnit conv in s2d form: ``conv(relu(x)) + x``."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 8, 32).astype(np.float32)
    kern, w = _kernel(rng, 3, 32, 32)
    bias = rng.randn(32).astype(np.float32)
    xs = s2d.space_to_depth(jnp.asarray(x))
    ref = s2d.depth_to_space(
        _conv_same(j_relu(xs), s2d.s2d_same_kernel(jnp.asarray(kern)), s2d.tile_bias(jnp.asarray(bias)))
        + xs)
    got = tail_conv_plain([T(x)], w, T(bias), residual=T(x), relu_in=True)
    assert _max_rel(got, ref) < 1e-5


def test_plain_matches_final_conv_clamp():
    """``final_conv`` in s2d form with ``max(update_base + offset, 0)``."""
    rng = np.random.RandomState(5)
    cur = rng.randn(2, 6, 8, 32).astype(np.float32)
    base = (rng.rand(2, 6, 8, 1) - 0.3).astype(np.float32)
    kern, w = _kernel(rng, 3, 32, 1)
    off = s2d.depth_to_space(_conv_same(s2d.space_to_depth(jnp.asarray(cur)),
                                        s2d.s2d_same_kernel(jnp.asarray(kern)), None))
    ref = np.maximum(np.asarray(base) + np.asarray(off), 0.0)
    assert (ref == 0).any() and (ref > 0).any()
    got = tail_conv_plain([T(cur)], w, residual=T(base), act="relu")
    assert _max_rel(got, ref) < 1e-5


@pytest.mark.parametrize("k,split,cout,dtype", [
    (3, (32, 1, 1), 32, torch.bfloat16), (3, (98,), 32, torch.float32),
    (1, (128,), 128, torch.bfloat16), (3, (40,), 128, torch.float32), (3, (5,), 1, torch.float32),
    (3, (32,), 1, torch.bfloat16)])
def test_formatted_weight_reproduces_the_conv(k, split, cout, dtype):
    """The weight layout of the kernel for the dtype and Cout, zero padded,
    summed the way the kernel sums it gives the plain conv: the contract
    between ``format_weight`` and ``csrc/tail_conv.cu``. Route "mma"
    (float32, bfloat16 at Cout <= 8): [Cin chunks][tap][32][N]; "wgmma":
    [k-steps of 16][half][tap][N][8]."""
    rng = np.random.RandomState(6)
    parts = [rng.randn(1, 5, 7, c).astype(np.float32) for c in split]
    _, w = _kernel(rng, k, sum(split), cout)
    wf = format_weight(w.to(dtype)).float().numpy()
    if launch_plan(split, k, cout, dtype)["route"] == "wgmma":
        nch, halves, kk, cpad, eight = wf.shape
        assert (halves, kk, eight) == (2, k * k, 8)
        wf = wf.transpose(0, 2, 1, 4, 3).reshape(nch, kk, 16, cpad)  # [k-step][tap][16][N]
        kc = 16
    else:
        nch, kk, kc, cpad = wf.shape
        assert (kk, kc) == (k * k, CHUNK)
    assert cpad == cout_pad(cout)
    x = np.concatenate(parts, axis=-1)
    x = np.pad(x, ((0, 0), (k // 2,) * 2, (k // 2,) * 2, (0, nch * kc - x.shape[-1])))
    acc = np.zeros((1, 5, 7, cpad), np.float64)
    for ch in range(nch):
        for tap in range(kk):
            du, dv = divmod(tap, k)
            acc += x[:, du:du + 5, dv:dv + 7, ch * kc:(ch + 1) * kc] @ wf[ch, tap]
    ref = tail_conv_plain([T(p) for p in parts], w.to(dtype).float())
    assert not acc[..., cout:].any()
    assert _max_rel(acc[..., :cout], ref) < 1e-5


# ---------------------------------------------------------------- the blocks
@pytest.mark.parametrize("split", [(8, 8), (8, 1, 1)])
def test_single_conv_cnn_ln_tail_matches_jax_s2d_split(split, s2d_default):
    rng = np.random.RandomState(7)
    parts = [rng.randn(2, 6, 8, c).astype(np.float32) for c in split]
    x = jnp.concatenate([s2d.space_to_depth(jnp.asarray(p)) for p in parts], axis=-1)
    jm = JSingle(8, s2d_split=split)
    v = init_random(jm, 8, x)
    ref = s2d.depth_to_space(jm.apply(v, x))
    port = SingleConvCNNLN(sum(split), 8, tail=True).eval()
    load_jax_params(port, v, part="SingleConvCNNLN")
    with torch.no_grad():
        assert_close_nhwc(port(*(nchw(p) for p in parts)), ref)


def test_double_conv_tail_matches_jax_s2d_out(s2d_default):
    """The last ``f2r_agg`` stage: 98 channels in (as in the configurations),
    the second conv in tail form."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, 8, 98).astype(np.float32)
    jm = JDoubleConv(8, 98, s2d_out=True)
    v = init_random(jm, 10, jnp.asarray(x))
    ref = s2d.depth_to_space(jm.apply(v, jnp.asarray(x)))
    port = DoubleConv(98, 8, 98, tail=True).eval()
    load_jax_params(port, v, part="DoubleConv")
    with torch.no_grad():
        assert_close_nhwc(port(nchw(x)), ref)


@pytest.mark.parametrize("gate", [True, False])
def test_gated_fusion_block_tail_matches_jax_s2d(gate, s2d_default):
    """The C2F head's ``output_conv2_fusion``: one gated unit (its conv and
    fusion conv on K9), K5, and the 1x1 ``out_conv`` on K9."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 6, 8, 16).astype(np.float32)
    c = rng.randn(2, 6, 8, 8).astype(np.float32)
    xs, cs = s2d.space_to_depth(jnp.asarray(x)), s2d.space_to_depth(jnp.asarray(c))
    jm = JGFB(16, gate=gate, fusion=True, s2d=True)
    v = init_random(jm, 12, xs, None, None, cs, False)
    ref = s2d.depth_to_space(jm.apply(v, xs, coarse_feat=cs, upscale=False))
    port = GatedFusionBlock(16, 8, skip=False, gate=gate, fusion=True, tail=True).eval()
    load_jax_params(port, v, part="GatedFusionBlock")
    with torch.no_grad():
        assert_close_nhwc(port(nchw(x), coarse_feat=nchw(c), upscale=False), ref)


def test_c2f_module_tail_matches_jax_s2d_tail(s2d_default):
    """The port's C2F head (on K9) against the JAX head in s2d form, whose
    ``last_feat`` comes back in s2d form: compared in the plain layout."""
    rng = np.random.RandomState(13)
    fine = [rng.randn(2, *s).astype(np.float32) for s in _FINE]
    coarse = [rng.randn(2, *s).astype(np.float32) for s in _COARSE]
    jm = JC2F(features=16, head2_features=8, gate=True, fusion=True, s2d_tail=True)
    args = ([jnp.asarray(f) for f in fine], [jnp.asarray(c) for c in coarse])
    v = init_random(jm, 14, *args)
    feats_j, out_j = jm.apply(v, *args)
    assert feats_j[5].shape[1] * 2 == out_j.shape[1]  # the s2d head ran
    feats_j = feats_j[:5] + [s2d.depth_to_space(feats_j[5])]
    port = C2FModule([s[2] for s in _FINE], [s[2] for s in _COARSE], features=16,
                     head2_features=8).eval()
    load_jax_params(port, v, part="C2FModule")
    with torch.no_grad():
        feats, out = port([nchw(f) for f in fine], [nchw(c) for c in coarse])
    for i, (a, b) in enumerate(zip(feats, feats_j)):
        assert_close_nhwc(a, b, f"c2f feature {i}")
    assert_close_nhwc(out, out_j, "c2f depth")


@pytest.mark.parametrize("hw,with_base", [((64, 96), True), ((64, 96), False), ((40, 56), True)])
def test_bidirectional_fusion_tail_matches_jax(hw, with_base, s2d_default, monkeypatch):
    """The whole head, with ``update_base`` (``final_conv``'s clamp) and
    without (the offset alone); the JAX head runs its s2d tail. The port's
    head makes 9 tail calls, one for each site."""
    h, w = hw
    rng = np.random.RandomState(15)
    fine_shapes = [(h, w, 8)] + [(-(-h // 2 ** i), -(-w // 2 ** i), c)
                                 for i, c in enumerate((8, 12, 16, 20, 24), start=1)]
    coarse_shapes = [(h, w, 8)] + [(s[0], s[1], 6) for s in fine_shapes[1:]]
    f_feat = [rng.randn(2, *s).astype(np.float32) for s in fine_shapes]
    c_feat = [rng.randn(2, *s).astype(np.float32) for s in coarse_shapes]
    pred1 = (rng.rand(2, h, w, 1) * 5).astype(np.float32)
    pred2 = (rng.rand(2, h, w, 1) * 5).astype(np.float32)
    base = pred1 if with_base else None
    temp, dec = (8, 8, 8, 16, 16, 16), (16, 16, 8, 8, 8)
    jf = JFusion(coarse_chl=tuple(s[2] for s in coarse_shapes), temp_chl=temp, dec_chl=dec,
                 c2f_features=16)
    jargs = ([jnp.asarray(c) for c in c_feat], [jnp.asarray(f) for f in f_feat],
             jnp.asarray(pred1), jnp.asarray(pred2))
    jb = None if base is None else jnp.asarray(base)
    v = init_random(jf, 16, *jargs, jb)
    ref = jf.apply(v, *jargs, update_base=jb)
    port = BiDirectionalFusion([s[2] for s in coarse_shapes], [s[2] for s in fine_shapes[1:]],
                               temp_chl=temp, dec_chl=dec, c2f_features=16,
                               head2_features=coarse_shapes[0][2]).eval()
    load_jax_params(port, v, part="BiDirectionalFusion")
    calls = []
    tc_mod = importlib.import_module("patchrefinerv2_torch.ops.tail_conv")
    plain = tc_mod.tail_conv_plain

    def counted(*a, **k):
        calls.append(a[1].shape)
        return plain(*a, **k)

    monkeypatch.setattr(tc_mod, "tail_conv_plain", counted)
    with torch.no_grad():
        got = port([nchw(c) for c in c_feat], [nchw(f) for f in f_feat], nchw(pred1),
                   nchw(pred2), update_base=None if base is None else nchw(base))
    assert_close_nhwc(got, ref, "fusion depth")
    assert len(calls) == 9, calls
