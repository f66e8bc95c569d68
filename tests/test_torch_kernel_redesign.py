"""What the redesigned K2 (resize) and K3/K4 (attention) kernels promise,
pinned on the CPU against the JAX package.

K2: the host's choice of kernel path (``ops/resize._launch_plan``) at the
channel counts and dtypes of every main path's calls; ``resize`` and
``crop_resize`` (their plain versions here) against the JAX ``resize`` and
``crop_resize_patches`` at the channel counts the kernel's paths split on,
float32, atol / rtol 1e-5 (the same float32 taps summed in another order);
nearest on maps holding inf and NaN against the plain formula
``w0 * v + w1 * v``, bit for bit.

K3/K4: a model of the bfloat16 kernel's order of operations (64-key tiles,
pass 1: the exact row max and the row sum rescaled online; pass 2:
``p = exp(s - m) * (1 / l)`` in float32, rounded to bfloat16 only after it
is normalised, P.V accumulated in float32, the output rounded) against the
JAX ``mha`` in bfloat16 at DINOv2-L's S = 1025 without a bias and BEiT-L's
S = 769 with the relative-position bias. Tolerance: one bfloat16 rounding
of the output, 2^-8 of its largest magnitude: both sides round the same
float32 sums to bfloat16, and where the rescaled sum or the reciprocal
moves a float32 p by an ulp and flips its bfloat16 rounding, or an output's
sum lands on the other side of a rounding boundary, the output moves by at
most about one bfloat16 step.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patchrefinerv2_tpu.models import tiling as jtiling
from patchrefinerv2_tpu.models.backbones.beit import relative_position_bias as j_rel_bias
from patchrefinerv2_tpu.ops.attention import mha
from patchrefinerv2_tpu.ops.resize import resize as j_resize

from patchrefinerv2_torch.ops.resize import axis_taps, crop_resize, resize

R = importlib.import_module("patchrefinerv2_torch.ops.resize")  # the module: ops.resize is the function
T = torch.from_numpy


# ---------------------------------------------------------------- K2 plan
# Every (channels, element bytes) of the main paths' K2 calls (the flagship
# and DA2 frames in m1, m2, r32, bf16, int8 and the f32 parity frame, and
# the Cityscapes evaluation), with an output width each takes, and the path
# the kernel takes there: (vec, vstore), vec the channels a thread (16
# bytes of them), 0 the run path. The sources are fresh 16-byte aligned
# allocations.
MAIN_PATH_CALLS = [
    ((1, 2, 960), (0, True)),    # rN predictions back to the raw patch (nearest)
    ((1, 2, 14), (0, False)),    # DA2's predictions at its 14-wide fusion level: 28-byte rows
    ((1, 2, 512), (0, True)),    # ZoeDepth's relative depth, the fusion's predictions
    ((1, 4, 3840), (0, True)),   # rN canvases to the raw frame (TileBlender.resize)
    ((1, 4, 2048), (0, True)),   # the metrics' prediction to the gt
    ((3, 2, 512), (0, True)),    # the frame crop, bf16
    ((3, 4, 512), (0, True)),    # the frame crop, f32 parity frame
    ((24, 2, 256), (8, False)),  # the refiner's top EfficientNet-B5 feature
    ((24, 4, 256), (4, False)),
    ((64, 2, 64), (8, False)),   # the bins head's centers
    ((64, 4, 64), (4, False)),
    ((128, 2, 448), (8, False)),  # bin embeddings; DA2's head features
    ((128, 4, 448), (4, False)),
    ((256, 2, 512), (8, False)),  # the feature upsamples
    ((256, 4, 512), (4, False)),
    ((512, 2, 64), (8, False)),
    ((512, 4, 64), (4, False)),
    ((1024, 2, 32), (8, False)),  # DINOv2's position embedding (bicubic)
]


@pytest.mark.parametrize("call,plan", MAIN_PATH_CALLS)
def test_launch_plan_at_the_main_paths_calls(call, plan):
    c, itemsize, ow = call
    assert R._launch_plan(c, itemsize, 16, ow * c * itemsize) == plan


@pytest.mark.parametrize("c,itemsize,align,row_bytes,plan", [
    (256, 2, 16, 512 * 256 * 2, (8, False)),   # 16-byte channel vectors
    (256, 4, 16, 512 * 256 * 4, (4, False)),
    (4, 2, 16, 960 * 8, (4, False)),           # 8 bytes of channels
    (98, 2, 16, 96 * 98 * 2, (2, False)),      # 196 bytes: 4-byte vectors
    (98, 4, 16, 96 * 98 * 4, (2, False)),      # 392 bytes: 8-byte vectors
    (322, 2, 16, 128 * 322 * 2, (2, False)),
    (194, 4, 16, 256 * 194 * 4, (2, False)),
    (256, 2, 4, 512 * 256 * 2, (2, False)),    # a view 4 bytes off alignment
    (256, 2, 2, 512 * 256 * 2, (0, True)),     # 2 bytes off: the run path
    (8, 4, 4, 40 * 8 * 4, (0, True)),
    (1, 2, 16, 960 * 2, (0, True)),            # single channel: runs
    (1, 4, 16, 3840 * 4, (0, True)),
    (1, 2, 16, 7 * 2, (0, False)),             # rows not a multiple of 16 bytes
    (3, 2, 16, 5 * 3 * 2, (0, False)),
])
def test_launch_plan_widest_vector_that_divides(c, itemsize, align, row_bytes, plan):
    assert R._launch_plan(c, itemsize, align, row_bytes) == plan


# ---------------------------------------------------------------- K2 values
CHANNELS = (1, 3, 8, 98, 256, 322)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("mode,ac,out_hw", [("bilinear", True, (13, 16)), ("bilinear", False, (4, 5)),
                                            ("nearest", False, (13, 16)), ("nearest", False, (4, 5))])
def test_resize_matches_jax_at_each_paths_channels(c, mode, ac, out_hw):
    rng = np.random.RandomState(c)
    x = rng.randn(2, 7, 9, c).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(x), out_hw, mode, ac))
    np.testing.assert_allclose(resize(T(x), out_hw, mode, ac).numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", CHANNELS)
def test_crop_resize_matches_jax_at_each_paths_channels(c):
    rng = np.random.RandomState(10 + c)
    img = rng.rand(24, 40, c).astype(np.float32)
    cfg = jtiling.TileCfg((24, 40), (2, 2), (10, 16))
    p = jtiling.regular_pass(cfg, (1, 1), 4)
    ref = np.asarray(jtiling.crop_resize_patches(jnp.asarray(img), jnp.asarray(p.starts_raw),
                                                 cfg.patch_raw_shape, (10, 16)))
    got = crop_resize(T(img), T(p.starts_raw), cfg.patch_raw_shape, (10, 16)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _nearest_formula(x, out_hw):
    """The plain formula on numpy: out = w0 * x[i0] + w1 * x[i1] along H,
    then along W, in float32 (inf * 0 is NaN, as on the card)."""
    iy, wy = axis_taps(x.shape[1], out_hw[0], "nearest", False)
    ix, wx = axis_taps(x.shape[2], out_hw[1], "nearest", False)
    with np.errstate(invalid="ignore"):
        y = x[:, iy[0]] * wy[0][None, :, None, None] + x[:, iy[1]] * wy[1][None, :, None, None]
        return y[:, :, ix[0]] * wx[0][None, None, :, None] + y[:, :, ix[1]] * wx[1][None, None, :, None]


@pytest.mark.parametrize("c", (1, 8))
@pytest.mark.parametrize("out_hw", [(13, 16), (4, 5)])
def test_nearest_propagates_inf_and_nan_as_the_plain_formula(c, out_hw):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 9, c).astype(np.float32)
    pick = rng.rand(*x.shape)
    x[pick < 0.1] = np.inf
    x[(pick >= 0.1) & (pick < 0.2)] = -np.inf
    x[(pick >= 0.2) & (pick < 0.3)] = np.nan
    ref = _nearest_formula(x, out_hw)
    got = resize(T(x), out_hw, "nearest").numpy()
    np.testing.assert_array_equal(got, ref)  # NaN where the formula gives NaN
    assert np.isnan(ref).sum() > np.isnan(x).mean() * ref.size  # the infs turned NaN too


# ---------------------------------------------------------------- K3 / K4
def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def two_pass_attention(q, k, v, scale, bias=None, tile=64):
    """The bfloat16 kernel's order of operations on (H, S, D) float32
    tensors holding bfloat16 values; returns the bfloat16 output as float32."""
    qs = _bf16(q * _bf16(torch.tensor(scale)))
    s = qs @ k.transpose(-2, -1)
    if bias is not None:
        s = s + bias
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    for t0 in range(0, s.shape[-1], tile):
        st = s[..., t0:t0 + tile]
        mn = torch.maximum(m, st.amax(-1))
        l = torch.where(torch.isinf(m), 0.0, l * torch.exp(m - mn)) + torch.exp(st - mn[..., None]).sum(-1)
        m = mn
    rl = 1.0 / l
    o = torch.zeros(q.shape)
    for t0 in range(0, s.shape[-1], tile):
        p = _bf16(torch.exp(s[..., t0:t0 + tile] - m[..., None]) * rl[..., None])
        o = o + p @ v[..., t0:t0 + tile, :]
    return _bf16(o)


@pytest.mark.parametrize("s,grid", [(1025, None), (769, (24, 32))])
def test_two_pass_order_matches_mha_in_bfloat16(s, grid):
    heads, d = 2, 64
    rng = np.random.RandomState(s)
    q, k, v = (_bf16(T(rng.randn(heads, s, d).astype(np.float32))) for _ in range(3))
    bias = None
    if grid is not None:
        gh, gw = grid
        table = _bf16(T(rng.randn((2 * gh - 1) * (2 * gw - 1) + 3, heads).astype(np.float32) * 2))
        bias = np.array(j_rel_bias(jnp.asarray(table.numpy()), gh, gw), np.float32)
    jb = [jnp.asarray(t.numpy()[None], jnp.bfloat16) for t in (q, k, v)]
    ref = np.asarray(mha(*jb, d ** -0.5, None if bias is None else jnp.asarray(bias)).astype(jnp.float32))[0]
    got = two_pass_attention(q, k, v, d ** -0.5, None if bias is None else T(bias)).numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -8 * np.abs(ref).max()
