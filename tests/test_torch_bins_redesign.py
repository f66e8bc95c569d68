"""K8 as redesigned for Hopper (``ops/bins.py``, ``csrc/bins.cu``): each
kernel takes in the bilinear align-corners resize of the bin centres that
the JAX layers apply before their math, so its plain version is that resize
followed by the math. On the CPU:

- the fused plain ``attractor_update`` against JAX's ``_interp`` and the
  ``AttractorLayerUnnormed`` / ``AttractorLayerNormed`` math
  (``patchrefinerv2_tpu/models/backbones/zoedepth.py:118-170``), at the
  flagship's 2x ratio (few bins), an odd ratio and equal sizes: float32 max
  |port - JAX| / max |JAX| < 1e-5 (the same float32 steps; the resize's
  taps summed in another order), bfloat16 < 1e-2 (each side rounds every
  step to bfloat16; where the centres are resized, JAX's layer math takes
  them as the port makes them, resized in float32 and rounded once, and
  the port's resize is held to a float64 one on its own);
- the port's ``ConditionalLogBinomial`` with the fused plain
  ``log_binomial_depth`` against JAX's ``ConditionalLogBinomial`` and the
  expectation over ``_interp(b_centers)`` (:368-376), at a 2x upsampling and
  at the identity: rtol 1e-5, atol 2e-5 (float32 in another order; the
  softmax divides its logits by temperatures down to 0.0212);
- the launch plans: a full wave of blocks at the flagship's levels, every
  (pixel, bin) taken once with ragged sizes, the log-binomial kernel's
  staged columns holding every tap;
- the ZoeDepth head resizes no bin centres through K2 any more.
Inputs are numpy arrays from a seed, handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import patchrefinerv2_tpu.models.backbones.zoedepth as Z

from patchrefinerv2_torch.models.backbones import zoedepth as PZ
from patchrefinerv2_torch.models.backbones.zoedepth import ConditionalLogBinomial, ZoeDepthHead
from patchrefinerv2_torch.models.blocks.convs import to_nchw
from patchrefinerv2_torch.ops.bins import attractor_update, launch_plan, log_binomial_plan
from patchrefinerv2_torch.ops.resize import axis_taps, resize_plain

# (h, w) of the previous centres -> (H, W) of the layer
SIZE_PAIRS = [((12, 16), (24, 32)), ((7, 9), (13, 17)), ((6, 8), (6, 8))]
FLAGSHIP_LEVELS = [((24, 32), 16), ((48, 64), 8), ((96, 128), 4), ((192, 256), 1)]


def _jax_attractor(a, b_prev, kind, attractor_type, normed, lo=1e-3, hi=10.0, b_centers=None):
    """zoedepth.py:124-131 (unnormed) and :159-170 (normed) from the
    attractor points on, the previous centres resized by ``_interp`` unless
    ``b_centers`` gives them."""
    a = jnp.asarray(a)
    if b_centers is None:
        b_centers = Z._interp(jnp.asarray(b_prev), a.shape[1:3])
    dist = Z.inv_attractor if attractor_type == "inv" else Z.exp_attractor
    dx = a[..., :, None] - b_centers[..., None, :]
    delta = dist(dx, Z._ATTRACTOR_ALPHA, Z._ATTRACTOR_GAMMA)
    delta = delta.mean(axis=-2) if kind == "mean" else delta.sum(axis=-2)
    b_new = b_centers + delta
    if not normed:
        return b_new, b_new
    centers = jnp.clip(jnp.sort((hi - lo) * b_new + lo, axis=-1), lo, hi)
    return b_new, centers


def _max_rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(got.float().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("attractor_type", ["inv", "exp"])
@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("src,out", SIZE_PAIRS)
def test_fused_attractor_matches_jax_resize_and_layer_math(src, out, kind, attractor_type, normed):
    rng = np.random.RandomState(12)
    a = (rng.rand(2, *out, 5) * (1.0 if normed else 3.0)).astype(np.float32)
    b_prev = (rng.rand(2, *src, 12) * (1.0 if normed else 3.0)).astype(np.float32)
    b_j, c_j = _jax_attractor(a, b_prev, kind, attractor_type, normed)
    b_new, centers = attractor_update(torch.from_numpy(a), torch.from_numpy(b_prev), kind,
                                      attractor_type, normed, 1e-3, 10.0)
    assert b_new.shape == (2, *out, 12) and centers.shape == (2, *out, 12)
    assert _max_rel(b_new, b_j) < 1e-5
    assert _max_rel(centers, c_j) < 1e-5


def _f64_resize(b, size):
    """The align-corners bilinear resize of ``b`` (B, h, w, C) to ``size``
    in float64, written out with numpy."""
    b = b.astype(np.float64)

    def axis(n, out):
        src = np.arange(out) * ((n - 1) / (out - 1) if out > 1 else 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), n - 1)
        return i0, np.minimum(i0 + 1, n - 1), src - i0

    y0, y1, fy = axis(b.shape[1], size[0])
    x0, x1, fx = axis(b.shape[2], size[1])
    rows = b[:, y0] * (1 - fy)[:, None, None] + b[:, y1] * fy[:, None, None]
    return rows[:, :, x0] * (1 - fx)[:, None] + rows[:, :, x1] * fx[:, None]


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("attractor_type", ["inv", "exp"])
@pytest.mark.parametrize("src,out", SIZE_PAIRS)
def test_fused_attractor_matches_jax_in_bfloat16(src, out, attractor_type, normed):
    """In bfloat16 both sides round every step of the layer math to
    bfloat16: the port holds to JAX within 1e-2 of max |JAX|. Where the
    centres are resized, the port (K2) resizes with float32 taps and rounds
    once, while JAX's bfloat16 resize rounds its weights and each axis
    (``ops/resize.py:252-259``), which alone puts the two ~1e-2 apart
    (1.05e-2 at 12x16 -> 24x32); so there JAX's layer math takes the
    centres as the port makes them, JAX's float32 ``_interp`` of the same
    bfloat16 centres rounded once to bfloat16, and the port's resize is
    held on its own to a float64 one: within one bfloat16 rounding of it
    (2^-8 relative), and no further from it than JAX's bfloat16 resize.
    ``b_new`` is also held element by element to one bfloat16 rounding of
    JAX's (the normed centres differ by one where JAX rounds max - min to
    bfloat16 before the product)."""
    rng = np.random.RandomState(13)
    a = (rng.rand(1, *out, 4) * (1.0 if normed else 3.0)).astype(np.float32)
    b_prev = (rng.rand(1, *src, 12) * (1.0 if normed else 3.0)).astype(np.float32)
    bf = jnp.bfloat16
    a16, b16 = torch.from_numpy(a).bfloat16(), torch.from_numpy(b_prev).bfloat16()
    b_centers = None
    if src != out:
        b_centers = Z._interp(jnp.asarray(b16.float().numpy()), out).astype(bf)
        port_c = resize_plain(b16, out, "bilinear", True).double().numpy()
        jax_c = np.asarray(Z._interp(jnp.asarray(b_prev, bf), out).astype(jnp.float32), np.float64)
        exact = _f64_resize(b16.float().numpy(), out)
        port_err, jax_err = np.abs(port_c - exact), np.abs(jax_c - exact)
        assert (port_err <= 2.0 ** -8 * np.abs(exact) + 1e-6).all()
        assert port_err.max() <= jax_err.max(), (port_err.max(), jax_err.max())
    outs_j = _jax_attractor(jnp.asarray(a, bf), jnp.asarray(b_prev, bf), "mean", attractor_type, normed,
                            b_centers=b_centers)
    outs = attractor_update(a16, b16, "mean", attractor_type, normed, 1e-3, 10.0)
    for name, got, ref in zip(("b_new", "centers"), outs, outs_j):
        assert got.dtype == torch.bfloat16
        assert _max_rel(got, ref) < 1e-2, name
    # the roundings pinned: every element of b_new within one bfloat16
    # rounding of JAX's (2^-8 relative), which the same math rounded only at
    # its end misses at hundreds of elements
    ref = np.asarray(jnp.asarray(outs_j[0], jnp.float32))
    assert (np.abs(outs[0].float().numpy() - ref) <= 2.0 ** -8 * np.abs(ref)).all()


def _mlp_state(node, key):
    """A JAX two-conv MLP ({Conv_0, Conv_1}) as the port's ``key.{0,2}`` weights."""
    sd = {}
    for i, name in ((0, "Conv_0"), (2, "Conv_1")):
        sd[f"{key}.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(node[name]["kernel"]), (3, 2, 0, 1))))
        sd[f"{key}.{i}.bias"] = torch.from_numpy(np.asarray(node[name]["bias"]))
    return sd


@pytest.mark.parametrize("n_bins,min_temp", [(64, 0.0212), (16, 5.0)])
@pytest.mark.parametrize("src", [(3, 4), (6, 8)])
def test_fused_log_binomial_matches_jax_probabilities_and_resized_centres(src, n_bins, min_temp):
    from tests.test_torch_modules import init_random

    rng = np.random.RandomState(14)
    x = rng.randn(2, 6, 8, 12).astype(np.float32)
    cond = rng.randn(2, 6, 8, 8).astype(np.float32)
    centers = np.sort(rng.rand(2, *src, n_bins) * 80, axis=-1).astype(np.float32)
    jm = Z.ConditionalLogBinomial(n_bins, bottleneck=10, min_temp=min_temp, max_temp=50.0)
    v = init_random(jm, 15, jnp.asarray(x), jnp.asarray(cond))
    probs = jm.apply(v, jnp.asarray(x), jnp.asarray(cond))
    ref = np.asarray(jnp.sum(probs * Z._interp(jnp.asarray(centers), probs.shape[1:3]), axis=-1,
                             keepdims=True))
    port = ConditionalLogBinomial(20, n_bins, 10, min_temp, 50.0).eval()
    port.load_state_dict(_mlp_state(v["params"], "mlp"))
    nchw = lambda t: to_nchw(torch.from_numpy(np.ascontiguousarray(t)))  # noqa: E731
    with torch.no_grad():
        got = port(nchw(x), nchw(cond), nchw(centers))
    assert tuple(got.shape) == (2, 1, 6, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("out,na", FLAGSHIP_LEVELS)
def test_attractor_plan_fills_the_card_at_the_flagship_levels(out, na, itemsize):
    plan = launch_plan(1, out, na, 64, itemsize)
    assert int(np.prod(plan["grid"])) >= 132
    assert plan["threads"] <= 256 and plan["vec"] in (2, 16 // itemsize)
    assert 64 % plan["vec"] == 0 and plan["tpp"] * plan["groups"] * plan["vec"] >= 64


def _covered(batch, out, nb, plan) -> np.ndarray:
    """How often the kernel's threads take each (image, row, column, bin),
    by its mapping: grid (segments, rows, images), block (tpp, pix), bins
    [(lane + i tpp) vec, + vec) of column segment * pix + j."""
    h, w = out
    seen = np.zeros((batch, h, w, nb), np.int64)
    gx, gy, gz = plan["grid"]
    assert (gy, gz) == (h, batch) and gx * plan["pix"] >= w > (gx - 1) * plan["pix"]
    for bx in range(gx):
        for j in range(plan["pix"]):
            x = bx * plan["pix"] + j
            if x >= w:
                continue
            for lane in range(plan["tpp"]):
                for gi in range(plan["groups"]):
                    k0 = (lane + gi * plan["tpp"]) * plan["vec"]
                    if k0 < nb:
                        assert k0 + plan["vec"] <= nb
                        seen[:, :, x, k0:k0 + plan["vec"]] += 1
    return seen


@pytest.mark.parametrize("batch,out,na,nb,itemsize,align,normed", [
    (1, (24, 32), 16, 64, 2, 16, False), (1, (192, 256), 1, 64, 2, 16, False),
    (2, (13, 17), 3, 12, 4, 16, True), (1, (7, 5), 16, 13, 2, 16, True),
    (3, (5, 9), 1, 1024, 2, 16, True), (1, (9, 11), 2, 16, 2, 2, False),
    (1, (96, 128), 4, 64, 4, 8, False), (2, (1, 1), 1, 1, 4, 4, False),
])
def test_attractor_plan_takes_every_pixel_and_bin_once(batch, out, na, nb, itemsize, align, normed):
    plan = launch_plan(batch, out, na, nb, itemsize, normed, align)
    assert plan["threads"] <= 256
    assert align % (plan["vec"] * itemsize) == 0 or plan["vec"] == 1
    if normed:
        assert plan["np"] >= nb and plan["np"] & (plan["np"] - 1) == 0
        assert plan["smem"] == 4 * plan["pix"] * plan["np"] <= 48 * 1024
    assert (_covered(batch, out, nb, plan) == 1).all()


@pytest.mark.parametrize("src,out,k,batch,itemsize", [
    ((192, 256), (384, 512), 64, 1, 2), ((192, 256), (384, 512), 64, 1, 4),
    ((7, 9), (13, 17), 64, 2, 2), ((13, 17), (13, 17), 16, 1, 4), ((4, 5), (9, 11), 12, 1, 2),
    ((3, 4), (5, 7), 1024, 1, 2), ((40, 300), (20, 100), 64, 1, 2),
])
def test_log_binomial_plan_stages_every_tap(src, out, k, batch, itemsize):
    plan = log_binomial_plan(src, out, k, batch, itemsize)
    if (src, out) == ((192, 256), (384, 512)):
        assert plan["staged"] and plan["registers"] and int(np.prod(plan["grid"])) >= 132
    assert plan["bw"] <= 128 and plan["grid"] == (-(-out[1] // plan["bw"]), out[0], batch)
    if not plan["staged"]:
        assert k % (16 // itemsize) or plan["smem"] == 0
        return
    assert k % (16 // itemsize) == 0 and plan["smem"] == 4 * plan["cols"] * (k + 4) <= 48 * 1024
    idx = (np.stack([np.arange(out[1])] * 2) if src[1] == out[1]
           else axis_taps(src[1], out[1], "bilinear", True)[0])
    for x0 in range(0, out[1], plan["bw"]):
        seg = idx[:, x0:x0 + plan["bw"]]
        lo = seg[0, 0]
        assert seg.min() >= lo and seg.max() - lo < plan["cols"]


def test_zoedepth_head_resizes_no_bin_centres_through_k2(monkeypatch):
    """The head's remaining K2 resizes are the four previous embeddings,
    the relative depth and the last embedding; the bin centres (12
    channels here) go to the K8 kernels at their own sizes."""
    head = ZoeDepthHead(btl_ch=8, block_chs=[8] * 4, n_midas_out=4, n_bins=12, bin_embedding_dim=6,
                        n_attractors=(4, 2, 2, 1), attractor_kind="mean", attractor_type="inv",
                        min_temp=0.0212, max_temp=50.0).eval()
    calls = []
    real = PZ.interp

    def counting(x, size):
        calls.append(x.shape[1])
        return real(x, size)

    monkeypatch.setattr(PZ, "interp", counting)
    g = torch.Generator().manual_seed(0)
    sizes = [(2, 2), (4, 4), (8, 8), (16, 16), (32, 32)]
    pyramid = [torch.randn(1, 4, 64, 64, generator=g), torch.randn(1, 8, *sizes[0], generator=g)]
    pyramid += [torch.randn(1, 8, *s, generator=g) for s in sizes[1:]]
    with torch.no_grad():
        out = head.head_forward(torch.randn(1, 1, 32, 32, generator=g), pyramid)
    assert tuple(out["metric_depth"].shape) == (1, 1, 64, 64)
    assert bool(torch.isfinite(out["metric_depth"]).all())
    assert sorted(calls) == [1] + [6] * 5


def test_sass_summary_counts_the_innermost_loops():
    """``utils/sass.summary`` on a listing of two nested loops: the inner
    one is reported with its length and opcode counts, predicated
    instructions by their opcode."""
    from patchrefinerv2_torch.utils.sass import summary

    ins = [(0x00, "S2R R0, SR_TID.X"), (0x10, "MUFU.RCP R1, R0"), (0x20, "FMUL R2, R1, R1"),
           (0x30, "MUFU.RCP R3, R2"), (0x40, "@P0 MUFU.EX2 R4, R3"), (0x50, "@P1 BRA 0x30"),
           (0x60, "IADD3 R5, R5, 0x1, RZ"), (0x70, "@P2 BRA 0x10"), (0x80, "EXIT")]
    out = summary(ins, ["MUFU.RCP", "MUFU.EX2", "BRA"])
    assert out["instructions"] == 9 and out["MUFU.RCP"] == 2 and out["BRA"] == 2
    assert out["loops"] == [dict(range=["0x30", "0x50"], length=3, **{"MUFU.RCP": 1, "MUFU.EX2": 1,
                                                                      "BRA": 1})]
