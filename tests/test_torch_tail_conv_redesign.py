"""What the redesigned K9 (``csrc/tail_conv.cu``: bfloat16 on a persistent
warp-specialised ``wgmma`` implicit GEMM fed by a streamed ring of halo and
weight k-steps) promises, pinned on the CPU, where the kernel cannot run.

(a) The host's launch plan (``ops/tail_conv.launch_plan``) at the 9 tail
sites of the flagship and DA2 chunks (16 and 8 patches) and the Cityscapes
network's, in both dtypes: the route, N, the tile, the ring's stages and
a block's shared memory within the card's 232448 bytes.

(b) A numpy model of the bfloat16 kernel's addressing: the producers' halo
cells (zeros outside the map and past Cin, the ReLU prologue), the weights'
k-step blocks as ``format_weight`` lays them out, the shared-memory
descriptors of the A and B operands (K-major, no swizzle: core matrices of
8 rows by 16 bytes, the two channel halves ``lbo`` bytes apart, 8-row
groups 128 bytes apart) shifted per tap and run, and the epilogue's map
from accumulator rows to pixels. Its sums must equal ``F.conv2d`` of the
concatenated parts, with an image edge inside a tile and the 1- and
98-channel parts.

(c) The weight cache (``formatted_weight``): one format per weight tensor,
made anew after an in-place ``copy_`` and after ``load_jax_params``.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from patchrefinerv2_tpu.models.blocks.convs import SingleConvCNNLN as JSingle
from patchrefinerv2_tpu.ops import s2d

from patchrefinerv2_torch.models.blocks.convs import SingleConvCNNLN
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests.test_torch_modules import init_random

# the module (``patchrefinerv2_torch.ops`` exports its wrapper under the same name)
tc = importlib.import_module("patchrefinerv2_torch.ops.tail_conv")


def sites(h2):
    """The 9 sites of a chunk (``chip_smoke.tail_sites``): (name, input
    widths, k, Cout, relu_in)."""
    return [("output_conv2", (128,), 3, h2, False), ("gcu_conv", (h2,), 3, h2, True),
            ("gcu_fusion_conv", (h2, h2), 3, h2, False), ("out_conv", (h2,), 1, h2, False),
            ("output_conv3", (h2,), 1, 1, False), ("fusion1_0", (h2, h2), 3, 32, False),
            ("fusion2_0", (32, 1, 1), 3, 32, False), ("f2r_agg_4_conv2", (98,), 3, 32, False),
            ("final_conv", (32,), 3, 1, False)]


PATHS = {"flagship": ((384, 512), 32), "da2": ((448, 448), 128), "cityscapes": ((384, 512), 32)}

# the plan every site must get: (route, N, runs, rows, stages) by (widths, k, Cout)
BF16_PLANS = {  # N, runs, rows, stages (route "wgmma")
    ((128,), 3, 32): (32, 4, 8, 6), ((32,), 3, 32): (32, 4, 8, 6), ((32, 32), 3, 32): (32, 4, 8, 6),
    ((32,), 1, 32): (32, 4, 8, 8), ((32, 1, 1), 3, 32): (32, 4, 8, 6), ((98,), 3, 32): (32, 4, 8, 6),
    ((128,), 3, 128): (128, 2, 4, 3), ((128, 128), 3, 128): (128, 2, 4, 3),
    ((128,), 1, 128): (128, 2, 4, 8), ((128, 128), 3, 32): (32, 4, 8, 6),
}

@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("batch", [16, 8])
def test_launch_plan_at_every_site(path, batch):
    (h, w), h2 = PATHS[path]
    for name, widths, k, cout, _ in sites(h2):
        p = tc.launch_plan(widths, k, cout, torch.bfloat16)
        f = tc.launch_plan(widths, k, cout, torch.float32)
        assert f["route"] == "mma" and f["n"] == tc.cout_pad(cout) and f["smem"] <= tc.SMEM_MAX
        assert f["tile"] == ((8, 16) if f["n"] == 128 else (16, 16))
        if cout <= 8:  # output_conv3, final_conv: the mma.sync kernel at N 8
            assert (p["route"], p["n"], p["tile"]) == ("mma", 8, (16, 16)) and p["smem"] <= tc.SMEM_MAX
            continue
        n, runs, rows, stages = BF16_PLANS[(widths, k, cout)]
        assert (p["route"], p["n"], p["runs"], p["tile"], p["stages"]) == ("wgmma", n, runs, (rows, 64), stages), name
        assert p["producers"] == (1 if n == 128 else 2)
        assert p["n"] >= cout and p["halo"] == (rows + k - 1, 2, 64 + k - 1)
        assert p["nk"] == -(-sum(widths) // 16)
        # the consumers' output tiles: runs x 64 pixel rows of N bfloat16 + 16 bytes each
        assert p["out_bytes"] == 2 * runs * 64 * (2 * n + 16)
        fixed = tc.WGMMA_FIXED + p["out_bytes"]
        assert p["smem"] == fixed + stages * p["stage_bytes"] <= tc.SMEM_MAX
        assert fixed + (stages + 1) * p["stage_bytes"] > tc.SMEM_MAX or stages == tc.MAX_STAGES
        # the accumulators of a consumer thread: runs x N / 2 floats
        assert runs * n // 2 <= 128
        # every output pixel in one tile: the grid over (batch, rows, 64-pixel runs)
        tiles = batch * -(-h // rows) * -(-w // 64)
        assert tiles * rows * 64 >= batch * h * w


def test_launch_plan_edge_shapes():
    """Cout 16 and 20 pad to N 32, Cout 72 to 128, Cout 8 takes the mma
    route, which keeps its weights whole when they fit."""
    assert tc.launch_plan((16,), 1, 16, torch.bfloat16)["n"] == 32
    assert tc.launch_plan((40,), 3, 72, torch.bfloat16)["n"] == 128
    assert tc.launch_plan((40,), 3, 8, torch.bfloat16)["route"] == "mma"
    assert tc.launch_plan((40,), 3, 9, torch.bfloat16)["route"] == "wgmma"
    assert tc.launch_plan((32,), 3, 1, torch.float32)["resident"]
    assert not tc.launch_plan((128, 128), 3, 128, torch.float32)["resident"]
    with pytest.raises(TypeError):
        tc.launch_plan((32,), 3, 32, torch.float16)


def _model(parts, weight, k, relu_in):
    """The bfloat16 kernel's sums by its own addressing, in float64."""
    widths = tuple(p.shape[-1] for p in parts)
    cout = weight.shape[0]
    plan = tc.launch_plan(widths, k, cout, torch.bfloat16)
    n_t, runs, (rows, run), (hr, _, hc) = plan["n"], plan["runs"], plan["tile"], plan["halo"]
    taps, r0 = k * k, k // 2
    x = np.concatenate(parts, axis=-1).astype(np.float64)
    if relu_in:
        x = np.maximum(x, 0)
    b, h, w, cin = x.shape
    wf = tc.format_weight(weight.to(torch.bfloat16)).float().numpy().astype(np.float64)
    assert wf.shape == (plan["nk"], 2, taps, n_t, 8)
    a_lbo, b_lbo = hc * 16, taps * n_t * 16  # bytes
    # element offsets (2 bytes an element) of a K-major operand: row m, channel kk
    m, kk = np.arange(64)[:, None], np.arange(16)[None, :]
    a_idx = (m // 8) * 64 + (m % 8) * 8 + (kk // 8) * (a_lbo // 2) + kk % 8
    nn = np.arange(n_t)[:, None]
    b_idx = (nn // 8) * 64 + (nn % 8) * 8 + (kk // 8) * (b_lbo // 2) + kk % 8
    y = np.zeros((b, h, w, n_t))
    hit = np.zeros((b, h, w), int)
    for n in range(b):
        for y0 in range(0, h, rows):
            for x0 in range(0, w, run):
                acc = np.zeros((2, runs, 64, n_t))
                for s in range(plan["nk"]):
                    cells = np.zeros((hr, 2, hc, 8))  # [row][half][column][8]
                    for hy in range(hr):
                        for hx in range(hc):
                            iy, ix = y0 + hy - r0, x0 + hx - r0
                            if 0 <= iy < h and 0 <= ix < w:
                                for half in range(2):
                                    c = x[n, iy, ix, 16 * s + 8 * half:16 * s + 8 * half + 8]
                                    cells[hy, half, hx, :c.size] = c
                    a_mem, b_mem = cells.reshape(-1), wf[s].reshape(-1)
                    for cw in range(2):
                        for r in range(runs):
                            row = cw * runs + r
                            for tap in range(taps):
                                du, dv = divmod(tap, k)
                                a = a_mem[((row + du) * 2 * hc + dv) * 8 + a_idx]
                                bm = b_mem[tap * n_t * 8 + b_idx]
                                acc[cw, r] += a @ bm.T
                for cw in range(2):
                    for r in range(runs):
                        iy = y0 + cw * runs + r
                        for mm in range(64):
                            ix = x0 + mm
                            if iy < h and ix < w:
                                y[n, iy, ix] = acc[cw, r, mm]
                                hit[n, iy, ix] += 1
    assert (hit == 1).all()  # each output pixel from exactly one run row
    assert not y[..., cout:].any()
    return y[..., :cout]


@pytest.mark.parametrize("shape,widths,k,cout,relu_in", [
    ((1, 9, 70), (32, 1, 1), 3, 32, False),   # fusion2_0: depth parts, edges inside tiles
    ((1, 5, 66), (98,), 3, 32, False),        # f2r_agg_4: 196-byte pixels, 7 k-steps
    ((2, 6, 64), (16,), 3, 12, True),         # Cout 12 (N 32), the ReLU prologue
    ((1, 5, 65), (32, 16), 3, 128, False),    # N 128, two runs a consumer
    ((1, 3, 70), (16,), 1, 20, False),        # 1x1, Cout 20 (N 32)
])
def test_wgmma_model_reproduces_the_conv(shape, widths, k, cout, relu_in):
    rng = np.random.RandomState(sum(widths) + cout)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    parts = [bf(rng.randn(*shape, c).astype(np.float32)) for c in widths]
    weight = torch.from_numpy(bf((rng.randn(cout, sum(widths), k, k) * 0.2).astype(np.float32)))
    got = _model(parts, weight, k, relu_in)
    x = torch.from_numpy(np.concatenate(parts, axis=-1)).double().permute(0, 3, 1, 2)
    if relu_in:
        x = torch.relu(x)
    ref = F.conv2d(x, weight.double(), padding=k // 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_format_weight_index_contract():
    """bfloat16: ``wf[s, h, tap, o, i] = weight[o, 16 s + 8 h + i, tap // k,
    tap % k]``, zeros past Cin and Cout; float32 keeps its chunk layout."""
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(20, 34, 3, 3).astype(np.float32))
    wf = tc.format_weight(w.to(torch.bfloat16)).float()
    assert tuple(wf.shape) == (3, 2, 9, 32, 8)
    wb = w.to(torch.bfloat16).float()
    for s, hh, tap, o, i in [(0, 0, 0, 0, 0), (1, 1, 4, 19, 7), (2, 0, 8, 3, 1), (2, 0, 8, 3, 2),
                             (2, 1, 5, 0, 0), (0, 1, 2, 25, 3)]:
        c = 16 * s + 8 * hh + i
        want = wb[o, c, tap // 3, tap % 3] if o < 20 and c < 34 else 0.0
        assert float(wf[s, hh, tap, o, i]) == float(want)
    assert tuple(tc.format_weight(w).shape) == (2, 9, 32, 32)
    # the mma route's layout for bfloat16 at Cout <= 8
    assert tuple(tc.format_weight(w[:8].to(torch.bfloat16)).shape) == (2, 9, 32, 8)


def test_formatted_weight_is_kept_and_made_anew_on_change():
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(8, 16, 3, 3).astype(np.float32)).to(torch.bfloat16)
    first = tc.formatted_weight(w)
    assert tc.formatted_weight(w) is first
    torch.testing.assert_close(first, tc.format_weight(w), rtol=0, atol=0)
    w.copy_(torch.from_numpy(rng.randn(8, 16, 3, 3).astype(np.float32)))  # in place: a new version
    second = tc.formatted_weight(w)
    assert second is not first
    torch.testing.assert_close(second, tc.format_weight(w), rtol=0, atol=0)
    w.data = torch.zeros_like(w)  # new storage
    assert not tc.formatted_weight(w).any()


def test_formatted_weight_follows_load_jax_params():
    """A tail block's conv weight formatted before ``load_jax_params`` is
    formatted anew after it, from the loaded values."""
    split = (8, 1, 1)
    parts = [np.random.RandomState(7).randn(1, 4, 6, c).astype(np.float32) for c in split]
    xs = jnp.concatenate([s2d.space_to_depth(jnp.asarray(p)) for p in parts], axis=-1)
    jm = JSingle(8, s2d_split=split)
    v = init_random(jm, 8, xs)
    port = SingleConvCNNLN(sum(split), 8, tail=True).eval()
    weight = next(p for p in port.parameters() if p.ndim == 4)
    before = tc.formatted_weight(weight)
    load_jax_params(port, v, part="SingleConvCNNLN")
    after = tc.formatted_weight(weight)
    assert after is not before and not torch.equal(after, before)
    torch.testing.assert_close(after, tc.format_weight(weight.detach()), rtol=0, atol=0)
