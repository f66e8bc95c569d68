"""What the redesigned K10 product kernel (``csrc/quant_conv.cu``, a
warp-specialised ``wgmma`` implicit GEMM fed by TMA) promises, pinned on
the CPU, where the kernel cannot run.

(a) The host's launch plan (``ops/quant.launch_plan``) at the 15 int8 sites
of the flagship's 16- and 8-patch chunks and DA2's 16-patch chunk, and at
the card's edge cases: the N tiles of each site, the ring's depth, the
shared memory of a block within the card's 232448 bytes, and a grid whose
blocks cover every output pixel and channel.

(b) The weight format's index contract (``format_weight``): the layout
the kernel's weight tensor map reads.

(c) A numpy model of the kernel's addressing: the quantize pass's scratch
(NHWC, or the two column-parity planes at a phased site, an odd width
padded by a zero column), each block's halo box as TMA loads it (zeros
outside the map), the weights' box (zeros past Cout), the shared-memory
descriptors of the A and B operands (K-major, no swizzle: core matrices of
8 rows by 16 bytes, the two channel halves ``lbo`` bytes apart, 8-row
groups 128 bytes apart) shifted per tap and run, and the epilogue's map
from accumulator rows to pixels. Its int32 sums must equal
``int8_conv_sums`` exactly, and at phased sites the phased sums of
``quant_conv_plain`` (each output pixel summed with its phase's weights).
"""

import numpy as np
import pytest
import torch

from patchrefinerv2_torch.ops import quant as pq
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

# the 15 int8 sites of a chunk (chip_smoke.quant_sites): (input widths,
# Cout, divisor of the process shape, phased, how many of the chunk)
SITES = [
    ((256,), 256, 4, False, 2), ((256, 256), 256, 4, False, 2), ((256,), 256, 2, False, 2),
    ((256, 256), 256, 2, False, 2), ((256,), 128, 1, False, 1), ((322,), 322, 4, False, 1),
    ((322,), 128, 4, False, 1), ((194,), 194, 2, False, 1),
]


def head_sites(h2):
    return [((128,), h2, 1, False, 1), ((h2,), h2, 1, True, 1), ((h2, h2), h2, 1, True, 1)]


PATHS = {"flagship": ((384, 512), 32), "da2": ((448, 448), 128)}

# (Cout, phased) -> the N tiles the plan must pick
N_SPLITS = {
    (256, False): [(128, 2)], (128, False): [(128, 1)], (322, False): [(128, 2), (80, 1)],
    (194, False): [(128, 1), (80, 1)], (32, False): [(32, 1)], (32, True): [(32, 1)],
    (128, True): [(32, 4)], (8, False): [(8, 1)], (72, False): [(80, 1)], (1, False): [(8, 1)],
    (20, False): [(32, 1)], (24, False): [(32, 1)], (64, False): [(80, 1)],
}


def _check_plan(n, h, w, cin, cout, k, phased):
    plan = pq.launch_plan(n, h, w, cin, cout, k, phased)
    segs = plan["segments"]
    assert 1 <= len(segs) <= 2
    cols = -(-w // 2) if phased else w
    # the pixel tiles cover every output pixel (phased: every plane column
    # of both column phases)
    assert plan["pixel_tiles"] == n * -(-h // pq.ROWS) * -(-cols // pq.RUN)
    assert -(-h // pq.ROWS) * pq.ROWS >= h and -(-cols // pq.RUN) * pq.RUN * (2 if phased else 1) >= w
    covered = 0
    for sg in segs:
        assert sg["n"] in pq.N_TILES[phased]
        assert 1 <= sg["stages"] <= pq.MAX_STAGES
        assert sg["smem"] <= pq.SMEM_MAX
        # a deeper ring would not fit, unless the ring is as deep as it may be
        assert sg["stages"] == pq.MAX_STAGES or sg["smem"] + sg["stage_bytes"] > pq.SMEM_MAX
        assert sg["work"] == plan["pixel_tiles"] * sg["tiles"]
        covered += sg["n"] * sg["tiles"]
    # the tiles cover every channel, the last one holding the last channel
    assert covered >= cout and covered - segs[-1]["n"] < cout
    assert covered == sum(pq.n_tiles(cout, phased))
    return plan


@pytest.mark.parametrize("path,batch", [("flagship", 16), ("flagship", 8), ("da2", 16)])
def test_launch_plan_at_the_sites(path, batch):
    (ph, pw), h2 = PATHS[path]
    sites = SITES + head_sites(h2)
    assert sum(s[4] for s in sites) == 15
    for widths, cout, div, phased, _ in sites:
        h, w, cin = ph // div, pw // div, sum(widths)
        plan = _check_plan(batch, h, w, cin, cout, 3, phased)
        assert [(sg["n"], sg["tiles"]) for sg in plan["segments"]] == N_SPLITS[(cout, phased)]
        # every 256-wide site runs 128-channel tiles in a 3-stage ring
        # beside its output tiles
        if cout == 256:
            assert plan["segments"][0]["stages"] == 3
        nch = -(-cin // 32)
        assert plan["xq_shape"] == ((batch, h, 2 * nch, 2, -(-w // 2), 16) if phased
                                    else (batch, h, 2 * nch, 1, w, 16))


EDGE_SHAPES = [
    ((1, 5, 7), 1, 1, 3, False), ((2, 9, 1), 33, 8, 3, False), ((1, 1, 13), 98, 20, 3, False),
    ((3, 11, 19), 98, 322, 3, False), ((2, 7, 30), 1056, 20, 1, False), ((1, 6, 9), 24, 20, 3, False),
    ((1, 9, 17), 64, 64, 3, False), ((1, 2, 2), 32, 32, 3, True), ((1, 34, 36), 64, 32, 3, True),
    ((2, 5, 7), 64, 32, 3, True), ((1, 18, 40), 256, 128, 3, True), ((1, 20, 18), 128, 32, 3, False),
    ((1, 6, 63), 194, 72, 3, False), ((1, 5, 64), 322, 322, 3, False), ((2, 3, 65), 33, 8, 3, False),
    ((1, 4, 112), 256, 256, 3, False), ((1, 3, 224), 128, 128, 3, False), ((1, 7, 5), 32, 32, 3, True),
]


@pytest.mark.parametrize("shape,cin,cout,k,phased", EDGE_SHAPES)
def test_launch_plan_at_the_edge_cases(shape, cin, cout, k, phased):
    n, h, w = shape
    _check_plan(n, h, w, cin, cout, k, phased)
    if (cout, phased) in N_SPLITS:
        plan = pq.launch_plan(n, h, w, cin, cout, k, phased)
        assert [(sg["n"], sg["tiles"]) for sg in plan["segments"]] == N_SPLITS[(cout, phased)]


def test_launch_plan_stage_bytes():
    """The stage sizes the kernel's ``Geo`` computes: the halo's box (rows,
    channel halves, planes, columns of 16 bytes), padded to 128 bytes, and
    the N tile's weights of one k-step; the output tiles (``Out``: a run's
    RUN rows of N outputs, bfloat16 rows padded by 16 bytes, for each run of
    each consumer)."""
    p = pq.launch_plan(16, 192, 256, 256, 256, 3, False)
    assert p["halo"] == (6, 2, 1, 66) and p["runs"] == 2
    sg = p["segments"][0]
    assert sg["stage_bytes"] == 12672 + 2 * 9 * 128 * 16 and sg["out_bytes"] == 2 * 2 * 64 * 272
    assert sg["stages"] == 3 and sg["smem"] == 384 + 69632 + 3 * 49536
    assert sg["tx_bytes"] == 6 * 2 * 66 * 16 + 2 * 9 * 128 * 16
    # float32: unpadded output tiles of twice the bytes, a ring of 2
    sg = pq.launch_plan(16, 192, 256, 256, 256, 3, False, itemsize=4)["segments"][0]
    assert sg["out_bytes"] == 131072 and sg["stages"] == 2 and sg["smem"] <= pq.SMEM_MAX
    p = pq.launch_plan(16, 384, 512, 64, 32, 3, True)
    assert p["halo"] == (6, 2, 2, 66) and p["runs"] == 4
    sg = p["segments"][0]
    assert sg["stage_bytes"] == 25344 + 4 * 2 * 9 * 32 * 16 and sg["stages"] == 3
    assert sg["out_bytes"] == 2 * 4 * 64 * 80
    p = pq.launch_plan(16, 96, 128, 322, 322, 3, False)
    assert [sg["stages"] for sg in p["segments"]] == [3, 4]
    p = pq.launch_plan(2, 7, 30, 1056, 20, 1, False)
    assert p["halo"] == (4, 2, 1, 64) and p["taps"] == 1


# ---------------------------------------------------------------- (b) weights
@pytest.mark.parametrize("phased,cout", [(False, 20), (False, 322), (True, 20), (True, 128)])
def test_format_weight_index_contract(phased, cout):
    g = torch.Generator().manual_seed(cout)
    cin, k = 40, 3
    lead = (pq.PHASES,) if phased else ()
    kq = torch.randint(-127, 128, (*lead, cout, cin, k, k), generator=g).to(torch.int8)
    wf = pq.format_weight(kq).numpy()
    nph = pq.PHASES if phased else 1
    widths = pq.n_tiles(cout, phased)
    assert wf.shape == (2 * 32 * nph * 9 * sum(widths),) and wf.dtype == np.int8
    q = kq.numpy() if phased else kq.numpy()[None]
    o_t = 0
    for nt in widths:
        start = o_t * 2 * 32 * nph * 9
        block = wf[start:start + 2 * nph * 2 * 9 * nt * 16].reshape(2, nph, 2, 9, nt, 16)
        for s_ in range(2):
            for ph in range(nph):
                for h in range(2):
                    for tap in range(9):
                        c = 32 * s_ + 16 * h + np.arange(16)
                        o = o_t + np.arange(nt)
                        want = np.zeros((nt, 16), np.int8)
                        ok_c, ok_o = c < cin, o < cout
                        want[np.ix_(ok_o, ok_c)] = q[ph][np.ix_(o[ok_o], c[ok_c])][:, :, tap // 3, tap % 3]
                        np.testing.assert_array_equal(block[s_, ph, h, tap], want)
        o_t += nt


# ---------------------------------------------------------------- (c) addressing model
def _scratch(xq, phased):
    """The quantize pass's int8 scratch for NHWC int8 ``xq``:
    [n][h][c / 16][plane][x][16], channels zero-padded to 32; one plane of W
    columns, or the two column-parity planes of ceil(W / 2) columns (pixel
    (h, 2x + plane)) with an odd W's last column of plane 1 zero."""
    n, h, w, cin = xq.shape
    cp = -(-cin // 32) * 32
    x = np.zeros((n, h, w, cp), np.int8)
    x[..., :cin] = xq
    if phased:
        w2 = -(-w // 2)
        planes = np.zeros((n, h, 2, w2, cp), np.int8)
        planes[:, :, 0, :len(range(0, w, 2))] = x[:, :, 0::2]
        planes[:, :, 1, :len(range(1, w, 2))] = x[:, :, 1::2]
    else:
        planes = x[:, :, None]
    pl, xw = planes.shape[2:4]
    return planes.reshape(n, h, pl, xw, cp // 16, 16).transpose(0, 1, 4, 2, 3, 5).copy()


def _box(t, starts, box):
    """A TMA tiled box of ``t`` (dims listed innermost first) at signed
    ``starts``: zeros outside the tensor."""
    t_dims = t.shape[::-1]
    out = np.zeros(box[::-1], t.dtype)
    src, dst = [], []
    for s, b, size in zip(starts, box, t_dims):
        lo, hi = max(s, 0), min(s + b, size)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst[::-1])] = t[tuple(src[::-1])]
    return out


def _operand(stage, start, lbo, rows):
    """The rows x 32 int8 operand a K-major, unswizzled descriptor at
    ``start`` reads: row m's half h at start + h * lbo + (m // 8) * 128 +
    (m % 8) * 16."""
    m = np.arange(rows)
    base = start + (m // 8) * 128 + (m % 8) * 16
    idx = np.concatenate([base[:, None] + np.arange(16), base[:, None] + lbo + np.arange(16)], axis=1)
    return stage[idx].astype(np.int64)


def model_sums(xq, kq, phased, k):
    """The kernel's int32 sums for int8 NHWC ``xq`` and int8 weights ``kq``
    ((Cout, Cin, k, k), or (4, Cout, Cin, 3, 3) phased), by its addressing:
    the persistent walk over each segment's tiles, the halo box in 8-byte
    elements, the weights' bulk copy, the descriptors and the epilogue."""
    n, h, w, cin = xq.shape
    cout = kq.shape[-4]
    plan = pq.launch_plan(n, h, w, cin, cout, k, phased)
    hr, _, pl, hc = plan["halo"]
    taps, nph, runs, nch = plan["taps"], plan["phases"], plan["runs"], plan["nchunk"]
    scratch = _scratch(xq, phased)
    # the tensor map's view in 8-byte elements: (x: 2 xw, plane, half, y, n)
    xview = scratch.view(np.int64).reshape(n, h, 2 * nch, pl, -1)
    xw = xview.shape[-1] // 2
    wf = pq.format_weight(torch.from_numpy(kq)).numpy()
    a_box = hr * 2 * pl * hc * 16
    a_pad = -(-a_box // 128) * 128
    tiles_x, tiles_y = -(-xw // pq.RUN), -(-h // pq.ROWS)
    acc = np.zeros((n, h, w, cout), np.int64)
    seen = np.zeros((n, h, w, cout), np.int64)
    n0 = 0
    for sg in plan["segments"]:
        nt_w = sg["n"]
        b_lbo = taps * nt_w * 16
        b_bytes = nph * 2 * b_lbo
        wseg = wf[n0 * nch * 32 * nph * taps:]
        for t in range(sg["work"]):
            nt, pt = t % sg["tiles"], t // sg["tiles"]
            nn, tr = pt // (tiles_x * tiles_y), pt % (tiles_x * tiles_y)
            y0, c0 = tr // tiles_x * pq.ROWS, tr % tiles_x * pq.RUN
            nb = n0 + nt * nt_w
            a = np.zeros((2, runs, pq.RUN, nt_w), np.int64)  # [consumer][run][m][n]
            for ch in range(nch):
                halo = _box(xview, (2 * (c0 - k // 2), 0, 2 * ch, y0 - k // 2, nn), (2 * hc, pl, 2, hr, 1))
                stage = np.zeros(a_pad + b_bytes, np.int8)
                stage[:a_box] = halo.view(np.int8).reshape(-1)
                wstart = (nt * nch + ch) * b_bytes
                stage[a_pad:] = wseg[wstart:wstart + b_bytes]
                for cw in range(2):
                    for tap in range(taps):
                        du, dv = tap // k, tap % k
                        for r in range(runs):
                            row = 2 * cw + (r // 2 if phased else r)
                            dj = r % 2
                            plane = (dj + dv + 1) & 1 if phased else 0
                            col = 1 + (dj + dv - 1 - plane) // 2 if phased else dv
                            ph = 2 * (r // 2) + dj if phased else 0
                            A = _operand(stage, (((row + du) * 2 * pl + plane) * hc + col) * 16, pl * hc * 16,
                                         pq.RUN)
                            B = _operand(stage, a_pad + (ph * 2 * taps + tap) * nt_w * 16, b_lbo, nt_w)
                            a[cw, r] += A @ B.T
            # the epilogue's pixels
            for cw in range(2):
                for r in range(runs):
                    iy = y0 + 2 * cw + (r // 2 if phased else r)
                    if iy >= h:
                        continue
                    for m in range(pq.RUN):
                        ix = 2 * (c0 + m) + r % 2 if phased else c0 + m
                        if ix >= w:
                            continue
                        c = np.arange(nb, min(nb + nt_w, cout))
                        acc[nn, iy, ix, c] = a[cw, r, m, :len(c)]
                        seen[nn, iy, ix, c] += 1
        n0 += nt_w * sg["tiles"]
    assert (seen == 1).all(), "every output written exactly once"
    return acc


def _ints(g, shape):
    return torch.randint(-127, 128, shape, generator=g).to(torch.int8)


MODEL_CASES = [  # (n, h, w), cin, cout, k
    ((1, 3, 1), 33, 8, 3), ((1, 5, 5), 1, 8, 3), ((2, 2, 63), 194, 72, 3), ((1, 3, 64), 33, 322, 3),
    ((1, 2, 65), 322, 8, 3), ((1, 1, 112), 33, 72, 3), ((1, 2, 224), 1, 8, 3), ((1, 5, 7), 194, 322, 1),
    ((1, 6, 65), 33, 72, 1),
]


@pytest.mark.parametrize("shape,cin,cout,k", MODEL_CASES)
def test_addressing_model_plain(shape, cin, cout, k):
    g = torch.Generator().manual_seed(sum(shape) * 31 + cin + cout + k)
    xq, kq = _ints(g, (*shape, cin)), _ints(g, (cout, cin, k, k))
    want = pq.int8_conv_sums(xq, kq).numpy()
    np.testing.assert_array_equal(model_sums(xq.numpy(), kq.numpy(), False, k), want)


PHASED_CASES = [((1, 2, 2), 32, 32), ((1, 5, 7), 33, 8), ((2, 5, 7), 64, 32), ((1, 3, 65), 1, 72),
                ((1, 4, 129), 33, 128), ((1, 1, 1), 32, 8)]


@pytest.mark.parametrize("shape,cin,cout", PHASED_CASES)
def test_addressing_model_phased(shape, cin, cout):
    """Each output pixel's sums with its own phase's weights, as
    ``quant_conv_plain`` takes them (through unit scales and no bias, so its
    float output is the sums)."""
    g = torch.Generator().manual_seed(sum(shape) * 17 + cin + cout)
    xq, kq = _ints(g, (*shape, cin)), _ints(g, (pq.PHASES, cout, cin, 3, 3))
    ph = pq.pixel_phase(shape[1], shape[2])
    want = sum(pq.int8_conv_sums(xq, kq[p]) * (ph == p)[None, :, :, None] for p in range(pq.PHASES))
    # quant_conv_plain's phased sums: unit scales keep the integers
    plain = pq.quant_conv_plain([xq.double()], kq, torch.ones(pq.PHASES, cin), torch.ones(pq.PHASES, cout))
    np.testing.assert_array_equal(plain.numpy(), want.double().numpy())
    np.testing.assert_array_equal(model_sums(xq.numpy(), kq.numpy(), True, 3), want.numpy())
