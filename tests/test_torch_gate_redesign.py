"""What the redesigned K5 (``csrc/gated_conv.cu``: bfloat16 on a persistent
kernel that streams tiles of f through a ring and runs the 1x1 on
``wgmma``) promises, pinned on the CPU, where the kernel cannot run.

(a) The host's launch plan (``ops/gated.launch_plan``) at the 10 sites of a
flagship and a DA2 chunk: the tile rows, the ring's stages, the block's
shared memory within the card's 232448 bytes, the grid; its constants
agree with the kernel's source.

(b) A numpy model of the kernel's addressing, tile by tile: the f tile
staged row-major (rows past P left stale, as NaN), the LayerNorm's lane map
(each lane's chunks, the statistics reduced over the lanes that share a
row, the permutation in place into the wgmma layout, with bank-conflict
free phases), W in the B layout, the A and B descriptors (K-major, no
swizzle: 8-row core matrices, ``lbo`` 128 bytes between a k-step's two
chunks, ``sbo`` one 8-row group), the accumulators' fragment and the
stmatrix addresses of the z staging, and the last pass's rows. In float64
without roundings it equals the function to 1e-12; with the kernel's
bfloat16 roundings it agrees with ``gate_tail_plain`` within one output
rounding (the card's tolerance). C in {32, 128, 256}, gate on and off, a
ragged last tile and P below one tile.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from patchrefinerv2_torch.ops import gated
from patchrefinerv2_torch.ops.gated import gate_tail_plain, launch_plan
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

SRC = (Path(gated.__file__).resolve().parent.parent / "csrc" / "gated_conv.cu").read_text()


def const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def chunk_sites(process, h2):
    """(rows, C, units) of the 10 K5 launches of a 16-patch chunk."""
    h, w = process
    return [(16 * (h >> k) * (w >> k), 256, 1 if k == 5 else 2) for k in range(1, 6)] + [(16 * h * w, h2, 1)]


# (tile rows, stages, shared bytes) by channels
PLANS = {256: (64, 3, 230656), 128: (64, 8, 165120), 32: (256, 8, 134400)}


@pytest.mark.parametrize("path,process,h2", [("flagship", (384, 512), 32), ("da2", (448, 448), 128)])
def test_launch_plan_at_every_site(path, process, h2):
    sites = chunk_sites(process, h2)
    assert sum(u for _, _, u in sites) == 10
    for rows, c, _ in sites:
        p = launch_plan(rows, c)
        tile, stages, smem = PLANS[c]
        assert (p["tile_rows"], p["stages"], p["smem"]) == (tile, stages, smem), (path, rows, c)
        assert p["smem"] <= gated.SMEM_MAX and 2 <= p["stages"] <= gated.MAX_STAGES
        assert p["tiles"] == -(-rows // tile) and p["grid"] == min(p["tiles"], 132)
    # the smallest sites are fewer tiles than SMs: one block a tile
    assert launch_plan(3072, 256)["grid"] == 48 and launch_plan(3136, 256)["grid"] == 49


def test_plan_constants_match_the_kernel():
    assert const("SMEM_MAX") == gated.SMEM_MAX and const("MAX_STAGES") == gated.MAX_STAGES
    assert gated.FIXED == 128 + const("BAR_BYTES") + const("PRM_BYTES")
    assert const("PRM_BYTES") >= 2 * 2 * max(gated.CHANNELS)  # scale and bias in bfloat16
    assert "MB = C == 32 ? 4 : 1" in SRC and "BP = 64 * MB" in SRC  # tile rows 256 at C = 32, else 64
    assert const("BAR_BYTES") >= 2 * 8 * gated.MAX_STAGES  # full and empty barriers


class Geo:
    def __init__(self, c):
        self.C, self.NCH = c, c // 8
        self.MB = 4 if c == 32 else 1
        self.BP = 64 * self.MB
        self.NP = min(c, 128)
        self.NPASS = c // self.NP
        self.KS = c // 16
        self.GROUP = self.NCH * 128
        self.LPR = 4 if self.NCH >= 32 else 2 if self.NCH >= 16 else 1
        self.NIT = self.NCH // self.LPR
        self.GPW = 4 // self.LPR
        self.LN_PASSES = self.BP // (32 * self.GPW)
        self.EPI = self.BP * self.NCH // 128
        self.ROT = 1 if self.NCH >= 8 else 2

    def core_off(self, r, c):
        return (r >> 3) * self.GROUP + c * 128 + (r & 7) * 16

    def z_off(self, r, c):
        return (r >> 3) * self.GROUP + c * 128 + (((r & 7) + c * self.ROT) & 7) * 16


def desc_element(start, lbo, sbo, m, k):
    """Byte address of element (m, k) of a K-major, unswizzled descriptor's
    64 x 16 (A) or N x 16 (B) operand."""
    return start + (m // 8) * sbo + (m % 8) * 16 + (k // 8) * lbo + (k % 8) * 2


def phase_banks_distinct(addrs):
    """16-byte accesses of one 8-lane phase: distinct 16-byte bank groups."""
    return len({(a // 16) % 8 for a in addrs}) == len(addrs)


def model(f, out, w, lw, lb, eps, rnd):
    """The bf16 kernel's data movement over numpy buffers of 2-byte
    elements (index = byte address / 2), in the precision of ``f``;
    ``rnd`` rounds where the kernel rounds to bfloat16."""
    p_rows, c = f.shape
    geo = Geo(c)
    dt = f.dtype
    # W in the B layout, by the kernel's load loop (e -> n, chunk)
    wsm = np.full(c * c, np.nan, dt)
    for e in range(c * geo.NCH):
        ch, n = (e >> 3) % geo.NCH, ((e >> 3) // geo.NCH) * 8 + (e & 7)
        a = geo.core_off(n, ch) // 2
        assert np.isnan(wsm[a:a + 8]).all()
        wsm[a:a + 8] = w[n, ch * 8:ch * 8 + 8]
    y = np.full_like(f, np.nan)
    for t in range(-(-p_rows // geo.BP)):
        p0 = t * geo.BP
        rows = min(geo.BP, p_rows - p0)
        st = np.full(geo.BP * c, np.nan, dt)  # stale rows stay NaN
        st[:rows * c] = f[p0:p0 + rows].reshape(-1)
        # the LayerNorm in place: warp wq, pass ps, lane (grp, q, r)
        for wq in range(4):
            for ps in range(geo.LN_PASSES):
                held = {}
                for it in range(geo.NIT):
                    phases = {}
                    for lane in range(32):
                        r, q, grp = lane & 7, (lane >> 3) % geo.LPR, lane // (8 * geo.LPR)
                        gi = (ps * 4 + wq) * geo.GPW + grp
                        ch = q * geo.NIT + ((r + it) & (geo.NIT - 1))
                        a = gi * geo.GROUP + r * c * 2 + ch * 16
                        phases.setdefault(lane // 8, []).append(a)
                        held.setdefault((gi, r), []).append((lane, ch, st[a // 2:a // 2 + 8].copy()))
                    if geo.NCH >= 8:
                        assert all(phase_banks_distinct(v) for v in phases.values())
                writes = []
                for (gi, r), parts in held.items():
                    assert sorted(ch for _, ch, _ in parts) == list(range(geo.NCH))  # the whole row
                    assert len({lane for lane, _, _ in parts}) == geo.LPR  # reduced over LPR lanes
                    x = np.concatenate([v for _, _, v in parts])
                    mean = x.sum() / c
                    var = max((x * x).sum() / c - mean * mean, 0.0)
                    rstd = 1.0 / np.sqrt(var + eps)
                    live = gi * 8 + r < rows
                    for lane, ch, v in parts:
                        g8, b8 = lw[ch * 8:ch * 8 + 8], lb[ch * 8:ch * 8 + 8]
                        h = rnd(np.maximum((v - mean) * (rstd * g8) + b8, 0)) if live else np.zeros(8, dt)
                        writes.append((gi * geo.GROUP + ch * 128 + r * 16, h, lane))
                # the warp's writes cover the bytes it read: a permutation of its groups
                assert len({a for a, _, _ in writes}) == len(writes)
                for a, h, _ in writes:
                    st[a // 2:a // 2 + 8] = h
        assert not np.isnan(st).any()
        # the products by descriptor, then z in bfloat16 and the stmatrix addresses
        z = np.zeros((geo.BP, c), dt)
        for ps in range(geo.NPASS):
            for mb in range(geo.MB):
                acc = np.zeros((64, geo.NP), dt)
                for ks in range(geo.KS):
                    a0, b0 = mb * 8 * geo.GROUP + ks * 256, ps * (geo.NP // 8) * geo.GROUP + ks * 256
                    mm, kk = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
                    A = st[desc_element(a0, 128, geo.GROUP, mm, kk) // 2]
                    nn, kk2 = np.meshgrid(np.arange(geo.NP), np.arange(16), indexing="ij")
                    B = wsm[desc_element(b0, 128, geo.GROUP, nn, kk2) // 2]
                    acc += A @ B.T
                z[mb * 64:(mb + 1) * 64, ps * geo.NP:(ps + 1) * geo.NP] = rnd(acc)
        zst = np.full(geo.BP * c, np.nan, dt)
        for wq in range(4):
            for ps in range(geo.NPASS):
                for mb in range(geo.MB):
                    for j in range(0, geo.NP // 8, 2):
                        for m in range(4):  # matrix m: rows g or g + 8, column group j or j + 1
                            addrs = []
                            for rr in range(8):
                                lane = 8 * m + rr
                                R = mb * 64 + wq * 16 + (m & 1) * 8 + (lane & 7)
                                ch = ps * (geo.NP // 8) + j + (m >> 1)
                                a = geo.z_off(R, ch)
                                addrs.append(a)
                                zst[a // 2:a // 2 + 8] = z[R, ch * 8:ch * 8 + 8]
                            assert phase_banks_distinct(addrs)
        assert not np.isnan(zst).any()
        # whole rows: thread ct, chunk k
        for k in range(geo.EPI):
            addrs = []
            for ct in range(128):
                e = ct + k * 128
                R, ch = e // geo.NCH, e % geo.NCH
                a = geo.z_off(R, ch)
                addrs.append(a)
                if R < rows:
                    zz = zst[a // 2:a // 2 + 8]
                    if out is not None:
                        s = rnd(1.0 / (1.0 + np.exp(-zz)))
                        zz = rnd(out[p0 + R, ch * 8:ch * 8 + 8] * s)
                    y[p0 + R, ch * 8:ch * 8 + 8] = zz
            assert all(phase_banks_distinct(addrs[i:i + 8]) for i in range(0, 128, 8))
    return y


def inputs(p, c, gate, seed):
    rng = np.random.RandomState(seed)
    f = (rng.randn(p, c) * 2 + 0.3)
    out = rng.randn(p, c) if gate else None
    w = rng.randn(c, c) * c ** -0.5
    lw = rng.rand(c) + 0.5
    lb = rng.randn(c) * 0.1
    return f, out, w, lw, lb


def exact(f, out, w, lw, lb, eps):
    mean = f.mean(1, keepdims=True)
    var = np.maximum((f * f).mean(1, keepdims=True) - mean * mean, 0)
    h = np.maximum((f - mean) / np.sqrt(var + eps) * lw + lb, 0)
    z = h @ w.T
    return z if out is None else out / (1 + np.exp(-z))


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("p", ["ragged", "below_one_tile"])
def test_model_reproduces_the_function(c, gate, p):
    bp = Geo(c).BP
    p = 2 * bp + 37 if p == "ragged" else bp // 2 + 3
    f, out, w, lw, lb = inputs(p, c, gate, seed=c + gate + p)
    # float64, no rounding: the addressing alone
    got = model(f, out, w, lw, lb, 1e-6, rnd=lambda x: x)
    np.testing.assert_allclose(got, exact(f, out, w, lw, lb, 1e-6), rtol=0, atol=1e-12)
    # bfloat16 inputs and the kernel's roundings, against the plain version
    tb = [None if a is None else torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in
          (f, out, w, lw, lb)]
    ref = gate_tail_plain(*tb).float().numpy()
    fb, ob, wb, lwb, lbb = [None if a is None else a.float().numpy() for a in tb]
    got = model(fb, ob, wb, lwb, lbb, np.float32(1e-6), rnd=bf16)
    err = np.abs(got - ref).max()
    assert err <= 1e-2 * max(np.abs(ref).max(), 1.0), err
    # most elements agree bit for bit; the rest by one bfloat16 rounding of the value
    ulp = np.maximum(np.abs(ref), 1e-30) * 2.0 ** -7
    assert (np.abs(got - ref) <= ulp * 1.01).mean() > 0.99
