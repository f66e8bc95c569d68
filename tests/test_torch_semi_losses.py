"""PatchRefinerSemi's edge losses and the bounded hysteresis (K12) against
the JAX package on the CPU, where the kernel wrappers take their plain
versions.

- The SSI forms (``ScaleAndShiftInvariantLoss`` with ``ssi``,
  ``grad_matching``, ``inverse`` and ``only_missing_area``;
  ``ScaleAndShiftInvariantDALoss`` with and without the gradient match) and
  ``missing_area_sampling_mask``: the loss and its gradient with respect to
  the prediction within 1e-5 of their magnitude in float32; the mask equal.
- ``canny_edges_graph``: the masks equal to JAX's. Both sides compute the
  9x9 Gaussian and the Sobel correlations in float32 in their own summation
  order, so a magnitude at a threshold or an NMS tie may round to the other
  side: at most 1e-4 of the pixels may differ (measured: none).
- The bounded hysteresis: ``hysteresis_bounded_plain`` exactly equal to
  JAX's ``fori_loop`` of ``low & _dilate3x3(m)``; on a snake longer than 128
  pixels it stops where JAX stops, and differs from the evaluation's
  connected-component hysteresis (``metrics._hysteresis``); with no high
  pixel it is empty. Numpy models of ``csrc/hysteresis.cu``'s two kernels
  equal the plain version and JAX's loop, so that their designs are exact on
  the CPU too: the resident kernel (``resident_model``: the cluster's row
  shares, the leader's per-thread strips and row dilation by shuffles, the
  edge rows between strips, the rows it skips and the step at which it
  exits, which must be the plain loop's first step that changes nothing;
  with each cluster size a plan may take) and the tiled one
  (``tiled_model``: its tile, halo and step constants read from the source,
  the launches ping-ponging), on the planes either side of the resident
  threshold of ``hysteresis_plan``.
- The ranking loss's body on JAX's own samples, drawn with JAX's key chain
  (``split(rng, b)``, ``split(key, 5)``, ``categorical``/``randint``/
  ``uniform``) from JAX's masks: the loss and the sample count within 1e-5,
  the gradient within 2e-2 of its norm; one image has no edge pixel. The
  port's sampler draws only where its masks allow, and an image without
  edges draws and is masked.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models import losses as jl
from patchrefinerv2_tpu.models import losses_extra as jle

from patchrefinerv2_torch.evaluation.metrics import _hysteresis
from patchrefinerv2_torch.models import losses as pl
from patchrefinerv2_torch.models import losses_extra as ple
from patchrefinerv2_torch.ops.canny import (
    RESIDENT_CLUSTERS, RESIDENT_ROWS, hysteresis_bounded, hysteresis_bounded_plain,
    hysteresis_exit_steps_plain, hysteresis_plan,
)
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

HW = (24, 32)


def depth_maps(seed, hw=HW, b=2, smooth=True):
    """Positive (B, H, W, 1) float32 depth maps: smooth ramps with steps
    (edges for canny) and a little noise."""
    rng = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(b):
        base = 2.0 + 10.0 * rng.rand() * (yy + rng.rand() * xx)
        step = np.where(xx > rng.uniform(0.3, 0.7), rng.uniform(2, 6), 0.0)
        out.append(base + step + (0.05 if smooth else 1.0) * rng.rand(h, w))
    return np.stack(out)[..., None].astype(np.float32)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def port_value_and_grad(loss, pred, *args):
    p = torch.from_numpy(pred).requires_grad_()
    out = loss(p, *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    out = out[0] if isinstance(out, tuple) else out
    out.backward()
    return float(out.detach()), p.grad.numpy()


def jax_value_and_grad(loss, pred, *args):
    def f(p):
        out = loss(p, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
        return out[0] if isinstance(out, tuple) else out

    v, g = jax.value_and_grad(f)(jnp.asarray(pred))
    return float(v), np.asarray(g)


SSI_FORMS = {
    "ssi_l1": dict(),
    "ssi_gm": dict(grad_matching=True),
    "no_ssi": dict(ssi=False),
    "inverse": dict(inverse=True),
    "missing_l1": dict(only_missing_area=True),
    "missing_gm": dict(only_missing_area=True, grad_matching=True),
}


def ssi_inputs(seed, pred_hw=HW):
    rng = np.random.RandomState(seed)
    pred = depth_maps(seed, pred_hw)
    pseudo = depth_maps(seed + 1, HW)
    gt = depth_maps(seed + 2, HW, smooth=False)
    gt[:, 5:12, 8:20] = 0.0  # a missing area
    mask = rng.rand(*pseudo.shape) > 0.2
    return pred, pseudo, gt, mask


@pytest.mark.parametrize("form", sorted(SSI_FORMS))
def test_ssi_loss_matches_jax(form):
    """float32: the loss within 1e-5, its gradient within 1e-5 (the inverse
    form: 1e-3, see below); float64: the gradient within 1e-10. The inverse
    form's gradient passes through the closed-form scale and shift of the
    differences, whose sums cancel: in float32 JAX's own gradient is 3.1e-4
    of its magnitude off its float64 one (the port's 1.2e-4), while the two
    agree at 1.5e-14 in float64."""
    pred, pseudo, gt, mask = ssi_inputs(3)
    kw = SSI_FORMS[form]
    ref = jax_value_and_grad(jl.ScaleAndShiftInvariantLoss(**kw), pred, pseudo, gt, mask, 1e-3, 80.0)
    got = port_value_and_grad(pl.ScaleAndShiftInvariantLoss(**kw), pred, pseudo, gt, mask, 1e-3, 80.0)
    assert ref[0] > 0
    assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0]), (got[0], ref[0])
    assert rel_err(got[1], ref[1]) <= (1e-3 if form == "inverse" else 1e-5)
    p64, t64, g64 = (a.astype(np.float64) for a in (pred, pseudo, gt))
    with jax.enable_x64(True):
        ref = jax_value_and_grad(jl.ScaleAndShiftInvariantLoss(**kw), p64, t64, g64, mask, 1e-3, 80.0)
    got = port_value_and_grad(pl.ScaleAndShiftInvariantLoss(**kw), p64, t64, g64, mask, 1e-3, 80.0)
    assert rel_err(got[1], ref[1]) <= 1e-10


@pytest.mark.parametrize("grad_matching", [True, False])
@pytest.mark.parametrize("pred_hw", [HW, (12, 16)], ids=["same_size", "resized"])
def test_ssi_da_loss_matches_jax(grad_matching, pred_hw):
    pred, pseudo, gt, mask = ssi_inputs(4, pred_hw)
    kw = dict(grad_matching=grad_matching)
    ref = jax_value_and_grad(jl.ScaleAndShiftInvariantDALoss(**kw), pred, pseudo, gt, mask, 1e-3, 80.0)
    got = port_value_and_grad(pl.ScaleAndShiftInvariantDALoss(**kw), pred, pseudo, gt, mask, 1e-3, 80.0)
    assert ref[0] > 0
    assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0]), (got[0], ref[0])
    assert rel_err(got[1], ref[1]) <= 1e-5


def test_ssi_losses_with_too_few_pixels_are_zero():
    pred, pseudo, gt, _ = ssi_inputs(5)
    mask = np.zeros(pseudo.shape, bool)
    mask[0, 0, 0] = True
    for loss in (pl.ScaleAndShiftInvariantLoss(), pl.ScaleAndShiftInvariantDALoss()):
        assert float(loss(*map(torch.from_numpy, (pred, pseudo, gt, mask)), 1e-3, 80.0)) == 0.0


@pytest.mark.parametrize("seed", [6, 7])
def test_missing_area_sampling_mask_matches_jax(seed):
    _, pseudo, gt, _ = ssi_inputs(seed)
    ref = np.asarray(jl.missing_area_sampling_mask(jnp.asarray(gt), jnp.asarray(pseudo[..., 0]), 1e-3, 80.0))
    got = pl.missing_area_sampling_mask(torch.from_numpy(gt), torch.from_numpy(pseudo[..., 0]), 1e-3,
                                        80.0).numpy()
    assert got.dtype == np.float32 and 0 < ref.sum() < ref.size
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,hw", [(8, (64, 96)), (9, (96, 128)), (10, (48, 200))])
def test_canny_edges_graph_matches_jax(seed, hw):
    x = np.log(depth_maps(seed, hw, smooth=False)[..., 0])
    ref = np.asarray(jax.jit(jle.canny_edges_graph)(jnp.asarray(x)))
    got = ple.canny_edges_graph(torch.from_numpy(x)).numpy()
    assert got.dtype == bool and ref.sum() > 0
    differ = float((got != ref).mean())
    print("canny_edges_graph: share of pixels that differ", differ)  # shown with pytest -s
    assert differ <= 1e-4


def test_kornia_sobel_magnitude_matches_jax():
    x = depth_maps(11, (40, 56))[..., 0]
    ref = np.asarray(jle.kornia_sobel_magnitude(jnp.asarray(x)))
    assert rel_err(ple.kornia_sobel_magnitude(torch.from_numpy(x)).numpy(), ref) <= 1e-6


# ------------------------------------------------------------ K12, bounded hysteresis
def jax_hysteresis(low, high, steps):
    f = jax.jit(lambda lo, hi: jax.lax.fori_loop(0, steps, lambda _, m: lo & jle._dilate3x3(m), hi))
    return np.asarray(f(jnp.asarray(low), jnp.asarray(high)))


def snake(h=40, w=60):
    """A one-pixel-wide snake of horizontal runs joined at alternate ends
    (~9 * 55 pixels long) as the low mask, one high pixel at its head."""
    low = np.zeros((1, h, w), bool)
    for i, r in enumerate(range(2, h - 2, 4)):
        low[0, r, 2:w - 2] = True
        c = w - 3 if i % 2 == 0 else 2
        low[0, r:r + 5, c] = r + 4 < h - 2
    high = np.zeros_like(low)
    high[0, 2, 2] = True
    return low, high


def random_masks(seed, shape):
    rng = np.random.RandomState(seed)
    low = rng.rand(*shape) < 0.55
    return low, low & (rng.rand(*shape) < 0.02)


HYSTERESIS_CASES = {
    "random": (random_masks(12, (2, 37, 70)), 128),
    "random, 45 steps": (random_masks(13, (3, 20, 33)), 45),
    "snake": (snake(), 128),
    "no high pixel": ((random_masks(14, (1, 16, 16))[0], np.zeros((1, 16, 16), bool)), 128),
    "one pixel wide": (random_masks(15, (2, 30, 1)), 128),
    "high outside low": ((np.zeros((1, 9, 9), bool), np.ones((1, 9, 9), bool)), 3),
    "0 steps": (random_masks(16, (1, 8, 8)), 0),
}


@pytest.mark.parametrize("case", sorted(HYSTERESIS_CASES))
def test_hysteresis_plain_matches_jax(case):
    (low, high), steps = HYSTERESIS_CASES[case]
    ref = jax_hysteresis(low, high, steps)
    got = hysteresis_bounded(torch.from_numpy(low), torch.from_numpy(high), steps).numpy()
    np.testing.assert_array_equal(got, ref)
    if case == "no high pixel":
        assert not got.any()


def test_hysteresis_is_bounded_on_a_long_snake():
    """Past 128 steps of the snake JAX's mask stops; the evaluation's
    connected components reach its end."""
    low, high = snake()
    got = hysteresis_bounded_plain(torch.from_numpy(low), torch.from_numpy(high)).numpy()
    full = _hysteresis(torch.from_numpy(low[0]), torch.from_numpy(high[0])).numpy()
    assert full.sum() == low.sum() > 300 and 128 < got.sum() < 0.5 * full.sum()
    assert not (got[0] & ~full).any()
    np.testing.assert_array_equal(got, jax_hysteresis(low, high, 128))


def test_hysteresis_wrong_inputs_raise():
    m = torch.zeros((4, 4), dtype=torch.bool)
    with pytest.raises(TypeError, match="bool"):
        hysteresis_bounded(m.float(), m)
    with pytest.raises(ValueError, match="one shape"):
        hysteresis_bounded(m, m[:3])


def tiled_constants() -> dict:
    src = (Path(__file__).resolve().parent.parent / "patchrefinerv2_torch/csrc/hysteresis.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in ("S", "TW", "TH")}


def tiled_model(low, high, steps):
    """``csrc/hysteresis.cu``'s tiled kernel (the planes no resident plan
    holds) in numpy: per launch (at most S steps), every block's region (TW
    + 2 words by TH + 2S rows) packed into uint32 words (bit j = pixel 32 c +
    j, 0 outside the map), the kernel's word formula for each step, the
    inner tile unpacked into the destination."""
    k = tiled_constants()
    s_max, tw, th = k["S"], k["TW"], k["TH"]
    rw, rh = tw + 2, th + 2 * s_max
    b, h, w = low.shape
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)

    def pack(m, y0, x0):
        region = np.zeros((b, rh, rw * 32), bool)
        ys, xs = slice(max(y0, 0), min(y0 + rh, h)), slice(max(x0, 0), min(x0 + rw * 32, w))
        region[:, ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = m[:, ys, xs]
        return (region.reshape(b, rh, rw, 32) * bits).sum(-1, dtype=np.uint32)

    def step(cur, lo):
        acc = np.zeros_like(cur)
        zero_row = np.zeros_like(cur[:, :1])
        for dr in (-1, 0, 1):
            rows = cur if dr == 0 else (np.concatenate([zero_row, cur[:, :-1]], 1) if dr == -1
                                        else np.concatenate([cur[:, 1:], zero_row], 1))
            zero_col = np.zeros_like(rows[:, :, :1])
            left = np.concatenate([zero_col, rows[:, :, :-1]], 2)
            right = np.concatenate([rows[:, :, 1:], zero_col], 2)
            acc |= rows | (rows << np.uint32(1)) | (rows >> np.uint32(1)) | (left >> np.uint32(31)) \
                | (right << np.uint32(31))
        return lo & acc

    src = high
    for i in range(-(-steps // s_max)):
        run = min(s_max, steps - i * s_max)
        dst = np.zeros_like(src)
        for by in range(-(-h // th)):
            for bx in range(-(-w // (tw * 32))):
                y0, x0 = by * th - s_max, bx * tw * 32 - 32
                lo, cur = pack(low, y0, x0), pack(src, y0, x0)
                for _ in range(run):
                    cur = step(cur, lo)
                inner = cur[:, s_max:s_max + th, 1:1 + tw]
                px = ((inner[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
                px = px.reshape(b, th, tw * 32)
                ye, xe = min(th, h - by * th), min(tw * 32, w - bx * tw * 32)
                dst[:, by * th:by * th + ye, bx * tw * 32:bx * tw * 32 + xe] = px[:, :ye, :xe]
        src = dst
    return src


def resident_model(low, high, steps, plan):
    """``csrc/hysteresis.cu``'s resident kernel in numpy, thread by thread.
    The ``plan.cluster`` CTAs of a plane each pack rows [r * per, (r + 1) *
    per) (per = ceil(H / CTAs)) of both masks, 32 pixels a word (bit j =
    pixel 32 c + j, 0 outside the map), into the leader's stage; the
    leader's thread t (of ``plan.warps * 32``) holds word column c = t % seg
    of rows y0 .. y0 + R - 1, y0 = (t // seg) * R, and each row dilated along
    the row (``h``, by __shfl_up/__shfl_down within segments of seg lanes: a
    lane's own word at the segment's ends, cleared by the lane masks, and
    funnel shifts). A step: each thread's first and last ``h`` stored into
    the edge slots of the threads above and below (double buffered); the
    plane leaves the loop when no warp changed a row in the previous step;
    a lane recomputes the rows next to a row its warp changed and its first
    / last row when the edge above / below it differs from the one it read
    in the previous step; its warp ORs the rows its lanes changed and
    recomputes their ``h``. Asserts that no skipped row would have changed.
    Returns the mask and each plane's exit step (the first step that changed
    nothing, ``steps`` if each one did)."""
    cl, rr, warps, seg = plan
    b, h, w = low.shape
    nt = warps * 32
    t = np.arange(nt)
    c = t % seg
    ys = (t // seg)[:, None] * rr + np.arange(rr)  # (nt, R)
    assert (nt // seg) * rr >= h and seg * 32 >= w
    per = -(-h // cl)
    shares = [(min(h, r * per), min(h, (r + 1) * per)) for r in range(cl)]
    assert shares[0][0] == 0 and shares[-1][1] == h and all(
        a[1] == n[0] for a, n in zip(shares, shares[1:]))  # the CTAs' rows partition the plane
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)

    def stage(m):  # the words the CTAs write into the leader's stage, (b, H, seg)
        px = np.zeros((b, h, seg * 32), bool)
        px[:, :, :w] = m
        return (px.reshape(b, h, seg, 32) * bits).sum(-1, dtype=np.uint32)

    def strips(words):  # (b, nt, R): the leader's registers, 0 past the plane
        return np.where(ys < h, words[:, np.minimum(ys, h - 1), c[:, None]], np.uint32(0))

    lo, cur = strips(stage(low)), strips(stage(high))
    ones = np.uint32(0xFFFFFFFF)
    lm = np.where(c > 0, ones, np.uint32(0))[:, None]
    rm = np.where(c < seg - 1, ones, np.uint32(0))[:, None]
    up_src = np.where(c > 0, t - 1, t)  # __shfl_up_sync(w, 1, seg): the lane's own word at the start
    down_src = np.where(c < seg - 1, t + 1, t)
    one, sh31 = np.uint32(1), np.uint32(31)

    def hdil(x):  # (b, nt, R) -> each word dilated along its row
        left, right = x[:, up_src] & lm, x[:, down_src] & rm
        return x | ((x << one) | (left >> sh31)) | ((x >> one) | (right << sh31))

    hd = hdil(cur)
    edge = np.zeros((2, b, nt, 2), np.uint32)  # [p][b][t]: (x: the row above, y: below)
    up = np.zeros((b, nt), np.uint32)
    down = np.zeros((b, nt), np.uint32)
    rows = np.ones((b, warps, rr), bool)  # step 0 computes every row
    running = np.ones(b, bool)
    exit_at = np.full(b, steps)
    warp = t // 32
    for s in range(steps + 1):
        p = s & 1
        edge[p][:, :nt - seg, 1] = hd[:, seg:, 0]  # thread t >= seg: its first row, to t - seg
        edge[p][:, seg:, 0] = hd[:, :nt - seg, rr - 1]
        stop = running & ~rows.any((1, 2))
        exit_at[stop] = s - 1
        running &= ~stop
        if s == steps or not running.any():
            break
        ex, ey = edge[p][..., 0], edge[p][..., 1]
        spread = rows.copy()
        spread[..., 1:] |= rows[..., :-1]
        spread[..., :-1] |= rows[..., 1:]
        need = spread[:, warp].copy()  # (b, nt, R)
        need[..., 0] |= ex != up
        need[..., rr - 1] |= ey != down
        need &= running[:, None, None]
        up, down = ex, ey
        hs = np.concatenate([ex[..., None], hd, ey[..., None]], -1)
        new = lo & (hs[..., :-2] | hs[..., 1:-1] | hs[..., 2:])
        differ = new != cur
        assert not (differ & ~need & running[:, None, None]).any(), "a skipped row would change"
        cur = np.where(need, new, cur)
        rows = (differ & need).reshape(b, warps, 32, rr).any(2)
        hd = np.where(rows[:, warp], hdil(cur), hd)
    out = np.zeros((b, (nt // seg) * rr, seg), np.uint32)
    out[:, ys, c[:, None]] = cur
    px = ((out[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    return px.reshape(b, -1, seg * 32)[:, :h, :w], exit_at


def plain_exit(low, high, steps):
    return hysteresis_exit_steps_plain(torch.from_numpy(low), torch.from_numpy(high), steps).numpy()


def inverted_thresholds(seed, shape):
    """A high mask not inside the low one (the thresholds swapped)."""
    rng = np.random.RandomState(seed)
    return rng.rand(*shape) < 0.5, rng.rand(*shape) < 0.1


MODEL_CASES = {  # name -> (low, high), steps
    "random": (random_masks(17, (2, 150, 300)), 128),
    "random, 70 steps": (random_masks(17, (2, 150, 300)), 70),
    "snake": (snake(70, 140), 128),
    "odd, 33 steps": (random_masks(18, (1, 65, 129)), 33),
    "odd, 1 step": (random_masks(18, (1, 65, 129)), 1),
    "empty high": ((random_masks(19, (2, 40, 96))[0], np.zeros((2, 40, 96), bool)), 128),
    "short chains": ((lambda r: (r.rand(3, 64, 200) < 0.25, r.rand(3, 64, 200) < 0.03))(
        np.random.RandomState(20)), 128),
    "snake past 128": (snake(), 128),
    "45 steps": (random_masks(13, (3, 20, 33)), 45),
    "inverted thresholds": (inverted_thresholds(21, (2, 33, 70)), 128),
    "one pixel wide": (random_masks(15, (2, 30, 1)), 128),
    "one pixel high": (random_masks(22, (2, 1, 700)), 128),
}


@functools.lru_cache(maxsize=None)
def model_reference(case):
    """The plain version's mask, JAX's loop's and the plain exit steps."""
    (low, high), steps = MODEL_CASES[case]
    ref = hysteresis_bounded_plain(torch.from_numpy(low), torch.from_numpy(high), steps).numpy()
    np.testing.assert_array_equal(ref, jax_hysteresis(low, high, steps))
    return ref, plain_exit(low, high, steps)


@pytest.mark.parametrize("cluster", RESIDENT_CLUSTERS)
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_hysteresis_resident_model_matches_plain(case, cluster):
    """The resident kernel's strips, shuffles, edge buffers, skipped warps
    and exit give the plain version's (and JAX's) mask, with the cluster
    sizes it may take, and leave the loop at the plain loop's first step
    that changes nothing."""
    (low, high), steps = MODEL_CASES[case]
    plan = hysteresis_plan(*low.shape[1:], cluster=cluster)
    assert plan is not None and plan.cluster == cluster
    ref, want_exit = model_reference(case)
    got, exit_at = resident_model(low, high, steps, plan)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(exit_at, want_exit)
    if case == "empty high":
        assert (exit_at == 0).all() and not got.any()
    elif case == "short chains":
        assert 0 < exit_at.max() < 32 and got.sum() > (high & low).sum()
    elif case in ("snake", "snake past 128"):
        assert (exit_at == steps).all() and steps < ref.sum() < low.sum()  # cut at 128 steps
    elif case == "inverted thresholds":
        assert (high & ~low).any() and not (got & ~low).any()


# planes either side of the resident threshold: the widest and the tallest
# planes a plan holds, and one pixel more (3 steps keep the CPU's work small)
THRESHOLD_PLANES = {"1024 wide": (6, 1024), "1025 wide": (6, 1025),
                    "384 x 1024": (384, 1024), "385 x 1024": (385, 1024)}


@pytest.mark.parametrize("name", list(THRESHOLD_PLANES))
def test_hysteresis_threshold_planes_match_plain(name):
    """Either side of the resident threshold the wrapper's plan (the
    resident kernel, or None: the tiled one) gives the plain version's and
    JAX's mask."""
    h, w = THRESHOLD_PLANES[name]
    low, high = random_masks(23, (1, h, w))
    plan = hysteresis_plan(h, w)
    assert (plan is None) == name.startswith(("1025", "385"))
    ref = hysteresis_bounded_plain(torch.from_numpy(low), torch.from_numpy(high), 3).numpy()
    np.testing.assert_array_equal(ref, jax_hysteresis(low, high, 3))
    got = tiled_model(low, high, 3) if plan is None else resident_model(low, high, 3, plan)[0]
    np.testing.assert_array_equal(got, ref)


def test_hysteresis_plan_is_instantiated():
    """Every plan fits the kernel's limits and its leader covers the plane,
    each rows count a plan can take is a template instance of the source
    and each cluster size one it launches."""
    src = (Path(__file__).resolve().parent.parent / "patchrefinerv2_torch/csrc/hysteresis.cu").read_text()
    rows = {int(r) for r in re.findall(r"case (\d+): err = launch_resident<\1>", src)}
    clusters = {int(c) for c in re.findall(r"case (\d+): return \(int\)launch\(hysteresis_floor_kernel<\1>", src)}
    assert rows == set(RESIDENT_ROWS) and clusters == set(RESIDENT_CLUSTERS)
    assert "cluster < 1 || cluster > 8" in src
    for h in (1, 2, 63, 64, 65, 384, 385, 768, 769, 1000, 2048, 12288, 12289):
        for w in (1, 31, 32, 33, 301, 512, 1000, 1024, 1025):
            for cluster in RESIDENT_CLUSTERS:
                plan = hysteresis_plan(h, w, cluster)
                words = -(-w // 32)
                seg = 1 << (words - 1).bit_length()
                if plan is None:  # wider than 1024 or more rows than 32 warps of 12-row strips
                    assert words > 32 or h > 32 * (32 // seg) * max(RESIDENT_ROWS)
                    continue
                assert plan.seg == seg and plan.warps <= 32 and plan.cluster == cluster
                assert plan.warps * (32 // seg) * plan.rows >= h
                assert plan.rows == min(r for r in RESIDENT_ROWS if -(-h // ((32 // seg) * r)) <= 32)
    assert hysteresis_plan(384, 512, 1) == (1, 6, 32, 16)


# ------------------------------------------------------------ the ranking loss
def ranking_inputs(seed=19, hw=(40, 56), flat_second=True):
    """Prediction, pseudo label (image 1 flat: no edge pixel) and gt, each
    (2, H, W, 1) float32."""
    pred = depth_maps(seed, hw)
    tgt = depth_maps(seed + 1, hw, smooth=False)
    if flat_second:
        tgt[1] = 7.0
    gt = depth_maps(seed + 2, hw)
    gt[0, :4] = 0.0  # invalid rows
    return pred, tgt, gt


def jax_samples(loss, tgt, gt, key):
    """JAX's samples, drawn as ``EdgeguidedRankingLoss.__call__`` draws them,
    from JAX's own masks, as the port's ``sample`` dict."""
    tgt_j, gt_j = jnp.asarray(tgt[..., 0]), jnp.asarray(gt[..., 0])
    strict = (gt_j > loss.min_depth) & (gt_j < loss.max_depth)
    log_t = jnp.where(tgt_j > 0, jnp.log(jnp.clip(tgt_j, 1.19e-7, None)), 0.0)
    edges = jle.canny_edges_graph(log_t) & strict
    n = loss.point_pairs
    out = {k: [] for k in ("anchor", "dist", "swap", "ia", "ib", "any_edge", "any_valid")}
    for i, k in enumerate(jax.random.split(key, tgt.shape[0])):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        logits = jnp.where(edges[i].reshape(-1), 0.0, -1e30)
        slogits = jnp.where(strict[i].reshape(-1), 0.0, -1e30)
        out["anchor"].append(jax.random.categorical(k1, logits, shape=(n,)))
        out["dist"].append(jax.random.randint(k3, (4, n), 2, 31))
        out["swap"].append(jax.random.uniform(k2) >= 0.5)
        out["ia"].append(jax.random.categorical(k4, slogits, shape=(3 * n,)))
        out["ib"].append(jax.random.categorical(k5, slogits, shape=(3 * n,)))
        out["any_edge"].append(edges[i].any())
        out["any_valid"].append(strict[i].any())
    return {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in out.items()}


@pytest.mark.parametrize("reweight,direct", [(False, True), (True, True), (False, False)])
def test_ranking_body_on_jax_samples_matches_jax(reweight, direct):
    kw = dict(point_pairs=300, reweight_target=reweight, random_direct=direct)
    pred, tgt, gt = ranking_inputs()
    key = jax.random.PRNGKey(23)
    jloss = jle.EdgeguidedRankingLoss(**kw)

    def f(p):
        return jloss(p, jnp.asarray(tgt), None, jnp.asarray(gt), rng=key)

    (loss_j, count_j), grad_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(pred))
    samples = jax_samples(jloss, tgt, gt, key)
    assert samples["any_edge"].tolist() == [True, False]
    port = ple.EdgeguidedRankingLoss(**kw)
    p = torch.from_numpy(pred).requires_grad_()
    loss, count = port(p, torch.from_numpy(tgt), None, torch.from_numpy(gt), samples=samples)
    loss.backward()
    assert float(count_j) > 0
    assert abs(float(count) - float(count_j)) <= 1e-5 * float(count_j)
    loss = float(loss.detach())
    assert abs(loss - float(loss_j)) <= 1e-5 * abs(float(loss_j)), (loss, float(loss_j))
    g, gj = p.grad.numpy(), np.asarray(grad_j)
    assert np.linalg.norm(g - gj) <= 2e-2 * np.linalg.norm(gj)
    # the image without edges has no surviving pair: its gradient is zero
    assert not g[1].any() and not gj[1].any()


def test_ranking_maps_match_jax():
    """The port's edges (within the anchor region) and thetas against JAX's
    on the same inputs."""
    pred, tgt, gt = ranking_inputs(flat_second=False)
    port = ple.EdgeguidedRankingLoss()
    _, _, edges, theta, valid = port.maps(*map(torch.from_numpy, (pred, tgt, gt)))
    tgt_j, gt_j = jnp.asarray(tgt[..., 0]), jnp.asarray(gt[..., 0])
    strict = np.asarray((gt_j > 1e-3) & (gt_j < 80))
    edges_j = np.asarray(jle.canny_edges_graph(jnp.log(tgt_j))) & strict
    np.testing.assert_array_equal(valid.numpy(), strict)
    assert float((edges.numpy() != edges_j).mean()) <= 1e-4 and edges_j.sum() > 0
    assert rel_err(theta.numpy(), jle.kornia_sobel_magnitude(tgt_j)) <= 1e-6


def test_ranking_sampler_draws_within_the_masks():
    pred, tgt, gt = ranking_inputs()
    port = ple.EdgeguidedRankingLoss(point_pairs=500)
    _, _, edges, _, valid = port.maps(*map(torch.from_numpy, (pred, tgt, gt)))
    g = torch.Generator().manual_seed(3)
    s = port.sample(edges, valid, g)
    b = edges.shape[0]
    assert s["anchor"].shape == (b, 500) and s["ia"].shape == s["ib"].shape == (b, 1500)
    assert s["dist"].shape == (b, 4, 500) and 2 <= int(s["dist"].min()) and int(s["dist"].max()) <= 30
    assert s["any_edge"].tolist() == [True, False] and s["any_valid"].all()
    assert edges.reshape(b, -1)[0][s["anchor"][0]].all()  # anchors on edge pixels only
    assert valid.reshape(b, -1).gather(1, s["ia"]).all() and valid.reshape(b, -1).gather(1, s["ib"]).all()
    again = port.sample(edges, valid, torch.Generator().manual_seed(3))
    assert all(torch.equal(v, again[k]) for k, v in s.items())  # a seeded generator repeats
    loss, count = port(torch.from_numpy(pred), torch.from_numpy(tgt), None, torch.from_numpy(gt),
                       generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(loss) and float(count) > 0


def test_cached_tables_made_under_inference_mode_take_gradients():
    """The plain resize's taps and the log-binomial table are cached across
    calls; a first call under ``torch.inference_mode`` (as ``infer`` runs)
    must not leave inference tensors that a later step's autograd saves
    (an earlier test's inference on the same test worker made the e2e
    Functions' gradient tests raise)."""
    from patchrefinerv2_torch.ops.bins import log_binomial_depth_plain
    from patchrefinerv2_torch.ops.resize import resize_plain

    x = torch.rand(1, 7, 9, 3, dtype=torch.float64)
    pt, centres = torch.rand(1, 5, 6, 4, dtype=torch.float64), torch.rand(1, 3, 3, 13, dtype=torch.float64)
    with torch.inference_mode():
        resize_plain(x, (13, 11), "bilinear", True)
        log_binomial_depth_plain(pt, centres, 13, 0.0212, 50.0)
    x.requires_grad_()
    pt.requires_grad_()
    resize_plain(x, (13, 11), "bilinear", True).sum().backward()
    log_binomial_depth_plain(pt, centres, 13, 0.0212, 50.0).sum().backward()
    assert x.grad is not None and pt.grad is not None
