"""The port's stage-3 training step (``v2_eff_u4k``: ``e2e_training``, the
coarse branch trained through roi_align) against the JAX package, on the
CPU.

The tiny flagship topology of tests/test_torch_slice.py (a 4-block BEiT and
the ZoeDepth bins head, the full EfficientNet-B5 refiner with its coarse
condition, BiDirectionalFusion at the coarse branch's widths) at 48x64
patches, with ``e2e_training=True`` and ``remat=True`` on both sides (the
JAX package builds ``train_forward`` with remat: it calls the remat-wrapped
fusion head positionally). One JAX model for the module: its variables
drawn with numpy from a seed (``randomize`` over ``jax.eval_shape`` of its
init) and loaded into the port through ``load_jax_params``; a batch of two
images, two crops with their boxes and 72x96 crop depths, from a seed.

Bars, as tests/test_torch_train_slice.py sets them. One step's loss dict
(SILog, GradMatch, the total), every gradient leaf (BEiT with its
relative-position tables, the bins head, the refiner, the fusion head) and
the BatchNorm statistics after the step, against ``jax.value_and_grad`` of
``PatchRefinerPlus.loss`` with ``mutable=["batch_stats"]``:

- float64 on both sides: each loss max rel <= 1e-5; each gradient leaf
  ||port - JAX|| / ||JAX|| <= 1e-4, a leaf's norm floored at 1e-6 of the
  whole gradient's; each BatchNorm statistic within 1e-5 of its leaf's
  largest value (not of itself: a running mean of 2.4e-6 differs by
  6.9e-10). Measured: loss 3.2e-9, worst leaf 5.8e-5 (a refiner
  squeeze-excite bias), statistics 2.0e-6. JAX's float64 step is not
  float64 throughout: its roi_align, attention, resize and LayerNorms
  compute in float32 (``cdt``, ``preferred_element_type``,
  ``compute_dtype``), and the step amplifies those roundings. Hence
  48x64: at 32x48 patches (the deepest refiner maps 1x2 pixels under
  train-mode BatchNorm) the same comparison gives a worst leaf of 7e-3
  (1.6e-4 with those JAX computations made float64; at 48x64 1.4e-6: a
  measurement, not a test). Marked ``slow``: JAX's float64 step takes ~2
  min alone; ``pytest -m slow tests/test_torch_train_e2e.py`` runs it.
- float32: each loss max rel <= 1e-5; the whole gradient within 2e-2 of
  its norm (measured 3.6e-4); each BatchNorm statistic within 1e-4 of its
  leaf's largest value (measured 4.3e-5); the coarse prediction within 1e-5
  of its magnitude.

The trained net's weights and statistics go to the JAX tree and back
unchanged (``convert_patchrefinerplus``, ``jax_to_state_dict``); with
``e2e_training`` off JAX's ``coarse_forward`` passes no gradient
(``stop_gradient``: its coarse leaves get zeros, where the port runs the
branch under no gradient and its leaves get none,
tests/test_torch_train_e2e_trainer.py). The port's checks that need no
JAX step (remat, the frozen coarse branch, the loss without statistics
updates, inference) are in that file too.

Below, the gradients of the kernels stage 3 trains through, in float64.

K1 (roi_align), K3/K4 (attention, with and without the BEiT
relative-position bias) and K8 (the attractor update and the log-binomial
depth, each resizing the centres it takes in) are
``torch.autograd.Function``s whose backwards are written in PyTorch ops.
Each one's output and gradients, for an output gradient drawn from a seed:

- against ``jax.vjp`` of the JAX function on the same numpy inputs: max
  |port - JAX| <= 1e-5 * max |JAX| per gradient (JAX computes roi_align,
  the attention and the log-binomial table in float32 even for float64
  inputs, so this is float32's agreement);
- against autograd through the port's plain version: <= 1e-10 of the
  magnitude (both float64, the same taps and table).

The JAX functions: ``mha`` (``ops/attention.py:44``) with the bias of
``relative_position_bias`` (``backbones/beit.py:46``), the form
``BeitAttention`` computes, and the attractor layers' math after their MLP
with ``_interp`` of the previous centres (``backbones/zoedepth.py:117-170``,
as ``tests/test_torch_bins_redesign.py`` writes it out), both under
``jit``; run eagerly: ``roi_align_mxu`` (``ops/roi_align.py:86``, its
``__wrapped__`` Python function: under ``jit`` XLA turns the bin size's
division by the output size into a product with its reciprocal, one
float32 ulp off the quotient the port and the kernel compute, which moves a
sample by an ulp of its coordinate, up to 1.5e-5 of a tap weight in a
96-wide map) and ``ConditionalLogBinomial``'s math after its MLP with the
expectation over ``_interp`` of the centres (``zoedepth.py:200-217,
375-376``), written out here from ``log_binom``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import patchrefinerv2_tpu.models.backbones.zoedepth as Z
from patchrefinerv2_tpu.models.backbones.beit import relative_position_bias as j_rel_bias
from patchrefinerv2_tpu.models.patchrefinerplus import PRPlusNet as JPRPlusNet
from patchrefinerv2_tpu.ops.attention import mha
from patchrefinerv2_tpu.ops.roi_align import roi_align_mxu
from patchrefinerv2_tpu.parallel.bn import bn_groups, set_bn_groups
from patchrefinerv2_tpu.registry import MODELS

from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.ops.attention import attention, attention_plain
from patchrefinerv2_torch.ops.bins import (
    attractor_update, attractor_update_plain, log_binomial_depth, log_binomial_depth_plain,
)
from patchrefinerv2_torch.ops.roi_align import roi_align, roi_align_plain
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests.test_torch_bins_redesign import _jax_attractor
from tests.test_torch_modules import randomize
from tests.test_torch_slice import slice_config
from tests.test_torch_train_slice import grad_errors, stats_of

B = 2
HW = (48, 64)
KEY = jax.random.PRNGKey(3)


def e2e_config(remat: bool = True, e2e: bool = True, hw=HW) -> dict:
    cfg = slice_config()
    cfg.update(e2e_training=e2e, remat=remat, patch_process_shape=list(hw),
               image_raw_shape=[2 * hw[0], 2 * hw[1]])
    return cfg


def make_batch(hw=HW, seed=5) -> dict:
    """Two images, a crop of each (half the frame, resized to the process
    shape) with its box in the process frame, and its raw depth."""
    rng = np.random.RandomState(seed)
    h, w = hw
    return dict(image_lr=rng.rand(B, h, w, 3), crops_image_hr=rng.rand(B, h, w, 3),
                crop_depths=1.0 + 20.0 * rng.rand(B, 72, 96, 1),
                bboxs=np.array([[0.0, 0.0, w / 2, h / 2], [w / 4, h / 3, 3 * w / 4, 5 * h / 6]]))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread for this module: the suite runs several
    workers on the CPU at once, and a pool of one thread per core in each of
    them stalls the port's CPU steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_bn_group():
    groups = bn_groups()
    set_bn_groups(1)  # one device: per-batch BatchNorm moments
    yield
    set_bn_groups(groups)


@pytest.fixture(scope="module")
def jax_model():
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=e2e_config()))
    return jm, randomize(jax.eval_shape(jm.init, KEY), seed=21), make_batch()


def port_model(variables, dtype=torch.float32) -> PatchRefinerPlus:
    port = PatchRefinerPlus(e2e_config(), device="cpu")
    load_jax_params(port, variables)
    port.net.to(dtype)
    return port.train()


def jax_step(jm, variables, batch, dtype):
    """(loss dict, aux coarse prediction, gradients and batch stats after
    the step as the port's state-dict names) of JAX's stage-3 loss."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        b = {k: jnp.asarray(np.asarray(x, dtype)) for k, x in batch.items()}

        def loss(p):
            ld, aux = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, b,
                              mutable=["batch_stats"])
            return ld["total_loss"], (ld, aux["coarse_prediction"], aux["variables"]["batch_stats"])

        (_, (ld, coarse, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        return ({k: float(x) for k, x in ld.items()}, np.asarray(coarse),
                jax_to_state_dict({"params": jax.device_get(grads), "batch_stats": jax.device_get(stats)}))


def port_step(variables, batch, dtype):
    port = port_model(variables, dtype=dtype)
    ld, aux = port.loss(batch, update_stats=True)
    ld["total_loss"].backward()
    return port, {k: float(v.detach()) for k, v in ld.items()}, aux


@pytest.fixture(scope="module")
def port_float32_step(jax_model):
    """The port's float32 step with remat on, end to end."""
    _, variables, batch = jax_model
    return port_step(variables, batch, torch.float32)


def assert_losses(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref) == ["gm_loss", "sig_fine_loss", "total_loss"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, got[k], ref[k])


@pytest.mark.slow  # composed parity, as the repo marks it: XLA's float64 step takes ~2 min
def test_stage3_step_matches_jax_float64(jax_model):
    jm, variables, batch = jax_model
    ref_losses, _, ref = jax_step(jm, variables, batch, np.float64)
    port, losses, _ = port_step(variables, batch, torch.float64)
    assert_losses(losses, ref_losses)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print("float64 worst gradient leaf", worst, errs[worst])  # shown with pytest -s
    for k, (d, n) in errs.items():
        assert d <= 1e-4 * max(n, 1e-6 * total), (k, d, n)
    coarse = [n for k, (_, n) in errs.items() if k.startswith("coarse_branch.")]
    assert all(n > 0 for n in coarse)  # the gradient reaches every coarse leaf
    bn = {k: np.abs(got - ref[k]).max() / np.abs(ref[k]).max() for k, got in stats_of(port).items()}
    print("float64 loss", losses, ref_losses, "worst statistic", max(bn.values()))
    assert max(bn.values()) <= 1e-5, max(bn, key=bn.get)


def test_stage3_step_float32(jax_model, port_float32_step):
    jm, variables, batch = jax_model
    ref_losses, ref_coarse, ref = jax_step(jm, variables, batch, np.float32)
    port, losses, aux = port_float32_step
    assert_losses(losses, ref_losses)
    coarse = aux["coarse_prediction"].detach().numpy()
    assert coarse.shape == ref_coarse.shape == (B, *HW, 1)
    assert np.abs(coarse - ref_coarse).max() <= 1e-5 * np.abs(ref_coarse).max()
    errs = grad_errors(port, ref)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print("float32 gradient ||port - JAX|| / ||JAX||", d / n)
    assert d <= 2e-2 * n
    assert all(errs[k][1] > 0 for k in errs if ".relative_position_bias_table" in k)
    for k, got in stats_of(port).items():
        assert np.abs(got - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k


def test_trained_weights_round_trip(port_float32_step):
    """The trained stage-3 net (its BatchNorm statistics updated) goes to
    the JAX package's tree through ``convert_patchrefinerplus`` and back
    through ``jax_to_state_dict`` unchanged, every tensor of the port's
    state dict but BatchNorm's step counters."""
    from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus

    port = port_float32_step[0]
    sd = {k: t.detach().numpy() for k, t in port.net.state_dict().items()}
    back = jax_to_state_dict(convert_patchrefinerplus(sd))
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


# ------------------------------------------------------------ the Functions, float64
JAX_TOL = 1e-5
PLAIN_TOL = 1e-10


def _port_grads(fn, arrays, gys, wrt):
    """``fn``'s outputs and the gradients of ``sum <out_i, gy_i>`` for the
    arrays at ``wrt``, in float64."""
    ts = [torch.from_numpy(a).requires_grad_(i in wrt) for i, a in enumerate(arrays)]
    ys = fn(*ts)
    ys = ys if isinstance(ys, tuple) else (ys,)
    gs = torch.autograd.grad(ys, [ts[i] for i in wrt], [torch.from_numpy(g) for g in gys])
    return [y.detach().numpy() for y in ys], [g.numpy() for g in gs]


def check64(port_fn, plain_fn, jax_fn, arrays, wrt, seed=0, jit=True):
    """The Function's outputs and gradients against ``jax.vjp`` of the JAX
    function (under ``jit`` unless ``jit`` is false) and against autograd
    through the plain version, in float64."""
    arrays = [np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating)
              else np.asarray(a) for a in arrays]
    with jax.enable_x64(True):
        def f(*diff):
            args = list(map(jnp.asarray, arrays))
            for i, d in zip(wrt, diff):
                args[i] = d
            out = jax_fn(*args)
            return out if isinstance(out, tuple) else (out,)

        def value_and_vjp(diff, gys):
            y, vjp = jax.vjp(f, *diff)
            return y, vjp(gys)

        diff = tuple(jnp.asarray(arrays[i]) for i in wrt)
        shapes = jax.eval_shape(f, *diff)
        rng = np.random.RandomState(seed)
        gys = tuple(jnp.asarray(rng.randn(*y.shape)) for y in shapes)
        yj, gj = (jax.jit(value_and_vjp) if jit else value_and_vjp)(diff, gys)
        gys = [np.array(g) for g in gys]
        gj = [np.asarray(g, np.float64) for g in gj]
        yj = [np.asarray(y, np.float64) for y in yj]
    ys, g = _port_grads(port_fn, arrays, gys, wrt)
    _, gp = _port_grads(plain_fn, arrays, gys, wrt)
    for y, r in zip(ys, yj):
        assert np.abs(y - r).max() <= JAX_TOL * np.abs(r).max(), "output"
    for i, a, b, c in zip(wrt, g, gj, gp):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= JAX_TOL * scale, (i, "jax", np.abs(a - b).max() / scale)
        assert np.abs(a - c).max() <= PLAIN_TOL * max(np.abs(c).max(), 1e-30), (
            i, "plain", np.abs(a - c).max() / max(np.abs(c).max(), 1e-30))
    return g


# --------------------------------------------------------------------- K1
# (B, H, W, C) levels of a patch at 64x96 process size: the roi's output
# size is the level's size and its spatial scale h / 64, as ``PRPlusNet._roi``
# calls it
LEVELS = [(4, 6), (16, 24), (64, 96)]
BOXES = {
    # stage 3: one box per image, box_idx = arange(B)
    "train": (np.array([[0.0, 0.0, 48.0, 32.0], [10.5, 7.25, 96.0, 64.0],
                        [31.0, 2.0, 77.0, 41.5], [0.0, 0.0, 96.0, 64.0]]), [0, 1, 2, 3], 4),
    # boxes at and past the border (samples clamped or zero), two images
    # sharing boxes and one image (1) with no box at all
    "border": (np.array([[-6.0, -4.0, 30.0, 20.0], [70.0, 50.0, 101.0, 70.0],
                         [-1.0, 60.0, 96.0, 66.0], [95.0, 0.0, 96.0, 64.0]]), [0, 2, 2, 0], 3),
}


@pytest.mark.parametrize("boxes", list(BOXES))
@pytest.mark.parametrize("level", LEVELS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_roi_align_function_grads(level, boxes):
    box, idx, b = BOXES[boxes]
    h, w = level
    c = 1 if h == 64 else 3  # the coarse depth, a feature level
    feats = np.random.RandomState(1).randn(b, h, w, c)
    boxes_t, idx_t = torch.from_numpy(box).float(), torch.tensor(idx, dtype=torch.int32)
    scale = h / 64
    g = check64(
        lambda f: roi_align(f, boxes_t, idx_t, (h, w), scale),
        lambda f: roi_align_plain(f, boxes_t, idx_t, (h, w), scale),
        lambda f: roi_align_mxu.__wrapped__(f, jnp.asarray(box, jnp.float32),
                                            jnp.asarray(idx, jnp.int32), (h, w), scale),
        [feats], wrt=[0], jit=False)
    if boxes == "border":
        assert not g[0][1].any() and g[0][0].any() and g[0][2].any()  # image 1 has no box


# ------------------------------------------------------------------- K3/K4
@pytest.mark.parametrize("grid", [(3, 4), (2, 2)])
def test_attention_function_grads_with_bias(grid):
    """K3: dq, dk, dv and the table's gradient, the cls token's three rows
    included (S = gh * gw + 1)."""
    gh, gw = grid
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 3, gh * gw + 1, 16) for _ in range(3))
    table = 0.5 * rng.randn((2 * gh - 1) * (2 * gw - 1) + 3, 3)
    g = check64(
        lambda q, k, v, t: attention(q, k, v, 0.25, t, grid),
        lambda q, k, v, t: attention_plain(q, k, v, 0.25, t, grid),
        lambda q, k, v, t: mha(q, k, v, 0.25, j_rel_bias(t, gh, gw)),
        [q, k, v, table], wrt=[0, 1, 2, 3])
    assert np.abs(g[3][-3:]).min() > 0  # the cls rows get their gradient


def test_attention_function_grads_without_bias():
    """K4 (DINOv2's form): dq, dk, dv."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 2, 17, 16) for _ in range(3))
    check64(lambda q, k, v: attention(q, k, v, 0.25), lambda q, k, v: attention_plain(q, k, v, 0.25),
            lambda q, k, v: mha(q, k, v, 0.25), [q, k, v], wrt=[0, 1, 2])


# --------------------------------------------------------------------- K8
# (h, w) of the previous centres -> (H, W) of the layer: the flagship's 2x
# ratio, an odd ratio, and equal sizes (no resize)
SIZE_PAIRS = [((6, 8), (12, 16)), ((5, 7), (9, 13)), ((6, 8), (6, 8))]
# the flagship's form at every pair, each other form at the 2x pair
CASES = [(pair, ("mean", "inv", False)) for pair in SIZE_PAIRS] + [
    (SIZE_PAIRS[0], form) for form in (("sum", "inv", False), ("mean", "exp", False),
                                       ("sum", "exp", False), ("mean", "inv", True),
                                       ("sum", "exp", True), ("mean", "exp", True))]


@pytest.mark.parametrize("pair,form", CASES,
                         ids=lambda c: "-".join(map(str, c[0] if isinstance(c[0], tuple) else c)))
def test_attractor_function_grads(pair, form):
    """The flagship's unnormed inv/mean form and each other form: the
    gradients in the attractor points and the previous centres (through the
    taken-in resize); a normed layer's both outputs."""
    (src, out), (kind, typ, normed) = pair, form
    rng = np.random.RandomState(4)
    s = 1.0 if normed else 3.0
    a = rng.rand(2, *out, 4) * s
    b_prev = rng.rand(2, *src, 10) * s
    check64(
        lambda a, b: attractor_update(a, b, kind, typ, normed, 1e-3, 10.0),
        lambda a, b: attractor_update_plain(a, b, kind, typ, normed, 1e-3, 10.0),
        lambda a, b: _jax_attractor(a, b, kind, typ, normed),
        [a, b_prev], wrt=[0, 1])


def _jax_log_binomial(pt, centers, k, min_temp, max_temp):
    """zoedepth.py:200-217 from the softplus output on, then :375-376."""
    p, t = pt[..., :2] + 1e-4, pt[..., 2:] + 1e-4
    p = p[..., 0] / (p[..., 0] + p[..., 1])
    t = t[..., 0] / (t[..., 0] + t[..., 1])
    t = (max_temp - min_temp) * t + min_temp
    k_idx = jnp.arange(k, dtype=jnp.float32)
    p = jnp.clip(p[..., None], 1e-4, 1.0)
    one_minus_p = jnp.clip(1.0 - p, 1e-4, 1.0)
    y = Z.log_binom(jnp.float32(k - 1), k_idx) + k_idx * jnp.log(p) + (k - 1 - k_idx) * jnp.log(one_minus_p)
    probs = jax.nn.softmax(y / t[..., None], axis=-1)
    return jnp.sum(probs * Z._interp(centers, probs.shape[1:3]), axis=-1, keepdims=True)


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("src,out", [((6, 8), (12, 16)), ((12, 16), (12, 16))])
def test_log_binomial_function_grads(src, out, k):
    """The gradients in ``pt`` and in the centres at the previous size
    (through the taken-in resize), with the flagship's temperatures. JAX
    runs eagerly: under ``jit`` XLA folds the float32 ``log_binom`` table to
    other last bits (up to 6.6e-5 of the gradient at K = 64 after the
    softmax at temperature 0.0212)."""
    rng = np.random.RandomState(5)
    pt = np.log1p(np.exp(rng.randn(2, *out, 4) * 2.0))
    centers = rng.rand(2, *src, k) * 20.0
    check64(
        lambda p, c: log_binomial_depth(p, c, k, 0.0212, 50.0),
        lambda p, c: log_binomial_depth_plain(p, c, k, 0.0212, 50.0),
        lambda p, c: _jax_log_binomial(p, c, k, 0.0212, 50.0),
        [pt, centers], wrt=[0, 1], jit=False)


def test_functions_run_the_kernel_path_without_grad():
    """Under no gradient the wrappers return their forward as before, with
    no autograd node; a gradient in bfloat16 raises (training is float32)."""
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(1, 2, 5, 16)).float().requires_grad_(True)
    with torch.no_grad():
        assert attention(q, q, q, 0.25).grad_fn is None
    with pytest.raises(TypeError):
        attention(*(q.bfloat16().requires_grad_(True) for _ in range(3)), 0.25)
    with pytest.raises(TypeError):
        roi_align(torch.rand(1, 4, 4, 2, dtype=torch.bfloat16, requires_grad=True),
                  torch.tensor([[0.0, 0.0, 2.0, 2.0]]), torch.zeros(1, dtype=torch.int32), (4, 4))


def test_jax_frozen_coarse_branch_passes_no_gradient(jax_model):
    """With ``e2e_training`` off the JAX package's ``coarse_forward`` stops
    the gradient (``stop_gradient``): its coarse leaves get zeros."""
    _, variables, batch = jax_model
    frozen = MODELS.build(dict(type="PatchRefinerPlus", config=e2e_config(e2e=False)))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    image = jnp.asarray(batch["image_lr"], jnp.float32)

    def out_sum(coarse):
        feats, pred = frozen.net.apply({"params": dict(params, coarse=coarse)}, image,
                                       method=JPRPlusNet.coarse_forward)
        return sum(jnp.sum(f) for f in feats) + jnp.sum(pred)

    grads = jax.jit(jax.grad(out_sum))(params["coarse"])
    leaves = jax.tree_util.tree_leaves(grads)
    assert leaves and not any(np.asarray(g).any() for g in leaves)
