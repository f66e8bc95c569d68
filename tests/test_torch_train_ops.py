"""The training pieces of the port against the JAX package, on the CPU.

- The four kernels that train (K2 bilinear resize, K5 gate tail, K6
  LayerNorm, K9 tail conv) are ``torch.autograd.Function``s: each one's
  input and parameter gradients against ``jax.vjp`` of the JAX function on
  the same numpy inputs and output gradient, and against autograd through
  the port's plain version. Bar: max |port - ref| <= 1e-5 * max |ref| per
  gradient (float32; both sides sum in other orders).
- SILog and GradMatch (value and gradient, with the mask, the ``n <= 1``
  guard and ``_align_pred``'s resize) against ``models/losses.py``: 1e-6
  relative on the value, 1e-5 of the magnitude on the gradient.
- The OneCycle learning rate and cycled ``b1`` over whole runs against
  ``_onecycle_lr_schedule`` / ``_momentum_schedule`` (both float32: 1e-6
  of the schedule's peak), and ``build_optimizer`` against optax over 5 steps on the same
  gradients, with clipping, ``lr_mult`` and a frozen prefix (parameters and
  moments within 1e-6 relative).
- Train-mode BatchNorm against flax's ``nn.BatchNorm`` (momentum 0.9,
  eps 1e-3): output, gradients and running statistics (1e-5 relative), and
  the statistics updated once per armed step.
- The wrappers of the kernels without a backward (K10, the crop-resize,
  nearest K2) raise under grad; K1, K3/K4 and K8 have theirs
  (tests/test_torch_train_e2e.py), bicubic K2 its transpose
  (tests/test_torch_baseline_pretrain.py).
"""

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.blocks.convs import DotLayerNorm
from patchrefinerv2_tpu.models.blocks.convs import gelu as j_gelu
from patchrefinerv2_tpu.models.blocks.convs import relu as j_relu
from patchrefinerv2_tpu.models.blocks.dpt import _conv_same, _layer_norm
from patchrefinerv2_tpu.models.losses import GradMatchLoss as JGradMatch
from patchrefinerv2_tpu.models.losses import SILogLoss as JSILog
from patchrefinerv2_tpu.ops.resize import resize as j_resize
from patchrefinerv2_tpu.training.optim import (
    _momentum_schedule, _onecycle_lr_schedule, build_optimizer as j_build_optimizer,
)

from patchrefinerv2_torch.models.backbones.encoders import BatchNorm, arm_stat_updates
from patchrefinerv2_torch.models.losses import GradMatchLoss, SILogLoss
from patchrefinerv2_torch.ops.gated import gate_tail, gate_tail_plain
from patchrefinerv2_torch.ops.layer_norm import layer_norm, layer_norm_plain
from patchrefinerv2_torch.ops.quant import quant_conv
from patchrefinerv2_torch.ops.resize import crop_resize, resize, resize_plain
from patchrefinerv2_torch.ops.tail_conv import tail_conv, tail_conv_plain
from patchrefinerv2_torch.training.optim import (
    build_optimizer, momentum_schedule, onecycle_lr_schedule,
)
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

TOL = 1e-5


def _grads(fn, arrays, gy, wrt):
    """``fn(*tensors)``'s output and the gradients of ``<out, gy>`` for the
    arrays at indices ``wrt`` (torch)."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(i in wrt)
          for i, a in enumerate(arrays)]
    y = fn(*ts)
    gs = torch.autograd.grad(y, [ts[i] for i in wrt], torch.from_numpy(gy))
    return y.detach().numpy(), [g.numpy() for g in gs]


def _jax_grads(fn, arrays, gy, wrt):
    def f(*diff):
        args = list(map(jnp.asarray, arrays))
        for i, d in zip(wrt, diff):
            args[i] = d
        return fn(*args)

    y, vjp = jax.vjp(f, *(jnp.asarray(arrays[i]) for i in wrt))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(gy))]


def check_function(port_fn, plain_fn, jax_fn, arrays, wrt, seed=0):
    """The Function's output and gradients against JAX's and against
    autograd through the plain version."""
    y_ref = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    gy = np.random.RandomState(seed).randn(*y_ref.shape).astype(np.float32)
    y, g = _grads(port_fn, arrays, gy, wrt)
    yj, gj = _jax_grads(jax_fn, arrays, gy, wrt)
    _, gp = _grads(plain_fn, arrays, gy, wrt)
    np.testing.assert_allclose(y, yj, rtol=0, atol=TOL * np.abs(yj).max())
    for i, a, b, c in zip(wrt, g, gj, gp):
        scale = max(np.abs(b).max(), 1e-30)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert np.abs(a - b).max() <= TOL * scale, (i, np.abs(a - b).max() / scale)
        assert np.abs(a - c).max() <= TOL * scale, (i, np.abs(a - c).max() / scale)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# --------------------------------------------------------------------- K2
@pytest.mark.parametrize("channels", [1, 32])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(23, 37), (5, 6)], ids=["up", "down"])
def test_resize_function_grads(size, align_corners, channels):
    x = _randn(np.random.RandomState(1), 2, 11, 14, channels)
    check_function(
        lambda t: resize(t, size, "bilinear", align_corners),
        lambda t: resize_plain(t, size, "bilinear", align_corners),
        lambda t: j_resize(t, size, mode="bilinear", align_corners=align_corners),
        [x], wrt=[0])


# --------------------------------------------------------------------- K6
def test_layer_norm_function_grads():
    rng = np.random.RandomState(2)
    x = _randn(rng, 2, 5, 6, 64, scale=2.0) + 0.5
    w = 1.0 + _randn(rng, 64, scale=0.2)
    b = _randn(rng, 64, scale=0.2)
    ln = DotLayerNorm()
    check_function(
        lambda t, s, c: layer_norm(t, s, c), lambda t, s, c: layer_norm_plain(t, s, c),
        lambda t, s, c: ln.apply({"params": {"scale": s, "bias": c}}, t),
        [x, w, b], wrt=[0, 1, 2])


# --------------------------------------------------------------------- K5
@pytest.mark.parametrize("gate", [True, False], ids=["gate_on", "gate_off"])
def test_gate_tail_function_grads(gate):
    c = 32
    rng = np.random.RandomState(3)
    f = _randn(rng, 2, 5, 6, c, scale=2.0)
    out = _randn(rng, 2, 5, 6, c)
    w = _randn(rng, c, c, 1, 1, scale=c ** -0.5)
    lw, lb = 1.0 + _randn(rng, c, scale=0.2), _randn(rng, c, scale=0.2)

    def jax_fn(f, out, w, lw, lb):
        z = _conv_same(j_relu(_layer_norm(f, lw, lb)), jnp.transpose(w, (2, 3, 1, 0)), None)
        return out * jax.nn.sigmoid(z) if gate else z

    o = (lambda x: x) if gate else (lambda x: None)
    check_function(
        lambda f, out, w, lw, lb: gate_tail(f, o(out), w, lw, lb),
        lambda f, out, w, lw, lb: gate_tail_plain(f, o(out), w, lw, lb),
        jax_fn, [f, out, w, lw, lb], wrt=[0, 2, 3, 4] + ([1] if gate else []))


# --------------------------------------------------------------------- K9
# the tail sites' epilogues: C2F out_conv / output_conv3 (bias), the
# GatedConvUnit conv (relu_in + residual), output_conv2 (bias + ReLU),
# SingleConvCNNLN (LN + GELU), DoubleConv (GELU), final_conv at inference
# (residual + ReLU, the clamp)
EPILOGUES = {
    "bias": dict(bias=True), "gcu": dict(relu_in=True, residual=True),
    "bias_relu": dict(bias=True, act="relu"), "ln_gelu": dict(ln=True, act="gelu"),
    "gelu": dict(act="gelu"), "residual_relu": dict(residual=True, act="relu"),
}


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
def test_tail_conv_function_grads(n_parts, k, epilogue):
    ep = EPILOGUES[epilogue]
    rng = np.random.RandomState(4)
    widths = (6, 3, 1, 4)[:n_parts]
    cout = 8
    parts = [_randn(rng, 2, 6, 7, c) for c in widths]
    w = _randn(rng, cout, sum(widths), k, k, scale=(sum(widths) * k * k) ** -0.5)
    bias, res = _randn(rng, cout, scale=0.2), _randn(rng, 2, 6, 7, cout)
    lw, lb = 1.0 + _randn(rng, cout, scale=0.2), _randn(rng, cout, scale=0.2)
    act = ep.get("act", "none")

    def torch_fn(fn):
        def run(w, bias, res, lw, lb, *ps):
            return fn(list(ps), w, bias if ep.get("bias") else None,
                      res if ep.get("residual") else None, (lw, lb) if ep.get("ln") else None,
                      act=act, relu_in=ep.get("relu_in", False))
        return run

    def jax_fn(w, bias, res, lw, lb, *ps):
        x = jnp.concatenate(ps, axis=-1)
        if ep.get("relu_in"):
            x = j_relu(x)
        y = _conv_same(x, jnp.transpose(w, (2, 3, 1, 0)), bias if ep.get("bias") else None)
        if ep.get("residual"):
            y = y + res
        if ep.get("ln"):
            y = _layer_norm(y, lw, lb)
        return {"none": lambda v: v, "relu": j_relu, "gelu": j_gelu}[act](y)

    used = [0] + [i for i, key in ((1, "bias"), (2, "residual"), (3, "ln"), (4, "ln")) if ep.get(key)]
    check_function(torch_fn(tail_conv), torch_fn(tail_conv_plain), jax_fn,
                   [w, bias, res, lw, lb, *parts], wrt=used + list(range(5, 5 + n_parts)))


# ----------------------------------------------------------------- losses
def _loss_inputs(case, rng):
    pred = np.maximum(_randn(rng, 2, 12, 16, 1, scale=4.0) + 5.0, 0.0).astype(np.float32)
    pred[0, :2] = 0.0  # relu'd zeros
    gt = (1.0 + 20.0 * rng.rand(2, 24, 32, 1)).astype(np.float32)
    if case == "same_size":
        gt = gt[:, ::2, ::2].copy()
    if case == "holes":
        gt[:, 3:15, 4:20] = 0.0
        gt[1, :, :5] = 200.0  # beyond max_depth
    if case == "one_valid":
        gt[:] = 0.0
        gt[0, 5, 5] = 3.0
    if case == "none_valid":
        gt[:] = 0.0
    return pred, gt


@pytest.mark.parametrize("loss", ["silog", "gradmatch"])
@pytest.mark.parametrize("case", ["resized", "same_size", "holes", "one_valid", "none_valid"])
def test_losses_match_jax(loss, case):
    pred, gt = _loss_inputs(case, np.random.RandomState(5))
    port, ref = {"silog": (SILogLoss(), JSILog()), "gradmatch": (GradMatchLoss(), JGradMatch())}[loss]
    p = torch.from_numpy(pred).requires_grad_(True)
    val = port(p, torch.from_numpy(gt), 1e-3, 80)
    val.backward()
    vj, gj = jax.value_and_grad(lambda q: ref(q, jnp.asarray(gt), 1e-3, 80))(jnp.asarray(pred))
    vj, gj = float(vj), np.asarray(gj)
    val = float(val.detach())
    assert abs(val - vj) <= 1e-6 * max(abs(vj), 1e-30), (val, vj)
    if case in ("one_valid", "none_valid"):
        assert vj == 0.0 and val == 0.0
    np.testing.assert_allclose(p.grad.numpy(), gj, rtol=0, atol=TOL * max(np.abs(gj).max(), 1e-30))


# ------------------------------------------------------------ data, panels
def test_synthetic_train_batches_match_jax():
    """SyntheticDataset's train and consistency items are JAX's (the same
    numpy draws; the resized images within float32 rounding of JAX's
    float64 resize), and the loader shuffles as JAX's does by seed and
    epoch."""
    from patchrefinerv2_tpu.datasets.base import DataLoader as JLoader
    from patchrefinerv2_tpu.datasets.synthetic import SyntheticDataset as JSynthetic

    from patchrefinerv2_torch.datasets.base import DataLoader
    from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset

    kw = dict(length=5, image_raw_shape=(64, 96), network_process_size=(16, 24),
              patch_raw_shape=(32, 48), seed=3)
    for extra in ({}, {"consistency": True}):
        port, ref = SyntheticDataset(mode="train", **kw, **extra), JSynthetic(mode="train", **kw, **extra)
        a, b = port[2], ref[2]
        assert sorted(a) == sorted(b)
        for k in ("depth_gt", "crop_depths", "bboxs"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("image_lr", "crops_image_hr"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    loader = DataLoader(SyntheticDataset(mode="train", **kw), batch_size=2, shuffle=True, seed=7)
    jl = JLoader(JSynthetic(mode="train", **kw), batch_size=2, shuffle=True, seed=7, num_prefetch=0)
    for epoch in (1, 2):
        loader.set_epoch(epoch)
        jl.set_epoch(epoch)
        assert loader._indices() == jl._indices() and len(loader) == len(jl) == 2
        np.testing.assert_array_equal(next(iter(loader))["depth_gt"], next(iter(jl))["depth_gt"])


def test_metrics_logger_panel(tmp_path):
    """An rgb | gt | prediction panel as one PNG, the gt's invalid pixels
    masked; none when every gt pixel is invalid."""
    import cv2

    from patchrefinerv2_torch.utils.metrics_logger import MetricsLogger

    rng = np.random.RandomState(8)
    gt = (1.0 + 20.0 * rng.rand(1, 12, 16, 1)).astype(np.float32)
    gt[0, :3] = 0.0
    logger = MetricsLogger(str(tmp_path))
    path = logger.log_images({"rgb": rng.rand(1, 12, 16, 3), "depth_pred": torch.rand(1, 12, 16, 1),
                              "depth_gt": gt}, step=3)
    assert cv2.imread(path).shape == (12, 48, 3)
    assert logger.log_images({"depth_pred": gt, "depth_gt": np.zeros_like(gt)}) is None
    logger.log({"loss": 1.5}, 3)
    logger.close()
    assert '"loss": 1.5' in (tmp_path / "metrics.jsonl").read_text()


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("total_steps", [1, 3, 40, 1000])
def test_schedules_match_jax(total_steps):
    lr_j = _onecycle_lr_schedule(total_steps, 1.2e-4, 0.3, 2.0, 100.0)
    b1_j = _momentum_schedule(total_steps, 0.3, 0.85, 0.95)
    lr_p = onecycle_lr_schedule(total_steps, 1.2e-4, 0.3, 2.0, 100.0)
    b1_p = momentum_schedule(total_steps, 0.3, 0.85, 0.95)
    for port, ref in ((lr_p, lr_j), (b1_p, b1_j)):
        a = np.array([float(port(s)) for s in range(total_steps + 1)])
        b = np.array([float(ref(s)) for s in range(total_steps + 1)])
        # of the schedule's peak: near the anneal's end 1 + cos is a difference
        # of nearly equal float32 numbers, and the two cosines may differ in
        # their last bit
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


OPTIM = dict(
    optimizer=dict(type="AdamW", lr=1.2e-4, weight_decay=0.01),
    clip_grad=dict(type="norm", max_norm=6.0, norm_type=2),
    paramwise_cfg=dict(custom_keys={
        "refiner_fine_branch.refiner_encoder": dict(lr_mult=0.1, decay_mult=1.0),
        "coarse_branch": dict(lr_mult=0.1, decay_mult=1.0)}),
)
SCHED = dict(cycle_momentum=True, base_momentum=0.85, max_momentum=0.95, div_factor=2,
             final_div_factor=100, pct_start=0.3)
# port parameter name -> JAX params path
LEAVES = {
    "refiner_fine_branch.refiner_encoder.conv.weight": ("fine", "refiner_encoder", "conv", "kernel"),
    "refiner_fine_branch.decoder.bias": ("fine", "decoder", "bias"),
    "refiner_fusion_model.final_conv.weight": ("fusion", "final_conv", "kernel"),
    "coarse_branch.head.weight": ("coarse", "head", "kernel"),
}


@pytest.mark.parametrize("frozen", [False, True], ids=["e2e", "frozen_coarse"])
def test_optimizer_matches_optax(frozen):
    rng = np.random.RandomState(6)
    shapes = [(8, 4, 3, 3), (16,), (1, 32, 3, 3), (5, 7)]
    init = {k: _randn(rng, *s) for k, s in zip(LEAVES, shapes)}
    # gradient norms around max_norm: some steps clip, some do not
    grads = [{k: _randn(rng, *v.shape, scale=s) for k, v in init.items()}
             for s in (0.05, 0.4, 0.02, 1.0, 0.3)]

    def tree(d):
        out = {}
        for k, path in LEAVES.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(d[k])
        return out

    def leaf(t, k):
        for p in LEAVES[k]:
            t = t[p]
        return np.asarray(t)

    tx, _ = j_build_optimizer(OPTIM, SCHED, 5, tree(init),
                              frozen_prefixes=(("coarse",),) if frozen else ())
    jp = tree(init)
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, _ = build_optimizer(OPTIM, SCHED, 5, params.items(),
                             frozen_prefixes=("coarse_branch",) if frozen else ())
    for g in grads:
        upd, state = tx.update(tree(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    mu_j = state[0][1].inner_state[0].mu
    for k, p in params.items():
        a, b = p.detach().numpy(), leaf(jp, k)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), (k, np.abs(a - b).max())
        m, mj = opt.mu[k].numpy(), leaf(mu_j, k)
        assert np.abs(m - mj).max() <= 1e-6 * np.abs(mj).max(), (k, "mu")
    if frozen:
        np.testing.assert_array_equal(params["coarse_branch.head.weight"].detach().numpy(),
                                      init["coarse_branch.head.weight"])


def test_parameters_without_gradient_decay():
    """A parameter with no gradient (``.grad`` None) is updated as optax
    updates a zero gradient: by the weight decay alone."""
    p = torch.nn.Parameter(torch.ones(3))
    opt, lr = build_optimizer(OPTIM, SCHED, 5, [("x", p)])
    lr0 = float(lr(0))
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - lr0 * 0.01 * 1.0, rtol=1e-6)


# -------------------------------------------------------------- BatchNorm
def test_batch_norm_train_mode_matches_flax():
    rng = np.random.RandomState(7)
    x = _randn(rng, 2, 3, 5, 16, scale=2.0) + 1.0
    scale, bias = 1.0 + _randn(rng, 16, scale=0.2), _randn(rng, 16, scale=0.2)
    mean, var = _randn(rng, 16, scale=0.2), rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    gy = _randn(rng, *x.shape)

    def f(x, s, b):
        y, upd = bn.apply({"params": {"scale": s, "bias": b},
                           "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
                          x, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    yj, vjp, stats = jax.vjp(f, *map(jnp.asarray, (x, scale, bias)), has_aux=True)
    gj = [np.asarray(g) for g in vjp(jnp.asarray(gy))]

    m = BatchNorm(16)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean))
        m.running_var.copy_(torch.from_numpy(var))
    m.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    arm_stat_updates(m)
    y = m(xt)
    m(xt.detach())  # a second forward of the step (a rematerialisation): no update
    y.permute(0, 2, 3, 1).backward(torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(yj), rtol=0,
                               atol=TOL * np.abs(np.asarray(yj)).max())
    for got, ref in zip((xt.grad.permute(0, 2, 3, 1), m.weight.grad, m.bias.grad), gj):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())
    for got, key in ((m.running_mean, "mean"), (m.running_var, "var")):
        ref = np.asarray(stats[key])
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)
    # unarmed train-mode forwards leave the statistics alone
    before = m.running_var.clone()
    m(xt.detach())
    assert torch.equal(before, m.running_var)


# ----------------------------------------------------- no backward: raise
def _no_backward_calls():
    g = torch.Generator().manual_seed(0)

    def r(*s, grad=True):
        return torch.rand(*s, generator=g).requires_grad_(grad)

    kq = torch.ones(4, 4, 1, 1, dtype=torch.int8)
    return {
        "quant_conv": lambda: quant_conv([r(1, 4, 4, 4)], kq, torch.ones(4), torch.ones(4)),
        "crop_resize": lambda: crop_resize(r(8, 8, 3), torch.zeros(1, 2, dtype=torch.int32),
                                           (4, 4), (6, 6)),
        "resize_nearest": lambda: resize(r(1, 4, 4, 2), (8, 8), "nearest"),
    }


@pytest.mark.parametrize("name", list(_no_backward_calls()))
def test_kernels_without_backward_raise_under_grad(name):
    call = _no_backward_calls()[name]
    with pytest.raises((RuntimeError, NotImplementedError)):
        call()
    with torch.no_grad():
        call()
