"""The port's refiner pretraining stage (``pretrain_eff_m0s1``) against the
JAX package, on the CPU.

The tiny topology of tests/test_torch_slice.py (the full EfficientNet-B5
refiner, here with its SimpleDPTHead decoder and no coarse condition, and
BiDirectionalFusion at the decoder's widths, over 32x48 patches, 48x64 for
the float32 step) with the
pretraining settings: ``pretrain_stage``, ``hack_strategy="mean_0_std_1"``.
One JAX model for the module: its variables are drawn with numpy from a seed
(``randomize`` over ``jax.eval_shape`` of its init) and loaded into the
port through ``load_jax_params``; a batch of two images (32x48) with depth
(64x96) from a seed; the hacked coarse features are JAX's own draws
(``jax.random.split`` then ``normal`` per level), handed to the port. The
JAX side runs with ``remat`` off: its ``nn.remat`` of the fusion head takes
its static argument positionally, which ``pretrain_forward``'s keyword call
does not give, so the JAX package cannot build this stage with remat on
(remat changes no value). The port runs both.

Bars. One step's loss, every gradient leaf and the BatchNorm statistics
after the step, against ``jax.value_and_grad`` of ``PatchRefinerPlus.loss``
with ``mutable=["batch_stats"]``:

- float64 on both sides: loss max rel <= 1e-5; each gradient leaf
  ||port - JAX|| / ||JAX|| <= 1e-4, a leaf's norm floored at 1e-6 of the
  whole gradient's (a BatchNorm bias followed, through a linear conv, by
  another train-mode BatchNorm has a gradient that is 0 but for rounding,
  ~1e-15 here); BatchNorm statistics max rel <= 1e-5.
- float32, at 48x64 patches: the loss max rel <= 1e-5 holds, the
  gradients cannot be held to 1e-4 by any float32 run. The step is ill-conditioned at this size: its gradient is
  dominated by pixels whose prediction is barely above 0 (SILog's 1/pred),
  and train-mode BatchNorm over maps of a few pixels amplifies rounding.
  JAX's own float32 gradients move by ~1e-2 of their norm when the input
  moves by 1e-6, and differ from its float64 ones by as much. So float32
  is held to: the whole gradient within 2e-2 of its norm, and each
  BatchNorm statistic within 1e-4 of its leaf's largest value.

The float64 test is marked ``slow`` (the repo's mark for composed parity):
JAX's float64 step takes ~1 min alone on the CPU and far longer beside the
other test workers; ``pytest -m slow tests/test_torch_train_slice.py`` runs
it.

Remat on and off in the port: the same gradients and running statistics,
updated once. Then one ``Trainer`` epoch on ``SyntheticDataset``, a save and
a resume (the state restored bit for bit), the CLI on a tiny config, and the
weights' round trip.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.parallel.bn import bn_groups, set_bn_groups
from patchrefinerv2_tpu.registry import MODELS
from patchrefinerv2_tpu.utils.torch_convert import convert_patchrefinerplus

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.train import main as train_main
from patchrefinerv2_torch.training.trainer import Trainer
from patchrefinerv2_torch.utils.jax_weights import jax_to_state_dict, load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from tests.test_torch_modules import assert_same_tree, randomize
from tests.test_torch_slice import slice_config


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: a checkpoint written
    here takes up to 1.5 GB, and pytest keeps the temp dirs of three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


B = 2
KEY = jax.random.PRNGKey(3)


def pretrain_config(remat: bool, hw=(32, 48)) -> dict:
    cfg = slice_config()
    cfg.update(pretrain_stage=True, hack_strategy="mean_0_std_1", remat=remat,
               image_raw_shape=[2 * hw[0], 2 * hw[1]], patch_process_shape=list(hw))
    cfg["refiner"]["fine_branch"].update(coarse_condition=False, with_decoder=True)
    return cfg


def make_case(hw):
    """(JAX model, its variables, a batch) at patches of ``hw``."""
    jm = MODELS.build(dict(type="PatchRefinerPlus", config=pretrain_config(False, hw)))
    variables = randomize(jax.eval_shape(jm.init, KEY), seed=21)
    rng = np.random.RandomState(5)
    h, w = hw
    batch = dict(image_lr=rng.rand(B, h, w, 3), depth_gt=1.0 + 20.0 * rng.rand(B, 2 * h, 2 * w, 1))
    return jm, variables, batch


@pytest.fixture(scope="module", autouse=True)
def one_bn_group():
    groups = bn_groups()
    set_bn_groups(1)  # one device: per-batch BatchNorm moments
    yield
    set_bn_groups(groups)


@pytest.fixture(scope="module")
def jax_model():
    return make_case((32, 48))


def port_model(variables, remat: bool, dtype=torch.float32, hw=(32, 48)) -> PatchRefinerPlus:
    port = PatchRefinerPlus(pretrain_config(remat, hw), device="cpu")
    load_jax_params(port, variables)
    port.net.to(dtype)
    return port.train()


def hacked_draws(port, batch, dtype):
    """JAX's hacked coarse features for the batch (pretrain_forward's
    split-then-normal per level, low resolution first), as numpy."""
    with torch.no_grad():
        feats, _ = port.net.refiner_fine_branch(torch.from_numpy(batch["image_lr"]).to(
            next(port.net.parameters()).dtype).permute(0, 3, 1, 2))
    draws, r = [], KEY
    for f, c in zip(feats, port.net.hack_chl):
        r, sub = jax.random.split(r)
        draws.append(np.asarray(jax.random.normal(sub, (f.shape[0], f.shape[2], f.shape[3], c),
                                                  dtype)))
    return draws


def jax_step(jm, variables, batch, dtype):
    """(loss, gradients, batch stats after the step) of JAX's pretraining
    loss in ``dtype``, as the port's state-dict names."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        b = {k: jnp.asarray(np.asarray(x, dtype)) for k, x in batch.items()}

        def loss(p):
            ld, aux = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, b, rng=KEY,
                              mutable=["batch_stats"])
            return ld["total_loss"], aux["variables"]["batch_stats"]

        (value, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        return float(value), jax_to_state_dict({"params": jax.device_get(grads),
                                                "batch_stats": jax.device_get(stats)})


def port_step(variables, batch, dtype, remat=True):
    """The port's step in ``dtype`` on the JAX step's draws in that dtype."""
    port = port_model(variables, remat, dtype, batch["image_lr"].shape[1:3])
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        draws = hacked_draws(port, batch, np_dtype)
    cf = [torch.from_numpy(d).permute(0, 3, 1, 2) for d in draws]
    ld, aux = port.loss(batch, update_stats=True, coarse_features=cf)
    ld["total_loss"].backward()
    return port, float(ld["total_loss"].detach())


def grad_errors(port, ref) -> dict:
    out = {}
    for k, p in port.net.named_parameters():
        g = np.zeros(ref[k].shape) if p.grad is None else p.grad.double().numpy()
        out[k] = (np.linalg.norm(g - ref[k]), np.linalg.norm(ref[k]))
    return out


def stats_of(port) -> dict:
    return {k: v.double().numpy() for k, v in port.net.state_dict().items() if "running_" in k}


@pytest.fixture(scope="module")
def jax_float64_step(jax_model):
    jm, variables, batch = jax_model
    return jax_step(jm, variables, batch, np.float64)


@pytest.mark.slow  # composed parity, as the repo marks it: XLA's float64 step takes ~1 min
def test_pretrain_step_matches_jax_float64(jax_model, jax_float64_step):
    _, variables, batch = jax_model
    loss_j, ref = jax_float64_step
    port, loss = port_step(variables, batch, torch.float64)
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (loss, loss_j)
    errs = grad_errors(port, ref)
    total = np.sqrt(sum(n ** 2 for _, n in errs.values()))
    worst = max(errs, key=lambda k: errs[k][0] / max(errs[k][1], 1e-6 * total))
    print("float64 worst gradient leaf", worst, errs[worst])  # shown with pytest -s
    for k, (d, n) in errs.items():
        assert d <= 1e-4 * max(n, 1e-6 * total), (k, d, n)
    assert sum(n > 0 for _, n in errs.values()) > 0.9 * len(errs)  # the gradient reaches the leaves
    for k, got in stats_of(port).items():
        np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=0, err_msg=k)


def test_pretrain_step_float32(jax_model):
    """float32 against JAX's float32 step, at 48x64 patches (at 32x48 the
    float32 loss itself moves by ~5e-5 with the rounding)."""
    jm, variables, batch = make_case((48, 64))
    loss_j, ref = jax_step(jm, variables, batch, np.float32)
    port, loss = port_step(variables, batch, torch.float32)
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (loss, loss_j)
    errs = grad_errors(port, ref)
    d = np.sqrt(sum(e ** 2 for e, _ in errs.values()))
    n = np.sqrt(sum(m ** 2 for _, m in errs.values()))
    print("float32 gradient ||port - JAX|| / ||JAX||", d / n)
    assert d <= 2e-2 * n
    for k, got in stats_of(port).items():
        assert np.abs(got - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k


def test_remat_on_and_off_agree(jax_model):
    """torch.utils.checkpoint runs the refiner and the fusion head again in
    the backward: the gradients and the running statistics (updated once)
    are those of the run without it."""
    _, variables, batch = jax_model
    ports = [port_step(variables, batch, torch.float32, remat=r)[0] for r in (True, False)]
    (a, b), start = ports, port_model(variables, False)
    for (k, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert (p.grad is None) == (q.grad is None), k
        if p.grad is not None:
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=1e-6 * float(q.grad.abs().max()))
    sa, sb, s0 = a.net.state_dict(), b.net.state_dict(), start.net.state_dict()
    for k in sa:
        if "running_" in k:
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-6, atol=0)
        if k.endswith("num_batches_tracked"):
            assert int(sa[k]) == int(s0[k]) + 1 == int(sb[k]), k


def test_panel_forward_raises_like_jax(jax_model):
    """The training image panel's extra forward (``_log_train_images``) is
    the loss without updating the batch statistics: JAX's immutable apply of
    the train-mode BatchNorm raises there, and so does the port."""
    from flax.errors import ModifyScopeVariableError

    jm, variables, batch = jax_model
    with pytest.raises(ModifyScopeVariableError):
        jm.loss(variables, {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}, rng=KEY)
    port = port_model(variables, True)
    with pytest.raises(RuntimeError, match="update_stats"):
        port.loss(batch)
    port.eval()
    with pytest.raises(RuntimeError, match="train"):
        port.loss(batch, update_stats=True)


def test_other_stages_raise(jax_model):
    """What the port does not train raises: a ``train_dtype`` other than
    float32 (no config sets one); the pretraining net has no coarse branch
    to infer with. Stage 3 trains with a ZoeDepth coarse branch
    (tests/test_torch_train_e2e.py) and a Depth-Anything-V2 one
    (tests/test_torch_da2_train.py)."""
    _, variables, batch = jax_model
    with pytest.raises(NotImplementedError, match="float32"):
        PatchRefinerPlus(dict(slice_config(), train_dtype="bfloat16"), device="cpu")
    port = port_model(variables, True).eval()
    with pytest.raises(NotImplementedError):
        port.infer(batch["image_lr"][:1], np.zeros((1, 64, 96, 3)), "m1")


def test_weights_round_trip(jax_model):
    """The JAX converter maps the port's state dict back to the variables it
    was loaded from (encoder, BatchNorm statistics, fusion head at the
    decoder's widths); it has no mapping of the refiner decoder, whose
    leaves the loader's walk holds against the port's instead."""
    _, variables, _ = jax_model
    port = port_model(variables, True)
    sd = {k: t.numpy() for k, t in port.net.state_dict().items()}
    conv = convert_patchrefinerplus(sd)
    want = {"params": {"fine": {"refiner_encoder": variables["params"]["fine"]["refiner_encoder"]},
                       "fusion": variables["params"]["fusion"]},
            "batch_stats": variables["batch_stats"]}
    assert_same_tree(conv, want)
    for k, v in jax_to_state_dict(variables).items():
        if ".decoder." in k:
            np.testing.assert_array_equal(sd[k], v, err_msg=k)


TINY = """
_base_ = [{base!r}]
model = dict(config=dict(image_raw_shape=[64, 96], patch_process_shape=[32, 48],
                         patch_split_num=[2, 2]))
train_dataloader = dict(batch_size=2, dataset=dict(
    type="SyntheticDataset", length=4, image_raw_shape=[64, 96], network_process_size=[32, 48],
    patch_raw_shape=[32, 48]))
val_dataloader = None
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1,
                 train_log_img_interval=0)
"""


@pytest.fixture
def tiny_config(tmp_path):
    import os

    base = os.path.abspath("configs/patchrefinerv2_zoedepth/pretrain_eff_m0s1.py")
    path = tmp_path / "tiny_pretrain.py"
    path.write_text(TINY.format(base=base))
    return str(path)


def test_trainer_epoch_save_resume(tiny_config, tmp_path):
    """One epoch (2 steps) through Trainer.run: finite losses, parameters
    and BatchNorm statistics move, a checkpoint; then a Trainer on a model
    of another seed resumes from it: network, optimizer, step and epoch
    restored bit for bit."""
    def trainer(seed, **extra):
        c = Config.fromfile(tiny_config)
        c.update(seed=3, **extra)
        model = PatchRefinerPlus(c.model.config, device="cpu", seed=seed)
        ds = {k: v for k, v in c.train_dataloader.dataset.items() if k != "type"}
        loader = DataLoader(SyntheticDataset(**ds), batch_size=2, shuffle=True, seed=3)
        return Trainer(c, model, loader, work_dir=str(tmp_path / "wd"))

    tr = trainer(3)
    before = {k: v.clone() for k, v in tr.model.net.state_dict().items()}
    tr.run()
    assert tr.step == 2
    after = tr.model.net.state_dict()
    for key in ("refiner_fine_branch.refiner_encoder.conv_stem.weight",
                "refiner_fusion_model.final_conv.weight",
                "refiner_fine_branch.refiner_encoder.bn1.running_var"):
        assert not torch.equal(before[key], after[key]), key
    lines = (tmp_path / "wd" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all(np.isfinite(json.loads(ln)["total_loss"]) for ln in lines)
    ckpt = tmp_path / "wd" / "checkpoint_01"
    assert ckpt.exists()

    tr2 = trainer(99, resume_from=str(ckpt))
    assert (tr2.step, tr2.start_epoch) == (2, 2)
    for k, v in tr2.model.net.state_dict().items():
        assert torch.equal(v, after[k]), k
    assert tr2.optimizer.count == tr.optimizer.count == 2
    for k in tr.optimizer.mu:
        assert torch.equal(tr2.optimizer.mu[k], tr.optimizer.mu[k]), k
        assert torch.equal(tr2.optimizer.nu[k], tr.optimizer.nu[k]), k


def test_train_cli(tiny_config, tmp_path):
    wd = tmp_path / "cli"
    train_main([tiny_config, "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    assert (wd / "checkpoint_01").exists()
    assert len((wd / "metrics.jsonl").read_text().splitlines()) == 2
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
