"""Stage 3 (``configs/patchrefinerv2_zoedepth/v2_eff_u4k.py``) through the
port's ``Trainer`` and CLI on the CPU, from a refiner-pretraining checkpoint
the port wrote, at the tiny flagship topology of tests/test_torch_slice.py
(a 4-block BEiT, 48x64 patches of a 96x128 frame).

- ``utils/checkpoint.apply_config_pretrained``: the ``pretrained`` merge of
  a stage-2 checkpoint (``pretrain_eff_m0s1``: no coarse branch, the refiner
  with its decoder and a 3-channel stem, the fusion head at the decoder's
  widths) into the stage-3 net follows the JAX package's
  ``merge_pretrained`` rule (a tensor is taken where its key and shape
  match, everything else kept; checked on the nested trees of both state
  dicts), running statistics included; ``load_whole=False`` drops the
  checkpoint's coarse branch first; a missing path keeps the random init;
  ``pretrain_coarse_model`` takes a checkpoint's ``coarse_branch.`` tensors
  alone (tests/test_torch_baseline_pretrain.py holds it to JAX).
- One ``Trainer`` epoch (a step of batch 2) from that checkpoint, with the
  default m1 validation on the trained model: finite losses, the coarse
  branch (trained end to end), the refiner, the fusion head and the
  BatchNorm statistics move; the checkpoint resumes bit for bit.
- The CLI on the same config.
- The port alone, on the tiny topology of tests/test_torch_train_e2e.py
  with its own random weights: remat on and off give the same gradients and
  statistics, updated once; with ``e2e_training`` off the coarse branch
  runs under no gradient (its leaves get none) and every other leaf gets
  the end-to-end step's gradient; without ``update_stats`` the loss runs
  BatchNorm on its running statistics and updates nothing, as JAX's loss
  with ``mutable=False`` does; tiled inference with ``remat`` on calls no
  checkpoint.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from patchrefinerv2_tpu.utils.checkpoint import merge_pretrained as j_merge_pretrained

from patchrefinerv2_torch.config import Config
from patchrefinerv2_torch.datasets.base import DataLoader
from patchrefinerv2_torch.datasets.synthetic import SyntheticDataset
from patchrefinerv2_torch.models.patchrefinerplus import PatchRefinerPlus
from patchrefinerv2_torch.train import main as train_main
from patchrefinerv2_torch.training.trainer import Trainer
from patchrefinerv2_torch.utils.checkpoint import apply_config_pretrained, save_checkpoint
from tests.test_torch_train_e2e import B, HW, e2e_config, make_batch


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: a checkpoint written
    here takes up to 1.5 GB, and pytest keeps the temp dirs of three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


CONFIGS = os.path.abspath("configs/patchrefinerv2_zoedepth")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread for this module: the suite runs several
    workers on the CPU at once, and a pool of one thread per core in each of
    them stalls the port's CPU steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = """
_base_ = [{base!r}]
model = dict(config=dict(
    image_raw_shape=[96, 128], patch_process_shape=[48, 64], patch_split_num=[2, 2],
    pretrained={pretrained!r},
    coarse_branch=dict(n_bins=16, bin_embedding_dim=16, trunk=dict(
        embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3], features=32,
        out_channels=[24, 32, 48, 48]))))
train_dataloader = dict(batch_size=2, dataset=dict(
    type="SyntheticDataset", mode="train", length=2, image_raw_shape=[96, 128],
    network_process_size=[48, 64], patch_raw_shape=[48, 64]))
val_dataloader = {val}
train_cfg = dict(max_epochs=1, log_interval=1, save_checkpoint_interval=1, val_interval=1,
                 train_log_img_interval=0)
"""


VAL = """dict(batch_size=1, dataset=dict(
    type="SyntheticDataset", mode="infer", length=1, image_raw_shape=[96, 128],
    network_process_size=[48, 64], patch_raw_shape=[48, 64]))"""


def tiny_config(tmp_path, name, base, val=VAL, **fill) -> Config:
    path = tmp_path / f"{name}.py"
    path.write_text(TINY.format(base=os.path.join(CONFIGS, base), val=val, **fill))
    return Config.fromfile(str(path))


@pytest.fixture(scope="module")
def stage2_checkpoint(tmp_path_factory):
    """A refiner-pretraining checkpoint written by the port (its network
    state, as ``Trainer.save`` writes it, without the optimizer's)."""
    tmp = tmp_path_factory.mktemp("stage2")
    cfg = tiny_config(tmp, "tiny_pretrain", "pretrain_eff_m0s1.py", pretrained=None)
    sd = PatchRefinerPlus(cfg.model.config, device="cpu", seed=7).net.state_dict()
    path = str(tmp / "checkpoint_01")
    save_checkpoint(path, {"state_dict": sd})
    yield path, sd
    shutil.rmtree(tmp, ignore_errors=True)


def _tree(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return out


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_pretrained_merge_follows_jax_rule(tmp_path, stage2_checkpoint):
    path, pre = stage2_checkpoint
    cfg = tiny_config(tmp_path, "tiny", "v2_eff_u4k.py", pretrained=path)
    model = PatchRefinerPlus(cfg.model.config, device="cpu", seed=3)
    init = {k: v.clone() for k, v in model.net.state_dict().items()}
    report = apply_config_pretrained(model)
    got = model.net.state_dict()
    want = _flat(j_merge_pretrained(_tree(init), _tree(pre)))
    assert sorted(want) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    taken = [k for k in pre if k in init and init[k].shape == pre[k].shape]
    assert report["pretrained"]["taken"] == len(taken) > 0
    assert report["pretrained"]["kept"] == len(init) - len(taken)
    enc = "refiner_fine_branch.refiner_encoder."
    # the encoder's blocks and their running statistics are the checkpoint's;
    # its stem (4 channels here, 3 there) and the fusion head at other widths
    # stay as they were
    for k in (enc + "blocks.1.0.conv_pw.weight", enc + "blocks.1.0.bn1.running_var"):
        assert torch.equal(got[k], pre[k]), k
    for k in (enc + "conv_stem.weight", "refiner_fusion_model.c2f.scratch.layer1_rn.weight"):
        assert k in pre and pre[k].shape != got[k].shape and torch.equal(got[k], init[k]), k
    assert all(torch.equal(got[k], init[k]) for k in got if k.startswith("coarse_branch."))


def test_pretrained_load_whole_missing_and_coarse(tmp_path):
    cfg = tiny_config(tmp_path, "tiny", "v2_eff_u4k.py", pretrained=None)
    other = PatchRefinerPlus(cfg.model.config, device="cpu", seed=4).net.state_dict()
    path = str(tmp_path / "stage3_ckpt")
    save_checkpoint(path, {"state_dict": other})
    model = PatchRefinerPlus(cfg.model.config, device="cpu", seed=3)
    init = {k: v.clone() for k, v in model.net.state_dict().items()}
    mcfg = model.config
    for load_whole in (True, False):
        model.net.load_state_dict(init)
        mcfg.update(pretrained=path, load_whole=load_whole)
        apply_config_pretrained(model)
        for k, v in model.net.state_dict().items():
            src = init if k.startswith("coarse_branch.") and not load_whole else other
            assert torch.equal(v, src[k]), (load_whole, k)
    model.net.load_state_dict(init)
    mcfg.update(pretrained=str(tmp_path / "missing"), whole_pretrained=None)
    assert apply_config_pretrained(model) == {}
    assert all(torch.equal(v, init[k]) for k, v in model.net.state_dict().items())
    # ``pretrain_coarse_model`` takes the checkpoint's depth network alone:
    # its ``coarse_branch.`` tensors, into the coarse branch
    model.net.load_state_dict(init)
    mcfg.update(pretrained=None, pretrain_coarse_model=path)
    report = apply_config_pretrained(model)
    coarse = [k for k in init if k.startswith("coarse_branch.")]
    assert report["pretrain_coarse_model"]["taken"] == len(coarse) > 0
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, (other if k in coarse else init)[k]), k


def test_trainer_epoch_save_resume(tmp_path, stage2_checkpoint):
    """One epoch (a step) of stage 3 from the stage-2 checkpoint through
    Trainer.run, the m1 validation after it; then a Trainer on a model of
    another seed resumes from its checkpoint: network, optimizer, step and
    epoch restored bit for bit."""
    path, pre = stage2_checkpoint

    def trainer(seed, **extra):
        c = tiny_config(tmp_path, "tiny", "v2_eff_u4k.py", pretrained=path)
        c.update(seed=3, **extra)
        model = PatchRefinerPlus(c.model.config, device="cpu", seed=seed)
        ds = {k: v for k, v in c.train_dataloader.dataset.items() if k != "type"}
        val = {k: v for k, v in c.val_dataloader.dataset.items() if k != "type"}
        loader = DataLoader(SyntheticDataset(**ds), batch_size=2, shuffle=True, seed=3)
        return Trainer(c, model, loader, DataLoader(SyntheticDataset(**val), batch_size=1),
                       work_dir=str(tmp_path / "wd"))

    tr = trainer(3)
    enc = "refiner_fine_branch.refiner_encoder."
    assert torch.equal(tr.model.net.state_dict()[enc + "blocks.2.1.conv_dw.weight"],
                       pre[enc + "blocks.2.1.conv_dw.weight"])
    before = {k: v.clone() for k, v in tr.model.net.state_dict().items()}
    tr.run()
    assert tr.step == 1
    after = tr.model.net.state_dict()
    for key in ("coarse_branch.core.core.pretrained.model.blocks.0.attn.relative_position_bias_table",
                "coarse_branch.attractors.0._net.0.weight", enc + "conv_stem.weight",
                "refiner_fusion_model.final_conv.weight", enc + "bn1.running_var"):
        assert not torch.equal(before[key], after[key]), key
    lines = [json.loads(ln) for ln in (tmp_path / "wd" / "metrics.jsonl").read_text().splitlines()]
    steps = [ln for ln in lines if "total_loss" in ln]
    assert len(steps) == 1 and all(np.isfinite(ln[k]) for ln in steps
                                   for k in ("sig_fine_loss", "gm_loss", "total_loss"))
    assert any(np.isfinite(ln.get("Val/rmse", np.nan)) for ln in lines)
    ckpt = tmp_path / "wd" / "checkpoint_01"
    assert ckpt.exists()

    tr2 = trainer(99, resume_from=str(ckpt))
    assert (tr2.step, tr2.start_epoch) == (1, 2)
    for k, v in tr2.model.net.state_dict().items():
        assert torch.equal(v, after[k]), k
    assert tr2.optimizer.count == tr.optimizer.count == 1
    for k in tr.optimizer.mu:
        assert torch.equal(tr2.optimizer.mu[k], tr.optimizer.mu[k]), k
        assert torch.equal(tr2.optimizer.nu[k], tr.optimizer.nu[k]), k


def test_train_cli(tmp_path, stage2_checkpoint):
    path, _ = stage2_checkpoint
    config = tmp_path / "tiny_cli.py"
    config.write_text(TINY.format(base=os.path.join(CONFIGS, "v2_eff_u4k.py"), pretrained=path,
                                  val=None))
    wd = tmp_path / "cli"
    train_main([str(config), "--work-dir", str(wd), "--device", "cpu", "--seed", "5"])
    assert (wd / "checkpoint_01").exists()
    lines = (wd / "metrics.jsonl").read_text().splitlines()
    assert sum("gm_loss" in ln for ln in lines) == 1
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def stage3_step(remat=True, e2e=True):
    """The port's float32 stage-3 step on the e2e tests' batch, from its own
    random weights (seed 5)."""
    port = PatchRefinerPlus(e2e_config(remat, e2e), device="cpu", seed=5).train()
    ld, _ = port.loss(make_batch(), update_stats=True)
    ld["total_loss"].backward()
    return port, {k: float(v.detach()) for k, v in ld.items()}


@pytest.fixture(scope="module")
def e2e_step():
    return stage3_step()


def test_remat_on_and_off_agree(e2e_step):
    """torch.utils.checkpoint runs the refiner and the fusion head again in
    the backward: the gradients and the running statistics (updated once)
    are those of the run without it."""
    (a, _), (b, _) = e2e_step, stage3_step(remat=False)
    start = PatchRefinerPlus(e2e_config(), device="cpu", seed=5).net.state_dict()
    for (k, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert p.grad is not None and q.grad is not None, k
        torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=1e-6 * float(q.grad.abs().max()))
    sa, sb = a.net.state_dict(), b.net.state_dict()
    for k in sa:
        if "running_" in k:
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-6, atol=0)
        if k.endswith("num_batches_tracked"):
            assert int(sa[k]) == int(start[k]) + 1 == int(sb[k]), k


def test_frozen_coarse_gets_no_gradient(e2e_step):
    """``e2e_training=False``: the coarse branch runs under no gradient, so
    its leaves get none and every other leaf gets the end-to-end step's
    gradient (the forward is the same)."""
    (on, losses_on), (off, losses_off) = e2e_step, stage3_step(e2e=False)
    assert losses_on == losses_off
    for (k, p), q in zip(off.net.named_parameters(), on.net.parameters()):
        if k.startswith("coarse_branch."):
            assert p.grad is None, k
        else:
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=1e-6 * float(q.grad.abs().max()))


def test_loss_without_stat_updates_uses_running_stats():
    """Without ``update_stats`` (the training panel's forward) the loss runs
    the refiner's BatchNorm on its running statistics and updates nothing,
    as JAX's loss with ``mutable=False`` (``train=False``) does; with it,
    the net must be in train mode."""
    port, batch = PatchRefinerPlus(e2e_config(), device="cpu", seed=5).train(), make_batch()
    before = {k: v.clone() for k, v in port.net.state_dict().items()}
    with torch.no_grad():
        ld, aux = port.loss(batch)
        assert port.net.training and aux["depth_pred"].shape == (B, *HW, 1)
        ld_eval, _ = port.eval().loss(batch)
    for k, v in port.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(float(ld[k]) == float(ld_eval[k]) for k in ld)
    with pytest.raises(RuntimeError, match="train"):
        port.eval().loss(batch, update_stats=True)


def test_inference_runs_no_remat(monkeypatch):
    """``refine`` rematerialises only under a gradient: tiled inference with
    ``remat`` on calls no checkpoint."""
    def no_checkpoint(*args, **kwargs):
        raise AssertionError("inference rematerialised")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", no_checkpoint)
    rng = np.random.RandomState(11)
    lr, hr = rng.rand(1, *HW, 3).astype(np.float32), rng.rand(1, 96, 128, 3).astype(np.float32)
    depth, _ = PatchRefinerPlus(e2e_config(), device="cpu", seed=5).infer(lr, hr, "m1", process_num=4)
    assert depth.shape == (96, 128) and bool(torch.isfinite(depth).all())
