"""The port's modules against the JAX package's, on the CPU.

Each JAX module is initialised, every leaf of its variables is redrawn with
numpy from a seed (:func:`randomize`, so that norms, layer scales, biases
and BatchNorm statistics all matter), and the same tree goes through
``load_jax_params`` into the port's counterpart. Inputs are numpy arrays
from a seed, handed to both sides; the port runs on CPU tensors, NCHW in
``channels_last`` as it runs on the card. Float32 throughout; atol 2e-4
(as tests/test_encoder_torch_parity.py) with rtol 1e-4: both sides run the
same float32 arithmetic, XLA's and oneDNN's convolutions sum in other
orders. The JAX fusion head runs its default space-to-depth tail, an exact
relayout of the port's plain one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patchrefinerv2_tpu.models.backbones.beit import MidasDPTBEiT as JMidas
from patchrefinerv2_tpu.models.backbones.encoders import EfficientNetB5Features as JEffB5
from patchrefinerv2_tpu.models.backbones.zoedepth import ZoeDepthHead as JHead
from patchrefinerv2_tpu.models.blocks.dpt import C2FModule as JC2F
from patchrefinerv2_tpu.models.blocks.dpt import GatedConvUnit as JGated
from patchrefinerv2_tpu.models.blocks.fusion import BiDirectionalFusion as JFusion
from patchrefinerv2_tpu.models.blocks.refiner import LightWeightRefiner as JRefiner
from patchrefinerv2_tpu.utils.torch_convert import convert_bidirectional_fusion

from patchrefinerv2_torch.models.backbones.beit import MidasDPTBEiT
from patchrefinerv2_torch.models.backbones.encoders import EfficientNetB5Features
from patchrefinerv2_torch.models.backbones.zoedepth import ZoeDepthHead
from patchrefinerv2_torch.models.blocks.convs import to_nchw, to_nhwc
from patchrefinerv2_torch.models.blocks.dpt import C2FModule, GatedConvUnit
from patchrefinerv2_torch.models.blocks.fusion import BiDirectionalFusion
from patchrefinerv2_torch.models.blocks.refiner import LightWeightRefiner
from patchrefinerv2_torch.utils.jax_weights import load_jax_params
from tests._torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

ATOL, RTOL = 2e-4, 1e-4


def randomize(tree, seed: int):
    """Redraw every leaf of a JAX variables tree with numpy: kernels from
    N(0, 1/fan_in), norm scales around 1, biases, BatchNorm means, q/v
    biases, the relative-position tables and the cls token around 0, BEiT
    layer scales in [0.1, 0.5] and BatchNorm variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = np.shape(leaf)
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name == "scale":
            v = 1.0 + 0.2 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name.startswith("gamma_"):
            v = rng.uniform(0.1, 0.5, shape)
        else:  # bias, mean, q_bias, v_bias, relative_position_bias_table, cls_token
            v = 0.2 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def init_random(module, seed, *args):
    """JAX variables of ``module`` for inputs ``args``, redrawn with numpy."""
    return randomize(module.init(jax.random.PRNGKey(0), *args), seed)


def nchw(x: np.ndarray) -> torch.Tensor:
    return to_nchw(torch.from_numpy(np.ascontiguousarray(x)))


def assert_close_nhwc(got: torch.Tensor, ref, what: str = ""):
    np.testing.assert_allclose(to_nhwc(got).detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def assert_same_tree(a, b):
    fa = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(a)[0]}
    fb = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(b)[0]}
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


# ---------------------------------------------------------------- coarse branch
def test_midas_dpt_beit_matches_jax():
    """Tiny BEiT trunk (dim 64, 4 blocks, 4 heads) with the full DPT decoder."""
    kw = dict(features=32, out_channels=(24, 32, 48, 48), embed_dim=64, depth=4,
              num_heads=4, taps=(0, 1, 2, 3))
    x = np.random.RandomState(0).rand(1, 48, 64, 3).astype(np.float32)
    jm = JMidas(**kw)
    v = init_random(jm, 1, jnp.asarray(x))
    rel_j, pyr_j = jm.apply(v, jnp.asarray(x))
    port = MidasDPTBEiT(img_size=(48, 64), **kw).eval()
    load_jax_params(port, v, part="MidasDPTBEiT")
    with torch.no_grad():
        rel, pyr = port(nchw(x))
    assert_close_nhwc(rel, rel_j, "rel_depth")
    assert len(pyr) == len(pyr_j) == 6
    for i, (a, b) in enumerate(zip(pyr, pyr_j)):
        assert_close_nhwc(a, b, f"pyramid level {i}")


@pytest.mark.parametrize("bin_centers_type", ["softplus", "normed"])
def test_zoedepth_head_matches_jax(bin_centers_type):
    """The bins head with the flagship's attractor settings (alpha 1000,
    kind mean, type inv) over a random MiDaS pyramid."""
    rng = np.random.RandomState(2)
    rel = rng.rand(1, 48, 64, 1).astype(np.float32)
    shapes = [(48, 64, 32), (2, 2, 32), (3, 4, 32), (6, 8, 32), (12, 16, 32), (24, 32, 32)]
    pyr = [rng.randn(1, *s).astype(np.float32) for s in shapes]
    kw = dict(n_bins=16, bin_centers_type=bin_centers_type, bin_embedding_dim=16,
              min_depth=1e-3, max_depth=80.0, n_attractors=(16, 8, 4, 1),
              attractor_kind="mean", attractor_type="inv", min_temp=0.0212, max_temp=50.0)
    jh = JHead(attractor_alpha=1000, **kw)
    v = init_random(jh, 3, jnp.asarray(rel), [jnp.asarray(p) for p in pyr])
    out_j = jh.apply(v, jnp.asarray(rel), [jnp.asarray(p) for p in pyr])
    port = ZoeDepthHead(btl_ch=32, block_chs=[32] * 4, **kw).eval()
    load_jax_params(port, v, part="ZoeDepthHead")
    with torch.no_grad():
        out = port.head_forward(nchw(rel), [nchw(p) for p in pyr])
    assert_close_nhwc(out["metric_depth"], out_j["metric_depth"], "metric_depth")
    for i, (a, b) in enumerate(zip(out["coarse_features"], out_j["coarse_features"])):
        assert_close_nhwc(a, b, f"coarse feature {i}")


# ---------------------------------------------------------------- refiner
@pytest.fixture(scope="module")
def refiner_vars():
    """One JAX LightWeightRefiner (EfficientNet-B5, 4-channel stem) at 64x96,
    its variables redrawn; shared by the encoder and refiner tests."""
    rng = np.random.RandomState(4)
    crop = rng.rand(2, 64, 96, 3).astype(np.float32)
    depth = (rng.rand(2, 64, 96, 1) * 10).astype(np.float32)
    jr = JRefiner()
    v = init_random(jr, 5, jnp.asarray(crop), jnp.asarray(depth), False)
    return jr, v, crop, depth


def test_efficientnet_b5_four_channel_stem_matches_jax(refiner_vars):
    _, v, crop, depth = refiner_vars
    x = np.concatenate([crop, depth], -1)
    enc_v = {"params": v["params"]["refiner_encoder"],
             "batch_stats": v["batch_stats"]["refiner_encoder"]}
    ref = JEffB5(in_ch=4).apply(enc_v, jnp.asarray(x), False)
    port = EfficientNetB5Features(in_ch=4).eval()
    load_jax_params(port, enc_v, part="EfficientNetB5Features")
    with torch.no_grad():
        got = port(nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [(24, 32, 48), (40, 16, 24), (64, 8, 12),
                                                 (176, 4, 6), (512, 2, 3)]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert_close_nhwc(a, b, f"encoder level {i}")


def test_lightweight_refiner_matches_jax(refiner_vars):
    jr, v, crop, depth = refiner_vars
    feats_j, depth_j = jr.apply(v, jnp.asarray(crop), jnp.asarray(depth), False)
    port = LightWeightRefiner().eval()
    load_jax_params(port, v, part="LightWeightRefiner")
    with torch.no_grad():
        feats, out_depth = port(nchw(crop), nchw(depth))
    assert len(feats) == len(feats_j) == 6
    for i, (a, b) in enumerate(zip(feats, feats_j)):
        assert_close_nhwc(a, b, f"refiner level {i}")
    assert_close_nhwc(out_depth, depth_j, "refiner depth")


# ---------------------------------------------------------------- fusion head
@pytest.mark.parametrize("gate", [True, False])
def test_gated_conv_unit_matches_jax(gate):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 8, 16).astype(np.float32)
    c = rng.randn(2, 6, 8, 8).astype(np.float32)
    ju = JGated(16, gate=gate, fusion=True)
    v = init_random(ju, 7, jnp.asarray(x), jnp.asarray(c))
    ref = ju.apply(v, jnp.asarray(x), jnp.asarray(c))
    port = GatedConvUnit(16, 8, gate=gate, fusion=True).eval()
    load_jax_params(port, v, part="GatedConvUnit")
    with torch.no_grad():
        assert_close_nhwc(port(nchw(x), nchw(c)), ref)


# fine levels (high -> low resolution) of a 64x96 patch and the coarse
# levels the C2F module reads (0: full resolution, 1..5: /2 .. /32)
_FINE = [(32, 48, 8), (16, 24, 12), (8, 12, 16), (4, 6, 20), (2, 3, 24)]
_COARSE = [(64, 96, 8), (32, 48, 6), (16, 24, 6), (8, 12, 6), (4, 6, 6), (2, 3, 6)]


def test_c2f_module_matches_jax():
    rng = np.random.RandomState(8)
    fine = [rng.randn(2, *s).astype(np.float32) for s in _FINE]
    coarse = [rng.randn(2, *s).astype(np.float32) for s in _COARSE]
    jm = JC2F(features=16, head2_features=8, gate=True, fusion=True)
    args = ([jnp.asarray(f) for f in fine], [jnp.asarray(c) for c in coarse])
    v = init_random(jm, 9, *args)
    feats_j, out_j = jm.apply(v, *args)
    port = C2FModule([s[2] for s in _FINE], [s[2] for s in _COARSE], features=16,
                     head2_features=8).eval()
    load_jax_params(port, v, part="C2FModule")
    with torch.no_grad():
        feats, out = port([nchw(f) for f in fine], [nchw(c) for c in coarse])
    for i, (a, b) in enumerate(zip(feats, feats_j)):
        assert_close_nhwc(a, b, f"c2f feature {i}")
    assert_close_nhwc(out, out_j, "c2f depth")


def test_bidirectional_fusion_matches_jax_and_round_trips():
    """Coarse-gated C2F, both fusion layers and the f2r decoder. One coarse
    level comes at another size than its fine level, so the head's own
    alignment resize runs too. The port's state dict converts back to the
    JAX tree it was loaded from."""
    rng = np.random.RandomState(10)
    fine_shapes = [(64, 96, 8)] + _FINE  # the refiner's top level, then the encoder's
    coarse_shapes = [(64, 96, 8), (32, 48, 6), (8, 12, 6), (8, 12, 6), (4, 6, 6), (2, 3, 6)]
    f_feat = [rng.randn(2, *s).astype(np.float32) for s in fine_shapes]
    c_feat = [rng.randn(2, *s).astype(np.float32) for s in coarse_shapes]
    pred1 = (rng.rand(2, 64, 96, 1) * 5).astype(np.float32)
    pred2 = np.zeros_like(pred1)
    temp, dec = (8, 8, 8, 16, 16, 16), (16, 16, 8, 8, 8)
    jf = JFusion(coarse_chl=tuple(s[2] for s in coarse_shapes), temp_chl=temp, dec_chl=dec,
                 c2f_features=16)
    jargs = ([jnp.asarray(c) for c in c_feat], [jnp.asarray(f) for f in f_feat],
             jnp.asarray(pred1), jnp.asarray(pred2))
    v = init_random(jf, 11, *jargs, jnp.asarray(pred1))
    ref = jf.apply(v, *jargs, update_base=jnp.asarray(pred1))
    port = BiDirectionalFusion([s[2] for s in coarse_shapes], [s[2] for s in _FINE],
                               temp_chl=temp, dec_chl=dec, c2f_features=16,
                               head2_features=coarse_shapes[0][2]).eval()
    load_jax_params(port, v, part="BiDirectionalFusion")
    with torch.no_grad():
        got = port([nchw(c) for c in c_feat], [nchw(f) for f in f_feat], nchw(pred1),
                   nchw(pred2), update_base=nchw(pred1))
    assert_close_nhwc(got, ref, "fusion depth")
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    assert_same_tree(convert_bidirectional_fusion(sd), v["params"])
