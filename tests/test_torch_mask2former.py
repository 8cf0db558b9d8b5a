"""The port's Mask2Former (``models/swin.py``, ``rhgm/mask2former.py``)
against the JAX package's, on the CPU, in f32.

JAX variables are drawn with numpy from a seed in the shapes of the JAX
module (``jax.eval_shape`` of its init: nothing compiles but the forward)
and carried across by ``weights.from_jax_mask2former``. Images are 52 x 76,
not a multiple of any stride: the windows pad, the shifted masks are built
on the padded sizes, two patch merges take odd sizes. Tolerances: 2e-4 for
the whole model, as ``tests/test_m2f_convert.py`` holds the JAX module to
the torch oracle; 1e-4 for the backbone and the decoders, 1e-5 for single
layers (f32 round-off of their depth of arithmetic). The port's names are
the published checkpoint's: its ``state_dict`` equals the structure of
``tests/ref_mask2former.py``'s, whose ``.pkl`` loads strictly and computes
what the port computes.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import swin as jswin
from hgsfusion_tpu.rhgm import mask2former as jm2f
from hgsfusion_tpu.train.torch_convert import convert_mask2former_state
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import swin
from hgsfusion_tpu_torch.rhgm import mask2former as m2f
from hgsfusion_tpu_torch.rhgm.checkpoint import load_mask2former
from torch_parity import assert_close, one_torch_thread, t  # noqa: F401

# the dims of tests/test_m2f_convert.py, so the oracle shares them
TINY = dict(embed_dims=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
            hidden_dim=32, num_queries=10, dec_heads=8, dec_layers=3, dim_feedforward=64,
            pd_enc_layers=2, pd_ffn=128)
ORACLE = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
              hidden_dim=32, num_queries=10, nheads=8, dim_feedforward=64, dec_layers=3,
              enc_layers=2, num_classes=8)
IMG_HW = (52, 76)
# backbone outputs at IMG_HW: strides 4, 8, 16, 32 of 16 * 2^i channels
FEATS = [((13, 19), 16), ((7, 10), 32), ((4, 5), 64), ((2, 3), 128)]
DECODERS = ["msdeform", "fpn"]


def random_variables(shapes, seed: int):
    """Numpy values in the shapes of a JAX variables tree: kernels LeCun
    normal, norm scales near 1, biases near 0, embeddings N(0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            a = rng.uniform(0.8, 1.2, s.shape)
        elif name == "bias":
            a = rng.normal(0.0, 0.05, s.shape)
        elif name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif name == "relative_position_bias_table":
            a = rng.normal(0.0, 0.5, s.shape)
        else:
            a = rng.normal(0.0, 1.0, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_init(module, *args, seed: int = 0):
    return random_variables(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)),
                            seed)


def _image(seed=5, hw=IMG_HW):
    return np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)


def _feats(seed=6):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, *hw, c).astype(np.float32) for hw, c in FEATS]


@pytest.fixture(scope="module")
def models():
    """Per pixel decoder: the JAX module, its variables and its output."""
    out = {}
    for pd in DECODERS:
        jm = jm2f.Mask2FormerInstance(pixel_decoder=pd, **TINY)
        v = jax_init(jm, jnp.asarray(_image()), False, seed=DECODERS.index(pd))
        y = jax.jit(lambda v, x: jm.apply(v, x, False))(v, jnp.asarray(_image()))
        out[pd] = (jm, v, jax.tree_util.tree_map(np.asarray, y))
    return out


def _port(pd, variables):
    pm = m2f.Mask2FormerInstance(pixel_decoder=pd, device="cpu", **TINY)
    pm.load_state_dict(weights.from_jax_mask2former(variables), strict=True)
    return pm


@pytest.mark.parametrize("pd", DECODERS)
def test_mask2former_instance(models, pd):
    _, v, want = models[pd]
    with torch.no_grad():
        got = _port(pd, v)(t(_image()))
    assert got["pred_logits"].shape == (1, 10, 9) and got["pred_masks"].shape == (1, 10, 13, 19)
    assert_close(got["pred_logits"], want["pred_logits"], atol=2e-4)
    assert_close(got["pred_masks"], want["pred_masks"], atol=2e-4)


@pytest.mark.parametrize("hw", [IMG_HW, (45, 61)])
def test_swin_transformer(models, hw):
    """Shifted windows on padded maps, odd patch merges (52 x 76), and
    window-aligned stage 0 with padded later stages (45 x 61)."""
    p = models["msdeform"][1]["params"]["backbone"]
    kw = dict(embed_dims=16, depths=TINY["depths"], num_heads=TINY["num_heads"], window_size=4,
              out_indices=(0, 1, 2, 3))
    jm = jswin.SwinTransformer(drop_path_rate=0.0, **kw)
    img = _image(7, hw)
    want = jax.jit(lambda x: jm.apply({"params": p}, x, False))(jnp.asarray(img))
    port = swin.SwinTransformer(**kw)
    port.load_state_dict(weights.swin_transformer(p), strict=True)
    with torch.no_grad():
        got = port(t(img))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w, atol=1e-4)


@pytest.mark.parametrize("hw", [(5, 7), (6, 8), (3, 2)])
def test_patch_merging(hw):
    c = 6
    x = np.random.RandomState(1).randn(2, hw[0] * hw[1], c).astype(np.float32)
    jm = jswin.PatchMerging(out_channels=2 * c)
    v = jax_init(jm, jnp.asarray(x), hw, seed=2)
    want, want_hw = jm.apply(v, jnp.asarray(x), hw)
    port = swin.PatchMerging(c, 2 * c)
    port.load_state_dict(weights.patch_merging(v["params"]), strict=True)
    with torch.no_grad():
        got, got_hw = port(t(x), hw)
    assert got_hw == tuple(want_hw) == ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    assert_close(got, want, atol=1e-5)


@pytest.mark.parametrize("shift", [False, True])
def test_swin_block(shift):
    hw, c = (9, 11), 8
    x = np.random.RandomState(3).randn(1, hw[0] * hw[1], c).astype(np.float32)
    jm = jswin.SwinBlock(embed_dims=c, num_heads=2, feedforward_channels=4 * c, window_size=4,
                         shift=shift)
    v = jax_init(jm, jnp.asarray(x), hw, False, seed=4)
    want = jm.apply(v, jnp.asarray(x), hw, False)
    port = swin.SwinBlock(c, 2, 4 * c, 4, shift)
    port.load_state_dict(weights.swin_block(v["params"]), strict=True)
    with torch.no_grad():
        got = port(t(x), hw)
    assert_close(got, want, atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 4), (12, 12)])
def test_window_constants_equal_jax(hw):
    np.testing.assert_array_equal(swin._rel_position_index(*hw), jswin._rel_position_index(*hw))
    win = hw[0]
    np.testing.assert_array_equal(swin._shift_attn_mask(3 * win, 5 * win, win, win // 2),
                                  jswin._shift_attn_mask(3 * win, 5 * win, win, win // 2))


@pytest.mark.parametrize("hwc", [(4, 6, 8), (13, 19, 32)])
def test_sine_position_embedding_equal_jax(hwc):
    np.testing.assert_array_equal(m2f.sine_position_embedding(*hwc),
                                  jm2f.sine_position_embedding(*hwc))


def test_deform_sample_level_edges():
    """Locations on, just inside and beyond every edge, and in between:
    out-of-map taps read 0 as in the JAX gather."""
    h, w = 5, 7
    value = np.random.RandomState(8).randn(2, h, w, 3, 4).astype(np.float32)
    xs = np.array([-0.3, -0.5 / w, 0.0, 0.25 / w, 0.5 / w, 0.37, 1 - 0.5 / w, 1.0, 1 + 0.4 / w,
                   1.2], np.float32)
    ys = np.array([-0.2, -0.5 / h, 0.0, 0.5 / h, 0.61, 1 - 0.5 / h, 1.0, 1 + 0.3 / h], np.float32)
    grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)  # (80, 2)
    q = grid.shape[0] // 4
    loc = np.broadcast_to(grid.reshape(1, q, 1, 4, 2), (2, q, 3, 4, 2)).copy()
    loc[1] = loc[1, ::-1]
    want = jax.jit(jm2f._deform_sample_level)(jnp.asarray(value), jnp.asarray(loc))
    got = m2f._deform_sample_level(t(value), t(loc))
    assert got.shape == want.shape == (2, q, 3, 4, 4)
    assert_close(got, want, atol=1e-5)
    assert np.all(np.asarray(want)[0, 0, :, 0] == 0)  # (-0.3, -0.2) reads nothing


def test_ms_deform_attn():
    rng = np.random.RandomState(9)
    hws = [(3, 4), (5, 7), (9, 13)]
    vals = [rng.randn(1, h, w, 32).astype(np.float32) for h, w in hws]
    nq = sum(h * w for h, w in hws)
    query = rng.randn(1, nq, 32).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (1, nq, 3, 2)).astype(np.float32)
    jm = jm2f.MSDeformAttn(d_model=32, n_levels=3, n_heads=8, n_points=4)
    args = (jnp.asarray(query), jnp.asarray(ref), [jnp.asarray(a) for a in vals])
    v = jax_init(jm, *args, seed=10)
    want = jax.jit(lambda v, *a: jm.apply(v, *a))(v, *args)
    port = m2f.MSDeformAttn(32, 3, 8, 4)
    port.load_state_dict(weights.ms_deform_attn(v["params"]), strict=True)
    with torch.no_grad():
        got = port(t(query), t(ref), [t(a) for a in vals])
    assert_close(got, want, atol=1e-5)


@pytest.mark.parametrize("pd", DECODERS)
def test_pixel_decoder(models, pd):
    p = models[pd][1]["params"]["pixel_decoder"]
    feats = _feats()
    if pd == "msdeform":
        jm = jm2f.PixelDecoderMSDeform(conv_dim=32, mask_dim=32, enc_layers=2, d_ffn=128)
        port = m2f.PixelDecoderMSDeform([c for _, c in FEATS], 32, 32, 2, d_ffn=128)
        sd = weights.pixel_decoder_msdeform(p)
    else:
        jm = jm2f.PixelDecoderFPN(conv_dim=32, mask_dim=32)
        port = m2f.PixelDecoderFPN([c for _, c in FEATS], 32, 32)
        sd = weights.pixel_decoder_fpn(p)
    want_mf, want_scales = jax.jit(lambda x: jm.apply({"params": p}, x))(
        [jnp.asarray(f) for f in feats])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got_mf, got_scales = port([t(f) for f in feats])
    assert_close(got_mf, want_mf, atol=1e-4)
    assert [g.shape[1:3] for g in got_scales] == [(2, 3), (4, 5), (7, 10)]
    for g, w in zip(got_scales, want_scales):
        assert_close(g, w, atol=1e-4)


@pytest.mark.parametrize("mask_features", ["random", "constant"])
def test_masked_transformer_decoder(models, mask_features):
    """"constant": the mask features are one vector at every pixel, so each
    query's mask logit is one number: the queries below 0 are blocked at
    every pixel (detectron2's reset unblocks them), the others nowhere."""
    p = models["msdeform"][1]["params"]["transformer_decoder"]
    rng = np.random.RandomState(11)
    scales = [rng.randn(1, h, w, 32).astype(np.float32) for (h, w), _ in FEATS[2::-1]]
    if mask_features == "random":
        mf = rng.randn(1, 13, 19, 32).astype(np.float32)
    else:
        mf = np.broadcast_to(rng.randn(1, 1, 1, 32), (1, 13, 19, 32)).astype(np.float32)
    jm = jm2f.MaskedTransformerDecoder(num_classes=8, hidden_dim=32, num_queries=10,
                                       num_heads=8, num_layers=3, dim_feedforward=64,
                                       mask_dim=32)
    want_cls, want_masks = jax.jit(lambda s, m: jm.apply({"params": p}, s, m))(
        [jnp.asarray(s) for s in scales], jnp.asarray(mf))
    port = m2f.MaskedTransformerDecoder(8, 32, 10, 8, 3, 64, 32)
    port.load_state_dict(weights.masked_transformer_decoder(p), strict=True)
    with torch.no_grad():
        got_cls, got_masks = port([t(s) for s in scales], t(mf))
        if mask_features == "constant":
            emb = port.mask_embed(port.decoder_norm(port.query_feat.weight))
            first = emb @ t(mf)[0, 0, 0]
            assert (first < 0).any() and (first > 0).any()  # some rows fully masked
    assert_close(got_cls, want_cls, atol=1e-4)
    assert_close(got_masks, want_masks, atol=1e-4)


def test_mha_key_mask():
    """The additive -1e9 key mask, with one query blocked at every key."""
    rng = np.random.RandomState(12)
    q = rng.randn(2, 3, 16).astype(np.float32)
    k = rng.randn(2, 7, 16).astype(np.float32)
    mask = rng.rand(2, 3, 7) > 0.5
    mask[0, 1] = True
    mask[1, 2] = False
    jm = jm2f._MHA(channels=16, heads=2)
    v = jax_init(jm, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), seed=13)
    want = jm.apply(v, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), key_mask=jnp.asarray(mask))
    port = m2f._MHA(16, 2)
    port.load_state_dict(weights.mha(v["params"]), strict=True)
    with torch.no_grad():
        got = port(t(q), t(k), t(k), key_mask=t(mask))
    assert_close(got, want, atol=1e-5)


def test_instance_inference():
    rng = np.random.RandomState(14)
    logits = rng.randn(1, 10, 9).astype(np.float32) * 3
    masks = rng.randn(1, 10, 13, 19).astype(np.float32) * 4
    masks[0, 4] = -1.0  # an empty mask: score 0
    jl, js, jb = (np.asarray(a) for a in jm2f.instance_inference(
        jnp.asarray(logits), jnp.asarray(masks), IMG_HW, topk=50))
    pl, ps, pb = m2f.instance_inference(t(logits), t(masks), IMG_HW, topk=50)
    np.testing.assert_array_equal(pl.numpy(), jl)
    assert_close(ps, js, atol=1e-6)
    np.testing.assert_array_equal(pb.numpy(), jb)
    assert pb.shape == (50,) + IMG_HW and pb.dtype == torch.bool
    assert (js == 0).any()


def test_from_jax_round_trip(models):
    """from_jax_mask2former, then the JAX package's converter back: the same
    JAX variables, every key used."""
    _, v, _ = models["msdeform"]
    state = {k: x.numpy() for k, x in weights.from_jax_mask2former(v).items()}
    back, report = convert_mask2former_state(state, v)
    assert report["missing"] == [] and report["unmatched"] == []
    flat_v = jax.tree_util.tree_leaves_with_path(v["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_v) == len(flat_b)
    for path, a in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


def test_state_dict_is_published_structure(tmp_path):
    """The port's names and shapes are the oracle's (the published dict's);
    the oracle's .pkl loads strictly and the port computes what it does."""
    from ref_mask2former import Mask2FormerTorch

    torch.manual_seed(11)
    oracle = Mask2FormerTorch(**ORACLE).eval()
    port = m2f.Mask2FormerInstance(device="cpu", **TINY)
    want = {k: tuple(v.shape) for k, v in oracle.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    with open(tmp_path / "model_final.pkl", "wb") as f:
        pickle.dump({"model": {**{k: v.numpy() for k, v in oracle.state_dict().items()},
                               "criterion.empty_weight": np.ones(9, np.float32)}}, f)
    assert load_mask2former(port, tmp_path / "model_final.pkl") == ["criterion.empty_weight"]
    img = _image()
    with torch.no_grad():
        want_cls, want_masks = oracle(t(img).permute(0, 3, 1, 2))
        got = port(t(img))
    assert_close(got["pred_logits"], want_cls.numpy(), atol=2e-4)
    assert_close(got["pred_masks"], want_masks.numpy(), atol=2e-4)


def test_seeded_weights_and_device():
    a = m2f.Mask2FormerInstance(device="cpu", seed=1, pixel_decoder="fpn", **TINY)
    b = m2f.Mask2FormerInstance(device="cpu", seed=1, pixel_decoder="fpn", **TINY)
    c = m2f.Mask2FormerInstance(device="cpu", seed=2, pixel_decoder="fpn", **TINY)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.patch_embed.proj.weight"],
                           sc["backbone.patch_embed.proj.weight"])
    assert "sem_seg_head.pixel_decoder.layer_4.norm.weight" in sa
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m2f.Mask2FormerInstance(**TINY)
    with pytest.raises(ValueError, match="pixel_decoder"):
        m2f.Mask2FormerInstance(device="cpu", pixel_decoder="deformable", **TINY)
