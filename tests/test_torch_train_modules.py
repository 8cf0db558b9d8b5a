"""Train-mode modules of the port against flax ``apply(..., True,
mutable=["batch_stats"])``, on the CPU, in f32: the outputs, the updated
running ``mean`` / ``var`` (flax stores the biased batch variance) and the
gradients of the inputs and the parameters for a random output cotangent
(``jax.vjp`` against ``torch.autograd``).

Modules: ConvBNReLU, a ResNet Bottleneck with downsample, the f2v reduce
(FrustumToVoxelMultiScale through the Pallas sampler's K2 in interpret mode)
and the Z-collapse; then the radar branch (pillar net + BEV encoder), whose
gradient goes through the scatter-max and its tie rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import layers as jl
from hgsfusion_tpu.models.bev_encoder import PillarNetRadar as JaxRadar
from hgsfusion_tpu.models.frustum import FrustumToVoxelMultiScale as JaxF2V
from hgsfusion_tpu.models.occupancy import Conv2DCollapse as JaxCollapse
from hgsfusion_tpu.models.pillar_encoder import PillarFeatureNet as JaxPFN
from hgsfusion_tpu.models.resnet import Bottleneck as JaxBottleneck
from hgsfusion_tpu.ops import pallas_sample
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import layers
from hgsfusion_tpu_torch.models.bev_encoder import PillarNetRadar
from hgsfusion_tpu_torch.models.frustum import FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.models.occupancy import Conv2DCollapse
from hgsfusion_tpu_torch.models.pillar_encoder import PillarFeatureNet
from hgsfusion_tpu_torch.models.resnet import Bottleneck
from torch_parity import assert_close, one_torch_thread, perturb_variables, t  # noqa: F401

KEY = jax.random.PRNGKey(0)
# f32 round-off of a few layers of convolution and batch statistics
TOL = 2e-5


def _bottleneck_weights(p, s):
    out = {}
    for i in (1, 2, 3):
        out.update({f"conv{i}.{k}": v for k, v in weights.conv(p[f"conv{i}"]).items()})
        out.update({f"bn{i}.{k}": v for k, v in weights.batch_norm(p[f"bn{i}"],
                                                                   s[f"bn{i}"]).items()})
    out.update({f"downsample.0.{k}": v for k, v in weights.conv(p["downsample_conv"]).items()})
    out.update({f"downsample.1.{k}": v for k, v in
                weights.batch_norm(p["downsample_bn"], s["downsample_bn"]).items()})
    return out


def _case(name, rng):
    """(JAX module, its inputs, port module, converter, NCHW port input)."""
    if name == "conv_bn_relu":
        x = [rng.randn(2, 6, 7, 8).astype(np.float32) + 0.5]
        return (jl.ConvBNReLU(12, kernel_size=(3, 3)), x,
                layers.ConvBNReLU(8, 12, (3, 3)), weights.conv_bn_relu, False)
    if name == "bottleneck":
        x = [rng.randn(1, 9, 11, 16).astype(np.float32)]
        return (JaxBottleneck(8, strides=2, downsample=True), x,
                Bottleneck(16, 8, 2, 1, True), _bottleneck_weights, True)
    if name == "f2v":
        feats = [rng.randn(1, 9, 13, 16).astype(np.float32)] + [
            rng.randn(1, 5, 7, 16).astype(np.float32) for _ in range(3)]
        grid = rng.uniform(-1.2, 1.2, (1, 6, 7, 5, 3)).astype(np.float32)
        return (JaxF2V(out_channels=24, sampler_kernel="pallas"), [feats, grid],
                FrustumToVoxelMultiScale([16] * 4, 24), weights.frustum_to_voxel, False)
    if name == "collapse":
        x = [rng.randn(1, 12, 10, 5, 16).astype(np.float32)]
        return (JaxCollapse(num_bev_features=24), x, Conv2DCollapse(16, 5, 24),
                weights.conv2d_collapse, False)
    raise ValueError(name)


def _param_grads(convert, grads, stats):
    """A JAX parameter-gradient tree in the port's names (statistics dropped)."""
    return {k: v.numpy() for k, v in convert(grads, stats).items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


@pytest.mark.parametrize("name", ["conv_bn_relu", "bottleneck", "f2v", "collapse"])
def test_train_mode_module_matches_flax(name, monkeypatch):
    monkeypatch.setattr(pallas_sample, "TILE", 64)
    rng = np.random.RandomState(0)
    jmod, args, port, convert, nchw = _case(name, rng)
    v = perturb_variables(jmod.init(KEY, *args, False), seed=3)

    def fwd(params, x0):
        out, new = jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                              x0, *args[1:], True, mutable=["batch_stats"])
        return out, new["batch_stats"]

    out, vjp_fn, new_stats = jax.vjp(fwd, v["params"], args[0], has_aux=True)
    cot = rng.randn(*out.shape).astype(np.float32)
    g_params, g_x = vjp_fn(jnp.asarray(cot))

    port.load_state_dict(convert(v["params"], v["batch_stats"]), strict=True)
    port.train()
    x0 = ([t(a).requires_grad_() for a in args[0]] if isinstance(args[0], list)
          else t(args[0]).requires_grad_())
    x_in = x0.permute(0, 3, 1, 2) if nchw else x0
    got = port(x_in, *(t(a) for a in args[1:]))
    if nchw:
        got = got.permute(0, 2, 3, 1)
    assert_close(got, out, atol=TOL, rtol=TOL)
    (got.float() * t(cot)).sum().backward()

    state = convert(v["params"], jax.tree_util.tree_map(np.asarray, new_stats))
    for k, p in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert_close(p, state[k], atol=1e-6, rtol=1e-5, err_msg=k)
    ref_grads = _param_grads(convert, g_params, v["batch_stats"])
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for k, p in port.named_parameters():
        assert_close(p.grad, ref_grads[k], atol=TOL * scale, rtol=TOL, err_msg=k)
    gx = [a.grad for a in x0] if isinstance(x0, list) else [x0.grad]
    gx_ref = g_x if isinstance(g_x, list) else [g_x]
    for a, r in zip(gx, gx_ref):
        assert_close(a, r, atol=TOL * float(np.abs(np.asarray(r)).max()), rtol=TOL)


def _radar_points(rng, n=256):
    pts = np.zeros((2, n, 17), np.float32)
    pts[..., 0] = rng.uniform(-0.3, 8.5, (2, n))
    pts[..., 1] = rng.uniform(-4.3, 4.3, (2, n))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (2, n))
    pts[..., 3:15] = rng.randn(2, n, 12)
    pts[..., 15] = rng.rand(2, n) > 0.5
    pts[..., 16] = 1.0
    return pts, rng.rand(2, n) > 0.1


def test_radar_branch_gradients_match_jax():
    """Pillar net and BEV encoder in train mode, each against its JAX module:
    outputs, statistics and the gradient of every parameter (and of the BEV
    input). Empty pillars and points whose features the ReLU zeroed tie with
    the scatter-max's 0 floor; both sides split the gradient evenly among
    the tied entries. The BEV encoder's unused last stage gets a zero
    gradient on both sides."""
    rng = np.random.RandomState(4)
    pts, valid = _radar_points(rng)
    pc_range = (0.0, -4.0, -1.0, 8.0, 4.0, 1.0)
    jpfn = JaxPFN(num_input_features=29, pillar_size=0.5, pc_range=pc_range)
    vp = perturb_variables(jpfn.init(KEY, pts, valid, False), seed=5)
    bev0, occ0 = jpfn.apply(vp, pts, valid, False, mutable=["batch_stats"])[0]
    bev0, occ_f = np.asarray(bev0), np.asarray(occ0).astype(np.float32)
    jradar = JaxRadar()
    vr = perturb_variables(jradar.init(KEY, bev0, occ_f, False), seed=6)

    @jax.jit
    def jax_side(cot_bev, cot_out):
        def pfn_fwd(pp):
            (bev, _), s = jpfn.apply({"params": pp, "batch_stats": vp["batch_stats"]}, pts,
                                     valid, True, mutable=["batch_stats"])
            return bev, s["batch_stats"]

        def radar_fwd(pr, x):
            out, s = jradar.apply({"params": pr, "batch_stats": vr["batch_stats"]}, x, occ_f,
                                  True, mutable=["batch_stats"])
            return out, s["batch_stats"]

        bev, vjp_p, sp = jax.vjp(pfn_fwd, vp["params"], has_aux=True)
        out, vjp_r, sr = jax.vjp(radar_fwd, vr["params"], bev0, has_aux=True)
        return bev, sp, vjp_p(cot_bev)[0], out, sr, vjp_r(cot_out)

    cot_bev = rng.randn(*bev0.shape).astype(np.float32)
    cot_out = rng.randn(*bev0.shape[:3], 128).astype(np.float32)
    bev_ref, sp, gp, out_ref, sr, (gr, gx) = jax_side(cot_bev, cot_out)

    pfn = PillarFeatureNet(29, (32,), 0.5, pc_range)
    pfn.load_state_dict(weights.pillar_feature_net(vp["params"], vp["batch_stats"]))
    radar = PillarNetRadar()
    radar.load_state_dict(weights.pillar_net_radar(vr["params"], vr["batch_stats"]))
    pfn.train()
    radar.train()
    bev, occ = pfn(t(pts), t(valid))
    assert_close(bev, bev_ref, atol=1e-5)
    np.testing.assert_array_equal(occ.numpy(), occ0)
    (bev * t(cot_bev)).sum().backward()
    x = t(bev0).requires_grad_()
    out = radar(x, t(occ_f))
    assert_close(out, out_ref, atol=1e-4, rtol=1e-4)
    (out * t(cot_out)).sum().backward()
    assert_close(x.grad, gx, atol=TOL * float(np.abs(np.asarray(gx)).max()), rtol=TOL)

    for port, convert, g, new_stats, old in (
            (pfn, weights.pillar_feature_net, gp, sp, vp),
            (radar, weights.pillar_net_radar, gr, sr, vr)):
        ref_stats = convert(old["params"], jax.tree_util.tree_map(np.asarray, new_stats))
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert_close(v, ref_stats[k], atol=1e-5, rtol=1e-4, err_msg=k)
        ref_grads = _param_grads(convert, g, old["batch_stats"])
        scale = max(float(np.abs(a).max()) for a in ref_grads.values())
        assert len(ref_grads) == len(list(port.parameters()))
        for k, p in port.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            assert_close(got, ref_grads[k], atol=TOL * scale, rtol=TOL, err_msg=k)
