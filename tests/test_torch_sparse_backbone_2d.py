"""The sparse 2-D pillar backbones and BaseBEVBackboneV1
(``models/sparse_backbone_2d.py``) against the JAX package's, on the CPU,
f32: ``PillarRes18BackBone8x`` with residual and post-activation blocks
(PillarBackBone8x), ``VoxelNeXt2DBackbone`` and ``BaseBEVBackboneV1`` in
eval mode within 1e-5 of the largest output, the two backbones in train
mode (outputs within 1e-5 of the largest, VoxelNeXt2D's within 1e-4, and
every masked and dense BatchNorm's updated statistics within 1e-5), and ``_zero_stuff`` at odd sizes (the placed map clipped at
the grid's edge) exactly equal. The grid: 2 frames of 36 x 44 pillars
(stages 36 x 44 -> 18 x 22 -> 9 x 11 -> 5 x 6 -> 3 x 3 -> 2 x 2, so the
stride-16 and stride-32 maps overhang the stride-8 grid), about a fifth
active (a fiftieth for VoxelNeXt2D), 32 features."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import sparse_backbone_2d as jsb
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import sparse_backbone_2d as sb
from torch_parity import one_torch_thread, shaped_variables, t  # noqa: F401

TOL = 1e-5
# VoxelNeXt2D's train-mode outputs: 22 residual blocks, each BN over the
# batch's active sites (8 at stride 32), carry the two frameworks' f32
# rounding of the statistics to 1e-5-5e-5 of the largest output
TRAIN_TOL = 1e-4
HW = (36, 44)


def _input(seed=0, b=2, c=32, hw=HW, density=0.2):
    rng = np.random.RandomState(seed)
    mask = rng.rand(b, *hw, 1) < density
    x = rng.randn(b, *hw, c).astype(np.float32) * mask
    return x, mask


def _close(got, ref, what="", tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30), err_msg=what)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _assert_stats(port, want):
    sd = _stats(port.state_dict())
    want = _stats(want)
    assert set(sd) == set(want) and sd
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL, err_msg=k)


def _run_pair(jax_module, port, convert, args, port_args, train: bool):
    """The JAX module (shaped variables, one jit) and the port loaded from
    them, in eval or train mode: (ref, got, variables, updated stats)."""
    variables = shaped_variables(jax_module, *args, False, seed=2)
    if train:
        ref, upd = jax.jit(lambda v, *a: jax_module.apply(v, *a, True, mutable=["batch_stats"]))(
            variables, *args)
        upd = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    else:
        ref, upd = jax.jit(lambda v, *a: jax_module.apply(v, *a, False))(variables, *args), None
    port.load_state_dict(convert(variables["params"], variables["batch_stats"]), strict=True)
    port.train(train)
    with torch.set_grad_enabled(train):
        got = port(*port_args)
    return ref, got, variables, upd


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_pillar_res18_matches_jax(residual, train):
    x, mask = _input()
    ref, got, variables, upd = _run_pair(
        jsb.PillarRes18BackBone8x(residual=residual), sb.PillarRes18BackBone8x(residual),
        weights.pillar_res18_backbone, (x, mask), (t(x), t(mask)), train)
    ref_outs, ref_masks = ref
    outs, masks = got
    assert set(outs) == set(ref_outs) == {f"x_conv{i}" for i in range(1, 6)}
    assert outs["x_conv4"].shape == (2, 5, 6, 256) and outs["x_conv5"].shape == (2, 3, 3, 256)
    for k in ref_outs:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(ref_masks[k]), err_msg=k)
        _close(outs[k], ref_outs[k], k)
    if train:
        port = sb.PillarRes18BackBone8x(residual)
        port.load_state_dict(weights.pillar_res18_backbone(variables["params"],
                                                           variables["batch_stats"]))
        port.train()(t(x), t(mask))
        _assert_stats(port, weights.pillar_res18_backbone(variables["params"], upd))


@pytest.mark.parametrize("train", [False, True])
def test_voxelnext2d_matches_jax(train):
    x, mask = _input(1, density=0.02)
    ref, got, variables, upd = _run_pair(jsb.VoxelNeXt2DBackbone(), sb.VoxelNeXt2DBackbone(),
                                         weights.voxelnext2d_backbone, (x, mask),
                                         (t(x), t(mask)), train)
    (ref_z, ref_mask, ref_stages), (z, omask, stages) = ref, got
    assert z.shape == (2, 5, 6, 256)
    np.testing.assert_array_equal(omask.numpy(), np.asarray(ref_mask))
    assert int(omask.sum()) > 0
    tol = TRAIN_TOL if train else TOL
    _close(z, ref_z, "z", tol)
    for k in ref_stages:
        _close(stages[k], ref_stages[k], k, tol)
    if train:
        port = sb.VoxelNeXt2DBackbone()
        port.load_state_dict(weights.voxelnext2d_backbone(variables["params"],
                                                          variables["batch_stats"]))
        port.train()(t(x), t(mask))
        _assert_stats(port, weights.voxelnext2d_backbone(variables["params"], upd))


def test_base_bev_backbone_v1_matches_jax():
    """Eval mode; the stride-1 deblock is a 1 x 1 transposed conv (flax does
    not flip its kernel: a 1 x 1 one is its own flip), the stride-2 one
    takes ``weights._conv_transpose``'s flip."""
    rng = np.random.RandomState(3)
    x4 = rng.randn(2, 6, 8, 24).astype(np.float32)
    x5 = rng.randn(2, 3, 4, 20).astype(np.float32)
    module = jsb.BaseBEVBackboneV1(layer_nums=(2, 1), num_filters=(16, 12),
                                   upsample_strides=(1, 2), num_upsample_filters=(8, 10))
    port = sb.BaseBEVBackboneV1((24, 20), (2, 1), (16, 12), (1, 2), (8, 10))
    ref, got, _, _ = _run_pair(module, port, weights.conv_bn_layers, (x4, x5), (t(x4), t(x5)),
                               False)
    assert got.shape == (2, 6, 8, 16) and port.out_channels == 16
    _close(got, ref)


@pytest.mark.parametrize("factor,src_hw,out_hw", [(2, (3, 3), (5, 6)), (4, (2, 2), (5, 6)),
                                                  (2, (4, 5), (7, 9)), (4, (1, 3), (3, 11))])
def test_zero_stuff_matches_jax_exactly(factor, src_hw, out_hw):
    x, mask = _input(4, c=3, hw=src_hw, density=0.6)
    ref, ref_m = jsb._zero_stuff(jnp.asarray(x), jnp.asarray(mask), factor, out_hw)
    got, got_m = sb._zero_stuff(t(x), t(mask), factor, out_hw)
    assert got.shape == (2,) + out_hw + (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
