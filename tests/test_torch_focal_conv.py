"""The focal sparse convolution, its loss and VoxelBackBone8xFocal
(``models/focal_conv.py``) against the JAX package's, on the CPU, f32, at
the TINY grid of ``test_torch_voxel_backbone.py`` (32 x 32 x 40 voxels,
41 planes, 5 point features, two frames).

The foreground is ``importance >= k-th importance`` over the active sites.
With random weights many importances sit near 0.5, and the two frameworks'
sigmoids may differ in the last bit, so the foreground masks are held to
JAX's rule (applied to JAX's own importances) at sites further than 1e-6
from the k-th value, and the outputs (features, grown masks, batch
statistics; 1e-5 of the largest) only at inputs where every importance
that close is an exact tie with the k-th in both frameworks: the tests
assert that this holds for their seeds. Every other
rule is JAX's exactly: the strict-interior dilation targets, the averaged
kernel multiplier, a foreground count of 0 selecting nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import focal_conv as jfc
from hgsfusion_tpu.models import voxel_backbone as jvb
from hgsfusion_tpu.ops.points_in_boxes import points_in_boxes as jax_points_in_boxes
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import focal_conv as fc
from hgsfusion_tpu_torch.ops.points_in_boxes import points_in_boxes
from test_torch_voxel_backbone import GRID, PC_RANGE, VOXEL, _points
from torch_parity import one_torch_thread, shaped_variables, t  # noqa: F401

TOL = 1e-5
TIE = 1e-6
GT = np.array([[[4.0, -2.0, -0.5, 3.9, 1.6, 1.56, 0.3, 1], [10.3, 3.2, -0.8, 0.8, 0.6, 1.73, -1, 2],
                [0, 0, 0, 0, 0, 0, 0, 0]],
               [[8.0, 1.0, -1.0, 4.2, 1.8, 1.6, -0.7, 1], [0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, 0]]], np.float32)


@pytest.fixture(scope="module")
def volume():
    pts, valid = _points(seed=4)
    dense, mask = jvb.mean_vfe(jnp.asarray(pts), jnp.asarray(valid), PC_RANGE, VOXEL, GRID)
    return np.asarray(dense), np.asarray(mask)


def _jax_foreground(mv, active, threshold, topk=True):
    """JAX's foreground rule on JAX's importances (numpy), and each site's
    distance from the k-th value (inf with the threshold rule)."""
    if not topk:
        return active & (mv > threshold), np.abs(mv - threshold)
    b = mv.shape[0]
    flat, act = mv.reshape(b, -1), active.reshape(b, -1)
    n_fore = (act.sum(1).astype(np.float32) * np.float32(threshold)).astype(np.int32)
    ranked = -np.sort(-np.where(act, flat, -1.0), axis=1)
    kth = ranked[np.arange(b), np.clip(n_fore - 1, 0, None)][:, None]
    fore = act & (flat >= kth) & (n_fore[:, None] > 0)
    return fore.reshape(active.shape), np.abs(flat - kth).reshape(active.shape)


def _premise(mv, mv_ref, clear, active):
    """The seed's premise: every active importance within 1e-6 of a frame's
    k-th one equals it exactly (a tie, the same sites in both frameworks),
    so both foreground sets are the same."""
    near = ~clear & active
    for f in range(len(mv)):
        for a in (mv[f][near[f]], mv_ref[f][near[f]]):
            assert a.size == 0 or (a == a[0]).all(), "an importance within 1e-6: another seed"


def test_kernel_offsets_and_shift_match_jax():
    assert fc.kernel_offsets() == jfc._kernel_offsets(3)
    v = np.random.RandomState(0).randn(1, 4, 5, 6, 2).astype(np.float32)
    for off in fc.kernel_offsets():
        np.testing.assert_array_equal(fc.shift(t(v), off).numpy(),
                                      np.asarray(jfc._shift(jnp.asarray(v), off)))


CASES = {"topk": {}, "threshold": {"topk": False}, "mask_multi": {"mask_multi": True},
         "skip_mask_kernel": {"skip_mask_kernel": True}}


_JAX_FOCAL = {}


def _jax_focal(volume, case):
    """JAX's focal convolution of ``case`` in eval and train mode from one
    compile (cached for the case's two tests): (x, variables, eval outputs,
    (train outputs, updated statistics))."""
    if case not in _JAX_FOCAL:
        dense, mask = volume
        x = np.tanh(dense @ np.random.RandomState(1).randn(5, 16).astype(np.float32))
        x = (x * mask).astype(np.float32)
        module = jfc.FocalSparseConv3D(16, voxel_stride=1, **CASES[case])
        variables = shaped_variables(module, x, mask, False, seed=3)
        both = jax.jit(lambda v, a, m: (module.apply(v, a, m, False),
                                        module.apply(v, a, m, True, mutable=["batch_stats"])))
        _JAX_FOCAL[case] = (x, variables, *both(variables, x, mask))
    return _JAX_FOCAL[case]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("train", [False, True])
def test_focal_conv_matches_jax(volume, case, train):
    """One focal convolution on a 16-wide input (a random projection of the
    points' features): the grown mask equal, features within 1e-5 of the
    largest, the importances within 1e-6, and in train mode the updated BN
    statistics within 1e-5."""
    _, mask = volume
    x, variables, ref_eval, ref_train = _jax_focal(volume, case)
    if train:
        (ref, ref_mask, ref_aux), stats = ref_train
    else:
        ref, ref_mask, ref_aux = ref_eval
    port = fc.FocalSparseConv3D(16, 16, 1, **CASES[case])
    port.load_state_dict(weights.focal_conv(variables["params"], variables["batch_stats"]))
    port.train(train)
    got, got_mask, aux = port(t(x), t(mask))
    mv_ref = np.asarray(ref_aux["mask_voxel"])
    np.testing.assert_allclose(aux["mask_voxel"].detach().numpy(), mv_ref, atol=1e-6, rtol=0)
    fore_ref, margin = _jax_foreground(mv_ref, mask[..., 0], 0.5, CASES[case].get("topk", True))
    fore = port.foreground(aux["mask_voxel"].detach(), t(mask[..., 0]))
    clear = margin > TIE
    np.testing.assert_array_equal(fore.numpy()[clear], fore_ref[clear])
    _premise(aux["mask_voxel"].detach().numpy(), mv_ref, clear, mask[..., 0])
    np.testing.assert_array_equal(fore.numpy(), fore_ref)
    assert 0 < fore_ref.sum() < mask.sum()
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    assert got_mask.sum() > mask.sum()  # the active set grew
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL * np.abs(ref).max(), rtol=0)
    if train:
        want = weights.focal_conv(variables["params"], stats["batch_stats"])
        sd = port.state_dict()
        for k in ("bn1.running_mean", "bn1.running_var"):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=TOL, rtol=TOL)


def test_no_foreground_when_k_is_zero():
    """Under two active sites at threshold 0.5 nothing is foreground, and
    nothing grows."""
    m = fc.FocalSparseConv3D(4, 4, 1)
    mask = torch.zeros(1, 5, 5, 5, 1, dtype=torch.bool)
    mask[0, 2, 2, 2] = True
    fore = m.foreground(torch.full((1, 5, 5, 5), 0.7) * mask[..., 0], mask[..., 0])
    assert not fore.any()
    with torch.no_grad():
        _, grown, _ = m.eval()(torch.randn(1, 5, 5, 5, 4), mask)
    assert torch.equal(grown, mask)


@pytest.fixture(scope="module")
def backbone(volume):
    dense, mask = volume
    module = jfc.VoxelBackBone8xFocal()
    variables = shaped_variables(module, dense, mask, False, seed=3)
    fn = jax.jit(lambda v, x, m: module.apply(v, x, m, True, mutable=["batch_stats"]))
    (out, out_mask, stages, aux), stats = fn(variables, dense, mask)
    loss = jax.jit(lambda a, g: jfc.focal_conv_loss(a, g, PC_RANGE, VOXEL))(aux, GT)
    ref = jax.tree_util.tree_map(np.asarray, (out, out_mask, stages, aux, stats["batch_stats"]))
    return variables, ref, float(loss)


def _port_backbone(variables):
    m = fc.VoxelBackBone8xFocal(5)
    m.load_state_dict(weights.voxel_backbone(variables["params"], variables["batch_stats"]),
                      strict=True)
    return m


def test_focal_backbone_train_mode_matches_jax(backbone, volume):
    """VoxelBackBone8xFocal in train mode: output, its mask and each stage
    (x_conv1 .. x_conv4 after the focal layers) within 1e-5 of the largest,
    the masks equal, the importances of the three focal layers within 1e-5
    (the later ones follow train-mode BNs, which carry the frameworks' f32
    rounding to about 1e-6), every masked BN's statistics within 1e-5."""
    dense, mask = volume
    variables, (out, out_mask, stages, aux, stats), _ = backbone
    m = _port_backbone(variables).train()
    got, got_mask, got_stages, got_aux = m(t(dense), t(mask))
    for ref_a, a in zip(aux, got_aux):
        _, margin = _jax_foreground(ref_a["mask_voxel"], ref_a["active"], 0.5)
        _premise(a["mask_voxel"].detach().numpy(), ref_a["mask_voxel"], margin > TIE,
                 ref_a["active"])
        np.testing.assert_allclose(a["mask_voxel"].detach().numpy(), ref_a["mask_voxel"],
                                   atol=TOL)
        assert a["voxel_stride"] == ref_a["voxel_stride"]
    np.testing.assert_array_equal(got_mask.numpy(), out_mask)
    np.testing.assert_allclose(got.detach().numpy(), out, atol=TOL * np.abs(out).max())
    for name, (f, msk, ds) in stages.items():
        gf, gm, gds = got_stages[name]
        assert gds == ds
        np.testing.assert_array_equal(gm.numpy(), msk, err_msg=name)
        np.testing.assert_allclose(gf.detach().numpy(), f, atol=TOL * np.abs(f).max(),
                                   err_msg=name)
    want = weights.voxel_backbone(variables["params"], stats)
    sd = m.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 15
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_focal_loss_matches_jax(backbone, volume):
    """``focal_conv_loss`` of the port's importances (the three focal
    layers, strides 1, 2, 4) against JAX's within 1e-5 relative; the cell
    corners inside the gt boxes (the padded all-zero rows contain none)."""
    dense, mask = volume
    variables, _, ref_loss = backbone
    m = _port_backbone(variables).train()
    _, _, _, aux = m(t(dense), t(mask))
    got = fc.focal_conv_loss(aux, t(GT), PC_RANGE, VOXEL)
    np.testing.assert_allclose(float(got.detach()), ref_loss, rtol=1e-5)
    got.backward()
    assert m.focal1.conv_imp.weight.grad.abs().sum() > 0
    inside = fc._corner_targets(aux[0]["active"].shape, 1, t(GT), PC_RANGE, VOXEL)
    assert 0 < int(inside.sum()) < inside.numel() // 10


def test_points_in_boxes_torch_equals_numpy():
    rng = np.random.RandomState(7)
    pts = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-2, 2, (6, 3)), rng.uniform(0.5, 3, (6, 3)),
                            rng.uniform(-3, 3, (6, 1))], axis=1).astype(np.float32)
    ref = jax_points_in_boxes(pts, boxes)
    np.testing.assert_array_equal(points_in_boxes(t(pts), t(boxes)).numpy(), ref)
    np.testing.assert_array_equal(points_in_boxes(pts, boxes), ref)
    assert ref.any()


def test_focal_backbone_refuses_fewer_than_25_planes():
    with pytest.raises(ValueError, match="25 z-planes"):
        fc.VoxelBackBone8xFocal(5)(torch.zeros(1, 24, 8, 8, 5),
                                   torch.zeros(1, 24, 8, 8, 1, dtype=torch.bool))
