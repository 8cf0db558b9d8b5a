"""The SECOND-family voxel backbone (``models/voxel_backbone.py``) against
the JAX package's, on the CPU, f32: ``mean_vfe`` bit for bit (points out of
the grid and invalid ones included), ``VoxelBackBone8x`` and
``height_compression`` in eval mode within 1e-5 of the largest output, the
train-mode outputs and the masked BatchNorms' updated statistics within
1e-5, the convolution's tapwise weight gradient against autograd's through
``F.conv3d`` (f64, each kernel, stride and padding of the backbone), the
channel order of the height compression, and the refusal of a grid under
25 z-planes; VoxelNeXt's ``VoxelResBackBone8xVoxelNeXt`` likewise (eval
within 1e-5 of the largest output, train-mode outputs and statistics within
1e-5, its refusal) and ``_place_strided`` at odd sizes exactly. The TINY grid: 32 x 32 x 40 voxels (41 planes with
spconv's extra one), 5 point features, two frames."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models import voxel_backbone as jvb
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models import voxel_backbone as vb
from torch_parity import one_torch_thread, shaped_variables, t  # noqa: F401

PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 2.0)
VOXEL = (0.5, 0.5, 0.125)
GRID = (32, 32, 40)
TOL = 1e-5


def _points(seed=0, b=2, n=600, c=5):
    """Points over and past the range (about a tenth outside), a tenth
    invalid, several to a voxel."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, c), np.float32)
    pts[..., 0] = rng.uniform(-1, 17, (b, n))
    pts[..., 1] = rng.uniform(-9, 9, (b, n))
    pts[..., 2] = rng.uniform(-3.5, 2.5, (b, n))
    pts[..., 3:] = rng.randn(b, n, c - 3)
    pts[:, n // 2:, :3] = pts[:, :n // 2, :3] + rng.uniform(-0.05, 0.05, (b, n - n // 2, 3))
    return pts, rng.rand(b, n) > 0.1


@pytest.fixture(scope="module")
def volume():
    pts, valid = _points()
    dense, mask = jvb.mean_vfe(jnp.asarray(pts), jnp.asarray(valid), PC_RANGE, VOXEL, GRID)
    return pts, valid, np.asarray(dense), np.asarray(mask)


def test_mean_vfe_matches_jax(volume):
    pts, valid, dense, mask = volume
    got, got_mask = vb.mean_vfe(t(pts), t(valid), PC_RANGE, VOXEL, GRID)
    assert got.shape == dense.shape == (2, 41, 32, 32, 5)
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    np.testing.assert_array_equal(got.numpy(), dense)
    assert 100 < mask.sum() < 1200 and not mask[:, -1].any()  # the top plane stays empty
    ids, in_grid = vb.points_to_voxel_ids(t(pts), t(valid), PC_RANGE, VOXEL, GRID)
    ref_ids, ref_in = jvb.points_to_voxel_ids(jnp.asarray(pts), jnp.asarray(valid), PC_RANGE,
                                              VOXEL, GRID)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(in_grid.numpy(), np.asarray(ref_in))


@pytest.fixture(scope="module")
def backbone(volume):
    _, _, dense, mask = volume
    module = jvb.VoxelBackBone8x()
    variables = shaped_variables(module, dense, mask, False, seed=3)
    fwd = jax.jit(lambda v, x, m: module.apply(v, x, m, False)[:2])
    train = jax.jit(lambda v, x, m: module.apply(v, x, m, True, mutable=["batch_stats"]))
    (ref_train, ref_train_mask, _), stats = train(variables, dense, mask)
    return variables, jax.tree_util.tree_map(np.asarray, fwd(variables, dense, mask)), \
        (np.asarray(ref_train), np.asarray(ref_train_mask),
         jax.tree_util.tree_map(np.asarray, stats["batch_stats"]))


def _port(variables):
    m = vb.VoxelBackBone8x(5)
    m.load_state_dict(weights.voxel_backbone(variables["params"], variables["batch_stats"]),
                      strict=True)
    return m


def test_backbone_and_height_compression_match_jax(volume, backbone):
    _, _, dense, mask = volume
    variables, (ref, ref_mask), _ = backbone
    m = _port(variables).eval()
    with torch.no_grad():
        got, got_mask = m(t(dense), t(mask))
    assert got.shape == ref.shape == (2, 2, 4, 4, 128)
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL * scale, rtol=0)
    bev = vb.height_compression(got)
    np.testing.assert_allclose(bev.numpy(), np.asarray(jvb.height_compression(jnp.asarray(ref))),
                               atol=TOL * scale, rtol=0)


def test_backbone_train_mode_matches_jax(volume, backbone):
    """Batch statistics over the active sites, outputs and the updated
    running mean and (unbiased) variance of every masked BN."""
    _, _, dense, mask = volume
    variables, _, (ref, ref_mask, ref_stats) = backbone
    m = _port(variables).train()
    got, got_mask = m(t(dense), t(mask))
    np.testing.assert_array_equal(got_mask.numpy(), ref_mask)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL * float(np.abs(ref).max()))
    want = weights.voxel_backbone(variables["params"], ref_stats)
    sd = m.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 12  # conv_input, conv1, conv2-4 (3 each), conv_out
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0))])
def test_conv3d_ndhwc_gradients(kernel, stride, padding):
    """Output and both gradients of ``conv3d_ndhwc`` equal autograd's
    through ``F.conv3d`` on the permuted views (f64, odd sizes)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 10, 11, 5, dtype=torch.float64, generator=gen)
    w = torch.randn((4,) + kernel + (5,), dtype=torch.float64, generator=gen)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    y1 = vb.conv3d_ndhwc(x1, w1, stride, padding)
    g = torch.randn(y1.shape, dtype=torch.float64, generator=gen)
    y1.backward(g)
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    y2 = torch.nn.functional.conv3d(x2.permute(0, 4, 1, 2, 3), w2.permute(0, 4, 1, 2, 3), None,
                                    stride, padding).permute(0, 2, 3, 4, 1)
    y2.backward(g)
    for got, want in ((y1, y2), (x1.grad, x2.grad), (w1.grad, w2.grad)):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=1e-12)


def test_height_compression_channel_order():
    """Channel c D + d of the BEV map is plane d of channel c, as the
    reference's (B, C, D, H, W) view: checked on an index volume."""
    b, d, h, w, c = 1, 3, 2, 2, 4
    x = torch.arange(b * d * h * w * c, dtype=torch.float32).reshape(b, d, h, w, c)
    bev = vb.height_compression(x)
    for ci in range(c):
        for di in range(d):
            assert torch.equal(bev[..., ci * d + di], x[:, di, :, :, ci])
    np.testing.assert_array_equal(bev.numpy(), np.asarray(jvb.height_compression(x.numpy())))


def test_refuses_fewer_than_25_planes():
    m = vb.VoxelBackBone8x(5)
    with pytest.raises(ValueError, match="25 z-planes"):
        m(torch.zeros(1, 24, 8, 8, 5), torch.zeros(1, 24, 8, 8, 1, dtype=torch.bool))


# ---- VoxelNeXt's backbone (VoxelResBackBone8xVoxelNeXt) -------------------

@pytest.fixture(scope="module")
def voxelnext(volume):
    """The JAX module's eval and train-mode outputs and updated statistics
    on ``volume`` (one jit each)."""
    _, _, dense, mask = volume
    module = jvb.VoxelResBackBone8xVoxelNeXt()
    variables = shaped_variables(module, dense, mask, False, seed=4)
    fwd = jax.jit(lambda v, x, m: module.apply(v, x, m, False))
    train = jax.jit(lambda v, x, m: module.apply(v, x, m, True, mutable=["batch_stats"]))
    (ref_train, ref_train_mask), stats = train(variables, dense, mask)
    return variables, jax.tree_util.tree_map(np.asarray, fwd(variables, dense, mask)), \
        (np.asarray(ref_train), np.asarray(ref_train_mask),
         jax.tree_util.tree_map(np.asarray, stats["batch_stats"]))


def _port_voxelnext(variables, stats=None):
    m = vb.VoxelResBackBone8xVoxelNeXt(5)
    m.load_state_dict(weights.voxelnext_backbone(variables["params"], stats or
                                                 variables["batch_stats"]), strict=True)
    return m


@pytest.mark.parametrize("train", [False, True])
def test_voxelnext_backbone_matches_jax(volume, voxelnext, train):
    """Eval: the BEV features and mask within 1e-5 of the largest output.
    Train: the outputs and every masked BN's updated running mean and
    (unbiased) variance within 1e-5 (32 BNs: conv_input, 2 x 2 in conv1,
    1 + 2 x 2 in each of conv2-6, conv_out, shared_conv)."""
    _, _, dense, mask = volume
    variables, (ref, ref_mask), (ref_t, ref_t_mask, ref_stats) = voxelnext
    m = _port_voxelnext(variables).train(train)
    with torch.set_grad_enabled(train):
        got, got_mask = m(t(dense), t(mask))
    want, want_mask = (ref_t, ref_t_mask) if train else (ref, ref_mask)
    assert got.shape == want.shape == (2, 4, 4, 128)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))
    if train:
        sd = m.state_dict()
        expect = weights.voxelnext_backbone(variables["params"], ref_stats)
        names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(names) == 2 * 32
        for k in names:
            np.testing.assert_allclose(sd[k].numpy(), expect[k].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("stride,src,target", [(2, (3, 2, 2), (6, 4, 4)), (2, (4, 3, 5), (7, 5, 9)),
                                               (4, (2, 2, 3), (5, 6, 9)), (4, (2, 1, 1), (3, 3, 3))])
def test_place_strided_matches_jax_exactly(stride, src, target):
    """Odd sizes: the placed volume clipped at the grid's edge."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, *src, 3).astype(np.float32)
    m = rng.rand(2, *src, 1) < 0.5
    ref, ref_m = jvb._place_strided(jnp.asarray(x), jnp.asarray(m), target, stride)
    got, got_m = vb._place_strided(t(x), t(m), target, stride)
    assert got.shape == (2,) + target + (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def test_voxelnext_refuses_fewer_than_25_planes():
    m = vb.VoxelResBackBone8xVoxelNeXt(5)
    with pytest.raises(ValueError, match="VoxelNeXt backbone needs >= 25 z-planes"):
        m(torch.zeros(1, 24, 8, 8, 5), torch.zeros(1, 24, 8, 8, 1, dtype=torch.bool))
