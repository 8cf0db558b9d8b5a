"""Ball query and grouping (``ops/pointnet2.py``) against the JAX package's
``ball_query`` and ``query_and_group``, on the CPU: the dense form's index
lists, any-neighbour masks and grouped rows equal JAX's exactly, and the
windowed query over a voxel stage's cell centres (``ball_query_grid``)
gives the dense query's index lists exactly at Voxel R-CNN's x_conv2,
x_conv3 and x_conv4 geometry (stride 2, 4, 8 of 0.16 x 0.16 x 0.1 m
cells, radius 1.8 x stride x 0.16 m), cut to small grids, with inactive
cells, centres on and off the grid and centres past its edges. A centre
some of whose cells lie within 4 ulp of radius^2 may flip between the
two forms' f32 sums (XLA may fuse them into FMAs); such centres are left
out and counted, and must be under 1%. The cell centres equal JAX's
``_stage_point_set``'s bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models.pvrcnn import _stage_point_set as jax_stage_point_set
from hgsfusion_tpu.ops import pointnet2 as jpn
from hgsfusion_tpu_torch.ops import pointnet2 as pn
from torch_parity import one_torch_thread, t  # noqa: F401

PC_RANGE = (0.0, -25.6, -3.0, 51.2, 25.6, 2.0)
VOXEL = (0.16, 0.16, 0.1)
NEAR_ULP = 4


def _jax_query(new_xyz, xyz, valid, radius, nsample):
    fn = jax.jit(lambda a, b, v: jpn.ball_query(a, b, v, radius, nsample))
    idx, any_nb = fn(jnp.asarray(new_xyz), jnp.asarray(xyz), jnp.asarray(valid))
    return np.asarray(idx), np.asarray(any_nb)


def _near_tie(new_xyz, xyz, valid, radius):
    """Centres with a valid point whose f32 squared distance lies within
    NEAR_ULP ulp of radius^2."""
    d = new_xyz[:, None, :].astype(np.float32) - xyz[None, :, :].astype(np.float32)
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    r2 = np.float32(radius * radius)
    near = np.abs(d2 - r2) <= NEAR_ULP * np.spacing(r2)
    return (near & valid[None, :]).any(axis=1)


@pytest.mark.parametrize("seed,radius,nsample", [(0, 0.4, 8), (1, 0.8, 16), (2, 1.5, 4)])
def test_dense_ball_query_matches_jax(seed, radius, nsample):
    """Random points with a fifth invalid and some far centres: equal index
    lists and masks (first nsample in index order, repeats of the first,
    zeros for an empty ball)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    new_xyz = np.concatenate([rng.uniform(-2, 2, (60, 3)),
                              rng.uniform(5, 6, (4, 3))]).astype(np.float32)
    valid = rng.rand(300) > 0.2
    ref_idx, ref_any = _jax_query(new_xyz, xyz, valid, radius, nsample)
    idx, any_nb = pn.ball_query(t(new_xyz), t(xyz), t(valid), radius, nsample)
    keep = ~_near_tie(new_xyz, xyz, valid, radius)
    np.testing.assert_array_equal(idx.numpy()[keep], ref_idx[keep])
    np.testing.assert_array_equal(any_nb.numpy()[keep], ref_any[keep])
    assert not ref_any[-4:].any() and (idx.numpy()[-4:] == 0).all()
    assert ref_any.sum() >= 30


@pytest.mark.parametrize("zero_empty", [True, False])
def test_query_and_group_matches_jax(zero_empty):
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-1, 1, (120, 3)).astype(np.float32)
    feats = rng.randn(120, 6).astype(np.float32)
    new_xyz = np.concatenate([rng.uniform(-1, 1, (20, 3)), [[9.0, 9.0, 9.0]]]).astype(np.float32)
    valid = rng.rand(120) > 0.3
    fn = jax.jit(lambda a, b, f, v: jpn.query_and_group(a, b, f, v, 0.5, 8,
                                                        zero_empty=zero_empty))
    ref, ref_idx, ref_any = (np.asarray(x) for x in fn(new_xyz, xyz, feats, valid))
    got, idx, any_nb = pn.query_and_group(t(new_xyz), t(xyz), t(feats), t(valid), 0.5, 8,
                                          zero_empty=zero_empty)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(any_nb.numpy(), ref_any)
    np.testing.assert_array_equal(got.numpy(), ref)


def _stage(shape_dhw, stride, seed, active=0.3):
    rng = np.random.RandomState(seed)
    d, h, w = shape_dhw
    feats = rng.randn(1, d, h, w, 4).astype(np.float32)
    mask = rng.rand(1, d, h, w, 1) < active
    return feats, mask, stride


def test_grid_centers_match_stage_point_set():
    """The windowed query's cell centres are JAX's ``_stage_point_set``
    centres, bit for bit, at each stride."""
    for stride, shape in ((2, (26, 12, 10)), (4, (13, 9, 7)), (8, (6, 5, 4))):
        feats, mask, _ = _stage(shape, stride, 0)
        ref, _, _ = jax.jit(lambda f, m: jax_stage_point_set((f, m, stride), PC_RANGE, VOXEL))(
            feats, mask)
        axes = pn.grid_axes(shape, stride, PC_RANGE, VOXEL, "cpu")
        np.testing.assert_array_equal(pn.grid_centers(axes).numpy(), np.asarray(ref))


def _centres(rng, axes, n):
    """Centres spread over the grid, a tenth on cell centres exactly, a few
    past each edge."""
    zs, ys, xs = (a.numpy() for a in axes)
    lo = np.array([xs[0], ys[0], zs[0]]) - 1.0
    hi = np.array([xs[-1], ys[-1], zs[-1]]) + 1.0
    c = rng.uniform(lo, hi, (n, 3))
    k = n // 10
    c[:k] = np.stack([rng.choice(xs, k), rng.choice(ys, k), rng.choice(zs, k)], axis=-1)
    c[-4:] = [[lo[0] - 3, 0, 0], [hi[0] + 3, 0, 0], [0, lo[1] - 3, 0], [0, 0, hi[2] + 5]]
    return c.astype(np.float32)


@pytest.mark.parametrize("name,stride,shape", [("x_conv2", 2, (26, 20, 18)),
                                               ("x_conv3", 4, (13, 14, 12)),
                                               ("x_conv4", 8, (6, 9, 8))])
def test_windowed_query_equals_dense(name, stride, shape):
    """The windowed query over a stage's cells against JAX's dense
    ``ball_query`` over its centre set, 16 samples: equal index lists and
    masks for every centre whose cells are all further than NEAR_ULP ulp
    from radius^2 (the rest counted; under 1%), and equal to the port's
    own dense form for every centre."""
    feats, mask, _ = _stage(shape, stride, stride)
    radius = 1.8 * stride * max(VOXEL)
    axes = pn.grid_axes(shape, stride, PC_RANGE, VOXEL, "cpu")
    centers = pn.grid_centers(axes)
    valid = torch.from_numpy(mask.reshape(-1))
    rng = np.random.RandomState(10 + stride)
    new_xyz = _centres(rng, axes, 800)
    pitch = tuple(VOXEL[a] * stride for a in (2, 1, 0))
    origin = tuple(PC_RANGE[a] for a in (2, 1, 0))
    idx, any_nb = pn.ball_query_grid(t(new_xyz), axes, pitch, origin, valid, radius, 16,
                                     chunk=256)
    ref_idx, ref_any = _jax_query(new_xyz, centers.numpy(), mask.reshape(-1), radius, 16)
    keep = ~_near_tie(new_xyz, centers.numpy(), mask.reshape(-1), radius)
    assert keep.mean() > 0.99, f"{(~keep).sum()} centres within {NEAR_ULP} ulp"
    np.testing.assert_array_equal(idx.numpy()[keep], ref_idx[keep])
    np.testing.assert_array_equal(any_nb.numpy()[keep], ref_any[keep])
    dense_idx, dense_any = pn.ball_query(t(new_xyz), centers, valid, radius, 16)
    np.testing.assert_array_equal(idx.numpy(), dense_idx.numpy())
    np.testing.assert_array_equal(any_nb.numpy(), dense_any.numpy())
    # the balls hold between none and more than 16 cells
    assert 0.5 < ref_any.mean() < 1.0
    counts = (ref_idx != ref_idx[:, :1]).sum(1)
    assert (counts == 15).any()


def test_windowed_query_groups_like_jax():
    """``query_and_group`` with the stage's grid (the windowed query)
    against JAX's over the centre set: equal grouped rows."""
    shape, stride = (13, 10, 9), 4
    feats, mask, _ = _stage(shape, stride, 5, active=0.5)
    axes = pn.grid_axes(shape, stride, PC_RANGE, VOXEL, "cpu")
    centers = pn.grid_centers(axes)
    new_xyz = _centres(np.random.RandomState(6), axes, 200)
    radius = 1.8 * stride * 0.16
    grid = (axes, tuple(VOXEL[a] * stride for a in (2, 1, 0)),
            tuple(PC_RANGE[a] for a in (2, 1, 0)))
    f = feats.reshape(-1, 4)
    v = mask.reshape(-1)
    keep = ~_near_tie(new_xyz, centers.numpy(), v, radius)
    got, _, _ = pn.query_and_group(t(new_xyz), centers, t(f), t(v), radius, 16, grid=grid)
    fn = jax.jit(lambda a, b, c, d: jpn.query_and_group(a, b, c, d, radius, 16))
    ref, _, _ = fn(new_xyz, centers.numpy(), f, v)
    np.testing.assert_array_equal(got.numpy()[keep], np.asarray(ref)[keep])


def test_windowed_query_non_finite_centres():
    """Centres at NaN or infinity find no cell (all-zero indices), as the
    dense rule gives them."""
    shape, stride = (6, 5, 4), 8
    axes = pn.grid_axes(shape, stride, PC_RANGE, VOXEL, "cpu")
    valid = torch.ones(6 * 5 * 4, dtype=torch.bool)
    c = torch.tensor([[float("nan"), 0.0, 0.0], [float("inf"), 0.0, 0.0],
                      [0.0, -float("inf"), 0.0]])
    idx, any_nb = pn.ball_query_grid(c, axes, (0.8, 1.28, 1.28), (-3.0, -25.6, 0.0), valid,
                                     2.304, 16)
    assert not any_nb.any() and (idx == 0).all()
