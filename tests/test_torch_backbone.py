"""Camera branch and view transform of the port against the JAX package:
image preprocessing, the ResNet-50 DeepLab taps at 64x96, the frustum grid
and FrustumToVoxelMultiScale (JAX side: sampler_kernel="pallas", interpret
mode), on the CPU in f32."""
import jax
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models.frustum import FrustumGridGenerator as JaxGrid
from hgsfusion_tpu.models.frustum import FrustumToVoxelMultiScale as JaxF2V
from hgsfusion_tpu.models.resnet import ResNetDeepLabBackbone as JaxResNet
from hgsfusion_tpu.models.resnet import preprocess_images as jax_preprocess
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models.frustum import FrustumGridGenerator, FrustumToVoxelMultiScale
from hgsfusion_tpu_torch.models.resnet import ResNetDeepLabBackbone, preprocess_images
from test_model import make_tiny_batch
from torch_parity import (assert_close, load, one_torch_thread,  # noqa: F401
                          perturb_variables, t)

KEY = jax.random.PRNGKey(0)
DISC = dict(mode="LID", depth_min=1.0, depth_max=16.0, num_bins=16)


def test_resnet50_taps():
    rng = np.random.RandomState(0)
    images = rng.rand(1, 64, 96, 3).astype(np.float32)
    images[0, :4] = 0.0  # padded rows stay 0 after normalization
    x = np.asarray(jax_preprocess(images))
    assert_close(preprocess_images(t(images)), x, atol=1e-6)
    jnet = JaxResNet(stage_sizes=(3, 4, 6, 3))
    v = perturb_variables(jax.jit(lambda a: jnet.init(KEY, a, False))(x), seed=2)
    ref = jax.jit(lambda vv, a: jnet.apply(vv, a, False))(v, x)
    net = load(ResNetDeepLabBackbone((3, 4, 6, 3)),
               weights.resnet_backbone(v["params"], v["batch_stats"]))
    with torch.no_grad():
        taps = net(t(x))
    assert [tuple(g.shape) for g in taps] == [
        (1, 16, 24, 256), (1, 8, 12, 512), (1, 8, 12, 1024), (1, 8, 12, 2048)]
    for i, (g, r) in enumerate(zip(taps, ref)):
        # 50 layers of f32 convolution: relative round-off, scaled by the tap
        scale = float(np.abs(np.asarray(r)).max())
        assert_close(g, r, atol=1e-5 * scale, err_msg=f"tap {i}")


@pytest.mark.parametrize("bev_aug", [False, True])
def test_frustum_grid(bev_aug):
    batch = make_tiny_batch(np.random.RandomState(1), b=2)
    bda = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    bda[1, :3, :3] = [[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]]  # a BEV rotation
    args = (np.asarray(batch["trans_lidar_to_cam"]), np.asarray(batch["trans_cam_to_img"]))
    grid_size, pc_range = (32, 32, 10), (0.0, -8.0, -3.0, 16.0, 8.0, 2.0)
    ref = JaxGrid(grid_size, pc_range, DISC, bev_aug)(*args, (64, 96), bda=bda)
    got = FrustumGridGenerator(grid_size, pc_range, DISC, bev_aug)(
        *(t(a) for a in args), (64, 96), bda=t(bda))
    assert got.shape == (2, 32, 32, 10, 3)
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_frustum_to_voxel_pallas():
    rng = np.random.RandomState(2)
    feats = [rng.randn(1, 9, 13, 16).astype(np.float32)] + [
        rng.randn(1, 5, 7, 16).astype(np.float32) for _ in range(3)]
    grid = rng.uniform(-1.2, 1.2, (1, 6, 7, 5, 3)).astype(np.float32)
    jf2v = JaxF2V(out_channels=24, sampler_kernel="pallas")
    v = perturb_variables(jf2v.init(KEY, feats, grid, False), seed=3)
    ref, _ = jf2v.apply(v, feats, grid, False, mutable=["batch_stats"])
    f2v = load(FrustumToVoxelMultiScale([16] * 4, 24),
               weights.frustum_to_voxel(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = f2v([t(f) for f in feats], t(grid))
    assert got.shape == (1, 6, 7, 5, 24)
    assert_close(got, ref, atol=1e-5)
    # SAMPLER_KERNEL: xla runs the same sampler as pallas
    xla = load(FrustumToVoxelMultiScale([16] * 4, 24, sampler_kernel="xla"),
               weights.frustum_to_voxel(v["params"], v["batch_stats"]))
    with torch.no_grad():
        assert torch.equal(xla([t(f) for f in feats], t(grid)), got)
    with pytest.raises(NotImplementedError, match="SAMPLER_KERNEL: mosaic"):
        FrustumToVoxelMultiScale([16] * 4, 24, sampler_kernel="mosaic")
    with pytest.raises(ValueError, match="int8"):
        FrustumToVoxelMultiScale([16] * 4, 24, quant="int8")
    # ADD is ported at module level (tests/test_torch_depth.py); others refused
    with pytest.raises(NotImplementedError, match="FUSE_MODE: MAX"):
        FrustumToVoxelMultiScale([16] * 4, 24, fuse_mode="MAX")
