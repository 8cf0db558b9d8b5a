"""The occupancy head's variants of the PyTorch port against the JAX
package's ``RadarOccupancy2D``, on the CPU, in f32: the parallel ASPP
(ASPP_DIAL) with and without deformable branches (USE_DCN), the SE gate
(FUSE_MODE SE), USE_MASK's radial blend and no ASPP at all; in eval mode the
outputs, in train mode (``apply(..., True, mutable=["batch_stats"])``) the
outputs, the updated BN statistics and the gradients of the inputs and of
every parameter, the deformable branches' ``conv_offset`` included, for
random cotangents (``jax.vjp`` against ``torch.autograd``). The offset
convolutions get random weights, so the taps land between pixels and their
gradient runs through the bilinear sample."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models.occupancy import RadarOccupancy2D as JaxOcc
from hgsfusion_tpu_torch import weights
from hgsfusion_tpu_torch.models.occupancy import RadarOccupancy2D
from torch_parity import assert_close, one_torch_thread, perturb_variables, t  # noqa: F401

KEY = jax.random.PRNGKey(0)
C = 16
# module-level tolerance (test_torch_train_modules.py)
TOL = 2e-5
CASES = {
    "parallel": dict(aspp_dilations=(1, 6, 12, 18)),
    "parallel_dcn_se": dict(aspp_dilations=(1, 6, 12, 18), use_dcn=(False, True, False, False),
                            fuse_mode="SE"),
    "dcn_1x1_and_3x3": dict(aspp_dilations=(1, 2), use_dcn=(True, True)),
    "mask": dict(use_mask=True),
    "no_aspp": dict(use_aspp=False),
}


def _setup(name, rng):
    kw = CASES[name]
    jmod = JaxOcc(radar_input_channels=C, **kw)
    image = rng.randn(2, 10, 12, C).astype(np.float32)
    radar = rng.randn(2, 10, 12, C).astype(np.float32)
    v = perturb_variables(jmod.init(KEY, image, radar, False), seed=2)
    for k, sub in v["params"].items():
        if k.startswith("aspp_dcn"):
            off = sub["conv_offset"]
            off["kernel"] = rng.normal(0, 0.05, off["kernel"].shape).astype(np.float32)
            off["bias"] = rng.normal(0, 0.3, off["bias"].shape).astype(np.float32)
    port = RadarOccupancy2D(C, use_aspp=kw.get("use_aspp", True),
                            aspp_dilations=kw.get("aspp_dilations"), use_dcn=kw.get("use_dcn"),
                            use_mask=kw.get("use_mask", False),
                            fuse_mode=kw.get("fuse_mode", "MUL"))
    port.load_state_dict(weights.radar_occupancy(v["params"], v["batch_stats"]), strict=True)
    return jmod, v, image, radar, port


@pytest.mark.parametrize("name", sorted(CASES))
def test_occupancy_variant_eval_matches_jax(name):
    rng = np.random.RandomState(0)
    jmod, v, image, radar, port = _setup(name, rng)
    gated, occ = jax.jit(lambda v, a, b: jmod.apply(v, a, b, False))(v, image, radar)
    with torch.no_grad():
        g, o = port.eval()(t(image), t(radar))
    for got, ref in ((g, gated), (o, occ)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert_close(got, ref, atol=TOL * float(np.abs(ref).max()), rtol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_occupancy_variant_train_matches_jax(name):
    rng = np.random.RandomState(1)
    jmod, v, image, radar, port = _setup(name, rng)

    def fwd(params, a, b):
        out, new = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, a, b, True,
                              mutable=["batch_stats"])
        return out, new["batch_stats"]

    (gated, occ), vjp_fn, new_stats = jax.vjp(fwd, v["params"], jnp.asarray(image),
                                              jnp.asarray(radar), has_aux=True)
    cot_g = rng.randn(*gated.shape).astype(np.float32)
    cot_o = rng.randn(*occ.shape).astype(np.float32)
    g_params, g_image, g_radar = vjp_fn((jnp.asarray(cot_g), jnp.asarray(cot_o)))

    port.train()
    xi, xr = t(image).requires_grad_(), t(radar).requires_grad_()
    g, o = port(xi, xr)
    for got, ref in ((g, gated), (o, occ)):
        ref = np.asarray(ref)
        assert_close(got, ref, atol=TOL * float(np.abs(ref).max()), rtol=TOL)
    ((g.float() * t(cot_g)).sum() + (o * t(cot_o)).sum()).backward()

    state = weights.radar_occupancy(v["params"], jax.tree_util.tree_map(np.asarray, new_stats))
    for k, p in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert_close(p, state[k], atol=1e-6, rtol=1e-5, err_msg=k)
    ref_grads = {k: g.numpy() for k, g in weights.radar_occupancy(g_params,
                                                                  v["batch_stats"]).items()
                 if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    scale = max(float(np.abs(r).max()) for r in ref_grads.values())
    names = {k for k, _ in port.named_parameters()}
    assert names == set(ref_grads)
    if "use_dcn" in CASES[name]:
        assert any(".conv_offset." in k for k in names)
    for k, p in port.named_parameters():
        assert_close(p.grad, ref_grads[k], atol=TOL * scale, rtol=TOL, err_msg=k)
    for got, ref in ((xi.grad, g_image), (xr.grad, g_radar)):
        ref = np.asarray(ref)
        assert_close(got, ref, atol=TOL * float(np.abs(ref).max()), rtol=TOL)
