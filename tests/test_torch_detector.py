"""The whole PyTorch-port model against the JAX package, on the CPU, in f32.

TINY config (tests/test_model.py) with the Pallas sampler on the JAX side
(interpret mode on the CPU) and the kernel's plain version on the port side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgsfusion_tpu.config import load_config as jax_load_config
from hgsfusion_tpu.config import model_config_from_yaml as jax_model_config
from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel
from hgsfusion_tpu.models.detector import post_process as jax_post_process
from hgsfusion_tpu.models.anchors import flatten_anchors as jax_flatten_anchors
from hgsfusion_tpu.models.anchors import generate_anchors as jax_generate_anchors
from hgsfusion_tpu.train.torch_convert import convert_hgsfusion_state
from hgsfusion_tpu.utils.box_coder import ResidualCoder as JaxCoder
from hgsfusion_tpu_torch.config import (load_config, model_config_from_yaml,
                                        vod_pallas_config)
from hgsfusion_tpu_torch.models.anchors import flatten_anchors, generate_anchors
from hgsfusion_tpu_torch.models.detector import HGSFusionModel, post_process
from hgsfusion_tpu_torch.utils.box_coder import ResidualCoder
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import ANCHOR_CFG, TINY, make_tiny_batch
from torch_parity import (assert_close, load, one_torch_thread,  # noqa: F401
                          perturb_variables, port_config, t, to_numpy_tree)

YAML = "configs/hgsfusion_vod_pallas.yaml"
TINY_PALLAS = dataclasses.replace(TINY, f2v_sampler_kernel="pallas")
# head outputs: f32 on both sides; the JAX package holds its own pallas and
# xla samplers to 1e-4 on these outputs (test_pallas_sample.py)
HEAD_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_tiny():
    batch = make_tiny_batch(np.random.RandomState(0))
    model = JaxModel(cfg=TINY_PALLAS)
    variables = jax.jit(lambda b: model.init(jax.random.PRNGKey(0), b, False))(batch)
    variables = perturb_variables(variables, seed=1)
    preds, _ = jax.jit(lambda v, b: model.apply(v, b, False, mutable=["batch_stats"]))(
        variables, batch)
    return variables, batch, {k: np.asarray(v) for k, v in preds.items()}


def test_vod_pallas_preset_equals_yaml():
    port_yaml = model_config_from_yaml(load_config(YAML))
    assert vod_pallas_config() == port_yaml
    ref = dataclasses.replace(jax_model_config(jax_load_config(YAML)),
                              compute_dtype="bfloat16")
    assert port_yaml == port_config(ref, **{
        f: getattr(port_yaml, f) for f in ("anchor_generator", "loss_weights", "score_thresh",
                                           "nms_thresh", "nms_pre_max_size",
                                           "nms_post_max_size", "optimization")})
    # the fields the JAX package reads from the YAML beside its model config:
    # the assigner's thresholds, the loss weights and the OPTIMIZATION block
    yaml = jax_load_config(YAML)
    for got, want in zip(port_yaml.anchor_generator,
                         yaml.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG):
        assert (got["matched_threshold"], got["unmatched_threshold"]) == (
            want["matched_threshold"], want["unmatched_threshold"])
    frozen = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa: E731
    assert port_yaml.loss_weights == frozen(yaml.MODEL.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS)
    assert port_yaml.optimization == frozen(yaml.OPTIMIZATION)
    assert port_yaml.optimization["OPTIMIZER"] == "adam_onecycle"
    assert port_yaml.optimization["BATCH_SIZE_PER_DEVICE"] == 1
    # the anchor generator config, through the flagship's flat anchors
    jax_anchor_cfg = jax_load_config(YAML).MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    np.testing.assert_array_equal(
        flatten_anchors(generate_anchors(port_yaml.anchor_generator,
                                         port_yaml.grid_size, port_yaml.pc_range)[0]),
        jax_flatten_anchors(jax_generate_anchors(jax_anchor_cfg, ref.grid_size,
                                                 ref.pc_range)[0]))


def test_weight_round_trip(jax_tiny):
    """port init -> state_dict -> convert_hgsfusion_state -> flax ->
    from_jax_variables is the identity."""
    variables = jax_tiny[0]
    model = HGSFusionModel(port_config(TINY_PALLAS), device="cpu", seed=3)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    flax_vars, report = convert_hgsfusion_state(state, variables)
    assert not report["unmatched"], report["unmatched"]
    back = from_jax_variables(to_numpy_tree(flax_vars))
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_model_matches_jax(jax_tiny):
    variables, batch, ref = jax_tiny
    model = load(HGSFusionModel(port_config(TINY_PALLAS), device="cpu"),
                 from_jax_variables(variables))
    with torch.no_grad():
        got = model(model.batch_to_device({k: np.asarray(v) for k, v in batch.items()}))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert_close(got[k], ref[k], atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)


def test_post_process_matches_jax():
    """Same kept boxes from tie-free synthetic head outputs on the TINY
    anchors (the random-weight model scores below the threshold)."""
    rng = np.random.RandomState(4)
    nx, ny, _ = TINY.grid_size
    a_loc = TINY.num_anchors_per_location
    cls = rng.normal(-3.0, 1.5, (1, ny, nx, a_loc * 3)).astype(np.float32)
    box = rng.normal(0, 0.3, (1, ny, nx, a_loc * 7)).astype(np.float32)
    dirs = rng.normal(0, 1, (1, ny, nx, a_loc * 2)).astype(np.float32)
    preds = {"cls_preds": cls, "box_preds": box, "dir_cls_preds": dirs}
    anchors = jax_flatten_anchors(
        jax_generate_anchors(ANCHOR_CFG, TINY.grid_size, TINY.pc_range)[0])
    kw = dict(score_thresh=0.1, nms_thresh=0.1, pre_max_size=512, post_max_size=40)
    ref = jax_post_process({k: jnp.asarray(v) for k, v in preds.items()},
                           jnp.asarray(anchors), JaxCoder(), TINY, **kw)
    got = post_process({k: t(v) for k, v in preds.items()}, t(anchors),
                       ResidualCoder(), port_config(TINY), **kw)
    valid = np.array(ref["valid"][0])  # writable: torch indexes with it
    assert 0 < valid.sum() <= 40
    np.testing.assert_array_equal(got["valid"][0].numpy(), valid)
    np.testing.assert_array_equal(got["labels"][0].numpy()[valid],
                                  np.asarray(ref["labels"][0])[valid])
    assert_close(got["scores"][0][valid], np.asarray(ref["scores"][0])[valid], atol=1e-6)
    assert_close(got["boxes"][0][valid], np.asarray(ref["boxes"][0])[valid], atol=1e-5)
