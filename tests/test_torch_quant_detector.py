"""The TINY detector under F2V QUANT int8 and DDN QUANT w8a8 against the
JAX package, on the CPU (the modules: ``test_torch_quant.py``): its heads
as ``serve`` computes them, the unquantized model's weights loading
unchanged, the refusal to train under w8a8, and the export through
``tools/export.py`` with the int8 ops in the graph."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hgsfusion_tpu.models.detector import HGSFusionModel as JaxModel
from hgsfusion_tpu_torch.models.detector import HGSFusionModel
from hgsfusion_tpu_torch.tools.export import export_model, model_inputs
from hgsfusion_tpu_torch.weights import from_jax_variables
from test_model import make_tiny_batch
from test_torch_quant import HEAD_TOL, TINY_Q8, TINY_W8, _rel_l2
from torch_parity import assert_close, load, one_torch_thread, perturb_variables, port_config  # noqa: F401


@pytest.fixture(scope="module")
def jax_tiny_runs():
    """seed -> (variables, batch, preds): JAX's TINY model initialized from
    PRNGKey(seed), perturbed with seed + 1, and its w8a8 and q8 heads; the
    init and the two applies compile once for every seed."""
    batch = make_tiny_batch(np.random.RandomState(0))
    init = jax.jit(lambda key, b: JaxModel(cfg=TINY_W8).init(key, b, False))
    applies = {name: jax.jit(lambda v, b, model=JaxModel(cfg=cfg): model.apply(
        v, b, False, mutable=["batch_stats"])[0]) for name, cfg in (("w8a8", TINY_W8),
                                                                     ("q8", TINY_Q8))}

    def run(seed):
        variables = perturb_variables(init(jax.random.PRNGKey(seed), batch), seed=seed + 1)
        preds = {name: {k: np.asarray(v) for k, v in apply(variables, batch).items()}
                 for name, apply in applies.items()}
        return variables, batch, preds
    return run


@pytest.fixture(scope="module")
def jax_tiny_w8(jax_tiny_runs):
    return jax_tiny_runs(0)


def _check_heads(jax_run, name):
    """The port's TINY detector (``cfg`` of ``name``) as ``serve`` runs it
    against JAX's heads of the same weights: q8 within HEAD_TOL; w8a8 no
    further from JAX's w8a8 heads than these are from JAX's q8 heads (the
    same model without w8a8)."""
    variables, batch, preds = jax_run
    cfg = TINY_W8 if name == "w8a8" else TINY_Q8
    model = load(HGSFusionModel(port_config(cfg), device="cpu"), from_jax_variables(variables))
    with torch.inference_mode():
        got = model(model.batch_to_device({k: np.asarray(v) for k, v in batch.items()}))
    ref = preds[name]
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if name == "q8":
            assert_close(got[k], ref[k], atol=HEAD_TOL, rtol=HEAD_TOL, err_msg=k)
            continue
        port_err, quant_err = _rel_l2(got[k].float().numpy(), ref[k]), _rel_l2(
            ref[k], preds["q8"][k])
        print(f"w8a8 head {k}: |port - jax| {port_err:.3g}, |jax w8a8 - jax| {quant_err:.3g}")
        assert port_err <= max(2.0 * quant_err, 1e-5), k
    return model, batch


@pytest.mark.parametrize("name", ["q8", "w8a8"])
def test_tiny_quant_detector_matches_jax(jax_tiny_w8, name):
    """The TINY detector under F2V QUANT int8 (and DDN QUANT w8a8), as
    ``serve`` runs it (eval mode, no gradient), against JAX's heads: q8
    within HEAD_TOL; w8a8 no further from JAX's w8a8 heads than these are
    from JAX's heads without w8a8 (see ``test_w8a8_backbone_matches_jax``)."""
    model, batch = _check_heads(jax_tiny_w8, name)
    dets = model.serve({k: np.asarray(v) for k, v in batch.items()})
    assert dets["boxes"].shape == (1, model.cfg.nms_post_max_size, 7)


@pytest.mark.parametrize("seed", [1, 2])
def test_tiny_w8a8_detector_matches_jax_at_more_seeds(jax_tiny_runs, seed):
    """The w8a8 case above at two more weight seeds (the same shapes, so
    JAX's compiles are shared), each held to JAX's own quantization error:
    where the port's w8a8 heads stand from JAX's, against how far JAX's
    w8a8 heads stand from its unquantized ones."""
    _check_heads(jax_tiny_runs(seed), "w8a8")


def test_w8a8_takes_the_unquantized_weights_and_refuses_to_train(jax_tiny_w8):
    """A w8a8 model's state_dict is the unquantized model's: the same keys,
    and either loads the other's weights strictly. Training raises, as in
    JAX."""
    plain = HGSFusionModel(port_config(dataclasses.replace(TINY_W8, ddn_quant="none")),
                           device="cpu", seed=2)
    quant = HGSFusionModel(port_config(TINY_W8), device="cpu", seed=5)
    assert list(plain.state_dict()) == list(quant.state_dict())
    quant.load_state_dict(plain.state_dict(), strict=True)
    for k, v in plain.state_dict().items():
        assert torch.equal(quant.state_dict()[k], v), k
    quant.train()
    with pytest.raises(NotImplementedError, match="eval-only"):
        quant(quant.batch_to_device({k: np.asarray(v) for k, v in jax_tiny_w8[1].items()}))


@pytest.mark.parametrize("name", ["q8", "w8a8"])
def test_quant_model_exports_with_its_ops(name):
    """``tools/export.py``'s ``export_model`` on the TINY int8 variants: the
    graph calls the int8 ops (``quad_sample_reduce_q8_fwd``, and under w8a8
    ``conv2d_w8a8``, the weights quantized inside it) and the program
    returns ``serve``'s detections bit for bit."""
    cfg = port_config(TINY_W8 if name == "w8a8" else TINY_Q8)
    model = HGSFusionModel(cfg, device="cpu", seed=0)
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(np.random.RandomState(0)).items()}
    ref = model.serve(batch)
    program, _ = export_model(model, batch)
    ops = {str(n.target) for n in program.graph.nodes if "hgsfusion" in str(n.target)}
    want = {"hgsfusion.quad_sample_reduce_q8_fwd.default", "hgsfusion.nms_lazy.default"}
    if name == "w8a8":
        want.add("hgsfusion.conv2d_w8a8.default")
    assert ops == want
    got = program.module()(model_inputs(model, batch))
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
