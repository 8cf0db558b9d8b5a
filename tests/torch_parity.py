"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed, run through the JAX function and
its port counterpart on the CPU, and compared as numpy arrays.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hgsfusion_tpu_torch.config import HGSFusionConfig as PortConfig


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep each xdist worker's torch to one thread; restore afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jax_cfg, **overrides) -> PortConfig:
    """The port config with every field the JAX config shares copied over."""
    shared = {f.name: getattr(jax_cfg, f.name)
              for f in dataclasses.fields(PortConfig) if hasattr(jax_cfg, f.name)}
    return PortConfig(**{**shared, **overrides})


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def perturb_variables(variables, seed=0):
    """Random BN statistics and affine parameters, so the eval BatchNorms are
    not identities and a mis-mapped statistic shows in the outputs."""
    rng = np.random.RandomState(seed)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.array(node, np.float32)
        if name == "mean":
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == "bias":
            return a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        return a

    return walk(to_numpy_tree(dict(variables)))


_SHAPES = {}


def variable_shapes(module, *args):
    """The shapes of ``module``'s init on ``args`` (``jax.eval_shape``:
    traced, nothing compiles), traced once per module (its ``repr``: type
    and fields) and argument shapes in a process: a test file's forward
    and step of one model share the trace."""
    key = (repr(module), str(jax.tree_util.tree_map(
        lambda a: (np.shape(a), np.asarray(a).dtype.str), args)))
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return _SHAPES[key]


def shaped_variables(module, *args, seed: int = 0):
    """Numpy variables in the shapes of ``module``'s init on ``args``
    (``variable_shapes``): kernels LeCun normal, biases near 0, norm scales
    near 1, BN means near 0 and variances in [0.5, 1.5], other parameters
    N(0, 0.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.8, 1.2, s.shape) if name == "scale" else rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            a = rng.normal(0.0, 0.05 if name == "bias" else 0.1, s.shape)
        else:
            a = rng.normal(0.0, 0.5, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(variable_shapes(module, *args)))


def lift_bn_biases(variables, shift: float = 4.0):
    """``variables`` with every BatchNorm's bias (a module named ``*bn*``)
    raised by ``shift``: in train mode a normalized value plus 4 sits below
    0 for 0.003% of the units, so the ReLUs after them barely ever switch
    under a rounding-sized change of the input. A deep plain conv stack
    with random weights in train mode is ill-conditioned otherwise (single
    ReLU flips move its gradients by percents, ``step_compare.SENS_CAP``);
    this is the plain-stack counterpart of ``zero_residual_scales``."""
    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "bias" and "bn" in path[-2]:
            return np.asarray(node) + np.float32(shift)
        return node
    return {**variables, "params": walk(variables["params"])}


def load(module, state_dict):
    """Load a converted state_dict strictly into ``module`` and return it in
    eval mode."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def assert_close(got, ref, atol, rtol=0.0, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _grad_capture():
    """An optax transformation that passes the gradients on and keeps them
    as its state, so a jitted step returns what it differentiated."""
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jax.numpy.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def compare_one_step(variables, jax_make_step, port_model, port_make_step, batch, optim_cfg,
                     total_steps: int = 20, probes=(1, 2)):
    """One training step from the same weights and a fresh optimizer on both
    sides, held to ``step_compare.compare_steps``; returns its report.

    ``variables``: the JAX model's {"params", "batch_stats"} (numpy);
    ``jax_make_step(tx)`` -> the JAX step (state, batch) -> (state, tb);
    ``port_model()`` -> a fresh port model on the CPU (the weights are
    loaded here); ``port_make_step(model, optimizer)`` -> the port's step;
    ``batch``: numpy arrays. The port's sensitivity comes from its own step
    on inputs perturbed by ``probes``' seeds."""
    import optax

    from hgsfusion_tpu.train.optim import build_optimizer as jax_build_optimizer
    from hgsfusion_tpu.train.trainer import TrainState
    from hgsfusion_tpu_torch.train.optim import build_optimizer
    from hgsfusion_tpu_torch.train.step_compare import (GradCapture, compare_steps,
                                                        perturb_inputs, sensitivity,
                                                        step_record)
    from hgsfusion_tpu_torch.weights import from_jax_variables

    def port_tree(params, stats):
        return {k: torch.from_numpy(np.array(v)) for k, v in
                from_jax_variables({"params": params, "batch_stats": stats}).items()}

    def port_run(perturb_seed=None):
        model = load(port_model(), from_jax_variables(variables))
        opt, lr_schedule = build_optimizer(dict(optim_cfg), total_steps, model)
        cap = GradCapture(opt)
        step = port_make_step(model, cap)
        pbatch = model.batch_to_device({k: np.asarray(v) for k, v in batch.items()})
        if perturb_seed is not None:
            pbatch = perturb_inputs(pbatch, perturb_seed)
        _, tb = step(pbatch)
        return step_record(model, cap, tb), float(lr_schedule(0))

    got, lr = port_run()
    sens = sensitivity(got["grads"], [port_run(s)[0]["grads"] for s in probes])
    tx, _ = jax_build_optimizer(optim_cfg, total_steps=total_steps, params=variables["params"])
    tx = optax.chain(_grad_capture(), tx)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=jax.jit(tx.init)(variables["params"]),
                       step=np.zeros((), np.int32))
    after, tb = jax.jit(jax_make_step(tx))(state, {k: np.asarray(v) for k, v in batch.items()})
    names = list(got["grads"])
    grads = port_tree(after.opt_state[0], after.batch_stats)
    tree = port_tree(after.params, after.batch_stats)
    ref = {"tb": {k: torch.tensor(float(v)) for k, v in tb.items()},
           "grads": {k: grads[k] for k in names}, "params": {k: tree[k] for k in names},
           "stats": {k: v for k, v in tree.items()
                     if k.endswith(("running_mean", "running_var"))}}
    return compare_steps(ref, got, sens, lr)
