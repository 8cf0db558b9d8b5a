"""The port's data-parallel training (``parallel/mesh.py``, the synchronized
BatchNorms of ``models/layers.py``, DDP in ``train/trainer.py``, the loader's
rank slices) on the CPU, in gloo process groups.

What JAX computes over its data mesh is one step on the global batch, so a
process group of W ranks at B each is held to one process at B x W:

- each BatchNorm (``batch_norm`` NHWC and NCHW, ``batch_norm_joint``,
  ``MaskedBatchNorm``) in 2 ranks against the single call on the joined
  input: outputs, running statistics and input gradients within 1e-6 of
  the largest value (f32; the sums run in another order), the affine
  parameters' gradients summed over the ranks likewise;
- one TINY training step in 2 ranks at B=1 against one process at B=2 under
  ``train/step_compare.py``, gather and polar views, and a second step
  (DDP refuses it if a trainable parameter got no gradient in the first);
- DDP at world size 1 against the plain step, bit for bit.

The single-process B=2 step is held to JAX's by the same tolerances in
tests/test_torch_tj4d.py; the single-process BatchNorms in
tests/test_torch_train_modules.py.
"""
import numpy as np
import pytest
import torch

import torch_dist
from chip_smoke import TINY, TINY_POLAR, tiny_batch
from hgsfusion_tpu_torch.datasets.loader import PrefetchLoader
from hgsfusion_tpu_torch.parallel import mesh, spawn
from hgsfusion_tpu_torch.train.step_compare import (SENS_CAP, compare_steps, over_cap,
                                                    sensitivity)
from torch_parity import one_torch_thread  # noqa: F401

BN_CASES = ("nhwc", "nchw", "joint", "masked")
BN_RTOL = 1e-6  # of the largest |value| of each compared tensor
VIEWS = {"gather": TINY, "polar": TINY_POLAR}
# the weights of the B=2 step: a seed whose step the single process's own
# 1e-7 probes find well conditioned (step_compare.SENS_CAP). At B=2 most
# seeds are not: with seeds 0, 2, 4 and 5 a probe flips ReLUs past the cap
# (sensitivity 1.4-20x10^-3 of a tensor's largest gradient), the finding of
# ROADMAP.md queue 3 check 1 for the TJ4D B=2 step; seed 1 sits at 2x10^-4.
DDP_WEIGHT_SEED = 1


@pytest.fixture(scope="module")
def bn_ranks():
    return spawn.spawn_ranks(torch_dist.bn_rank, 2, BN_CASES)


def _close(got, want, what):
    tol = BN_RTOL * max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("case", BN_CASES)
def test_sync_batch_norm_equals_the_joined_batch(bn_ranks, case):
    ref = torch_dist.bn_run(case)
    got = [r[case] for r in bn_ranks]
    for i, want in enumerate(ref["out"]):
        _close(torch.cat([g["out"][i] for g in got]), want, f"{case} output {i}")
        _close(torch.cat([g["x_grad"][i] for g in got]), ref["x_grad"][i], f"{case} dx {i}")
    for k in ("weight_grad", "bias_grad"):
        _close(got[0][k] + got[1][k], ref[k], f"{case} {k}")
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[0][k], got[1][k]), k
        _close(got[0][k], ref[k], f"{case} {k}")


def test_batch_norm_without_a_group_is_unchanged():
    # the single-process arithmetic, run twice: bit for bit (no collective)
    for case in BN_CASES:
        a, b = torch_dist.bn_run(case), torch_dist.bn_run(case)
        for x, y in zip(a["out"] + a["x_grad"], b["out"] + b["x_grad"]):
            assert torch.equal(x, y), case


@pytest.fixture(scope="module")
def steps():
    """Per view: one process at B=2 (and its two probes), and 2 ranks at
    B=1 each taking two steps; one torch thread everywhere."""
    torch.set_num_threads(1)
    batch = tiny_batch(2)
    out = {}
    for view, cfg in VIEWS.items():
        ref, lr = torch_dist.train_steps(None, cfg, batch, 1, DDP_WEIGHT_SEED)
        probes = [torch_dist.train_steps(None, cfg, batch, 1, DDP_WEIGHT_SEED, s)[0][0]["grads"]
                  for s in (1, 2)]
        ranks = spawn.spawn_ranks(torch_dist.train_steps, 2, cfg, batch, 2, DDP_WEIGHT_SEED)
        out[view] = {"ref": ref[0], "lr": lr, "sens": sensitivity(ref[0]["grads"], probes),
                     "ranks": [r[0] for r in ranks]}
    return out


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_two_ranks_at_b1_equal_one_process_at_b2(steps, view):
    s = steps[view]
    report = compare_steps(s["ref"], s["ranks"][0][0], s["sens"], s["lr"])
    print(f"{view}: {report}")
    assert float(s["ref"]["tb"]["rpn_loss_cls"]) > 0


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_ranks_stay_equal_for_two_steps(steps, view):
    a, b = steps[view]["ranks"]
    assert len(a) == len(b) == 2
    for step_a, step_b in zip(a, b):
        for part in ("tb", "params", "stats", "grads"):
            for k, v in step_a[part].items():
                assert torch.equal(v, step_b[part][k]), (part, k)


def test_ddp_at_world_size_1_equals_the_plain_step():
    batch = tiny_batch(1)
    plain, _ = torch_dist.train_steps(None, TINY, batch, 2, DDP_WEIGHT_SEED)
    (wrapped, _), = spawn.spawn_ranks(torch_dist.train_steps, 1, TINY, batch, 2, DDP_WEIGHT_SEED)
    for step_p, step_w in zip(plain, wrapped):
        for part in ("tb", "params", "stats", "grads"):
            for k, v in step_p[part].items():
                assert torch.equal(v, step_w[part][k]), (part, k)


class _Frames:
    """A dataset of frame indices, for the loader's schedule."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i

    @staticmethod
    def collate_batch(samples):
        return list(samples)


@pytest.mark.parametrize("n, per_rank, world", [(10, 1, 2), (9, 2, 2), (3, 2, 2), (12, 1, 4)])
def test_rank_loaders_split_the_single_process_schedule(n, per_rank, world):
    """W ranks at B see, batch by batch, the frames of one process at W x B
    (one seed; the last short batch of an epoch dropped, a batch larger
    than the dataset topped up)."""
    one = PrefetchLoader(_Frames(n), per_rank * world, num_workers=0, seed=5).batches()
    ranks = [PrefetchLoader(_Frames(n), per_rank, num_workers=0, seed=5, rank=r,
                            world_size=world).batches() for r in range(world)]
    for _ in range(7):
        assert next(one) == [i for it in ranks for i in next(it)]


def test_rank_slice():
    batch = {k: v for k, v in tiny_batch(4).items()}
    batch["frame_id"] = ["a", "b", "c", "d"]
    batch["batch_size"] = 4
    part = mesh.rank_slice(batch, 1, 2)
    assert part["batch_size"] == 2 and part["frame_id"] == ["c", "d"]
    np.testing.assert_array_equal(part["points"], batch["points"][2:4])
    with pytest.raises(ValueError):
        mesh.rank_slice(batch, 0, 3)


def _record(grads):
    return {"tb": {"loss": torch.tensor(1.0)}, "grads": grads, "stats": {},
            "params": {k: torch.zeros_like(g) for k, g in grads.items()}}


def test_only_the_exempt_tensors_are_left_out():
    """``over_cap`` names the tensors whose sensitivity passes the cap;
    ``compare_steps`` leaves out those it is given and holds every other."""
    g = {"ill": torch.ones(4), "well": torch.ones(4)}
    sens = {"ill": 2 * SENS_CAP, "well": 0.0}
    assert over_cap(g, sens) == ["ill"]
    off_ill = {"ill": torch.full((4,), 1.5), "well": torch.ones(4)}
    off_well = {"ill": torch.ones(4), "well": torch.full((4,), 1.5)}
    with pytest.raises(AssertionError, match="ill-conditioned"):
        compare_steps(_record(g), _record(off_ill), sens, 1e-3)
    report = compare_steps(_record(g), _record(off_ill), sens, 1e-3, exempt=over_cap(g, sens))
    assert report["exempt"] == 1
    with pytest.raises(AssertionError, match="gradient well"):
        compare_steps(_record(g), _record(off_well), sens, 1e-3, exempt=over_cap(g, sens))


def test_more_local_ranks_than_cards_raise(monkeypatch):
    """Under torchrun, "cuda" gives each process the card of its local rank;
    a host with fewer cards than local ranks raises before any group."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1 has no card of its own"):
        mesh.init_distributed("cuda")
