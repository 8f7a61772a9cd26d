"""The `inverse` runner's own pieces: what `validate` refuses, and the
check's plain Adam against torch's."""

import dataclasses

import pytest
import torch

from brtbench import spec

CELL = "rtiow_final_fit.inverse"


def _runner():
    return spec.runner("inverse"), spec.rehearsal("inverse")


def test_mix_with_a_key_the_runner_does_not_read_is_refused():
    runner, helper = _runner()
    cell = helper.tiny_cell(CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, clients=4))
    with pytest.raises(ValueError, match="clients"):
        runner.validate(cell)


@pytest.mark.parametrize("change,match", [
    (lambda c: dict(c, traffic=dict(c["traffic"], optimizable=["radii"])),
     "differentiates"),
    (lambda c: dict(c, traffic=dict(c["traffic"], lr={"centers": 1e-3})),
     "not a number"),
    (lambda c: dict(c, config=dict(c["config"], max_depth=17)), "K3"),
    (lambda c: dict(c, check=dict(c["check"], steps=0)), "no step"),
    (lambda c: dict(c, check=dict(c["check"], limits=dict(
        c["check"]["limits"], grad_max_rel=1e-3))), "limits"),
    (lambda c: dict(c, check=dict(c["check"], pixels=32 * 24 + 1)),
     "more than a frame"),
], ids=["optimizable", "lr", "depth", "steps", "limits", "pixels"])
def test_a_cell_the_inverse_runner_cannot_run_is_refused(change, match):
    runner, helper = _runner()
    cell = helper.tiny_cell(CELL)
    cell = dataclasses.replace(cell, **change(dataclasses.asdict(cell)))
    with pytest.raises(ValueError, match=match):
        runner.validate(cell)


def test_the_checks_adam_is_torchs():
    """The check's plain Adam (float64) from a kept state and step count
    gives torch.optim.Adam's change to float32 rounding, over five steps
    of one group of two parameters."""
    runner, _ = _runner()
    g = torch.Generator().manual_seed(3)
    params = {"centers": torch.randn(7, 3, generator=g),
              "albedo": torch.rand(5, 3, generator=g)}
    lr = 1e-2
    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=runner.BETAS,
                           eps=runner.EPS)
    for t in range(1, 6):
        before = {n: p.detach().clone() for n, p in leaves.items()}
        for n, p in leaves.items():
            st = opt.state[p]
            before[f"exp_avg.{n}"] = (st["exp_avg"].clone() if st
                                      else torch.zeros_like(p))
            before[f"exp_avg_sq.{n}"] = (st["exp_avg_sq"].clone() if st
                                         else torch.zeros_like(p))
        grads = {n: torch.randn(p.shape, generator=g)
                 for n, p in leaves.items()}
        for n, p in leaves.items():
            p.grad = grads[n].clone()
        opt.step()
        after = {n: p.detach().clone() for n, p in leaves.items()}
        change = runner._adam(before, grads, tuple(leaves), lr, t,
                              torch.float64)
        assert runner._update_rel(before, after, change,
                                  tuple(leaves)) < 1e-5
        skipped = runner._update_rel(before, before, change, tuple(leaves))
        assert skipped == pytest.approx(1.0)
