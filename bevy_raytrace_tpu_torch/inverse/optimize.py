"""Gradient-based scene recovery with checkpoint/resume (mirror of
`bevy_raytrace_tpu/inverse/optimize.py`).

`optimize` recovers selected scene parameters (sphere centers/radii,
material albedo/fuzz/ior) from a target image by gradient descent on
`render_loss`, drawing fresh Monte-Carlo samples every step (frame == step).

The optimizer is Adam (`torch.optim.Adam` at optax.adam's defaults: b1 0.9,
b2 0.999, eps 1e-8: `ADAM_BETAS`, `ADAM_EPS`) unless `optimizer=` gives
another; parameters are leaf tensors on the scene's device
(`leaf_params`).  One step of the loop is `optimize_step`, which a caller
that times or drives steps one at a time calls as `optimize` does; the
span `inverse.update` covers its optimizer update and the counter
`inverse.steps` counts its steps (`utils/spans.py`).  The checkpoint is an
.npz of plain arrays keyed by parameter name: the step, the parameters,
and every tensor or number of each parameter's optimizer state as
`<state key>.<name>` (Adam's: exp_avg, exp_avg_sq and step).
Divergences from the reference: its checkpoint pickles a JAX treedef
(which needs JAX to load), here nothing is pickled; its `optimizer=` is an
optax transformation, here it is a factory `params ->
torch.optim.Optimizer`, since a torch optimizer binds to its parameters.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.types import Scene
from bevy_raytrace_tpu_torch.device import resolve
from bevy_raytrace_tpu_torch.inverse.loss import render_loss
from bevy_raytrace_tpu_torch.utils.spans import count, span

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

# Leaves of Scene that may be optimized, addressed by short name.
_SCENE_LEAVES = {
    "centers": lambda s: s.centers,
    "radii": lambda s: s.radii,
    "albedo": lambda s: s.materials.albedo,
    "fuzz": lambda s: s.materials.fuzz,
    "ior": lambda s: s.materials.ior,
}


def _set_scene_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    mats = dataclasses.replace(
        scene.materials,
        albedo=params.get("albedo", scene.materials.albedo),
        fuzz=params.get("fuzz", scene.materials.fuzz),
        ior=params.get("ior", scene.materials.ior),
    )
    return dataclasses.replace(
        scene,
        centers=params.get("centers", scene.centers),
        radii=params.get("radii", scene.radii),
        materials=mats,
    )


def _get_scene_params(scene: Scene,
                      names: Sequence[str]) -> Dict[str, torch.Tensor]:
    return {n: _SCENE_LEAVES[n](scene) for n in names}


def leaf_params(scene: Scene,
                names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Copies of the scene's parameters `names` as leaf tensors that
    require grad: what `optimize` optimizes."""
    return {n: p.detach().clone().requires_grad_(True)
            for n, p in _get_scene_params(scene, names).items()}


def adam(learning_rate: float = 1e-2):
    """`optimize`'s default optimizer factory: Adam at `learning_rate`,
    `ADAM_BETAS` and `ADAM_EPS`."""
    return lambda ps: torch.optim.Adam(ps, lr=learning_rate,
                                       betas=ADAM_BETAS, eps=ADAM_EPS)


@dataclasses.dataclass
class InverseProblem:
    """An inverse-rendering problem.

    `render_fn(scene, camera, config, frame) -> image` selects the renderer
    the loss differentiates through: None = the wavefront `render`;
    `inverse.fast_grad.make_fast_renderer` gives the K2 forward + replay
    backward fast path."""

    config: RenderConfig
    camera: object
    target: torch.Tensor  # [H, W, 3]
    optimizable: Tuple[str, ...] = ("centers", "radii", "albedo")
    render_fn: Optional[Callable] = None

    def loss_fn(self, params, scene, frame):
        return render_loss(_set_scene_params(scene, params), self.camera,
                           self.config, self.target, frame,
                           render_fn=self.render_fn)


@dataclasses.dataclass
class OptResult:
    scene: Scene
    losses: List[float]
    step: int


def save_checkpoint(path: str, step: int, params, opt_state) -> None:
    """Write step, parameters and optimizer state to an .npz of plain arrays.

    params: {name: tensor}; opt_state: {name: {key: tensor or number}}, the
    per-parameter state of a torch optimizer (`opt.state[p]`).  An entry
    that is None (SGD's momentum_buffer at momentum 0) is not stored."""
    arrays = {"step": np.asarray(step, np.int64)}
    for name, p in params.items():
        arrays[f"param.{name}"] = p.detach().cpu().numpy()
        for key, v in opt_state[name].items():
            if v is None:
                continue
            if isinstance(v, torch.Tensor):
                arrays[f"{key}.{name}"] = v.detach().cpu().numpy()
            elif isinstance(v, (int, float)):
                arrays[f"{key}.{name}"] = np.asarray(v)
            else:
                raise TypeError(f"optimizer state {key!r} of {name!r} is a "
                                f"{type(v).__name__}, not a tensor or number")
    np.savez(path, **arrays)


def load_checkpoint(path: str, device=None):
    """Read a `save_checkpoint` file -> (step, params, opt_state) on
    `device` (None: the default device).  opt_state holds every state key
    the file has, as tensors; 0-d ones (step counters) stay on the CPU, as
    torch's optimizers keep them."""
    device = resolve(device)
    with np.load(path, allow_pickle=False) as z:
        step = int(z["step"])
        names = [k.split(".", 1)[1] for k in z.files if k.startswith("param.")]
        params = {n: torch.from_numpy(z[f"param.{n}"]).to(device)
                  for n in names}
        opt_state = {n: {} for n in names}
        for k in z.files:
            if "." not in k or k.startswith("param."):
                continue
            key, name = k.rsplit(".", 1)
            v = torch.from_numpy(z[k])
            opt_state[name][key] = v if v.dim() == 0 else v.to(device)
    return step, params, opt_state


def _state_keys(make_opt, params: List[torch.Tensor]):
    """The state keys `make_opt`'s optimizer keeps per parameter, None
    entries left out: one step of a fresh optimizer on zero-gradient
    copies of `params`."""
    probe = [torch.zeros_like(p).requires_grad_(True) for p in params]
    opt = make_opt(probe)
    for p in probe:
        p.grad = torch.zeros_like(p)
    opt.step()
    return [{k for k, v in opt.state[p].items() if v is not None}
            for p in probe]


def optimize_step(problem: InverseProblem, scene: Scene,
                  params: Dict[str, torch.Tensor], opt, step: int
                  ) -> torch.Tensor:
    """One step of `optimize`: the loss at `step` (frame == step), its
    backward, one update of `opt` over `params`.  Returns the loss,
    detached, on its device (no wait for the device)."""
    opt.zero_grad(set_to_none=True)
    loss = problem.loss_fn(params, scene, step)
    loss.backward()
    with span("inverse.update"):
        opt.step()
    count("inverse.steps")
    return loss.detach()


def optimize(scene: Scene, problem: InverseProblem, steps: int = 200,
             learning_rate: float = 1e-2,
             optimizer: Optional[Callable[[List[torch.Tensor]],
                                          torch.optim.Optimizer]] = None,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 50,
             callback: Optional[Callable[[int, float], None]] = None
             ) -> OptResult:
    """Run `optimizer` (Adam at `learning_rate` when None) on the selected
    scene parameters.

    `optimizer(params) -> torch.optim.Optimizer` builds the optimizer over
    the list of parameter tensors; `learning_rate` is then not used.
    Resumes from `checkpoint_path` if it exists; a checkpoint whose state
    keys are not the ones this optimizer keeps raises ValueError.  Returns
    the optimized scene and the loss history of the steps run in this
    call."""
    names = list(problem.optimizable)
    params = leaf_params(scene, names)
    make_opt = optimizer or adam(learning_rate)
    opt = make_opt([params[n] for n in names])
    step_done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        step_done, saved, saved_state = load_checkpoint(checkpoint_path,
                                                        scene.device)
        want = _state_keys(make_opt, [params[n] for n in names])
        for n, keys in zip(names, want):
            got = set(saved_state[n])
            for key in sorted(keys - got) + sorted(got - keys):
                raise ValueError(
                    f"checkpoint {checkpoint_path} "
                    f"{'lacks' if key in keys else 'has'} optimizer state "
                    f"{key!r} of {n!r}: it holds {sorted(got)}, this "
                    f"optimizer keeps {sorted(keys)}")
        with torch.no_grad():
            for n in names:
                params[n].copy_(saved[n])
        state = opt.state_dict()
        state["state"] = {i: dict(saved_state[n]) for i, n in enumerate(names)}
        opt.load_state_dict(state)

    losses: List[float] = []
    for step in range(step_done, steps):
        losses.append(float(optimize_step(problem, scene, params, opt, step)))
        step_done = step + 1
        if callback:
            callback(step, losses[-1])
        if checkpoint_path and step_done % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, step_done, params,
                            {n: opt.state[params[n]] for n in names})

    final = {n: p.detach() for n, p in params.items()}
    return OptResult(scene=_set_scene_params(scene, final), losses=losses,
                     step=step_done)
