"""Gradient-based scene recovery with checkpoint/resume (mirror of
`bevy_raytrace_tpu/inverse/optimize.py`).

`optimize` recovers selected scene parameters (sphere centers/radii,
material albedo/fuzz/ior) from a target image by Adam on `render_loss`,
drawing fresh Monte-Carlo samples every step (frame == step).

Adam is `torch.optim.Adam` at optax.adam's defaults (b1 0.9, b2 0.999,
eps 1e-8); parameters are leaf tensors on the scene's device.  The
checkpoint is an .npz of plain arrays keyed by parameter name: the step,
the parameters and Adam's exp_avg, exp_avg_sq and step.  Divergence from the
reference: its checkpoint pickles a JAX treedef (which needs JAX to load)
and its `optimizer=` takes any optax transformation; here the optimizer is
Adam and nothing is pickled.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.types import Scene
from bevy_raytrace_tpu_torch.inverse.loss import render_loss

# Leaves of Scene that may be optimized, addressed by short name.
_SCENE_LEAVES = {
    "centers": lambda s: s.centers,
    "radii": lambda s: s.radii,
    "albedo": lambda s: s.materials.albedo,
    "fuzz": lambda s: s.materials.fuzz,
    "ior": lambda s: s.materials.ior,
}
_ADAM_STATE = ("exp_avg", "exp_avg_sq", "step")


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
    """Write step, parameters and Adam state to an .npz of plain arrays.

    params: {name: tensor}; opt_state: {name: {"exp_avg", "exp_avg_sq",
    "step"}}, the per-parameter state of torch.optim.Adam."""
    arrays = {"step": np.asarray(step, np.int64)}
    for name, p in params.items():
        arrays[f"param.{name}"] = p.detach().cpu().numpy()
        for key in _ADAM_STATE:
            v = opt_state[name][key]
            arrays[f"{key}.{name}"] = (v.detach().cpu().numpy()
                                       if isinstance(v, torch.Tensor)
                                       else np.asarray(v, np.float32))
    np.savez(path, **arrays)


def load_checkpoint(path: str, device="cpu"):
    """Read a `save_checkpoint` file -> (step, params, opt_state)."""
    with np.load(path, allow_pickle=False) as z:
        step = int(z["step"])
        names = [k.split(".", 1)[1] for k in z.files if k.startswith("param.")]
        params = {n: torch.from_numpy(z[f"param.{n}"]).to(device)
                  for n in names}
        opt_state = {n: {key: torch.from_numpy(z[f"{key}.{n}"])
                         for key in _ADAM_STATE} for n in names}
    for st in opt_state.values():
        st["exp_avg"] = st["exp_avg"].to(device)
        st["exp_avg_sq"] = st["exp_avg_sq"].to(device)
    return step, params, opt_state


def optimize(scene: Scene, problem: InverseProblem, steps: int = 200,
             learning_rate: float = 1e-2,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 50,
             callback: Optional[Callable[[int, float], None]] = None
             ) -> OptResult:
    """Run Adam on the selected scene parameters.

    Resumes from `checkpoint_path` if it exists.  Returns the optimized
    scene and the loss history of the steps run in this call."""
    names = list(problem.optimizable)
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in _get_scene_params(scene, names).items()}
    opt = torch.optim.Adam([params[n] for n in names], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    step_done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        step_done, saved, saved_state = load_checkpoint(checkpoint_path,
                                                        scene.device)
        with torch.no_grad():
            for n in names:
                params[n].copy_(saved[n])
        state = opt.state_dict()
        state["state"] = {i: dict(saved_state[n]) for i, n in enumerate(names)}
        opt.load_state_dict(state)

    losses: List[float] = []
    for step in range(step_done, steps):
        opt.zero_grad(set_to_none=True)
        loss = problem.loss_fn(params, scene, step)  # frame == step
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        step_done = step + 1
        if callback:
            callback(step, losses[-1])
        if checkpoint_path and step_done % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, step_done, params,
                            {n: opt.state[params[n]] for n in names})

    final = {n: p.detach() for n, p in params.items()}
    return OptResult(scene=_set_scene_params(scene, final), losses=losses,
                     step=step_done)
