"""Pixel losses for inverse rendering (mirror of
`bevy_raytrace_tpu/inverse/loss.py`).

Gradients flow through the renderer with the counter-based RNG replaying
the same samples under differentiation, smooth transport terms
differentiating through, and the discrete path structure held fixed; the
`edge_softness` term adds the silhouette gradient.
"""

from __future__ import annotations

import torch

from bevy_raytrace_tpu_torch.wavefront.render import render


def image_l2_loss(img, target):
    """Mean squared error over pixels and channels.

    With a stochastic renderer this plain L2 is biased (its expectation adds
    Var[img], whose gradient can dominate at low spp): optimize with
    `render_loss`."""
    diff = img - target
    return torch.mean(diff * diff)


def render_loss(scene, camera, config, target, frame: int = 0,
                render_fn=None):
    """Unbiased pixel L2 via the two-sample cross estimator.

    Renders frames 2*frame and 2*frame + 1 (independent sample sets A and
    B) and returns mean((r_A - t) * (r_B - t)), whose expectation is
    ||E r - t||^2 and whose gradient is the unbiased gradient of it.

    `render_fn(scene, camera, config, frame) -> image` swaps the renderer
    (default: the wavefront `render`); pass the fast path via
    `inverse.fast_grad.make_fast_renderer`."""
    if render_fn is None:
        render_fn = render
    frame_a = 2 * int(frame)
    img_a = render_fn(scene, camera, config, frame_a)
    img_b = render_fn(scene, camera, config, frame_a + 1)
    return torch.mean((img_a - target) * (img_b - target))
