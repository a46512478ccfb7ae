"""SGD of both training stages, reproducing the JAX package's optax chain.

Counterpart of `make_optimizer` (weasal_tpu/train/trainer.py:88-105) with
the update of :358-361:

    g <- g * (max_norm / |g|) when the global norm |g| >= max_norm
                              (clip "norm", the weak-label stage's
                              optax.clip_by_global_norm: no epsilon, so
                              not torch.nn.utils.clip_grad_norm_)
      or g <- clamp(g, -max_norm, max_norm)
                              (clip "value", the pseudo-label stage's
                              optax.clip, elementwise)
    g <- g + weight_decay * p (optax.add_decayed_weights)
    t <- g + momentum * t     (optax.trace, from zeros)
    u <- t, or u <- deform_lr_factor * t for a parameter whose name holds
                              "offset" (the deform group: optax.masked
                              scale of `_offset_mask`, :74-105; the trace
                              is shared, only the update is scaled)
    u <- -lr * u, p <- p + u  (the trainer's scaling and apply_updates,
                               each rounded as optax rounds it)

The state is one momentum buffer per parameter, keyed by parameter name
(`init_opt_state`; `interop.from_jax_opt_state` fills it from an optax
state).
"""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn


def init_opt_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero momentum buffers, one per parameter, on its device."""
    return {name: torch.zeros_like(p)
            for name, p in model.named_parameters()}


CLIP_MODES = ("norm", "value")


@torch.no_grad()
def sgd_step(model: nn.Module, opt_state: Dict[str, torch.Tensor], config,
             lr: Union[float, torch.Tensor], clip: str = "norm") -> None:
    """Apply one update from the parameters' `.grad` (a missing gradient
    counts as zero, and `.grad` is left as it was); updates the parameters
    and `opt_state` in place. Multi-tensor (`torch._foreach_*`) ops: a
    handful of launches for all parameters instead of several each.

    `lr` is a float or a 0-d f32 tensor on the parameters' device; a CUDA
    graph captures the tensor's address, so the trainer's per-epoch decay
    (`lr_t.fill_`) reaches every later replay. `clip` is "norm" or
    "value" (see the module docstring)."""
    if clip not in CLIP_MODES:
        raise ValueError(f"clip must be one of {CLIP_MODES}, not {clip!r}")
    named = list(model.named_parameters())
    if set(opt_state) != {name for name, _ in named}:
        raise ValueError("opt_state does not hold one buffer per parameter")
    params = [p for _, p in named]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    traces = [opt_state[name] for name, _ in named]
    max_norm = float(config.grad_clip_norm)
    if max_norm > 0 and clip == "value":
        grads = torch._foreach_clamp_max(
            torch._foreach_clamp_min(grads, -max_norm), max_norm)
    elif max_norm > 0:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        grads = torch._foreach_mul(grads, scale)
    if config.weight_decay:
        grads = torch._foreach_add(grads, params,
                                   alpha=float(config.weight_decay))
    torch._foreach_mul_(traces, float(config.momentum))
    torch._foreach_add_(traces, grads)
    updates = list(traces)
    # the deform group: the offset convs' weights and the offset biases
    group = [i for i, (name, _) in enumerate(named) if "offset" in name]
    if group:
        scaled = torch._foreach_mul([traces[i] for i in group],
                                    float(config.deform_lr_factor))
        for i, u in zip(group, scaled):
            updates[i] = u
    torch._foreach_add_(params, torch._foreach_mul(updates, -lr))
