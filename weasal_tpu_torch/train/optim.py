"""SGD of the weak-label stage, reproducing the JAX package's optax chain.

Counterpart of `make_optimizer` (weasal_tpu/train/trainer.py:88-105) in
weak mode with the update of :358-361:

    g <- g * (max_norm / |g|) when the global norm |g| >= max_norm
                              (optax.clip_by_global_norm: no epsilon, so
                              not torch.nn.utils.clip_grad_norm_)
    g <- g + weight_decay * p (optax.add_decayed_weights)
    t <- g + momentum * t     (optax.trace, from zeros)
    u <- -lr * t, p <- p + u  (the trainer's scaling and apply_updates,
                               each rounded as optax rounds it)

The state is one momentum buffer per parameter, keyed by parameter name
(`init_opt_state`; `interop.from_jax_opt_state` fills it from an optax
state). Deformable offsets, which train at lr * deform_lr_factor on the
JAX path, are not ported and raise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch
from torch import nn


def _named_params(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    named = list(model.named_parameters())
    for name, _ in named:
        if "offset" in name:
            raise NotImplementedError(
                f"deformable offset parameter {name!r}: the deform_lr_factor "
                "group is not ported")
    return named


def init_opt_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Zero momentum buffers, one per parameter, on its device."""
    return {name: torch.zeros_like(p) for name, p in _named_params(model)}


@torch.no_grad()
def sgd_step(model: nn.Module, opt_state: Dict[str, torch.Tensor], config,
             lr: Union[float, torch.Tensor]) -> None:
    """Apply one update from the parameters' `.grad` (a missing gradient
    counts as zero, and `.grad` is left as it was); updates the parameters
    and `opt_state` in place. Multi-tensor (`torch._foreach_*`) ops: a
    handful of launches for all parameters instead of several each.

    `lr` is a float or a 0-d f32 tensor on the parameters' device; a CUDA
    graph captures the tensor's address, so the trainer's per-epoch decay
    (`lr_t.fill_`) reaches every later replay."""
    named = _named_params(model)
    if set(opt_state) != {name for name, _ in named}:
        raise ValueError("opt_state does not hold one buffer per parameter")
    params = [p for _, p in named]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    traces = [opt_state[name] for name, _ in named]
    max_norm = float(config.grad_clip_norm)
    if max_norm > 0:
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
    torch._foreach_add_(params, torch._foreach_mul(traces, -lr))
