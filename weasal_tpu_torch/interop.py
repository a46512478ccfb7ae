"""Carry weights from the JAX package's flax variables into the port.

`from_jax_variables` takes the flax `params`, `batch_stats` and
`constants` trees as nested dicts of numpy arrays and returns the port's
`state_dict`. The port names its modules after the flax ones, so the map
is a rename (`encoder_blocks_3/unary1/...` -> `encoder_blocks.3.unary1...`;
KPCNN's `block_ops_i` likewise)
plus one layout change: the flax `mlp` kernel [in, out] becomes the
`mlp.weight` [out, in] of the port's Linear. `from_jax_opt_state` maps an
optax momentum trace the same way onto the port's optimizer state
(train/optim.py).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LIST_TOKEN = re.compile(
    r"^(encoder_blocks|decoder_blocks|block_ops)_(\d+)$")


def _torch_key(path) -> str:
    tokens = []
    for p in path:
        m = _LIST_TOKEN.match(p)
        tokens.extend(m.groups() if m else (p,))
    return ".".join(tokens)


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def from_jax_variables(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """flax {'params', 'batch_stats', 'constants'} -> port state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats", "constants"):
        for path, value in _walk(variables_np.get(collection) or {}):
            arr = np.array(value, dtype=np.float32)
            key = _torch_key(path)
            if collection == "params" and path[-1] == "mlp":
                arr, key = arr.T, key + ".weight"
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def from_jax_opt_state(opt_state_np) -> Dict[str, torch.Tensor]:
    """The momentum trace of the JAX package's optimizer state, as the
    port's `opt_state` ({parameter name: buffer}).

    :param opt_state_np: the optax chain state of `make_optimizer`
        (weasal_tpu/train/trainer.py:88) with its leaves as numpy arrays;
        it holds one `TraceState`
    """
    found = [s.trace for s in opt_state_np if hasattr(s, "trace")]
    if len(found) != 1:
        raise ValueError("expected an optax chain state with one TraceState")
    return from_jax_variables({"params": found[0]})
