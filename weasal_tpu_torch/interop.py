"""Carry weights from the JAX package's flax variables into the port.

`from_jax_variables` takes the flax `params`, `batch_stats` and
`constants` trees as nested dicts of numpy arrays and returns the port's
`state_dict`. The port names its modules after the flax ones, so the map
is a rename (`encoder_blocks_3/unary1/...` -> `encoder_blocks.3.unary1...`)
plus one layout change: the flax `mlp` kernel [in, out] becomes the
`mlp.weight` [out, in] of the port's Linear.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LIST_TOKEN = re.compile(r"^(encoder_blocks|decoder_blocks)_(\d+)$")


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
            arr = np.asarray(value, dtype=np.float32)
            key = _torch_key(path)
            if collection == "params" and path[-1] == "mlp":
                arr, key = arr.T, key + ".weight"
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
