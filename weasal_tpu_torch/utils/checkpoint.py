"""Read a checkpoint of any format the JAX package reads, as the port's
payload.

Counterpart of `load_checkpoint_file` (weasal_tpu/train/trainer.py:50-70).
The payload is the port's: {"epoch", "model_state_dict" (the port's
`state_dict`), "optimizer_state_dict" ({parameter name: momentum buffer},
or None), "saving_path"}. The formats:

- the JAX package's `.tar`: a tar archive of one pickle of numpy trees
  (`ModelTrainer.save_checkpoint`, :535-558), whose optimizer state is an
  optax chain state. It is read by `RestrictedUnpickler`, which admits
  numpy's array reconstruction, builtin containers, flax's `FrozenDict`
  (as a dict) and stand-ins for the optax state classes the chain of
  `make_optimizer` holds, and refuses every other global; neither optax
  nor JAX is imported. The trees go through `interop.from_jax_variables`
  and `from_jax_opt_state`. A bare pickle of the same payload (the JAX
  package's earliest files) is read the same way.
- a `torch.save` file (zip, or the legacy pickle of torch 1.4), read by
  `torch.load(weights_only=True)`: the port's own `ModelTrainer`
  payload as it is, or the reference's (`torch_interop.
  is_reference_payload`), mapped key by key by `torch_interop`; the
  reference's SGD state has no counterpart, so its optimizer state is
  None and a resume restarts momentum at zero, as in the JAX package.
"""

from __future__ import annotations

import importlib
import io
import pickle
import tarfile
from typing import Any, Dict, NamedTuple

import torch

from weasal_tpu_torch.interop import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.utils.torch_interop import (is_reference_payload,
                                                  reference_to_port_state)


class EmptyState(NamedTuple):
    """Stand-in for optax's EmptyState (clip, weight decay, scale)."""


class TraceState(NamedTuple):
    """Stand-in for optax's TraceState: the momentum trace."""
    trace: Any


class MaskedState(NamedTuple):
    """Stand-in for optax's MaskedState (the deform group's scale)."""
    inner_state: Any


class MaskedNode(NamedTuple):
    """Stand-in for optax's MaskedNode (a masked-out leaf)."""


_OPTAX_STATES = {cls.__name__: cls for cls in (EmptyState, TraceState,
                                               MaskedState, MaskedNode)}
# numpy's array reconstruction, under numpy 1's and numpy 2's module names
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct"),
                  ("numpy.core.multiarray", "scalar"),
                  ("numpy._core.multiarray", "scalar")}
_NUMPY_TWINS = {"numpy.core.multiarray": "numpy._core.multiarray",
                "numpy._core.multiarray": "numpy.core.multiarray"}


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler of numpy trees that admits only the globals a JAX
    checkpoint names (see the module docstring); any other raises
    `pickle.UnpicklingError`."""

    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY_GLOBALS:
            try:
                mod = importlib.import_module(module)
            except ImportError:
                mod = importlib.import_module(_NUMPY_TWINS[module])
            return getattr(mod, name)
        if module.split(".")[0] == "optax" and name in _OPTAX_STATES:
            return _OPTAX_STATES[name]
        if module == "flax.core.frozen_dict" and name == "FrozenDict":
            return dict
        raise pickle.UnpicklingError(
            f"a checkpoint may not name the global {module}.{name}")


def restricted_loads(blob: bytes):
    return RestrictedUnpickler(io.BytesIO(blob)).load()


def from_jax_payload(payload) -> Dict:
    """A JAX `ModelTrainer` payload (numpy trees) as the port's."""
    opt = payload.get("optimizer_state_dict")
    return {"epoch": int(payload.get("epoch", 0)),
            "model_state_dict": from_jax_variables(
                payload["model_state_dict"]),
            "optimizer_state_dict": (None if opt is None
                                     else from_jax_opt_state(opt)),
            "saving_path": payload.get("saving_path")}


def load_checkpoint_file(path: str) -> Dict:
    """The port's payload from a checkpoint of any supported format (see
    the module docstring), on the CPU."""
    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tar:
            member = tar.getmembers()[0]
            blob = tar.extractfile(member).read()
        return from_jax_payload(restricted_loads(blob))
    with open(path, "rb") as f:
        head = f.read(2)
    if head not in (b"PK", b"\x80\x02"):
        with open(path, "rb") as f:
            return from_jax_payload(restricted_loads(f.read()))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not is_reference_payload(payload):
        return payload
    return {"epoch": int(payload.get("epoch", 0)),
            "model_state_dict": reference_to_port_state(
                payload["model_state_dict"]),
            "optimizer_state_dict": None,
            "saving_path": payload.get("saving_path")}
