"""The reference implementation's torch checkpoints, both ways.

The port's own copy of weasal_tpu/utils/torch_interop.py:37-290, mapped
straight between the reference's `net.state_dict()` keys and the port's
`state_dict` (no flax tree between them). The reference names its
modules as the port does (`encoder_blocks.3.unary1.mlp.weight`,
`...KPConv.weights`, `...KPConv.kernel_points`, `...gamma`,
`...KPConv.offset_conv.*`, `...KPConv.offset_bias`), so most keys carry
over as they are:

    reference key                                   port key
    ----------------------------------------------- -------------------------
    ....mlp.weight  [out, in]                       ....mlp.weight  [out, in]
    ....batch_norm.batch_norm.weight / .bias        ....batch_norm.scale / .bias
    ....batch_norm.batch_norm.running_mean / _var   ....batch_norm.mean / .var
    ....batch_norm.bias            (use_bn=False)   ....batch_norm.bias
    ....KPConv.weights / kernel_points, gamma,      as they are (offset_conv.*
    ....KPConv.offset_bias                          follows the same rules)
    criterion.*, criterion_multi.*, l1.*,           skipped on load
    *num_batches_tracked

The JAX package transposes `mlp.weight` into flax's [in, out] kernel and
`interop.from_jax_variables` transposes it back: between two torch
layouts the two transposes cancel. The BatchNorm wrappers are
`batch_norm` and `batch_norm_conv` (the reference's BatchNormBlock holds
an `nn.BatchNorm1d` named `batch_norm`, hence the doubled level).

Loading is strict: a key that no rule maps raises, and the caller's
`load_state_dict(strict=True)` raises for a parameter left unfilled.
`save_reference_checkpoint` writes what the reference's strict restore
reads (utils/trainer_WeakLabel.py:100-112 there): the state dict with
`num_batches_tracked`, the loss modules' `criterion.weight` (and
`criterion_multi.weight` for the mprm nets) and the two SGD parameter
groups of its trainer, the offset parameters at lr * deform_lr_factor.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

BN_WRAPPERS = ("batch_norm", "batch_norm_conv")
_SKIPPED_ROOTS = ("criterion", "criterion_multi", "l1")
_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}
_AS_THEY_ARE = ("weights", "kernel_points", "gamma", "offset_bias")
_BUFFER_LEAVES = ("running_mean", "running_var", "num_batches_tracked")


def classify_torch_key(key: str) -> Optional[str]:
    """The port key of a reference state-dict key, or None for a key with
    no counterpart (the loss modules' buffers, `num_batches_tracked`);
    raises for a key that no rule maps."""
    tokens = key.split(".")
    leaf = tokens[-1]
    if tokens[0] in _SKIPPED_ROOTS or leaf == "num_batches_tracked":
        return None
    if leaf == "weight" and len(tokens) >= 2 and tokens[-2] == "mlp":
        return key
    if (len(tokens) >= 3 and tokens[-2] == "batch_norm"
            and tokens[-3] in BN_WRAPPERS and leaf in _BN_LEAVES):
        return ".".join(tokens[:-2] + [_BN_LEAVES[leaf]])
    if leaf == "bias" and len(tokens) >= 2 and tokens[-2] in BN_WRAPPERS:
        return key
    if leaf in _AS_THEY_ARE:
        return key
    raise ValueError(f"Unrecognized reference state-dict key: {key}")


def reference_to_port_state(state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """A reference `net.state_dict()` as the port's `state_dict` (f32
    CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        port_key = classify_torch_key(key)
        if port_key is None:
            continue
        if port_key in out:
            raise ValueError(f"two reference keys map to {port_key}")
        out[port_key] = value.detach().to("cpu", torch.float32).contiguous()
    return out


def port_to_reference_state(state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The port's `state_dict` in the reference's keys, with the
    `num_batches_tracked` buffer (int64 0) beside each pair of running
    statistics; raises for a key that no rule maps."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        tokens = key.split(".")
        leaf, parent = tokens[-1], tokens[-2] if len(tokens) > 1 else ""
        value = value.detach().to("cpu").contiguous()
        if parent in BN_WRAPPERS and leaf in ("scale", "bias", "mean",
                                               "var"):
            base = ".".join(tokens[:-1])
            if leaf == "bias" and base + ".scale" not in state_dict:
                out[key] = value          # use_bn=False: the bias alone
                continue
            torch_leaf = {v: k for k, v in _BN_LEAVES.items()}[leaf]
            out[f"{base}.batch_norm.{torch_leaf}"] = value
            if leaf == "mean":
                out[f"{base}.batch_norm.num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.int64)
        elif (leaf == "weight" and parent == "mlp") or leaf in _AS_THEY_ARE:
            out[key] = value
        else:
            raise ValueError(f"port state-dict key {key} has no reference "
                             "counterpart")
    return out


def is_reference_payload(payload: Mapping) -> bool:
    """Whether a torch checkpoint payload is the reference's (its SGD
    state's param_groups, or reference-only keys in its state dict)
    rather than the port's own `ModelTrainer` payload."""
    opt = payload.get("optimizer_state_dict")
    if isinstance(opt, Mapping) and "param_groups" in opt:
        return True
    return any(k.split(".")[0] in _SKIPPED_ROOTS
               or k.endswith(_BUFFER_LEAVES)
               for k in payload.get("model_state_dict", {}))


def save_reference_checkpoint(path: str,
                              state_dict: Mapping[str, torch.Tensor],
                              epoch: int = 0,
                              saving_path: Optional[str] = None,
                              config=None,
                              class_weights: Optional[Sequence[float]] = None,
                              model_name: str = "KPFCNN_mprm") -> None:
    """Write a reference-format `torch.save` checkpoint of a port
    `state_dict` (weasal_tpu/utils/torch_interop.py:196-270).

    :param config: fills the SGD groups' hyper-parameters (learning_rate,
        momentum, weight_decay, deform_lr_factor; the JAX package's
        defaults where it is None)
    :param class_weights: the loss modules' `criterion.weight` (and
        `criterion_multi.weight` for the mprm nets), which the reference
        registers when built with class weights
    """
    sd = port_to_reference_state(state_dict)
    if class_weights is not None:
        w = torch.tensor([float(v) for v in class_weights],
                         dtype=torch.float32)
        sd["criterion.weight"] = w
        if "mprm" in model_name:
            sd["criterion_multi.weight"] = w.clone()
    # The reference trainer's two groups (trainer_WeakLabel.py:80-87):
    # group 0 the other parameters, group 1 the offsets; ids enumerate
    # group 0 then group 1, and the momentum state starts empty
    param_keys = [k for k in sd if not k.endswith(_BUFFER_LEAVES)
                  and k.split(".")[0] not in _SKIPPED_ROOTS]
    n_offset = sum("offset" in k for k in param_keys)
    n_other = len(param_keys) - n_offset
    lr = float(getattr(config, "learning_rate", 0.01) or 0.01)
    hyper = dict(momentum=float(getattr(config, "momentum", 0.98) or 0.98),
                 dampening=0, nesterov=False, maximize=False,
                 weight_decay=float(getattr(config, "weight_decay", 0.001)
                                    or 0.0),
                 foreach=None, differentiable=False, fused=None)
    factor = float(getattr(config, "deform_lr_factor", 0.1) or 0.1)
    optimizer_state = {"state": {}, "param_groups": [
        dict(hyper, lr=lr, params=list(range(n_other))),
        dict(hyper, lr=lr * factor,
             params=list(range(n_other, n_other + n_offset)))]}
    torch.save({"epoch": int(epoch), "model_state_dict": sd,
                "optimizer_state_dict": optimizer_state,
                "saving_path": saving_path}, path)
