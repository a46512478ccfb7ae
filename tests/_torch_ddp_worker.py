"""Rank functions of tests/test_torch_parallel.py (not collected: no test_
prefix).

`weasal_tpu_torch.parallel.ddp.spawn` starts each in a fresh process, one
per rank of a gloo group on the CPU. This module imports no JAX, so a
rank starts in the time torch takes to import; each rank keeps torch on
one intra-op thread (`spawn(threads=1)`). Results go to files in the
directory a test gives, one per rank, written with `torch.save`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.batch import PyramidBatch
from weasal_tpu_torch.data.demo import demo_batch
from weasal_tpu_torch.models import architectures, blocks, losses
from weasal_tpu_torch.models.architectures import KPFCNN, KPFCNN_mprm
from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.step import step_on_batch

PL_LABELS, PL_IGNORED = tuple(range(5)) + (10,), (10,)


class TinyConfig(Config):
    """tests/test_parallel.py's TinyConfig (the JAX DP test's model)."""
    dataset = "Vaihingen3DWL"
    num_classes = 5
    in_features_dim = 4
    first_features_dim = 16
    num_kernel_points = 15
    in_radius = 4.0
    first_subsampling_dl = 0.5
    conv_radius = 2.5
    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb",
                    "nearest_upsample", "nearest_upsample"]
    use_batch_norm = True
    batch_norm_momentum = 0.02


class TinyPLConfig(TinyConfig):
    """The same network as a pseudo-label KPFCNN: dropout before the head,
    the cross-entropy and the contrast loss, clipping by value."""
    dataset = "Vaihingen3DPL"
    model_name = "KPFCNN"
    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb", "nearest_upsample",
                    "unary", "nearest_upsample", "unary"]
    dropout = 0.5
    grad_clip_norm = 2e-3
    contrast_thd = 20


def config(mode: str):
    return TinyConfig() if mode == "weak" else TinyPLConfig()


def global_batch(mode: str, batch_size: int = 4) -> PyramidBatch:
    """The demo batch of `batch_size` spheres (the JAX package's
    `demo_batch` makes the same one); in pseudo mode 30 % of the real
    points carry the 'no label' value 10."""
    batch, _plan = demo_batch(TinyConfig(), batch_size=batch_size, seed=0,
                              density=6.0)
    if mode == "pseudo":
        rng = np.random.default_rng(5)
        labels = np.array(batch.labels)
        unlabeled = (rng.random(labels.shape) < 0.3) & batch.masks[0]
        batch.labels = np.where(unlabeled, 10, labels).astype(np.int32)
    return batch


def model_for(mode: str, state_path=None, device="cpu"):
    cfg = config(mode)
    if mode == "weak":
        model = KPFCNN_mprm(cfg, tuple(range(5)), ())
    else:
        model = KPFCNN(cfg, PL_LABELS, PL_IGNORED)
    if state_path:
        model.load_state_dict(torch.load(state_path), strict=True)
    return model.to(device), cfg


def run_step(mode: str, batch: PyramidBatch, state_path=None,
             lr: float = 0.01, seed: int = 7, device="cpu"):
    """One training step of this process (a rank's spheres, or all of
    them alone) on `device`: a dict of the loss, the accuracy, the
    gradients, the state after the update, and in pseudo mode the dropout
    mask and the contrast draw, on the CPU."""
    model, cfg = model_for(mode, state_path, device)
    ddp.broadcast_tensors(list(model.parameters()) + list(model.buffers()))
    opt = init_opt_state(model)
    tb = batch.to(device)
    out = {}
    draws, masks = [], []
    draw, dropout = losses.contrast_draw, architectures.dropout

    def recording_draw(*a, **k):
        idx = draw(*a, **k)
        draws.append(idx.clone())
        return idx

    def recording_dropout(x, rate, seed=None, keep=None):
        keep = blocks.dropout_keep(x.shape, rate, seed)
        masks.append(keep)
        return dropout(x, rate, keep=keep)

    losses.contrast_draw = recording_draw
    architectures.dropout = recording_dropout
    try:
        loss, acc = step_on_batch(model, opt, tb, cfg, lr,
                                  seed=seed, use_contrast=mode == "pseudo")
    finally:
        losses.contrast_draw = draw
        architectures.dropout = dropout
    if masks:
        out["keep"] = masks[0].cpu()
    out.update(loss=loss.cpu(), acc=acc.cpu(),
               grads={n: p.grad.cpu() for n, p in model.named_parameters()},
               state={k: v.cpu() for k, v in model.state_dict().items()},
               momentum={k: v.cpu() for k, v in opt.items()})
    if draws:
        out["draw"] = draws[0].cpu()
    return out


def step_rank(out_dir: str, mode: str, state_path=None) -> None:
    """One rank of the data-parallel step on the global demo batch, on
    the rank's device."""
    ctx = ddp.current()
    batch = PyramidBatch.from_arrays(ddp.shard(global_batch(mode).arrays()))
    out = run_step(mode, batch, state_path, device=ctx.device)
    torch.save(out, os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def vote_rank(out_dir: str) -> None:
    """One rank of the data-parallel vote of
    tests/test_parallel.py:139-181's inputs: each rank smooths the
    gathered probabilities of the global batch into its replicated
    buffers."""
    from types import SimpleNamespace

    from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
    ctx = ddp.current()
    inputs = vote_inputs()
    local = ddp.shard({k: torch.from_numpy(v) for k, v in inputs.items()
                       if k != "res_points"})
    resident = SimpleNamespace(
        arrays={"res_points": torch.from_numpy(inputs["res_points"])},
        sizes=[128, 128], base=np.array([0, 128], np.int64))
    acc = DeviceVoteAccumulator(resident, 5, smooth=0.95, radius_sq=6.0)
    acc.update_gathered(local["probs"], local, d2=local["d2"])
    torch.save(acc.materialize(), os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def vote_inputs():
    """The vote test's seeded arrays (tests/test_parallel.py:149-162)."""
    rng = np.random.default_rng(4)
    S, C, B, n0 = 257, 5, 4, 64
    res_points = rng.normal(size=(S, 3)).astype(np.float32) * 3.0
    probs = rng.random((B, n0, C)).astype(np.float32)
    flat_inds = rng.integers(0, S - 1, size=(B, n0)).astype(np.int32)
    flat_inds[:, -5:] = S - 1
    centers = rng.normal(size=(B, 3)).astype(np.float32)
    d2 = rng.random((B, n0)).astype(np.float32) * 9.0
    return dict(res_points=res_points, probs=probs, flat_inds=flat_inds,
                center_pts=centers, d2=d2)


def gradient_rule_inputs():
    """x [8, 3] (4 rows a rank) and w [3] of the gradient-rule test."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(8, 3, generator=g), torch.randn(3, generator=g)


def gradient_rule_rank(out_dir: str) -> None:
    """The loss mean(tanh(x @ w)) of the global rows from GlobalSum-reduced
    sums: the gradient of w before and after `all_reduce_grads`."""
    ctx = ddp.current()
    x, w = gradient_rule_inputs()
    x = ddp.shard({"x": x})["x"]
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(w.clone())
    loss = ddp.global_sum(torch.tanh(x @ model.w).sum()) / ddp.global_sum(
        torch.tensor(float(x.shape[0])))
    loss.backward()
    raw = model.w.grad.clone()
    ddp.all_reduce_grads(model)
    torch.save({"raw": raw, "averaged": model.w.grad.clone()},
               os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def failing_rank(out_dir: str) -> None:
    """Rank 1 raises; rank 0 waits at a barrier that never completes."""
    ctx = ddp.current()
    if ctx.rank == 1:
        raise RuntimeError("rank 1 fails")
    ddp.barrier()
    open(os.path.join(out_dir, "rank0_passed"), "w").close()
