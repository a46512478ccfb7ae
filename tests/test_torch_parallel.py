"""The port's data parallelism (weasal_tpu_torch/parallel/ddp.py) on the
CPU: two gloo ranks against the JAX package's `make_mesh(2)` and against
the port's single-process step.

The ranks run in fresh processes (`ddp.spawn`, the functions of
tests/_torch_ddp_worker.py, which imports no JAX), each on one intra-op
thread, each spawn with its own deadline so that a hung rendezvous fails
in seconds. Inputs are made from seeds in both packages: the demo batch
of tests/test_parallel.py's TinyConfig at 4 spheres, 2 a rank.

Tolerances: the JAX DP test's (tests/test_parallel.py:71-76): loss rtol
1e-5, gradients rtol 2e-4 and atol 2e-5 (the ranks sum their halves
before the ranks' sum, another order than one process's). Bit-equal: the
ranks' parameters and running statistics after the step, the dropout
masks against `jax.random.bernoulli` over the global shape, the contrast
draw against the single-process draw, and the replicated vote buffers
against one process's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weasal_tpu.config import Config as JaxConfig
from weasal_tpu.data.demo import demo_batch as jax_demo_batch
from weasal_tpu.models import losses as jlosses
from weasal_tpu.models.architectures import KPFCNN as JaxKPFCNN
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxKPFCNNmprm
from weasal_tpu.models.architectures import valid_label_mapper as jax_mapper
from weasal_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from weasal_tpu_torch import from_jax_variables
from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.loader import HostPyramidSource
from weasal_tpu_torch.data.synthetic import make_dales_like_root
from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
from tests import _torch_ddp_worker as worker
from tests._warm_torch import cpu_torch
from tests.test_parallel import TinyConfig as JaxTiny
from tests.test_torch_model import _as_dicts

# Seconds a spawn of 2 ranks may take (each starts in ~3 s here)
SPAWN_S = 90.0


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _spawn(fn, world, *args):
    ddp.spawn(fn, world, "cpu", args=args, threads=1, timeout=SPAWN_S)


def _load_ranks(d, world=2):
    # files the ranks of this test wrote
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class JaxTinyPL(JaxConfig):
    dataset = "Vaihingen3DPL"
    model_name = "KPFCNN"
    num_classes = 5
    in_features_dim = 4
    first_features_dim = 16
    num_kernel_points = 15
    in_radius = 4.0
    first_subsampling_dl = 0.5
    conv_radius = 2.5
    architecture = worker.TinyPLConfig.architecture
    use_batch_norm = True
    batch_norm_momentum = 0.02
    dropout = 0.5
    grad_clip_norm = 2e-3
    contrast_thd = 20


def _jax_problem(mode):
    """(JAX model, variables, global JAX batch) of the worker's batch."""
    jcfg = JaxTiny() if mode == "weak" else JaxTinyPL()
    jbatch, _ = jax_demo_batch(JaxTiny(), batch_size=4, seed=0, density=6.0)
    if mode == "weak":
        model = JaxKPFCNNmprm(jcfg, tuple(range(5)), ())
    else:
        model = JaxKPFCNN(jcfg, worker.PL_LABELS, worker.PL_IGNORED)
        jbatch = jbatch.replace(
            labels=jnp.asarray(worker.global_batch("pseudo").labels))
    variables = model.init(jax.random.PRNGKey(0), jbatch, train=False)
    return model, variables, jbatch


def _jax_sharded_grads(mode, model, variables, jbatch, keep=None, slc=None):
    """Loss and gradients of the stage's loss on `jbatch` sharded over
    make_mesh(2) (the JAX trainer's step_core, trainer.py:257-343)."""
    mesh = make_mesh(2)
    table = jnp.asarray(jax_mapper(worker.PL_LABELS, worker.PL_IGNORED))

    def loss_fn(params, batch):
        out, _ = model.apply(
            {"params": params, "constants": variables["constants"],
             "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        if mode == "weak":
            _logits, _cla, cam = out
            return jlosses.region_mprm_loss(
                cam, batch.region_inds, batch.region_masks,
                batch.region_point_masks, batch.region_lb)
        raw = batch.labels
        targets = jnp.where(raw >= 0, table[jnp.clip(raw, 0, None)], -1)
        loss = jlosses.softmax_cross_entropy(out, targets)
        c = out.shape[-1]
        flat = jnp.where(raw.reshape(-1) >= 0, raw.reshape(-1), 5 + 1)
        return loss + jlosses.contrast_loss(
            out.reshape(-1, c), flat, batch.masks[0].reshape(-1), None, 5,
            0.2, slc_idx=jnp.asarray(slc))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    return grad_fn(replicate(variables["params"], mesh),
                   shard_batch(jbatch, mesh))


def _assert_grads(got, want, rtol=2e-4, atol=2e-5):
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=rtol,
                                   atol=atol, err_msg=key)


def _assert_ranks_equal(ranks):
    first = ranks[0]
    for other in ranks[1:]:
        for part in ("grads", "state", "momentum"):
            for key, value in first[part].items():
                assert torch.equal(value, other[part][key]), (part, key)
        assert torch.equal(first["loss"], other["loss"])


@pytest.mark.parametrize("mode", ["weak", "pseudo"])
def test_two_rank_step_matches_jax_mesh_and_one_process(mode, tmp_path,
                                                        monkeypatch):
    jmodel, variables, jbatch = _jax_problem(mode)
    state = from_jax_variables(_as_dicts(variables))
    state_path = str(tmp_path / "state.pt")
    torch.save(state, state_path)
    _spawn(worker.step_rank, 2, str(tmp_path), mode, state_path)
    ranks = _load_ranks(str(tmp_path))
    _assert_ranks_equal(ranks)
    single = worker.run_step(mode, worker.global_batch(mode), state_path)
    got = ranks[0]

    keep = slc = None
    if mode == "pseudo":
        # each rank's mask is its slice of the global batch's, which is
        # jax.random.bernoulli of the step seed over the global shape
        keep = torch.cat([r["keep"] for r in ranks])
        want = jax.random.bernoulli(jax.random.PRNGKey(7), 0.5,
                                    tuple(keep.shape))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
        assert torch.equal(keep, single["keep"])
        for r in ranks:
            assert torch.equal(r["draw"], single["draw"])
        slc = single["draw"].numpy().astype(np.int32)
        from tests.test_torch_pl_model import InjectedDropout
        import flax.linen as fnn
        monkeypatch.setattr(fnn, "Dropout", InjectedDropout)
        monkeypatch.setattr(InjectedDropout, "KEEP", keep.numpy(),
                            raising=False)
    jloss, jgrads = _jax_sharded_grads(mode, jmodel, variables, jbatch,
                                       keep, slc)
    want = from_jax_variables({"params": _np_tree(jgrads)})
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), float(single["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["acc"]), float(single["acc"]),
                               rtol=1e-6)
    _assert_grads(got["grads"], want)
    _assert_grads(got["grads"], single["grads"])


def test_gradient_rule_averages_the_ranks(tmp_path):
    """A loss of GlobalSum-reduced sums gives each rank W times its share
    before the average; after `all_reduce_grads` the gradient is the
    single-process one, not W times it."""
    _spawn(worker.gradient_rule_rank, 2, str(tmp_path))
    ranks = _load_ranks(str(tmp_path))
    x, w = worker.gradient_rule_inputs()
    w = w.clone().requires_grad_(True)
    (torch.tanh(x @ w).sum() / x.shape[0]).backward()
    for r in ranks:
        torch.testing.assert_close(r["averaged"], w.grad, rtol=1e-6,
                                   atol=0)
        assert not torch.allclose(r["averaged"], 2 * w.grad)
    # before the average: each rank's own share, doubled
    shares = [r["raw"] / 2 for r in ranks]
    torch.testing.assert_close(shares[0] + shares[1], w.grad, rtol=1e-6,
                               atol=1e-7)


def test_sharded_votes_equal_unsharded(tmp_path):
    """The counterpart of tests/test_parallel.py:139-181: each rank holds
    the unsharded buffers, bit for bit."""
    _spawn(worker.vote_rank, 2, str(tmp_path))
    inputs = worker.vote_inputs()
    from types import SimpleNamespace
    resident = SimpleNamespace(
        arrays={"res_points": torch.from_numpy(inputs["res_points"])},
        sizes=[128, 128], base=np.array([0, 128], np.int64))
    acc = DeviceVoteAccumulator(resident, 5, smooth=0.95, radius_sq=6.0)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    acc.update(batch["probs"], batch, d2=batch["d2"])
    want = acc.materialize()
    for got in _load_ranks(str(tmp_path)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_failed_rank_fails_the_spawn(tmp_path):
    """A rank that raises ends the other (waiting at a barrier) and the
    spawn raises: no rank trains on alone. The error reported is the
    first rank's to end (rank 1's, or rank 0's broken barrier)."""
    with pytest.raises(Exception, match=r"Process \d terminated"):
        _spawn(worker.failing_rank, 2, str(tmp_path))
    assert not os.path.exists(tmp_path / "rank0_passed")


def test_more_cards_than_exist_raise():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = max(n + 1, 2)
    with pytest.raises(ValueError, match=f"requested {want} .* only {n}"):
        ddp.resolve_world(want, "cuda")
    from weasal_tpu_torch.train_DALES_WeakLabel import run as run_wl
    with pytest.raises(ValueError, match=f"requested {want} .* only {n}"):
        run_wl(["--devices", str(want), "--device", "cuda"])
    assert ddp.resolve_world(0, "cpu") == 1
    assert ddp.resolve_world(3, "cpu") == 3
    with pytest.raises(ValueError, match="-1"):
        ddp.resolve_world(-1, "cpu")


def test_batch_num_rounds_up_and_a_mismatch_raises(monkeypatch):
    cfg = Config()
    cfg.batch_num, cfg.data_parallel_devices = 3, 2
    with pytest.raises(RuntimeError, match="spawn"):
        ddp.round_batch_num(cfg)         # 2 ranks asked for, none here
    monkeypatch.setattr(ddp, "_CONTEXT", ddp.ParallelContext(
        1, 2, "gloo", torch.device("cpu")))
    assert ddp.round_batch_num(cfg) == 2 and cfg.batch_num == 4
    cfg.data_parallel_devices = -1
    assert ddp.round_batch_num(cfg) == 2 and cfg.data_parallel_devices == 2


def test_pyramid_grid_rotations_are_every_draw_of_a_pyramid():
    """A rank that skips a sphere draws `pyramid_grid_rotations` alone:
    the shared rng must then stand where building the pyramid leaves it,
    and the pyramid's grids use those very rotations."""
    from weasal_tpu_torch.data.batching import (build_sphere_pyramid,
                                                pyramid_grid_rotations)
    cfg = Config()
    cfg.num_layers = 4
    pts = np.random.default_rng(5).uniform(0, 4, (600, 3)).astype(
        np.float32)
    built, skipped = np.random.default_rng(8), np.random.default_rng(8)
    pyr = build_sphere_pyramid(pts, cfg, rng=built)
    rotations = pyramid_grid_rotations(skipped, cfg)
    assert len(rotations) == cfg.num_layers - 1
    assert built.random() == skipped.random()
    from weasal_tpu_torch.ops.subsample import grid_subsample
    R = rotations[0]
    level1 = grid_subsample(pts @ R.T, dl=2 * cfg.first_subsampling_dl) @ R
    np.testing.assert_array_equal(pyr["points"][1],
                                  level1.astype(np.float32))


def test_global_sums_alone_are_the_inputs():
    a, b = torch.arange(3.0), torch.ones((2, 2))
    got = ddp.global_sums(a, b)
    assert got[0] is a and got[1] is b


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("threads", [1, 3])
def test_host_pyramid_rank_builds_its_rows_of_the_global_batch(
        tmp_path, monkeypatch, threads, rank):
    """Rank r of 2 builds only its spheres' pyramids; its arrays are rows
    [2r, 2r + 2) of the global batch, its metas the global ones, and the
    shared rng ends where the global batch leaves it."""
    from weasal_tpu_torch.config import DALESWLConfig
    from weasal_tpu_torch.data.datasets import DALESWLDataset
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import quick
    root = make_dales_like_root(str(tmp_path / "DALES"), extent=40.0,
                                density=3.0, seed=9, train_tiles=2,
                                test_tiles=1)
    cfg = DALESWLConfig()
    quick(cfg)
    cfg.batch_num = 4
    cfg.device_pyramid = False

    def source():
        ds = DALESWLDataset(cfg, split="training", data_root=root,
                            rng=np.random.default_rng(0))
        return HostPyramidSource(ds, ds.calibration(), threads)

    full, mine = source(), source()
    rng_full, rng_mine = np.random.default_rng(3), np.random.default_rng(3)
    want, want_metas = full.next_batch(rng_full)
    monkeypatch.setattr(ddp, "_CONTEXT", ddp.ParallelContext(
        rank, 2, "gloo", torch.device("cpu")))
    got, got_metas = mine.next_batch(rng_mine)
    full.close()
    mine.close()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value[2 * rank:2 * rank + 2],
                                      err_msg=key)
    assert [m["cloud_ind"] for m in got_metas] == \
        [m["cloud_ind"] for m in want_metas]
    assert rng_full.random() == rng_mine.random()
    for a, b in zip(full.dataset.potentials, mine.dataset.potentials):
        np.testing.assert_array_equal(a, b)


def test_entry_point_trains_and_votes_on_four_ranks(tmp_path, monkeypatch):
    """`train_DALES_WeakLabel --devices 4 --device cpu --preset quick` with
    one acquisition (as tests/test_parallel.py:84-136 runs the JAX script):
    batch_num 2 rounds up to 4, both iterations train, rank 0 alone
    writes (one row a step, one validation line an epoch), and
    `test_models` reads the log's rank count."""
    from weasal_tpu_torch import test_models
    from weasal_tpu_torch.train_DALES_WeakLabel import run as run_wl
    root = make_dales_like_root(str(tmp_path / "DALES"), extent=40.0,
                                density=3.0, seed=9, train_tiles=2,
                                test_tiles=1)
    monkeypatch.chdir(tmp_path)
    log = os.path.join("results", "WeakLabel", "Log_dp")
    assert run_wl([log, "--data_root", root, "--preset", "quick",
                   "--device", "cpu", "--devices", "4", "--al_iterations",
                   "1", "--epoch_steps", "2", "--validation_size", "1",
                   "--al_votes", "0"]) is None
    with open(os.path.join(log, "parameters.txt")) as f:
        params = f.read()
    assert "batch_num = 4\n" in params
    assert "data_parallel_devices = 4\n" in params
    for it in (0, 1):
        with open(os.path.join(log, f"training_iteration{it}.txt")) as f:
            rows = f.read().splitlines()[1:]
        assert 1 <= len(rows) <= 2          # no rank's rows twice
        assert [int(r.split()[1]) for r in rows] == list(range(len(rows)))
    with open(os.path.join(log, "val_IoUs.txt")) as f:
        assert len(f.read().splitlines()) == 2
    with open(os.path.join(log, "plan_saturation.txt")) as f:
        assert len(f.read().splitlines()) == 2
    assert sorted(os.listdir(log)) == [
        "checkpoints", "parameters.txt", "plan_saturation.txt",
        "potentials", "training_iteration0.txt", "training_iteration1.txt",
        "val_IoUs.txt"]
    assert not [f for f in os.listdir(tmp_path)
                if re.match(r"rank\d", f)]

    calls = []
    monkeypatch.setattr(ddp, "spawn",
                        lambda fn, world, device, args: calls.append(
                            (world, str(device))))
    assert test_models.main(["--log", log, "--on", "validation",
                             "--data_root", root, "--device", "cpu"]) is None
    assert calls == [(4, "cpu")]
