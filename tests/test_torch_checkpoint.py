"""Checkpoints across packages: the JAX package's `.tar`, the reference's
torch format (zip and the legacy pickle) and the port's export, on the
CPU.

The network is tests/test_deformable.py's `DeformConfig` (its offset
convs and offset biases, and an optax chain with the deform group's
masked state), with the randomized weights of
tests/test_torch_deformable.py; the JAX side takes one step first, so the
momentum it saves is not zero. Files are written by the JAX package's own
code: `ModelTrainer.save_checkpoint` (weasal_tpu/train/trainer.py:
535-558, called on a stand-in `self` that holds its state, since a whole
trainer costs a compile of its loop) and `save_torch_checkpoint`; the
port reads them with `load_checkpoint_file` and restores them with
`ModelTrainer.load_checkpoint` (on a stand-in `self` holding the model
and momentum). Tolerances, f32: eval outputs rtol 1e-4, atol 1e-4, as
tests/test_torch_model.py; one step after resume as
tests/test_torch_deformable.py's step (loss rtol 1e-5, gradients and
momentum rtol 1e-3, atol 1e-5 x the largest |gradient|, parameters rtol
1e-3, atol 1e-5 x max |value|); a round trip port -> reference -> port
and the legacy format bit for bit.
"""

import io
import os
import pickle
import tarfile
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from weasal_tpu.models import losses as jlosses
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu.train.trainer import TrainState, make_optimizer
from weasal_tpu.train.trainer import load_checkpoint_file as jax_load
from weasal_tpu.utils.torch_interop import save_torch_checkpoint
from weasal_tpu_torch import (KPFCNN_mprm, from_jax_opt_state,
                              from_jax_variables, init_opt_state)
from weasal_tpu_torch.export_torch_checkpoint import main as export_main
from weasal_tpu_torch.train.step import step_on_batch
from weasal_tpu_torch.train.trainer import ModelTrainer
from weasal_tpu_torch.utils.checkpoint import load_checkpoint_file
from weasal_tpu_torch.utils.torch_interop import (classify_torch_key,
                                                  port_to_reference_state,
                                                  reference_to_port_state,
                                                  save_reference_checkpoint)
from tests._warm_torch import cpu_torch
from tests.test_torch_deformable import PortDeformConfig, setup  # noqa: F401
from tests.test_torch_train import _assert_close, _np_tree

CLASS_W = [0.7, 1.3, 1.0, 0.9, 1.6]


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _jax_step_fn(setup, tx):
    """One JAX weak-label step with the regularizer (the weak branch of
    step_core, weasal_tpu/train/trainer.py:257-365)."""
    jcfg, jbatch, jmodel = setup["jcfg"], setup["jbatch"], setup["jmodel"]
    constants = jax.tree_util.tree_map(jnp.asarray,
                                       setup["variables"]["constants"])

    @jax.jit
    def step(params, batch_stats, opt_state):
        def loss_fn(p):
            (_l, _c, cam), mutated = jmodel.apply(
                {"params": p, "batch_stats": batch_stats,
                 "constants": constants}, jbatch, train=True,
                mutable=["batch_stats", "deform"])
            out_loss = jlosses.region_mprm_loss(
                cam, jbatch.region_inds, jbatch.region_masks,
                jbatch.region_point_masks, jbatch.region_lb)
            reg = jlosses.p2p_fitting_regularizer(
                mutated["deform"], jcfg.repulse_extent,
                jcfg.deform_fitting_power)
            return out_loss + reg, (mutated["batch_stats"], out_loss)

        grads, (new_bs, loss) = jax.grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(
            lambda u: -jcfg.learning_rate * u, updates)
        return (optax.apply_updates(params, updates), new_bs, new_opt,
                loss, grads)

    return step


@pytest.fixture(scope="module")
def saved(setup, tmp_path_factory):  # noqa: F811
    """One JAX step from the randomized state, then that state saved by
    the JAX package as its `.tar` and as a reference torch file."""
    wd = tmp_path_factory.mktemp("chkp")
    v = jax.tree_util.tree_map(jnp.asarray, setup["variables"])
    tx = make_optimizer(setup["jcfg"], v["params"])
    step = _jax_step_fn(setup, tx)
    params, bstats, opt, _, _ = step(v["params"], v["batch_stats"],
                                     tx.init(v["params"]))
    state = TrainState(params=params, batch_stats=bstats,
                       constants=v["constants"], opt_state=opt)
    JaxTrainer.save_checkpoint(
        SimpleNamespace(epoch=3, state=state,
                        config=SimpleNamespace(saving_path="Log_jax")),
        str(wd), "jax_chkp.tar")
    model_state = {"params": params, "batch_stats": bstats,
                   "constants": v["constants"]}
    save_torch_checkpoint(str(wd / "ref_chkp.tar"),
                          jax.device_get(model_state), epoch=4,
                          saving_path="Log_ref", config=setup["jcfg"],
                          class_weights=CLASS_W, model_name="KPFCNN_mprm")
    return dict(wd=wd, tx=tx, step=step, state=state,
                jax_tar=str(wd / "jax_chkp.tar"),
                ref=str(wd / "ref_chkp.tar"))


def _jax_eval(setup, params, batch_stats):
    v = {"params": params, "batch_stats": batch_stats,
         "constants": jax.tree_util.tree_map(
             jnp.asarray, setup["variables"]["constants"])}
    return jax.jit(lambda v, b: setup["jmodel"].apply(v, b, train=False))(
        v, setup["jbatch"])


def _port_eval(model, setup):
    model.eval()
    with torch.no_grad():
        return model(setup["batch"])


def _assert_eval_close(got, want, setup):
    mask0 = np.asarray(setup["jbatch"].masks[0])
    np.testing.assert_allclose(got[0].numpy()[mask0],
                               np.asarray(want[0])[mask0],
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _restore(path, finetune=False):
    """`ModelTrainer.load_checkpoint` on a stand-in trainer holding a
    fresh model and its momentum (non-zero, so a reset shows)."""
    model = KPFCNN_mprm(PortDeformConfig(), tuple(range(5)), ())
    opt = init_opt_state(model)
    for v in opt.values():
        v.fill_(0.5)
    self = SimpleNamespace(model=model, opt_state=opt, epoch=0)
    ModelTrainer.load_checkpoint(self, path, finetune=finetune)
    return self


def test_jax_tar_loads_evaluates_and_resumes_as_in_jax(setup, saved):  # noqa: F811,E501
    payload = load_checkpoint_file(saved["jax_tar"])
    assert payload["epoch"] == 3 and payload["saving_path"] == "Log_jax"
    state = saved["state"]
    # momentum restored in place: same tensors, JAX's trace
    restored = _restore(saved["jax_tar"])
    buffers = dict(restored.opt_state)
    assert restored.epoch == 3
    want_trace = from_jax_opt_state(_np_tree(state.opt_state))
    for key, ref in want_trace.items():
        assert torch.equal(restored.opt_state[key], ref), key
        assert restored.opt_state[key] is buffers[key]
    # eval equals JAX eval of the same state
    _assert_eval_close(_port_eval(restored.model, setup),
                       _jax_eval(setup, state.params, state.batch_stats),
                       setup)
    # one step after resume, both packages
    params, bstats, opt, jloss, grads = saved["step"](
        state.params, state.batch_stats, state.opt_state)
    loss, _acc = step_on_batch(restored.model, restored.opt_state,
                               setup["batch"], PortDeformConfig(),
                               setup["jcfg"].learning_rate)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    gmax = max(float(jnp.abs(g).max())
               for g in jax.tree_util.tree_leaves(grads))
    _assert_close({n: p.grad for n, p in
                   restored.model.named_parameters()},
                  from_jax_variables({"params": _np_tree(grads)}),
                  rtol=1e-3, atol_rel=1e-5, global_scale=True)
    _assert_close(restored.model.state_dict(), from_jax_variables(
        {"params": _np_tree(params), "batch_stats": _np_tree(bstats),
         "constants": setup["variables"]["constants"]}),
        rtol=1e-3, atol_rel=1e-5)
    for key, ref in from_jax_opt_state(_np_tree(opt)).items():
        np.testing.assert_allclose(restored.opt_state[key].numpy(),
                                   ref.numpy(), rtol=1e-3,
                                   atol=1e-5 * gmax, err_msg=key)
    # finetune: the weights only
    fine = _restore(saved["jax_tar"], finetune=True)
    assert fine.epoch == 0
    assert all(float(v.min()) == 0.5 for v in fine.opt_state.values())


def test_bare_jax_pickle_loads_as_the_tar(saved, tmp_path):
    with tarfile.open(saved["jax_tar"]) as tar:
        blob = tar.extractfile(tar.getmembers()[0]).read()
    bare = tmp_path / "bare.pkl"
    bare.write_bytes(blob)
    a, b = load_checkpoint_file(saved["jax_tar"]), load_checkpoint_file(
        str(bare))
    assert set(a["model_state_dict"]) == set(b["model_state_dict"])
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k


@pytest.mark.parametrize("legacy", [False, True])
def test_reference_file_loads_and_evaluates_as_in_jax(setup, saved,  # noqa: F811,E501
                                                      tmp_path, legacy,
                                                      capsys):
    path = saved["ref"]
    if legacy:
        # the torch-1.4 legacy pickle of the same payload
        payload = torch.load(path, weights_only=True)
        path = str(tmp_path / "legacy.tar")
        torch.save(payload, path, _use_new_zipfile_serialization=False)
        with open(path, "rb") as f:
            assert f.read(2) == b"\x80\x02"
    got = load_checkpoint_file(path)
    assert got["epoch"] == 4 and got["optimizer_state_dict"] is None
    restored = _restore(path)
    assert "momentum restarts from zero" in capsys.readouterr().out
    assert all(float(v.abs().max()) == 0.0
               for v in restored.opt_state.values())
    assert restored.epoch == 4
    state = saved["state"]
    _assert_eval_close(_port_eval(restored.model, setup),
                       _jax_eval(setup, state.params, state.batch_stats),
                       setup)
    want = from_jax_variables(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats,
         "constants": setup["variables"]["constants"]}))
    for key, ref in want.items():
        assert torch.equal(got["model_state_dict"][key], ref), key


def test_port_export_loads_in_jax_with_equal_eval(setup, tmp_path):  # noqa: F811,E501
    """The port's own checkpoint, exported by `python -m
    weasal_tpu_torch.export_torch_checkpoint` with the run's
    parameters.txt, read by the JAX package's `load_checkpoint_file`:
    JAX eval of it equals the port's eval."""
    from tests.test_torch_deformable import _port_model
    model = _port_model(setup)
    cfg = PortDeformConfig()
    cfg.class_w = CLASS_W
    cfg.saving_path = str(tmp_path / "Log_port")
    os.makedirs(cfg.saving_path)
    cfg.save()
    chkp = os.path.join(cfg.saving_path, "checkpoints")
    ModelTrainer.save_checkpoint(
        SimpleNamespace(epoch=7, model=model, opt_state=init_opt_state(model),
                        config=cfg), chkp)
    out = str(tmp_path / "exported.tar")
    export_main([os.path.join(chkp, "current_chkp.tar"), out])
    ref = torch.load(out, weights_only=True)
    assert ref["epoch"] == 7
    assert torch.equal(ref["model_state_dict"]["criterion.weight"],
                       torch.tensor(CLASS_W, dtype=torch.float32))
    assert "criterion_multi.weight" in ref["model_state_dict"]
    groups = ref["optimizer_state_dict"]["param_groups"]
    # the reference's parameters: the port's and the kernel points (a
    # frozen nn.Parameter there), the offset convs' and biases in group 1
    params = [n for n, _ in model.named_parameters()] + [
        n for n in model.state_dict() if n.endswith("kernel_points")]
    n_offset = sum("offset" in n for n in params)
    assert n_offset == 9
    assert [len(g["params"]) for g in groups] == [len(params) - n_offset,
                                                  n_offset]
    np.testing.assert_allclose(groups[1]["lr"], cfg.learning_rate
                               * cfg.deform_lr_factor)
    payload = jax_load(out)
    ms = payload["model_state_dict"]
    _assert_eval_close(_port_eval(model, setup),
                       _jax_eval(setup, ms["params"], ms["batch_stats"]),
                       setup)


def test_round_trip_port_reference_port_is_bit_equal(setup, tmp_path):  # noqa: F811,E501
    from tests.test_torch_deformable import _port_model
    state = _port_model(setup).state_dict()
    path = str(tmp_path / "ref.tar")
    save_reference_checkpoint(path, state, epoch=2,
                              config=PortDeformConfig())
    back = load_checkpoint_file(path)["model_state_dict"]
    assert set(back) == set(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    assert set(reference_to_port_state(port_to_reference_state(state))) \
        == set(state)


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo should-not-run",))


@pytest.mark.parametrize("wrapped", ["tar", "bare"])
def test_a_pickle_naming_a_foreign_global_is_refused(tmp_path, wrapped):
    blob = pickle.dumps({"epoch": 0, "model_state_dict": {"params": {}},
                         "hook": _Evil()})
    path = tmp_path / "evil.tar"
    if wrapped == "tar":
        with tarfile.open(path, "w") as tar:
            info = tarfile.TarInfo("state.pkl")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    else:
        path.write_bytes(blob)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        load_checkpoint_file(str(path))


def test_missing_or_extra_keys_raise(setup, saved, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match="Unrecognized"):
        classify_torch_key("encoder_blocks.0.KPConv.mystery")
    assert classify_torch_key("criterion.weight") is None
    assert classify_torch_key(
        "encoder_blocks.1.batch_norm_conv.batch_norm.num_batches_tracked") \
        is None
    payload = torch.load(saved["ref"], weights_only=True)
    sd = payload["model_state_dict"]
    # an extra key that a rule maps, but that the model does not hold
    extra = dict(payload, model_state_dict=dict(
        sd, **{"encoder_blocks.9.KPConv.weights": torch.zeros(1)}))
    # a parameter left unfilled
    missing = dict(payload, model_state_dict={
        k: v for k, v in sd.items() if k != "encoder_blocks.3.KPConv."
                                            "offset_bias"})
    # a key that no rule maps
    unknown = dict(payload, model_state_dict=dict(
        sd, **{"encoder_blocks.0.foo": torch.zeros(1)}))
    for name, bad, error in (("extra", extra, RuntimeError),
                             ("missing", missing, RuntimeError),
                             ("unknown", unknown, ValueError)):
        path = str(tmp_path / f"{name}.tar")
        torch.save(bad, path)
        with pytest.raises(error):
            _restore(path)
