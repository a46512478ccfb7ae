"""The port's deformable KP-FCNN against the benchmark's plain reference.

`portbench/reference/` is an independent plain PyTorch copy of the
network (f32, no JAX, nothing of the port): its deformable block
(`models/blocks.py`), the fitting and repulsion regularizer
(`models/losses.p2p_fitting_regularizer`) and the SGD step with the
deform group (`train/optim.py`). Here both networks run a small
pseudo-label architecture whose last two layers are deformable
(`config.deformable_last_layers` of the quick preset's, as
`VaihingenPLDeformConfig` is of the published one), from the same seeded
weights (`portbench/drivers/common.seeded_state`, offset biases drawn
too) on one pyramid built by the port's plain versions on the CPU, in
training mode with dropout and the contrast loss. Compared: the logits,
the loss and the offset loss, every leaf's gradient (the offset convs'
weights and `offset_bias` among them) and one SGD update (parameters
and momentum, the deform group's scaled trace included).

Tolerances: both sides run the same plain operations on one pyramid, but
in two copies of the code whose reductions may group differently (the
influence sums, the einsum, torch's matmuls), so values are held at f32
rounding grown through the network: 1e-5 relative (a few hundred ulps)
on the logits and losses, and on each gradient and update 1e-5 of that
leaf's largest magnitude. (On one torch thread with its math kernels
warmed, `tests/_warm_torch.cpu_torch`, they came out equal bit for bit.)
A wrong mask, offset scale, regularizer term or deform-group factor
moves them by percents.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.drivers.common import check_names, seeded_state
from portbench.reference.data.batch import PyramidBatch as RefBatch
from portbench.reference.models.architectures import \
    model_for_config as reference_model
from portbench.reference.train.step import step_on_batch as reference_step
from weasal_tpu_torch import KPFCNN, init_opt_state
from weasal_tpu_torch.config import (VaihingenPLDeformConfig,
                                     deformable_last_layers)
from weasal_tpu_torch.data.batching import calibrate_shape_plan
from weasal_tpu_torch.data.demo import thin_payload
from weasal_tpu_torch.data.level0 import assemble_level0
from weasal_tpu_torch.data.synthetic import synthetic_scene
from weasal_tpu_torch.infer import to_device
from weasal_tpu_torch.models.blocks import kpconv_modules
from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
from weasal_tpu_torch.ops.subsample import grid_subsample
from weasal_tpu_torch.train.step import step_on_batch
from tests._warm_torch import cpu_torch

RTOL = 1e-5
QUICK_ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb",
              "resnetb_strided", "resnetb", "nearest_upsample", "unary",
              "nearest_upsample", "unary"]
LABELS = tuple(range(9)) + (10,)
IGNORED = (10,)


class SmallDeform(VaihingenPLDeformConfig):
    architecture = deformable_last_layers(QUICK_ARCH)
    in_radius = 6.0
    first_subsampling_dl = 0.45
    first_features_dim = 16
    batch_num = 2
    num_classes = 9


def _pyramid(cfg):
    """A pyramid of batch_num spheres of a synthetic scene, built by the
    port's plain versions on the CPU; labels 0-8 with a third set to 10
    (no label)."""
    pts, _, _ = synthetic_scene(np.random.default_rng(5), extent=30.0,
                                density=5.0)
    tile = grid_subsample(pts.astype(np.float32),
                          dl=cfg.first_subsampling_dl)
    rng = np.random.default_rng(0)

    def sphere():
        c = tile[rng.integers(tile.shape[0])]
        p = tile[np.linalg.norm(tile - c, axis=1) < cfg.in_radius] - c
        n = p.shape[0]
        labels = rng.integers(0, 9, n).astype(np.int32)
        labels[rng.random(n) < 0.3] = 10
        return dict(points=p.astype(np.float32),
                    features=rng.random((n, cfg.in_features_dim),
                                        dtype=np.float32),
                    labels=labels, center=np.zeros(3, np.float32),
                    cloud_lb=np.zeros(cfg.num_classes, np.float32),
                    regions=[])

    calib = [sphere() for _ in range(6)]
    plan = calibrate_shape_plan([p["points"] for p in calib], cfg, rng=rng)
    arrays = assemble_level0(
        [thin_payload(p, plan.num_points[0], rng)
         for p in calib[:cfg.batch_num]], plan, cfg.num_classes, rng)
    t = to_device(arrays, torch.device("cpu"))
    with torch.no_grad():
        return batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], cfg, plan,
            t["center_pts"], rotations=t["rotations"])


@pytest.fixture(scope="module")
def setup():
    with cpu_torch():
        yield _setup()


def _setup():
    cfg = SmallDeform()
    assert cfg.deform_layers == [False, True, True]
    pyr = _pyramid(cfg)
    ref_batch = RefBatch(**{f.name: getattr(pyr, f.name)
                            for f in dataclasses.fields(RefBatch)})
    model = KPFCNN(cfg, LABELS, IGNORED,
                   generator=torch.Generator().manual_seed(1))
    ref = reference_model(cfg, LABELS, IGNORED,
                          generator=torch.Generator().manual_seed(2))
    state = seeded_state(ref, 2 ** 31 + 7, "cpu")
    gen = torch.Generator().manual_seed(3)
    for name in state:
        if name.endswith("offset_bias"):
            state[name] = 0.1 * torch.randn(state[name].shape,
                                            generator=gen)
    check_names(model, state)
    model.load_state_dict(state)
    ref.load_state_dict(state)
    return cfg, pyr, ref_batch, model, ref, state


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, f"{what}: {err} against {scale}"


def test_the_deformable_convs_are_the_published_pattern(setup):
    _, _, _, model, _, _ = setup
    deformable = [name for name, m in kpconv_modules(model)
                  if m.params.deformable]
    # layer 1's resnetb, the strided block into layer 2, layer 2's resnetb
    assert len(deformable) == 3
    assert all(hasattr(m, "offset_conv") for name, m in
               kpconv_modules(model) if name in deformable)


def test_logits_equal_the_reference(setup):
    cfg, pyr, ref_batch, model, ref, state = setup
    seed = torch.tensor(11, dtype=torch.int64)
    model.train()
    ref.train()
    with torch.no_grad():
        got = model(pyr, dropout_seed=seed)
        want = ref(ref_batch, dropout_seed=seed)
    model.load_state_dict(state)
    ref.load_state_dict(state)
    assert got.shape == want.shape
    _close(got, want, "logits")


def test_step_equals_the_reference(setup):
    """Loss, offset loss, every leaf's gradient and one SGD update with
    the deform group, from one state."""
    cfg, pyr, ref_batch, model, ref, state = setup
    model.load_state_dict(state)
    ref.load_state_dict(state)
    opt, ref_opt = init_opt_state(model), init_opt_state(ref)
    seed = torch.tensor(5, dtype=torch.int64)
    got = step_on_batch(model, opt, pyr, cfg, cfg.learning_rate, seed=seed,
                        use_contrast=True, with_offset_loss=True)
    want = reference_step(ref, ref_opt, ref_batch, cfg, cfg.learning_rate,
                          seed=seed, use_contrast=True,
                          with_offset_loss=True)
    for name, g, w in zip(("loss", "accuracy", "offset loss"), got, want):
        _close(g, w, name)
    assert float(want[2]) > 0
    params = dict(model.named_parameters())
    ref_params = dict(ref.named_parameters())
    offsets = [n for n in params if "offset" in n]
    assert any(n.endswith("offset_bias") for n in offsets)
    assert any(n.endswith("offset_conv.weights") for n in offsets)
    for name, p in params.items():
        want_grad = ref_params[name].grad
        assert p.grad is not None and want_grad is not None, name
        _close(p.grad, want_grad, f"gradient of {name}")
        _close(p.detach(), ref_params[name].detach(), f"updated {name}")
        _close(opt[name], ref_opt[name], f"momentum of {name}")
    for name in offsets:
        assert float(opt[name].abs().max()) > 0, name
    model.load_state_dict(state)
    ref.load_state_dict(state)
