"""The port's DALES data layer against the JAX package's.

Each package writes one synthetic DALES-like root of its own from one
seed (3 training and validation tiles of 40 m, 2 test tiles; no
intensity), then prepares, subsamples, builds anchors, calibrates and
samples with the same seeds. The JAX side runs with sorted KD rows, a
seeded anchor generator and its numpy grid subsample
(tests/_torch_data_setup.py); torch runs on one intra-op thread.
Everything is held exactly: the plys byte for byte; the discovered tile
layout and each split's tiles (a list of test tiles, with and without
`test_on_train`); the subsampled points and labels, with no color read
or written; the anchor sets (centers to 1e-6); the potentials; the
calibrated plan; twenty successive sphere payloads on each split, in
both the gathered and the resident form, with the potentials after each
(the features [1, z + c_z, z] to 1e-6: f32 arithmetic in the same
order); the pseudo-label dataset's training labels with a ground-truth
ledger over them. The resident assembly of the features on the CPU
equals the JAX package's (1e-5, each side's own jitter from the shipped
seeds, as tests/test_torch_resident.py holds Vaihingen3D's) and, without
augmentation, the host's features of the same spheres (1e-6). The
`parameters.txt` of the JAX package's DALES configurations loads into the
values of the port's (floats to 1e-6).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weasal_tpu.config import Config as JaxConfig
from weasal_tpu.data import datasets as jax_datasets
from weasal_tpu.data import resident as jres
from weasal_tpu.data.synthetic import make_dales_like_root as jax_make
from weasal_tpu_torch.config import Config as PortConfig
from weasal_tpu_torch.data import datasets as port_datasets
from weasal_tpu_torch.data import resident as pres
from weasal_tpu_torch.data.batching import ShapePlan
from weasal_tpu_torch.data.synthetic import make_dales_like_root
from tests._torch_data_setup import POTENTIAL_SEED, jax_dataset_patches
from tests._warm_torch import cpu_torch
from tests.test_torch_dataset import _assert_payload_equal
from tests.test_torch_resident import _in_input_order

N_SPHERES = 20
TILES = dict(extent=40.0, density=4.0, seed=7, train_tiles=3, test_tiles=2)
LOG = "WL"
ATTRS = dict(
    dataset="DALESWL", num_classes=None, in_features_dim=3,
    first_features_dim=16, num_kernel_points=15, in_radius=8.0,
    sub_radius=3.0, first_subsampling_dl=0.4, conv_radius=2.5,
    architecture=["simple", "resnetb", "resnetb_strided", "resnetb",
                  "resnetb_strided", "resnetb", "nearest_upsample",
                  "nearest_upsample"],
    batch_num=2, epoch_steps=4, validation_size=2,
    augment_rotation="vertical", augment_scale_min=0.9,
    augment_scale_max=1.1, augment_noise=0.01,
    augment_symmetries=[True, True, False], augment_color=0.7,
    model_name="KPFCNN_mprm", loss_type="region_mprm_loss",
    anchor_method="reduced", active_learning_iterations=0,
    subsample_labels=True, initial_labels_per_file=30,
    subsample_method="balanced", added_labels_per_epoch=10,
    weak_label_log=LOG, contrast_thd=10)
SPLITS = (("training", False), ("validation", False), ("test", False),
          ("test", True))


def configs(**overrides):
    attrs = {**ATTRS, **overrides}
    return (type("JaxDALES", (JaxConfig,), attrs)(),
            type("PortDALES", (PortConfig,), attrs)())


def _make(jax_cls, port_cls, roots, split, test_on_train=False,
          al_iteration=0, **overrides):
    jcfg, pcfg = configs(**overrides)
    kw = dict(split=split, test_on_train=test_on_train,
              al_iteration=al_iteration)
    with jax_dataset_patches():
        j = jax_cls(jcfg, data_root=roots[0],
                    rng=np.random.default_rng(POTENTIAL_SEED), **kw)
    p = port_cls(pcfg, data_root=roots[1],
                 rng=np.random.default_rng(POTENTIAL_SEED), **kw)
    return j, p


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("dales")
    jroot, proot = str(base / "jax" / "DALES"), str(base / "port" / "DALES")
    jax_make(jroot, **TILES)
    make_dales_like_root(proot, **TILES)
    return jroot, proot


@pytest.fixture(scope="module")
def both(roots):
    """{(split, test_on_train): (JAX dataset, port dataset)}."""
    with cpu_torch():
        yield {key: _make(jax_datasets.DALESWLDataset,
                          port_datasets.DALESWLDataset, roots, *key)
               for key in SPLITS}


def _ply_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kwargs", [
    TILES, dict(extent=40.0, density=3.0, seed=5),
    dict(tile_names=("5080_54435", "test_5080_54400"), extent=40.0,
         density=3.0, seed=2, styled=True)],
    ids=["discovered", "named", "named_styled"])
def test_make_dales_like_root_plys_are_byte_equal(tmp_path, kwargs):
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_make(jroot, **kwargs)
    make_dales_like_root(proot, **kwargs)
    names = sorted(os.listdir(jroot))
    assert names == sorted(os.listdir(proot)) and len(names) >= 2
    for name in names:
        assert _ply_bytes(os.path.join(proot, name)) == \
            _ply_bytes(os.path.join(jroot, name)), name


@pytest.mark.parametrize("split,on_train", SPLITS)
def test_discovered_splits_equal_jax(both, roots, split, on_train):
    """The discovered layout and each split's tiles: the 'test' split is
    a list of tiles (the test tiles, or the training tiles with
    `test_on_train`), and a tile lands in one split only."""
    j, p = both[(split, on_train)]
    assert p.cloud_names == j.cloud_names == [
        "tile_00", "tile_01", "tile_02", "test_tile_00", "test_tile_01"]
    assert p.validation_split == j.validation_split == 2
    assert p.test_split == j.test_split
    assert isinstance(p.test_split, list)
    want = {("training", False): ["tile_00", "tile_01"],
            ("validation", False): ["tile_02"],
            ("test", False): ["test_tile_00", "test_tile_01"],
            ("test", True): ["tile_00", "tile_01"]}[(split, on_train)]
    assert p.cloud_names_split == j.cloud_names_split == want
    assert [os.path.relpath(f, roots[1]) for f in p.files] == \
        [os.path.relpath(f, roots[0]) for f in j.files]
    assert p.has_labels == (split != "test" or on_train)
    np.testing.assert_array_equal(p.coord_offset, j.coord_offset)
    for f_p, f_j in zip(p.files, j.files):
        assert _ply_bytes(f_p) == _ply_bytes(f_j)


@pytest.mark.parametrize("split,on_train", SPLITS)
def test_subsampled_clouds_equal_without_color(both, roots, split,
                                               on_train):
    j, p = both[(split, on_train)]
    assert p.num_clouds == j.num_clouds == len(p.cloud_names_split)
    for i, name in enumerate(p.cloud_names_split):
        assert p.input_colors[i] is None and j.input_colors[i] is None
        np.testing.assert_array_equal(np.asarray(p.input_trees[i].data),
                                      np.asarray(j.input_trees[i].data))
        np.testing.assert_array_equal(p.input_labels[i], j.input_labels[i])
        np.testing.assert_array_equal(np.asarray(p.pot_trees[i].data),
                                      np.asarray(j.pot_trees[i].data))
        np.testing.assert_array_equal(p.potentials[i], j.potentials[i])
        sub = port_datasets.read_ply(os.path.join(p.tree_path,
                                                  name + ".ply"))
        assert sub.dtype.names == ("x", "y", "z", "class")
    if split != "training":
        for i in range(p.num_clouds):
            np.testing.assert_array_equal(p.test_proj[i], j.test_proj[i])
            np.testing.assert_array_equal(p.validation_labels[i],
                                          j.validation_labels[i])
    # The same split again, from the port's caches (no color column)
    _, cached = configs()
    with cpu_torch():
        again = port_datasets.DALESWLDataset(
            cached, split=split, test_on_train=on_train, data_root=roots[1],
            rng=np.random.default_rng(POTENTIAL_SEED))
    for i in range(p.num_clouds):
        assert again.input_colors[i] is None
        np.testing.assert_array_equal(again.input_labels[i],
                                      p.input_labels[i])


def test_anchors_and_plan_equal(both):
    j, p = both[("training", False)]
    assert p.num_clouds == 2
    for i in range(p.num_clouds):
        assert len(j.anchors[i]) >= p.config.initial_labels_per_file
        np.testing.assert_allclose(p.anchors[i], j.anchors[i], rtol=0,
                                   atol=1e-6)
        assert sorted(p.anchor_dicts[i]) == sorted(j.anchor_dicts[i])
        for k in j.anchor_dicts[i]:
            np.testing.assert_array_equal(p.anchor_dicts[i][k][0][0],
                                          j.anchor_dicts[i][k][0][0])
            np.testing.assert_array_equal(p.anchor_lbs[i][k],
                                          j.anchor_lbs[i][k])
    jplan = j.calibration(num_samples=12)
    pplan = p.calibration(num_samples=12)
    assert ShapePlan.from_dict(vars(jplan)) == pplan
    for i in range(p.num_clouds):
        np.testing.assert_array_equal(p.potentials[i], j.potentials[i])


@pytest.mark.parametrize("split,on_train,gather", [
    ("training", False, True), ("training", False, False),
    ("validation", False, True), ("validation", False, False),
    ("test", False, True), ("test", False, False)])
def test_twenty_sphere_payloads_equal(both, split, on_train, gather):
    """Twenty spheres of one seed: the sampler chooses among the tiles,
    and draws no color drop (the JAX package draws none for a cloud
    without colors: an extra draw would shift every later sphere)."""
    j, p = both[(split, on_train)]
    max_points = 500
    rj, rp = np.random.default_rng(40), np.random.default_rng(40)
    clouds, thinned = set(), 0
    for _ in range(N_SPHERES):
        want = j.sample_sphere(rj, augment=True, max_points=max_points,
                               gather=gather)
        got = p.sample_sphere(rp, augment=True, max_points=max_points,
                              gather=gather)
        _assert_payload_equal(got, want)
        if gather:
            feats, pts = got["features"], got["points"]
            assert feats.shape == (pts.shape[0], 3)
            np.testing.assert_array_equal(feats[:, 0], 1.0)
            np.testing.assert_array_equal(feats[:, 2], pts[:, 2])
            np.testing.assert_allclose(feats[:, 1],
                                       pts[:, 2] + got["center"][2],
                                       rtol=0, atol=1e-6)
        else:
            assert got["color_keep"] == 1.0
        clouds.add(got["cloud_ind"])
        thinned += len(want["input_inds"]) == max_points
        for i in range(j.num_clouds):
            np.testing.assert_array_equal(p.potentials[i], j.potentials[i])
        assert p.min_potentials == j.min_potentials
    assert clouds == set(range(p.num_clouds))   # every tile drawn
    assert thinned > 0
    assert rj.random() == rp.random()           # same draws consumed


@pytest.mark.parametrize("augment", [True, False])
def test_resident_feature_assembly(both, augment):
    """The device assembly (on the CPU) of one training batch: with
    augmentation against the JAX package's (no color table on either
    side), without it against the host's features of the same spheres."""
    _, p = both[("training", False)]
    cfg = p.config
    plan = p.calibration(num_samples=12)
    n0 = plan.num_points[0]
    src = pres.ResidentBatchSource(p, plan, "cpu")
    assert set(src.resident.arrays) == {"res_points", "res_labels"}
    spec = pres.feature_spec(p.name, cfg.in_features_dim)
    assert spec == jres.feature_spec(p.name, cfg.in_features_dim) == (
        "ones", "abs_z", "red_z")
    pots = [q.copy() for q in p.potentials]
    small, metas = src.next_batch(np.random.default_rng(8), augment=augment)
    with cpu_torch():
        batch_t = {k: torch.from_numpy(v.astype(np.int64)
                                       if k == "noise_seed" else v)
                   for k, v in small.items()}
        got = pres.assemble_level0_device({**batch_t, **src.resident.arrays},
                                          cfg, plan, augment, spec)
    got = {k: v.numpy() for k, v in got.items()}
    feats = _in_input_order(got, "features")
    if augment:
        arrays = {k: jnp.asarray(v.numpy())
                  for k, v in src.resident.arrays.items()}
        want = jax.jit(lambda b: jres.assemble_level0_device(
            b, cfg, plan, True, spec))(
                {**{k: jnp.asarray(v) for k, v in small.items()}, **arrays})
        want = {k: np.asarray(v) for k, v in want.items()}
        np.testing.assert_array_equal(got["mask0"], want["mask0"])
        np.testing.assert_array_equal(_in_input_order(got, "labels"),
                                      _in_input_order(want, "labels"))
        for key in ("points0", "features"):
            np.testing.assert_allclose(_in_input_order(got, key),
                                       _in_input_order(want, key), rtol=0,
                                       atol=1e-5, err_msg=key)
    else:
        # the same spheres drawn again with the host's gather
        _restore(p, pots)
        rng = np.random.default_rng(8)
        for b, meta in enumerate(metas):
            host = p.sample_sphere(rng, augment=False, max_points=n0)
            np.testing.assert_array_equal(host["input_inds"],
                                          meta["input_inds"])
            n = meta["n_real"]
            np.testing.assert_allclose(feats[b, :n], host["features"][:n],
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(feats[b, n:], 0.0)
    _restore(p, pots)


def _restore(ds, pots):
    ds.potentials = [q.copy() for q in pots]
    ds.min_potentials = [float(q.min()) for q in pots]
    ds.argmin_potentials = [int(q.argmin()) for q in pots]


def _write_pseudo(root, truth_by_tile):
    folder = os.path.join(root, "PseudoLabels", LOG)
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(17)
    pseudo = {}
    for name, truth in truth_by_tile.items():
        pseudo[name] = np.where(rng.random(truth.shape[0]) < 0.3, 10, truth)
        np.savetxt(os.path.join(folder, f"{name}_t10_pseudo.txt"),
                   pseudo[name], fmt="%i")
    return pseudo


@pytest.mark.parametrize("al_iteration", [0, 1])
def test_pl_dataset_labels_match_jax(both, roots, al_iteration):
    """DALESPLDataset: each training tile's refined labels (t10), with
    the tile's ground-truth ledger written over them after iteration 0;
    the class 10 stays raw (unlabeled for the contrast loss)."""
    _, wl = both[("training", False)]
    truth = {n: wl.input_labels[i]
             for i, n in enumerate(wl.cloud_names_split)}
    pseudo = {}
    for root in roots:
        pseudo = _write_pseudo(root, truth)
    ids = {}
    if al_iteration:
        for i, name in enumerate(truth):
            ids[name] = np.random.default_rng([3, i]).choice(
                truth[name].shape[0], 40, replace=False).astype(np.int64)
            for folder in (os.path.join(roots[0], "input_0.400"),
                           os.path.join(roots[1], "input_0.400_torch")):
                with open(os.path.join(
                        folder, f"{name}_al_groundTruth_IDs.pkl"),
                        "wb") as f:
                    pickle.dump(ids[name], f)
    with cpu_torch():
        j, p = _make(jax_datasets.DALESPLDataset,
                     port_datasets.DALESPLDataset, roots, "training",
                     dataset="DALESPL", model_name="KPFCNN",
                     al_iteration=al_iteration)
    assert p.label_to_idx == j.label_to_idx and p.label_to_idx[10] == 10
    np.testing.assert_array_equal(p.label_values, j.label_values)
    assert p.config.num_classes == j.config.num_classes == 9
    for i, name in enumerate(p.cloud_names_split):
        np.testing.assert_array_equal(p.input_labels[i], j.input_labels[i])
        if al_iteration:
            np.testing.assert_array_equal(p.input_labels[i][ids[name]],
                                          truth[name][ids[name]])
        else:
            np.testing.assert_array_equal(p.input_labels[i], pseudo[name])
            with open(p.gt_ledger_file(name), "rb") as f:
                assert list(pickle.load(f)) == []
    assert p._label_table()[10] == 10


@pytest.mark.parametrize("stage,tag", [("WeakLabel", "WL"),
                                       ("PseudoLabel", "PL")])
def test_dales_configs_load_the_jax_parameters(tmp_path, stage, tag):
    """The `parameters.txt` that the JAX package writes for its DALES
    configuration (the root script's `DALES<tag>Config`) loads through
    the port's `Config.load` into the values of the port's own class,
    every written key (floats to 1e-6: the file keeps 6 decimals)."""
    import importlib
    from weasal_tpu_torch import config as port_config
    jcfg = getattr(importlib.import_module(f"train_DALES_{stage}"),
                   f"DALES{tag}Config")()
    pcfg = getattr(port_config, f"DALES{tag}Config")()
    jcfg.num_classes = pcfg.num_classes = 9
    jcfg.saving_path = str(tmp_path)
    jcfg.save()
    loaded = PortConfig()
    loaded.load(str(tmp_path))
    with open(tmp_path / "parameters.txt") as f:
        keys = [line.split()[0] for line in f
                if len(line.split()) > 2 and line[0] != "#"]
    assert len(keys) > 50 and "first_features_dim" in keys
    for key in keys:
        if key == "lr_decay_epochs":
            assert loaded.lr_decays == pytest.approx(pcfg.lr_decays,
                                                     rel=1e-6)
            continue
        attr = "contrast_thd" if key.startswith("contrast_thd") else key
        want, got = getattr(pcfg, attr), getattr(loaded, attr)
        if isinstance(want, float) or isinstance(got, float):
            assert got == pytest.approx(want, rel=1e-6), key
        else:
            assert got == want, key
    assert loaded.dataset == f"DALES{tag}"
    assert (loaded.first_features_dim, loaded.in_features_dim) == (
        (128, 3) if tag == "WL" else (64, 3))
