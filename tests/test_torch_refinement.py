"""The port's pseudo-label refinement against the JAX package's.

Each package builds its own caches of the same synthetic scene (the
subsampled cloud and the anchors: the JAX package's sklearn pickles, the
port's `input_<dl>_torch/`); the same prediction and probability plys
(the vote on the training clouds, made here from seeded numpy draws) go
into each package's test directory, and `refine_pseudo_labels` of each
writes its pseudo-label txt and class-weight file. Checked:
- the point-wise weak-label masks (`weak_label_masks` over each
  package's own anchors) equal;
- the pseudo labels equal at every point whose nearest predicted point
  is the same under sklearn's `NearestNeighbors` and scipy's `cKDTree`;
  where the two pick different points, the two must be exactly
  equidistant (ties), and they are counted;
- the class weights equal (to the file's 3 decimals) when no tie moved
  a label, else to 1e-3.
"""

import os

import numpy as np
import pytest
from scipy.spatial import cKDTree
from sklearn.neighbors import NearestNeighbors

from weasal_tpu.train import refinement as jax_refinement
from weasal_tpu.utils.ply import write_ply as jax_write_ply
from weasal_tpu_torch.data.anchors import weak_label_masks
from weasal_tpu_torch.train import refinement as port_refinement
from weasal_tpu_torch.utils.ply import read_ply
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)

LOG = "Log_2026-01-01_00-00-00"
CLOUD = "Vaihingen3D_Training"
THRESHOLD = 20


def _prediction_plys(test_dir, points, probs, names):
    preds = np.argmax(probs, axis=1).astype(np.int32)
    for sub in ("predictions", "probs"):
        os.makedirs(os.path.join(test_dir, sub), exist_ok=True)
    jax_write_ply(os.path.join(test_dir, "predictions", CLOUD + ".ply"),
                  [points, preds, preds, np.zeros_like(preds, np.int8)],
                  ["x", "y", "z", "preds", "targets", "error"])
    jax_write_ply(os.path.join(test_dir, "probs", CLOUD + ".ply"),
                  [points, probs], ["x", "y", "z"] + names)


@pytest.fixture(scope="module")
def refined(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "refinement")
    base = tmp_path_factory.mktemp("refinement_tests")
    with jax_dataset_patches():
        jcfg = JaxSynthConfig()
        (jtrain,) = jax_datasets_for(jcfg, jroot, splits=("training",))
    pcfg = port_config_class()()
    (ptrain,) = port_datasets_for(pcfg, proot, splits=("training",))

    # The vote's points: the training cloud's prepared points (as the
    # tester writes them, offset added back), a little displaced
    rng = np.random.default_rng(7)
    data = read_ply(os.path.join(proot, "Training", CLOUD + ".ply"))
    points = np.vstack((data["x"], data["y"], data["z"])).T
    points = (points + ptrain.coord_offset
              + rng.normal(scale=0.01, size=points.shape)).astype(np.float32)
    logits = rng.normal(scale=2.0, size=(points.shape[0],
                                         pcfg.num_classes))
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    probs = probs.astype(np.float32)
    names = [f"class_{i}" for i in range(pcfg.num_classes)]
    out = {}
    for key, cfg, root, mod in (("jax", jcfg, jroot, jax_refinement),
                                ("port", pcfg, proot, port_refinement)):
        test_root = str(base / key / "test")
        _prediction_plys(os.path.join(test_root, LOG), points, probs, names)
        with jax_dataset_patches():
            folder = mod.refine_pseudo_labels(LOG, THRESHOLD,
                                              test_root=test_root,
                                              data_root=root, config=cfg)
        out[key] = dict(
            pseudo=np.loadtxt(os.path.join(
                folder, f"{CLOUD}_t{THRESHOLD}_pseudo.txt")).astype(int),
            weights=np.loadtxt(os.path.join(
                folder, f"Vaihingen3D_t{THRESHOLD}_weight.txt")),
            root=root, cfg=cfg)
    sub = read_ply(os.path.join(proot, "input_0.400_torch", CLOUD + ".ply"))
    sub_points = np.vstack((sub["x"], sub["y"], sub["z"])).T
    out.update(points=points, sub_points=sub_points, train=ptrain)
    return out


def test_weak_label_masks_match_jax(refined):
    jcfg, pcfg = refined["jax"]["cfg"], refined["port"]["cfg"]
    with jax_dataset_patches():
        j = jax_refinement.get_weak_labels_per_point(
            CLOUD, os.path.join(refined["jax"]["root"], "input_0.400"),
            jcfg.anchor_method, jcfg.num_classes)
    p = port_refinement.get_weak_labels_per_point(
        CLOUD, os.path.join(refined["port"]["root"], "input_0.400_torch"),
        pcfg.anchor_method, pcfg.num_classes)
    assert p.shape == j.shape == (refined["sub_points"].shape[0],
                                  pcfg.num_classes)
    assert (p < 1).any()                         # the anchors mask points
    np.testing.assert_array_equal(p, j)


def test_weak_label_masks_function_matches_jax(refined):
    from weasal_tpu.data.anchors import weak_label_masks as jax_masks
    train = refined["train"]        # the initial budget's anchors
    n, c = train.input_labels[0].shape[0], refined["port"]["cfg"].num_classes
    np.testing.assert_array_equal(
        weak_label_masks(train.anchor_dicts[0], train.anchor_lbs[0], n, c),
        jax_masks(train.anchor_dicts[0], train.anchor_lbs[0], n, c))


def test_pseudo_labels_and_weights_match_jax(refined):
    j, p = refined["jax"]["pseudo"], refined["port"]["pseudo"]
    assert p.shape == j.shape == (refined["sub_points"].shape[0],)
    # The two 1-NN queries of refinement, on its shifted f32 coordinates
    pred = refined["points"].astype(np.float64)
    pred = (pred - pred.min(0)).astype(np.float32)
    orig = refined["sub_points"]
    orig = (orig - orig.min(0)).astype(np.float32)
    sk = np.squeeze(NearestNeighbors(n_neighbors=1, algorithm="kd_tree")
                    .fit(pred).kneighbors(orig)[1])
    ck = cKDTree(pred).query(orig, k=1)[1]
    differ = sk != ck
    d_sk = np.linalg.norm(pred[sk].astype(np.float64) - orig, axis=1)
    d_ck = np.linalg.norm(pred[ck].astype(np.float64) - orig, axis=1)
    np.testing.assert_array_equal(d_sk[differ], d_ck[differ])
    print(f"{int(differ.sum())} of {differ.size} points tie between "
          "sklearn's and cKDTree's nearest neighbor")
    np.testing.assert_array_equal(p[~differ], j[~differ])
    assert (p == port_refinement.NO_LABEL).any() and (p < 10).any()
    wj, wp = refined["jax"]["weights"], refined["port"]["weights"]
    assert np.isfinite(wp).all() and wp.shape == (9,)
    if (p != j).any():
        np.testing.assert_allclose(wp, wj, atol=1e-3)
    else:
        np.testing.assert_array_equal(wp, wj)
