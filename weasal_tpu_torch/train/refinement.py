"""Pseudo-label refinement: predictions masked by the weak labels.

Counterpart of weasal_tpu/train/refinement.py:30-156 (the reference's
pseudoLabel_refinement.py:33-172). For every training cloud's prediction
ply (written by the tester's `--on train` pass), the probabilities of
each subsampled point's nearest predicted point are multiplied by the
product of the multi-hot labels of every anchor that holds the point;
points whose best masked probability falls below the threshold get the
'no-label' class 10. Writes `<cloud>_t<thd>_pseudo.txt` per cloud and the
log-inverse-frequency class weights `<DS>_t<thd>_weight.txt` that the
pseudo-label stage reads. Host numpy only.

Two differences from the JAX package, by the port's rules: the 1-NN
query is scipy's `cKDTree.query(k=1)` in place of sklearn's
`NearestNeighbors` (exactly equidistant candidates may resolve to another
index), and the subsampled cloud's point count and anchors come from the
port's own caches (`input_<dl>_torch/<cloud>.ply` and its anchor
pickle), not from the JAX package's `_KDTree.pkl`.
"""

from __future__ import annotations

import pickle
from os import listdir, makedirs
from os.path import exists, isfile, join
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.anchors import weak_label_masks
from weasal_tpu_torch.utils.ply import read_ply

NO_LABEL = 10   # the 'no-label' class (pseudoLabel_refinement.py:141)
# The threshold each dataset's pseudo-label stage reads its labels at
# (its config's contrast_thd)
DEFAULT_THRESHOLD = {"Vaihingen3D": 20, "DALES": 10}


def get_weak_labels_per_point(cloud_name: str, sub_folder: str,
                              anchor_method: str,
                              num_classes: int) -> np.ndarray:
    """Point-wise weak-label mask [N, num_classes] of one subsampled cloud
    of the port's cache `sub_folder`."""
    sub_file = join(sub_folder, f"{cloud_name}.ply")
    anchors_file = join(sub_folder,
                        f"{cloud_name}_anchors_{anchor_method}.pkl")
    if not exists(sub_file):
        raise ValueError(f"Subsampled cloud does not exist: {sub_file}")
    num_points = read_ply(sub_file)["x"].shape[0]
    if not exists(anchors_file):
        raise ValueError(f"Anchors file does not exist: {anchors_file}")
    with open(anchors_file, "rb") as f:
        _anchor, anchors_dict, anchor_lb = pickle.load(f)
    return weak_label_masks(anchors_dict, anchor_lb, num_points, num_classes)


def refine_pseudo_labels(weak_label_log: str,
                         threshold: Optional[int] = None,
                         results_root: str = "results/WeakLabel",
                         test_root: str = "test/WeakLabel",
                         data_root: Optional[str] = None,
                         config: Optional[Config] = None) -> str:
    """Refine the predictions of one weak-label log; returns the
    PseudoLabels output directory.

    :param threshold: max-probability cutoff in percent (default: the
        log's dataset's, DEFAULT_THRESHOLD)
    """
    if config is None:
        config = Config()
        config.load(join(results_root, weak_label_log))
    if threshold is None:
        threshold = DEFAULT_THRESHOLD[config.dataset[:-2]]

    base_path = join(test_root, weak_label_log)
    data_folder = data_root or join("data", config.dataset[:-2])
    sub_folder = join(data_folder, "input_{:.3f}_torch".format(
        config.first_subsampling_dl))
    pred_dir = join(base_path, "predictions")
    refinement_list = sorted(
        join(pred_dir, f) for f in listdir(pred_dir)
        if isfile(join(pred_dir, f)) and f.endswith(".ply"))

    # Every weak-label training cloud (one anchor pickle each) must have
    # its prediction ply, or the pseudo labels and the class weights
    # would come from a subset
    expected = sorted({f.split("_anchors")[0]
                       for f in listdir(sub_folder) if "_anchors_" in f})
    got = {file.split("/")[-1].split(".ply")[0] for file in refinement_list}
    missing = [c for c in expected if c not in got]
    if missing:
        raise FileNotFoundError(
            f"predictions missing for training cloud(s) {missing} in "
            f"{pred_dir}: run the vote on the training clouds "
            "(test_models --on train) to completion first")

    print(f"\nPseudo label refinement for {weak_label_log} "
          f"with threshold {threshold}%:\n")
    counts = np.zeros(config.num_classes, np.int64)
    out_folder = join(data_folder, "PseudoLabels", weak_label_log)
    makedirs(out_folder, exist_ok=True)

    for file in refinement_list:
        data = read_ply(file)
        points = np.array([data["x"], data["y"], data["z"]]).T
        pseudo_lbs = data["preds"].astype(np.int64)
        file_name = file.split("/")[-1].split(".ply")[0]
        points = (points - np.min(points, 0)).astype(np.float32)

        data_orig = read_ply(join(sub_folder, file_name + ".ply"))
        points_orig = np.array([data_orig["x"], data_orig["y"],
                                data_orig["z"]]).T
        points_orig = (points_orig - np.min(points_orig, 0)).astype(
            np.float32)

        # 1-NN of each subsampled point in the prediction cloud
        _, indices = cKDTree(points).query(points_orig, k=1)
        indices = np.asarray(indices, dtype=np.int64)

        data = read_ply(join(base_path, "probs", file_name + ".ply"))
        label_list = data.dtype.names[3:]
        probs = np.vstack([data[label] for label in label_list]).T

        print(f'Getting point-wise weak labels for "{file_name}"')
        weak = get_weak_labels_per_point(file_name, sub_folder,
                                         config.anchor_method,
                                         config.num_classes)
        probs = probs[indices] * weak

        empty = np.max(probs, axis=-1) < (0.01 * threshold)
        pseudo_lbs = pseudo_lbs[indices]
        pseudo_lbs[empty] = NO_LABEL

        unique_lbs, counter = np.unique(pseudo_lbs, return_counts=True)
        for c in range(len(counts)):
            if c in unique_lbs:
                counts[c] += counter[np.where(unique_lbs == c)][0]

        pseudo_path = join(out_folder,
                           f"{file_name}_t{threshold}_pseudo.txt")
        np.savetxt(pseudo_path, pseudo_lbs, fmt="%i")
        print("Created: " + pseudo_path)

    if 0 in counts:
        print("\nWARNING:\nPseudo labels are missing classes! "
              "Lower threshold or improve weak label training.")
    if np.sum(counts) == 0:
        # every point below the threshold: uniform weights, not NaNs
        weights_norm = np.full(len(counts), 1.0 / len(counts))
    else:
        weights = np.log(1 / ((counts + 1) / np.sum(counts)))
        weights_norm = weights / np.sum(weights)
    weights_path = join(out_folder,
                        f"{config.dataset[:-2]}_t{threshold}_weight.txt")
    np.savetxt(weights_path, weights_norm, fmt="%.3f")
    print("\nCreated: " + weights_path + "\n")
    return out_folder
