"""Anchors: the weak labels of sub-clouds.

Counterpart of weasal_tpu/data/anchors.py:26-186 on scipy's cKDTree.
Anchors are regularly spaced sphere centers of radius `sub_radius`; each
anchor that holds points carries the multi-hot class label of those
points; overlapping anchors with different labels spawn an intersection
anchor labeled with the AND of the two; the initial active-learning
budget subsamples anchors per file.

Data structures are the JAX package's: (anchor array [A, 3], tree,
anchors_dict {i: [[point_inds], [center]]}, anchor_lbs {i: multi-hot}),
with a cKDTree in place of sklearn's KDTree. Radius queries return rows
sorted ascending (ops/neighbors.query_radius), which fixes the numbering
of intersection anchors. `subsample_anchors` takes an explicit, seeded
`random.Random`; the JAX package falls back to an unseeded one.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np
from scipy.spatial import cKDTree

from weasal_tpu_torch.ops.neighbors import query_radius


def get_anchors(points: np.ndarray, sub_radius: float,
                method: str = "full") -> np.ndarray:
    """Regular 3-D grid of candidate anchor centers over the cloud bounds.

    'full': spacing = sub_radius. 'reduced': spacing = 2*sub_radius with a
    half-offset pattern (4 anchors per grid node), i.e. half the density.
    """
    mins = points.min(axis=0)
    maxs = points.max(axis=0)

    def axis_coords(spacing):
        steps = (np.floor((maxs - mins) / spacing) + 1).astype(int)
        return [np.linspace(mins[d], maxs[d], steps[d]) for d in range(3)]

    anchors = []
    if method == "full":
        xs, ys, zs = axis_coords(sub_radius)
        for x in xs:
            for y in ys:
                for z in zs:
                    anchors.append([x, y, z])
    elif method == "reduced":
        xs, ys, zs = axis_coords(2 * sub_radius)
        r = sub_radius
        for x in xs:
            for y in ys:
                for z in zs:
                    anchors.append([x, y, z])
                    anchors.append([x, y, z + r])
                    anchors.append([x + r, y + r, z])
                    anchors.append([x + r, y + r, z + r])
    else:
        raise ValueError(f"Unsupported anchor method: {method}")
    return np.array(anchors)


def anchors_with_points(input_tree: cKDTree, anchors: np.ndarray,
                        labels: np.ndarray, radius: float, n_class: int):
    """Keep anchors with >= 1 point inside; label each with the multi-hot of
    its member points' classes."""
    clean_anchors = []
    anchors_dict: Dict[int, list] = {}
    anchor_lbs: Dict[int, np.ndarray] = {}
    cc = 0
    for anchor, inds in zip(anchors, query_radius(input_tree, anchors,
                                                  radius)):
        if inds.shape[0] > 0:
            clean_anchors.append(anchor)
            anchors_dict[cc] = [[inds], [anchor]]
            multi_hot = np.zeros(n_class)
            multi_hot[np.unique(labels[inds]).astype(int)] = 1
            anchor_lbs[cc] = multi_hot.astype(int)
            cc += 1
    clean_anchors = np.array(clean_anchors)
    return clean_anchors, cKDTree(clean_anchors), anchors_dict, anchor_lbs


def update_anchors(input_tree: cKDTree, clean_anchors: np.ndarray,
                   anchor_tree: cKDTree, anchors_dict: Dict,
                   anchor_lbs: Dict, sub_radius: float):
    """Add an intersection anchor for each overlapping pair with differing
    labels (label = AND of the pair)."""
    cc = len(anchors_dict)
    points = np.asarray(input_tree.data)

    nei_idx = query_radius(anchor_tree, clean_anchors, 1.5 * sub_radius)
    new_anchors = []
    for idx, row in enumerate(nei_idx):
        i_idxs = anchors_dict[idx][0][0]
        for nei in row[row > idx]:
            overlap = np.isin(i_idxs, anchors_dict[nei][0][0])
            if overlap.sum() < 1:
                continue
            if (anchor_lbs[idx] != anchor_lbs[nei]).sum() > 0:
                new_idxs = i_idxs[overlap]
                new_anchor = np.mean(points[new_idxs], axis=0)
                anchors_dict[cc] = [[new_idxs], [new_anchor]]
                anchor_lbs[cc] = (anchor_lbs[idx] * anchor_lbs[nei]).astype(
                    int)
                new_anchors.append(new_anchor)
                cc += 1
    if new_anchors:
        clean_anchors = np.vstack([clean_anchors, np.stack(new_anchors)])
    return clean_anchors, cKDTree(clean_anchors), anchors_dict, anchor_lbs


def select_anchors(anchor: np.ndarray, anchors_dict: Dict, anchor_lb: Dict,
                   anchor_inds_sub: Sequence[int]):
    """Restrict anchors to the given (full-set) indices."""
    anchor_sub = anchor[np.asarray(anchor_inds_sub)]
    anchors_dict_sub = {}
    anchor_lb_sub = {}
    for idx, a_ind in enumerate(anchor_inds_sub):
        anchors_dict_sub[idx] = anchors_dict[a_ind]
        anchor_lb_sub[idx] = anchor_lb[a_ind]
    return anchor_sub, cKDTree(anchor_sub), anchors_dict_sub, anchor_lb_sub


def subsample_anchors(anchor: np.ndarray, anchors_dict: Dict,
                      anchor_lb: Dict, anchor_count: int,
                      subsample_method: str, rng: random.Random):
    """The initial active-learning anchor budget per file.

    'regular': evenly spaced indices; 'random': uniform with replacement;
    'balanced': per-class round-robin over up to 4 passes, the remainder
    drawn from `rng`. Returns (anchor_sub, tree, dict, lbs,
    chosen_full_set_indices).
    """
    if anchor_count > len(anchor_lb):
        raise ValueError(
            f"Selected anchor count ({anchor_count}) exceeds the number of "
            f"anchors ({len(anchor_lb)})!")

    if subsample_method == "regular":
        anchor_inds_sub = list(np.round(
            np.linspace(0, anchor.shape[0] - 1, anchor_count)).astype(int))
    elif subsample_method == "random":
        pool = list(range(len(anchor_lb)))
        anchor_inds_sub = sorted(rng.choices(pool, k=anchor_count))
    elif subsample_method == "balanced":
        pool = list(range(len(anchor_lb)))
        anchor_inds_sub: List[int] = []
        remaining = anchor_count
        n_class = len(anchor_lb[0])
        for _ in range(4):
            class_members = {label: [] for label in range(n_class)}
            for key in pool:
                for cls in np.where(anchor_lb[key] == 1)[0]:
                    class_members[cls].append(key)
            per_class = int(remaining / n_class)
            to_add: List[int] = []
            for members in class_members.values():
                if len(members) >= per_class:
                    ids = np.round(np.linspace(
                        0, len(members) - 1, per_class)).astype(int)
                    to_add += [members[i] for i in ids]
                else:
                    to_add += members
            to_add = list(set(to_add))
            anchor_inds_sub += to_add
            for ind in to_add:
                pool.remove(ind)
            remaining = anchor_count - len(anchor_inds_sub)
            if remaining < n_class:
                break
        anchor_inds_sub += rng.choices(pool, k=remaining)
        anchor_inds_sub = sorted(anchor_inds_sub)
    else:
        raise ValueError(
            f'Subsample method "{subsample_method}" is not supported!')

    sub = select_anchors(anchor, anchors_dict, anchor_lb, anchor_inds_sub)
    return (*sub, anchor_inds_sub)
