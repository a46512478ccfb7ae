"""Helper of the port's dataset and loop parity tests (not collected: no
test_ prefix).

The JAX package's datasets differ from the port's in three places that are
not semantics, and `jax_dataset_patches` removes them for a comparison:
- sklearn's `KDTree.query_radius` returns rows in its tree's order; the
  port sorts each row. `SortedKDTree` sorts them the same way. It lives
  in this importable module so that the JAX package's cache pickles of it
  load again.
- `subsample_anchors` draws from an unseeded `random.Random()`; the port
  from `random.Random(ANCHOR_SEED)`.
- each package's host subsample and fixed-width radius search run its
  own native C++ library where it is built, else numpy / scipy; the
  patch makes the JAX package's choice the port's, so that both sides
  run native code (the same source) or both run numpy and scipy.
"""

import contextlib
import random
import types

import numpy as np
import pytest
from sklearn.neighbors import KDTree

from weasal_tpu.data import anchors as jax_anchors
from weasal_tpu.data import datasets as jax_datasets
from weasal_tpu.ops import native as jax_native
from weasal_tpu_torch.config import Config as PortConfig
from weasal_tpu_torch.data.datasets import ANCHOR_SEED
from weasal_tpu_torch.ops import native as port_native
from tests.test_datasets import SynthWLConfig

# Scene of the parity tests: extent 30 m, density 5 points / m^2
EXTENT, DENSITY, SCENE_SEED = 30.0, 5.0, 11
POTENTIAL_SEED = 0


class SortedKDTree(KDTree):
    """sklearn KDTree whose `query_radius` rows come sorted ascending."""

    def query_radius(self, X, r, return_distance=False, **kwargs):
        out = super().query_radius(X, r, return_distance=return_distance,
                                   **kwargs)
        if return_distance:
            ind, dist = out
            for i in range(len(ind)):
                order = np.argsort(ind[i], kind="stable")
                ind[i], dist[i] = ind[i][order], dist[i][order]
            return ind, dist
        for i in range(len(out)):
            out[i] = np.sort(out[i])
        return out


class JaxSynthConfig(SynthWLConfig):
    """tests/test_datasets.py geometry (in_radius 8, dl 0.4, sub_radius
    3), with the initial label budget subsampled."""
    subsample_labels = True
    initial_labels_per_file = 30


def port_config_class(**overrides):
    """A port Config subclass holding the class attributes that
    JaxSynthConfig and its test bases set over the JAX package's base
    Config, then `overrides`."""
    from weasal_tpu.config import Config as JaxConfig
    attrs = {}
    for cls in reversed(JaxSynthConfig.__mro__):
        if cls in (object, JaxConfig) or not issubclass(cls, JaxConfig):
            continue
        attrs.update({k: v for k, v in vars(cls).items()
                      if not k.startswith("_") and not callable(v)})
    attrs.update(overrides)
    return type("PortSynthConfig", (PortConfig,), attrs)


@contextlib.contextmanager
def jax_dataset_patches():
    """Sorted KD rows, a seeded anchor generator and the port's choice of
    native or numpy geometry for the JAX package's datasets, undone on
    exit."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_datasets, "KDTree", SortedKDTree)
        mp.setattr(jax_anchors, "KDTree", SortedKDTree)
        mp.setattr(jax_anchors, "random", types.SimpleNamespace(
            Random=lambda: random.Random(ANCHOR_SEED)))
        mp.setattr(jax_native, "available", port_native.available)
        yield
    finally:
        mp.undo()


def make_roots(tmp_path_factory, name):
    """(JAX root, port root): the same synthetic scene written by each
    package into a root of its own."""
    from weasal_tpu.data.synthetic import make_vaihingen_like_root as jax_make
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    base = tmp_path_factory.mktemp(name)
    jroot = str(base / "jax" / "Vaihingen3D")
    proot = str(base / "port" / "Vaihingen3D")
    jax_make(jroot, extent=EXTENT, density=DENSITY, seed=SCENE_SEED)
    make_vaihingen_like_root(proot, extent=EXTENT, density=DENSITY,
                             seed=SCENE_SEED)
    return jroot, proot


def jax_datasets_for(config, root, splits=("training", "validation")):
    with jax_dataset_patches():
        return [jax_datasets.Vaihingen3DWLDataset(
            config, split=s, data_root=root,
            rng=np.random.default_rng(POTENTIAL_SEED)) for s in splits]


def port_datasets_for(config, root, splits=("training", "validation")):
    from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
    return [Vaihingen3DWLDataset(config, split=s, data_root=root,
                                 rng=np.random.default_rng(POTENTIAL_SEED))
            for s in splits]
