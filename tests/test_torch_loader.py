"""The port's batch packing (weasal_tpu_torch/data/loader.py) against the
JAX package's (weasal_tpu/data/loader.py:84-144), on the CPU.

One scripted source feeds both prefetchers the same batches: numpy arrays
whose values name the batch, metas tagged with a size bucket, some without
regions, which `keep_fn` drops before packing. The port must emit the same
packs in the same order with the same metas: a full pack equal to JAX's,
a tail pack equal to the real rows of JAX's padded one (the port pads
nothing: its trainer runs a tail one step a replay), no pack mixing
buckets. Exact equality; no JAX computation runs.
"""

import numpy as np
import pytest
import torch

from weasal_tpu.data.loader import BatchPrefetcher as JaxPrefetcher
from weasal_tpu_torch.data.loader import BatchPrefetcher


class ScriptedSource:
    """next_batch draws a bucket and a has-regions flag from the rng and
    returns arrays that name the batch by its draw count."""

    def __init__(self, bucketed: bool):
        self.bucketed = bucketed
        self.count = 0

    def next_batch(self, rng, *args, augment=None, **kwargs):
        i = self.count
        self.count += 1
        small = self.bucketed and rng.random() < 0.4
        regions = rng.random() < 0.8
        batch = {"points": np.full((2, 5, 3), i, np.float32),
                 "noise_seed": np.array([i, i + 1], np.uint32)}
        metas = [dict(index=i, has_regions=regions,
                      bucket="small" if small else "large")] * 2
        return batch, metas


def _keep(metas):
    return any(m["has_regions"] for m in metas)


def _packs(cls, pack, bucketed, keep, **kwargs):
    source = ScriptedSource(bucketed)
    return list(cls(source, num_batches=29, rng=np.random.default_rng(5),
                    pack=pack, keep_fn=_keep if keep else None, **kwargs))


@pytest.mark.parametrize("keep", [False, True], ids=["all", "keep_fn"])
@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["one_bucket", "buckets"])
@pytest.mark.parametrize("pack", [1, 3, 4])
def test_packs_equal_jax(pack, bucketed, keep):
    ours = _packs(BatchPrefetcher, pack, bucketed, keep, device="cpu")
    theirs = _packs(JaxPrefetcher, pack, bucketed, keep, plan=None,
                    to_device=False)
    assert len(ours) == len(theirs) > 0
    tails = 0
    for (batch, metas), (jbatch, jmetas) in zip(ours, theirs):
        if pack == 1:
            # JAX's pack=1 yields single batches; the port's a pack of one
            jbatch = {k: v[None] for k, v in jbatch.items()}
            jbatch["do_step"], jmetas = np.ones(1, bool), [jmetas]
        assert metas == jmetas
        n = int(jbatch["do_step"].sum())
        assert n == len(metas) == batch["points"].shape[0] <= pack
        tails += n < pack
        assert set(batch) == set(jbatch) - {"do_step"}
        for key, value in batch.items():
            assert isinstance(value, torch.Tensor)
            want = jbatch[key][:n]
            if want.dtype == np.uint32:          # shipped as int64
                want = want.astype(np.int64)
            np.testing.assert_array_equal(value.numpy(), want)
        assert len({m[0]["bucket"] for m in metas}) == 1
    if pack > 1:
        assert tails >= 1                       # a tail pack was checked
