"""Voting inference and the active-learning acquisitions of both stages.

Counterpart of `ModelTester` in weasal_tpu/train/tester.py:37-534 on one
device, in weak mode ('weak' = KPFCNN_mprm) and pseudo mode ('pseudo' =
KPFCNN), after the reference's ModelTesterWL
(utils/tester_WeakLabel.py): spheres are drawn by minimum
potential (rng `default_rng(11)`, augmented, as the reference's test
loaders augment) until every point has been voted on `num_votes` times;
each sphere's softmax probabilities are smoothed into full-cloud buffers
(factor 0.95), only at points whose augmented coordinates lie within
0.7 * in_radius of the sphere's center; the final probabilities are
projected onto the split's points and written as prediction, probability
and potential plys plus pickles, or, in an active-learning pass, extend
every training cloud's ledger by `added_labels_per_epoch`: in weak mode
the unused anchors of its anchor ledger
(`<cloud>_subsampled_anchors.pkl`) ranked by entropy x class rarity, in
pseudo mode the unused points of its ground-truth ledger
(`<cloud>_al_groundTruth_IDs.pkl`, `_extend_gt_ledger`, :500-534)
ranked by entropy x exp(class weight of the predicted class); with
`al_acquisition = "random"` either at random.

The checkpoint is the port's own `torch.save` file
(train/trainer.ModelTrainer.save_checkpoint), the JAX package's `.tar` or
the reference's torch file (utils/checkpoint.py). On a CUDA device with the
resident input each vote batch replays a captured CUDA graph of
`infer.eval_body` (train/graphs.EvalGraph), and the vote update runs
eagerly on the card (train/vote.DeviceVoteAccumulator with the `d2`
mask); elsewhere the same body runs eagerly on level-0 batches and the
votes are smoothed on the host, as the JAX package's host branch does.
A vote checkpoint (`vote_chkp_<split>.pkl`) at every vote boundary lets
`resume=True` continue an interrupted pass; a stall watchdog guards the
loop on the card. Not ported: the confusion plot (`conf_matrix.plot`,
:432; matplotlib), whose counts are written as text instead;
data-parallel voting.
"""

from __future__ import annotations

import os
import pickle
import time
from os.path import join
from typing import Optional

import numpy as np
import torch

from weasal_tpu_torch.data.level0 import Level0BatchSource
from weasal_tpu_torch.data.loader import BatchPrefetcher
from weasal_tpu_torch.data.resident import ResidentBatchSource, feature_spec
from weasal_tpu_torch.infer import eval_body
from weasal_tpu_torch.models.architectures import model_for_config
from weasal_tpu_torch.train.graphs import EvalGraph
from weasal_tpu_torch.train.trainer import resolve_resident
from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
from weasal_tpu_torch.utils.checkpoint import load_checkpoint_file
from weasal_tpu_torch.utils.device import configure_precision, resolve_device
from weasal_tpu_torch.utils.metrics import IoU_from_confusions, fast_confusion
from weasal_tpu_torch.utils.ply import write_ply
from weasal_tpu_torch.utils.watchdog import StallWatchdog

TEST_SMOOTH = 0.95
TEST_RADIUS_RATIO = 0.7


class ModelTester:
    """Votes a trained model over a dataset's clouds.

    :param config: the trained model's configuration
    :param dataset: the split to vote on (its shape plan is the
        training's: calibration reads the same cache)
    :param chkp_path: a checkpoint of any format `load_checkpoint_file`
        reads (the port's, the JAX package's `.tar`, the reference's)
    :param mode: 'weak' or 'pseudo' (default: the stage of the model that
        `config.model_name` builds; another raises)
    :param device: default ``cuda``; raises where CUDA is absent

    On a CUDA device with the resident input each vote batch replays a
    captured graph; elsewhere the same body runs eagerly.
    """

    def __init__(self, config, dataset, chkp_path: str,
                 mode: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        configure_precision()
        self.config = config
        self.model = model_for_config(
            config, dataset.label_values, dataset.ignored_labels,
            generator=torch.Generator().manual_seed(0)).to(self.device)
        self.mode = mode or self.model.mode
        if self.model.mode != self.mode:
            raise ValueError(f"mode {self.mode!r} does not vote with a "
                             f"{type(self.model).__name__}")
        self.plan = dataset.calibration()
        payload = load_checkpoint_file(chkp_path)
        self.model.load_state_dict(payload["model_state_dict"])
        self.model.eval()
        self.epoch = payload["epoch"]
        print("Model and training state restored.")
        self.resident = resolve_resident(
            getattr(config, "resident_clouds", "auto"), self.device)
        self.spec = feature_spec(dataset.name, config.in_features_dim)
        self.graphed = self.device.type == "cuda" and self.resident
        self._eval_graph: Optional[EvalGraph] = None
        # Per vote pass: batches, seconds, voted points (real points of
        # the batches), for callers that report the pass's speed
        self.vote_times: list = []

    # ------------------------------------------------------------------

    def _runner(self, pack, extra) -> EvalGraph:
        if self._eval_graph is None:
            config, plan, spec = self.config, self.plan, self.spec

            def body(inputs, out):
                return eval_body(self.model, inputs, config, plan,
                                 self.device, spec=spec, out=out)

            self._eval_graph = EvalGraph("vote batch", body, pack,
                                         self.device, extra=extra,
                                         graphed=self.graphed)
        return self._eval_graph

    def vote_parts(self, dataset):
        """(batch source, resident tensors or None, vote accumulator or
        None) of a vote pass over `dataset`."""
        r_sq = None
        if 0 < TEST_RADIUS_RATIO < 1:
            r_sq = (TEST_RADIUS_RATIO * self.config.in_radius) ** 2
        if self.resident:
            source = ResidentBatchSource(dataset, self.plan, self.device)
            acc = DeviceVoteAccumulator(source.resident,
                                        self.config.num_classes,
                                        smooth=TEST_SMOOTH, radius_sq=r_sq)
            return source, source.resident.arrays, acc
        return Level0BatchSource(dataset, self.plan), None, None

    def cloud_segmentation_test(self, dataset, num_votes: int = 100,
                                active_learning: bool = False,
                                test_on_train: bool = False,
                                stage_dir: str = "WeakLabel",
                                resume: bool = False):
        """Vote until the minimum potential passes `num_votes`; returns
        the per-cloud probabilities (subsampled clouds)."""
        config = self.config
        nc_model = config.num_classes
        rng = np.random.default_rng(11)

        if dataset.split == "ERF":
            raise ValueError("cloud_segmentation_test cannot vote on the "
                             "'ERF' split: its potentials never advance.")

        self.test_probs = [np.zeros((l.shape[0], nc_model))
                           for l in dataset.input_labels]

        test_path = None
        if not active_learning and config.saving:
            test_path = join(f"test/{stage_dir}",
                             config.saving_path.split("/")[-1])
            for sub in ("", "predictions", "probs", "potentials"):
                os.makedirs(join(test_path, sub), exist_ok=True)

        if dataset.split == "validation":
            val_proportions = np.zeros(nc_model, np.float32)
            i = 0
            for label_value in dataset.label_values:
                if label_value not in dataset.ignored_labels:
                    val_proportions[i] = np.sum(
                        [np.sum(lbl == label_value)
                         for lbl in dataset.validation_labels])
                    i += 1

        test_epoch = 0
        last_min = -0.5
        t_last = time.time()
        watchdog = StallWatchdog.from_config(config, f"vote[{self.mode}]",
                                             self.device)
        source, extra, vote_acc = self.vote_parts(dataset)
        r_sq = (TEST_RADIUS_RATIO * config.in_radius) ** 2

        chkp_file = None
        if not active_learning and getattr(config, "saving", False) \
                and config.saving_path:
            tag = "train" if test_on_train else dataset.split
            os.makedirs(config.saving_path, exist_ok=True)
            chkp_file = join(config.saving_path, f"vote_chkp_{tag}.pkl")
            if resume and os.path.exists(chkp_file):
                with open(chkp_file, "rb") as f:
                    vc = pickle.load(f)
                self.test_probs = vc["test_probs"]
                if vote_acc is not None:
                    vote_acc.load(self.test_probs)
                dataset.potentials = vc["potentials"]
                dataset.min_potentials = vc["min_potentials"]
                dataset.argmin_potentials = vc["argmin_potentials"]
                rng.bit_generator.state = vc["rng_state"]
                test_epoch = vc["test_epoch"]
                last_min = vc["last_min"]
                print(f"Vote resumed at epoch {test_epoch}, min potential "
                      f"{dataset.min_potential():.1f}")
            elif os.path.exists(chkp_file):
                # stale state of an earlier run of this log
                os.remove(chkp_file)

        t_pass = time.perf_counter()
        n_batches = n_points = 0
        try:
            while True:
                prefetcher = BatchPrefetcher(source, config.validation_size,
                                             self.device, rng=rng,
                                             augment=True, pack=1)
                for i, (pack, metas) in enumerate(prefetcher):
                    runner = self._runner(pack, extra)
                    runner.load(pack)
                    runner.run()
                    out = runner.out
                    n_batches += 1
                    n_points += sum(m["n_real"] for m in metas[0])
                    if vote_acc is not None:
                        vote_acc.update(out["probs"], runner.slots[0],
                                        d2=out["d2"])
                    else:
                        probs_all = np.array(out["probs"].cpu())
                        d2_all = np.array(out["d2"].cpu())
                        for b, meta in enumerate(metas[0]):
                            n = meta["n_real"]
                            probs = probs_all[b, :n]
                            inds = meta["input_inds"][:n]
                            if 0 < TEST_RADIUS_RATIO < 1:
                                inside = d2_all[b, :n] < r_sq
                                inds = inds[inside]
                                probs = probs[inside]
                            c_i = meta["cloud_ind"]
                            self.test_probs[c_i][inds] = \
                                TEST_SMOOTH * self.test_probs[c_i][inds] \
                                + (1 - TEST_SMOOTH) * probs
                    watchdog.beat()
                    if time.time() - t_last > 1.0:
                        t_last = time.time()
                        print(f"e{test_epoch:03d}-i{i:04d} => "
                              f"{100 * i / config.validation_size:.0f}%")

                new_min = dataset.min_potential()
                print(f"Test epoch {test_epoch}, end. "
                      f"Min potential = {new_min:.1f}")
                watchdog.beat()

                if last_min + 1 < new_min:
                    last_min += 1
                    if vote_acc is not None:
                        self.test_probs = vote_acc.materialize()
                        watchdog.beat()

                    if chkp_file is not None:
                        tmp = chkp_file + ".tmp"
                        with open(tmp, "wb") as f:
                            pickle.dump(dict(
                                test_probs=self.test_probs,
                                potentials=dataset.potentials,
                                min_potentials=dataset.min_potentials,
                                argmin_potentials=dataset.argmin_potentials,
                                rng_state=rng.bit_generator.state,
                                test_epoch=test_epoch + 1,
                                last_min=last_min), f)
                        os.replace(tmp, chkp_file)

                    if dataset.split == "validation":
                        self._subcloud_confusion(dataset, val_proportions)

                    if last_min > num_votes:
                        self.vote_times.append(dict(
                            batches=n_batches, points=n_points,
                            seconds=time.perf_counter() - t_pass))
                        self._finish(dataset, active_learning, test_path,
                                     test_on_train)

                test_epoch += 1
                if last_min > num_votes:
                    break
        finally:
            watchdog.stop()
        if chkp_file is not None and os.path.exists(chkp_file):
            os.remove(chkp_file)
        return self.test_probs

    def _finish(self, dataset, active_learning, test_path, test_on_train):
        """The pass's outputs: pickles and plys, or the AL acquisition."""
        all_pseudo_lbs, all_probs = {}, {}
        proj_probs = []
        for i, file_path in enumerate(dataset.files):
            proj_probs.append(self.test_probs[i][dataset.test_proj[i], :])
            fn = file_path.split("/")[-1].split(".txt")[0]
            all_probs[fn] = self.test_probs[i]
            all_pseudo_lbs[fn] = np.argmax(self.test_probs[i], axis=1)
        if not active_learning:
            if test_path is not None:
                with open(join(test_path, "_pseudo.pickle"), "wb") as f:
                    pickle.dump(all_pseudo_lbs, f)
                with open(join(test_path, "_probs.pickle"), "wb") as f:
                    pickle.dump(all_probs, f)
                self._save_clouds(dataset, proj_probs, test_path,
                                  test_on_train)
        elif self.mode == "weak":
            self._extend_anchor_ledger(dataset, all_probs, all_pseudo_lbs)
        else:
            self._extend_gt_ledger(dataset, all_probs)

    # ------------------------------------------------------------------

    def _subcloud_confusion(self, dataset, val_proportions):
        label_values = dataset.label_values
        confs = []
        for i in range(len(dataset.files)):
            probs = np.array(self.test_probs[i], copy=True)
            for l_ind, label_value in enumerate(label_values):
                if label_value in dataset.ignored_labels:
                    probs = np.insert(probs, l_ind, 0, axis=1)
            preds = label_values[np.argmax(probs, axis=1)].astype(np.int32)
            confs.append(fast_confusion(dataset.input_labels[i], preds,
                                        label_values))
        C = np.sum(np.stack(confs), axis=0).astype(np.float32)
        for l_ind, label_value in reversed(list(enumerate(label_values))):
            if label_value in dataset.ignored_labels:
                C = np.delete(C, l_ind, axis=0)
                C = np.delete(C, l_ind, axis=1)
        C *= np.expand_dims(
            val_proportions / (np.sum(C, axis=1) + 1e-6), 1)
        IoUs = IoU_from_confusions(C)
        print("Sub-cloud mIoU = {:.2f} | ".format(100 * np.mean(IoUs))
              + " ".join(f"{100 * v:.2f}" for v in IoUs))

    def _save_clouds(self, dataset, proj_probs, test_path, test_on_train):
        """Prediction, probability and potential plys of every cloud;
        the summed confusion goes to predictions/conf_<name>.txt."""
        label_values = dataset.label_values
        n_show = len(label_values) - len(dataset.ignored_labels)
        confs = np.zeros((len(label_values), len(label_values)), np.int32)
        for i, file_path in enumerate(dataset.files):
            points = dataset.load_evaluation_points(file_path)
            if hasattr(dataset, "coord_offset"):
                points = points + dataset.coord_offset
            pp = proj_probs[i]
            for l_ind, label_value in enumerate(label_values):
                if label_value in dataset.ignored_labels:
                    pp = np.insert(pp, l_ind, 0, axis=1)
            preds = label_values[np.argmax(pp, axis=1)].astype(np.int32)
            targets = dataset.validation_labels[i].astype(np.int32)
            error_map = (preds != targets).astype(np.int8)
            cloud_name = file_path.split("/")[-1]
            write_ply(join(test_path, "predictions", cloud_name),
                      [points.astype(np.float32), preds, targets, error_map],
                      ["x", "y", "z", "preds", "targets", "error"])
            prob_names = ["_".join(dataset.label_to_names[label].split())
                          for label in label_values
                          if label not in dataset.ignored_labels]
            write_ply(join(test_path, "probs", cloud_name),
                      [points.astype(np.float32),
                       proj_probs[i].astype(np.float32)],
                      ["x", "y", "z"] + prob_names)
            pot_points = np.asarray(dataset.pot_trees[i].data)
            pots = dataset.potentials[i].astype(np.float32)
            write_ply(join(test_path, "potentials", cloud_name),
                      [pot_points.astype(np.float32), pots],
                      ["x", "y", "z", "pots"])
            confs += fast_confusion(targets, preds, label_values).astype(
                np.int32)
        cm_name = dataset.name + ("_train" if test_on_train
                                  else "_" + dataset.split)
        np.savetxt(join(test_path, "predictions", f"conf_{cm_name}.txt"),
                   confs[:n_show, :n_show], fmt="%i")

    # ------------------------------------------------------------------
    # Active learning: extend the anchor ledgers
    # ------------------------------------------------------------------

    def _extend_anchor_ledger(self, dataset, all_probs, all_pseudo_lbs):
        """Add `added_labels_per_epoch` unused anchors per training file,
        ranked by entropy x class rarity (the reference policy,
        tester_WeakLabel.py:403-474) or, with `al_acquisition` "random",
        in a permutation seeded by (ledger size, file, 913)."""
        config = self.config
        random_arm = getattr(config, "al_acquisition",
                             "entropy") == "random"
        for i, cloud_name in enumerate(dataset.cloud_names_split):
            key = cloud_name + ".ply"
            probs = all_probs[key]
            entropy = -np.sum(probs * np.log2(probs + 1e-12), axis=1)

            anchors_file = join(
                dataset.tree_path,
                f"{cloud_name}_anchors_{config.anchor_method}.pkl")
            with open(anchors_file, "rb") as f:
                _anchor, anchors_dict, anchor_lb = pickle.load(f)
            sub_file = join(dataset.tree_path,
                            f"{cloud_name}_subsampled_anchors.pkl")
            with open(sub_file, "rb") as f:
                anchor_inds_sub = pickle.load(f)

            if random_arm:
                r = np.random.default_rng([len(anchor_inds_sub), i, 913])
                sort_ids = r.permutation(len(anchors_dict))
            else:
                label_sum = np.zeros(np.size(anchor_lb[0]), dtype=np.int64)
                for label in anchor_inds_sub:
                    label_sum += anchor_lb[label]
                class_scores = np.exp(-label_sum / len(anchor_inds_sub))
                scores = np.zeros(len(anchors_dict), np.float32)
                pseudo = all_pseudo_lbs[key]
                for a in anchors_dict:
                    pt_ids = np.squeeze(anchors_dict[a][0])
                    weak_pred = np.zeros(np.size(anchor_lb[0]),
                                         dtype=np.int64)
                    weak_pred[np.unique(pseudo[pt_ids])] = 1
                    scores[a] = np.mean(entropy[pt_ids]) * (
                        weak_pred @ class_scores)
                sort_ids = np.argsort(-scores)
            used = set(int(u) for u in anchor_inds_sub)
            sort_ids = np.array([s for s in sort_ids if s not in used])
            n_add = config.added_labels_per_epoch
            if len(sort_ids) < n_add:
                raise ValueError(
                    "Not enough weak labels left for the next iteration")
            anchor_inds_sub = np.append(anchor_inds_sub, sort_ids[:n_add])
            with open(sub_file, "wb") as f:
                pickle.dump(anchor_inds_sub, f)
            print(f"{cloud_name}: anchor ledger -> "
                  f"{len(anchor_inds_sub)} anchors")

    def _extend_gt_ledger(self, dataset, all_probs):
        """Add `added_labels_per_epoch` points per training file to its
        ground-truth ledger, ranked by entropy x exp(class weight of the
        predicted class) (the reference policy) or, with `al_acquisition`
        "random", in a permutation seeded by (ledger size, file, 913)."""
        config = self.config
        random_arm = getattr(config, "al_acquisition",
                             "entropy") == "random"
        for i, cloud_name in enumerate(dataset.cloud_names_split):
            probs = all_probs[cloud_name + ".ply"]
            gt_file = dataset.gt_ledger_file(cloud_name)
            with open(gt_file, "rb") as f:
                gt_ids = np.asarray(pickle.load(f), dtype=np.int64)
            used = np.zeros(probs.shape[0], bool)
            used[gt_ids.ravel()] = True
            if random_arm:
                r = np.random.default_rng([int(used.sum()), i, 913])
                sort_ids = r.permutation(probs.shape[0])
            else:
                entropy = -np.sum(probs * np.log2(probs + 1e-12), axis=1)
                class_w = np.asarray(config.class_w, np.float64)
                combined = entropy * np.exp(class_w[np.argmax(probs,
                                                              axis=1)])
                sort_ids = np.argsort(-combined)
            sort_ids = sort_ids[~used[sort_ids]]
            n_add = config.added_labels_per_epoch
            if len(sort_ids) < n_add:
                raise ValueError(
                    "Not enough point labels left for the next iteration")
            gt_ids = np.append(gt_ids, sort_ids[:n_add]).astype(np.int64)
            with open(gt_file, "wb") as f:
                pickle.dump(gt_ids, f)
            print(f"{cloud_name}: GT ledger -> {len(gt_ids)} points")
