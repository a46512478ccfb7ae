"""Weak-label training loop: sampling, steps, logs, checkpoints and
per-epoch validation.

Counterpart of `ModelTrainer` in weasal_tpu/train/trainer.py on its fused
path (the pyramid built on the device), weak mode, one device, one step
per dispatch: `__init__` (:121-233), `save_checkpoint` and
`load_checkpoint` (:535-577), `train` (:582-957), `_flush_log`
(:1000-1024) and `cloud_segmentation_validation` (:1031-1171). The
artifacts are the JAX package's: `parameters.txt`,
`training_iteration{al}.txt` rows `epoch step out_loss offset_loss
train_accuracy time`, `val_IoUs.txt`, the potentials plys, `conf.txt`
every `checkpoint_gap` epochs, the `running_PID.txt` kill file and
`checkpoints/current_chkp.tar` with `chkp_XXXX_{al}.tar`, here written
by `torch.save`.

The input is the resident one (data/resident.py) when
`config.resident_clouds` resolves on ("auto": on a CUDA device), else
level-0 arrays (data/level0.py); either way a producer thread samples
ahead of the steps (data/loader.py). Nothing in the loop waits for the
card per step: losses stay on the device until `_flush_log` (every 20
steps or 2 s), the skip of batches without regions reads host metas, and
validation keeps its argmax and labels on the device and fetches them
once. The port's kernels drop no neighbor, so the drop vector of each
step is zero; each epoch sums it and a non-zero sum raises, where the
JAX package would widen its band windows.
"""

from __future__ import annotations

import os
import time
from os.path import exists, join
from typing import Dict, List, Optional

import numpy as np
import torch

from weasal_tpu_torch.data.level0 import Level0BatchSource
from weasal_tpu_torch.data.loader import BatchPrefetcher
from weasal_tpu_torch.data.resident import ResidentBatchSource, feature_spec
from weasal_tpu_torch.infer import eval_batch
from weasal_tpu_torch.models.architectures import KPFCNN_mprm
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.step import class_weights, label_table, train_step
from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
from weasal_tpu_torch.utils.device import configure_precision, resolve_device
from weasal_tpu_torch.utils.metrics import IoU_from_confusions, fast_confusion
from weasal_tpu_torch.utils.ply import write_ply


def resolve_resident(value, device: torch.device) -> bool:
    """`config.resident_clouds`: True/False, or "auto" = on for CUDA."""
    if value == "auto":
        return device.type == "cuda"
    if isinstance(value, bool):
        return value
    raise ValueError(f"resident_clouds must be 'auto' or a bool, not "
                     f"{value!r}")


class ModelTrainer:
    """Drives the weak-label training of one active-learning iteration.

    :param dataset: the training dataset (labels and shape plan)
    :param chkp_path: checkpoint to restore (None = fresh)
    :param finetune: restore the weights only (not the epoch or momentum)
    :param device: default ``cuda``; raises where CUDA is absent
    :param generator: the torch.Generator of the initial weights (default
        seed 0)
    """

    def __init__(self, config, dataset, chkp_path: Optional[str] = None,
                 finetune: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        configure_precision()
        self.config = config
        self.epoch = 0
        self.step = 0
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = KPFCNN_mprm(
            config, tuple(int(v) for v in dataset.label_values),
            tuple(int(v) for v in dataset.ignored_labels),
            generator=generator).to(self.device)
        self.opt_state = init_opt_state(self.model)
        self.table = label_table(self.model, self.device)
        self.class_w = class_weights(config, self.device)
        t0 = time.perf_counter()
        self.plan = dataset.calibration()
        self.calibration_seconds = time.perf_counter() - t0
        self.resident = resolve_resident(
            getattr(config, "resident_clouds", "auto"), self.device)
        self.spec = feature_spec(dataset.name, config.in_features_dim)

        # The JAX trainer initializes its model on one example batch
        # (trainer.py:175-176), which moves the potentials by batch_num
        # spheres: make the same draws, so that every later sphere is the
        # same in both packages
        rng = np.random.default_rng(0)
        for _ in range(config.batch_num):
            dataset.sample_sphere(rng, augment=True,
                                  max_points=self.plan.num_points[0])
        self.lr = config.learning_rate

        if chkp_path is not None:
            self.load_checkpoint(chkp_path, finetune=finetune)

        if config.saving:
            if config.saving_path is None:
                config.saving_path = time.strftime(
                    "results/WeakLabel/Log_%Y-%m-%d_%H-%M-%S", time.gmtime())
            os.makedirs(config.saving_path, exist_ok=True)
            config.save()
        # Per epoch: host-clock seconds, real steps and their real level-0
        # points, the neighbor drops; per validation: seconds and batches.
        # For callers that report the loop's speed.
        self.epoch_times: List[Dict] = []
        self.epoch_drops: List[float] = []
        self.val_times: List[Dict] = []

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, directory: str, name: str = "current_chkp.tar"):
        """torch.save of the epoch, the model's state (parameters,
        BatchNorm statistics, kernel points), the momentum buffers and
        the saving path; written to a temporary file and renamed, so a
        crash never leaves a torn checkpoint."""
        os.makedirs(directory, exist_ok=True)
        payload = {
            "epoch": self.epoch,
            "model_state_dict": self.model.state_dict(),
            "optimizer_state_dict": self.opt_state,
            "saving_path": self.config.saving_path,
        }
        target = join(directory, name)
        tmp = target + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)

    def load_checkpoint(self, path: str, finetune: bool = False):
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        self.model.load_state_dict(payload["model_state_dict"])
        if not finetune:
            opt = payload["optimizer_state_dict"]
            if set(opt) != set(self.opt_state):
                raise ValueError("checkpoint optimizer state does not match "
                                 "the model's parameters")
            self.opt_state = {k: v.to(self.device) for k, v in opt.items()}
            self.epoch = payload["epoch"]
        print("Model restored" + (" for finetuning." if finetune
                                  else " with training state."))

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def _source(self, dataset):
        """(batch source, resident tensors or None) of a dataset."""
        if self.resident:
            source = ResidentBatchSource(dataset, self.plan, self.device)
            return source, source.resident.arrays
        return Level0BatchSource(dataset, self.plan), None

    def train(self, train_dataset, val_dataset=None, al_iteration: int = 0):
        config = self.config
        self.al_iteration = al_iteration
        rng = np.random.default_rng(42 + al_iteration)

        if config.saving:
            log_file = join(config.saving_path,
                            f"training_iteration{al_iteration}.txt")
            with open(log_file, "w") as f:
                f.write(self._log_header(train_dataset, al_iteration))
            pid_file = join(config.saving_path, "running_PID.txt")
            if not exists(pid_file):
                with open(pid_file, "w") as f:
                    f.write("Launched\n")
            chkp_dir = join(config.saving_path, "checkpoints")
            os.makedirs(chkp_dir, exist_ok=True)
        else:
            log_file = pid_file = chkp_dir = None

        # Per-epoch decayed LR, resuming mid-schedule
        lr = config.learning_rate
        for e in range(self.epoch):
            if e in config.lr_decays:
                lr *= config.lr_decays[e]
        self.lr = lr

        source, extra = self._source(train_dataset)

        # Opt-in breakdown of each epoch's host time (WEASAL_LOOP_STATS=1):
        # waiting for batches, issuing steps, flushing the log
        loop_stats = None
        if os.environ.get("WEASAL_LOOP_STATS"):
            loop_stats = {"wait_batch": 0.0, "dispatch": 0.0, "flush": 0.0}

        t0 = time.time()
        last_display = time.time()
        pending = []
        drops_pending = []
        while self.epoch < config.max_epoch:
            self.step = 0
            epoch_real_steps = 0
            epoch_points = 0
            prefetcher = BatchPrefetcher(source, config.epoch_steps,
                                         self.device, rng=rng,
                                         extra_arrays=extra)
            epoch_t0 = time.perf_counter()
            batch_iter = iter(prefetcher)
            while True:
                tw = time.perf_counter()
                try:
                    batch, metas = next(batch_iter)
                except StopIteration:
                    break
                if loop_stats is not None:
                    loop_stats["wait_batch"] += time.perf_counter() - tw
                if config.saving and pid_file and not exists(pid_file):
                    prefetcher.close()
                    break
                # No sub-region labels -> no loss signal: skip the batch,
                # deciding from host metas (never a read of the device)
                if not any(m["has_regions"] for m in metas):
                    continue
                td = time.perf_counter()
                loss, acc, drops = train_step(
                    self.model, self.opt_state, batch, config, self.plan,
                    self.lr, device=self.device, class_w=self.class_w,
                    table=self.table, spec=self.spec)
                if loop_stats is not None:
                    loop_stats["dispatch"] += time.perf_counter() - td
                drops_pending.append(drops)
                epoch_real_steps += 1
                epoch_points += sum(m["n_real"] for m in metas)
                pending.append((self.epoch, self.step, loss, acc,
                                time.time() - t0))
                self.step += 1
                if len(pending) >= 20 or time.time() - last_display > 2.0:
                    last_display = time.time()
                    tf = time.perf_counter()
                    self._flush_log(pending, log_file, al_iteration)
                    if loop_stats is not None:
                        loop_stats["flush"] += time.perf_counter() - tf
                    pending = []

            tf = time.perf_counter()
            self._flush_log(pending, log_file, al_iteration)
            pending = []
            if loop_stats is not None:
                loop_stats["flush"] += time.perf_counter() - tf
            epoch_s = time.perf_counter() - epoch_t0
            self.epoch_times.append(dict(epoch=self.epoch, seconds=epoch_s,
                                         steps=epoch_real_steps,
                                         points=epoch_points,
                                         **(loop_stats or {})))
            if loop_stats is not None:
                parts = " ".join(f"{k}={v:.2f}s"
                                 for k, v in loop_stats.items())
                n = max(epoch_real_steps, 1)
                print(f"[loop-stats] epoch {self.epoch}: {epoch_s:.2f}s "
                      f"/ {n} steps = {1e3 * epoch_s / n:.1f} ms/step | "
                      f"{parts} other={epoch_s - sum(loop_stats.values()):.2f}s")
                loop_stats = dict.fromkeys(loop_stats, 0.0)

            if config.saving and pid_file and not exists(pid_file):
                break

            if self.epoch in config.lr_decays:
                self.lr *= config.lr_decays[self.epoch]
            self.epoch += 1

            # The port's kernels drop nothing: a non-zero sum is a fault
            epoch_drops = (float(torch.stack(drops_pending).sum())
                           if drops_pending else 0.0)
            drops_pending = []
            self.epoch_drops.append(epoch_drops)
            if epoch_drops != 0.0:
                raise RuntimeError(
                    f"{epoch_drops:g} neighbors dropped in epoch "
                    f"{self.epoch - 1}: the exact kernels must drop none")

            if config.saving:
                self.save_checkpoint(chkp_dir)
                if (self.epoch + 1) % config.checkpoint_gap == 0:
                    self.save_checkpoint(
                        chkp_dir,
                        f"chkp_{self.epoch + 1:04d}_{al_iteration}.tar")

            if val_dataset is not None:
                self.cloud_segmentation_validation(val_dataset)

            # The kill file goes once training completes
            if self.epoch >= config.max_epoch and pid_file and \
                    exists(pid_file):
                os.remove(pid_file)

        if config.saving and not exists(join(chkp_dir, "current_chkp.tar")):
            # Resumed at or after max_epoch: no epoch ran in this run dir,
            # but later stages restore from it
            self.save_checkpoint(chkp_dir)
        if pid_file and exists(pid_file) and self.epoch >= config.max_epoch:
            os.remove(pid_file)

        if getattr(self, "_val_acc", None) is not None:
            self.validation_probs = self._val_acc.materialize()
        print("Finished Training")

    def _log_header(self, train_dataset, al_iteration) -> str:
        cfg = self.config
        n_files = len(train_dataset.cloud_names_split)
        init = (getattr(cfg, "initial_labels_per_file", 0) * n_files
                + al_iteration * getattr(cfg, "added_labels_per_epoch", 0)
                * n_files)
        over = int(np.sum([len(a) for a in train_dataset.anchors]))
        return ("epochs steps out_loss offset_loss train_accuracy time "
                f"\tweak labels (initial): {over} ({init})\n")

    def _flush_log(self, pending, log_file, al_iteration):
        """Fetch the buffered device scalars in one copy and log them."""
        if not pending:
            return
        values = torch.stack([torch.stack([p[2], p[3]]) for p in pending])
        values = values.cpu().numpy().astype(np.float64)
        rows = [(epoch, step, float(ls), 0.0, float(ac), wall)
                for (epoch, step, _, _, wall), (ls, ac) in zip(pending,
                                                               values)]
        if self.config.saving and log_file:
            with open(log_file, "a") as f:
                for epoch, step, ls, rg, ac, wall in rows:
                    f.write(f"{epoch:d} {step:d} {ls:.3f} "
                            f"{rg:.3f} {ac:.3f} "
                            f"{wall:.3f}\n")
        epoch, step, ls, rg, ac, _ = rows[-1]
        print(f"e{epoch:03d}-i{step:04d} => L={ls:.3f} "
              f"acc={100 * ac:3.0f}% "
              f"| al_iteration={al_iteration}")

    # ------------------------------------------------------------------
    # Validation
    # ------------------------------------------------------------------

    def cloud_segmentation_validation(self, val_dataset) -> float:
        """One validation pass of `validation_size` batches: smoothed
        full-cloud probabilities (on the device with resident clouds),
        sub-part confusions rebalanced by class proportions, mIoU.
        Returns the mIoU in percent."""
        config = self.config
        val_smooth = 0.95
        nc_model = config.num_classes
        rng = np.random.default_rng(7 + self.epoch)
        t_start = time.perf_counter()

        if not hasattr(self, "validation_probs") or \
                len(self.validation_probs) != val_dataset.num_clouds:
            self.validation_probs = [
                np.zeros((l.shape[0], nc_model))
                for l in val_dataset.input_labels]
            self.val_proportions = np.zeros(nc_model, np.float32)
            i = 0
            for label_value in val_dataset.label_values:
                if label_value not in val_dataset.ignored_labels:
                    self.val_proportions[i] = np.sum(
                        [np.sum(lbl == label_value)
                         for lbl in val_dataset.validation_labels])
                    i += 1

        val_acc = None
        if self.resident:
            if getattr(self, "_val_source", None) is None or \
                    self._val_source.dataset is not val_dataset:
                self._val_source, _ = self._source(val_dataset)
                self._val_acc = DeviceVoteAccumulator(
                    self._val_source.resident, nc_model, smooth=val_smooth)
                self._val_acc.load(self.validation_probs)
            source = self._val_source
            extra = source.resident.arrays
            val_acc = self._val_acc
        else:
            source, extra = self._source(val_dataset)
        prefetcher = BatchPrefetcher(source, config.validation_size,
                                     self.device, rng=rng, augment=True,
                                     extra_arrays=extra)
        label_values = val_dataset.label_values
        nonign = np.array([li for li, lv in enumerate(label_values)
                           if lv not in val_dataset.ignored_labels])

        predictions, targets = [], []
        n_batches = 0
        if val_acc is not None:
            # Smoothing on the device; argmax and labels stay there and
            # come back in one copy at the end
            buffered, metas_all = [], []
            for batch, metas in prefetcher:
                probs, labels = eval_batch(self.model, batch, config,
                                           self.plan, device=self.device,
                                           spec=self.spec)
                val_acc.update(probs, batch)
                buffered.append(torch.stack([probs.argmax(dim=-1),
                                             labels.long()]))
                metas_all.append(metas)
            n_batches = len(buffered)
            fetched = (torch.stack(buffered).cpu().numpy() if buffered
                       else [])
            for (preds_all, labels_all), metas in zip(fetched, metas_all):
                for b, meta in enumerate(metas):
                    n = meta["n_real"]
                    predictions.append(preds_all[b, :n])
                    targets.append(labels_all[b, :n])
        else:
            for batch, metas in prefetcher:
                probs, labels = eval_batch(self.model, batch, config,
                                           self.plan, device=self.device)
                probs_all = probs.cpu().numpy()
                preds_all = np.argmax(probs_all, axis=-1)
                labels_all = labels.cpu().numpy()
                n_batches += 1
                for b, meta in enumerate(metas):
                    n = meta["n_real"]
                    inds = meta["input_inds"][:n]
                    c_i = meta["cloud_ind"]
                    self.validation_probs[c_i][inds] = \
                        val_smooth * self.validation_probs[c_i][inds] \
                        + (1 - val_smooth) * probs_all[b, :n]
                    predictions.append(preds_all[b, :n])
                    targets.append(labels_all[b, :n])
        self.val_times.append(dict(epoch=self.epoch, batches=n_batches,
                                   seconds=time.perf_counter() - t_start))

        # Sub-part confusions with proportion rebalance
        confs = []
        for pred_cls, truth in zip(predictions, targets):
            preds = label_values[nonign[pred_cls]]
            truth_vals = label_values[np.clip(truth, 0, None)]
            confs.append(fast_confusion(truth_vals, preds, label_values))
        C = np.sum(np.stack(confs), axis=0).astype(np.float32)
        for l_ind, label_value in reversed(list(enumerate(label_values))):
            if label_value in val_dataset.ignored_labels:
                C = np.delete(C, l_ind, axis=0)
                C = np.delete(C, l_ind, axis=1)
        C *= np.expand_dims(
            self.val_proportions / (np.sum(C, axis=1) + 1e-6), 1)
        IoUs = IoU_from_confusions(C)
        mIoU = 100 * float(np.mean(IoUs))
        print(f"{config.dataset} mean IoU = {mIoU:.1f}%")

        if config.saving:
            line = " ".join(f"{IoU:.3f}" for IoU in IoUs) + " \n"
            val_file = join(config.saving_path, "val_IoUs.txt")
            with open(val_file, "a" if exists(val_file) else "w") as f:
                f.write(line)

            pot_path = join(config.saving_path, "potentials")
            os.makedirs(pot_path, exist_ok=True)
            for i, file_path in enumerate(val_dataset.files):
                pot_points = np.asarray(val_dataset.pot_trees[i].data)
                pots = val_dataset.potentials[i].astype(np.float32)
                write_ply(join(pot_path, os.path.basename(file_path)),
                          [pot_points.astype(np.float32), pots],
                          ["x", "y", "z", "pots"])

            if (self.epoch + 1) % config.checkpoint_gap == 0:
                if val_acc is not None:
                    self.validation_probs = val_acc.materialize()
                self._save_val_confusions(val_dataset)
        self.last_mIoU = mIoU
        return mIoU

    def _save_val_confusions(self, val_dataset):
        """Full-cloud confusion of the smoothed probabilities, projected to
        the original points, as `conf.txt` (the plot is not ported)."""
        val_path = join(self.config.saving_path,
                        f"val_preds_{self.al_iteration}_{self.epoch + 1}")
        os.makedirs(val_path, exist_ok=True)
        label_values = val_dataset.label_values
        n_tot = len(label_values)
        confs = np.zeros((n_tot, n_tot), np.int32)
        for i in range(len(val_dataset.files)):
            sub_probs = self.validation_probs[i]
            for l_ind, label_value in enumerate(label_values):
                if label_value in val_dataset.ignored_labels:
                    sub_probs = np.insert(sub_probs, l_ind, 0, axis=1)
            sub_preds = label_values[np.argmax(sub_probs, axis=1)]
            preds = sub_preds[val_dataset.test_proj[i]].astype(np.int32)
            labels = val_dataset.validation_labels[i].astype(np.int32)
            confs += fast_confusion(labels, preds, label_values).astype(
                np.int32)
        np.savetxt(join(val_path, "conf.txt"), confs, fmt="%i")
