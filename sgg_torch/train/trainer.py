"""Training loop: model construction, the epoch loop, checkpoints,
validation and the test sweep.

Counterpart of ``sgg_tpu/train/trainer.py`` (reference ``main.py``): the
epoch loop with interval loss averaging and s/batch reporting
(``main.py:196-236``; with the mean wait for a batch, issue of a step
and, with a GAN, its F, G and D phases, read from the spans of
``utils/counters.py``), per-epoch checkpoints with auto-resume
(``main.py:249-254``), validation after the first epoch and then every
``VAL_EVERY`` epochs, and the final test sweep over all eval splits
(``main.py:256-288``). One process on one device (``config.device``).
In mode sgdet the relation model trains on the detections of a frozen,
pretrained detector (``main.py:62-63``; ``sgg_torch/pretrain_detector.py``
writes one), which also serves validation and the test sweep. Batches
reach the step in the config's ``image_format`` (uint8 canvases are
normalized on the device), float canvases in bfloat16 when the model
computes in it, their copies to the device issued ahead on a stream of
their own while the previous steps run (``device_prefetch``). With
``config.feature_cache`` each split's frozen-trunk maps are extracted once
(``data/feature_cache.py``; a cache of other trunk weights is extracted
again) and the loaders stream them instead of images. With
``config.gan`` each batch takes the GAN step (``train/gan_step.py``: the
SGG, generator and discriminator updates) on a ``GANModel`` built from the
train split's vocabulary, its classes perturbed on the host first
(``-perturb``, ``augment/perturb.py``); with ``config.vis_cond`` G also
reads real features of those classes, sampled on the host from the
feature bank (``augment/feature_bank.py``) and copied with the batch.
``log_fn`` (``utils/logging.py::make_logger``) receives the interval
losses and the evaluation results.

Under a data-parallel group (``sgg_torch.parallel``, one process a card,
``torchrun --nproc_per_node N``) each rank loads its rows of every global
batch (``BatchLoader(shard=)``), starts from rank 0's state
(``replicate``) and steps with the ranks' gradients summed
(``train/step.py``, ``train/gan_step.py``); rank 0 alone extracts the
feature caches and writes the checkpoints and the test artifacts, each
followed by a barrier, and every rank reads a checkpoint to resume and
evaluates through the data-parallel ``val_epoch``
(``sgg_tpu/train/trainer.py``'s multi-host paths), in every mode: in mode
sgdet each rank runs the frozen detector on its rows
(``models/sgdet.py``), rank 0 extracts the detector trunk's cache and the
SGDet evaluation keeps its batches whole on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import threading
import time
import zlib
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from sgg_torch import constants
from sgg_torch.config import Config
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.data.pipeline import (BatchLoader, background,
                                     device_prefetch, to_image_dtype)
from sgg_torch.device import resolve_device
from sgg_torch.eval.driver import val_epoch
from sgg_torch.data.word_vectors import normalized_class_embeddings
from sgg_torch.models.frequency_bias import (count_matrices,
                                             log_predicate_distribution)
from sgg_torch.models.gan import GANModel, init_gan_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.sgdet import make_sgdet_train_step
from sgg_torch.parallel import Group, replicate, sync_processes, using
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train.gan_step import (create_gan_optimizers,
                                      make_gan_train_step)
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from sgg_torch.utils import counters


def build_model(config: Config, train_data: SGGDataset, *,
                device="cuda", seed: int = 0,
                widths: Optional[Dict[str, int]] = None) -> RelModelIMP:
    """Flagship IMP model from config + dataset vocabulary (main.py:54-60),
    with seeded random weights, computing in the config's type over
    float32 master weights (the frozen trunk stored in that type), in eval
    mode on ``device`` (the card unless the caller asks for the CPU). In
    mode sgdet it has no trunk: the detector's feature map feeds it.
    ``widths`` (``obj_dim``, ``hidden_dim``) overrides the heads' widths
    (the tools' narrow CPU runs)."""
    dev = resolve_device(device)
    freq_table = None
    if config.use_bias:
        fg, bg = count_matrices(train_data.gt_boxes, train_data.gt_classes,
                                train_data.relationships,
                                train_data.num_classes,
                                train_data.num_predicates, must_overlap=True)
        freq_table = log_predicate_distribution(fg, bg)
    widths = {"obj_dim": 1024 if config.backbone == "resnet50" else 4096,
              **(widths or {})}
    model = RelModelIMP(
        num_classes=train_data.num_classes,
        num_predicates=train_data.num_predicates,
        mode=config.mode, use_bias=config.use_bias,
        test_bias=config.test_bias, backbone=config.backbone,
        edge_model=config.edge_model, freq_table=freq_table, **widths)
    init_weights(model, seed)  # the bias table keeps its counts
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
        else torch.float32
    return model.to_compute_dtype(dtype).to(dev).eval()


# the reference evaluates every 5 epochs: evaluation is slow and noisy
# (main.py:258-259)
VAL_EVERY = 5

# how long the other ranks wait for rank 0's feature-cache extraction
CACHE_WAIT_S = 6 * 3600


def _in_group(method):
    """Run a ``Trainer`` method with the trainer's group active."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        with using(self.group):
            return method(self, *args, **kw)
    return run


def _rank0(group: Optional[Group]) -> bool:
    return group is None or group.rank == 0


def build_gan(config: Config, train_data: SGGDataset, *, device="cuda",
              seed: int = 1) -> GANModel:
    """The GAN of ``-gan`` (reference main.py:65-76): the train split's
    vocabulary, a ``IM_SCALE // STRIDE`` map (read at call time), ``largeD``,
    ``vis_cond`` with ``-vis_cond`` and, with ``init_embed``, word-vector
    tables for both embeddings; seeded random weights, float32, on
    ``device``."""
    emb_o = emb_r = None
    if config.init_embed:
        emb_o = normalized_class_embeddings(train_data.ind_to_classes,
                                            wv_dir=config.data)
        emb_r = normalized_class_embeddings(train_data.ind_to_predicates,
                                            wv_dir=config.data)
    gan = GANModel(num_classes=train_data.num_classes,
                   num_predicates=train_data.num_predicates,
                   fmap_sz=constants.IM_SCALE // constants.STRIDE,
                   vis_cond=config.vis_cond is not None,
                   largeD=config.largeD, init_embed_objs=emb_o,
                   init_embed_rels=emb_r)
    return init_gan_weights(gan, seed).to(resolve_device(device))


@dataclasses.dataclass
class GANBatch:
    """A batch, the classes the generator paints for it and, with
    ``-vis_cond``, the feature bank's samples of those classes, for
    ``device_prefetch``: its copies to a card are pinned and
    ``non_blocking``, so they run on the prefetch stream beside a step."""

    batch: GraphBatch
    fake_classes: object
    vis: object = None

    def pinned(self) -> "GANBatch":
        """The classes and the samples as tensors in pinned memory (a
        later ``to`` a card copies them without pinning them again)."""
        return GANBatch(self.batch, _host(self.fake_classes, np.int64, True),
                        _host(self.vis, np.float32, True))

    def to(self, device) -> "GANBatch":
        cuda = torch.device(device).type == "cuda"

        def place(x, dtype):
            x = _host(x, dtype, cuda)
            if x is None:
                return None
            if cuda and x.device.type == "cpu":
                return x.to(device, non_blocking=True)
            return x.to(device)

        return GANBatch(self.batch.to(device),
                        place(self.fake_classes, np.int64),
                        place(self.vis, np.float32))


def _host(x, dtype, pin: bool):
    """A host array as a tensor, pinned if ``pin``; a tensor as it is, a
    host one pinned if ``pin`` (a no-op when it already is)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype))
    if pin and x.device.type == "cpu":
        x = x.pin_memory()
    return x


def _waited(batches, epoch: int):
    """``enumerate(batches)``, each wait for the next item a ``batch.wait``
    span, and the item's ``(epoch, index)`` the thread's batch
    (``counters.set_batch``) while the caller holds it."""
    try:
        for index in itertools.count():
            with counters.span("batch.wait", batch=(epoch, index)) as wait:
                item = next(batches, None)
                if item is None:
                    wait.batch = None  # the epoch's end: no batch
            if item is None:
                return
            counters.set_batch((epoch, index))
            yield index, item
    finally:
        counters.set_batch(None)


class Trainer:
    """Owns the model, the optimizer, the train step and the epoch, val
    and test loops, on ``config.device``.

    Mode sgdet needs ``detector`` (a ``FasterRCNNVGG`` or
    ``FasterRCNNFPN``, of the config's backbone); ``det_state``, a
    detector payload (``checkpoint.load_detector``), is loaded into it
    with ``strict=True``. The detector is frozen and is not part of the
    run's checkpoints: they hold the relation model and its optimizer.

    With ``config.gan`` the trainer also owns the ``GANModel`` (``gan``,
    or ``build_gan``'s with seed ``config.seed + 1``), its two Adams and the
    perturber, and with ``config.vis_cond`` the ``FeatureBank`` read from
    that file; the relation model's SGD then takes two updates a batch
    under ``rec``, and the schedule's boundaries count both
    (``sgg_tpu/train/trainer.py:308-317``). Checkpoints carry the GAN
    under ``gan``.

    ``with_images=False`` gives every loader blank canvases in place of a
    dataset's image files (feature-level runs, as the JAX trainer's).

    ``group``: the data-parallel group (``sgg_torch.parallel``; None for
    one process), in any mode; the trainer's loops run with it active.
    ``config.num_devices`` N > 1 needs a group of N ranks.
    """

    def __init__(self, config: Config, splits: Dict[str, SGGDataset],
                 model: Optional[RelModelIMP] = None, detector=None,
                 det_state: Optional[Dict] = None,
                 gan: Optional[GANModel] = None, with_images: bool = True,
                 log_fn=None, group: Optional[Group] = None):
        if config.mode == "sgdet" and detector is None:
            raise ValueError("sgdet training needs a (pretrained) detector")
        if config.gan and config.mode == "sgdet":
            raise ValueError("-gan trains on the GT boxes of predcls/sgcls; "
                             "mode sgdet has no trunk of its own to pool "
                             "the real map from")
        if config.num_devices > 1 and group is None:
            raise ValueError(
                f"-ndev {config.num_devices} trains on {config.num_devices} "
                f"cards, one process each: launch under torchrun "
                f"--nproc_per_node {config.num_devices} -m sgg_torch.main")
        if group is not None and config.num_devices not in (0, group.world):
            raise ValueError(f"-ndev {config.num_devices} but the process "
                             f"group has {group.world} ranks")
        self.group = group
        self.config = config
        self.splits = splits
        self.train_data = splits["train"]
        self.with_images = with_images
        self.log_fn = log_fn or (lambda d, **kw: None)
        self.device = resolve_device(config.device)
        self.model = (model.to(self.device) if model is not None else
                      build_model(config, self.train_data,
                                  device=self.device, seed=config.seed))
        self.detector = None
        if detector is not None:
            if det_state is not None:
                ckpt.load_detector_state(detector, det_state)
            dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
                else torch.float32
            self.detector = detector.requires_grad_(False).to_compute_dtype(
                dtype).to(self.device).eval()
        if config.mode != "sgdet" and config.max_edges < config.rels_per_img:
            # the padded edge bucket bounds the per-image relation budget;
            # only images with more candidate pairs than the bucket are
            # affected (reference budget: rels_per_img)
            print(f"[trainer] edge budget = min(max_edges "
                  f"{config.max_edges}, rels_per_img "
                  f"{config.rels_per_img}) — raise -max_edges for full "
                  f"budget parity on graphs with > {config.max_edges} "
                  f"candidate pairs")
        self.steps_per_epoch = max(len(self.train_data) // config.batch_size,
                                   1)
        upd_per_batch = 2 if config.gan and "rec" in config.ganlosses else 1
        self.optimizer = Optimizer(config, self.model,
                                   self.steps_per_epoch * upd_per_batch)
        self.gan = self.perturber = self.feature_bank = None
        if config.gan:
            self._init_gan(gan)
        # every rank starts from rank 0's weights
        replicate(self.model, group)
        if self.gan is not None:
            replicate(self.gan, group)
        if config.mode == "sgdet":
            self.train_step = make_sgdet_train_step(
                self.detector, self.model, config, self.optimizer)
        else:
            self.train_step = make_train_step(self.model, config,
                                              self.optimizer)
        self.start_epoch = 0
        self.global_iter = 0
        self._feature_caches: Dict[str, object] = {}
        if config.save_dir:
            os.makedirs(config.save_dir, exist_ok=True)
            self._restore()

    # ------------------------------------------------------------------
    def _init_gan(self, gan: Optional[GANModel]) -> None:
        """The GAN, its optimizers, step, feature bank and perturber
        (reference main.py:65-76, the perturber at :131). The bank's draws
        come from ``RandomState(cfg.seed)`` as the JAX trainer's, which
        also draws one batch from it to shape its initialization; the port's
        modules need no example input, so its draws start there."""
        cfg, td = self.config, self.train_data
        self.gan = (gan.to(self.device) if gan is not None else
                    build_gan(cfg, td, device=self.device,
                              seed=cfg.seed + 1))
        if cfg.vis_cond is not None:
            from sgg_torch.augment.feature_bank import FeatureBank
            self.feature_bank = FeatureBank(
                cfg.vis_cond, td.ind_to_classes, pool_sz=self.gan.pool_sz,
                n_ch=self.gan.n_ch, seed=cfg.seed)
        self.g_opt, self.d_opt = create_gan_optimizers(cfg, self.gan)
        self.gan_step = make_gan_train_step(self.model, self.gan, cfg,
                                            self.optimizer, self.g_opt,
                                            self.d_opt)
        if cfg.perturb:
            from sgg_torch.augment.perturb import SceneGraphPerturb
            emb = normalized_class_embeddings(td.ind_to_classes,
                                              wv_dir=cfg.data)
            self.perturber = SceneGraphPerturb(
                cfg.perturb, emb, td.subj_pred_pairs, td.pred_obj_pairs,
                L=cfg.L, topk=cfg.topk, alpha=cfg.graphn_a,
                uniform=cfg.uniform,
                degree_smoothing=cfg.degree_smoothing, seed=cfg.seed)

    def _payload(self, epoch: int) -> Dict:
        params = dict(self.model.named_parameters())
        payload = {
            "step": torch.tensor(self.optimizer.count),
            "params": {k: v.detach() for k, v in params.items()},
            "batch_stats": dict(self.model.named_buffers()),
            "opt_state": self.optimizer.state_dict(),
            "epoch": torch.tensor(epoch),
        }
        if self.gan is not None:
            payload["gan"] = {
                "params": {k: v.detach()
                           for k, v in self.gan.named_parameters()},
                "stats": dict(self.gan.named_buffers()),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict()}
        return payload

    @_in_group
    def save(self, epoch: int) -> None:
        """Rank 0 writes the checkpoint of ``epoch``; every rank waits for
        it."""
        if _rank0(self.group):
            ckpt.save_payload(self.config.save_dir, self._payload(epoch),
                              epoch)
        sync_processes(f"save{epoch}")

    def _restore(self) -> None:
        # the payload is the relation model's alone: a frozen detector's
        # leaves are never counted as the run's own
        restored, last, on_disk, stats = ckpt.optimistic_restore_payload(
            self.config.save_dir, self._payload(0),
            map_location=self.device)
        if last < 0:
            return
        # the run's own save_dir: a partial match usually means config
        # drift (e.g. a changed hidden_dim), and resuming part random-init
        # at a saved epoch would corrupt the run, so say which leaves kept
        # their init values
        if stats["missing"] or stats["unused"]:
            print(f"[resume] WARNING: checkpoint epoch {last} in "
                  f"{self.config.save_dir} only partially matches this "
                  f"run's state — {len(stats['missing'])} leaves kept "
                  f"their fresh-init values "
                  f"(first: {stats['missing'][:5]}), "
                  f"{len(stats['unused'])} on-disk leaves had no home "
                  f"(first: {stats['unused'][:5]}).")
        with torch.no_grad():
            for coll in ("params", "batch_stats"):
                live = dict(self.model.named_parameters()) \
                    if coll == "params" else dict(self.model.named_buffers())
                for k, v in restored[coll].items():
                    live[k].copy_(v)
        self.optimizer.load_state_dict(restored["opt_state"])
        self.optimizer.count = int(restored["step"])
        if self.gan is not None and "gan" in on_disk:
            g = restored["gan"]
            with torch.no_grad():
                for coll, live in (("params",
                                    dict(self.gan.named_parameters())),
                                   ("stats", dict(self.gan.named_buffers()))):
                    for k, v in g[coll].items():
                        live[k].copy_(v)
            self.g_opt.load_state_dict(g["g_opt"])
            self.d_opt.load_state_dict(g["d_opt"])
        self.start_epoch = last + 1
        self.global_iter = self.optimizer.count
        print(f"resumed from epoch {last}")

    # ------------------------------------------------------------------
    def _trunk(self):
        """(the frozen trunk module, its forward, its stride): the relation
        model's, or in mode sgdet the frozen detector's (VGG16 only: the
        FPN detector reads every pyramid level). The ResNet50-FPN relation
        model pools the stride-64 ``pool`` level alone, and only that is
        cached."""
        if self.config.mode == "sgdet":
            trunk = self.detector.trunk
        else:
            trunk = self.model.trunk
        if self.config.backbone == "resnet50":
            return trunk, trunk.pool, 64
        return trunk, trunk, 16

    def _feature_cache_for(self, split_name: str, dataset):
        """The frozen-trunk cache of one split (``config.feature_cache``),
        extracted on first use, and again when the stored fingerprint is
        not the trunk's (``sgg_tpu/train/trainer.py:_feature_cache_for``).
        None without a cache directory, for an empty split, and for the
        val splits of mode sgdet, which the evaluator skips. Under a group
        rank 0 alone opens or extracts it (the directory is shared); the
        other ranks open it after a barrier, and raise if it is not the
        one this trunk needs."""
        cfg = self.config
        if not cfg.feature_cache or len(dataset) == 0:
            return None
        if cfg.mode == "sgdet" and split_name.startswith("val_"):
            return None
        cache = self._feature_caches.get(split_name)
        if cache is not None:
            return cache
        from sgg_torch.data.feature_cache import (FeatureCache,
                                                  params_fingerprint,
                                                  split_cache_path)
        path = split_cache_path(cfg.feature_cache, split_name)
        fp = params_fingerprint(self._trunk()[0].state_dict())
        # train splits store cfg.cache_orientations (1: half the disk, no
        # flips); eval splits never flip. More orientations on disk serve.
        want_orient = cfg.cache_orientations if dataset.is_train else 1

        def fresh(cache):
            return (cache.complete() and cache.fingerprint == fp
                    and cache.n_orient >= want_orient
                    and cache.im_scale == constants.IM_SCALE)

        if not _rank0(self.group):
            # rank 0 extracts: an hour or more for a full split
            sync_processes(f"feature_cache_{split_name}", CACHE_WAIT_S)
            cache = FeatureCache(path)
            if not fresh(cache):
                raise RuntimeError(f"rank {self.group.rank}: the feature "
                                   f"cache {path} that rank 0 left is not "
                                   f"this trunk's")
            self._feature_caches[split_name] = cache
            return cache
        cache = self._open_or_extract(split_name, dataset, path, fp,
                                      want_orient, fresh)
        sync_processes(f"feature_cache_{split_name}", CACHE_WAIT_S)
        return cache

    def _open_or_extract(self, split_name, dataset, path, fp, want_orient,
                         fresh):
        """The cache at ``path`` when ``fresh``, else extracted there."""
        from sgg_torch.data.feature_cache import (FeatureCache,
                                                  extract_trunk_cache)
        cfg = self.config
        trunk, trunk_fwd, stride = self._trunk()
        if os.path.exists(path):
            try:
                cache = FeatureCache(path)
            except (OSError, ValueError, KeyError) as e:
                print(f"[feature_cache] {path} unreadable ({e}): "
                      f"extracting again")
            else:
                if fresh(cache):
                    self._feature_caches[split_name] = cache
                    return cache
                print(f"[feature_cache] {path} is stale (incomplete, or of "
                      f"other trunk weights or scale): extracting again")
                cache.close()

        @torch.inference_mode()
        def trunk_fn(canvases):
            return trunk_fwd(torch.from_numpy(canvases).to(self.device))

        t0 = time.time()
        extract_trunk_cache(
            path, dataset, trunk_fn, stride=stride,
            batch_size=min(8, len(dataset)), im_scale=constants.IM_SCALE,
            image_format=cfg.image_format, fingerprint=fp,
            with_images=self.with_images, n_orient=want_orient).close()
        print(f"[feature_cache] extracted {split_name} ({len(dataset)} "
              f"images) in {time.time() - t0:.1f}s")
        cache = FeatureCache(path)
        self._feature_caches[split_name] = cache
        return cache

    # ------------------------------------------------------------------
    @_in_group
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch (reference train_epoch, main.py:196-236). Losses stay
        on the device between print intervals; a non-finite interval mean
        raises ``FloatingPointError``."""
        cfg = self.config
        loader = BatchLoader(self.train_data, batch_size=cfg.batch_size,
                             max_nodes=cfg.max_nodes,
                             max_edges=cfg.max_edges, seed=cfg.seed,
                             num_workers=cfg.num_workers,
                             with_images=self.with_images,
                             image_format=cfg.image_format,
                             im_scale=constants.IM_SCALE,  # read per call
                             feature_cache=self._feature_cache_for(
                                 "train", self.train_data),
                             cache_orientations=cfg.cache_orientations,
                             shard=(None if self.group is None else
                                    (self.group.rank, self.group.world)))
        loader._epoch = epoch
        sync_processes(f"epoch{epoch}")
        source = (to_image_dtype(b, cfg.compute_dtype) for b in loader)
        if self.gan is not None:
            source = background(self._gan_inputs(source, epoch))
        # the next batches' copies to the device run while a step does
        batches = device_prefetch(source, self.device, epoch=epoch)
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed * 100003 + epoch)
        accum = defaultdict(list)
        epoch_means = defaultdict(list)
        t0 = time.time_ns()
        for b_i, item in _waited(batches, epoch):
            if self.gan is not None:
                metrics = self.gan_step(item.batch, item.fake_classes,
                                        generator, vis_features=item.vis)
            else:
                metrics = self.train_step(item, generator)
            self.global_iter += 1
            for k, v in metrics.items():
                accum[k].append(v)
            if (b_i + 1) % cfg.print_interval == 0:
                means = self._means(accum)  # one host sync an interval
                if not all(map(math.isfinite, means.values())):
                    # the reference kills the run on a non-finite loss
                    # (detector/engine.py:41-44); a silent NaN would burn
                    # the remaining epochs
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch} batch {b_i}: "
                        f"{means}")
                for k, v in means.items():
                    epoch_means[k].append(v)
                t1 = time.time_ns()
                times = self._interval_ms(t0, t1, cfg.print_interval)
                print(f"e{epoch} b{b_i + 1} "
                      + " ".join(f"{k}={v:.4f}" for k, v in means.items()
                                 if not k.startswith("grad/"))
                      + "".join(f" {k}={v:.1f}ms" for k, v in times.items())
                      + f" {(t1 - t0) / 1e9 / cfg.print_interval:.3f}"
                        "s/batch", flush=True)
                self.log_fn({**{f"loss/{k}": v for k, v in means.items()},
                             **{f"time/{k}_ms": v for k, v in times.items()}},
                            step=self.global_iter)
                accum.clear()
                t0 = t1
        if accum:
            for k, v in self._means(accum).items():
                epoch_means[k].append(v)
        return {k: sum(v) / len(v) for k, v in epoch_means.items()}

    def _gan_inputs(self, source, epoch: int):
        """Each batch of ``source`` with its GAN host inputs, pinned for a
        card: the perturbation, the bank's samples and their pinning run on
        the host batch, before its copy, in a thread of their own (the
        caller's ``background``) beside the issue of the steps; a
        ``batch.gan_inputs`` span each."""
        pin = self.device.type == "cuda"
        for index, batch in enumerate(source):
            with counters.span("batch.gan_inputs", batch=(epoch, index)):
                item = self._gan_host_inputs(batch, epoch)
                if pin:
                    item = item.pinned()
            yield item

    @staticmethod
    def _interval_ms(t0_ns: int, t1_ns: int, steps: int) -> Dict[str, float]:
        """This thread's spans in ``[t0_ns, t1_ns]`` as mean ms a step: the
        wait for a batch, the step's issue and, with a GAN, its phases."""
        names = {"batch.wait": "wait", "step": "issue", "step.F": "F",
                 "step.G": "G", "step.D": "D"}
        me = threading.get_ident()
        total: Dict[str, float] = {}
        for sp in counters.spans(t0_ns, t1_ns):
            if sp.thread == me and sp.name in names:
                total[sp.name] = total.get(sp.name, 0.0) + sp.ns
        return {short: total[name] / 1e6 / steps
                for name, short in names.items() if name in total}

    def _gan_host_inputs(self, batch: GraphBatch, epoch: int) -> GANBatch:
        """The batch, the classes G paints for it and, with a feature bank,
        its samples of those classes under the node mask, computed on the
        host batch (``sgg_tpu/train/trainer.py:522-550``). Each image's
        perturbation draws from a ``RandomState`` seeded by the crc32 of its
        int32 classes and float32 boxes, mixed with the epoch and the run's
        seed: the same image perturbs the same way whatever batch or
        process holds it, and differently each epoch."""
        fake = np.asarray(batch.classes)
        if self.perturber is not None:
            classes = np.ascontiguousarray(fake, np.int32)
            boxes = np.ascontiguousarray(batch.boxes, np.float32)
            seeds = [(zlib.crc32(classes[i].tobytes() + boxes[i].tobytes())
                      ^ (epoch * 0x9E3779B1)
                      ^ (self.config.seed * 0x85EBCA6B)) & 0xFFFFFFFF
                     for i in range(fake.shape[0])]
            fake = self.perturber.perturb_batch(
                fake, np.asarray(batch.rels), np.asarray(batch.node_mask),
                np.asarray(batch.rel_mask), seeds=seeds)
        vis = None
        if self.feature_bank is not None:
            vis = self.feature_bank.sample(fake, np.asarray(batch.node_mask))
        return GANBatch(batch, fake, vis)

    @staticmethod
    def _means(accum) -> Dict[str, float]:
        keys = list(accum)
        means = torch.stack([torch.stack(accum[k]).mean() for k in keys])
        return dict(zip(keys, means.tolist()))

    # ------------------------------------------------------------------
    @_in_group
    def evaluate(self, split_names, verbose: bool = True,
                 collect_entries: bool = False) -> Dict[str, float]:
        results = {}
        for name in split_names:
            ds = self.splits.get(name)
            if ds is None or len(ds) == 0:
                continue
            res = val_epoch(
                self.model, ds, self.config, name, train=self.train_data,
                verbose=verbose, collect_entries=collect_entries,
                detector=self.detector, device=self.device,
                with_images=self.with_images,
                feature_cache=self._feature_cache_for(name, ds),
                group=self.group,
                # summaries, repeated at test time against W&B's loss of
                # trailing values (reference lib/eval.py:108-110)
                log_fn=lambda d, test=name.startswith("test"): self.log_fn(
                    d, step=self.global_iter, is_summary=True,
                    log_repeats=5 if test else 1))
            if collect_entries and "_entries" in res:
                results.setdefault("_entries", {})[name] = res.pop("_entries")
            for extra in ("_counters", "_throughput", "_detections"):
                if extra in res:
                    results.setdefault(extra, {})[name] = res.pop(extra)
            results.update(res)
        return results

    # ------------------------------------------------------------------
    @_in_group
    def fit(self, val_names=("val_zs", "val_alls"),
            test_names=("test_zs", "test_10s", "test_100s", "test_alls")
            ) -> Dict[str, float]:
        """Full run: epochs + periodic val + final test (main.py:244-288).

        Validation runs after the first epoch and then every ``VAL_EVERY``
        epochs."""
        cfg = self.config
        for epoch in range(self.start_epoch, cfg.num_epochs):
            losses = self.train_epoch(epoch)
            print(f"epoch {epoch}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in losses.items()))
            if cfg.save_dir:
                self.save(epoch)
            run_val = (epoch == self.start_epoch
                       or (epoch % VAL_EVERY == 0
                           and epoch < cfg.num_epochs - 1))
            if cfg.val_size != 0 and run_val:
                self.evaluate(val_names, verbose=False)
        results = {}
        if not cfg.notest:
            results = self.evaluate(test_names,
                                    collect_entries=cfg.save_scores)
            # every rank has the same results; rank 0 writes them
            if _rank0(self.group):
                self._write_results(results)
            sync_processes("test_results")
        return results

    def _write_results(self, results: Dict) -> None:
        """``test_results.json`` and, with ``save_scores``, the pickled
        test entries (popped from ``results``) in ``save_dir``."""
        cfg = self.config
        if cfg.save_dir and results:
            with open(os.path.join(cfg.save_dir, "test_results.json"),
                      "w") as f:
                json.dump({k: v for k, v in results.items()
                           if not k.startswith("_")}, f, indent=2)
        if cfg.save_scores and cfg.save_dir and "_entries" in results:
            # test prediction entries (reference main.py:284-288)
            import pickle
            with open(os.path.join(cfg.save_dir,
                                   "test_predictions.pkl"), "wb") as f:
                pickle.dump(results.pop("_entries"), f)
