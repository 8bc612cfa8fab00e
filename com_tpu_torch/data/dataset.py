"""Dataset template, fixed-shape collate and the prefetching loader (the
port's copy of ``com_tpu/data/dataset.py``; pcdet datasets/dataset.py
``prepare_data`` :144-238 and ``collate_batch`` :240-370).

The collate emits fixed-shape batches (points padded to
MAX_POINTS_PER_SCENE, boxes to MAX_GT_OBJECTS, voxels to
MAX_NUMBER_OF_VOXELS), so every train step sees the same shapes.  The COM
side arrays are optional per dataset.  A scene with more points than
MAX_POINTS_PER_SCENE is subsampled without replacement in the collate,
which undoes a pillar presort, as in ``com_tpu``.
"""
from __future__ import annotations

import queue as _queue
import threading
from collections import defaultdict

import numpy as np

from ..utils.registry import DATASETS
from .augmentor.data_augmentor import DataAugmentor
from .point_feature_encoder import PointFeatureEncoder
from .processor import GT_SIDE_KEYS, DataProcessor

IMAGE_KEYS = ("images", "gt_boxes2d", "trans_lidar_to_cam", "trans_cam_to_img")


class _ThreadLocalRng:
    """np.random.RandomState facade with one independent state per thread.

    PrefetchLoader prepares items on several worker threads; one shared
    RandomState would race the reseed-then-draw of ``_reseed_for_item``.
    Each thread lazily gets its own RandomState (seeded with the base seed),
    and ``_reseed_for_item`` reseeds only the calling thread's."""

    def __init__(self, seed: int):
        self._seed = int(seed)
        self._tl = threading.local()

    def _state(self) -> np.random.RandomState:
        rs = getattr(self._tl, "rs", None)
        if rs is None:
            rs = np.random.RandomState(self._seed)
            self._tl.rs = rs
        return rs

    def __getattr__(self, name):
        return getattr(self._state(), name)


class DatasetTemplate:
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.root_path = root_path if root_path is not None else dataset_cfg.get("DATA_PATH")
        self.logger = logger
        self.seed = seed if seed is not None else 0
        # One RNG shared by augmentor, processor and collate, reseeded per
        # (seed, epoch, index) in _reseed_for_item.  DATA_AUGMENTOR.SEED_PARITY
        # instead draws from the GLOBAL np.random stream in the reference's
        # call order, never reseeded.
        self.seed_parity = bool(
            (dataset_cfg.get("DATA_AUGMENTOR") or {}).get("SEED_PARITY", False))
        self.rng = np.random if self.seed_parity else _ThreadLocalRng(self.seed)

        self.point_cloud_range = np.asarray(dataset_cfg["POINT_CLOUD_RANGE"], np.float32)
        self.point_feature_encoder = PointFeatureEncoder(dataset_cfg["POINT_FEATURE_ENCODING"])
        self.data_augmentor = (
            DataAugmentor(self.root_path, dataset_cfg["DATA_AUGMENTOR"], class_names,
                          logger=logger, db_infos=db_infos, rng=self.rng)
            if training and dataset_cfg.get("DATA_AUGMENTOR") is not None else None)
        self.data_processor = DataProcessor(
            dataset_cfg.get("DATA_PROCESSOR", []), self.point_cloud_range, training,
            self.point_feature_encoder.num_point_features, rng=self.rng)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_points = int(dataset_cfg.get("MAX_POINTS_PER_SCENE", 180224))
        self.max_gt = int(dataset_cfg.get("MAX_GT_OBJECTS", 500))
        self.epoch = 0

    @property
    def mode(self):
        """The split selector of ``INFO_PATH`` and ``DATA_SPLIT``: 'train' or
        'test' (pcdet dataset.py:60-62)."""
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def set_epoch(self, epoch):
        self.epoch = epoch
        if self.data_augmentor is not None and self.data_augmentor.gt_sampler is not None:
            self.data_augmentor.gt_sampler.epoch = epoch

    def _reseed_for_item(self, index):
        if self.seed_parity:
            return  # global-stream mode: never reseed
        self.rng.seed((self.seed * 1_000_003 + self.epoch * 9_973 + index) % 2**31)

    def set_confidence_groups(self, conf):
        """The device -> host curriculum feedback: the epoch's (C, G) mean
        confidences for the COM sampler (reference train_utils.py:321-328)."""
        if self.data_augmentor is not None and self.data_augmentor.gt_sampler is not None:
            self.data_augmentor.gt_sampler.confidence_groups = conf

    def prepare_data(self, data_dict):
        """Augment -> class filter -> feature encode -> process, the side
        arrays kept aligned through the class filter (dataset.py:144-238)."""
        if self.training:
            if "gt_boxes" not in data_dict:
                raise KeyError("a training sample needs gt_boxes")
            data_dict["gt_boxes_mask"] = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], dtype=bool)
            # the side arrays exist, so samplers and filters stay aligned
            n = len(data_dict["gt_names"])
            for k, default in (("num_points_in_gt", 0.0), ("true_object", 1.0),
                               ("occupancy_ratio", 0.0), ("facade_type", 0.0)):
                if k not in data_dict:
                    data_dict[k] = np.full(n, default, np.float32)
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor.forward(data_dict)
            else:
                data_dict.pop("gt_boxes_mask", None)

        if data_dict.get("gt_boxes", None) is not None:
            keep = np.array([n in self.class_names for n in data_dict["gt_names"]], bool)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][keep]
            data_dict["gt_names"] = data_dict["gt_names"][keep]
            for k in GT_SIDE_KEYS:
                if k in data_dict and len(np.atleast_1d(data_dict[k])) == len(keep):
                    data_dict[k] = np.asarray(data_dict[k])[keep]
            classes = np.array([self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                               np.float32)
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"].astype(np.float32), classes[:, None]], axis=1)

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)

        if self.training and len(data_dict.get("gt_boxes", [])) == 0:
            # resample another frame (dataset.py:231-236)
            return self[self.rng.randint(len(self))]
        data_dict.pop("gt_names", None)
        data_dict.pop("gt_boxes_mask", None)
        return data_dict

    # ---- fixed-shape collate ----
    def collate_batch(self, samples):
        batch = defaultdict(list)
        for s in samples:
            for k, v in s.items():
                batch[k].append(v)
        image_keys = [k for k in IMAGE_KEYS if k in batch]
        if image_keys:
            raise NotImplementedError(f"{image_keys}: image batches are not ported yet "
                                      "(the image VFE)")
        bs = len(samples)
        out = {"batch_size": bs}

        if "points" in batch:
            pts = np.zeros((bs, self.max_points, batch["points"][0].shape[1]), np.float32)
            mask = np.zeros((bs, self.max_points), bool)
            for i, p in enumerate(batch["points"]):
                n = min(len(p), self.max_points)
                if len(p) > self.max_points:
                    p = p[self.rng.choice(len(p), self.max_points, replace=False)]
                pts[i, :n] = p[:n]
                mask[i, :n] = True
            out["points"] = pts
            out["points_mask"] = mask

        if "gt_boxes" in batch and batch["gt_boxes"][0] is not None:
            # the widest over the batch: an empty (0, W) first sample still
            # reports its W
            width = max((np.asarray(g).shape[1] if np.asarray(g).ndim == 2 else 0)
                        for g in batch["gt_boxes"]) or 8
            gt = np.zeros((bs, self.max_gt, width), np.float32)
            for i, g in enumerate(batch["gt_boxes"]):
                g = np.asarray(g, np.float32)
                if g.ndim != 2 or not len(g):
                    continue
                n = min(len(g), self.max_gt)
                gt[i, :n, : g.shape[1]] = g[:n]
            out["gt_boxes"] = gt
            for k in GT_SIDE_KEYS:
                if k in batch:
                    arr = np.zeros((bs, self.max_gt), np.float32)
                    for i, v in enumerate(batch[k]):
                        n = min(len(v), self.max_gt)
                        arr[i, :n] = np.asarray(v, np.float32)[:n]
                    out[k] = arr

        if "voxels" in batch:
            # padded to the config's cap: a per-batch max would change the
            # shape from step to step
            vmax = self.data_processor.max_voxels or max(v.shape[0] for v in batch["voxels"])
            t, f = batch["voxels"][0].shape[1:]
            vox = np.zeros((bs, vmax, t, f), np.float32)
            coords = np.full((bs, vmax, 3), -1, np.int32)
            vnum = np.zeros((bs, vmax), np.int32)
            for i in range(bs):
                n = batch["voxels"][i].shape[0]
                vox[i, :n] = batch["voxels"][i]
                coords[i, :n] = batch["voxel_coords"][i]
                vnum[i, :n] = batch["voxel_num_points"][i]
            out["voxels"] = vox
            out["voxel_coords"] = coords
            out["voxel_num_points"] = vnum

        # the world augmentations' parameters
        for k, default in (("noise_rot", 0.0), ("noise_scale", 1.0), ("flip_x", False),
                           ("flip_y", False)):
            if k in batch:
                out[k] = np.asarray([v if v is not None else default for v in batch[k]],
                                    bool if isinstance(default, bool) else np.float32)
        for k in ("frame_id", "metadata"):
            if k in batch:
                out[k] = batch[k]
        return out


class PrefetchLoader:
    """Host loader: index order, worker threads, a prefetch queue.

    Each worker takes a strided shard of the epoch's batches, prepares and
    collates them, and puts them on a bounded queue of its own; the
    consumer takes them in the epoch's order whatever the workers' timing
    (a data-parallel eval puts the ranks' frames back in dataset order by
    it).  A worker's failure is raised in the consumer once every worker
    has stopped."""

    def __init__(self, dataset: DatasetTemplate, batch_size: int, shuffle: bool,
                 seed: int = 0, num_workers: int = 2, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0
        # data parallelism: each process feeds only its strided shard of the
        # epoch's (shared-seed) order, padded by wrapping to equal lengths
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def _shard_order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.process_count > 1:
            total = int(np.ceil(len(order) / self.process_count)) * self.process_count
            order = np.concatenate([order, order[: total - len(order)]])
            order = order[self.process_index:: self.process_count]
        return order

    def __len__(self):
        n_samples = int(np.ceil(len(self.dataset) / self.process_count))
        n = n_samples // self.batch_size
        if not self.drop_last and n_samples % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = self._shard_order()
        batches = [order[i: i + self.batch_size] for i in range(
            0, len(order) - (self.batch_size - 1 if self.drop_last else 0), self.batch_size)]
        # SEED_PARITY replays the global np.random stream in order: one worker
        workers = 1 if getattr(self.dataset, "seed_parity", False) else self.num_workers
        # worker i prepares batches i, i + workers, ...: batch k waits on
        # queue k % workers, so they come out in order, two ahead a worker
        queues = [_queue.Queue(maxsize=2) for _ in range(workers)]
        stop = object()
        errors: list = []
        closing = threading.Event()

        def worker(i):
            try:
                for idxs in batches[i::workers]:
                    if closing.is_set():
                        break
                    queues[i].put(self.dataset.collate_batch([self.dataset[int(j)]
                                                              for j in idxs]))
            except BaseException as e:  # raised in the consumer
                errors.append(e)
            finally:
                queues[i].put(stop)  # the consumer must see every worker's end

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(workers)]
        for t in threads:
            t.start()
        ended = set()
        try:
            for k in range(len(batches)):
                item = queues[k % workers].get()
                if item is stop:  # that worker failed: the others are stopped below
                    ended.add(k % workers)
                    break
                yield item
        finally:
            # a consumer that stops early: the workers end after their batch
            # in hand, and each queue is drained so that none blocks on it
            closing.set()
            for i in range(workers):
                while i not in ended:
                    if queues[i].get() is stop:
                        ended.add(i)
        if errors:
            raise RuntimeError("dataloader worker failed") from errors[0]


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False, root_path=None,
                     workers=2, logger=None, training=True, seed=666, db_infos=None):
    """(dataset, loader), the role of pcdet/datasets/__init__.py:50-81.
    With ``dist`` the loader feeds this rank's shard of each epoch
    (``PrefetchLoader``'s strided shards, equal in length): the rank and
    world of the active data mesh, else of the initialised process group,
    else one process (``com_tpu``'s ``jax.process_index`` and
    ``process_count``)."""
    process_index, process_count = 0, 1
    if dist:
        from ..parallel.mesh import rank_and_world

        process_index, process_count = rank_and_world()
    dataset = DATASETS.get(dataset_cfg["DATASET"])(
        dataset_cfg=dataset_cfg, class_names=class_names, training=training,
        root_path=root_path, logger=logger, db_infos=db_infos, seed=seed)
    loader = PrefetchLoader(dataset, batch_size, shuffle=training, seed=seed,
                            num_workers=workers, drop_last=training,
                            process_index=process_index, process_count=process_count)
    return dataset, loader
