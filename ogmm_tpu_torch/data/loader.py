"""Batched prefetching loader and the dataset factory of the port.

A thread pool maps `__getitem__` over index batches and a bounded queue
keeps `PREFETCH` collated batches (dict of numpy arrays) ready; the train
step moves them to the card. The test split seeds the global `np.random`
per item (SetDeterministic), so its items are fetched one at a time under a
lock and thread interleaving cannot change the draws; the training split
runs in parallel. A copy of the JAX package's `ogmm_tpu/data/loader.py`.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

# collated batches a loader keeps ready
PREFETCH = 2


def _collate(items) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}


class PrefetchLoader:
    """Iterable over collated batches with background prefetch; with
    `shuffle` the order of epoch e comes from RandomState(seed + e)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 6,
                 seed: Optional[int] = None, serialize_items: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.serialize_items = serialize_items
        self._epoch = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(
                None if self.seed is None else self.seed + self._epoch)
            rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _fetch(self, idxs) -> Dict[str, np.ndarray]:
        if self.serialize_items:
            with self._lock:
                items = [self.dataset[int(i)] for i in idxs]
        else:
            items = [self.dataset[int(i)] for i in idxs]
        return _collate(items)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices()
        self._epoch += 1
        if not batches:
            return
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        it = iter(batches)
        it_lock = threading.Lock()

        def worker():
            while not stop.is_set():
                with it_lock:
                    idxs = next(it, None)
                if idxs is None:
                    break
                try:
                    q.put((self._fetch(idxs), None))
                except Exception as e:  # handed to the consumer, raised there
                    q.put((None, e))
                    break

        n_workers = 1 if self.serialize_items else min(
            self.num_workers, len(batches))
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(len(batches)):
                batch, err = q.get()
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()
            while not q.empty():            # unblock the producers
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class ListAsDict:
    """A dataset of [src, tgt, tsfm] items (`ModelNetDV`) in the dict
    layout the trainer reads: overlaps of ones, the (3, 4) transform."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        src, tgt, tsfm = self.dataset[i][:3]
        return {
            'src_xyz': src.astype(np.float32),
            'tgt_xyz': tgt.astype(np.float32),
            'src_overlap': np.ones(len(src), np.float32),
            'tgt_overlap': np.ones(len(tgt), np.float32),
            'transform_gt': np.asarray(tsfm, np.float32)[:3, :4],
        }


def _check_overlap_thresh(dataset_cls, t):
    """With `device_overlap` the step remakes the labels at
    TrainConfig.overlap_thresh: refuse a radius other than the dataset's
    own."""
    if t.device_overlap and t.overlap_thresh != dataset_cls.overlap_thresh:
        raise ValueError(
            f"TrainConfig.overlap_thresh={t.overlap_thresh} but "
            f"{dataset_cls.__name__} computes host labels at "
            f"{dataset_cls.overlap_thresh}; set overlap_thresh="
            f"{dataset_cls.overlap_thresh} when device_overlap is on")


def data_loader(cfg):
    """(train_loader, test_loader) of cfg.data.dataset: `modelnet` (h5 files
    under cfg.data.root), `synthetic` (cfg.data.root 'synthetic[:S]'), the
    variants `modelnetcp` and `modelnetdv` (either source), `7scene` (.ply
    fragments under <root>/7scene) or `icl_nuim` (h5 files under
    <root>/icl_nuim). With `device_overlap` the indoor datasets emit no
    host labels: the step makes them."""
    d, t = cfg.data, cfg.train
    name = d.dataset
    if name in ("modelnet", "synthetic"):
        from ogmm_tpu_torch.data.modelnet import ModelNetHdf, get_transforms
        root = d.root if d.root.startswith("synthetic") else (
            "synthetic" if name == "synthetic" else d.root)
        train_tf, test_tf = get_transforms(d.noise_type, d.rot_mag,
                                           d.trans_mag, d.n_points,
                                           list(d.partial))
        train_data = ModelNetHdf(root, unseen=d.unseen, transform=train_tf,
                                 partition='train')
        test_data = ModelNetHdf(root, unseen=d.unseen, transform=test_tf,
                                partition='test')
        serialize_test = True          # the test chain seeds np.random
    elif name == "modelnetcp":
        from ogmm_tpu_torch.data.modelnet import ModelNetCP
        train_data, test_data = (
            ModelNetCP(d.root, d.n_points, d.rot_mag, d.trans_mag, d.unseen,
                       list(d.partial)[:1], d.noise_type, partition=part)
            for part in ("train", "test"))
        serialize_test = True          # the test items seed np.random
    elif name == "modelnetdv":
        from ogmm_tpu_torch.data.modelnet import ModelNetDV
        train_data, test_data = (
            ListAsDict(ModelNetDV(d.root, partition=part, unseen=d.unseen))
            for part in ("train", "test"))
        serialize_test = True
    elif name in ("7scene", "icl_nuim"):
        from ogmm_tpu_torch.data.realdata import IclNuim, Scene7
        cls = Scene7 if name == "7scene" else IclNuim
        _check_overlap_thresh(cls, t)
        train_data, test_data = (
            cls(d.root, d.n_points, list(d.partial), part,
                fix_tgt_overlap=d.fix_tgt_overlap,
                compute_overlap=not t.device_overlap)
            for part in ("train", "test"))
        # IclNuim seeds np.random per item; Scene7's test items do not
        serialize_test = name == "icl_nuim"
    else:
        raise ValueError(f"unknown dataset {name!r}")
    train_loader = PrefetchLoader(train_data, t.batch_size, shuffle=True,
                                  drop_last=True, num_workers=d.num_workers,
                                  seed=t.seed)
    test_loader = PrefetchLoader(test_data, t.test_batch_size, shuffle=False,
                                 drop_last=False, num_workers=d.num_workers,
                                 serialize_items=serialize_test)
    return train_loader, test_loader
