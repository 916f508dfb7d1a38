"""Batch iterator with deterministic shuffling and background prefetch.

Replaces torch ``DataLoader`` + ``DistributedSampler`` (``dataloader.py:513-532``).
Differences, all TPU-motivated:

* static batch shapes (see ``collate``); training drops the last partial batch,
  eval pads it and reports ``n_valid``,
* per-epoch deterministic shuffle via ``epoch`` seed — the equivalent of
  ``DistributedSampler.set_epoch`` (``train.py:236``),
* no per-rank sharded sampler: under GSPMD one *global* batch is assembled on
  host and ``jax.device_put`` with a NamedSharding splits it over the data mesh
  axis (``vct_tpu.parallel``); the sampler-per-process machinery disappears,
* optional double-buffered prefetch on a background thread so host feature
  loading overlaps device compute (the torch version uses worker processes).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from vct_tpu_torch.data.collate import Batch, collate
from vct_tpu_torch.data.datasets import CoreDataset


class DataLoader:
    def __init__(
        self,
        dataset: CoreDataset,
        batch_size: int,
        *,
        max_frames: int = 12,
        preprocessor=None,
        shuffle: bool = False,
        drop_last: Optional[bool] = None,
        seed: int = 666,
        prefetch: int = 2,
        native: Optional[bool] = None,
        feat_dtype=np.float32,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_frames = max_frames
        self.preprocessor = preprocessor
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.prefetch = prefetch
        # float16 batches halve/quarter host->device transfer bytes (the e2e
        # bottleneck on narrow links); the model casts inputs to its compute
        # dtype on device (encoder.py: src.astype(self.dtype))
        self.feat_dtype = np.dtype(feat_dtype)
        self.epoch = 0
        if native is None:  # auto: use the C++ batch loader when it builds
            from vct_tpu_torch.data import native as native_mod

            native = native_mod.available()
        self.native = native

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.permutation(n)
        return np.arange(n)

    def _batches(self) -> Iterator[Batch]:
        order = self._order()
        bs = self.batch_size
        limit = (len(order) // bs) * bs if self.drop_last else len(order)
        for start in range(0, limit, bs):
            idx = order[start : start + bs]
            if self.native:
                from vct_tpu_torch.data.native import collate_from_dataset

                try:
                    # build INSIDE try, yield OUTSIDE: with prefetch<=0 an
                    # exception the consumer raises while processing the
                    # batch is thrown into this generator at the yield —
                    # it must propagate, not trip the native fallback and
                    # re-yield the same indices as a duplicate batch
                    batch = collate_from_dataset(
                        self.dataset, idx,
                        batch_size=bs,
                        max_frames=self.max_frames,
                        preprocessor=self.preprocessor,
                        feat_dtype=self.feat_dtype,
                    )
                except (IOError, RuntimeError) as e:
                    from vct_tpu_torch.data.native import NativeLoaderTooOld

                    recoverable = isinstance(e, NativeLoaderTooOld) or (
                        isinstance(e, IOError) and "unsupported dtype" in str(e)
                    )
                    if not recoverable:
                        raise
                    # dataset uses a dtype the C loader doesn't cover (the
                    # C++ side reports it through the IOError message), or a
                    # stale prebuilt .so lacks the f16 entry point — fall
                    # back to the Python path permanently (same results,
                    # load_feature casts via numpy)
                    self.native = False
                else:
                    yield batch
                    continue
            items = [self.dataset[int(i)] for i in idx]
            batch = collate(
                items,
                batch_size=bs,
                max_frames=self.max_frames,
                preprocessor=self.preprocessor,
            )
            if self.feat_dtype != np.float32:
                # same fp32 -> fp16 rounding as the native f16 path
                import dataclasses

                batch = dataclasses.replace(
                    batch,
                    feats=[f.astype(self.feat_dtype) for f in batch.feats],
                )
            yield batch

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        stop = threading.Event()

        def put_until_stop(item) -> bool:
            """Bounded put with a stop check: if the consumer abandons the
            iterator mid-epoch (break / GeneratorExit), the thread must not
            stay blocked on a full queue forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._batches():
                    if not put_until_stop(b):
                        return
            except BaseException as e:  # noqa: BLE001
                err.append(e)
            finally:
                put_until_stop(sentinel)  # must land even when the queue is full

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # normal exhaustion: stop is a no-op, join returns immediately.
            # abandoned iterator (break/GeneratorExit): unblock + reap the
            # producer and drop the prefetched batches it was holding
            stop.set()
            t.join()
        if err:
            raise err[0]


def build_dataloader(split_cfg, tpu_cfg, preprocessor=None) -> "tuple[CoreDataset, DataLoader]":
    """Config-driven factory mirroring the reference ``build_dataloader``
    signature semantics (``dataloader.py:513-532``): shuffle only the train
    split. Returns (dataset, loader)."""
    from vct_tpu_torch.data.datasets import build_dataset

    ds = build_dataset(split_cfg)
    is_train = split_cfg.split_mode == "train"
    loader = DataLoader(
        ds,
        split_cfg.batch_size,
        max_frames=tpu_cfg.max_frames,
        preprocessor=preprocessor,
        shuffle=is_train,
        seed=tpu_cfg.seed,
        feat_dtype=np.dtype(getattr(tpu_cfg, "feat_transfer_dtype", "float32")),
    )
    return ds, loader
