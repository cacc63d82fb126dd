"""The group loader: sharding, per-epoch shuffles, collation into [N, V, ...]
batches, a thread pool for the images and a prefetch thread.

The reference uses torch's DataLoader with a DistributedSampler
(lib/utils/utils.py:118-153): worker processes, per-rank subsets, a reshuffle
each epoch. Here, as in the JAX package, one plain-Python loader shards the
groups, reshuffles with a per-epoch seed (``set_epoch``), draws each batch's
augmentation from a seed of its own, and collates numpy batches; the device
side is data/prepare.py. A batch's images are decoded, flipped, warped and
jittered on a pool of ``num_threads`` threads (cv2 releases the GIL there),
and a prefetch thread keeps ``prefetch`` batches ready ahead of the step.

A host's ranks each take a part of its batches (``part``): each makes every
draw of a batch, in the order one loader makes them, and decodes only its
own rows.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

COLLATE_KEYS = (
    "image", "joints_crop", "joints_vis", "supervise", "center", "scale",
    "rotation", "joints_2d", "is_h36m", "subject",
)


def collate_groups(groups: list[list[dict]]) -> dict[str, np.ndarray]:
    """Groups (each a list of V per-view records) -> {key: [N, V, ...]}
    arrays; 'image' becomes 'images' uint8 NHWC, and ``is_h36m``,
    ``subject`` and ``supervise`` are one value a group."""
    out = {}
    for key in COLLATE_KEYS:
        rows = [np.stack([view[key] for view in g]) for g in groups]
        out[key] = np.stack(rows)
    out["images"] = out.pop("image")
    out["is_h36m"] = out["is_h36m"][:, 0]
    out["subject"] = out["subject"][:, 0]
    out["supervise"] = out["supervise"][:, 0]
    return out


class GroupLoader:
    """Iterates a data set's groups in shuffled, sharded, collated batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        num_threads: int = 4,
        part: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_threads = num_threads
        # (index, count): this loader yields rows [index * B / count, (index
        # + 1) * B / count) of each batch of B, a short last batch first
        # padded to B by wrapping around its groups
        index, count = (int(x) for x in part)
        if not 0 <= index < count or batch_size % count:
            raise ValueError(f"part {part} of a batch of {batch_size} groups")
        self.part = (index, count)
        self.epoch = 0
        # per-group sampling weights (the reference's unimplemented IF_SAMPLE
        # balancing, lib/utils/utils.py:119-126): when set, each epoch draws
        # len(dataset) groups with replacement in proportion
        self.weights = None

    def _run_image_jobs(self, groups: list[list[dict]], pool) -> None:
        """Complete every deferred record of a batch: each record's decode,
        flip, warp and jitter on ``pool`` (inline where it is None). The
        first failure raises, naming its file."""
        # a group twice in a padded part is completed once
        jobs = list({id(v): v for g in groups for v in g if "_image_job" in v}.values())
        if pool is None:
            for v in jobs:
                self.dataset.finalize_record(v)
            return
        for f in [pool.submit(self.dataset.finalize_record, v) for v in jobs]:
            f.result()

    def set_weights(self, weights) -> None:
        self.weights = None if weights is None else np.asarray(weights, np.float64)

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch reshuffle seed (DistributedSampler.set_epoch,
        train.py:361)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.weights is not None and self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            p = self.weights / self.weights.sum()
            idx = rs.choice(n, size=n, replace=True, p=p)
        else:
            idx = np.arange(n)
            if self.shuffle:
                rs = np.random.RandomState(self.seed + self.epoch)
                rs.shuffle(idx)
        # pad so every shard sees the same count (DistributedSampler's)
        if self.num_shards > 1:
            per = int(np.ceil(n / self.num_shards))
            idx = np.concatenate([idx, idx[: per * self.num_shards - n]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    def batch_rows(self, b: int) -> int:
        """Groups in batch ``b`` of the whole batch, before any padding."""
        return min(self.batch_size, len(self._indices()) - b * self.batch_size)

    def _part_rows(self, n: int) -> np.ndarray:
        """This part's rows of a batch of ``n`` groups padded to the batch
        size (the mesh eval step's rule, train/loop.validate)."""
        index, count = self.part
        per = self.batch_size // count
        return (np.arange(self.batch_size) % n)[index * per:(index + 1) * per]

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]
        pool = (ThreadPoolExecutor(self.num_threads, thread_name_prefix="posetpu-images")
                if self.num_threads > 1 else None)

        def load_batch(b, batch_ids):
            rs = np.random.RandomState(
                (self.seed + self.epoch) * 100003 + b * 1009 + self.shard_index
            )
            groups = [self.dataset.load_group(int(g), rs, defer_images=True)
                      for g in batch_ids]
            if self.part[1] > 1:  # every draw made; this part's images alone
                groups = [groups[r] for r in self._part_rows(len(groups))]
            self._run_image_jobs(groups, pool)
            return collate_groups(groups)

        try:
            if self.prefetch <= 0:
                for b, ids in enumerate(batches):
                    yield load_batch(b, ids)
                return
            yield from self._prefetched(batches, load_batch)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    def _prefetched(self, batches, load_batch) -> Iterator[dict]:
        """The batches, loaded ``prefetch`` ahead on a thread of their own.
        A loader error is raised to the consumer; a consumer that stops
        early stops the thread and waits for it."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b, ids in enumerate(batches):
                    if stop.is_set() or not put(load_batch(b, ids)):
                        return
            except Exception as e:  # raised again in the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, name="posetpu-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
