"""Deterministic, resumable, multi-host streaming loader over TTRS shards.

The port's own copy of `two_tower_recommender_model_tpu/data/loader.py`
(numpy and the standard library): the same dataset, seed, epoch and host
slice give the same batches, batch by batch.

- determinism: the visit order is a pure function of (seed, epoch,
  host_index, num_hosts); every host sees a disjoint sample set.
- resume: `state_dict()` captures (epoch, batches_yielded);
  `load_state_dict()` fast-forwards by skipping whole shards where possible,
  so a restored run continues the exact same stream.

A background thread prefetches the next shard while the current one is being
sliced into batches.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset


class StreamLoader:
    def __init__(
        self,
        dataset: ShardedDataset | str,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        host_index: int = 0,
        num_hosts: int = 1,
        drop_last: bool = True,
        prefetch_shards: int = 2,
        columns: list[str] | None = None,
        read_workers: int = 1,
        align_hosts: str = "truncate",
    ):
        """`read_workers > 1` decodes shards concurrently (order preserved;
        zlib's inflate releases the GIL, so workers scale). The visit order is
        fixed by the plan, so workers do not change the stream.

        `align_hosts` governs multi-host step alignment (every host must take
        the same number of steps). "truncate" (the training choice) cuts all
        hosts to the global minimum batch count. "pad" (the eval choice) runs
        every host to the global maximum: hosts that run out of data yield
        0-row batches, so no sample is dropped."""
        self.dataset = ShardedDataset(dataset) if isinstance(dataset, str) else dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.prefetch_shards = prefetch_shards
        self.columns = columns
        self.read_workers = read_workers
        if align_hosts not in ("truncate", "pad"):
            raise ValueError(f"align_hosts must be 'truncate' or 'pad', got {align_hosts!r}")
        self.align_hosts = align_hosts
        self._epoch = 0
        self._batches_yielded = 0  # within the current epoch

    # -- determinism ------------------------------------------------------

    def _shard_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.dataset.num_shards)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(order)
        return order

    def _epoch_plan(self, epoch: int) -> list[int]:
        """This host's shard visit order for an epoch: round-robin over the
        epoch's shard order, so each sample belongs to exactly one host."""
        return [int(s) for s in self._shard_order(epoch)[self.host_index:: self.num_hosts]]

    def _row_perm(self, epoch: int, shard: int, n: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, shard]))
        return rng.permutation(n)

    def _batches(self, rows: int) -> int:
        return rows // self.batch_size if self.drop_last else -(-rows // self.batch_size)

    def batches_per_epoch(self, epoch: int = 0) -> int:
        if self.num_hosts > 1:
            counts = self._host_batch_counts(epoch)
            return min(counts) if self.align_hosts == "truncate" else max(counts)
        return self._batches(sum(self.dataset.shard_row_counts[s]
                                 for s in self._epoch_plan(epoch)))

    def _host_batch_counts(self, epoch: int) -> list[int]:
        """Per-host batch counts for an epoch: with unequal shard row counts,
        round-robin assignment can give hosts different counts, which
        `align_hosts` then evens out."""
        order = self._shard_order(epoch)
        return [self._batches(sum(self.dataset.shard_row_counts[int(s)]
                                  for s in order[h:: self.num_hosts]))
                for h in range(self.num_hosts)]

    def _empty_batch(self) -> dict[str, np.ndarray]:
        sch = self.dataset.schema(self.columns)
        return {k: np.zeros((0, *shape), dtype) for k, (dtype, shape) in sch.items()}

    # -- resume -----------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "epoch": self._epoch,
            "batches_yielded": self._batches_yielded,
            "seed": self.seed,
            "host_index": self.host_index,
            "num_hosts": self.num_hosts,
        }

    def load_state_dict(self, state: dict) -> None:
        if (state["seed"], state["host_index"], state["num_hosts"]) != (
                self.seed, self.host_index, self.num_hosts):
            raise ValueError(
                f"loader state {state} incompatible with loader "
                f"(seed={self.seed}, host={self.host_index}/{self.num_hosts})")
        self._epoch = state["epoch"]
        self._batches_yielded = state["batches_yielded"]

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._batches_yielded = 0

    # -- iteration --------------------------------------------------------

    @staticmethod
    def _put(out: queue.Queue, stop: threading.Event, item) -> bool:
        """A bounded-queue put that gives up once the consumer abandoned the
        iterator (the reader would otherwise block forever holding a decoded
        shard)."""
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _shard_reader_pool(self, plan: list[int], out: queue.Queue, stop: threading.Event):
        """Decode up to `read_workers` shards ahead, emit in plan order."""
        pool = ThreadPoolExecutor(max_workers=self.read_workers)
        try:
            futures = collections.deque()
            for s in plan:
                if stop.is_set():
                    return
                futures.append((s, pool.submit(self.dataset.read_shard, s, self.columns)))
                while len(futures) > self.read_workers:
                    s0, f = futures.popleft()
                    if not self._put(out, stop, (s0, f.result())):
                        return
            while futures:
                s0, f = futures.popleft()
                if not self._put(out, stop, (s0, f.result())):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            self._put(out, stop, e)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            self._put(out, stop, None)

    def _shard_reader(self, plan: list[int], out: queue.Queue, stop: threading.Event):
        try:
            for s in plan:
                if stop.is_set():
                    return
                if not self._put(out, stop, (s, self.dataset.read_shard(s, self.columns))):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            self._put(out, stop, e)
        finally:
            self._put(out, stop, None)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = self._epoch
        skip_batches = self._batches_yielded
        plan = self._epoch_plan(epoch)
        max_batches = pad_to_batches = None
        if self.num_hosts > 1:
            counts = self._host_batch_counts(epoch)
            if self.align_hosts == "truncate":
                max_batches = min(counts)
            else:  # "pad": no truncation; fill up to the global max
                pad_to_batches = max(counts)

        # Fast-forward for resume: a batch never crosses shards in reverse, so
        # whole shards that were fully consumed are dropped.
        skip_rows = skip_batches * self.batch_size
        rows_before = 0
        start_idx = 0
        for i, s in enumerate(plan):
            n = self.dataset.shard_row_counts[s]
            if rows_before + n <= skip_rows:
                rows_before += n
                start_idx = i + 1
            else:
                break
        within_shard_skip = skip_rows - rows_before

        q: queue.Queue = queue.Queue(maxsize=self.prefetch_shards)
        stop = threading.Event()
        reader = self._shard_reader_pool if self.read_workers > 1 else self._shard_reader
        t = threading.Thread(target=reader, args=(plan[start_idx:], q, stop), daemon=True)
        t.start()

        buf = _ChunkBuffer()
        first = True
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                s, cols = item
                perm = self._row_perm(epoch, s, len(next(iter(cols.values()))))
                if first and within_shard_skip:
                    perm = perm[within_shard_skip:]
                first = False
                buf.push({k: v[perm] for k, v in cols.items()})
                while buf.rows >= self.batch_size:
                    if max_batches is not None and self._batches_yielded >= max_batches:
                        self._epoch = epoch + 1  # a truncated epoch still completes
                        self._batches_yielded = 0
                        return
                    self._batches_yielded += 1
                    yield buf.take(self.batch_size)
            if (buf.rows and not self.drop_last
                    and (max_batches is None or self._batches_yielded < max_batches)):
                self._batches_yielded += 1
                yield buf.take(buf.rows)
            if pad_to_batches is not None and self._batches_yielded < pad_to_batches:
                empty = self._empty_batch()
                while self._batches_yielded < pad_to_batches:
                    self._batches_yielded += 1
                    yield {k: v.copy() for k, v in empty.items()}
        finally:
            stop.set()
        # epoch finished -> advance
        self._epoch = epoch + 1
        self._batches_yielded = 0


class _ChunkBuffer:
    """Row cursor over queued shard chunks. Batches are zero-copy views into
    the decoded shard arrays; only a batch that straddles a shard boundary
    concatenates."""

    def __init__(self):
        self.chunks: collections.deque[dict[str, np.ndarray]] = collections.deque()
        self.rows = 0
        self._head_off = 0

    def push(self, cols: dict[str, np.ndarray]) -> None:
        n = len(next(iter(cols.values())))
        if n:
            self.chunks.append(cols)
            self.rows += n

    def take(self, n: int) -> dict[str, np.ndarray]:
        parts = []
        need = n
        while need:
            head = self.chunks[0]
            avail = len(next(iter(head.values()))) - self._head_off
            use = min(avail, need)
            parts.append({k: v[self._head_off: self._head_off + use] for k, v in head.items()})
            self._head_off += use
            need -= use
            if use == avail:
                self.chunks.popleft()
                self._head_off = 0
        self.rows -= n
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
