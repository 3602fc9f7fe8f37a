"""Host -> device input pipeline: featurize and transfer ahead of compute.

Port of `two_tower_recommender_model_tpu/train/pipeline.py`. A background
thread featurizes each batch of columns on the host and copies its arrays
into pinned (page-locked) buffers; the consumer's thread issues each batch's
host-to-device copy without blocking, on a side stream, `prefetch` batches
ahead of the step that uses it, and records an event after it. When a batch
is handed out, the consumer's current stream waits on that event (on the
device: the host does not block), so the copy of batch k+1 overlaps the step
on batch k.

A batch is any nest of dataclasses (`Batch`, `SparseFeature`,
`PackedBatch`, `CompactBatch`) and dicts whose leaves are numpy arrays or tensors.

`macro_stream` groups a stream of column dicts into K-deep macro-batches (a
leading axis K on every leaf) for `train.step.make_multi_step`;
`device_put_batch` moves one host batch to a device.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.device import resolve_device


def map_leaves(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """Apply `fn` to every array leaf of a batch (numpy leaves become
    tensors first); other leaves are kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        # a read-only array (a wire cache's mmap view) is copied: a tensor owns
        # writable memory
        return fn(torch.from_numpy(arr if arr.flags.writeable else arr.copy()))
    if isinstance(obj, dict):
        return {k: map_leaves(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: map_leaves(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    return obj


def _pin(t: torch.Tensor) -> torch.Tensor:
    return t if t.device.type != "cpu" or t.is_pinned() else t.pin_memory()


def _placements(sharding) -> list:
    """The slicers of a placement: itself, or the leaves of a pytree of
    per-leaf placements (None leaves: kept whole)."""
    if callable(sharding):
        return [sharding]
    if isinstance(sharding, dict):
        return [p for v in sharding.values() for p in _placements(v)]
    if dataclasses.is_dataclass(sharding) and not isinstance(sharding, type):
        return [p for f in dataclasses.fields(sharding)
                for p in _placements(getattr(sharding, f.name))]
    if sharding is None:
        return []
    raise TypeError(f"not a placement: {sharding!r}")


def check_sharding(sharding) -> None:
    """A placement the port has: None; a callable leaf -> this rank's slice
    (`parallel.sharded.batch_sharding`); or a pytree of those, one per leaf,
    None where a leaf is kept whole (`parallel.sharded.compact_shardings`,
    the compact wire on a mesh)."""
    if sharding is not None and not _placements(sharding):
        raise ValueError("a placement pytree with no slicer in it")


def placement_device(sharding) -> torch.device:
    """The device of a placement's mesh."""
    return _placements(sharding)[0].device


def placement_parts(sharding) -> int:
    """The factor from the examples of a rank's slice to the global batch's
    (1 without a placement)."""
    return 1 if sharding is None else _placements(sharding)[0].parts


def cut_batch(batch: Any, sharding, fn: Callable[[torch.Tensor], torch.Tensor] = lambda t: t):
    """`fn` of this rank's part of every leaf: each leaf cut by `sharding`
    when it is one callable, by its own placement in a pytree of them (a
    None there keeps the leaf whole), or whole without a placement."""
    if sharding is None:
        return map_leaves(batch, fn)
    if callable(sharding):
        return map_leaves(batch, lambda t: fn(sharding(t)))
    if isinstance(batch, dict):
        return {k: cut_batch(v, sharding.get(k), fn) for k, v in batch.items()}
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(batch, **{
            f.name: cut_batch(getattr(batch, f.name), getattr(sharding, f.name), fn)
            for f in dataclasses.fields(batch)})
    return map_leaves(batch, fn)


def device_put_batch(batch: Any, device: torch.device | str | None = None, sharding=None) -> Any:
    """A host batch with every array leaf on `device` (the card when None).
    `sharding` (`parallel.sharded.batch_sharding` or `macro_batch_sharding`
    of a mesh, or a pytree of per-leaf placements: `compact_shardings`) cuts
    each leaf to this rank's slice of the batch first, and `device` then
    defaults to the mesh's."""
    check_sharding(sharding)
    if sharding is not None:
        device = placement_device(sharding) if device is None else torch.device(device)
        return cut_batch(batch, sharding, lambda t: t.to(device))
    device = resolve_device(device)
    return map_leaves(batch, lambda t: t.to(device))


def _pooled(columns_iter: Iterable[dict], make: Callable, workers: int) -> Iterator:
    """`make(cols)` for each item on `workers` threads, yielded in the
    stream's order, at most `workers + 1` items ahead of the consumer."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    futures: collections.deque = collections.deque()
    try:
        for cols in columns_iter:
            futures.append(pool.submit(make, cols))
            if len(futures) > workers + 1:
                yield futures.popleft().result()
        while futures:
            yield futures.popleft().result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _background(columns_iter: Iterable[dict], make: Callable, depth: int) -> Iterator:
    """`make(cols)` for each item, run ahead by a worker thread; its errors
    are raised in the consumer, and the thread stops when the consumer does."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = object()
    abandoned = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for cols in columns_iter:
                if not put(make(cols)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            err.append(e)
        finally:
            put(stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        abandoned.set()


def prefetch_to_device(columns_iter: Iterable[dict], featurize: Callable[[dict], Any],
                       device: torch.device | str | None = None,
                       prefetch: int = 2, num_workers: int = 1, sharding=None) -> Iterator[Any]:
    """Yield batches on `device`, keeping `prefetch` host-to-device copies in
    flight. `featurize` builds a host batch from a dict of columns, in a
    background thread; `num_workers > 1` featurizes on that many threads
    (order kept), for when the host's featurization limits the throughput.
    `sharding` cuts each host batch to this rank's slice before it is pinned
    and copied (`device_put_batch`); `device` then defaults to the mesh's."""
    check_sharding(sharding)
    if sharding is not None and device is None:
        device = placement_device(sharding)
    device = resolve_device(device)
    cuda = device.type == "cuda"

    def host_batch(cols):
        return cut_batch(featurize(cols), sharding, _pin if cuda else (lambda t: t))

    if num_workers > 1:
        source = _pooled(columns_iter, host_batch, num_workers)
    else:
        source = _background(columns_iter, host_batch, prefetch)
    if not cuda:
        for hb in source:
            yield map_leaves(hb, lambda t: t.to(device))
        return
    side = torch.cuda.Stream(device)
    buf: collections.deque = collections.deque()

    def hand_out():
        batch, ready = buf.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)

        def adopt(t: torch.Tensor) -> torch.Tensor:
            t.record_stream(consumer)  # allocated on the side stream, used on this one
            return t
        return map_leaves(batch, adopt)

    for hb in source:
        with torch.cuda.stream(side):
            moved = map_leaves(hb, lambda t: t.to(device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(side)
        buf.append((moved, ready))
        if len(buf) > prefetch:
            yield hand_out()
    while buf:
        yield hand_out()


def macro_stream(columns_iter: Iterable[dict], packed_featurizer: Callable[[dict], Any],
                 k: int) -> Iterator[Any]:
    """Group a per-batch column stream into K-deep host macro-batches for
    `train.step.make_multi_step` (a leading axis K on every leaf). A trailing
    partial group is dropped: a macro-batch's shape is fixed (on the card it
    is the shape a CUDA graph was captured for)."""
    from two_tower_recommender_model_tpu_torch.train.step import stack_batches

    group = []
    for cols in columns_iter:
        group.append(packed_featurizer(cols))
        if len(group) == k:
            yield stack_batches(group)
            group = []
