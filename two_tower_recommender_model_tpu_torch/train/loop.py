"""Training and eval loops.

Port of `two_tower_recommender_model_tpu/train/loop.py` (`evaluate`,
`train_one_epoch`, `train_one_epoch_packed`, `train_val_test`) for one device:

- a baseline validation eval before any training,
- per epoch: train -> validation eval -> metric logging -> checkpoint,
- optional mid-epoch validation every `validation_freq` steps,
- `limit_{train,val,test}_batches` truncation,
- per-epoch retrieval metrics (`retrieval_eval_fn`) and the best epoch's
  state kept by a named validation metric (`select_best`),
- a final test eval.

Batches come through `train.pipeline.prefetch_to_device` onto the state's
device. The training loss is read once, at the end of the epoch, so the
host never waits for the card inside the loop.

`train_one_epoch_packed` is the high-throughput epoch: packed (or compact)
batches, grouped K at a time into macro-batches that `train.step.make_multi_step`
trains in one call (on the card: one replay of a CUDA graph of K steps).

On a mesh (`parallel/`) the loops take the reference's `sharding` (this
rank's slice of each global batch: `parallel.sharded.batch_sharding`, or
`macro_batch_sharding` for the packed epoch's macro-batches and the per-leaf
`compact_shardings` for compact ones), `pad_multiple`
(eval batches padded with zero-weight rows to a multiple of the data ranks)
and `pad_to` (every eval batch padded to that many rows, a 0-row one into a
batch of padding that still runs its step and its collectives). Every rank
of a host runs the same batches, and every host as many (`--multi-host`:
the loader's `align_hosts`), so every rank runs every collective. The all-to-all
exchange's overflow counts (`exchange_overflow`, summed over the mesh) are
added up on the device and read once: `evaluate` raises at the end of its
pass, the epochs at the end of the epoch, with the reference's messages.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Iterable

import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_recommender_model_tpu_torch.data.featurizer import pad_batch, pad_batch_to
from two_tower_recommender_model_tpu_torch.models.metrics import auroc_compute, mean_compute
from two_tower_recommender_model_tpu_torch.train.pipeline import (
    check_sharding,
    device_put_batch,
    placement_parts,
    prefetch_to_device,
)
from two_tower_recommender_model_tpu_torch.train.step import (
    TrainState,
    eval_state_init,
    stack_batches,
)

log = logging.getLogger(__name__)


def evaluate(state: TrainState, eval_step: Callable, batches: Iterable[dict], featurizer,
             limit_batches: int | None = None, stage: str = "val", sharding=None,
             pad_multiple: int | None = None, pad_to: int | None = None) -> dict[str, float]:
    """One pass of eval: {"<stage>_loss", "<stage>_auroc"}. `pad_multiple`
    pads ragged batches with zero-weight rows so they split over the data
    ranks without dropping or skewing a sample; `pad_to` pads every batch to
    that many rows, a 0-row batch into one of padding alone."""
    es = eval_state_init(device=state.device)
    it = iter(batches)
    if limit_batches is not None:
        it = itertools.islice(it, limit_batches)
    featurize = featurizer
    if pad_to:
        featurize = lambda cols: pad_batch_to(featurizer(cols), pad_to)  # noqa: E731
    elif pad_multiple:
        featurize = lambda cols: pad_batch(featurizer(cols), pad_multiple)  # noqa: E731
    n = 0
    for batch in prefetch_to_device(it, featurize, state.device, sharding=sharding):
        es = eval_step(state, es, batch)
        n += 1
    loss = float(mean_compute(es.loss)) if n else float("nan")
    auroc = float(auroc_compute(es.auroc)) if n else float("nan")
    if es.exchange_overflow is not None and int(es.exchange_overflow) > 0:
        raise RuntimeError(
            f"{stage} eval dropped {int(es.exchange_overflow)} distinct ids "
            "past the alltoall bucket capacity — metrics would be computed "
            "on corrupted pooled embeddings; raise "
            "TrainConfig.exchange_capacity_factor (or use the dense exchange)"
        )
    return {f"{stage}_loss": loss, f"{stage}_auroc": auroc}


def _accumulate_overflow(total, out: dict):
    """The all-to-all exchange's dropped-id counts summed over the steps, on
    the device (no read in the loop); checked once at the epoch's end by
    `_check_overflow`."""
    ovf = out.get("exchange_overflow")
    if ovf is None:
        return total
    ovf = ovf.sum() if ovf.dim() else ovf
    return ovf if total is None else total + ovf


def _check_overflow(total, where: str) -> None:
    if total is not None and int(total) > 0:
        raise RuntimeError(
            f"{where}: the alltoall exchange dropped {int(total)} distinct "
            "ids past its bucket capacity this epoch — their embeddings did "
            "not train. This is a configuration error: raise "
            "TrainConfig.exchange_capacity_factor (or use "
            "sharded_exchange='dense')."
        )


def train_one_epoch(state: TrainState, train_step: Callable, batches: Iterable[dict],
                    featurizer, train_cfg: TrainConfig, eval_step: Callable | None = None,
                    val_batches_factory: Callable[[], Iterable[dict]] | None = None,
                    logger=None, epoch: int = 0, sharding=None, pad_multiple: int | None = None,
                    pad_to: int | None = None) -> tuple[TrainState, dict[str, float]]:
    it = iter(batches)
    if train_cfg.limit_train_batches is not None:
        it = itertools.islice(it, train_cfg.limit_train_batches)
    steps = examples = 0
    t0 = time.perf_counter()
    last_loss = overflow = None
    parts = placement_parts(sharding)
    for batch in prefetch_to_device(it, featurizer, state.device, sharding=sharding):
        state, out = train_step(state, batch)
        last_loss = out["loss"]
        overflow = _accumulate_overflow(overflow, out)
        steps += 1
        examples += batch.batch_size * parts
        if (train_cfg.validation_freq and eval_step is not None
                and val_batches_factory is not None and steps % train_cfg.validation_freq == 0):
            metrics = evaluate(state, eval_step, val_batches_factory(), featurizer,
                               train_cfg.limit_val_batches, "val", sharding, pad_multiple,
                               pad_to)
            log.info("epoch %d step %d mid-epoch %s", epoch, steps, metrics)
            if logger is not None:
                logger.log_metrics(metrics, step=state.step)
    if last_loss is not None:
        last_loss = float(last_loss)  # the one read of the epoch
    _check_overflow(overflow, f"epoch {epoch}")
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)  # the last step's updates are in the time
    dt = time.perf_counter() - t0
    return state, {
        "train_steps": steps,
        "train_examples": examples,
        "train_loss": last_loss if last_loss is not None else float("nan"),
        "examples_per_sec": examples / dt if dt > 0 else 0.0,
        "epoch_time_s": dt,
    }


def train_val_test(state: TrainState, train_step: Callable, eval_step: Callable,
                   model_cfg: ModelConfig, train_cfg: TrainConfig, featurizer,
                   train_batches_factory: Callable[[int], Iterable[dict]],
                   val_batches_factory: Callable[[], Iterable[dict]],
                   test_batches_factory: Callable[[], Iterable[dict]], logger=None,
                   checkpoint_fn: Callable[[TrainState, int], None] | None = None,
                   sharding=None, pad_multiple: int | None = None, pad_to: int | None = None,
                   start_epoch: int = 0,
                   train_epoch_fn: Callable | None = None,
                   select_best: str | None = None,
                   retrieval_eval_fn: Callable[[TrainState], dict[str, float]] | None = None,
                   ) -> tuple[TrainState, dict[str, float]]:
    """Baseline val eval, then epochs [start_epoch, epochs) of train + val,
    then a test eval. Returns the state and a dict of every metric
    (`baseline_val_*`, the last epoch's `val_*` and train stats, `test_*`).

    `train_epoch_fn(state, epoch) -> (state, stats)` replaces the inner epoch
    while the baseline eval, per-epoch validation and checkpoints stay here.

    `retrieval_eval_fn(state) -> {"val_recall_at_100": ...}` (see
    `evaluation.retrieval.make_retrieval_eval_fn`) merges retrieval metrics
    into every epoch's validation metrics.

    `select_best` names a per-epoch validation metric (a name containing
    "loss" means lower is better): the state of the best epoch is kept, the
    final test eval runs on it, it is what is returned, and the results hold
    `best_epoch`. The kept state is a copy, because a train step updates its
    state in place.

    `sharding`, `pad_multiple` and `pad_to` go to every eval and to the
    per-batch epoch (`evaluate`)."""
    del model_cfg  # the reference's signature; the state's model carries it
    results: dict[str, float] = {}
    best_state, best_metric, best_epoch = None, None, None

    def improved(val):
        if best_metric is None:
            return True
        return val < best_metric if "loss" in select_best else val > best_metric

    metrics = evaluate(state, eval_step, val_batches_factory(), featurizer,
                       train_cfg.limit_val_batches, "val", sharding, pad_multiple, pad_to)
    if retrieval_eval_fn is not None:
        metrics.update(retrieval_eval_fn(state))
    log.info("baseline %s", metrics)
    results.update({f"baseline_{k}": v for k, v in metrics.items()})
    if logger is not None:
        logger.log_metrics(results, step=0)
    for epoch in range(start_epoch, train_cfg.epochs):
        if train_epoch_fn is not None:
            state, stats = train_epoch_fn(state, epoch)
        else:
            state, stats = train_one_epoch(state, train_step, train_batches_factory(epoch),
                                           featurizer, train_cfg, eval_step,
                                           val_batches_factory, logger, epoch, sharding,
                                           pad_multiple, pad_to)
        metrics = evaluate(state, eval_step, val_batches_factory(), featurizer,
                           train_cfg.limit_val_batches, "val", sharding, pad_multiple, pad_to)
        if retrieval_eval_fn is not None:
            metrics.update(retrieval_eval_fn(state))
        log.info("epoch %d train %s val %s", epoch, stats, metrics)
        results.update(metrics)
        results.update(stats)
        if logger is not None:
            logger.log_metrics({**stats, **metrics, "epoch": epoch}, step=state.step)
        if checkpoint_fn is not None and (epoch + 1) % train_cfg.checkpoint_every_epochs == 0:
            checkpoint_fn(state, epoch)
        if select_best is not None and improved(metrics[select_best]):
            best_metric, best_epoch = metrics[select_best], epoch
            best_state = state.copy()
    if best_state is not None:
        log.info("select_best: epoch %d (%s=%.5f)", best_epoch, select_best, best_metric)
        results["best_epoch"] = float(best_epoch)
        state = best_state
    metrics = evaluate(state, eval_step, test_batches_factory(), featurizer,
                       train_cfg.limit_test_batches, "test", sharding, pad_multiple, pad_to)
    log.info("test %s", metrics)
    results.update(metrics)
    if logger is not None:
        logger.log_metrics(metrics, step=state.step)
    return state, results


def _macro_dims(mb) -> tuple[int, int]:
    """(K steps, B examples a step) of a stacked macro payload: a
    `PackedBatch` (`ids_raw [K, B, S]`) or a `CompactBatch` (`wire [K, W, B]`,
    the batch axis last)."""
    if hasattr(mb, "wire"):
        return mb.wire.shape[0], mb.wire.shape[-1]
    return mb.ids_raw.shape[0], mb.ids_raw.shape[1]


def train_one_epoch_packed(state: TrainState, multi_step: Callable, batches: Iterable[dict],
                           packed_featurizer, macro: int = 16, prefetch: int = 2,
                           num_workers: int = 2, train_cfg: TrainConfig | None = None,
                           tail_step: Callable | None = None, eval_step: Callable | None = None,
                           val_batches_factory: Callable[[], Iterable[dict]] | None = None,
                           val_featurizer=None, logger=None, epoch: int = 0,
                           sharding=None, tail_sharding=None, val_sharding=None,
                           pad_multiple: int | None = None, pad_to: int | None = None,
                           ) -> tuple[TrainState, dict[str, float]]:
    """The high-throughput epoch: packed batches, device-side featurization
    and K-step macro-batches through `make_multi_step`, with the surface of
    `train_one_epoch`:

    - `train_cfg.limit_train_batches` truncation,
    - mid-epoch validation every `train_cfg.validation_freq` steps, checked
      at macro boundaries (through `val_featurizer`, or the packed featurizer
      with a packed eval step),
    - a trailing partial macro fed batch by batch through `tail_step` (e.g.
      `make_packed_train_step(...)`) instead of being dropped; without a
      `tail_step` it is dropped.

    `num_workers` threads featurize and stack macro groups, in order. On a
    mesh `sharding` cuts each macro-batch (`macro_batch_sharding`, or for
    compact batches the per-leaf `compact_shardings`), `tail_sharding` each
    tail batch (`batch_sharding`, `compact_shardings(macro=False)`), and the mid-epoch
    validation takes `val_sharding`, `pad_multiple` and `pad_to`."""
    for placement in (sharding, tail_sharding, val_sharding):
        check_sharding(placement)
    it = iter(batches)
    if train_cfg is not None and train_cfg.limit_train_batches is not None:
        it = itertools.islice(it, train_cfg.limit_train_batches)
    vfreq = train_cfg.validation_freq if train_cfg is not None else None
    can_validate = vfreq and eval_step is not None and val_batches_factory is not None
    tail: list = []

    def groups():
        g = []
        for cols in it:
            g.append(cols)
            if len(g) == macro:
                yield g
                g = []
        tail.extend(g)

    def assemble(group):
        return stack_batches([packed_featurizer(c) for c in group])

    def maybe_validate(steps, next_val):
        if not can_validate or steps < next_val:
            return next_val
        metrics = evaluate(state, eval_step, val_batches_factory(),
                           val_featurizer or packed_featurizer, train_cfg.limit_val_batches,
                           "val", val_sharding, pad_multiple, pad_to)
        log.info("epoch %d step %d mid-epoch %s", epoch, steps, metrics)
        if logger is not None:
            logger.log_metrics(metrics, step=state.step)
        while next_val <= steps:
            next_val += vfreq
        return next_val

    steps = examples = 0
    next_val = vfreq or 0
    t0 = time.perf_counter()
    last_loss = overflow = None
    parts = placement_parts(sharding)
    for mb in prefetch_to_device(groups(), assemble, state.device, prefetch=prefetch,
                                 num_workers=num_workers, sharding=sharding):
        state, out = multi_step(state, mb)
        last_loss = out["loss"][-1]
        overflow = _accumulate_overflow(overflow, out)
        k, b = _macro_dims(mb)
        steps += k
        examples += k * b * parts
        next_val = maybe_validate(steps, next_val)
    if tail and tail_step is not None:
        for cols in tail:
            pb = device_put_batch(packed_featurizer(cols), state.device, tail_sharding)
            state, out = tail_step(state, pb)
            last_loss = out["loss"]
            overflow = _accumulate_overflow(overflow, out)
            steps += 1
            examples += pb.batch_size * placement_parts(tail_sharding)
            next_val = maybe_validate(steps, next_val)
    if last_loss is not None:
        last_loss = float(last_loss)  # the one read of the epoch
    _check_overflow(overflow, f"epoch {epoch}")
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    dt = time.perf_counter() - t0
    return state, {
        "train_steps": steps,
        "train_examples": examples,
        "train_loss": last_loss if last_loss is not None else float("nan"),
        "examples_per_sec": examples / dt if dt > 0 else 0.0,
        "epoch_time_s": dt,
    }
