"""Training and eval loops.

Port of `two_tower_recommender_model_tpu/train/loop.py` (`evaluate`,
`train_one_epoch`, `train_val_test`) for one device:

- a baseline validation eval before any training,
- per epoch: train -> validation eval -> metric logging -> checkpoint,
- optional mid-epoch validation every `validation_freq` steps,
- `limit_{train,val,test}_batches` truncation,
- per-epoch retrieval metrics (`retrieval_eval_fn`) and the best epoch's
  state kept by a named validation metric (`select_best`),
- a final test eval.

Batches come through `train.pipeline.prefetch_to_device` onto the state's
device. The training loss is read once, at the end of the epoch, so the
host never waits for the card inside the loop. The reference's sharding,
padding and exchange-overflow arguments, and `train_one_epoch_packed` with
its macro-steps, are not ported yet.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Iterable

import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_recommender_model_tpu_torch.models.metrics import auroc_compute, mean_compute
from two_tower_recommender_model_tpu_torch.train.pipeline import prefetch_to_device
from two_tower_recommender_model_tpu_torch.train.step import TrainState, eval_state_init

log = logging.getLogger(__name__)


def evaluate(state: TrainState, eval_step: Callable, batches: Iterable[dict], featurizer,
             limit_batches: int | None = None, stage: str = "val") -> dict[str, float]:
    """One pass of eval: {"<stage>_loss", "<stage>_auroc"}."""
    es = eval_state_init(device=state.device)
    it = iter(batches)
    if limit_batches is not None:
        it = itertools.islice(it, limit_batches)
    n = 0
    for batch in prefetch_to_device(it, featurizer, state.device):
        es = eval_step(state, es, batch)
        n += 1
    loss = float(mean_compute(es.loss)) if n else float("nan")
    auroc = float(auroc_compute(es.auroc)) if n else float("nan")
    return {f"{stage}_loss": loss, f"{stage}_auroc": auroc}


def train_one_epoch(state: TrainState, train_step: Callable, batches: Iterable[dict],
                    featurizer, train_cfg: TrainConfig, eval_step: Callable | None = None,
                    val_batches_factory: Callable[[], Iterable[dict]] | None = None,
                    logger=None, epoch: int = 0) -> tuple[TrainState, dict[str, float]]:
    it = iter(batches)
    if train_cfg.limit_train_batches is not None:
        it = itertools.islice(it, train_cfg.limit_train_batches)
    steps = examples = 0
    t0 = time.perf_counter()
    last_loss = None
    for batch in prefetch_to_device(it, featurizer, state.device):
        state, out = train_step(state, batch)
        last_loss = out["loss"]
        steps += 1
        examples += batch.batch_size
        if (train_cfg.validation_freq and eval_step is not None
                and val_batches_factory is not None and steps % train_cfg.validation_freq == 0):
            metrics = evaluate(state, eval_step, val_batches_factory(), featurizer,
                               train_cfg.limit_val_batches, "val")
            log.info("epoch %d step %d mid-epoch %s", epoch, steps, metrics)
            if logger is not None:
                logger.log_metrics(metrics, step=state.step)
    if last_loss is not None:
        last_loss = float(last_loss)  # the one read of the epoch
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
    state in place."""
    del model_cfg  # the reference's signature; the state's model carries it
    results: dict[str, float] = {}
    best_state, best_metric, best_epoch = None, None, None

    def improved(val):
        if best_metric is None:
            return True
        return val < best_metric if "loss" in select_best else val > best_metric

    metrics = evaluate(state, eval_step, val_batches_factory(), featurizer,
                       train_cfg.limit_val_batches, "val")
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
                                           val_batches_factory, logger, epoch)
        metrics = evaluate(state, eval_step, val_batches_factory(), featurizer,
                           train_cfg.limit_val_batches, "val")
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
                       train_cfg.limit_test_batches, "test")
    log.info("test %s", metrics)
    results.update(metrics)
    if logger is not None:
        logger.log_metrics(metrics, step=state.step)
    return state, results
