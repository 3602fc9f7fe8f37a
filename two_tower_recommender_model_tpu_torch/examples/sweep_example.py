"""Hyperparameter sweep: a TPE search over the towers' layer sizes, both
learning rates and the batch size, ranked by val_loss; ASHA early stopping
over the same space; then a multi-seed run of the winner.

    python -m two_tower_recommender_model_tpu_torch.examples.sweep_example \\
        [--device cpu] [--trials 8] [--users 500 --items 200 --batches 120]

The port of `examples/sweep_example.py`. The trials are module-level
functions that take the device and the sizes in their config, so a sweep
can also run them in spawned worker processes (`run_sweep(...,
max_workers=N)`).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from two_tower_recommender_model_tpu_torch import config as cfg
from two_tower_recommender_model_tpu_torch.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.train import (
    create_train_state,
    evaluate,
    make_eval_step,
    make_train_step,
)
from two_tower_recommender_model_tpu_torch.train.pipeline import prefetch_to_device
from two_tower_recommender_model_tpu_torch.tuning import (
    Choice,
    LogUniform,
    multi_seed_train,
    run_sweep,
)
from two_tower_recommender_model_tpu_torch.tuning.adaptive import (
    asha_best,
    asha_total_resource,
    run_asha,
)

# the reference's space: per-tower layer sizes, the towers' and the tables'
# learning rates (log-uniform), the batch size
SPACE = {
    "layer_sizes": Choice(((64, 32), (128, 64), (128, 64, 32))),
    "mlp_lr": LogUniform(1e-4, 1e-2),
    "ebc_lr": LogUniform(1e-3, 2e-1),
    "batch_size": Choice((256, 512)),
}


def _setup(config):
    """The trial's model and train configs, dataset and featurizer."""
    users, items = config["users"], config["items"]
    mcfg = cfg.two_tower_model_config(users, items, embedding_dim=32,
                                      layer_sizes=tuple(config["layer_sizes"]))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(learning_rate=config["mlp_lr"], sparse_learning_rate=config["ebc_lr"])
    ds = SyntheticClickstream(users, items, seed=3, noise=0.05, latent_dim=4)
    return mcfg, tcfg, ds, Featurizer(mcfg, device="cpu")


def trial(config) -> dict:
    """Train `config["batches"]` batches from a fresh state on
    `config["device"]`; the validation metrics."""
    mcfg, tcfg, ds, feat = _setup(config)
    device = resolve_device(config["device"])
    state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(0),
                                          mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    for batch in prefetch_to_device(ds.batches(config["batch_size"], config["batches"]), feat,
                                    device):
        state, _ = tstep(state, batch)
    return evaluate(state, make_eval_step(mcfg, tcfg), ds.batches(512, 6, "val"), feat)


def trial_resumable(config, grow_epochs, state_pack):
    """An ASHA trial: `grow_epochs` more epochs of a third of the batches
    from the carried state; the validation metrics (`run_asha`'s contract)."""
    mcfg, tcfg, ds, feat = _setup(config)
    if state_pack is None:
        device = resolve_device(config["device"])
        state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(0),
                                              mcfg, tcfg)
        epoch = 0
    else:
        state, dense_opt, epoch = state_pack
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    for e in range(epoch, epoch + grow_epochs):
        for batch in prefetch_to_device(ds.batches(config["batch_size"],
                                                   max(1, config["batches"] // 3),
                                                   split=f"ep{e}"), feat, state.device):
            state, _ = tstep(state, batch)
    metrics = evaluate(state, make_eval_step(mcfg, tcfg), ds.batches(512, 6, "val"), feat)
    return (state, dense_opt, epoch + grow_epochs), metrics


def main(device: str | None = None, num_trials: int = 8, users: int = 500, items: int = 200,
         batches: int = 120, seeds: int = 4) -> dict:
    device = str(resolve_device(device))
    space = {**SPACE, "device": device, "users": users, "items": items, "batches": batches}

    # 1. a TPE-guided sweep: later trials concentrate near the best region seen
    result = run_sweep(trial, space, num_trials=num_trials, metric="val_loss", mode="min",
                       seed=0, search="tpe")
    print(result.table())
    best = result.best()
    print("\nbest config:", best.config)
    print("best val_loss:", round(best.metrics["val_loss"], 4),
          "val_auroc:", round(best.metrics["val_auroc"], 4))

    # 2. ASHA: bad configs are cut after one epoch, survivors train the full budget
    trials = run_asha(trial_resumable, space, num_trials=num_trials, metric="val_loss",
                      min_resource=1, max_resource=4, eta=2, seed=1)
    winner = asha_best(trials)
    print(f"\nASHA: best val_loss {winner.metric_value:.4f} at {winner.config}; "
          f"total epochs spent {asha_total_resource(trials)} "
          f"(the full budget would be {num_trials * 4})")

    # 3. the winner's seed robustness: one model per seed on the same batches
    mcfg, _, ds, _ = _setup(best.config)
    tcfg = cfg.TrainConfig(learning_rate=best.config["mlp_lr"],
                           sparse_learning_rate=best.config["ebc_lr"])
    ms = multi_seed_train(mcfg, tcfg, seeds=list(range(seeds)),
                          train_batches=ds.batches(best.config["batch_size"], batches // 2),
                          eval_batch=ds.sample(2048, "val"), device=device)
    print("multi-seed eval AUROC:", ms["eval_auroc"].round(4).tolist())
    return {"best": best.metrics, "asha_best": winner.metric_value,
            "asha_resource": asha_total_resource(trials), "multi_seed": ms}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--users", type=int, default=500)
    ap.add_argument("--items", type=int, default=200)
    ap.add_argument("--batches", type=int, default=120, help="train batches a trial")
    a = ap.parse_args()
    out = main(a.device, a.trials, a.users, a.items, a.batches)
    # above chance: one config's val AUROC spans 0.57-0.66 over initial draws
    # (either package), and the TPE path follows the trials' results
    assert out["best"]["val_auroc"] > 0.55, out
    print("SWEEP OK")
