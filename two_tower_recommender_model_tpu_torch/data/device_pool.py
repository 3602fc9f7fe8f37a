"""Batch pools drawn on the device, for device-resident step measurements.

Port of `two_tower_recommender_model_tpu/data/device_pool.py`: a pool of
packed batches generated where the step runs, so that no batch crosses the
host-to-device link. The draws come from a `torch.Generator` on the device;
they cannot equal the reference's `jax.random` draws, so the pool is held to
the layout that `PackedFeaturizer` gives: raw ids uniform in
[1, num_embeddings] per slot (the device hash `id % N` keeps every id but N
itself, and no id is missing), the binary label in bit 30 of slot 0 when
`pack_label` (the slot-0 id's parity: learnable, so a chained loss falls),
and rows sorted by the slot-0 key when `sort`.
"""

from __future__ import annotations

import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig
from two_tower_recommender_model_tpu_torch.device import resolve_device


def _slot_layout(model_cfg: ModelConfig) -> list[tuple[int, int]]:
    """[(slot offset, num_embeddings)], one entry per id slot."""
    out = []
    off = 0
    for fc in model_cfg.features:
        n = model_cfg.feature_table(fc.name).num_embeddings
        for _ in range(fc.max_ids_per_sample):
            out.append((off, n))
            off += 1
    return out


def device_batch_pool(model_cfg: ModelConfig, batch_size: int, pool_n: int, *,
                      pack_label: bool = True, sort: bool = False, seed: int = 0,
                      device: torch.device | str | None = None) -> torch.Tensor:
    """A `[P, B, S]` int32 pool of `ids_raw` on `device` (the card when None),
    drawn from a `torch.Generator` there seeded with `seed`. Each pool entry
    is a distinct draw."""
    device = resolve_device(device)
    slots = _slot_layout(model_cfg)
    if pack_label and slots[0][1] >= (1 << 30):
        raise ValueError("pack_label needs slot-0 table < 2^30 rows")
    gen = torch.Generator(device=device).manual_seed(seed)
    cols = [torch.randint(1, n + 1, (pool_n, batch_size), generator=gen, device=device,
                          dtype=torch.int32) for _, n in slots]
    if sort:
        # the hashed key is the raw id here (ids <= N; none missing): a stable sort
        # gives sort_packed_batch's non-decreasing slot-0 order
        order = torch.sort(cols[0], dim=1, stable=True).indices
        cols = [torch.gather(c, 1, order) for c in cols]
    if pack_label:
        cols[0] = cols[0] | ((cols[0] & 1) << 30)
    return torch.stack(cols, dim=2)
