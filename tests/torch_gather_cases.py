"""Inputs for the card tests of the two pooled gathers (kernels #1 and #5):
batch sizes at the edges of their launch plan (`ops/gather_plan.py`), bags
with dead slots at chosen places, and tensors that start off a 16-byte
boundary. Imports torch, numpy and the port, no JAX: the card tests use it."""

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.ops.gather_plan import (
    WARPS_PER_BLOCK,
    WINDOW,
    Walk,
    gather_plan,
)

SLOTS = [1, 3, 7, 40]  # 40: a bag of more slots than one id load holds
DEAD_AT = ["first", "middle", "last"]


def edge_batches(bag_l: int, d: int, elem_bytes: int, sms: int,
                 blocks_per_sm: dict[Walk, int]) -> list[int]:
    """1, 31, 32, 33, and the wide path plan's boundaries, each -1, 0, +1:
    the bags of a warp and of a block at small B, the batch past which one
    slot a bag leaves the one-item walk for runs, and the batch past which
    runs hold all the bags one id load covers. `blocks_per_sm`: what the
    kernel library reports for the card."""
    r = gather_plan(64, bag_l, d, elem_bytes, True, sms, blocks_per_sm).bags_per_warp
    walk = Walk.RUNS if bag_l == 1 else Walk.ITEMS
    longest = max(1, WINDOW // bag_l)
    edges = {1, 31, 32, 33, r, r * WARPS_PER_BLOCK,
             sms * blocks_per_sm[walk] * WARPS_PER_BLOCK * longest}
    if bag_l == 1:
        edges.add(sms * blocks_per_sm[Walk.ONE] * WARPS_PER_BLOCK * r)
    return sorted({e + k for e in edges for k in (-1, 0, 1) if e + k > 0})


def bags(rng, n: int, b: int, bag_l: int, dead_at: str) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] int32 ids in [0, N) and f32 weights in (0, 1], with dead slots
    (the sentinel N, a negative id, a zero weight) in turn in slot 0, the
    middle slot or the last, and a few more anywhere."""
    ids = rng.integers(0, n, (b, bag_l))
    w = (rng.random((b, bag_l)) * 0.9 + 0.1).astype(np.float32)
    if bag_l == 1:
        w[:] = 1.0
    if bag_l:
        slot = {"first": 0, "middle": bag_l // 2, "last": bag_l - 1}[dead_at]
        kind = np.arange(b) % 4
        ids[kind == 0, slot] = n
        ids[kind == 1, slot] = -3
        w[kind == 2, slot] = 0.0
        ids[rng.random((b, bag_l)) < 0.03] = n + 7
    return ids.astype(np.int32), w


def off_boundary(t: torch.Tensor, off: int = 4) -> torch.Tensor:
    """A copy of `t`, on its device, whose data starts `off` bytes past a
    16-byte boundary."""
    nbytes = t.numel() * t.element_size()
    buf = torch.zeros(nbytes + 32, dtype=torch.uint8, device=t.device)
    start = (-buf.data_ptr()) % 16 + off
    view = buf[start:start + nbytes].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == off
    return view


def within(got: torch.Tensor, want: torch.Tensor, bag_l: int) -> None:
    """One slot: the plain version's bits. More: within 1e-5 x max|plain| in
    f32 out, 2^-8 x max|plain| in bf16 (f32 summation order)."""
    if bag_l <= 1:
        assert torch.equal(got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if want.dtype == torch.bfloat16 else torch.int32))
        return
    rel = 1e-5 if got.dtype == torch.float32 else 2.0 ** -8
    tol = rel * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
