"""Gather speed against its consumer: the gather probe.

Port of the reference's `tools/probe_consumer.py`: its five cases at its
shapes (`M` = 262,144 gathered rows, `N` = 49,688 table rows, widths 128 and
64), and two more that time the port's own pooled-gather kernel on ids as
drawn and on sorted ids:

  same_ids       h0[ids].sum() + h1[ids].sum(): two [N, 64] takes, same ids
  same_ids_bar   the reference sends the second take's ids through an
                 optimization barrier so that its compiler cannot merge the
                 two takes; eager PyTorch fuses nothing, so this case equals
                 `same_ids` by construction and is kept for the name
  h128_pallas    [N, 128] take -> `probe_sum` (the block-sums kernel)
  h128_perm_mat  [M, 128] permute-take -> @ [128, 8] -> sum
  h64x2_pallas   two [M, 64] permute-takes -> `probe_sum2`
  k1_unsorted    `pooled_gather` (M bags x 1 slot over the [N, 128] table)
                 -> `probe_sum`, the ids as drawn
  k1_sorted      the same with the ids sorted

Run: python -m two_tower_recommender_model_tpu_torch.tools.probe_consumer
     [--m M] [--k K] [--device cuda|cpu]

It runs on the card unless `--device cpu` is given, and raises without a
card. On the card each case's time is the median over `--k` launches of the
device time between two CUDA events, each launch after a 64 MB read that
flushes the L2 cache; on the CPU (where the kernels' plain versions run) it
is the median host time. Inputs come from a seeded `torch.Generator`. Output:
one JSON line per case, `{"case", "ms"}`, then `{"all": [...]}`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable

import torch

from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.probe_sum import probe_sum, probe_sum2

M = 262_144
K = 64
N = 49_688
CASES = ("same_ids", "same_ids_bar", "h128_pallas", "h128_perm_mat", "h64x2_pallas",
         "k1_unsorted", "k1_sorted")


def timed(fn: Callable[[], torch.Tensor], device: torch.device, k: int) -> float:
    """Median ms of `k` calls of `fn` after one warm-up call."""
    float(fn())
    times = []
    if device.type != "cuda":
        for _ in range(k):
            t0 = time.perf_counter()
            float(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=device)  # 64 MB > the 50 MB L2
    for _ in range(k):
        flush.sum()  # a read: no dirty lines are written back during the timed call
        torch.cuda.synchronize(device)
        # a device-side spin (~1 ms) queued first: the host enqueues the events and the
        # case behind it, so the events bracket device work, not the host's launches
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_cases(m: int, device: torch.device, seed: int) -> dict[str, Callable[[], torch.Tensor]]:
    """The seven cases as functions that return a 0-dim tensor on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x128 = torch.randn((N, 128), generator=gen, device=device)
    h0, h1 = x128[:, :64].contiguous(), x128[:, 64:].contiguous()
    w128 = torch.randn((128, 8), generator=gen, device=device)
    ids = torch.randint(0, N, (m,), generator=gen, device=device)
    gm = torch.randn((m, 128), generator=gen, device=device)
    g0, g1 = gm[:, :64].contiguous(), gm[:, 64:].contiguous()
    perm = torch.randperm(m, generator=gen, device=device)
    bag_ids = ids.to(torch.int32).reshape(m, 1)
    sorted_bag_ids = torch.sort(bag_ids, dim=0).values.contiguous()
    ones = torch.ones((m, 1), dtype=torch.float32, device=device)

    def same_ids():
        return h0[ids].sum() + h1[ids].sum()

    return {
        "same_ids": same_ids,
        "same_ids_bar": same_ids,
        "h128_pallas": lambda: probe_sum(x128[ids]),
        "h128_perm_mat": lambda: (gm[perm] @ w128).sum(),
        "h64x2_pallas": lambda: probe_sum2(g0[perm], g1[perm]),
        "k1_unsorted": lambda: probe_sum(pooled_gather(x128, bag_ids, ones)),
        "k1_sorted": lambda: probe_sum(pooled_gather(x128, sorted_bag_ids, ones)),
    }


def run(m: int = M, k: int = K, seed: int = 0, device: torch.device | str | None = None,
        emit: Callable[[str], None] = print) -> list[dict]:
    """Time every case; `emit` gets one JSON line per case as it finishes."""
    device = resolve_device(device)
    out = []
    with torch.no_grad():
        for name, fn in build_cases(m, device, seed).items():
            rec = {"case": name, "ms": round(timed(fn, device, k), 4)}
            out.append(rec)
            emit(json.dumps(rec))
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--m", type=int, default=M, help="gathered rows (at least 512)")
    parser.add_argument("--k", type=int, default=K, help="timed launches per case")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({kind})", file=sys.stderr, flush=True)
    out = run(args.m, args.k, device=device, emit=lambda line: print(line, flush=True))
    print(json.dumps({"all": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
