"""Sorted ids with runs of chosen lengths, and the sums of kernels #3, #4 and
#6 in their span walk's order (`csrc/sorted_runs.cuh`), for the port's CPU
and card tests. Imports torch, numpy and the port, no JAX: the card tests
use it too."""

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import SPAN

# name -> (the run's length, its first position, sentinels at the end). The
# lengths sit at the walk's edges: a warp sums a run that starts in its span
# when it ends within the 64 positions it reads (so 64 is complete and 65
# long); a long run goes to 32-position pieces, more than 64 pieces to a
# whole block.
RUN_CASES = {
    "run-1": (1, 40, 100),
    "run-32": (32, 64, 100),  # exactly one span
    "run-33": (33, 31, 100),  # from a span's last position to the next span's end
    "run-63": (63, 1, 100),
    "run-64": (64, 32, 100),  # two whole spans: the longest complete run
    "run-65": (65, 32, 100),  # one position past the window: a long run of two pieces
    "run-3000": (3000, 96, 100),  # 94 pieces: the block-wide finish
    "long-mid-span": (700, 45, 100),
    "long-ends-at-M": (1096, 3000, 0),
    "long-then-sentinels": (500, 3496, 100),
}


def run_case_ids(name: str, m: int = 4096) -> tuple[int, np.ndarray]:
    """(N, [M] sorted int64 ids): runs of 3 before the case's run, its run,
    runs of 3 after it, then its sentinels (the id N)."""
    length, start, tail = RUN_CASES[name]
    base = np.arange(m) // 3
    ids = np.concatenate([base[:start], np.full(length, m),
                          base[start + length:] + m + 1]).astype(np.int64)
    n = 3 * m
    if tail:
        ids[m - tail:] = n
    return n, ids


def in_order(rows: torch.Tensor) -> torch.Tensor:
    """Rows added one after another in f32, from zero: a sequential sum."""
    total = torch.zeros(rows.shape[1:])
    for row in rows:
        total = total + row
    return total


def span_order_sums(sids: np.ndarray, g: torch.Tensor, n: int):
    """(rows, [R, D] sums) of each live run of sorted ids `sids` over the
    sorted gradient rows `g`, added in the order of the span walk. Spans are
    the aligned 32 positions of one warp. A run that ends within the span
    after its first is summed in position order. A longer run is summed in
    pieces: its first piece reaches to the end of that next span, then one
    piece per later span; each piece is its first half (rounded up) and its
    second half added in order, then added to the first. The T pieces are
    added in order when T <= 64; else in 8 contiguous shares of ceil(T / 8)
    pieces, each in order, and the shares in order."""
    m = len(sids)
    rows, sums = [], []
    a = 0
    while a < m:
        b = a
        while b < m and sids[b] == sids[a]:
            b += 1
        if 0 <= sids[a] < n:
            reach = (a // SPAN + 2) * SPAN
            if b <= reach:
                total = in_order(g[a:b])
            else:
                bounds = [a] + list(range(reach, b, SPAN)) + [b]
                pieces = []
                for lo, hi in zip(bounds[:-1], bounds[1:]):
                    mid = lo + (hi - lo + 1) // 2
                    pieces.append(in_order(g[lo:mid]) + in_order(g[mid:hi]))
                pieces = torch.stack(pieces)
                if len(pieces) <= 64:
                    total = in_order(pieces)
                else:
                    share = -(-len(pieces) // 8)
                    total = in_order(torch.stack([in_order(pieces[k:k + share])
                                                  for k in range(0, len(pieces), share)]))
            rows.append(int(sids[a]))
            sums.append(total)
        a = b
    return torch.tensor(rows, dtype=torch.long), torch.stack(sums)
