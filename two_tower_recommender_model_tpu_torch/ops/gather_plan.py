"""The launch plan of the two pooled gathers (`csrc/pooled_gather.cu`,
`csrc/quantized_gather.cu`), computed here and passed to their entry points,
which check that it fits the shape and launch the walk it names.

Both kernels cut a table row into 16-byte chunks. The walks of their wide
path (`csrc/gather_rows.cuh`) give a warp a run of bags, whose lanes take the
run's (bag, chunk) items. The narrow path, one warp a bag, takes what the
wide path cannot: a row that is not a whole number of 16-byte chunks, or a
table or output pointer that is not 16-byte aligned.

The plan sizes the work to the batch:
- one slot a bag, while the card holds all the warps of one item a lane:
  `Walk.ONE`, a run of as many bags as give each lane one 16-byte load (one
  bag when a row is 32 chunks), so the chain id load -> row load -> store is
  paid once by warps that do nothing else;
- one slot a bag, past that: `Walk.RUNS`, runs that grow until the warps fit
  the card, up to as many bags as one id load covers (32), a lane with
  several row loads out at once; larger batches take more warps;
- L slots a bag: `Walk.ITEMS`, runs sized the same way, up to 32 slots.
"Fit the card" counts the blocks an SM the walk's kernel reaches, which the
kernel library reports (`GatherKernel.blocks_per_sm`): its `__launch_bounds__`
and its registers decide it, nothing here. A warp takes one run (a grid of
a few blocks an SM striding over the runs was slower at 262,144 and
1,048,576 bags); blocks hold up to 8 warps, so only the last block has
warps without a run.

`gather_plan` touches no device: the wrappers pass the card's SM count and
the blocks an SM, and the CPU tests pass their own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
from collections.abc import Mapping

import torch

from two_tower_recommender_model_tpu_torch.ops import _build


class Walk(enum.IntEnum):
    """The kernels' walks; the codes of `csrc/gather_rows.cuh`'s `Walk`."""
    NARROW = 0  # one warp a bag: any D, any alignment
    ONE = 1  # one slot a bag, one 16-byte load a lane
    RUNS = 2  # one slot a bag, runs of up to 32 bags, several loads a lane
    ITEMS = 3  # L slots a bag


WIDE_WALKS = (Walk.ONE, Walk.RUNS, Walk.ITEMS)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the entry points' table and output codes
WINDOW = 32  # slots of one coalesced id load: one a lane
WARPS_PER_BLOCK = 8  # the most; the kernels are compiled for 256 threads
CHUNK = 16  # bytes of one row load
MAX_PLANS = 4096  # plans a wrapper keeps


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    walk: Walk
    bags_per_warp: int  # bags of a run; 1 on the narrow path
    warps_per_block: int
    blocks: int


def _grid(walk: Walk, bags: int, batch: int) -> GatherPlan:
    warps = -(-batch // bags)
    warps_per_block = min(WARPS_PER_BLOCK, warps)
    return GatherPlan(walk, bags, warps_per_block, -(-warps // warps_per_block))


def gather_plan(batch: int, bag_l: int, d: int, elem_bytes: int, aligned: bool, sms: int,
                blocks_per_sm: Mapping[Walk, int]) -> GatherPlan:
    """The plan for `batch` bags of `bag_l` slots over rows of `d` elements
    of `elem_bytes` bytes. `aligned`: the table and the output both start on
    a 16-byte boundary. `sms`: the card's SM count; `blocks_per_sm`: the
    256-thread blocks an SM each wide walk's kernel reaches."""
    if batch < 1 or d < 1 or bag_l < 0 or sms < 1:
        raise ValueError(f"no plan for batch={batch}, bag_l={bag_l}, d={d}, sms={sms}")
    row_bytes = d * elem_bytes
    if not aligned or row_bytes % CHUNK:
        return _grid(Walk.NARROW, 1, batch)
    chunks = row_bytes // CHUNK
    one_load = max(1, WINDOW // chunks)  # bags of one 16-byte load a lane

    def capacity(walk: Walk) -> int:  # warps the card holds at once
        return sms * blocks_per_sm[walk] * WARPS_PER_BLOCK

    if bag_l == 1:
        if chunks <= WINDOW and -(-batch // one_load) <= capacity(Walk.ONE):
            return _grid(Walk.ONE, min(one_load, batch), batch)
        walk, longest = Walk.RUNS, WINDOW
    else:
        walk, longest = Walk.ITEMS, max(1, WINDOW // bag_l) if bag_l else WINDOW
    bags = min(longest, max(one_load, -(-batch // capacity(walk))), batch)
    return _grid(walk, bags, batch)


class GatherKernel(_build.KernelLibrary):
    """A pooled gather's kernel library and its launch plan. The card's SM
    count and the blocks an SM each wide walk reaches (the library's
    `<entry>_blocks_per_sm`, from the CUDA occupancy calculator) are read
    once a card and dtype pair and kept."""

    def __init__(self, name: str, entry: str, argtypes: list, source: str | None = None):
        super().__init__(name, entry, argtypes, source)
        self._cards: dict[tuple, tuple[int, dict[Walk, int]]] = {}
        self._plans: dict[tuple, GatherPlan] = {}  # a call's host time is part of serving's

    def _card(self, device: torch.device,
              dtypes: tuple[torch.dtype, ...]) -> tuple[int, dict[Walk, int]]:
        key = (device.index, *dtypes)
        card = self._cards.get(key)
        if card is None:
            lib = self.load().lib
            fn = getattr(lib, f"{self._entry}_blocks_per_sm")
            fn.argtypes = [ctypes.c_int] * (len(dtypes) + 1)
            fn.restype = ctypes.c_int
            # a dtype by its code; a flag of the entry point (#1's round_rows) as it is
            codes = [DTYPE_CODES[t] if isinstance(t, torch.dtype) else int(t) for t in dtypes]
            with torch.cuda.device(device):
                blocks = {walk: fn(*codes, walk) for walk in WIDE_WALKS}
            bad = {walk.name: n for walk, n in blocks.items() if n < 1}
            if bad:
                raise RuntimeError(f"{self.name}: no block of {WARPS_PER_BLOCK} warps fits an SM "
                                   f"for {bad} (a negative value is a CUDA error code)")
            card = (torch.cuda.get_device_properties(device).multi_processor_count, blocks)
            self._cards[key] = card
        return card

    def blocks_per_sm(self, device: torch.device, *dtypes: torch.dtype) -> dict[Walk, int]:
        """The blocks of 256 threads an SM each wide walk reaches on this card
        for these dtypes (the entry point's: table, output and round_rows for
        #1, output for #5)."""
        return dict(self._card(device, dtypes)[1])

    def plan_for(self, device: torch.device, dtypes: tuple[torch.dtype, ...], batch: int,
                 bag_l: int, d: int, elem_bytes: int, aligned: bool) -> GatherPlan:
        """`gather_plan` on this card, kept for the shapes met (up to
        `MAX_PLANS`, then forgotten all at once)."""
        key = (device.index, dtypes, batch, bag_l, d, elem_bytes, aligned)
        plan = self._plans.get(key)
        if plan is None:
            sms, blocks = self._card(device, dtypes)
            plan = gather_plan(batch, bag_l, d, elem_bytes, aligned, sms, blocks)
            if len(self._plans) >= MAX_PLANS:
                self._plans.clear()
            self._plans[key] = plan
        return plan
