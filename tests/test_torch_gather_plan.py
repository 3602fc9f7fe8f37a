"""The launch plan of the two pooled gathers (`ops/gather_plan.py`): which
walk a shape takes, how many bags a warp takes, and the grid, for the widths,
dtypes, alignments and batch sizes the port meets. Pure Python: no kernel
runs, so it runs here; the card tests hold the kernels to what it picks."""

import pytest

from two_tower_recommender_model_tpu_torch.ops.gather_plan import (
    WARPS_PER_BLOCK,
    WINDOW,
    GatherPlan,
    Walk,
    gather_plan,
)

SMS = 132  # an H100 SXM
BLOCKS = {Walk.ONE: 8, Walk.RUNS: 4, Walk.ITEMS: 3}  # blocks an SM each walk reaches
DIMS = [8, 32, 36, 128, 130, 512]
ELEM_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
BATCHES = [1, 16, 8192, 262_144]


def plan(batch, bag_l, d, elem, aligned=True, blocks=None):
    return gather_plan(batch, bag_l, d, elem, aligned, SMS, blocks or BLOCKS)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", sorted(ELEM_BYTES))
def test_plan_covers_the_batch(d, dtype):
    """For both alignments and every batch size: the wide path exactly when
    the row is whole 16-byte chunks and both pointers are aligned; the walk
    fits the slots (one slot: ONE or RUNS; more: ITEMS); a run's slots fit
    one id load; one run a warp, the runs cover the batch, and only the
    last block has warps without a run."""
    elem = ELEM_BYTES[dtype]
    for aligned in (True, False):
        for b in BATCHES:
            for bag_l in (1, 3):
                p = plan(b, bag_l, d, elem, aligned)
                warps = p.warps_per_block * p.blocks
                wide = aligned and d * elem % 16 == 0
                assert (p.walk != Walk.NARROW) == wide
                assert 1 <= p.warps_per_block <= WARPS_PER_BLOCK and p.blocks >= 1
                runs = -(-b // p.bags_per_warp)
                assert p.bags_per_warp <= b
                # the last block has work
                assert (p.blocks - 1) * p.warps_per_block * p.bags_per_warp < b
                if not wide:
                    assert p.bags_per_warp == 1 and warps >= b
                    continue
                assert p.walk in ((Walk.ONE, Walk.RUNS) if bag_l == 1 else (Walk.ITEMS,))
                assert p.bags_per_warp * bag_l <= WINDOW
                assert runs <= warps < runs + p.warps_per_block
                if p.walk == Walk.ONE:  # one 16-byte load a lane, and the card holds every warp
                    assert p.bags_per_warp * d * elem // 16 <= WINDOW
                    assert runs <= SMS * BLOCKS[Walk.ONE] * WARPS_PER_BLOCK
                elif runs > SMS * BLOCKS[p.walk] * WARPS_PER_BLOCK:  # past the card: longest runs
                    assert p.bags_per_warp == WINDOW // bag_l


@pytest.mark.parametrize("dtype", sorted(ELEM_BYTES))
def test_small_batches_give_one_load_a_lane(dtype):
    """While the card holds every warp, one slot a bag takes the one-item
    walk: a run is as many bags as give each lane one 16-byte load (one bag
    when a row is 32 chunks), and a batch of 1 launches one warp. A row of
    more than 32 chunks (f32 or bf16 at D = 512) takes the runs walk, one bag
    a run."""
    elem = ELEM_BYTES[dtype]
    for d in (32, 128, 512):
        chunks = d * elem // 16
        for b in (1, 16, 100, 1000):
            p = plan(b, 1, d, elem)
            assert p.bags_per_warp == min(max(1, WINDOW // chunks), b)
            assert p.walk == (Walk.ONE if chunks <= WINDOW else Walk.RUNS)
        one = plan(1, 1, d, elem)
        assert (one.warps_per_block, one.blocks) == (1, 1)


def test_the_main_paths_plans():
    """The shapes of the flagship: /invocations of 8,192 rows from the f32,
    bf16 and int8 user table (one bag a warp in f32, as many as give a lane
    one load otherwise), the BCE train step's 262,144 bags (runs of 32), and
    three mean-weighted slots."""
    assert plan(8192, 1, 128, 4) == GatherPlan(Walk.ONE, 1, 8, 1024)
    assert plan(8192, 1, 128, 2) == GatherPlan(Walk.ONE, 2, 8, 512)
    assert plan(8192, 1, 128, 1) == GatherPlan(Walk.ONE, 4, 8, 256)
    assert plan(262_144, 1, 128, 4) == GatherPlan(Walk.RUNS, 32, 8, 1024)
    assert plan(262_144, 1, 128, 2) == GatherPlan(Walk.RUNS, 32, 8, 1024)
    assert plan(262_144, 1, 128, 1) == GatherPlan(Walk.RUNS, 32, 8, 1024)
    assert plan(8192, 3, 128, 4) == GatherPlan(Walk.ITEMS, 3, 8, 342)
    # past the card's capacity at 32 bags a run, more warps (one run each)
    big = plan(4 << 20, 1, 128, 4)
    assert big.walk == Walk.RUNS and big.bags_per_warp == WINDOW
    assert big.warps_per_block * big.blocks == (4 << 20) // WINDOW


def test_capacity_comes_from_the_walks_blocks():
    """Where the one-item walk stops and how long runs grow follow the blocks
    an SM each walk reaches, as the kernel library reports them."""
    one_cap = SMS * BLOCKS[Walk.ONE] * WARPS_PER_BLOCK
    assert plan(one_cap, 1, 128, 4).walk == Walk.ONE
    assert plan(one_cap + 1, 1, 128, 4).walk == Walk.RUNS
    fewer = {**BLOCKS, Walk.ONE: 2}
    assert plan(one_cap, 1, 128, 4, blocks=fewer).walk == Walk.RUNS
    runs_cap = SMS * BLOCKS[Walk.RUNS] * WARPS_PER_BLOCK
    assert plan(runs_cap * 5, 1, 128, 4).bags_per_warp == 5
    assert plan(runs_cap * 5, 1, 128, 4, blocks={**BLOCKS, Walk.RUNS: 1}).bags_per_warp == 20


def test_narrow_path_shapes():
    """D = 8 in int8, D = 36 in bf16 and D = 130 in any dtype are not whole
    16-byte chunks; an aligned f32 D = 36 is."""
    assert plan(100, 1, 8, 1).walk == Walk.NARROW
    assert plan(100, 1, 36, 2).walk == Walk.NARROW
    assert plan(100, 1, 36, 4).walk == Walk.ONE
    for elem in (1, 2, 4):
        assert plan(100, 1, 130, elem).walk == Walk.NARROW
    assert plan(100, 1, 130, 4, aligned=False) == GatherPlan(Walk.NARROW, 1, 8, 13)


def test_bags_of_many_slots_take_one_bag_a_run():
    """L = 40 passes one id load: one bag a run, its slots in windows."""
    p = plan(1000, 40, 128, 4)
    assert p.walk == Walk.ITEMS and p.bags_per_warp == 1
    assert p.warps_per_block * p.blocks == 1000


def test_no_plan_for_an_empty_batch():
    with pytest.raises(ValueError, match="no plan"):
        plan(0, 1, 128, 4)
