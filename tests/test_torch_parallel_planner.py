"""The port's sharding planner (`parallel/planner.py`, its own copy) gives
the reference's plan and texts: strategies, buckets, owners, offsets,
padded rows, bytes, `describe()`, `comm_volume_report` and the MemoryError
at the same budgets, over a grid of configurations x 1/2/4/8 devices x
forced strategies; and the reference's planner tests on the port's copy
(`tests/test_sharded.py:143`, `tests/test_table_wise.py:51`, `:78`, `:234`,
`:329`)."""

import dataclasses

import pytest

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.parallel import planner as jax_planner
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.parallel import planner as port_planner

REP, ROW, COL, TW = "replicated", "row_sharded", "column_sharded", "table_wise"


def _both(make):
    """The same configuration built by either package's config module."""
    return make(jax_config), make(port_config)


def _flagship(lib, dim=128, dtype=None):
    cfg = lib.two_tower_model_config(206_209, 49_688, embedding_dim=dim)
    return dataclasses.replace(cfg, table_dtype=dtype) if dtype else cfg


def _three(lib):
    return lib.ModelConfig(
        tables=(lib.TableConfig("tiny", 1_000, 128), lib.TableConfig("mid", 50_000, 128),
                lib.TableConfig("huge", 3_000_000, 128)),
        features=(lib.FeatureConfig("tiny", "tiny"), lib.FeatureConfig("mid", "mid"),
                  lib.FeatureConfig("huge", "huge")),
        query_tower=lib.TowerConfig(("tiny", "mid"), (16, 8)),
        candidate_tower=lib.TowerConfig(("huge",), (16, 8)))


def _six(lib):
    return lib.ModelConfig(
        tables=tuple(lib.TableConfig(f"t{i}", 10_000 + i * 1000, 64) for i in range(6)),
        features=tuple(lib.FeatureConfig(f"t{i}", f"t{i}") for i in range(6)),
        query_tower=lib.TowerConfig(("t0", "t1", "t2"), (8,)),
        candidate_tower=lib.TowerConfig(("t3", "t4", "t5"), (8,)))


def _comm(lib, scale=1):
    return lib.ModelConfig(
        tables=(lib.TableConfig("small", 100 * scale, 16),
                lib.TableConfig("tw_a", 5000 * scale, 16),
                lib.TableConfig("tw_b", 6000 * scale, 16),
                lib.TableConfig("big", 100_000 * scale, 16)),
        features=(lib.FeatureConfig("small", "small"), lib.FeatureConfig("tw_a", "tw_a"),
                  lib.FeatureConfig("tw_b", "tw_b"), lib.FeatureConfig("big", "big")),
        query_tower=lib.TowerConfig(("small", "tw_a"), (8,)),
        candidate_tower=lib.TowerConfig(("tw_b", "big"), (8,)))


def _mixed_dtypes(lib):
    return lib.ModelConfig(
        tables=(lib.TableConfig("t_u", 80, 16, ("u",)),
                lib.TableConfig("t_i", 50, 16, ("i",), dtype="int8"),
                lib.TableConfig("t_b", 70_000, 16, ("b",), dtype="bfloat16")),
        features=(lib.FeatureConfig("u", "t_u"), lib.FeatureConfig("i", "t_i"),
                  lib.FeatureConfig("b", "t_b", 3, "mean")),
        query_tower=lib.TowerConfig(("u", "b"), (16, 8)),
        candidate_tower=lib.TowerConfig(("i",), (16, 8)))


CONFIGS = {
    "flagship": _flagship,
    "flagship-bf16": lambda lib: _flagship(lib, dtype="bfloat16"),
    "flagship-d16": lambda lib: _flagship(lib, dim=16),
    "tiny-mid-huge": _three,
    "six-tables": _six,
    "comm": _comm,
    "mixed-dtypes": _mixed_dtypes,
}
FORCES = {
    "planned": lambda cfg: None,
    "all-row": lambda cfg: {t.name: ROW for t in cfg.tables},
    "all-table-wise": lambda cfg: {t.name: TW for t in cfg.tables},
    "alternating": lambda cfg: {t.name: (ROW, TW, REP, COL)[i % 4]
                                for i, t in enumerate(cfg.tables)},
}


def _same_plan(got, want):
    assert got.num_devices == want.num_devices
    assert list(got.specs) == list(want.specs)
    for name in want.specs:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name]), name
        assert got[name].rows_per_device == want[name].rows_per_device
    assert {k: dataclasses.asdict(v) for k, v in got.buckets.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.buckets.items()}
    assert got.total_bytes_per_device == want.total_bytes_per_device
    assert got.describe() == want.describe()


@pytest.mark.parametrize("force", list(FORCES))
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_plan_equals_the_references(config, devices, force):
    jcfg, pcfg = _both(CONFIGS[config])
    kw = {"force": FORCES[force](jcfg)}
    want = jax_planner.plan_sharding(jcfg, devices, **kw)
    got = port_planner.plan_sharding(pcfg, devices, **kw)
    _same_plan(got, want)
    for batch in (256, 262_144):
        assert port_planner.comm_volume_report(pcfg, got, batch) == \
            jax_planner.comm_volume_report(jcfg, want, batch)
    # the budget: the same plans fit, the same raise, with the same text
    need = want.total_bytes_per_device
    for budget in (need, int(need / 0.95) + 1, need // 2, 4 << 20):
        try:
            ref = jax_planner.plan_sharding(jcfg, devices, hbm_budget_bytes=budget, **kw)
        except MemoryError as e:
            with pytest.raises(MemoryError) as got_err:
                port_planner.plan_sharding(pcfg, devices, hbm_budget_bytes=budget, **kw)
            assert str(got_err.value) == str(e)
        else:
            _same_plan(port_planner.plan_sharding(pcfg, devices, hbm_budget_bytes=budget, **kw),
                       ref)


@pytest.mark.parametrize("options", [dict(replicate_threshold_bytes=1 << 20),
                                     dict(batch_hint=8192), dict(bytes_per_param=2),
                                     dict(reserve_fraction=0.2, hbm_budget_bytes=1 << 30)])
def test_plan_options_equal_the_references(options):
    jcfg, pcfg = _both(_flagship)
    for devices in (2, 4, 8):
        _same_plan(port_planner.plan_sharding(pcfg, devices, **options),
                   jax_planner.plan_sharding(jcfg, devices, **options))


def test_flagship_default_plan_needs_row_sharded_and_table_wise():
    """At 2, 4 and 8 devices the flagship's user table row-shards and its
    item table goes table-wise: the mesh path runs both."""
    cfg = _flagship(port_config)
    for devices in (2, 4, 8):
        plan = port_planner.plan_sharding(cfg, devices)
        assert plan["t_user_id"].strategy == ROW
        assert plan["t_product_id"].strategy == TW
    assert all(s.strategy == REP for s in port_planner.plan_sharding(cfg, 1).specs.values())


def test_planner_budget_and_plan_print():
    """`test_sharded.py:143`."""
    mcfg = port_config.two_tower_model_config(num_users=100_000, num_items=50_000,
                                              embedding_dim=128)
    plan = port_planner.plan_sharding(mcfg, 8, replicate_threshold_bytes=1 << 20)
    assert plan["t_user_id"].strategy == ROW
    desc = plan.describe()
    assert "t_user_id" in desc and "row_sharded" in desc
    with pytest.raises(MemoryError):
        port_planner.plan_sharding(mcfg, 8, hbm_budget_bytes=4 << 20,
                                   replicate_threshold_bytes=1 << 20)
    plan1 = port_planner.plan_sharding(mcfg, 1)
    assert all(s.strategy == REP for s in plan1.specs.values())


def test_planner_cost_model_picks_table_wise_for_midsize():
    """`test_table_wise.py:51`."""
    plan = port_planner.plan_sharding(_three(port_config), 8)
    assert plan["tiny"].strategy == REP
    assert plan["mid"].strategy == TW
    assert plan["huge"].strategy == ROW
    assert plan["mid"].owner in range(8)
    assert plan.buckets[plan["mid"].bucket].embedding_dim == 128
    assert "table_wise" in plan.describe() and "bucket" in plan.describe()


def test_bucket_bin_packing_balances_devices():
    """`test_table_wise.py:78`."""
    plan = port_planner.plan_sharding(_six(port_config), 4,
                                      force={f"t{i}": TW for i in range(6)})
    (bucket,) = plan.buckets.values()
    assert set(bucket.tables) == {f"t{i}" for i in range(6)}
    loads = {}
    for i in range(6):
        s = plan[f"t{i}"]
        loads[s.owner] = loads.get(s.owner, 0) + s.num_embeddings
    assert max(loads.values()) <= bucket.rows_per_device
    for dev in loads:
        spans = sorted((plan[f"t{i}"].bucket_offset, plan[f"t{i}"].num_embeddings)
                       for i in range(6) if plan[f"t{i}"].owner == dev)
        end = 0
        for off, n in spans:
            assert off >= end
            end = off + n


def test_comm_volume_report_groups_and_totals():
    """`test_table_wise.py:234`."""
    force = {"small": REP, "tw_a": TW, "tw_b": TW, "big": ROW}
    mcfg = _comm(port_config)
    rep = port_planner.comm_volume_report(mcfg, port_planner.plan_sharding(mcfg, 4, force=force),
                                          batch_size=256)
    assert rep.count("__tw_bucket_d16__") == 3
    assert "tw_a" not in rep.replace("__tw_bucket_d16__", "")
    assert rep.count("small") == 1
    assert f"{256*16*4:,}" in rep
    mcfg2 = _comm(port_config, scale=2)
    rep2 = port_planner.comm_volume_report(
        mcfg2, port_planner.plan_sharding(mcfg2, 4, force=force), batch_size=256)
    assert rep.splitlines()[-1] == rep2.splitlines()[-1]


def test_mixed_dtype_table_wise_buckets_are_separate():
    """`test_table_wise.py:329` (the plan; int8 sharded training is ROADMAP
    M12(b))."""
    mcfg = _mixed_dtypes(port_config)
    plan = port_planner.plan_sharding(mcfg, 8, force={"t_u": TW, "t_i": TW, "t_b": TW})
    assert set(plan.buckets) == {"__tw_bucket_d16__", "__tw_bucket_d16_int8__",
                                 "__tw_bucket_d16_bfloat16__"}
    assert plan.buckets["__tw_bucket_d16_int8__"].dtype == "int8"
