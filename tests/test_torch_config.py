"""The port's config module against the JAX package's: the same builders give
the same fields, each package reads the other's JSON, and both refuse the
same invalid configurations."""

import dataclasses
import json

import pytest

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu_torch import config as port_config

BUILDS = [
    dict(num_users=206_209, num_items=49_688),
    dict(num_users=1000, num_items=300, embedding_dim=32, layer_sizes=(64, 32),
         compute_dtype="bfloat16"),
    dict(num_users=10, num_items=7, embedding_dim=8, layer_sizes=(16, 8, 4),
         user_feature="u", item_feature="i"),
]


def _rich(lib):
    """A config using every field: a shared table, a mean bag, dense inputs,
    per-table dtypes."""
    base = lib.two_tower_model_config(1000, 300, embedding_dim=32, layer_sizes=(64, 32))
    items = dataclasses.replace(base.tables[1], feature_names=("product_id", "history"),
                                dtype="bfloat16")
    return dataclasses.replace(
        base,
        tables=(base.tables[0], items),
        features=base.features + (lib.FeatureConfig("history", items.name, 3, "mean"),),
        query_tower=dataclasses.replace(base.query_tower, features=("user_id", "history"),
                                        dense_dim=4, final_activation=False),
        candidate_tower=dataclasses.replace(base.candidate_tower, activation="tanh"),
        table_dtype="float32", fused_tower_backward="off",
    )


@pytest.mark.parametrize("kwargs", BUILDS)
def test_two_tower_model_config_matches_jax(kwargs):
    got = port_config.two_tower_model_config(**kwargs)
    want = jax_config.two_tower_model_config(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_config.to_json(got) == jax_config.to_json(want)
    assert got.tower_out_dim == want.tower_out_dim


@pytest.mark.parametrize("make", [lambda lib: lib.two_tower_model_config(50, 40), _rich])
def test_json_round_trips_between_packages(make):
    jax_cfg, port_cfg = make(jax_config), make(port_config)
    assert port_config.model_config_from_dict(json.loads(jax_config.to_json(jax_cfg))) == port_cfg
    assert jax_config.model_config_from_dict(json.loads(port_config.to_json(port_cfg))) == jax_cfg
    for t in jax_cfg.tables:
        assert port_cfg.table_dtype_of(t.name) == jax_cfg.table_dtype_of(t.name)
    for f in jax_cfg.features:
        assert port_cfg.feature_table(f.name).name == jax_cfg.feature_table(f.name).name


@pytest.mark.parametrize("broken", [
    lambda lib, c: dataclasses.replace(c, features=(lib.FeatureConfig("user_id", "nope"),)),
    lambda lib, c: dataclasses.replace(
        c, query_tower=dataclasses.replace(c.query_tower, features=("nope",))),
    lambda lib, c: dataclasses.replace(
        c, candidate_tower=dataclasses.replace(c.candidate_tower, layer_sizes=(64, 16))),
    lambda lib, c: dataclasses.replace(c, fused_tower_backward="maybe"),
])
def test_validate_refuses_what_jax_refuses(broken):
    for lib in (jax_config, port_config):
        cfg = broken(lib, lib.two_tower_model_config(50, 40))
        with pytest.raises(ValueError):
            cfg.validate()
    with pytest.raises(KeyError):
        port_config.two_tower_model_config(50, 40).table("nope")


@pytest.mark.parametrize("kwargs", [
    {},
    dict(batch_size=262_144, sorted_feature="user_id", block_sorted_kernel="bfloat16"),
    dict(loss="weighted_bce", loss_type_weights=(1.0, 0.5), limit_val_batches=4),
])
def test_train_config_matches_jax_field_for_field(kwargs):
    got, want = port_config.TrainConfig(**kwargs), jax_config.TrainConfig(**kwargs)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_config.to_json(got) == jax_config.to_json(want)


@pytest.mark.parametrize("kwargs", [{}, dict(data=4), dict(data=2, model=2)])
def test_mesh_config_matches_jax_field_for_field(kwargs):
    got, want = port_config.MeshConfig(**kwargs), jax_config.MeshConfig(**kwargs)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_devices == want.num_devices
    assert port_config.to_json(got) == jax_config.to_json(want)
