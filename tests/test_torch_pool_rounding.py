"""A multi-slot bag's rounding under bf16 compute, against the JAX package.

The reference pools a bag of an f32 table under a narrower compute dtype
(`ops/embedding_ops.py:67-75`) by casting each row to bf16, masking, summing
the bag (XLA sums the bf16 rows in f32 in slot order and rounds once) and, for
a mean, dividing that bf16 sum by the bf16 count. The port's `pooled_lookup`
takes kernel #1 with `round_rows` (the mask as the weights) and divides in
bf16 after: on the CPU the kernel's plain version, which these tests hold to
the reference bit for bit. A bag of one live slot gives the same bits with
and without the mode, so the flagship's single-slot steps do not move."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.models import two_tower as jax_two_tower
from two_tower_recommender_model_tpu.ops import embedding_ops as jax_embedding_ops
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.models import two_tower
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather_reference
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup

DRAWS = 6  # seeded draws a bag length


def _bits(a) -> np.ndarray:
    """bf16 values as their 16 bits (a -0 and a +0 differ here)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.uint16).astype(np.int16)


def _bags(rng, n, b, bag_l):
    """ids [B, L] and a 0/1 mask whose live counts run over 0..L, the live
    slots anywhere in the bag (dead slots keep an id, as the reference's
    featurizer leaves 0 there)."""
    count = np.arange(b) % (bag_l + 1)
    order = rng.random((b, bag_l)).argsort(axis=1)
    mask = (order < count[:, None]).astype(np.float32)
    ids = np.where(mask > 0, rng.integers(0, n, (b, bag_l)), 0).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("bag_l", list(range(2, 17)))
def test_reference_rounding_order(pooling, bag_l):
    """Rows rounded to bf16, summed in f32 in slot order, rounded once (and a
    mean's bf16 division after it): the port's pool bit for bit the
    reference's over seeded draws, with live counts from 0 to L."""
    for draw in range(DRAWS):
        rng = np.random.default_rng(1000 * bag_l + draw)
        n, d, b = 200, 24, 68
        table = (rng.normal(size=(n, d)) * rng.choice([1e-3, 1.0, 30.0], (n, 1))).astype(
            np.float32)
        ids, mask = _bags(rng, n, b, bag_l)
        want = jax_embedding_ops.pooled_lookup(jnp.asarray(table), jnp.asarray(ids),
                                               jnp.asarray(mask), pooling, jnp.bfloat16)
        got = pooled_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(mask), pooling, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"draw {draw}")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_one_live_slot_gives_the_same_bits_in_either_mode(out_dtype):
    """`round(1 x round(row)) = round(row)`: at one slot the mode changes no
    bit, dead slots included."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(300, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-5, 310, (500, 1)).astype(np.int32))
    w = torch.from_numpy((rng.random((500, 1)) > 0.2).astype(np.float32))
    plain = pooled_gather_reference(table, ids, w, out_dtype)
    rounded = pooled_gather_reference(table, ids, w, out_dtype, round_rows=True)
    assert torch.equal(plain.view(torch.int16) if out_dtype == torch.bfloat16 else plain,
                       rounded.view(torch.int16) if out_dtype == torch.bfloat16 else rounded)


def _multislot_config():
    """The flagship pair at 1,000 users x 300 items under bf16 compute, the
    query tower also reading a 6-slot summed and a 9-slot mean-pooled bag of
    the items table."""
    cfg = cfg_lib.two_tower_model_config(1000, 300, embedding_dim=32, layer_sizes=(64, 32),
                                         compute_dtype="bfloat16")
    items = dataclasses.replace(cfg.tables[1],
                                feature_names=("product_id", "basket", "history"))
    cfg = dataclasses.replace(
        cfg, tables=(cfg.tables[0], items),
        features=cfg.features + (cfg_lib.FeatureConfig("basket", items.name, 6, "sum"),
                                 cfg_lib.FeatureConfig("history", items.name, 9, "mean")),
        query_tower=dataclasses.replace(cfg.query_tower,
                                        features=("user_id", "basket", "history")))
    cfg.validate()
    return cfg


def test_two_tower_multislot_pooled_embeddings_match_jax_bit_for_bit():
    """The two-tower model's `pooled_embeddings` under bf16 compute on f32
    tables, the single-slot features and the summed and mean bags: every
    pooled value the JAX package's, bit for bit."""
    cfg = _multislot_config()
    rng = np.random.default_rng(7)
    tables = {t.name: rng.uniform(-1, 1, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
              for t in cfg.tables}
    n = 256
    cols = {"user_id": rng.integers(0, 3000, n), "product_id": rng.integers(0, 900, n),
            "basket": rng.integers(0, 900, (n, 6)), "history": rng.integers(0, 900, (n, 9)),
            "label": rng.integers(0, 2, n)}
    for name, width in (("basket", 6), ("history", 9)):
        cut = rng.integers(0, width + 1, n)
        cols[name] = np.where(np.arange(width)[None, :] < cut[:, None], cols[name], 0)
    want = jax_two_tower.pooled_embeddings({k: jnp.asarray(v) for k, v in tables.items()},
                                           JaxFeaturizer(cfg)(cols), cfg)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(cfg))
    got = two_tower.pooled_embeddings({k: torch.from_numpy(v) for k, v in tables.items()},
                                      Featurizer(pcfg, device="cpu")(cols), pcfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(w), err_msg=name)
