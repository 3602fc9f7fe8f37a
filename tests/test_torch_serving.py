"""The port's retrieval and serving stack against the JAX package's: exact
top-k with ties, corpus export, Scorer, RetrievalService, loading a JAX
export, and both HTTP servers answering the same requests."""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.evaluation.retrieval import (
    export_feature_embeddings as jax_export,
)
from two_tower_recommender_model_tpu.models.two_tower import tower_in_dim
from two_tower_recommender_model_tpu.ops.topk import chunked_topk as jax_chunked_topk
from two_tower_recommender_model_tpu.serving import RetrievalService as JaxRetrievalService
from two_tower_recommender_model_tpu.serving import Scorer as JaxScorer
from two_tower_recommender_model_tpu.serving import load_scorer as jax_load_scorer
from two_tower_recommender_model_tpu.serving.server import ModelServer as JaxModelServer
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import export_feature_embeddings
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk
from two_tower_recommender_model_tpu_torch.serving import RetrievalService, Scorer, load_scorer
from two_tower_recommender_model_tpu_torch.serving.server import (
    ModelServer,
    validate_serving_input,
)
from two_tower_recommender_model_tpu_torch.utils.checkpoint import load_model

# f32 products summed in another order (XLA vs torch CPU matmuls)
F32 = dict(rtol=1e-5, atol=1e-6)


def _config(compute_dtype="float32", dense_dim=0):
    cfg = cfg_lib.two_tower_model_config(1000, 300, embedding_dim=32, layer_sizes=(64, 32),
                                         compute_dtype=compute_dtype)
    if dense_dim:
        cfg = dataclasses.replace(
            cfg, candidate_tower=dataclasses.replace(cfg.candidate_tower, dense_dim=dense_dim))
    return cfg


def _port(cfg):
    """The same configuration in the port's own dataclasses."""
    return port_config.model_config_from_dict(dataclasses.asdict(cfg))


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {t.name: rng.uniform(-1, 1, (t.num_embeddings, t.embedding_dim))
                         .astype(np.float32) for t in cfg.tables}}
    for key in ("query_tower", "candidate_tower"):
        tower = getattr(cfg, key)
        sizes = [tower_in_dim(cfg, tower), *tower.layer_sizes]
        params[key] = {
            f"layer_{i}": {
                "kernel": rng.uniform(-a ** -0.5, a ** -0.5, (a, b)).astype(np.float32),
                "bias": rng.uniform(-a ** -0.5, a ** -0.5, b).astype(np.float32)}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    return params


def _requests(n=40, seed=3):
    rng = np.random.default_rng(seed)
    users = rng.integers(-50, 2500, n)
    users[::6] = 0
    return {"user_id": users, "product_id": rng.integers(0, 700, n)}


# --- top-k ---------------------------------------------------------------


@pytest.mark.parametrize("corpus_chunk,query_chunk", [(128, 7), (256, 1024), (4096, 16)])
def test_chunked_topk_matches_jax_with_ties(corpus_chunk, query_chunk):
    """Small integer vectors make the scores exact in both packages, with
    many exact ties (zero rows, duplicate rows, an all-zero query): indices
    must agree, ties going to the lower index."""
    rng = np.random.default_rng(2)
    corpus = rng.integers(0, 3, (1000, 16)).astype(np.float32)
    corpus[::5] = 0
    corpus[100:200] = corpus[1]
    queries = rng.integers(0, 2, (21, 16)).astype(np.float32)
    queries[3] = 0
    want_v, want_i = jax_chunked_topk(jnp.asarray(queries), jnp.asarray(corpus), k=50,
                                      corpus_chunk=corpus_chunk, query_chunk=query_chunk)
    got_v, got_i = chunked_topk(torch.from_numpy(queries), torch.from_numpy(corpus), k=50,
                                corpus_chunk=corpus_chunk, query_chunk=query_chunk)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i[3].numpy(), np.arange(50))  # all tied at 0


def test_chunked_topk_random_matches_numpy():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(9, 24)).astype(np.float32)
    c = rng.normal(size=(777, 24)).astype(np.float32)
    v, i = chunked_topk(torch.from_numpy(q), torch.from_numpy(c), k=10, corpus_chunk=128)
    full = q.astype(np.float64) @ c.T.astype(np.float64)
    np.testing.assert_array_equal(i.numpy(), np.argsort(-full, axis=1, kind="stable")[:, :10])
    np.testing.assert_allclose(v.numpy(), np.take_along_axis(full, i.numpy(), 1), rtol=1e-5)


# --- corpus export ---------------------------------------------------------


@pytest.mark.parametrize("feature,ids,dense", [
    ("user_id", np.array([0, 1, 7, -3, 1005, 999, 123456]), False),
    ("product_id", None, False),
    ("product_id", None, True),
])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_export_feature_embeddings_matches_jax(feature, ids, dense, compute_dtype):
    cfg = _config(compute_dtype, dense_dim=3 if dense else 0)
    params = _numpy_params(cfg)
    dense_in = (np.random.default_rng(1).normal(size=(300, 3)).astype(np.float32)
                if dense else None)
    want = np.asarray(jax_export(params, cfg, feature, ids=ids, batch_size=128,
                                 dense=dense_in)).astype(np.float32)
    got = export_feature_embeddings(params_from_numpy(params, _port(cfg), "cpu"), feature, ids=ids,
                                    batch_size=128, dense=dense_in)
    assert got.dtype == getattr(torch, compute_dtype)
    tol = F32 if compute_dtype == "float32" else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# --- Scorer and RetrievalService -------------------------------------------


@pytest.fixture(scope="module")
def models():
    cfg = _config()
    params = _numpy_params(cfg)
    return cfg, params, params_from_numpy(params, _port(cfg), "cpu")


def test_scorer_predict_and_embed_match_jax(models):
    cfg, params, model = models
    ref = JaxScorer(cfg, params)
    got = Scorer(model)
    inputs = _requests()
    np.testing.assert_allclose(got.predict(inputs), ref.predict(inputs), **F32)
    for a, b in zip(got.embed(inputs), ref.embed(inputs)):
        np.testing.assert_allclose(a, b, **F32)


def test_retrieval_service_matches_jax(models):
    cfg, params, model = models
    ref = JaxRetrievalService(cfg, params)
    svc = RetrievalService(model)
    assert svc.corpus_size == ref.corpus_size == 299
    users = [1, 7, 0, 999, 4321]
    for k in (1, 10, 299):
        items, scores = svc.retrieve(users, k=k)
        want_items, want_scores = ref.retrieve(users, k=k)
        np.testing.assert_array_equal(items, want_items)
        np.testing.assert_allclose(scores, want_scores, **F32)
    for bad_k in (0, 300):
        with pytest.raises(ValueError, match="out of range"):
            svc.retrieve(users, k=bad_k)


def test_retrieval_service_refresh(models):
    cfg, params, model = models
    svc = RetrievalService(model)
    other = params_from_numpy(_numpy_params(cfg, seed=5), _port(cfg), "cpu")
    svc.refresh(other)
    want = export_feature_embeddings(other, "product_id")[1:]
    assert torch.equal(svc.corpus, want) and svc.model is other


def test_load_model_reads_a_jax_export(tmp_path):
    from two_tower_recommender_model_tpu.train.step import create_train_state
    from two_tower_recommender_model_tpu.utils.checkpoint import export_model

    cfg = _config()
    state, _ = create_train_state(jax.random.key(0), cfg, cfg_lib.TrainConfig())
    export_model(str(tmp_path), cfg, state)
    got_cfg, got_params = load_model(str(tmp_path))
    assert got_cfg == _port(cfg)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    for name, table in state.tables.items():
        np.testing.assert_array_equal(got_params["tables"][name], np.asarray(table))
    inputs = _requests()
    np.testing.assert_allclose(load_scorer(str(tmp_path), device="cpu").predict(inputs),
                               jax_load_scorer(str(tmp_path)).predict(inputs), **F32)


# --- HTTP ------------------------------------------------------------------


def _post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def servers(models):
    cfg, params, model = models
    jax_srv = JaxModelServer(JaxScorer(cfg, params),
                             retrieval=JaxRetrievalService(cfg, params)).start()
    srv = ModelServer(Scorer(model), retrieval=RetrievalService(model)).start()
    bare_jax = JaxModelServer(JaxScorer(cfg, params)).start()
    bare = ModelServer(Scorer(model)).start()
    yield (jax_srv, srv), (bare_jax, bare)
    for s in (jax_srv, srv, bare_jax, bare):
        s.stop()


def _payloads():
    req = _requests(12)
    users, items = req["user_id"].tolist(), req["product_id"].tolist()
    return [
        {"inputs": {"user_id": users, "product_id": items}},
        {"dataframe_split": {"columns": ["user_id", "product_id"],
                             "data": [[u, i] for u, i in zip(users, items)]}},
        {"dataframe_records": [{"user_id": u, "product_id": i} for u, i in zip(users, items)]},
    ]


@pytest.mark.parametrize("form", [0, 1, 2])
def test_http_invocations_match_jax_server(servers, form):
    (jax_srv, srv), _ = servers
    payload = _payloads()[form]
    want_code, want = _post(jax_srv.url, "/invocations", payload)
    code, got = _post(srv.url, "/invocations", payload)
    assert code == want_code == 200
    np.testing.assert_allclose(got["predictions"], want["predictions"], **F32)


def test_http_retrieve_matches_jax_server(servers):
    (jax_srv, srv), _ = servers
    payload = {"user_id": [1, 7, 500, 0], "k": 10}
    want_code, want = _post(jax_srv.url, "/retrieve", payload)
    code, got = _post(srv.url, "/retrieve", payload)
    assert code == want_code == 200
    assert got["items"] == want["items"]
    np.testing.assert_allclose(got["scores"], want["scores"], **F32)


@pytest.mark.parametrize("path,payload,status", [
    ("/invocations", {"wrong": 1}, 400),
    ("/invocations", {"inputs": {"user_id": [1, 2]}}, 400),  # missing product_id
    ("/retrieve", {"user_id": [1], "k": 0}, 400),
    ("/retrieve", {"k": 5}, 400),
    ("/elsewhere", {}, 404),
])
def test_http_errors_match_jax_server(servers, path, payload, status):
    (jax_srv, srv), _ = servers
    assert _post(jax_srv.url, path, payload)[0] == status
    assert _post(srv.url, path, payload)[0] == status


def test_http_health_capture_and_missing_retrieval(servers, models, tmp_path):
    (_, srv), (bare_jax, bare) = servers
    with urllib.request.urlopen(srv.url + "/health", timeout=10) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    payload = {"user_id": [1], "k": 5}
    assert _post(bare_jax.url, "/retrieve", payload)[0] == 404
    assert _post(bare.url, "/retrieve", payload)[0] == 404
    cap = tmp_path / "capture.jsonl"
    with ModelServer(Scorer(models[2]), capture_path=str(cap)) as s:
        assert _post(s.url, "/invocations", _payloads()[0])[0] == 200
    assert "predictions" in json.loads(cap.read_text().splitlines()[0])


def test_validate_serving_input(models):
    scorer = Scorer(models[2])
    assert validate_serving_input(scorer, _payloads()[1]).shape == (12,)
    with pytest.raises(ValueError):
        validate_serving_input(scorer, {"nope": {}})


def test_cpu_serving_launches_no_kernel(models):
    before = pooled_gather.launches
    Scorer(models[2]).predict(_requests())
    assert pooled_gather.launches == before
