"""On-card smoke run of the PyTorch port: build the CUDA kernel, hold it
against its plain PyTorch version, then serve the full-width flagship model
over HTTP and check what comes back.

    python3 chip_smoke.py [--profile]

Needs one CUDA card, `nvcc` and this repository's sources; exits non-zero
without a card. Phases (any failure raises and exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build `csrc/pooled_gather.cu` with nvcc, timed;
3. kernel vs plain version on the card at the serving shapes (flagship user
   table, 8,192 bags): exact at one slot (f32 and bf16) and for sentinel ids,
   relative 1e-5 at three mean-weighted slots; median CUDA-event times of both;
4. the flagship (206,209 users x 49,688 items, dim 128, towers (128, 64),
   f32, random weights from a seeded generator) served through `Scorer`,
   `RetrievalService` and `ModelServer`: /invocations at 1, 100 and 8,192
   rows and one dataframe_split payload, /retrieve for 16 and 1,000 users at
   k = 100. The launch count is reset just before this main path and read
   just after it, and each group of requests must launch the kernel exactly
   as often as the path says (7 for the corpus export, 2 per /invocations,
   1 per /retrieve). The answers are checked after that, outside the count,
   against direct calls, a plain-PyTorch forward and a brute-force top-k;
5. with --profile, a torch.profiler trace of the direct calls: device busy
   time and idle share per call.

The line before the last is a JSON object describing each kernel; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import export_feature_embeddings
from two_tower_recommender_model_tpu_torch.models.two_tower import init_params, towers_forward
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import (
    pooled_gather,
    pooled_gather_reference,
)
from two_tower_recommender_model_tpu_torch.serving import RetrievalService, Scorer
from two_tower_recommender_model_tpu_torch.serving.server import ModelServer

NUM_USERS, NUM_ITEMS, DIM, LAYERS = 206_209, 49_688, 128, (128, 64)
BAGS = 8192
EXPORT_BATCH = 8192  # ids per launch of export_feature_embeddings (its batch_size)
REPS = 50  # timed launches per version
REQ_REPS = 5  # HTTP requests per payload
KERNEL_SOURCE = "two_tower_recommender_model_tpu_torch/csrc/pooled_gather.cu"
KERNEL_REPLACES = "two_tower_recommender_model_tpu/ops/pallas_embedding.py:40"


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, flush: torch.Tensor) -> float:
    """Median device ms over REPS launches of `fn`, each after an L2 flush (a
    serving lookup meets a cold cache: the user table is twice the 50 MB L2).
    The flush is a read, so no dirty lines are written back during the timed
    launch. A GPU-side sleep queued first keeps the card busy while the host
    enqueues the events and `fn`, so the events bracket the device work alone."""
    fn()
    times = []
    for _ in range(REPS):
        flush.sum()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)  # ~1 ms of spinning at H100 clocks
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def phase_kernel(dev: torch.device) -> dict:
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    user_table = torch.empty((NUM_USERS, DIM), device=dev).uniform_(-1, 1, generator=gen)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB > L2

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # one slot, ~10% dead (mask 0 with id 0, as the featurizer emits them)
    live = rng.random((BAGS, 1)) > 0.1
    ids1 = on_card(np.where(live, rng.integers(0, NUM_USERS, (BAGS, 1)), 0).astype(np.int32))
    w1 = on_card(live.astype(np.float32))
    # three slots, mean weights, some slots dead
    live3 = rng.random((BAGS, 3)) > 0.2
    ids3 = on_card(np.where(live3, rng.integers(0, NUM_USERS, (BAGS, 3)), 0).astype(np.int32))
    w3 = live3.astype(np.float32)
    w3 = on_card(w3 / np.maximum(w3.sum(1, keepdims=True), 1.0))
    # sentinels: a quarter of the ids at or past N
    sent = rng.random((BAGS, 1)) < 0.25
    ids_s = on_card(np.where(sent, NUM_USERS + rng.integers(0, 1000, (BAGS, 1)),
                             rng.integers(0, NUM_USERS, (BAGS, 1))).astype(np.int32))
    ones = torch.ones((BAGS, 1), device=dev)
    bf16_table = user_table.to(torch.bfloat16)
    item_table = user_table[:NUM_ITEMS].contiguous()
    item_ids = on_card(rng.integers(0, NUM_ITEMS, (BAGS, 1)).astype(np.int32))

    cases = [
        # name, args, exact?
        ("user f32 L=1", (user_table, ids1, w1, torch.float32), True),
        ("user f32 L=3 mean", (user_table, ids3, w3, torch.float32), False),
        ("user f32 sentinels", (user_table, ids_s, ones, torch.float32), True),
        ("user bf16->bf16 L=1", (bf16_table, ids1, w1, torch.bfloat16), True),
        ("item f32 export", (item_table, item_ids, ones, torch.float32), True),
    ]
    results = []
    for name, (table, ids, w, out_dtype), exact in cases:
        got = pooled_gather(table, ids, w, out_dtype)
        want = pooled_gather_reference(table, ids, w, out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if exact:
            if not bitwise_equal(got, want):
                raise AssertionError(f"{name}: kernel != plain version (max abs diff {err})")
        elif err > 1e-5 * want.float().abs().max().item():  # summation order differs
            raise AssertionError(f"{name}: max abs diff {err} > 1e-5 x max |plain|")
        if name == "user f32 sentinels":
            zero_rows = got[ids_s[:, 0] >= NUM_USERS]
            if zero_rows.numel() == 0 or torch.count_nonzero(zero_rows).item() != 0:
                raise AssertionError("sentinel ids must give exact zero rows")
        ms = median_ms(lambda: pooled_gather(table, ids, w, out_dtype), flush)
        plain_ms = median_ms(lambda: pooled_gather_reference(table, ids, w, out_dtype), flush)
        log(f"[kernel] {name}: [{ids.shape[0]}, {ids.shape[1]}] from [{table.shape[0]}, "
            f"{table.shape[1]}] {'bitwise equal' if exact else 'within 1e-5 x max|plain|'}, "
            f"max_abs_err={err!r}, kernel_ms={ms!r}, plain_ms={plain_ms!r}")
        results.append((name, err, ms, plain_ms))
    return {"max_abs_err": max(r[1] for r in results), "ms": results[0][2],
            "plain_ms": results[0][3]}


def post(url: str, payload: dict) -> tuple[dict, float]:
    body = json.dumps(payload).encode()
    req = urllib.request.Request(url, body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out, (time.perf_counter() - t0) * 1e3


def timed_requests(url: str, payload: dict, label: str, launches_each: int) -> dict:
    """REQ_REPS identical requests; their median latency, and a check that
    together they launched the pooled-gather kernel exactly
    `launches_each * REQ_REPS` times."""
    before = pooled_gather.launches
    outs, lat = [], []
    for _ in range(REQ_REPS):
        out, ms = post(url, payload)
        outs.append(out)
        lat.append(ms)
    launched = pooled_gather.launches - before
    if launched != launches_each * REQ_REPS:
        raise AssertionError(f"{label}: {launched} pooled-gather launches over {REQ_REPS} "
                             f"requests, expected {launches_each} each")
    if any(o != outs[0] for o in outs[1:]):
        raise AssertionError(f"{label}: repeated requests disagree")
    log(f"[serve] {label}: median_ms={statistics.median(lat)!r} first_ms={lat[0]!r} "
        f"(n={REQ_REPS}), pooled_gather launches={launched}")
    return outs[0]


def timed_direct(fn, label: str) -> None:
    """Median wall time of a direct call (no HTTP, no JSON), for comparison."""
    lat = []
    for _ in range(REQ_REPS):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"[direct] {label}: median_ms={statistics.median(lat)!r} (n={REQ_REPS})")


def profile_direct(fn, label: str, gathers_per_call: int, calls: int = 10) -> None:
    """Where a direct call's time goes on the card: `torch.profiler` traces
    the device alone over `calls` calls, after 3 traced warm-up calls that it
    discards (tracing starts late, so without them the first calls' events
    go missing). The trace must hold `gathers_per_call` pooled-gather
    launches per call, which shows it is complete. Busy time is the union of
    the device events' intervals (kernels, copies, memsets), so nothing is
    counted twice; the idle share is 1 - busy / wall, where wall is the
    host's clock over the same calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    warmup = 3
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=warmup, active=calls, repeat=1)) as prof:
        for step in range(warmup + calls):
            if step == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            fn()
            if step == warmup + calls - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / calls
            prof.step()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    gathers = sum("pooled_gather" in name for _, _, name in spans)
    if gathers != gathers_per_call * calls:
        raise AssertionError(f"{label}: the trace holds {gathers} pooled-gather launches, "
                             f"expected {gathers_per_call * calls}")
    busy, (lo, hi) = 0.0, spans[0][:2]
    by_name: dict[str, list] = {}
    for start, end, name in spans:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
        item = by_name.setdefault(name[:70], [0.0, 0])
        item[0] += (end - start) / 1e3 / calls
        item[1] += 1
    busy = (busy + hi - lo) / 1e3 / calls
    log(f"[profile] {label}: wall_ms={wall!r} device_busy_ms={busy!r} "
        f"idle_share={1 - busy / wall!r} (per call, {calls} calls)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"[profile]   {ms!r} ms in {n / calls!r} launches: {name}")


@torch.no_grad()
def phase_serve(dev: torch.device, profile: bool) -> int:
    """The main path first, counted alone: the services are built, the server
    starts and every request is sent, and nothing else runs on the card in
    between. Its answers are checked after, against direct calls, the plain
    lookup and a brute-force top-k; those launches are not counted."""
    rng = np.random.default_rng(1)
    cfg = cfg_lib.two_tower_model_config(NUM_USERS, NUM_ITEMS, embedding_dim=DIM,
                                         layer_sizes=LAYERS)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    requests = []
    for n in (1, 100, BAGS):
        users = rng.integers(0, NUM_USERS, n)
        users[::10] = 0  # dropped ids pool to zero
        requests.append({"user_id": users, "product_id": rng.integers(0, NUM_ITEMS, n)})
    split = {"columns": ["user_id", "product_id"],
             "data": [[int(u), int(i)] for u, i in zip(rng.integers(1, NUM_USERS, 64),
                                                       rng.integers(1, NUM_ITEMS, 64))]}
    retrieve_users = [rng.integers(1, NUM_USERS, n) for n in (16, 1000)]

    # --- the main path, counted ------------------------------------------------
    pooled_gather.launches = 0
    scorer = Scorer(model)
    svc = RetrievalService(model)  # exports the corpus once, EXPORT_BATCH ids per launch
    export_launches = pooled_gather.launches
    if export_launches != -(-NUM_ITEMS // EXPORT_BATCH):
        raise AssertionError(f"corpus export made {export_launches} pooled-gather launches")
    if svc.corpus_size != NUM_ITEMS - 1:
        raise AssertionError(f"corpus {svc.corpus_size} != {NUM_ITEMS - 1}")
    server = ModelServer(scorer, host="127.0.0.1", port=0, retrieval=svc).start()
    try:
        invocations = [  # two lookups per request, one per tower
            timed_requests(server.url + "/invocations",
                           {"inputs": {k: v.tolist() for k, v in inputs.items()}},
                           f"/invocations {len(inputs['user_id'])} rows", 2)["predictions"]
            for inputs in requests]
        split_preds = timed_requests(server.url + "/invocations", {"dataframe_split": split},
                                     "/invocations dataframe_split 64 rows", 2)["predictions"]
        retrievals = [  # one user-embedding lookup per EXPORT_BATCH users
            timed_requests(server.url + "/retrieve", {"user_id": users.tolist(), "k": 100},
                           f"/retrieve {len(users)} users k=100",
                           -(-len(users) // EXPORT_BATCH))
            for users in retrieve_users]
    finally:
        server.stop()
    launches = pooled_gather.launches
    log(f"[serve] pooled_gather launches on the main path: {launches} (corpus export "
        f"{export_launches}, the rest from the HTTP requests)")

    # --- checks, not counted -----------------------------------------------------
    for inputs, preds in zip(requests, invocations):
        n = len(inputs["user_id"])
        preds = np.asarray(preds, np.float32)
        if preds.shape != (n,) or not np.isfinite(preds).all():
            raise AssertionError(f"{n} rows: bad predictions shape/values")
        if not ((preds >= 0) & (preds <= 1)).all():
            raise AssertionError(f"{n} rows: probabilities outside [0, 1]")
        np.testing.assert_array_equal(preds, scorer.predict(inputs))
        timed_direct(lambda: scorer.predict(inputs), f"Scorer.predict {n} rows")
        if n == 100:  # the same rows through the plain lookup on the card
            batch = Featurizer(cfg, device=dev)({**inputs, "label": np.zeros(n)})
            pooled = {fc.name: pooled_gather_reference(
                model.tables[fc.table], batch.features[fc.name].ids,
                batch.features[fc.name].mask) for fc in cfg.features}
            q, c = towers_forward(model, pooled, None)
            plain = torch.sigmoid((q * c).sum(1)).cpu().numpy()
            np.testing.assert_allclose(preds, plain, rtol=1e-5, atol=1e-7)
    cols = np.asarray(split["data"])
    np.testing.assert_array_equal(
        np.asarray(split_preds, np.float32),
        scorer.predict({"user_id": cols[:, 0], "product_id": cols[:, 1]}))

    for users, out in zip(retrieve_users, retrievals):
        items = np.asarray(out["items"])
        scores = np.asarray(out["scores"], np.float32)
        if items.shape != (len(users), 100) or not np.isfinite(scores).all():
            raise AssertionError("/retrieve: bad shape or values")
        if not ((items >= 1) & (items < NUM_ITEMS)).all():
            raise AssertionError("/retrieve: item ids outside [1, N)")
        q = export_feature_embeddings(model, "user_id", ids=users)
        full = q @ svc.corpus.T  # brute force on the card
        want = torch.topk(full, 100, dim=1).values.cpu().numpy()
        np.testing.assert_allclose(scores, want, rtol=1e-5, atol=0)
        got = torch.gather(full, 1, torch.from_numpy(items - 1).to(dev)).cpu().numpy()
        np.testing.assert_allclose(scores, got, rtol=1e-5, atol=0)
        timed_direct(lambda: svc.retrieve(users, k=100),
                     f"RetrievalService.retrieve {len(users)} users k=100")

    if profile:
        for inputs in requests[::2]:
            profile_direct(lambda: scorer.predict(inputs),
                           f"Scorer.predict {len(inputs['user_id'])} rows", 2)
        for users in retrieve_users:
            profile_direct(lambda: svc.retrieve(users, k=100),
                           f"RetrievalService.retrieve {len(users)} users k=100", 1)
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace the direct calls with torch.profiler and print "
                             "device busy time, idle share and the largest device items")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = pooled_gather.load()
    log(f"[build] {built.path.name}: nvcc {built.build_seconds!r} s, load "
        f"{time.perf_counter() - t0!r} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    kstats = phase_kernel(dev)
    launches = phase_serve(dev, args.profile)
    torch.cuda.synchronize()
    leaked = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "two_tower_recommender_model_tpu")]
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked[:5]}")

    print(json.dumps({"kernels": [{
        "name": "pooled_gather", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, **kstats}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
