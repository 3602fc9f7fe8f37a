"""Gloo ranks for the parallel tests: a pool of N spawned processes in one
process group (`device="cpu"`), and the tasks they run.

The pool starts once a test module (each rank is a process that imports
torch and the port, a few seconds) and runs tasks by name on every rank:
`pool.run("train_steps", **kwargs)` returns each rank's result in rank
order. Inputs and results are numpy: the JAX side of a test lives in the
parent process only, and nothing here imports JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import sys
import traceback

import numpy as np

TIMEOUT_S = 240  # a task's longest wait; the ranks' collectives time out first


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """`world` gloo ranks, started by spawn, serving tasks until `close`."""

    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, world, port, self.inboxes[r],
                                                      self.outbox), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, task: str, **kwargs) -> list:
        for box in self.inboxes:
            box.put((task, kwargs))
        got: dict[int, object] = {}
        while len(got) < self.world:
            try:
                rank, ok, value = self.outbox.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"task {task}: ranks {sorted(set(range(self.world)) - set(got))}"
                                   f" gave no answer in {TIMEOUT_S} s") from None
            if not ok:
                raise RuntimeError(f"task {task} failed on rank {rank}:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()


def _serve(rank, world, port, inbox, outbox) -> None:
    import torch

    torch.set_num_threads(1)
    from two_tower_recommender_model_tpu_torch.parallel import launch

    launch.initialize_distributed("cpu", world, rank, f"tcp://127.0.0.1:{port}", timeout_s=120)
    this = sys.modules[__name__]
    while True:
        item = inbox.get()
        if item is None:
            break
        name, kwargs = item
        try:
            outbox.put((rank, True, getattr(this, name)(**kwargs)))
        except BaseException:  # noqa: BLE001 - sent to the parent, which raises it
            outbox.put((rank, False, traceback.format_exc()))
    assert not any(m.split(".")[0] in ("jax", "two_tower_recommender_model_tpu")
                   for m in sys.modules), "a rank imported JAX or the JAX package"
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the tasks (every rank runs each; helpers shared with the parent process)

_MESHES: dict = {}


def mesh_of(shape):
    """This rank's mesh of `shape` (data, model), made once: every rank
    makes every mesh, in one order (None beyond the mesh)."""
    from two_tower_recommender_model_tpu_torch.parallel.mesh import make_mesh

    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(*shape)
    return _MESHES[shape]


def configs(cfg: dict, tcfg: dict):
    from two_tower_recommender_model_tpu_torch import config as port_config

    tcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in tcfg.items()}
    return port_config.model_config_from_dict(cfg), port_config.TrainConfig(**tcfg)


def start_state(start: dict, pcfg, ptcfg, device="cpu"):
    """The port's state from a numpy start (`train_state_from_numpy`'s
    layout), f32 tables rounded into a bf16 model's tables."""
    from two_tower_recommender_model_tpu_torch.train.step import train_state_from_numpy

    return train_state_from_numpy(start, pcfg, ptcfg, device=device)


def port_batch(nb: dict):
    """A port `Batch` of CPU tensors from its numpy arrays:
    {"features": {name: (ids, mask)}, "labels", "weights"?, "dense"?}."""
    import torch

    from two_tower_recommender_model_tpu_torch.data.featurizer import Batch, SparseFeature

    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return Batch(features={k: SparseFeature(ids=t(i), mask=t(m))
                           for k, (i, m) in nb["features"].items()},
                 labels=t(nb["labels"]), dense=t(nb.get("dense")), weights=t(nb.get("weights")))


def state_numpy(state) -> dict:
    """Tables (f32), accumulators, towers in the JAX layout, Adam's moments
    in the JAX layout, and the step."""
    from two_tower_recommender_model_tpu_torch.models.two_tower import params_to_numpy

    out = params_to_numpy(state.model)
    out["adagrad_acc"] = {k: v.numpy().copy() for k, v in state.adagrad_acc.items()}
    opt = state.dense_opt_state
    for moment, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        out[moment] = {}
        for key in ("query_tower", "candidate_tower"):
            out[moment][key] = {}
            for i, layer in enumerate(getattr(state.model, key).layers):
                out[moment][key][f"layer_{i}"] = {
                    "kernel": opt.state[layer.weight][name].numpy().T.copy(),
                    "bias": opt.state[layer.bias][name].numpy().copy()}
    out["step"] = state.step
    out["item_counts"] = None if state.item_counts is None else state.item_counts.numpy().copy()
    return out


def _sharded_setup(cfg, tcfg, start, mesh_shape, force):
    from two_tower_recommender_model_tpu_torch.parallel.planner import plan_sharding
    from two_tower_recommender_model_tpu_torch.parallel.sharded import shard_train_state

    mesh = mesh_of(mesh_shape)
    if mesh is None:
        return None
    pcfg, ptcfg = configs(cfg, tcfg)
    state, opt = start_state(start, pcfg, ptcfg)
    plan = plan_sharding(pcfg, mesh.size, force=force)
    return mesh, pcfg, ptcfg, plan, shard_train_state(state, plan, mesh), opt


def train_steps(cfg, tcfg, start, batches, mesh_shape, force, packed_columns=None):
    """The sharded train step over `batches` (numpy `Batch`es); with
    `packed_columns`, also the packed macro-step over those columns from the
    same start. Rank 0 returns {"losses", "state", "plan"} (and
    {"macro_losses", "macro_state"}); the others None."""
    import torch

    from two_tower_recommender_model_tpu_torch.data.device_featurizer import PackedFeaturizer
    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        batch_sharding,
        macro_batch_sharding,
        make_sharded_multi_step,
        make_sharded_train_step,
        shard_train_state,
        unshard_train_state,
    )
    from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch
    from two_tower_recommender_model_tpu_torch.train.step import stack_batches

    setup = _sharded_setup(cfg, tcfg, start, mesh_shape, force)
    if setup is None:
        return None
    mesh, pcfg, ptcfg, plan, sh, opt = setup
    step = make_sharded_train_step(pcfg, ptcfg, opt, mesh, plan)
    losses, overflow = [], []
    for nb in batches:
        sh, out = step(sh, device_put_batch(port_batch(nb), sharding=batch_sharding(mesh)))
        losses.append(out["loss"].float().item())
        if "exchange_overflow" in out:
            overflow.append(int(out["exchange_overflow"]))
        assert out["logits"].shape[0] == nb["labels"].shape[0] // mesh.data
    full = unshard_train_state(sh, plan, pcfg, mesh, dst=0)
    result = None if mesh.rank else {"losses": losses, "state": state_numpy(full),
                                     "plan": plan.describe(), "overflow": overflow}
    if packed_columns is not None:
        state, _ = start_state(start, pcfg, ptcfg)
        sh = shard_train_state(state, plan, mesh)
        multi = make_sharded_multi_step(pcfg, ptcfg, opt, mesh, plan, pack_label=True)
        pf = PackedFeaturizer(pcfg, pack_label=True, sort_feature=ptcfg.sorted_feature)
        mb = stack_batches([pf(c) for c in packed_columns])
        sh, out = multi(sh, device_put_batch(mb, sharding=macro_batch_sharding(mesh)))
        full = unshard_train_state(sh, plan, pcfg, mesh, dst=0)
        if result is not None:
            result.update(macro_losses=out["loss"].float().tolist(),
                          macro_state=state_numpy(full),
                          macro_overflow=(int(out["exchange_overflow"])
                                          if "exchange_overflow" in out else None))
    torch.distributed.barrier(group=mesh.group)
    return result


def evaluate_columns(cfg, tcfg, start, columns, mesh_shape, force, pad_multiple=None,
                     pad_to=None):
    """`train.loop.evaluate` on the mesh over `columns`: every rank's
    metrics."""
    from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        batch_sharding,
        make_sharded_eval_step,
    )
    from two_tower_recommender_model_tpu_torch.train.loop import evaluate

    setup = _sharded_setup(cfg, tcfg, start, mesh_shape, force)
    if setup is None:
        return None
    mesh, pcfg, ptcfg, plan, sh, _ = setup
    return evaluate(sh, make_sharded_eval_step(pcfg, ptcfg, mesh, plan), columns,
                    Featurizer(pcfg, device="cpu"), stage="val", sharding=batch_sharding(mesh),
                    pad_multiple=pad_multiple, pad_to=pad_to)


def round_trip(cfg, tcfg, start, mesh_shape, force):
    """`shard_train_state` then `unshard_train_state` on every rank
    (`dst=None`) and on rank 0: each rank's gathered state, and rank 0's."""
    from two_tower_recommender_model_tpu_torch.parallel.sharded import unshard_train_state

    setup = _sharded_setup(cfg, tcfg, start, mesh_shape, force)
    if setup is None:
        return None
    mesh, pcfg, _, plan, sh, _ = setup
    everywhere = state_numpy(unshard_train_state(sh, plan, pcfg, mesh, dst=None))
    at0 = unshard_train_state(sh, plan, pcfg, mesh, dst=0)
    return {"everywhere": everywhere, "at0": None if at0 is None else state_numpy(at0)}


def loops_raise(cfg, tcfg, start, columns, mesh_shape, force):
    """`evaluate`, `train_one_epoch` and `train_one_epoch_packed` on the
    mesh over `columns`: each one's error message (None where it returned)."""
    from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
        PackedFeaturizer,
        make_packed_train_step,
    )
    from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        batch_sharding,
        macro_batch_sharding,
        make_sharded_eval_step,
        make_sharded_multi_step,
        make_sharded_train_step,
    )
    from two_tower_recommender_model_tpu_torch.train.loop import (
        evaluate,
        train_one_epoch,
        train_one_epoch_packed,
    )

    setup = _sharded_setup(cfg, tcfg, start, mesh_shape, force)
    if setup is None:
        return None
    mesh, pcfg, ptcfg, plan, sh, opt = setup
    feat, sharding = Featurizer(pcfg, device="cpu"), batch_sharding(mesh)
    step = make_sharded_train_step(pcfg, ptcfg, opt, mesh, plan)
    pf = PackedFeaturizer(pcfg, pack_label=True)
    runs = {
        "evaluate": lambda: evaluate(sh, make_sharded_eval_step(pcfg, ptcfg, mesh, plan),
                                     columns, feat, sharding=sharding),
        "train_one_epoch": lambda: train_one_epoch(sh, step, columns, feat, ptcfg,
                                                   sharding=sharding),
        "train_one_epoch_packed": lambda: train_one_epoch_packed(
            sh, make_sharded_multi_step(pcfg, ptcfg, opt, mesh, plan), columns, pf,
            macro=2, num_workers=1, train_cfg=ptcfg,
            tail_step=make_packed_train_step(step, pcfg, pack_label=True),
            sharding=macro_batch_sharding(mesh), tail_sharding=sharding),
    }
    out = {}
    for name, run in runs.items():
        try:
            run()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def sharded_lookup(table, ids, w, mesh_shape):
    """`make_sharded_lookup` on a row-sharded `table`: the pooled rows of
    the whole batch (each data rank's slice, gathered), on every rank."""
    import torch

    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        _all_gather,
        batch_sharding,
        make_sharded_lookup,
    )

    mesh = mesh_of(mesh_shape)
    if mesh is None:
        return None
    rows = table.shape[0] // mesh.size
    shard = torch.from_numpy(table[mesh.rank * rows:(mesh.rank + 1) * rows].copy())
    cut = batch_sharding(mesh)
    out = make_sharded_lookup(mesh)(shard, cut(torch.from_numpy(ids)), cut(torch.from_numpy(w)))
    return _all_gather(out, mesh.data_group, mesh.data).numpy()


def batch_numpy(batch) -> dict:
    """A `Batch` (JAX arrays or tensors) as `port_batch`'s numpy layout."""
    a = lambda x: None if x is None else np.asarray(x)  # noqa: E731
    return {"features": {k: (a(f.ids), a(f.mask)) for k, f in batch.features.items()},
            "labels": a(batch.labels), "weights": a(batch.weights), "dense": a(batch.dense)}



# ---------------------------------------------------------------------------
# M12(c): sharded top-k and retrieval, the compact wire on a mesh, several hosts


def topk_ranks(corpus, queries, k, chunk, mesh_shape):
    """`make_sharded_topk` over `corpus` cut by `shard_corpus` (padded to a
    multiple of the ranks, the real rows passed as `valid`): every rank's
    (scores, rows)."""
    import torch

    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        make_sharded_topk,
        shard_corpus,
    )

    mesh = mesh_of(mesh_shape)
    if mesh is None:
        return None
    shard, n = shard_corpus(torch.from_numpy(corpus), mesh)
    vals, idx = make_sharded_topk(mesh, k, chunk)(torch.from_numpy(queries), shard, valid=n)
    return vals.numpy(), idx.numpy()


def retrieval_ranks(cfg, params, users, ks, mesh_shape, params2=None, k2=5):
    """`RetrievalService(mesh=)` on every rank: (items, scores) for each k of
    `ks`, then after `refresh(params2)` at `k2`."""
    from two_tower_recommender_model_tpu_torch import config as port_config
    from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
    from two_tower_recommender_model_tpu_torch.serving.retrieval_service import RetrievalService

    mesh = mesh_of(mesh_shape)
    if mesh is None:
        return None
    pcfg = port_config.model_config_from_dict(cfg)
    svc = RetrievalService(params_from_numpy(params, pcfg, "cpu"), mesh=mesh)
    out = [svc.retrieve(users, k) for k in ks]
    if params2 is not None:
        svc.refresh(params_from_numpy(params2, pcfg, "cpu"))
        out.append(svc.retrieve(users, k2))
    return out


class _hosts:
    """torchrun's view of `n` hosts of equal ranks (`GROUP_RANK`,
    `LOCAL_WORLD_SIZE`), set in this rank's environment for a task."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        import os

        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        local = world // self.n
        self.saved = {k: os.environ.get(k) for k in ("GROUP_RANK", "LOCAL_WORLD_SIZE",
                                                    "LOCAL_RANK")}
        os.environ.update(GROUP_RANK=str(rank // local), LOCAL_WORLD_SIZE=str(local),
                          LOCAL_RANK=str(rank % local))
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _compact_scheme(pcfg, delta_feature, segments=1):
    from two_tower_recommender_model_tpu_torch.data.compact import CompactScheme

    return CompactScheme.from_model(pcfg, pack_label=True, delta_feature=delta_feature,
                                    delta_segments=segments)


def _compact_featurizer(pcfg, scheme):
    from two_tower_recommender_model_tpu_torch.data.compact import CompactFeaturizer
    from two_tower_recommender_model_tpu_torch.data.device_featurizer import PackedFeaturizer

    return CompactFeaturizer(PackedFeaturizer(pcfg, pack_label=True,
                                              sort_feature=scheme.delta_feature), scheme)


def compact_steps(cfg, tcfg, start, columns, mesh_shape, force, delta_feature=None):
    """The compact wire on the mesh: the K batches of `columns` encoded
    (host-sorted and delta-encoded by `delta_feature`), placed leaf by leaf
    (`compact_shardings`) and trained as one `make_sharded_compact_multi_step`
    call; and each batch's slices decoded (`sharded_compact_decoder`),
    gathered over data, against the one-device decode of the whole batch.
    Rank 0 returns {"losses", "state", "decoded_equal"}; the others None."""
    import torch

    from two_tower_recommender_model_tpu_torch.data.compact import batch_from_compact
    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        _all_gather,
        compact_shardings,
        make_sharded_compact_multi_step,
        sharded_compact_decoder,
        unshard_train_state,
    )
    from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch, map_leaves
    from two_tower_recommender_model_tpu_torch.train.step import stack_batches

    setup = _sharded_setup(cfg, tcfg, start, mesh_shape, force)
    if setup is None:
        return None
    mesh, pcfg, ptcfg, plan, sh, opt = setup
    scheme = _compact_scheme(pcfg, delta_feature)
    cf = _compact_featurizer(pcfg, scheme)
    encoded = [cf(c) for c in columns]
    placement = compact_shardings(mesh, scheme, encoded[0].batch_size)
    decode = sharded_compact_decoder(pcfg, scheme, mesh)
    equal = True
    for cb in encoded:
        got = decode(device_put_batch(cb, sharding=placement))
        want = batch_from_compact(map_leaves(cb, lambda t: t), pcfg, scheme)
        for name, f in want.features.items():
            for a, b in ((got.features[name].ids, f.ids), (got.features[name].mask, f.mask)):
                equal &= torch.equal(_all_gather(a.contiguous(), mesh.data_group, mesh.data), b)
        equal &= torch.equal(_all_gather(got.labels, mesh.data_group, mesh.data), want.labels)
    multi = make_sharded_compact_multi_step(pcfg, ptcfg, opt, mesh, plan, scheme)
    sh, out = multi(sh, device_put_batch(stack_batches(encoded), sharding=placement))
    full = unshard_train_state(sh, plan, pcfg, mesh, dst=0)
    torch.distributed.barrier(group=mesh.group)
    if mesh.rank:
        return None
    return {"losses": out["loss"].float().tolist(), "state": state_numpy(full),
            "decoded_equal": bool(equal)}


def multihost_steps(cfg, tcfg, start, columns, force, hosts, route, mesh_shape=(4, 1)):
    """`hosts` hosts of equal ranks (`_hosts`), each host featurizing its own
    slice of every batch of `columns` (host h: rows [h * B / hosts, (h + 1)
    * B / hosts)), as the reference's multi-host workers do: `route` "step"
    (`put_global_batch` into the sharded step), "packed" (one macro-batch,
    `macro_batch_sharding(mesh, hosts)`), "compact" or "delta" (the compact
    wire, `compact_shardings(..., hosts)`; "delta" sorts each host's batch by
    user and encodes it as one of `hosts` segments). Rank 0 returns {"losses",
    "state"}; the others None."""
    import torch

    from two_tower_recommender_model_tpu_torch.data.device_featurizer import PackedFeaturizer
    from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
    from two_tower_recommender_model_tpu_torch.parallel import launch
    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        compact_shardings,
        macro_batch_sharding,
        make_sharded_compact_multi_step,
        make_sharded_multi_step,
        make_sharded_train_step,
        unshard_train_state,
    )
    from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch
    from two_tower_recommender_model_tpu_torch.train.step import stack_batches

    setup = _sharded_setup(cfg, tcfg, start, mesh_shape, force)
    if setup is None:
        return None
    mesh, pcfg, ptcfg, plan, sh, opt = setup
    with _hosts(hosts):
        h, n = launch.per_host_loader_slice()
        assert n == hosts and launch.mesh_hosts(mesh) == hosts
        local = []
        for cols in columns:
            b = len(next(iter(cols.values()))) // n
            local.append({k: v[h * b:(h + 1) * b] for k, v in cols.items()})
        losses = []
        if route == "step":
            step = make_sharded_train_step(pcfg, ptcfg, opt, mesh, plan)
            feat = Featurizer(pcfg, device="cpu")
            for cols in local:
                sh, out = step(sh, launch.put_global_batch(feat(cols), mesh))
                losses.append(out["loss"].float().item())
        elif route == "packed":
            multi = make_sharded_multi_step(pcfg, ptcfg, opt, mesh, plan)
            pf = PackedFeaturizer(pcfg, pack_label=True)
            mb = stack_batches([pf(c) for c in local])
            sh, out = multi(sh, device_put_batch(mb, sharding=macro_batch_sharding(mesh, n)))
            losses = out["loss"].float().tolist()
        else:
            scheme = _compact_scheme(pcfg, "user_id" if route == "delta" else None,
                                     n if route == "delta" else 1)
            cf = _compact_featurizer(pcfg, scheme)
            mb = stack_batches([cf(c) for c in local])
            placement = compact_shardings(mesh, scheme, mb.wire.shape[-1], n)
            multi = make_sharded_compact_multi_step(pcfg, ptcfg, opt, mesh, plan, scheme, n)
            sh, out = multi(sh, device_put_batch(mb, sharding=placement))
            losses = out["loss"].float().tolist()
    full = unshard_train_state(sh, plan, pcfg, mesh, dst=0)
    torch.distributed.barrier(group=mesh.group)
    return None if mesh.rank else {"losses": losses, "state": state_numpy(full)}
