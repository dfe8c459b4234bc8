"""Worker processes of the port's multi-process CPU tests
(``test_torch_mesh_devices.py``, ``test_torch_train_dp.py``,
``test_torch_opcount.py``, ``test_torch_tp.py``).

``spawn_world(fn, world, tmp_path, *args)`` starts ``world`` processes
with ``torch.multiprocessing`` (spawn), each joining a gloo world over a
``FileStore`` in ``tmp_path`` and calling ``fn(rank, world, tmp_path,
*args)``; rank 0's return value is pickled to a file and handed back.
This module imports no jax, so the workers start in a few seconds.
"""
from __future__ import annotations

import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEQ, GLOBAL_BATCH = 32, 4


def _entry(rank, world, tmp, fn, args):
    from repro_torch.sharding import init_world

    torch.set_num_threads(1)
    init_world(rank, world, "gloo", Path(tmp) / "store")
    try:
        out = fn(rank, world, Path(tmp), *args)
        if rank == 0:
            with open(Path(tmp) / "result.pkl", "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world: int, tmp, *args):
    """Run ``fn`` on every rank of a gloo world of ``world`` processes and
    return rank 0's result."""
    mp.start_processes(_entry, args=(world, str(tmp), fn, args),
                       nprocs=world, join=True, start_method="spawn")
    with open(Path(tmp) / "result.pkl", "rb") as f:
        return pickle.load(f)


def walk(tree, path=()):
    """("/"-joined path, leaf) of a tree of dicts and NamedTuples, in the
    snapshot bridge's order (dict keys sorted, None fields skipped)."""
    from repro_torch.core.snapshot import _flatten, _leaf_name

    for p, leaf in _flatten(tree):
        yield _leaf_name(p), leaf


# --------------------------------------------------------------------------
# mesh devices: a Shard(0) tree over 4 ranks, committed, redistributed
# --------------------------------------------------------------------------
def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32),
            "h": rng.standard_normal((16, 8)).astype(np.float32)}


def _sharded_tree(full, mesh, fill=True):
    """Each leaf as a DTensor sharded ``Shard(0)`` over ``mesh``'s one
    axis (a rank outside the mesh gets None)."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.sharding import NamedSharding, P

    if mesh.get_coordinate() is None:
        return None
    out = {}
    for name, arr in full.items():
        box = NamedSharding(mesh, P("data")).devices_indices_map(
            arr.shape)[dist.get_rank()]
        local = torch.from_numpy(np.ascontiguousarray(arr[box])) if fill \
            else torch.full(arr[box].shape, float("nan"))
        if name == "h":        # a bfloat16 leaf travels as its bits
            local = local.to(torch.bfloat16)
        out[name] = DTensor.from_local(local, mesh, [Shard(0)],
                                       run_check=False)
    return out


def _mesh_2d(shape, names):
    """A mesh over the world's first prod(shape) ranks laid out as
    ``shape`` (``make_mesh`` makes one-axis meshes)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def mesh_redistribution(rank, world, tmp):
    """The twin of ``tests/test_elastic_mesh_devices.py``: commit a tree
    sharded over 4 ranks as 4 parts, then redistribute it onto 8 ranks
    and onto 2, each rank's shard bit-equal to its box of the original.
    Also returns each rank's box of ``NamedSharding`` on the meshes and
    specs the test holds against JAX's."""
    import dataclasses

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.core import plan as planlib
    from repro_torch.core.snapshot import load_leaf_, snapshot_pytree
    from repro_torch.core.types import PartitionDesc, PartitionScheme
    from repro_torch.sharding import NamedSharding, P, make_mesh

    full = _tree_np()
    report = {"parts": {}, "moved": {}, "boxes": {}}
    cluster = ICheckCluster(n_icheck_nodes=2) if rank == 0 else None
    client = None
    try:
        m4 = make_mesh(4)
        tree = _sharded_tree(full, m4)
        if rank == 0:
            client = ICheckClient("app", cluster.controller, ranks=4).init()
        if tree is not None:
            snap = snapshot_pytree(tree, step=0)
            assert (snap is None) == (rank != 0)
            if rank == 0:
                report["parts"] = {n: r.meta.partition.num_parts
                                   for n, r in snap.regions.items()}
                client.add_adapt_snapshot(snap)
                client.commit(0, {n: r.parts for n, r in snap.regions.items()},
                              blocking=True)
        for new_n in (8, 2):
            mesh = make_mesh(new_n)
            new_tree = _sharded_tree(full, mesh, fill=False)
            if new_tree is not None:
                for name, leaf in new_tree.items():
                    meta = parts = None
                    if rank == 0:
                        boxes = planlib.mesh_part_bounds(
                            leaf.shape, NamedSharding(mesh, P("data")))
                        parts = client.redistribute_mesh(name, boxes)
                        report["moved"][(new_n, name)] = len(parts)
                        meta = dataclasses.replace(
                            client.regions[name],
                            partition=PartitionDesc(
                                scheme=PartitionScheme.MESH,
                                num_parts=len(boxes), bounds=boxes))
                    load_leaf_(name, leaf, meta, parts)
            # every rank of the new mesh checks its shard against the
            # original's box, bit for bit
            ok = torch.ones(())
            if new_tree is not None:
                want = _sharded_tree(full, mesh)
                for name in full:
                    if not torch.equal(new_tree[name].to_local(),
                                       want[name].to_local()):
                        ok.zero_()
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            report[f"bit_equal_{new_n}"] = bool(ok)
        # NamedSharding's boxes on the meshes the test compares with JAX's
        for shape, names, spec in (((4,), ("data",), P("data")),
                                   ((8,), ("data",), P("data")),
                                   ((2, 4), ("data", "model"),
                                    P("data", "model")),
                                   ((2, 4), ("pod", "data"),
                                    P(("pod", "data")))):
            mesh = _mesh_2d(shape, names)
            for arr_shape in ((64, 32), (16, 8, 4)):
                m = NamedSharding(mesh, spec).devices_indices_map(arr_shape)
                report["boxes"][(shape, names, tuple(spec), arr_shape)] = {
                    r: tuple((s.start, s.stop) for s in box)
                    for r, box in m.items()}
        # ``constrain`` on a replicated DTensor under TP rules on a (2, 4)
        # (data, model) mesh: batch over "data", act_ff over "model"
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.sharding import TP_RULES, constrain, use_rules

        mesh = _mesh_2d((2, 4), ("data", "model"))
        x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
        dx = DTensor.from_local(x.clone(), mesh, [Replicate(), Replicate()],
                                run_check=False)
        with use_rules(mesh, TP_RULES):
            y = constrain(dx, "batch", "act_ff")
        box = NamedSharding(mesh, P("data", "model")).devices_indices_map(
            x.shape)[rank]
        ok = torch.tensor(float(torch.equal(y.to_local(), x[box])))
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        report["constrain"] = ([str(p) for p in y.placements], bool(ok))
        if rank == 0:
            client.finalize()
    finally:
        if cluster is not None:
            cluster.close()
    return report


# --------------------------------------------------------------------------
# the data-parallel trainer
# --------------------------------------------------------------------------
def load_state_(state, arrays) -> None:
    """Copy numpy arrays (by leaf name) into a TrainState in place."""
    with torch.no_grad():
        for name, leaf in walk(state):
            leaf.copy_(torch.from_numpy(np.asarray(arrays[name])))


def state_arrays(state):
    return {name: leaf.detach().numpy().copy() for name, leaf in walk(state)}


def _shape():
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("t", "train", SEQ, GLOBAL_BATCH)


def _trainer(arch, cluster, seed, ranks, **kw):
    """``arch``: a name, or "name:rules" for its tiny config under other
    rules."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import ElasticTrainer

    name, _, rules = arch.partition(":")
    cfg = get_config(name, tiny=True)
    if rules:
        cfg = dataclasses.replace(cfg, rules=rules)
    return ElasticTrainer(cfg, _shape(), cluster,
                          app_id="app", ranks=ranks, seed=seed,
                          opt_cfg=AdamWConfig(lr=1e-3), probe_every=0,
                          global_batch=GLOBAL_BATCH, device="cpu", **kw)


def trainer_resize(rank, world, tmp, arch, init, plan, commit_every):
    """A trainer from ``init`` (the reference's initial state, by leaf
    name) through ``plan``, a list of (steps, ranks to resize to after
    them or None).  Returns rank 0's losses, final state and ranks seen,
    and whether every rank of the last mesh holds rank 0's state bit for
    bit."""
    from repro_torch.core import ICheckCluster

    cluster = ICheckCluster(n_icheck_nodes=2) if rank == 0 else None
    try:
        t = _trainer(arch, cluster, seed=0, ranks=1,
                     commit_every=commit_every)
        if t.state is not None:
            load_state_(t.state, init)
        sizes = []
        for steps, new_ranks in plan:
            t.run(steps)
            sizes.append(t.mesh.size())
            if new_ranks is not None and rank == 0:
                cluster.rm.schedule_resize("app", new_ranks)
        replicas_equal = _replicas_equal(t)
        out = None
        if rank == 0:
            out = {"losses": [m["loss"] for m in t.metrics_log],
                   "state": state_arrays(t.state), "sizes": sizes,
                   "resizes": t.resizes, "replicas_equal": replicas_equal,
                   "ranks": t.app.ranks}
        t.finalize()
        return out
    finally:
        if cluster is not None:
            cluster.close()


def _replicas_equal(t) -> bool:
    """Every rank of the trainer's mesh holds the state rank 0 holds."""
    ok = torch.ones(())
    if t.state is not None:
        group = t.mesh.get_group(0)
        for _, leaf in walk(t.state):
            mine = leaf.detach().clone()
            root = mine.clone()
            dist.broadcast(root, src=0, group=group)
            if not torch.equal(mine, root):
                ok.zero_()
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok)


def trainer_restart_across_ranks(rank, world, tmp, arch, init, steps):
    """``steps`` steps on 2 ranks committing at the last, then a new
    trainer on 1 rank restarts from that commit and takes ``steps``
    more.  Returns rank 0's losses of both and the final state."""
    from repro_torch.core import ICheckCluster

    cluster = ICheckCluster(n_icheck_nodes=2) if rank == 0 else None
    try:
        t1 = _trainer(arch, cluster, seed=0, ranks=2, commit_every=0)
        load_state_(t1.state, init)
        t1.run(steps)
        losses = [m["loss"] for m in t1.metrics_log]
        t1.commit(blocking=True)
        t2 = _trainer(arch, cluster, seed=7, ranks=1, commit_every=0)
        restarted = t2.restarted
        t2.run(steps)
        out = None
        if rank == 0:
            out = {"losses": losses + [m["loss"] for m in t2.metrics_log],
                   "restarted": restarted, "state": state_arrays(t2.state),
                   "mesh": t2.mesh.size()}
        t2.finalize()
        return out
    finally:
        if cluster is not None:
            cluster.close()


def dp_grads(rank, world, tmp, arch, init, batch, steps, microbatches=1):
    """The data-parallel loss and gradient over the world at ``init``
    (rank-sliced ``batch``, numpy, the whole global batch) in
    ``microbatches``, then the losses of ``steps`` data-parallel train
    steps from it."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.train.step import _grads

    cfg = get_config(arch, tiny=True)
    opt = AdamWConfig(lr=1e-3)
    state = make_train_state(cfg, None, opt, "cpu")
    load_state_(state, init)
    b = batch["tokens"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * b:(rank + 1) * b])
            for k, v in batch.items()}
    group = dist.group.WORLD
    loss, _, grads = _grads(cfg, state.params, mine, group,
                            microbatches=microbatches)
    out = {"loss": float(loss),
           "grads": {n: g.numpy().copy() for n, g in walk(grads)}}
    step = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10),
                           microbatches=microbatches, group=group)
    out["losses"] = [float(step(state, mine)[1]["loss"])
                     for _ in range(steps)]
    return out


# --------------------------------------------------------------------------
# test_torch_opcount.py: collectives under the op counter
# --------------------------------------------------------------------------
def counted_collectives(rank, world, tmp, n):
    """Two all-reduces of ``n`` f32 values and an all-gather of ``n`` per
    rank, under an ``OpCounter``; returns its collectives."""
    from repro_torch.launch.opcount import OpCounter

    x, y = torch.ones(n), torch.ones(n)
    out = torch.empty(world * n)
    with OpCounter() as counter:
        dist.all_reduce(x)
        dist.all_reduce(y)
        dist.all_gather_into_tensor(out, torch.ones(n))
    assert float(x[0]) == world
    return counter.result()["collectives"]


# --------------------------------------------------------------------------
# test_torch_tp.py: the "model" axis
# --------------------------------------------------------------------------
def _gathered(obj):
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _tp_cfg(case):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(case["arch"], tiny=True),
                               **case.get("over", {}))


def tp_serve(rank, world, tmp, data, model, cases):
    """Each case ({arch, over, params (numpy tree), tokens, gen}) served on
    a (data, model) mesh: this rank's prefill logits and cache, the
    generated tokens with the cache committed on rank 0, the cache
    restored on the mesh (bit-equal to a second prefill's) and the decode
    from it, then the commit restored whole on rank 0 alone and decoded
    there.  Returns every rank's results (rank 0's return value)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.serve import ServeEngine, serve_max_len
    from repro_torch.sharding import make_tp_mesh

    mesh = make_tp_mesh(data, model)
    out = []
    for i, case in enumerate(cases):
        cfg = _tp_cfg(case)
        toks, gen = case["tokens"], case["gen"]
        full = params_from_numpy(case["params"], "cpu")
        max_len = serve_max_len(cfg, toks.shape[1], gen)
        eng = ServeEngine(cfg, full, max_len=max_len, device="cpu", mesh=mesh)
        res = {"coord": (mesh.get_local_rank("data"),
                         mesh.get_local_rank("model")),
               "param_shapes": {n: tuple(t.shape)
                                for n, t in walk(eng.params)}}
        logits, cache = eng.prefill({"tokens": toks})
        res["logits"] = logits.numpy().copy()
        res["cache"] = {n: t.numpy().copy() for n, t in walk(cache)}
        cluster = ICheckCluster(n_icheck_nodes=1) if rank == 0 else None
        try:
            client = ICheckClient(f"serve{i}", cluster.controller).init() \
                if rank == 0 else None
            res["tokens"] = eng.generate({"tokens": toks}, gen_len=gen,
                                         checkpoint_client=client)
            if rank == 0:
                eng.last_commit.wait(timeout=60)
                res["parts"] = {n: r.partition.num_parts
                                for n, r in client.regions.items()}
            restored = eng.restore_serving_state(client, toks.shape[0])
            _, fresh = eng.prefill({"tokens": toks})
            res["restored_equal"] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(walk(restored), walk(fresh)))
            res["restored_decode"] = eng.decode_greedy(
                restored, res["tokens"][:, :1], gen - 1)
            if rank == 0:
                one = ServeEngine(cfg, full, max_len=max_len, device="cpu")
                whole = one.restore_serving_state(client, toks.shape[0])
                res["whole"] = {n: t.numpy().copy() for n, t in walk(whole)}
                res["whole_decode"] = one.decode_greedy(
                    whole, res["tokens"][:, :1], gen - 1)
                client.finalize()
        finally:
            if cluster is not None:
                cluster.close()
        out.append(res)
    # an RWKV-6 split that would cut inside a head raises: tiny rwkv6-7b
    # with one head of 64 (its parameters on "meta": the check comes
    # first)
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    rwkv = dataclasses.replace(get_config("rwkv6-7b", tiny=True),
                               rwkv_head_dim=64)
    try:
        ServeEngine(rwkv, init_params(rwkv, None, "meta"), max_len=8,
                    device="cpu", mesh=mesh)
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"cases": _gathered(out), "rwkv_raised": raised}


def tp_train(rank, world, tmp, data, model, cases, steps):
    """Each case ({arch, over, params (numpy tree), batch}) trained on a
    (data, model) mesh from the whole params' shards: this rank's param
    shards, its loss and gradient shards over its rows of the batch, then
    the losses and clip norms of ``steps`` train steps.  Returns every
    rank's results."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import param_split
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
    from repro_torch.sharding import get_rules, make_tp_mesh, use_rules
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.step import _grads, compute_grads

    mesh = make_tp_mesh(data, model)
    out = []
    for case in cases:
        cfg = _tp_cfg(case)
        params = params_from_numpy(case["params"], "cpu", cfg, mesh)
        res = {"coord": (mesh.get_local_rank("data"),
                         mesh.get_local_rank("model")),
               "params": {n: t.numpy().copy() for n, t in walk(params)}}
        b = case["batch"]["tokens"].shape[0] // data
        d = mesh.get_local_rank("data")
        mine = {k: torch.from_numpy(v[d * b:(d + 1) * b])
                for k, v in case["batch"].items()}
        with use_rules(mesh, get_rules(cfg.rules)):
            if data > 1:
                loss, _, grads = _grads(cfg, params, mine,
                                           mesh.get_group("data"),
                                           param_split(cfg, mesh))
            else:
                loss, _, grads = compute_grads(cfg, params, mine)
        res["loss"] = float(loss)
        res["grads"] = {n: g.numpy().copy() for n, g in walk(grads)}
        opt = AdamWConfig(lr=1e-3)
        state = TrainState(params=params, opt=adamw_init(params),
                           step=torch.zeros((), dtype=torch.int32))
        step = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10),
                               mesh=mesh)
        res["losses"], res["grad_norms"] = [], []
        for _ in range(steps):
            state, m = step(state, mine)
            res["losses"].append(float(m["loss"]))
            res["grad_norms"].append(float(m["grad_norm"]))
        out.append(res)
    return _gathered(out)


def tp_world(rank, world, tmp, data, model, cases, steps):
    """``tp_serve`` then ``tp_train`` in one world."""
    return {"serve": tp_serve(rank, world, tmp, data, model, cases),
            "train": tp_train(rank, world, tmp, data, model, cases, steps)}


# --------------------------------------------------------------------------
# test_torch_kv_seq.py: the KV cache split over its sequence
# --------------------------------------------------------------------------
def kv_seq_serve(rank, world, tmp, data, model, cases):
    """Each case ({arch, over, params (numpy tree), tokens, max_len,
    steps}) served on a (data, model) mesh under the serving cells' rules
    (``launch.specs.cell_rules``: the KV cache over its sequence where
    the kv heads do not divide "model"), through ``init_cache(mesh=,
    rules=)``, ``prefill`` and ``decode_step``: this rank's prefill
    logits and cache leaves, which caches are split over their slots,
    then ``steps`` greedy steps' tokens (its rows, global ids) and
    logits and the cache after them.  Returns every rank's results."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.specs import cell_rules
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.attention import KVSeqShard
    from repro_torch.sharding import make_tp_mesh, tp, use_rules

    mesh = make_tp_mesh(data, model)
    out = []
    for case in cases:
        cfg = _tp_cfg(case)
        rules = cell_rules(cfg, ShapeConfig("decode", "decode", 1, 1), mesh)
        params = params_from_numpy(case["params"], "cpu", cfg, mesh)
        toks = torch.from_numpy(case["tokens"])
        rows = tp.data_rows(toks.shape[0], mesh)
        cache = init_cache(cfg, rows.stop - rows.start, case["max_len"],
                           device="cpu", mesh=mesh, rules=rules)
        res = {"coord": (mesh.get_local_rank("data"),
                         mesh.get_local_rank("model")),
               "seq_split": sorted(
                   n.rsplit("/", 1)[0] for n, _ in walk(cache)
                   if n.endswith("/k") and isinstance(
                       _at_path(cache, n.rsplit("/", 1)[0]), KVSeqShard))}
        with torch.no_grad(), use_rules(mesh, rules):
            logits, cache = prefill(cfg, params, {"tokens": toks[rows]},
                                    cache)
            res["cache_prefill"] = {n: t.numpy().copy()
                                    for n, t in walk(cache)}
            res["logits"], res["tokens"] = [logits.numpy().copy()], []
            for _ in range(case["steps"]):
                tok = tp.argmax(logits, cfg.padded_vocab)[:, None].to(
                    torch.int32)
                res["tokens"].append(tok.numpy().copy())
                logits, cache = decode_step(cfg, params, cache, tok)
                res["logits"].append(logits.numpy().copy())
        res["cache"] = {n: t.numpy().copy() for n, t in walk(cache)}
        out.append(res)
    return _gathered(out)


def _at_path(tree, name):
    """The node of a dict / list / NamedTuple tree at a "/"-joined path."""
    for k in name.split("/"):
        if isinstance(tree, dict):
            tree = tree[k]
        elif isinstance(tree, list):
            tree = tree[int(k)]
        else:
            tree = getattr(tree, k)
    return tree
