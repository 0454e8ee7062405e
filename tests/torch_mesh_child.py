"""Rank processes of the port's multi-rank CPU tests, and the models they
share with the JAX side of those tests.

The builders take the package as an argument (``paddle_tpu`` in the test
process, ``paddle_tpu_torch`` in a rank), so both packages build one
program, name for name.  This module imports no jax: the ranks run it.

A rank is started by ``paddle_tpu_torch.distributed.launch`` as

    python tests/torch_mesh_child.py OUT_DIR

and runs the scenarios ``OUT_DIR/plan.json`` lists, in order, over a gloo
group of the launcher's ranks (one CPU thread each).  Each scenario writes
``rank<r>_<name>.json`` into ``OUT_DIR``; a failing scenario writes its
traceback there instead and the rank exits 1.  ``launch_ranks`` (used by
the tests) starts the ranks on free ports, each within a timeout.
"""
import json
import os
import socket
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 240  # a rank's time limit

# the small transformer LM of tests/test_sharded_training.py
LM = dict(seq=16, d_model=32, vocab=128, batch=4, n_layer=1, n_head=4, d_inner=64)
# the hybrid engine's widths in tests/test_hybrid_parallel.py
HYBRID = dict(vocab_size=64, d_model=16, n_head=4, d_ff=32, n_layers=4, n_experts=4, seq_len=16,
              batch=8, microbatches=2)
# test_hybrid_engine_adam_parity's Adam: beta1, beta2, epsilon, learning rate, L2 decay
HYBRID_ADAM = dict(b1=0.9, b2=0.999, eps=1e-3, lr=0.01, decay=0.02)
# the BN model of tests/test_parallel_executor.py's batch-norm test
BN = dict(B=16, C=4, H=3, W=3)
BN_STEPS = 3  # SGD steps of the compiled data-parallel BN run


def build_mlp(fluid, seed):
    """tests/test_parallel_executor.py's MLP under SGD 0.1."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return prog, startup, loss


def mlp_batches(steps=5, batch=32):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(steps):
        xb = rng.uniform(-1, 1, (batch, 16)).astype("float32")
        out.append({"x": xb, "y": (xb.sum(axis=1, keepdims=True) * 0.5).astype("float32")})
    return out


def build_lm(fluid, models, n_layer=LM["n_layer"]):
    """The LM of tests/test_sharded_training.py under Adam 1e-3."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 23
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [LM["seq"]], dtype="int64")
        lbl = fluid.layers.data("lbl", [LM["seq"], 1], dtype="int64")
        loss, logits = models.transformer_lm(
            ids, lbl, vocab_size=LM["vocab"], d_model=LM["d_model"], n_layer=n_layer,
            n_head=LM["n_head"], d_inner=LM["d_inner"], seq_len=LM["seq"], max_pos=64)
        opt = fluid.optimizer.AdamOptimizer(1e-3)
        opt.minimize(loss)
    return {"prog": prog, "startup": startup, "loss": loss, "logits": logits, "opt": opt}


def lm_batches(n, start=0):
    out = []
    for i in range(start, n):
        rng = np.random.RandomState(500 + i)  # keyed by the global step
        out.append({"src_ids": rng.randint(1, LM["vocab"], (LM["batch"], LM["seq"])).astype(np.int64),
                    "lbl": rng.randint(0, LM["vocab"], (LM["batch"], LM["seq"], 1)).astype(np.int64)})
    return out


def build_bn(fluid, sync):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 19
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [BN["C"], BN["H"], BN["W"]])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.batch_norm(x, act="relu", sync=sync)
        pool = fluid.layers.pool2d(h, pool_type="avg", global_pooling=True)
        pred = fluid.layers.fc(pool, 1, name="bn_head")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return prog, startup, loss


def bn_batch():
    rng = np.random.RandomState(6)
    xb = (rng.randn(BN["B"], BN["C"], BN["H"], BN["W"])
          * np.arange(1, BN["C"] + 1).reshape(1, BN["C"], 1, 1)).astype("float32")
    return {"x": xb, "y": rng.randn(BN["B"], 1).astype("float32")}


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------
def _free_ports(n):
    for _ in range(100):
        socks = []
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            port = s.getsockname()[1]
            for k in range(1, n):
                s = socket.socket()
                s.bind(("127.0.0.1", port + k))
                socks.append(s)
            return port
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no %d consecutive free ports" % n)


def launch_ranks(out_dir, n, scenarios, **plan):
    """Start ``n`` ranks through the port's launcher on ``scenarios`` (each
    a name and its arguments); wait for each within CHILD_S and return
    ``{scenario name: [rank 0's result, rank 1's, ...]}``."""
    from paddle_tpu_torch.distributed import launch

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "plan.json"), "w") as f:
        json.dump(dict(plan, scenarios=scenarios), f)
    args = launch._parse_args(["--nproc_per_node=%d" % n, "--started_port=%d" % _free_ports(n),
                               "--log_dir=%s" % os.path.join(out_dir, "logs"),
                               os.path.abspath(__file__), out_dir])
    # the ranks inherit the environment: the repo on their path, one thread each
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    try:
        procs = launch.start_procs(args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        for p in procs:
            p.wait(timeout=CHILD_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {}
    for r in range(n):
        try:
            with open(os.path.join(out_dir, "logs", "workerlog.%d" % r)) as f:
                logs[r] = f.read()[-4000:]
        except OSError:
            logs[r] = ""
    assert [p.returncode for p in procs] == [0] * n, logs
    out = {}
    for name, _ in scenarios:
        out[name] = []
        for r in range(n):
            with open(os.path.join(out_dir, "rank%d_%s.json" % (r, name))) as f:
                out[name].append(json.load(f))
    return out


# ---------------------------------------------------------------------------
# scenarios (in a rank)
# ---------------------------------------------------------------------------
def _state(fluid, scope, path):
    """The JAX package's startup state (an .npz the test wrote) into scope."""
    fluid.io.set_params_from_numpy(scope, dict(np.load(path)), "cpu")


def scenario_dp_mlp(ctx, state):
    fluid = ctx["fluid"]
    prog, startup, loss = build_mlp(fluid, seed=5)
    compiled = fluid.CompiledProgram(prog).with_data_parallel(loss_name=loss.name)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    _state(fluid, scope, state)
    losses = []
    for i, f in enumerate(mlp_batches()):
        losses.append(float(exe.run(compiled, feed=f, fetch_list=[loss], scope=scope)[0]))
        if i == 0:
            misses = exe.jit_cache_stats()["misses"]
    misses = exe.jit_cache_stats()["misses"] - misses
    plan, _ = compiled._plan(exe, ("x", "y"), (loss.name,))
    # a batch that does not divide dp is typed
    bad = {k: v[:ctx["world"] + 1] for k, v in mlp_batches(1)[0].items()}
    try:
        exe.run(compiled, feed=bad, fetch_list=[loss], scope=scope)
        uneven = None
    except ValueError as e:
        uneven = str(e)
    # a per-row fetch comes back whole: the global batch's predictions
    pred_name = [op.outputs["Out"][0] for op in prog.global_block().ops
                 if op.type == "elementwise_add"][-1]
    rows = exe.run(compiled, feed=mlp_batches(1)[0], fetch_list=[pred_name], scope=scope)[0]
    return {"losses": losses, "eager_ops": list(plan.eager_ops), "uneven": uneven,
            "rows_shape": list(rows.shape), "misses_after_first": misses}


def scenario_tp_specs(ctx, state):
    fluid = ctx["fluid"]
    prog, startup, loss = build_mlp(fluid, seed=9)
    wname = [p.name for p in prog.all_parameters() if tuple(p.shape) == (16, 32)][0]
    strat = fluid.DistributedStrategy()
    strat.mesh_axes = {"dp": 2, "tp": 2}
    strat.sharding_specs = {wname: (None, "tp")}
    compiled = fluid.CompiledProgram(prog).with_strategy(strat)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    _state(fluid, scope, state)
    losses = [float(exe.run(compiled, feed=f, fetch_list=[loss], scope=scope)[0])
              for f in mlp_batches()]
    return {"losses": losses, "w_shard": list(scope.vars[wname].shape)}


def scenario_lm(ctx, state, mode, mesh_axes, steps, ckpt_dir=None, save_at=()):
    """The LM trained ``steps`` steps under ``canonical_rules(mode)``; with
    ``ckpt_dir`` a shard-wise checkpoint after each step in ``save_at``."""
    from paddle_tpu_torch import models, monitor, sharding
    from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint
    from paddle_tpu_torch.sharding.rules import MeshCommittedStateError

    fluid = ctx["fluid"]
    lm = build_lm(fluid, models)
    compiled = sharding.sharded_train_program(
        lm["prog"], sharding.transformer_lm_rules(mode), optimizer=lm["opt"],
        mesh_axes=mesh_axes)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(lm["startup"], scope=scope)
    _state(fluid, scope, state)
    losses, misses = [], None
    ck = TrainCheckpoint(ckpt_dir, keep=3) if ckpt_dir else None
    for i, feed in enumerate(lm_batches(steps)):
        losses.append(float(exe.run(compiled, feed=feed, fetch_list=[lm["loss"]], scope=scope)[0]))
        if i == 0:
            misses = exe.jit_cache_stats()["misses"]
        if ck is not None and i + 1 in save_at:
            ck.save(lm["prog"], scope, i + 1, compiled=compiled)
    acc = lm["opt"].accumulator_map()
    m1 = next(a for a, (p, k) in acc.items() if p == "lm_word_emb" and k == "moment1")
    params = {p.name for p in lm["prog"].global_block().all_parameters()}
    names = params | set(acc)
    bytes_rank = sum(scope.vars[n].numel() * 4 for n in names)
    gauges = {k: monitor.counter_value("sharding_train_state_bytes", default=-1.0, kind=k)
              for k in ("param", "grad", "moment")}
    emb_shard, m1_shard = list(scope.vars["lm_word_emb"].shape), list(scope.vars[m1].shape)
    # an uncompiled run over the shards is typed; opted in, it gathers them once
    try:
        exe.run(lm["prog"], feed=lm_batches(1)[0], fetch_list=[lm["loss"]], scope=scope)
        committed = None
    except MeshCommittedStateError as e:
        committed = str(e)
    regather = fluid.Executor(fluid.CPUPlace(), reshard_on_gather=True)
    whole = regather.run(lm["prog"], feed=lm_batches(steps + 1)[steps], fetch_list=[lm["loss"]],
                         scope=scope)[0]
    return {"losses": losses, "misses_after_first": exe.jit_cache_stats()["misses"] - misses,
            "bytes": int(bytes_rank), "emb_shard": emb_shard, "m1_shard": m1_shard,
            "gauges": gauges, "committed": committed,
            "uncompiled_after_gather": float(whole),
            "emb_after_gather": list(scope.vars["lm_word_emb"].shape)}


def scenario_lm_restore(ctx, state, mode, mesh_axes, run_dir, steps):
    """A fresh scope restored from ``run_dir``'s newest checkpoint, trained
    on to ``steps``."""
    from paddle_tpu_torch import models, sharding
    from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint

    fluid = ctx["fluid"]
    lm = build_lm(fluid, models)
    compiled = sharding.sharded_train_program(
        lm["prog"], sharding.transformer_lm_rules(mode), optimizer=lm["opt"],
        mesh_axes=mesh_axes)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(lm["startup"], scope=scope)
    _state(fluid, scope, state)
    ck = TrainCheckpoint(run_dir, keep=3)
    cursor = ck.restore(lm["prog"], scope, compiled=compiled)
    losses = [float(exe.run(compiled, feed=f, fetch_list=[lm["loss"]], scope=scope)[0])
              for f in lm_batches(steps, cursor["step"])]
    return {"step": cursor["step"], "losses": losses, "stats": ck.last_restore_stats}


def scenario_bn(ctx, state_sync, state_local, state_dp):
    """BN statistics across ranks: the JAX test's shard_map run (sync_bn
    and not) on this rank's slice, and the compiled data-parallel step."""
    import torch

    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.parallel import mesh as mesh_lib
    from paddle_tpu_torch.sharding import PartitionSpec as P

    fluid = ctx["fluid"]
    batch = bn_batch()
    out = {}
    mesh = mesh_lib.make_mesh({"dp": ctx["world"]})
    penv.set_ring_axis(0, "dp")
    for key, sync, path in (("sync", True, state_sync), ("local", False, state_local)):
        prog, startup, loss = build_bn(fluid, sync)
        persist = {n: torch.from_numpy(a) for n, a in np.load(path).items()}
        fn = lowering.lower_block(prog.global_block(), ["x", "y"], [loss.name], [],
                                  torch.device("cpu"))

        def step(st, xs, ys, fn=fn):
            fetches, _ = fn(dict(st), {"x": torch.as_tensor(xs), "y": torch.as_tensor(ys)})
            return mesh_lib.pmean(fetches[0], "dp")

        sharded = mesh_lib.shard_map(step, mesh=mesh, in_specs=(P(), P("dp"), P("dp")),
                                     out_specs=P(), check_vma=False)
        with torch.no_grad():
            out[key] = float(sharded(persist, batch["x"], batch["y"]).reshape(-1)[0])
    prog, startup, loss = build_bn(fluid, False)
    compiled = fluid.CompiledProgram(prog).with_data_parallel(loss_name=loss.name)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    _state(fluid, scope, state_dp)
    out["compiled_dp"] = [float(exe.run(compiled, feed=batch, fetch_list=[loss], scope=scope)[0])
                          for _ in range(BN_STEPS)]
    return out


def scenario_serve(ctx, model_dir, ids, precisions=(None,)):
    """The rank's predictor of a saved model: its answers (one a
    precision), placements and stats."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor

    before = monitor.counter_value("sharding_params_sharded_total", default=0.0)
    cfg = AnalysisConfig(model_dir)
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    outs = [np.asarray(pred.run({"src_ids": np.asarray(ids, np.int64)}, precision=p)[0]).tolist()
            for p in precisions]
    placements = pred.param_placements()
    return {"sharded": pred.sharded, "out": outs[0], "outs": outs,
            "placements": {n: {k: (list(v) if isinstance(v, tuple) else v)
                               for k, v in p.items()} for n, p in placements.items()},
            "stats": pred.sharding_stats(group="tp_lm"),
            "params_sharded": monitor.counter_value("sharding_params_sharded_total",
                                                    default=0.0) - before,
            "group_gauge": monitor.counter_value("sharding_group_hbm_bytes", default=-1.0,
                                                 group="tp_lm")}


def scenario_sp_serve(ctx, model_dir, feeds, storm=()):
    """The rank's predictor of an ``sp`` export: its answer to each feed
    (each a dict of name -> rows), its stats, the misses of a storm of
    ``storm`` (indices into ``feeds``) after one run of each, and the ring's
    counters."""
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.parallel.ring_attention import reset_ring_stats, ring_stats

    cfg = AnalysisConfig(model_dir)
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    reset_ring_stats()
    feeds = [{n: np.asarray(v) for n, v in f.items()} for f in feeds]
    outs = [np.asarray(pred.run(f)[0]).tolist() for f in feeds]
    misses = pred.jit_cache_stats()["misses"]
    for i in storm:
        pred.run(feeds[i])
    return {"sharded": pred.sharded, "outs": outs, "stats": pred.sharding_stats(group="sp_lm"),
            "storm_misses": pred.jit_cache_stats()["misses"] - misses,
            "ring": ring_stats()}


def scenario_ring(ctx, q, k, v, causal, scale):
    """``parallel.ring_attention`` on this rank's window of the full
    [B, H, S, D] q/k/v (rank r holds tokens [r S/n, (r+1) S/n))."""
    import torch

    from paddle_tpu_torch.parallel import mesh as mesh_lib
    from paddle_tpu_torch.parallel.ring_attention import reset_ring_stats, ring_attention, ring_stats

    mesh = mesh_lib.make_mesh({"sp": ctx["world"]})
    group, _ = mesh.group(("sp",))
    r, n = ctx["rank"], ctx["world"]
    win = [torch.as_tensor(np.asarray(t, np.float32)).chunk(n, dim=2)[r].contiguous()
           for t in (q, k, v)]
    reset_ring_stats()
    out = ring_attention(*win, group, causal=causal, scale=scale)
    return {"out": out.numpy().tolist(), "ring": ring_stats()}


def hybrid_tokens(seed, cfg):
    """tests/test_hybrid_parallel.py's tokens and labels for a seed (int64)."""
    rng = np.random.RandomState(seed + 1)
    tokens = rng.randint(0, cfg.vocab_size, (cfg.batch, cfg.seq_len)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (cfg.batch, cfg.seq_len)).astype(np.int64)
    return tokens, labels


def hybrid_adam(fluid):
    a = HYBRID_ADAM
    return fluid.optimizer.AdamOptimizer(
        learning_rate=a["lr"], beta1=a["b1"], beta2=a["b2"], epsilon=a["eps"],
        regularization=fluid.regularizer.L2DecayRegularizer(a["decay"]))


def scenario_hybrid(ctx, axes, seed=0, ring=True, steps=1, adam=False, via_fleet=False):
    """The hybrid engine's step on this rank's shards over ``axes``: one
    SGD step at lr 0.1, or ``steps`` Adam steps (``hybrid_adam``, the
    engine built directly or through ``fleet``); the losses, each step's
    ring counters, and (rank 0) every parameter gathered whole."""
    from paddle_tpu_torch.parallel import hybrid
    from paddle_tpu_torch.parallel import mesh as mesh_lib
    from paddle_tpu_torch.parallel.ring_attention import reset_ring_stats, ring_stats

    fluid = ctx["fluid"]
    cfg = hybrid.HybridConfig(lr=0.1, ring_attention=ring, **HYBRID, **axes)
    mesh = mesh_lib.make_mesh(cfg.mesh_axes(), backend="cpu")
    tokens, labels = hybrid_tokens(seed, cfg)
    if via_fleet:
        strat = fluid.DistributedStrategy()
        strat.hybrid = dict(HYBRID, **axes)
        step, helpers = fluid.parallel.fleet.distributed_optimizer(
            hybrid_adam(fluid), strat).build_hybrid_train_step(mesh=mesh)
        params = helpers.init_params(seed=seed)
        p, tok, lab = helpers.place(params, tokens, labels)
        aux = helpers.place_aux(helpers.init_opt_state(params))
    elif adam:
        opt = hybrid_adam(fluid)
        step, place, _ = hybrid.make_train_step(cfg, mesh, optimizer=opt)
        params = hybrid.init_params(cfg, seed=seed)
        p, tok, lab = place(params, tokens, labels)
        aux = step.place_aux(hybrid.init_opt_state(cfg, params, opt))
    else:
        step, place, _ = hybrid.make_train_step(cfg, mesh)
        p, tok, lab = place(hybrid.init_params(cfg, seed=seed), tokens, labels)
    shard_shapes = {n: list(t.shape) for n, t in p.items()}
    losses, rings = [], []
    for _ in range(steps):
        reset_ring_stats()
        if adam or via_fleet:
            loss, p, aux = step(p, aux, tok, lab)
        else:
            loss, p = step(p, tok, lab)
        losses.append(float(loss))
        rings.append(ring_stats())
    full = hybrid.gather(cfg, mesh, p)
    res = {"losses": losses, "ring": rings, "coords": mesh.coords, "shard_shapes": shard_shapes}
    if ctx["rank"] == 0:
        res["params"] = {n: a.tolist() for n, a in full.items()}
    return res


def scenario_ring_grad(ctx, q, k, v, d_out, causal, scale):
    """``parallel.ring_attention``'s gradient on this rank's window of the
    full [B, H, S, D] q/k/v, the upstream gradient d_out's window."""
    import torch

    from paddle_tpu_torch.parallel import mesh as mesh_lib
    from paddle_tpu_torch.parallel.ring_attention import reset_ring_stats, ring_attention, ring_stats

    mesh = mesh_lib.make_mesh({"sp": ctx["world"]}, backend="cpu")
    group, _ = mesh.group(("sp",))
    r, n = ctx["rank"], ctx["world"]
    win = [torch.as_tensor(np.asarray(t, np.float32)).chunk(n, dim=2)[r].contiguous()
           for t in (q, k, v, d_out)]
    leaves = [t.requires_grad_(True) for t in win[:3]]
    reset_ring_stats()
    out = ring_attention(*leaves, group, causal=causal, scale=scale)
    dq, dk, dv = torch.autograd.grad(out, leaves, win[3])
    return {"dq": dq.numpy().tolist(), "dk": dk.numpy().tolist(), "dv": dv.numpy().tolist(),
            "ring": ring_stats()}


SCENARIOS = {"dp_mlp": scenario_dp_mlp, "tp_specs": scenario_tp_specs, "lm": scenario_lm,
             "lm_restore": scenario_lm_restore, "bn": scenario_bn, "serve": scenario_serve,
             "sp_serve": scenario_sp_serve, "ring": scenario_ring, "hybrid": scenario_hybrid,
             "ring_grad": scenario_ring_grad}


def main(out_dir):
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import env as penv

    penv.init_from_env(backend="gloo", timeout_s=CHILD_S)
    rank, world = int(os.environ["PADDLE_TRAINER_ID"]), int(os.environ["PADDLE_TRAINERS_NUM"])
    with open(os.path.join(out_dir, "plan.json")) as f:
        plan = json.load(f)
    ctx = {"fluid": fluid, "rank": rank, "world": world}
    for name, kwargs in plan["scenarios"]:
        kind = name.split(":")[0]
        try:
            res = SCENARIOS[kind](ctx, **kwargs)
        except BaseException:
            with open(os.path.join(out_dir, "rank%d_%s.json" % (rank, name)), "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            traceback.print_exc()
            return 1
        with open(os.path.join(out_dir, "rank%d_%s.json" % (rank, name)), "w") as f:
            json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
