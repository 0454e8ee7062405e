"""``Executor.run`` of paddle_tpu_torch against paddle_tpu's: multi-step
runs (``steps=``, ``per_step_feed``), the run-plan and entry caches and
their counters (``jit_cache_stats``), and the predictor's view of them.

On the CPU an entry runs the block interpreter ``steps`` times, so
``steps=N`` must give the same bits as N single runs (the arithmetic is
the same, in the same order).  The cache counters are integers and must
equal the JAX executor's on the same sequence of runs.  The captured
CUDA-graph steps are held on the card (``tests/test_torch_cuda.py``).

Small size: an MLP of 16 inputs, a hidden fc of 32 with tanh, 4
classes (the port's own ops), and the small BERT encoder served through
``InferenceServer``; inputs made from a seed with numpy.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.scope import to_numpy

PACKAGES = {"jax": jfluid, "torch": tfluid}
STAT_KEYS = ("entries", "hits", "misses", "jit_evictions", "plan_entries", "plan_hits",
             "plan_misses", "plan_evictions", "ps_pull_overlap_s", "ps_pull_wait_s")


def build_mlp(pkg, opt="adam", seed=7):
    fluid = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="tanh")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        optimizer = (fluid.optimizer.AdamOptimizer(0.05) if opt == "adam"
                     else fluid.optimizer.SGDOptimizer(0.1))
        optimizer.minimize(loss)
    return main, startup, loss


def batches(n, rows=8, seed=1):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, rows, 16).astype("float32")
    ys = rng.randint(0, 4, (n, rows, 1)).astype("int64")
    return xs, ys


def _params(main, scope):
    return {p.name: to_numpy(scope.get(p.name)) for p in main.all_parameters()}


# ---------------------------------------------------------------------------
# steps= and per_step_feed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_steps_equal_single_runs(opt):
    main, startup, loss = build_mlp("torch", opt)
    exe = tfluid.Executor(tfluid.CPUPlace())
    xs, ys = batches(1)
    feed = {"x": xs[0], "y": ys[0]}
    scope_a = tfluid.Scope()
    exe.run(startup, scope=scope_a)
    for _ in range(4):
        la, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope_a)
    scope_b = tfluid.Scope()
    exe.run(startup, scope=scope_b)
    lb, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope_b, steps=4)
    np.testing.assert_array_equal(lb, la)
    pa, pb = _params(main, scope_a), _params(main, scope_b)
    for n in pa:
        np.testing.assert_array_equal(pb[n], pa[n], err_msg=n)
    # the optimizer state moved on four times too
    for n, v in scope_a.vars.items():
        np.testing.assert_array_equal(to_numpy(scope_b.vars[n]), to_numpy(v), err_msg=n)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_per_step_feed_equal_single_runs(opt):
    main, startup, loss = build_mlp("torch", opt)
    exe = tfluid.Executor(tfluid.CPUPlace())
    xs, ys = batches(5)
    scope_a = tfluid.Scope()
    exe.run(startup, scope=scope_a)
    for i in range(5):
        la, = exe.run(main, feed={"x": xs[i], "y": ys[i]}, fetch_list=[loss], scope=scope_a)
    scope_b = tfluid.Scope()
    exe.run(startup, scope=scope_b)
    lb, = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss], scope=scope_b,
                  steps=5, per_step_feed=True)
    np.testing.assert_array_equal(lb, la)
    pa, pb = _params(main, scope_a), _params(main, scope_b)
    for n in pa:
        np.testing.assert_array_equal(pb[n], pa[n], err_msg=n)


def test_per_step_feed_one_step_reads_slice_zero():
    main, startup, loss = build_mlp("torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    xs, ys = batches(1)
    scope_a, scope_b = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=scope_a)
    exe.run(startup, scope=scope_b)
    la, = exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss], scope=scope_a)
    lb, = exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss], scope=scope_b,
                  per_step_feed=True)
    np.testing.assert_array_equal(lb, la)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_wrong_leading_axis_raises(pkg):
    fluid = PACKAGES[pkg]
    main, startup, loss = build_mlp(pkg)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xs, ys = batches(5)
    with pytest.raises(ValueError, match="leading"):
        exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss], scope=scope,
                steps=5, per_step_feed=True)
    with pytest.raises(ValueError, match="leading"):
        exe.run(main, feed={"x": xs[:4], "y": ys}, fetch_list=[loss], scope=scope,
                steps=5, per_step_feed=True)


def test_steps_below_one_raise():
    main, startup, loss = build_mlp("torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xs, ys = batches(1)
    with pytest.raises(ValueError, match="steps"):
        exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss], scope=scope, steps=0)


def test_interpreter_keeps_only_live_values():
    """After a block has run, its env holds the fetches and the state the
    executor stores back, and nothing else: every other value was dropped
    after the last op that reads or writes it."""
    import torch

    from paddle_tpu_torch.core import lowering

    main, startup, loss = build_mlp("torch")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    block = main.global_block()
    state_out = {n for op in block.ops if op.type == "adam" for n in op.output_arg_names}
    keep = {loss.name} | state_out
    xs, ys = batches(1)
    env = dict(scope.vars)
    env.update({"x": torch.from_numpy(xs[0]), "y": torch.from_numpy(ys[0])})
    lowering.trace_ops(block.ops, env, torch.device("cpu"), block,
                       lowering._dead_after(block.ops, keep))
    assert set(env) == keep


# ---------------------------------------------------------------------------
# the caches' counters against the JAX executor's
# ---------------------------------------------------------------------------
def _stats(exe):
    s = exe.jit_cache_stats()
    return {k: s[k] for k in STAT_KEYS}


def _run_sequence(pkg):
    """The same runs in either package, with both caches at capacity 2;
    the counters after each run."""
    fluid = PACKAGES[pkg]
    main, startup, loss = build_mlp(pkg)
    exe = fluid.Executor(fluid.CPUPlace(), plan_cache_capacity=2, jit_cache_capacity=2)
    scope = fluid.Scope()
    xs, ys = batches(2)
    feed8 = {"x": xs[0], "y": ys[0]}
    feed3 = {"x": xs[1][:3], "y": ys[1][:3]}
    out = []

    def run(prog=main, feed=feed8, fetch=(loss,), **kw):
        res = exe.run(prog, feed=feed, fetch_list=list(fetch), scope=scope, **kw)
        out.append(_stats(exe))
        return res

    run(startup, feed=None, fetch=())          # startup: plan and entry miss
    run()                                      # main: misses
    run()                                      # plan hit, entry hit
    run(feed=feed3)                            # new feed shape: plan hit, entry miss (evicts)
    run()                                      # the first shape again: evicted, so a miss
    main.version += 1
    run()                                      # version bump: plan miss
    with fluid.program_guard(main, startup):
        doubled = fluid.layers.scale(loss, scale=2.0)
    run()                                      # an op appended without a bump: plan miss
    run(fetch=(loss, doubled))                 # another fetch list: plan miss
    run(fetch=(loss, doubled))                 # hits
    run(use_program_cache=False)               # no cache: a plan miss and a miss, nothing kept
    run(feed={"x": xs, "y": ys}, steps=2, per_step_feed=True)  # its own plan key
    return out, exe


def test_cache_counters_match_jax_executor():
    jout, _ = _run_sequence("jax")
    tout, texe = _run_sequence("torch")
    assert len(tout) == len(jout)
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t == j, (i, t, j)
    last = tout[-1]
    assert last["jit_evictions"] > 0 and last["plan_evictions"] > 0
    assert last["entries"] == last["plan_entries"] == 2
    full = texe.jit_cache_stats()
    assert full["dispatch_overhead_s"] > 0.0
    assert full["graphs"] == full["graph_pool_bytes"] == 0  # no graph on the CPU
    texe.close()
    assert texe.jit_cache_stats()["entries"] == texe.jit_cache_stats()["plan_entries"] == 0


def test_predictor_stats_after_serving_warmup(tmp_path):
    """The served buckets: one entry a rung from the warm-up, and no new
    entry under traffic (the JAX package's zero-recompiles rule)."""
    from paddle_tpu_torch.models import transformer

    seq = 16
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("src_ids", [seq], dtype="int64")
        mask = tfluid.layers.data("input_mask", [seq])
        enc = transformer.bert_encoder(ids, mask, vocab_size=97, d_model=64, n_layer=2,
                                       n_head=4, d_inner=128, max_pos=32, seq_len=seq,
                                       dropout_rate=0.0, is_test=True, fused_attention=True)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), ["src_ids", "input_mask"], [enc], exe,
                                   main_program=main, scope=scope)
    cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    pred = tfluid.inference.create_paddle_predictor(cfg)
    server = tfluid.serving.InferenceServer(pred, max_batch_size=8)
    try:
        rungs = server.warmup()
        after_warmup = pred.jit_cache_stats()
        assert after_warmup["misses"] == after_warmup["entries"] == rungs
        client = tfluid.serving.Client(server)
        rng = np.random.RandomState(3)
        for rows in (1, 3, 8, 5):
            out, = client.infer({"src_ids": rng.randint(0, 97, (rows, seq)),
                                 "input_mask": np.ones((rows, seq), "float32")})
            assert out.shape == (rows, seq, 64)
    finally:
        server.stop()
    stats = pred.jit_cache_stats()
    assert stats["misses"] == rungs
    assert stats["hits"] >= 4


def test_threads_share_the_caches():
    """Four threads run one executor at once, each its own scope and batch
    size (two share a feed signature): every answer is bit-equal to the
    same runs made on one thread, and the counters add up (each run is a
    hit or a miss, one miss per plan and feed signature)."""
    import threading

    main, startup, loss = build_mlp("torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    xs, ys = batches(5, rows=8)
    rows = [8, 4, 8, 2]

    def losses(scope, r):
        return [exe.run(main, feed={"x": xs[i][:r], "y": ys[i][:r]}, fetch_list=[loss],
                        scope=scope)[0] for i in range(5)]

    ref = []
    for r in rows:
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        ref.append(losses(scope, r))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scopes = [tfluid.Scope() for _ in rows]
    for scope in scopes:
        exe.run(startup, scope=scope)
    got = [None] * len(rows)

    def worker(i):
        got[i] = losses(scopes[i], rows[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.array(g), np.array(r))
    stats = exe.jit_cache_stats()
    assert stats["hits"] + stats["misses"] == 4 + 4 * 5
    assert stats["misses"] == 1 + 3  # the startup program, then one entry a batch size


# ---------------------------------------------------------------------------
# fetched tensors are the caller's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fetched_persistable_does_not_change_after_later_runs(pkg):
    """A parameter fetched with ``return_numpy=False`` keeps its value
    while later runs update the parameter, as the JAX executor's immutable
    arrays do.  (On a card the later runs capture and replay a graph over
    the scope's tensors: ``tests/test_torch_cuda.py`` holds it there.)"""
    fluid = PACKAGES[pkg]
    main, startup, loss = build_mlp(pkg, "sgd")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    xs, ys = batches(3)
    w = main.all_parameters()[0].name
    got, = exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[w], scope=scope,
                   return_numpy=False)
    first = np.array(got)
    for i in (1, 2):
        exe.run(main, feed={"x": xs[i], "y": ys[i]}, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(np.array(got), first)
    assert not np.array_equal(np.array(scope.get(w)), first)  # the parameter itself moved on
