"""The parameter server of paddle_tpu_torch against paddle_tpu:
``distributed/ps.py`` (the wire format and the servers),
``distributed/lookup.py``, ``distributed/communicator.py``
(``Communicator`` and ``GeoSGD``) and the executor's sparse prefetch and
push, as tests/test_distributed.py and tests/test_sparse_scaleout.py hold
the JAX package's.  Servers run in-process on 127.0.0.1.

* Wire format: a JAX-package client drives a port server and a port
  client drives a JAX-package server, bfloat16 payloads included, with
  the same answers (exact); the port decodes bfloat16 without
  ``ml_dtypes`` (its bits shifted into float32, exact).
* PS against dense: the same model with its table on two servers (zero
  rows, server-side SGD 0.1) and in HBM (zero table, SGD 0.1), from the
  JAX package's saved head: the port's PS losses within rtol 2e-4 (atol
  1e-6) of the JAX package's dense run and of the port's own dense run,
  as the JAX test holds its two; the JAX package's PS run within the
  same of the port's.
* Padding (the pad position exactly zero after training) and two lookup
  sites tied to one server table.
* The async Communicator converges as the sync push does, retries a
  flaky client and requeues a failed batch; GeoSGD with two trainers
  reaches the JAX test's bound; the overlapped prefetch of
  ``train_from_dataset`` hides pull time, shares the inline path's plan
  and entry (``jit_cache_stats``) and leaves the caller's dicts alone.
"""
import inspect
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.communicator import Communicator, GeoSGD
from paddle_tpu_torch.executor import Executor, pow2_id_bucket
from paddle_tpu_torch.scope import to_numpy

PKG = {"jax": jfluid, "torch": tfluid}


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------
def test_port_decodes_bfloat16_without_ml_dtypes():
    src = inspect.getsource(tps)
    assert "ml_dtypes" not in src.replace("without ``ml_dtypes``", "")
    vals = np.random.RandomState(0).randn(7, 5).astype(np.float32).astype(ml_dtypes.bfloat16)
    msg = jps._encode_msg({"op": "push", "grads": vals, "ids": np.arange(7)})
    out = tps._decode_msg(msg)
    assert out["grads"].dtype == np.float32
    np.testing.assert_array_equal(out["grads"], vals.astype(np.float32))
    # a torch bfloat16 tensor encodes as a bfloat16 payload of its own bits
    t = torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)
    back = jps._decode_msg(tps._encode_msg({"v": t}))["v"]
    assert back.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.uint16), vals.view(np.uint16))


def test_wire_bytes_are_the_jax_packages():
    msg = {"op": "push", "table": "emb", "ids": np.arange(5, dtype=np.int64),
           "grads": np.random.RandomState(0).randn(5, 8).astype(np.float32),
           "nested": {"a": [1, 2.5, None, "s"], "flag": True}, "n": np.int64(3)}
    assert tps._encode_msg(msg) == jps._encode_msg(msg)
    for bad in (b"\xff\xff\xff\x7f corrupt", b""):
        with pytest.raises(ValueError):
            tps._decode_msg(bad)
    with pytest.raises(TypeError):
        tps._encode_msg({"bad": object()})


@pytest.mark.parametrize("client_pkg", ["jax", "torch"])
def test_client_and_server_across_packages(client_pkg):
    """Two server shards of one package, a client of the other: tables,
    pulls, pushes (float32 and bfloat16 gradients), assign, chunked save
    and the in-band error channel."""
    server_mod, client_mod = (tps, jps) if client_pkg == "jax" else (jps, tps)
    s1, s2 = server_mod.ParameterServer().start(), server_mod.ParameterServer().start()
    try:
        cli = client_mod.PSClient([s1.endpoint, s2.endpoint])
        cli.create_table("emb", 4, initializer="zeros", optimizer="sgd", lr=1.0)
        ids = np.arange(10, dtype=np.int64)
        np.testing.assert_array_equal(cli.pull_sparse("emb", ids), np.zeros((10, 4), np.float32))
        cli.push_sparse("emb", ids, -np.ones((10, 4), np.float32))
        g16 = np.full((10, 4), -0.5, np.float32)
        if client_pkg == "jax":
            g16 = g16.astype(ml_dtypes.bfloat16)
            cli._call(0, {"op": "push", "table": "emb", "ids": ids[ids % 2 == 0],
                          "grads": g16[ids % 2 == 0]})
        else:
            cli._call(0, {"op": "push", "table": "emb", "ids": ids[ids % 2 == 0],
                          "grads": torch.from_numpy(g16[ids % 2 == 0]).to(torch.bfloat16)})
        rows = cli.pull_sparse("emb", ids)
        want = np.where((ids % 2 == 0)[:, None], 1.5, 1.0).astype(np.float32) * np.ones((1, 4))
        np.testing.assert_array_equal(rows, want)
        cli.load_tables({"emb": (np.array([3], np.int64), np.full((1, 4), 7.0, np.float32))})
        saved = cli.save(chunk_rows=3)
        sids, srows = saved["emb"]
        order = np.argsort(sids)
        assert sids[order].tolist() == ids.tolist()
        np.testing.assert_array_equal(srows[order][3], np.full(4, 7.0, np.float32))
        with pytest.raises(RuntimeError, match="unknown PS op"):
            cli._call(0, {"op": "definitely_not_an_op"})
        assert cli._call(0, {"op": "stats"})["emb"] > 0
        cli.close()
    finally:
        s1.stop()
        s2.stop()


def test_parameter_server_sparse_training():
    """2-shard port PS: embedding rows converge on a learnable target."""
    s1, s2 = tps.ParameterServer().start(), tps.ParameterServer().start()
    try:
        client = tps.PSClient([s1.endpoint, s2.endpoint])
        client.create_table("emb", dim=4, optimizer="sgd", lr=0.5)
        rng = np.random.RandomState(0)
        target = rng.uniform(-1, 1, (50, 4)).astype("float32")
        losses = []
        for _ in range(30):
            ids = rng.randint(0, 50, 16)
            grad = client.pull_sparse("emb", ids) - target[ids]
            losses.append(float((grad ** 2).mean()))
            client.push_sparse("emb", ids, grad)
        assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
        assert s1._dispatch({"op": "stats"})["emb"] > 0 and s2._dispatch({"op": "stats"})["emb"] > 0
        client.close()
    finally:
        s1.stop()
        s2.stop()


# ---------------------------------------------------------------------------
# the executor's prefetch and push
# ---------------------------------------------------------------------------
def test_pow2_bucket_and_expand_ids():
    from paddle_tpu.executor import pow2_id_bucket as jbucket

    for n in (0, 1, 7, 8, 9, 100, 147_000, 262_144, 262_145):
        assert pow2_id_bucket(n) == jbucket(n)
    meta = {"squeeze_last": True}
    ids = np.array([[3], [3], [7], [9]], np.int64)
    uniq_p, n, counts, local = Executor._sparse_expand_ids(meta, ids)
    assert n == 3 and len(uniq_p) == 8 and counts.tolist() == [2, 1, 1]
    assert (uniq_p[3:] == uniq_p[0]).all() and local.shape == (4,) and local.dtype == np.int32
    assert len(Executor._sparse_expand_ids(meta, ids, ladder=[4, 12])[0]) == 4
    big = np.arange(20, dtype=np.int64).reshape(20, 1)
    assert len(Executor._sparse_expand_ids(meta, big, ladder=[4, 12])[0]) == 32
    # a [B, F] feed for a [F, 1] var keeps its shape; a CPU tensor works too
    local2 = Executor._sparse_expand_ids(meta, torch.tensor([[5, 6, 5], [6, 6, 1]]))[3]
    assert local2.tolist() == [[1, 2, 1], [2, 2, 0]]


def _emb_model(pkg, distributed, V=40, D=6, seed=21, optimizer="sgd", lr=0.1):
    fluid = PKG[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", [1], dtype="int64")
        y = fluid.layers.data("y", [1])
        if distributed:
            emb = fluid.layers.embedding(ids, [V, D], is_sparse=True, is_distributed=True,
                                         param_attr=fluid.ParamAttr(name="ctr_table"))
        else:
            emb = fluid.layers.embedding(ids, [V, D], param_attr=fluid.ParamAttr(
                name="dense_table", initializer=fluid.initializer.Constant(0.0)))
        pred = fluid.layers.fc(emb, 1, name="head")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = (fluid.optimizer.AdagradOptimizer(lr) if optimizer == "adagrad"
               else fluid.optimizer.SGDOptimizer(lr))
        opt.minimize(loss)
    return prog, startup, loss


def _feeds(V, B, n, seed=4):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, V, (B, 1)).astype("int64"),
             "y": rng.randn(B, 1).astype("float32")} for _ in range(n)]


def _jax_head(tmp_path, distributed=False, **kw):
    """The JAX package's startup of the model, saved: its head (and its
    optimizer state) is the state the runs below start from."""
    prog, startup, _ = _emb_model("jax", distributed, **kw)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / "jax_state")
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_persistables(exe, d, prog)
    return d


def _run(pkg, distributed, feeds, state_dir, endpoints=None, **bind):
    fluid = PKG[pkg]
    prog, _, loss = _emb_model(pkg, distributed)
    if distributed:
        fluid.distributed.bind_distributed_tables(prog, endpoints, optimizer="sgd", lr=0.1,
                                                  initializer="zeros", **bind)
    out = []
    if pkg == "jax":
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        with jfluid.scope_guard(scope):
            jfluid.io.load_persistables(exe, state_dir, prog)
            for f in feeds:
                out.append(float(np.asarray(exe.run(prog, feed=dict(f), fetch_list=[loss])[0])))
    else:
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        tfluid.io.load_persistables(exe, state_dir, prog, scope=scope)
        for f in feeds:
            out.append(float(exe.run(prog, feed=dict(f), fetch_list=[loss], scope=scope)[0]))
    return out, prog


def test_ps_embedding_parity_with_dense(tmp_path):
    d = _jax_head(tmp_path)
    feeds = _feeds(40, 16, 12)
    jax_dense, _ = _run("jax", False, feeds, d)
    port_dense, _ = _run("torch", False, feeds, d)
    runs = {}
    for pkg, mod in (("torch", tps), ("jax", jps)):
        s1, s2 = mod.ParameterServer().start(), mod.ParameterServer().start()
        try:
            runs[pkg], prog = _run(pkg, True, feeds, d, [s1.endpoint, s2.endpoint])
        finally:
            s1.stop()
            s2.stop()
    np.testing.assert_allclose(runs["torch"], jax_dense, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(runs["torch"], port_dense, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(runs["jax"], runs["torch"], rtol=2e-4, atol=1e-6)
    assert runs["torch"][-1] < runs["torch"][0]
    assert all(p.name != "ctr_table" for p in prog.all_parameters())


def test_ps_adagrad_matches_the_jax_package(tmp_path):
    """Server-side adagrad: the port's trainer and servers against the JAX
    package's on the same feeds and state."""
    d = _jax_head(tmp_path, distributed=True, optimizer="adagrad")
    feeds = _feeds(40, 16, 8, seed=5)
    runs = {}
    for pkg, mod in (("torch", tps), ("jax", jps)):
        s = mod.ParameterServer().start()
        try:
            fluid = PKG[pkg]
            prog, _, loss = _emb_model(pkg, True, optimizer="adagrad", lr=0.1)
            fluid.distributed.bind_distributed_tables(prog, [s.endpoint], optimizer="adagrad",
                                                      lr=0.1, initializer="zeros")
            runs[pkg] = _train_loop(pkg, prog, loss, feeds, d)
        finally:
            s.stop()
    np.testing.assert_allclose(runs["torch"], runs["jax"], rtol=2e-4, atol=1e-6)


def _train_loop(pkg, prog, loss, feeds, state_dir):
    if pkg == "jax":
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        with jfluid.scope_guard(scope):
            jfluid.io.load_persistables(exe, state_dir, prog)
            return [float(np.asarray(exe.run(prog, feed=dict(f), fetch_list=[loss])[0]))
                    for f in feeds]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(exe, state_dir, prog, scope=scope)
    return [float(exe.run(prog, feed=dict(f), fetch_list=[loss], scope=scope)[0]) for f in feeds]


def test_padding_and_tied_tables():
    V, D, B = 20, 4, 6
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 13
    with tfluid.program_guard(prog, startup), tfluid.unique_name.guard():
        a = tfluid.layers.data("a", [1], dtype="int64")
        b = tfluid.layers.data("b", [1], dtype="int64")
        y = tfluid.layers.data("y", [1])
        ea = tfluid.layers.embedding(a, [V, D], is_distributed=True, padding_idx=0,
                                     param_attr=tfluid.ParamAttr(name="tied"))
        eb = tfluid.layers.embedding(b, [V, D], is_distributed=True, padding_idx=0,
                                     param_attr=tfluid.ParamAttr(name="tied"))
        pred = tfluid.layers.fc(ea + eb, 1, name="tied_head")
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    assert len(prog._distributed_tables) == 2
    assert {m["table"] for m in prog._distributed_tables.values()} == {"tied"}
    server = tps.ParameterServer().start()
    try:
        tfluid.distributed.bind_distributed_tables(prog, [server.endpoint], lr=0.1)
        rng = np.random.RandomState(5)
        av = rng.randint(1, V, (B, 1)).astype("int64")
        av[0] = 0  # the pad token
        bv = rng.randint(1, V, (B, 1)).astype("int64")
        bv[1] = 0
        yv = rng.randn(B, 1).astype("float32")
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        row0 = server._dispatch({"op": "pull", "table": "tied", "ids": np.array([0])})["rows"].copy()
        for _ in range(5):
            ea_v, eb_v = exe.run(prog, feed={"a": av, "b": bv, "y": yv}, fetch_list=[ea, eb],
                                 scope=scope)
        np.testing.assert_array_equal(ea_v[0], np.zeros(D, np.float32))
        np.testing.assert_array_equal(eb_v[1], np.zeros(D, np.float32))
        assert np.abs(ea_v[1:]).max() > 0
        # the pad row's pushed gradient was masked: row 0 never moved
        row0_after = server._dispatch({"op": "pull", "table": "tied", "ids": np.array([0])})["rows"]
        np.testing.assert_array_equal(row0_after, row0)
    finally:
        server.stop()


def test_multi_table_pulls_on_dedicated_clients(tmp_path):
    V, B = 60, 16
    server = tps.ParameterServer().start()
    try:
        prog, startup = tfluid.Program(), tfluid.Program()
        prog.random_seed = startup.random_seed = 5
        with tfluid.program_guard(prog, startup), tfluid.unique_name.guard():
            ids = tfluid.layers.data("ids", [1], dtype="int64")
            y = tfluid.layers.data("y", [1])
            e1 = tfluid.layers.embedding(ids, [V, 6], is_distributed=True,
                                         param_attr=tfluid.ParamAttr(name="t1"))
            e2 = tfluid.layers.embedding(ids, [V, 4], is_distributed=True,
                                         param_attr=tfluid.ParamAttr(name="t2"))
            pred = tfluid.layers.fc([e1, e2], 1, name="head")
            loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
            tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        tfluid.distributed.bind_distributed_tables(prog, [server.endpoint], lr=0.1,
                                                   initializer="zeros")
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(prog, feed=dict(f), fetch_list=[loss], scope=scope)[0])
                  for f in _feeds(V, B, 8, seed=3)]
        pool = prog.__dict__.get("_sparse_pull_pool")
        assert pool and len(pool) == 1 and pool[0] is not prog._ps_client
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert sum(prog._uniq_id_hist.values()) == 2 * 8  # one count a table a batch
    finally:
        server.stop()


def test_steps_above_one_refused_with_tables(tmp_path):
    server = tps.ParameterServer().start()
    try:
        prog, startup, loss = _emb_model("torch", True)
        tfluid.distributed.bind_distributed_tables(prog, [server.endpoint])
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="steps=2"):
            exe.run(prog, feed=_feeds(40, 4, 1)[0], fetch_list=[loss], scope=scope, steps=2)
        with pytest.raises(RuntimeError, match="bind_distributed_tables"):
            exe.run(_emb_model("torch", True)[0], feed=_feeds(40, 4, 1)[0], scope=scope)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# async: the Communicator and the overlapped prefetch
# ---------------------------------------------------------------------------
def test_async_communicator_converges():
    V, D, B = 100, 6, 16
    rng = np.random.RandomState(7)
    target = rng.randn(V).astype("float32")
    feeds = []
    for _ in range(80):
        ids = rng.randint(0, V, (B, 1)).astype("int64")
        feeds.append({"ids": ids, "y": target[ids[:, 0]].reshape(-1, 1)})
    results = {}
    for mode in ("sync", "async"):
        server = tps.ParameterServer().start()
        try:
            prog, startup, loss = _emb_model("torch", True, V=V, D=D, seed=41, lr=0.3)
            tfluid.distributed.bind_distributed_tables(prog, [server.endpoint], lr=0.3,
                                                       initializer="zeros",
                                                       async_mode=(mode == "async"))
            exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
            exe.run(startup, scope=scope)
            results[mode] = [float(exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0])
                             for f in feeds]
            if mode == "async":
                comm = prog._ps_communicator
                comm.stop()
                assert comm.pending() == 0
        finally:
            server.stop()
    assert results["sync"][-1] < results["sync"][0] * 0.5
    assert results["async"][-1] < results["async"][0] * 0.5
    assert results["async"][-1] < max(results["sync"][-1] * 3.0, 0.05)


class _FlakyClient:
    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.calls = 0
        self.pushed = []

    def push_sparse(self, table, ids, grads):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise ConnectionError("transient PS blip %d" % self.calls)
        self.pushed.append((table, np.asarray(ids).copy(), np.asarray(grads).copy()))


def test_communicator_retries_and_requeues_failed_batch():
    c = _FlakyClient(fail_times=2)
    comm = Communicator(c, max_retries=3).start()
    comm.push("t", np.array([1, 2]), np.ones((2, 4), np.float32))
    comm.flush()
    comm.stop()
    assert len(c.pushed) == 1 and c.calls == 3 and comm.dropped == 0

    c = _FlakyClient(fail_times=3)
    comm = Communicator(c, max_retries=3).start()
    comm.push("t", np.array([5]), np.full((1, 4), 2.0, np.float32))
    deadline = time.time() + 20
    while comm._error is None and time.time() < deadline:
        time.sleep(0.05)
    assert comm._error is not None
    with pytest.raises(ConnectionError):
        comm.push("t", np.array([6]), np.ones((1, 4), np.float32))
    assert comm._error is not None
    with pytest.raises(ConnectionError):
        comm.flush()
    assert comm._error is None
    comm.flush()
    comm.stop()
    assert comm.dropped == 0
    assert any((ids == 5).all() for _, ids, _ in c.pushed), c.pushed


def test_communicator_queues_host_copies():
    """A tensor pushed on the queue is copied out on the caller's thread:
    writing the tensor afterwards does not change what is sent."""
    c = _FlakyClient(fail_times=0)
    comm = Communicator(c)  # not started: the batch stays queued
    g = torch.ones(3, 2)
    comm.push("t", torch.tensor([1, 2, 3]), g)
    g.fill_(7.0)
    comm.flush()
    np.testing.assert_array_equal(c.pushed[0][2], np.ones((3, 2), np.float32))


def test_geo_sgd_two_trainers():
    D = 6

    def build():
        prog, startup = tfluid.Program(), tfluid.Program()
        prog.random_seed = startup.random_seed = 51
        with tfluid.program_guard(prog, startup), tfluid.unique_name.guard():
            x = tfluid.layers.data("x", [D])
            y = tfluid.layers.data("y", [1])
            pred = tfluid.layers.fc(x, 1, name="geo_fc")
            loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
            tfluid.optimizer.SGDOptimizer(0.3).minimize(loss)
        return prog, startup, loss

    rng = np.random.RandomState(3)
    w_true = rng.randn(D, 1).astype("float32")
    data = []
    for _ in range(120):
        xb = rng.uniform(-1, 1, (16, D)).astype("float32")
        data.append({"x": xb, "y": xb @ w_true})
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog, startup, loss = build()
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    base = [float(exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]) for f in data]
    server = tps.ParameterServer().start()
    try:
        trainers = []
        for t in range(2):
            prog_t, startup_t, loss_t = build()
            scope_t = tfluid.Scope()
            exe.run(startup_t, scope=scope_t)
            geo = GeoSGD(prog_t, scope_t, [server.endpoint], num_trainers=2, trainer_id=t,
                         sync_every=3).init_worker()
            trainers.append((prog_t, scope_t, loss_t, geo, []))
        # trainer 1 pulled trainer 0's seed: both start from one state
        for n in (p.name for p in trainers[0][0].all_parameters()):
            np.testing.assert_array_equal(to_numpy(trainers[0][1].get(n)),
                                          to_numpy(trainers[1][1].get(n)))
        for i, f in enumerate(data):
            prog_t, scope_t, loss_t, geo, ls = trainers[i % 2]
            ls.append(float(exe.run(prog_t, feed=f, fetch_list=[loss_t], scope=scope_t)[0]))
            geo.step()
        assert trainers[0][4][-1] < trainers[0][4][0] * 0.1
        assert trainers[1][4][-1] < trainers[1][4][0] * 0.1
        assert min(trainers[0][4][-1], trainers[1][4][-1]) < max(base[-1] * 10.0, 0.08)
        assert all(isinstance(trainers[0][1].get(p.name), torch.Tensor)
                   for p in trainers[0][0].all_parameters())
    finally:
        server.stop()


def test_overlapped_prefetch_hides_latency_and_trains():
    V, B = 60, 16
    server = tps.ParameterServer().start()
    try:
        prog, startup, loss = _emb_model("torch", True, V=V, seed=9)
        tfluid.distributed.bind_distributed_tables(prog, [server.endpoint], lr=0.1,
                                                   initializer="zeros", async_mode=True)
        rng = np.random.RandomState(2)
        w = rng.randn(V, 1).astype("float32")
        feeds = []
        for _ in range(20):
            ids = rng.randint(0, V, (B, 1)).astype("int64")
            feeds.append({"ids": ids, "y": w[ids[:, 0]]})
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        out = exe.train_from_dataset(program=prog, dataset=feeds, scope=scope, fetch_list=[loss])
        losses = [float(o[0]) for o in out]
        assert len(losses) == 20 and losses[-1] < losses[0] * 0.9, losses
        stats = exe.jit_cache_stats()
        assert stats["ps_pull_overlap_s"] + stats["ps_pull_wait_s"] > 0, stats
        ctx = prog.__dict__.get("_sparse_overlap_ctx", {})
        assert "pending" not in ctx and ctx.get("clients", []) == []
        assert prog.__dict__.get("_sparse_prefetched_ids") in (None, {})
        (l,) = exe.run(prog, feed=dict(feeds[0]), fetch_list=[loss], scope=scope)
        assert np.isfinite(float(l))
        prog._ps_communicator.stop()
    finally:
        server.stop()


def test_overlapped_and_inline_paths_share_one_entry():
    server = tps.ParameterServer().start()
    try:
        prog, startup, loss = _emb_model("torch", True, seed=11)
        tfluid.distributed.bind_distributed_tables(prog, [server.endpoint], lr=0.1,
                                                   initializer="zeros", async_mode=True)
        feeds = _feeds(40, 8, 6, seed=6)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(prog, feed=dict(feeds[0]), fetch_list=[loss], scope=scope)
        before = exe.jit_cache_stats()
        exe.train_from_dataset(program=prog, dataset=feeds, scope=scope, fetch_list=[loss])
        after = exe.jit_cache_stats()
        assert after["misses"] == before["misses"] and after["entries"] == before["entries"]
        assert after["plan_misses"] == before["plan_misses"]
        assert after["hits"] == before["hits"] + len(feeds)
        prog._ps_communicator.stop()
    finally:
        server.stop()


def test_overlap_iterator_does_not_mutate_caller_feeds():
    V = 40
    server = tps.ParameterServer().start()
    try:
        prog, startup, loss = _emb_model("torch", True, V=V, seed=29)
        tfluid.distributed.bind_distributed_tables(prog, [server.endpoint], lr=0.1,
                                                   initializer="zeros", async_mode=True)
        feeds = _feeds(V, 8, 5, seed=12)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        exe.train_from_dataset(program=prog, dataset=feeds, scope=scope, fetch_list=[loss])
        assert all(set(f) == {"ids", "y"} for f in feeds)
        prog._ps_communicator.flush()
        pull = {"op": "pull", "table": "ctr_table", "ids": np.arange(V)}
        before = server._dispatch(pull)["rows"].copy()
        exe.train_from_dataset(program=prog, dataset=feeds, scope=scope, fetch_list=[loss])
        prog._ps_communicator.flush()
        assert not np.allclose(before, server._dispatch(pull)["rows"])
        prog._ps_communicator.stop()
    finally:
        server.stop()


def test_distributed_table_metadata_serde():
    prog, _, _ = _emb_model("torch", True)
    loaded = tfluid.Program.from_json(prog.to_json())
    assert loaded._distributed_tables == prog._distributed_tables


def test_flush_is_not_starved_by_an_idle_send_thread():
    """flush() while the send thread idles over two tables: the thread
    waits for work outside the send lock, so the flush takes its turn at
    once (the JAX package's copy waits on the lock for about a minute)."""
    c = _FlakyClient(fail_times=0)
    comm = Communicator(c).start()
    try:
        for t in ("a", "b"):
            comm.push(t, np.arange(8), np.ones((8, 4), np.float32))
        time.sleep(0.3)  # drained; the thread now idles on both queues
        comm.push("a", np.arange(8), np.ones((8, 4), np.float32))
        t0 = time.perf_counter()
        comm.flush()
        assert time.perf_counter() - t0 < 5.0
        assert comm.pending() == 0 and len(c.pushed) == 3
    finally:
        comm.stop()


class _SlowClient(_FlakyClient):
    def push_sparse(self, table, ids, grads):
        time.sleep(0.3)
        super().push_sparse(table, ids, grads)


def test_flush_waits_for_a_send_in_flight():
    """A batch the send thread has popped and is still sending counts for
    flush()'s barrier: flush returns only once it is on the server."""
    c = _SlowClient(fail_times=0)
    comm = Communicator(c).start()
    try:
        comm.push("t", np.arange(4), np.ones((4, 2), np.float32))
        deadline = time.time() + 5
        while comm.pending() and time.time() < deadline:
            time.sleep(0.005)
        assert comm.pending() == 0 and not c.pushed  # popped, not yet sent
        comm.flush()
        assert len(c.pushed) == 1
        for k in range(6):  # merged or not, every batch lands before flush returns
            comm.push("t", np.arange(4) + k, np.ones((4, 2), np.float32))
        comm.flush()
        assert sum(len(ids) for _, ids, _ in c.pushed) == 4 + 24
    finally:
        comm.stop()
