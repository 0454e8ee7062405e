"""The dense parameter server of paddle_tpu_torch against paddle_tpu:
``DistributeTranspiler``'s "pserver" mode, the executor's dense-PS round
and ``_run_pserver``, Hogwild's async flip, the overlapped pull of
``train_from_dataset`` and ``AsyncExecutor``, as tests/test_distributed.py,
tests/chaos/test_chaos_training.py and tests/test_aux_subsystems.py hold
the JAX package's.  Servers run on threads of this process on 127.0.0.1,
each on a free port; every thread is joined with a timeout, so a hung
trainer or server fails its test.

* Loss parity: two port trainers, each feeding the same batch, on two
  port pservers (sync) against the JAX package's single-process run from
  the same state: SGD and Momentum within rtol 2e-4, Adam 5e-4, the
  reference tests' tolerances.
* Hogwild flips the round to async and still learns; the overlapped pull
  runs on a client of its own, feeds ``ps_pull_overlap_s`` and
  ``ps_pull_wait_s`` and the ledger's ``ps_wait``, and leaves nothing in
  flight; a flapping ``ps.pull`` is retried through the pull's budget.
* The dense ``ps.pull`` and ``ps.push`` fault points fire (the JAX
  package's labels).
* A pulled parameter reaches the cached entry: on the CPU's cached path
  each loss is that of the parameters the server holds, and ``_replay``
  copies a tensor that the pull put in the scope into its graph's buffer
  before the replay.
* ``AsyncExecutor`` over a MultiSlot filelist: the JAX package's losses
  from the same state.
"""
import socket
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.trainer_desc import TrainerFactory

from torch_parity_util import jax_startup_state, run_jax

PKG = {"jax": jfluid, "torch": tfluid}
JOIN_S = 120  # a trainer thread's limit


def free_endpoint():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return "127.0.0.1:%d" % port


def model(pkg, opt="sgd", seed=5):
    fluid = PKG[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        {"sgd": lambda: fluid.optimizer.SGDOptimizer(0.2),
         "momentum": lambda: fluid.optimizer.MomentumOptimizer(0.1, momentum=0.9),
         "adam": lambda: fluid.optimizer.AdamOptimizer(0.01)}[opt]().minimize(loss)
    return prog, startup, loss


def batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.uniform(-1, 1, (16, 8)).astype("float32"),
            "y": rng.randint(0, 4, (16, 1)).astype("int64")}


def start_pservers(endpoints, opt="sgd", trainers=2, sync=True):
    """One port pserver program a endpoint, each served by
    ``Executor.run`` on a thread; returns the programs (``._pserver`` once
    serving)."""
    progs = []
    for ep in endpoints:
        t = tfluid.DistributeTranspiler()
        p, _, _ = model("torch", opt)
        t.transpile(0, program=p, pservers=",".join(endpoints), trainers=trainers,
                    sync_mode=sync)
        pprog = t.get_pserver_program(ep)
        threading.Thread(target=tfluid.Executor(tfluid.CPUPlace()).run, args=(pprog,),
                         daemon=True).start()
        progs.append(pprog)
    return progs


def stop_pservers(progs):
    for p in progs:
        server = getattr(p, "_pserver", None)
        if server is not None:
            server.stop()


def trainer_program(tid, endpoints, opt="sgd", trainers=2, sync=True):
    prog, startup, loss = model("torch", opt)
    t = tfluid.DistributeTranspiler()
    t.transpile(tid, program=prog, pservers=",".join(endpoints), trainers=trainers,
                sync_mode=sync)
    return t.get_trainer_program(), startup, loss


def port_scope(state):
    scope = tfluid.Scope()
    tfluid.io.set_params_from_numpy(scope, state, "cpu")
    return scope


def run_threads(fns):
    threads = [threading.Thread(target=f, daemon=True) for f in fns]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=JOIN_S)
    assert not any(th.is_alive() for th in threads), "a trainer thread hung"


@pytest.mark.parametrize("opt,rtol", [("sgd", 2e-4), ("momentum", 2e-4), ("adam", 5e-4)])
def test_two_trainer_loss_parity_with_the_jax_package(opt, rtol):
    steps = 6
    jm, js, jloss = model("jax", opt)
    state = jax_startup_state(js, jm)
    feed = batch()
    base = [float(o[0]) for o in run_jax(jm, state, feed, [jloss.name], steps)[0]]

    endpoints = [free_endpoint(), free_endpoint()]
    pservers = start_pservers(endpoints, opt)
    # program building touches the process-global name state: build both
    # trainers' programs first, run them concurrently
    built = {tid: trainer_program(tid, endpoints, opt) for tid in (0, 1)}
    results = {}

    def trainer(tid):
        tprog, _, loss = built[tid]
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), port_scope(state)
        results[tid] = [float(exe.run(tprog, feed=feed, fetch_list=[loss], scope=scope)[0])
                        for _ in range(steps)]

    try:
        run_threads([lambda t=t: trainer(t) for t in (0, 1)])
        assert set(results) == {0, 1}, "a trainer thread died: %s" % results
        # both trainers feed the same batch: the mean gradient is the
        # single process's, so the server's trajectory is its
        np.testing.assert_allclose(results[0], base, rtol=rtol)
        np.testing.assert_allclose(results[1], base, rtol=rtol)
    finally:
        stop_pservers(pservers)


def test_trainer_program_has_no_update_and_a6b_is_ported():
    tprog, _, _ = trainer_program(0, ["127.0.0.1:1"], "adam")
    assert not [op for op in tprog.global_block().ops if op.type == "adam"]
    assert "_dense_ps_ctx" not in texecutor._UNPORTED_PROGRAM_STATE
    assert "_pserver_ctx" not in texecutor._UNPORTED_PROGRAM_STATE
    assert not any("A6b" in v for v in texecutor._UNPORTED_PROGRAM_STATE.values())


def test_steps_above_one_refused():
    endpoints = [free_endpoint()]
    tprog, startup, loss = trainer_program(0, endpoints, trainers=1)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="dense PS"):
        exe.run(tprog, feed=batch(), fetch_list=[loss], scope=scope, steps=2)


def test_compiled_trainer_program_pushes_and_pulls():
    """A transpiled trainer program wrapped in ``CompiledProgram(...)
    .with_data_parallel`` (a one-rank mesh) runs the executor's dense-PS
    round, as the JAX package unwraps it: one trainer's losses are the JAX
    package's single-process run (rtol 2e-4), so every step pushed its
    gradients and pulled the server's update.  Over more than one rank the
    compiled step has no dense-PS round and raises naming A10 part 4."""
    from paddle_tpu_torch.parallel import mesh as tmesh

    steps = 4
    jm, js, jloss = model("jax")
    state = jax_startup_state(js, jm)
    feed = batch()
    base = [float(o[0]) for o in run_jax(jm, state, feed, [jloss.name], steps)[0]]
    endpoints = [free_endpoint()]
    pservers = start_pservers(endpoints, trainers=1)
    tprog, _, loss = trainer_program(0, endpoints, trainers=1)
    try:
        cp = tfluid.CompiledProgram(tprog).with_data_parallel(loss_name=loss.name)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), port_scope(state)
        got = [float(exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)[0])
               for _ in range(steps)]
        np.testing.assert_allclose(got, base, rtol=2e-4)
        assert got[-1] < got[0]
        cp._mesh = tmesh.Mesh({"dp": 2}, 0, groups={})  # seen from rank 0 of two
        with pytest.raises(NotImplementedError, match="parameter-server.*A10 part 4"):
            exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        stop_pservers(pservers)


def test_pserver_run_binds_no_device():
    """The pserver branch returns before the scope binds a device: a
    pserver process never touches its executor's device."""
    ep = free_endpoint()
    t = tfluid.DistributeTranspiler()
    p, _, _ = model("torch")
    t.transpile(0, program=p, pservers=ep, trainers=1)
    pprog = t.get_pserver_program(ep)
    scope = tfluid.Scope()
    th = threading.Thread(target=tfluid.Executor(tfluid.CPUPlace()).run, args=(pprog,),
                          kwargs={"scope": scope}, daemon=True)
    th.start()
    try:
        for _ in range(200):
            if getattr(pprog, "_pserver", None) is not None:
                break
            th.join(0.01)
        assert pprog._pserver.endpoint == ep
        assert sorted(pprog._pserver._dense) == sorted(pprog._pserver_ctx["params"])
        assert scope.device is None
    finally:
        stop_pservers([pprog])
    th.join(timeout=10)
    assert not th.is_alive()


def _hogwild_setup(opt="sgd"):
    ep = free_endpoint()
    pservers = start_pservers([ep], opt, trainers=1, sync=False)
    # transpiled sync: Hogwild flips it
    tprog, startup, loss = trainer_program(0, [ep], opt, trainers=1, sync=True)
    desc = TrainerFactory().create_trainer()  # Hogwild
    desc.set_fetch_var_and_info([loss], ["loss"], 100)
    return pservers, tprog, startup, loss, desc


def test_hogwild_async_dense_ps_trains():
    pservers, tprog, startup, loss, desc = _hogwild_setup()
    feeds = [batch() for _ in range(12)]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    try:
        exe.run(startup, scope=scope)
        out = exe.train_from_dataset(program=tprog, dataset=feeds, scope=scope,
                                     trainer_desc=desc)
        assert tprog._dense_ps_ctx["sync"] is False  # Hogwild flipped it
        losses = [float(o[0]) for o in out]
        assert len(losses) == 12 and losses[-1] < losses[0] * 0.9, losses
    finally:
        stop_pservers(pservers)


def test_overlapped_pull_counters_and_ledger_ps_wait():
    """The pull runs on a client of its own, is accounted in the overlap
    and wait counters (the executor's and the registry's) and in the
    ledger's ps_wait, training still converges, nothing is left in flight,
    and the overlap flag lives only inside train_from_dataset."""
    pservers, tprog, startup, loss, desc = _hogwild_setup()
    feeds = [batch(3) for _ in range(12)]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    reg0 = (monitor.counter_value("executor_ps_pull_overlap_seconds_total")
            + monitor.counter_value("executor_ps_pull_wait_seconds_total"))
    try:
        exe.run(startup, scope=scope)
        out = exe.train_from_dataset(program=tprog, dataset=feeds, scope=scope,
                                     trainer_desc=desc, phase_ledger=True)
        ctx = tprog._dense_ps_ctx
        assert ctx["sync"] is False
        assert ctx.get("_pull_client") is not None
        assert ctx["_pull_client"]._socks == [None] * len(ctx["endpoints"])  # closed
        assert ctx.get("_pull_pending") is None
        assert "overlap_pull" not in ctx
        stats = exe.jit_cache_stats()
        total = stats["ps_pull_overlap_s"] + stats["ps_pull_wait_s"]
        assert total > 0, stats
        assert (monitor.counter_value("executor_ps_pull_overlap_seconds_total")
                + monitor.counter_value("executor_ps_pull_wait_seconds_total")) >= reg0 + total * 0.99
        led = exe.last_train_ledger
        assert led.seconds["ps_wait"] > 0
        # the ledger's ps_wait is the in-loop joins' waits (the drain after
        # the loop comes after the epoch's ledger closed)
        assert led.seconds["ps_wait"] <= stats["ps_pull_wait_s"] * 1.01
        assert exe.last_dense_ps_round["overlapped"] is True
        losses = [float(o[0]) for o in out]
        assert losses[-1] < losses[0] * 0.9, losses
        # a run outside train_from_dataset is synchronous again
        (l,) = exe.run(tprog, feed=feeds[0], fetch_list=[loss], scope=scope)
        assert ctx.get("_pull_pending") is None and np.isfinite(l).all()
        assert exe.last_dense_ps_round["overlapped"] is False
    finally:
        stop_pservers(pservers)


def test_ps_pull_flap_is_retried_during_async_training():
    """The chaos test's case: two injected connection failures land inside
    a step's overlapped pull (the init handshake makes 4 direct pulls),
    which redials and retries; every step completes and training learns."""
    pservers, tprog, startup, loss, desc = _hogwild_setup()
    feeds = [batch() for _ in range(12)]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    r0 = monitor.counter_value("retry_attempts_total", op="ps.pull")
    try:
        exe.run(startup, scope=scope)
        with faults.armed("ps.pull=error:ConnectionError,after=10,times=2") as plan:
            out = exe.train_from_dataset(program=tprog, dataset=feeds, scope=scope,
                                         trainer_desc=desc)
        assert plan.triggers() == {"ps.pull": 2}
        assert len(out) == 12
        losses = [float(o[0]) for o in out]
        assert losses[-1] < losses[0] * 0.9, losses
        assert monitor.counter_value("retry_attempts_total", op="ps.pull") - r0 >= 1
    finally:
        stop_pservers(pservers)


@pytest.mark.parametrize("point", ["ps.pull", "ps.push"])
def test_dense_fault_points_fire(point):
    """``pull_dense`` and ``push_dense`` carry the JAX package's fault
    points, labelled with the parameter's name."""
    from paddle_tpu_torch.distributed.ps import ParameterServer, PSClient

    srv = ParameterServer().start()
    cli = PSClient([srv.endpoint])
    try:
        cli.create_dense("w", (2, 3))
        cli.seed_dense("w", np.ones((2, 3), np.float32))
        with faults.armed("%s=error:ConnectionError" % point) as plan:
            with pytest.raises(ConnectionError):
                if point == "ps.pull":
                    cli.pull_dense("w")
                else:
                    cli.push_dense("w", np.ones((2, 3), np.float32), 0.1)
        assert plan.triggers() == {point: 1}
        # disarmed, the call goes through
        np.testing.assert_array_equal(cli.pull_dense("w"), np.ones((2, 3), np.float32))
    finally:
        cli.close()
        srv.stop()


def test_pulled_parameters_reach_the_cached_entry():
    """One sync SGD trainer on the CPU's cached path: after each run the
    scope holds the server's parameters, and the next (cached) run's loss
    is the loss of exactly those parameters."""
    ep = free_endpoint()
    pservers = start_pservers([ep], trainers=1)
    tprog, startup, loss = trainer_program(0, [ep], trainers=1)
    ref_prog, ref_startup, ref_loss = model("torch")
    test_prog = ref_prog.clone(for_test=True)
    feed = batch(7)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    ref_exe, ref_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    names = sorted(tprog._dense_ps_ctx["params"])
    try:
        exe.run(startup, scope=scope)
        ref_exe.run(ref_startup, scope=ref_scope)
        server = pservers[0]._pserver
        for step in range(4):
            (l,) = exe.run(tprog, feed=feed, fetch_list=[loss], scope=scope)
            if step:
                # the loss of the parameters the last run pulled
                np.testing.assert_allclose(float(l), want, rtol=1e-6)
            for n in names:
                np.testing.assert_array_equal(scope.get(n).numpy(), server._dense[n].value)
                ref_scope.set(n, server._dense[n].value)
            (want,) = ref_exe.run(test_prog, feed=feed, fetch_list=[ref_loss.name],
                                  scope=ref_scope)
            want = float(want)
        stats = exe.jit_cache_stats()
        assert stats["hits"] >= 3 and stats["plan_hits"] >= 3, stats
    finally:
        stop_pservers(pservers)


def test_replay_copies_a_pulled_tensor_into_the_graph_buffer():
    """A pull puts a NEW tensor in the scope; before the replay, ``_replay``
    copies it into the captured graph's buffer and makes the buffer the
    scope's tensor again (a graph that read the stale buffer would train
    on old weights with no error)."""
    seen = {}

    class Recorder:
        def replay(self):
            seen["w"] = bufs["w"].clone()

    scope = tfluid.Scope(device="cpu")
    buf = torch.zeros(3)
    scope.vars["w"] = buf
    bufs = {"w": buf}
    graph = texecutor._Graph(scope, Recorder(), bufs, {}, [], {}, 0)
    pulled = np.array([1.0, 2.0, 3.0], np.float32)
    scope.set("w", pulled)  # what the dense pull does
    assert scope.vars["w"] is not buf
    tfluid.Executor(tfluid.CPUPlace())._replay(graph, scope, {}, 1, False)
    np.testing.assert_array_equal(seen["w"].numpy(), pulled)
    assert scope.vars["w"] is buf


def _multislot_file(tmp_path):
    f = tmp_path / "part-0.txt"
    rng = np.random.RandomState(0)
    lines = []
    for _ in range(64):
        x = rng.rand(4)
        lines.append("4 " + " ".join("%.4f" % v for v in x) + " 1 %.4f" % (x.sum() * 0.5))
    f.write_text("\n".join(lines) + "\n")
    return str(f)


def _async_model(pkg):
    fluid = PKG[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 12
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return prog, startup, loss, [x, y]


def test_async_executor_over_a_filelist_matches_the_jax_package(tmp_path):
    path = _multislot_file(tmp_path)
    jprog, jstartup, jloss, jslots = _async_model("jax")
    state = jax_startup_state(jstartup, jprog)

    class JFeed:
        slots = jslots

    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        for n, v in state.items():
            jscope.set(n, v)
        jout = jfluid.AsyncExecutor(jfluid.CPUPlace()).run(jprog, JFeed(), [path],
                                                           fetch_list=[jloss], scope=jscope)
    tprog, _, tloss, tslots = _async_model("torch")

    class TFeed:
        slots = tslots

    tout = tfluid.AsyncExecutor(tfluid.CPUPlace()).run(tprog, TFeed(), path, fetch_list=[tloss],
                                                       scope=port_scope(state))
    jl = [float(np.asarray(o[0])) for o in jout]
    tl = [float(o[0]) for o in tout]
    assert len(tl) == len(jl) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
    assert tl[-1] < tl[0]
    with pytest.raises(ValueError, match="slots"):
        tfluid.AsyncExecutor(tfluid.CPUPlace()).run(tprog, object(), path)
    if not torch.cuda.is_available():  # no place: the card, never a CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            tfluid.AsyncExecutor()
