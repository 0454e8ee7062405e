"""The collective ops, ``parallel/env.py``, the collective rewriters at
work and ``distributed/launch.py`` of paddle_tpu_torch against
paddle_tpu.

* At one rank (no process group bound to the ring) each of the 13 op
  types gives the JAX op's output outside a mapped axis: the identity,
  nothing for the bootstrap ops, ``local_sgd_select``'s choice.  A
  ``c_comm_init`` for more than one rank with no group raises.
* Over two gloo processes started by the port's launcher: every reducing
  op against numpy, ``c_allreduce_prod`` with signs and zeros, broadcast
  from rank 1, allgather, reduce-scatter.
* ``GradAllReduce`` over two gloo ranks, each with half of a batch: the
  mean of the ranks' losses and the weight within rtol 1e-5 and 1e-4 of
  the JAX package's ``shard_map`` run of its own rewritten program and of
  its single-process full batch (tests/test_distributed.py's bar), for two
  steps against the latter; and on a model whose weight is used twice
  (its update reads a ``sum`` of partial gradients) against the full
  batch.  The ranks' plan holds ``c_allreduce_sum`` in
  its ``eager_ops``; at one rank the same plan has none (it captures).
* The launcher's worker environment is the JAX launcher's (the device
  flag named for the card), hides no device, writes ``workerlog.N`` and
  returns a failing worker's code.

Every child process has a timeout and every port is a free one.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.parallel import env as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 180  # a child process's limit

ONE_RANK_CASES = {
    "c_allreduce_sum": {}, "c_allreduce_max": {}, "c_allreduce_min": {},
    "c_allreduce_prod": {}, "allreduce": {}, "c_broadcast": {"root": 0},
    "c_allgather": {}, "c_reducescatter": {}, "c_sync_calc_stream": {},
    "c_sync_comm_stream": {}, "c_comm_init": {"nranks": 1, "rank": 0},
    "c_gen_nccl_id": {}, "local_sgd_select": {"k_steps": 2, "nranks": 2},
}


def free_port_pair():
    """A free port whose successor is free too (the launcher numbers its
    workers' endpoints from a started port)."""
    for _ in range(50):
        s1 = socket.socket()
        s1.bind(("127.0.0.1", 0))
        port = s1.getsockname()[1]
        s2 = socket.socket()
        try:
            s2.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
        finally:
            s1.close()
            s2.close()
    raise RuntimeError("no free port pair")


@pytest.mark.parametrize("op_type", sorted(ONE_RANK_CASES))
def test_one_rank_output_is_the_jax_ops_outside_a_mapped_axis(op_type):
    rng = np.random.RandomState(3)
    attrs = dict(ONE_RANK_CASES[op_type], ring_id=0)
    if op_type == "local_sgd_select":
        ins = {"Param": rng.randn(3, 4).astype("float32"), "Avg": rng.randn(3, 4).astype("float32")}
        for step in (2.0, 3.0):  # a multiple of k takes the average
            feed = dict(ins, Step=np.array([step], np.float32))
            want = jregistry.get_kernel(op_type)({k: [v] for k, v in feed.items()}, attrs)["Out"]
            got = tregistry.get_kernel(op_type)({k: [torch.from_numpy(v)] for k, v in feed.items()},
                                                attrs, torch.device("cpu"))["Out"]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    x = rng.randn(4, 3).astype("float32")
    want = jregistry.get_kernel(op_type)({"X": [x]}, attrs)
    got = tregistry.get_kernel(op_type)({"X": [torch.from_numpy(x)]}, attrs, torch.device("cpu"))
    assert set(got) == set(want)
    for slot in want:
        np.testing.assert_array_equal(got[slot].numpy(), np.asarray(want[slot]))


def test_comm_init_for_several_ranks_without_a_group_raises():
    init = tregistry.get_kernel("c_comm_init")
    assert init({}, {"ring_id": 0, "nranks": 1}, torch.device("cpu")) == {}
    with pytest.raises(RuntimeError, match="rewritten for 2 ranks"):
        init({}, {"ring_id": 0, "nranks": 2, "rank": 0}, torch.device("cpu"))
    # shape inference (meta) checks nothing
    assert init({}, {"ring_id": 0, "nranks": 2}, torch.device("meta")) == {}
    assert tenv.ring_size(0) == 1 and tenv.group_for_ring(0) is None


MODEL = textwrap.dedent('''
    def gar_model(fluid, tied=False):
        """fc(x, 1) with no bias under SGD 0.2 (tests/test_distributed.py's);
        ``tied``: the input goes through one [6, 6] weight twice first, so
        its update reads the sum of two partial gradients."""
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 11
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [6])
            y = fluid.layers.data("y", [1])
            if tied:
                for _ in range(2):
                    x = fluid.layers.fc(x, 6, param_attr=fluid.ParamAttr(name="w_tied"),
                                        bias_attr=False, act="tanh")
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                fluid.layers.fc(x, 1, bias_attr=False), y))
            fluid.optimizer.SGDOptimizer(0.2).minimize(loss)
        return prog, startup, loss
''')
exec(MODEL)

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.parallel import env as penv

    {model}
    mode, out_dir = sys.argv[1], sys.argv[2]
    penv.init_from_env(backend="gloo", timeout_s=60)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    cpu = torch.device("cpu")
    res = {{"rank": rank, "ring_size": penv.ring_size(0)}}
    if mode == "ops":
        xs = np.array({xs!r}, np.float32)
        x = torch.from_numpy(xs[rank].copy())
        for t in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                  "c_allreduce_prod", "allreduce", "c_reducescatter", "c_allgather"):
            res[t] = registry.get_kernel(t)({{"X": [x]}}, {{"ring_id": 0}}, cpu)["Out"].tolist()
        res["c_broadcast"] = registry.get_kernel("c_broadcast")(
            {{"X": [x]}}, {{"ring_id": 0, "root": 1}}, cpu)["Out"].tolist()
        res["x_after"] = x.tolist()  # the ops leave their input alone
    else:
        state = dict(np.load(os.path.join(out_dir, "state.npz")))
        data = np.load(os.path.join(out_dir, "batch.npz"))
        half = len(data["x"]) // 2
        feed = {{"x": data["x"][rank * half:(rank + 1) * half],
                 "y": data["y"][rank * half:(rank + 1) * half]}}
        prog, startup, loss = gar_model(fluid, mode == "gar_tied")
        fluid.parallel.GradAllReduce().transpile(startup, prog, rank, ["r0", "r1"], "r%d" % rank)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)  # c_comm_init checks the ring's two ranks
        fluid.io.set_params_from_numpy(scope, state, "cpu")
        wname = sorted(p.name for p in prog.all_parameters())[-1]
        res["losses"], res["w"] = [], []
        for _ in range(2):
            res["losses"].append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                               scope=scope)[0]))
            res["w"].append(scope.get(wname).numpy().tolist())
        res["eager_ops"] = list(exe._analyze(prog, ("x", "y"), (loss.name,)).eager_ops)
        res["graphs"] = exe.jit_cache_stats()["graphs"]
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
''')

PROD_XS = [[2.0, -3.0, 0.0, -1.5, -2.0, 1.0], [1.0, -1.0, 4.0, 0.5, -2.0, -7.0]]


def launch_two(tmp_path, mode, monkeypatch):
    """Start two gloo workers through the port's launcher; wait for both
    (each within CHILD_S) and return their results by rank."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, xs=PROD_XS, model=MODEL))
    monkeypatch.setenv("PYTHONPATH", REPO)
    args = tlaunch._parse_args(["--nproc_per_node=2", "--started_port=%d" % free_port_pair(),
                                "--log_dir=%s" % (tmp_path / "logs"), str(script), mode,
                                str(tmp_path)])
    procs = tlaunch.start_procs(args)
    try:
        for p in procs:
            p.wait(timeout=CHILD_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {r: (tmp_path / "logs" / ("workerlog.%d" % r)).read_text() for r in (0, 1)}
    assert [p.returncode for p in procs] == [0, 0], logs
    return [json.loads((tmp_path / ("rank%d.json" % r)).read_text()) for r in (0, 1)]


def test_collective_ops_over_two_gloo_processes(tmp_path, monkeypatch):
    res = launch_two(tmp_path, "ops", monkeypatch)
    xs = np.array(PROD_XS, np.float32)
    for r, out in enumerate(res):
        assert out["rank"] == r and out["ring_size"] == 2
        np.testing.assert_array_equal(out["x_after"], xs[r])
        for t in ("c_allreduce_sum", "allreduce"):
            np.testing.assert_allclose(out[t], xs.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(out["c_allreduce_max"], xs.max(0))
        np.testing.assert_array_equal(out["c_allreduce_min"], xs.min(0))
        # signs and zeros: [2, 3, 0, -0.75, 4, -7]
        np.testing.assert_allclose(out["c_allreduce_prod"], np.prod(xs, axis=0), rtol=1e-6)
        assert out["c_allreduce_prod"][2] == 0.0 and out["c_allreduce_prod"][3] < 0
        np.testing.assert_array_equal(out["c_broadcast"], xs[1])
        np.testing.assert_array_equal(out["c_allgather"], xs.reshape(-1))
        np.testing.assert_allclose(out["c_reducescatter"], xs.sum(0)[3 * r:3 * (r + 1)], rtol=1e-6)


def _jax_shard_map_step(state, xb, yb):
    """The JAX package's GradAllReduce program over a 2-device mesh
    (tests/test_distributed.py's run, at two ranks): the ranks' mean loss
    and the weight after one step."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.core import lowering
    from paddle_tpu.parallel import env as jenv
    from paddle_tpu.parallel import mesh as mesh_lib
    from paddle_tpu.parallel.collective_transpiler import GradAllReduce

    prog, startup, loss = gar_model(jfluid)
    GradAllReduce().transpile(startup, prog, 0, ["r0", "r1"], "r0")
    wname = prog.all_parameters()[0].name
    fn = lowering.lower_block(prog.global_block(), ["x", "y"], [loss.name], [wname])
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("dp",))
    jenv.set_ring_axis(0, "dp")

    def step(state0, xs, ys):
        with jenv.active_axes(["dp"]):
            fetches, new = fn(dict(state0), {"x": xs, "y": ys})
        return jax.lax.pmean(fetches[0], "dp"), new[wname]

    sharded = jax.jit(mesh_lib.shard_map(step, mesh=mesh, in_specs=(P(), P("dp"), P("dp")),
                                         out_specs=(P(), P()), check_vma=False))
    l, w = sharded(state, xb, yb)
    return float(np.asarray(l)), np.asarray(w)


@pytest.mark.parametrize("tied", [False, True])
def test_grad_allreduce_over_two_gloo_ranks(tied, tmp_path, monkeypatch):
    """``tied``: the port reduces the summed gradient of the weight used
    twice (the JAX package's rewrite reduces a partial after the sum has
    read it, tests/test_torch_transpiler.py), so it matches the full batch
    there too; its shard_map run is compared on the plain model only."""
    from torch_parity_util import jax_startup_state, run_jax

    rng = np.random.RandomState(2)
    xb = rng.uniform(-1, 1, (16, 6)).astype("float32")
    yb = xb.sum(1, keepdims=True).astype("float32") * 0.3
    jprog, jstartup, jloss = gar_model(jfluid, tied)
    state = jax_startup_state(jstartup, jprog)
    wname = sorted(p.name for p in jprog.all_parameters())[-1]  # w_tied, or the fc weight
    single, jscope = run_jax(jprog, state, {"x": xb, "y": yb}, [jloss.name])
    w1 = np.asarray(jscope.get(wname))
    single2, jscope2 = run_jax(jprog, state, {"x": xb, "y": yb}, [jloss.name], steps=2)
    w2 = np.asarray(jscope2.get(wname))
    np.savez(tmp_path / "state.npz", **state)
    np.savez(tmp_path / "batch.npz", x=xb, y=yb)

    res = launch_two(tmp_path, "gar_tied" if tied else "gar", monkeypatch)
    losses = np.mean([r["losses"] for r in res], axis=0)
    np.testing.assert_allclose(losses[0], float(single[0][0]), rtol=1e-5)
    np.testing.assert_allclose(losses[1], float(single2[1][0]), rtol=1e-5)
    if not tied:
        l_sm, w_sm = _jax_shard_map_step(state, xb, yb)
        np.testing.assert_allclose(losses[0], l_sm, rtol=1e-5)
    for r in res:
        np.testing.assert_allclose(r["w"][0], w1, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["w"][1], w2, rtol=1e-4, atol=1e-6)
        if not tied:
            np.testing.assert_allclose(r["w"][0], w_sm, rtol=1e-4, atol=1e-6)
        # a live collective keeps the plan on the interpreter
        assert r["eager_ops"] == ["c_allreduce_sum"] and r["graphs"] == 0
    assert res[0]["w"] == res[1]["w"]  # the ranks stay in step


def test_one_rank_plan_captures():
    """With no group bound the rewritten plan has no eager op (on a card it
    would be captured), and the program trains as the plain one."""
    prog, startup, loss = gar_model(tfluid)
    tfluid.parallel.GradAllReduce().transpile(startup, prog, 0, ["r0"], "r0")
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert exe._analyze(prog, ("x", "y"), (loss.name,)).eager_ops == ()
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    xb = rng.uniform(-1, 1, (8, 6)).astype("float32")
    out = [float(exe.run(prog, feed={"x": xb, "y": xb[:, :1]}, fetch_list=[loss], scope=scope)[0])
           for _ in range(3)]
    assert out[-1] < out[0]


LAUNCH_SCRIPT = textwrap.dedent('''
    import json, os
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_TRAINER_ENDPOINTS", "FLAGS_selected_tpus", "FLAGS_selected_gpus",
            "CUDA_VISIBLE_DEVICES", "LAUNCH_PROBE")
    print(json.dumps({k: os.environ.get(k) for k in keys}))
''')


def test_launcher_environment_is_the_jax_launchers(tmp_path, monkeypatch):
    from paddle_tpu.distributed import launch as jlaunch

    script = tmp_path / "worker.py"
    script.write_text(LAUNCH_SCRIPT)
    monkeypatch.setenv("LAUNCH_PROBE", "inherited")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    port = free_port_pair()
    envs = {}
    for pkg, mod in (("jax", jlaunch), ("torch", tlaunch)):
        logdir = tmp_path / pkg
        assert mod.launch(["--nproc_per_node=2", "--started_port=%d" % port,
                           "--log_dir=%s" % logdir, str(script)]) == 0
        envs[pkg] = [json.loads((logdir / ("workerlog.%d" % r)).read_text()) for r in (0, 1)]
    for r, (j, t) in enumerate(zip(envs["jax"], envs["torch"])):
        for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_CURRENT_ENDPOINT",
                  "PADDLE_TRAINER_ENDPOINTS", "LAUNCH_PROBE"):
            assert t[k] == j[k], k
        assert t["FLAGS_selected_gpus"] == j["FLAGS_selected_tpus"] == str(r)
        assert t["CUDA_VISIBLE_DEVICES"] is None  # no card hidden
        assert t["PADDLE_CURRENT_ENDPOINT"] == "127.0.0.1:%d" % (port + r)
    assert envs["torch"][0]["PADDLE_TRAINER_ENDPOINTS"] == "127.0.0.1:%d,127.0.0.1:%d" % (
        port, port + 1)
    # the workers' variables without starting them
    args = tlaunch._parse_args(["--nproc_per_node=2", "--started_port=%d" % port, str(script)])
    assert [e["PADDLE_TRAINER_ID"] for e in tlaunch.worker_envs(args)] == ["0", "1"]
    # a failing worker's exit code comes back
    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nsys.exit(3)\n")
    assert tlaunch.launch(["--started_port=%d" % port, "--log_dir=%s" % (tmp_path / "bad"),
                           str(bad)]) == 3


def test_init_from_env_with_one_trainer_binds_nothing(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:1")
    g0 = tenv.generation()
    assert tenv.init_from_env() is None
    assert tenv.group_for_ring(0) is None and tenv.generation() == g0
    assert sys.modules["torch.distributed"].is_initialized() is False
