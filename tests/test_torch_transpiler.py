"""``transpiler.py`` and ``parallel/collective_transpiler.py`` of
paddle_tpu_torch against paddle_tpu on the same layer calls:

* ``DistributeTranspiler``: in "pserver" mode the trainer program's JSON
  and its ``_dense_ps_ctx``, and each pserver program's ``_pserver_ctx``,
  equal the JAX package's key for key (SGD, Momentum, Adam); "nccl2" mode
  hands off to ``GradAllReduce``, with the same rewritten main and startup
  programs; an optimizer the servers cannot run raises
  NotImplementedError, a program with no update ValueError, as there.
* ``GradAllReduce`` and ``LocalSGD`` (2 and 4 ranks, 1 and 2 rings): the
  rewritten main and startup programs equal the JAX package's, op for op,
  the bootstrap ops ``c_gen_nccl_id`` and ``c_comm_init`` included.
* ``InferenceTranspiler``: the same fold count, folded JSON and folded
  scope values (fp32, to 1e-6) as the JAX package's, on a conv without a
  bias (a new bias var) and with one (merged into it); the folded
  program's outputs within 1e-5 of the JAX package's unfolded ones, and
  through ``AnalysisPredictor`` after ``save_inference_model``.
* ``HashName`` and ``RoundRobin`` dispatch as the JAX package's;
  ``memory_optimize`` and ``release_memory`` are no-ops.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import transpiler as jtranspiler
from paddle_tpu.parallel import collective_transpiler as jcoll
from paddle_tpu_torch import transpiler as ttranspiler
from paddle_tpu_torch.parallel import collective_transpiler as tcoll

from torch_parity_util import _canon, assert_same_program, jax_startup_state, run_jax

PKG = {"jax": jfluid, "torch": tfluid}
TRANSPILER = {"jax": jtranspiler, "torch": ttranspiler}
COLL = {"jax": jcoll, "torch": tcoll}
OPTS = {"sgd": lambda f: f.optimizer.SGDOptimizer(0.2),
        "momentum": lambda f: f.optimizer.MomentumOptimizer(0.1, momentum=0.9),
        "adam": lambda f: f.optimizer.AdamOptimizer(0.01),
        "adadelta": lambda f: f.optimizer.AdadeltaOptimizer(0.1)}


def mlp(pkg, opt="sgd", minimize=True):
    fluid = PKG[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 5
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        if minimize:
            OPTS[opt](fluid).minimize(loss)
    return prog, startup, loss


def same_json(a, b):
    assert json.dumps(_canon(a), sort_keys=True) == json.dumps(_canon(b), sort_keys=True)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("sync", [True, False])
def test_pserver_mode_trainer_and_pserver_programs(opt, sync):
    eps = "127.0.0.1:6174,127.0.0.1:6175"
    out = {}
    for pkg in ("jax", "torch"):
        prog, _, _ = mlp(pkg, opt)
        t = TRANSPILER[pkg].DistributeTranspiler()
        t.transpile(1, program=prog, pservers=eps, trainers=2, sync_mode=sync)
        out[pkg] = (t.get_trainer_program(),
                    [t.get_pserver_programs(ep) for ep in eps.split(",")])
    (jt, jps), (tt, tps) = out["jax"], out["torch"]
    assert_same_program(jt, tt)
    assert set(jt._dense_ps_ctx) == set(tt._dense_ps_ctx)
    same_json(jt._dense_ps_ctx, tt._dense_ps_ctx)
    assert tt._dense_ps_ctx["trainer_id"] == 1 and tt._dense_ps_ctx["sync"] is sync
    assert len(tt._dense_ps_ctx["params"]) == 4  # two fc weights, two biases
    for (jp, js), (tp, ts) in zip(jps, tps):
        same_json(jp._pserver_ctx, tp._pserver_ctx)
        assert_same_program(jp, tp)
        assert_same_program(js, ts)
        assert not tp.global_block().ops and not ts.global_block().ops
    with pytest.raises(ValueError, match="not in pserver list"):
        t = ttranspiler.DistributeTranspiler()
        t.transpile(0, program=mlp("torch", opt)[0], pservers=eps, trainers=2)
        t.get_pserver_program("127.0.0.1:1")


@pytest.mark.parametrize("case", ["adadelta", "no_update"])
def test_unsupported_programs_raise_as_the_jax_package(case):
    errors = {}
    for pkg in ("jax", "torch"):
        prog, _, _ = mlp(pkg, "adadelta", minimize=case == "adadelta")
        with pytest.raises((NotImplementedError, ValueError)) as e:
            TRANSPILER[pkg].DistributeTranspiler().transpile(
                0, program=prog, pservers="127.0.0.1:6174", trainers=2)
        errors[pkg] = (type(e.value), str(e.value))
    assert errors["jax"] == errors["torch"]
    assert errors["torch"][0] is (NotImplementedError if case == "adadelta" else ValueError)


def test_nccl2_mode_hands_off_to_grad_allreduce():
    out = {}
    for pkg in ("jax", "torch"):
        prog, startup, _ = mlp(pkg, "momentum")
        cfg = TRANSPILER[pkg].DistributeTranspilerConfig()
        cfg.mode = "nccl2"
        t = TRANSPILER[pkg].DistributeTranspiler(cfg)
        t.transpile(1, program=prog, trainers=3, startup_program=startup)
        out[pkg] = (prog, startup)
        assert isinstance(t._collective, COLL[pkg].GradAllReduce)
    assert_same_program(out["jax"][0], out["torch"][0])
    assert_same_program(out["jax"][1], out["torch"][1])
    ops = [(op.type, op.attrs.get("nranks"), op.attrs.get("rank"))
           for op in out["torch"][1].global_block().ops[-2:]]
    assert ops == [("c_gen_nccl_id", None, None), ("c_comm_init", 3, 1)]


@pytest.mark.parametrize("kind,nranks,nrings", [("GradAllReduce", 2, 1), ("GradAllReduce", 4, 2),
                                                ("LocalSGD", 2, 1), ("LocalSGD", 4, 2)])
def test_collective_rewrites_equal_the_jax_packages(kind, nranks, nrings):
    out = {}
    for pkg in ("jax", "torch"):
        prog, startup, _ = mlp(pkg, "sgd")
        with PKG[pkg].unique_name.guard():
            rewriter = getattr(COLL[pkg], kind)(nrings=nrings)
            rewriter.transpile(startup, prog, 1, ["r%d" % i for i in range(nranks)], "r1")
        out[pkg] = (prog, startup)
    assert_same_program(out["jax"][0], out["torch"][0])
    assert_same_program(out["jax"][1], out["torch"][1])
    types = [op.type for op in out["torch"][0].global_block().ops]
    if kind == "GradAllReduce":
        assert types.count("c_allreduce_sum") == 4 and types.count("scale") >= 4
        rings = {op.attrs["ring_id"] for op in out["torch"][0].global_block().ops
                 if op.type == "c_allreduce_sum"}
        assert rings == set(range(nrings))
    else:
        assert types.count("local_sgd_select") == 4
    boot = [op.type for op in out["torch"][1].global_block().ops]
    assert boot.count("c_gen_nccl_id") == boot.count("c_comm_init") == nrings


def tied(pkg):
    """One [6, 6] weight used twice: its update reads the ``sum`` of two
    partial gradients (as BERT's word embedding, tied to the MLM output)."""
    fluid = PKG[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [6])
        for _ in range(2):
            x = fluid.layers.fc(x, 6, param_attr=fluid.ParamAttr(name="w_tied"), bias_attr=False,
                                act="tanh")
        loss = fluid.layers.mean(fluid.layers.fc(x, 1))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return prog, startup


def _reduced_update_grads(prog):
    """For each update op: whether its Grad is what a c_allreduce_sum wrote."""
    ops = prog.global_block().ops
    reduced = {op.outputs["Out"][0] for op in ops if op.type == "c_allreduce_sum"}
    return {op.inputs["Param"][0]: op.inputs["Grad"][0] in reduced
            for op in ops if op.attrs.get("op_role") == "optimize"}


def test_grad_allreduce_reduces_the_accumulated_gradient():
    """The one place the port's rewrite leaves the JAX package's: a
    parameter whose update reads ``<param>@GRAD@SUM`` has that sum
    reduced.  The JAX package reduces the first partial after the sum has
    read it, so its tied weight trains on each rank's own gradient (a fault
    of the reference, ROADMAP C5); every other op is the same."""
    out = {}
    for pkg in ("jax", "torch"):
        prog, startup = tied(pkg)
        COLL[pkg].GradAllReduce().transpile(startup, prog, 0, ["r0", "r1"], "r0")
        out[pkg] = prog
    assert _reduced_update_grads(out["torch"]) == {"w_tied": True, "fc_2.w_0": True,
                                                   "fc_2.b_0": True}
    assert _reduced_update_grads(out["jax"])["w_tied"] is False
    port, jax = (_canon(json.loads(out[k].to_json())) for k in ("torch", "jax"))
    assert port != jax
    # the port's desc with the reduced name put back is the JAX package's
    for op in port["blocks"][0]["ops"]:
        if op["type"] in ("c_allreduce_sum", "scale") and op["inputs"]["X"] == ["w_tied@GRAD@SUM"]:
            op["inputs"]["X"] = op["outputs"]["Out"] = ["w_tied@GRAD"]
    assert port == jax


def conv_bn(pkg, bias):
    """The JAX package's tests' two fold cases: conv2d (no bias) + BN +
    relu + pool + fc, and conv2d with its channel bias + BN + relu."""
    fluid = PKG[pkg]
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 52 if bias else 51
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        if bias:
            img = fluid.layers.data("img", [2, 6, 6])
            c = fluid.layers.conv2d(img, num_filters=3, filter_size=3, padding=1)
            out = fluid.layers.relu(fluid.layers.batch_norm(c))
        else:
            img = fluid.layers.data("img", [3, 8, 8])
            c = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                                    bias_attr=False)
            c = fluid.layers.relu(fluid.layers.batch_norm(c))
            c = fluid.layers.pool2d(c, pool_size=2, pool_stride=2, pool_type="max")
            out = fluid.layers.fc(fluid.layers.reshape(c, shape=[-1, 4 * 4 * 4]), 3,
                                  act="softmax")
    return prog, startup, out


@pytest.mark.parametrize("bias", [False, True])
def test_inference_transpiler_folds_as_the_jax_package(bias, tmp_path):
    jprog, jstartup, jout = conv_bn("jax", bias)
    rng = np.random.RandomState(12)
    state = jax_startup_state(jstartup, jprog)
    # BN statistics, scale and the conv bias off their init, so the fold is
    # not trivial (variances stay positive)
    state = {n: (v + rng.uniform(0.01, 0.1, v.shape).astype(v.dtype)) for n, v in state.items()}
    img = rng.uniform(-1, 1, (2,) + tuple(jprog.global_block().var("img").shape[1:]))
    feed = {"img": img.astype("float32")}
    jtest = jprog.clone(for_test=True)
    (want,) = run_jax(jtest, state, feed, [jout.name])[0][0:1][0]

    folded = {}
    for pkg in ("jax", "torch"):
        fluid = PKG[pkg]
        prog, _, out = conv_bn(pkg, bias)
        test_prog = prog.clone(for_test=True)
        if pkg == "jax":
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                for n, v in state.items():
                    scope.set(n, v)
            with fluid.unique_name.guard():
                n_folds = fluid.InferenceTranspiler().transpile(test_prog, fluid.CPUPlace(), scope)
            vals = {n: np.asarray(scope.get(n)) for n in scope.vars}
        else:
            scope = tfluid.Scope()
            tfluid.io.set_params_from_numpy(scope, state, "cpu")
            with fluid.unique_name.guard():
                n_folds = fluid.InferenceTranspiler().transpile(test_prog, fluid.CPUPlace(), scope)
            vals = {n: scope.get(n).numpy() for n in scope.vars}
        folded[pkg] = (test_prog, n_folds, vals, scope, out)
    (jp, jn, jvals, _, _), (tp, tn, tvals, tscope, tout) = folded["jax"], folded["torch"]
    assert jn == tn == 1
    assert_same_program(jp, tp)
    types = [op.type for op in tp.global_block().ops]
    assert "batch_norm" not in types and types.count("elementwise_add") == (1 if bias else 2)
    assert sorted(jvals) == sorted(tvals)
    for n in tvals:
        np.testing.assert_allclose(tvals[n], jvals[n], rtol=1e-6, atol=1e-7, err_msg=n)
    exe = tfluid.Executor(tfluid.CPUPlace())
    (got,) = exe.run(tp, feed=feed, fetch_list=[tout.name], scope=tscope)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    d = str(tmp_path / "folded")
    tfluid.io.save_inference_model(d, ["img"], [tout], exe, main_program=tp, scope=tscope)
    cfg = tfluid.inference.AnalysisConfig(d)
    cfg.disable_gpu()
    (served,) = tfluid.inference.create_paddle_predictor(cfg).run(feed)
    np.testing.assert_allclose(served, want, rtol=1e-5, atol=1e-6)


def test_hash_name_and_round_robin_dispatch_as_the_jax_package():
    prog, _, _ = mlp("torch")
    params = prog.all_parameters()
    eps = ["a:1", "b:2", "c:3"]
    assert (ttranspiler.HashName(eps).dispatch(params)
            == jtranspiler.HashName(eps).dispatch(params))
    jrr, trr = jtranspiler.RoundRobin(eps), ttranspiler.RoundRobin(eps)
    for _ in range(2):  # the cursor carries over calls
        assert trr.dispatch(params) == jrr.dispatch(params)
    assert trr.dispatch(params[:2]) == ["c:3", "a:1"]  # 8 dispatched before
    assert ttranspiler.memory_optimize(prog) is None and ttranspiler.release_memory(prog) is None
    assert tfluid.memory_optimize is ttranspiler.memory_optimize
