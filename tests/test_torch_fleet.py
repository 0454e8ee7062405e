"""Fleet in paddle_tpu_torch (``parallel/fleet.py``, ``incubate/fleet/``)
against the JAX package's, each in this process:

* the role makers under the same launcher environment (``monkeypatch``),
  and ``MPISymetricRoleMaker``'s refusal without mpi4py;
* ``Fleet.init``'s start of ``torch.distributed`` (the JAX package's
  ``jax.distributed.initialize``) only for trainers on several hosts with
  ``PADDLE_TPU_DISTRIBUTED_INIT=1``;
* the ``incubate.fleet`` import paths export the same names;
* ``DistributedOptimizer.minimize`` as tests/test_distributed.py's
  ``test_fleet_collective_minimize``: a CompiledProgram whose six SGD
  steps from the JAX package's startup state give the JAX fleet's losses
  (its CompiledProgram over 8 virtual devices; the port's over the world's
  ranks) within 1e-5;
* ``fleet.save_inference_model`` writes the JAX fleet's ``__model__``
  desc, and ``fleet.save_persistables`` the same file names;
* ``build_hybrid_train_step`` on 4 gloo ranks (``{"dp": 2, "tp": 2}``,
  tests/test_hybrid_parallel.py's Adam with L2 decay) gives, bit for bit,
  the losses and parameters of ``make_train_step`` called directly, and
  its second loss is below its first, as the JAX package's
  ``test_fleet_api_reaches_hybrid_engine`` asks.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import fleet_mod as jfleet
from paddle_tpu_torch.parallel import fleet_mod as tfleet
from torch_mesh_child import launch_ranks
from torch_parity_util import _canon, jax_startup_state, run_jax, run_port

ENVS = {
    "trainer": {"PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170,10.0.0.2:6170",
                "PADDLE_PSERVER_ENDPOINTS": "", "TRAINING_ROLE": "trainer",
                "PADDLE_TRAINER_ID": "1"},
    "pserver": {"PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:6170",
                "PADDLE_PSERVER_ENDPOINTS": "127.0.0.1:6174,127.0.0.1:6175",
                "TRAINING_ROLE": "PSERVER", "PADDLE_TRAINER_ID": "0"},
    "unset": {},
}
ENV_KEYS = ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_PSERVER_ENDPOINTS", "TRAINING_ROLE",
            "PADDLE_TRAINER_ID", "PADDLE_TPU_DISTRIBUTED_INIT")


def _role_view(rm):
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(), rm.worker_index(),
            rm.server_index(), rm.worker_num(), rm.server_num(), rm.get_trainer_endpoints(),
            rm.get_pserver_endpoints())


def _fleet_view(f):
    return (f.is_worker(), f.is_server(), f.is_first_worker(), f.worker_index(), f.worker_num(),
            f.worker_endpoints(), f.worker_endpoints(to_string=True), f.server_endpoints(),
            f.server_endpoints(to_string=True))


def _set_env(monkeypatch, env):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", list(ENVS))
def test_paddle_cloud_role_maker_reads_the_launchers_environment(env, monkeypatch):
    _set_env(monkeypatch, ENVS[env])
    j, t = jfleet.PaddleCloudRoleMaker(), tfleet.PaddleCloudRoleMaker()
    assert _role_view(t) == _role_view(j)
    jf, tf = jfleet.Fleet(), tfleet.Fleet()
    assert _fleet_view(tf) == _fleet_view(jf)  # before init
    assert _fleet_view(tf.init(t)) == _fleet_view(jf.init(j))


@pytest.mark.parametrize("make", [
    lambda m: m.UserDefinedRoleMaker(current_id=2, role=m.Role.WORKER, worker_num=3),
    lambda m: m.UserDefinedRoleMaker(current_id=0, role=m.Role.SERVER,
                                     server_endpoints=["127.0.0.1:7000"]),
    lambda m: m.UserDefinedCollectiveRoleMaker(current_id=1, worker_endpoints=["a:1", "b:2"]),
    lambda m: m.UserDefinedCollectiveRoleMaker(),
], ids=["user_worker", "user_server", "collective", "collective_default"])
def test_user_defined_role_makers_match_jax(make):
    j, t = make(jfleet), make(tfleet)
    assert _role_view(t) == _role_view(j)
    jf, tf = jfleet.Fleet(), tfleet.Fleet()
    assert _fleet_view(tf.init(t)) == _fleet_view(jf.init(j))


def test_mpi_role_maker_needs_mpi4py():
    with pytest.raises(RuntimeError) as want:
        jfleet.MPISymetricRoleMaker().generate_role()
    with pytest.raises(RuntimeError) as got:
        tfleet.MPISymetricRoleMaker().generate_role()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("endpoints,flag,starts", [
    ("10.0.0.1:6170,10.0.0.2:6170", "1", True),
    ("10.0.0.1:6170,10.0.0.2:6170", "0", False),
    ("127.0.0.1:6170,127.0.0.1:6171", "1", False),
], ids=["two_hosts", "two_hosts_flag_off", "one_host"])
def test_init_starts_torch_distributed_only_across_hosts(endpoints, flag, starts, monkeypatch):
    _set_env(monkeypatch, {"PADDLE_TRAINER_ENDPOINTS": endpoints, "PADDLE_TRAINER_ID": "0",
                           "PADDLE_TPU_DISTRIBUTED_INIT": flag})
    calls = []
    monkeypatch.setattr(tfleet.penv, "init_from_env", lambda *a, **k: calls.append(a))
    tfleet.Fleet().init()
    assert calls == ([()] if starts else [])


@pytest.mark.parametrize("path", ["incubate.fleet.collective", "incubate.fleet.base.role_maker",
                                  "incubate.fleet.parameter_server"])
def test_incubate_fleet_import_paths_export_the_same_names(path):
    import importlib

    jmod = importlib.import_module("paddle_tpu." + path)
    tmod = importlib.import_module("paddle_tpu_torch." + path)
    assert tmod.__all__ == jmod.__all__
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        assert type(obj).__name__ == type(getattr(jmod, name)).__name__
        assert (getattr(obj, "__module__", "") or type(obj).__module__).startswith(
            "paddle_tpu_torch.")
    base = importlib.import_module("paddle_tpu_torch.incubate.fleet.base")
    assert base.role_maker.PaddleCloudRoleMaker is tfleet.PaddleCloudRoleMaker
    assert tfluid.incubate.fleet.collective.fleet is tfleet.fleet is tfluid.parallel.fleet


def _fc_program(fluid, fleet_, seed=3):
    """tests/test_distributed.py::test_fleet_collective_minimize's model."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fleet_.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1)).minimize(loss)
    return prog, startup, loss, pred


def _fc_batch():
    rng = np.random.RandomState(0)
    xb = rng.uniform(-1, 1, (16, 8)).astype("float32")
    return {"x": xb, "y": xb.sum(1, keepdims=True).astype("float32") * 0.2}


def test_distributed_optimizer_minimize_trains_as_the_jax_fleet():
    jf, tf = jfleet.Fleet(), tfleet.Fleet()
    jf.init(jfleet.UserDefinedRoleMaker(current_id=0, worker_num=1))
    tf.init(tfleet.UserDefinedRoleMaker(current_id=0, worker_num=1))
    assert tf.is_first_worker() and tf.worker_num() == 1
    jprog, jstart, jloss, _ = _fc_program(jfluid, jf)
    tprog, _, tloss, _ = _fc_program(tfluid, tf)
    compiled = tf.main_program
    assert getattr(compiled, "_is_compiled_program", False)
    assert compiled._strategy.mesh_axes == {"dp": 1}  # the world's ranks: this process
    state = jax_startup_state(jstart, jprog)
    want, _ = run_jax(jf.main_program, state, _fc_batch(), [jloss], steps=6)
    got, _ = run_port(compiled, state, _fc_batch(), [tloss], steps=6)
    want = [float(np.asarray(w[0]).reshape(-1)[0]) for w in want]
    got = [float(np.asarray(g[0]).reshape(-1)[0]) for g in got]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_fleet_saves_the_jax_fleets_inference_model_and_persistables(tmp_path):
    jf, tf = jfleet.Fleet(), tfleet.Fleet()
    jprog, jstart, _, jpred = _fc_program(jfluid, jf)
    tprog, tstart, _, tpred = _fc_program(tfluid, tf)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        jf.save_inference_model(jexe, str(tmp_path / "jax"), ["x"], [jpred], main_program=jprog)
        jf.save_persistables(jexe, str(tmp_path / "jax_p"), main_program=jprog)
    texe.run(tstart, scope=scope)
    with tfluid.scope_guard(scope):
        tf.save_inference_model(texe, str(tmp_path / "port"), ["x"], [tpred], main_program=tprog)
        tf.save_persistables(texe, str(tmp_path / "port_p"), main_program=tprog)
    want = _canon(json.loads((tmp_path / "jax" / "__model__").read_text()))
    got = _canon(json.loads((tmp_path / "port" / "__model__").read_text()))
    assert got == want
    assert sorted(p.name for p in (tmp_path / "port_p").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax_p").iterdir())


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    axes = {"dp": 2, "tp": 2}
    scen = [["hybrid:direct", {"axes": axes, "seed": 1, "steps": 2, "adam": True}],
            ["hybrid:fleet", {"axes": axes, "seed": 1, "steps": 2, "via_fleet": True}]]
    return launch_ranks(str(tmp_path_factory.mktemp("fleet_hybrid")), 4, scen)


def test_build_hybrid_train_step_is_make_train_step(hybrid_runs):
    direct, via = hybrid_runs["hybrid:direct"], hybrid_runs["hybrid:fleet"]
    for d, f in zip(direct, via):
        assert f["losses"] == d["losses"] and f["shard_shapes"] == d["shard_shapes"]
        assert np.isfinite(f["losses"]).all() and f["losses"][1] < f["losses"][0]
    assert via[0]["params"] == direct[0]["params"]


def test_build_hybrid_train_step_needs_the_hybrid_strategy():
    with pytest.raises(ValueError, match="DistributedStrategy.hybrid"):
        tfleet.Fleet().distributed_optimizer(
            tfluid.optimizer.SGDOptimizer(0.1)).build_hybrid_train_step()
