"""paddle_tpu_torch's fault injection against the JAX package's: the same
``PADDLE_TPU_FAULTS`` text and seed fire on the same hits in both
packages, and each of the port's fault points (``executor.run``,
``reader.prefetch``, ``ps.pull``, ``ps.push``, ``checkpoint.commit``,
``checkpoint.restore``) delivers what its README catalog row says."""
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu.faults as jfaults
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.faults as tfaults
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.monitor import REGISTRY as TREG
from paddle_tpu_torch.serving.errors import BackendUnavailable

PLANS = [
    "wire.send=error:ConnectionError,times=2",
    "ps.pull=delay:0.0,after=3",
    "executor.run=error,after=2,times=3;seed=7",
    "reader.prefetch=error:OSError,prob=0.4;seed=3",
    "ps.push=corrupt,times=1;ps.pull=error:TimeoutError,prob=0.5,after=1;seed=11",
    "checkpoint.commit=kill,after=4",
]


def _fire_pattern(faults, text, hits=40):
    """Which hits of each of the plan's points fire: the plan-local
    counts after driving each point ``hits`` times."""
    plan = faults.parse_plan(text)
    out = {}
    for point in plan.points:
        fired = []
        for i in range(hits):
            before = plan.triggers()[point]
            try:
                plan.faultpoint(point)  # a kill spec here has no pid: it only counts
            except Exception as e:  # noqa: BLE001 — an injected error is a firing
                fired.append((i, type(e).__name__))
                continue
            if plan.triggers()[point] > before:
                fired.append((i, "fired"))
        out[point] = fired
    return out


@pytest.mark.parametrize("text", PLANS)
def test_plans_fire_on_the_same_hits_in_both_packages(text):
    assert _fire_pattern(tfaults, text) == _fire_pattern(jfaults, text)


@pytest.mark.parametrize("bad", ["nopoint", "a.b=explode", "a.b=delay,bogus=1",
                                 "a.b=corrupt:x", "Bad.Point=error", "a.b=error:NoSuchError"])
def test_bad_plans_raise_in_both_packages(bad):
    for faults in (jfaults, tfaults):
        with pytest.raises(ValueError):
            faults.parse_plan(bad)


def test_env_arming_and_scoped_arming():
    plan = tfaults.arm_from_env({"PADDLE_TPU_FAULTS": "ps.pull=error,times=1",
                                 "PADDLE_TPU_FAULTS_SEED": "5"})
    try:
        assert tfaults.active is plan and plan.seed == 5
    finally:
        tfaults.disarm()
    assert tfaults.arm_from_env({}) is None and tfaults.active is None
    with pytest.raises(RuntimeError):
        with tfaults.armed("executor.run=error:RuntimeError"):
            assert tfaults.active is not None
            raise RuntimeError("body")
    assert tfaults.active is None


def test_corrupt_action_flips_the_framing_byte():
    plan = tfaults.parse_plan("wire.send=corrupt,times=1")
    act = plan.faultpoint("wire.send")
    data = bytes(range(256)) * 4
    bad = act.corrupt(data)
    assert bad[0] == data[0] ^ 0xFF and len(bad) == len(data)
    assert plan.faultpoint("wire.send") is None  # healed after one


def _tiny_program():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.data("y", [1])
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(tfluid.layers.fc(x, 1), y))
        tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def _batches(n):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(4, 4).astype("float32"), "y": rng.rand(4, 1).astype("float32")}
            for _ in range(n)]


def test_executor_run_error_surfaces_typed_from_train_from_dataset():
    main, startup, loss = _tiny_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    before = TREG.value("faults_injected_total", point="executor.run")
    with tfaults.armed("executor.run=error,after=2,times=1") as plan:
        with pytest.raises(BackendUnavailable, match="executor.run"):
            exe.train_from_dataset(main, _batches(5), scope=scope, fetch_list=[loss])
        assert plan.triggers() == {"executor.run": 1}
        # healed: the next epoch runs every step
        assert len(exe.train_from_dataset(main, _batches(5), scope=scope,
                                          fetch_list=[loss])) == 5
    assert TREG.value("faults_injected_total", point="executor.run") == before + 1


def test_executor_run_kill_passes_its_own_pid(monkeypatch):
    """The kill mode SIGKILLs the process that hits executor.run."""
    killed = []
    monkeypatch.setattr(tfaults.os, "kill", lambda pid, sig: killed.append((pid, sig)))
    main, startup, loss = _tiny_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfaults.armed("executor.run=kill,after=1"):
        exe.run(startup, scope=scope)
        exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    import signal

    assert killed == [(os.getpid(), signal.SIGKILL)]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "ptpu-prefetch" and t.is_alive()]


def test_reader_prefetch_error_surfaces_typed_and_the_producer_ends():
    base = len(_prefetch_threads())
    with tfaults.armed("reader.prefetch=error:OSError,after=2,times=1"):
        gen = treader.device_buffered(lambda: iter(range(10)), size=2, device=None)()
        got = [next(gen), next(gen)]
        with pytest.raises(OSError, match="reader.prefetch"):
            next(gen)
    assert got == [0, 1]
    deadline = time.time() + 5
    while len(_prefetch_threads()) > base and time.time() < deadline:
        time.sleep(0.01)
    assert len(_prefetch_threads()) == base


def test_reader_prefetch_error_through_train_from_dataset():
    main, startup, loss = _tiny_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with tfaults.armed("reader.prefetch=error:OSError,after=3,times=1"):
        with pytest.raises(OSError):
            exe.train_from_dataset(main, _batches(6), scope=scope, thread=2, fetch_list=[loss])


@pytest.fixture
def ps_client():
    s1, s2 = tps.ParameterServer().start(), tps.ParameterServer().start()
    cli = tps.PSClient([s1.endpoint, s2.endpoint])
    cli.create_table("emb", 4, initializer="zeros", optimizer="sgd", lr=1.0)
    yield cli
    cli.close()
    s1.stop()
    s2.stop()


@pytest.mark.parametrize("point", ["ps.pull", "ps.push"])
def test_ps_points_raise_typed_then_heal(ps_client, point):
    ids = np.arange(6, dtype=np.int64)
    grads = -np.ones((6, 4), np.float32)
    call = ((lambda: ps_client.pull_sparse("emb", ids)) if point == "ps.pull"
            else (lambda: ps_client.push_sparse("emb", ids, grads)))
    with tfaults.armed("%s=error:ConnectionError,times=1" % point) as plan:
        with pytest.raises(ConnectionError, match=point):
            call()
        call()  # healed
        assert plan.triggers() == {point: 1}
    rows = ps_client.pull_sparse("emb", ids)
    np.testing.assert_array_equal(rows, np.ones((6, 4)) if point == "ps.push" else np.zeros((6, 4)))


def test_ps_pull_delay_is_applied(ps_client):
    ids = np.arange(4, dtype=np.int64)
    with tfaults.armed("ps.pull=delay:0.2,times=1"):
        t = time.perf_counter()
        ps_client.pull_sparse("emb", ids)
        assert time.perf_counter() - t >= 0.2


def test_disarmed_points_cost_nothing_observable():
    assert tfaults.active is None
    main, startup, loss = _tiny_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out = exe.train_from_dataset(main, _batches(3), scope=scope, fetch_list=[loss], thread=2)
    assert len(out) == 3
