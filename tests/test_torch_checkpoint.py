"""paddle_tpu_torch's training checkpoints (faults/checkpoint.py) and
train_from_dataset's crash-resume, against the JAX package's.

Both packages write the same directory format, file for file: a 3-step
JAX checkpoint restores in the port and the next 2 steps' losses match
the JAX run within 1e-5 (fp32 on the CPU: summation order), a port
checkpoint restores in the JAX package with the same result, and the two
integrity manifests list the same files.  Then the port's own contract:
the async snapshot is a copy, integrity fallback, the fault points of
the save and restore paths, PS tables, fork-a-run resume, and the SIGKILL
drill (``tests/torch_train_child.py``): kill, resume, per-step loss
continuity (bit for bit: one process, one CPU)."""
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.faults as tfaults
from paddle_tpu.faults import checkpoint as jckpt
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.faults import checkpoint as tckpt
from paddle_tpu_torch.monitor import REGISTRY as TREG
from paddle_tpu_torch.monitor import events as tevents

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # fp32 on the CPU, the two packages' summation orders


def _program(fluid, opt="adam"):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 21
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [6])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 8, act="relu")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        (fluid.optimizer.AdamOptimizer(0.05) if opt == "adam"
         else fluid.optimizer.SGDOptimizer(0.1)).minimize(loss)
    return main, startup, loss


def _batches(n):
    out = []
    for i in range(n):
        rng = np.random.RandomState(50 + i)
        x = rng.randn(8, 6).astype("float32")
        out.append({"x": x, "y": (x[:, :2].sum(1, keepdims=True)).astype("float32")})
    return out


def _run(fluid, place, run_dir=None, resume_from=None, n=5, every=3, scope_init=None, **kw):
    main, startup, loss = _program(fluid)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        if scope_init is not None:
            scope_init(scope)
        out = exe.train_from_dataset(program=main, dataset=_batches(n), scope=scope,
                                     fetch_list=[loss], checkpoint_dir=run_dir,
                                     checkpoint_every=every, resume_from=resume_from, **kw)
    return exe, scope, [float(np.asarray(o[0]).reshape(-1)[0]) for o in out]


def _jax_state(scope):
    return {n: np.asarray(scope.find_var(n).get_tensor()) for n in scope.local_var_names()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ckpt") / "run")
    exe, scope, losses = _run(jfluid, jfluid.CPUPlace(), run_dir=d)
    init = {}
    # the JAX run's initial state, for the port's from-scratch run
    _, s0, _ = _run(jfluid, jfluid.CPUPlace(), n=0)
    init = _jax_state(s0)
    return d, losses, init


def _port_from(init):
    def load(scope):
        for n, a in init.items():
            scope.set(n, np.asarray(a))
    return load


def test_a_jax_checkpoint_restores_in_the_port(jax_run):
    d, jl, _ = jax_run
    exe, _, tl = _run(tfluid, tfluid.CPUPlace(), resume_from=d)
    assert exe.last_resume_step == 3 and exe.last_restore_path.endswith("ckpt-000003")
    np.testing.assert_allclose(tl, jl[3:], rtol=TOL, atol=TOL)


def test_a_port_checkpoint_restores_in_the_jax_package(jax_run, tmp_path):
    _, jl, init = jax_run
    d = str(tmp_path / "run")
    _, _, tl = _run(tfluid, tfluid.CPUPlace(), run_dir=d, scope_init=_port_from(init))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    exe, _, jl2 = _run(jfluid, jfluid.CPUPlace(), resume_from=d)
    assert exe.last_resume_step == 3
    np.testing.assert_allclose(jl2, tl[3:], rtol=TOL, atol=TOL)


def test_the_manifests_list_the_same_files(jax_run, tmp_path):
    d, _, init = jax_run
    d2 = str(tmp_path / "run")
    _run(tfluid, tfluid.CPUPlace(), run_dir=d2, scope_init=_port_from(init))
    for name in ("ckpt-000003",):
        docs = [json.load(open(os.path.join(r, name, "integrity.json"))) for r in (d, d2)]
        assert sorted(docs[0]["files"]) == sorted(docs[1]["files"])
        assert docs[0]["algo"] == docs[1]["algo"] == "sha256"
        curs = [json.load(open(os.path.join(r, name, "cursor.json"))) for r in (d, d2)]
        assert curs[0] == curs[1] == {"step": 3, "epoch": 0}
    assert open(os.path.join(d, "LATEST")).read() == open(os.path.join(d2, "LATEST")).read()


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_resume_continues_bit_for_bit(tmp_path, async_):
    d = str(tmp_path / "run")
    _, _, full = _run(tfluid, tfluid.CPUPlace(), run_dir=d, n=8, every=3,
                      checkpoint_async=async_)
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt-000003", "ckpt-000006"]  # keep=2
    exe, _, tail = _run(tfluid, tfluid.CPUPlace(), resume_from=d, n=8)
    assert exe.last_resume_step == 6 and tail == full[6:]
    assert [c["step"] for c in _run(tfluid, tfluid.CPUPlace(), run_dir=str(tmp_path / "r2"),
                                    n=7, every=3)[0].last_checkpoints] == [3, 6]


def test_save_async_snapshot_is_a_copy(tmp_path):
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    want = {n: t.clone() for n, t in scope.vars.items()}
    ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
    ck.save_async(main, scope, step=1)
    for t in scope.vars.values():  # the live scope changes in place at once
        t.add_(5.0)
    assert ck.wait().endswith("ckpt-000001")
    fresh = tfluid.Scope(device="cpu")
    ck.restore(main, fresh)
    for n, t in want.items():
        assert torch.equal(fresh.vars[n], t), n


def test_restore_writes_in_place_and_keeps_dtypes(tmp_path):
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    name = sorted(n for n in scope.vars if n.endswith(".w_0"))[0]
    scope.vars[name] = scope.vars[name].to(torch.bfloat16)
    want = {n: t.clone() for n, t in scope.vars.items()}
    ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
    ck.save(main, scope, step=2)
    held = dict(scope.vars)
    for t in scope.vars.values():
        t.zero_()
    assert ck.restore(main, scope) == {"step": 2, "epoch": 0}
    for n, t in want.items():
        assert scope.vars[n] is held[n] and scope.vars[n].dtype == t.dtype and torch.equal(
            scope.vars[n], t), n


def test_a_jax_bf16_array_restores_as_bf16(tmp_path):
    """The JAX package writes a bf16 persistable as raw 2-byte values
    (numpy has no bfloat16); the port brings it back as bf16."""
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
    path = ck.save(main, scope, step=1)
    name = sorted(n for n in scope.vars if n.endswith(".w_0"))[0]
    bf = scope.vars[name].to(torch.bfloat16)
    raw = bf.view(torch.int16).numpy().view("V2")
    np.save(os.path.join(path, "params", name + ".npy"), raw)
    os.remove(os.path.join(path, "integrity.json"))
    ck._write_integrity(path)  # re-hash the doctored file
    fresh = tfluid.Scope(device="cpu")
    ck.restore(main, fresh)
    assert fresh.vars[name].dtype == torch.float32  # the program var is fp32
    assert torch.equal(fresh.vars[name], bf.float())
    fresh.vars[name] = torch.zeros_like(bf)  # a bf16 scope tensor stays bf16
    ck.restore(main, fresh)
    assert fresh.vars[name].dtype == torch.bfloat16 and torch.equal(fresh.vars[name], bf)


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 3)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def test_a_corrupt_newest_checkpoint_falls_back(tmp_path):
    d = str(tmp_path / "run")
    _, _, full = _run(tfluid, tfluid.CPUPlace(), run_dir=d, n=8, every=3)
    newest = os.path.join(d, "ckpt-000006", "params")
    _flip(os.path.join(newest, sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]))
    corrupt0 = TREG.value("train_checkpoint_corruption_total")
    fall0 = TREG.value("train_checkpoint_fallback_total")
    seq0 = max((e["seq"] for e in tevents.eventz()["events"]), default=-1)
    exe, _, tail = _run(tfluid, tfluid.CPUPlace(), resume_from=d, n=8)
    assert exe.last_resume_step == 3 and exe.last_restore_fallbacks == 1
    assert tail == full[3:]
    assert TREG.value("train_checkpoint_corruption_total") == corrupt0 + 1
    assert TREG.value("train_checkpoint_fallback_total") == fall0 + 1
    ev = [e for e in tevents.eventz()["events"] if e["seq"] > seq0 and e["kind"] == "train/resume"]
    assert ev[-1]["severity"] == "warning" and ev[-1]["fallbacks"] == 1


@pytest.mark.parametrize("damage", ["flip", "truncate", "extra", "missing", "manifest"])
def test_verify_checkpoint_dir_catches_damage(tmp_path, damage):
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    path = tckpt.TrainCheckpoint(str(tmp_path / "run")).save(main, scope, step=1)
    tckpt.verify_checkpoint_dir(path)
    p = os.path.join(path, "cursor.json")
    if damage == "flip":
        _flip(p)
    elif damage == "truncate":
        open(p, "w").write("{")
    elif damage == "extra":
        open(os.path.join(path, "params", "stray.npy"), "w").write("x")
    elif damage == "missing":
        os.remove(p)
    else:
        open(os.path.join(path, "integrity.json"), "w").write("[]")
    with pytest.raises(tckpt.CheckpointCorruptionError):
        tckpt.verify_checkpoint_dir(path)
    with pytest.raises(jckpt.CheckpointCorruptionError):
        jckpt.verify_checkpoint_dir(path)  # the JAX package reads the same manifest alike


def test_every_checkpoint_corrupt_raises_and_a_lost_run_dir_raises(tmp_path):
    d = str(tmp_path / "run")
    _run(tfluid, tfluid.CPUPlace(), run_dir=d, n=6, every=3)
    for name in ("ckpt-000003", "ckpt-000006"):
        _flip(os.path.join(d, name, "cursor.json"))
    main, startup, _ = _program(tfluid)
    scope = tfluid.Scope(device="cpu")
    with pytest.raises(tckpt.CheckpointCorruptionError):
        tckpt.TrainCheckpoint(d).restore(main, scope)
    for name in ("ckpt-000003", "ckpt-000006"):
        shutil.rmtree(os.path.join(d, name))
    with pytest.raises(tckpt.CheckpointCorruptionError, match="LATEST"):
        tckpt.TrainCheckpoint(d).restore(main, scope)
    assert tckpt.TrainCheckpoint(str(tmp_path / "empty")).restore(main, scope) is None


def test_a_dangling_latest_falls_back_counted(tmp_path):
    d = str(tmp_path / "run")
    _run(tfluid, tfluid.CPUPlace(), run_dir=d, n=6, every=3)
    open(os.path.join(d, "LATEST"), "w").write("ckpt-000009\n")
    exe, _, _ = _run(tfluid, tfluid.CPUPlace(), resume_from=d, n=6)
    assert exe.last_resume_step == 6 and exe.last_restore_fallbacks == 1


def test_checkpoint_commit_fault_leaves_the_previous_checkpoint(tmp_path):
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
    ck.save(main, scope, step=1)
    with tfaults.armed("checkpoint.commit=error:OSError,times=1"):
        with pytest.raises(OSError, match="checkpoint.commit"):
            ck.save(main, scope, step=2)
        assert ck.latest().endswith("ckpt-000001")
        ck.save_async(main, scope, step=3)  # healed; the staged tmp of step 2 is stale
        ck.wait()
    assert ck.latest().endswith("ckpt-000003")


def test_checkpoint_restore_fault_is_armed_on_the_read_side(tmp_path):
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
    ck.save(main, scope, step=1)
    with tfaults.armed("checkpoint.restore=error:TimeoutError,times=1") as plan:
        with pytest.raises(TimeoutError):
            ck.restore(main, scope)
        assert ck.restore(main, scope)["step"] == 1
        assert plan.triggers() == {"checkpoint.restore": 1}


def test_fork_a_run_restores_from_one_dir_and_saves_to_another(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _run(tfluid, tfluid.CPUPlace(), run_dir=a, n=6, every=3)
    exe, _, _ = _run(tfluid, tfluid.CPUPlace(), run_dir=b, resume_from=a, n=12, every=3)
    assert exe.last_resume_step == 6
    assert sorted(os.listdir(b)) == ["LATEST", "ckpt-000009", "ckpt-000012"]
    assert sorted(os.listdir(a)) == ["LATEST", "ckpt-000003", "ckpt-000006"]


def test_ps_tables_ride_the_checkpoint(tmp_path):
    s1, s2 = tps.ParameterServer().start(), tps.ParameterServer().start()
    try:
        cli = tps.PSClient([s1.endpoint, s2.endpoint])
        cli.create_table("emb", 4, initializer="zeros", optimizer="adagrad", lr=0.5)
        ids = np.arange(10, dtype=np.int64)
        cli.push_sparse("emb", ids, np.ones((10, 4), np.float32))
        want = cli.pull_sparse("emb", ids)
        main, startup, loss = _program(tfluid)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
        path = ck.save(main, scope, step=1, ps_client=cli)
        assert os.path.exists(os.path.join(path, "ps", "t000_moments.npy"))
        cli.push_sparse("emb", ids, np.ones((10, 4), np.float32))
        with pytest.raises(ValueError, match="ps_client"):
            ck.restore(main, scope)
        ck.restore(main, scope, ps_client=cli)
        np.testing.assert_array_equal(cli.pull_sparse("emb", ids), want)
        cli.close()
    finally:
        s1.stop()
        s2.stop()


def test_sharded_checkpoints_wait_for_a10(tmp_path):
    """A compiled program at one rank holds its state whole: save(compiled=)
    writes no shards/ and restore(compiled=) reads it back (the shard-wise
    mode across ranks: tests/test_torch_sharded_training.py).  A
    mesh-resident table's entry is ROADMAP A10 part 4 and raises."""
    main, startup, loss = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope(device="cpu")
    exe.run(startup, scope=scope)
    compiled = tfluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    ck = tckpt.TrainCheckpoint(str(tmp_path / "run"))
    path = ck.save(main, scope, 1, compiled=compiled)
    assert not os.path.isdir(os.path.join(path, "shards"))
    ck.save_async(main, scope, 2, compiled=compiled)
    ck.wait()
    fresh = tfluid.Scope(device="cpu")
    exe.run(startup, scope=fresh)
    assert ck.restore(main, fresh, compiled=compiled)["step"] == 2
    for n, v in scope.vars.items():
        if n in fresh.vars:
            torch.testing.assert_close(fresh.vars[n], v, rtol=0, atol=0)
    ck_dir = os.path.join(str(tmp_path / "run"), "ckpt-000002")
    os.remove(os.path.join(ck_dir, "integrity.json"))
    os.makedirs(os.path.join(ck_dir, "shards"))
    with open(os.path.join(ck_dir, "shards", "manifest.json"), "w") as f:
        json.dump({"mesh_axes": {"dp": 1}, "vars": {"emb": {
            "kind": "mesh_table", "table": "emb", "shape": [4, 2], "dtype": "float32",
            "spec": ["dp"], "shards": []}}}, f)
    with pytest.raises(NotImplementedError, match="A10 part 4"):
        ck.restore(main, fresh, compiled=compiled)


# ---------------------------------------------------------------------------
# the SIGKILL drill, on the CPU
# ---------------------------------------------------------------------------
def _spawn(run_dir, steps, delay, resume=False, async_=False, plan=None):
    argv = [sys.executable, "-u", os.path.join(REPO_ROOT, "tests", "torch_train_child.py"),
            "--run-dir", run_dir, "--steps", str(steps), "--ckpt-every", "5",
            "--step-delay", str(delay)] + (["--resume"] if resume else []) + (
        ["--async-ckpt"] if async_ else [])
    env = dict(os.environ)
    env.pop("PADDLE_TPU_FAULTS", None)
    if plan:
        env["PADDLE_TPU_FAULTS"] = plan
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _losses(text):
    return {int(ln.split()[1]): ln.split()[2] for ln in text.splitlines()
            if ln.startswith("STEP ")}


def test_sigkill_then_resume_loss_continuity(tmp_path):
    """The parent kills a training child after its first checkpoint; the
    resumed child starts at the cursor and its losses equal the killed
    run's on every overlapping step."""
    run_dir = str(tmp_path / "run")
    proc = _spawn(run_dir, steps=400, delay=0.05)
    lines = []
    drain = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    drain.start()
    latest = os.path.join(run_dir, "LATEST")
    deadline = time.monotonic() + 120
    try:
        while not os.path.exists(latest):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.02)
        cursor = int(open(latest).read().strip().rsplit("-", 1)[1])
        while max(_losses("".join(lines)) or [0]) < cursor + 2:  # run past the checkpoint
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        drain.join(timeout=30)
        out = "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -9
    killed = _losses(out)
    cursor = int(open(latest).read().strip().rsplit("-", 1)[1])
    assert cursor % 5 == 0 and max(killed) >= cursor
    res = _spawn(run_dir, steps=cursor + 4, delay=0.0, resume=True)
    rout, rerr = res.communicate(timeout=120)
    assert res.returncode == 0, rerr
    assert "RESUMED_FROM %d" % cursor in rout
    resumed = _losses(rout)
    assert min(resumed) == cursor
    overlap = sorted(set(killed) & set(resumed))
    assert overlap
    for step in overlap:
        assert resumed[step] == killed[step], step


def test_an_armed_kill_mid_epoch_then_resume(tmp_path):
    """The child arms ``executor.run=kill`` itself (its 13th run: the
    startup and steps 0 to 10, then death at step 11); the async save of
    step 10 commits first because the plan delays the fatal run."""
    run_dir = str(tmp_path / "run")
    proc = _spawn(run_dir, steps=20, delay=0.0, async_=True,
                  plan="executor.run=delay:1.0,after=12,times=1;executor.run=kill,after=12")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == -9, err
    killed = _losses(out)
    assert sorted(killed) == list(range(11))
    assert open(os.path.join(run_dir, "LATEST")).read().strip() == "ckpt-000010"
    tckpt.verify_checkpoint_dir(os.path.join(run_dir, "ckpt-000010"))
    res = _spawn(run_dir, steps=14, delay=0.0, resume=True, async_=True)
    rout, rerr = res.communicate(timeout=120)
    assert res.returncode == 0, rerr
    resumed = _losses(rout)
    assert sorted(resumed) == [10, 11, 12, 13] and resumed[10] == killed[10]
