"""``python -m paddle_tpu_torch.tools.train_top`` (the port's copy of the
JAX package's training console, stdlib only) on the CPU: one frame
against a real trainer's admin (phase bars, throughput, watchdog, the
step table), the offline ``--replay`` of the run's step log, and a dead
address exiting 1."""
import io
import sys

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.tools import train_top


def _frame(argv):
    out, real = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        rc = train_top.main(argv)
    finally:
        sys.stdout = real
    return rc, out.getvalue()


def test_train_top_once_renders_a_live_training_run(tmp_path):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 27
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [6])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(0.05).minimize(loss)
    rng = np.random.RandomState(9)
    feeds = [{"x": rng.randn(4, 6).astype("float32"), "y": rng.randn(4, 1).astype("float32")}
             for _ in range(6)]
    log = str(tmp_path / "steps.jsonl")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.train_from_dataset(program=prog, dataset=feeds, scope=scope, fetch_list=[loss],
                           phase_ledger=True, watchdog=True, train_log=log)
    host, port = exe.start_train_admin(port=0)
    try:
        rc, frame = _frame(["%s:%d" % (host, port), "--once", "--no-color"])
        assert rc == 0
        assert "PHASE" in frame and "device_execute" in frame
        assert "WATCHDOG" in frame and "throughput" in frame and "STEP" in frame
        rc, replay = _frame(["--replay", log, "--no-color"])
        assert rc == 0 and "PHASE" in replay and "steps 6" in replay
        assert train_top.main(["127.0.0.1:1", "--once", "--no-color"]) == 1
    finally:
        exe.stop_train_admin()
