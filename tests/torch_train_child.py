"""Child process for the port's SIGKILL-and-resume drill (the JAX
package's ``tests/chaos/_train_child.py`` on paddle_tpu_torch, on the CPU).

Trains a small regression program with checkpointing and prints one
``STEP <global step> <loss as float.hex>`` line per step as it returns.
Batches are a function of the global step index, so a resumed run
regenerates the batches the killed run would have consumed.  A plan in
``PADDLE_TPU_FAULTS`` (``executor.run=kill,...``) makes the child kill
itself; otherwise the parent kills it.  Not a test module.
"""
import argparse
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402

W_TRUE = np.array([[0.5], [-1.0], [2.0], [0.25]], np.float32)


def build_model():
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 17
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.AdamOptimizer(0.05).minimize(loss)
    return prog, startup, loss


def batches(n_steps, step_delay):
    for i in range(n_steps):
        rng = np.random.RandomState(1000 + i)  # keyed by the GLOBAL step
        x = rng.uniform(-1, 1, (8, 4)).astype("float32")
        if step_delay:
            time.sleep(step_delay)
        yield {"x": x, "y": (x @ W_TRUE + 0.05 * rng.standard_normal((8, 1))).astype("float32")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--step-delay", type=float, default=0.0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--async-ckpt", action="store_true")
    args = ap.parse_args()
    prog, startup, loss = build_model()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    run, calls = exe.run, []

    def logged(program=None, feed=None, **kw):
        out = run(program, feed=feed, **kw)
        step = (exe.last_resume_step or 0) + len(calls)
        calls.append(step)
        print("STEP %d %s" % (step, float(np.asarray(out[0]).reshape(-1)[0]).hex()), flush=True)
        return out

    exe.run = logged
    exe.train_from_dataset(prog, batches(args.steps, args.step_delay), scope=scope,
                           fetch_list=[loss], checkpoint_dir=args.run_dir,
                           checkpoint_every=args.ckpt_every, checkpoint_async=args.async_ckpt,
                           resume_from=args.run_dir if args.resume else None)
    if args.resume:
        print("RESUMED_FROM %s" % exe.last_resume_step, flush=True)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
