"""The control-flow ops and layers of paddle_tpu_torch against paddle_tpu.

Each case of ``tests/test_control_flow_rnn.py`` is built with the same
layer calls in both packages (``While`` unbounded and with
``max_trip_count``, ``cond``, ``StaticRNN``, ``DynamicRNN``, ``IfElse``,
``Switch``, the tensor arrays, the rank table) and a hand-built
``conditional_block``.  Small sizes; inputs from a numpy seed.

* Desc parity: the same Program JSON, sub-blocks included, and the
  port's JSON round-trips through ``from_json``.
* Run parity from the JAX package's startup state: forward fetches
  within 1e-5 (rtol 1e-5, atol 1e-6), and where the case trains, the
  gradients (the generic vjp through the loop) and 3 optimizer steps'
  losses and parameters within 1e-5 (rtol 1e-4, atol 1e-5).
* Which plans a card may capture (``Executor._analyze``'s
  ``eager_ops``): ``bounded_while``, ``static_rnn`` and ``dynamic_rnn``
  plans may; ``while``, ``conditional_block`` and ``select_branch``, at
  any depth, keep a plan on the interpreter, as does a random op in a
  sub-block.
* The three places that must walk sub-blocks and not only block 0: a
  random op inside a ``DynamicRNN``; a parameter that only a ``while``
  body reads is in ``state_in``; a value that only a body reads
  survives until the body's op has run.  The last two use hand-built
  descs whose body reads names its op does not list, as the reference's
  sub-scope reads its parent scope.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import lowering
from torch_control_flow_cases import CASES, EAGER
from torch_parity_util import (assert_same_program, jax_startup_state, op_parity, program_json,
                               run_jax, run_port)

PKG = {"jax": jfluid, "torch": tfluid}
FWD = dict(rtol=1e-5, atol=1e-6)
TRAIN = dict(rtol=1e-4, atol=1e-5)


def build(pkg, case, seed=5):
    fluid = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        fetch, feeds, trains = CASES[case](fluid)
    return main, startup, fetch, feeds, trains


@pytest.mark.parametrize("case", sorted(CASES))
def test_desc_parity(case):
    jm, js, _, _, _ = build("jax", case)
    tm, ts, _, _, _ = build("torch", case)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    assert jm.num_blocks == tm.num_blocks > 1 or case in ("ifelse_switch_array", "rank_table")
    round_trip = tfluid.Program.from_json(tm.to_json())
    assert program_json(round_trip) == program_json(tm)
    for blk in round_trip.blocks:
        for op in blk.ops:
            for blk_attr in lowering.sub_blocks(op):
                assert blk_attr is round_trip.blocks[blk_attr.idx]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_parity(case):
    jm, js, fetch, feeds, trains = build("jax", case)
    tm, _, _, _, _ = build("torch", case)
    state = jax_startup_state(js, jm)
    steps = len(feeds)
    jout, jscope = run_jax(jm, state, feeds, fetch, steps)
    tout, tscope = run_port(tm, state, feeds, fetch, steps)
    tol = TRAIN if trains else FWD
    for step, (js_, ts_) in enumerate(zip(jout, tout)):
        for name, a, b in zip(fetch, js_, ts_):
            assert b.shape == a.shape or b.size == a.size, (step, name, a.shape, b.shape)
            np.testing.assert_allclose(np.asarray(b, np.float64).reshape(a.shape),
                                       np.asarray(a, np.float64), err_msg="%s step %d" % (name, step),
                                       **(FWD if step == 0 else tol))
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.get(p.name).numpy(), np.asarray(jscope.get(p.name)),
                                   err_msg=p.name, **TRAIN)


@pytest.mark.parametrize("slot_i", [0, 3, 7])
def test_array_ops_forward_and_vjp(slot_i):
    """write_to_array / read_from_array against the JAX kernels, and their
    vjp into the array and the value; an index past the end clamps."""
    rng = np.random.RandomState(slot_i)
    arr = rng.randn(4, 2, 3).astype("float32")
    x = rng.randn(2, 3).astype("float32")
    i = np.array([slot_i], "int64")
    op_parity("write_to_array", {"Array": [arr], "I": [i], "X": [x]}, {},
              grad_slots=("Array", "X"), **FWD)
    op_parity("read_from_array", {"X": [arr], "I": [i]}, {}, grad_slots=("X",), **FWD)
    op_parity("lod_array_length", {"X": [arr]}, {})


def test_case_values():
    """The cases compute what tests/test_control_flow_rnn.py says they do."""
    tm, _, fetch, feeds, _ = build("torch", "while")
    (total, i), = run_port(tm, {}, feeds, fetch)[0]
    assert total.item() == sum(range(10)) and i.item() == 10.0
    tm, _, fetch, feeds, _ = build("torch", "bounded_while")
    jm, js = build("jax", "bounded_while")[:2]
    state = jax_startup_state(js, jm)
    (loss, gw, i), = run_port(tm, state, feeds[:1], fetch)[0]
    dot = (feeds[0]["x"] @ state["w_bw"]).item()
    np.testing.assert_allclose(loss.item(), dot ** 3, rtol=1e-5)
    np.testing.assert_allclose(gw, 3 * dot ** 2 * feeds[0]["x"].reshape(4, 1), rtol=1e-4)
    assert i.item() == 3.0  # the bound is 5: the last two steps hold
    tm, _, fetch, feeds, _ = build("torch", "rank_table")
    jm, js = build("jax", "rank_table")[:2]
    (r, idx, slen, _), = run_port(tm, jax_startup_state(js, jm), feeds[:1], fetch)[0]
    np.testing.assert_array_equal(idx, [1, 2, 0, 3])
    np.testing.assert_array_equal(slen, [4, 4, 2, 1])
    np.testing.assert_allclose(r, feeds[0]["x"][[1, 2, 0, 3]])
    tm, _, fetch, feeds, _ = build("torch", "while_in_dynamic_rnn")
    (out,), = run_port(tm, {}, feeds, fetch)[0]
    x, lens = feeds[0]["x"], feeds[0]["sl"].reshape(-1)
    want = np.where((np.arange(4)[None, :] < lens[:, None])[..., None],
                    2 * np.cumsum(x, axis=1), 0.0)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# which plans a card may capture
# ---------------------------------------------------------------------------
def _plan(main, feeds, fetch):
    exe = tfluid.Executor(tfluid.CPUPlace())
    return exe._analyze(main, tuple(sorted(feeds[0])), tuple(fetch))


@pytest.mark.parametrize("case", sorted(CASES))
def test_capture_eligibility(case):
    tm, _, fetch, feeds, _ = build("torch", case)
    assert _plan(tm, feeds, fetch).eager_ops == EAGER.get(case, ())


def test_random_op_in_a_sub_block_keeps_the_plan_eager():
    """uniform_random (a ``random=True`` op) inside a DynamicRNN body:
    block 0 holds only ``dynamic_rnn``, so a block-0 scan would capture
    the plan and freeze the draws."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4, 2])
        sl = tfluid.layers.reshape(tfluid.layers.data("sl", [1], dtype="int32"), [-1])
        drnn = tfluid.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, seq_len=sl)
            noise = main.current_block().create_var(name="drnn_noise", dtype="float32", shape=(2,))
            main.current_block().append_op(
                type="uniform_random", outputs={"Out": [noise]},
                attrs={"shape": [2], "min": 0.0, "max": 1.0, "seed": 7, "dtype": "float32"})
            drnn.output(word + noise)
        out = drnn()
    assert [op.type for op in main.global_block().ops if op.type == "uniform_random"] == []
    plan = _plan(main, [{"x": 0, "sl": 0}], [out.name])
    assert plan.eager_ops == ("uniform_random",)
    exe = tfluid.Executor(tfluid.CPUPlace())
    xb = np.zeros((2, 4, 2), "float32")
    o, = exe.run(main, feed={"x": xb, "sl": np.array([[4], [2]], np.int32)}, fetch_list=[out])
    assert o.shape == (2, 4, 2) and (o[0] >= 0).all() and (o[0] < 1).all() and (o[1, 2:] == 0).all()


def _hand_built_while(param_only_in_body):
    """acc = 0; i = 0; while i < 3: acc += v; i += 1 — the body reads
    ``v`` (a parameter, or a value block 0 computes from the feed) and
    ``limit`` without the ``while`` op listing them."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [2], append_batch_size=False)
        if param_only_in_body:
            v = tfluid.layers.create_parameter(
                [2], "float32", name="body_w",
                default_initializer=tfluid.initializer.Constant(0.5))
        else:
            v = tfluid.layers.scale(x, scale=2.0)  # read only in the body
        acc = tfluid.layers.fill_constant([2], "float32", 0.0)
        i = tfluid.layers.fill_constant([1], "float32", 0.0)
        limit = tfluid.layers.fill_constant([1], "float32", 3.0)
        cond = tfluid.layers.less_than(i, limit)
        blk = main._create_block()
        tfluid.layers.assign(acc + v, acc)
        tfluid.layers.control_flow.increment(i, value=1.0, in_place=True)
        tfluid.layers.less_than(i, limit, cond=cond)
        main._rollback()
        carried = [cond.name, acc.name, i.name]
        main.global_block().append_op(
            type="while", inputs={"X": carried}, outputs={"Out": carried},
            attrs={"sub_block": blk, "carry_names": carried, "external_names": [],
                   "cond_name": cond.name})
        out = acc + x
    return main, startup, v, out


def test_parameter_read_only_in_a_body_is_in_state_in():
    main, startup, v, out = _hand_built_while(param_only_in_body=True)
    assert not any(v.name in op.input_arg_names for op in main.global_block().ops)
    plan = _plan(main, [{"x": 0}], [out.name])
    assert v.name in plan.state_in and plan.eager_ops == ("while",)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    o, = exe.run(main, feed={"x": np.ones(2, "float32")}, fetch_list=[out], scope=scope)
    np.testing.assert_allclose(o, [2.5, 2.5])


def test_value_read_only_in_a_body_survives_until_its_op():
    main, startup, v, out = _hand_built_while(param_only_in_body=False)
    ops = main.global_block().ops
    dead = lowering._dead_after(ops, {out.name})
    producer = next(i for i, op in enumerate(ops) if v.name in op.output_arg_names)
    loop = next(i for i, op in enumerate(ops) if op.type == "while")
    assert v.name not in dead[producer] and v.name in dead[loop]
    exe = tfluid.Executor(tfluid.CPUPlace())
    o, = exe.run(main, feed={"x": np.array([1.0, -2.0], "float32")}, fetch_list=[out])
    np.testing.assert_allclose(o, [7.0, -14.0])
