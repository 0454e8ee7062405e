"""The control-flow programs the port's tests build (not a test module).

Each builder takes a fluid package (``paddle_tpu`` or
``paddle_tpu_torch``), appends its ops to the current programs with the
same layer calls in either, and returns (fetch names, the feeds of each
step, whether it trains).  ``tests/test_torch_control_flow.py`` holds
them against the JAX package on the CPU; ``tests/test_torch_cuda.py``
runs them on the card, where this module's freedom from jax matters.
``EAGER`` names, for each case whose plan a card may not capture, the
op types that keep it on the interpreter.
"""
import numpy as np


# ---------------------------------------------------------------------------
# builders: fluid -> (main, startup, fetch names, feeds for 3 steps, trains)
# ---------------------------------------------------------------------------
def _while(fluid):
    with fluid.unique_name.guard():
        i = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        total = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="float32", value=10.0)
        i.stop_gradient = total.stop_gradient = True
        cond = fluid.layers.less_than(i, limit)
        loop = fluid.layers.While(cond)
        with loop.block():
            fluid.layers.assign(total + i, total)
            fluid.layers.control_flow.increment(i, value=1.0, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
    return [total.name, i.name], [{}], False


def _cond(fluid):
    with fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        flag = fluid.layers.data("flag", [1])
        w = fluid.layers.create_parameter([4, 4], "float32", name="cond_w")
        pred = fluid.layers.greater_than(fluid.layers.reduce_sum(flag),
                                         fluid.layers.fill_constant([1], "float32", 0.0))
        h = fluid.layers.matmul(x, w)
        out = fluid.layers.cond(pred, lambda: fluid.layers.scale(h, scale=2.0),
                                lambda: fluid.layers.tanh(h))
        loss = fluid.layers.mean(out * out)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    rng = np.random.RandomState(0)
    xb = rng.uniform(-1, 1, (3, 4)).astype("float32")
    feeds = [{"x": xb, "flag": np.full((1, 1), s, "float32")} for s in (1.0, -1.0, 1.0)]
    return [out.name, loss.name, "cond_w@GRAD"], feeds, True


def _static_rnn(fluid):
    T, B, D, H = 5, 3, 4, 6
    with fluid.unique_name.guard():
        x = fluid.layers.data("xt", [T, B, D], append_batch_size=False)
        y = fluid.layers.data("y", [B, H], append_batch_size=False)
        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[-1, H], batch_ref=xt, init_value=0.0, ref_batch_dim_idx=0)
            nh = fluid.layers.fc([xt, h], size=H, act="tanh", bias_attr=False)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        outs = rnn()
        last = fluid.layers.reshape(fluid.layers.slice(outs, axes=[0], starts=[T - 1], ends=[T]),
                                    shape=[B, H])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(last, y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"xt": rng.uniform(-1, 1, (T, B, D)).astype("float32"),
            "y": rng.uniform(-1, 1, (B, H)).astype("float32")}
    return [outs.name, loss.name], [feed] * 3, True


def _bounded_while(fluid):
    N = 3
    with fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        w = fluid.layers.create_parameter([4, 1], "float32", name="w_bw")
        i = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="float32", value=float(N))
        s = fluid.layers.fill_constant(shape=[1, 1], dtype="float32", value=1.0)
        s.stop_gradient = False
        i.stop_gradient = True
        cond = fluid.layers.less_than(i, limit)
        loop = fluid.layers.While(cond, max_trip_count=N + 2)  # bound > actual trips
        with loop.block():
            prod = fluid.layers.matmul(x, w)
            fluid.layers.assign(s * prod, s)
            fluid.layers.control_flow.increment(i, value=1.0, in_place=True)
            fluid.layers.less_than(i, limit, cond=cond)
        loss = fluid.layers.mean(s)
        fluid.optimizer.SGDOptimizer(0.05).minimize(loss)
    feed = {"x": np.array([[0.5, -0.3, 0.2, 0.1]], np.float32)}
    return [loss.name, "w_bw@GRAD", i.name], [feed] * 3, True


def _dynamic_rnn(fluid):
    B, T, D, H = 4, 6, 3, 5
    with fluid.unique_name.guard():
        x = fluid.layers.data("x", [T, D])
        sl = fluid.layers.data("sl", [1], dtype="int32")
        sl2 = fluid.layers.reshape(sl, [-1])
        label = fluid.layers.data("label", [1])
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, seq_len=sl2)
            prev = drnn.memory(shape=[H], value=0.0)
            hidden = fluid.layers.fc(fluid.layers.concat([word, prev], axis=1), H, act="tanh",
                                     name="drnn_fc")
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()
        last = fluid.layers.sequence_pool(out, "last", seq_len=sl2)
        pred = fluid.layers.fc(last, 1, name="drnn_head")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, label))
        fluid.optimizer.AdamOptimizer(0.05).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(B, T, D).astype("float32"),
            "sl": np.array([[6], [3], [1], [4]], np.int32),
            "label": rng.randn(B, 1).astype("float32")}
    return [out.name, loss.name], [feed] * 3, True


def _ifelse_switch_array(fluid):
    with fluid.unique_name.guard():
        x = fluid.layers.data("x", [3])
        zero = fluid.layers.fill_constant([1], "float32", 0.0)
        cond = fluid.layers.greater_than(fluid.layers.reduce_sum(x, dim=1, keep_dim=True), zero)
        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(fluid.layers.scale(x, scale=2.0))
        with ie.false_block():
            ie.output(fluid.layers.scale(x, scale=-1.0))
        merged = ie()
        step = fluid.layers.fill_constant([1], "float32", 7.0)
        sw = fluid.layers.Switch()
        with sw.case(fluid.layers.less_than(step, fluid.layers.fill_constant([1], "float32", 5.0))):
            sw.assign(fluid.layers.fill_constant([1], "float32", 0.1))
        with sw.case(fluid.layers.less_than(step, fluid.layers.fill_constant([1], "float32", 10.0))):
            sw.assign(fluid.layers.fill_constant([1], "float32", 0.01))
        with sw.default():
            sw.assign(fluid.layers.fill_constant([1], "float32", 0.001))
        lr = sw.merge()
        arr = fluid.layers.create_array(4, [3])
        i0 = fluid.layers.fill_constant([1], "int64", 2)
        row = fluid.layers.reshape(fluid.layers.slice(x, axes=[0], starts=[0], ends=[1]), [3])
        arr2 = fluid.layers.array_write(row, i0, arr)
        back = fluid.layers.array_read(arr2, i0)
        past = fluid.layers.array_read(arr2, fluid.layers.fill_constant([1], "int64", 9))  # clamped
        alen = fluid.layers.array_length(arr2)
    feed = {"x": np.array([[1, 2, 3], [-1, -2, -3]], "float32")}
    return [merged.name, lr.name, back.name, past.name, alen.name], [feed], False


def _rank_table(fluid):
    with fluid.unique_name.guard():
        x = fluid.layers.data("x", [4, 3], lod_level=1)
        rank = fluid.layers.lod_rank_table(x, level=0)
        reordered = fluid.layers.reorder_lod_tensor_by_rank(x, rank)
        w = fluid.layers.fc(reordered, 1, num_flatten_dims=2, bias_attr=False)
        loss = fluid.layers.mean(w * w)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 4, 3).astype("float32"), "x_seq_len": np.array([2, 4, 4, 1], "int32")}
    return [reordered.name, rank.name, rank.lengths.name, loss.name], [feed] * 3, True


def _conditional_block(fluid):
    """A hand-built conditional_block (no layer emits one) that lists
    every read: h = x @ w, then h = tanh(h) * 3 when the flag is set."""
    with fluid.unique_name.guard():
        prog = fluid.default_main_program()
        x = fluid.layers.data("x", [4])
        flag = fluid.layers.data("flag", [1])
        w = fluid.layers.create_parameter([4, 4], "float32", name="cb_w")
        h = fluid.layers.matmul(x, w)
        pred = fluid.layers.greater_than(fluid.layers.reduce_sum(flag),
                                         fluid.layers.fill_constant([1], "float32", 0.0))
        three = fluid.layers.fill_constant([1], "float32", 3.0)
        blk = prog._create_block()
        t = fluid.layers.tanh(h)
        blk.append_op(type="elementwise_mul", inputs={"X": [t], "Y": [three]},
                      outputs={"Out": [h]}, attrs={"axis": -1})
        prog._rollback()
        prog.global_block().append_op(
            type="conditional_block", inputs={"Cond": [pred], "X": [h, three]},
            outputs={"Out": [h]},
            attrs={"sub_block": blk, "carry_names": [h.name], "external_names": [three.name]})
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    rng = np.random.RandomState(2)
    xb = rng.uniform(-1, 1, (3, 4)).astype("float32")
    feeds = [{"x": xb, "flag": np.full((1, 1), s, "float32")} for s in (1.0, -1.0, 1.0)]
    return [h.name, loss.name, "cb_w@GRAD"], feeds, True


def _while_in_dynamic_rnn(fluid):
    """A ``while`` nested in a DynamicRNN body: each step adds the step
    input to the memory k times (k = 2)."""
    B, T, H = 3, 4, 2
    with fluid.unique_name.guard():
        x = fluid.layers.data("x", [T, H])
        sl = fluid.layers.data("sl", [1], dtype="int32")
        sl2 = fluid.layers.reshape(sl, [-1])
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, seq_len=sl2)
            prev = drnn.memory(shape=[H], value=0.0)
            acc = fluid.layers.assign(prev)
            j = fluid.layers.fill_constant([1], "float32", 0.0)
            k = fluid.layers.fill_constant([1], "float32", 2.0)
            c = fluid.layers.less_than(j, k)
            loop = fluid.layers.While(c)
            with loop.block():
                fluid.layers.assign(acc + word, acc)
                fluid.layers.control_flow.increment(j, value=1.0, in_place=True)
                fluid.layers.less_than(j, k, cond=c)
            drnn.update_memory(prev, acc)
            drnn.output(acc)
        out = drnn()
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(B, T, H).astype("float32"), "sl": np.array([[4], [2], [3]], np.int32)}
    return [out.name], [feed], False


CASES = {
    "while": _while, "cond": _cond, "static_rnn": _static_rnn, "bounded_while": _bounded_while,
    "dynamic_rnn": _dynamic_rnn, "ifelse_switch_array": _ifelse_switch_array,
    "rank_table": _rank_table, "conditional_block": _conditional_block,
    "while_in_dynamic_rnn": _while_in_dynamic_rnn,
}
# the op types a case's main program holds that keep it on the interpreter
EAGER = {"while": ("while",), "cond": ("select_branch",), "conditional_block": ("conditional_block",),
         "while_in_dynamic_rnn": ("while",)}
