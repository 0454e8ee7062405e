"""Helpers the seq2seq slice's port tests share (not a test module).

* ``program_json``: a Program's JSON with the JAX package's int32 (its
  64-bit types are off) read as the port's int64, so two descs compare
  with ``==``, sub-blocks included;
* ``jax_startup_state``: the JAX package's startup run, as numpy arrays
  by name, the state both packages then start from;
* ``run_jax`` / ``run_port``: ``steps`` runs of a main program on the
  CPU from that state, each run's fetches as numpy arrays.
"""
import json

import numpy as np

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _canon(o):
    if isinstance(o, dict):
        return {k: _canon(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_canon(v) for v in o]
    return "int64" if o == "int32" else o


def program_json(program):
    return _canon(json.loads(program.to_json()))


def first_difference(a, b, path=""):
    """The path of the first place two JSON values differ, or None."""
    if type(a) is not type(b):
        return path
    if isinstance(a, dict):
        for k in list(a) + [k for k in b if k not in a]:
            if k not in a or k not in b:
                return path + "/" + k
            d = first_difference(a[k], b[k], path + "/" + k)
            if d is not None:
                return d
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return path + "[len]"
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, "%s[%d]" % (path, i))
            if d is not None:
                return d
        return None
    return None if a == b else path


def assert_same_program(jp, tp):
    ja, ta = program_json(jp), program_json(tp)
    assert ja == ta, first_difference(ja, ta)


def jax_startup_state(js, jm):
    """Run the JAX package's startup program; its persistables as numpy."""
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(js)
    names = sorted({v.name for v in jm.list_vars() if v.persistable} & set(scope.vars))
    return {n: np.array(scope.get(n)) for n in names}


def run_jax(jm, state, feeds, fetch, steps=1):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    out = []
    with jfluid.scope_guard(scope):
        for n, v in state.items():
            scope.set(n, v)
        for i in range(steps):
            feed = feeds[i] if isinstance(feeds, list) else feeds
            out.append([np.asarray(v) for v in exe.run(jm, feed=feed, fetch_list=fetch)])
    return out, scope


def run_port(tm, state, feeds, fetch, steps=1):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.set_params_from_numpy(scope, state, "cpu")
    out = []
    for i in range(steps):
        feed = feeds[i] if isinstance(feeds, list) else feeds
        out.append(exe.run(tm, feed=feed, fetch_list=fetch, scope=scope))
    return out, scope


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def op_parity(op_type, inputs, attrs, grad_slots=(), out_slots=None, seed=0,
              rtol=1e-5, atol=1e-6):
    """One op's kernel in both packages on the same numpy ``inputs``
    (slot -> list of arrays): every output of ``out_slots`` (default:
    all the JAX kernel returns) within the tolerance, and with
    ``grad_slots``, the vjp of those float outputs against seeded
    cotangents (``jax.vjp`` against ``torch.autograd.grad``) into each
    input of those slots.  Returns the port's outputs."""
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    jk, tk = jreg.get_kernel(op_type), treg.get_kernel(op_type)
    cpu = torch.device("cpu")
    jout = jk({s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()}, attrs)
    tout = tk({s: [torch.from_numpy(np.ascontiguousarray(v)) for v in vs]
               for s, vs in inputs.items()}, attrs, cpu)
    out_slots = list(out_slots or jout)
    for s in out_slots:
        for j, t in zip(_as_list(jout[s]), _as_list(tout[s])):
            j = np.asarray(j)
            t = t.detach().numpy() if t.dtype != torch.bfloat16 else t.float().numpy()
            assert t.shape == j.shape, (op_type, s, t.shape, j.shape)
            np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64), rtol=rtol,
                                       atol=atol, err_msg="%s %s" % (op_type, s))
    if not grad_slots:
        return tout
    rng = np.random.RandomState(seed)
    float_outs = [(s, i) for s in out_slots for i, v in enumerate(_as_list(jout[s]))
                  if jnp.issubdtype(np.asarray(v).dtype, jnp.floating)]
    cots = [np.asarray(rng.randn(*np.asarray(_as_list(jout[s])[i]).shape), dtype="float32")
            for s, i in float_outs]
    keys = [(s, i) for s in grad_slots for i in range(len(inputs[s]))]

    def jf(*vals):
        ins = {s: [jnp.asarray(v) for v in vs] for s, vs in inputs.items()}
        for (s, i), v in zip(keys, vals):
            ins[s][i] = v
        out = jk(ins, attrs)
        return tuple(_as_list(out[s])[i] for s, i in float_outs)

    _, vjp = jax.vjp(jf, *[jnp.asarray(inputs[s][i]) for s, i in keys])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    tins = {s: [torch.from_numpy(np.ascontiguousarray(v)) for v in vs] for s, vs in inputs.items()}
    leaves = []
    for s, i in keys:
        tins[s][i] = tins[s][i].clone().requires_grad_(True)
        leaves.append(tins[s][i])
    with torch.enable_grad():
        out = tk(tins, attrs, cpu)
        prim = [_as_list(out[s])[i] for s, i in float_outs]
        tgrads = torch.autograd.grad(prim, leaves, [torch.from_numpy(c) for c in cots],
                                     allow_unused=True)
    for (s, i), jg, tg in zip(keys, jgrads, tgrads):
        tg = np.zeros(np.shape(jg), np.float32) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=rtol, atol=atol,
                                   err_msg="%s d%s[%d]" % (op_type, s, i))
    return tout
