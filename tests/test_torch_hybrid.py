"""The 5D hybrid engine (``paddle_tpu_torch.parallel.hybrid``) against the
JAX package's ``parallel/hybrid.py``.

* No ranks: ``init_params`` bit for bit, ``factorize_mesh`` for 1 to 19
  devices, ``init_opt_state``, ``_optimizer_plan``'s refusals (the same
  messages), and ``reference_loss`` and its gradient against
  ``jax.value_and_grad`` of the JAX function (fp32: the loss within 1e-6
  relative, each gradient within 1e-4 relative of its largest element).
* The sharded step over gloo CPU ranks (one launch of 4 ranks and one of
  8, through ``tests/torch_mesh_child.py``; the mesh of one rank in this
  process), at tests/test_hybrid_parallel.py's widths and limits: one SGD
  step's loss within rtol 2e-4 of the JAX package's ``reference_loss`` and
  every parameter after it within rtol 3e-3, atol 2e-5 of the JAX
  reference's SGD update, for ``{}``, ``{"pp": 2, "sp": 2}`` with the ring
  and with all-gathered K/V, ``{"dp": 2, "tp": 2}``, ``{"sp": 2, "ep": 2}``
  and ``{"dp": 2, "sp": 2, "tp": 2}``, so every axis runs at 2; each rank's
  shards are the JAX ``NamedSharding``'s; the ring's hops a step.
* Adam with L2 decay over 2 steps on ``{"dp": 2, "tp": 2}``, as
  ``test_hybrid_engine_adam_parity``: losses rtol 2e-4, parameters rtol
  3e-3, atol 2e-5 of Adam written out on the JAX reference.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import hybrid as jhybrid
from paddle_tpu_torch.parallel import hybrid as thybrid
from paddle_tpu_torch.parallel import mesh as tmesh
from torch_mesh_child import HYBRID, HYBRID_ADAM, hybrid_adam, hybrid_tokens, launch_ranks

LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=3e-3, atol=2e-5)
COMBOS = {  # name: (axes, ring attention, seed)
    "single": ({}, True, 0),
    "pp2_sp2_ring": ({"pp": 2, "sp": 2}, True, 0),
    "pp2_sp2_allgather": ({"pp": 2, "sp": 2}, False, 1),
    "dp2_tp2": ({"dp": 2, "tp": 2}, True, 2),
    "sp2_ep2": ({"sp": 2, "ep": 2}, True, 3),
    "dp2_sp2_tp2": ({"dp": 2, "sp": 2, "tp": 2}, True, 0),
}


def _cfg(mod, axes, ring=True, lr=0.1):
    return mod.HybridConfig(lr=lr, ring_attention=ring, **HYBRID, **axes)


def _world(axes):
    return int(np.prod(list(axes.values()))) if axes else 1


def _jax_value_and_grad(cfg, params, tokens, labels):
    import jax
    import jax.numpy as jnp

    fn = jax.jit(jax.value_and_grad(lambda p: jhybrid.reference_loss(
        p, jnp.asarray(tokens.astype(np.int32)), jnp.asarray(labels.astype(np.int32)), cfg)))
    loss, grads = fn({k: jnp.asarray(v) for k, v in params.items()})
    return float(loss), {k: np.asarray(g) for k, g in grads.items()}


# ---------------------------------------------------------------------------
# no ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axes,seed", [({}, 0), ({"pp": 2}, 7), ({"pp": 4, "tp": 2}, 3)],
                         ids=["pp1", "pp2", "pp4"])
def test_init_params_bit_equal_to_jax(axes, seed):
    want = jhybrid.init_params(_cfg(jhybrid, axes), seed=seed)
    got = thybrid.init_params(_cfg(thybrid, axes), seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("n", list(range(1, 17)) + [17, 19])
def test_factorize_mesh_matches_jax(n):
    assert thybrid.factorize_mesh(n) == jhybrid.factorize_mesh(n)


@pytest.mark.parametrize("make", ["sgd", "momentum", "adam"])
def test_init_opt_state_and_plan_match_jax(make):
    opts = {"sgd": lambda f: f.optimizer.SGDOptimizer(0.1),
            "momentum": lambda f: f.optimizer.MomentumOptimizer(0.1, 0.9, use_nesterov=True),
            "adam": hybrid_adam}
    jopt, topt = opts[make](jfluid), opts[make](tfluid)
    params = thybrid.init_params(_cfg(thybrid, {"pp": 2}), seed=1)
    want = jhybrid.init_opt_state(_cfg(jhybrid, {"pp": 2}), params, jopt)
    got = thybrid.init_opt_state(_cfg(thybrid, {"pp": 2}), params, topt)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)
    assert thybrid._optimizer_plan(topt) == jhybrid._optimizer_plan(jopt)


def _refused(fluid, kind):
    if kind == "subclass":
        sub = type("MyAdam", (fluid.optimizer.AdamOptimizer,), {})
        return sub(learning_rate=0.01)
    if kind == "non_float_lr":
        opt = fluid.optimizer.SGDOptimizer(0.1)
        opt._learning_rate = np.float32(0.1).reshape(1)  # not a Python float
        return opt
    if kind == "l1":
        return fluid.optimizer.SGDOptimizer(
            0.1, regularization=fluid.regularizer.L1DecayRegularizer(0.01))
    return fluid.optimizer.LambOptimizer(0.01)


@pytest.mark.parametrize("kind", ["subclass", "non_float_lr", "l1", "other_class"])
def test_optimizer_plan_refuses_as_jax_does(kind):
    with pytest.raises(ValueError) as want:
        jhybrid._optimizer_plan(_refused(jfluid, kind))
    with pytest.raises(ValueError) as got:
        thybrid._optimizer_plan(_refused(tfluid, kind))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axes", [{}, {"pp": 2}], ids=["pp1", "pp2"])
def test_reference_loss_and_gradient_match_jax(axes):
    cfg_t, cfg_j = _cfg(thybrid, axes), _cfg(jhybrid, axes)
    params = thybrid.init_params(cfg_t, seed=9)
    tokens, labels = hybrid_tokens(9, cfg_t)
    want_loss, want = _jax_value_and_grad(cfg_j, params, tokens, labels)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss = thybrid.reference_loss(leaves, torch.from_numpy(tokens), torch.from_numpy(labels), cfg_t)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-6)
    for k, g in zip(leaves, grads):
        scale = max(np.abs(want[k]).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0, atol=1e-4 * scale, err_msg=k)


def test_make_train_step_refuses_a_mesh_of_other_sizes():
    mesh = tmesh.make_mesh({"dp": 1}, backend="cpu")
    with pytest.raises(ValueError, match="the config"):
        thybrid.make_train_step(_cfg(thybrid, {"tp": 2}), mesh)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
def _scenarios(world):
    return [["hybrid:" + name, {"axes": axes, "ring": ring, "seed": seed}]
            for name, (axes, ring, seed) in COMBOS.items() if _world(axes) == world and world > 1]


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    scen = _scenarios(4) + [["hybrid:adam", {"axes": {"dp": 2, "tp": 2}, "seed": 5, "steps": 2,
                                             "adam": True}]]
    return launch_ranks(str(tmp_path_factory.mktemp("hybrid4")), 4, scen)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return launch_ranks(str(tmp_path_factory.mktemp("hybrid8")), 8, _scenarios(8))


def _one_rank(axes, ring, seed):
    """The combo of one rank, in this process (no group): rank 0's result."""
    cfg = _cfg(thybrid, axes, ring)
    mesh = tmesh.make_mesh(cfg.mesh_axes(), backend="cpu")
    step, place, _ = thybrid.make_train_step(cfg, mesh)
    p, tok, lab = place(thybrid.init_params(cfg, seed=seed), *hybrid_tokens(seed, cfg))
    assert tok.dtype == torch.int64 and p["wq"].device == torch.device("cpu")
    loss, p = step(p, tok, lab)
    full = thybrid.gather(cfg, mesh, p)
    return [{"losses": [float(loss)], "params": {k: v.tolist() for k, v in full.items()},
             "coords": mesh.coords, "shard_shapes": {k: list(v.shape) for k, v in p.items()}}]


def _results(name, request):
    axes, ring, seed = COMBOS[name]
    world = _world(axes)
    if world == 1:
        return _one_rank(axes, ring, seed)
    return request.getfixturevalue("ranks%d" % world)["hybrid:" + name]


@pytest.mark.parametrize("name", list(COMBOS))
def test_sharded_step_matches_jax_reference(name, request):
    axes, ring, seed = COMBOS[name]
    res = _results(name, request)
    cfg = _cfg(jhybrid, axes, ring)
    params = jhybrid.init_params(cfg, seed=seed)
    want_loss, grads = _jax_value_and_grad(cfg, params, *hybrid_tokens(seed, cfg))
    for r in res:
        assert len(r["losses"]) == 1
        np.testing.assert_allclose(r["losses"][0], want_loss, rtol=LOSS_RTOL)
    got = res[0]["params"]
    assert sorted(got) == sorted(params)
    for k in params:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), params[k] - cfg.lr * grads[k],
                                   err_msg="param %s diverged under %s" % (k, axes), **PARAM_TOL)


@pytest.mark.parametrize("name", list(COMBOS))
def test_each_rank_holds_the_jax_shards(name, request):
    """Each rank's shard shapes are the JAX NamedSharding's for its
    coordinates (every shard of a spec has one shape)."""
    from jax.sharding import NamedSharding

    from paddle_tpu.parallel import mesh as jmesh

    axes, ring, _ = COMBOS[name]
    res = _results(name, request)
    cfg = _cfg(jhybrid, axes, ring)
    mesh = jmesh.make_mesh(cfg.mesh_axes())
    params = jhybrid.init_params(cfg, seed=0)
    for k, spec in jhybrid._param_specs(cfg).items():
        want = list(NamedSharding(mesh, spec).shard_shape(params[k].shape))
        assert all(r["shard_shapes"][k] == want for r in res), k
    assert sorted(tuple(sorted(r["coords"].items())) for r in res) == sorted(
        {tuple(sorted(zip(cfg.mesh_axes(), c))) for c in np.ndindex(*cfg.mesh_axes().values())})


def test_ring_hops_a_step(ranks4):
    """{"pp": 2, "sp": 2}: each rank runs the ring once a layer a time step
    (2 layers, M + S - 1 = 3 steps): 6 forward hops and 12 rounds of the
    backward's a step, bubbles included, on every rank alike."""
    for r in ranks4["hybrid:pp2_sp2_ring"]:
        ring = r["ring"][0]
        assert (ring["calls"], ring["hops"], ring["bwd_calls"], ring["bwd_hops"]) == (6, 6, 6, 12)
    for r in ranks4["hybrid:pp2_sp2_allgather"]:
        assert r["ring"][0]["calls"] == 0 and r["ring"][0]["bwd_calls"] == 0


def test_adam_with_l2_decay_matches_jax_adam_on_the_reference(ranks4):
    import jax
    import jax.numpy as jnp

    a = HYBRID_ADAM
    axes = {"dp": 2, "tp": 2}
    cfg = _cfg(jhybrid, axes)
    params = jhybrid.init_params(cfg, seed=5)
    tokens, labels = hybrid_tokens(5, cfg)
    fn = jax.jit(jax.value_and_grad(lambda q: jhybrid.reference_loss(
        q, jnp.asarray(tokens.astype(np.int32)), jnp.asarray(labels.astype(np.int32)), cfg)))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    m1 = {k: jnp.zeros_like(v) for k, v in p.items()}
    m2 = {k: jnp.zeros_like(v) for k, v in p.items()}
    b1p, b2p = a["b1"], a["b2"]
    ref_losses = []
    for _ in range(2):
        l, g = fn(p)
        ref_losses.append(float(l))
        for k in p:
            gk = g[k] + a["decay"] * p[k]
            m1[k] = a["b1"] * m1[k] + (1 - a["b1"]) * gk
            m2[k] = a["b2"] * m2[k] + (1 - a["b2"]) * gk * gk
            lr_t = a["lr"] * np.sqrt(1 - b2p) / (1 - b1p)
            p[k] = p[k] - lr_t * m1[k] / (jnp.sqrt(m2[k]) + a["eps"])
        b1p *= a["b1"]
        b2p *= a["b2"]
    res = ranks4["hybrid:adam"]
    for r in res:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=LOSS_RTOL)
    for k in ("wq", "wo", "moe_w0", "word_emb", "head", "ln1_scale"):
        np.testing.assert_allclose(np.asarray(res[0]["params"][k], np.float32), np.asarray(p[k]),
                                   err_msg="param %s diverged under Adam + %s" % (k, axes),
                                   **PARAM_TOL)
