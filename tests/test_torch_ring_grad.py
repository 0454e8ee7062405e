"""Ring attention's gradient in paddle_tpu_torch against the JAX package.

* ``parallel.ring_attention``'s backward on 2 and 4 gloo CPU ranks (one
  launch a world size, through ``tests/torch_mesh_child.py``, each rank a
  window of the sequence, the upstream gradient's window seeded on it)
  against ``jax.vjp`` of the JAX package's ``ring_attention`` under
  ``shard_map`` on its 8-device virtual CPU mesh, and against full softmax
  attention's gradient in float64, at tests/test_long_context.py:99's
  shapes (B=2, H=3, D=10, seq 32), causal and not, ``scale`` None and
  given: dQ, dK and dV within 1e-5 (rtol and atol: fp32 sums of the same
  terms in other orders).  Each rank's backward sends n - 1 blocks of K and
  V and n dK/dV accumulators.
* The backward's block (``kernels/ring_attention.py`` ``ring_block_bwd``)
  and its plain version: every block the ring attends, from the ring's
  final statistics, sums to full attention's gradient in float64 (fp32 and
  float64 inputs); the wrapper's CPU and meta paths.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.kernels import fused_attention as fa
from paddle_tpu_torch.kernels import ring_attention as kra
from torch_mesh_child import launch_ranks

B, H, D, SEQ = 2, 3, 10, 32
TOL = 1e-5
CASES = [(True, None), (False, None), (True, 0.125), (False, 0.31)]
CASE_IDS = ["causal", "full", "causal_scale", "full_scale"]


def _inputs():
    rng = np.random.RandomState(21)
    return [rng.randn(B, H, SEQ, D).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def _full_grads(q, k, v, d_out, causal, scale):
    """dQ, dK, dV of full softmax attention in float64."""
    qt, kt, vt = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if causal:
        s = s.masked_fill(~torch.ones(SEQ, SEQ, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vt)
    return [g.numpy() for g in torch.autograd.grad(out, (qt, kt, vt),
                                                   torch.tensor(d_out, dtype=torch.float64))]


def _jax_ring_grads(q, k, v, d_out, n, causal, scale):
    import jax
    from jax.sharding import PartitionSpec as P

    spec = P(None, None, "sp", None)
    ring = jmesh.shard_map(
        lambda a, b, c: jax_ring(a, b, c, axis_name="sp", causal=causal, scale=scale),
        jmesh.make_mesh({"sp": n}), in_specs=(spec, spec, spec), out_specs=spec)
    grads = jax.jit(lambda a, b, c, g: jax.vjp(ring, a, b, c)[1](g))
    return [np.asarray(g) for g in grads(q, k, v, d_out)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def grad_runs(request, tmp_path_factory):
    n = request.param
    q, k, v, d_out = _inputs()
    scen = [["ring_grad:%d" % i, {"q": q.tolist(), "k": k.tolist(), "v": v.tolist(),
                                  "d_out": d_out.tolist(), "causal": c, "scale": s}]
            for i, (c, s) in enumerate(CASES)]
    return n, launch_ranks(str(tmp_path_factory.mktemp("ring_grad%d" % n)), n, scen)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_port_ring_gradient_matches_jax_ring_and_full_attention(grad_runs, case):
    n, ranks = grad_runs
    causal, scale = CASES[case]
    q, k, v, d_out = _inputs()
    res = ranks["ring_grad:%d" % case]
    want_jax = _jax_ring_grads(q, k, v, d_out, n, causal, scale)
    want = _full_grads(q, k, v, d_out, causal, scale if scale is not None else D ** -0.5)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = np.concatenate([np.asarray(r[name], np.float32) for r in res], axis=2)
        assert got.shape == (B, H, SEQ, D)
        np.testing.assert_allclose(got, want_jax[i], rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(got, want[i], rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_ring_backward_sends_blocks_and_accumulators(grad_runs, case):
    """Forward: n - 1 hops of K and V.  Backward: n - 1 rounds of K, V and
    the fp32 dK/dV accumulator, then one of the accumulator to its owner."""
    n, ranks = grad_runs
    window = B * H * (SEQ // n) * D * 4  # one tensor's window, fp32
    for r in ranks["ring_grad:%d" % case]:
        st = r["ring"]
        assert st["calls"] == 1 and st["hops"] == n - 1
        assert st["bytes_sent"] == (n - 1) * 2 * window
        assert st["bwd_calls"] == 1 and st["bwd_hops"] == n
        assert st["bwd_bytes_sent"] == (n - 1) * 2 * window + n * 2 * window


# ---------------------------------------------------------------------------
# the backward's block and its plain version, in one process
# ---------------------------------------------------------------------------
def _ring_in_one_process(q, k, v, d_out, n, causal, scale, block_bwd):
    """dQ, dK, dV of the ring's arithmetic on n windows: each window's
    forward by ring_step over the blocks in the ring's order, then each
    attended block's gradient by ``block_bwd`` from the final statistics
    and Di, dK and dV summed for the block's owner."""
    tl = q.shape[2] // n
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for r in range(n):
        win = slice(r * tl, (r + 1) * tl)
        order = [((r - s) % n, s) for s in range(n) if not (causal and (r - s) % n > r)]
        out = st = None
        for src, s in order:
            kw = slice(src * tl, (src + 1) * tl)
            out, st = kra.ring_step(q[:, :, win], k[:, :, kw], v[:, :, kw], causal and s == 0,
                                    scale, out, st)
        di = (out * d_out[:, :, win]).sum(-1)
        for src, s in order:
            kw = slice(src * tl, (src + 1) * tl)
            gq, gk, gv = block_bwd(q[:, :, win], k[:, :, kw], v[:, :, kw], causal and s == 0,
                                   scale, d_out[:, :, win], st, di)
            dq[:, :, win] += gq
            dk[:, :, kw] += gk
            dv[:, :, kw] += gv
    return dq, dk, dv


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.float64, 1e-12)],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_ring_block_bwd_plain_sums_to_full_attention_gradient(dtype, tol, case):
    """The plain backward of each block from the ring's final (merged)
    statistics, whose probabilities sum to less than 1 a block, adds up
    over the blocks to full attention's gradient in float64."""
    causal, scale = CASES[case]
    scale = D ** -0.5 if scale is None else scale
    q, k, v, d_out = (torch.tensor(a, dtype=dtype) for a in _inputs())
    got = _ring_in_one_process(q, k, v, d_out, 4, causal, scale, kra.ring_block_bwd_plain)
    want = _full_grads(*_inputs(), causal, scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_ring_block_bwd_wrapper_cpu_and_meta_paths():
    rng = np.random.RandomState(23)
    q, k, v, d_out = (torch.tensor(rng.randn(1, 2, 8, 4), dtype=torch.float32) for _ in range(4))
    out, st = fa.fused_attention_plain(q, k, v, None, True, 0.4, return_stats=True)
    di = (out * d_out).sum(-1)
    got = kra.ring_block_bwd(q, k, v, True, 0.4, d_out, st, di)
    want = kra.ring_block_bwd_plain(q, k, v, True, 0.4, d_out, st, di)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a block alone with its own statistics is B1's plain backward
    for a, b in zip(got, fa.fused_attention_bwd_plain(q, k, v, None, True, 0.4, out, d_out, st)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    meta = [t.to("meta") for t in (q, k, v, d_out, st, di)]
    shapes = kra.ring_block_bwd(*meta[:3], True, 0.4, *meta[3:])
    assert [t.shape for t in shapes] == [q.shape, k.shape, v.shape]
    assert all(t.device.type == "meta" for t in shapes)


def test_ring_gradient_in_one_rank_is_attention_gradient():
    """A world of one rank (no group): the differentiable ring is B1's
    forward and its backward, no hop counted."""
    from paddle_tpu_torch.parallel.ring_attention import reset_ring_stats, ring_attention, ring_stats

    q, k, v, d_out = (torch.tensor(a) for a in _inputs())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_ring_stats()
    out = ring_attention(*leaves, None, causal=True)
    got = torch.autograd.grad(out, leaves, d_out)
    want = _full_grads(*_inputs(), True, D ** -0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    st = ring_stats()
    assert st["calls"] == 1 and st["bwd_calls"] == 1
    assert st["hops"] == 0 and st["bwd_hops"] == 0
    # without a gradient asked for, no autograd node is made
    with torch.no_grad():
        assert ring_attention(*leaves, None, causal=True).grad_fn is None
