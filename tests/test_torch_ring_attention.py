"""Ring attention in paddle_tpu_torch against the JAX package.

* ``parallel.ring_attention`` on 2 and 4 gloo CPU ranks (started through
  ``tests/torch_mesh_child.py``'s launcher, each rank a window of the
  sequence) against the JAX package's ``ring_attention`` under
  ``shard_map`` on its 8-device virtual CPU mesh and against full softmax
  attention in float64, at tests/test_long_context.py:99's shapes (B=2,
  H=3, D=10, seq 32), causal and not, ``scale=None`` and given: within
  1e-5 (rtol and atol; both sides are fp32 sums of the same terms in
  another order).  Each rank sends its n - 1 hops of K and V.
* Kernel B2's plain versions: ``ring_merge_plain`` against a float64
  log-sum-exp merge of two blocks, rows with the masked fill (a block with
  no valid key) included; ``ring_step_plain`` written in place into the
  running output (a strided view kept) against a fresh merge; a ring of
  ``ring_step`` calls against full attention; the wrapper's CPU and meta
  paths and its argument checks.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.kernels import ring_attention as kra
from torch_mesh_child import launch_ranks

B, H, D, SEQ = 2, 3, 10, 32
TOL = 1e-5
CASES = [(True, None), (False, None), (True, 0.125), (False, 0.31)]


def _qkv():
    rng = np.random.RandomState(11)
    return [rng.randn(B, H, SEQ, D).astype(np.float32) for _ in range(3)]


def _full_attention(q, k, v, causal, scale):
    s = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) * scale
    if causal:
        s = np.where(np.tril(np.ones((SEQ, SEQ), dtype=bool))[None, None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(axis=-1, keepdims=True), v)


def _jax_ring(q, k, v, n, causal, scale):
    from jax.sharding import PartitionSpec as P

    spec = P(None, None, "sp", None)
    ring = jmesh.shard_map(
        lambda a, b, c: jax_ring(a, b, c, axis_name="sp", causal=causal, scale=scale),
        jmesh.make_mesh({"sp": n}), in_specs=(spec, spec, spec), out_specs=spec)
    return np.asarray(ring(q, k, v))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ring_runs(request, tmp_path_factory):
    n = request.param
    q, k, v = _qkv()
    scen = [["ring:%d" % i, {"q": q.tolist(), "k": k.tolist(), "v": v.tolist(),
                             "causal": c, "scale": s}] for i, (c, s) in enumerate(CASES)]
    return n, launch_ranks(str(tmp_path_factory.mktemp("ring%d" % n)), n, scen)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["causal", "full", "causal_scale", "full_scale"])
def test_port_ring_matches_jax_ring_and_full_attention(ring_runs, case):
    n, ranks = ring_runs
    causal, scale = CASES[case]
    q, k, v = _qkv()
    res = ranks["ring:%d" % case]
    got = np.concatenate([np.asarray(r["out"], np.float32) for r in res], axis=2)
    assert got.shape == (B, H, SEQ, D)
    want_jax = _jax_ring(q, k, v, n, causal, scale)
    want = _full_attention(q, k, v, causal, scale if scale is not None else D ** -0.5)
    np.testing.assert_allclose(got, want_jax, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    window_bytes = 2 * B * H * (SEQ // n) * D * 4  # K and V of one window, fp32
    for r in res:
        assert r["ring"]["calls"] == 1 and r["ring"]["hops"] == n - 1
        assert r["ring"]["bytes_sent"] == (n - 1) * window_bytes


# ---------------------------------------------------------------------------
# kernel B2's plain version
# ---------------------------------------------------------------------------
def _block(rng, shape, masked_rows=()):
    """(o, stats) of one block as B1 writes them, rows ``masked_rows`` (flat
    indices into [N, H, T]) the masked fill."""
    n, h, t, d = shape
    o = rng.randn(*shape)
    m = 3 * rng.randn(n, h, t)
    logl = rng.uniform(0, np.log(t), (n, h, t))
    for r in masked_rows:
        m.reshape(-1)[r], logl.reshape(-1)[r] = kra.MASKED_FILL
        o.reshape(-1, d)[r] = 0.0
    return o, np.stack([m, logl])


def _merge_f64(oa, sa, ob, sb):
    """The merge as log-sum-exp in float64: lse = logaddexp(lse_a, lse_b),
    o = o_a e^(lse_a - lse) + o_b e^(lse_b - lse) (0 where both are empty)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        la, lb = sa[0] + sa[1], sb[0] + sb[1]
        lse = np.logaddexp(la, lb)
        wa = np.where(np.isneginf(la), 0.0, np.exp(la - lse))
        wb = np.where(np.isneginf(lb), 0.0, np.exp(lb - lse))
    out = oa * wa[..., None] + ob * wb[..., None]
    return np.where(np.isneginf(lse)[..., None], 0.0, out), lse


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6), (torch.float64, 1e-12)],
                         ids=["fp32", "fp64"])
def test_ring_merge_plain_matches_a_float64_logsumexp_merge(dtype, tol):
    rng = np.random.RandomState(5)
    shape = (2, 3, 16, 8)
    oa, sa = _block(rng, shape, masked_rows=(0, 1))
    ob, sb = _block(rng, shape, masked_rows=(1, 2))
    want, want_lse = _merge_f64(oa, sa, ob, sb)
    st = torch.float32 if dtype == torch.float32 else torch.float64
    out, stats = kra.ring_merge_plain(torch.tensor(oa, dtype=dtype), torch.tensor(sa, dtype=st),
                                      torch.tensor(ob, dtype=dtype), torch.tensor(sb, dtype=st))
    assert out.dtype == dtype and stats.shape == (2, 2, 3, 16)
    np.testing.assert_allclose(out.numpy(), want, rtol=tol, atol=tol)
    # row 1 is the masked fill in both blocks: output 0, statistics the fill
    assert np.all(out.numpy().reshape(-1, 8)[1] == 0.0)
    assert stats[0].reshape(-1)[1] == kra.MASKED_FILL[0]
    assert stats[1].reshape(-1)[1] == float("-inf")
    lse = (stats[0] + stats[1]).numpy()
    ok = ~np.isneginf(want_lse)
    np.testing.assert_allclose(lse[ok], want_lse[ok], rtol=tol, atol=tol)


def _step_inputs(rng, shape, head_split=False, dtype=torch.float32):
    """q, k, v of one block and a running (acc, acc_stats) whose row 1 is the
    masked fill; with ``head_split`` acc is the [N, T, H, D] view's permute."""
    n, h, t, d = shape
    q, k, v = (torch.tensor(rng.randn(*shape), dtype=dtype) for _ in range(3))
    o, st = _block(rng, shape, masked_rows=(1,))
    acc = torch.tensor(o, dtype=dtype)
    if head_split:
        acc = acc.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    return q, k, v, acc, torch.tensor(st, dtype=torch.float32)


def test_ring_step_wrapper_cpu_and_meta_paths():
    rng = np.random.RandomState(6)
    shape = (1, 2, 4, 8)
    q, k, v, acc, st = _step_inputs(rng, shape)
    for causal in (True, False):
        got = kra.ring_step(q, k, v, causal, 0.3)
        want = kra.ring_step_plain(q, k, v, causal, 0.3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        a1, s1, a2, s2 = acc.clone(), st.clone(), acc.clone(), st.clone()
        got = kra.ring_step(q, k, v, causal, 0.3, a1, s1)
        want = kra.ring_step_plain(q, k, v, causal, 0.3, a2, s2)
        assert got[0] is a1 and got[1] is s1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta = [t.to("meta") for t in (q, k, v, acc, st)]
    first = kra.ring_step(*meta[:3], True, 0.3)
    assert [t.shape for t in first] == [q.shape, st.shape]
    assert all(t.device.type == "meta" for t in first)
    merged = kra.ring_step(*meta[:3], False, 0.3, meta[3], meta[4])
    assert merged[0] is meta[3] and merged[1] is meta[4]


@pytest.mark.parametrize("head_split", [False, True], ids=["contiguous", "head_split"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_step_plain_in_place_matches_fresh(head_split, causal):
    """The merged rows written into acc's own storage, its strides kept,
    equal a fresh merge of the block's plain output; acc's masked-fill row
    comes out as the block's own output."""
    from paddle_tpu_torch.kernels import fused_attention as fa

    rng = np.random.RandomState(8)
    shape = (2, 3, 16, 8)
    q, k, v, acc, st = _step_inputs(rng, shape, head_split)
    ob, sb = fa.fused_attention_plain(q, k, v, None, causal, 0.35, return_stats=True)
    fresh, fresh_st = kra.ring_merge_plain(acc.clone(), st.clone(), ob, sb)
    ptr, strides = acc.data_ptr(), acc.stride()
    out, out_st = kra.ring_step_plain(q, k, v, causal, 0.35, acc, st)
    assert out is acc and out_st is st
    assert acc.data_ptr() == ptr and acc.stride() == strides
    assert torch.equal(acc, fresh) and torch.equal(st, fresh_st)
    torch.testing.assert_close(acc.reshape(-1, 8)[1], ob.reshape(-1, 8)[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(st[:, 0, 0, 1], sb[:, 0, 0, 1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", ["shape", "dtype", "last_stride", "stats_layout", "stats_dtype"])
def test_ring_step_checks_the_running_output(bad):
    """The card path's checks of acc and acc_stats, on CPU tensors."""
    rng = np.random.RandomState(9)
    q, _, _, acc, st = _step_inputs(rng, (1, 2, 4, 8))
    if bad == "shape":
        acc = acc[:, :, :3]
    elif bad == "dtype":
        acc = acc.double()
    elif bad == "last_stride":
        acc = torch.empty(1, 2, 4, 16)[..., ::2]
    elif bad == "stats_layout":
        st = torch.empty(2, 1, 2, 8)[..., ::2]
    else:
        st = st.double()
    with pytest.raises((ValueError, TypeError), match="ring_step"):
        kra._check(q, acc, st)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_blockwise_merges_of_b1_blocks_are_full_attention(causal):
    """The ring's arithmetic in one process: ``ring_step`` on each (query
    window, key window) pair the ring attends, in the ring's order, each hop
    merged into the running output, equals full attention."""
    n, tl = 4, SEQ // 4
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    want = _full_attention(*_qkv(), causal, D ** -0.5)
    for r in range(n):
        out = st = None
        for s in range(n):
            src = (r - s) % n
            if causal and src > r:
                continue
            win = slice(r * tl, (r + 1) * tl)
            kw = slice(src * tl, (src + 1) * tl)
            out, st = kra.ring_step(q[:, :, win], k[:, :, kw], v[:, :, kw], causal and s == 0,
                                    D ** -0.5, out, st)
        np.testing.assert_allclose(out.numpy(), want[:, :, r * tl:(r + 1) * tl], rtol=TOL, atol=TOL)
