"""The fused attention, its row statistics and its gradient on a batch
row whose padding Mask is all zero (a batch padded with empty rows up to
a fixed size feeds such a row).

Every score of such a row is -1e9, where one fp32 ulp is 64, so the
row's log-sum-exp m + log(S) rounds back to m: a backward that took
P = exp(s - lse) gave every key 1 where the softmax gives 1/S.  The port
keeps the row max and the log row sum apart (``fa._row_stats``); these
tests hold its output, its statistics and its gradient to the JAX
package's on such rows.

The JAX side runs on the CPU as its own tests run it: the op takes its
einsum branch and ``jax.vjp`` differentiates that.  Gradient limit 1e-5
absolute (fp32, the two frameworks sum in different orders; the fault
was 5.6).  Forward limits: Out 1e-6 in fp32 and 2e-2 in bf16 (one to two
bf16 ulps at unit scale), the fp32 statistics 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.kernels import fused_attention as fa

CPU = torch.device("cpu")
ATOL = 1e-5


def _inputs(n=3, h=2, s=8, d=4, seed=0):
    """Q, K, V, dOut and a Mask whose row 1 is all pad (row 0 all real,
    row 2 five real keys), made by numpy from a seed."""
    rng = np.random.RandomState(seed)
    q, k, v, d_out = (rng.randn(n, h, s, d).astype("float32") for _ in range(4))
    lens = np.array([s, 0, 5][:n])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype("float32")
    return q, k, v, mask, d_out


def _jax_forward(q, k, v, mask, causal, scale, bf16):
    """The JAX op's Out (as float32 numpy), and the row statistics [2, N,
    H, S] (row max, log row sum) of its einsum branch's scores, taken from
    the inputs' values in fp32 as the port takes them."""
    cast = (lambda a: jnp.asarray(a, dtype=jnp.bfloat16)) if bf16 else jnp.asarray
    jq, jk, jv, jm = cast(q), cast(k), cast(v), jnp.asarray(mask)
    out = jreg.get_kernel("fused_attention")(
        {"Q": [jq], "K": [jk], "V": [jv], "Mask": [jm]}, {"causal": causal, "scale": scale})["Out"]
    s = jnp.einsum("bhqd,bhkd->bhqk", jq.astype(jnp.float32), jk.astype(jnp.float32)) * scale
    S = q.shape[2]
    if causal:
        s = s + jnp.where(jnp.arange(S)[None, :] <= jnp.arange(S)[:, None], 0.0, -1e9)
    s = s + ((jm - 1.0) * 1e9)[:, None, None, :]
    m = s.max(-1)
    stats = jnp.stack([m, jnp.log(jnp.exp(s - m[..., None]).sum(-1))])
    return np.asarray(out.astype(jnp.float32)), np.asarray(stats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_forward_matches_jax_on_all_pad_row(dtype, causal):
    """The ``fused_attention`` op's Out and the plain row statistics
    against the JAX op on every row: on the all-pad one each query takes
    the mean of V (causal: of its first i + 1 rows), its row max is -1e9
    and its log row sum log(S) (causal: log(i + 1))."""
    q, k, v, mask, _ = _inputs(n=3, h=2, s=9, d=6, seed=5)
    scale = 0.45
    bf16 = dtype == torch.bfloat16
    want_out, want_stats = _jax_forward(q, k, v, mask, causal, scale, bf16)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    out = treg.get_kernel("fused_attention")(
        {"Q": [tq], "K": [tk], "V": [tv], "Mask": [tmask]}, {"causal": causal, "scale": scale},
        CPU)["Out"]
    _, stats = fa.fused_attention_fwd(tq, tk, tv, tmask, causal, scale, return_stats=True)
    assert out.dtype == dtype and stats.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=2e-2 if bf16 else 1e-6, rtol=0)
    np.testing.assert_allclose(stats.numpy(), want_stats, atol=1e-6, rtol=0)
    assert (stats[0, 1] == -1e9).all()
    keys = np.arange(1, 10) if causal else np.full(9, 9)
    np.testing.assert_allclose(stats[1, 1].numpy(), np.log(keys)[None, :].repeat(2, 0), atol=1e-6)


def _jax_grads(q, k, v, mask, d_out, causal, scale):
    fwd = jreg.get_kernel("fused_attention")
    attrs = {"causal": causal, "scale": scale}

    def f(a, b, c):
        return fwd({"Q": [a], "K": [b], "V": [c], "Mask": [jnp.asarray(mask)]}, dict(attrs))["Out"]

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(d_out))]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_autograd_matches_jax_on_all_pad_row(causal):
    """torch.autograd.grad through ``fused_attention_fwd`` against jax.vjp
    of the op, on every row: the all-pad one, a padded one, a full one."""
    q, k, v, mask, d_out = _inputs(seed=1)
    scale = 0.5
    ref = _jax_grads(q, k, v, mask, d_out, causal, scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.fused_attention_fwd(tq, tk, tv, torch.from_numpy(mask), causal, scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(d_out))
    for name, got, want in zip(("Out", "dQ", "dK", "dV"), (out,) + grads, ref):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_grad_op_matches_jax_on_all_pad_row(causal):
    """The ``fused_attention_grad`` op of both packages on the same inputs,
    as the executor runs it."""
    q, k, v, mask, d_out = _inputs(n=2, h=3, s=6, d=5, seed=2)
    attrs = {"causal": causal, "scale": 0.4, "__fwd_output_slots__": ("Out",),
             "__grad_input_slots__": ("Q", "K", "V")}
    inputs = {"Q": [q], "K": [k], "V": [v], "Mask": [mask], "Out@GRAD": [d_out]}
    jout = jreg.get_kernel("fused_attention_grad")(
        {s: [jnp.asarray(a) for a in arrs] for s, arrs in inputs.items()}, dict(attrs))
    tout = treg.get_kernel("fused_attention_grad")(
        {s: [torch.from_numpy(a) for a in arrs] for s, arrs in inputs.items()}, dict(attrs), CPU)
    assert set(tout) == set(jout) == {"Q@GRAD", "K@GRAD", "V@GRAD"}
    for slot in jout:
        want = np.asarray(jout[slot][0] if isinstance(jout[slot], (list, tuple)) else jout[slot])
        got = tout[slot][0] if isinstance(tout[slot], (list, tuple)) else tout[slot]
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=slot)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradcheck_float64_with_all_pad_row(causal):
    """gradcheck through the Function on a CPU tensor.  The all-pad row's
    scores lie near -1e9, where one fp64 ulp is 1.2e-7, so the finite
    differences take eps 1e-3 (round-off 1.2e-7 / 2e-3 = 6e-5 in a
    difference) and atol 1e-3; the fault was 5.6."""
    q, k, v, mask, _ = (torch.from_numpy(a.astype("float64")) for a in _inputs(s=6, seed=3))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.fused_attention_fwd(a, b, c, mask, causal, 0.45), (q, k, v),
        eps=1e-3, atol=1e-3)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_all_pad_row_probabilities_sum_to_one(causal):
    """The backward's P = exp((s - m) - log l) is the softmax on every
    row; the log-sum-exp m + log l rounds to -1e9 on the all-pad row."""
    q, k, v, mask, _ = (torch.from_numpy(a) for a in _inputs(seed=4))
    _, stats = fa.fused_attention_plain(q, k, v, mask, causal, 0.5, return_stats=True)
    s = fa._scores(q, k, mask, causal, 0.5)
    p = torch.exp((s - stats[0][..., None]) - stats[1][..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones(p.shape[:3]), atol=1e-6, rtol=0)
    torch.testing.assert_close(p, torch.softmax(s, -1), atol=1e-6, rtol=0)
    assert (fa.row_lse(stats)[1] == -1e9).all()
