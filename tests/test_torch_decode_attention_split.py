"""Kernel B3's split plan and the cases the card holds the kernel to, on
the CPU: ``split_plan(T, rows, sms, tile)`` for every T from 1 to 4,096
(each position in exactly one chunk, at most 8 chunks and no more CTAs
than two an SM, a tile for each warp, chunks of whole 32-position
pieces); the plain version
(``decode_attention_plain``) against the JAX package's int8 attention at
cache lengths that are not a multiple of the chunk, with ``ts`` at each
chunk boundary and one either side of it, and the widest verify clamped
at T - 1, within 2e-6 of max |ctx| (fp32 sums of up to 2,000 terms in
another order: ``test_torch_int8_kv.py`` holds the same comparison to
1e-6 absolute at T = 40 and Dh = 16, where sums are shorter and max
|ctx| is near 1; here it is near 3).  The card tests
(``test_torch_cuda.py``) hold the kernel to the plain version at the
same cases.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import decode_attention as kda
from torch_b3_cases import b3_inputs, boundary_positions

JAX_TOL = 2e-6  # the plain version against the JAX package's, of max |ctx|


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("rows,sms", [(1, 132), (32, 132), (256, 132), (64, 114)])
def test_split_plan_covers_every_position_once(rows, sms, tile):
    for T in range(1, 4097):
        C, chunk = kda.split_plan(T, rows, sms, tile)
        assert 1 <= C <= kda.MAX_SPLIT, T
        assert C <= max(1, kda.CTAS_PER_SM * sms // rows), T  # no more CTAs than the card keeps
        assert chunk % kda.SPLIT_TILE == 0, T
        starts = [r * chunk for r in range(C)]
        assert all(s % kda.SPLIT_TILE == 0 for s in starts)
        seen = np.zeros(T, np.int64)
        for s in starts:
            assert s < T, (T, C, chunk)  # no empty chunk
            seen[s:min(s + chunk, T)] += 1
        assert (seen == 1).all(), T
        # a tile for each warp, and no CTA takes more than its share, give or take a tile
        assert C == 1 or chunk >= kda.WARPS * tile, T
        assert chunk <= max(kda.WARPS * tile, -(-T // C) + kda.SPLIT_TILE - 1), T
    with pytest.raises(ValueError):
        kda.split_plan(0)


def test_split_plan_at_the_lm_shapes():
    """The LM's 32 slots x 8 heads fill an H100's 132 SMs without a split;
    4 slots take 8 CTAs a (slot, head) at 2,048 positions.  At the int8
    server's 8- and 16-slot rungs the step (K = 1, 32-position tiles)
    splits 512 positions 4 and 2 ways and 256 positions 2 ways, and the
    verify (K = 4, 64-position tiles) splits only 512 positions, 2 ways."""
    assert kda.split_plan(512, 256, 132) == (1, 512)
    assert kda.split_plan(2048, 256, 132) == (1, 2048)
    assert kda.split_plan(2048, 32, 132) == (8, 256)
    assert kda.split_plan(300) == (2, 160)
    step, verify = kda.tile_positions(1, 64), kda.tile_positions(4, 64)
    assert (step, verify, kda.tile_positions(4, 128), kda.tile_positions(2, 32)) == (32, 64, 32, 32)
    assert [kda.split_plan(T, S * 8, 132, step) for S, T in [(8, 512), (8, 256), (16, 512), (16, 256)]] \
        == [(4, 128), (2, 128), (2, 256), (2, 128)]
    assert [kda.split_plan(T, S * 8, 132, verify) for S, T in [(8, 512), (8, 256), (16, 512), (16, 256)]] \
        == [(2, 256), (1, 256), (2, 256), (1, 256)]


def test_verify_width():
    assert [kda.verify_width(k) for k in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    for bad in (0, 9):
        with pytest.raises(ValueError):
            kda.verify_width(bad)


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    """The kernel's entries take CUDA tensors only: a CPU or meta tensor
    raises before anything is built, while ``decode_attention`` answers a
    meta tensor with a shape."""
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(a) for a in b3_inputs(rng, 100, 2, 32, H=2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kda.decode_attention_kernel(*args, 0.25)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kda.decode_attention_kernel(*meta, 0.25, plan=(1, 128))
    assert kda.decode_attention(*meta, 0.25).shape == args[0].shape


@pytest.mark.parametrize("T,K", [(100, 1), (100, 8), (300, 2), (300, 3), (300, 8), (1000, 4),
                                 (1000, 8)])
def test_boundary_positions(T, K):
    ts = boundary_positions(T, K)
    C, chunk = kda.split_plan(T)
    assert 0 in ts and T - 1 in ts and T - K in ts
    for r in range(1, C):
        assert {r * chunk - 1, r * chunk, r * chunk + 1} <= set(ts)
    assert all(0 <= t < T for t in ts)


def _jax_dequant_attend(q, kc, ks, vc, vs, ts, scale):
    """The JAX package's int8 attention (decoding.py's verify fn math, K
    queries a slot; K = 1 is the step's)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.quant import dequantize_rows

    K = q.shape[1]
    T = kc.shape[2]
    p = jnp.minimum(jnp.asarray(ts)[:, None] + jnp.arange(K)[None, :], T - 1)
    pos_ok = jnp.arange(T)[None, None, None, :] <= p[:, :, None, None]
    kf = dequantize_rows(jnp.asarray(kc), jnp.asarray(ks))
    vf = dequantize_rows(jnp.asarray(vc), jnp.asarray(vs))
    scores = jnp.einsum("skhd,shtd->skht", jnp.asarray(q), kf) * scale
    w = jax.nn.softmax(jnp.where(pos_ok, scores, -1e9), axis=-1)
    return np.asarray(jnp.einsum("skht,shtd->skhd", w, vf))


@pytest.mark.parametrize("T,K", [(100, 1), (100, 4), (300, 1), (300, 4), (300, 8), (700, 2),
                                 (700, 8), (1000, 3), (1000, 8), (2000, 1)])
def test_plain_matches_jax_at_chunk_boundaries(T, K):
    rng = np.random.RandomState(T + K)
    q, kc, ks, vc, vs, ts = b3_inputs(rng, T, K, 32, H=2)
    assert T % kda.split_plan(T)[1] != 0
    if K == 8:
        assert int(ts.max()) + K - 1 > T - 1  # the widest verify clamps at T - 1
    scale = 32 ** -0.5
    want = _jax_dequant_attend(q, kc, ks, vc, vs, ts, scale)
    got = kda.decode_attention(*[torch.from_numpy(a) for a in (q, kc, ks, vc, vs, ts)], scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_TOL * np.abs(want).max())
