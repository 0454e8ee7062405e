"""Auto-regressive decoding: greedy and beam search, full-prefix and
KV-cached (the fp32 half of the JAX package's ``decoding.py``).

Reference: paddle/fluid/operators/beam_search_op.cc +
beam_search_decode_op.cc, driven from Python by a While loop over
LoDTensorArray (book test test_machine_translation.py).  Beams are a
dense [batch, beam] axis, as in the JAX package; where it ran one
``lax.fori_loop`` in a compiled module, the port runs a Python loop of
``max_len - 1`` steps over tensors on the device.  Nothing in the loop
reads a value on the host (the beam bookkeeping is gathers, a stable
sort and ``torch.where``), so the steps queue on the stream without a
sync until the caller reads the tokens.

Two regimes:

* ``beam_search`` / ``greedy_search``: the model forward re-runs over
  the full padded prefix each step (any ``logits_fn``; O(T^2) forwards).
  ``make_program_logits_fn`` makes one from an inference Program: on a
  card a captured entry of the port's executor (one graph replay a
  step), on the CPU the interpreter.
* ``beam_search_cached`` / ``greedy_search_cached``: the caller's
  ``step_fn(cache, tokens, t) -> (logits, cache)`` consumes ONE token a
  step and carries per-layer key/value caches; the beam reorder gathers
  cache rows by parent.  ``make_transformer_lm_step_fn`` builds one from
  a ``models.transformer.transformer_lm`` Program's weights.

Ties are broken as ``jax.lax.top_k`` breaks them (the lower index
first), so the port's beams are the JAX package's on equal scores too.

The slot-pool builders serve continuous batching (``serving.kv_pool``,
``serving.decode``): ``make_transformer_lm_pooled_step_fn`` (per-row
positions), ``make_transformer_lm_pooled_verify_fn`` (K positions a row
in one call, for speculative decode), ``make_slot_decode_fns`` (the
pool's ``chunk`` / ``admit`` / ``release``) and ``make_prefix_admit_fn``.
Where the JAX package returns a new cache and a new pool state, these
write the pool's tensors in place and return them: each row's fresh
K/V row goes to ``(row, ts[row])`` with one indexed write, the values
the JAX package's one-hot ``where`` gives, with no copy of the cache.
That is what lets a pool capture them once as CUDA graphs over fixed
buffers.  The scalar-``t`` step keeps its functional cache (beam search
reorders caches by parent).  ``kv_dtype="int8"`` stores the cache as
int8 codes with per-(slot, head, position) fp32 scales
(``quant.quantize_rows`` on write); its attention is
``kernels.decode_attention``, which dequantizes in registers on the card.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.ops import common

__all__ = [
    "beam_search", "greedy_search", "make_program_logits_fn",
    "beam_search_cached", "greedy_search_cached",
    "make_transformer_lm_step_fn",
    "make_transformer_lm_pooled_step_fn", "make_slot_decode_fns",
    "make_transformer_lm_pooled_verify_fn", "make_prefix_admit_fn",
    "kv_leaf_seq_axis", "normalize_kv_dtype",
    "random_transformer_lm_state",
]

#: KV-cache storage dtypes the pooled builders accept.  "int8" stores
#: K/V rows quantized (per-slot-per-head-per-position absmax scales as
#: sibling ``k_scale``/``v_scale`` leaves — see paddle_tpu_torch.quant),
#: quantize-on-write / dequant-at-attend inside the step.
KV_DTYPES = ("fp32", "int8")


def normalize_kv_dtype(kv_dtype) -> str:
    d = str(kv_dtype or "fp32").lower()
    d = {"float32": "fp32", "fp32": "fp32", "int8": "int8"}.get(d)
    if d is None:
        raise ValueError(
            "unsupported kv_dtype %r (supported: %s)"
            % (kv_dtype, list(KV_DTYPES)))
    return d


def random_transformer_lm_state(rng, vocab, d_model, n_layer, n_head,
                                d_inner, max_pos, name="lm"):
    """A randomly initialized transformer-LM weight dict with exactly
    the keys ``make_transformer_lm_step_fn`` reads (numpy, float32)."""
    w = {name + "_word_emb": rng.randn(vocab, d_model) * 0.1,
         name + "_pos_emb": rng.randn(max_pos, d_model) * 0.1,
         name + "_head_w": rng.randn(d_model, vocab) * 0.1,
         name + "_head_b": np.zeros(vocab)}
    for i in range(n_layer):
        p = "%s_dec_%d" % (name, i)
        for nm, shp in (("_att_q", (d_model, d_model)),
                        ("_att_k", (d_model, d_model)),
                        ("_att_v", (d_model, d_model)),
                        ("_att_out", (d_model, d_model)),
                        ("_ffn_fc0", (d_model, d_inner)),
                        ("_ffn_fc1", (d_inner, d_model))):
            w[p + nm + "_w"] = rng.randn(*shp) * 0.1
            w[p + nm + "_b"] = np.zeros(shp[1])
        for ln in ("_ln1", "_ln2"):
            w[p + ln + "_scale"] = np.ones(d_model)
            w[p + ln + "_bias"] = np.zeros(d_model)
    return {k: np.asarray(v, "float32") for k, v in w.items()}


def _on(device, v):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(device)


def make_program_logits_fn(program, state, feed_names, logits_name, place=None):
    """Lower an inference program into ``logits_fn(feeds_dict) -> logits``
    for use inside the decode loop.  ``state``: persistable name -> array
    or tensor (the trained params), moved to the device once; ``place``:
    ``cuda:0`` by default (raising without a card), ``CPUPlace()`` for
    the CPU.

    On a card the program runs as an entry of the port's ``Executor``
    over a scope holding the weights: a decode loop's feeds keep their
    shapes, so the first call runs eagerly, the second captures the
    program as a CUDA graph and every later call replays it (the logits
    leave as a copy of the graph's buffer).  On the CPU it runs the
    interpreter (``core/lowering.lower_block``).  ``logits_fn.device``
    says where, ``logits_fn.executor`` is the card's executor (None on
    the CPU)."""
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.executor import Executor
    from paddle_tpu_torch.scope import Scope

    device = framework.device_of(place)
    weights = {k: _on(device, v) for k, v in state.items()}
    if device.type == "cuda":
        exe, scope = Executor(framework.CUDAPlace(device.index or 0)), Scope()
        scope.vars.update(weights)

        def logits_fn(feeds):
            return exe.run(program, feed={k: _on(device, v) for k, v in feeds.items()},
                           fetch_list=[logits_name], scope=scope, return_numpy=False)[0]
    else:
        exe = None
        fn = lowering.lower_block(program.global_block(), feed_names, [logits_name], [], device)

        def logits_fn(feeds):
            with torch.no_grad():
                fetches, _ = fn(dict(weights), {k: _on(device, v) for k, v in feeds.items()})
            return fetches[0]

    logits_fn.device = device
    logits_fn.executor = exe
    return logits_fn


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _beam_core(step, state0, B, K, bos_id, eos_id, max_len, length_penalty, device):
    """Shared beam bookkeeping for the full-prefix and KV-cached paths.

    ``step(state, tokens_flat [B*K, max_len], t) -> (logits [B*K, V],
    state)`` returns the next-token logits for loop position ``t``;
    ``state``'s leaves carry a leading B*K axis and are gathered by the
    winning parents after each selection."""
    NEG = -1e9
    tokens = torch.full((B, K, max_len), eos_id, dtype=torch.int64, device=device)
    tokens[:, :, 0] = bos_id
    scores = torch.where(torch.arange(K, device=device)[None, :] == 0, 0.0, NEG).expand(B, K)
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    lanes = (torch.arange(B, device=device) * K)[:, None]
    eos_only = None
    st = state0
    for t in range(1, max_len):
        logits, st = step(st, tokens.reshape(B * K, max_len), t)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, -1)
        V = logp.shape[-1]
        if eos_only is None:  # finished beams may only extend with EOS at zero cost
            eos_only = torch.full((V,), NEG, device=device)
            eos_only[eos_id] = 0.0
        logp = torch.where(finished[..., None], eos_only, logp)
        scores, top_idx = common.top_k((scores[..., None] + logp).reshape(B, K * V), K)
        parent = top_idx // V
        tok = top_idx % V
        tokens = tokens.gather(1, parent[..., None].expand(B, K, max_len))
        tokens[:, :, t] = tok
        finished = finished.gather(1, parent) | (tok == eos_id)
        rows = (lanes + parent).reshape(-1)
        st = _tree_map(lambda c: c[rows], st)
    if length_penalty > 0.0:
        lengths = (tokens != eos_id).float().sum(-1) + 1.0
        scores = scores / lengths ** length_penalty
        order = torch.sort(-scores, dim=-1, stable=True).indices
        tokens = tokens.gather(1, order[..., None].expand(B, K, max_len))
        scores = scores.gather(1, order)
    return tokens, scores


def _device_of(src, logits_fn=None):
    if isinstance(src, torch.Tensor):
        return src.device
    dev = getattr(logits_fn, "device", None)
    return dev if dev is not None else framework.device_of(None)


def beam_search(
    logits_fn: Callable,
    src,
    bos_id: int,
    eos_id: int,
    beam_size: int = 4,
    max_len: int = 16,
    src_feed_name: str = "src",
    tgt_feed_name: str = "tgt",
    length_penalty: float = 0.0,
    extra_feeds: Optional[dict] = None,
):
    """Returns (tokens [B, beam, max_len], scores [B, beam]) sorted best
    first, as tensors on the decode's device (``src``'s, or
    ``logits_fn.device``).  ``logits_fn`` maps {src, tgt [N, max_len]}
    -> [N, max_len, V]."""
    device = _device_of(src, logits_fn)
    src = _on(device, src)
    B, K = src.shape[0], beam_size
    feeds = {src_feed_name: src.repeat_interleave(K, dim=0)}
    for k, v in (extra_feeds or {}).items():
        feeds[k] = _on(device, v).repeat_interleave(K, dim=0)

    def step(state, flat, t):
        logits = logits_fn(dict(feeds, **{tgt_feed_name: flat}))  # [B*K, T, V]
        return logits[:, t - 1, :], state

    return _beam_core(step, None, B, K, bos_id, eos_id, max_len, length_penalty, device)


def greedy_search(logits_fn, src, bos_id, eos_id, max_len=16, **kwargs):
    """Greedy = beam 1; returns (tokens [B, max_len], scores [B])."""
    tokens, scores = beam_search(
        logits_fn, src, bos_id, eos_id, beam_size=1, max_len=max_len, **kwargs
    )
    return tokens[:, 0], scores[:, 0]


# ---------------------------------------------------------------------------
# KV-cached decoding
# ---------------------------------------------------------------------------
def _cache_device(cache):
    leaves = []
    _tree_map(leaves.append, cache)
    return leaves[0].device


def beam_search_cached(
    step_fn: Callable,
    init_cache,
    batch: int,
    bos_id: int,
    eos_id: int,
    beam_size: int = 4,
    max_len: int = 16,
    length_penalty: float = 0.0,
):
    """Beam search with a KV cache carried through the loop.

    ``step_fn(cache, tokens [N], t) -> (logits [N, V], cache)``: consume
    the token at position ``t`` and return logits for position
    ``t + 1``; cache leaves carry a leading ``N = batch * beam`` axis
    so the beam reorder can gather rows by parent.  ``init_cache``: the
    zeroed cache (leaves ``[N, ...]``, on the decode's device)."""

    def step(cache, flat, t):
        return step_fn(cache, flat[:, t - 1], t - 1)

    return _beam_core(step, init_cache, batch, beam_size, bos_id, eos_id,
                      max_len, length_penalty, _cache_device(init_cache))


def greedy_search_cached(step_fn, init_cache, batch, bos_id, eos_id,
                         max_len=16, **kwargs):
    """Greedy = beam 1 on the cached path; returns ([B, max_len], [B])."""
    tokens, scores = beam_search_cached(
        step_fn, init_cache, batch, bos_id, eos_id, beam_size=1,
        max_len=max_len, **kwargs
    )
    return tokens[:, 0], scores[:, 0]


def make_transformer_lm_step_fn(
    state,
    vocab_size: int,
    d_model: int,
    n_layer: int,
    n_head: int,
    d_inner: int,
    max_len: int,
    name: str = "lm",
    place=None,
):
    """Build (step_fn, make_cache) for KV-cached decoding from a trained
    ``models.transformer.transformer_lm`` Program's weights.

    ``state``: persistable name -> array or tensor, moved to ``place``
    (``cuda:0`` by default, raising without a card).  Mirrors the
    Program math — post-LN blocks (eps 1e-5), exact (erf) gelu FFN,
    per-head scaled dot product — on an incrementally updated
    ``[N, H, T, Dh]`` key/value cache per layer.  ``make_cache(n_rows)``
    allocates the zeroed cache for ``n_rows = batch * beam`` lanes."""
    device = framework.device_of(place)
    d_head = d_model // n_head
    W = {k: _on(device, v).float() for k, v in state.items()}
    scale = 1.0 / float(np.sqrt(d_head))

    def make_cache(n_rows: int):
        return [{"k": torch.zeros((n_rows, n_head, max_len, d_head), device=device),
                 "v": torch.zeros((n_rows, n_head, max_len, d_head), device=device)}
                for _ in range(n_layer)]

    def step_fn(cache, tokens, t):
        # tokens [N]; t: the position being consumed (a Python int)
        with torch.no_grad():
            x = W[name + "_word_emb"][tokens.long()] + W[name + "_pos_emb"][t]
            return _lm_forward_one(W, name, cache, x, t, None, n_layer, n_head, d_head,
                                   d_model, scale)

    return step_fn, make_cache




def _lm_forward_one(W, name, cache, x, t, ts, n_layer, n_head, d_head, d_model, scale,
                    kv_int8=False):
    """One incremental transformer-LM forward shared by the scalar-``t``
    and slot-pooled (per-row ``ts``) step fns.  Exactly one of ``t``
    (a Python int, all rows aligned) / ``ts`` ([N] int32 tensor, each
    row at its own position) is not None; the cache T axis is read from
    the cache itself so one builder serves every length rung.

    Scalar ``t``: each layer's new K/V row goes into a copy of its cache
    (the caller keeps the old one, as beam search's reorder needs).
    Per-row ``ts``: the pool's cache is written in place, row ``i`` at
    ``ts[i]`` with one indexed write, and the same cache is returned.  A
    position past the cache is clamped to its last row, where the JAX
    package's one-hot select writes nothing; such a lane is past its
    length cap and the pool never reads it back.

    ``kv_int8`` (pooled path only): the cache stores K/V rows int8 with
    per-(slot, head, position) fp32 scales as sibling ``k_scale``/``v_scale`` leaves; each
    fresh row is quantized as it is written and the attention reads the
    codes through ``kernels.decode_attention`` (dequantized in registers
    on the card)."""
    from paddle_tpu_torch.kernels import decode_attention as kda

    T = cache[0]["k"].shape[2]
    n = x.shape[0]
    dev = x.device
    if kv_int8 and ts is None:
        raise ValueError("the int8 KV cache needs per-row positions (the pooled step fn)")
    if ts is None:
        pos_ok = (torch.arange(T, device=dev) <= t)[None, None, :]
        cache = list(cache)
    else:
        tl = ts.long()
        rows = torch.arange(n, device=dev)
        wpos = tl.clamp(0, T - 1)
        pos_ok = (torch.arange(T, device=dev)[None, :] <= tl[:, None])[:, None, :]  # [N,1,T]
    if kv_int8:
        from paddle_tpu_torch.quant import quantize_rows
    for i in range(n_layer):
        p = "%s_dec_%d" % (name, i)
        q = _fc(W, x, p + "_att_q").reshape(n, n_head, d_head)
        k = _fc(W, x, p + "_att_k").reshape(n, n_head, d_head)
        v = _fc(W, x, p + "_att_v").reshape(n, n_head, d_head)
        c = cache[i]
        if kv_int8:
            # quantize-on-write: one absmax scale per fresh (row, head)
            kq, ks = quantize_rows(k)                        # [N,H,Dh], [N,H]
            vq, vs = quantize_rows(v)
            c["k"][rows, :, wpos] = kq
            c["v"][rows, :, wpos] = vq
            c["k_scale"][rows, :, wpos] = ks
            c["v_scale"][rows, :, wpos] = vs
            ctx = kda.decode_attention(q[:, None], c["k"], c["k_scale"], c["v"], c["v_scale"],
                                       ts, scale)[:, 0].reshape(n, d_model)
        else:
            if ts is None:
                kc, vc = c["k"].clone(), c["v"].clone()
                kc[:, :, t] = k
                vc[:, :, t] = v
                cache[i] = {"k": kc, "v": vc}
            else:
                kc, vc = c["k"], c["v"]
                kc[rows, :, wpos] = k
                vc[rows, :, wpos] = v
            scores = torch.einsum("nhd,nhtd->nht", q, kc) * scale
            w = torch.softmax(torch.where(pos_ok, scores, -1e9), dim=-1)
            ctx = torch.einsum("nht,nhtd->nhd", w, vc).reshape(n, d_model)
        x = _ln(W, x + _fc(W, ctx, p + "_att_out"), p + "_ln1")
        h = torch.nn.functional.gelu(_fc(W, x, p + "_ffn_fc0"))
        x = _ln(W, x + _fc(W, h, p + "_ffn_fc1"), p + "_ln2")
    return _fc(W, x, name + "_head"), cache


def _fc(W, x, pname):
    return x @ W[pname + "_w"] + W[pname + "_b"]


def _ln(W, x, pname):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5) * W[pname + "_scale"] + W[pname + "_bias"]


def _gather_ids(table, ids):
    """``table[ids]`` with the ids clamped into the table, as the JAX
    package's gather clamps (an out-of-range id must not fault the card)."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def _cache_maker(device, n_layer, n_head, d_head, kv_int8):
    def make_cache(n_rows: int, seq_len: int, device=device):
        shp = (n_rows, n_head, seq_len, d_head)
        if kv_int8:
            return [{"k": torch.zeros(shp, dtype=torch.int8, device=device),
                     "k_scale": torch.zeros(shp[:3], device=device),
                     "v": torch.zeros(shp, dtype=torch.int8, device=device),
                     "v_scale": torch.zeros(shp[:3], device=device)}
                    for _ in range(n_layer)]
        return [{"k": torch.zeros(shp, device=device), "v": torch.zeros(shp, device=device)}
                for _ in range(n_layer)]

    return make_cache


def make_transformer_lm_pooled_step_fn(
    state,
    vocab_size: int,
    d_model: int,
    n_layer: int,
    n_head: int,
    d_inner: int,
    name: str = "lm",
    kv_dtype: str = "fp32",
    place=None,
):
    """The slot-pool variant of :func:`make_transformer_lm_step_fn`.

    Continuous batching decodes a POOL of sequences that are each at a
    different position, so the step consumes per-row positions:
    ``step_fn(cache, tokens [N] int32, ts [N] int32) -> (logits [N, V],
    cache)`` where row ``i`` consumes ``tokens[i]`` at position
    ``ts[i]`` (cache row ``i`` written in place at ``ts[i]``; its
    attention masked to positions ``<= ts[i]``).  The returned cache is
    the one passed in.

    The cache T axis is read from the cache tensors, so one step fn
    serves every length rung: ``make_cache(n_rows, seq_len)`` allocates
    the zeroed cache for one (slot-rung, length-rung) pair on ``place``
    (``cuda:0`` by default, raising without a card; ``make_cache(...,
    device="meta")`` gives shapes and types only).

    The pool relies on a write-before-read invariant instead of cache
    zeroing on slot reuse: a sequence at position ``ts`` has itself
    written every cache position ``<= ts``, and the mask hides ``> ts``.

    ``kv_dtype="int8"`` stores the cache int8 with per-slot-per-head
    scales as sibling ``k_scale``/``v_scale`` [N, H, T] fp32 leaves
    (quantize-on-write, dequant-at-attend in ``kernels.decode_attention``):
    about a quarter of fp32's bytes a slot.
    """
    kv_int8 = normalize_kv_dtype(kv_dtype) == "int8"
    device = framework.device_of(place)
    d_head = d_model // n_head
    W = {k: _on(device, v).float() for k, v in state.items()}
    scale = 1.0 / float(np.sqrt(d_head))

    def step_fn(cache, tokens, ts):
        with torch.no_grad():
            x = _gather_ids(W[name + "_word_emb"], tokens) + _gather_ids(W[name + "_pos_emb"], ts)
            return _lm_forward_one(W, name, cache, x, None, ts, n_layer, n_head, d_head,
                                   d_model, scale, kv_int8=kv_int8)

    step_fn.device = device
    return step_fn, _cache_maker(device, n_layer, n_head, d_head, kv_int8)


def make_transformer_lm_pooled_verify_fn(
    state,
    vocab_size: int,
    d_model: int,
    n_layer: int,
    n_head: int,
    d_inner: int,
    name: str = "lm",
    kv_dtype: str = "fp32",
    place=None,
):
    """The K-wide teacher-forced forward for speculative verification.

    ``verify_fn(cache, tokens [S, K] int32, ts [S] int32) -> (logits
    [S, K, V], cache)``: row ``i`` consumes ``tokens[i, j]`` at position
    ``ts[i] + j`` for every ``j`` in one call — the math of K sequential
    :func:`make_transformer_lm_pooled_step_fn` steps, with causal
    masking among the K fresh positions.  Positions are clamped to the
    cache T axis; a clamped lane is past its buffer, inactive or
    finished, and its results are never committed.  The K fresh K/V rows
    are written into the cache in place (one indexed write, an exact
    copy) before attention, so position ``ts + j`` attends to the rows
    ``ts .. ts + j`` just written.

    With ``kv_dtype="int8"`` each fresh row is quantized exactly as the
    sequential step quantizes it, and the attention is
    ``kernels.decode_attention`` over K queries a slot.
    """
    from paddle_tpu_torch.kernels import decode_attention as kda

    kv_int8 = normalize_kv_dtype(kv_dtype) == "int8"
    device = framework.device_of(place)
    d_head = d_model // n_head
    W = {k: _on(device, v).float() for k, v in state.items()}
    scale = 1.0 / float(np.sqrt(d_head))
    if kv_int8:
        from paddle_tpu_torch.quant import quantize_rows

    def verify_fn(cache, tokens, ts):
        with torch.no_grad():
            S, K = tokens.shape
            T = cache[0]["k"].shape[2]
            dev = tokens.device
            p = torch.clamp_max(ts.long()[:, None] + torch.arange(K, device=dev)[None, :], T - 1)
            rows = torch.arange(S, device=dev)[:, None]
            x = _gather_ids(W[name + "_word_emb"], tokens) + _gather_ids(W[name + "_pos_emb"], p)
            if not kv_int8:
                pos_ok = torch.arange(T, device=dev)[None, None, None, :] <= p[:, :, None, None]
            for i in range(n_layer):
                pfx = "%s_dec_%d" % (name, i)
                q = _fc(W, x, pfx + "_att_q").reshape(S, K, n_head, d_head)
                k = _fc(W, x, pfx + "_att_k").reshape(S, K, n_head, d_head)
                v = _fc(W, x, pfx + "_att_v").reshape(S, K, n_head, d_head)
                c = cache[i]
                if kv_int8:
                    kq, ks = quantize_rows(k)                  # [S,K,H,Dh], [S,K,H]
                    vq, vs = quantize_rows(v)
                    c["k"][rows, :, p] = kq
                    c["v"][rows, :, p] = vq
                    c["k_scale"][rows, :, p] = ks
                    c["v_scale"][rows, :, p] = vs
                    ctx = kda.decode_attention(q, c["k"], c["k_scale"], c["v"], c["v_scale"],
                                               ts, scale).reshape(S, K, d_model)
                else:
                    c["k"][rows, :, p] = k
                    c["v"][rows, :, p] = v
                    scores = torch.einsum("skhd,shtd->skht", q, c["k"]) * scale
                    w = torch.softmax(torch.where(pos_ok, scores, -1e9), dim=-1)
                    ctx = torch.einsum("skht,shtd->skhd", w, c["v"]).reshape(S, K, d_model)
                x = _ln(W, x + _fc(W, ctx, pfx + "_att_out"), pfx + "_ln1")
                h = torch.nn.functional.gelu(_fc(W, x, pfx + "_ffn_fc0"))
                x = _ln(W, x + _fc(W, h, pfx + "_ffn_fc1"), pfx + "_ln2")
            return _fc(W, x, name + "_head"), cache

    verify_fn.device = device
    return verify_fn


# ---------------------------------------------------------------------------
# Slot-pool decode: the multi-token chunk + admit/release
# ---------------------------------------------------------------------------
def kv_tree_leaves(tree):
    """The tensor leaves of a cache tree in the JAX package's
    ``tree_flatten`` order (dict keys sorted, list order kept), so
    ``extract_kv`` and ``admit_prefix`` leaf lists line up with its."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in kv_tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in kv_tree_leaves(v)]
    return [tree]


def assign_tree(dst, src):
    """Write ``src``'s leaves into ``dst``'s tensors in place (a step fn
    that returns fresh tensors still leaves its results in the pool's
    buffers); leaves that are the same tensor are left alone."""
    for d, s in zip(kv_tree_leaves(dst), kv_tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def make_slot_decode_fns(step_fn, eos_id: int, steps: int, draft_step_fn=None):
    """The three functions the serving slot pool runs per (slot-rung,
    length-rung) pair: ``chunk(state) -> state`` advancing every active
    slot by up to ``steps`` tokens (``steps`` step bodies in a row, the
    unrolled form of the JAX package's ``fori_loop``), ``admit(state,
    slot_mask, prompt, prompt_len, total_len) -> state`` seating one
    request into a free slot, and ``release(state, slot_mask) -> state``
    deactivating slots mid-flight.  Each writes ``state``'s tensors in
    place and returns ``state``; nothing reads a value back to the host,
    so a pool captures each once as a CUDA graph.

    The pool state is a dict (every leaf's axis 0 is the slot):

    * ``cache``    — the step fn's KV tree (T axis read by the step)
    * ``tokens``   — [S, T] int32, position-indexed token buffer
    * ``pos``      — [S] int32, tokens consumed so far (the step eats
      index ``pos`` and produces the token for ``pos + 1``)
    * ``prompt_len``/``total_len`` — [S] int32 per-slot prompt size and
      overall length cap (prompt + generated <= total_len <= T)
    * ``active``/``finished`` — [S] bool scheduler flags
    * ``n_gen``    — [S] int32 generated-token count

    Prefill and decode are the SAME step: while ``pos + 1 <
    prompt_len`` the produced token is discarded in favor of the stored
    prompt token (teacher forcing).  A slot finishes when it emits
    ``eos_id`` or reaches ``total_len``; inactive slots do not advance.

    Extra state leaves pass through untouched, so the speculative pool's
    ``spec`` flag and ``draft_cache`` ride the same functions.  With
    ``draft_step_fn`` the chunk also teacher-forces each consumed token
    through the draft model, keeping ``state["draft_cache"]``
    position-synced with the target.  ``admit`` takes an optional
    trailing ``spec_flag`` marking the seated slot speculative.
    """

    def _body(state):
        tokens, pos, active = state["tokens"], state["pos"], state["active"]
        S, T = tokens.shape
        rows = torch.arange(S, device=tokens.device)
        tok_in = tokens[rows, torch.clamp_max(pos.long(), T - 1)]
        logits, cache = step_fn(state["cache"], tok_in, pos)
        assign_tree(state["cache"], cache)
        if draft_step_fn is not None:
            _, dcache = draft_step_fn(state["draft_cache"], tok_in, pos)
            assign_tree(state["draft_cache"], dcache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        write_idx = torch.clamp_max(pos.long() + 1, T - 1)
        do_write = active & ~((pos + 1) < state["prompt_len"])
        tokens[rows, write_idx] = torch.where(do_write, nxt, tokens[rows, write_idx])
        newly_fin = do_write & ((nxt == eos_id) | ((pos + 2) >= state["total_len"]))
        pos.copy_(torch.where(active, pos + 1, pos))
        state["finished"].logical_or_(newly_fin)
        active.logical_and_(~newly_fin)
        state["n_gen"].add_(do_write.to(torch.int32))

    def chunk(state):
        with torch.no_grad():
            for _ in range(steps):
                _body(state)
        return state

    def admit(state, slot_mask, prompt, prompt_len, total_len, spec_flag=None):
        # slot_mask [S] bool (one admitted slot), prompt [T] int32 (padded
        # by the caller), prompt_len/total_len 0-d int32 tensors.  The
        # cache is left as it is: write-before-read makes zeroing a
        # reused slot's rows unnecessary.
        m = slot_mask
        with torch.no_grad():
            state["tokens"].copy_(torch.where(m[:, None], prompt[None, :], state["tokens"]))
            state["pos"].masked_fill_(m, 0)
            state["prompt_len"].copy_(torch.where(m, prompt_len, state["prompt_len"]))
            state["total_len"].copy_(torch.where(m, total_len, state["total_len"]))
            state["active"].logical_or_(m)
            state["finished"].logical_and_(~m)
            state["n_gen"].masked_fill_(m, 0)
            if spec_flag is not None:
                state["spec"].copy_(torch.where(m, spec_flag, state["spec"]))
        return state

    def release(state, slot_mask):
        # deactivate without finishing: the slot becomes seatable again;
        # tokens and cache stay (write-before-read protects the next one)
        with torch.no_grad():
            state["active"].logical_and_(~slot_mask)
            state["finished"].logical_and_(~slot_mask)
        return state

    return chunk, admit, release


# ---------------------------------------------------------------------------
# Prefix KV installation (serving.prefix_cache's device half)
# ---------------------------------------------------------------------------
def kv_leaf_seq_axis(shape, n_slots: int, seq_len: int):
    """The sequence axis of a per-slot KV-cache leaf, or None when the
    leaf carries no per-slot sequence state (no leading slot axis of
    ``n_slots``, or no axis of size ``seq_len`` past it).

    Convention: the LAST axis of size ``seq_len`` that is not the final
    axis, else the final axis — the transformer cache is ``[S, H, T,
    Dh]`` (T at -2, robust to an ``H == T`` or ``Dh == T`` coincidence)
    and simple per-position buffers are ``[S, T]`` (T final).  Both the
    host extract/pad side and the install side resolve the axis through
    this one function so they can never disagree.
    """
    if len(shape) < 2 or shape[0] != n_slots:
        return None
    inner = tuple(shape[1:])
    cands = [i for i, d in enumerate(inner) if d == seq_len]
    if not cands:
        return None
    non_final = [i for i in cands if i != len(inner) - 1]
    return (non_final[-1] if non_final else cands[-1]) + 1


def make_prefix_admit_fn(admit_fn):
    """Wrap a :func:`make_slot_decode_fns` ``admit`` with shared-prefix
    KV installation: ``admit_prefix(state, slot_mask, prompt,
    prompt_len, total_len, kv_leaves, prefix_len[, spec_flag])`` seats
    the request as usual, then overwrites the slot's first
    ``prefix_len`` cache positions with the retained KV blocks and
    starts ``pos`` at ``prefix_len`` — prefill resumes at the unmatched
    suffix.

    ``kv_leaves`` is the leaf list of the state's KV subtrees (``cache``
    plus ``draft_cache`` when present, in :func:`kv_tree_leaves` order),
    each leaf padded along its sequence axis to the state's length rung;
    non-qualifying positions carry a ``(1,)`` dummy.  Qualification and
    the sequence axis are decided by shapes (:func:`kv_leaf_seq_axis`),
    so one function per rung pair serves every prefix length —
    ``prefix_len`` is a 0-d tensor.
    """

    def admit_prefix(state, slot_mask, prompt, prompt_len, total_len, kv_leaves, prefix_len,
                     spec_flag=None):
        if spec_flag is None:
            admit_fn(state, slot_mask, prompt, prompt_len, total_len)
        else:
            admit_fn(state, slot_mask, prompt, prompt_len, total_len, spec_flag)
        S, T = state["tokens"].shape
        keep = torch.arange(T, device=slot_mask.device) < prefix_len
        sub = {"cache": state["cache"]}
        if "draft_cache" in state:
            sub["draft_cache"] = state["draft_cache"]
        with torch.no_grad():
            for cur, pre in zip(kv_tree_leaves(sub), kv_leaves):
                ax = kv_leaf_seq_axis(tuple(cur.shape), S, T)
                if ax is None or tuple(pre.shape) != tuple(cur.shape[1:]):
                    continue
                kshape = [1] * cur.dim()
                kshape[ax] = T
                sel = slot_mask.reshape((S,) + (1,) * (cur.dim() - 1)) & keep.reshape(kshape)
                cur.copy_(torch.where(sel, pre[None].to(cur.dtype), cur))
            state["pos"].copy_(torch.where(slot_mask, prefix_len, state["pos"]))
        return state

    return admit_prefix
