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
The slot-pooled and prefix-admitting builders and the int8 KV cache
(``make_transformer_lm_pooled_step_fn``, ``make_slot_decode_fns``,
``make_transformer_lm_pooled_verify_fn``, ``make_prefix_admit_fn``,
``kv_leaf_seq_axis``) are not ported yet (ROADMAP A8, kernel B3).
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
    "make_transformer_lm_step_fn", "normalize_kv_dtype",
    "random_transformer_lm_state",
]

#: KV-cache storage dtypes the JAX package's pooled builders accept;
#: the port's cached path stores fp32 only.
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
            return _lm_forward_one(W, name, cache, x, t, n_layer, n_head, d_head, d_model,
                                   scale)

    return step_fn, make_cache


def _lm_forward_one(W, name, cache, x, t, n_layer, n_head, d_head, d_model, scale,
                    kv_int8=False):
    """One incremental transformer-LM forward at loop position ``t`` (all
    rows aligned); the cache's T axis is read from the cache.  Each
    layer's new K/V row is written into a copy of its cache."""
    if kv_int8:
        raise NotImplementedError(
            "the int8 KV cache is not ported to paddle_tpu_torch yet (ROADMAP A8, kernel B3)")
    n = x.shape[0]
    pos_ok = (torch.arange(cache[0]["k"].shape[2], device=x.device) <= t)[None, None, :]
    new_cache = []
    for i in range(n_layer):
        p = "%s_dec_%d" % (name, i)
        q = _fc(W, x, p + "_att_q").reshape(n, n_head, d_head)
        kc, vc = cache[i]["k"].clone(), cache[i]["v"].clone()
        kc[:, :, t] = _fc(W, x, p + "_att_k").reshape(n, n_head, d_head)
        vc[:, :, t] = _fc(W, x, p + "_att_v").reshape(n, n_head, d_head)
        new_cache.append({"k": kc, "v": vc})
        scores = torch.einsum("nhd,nhtd->nht", q, kc) * scale
        w = torch.softmax(torch.where(pos_ok, scores, -1e9), dim=-1)
        ctx = torch.einsum("nht,nhtd->nhd", w, vc).reshape(n, d_model)
        x = _ln(W, x + _fc(W, ctx, p + "_att_out"), p + "_ln1")
        h = torch.nn.functional.gelu(_fc(W, x, p + "_ffn_fc0"))
        x = _ln(W, x + _fc(W, h, p + "_ffn_fc1"), p + "_ln2")
    return _fc(W, x, name + "_head"), new_cache


def _fc(W, x, pname):
    return x @ W[pname + "_w"] + W[pname + "_b"]


def _ln(W, x, pname):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5) * W[pname + "_scale"] + W[pname + "_bias"]
