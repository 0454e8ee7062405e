"""Hybrid 5D-parallel transformer engine: dp / pp / tp / sp / ep.

The port's counterpart of the JAX package's ``parallel/hybrid.py``: one
training step of a transformer with MoE feed-forwards, over a mesh of five
named axes.  The JAX package writes the step as one jitted function under
``shard_map``; the port is SPMD across processes, one rank a mesh device
(``parallel/mesh.py``), and each rank runs the same step on its shards:

* dp: the batch's rows split over ``dp``;
* pp: a GPipe pipeline of microbatches.  Each rank holds ``n_layers / pp``
  layers (the stage-stacked parameters' first dim), and activations move
  stage to stage by ``mesh.ppermute``.  Every stage runs every one of the
  ``M + S - 1`` time steps, bubbles included, as the JAX ``lax.scan`` does,
  and picks its input and its output with ``torch.where``: so every
  rank's autograd graph is the same, and the collectives of the backward
  are issued in the same order on every rank;
* tp: the q/k/v and first MoE weights split by columns, the output and
  second MoE weights by rows, ``psum`` over ``tp`` after each row-parallel
  product; the logits gathered over ``tp``;
* sp: the sequence split over ``sp``.  Attention is ring attention
  (``parallel/ring_attention.py``: kernel B1's forward, B2's steps, and in
  the backward B1's dK/dV and dQ kernels) when ``ring_attention``, else
  the window's queries against K and V all-gathered over ``sp``;
* ep: the experts split over ``ep``; the gate's softmax over all experts,
  sliced to the rank's, and the MoE output ``psum`` over ``("ep", "tp")``.

The loss is ``psum`` over ``("dp", "pp", "sp")`` of the last stage's summed
token losses over ``batch * seq_len``, ``pmean`` over ``("tp", "ep")``.  The
gradient follows the JAX package's ``pre_vma`` route (its
``shard_map(check_rep=False)``): each collective's backward is the one
``parallel/mesh.py`` names, every rank seeds its copy of the loss with 1,
and ``reduce_grads`` sums each gradient over its parameter's replicated
axes and divides by the mesh's size.  The update replays the port's
registered ``sgd`` / ``momentum`` / ``adam`` kernel on each shard.

``init_params`` draws the JAX package's arrays bit for bit, so a seed gives
both packages the same weights; ``place`` cuts them into this rank's
shards on ``mesh.device`` (``cuda:(r % cards)``, or the CPU for a mesh made
with ``backend="cpu"``), the step takes and returns shards, and ``gather``
rebuilds full arrays for checks.  Token ids are int64.  ``reference_loss``
is the single-process loss the tests and the card check hold the step to.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from paddle_tpu_torch.parallel import mesh as mesh_lib

__all__ = ["HybridConfig", "init_params", "make_train_step", "reference_loss", "factorize_mesh"]

ALL_AXES = ("dp", "pp", "tp", "sp", "ep")
STAGE_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
              "wq", "wk", "wv", "wo", "gate_w", "moe_w0", "moe_w1")


class HybridConfig(NamedTuple):
    vocab_size: int = 1000
    d_model: int = 64
    n_head: int = 4
    d_ff: int = 128
    n_layers: int = 4
    n_experts: int = 4
    seq_len: int = 32
    batch: int = 8          # global batch
    microbatches: int = 2   # per dp-shard microbatch count (GPipe M)
    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    lr: float = 0.1
    ring_attention: bool = True  # sp>1: ring attention vs all-gather KV

    @property
    def layers_per_stage(self) -> int:
        assert self.n_layers % self.pp == 0
        return self.n_layers // self.pp

    def mesh_axes(self) -> Dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp, "sp": self.sp, "ep": self.ep}


def factorize_mesh(n_devices: int) -> Dict[str, int]:
    """Deterministically factor a device count onto the 5 axes, in the
    order pp, tp, dp, sp, ep (a prime above 13 goes to dp whole)."""
    sizes = {"dp": 1, "pp": 1, "tp": 1, "sp": 1, "ep": 1}
    order = ["pp", "tp", "dp", "sp", "ep"]
    n = n_devices
    i = 0
    while n > 1:
        for p in (2, 3, 5, 7, 11, 13):
            if n % p == 0:
                sizes[order[i % len(order)]] *= p
                n //= p
                break
        else:
            sizes["dp"] *= n
            n = 1
        i += 1
    return sizes


# ---------------------------------------------------------------------------
# parameters: stage-stacked, leading dim pp, second dim layers-per-stage
# ---------------------------------------------------------------------------
def _param_specs(cfg: HybridConfig):
    """name -> PartitionSpec (None = replicated on that dim)."""
    from paddle_tpu_torch.sharding.rules import PartitionSpec as P

    return {
        "word_emb": P(),
        "pos_emb": P(),
        "head": P(None, "tp"),
        "ln1_scale": P("pp"),
        "ln1_bias": P("pp"),
        "ln2_scale": P("pp"),
        "ln2_bias": P("pp"),
        "wq": P("pp", None, None, "tp"),
        "wk": P("pp", None, None, "tp"),
        "wv": P("pp", None, None, "tp"),
        "wo": P("pp", None, "tp", None),
        "gate_w": P("pp"),
        "moe_w0": P("pp", None, "ep", None, "tp"),
        "moe_w1": P("pp", None, "ep", "tp", None),
    }


def init_params(cfg: HybridConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's initial parameters, bit for bit (numpy)."""
    rng = np.random.RandomState(seed)
    S, L = cfg.pp, cfg.layers_per_stage
    D, F, E, V = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.vocab_size

    def rand(*shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[-2] if len(shape) >= 2 else D))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "word_emb": rand(V, D, scale=0.02),
        "pos_emb": rand(cfg.seq_len, D, scale=0.02),
        "head": rand(D, V),
        "ln1_scale": np.ones((S, L, D), np.float32),
        "ln1_bias": np.zeros((S, L, D), np.float32),
        "ln2_scale": np.ones((S, L, D), np.float32),
        "ln2_bias": np.zeros((S, L, D), np.float32),
        "wq": rand(S, L, D, D),
        "wk": rand(S, L, D, D),
        "wv": rand(S, L, D, D),
        "wo": rand(S, L, D, D),
        "gate_w": rand(S, L, D, E),
        "moe_w0": rand(S, L, E, D, F),
        "moe_w1": rand(S, L, E, F, D, scale=1.0 / np.sqrt(F)),
    }


# ---------------------------------------------------------------------------
# model math (shared by the sharded engine and the reference)
# ---------------------------------------------------------------------------
def _layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _attention_math(q, k, v, bias, n_head_local, d_head):
    """q: [b, Tq, Hl*Dh]; k/v: [b, Tk, Hl*Dh]; bias: [Tq, Tk]."""
    b, tq, _ = q.shape
    tk = k.shape[1]

    def heads(x, t):
        return x.reshape(b, t, n_head_local, d_head).transpose(1, 2)

    qh, kh, vh = heads(q, tq), heads(k, tk), heads(v, tk)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / float(np.sqrt(d_head))
    w = _softmax(scores + bias)
    ctx = torch.einsum("bhqk,bhkd->bhqd", w, vh)
    return ctx.transpose(1, 2).reshape(b, tq, n_head_local * d_head)


def _moe_math(x, gate_logits_local, w0_local, w1_local):
    """x: [b, t, D]; gate_logits_local: [b, t, e_loc] (already softmaxed
    slice); w0_local: [e_loc, D, F_loc]; w1_local: [e_loc, F_loc, D].
    jax.nn.gelu's default is the tanh approximation."""
    h = torch.nn.functional.gelu(torch.einsum("btd,edf->btef", x, w0_local), approximate="tanh")
    y = torch.einsum("btef,efd->bted", h, w1_local)
    return torch.einsum("bted,bte->btd", y, gate_logits_local)


def _causal_bias(rows, cols, device):
    return torch.where(cols[None, :] <= rows[:, None], 0.0, -1e9).to(device=device,
                                                                     dtype=torch.float32)


def reference_loss(params: Dict[str, Any], tokens, labels, cfg: HybridConfig):
    """The single-process forward loss, the sharded engine's math: params
    a dict of tensors, tokens and labels int [batch, seq_len]."""
    D, H = cfg.d_model, cfg.n_head
    d_head = D // H
    T = cfg.seq_len
    dev = params["word_emb"].device
    tokens, labels = torch.as_tensor(tokens).long(), torch.as_tensor(labels).long()
    x = params["word_emb"][tokens] + params["pos_emb"][None, :, :]
    ar = torch.arange(T, device=dev)
    causal = _causal_bias(ar, ar, dev)
    for s in range(cfg.pp):
        for l in range(cfg.layers_per_stage):
            h = _layer_norm(x, params["ln1_scale"][s, l], params["ln1_bias"][s, l])
            q, k, v = h @ params["wq"][s, l], h @ params["wk"][s, l], h @ params["wv"][s, l]
            x = x + _attention_math(q, k, v, causal, H, d_head) @ params["wo"][s, l]
            h = _layer_norm(x, params["ln2_scale"][s, l], params["ln2_bias"][s, l])
            gates = _softmax(h @ params["gate_w"][s, l])
            x = x + _moe_math(h, gates, params["moe_w0"][s, l], params["moe_w1"][s, l])
    logp = torch.log_softmax(x @ params["head"], dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------
def _optimizer_plan(optimizer):
    """Map a fluid optimizer object onto its registered op kernel.

    Returns (op_type, attrs, moment_slots, pow_slots, lr, l2_decay):
    moment_slots are per-param aux tensors shaped like the param (sharded
    with its spec); pow_slots per-param scalars (replicated)."""
    if optimizer is None:
        return ("sgd", {}, [], {}, None, 0.0)
    decay = 0.0
    reg = getattr(optimizer, "regularization", None)
    if reg is not None:
        if type(reg).__name__ != "L2DecayRegularizer":
            raise ValueError(
                "hybrid engine: only L2 decay regularization is supported "
                "(got %s)" % type(reg).__name__
            )
        decay = float(reg._coeff)
    lr = optimizer._learning_rate
    if not isinstance(lr, (int, float)):
        raise ValueError(
            "hybrid engine: optimizer must have a float learning rate "
            "(LR schedules run program-side)"
        )
    # an exact-class whitelist: a subclass or wrapper (DGC, LARS momentum)
    # carries update semantics a match by name would drop
    from paddle_tpu_torch import optimizer as opt_mod

    cls = type(optimizer)
    if cls is opt_mod.AdamOptimizer:
        return (
            "adam",
            {"beta1": optimizer._beta1, "beta2": optimizer._beta2,
             "epsilon": optimizer._epsilon},
            ["Moment1", "Moment2"],
            {"Beta1Pow": optimizer._beta1, "Beta2Pow": optimizer._beta2},
            float(lr), decay,
        )
    if cls is opt_mod.MomentumOptimizer:
        return (
            "momentum",
            {"mu": optimizer._momentum,
             "use_nesterov": optimizer._use_nesterov},
            ["Velocity"], {}, float(lr), decay,
        )
    if cls is opt_mod.SGDOptimizer:
        return ("sgd", {}, [], {}, float(lr), decay)
    raise ValueError(
        "hybrid engine supports exactly SGDOptimizer/MomentumOptimizer/"
        "AdamOptimizer (got %s — subclasses and wrappers carry extra "
        "update semantics); route other optimizers through the Program "
        "path" % cls.__name__
    )


def init_opt_state(cfg: HybridConfig, params, optimizer):
    """Optimizer aux state for ``make_train_step(..., optimizer=)``:
    '<param>@<Slot>' -> zeros_like(param) moments and [1] beta pows."""
    _, _, moment_slots, pow_slots, _, _ = _optimizer_plan(optimizer)
    aux = {}
    for n, p in params.items():
        for slot in moment_slots:
            aux["%s@%s" % (n, slot)] = np.zeros_like(p)
        for slot, v0 in pow_slots.items():
            aux["%s@%s" % (n, slot)] = np.full((1,), v0, np.float32)
    return aux


def _spec_of(cfg: HybridConfig, name: str):
    """A parameter's spec; an aux slot's is its parameter's, a pow's none."""
    from paddle_tpu_torch.sharding.rules import PartitionSpec as P

    specs = _param_specs(cfg)
    if name in specs:
        return specs[name]
    param, slot = name.split("@", 1)
    return P() if slot.endswith("Pow") else specs[param]


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def gather(cfg: HybridConfig, mesh, shards) -> Dict[str, np.ndarray]:
    """Full numpy arrays of a dict of this rank's parameter or aux shards
    (collective: every rank of the mesh calls it)."""
    items = []
    for n, t in shards.items():
        sh = mesh_lib.NamedSharding(mesh, _spec_of(cfg, n))
        items.append((sh, t, [d * mesh_lib._block(sh, i) for i, d in enumerate(t.shape)]))
    return {n: _numpy(full) for n, full in zip(shards, mesh_lib.gather_many(items))}


def make_train_step(cfg: HybridConfig, mesh=None, optimizer=None):
    """The 5D-parallel training step (forward, backward, update) on this
    rank.  Returns ``(step, place, mesh)``.

    ``optimizer=None``: plain SGD at ``cfg.lr``; ``step(params, tokens,
    labels) -> (loss, new_params)``.  ``optimizer=`` a fluid SGD / Momentum
    / Adam optimizer (with optional L2 decay): the update replays its
    registered op kernel on each shard, and ``step(params, aux, tokens,
    labels) -> (loss, new_params, new_aux)`` with ``aux`` from
    :func:`init_opt_state` placed by ``step.place_aux``.  ``place(params,
    tokens, labels)`` cuts full numpy arrays (or tensors) into this rank's
    shards on ``mesh.device``; params and aux go in and out as shards, the
    loss as a 0-d tensor, every rank's the same.  ``step.last_seconds``
    holds the last step's host seconds: ``forward_backward``, ``reduce``
    (the gradient reduction), ``update`` and ``step``."""
    import torch.distributed as dist

    from paddle_tpu_torch.sharding.rules import PartitionSpec as P

    if mesh is None:
        mesh = mesh_lib.make_mesh(cfg.mesh_axes())
    for a, n in cfg.mesh_axes().items():
        if mesh.axis_size(a) != n:
            raise ValueError("hybrid engine: the mesh %r has %s=%d, the config %d"
                             % (mesh.shape, a, mesh.axis_size(a), n))
    device = mesh.device
    specs = _param_specs(cfg)
    opt_op, opt_attrs, moment_slots, pow_slots, opt_lr, l2_decay = _optimizer_plan(optimizer)
    aux_spec_of = {}
    for n in specs:
        for slot in moment_slots:
            aux_spec_of["%s@%s" % (n, slot)] = specs[n]
        for slot in pow_slots:
            aux_spec_of["%s@%s" % (n, slot)] = P()

    D, H, T, V, E, F = cfg.d_model, cfg.n_head, cfg.seq_len, cfg.vocab_size, cfg.n_experts, cfg.d_ff
    assert H % cfg.tp == 0 and D % cfg.tp == 0 and F % cfg.tp == 0
    assert T % cfg.sp == 0 and E % cfg.ep == 0 and cfg.batch % cfg.dp == 0
    h_loc, t_loc, e_loc = H // cfg.tp, T // cfg.sp, E // cfg.ep
    d_head = D // H
    b_loc = cfg.batch // cfg.dp
    M = cfg.microbatches
    assert b_loc % M == 0
    mb = b_loc // M
    S = cfg.pp
    n_steps = M + S - 1
    n_mesh = int(np.prod(list(cfg.mesh_axes().values())))
    stage, sp_idx, ep_idx = (mesh.coords.get(a, 0) for a in ("pp", "sp", "ep"))
    sp_group = mesh.group(("sp",))[0]
    is_first = torch.tensor(stage == 0, device=device)
    is_last = torch.tensor(stage == S - 1, device=device)
    causal = _causal_bias(torch.arange(t_loc) + sp_idx * t_loc, torch.arange(T), device)
    ring = cfg.sp > 1 and cfg.ring_attention

    def replicated_axes(spec):
        used = {a for a in spec if a is not None}
        return tuple(a for a in ALL_AXES if a not in used)

    def stage_fn(stage_params, x):
        """x: [mb, t_loc, D], this rank's window; applies the stage's layers."""
        from paddle_tpu_torch.parallel.ring_attention import ring_attention

        for l in range(cfg.layers_per_stage):
            p = {k: v[l] for k, v in stage_params.items()}
            h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
            q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]  # tp column-parallel
            if ring:
                b = q.shape[0]

                def heads(z):
                    return z.reshape(b, t_loc, h_loc, d_head).transpose(1, 2)

                ctx = ring_attention(heads(q), heads(k), heads(v), sp_group, causal=True)
                att = ctx.transpose(1, 2).reshape(b, t_loc, h_loc * d_head)
            else:
                if cfg.sp > 1:  # the window's queries against the whole sequence's keys
                    k = mesh_lib.all_gather(k, "sp", axis=1, tiled=True)
                    v = mesh_lib.all_gather(v, "sp", axis=1, tiled=True)
                att = _attention_math(q, k, v, causal, h_loc, d_head)
            x = x + mesh_lib.psum(att @ p["wo"], "tp")  # tp row-parallel
            h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
            gates = _softmax(h @ p["gate_w"])  # every expert
            g_loc = gates[..., ep_idx * e_loc:(ep_idx + 1) * e_loc]
            y = _moe_math(h, g_loc, p["moe_w0"], p["moe_w1"])
            x = x + mesh_lib.psum(y, ("ep", "tp"))
        return x

    def local_loss(params, tokens, labels):
        win = slice(sp_idx * t_loc, (sp_idx + 1) * t_loc)
        tok, lab = tokens[:, win], labels[:, win]
        x = params["word_emb"][tok] + params["pos_emb"][win][None]  # [b_loc, t_loc, D]
        stage_params = {k: params[k][0] for k in STAGE_KEYS}  # this rank's stage
        if S == 1:
            final = stage_fn(stage_params, x)
        else:
            xs = x.reshape(M, mb, t_loc, D)
            buf = torch.zeros((mb, t_loc, D), dtype=x.dtype, device=device)
            ring_perm = [(i, (i + 1) % S) for i in range(S)]
            ys = []
            for t in range(n_steps):
                out = stage_fn(stage_params, torch.where(is_first, xs[min(t, M - 1)], buf))
                if t < n_steps - 1:  # the last step's send reaches no one
                    buf = mesh_lib.ppermute(out, "pp", ring_perm)
                ys.append(out)
            # valid on the last stage: its outputs of time steps S - 1 on
            final = torch.where(is_last, torch.cat(ys[S - 1:]), 0.0)
        logits = final @ params["head"]  # [b_loc, t_loc, V / tp]
        if cfg.tp > 1:
            logits = mesh_lib.all_gather(logits, "tp", axis=-1, tiled=True)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, lab[..., None])[..., 0]
        loss_sum = torch.where(is_last, nll.sum(), 0.0)  # only the last stage's is real
        loss = mesh_lib.psum(loss_sum, ("dp", "pp", "sp")) / (cfg.batch * T)
        return mesh_lib.pmean(loss, ("tp", "ep"))  # computed alike on tp and ep ranks

    def reduce_grads(grads):
        """Each gradient summed over its parameter's replicated axes, over
        the mesh's size (every rank seeded its loss with 1): one all_reduce
        a set of replicated axes."""
        out = {}
        by_axes: Dict[tuple, list] = {}
        for n in grads:
            by_axes.setdefault(replicated_axes(specs[n]), []).append(n)
        for rep, names in by_axes.items():
            group = mesh.group(rep)[0]
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            if group is not None:
                dist.all_reduce(flat, group=group)
            flat = flat / n_mesh
            for n, piece in zip(names, flat.split([grads[n].numel() for n in names])):
                out[n] = piece.view(grads[n].shape)
        return out

    def apply_optimizer(params, grads, aux):
        """The registered optimizer kernel on each shard (the kernels the
        Executor's programs run)."""
        from paddle_tpu_torch.core.registry import get_kernel

        kern = get_kernel(opt_op)
        lr_arr = torch.tensor([opt_lr], dtype=torch.float32, device=device)
        slots = moment_slots + list(pow_slots)
        new_p, new_aux = {}, dict(aux)
        for n in params:
            g = grads[n]
            if l2_decay:
                g = g + l2_decay * params[n]
            ins = {"Param": [params[n]], "Grad": [g.to(params[n].dtype)], "LearningRate": [lr_arr]}
            for slot in slots:
                ins[slot] = [aux["%s@%s" % (n, slot)]]
            outs = kern(ins, opt_attrs, device)
            new_p[n] = outs["ParamOut"]
            for slot in slots:
                out = outs.get(slot + "Out")
                if out is not None:
                    key = "%s@%s" % (n, slot)
                    new_aux[key] = out.reshape(aux[key].shape)
        return new_p, new_aux

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def sharded_step(params, aux, tokens, labels):
        t0 = time.perf_counter()
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            loss = local_loss(leaves, tokens, labels)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        sync()
        t1 = time.perf_counter()
        with torch.no_grad():
            grads = reduce_grads(grads)
            sync()
            t2 = time.perf_counter()
            if optimizer is None:
                new_params, new_aux = {n: params[n] - cfg.lr * grads[n] for n in names}, aux
            else:
                new_params, new_aux = apply_optimizer(params, grads, aux)
        sync()
        t3 = time.perf_counter()
        step.last_seconds = {"forward_backward": t1 - t0, "reduce": t2 - t1,
                             "update": t3 - t2, "step": t3 - t0}
        return loss.detach(), new_params, new_aux

    mapped = mesh_lib.shard_map(sharded_step, mesh=mesh, in_specs=(None, None, None, None),
                                out_specs=None)

    def _shard(x, spec, dtype=None):
        x = _numpy(x)
        box = mesh_lib.NamedSharding(mesh, spec).local_box(x.shape)
        part = np.ascontiguousarray(x[tuple(slice(lo, hi) for lo, hi in box)])
        return torch.tensor(part, dtype=dtype, device=device)

    def place_aux(aux):
        return {n: _shard(v, aux_spec_of[n]) for n, v in aux.items()}

    def place(params, tokens, labels):
        params = {n: _shard(v, specs[n]) for n, v in params.items()}
        tokens = _shard(tokens, P("dp"), torch.int64)
        labels = _shard(labels, P("dp"), torch.int64)
        return params, tokens, labels

    if optimizer is None:
        # the legacy signature: step(params, tokens, labels) -> (loss, params)
        def step(params, tokens, labels):
            loss, new_params, _ = mapped(params, {}, tokens, labels)
            return loss, new_params

        step.last_seconds = {}
        return step, place, mesh

    def step(params, aux, tokens, labels):
        return mapped(params, aux, tokens, labels)

    step.last_seconds = {}
    step.place_aux = place_aux
    return step, place, mesh
