"""Transpiler namespace (reference: python/paddle/fluid/transpiler/).

The port's own copy of the JAX package's ``transpiler.py``:

* ``DistributeTranspiler`` — the reference's PS program rewriter
  (distribute_transpiler.py:181).  In "pserver" mode the trainer program
  loses its optimizer updates and carries ``_dense_ps_ctx``: the executor
  pushes each step's gradients to the parameter servers and pulls the
  parameters back (``executor.py``, the dense-PS round); the pserver
  program carries ``_pserver_ctx``, and running it serves the parameters
  with their optimizer state on the host (``distributed/ps.py``
  ``_DenseParam``).  In "nccl2" mode it hands off to ``GradAllReduce``.
* ``InferenceTranspiler`` — folds an ``is_test`` batch_norm into the conv2d
  before it.
* ``memory_optimize`` / ``release_memory`` — no-ops, as in the JAX
  package: the caching allocator reuses freed blocks and a captured step
  has its own memory pool (the reference's liveness pass,
  memory_optimization_transpiler.py).
"""
from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import framework
from paddle_tpu_torch.parallel.collective_transpiler import Collective, GradAllReduce, LocalSGD  # noqa: F401

__all__ = [
    "DistributeTranspiler",
    "DistributeTranspilerConfig",
    "GradAllReduce",
    "InferenceTranspiler",
    "LocalSGD",
    "memory_optimize",
    "release_memory",
    "HashName",
    "RoundRobin",
]


class DistributeTranspilerConfig:
    """reference: distribute_transpiler.py:131."""

    slice_var_up = True
    split_method = None
    min_block_size = 8192
    mode = "pserver"  # or "nccl2" (collective)
    print_log = False
    wait_port = True


class DistributeTranspiler:
    """reference: distribute_transpiler.py:181."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self._collective: Optional[Collective] = None

    def transpile(
        self,
        trainer_id: int,
        program=None,
        pservers: str = "127.0.0.1:6174",
        trainers: int = 1,
        sync_mode: bool = True,
        startup_program=None,
        current_endpoint: str = "127.0.0.1:6174",
    ):
        program = program or framework.default_main_program()
        startup_program = startup_program or framework.default_startup_program()
        if self.config.mode == "nccl2":
            endpoints = [str(i) for i in range(trainers)]
            self._collective = GradAllReduce()
            self._collective.transpile(
                startup_program, program, trainer_id, endpoints, str(trainer_id),
            )
            return
        # pserver mode: the trainer program loses its optimizer-update ops
        # (the executor pushes grads and pulls params around each step),
        # and the pserver program serves the params with server-side
        # optimizer state (distributed/ps.py _DenseParam;
        # listen_and_serv_op.cc:109)
        self.trainer_id = trainer_id
        self.pserver_endpoints = [e for e in pservers.split(",") if e]
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.origin_program = program
        self._analyze_optimize_ops()

    # update-op types the dense PS can run server-side; everything the
    # reference's listen_and_serv optimize blocks support on this build
    _SERVER_OPTS = ("sgd", "momentum", "adagrad", "adam")

    def _analyze_optimize_ops(self):
        """Find (Param, Grad, LearningRate, optimizer) per parameter."""
        self._param_updates = {}
        block = self.origin_program.global_block()
        for op in block.ops:
            if "Param" in op.inputs and "Grad" in op.inputs and "ParamOut" in op.outputs:
                if op.type not in self._SERVER_OPTS:
                    raise NotImplementedError(
                        "dense PS mode supports server-side %s; program uses "
                        "%r — use collective (nccl2) mode or GeoSGD instead"
                        % (list(self._SERVER_OPTS), op.type)
                    )
                self._param_updates[op.inputs["Param"][0]] = {
                    "grad": op.inputs["Grad"][0],
                    "lr_var": op.inputs["LearningRate"][0],
                    "optimizer": op.type,
                    "attrs": {k: v for k, v in op.attrs.items()
                              if not k.startswith("__")},
                }
        if not self._param_updates:
            raise ValueError(
                "transpile(mode='pserver') found no optimizer update ops — "
                "call minimize() before transpile (reference: "
                "distribute_transpiler.py:272 _has_distributed_lookup_table)"
            )

    def get_trainer_program(self, wait_port: bool = True):
        """Trainer program: optimizer updates stripped; the executor
        pushes grads / pulls params around each step (the send/recv+
        barrier ops of distribute_transpiler.py:320 as host-side calls)."""
        prog = self.origin_program.clone()
        update_params = set(self._param_updates)
        for blk in prog.blocks:
            blk.ops = [
                op for op in blk.ops
                if not (op.type in self._SERVER_OPTS
                        and op.inputs.get("Param", [None])[0] in update_params)
            ]
        prog._dense_ps_ctx = {
            "endpoints": list(self.pserver_endpoints),
            "trainer_id": int(self.trainer_id),
            "n_trainers": int(self.trainer_num),
            "sync": bool(self.sync_mode),
            "params": dict(self._param_updates),
            "step": 0,
            "initialized": False,
        }
        return prog

    def get_pserver_program(self, endpoint: str):
        """Pserver program: running it (Executor.run) starts the dense
        server loop for the params hashed to ``endpoint`` and BLOCKS
        serving, like the reference's listen_and_serv op."""
        if endpoint not in self.pserver_endpoints:
            raise ValueError("%r not in pserver list %s" % (endpoint, self.pserver_endpoints))
        prog = framework.Program()
        block = self.origin_program.global_block()
        prog._pserver_ctx = {
            "endpoint": endpoint,
            "endpoints": list(self.pserver_endpoints),
            "n_trainers": int(self.trainer_num),
            "sync": bool(self.sync_mode),
            "params": {
                name: {
                    "shape": [int(s) for s in block.var(name).shape],
                    "optimizer": desc["optimizer"],
                    "attrs": desc["attrs"],
                }
                for name, desc in self._param_updates.items()
            },
        }
        return prog

    def get_pserver_programs(self, endpoint: str):
        prog = self.get_pserver_program(endpoint)
        return prog, self.get_startup_program(endpoint, prog)

    def get_startup_program(self, endpoint: str, pserver_program=None):
        # dense params are seeded by trainer 0's initial values (the
        # executor's first dense-PS run), so the pserver startup is empty
        return framework.Program()


class InferenceTranspiler:
    """reference: transpiler/inference_transpiler.py:25 — fold batch
    normalization into the preceding convolution for inference.

    For every NCHW ``conv2d`` whose output feeds exactly one ``is_test``
    ``batch_norm`` (directly, or through one channel-bias
    ``elementwise_add``), the BN affine transform is folded into the conv
    filter (per-output-channel scale) and a bias (new, or merged into the
    existing channel bias), and the batch_norm op is removed.  The scope's
    tensors are rewritten in place, on the device where they lie, so
    clone the program (``for_test=True``) first, and keep a copy of the
    weights if the unfolded program must run again.  Returns the number of
    folds."""

    def transpile(self, program, place=None, scope=None) -> int:
        import torch

        from paddle_tpu_torch import unique_name
        from paddle_tpu_torch.scope import global_scope

        scope = scope or global_scope()
        block = program.global_block()
        # reader counts over EVERY block (a While/cond sub-block reading
        # the conv output still needs the raw pre-BN values); only
        # single-consumer chains are fused
        readers: dict = {}
        for blk in program.blocks:
            for op in blk.ops:
                for n in op.input_arg_names:
                    readers[n] = readers.get(n, 0) + 1

        def fold_pair(conv_op, bias_op, bn_op, bn_idx):
            """Fold bn (and the optional existing channel-bias add) into
            the conv filter."""
            w_name = conv_op.inputs["Filter"][0]
            scale_n, bias_n, mean_n, var_n = (
                bn_op.inputs["Scale"][0], bn_op.inputs["Bias"][0],
                bn_op.inputs["Mean"][0], bn_op.inputs["Variance"][0],
            )
            names = [w_name, scale_n, bias_n, mean_n, var_n]
            if bias_op is not None:
                names.append(bias_op.inputs["Y"][0])
            vals = {n: scope.get(n) for n in names}
            missing = [n for n, v in vals.items() if v is None]
            if missing:
                raise RuntimeError(
                    "InferenceTranspiler: vars %s not initialized in "
                    "scope — run startup / load params first" % missing
                )
            w = vals[w_name]                         # OIHW
            eps = float(bn_op.attrs.get("epsilon", 1e-5))
            with torch.no_grad():
                alpha = vals[scale_n] / torch.sqrt(vals[var_n] + eps)  # [C_out]
                if bias_op is not None:
                    # BN(conv + b) = alpha*conv + (alpha*(b - mean) + bnbias):
                    # merge into the EXISTING channel bias
                    b = vals[bias_op.inputs["Y"][0]]
                    beta = alpha * (b.reshape(-1) - vals[mean_n]) + vals[bias_n]
                    w.mul_(alpha.to(w.dtype)[:, None, None, None])
                    b.copy_(beta.reshape(b.shape))
                    # the add now directly produces the BN output name
                    bias_op.outputs["Out"] = [bn_op.outputs["Y"][0]]
                    block._remove_op(bn_idx)
                    return
                beta = vals[bias_n] - vals[mean_n] * alpha
                w.mul_(alpha.to(w.dtype)[:, None, None, None])
            bn_y = bn_op.outputs["Y"][0]
            fused_bias = unique_name.generate(w_name + ".bn_fold_bias")
            block.create_var(
                name=fused_bias, shape=[int(alpha.shape[0])],
                dtype="float32", persistable=True, stop_gradient=True,
            )
            scope.vars[fused_bias] = beta.float()
            block._remove_op(bn_idx)
            block._insert_op(
                bn_idx,
                type="elementwise_add",
                inputs={"X": [conv_op.outputs["Output"][0]],
                        "Y": [fused_bias]},
                outputs={"Out": [bn_y]},
                attrs={"axis": 1},
            )

        def is_channel_bias_add(op, src_name):
            return (
                op.type == "elementwise_add"
                and op.inputs.get("X", [None])[0] == src_name
                and op.attrs.get("axis") == 1
                and len(op.inputs.get("Y", [])) == 1
            )

        i = 0
        fused = 0
        while i < len(block.ops) - 1:
            op = block.ops[i]
            if not (op.type == "conv2d"
                    and op.attrs.get("data_format", "NCHW") == "NCHW"):
                i += 1
                continue
            conv_out = op.outputs["Output"][0]
            nxt = block.ops[i + 1]
            bias_op = None
            bn_idx = i + 1
            if (is_channel_bias_add(nxt, conv_out)
                    and readers.get(conv_out, 0) == 1
                    and i + 2 < len(block.ops)):
                bias_op = nxt
                bn_idx = i + 2
            bn_op = block.ops[bn_idx] if bn_idx < len(block.ops) else None
            chain_in = (bias_op.outputs["Out"][0] if bias_op is not None
                        else conv_out)
            if not (
                bn_op is not None
                and bn_op.type == "batch_norm"
                and bn_op.attrs.get("is_test")
                and bn_op.inputs.get("X", [None])[0] == chain_in
                and readers.get(chain_in, 0) == 1
            ):
                i += 1
                continue
            fold_pair(op, bias_op, bn_op, bn_idx)
            fused += 1
            i = bn_idx  # continue after the (now replaced) bn position
        program.version += 1
        return fused


def memory_optimize(input_program=None, skip_opt_set=None, print_log=False, level=0, skip_grads=False):
    """No-op: the caching allocator reuses freed blocks, and a captured
    step owns its memory pool (the reference's
    memory_optimization_transpiler.py liveness pass)."""


def release_memory(input_program=None, skip_opt_set=None):
    """No-op (see memory_optimize)."""


class HashName:
    def __init__(self, pserver_endpoints):
        self.endpoints = pserver_endpoints

    def dispatch(self, varlist):
        return [self.endpoints[hash(v.name) % len(self.endpoints)] for v in varlist]


class RoundRobin:
    def __init__(self, pserver_endpoints):
        self.endpoints = pserver_endpoints
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for v in varlist:
            out.append(self.endpoints[self._i % len(self.endpoints)])
            self._i += 1
        return out
