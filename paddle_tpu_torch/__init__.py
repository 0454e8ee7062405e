"""paddle_tpu_torch: the PyTorch/CUDA port of the repo's Fluid-style
framework, for one NVIDIA Hopper card.

The user-facing API mirrors ``paddle.fluid`` and the JAX package's
module layout, so each module's counterpart is found by name:

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    ids = fluid.layers.data("src_ids", [128], dtype="int64")
    mask = fluid.layers.data("input_mask", [128])
    out = transformer.bert_encoder(ids, mask, dropout_rate=0.0,
                                   is_test=True, fused_attention=True)
    exe = fluid.Executor()          # cuda:0; Executor(CPUPlace()) for the CPU

What is ported so far is the serving path of a fused, inference-mode
BERT encoder (Program building, startup, ``io.save_inference_model``,
``inference.AnalysisPredictor``, with bf16 precision variants, and
``serving.InferenceServer`` over one or more replicas) and the training path of fused BERT
pretraining (``models.transformer.bert_pretrain``, ``backward``,
``optimizer.SGDOptimizer`` / ``AdamOptimizer``, optionally under
``contrib.mixed_precision.decorate`` for bf16 AMP), and the training of
LeNet-5 and ResNet-50 (``models.lenet5``, ``models.resnet50``; conv2d,
pool2d and batch_norm, ``MomentumOptimizer``, and checkpoints through
``io.save_persistables`` / ``load_persistables``).  ``Executor.run``
keeps a run plan and an entry per feed signature and, on a card,
captures each entry as a CUDA graph at its second run on one thread.
Its one TPU op, fused attention, runs on hand-written CUDA kernels,
forward and backward, in fp32 and bf16 (``csrc/fused_attention.cu`` and
``csrc/fused_attention_bwd.cu``, wrappers in
``kernels/fused_attention.py``), built with nvcc at first use into
``_build/``.

The training surface around them: every optimizer of the JAX package
(Lamb, Lars, Adagrad, DecayedAdagrad, Adamax, Adadelta, RMSProp, Ftrl,
DGCMomentum, ModelAverage, ExponentialMovingAverage, PipelineOptimizer
without stages), ``gradients``, the initializers, ``io.save_program``,
``FLAGS_check_nan_inf`` (``get_flags``/``set_flags``), and the input
pipeline: the ``reader`` decorators, ``PyReader`` (staged on the card by
a double buffer on a side stream) and ``DataFeeder``.

CTR training (DeepFM, ``models.deepfm_ctr``) from MultiSlot files:
``DatasetFactory`` / ``InMemoryDataset`` / ``QueueDataset`` (parsed by
``native/``), ``Executor.train_from_dataset`` with ``thread=N`` prefetch
onto the card, ``trainer_desc`` / ``TrainerFactory``, ``metrics.Auc``,
and the parameter server (``distributed``: ``ParameterServer``,
``PSClient``, ``bind_distributed_tables``, the async ``Communicator``,
``GeoSGD``) behind ``embedding(is_distributed=True)``.

Multi-process training: ``transpiler.DistributeTranspiler`` (dense
parameters on parameter-server processes, or "nccl2" mode),
``parallel.GradAllReduce`` / ``LocalSGD`` with the collective ops over
``torch.distributed`` (``parallel.env``), ``distributed.launch``,
``AsyncExecutor``, and ``InferenceTranspiler``'s conv + batch_norm fold.
Across a mesh of ranks (one rank a mesh device, ``parallel.make_mesh``):
``CompiledProgram`` (``with_data_parallel``, ``with_strategy``,
``with_sharding_rules``) and the partition rules (``sharding``) for data-,
FSDP- and tensor-parallel training and sharded serving, shard-wise
checkpoints and ``batch_norm``'s ``sync_bn``.

Seq2seq: Programs with sub-blocks and the control-flow layers
(``While``, ``cond``, ``StaticRNN``, ``DynamicRNN``, ``IfElse``,
``Switch``, the tensor arrays), the recurrent layers (``dynamic_lstm``,
``dynamic_gru``, ``dynamic_lstmp``), the sequence and beam layers,
Transformer NMT (``models.seq2seq.transformer_nmt``) and ``decoding``
(greedy and beam search, full prefix and KV-cached).

The core layers: the math, tensor and plain nn ops with
``layers/tensor.py``, ``layers/nn.py``'s plain names and ``layers/io.py``
(the reader layers over ``reader.py``, ``layers.load``), and
``models.vgg16`` and ``models.word2vec_ngram``.
"""
from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import (
    CPUPlace,
    CUDAPlace,
    Place,
    Program,
    cpu_places,
    cuda_pinned_places,
    cuda_places,
    default_main_program,
    default_startup_program,
    is_compiled_with_cuda,
    name_scope,
    program_guard,
)
from paddle_tpu_torch.executor import AsyncExecutor, Executor
from paddle_tpu_torch.scope import Scope, global_scope, scope_guard

from paddle_tpu_torch import initializer, layers, unique_name
from paddle_tpu_torch import backward, clip, optimizer, regularizer
from paddle_tpu_torch.backward import append_backward, gradients
from paddle_tpu_torch import flags
from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch import monitor, reader
from paddle_tpu_torch import profiler, memory, debugger, faults
from paddle_tpu_torch.reader import DataLoader, PyReader, batch
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.param_attr import ParamAttr, WeightNormParamAttr
from paddle_tpu_torch import inference
from paddle_tpu_torch import io
from paddle_tpu_torch.io import (
    load_inference_model,
    load_params,
    load_persistables,
    load_vars,
    save_inference_model,
    save_params,
    save_persistables,
    save_program,
    save_vars,
)
from paddle_tpu_torch.optimizer import ExponentialMovingAverage
from paddle_tpu_torch.layers import learning_rate_scheduler as learning_rate_decay
from paddle_tpu_torch import kernels
from paddle_tpu_torch import models
from paddle_tpu_torch import nets
from paddle_tpu_torch import serving
from paddle_tpu_torch import contrib
from paddle_tpu_torch import dataset, decoding, distributed, incubate, metrics, native, recordio_writer
from paddle_tpu_torch import fluid_dataset, trainer_desc
from paddle_tpu_torch import parallel
from paddle_tpu_torch import sharding
from paddle_tpu_torch.parallel.compiled_program import CompiledProgram, ParallelExecutor
from paddle_tpu_torch.parallel.strategy import (
    BuildStrategy,
    DistributedStrategy,
    ExecutionStrategy,
)
from paddle_tpu_torch import transpiler
from paddle_tpu_torch.transpiler import (
    DistributeTranspiler,
    DistributeTranspilerConfig,
    InferenceTranspiler,
    memory_optimize,
    release_memory,
)
from paddle_tpu_torch.fluid_dataset import DatasetFactory, InMemoryDataset, QueueDataset
from paddle_tpu_torch.trainer_desc import TrainerFactory

# the LoDTensor surface: a scope var's tensor view carries the reference
# binding's set / shape (a ragged sequence is padded, with its lengths)
from paddle_tpu_torch.scope import _TensorView as Tensor

LoDTensor = Tensor
LoDTensorArray = list


def CUDAPinnedPlace():
    """Pinned host staging memory: a host place."""
    return CPUPlace()
