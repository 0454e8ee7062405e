"""paddle_tpu_torch.sharding — declarative partition rules for
model-parallel serving and training.

The port's counterpart of the JAX package's ``sharding/`` (regex rules
over parameter names → ``PartitionSpec``s), which lets one predictor or
trainer span a tensor- or FSDP-sharded mesh of ranks instead of
replicating every parameter on each:

* :mod:`paddle_tpu_torch.sharding.rules` — :class:`PartitionSpec`,
  :class:`PartitionRules` (ordered first-match rule sets, typed errors,
  JSON manifest round-trip),
* :mod:`paddle_tpu_torch.sharding.layouts` — canonical ``tp`` /
  ``fsdp`` / ``fsdp_tp`` layouts for the in-tree model families
  (transformer LM, NMT seq2seq, DeepFM), coverage-checked against the
  real models by ``tools/check_partition_rules.py``,
* :mod:`paddle_tpu_torch.sharding.train` — the same rules pointed at a
  TRAIN program: :class:`TrainPartitionRules` derives every optimizer
  accumulator's spec from its param's matched rule, so params and
  optimizer state live sharded,
* :mod:`paddle_tpu_torch.sharding.activations` — the activation rules
  applied to a compiled program's step: each rank keeps its window of the
  sequence axis (sequence-parallel serving under the ``sp`` layout),
* :mod:`paddle_tpu_torch.sharding.metrics` — placement observability.

The mesh-resident sparse tables (the JAX package's ``sharding/sparse.py``)
are ROADMAP A10 part 4.

Entry points: ``CompiledProgram.with_sharding_rules(rules, ...)``
(``paddle_tpu_torch/parallel/compiled_program.py``),
``save_inference_model(..., sharding_rules=..., sharding_mesh=...)``
(``paddle_tpu_torch/io.py``), and ``AnalysisPredictor``, which
reconstructs the saved layout on load (``paddle_tpu_torch/inference.py``).
"""
from paddle_tpu_torch.sharding.layouts import (
    AXIS_FSDP,
    AXIS_TP,
    FAMILIES,
    MODES,
    canonical_rules,
    deepfm_rules,
    transformer_lm_rules,
    transformer_nmt_rules,
)
from paddle_tpu_torch.sharding.rules import (
    MeshCommittedStateError,
    PartitionRules,
    PartitionSpec,
    ShardingRuleError,
)
from paddle_tpu_torch.sharding.train import (
    TrainPartitionRules,
    sharded_train_program,
    train_rules,
)

__all__ = [
    "PartitionSpec",
    "PartitionRules",
    "ShardingRuleError",
    "MeshCommittedStateError",
    "TrainPartitionRules",
    "train_rules",
    "sharded_train_program",
    "canonical_rules",
    "transformer_lm_rules",
    "transformer_nmt_rules",
    "deepfm_rules",
    "AXIS_TP",
    "AXIS_FSDP",
    "MODES",
    "FAMILIES",
]
