"""Metric ops (the slice's subset of the JAX package's ``ops/metric_ops.py``;
reference: paddle/fluid/operators/metrics/accuracy_op.cc)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one


@register_op("accuracy", differentiable=False)
def accuracy(inputs, attrs, device):
    """Top-k accuracy given the ``Indices`` of a ``top_k`` op."""
    idx = one(inputs, "Indices")
    label = one(inputs, "Label")
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    correct = torch.any(idx == label[:, None], dim=1)
    num_correct = correct.to(torch.float32).sum()
    total = float(idx.shape[0])
    return {
        "Accuracy": (num_correct / total).reshape(1),
        "Correct": num_correct.to(torch.int32).reshape(1),
        "Total": torch.full((1,), int(total), dtype=torch.int32, device=idx.device),
    }
