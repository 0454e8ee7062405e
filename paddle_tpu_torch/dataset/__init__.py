"""Dataset zoo with the reference's reader API.

Reference: python/paddle/dataset/ (mnist, cifar, uci_housing, imdb, ...)
— each module exposes ``train()``/``test()`` returning sample-tuple
generators consumed by ``paddle_tpu_torch.reader`` decorators.

This environment has no network egress, so the zoo generates
*deterministic synthetic* data with the exact shapes/dtypes/ranges of the
real datasets (documented per module).  Swap in real data by pointing
``PADDLE_TPU_DATA_HOME`` at pre-downloaded copies; modules check it first.
"""
from paddle_tpu_torch.dataset import (  # noqa: F401
    cifar, flowers, imdb, mnist, movielens, uci_housing, voc2012, wmt14, wmt16,
)
