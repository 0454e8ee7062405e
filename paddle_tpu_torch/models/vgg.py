"""VGG-16 — the reference's float16 benchmark model
(paddle/contrib/float16/float16_benchmark.md:21-33; book test
test_image_classification.py vgg16_bn_drop).
"""
from __future__ import annotations

from paddle_tpu_torch import layers

__all__ = ["vgg16"]


def _conv_block(x, num_filter, groups, is_test=False):
    for _ in range(groups):
        x = layers.conv2d(x, num_filters=num_filter, filter_size=3, padding=1, act=None, bias_attr=False)
        x = layers.batch_norm(x, act="relu", is_test=is_test)
    return layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")


def vgg16(images, labels, class_num: int = 1000, is_test: bool = False, dropout: bool = True):
    """Returns (avg_loss, accuracy, prediction). images: [N,3,H,W]."""
    x = _conv_block(images, 64, 2, is_test)
    x = _conv_block(x, 128, 2, is_test)
    x = _conv_block(x, 256, 3, is_test)
    x = _conv_block(x, 512, 3, is_test)
    x = _conv_block(x, 512, 3, is_test)

    if dropout:
        x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(x, size=4096, act=None)
    x = layers.batch_norm(fc1, act="relu", is_test=is_test)
    if dropout:
        x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(x, size=4096, act="relu")
    prediction = layers.fc(fc2, size=class_num, act="softmax")
    loss = layers.cross_entropy(prediction, labels)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(prediction, labels)
    return avg_loss, acc, prediction
