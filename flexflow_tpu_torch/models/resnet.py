"""ResNet-50 and ResNeXt-50 on the layer API
(flexflow_tpu/models/resnet.py): bottleneck blocks without BatchNorm,
as the reference's builders have them; ResNeXt's 3x3 convolutions are
grouped.  The builders take the image size and stage depths, so the
tests build tiny ones."""
from __future__ import annotations

from typing import Sequence

from ..fftype import ActiMode


def _channels(t) -> int:
    return t.shape.logical_shape[1]  # NCHW


def bottleneck_block(ff, input, out_channels: int, stride: int):
    """1x1 -> 3x3 (stride) -> 1x1 (4x), with a projection shortcut where
    the shape changes."""
    t = ff.conv2d(input, out_channels, 1, 1, 1, 1, 0, 0)
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1)
    t = ff.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0)
    if stride > 1 or _channels(input) != 4 * out_channels:
        input = ff.conv2d(input, 4 * out_channels, 1, 1, stride, stride,
                          0, 0)
    t = ff.add(input, t)
    return ff.relu(t, inplace=False)


def build_resnet50(ff, batch_size: int = 64, num_classes: int = 10,
                   image_size: int = 229,
                   stage_blocks: Sequence[int] = (3, 4, 6, 3),
                   base_channels: int = 64):
    t = ff.create_tensor([batch_size, 3, image_size, image_size],
                         name="input")
    t = ff.conv2d(t, base_channels, 7, 7, 2, 2, 3, 3, name="stem_conv")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    ch = base_channels
    for stage, blocks in enumerate(stage_blocks):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = bottleneck_block(ff, t, ch, stride)
        ch *= 2
    h, w = t.shape.logical_shape[2:]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, pool_type="avg", name="head_pool")
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return ff.softmax(t, name="softmax")


def resnext_block(ff, input, stride: int, out_channels: int, groups: int,
                  has_residual: bool = False):
    """1x1 (ReLU) -> grouped 3x3 (stride, ReLU) -> 1x1 (2x); the
    residual only when asked for and the shape changes, as the
    reference has it."""
    t = ff.conv2d(input, out_channels, 1, 1, 1, 1, 0, 0,
                  activation=ActiMode.RELU)
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1,
                  activation=ActiMode.RELU, groups=groups)
    t = ff.conv2d(t, 2 * out_channels, 1, 1, 1, 1, 0, 0)
    if (stride > 1 or _channels(input) != 2 * out_channels) and has_residual:
        input = ff.conv2d(input, 2 * out_channels, 1, 1, stride, stride,
                          0, 0, activation=ActiMode.RELU)
        t = ff.relu(ff.add(input, t), inplace=False)
    return t


def build_resnext50(ff, batch_size: int = 16, num_classes: int = 1000,
                    image_size: int = 224,
                    stage_blocks: Sequence[int] = (3, 4, 6, 3),
                    groups: int = 32, base_channels: int = 128):
    """ResNeXt-50 (32x4d)."""
    t = ff.create_tensor([batch_size, 3, image_size, image_size],
                         name="input")
    t = ff.conv2d(t, 64, 7, 7, 2, 2, 3, 3, activation=ActiMode.RELU,
                  name="stem_conv")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="stem_pool")
    ch = base_channels
    for stage, blocks in enumerate(stage_blocks):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            t = resnext_block(ff, t, stride, ch, groups)
        ch *= 2
    t = ff.relu(t, inplace=False)
    h, w = t.shape.logical_shape[2:]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, pool_type="avg", name="head_pool")
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return ff.softmax(t, name="softmax")
