"""Inception-v3 on the layer API (flexflow_tpu/models/inception.py):
the stem and the A, B, C, D and E blocks, each a concat of branch
convolutions along the channels (with the asymmetric 1x7/7x1 and
1x3/3x1 factorizations), no BatchNorm, as the reference's builder has
it.  `channel_scale` shrinks every channel count for tiny test
configurations."""
from __future__ import annotations

from ..fftype import ActiMode

RELU = ActiMode.RELU


def _c(scale: float, n: int) -> int:
    return max(1, int(n * scale))


def inception_a(ff, x, pool_features: int, s: float = 1.0):
    t1 = ff.conv2d(x, _c(s, 64), 1, 1, 1, 1, 0, 0, activation=RELU)
    t2 = ff.conv2d(x, _c(s, 48), 1, 1, 1, 1, 0, 0, activation=RELU)
    t2 = ff.conv2d(t2, _c(s, 64), 5, 5, 1, 1, 2, 2, activation=RELU)
    t3 = ff.conv2d(x, _c(s, 64), 1, 1, 1, 1, 0, 0, activation=RELU)
    t3 = ff.conv2d(t3, _c(s, 96), 3, 3, 1, 1, 1, 1, activation=RELU)
    t3 = ff.conv2d(t3, _c(s, 96), 3, 3, 1, 1, 1, 1, activation=RELU)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    t4 = ff.conv2d(t4, _c(s, pool_features), 1, 1, 1, 1, 0, 0,
                   activation=RELU)
    return ff.concat([t1, t2, t3, t4], axis=1)


def inception_b(ff, x, s: float = 1.0):
    t1 = ff.conv2d(x, _c(s, 384), 3, 3, 2, 2, 0, 0)
    t2 = ff.conv2d(x, _c(s, 64), 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, _c(s, 96), 3, 3, 1, 1, 1, 1)
    t2 = ff.conv2d(t2, _c(s, 96), 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def inception_c(ff, x, channels: int, s: float = 1.0):
    c = _c(s, channels)
    t1 = ff.conv2d(x, _c(s, 192), 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(x, c, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, c, 1, 7, 1, 1, 0, 3)
    t2 = ff.conv2d(t2, _c(s, 192), 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(x, c, 1, 1, 1, 1, 0, 0)
    t3 = ff.conv2d(t3, c, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(t3, c, 1, 7, 1, 1, 0, 3)
    t3 = ff.conv2d(t3, c, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(t3, _c(s, 192), 1, 7, 1, 1, 0, 3)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    t4 = ff.conv2d(t4, _c(s, 192), 1, 1, 1, 1, 0, 0)
    return ff.concat([t1, t2, t3, t4], axis=1)


def inception_d(ff, x, s: float = 1.0):
    t1 = ff.conv2d(x, _c(s, 192), 1, 1, 1, 1, 0, 0)
    t1 = ff.conv2d(t1, _c(s, 320), 3, 3, 2, 2, 0, 0)
    t2 = ff.conv2d(x, _c(s, 192), 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, _c(s, 192), 1, 7, 1, 1, 0, 3)
    t2 = ff.conv2d(t2, _c(s, 192), 7, 1, 1, 1, 3, 0)
    t2 = ff.conv2d(t2, _c(s, 192), 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def inception_e(ff, x, s: float = 1.0):
    t1 = ff.conv2d(x, _c(s, 320), 1, 1, 1, 1, 0, 0)
    t2i = ff.conv2d(x, _c(s, 384), 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2i, _c(s, 384), 1, 3, 1, 1, 0, 1)
    t3 = ff.conv2d(t2i, _c(s, 384), 3, 1, 1, 1, 1, 0)
    t3i = ff.conv2d(x, _c(s, 448), 1, 1, 1, 1, 0, 0)
    t3i = ff.conv2d(t3i, _c(s, 384), 3, 3, 1, 1, 1, 1)
    t4 = ff.conv2d(t3i, _c(s, 384), 1, 3, 1, 1, 0, 1)
    t5 = ff.conv2d(t3i, _c(s, 384), 3, 1, 1, 1, 1, 0)
    t6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type="avg")
    t6 = ff.conv2d(t6, _c(s, 192), 1, 1, 1, 1, 0, 0)
    return ff.concat([t1, t2, t3, t4, t5, t6], axis=1)


def build_inception_v3(ff, batch_size: int = 64, num_classes: int = 10,
                       image_size: int = 299, channel_scale: float = 1.0):
    """The stem, 3 A, B, 4 C, D, 2 E, the global average pool and the
    classifier, ending in softmax."""
    s = channel_scale
    t = ff.create_tensor([batch_size, 3, image_size, image_size],
                         name="input")
    t = ff.conv2d(t, _c(s, 32), 3, 3, 2, 2, 0, 0, activation=RELU,
                  name="stem1")
    t = ff.conv2d(t, _c(s, 32), 3, 3, 1, 1, 0, 0, activation=RELU,
                  name="stem2")
    t = ff.conv2d(t, _c(s, 64), 3, 3, 1, 1, 1, 1, activation=RELU,
                  name="stem3")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.conv2d(t, _c(s, 80), 1, 1, 1, 1, 0, 0, activation=RELU,
                  name="stem4")
    t = ff.conv2d(t, _c(s, 192), 3, 3, 1, 1, 1, 1, activation=RELU,
                  name="stem5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = inception_a(ff, t, 32, s)
    t = inception_a(ff, t, 64, s)
    t = inception_a(ff, t, 64, s)
    t = inception_b(ff, t, s)
    t = inception_c(ff, t, 128, s)
    t = inception_c(ff, t, 160, s)
    t = inception_c(ff, t, 160, s)
    t = inception_c(ff, t, 192, s)
    t = inception_d(ff, t, s)
    t = inception_e(ff, t, s)
    t = inception_e(ff, t, s)
    h, w = t.shape.logical_shape[2:]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, pool_type="avg", name="head_pool")
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return ff.softmax(t, name="softmax")
