"""AlexNet, the CIFAR-10 variant (flexflow_tpu/models/alexnet.py): five
ReLU convolutions with three max pools, two 4096-wide ReLU denses and
the classifier, ending in softmax."""
from __future__ import annotations

from ..fftype import ActiMode


def build_alexnet(ff, batch_size: int = 64, num_classes: int = 10,
                  image_size: int = 32):
    t = ff.create_tensor([batch_size, 3, image_size, image_size],
                         name="input")
    t = ff.conv2d(t, 64, 11, 11, 4, 4, 2, 2, activation=ActiMode.RELU,
                  name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation=ActiMode.RELU,
                  name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation=ActiMode.RELU,
                  name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=ActiMode.RELU,
                  name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=ActiMode.RELU,
                  name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool5")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 4096, activation=ActiMode.RELU, name="fc6")
    t = ff.dense(t, 4096, activation=ActiMode.RELU, name="fc7")
    t = ff.dense(t, num_classes, name="fc8")
    return ff.softmax(t, name="softmax")
