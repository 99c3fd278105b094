"""MNIST models (BASELINE.json config 1: "MNIST softmax via tf.Session").

(ref: the reference's models.BUILD mnist tutorials / tensorflow examples.)
Both the classic softmax regression and a small convnet, built with the
stf graph API exactly as a reference user would write them.
"""

from __future__ import annotations

import numpy as np

import simple_tensorflow_tpu_torch as stf


def softmax_model(batch_size=None, image_size=784, num_classes=10,
                  learning_rate=0.5):
    """y = softmax(xW + b): the canonical tf.Session tutorial model."""
    x = stf.placeholder(stf.float32, [batch_size, image_size], name="x")
    y_ = stf.placeholder(stf.float32, [batch_size, num_classes], name="y_")
    W = stf.Variable(stf.zeros([image_size, num_classes]), name="W")
    b = stf.Variable(stf.zeros([num_classes]), name="b")
    logits = stf.matmul(x, W) + b
    cross_entropy = stf.reduce_mean(
        stf.nn.softmax_cross_entropy_with_logits(labels=y_, logits=logits))
    train_op = stf.train.GradientDescentOptimizer(learning_rate).minimize(
        cross_entropy)
    correct = stf.equal(stf.argmax(logits, 1, output_type=stf.int32),
                        stf.argmax(y_, 1, output_type=stf.int32))
    accuracy = stf.reduce_mean(stf.cast(correct, stf.float32))
    return {"x": x, "y_": y_, "logits": logits, "loss": cross_entropy,
            "train_op": train_op, "accuracy": accuracy}


def convnet_model(batch_size=None, num_classes=10, learning_rate=1e-3,
                  dtype=stf.float32):
    """LeNet-style convnet (conv-pool-conv-pool-fc-dropout-fc)."""
    x = stf.placeholder(dtype, [batch_size, 28, 28, 1], name="x")
    y_ = stf.placeholder(stf.int32, [batch_size], name="y_")
    keep_prob = stf.placeholder_with_default(stf.constant(1.0), [],
                                             name="keep_prob")
    with stf.variable_scope("convnet"):
        h = stf.layers.conv2d(x, 32, 5, padding="same",
                              activation=stf.nn.relu, name="conv1")
        h = stf.layers.max_pooling2d(h, 2, 2, name="pool1")
        h = stf.layers.conv2d(h, 64, 5, padding="same",
                              activation=stf.nn.relu, name="conv2")
        h = stf.layers.max_pooling2d(h, 2, 2, name="pool2")
        h = stf.layers.flatten(h)
        h = stf.layers.dense(h, 1024, activation=stf.nn.relu, name="fc1")
        h = stf.nn.dropout(h, keep_prob=keep_prob)
        logits = stf.layers.dense(h, num_classes, name="fc2")
    loss = stf.reduce_mean(stf.nn.sparse_softmax_cross_entropy_with_logits(
        labels=y_, logits=logits))
    gs = stf.train.get_or_create_global_step()
    train_op = stf.train.AdamOptimizer(learning_rate).minimize(
        loss, global_step=gs)
    correct = stf.equal(stf.cast(stf.argmax(logits, 1, output_type=stf.int32),
                                 stf.int32), y_)
    accuracy = stf.reduce_mean(stf.cast(correct, stf.float32))
    return {"x": x, "y_": y_, "keep_prob": keep_prob, "logits": logits,
            "loss": loss, "train_op": train_op, "accuracy": accuracy,
            "global_step": gs}


def synthetic_mnist(n=512, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(n, 784).astype(np.float32)
    labels = rng.randint(0, 10, size=n)
    onehot = np.zeros((n, 10), np.float32)
    onehot[np.arange(n), labels] = 1.0
    return images, labels, onehot
