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


# -- the end-to-end journey (examples/train_mnist_end_to_end.py) ------------

def write_records(path, n=512, seed=0, shards=4):
    """``examples/train_mnist_end_to_end.py``'s ``write_dataset``: ``n``
    synthetic 28x28 digits (labels from a random linear map, so a model
    can learn them) as ``tf.Example`` TFRecords split over ``shards``
    files, record i in shard i % shards. Returns ``(images, labels,
    files)``."""
    from ..lib.example import make_example
    from ..lib.io.tf_record import TFRecordWriter

    rng = np.random.RandomState(seed)
    images = rng.rand(n, 28 * 28).astype(np.float32)
    w_true = rng.randn(28 * 28, 10).astype(np.float32)
    labels = np.argmax(images @ w_true, axis=1).astype(np.int64)
    files = [f"{path}-{s:05d}-of-{shards:05d}" for s in range(shards)]
    for s, f in enumerate(files):
        with TFRecordWriter(f) as w:
            for i in range(s, n, shards):
                ex = make_example(image=images[i].tolist(),
                                  label=[int(labels[i])])
                w.write(ex.SerializeToString())
    return images, labels, files


def records_pipeline(files, batch_size, device=None):
    """The example's ``input_pipeline``: parallel sharded reads (AUTOTUNE,
    strict shard order), a seeded shuffle, repeat, batch, one native
    parse a batch, ``prefetch_to_device`` onto ``device`` (default the
    card); a one-shot iterator of the graph being built."""
    spec = {"image": stf.FixedLenFeature([784], stf.float32),
            "label": stf.FixedLenFeature([], stf.int64)}
    ds = stf.data.TFRecordDataset(files, num_parallel_reads=stf.data.AUTOTUNE)
    ds = ds.shuffle(256, seed=7).repeat().batch(batch_size)
    ds = ds.parse_example(spec)
    ds = ds.prefetch_to_device(buffer_size=2, device=device)
    return ds.make_one_shot_iterator()


def build_logits(x):
    """The example's convnet (its variable names)."""
    h = stf.reshape(x, [-1, 28, 28, 1])
    h = stf.layers.conv2d(h, 16, 3, activation=stf.nn.relu, name="c1")
    h = stf.layers.max_pooling2d(h, 2, 2)
    h = stf.layers.conv2d(h, 32, 3, activation=stf.nn.relu, name="c2")
    h = stf.layers.max_pooling2d(h, 2, 2)
    h = stf.reshape(h, [-1, 5 * 5 * 32])
    h = stf.layers.dense(h, 64, activation=stf.nn.relu, name="fc1")
    return stf.layers.dense(h, 10, name="fc2")


def records_model(files, batch_size=32, learning_rate=1e-3, device=None):
    """The example's training graph in the default graph: ``get_next()``
    of :func:`records_pipeline` feeding :func:`build_logits`, the mean
    sparse xent, Adam with a global step, and a ``loss`` scalar summary.
    Returns ``{"iterator", "loss", "train_op", "global_step"}``."""
    it = records_pipeline(files, batch_size, device=device)
    feats = it.get_next()
    logits = build_logits(feats["image"])
    labels = stf.cast(feats["label"], stf.int32)
    loss = stf.reduce_mean(stf.nn.sparse_softmax_cross_entropy_with_logits(
        labels=stf.reshape(labels, [-1]), logits=logits))
    gs = stf.train.get_or_create_global_step()
    train_op = stf.train.AdamOptimizer(learning_rate).minimize(
        loss, global_step=gs)
    stf.summary.scalar("loss", loss)
    return {"iterator": it, "loss": loss, "train_op": train_op,
            "global_step": gs}
