"""Word2Vec skip-gram with NCE loss: port of
``simple_tensorflow_tpu/models/word2vec.py``.

The JAX code with the port's imports: ``skipgram_model`` builds the
tutorial graph op for op (the embedding ``Gather``, the
``LogUniformCandidateSampler`` of ``nce_loss`` with ``unique=True``, one
gather of the NCE weights and one of the biases, the
``SigmoidCrossEntropyWithLogits``, plain SGD), and ``stf.Session``
trains it. The embedding gradients are the port's deterministic
``Gather`` backward (``index_put_`` with accumulate, sorted), so a
captured step stays bit-identical with an eager one; the sampler draws
from the op's key of the run on the device (``ops/candidate_sampling_ops.py``).
No Pallas kernel is on this path in the JAX package, none on the card.
"""

from __future__ import annotations

import numpy as np

import simple_tensorflow_tpu_torch as stf


def skipgram_model(vocab_size=50000, embedding_size=128, batch_size=128,
                   num_sampled=64, learning_rate=1.0):
    """The classic tutorial graph: embeddings -> NCE loss -> SGD."""
    inputs = stf.placeholder(stf.int32, [batch_size], name="train_inputs")
    labels = stf.placeholder(stf.int32, [batch_size, 1], name="train_labels")
    with stf.variable_scope("word2vec", reuse=stf.AUTO_REUSE):
        embeddings = stf.get_variable(
            "embeddings", [vocab_size, embedding_size],
            initializer=stf.random_uniform_initializer(-1.0, 1.0))
        nce_w = stf.get_variable(
            "nce_weights", [vocab_size, embedding_size],
            initializer=stf.truncated_normal_initializer(
                stddev=1.0 / np.sqrt(embedding_size)))
        nce_b = stf.get_variable("nce_biases", [vocab_size],
                                 initializer=stf.zeros_initializer())
    embed = stf.nn.embedding_lookup(embeddings, inputs)
    loss = stf.reduce_mean(stf.nn.nce_loss(
        weights=nce_w, biases=nce_b, labels=labels, inputs=embed,
        num_sampled=num_sampled, num_classes=vocab_size))
    train_op = stf.train.GradientDescentOptimizer(learning_rate).minimize(
        loss)
    # cosine-similarity graph for nearest-neighbour eval
    norm = stf.sqrt(stf.reduce_sum(stf.square(embeddings), 1, keepdims=True))
    normalized = embeddings / norm
    return {"train_inputs": inputs, "train_labels": labels, "loss": loss,
            "train_op": train_op, "embeddings": embeddings,
            "normalized_embeddings": normalized}


def similarity(normalized_embeddings, valid_ids):
    """(V,D) x ids -> (len(ids), V) cosine similarity."""
    valid = stf.constant(np.asarray(valid_ids, np.int32))
    valid_emb = stf.nn.embedding_lookup(normalized_embeddings, valid)
    return stf.matmul(valid_emb, normalized_embeddings, transpose_b=True)


def synthetic_skipgram_batch(batch_size, vocab_size=50000, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab_size, batch_size).astype(np.int32),
            rng.randint(0, vocab_size, (batch_size, 1)).astype(np.int32))
