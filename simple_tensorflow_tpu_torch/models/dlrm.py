"""DLRM-style ranking model over fused embedding bags: port of
``simple_tensorflow_tpu/models/dlrm.py``.

The canonical deep-learning recommendation shape (1906.00091): a dense
MLP "bottom" over continuous features, pooled embedding-bag lookups over
the categorical features, an explicit pairwise dot-product interaction
between all latent vectors, and a "top" MLP producing a CTR logit trained
with sigmoid cross-entropy. The JAX code with the port's imports, so
``dlrm_model`` builds the JAX graph op for op with the JAX package's
seeded glorot and uniform initializers. The categorical path runs through
``embedding_ops.embedding_bag``: the ``EmbeddingLookupFused`` op, which
without a mesh (always, in the port) is dedup-before-lookup and one
clipped gather, its gradient a segment sum over the inverse index and one
deterministic scatter-add into the table. No Pallas kernel is on this
path in the JAX package, none on the card.
"""

from __future__ import annotations

import numpy as np

import simple_tensorflow_tpu_torch as stf
from simple_tensorflow_tpu_torch.ops import embedding_ops


def _mlp(x, sizes, scope, *, final_relu=True, seed=0):
    """Stacked dense layers; relu on all but optionally the last."""
    with stf.variable_scope(scope, reuse=stf.AUTO_REUSE):
        for i, width in enumerate(sizes):
            in_dim = int(x.shape.dims[-1].value)
            w = stf.get_variable(
                f"w{i}", [in_dim, width],
                initializer=stf.glorot_uniform_initializer(
                    seed=seed + 31 * i))
            b = stf.get_variable(f"b{i}", [width],
                                 initializer=stf.zeros_initializer())
            x = stf.nn.bias_add(stf.matmul(x, w), b)
            if final_relu or i + 1 < len(sizes):
                x = stf.nn.relu(x)
    return x


def dlrm_model(batch_size=32, num_dense=8,
               table_sizes=(1000, 1000, 500, 200), embedding_dim=16,
               max_ids_per_feature=8, bottom_mlp=(32, 16),
               top_mlp=(32, 16, 1), learning_rate=0.1, combiner="sum",
               axis="ep", dedup=True, optimizer=None, seed=17):
    """Build the DLRM training graph; returns the standard zoo dict.

    ``bottom_mlp[-1]`` must equal ``embedding_dim`` (the interaction
    needs every latent vector in the same space); the default shapes
    satisfy it.  Categorical feature ``i`` feeds two placeholders:
    ``cat{i}_ids`` int32 ``[batch, max_ids_per_feature]`` padded with
    ``-1`` and ``cat{i}_lengths`` int32 ``[batch]`` — the
    ``RaggedFeature`` parser contract, so a parsed Example batch plugs
    straight in. ``optimizer`` defaults to SGD at ``learning_rate``.
    """
    if bottom_mlp[-1] != embedding_dim:
        raise ValueError(
            f"dlrm_model: bottom_mlp[-1] ({bottom_mlp[-1]}) must equal "
            f"embedding_dim ({embedding_dim}) for the interaction")
    dense = stf.placeholder(stf.float32, [batch_size, num_dense],
                            name="dense_features")
    labels = stf.placeholder(stf.float32, [batch_size, 1], name="labels")
    id_phs, len_phs = [], []
    for i in range(len(table_sizes)):
        id_phs.append(stf.placeholder(
            stf.int32, [batch_size, max_ids_per_feature],
            name=f"cat{i}_ids"))
        len_phs.append(stf.placeholder(stf.int32, [batch_size],
                                       name=f"cat{i}_lengths"))

    bottom = _mlp(dense, bottom_mlp, "dlrm/bottom", seed=seed)

    tables, bags = [], []
    with stf.variable_scope("dlrm/embedding", reuse=stf.AUTO_REUSE):
        for i, vocab in enumerate(table_sizes):
            t = stf.get_variable(
                f"table_{i}", [vocab, embedding_dim],
                initializer=stf.random_uniform_initializer(
                    -1.0 / np.sqrt(embedding_dim),
                    1.0 / np.sqrt(embedding_dim), seed=seed + 101 * i))
            tables.append(t)
            bags.append(embedding_ops.embedding_bag(
                t, id_phs[i], len_phs[i], combiner=combiner, axis=axis,
                dedup=dedup, name=f"bag_{i}"))

    # pairwise dot-product interaction over [bottom] + bags — the
    # feature count is small and static, so explicit pair reductions
    # beat a batched matmul + tril mask on readability and avoid any
    # rank-3 contraction in the plan
    feats = [bottom] + bags
    pairs = []
    for i in range(len(feats)):
        for j in range(i + 1, len(feats)):
            pairs.append(stf.reduce_sum(
                stf.multiply(feats[i], feats[j]), 1, keepdims=True))
    top_in = stf.concat([bottom] + bags + pairs, axis=1)

    logits = _mlp(top_in, top_mlp, "dlrm/top", final_relu=False,
                  seed=seed + 7)
    loss = stf.reduce_mean(stf.nn.sigmoid_cross_entropy_with_logits(
        labels=labels, logits=logits))
    if optimizer is None:
        optimizer = stf.train.GradientDescentOptimizer(learning_rate)
    train_op = optimizer.minimize(loss)
    prediction = stf.sigmoid(logits, name="ctr")
    return {"dense": dense, "cat_ids": id_phs, "cat_lengths": len_phs,
            "labels": labels, "loss": loss, "train_op": train_op,
            "logits": logits, "prediction": prediction,
            "tables": tables}


def synthetic_dlrm_batch(batch_size, num_dense=8,
                         table_sizes=(1000, 1000, 500, 200),
                         max_ids_per_feature=8, zipf_a=1.3, seed=0):
    """Skewed synthetic batch matching :func:`dlrm_model` placeholders.

    Ids are Zipf-distributed (real click logs are head-heavy — the
    dedup-before-lookup pass is exercised, not idle) and rows are
    ragged: per-example lengths are uniform in [0, max_ids_per_feature]
    with ``-1`` padding, the RaggedFeature contract.
    """
    rng = np.random.RandomState(seed)
    dense = rng.standard_normal((batch_size, num_dense)).astype(np.float32)
    labels = (rng.uniform(size=(batch_size, 1)) < 0.3).astype(np.float32)
    cat_ids, cat_lengths = [], []
    for vocab in table_sizes:
        lens = rng.randint(0, max_ids_per_feature + 1, batch_size)
        ids = np.full((batch_size, max_ids_per_feature), -1, np.int32)
        for b, ln in enumerate(lens):
            if ln:
                draw = rng.zipf(zipf_a, ln) - 1
                ids[b, :ln] = np.minimum(draw, vocab - 1)
        cat_ids.append(ids)
        cat_lengths.append(lens.astype(np.int32))
    return {"dense": dense, "labels": labels, "cat_ids": cat_ids,
            "cat_lengths": cat_lengths}


def feed_dict_for(model, batch):
    """Zip a synthetic (or parsed) batch onto the model placeholders."""
    fd = {model["dense"]: batch["dense"], model["labels"]: batch["labels"]}
    for ph, v in zip(model["cat_ids"], batch["cat_ids"]):
        fd[ph] = v
    for ph, v in zip(model["cat_lengths"], batch["cat_lengths"]):
        fd[ph] = v
    return fd
