"""stf.nn of the port (ref: tensorflow/python/ops/nn.py): the graph ops the
MNIST graphs reach. Left out: the rest of the JAX package's ``stf.nn``
namespace (its fused ops, embeddings and normalisation functions)."""

from .ops.nn_ops import (bias_add, conv2d, dropout, max_pool, relu,
                         softmax_cross_entropy_with_logits,
                         softmax_cross_entropy_with_logits_v2,
                         sparse_softmax_cross_entropy_with_logits)

__all__ = ["bias_add", "conv2d", "dropout", "max_pool", "relu",
           "softmax_cross_entropy_with_logits",
           "softmax_cross_entropy_with_logits_v2",
           "sparse_softmax_cross_entropy_with_logits"]
