"""stf.nn of the port (ref: tensorflow/python/ops/nn.py): the graph ops the
MNIST and transformer graphs reach, and the fused ops
(``fused_attention``, ``fused_bias_dropout_residual``,
``fused_layer_norm``, ``fused_softmax_cross_entropy``), which take graph
tensors or, from the eager models, torch tensors (``ops/fused_ops.py``).
Left out: the rest of the JAX package's ``stf.nn`` namespace."""

from .ops.embedding_ops import embedding_lookup
from .ops.fused_ops import (fused_attention, fused_bias_dropout_residual,
                            fused_layer_norm, fused_softmax_cross_entropy)
from .ops.nn_ops import (bias_add, conv2d, dropout, max_pool, relu,
                         softmax_cross_entropy_with_logits,
                         softmax_cross_entropy_with_logits_v2,
                         sparse_softmax_cross_entropy_with_logits)

__all__ = ["bias_add", "conv2d", "dropout", "embedding_lookup",
           "fused_attention", "fused_bias_dropout_residual",
           "fused_layer_norm", "fused_softmax_cross_entropy", "max_pool",
           "relu", "softmax_cross_entropy_with_logits",
           "softmax_cross_entropy_with_logits_v2",
           "sparse_softmax_cross_entropy_with_logits"]
