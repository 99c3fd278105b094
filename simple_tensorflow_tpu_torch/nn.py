"""stf.nn of the port (ref: tensorflow/python/ops/nn.py): the graph ops the
MNIST, transformer, ResNet, BERT and RNN graphs and beam search reach
(``rnn_cell``, ``dynamic_rnn``, ``raw_rnn`` and the other RNN loops,
``log_softmax``, ``top_k`` and ``decode_attention`` among them), and the fused ops
(``fused_attention``, ``fused_bias_dropout_residual``,
``fused_layer_norm``, ``fused_softmax_cross_entropy``), which take graph
tensors or, from the eager models, torch tensors (``ops/fused_ops.py``);
for word2vec ``nce_loss``, ``sampled_softmax_loss``, the candidate
samplers and ``compute_accidental_hits``, and for DLRM
``sigmoid_cross_entropy_with_logits`` (with
``weighted_cross_entropy_with_logits``).
Left out: the rest of the JAX package's ``stf.nn`` namespace."""

from .ops.embedding_ops import embedding_lookup
from .ops.fused_ops import (fused_attention, fused_bias_dropout_residual,
                            fused_layer_norm, fused_softmax_cross_entropy)
from .ops.candidate_sampling_ops import (all_candidate_sampler,
                                         compute_accidental_hits,
                                         fixed_unigram_candidate_sampler,
                                         learned_unigram_candidate_sampler,
                                         log_uniform_candidate_sampler,
                                         uniform_candidate_sampler)
from .ops.nn_impl import fused_batch_norm, nce_loss, sampled_softmax_loss
from .ops.kv_cache_ops import decode_attention
from .ops.nn_ops import (bias_add, conv2d, dropout, gelu, l2_loss,
                         log_softmax, max_pool, relu,
                         sigmoid_cross_entropy_with_logits, softmax,
                         softmax_cross_entropy_with_logits,
                         softmax_cross_entropy_with_logits_v2,
                         sparse_softmax_cross_entropy_with_logits, top_k,
                         weighted_cross_entropy_with_logits)
from .ops import rnn_cell
from .ops.rnn import (bidirectional_dynamic_rnn, dynamic_rnn, raw_rnn,
                      static_rnn)
from .ops.math_ops import sigmoid, tanh

__all__ = ["all_candidate_sampler", "bias_add", "bidirectional_dynamic_rnn",
           "compute_accidental_hits", "conv2d",
           "decode_attention", "dropout", "dynamic_rnn", "embedding_lookup",
           "fixed_unigram_candidate_sampler",
           "fused_attention", "fused_bias_dropout_residual",
           "fused_batch_norm", "fused_layer_norm",
           "fused_softmax_cross_entropy", "gelu", "l2_loss",
           "learned_unigram_candidate_sampler", "log_softmax",
           "log_uniform_candidate_sampler", "max_pool", "nce_loss",
           "raw_rnn", "relu", "rnn_cell", "sampled_softmax_loss",
           "sigmoid", "sigmoid_cross_entropy_with_logits", "softmax",
           "softmax_cross_entropy_with_logits",
           "softmax_cross_entropy_with_logits_v2",
           "sparse_softmax_cross_entropy_with_logits", "static_rnn",
           "tanh", "top_k", "uniform_candidate_sampler",
           "weighted_cross_entropy_with_logits"]
