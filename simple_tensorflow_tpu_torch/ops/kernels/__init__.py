"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``*_plain``) and behind a wrapper with a launch counter."""

from .common import (counter_keep_mask_plain, launch_counts,
                     reset_launch_counts)
from .decode_attention import decode_attention, decode_attention_plain
from .dropout import dropout_bwd, dropout_fwd, dropout_plain
from .dropout_residual import (dropout_bias_residual, dropout_residual_bwd,
                               dropout_residual_bwd_plain,
                               dropout_residual_fwd,
                               dropout_residual_fwd_plain)
from .flash_attention import (flash_attention, flash_attention_dkdv,
                              flash_attention_dkdv_plain, flash_attention_dq,
                              flash_attention_dq_plain, flash_attention_fwd,
                              flash_attention_fwd_plain)
from .fused_update import (adam_update, adam_update_plain, momentum_update,
                           momentum_update_plain)
from .numeric_summary import numeric_summary, numeric_summary_plain
from .layer_norm import (layer_norm, layer_norm_bwd, layer_norm_bwd_plain,
                         layer_norm_fwd, layer_norm_plain)
from .quant_matmul import (quant_matmul, quant_matmul_plain,
                           quantize_rowwise_plain)
from .softmax_xent import (softmax_cross_entropy, softmax_xent_bwd,
                           softmax_xent_bwd_plain, softmax_xent_fwd,
                           softmax_xent_fwd_plain)

__all__ = [
    "adam_update", "adam_update_plain", "counter_keep_mask_plain",
    "decode_attention", "decode_attention_plain", "dropout_bias_residual",
    "dropout_bwd", "dropout_fwd", "dropout_plain", "dropout_residual_bwd",
    "dropout_residual_bwd_plain", "dropout_residual_fwd",
    "dropout_residual_fwd_plain", "flash_attention", "flash_attention_dkdv",
    "flash_attention_dkdv_plain", "flash_attention_dq",
    "flash_attention_dq_plain", "flash_attention_fwd",
    "flash_attention_fwd_plain", "launch_counts", "layer_norm",
    "layer_norm_bwd", "layer_norm_bwd_plain", "layer_norm_fwd",
    "layer_norm_plain", "momentum_update", "momentum_update_plain",
    "numeric_summary", "numeric_summary_plain",
    "quant_matmul", "quant_matmul_plain",
    "quantize_rowwise_plain", "reset_launch_counts", "softmax_cross_entropy",
    "softmax_xent_bwd", "softmax_xent_bwd_plain", "softmax_xent_fwd",
    "softmax_xent_fwd_plain",
]
