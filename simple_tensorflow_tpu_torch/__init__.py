"""PyTorch/CUDA port of simple_tensorflow_tpu
(``import simple_tensorflow_tpu_torch as stf``).

The TF-1 front end: deferred graphs (``stf.placeholder``, ``stf.Variable``,
``stf.layers``, ``stf.nn``, ``stf.train``) run by ``stf.Session`` on an
NVIDIA H100 (or, with ``ConfigProto(device_count={"GPU": 0})``, on the
CPU), beside the eager paths of the port: paged causal-LM serving and
causal-LM and ResNet-50 training with hand-written CUDA kernels (see
PERF.md). The transformer, causal-LM and ResNet-50 training graphs
(``models.transformer.transformer_train_model``,
``models.causal_lm.causal_lm_train_model``,
``models.resnet.resnet50_train_model``) train through the Session, also
as the TF-1 training loop: ``Session.run_steps``, ``stf.train.Saver``,
the hooks and ``MonitoredTrainingSession``, and ``stf.summary``; BERT
with per-layer recompute (``models.bert``), and the RNN graphs
(``models.ptb_lstm``, ``models.rnn_seq2seq``) on ``stf.scan`` and
``stf.nn.rnn_cell``; TF-1 control flow (``stf.cond``, ``stf.case``,
``stf.while_loop``, ``stf.TensorArray``, ``stf.nn.raw_rnn``) and the
transformer's beam search (``models.transformer.beam_search_decode``);
the input pipeline (``stf.data``: TFRecord shards, ``parse_example``,
``prefetch_to_device`` onto the card, ``iterator.get_next()`` run by the
Session in its host stage before the device step). Importing the package
loads no kernel library; the kernels are built and loaded at their first
launch, the native host runtime (``runtime_cc/``) at its first use.
"""

from .framework import dtypes, errors
from .framework.config_pb import ConfigProto
from .framework.constant_op import constant
from .framework.dtypes import (DType, as_dtype, bfloat16, double, float16,
                               float32, float64, half, int8, int16, int32,
                               int64, string, uint8)
from .framework.dtypes import bool_ as bool  # noqa: A001
from .framework.gradients import gradients
from .framework.graph import (Graph, GraphKeys, Operation, Tensor,
                              add_to_collection, control_dependencies,
                              convert_to_tensor, get_collection,
                              get_default_graph, name_scope,
                              reset_default_graph)
from .framework.random_seed import get_seed, set_random_seed
from .framework.tensor_shape import Dimension, TensorShape
from .ops.array_ops import (concat, expand_dims, fill, gather, identity,
                            one_hot, ones, ones_like, placeholder,
                            placeholder_with_default, reshape, reverse,
                            sequence_mask, slice, squeeze, stop_gradient,
                            strided_slice, tile, transpose, where, zeros,
                            zeros_like)
from .ops.clip_ops import (clip_by_global_norm, clip_by_norm, clip_by_value,
                           global_norm)
from .ops.control_flow_ops import (case, cond, group, no_op, smart_cond,
                                   while_loop)
from .ops.functional_ops import foldl, foldr, map_fn, py_func, scan
from .ops.logging_ops import Print
from .ops import parsing_ops
from .ops.parsing_ops import (FixedLenFeature, FixedLenSequenceFeature,
                              RaggedFeature, SparseFeature, VarLenFeature,
                              decode_csv, decode_json_example, decode_raw,
                              parse_example, parse_single_example,
                              parse_tensor, serialize_tensor)
from .ops import init_ops
from .ops.init_ops import (constant_initializer,
                           glorot_uniform_initializer, ones_initializer,
                           random_normal_initializer,
                           random_uniform_initializer,
                           truncated_normal_initializer,
                           variance_scaling_initializer, zeros_initializer)
from .ops.math_ops import (add, add_n, argmax, cast, divide, equal, exp,
                           floordiv, floormod, greater, greater_equal, less,
                           less_equal, log, logical_and, logical_not,
                           logical_or,
                           matmul, maximum, minimum, multiply, negative,
                           not_equal, pow, range, realdiv, reduce_all,
                           reduce_mean, reduce_sum, sigmoid, sqrt, square,
                           subtract, tanh, truediv)
from .ops.random_ops import random_normal, random_uniform, truncated_normal
from .ops.state_ops import assign, assign_add, assign_sub
from .ops.tensor_array_ops import TensorArray
from .ops.variable_scope import (AUTO_REUSE, VariableScope, get_variable,
                                 get_variable_scope, variable_scope)
from .ops.variables import (Variable, global_variables,
                            global_variables_initializer,
                            initialize_all_variables, local_variables,
                            local_variables_initializer, trainable_variables,
                            variables_initializer)
from .framework import function
from .framework.function import Defun, recompute_grad
from .client.session import Session, get_default_session
from .ops.numerics import (add_check_numerics_ops, check_numerics,
                           verify_tensor_all_finite)
from . import (analysis, checkpoint, data, debug, kernels, layers, nn,
               summary, train)
