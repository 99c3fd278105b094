"""PyTorch/CUDA port of simple_tensorflow_tpu
(``import simple_tensorflow_tpu_torch as stf``).

The TF-1 front end: deferred graphs (``stf.placeholder``, ``stf.Variable``,
``stf.layers``, ``stf.nn``, ``stf.train``) run by ``stf.Session`` on an
NVIDIA H100 (or, with ``ConfigProto(device_count={"GPU": 0})``, on the
CPU), beside the eager paths of the port: paged causal-LM serving and
causal-LM and ResNet-50 training with hand-written CUDA kernels (see
PERF.md). Importing the package loads no kernel library; the kernels are
built and loaded at their first launch.
"""

from .framework import dtypes, errors
from .framework.config_pb import ConfigProto
from .framework.constant_op import constant
from .framework.dtypes import (DType, as_dtype, bfloat16, double, float16,
                               float32, float64, half, int8, int16, int32,
                               int64, uint8)
from .framework.dtypes import bool_ as bool  # noqa: A001
from .framework.gradients import gradients
from .framework.graph import (Graph, GraphKeys, Operation, Tensor,
                              add_to_collection, control_dependencies,
                              convert_to_tensor, get_collection,
                              get_default_graph, name_scope,
                              reset_default_graph)
from .framework.random_seed import get_seed, set_random_seed
from .framework.tensor_shape import Dimension, TensorShape
from .ops.array_ops import (fill, gather, identity, ones, placeholder,
                            placeholder_with_default, reshape, stop_gradient,
                            transpose, zeros)
from .ops.control_flow_ops import group, no_op
from .ops.init_ops import (glorot_uniform_initializer, ones_initializer,
                           random_normal_initializer,
                           variance_scaling_initializer, zeros_initializer)
from .ops.math_ops import (add, add_n, argmax, cast, divide, equal, matmul,
                           minimum, multiply, not_equal, pow, realdiv,
                           reduce_mean, reduce_sum, subtract, truediv)
from .ops.random_ops import random_normal, random_uniform
from .ops.state_ops import assign, assign_add, assign_sub
from .ops.variable_scope import (AUTO_REUSE, VariableScope, get_variable,
                                 get_variable_scope, variable_scope)
from .ops.variables import (Variable, global_variables,
                            global_variables_initializer,
                            initialize_all_variables, trainable_variables,
                            variables_initializer)
from .client.session import Session, get_default_session
from . import analysis, layers, nn, train
