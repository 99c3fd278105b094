"""``Print`` (ref: tensorflow/python/ops/logging_ops.py:37); the port of
``simple_tensorflow_tpu/ops/logging_ops.py``'s ``Print``: the identity
of its input that prints ``message`` and the values of ``data`` when it
runs. Its declared ``io`` effect keeps a plan with it out of
``run_steps`` windows (``analysis/loop_safety.py``) and out of CUDA
graphs (its run reads the device from the host). Left out: ``Assert``
and ``print_v2``."""

from __future__ import annotations

import numpy as np

from ..framework import graph as ops_mod
from ..framework import op_registry


def _lower_print(ctx, op, inputs):
    data = inputs[1:]
    if data:
        vals = [np.asarray(d.detach().float().cpu() if d.is_floating_point()
                           else d.detach().cpu()) for d in data]
        print(op.attrs.get("message", "") + " ".join(str(v) for v in vals),
              flush=True)
    return [inputs[0]]


op_registry.register("Print", lower=_lower_print,
                     effects=op_registry.Effects(io=True))


def Print(input_, data, message=None, first_n=None, summarize=None,
          name=None):
    """(ref: logging_ops.py:37 ``Print``)."""
    x = ops_mod.convert_to_tensor(input_)
    data_t = [ops_mod.convert_to_tensor(d) for d in data]
    op = ops_mod.get_default_graph().create_op(
        "Print", [x] + data_t,
        attrs={"message": message or "", "summarize": summarize or 3},
        name=name or "Print", output_specs=[(x.shape, x.dtype)])
    return op.outputs[0]
