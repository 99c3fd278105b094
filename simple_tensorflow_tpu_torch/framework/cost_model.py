"""Static per-op cost model over the graph (ref: tensorflow/core/grappler/
costs/{cost_estimator.h,op_level_cost_estimator.cc,graph_memory.cc}).

Port of ``simple_tensorflow_tpu/framework/cost_model.py``, rule for rule,
so that the port's graphs price as the JAX package's do: FLOPs, bytes and
peak live bytes of a pruned graph slice before it runs. Per-op rules
(matmul/conv/reduction families, the fused ops) with an elementwise
default; ``bytes = inputs + outputs`` per op (pre-fusion accounting);
``SymbolicGradient`` costed as 2x its forward slice; function ops priced by
recursing into their bodies (``_function_op_cost``), whose attrs, mode and
static trip count come from :data:`_FUNCTION_OPS` (the JAX package keeps
them in its optimizer's registry, ``framework/optimizer.py:118``, which
the port does not have). ``estimate`` (:480) runs the liveness sweep for
peak memory; ``predicted_vs_measured`` (:576) sets the prediction beside a
measured step and the MFU, from ``utils.perf`` (the card's figures, the
JAX package's nominal ones on the CPU); ``suggest_remat``,
``resolve_recompute`` and the model helpers (:620-727) decide
``recompute="auto"`` for the graph models. Slices are pruned as the JAX
pruner prunes them (``lowering.prune(..., follow_shape_only=True)``): a
``ZerosLike`` of a static shape keeps its producer in the priced op list,
which the port's Session does not run. ``mesh_shard_factor`` is 1: the
port has no mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import graph as ops_mod
from . import lowering as lowering_mod

Tensor = ops_mod.Tensor
Operation = ops_mod.Operation

# Every step pays host dispatch (Python run() plumbing, executable
# lookup, device launch, result sync) regardless of program size: the
# JAX package's figure, kept so the two packages predict alike. Predictions
# are floored here so predicted-vs-measured on tiny configs reads as
# dispatch-bound (ratio ≈ measured/floor) instead of a nonsense 100x.
HOST_DISPATCH_FLOOR_S = 1.5e-4


def _nelems(shape) -> Optional[int]:
    if shape is None or shape.rank is None:
        return None
    n = 1
    for d in shape.dims:
        if d.value is None:
            return None
        n *= d.value
    return n


def _tensor_bytes(t: Tensor) -> int:
    n = _nelems(t.shape)
    if n is None:
        return 0
    return n * t.dtype.base_dtype.size


def _out_elems(op: Operation) -> int:
    total = 0
    for t in op.outputs:
        n = _nelems(t.shape)
        total += n or 0
    return total


# ---------------------------------------------------------------------------
# per-op FLOP rules (ref: grappler/costs/op_level_cost_estimator.cc — the
# reference's PredictMatMul / PredictConv2D / elementwise default)
# ---------------------------------------------------------------------------

def _flops_matmul(op: Operation) -> float:
    a, b = op.inputs[0], op.inputs[1]
    if a.shape.rank is None or b.shape.rank is None:
        return 0.0
    ash = [d.value or 0 for d in a.shape.dims]
    bsh = [d.value or 0 for d in b.shape.dims]
    ta = bool(op.attrs.get("transpose_a", op.attrs.get("adj_x", False)))
    tb = bool(op.attrs.get("transpose_b", op.attrs.get("adj_y", False)))
    m = ash[-1 if ta else -2]
    k = ash[-2 if ta else -1]
    n = bsh[-2 if tb else -1]
    batch = 1
    for d in ash[:-2]:
        batch *= d
    return 2.0 * batch * m * k * n


def _flops_conv2d(op: Operation) -> float:
    # out_elems x (2 x kh x kw x cin) — same formula the reference uses
    x, w = op.inputs[0], op.inputs[1]
    out_n = _out_elems(op)
    if w.shape.rank is None or out_n == 0:
        return 0.0
    wsh = [d.value or 0 for d in w.shape.dims]
    if len(wsh) < 3:
        return 0.0
    kh, kw, cin = wsh[0], wsh[1], wsh[2]
    return 2.0 * out_n * kh * kw * cin


def _flops_conv_backward(op: Operation) -> float:
    # dgrad/wgrad are convs of the same arithmetic intensity
    return _flops_conv2d(op) if len(op.inputs) >= 2 else 0.0


_REDUCTION_OPS = {"Sum", "Mean", "Prod", "Max", "Min", "All", "Any",
                  "ArgMax", "ArgMin", "LogSumExp"}
_FREE_OPS = {"Identity", "Reshape", "StopGradient", "Placeholder", "Const",
             "VariableV2", "ReadVariable", "Shape", "Rank", "Size",
             "NoOp", "ExpandDims", "Squeeze", "ZerosLike", "Snapshot",
             "PreventGradient", "CheckNumerics",
             # a layout annotation, not compute: any resharding it
             # forces is priced by the sharding analyzer's edge
             # classification, never double-counted here
             "ShardingConstraint"}
# pure data movement: bytes count, flops don't
_ZERO_FLOP_OPS = {"Transpose", "CapturedInput", "FuncArg"}
_TRANSCENDENTAL_OPS = {"Exp", "Log", "Sigmoid", "Tanh", "Softmax",
                       "LogSoftmax", "Erf", "Erfc", "Pow", "Rsqrt",
                       "Sqrt", "Softplus", "Elu", "Selu", "Gelu",
                       "Expm1", "Log1p", "Sin", "Cos", "Tan", "Digamma",
                       "Lgamma"}


def _op_flops(op: Operation, grad_depth: int = 0,
              fn_depth: int = 0) -> float:
    t = op.type
    if t in ("MatMul", "BatchMatMul", "Einsum", "SparseMatMul"):
        return _flops_matmul(op) if t != "Einsum" else 2.0 * _out_elems(op)
    if t in ("Conv2D", "DepthwiseConv2dNative", "Conv3D"):
        return _flops_conv2d(op)
    if t in ("Conv2DBackpropInput", "Conv2DBackpropFilter"):
        return _flops_conv_backward(op)
    if t == "SymbolicGradient":
        return _symbolic_gradient_flops(op, grad_depth)
    if t == "SymbolicHessian":
        return 4.0 * _symbolic_gradient_flops(op, grad_depth)
    fc = _function_op_cost(op, grad_depth, fn_depth)
    if fc is not None:
        return fc[0]
    if t in _FREE_OPS or t in _ZERO_FLOP_OPS:
        return 0.0
    if t == "NumericSummary":
        # four fused elementwise reductions over the tapped tensor
        # (nonfinite count, max-abs, sum-of-squares, zero count) — NOT
        # free: the health plane's cost must show up in plan estimates
        # so the <3% overhead budget is a priced, checkable claim
        n = _nelems(op.inputs[0].shape) or 0
        return 4.0 * n
    if t == "HistogramBucketCounts":
        # searchsorted over the fixed reference grid (~log2(|edges|)
        # comparisons per element) plus the moment reductions
        n = _nelems(op.inputs[0].shape) or 0
        return 14.0 * n
    if t in _REDUCTION_OPS:
        # one flop per INPUT element reduced
        n = sum(_nelems(i.shape) or 0 for i in op.inputs[:1])
        return float(n)
    if t in ("FusedBatchNorm", "FusedBatchNormV2", "LayerNorm"):
        n = _nelems(op.inputs[0].shape) or 0
        return 5.0 * n  # two reduction passes + normalize + scale/shift
    if t in ("FusedAdamUpdate", "FusedMomentumUpdate"):
        # the fused optimizer tail (stf.kernels): elementwise over every
        # gradient element — m/v updates, alpha scaling, param subtract
        # (~12 flops/elem Adam, ~6 Momentum); same arithmetic the
        # per-variable assign chains carried, now priced on one op
        n = sum(_nelems(i.shape) or 0 for i in op.inputs)
        return (12.0 if t == "FusedAdamUpdate" else 6.0) * n
    if t == "DecodeAttention":
        # q·K + P·V over the gathered cache: 4 * B * Kq * H * max_len
        # * D (Kq = 1 for the classic single-query step, the query-
        # block width for verify/block-prefill plans; the output is
        # only (B[, Kq], H, D) — the default out-elems pricing would
        # miss the cache-length factor entirely)
        ks = op.inputs[1].shape
        qs = op.inputs[0].shape
        kq = 1
        if qs.rank == 4 and qs.dims[1].value:
            kq = int(qs.dims[1].value)
        if ks.rank == 4 and all(d.value for d in ks.dims):
            b, max_len, h, d = (int(x.value) for x in ks.dims)
            return 4.0 * b * kq * h * max_len * d
        return 2.0 * _out_elems(op)
    if t in ("KVCacheAlloc", "KVCacheAppend", "KVCacheGather",
             "KVCachePageCopy"):
        return 0.0  # pure data movement; bytes are priced in _op_bytes
    if t == "EmbeddingLookupFused":
        # row routing is data movement (the whole point vs the one-hot
        # contraction's B*vocab_shard*D matmul flops); the dedup
        # unique-sort is ~b log b, negligible against the row bytes
        return 0.0
    if t == "EmbeddingScatterAddGrad":
        # one accumulate per incoming cotangent element (segment_sum +
        # owning-shard scatter-add); NOT the default out-elems pricing,
        # which would charge the whole table per step
        return 2.0 * (_nelems(op.inputs[1].shape) or 0) \
            if len(op.inputs) > 1 else 0.0
    mult = 2.0 if t in _TRANSCENDENTAL_OPS else 1.0
    return mult * _out_elems(op)


def _symbolic_gradient_flops(op: Operation, grad_depth: int) -> float:
    """Backward slice ≈ 2x the forward slice it differentiates (wgrad +
    dgrad per matmul/conv; the forward is not recounted)."""
    if grad_depth > 2:  # grad-of-grad-of-grad: stop the recursion
        return 0.0
    n_ys = op.attrs.get("n_ys", 1)
    n_xs = op.attrs.get("n_xs", 1)
    ys = list(op.inputs[:n_ys])
    xs = list(op.inputs[n_ys:n_ys + n_xs])
    try:
        path_ops, _ = lowering_mod.ancestors_between(
            xs, ys, follow_shape_only=True)
    except Exception:
        return 0.0
    return 2.0 * sum(_op_flops(p, grad_depth + 1) for p in path_ops)


def _op_bytes(op: Operation) -> float:
    """inputs + outputs — the pre-fusion HLO accounting (each use of an
    operand is a read; fusion reduces the real number, measured
    separately by utils/perf)."""
    return float(sum(_tensor_bytes(t) for t in op.inputs)
                 + sum(_tensor_bytes(t) for t in op.outputs))


_NCHW_PENALTY_OPS = {"Conv2D", "DepthwiseConv2dNative", "MaxPool",
                     "AvgPool", "FusedBatchNorm", "BiasAdd"}


def _nchw_lowering_transpose_bytes(op: Operation) -> float:
    """The per-op lowering of an NCHW image op transposes its data input
    to NHWC and its primary output back (ops/nn_ops.py) — two
    read+write pairs the graph never shows as nodes. Charging them here
    makes the layout pass's win measurable: after the rewrite the
    conversions are explicit Transpose nodes (mostly cancelled), and
    converted NHWC ops pay nothing."""
    if op.type not in _NCHW_PENALTY_OPS \
            or op.attrs.get("data_format") != "NCHW":
        return 0.0
    b = 0.0
    if op.inputs:
        b += 2.0 * _tensor_bytes(op.inputs[0])
    if op.outputs:
        b += 2.0 * _tensor_bytes(op.outputs[0])
    return b


def _op_bytes_dispatch(op: Operation, fn_depth: int = 0) -> float:
    """Per-op bytes with the special cases routed: gradient slices,
    free ops, function ops (cost attributed into their bodies), and the
    hidden NCHW lowering transposes."""
    if op.type == "SymbolicGradient":
        return _symbolic_gradient_bytes(op)
    if op.type in ("FusedAdamUpdate", "FusedMomentumUpdate"):
        # inputs (grads + scalar hypers) move once, plus the
        # store-resident state the op reads AND writes in place:
        # m/v/param for Adam (6 streams over n), accumulator/param for
        # Momentum (4 streams) — traffic the per-variable assign chains
        # previously charged across their many ops
        n = sum(_nelems(i.shape) or 0 for i in op.inputs)
        streams = 6.0 if op.type == "FusedAdamUpdate" else 4.0
        return _op_bytes(op) + streams * n * 4.0
    if op.type == "KVCacheAppend":
        # in-place scatter of B rows at one position range: the touched
        # bytes are value read + write (the output tensor is the WHOLE
        # cache only nominally — it is updated in place; the
        # default inputs+outputs accounting would charge a full cache
        # write per append and dominate every decode-step attribution)
        return 2.0 * sum(_tensor_bytes(t) for t in op.inputs)
    if op.type == "KVCachePageCopy":
        # CoW: M whole rows read + written in place (same donation
        # argument as the append) — row bytes from the cache attrs,
        # never the nominal whole-cache output
        sh = op.attrs.get("shape") or []
        m = _nelems(op.inputs[0].shape) or 0
        row = 1
        for d in sh[1:]:
            row *= int(d)
        itemsize = op.outputs[0].dtype.base_dtype.size if op.outputs else 4
        return 2.0 * m * row * itemsize
    if op.type == "EmbeddingLookupFused":
        # the default inputs+outputs accounting would charge reading
        # the ENTIRE table per lookup; the fused route touches ids +
        # the gathered rows (read at the owner, written twice through
        # the send/receive buffers)
        ids_b = _tensor_bytes(op.inputs[1]) if len(op.inputs) > 1 else 0.0
        out_b = _tensor_bytes(op.outputs[0]) if op.outputs else 0.0
        return ids_b + 2.0 * out_b
    if op.type == "EmbeddingScatterAddGrad":
        # cotangents read twice (segment_sum + scatter) plus the dense
        # per-shard gradient buffer write (the output IS materialized —
        # unlike the lookup, the table-shaped write is real)
        grad_b = _tensor_bytes(op.inputs[1]) if len(op.inputs) > 1 else 0.0
        out_b = _tensor_bytes(op.outputs[0]) if op.outputs else 0.0
        return 2.0 * grad_b + out_b
    fc = _function_op_cost(op, 0, fn_depth)
    if fc is not None:
        return fc[1]
    if op.type in _FREE_OPS:
        return 0.0
    return _op_bytes(op) + _nchw_lowering_transpose_bytes(op)


# ---------------------------------------------------------------------------
# cost attribution into FuncGraph bodies (cond/while/scan/defun): the
# flat walk used to price a While at its output-elems — a conv chain
# executing 100 iterations inside the body was invisible. Bodies are
# priced by recursing over their pruned op lists; _FUNCTION_OPS
# says where the bodies live, how often they run (mode/trip), and how
# branches combine.
# ---------------------------------------------------------------------------

def _leading_dim(t):
    """Static trip count of a scan/map: the elems' leading dim."""
    sh = t.shape
    return sh[0].value if sh.rank else None


# op type -> (mode, body attrs, static trip count or None): the JAX
# package's registrations (ops/functional_ops.py:105-258,
# ops/control_flow_ops.py:221-422, framework/function.py:39 and :184)
_FUNCTION_OPS = {
    "GraphFunctionCall": ("call", ("func_graph",), None),
    "RecomputeGradCall": ("call", ("func_graph",), None),
    "MapFn": ("loop", ("body",),
              lambda a, inputs: _leading_dim(inputs[0]) if inputs else None),
    "Scan": ("loop", ("body",),
             lambda a, inputs: (_leading_dim(inputs[a["n_carry"]])
                                if len(inputs) > a["n_carry"] else None)),
    "Foldl": ("loop", ("body",),
              lambda a, inputs: (_leading_dim(inputs[a["n_carry"]])
                                 if len(inputs) > a["n_carry"] else None)),
    "Cond": ("branch", ("true_graph", "false_graph"), None),
    "While": ("loop", ("cond_graph", "body_graph"),
              lambda a, inputs: a.get("max_iterations")),
}


def _function_body_cost(fg, grad_depth: int,
                        fn_depth: int) -> Tuple[float, float]:
    fed = set(fg.inputs) | {inner for _, inner in fg.captures}
    try:
        plan = lowering_mod.prune([t.op for t in fg.outputs], fed,
                                  follow_shape_only=True)
    except Exception:
        return 0.0, 0.0
    flops = 0.0
    byts = 0.0
    for p in plan:
        flops += _op_flops(p, grad_depth, fn_depth)
        byts += _op_bytes_dispatch(p, fn_depth)
    return flops, byts


# (flops, bytes) memo: pricing a body means pruning and walking it, and
# BOTH _op_flops and _op_bytes_dispatch route function ops here — without
# the memo every nesting level would be walked twice per query. Keyed by
# the op plus the body identities (a body swapped in place must
# invalidate).
_function_cost_memo = None  # created lazily: WeakKeyDictionary


def _function_op_cost(op: Operation, grad_depth: int,
                      fn_depth: int = 0) -> Optional[Tuple[float, float]]:
    """(flops, bytes) for a function op, or None when ``op`` carries no
    FuncGraph bodies. Loops multiply by the static trip count
    when one is known (While max_iterations, scan/map leading dim);
    branches cost as the heavier side (one branch executes).
    ``fn_depth`` counts BODY nesting only — it must stay separate from
    ``grad_depth`` (the grad-of-grad cutoff) or a gradient inside a
    loop body would be priced at 0."""
    spec = _FUNCTION_OPS.get(op.type)
    if spec is None:
        return None
    mode, attrs, trip_fn = spec
    if fn_depth > 4:  # deeply nested bodies: stop the recursion
        return 0.0, 0.0
    fgs = []
    for a in attrs:
        fg = op.attrs.get(a)
        if fg is None or not hasattr(fg, "outputs"):
            return None
        fgs.append(fg)
    if not fgs:
        return None

    import weakref

    global _function_cost_memo
    if _function_cost_memo is None:
        _function_cost_memo = weakref.WeakKeyDictionary()
    memo_key = (grad_depth, fn_depth)
    per_op = _function_cost_memo.setdefault(op, {})
    hit = per_op.get(memo_key)
    if hit is not None:
        # validate the bodies are the SAME objects (weakrefs, so a
        # freed FuncGraph whose id is recycled can never alias)
        refs, result = hit
        if len(refs) == len(fgs) and all(
                r() is fg for r, fg in zip(refs, fgs)):
            return result

    costs = [_function_body_cost(fg, grad_depth, fn_depth + 1)
             for fg in fgs]
    boundary = _op_bytes(op)  # the op's own operands/results move once
    if mode == "branch":
        result = (max(c[0] for c in costs),
                  max(c[1] for c in costs) + boundary)
    else:
        flops = sum(c[0] for c in costs)
        byts = sum(c[1] for c in costs)
        trip = 1
        if mode == "loop":
            t = trip_fn(op.attrs, op.inputs)
            # an unbounded While (t None) prices one iteration — a
            # documented lower bound; a KNOWN trip of 0 stays 0
            trip = int(t) if t is not None else 1
        result = (trip * flops, trip * byts + boundary)
    per_op[memo_key] = (tuple(weakref.ref(fg) for fg in fgs), result)
    return result


def _symbolic_gradient_bytes(op: Operation) -> float:
    """Backward traffic ≈ the forward slice's own traffic (each op's
    backward re-reads its operands/residuals and writes cotangents of the
    same sizes), plus this node's gradient outputs."""
    n_ys = op.attrs.get("n_ys", 1)
    n_xs = op.attrs.get("n_xs", 1)
    ys = list(op.inputs[:n_ys])
    xs = list(op.inputs[n_ys:n_ys + n_xs])
    try:
        path_ops, _ = lowering_mod.ancestors_between(
            xs, ys, follow_shape_only=True)
    except Exception:
        return 0.0
    fwd = sum(_op_bytes(p) for p in path_ops if p.type not in _FREE_OPS)
    outs = sum(_tensor_bytes(t) for t in op.outputs)
    return fwd + outs


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

@dataclass
class OpCost:
    name: str
    op_type: str
    flops: float
    bytes: float


@dataclass
class CostEstimate:
    """(ref: grappler/costs/cost_estimator.h ``struct Costs``)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_bytes: float = 0.0
    resident_bytes: float = 0.0     # variables (persistent_memory)
    per_op: List[OpCost] = field(default_factory=list)

    def seconds_on(self, peak_flops: float, peak_bw: float,
                   dispatch_floor_s: Optional[float] = None) -> float:
        """Roofline projection: max of compute time, HBM time, and the
        host-dispatch floor. A tiny program's roofline time (~µs) is
        unreachable — every step pays Python dispatch + device launch +
        result sync, so the prediction is floored at
        HOST_DISPATCH_FLOOR_S before being compared with measurements.
        Pass ``dispatch_floor_s=0`` for the raw roofline number."""
        if dispatch_floor_s is None:
            dispatch_floor_s = HOST_DISPATCH_FLOOR_S
        return max(self.flops / max(peak_flops, 1.0),
                   self.bytes_accessed / max(peak_bw, 1.0),
                   float(dispatch_floor_s))

    def summary(self) -> Dict[str, float]:
        return {
            "predicted_tflops": round(self.flops / 1e12, 4),
            "predicted_gbytes": round(self.bytes_accessed / 1e9, 3),
            "predicted_peak_gb": round(self.peak_bytes / 1e9, 3),
        }


def estimate(fetches, feeds: Sequence[Tensor] = (),
             graph: Optional[ops_mod.Graph] = None,
             top_k: int = 0,
             shard_factor_fn=None) -> CostEstimate:
    """Predict FLOPs / bytes / peak live memory of running ``fetches``.

    ``fetches``: tensors/ops (same things you pass to Session.run).
    ``feeds``: placeholders that will be fed (pruning boundary).
    ``shard_factor_fn``: optional fn(tensor) -> int dividing that
    tensor's RESIDENT/LIVE bytes — the sharding analyzer passes the
    per-tensor mesh shard factor so ``peak_bytes``/``resident_bytes``
    become PER-SHARD HBM (flops/bytes_accessed stay global: the whole
    mesh still does the whole step's work).
    """
    tensors: List[Tensor] = []
    target_ops: List[Operation] = []
    items = fetches if isinstance(fetches, (list, tuple)) else [fetches]
    for f in items:
        if isinstance(f, Operation):
            target_ops.append(f)
        elif isinstance(f, Tensor):
            tensors.append(f)
            target_ops.append(f.op)
        elif hasattr(f, "_ref"):  # Variable
            target_ops.append(f._ref.op)
        else:
            raise TypeError(f"estimate: cannot cost {f!r}")
    fed = set(feeds)
    plan = lowering_mod.prune(target_ops, fed_tensors=fed,
                              follow_shape_only=True)

    def _live_bytes(t):
        b = _tensor_bytes(t)
        if shard_factor_fn is not None and b:
            try:
                f = int(shard_factor_fn(t) or 1)
            except Exception:
                f = 1
            if f > 1:
                b = b / f
        return b

    est = CostEstimate()
    # resident state: every variable in the slice stays in HBM all step
    seen_vars = set()
    for op in plan:
        if op.type in ("VariableV2", "ReadVariable"):
            vn = op.attrs.get("var_name")
            if vn not in seen_vars:
                seen_vars.add(vn)
                est.resident_bytes += sum(_live_bytes(t)
                                          for t in op.outputs[:1])

    # liveness sweep for peak memory: feed buffers are live from step
    # start; a tensor is freed at its last use only if something actually
    # allocated it (fed or produced in-plan — a pruned producer's tensor
    # must not drive `live` below baseline)
    last_use: Dict[Tensor, int] = {}
    for idx, op in enumerate(plan):
        for t in op.inputs:
            last_use[t] = idx
    for t in tensors:  # fetched tensors live to the end
        last_use[t] = len(plan)
    allocated = set(fed)
    live = est.resident_bytes + sum(_live_bytes(t) for t in fed)
    peak = live
    frees: Dict[int, List[Tensor]] = {}
    for t, idx in last_use.items():
        frees.setdefault(idx, []).append(t)

    for idx, op in enumerate(plan):
        flops = _op_flops(op)
        byts = _op_bytes_dispatch(op)
        est.flops += flops
        est.bytes_accessed += byts
        if top_k:
            est.per_op.append(OpCost(op.name, op.type, flops, byts))
        # allocate outputs
        if op.type not in ("VariableV2", "ReadVariable"):
            for t in op.outputs:
                allocated.add(t)
            live += sum(_live_bytes(t) for t in op.outputs)
        if op.type == "SymbolicGradient":
            # residuals of the forward slice stay live through backward
            pass  # their producers' buffers are already counted live
        peak = max(peak, live)
        for t in frees.get(idx, ()):
            if t in allocated and t.op.type not in ("VariableV2",
                                                    "ReadVariable"):
                live -= _live_bytes(t)
    est.peak_bytes = peak
    if top_k:
        est.per_op.sort(key=lambda o: -(o.flops + o.bytes))
        est.per_op = est.per_op[:top_k]
    return est


def predicted_vs_measured(fetches, feeds: Sequence[Tensor] = (),
                          measured_seconds: Optional[float] = None,
                          est: Optional[CostEstimate] = None
                          ) -> Dict[str, float]:
    """Static cost-model prediction for ``fetches`` next to a measured
    step time (ref: grappler/costs/cost_estimator.h — the reference
    checks its cost model against real run stats the same way).

    Returns predicted FLOPs/bytes/peak-memory, the roofline-projected
    step seconds for the attached chip, and — when ``measured_seconds``
    is given — measured/predicted, where >>1 means the program is
    leaving roofline performance on the table (or the model missed
    traffic). Pass a precomputed ``est`` to skip the graph
    walk (the prediction is a pure function of graph + fetches, so
    periodic reporters cache it)."""
    from ..utils import perf

    if est is None:
        est = estimate(fetches, feeds=feeds)
    peak_flops, peak_bw = perf.chip_spec()
    out = dict(est.summary())
    pred_s = est.seconds_on(peak_flops, peak_bw)
    out["predicted_sec_per_step"] = float(f"{pred_s:.4g}")
    if pred_s <= HOST_DISPATCH_FLOOR_S:
        # the roofline time is below the host-dispatch floor: the row is
        # dispatch-bound and measured/predicted compares against the
        # floor, not the (unreachable) roofline
        out["dispatch_floor_bound"] = True
    if measured_seconds:
        out["measured_sec_per_step"] = float(f"{measured_seconds:.4g}")
        out["measured_over_predicted"] = round(
            float(measured_seconds) / max(pred_s, 1e-12), 3)
        # model FLOPs utilization from the unrounded estimate (the
        # summary()'s tflops rounds small programs to 0)
        out["mfu"] = round(
            perf.mfu(est.flops, float(measured_seconds)), 6)
    return out


# ---------------------------------------------------------------------------
# planning helpers (the consumers grappler's cost model exists for)
# ---------------------------------------------------------------------------

def suggest_microbatches(per_stage_activation_bytes: float,
                         n_stages: int,
                         hbm_budget_bytes: float,
                         schedule: str = "1f1b") -> int:
    """Smallest power-of-two microbatch count whose in-flight activation
    footprint fits the budget. Under 1F1B, stage i holds at most
    ``min(n_microbatches, n_stages - i)`` activation stashes; GPipe holds
    all of them (ref: GPipe / PipeDream-1F1B papers; grappler's
    graph_memory.cc plays this role for the reference's schedulers)."""
    if per_stage_activation_bytes <= 0 or hbm_budget_bytes <= 0:
        return 1
    for m in (1, 2, 4, 8, 16, 32, 64, 128):
        stash = (n_stages if schedule == "1f1b"
                 else m)  # gpipe stashes every microbatch
        per_micro = per_stage_activation_bytes / m
        if per_micro * stash <= hbm_budget_bytes:
            return m
    return 256


def suggest_remat(forward_activation_bytes: float,
                  hbm_budget_bytes: float,
                  forward_flops: float = 0.0,
                  peak_flops: float = 1.0,
                  peak_bw: float = 1.0) -> bool:
    """Remat when the forward residuals alone would blow the budget, or
    when the step is bandwidth-bound enough that recomputing is cheaper
    than re-reading (arithmetic intensity below the chip's balance
    point). Returns True = recompute per block."""
    if forward_activation_bytes > 0.7 * hbm_budget_bytes:
        return True
    if forward_flops > 0 and peak_bw > 0:
        intensity = forward_flops / max(forward_activation_bytes, 1.0)
        balance = peak_flops / peak_bw
        # deeply bandwidth-bound: trade FLOPs for bytes
        return intensity < 0.25 * balance
    return False


def transformer_activation_bytes(batch, seq_len, hidden, n_layers,
                                 dtype_bytes=2):
    """Order-of-magnitude forward-residual footprint of a transformer
    encoder stack: per layer, the backward consumes roughly qkv (3BSH) +
    attention out (BSH) + mlp hidden (4BSH) + mlp out (BSH) + two
    norms/residual reads (~4BSH) ~= 13 BSH."""
    return 13.0 * batch * seq_len * hidden * n_layers * dtype_bytes


def transformer_forward_flops(batch, seq_len, hidden, n_layers,
                              d_ff=None):
    """Order-of-magnitude forward FLOPs of a transformer stack (for the
    remat intensity heuristic, not the MFU accounting): per layer,
    qkv/out projections (2*4H^2 per token), the mlp (2*2*H*d_ff), and
    the S-dependent attention matmuls (2*2*S*H)."""
    d_ff = d_ff if d_ff is not None else 4 * hidden
    per_token = 2.0 * (4 * hidden * hidden + 2 * hidden * d_ff
                       + 2 * seq_len * hidden)
    return batch * seq_len * n_layers * per_token


def resnet_activation_bytes(batch, image_size, dtype_bytes=2, depth=50):
    """Order-of-magnitude forward-residual footprint of a ResNet-v1.5:
    per stage, blocks save ~3 conv outputs + BN/relu reads (~5x the
    stage's B*H*W*C feature map per block)."""
    stages = [(image_size // 4, 256, 3), (image_size // 8, 512, 4),
              (image_size // 16, 1024, 6), (image_size // 32, 2048, 3)]
    if depth >= 101:
        stages[2] = (image_size // 16, 1024, 23)
    total = 0.0
    for hw, c, blocks in stages:
        total += 5.0 * blocks * batch * hw * hw * c
    return total * dtype_bytes


def mesh_shard_factor(axes):
    """Product of the active mesh's sizes along ``axes`` (1 when no mesh
    or the axis is absent) — divides a GLOBAL activation estimate down
    to per-chip before comparing against one chip's HBM."""
    from ..parallel import mesh as mesh_mod

    m = mesh_mod.current_mesh()
    if m is None:
        return 1
    n = 1
    for ax in axes:
        if ax and ax in m.axis_names:
            n *= m.axis_size(ax)
    return n


def resolve_recompute(recompute, forward_activation_bytes,
                      forward_flops=0.0, device=None):
    """Resolve a model's ``recompute`` flag: ``"auto"`` asks
    ``suggest_remat`` against the ATTACHED chip's HBM capacity and
    balance point (the grappler memory-optimizer role, decided from the
    static estimate instead of a post-hoc OOM); True/False pass
    through. ``forward_activation_bytes`` must be PER-CHIP (divide a
    global estimate by ``mesh_shard_factor`` over the sharded axes)."""
    if recompute != "auto":
        return bool(recompute)
    from ..utils import perf

    peak_flops, peak_bw = perf.chip_spec(device)
    hbm = perf.chip_hbm_bytes(device)
    # params + optimizer state + workspace share the budget; activations
    # may claim roughly half of HBM before remat becomes the default
    return suggest_remat(forward_activation_bytes, 0.5 * hbm,
                         forward_flops, peak_flops, peak_bw)
