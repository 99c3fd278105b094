"""Graph functions of the port (``framework/function.py``: ``Defun``,
``recompute_grad``; ``FuncGraph`` in ``framework/graph.py``) against the
JAX package's, on the CPU.

- The same user code builds the same ``FuncGraph`` bodies in both
  packages: op types, names (``arg0``, ``captured_<i>``, body ops named
  within the body), inputs, captures (outer and inner names) and the
  call ops in the outer graph.
- ``Defun`` called at two signatures (two traces, one per signature) with
  a captured variable: values within 1e-6 of JAX's, gradients within
  ``GRAD_TOL`` (5e-6: the host spread measured below).
- ``recompute_grad`` over a body with a captured variable: the value
  within 1e-6 of JAX's and the gradients of the input and the variable
  within ``GRAD_TOL``, and equal to the same body built inline in the
  port (the same arithmetic).
- The recompute body keeps for the backward only the call's inputs and
  captures: ``torch.autograd.graph.saved_tensors_hooks`` around the call's
  forward counts exactly those tensors (the same graph under
  ``without_rematerialization()`` saves the body's intermediates).
- A recompute step leaves no reference cycle: with the collector off,
  no run's context outlives the run (a cycle through the autograd node's
  body would hold the step's whole graph, a few GiB at BERT-base's size,
  until the collector ran).
- ``uses_rng`` through a body: a run whose plan calls a body with a
  dropout advances the session's run counter, one whose body draws
  nothing does not, in both packages; and a dropout in a recompute body
  draws JAX's mask (its op named within the body).
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu_torch.framework import function as pfunction
from simple_tensorflow_tpu_torch.framework import lowering as plowering
from simple_tensorflow_tpu_torch.framework import op_registry

PKGS = {"jax": jstf, "port": pstf}
TOL = 1e-6
# the gradients against JAX's: the JAX reference's own gradients of this
# graph move by up to 1.67e-6 (max |grad| 7.6) between two host code paths
# of one AVX-512 box (ONEDNN_MAX_CPU_ISA unset and AVX2), and each package
# sits up to 2.5e-6 from a float64 evaluation (JAX 1.73e-6 / 2.47e-6 on the
# input and weight gradients, the port 1.96e-6 / 1.41e-6: tanh and matmul
# round differently in XLA and PyTorch), so the two differ by up to their
# sum (3.46e-6 measured): 3x the reference's own spread
GRAD_TOL = 5e-6


def _session(stf):
    return stf.Session(config=stf.ConfigProto(device_count={"GPU": 0}))


def _values():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(3, 4).astype(np.float32),
            "v": rng.randn(5).astype(np.float32),
            "w": rng.randn(4, 4).astype(np.float32)}


def _build(stf):
    """A Defun called at two signatures, a recompute_grad call, the same
    body inline, and the gradients of all of them, in one graph."""
    v = _values()
    g = stf.Graph()
    with g.as_default():
        x = stf.placeholder(stf.float32, [3, 4], name="x")
        vec = stf.placeholder(stf.float32, [5], name="vec")
        w = stf.Variable(v["w"], name="w")
        scale = stf.constant(1.5, name="scale")

        @stf.Defun(stf.float32)
        def scaled_tanh(t):
            return stf.tanh(t) * scale

        def block(h):
            with stf.variable_scope("block"):
                y = stf.tanh(stf.matmul(h, w))
                return y * y + h

        d1 = scaled_tanh(x)
        d2 = scaled_tanh(vec)
        d3 = scaled_tanh(x * 2.0)      # the first signature again
        r = stf.recompute_grad(block, name="rc")(x)
        inline = block(x)
        loss_r = stf.reduce_sum(r * r)
        loss_i = stf.reduce_sum(inline * inline)
        loss_d = stf.reduce_sum(d1 * d3) + stf.reduce_sum(d2)
        grads = {"rc": stf.gradients(loss_r, [x, w]),
                 "inline": stf.gradients(loss_i, [x, w]),
                 "defun": stf.gradients(loss_d, [x, vec])}
        init = stf.global_variables_initializer()
    feeds = {x: v["x"], vec: v["v"]}
    return g, init, feeds, {"d1": d1, "d2": d2, "d3": d3, "rc": r,
                            "inline": inline, "grads": grads}


def _run(stf):
    g, init, feeds, fetch = _build(stf)
    with g.as_default(), _session(stf) as s:
        s.run(init)
        return s.run(fetch, feeds), g


@pytest.fixture(scope="module")
def runs():
    return {name: _run(stf) for name, stf in PKGS.items()}


def _signature(g):
    out = []
    for op in g.get_operations():
        out.append((op.type, op.name, [t.name for t in op.inputs],
                    [(str(t.shape), t.dtype.name) for t in op.outputs]))
        fg = op.attrs.get("func_graph")
        if fg is not None:
            out.append((fg.func_name,
                        [(o.type, o.name, [t.name for t in o.inputs])
                         for o in fg.get_operations()],
                        [(a.name, b.name) for a, b in fg.captures],
                        [t.name for t in fg.inputs],
                        [t.name for t in fg.outputs]))
    return out


def test_func_graphs_match_jax(runs):
    jg, pg = runs["jax"][1], runs["port"][1]
    assert _signature(pg) == _signature(jg)
    calls = [op for op in pg.get_operations()
             if op.type in pfunction.CALL_OPS]
    assert [op.type for op in calls] == ["GraphFunctionCall"] * 3 + [
        "RecomputeGradCall"]
    # two signatures, two traces; the third call reuses the first
    assert calls[0].attrs["func_graph"] is calls[2].attrs["func_graph"]
    assert calls[0].attrs["func_graph"] is not calls[1].attrs["func_graph"]
    body = calls[3].attrs["func_graph"]
    names = [o.name for o in body.get_operations()]
    assert names[0] == "arg0" and "block/captured_0" in names
    assert [outer.name for outer, _ in body.captures] == ["w:0"]


def test_defun_and_recompute_match_jax(runs):
    j, p = runs["jax"][0], runs["port"][0]
    for k in ("d1", "d2", "d3", "rc", "inline"):
        np.testing.assert_allclose(p[k], j[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    for k in ("rc", "inline", "defun"):
        for a, b in zip(p["grads"][k], j["grads"][k]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=GRAD_TOL,
                                       err_msg=k)


def test_recompute_equals_the_inline_body(runs):
    p = runs["port"][0]
    np.testing.assert_array_equal(p["rc"], p["inline"])
    for a, b in zip(p["grads"]["rc"], p["grads"]["inline"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rematerialize", [True, False])
def test_recompute_body_saves_only_its_inputs_and_captures(
        monkeypatch, rematerialize):
    g, init, feeds, fetch = _build(pstf)
    opdef = op_registry.get("RecomputeGradCall")
    lower = opdef.lower
    saved, inputs = [], []

    def counted(ctx, op, vals):
        inputs.extend(v.data_ptr() for v in vals)
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.data_ptr()) or t, lambda t: t):
            return lower(ctx, op, vals)

    monkeypatch.setattr(opdef, "lower", counted)
    mode = contextlib.nullcontext() if rematerialize \
        else pfunction.without_rematerialization()
    with g.as_default(), _session(pstf) as s, mode:
        s.run(init)
        got = s.run(fetch["grads"]["rc"], feeds)
    assert len(inputs) == 2      # x and the captured w
    if rematerialize:
        assert sorted(saved) == sorted(inputs)
    else:
        # the body's matmul, tanh and products keep their operands
        assert len(saved) > len(inputs)
    np.testing.assert_allclose(got[1], _run(pstf)[0]["grads"]["rc"][1],
                               rtol=TOL, atol=TOL)


def test_a_recompute_step_leaves_no_reference_cycle():
    g, init, feeds, fetch = _build(pstf)
    with g.as_default(), _session(pstf) as s:
        s.run(init)
        gc.collect()
        gc.disable()
        try:
            # the call's output, fetched, stays in the run's values
            s.run([fetch["rc"], fetch["grads"]["rc"]], feeds)
            left = [o for o in gc.get_objects()
                    if type(o) is plowering.LoweringContext]
        finally:
            gc.enable()
    assert left == []


def _rng_graph(stf, with_dropout, recompute):
    g = stf.Graph()
    with g.as_default():
        x = stf.placeholder(stf.float32, [4, 8], name="x")

        def body(h):
            h = stf.tanh(h)
            return stf.nn.dropout(h, keep_prob=0.5) if with_dropout else h

        if recompute:
            y = stf.recompute_grad(body, name="rc")(x)
        else:
            y = stf.Defun(stf.float32)(body)(x)
    return g, x, y


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("with_dropout", [False, True])
def test_a_body_that_draws_advances_the_run_counter(with_dropout,
                                                    recompute):
    x_val = np.random.RandomState(1).rand(4, 8).astype(np.float32) + 0.5
    outs = {}
    for name, stf in PKGS.items():
        g, x, y = _rng_graph(stf, with_dropout, recompute)
        with g.as_default(), _session(stf) as s:
            vals = [s.run(y, {x: x_val}) for _ in range(2)]
            outs[name] = (vals, s._run_counter)
    (jv, jc), (pv, pc) = outs["jax"], outs["port"]
    assert pc == jc == (2 if with_dropout else 0)
    for a, b in zip(pv, jv):
        if with_dropout:
            np.testing.assert_array_equal(a == 0, b == 0)   # JAX's masks
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    if with_dropout:
        assert not np.array_equal(pv[0] == 0, pv[1] == 0)
