"""The port's TF-1 front end (``Graph``, op registry, ``Session.run``)
against the JAX package's on the same user code, on the CPU
(``ConfigProto(device_count={"GPU": 0})`` in both packages).

Each test builds the same graph with both packages' ``stf`` API: partial
shape inference (an unknown batch dim), fetch structures and fetch by
name, the errors of a wrong-shape feed, an uninitialized variable, a
closed session and a mixed-dtype add, the 64-bit rule (int64 computes and
fetches as int32), plan-cache hits, the RNG consume rule over runs that
mix RNG and non-RNG plans, ``random_uniform`` bit for bit (seeded and
unseeded), the gradient of a variable read twice, a run that fails
committing nothing, and the variable-hazard detector's modes (``raise``
refusing an unordered read and write, ``warn``, ``off``, ``auto_deps``,
WAW pairs left as warnings). Values are exact unless a tolerance is
stated.
"""

import collections

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from simple_tensorflow_tpu_torch.framework import errors as perrors
from simple_tensorflow_tpu.framework import errors as jerrors

PKGS = {"jax": jstf, "port": pstf}
ERRORS = {"jax": jerrors, "port": perrors}


def cpu_session(stf, graph=None, **kw):
    return stf.Session(graph=graph, config=stf.ConfigProto(
        device_count={"GPU": 0}, **kw))


def in_both(build):
    """``build(stf)`` in a fresh graph of each package:
    ``{"jax": result, "port": result}``."""
    out = {}
    for name, stf in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            out[name] = build(stf)
    return out


def _conv_graph(stf):
    x = stf.placeholder(stf.float32, [None, 28, 28, 1], name="x")
    h = stf.layers.conv2d(x, 8, 5, padding="same", activation=stf.nn.relu,
                          name="c")
    h = stf.layers.max_pooling2d(h, 2, 2, name="p")
    flat = stf.layers.flatten(h)
    logits = stf.layers.dense(flat, 10, name="fc")
    r = stf.reshape(logits, [-1, 5, 2])
    return {"x": x, "h": h, "flat": flat, "logits": logits, "r": r,
            "mean": stf.reduce_mean(r, axis=1),
            "argmax": stf.argmax(logits, 1),
            "i32": stf.argmax(logits, 1, output_type=stf.int32),
            "loss": stf.reduce_mean(logits)}


def test_partial_shape_inference_matches_jax():
    got = in_both(lambda stf: {k: (t.shape.as_list(), t.dtype.name)
                               for k, t in _conv_graph(stf).items()})
    assert got["port"] == got["jax"]
    assert got["port"]["h"][0] == [None, 14, 14, 8]
    assert got["port"]["mean"][0] == [None, 2]


def _run(stf, build, fetch, feeds=None, init=True):
    g = stf.Graph()
    with g.as_default():
        m = build(stf)
        with cpu_session(stf) as s:
            if init:
                s.run(stf.global_variables_initializer())
            return s.run(fetch(m), feeds(m) if feeds else None)


Pair = collections.namedtuple("Pair", "a b")


def test_fetch_structures_and_names_match_jax():
    x = np.random.RandomState(0).rand(3, 28, 28, 1).astype(np.float32)

    def fetch(m):
        return {"nested": [m["logits"], (m["mean"], "fc/MatMul:0")],
                "pair": Pair(m["argmax"], m["loss"]),
                "op": m["loss"].op}

    got = {name: _run(stf, _conv_graph, fetch, lambda m: {m["x"]: x})
           for name, stf in PKGS.items()}
    for name in PKGS:
        out = got[name]
        assert isinstance(out, dict) and isinstance(out["nested"], list)
        assert isinstance(out["nested"][1], tuple)
        assert isinstance(out["pair"], Pair) and out["op"] is None
    j, p = got["jax"], got["port"]
    np.testing.assert_allclose(p["nested"][0], j["nested"][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(p["nested"][1][0], j["nested"][1][0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p["nested"][1][1], j["nested"][1][1],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(p["pair"].a, j["pair"].a)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_wrong_shape_feed_raises_value_error(pkg):
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        x = stf.placeholder(stf.float32, [None, 4], name="x")
        y = stf.reduce_mean(x)
        with cpu_session(stf) as s:
            with pytest.raises(ValueError, match="Cannot feed value of "
                                                 "shape"):
                s.run(y, {x: np.zeros((2, 5), np.float32)})
            assert s.run(y, {"x:0": np.ones((2, 4))}) == 1.0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_uninitialized_variable_raises_failed_precondition(pkg):
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        v = stf.Variable(stf.zeros([3]), name="v")
        with cpu_session(stf) as s:
            with pytest.raises(ERRORS[pkg].FailedPreconditionError,
                               match="uninitialized variable 'v'"):
                s.run(v)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_closed_session_raises_runtime_error(pkg):
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        c = stf.constant(1.0)
        s = cpu_session(stf)
        assert s.run(c) == 1.0
        s.close()
        with pytest.raises(RuntimeError, match="closed Session"):
            s.run(c)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_mixed_dtype_add_raises_type_error(pkg):
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        a = stf.constant(1.0)
        b = stf.constant(1)
        with pytest.raises(TypeError, match="dtypes must match"):
            stf.add(a, b)
        with pytest.raises(TypeError, match="dtypes must match"):
            a + b  # noqa: B018


def _int64_graph(stf):
    x = stf.placeholder(stf.float32, [None, 3], name="x")
    gs = stf.train.get_or_create_global_step()
    inc = stf.assign_add(gs, 5)
    return {"x": x, "argmax": stf.argmax(x, 1),
            "cast": stf.cast(stf.argmax(x, 1, output_type=stf.int32),
                             stf.int64),
            "inc": inc, "gs": gs}


def test_int64_computes_and_fetches_as_int32_like_jax():
    x = np.array([[0.0, 2.0, 1.0], [3.0, 0.0, 1.0]], np.float32)

    def fetch(m):
        return [m["argmax"], m["cast"], m["inc"], m["gs"]]

    got = {name: _run(stf, _int64_graph, fetch, lambda m: {m["x"]: x})
           for name, stf in PKGS.items()}
    for a, b in zip(got["port"], got["jax"]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # static dtypes: inference narrows the cast's int64 as JAX's does
    assert in_both(lambda stf: [t.dtype.name for t in fetch(
        _int64_graph(stf))]) == {n: ["int32", "int32", "int64", "int64_ref"]
                                 for n in PKGS}


def test_plan_cache_hits_on_a_repeated_run():
    stf = pstf
    with stf.Graph().as_default():
        m = _conv_graph(stf)
        x = np.zeros((2, 28, 28, 1), np.float32)
        with cpu_session(stf) as s:
            s.run(stf.global_variables_initializer())
            misses = s.plan_cache_misses
            for _ in range(3):
                s.run(m["loss"], {m["x"]: x})
            assert s.plan_cache_misses == misses + 1
            assert s.plan_cache_hits == 2
            s.run([m["loss"]], {m["x"]: x})  # another fetch structure...
            s.run(m["loss"], {"x:0": x})  # ...and a feed key by name
            assert s.plan_cache_misses == misses + 1
            s.run(m["mean"], {m["x"]: x})
            assert s.plan_cache_misses == misses + 2
    # the JAX session keeps one plan per signature too
    sizes = {}
    for name, stf in PKGS.items():
        with stf.Graph().as_default():
            m = _conv_graph(stf)
            with cpu_session(stf) as s:
                s.run(stf.global_variables_initializer())
                for _ in range(3):
                    s.run(m["loss"], {m["x"]: x})
                s.run(m["mean"], {m["x"]: x})
                sizes[name] = len(s._cache)
    assert sizes["port"] == sizes["jax"] == 3


def test_values_are_dropped_after_their_last_use():
    """The run keeps an intermediate value only until its last consumer
    has run (as XLA frees a buffer), the fetches to the end; the fetched
    values and gradients are those of a run that keeps everything."""
    import torch

    from simple_tensorflow_tpu_torch.framework import lowering

    stf = pstf
    with stf.Graph().as_default():
        x = stf.placeholder(stf.float32, [3], name="x")
        w = stf.Variable(stf.constant([1.0, -2.0, 0.5]), name="w")
        a = x * w
        b = a + 1.0
        c = b * b
        loss = stf.reduce_sum(c)
        (gw,) = stf.gradients(loss, [w])
        with cpu_session(stf) as s:
            s.run(stf.global_variables_initializer())
            feed = {x: np.array([1.0, 2.0, 3.0], np.float32)}
            got = s.run([loss, gw, b], feed)
            plan = s._get_or_plan([loss, gw, b], s._normalize_feeds(feed))
            ops = plan.ops
            pos = {op: i for i, op in enumerate(ops)}
            dropped = {t: op for op, ts in plan.frees.items() for t in ts}
            assert loss not in dropped and gw not in dropped and \
                b not in dropped
            assert pos[dropped[a]] == max(pos[o] for o in a.consumers()
                                          if o in pos)
            assert pos[dropped[c]] > pos[c.op]
            ctx = s._context(plan, s._normalize_feeds(feed), None)
            with torch.enable_grad():
                lowering.execute_ops(ctx, ops, plan.frees)
            assert a not in ctx.env and c not in ctx.env
            assert loss in ctx.env and b in ctx.env
    np.testing.assert_allclose(got[0], np.sum(
        (np.array([1.0, -4.0, 1.5]) + 1.0) ** 2), rtol=1e-6)
    np.testing.assert_allclose(got[1], 2 * (np.array([2.0, -3.0, 2.5]))
                               * np.array([1.0, 2.0, 3.0]), rtol=1e-6)


def _rng_graph(stf):
    r = stf.random_uniform([4, 3], -1.0, 2.0, name="r")
    c = stf.Variable(stf.zeros([2]), name="c")
    y = stf.reduce_sum(c) + stf.constant(1.0)
    return {"r": r, "y": y}


def test_rng_consume_rule_over_a_mixed_run_sequence():
    """Only runs whose plan declares an RNG effect advance the counter:
    the draws of ``r`` interleaved with non-RNG runs are the JAX
    package's, and so is the counter after each run."""
    seq = ["y", "r", "y", "y", "r", "r", "y", "r"]
    got = {}
    for name, stf in PKGS.items():
        with stf.Graph().as_default():
            m = _rng_graph(stf)
            with cpu_session(stf) as s:
                s.run(stf.global_variables_initializer())  # draws nothing
                counters, outs = [s._run_counter], []
                for k in seq:
                    outs.append(s.run(m[k]))
                    counters.append(s._run_counter)
        got[name] = (counters, outs)
    assert got["port"][0] == got["jax"][0] == [0, 0, 1, 1, 1, 2, 3, 3, 4]
    for a, b in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [None, 11])
@pytest.mark.parametrize("bounds", [(None, None), (-0.0625, 0.0625),
                                    (-3.0, 5.5)])
def test_random_uniform_is_bit_exact_with_jax(seed, bounds):
    lo, hi = bounds

    def build(stf):
        if seed is not None:
            stf.set_random_seed(seed)
        kw = {} if lo is None else {"minval": lo, "maxval": hi}
        a = stf.random_uniform([37, 53], **kw)
        b = stf.random_uniform([5, 7, 3], seed=3, **kw)
        return [a, b]

    got = {}
    for name, stf in PKGS.items():
        with stf.Graph().as_default():
            ts = build(stf)
            with cpu_session(stf) as s:
                got[name] = [s.run(ts) for _ in range(2)]
    for (a1, b1), (a2, b2) in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)
    assert not np.array_equal(got["port"][0][0], got["port"][1][0])


def test_gradient_of_a_variable_read_twice_sums_like_jax():
    def build(stf):
        w = stf.Variable(stf.constant([[1.0, -2.0], [0.5, 3.0]]), name="w")
        x = stf.placeholder(stf.float32, [None, 2], name="x")
        y = stf.reduce_sum(stf.matmul(x, w) * stf.matmul(x, w.read_value()))
        return {"x": x, "grads": stf.gradients(y, [w, x])}

    x = np.array([[1.0, 2.0], [-1.0, 0.5], [0.25, 4.0]], np.float32)
    got = {name: _run(stf, build, lambda m: m["grads"],
                      lambda m: {m["x"]: x})
           for name, stf in PKGS.items()}
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_values_read_before_the_in_place_adam_update_keep_them():
    """The fused Adam update writes the flat parameter and slot buffers in
    place; a fetched value read before it in the run (a variable, an Adam
    slot view) keeps its contents, as in the JAX package's functional
    state. Nothing orders the slot view's read against the update, so the
    default hazard mode refuses that fetch, as the JAX package does;
    ``auto_deps`` orders the read first (program order)."""
    def build(stf):
        w = stf.Variable(stf.constant([1.0, -2.0, 3.0]), name="w")
        v = stf.Variable(stf.constant([[0.5], [0.25]]), name="v")
        loss = stf.reduce_sum(w * w) + stf.reduce_sum(v * v)
        opt = stf.train.AdamOptimizer(0.1)
        train = opt.minimize(loss)
        return w, train, opt.get_slot(w, "m")

    for name, stf in PKGS.items():
        with stf.Graph().as_default():
            w, train, m_view = build(stf)
            with cpu_session(stf) as s:
                s.run(stf.global_variables_initializer())
                with pytest.raises(ERRORS[name].InvalidArgumentError,
                                   match="WAR hazard on 'Adam/Adam/"
                                         "fused_m_g0'"):
                    s.run([m_view, w, train])
    stf = pstf
    with stf.Graph().as_default():
        w, train, m_view = build(stf)
        config = stf.ConfigProto(device_count={"GPU": 0},
                                 variable_hazard_mode="auto_deps")
        with stf.Session(config=config) as s:
            s.run(stf.global_variables_initializer())
            s.run(train)
            for _ in range(3):  # each plan: warm-up, capture, replay
                m1, w1 = s.run([m_view, w])
                got_m, got_w, _ = s.run([m_view, w, train])
                np.testing.assert_array_equal(got_m, m1)
                np.testing.assert_array_equal(got_w, w1)
                m2, w2 = s.run([m_view, w])
                assert not np.array_equal(m2, m1)
                assert not np.array_equal(w2, w1)
            # the parameters now view one flat buffer the kernel updates
            p = s._flat_groups[("w", "v")]
            assert s._variable_store.values["w"].data_ptr() == p.data_ptr()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_variable_load_and_eval_in_the_default_session(pkg):
    """TF-1's host path: ``Variable.load`` sets the store value without a
    graph op, ``eval`` runs in the default session, in both packages."""
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        v = stf.Variable(stf.zeros([2, 3]), name="v")
        y = stf.reduce_sum(v) * 2.0
        with cpu_session(stf) as s:
            s.run(stf.global_variables_initializer())
            v.load(np.arange(6, dtype=np.float32).reshape(2, 3))
            np.testing.assert_array_equal(
                v.eval(), np.arange(6, dtype=np.float32).reshape(2, 3))
            assert y.eval() == 30.0


def _fault_graph(stf):
    a = stf.Variable(1.0, name="a")
    b = stf.Variable(2.0, name="b")
    return a, b


@pytest.mark.parametrize("pkg", list(PKGS))
def test_a_run_that_fails_commits_nothing(pkg):
    """Only ``a`` is initialized: ``run(assign(a, 5) * 1 + b)`` raises on
    the uninitialized ``b`` before anything commits, so ``a`` still reads
    1.0 afterwards, as in the JAX package."""
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        a, b = _fault_graph(stf)
        y = stf.assign(a, 5.0) * 1.0 + b
        with cpu_session(stf) as s:
            s.run(a.initializer)
            with pytest.raises(ERRORS[pkg].FailedPreconditionError,
                               match="uninitialized variable 'b'"):
                s.run(y)
            assert s.run(a) == 1.0
            s.run(b.initializer)
            assert s.run(y) == 7.0 and s.run(a) == 5.0


@pytest.mark.parametrize("order", ["write_first", "read_first"])
@pytest.mark.parametrize("pkg", list(PKGS))
def test_an_unordered_read_and_write_raise_a_war_hazard(pkg, order):
    """``r = a * 1`` and ``up = assign(a, 5)`` with nothing ordering them:
    the default hazard mode refuses the plan in either fetch order, as the
    JAX package does, and nothing runs."""
    stf = PKGS[pkg]
    with stf.Graph().as_default():
        a, _ = _fault_graph(stf)
        r = a * 1.0
        up = stf.assign(a, 5.0)
        with cpu_session(stf) as s:
            s.run(a.initializer)
            with pytest.raises(ERRORS[pkg].InvalidArgumentError,
                               match="WAR hazard on 'a'"):
                s.run([up, r] if order == "write_first" else [r, up])
            assert s.run(a) == 1.0


def _hazard_runs(stf, mode):
    """Both fetch orders of the unordered pair, and two unordered
    overwrites (a WAW pair), each from a fresh session in ``mode``."""
    out = []
    with stf.Graph().as_default():
        a, _ = _fault_graph(stf)
        r = a * 1.0
        up = stf.assign(a, 5.0)
        w1 = stf.assign(a, 2.0)
        w2 = stf.assign(a, 3.0)
        for fetch in ([up, r], [r, up], [w1, w2]):
            with cpu_session(stf, variable_hazard_mode=mode) as s:
                s.run(a.initializer)
                out.append([float(v) for v in s.run(fetch)]
                           + [float(s.run(a))])
    return out


@pytest.mark.parametrize("mode", ["warn", "off", "auto_deps"])
def test_hazard_modes_match_jax(mode, caplog):
    """``warn`` and ``off`` run the pair in the plan's order, ``auto_deps``
    in program order (the read, made first, before the assign): the same
    values as the JAX package in each mode; ``warn`` logs the hazard."""
    got = {}
    for name, stf in PKGS.items():
        caplog.clear()
        got[name] = _hazard_runs(stf, mode)
        if name == "port":
            logged = [r.getMessage() for r in caplog.records]
            war = [m for m in logged if "WAR hazard on 'a'" in m]
            assert bool(war) == (mode == "warn"), logged
    assert got["port"] == got["jax"]
    if mode == "auto_deps":
        assert got["port"][0][1] == got["port"][1][0] == 1.0


def test_waw_pairs_stay_warnings_under_raise(caplog):
    """Two unordered overwrites run under the default "raise" mode, as in
    the JAX package (the last writer in plan order wins), and are logged
    as a warning."""
    got = {}
    for name, stf in PKGS.items():
        with stf.Graph().as_default():
            a, _ = _fault_graph(stf)
            w1 = stf.assign(a, 2.0)
            w2 = stf.assign(a, 3.0)
            caplog.clear()
            with cpu_session(stf) as s:
                s.run(a.initializer)
                got[name] = [float(v) for v in s.run([w1, w2])] \
                    + [float(s.run(a))]
            if name == "port":
                assert any("WAW hazard on 'a'" in r.getMessage()
                           for r in caplog.records)
    assert got["port"] == got["jax"]


def test_hazard_mode_default_and_config():
    """``set_hazard_mode`` sets the process default (``raise`` unless
    ``STF_HAZARD_MODE`` says otherwise), a ``ConfigProto`` overrides it,
    and an unknown mode is refused in both places."""
    from simple_tensorflow_tpu_torch import analysis

    assert analysis.get_hazard_mode() == "raise"
    with pytest.raises(ValueError, match="variable_hazard_mode"):
        pstf.ConfigProto(variable_hazard_mode="sometimes")
    with pytest.raises(ValueError, match="hazard mode"):
        analysis.set_hazard_mode("sometimes")
    prev = analysis.set_hazard_mode("off")
    try:
        with pstf.Graph().as_default():
            a, _ = _fault_graph(pstf)
            r = a * 1.0
            up = pstf.assign(a, 5.0)
            with cpu_session(pstf) as s:
                s.run(a.initializer)
                s.run([up, r])
            with cpu_session(pstf, variable_hazard_mode="raise") as s:
                s.run(a.initializer)
                with pytest.raises(perrors.InvalidArgumentError):
                    s.run([up, r])
    finally:
        analysis.set_hazard_mode(prev)
