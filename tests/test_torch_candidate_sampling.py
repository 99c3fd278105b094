"""The port's candidate samplers and sampled losses against the JAX
package's, on the CPU.

Held: ``log_uniform_candidate_sampler`` and ``uniform_candidate_sampler``
(unique: Gumbel top-k over the whole range; not unique: the inverse-CDF
draw and ``randint``) draw the JAX package's ids in five runs of a
Session, runs 2-5 captured (the CPU replay reads the device key buffer
the Session refills), and the expected counts within 1e-6; a replay
whose key buffer is not refilled repeats the last draw;
``compute_accidental_hits`` exact; ``SigmoidCrossEntropyWithLogits`` and
``weighted_cross_entropy_with_logits`` and their gradients (a tie at
logit 0 included), ``nce_loss`` and ``sampled_softmax_loss`` with their
weight gradients, within 1e-6.
"""

import numpy as np
import pytest

import simple_tensorflow_tpu as jstf
import simple_tensorflow_tpu_torch as pstf
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": jstf, "port": pstf}
RUNS = 5
TOL = 1e-6


def _session(stf, g):
    return stf.Session(graph=g,
                       config=stf.ConfigProto(device_count={"GPU": 0}))


def _draws(name, sampler, unique, range_max, seed):
    stf = PKGS[name]
    labels = np.array([[0], [3], [49999 % range_max], [7]], np.int64)
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(seed)
        out = getattr(stf.nn, sampler)(
            true_classes=stf.constant(labels), num_true=1, num_sampled=64,
            unique=unique, range_max=range_max)
        with _session(stf, g) as s:
            runs = [s.run(list(out)) for _ in range(RUNS)]
            stale = None
            if name == "port":
                assert s.captures == 1
                s._refresh_keys = False
                stale = s.run(list(out))
    return runs, stale


@pytest.mark.parametrize("sampler,unique,range_max,seed", [
    ("log_uniform_candidate_sampler", True, 50000, 1),
    ("log_uniform_candidate_sampler", True, 50000, 7),
    ("log_uniform_candidate_sampler", True, 1000, 1),
    ("log_uniform_candidate_sampler", False, 50000, 1),
    ("uniform_candidate_sampler", True, 50000, 7),
])
def test_sampler_draws_the_jax_ids(sampler, unique, range_max, seed):
    j, _ = _draws("jax", sampler, unique, range_max, seed)
    p, stale = _draws("port", sampler, unique, range_max, seed)
    for (jid, jt, js), (pid, pt, ps) in zip(j, p):
        np.testing.assert_array_equal(pid, jid)
        assert pid.dtype == np.int32 and pid.shape == (64,)
        np.testing.assert_allclose(pt, jt, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ps, js, rtol=TOL, atol=TOL)
        if unique:
            assert len(np.unique(pid)) == 64
    # every run draws anew; a replay without the key refill repeats the
    # last run's key
    assert all(not np.array_equal(a[0], b[0]) for a, b in zip(p, p[1:]))
    np.testing.assert_array_equal(stale[0], p[-1][0])


def test_uniform_sampler_with_replacement_draws_on_the_host():
    """The uniform draw with replacement is ``randint`` of the op's key on
    the host: the JAX ids eagerly; a captured step refuses the host key."""
    got = {}
    for name, stf in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            stf.set_random_seed(3)
            out = stf.nn.uniform_candidate_sampler(
                true_classes=stf.constant(np.array([[1], [2]], np.int64)),
                num_true=1, num_sampled=16, unique=False, range_max=100)
            with _session(stf, g) as s:
                if name == "port":
                    s._capture = False
                got[name] = [s.run(list(out)) for _ in range(2)]
    for j, p in zip(got["jax"], got["port"]):
        for a, b in zip(j, p):
            np.testing.assert_allclose(b, a, rtol=TOL)
    from simple_tensorflow_tpu_torch.framework import errors

    g = pstf.Graph()
    with g.as_default():
        out = pstf.nn.uniform_candidate_sampler(
            true_classes=pstf.constant(np.array([[1]], np.int64)),
            num_true=1, num_sampled=4, unique=False, range_max=100)
        with _session(pstf, g) as s:
            s.run(out[0])
            with pytest.raises(errors.InvalidArgumentError, match="host key"):
                s.run(out[0])


def test_compute_accidental_hits_matches_jax():
    true = np.array([[1, 5], [2, 9], [4, 4]], np.int64)
    sampled = np.array([5, 2, 7, 4], np.int64)
    got = {}
    for name, stf in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            out = stf.nn.compute_accidental_hits(
                stf.constant(true), stf.constant(sampled), num_true=2)
            with _session(stf, g) as s:
                got[name] = s.run(list(out))
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(b, a)
    assert (got["port"][2] != 0).sum() == 3


def _xent_graph(stf, fn):
    logits = stf.placeholder(stf.float32, [3, 5], "logits")
    labels = stf.placeholder(stf.float32, [3, 5], "labels")
    out = fn(stf, labels, logits)
    return logits, labels, out, stf.gradients(out, [logits])[0]


@pytest.mark.parametrize("fn", [
    lambda stf, y, x: stf.nn.sigmoid_cross_entropy_with_logits(
        labels=y, logits=x),
    lambda stf, y, x: stf.nn.weighted_cross_entropy_with_logits(
        y, x, pos_weight=2.5),
], ids=["sigmoid", "weighted"])
def test_sigmoid_cross_entropy_matches_jax(fn):
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(3, 5)).astype(np.float32)
    x[0, :2] = 0.0   # a tie of max(x, 0): its gradient split in halves
    x[1, 0] = 30.0
    y = rng.rand(3, 5).astype(np.float32)
    got = {}
    for name, stf in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            lt, yt, out, grad = _xent_graph(stf, fn)
            with _session(stf, g) as s:
                got[name] = s.run([out, grad], {lt: x, yt: y})
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("loss", ["nce_loss", "sampled_softmax_loss"])
def test_sampled_losses_match_jax(loss):
    rng = np.random.RandomState(2)
    vocab, dim, b = 300, 8, 6
    w0 = (0.3 * rng.randn(vocab, dim)).astype(np.float32)
    b0 = (0.1 * rng.randn(vocab)).astype(np.float32)
    x = rng.randn(b, dim).astype(np.float32)
    y = rng.randint(0, vocab, (b, 1)).astype(np.int32)
    got = {}
    for name, stf in PKGS.items():
        g = stf.Graph()
        with g.as_default():
            stf.set_random_seed(5)
            w = stf.Variable(w0, name="w")
            bias = stf.Variable(b0, name="b")
            xt = stf.constant(x)
            out = getattr(stf.nn, loss)(
                weights=w, biases=bias, labels=stf.constant(y), inputs=xt,
                num_sampled=10, num_classes=vocab)
            total = stf.reduce_sum(out)
            grads = stf.gradients(total, [w, bias, xt])
            init = stf.global_variables_initializer()
            with _session(stf, g) as s:
                s.run(init)
                got[name] = [s.run([out] + grads) for _ in range(2)]
    for j, p in zip(got["jax"], got["port"]):
        for a, b_ in zip(j, p):
            np.testing.assert_allclose(np.asarray(b_), np.asarray(a),
                                       rtol=TOL, atol=TOL)
