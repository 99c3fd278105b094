"""Candidate samplers (ref: tensorflow/python/ops/candidate_sampling_ops.py,
core/kernels/candidate_sampler_ops.cc).

Port of ``simple_tensorflow_tpu/ops/candidate_sampling_ops.py``: the
``LogUniformCandidateSampler`` and ``UniformCandidateSampler`` ops with the
JAX op's attrs and three outputs (sampled ids, expected counts of the true
classes and of the sampled ids), ``ComputeAccidentalHits`` (:172) with its
static-shape form, and the five wrappers' signatures (the learned, fixed
and all-candidate samplers degrade to the uniform one, as there).

Like the JAX lowering (:47-110) the draw takes the op's key of the run,
here through ``LoweringContext.rng_key``: in a captured step that is the
device key buffer the Session refills before every replay, so each replay
draws new ids; the threefry bits are the JAX package's
(``framework/prng.py``).

- ``unique=True`` (what ``nce_loss`` asks for): Gumbel top-k over the
  whole range, as :82-88: ``log(prob(ids)) + gumbel`` with the noise
  drawn as ``jax.random.gumbel`` draws it (``-log(-log(u))``, ``u``
  uniform in ``[finfo.tiny, 1)``), then the ``n`` largest, descending, a
  tie to the lower index (``lax.top_k``'s order, a stable sort). The
  expected counts are ``_expected``'s ``-expm1(n * log1p(-p))`` (:39-44).
  Past ``2**25`` ids it falls back to with-replacement sampling with a
  warning, as there.
- ``unique=False``: the log-uniform draw inverts the CDF of a uniform
  draw (on the device); the uniform draw is ``randint`` of the key on the
  host (``prng.randint``), which a captured step refuses (no graph here
  draws it).
"""

from __future__ import annotations

import logging

import torch

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import prng
from ..framework import random_seed as random_seed_mod
from ..framework import tensor_shape as shape_mod

_log = logging.getLogger(__name__)

_TINY = torch.finfo(torch.float32).tiny


def _sampler_op(op_type, true_classes, num_true, num_sampled, unique,
                range_max, seed, name, extra=None):
    g = ops_mod.get_default_graph()
    graph_seed, op_seed = random_seed_mod.get_seed(seed)
    true_classes = ops_mod.convert_to_tensor(true_classes,
                                             dtype=dtypes_mod.int64)
    attrs = {"num_true": int(num_true), "num_sampled": int(num_sampled),
             "unique": bool(unique), "range_max": int(range_max),
             "seed": op_seed, "_graph_seed": graph_seed}
    attrs.update(extra or {})
    batch = true_classes.shape[0].value
    op = g.create_op(
        op_type, [true_classes], attrs=attrs, name=name or op_type,
        output_specs=[
            (shape_mod.TensorShape([num_sampled]), dtypes_mod.int64),
            (shape_mod.TensorShape([batch, num_true]), dtypes_mod.float32),
            (shape_mod.TensorShape([num_sampled]), dtypes_mod.float32)])
    return op.outputs[0], op.outputs[1], op.outputs[2]


def _expected(p, num_tries):
    """The probability that an id of probability ``p`` is drawn at least
    once in ``num_tries`` draws."""
    return -torch.expm1(num_tries * torch.log1p(-p))


def gumbel(key, n, device):
    """``jax.random.gumbel(key, (n,))`` in f32: ``-log(-log(u))`` with
    ``u`` uniform in ``[tiny, 1)`` (``u * (1 - tiny) + tiny``, which is
    ``u + tiny`` in f32)."""
    u = prng.uniform_torch(key, (n,), device)
    u = torch.clamp_min(u + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def _make_sampler(log_uniform):
    def lower(ctx, op, inputs):
        a = op.attrs
        n, rmax = a["num_sampled"], a["range_max"]
        dev = ctx.device
        # torch.full, not torch.tensor: no host copy inside a capture
        log_range = torch.log(torch.full((), rmax + 1.0, dtype=torch.float32,
                                         device=dev))
        if log_uniform:
            def prob(ids):
                idsf = ids.to(torch.float32)
                return torch.log((idsf + 2.0) / (idsf + 1.0)) / log_range
        else:
            def prob(ids):
                return torch.full(ids.shape, 1.0 / rmax, dtype=torch.float32,
                                  device=ids.device)

        unique = a["unique"]
        if unique and rmax > (1 << 25):
            _log.warning(
                "%s: unique=True with range_max=%d > 2^25 falls back to "
                "with-replacement sampling (duplicate candidates "
                "possible)", op.type, rmax)
        if unique and rmax <= (1 << 25):
            ids_all = torch.arange(rmax, dtype=torch.int32, device=dev)
            logits = torch.log(prob(ids_all)) if log_uniform else \
                torch.zeros((rmax,), dtype=torch.float32, device=dev)
            noisy = logits + gumbel(ctx.rng_key(op), rmax, dev)
            order = torch.sort(noisy, descending=True, stable=True)[1]
            sampled = order[:n].to(torch.int32)
        elif log_uniform:
            u = prng.uniform_torch(ctx.rng_key(op), (n,), dev)
            sampled = (torch.exp(u * log_range) - 1.0).to(torch.int32)
            sampled = torch.clamp(sampled, 0, rmax - 1)
        else:
            sampled = torch.as_tensor(
                prng.randint(ctx.rng_for(op), (n,), 0, rmax)).to(
                    device=dev, dtype=torch.int32)
        true_classes = inputs[0]
        if unique:
            true_exp = _expected(prob(true_classes), n)
            samp_exp = _expected(prob(sampled), n)
        else:
            true_exp = prob(true_classes) * n
            samp_exp = prob(sampled) * n
        return [sampled, true_exp.to(torch.float32),
                samp_exp.to(torch.float32)]

    return lower


op_registry.register("UniformCandidateSampler",
                     lower=_make_sampler(log_uniform=False),
                     effects=op_registry.Effects(rng=True))
op_registry.register("LogUniformCandidateSampler",
                     lower=_make_sampler(log_uniform=True),
                     effects=op_registry.Effects(rng=True))


def uniform_candidate_sampler(true_classes, num_true, num_sampled, unique,
                              range_max, seed=None, name=None):
    return _sampler_op("UniformCandidateSampler", true_classes, num_true,
                       num_sampled, unique, range_max, seed, name)


def log_uniform_candidate_sampler(true_classes, num_true, num_sampled, unique,
                                  range_max, seed=None, name=None):
    return _sampler_op("LogUniformCandidateSampler", true_classes, num_true,
                       num_sampled, unique, range_max, seed, name)


def learned_unigram_candidate_sampler(true_classes, num_true, num_sampled,
                                      unique, range_max, seed=None, name=None):
    # Degrades to uniform (the reference learns counts server-side).
    return uniform_candidate_sampler(true_classes, num_true, num_sampled,
                                     unique, range_max, seed, name)


def fixed_unigram_candidate_sampler(true_classes, num_true, num_sampled,
                                    unique, range_max, vocab_file="",
                                    distortion=1.0, num_reserved_ids=0,
                                    num_shards=1, shard=0, unigrams=(),
                                    seed=None, name=None):
    return uniform_candidate_sampler(true_classes, num_true, num_sampled,
                                     unique, range_max, seed, name)


def all_candidate_sampler(true_classes, num_true, num_sampled, unique,
                          seed=None, name=None):
    return uniform_candidate_sampler(true_classes, num_true, num_sampled,
                                     unique, num_sampled, seed, name)


def _lower_accidental_hits(ctx, op, inputs):
    true_classes, sampled = inputs
    batch = true_classes.shape[0]
    n = sampled.shape[0]
    # [batch, n]: sampled candidate j collides with a true label of row i
    hit = (sampled[None, :, None] == true_classes[:, None, :]).any(dim=2)
    dev = sampled.device
    indices = torch.arange(batch, dtype=torch.int32,
                           device=dev).repeat_interleave(n)
    ids = torch.arange(n, dtype=torch.int32, device=dev).repeat(batch)
    weights = torch.where(hit.reshape(-1),
                          torch.full((), -1e37, dtype=torch.float32,
                                     device=dev),
                          torch.zeros((), dtype=torch.float32, device=dev))
    return [indices, ids, weights]


op_registry.register("ComputeAccidentalHits", lower=_lower_accidental_hits)


def compute_accidental_hits(true_classes, sampled_candidates, num_true,
                            seed=None, name=None):
    """(ref: candidate_sampling_ops.py:343). Static-shape form, as the JAX
    package's: EVERY (row, position) pair (batch * num_sampled of them)
    with weight -1e37 on a collision and 0.0 elsewhere."""
    g = ops_mod.get_default_graph()
    true_classes = ops_mod.convert_to_tensor(true_classes,
                                             dtype=dtypes_mod.int64)
    sampled_candidates = ops_mod.convert_to_tensor(sampled_candidates,
                                                   dtype=dtypes_mod.int64)
    batch = true_classes.shape[0].value
    n = sampled_candidates.shape[0].value
    total = None if batch is None or n is None else batch * n
    op = g.create_op(
        "ComputeAccidentalHits", [true_classes, sampled_candidates],
        attrs={"num_true": int(num_true)},
        name=name or "ComputeAccidentalHits",
        output_specs=[
            (shape_mod.TensorShape([total]), dtypes_mod.int32),
            (shape_mod.TensorShape([total]), dtypes_mod.int64),
            (shape_mod.TensorShape([total]), dtypes_mod.float32)])
    return op.outputs[0], op.outputs[1], op.outputs[2]
