"""Per-step random streams of dropout sites, as a JAX ``Session`` derives
them.

Port of ``simple_tensorflow_tpu/framework/random_seed.py:fold_in_value``
(:45-53) and of the key chain around it: a session run that draws
randomness advances the session's run counter ``c`` and folds it into the
base key, ``root = fold_in(key(graph_seed or 0), c)``
(``client/session.py:_rng_args``); a random op's key is ``fold_in(root,
fold_in_value(op))`` (``framework/lowering.py:rng_for``). A ``Dropout``
op draws ``uniform(key, shape)`` from it; ``FlashAttentionDropout`` and
``FusedDropoutBiasResidual`` draw one int32 seed ``randint(key, (1,), 0,
2**31 - 1)`` for their counter-hash masks (``ops/pallas/__init__.py``).

:class:`StepRNG` holds the keys and seeds of one step;
:meth:`StepRNG.for_steps` derives every site of a block of steps in one
vectorized host pass over numpy arrays: no tensor, no device work.

The eager trainers use the unseeded rule (no ``set_random_seed``: base
key ``key(0)``, stream id ``crc32(op name)``). Graph ops take their seeds
from :func:`get_seed` (:26) at construction, which reads the graph's op
counter when only the graph seed is set, and :func:`fold_in_value` reads
them back from the op's ``seed`` and ``_graph_seed`` attrs (:45-53).
"""

from __future__ import annotations

import zlib

import numpy as np

from . import prng

DEFAULT_GRAPH_SEED = 87654321


def get_seed(op_seed):
    """``(graph_seed, op_seed)`` of a random op being built in the default
    graph (ref: python/framework/random_seed.py:27 ``get_seed``): with a
    graph seed and no op seed, the op seed is the graph's op counter."""
    from . import graph as ops

    g = ops.get_default_graph()
    graph_seed = g.seed
    if graph_seed is not None:
        if op_seed is None:
            op_seed = g._op_counter
        return graph_seed, op_seed
    if op_seed is not None:
        return DEFAULT_GRAPH_SEED, op_seed
    return None, None


def set_random_seed(seed):
    """The default graph's seed (ref: random_seed.py:75)."""
    from . import graph as ops

    ops.get_default_graph().seed = seed


def fold_in_value(op_or_name, graph_seed=None, op_seed=None) -> int:
    """Stable 31-bit stream id of a random op, from its seeds or, when it
    has none, from its name. ``op_or_name`` is a graph Operation (its
    ``_graph_seed`` and ``seed`` attrs are read) or an op name with the
    seeds beside it."""
    if hasattr(op_or_name, "attrs"):
        graph_seed = op_or_name.attrs.get("_graph_seed")
        op_seed = op_or_name.attrs.get("seed")
        op_or_name = op_or_name.name
    if graph_seed is not None or op_seed is not None:
        return ((graph_seed or 0) * 1000003 + (op_seed or 0)) & 0x7FFFFFFF
    return zlib.crc32(op_or_name.encode()) & 0x7FFFFFFF


class StepRNG:
    """The random streams of one step: ``key_for(name)`` is the threefry
    key (two uint32 words as Python ints) of a ``Dropout`` site,
    ``seed_for(name)`` the int32 seed of a counter-hash site. Build them
    with :meth:`for_steps`."""

    def __init__(self, keys: dict, seeds: dict):
        self._keys = keys
        self._seeds = seeds

    @classmethod
    def for_steps(cls, counters, key_sites, seed_sites):
        """One :class:`StepRNG` per session run counter in ``counters``
        (each already advanced), derived in one vectorized host pass over
        every (step, site) of an unseeded graph: ``key_sites`` and
        ``seed_sites`` are JAX op names."""
        key_sites, seed_sites = list(key_sites), list(seed_sites)
        names = key_sites + seed_sites
        counters = np.asarray(counters, dtype=np.int64) & 0xFFFFFFFF
        roots = prng.fold_in(prng.key(0), counters)
        ids = np.array([fold_in_value(n) for n in names], dtype=np.uint32)
        keys = prng.fold_in(roots[:, None, :], ids)      # (steps, sites, 2)
        nk = len(key_sites)
        seeds = prng.randint(keys[:, nk:], (1,), 0, prng.INT32_MAX)
        return [cls({n: (int(k[0]), int(k[1]))
                     for n, k in zip(key_sites, step_keys[:nk])},
                    {n: int(s[0]) for n, s in zip(seed_sites, step_seeds)})
                for step_keys, step_seeds in zip(keys, seeds)]

    def key_for(self, name: str) -> tuple:
        return self._keys[name]

    def seed_for(self, name: str) -> int:
        return self._seeds[name]
