"""The PyTorch port's encoder-decoder serving against the JAX package's.

JAX ``TransformerGenerativeModel``s (``TransformerConfig.tiny()``,
``aot_warmup=False``) are built once for the module: a target saved
through the JAX ``Saver`` (``init_fresh=True, seed=7``) and a garbage
draft of other weights (``seed=999``). The port reads the same ``.stfz``
checkpoints (``convert.load_stfz`` -> ``seq2seq_params_from_jax``) and
both engines serve the same sources: plain greedy with the f32 head and
with ``int8=True``, and speculative with a same-weights draft and with the
garbage draft at ``max_decode_len = 8``, ``speculative_k = 3`` (verify
blocks and draft steps run past the cache end). Tokens must be identical,
log-probs within 1e-5, outcomes and the speculative counts equal. The
port's models run on the CPU (the kernels' plain versions), their bucket
programs through ``aot_warmup=True`` unless a test says otherwise.
"""

import os
import time

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as stf
from simple_tensorflow_tpu import serving as jserving
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.ops import kv_cache_ops as jkvc
from simple_tensorflow_tpu_torch import convert, serving
from simple_tensorflow_tpu_torch.framework import errors
from simple_tensorflow_tpu_torch.models import transformer as tr
from simple_tensorflow_tpu_torch.ops.kv_cache import SlotKVCache
from torch_threads import one_torch_thread  # noqa: F401

SRC_LEN, L, SLOTS = 8, 8, 4
# decode buckets of the models and policies: two, so the JAX models
# compile two programs of each kind
BUCKETS = [1, SLOTS]


@pytest.fixture(autouse=True)
def _fresh_graph():
    stf.reset_default_graph()
    yield
    stf.reset_default_graph()


def _save(model, directory):
    ckpt = str(directory / "model")
    with model.graph.as_default():
        stf.train.Saver().save(model.session, ckpt)
    return ckpt


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    """``get(kind)`` builds each JAX model once: ``"target"`` (seed 7,
    saved), ``"target_int8"``, ``"spec_target"`` (``speculative_k=3`` and
    ``draft_steps=2``), ``"draft"`` (the target's weights,
    ``draft_steps=2``) and
    ``"garbage_draft"`` (seed 999, saved). ``ckpt[name]`` holds the
    checkpoints."""
    built, ckpt = {}, {}
    cfg = jtr.TransformerConfig.tiny()

    def make(**kw):
        return jtr.TransformerGenerativeModel(
            cfg, SRC_LEN, num_slots=SLOTS, max_decode_len=L,
            decode_bucket_sizes=BUCKETS, aot_warmup=False, **kw)

    def get(kind):
        if kind in built:
            return built[kind]
        if kind in ("target", "garbage_draft"):
            seed = 7 if kind == "target" else 999
            extra = {"draft_steps": 2} if kind == "garbage_draft" else {}
            m = make(init_fresh=True, seed=seed, **extra)
            ckpt[kind] = _save(m, tmp_path_factory.mktemp(kind))
        else:
            get("target")
            extra = {"target_int8": {"int8": True},
                     "spec_target": {"speculative_k": 3,
                                     "draft_steps": 2},
                     "draft": {"draft_steps": 2}}[kind]
            m = make(checkpoint=ckpt["target"], **extra)
        built[kind] = m
        return m

    get.ckpt = ckpt
    yield get
    for m in built.values():
        m.close()


class _Borrowed:
    """A module-scoped model lent to one engine: its ``close`` (which the
    engine calls as it closes) is left to the fixture; ``overrides``
    replace attributes the engine reads."""

    def __init__(self, model, **overrides):
        self._model = model
        self.__dict__.update(overrides)

    def __getattr__(self, name):
        return getattr(self._model, name)

    def close(self):
        pass


def _port(ckpt, **kw):
    return tr.TransformerGenerativeModel(
        tr.TransformerConfig.tiny(), SRC_LEN, num_slots=SLOTS,
        max_decode_len=L, decode_bucket_sizes=BUCKETS, checkpoint=ckpt,
        device="cpu", **kw)


def _sources(n, seed=3):
    """Sources of 3 to 8 real tokens (the rest pad), so the pad bias
    masks part of every short one."""
    rng = np.random.RandomState(seed)
    vocab = tr.TransformerConfig.tiny().vocab_size
    return [rng.randint(2, vocab, rng.randint(3, SRC_LEN + 1))
            for _ in range(n)]


def _serve(engine_cls, policy_cls, model, sources, draft=None, name="e",
           budgets=None):
    pol = policy_cls(num_slots=SLOTS, max_decode_len=L, max_new_tokens=L,
                     bucket_sizes=BUCKETS)
    budgets = budgets or [3 + i % 6 for i in range(len(sources))]
    if engine_cls is jserving.GenerativeEngine:
        model = _Borrowed(model)
        draft = None if draft is None else _Borrowed(draft)
    with engine_cls(name, model, pol, draft=draft) as eng:
        futs = [eng.generate(s, max_new_tokens=b)
                for s, b in zip(sources, budgets)]
        out = [f.result(timeout=120) for f in futs]
        info = eng.statusz_info()
    return out, info


def _same_streams(got, want, exact_logp=False):
    for g, w in zip(got, want):
        assert g["outcome"] == w["outcome"]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        if exact_logp:
            np.testing.assert_array_equal(g["logprobs"], w["logprobs"])
        else:
            np.testing.assert_allclose(g["logprobs"], w["logprobs"],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_head",
                                                     "int8_head"])
def test_engine_streams_match_jax(jax_models, int8):
    """Nine sources over four slots with staggered budgets (slots retire
    and refill mid-decode): the port's streams equal the JAX engine's, and
    the f32 head's tokens are the argmax of the plain re-forward,
    teacher-forced on the stream."""
    jm = jax_models("target_int8" if int8 else "target")
    sources = _sources(9)
    want, _ = _serve(jserving.GenerativeEngine, jserving.DecodePolicy, jm,
                     sources, name=f"jax_{int8}")
    pm = _port(jax_models.ckpt["target"], int8=int8)
    stack = pm.stack
    got, info = _serve(serving.GenerativeEngine, serving.DecodePolicy, pm,
                       sources, name=f"port_{int8}")
    _same_streams(got, want)
    assert info["metrics"]["prefill_seconds_total"] > 0
    assert info["metrics"]["tokens"] == sum(len(g["tokens"]) for g in got)
    if int8:
        return
    for src, r in zip(sources, got):
        row = np.zeros((1, SRC_LEN), np.int64)
        row[0, :len(src)] = src
        tgt_in = np.concatenate([[tr.TransformerConfig.tiny().eos_id],
                                 r["tokens"][:-1]])[None]
        logits = tr.seq2seq_logits_plain(stack, torch.as_tensor(row),
                                         torch.as_tensor(tgt_in))[0]
        assert logits.argmax(-1).tolist() == list(r["tokens"])
        lp = torch.log_softmax(logits, -1).gather(
            1, torch.as_tensor(r["tokens"]).long()[:, None])[:, 0]
        np.testing.assert_allclose(r["logprobs"], lp.numpy(), rtol=0,
                                   atol=1e-5)


def _jax_hidden(jm, kind, feeds):
    """The JAX ``kind`` program's final hidden state (the logits head's
    input) at bucket ``len(slots)``, its caches appended on the way."""
    p = jm._prog[kind][len(feeds["slots"])]
    queue, seen = [p["next_tok"].op], set()
    while queue:
        op = queue.pop(0)
        if op.type == "FusedLayerNorm":
            h = op.outputs[0]
            break
        for t in op.inputs:
            if t.op.name not in seen:
                seen.add(t.op.name)
                queue.append(t.op)
    plan = jm.session.plan({"h": h}, feeds=[p["tok"], p["pos"], p["slots"]])
    return np.asarray(plan.execute({p[k]: v for k, v in feeds.items()})["h"])


def test_decode_and_verify_hidden_states_match_jax(jax_models):
    """Prefill two sources, one decode step of both (padded to bucket 4,
    padding rows on the scratch slot), then a verify block of 3 at
    position 1: the hidden states equal JAX's within 1e-5."""
    jm = jax_models("spec_target")
    pm = _port(jax_models.ckpt["target"], speculative_k=3,
               aot_warmup=False)
    src = np.zeros((2, SRC_LEN), np.int32)
    for i, s in enumerate(_sources(2, seed=8)):
        src[i, :len(s)] = s
    jm.prefill(src, [2, 0])
    pm.prefill(src, [2, 0])
    scratch = pm.scratch_slot
    feeds = {"tok": np.array([1, 1, 0, 0], np.int32),
             "pos": np.zeros(4, np.int32),
             "slots": np.array([2, 0, scratch, scratch], np.int32)}
    want = _jax_hidden(jm, "decode", feeds)
    got = pm.decode_hidden(feeds["tok"], feeds["pos"],
                           feeds["slots"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    blk = np.array([[5, 9, 11], [7, 7, 3], [0, 0, 0], [0, 0, 0]], np.int32)
    feeds = {"tok": blk, "pos": np.array([1, 1, 0, 0], np.int32),
             "slots": feeds["slots"]}
    want = _jax_hidden(jm, "verify", feeds)
    got = pm.verify_hidden(blk, feeds["pos"], feeds["slots"]).numpy()
    assert got.shape == (4, 3, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("draft_kind", ["draft", "garbage_draft"],
                         ids=["same_weights", "garbage"])
def test_speculative_streams_match_jax_and_plain(jax_models, draft_kind):
    """A ``speculative_k=3`` target with a ``draft_steps=2`` draft at
    ``max_decode_len = 8``: blocks verified near the end write past the
    cache (dropped), and the draft's chained steps do too. The streams
    equal the JAX engine's speculative streams and the port's own plain
    streams; the proposed and accepted counts equal JAX's."""
    sources = _sources(6, seed=5)
    budgets = [L] * 3 + [4, 6, 7]
    want, jinfo = _serve(jserving.GenerativeEngine, jserving.DecodePolicy,
                         jax_models("spec_target"), sources,
                         draft=jax_models(draft_kind),
                         name=f"jspec_{draft_kind}", budgets=budgets)
    ckpt = jax_models.ckpt
    draft_ckpt = ckpt["garbage_draft" if draft_kind == "garbage_draft"
                      else "target"]
    got, pinfo = _serve(serving.GenerativeEngine, serving.DecodePolicy,
                        _port(ckpt["target"], speculative_k=3), sources,
                        draft=_port(draft_ckpt, draft_steps=2),
                        name=f"pspec_{draft_kind}", budgets=budgets)
    plain, _ = _serve(serving.GenerativeEngine, serving.DecodePolicy,
                      _port(ckpt["target"]), sources,
                      name=f"pplain_{draft_kind}", budgets=budgets)
    _same_streams(got, want)
    _same_streams(got, plain)
    assert pinfo["speculative"] == jinfo["speculative"]
    assert pinfo["speculative"]["proposed_tokens"] > 0
    rate = pinfo["speculative"]["acceptance_rate"]
    assert rate >= 0.5 if draft_kind == "draft" else rate < 0.5
    m = pinfo["metrics"]
    assert m["spec_proposed_tokens"] == \
        pinfo["speculative"]["proposed_tokens"]
    assert m["tokens"] == sum(len(g["tokens"]) for g in got)


def test_verify_equals_chained_decode_steps():
    """One verify of a block equals the same positions decoded one by
    one, bit for bit on the CPU (JAX
    ``test_verify_matches_chained_single_steps``), and a draft's
    ``decode_k`` proposes the chained steps' picks."""
    cfg = tr.TransformerConfig.tiny()
    model = tr.TransformerGenerativeModel(
        cfg, SRC_LEN, num_slots=2, max_decode_len=L, init_fresh=True,
        seed=3, speculative_k=3, draft_steps=2, device="cpu")
    src = np.zeros((1, SRC_LEN), np.int32)
    first = _sources(1, seed=2)[0]
    src[0, :len(first)] = first
    model.prefill(src, [0])
    tok, chain, lps = np.array([cfg.eos_id], np.int32), [], []
    for t in range(3):
        nxt, lp, _ = model.decode(tok, [t], [0])
        chain.append(int(nxt[0]))
        lps.append(float(lp[0]))
        tok = nxt
    model.prefill(src, [1])
    props, _ = model.decode_k([cfg.eos_id], [0], [1])
    assert list(props[0]) == chain[:2]
    toks, logps, sb = model.verify([[cfg.eos_id] + chain[:2]], [0], [1])
    assert sb == 1 and list(toks[0]) == chain
    np.testing.assert_allclose(logps[0], lps, rtol=0, atol=1e-6)
    model.close()


def test_aot_programs_match_eager_and_jax(jax_models):
    """``aot_warmup=True`` (one program a bucket, replayed from static
    inputs) against eager dispatch on one script of prefill, decode,
    verify and draft calls at shrinking and partial buckets: bit-identical;
    tokens equal the JAX model's."""
    jm = jax_models("spec_target")
    ckpt = jax_models.ckpt
    models = {"jax": jm,
              "aot": _port(ckpt["target"], speculative_k=3, draft_steps=2),
              "eager": _port(ckpt["target"], speculative_k=3, draft_steps=2,
                             aot_warmup=False)}
    src = np.zeros((3, SRC_LEN), np.int32)
    for i, s in enumerate(_sources(3, seed=4)):
        src[i, :len(s)] = s
    got = {}
    for name, m in models.items():
        m.prefill(src, [0, 1, 2])
        out = []
        last, pos = np.ones(3, np.int32), np.zeros(3, np.int32)
        for rows in (3, 1, 2):
            t, lp, sb = m.decode(last[:rows], pos[:rows], np.arange(rows))
            out.append((t, lp, sb))
            last[:rows], pos[:rows] = t, pos[:rows] + 1
        props, sb = m.decode_k(last[:2], pos[:2], [0, 1])
        out.append((props, np.zeros(1), sb))
        blk = np.concatenate([last[:2, None], props], axis=1)
        t, lp, sb = m.verify(blk, pos[:2], [0, 1])
        out.append((t, lp, sb))
        got[name] = out
    assert [o[2] for o in got["aot"]] == [4, 1, 4, 4, 4]
    for a, e, j in zip(got["aot"], got["eager"], got["jax"]):
        assert a[2] == e[2] == j[2]
        np.testing.assert_array_equal(a[0], e[0])
        np.testing.assert_array_equal(a[1], e[1])
        np.testing.assert_array_equal(a[0], j[0])
        np.testing.assert_allclose(a[1], j[1], rtol=0, atol=1e-5)


def test_join_leave_bitexact_vs_solo():
    """In the one decode bucket 4, each sequence's stream alone equals its
    stream in a churning batch (staggered budgets leave at different
    steps), bit for bit (JAX ``test_join_leave_bitexact_vs_solo``)."""
    cfg = tr.TransformerConfig.tiny()
    model = tr.TransformerGenerativeModel(
        cfg, SRC_LEN, num_slots=SLOTS, max_decode_len=L,
        decode_bucket_sizes=[4], init_fresh=True, seed=5, device="cpu")
    pol = serving.DecodePolicy(num_slots=SLOTS, max_decode_len=L,
                               bucket_sizes=[4], max_new_tokens=6)
    sources = _sources(4, seed=6)
    with serving.GenerativeEngine("bitexact", model, pol) as eng:
        solo = [eng.generate(s, max_new_tokens=4 + i % 3).result(60)
                for i, s in enumerate(sources)]
        futs = [eng.generate(s, max_new_tokens=4 + i % 3)
                for i, s in enumerate(sources)]
        joined = [f.result(60) for f in futs]
    _same_streams(joined, solo, exact_logp=True)


class _FakeSlotModel:
    """A slot model whose sequence for prompt id ``p`` (the source's
    first token) emits 100 + p, then EOS after ``eos_after[p]`` tokens;
    each decode sleeps ``delay_s``. Records the slots each prefill took."""

    eos_id, pad_id, src_len, num_slots, max_decode_len = 1, 0, 4, 2, 16
    scratch_slot = 2
    decode_buckets = [1, 2]

    def __init__(self, eos_after, delay_s=0.0):
        self.eos_after = dict(eos_after)
        self.delay_s = delay_s
        self.prompt_of_slot, self.emitted = {}, {}
        self.slots_used = []
        self.closed = False

    def prefill(self, src_rows, slots):
        for row, slot in zip(np.asarray(src_rows), np.asarray(slots)):
            self.prompt_of_slot[int(slot)] = int(row[0])
            self.emitted[int(slot)] = 0
            self.slots_used.append(int(slot))

    def decode(self, tokens, positions, slots):
        time.sleep(self.delay_s)
        out = []
        for slot in slots:
            if slot == self.scratch_slot:
                out.append(self.pad_id)
                continue
            pid = self.prompt_of_slot[slot]
            self.emitted[slot] += 1
            done = self.emitted[slot] > self.eos_after.get(pid, 10 ** 9)
            out.append(self.eos_id if done else 100 + pid)
        return (np.asarray(out, np.int32),
                np.full(len(out), -0.5, np.float32), len(slots))

    def close(self):
        self.closed = True


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_eos_retires_and_slot_is_reused(impl):
    """Six requests over two slots: each retires at its EOS, its slot
    returns to the free-list and the next request takes it; the port and
    the JAX engine give the same results on the same model."""
    eng_mod = serving if impl == "port" else jserving
    fake = _FakeSlotModel({i: i % 3 + 1 for i in range(2, 8)})
    pol = eng_mod.DecodePolicy(num_slots=2, max_decode_len=16,
                               bucket_sizes=[1, 2])
    with eng_mod.GenerativeEngine(f"eos_{impl}", fake, pol) as eng:
        res = [f.result(30) for f in [eng.generate([i, 5])
                                      for i in range(2, 8)]]
    for i, r in zip(range(2, 8), res):
        assert r["outcome"] == "eos"
        assert list(r["tokens"]) == [100 + i] * (i % 3 + 1) + [1]
    assert sorted(set(fake.slots_used)) == [0, 1]
    assert len(fake.slots_used) == 6 and fake.closed


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_per_token_deadline_and_close(impl):
    """A request whose deadline passes mid-decode retires at the next step
    with DeadlineExceeded while another finishes; close drains the queued
    requests, then refuses new ones as Unavailable."""
    eng_mod = serving if impl == "port" else jserving
    err = errors if impl == "port" else jerrors()
    fake = _FakeSlotModel({2: 100, 3: 2}, delay_s=0.02)
    pol = eng_mod.DecodePolicy(num_slots=2, max_decode_len=200,
                               bucket_sizes=[1, 2], max_new_tokens=150)
    fake.max_decode_len = 200
    eng = eng_mod.GenerativeEngine(f"dl_{impl}", fake, pol)
    slow = eng.generate([2, 5], timeout_ms=150)
    fast = eng.generate([3, 5])
    assert fast.result(30)["outcome"] == "eos"
    with pytest.raises(err.DeadlineExceededError):
        slow.result(30)
    queued = [eng.generate([3, 5]) for _ in range(3)]
    eng.close()
    assert all(f.result(30)["outcome"] == "eos" for f in queued)
    with pytest.raises(err.UnavailableError):
        eng.generate([3, 5]).result(5)
    assert fake.closed


def jerrors():
    from simple_tensorflow_tpu.framework import errors as jerr
    return jerr


def test_engine_rejects_long_sources_and_zero_budgets():
    model = tr.TransformerGenerativeModel(
        tr.TransformerConfig.tiny(), SRC_LEN, num_slots=SLOTS,
        max_decode_len=L, init_fresh=True, device="cpu", aot_warmup=False)
    pol = serving.DecodePolicy(num_slots=SLOTS, max_decode_len=L)
    with serving.GenerativeEngine("rej", model, pol) as eng:
        with pytest.raises(errors.InvalidArgumentError, match="src_len"):
            eng.generate(np.arange(2, 12)).result(10)
        r = eng.generate([3, 4], max_new_tokens=0).result(10)
        assert r["outcome"] == "length" and not len(r["tokens"])
        r = eng.generate([3, 4], max_new_tokens=50).result(60)
        # the budget clamps to the cache
        assert r["outcome"] == "eos" or len(r["tokens"]) == L
        assert eng.metrics.snapshot()["sequences"]["rejected"] == 1


# ---------------------------------------------------------------------------
# Modules of the slice
# ---------------------------------------------------------------------------

def test_slot_kv_cache_matches_jax_kv_cache_ops():
    """Append (one position and a block of 3, one block reaching past the
    end) and gather against the JAX ``KVCacheAppend``/``KVCacheGather``
    lowerings on the same inputs: the same cache, the out-of-bounds rows
    dropped, the scratch row included; and the bias cache's ``()``
    inner shape."""
    rng = np.random.RandomState(0)
    steps = [(rng.randn(2, 1, 2, 3).astype(np.float32), [1, 3], [0, 5]),
             (rng.randn(3, 3, 2, 3).astype(np.float32), [0, 4, 1], [4, 6, 1]),
             (rng.randn(2, 3, 2, 3).astype(np.float32), [4, 3], [0, 7])]
    c = jkvc.kv_cache("c_slot", num_slots=5, max_len=8, inner_shape=(2, 3),
                      dtype=stf.float32)
    alloc = c.alloc()
    val = stf.placeholder(stf.float32, [None, None, 2, 3], "val")
    slots = stf.placeholder(stf.int32, [None], "slots")
    pos = stf.placeholder(stf.int32, [None], "pos")
    gathered = c.append_and_gather(val, slots, pos)
    everything = c.gather(stf.constant(np.arange(5, dtype=np.int32)))
    ours = SlotKVCache(4, 8, (2, 3))
    with stf.Session() as sess:
        sess.run(alloc.op)
        for v, s, p in steps:
            g = sess.run(gathered, {val: v, slots: np.int32(s),
                                    pos: np.int32(p)})
            ours.append(torch.from_numpy(v), torch.tensor(s),
                        torch.tensor(p, dtype=torch.int32))
            np.testing.assert_array_equal(
                ours.gather(torch.tensor(s)).numpy(), g)
        want = sess.run(everything)
    assert tuple(ours.data.shape) == (5, 8, 2, 3)
    np.testing.assert_array_equal(ours.data.numpy(), want)
    # the rows past the end were dropped: slot 3 holds positions 5 and 7
    assert (ours.data[3, 6].numpy() == 0).all()
    bias = SlotKVCache(2, 4, (), dtype=torch.float32)
    bias.append(torch.ones(1, 4), torch.tensor([1]), torch.tensor([0]))
    assert bias.gather(torch.tensor([1, 2])).tolist() == [[1.0] * 4,
                                                          [0.0] * 4]
    bias.alloc()
    assert not bias.data.any()


def test_decode_len_beyond_pos_table_raises():
    cfg = tr.TransformerConfig.tiny()  # max_len 32
    with pytest.raises(ValueError, match="max_len"):
        tr.TransformerGenerativeModel(cfg, SRC_LEN, num_slots=2,
                                      max_decode_len=cfg.max_len + 1,
                                      init_fresh=True, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        jtr.build_generative_program(jtr.TransformerConfig.tiny(), SRC_LEN,
                                     num_slots=2,
                                     max_decode_len=cfg.max_len + 1)


def _geometry_error(eng_mod, target, draft):
    pol = eng_mod.DecodePolicy(num_slots=SLOTS, max_decode_len=L,
                               bucket_sizes=BUCKETS)
    with pytest.raises(ValueError) as info:
        eng_mod.GenerativeEngine("geom", target, pol, draft=draft)
    return str(info.value)


@pytest.mark.parametrize("target_kw,draft_kw", [
    ({}, {"draft_steps": 3}),
    ({"spec_k": 1}, {"draft_steps": 0}),
    ({}, {"src_len": 6}),
    ({}, {"num_slots": 2}),
    ({}, {"max_decode_len": 6}),
], ids=["k_vs_steps", "k_below_2", "src_len", "slots", "decode_len"])
def test_draft_target_geometry_validated(jax_models, target_kw, draft_kw):
    """Each draft/target mismatch raises JAX's ValueError, word for word
    (JAX ``test_draft_target_geometry_validated``); the models' geometry is
    overridden where the engine reads it."""
    ckpt = jax_models.ckpt
    jax_models("target")
    ours = _geometry_error(
        serving, _Borrowed(_port(ckpt["target"], speculative_k=3,
                                 aot_warmup=False), **target_kw),
        _Borrowed(_port(ckpt["target"], draft_steps=2, aot_warmup=False),
                  **draft_kw))
    theirs = _geometry_error(
        jserving, _Borrowed(jax_models("spec_target"), **target_kw),
        _Borrowed(jax_models("draft"), **draft_kw))
    assert ours == theirs
    # a draft on the paged model: JAX's error too
    assert "paged" in _geometry_error(
        serving, _Borrowed(_port(ckpt["target"], speculative_k=3,
                                 aot_warmup=False), page_len=4),
        _Borrowed(_port(ckpt["target"], draft_steps=2, aot_warmup=False)))


def test_seq2seq_checkpoint_names_and_init(jax_models):
    jax_models("target")
    named = convert.load_stfz(jax_models.ckpt["target"])
    cfg = tr.TransformerConfig.tiny()
    state = convert.seq2seq_params_from_jax(named, cfg)
    fresh = convert.init_seq2seq_params(cfg, seed=0)
    assert set(state) == set(fresh) == set(tr.Seq2SeqStack(cfg).state_dict())
    for k in state:
        assert state[k].shape == fresh[k].shape, k
    np.testing.assert_array_equal(
        state["decoder.layer_1.cross_attn.k.kernel"].numpy(),
        named["transformer/decoder/layer_1/cross_attn/k/kernel"])
    np.testing.assert_array_equal(
        state["encoder.layer_0.ln2.gamma"].numpy(),
        named["transformer/encoder/layer_0/ln2/gamma"])
    again = convert.init_seq2seq_params(cfg, seed=0)
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    del named["transformer/decoder/layer_0/ln2/beta"]
    with pytest.raises(KeyError, match="ln2/beta"):
        convert.seq2seq_params_from_jax(named, cfg)
    total, unsharded = tr.generative_cache_bytes(cfg, SRC_LEN, SLOTS, L,
                                                 torch.float32)
    assert (total, unsharded) == jtr.generative_cache_bytes(
        jtr.TransformerConfig.tiny(), SRC_LEN, SLOTS, L, stf.float32)


def test_slot_model_refuses_what_later_slices_port():
    cfg = tr.TransformerConfig.tiny()
    kw = dict(num_slots=2, max_decode_len=L, init_fresh=True, device="cpu")
    with pytest.raises(NotImplementedError, match="sampling"):
        tr.TransformerGenerativeModel(cfg, SRC_LEN,
                                      sampling={"temperature": 1.0}, **kw)
    for extra in ({"tp": 2}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="tensor parallel"):
            tr.TransformerGenerativeModel(cfg, SRC_LEN, **kw, **extra)
    with pytest.raises(ValueError, match="init_fresh"):
        tr.TransformerGenerativeModel(cfg, SRC_LEN, num_slots=2,
                                      device="cpu")
    m = tr.TransformerGenerativeModel(cfg, SRC_LEN, aot_warmup=False, **kw)
    with pytest.raises(RuntimeError, match="speculative_k"):
        m.verify([[1, 2]], [0], [0])
    with pytest.raises(RuntimeError, match="draft_steps"):
        m.decode_k([1], [0], [0])
    info = m.statusz_info()
    assert info["spec_k"] == 0 and info["decode_buckets"] == [1, 2]
    assert os.fspath(info["device"]) == "cpu"


def test_bf16_compute_dtype_matches_jax(tmp_path):
    """``compute_dtype=bfloat16`` (Dense weights, activations and caches in
    bf16; the embedding, LayerNorm parameters and the pad bias f32): from
    a JAX bf16 model's checkpoint, seven decode steps of four sequences
    pick JAX's tokens, log-probs within 2e-2 (bf16 rounding)."""
    import simple_tensorflow_tpu_torch as pstf

    jm = jtr.TransformerGenerativeModel(
        jtr.TransformerConfig.tiny(), SRC_LEN, num_slots=SLOTS,
        max_decode_len=L, decode_bucket_sizes=BUCKETS,
        prefill_bucket_sizes=[SLOTS], init_fresh=True, seed=7,
        aot_warmup=False, compute_dtype=stf.bfloat16)
    ckpt = _save(jm, tmp_path)
    pm = _port(ckpt, compute_dtype=pstf.bfloat16)
    assert pm.stack.decoder["layer_0"].self_attn["q"].kernel.dtype == \
        torch.bfloat16
    try:
        src = np.random.RandomState(0).randint(2, 64, (SLOTS, SRC_LEN))
        slots = np.arange(SLOTS)
        for m in (jm, pm):
            m.prefill(src.astype(np.int32), slots)
        tok = {"jax": np.ones(SLOTS, np.int32), "port": np.ones(SLOTS,
                                                              np.int32)}
        for t in range(L - 1):
            want = jm.decode(tok["jax"], [t] * SLOTS, slots)
            got = pm.decode(tok["port"], [t] * SLOTS, slots)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-2)
            tok["jax"], tok["port"] = want[0], got[0]
    finally:
        jm.close()
