"""The PyTorch port's paged causal-LM serving slice against the JAX
package's.

One JAX ``CausalLMGenerativeModel`` (``TransformerConfig.tiny()``,
``init_fresh=True, seed=11``) is saved through the JAX ``Saver``; the port
reads the same ``.stfz`` checkpoint (``convert.load_stfz`` ->
``params_from_jax``) and both engines serve the same shared-prefix
prompts, with the f32 head and with ``int8=True``: the token streams must
be identical and the log-probs agree within 1e-5. The decode step's
hidden state is compared directly too, and the per-bucket executables
(``aot_warmup=True``, the default) on a fixed call script. Everything runs on the CPU (the
port's kernels take their plain versions on CPU tensors).
"""

import threading

import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as stf
from simple_tensorflow_tpu import serving as jserving
from simple_tensorflow_tpu.data import pipeline as jpipeline
from simple_tensorflow_tpu.models import causal_lm as jclm
from simple_tensorflow_tpu.models import transformer as jtr
from simple_tensorflow_tpu.serving import policy as jpolicy
from simple_tensorflow_tpu.serving import prefix_cache as jprefix
from simple_tensorflow_tpu_torch import convert, serving
from simple_tensorflow_tpu_torch.framework import errors
from simple_tensorflow_tpu_torch.models import causal_lm as clm
from simple_tensorflow_tpu_torch.models import transformer as tr
from simple_tensorflow_tpu_torch.ops.kv_cache import KVCache
from simple_tensorflow_tpu_torch.serving import _queue
from simple_tensorflow_tpu_torch.serving import policy as ppolicy
from simple_tensorflow_tpu_torch.serving import prefix_cache as pprefix
from torch_threads import one_torch_thread  # noqa: F401

PAGE_LEN, PAGES_PER_SEQ, NUM_PAGES, MAX_LIVE = 4, 4, 16, 4
GEOMETRY = dict(page_len=PAGE_LEN, pages_per_seq=PAGES_PER_SEQ,
                num_pages=NUM_PAGES, max_live=MAX_LIVE)


@pytest.fixture(autouse=True)
def _fresh_graph():
    stf.reset_default_graph()
    yield
    stf.reset_default_graph()


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    """JAX model per head (built lazily) and its checkpoint prefix."""
    built = {}

    def get(int8):
        if int8 not in built:
            m = jclm.CausalLMGenerativeModel(
                jtr.TransformerConfig.tiny(), init_fresh=True, seed=11,
                aot_warmup=False, int8=int8, **GEOMETRY)
            ckpt = str(tmp_path_factory.mktemp("clm") / "model")
            with m.graph.as_default():
                stf.train.Saver().save(m.session, ckpt)
            built[int8] = (m, ckpt)
        return built[int8]

    yield get
    for m, _ in built.values():
        m.close()


def _port_model(ckpt, int8=False, **kw):
    return clm.CausalLMGenerativeModel(
        tr.TransformerConfig.tiny(), checkpoint=ckpt, int8=int8,
        device="cpu", **GEOMETRY, **kw)


def _prompts(vocab):
    """Four prompts sharing one full page, then a pair whose second
    prompt's cached tail is a proper prefix of the first's page (the
    copy-on-write admission)."""
    rng = np.random.RandomState(4)
    shared = list(rng.randint(2, vocab, 6))
    group = [shared + list(rng.randint(2, vocab, 3)) for _ in range(4)]
    base = list(rng.randint(2, vocab, 9))
    return group, [base, base[:6] + [int(rng.randint(2, vocab))]]


def _serve(engine_cls, policy_cls, model, group, pair, name):
    pol = policy_cls(num_slots=MAX_LIVE, max_decode_len=16,
                     bucket_sizes=[1, MAX_LIVE], max_new_tokens=5)
    with engine_cls(name, model, pol) as eng:
        out = [f.result(timeout=120)
               for f in [eng.generate(p, max_new_tokens=5) for p in group]]
        # one at a time: the second reads the first's resident page
        out += [eng.generate(p, max_new_tokens=5).result(timeout=120)
                for p in pair]
        info = eng.statusz_info()["prefix_cache"]
    return out, info


@pytest.mark.parametrize("int8", [False, True], ids=["f32_head",
                                                     "int8_head"])
def test_engine_streams_match_jax(jax_models, int8):
    jm, ckpt = jax_models(int8)
    group, pair = _prompts(jm.cfg.vocab_size)
    want, jinfo = _serve(jserving.GenerativeEngine, jserving.DecodePolicy,
                         jm, group, pair, f"jax_{int8}")
    got, pinfo = _serve(serving.GenerativeEngine, serving.DecodePolicy,
                        _port_model(ckpt, int8), group, pair,
                        f"port_{int8}")
    for w, g in zip(want, got):
        assert g["outcome"] == w["outcome"]
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=0,
                                   atol=1e-5)
    assert pinfo == jinfo
    assert pinfo["hit_pages"] >= 3 and pinfo["cow_hits"] == 1


def _jax_decode_hidden(jm, tok, pos, tbl):
    """The JAX decode program's final hidden state (the logits head's
    input) for one bucket-padded batch."""
    sb = len(tok)
    p = jm._prog["decode"][sb]
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
    plan = jm.session.plan({"h": h}, feeds=[p["tok"], p["pos"],
                                            p["tables"], p["dst"],
                                            p["off"]])
    dst = tbl[np.arange(sb), pos // PAGE_LEN]
    off = (pos % PAGE_LEN).astype(np.int32)
    return np.asarray(plan.execute({p["tok"]: tok, p["pos"]: pos,
                                    p["tables"]: tbl, p["dst"]: dst,
                                    p["off"]: off})["h"])


def test_decode_step_hidden_state_matches_jax(jax_models, tmp_path):
    # a fresh JAX model from the same checkpoint: its caches are ours
    _, ckpt = jax_models(False)
    jm = jclm.CausalLMGenerativeModel(
        jtr.TransformerConfig.tiny(), checkpoint=ckpt, aot_warmup=False,
        **GEOMETRY)
    pm = _port_model(ckpt)
    try:
        rng = np.random.RandomState(8)
        p1 = rng.randint(2, 64, 9)       # cached 8 = pages 0, 1
        p2 = rng.randint(2, 64, 6)       # cached 5 = page 2 + tail page 3
        tables = np.full((2, PAGES_PER_SEQ), NUM_PAGES, np.int32)
        tables[0, :3], tables[1, :2] = [0, 1, 4], [2, 3]
        chunks = np.stack([p1[:4], p2[:4]])
        tail = np.zeros((2, PAGE_LEN), np.int32)
        tail[0], tail[1, :1] = p1[4:8], p2[4:5]
        for model in (jm, pm):
            model.prefill_chunk(chunks, [0, 0], tables, [0, 2])
            model.prefill_chunk(tail, [4, 4], tables, [1, 3])
        tok, pos, tbl, sb = pm.pad_decode_batch([p1[8], p2[5]], [8, 5],
                                                tables)
        assert sb == MAX_LIVE and (tbl[2:] == NUM_PAGES).all()
        want = _jax_decode_hidden(jm, tok, pos, tbl)
        got = pm.decode_hidden(tok, pos, tbl).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.isfinite(got).all()
    finally:
        jm.close()


def test_aot_buckets_match_jax_with_partial_and_shrinking_batches(
        jax_models):
    """``aot_warmup=True`` (the default: one executable per bucket, replayed
    from static inputs) on the CPU: prefill then decode steps of 3, 1, 2,
    3 and 1 rows, so decode bucket 4 runs partly filled and replays a
    2-row batch right after a 3-row one (a stale third row would show).
    Tokens equal the JAX model's and log-probs within 1e-5; against the
    port's own eager dispatch (``aot_warmup=False``) both are
    bit-identical."""
    _, ckpt = jax_models(False)
    jm = jclm.CausalLMGenerativeModel(
        jtr.TransformerConfig.tiny(), checkpoint=ckpt, aot_warmup=False,
        **GEOMETRY)
    models = {"jax": jm, "aot": _port_model(ckpt),
              "eager": _port_model(ckpt, aot_warmup=False)}
    assert models["aot"].statusz_info()["aot_warmup"]
    rng = np.random.RandomState(9)
    chunks = rng.randint(2, 64, (3, PAGE_LEN)).astype(np.int32)
    tables = np.full((3, PAGES_PER_SEQ), NUM_PAGES, np.int32)
    tables[:, :3] = np.arange(9).reshape(3, 3)
    got = {}
    try:
        for name, model in models.items():
            model.prefill_chunk(chunks, np.zeros(3, np.int32), tables,
                                tables[:, 0])
            pos = np.full(3, PAGE_LEN, np.int32)
            last = chunks[:, -1].copy()
            out = []
            for rows in (3, 1, 2, 3, 1):
                tok, lp, sb = model.decode(last[:rows], pos[:rows],
                                           tables[:rows])
                out.append((np.asarray(tok), np.asarray(lp), sb))
                last[:rows], pos[:rows] = tok, pos[:rows] + 1
            got[name] = out
    finally:
        jm.close()
    for a, e, j in zip(got["aot"], got["eager"], got["jax"]):
        assert a[2] == e[2] == j[2]
        np.testing.assert_array_equal(a[0], e[0])
        np.testing.assert_array_equal(a[1], e[1])
        np.testing.assert_array_equal(a[0], j[0])
        np.testing.assert_allclose(a[1], j[1], rtol=0, atol=1e-5)
    assert [o[2] for o in got["aot"]] == [MAX_LIVE, 1, MAX_LIVE, MAX_LIVE,
                                          1]


def test_same_batch_joiners_read_filled_pages():
    """Three joiners admitted in ONE batch share two full pages that the
    first of them prefills: each chunk must run after the chunks below
    it (the port orders prefill by chunk position)."""
    cfg = tr.TransformerConfig.tiny()
    model = clm.CausalLMGenerativeModel(
        cfg, init_fresh=True, seed=3, prefill_bucket_sizes=[1, 4],
        device="cpu", **GEOMETRY)
    rng = np.random.RandomState(5)
    shared = list(rng.randint(2, 64, 8))
    joiners = [shared + list(rng.randint(2, 64, 3)) for _ in range(3)]
    release = threading.Event()
    pol = serving.DecodePolicy(num_slots=MAX_LIVE, max_decode_len=16,
                               bucket_sizes=[1, MAX_LIVE])
    with serving.GenerativeEngine("joiners", model, pol) as eng:
        # the first request parks the engine thread in its first token
        # callback until every joiner is queued
        first = eng.generate([5, 6, 7], max_new_tokens=2,
                             on_token=lambda t, lp: release.wait(10))
        futs = [eng.generate(p, max_new_tokens=4) for p in joiners]
        release.set()
        first.result(timeout=60)
        results = [f.result(timeout=60) for f in futs]
        assert eng._prefix.statusz_info()["hit_pages"] == 4
    for p, r in zip(joiners, results):
        ids = torch.tensor([p + list(r["tokens"][:-1])])
        logits = clm.causal_lm_logits_plain(model.stack,
                                            ids)[0, len(p) - 1:]
        lp = torch.log_softmax(logits, -1)
        assert logits.argmax(-1).tolist() == list(r["tokens"])
        ref = lp.gather(1, torch.as_tensor(r["tokens"]).long()[:, None])
        np.testing.assert_allclose(r["logprobs"], ref[:, 0].numpy(),
                                   rtol=0, atol=1e-5)


def test_engine_rejections_and_close():
    model = clm.CausalLMGenerativeModel(
        tr.TransformerConfig.tiny(), init_fresh=True, device="cpu",
        **GEOMETRY)
    pol = serving.DecodePolicy(num_slots=MAX_LIVE, max_decode_len=16,
                               bucket_sizes=[1, MAX_LIVE])
    eng = serving.GenerativeEngine("rej", model, pol)
    try:
        too_long = eng.generate(list(range(2, 18)))   # > max_seq_len - 1
        with pytest.raises(errors.InvalidArgumentError):
            too_long.result(timeout=10)
        empty = eng.generate([3, 4], max_new_tokens=0).result(timeout=10)
        assert empty["outcome"] == "length" and not len(empty["tokens"])
        with pytest.raises(errors.InvalidArgumentError):
            eng.generate([3, 4], max_new_tokens=-1).result(timeout=10)
        ok = eng.generate([3, 4, 5], max_new_tokens=3).result(timeout=60)
        assert len(ok["tokens"]) == 3 or ok["outcome"] == "eos"
        assert eng.metrics.snapshot()["sequences"]["rejected"] == 2
    finally:
        eng.close()
    with pytest.raises(errors.UnavailableError):
        eng.generate([3, 4]).result(timeout=10)
    assert not eng._thread.is_alive()


def test_engine_refuses_what_later_slices_port():
    model = clm.CausalLMGenerativeModel(
        tr.TransformerConfig.tiny(), init_fresh=True, device="cpu",
        **GEOMETRY)
    pol = serving.DecodePolicy(num_slots=MAX_LIVE, max_decode_len=16,
                               bucket_sizes=[1, MAX_LIVE])
    # a draft on the paged model: JAX's ValueError
    with pytest.raises(ValueError, match="not supported on the paged"):
        serving.GenerativeEngine("d", model, pol, draft=model)
    # a non-paged (slot) model is served
    slot_model = tr.TransformerGenerativeModel(
        tr.TransformerConfig.tiny(), 8, num_slots=MAX_LIVE,
        max_decode_len=16, decode_bucket_sizes=[1, MAX_LIVE],
        init_fresh=True, aot_warmup=False, device="cpu")
    serving.GenerativeEngine("s", slot_model, pol).close()
    model.tp_degree = 2
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        serving.GenerativeEngine("t", model, pol)
    model.tp_degree = 1
    with pytest.raises(ValueError, match="decode program"):
        serving.GenerativeEngine("b", model, serving.DecodePolicy(
            num_slots=MAX_LIVE, max_decode_len=16, bucket_sizes=[2]))
    with pytest.raises(ValueError, match="prefix cache"):
        serving.GenerativeEngine("p", model, serving.DecodePolicy(
            num_slots=MAX_LIVE, max_decode_len=16,
            bucket_sizes=[1, MAX_LIVE], use_prefix_cache=False))
    with pytest.raises(NotImplementedError, match="sampling"):
        clm.CausalLMGenerativeModel(tr.TransformerConfig.tiny(),
                                    init_fresh=True, device="cpu",
                                    sampling={"temperature": 1.0})
    with pytest.raises(NotImplementedError, match="sampling"):
        tr.TransformerGenerativeModel(tr.TransformerConfig.tiny(), 8,
                                      init_fresh=True, device="cpu",
                                      sampling={"temperature": 1.0})


# ---------------------------------------------------------------------------
# Modules of the slice
# ---------------------------------------------------------------------------

def test_kv_cache_append_gather_copy():
    c = KVCache(num_pages=3, page_len=2, heads=1, head_dim=2)
    assert tuple(c.data.shape) == (4, 2, 1, 2)   # + the scratch page
    new = torch.arange(8, dtype=torch.float32).reshape(2, 2, 1, 2)
    c.append(new, torch.tensor([1, 3]), torch.tensor([0, 0]))
    c.append(new[:1, :1] + 100, torch.tensor([0]), torch.tensor([1]))
    view = c.gather(torch.tensor([[1, 0], [3, 3]]))
    assert tuple(view.shape) == (2, 4, 1, 2)
    np.testing.assert_array_equal(view[0, :2, 0].numpy(), new[0, :, 0])
    np.testing.assert_array_equal(view[0, 3, 0].numpy(), [100, 101])
    np.testing.assert_array_equal(view[1, 2:, 0].numpy(), new[1, :, 0])
    c.copy_page(2, 1)
    np.testing.assert_array_equal(c.data[2].numpy(), c.data[1].numpy())


def test_checkpoint_names_and_init(jax_models):
    _, ckpt = jax_models(False)
    named = convert.load_stfz(ckpt)
    cfg = tr.TransformerConfig.tiny()
    state = convert.params_from_jax(named, cfg)
    fresh = convert.init_params(cfg, seed=0)
    assert set(state) == set(fresh) == set(
        tr.DecoderStack(cfg).state_dict())
    for k in state:
        assert state[k].shape == fresh[k].shape, k
    np.testing.assert_array_equal(
        state["decoder.layer_1.self_attn.q.kernel"].numpy(),
        named["causal_lm/decoder/layer_1/self_attn/q/kernel"])
    again = convert.init_params(cfg, seed=0)
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    del named["causal_lm/decoder/layer_0/ln3/beta"]
    with pytest.raises(KeyError, match="ln3/beta"):
        convert.params_from_jax(named, cfg)


def test_prefix_cache_copy_matches_jax():
    rng = np.random.RandomState(6)
    ours, theirs = pprefix.PrefixCache(10, 4), jprefix.PrefixCache(10, 4)
    held = []
    for step in range(60):
        if held and (rng.rand() < 0.4 or len(held) > 3):
            a, b = held.pop(rng.randint(len(held)))
            ours.release(a.node)
            theirs.release(b.node)
            continue
        toks = list(rng.randint(2, 5, rng.randint(1, 14)))
        try:
            a = ours.acquire(toks)
        except pprefix.PagesExhaustedError:
            with pytest.raises(jprefix.PagesExhaustedError):
                theirs.acquire(toks)
            continue
        b = theirs.acquire(toks)
        assert (a.pages, a.cow_src, a.tail_ready, a.cached_len) == \
            (b.pages, b.cow_src, b.tail_ready, b.cached_len)
        held.append((a, b))
        assert ours.statusz_info() == theirs.statusz_info()
    assert ours.reconcile([]) == theirs.reconcile([])


def test_policy_copy_matches_jax():
    assert ppolicy._pow2_buckets(48) == jpolicy._pow2_buckets(48)
    a = ppolicy.DecodePolicy(num_slots=16, max_decode_len=64,
                             max_new_tokens=100)
    b = jpolicy.DecodePolicy(num_slots=16, max_decode_len=64,
                             max_new_tokens=100)
    assert repr(a) == repr(b)
    assert [a.bucket_for(n) for n in range(1, 17)] == \
        [b.bucket_for(n) for n in range(1, 17)]


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_admission_queue_close_and_deadline_semantics(impl):
    # the port's queue and the JAX ring buffer it ports, step for step
    if impl == "port":
        q, done = _queue.AdmissionQueue(2), _queue.DONE
    else:
        q, done = jpipeline.RingBuffer(2), jpipeline._DONE
    assert q.put(1) and q.put(2)
    assert not q.put(3, timeout=0.05)          # full: backpressure
    assert q.get_available(5) == [1, 2]
    assert q.get_available(5) == []
    q.put(4)
    q.close()
    assert not q.put(5)                         # closed: refused
    assert q.get() == 4                         # drains first
    assert q.get() is done


@pytest.mark.parametrize("model", ["causal_lm", "seq2seq"])
def test_default_device_needs_a_card(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if model == "causal_lm":
            clm.CausalLMGenerativeModel(tr.TransformerConfig.tiny(),
                                        init_fresh=True, **GEOMETRY)
        else:
            tr.TransformerGenerativeModel(tr.TransformerConfig.tiny(), 8,
                                          init_fresh=True)


def test_int8_head_weights_follow_the_embedding():
    cfg = tr.TransformerConfig.tiny()
    m = clm.CausalLMGenerativeModel(cfg, init_fresh=True, int8=True,
                                    device="cpu", **GEOMETRY)
    wq, scale = tr.build_int8_logits_weights(m.stack.shared_embedding)
    assert torch.equal(m.wq, wq) and torch.equal(m.w_scale, scale)
    h = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(0))
    deq = h @ (m.wq.float() * m.w_scale)
    # int8 rounding of h and of the weights: a few percent of a logit
    np.testing.assert_allclose(m.logits_head(h).numpy(), deq.numpy(),
                               rtol=0.05, atol=0.05)
