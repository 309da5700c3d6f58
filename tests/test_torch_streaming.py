"""The PyTorch port's streamed tutoring answers on the CPU, against JAX.

A tiny paged engine of each package holds the same weights (the JAX
engine's tree carried across with `params_from_jax`), float32, greedy.
Through each package's `TutoringService` (the cases of
tests/test_streaming.py, `_check_contract`):

- a fresh stream's deltas (offset, count, text, final, digest) are equal
  between the packages, assemble to the unary answer, and the digest is
  the sha256 of the stripped answer;
- a stream resumed at offset K is equal between the packages and delivers
  exactly the token suffix under the same digest;
- a session's turn 2, framed over turn 1's transcript, admits with a
  pinned prefix hit in both.

Each case runs under GPT-2's byte fallback and under a byte-level BPE
whose ids end inside UTF-8 characters (`full_byte_vocab`), where a
stream's decode is not prefix-stable at every token boundary and the queue
must hold a delta back. The hold-back and the bucketed queue's splitter
are also held against JAX's on scripted engines.
"""

import asyncio
import hashlib
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_lms_raft_llm_tpu.engine import BatchingQueue as JaxBatching
from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import PagedQueue as JaxQueue
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.engine.batcher import (
    split_stream_tokens as jax_split,
)
from distributed_lms_raft_llm_tpu.proto import lms_pb2 as jax_pb2
from distributed_lms_raft_llm_tpu.serving.tutoring_server import (
    TutoringService as JaxService,
)
from distributed_lms_raft_llm_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_lms_raft_llm_tpu.utils.tokenizer import (
    BPETokenizer as JaxBPE,
)
from distributed_lms_raft_llm_tpu_torch.engine import (
    BatchingQueue,
    EngineConfig,
    PagedEngine,
    PagedQueue,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.engine.batcher import (
    STREAM_CHUNK_TOKENS,
    split_stream_tokens,
)
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.proto import lms_pb2
from distributed_lms_raft_llm_tpu_torch.serving.prompts import (
    FOLLOWUP_TEMPLATE,
    PROMPT_TEMPLATE,
)
from distributed_lms_raft_llm_tpu_torch.serving.tutoring_server import (
    TutoringService,
)
from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics
from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import (
    BPETokenizer,
    full_byte_vocab,
)

MAX_NEW = 16
# Greedy (argmax) decoding with a repetition penalty: random tiny weights
# otherwise repeat one token, and an answer of one repeated id ends inside
# a UTF-8 character at every boundary or at none.
PENALTY = 3.0
QUERIES = ["what is paging?", "how does raft elect a leader?",
           "explain a b-tree", "why?"]
ENGINE_KW = dict(slots=2, chunk=2, prefix_cache=True, prefix_block_tokens=4,
                 prefix_cache_blocks=64)
VOCAB_SIZE = 384  # the tiny preset's vocabulary


def write_bpe(directory):
    """vocab.json + merges.txt of a byte-level BPE of the tiny preset's
    size whose multi-byte ids often end inside a UTF-8 character."""
    vocab = directory / "vocab.json"
    merges = directory / "merges.txt"
    vocab.write_text(json.dumps(full_byte_vocab(VOCAB_SIZE, seed=3)))
    merges.write_text("#version: 0.2\n")
    return str(vocab), str(merges)


def _build_pair(penalty=PENALTY, **files):
    """(JAX PagedEngine, port PagedEngine, a third engine on the same
    weights without a prefix cache that answers with token ids), all in
    float32 (the JAX engine's parameters too: with bf16 parameters its
    products round differently, and the penalty's near-ties part)."""
    common = dict(model="tiny", batch_buckets=(1, 2, 4),
                  length_buckets=(16, 32, 48), **files)
    jeng = JaxPaged(JaxConfig(
        dtype=jnp.float32, param_dtype=jnp.float32,
        sampling=JaxSampling.greedy(max_new_tokens=MAX_NEW,
                                    repetition_penalty=penalty),
        **common), **ENGINE_KW)
    config = EngineConfig(
        dtype=torch.float32, param_dtype=torch.float32, device="cpu",
        sampling=SamplingParams.greedy(max_new_tokens=MAX_NEW,
                                       repetition_penalty=penalty), **common)
    params = params_from_jax(jax.device_get(jeng.params), device="cpu")
    peng = PagedEngine(config, **ENGINE_KW)
    peng.params = params
    ids = PagedEngine(config, slots=2, chunk=2)
    ids.params = params
    assert peng.tokenizer.vocab_size == jeng.tokenizer.vocab_size
    return jeng, peng, ids


@pytest.fixture(scope="module", params=["bytes", "bpe"])
def pair(request, tmp_path_factory):
    """The engines under the byte fallback or the synthesized BPE."""
    if request.param == "bytes":
        return _build_pair()
    vocab, merges = write_bpe(tmp_path_factory.mktemp("bpe"))
    return _build_pair(vocab_path=vocab, merges_path=merges)


@pytest.fixture(scope="module")
def byte_pair():
    """The engines under the byte fallback without a penalty, for session
    turns: a session transcript is text, and turn 2's prompt must fit the
    tiny window with turn 1's ids at its head. The synthesized BPE has no
    merges, so an answer's text re-encodes into about three ids a token,
    and so does a byte answer holding invalid UTF-8 (what the penalty
    makes random weights emit): either overflows the window, whose tail is
    kept."""
    return _build_pair(penalty=1.0)


def _token_ids(engine, prompt):
    """The greedy answer's token ids (eos filtered), as a stream sees
    them."""
    rid = engine.submit(prompt)
    engine.stream_watch(rid)
    engine.drain()
    return engine.pop_final_tokens()[rid]


def _check_contract(chunks, start=0):
    """Monotone gap-free offsets from `start` and exactly one final chunk;
    returns (assembled text, final digest)."""
    assert chunks, "stream yielded nothing"
    delivered = start
    for ch in chunks:
        assert ch.success
        assert ch.offset == delivered, (
            f"offset gap: chunk at {ch.offset}, delivered {delivered}")
        delivered += ch.count
    assert [c.final for c in chunks].count(True) == 1
    assert chunks[-1].final
    return "".join(c.text for c in chunks), chunks[-1].digest


def _rows(chunks):
    return [(c.offset, c.count, c.text, c.final, c.digest) for c in chunks]


def _split_char_ends(rows, toks, tokenizer):
    """Ends of non-final deltas that fall inside a UTF-8 character of
    the answer `toks`."""
    return [off + n for off, n, _, final, _ in rows if not final
            and tokenizer.decode_complete(toks[:off + n])
            != tokenizer.decode(toks[:off + n])]


def _as_port_delivers(rows, toks, tokenizer):
    """JAX's deltas as the port delivers them: a JAX delta that ends
    inside a UTF-8 character is held back and merged into the next (the
    JAX rule delivers it, the port's does not; see
    test_jax_hold_back_delivers_a_split_character)."""
    out, carry = [], None
    for row in rows:
        if carry is not None:
            row = (carry[0], carry[1] + row[1], carry[2] + row[2], row[3],
                   row[4])
        carry = None
        end = row[0] + row[1]
        if not row[3] and (tokenizer.decode_complete(toks[:end])
                           != tokenizer.decode(toks[:end])):
            carry = row
            continue
        out.append(row)
    return out


def _hold_equal(got, want, toks, tokenizer):
    """The port's deltas are JAX's, but for JAX deltas that end inside a
    UTF-8 character: where JAX delivered one whose character a later
    token completes, its stream no longer assembles to its answer (the
    reference's fault); the port's always does."""
    assert not _split_char_ends(got, toks, tokenizer)
    jax_text = "".join(r[2] for r in want)
    port_text = "".join(r[2] for r in got)
    assert port_text == tokenizer.decode(toks)[
        len(tokenizer.decode(toks[:got[0][0]])):]
    if want[0][0] == 0 and jax_text != port_text:
        assert _split_char_ends(want, toks, tokenizer)
        return
    assert got == _as_port_delivers(want, toks, tokenizer)


def _serve(jeng, peng, body):
    """Run `body(service, pb2, metrics)` against each package's service
    over its PagedQueue; returns (JAX result, port result)."""

    async def one(service_cls, queue_cls, metrics_cls, engine, pb2):
        metrics = metrics_cls()
        queue = queue_cls(engine, metrics=metrics)
        await queue.start()
        try:
            return await body(service_cls(queue, metrics, node_id="n"), pb2,
                              metrics)
        finally:
            await queue.close()

    return (asyncio.run(one(JaxService, JaxQueue, JaxMetrics, jeng,
                            jax_pb2)),
            asyncio.run(one(TutoringService, PagedQueue, Metrics, peng,
                            lms_pb2)))


async def _stream(service, pb2, query, **kw):
    return [c async for c in service.StreamLLMAnswer(
        pb2.StreamRequest(token="tok", query=query, **kw), None)]


@pytest.mark.parametrize("query", QUERIES)
def test_stream_equals_unary_and_the_jax_node(pair, query):
    jeng, peng, ids = pair
    toks = _token_ids(ids, PROMPT_TEMPLATE.format(query=query))

    async def body(service, pb2, metrics):
        unary = await service.GetLLMAnswer(
            pb2.QueryRequest(token="tok", query=query), None)
        return unary.success, unary.response, await _stream(service, pb2,
                                                            query)

    (jok, junary, jchunks), (ok, unary, chunks) = _serve(jeng, peng, body)
    assert ok and jok and unary == junary
    full, digest = _check_contract(chunks)
    assert full.strip() == unary
    assert digest == hashlib.sha256(full.strip().encode()).hexdigest()
    assert chunks[-1].offset + chunks[-1].count == len(toks) > 0
    assert digest == jchunks[-1].digest
    _hold_equal(_rows(chunks), _rows(jchunks), toks, peng.tokenizer)


@pytest.mark.parametrize("at", ["two", "second_chunk", "half", "end"])
def test_resume_at_offset_gives_the_same_suffix(pair, at):
    jeng, peng, ids = pair
    query = QUERIES[1]
    toks = _token_ids(ids, PROMPT_TEMPLATE.format(query=query))
    tok = peng.tokenizer
    k = {"two": 2, "second_chunk": None, "half": len(toks) // 2,
         "end": len(toks)}[at]

    async def body(service, pb2, metrics):
        fresh = await _stream(service, pb2, query)
        at_k = fresh[min(1, len(fresh) - 1)].offset if k is None else k
        return fresh, at_k, await _stream(service, pb2, query,
                                          resume_offset=at_k)

    (jfresh, jk, jresumed), (fresh, k, resumed) = _serve(jeng, peng, body)
    full, digest = _check_contract(fresh)
    tail, rdigest = _check_contract(resumed, start=k)
    assert rdigest == digest == jresumed[-1].digest
    # Exactly the text of tokens [K, n): the answer less the text of
    # tokens [0, K).
    assert tail == tok.decode(toks)[len(tok.decode(toks[:k])):]
    _hold_equal(_rows(resumed), _rows(jresumed), toks, tok)


def test_session_turn2_admits_with_pinned_prefix_hit(byte_pair):
    """At the queue level, where a prompt fits the tiny window whole (the
    service's template overflows it and keeps the tail): turn 1 is
    published and session-pinned, and turn 2, framed over turn 1's
    transcript as the server frames follow-ups, admits with a prefix hit,
    in the port as in JAX."""
    jeng, peng, ids = byte_pair
    t1 = "Q: what is raft?\nA:"

    async def run(queue_cls, metrics_cls, engine):
        metrics = metrics_cls()
        queue = queue_cls(engine, metrics=metrics)
        await queue.start()
        try:
            d1 = [d async for d in queue.submit_stream(
                t1, session=("sess-1", 30.0))]
            pins = engine.session_pin_stats()
            hits0 = metrics.snapshot()["counters"].get(
                "prefix_cache_hit_tokens", 0)
            t2 = t1 + d1[-1].full_text + FOLLOWUP_TEMPLATE.format(query="why")
            d2 = [d async for d in queue.submit_stream(
                t2, session=("sess-1", 30.0))]
            snap = metrics.snapshot()
            return ([[(d.offset, d.count, d.text, d.final, d.full_text)
                      for d in ds] for ds in (d1, d2)], t2, pins,
                    snap["counters"]["prefix_cache_hit_tokens"] - hits0,
                    snap["gauges"]["session_pinned_blocks"])
        finally:
            await queue.close()

    (jturns, jt2, *jrest) = asyncio.run(run(JaxQueue, JaxMetrics, jeng))
    (turns, t2, *rest) = asyncio.run(run(PagedQueue, Metrics, peng))
    pins, hit, pinned = rest
    assert pins[0] == 1 and pins[1] > 0, "turn 1 must stay session-pinned"
    assert hit > 0, "turn 2 must admit with a hit on turn 1's transcript"
    assert pinned > 0
    assert rest == jrest and t2 == jt2
    for got, want, prompt in zip(turns, jturns, (t1, t2)):
        _hold_equal(got, want, _token_ids(ids, prompt), peng.tokenizer)


def test_session_turns_through_the_service(pair):
    """The service keeps one transcript per session and frames turn 2 over
    it with FOLLOWUP_TEMPLATE: `session_active` 1, as on a JAX node."""
    jeng, peng, ids = pair

    async def body(service, pb2, metrics):
        one = await _stream(service, pb2, "what is raft?", session_id="s")
        transcript1 = service._sessions["s"][0]
        two = await _stream(service, pb2, "and why?", session_id="s")
        return ([_rows(one), _rows(two)], transcript1,
                service._sessions["s"][0],
                metrics.snapshot()["gauges"]["session_active"])

    (jturns, *jrest), (turns, *rest) = _serve(jeng, peng, body)
    transcript1, transcript2, active = rest
    assert rest == jrest and active == 1.0
    prompt2 = transcript1 + FOLLOWUP_TEMPLATE.format(query="and why?")
    assert transcript2.startswith(prompt2)
    prompts = (PROMPT_TEMPLATE.format(query="what is raft?"), prompt2)
    for got, want, prompt in zip(turns, jturns, prompts):
        _hold_equal(got, want, _token_ids(ids, prompt), peng.tokenizer)


# --------------------------------------------- the hold-back, scripted


class _ScriptEngine:
    """A paged engine stand-in that emits a fixed token script one token a
    step through the stream channel (what both queues read), decoding
    with the given tokenizer."""

    def __init__(self, tokenizer, script):
        self.tokenizer = tokenizer
        self.script = list(script)
        self._work = {}
        self._watch = set()
        self._finals = {}
        self._rid = 0

    def submit(self, prompt):
        self._rid += 1
        self._work[self._rid] = []
        return self._rid

    @property
    def has_work(self):
        return bool(self._work)

    backlog = 0

    def cancel_pending(self, rid):
        return False

    def step(self):
        done = []
        for rid, toks in list(self._work.items()):
            toks.append(self.script[len(toks)])
            if len(toks) == len(self.script):
                del self._work[rid]
                if rid in self._watch:
                    self._finals[rid] = list(toks)
                done.append((rid, self.tokenizer.decode(toks)))
        return done

    def stream_watch(self, rid):
        self._watch.add(rid)

    def stream_unwatch(self, rid):
        self._watch.discard(rid)

    def stream_snapshot(self, rids):
        return {r: list(self._work[r]) for r in rids if r in self._work}

    def pop_final_tokens(self):
        out, self._finals = self._finals, {}
        return out

    def decode_tokens(self, tokens):
        return self.tokenizer.decode(list(tokens))

    def decode_complete(self, tokens):
        return self.tokenizer.decode_complete(list(tokens))

    def pop_ttfts(self):
        return {}

    def pop_program_times(self):
        return []

    def pop_dispatch_stats(self):
        return (0, 0, 0, 0.0, 0)

    def reset(self):
        self._work = {}


def _utf8_script():
    """(vocab, script): "ab" + the lead byte of "é", then its continuation
    byte + "c", "d", and the pair again: two token boundaries inside a
    UTF-8 character (after tokens 1 and 4)."""
    vocab = full_byte_vocab(300, seed=1)
    for piece in ("abÃ", "©c"):      # b"ab\xc3", b"\xa9c"
        vocab.setdefault(piece, len(vocab))
    return vocab, [vocab["abÃ"], vocab["©c"], ord("d"), vocab["abÃ"],
                   vocab["©c"]]


def _scripted_stream(queue_cls, tokenizer, script, resume=0):
    async def run():
        queue = queue_cls(_ScriptEngine(tokenizer, script))
        await queue.start()
        try:
            return [(d.offset, d.count, d.text, d.final, d.full_text)
                    async for d in queue.submit_stream(
                        "q", resume_offset=resume)]
        finally:
            await queue.close()

    return asyncio.run(run())


@pytest.mark.parametrize("resume", [0, 2, 3, 5])
def test_hold_back_at_a_token_inside_a_utf8_character(resume):
    vocab, script = _utf8_script()
    tok = BPETokenizer(vocab, [])
    assert tok.decode(script) == "abécdabéc"
    got = _scripted_stream(PagedQueue, tok, script, resume)
    # No delta ends after token 1 or 4 (inside "é"): the hold-back.
    ends = [off + n for off, n, *_ in got]
    assert 1 not in ends and 4 not in ends
    assert got[0][0] == resume and got[-1][3]
    assert got[-1][4] == "abécdabéc"
    skipped = tok.decode(script[:resume])
    assert "".join(text for _, _, text, _, _ in got) == \
        "abécdabéc"[len(skipped):]
    # Where JAX's delivered text holds no split character, the two
    # queues deliver the same deltas.
    want = _scripted_stream(JaxQueue, JaxBPE(vocab, []), script, resume)
    if not any(text.endswith("�") for _, _, text, final, _ in want
               if not final):
        assert got == want


def test_jax_hold_back_delivers_a_split_character():
    """The reference's rule (only "does the decode extend what was sent")
    delivers "ab" + U+FFFD after token 1, then cannot extend it and
    splices the rest one character off: its stream does not assemble to
    its own answer. The port holds that snapshot back."""
    vocab, script = _utf8_script()
    want = _scripted_stream(JaxQueue, JaxBPE(vocab, []), script)
    assert want[0][:3] == (0, 1, "ab�")
    assert "".join(d[2] for d in want) != want[-1][4]
    got = _scripted_stream(PagedQueue, BPETokenizer(vocab, []), script)
    assert "".join(d[2] for d in got) == got[-1][4] == want[-1][4]


# ------------------------------------- the bucketed queue's re-chunking


@settings(max_examples=200, deadline=None)
@given(st.text())
def test_split_stream_tokens_equals_jax(text):
    toks = split_stream_tokens(text)
    assert toks == jax_split(text)
    assert "".join(toks) == text


class _EchoEngine:
    """Answers each prompt with a fixed multi-word text."""

    def __init__(self):
        self.last_batch_ttfts = []

    def answer_batch(self, prompts):
        return [f" {p} " + " ".join(f"w{i}" for i in range(19)) + "\n"
                for p in prompts]


@pytest.mark.parametrize("resume", [0, 3, STREAM_CHUNK_TOKENS, 40])
def test_batching_queue_stream_equals_jax(resume):
    async def run(queue_cls):
        queue = queue_cls(_EchoEngine(), max_batch=2, max_wait_ms=1.0)
        await queue.start()
        try:
            return [(d.offset, d.count, d.text, d.final, d.full_text)
                    async for d in queue.submit_stream(
                        "hello there", resume_offset=resume)]
        finally:
            await queue.close()

    got = asyncio.run(run(BatchingQueue))
    assert got == asyncio.run(run(JaxBatching))
    n = len(split_stream_tokens(_EchoEngine().answer_batch(
        ["hello there"])[0]))
    assert got[-1][3] and got[0][0] == min(resume, n)
