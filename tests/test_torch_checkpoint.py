"""The deployment's checkpoints and trained vocabularies in the port, on
the CPU.

`data/gpt2-local/{model.safetensors,vocab.json,merges.txt}` is what
configs/cluster.toml's tutoring node serves, and
`data/bert-local/{model.safetensors,vocab.txt}` what its relevance gate
loads (both built offline by scripts/make_local_checkpoint.py;
gitignored). Held against the JAX package on the GPT-2 files:

- the weights through the port's `convert.load_safetensors` and
  `gpt2_params_from_hf` equal the JAX loader's tree, and GPT-2 small's
  float32 logits over a framed question agree with JAX's forward within
  1e-5 of the logits' range (twelve layers of float32 sums in another
  order: about 7e-7 of it on a CPU);
- the port's greedy tokens (its engine, KV cache and all) are the argmax
  of JAX's logits at every step, teacher-forced in one JAX forward;
- the BPE encodes a mixed-script corpus to the same ids and decodes every
  id of the vocabulary to the same text, ids whose bytes end inside a
  UTF-8 character included (alone, and completed by the next id).

And on the BERT files: the weights through both packages' converters are
equal leaf for leaf, and the gate built on the checkpoint and the
WordPiece vocabulary in float32 embeds texts within 1e-5 of the JAX gate
(twelve layers of float32 sums in another order) and decides every pair
alike.

Every case runs on two sets of artifacts, one from each builder:

- the JAX package's: data/ where present, else (a fresh checkout: data/
  is gitignored) built once in a temporary directory with
  scripts/make_local_checkpoint.py's own builders;
- the port's: built once in a temporary directory with
  `distributed_lms_raft_llm_tpu_torch.tools.make_local_checkpoint`
  (its own trainers and weight draws, no `tokenizers` or
  `transformers`), on the CPU.

A built set is at a reduced size that takes seconds: the same full-size
models from seeded random weights, and vocabularies of REDUCED_VOCAB
trained on this checkout's text (its Markdown, the JAX package and the
tests: the builder's corpus without the system's files).
"""

import contextlib
import glob
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine.gate import (
    GateConfig as JaxGateConfig,
    RelevanceGate as JaxGate,
)
from distributed_lms_raft_llm_tpu.models import bert as jax_bert
from distributed_lms_raft_llm_tpu.models import convert as jax_convert
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.utils.tokenizer import (
    BPETokenizer as JaxBPE,
)
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    GateConfig,
    RelevanceGate,
    SamplingParams,
    TutoringEngine,
)
from distributed_lms_raft_llm_tpu_torch.models import bert, convert, gpt2
from distributed_lms_raft_llm_tpu_torch.serving.prompts import PROMPT_TEMPLATE
from distributed_lms_raft_llm_tpu_torch.tools import (
    make_local_checkpoint as port_builders,
)
from distributed_lms_raft_llm_tpu_torch.utils.tokenizer import BPETokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL = os.path.join(REPO, "data", "gpt2-local")
FILES = {name: os.path.join(LOCAL, name)
         for name in ("model.safetensors", "vocab.json", "merges.txt")}
BERT_LOCAL = os.path.join(REPO, "data", "bert-local")
BERT_FILES = {name: os.path.join(BERT_LOCAL, name)
              for name in ("model.safetensors", "vocab.txt")}


REDUCED_VOCAB = 8000


def _checkout_corpus(out_path: str, max_files: int = 400) -> str:
    """`build_corpus` of scripts/make_local_checkpoint.py over this
    checkout's files alone."""
    sources = []
    for pattern in (f"{REPO}/*.md",
                    f"{REPO}/distributed_lms_raft_llm_tpu/**/*.py",
                    f"{REPO}/tests/*.py"):
        sources.extend(sorted(glob.glob(pattern, recursive=True))[:max_files])
    with open(out_path, "w", encoding="utf-8") as out:
        for src in sources:
            with open(src, encoding="utf-8", errors="ignore") as f:
                out.write(f.read())
                out.write("\n")
    return out_path


BUILDERS = ("jax_script", "port_tool")


@contextlib.contextmanager
def local_artifacts(tmp_path_factory, files, builder, source):
    """`files` built by the named builder of `source`: the JAX script's
    (data/ where all exist) or the port's tool, into a temporary
    directory removed after the module."""
    out = tmp_path_factory.mktemp(f"{source}_{builder}")
    if source == "port_tool":
        getattr(port_builders, builder)(str(out), vocab_size=REDUCED_VOCAB,
                                        device="cpu", corpus="checkout")
    elif all(os.path.exists(p) for p in files.values()):
        out.rmdir()
        yield files
        return
    else:
        spec = importlib.util.spec_from_file_location(
            "make_local_checkpoint",
            os.path.join(REPO, "scripts", "make_local_checkpoint.py"))
        builders = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(builders)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(builders, "build_corpus", _checkout_corpus)
            getattr(builders, builder)(str(out), vocab_size=REDUCED_VOCAB)
    try:
        yield {name: str(out / name) for name in files}
    finally:
        shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module", params=BUILDERS)
def gpt2_files(request, tmp_path_factory):
    with local_artifacts(tmp_path_factory, FILES, "build_gpt2_local",
                         request.param) as f:
        yield f


@pytest.fixture(scope="module", params=BUILDERS)
def bert_files(request, tmp_path_factory):
    with local_artifacts(tmp_path_factory, BERT_FILES, "build_bert_local",
                         request.param) as f:
        yield f


CORPUS = [
    "What is the Raft consensus algorithm?",
    "  leading spaces, trailing spaces  \n\ttabs and\r\nnewlines\n\n",
    "Don't we'll they're I'm you've she'd it's",
    "numbers 3.14159 and 1,000,000 and 2026-10-17",
    "naïve café résumé über straße",
    "日本語のテキストと中文文本",
    "emoji 🙂🚀 and symbols ∑∫√ and ½",
    "mixed: αβγ δ, кириллица, עברית, العربية",
]
NEW_TOKENS = 8
ATOL_OF_RANGE = 1e-5


@pytest.fixture(scope="module")
def tokenizers(gpt2_files):
    files = gpt2_files
    return (BPETokenizer.from_files(files["vocab.json"], files["merges.txt"]),
            JaxBPE.from_files(files["vocab.json"], files["merges.txt"]))


@pytest.mark.parametrize("text", CORPUS)
def test_bpe_encodes_like_jax_and_round_trips(tokenizers, text):
    tok, jtok = tokenizers
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids) == text


def test_bpe_decodes_every_id_like_jax(tokenizers):
    tok, jtok = tokenizers
    assert tok.vocab_size == jtok.vocab_size
    assert (tok.eos_id, tok.pad_id) == (jtok.eos_id, jtok.pad_id)
    for i in range(tok.vocab_size):
        assert tok.decode([i]) == jtok.decode([i]), i


def test_bpe_ids_ending_inside_a_character(tokenizers):
    """Ids whose bytes end inside a UTF-8 character decode alike in both
    packages, alone and completed by an id that starts with the rest of
    the character; `decode_complete` drops exactly the cut character."""
    tok, jtok = tokenizers
    cut = [i for i in range(tok.vocab_size)
           if tok.decode_complete([i]) != tok.decode([i])]
    assert cut, "the trained vocabulary holds no id ending mid-character"
    for text in CORPUS:
        ids = tok.encode(text)
        for k in range(1, len(ids)):
            head = tok.decode(ids[:k])
            assert head == jtok.decode(ids[:k])
            if tok.decode_complete(ids[:k]) != head:
                # The id at k-1 ends inside a character the next completes.
                assert not text.startswith(head)
                assert text.startswith(tok.decode_complete(ids[:k]))
    completed = 0
    for i in cut[:200]:
        for j in range(tok.vocab_size):
            pair = [i, j]
            if tok.decode_complete(pair) == tok.decode(pair) and \
                    not tok.decode(pair).startswith(tok.decode([i])):
                assert tok.decode(pair) == jtok.decode(pair)
                completed += 1
                break
    assert completed > 0


@pytest.fixture(scope="module")
def models(gpt2_files):
    """The checkpoint in both packages at GPT-2 small's width, float32."""
    sd = convert.load_safetensors(gpt2_files["model.safetensors"])
    jsd = jax_convert.load_safetensors(gpt2_files["model.safetensors"])
    assert sorted(sd) == sorted(jsd)
    for name in sd:
        np.testing.assert_array_equal(sd[name], jsd[name])
    jcfg = jax_gpt2.GPT2Config.small(dtype=jnp.float32,
                                     param_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, jax_convert.gpt2_params_from_hf(jsd, jcfg))
    cfg = gpt2.GPT2Config.small(dtype=torch.float32,
                                param_dtype=torch.float32)
    params = convert.gpt2_params_from_hf(sd, cfg, device="cpu")
    return cfg, params, jcfg, jparams


def test_params_from_the_checkpoint_equal_jax(models):
    cfg, params, _, jparams = models
    assert (cfg.num_layers, cfg.hidden_size, cfg.vocab_size) == (12, 768,
                                                                50257)
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    port = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                port[path + (key,)] = value

    walk(params, ())
    assert len(flat) == len(port)
    for jpath, value in flat.items():
        key = tuple(p.key for p in jpath)
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(value))


def test_logits_and_greedy_tokens_equal_jax(models, tokenizers, gpt2_files):
    cfg, params, jcfg, jparams = models
    tok, _ = tokenizers
    prompt = PROMPT_TEMPLATE.format(query="How does Raft elect a leader?")
    ids = tok.encode(prompt)
    # The port's greedy answer through its serving engine (KV cache,
    # eager decode on the CPU).
    engine = TutoringEngine(EngineConfig(
        model="gpt2", checkpoint=gpt2_files["model.safetensors"],
        vocab_path=gpt2_files["vocab.json"],
        merges_path=gpt2_files["merges.txt"],
        sampling=SamplingParams.greedy(max_new_tokens=NEW_TOKENS),
        length_buckets=(64,), batch_buckets=(1,), dtype=torch.float32,
        param_dtype=torch.float32, device="cpu"))
    ids_b, mask, _ = engine.encode_prompts([prompt])
    res = engine.generate_ids(ids_b, mask)
    greedy = res.tokens[0, :int(res.lengths[0])].tolist()
    assert len(greedy) == NEW_TOKENS
    # Teacher-forced: both packages' logits over prompt + answer.
    seq = ids + greedy[:-1]
    with torch.no_grad():
        logits, _ = gpt2.forward(params, cfg, torch.tensor([seq]))
    jlogits, _ = jax.jit(
        lambda p, x: jax_gpt2.forward(p, jcfg, x))(jparams,
                                                  jnp.asarray([seq]))
    got = logits[0].numpy()
    want = np.asarray(jlogits)[0]
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_OF_RANGE * span)
    steps = want[len(ids) - 1:]
    assert [int(np.argmax(row)) for row in steps] == greedy
    assert [int(np.argmax(row)) for row in got[len(ids) - 1:]] == greedy


# ------------------------------------------- the relevance gate's BERT

GATE_QUESTIONS = ["How does Raft elect a leader?",
                  "What is a binary search tree?",
                  "Comment préparer une crème brûlée ?"]
GATE_CONTEXTS = [
    "Homework 3: implement leader election and log replication in Raft.",
    "Distributed systems, CS 451 notes, week 6: Raft keeps a replicated "
    "log consistent across servers by electing a leader for a term; the "
    "leader appends entries and replicates them to a majority before "
    "they commit. " * 3,
    "",
]


def test_bert_params_from_the_checkpoint_equal_jax(bert_files):
    sd = convert.load_safetensors(bert_files["model.safetensors"])
    jsd = jax_convert.load_safetensors(bert_files["model.safetensors"])
    assert sorted(sd) == sorted(jsd)
    jcfg = jax_bert.BertConfig.base_uncased()
    cfg = bert.BertConfig.base_uncased()
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jax_convert.bert_params_from_hf(jsd, jcfg))[0])
    port = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                port[path + (key,)] = value

    walk(convert.bert_params_from_hf(sd, cfg, device="cpu"), ())
    assert len(jflat) == len(port) == 17
    assert tuple(port[("blocks", "attn", "wqkv")].shape) == (12, 768, 2304)
    for jpath, value in jflat.items():
        key = tuple(p.key for p in jpath)
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(value))


def test_gate_on_the_checkpoint_equals_jax(bert_files):
    common = dict(model="bert-base-uncased",
                  checkpoint=bert_files["model.safetensors"],
                  vocab_path=bert_files["vocab.txt"])
    jgate = JaxGate(JaxGateConfig(dtype=jnp.float32, **common))
    gate = RelevanceGate(GateConfig(dtype=torch.float32, device="cpu",
                                    **common))
    assert gate.tokenizer.vocab_size == jgate.tokenizer.vocab_size <= 30522
    texts = GATE_QUESTIONS + GATE_CONTEXTS
    assert {gate._encode([t])[0].shape[1] for t in texts} == {64, 128}
    np.testing.assert_allclose(gate.embed_texts(texts),
                               jgate.embed_texts(texts), atol=1e-5, rtol=0)
    for q in GATE_QUESTIONS:
        for c in GATE_CONTEXTS:
            passed, sim = gate.check(q, c)
            jpassed, jsim = jgate.check(q, c)
            assert sim == pytest.approx(jsim, abs=1e-5)
            assert passed == jpassed
