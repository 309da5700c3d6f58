"""The port's training path against the JAX package's, on the CPU.

Both packages start from the same train state: a JAX init (`init_train_state`)
carried across leaf by leaf onto the port's tree (`_carry`), whose leaf names
are the JAX package's. The JAX side runs as its own tests run it: the train
step jitted with no mesh. Sizes: the JAX tests' `TINY` (vocabulary 256, 32
positions, width 64, 2 layers, 4 heads, float32) and `moe-tiny`'s shape.

Tolerances, with their reasons (both sides float32 on the CPU; the two
libraries sum in other orders):

- `lm_loss` within 1e-6 of JAX's on the same logits;
- the schedule equal to optax's at warmup 1 and decay 4; at other
  schedules within 2 float32 ulp (rtol 2.5e-7, and atol 2.5e-7 of the
  peak rate where the cosine nears 0): torch's and XLA's float32 cos round
  differently;
- a step's loss within rtol 1e-6 and its `grad_norm` within rtol 1e-6;
  every gradient within atol 1e-6 + rtol 1e-5 (the forward's sums in
  another order); the first moments within atol 1e-6 + rtol 1e-4, the
  second within atol 1e-10 + rtol 1e-4 (each the gradients' square); the
  counts and the step equal;
- the parameters within atol 2e-5 + rtol 1e-5 after 4 steps at lr 1e-2:
  Adam divides each moment by the root of the second one, so where a
  gradient sits at float noise (the attention's key bias, whose gradient
  is 0 in exact arithmetic: softmax ignores a shift of every score) the
  update is about +-lr either way. `params/blocks/attn/bqkv` is bounded by
  lr x (the steps that move parameters) instead;
- remat against no remat within 1e-5 (loss) and bit for bit (gradients);
- `moe_mlp`'s routing makes MoE gradients of dropped tokens exact zeros on
  both sides; MoE logits within atol 1e-5 (the expert products' summation
  order), aux and `moe_balance` within 1e-6;
- checkpoint and export files byte-equal for equal leaves; the port's
  interrupted-and-resumed `fit` bit-equal to its straight `fit`; state
  after a resume across the packages as after the same steps above;
- served greedy answers byte-equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_carry
import torch_threads  # noqa: F401 (caps torch's threads)

from distributed_lms_raft_llm_tpu.engine import EngineConfig as JaxConfig
from distributed_lms_raft_llm_tpu.engine import PagedEngine as JaxPaged
from distributed_lms_raft_llm_tpu.engine import SamplingParams as JaxSampling
from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.train import checkpoint as jax_ckpt
from distributed_lms_raft_llm_tpu.train import data as jax_data
from distributed_lms_raft_llm_tpu.train import train as jax_train
from distributed_lms_raft_llm_tpu.utils import pdf as jax_pdf
from distributed_lms_raft_llm_tpu_torch.engine import (
    EngineConfig,
    PagedEngine,
    SamplingParams,
)
from distributed_lms_raft_llm_tpu_torch.models import convert, gpt2, moe
from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt
from distributed_lms_raft_llm_tpu_torch.train import data
from distributed_lms_raft_llm_tpu_torch.train import train

REPO = Path(__file__).resolve().parent.parent

TINY_JAX = jax_gpt2.GPT2Config(
    vocab_size=256, max_position_embeddings=32, hidden_size=64,
    num_layers=2, num_heads=4, dtype=jnp.float32)
TINY = gpt2.GPT2Config(
    vocab_size=256, max_position_embeddings=32, hidden_size=64,
    num_layers=2, num_heads=4, dtype=torch.float32,
    param_dtype=torch.float32)
MOE_JAX = jax_moe.GPT2MoEConfig.tiny(dtype=jnp.float32,
                                     param_dtype=jnp.float32)
MOE = moe.GPT2MoEConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
# The gradients' global norm here is ~1.4-2.4: idle never clips, active
# clips every step.
MAX_NORM = {"idle": 1e3, "active": 0.1}
LOOSE = "params/blocks/attn/bqkv"  # the key bias: see the docstring


def _cfg(**kw):
    kw = dict(dict(learning_rate=1e-2, warmup_steps=1, decay_steps=8,
                   remat=False), **kw)
    return jax_train.TrainConfig(**kw)


def _batches(n, vocab=256, b=4, t=16, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, t)).astype(np.int32)
        yield {"input_ids": ids, "loss_mask": np.ones_like(ids, np.float32)}


def _jax_state(cfg, model_cfg, seed=0):
    opt = jax_train.make_optimizer(cfg)
    state = jax_train.init_train_state(jax.random.key(seed), model_cfg, opt)
    step = jax.jit(jax_train.make_train_step(
        model_cfg, opt, remat=False, moe_aux_weight=cfg.moe_aux_weight))
    return state, step


def _carry(jstate, model_cfg, cfg):
    """The JAX state as the port's: each leaf by its path."""
    flat = jax_ckpt._flatten(jstate)
    template = train.init_train_state(0, model_cfg,
                                      train.make_optimizer(cfg), "cpu")
    assert [k for k, _ in ckpt.flatten_with_paths(template)] == list(flat)
    return ckpt.map_with_paths(
        lambda k, leaf: convert.to_tensor(flat[k], leaf.dtype, "cpu")
        .requires_grad_(leaf.requires_grad), template)


def _flat(state):
    return {k: np.array(convert.to_host(v))
            for k, v in ckpt.flatten_with_paths(state)}


def _jax_grads(params, model_cfg, batch, aux_weight=0.01):
    ids = jnp.asarray(batch["input_ids"])
    mask = jnp.asarray(batch["loss_mask"])
    moe_cfg = isinstance(model_cfg, jax_moe.GPT2MoEConfig)

    def loss_fn(p):
        if moe_cfg:
            logits, aux = jax_moe.forward_with_aux(p, model_cfg, ids)
        else:
            (logits, _), aux = jax_gpt2.forward(p, model_cfg, ids), 0.0
        loss = jax_train.lm_loss(logits[:, :-1], ids[:, 1:], mask[:, 1:])
        return loss + aux_weight * aux

    return jax_ckpt._flatten(jax.grad(loss_fn)(params))


def _port_grads(params, model_cfg, batch, remat=False, aux_weight=0.01):
    names, leaves = zip(*ckpt.flatten_with_paths(params))
    ids = torch.as_tensor(batch["input_ids"]).long()
    mask = torch.as_tensor(batch["loss_mask"])
    is_moe = isinstance(model_cfg, moe.GPT2MoEConfig)
    out = gpt2.forward(params, model_cfg, ids, collect_moe_aux=is_moe,
                       remat=remat)
    loss = train.lm_loss(out[0][:, :-1], ids[:, 1:], mask[:, 1:])
    if is_moe:
        loss = loss + aux_weight * out[2]
    grads = torch.autograd.grad(loss, leaves)
    return loss, {n: g.numpy() for n, g in zip(names, grads)}


def _close(got, want, what, atol, rtol):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=what)


def _assert_states(jflat, pflat, steps, lr):
    assert list(jflat) == list(pflat)
    for k, want in jflat.items():
        got = pflat[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "step" or k.endswith("/count"):
            assert np.array_equal(got, want), k
        elif "/mu/" in k:
            _close(got, want, k, 1e-6, 1e-4)
        elif "/nu/" in k:
            _close(got, want, k, 1e-10, 1e-4)
        elif k == LOOSE:
            # The first step's rate is 0 (warmup 1): steps - 1 move.
            assert np.abs(got - want).max() <= lr * max(steps - 1, 0) + 1e-6
        else:
            _close(got, want, k, 2e-5, 1e-5)


# ------------------------------------------------------- loss, schedule


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.3
    want = float(jax_train.lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                                   jnp.asarray(mask)))
    got = float(train.lm_loss(torch.as_tensor(logits),
                              torch.as_tensor(targets),
                              torch.as_tensor(mask)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    empty = train.lm_loss(torch.as_tensor(logits), torch.as_tensor(targets),
                          torch.zeros(3, 7, dtype=torch.bool))
    assert float(empty) == 0.0  # the mask's sum is floored at 1


@pytest.mark.parametrize("warmup,decay,rtol", [(1, 4, 0.0),
                                               (7, 100, 2.5e-7),
                                               (0, 5, 2.5e-7)])
def test_schedule_matches_optax(warmup, decay, rtol):
    import optax

    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    opt = train.AdamW(learning_rate=3e-4, warmup_steps=warmup,
                      decay_steps=decay, weight_decay=0.01,
                      max_grad_norm=1.0)
    counts = range(decay + 3)
    got = [float(opt.schedule(torch.tensor(c, dtype=torch.int32)))
           for c in counts]
    want = [float(sched(jnp.int32(c))) for c in counts]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 3e-4)
    if warmup == 1:  # the zero first step the reference's optax gives
        assert got[:6] == pytest.approx([0.0, 3e-4, 2.25e-4, 7.5e-5, 0, 0],
                                        rel=1e-6)


def test_optimizer_refuses_an_empty_cosine():
    with pytest.raises(ValueError, match="positive decay_steps"):
        train.make_optimizer(train.TrainConfig(warmup_steps=4,
                                               decay_steps=4))


# ------------------------------------------------------------ the step


@pytest.mark.parametrize("clip", sorted(MAX_NORM))
@pytest.mark.parametrize("steps", [1, 4])
def test_train_steps_match_jax(steps, clip):
    cfg = _cfg(max_grad_norm=MAX_NORM[clip])
    jstate, jstep = _jax_state(cfg, TINY_JAX)
    pstate = _carry(jstate, TINY, cfg)
    start = _flat(pstate)
    pstep = train.make_train_step(TINY, train.make_optimizer(cfg),
                                  remat=False)
    for batch in _batches(steps):
        want = _jax_grads(jstate["params"], TINY_JAX, batch)
        _, got = _port_grads(pstate["params"], TINY, batch)
        for k, g in want.items():
            _close(got[k], g, f"gradient {k}", 1e-6, 1e-5)
        jstate, jm = jstep(jstate, batch)
        pstate, pm = pstep(pstate, batch)
        _close(float(pm["loss"]), float(jm["loss"]), "loss", 0, 1e-6)
        _close(float(pm["grad_norm"]), float(jm["grad_norm"]), "grad_norm",
               0, 1e-6)
        clipped = float(jm["grad_norm"]) >= cfg.max_grad_norm
        assert clipped == (clip == "active")
    _assert_states(jax_ckpt._flatten(jstate), _flat(pstate), steps,
                   cfg.learning_rate)
    if steps == 1:
        # Step 1 reads the schedule at count 0: rate 0, no parameter
        # moves, while both moments took the gradient.
        after = _flat(pstate)
        for k, v in start.items():
            if k.startswith("params/"):
                assert np.array_equal(after[k], v), k
        assert np.abs(after["opt_state/1/0/mu/wte"]).max() > 0
        assert int(after["opt_state/1/0/count"]) == 1
        assert int(after["opt_state/1/2/count"]) == 1


def test_state_layout_is_the_references():
    """51 leaves at this size: the params, optax's counts, mu and nu, and
    step; counts and step int32 scalars."""
    cfg = _cfg()
    pstate = train.init_train_state(0, TINY, train.make_optimizer(cfg),
                                    "cpu")
    flat = _flat(pstate)
    assert len(flat) == 51
    assert [k for k in flat if not k.startswith(("params/", "opt_state/1/0/m",
                                                 "opt_state/1/0/n"))] == [
        "opt_state/1/0/count", "opt_state/1/2/count", "step"]
    for k in ("opt_state/1/0/count", "opt_state/1/2/count", "step"):
        assert flat[k].dtype == np.int32 and flat[k].shape == ()
    jstate, _ = _jax_state(cfg, TINY_JAX)
    assert list(jax_ckpt._flatten(jstate)) == list(flat)


def test_remat_matches_no_remat():
    cfg = _cfg()
    jstate, _ = _jax_state(cfg, TINY_JAX, seed=1)
    params = _carry(jstate, TINY, cfg)["params"]
    batch = next(_batches(1, seed=3))
    loss0, g0 = _port_grads(params, TINY, batch, remat=False)
    loss1, g1 = _port_grads(params, TINY, batch, remat=True)
    assert abs(float(loss0.detach()) - float(loss1.detach())) < 1e-5
    for k in g0:
        assert np.array_equal(g0[k], g1[k]), k


def test_remat_and_aux_are_full_sequence_options():
    params = gpt2.init_params(TINY, 0, "cpu")
    cache = gpt2.init_cache(TINY, 1, 8, device="cpu")
    ids = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="collect_moe_aux is a full-sequence"):
        gpt2.forward(params, TINY, ids, cache, collect_moe_aux=True)
    with pytest.raises(ValueError, match="remat is a full-sequence"):
        gpt2.forward(params, TINY, ids, cache, remat=True)


def test_loss_falls_on_a_repetitive_corpus():
    """`tests/test_train.py`'s corpus, on one device."""
    cfg = jax_train.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                remat=True)
    opt = train.make_optimizer(cfg)
    state = train.init_train_state(0, TINY, opt, "cpu")
    step = train.make_train_step(TINY, opt, remat=True)
    seq = np.tile(np.arange(16, dtype=np.int32), (8, 2))
    batch = {"input_ids": seq, "loss_mask": np.ones_like(seq, np.float32)}
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses
    assert float(metrics["grad_norm"]) > 0


# ------------------------------------------------------------------ MoE


def test_moe_forward_with_aux_matches_jax():
    params = jax_moe.init_params(jax.random.key(0), MOE_JAX)
    ids = np.array(jax.random.randint(jax.random.key(8), (2, 10), 0,
                                      MOE.vocab_size))
    want, want_aux = jax_moe.forward_with_aux(params, MOE_JAX,
                                              jnp.asarray(ids))
    pparams = convert.params_from_jax(jax.device_get(params), device="cpu")
    got, aux = moe.forward_with_aux(pparams, MOE,
                                    torch.as_tensor(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert 0.9 <= float(aux) <= MOE.num_experts
    # Through gpt2.forward, the serving trunk: equal logits.
    plain, _ = moe.forward(pparams, MOE, torch.as_tensor(ids).long())
    assert torch.equal(plain, got)


def test_moe_train_step_matches_jax():
    cfg = _cfg()
    batch = next(_batches(1, vocab=MOE.vocab_size, b=2, t=12, seed=4))
    jstate, jstep = _jax_state(cfg, MOE_JAX)
    pstate = _carry(jstate, MOE, cfg)
    want = _jax_grads(jstate["params"], MOE_JAX, batch)
    _, got = _port_grads(pstate["params"], MOE, batch)
    for k, g in want.items():
        _close(got[k], g, f"gradient {k}", 1e-6, 1e-5)
    assert np.abs(got["blocks/moe/wr"]).max() > 0  # the router learns
    jstate, jm = jstep(jstate, batch)
    pstate, pm = train.make_train_step(MOE, train.make_optimizer(cfg),
                                       remat=False)(pstate, batch)
    _close(float(pm["loss"]), float(jm["loss"]), "loss", 0, 1e-6)
    _close(float(pm["grad_norm"]), float(jm["grad_norm"]), "grad_norm", 0,
           1e-6)
    assert abs(float(pm["moe_balance"]) - float(jm["moe_balance"])) <= 1e-6
    _assert_states(jax_ckpt._flatten(jstate), _flat(pstate), 1,
                   cfg.learning_rate)


def test_trainer_refuses_llama():
    from distributed_lms_raft_llm_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32,
                                 param_dtype=torch.float32)
    opt = train.make_optimizer(_cfg())
    for build in (lambda: train.init_train_state(0, cfg, opt, "cpu"),
                  lambda: train.make_train_step(cfg, opt)):
        with pytest.raises(ValueError, match="GPT-2 and GPT-2-MoE"):
            build()


# ----------------------------------------------------------------- data


_carried_train = torch_carry.carry("test_train",
                                   modules=["train.data", "utils"])
test_port_train_pack_and_batches_deterministic = (
    _carried_train.test_pack_and_batches_deterministic)


class _ByteTok:
    eos_id = 0

    def encode(self, text):
        return [b % 251 + 1 for b in text.encode()]


def _corpus(directory: Path, repeat=40) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "notes.txt").write_text(
        "raft elects a leader by majority " * repeat)
    (directory / "b").mkdir(exist_ok=True)
    (directory / "b" / "slides.pdf").write_bytes(
        jax_pdf.make_pdf("consensus requires a quorum of acceptors " * 5))
    (directory / "b" / "readme.md").write_text("logs replicate in order\n")
    (directory / "ignore.bin").write_bytes(b"\x00\x01")
    return directory


def test_batches_equal_to_jax(tmp_path):
    root = _corpus(tmp_path / "course")
    assert data.load_corpus_texts([str(root)]) == \
        jax_data.load_corpus_texts([str(root)])
    for seed in (0, 3):
        cfg_p = data.DataConfig(batch_size=3, seq_len=16, seed=seed)
        cfg_j = jax_data.DataConfig(batch_size=3, seq_len=16, seed=seed)
        ours = data.PackedDataset.from_paths([str(root)], _ByteTok(), cfg_p)
        theirs = jax_data.PackedDataset.from_paths([str(root)], _ByteTok(),
                                                   cfg_j)
        assert ours.steps_per_epoch() == theirs.steps_per_epoch() > 1
        for epoch in range(3):
            a, b = list(ours.batches(epoch)), list(theirs.batches(epoch))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert sorted(x) == sorted(y)
                for k in x:
                    assert x[k].dtype == y[k].dtype
                    assert np.array_equal(x[k], y[k])


# ---------------------------------------------------------- checkpoints


def _trained_jax_state(steps=2, model_cfg=TINY_JAX, **kw):
    cfg = _cfg(**kw)
    jstate, jstep = _jax_state(cfg, model_cfg)
    vocab = model_cfg.vocab_size
    for batch in _batches(steps, vocab=vocab):
        jstate, _ = jstep(jstate, batch)
    return cfg, jstate, jstep


def test_save_is_byte_equal_to_jax(tmp_path):
    cfg, jstate, _ = _trained_jax_state()
    pstate = _carry(jstate, TINY, cfg)
    a, b = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_ckpt.save_train_state(a, jstate)
    ckpt.save_train_state(b, pstate)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert Path(a + ".json").read_bytes() == Path(b + ".json").read_bytes()
    assert ckpt.latest_step(b) == 2 and not Path(b + ".tmp").exists()
    meta = json.loads(Path(b + ".json").read_text())
    assert meta["leaves"] == sorted(_flat(pstate)) and len(meta["leaves"]) == 51


def test_restore_refuses_a_wrong_template(tmp_path):
    cfg, jstate, _ = _trained_jax_state(steps=1)
    path = str(tmp_path / "jax.safetensors")
    jax_ckpt.save_train_state(path, jstate)
    wide = gpt2.GPT2Config(vocab_size=256, max_position_embeddings=32,
                           hidden_size=32, num_layers=2, num_heads=4,
                           dtype=torch.float32, param_dtype=torch.float32)
    template = train.init_train_state(0, wide, train.make_optimizer(cfg),
                                      "cpu")
    with pytest.raises(ValueError, match="has shape"):
        ckpt.restore_train_state(path, template)
    template = train.init_train_state(0, TINY, train.make_optimizer(cfg),
                                      "cpu")
    template["params"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="missing leaf 'params/extra'"):
        ckpt.restore_train_state(path, template)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """Two steps in one package, saved; restored in the other, two more:
    the same state as four steps straight in the first one."""
    cfg = _cfg()
    opt = train.make_optimizer(cfg)
    jstate, jstep = _jax_state(cfg, TINY_JAX)
    pstate = _carry(jstate, TINY, cfg)
    pstep = train.make_train_step(TINY, opt, remat=False)
    batches = list(_batches(4, seed=7))
    path = str(tmp_path / "state.safetensors")
    if first == "jax":
        for b in batches[:2]:
            jstate, _ = jstep(jstate, b)
        jax_ckpt.save_train_state(path, jstate)
        resumed = ckpt.restore_train_state(
            path, train.init_train_state(0, TINY, opt, "cpu"))
        assert int(resumed["step"]) == 2
        for b in batches[2:]:
            resumed, _ = pstep(resumed, b)
        for b in batches[2:]:
            jstate, _ = jstep(jstate, b)
        _assert_states(jax_ckpt._flatten(jstate), _flat(resumed), 4,
                       cfg.learning_rate)
    else:
        for b in batches[:2]:
            pstate, _ = pstep(pstate, b)
        ckpt.save_train_state(path, pstate)
        template = jax.tree.map(
            np.asarray, jax.device_get(jax_train.init_train_state(
                jax.random.key(0), TINY_JAX, jax_train.make_optimizer(cfg))))
        resumed = jax_ckpt.restore_train_state(path, template)
        assert int(resumed["step"]) == 2
        for b in batches[2:]:
            resumed, _ = jstep(resumed, b)
        for b in batches[2:]:
            pstate, _ = pstep(pstate, b)
        _assert_states(jax_ckpt._flatten(resumed), _flat(pstate), 4,
                       cfg.learning_rate)


def _tiny_dataset():
    rng = np.random.default_rng(0)
    blocks = rng.integers(1, 250, (16, 16)).astype(np.int32)
    return data.PackedDataset(blocks, data.DataConfig(batch_size=8,
                                                      seq_len=16, seed=1))


def test_fit_resume_is_bit_exact(tmp_path):
    """The port's counterpart of the JAX package's slow
    `test_checkpoint_roundtrip_and_resume_bitexact`: an interrupted and
    resumed run equals a straight one, every leaf bit for bit."""
    ds = _tiny_dataset()
    cfg = train.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                            decay_steps=8, remat=False)
    a = train.fit("cpu", TINY, cfg, ds, epochs=2, seed=5)
    assert a["step"] == 2 * ds.steps_per_epoch()
    ck = str(tmp_path / "state.safetensors")
    b1 = train.fit("cpu", TINY, cfg, ds, epochs=1, seed=5,
                   checkpoint_path=ck)
    assert b1["step"] == ds.steps_per_epoch() == ckpt.latest_step(ck)
    b2 = train.fit("cpu", TINY, cfg, ds, epochs=2, seed=5,
                   checkpoint_path=ck)
    assert b2["step"] == a["step"] == ckpt.latest_step(ck)
    fa, fb = _flat(a["state"]), _flat(b2["state"])
    assert list(fa) == list(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k
    # log_every 10: each run logs its first step only.
    assert [h["step"] for h in a["history"]] == [1]
    assert [h["step"] for h in b2["history"]] == [3]
    assert all(np.isfinite(h["loss"]) and h["step_ms"] > 0
               for h in a["history"] + b2["history"])


# --------------------------------------------------------------- export


@pytest.mark.parametrize("family", ["gpt2", "moe"])
def test_export_is_byte_equal_to_jax(tmp_path, family):
    model_jax, model = (TINY_JAX, TINY) if family == "gpt2" else (MOE_JAX,
                                                                  MOE)
    cfg, jstate, _ = _trained_jax_state(steps=2, model_cfg=model_jax)
    pstate = _carry(jstate, model, cfg)
    a, b = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_ckpt.export_model(a, jstate)
    ckpt.export_model(b, pstate)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    sd = convert.load_safetensors(b)
    back = (convert.gpt2_params_from_hf(sd, model, device="cpu")
            if family == "gpt2" else moe.params_from_hf(sd, model, "cpu"))
    for (k, x), (_, y) in zip(ckpt.flatten_with_paths(back),
                              ckpt.flatten_with_paths(pstate["params"])):
        assert torch.equal(x, y.detach()), k
    ids = torch.arange(12)[None, :] % model.vocab_size
    with torch.no_grad():
        want = gpt2.forward(pstate["params"], model, ids)[0]
        got = gpt2.forward(back, model, ids)[0]
    assert torch.equal(got, want)


def test_gpt2_params_to_hf_takes_numpy_and_bf16(tmp_path):
    params = gpt2.init_params(TINY, 0, "cpu")
    as_np = {"wte": params["wte"].numpy(), "wpe": params["wpe"].numpy(),
             "lnf": {k: v.numpy() for k, v in params["lnf"].items()},
             "blocks": {g: {k: v.numpy() for k, v in grp.items()}
                        for g, grp in params["blocks"].items()}}
    a, b = convert.gpt2_params_to_hf(params), convert.gpt2_params_to_hf(as_np)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)
    bf = {"wte": params["wte"].bfloat16(), "wpe": params["wpe"],
          "lnf": params["lnf"], "blocks": params["blocks"]}
    path = str(tmp_path / "bf16.safetensors")
    convert.save_safetensors(path, convert.gpt2_params_to_hf(bf))
    back = convert.load_safetensors(path)
    assert np.array_equal(back["wte.weight"],
                          params["wte"].bfloat16().float().numpy())


_SERVE_PROMPTS = ["what is raft?", "hello world", "explain paging", "k",
                  "a longer question about logs"]


@pytest.mark.parametrize("preset", ["tiny", "moe-tiny"])
def test_trained_export_serves_like_jax(tmp_path, preset):
    """Three steps in each package from the same state, each package's
    export served by its own paged engine: the same greedy answers."""
    model_jax = (jax_gpt2.GPT2Config.tiny(dtype=jnp.float32)
                 if preset == "tiny" else MOE_JAX)
    model = (gpt2.GPT2Config.tiny(dtype=torch.float32,
                                  param_dtype=torch.float32)
             if preset == "tiny" else MOE)
    cfg = _cfg(learning_rate=3e-3)
    jstate, jstep = _jax_state(cfg, model_jax)
    pstate = _carry(jstate, model, cfg)
    pstep = train.make_train_step(model, train.make_optimizer(cfg),
                                  remat=False)
    for batch in _batches(3, vocab=model.vocab_size, seed=11):
        jstate, _ = jstep(jstate, batch)
        pstate, _ = pstep(pstate, batch)
    a, b = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_ckpt.export_model(a, jstate)
    ckpt.export_model(b, pstate)

    jeng = JaxPaged(JaxConfig(
        model=preset, checkpoint=a, batch_buckets=(1, 2, 4),
        dtype=jnp.float32, param_dtype=jnp.float32, length_buckets=(16,),
        sampling=JaxSampling.greedy(max_new_tokens=8)), slots=3)
    eng = PagedEngine(EngineConfig(
        model=preset, checkpoint=b, batch_buckets=(1, 2, 4),
        dtype=torch.float32, param_dtype=torch.float32, device="cpu",
        length_buckets=(16,), sampling=SamplingParams.greedy(
            max_new_tokens=8)), slots=3)
    answers = []
    for e in (jeng, eng):
        rids = [e.submit(p) for p in _SERVE_PROMPTS]
        out = e.drain()
        answers.append([out[r] for r in rids])
    assert answers[0] == answers[1]
    assert any(answers[1])


# ------------------------------------------------------------------ CLI


def _run_cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "distributed_lms_raft_llm_tpu_torch.train.train",
         *args], cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=timeout)


def test_cli_trains_exports_and_resumes(tmp_path):
    root = _corpus(tmp_path / "course", repeat=8)
    ck, ex = str(tmp_path / "ck.safetensors"), str(tmp_path / "m.safetensors")
    base = ["--data", str(root), "--model", "tiny", "--device", "cpu",
            "--batch-size", "2", "--seq-len", "32", "--checkpoint", ck]
    first = _run_cli(*base, "--export", ex, "--epochs", "1")
    assert first.returncode == 0, first.stderr[-2000:]
    tok_blocks = data.pack_tokens(data.load_corpus_texts([str(root)]),
                                  _ByteTokLike(), 32)
    per_epoch = len(tok_blocks) // 2
    assert ckpt.latest_step(ck) == per_epoch > 2
    assert f"trained to step {per_epoch}:" in first.stdout
    sd = convert.load_safetensors(ex)
    params = convert.gpt2_params_from_hf(sd, gpt2.GPT2Config.tiny(),
                                         device="cpu")
    assert params["wte"].shape == (384, 32)
    state = convert.load_safetensors(ck)
    assert all(np.array_equal(sd[f"h.{i}.attn.c_attn.weight"],
                              state["params/blocks/attn/wqkv"][i])
               for i in range(2))
    second = _run_cli(*base, "--epochs", "2")
    assert second.returncode == 0, second.stderr[-2000:]
    assert f"resumed from {ck} at step {per_epoch}" in second.stderr
    assert ckpt.latest_step(ck) == 2 * per_epoch
    assert f"trained to step {2 * per_epoch}:" in second.stdout


class _ByteTokLike:
    """The CLI's byte fallback (`utils.tokenizer.ByteTokenizer`): bytes,
    EOS 256."""

    eos_id = 256

    def encode(self, text):
        return list(text.encode("utf-8"))


@pytest.mark.parametrize("flag,model,error,match", [
    # One process: the JAX CLI's make_mesh refusal of the layout.
    ("--tp", "tiny", ValueError, r"^1 devices not divisible by 2$"),
    ("--sp", "tiny", ValueError, r"^1 devices not divisible by 2$"),
    ("--pp", "tiny", ValueError, r"^1 devices not divisible by 2$"),
    ("--ep", "moe-tiny", ValueError, r"^1 devices not divisible by 2$"),
    ("--ep", "tiny", SystemExit, None),
])
def test_cli_refuses_parallel_axes(tmp_path, capsys, flag, model, error,
                                   match):
    argv = ["--data", str(tmp_path), "--model", model, "--device", "cpu",
            flag, "2"]
    with pytest.raises(error, match=match):
        train.main(argv)
    if error is SystemExit:  # the reference's own parser.error
        assert "--ep 2 requires an MoE model preset" in capsys.readouterr().err


def test_cli_refuses_llama(tmp_path):
    with pytest.raises(ValueError, match="GPT-2 and GPT-2-MoE"):
        train.main(["--data", str(tmp_path), "--model", "llama-tiny",
                    "--device", "cpu"])
