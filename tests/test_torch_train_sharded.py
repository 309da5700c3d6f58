"""The port's sharded trainer against the JAX package's, on the CPU.

Gloo rank pools of two and four processes (`tests/torch_tp_ranks.py`)
run `train.make_sharded_train_step` over the same axes as the JAX
package's `make_sharded_train_step` on its 8-virtual-device mesh, from the
same train state: the JAX init, saved by the JAX package's
`save_train_state` and restored by every rank as its slice (the port's
`restore_train_state` over a mesh). Sizes: tests/test_train.py's `TINY`
(vocabulary 256, width 64, 2 layers, 4 heads) and `moe-tiny` (width 32,
4 experts, top-2), float32, batches of 4 x 16 tokens under a ragged
`loss_mask` (about 70% ones, so the data ranks' counts differ).

Held, at dp 2, tp 2 x dp 2, pp 2 x dp 2, sp 2 x tp 2, ep 2 x tp 2 and
sp 2 x ep 2 (and pp 2 alone, remat on), with the tolerances of the JAX
package's own tests (tests/test_model_parallel.py: loss rtol 1e-5,
grad norm rtol 1e-4):

- each step's loss within 1e-5 and grad norm within 1e-4 (relative) of
  JAX's, the same on every rank (MoE: `moe_balance` within 1e-5);
- every leaf after 3 steps, gathered, within
  tests/test_torch_train.py's `_assert_states` tolerances of JAX's
  (the first step moves nothing under the warmup);
- each rank's leaves the slice `train_state_shardings` names (a pp stage
  half the layers, an ep rank half the experts, a tp rank half a
  column- or row-parallel leaf; Adam's moments as their parameter);
- the gradient all-reduce over the data axes: its bytes (every float32
  parameter of the rank, once per data axis);
- the ring's rotations: sp - 1 a layer forward, again in remat's
  recompute, and as many backward.

Also: the loss falling over 8 steps at tp 2 x dp 2 (tests/test_train.py's
test); JAX's refusals word for word (pp with MoE, sp and tp); the
vocabulary that tp does not divide; a pp-2 checkpoint holding the
one-device file's keys, shapes and dtypes, restored at pp 1 by the port
and by JAX's `restore_train_state`, equal to the ranks' gathered state;
`fit` at pp 2 interrupted and resumed equal to a straight run, bit for
bit; and the CLI at `--pp 2` and `--tp 2` over gloo in two processes
(torchrun's environment on a free port).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from test_torch_train import _assert_states, _corpus
from torch_tp_ranks import Ranks

from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.models import moe as jax_moe
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.train import checkpoint as jax_ckpt
from distributed_lms_raft_llm_tpu.train import train as jax_train
from distributed_lms_raft_llm_tpu_torch.models import convert, gpt2
from distributed_lms_raft_llm_tpu_torch.parallel import mesh
from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt
from distributed_lms_raft_llm_tpu_torch.train import train

REPO = Path(__file__).resolve().parent.parent
TINY_JAX = jax_gpt2.GPT2Config(
    vocab_size=256, max_position_embeddings=32, hidden_size=64,
    num_layers=2, num_heads=4, dtype=jax.numpy.float32)
MOE_JAX = jax_moe.GPT2MoEConfig.tiny(dtype=jax.numpy.float32,
                                     param_dtype=jax.numpy.float32)
VOCAB = {"tiny": 256, "moe-tiny": 384}
TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=8,
                remat=False, pp_micro=2)
STEPS = 3
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4  # tests/test_model_parallel.py's

# (model, axes, train overrides): every case of the issue's list, each
# axis' product the pool's world.
CASES = [
    ("tiny", {"dp": 2}, {}),
    ("tiny", {"pp": 2}, {"remat": True}),
    ("tiny", {"tp": 2, "dp": 2}, {}),
    ("tiny", {"pp": 2, "dp": 2}, {}),
    ("tiny", {"sp": 2, "tp": 2}, {"remat": True}),
    ("moe-tiny", {"ep": 2, "tp": 2}, {}),
    ("moe-tiny", {"sp": 2, "ep": 2}, {}),
    ("moe-tiny", {"dp": 2, "ep": 2}, {}),
]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools by world size, started on first use."""
    made = {}

    def get(world):
        if world not in made:
            made[world] = Ranks(world, tmp_path_factory.mktemp(
                f"train_rendezvous_{world}"))
        return made[world]

    yield get
    for ranks in made.values():
        ranks.close()


def _batches(vocab, n=STEPS, b=4, t=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, t)).astype(np.int32)
        mask = (rng.random((b, t)) < 0.7).astype(np.float32)
        out.append({"input_ids": ids, "loss_mask": mask})
    return out


def _jax_run(model, sizes, batches, train_kw, state_path):
    """JAX's sharded step at `sizes`: saves its initial state to
    `state_path`, then steps; (metrics, final flat state)."""
    cfg = MOE_JAX if model == "moe-tiny" else TINY_JAX
    world = int(np.prod(list(sizes.values())))
    m = jax_mesh.make_mesh(sizes, devices=jax.devices()[:world])
    step, state, shard = jax_train.make_sharded_train_step(
        m, cfg, jax_train.TrainConfig(**train_kw), jax.random.key(0))
    jax_ckpt.save_train_state(state_path, state)
    metrics = []
    with m:
        for b in batches:
            state, mt = step(state, {k: jax.device_put(v, shard[k])
                                     for k, v in b.items()})
            metrics.append({k: float(v) for k, v in mt.items()})
    return metrics, jax_ckpt._flatten(state)


def _world(sizes):
    return int(np.prod(list(sizes.values())))


@pytest.mark.parametrize("model,sizes,kw", CASES,
                         ids=[f"{m}-" + "x".join(f"{a}{n}" for a, n in
                                                  s.items())
                              for m, s, _ in CASES])
def test_sharded_step_matches_jax(pools, tmp_path, model, sizes, kw):
    train_kw = dict(TRAIN_KW, **kw)
    batches = _batches(VOCAB[model])
    path = str(tmp_path / "init.safetensors")
    jm, jflat = _jax_run(model, sizes, batches, train_kw, path)
    res = pools(_world(sizes)).run(
        "train", model=model, state_path=path, batches=batches,
        sizes=sizes, train_kw=train_kw)
    for r in res:
        assert r["metrics"] == res[0]["metrics"], "ranks disagree"
    for i, (got, want) in enumerate(zip(res[0]["metrics"], jm)):
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL), i
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=NORM_RTOL), i
        if model == "moe-tiny":
            assert got["moe_balance"] == pytest.approx(
                want["moe_balance"], rel=LOSS_RTOL), i
    # The clip is active: the JAX norms sit above max_grad_norm 1.0.
    assert any(w["grad_norm"] >= 1.0 for w in jm)
    _assert_states(jflat, res[0]["state"], STEPS, train_kw["learning_rate"])
    _check_slices(res, jflat, sizes)
    # The ring: sp - 1 rotations a layer forward (again in remat's
    # recompute) and as many backward, every step.
    sp = sizes.get("sp", 1)
    layers = (MOE_JAX if model == "moe-tiny" else TINY_JAX).num_layers
    fwd = STEPS * layers * (sp - 1)
    for r in res:
        assert r["ring"] == {"rotate": fwd * (2 if train_kw["remat"] else 1),
                             "rotate_backward": fwd}, r["ring"]


def _check_slices(res, jflat, sizes):
    """Each rank's leaves: the whole leaf cut by the axes its spec names;
    the data axes' all-reduce moved every parameter once an axis."""
    data_axes = sum(sizes.get(a, 1) > 1 for a in ("dp", "sp"))
    n_params = sum(v.size for k, v in jflat.items()
                   if k.startswith("params/"))
    for r in res:
        local, coords = r["local"], r["coords"]
        for key, shape in local.items():
            whole = jflat[key].shape
            leaf = key.split("/", 1)[1] if key.startswith("params/") else ""
            for prefix in ("opt_state/1/0/mu/", "opt_state/1/0/nu/"):
                if key.startswith(prefix):
                    leaf = key[len(prefix):]
            want = list(whole)
            if leaf.startswith("blocks/") and sizes.get("pp", 1) > 1:
                want[0] //= sizes["pp"]
            if leaf.startswith("blocks/moe/") and leaf[-2:] in ("wi", "wo",
                                                                "bi", "bo"):
                want[1] //= sizes.get("ep", 1)
            tp = sizes.get("tp", 1)
            if leaf in ("wte",):
                want[0] //= tp
            if leaf in ("blocks/attn/wqkv", "blocks/mlp/wi"):
                want[2] //= tp
            if leaf in ("blocks/attn/bqkv", "blocks/mlp/bi",
                        "blocks/attn/wo", "blocks/mlp/wo"):
                want[1] //= tp
            assert tuple(want) == tuple(shape), (key, shape, want)
        local_params = sum(int(np.prod(s)) for k, s in local.items()
                           if k.startswith("params/"))
        assert r["last"]["bytes"] == 4 * local_params * data_axes
        assert local_params <= n_params


def test_loss_decreases_at_tp2_dp2(pools):
    """tests/test_train.py's test, in the port: a repetitive corpus the
    model memorizes, 8 steps at tp 2 x dp 2 with remat."""
    seq = np.tile(np.arange(16, dtype=np.int32), (8, 2))
    batch = {"input_ids": seq, "loss_mask": np.ones_like(seq, np.float32)}
    res = pools(4).run("train", model="tiny", state_path=None,
                       batches=[batch] * 8, sizes={"tp": 2, "dp": 2},
                       train_kw=dict(learning_rate=1e-2, warmup_steps=1,
                                     remat=True))
    losses = [m["loss"] for m in res[0]["metrics"]]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses
    assert res[0]["metrics"][-1]["grad_norm"] > 0


@pytest.mark.parametrize("model,sizes", [
    ("moe-tiny", {"pp": 2, "ep": 2}), ("tiny", {"pp": 2, "sp": 2}),
    ("tiny", {"pp": 2, "tp": 2})])
def test_refusals_are_jaxs(model, sizes):
    cfg = MOE_JAX if model == "moe-tiny" else TINY_JAX
    world = _world(sizes)
    jm = jax_mesh.make_mesh(sizes, devices=jax.devices()[:world])
    with pytest.raises(ValueError) as want:
        jax_train.make_sharded_train_step(
            jm, cfg, jax_train.TrainConfig(warmup_steps=1),
            jax.random.key(0))
    port_cfg = {"tiny": _tiny(), "moe-tiny": _moe()}[model]
    with pytest.raises(ValueError) as got:
        train.make_sharded_train_step(
            mesh.make_mesh(sizes, world_size=world, rank=0, device="cpu"),
            port_cfg, train.TrainConfig(warmup_steps=1), 0)
    assert str(got.value) == str(want.value)


def _tiny(**kw):
    kw = dict(dict(vocab_size=256, max_position_embeddings=32,
                   hidden_size=64, num_layers=2, num_heads=4,
                   dtype=torch.float32, param_dtype=torch.float32), **kw)
    return gpt2.GPT2Config(**kw)


def _moe():
    from distributed_lms_raft_llm_tpu_torch.models import moe

    return moe.GPT2MoEConfig.tiny(dtype=torch.float32,
                                  param_dtype=torch.float32)


def test_tp_refuses_a_vocabulary_it_does_not_divide():
    """GPT-2's 50,257 rows at tp 2, at a tiny width: 255 rows."""
    with pytest.raises(ValueError, match="wte: axis 0 of size 255 does "
                       "not split over tp=2"):
        train.make_sharded_train_step(
            mesh.make_mesh({"tp": 2}, world_size=2, rank=1, device="cpu"),
            _tiny(vocab_size=255), train.TrainConfig(warmup_steps=1), 0)


def test_pp2_checkpoint_restores_at_pp1_and_in_jax(pools, tmp_path):
    batches = _batches(256)
    path = str(tmp_path / "init.safetensors")
    _jax_run("tiny", {"pp": 2}, batches[:1], TRAIN_KW, path)
    saved = str(tmp_path / "pp2.safetensors")
    res = pools(2).run("train", model="tiny", state_path=path,
                       batches=batches, sizes={"pp": 2}, train_kw=TRAIN_KW,
                       save=saved)
    gathered = res[0]["state"]
    one_device = convert.load_safetensors(path)
    file = convert.load_safetensors(saved)
    assert list(file) == list(one_device)
    for k, v in one_device.items():
        assert file[k].shape == v.shape and file[k].dtype == v.dtype, k
        assert np.array_equal(file[k], gathered[k]), k
    assert ckpt.latest_step(saved) == STEPS
    # The port at pp 1.
    opt = train.make_optimizer(train.TrainConfig(**TRAIN_KW))
    template = train.init_train_state(0, _tiny(), opt, "cpu")
    restored = ckpt.restore_train_state(saved, template)
    for k, v in ckpt.flatten_with_paths(restored):
        assert np.array_equal(convert.to_host(v), file[k]), k
    assert restored["params"]["wte"].requires_grad
    # JAX's restore_train_state.
    jtemplate = jax_train.init_train_state(
        jax.random.key(1), TINY_JAX, jax_train.make_optimizer(
            jax_train.TrainConfig(**TRAIN_KW)))
    jrestored = jax_ckpt._flatten(jax_ckpt.restore_train_state(
        saved, jtemplate))
    assert list(jrestored) == list(file)
    for k, v in jrestored.items():
        assert np.array_equal(v, file[k]), k
    # One more step at pp 1 from it within the tolerances of the pp-2
    # run's next step, which JAX's continuation stands for.
    step = train.make_train_step(_tiny(), opt, remat=False)
    _, m1 = step(restored, _batches(256, n=1, seed=9)[0])
    assert np.isfinite(float(m1["loss"]))


def test_fit_resumes_under_pp2(pools, tmp_path):
    """fit at pp 2: one epoch checkpointed, then resumed to two, equal to
    a straight two-epoch run bit for bit, leaf by leaf."""
    blocks = np.random.default_rng(0).integers(1, 250, (16, 16)).astype(
        np.int32)
    kw = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=8,
              remat=False, pp_micro=2)
    sizes = {"pp": 2}
    straight = pools(2).run("fit", data_blocks=blocks, sizes=sizes,
                            train_kw=kw, epochs=2)
    ck = str(tmp_path / "fit.safetensors")
    first = pools(2).run("fit", data_blocks=blocks, sizes=sizes,
                         train_kw=kw, epochs=1, ck=ck)
    assert first[0]["step"] == 2 == ckpt.latest_step(ck)
    resumed = pools(2).run("fit", data_blocks=blocks, sizes=sizes,
                           train_kw=kw, epochs=2, ck=ck)
    assert resumed[0]["step"] == straight[0]["step"] == 4
    a, b = straight[0]["state"], resumed[0]["state"]
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------------ CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cli_ranks(world, *args, timeout=300):
    """The trainer's CLI as `world` ranks, torchrun's environment set by
    hand (a free port on the loopback)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "distributed_lms_raft_llm_tpu_torch.train.train", *args],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


@pytest.mark.parametrize("flag", ["--pp", "--tp"])
def test_cli_trains_over_two_gloo_ranks(tmp_path, flag):
    root = _corpus(tmp_path / "course", repeat=8)
    ck, ex = str(tmp_path / "ck.safetensors"), str(tmp_path / "m.safetensors")
    runs = _run_cli_ranks(
        2, "--data", str(root), "--model", "tiny", "--device", "cpu",
        "--batch-size", "2", "--seq-len", "32", "--checkpoint", ck,
        "--export", ex, flag, "2", "--backend", "gloo", "--log-every", "1")
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
    assert "trained to step" in runs[0][1]
    assert "trained to step" not in runs[1][1]  # rank 0 reports
    steps = ckpt.latest_step(ck)
    assert steps and steps > 2
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32,
                               param_dtype=torch.float32)
    template = train.init_train_state(0, cfg, train.make_optimizer(
        train.TrainConfig(warmup_steps=1, decay_steps=4)), "cpu")
    state = convert.load_safetensors(ck)
    want = {k: tuple(v.shape) for k, v in ckpt.flatten_with_paths(template)}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert all(np.isfinite(v).all() for v in state.values())
    params = convert.gpt2_params_from_hf(convert.load_safetensors(ex), cfg,
                                         device="cpu")
    assert np.array_equal(params["blocks"]["attn"]["wqkv"].numpy(),
                          state["params/blocks/attn/wqkv"])


def test_cli_without_a_backend_refuses_under_torchrun(tmp_path):
    """WORLD_SIZE > 1 and no --backend: the error, never a backend chosen
    for the caller."""
    runs = _run_cli_ranks(1, "--data", str(tmp_path), "--model", "tiny",
                          "--device", "cpu", "--pp", "2", timeout=120)
    # One process told WORLD_SIZE=1 joins nothing and refuses the layout.
    assert runs[0][0] != 0
    assert "1 devices not divisible by 2" in runs[0][2]
    env = dict(os.environ, PYTHONPATH=str(REPO), WORLD_SIZE="2", RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_lms_raft_llm_tpu_torch.train."
         "train", "--data", str(tmp_path), "--model", "tiny", "--device",
         "cpu", "--pp", "2"], cwd=str(REPO), env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "pass the collective backend" in proc.stderr

