"""Tensor-parallel ranks for the port's tp tests: `Ranks` starts `world`
processes that join one gloo process group through a `file://` rendezvous
(no fixed port: several pytest-xdist workers run at once) and then run
named cases on command, all ranks the same case at once, each returning its
own result. The processes live for a test module (spawning is the cost);
the parent holds the JAX references and compares.

The rank side (`CASES`) imports the port alone: no JAX in these processes.
Run directly (`python torch_tp_ranks.py RANK WORLD INIT`) it serves one
rank: pickled (case, kwargs) frames on stdin, pickled (ok, result) frames
on the original stdout (the process' own prints go to stderr).
"""

from __future__ import annotations

import os
import pickle
import select
import struct
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# Seconds a case may take on every rank before the parent gives up.
CASE_TIMEOUT = 120.0


def _write(fh, obj) -> None:
    data = pickle.dumps(obj)
    fh.write(struct.pack("<Q", len(data)) + data)
    fh.flush()


def _read_exact(fd: int, n: int, deadline: float) -> bytes:
    out = b""
    while len(out) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("rank did not answer in time")
        ready, _, _ = select.select([fd], [], [], left)
        if not ready:
            continue
        chunk = os.read(fd, n - len(out))
        if not chunk:
            raise EOFError("rank process exited")
        out += chunk
    return out


def _read(fd: int, deadline: float):
    (n,) = struct.unpack("<Q", _read_exact(fd, 8, deadline))
    return pickle.loads(_read_exact(fd, n, deadline))


class Ranks:
    """`world` rank processes joined over gloo; `run(case, **kw)` runs a
    case on all of them and returns their results in rank order (raising
    with the rank's traceback if one failed)."""

    def __init__(self, world: int, rendezvous_dir: Path):
        init = f"file://{rendezvous_dir / 'rendezvous'}"
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([str(REPO), str(HERE)]))
        self.procs = [
            subprocess.Popen(
                [sys.executable, str(HERE / "torch_tp_ranks.py"), str(r),
                 str(world), init],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
                cwd=str(REPO))
            for r in range(world)]

    def run(self, case: str, timeout: float = CASE_TIMEOUT, **kwargs):
        for p in self.procs:
            _write(p.stdin, (case, kwargs))
        deadline = time.monotonic() + timeout
        results = [_read(p.stdout.fileno(), deadline) for p in self.procs]
        for rank, (ok, value) in enumerate(results):
            if not ok:
                raise AssertionError(f"rank {rank} failed in {case}:\n{value}")
        return [value for _, value in results]

    def close(self) -> None:
        for p in self.procs:
            try:
                _write(p.stdin, None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


class _Device:
    """A stand-in device of host `slice_index` (JAX's CPU devices carry
    none, and `create_hybrid_device_mesh` groups by it)."""

    platform = device_kind = "cpu"

    def __init__(self, id_, host):
        self.id, self.slice_index = id_, host


def jax_hybrid_ranks(ici, dcn, local, n):
    """The parent's reference for `make_hybrid_mesh`: JAX's
    `create_hybrid_device_mesh` over `n` stand-in devices in hosts of
    `local`, as the array of device ids (= torchrun's ranks)."""
    import numpy as np
    from jax.experimental import mesh_utils

    from distributed_lms_raft_llm_tpu_torch.parallel.mesh import AXIS_ORDER

    devices = mesh_utils.create_hybrid_device_mesh(
        [ici.get(a, 1) for a in AXIS_ORDER],
        [dcn.get(a, 1) for a in AXIS_ORDER],
        devices=[_Device(i, i // local) for i in range(n)])
    return np.vectorize(lambda d: d.id)(devices)


# ------------------------------------------------------------ rank side


def _tp():
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    return mesh.make_mesh({"tp": -1}).tensor_parallel()


def _leader() -> bool:
    """Rank 0 of the group: the rank that takes an engine's calls."""
    from torch import distributed as dist

    return dist.get_rank() == 0


def _mesh(**sizes):
    """The mesh over every rank, tp taking what the other axes leave."""
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    return mesh.make_mesh(dict(sizes, tp=-1))


def case_forward(model: str, tree, ids):
    """The port's forward at tp = world on this rank's slice of `tree`
    (the whole parameter tree, dense or int8): full-sequence logits, and a
    cached prefill of all but the last id followed by a one-token decode
    step."""
    import dataclasses

    import torch

    from distributed_lms_raft_llm_tpu_torch.engine.engine import (
        EngineAxes,
        shard_for,
    )
    from distributed_lms_raft_llm_tpu_torch.models import registry

    tp = _tp()
    family, cfg = registry.resolve(model, torch.float32)
    cfg = dataclasses.replace(cfg, tensor_parallel=tp)
    params = shard_for(tree, family.name, EngineAxes(tp=tp))
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        full, _ = family.forward(params, cfg, ids)
        b, t = ids.shape
        cache = family.init_cache(cfg, b, t, dtype=torch.float32,
                                  device="cpu")
        pre, cache = family.forward(params, cfg, ids[:, :-1], cache=cache)
        step, _ = family.forward(params, cfg, ids[:, -1:], cache=cache)
    return {"full": full.numpy(), "prefill": pre.numpy(),
            "step": step.numpy(), "cache_heads": cache.k.shape[2]}


def _engine_config(model, tp, config_kw):
    """The case's EngineConfig: float32 on the CPU, greedy; tp (`tp` =
    None) is `config_kw`'s, else what the group's ranks leave after its ep
    and sp (dp takes what a given tp leaves)."""
    import torch
    from torch import distributed as dist

    from distributed_lms_raft_llm_tpu_torch.engine import (
        EngineConfig,
        SamplingParams,
    )

    kw = dict(config_kw)
    max_new = kw.pop("max_new", 8)
    kw.setdefault("batch_buckets", (1, 2))
    kw.setdefault("length_buckets", (4, 16))
    if tp is None:
        tp = kw.pop("tp", None) or dist.get_world_size() // (
            kw.get("ep", 1) * kw.get("sp", 1))
    return EngineConfig(model=model, dtype=torch.float32,
                        param_dtype=torch.float32, device="cpu", tp=tp,
                        sampling=SamplingParams.greedy(max_new_tokens=max_new),
                        **kw)


def _carry(eng, tree):
    from distributed_lms_raft_llm_tpu_torch.engine.engine import shard_for

    eng.params = shard_for(tree, eng.family.name, eng.axes)


def _follow_answers(eng, finals=None) -> dict:
    """A follower's loop over `eng`: the answers (rid -> text) its
    replayed steps returned; the final tokens of watched rids go into
    `finals` where given."""
    answers = {}

    def keep(name, result):
        if name == "step":
            answers.update(result)
        if finals is not None:
            finals.update(eng.pop_final_tokens())

    eng.follow(keep)
    return answers


def case_paged(model: str, tree, prompts, config_kw=None, engine_kw=None,
               warmup: bool = False):
    """Rank 0 submits `prompts` to a PagedEngine over every rank (tp x
    `config_kw`'s ep) and drains it; the other ranks follow. Every rank
    returns its answers by rid, its decision log, its KV bytes and its
    expert rows."""
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine

    eng = PagedEngine(_engine_config(model, None, config_kw or {}),
                      **(engine_kw or {}))
    _carry(eng, tree)
    if _leader():
        if warmup:
            eng.warmup()
        rids = [eng.submit(p) for p in prompts]
        out = eng.drain()
        answers = {r: out[r] for r in rids}
        kv = eng.kv_bytes_per_chip
        eng.stop_followers()
    else:
        answers = _follow_answers(eng)
        kv = eng.kv_bytes_per_chip
    return {"answers": answers, "decisions": list(eng.decisions),
            "kv_bytes_per_chip": kv, "kv_bytes_total": eng.kv_bytes_total,
            "tp": eng.tp, "ep": eng.ep, "dp": eng.dp,
            "cache_heads": eng.state.cache.k.shape[2],
            "experts": _expert_rows(eng.params)}


def _expert_rows(params):
    """The expert stacks' expert count on this rank (None: no experts)."""
    moe = params["blocks"].get("moe")
    if moe is None:
        return None
    wi = moe["wi"]
    return (wi["q"] if isinstance(wi, dict) else wi).shape[1]


def case_bucketed(model: str, tree, prompts, config_kw=None):
    """Rank 0 answers `prompts` with a TutoringEngine over every rank (tp x
    `config_kw`'s ep and sp); the other ranks follow. Every rank returns
    the answers it computed."""
    from distributed_lms_raft_llm_tpu_torch.engine import TutoringEngine

    eng = TutoringEngine(_engine_config(model, None, config_kw or {}))
    _carry(eng, tree)
    if _leader():
        answers = eng.answer_batch(prompts)
        eng.stop_followers()
        return answers
    results = []
    eng.follow(lambda name, result: results.append(result))
    return results[-1]


def case_queue(model: str, tree, prompts, config_kw=None, engine_kw=None):
    """A PagedQueue on rank 0 over a PagedEngine at tp = world (the other
    ranks follow): the answers and the tp gauges it sets."""
    import asyncio

    from distributed_lms_raft_llm_tpu_torch.engine import (
        PagedEngine,
        PagedQueue,
    )
    from distributed_lms_raft_llm_tpu_torch.utils.metrics import Metrics

    tp = _tp()
    eng = PagedEngine(_engine_config(model, tp.size, config_kw or {}),
                      **(engine_kw or {}))
    _carry(eng, tree)
    if not tp.leader:
        return sorted(_follow_answers(eng).values())
    metrics = Metrics()

    async def serve():
        queue = PagedQueue(eng, metrics=metrics)
        await queue.start()
        try:
            return await asyncio.gather(*(queue.submit(p) for p in prompts))
        finally:
            await queue.close()

    answers = asyncio.run(serve())
    eng.stop_followers()
    gauges = metrics.snapshot()["gauges"]
    return {"answers": answers, "serving_tp": gauges.get("serving_tp"),
            "serving_kv_bytes_per_chip":
                gauges.get("serving_kv_bytes_per_chip")}


def case_release_during_step(model: str, tree, prompts, config_kw=None,
                             engine_kw=None):
    """Rank 0 serves `prompts[:2]` as the turns of sessions s1 and s2 (each
    pinned in the radix tree at its finish), then streams the rest; while
    the first of those steps runs, another thread closes s1 and unwatches
    the first stream, as the node's event loop does while the queue's step
    runs in an executor thread. The other ranks follow. Every rank returns
    its answers by rid, decisions, pinned sessions in the tree's order, pin
    stats, watched rids and the rids whose final tokens it kept."""
    import threading

    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine

    tp = _tp()
    eng = PagedEngine(_engine_config(model, tp.size, config_kw or {}),
                      **(engine_kw or {}))
    _carry(eng, tree)
    finals = {}
    fired = []
    if tp.leader:
        for session, prompt in zip(("s1", "s2"), prompts[:2]):
            eng.mark_session(eng.submit(prompt), session, 600.0)
        answers = eng.drain()
        eng.session_pin_stats()  # as the queue does between steps
        streamed = [eng.submit(p) for p in prompts[2:]]
        for rid in streamed:
            eng.stream_watch(rid)
        step = eng._step_once

        def close_session_and_stream():
            fired.append((eng.release_session("s1"),
                          eng.stream_unwatch(streamed[0])))

        def step_once():
            if not fired:
                other = threading.Thread(target=close_session_and_stream)
                other.start()
                other.join()
            return step()

        eng._step_once = step_once
        answers.update(eng.drain())
        finals.update(eng.pop_final_tokens())
        eng.stop_followers()
    else:
        answers = _follow_answers(eng, finals)
    return {"answers": answers, "decisions": list(eng.decisions),
            "pins": list(eng.prefix_cache._session_pins),
            "pin_stats": (eng.prefix_cache.session_count,
                          eng.prefix_cache.session_pinned_blocks()),
            "watched": sorted(eng._stream_watch), "finals": sorted(finals),
            "fired": fired}


def case_follower_fails(model: str, tree, prompts):
    """The follower's replayed step raises (a fault on that rank alone):
    each rank returns the TensorParallelFailure it raised and how long it
    took, and rank 0 what a later call raised."""
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine
    from distributed_lms_raft_llm_tpu_torch.parallel import (
        TensorParallelFailure,
    )

    tp = _tp()
    eng = PagedEngine(_engine_config(model, tp.size, {}), slots=2, chunk=2)
    _carry(eng, tree)
    t0 = time.monotonic()
    out = {}
    try:
        if tp.leader:
            for prompt in prompts:
                eng.submit(prompt)
            eng.drain()
        else:
            def broken():
                raise RuntimeError("a fault on this rank alone")

            eng._step_once = broken
            eng.follow()
    except TensorParallelFailure as e:
        out = {"error": str(e), "seconds": time.monotonic() - t0}
    if tp.leader:
        try:
            eng.submit(prompts[0])
        except TensorParallelFailure as e:
            out["later"] = str(e)
    return out


def case_refusals():
    """What a tp engine refuses at construction over gloo: CUDA graphs."""
    from distributed_lms_raft_llm_tpu_torch.engine import PagedEngine

    tp = _tp()
    try:
        PagedEngine(_engine_config("tiny", tp.size, {}), cuda_graphs=True)
    except ValueError as e:
        return str(e)
    return None


def case_moe_forward(tree, ids, ep, dtype="float32"):
    """The MoE forward over every rank at `ep` (tp the rest) on this rank's
    slice of `tree`: full-sequence logits, a cached prefill of all but the
    last id and a one-token decode step, and this rank's expert count."""
    import dataclasses

    import torch

    from distributed_lms_raft_llm_tpu_torch.engine.engine import (
        EngineAxes,
        shard_cfg,
        shard_for,
    )
    from distributed_lms_raft_llm_tpu_torch.models import registry

    m = _mesh(ep=ep)
    axes = EngineAxes(tp=m.tensor_parallel(), ep=m.axis("ep"))
    family, cfg = registry.resolve("moe-tiny", getattr(torch, dtype))
    cfg = shard_cfg(dataclasses.replace(cfg, param_dtype=getattr(
        torch, dtype)), axes)
    params = shard_for(tree, family.name, axes)
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        full, _ = family.forward(params, cfg, ids)
        b, t = ids.shape
        cache = family.init_cache(cfg, b, t, dtype=cfg.dtype, device="cpu")
        pre, cache = family.forward(params, cfg, ids[:, :-1], cache=cache)
        step, _ = family.forward(params, cfg, ids[:, -1:], cache=cache)
    return {"full": full.float().numpy(), "prefill": pre.float().numpy(),
            "step": step.float().numpy(), "experts": _expert_rows(params),
            "coords": m.coords()}


def case_ring(q, k, v, sp):
    """`ring_attention` over every rank at `sp` (tp the rest): this rank
    takes its heads (tp) and its sequence shard (sp) of the whole q, k, v
    and returns its output block with its coordinates."""
    import torch

    from distributed_lms_raft_llm_tpu_torch.parallel.ring import (
        ring_attention,
    )

    m = _mesh(sp=sp)
    tp, spa = m.tensor_parallel(), m.axis("sp")
    h, t = q.shape[1] // tp.size, q.shape[2] // spa.size

    def mine(x):
        x = torch.as_tensor(x)
        return x[:, tp.rank * h:(tp.rank + 1) * h,
                 spa.rank * t:(spa.rank + 1) * t]

    out = ring_attention(mine(q), mine(k), mine(v), spa)
    return {"out": out.numpy(), "tp": tp.rank, "sp": spa.rank}


def case_ring_forward(model, tree, ids, cfg_kw, sp):
    """The ring forward over every rank at `sp` (tp the rest): each rank's
    logits block gathered over sp to the whole [B, T, V], and the messages
    a padding mask and explicit positions raise."""
    import dataclasses

    import torch

    from distributed_lms_raft_llm_tpu_torch.engine.engine import (
        EngineAxes,
        shard_for,
    )
    from distributed_lms_raft_llm_tpu_torch.models import registry

    m = _mesh(sp=sp)
    tp, spa = m.tensor_parallel(), m.axis("sp")
    family, cfg = registry.resolve(model, torch.float32)
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              tensor_parallel=tp, sequence_parallel=spa,
                              **cfg_kw)
    params = shard_for(tree, family.name, EngineAxes(tp=tp))
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        local, _ = family.forward(params, cfg, ids)
        errors = []
        for kw in (dict(kv_mask=torch.ones(ids.shape, dtype=torch.bool)),
                   dict(positions=torch.zeros_like(ids))):
            try:
                family.forward(params, cfg, ids, **kw)
            except ValueError as e:
                errors.append(str(e))
    return {"logits": spa.all_gather(local, dim=1).numpy(),
            "local_t": local.shape[1], "errors": errors}


def case_score(model, tree, texts, config_kw):
    """Rank 0 scores `texts` with a TutoringEngine over every rank at
    `config_kw`'s sp (tp the rest, or dp where it gives tp); the other
    ranks follow. Every rank returns the results it computed."""
    from distributed_lms_raft_llm_tpu_torch.engine import TutoringEngine

    eng = TutoringEngine(_engine_config(model, None, config_kw))
    _carry(eng, tree)
    if _leader():
        out = eng.score(texts)
        eng.stop_followers()
    else:
        results = []
        eng.follow(lambda name, result: results.append(result))
        out = results[-1]
    return {"scores": out, "shapes": eng.score_shapes, "dp": eng.dp}


def case_gate(tree, pairs, gate_kw):
    """Rank 0 checks `pairs` with a RelevanceGate over every rank (the
    default group) at `gate_kw`'s tp (every rank when it gives none; dp
    the rest), holding this rank's slice of the JAX gate's `tree`; the
    other ranks follow. Each returns its forwards count, rank 0 the
    (verdict, similarity) pairs too."""
    import torch
    from torch import distributed as dist

    from distributed_lms_raft_llm_tpu_torch.engine import (
        GateConfig,
        RelevanceGate,
    )
    from distributed_lms_raft_llm_tpu_torch.models import bert
    from distributed_lms_raft_llm_tpu_torch.parallel import partition

    kw = dict(gate_kw)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    kw.setdefault("tp", dist.get_world_size())
    gate = RelevanceGate(GateConfig(model="tiny", device="cpu", **kw))
    tp = gate.tensor_parallel
    gate.params = partition.shard_params(
        bert.cast_products(tree, gate.cfg.dtype),
        partition.slicing_rules("bert"), tp.rank, tp.size)
    out = {"word_rows": gate.params["embeddings"]["word"].shape[0]
           if not isinstance(gate.params["embeddings"]["word"], dict)
           else gate.params["embeddings"]["word"]["q"].shape[0]}
    if _leader():
        out["checks"] = [gate.check(q, c) for q, c in pairs]
        gate.stop_followers()
    else:
        gate.follow()
    out["forwards"] = gate.forwards
    return out


def case_hybrid_axes(layouts, local_world_size):
    """For each (ici, dcn) of `layouts`, `make_hybrid_mesh` over every rank
    with `LOCAL_WORLD_SIZE` set to `local_world_size` (torchrun's hosts):
    this rank's layout, coordinates and axis ranks, and for each axis of
    several ranks the all-reduce of 2 ** rank over its subgroup."""
    import torch
    from torch import distributed as dist

    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    out = []
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    try:
        for ici, dcn in layouts:
            m = mesh.make_hybrid_mesh(ici, dcn)
            sums = {}
            for name, n in m.shape.items():
                if n > 1:
                    x = torch.tensor([2.0 ** dist.get_rank()])
                    sums[name] = float(m.axis(name).all_reduce(x))
            out.append({"layout": m.layout, "coords": m.coords(),
                        "ranks": {a: m.axis_ranks(a) for a in m.shape},
                        "sums": sums})
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out


def _train_mesh(sizes):
    """The mesh of `sizes` (every axis given) over every rank, on the
    CPU."""
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    return mesh.make_mesh(sizes, device="cpu")


def _block(lp, h):
    """tests/test_pipeline.py's layer: RMS norm, dense, gelu, dense,
    residual."""
    import torch

    hn = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + 1e-6)
    return h + torch.nn.functional.gelu(hn @ lp["w"]) @ lp["w2"]


def case_pipeline(params, x, cot, sizes, n_micro, stage_sliced):
    """`pipeline_trunk` over `sizes` (pp and dp) on `_block`: this rank's
    output, and the gradients of sum(out * cot) with respect to x and to
    the params (whole, or this stage's slice with `stage_sliced`; under dp
    the rank pipelines its own rows of x)."""
    import torch

    from distributed_lms_raft_llm_tpu_torch.parallel import pipeline

    m = _train_mesh(sizes)
    pp, dp = m.axis("pp"), m.axis("dp")
    x, cot = torch.as_tensor(x), torch.as_tensor(cot)
    rows = x.shape[0] // dp.size
    x = x[dp.rank * rows:(dp.rank + 1) * rows].clone().requires_grad_(True)
    cot = cot[dp.rank * rows:(dp.rank + 1) * rows]
    tree = {}
    for k, v in params.items():
        v = torch.as_tensor(v)
        if stage_sliced:
            per = v.shape[0] // pp.size
            v = v[pp.rank * per:(pp.rank + 1) * per]
        tree[k] = v.clone().requires_grad_(True)
    pipeline.STATS.clear()
    out = pipeline.pipeline_trunk(_block, tree, x, m, n_micro=n_micro,
                                  stage_sliced=stage_sliced)
    grads = torch.autograd.grad((out * cot).sum(), [x] + list(tree.values()))
    return {"out": out.detach().numpy(), "gx": grads[0].numpy(),
            "gp": {k: g.numpy() for k, g in zip(tree, grads[1:])},
            "pp": pp.rank, "dp": dp.rank, "stats": dict(pipeline.STATS)}


def case_forward_pipelined(tree, ids, sizes, n_micro, remat=False):
    """`gpt2.forward_pipelined` of the tiny GPT-2 (float32, as many layers
    as `tree` stacks) over `sizes` on the whole `tree`: the logits of this
    rank's dp rows, and the gradient of their sum of squares with respect
    to wte."""
    import dataclasses

    import torch

    from distributed_lms_raft_llm_tpu_torch.models import gpt2

    m = _train_mesh(sizes)
    dp = m.axis("dp")
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32,
                               param_dtype=torch.float32)
    cfg = dataclasses.replace(cfg, num_layers=len(tree["blocks/ln1/scale"]))
    params = _tree_of(tree, requires_grad=True)
    ids = torch.as_tensor(ids).long()
    rows = ids.shape[0] // dp.size
    ids = ids[dp.rank * rows:(dp.rank + 1) * rows]
    logits = gpt2.forward_pipelined(params, cfg, ids, m, n_micro=n_micro,
                                    remat=remat)
    (g,) = torch.autograd.grad((logits * logits).sum(), [params["wte"]])
    return {"logits": logits.detach().numpy(), "g_wte": g.numpy(),
            "dp": dp.rank}


def _tree_of(flat, requires_grad=False):
    import torch

    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.as_tensor(value).clone().requires_grad_(
            requires_grad)
    return tree


def _model_cfg(model):
    import torch

    from distributed_lms_raft_llm_tpu_torch.models import gpt2, moe

    if model == "moe-tiny":
        return moe.GPT2MoEConfig.tiny(dtype=torch.float32,
                                      param_dtype=torch.float32)
    return gpt2.GPT2Config(vocab_size=256, max_position_embeddings=32,
                           hidden_size=64, num_layers=2, num_heads=4,
                           dtype=torch.float32, param_dtype=torch.float32)


def case_train(model, state_path, batches, sizes, train_kw, save=None):
    """The port's sharded train step over `sizes`, from the train state
    saved at `state_path` (the JAX package's file: every rank keeps its
    slice; None: the port's seeded init), through `batches` (global; each rank keeps its block): each
    step's loss, grad_norm and moe_balance (every rank's), the last step's
    gradient all-reduce, the ring's rotations forward and backward over
    the steps, the leaves a rank holds with their shapes, and on
    rank 0 the whole state after the steps, gathered. `save` writes the
    state there (every rank calls, rank 0 writes)."""
    from distributed_lms_raft_llm_tpu_torch.models import convert
    from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt
    from distributed_lms_raft_llm_tpu_torch.train import train

    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    m = _train_mesh(sizes)
    cfg = train.TrainConfig(**train_kw)
    step, state, slicer = train.make_sharded_train_step(
        m, _model_cfg(model), cfg, 0)
    mesh.STATS.clear()
    if state_path:
        state = ckpt.restore_train_state(state_path, state, m)
    metrics = []
    for batch in batches:
        state, mt = step(state, slicer(batch))
        metrics.append({k: float(v) for k, v in mt.items()})
    ring = {k: mesh.STATS[k] for k in ("rotate", "rotate_backward")}
    local = {k: tuple(v.shape) for k, v in ckpt.flatten_with_paths(state)}
    flat = ckpt._flatten(state, m)
    if save:
        ckpt.save_train_state(save, state, m)
    return {"metrics": metrics, "local": local, "last": dict(step.last),
            "coords": m.coords(), "ring": ring,
            "state": {k: convert.to_host(v) for k, v in flat.items()}
            if m.rank == 0 else None}


def case_train_refusals(model, sizes):
    """make_sharded_train_step's refusal over `sizes`, its message (None
    where it trains)."""
    from distributed_lms_raft_llm_tpu_torch.train import train

    try:
        train.make_sharded_train_step(
            _train_mesh(sizes), _model_cfg(model),
            train.TrainConfig(warmup_steps=1), 0)
    except ValueError as e:
        return str(e)
    return None


def case_fit(data_blocks, sizes, train_kw, epochs, ck=None, seed=5):
    """`fit` over `sizes` on a PackedDataset of `data_blocks`: the step
    reached and, on rank 0, the whole state gathered."""
    import numpy as np

    from distributed_lms_raft_llm_tpu_torch.models import convert
    from distributed_lms_raft_llm_tpu_torch.train import checkpoint as ckpt
    from distributed_lms_raft_llm_tpu_torch.train import data, train

    m = _train_mesh(sizes)
    ds = data.PackedDataset(np.asarray(data_blocks), data.DataConfig(
        batch_size=8, seq_len=16, seed=1))
    out = train.fit(m, _model_cfg("tiny"), train.TrainConfig(**train_kw),
                    ds, epochs=epochs, seed=seed, checkpoint_path=ck)
    flat = ckpt._flatten(out["state"], m)
    return {"step": out["step"],
            "state": {k: convert.to_host(v) for k, v in flat.items()}
            if m.rank == 0 else None}


CASES = {
    "forward": case_forward,
    "paged": case_paged,
    "bucketed": case_bucketed,
    "queue": case_queue,
    "refusals": case_refusals,
    "release_during_step": case_release_during_step,
    "follower_fails": case_follower_fails,
    "moe_forward": case_moe_forward,
    "ring": case_ring,
    "ring_forward": case_ring_forward,
    "score": case_score,
    "gate": case_gate,
    "hybrid_axes": case_hybrid_axes,
    "pipeline": case_pipeline,
    "forward_pipelined": case_forward_pipelined,
    "train": case_train,
    "train_refusals": case_train_refusals,
    "fit": case_fit,
}


def serve_rank(rank: int, world: int, init: str) -> None:
    """One rank: join the group, then run cases until a None frame."""
    out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    import torch

    torch.set_num_threads(1)
    from distributed_lms_raft_llm_tpu_torch.parallel import mesh

    mesh.init_process_group("gloo", init, world, rank)
    stdin = sys.stdin.buffer
    while True:
        head = stdin.read(8)
        if len(head) < 8:
            return
        (n,) = struct.unpack("<Q", head)
        msg = pickle.loads(stdin.read(n))
        if msg is None:
            return
        case, kwargs = msg
        try:
            _write(out, (True, CASES[case](**kwargs)))
        except BaseException:  # reported to the parent, which fails the test
            _write(out, (False, traceback.format_exc()))


if __name__ == "__main__":
    serve_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
