"""The port's GPipe pipeline (`parallel/pipeline.py`) and
`gpt2.forward_pipelined`: gloo ranks on the CPU, held against the
sequential loop and against the JAX package on the same weights.

Two rank pools start once for the module (`tests/torch_tp_ranks.py`): two
ranks (pp 2) and four (pp 4, and pp 2 x dp 2). Held here, float32:

- `pipeline_trunk` on tests/test_pipeline.py's layer (8 layers, width 16)
  at pp 2 and 4 with n_micro 2, 4 and 8, the parameters whole or already
  sliced to the stage: the output equal on every stage and within 2e-5 of
  the sequential loop and of JAX's `pipeline_trunk` (test_pipeline's
  tolerance); the gradients of sum(out * cot) with respect to the input
  and every parameter within 2e-5 of the sequential loop's and of JAX's
  (`jax.vjp`), each stage's gradient zero outside its layers; the
  schedule's ticks n_micro + pp - 1 and its hops;
- JAX's two refusals, word for word;
- `forward_pipelined` of the tiny GPT-2 (4 layers) at pp 2 (n_micro 2)
  and pp 2 x dp 2 (remat on) within 2e-5 of JAX's `forward_pipelined` and
  of the port's `forward`, and the gradient of the logits' sum of squares
  with respect to the tied table (its embedding and unembedding parts)
  within 1e-4 relative of the sequential forward's; its refusal at tp 2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401 (caps torch's threads)
from torch_tp_ranks import Ranks

from distributed_lms_raft_llm_tpu.models import gpt2 as jax_gpt2
from distributed_lms_raft_llm_tpu.parallel import mesh as jax_mesh
from distributed_lms_raft_llm_tpu.parallel.pipeline import (
    pipeline_trunk as jax_pipeline_trunk,
)
from distributed_lms_raft_llm_tpu_torch.models import gpt2
from distributed_lms_raft_llm_tpu_torch.models.convert import params_from_jax
from distributed_lms_raft_llm_tpu_torch.parallel import mesh, pipeline

TOL = 2e-5  # tests/test_pipeline.py's
LAYERS, B, T, D = 8, 8, 4, 16


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools by world size, started on first use."""
    made = {}

    def get(world):
        if world not in made:
            made[world] = Ranks(world, tmp_path_factory.mktemp(
                f"pp_rendezvous_{world}"))
        return made[world]

    yield get
    for ranks in made.values():
        ranks.close()


def _jax_block(lp, h):
    hn = h * jax.lax.rsqrt(jnp.mean(h * h, axis=-1, keepdims=True) + 1e-6)
    return h + jax.nn.gelu(hn @ lp["w"], approximate=False) @ lp["w2"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "w": (rng.normal(size=(LAYERS, D, 2 * D)) * 0.1).astype(np.float32),
        "w2": (rng.normal(size=(LAYERS, 2 * D, D)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    cot = rng.normal(size=(B, T, D)).astype(np.float32)
    return params, x, cot


def _port_sequential(params, x, cot):
    """The sequential loop in the port, its output and gradients."""
    from torch_tp_ranks import _block

    tree = {k: torch.as_tensor(v).clone().requires_grad_(True)
            for k, v in params.items()}
    h = xt = torch.as_tensor(x).clone().requires_grad_(True)
    for i in range(LAYERS):
        h = _block({k: v[i] for k, v in tree.items()}, h)
    grads = torch.autograd.grad((h * torch.as_tensor(cot)).sum(),
                                [xt] + list(tree.values()))
    return (h.detach().numpy(), grads[0].numpy(),
            {k: g.numpy() for k, g in zip(tree, grads[1:])})


def _jax_pipeline(params, x, cot, pp, n_micro):
    m = jax_mesh.make_mesh({"pp": pp}, devices=jax.devices()[:pp])
    p = {k: jnp.asarray(v) for k, v in params.items()}

    def run(p, x):
        return jax_pipeline_trunk(_jax_block, p, x, m, n_micro=n_micro)

    with m:
        out, vjp = jax.vjp(run, p, jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(cot))
    return (np.asarray(out), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()})


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("pp,n_micro,sliced", [
    (2, 2, False), (2, 4, True), (2, 8, False),
    (4, 2, True), (4, 4, False), (4, 8, True)])
def test_pipeline_matches_sequential_and_jax(pools, pp, n_micro, sliced):
    params, x, cot = _inputs()
    seq_out, seq_gx, seq_gp = _port_sequential(params, x, cot)
    j_out, j_gx, j_gp = _jax_pipeline(params, x, cot, pp, n_micro)
    _close(seq_out, j_out, "sequential port against JAX's pipeline")
    res = pools(pp).run("pipeline", params=params, x=x, cot=cot,
                        sizes={"pp": pp}, n_micro=n_micro,
                        stage_sliced=sliced)
    per = LAYERS // pp
    for r in res:
        assert np.array_equal(r["out"], res[0]["out"]), "stages disagree"
        assert np.array_equal(r["gx"], res[0]["gx"]), "stages disagree"
        assert r["stats"]["ticks"] == n_micro + pp - 1
        assert r["stats"]["calls"] == 1
    out, gx = res[0]["out"], res[0]["gx"]
    for want, what in ((seq_out, "sequential"), (j_out, "JAX")):
        _close(out, want, f"output against the {what}")
    for want, what in ((seq_gx, "sequential"), (j_gx, "JAX")):
        _close(gx, want, f"input gradient against the {what}")
    for k in params:
        if sliced:
            got = np.concatenate([r["gp"][k] for r in res])
        else:
            got = sum(r["gp"][k] for r in res)
            for r in res:  # zero outside the stage's layers
                mine = np.zeros(LAYERS, bool)
                mine[r["pp"] * per:(r["pp"] + 1) * per] = True
                assert not np.any(r["gp"][k][~mine]), k
        _close(got, seq_gp[k], f"{k} gradient against the sequential")
        _close(got, j_gp[k], f"{k} gradient against JAX's")


def test_pipeline_under_dp(pools):
    """pp 2 x dp 2: each dp line pipelines its own rows; the rows'
    outputs and the summed gradients are the sequential loop's."""
    params, x, cot = _inputs(1)
    seq_out, seq_gx, seq_gp = _port_sequential(params, x, cot)
    res = pools(4).run("pipeline", params=params, x=x, cot=cot,
                       sizes={"dp": 2, "pp": 2}, n_micro=2,
                       stage_sliced=False)
    rows = B // 2
    for r in res:
        lo = r["dp"] * rows
        _close(r["out"], seq_out[lo:lo + rows], "rows' output")
        _close(r["gx"], seq_gx[lo:lo + rows], "rows' input gradient")
    for k in params:
        _close(sum(r["gp"][k] for r in res), seq_gp[k], k)


def test_pipeline_refusals_are_jaxs():
    """JAX's two ValueErrors, word for word, before any collective."""
    params, _, _ = _inputs()
    odd = {k: v[:3] for k, v in params.items()}
    cases = [(params, np.zeros((6, 2, D), np.float32), 4),
             (odd, np.zeros((4, 2, D), np.float32), 2)]
    port_mesh = mesh.make_mesh({"pp": 2}, world_size=2, rank=0)
    jm = jax_mesh.make_mesh({"pp": 2}, devices=jax.devices()[:2])
    for p, x, n_micro in cases:
        with pytest.raises(ValueError) as want:
            jax_pipeline_trunk(_jax_block, {k: jnp.asarray(v)
                                            for k, v in p.items()},
                               jnp.asarray(x), jm, n_micro=n_micro)
        with pytest.raises(ValueError) as got:
            pipeline.pipeline_trunk(
                lambda lp, h: h, {k: torch.as_tensor(v)
                                  for k, v in p.items()},
                torch.as_tensor(x), port_mesh, n_micro=n_micro)
        assert str(got.value) == str(want.value)


def _tiny_gpt2(seed=0):
    cfg = jax_gpt2.GPT2Config(vocab_size=384, max_position_embeddings=64,
                              hidden_size=32, num_layers=4, num_heads=4,
                              dtype=jnp.float32)
    jparams = jax_gpt2.init_params(jax.random.key(seed), cfg)
    flat = {k: np.asarray(v) for k, v in _flat_jax(jparams).items()}
    return cfg, jparams, flat


def _flat_jax(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat_jax(tree[k], key))
        else:
            out[key] = tree[k]
    return out


@pytest.mark.parametrize("sizes,n_micro,remat", [
    ({"pp": 2}, 2, False), ({"dp": 2, "pp": 2}, 2, True)])
def test_forward_pipelined_matches_jax(pools, sizes, n_micro, remat):
    jcfg, jparams, flat = _tiny_gpt2()
    ids = np.random.default_rng(2).integers(0, 384, (4, 16)).astype(
        np.int32)
    world = int(np.prod(list(sizes.values())))
    jm = jax_mesh.make_mesh(sizes, devices=jax.devices()[:world])
    with jm:
        want = np.asarray(jax.jit(
            lambda p, i: jax_gpt2.forward_pipelined(p, jcfg, i, jm,
                                                    n_micro=n_micro)
        )(jparams, jnp.asarray(ids)))
    cfg = gpt2.GPT2Config(vocab_size=384, max_position_embeddings=64,
                          hidden_size=32, num_layers=4, num_heads=4,
                          dtype=torch.float32, param_dtype=torch.float32)
    # The sequential forward, and its gradient of the same objective.
    ptree = params_from_jax(jparams, torch.float32, "cpu")
    for _, leaf in _flat_jax(ptree).items():
        leaf.requires_grad_(True)
    seq, _ = gpt2.forward(ptree, cfg, torch.as_tensor(ids).long())
    (g_seq,) = torch.autograd.grad((seq * seq).sum(), [ptree["wte"]])
    res = pools(world).run("forward_pipelined", tree=flat, ids=ids,
                           sizes=sizes, n_micro=n_micro, remat=remat)
    rows = ids.shape[0] // sizes.get("dp", 1)
    for r in res:
        lo = r["dp"] * rows
        _close(r["logits"], want[lo:lo + rows], "logits against JAX's")
        _close(r["logits"], seq.detach().numpy()[lo:lo + rows],
               "logits against the sequential forward")
    # Each dp line's table gradient covers its rows; the lines sum.
    lines = {r["dp"]: r["g_wte"] for r in res}
    g = sum(lines.values())
    np.testing.assert_allclose(g, g_seq.numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(g_seq.numpy()).max())


def test_forward_pipelined_refuses_tp():
    jcfg, jparams, flat = _tiny_gpt2()
    cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
    ptree = params_from_jax(jparams, torch.float32, "cpu")
    ids = torch.zeros((2, 4), dtype=torch.long)
    jm = jax_mesh.make_mesh({"pp": 2, "tp": 2}, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as want:
        jax_gpt2.forward_pipelined(jparams, jcfg, jnp.zeros((2, 4), int), jm,
                                   n_micro=2)
    with pytest.raises(ValueError) as got:
        gpt2.forward_pipelined(ptree, cfg, ids, mesh.make_mesh(
            {"pp": 2, "tp": 2}, world_size=4, rank=0), n_micro=2)
    assert str(got.value) == str(want.value)
