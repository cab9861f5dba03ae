"""Tensor-parallel serving of the port (``MPICEngine(mesh=)``) against the
JAX package's unsharded engine, on the fp32 smoke internvl2-76b (4 query
heads on 2 kv heads, a 64-token window that bites in every prompt).

The reference's own mesh engine fails under the installed jax (its
``tests/test_sharded_serving.py``), so the oracle is its unsharded engine;
the cases mirror its sharded worker (``tests/_sharded_worker.py``).  Two
gloo ranks on the CPU (``tests/_torch_sharded.py``) serve three dialogues
and an MRAG request on a paged fp32 pool (mpic, cacheblend,
full_recompute: the prefill, mrag, cacheblend and decode cases), on the
dense cache (the dense case) and on an int8 pool (the int8 case), and run
the kernel and the model-level decode cases; four ranks, which the 2 kv
heads do not divide, serve the paged and dense setups with attention
replicated (the nondiv case).  Also: every parameter's cut against the
reference's ``_leaf_spec``/``_guard``, the shards concatenating back to
the whole weights (cut, and drawn per rank by ``init_params``), the
pool's and the dense cache's kv heads per rank, and what raises under a
mesh (a library that would spool among it).

Tolerances: greedy tokens, ``n_reused``, linked media exact; first-token
logits within 1e-4 relative (max |diff| over max |logit|): the
row-parallel sums add in another order.  The int8 pool: within 1e-4 of
the port's own unsharded int8 engine, served in the ranks' test, and
within the 1e-3 absolute that ``test_torch_engine.py`` holds the
unsharded int8 engine to against the JAX one (int8 rounding of K/V that
differ in their last fp32 bits).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.launch.specs import _guard as jax_guard
from repro.launch.specs import _leaf_spec as jax_leaf_spec
from repro_torch.cache import KVLibrary
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.serving import EngineConfig, MPICEngine, Request
from repro_torch.serving.sharding import ServingSharding
from repro_torch.weights import leaf_path

from _torch_parity import build_pair, jax_traffic, smoke_configs
from _torch_parity import jax_compile_cache  # noqa: F401
from _torch_sharded import (
    REL,
    SETUPS,
    Ranks,
    _torch_pkg,
    check_requests,
    rel,
    run_traffic,
)

ARCH = "internvl2-76b"
TOKENS = [5, 17, 200, 33, 101, 7, 64, 250, 12, 90, 3]
STEPS = 4


def _jax_decode(jm, jp, tokens, steps):
    """The reference worker's dense decode: prefill, then greedy steps."""
    import jax.numpy as jnp
    cache = jm.make_cache(1, 64)
    logits, cache = jm.prefill(jp, jnp.asarray([tokens], jnp.int32), cache)
    out = [np.asarray(logits[0, -1])]
    tok = int(jnp.argmax(logits[0, -1]))
    for i in range(steps):
        p = jnp.full((1, 1), len(tokens) + i, jnp.int32)
        lg, cache = jm.decode_step(jp, jnp.full((1, 1), tok, jnp.int32), p,
                                   cache, p)
        out.append(np.asarray(lg[0]))
        tok = int(jnp.argmax(lg[0]))
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX results, port unsharded results, 2-rank results, 4-rank
    results); the ranks run while the JAX engines serve."""
    jm, jp, tm, tp = build_pair(arch=ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    two = Ranks(2, tm.cfg, tree, [(s, "serve", {"setup": s})
                                  for s in SETUPS] + [
        ("kernel", "kernel", {}),
        ("decode", "decode", {"tokens": TOKENS, "steps": STEPS})])
    four = Ranks(4, tm.cfg, tree, [(s, "serve", {"setup": s})
                                   for s in ("paged", "dense")])
    try:
        ref = {s: jax_traffic(jm, jp, s) for s in SETUPS}
        ref["decode"] = _jax_decode(jm, jp, TOKENS, STEPS)
        eng = MPICEngine(tm, tp, EngineConfig(**SETUPS["int8"][0]),
                         device="cpu")
        port_int8 = run_traffic(eng, _torch_pkg(), tm.cfg.d_model,
                                tm.cfg.media_token_len, SETUPS["int8"][1])
        eng.close()
    finally:
        r2, r4 = two.results(), four.results()
    return ref, port_int8, r2, r4


@pytest.mark.parametrize("setup", list(SETUPS))
def test_two_ranks_serve_the_jax_engines_tokens(runs, setup):
    ref, port_int8, r2, _ = runs
    for rank in (0, 1):
        res = r2[rank][setup]
        check_requests(res["requests"], ref[setup],
                       atol=1e-3 if setup == "int8" else None)
        if setup == "int8":
            check_requests(res["requests"], port_int8)
    assert [r["tokens"] for r in r2[0][setup]["requests"]] == \
        [r["tokens"] for r in r2[1][setup]["requests"]]


@pytest.mark.parametrize("setup", list(SETUPS))
def test_two_ranks_hold_half_the_kv_heads(runs, setup):
    facts = runs[2][0][setup]["facts"]
    assert facts["attn_sharded"] and facts["local_kv_heads"] == 1
    if setup == "dense":
        assert facts["cache_shape"] == (2, 2, 256, 1, 64)
    else:
        assert facts["pool_shape"][3] == 1 and facts["pages_back"]
    if setup == "int8":
        assert facts["scale_shape"][2] == 1


@pytest.mark.parametrize("setup", ["paged", "dense"])
def test_four_ranks_replicate_attention_where_kv_heads_do_not_divide(
        runs, setup):
    ref, _, _, r4 = runs
    for rank in range(4):
        res = r4[rank][setup]
        assert not res["facts"]["attn_sharded"]
        assert res["facts"]["local_kv_heads"] == 2
        check_requests(res["requests"], ref[setup])


def test_kernels_on_a_ranks_heads_equal_the_whole_call(runs):
    for rank in (0, 1):
        err = runs[2][rank]["kernel"]
        assert set(err) == {"paged_decode", "paged_prefill", "dense"}
        assert max(err.values()) <= 1e-6, err


def test_model_level_paged_decode_matches_the_jax_dense_decode(runs):
    ref, _, r2, _ = runs
    for rank in (0, 1):
        got = r2[rank]["decode"]
        assert got["pool_shape"][3] == 1
        assert len(got["logits"]) == STEPS + 1
        for g, w in zip(got["logits"], ref["decode"]):
            assert g.shape == w.shape == (512,)
            assert rel(g, w) <= REL
            assert int(np.argmax(g)) == int(np.argmax(w))


def test_live_collectives_equal_the_dry_runs_recording(runs):
    """The collectives each rank's prefill and first paged decode step ran
    over gloo, kind for kind and byte for byte, are what the dry run's
    recording mesh counts for the same config and shapes on ``meta``."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import trace_serving, trace_step
    from repro_torch.launch.mesh import ProductionMesh, RecordingMesh
    cfg = smoke_configs(ARCH)[1]
    shape = InputShape("case_decode", len(TOKENS), 1, "prefill")
    prefill = trace_step(cfg, "prefill", shape,
                         ProductionMesh(("data", "model"), (1, 2)))[2]
    decode = trace_serving(cfg, "serve_decode", RecordingMesh(2), slots=1,
                           kv_len=len(TOKENS) + STEPS)[2]
    assert len(prefill) == len(decode) == 2 * cfg.num_layers + 2
    for rank in (0, 1):
        got = runs[2][rank]["decode"]
        assert got["prefill_calls"] == prefill
        assert got["decode_calls"] == decode


# ---------------------------------------------------------------------------
# the plan: no process group needed
# ---------------------------------------------------------------------------

def _mesh(m, rank=0):
    return ServingMesh(data=1, model=m, rank=rank, backend="gloo",
                       device=torch.device("cpu"))


def _jax_mesh(m):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, m)))


def _reference_decision(cfg, name, shape, m):
    path, index = leaf_path(name)
    stacked = index is not None
    full = (cfg.num_layers,) * stacked + tuple(shape)
    spec = tuple(jax_guard(jax_leaf_spec("/" + "/".join(path), len(full),
                                         fsdp=False), full, _jax_mesh(m)))
    return spec[1:] if stacked else spec


CUTS = [("internvl2-76b", True, 2), ("internvl2-76b", False, 4),
        ("internvl2-76b", False, 8), ("llava-1.6-7b", True, 2),
        ("llava-1.6-7b", False, 4), ("qwen2.5-14b", False, 4),
        ("internvl2-76b", True, 4)]


@pytest.mark.parametrize("arch, smoke, m", CUTS, ids=[
    f"{a.split('-')[0]}-{'smoke' if s else 'full'}-{m}" for a, s, m in CUTS])
def test_every_parameters_cut_is_the_references(arch, smoke, m):
    """Equal to ``_leaf_spec``/``_guard`` leaf for leaf, but where the kv
    heads do not divide the axis (the smoke internvl2 at 4): there the
    port keeps every attention leaf whole, and the QKV biases follow their
    weights."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    ours = specs.param_pspecs(cfg, _mesh(m))
    shapes = {n: tuple(p.shape) for n, p in
              specs._meta_params(cfg).named_parameters()}
    attn_cut = cfg.num_kv_heads % m == 0
    for name, shape in shapes.items():
        want = _reference_decision(cfg, name, shape, m)
        if ".attn." in name and not attn_cut:
            assert ours[name] == (None,) * len(shape), name
        elif name.split(".")[-1] in ("bq", "bk", "bv"):
            w = name[:-2] + "w" + name[-1]
            assert ours[name] == ours[w][-1:], name
        else:
            assert ours[name] == want, (name, ours[name], want)
    assert any(s == ("model", None) for s in ours.values())


@pytest.mark.parametrize("arch", ["internvl2-76b", "deepseek-moe-16b",
                                  "mamba2-130m", "hymba-1.5b",
                                  "whisper-small", "qwen2.5-14b"])
def test_leaf_spec_is_the_references_for_every_family(arch):
    """The pure decision (the reference's without FSDP) on every leaf of
    the JAX tree's layout."""
    cfg = get_config(arch)
    for name, p in specs._meta_params(cfg).named_parameters():
        path, index = leaf_path(name)
        ndim = p.dim() + (index is not None)
        ref_path = "/" + "/".join(path)
        assert specs.leaf_spec(ref_path, ndim) == tuple(
            jax_leaf_spec(ref_path, ndim, fsdp=False)), name


def _concat(parts, spec):
    dims = [d for d, ax in enumerate(spec) if ax == "model"]
    return torch.cat(parts, dims[0]) if dims else parts[0]


@pytest.mark.parametrize("m", [2, 4])
def test_shards_concatenate_to_the_whole_model(m):
    """``shard_params`` of a whole model and ``init_params(sharding=)``,
    which never builds the whole model: both give each rank its piece of
    the same seeded weights."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    whole = init_params(cfg, seed=3, device="cpu")
    plans = [ServingSharding(_mesh(m, r), cfg) for r in range(m)]
    cut = [p.shard(whole) for p in plans]
    drawn = [init_params(cfg, seed=3, device="cpu", sharding=p)
             for p in plans]
    for shards in (cut, drawn):
        assert all(s.sharding is p for s, p in zip(shards, plans))
        named = [dict(s.named_parameters()) for s in shards]
        for name, w in whole.named_parameters():
            got = _concat([n[name] for n in named], plans[0].specs[name])
            assert torch.equal(got, w), name
    assert cut[0].cfg == plans[0].local_cfg
    assert plans[0].local_cfg.d_ff == cfg.d_ff // m


@pytest.mark.parametrize("m", [2, 4])
def test_pool_and_dense_cache_hold_the_ranks_kv_heads(m):
    """One decision cuts attention, the MLP and the vocabulary: the smoke
    internvl2's 2 kv heads divide 2 ranks (each rank's pool, scales and
    dense cache hold one head) and not 4 (attention and the caches whole,
    the MLP still cut)."""
    cfg = get_smoke_config(ARCH)
    plan = ServingSharding(_mesh(m), cfg)
    attn = cfg.num_kv_heads % m == 0
    assert plan.cuts == specs.Cuts(attn=attn, mlp=True, vocab=True)
    assert plan.local_cfg.num_kv_heads == (
        cfg.num_kv_heads // m if attn else cfg.num_kv_heads)
    assert plan.local_cfg.d_ff == cfg.d_ff // m
    cache = plan.local_model().make_cache(2, 32, device="meta")
    whole = build_model(cfg).make_cache(2, 32, device="meta")
    for key in ("k", "v"):
        want = list(whole[key].shape)
        want[3] //= m if attn else 1
        assert list(cache[key].shape) == want
    pool = PagedKVPool(PagedConfig(
        num_pages=3, page_size=4, num_layers=plan.local_cfg.num_layers,
        num_kv_heads=plan.local_cfg.num_kv_heads,
        head_dim=plan.local_cfg.head_dim, dtype="int8"), device="cpu")
    assert pool.k.shape[3] == pool.k_scale.shape[2] == \
        plan.local_cfg.num_kv_heads


def test_a_mesh_engine_raises_where_its_library_would_spool():
    """The disk tier under a mesh is not ported: the engine keeps the
    libraries' host budgets, and a put that takes one over them raises
    instead of spooling (a 1 x 1 mesh, two images over a budget of
    one)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    mesh = make_serving_mesh(1, 1, device="cpu")
    lib = KVLibrary(hbm_capacity=0, host_capacity=1)
    eng = MPICEngine(build_model(cfg), init_params(cfg, device="cpu"),
                     EngineConfig(max_seq_len=256), mesh=mesh,
                     static_library=lib)
    try:
        assert eng.dynamic_lib.memory.host_capacity == \
            KVLibrary().memory.host_capacity
        embeds = np.random.default_rng(0).standard_normal(
            (16, cfg.d_model)).astype(np.float32)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.upload("u", "img-0", embeds)
        assert lib.disk.spool_dir is None       # nothing was written
    finally:
        eng.close()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-130m",
                                  "hymba-1.5b", "whisper-small"])
def test_unported_families_raise_under_a_mesh(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingSharding(_mesh(2), get_smoke_config(arch))


def test_what_a_mesh_does_not_serve_yet_raises(tmp_path):
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, device="cpu")
    mesh = make_serving_mesh(1, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_serving_mesh(2, 1, device="cpu")
    for kw in ({"static_library": KVLibrary(spool_dir=str(tmp_path))},
               {"static_library": KVLibrary(peers=["127.0.0.1:1"])}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MPICEngine(model, params, EngineConfig(), mesh=mesh, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MPICEngine(model, params, EngineConfig(freeze_idle_s=1.0),
                   mesh=mesh)
    eng = MPICEngine(model, params, EngineConfig(max_seq_len=256),
                     mesh=mesh)
    try:
        assert eng.device.type == "cpu" and eng.params.sharding is not None
        prompt = _torch_pkg()["make_dialogues"](
            n=1, n_images=1, d_model=cfg.d_model, media_len=16)[0].prompt
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.submit(Request(prompt=prompt, freeze_after=2))
    finally:
        eng.close()
