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
replicated (the nondiv case).  The paper's system half under the mesh, in
the same two ranks: the paged setup with every block spooled into one
directory the ranks share (rank 0 writes, both read), with every dialogue
image pulled from the JAX package's block server (rank 0 pulls, rank 1
reads rank 0's file), and through two replicas; a session's freeze, thaw
and fork on fp32 and int8 pools against the port's unsharded engine
(which ``test_torch_sessions.py`` holds to the JAX engine); an aging
queue admitting in one order on both ranks.  Also: every parameter's cut
against the reference's ``_leaf_spec``/``_guard``, the shards
concatenating back to the whole weights (cut, and drawn per rank by
``init_params``), the pool's and the dense cache's kv heads per rank, a
1 x 1 mesh engine's spool file byte-equal to the unsharded engine's and
read back by both packages, and what still raises under a mesh.

Tolerances: greedy tokens, ``n_reused``, linked media exact; first-token
logits within 1e-4 relative (max |diff| over max |logit|): the
row-parallel sums add in another order.  The int8 pool: within 1e-4 of
the port's own unsharded int8 engine, served in the ranks' test, and
within the 1e-3 absolute that ``test_torch_engine.py`` holds the
unsharded int8 engine to against the JAX one (int8 rounding of K/V that
differ in their last fp32 bits).
"""
import dataclasses
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

import torch.multiprocessing as mp

from repro.cache.library import KVLibrary as JaxLibrary
from repro.launch.specs import _guard as jax_guard
from repro.launch.specs import _leaf_spec as jax_leaf_spec
from repro_torch.cache import KVLibrary
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.serving import EngineConfig, MPICEngine
from repro_torch.serving.sharding import ServingSharding
from repro_torch.weights import leaf_path

from _torch_parity import build_pair, jax_traffic, smoke_configs
from _torch_parity import jax_compile_cache  # noqa: F401
from _torch_sharded import (
    REL,
    SETUPS,
    Ranks,
    _torch_pkg,
    case_sessions,
    check_requests,
    rel,
    run_traffic,
    upload_dialogues,
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


SESSION_POOLS = {"fp32": "", "int8": "int8"}


def _jax_peer(jm, jp):
    """The JAX package's block server over a JAX engine's library holding
    the stream's dialogue images (the peer case pulls them)."""
    from repro.cache.net import KVPeerServer
    from repro.core import Prompt, text_segment
    from repro.data import image_embeds, make_dialogues
    from repro.serving import EngineConfig as JaxConfig
    from repro.serving import MPICEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    eng = JaxEngine(jm, jp, JaxConfig(paged_backend="ref", pipelined=False,
                                      **SETUPS["paged"][0]))
    upload_dialogues(eng, {"make_dialogues": make_dialogues,
                           "image_embeds": image_embeds,
                           "text_segment": text_segment, "Prompt": Prompt,
                           "Request": JaxRequest},
                     jm.cfg.d_model, jm.cfg.media_token_len)
    return KVPeerServer(eng.static_lib)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, port unsharded results, 2-rank results, 4-rank
    results); the ranks run while the JAX engines serve.  The port's
    unsharded results: the int8 setup and the session cases."""
    jm, jp, tm, tp = build_pair(arch=ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    inbox = mp.get_context("spawn").Queue()
    spool = tmp_path_factory.mktemp("spool")
    two = Ranks(2, tm.cfg, tree, [(s, "serve", {"setup": s})
                                  for s in SETUPS] + [
        ("kernel", "kernel", {}),
        ("decode", "decode", {"tokens": TOKENS, "steps": STEPS}),
        ("disk", "disk", {"spool_dir": str(spool / "disk")}),
        ("replicas", "replicas", {}), ("aging", "aging", {})] + [
        (f"sessions-{name}", "sessions", {
            "pool": pool, "spool_dir": str(spool / f"sessions-{name}")})
        for name, pool in SESSION_POOLS.items()] + [
        ("peer", "peer", {"inbox": inbox, "spool_dir": str(spool / "peer")})])
    four = Ranks(4, tm.cfg, tree, [(s, "serve", {"setup": s})
                                   for s in ("paged", "dense")])
    server = None
    try:
        server = _jax_peer(jm, jp)
        for _ in range(2):
            inbox.put(server.address)
        ref = {s: jax_traffic(jm, jp, s) for s in SETUPS}
        ref["decode"] = _jax_decode(jm, jp, TOKENS, STEPS)
        eng = MPICEngine(tm, tp, EngineConfig(**SETUPS["int8"][0]),
                         device="cpu")
        port = {"int8": run_traffic(eng, _torch_pkg(), tm.cfg.d_model,
                                    tm.cfg.media_token_len,
                                    SETUPS["int8"][1])}
        eng.close()
        for name, pool in SESSION_POOLS.items():
            port[f"sessions-{name}"] = case_sessions(
                tm, tp, None, pool, str(spool / f"unsharded-{name}"))
    finally:
        r2, r4 = two.results(), four.results()
        if server is not None:
            server.close()
    return ref, port, r2, r4


@pytest.mark.parametrize("setup", list(SETUPS))
def test_two_ranks_serve_the_jax_engines_tokens(runs, setup):
    ref, port, r2, _ = runs
    for rank in (0, 1):
        res = r2[rank][setup]
        check_requests(res["requests"], ref[setup],
                       atol=1e-3 if setup == "int8" else None)
        if setup == "int8":
            check_requests(res["requests"], port["int8"])
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


def test_two_ranks_serve_every_block_from_the_spool_they_share(runs):
    """Host budget 0: every image (the dialogues' and the MRAG one) spools
    at its upload and is read back at its link.  Rank 0 alone writes the
    files; both ranks read the same ones; the tokens are the JAX engine's.
    How often a rank reads one block is timing: a loader thread's fetch
    races rank 0's re-spool of a block no request pins yet."""
    ref, _, r2, _ = runs
    for rank in (0, 1):
        res = r2[rank]["disk"]
        check_requests(res["requests"], ref["paged"])
        for lib in ("static", "dynamic"):
            assert res[lib]["disk_fetches"] > 0
            assert (res[lib]["disk_bytes_written"] > 0) == (rank == 0)
    read = [set(r2[rank]["disk"]["static"]["read_keys"]) for rank in (0, 1)]
    assert read[0] and read[0] == read[1]


def test_two_ranks_serve_blocks_that_rank_0_pulls_from_a_jax_peer(runs):
    """No dialogue image is uploaded: rank 0 pulls each from the JAX
    package's block server (the wire formats are byte-equal) and writes
    it into the shared spool, where rank 1 reads it; the tokens are the
    JAX engine's, which computed those blocks."""
    ref, _, r2, _ = runs
    for rank in (0, 1):
        check_requests(r2[rank]["peer"]["requests"], ref["paged"])
    lead, other = r2[0]["peer"]["static"], r2[1]["peer"]["static"]
    assert lead["network_fetches"] == 4 and other["network_fetches"] == 0
    assert lead["disk_bytes_written"] == other["disk_bytes_read"] > 0
    assert other["disk_bytes_written"] == 0


def test_two_replicas_over_the_mesh_serve_the_jax_engines_tokens(runs):
    ref, _, r2, _ = runs
    for rank in (0, 1):
        check_requests(r2[rank]["replicas"]["requests"], ref["paged"])
    assert r2[0]["replicas"]["replicas"] == r2[1]["replicas"]["replicas"]
    assert set(r2[0]["replicas"]["replicas"]) == {0, 1}


@pytest.mark.parametrize("pool", list(SESSION_POOLS))
def test_two_ranks_freeze_thaw_and_fork_as_the_unsharded_engine(runs, pool):
    """freeze_after 4 (spooled whole by rank 0, read back by both at the
    thaw), a thaw with a 4-token suffix, a fork into 2: the tokens of the
    port's unsharded engine, the first tokens' logits within 1e-4
    relative (fp32 pool) or 1e-3 absolute (int8 pool)."""
    _, port, r2, _ = runs
    want = port[f"sessions-{pool}"]
    assert want["state"] == ["frozen", "done", "done", "done"]
    assert len(want["tokens"][0]) == 4 and want["spooled"] == 1
    for rank in (0, 1):
        got = r2[rank][f"sessions-{pool}"]
        assert got["tokens"] == want["tokens"]
        assert got["state"] == want["state"] and got["spooled"] == 1
        assert got["static"]["disk_fetches"] == 1
        assert (got["static"]["disk_bytes_written"] > 0) == (rank == 0)
        for g, w in zip(got["first"], want["first"]):
            if pool == "int8":
                np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
            else:
                assert rel(g, w) <= REL


def test_the_aged_admission_order_is_rank_0s_on_every_rank(runs):
    """Rank 1 waits after each submit, so its own clock would age the
    queue into another order; both ranks admit in rank 0's."""
    r2 = runs[2]
    assert r2[0]["aging"] == r2[1]["aging"]
    assert sorted(r2[0]["aging"]["order"]) == [0, 1, 2]
    assert all(len(t) == 3 for t in r2[0]["aging"]["tokens"])


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


def test_a_mesh_engine_spools_as_the_unsharded_engine_does(monkeypatch):
    """A 1 x 1 mesh engine whose library goes over a 1-byte host budget
    spools into a directory of its own, as the unsharded engine does: the
    two files are byte-equal (one clock for both sidecars), and each
    rehydrates into the JAX package's ``KVLibrary(rehydrate=True)`` and
    the port's with the uploaded K/V."""
    import repro_torch.cache.library as library_mod
    monkeypatch.setattr(library_mod.time, "time", lambda: 1.0e9)
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    model, params = build_model(cfg), init_params(cfg, device="cpu")
    embeds = np.random.default_rng(0).standard_normal(
        (16, cfg.d_model)).astype(np.float32)
    files = []
    for mesh in (make_serving_mesh(1, 1, device="cpu"), None):
        lib = KVLibrary(hbm_capacity=0, host_capacity=1)
        eng = MPICEngine(model, params, EngineConfig(max_seq_len=256),
                         mesh=mesh, static_library=lib, device="cpu")
        try:
            eng.upload("u", "img-0", embeds)
            entry = lib._entries[("u", "img-0")]
            assert entry.tier == "disk" and entry.payload.k is None
            files.append(lib.disk.path_for(entry.meta.key))
        finally:
            eng.close()
    try:
        with open(files[0], "rb") as a, open(files[1], "rb") as b:
            assert a.read() == b.read()
        assert os.path.dirname(files[0]) != os.path.dirname(files[1])
        want = None
        for path in files:
            ours = KVLibrary(spool_dir=os.path.dirname(path),
                             rehydrate=True, device="cpu")
            theirs = JaxLibrary(spool_dir=os.path.dirname(path),
                                rehydrate=True)
            got = ours.get("u", "img-0")
            ref = theirs.get("u", "img-0")
            assert ours.rehydrate_stats["rehydrated"] == 1
            assert got is not None and ref is not None
            want = got.k if want is None else want
            assert torch.equal(got.k, want)
            np.testing.assert_array_equal(np.asarray(ref.k),
                                          got.k.numpy())
    finally:
        for path in files:
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-130m",
                                  "hymba-1.5b", "whisper-small"])
def test_unported_families_raise_under_a_mesh(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingSharding(_mesh(2), get_smoke_config(arch))


def test_what_a_mesh_does_not_serve_yet_raises(capsys):
    """The ``data`` axis (ROADMAP.md, queue 1) and ``--mesh`` with
    ``--fleet``, which the JAX launcher has no path for either: its
    ``--fleet`` returns before it reads ``--mesh``."""
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_serving_mesh(2, 1, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--mesh", "1x2", "--fleet", "2", "--device", "cpu"])
    assert "returns before it reads --mesh" in capsys.readouterr().err
