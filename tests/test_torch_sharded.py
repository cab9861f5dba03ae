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
queue admitting in one order on both ranks.  The ``data`` axis, in the
same processes after those cases (a fresh process group each): the two
ranks as ``data 2 x model 1`` and the four as ``data 2 x model 2`` serve
the paged, int8 and dense setups (each data rank decodes one of the two
slots, the prefills replicated), the two also the replicated case (3
slots, which 2 data ranks do not divide), held to the same JAX runs, every
data rank's pool after every request bit-equal to its data peer's and
within fp32 rounding of the port's unsharded engine's heads (bit-equal
in the replicated case); and the dry run's long decode (a wrapped ring of
the 64-token window, its KV sequence on ``data``, merged through kernel
5's log-sum-exp) within 1e-5 relative of the port's unsharded step,
which is held once to the JAX package's ``decode_step``.  Also: every
parameter's cut
against the reference's ``_leaf_spec``/``_guard``, the shards
concatenating back to the whole weights (cut, and drawn per rank by
``init_params``), the pool's and the dense cache's kv heads per rank, a
1 x 1 mesh engine's spool file byte-equal to the unsharded engine's and
read back by both packages, every family's plan (the MoE's experts, the
SSM's and hybrid's SSD heads, whisper's encoder-decoder) with its cuts
and its shards concatenating back, and what still raises under a mesh
(training, and ``--mesh`` with ``--fleet``; the families' parity
modules serve them on ranks against their own JAX runs:
``test_torch_moe_engine*.py``, ``test_torch_ssm.py``,
``test_torch_hybrid.py``, ``test_torch_whisper.py``).

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
    LONG_AT,
    REL,
    SETUPS,
    SLOTS3,
    Ranks,
    _torch_pkg,
    case_sessions,
    check_requests,
    long_decode,
    pool_pages,
    rel,
    ring_cache,
    run_traffic,
    upload_dialogues,
)

ARCH = "internvl2-76b"
TOKENS = [5, 17, 200, 33, 101, 7, 64, 250, 12, 90, 3]
STEPS = 4
LONG_STEPS = 8


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


# the data axis's setups: on data 2 x model 1 (the two ranks) and on
# data 2 x model 2 (the four), each rank's pool after every request
DATA_SETUPS = {2: ("paged", "int8", "dense", "slots3"),
               4: ("paged", "int8", "dense")}


def _data_jobs(world):
    """The data phase of ``world`` ranks: the long decode on the four
    (where the model axis cuts its kv heads too), two replicas over the
    mesh on the two."""
    jobs = [(f"data-{s}", "serve", {"setup": s, "pools": True})
            for s in DATA_SETUPS[world]]
    extra = ("long", "long_decode", {}) if world == 4 else (
        "data-replicas", "replicas", {})
    return [(2, jobs + [extra])]


def _unsharded(tm, tp, setup):
    """The port's unsharded engine over a setup (or ``"slots3"``): its
    requests and its pool after every request."""
    over, policies = SLOTS3 if setup == "slots3" else SETUPS[setup]
    eng = MPICEngine(tm, tp, EngineConfig(**over), device="cpu")
    snaps, finish = [], eng._finish

    def snapshot_after(r):
        finish(r)
        snaps.append(pool_pages(eng))

    eng._finish = snapshot_after
    try:
        return {"requests": run_traffic(eng, _torch_pkg(), tm.cfg.d_model,
                                        tm.cfg.media_token_len, policies),
                "pools": snaps}
    finally:
        eng.close()


def _jax_long_decode(jm, jp, steps, token=7):
    """The JAX package's ``decode_step`` on :func:`ring_cache`'s wrapped
    ring, greedy, each step writing slot ``position % window``."""
    import jax.numpy as jnp
    cache = {k: jnp.asarray(v) for k, v in ring_cache(jm.cfg, 5).items()}
    w = jm.cfg.sliding_window
    tok, out = jnp.full((1, 1), token, jnp.int32), []
    for i in range(steps):
        p = jnp.full((1, 1), LONG_AT + i, jnp.int32)
        lg, cache = jm.decode_step(jp, tok, p, cache, p % w)
        out.append(np.asarray(lg[0]))
        tok = jnp.argmax(lg, axis=-1, keepdims=True).astype(jnp.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, port unsharded results, 2-rank results, 4-rank
    results); the ranks run while the JAX engines serve, then again as
    ``data 2 x model 1`` and ``data 2 x model 2``.  The port's unsharded
    results: the paged, int8 and 3-slot setups with their pools, the long
    decode and the session cases."""
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
        ("peer", "peer", {"inbox": inbox, "spool_dir": str(spool / "peer")})],
        then=_data_jobs(2))
    four = Ranks(4, tm.cfg, tree, [(s, "serve", {"setup": s})
                                   for s in ("paged", "dense")],
                 then=_data_jobs(4))
    server = None
    try:
        server = _jax_peer(jm, jp)
        for _ in range(2):
            inbox.put(server.address)
        ref = {s: jax_traffic(jm, jp, s) for s in SETUPS}
        ref["decode"] = _jax_decode(jm, jp, TOKENS, STEPS)
        ref["long"] = _jax_long_decode(jm, jp, LONG_STEPS)
        port = {s: _unsharded(tm, tp, s) for s in ("paged", "int8",
                                                    "slots3")}
        port["long"] = long_decode(tm, tp, None, steps=LONG_STEPS)
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
            check_requests(res["requests"], port["int8"]["requests"])
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
# the data axis
# ---------------------------------------------------------------------------

DATA_CASES = [(w, s) for w, setups in DATA_SETUPS.items() for s in setups]


def _mesh_name(world):
    return "2x1" if world == 2 else "2x2"


@pytest.mark.parametrize("world, setup", DATA_CASES, ids=[
    f"{_mesh_name(w)}-{s}" for w, s in DATA_CASES])
def test_data_ranks_serve_the_jax_engines_tokens(runs, world, setup):
    """``data 2 x model 1`` and ``data 2 x model 2``: every rank gives the
    JAX engine's tokens and first-token logits within 1e-4 relative (the
    int8 pool: 1e-3 absolute of the JAX engine's, 1e-4 relative of the
    port's unsharded int8 engine's), each data rank decoding its slot
    (all three slots in the replicated case), its dense cache holding
    only its slot's row, its pool every page."""
    ref, port, r2, r4 = runs
    got = (r2 if world == 2 else r4)
    model = world // 2
    want = ref["paged" if setup == "slots3" else setup]
    for rank in range(world):
        res = got[rank][f"data-{setup}"]
        check_requests(res["requests"], want,
                       atol=1e-3 if setup == "int8" else None)
        if setup == "int8":
            check_requests(res["requests"], port["int8"]["requests"])
        facts = res["facts"]
        d, m = divmod(rank, model)
        assert facts["coords"] == (rank, d, m)
        assert facts["groups"] == (model, 2)
        assert facts["slots"] == ((0, 3) if setup == "slots3" else (d, 1))
        if setup == "dense":
            assert facts["cache_shape"][1] == 1
        else:
            assert facts["pages_back"]
            assert facts["pool_shape"][1] == (49 if setup == "slots3"
                                              else 33)


@pytest.mark.parametrize("world, setup", [
    c for c in DATA_CASES if c[1] != "dense"], ids=[
    f"{_mesh_name(w)}-{s}" for w, s in DATA_CASES if s != "dense"])
def test_data_ranks_pools_equal_their_peers_and_the_unsharded_engine(
        runs, world, setup):
    """After every request each data rank's pool (and an int8 pool's
    scales), the scratch page aside, is bit-equal to its data peer's (the
    same model rank): every slot's new rows go into every copy through the
    same write.  Against the port's unsharded engine's heads of that
    model rank: bit-equal in the replicated case (every rank computes
    every slot, as the unsharded engine does), else within fp32 rounding
    (a rank's step runs its one slot where the unsharded one runs two, and
    the CPU's products round a batch of 1 and of 2 differently): 1e-5 of
    the largest K/V, int8 bytes within one step and scales within 1e-5
    relative."""
    _, port, r2, r4 = runs
    got = r2 if world == 2 else r4
    model = world // 2
    want = port[setup]["pools"]
    for rank in range(world):
        mine = got[rank][f"data-{setup}"]["pools"]
        peer = got[(rank + model) % world][f"data-{setup}"]["pools"]
        assert len(mine) == len(peer) == len(want) == 4
        for a, b, w in zip(mine, peer, want):
            assert set(a) == set(b) == set(w)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
                axis = 3 if key in ("k", "v") else 2
                n = w[key].shape[axis] // model
                whole = np.take(w[key], range((rank % model) * n,
                                              (rank % model + 1) * n), axis)
                if setup == "slots3" and model == 1:
                    np.testing.assert_array_equal(a[key], whole)
                elif a[key].dtype == np.int8:
                    assert np.abs(a[key].astype(int) - whole).max() <= 1
                elif key.endswith("scale"):
                    np.testing.assert_allclose(a[key], whole, rtol=1e-5)
                else:
                    np.testing.assert_allclose(
                        a[key], whole, rtol=0,
                        atol=1e-5 * np.abs(whole).max())


def test_two_replicas_over_the_data_axis_serve_the_jax_engines_tokens(
        runs):
    """``MPICCluster(mesh=)`` on ``data 2 x model 1``: two replicas, each
    an engine whose data ranks decode a slot each, routed alike on both
    ranks (world rank 0's decisions), give the JAX engine's tokens."""
    ref, _, r2, _ = runs
    for rank in (0, 1):
        check_requests(r2[rank]["data-replicas"]["requests"], ref["paged"])
    assert r2[0]["data-replicas"]["replicas"] == \
        r2[1]["data-replicas"]["replicas"]
    assert set(r2[0]["data-replicas"]["replicas"]) == {0, 1}


def test_long_decode_with_the_kv_sequence_on_data(runs):
    """The dry run's ``long_500k`` step live on ``data 2 x model 2``: a
    wrapped ring of the 64-token window, 32 slots and one kv head a rank,
    8 greedy steps; every rank's logits within 1e-5 relative of the
    port's unsharded step, each step's merge two fp32 all-reduces a layer
    on ``data`` (``test_torch_hybrid.py`` runs hymba's on ``2 x 1``)."""
    _, port, _, got = runs
    world = 4
    cfg = smoke_configs(ARCH)[1]
    want = port["long"]["logits"]
    assert len(want) == LONG_STEPS
    for rank in range(world):
        res = got[rank]["long"]
        assert res["slots"][2] == cfg.sliding_window // 2
        for g, w in zip(res["logits"], want):
            assert rel(g, w) <= 1e-5
        data = [c for c in res["calls"] if c.axis == "data"]
        assert len(data) == 2 * cfg.num_layers
        assert all(c.kind == "all-reduce" and c.group == 2 for c in data)


def test_long_decode_matches_the_jax_decode_step(runs):
    """The port's unsharded long decode that the data ranks are held to,
    against the JAX package's ``decode_step`` on the same ring: logits
    within 1e-4 relative, the same greedy tokens."""
    ref, port, _, _ = runs
    for g, w in zip(port["long"]["logits"], ref["long"]):
        assert rel(g, w) <= REL
        assert int(np.argmax(g)) == int(np.argmax(w))


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
    """The reference's spec of one leaf, ``replicate_ssm`` set as its
    serving plan sets it (SSD heads that do not divide the axis)."""
    path, index = leaf_path(name)
    stacked = index is not None
    full = (cfg.num_layers if path[0] == "layers" else cfg.encoder_layers,
            ) * stacked + tuple(shape)
    rep_ssm = bool((cfg.attn_free or cfg.hybrid) and cfg.ssm_num_heads % m)
    spec = tuple(jax_guard(jax_leaf_spec("/" + "/".join(path), len(full),
                                         fsdp=False, replicate_ssm=rep_ssm),
                           full, _jax_mesh(m)))
    return spec[1:] if stacked else spec


CUTS = [("internvl2-76b", True, 2), ("internvl2-76b", False, 4),
        ("internvl2-76b", False, 8), ("llava-1.6-7b", True, 2),
        ("llava-1.6-7b", False, 4), ("qwen2.5-14b", False, 4),
        ("internvl2-76b", True, 4), ("deepseek-moe-16b", False, 2),
        ("deepseek-moe-16b", True, 4), ("granite-moe-1b-a400m", False, 4),
        ("mamba2-130m", False, 2), ("mamba2-130m", True, 8),
        ("hymba-1.5b", False, 2), ("hymba-1.5b", True, 2),
        ("whisper-small", False, 2), ("whisper-small", False, 8)]
# the port's SSM leaves cut by heads or channels, which the reference
# keeps whole, and the ones it keeps whole where the reference cuts
SSM_BY_HEADS = ("dt_bias", "A_log", "D", "conv_b", "out_norm")


@pytest.mark.parametrize("arch, smoke, m", CUTS, ids=[
    f"{a.split('-')[0]}-{'smoke' if s else 'full'}-{m}" for a, s, m in CUTS])
def test_every_parameters_cut_is_the_references(arch, smoke, m):
    """Equal to ``_leaf_spec``/``_guard`` leaf for leaf, but where the
    port runs a collective of its own (``launch/specs.py``'s named
    rules): where the kv heads do not divide the axis the port keeps every
    attention leaf (self, cross, the encoder's) whole; the QKV biases and
    whisper's ``b_up`` follow their weights; the router stays whole; where
    the SSD heads divide the axis ``bc_proj`` stays whole and the SSM's
    1-D leaves are cut by heads or channels (where they do not, both
    packages keep every SSM leaf whole: ``replicate_ssm``)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    ours = specs.param_pspecs(cfg, _mesh(m))
    shapes = {n: tuple(p.shape) for n, p in
              specs._meta_params(cfg).named_parameters()}
    attn_cut = cfg.num_kv_heads % m == 0
    ssm_cut = bool(cfg.ssm_state) and cfg.ssm_num_heads % m == 0
    for name, shape in shapes.items():
        want = _reference_decision(cfg, name, shape, m)
        parts = ["", *name.split(".")]
        if parts[-2] in ("attn", "cross_attn") and not attn_cut:
            assert ours[name] == (None,) * len(shape), name
        elif parts[-1] in ("bq", "bk", "bv", "b_up"):
            w = name[:-4] + "w_up" if parts[-1] == "b_up" else \
                name[:-2] + "w" + name[-1]
            assert ours[name] == ours[w][-1:], name
        elif parts[-1] == "router":
            assert ours[name] == (None, None) != want, name
        elif parts[-2] == "ssm" and ssm_cut and parts[-1] == "bc_proj":
            assert ours[name] == (None, None) != want, name
        elif parts[-2] == "ssm" and ssm_cut and parts[-1] in SSM_BY_HEADS:
            assert ours[name] == ("model",) != want, name
        else:
            assert ours[name] == want, (name, ours[name], want)
    assert any(s == ("model", None) for s in ours.values())
    if cfg.ssm_state and not ssm_cut:
        assert all(s == (None,) * len(s) for n, s in ours.items()
                   if ".ssm." in n)


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


def _concat(parts, spec, halves=1):
    """The ranks' pieces put back together; a leaf of ``halves`` blocks
    (``in_proj``'s ``[x | z]``) block by block."""
    dims = [d for d, ax in enumerate(spec) if ax == "model"]
    if not dims:
        return parts[0]
    blocks = [torch.chunk(p, halves, dims[0]) for p in parts]
    return torch.cat([b[i] for i in range(halves) for b in blocks], dims[0])


def _shards_concatenate(cfg, m):
    """``shard_params`` of a whole model and ``init_params(sharding=)``,
    which never builds the whole model: both give each rank its piece of
    the same seeded weights.  Returns the plans."""
    whole = init_params(cfg, seed=3, device="cpu")
    plans = [ServingSharding(_mesh(m, r), cfg) for r in range(m)]
    cut = [p.shard(whole) for p in plans]
    drawn = [init_params(cfg, seed=3, device="cpu", sharding=p)
             for p in plans]
    for shards in (cut, drawn):
        assert all(s.sharding is p for s, p in zip(shards, plans))
        named = [dict(s.named_parameters()) for s in shards]
        for name, w in whole.named_parameters():
            got = _concat([n[name] for n in named], plans[0].specs[name],
                          specs.halves(name))
            assert torch.equal(got, w), name
    assert cut[0].cfg == plans[0].local_cfg
    return plans


@pytest.mark.parametrize("m", [2, 4])
def test_shards_concatenate_to_the_whole_model(m):
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32",
                              compute_dtype="float32")
    plans = _shards_concatenate(cfg, m)
    assert plans[0].local_cfg.d_ff == cfg.d_ff // m


FAMILY_SHARDS = [("deepseek-moe-16b", 2), ("deepseek-moe-16b", 4),
                 ("granite-moe-1b-a400m", 2), ("mamba2-130m", 2),
                 ("mamba2-130m", 4), ("hymba-1.5b", 2),
                 ("whisper-small", 2)]


@pytest.mark.parametrize("arch, m", FAMILY_SHARDS,
                         ids=[f"{a.split('-')[0]}-{m}"
                              for a, m in FAMILY_SHARDS])
def test_family_shards_concatenate_to_the_whole_model(arch, m):
    """The same for the families the plan cuts by expert or by SSD head:
    the ranks' experts stack back into every expert, each half of
    ``in_proj``'s ``[x | z]`` is every rank's channels of that half, and
    ``A_log`` (drawn whole, then cut) is the whole model's."""
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    plans = _shards_concatenate(cfg, m)
    w = plans[0].widths
    if cfg.num_experts:
        assert plans[0].cuts.experts and w.experts == cfg.num_experts // m
        assert [p.expert_range for p in plans] == [
            (r * w.experts, w.experts) for r in range(m)]
        assert plans[0].local_cfg.num_experts == cfg.num_experts
    if cfg.ssm_state:
        assert plans[0].cuts.ssm and w.ssm_heads == cfg.ssm_num_heads // m


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


# arch, m -> the cuts (attn, mlp, vocab, experts, ssm) and the rank's
# widths (routed experts, shared experts' hidden units, SSD heads)
FAMILY_PLANS = {
    ("deepseek-moe-16b", 2): ((True, True, True, True, False),
                              (32, 1408, 0)),
    ("deepseek-moe-16b", 4): ((True, True, True, True, False), (16, 704, 0)),
    ("granite-moe-1b-a400m", 2): ((True, False, False, True, False),
                                  (16, 0, 0)),
    ("granite-moe-1b-a400m", 4): ((True, False, False, True, False),
                                  (8, 0, 0)),
    ("mamba2-130m", 2): ((False, False, True, False, True), (0, 0, 12)),
    ("mamba2-130m", 4): ((False, False, True, False, True), (0, 0, 6)),
    ("hymba-1.5b", 2): ((False, True, False, False, False), (0, 0, 25)),
    ("hymba-1.5b", 4): ((False, True, False, False, False), (0, 0, 25)),
    ("whisper-small", 2): ((True, True, False, False, False), (0, 0, 0)),
    ("whisper-small", 4): ((True, True, False, False, False), (0, 0, 0)),
}


@pytest.mark.parametrize("arch, m", list(FAMILY_PLANS),
                         ids=[f"{a.split('-')[0]}-{m}"
                              for a, m in FAMILY_PLANS])
def test_every_family_builds_a_plan_with_its_cuts(arch, m):
    """The MoE, SSM, hybrid and encoder-decoder families at their full
    widths on 2 and 4 ranks: what the plan cuts and the rank's widths.
    deepseek's experts, attention, shared experts and vocabulary all
    divide; granite's and whisper's odd vocabularies stay whole; mamba2's
    24 SSD heads divide (it has no attention or MLP); hymba's 5 kv heads
    and 25 SSD heads do not (attention and every SSM leaf whole, the
    reference's ``replicate_ssm``), its MLP is cut.  The rank's config
    keeps the whole ``num_experts`` and ``d_ff`` of a MoE (routing and
    capacity read them) and its SSM fields."""
    cfg = get_config(arch)
    plan = ServingSharding(_mesh(m, m - 1), cfg)
    (attn, mlp, vocab, experts, ssm), widths = FAMILY_PLANS[arch, m]
    assert plan.cuts == specs.Cuts(attn=attn, mlp=mlp, vocab=vocab,
                                   experts=experts, ssm=ssm)
    assert plan.widths == specs.Widths(*widths)
    local = plan.local_cfg
    assert (local.num_experts, local.ssm_inner, local.ssm_num_heads) == (
        cfg.num_experts, cfg.ssm_inner, cfg.ssm_num_heads)
    if cfg.arch_type == "moe":
        assert local.d_ff == cfg.d_ff
        assert plan.expert_range == ((m - 1) * widths[0], widths[0])
    shard = plan.local_model()
    assert shard.widths == plan.widths
    cache = shard.make_cache(2, 8, device="meta")
    if cfg.ssm_state:
        assert cache["ssm_h"].shape[2] == widths[2]
        assert cache["ssm_conv"].shape[3] == widths[2] * cfg.ssm_head_dim
    if cfg.is_encoder_decoder:
        assert cache["cross_k"].shape[3] == local.num_kv_heads == \
            cfg.num_kv_heads // m


def test_what_a_mesh_does_not_serve_yet_raises(runs, capsys):
    """The ``data`` axis serves now: the two ranks' ``2 x 1`` mesh had
    world ranks 0 and 1 at data coordinates 0 and 1 on model coordinate
    0, a ``model`` group of 1 and a ``data`` group of 2 (a ``ServingMesh``
    computes the same coordinates without a process group).  Still
    refused: training under a mesh (the next slice, ROADMAP.md queue 1)
    and ``--mesh`` with ``--fleet``, which the JAX launcher has no path
    for either: its ``--fleet`` returns before it reads ``--mesh``."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import serve
    r2 = runs[2]
    for rank in (0, 1):
        facts = r2[rank]["data-paged"]["facts"]
        assert facts["coords"] == (rank, rank, 0)
        assert facts["groups"] == (1, 2)
    coords = [(m.data_rank, m.model_rank, m.world) for m in (
        ServingMesh(data=2, model=2, rank=r, backend="gloo",
                    device=torch.device("cpu")) for r in range(4))]
    assert coords == [(0, 0, 4), (0, 1, 4), (1, 0, 4), (1, 1, 4)]
    with pytest.raises(NotImplementedError, match="next slice"):
        specs.make_step_fn(smoke_configs(ARCH)[1], "train",
                           INPUT_SHAPES["train_4k"])
    with pytest.raises(SystemExit):
        serve.main(["--mesh", "1x2", "--fleet", "2", "--device", "cpu"])
    assert "returns before it reads --mesh" in capsys.readouterr().err
