"""Shared set-up of the MoE engine parity tests (one file per model, so
that the test run spreads them over its workers): the smoke config's
pair of models, one setup served through both engines, and the checks.

Every pass routes all the rows it carries (the paged prefill's bucket pad
rows and the decode step's idle slot too), so the greedy tokens agree
only if every (token, choice) pair is kept or dropped as in JAX.  As in
``test_torch_engine.py``: greedy tokens identical, every page back in the
pool, first-token logits within 1e-3, and ``n_recomputed``, ``n_reused``
and ``engine_steps`` equal; unchunked runs are shown to drop pairs (the
prompts' 190-208 tokens pass T = 64), chunked ones (32 rows a pass) to
drop none.

Tensor parallelism: two gloo ranks (``tests/_torch_sharded.py``), started
when the module starts, serve every setup through ``MPICEngine(mesh=)``
(:func:`serve_rank`: half the experts a rank, every row routed with the
whole router over every expert); :func:`check_ranks` holds them to the
same setup's JAX and unsharded runs: the JAX engine's tokens, first-token
logits within 1e-4 relative of the port's unsharded engine's (fp32 pool:
of the JAX engine's too; int8: within its 1e-3), every routing pass
dropping the unsharded engine's pairs, every page back.
"""
import jax
import numpy as np

from _torch_parity import build_pair
from _torch_serve import serve
from _torch_sharded import REL, Ranks, counting_drops, rel

POLICIES = ("mpic", "full_recompute", "cacheblend")
CHUNKED = {"prefill_chunk_tokens": 32}
_PAIRS = {}


def setups(chunked: bool):
    """(policy, pool dtype, engine kwargs): every policy on both pools,
    and with ``chunked`` mpic in chunks of 32 tokens."""
    out = [(p, pool, None) for p in POLICIES for pool in ("", "int8")]
    return out + ([("mpic", "", CHUNKED)] if chunked else [])


def ids(arch_setups):
    return [f"{p}-{pool or 'fp32'}" + ("-chunked" if kw else "")
            for p, pool, kw in arch_setups]


def pair(arch):
    """The arch's pair of models (built once a process)."""
    if arch not in _PAIRS:
        _PAIRS[arch] = build_pair(arch=arch)
    return _PAIRS[arch]


def serve_both(arch, policy, pool, kw):
    """The setup through the JAX engine and the port's, counting the pairs
    the port's capacity dropped: (jax out, port out, every routing pass's
    (rows, dropped pairs))."""
    jmodel, jparams, tmodel, tparams = pair(arch)
    jout = serve("jax", jmodel, jparams, policy, pool, **(kw or {}))
    with counting_drops() as counted:
        tout = serve("torch", tmodel, tparams, policy, pool, **(kw or {}))
    return jout, tout, counted.drops


def serve_rank(model, params, mesh, policy, pool, kw):
    """One setup on a rank of the spawned ranks, through
    ``MPICEngine(mesh=)`` on the whole weights: its requests' tokens and
    linked media, first-token logits, every routing pass's (rows, dropped
    pairs), the routed experts the rank holds, whether every page came
    back."""
    with counting_drops() as counted:
        reqs, firsts, eng = serve("torch", model, params, policy, pool,
                                  mesh=mesh, **(kw or {}))
    try:
        return {"tokens": [r.output_tokens for r in reqs],
                "linked": [r.linked_media for r in reqs],
                "firsts": firsts, "drops": counted.drops,
                "experts": eng.params.layers[0].moe.w_up.shape[0],
                "pages_back": (eng.pool.free_pages
                               == eng.pool.cfg.num_pages - 1)}
    finally:
        eng.close()


def start_ranks(arch, arch_setups) -> Ranks:
    """Two ranks serving every setup (:func:`serve_rank`), started now."""
    _, jparams, tmodel, _ = pair(arch)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return Ranks(2, tmodel.cfg, tree, [
        (name, "call", {"target": "_torch_moe_serve:serve_rank",
                        "policy": p, "pool": pool, "kw": kw})
        for name, (p, pool, kw) in zip(ids(arch_setups), arch_setups)])


def check_tokens(setup, jout, tout, dropped):
    _, pool, kw = setup
    (jreqs, _, _), (treqs, _, teng) = jout, tout
    # chunks of 32 rows never pass T = 64: no pair can drop there
    assert (sum(d for _, d in dropped) > 0) != bool(kw)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.output_tokens == jr.output_tokens
        assert tr.linked_media == jr.linked_media
    assert "RAG1" in treqs[-1].linked_media
    assert teng.pool.quantized == (pool == "int8")
    assert teng.pool.free_pages == teng.pool.cfg.num_pages - 1
    if kw:
        assert min(r.prefill_stats.get("chunks", 1) for r in treqs[:-1]) > 1


def check_logits(jout, tout):
    (jreqs, jfirst, _), (treqs, tfirst, _) = jout, tout
    for jr, tr, jl, tl in zip(jreqs, treqs, jfirst, tfirst):
        for key in ("n_recomputed", "n_reused", "engine_steps"):
            assert tr.prefill_stats.get(key) == jr.prefill_stats.get(key), key
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)


def check_ranks(setup, jout, tout, dropped, ranks):
    """Both ranks' run of ``setup`` against the JAX engine's and the
    port's unsharded one (see the module's notes)."""
    _, pool, kw = setup
    (jreqs, jfirst, _), (treqs, tfirst, teng) = jout, tout
    name = ids([setup])[0]
    if not kw:
        assert any(rows > 64 and d > 0 for rows, d in dropped)
    for rank in (0, 1):
        got = ranks[rank][name]
        assert got["tokens"] == [r.output_tokens for r in jreqs]
        assert got["linked"] == [r.linked_media for r in treqs]
        assert got["drops"] == dropped
        assert got["experts"] == teng.model.cfg.num_experts // 2
        assert got["pages_back"]
        for g, t, j in zip(got["firsts"], tfirst, jfirst):
            assert rel(g, t) <= REL
            if pool:
                np.testing.assert_allclose(g, j, atol=1e-3, rtol=0)
            else:
                assert rel(g, j) <= REL
