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
"""
import numpy as np

from repro_torch.models import moe

from _torch_parity import build_pair
from _torch_serve import serve

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


def serve_both(arch, policy, pool, kw):
    """The setup through the JAX engine and the port's, counting the pairs
    the port's capacity dropped: (jax out, port out, dropped)."""
    if arch not in _PAIRS:
        _PAIRS[arch] = build_pair(arch=arch)
    jmodel, jparams, tmodel, tparams = _PAIRS[arch]
    jout = serve("jax", jmodel, jparams, policy, pool, **(kw or {}))
    dropped = []
    route = moe.route

    def counting(*args, **kwargs):
        out = route(*args, **kwargs)
        dropped.append(int((~out[4]).sum()))
        return out

    moe.route = counting
    try:
        tout = serve("torch", tmodel, tparams, policy, pool, **(kw or {}))
    finally:
        moe.route = route
    return jout, tout, sum(dropped)


def check_tokens(setup, jout, tout, dropped):
    _, pool, kw = setup
    (jreqs, _, _), (treqs, _, teng) = jout, tout
    # chunks of 32 rows never pass T = 64: no pair can drop there
    assert (dropped > 0) != bool(kw)
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
