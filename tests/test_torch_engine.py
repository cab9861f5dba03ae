"""End-to-end parity of the port's engine with the JAX reference engine.

Same traffic through both: three two-image dialogues and one MRAG request
on the fp32 llava smoke config, two decode slots (so requests queue and
batch), every request under one policy: mpic k=8, cacheblend r=0.25,
full_recompute, prefix_caching (both engines' prefix stores hold the
system prompt's KV) or full_reuse.  Each policy runs on the paged engine
with an fp32 pool and with an int8 pool (the port's int8 pool against the
reference's), and mpic once more on the dense batch cache
(``paged=False``).  Greedy tokens must be identical and every page must
return to the pool; first-token logits agree to 1e-3, and ``n_recomputed``,
``n_reused`` and ``engine_steps`` are equal.
"""
import numpy as np
import pytest

from repro_torch.models.layers import INVALID_POS

from _torch_parity import build_pair
from _torch_serve import serve
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

MAX_NEW = 6
# (policy, pool dtype, paged); the mpic cases keep their original ids
SETUPS = [("mpic", "", True), ("mpic", "int8", True)] + [
    (p, pool, True) for p in ("cacheblend", "full_recompute",
                              "prefix_caching", "full_reuse")
    for pool in ("", "int8")] + [("mpic", "", False)]
IDS = ["fp32", "int8"] + [f"{p}-{pool or 'fp32'}" for p, pool, _ in
                          SETUPS[2:-1]] + ["mpic-dense"]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module", params=SETUPS, ids=IDS)
def served(request, pair):
    jmodel, jparams, tmodel, tparams = pair
    return (request.param,
            serve("jax", jmodel, jparams, *request.param, max_new=MAX_NEW),
            serve("torch", tmodel, tparams, *request.param,
                  max_new=MAX_NEW))


def test_engine_greedy_tokens_identical(served):
    (policy, pool_dtype, paged), (jreqs, _, jeng), (treqs, _, teng) = served
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert len(tr.output_tokens) == MAX_NEW
        assert tr.output_tokens == jr.output_tokens
        assert tr.linked_media == jr.linked_media
    assert "RAG1" in treqs[-1].linked_media
    assert teng.report()["paged"] == paged
    if paged:
        assert teng.pool.quantized == (pool_dtype == "int8")
        # every page but the scratch page went back to the pool
        assert teng.pool.free_pages == teng.pool.cfg.num_pages - 1
    else:
        assert teng.pool is None
        # every finished slot was emptied; the last slot keeps what the
        # idle slots' decode writes there
        assert bool((teng._batch_cache["pos"][:, :-1] == INVALID_POS).all())


def test_engine_first_token_logits_agree(served):
    _, (jreqs, jfirst, _), (treqs, tfirst, _) = served
    for jr, tr, jl, tl in zip(jreqs, treqs, jfirst, tfirst):
        assert tr.prompt.total_len == jr.prompt.total_len
        for key in ("n_recomputed", "n_reused", "engine_steps"):
            assert tr.prefill_stats[key] == jr.prefill_stats[key], key
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
