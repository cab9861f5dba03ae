"""The port's engine against the JAX engine on the GQA/MHA decoders, at each
model's own query-head group (``_torch_serve.MODELS``; qwen2.5-14b with
nonzero QKV biases): three two-image dialogues and one MRAG request, two
decode slots.  qwen2.5-14b at G 5 runs every policy on an fp32 and an int8
pool and ``mpic`` on the dense cache; yi-9b (G 8), phi3-medium-14b (G 4)
and stablelm-1.6b (MHA, head dim 64) run ``mpic`` on both pools.  As in
``test_torch_engine.py``: greedy tokens identical, every page back in the
pool, first-token logits within 1e-3, and ``n_recomputed``, ``n_reused``
and ``engine_steps`` equal.
"""
import numpy as np
import pytest

from _torch_serve import build_gqa_pair, serve
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

POLICIES = ("mpic", "cacheblend", "full_recompute", "prefix_caching",
            "full_reuse")
# (case, policy, pool dtype, paged)
SETUPS = ([("qwen-g5", p, pool, True) for p in POLICIES
           for pool in ("", "int8")] + [("qwen-g5", "mpic", "", False)]
          + [(c, "mpic", pool, True) for c in ("yi-g8", "phi3-g4",
                                                 "stablelm-mha")
             for pool in ("", "int8")])
IDS = [f"{c}-{p}-{pool or 'fp32'}" + ("" if paged else "-dense")
       for c, p, pool, paged in SETUPS]
_PAIRS = {}


def _pair(case):
    if case not in _PAIRS:
        _PAIRS[case] = build_gqa_pair(case)
    return _PAIRS[case]


@pytest.fixture(scope="module", params=SETUPS, ids=IDS)
def served(request):
    case, policy, pool, paged = request.param
    jmodel, jparams, tmodel, tparams = _pair(case)
    return (request.param,
            serve("jax", jmodel, jparams, policy, pool, paged),
            serve("torch", tmodel, tparams, policy, pool, paged))


def test_engine_greedy_tokens_identical(served):
    (_, _, pool, paged), (jreqs, _, _), (treqs, _, teng) = served
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.output_tokens == jr.output_tokens
        assert tr.linked_media == jr.linked_media
    assert "RAG1" in treqs[-1].linked_media
    if paged:
        assert teng.pool.quantized == (pool == "int8")
        assert teng.pool.free_pages == teng.pool.cfg.num_pages - 1
    else:
        assert teng.pool is None


def test_engine_first_token_logits_agree(served):
    _, (jreqs, jfirst, _), (treqs, tfirst, _) = served
    for jr, tr, jl, tl in zip(jreqs, treqs, jfirst, tfirst):
        for key in ("n_recomputed", "n_reused", "engine_steps"):
            assert tr.prefill_stats[key] == jr.prefill_stats[key], key
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
