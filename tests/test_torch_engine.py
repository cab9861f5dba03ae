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

import jax.numpy as jnp
import torch

from repro.data import ByteTokenizer as JaxTokenizer
from repro.data import SYSTEM_PROMPT
from repro.data import make_dialogues as jax_dialogues
from repro.data import image_embeds as jax_image_embeds
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.core import Prompt as JaxPrompt
from repro.core import text_segment as jax_text
from repro_torch.core import Prompt, text_segment
from repro_torch.data import image_embeds, make_dialogues
from repro_torch.models.layers import INVALID_POS
from repro_torch.serving import EngineConfig, MPICEngine, Request

from _torch_parity import build_pair

MAX_NEW = 6
K = 8


KWARGS = {"mpic": {"k": K}, "cacheblend": {"r": 0.25}}
# (policy, pool dtype, paged); the mpic cases keep their original ids
SETUPS = [("mpic", "", True), ("mpic", "int8", True)] + [
    (p, pool, True) for p in ("cacheblend", "full_recompute",
                              "prefix_caching", "full_reuse")
    for pool in ("", "int8")] + [("mpic", "", False)]
IDS = ["fp32", "int8"] + [f"{p}-{pool or 'fp32'}" for p, pool, _ in
                          SETUPS[2:-1]] + ["mpic-dense"]


def _store_system_prompt(pkg, eng, model, params):
    """Put the system prompt's KV into the engine's prefix store."""
    sys_toks = JaxTokenizer().encode(SYSTEM_PROMPT, bos=True)
    n = len(sys_toks)
    if pkg == "jax":
        cache = model.make_cache(1, n + 1)
        _, cache = model.prefill(params, jnp.asarray(sys_toks[None]), cache)
    else:
        cache = model.make_cache(1, n + 1, device="cpu")
        _, cache = model.prefill(
            params, torch.as_tensor(sys_toks[None], dtype=torch.int32), cache)
    eng.prefix_store.put(sys_toks, cache["k"][:, 0, :n], cache["v"][:, 0, :n])


def _serve(pkg, model, params, policy, pool_dtype, paged):
    """Run the traffic through one package's engine.  Returns (requests,
    first-token logits per request, engine)."""
    if pkg == "jax":
        eng = JaxEngine(model, params, JaxEngineConfig(
            max_seq_len=256, decode_slots=2, paged_backend="ref",
            pool_dtype=pool_dtype, pipelined=False, paged=paged))
        dialogues, embeds, text, mk_prompt, mk_req = (
            jax_dialogues, jax_image_embeds, jax_text, JaxPrompt, JaxRequest)
    else:
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype,
            paged=paged), device="cpu")
        dialogues, embeds, text, mk_prompt, mk_req = (
            make_dialogues, image_embeds, text_segment, Prompt, Request)
    _store_system_prompt(pkg, eng, model, params)
    cfg = model.cfg
    firsts = {}
    finalize = eng._finalize_prefill

    def record(req, result, *rest):
        firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
        return finalize(req, result, *rest)

    eng._finalize_prefill = record
    samples = dialogues(n=3, n_images=2, d_model=cfg.d_model,
                        media_len=cfg.media_token_len)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    rag = embeds("RAG1", 12, cfg.d_model)
    eng.upload("*", "RAG1", rag, dynamic=True)
    kw = KWARGS.get(policy, {})
    reqs = [mk_req(prompt=s.prompt, max_new_tokens=MAX_NEW, policy=policy,
                   policy_kwargs=kw) for s in samples]
    mrag = mk_req(prompt=mk_prompt([text(np.arange(20, 60))], user_id="u0"),
                  max_new_tokens=MAX_NEW, policy=policy, policy_kwargs=kw)
    mrag.retrieval_query = rag.mean(0)
    reqs.append(mrag)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, [firsts[r.req_id] for r in reqs], eng


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module", params=SETUPS, ids=IDS)
def served(request, pair):
    jmodel, jparams, tmodel, tparams = pair
    return (request.param,
            _serve("jax", jmodel, jparams, *request.param),
            _serve("torch", tmodel, tparams, *request.param))


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
