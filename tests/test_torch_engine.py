"""End-to-end parity of the port's engine with the JAX reference engine.

Same traffic through both: three two-image dialogues and one MRAG request
on the fp32 llava smoke config, mpic k=8, two decode slots (so requests
queue and batch).  Greedy tokens must be identical, for the fp32 pool and
for the int8 pool (the port's int8 pool against the reference's int8 pool);
first-token logits agree to 1e-3.
"""
import numpy as np
import pytest

from repro.data import make_dialogues as jax_dialogues
from repro.data import image_embeds as jax_image_embeds
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.core import Prompt as JaxPrompt
from repro.core import text_segment as jax_text
from repro_torch.core import Prompt, text_segment
from repro_torch.data import image_embeds, make_dialogues
from repro_torch.serving import EngineConfig, MPICEngine, Request

from _torch_parity import build_pair

MAX_NEW = 6
K = 8


def _serve(pkg, model, params, pool_dtype):
    """Run the traffic through one package's engine.  Returns (requests,
    first-token logits per request, engine)."""
    if pkg == "jax":
        eng = JaxEngine(model, params, JaxEngineConfig(
            max_seq_len=256, decode_slots=2, paged_backend="ref",
            pool_dtype=pool_dtype, pipelined=False))
        dialogues, embeds, text, mk_prompt, mk_req = (
            jax_dialogues, jax_image_embeds, jax_text, JaxPrompt, JaxRequest)
    else:
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype),
            device="cpu")
        dialogues, embeds, text, mk_prompt, mk_req = (
            make_dialogues, image_embeds, text_segment, Prompt, Request)
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
    reqs = [mk_req(prompt=s.prompt, max_new_tokens=MAX_NEW,
                   policy_kwargs={"k": K}) for s in samples]
    mrag = mk_req(prompt=mk_prompt([text(np.arange(20, 60))], user_id="u0"),
                  max_new_tokens=MAX_NEW, policy_kwargs={"k": K})
    mrag.retrieval_query = rag.mean(0)
    reqs.append(mrag)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, [firsts[r.req_id] for r in reqs], eng


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module", params=["", "int8"], ids=["fp32", "int8"])
def served(request, pair):
    jmodel, jparams, tmodel, tparams = pair
    return (request.param, _serve("jax", jmodel, jparams, request.param),
            _serve("torch", tmodel, tparams, request.param))


def test_engine_greedy_tokens_identical(served):
    pool_dtype, (jreqs, _, jeng), (treqs, _, teng) = served
    assert teng.pool.quantized == (pool_dtype == "int8")
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert len(tr.output_tokens) == MAX_NEW
        assert tr.output_tokens == jr.output_tokens
        assert tr.linked_media == jr.linked_media
    assert "RAG1" in treqs[-1].linked_media
    # every page but the scratch page went back to the pool
    assert teng.pool.free_pages == teng.pool.cfg.num_pages - 1


def test_engine_first_token_logits_agree(served):
    _, (jreqs, jfirst, _), (treqs, tfirst, _) = served
    for jr, tr, jl, tl in zip(jreqs, treqs, jfirst, tfirst):
        assert tr.prompt.total_len == jr.prompt.total_len
        assert tr.prefill_stats["n_recomputed"] == \
            jr.prefill_stats["n_recomputed"]
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
