"""Chunked prefill (``EngineConfig.prefill_chunk_tokens``) in the port's
engine against its monolithic prefill and against the JAX engine's
chunked prefill, on qwen2.5-14b's smoke config at G 5 with nonzero QKV
biases (``_torch_serve``).

Same traffic as ``test_torch_gqa_engine.py`` with chunks of 32 tokens:
``mpic`` k=8 (its ~40-170 selected tokens in chunks) and
``full_recompute`` (every prompt token in chunks) on an fp32 and an int8
pool, and ``mpic`` on the dense cache.  Greedy tokens must equal both the
monolithic run's and the JAX chunked run's; first-token logits agree
within 1e-3 (as in ``test_torch_engine.py``: the chunks attend to the
same keys, only the sums' order changes); the chunk counts equal the JAX
engine's and exceed one.  One exception, the reference's design: a
chunked ``mpic`` prefill runs over a dense blended cache in the compute
dtype and is spliced into the pool afterwards, where the monolithic one
on an int8 pool attends to the quantized pages.  There the monolithic
run is the fp32 pool's (its first token comes from unquantized KV too),
and only the first-token logits are held to it.  The engine decodes the
running slots between a request's chunks, and a chunk that raises frees
the request's slot and pages.
"""
import numpy as np
import pytest
import torch

from repro_torch.serving import EngineConfig, MPICEngine, Request
from repro_torch.data import make_dialogues

from _torch_serve import build_gqa_pair, serve
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

CHUNK = 32
SETUPS = [("mpic", "", True), ("mpic", "int8", True),
          ("full_recompute", "", True), ("full_recompute", "int8", True),
          ("mpic", "", False)]
IDS = [f"{p}-{pool or 'fp32'}" + ("" if paged else "-dense")
       for p, pool, paged in SETUPS]


@pytest.fixture(scope="module")
def pair():
    return build_gqa_pair("qwen-g5")


def _int8_mpic(setup):
    policy, pool, _ = setup
    return policy == "mpic" and pool == "int8"


@pytest.fixture(scope="module", params=SETUPS, ids=IDS)
def served(request, pair):
    jmodel, jparams, tmodel, tparams = pair
    policy, pool, paged = request.param
    mono_pool = "" if _int8_mpic(request.param) else pool
    return (request.param,
            serve("jax", jmodel, jparams, policy, pool, paged,
                  prefill_chunk_tokens=CHUNK),
            serve("torch", tmodel, tparams, policy, pool, paged,
                  prefill_chunk_tokens=CHUNK),
            serve("torch", tmodel, tparams, policy, mono_pool, paged))


def test_chunked_tokens_equal_monolithic_and_jax(served):
    setup, (jreqs, _, _), (treqs, _, teng), (mreqs, _, _) = served
    for jr, tr, mr in zip(jreqs, treqs, mreqs):
        assert tr.done
        assert tr.output_tokens == jr.output_tokens
        if not _int8_mpic(setup):
            assert tr.output_tokens == mr.output_tokens
        assert tr.linked_media == jr.linked_media
    if teng.pool is not None:
        assert teng.pool.free_pages == teng.pool.cfg.num_pages - 1
    assert not teng._prefill_tasks


def test_chunked_first_logits_agree(served):
    _, (jreqs, jfirst, _), (treqs, tfirst, _), (_, mfirst, _) = served
    for jr, tr, jl, tl, ml in zip(jreqs, treqs, jfirst, tfirst, mfirst):
        for key in ("n_recomputed", "n_reused", "engine_steps", "chunks"):
            assert tr.prefill_stats[key] == jr.prefill_stats[key], key
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
        np.testing.assert_allclose(tl, ml, atol=1e-3, rtol=0)


def test_long_prompts_run_in_several_chunks(served):
    _, _, (treqs, _, teng), _ = served
    chunks = [r.prefill_stats.get("chunks", 1) for r in treqs]
    # the three dialogues are longer than a chunk; their selections too
    assert all(c > 1 for c in chunks[:3]), chunks
    n = [r.prefill_stats["n_recomputed"] for r in treqs[:3]]
    assert chunks[:3] == [-(-x // CHUNK) for x in n]
    assert teng.report()["scheduler"]["chunked_prefills"] >= 3


def test_decode_runs_between_chunks(pair):
    """While one slot's prefill is between chunks, the other slot's
    running request gains a token every step."""
    _, _, tmodel, tparams = pair
    seen = []

    def watch(eng):
        if eng._prefill_tasks:
            seen.append(tuple(len(r.output_tokens) for r in eng.running
                              if r is not None and r.output_tokens))

    serve("torch", tmodel, tparams, "full_recompute", max_new=12,
          prefill_chunk_tokens=CHUNK, on_step=watch)
    grew = [a[0] < b[0] for a, b in zip(seen, seen[1:]) if a and b]
    assert sum(grew) >= 2, seen


@pytest.mark.parametrize("pool", ["", "int8"], ids=["fp32", "int8"])
def test_aborted_chunk_frees_the_slot(pair, pool):
    _, _, tmodel, tparams = pair
    eng = MPICEngine(tmodel, tparams, EngineConfig(
        max_seq_len=256, decode_slots=2, pool_dtype=pool,
        prefill_chunk_tokens=CHUNK, greedy=False), device="cpu")
    cfg = tmodel.cfg
    (s,) = make_dialogues(n=1, n_images=2, d_model=cfg.d_model,
                          media_len=cfg.media_token_len)
    for _, seg in s.prompt.media_segments():
        eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    req = eng.submit(Request(prompt=s.prompt, max_new_tokens=4,
                             policy="full_recompute"))
    eng.step()                                   # the first chunk
    assert req.slot == 0 and 0 in eng._prefill_tasks
    calls = []
    prefill = tmodel.prefill

    def failing(*a, **k):
        calls.append(1)
        raise RuntimeError("chunk failed")

    object.__setattr__(tmodel, "prefill", failing)
    try:
        with pytest.raises(RuntimeError, match="chunk failed"):
            eng.step()
    finally:
        object.__delattr__(tmodel, "prefill")
    assert tmodel.prefill == prefill and calls
    assert req.state.value == "failed" and "chunk failed" in req.error
    assert eng.failed == [req] and req.slot == -1
    assert eng.running == [None, None] and not eng._prefill_tasks
    assert req.req_id not in eng._rngs
    assert eng.pool.free_pages == eng.pool.cfg.num_pages - 1
    # the engine serves on: the same prompt again, in chunks
    again = eng.submit(Request(prompt=s.prompt, max_new_tokens=4,
                               policy="full_recompute"))
    eng.run()
    assert again.done and again.prefill_stats["chunks"] > 1
    assert torch.is_tensor(eng.pool.k)
