"""The port's engine against the JAX package's, with every media block on
disk and admission pipelined.

Same traffic through both engines (the fp32 llava smoke config, weights
carried over): three two-image dialogues under ``mpic`` k=8, two decode
slots, each library under its own spool directory with every entry
spooled after the uploads, so that each request's media comes back
through the parallel loader.  Cases: an fp32 pool; an int8 pool fed by
a ``quantize=True`` library on both sides, checked against the JAX
package's int8 path; and ``max_prefills_per_step=2``.  Greedy tokens must
be identical, first-token logits within 1e-3 (as in
``test_torch_engine.py``), and ``direct_links``, the disk hits and the
misses equal; every media lookup is a disk hit and every pin is released.
"""
import numpy as np
import pytest

from repro.cache import KVLibrary as JaxLibrary
from repro.data import make_dialogues as jax_dialogues
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.cache import KVLibrary
from repro_torch.data import make_dialogues
from repro_torch.serving import EngineConfig, MPICEngine, Request

from _torch_parity import build_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

MAX_NEW = 5
N_REQ = 3
# (pool dtype, library quantize, max prefills per step)
CASES = {"fp32": ("", False, 1), "int8": ("int8", True, 1),
         "two_prefills": ("", False, 2)}


def _serve(pkg, model, params, spool, pool_dtype, quantize, per_step):
    kw = dict(max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype,
              pipelined=True,
              max_prefills_per_step=per_step)
    if pkg == "jax":
        lib = JaxLibrary(spool_dir=str(spool), quantize=quantize)
        eng = JaxEngine(model, params, JaxEngineConfig(
            paged_backend="ref", **kw), static_library=lib)
        dialogues, mk_req = jax_dialogues, JaxRequest
    else:
        lib = KVLibrary(spool_dir=str(spool), quantize=quantize)
        eng = MPICEngine(model, params, EngineConfig(**kw),
                         static_library=lib, device="cpu")
        dialogues, mk_req = make_dialogues, Request
    firsts = {}
    finalize = eng._finalize_prefill

    def record(req, result, *rest):
        firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
        return finalize(req, result, *rest)

    eng._finalize_prefill = record
    cfg = model.cfg
    samples = dialogues(n=N_REQ, n_images=2, d_model=cfg.d_model,
                        media_len=cfg.media_token_len, seed=11)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
            assert lib.spool_now(s.prompt.user_id, seg.media_id)
    reqs = [eng.submit(mk_req(prompt=s.prompt, max_new_tokens=MAX_NEW,
                              policy="mpic", policy_kwargs={"k": 8}))
            for s in samples]
    eng.run()
    if pkg == "torch":
        eng.close()
    return reqs, [firsts[r.req_id] for r in reqs], eng, lib


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("case", list(CASES))
def test_disk_resident_pipelined_engine_matches_reference(case, pair,
                                                          tmp_path):
    pool_dtype, quantize, per_step = CASES[case]
    jmodel, jparams, tmodel, tparams = pair
    jreqs, jfirst, _, jlib = _serve("jax", jmodel, jparams, tmp_path / "jax",
                                    pool_dtype, quantize, per_step)
    treqs, tfirst, teng, tlib = _serve("torch", tmodel, tparams,
                                       tmp_path / "torch", pool_dtype,
                                       quantize, per_step)
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.output_tokens == jr.output_tokens
        assert len(tr.output_tokens) == MAX_NEW
    np.testing.assert_allclose(np.stack(tfirst), np.stack(jfirst), atol=1e-3,
                               rtol=0)
    jst, tst = jlib.stats(), tlib.stats()
    placed = 2 * N_REQ
    assert tst["tiers"]["disk"]["hits"] == jst["tiers"]["disk"]["hits"] \
        == placed
    assert tst["tiers"]["disk"]["corrupt"] == 0
    assert tst["misses"] == jst["misses"] == 0
    assert tst["direct_links"] == jst["direct_links"] == (
        placed if quantize else 0)
    assert tst["dequants"] == jst["dequants"] == 0
    assert all(e.pins == 0 for e in tlib._entries.values())
    rep = teng.report()
    sched = rep["scheduler"]
    assert sched["pipelined"] and sched["admitted"] == N_REQ
    assert sched["mean_load_s"] > 0.0
    assert all(r.load_s > 0 and r.compute_s > 0 and
               0.0 <= r.overlap_s <= r.load_s for r in treqs)
    assert teng.loader.load_failures == 0
    assert teng.pool.free_pages == teng.pool.cfg.num_pages - 1


def test_sequential_baseline_waits_before_compute(pair, tmp_path):
    """``pipelined=False``: a request's media is loaded when it is popped,
    before its compute, so nothing it loads overlaps its own compute."""
    _, _, tmodel, tparams = pair
    lib = KVLibrary(spool_dir=str(tmp_path))
    eng = MPICEngine(tmodel, tparams, EngineConfig(
        max_seq_len=256, decode_slots=2, pipelined=False),
        static_library=lib, device="cpu")
    cfg = tmodel.cfg
    samples = make_dialogues(n=2, n_images=2, d_model=cfg.d_model,
                             media_len=cfg.media_token_len, seed=11)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
            lib.spool_now(s.prompt.user_id, seg.media_id)
    reqs = [eng.submit(Request(prompt=s.prompt, max_new_tokens=2,
                               policy="mpic", policy_kwargs={"k": 8}))
            for s in samples]
    # nothing is prefetched while the requests wait
    assert not eng.scheduler._handles
    eng.run()
    eng.close()
    assert all(r.done and r.load_s > 0 and r.overlap_s == 0 for r in reqs)
    assert eng.report()["scheduler"]["pipelined"] is False
    assert lib.stats()["tiers"]["disk"]["hits"] == 4
