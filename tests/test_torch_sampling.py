"""Seeded sampling (``EngineConfig.greedy=False``, ``temperature``,
``top_k``, ``Request.seed``) in the port's engine against the JAX
engine's.

``_select_token`` draws with a numpy generator seeded by the request's
seed, in float64, after the same top-k cut, so the port's draws must be
the JAX engine's bit for bit: over seeds, temperatures and top-k values,
on the same logits rows (seeded numpy, some with ties at the k-th value),
every token of a 12-draw stream is equal.  End to end on qwen2.5-14b's
smoke config at G 5 with nonzero QKV biases (``_torch_serve``), on an
fp32 and an int8 pool: the sampled tokens equal the JAX engine's, one
seed twice gives the same tokens, ``top_k=1`` gives the greedy tokens,
and every generator is dropped with its request.
"""
import types

import numpy as np
import pytest

from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro_torch.serving import EngineConfig, MPICEngine

from _torch_serve import build_gqa_pair, serve
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

SEEDS = [0, 1, 7, 12345]
SAMPLED = dict(greedy=False, temperature=0.8, top_k=8)


def _selector(cfg_cls, **cfg):
    """An object that an engine's ``_select_token`` can run on: the
    engine's config and its generator map, nothing else."""
    return types.SimpleNamespace(cfg=cfg_cls(**cfg), _rngs={})


def _rows(seed, vocab=97, n=12):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((n, vocab)) * 3).astype(np.float32)
    rows[::3, :5] = rows[::3, :1]          # ties, also at the k-th value
    return rows


@pytest.mark.parametrize("top_k", [0, 1, 5, 8, 97, 200])
@pytest.mark.parametrize("temperature", [1e-7, 0.3, 1.0, 2.5])
def test_select_token_bit_identical(temperature, top_k):
    kw = dict(greedy=False, temperature=temperature, top_k=top_k)
    for seed in SEEDS:
        jsel = _selector(JaxEngineConfig, **kw)
        tsel = _selector(EngineConfig, **kw)
        req = types.SimpleNamespace(req_id="r", seed=seed)
        for row in _rows(seed):
            want = JaxEngine._select_token(jsel, req, row)
            got = MPICEngine._select_token(tsel, req, row)
            assert got == want
        if top_k == 1 or temperature < 1e-6:
            assert got == int(np.argmax(row))


def test_greedy_is_argmax():
    tsel = _selector(EngineConfig)
    req = types.SimpleNamespace(req_id="r", seed=3)
    for row in _rows(3):
        assert MPICEngine._select_token(tsel, req, row) == int(np.argmax(row))
    assert not tsel._rngs


@pytest.fixture(scope="module")
def pair():
    return build_gqa_pair("qwen-g5")


@pytest.mark.parametrize("pool", ["", "int8"], ids=["fp32", "int8"])
def test_engine_sampling_matches_reference(pair, pool):
    jmodel, jparams, tmodel, tparams = pair
    seeds = [3, 4, 5, 6]
    jreqs, _, _ = serve("jax", jmodel, jparams, "mpic", pool, seeds=seeds,
                        **SAMPLED)
    treqs, _, teng = serve("torch", tmodel, tparams, "mpic", pool,
                           seeds=seeds, **SAMPLED)
    again, _, _ = serve("torch", tmodel, tparams, "mpic", pool, seeds=seeds,
                        **SAMPLED)
    greedy, _, _ = serve("torch", tmodel, tparams, "mpic", pool)
    top1, _, _ = serve("torch", tmodel, tparams, "mpic", pool, seeds=seeds,
                       greedy=False, temperature=0.8, top_k=1)
    for jr, tr, ar, gr, t1 in zip(jreqs, treqs, again, greedy, top1):
        assert tr.done and len(tr.output_tokens) == 6
        assert tr.output_tokens == jr.output_tokens == ar.output_tokens
        assert t1.output_tokens == gr.output_tokens
    # sampling draws from more than the argmax
    assert [r.output_tokens for r in treqs] != [r.output_tokens
                                                for r in greedy]
    assert not teng._rngs
