"""The four GQA/MHA decoders of the port against the JAX package: their
configs field for field, the weight bridge with QKV biases, and
``attention_qkv`` and every model pass at each model's own query-head
group: qwen2.5-14b at G 5 with nonzero QKV biases, yi-9b at G 8,
phi3-medium-14b at G 4 and stablelm-1.6b, MHA at head dim 64 (the smoke
configs, whose heads are overridden to keep each group; see
``_torch_serve.MODELS``).  The passes: ``precompute_media_kv``, the paged
selective prefill and decode on an fp32 and an int8 pool, and the dense
``selective_prefill``, ``prefill`` and ``decode_step``.  The JAX side runs
its ``ref`` kernels.  Tolerances are ``test_torch_model.py``'s: logits and
media K/V atol 1e-4 (fp32 sums in another order over two layers), dense
caches 1e-5 and positions exact, int8 codes within one step on at most
0.1% of entries.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.linker import precompute_media_kv as jax_precompute
from repro.models.layers import attention_qkv as jax_attention_qkv
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.linker import precompute_media_kv
from repro_torch.models.layers import INVALID_POS, attention_qkv, rope_relink

from _torch_serve import MODELS, build_gqa_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401
from test_torch_model import (
    ATOL,
    KV_LEN,
    SCRATCH,
    _as,
    _assert_cache_match,
    _assert_pools_match,
    _dense_cache,
    _inputs,
    _jax,
    _pools,
    _torch,
)

CASES = list(MODELS)
ARCHS = [arch for arch, _ in MODELS.values()]
GROUPS = {"qwen-g5": 5, "yi-g8": 8, "phi3-g4": 4, "stablelm-mha": 1}


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return request.param, build_gqa_pair(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_get_smoke_config(arch))


def test_cases_keep_each_models_group(case):
    name, (_, _, tmodel, _) = case
    cfg = tmodel.cfg
    assert cfg.num_heads // cfg.num_kv_heads == GROUPS[name]
    full = get_config(MODELS[name][0])
    assert full.num_heads // full.num_kv_heads == GROUPS[name]
    assert cfg.qkv_bias == full.qkv_bias == (name == "qwen-g5")


def test_weight_bridge_carries_nonzero_biases():
    _, jparams, tmodel, tparams = build_gqa_pair("qwen-g5")
    attn = jparams["layers"]["attn"]
    for i, lp in enumerate(tparams.layers):
        for name in ("bq", "bk", "bv"):
            want = np.asarray(attn[name][i])
            assert np.abs(want).max() > 0.1
            np.testing.assert_array_equal(getattr(lp.attn, name).numpy(),
                                          want)
    assert tparams.layers[0].attn.bq.shape == (tmodel.cfg.q_dim,)
    assert tparams.layers[0].attn.bk.shape == (tmodel.cfg.kv_dim,)


def test_init_params_zero_biases():
    """The port's seeded init makes zero biases, as ``init_attention``."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"),
                              param_dtype="float32")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, device="cpu")
    for lp in params.layers:
        for name in ("bq", "bk", "bv"):
            assert not getattr(lp.attn, name).any()
    plain = init_params(get_smoke_config("yi-9b"), device="cpu")
    assert not hasattr(plain.layers[0].attn, "bq")


def test_attention_qkv_matches(case):
    _, (jmodel, jparams, tmodel, tparams) = case
    cfg = tmodel.cfg
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 9)).astype(np.int32)
    jattn = {n: a[0] for n, a in jparams["layers"]["attn"].items()}
    jq, jk, jv = jax_attention_qkv(jattn, jmodel.cfg, jnp.asarray(x),
                                   jnp.asarray(pos))
    tq, tk, tv = attention_qkv(tparams.layers[0].attn, cfg,
                               torch.from_numpy(x), torch.from_numpy(pos))
    assert tq.shape == (2, 9, cfg.num_heads, cfg.head_dim)
    assert tk.shape == (2, 9, cfg.num_kv_heads, cfg.head_dim)
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)


def test_biased_media_kv_relinks_exactly():
    """The bias sits inside the rotated K, so relinking K stored at
    position 0 to offset d equals K computed at positions d.. (layer 0,
    where no attention has mixed the positions in yet)."""
    _, _, tmodel, tparams = build_gqa_pair("qwen-g5")
    cfg = tmodel.cfg
    rng = np.random.default_rng(21)
    h = torch.from_numpy(rng.standard_normal((1, 12, cfg.d_model)).astype(
        np.float32))
    lp = tparams.layers[0].attn
    _, k0, _ = attention_qkv(lp, cfg, h, torch.zeros((1, 12),
                                                     dtype=torch.int32))
    off = 37
    _, kd, _ = attention_qkv(lp, cfg, h, torch.full((1, 12), off,
                                                    dtype=torch.int32))
    moved = rope_relink(k0, torch.full((1, 12), off, dtype=torch.int32),
                        cfg.rope_theta)
    np.testing.assert_allclose(moved.numpy(), kd.numpy(), atol=1e-5, rtol=0)


def test_precompute_media_kv_matches(case):
    _, (jmodel, jparams, tmodel, tparams) = case
    emb = np.random.default_rng(0).standard_normal(
        (24, tmodel.cfg.d_model)).astype(np.float32) * 0.02
    jk, jv = jax_precompute(jmodel, jparams, jnp.asarray(emb))
    tk, tv = precompute_media_kv(tmodel, tparams, torch.from_numpy(emb))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_selective_prefill_paged_matches(case, pool):
    _, (jmodel, jparams, tmodel, tparams) = case
    cfg = tmodel.cfg
    ps = 8
    rng = np.random.default_rng(1)
    lengths = np.asarray([37, 21], np.int32)
    page_table = np.asarray([[3, 7, 1, 9, 12], [5, 2, 11, SCRATCH, SCRATCH]],
                            np.int32)
    sq = 16
    pos = np.zeros((2, sq), np.int32)
    pos[0, :13] = np.sort(rng.choice(37, 13, replace=False))
    pos[1, :9] = np.sort(rng.choice(21, 9, replace=False))
    real = np.arange(sq)[None, :] < np.asarray([[13], [9]])
    wp = np.where(real, np.take_along_axis(page_table, pos // ps, 1), SCRATCH)
    wo = np.where(real, pos % ps, ps - 1).astype(np.int32)
    tokens, media_mask, emb = _inputs(cfg, rng, (2, sq))
    media_mask &= real
    pools = _pools(cfg, pool, seed=2)
    host = (tokens, pos)
    rest = (page_table, lengths, wp.astype(np.int32), wo)
    jout = jmodel.selective_prefill_paged(
        jparams, *_jax(host), *_jax(pools[:2]), *_jax(rest),
        *_jax(pools[2:]), media_embeds=jnp.asarray(emb),
        media_mask=jnp.asarray(media_mask), backend="ref")
    tpools = _torch(pools)
    tlogits = tmodel.selective_prefill_paged(
        tparams, *_torch(host), *tpools[:2], *_torch(rest), *tpools[2:],
        media_embeds=torch.from_numpy(emb),
        media_mask=torch.from_numpy(media_mask))
    jpools = list(jout[1:]) + ([] if pool == "int8" else [None, None])
    np.testing.assert_allclose(tlogits.numpy()[real],
                               np.asarray(jout[0])[real], atol=ATOL, rtol=0)
    _assert_pools_match(tpools, jpools, pool)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_decode_step_paged_matches(case, pool):
    _, (jmodel, jparams, tmodel, tparams) = case
    cfg = tmodel.cfg
    ps = 8
    rng = np.random.default_rng(3)
    lengths = np.asarray([38, 0, 22], np.int32)     # slot 1 idle
    page_table = np.asarray([[3, 7, 1, 9, 12], [SCRATCH] * 5,
                             [5, 2, 11, SCRATCH, SCRATCH]], np.int32)
    pos = np.maximum(lengths - 1, 0)[:, None].astype(np.int32)
    wp = np.where(lengths > 0, page_table[np.arange(3), pos[:, 0] // ps],
                  SCRATCH).astype(np.int32)
    wo = np.where(lengths > 0, pos[:, 0] % ps, 0).astype(np.int32)
    tokens = rng.integers(8, cfg.vocab_size, (3, 1)).astype(np.int32)
    pools = _pools(cfg, pool, seed=4)
    rest = (page_table, lengths, wp, wo)
    jout = jmodel.decode_step_paged(jparams, *_jax((tokens, pos)),
                                    *_jax(pools[:2]), *_jax(rest),
                                    *_jax(pools[2:]), backend="ref")
    tpools = _torch(pools)
    tlogits = tmodel.decode_step_paged(tparams, *_torch((tokens, pos)),
                                       *tpools[:2], *_torch(rest),
                                       *tpools[2:])
    jpools = list(jout[1:]) + ([] if pool == "int8" else [None, None])
    live = lengths > 0
    np.testing.assert_allclose(tlogits.numpy()[live],
                               np.asarray(jout[0])[live], atol=ATOL, rtol=0)
    _assert_pools_match(tpools, jpools, pool)


def test_selective_prefill_dense_matches(case):
    _, (jmodel, jparams, tmodel, tparams) = case
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    valid, sel = [], []
    for total in (40, 29):
        order = rng.permutation(KV_LEN - 1)[:total]
        pos = np.full(KV_LEN, INVALID_POS, np.int64)
        pos[order] = np.arange(total)
        chosen = np.sort(rng.choice(total, 12, replace=False))
        pos[order[chosen]] = INVALID_POS
        valid.append(pos)
        sel.append((chosen, order[chosen]))
    cache = _dense_cache(cfg, 2, valid, seed=6)
    positions = np.stack([c for c, _ in sel]).astype(np.int32)
    write_idx = np.stack([w for _, w in sel]).astype(np.int32)
    tokens, mask, emb = _inputs(cfg, rng, positions.shape)
    jl, jc = jmodel.selective_prefill(
        jparams, jnp.asarray(tokens), jnp.asarray(positions),
        _as(cache, "jax"), jnp.asarray(write_idx),
        media_embeds=jnp.asarray(emb), media_mask=jnp.asarray(mask))
    tl, tc = tmodel.selective_prefill(
        tparams, torch.from_numpy(tokens), torch.from_numpy(positions),
        _as(cache, "torch"), torch.from_numpy(write_idx),
        media_embeds=torch.from_numpy(emb), media_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_match(tc, jc)


def test_prefill_dense_matches(case):
    """A suffix prefill after 11 cached tokens, as prefix caching and a
    chunk of a chunked prefill run it."""
    _, (jmodel, jparams, tmodel, tparams) = case
    cfg = tmodel.cfg
    rng = np.random.default_rng(7)
    n_hit, total = 11, 30
    pos = np.full((1, KV_LEN), INVALID_POS, np.int64)
    pos[0, :n_hit] = np.arange(n_hit)
    cache = _dense_cache(cfg, 1, pos, seed=8)
    tokens, mask, emb = _inputs(cfg, rng, (1, total - n_hit))
    p = np.arange(n_hit, total, dtype=np.int32)[None]
    jl, jc = jmodel.prefill(
        jparams, jnp.asarray(tokens), _as(cache, "jax"),
        media_embeds=jnp.asarray(emb), media_mask=jnp.asarray(mask),
        positions=jnp.asarray(p), write_idx=jnp.asarray(p))
    tl, tc = tmodel.prefill(
        tparams, torch.from_numpy(tokens), _as(cache, "torch"),
        media_embeds=torch.from_numpy(emb), media_mask=torch.from_numpy(mask),
        positions=torch.from_numpy(p), write_idx=torch.from_numpy(p))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_match(tc, jc)


def test_decode_step_dense_matches(case):
    _, (jmodel, jparams, tmodel, tparams) = case
    cfg = tmodel.cfg
    rng = np.random.default_rng(9)
    lengths = [33, 0, 20]
    pos = np.full((3, KV_LEN), INVALID_POS, np.int64)
    for b, n in enumerate(lengths):
        pos[b, :n] = np.arange(n)
    cache = _dense_cache(cfg, 3, pos, seed=10)
    position = np.asarray([[33], [KV_LEN - 1], [20]], np.int32)
    token = rng.integers(8, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jc = jmodel.decode_step(jparams, jnp.asarray(token),
                                jnp.asarray(position), _as(cache, "jax"),
                                jnp.asarray(position))
    tl, tc = tmodel.decode_step(tparams, torch.from_numpy(token),
                                torch.from_numpy(position),
                                _as(cache, "torch"),
                                torch.from_numpy(position))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_match(tc, jc)
