"""The port's model against the JAX ``Model`` on the same weights (carried
over by the weight bridge): media KV precompute, paged selective prefill
(logits and the pool it writes), paged decode, and the dense cache passes
(``prefill`` with and without ``positions``/``write_idx``,
``selective_prefill``, ``decode_step``), on the fp32 llava smoke config.
The JAX side runs its ``ref`` kernels.  Tolerance: logits atol 1e-4 (fp32
sums in another order over two layers); a dense cache's K/V within 1e-5
and its positions exact; int8 pool codes may differ by one step on at most
0.1% of entries (see test_torch_layers' quant_scatter test), scales to
rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.linker import precompute_media_kv as jax_precompute
from repro_torch.core.linker import precompute_media_kv
from repro_torch.models.layers import INVALID_POS

from _torch_parity import build_pair, smoke_configs

ATOL = 1e-4
PS, P = 8, 16
SCRATCH = 0


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_configs_match_field_for_field():
    jcfg, tcfg = smoke_configs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    from repro.configs import get_config as jax_get
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_config, get_smoke_config
    for arch in ("llava-1.6-7b", "deepseek-moe-16b", "granite-moe-1b-a400m"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))


def test_weight_bridge_carries_every_weight(pair):
    _, jparams, tmodel, tparams = pair
    lay = jparams["layers"]
    np.testing.assert_array_equal(tparams.embed.numpy(),
                                  np.asarray(jparams["embed"]))
    np.testing.assert_array_equal(tparams.lm_head.numpy(),
                                  np.asarray(jparams["lm_head"]))
    assert len(tparams.layers) == tmodel.cfg.num_layers
    for i, lp in enumerate(tparams.layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(getattr(lp.attn, name).numpy(),
                                          np.asarray(lay["attn"][name][i]))
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(lp.mlp, name).numpy(),
                                          np.asarray(lay["mlp"][name][i]))
        np.testing.assert_array_equal(
            lp.attn_norm.numpy(), np.asarray(lay["attn_norm"]["scale"][i]))


def test_precompute_media_kv_matches(pair):
    jmodel, jparams, tmodel, tparams = pair
    emb = np.random.default_rng(0).standard_normal(
        (24, tmodel.cfg.d_model)).astype(np.float32) * 0.02
    jk, jv = jax_precompute(jmodel, jparams, jnp.asarray(emb))
    tk, tv = precompute_media_kv(tmodel, tparams, torch.from_numpy(emb))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def _pools(cfg, pool, seed):
    """Random resident pool state (the linked, reused KV), both packages."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, P, PS, cfg.num_kv_heads, cfg.head_dim)
    if pool == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        sshape = (cfg.num_layers, P, cfg.num_kv_heads)
        ks = rng.uniform(0.002, 0.01, sshape).astype(np.float32)
        vs = rng.uniform(0.002, 0.01, sshape).astype(np.float32)
        return [k, v, ks, vs]
    return [rng.standard_normal(shape).astype(np.float32) * 0.5
            for _ in range(2)] + [None, None]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a.copy()) for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _assert_pools_match(tpools, jpools, pool):
    (tk, tv, tks, tvs), (jk, jv, jks, jvs) = tpools, jpools
    # padding rows all write one scratch slot: which one lands is undefined
    real = np.arange(P) != SCRATCH
    if pool == "int8":
        np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=1e-5)
        np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=1e-5)
        for t, j in ((tk, jk), (tv, jv)):
            diff = np.abs(t.numpy()[:, real].astype(np.int32)
                          - np.asarray(j)[:, real].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        np.testing.assert_allclose(tk.numpy()[:, real], np.asarray(jk)[:, real],
                                   atol=ATOL)
        np.testing.assert_allclose(tv.numpy()[:, real], np.asarray(jv)[:, real],
                                   atol=ATOL)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_selective_prefill_paged_matches(pair, pool):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(1)
    lengths = np.asarray([37, 21], np.int32)
    page_table = np.asarray([[3, 7, 1, 9, 12], [5, 2, 11, SCRATCH, SCRATCH]],
                            np.int32)
    sq = 16                                # 13 and 9 real rows, pad after
    pos = np.zeros((2, sq), np.int32)
    pos[0, :13] = np.sort(rng.choice(37, 13, replace=False))
    pos[1, :9] = np.sort(rng.choice(21, 9, replace=False))
    real = np.arange(sq)[None, :] < np.asarray([[13], [9]])
    wp = np.where(real, np.take_along_axis(page_table, pos // PS, 1), SCRATCH)
    wo = np.where(real, pos % PS, PS - 1).astype(np.int32)
    tokens = rng.integers(8, cfg.vocab_size, (2, sq)).astype(np.int32)
    media_mask = real & (rng.random((2, sq)) < 0.4)
    emb = (rng.standard_normal((2, sq, cfg.d_model)) * 0.02).astype(
        np.float32)
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
    jlogits, jpools = np.asarray(jout[0]), list(jout[1:])
    if pool != "int8":
        jpools += [None, None]
    np.testing.assert_allclose(tlogits.numpy()[real], jlogits[real],
                               atol=ATOL, rtol=0)
    _assert_pools_match(tpools, jpools, pool)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_decode_step_paged_matches(pair, pool):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    lengths = np.asarray([38, 0, 22], np.int32)     # slot 1 idle
    page_table = np.asarray([[3, 7, 1, 9, 12], [SCRATCH] * 5,
                             [5, 2, 11, SCRATCH, SCRATCH]], np.int32)
    pos = np.maximum(lengths - 1, 0)[:, None].astype(np.int32)
    wp = np.where(lengths > 0, page_table[np.arange(3), pos[:, 0] // PS],
                  SCRATCH).astype(np.int32)
    wo = np.where(lengths > 0, pos[:, 0] % PS, 0).astype(np.int32)
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
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jout[0]),
                               atol=ATOL, rtol=0)
    _assert_pools_match(tpools, jpools, pool)


# -- dense cache passes -------------------------------------------------------

CACHE_ATOL = 1e-5
KV_LEN = 48


def _dense_cache(cfg, batch, valid, seed):
    """A dense cache whose slot ``i`` of sequence ``b`` holds a random K/V at
    position ``valid[b][i]`` (``INVALID_POS`` where the slot is empty), as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, batch, KV_LEN, cfg.num_kv_heads, cfg.head_dim)
    k = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    pos = np.asarray(valid, np.int32)
    empty = pos == INVALID_POS
    k[:, empty] = 0.0
    v[:, empty] = 0.0
    return {"k": k, "v": v, "pos": pos}


def _as(cache, pkg):
    if pkg == "jax":
        return {n: jnp.asarray(a) for n, a in cache.items()}
    return {n: torch.from_numpy(a.copy()) for n, a in cache.items()}


def _assert_cache_match(tcache, jcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=CACHE_ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def _inputs(cfg, rng, shape, media_frac=0.4):
    tokens = rng.integers(8, cfg.vocab_size, shape).astype(np.int32)
    mask = rng.random(shape) < media_frac
    emb = (rng.standard_normal(shape + (cfg.d_model,)) * 0.02).astype(
        np.float32)
    return tokens, mask, emb


def test_selective_prefill_dense_matches(pair):
    """A linked cache: placed slots at permuted positions, the selected
    slots empty until this pass writes them."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    valid, sel = [], []
    for total in (40, 29):
        order = rng.permutation(KV_LEN - 1)[:total]   # slot of position p
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


@pytest.mark.parametrize("n_hit", [0, 11], ids=["contiguous", "suffix"])
def test_prefill_dense_matches(pair, n_hit):
    """``prefill`` from position 0 (no positions given) and, as prefix
    caching runs it, of the suffix after ``n_hit`` cached tokens."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(7)
    total = 30
    pos = np.full((1, KV_LEN), INVALID_POS, np.int64)
    pos[0, :n_hit] = np.arange(n_hit)
    cache = _dense_cache(cfg, 1, pos, seed=8)
    tokens, mask, emb = _inputs(cfg, rng, (1, total - n_hit))
    kw = {}
    if n_hit:
        p = np.arange(n_hit, total, dtype=np.int32)[None]
        kw = {"positions": p, "write_idx": p}
    jl, jc = jmodel.prefill(
        jparams, jnp.asarray(tokens), _as(cache, "jax"),
        media_embeds=jnp.asarray(emb), media_mask=jnp.asarray(mask),
        **{n: jnp.asarray(a) for n, a in kw.items()})
    tl, tc = tmodel.prefill(
        tparams, torch.from_numpy(tokens), _as(cache, "torch"),
        media_embeds=torch.from_numpy(emb), media_mask=torch.from_numpy(mask),
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_match(tc, jc)


def test_decode_step_dense_matches(pair):
    """Three slots of a dense batch cache; slot 1 is idle and writes its
    token at the last slot, position ``KV_LEN - 1``, as the engine does."""
    jmodel, jparams, tmodel, tparams = pair
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


def test_forward_with_cache_matches(pair):
    """The transformer-level cache form on embeddings, with a window that
    bites (8 < the 30-token span)."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(11)
    pos = np.full((1, KV_LEN), INVALID_POS, np.int64)
    pos[0, 10:30] = np.arange(20) + 5
    cache = _dense_cache(cfg, 1, pos, seed=12)
    positions = np.asarray([[25, 26, 27, 30]], np.int32)
    write_idx = np.asarray([[2, 3, 4, 5]], np.int32)
    emb = (rng.standard_normal((1, 4, cfg.d_model)) * 0.5).astype(np.float32)
    jl, jc, _ = jtf.forward_with_cache(jparams, jmodel.cfg, jnp.asarray(emb),
                                       jnp.asarray(positions),
                                       _as(cache, "jax"),
                                       jnp.asarray(write_idx), window=8)
    tl, tc = ttf.forward_with_cache(tparams, cfg, torch.from_numpy(emb),
                                    torch.from_numpy(positions),
                                    _as(cache, "torch"),
                                    torch.from_numpy(write_idx), window=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_match(tc, jc)
