"""The port's model against the JAX ``Model`` on the same weights (carried
over by the weight bridge): media KV precompute, paged selective prefill
(logits and the pool it writes) and paged decode, on the fp32 llava smoke
config.  The JAX side runs its ``ref`` kernels.  Tolerance: atol 1e-4 (fp32
sums in another order over two layers); int8 pool codes may differ by one
step on at most 0.1% of entries (see test_torch_layers' quant_scatter
test), scales to rtol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.linker import precompute_media_kv as jax_precompute
from repro_torch.core.linker import precompute_media_kv

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
    from repro_torch.configs import get_config
    assert dataclasses.asdict(get_config("llava-1.6-7b")) == \
        dataclasses.asdict(jax_get("llava-1.6-7b"))


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
