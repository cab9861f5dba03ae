"""The port's primitives against ``repro.models.layers`` and the JAX
``quant_scatter``, on the same numpy inputs (fp32, tolerance 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.pagequant import quant_scatter as jax_quant_scatter
from repro.models import layers as jl
from repro_torch.cache.pagequant import quant_scatter
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)
THETA = 10000.0


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dh", [16, 64])
def test_apply_rope_matches(dh):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    ref = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), THETA))
    out = tl.apply_rope(_t(x), _t(pos), THETA).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_rope_is_half_split_not_interleaved():
    # a vector on channel 0 rotates into channel Dh/2, not channel 1
    x = np.zeros((1, 1, 1, 8), np.float32)
    x[..., 0] = 1.0
    out = tl.apply_rope(_t(x), _t(np.ones((1, 1), np.int32)), THETA).numpy()
    assert out[0, 0, 0, 4] == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[0, 0, 0, 1] == 0.0


def test_rope_relink_matches_and_composes():
    rng = _rng(2)
    k = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)     # (L,S,H,D)
    pos = np.arange(9, dtype=np.int32)
    delta = np.full(9, 531, np.int32)
    ref = np.asarray(jl.rope_relink(jnp.asarray(k), jnp.asarray(delta), THETA))
    out = tl.rope_relink(_t(k), _t(delta), THETA)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # relinking stored K(p) by d gives K(p + d): what makes the cache
    # position-independent.  The angles are fp32, so the composition is
    # exact up to the angle's rounding (ulp(p*f) grows with the position):
    # within 1e-5 at d=40, and at d=531 as close as the JAX package gets
    stored = tl.apply_rope(_t(k), _t(pos), THETA)
    for d in (40, 531):
        dd = np.full(9, d, np.int32)
        moved = tl.rope_relink(stored, _t(dd), THETA).numpy()
        direct = tl.apply_rope(_t(k), _t(pos + dd), THETA).numpy()
        jstored = jl.apply_rope(jnp.asarray(k), jnp.asarray(pos), THETA)
        jerr = np.abs(np.asarray(jl.rope_relink(jstored, jnp.asarray(dd),
                                                THETA))
                      - np.asarray(jl.apply_rope(jnp.asarray(k),
                                                 jnp.asarray(pos + dd),
                                                 THETA))).max()
        assert np.abs(moved - direct).max() <= max(1e-5, jerr)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_attend_matches(hq, hkv, window):
    rng = _rng(3)
    b, sq, skv, dh = 2, 6, 14, 16
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    kv_pos = np.tile(np.arange(skv, dtype=np.int32), (b, 1))
    kv_pos[:, [3, 9]] = np.iinfo(np.int32).max       # empty slots
    q_pos = np.stack([np.sort(rng.choice(skv, sq, replace=False))
                      for _ in range(b)]).astype(np.int32)
    ref = np.asarray(jl.attend(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                               window=window))
    out = tl.attend(*map(_t, (q, k, v, q_pos, kv_pos)), window=window)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert tl.INVALID_POS == int(jl.INVALID_POS)


def test_rmsnorm_and_swiglu_match():
    rng = _rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    ref = np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)},
                                jnp.asarray(x), 1e-5))
    np.testing.assert_allclose(tl.rmsnorm(_t(scale), _t(x), 1e-5).numpy(),
                               ref, **TOL)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    ref = np.asarray(jl.swiglu({n: jnp.asarray(a) for n, a in w.items()},
                               jnp.asarray(x)))
    out = tl.swiglu(_t(w["w_gate"]), _t(w["w_up"]), _t(w["w_down"]), _t(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_quant_scatter_matches_jax():
    """Three successive writes into int8 pages, with several tokens per
    page, duplicate targets on a scratch page, and growing amax (so pages
    requantize).  Scales agree to rtol 1e-6.  int8 codes are equal, or off
    by one on at most 0.1% of entries: ``round(x / s)`` may land on the
    other side of a .5 boundary when the two libraries compute ``x / s``
    (or the requantize ratio) with one rounding more or less."""
    rng = _rng(5)
    L, P, ps, H, D = 2, 6, 4, 3, 16
    jk = jv = jnp.zeros((L, P, ps, H, D), jnp.int8)      # immutable: may alias
    jks = jvs = jnp.zeros((L, P, H), jnp.float32)
    tk, tv = (torch.zeros((L, P, ps, H, D), dtype=torch.int8)
              for _ in range(2))
    tks, tvs = torch.zeros((L, P, H)), torch.zeros((L, P, H))
    scratch = 0
    for step, amp in enumerate((0.5, 2.0, 1.0)):
        n = 7
        pages = rng.integers(1, P, n).astype(np.int32)
        offs = rng.integers(0, ps, n).astype(np.int32)
        pages[-2:] = scratch                   # padding rows collide
        offs[-2:] = ps - 1
        k_new = (rng.standard_normal((L, n, H, D)) * amp).astype(np.float32)
        v_new = (rng.standard_normal((L, n, H, D)) * amp).astype(np.float32)
        jk, jv, jks, jvs = jax_quant_scatter(
            jk, jv, jks, jvs, *map(jnp.asarray, (pages, offs, k_new, v_new)))
        quant_scatter(tk, tv, tks, tvs, *map(_t, (pages, offs, k_new, v_new)))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=1e-6)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=1e-6)
    real = np.arange(P) != scratch             # the scratch winner is free
    for t_pool, j_pool in ((tk, jk), (tv, jv)):
        diff = np.abs(t_pool.numpy()[:, real].astype(np.int32)
                      - np.asarray(j_pool)[:, real].astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3
