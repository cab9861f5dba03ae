"""The port's ``PagedKVPool`` against the JAX one: the same allocation
sequence gives the same page lists and free counts, and the same writes
(``link_write`` with RoPE relink, ``write_tokens``) leave the same pool,
for a 16-bit and an int8 pool (scales reset when a page is freed)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.paged import PagedConfig as JaxPagedConfig
from repro.cache.paged import PagedKVPool as JaxPool
from repro_torch.cache.paged import PagedConfig, PagedKVPool

L, P, PS, H, D = 2, 10, 4, 2, 16
THETA = 10000.0


def _pools(dtype):
    j = JaxPool(JaxPagedConfig(P, PS, L, H, D, dtype=dtype))
    t = PagedKVPool(PagedConfig(P, PS, L, H, D, dtype=dtype), device="cpu")
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_alloc_and_writes_match(dtype):
    jp, tp = _pools(dtype)
    rng = np.random.default_rng(0)
    for pool in (jp, tp):
        assert pool.alloc("scratch", 1) is not None
    np.testing.assert_array_equal(tp.alloc("a", 9), jp.alloc("a", 9))
    np.testing.assert_array_equal(tp.extend("a", 5, 9), jp.extend("a", 5, 9))
    row = tp.alloc("b", 6)
    np.testing.assert_array_equal(row, jp.alloc("b", 6))
    assert tp.free_pages == jp.free_pages and tp.capacity("a") == 16
    assert tp.alloc("c", 4 * PS) is None and jp.alloc("c", 4 * PS) is None

    # link a 6-token segment stored at position 0 into slots 1..6 of "b"
    # (relinked by 1), with two pad rows on the scratch page
    k_seg = rng.standard_normal((L, 8, H, D)).astype(np.float32)
    v_seg = rng.standard_normal((L, 8, H, D)).astype(np.float32)
    slots = np.arange(1, 7)
    pages = np.concatenate([row[slots // PS], [0, 0]]).astype(np.int32)
    offs = np.concatenate([slots % PS, [0, 0]]).astype(np.int32)
    delta = np.asarray([1] * 6 + [0, 0], np.int32)
    jp.link_write(*map(jnp.asarray, (pages, offs, k_seg, v_seg, delta)),
                  theta=THETA, relink=True)
    tp.link_write(*map(torch.from_numpy, (pages, offs, k_seg, v_seg, delta)),
                  theta=THETA, relink=True)
    # then more tokens from slot 5 on (the page of slot 5 requantizes)
    k_new = (rng.standard_normal((L, 3, H, D)) * 3).astype(np.float32)
    v_new = (rng.standard_normal((L, 3, H, D)) * 3).astype(np.float32)
    jp.write_tokens(row, 5, jnp.asarray(k_new), jnp.asarray(v_new))
    tp.write_tokens(row, 5, torch.from_numpy(k_new), torch.from_numpy(v_new))

    real = row[:3]
    for t, j in ((tp.k, jp.k), (tp.v, jp.v)):
        t, j = t.numpy()[:, real], np.asarray(j)[:, real]
        if dtype == "int8":
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    if dtype == "int8":
        np.testing.assert_allclose(tp.k_scale.numpy(), np.asarray(jp.k_scale),
                                   rtol=1e-6)
    tp.free("b")
    jp.free("b")
    if dtype == "int8":             # freed pages start their amax afresh
        assert np.all(tp.k_scale.numpy()[:, row] == 0)
        np.testing.assert_array_equal(tp.v_scale.numpy(),
                                      np.asarray(jp.v_scale))
    assert tp.page_ref(int(row[0])) == 0 and tp.free_pages == jp.free_pages
    tp.free("b")                    # idempotent
    assert tp.free_pages == jp.free_pages
