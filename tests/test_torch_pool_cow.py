"""The port's copy-on-write page pool against the JAX package's: seeded
random sequences of alloc / extend / fork / make_exclusive + write / free
applied to both pools, fp32 and int8.

After every operation both pools hold the same page lists, refcounts, free
stack and copy counters, and the port's pool keeps the reference's
invariants: no page leaked or lost, none both free and owned, no page on
the free stack twice, a refcount equal to the number of owner lists a page
is on, and every write lands in a page its writer owns alone.  At the end
each live request's pages hold the same bytes in both pools (fp32 exactly;
int8 codes within one step of the requantizing write, as
``test_torch_model.py`` states, scales to rtol 1e-6).  Seeded numpy draws
stand in for hypothesis, which rejects ``@given`` beside function-scoped
fixtures.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.paged import PagedConfig as JaxPagedConfig
from repro.cache.paged import PagedKVPool as JaxPagedKVPool
from repro_torch.cache.paged import PagedConfig, PagedKVPool

NP, PS, L, H, DH = 12, 4, 2, 1, 4
OPS = ("alloc", "extend", "free", "fork", "write")


def _pools(dtype):
    kw = dict(num_pages=NP, page_size=PS, num_layers=L, num_kv_heads=H,
              head_dim=DH, dtype=dtype)
    return (JaxPagedKVPool(JaxPagedConfig(**kw)),
            PagedKVPool(PagedConfig(**kw), device="cpu"))


def _check_invariants(pool, tokens):
    owned = [int(p) for r in tokens for p in pool._owned[r]]
    distinct, free = set(owned), set(pool._free)
    assert len(pool._free) == len(free)           # no page freed twice
    assert not (distinct & free)                  # never free and owned
    assert len(distinct) + len(free) == NP        # nothing leaked or lost
    for page, holders in Counter(owned).items():
        assert pool._refs.get(page) == holders
    for page in free:
        assert pool._refs.get(page, 0) == 0


def _same_books(jpool, tpool):
    assert {r: list(map(int, p)) for r, p in tpool._owned.items()} == \
        {r: list(map(int, p)) for r, p in jpool._owned.items()}
    assert dict(tpool._refs) == {int(p): n for p, n in jpool._refs.items()}
    assert list(map(int, tpool._free)) == list(map(int, jpool._free))
    assert (tpool.cow_copies, tpool.pages_shared) == \
        (jpool.cow_copies, jpool.pages_shared)


def _same_contents(jpool, tpool, tokens, dtype):
    for rid, n in tokens.items():
        pages = np.asarray(tpool._owned[rid])[:tpool.pages_for(n)]
        idx = torch.as_tensor(pages).long()
        for tbuf, jbuf in ((tpool.k, jpool.k), (tpool.v, jpool.v)):
            t = tbuf[:, idx].numpy().astype(np.float64)
            j = np.asarray(jbuf)[:, pages].astype(np.float64)
            if dtype == "int8":
                assert np.abs(t - j).max() <= 1
            else:
                np.testing.assert_array_equal(t, j)
        if dtype == "int8":
            for tsc, jsc in ((tpool.k_scale, jpool.k_scale),
                             (tpool.v_scale, jpool.v_scale)):
                np.testing.assert_allclose(tsc[:, idx].numpy(),
                                           np.asarray(jsc)[:, pages],
                                           rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("seed", range(12))
def test_random_cow_sequences_match_the_reference(seed, dtype):
    rng = np.random.default_rng(seed)
    jpool, tpool = _pools(dtype)
    tokens = {}            # live request -> tokens it holds
    next_id = 0
    for _ in range(int(rng.integers(8, 30))):
        op = OPS[int(rng.integers(len(OPS)))]
        a, b = int(rng.integers(0, 8)), int(rng.integers(1, 10))
        names = sorted(tokens)
        if op == "alloc":
            rid = f"r{next_id}"
            next_id += 1
            got = [p.alloc(rid, b) for p in (jpool, tpool)]
            assert (got[0] is None) == (got[1] is None)
            if got[1] is not None:
                tokens[rid] = b
        elif op == "extend" and names:
            rid = names[a % len(names)]
            got = [p.extend(rid, b, tokens[rid]) for p in (jpool, tpool)]
            assert (got[0] is None) == (got[1] is None)
            if got[1] is not None:
                tokens[rid] += b
        elif op == "free" and names:
            rid = names[a % len(names)]
            for p in (jpool, tpool):
                p.free(rid)
                p.free(rid)                      # a second free: no-op
            del tokens[rid]
        elif op == "fork" and names:
            rid = names[a % len(names)]
            kids = [f"r{next_id + i}" for i in range(1 + a % 2)]
            next_id += len(kids)
            for p in (jpool, tpool):
                p.fork(rid, kids)
            for kid in kids:
                tokens[kid] = tokens[rid]
        elif op == "write" and names:
            rid = names[a % len(names)]
            pos = (b - 1) % max(tokens[rid], 1)
            got = [p.make_exclusive(rid, pos) for p in (jpool, tpool)]
            assert (got[0] is None) == (got[1] is None)
            if got[1] is not None:
                assert tpool.page_ref(int(got[1][pos // PS])) == 1
                kv = rng.standard_normal((2, L, 1, H, DH)).astype(np.float32)
                jpool.write_tokens(got[0], pos, jnp.asarray(kv[0]),
                                   jnp.asarray(kv[1]))
                tpool.write_tokens(got[1], pos, torch.from_numpy(kv[0]),
                                   torch.from_numpy(kv[1]))
        _check_invariants(tpool, tokens)
        _same_books(jpool, tpool)
    _same_contents(jpool, tpool, tokens, dtype)


def test_make_exclusive_copies_the_shared_pages_only():
    """Two owners of three pages: a write range over pages 1-2 copies
    those two (bytes and, on int8, scale rows) and leaves page 0 shared;
    the copies equal the originals, which the other owner keeps."""
    pool = PagedKVPool(PagedConfig(num_pages=8, page_size=PS, num_layers=L,
                                   num_kv_heads=H, head_dim=DH,
                                   dtype="int8"), device="cpu")
    pages = pool.alloc("a", 3 * PS)
    g = torch.Generator().manual_seed(0)
    pool.k.copy_(torch.randint(-127, 128, pool.k.shape, generator=g))
    pool.k_scale.copy_(torch.rand(pool.k_scale.shape, generator=g))
    pool.fork("a", ["b"])
    new = pool.make_exclusive("b", PS + 1, 2 * PS)
    assert new[0] == pages[0] and set(new[1:]).isdisjoint(pages)
    assert pool.cow_copies == 2 and pool.page_ref(int(pages[0])) == 2
    for o, n in zip(pages[1:], new[1:]):
        assert torch.equal(pool.k[:, n], pool.k[:, o])
        assert torch.equal(pool.k_scale[:, n], pool.k_scale[:, o])
    assert pool.make_exclusive("b", PS + 1, 2 * PS).tolist() == new.tolist()
    assert pool.cow_copies == 2
