"""The port's context-caching policies against the JAX package's, one
request at a time, on the fp32 llava smoke config with the JAX weights
carried over.

Both packages get the same two-image MMDU-style prompt, a library holding
its images' KV (each package's own ``precompute_media_kv``) and a prefix
store holding the system prompt's KV.  Every policy runs on its dense
branch; ``mpic`` and ``cacheblend`` also run against a page pool, fp32 and
int8.  The JAX side runs its plain ``ref`` kernels; the port runs with
``device="cpu"``.

Tolerances: first-token logits within 1e-3 (fp32 sums over two layers and
a vocabulary head in another order); ``n_recomputed``, ``n_reused`` and
``engine_steps`` equal; the positions of a returned dense cache equal.
cacheblend's layer-0 deviation scores agree within 1e-4 and, on library
entries that really deviate, pick the same tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import KVLibrary as JaxLibrary
from repro.cache.paged import PagedConfig as JaxPagedConfig
from repro.cache.paged import PagedKVPool as JaxPool
from repro.core import policies as jpol
from repro.core import select as jsel
from repro.core.linker import link_prompt as jax_link_prompt
from repro.core.linker import precompute_media_kv as jax_precompute
from repro.core.paged_prefill import PagedPrefiller as JaxPrefiller
from repro.data import make_dialogues as jax_dialogues
from repro.data import ByteTokenizer as JaxTokenizer
from repro.data import SYSTEM_PROMPT
from repro_torch.cache import KVLibrary
from repro_torch.cache.paged import PagedConfig, PagedKVPool
from repro_torch.core import policies as tpol
from repro_torch.core import select as tsel
from repro_torch.core.linker import link_prompt, precompute_media_kv
from repro_torch.core.paged_prefill import PagedPrefiller
from repro_torch.data import make_dialogues

from _torch_parity import build_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

LOGIT_ATOL = 1e-3
DEV_ATOL = 1e-4
KV_LEN = 256
PS = 8
R = 0.25


@pytest.fixture(scope="module")
def setup():
    jmodel, jparams, tmodel, tparams = build_pair()
    cfg = tmodel.cfg
    kw = dict(n=1, n_images=2, d_model=cfg.d_model,
              media_len=cfg.media_token_len, seed=5)
    jprompt = jax_dialogues(**kw)[0].prompt
    tprompt = make_dialogues(**kw)[0].prompt
    np.testing.assert_array_equal(tprompt.flat_tokens(),
                                  jprompt.flat_tokens())
    jlib, tlib = JaxLibrary(), KVLibrary()
    for _, seg in jprompt.media_segments():
        k, v = jax_precompute(jmodel, jparams, jnp.asarray(seg.embeds))
        jlib.put(jprompt.user_id, seg.media_id, k, v)
        k, v = precompute_media_kv(tmodel, tparams,
                                   torch.from_numpy(seg.embeds))
        tlib.put(tprompt.user_id, seg.media_id, k, v)
    # the prefix store holds the system prompt, as the benchmarks build it
    sys_toks = JaxTokenizer().encode(SYSTEM_PROMPT, bos=True)
    n = len(sys_toks)
    jcache = jmodel.make_cache(1, n + 1)
    _, jcache = jmodel.prefill(jparams, jnp.asarray(sys_toks[None]), jcache)
    jstore = jpol.PrefixStore()
    jstore.put(sys_toks, np.asarray(jcache["k"][:, 0, :n]),
               np.asarray(jcache["v"][:, 0, :n]))
    tcache = tmodel.make_cache(1, n + 1, device="cpu")
    _, tcache = tmodel.prefill(
        tparams, torch.as_tensor(sys_toks[None], dtype=torch.int32), tcache)
    tstore = tpol.PrefixStore()
    tstore.put(sys_toks, tcache["k"][:, 0, :n], tcache["v"][:, 0, :n])
    return {"jax": (jmodel, jparams, jprompt, jlib, jstore),
            "torch": (tmodel, tparams, tprompt, tlib, tstore)}


def _paged(pkg, model, prompt, pool_dtype):
    """A pool of two requests' pages; the request's row, bound."""
    cfg = model.cfg
    args = dict(num_pages=2 * (KV_LEN // PS) + 1, page_size=PS,
                num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, dtype=pool_dtype or "float32")
    if pkg == "jax":
        pool = JaxPool(JaxPagedConfig(**args))
    else:
        pool = PagedKVPool(PagedConfig(**args), device="cpu")
    scratch = int(pool.alloc("__scratch__", 1)[0])
    pages = pool.alloc("req", prompt.total_len + 1)
    row = np.full((KV_LEN // PS,), scratch, np.int32)
    row[:len(pages)] = pages
    if pkg == "jax":
        pf = JaxPrefiller(model, pool, scratch, backend="ref",
                          interpret=False)
    else:
        pf = PagedPrefiller(model, pool, scratch)
    return pf.bind(row)


def _run(setup, pkg, policy, paged_pool, **kw):
    model, params, prompt, lib, store = setup[pkg]
    pol = (jpol if pkg == "jax" else tpol).POLICIES[policy]
    paged = (_paged(pkg, model, prompt, paged_pool)
             if paged_pool is not None else None)
    return pol(model, params, prompt, lib, kv_len=KV_LEN, prefix_store=store,
               paged=paged, **kw)


CASES = [("full_recompute", None, {}), ("prefix_caching", None, {}),
         ("full_reuse", None, {}), ("cacheblend", None, {"r": R}),
         ("mpic", None, {"k": 8}),
         ("cacheblend", "", {"r": R}), ("cacheblend", "int8", {"r": R}),
         ("mpic", "", {"k": 8}), ("mpic", "int8", {"k": 8})]


@pytest.mark.parametrize(
    "policy,pool,kw", CASES,
    ids=[f"{p}-{'dense' if pool is None else pool or 'fp32'}"
         for p, pool, _ in CASES])
def test_policy_matches_reference(setup, policy, pool, kw):
    jres = _run(setup, "jax", policy, pool, **kw)
    tres = _run(setup, "torch", policy, pool, **kw)
    for key in ("n_recomputed", "n_reused", "engine_steps", "policy"):
        assert tres.stats[key] == jres.stats[key], key
    np.testing.assert_allclose(tres.first_logits,
                               np.asarray(jres.first_logits, np.float32),
                               atol=LOGIT_ATOL, rtol=0)
    assert (tres.cache is None) == (jres.cache is None)
    if tres.cache is not None:
        np.testing.assert_array_equal(tres.cache["pos"].numpy(),
                                      np.asarray(jres.cache["pos"]))
    if policy == "prefix_caching":
        assert tres.stats["n_reused"] > 0          # the system prompt hit


def _stale_libraries(setup):
    """Libraries whose entries were computed from perturbed image
    embeddings (a per-token noise level drawn uniformly), so the probe
    measures real, well separated deviations."""
    jmodel, jparams, jprompt, _, _ = setup["jax"]
    tmodel, tparams, tprompt, _, _ = setup["torch"]
    rng = np.random.default_rng(7)
    jlib, tlib = JaxLibrary(), KVLibrary()
    for _, seg in jprompt.media_segments():
        n, d = seg.embeds.shape
        noise = (rng.standard_normal((n, d)) * 0.02
                 * rng.uniform(0, 1, (n, 1))).astype(np.float32)
        emb = seg.embeds + noise
        k, v = jax_precompute(jmodel, jparams, jnp.asarray(emb))
        jlib.put(jprompt.user_id, seg.media_id, k, v)
        k, v = precompute_media_kv(tmodel, tparams, torch.from_numpy(emb))
        tlib.put(tprompt.user_id, seg.media_id, k, v)
    return {"jax": jlib, "torch": tlib}


def _deviations(setup, pool, libs):
    """Per package: the probe's layer-0 K deviation per token and the
    tokens cacheblend picks, reading the dense blended cache (pool None)
    or the pool."""
    scores, picks = {}, {}
    for pkg in ("jax", "torch"):
        model, params, prompt, _, _ = setup[pkg]
        lib = libs[pkg]
        pol, sel = (jpol, jsel) if pkg == "jax" else (tpol, tsel)
        base = sel.full_reuse_selection(prompt)
        n = prompt.total_len
        if pool is None:
            link = (jax_link_prompt(model, prompt, lib, base) if pkg == "jax"
                    else link_prompt(model, prompt, lib, base, device="cpu"))
            k0 = link.cache["k"][0, 0, :n]
        else:
            paged = _paged(pkg, model, prompt, pool)
            link = paged.link(model, prompt, lib, base)
            k0 = paged.gather_k0(n)
            k0[link.sel_idx] = 0.0
        scores[pkg] = np.asarray(
            pol._probe_k_deviation(model, params, prompt, k0))
        picks[pkg] = sel.cacheblend_selection(prompt, scores[pkg], R)
    return scores, picks


POOLS = pytest.mark.parametrize("pool", [None, "", "int8"],
                                ids=["dense", "fp32", "int8"])


@POOLS
def test_cacheblend_deviation_and_selection(setup, pool):
    """Stale library entries: the deviations agree and the picks are the
    same tokens."""
    scores, picks = _deviations(setup, pool, _stale_libraries(setup))
    media = setup["torch"][2].media_mask()
    np.testing.assert_allclose(scores["torch"], scores["jax"],
                               atol=DEV_ATOL, rtol=0)
    np.testing.assert_array_equal(picks["torch"], picks["jax"])
    assert picks["torch"].sum() > (~media).sum()   # some media was picked


@POOLS
def test_cacheblend_exact_library_picks_differ_only_at_near_ties(setup,
                                                                 pool):
    """Entries computed from the very embeddings of the prompt: a media
    token's layer-0 K depends only on its embedding and position, so its
    deviation is the rounding of the RoPE relink (~1e-4 in fp32), and the
    ranking is rounding noise in both packages.  The deviations agree; a
    pick may flip only where the two packages' scores straddle the cut by
    no more than they disagree."""
    libs = {pkg: setup[pkg][3] for pkg in ("jax", "torch")}
    scores, picks = _deviations(setup, pool, libs)
    np.testing.assert_allclose(scores["torch"], scores["jax"],
                               atol=DEV_ATOL, rtol=0)
    media = setup["torch"][2].media_mask()
    gap = np.abs(scores["torch"] - scores["jax"])[media].max()
    n_pick = int(round(R * media.sum()))
    for pkg in ("jax", "torch"):
        cut = np.sort(scores[pkg][media])[-n_pick]
        flipped = picks["torch"] != picks["jax"]
        assert np.all(np.abs(scores[pkg][flipped] - cut) <= 2 * gap), pkg


@pytest.mark.parametrize("k", [0, 4], ids=["full_reuse", "mpic4"])
def test_link_prompt_matches(setup, k):
    """The dense blended cache and the selection arrays, from the same
    stored KV in both libraries, with one image missing from the library
    (recomputed whole).  Everything is equal except the relinked K, whose
    RoPE rotation takes cos/sin from XLA in one package and from torch in
    the other: those differ by an ulp now and then, so K is held to 1e-6
    (an ulp of values below 8)."""
    jmodel, _, jprompt, jlib, _ = setup["jax"]
    tmodel, _, tprompt, _, _ = setup["torch"]
    media = [seg.media_id for _, seg in jprompt.media_segments()]
    kept = JaxLibrary()
    tlib = KVLibrary()
    e = jlib.get(jprompt.user_id, media[0])
    kept.put(jprompt.user_id, media[0], e.k, e.v)
    tlib.put(tprompt.user_id, media[0], torch.from_numpy(np.asarray(e.k)),
             torch.from_numpy(np.asarray(e.v)))
    jl = jax_link_prompt(jmodel, jprompt, kept,
                         jsel.mpic_selection(jprompt, k), kv_len=KV_LEN)
    tl = link_prompt(tmodel, tprompt, tlib, tsel.mpic_selection(tprompt, k),
                     kv_len=KV_LEN, device="cpu")
    assert tl.misses == jl.misses == [media[1]]
    assert (tl.n_reused, tl.n_recomputed) == (jl.n_reused, jl.n_recomputed)
    for name in ("sel_idx", "sel_tokens", "sel_media_embeds",
                 "sel_media_mask"):
        np.testing.assert_array_equal(getattr(tl, name),
                                      np.asarray(getattr(jl, name)))
    for name in ("v", "pos"):
        np.testing.assert_array_equal(tl.cache[name].numpy(),
                                      np.asarray(jl.cache[name]))
    np.testing.assert_allclose(tl.cache["k"].numpy(),
                               np.asarray(jl.cache["k"]), atol=1e-6, rtol=0)
    # the dummy cache: selected slots zero in both
    assert not tl.cache["k"].numpy()[:, 0, tl.sel_idx].any()


def test_prefix_store_chain_matches_put():
    """A prefix stored in one piece is found by the per-token chain, and
    only as a whole."""
    store = tpol.PrefixStore()
    toks = np.arange(3, 40, dtype=np.int32)
    store.put(toks[:20], "k", "v")
    assert store.longest_match(toks)[:1] == (20,)
    assert store.longest_match(toks[:19])[0] == 0
    assert store.longest_match(toks[1:])[0] == 0
