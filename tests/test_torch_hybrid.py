"""The port's hybrid slice (hymba-1.5b: attention and SSD heads in every
layer, a sliding window) against the JAX package on the CPU.

The smoke config runs in fp32 with the JAX weights carried over, at
hymba's own query-head group of 5 (10 query heads on 2 kv heads; the
smoke sizes would make it 2) and, for the model passes, also at the stock
smoke heads.  Held against the JAX package: the config, the weight bridge
(the ``ssm`` leaves and the two mix norms), ``banded_attend`` at S = 2w
and 4w, one hybrid layer's cache pass, ``Model.prefill`` at S = 23 (chunk
pads) and at S = 128 = 2 smoke windows into exactly 128 slots (the banded
branch), ``Model.forward``, three decode steps, and the engine on the
dense cache under ``full_recompute``, ``mpic`` and ``cacheblend`` (both
served as ``full_recompute``), ``prefix_caching`` with an empty prefix
store, and an MRAG-linked request whose 128-token image is uploaded
through the banded branch; the dialogues' prompts (178-201 tokens) run
past two windows.  The same ``full_recompute`` stream on two gloo ranks
(``tests/_torch_sharded.py``: 5 query heads on 1 kv head, 2 of the 4 SSD
heads, half the MLP and the vocabulary a rank) and on three, which divide
neither the kv heads nor the SSD heads (every attention and SSM leaf
whole on each rank, the reference's ``replicate_ssm``), held to the JAX
engine's tokens and first-token logits within 1e-4 relative.

Tolerances:

- model passes: logits atol 1e-4 (fp32 sums in another order over two
  layers); caches' K/V and SSM state 1e-4, positions exact;
- ``banded_attend``: fp32 within 1e-5; bf16 within one bf16 ulp of the
  larger value plus ``2**-17 * max|V|`` (``repro_torch.kernels.check``)
  plus ``2**-9 * max|V|``: the JAX version rounds the probabilities to
  bf16 before the value product, the port's keeps them fp32 (ROADMAP
  queue 3), and one bf16 rounding moves each probability by at most
  2^-9 of itself;
- the engine: greedy tokens identical, first-token logits within 1e-3.

Two reference defects are shown beside the port's answer:
``test_reference_upload_parks_pads_on_the_last_token`` (a hybrid upload
whose length is not a multiple of ``ssm_chunk``) and
``test_reference_prefix_hit_starts_the_ssd_from_zero`` (``prefix_caching``
on a hybrid).  The engine tests upload images whose lengths are
multiples of the chunk (16 and 128 tokens), so the first defect stays out
of the reference's side of their comparison.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import policies as jpol
from repro.core.linker import precompute_media_kv as jax_precompute
from repro.core.segments import Prompt as JaxPrompt
from repro.core.segments import text_segment as jax_text
from repro.models import transformer as jtf
from repro.models.layers import banded_attend as jax_banded_attend
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import Prompt, text_segment
from repro_torch.core import policies as tpol
from repro_torch.core.linker import precompute_media_kv
from repro_torch.kernels.check import compare, error_limit
from repro_torch.models import build_model
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import INVALID_POS, banded_attend
from repro_torch.models.transformer import init_params

from _torch_parity import build_pair
from _torch_serve import build_gqa_pair, serve
from _torch_sharded import REL, Ranks, rel
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

ARCH = "hymba-1.5b"
ATOL = 1e-4
# case -> overrides of the smoke config: hymba's group of 5, and the stock
# smoke heads (4 on 2)
CASES = {"g5": dict(num_heads=10, num_kv_heads=2), "stock": {}}
HYBRID_KEYS = {"k", "v", "pos", "ssm_h", "ssm_conv"}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return build_pair(arch=ARCH, **CASES[request.param])


@pytest.fixture(scope="module")
def g5():
    return build_pair(arch=ARCH, **CASES["g5"])


# ranks -> the plan's (attention, SSD heads) cut
RANK_WORLDS = {2: (True, True), 3: (False, False)}


@pytest.fixture(scope="module", autouse=True)
def ranks(g5):
    """Two and three gloo ranks serving the engine stream under
    ``full_recompute`` tensor-parallel, started with the module so that
    they run while the JAX package serves."""
    tree = jax.tree_util.tree_map(np.asarray, g5[1])
    started = {world: Ranks(world, g5[2].cfg, tree, [(
        "full_recompute", "call", {
            "target": "_torch_serve:serve_rank", "stream": "serve",
            "policy": "full_recompute", "rag_len": 128,
            "store_prefix": False})]) for world in RANK_WORLDS}
    yield started
    for r in started.values():
        r.close()


def _tokens(cfg, s, seed, b=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_caches_match(tc, jc, real=None):
    """Every key of a hybrid cache: K/V over the slots ``real`` (all by
    default), positions exactly, the SSM state and conv tail."""
    assert set(tc) == set(jc) == HYBRID_KEYS
    sl = slice(None) if real is None else real
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, :, sl],
                                   np.asarray(jc[key])[:, :, sl], atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy()[:, sl],
                                  np.asarray(jc["pos"])[:, sl])
    for key in ("ssm_h", "ssm_conv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------

def test_configs_match_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_get_smoke_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.ssm_num_heads,
            cfg.ssm_state, cfg.sliding_window) == (5, 25, 16, 2048)
    assert build_model(cfg).supports_paged_decode() is False


def test_g5_case_keeps_hymbas_group(g5):
    cfg = g5[2].cfg
    assert cfg.num_heads // cfg.num_kv_heads == 5
    assert (cfg.ssm_state, cfg.ssm_chunk, cfg.sliding_window) == (16, 16, 64)


def test_weight_bridge_carries_the_hybrid_leaves(pair):
    _, jparams, tmodel, tparams = pair
    lay = jparams["layers"]
    for i, lp in enumerate(tparams.layers):
        for name, p in lp.ssm.named_parameters():
            leaf = lay["ssm"][name]
            want = np.asarray(leaf["scale"] if name == "out_norm" else leaf)[i]
            assert tuple(p.shape) == want.shape
            np.testing.assert_array_equal(p.numpy(), want)
        for name in ("attn_mix_norm", "ssm_mix_norm"):
            np.testing.assert_array_equal(
                getattr(lp, name).numpy(), np.asarray(lay[name]["scale"][i]))
        np.testing.assert_array_equal(lp.attn.wq.numpy(),
                                      np.asarray(lay["attn"]["wq"][i]))
    assert tparams.layers[0].ssm.in_proj.shape == (
        tmodel.cfg.d_model, 2 * tmodel.cfg.ssm_inner)


def test_init_params_draws_the_ssm_heads():
    """The port's seeded init fills a hybrid layer's SSM as ``init_ssm``
    does, beside the attention and the MLP; mix norms are ones."""
    cfg = get_smoke_config(ARCH)
    p = init_params(cfg, seed=3, device="cpu")
    lp = p.layers[0]
    assert lp.ssm.in_proj.float().abs().max() > 0
    assert lp.attn.wq.float().abs().max() > 0
    assert torch.all(lp.ssm.dt_bias == -4.6)
    assert torch.all(lp.attn_mix_norm == 1) and torch.all(lp.ssm_mix_norm == 1)
    again = init_params(cfg, seed=3, device="cpu")
    assert torch.equal(again.layers[1].ssm.out_proj, p.layers[1].ssm.out_proj)


# ---------------------------------------------------------------------------
# banded_attend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [2, 4], ids=["2w", "4w"])
def test_banded_attend_matches_jax(dtype, blocks):
    """G 5 (10 query heads on 2 kv heads), w 64, S = 2w or 4w; the second
    sequence ends in 5 padding rows at ``INVALID_POS``."""
    w, hq, hkv, dh = 64, 10, 2, 64
    s = blocks * w
    rng = np.random.default_rng(blocks)
    q = rng.standard_normal((2, s, hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, dh)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    pos[1, -5:] = INVALID_POS
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    ref = np.asarray(jax_banded_attend(
        *[jnp.asarray(a, jdt) for a in (q, k, v)], jnp.asarray(pos), w),
        np.float32)
    out = banded_attend(*[torch.from_numpy(a).to(tdt) for a in (q, k, v)],
                        torch.from_numpy(pos), w)
    assert out.shape == (2, s, hq, dh) and out.dtype == tdt
    real = torch.from_numpy(pos != INVALID_POS)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy()[real.numpy()],
                                   ref[real.numpy()], atol=1e-5, rtol=0)
        return
    vmax = float(np.abs(torch.from_numpy(v).to(tdt).float().numpy()).max())
    res = compare(out, torch.from_numpy(ref).to(tdt), rows=real,
                  limit=lambda o, r: error_limit(o, r, vmax) + 2 ** -9 * vmax)
    assert res["worst"] <= 1.0, res


def test_banded_attend_rejects_what_it_does_not_take():
    q = torch.zeros((1, 96, 2, 64))
    kv = torch.zeros((1, 96, 2, 64))
    pos = torch.arange(96, dtype=torch.int32)[None]
    for s in (96, 64):          # not whole windows; one window only
        with pytest.raises(ValueError, match="banded_attend"):
            banded_attend(q[:, :s], kv[:, :s], kv[:, :s], pos[:, :s], 64)
    with pytest.raises(ValueError, match="banded_attend"):
        banded_attend(q[:, :64], kv, kv, pos[:, :64], 32)   # Skv != S


# ---------------------------------------------------------------------------
# model passes
# ---------------------------------------------------------------------------

def test_one_hybrid_layer_matches_jax():
    """A one-layer hybrid (G 5) through ``forward_with_cache`` from random
    embeddings: a 48-token prefill (three chunks) into 64 slots, then one
    decode step; logits and every cache key against the JAX pass."""
    jm, jp, tm, tp = build_pair(arch=ARCH, num_layers=1, **CASES["g5"])
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    s, kv_len = 48, 64
    emb = rng.standard_normal((1, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    mask = np.ones((1, s), np.float32)
    tail = np.full((1,), s - (cfg.ssm_conv_width - 1), np.int32)
    jl, jc, _ = jtf.forward_with_cache(
        jp, jm.cfg, jnp.asarray(emb), jnp.asarray(pos), jm.make_cache(1, kv_len),
        jnp.asarray(pos), ssm_mask=jnp.asarray(mask),
        ssm_tail_start=jnp.asarray(tail), contiguous=True)
    tc = tm.make_cache(1, kv_len, device="cpu")
    tl, tc = ttf.forward_with_cache(
        tp, cfg, torch.from_numpy(emb), torch.from_numpy(pos), tc,
        torch.from_numpy(pos), ssm_mask=torch.from_numpy(mask),
        ssm_tail_start=torch.from_numpy(tail), contiguous=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_caches_match(tc, jc)
    emb1 = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((1, 1), s, np.int32)
    jl, jc, _ = jtf.forward_with_cache(jp, jm.cfg, jnp.asarray(emb1),
                                       jnp.asarray(p1), jc, jnp.asarray(p1))
    tl, tc = ttf.forward_with_cache(tp, cfg, torch.from_numpy(emb1),
                                    torch.from_numpy(p1), tc,
                                    torch.from_numpy(p1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_caches_match(tc, jc)


def _count_banded(monkeypatch):
    calls = []
    real = ttf.banded_attend

    def counting(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(ttf, "banded_attend", counting)
    return calls


@pytest.mark.parametrize("s,kv_len,banded", [(23, 40, False),
                                             (128, 128, True),
                                             (128, 129, False)],
                         ids=["pads", "banded", "windowed"])
def test_prefill_matches_jax(pair, monkeypatch, s, kv_len, banded):
    """S 23 pads to 32 (the pads' K/V parked in slot 39); S 128 into
    exactly 128 slots takes the banded branch in every layer, into 129 the
    windowed dense attention."""
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, s, seed=s + kv_len)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.make_cache(1, kv_len))
    calls = _count_banded(monkeypatch)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks),
                        tm.make_cache(1, kv_len, device="cpu"))
    assert calls == ([s] * tm.cfg.num_layers if banded else [])
    assert tl.shape == (1, s, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # the pads' K/V land on one scratch slot: which pad wins is undefined
    _assert_caches_match(tc, jc, real=slice(0, min(s, kv_len - 1)))
    assert (tc["pos"][0, s:] == INVALID_POS).all()


def test_prefill_needs_a_scratch_slot_past_padded_tokens(g5):
    """23 tokens pad to 32, whose K/V go to the cache's last slot: in a
    cache of 23 slots that is the last token's, so the port raises."""
    _, _, tm, tp = g5
    toks = torch.from_numpy(_tokens(tm.cfg, 23, seed=1))
    with pytest.raises(ValueError, match="scratch slot"):
        tm.prefill(tp, toks, tm.make_cache(1, 23, device="cpu"))


@pytest.mark.parametrize("s", [23, 128, 200])
def test_forward_matches_jax(pair, monkeypatch, s):
    """The cache-free forward: S 23 pads to 32; S 128 (2 windows) takes the
    banded branch; S 200 pads to 208, not whole windows, so it does not."""
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, s, seed=s, b=2)
    ref = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    calls = _count_banded(monkeypatch)
    out = tm.forward(tp, torch.from_numpy(toks))
    assert calls == ([s] * tm.cfg.num_layers if s == 128 else [])
    assert out.shape == (2, s, tm.cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    # the inference forward is the prefill's oracle, as in the JAX tests
    tl, _ = tm.prefill(tp, torch.from_numpy(toks[:1]),
                       tm.make_cache(1, s + 1, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), out.numpy()[:1], atol=ATOL, rtol=0)


def test_decode_steps_match_jax(pair):
    """Two sequences prefilled 150 tokens (past two windows, padded to
    160) into 192 slots, then three decode steps."""
    jm, jp, tm, tp = pair
    s, kv_len = 150, 192
    toks = _tokens(tm.cfg, s, seed=5, b=2)
    _, jc = jm.prefill(jp, jnp.asarray(toks), jm.make_cache(2, kv_len))
    _, tc = tm.prefill(tp, torch.from_numpy(toks),
                       tm.make_cache(2, kv_len, device="cpu"))
    nxt = _tokens(tm.cfg, 3, seed=6, b=2)
    for i in range(3):
        tok = nxt[:, i:i + 1]
        pos = np.full((2, 1), s + i, np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos), jc,
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    _assert_caches_match(tc, jc, real=slice(0, s + 3))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_RUNS = {
    "full_recompute": ("full_recompute", {}),
    "mpic": ("mpic", {}),
    "cacheblend": ("cacheblend", {}),
    "prefix_caching": ("prefix_caching", {}),
    "full_recompute_chunk_asked": ("full_recompute",
                                   {"prefill_chunk_tokens": 32}),
}


_JAX_RUNS = {}


def _jax_serve(g5, run):
    """The JAX engine's answer to ``ENGINE_RUNS[run]``, once a module."""
    if run not in _JAX_RUNS:
        policy, engine_kw = ENGINE_RUNS[run]
        _JAX_RUNS[run] = serve("jax", *g5[:2], policy, rag_len=128,
                               store_prefix=False, **engine_kw)
    return _JAX_RUNS[run]


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_engine_matches_jax(g5, run):
    """Three dialogues and an MRAG request on the dense cache (``paged``
    asked for), no prefix stored; every policy is served as
    ``full_recompute`` except ``prefix_caching``, which misses, and no
    prefill is chunked even when chunks are asked for."""
    jm, jp, tm, tp = g5
    policy, engine_kw = ENGINE_RUNS[run]
    kw = dict(rag_len=128, store_prefix=False, **engine_kw)
    jreqs, jfirst, _ = _jax_serve(g5, run)
    treqs, tfirst, teng = serve("torch", tm, tp, policy, **kw)
    assert teng.pool is None and set(teng._batch_cache) == HYBRID_KEYS
    assert min(r.prompt.total_len for r in treqs[:3]) > \
        2 * tm.cfg.sliding_window
    want = "prefix_caching" if policy == "prefix_caching" else \
        "full_recompute"
    assert "RAG1" in treqs[-1].linked_media
    for jr, tr, jl, tl in zip(jreqs, treqs, jfirst, tfirst):
        assert tr.done and jr.done and tr.slot == -1
        assert tr.prefill_stats["policy"] == jr.prefill_stats["policy"] \
            == want
        assert tr.prefill_stats["n_reused"] == 0
        assert "chunks" not in tr.prefill_stats
        assert tr.output_tokens == jr.output_tokens
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)


@pytest.mark.parametrize("world", list(RANK_WORLDS))
def test_ranks_serve_the_jax_engines_tokens(g5, ranks, world):
    """The engine stream under ``full_recompute`` on ``world`` ranks: on 2
    each rank cuts attention by its kv head and the SSD heads by 2 of 4
    (their state in its dense cache); on 3 neither divides, and every
    attention and SSM leaf is whole on each rank.  Both give the JAX
    engine's tokens, first-token logits within 1e-4 relative."""
    jreqs, jfirst, _ = _jax_serve(g5, "full_recompute")
    cfg = g5[2].cfg
    attn, ssm = RANK_WORLDS[world]
    for rank, got in ranks[world].results().items():
        res = got["full_recompute"]
        assert (res["cuts"].attn, res["cuts"].ssm) == (attn, ssm)
        heads = cfg.ssm_num_heads // world if ssm else cfg.ssm_num_heads
        assert res["widths"].ssm_heads == res["cache"]["ssm_h"][2] == heads
        assert res["cache"]["k"][3] == (cfg.num_kv_heads // world if attn
                                        else cfg.num_kv_heads)
        assert res["tokens"] == [r.output_tokens for r in jreqs]
        assert res["linked"] == [r.linked_media for r in jreqs]
        assert set(res["policies"]) == {"full_recompute"}
        for g, j in zip(res["firsts"], jfirst):
            assert rel(g, j) <= REL


# ---------------------------------------------------------------------------
# two reference defects, beside the port's answer
# ---------------------------------------------------------------------------

def test_reference_upload_parks_pads_on_the_last_token(g5):
    """A 23-token hybrid upload pads to 32.  The JAX package prefills it
    into a cache of exactly 23 slots, so the pads' K/V land in slot 22,
    the last real token's: its K there differs from a prefill into 24
    slots, and its position reads ``INVALID_POS``.  The port's upload
    parks the pads past the segment and equals the 24-slot prefill."""
    jm, jp, tm, tp = g5
    n = 23
    emb = np.random.default_rng(0).standard_normal(
        (n, tm.cfg.d_model)).astype(np.float32) * 0.5
    toks = jnp.zeros((1, n), jnp.int32)
    mask = jnp.ones((1, n), bool)
    _, good = jm.prefill(jp, toks, jm.make_cache(1, n + 1),
                         media_embeds=jnp.asarray(emb)[None], media_mask=mask)
    want_k = np.asarray(good["k"])[:, 0, :n]
    want_v = np.asarray(good["v"])[:, 0, :n]
    # the reference's defect
    jk, jv = jax_precompute(jm, jp, jnp.asarray(emb))
    jk = np.asarray(jk)
    np.testing.assert_allclose(jk[:, :n - 1], want_k[:, :n - 1], atol=ATOL)
    assert np.abs(jk[:, n - 1] - want_k[:, n - 1]).max() > 0.1
    _, exact = jm.prefill(jp, toks, jm.make_cache(1, n),
                          media_embeds=jnp.asarray(emb)[None], media_mask=mask)
    assert int(exact["pos"][0, -1]) == INVALID_POS
    # the port's upload
    tk, tv = precompute_media_kv(tm, tp, torch.from_numpy(emb))
    assert tk.shape == (tm.cfg.num_layers, n, tm.cfg.num_kv_heads,
                        tm.cfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), want_k, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), want_v, atol=ATOL, rtol=0)


def _prefix_vs_full(pkg, model, params, prompt, n_prefix):
    """(prefix_caching's first logits with the prompt's first ``n_prefix``
    tokens stored, full_recompute's, prefix_caching's stats)."""
    flat = prompt.flat_tokens()
    toks = flat[None, :n_prefix]
    if pkg == "jax":
        _, c = model.prefill(params, jnp.asarray(toks),
                             model.make_cache(1, n_prefix + 1))
        pol, store = jpol, jpol.PrefixStore()
    else:
        _, c = model.prefill(params, torch.from_numpy(toks),
                             model.make_cache(1, n_prefix + 1, device="cpu"))
        pol, store = tpol, tpol.PrefixStore()
    store.put(flat[:n_prefix], c["k"][:, 0, :n_prefix],
              c["v"][:, 0, :n_prefix])
    hit = pol.prefix_caching(model, params, prompt, prefix_store=store)
    full = pol.full_recompute(model, params, prompt)
    return (np.asarray(hit.first_logits, np.float32),
            np.asarray(full.first_logits, np.float32), hit.stats)


def test_reference_prefix_hit_starts_the_ssd_from_zero(g5):
    """``prefix_caching`` with a 32-token stored prefix.  The JAX package
    reuses a hybrid's prefix K/V and runs its SSD heads over the suffix
    alone, from a zero state: its first logits leave full_recompute's.
    An attention-only model (yi-9b's smoke config at G 8) is the control:
    there the hit is exact.  The port takes a hybrid's hit as a miss
    (``n_reused`` 0) and equals full_recompute."""
    jm, jp, tm, tp = g5
    ids = np.random.default_rng(9).integers(1, 255, 60)
    jprompt = JaxPrompt([jax_text(ids)], user_id="u")
    tprompt = Prompt([text_segment(ids)], user_id="u")
    hit, full, stats = _prefix_vs_full("jax", jm, jp, jprompt, 32)
    assert stats["n_reused"] == 32
    assert np.abs(hit - full).max() > 1e-2
    ym, yp, ytm, ytp = build_gqa_pair("yi-g8")
    yhit, yfull, ystats = _prefix_vs_full("jax", ym, yp, jprompt, 32)
    assert ystats["n_reused"] == 32
    np.testing.assert_allclose(yhit, yfull, atol=1e-4, rtol=0)
    yhit, yfull, ystats = _prefix_vs_full("torch", ytm, ytp, tprompt, 32)
    assert ystats["n_reused"] == 32
    np.testing.assert_allclose(yhit, yfull, atol=1e-4, rtol=0)
    thit, tfull, tstats = _prefix_vs_full("torch", tm, tp, tprompt, 32)
    assert tstats["n_reused"] == 0 and tstats["n_recomputed"] == 60
    np.testing.assert_array_equal(thit, tfull)
    np.testing.assert_allclose(tfull, full, atol=1e-3, rtol=0)
