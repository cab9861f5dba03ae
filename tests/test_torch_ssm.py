"""The port's SSM slice against the JAX package on the CPU: the SSD chunk
step's plain version, ``ssd_chunked``, the SSM layer (``ssm_forward``,
``ssm_decode``), mamba2's prefill and decode, and the engine serving it
(dense cache, every policy resolved to ``full_recompute``).

Inputs come from numpy seeds; the port computes with the JAX weights,
carried over by ``params_from_numpy``; the mamba2 smoke config runs in fp32.
Tolerances, each the fp32 sum order over the terms named:

- the SSD chunk step: 1e-4 abs and rel, the JAX package's own tolerance
  for its Pallas kernel against its oracle;
- ``ssd_chunked``: 1e-4 abs and rel (the port composes the chunk states in
  a loop, the JAX package with an associative scan);
- the SSM layer, the prefill and decode: 1e-4 abs (two layers of fp32
  projections of width 256-1024);
- the engine: greedy tokens identical, first-token logits within 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import make_dialogues as jax_dialogues
from repro.kernels.ssd_chunk.ops import ssd_chunk as jax_ssd_chunk
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.core import Prompt, text_segment
from repro_torch.cache.library import KVLibrary
from repro_torch.core.policies import cacheblend
from repro_torch.data import make_dialogues
from repro_torch.kernels import KERNELS
from repro_torch.kernels._build import reset_launches
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.models import build_model, ssm
from repro_torch.models.transformer import SSMLayer, init_params
from repro_torch.serving import EngineConfig, MPICEngine
from repro_torch.weights import params_from_numpy

from _torch_parity import build_pair, smoke_configs
from _torch_serve import serve_ssm
from _torch_sharded import REL, Ranks, rel
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

ARCH = "mamba2-130m"
ATOL = 1e-4
MAX_NEW = 5

# the shapes of tests/test_ssd_kernel.py: (b, nc, h, q, hd, ds)
SHAPES = [(1, 2, 2, 8, 16, 8), (2, 3, 4, 16, 32, 16),
          (1, 4, 3, 32, 64, 128), (2, 2, 5, 64, 64, 16)]


def _chunk_inputs(rng, b, nc, h, q, hd, ds, dt_hi=0.2):
    return (rng.normal(size=(b, nc, h, q, hd)).astype(np.float32),
            rng.normal(size=(b, nc, q, ds)).astype(np.float32),
            rng.normal(size=(b, nc, q, ds)).astype(np.float32),
            -rng.uniform(0.01, 0.4, (b, nc, h, q)).astype(np.float32),
            rng.uniform(0.01, dt_hi, (b, nc, h, q)).astype(np.float32))


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def pair():
    return build_pair(arch=ARCH)


def test_configs_match_field_for_field():
    jcfg, tcfg = smoke_configs(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert (full.ssm_inner, full.ssm_num_heads) == (1536, 24)
    assert (tcfg.ssm_inner, tcfg.ssm_num_heads) == (jcfg.ssm_inner,
                                                    jcfg.ssm_num_heads)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_ssd_chunk_ref_matches_jax(shape):
    args = _chunk_inputs(np.random.default_rng(0), *shape)
    ours = ssd_chunk_ref(*map(torch.as_tensor, args))
    jargs = [jnp.asarray(a) for a in args]
    for theirs in (jax_ssd_chunk_ref(*jargs),
                   jax_ssd_chunk(*jargs, interpret=True)):
        for o, t in zip(ours, theirs):
            _close(o, t, rtol=1e-4)


def test_ssd_chunk_pad_rows_and_large_dt():
    """Pad steps (la = dt = 0) add nothing and decay nothing; a large dt,
    whose masked exponents overflow, stays finite (the JAX oracle's tril
    product gives NaN there; the Pallas kernel selects, as the port does)."""
    rng = np.random.default_rng(1)
    x, bm, cm, la, dt = _chunk_inputs(rng, 1, 2, 3, 16, 32, 16)
    la[..., 11:] = 0.0
    dt[..., 11:] = 0.0
    y, s, a = ssd_chunk_ref(*map(torch.as_tensor, (x, bm, cm, la, dt)))
    cut = ssd_chunk_ref(*map(torch.as_tensor, (
        x[..., :11, :], bm[:, :, :11], cm[:, :, :11], la[..., :11],
        dt[..., :11])))
    _close(y[..., :11, :], cut[0], rtol=1e-4)
    _close(s, cut[1], rtol=1e-4)
    _close(a, cut[2], rtol=1e-6)
    big = _chunk_inputs(rng, 1, 2, 3, 16, 32, 16)
    la_big = -np.full_like(big[3], 60.0)
    args = (*big[:3], la_big, np.full_like(big[4], 4.0))
    ours = ssd_chunk_ref(*map(torch.as_tensor, args))
    assert all(bool(torch.isfinite(t).all()) for t in ours)
    assert not np.isfinite(np.asarray(
        jax_ssd_chunk_ref(*map(jnp.asarray, args))[0])).all()
    pallas = jax_ssd_chunk(*map(jnp.asarray, args), interpret=True)
    for o, t in zip(ours, pallas):
        _close(o, t, rtol=1e-4)


def test_dispatcher_takes_strided_views_on_the_cpu():
    """The dispatcher's CPU branch is the plain version, and the model's
    permuted views give what contiguous operands give."""
    args = [torch.as_tensor(a) for a in
            _chunk_inputs(np.random.default_rng(2), 1, 2, 3, 16, 32, 16)]
    x_model = args[0].permute(0, 1, 3, 2, 4).contiguous()
    la_model = args[3].permute(0, 1, 3, 2).contiguous()
    dt_model = args[4].permute(0, 1, 3, 2).contiguous()
    reset_launches(KERNELS.values())
    views = ssd_chunk(x_model.permute(0, 1, 3, 2, 4), args[1], args[2],
                      la_model.permute(0, 1, 3, 2),
                      dt_model.permute(0, 1, 3, 2))
    assert KERNELS["ssd_chunk"].launches == 0
    for o, t in zip(views, ssd_chunk_ref(*args)):
        assert torch.equal(o, t)


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(3)
    b, nc, h, q, hd, ds = 2, 3, 4, 16, 32, 16
    x, bm, cm, la, dt = _chunk_inputs(rng, b, nc, h, q, hd, ds)
    x, la, dt = (np.moveaxis(x, 2, 3).copy(), np.moveaxis(la, 2, 3).copy(),
                 np.moveaxis(dt, 2, 3).copy())
    h0 = rng.normal(size=(b, h, ds, hd)).astype(np.float32)
    args = (x, bm, cm, la, dt, h0)
    y, hf = ssm.ssd_chunked(*map(torch.as_tensor, args))
    jy, jhf = jax_ssm.ssd_chunked(*map(jnp.asarray, args))
    _close(y, jy, rtol=1e-4)
    _close(hf, jhf, rtol=1e-4)


def _layer(pair, i=0):
    jmodel, jparams, tmodel, tparams = pair
    jlp = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"]["ssm"])
    return jmodel.cfg, jlp, tparams.layers[i].ssm


def test_ssm_forward_and_decode_match_jax(pair):
    cfg, jlp, tlp = _layer(pair)
    rng = np.random.default_rng(4)
    b, t = 2, 3 * cfg.ssm_chunk
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[0, 37:] = 0.0                      # row 0: 37 real steps, then pads
    tail = np.array([37 - 3, t - 3], np.int32)
    out, st = ssm.ssm_forward(tlp, cfg, torch.as_tensor(x),
                              dt_mask=torch.as_tensor(mask),
                              tail_start=torch.as_tensor(tail))
    jout, jst = jax_ssm.ssm_forward(jlp, cfg, jnp.asarray(x),
                                    dt_mask=jnp.asarray(mask),
                                    tail_start=jnp.asarray(tail))
    _close(out, jout)
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])
    for _ in range(2):
        xs = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        out, st = ssm.ssm_decode(tlp, cfg, torch.as_tensor(xs), st)
        jout, jst = jax_ssm.ssm_decode(jlp, cfg, jnp.asarray(xs), jst)
        _close(out, jout)
        _close(st["h"], jst["h"])
        _close(st["conv"], jst["conv"])


def test_prefill_pads_to_chunks_and_decodes_like_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    s = 23                                  # not a multiple of ssm_chunk
    assert s % cfg.ssm_chunk
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                            jmodel.make_cache(1, 64))
    tc = tmodel.make_cache(1, 64, device="cpu")
    assert set(tc) == set(jc) == {"ssm_h", "ssm_conv"}
    tl, tc = tmodel.prefill(tparams, torch.as_tensor(toks), tc)
    assert tl.shape == (1, s, cfg.vocab_size)
    _close(tl, jl)
    for key in ("ssm_h", "ssm_conv"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    for i in range(3):
        tok = np.array([[7 + i]], np.int32)
        pos = np.array([[s + i]], np.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok),
                                    jnp.asarray(pos), jc, jnp.asarray(pos))
        tl, tc = tmodel.decode_step(tparams, torch.as_tensor(tok),
                                    torch.as_tensor(pos), tc,
                                    torch.as_tensor(pos))
        _close(tl, jl)
        for key in ("ssm_h", "ssm_conv"):
            _close(tc[key], jc[key])


@pytest.mark.parametrize("policy", ["full_recompute", "prefix_caching"])
def test_policies_run_on_the_ssm_cache(pair, policy):
    """The two policies that need no attention KV (prefix caching with an
    empty store) run on a cache of SSM state alone, as the JAX ones do."""
    from repro.core import policies as jax_policies
    from repro.core.policies import PrefixStore as JaxPrefixStore
    from repro_torch.core import policies
    from repro_torch.core.policies import PrefixStore

    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    sample = make_dialogues(n=1, n_images=2, d_model=cfg.d_model,
                            media_len=cfg.media_token_len)[0]
    jsample = jax_dialogues(n=1, n_images=2, d_model=cfg.d_model,
                            media_len=cfg.media_token_len)[0]
    got = getattr(policies, policy)(tmodel, tparams, sample.prompt,
                                    KVLibrary(), kv_len=256,
                                    prefix_store=PrefixStore())
    want = getattr(jax_policies, policy)(jmodel, jparams, jsample.prompt,
                                         None, kv_len=256,
                                         prefix_store=JaxPrefixStore())
    assert set(got.cache) == {"ssm_h", "ssm_conv"}
    assert got.stats["n_recomputed"] == sample.prompt.total_len
    _close(got.first_logits, want.first_logits)
    for key in ("ssm_h", "ssm_conv"):
        _close(got.cache[key], want.cache[key])


def test_tied_head_uses_the_embedding(pair):
    _, jparams, tmodel, tparams = pair
    assert tmodel.cfg.tie_embeddings and "lm_head" not in jparams
    assert tparams.lm_head is None
    assert "lm_head" not in dict(tparams.named_parameters())
    x = torch.as_tensor(np.random.default_rng(6).normal(
        size=(1, 3, tmodel.cfg.d_model)).astype(np.float32))
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import _logits
    want = rmsnorm(tparams.final_norm, x, tmodel.cfg.rms_norm_eps) \
        @ tparams.embed.T
    assert torch.equal(_logits(tparams, tmodel.cfg, x), want)


def test_weight_bridge_and_seeded_init_follow_init_ssm(pair):
    jmodel, jparams, tmodel, tparams = pair
    jl = jparams["layers"]["ssm"]
    seeded = init_params(tmodel.cfg, seed=0, device="cpu")
    for i, (lp, sp) in enumerate(zip(tparams.layers, seeded.layers)):
        assert isinstance(lp, SSMLayer)
        for name, p in lp.ssm.named_parameters():
            leaf = jl["out_norm"]["scale"] if name == "out_norm" else jl[name]
            np.testing.assert_array_equal(p.numpy(), np.asarray(leaf[i]))
            assert sp.ssm.get_parameter(name).shape == p.shape
    nh = tmodel.cfg.ssm_num_heads
    s0 = seeded.layers[0].ssm
    assert torch.all(s0.dt_bias == -4.6) and torch.all(s0.D == 1.0)
    assert torch.all(s0.conv_b == 0) and torch.all(s0.out_norm == 1)
    assert torch.allclose(s0.A_log, torch.log(torch.linspace(1.0, 16.0, nh)))
    # a bf16 model keeps the JAX package's fp32 leaves in fp32
    bf16 = dataclasses.replace(tmodel.cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    p16 = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                            bf16, "cpu")
    assert p16.layers[0].ssm.A_log.dtype == torch.float32
    assert p16.layers[0].ssm.in_proj.dtype == torch.bfloat16


def test_attention_paths_refuse_the_ssm(pair):
    _, _, tmodel, tparams = pair
    cfg = tmodel.cfg
    assert not tmodel.supports_paged_decode()
    assert not tmodel.supports_paged_prefill()
    idx = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention KV"):
        tmodel.selective_prefill(tparams, idx, idx,
                                 tmodel.make_cache(1, 8, device="cpu"), idx)
    prompt = Prompt([text_segment(np.arange(10, 40))], user_id="u")
    with pytest.raises(ValueError, match="attention KV"):
        cacheblend(tmodel, tparams, prompt, KVLibrary(), kv_len=64)
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, arch_type="audio"))


def test_paged_engine_falls_back_to_the_dense_cache(pair):
    _, _, tmodel, tparams = pair
    eng = MPICEngine(tmodel, tparams, EngineConfig(max_seq_len=64,
                                                   decode_slots=2, paged=True),
                     device="cpu")
    assert eng.pool is None and not eng._paged
    assert set(eng._batch_cache) == {"ssm_h", "ssm_conv"}
    with pytest.raises(ValueError, match="paged KV pool"):
        MPICEngine(tmodel, tparams, EngineConfig(
            max_seq_len=64, decode_slots=1, paged=True, pool_dtype="int8"),
            device="cpu")


_JAX_RUNS = {}


def _serve(pkg, model, params, policy):
    """``_torch_serve.serve_ssm`` at ``MAX_NEW``; the JAX package's runs
    once a module."""
    if pkg == "jax" and policy in _JAX_RUNS:
        return _JAX_RUNS[policy]
    out = serve_ssm(pkg, model, params, policy, MAX_NEW)
    if pkg == "jax":
        _JAX_RUNS[policy] = out
    return out


@pytest.fixture(scope="module", autouse=True)
def ranks(pair):
    """Two gloo ranks (``tests/_torch_sharded.py``) serving the stream
    tensor-parallel under ``full_recompute`` (4 of the 8 SSD heads a
    rank), started with the module, so that they run while the JAX
    package serves."""
    jparams, tmodel = pair[1], pair[2]
    started = Ranks(2, tmodel.cfg, jax.tree_util.tree_map(
        np.asarray, jparams), [("full_recompute", "call", {
            "target": "_torch_serve:serve_rank", "stream": "serve_ssm",
            "policy": "full_recompute", "max_new": MAX_NEW})])
    yield started
    started.close()


@pytest.mark.parametrize("policy", ["full_recompute", "mpic"])
def test_engine_matches_jax(pair, policy):
    jmodel, jparams, tmodel, tparams = pair
    jreqs, jfirst, _ = _serve("jax", jmodel, jparams, policy)
    reset_launches(KERNELS.values())
    treqs, tfirst, teng = _serve("torch", tmodel, tparams, policy)
    assert all(k.launches == 0 for k in KERNELS.values())     # CPU run
    assert teng.pool is None
    assert len({r.prompt.total_len % tmodel.cfg.ssm_chunk
                for r in treqs}) > 1
    for jr, tr, jl, tl in zip(jreqs, treqs, jfirst, tfirst):
        assert tr.done and jr.done and tr.slot == -1
        assert tr.prefill_stats["policy"] == "full_recompute"
        assert jr.prefill_stats["policy"] == "full_recompute"
        assert len(tr.output_tokens) == MAX_NEW
        assert tr.output_tokens == jr.output_tokens
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)


def test_two_ranks_serve_the_jax_engines_tokens(pair, ranks):
    """The stream under ``full_recompute`` on two ranks, each holding 4 of
    the 8 SSD heads (their state in its dense cache) and the whole
    ``bc_proj``: the JAX engine's tokens, first-token logits within 1e-4
    relative."""
    jreqs, jfirst, _ = _serve("jax", *pair[:2], "full_recompute")
    cfg = pair[2].cfg
    for rank, got in ranks.results().items():
        res = got["full_recompute"]
        assert res["cuts"].ssm and res["widths"].ssm_heads == \
            cfg.ssm_num_heads // 2
        assert res["cache"]["ssm_h"][2] == cfg.ssm_num_heads // 2
        assert res["cache"]["ssm_conv"][3] == cfg.ssm_inner // 2
        assert res["tokens"] == [r.output_tokens for r in jreqs]
        assert set(res["policies"]) == {"full_recompute"}
        for g, j in zip(res["firsts"], jfirst):
            assert rel(g, j) <= REL
