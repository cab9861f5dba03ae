"""The port's whisper-small against the JAX package's, on the fp32 smoke
config (2 encoder and 2 decoder layers, 32 audio frames, d 256, 4 heads at
Dh 64) with the JAX weights carried over: the config, the weight bridge
both ways, ``layernorm`` and ``gelu_mlp``, the encoder, the cross K/V,
``Model.forward``, ``prefill`` with audio and ``decode_step``, and the
engine on a text-only request.

The JAX side runs its jnp ``attend``; the port's serving passes run the
dense selective attention's plain version (the kernel's, on the CPU),
the encoder with every query at the last frame's position.

Tolerances: fp32 within 1e-4 (sums in another order over two layers);
bf16 attention within one bf16 ulp of the larger value plus
``2**-17 * max|V|`` plus ``2**-9 * max|V|``: the JAX ``attend`` rounds
the probabilities to bf16 before the value product, the port's kernel
keeps them fp32 (ROADMAP queue 3); a bf16 forward's logits within 2 %
relative RMS (that rounding and bf16 activations over four layers); the
engine's greedy tokens identical, first-token logits within 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import Prompt as JaxPrompt
from repro.core import text_segment as jax_text
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import Prompt, text_segment
from repro_torch.kernels.check import compare, error_limit
from repro_torch.kernels.selective_attn.ops import selective_attention
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.serving import EngineConfig, MPICEngine, Request, State
from repro_torch.weights import params_from_numpy, params_to_numpy, reference_tree

from _torch_parity import build_pair, jax_compile_cache  # noqa: F401

ARCH = "whisper-small"
ATOL = 1e-4
B, S = 2, 12


@pytest.fixture(scope="module")
def pair():
    return build_pair(arch=ARCH)


@pytest.fixture(scope="module")
def audio(pair):
    cfg = pair[2].cfg
    rng = np.random.default_rng(2)
    return (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
            * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def tokens(pair):
    return np.random.default_rng(1).integers(
        0, pair[2].cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32)


def test_configs_match_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_get_smoke_config(ARCH))


def test_weight_bridge_both_ways(pair):
    """Every leaf carried over and back equals the JAX tree's, keys in
    the order JAX's tree functions give them; the port's own seeded
    weights have the JAX tree's structure and shapes."""
    _, jparams, tmodel, tparams = pair
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    back = params_to_numpy(tparams)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jtree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert list(back) == list(jtree)
    own = reference_tree(tmodel.init(seed=3, device="cpu"))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == \
        jax.tree_util.tree_map(lambda a: a.shape, jtree)
    assert float(own["layers"]["mlp"]["b_up"].abs().max()) == 0.0
    assert float(own["enc_norm"]["scale"].min()) == 1.0


def test_layernorm_and_gelu_mlp_match(pair):
    _, jparams, _, tparams = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(256).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    ref = jlayers.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x))
    out = tlayers.layernorm(torch.from_numpy(scale), torch.from_numpy(bias),
                            torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)
    mlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["mlp"])
    mlp = dict(mlp, b_up=jnp.asarray(rng.standard_normal(512), jnp.float32),
               b_down=jnp.asarray(rng.standard_normal(256), jnp.float32))
    ref = jlayers.gelu_mlp(mlp, jnp.asarray(x))
    out = tlayers.gelu_mlp(*[torch.from_numpy(np.asarray(mlp[n])) for n in
                             ("w_up", "b_up", "w_down", "b_down")],
                           torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)
    assert tparams.layers[0].mlp.b_up.shape == (512,)


def test_encoder_rule_is_bidirectional_attention():
    """Every query at the last frame's position keeps exactly the pairs
    of bidirectional attention, and the dense selective attention then
    equals ``attend(bidirectional=True)`` bit for bit in fp32 (and the JAX
    ``attend`` within 1e-6)."""
    rng = np.random.default_rng(4)
    b, s, h, dh = 2, 32, 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh))
                                .astype(np.float32)) for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    last = torch.full((b, s), s - 1, dtype=torch.int32)
    kept = (pos[:, None, :] <= last[:, :, None]) & \
        (pos[:, None, :] != tlayers.INVALID_POS)
    assert bool(kept.all())
    out = selective_attention(q, k, v, last, pos)
    ref = tlayers.attend(q, k, v, pos, pos, bidirectional=True)
    assert torch.equal(out, ref)
    jref = jlayers.attend(*[jnp.asarray(t.numpy()) for t in (q, k, v, pos,
                                                             pos)],
                          bidirectional=True)
    np.testing.assert_allclose(ref.numpy(), _np(jref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["encoder", "cross"])
def test_bf16_attention_within_one_rounding(case):
    """bf16: the encoder's rule and the cross attention's zero positions
    on the kernel's plain version, against JAX's bidirectional ``attend``
    in bf16 (the probabilities' one bf16 rounding apart)."""
    rng = np.random.default_rng(5)
    b, sq, skv, h, dh = 2, 12 if case == "cross" else 32, 32, 4, 64
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, h, dh)).astype(np.float32)
            for _ in range(2))
    kv_pos = (np.tile(np.arange(skv, dtype=np.int32), (b, 1))
              if case == "encoder" else np.zeros((b, skv), np.int32))
    q_pos = np.full((b, sq), skv - 1 if case == "encoder" else 0, np.int32)
    ref = jlayers.attend(*[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)],
                         jnp.asarray(q_pos), jnp.asarray(kv_pos),
                         bidirectional=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = selective_attention(tq, tk, tv, torch.from_numpy(q_pos),
                              torch.from_numpy(kv_pos))
    vmax = float(tv.float().abs().max())
    res = compare(out, torch.from_numpy(_np(ref)).bfloat16(),
                  limit=lambda o, r: error_limit(o, r, vmax)
                  + 2 ** -9 * vmax)
    assert res["worst"] <= 1.0, res


def test_encode_and_cross_kv_match(pair, audio):
    jm, jp, tm, tp = pair
    jenc = jm.encode_audio(jp, jnp.asarray(audio))
    tenc = tm.encode_audio(tp, torch.from_numpy(audio))
    np.testing.assert_allclose(tenc.numpy(), _np(jenc), atol=ATOL, rtol=0)
    jk, jv = jm.cross_kv(jp, jenc)
    tk, tv = tm.cross_kv(tp, tenc)
    assert tk.shape == (tm.cfg.num_layers, B, tm.cfg.encoder_seq,
                        tm.cfg.num_kv_heads, tm.cfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ATOL, rtol=0)


def test_forward_prefill_decode_match(pair, audio, tokens):
    """``forward``, ``prefill`` with audio into 64 slots (logits and the
    cache: K/V, positions, cross K/V) and three greedy decode steps, each
    against the JAX pass; and the reference's own check, prefill and
    every decode step equal to ``forward`` over the same sequence."""
    jm, jp, tm, tp = pair
    ja, ta = jnp.asarray(audio), torch.from_numpy(audio)
    jfull = jm.forward(jp, jnp.asarray(tokens), audio_embeds=ja)
    tfull = tm.forward(tp, torch.from_numpy(tokens), audio_embeds=ta)
    np.testing.assert_allclose(tfull.numpy(), _np(jfull), atol=ATOL, rtol=0)

    jlg, jc = jm.prefill(jp, jnp.asarray(tokens), jm.make_cache(B, 64),
                         audio_embeds=ja)
    tlg, tc = tm.prefill(tp, torch.from_numpy(tokens),
                         tm.make_cache(B, 64, device="cpu"), audio_embeds=ta)
    np.testing.assert_allclose(tlg.numpy(), _np(jlg), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlg.numpy(), tfull.numpy(), atol=ATOL, rtol=0)
    assert set(tc) == set(jc)
    for key in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), atol=ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    seq = tokens
    for step in range(3):
        nxt = np.asarray(tlg[:, -1] if tlg.ndim == 3 else tlg).argmax(-1)
        nxt = nxt[:, None].astype(np.int32)
        pos = np.full((B, 1), S + step, np.int32)
        jlg, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                                 jnp.asarray(pos))
        tpos = torch.from_numpy(pos)
        tlg, tc = tm.decode_step(tp, torch.from_numpy(nxt), tpos, tc, tpos)
        np.testing.assert_allclose(tlg.numpy(), _np(jlg), atol=ATOL, rtol=0)
        seq = np.concatenate([seq, nxt], 1)
        tfull = tm.forward(tp, torch.from_numpy(seq), audio_embeds=ta)
        np.testing.assert_allclose(tlg.numpy(), tfull[:, -1].numpy(),
                                   atol=ATOL, rtol=0)


def test_bf16_forward_near_jax(audio, tokens):
    jcfg = jax_get_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(ARCH))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tm.cfg,
                           "cpu")
    assert tp.pos_embed.dtype == torch.bfloat16
    ref = _np(jm.forward(jp, jnp.asarray(tokens),
                         audio_embeds=jnp.asarray(audio)))
    out = tm.forward(tp, torch.from_numpy(tokens),
                     audio_embeds=torch.from_numpy(audio)).numpy()
    rel = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
    assert rel <= 0.02, rel


def test_model_refuses_inconsistent_families():
    cfg = get_smoke_config(ARCH)
    for over in ({"is_encoder_decoder": False}, {"learned_pos_emb": False},
                 {"arch_type": "dense"}):
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(cfg, **over))
    assert not build_model(cfg).supports_paged_decode()


def test_engine_on_a_text_only_request(pair):
    """The JAX engine serves a text-only request under ``full_recompute``
    and ``prefix_caching`` (its cache's cross K/V zeros) and raises
    ``KeyError: 'cross_k'`` under the policies that link media KV; the
    port's engine gives the same tokens and fails those requests with its
    reason, serving on."""
    jm, jp, tm, tp = pair
    toks = np.arange(10, 30)
    results = {}
    for policy in ("full_recompute", "prefix_caching"):
        outs = []
        for pkg in ("jax", "torch"):
            if pkg == "jax":
                eng = JaxEngine(jm, jp, JaxEngineConfig(max_seq_len=64,
                                                        decode_slots=2))
                req = JaxRequest(prompt=JaxPrompt([jax_text(toks)],
                                                  user_id="u"),
                                 max_new_tokens=4, policy=policy)
            else:
                eng = MPICEngine(tm, tp, EngineConfig(max_seq_len=64,
                                                      decode_slots=2),
                                 device="cpu")
                req = Request(prompt=Prompt([text_segment(toks)],
                                            user_id="u"),
                              max_new_tokens=4, policy=policy)
            assert eng.pool is None
            eng.submit(req)
            eng.run()
            assert req.error is None and len(req.output_tokens) == 4
            outs.append(req.output_tokens)
        assert outs[0] == outs[1], policy
        results[policy] = outs[1]
    assert results["full_recompute"] == results["prefix_caching"]

    jeng = JaxEngine(jm, jp, JaxEngineConfig(max_seq_len=64, decode_slots=2))
    jeng.submit(JaxRequest(prompt=JaxPrompt([jax_text(toks)], user_id="u"),
                           max_new_tokens=4, policy="mpic"))
    with pytest.raises(KeyError, match="cross_k"):
        jeng.run()
    eng = MPICEngine(tm, tp, EngineConfig(max_seq_len=64, decode_slots=2),
                     device="cpu")
    reqs = [eng.submit(Request(prompt=Prompt([text_segment(toks)],
                                             user_id="u"),
                               max_new_tokens=4, policy=policy))
            for policy in ("mpic", "cacheblend", "full_reuse",
                           "full_recompute")]
    eng.run()
    for r in reqs[:3]:
        assert r.state is State.FAILED and "cross-attention" in r.error
    assert reqs[3].output_tokens == results["full_recompute"]
