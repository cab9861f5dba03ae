"""Shared set-up for the parity tests of the GQA models, chunked prefill
and sampling: each served model's smoke config at its own query-head group
(the smoke sizes cap heads at 4 and kv heads at 2, which would make every
group 2), both packages' models with the JAX weights carried over, nonzero
QKV biases where the config has them (the JAX package initialises them to
zeros, which would hide a dropped bias), and one function that serves the
same traffic through either package's engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import Prompt as JaxPrompt
from repro.core import text_segment as jax_text
from repro.data import ByteTokenizer as JaxTokenizer
from repro.data import SYSTEM_PROMPT
from repro.data import image_embeds as jax_image_embeds
from repro.data import make_dialogues as jax_dialogues
from repro.models import build_model as jax_build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import MPICEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.core import Prompt, text_segment
from repro_torch.data import image_embeds, make_dialogues
from repro_torch.models import build_model as torch_build_model
from repro_torch.serving import EngineConfig, MPICEngine, Request
from repro_torch.weights import params_from_numpy

from _torch_parity import smoke_configs

# case -> (arch, overrides of the smoke config): qwen2.5-14b's group of 5
# with QKV bias, yi-9b's 8, phi3-medium-14b's 4, stablelm-1.6b's MHA at
# head dim 64
MODELS = {
    "qwen-g5": ("qwen2.5-14b", dict(num_heads=10, num_kv_heads=2)),
    "yi-g8": ("yi-9b", dict(num_heads=8, num_kv_heads=1)),
    "phi3-g4": ("phi3-medium-14b", dict(num_heads=8, num_kv_heads=2)),
    "stablelm-mha": ("stablelm-1.6b", {}),
}
KWARGS = {"mpic": {"k": 8}, "cacheblend": {"r": 0.25}}
BIAS_SCALE = 0.5


def build_gqa_pair(case: str, seed: int = 0):
    """(jax_model, jax_params, torch_model, torch_params) of one case; with
    ``qkv_bias`` the JAX tree's ``bq``/``bk``/``bv`` are set to seeded
    N(0, 0.5^2) values before the tree is carried over."""
    arch, over = MODELS[case]
    jcfg, tcfg = smoke_configs(arch, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = jparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape).astype(np.float32)
                * BIAS_SCALE)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = torch_build_model(tcfg)
    return jmodel, jparams, tmodel, params_from_numpy(tree, tcfg, "cpu")


def _store_system_prompt(pkg, eng, model, params):
    """Put the system prompt's KV into the engine's prefix store."""
    sys_toks = JaxTokenizer().encode(SYSTEM_PROMPT, bos=True)
    n = len(sys_toks)
    if pkg == "jax":
        cache = model.make_cache(1, n + 1)
        _, cache = model.prefill(params, jnp.asarray(sys_toks[None]), cache)
    else:
        cache = model.make_cache(1, n + 1, device="cpu")
        _, cache = model.prefill(
            params, torch.as_tensor(sys_toks[None], dtype=torch.int32), cache)
    eng.prefix_store.put(sys_toks, cache["k"][:, 0, :n], cache["v"][:, 0, :n])


def serve(pkg, model, params, policy, pool_dtype="", paged=True, *,
          max_new=6, seeds=None, mrag=True, on_step=None, rag_len=12,
          store_prefix=True, **engine_kw):
    """Three two-image dialogues and (``mrag``) one MRAG request, whose
    retrieved image has ``rag_len`` tokens, under one policy through one
    package's engine, two decode slots; with ``store_prefix`` the system
    prompt's KV sits in the engine's prefix store.  ``engine_kw`` go to
    both ``EngineConfig``s (``prefill_chunk_tokens``, ``greedy``,
    ``temperature``, ``top_k``); ``seeds`` are the requests' sampling
    seeds; ``on_step(eng)`` runs after every engine step.  Returns
    (requests, first-token logits per request, engine)."""
    if pkg == "jax":
        eng = JaxEngine(model, params, JaxEngineConfig(
            max_seq_len=256, decode_slots=2, paged_backend="ref",
            pool_dtype=pool_dtype, pipelined=False, paged=paged, **engine_kw))
        dialogues, embeds, text, mk_prompt, mk_req = (
            jax_dialogues, jax_image_embeds, jax_text, JaxPrompt, JaxRequest)
    else:
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype,
            paged=paged, **engine_kw), device="cpu")
        dialogues, embeds, text, mk_prompt, mk_req = (
            make_dialogues, image_embeds, text_segment, Prompt, Request)
    if store_prefix:
        _store_system_prompt(pkg, eng, model, params)
    cfg = model.cfg
    firsts = {}
    finalize = eng._finalize_prefill

    def record(req, result, *rest):
        firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
        return finalize(req, result, *rest)

    eng._finalize_prefill = record
    samples = dialogues(n=3, n_images=2, d_model=cfg.d_model,
                        media_len=cfg.media_token_len)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    kw = KWARGS.get(policy, {})
    reqs = [mk_req(prompt=s.prompt, max_new_tokens=max_new, policy=policy,
                   policy_kwargs=kw) for s in samples]
    if mrag:
        rag = embeds("RAG1", rag_len, cfg.d_model)
        eng.upload("*", "RAG1", rag, dynamic=True)
        req = mk_req(prompt=mk_prompt([text(np.arange(20, 60))],
                                      user_id="u0"),
                     max_new_tokens=max_new, policy=policy, policy_kwargs=kw)
        req.retrieval_query = rag.mean(0)
        reqs.append(req)
    for i, r in enumerate(reqs):
        if seeds is not None:
            r.seed = seeds[i]
        eng.submit(r)
    steps = 0
    while (eng.scheduler.queue or any(eng.running)) and steps < 1000:
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng)
    return reqs, [firsts[r.req_id] for r in reqs], eng
