"""Public model facade (port of the JAX package's ``models/model.py``).

``Model`` holds the config; the parameters are a
:class:`~repro_torch.models.transformer.Transformer` module passed to each
call as ``params``, as the JAX facade takes its parameter pytree.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if cfg.arch_type in ("ssm", "hybrid", "moe", "audio") or cfg.hybrid:
        unsupported.append(f"arch_type={cfg.arch_type!r}")
    if cfg.is_encoder_decoder:
        unsupported.append("encoder-decoder")
    if cfg.qkv_bias:
        unsupported.append("qkv_bias")
    if cfg.learned_pos_emb:
        unsupported.append("learned_pos_emb")
    if cfg.tie_embeddings:
        unsupported.append("tie_embeddings")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(unsupported)}); the "
            "port serves attention-only models with RoPE")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        _check_supported(self.cfg)

    def init(self, *, seed: int = 0, device=None) -> tf.Transformer:
        return tf.init_params(self.cfg, seed=seed, device=device)

    def embed(self, params, tokens, media_embeds=None, media_mask=None):
        return tf.embed_tokens(params, self.cfg, tokens, media_embeds,
                               media_mask)

    def prefill(self, params, tokens, *, media_embeds=None, media_mask=None):
        """Plain contiguous prefill from position 0; returns (logits
        (B, S, V), cache {"k", "v": (L, B, S, Hkv, Dh), "pos"})."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        x = self.embed(params, tokens, media_embeds, media_mask)
        return tf.forward_with_cache(params, self.cfg, x, positions)

    def supports_paged_prefill(self) -> bool:
        return self.supports_paged_decode()

    def supports_paged_decode(self) -> bool:
        # every architecture the port accepts is attention-only
        return True

    def selective_prefill_paged(self, params, sel_tokens, sel_positions,
                                pool_k, pool_v, page_table, lengths,
                                write_pages, write_offs, k_scales=None,
                                v_scales=None, *, media_embeds=None,
                                media_mask=None) -> torch.Tensor:
        """MPIC selective prefill against the page pool, written in place.
        See :func:`repro_torch.models.transformer.selective_prefill_paged`.
        Returns logits (B, Sq, V)."""
        x = self.embed(params, sel_tokens, media_embeds, media_mask)
        return tf.selective_prefill_paged(
            params, self.cfg, x, sel_positions, pool_k, pool_v, page_table,
            lengths, write_pages, write_offs, k_scales, v_scales)

    def decode_step_paged(self, params, token, position, pool_k, pool_v,
                          page_table, lengths, write_pages, write_offs,
                          k_scales=None, v_scales=None) -> torch.Tensor:
        """One decode step against the page pool, written in place.  See
        :func:`repro_torch.models.transformer.decode_paged`.  Returns
        logits (B, V)."""
        x = self.embed(params, token)
        return tf.decode_paged(
            params, self.cfg, x, position, pool_k, pool_v, page_table,
            lengths, write_pages, write_offs, k_scales, v_scales)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
