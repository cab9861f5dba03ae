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
from repro_torch.models.layers import INVALID_POS


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if cfg.arch_type == "audio":
        unsupported.append(f"arch_type={cfg.arch_type!r}")
    if cfg.hybrid != (cfg.arch_type == "hybrid"):
        unsupported.append(f"hybrid={cfg.hybrid} with "
                           f"arch_type={cfg.arch_type!r}")
    if cfg.is_encoder_decoder:
        unsupported.append("encoder-decoder")
    if cfg.learned_pos_emb:
        unsupported.append("learned_pos_emb")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(unsupported)}); the "
            "port serves attention-only models with RoPE (dense or MoE "
            "FFNs), the pure SSM and the attention + SSM hybrid")


def _pad_right(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, ...) -> (B, S + pad, ...), zeros (False) appended."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)


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

    def chunk_pad(self, s: int) -> int:
        """Steps that pad ``s`` tokens to a multiple of ``ssm_chunk`` for
        a model with SSM heads (0 for one without)."""
        if self.cfg.attn_free or self.cfg.hybrid:
            return (-s) % self.cfg.ssm_chunk
        return 0

    def forward(self, params, tokens, media_embeds=None, media_mask=None):
        """Logits (B, S, V) fp32 of a contiguous sequence from position 0,
        with no cache (the JAX package's ``Model.forward`` without the
        loss): an SSM or a hybrid pads to ``ssm_chunk`` with token 0, whose
        rows come after every real one and are cut off."""
        s = tokens.shape[1]
        pad = self.chunk_pad(s)
        if pad:
            tokens = _pad_right(tokens, pad)
            if media_embeds is not None:
                media_embeds = _pad_right(media_embeds, pad)
                media_mask = _pad_right(media_mask, pad)
        x = self.embed(params, tokens, media_embeds, media_mask)
        return tf.forward(params, self.cfg, x)[:, :s]

    # -- serving ------------------------------------------------------------
    def make_cache(self, batch: int, kv_len: int, *, device=None) -> dict:
        """Empty dense cache on ``device`` (None means the card); see
        :func:`repro_torch.models.transformer.make_cache`."""
        return tf.make_cache(self.cfg, batch, kv_len, device=device)

    def prefill(self, params, tokens, cache, *, media_embeds=None,
                media_mask=None, positions=None, write_idx=None):
        """Prefill ``tokens`` (B, S) into ``cache``, in place; contiguous
        from position 0 unless ``positions``/``write_idx`` (B, S) int32 say
        otherwise.  Returns (logits (B, S, V), cache).

        An SSM or a hybrid needs S to be a multiple of ``ssm_chunk``: the
        tokens are right-padded with steps that ``ssm_mask`` (0 on the
        pads) makes no-ops (dt = 0: the state neither decays nor absorbs
        input), the conv state's tail starts at S - (W-1), and the logits
        are cut back to S.  A hybrid's pads carry ``INVALID_POS``, so no
        query sees their K/V, which go to the scratch slot ``kv_len - 1``
        as in the JAX package; a contiguous prefill whose scratch slot
        would be one of its own tokens' raises (give the cache a slot
        more)."""
        b, s = tokens.shape
        contiguous = positions is None and write_idx is None
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).repeat(b, 1)
        if write_idx is None:
            write_idx = positions
        ssm_mask = ssm_tail = None
        pad = self.chunk_pad(s)
        if pad:
            tokens = _pad_right(tokens, pad)
            if media_embeds is not None:
                media_embeds = _pad_right(media_embeds, pad)
                media_mask = _pad_right(media_mask, pad)
            if "pos" in cache:
                kv_len = cache["pos"].shape[1]
                if contiguous and kv_len <= s:
                    raise ValueError(
                        f"{self.cfg.name}: a prefill of {s} tokens padded to "
                        f"the SSD chunk needs a scratch slot past them; the "
                        f"cache has {kv_len}")
                positions = torch.cat([positions, positions.new_full(
                    (b, pad), INVALID_POS)], 1)
                write_idx = torch.cat([write_idx, write_idx.new_full(
                    (b, pad), kv_len - 1)], 1)
        if self.cfg.attn_free or self.cfg.hybrid:
            ssm_mask = (torch.arange(s + pad, device=tokens.device)
                        < s).float()[None].expand(b, s + pad)
            ssm_tail = torch.full((b,), s - (self.cfg.ssm_conv_width - 1),
                                  dtype=torch.int32, device=tokens.device)
        x = self.embed(params, tokens, media_embeds, media_mask)
        logits, cache = tf.forward_with_cache(
            params, self.cfg, x, positions, cache, write_idx,
            contiguous=contiguous, ssm_mask=ssm_mask, ssm_tail_start=ssm_tail)
        return (logits[:, :s] if pad else logits), cache

    def _needs_attention(self, what: str) -> None:
        if self.cfg.arch_type == "ssm":
            raise ValueError(f"{what} needs attention KV; {self.cfg.name} "
                             "is attention-free")

    def selective_prefill(self, params, sel_tokens, sel_positions, cache,
                          write_idx, *, media_embeds=None, media_mask=None):
        """MPIC selective-attention prefill (single step) against a linked
        dense cache: reused segment KV already placed, dummy (zero, invalid)
        KV in the selected slots, which the recomputed tokens' K/V fill
        inside this one pass.  Returns (logits (B, Sq, V), cache)."""
        self._needs_attention("selective prefill")
        x = self.embed(params, sel_tokens, media_embeds, media_mask)
        return tf.forward_with_cache(params, self.cfg, x, sel_positions,
                                     cache, write_idx)

    def decode_step(self, params, token, position, cache, write_idx):
        """One decode step against a dense cache.  token, position and
        write_idx (B, 1).  Returns (logits (B, V), cache)."""
        x = self.embed(params, token)
        logits, cache = tf.forward_with_cache(params, self.cfg, x, position,
                                              cache, write_idx)
        return logits[:, -1, :], cache

    def supports_paged_prefill(self) -> bool:
        return self.supports_paged_decode()

    def supports_paged_decode(self) -> bool:
        """Paged decode covers pure-attention KV caches; an SSM and a
        hybrid keep the dense decode path (their state is no KV).  The JAX
        predicate also excludes encoder-decoder models, which the port does
        not accept."""
        return not (self.cfg.attn_free or self.cfg.hybrid)

    def selective_prefill_paged(self, params, sel_tokens, sel_positions,
                                pool_k, pool_v, page_table, lengths,
                                write_pages, write_offs, k_scales=None,
                                v_scales=None, *, media_embeds=None,
                                media_mask=None) -> torch.Tensor:
        """MPIC selective prefill against the page pool, written in place.
        See :func:`repro_torch.models.transformer.selective_prefill_paged`.
        Returns logits (B, Sq, V)."""
        self._needs_attention("selective prefill")
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
