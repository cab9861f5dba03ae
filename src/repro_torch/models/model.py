"""Public model facade (port of the JAX package's ``models/model.py``):
the serving passes, whisper's encoder, and the training loss.

``Model`` holds the config; the parameters are a
:class:`~repro_torch.models.transformer.Transformer` module passed to each
call as ``params``, as the JAX facade takes its parameter pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import INVALID_POS


def _check_supported(cfg: ModelConfig) -> None:
    """The port builds the families the JAX package's configs use: an
    audio model is whisper's encoder-decoder with learned positions, and
    only it has an encoder or learned positions."""
    unsupported = []
    if cfg.hybrid != (cfg.arch_type == "hybrid"):
        unsupported.append(f"hybrid={cfg.hybrid} with "
                           f"arch_type={cfg.arch_type!r}")
    audio = cfg.arch_type == "audio"
    if audio != cfg.is_encoder_decoder:
        unsupported.append(f"is_encoder_decoder={cfg.is_encoder_decoder} "
                           f"with arch_type={cfg.arch_type!r}")
    if audio != cfg.learned_pos_emb:
        unsupported.append(f"learned_pos_emb={cfg.learned_pos_emb} "
                           f"with arch_type={cfg.arch_type!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet ({', '.join(unsupported)}); the "
            "port serves attention-only models with RoPE (dense or MoE "
            "FFNs), the pure SSM, the attention + SSM hybrid and the audio "
            "encoder-decoder with learned positions")


def _pad_right(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, ...) -> (B, S + pad, ...), zeros (False) appended."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)


@dataclasses.dataclass(frozen=True)
class Model:
    """On a tensor-parallel rank ``cfg`` is the rank's local config,
    ``widths`` (``launch.specs.Widths``) the widths it cannot carry (the
    rank's SSD heads size its dense cache's SSM state), and the plan rides
    on the parameters (``params.sharding``)."""
    cfg: ModelConfig
    widths: Optional[object] = None

    def __post_init__(self):
        _check_supported(self.cfg)

    def init(self, *, seed: int = 0, device=None) -> tf.Transformer:
        return tf.init_params(self.cfg, seed=seed, device=device)

    def embed(self, params, tokens, media_embeds=None, media_mask=None,
              positions=None):
        """Token embeddings, media embeddings where ``media_mask`` is set,
        and whisper's learned positions (``positions`` (B, S), 0..S-1 by
        default)."""
        x = tf.embed_tokens(params, self.cfg, tokens, media_embeds,
                            media_mask)
        if self.cfg.learned_pos_emb:
            if positions is None:
                x = x + params.pos_embed[:tokens.shape[1]][None]
            else:
                x = x + params.pos_embed[positions.long()]
        return x

    # -- training -----------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token NLL over the labels >= 0 of ``batch`` (a dict of
        tensors: ``tokens``, ``labels`` (B, S), optionally ``media_embeds``
        / ``media_mask`` and whisper's ``audio_embeds``), plus a MoE's aux
        term ``router_aux_loss_coef * aux / L``; a differentiable fp32
        scalar (see :func:`repro_torch.models.transformer.forward_train`).
        """
        logits, aux = tf.forward_train(
            params, self.cfg, batch["tokens"],
            media_embeds=batch.get("media_embeds"),
            media_mask=batch.get("media_mask"),
            audio_embeds=batch.get("audio_embeds"))
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        if self.cfg.arch_type == "moe":
            loss = loss + self.cfg.router_aux_loss_coef * aux / max(
                self.cfg.num_layers, 1)
        return loss

    def chunk_pad(self, s: int) -> int:
        """Steps that pad ``s`` tokens to a multiple of ``ssm_chunk`` for
        a model with SSM heads (0 for one without)."""
        if self.cfg.attn_free or self.cfg.hybrid:
            return (-s) % self.cfg.ssm_chunk
        return 0

    def forward(self, params, tokens, media_embeds=None, media_mask=None,
                audio_embeds=None):
        """Logits (B, S, V) fp32 of a contiguous sequence from position 0,
        with no cache (the JAX package's ``Model.forward`` without the
        loss): an SSM or a hybrid pads to ``ssm_chunk`` with token 0, whose
        rows come after every real one and are cut off.  whisper's decoder
        attends to the encoding of ``audio_embeds`` (B, Senc, D)."""
        s = tokens.shape[1]
        pad = self.chunk_pad(s)
        if pad:
            tokens = _pad_right(tokens, pad)
            if media_embeds is not None:
                media_embeds = _pad_right(media_embeds, pad)
                media_mask = _pad_right(media_mask, pad)
        x = self.embed(params, tokens, media_embeds, media_mask)
        cross_kv = None
        if self.cfg.is_encoder_decoder:
            cross_kv = self.cross_kv(params,
                                     self.encode_audio(params, audio_embeds))
        return tf.forward(params, self.cfg, x, cross_kv)[:, :s]

    # -- serving ------------------------------------------------------------
    def make_cache(self, batch: int, kv_len: int, *, device=None) -> dict:
        """Empty dense cache on ``device`` (None means the card); see
        :func:`repro_torch.models.transformer.make_cache`."""
        return tf.make_cache(self.cfg, batch, kv_len, device=device,
                             ssm_heads=self.widths.ssm_heads
                             if self.widths is not None else 0)

    def prefill(self, params, tokens, cache, *, media_embeds=None,
                media_mask=None, positions=None, write_idx=None,
                audio_embeds=None, logits: bool = True):
        """Prefill ``tokens`` (B, S) into ``cache``, in place; contiguous
        from position 0 unless ``positions``/``write_idx`` (B, S) int32 say
        otherwise.  Returns (logits (B, S, V), cache).  An encoder-decoder
        given ``audio_embeds`` (B, Senc, D) encodes them first and puts
        their cross K/V into the cache (``cross_k``/``cross_v``); without,
        it attends to the cross K/V the cache holds.

        An SSM or a hybrid needs S to be a multiple of ``ssm_chunk``: the
        tokens are right-padded with steps that ``ssm_mask`` (0 on the
        pads) makes no-ops (dt = 0: the state neither decays nor absorbs
        input), the conv state's tail starts at S - (W-1), and the logits
        are cut back to S.  A hybrid's pads carry ``INVALID_POS``, so no
        query sees their K/V, which go to the scratch slot ``kv_len - 1``
        as in the JAX package; a contiguous prefill whose scratch slot
        would be one of its own tokens' raises (give the cache a slot
        more).  ``logits=False`` skips the head and returns None for the
        logits (an upload keeps only the cache)."""
        b, s = tokens.shape
        contiguous = positions is None and write_idx is None
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).repeat(b, 1)
        if write_idx is None:
            write_idx = positions
        if self.cfg.is_encoder_decoder and audio_embeds is not None:
            cache["cross_k"], cache["cross_v"] = self.cross_kv(
                params, self.encode_audio(params, audio_embeds))
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
        x = self.embed(params, tokens, media_embeds, media_mask, positions)
        out, cache = tf.forward_with_cache(
            params, self.cfg, x, positions, cache, write_idx,
            contiguous=contiguous, ssm_mask=ssm_mask, ssm_tail_start=ssm_tail,
            logits=logits)
        return (out[:, :s] if pad and logits else out), cache

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
        x = self.embed(params, sel_tokens, media_embeds, media_mask,
                       sel_positions)
        return tf.forward_with_cache(params, self.cfg, x, sel_positions,
                                     cache, write_idx)

    def decode_step(self, params, token, position, cache, write_idx):
        """One decode step against a dense cache.  token, position and
        write_idx (B, 1).  Returns (logits (B, V), cache)."""
        x = self.embed(params, token, positions=position)
        logits, cache = tf.forward_with_cache(params, self.cfg, x, position,
                                              cache, write_idx)
        return logits[:, -1, :], cache

    def supports_paged_prefill(self) -> bool:
        return self.supports_paged_decode()

    def supports_paged_decode(self) -> bool:
        """Paged decode covers pure-attention KV caches; an SSM and a
        hybrid keep the dense decode path (their state is no KV), and so
        does an encoder-decoder (its cross K/V live in the dense cache)."""
        cfg = self.cfg
        return not (cfg.attn_free or cfg.hybrid or cfg.is_encoder_decoder)

    def selective_prefill_paged(self, params, sel_tokens, sel_positions,
                                pool_k, pool_v, page_table, lengths,
                                write_pages, write_offs, k_scales=None,
                                v_scales=None, *, media_embeds=None,
                                media_mask=None) -> torch.Tensor:
        """MPIC selective prefill against the page pool, written in place.
        See :func:`repro_torch.models.transformer.selective_prefill_paged`.
        Returns logits (B, Sq, V)."""
        self._needs_attention("selective prefill")
        x = self.embed(params, sel_tokens, media_embeds, media_mask,
                       sel_positions)
        return tf.selective_prefill_paged(
            params, self.cfg, x, sel_positions, pool_k, pool_v, page_table,
            lengths, write_pages, write_offs, k_scales, v_scales)

    def decode_step_paged(self, params, token, position, pool_k, pool_v,
                          page_table, lengths, write_pages, write_offs,
                          k_scales=None, v_scales=None) -> torch.Tensor:
        """One decode step against the page pool, written in place.  See
        :func:`repro_torch.models.transformer.decode_paged`.  Returns
        logits (B, V)."""
        x = self.embed(params, token, positions=position)
        return tf.decode_paged(
            params, self.cfg, x, position, pool_k, pool_v, page_table,
            lengths, write_pages, write_offs, k_scales, v_scales)

    # -- whisper ---------------------------------------------------------------
    def encode_audio(self, params, audio_embeds) -> torch.Tensor:
        """The encoder's output (B, Senc, D); see
        :func:`repro_torch.models.transformer.encode`."""
        return tf.encode(params, self.cfg, audio_embeds)

    def cross_kv(self, params, enc_out):
        """(cross_k, cross_v), each (L, B, Senc, Hkv, Dh); see
        :func:`repro_torch.models.transformer.compute_cross_kv`."""
        return tf.compute_cross_kv(params, self.cfg, enc_out)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
