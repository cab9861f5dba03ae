"""Core neural-net primitives: norms, RoPE, SwiGLU, position-masked attention.

Plain functions on tensors, with weights passed explicitly (the layer
modules in :mod:`repro_torch.models.transformer` hold them).  Layouts are
the JAX package's: activations ``(B, S, D)``, heads ``(B, S, H, Dh)``,
weights ``(in, out)`` applied as ``x @ W``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Sentinel position for cache slots that hold no token yet (masked out).
INVALID_POS = torch.iinfo(torch.int32).max


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE, including the MPIC position-relink rotation
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate ``x`` (..., S, H, Dh) by per-token ``positions`` (..., S).

    Half-split rotation: the first and second halves of ``Dh`` form the
    pairs (not interleaved even/odd channels)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_relink(k: torch.Tensor, delta: torch.Tensor, theta: float):
    """Re-rotate cached keys by ``delta`` positions (MPIC linker).

    RoPE rotations compose, K(p + d) = R(d) K(p), so a stored segment
    cached at position 0 moves to offset ``d`` with one elementwise pass.
    """
    return apply_rope(k, delta, theta)


# ---------------------------------------------------------------------------
# attention core: position-masked, cache-agnostic
# ---------------------------------------------------------------------------

def banded_attend(*args, **kwargs):
    """The JAX package's S x 2w band attention for contiguous prefills of
    at least two windows.  Not ported yet: the served model's 8192-token
    window is never reached by a media upload."""
    raise NotImplementedError(
        "banded_attend (contiguous prefill of >= 2 sliding windows) is not "
        "ported yet")


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*n_rep, Dh) for GQA."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def attend(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """Causal attention masked by original token positions.

    q (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh); q_pos (B, Sq); kv_pos
    (B, Skv) with ``INVALID_POS`` for empty slots; ``window`` > 0 keeps
    only keys with ``kv_pos > q_pos - window``.  Logits and the value
    product accumulate in fp32, the probabilities round to the value dtype
    first, as the JAX package does.
    """
    hq, dh = q.shape[2], q.shape[3]
    k = repeat_kv(k, hq // k.shape[2])
    v = repeat_kv(v, hq // v.shape[2])
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kp = kv_pos[:, None, None, :]
    qp = q_pos[:, None, :, None]
    mask = (kp != INVALID_POS) & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention projections and MLP
# ---------------------------------------------------------------------------

def attention_qkv(attn, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x (B,S,D), positions (B,S) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh).

    ``attn`` holds ``wq``/``wk``/``wv`` (in, out)."""
    b, s, _ = x.shape
    q = (x @ attn.wq).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ attn.wk).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ attn.wv).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(wo: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ wo


def swiglu(w_gate, w_up, w_down, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
