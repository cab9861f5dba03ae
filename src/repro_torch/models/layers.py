"""Core neural-net primitives: norms, RoPE, SwiGLU and GELU MLPs,
position-masked attention.

Plain functions on tensors, with weights passed explicitly (the layer
modules in :mod:`repro_torch.models.transformer` hold them).  Layouts are
the JAX package's: activations ``(B, S, D)``, heads ``(B, S, H, Dh)``,
weights ``(in, out)`` applied as ``x @ W``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_attn.ops import selective_attention

# Sentinel position for cache slots that hold no token yet (masked out).
INVALID_POS = torch.iinfo(torch.int32).max


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    """fp32 layer norm with the population variance, then scale and
    bias, back in x's dtype."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


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

def banded_attend(q, k, v, positions, window: int):
    """Sliding-window attention of a contiguous sequence over its S x 2w
    band: each query sees at most the previous ``window`` keys, so only
    the keys of its own w-block and the one before count.

    q (B, S, Hq, Dh); k, v (B, S, Hkv, Dh), the sequence's fresh K/V;
    positions (B, S) int32 (``INVALID_POS`` on padding rows).  Requires
    S % window == 0 and S >= 2 * window, as the JAX package's callers
    check.  The function is ``attend(q, k, v, positions, positions,
    window=window)``; it runs as one call of the dense selective-attention
    dispatcher with ``kv_pos = positions``, whose kernel leaves out every
    tile of keys that no query of a block can see, so the work is the
    band's."""
    s = q.shape[1]
    if not (window > 0 and s % window == 0 and s >= 2 * window
            and k.shape[1] == s and v.shape[1] == s):
        raise ValueError(
            f"banded_attend: needs S % w == 0 and S >= 2w over the "
            f"sequence's own K/V; got S {s}, w {window}, Skv {k.shape[1]}")
    return selective_attention(q, k, v, positions, positions, window=window)


def banded_attend_train(q, k, v, positions, window: int):
    """The training pass's counterpart of :func:`banded_attend`, the JAX
    package's jnp ``banded_attend``: the sequence cut into S/w query
    blocks, block i attending through :func:`attend` to the keys of
    blocks i-1 and i (2w keys, the first block's earlier half empty), so
    the logits are the S x 2w band's.  Differentiable; it calls no kernel.
    Same arguments and requirements as :func:`banded_attend`."""
    b, s, hq, dh = q.shape
    if not (window > 0 and s % window == 0 and s >= 2 * window):
        raise ValueError(f"banded_attend_train: needs S % w == 0 and "
                         f"S >= 2w; got S {s}, w {window}")
    nb = s // window

    def band(x):                    # (B, S, ...) -> (B*nb, 2w, ...)
        xr = x.reshape(b, nb, window, *x.shape[2:])
        prev = torch.cat([torch.zeros_like(xr[:, :1]), xr[:, :-1]], 1)
        return torch.cat([prev, xr], 2).flatten(0, 1)

    qp = positions.reshape(b, nb, window)
    kp = torch.cat([torch.full_like(qp[:, :1], INVALID_POS), qp[:, :-1]], 1)
    kp = torch.cat([kp, qp], 2).flatten(0, 1)
    o = attend(q.reshape(b * nb, window, hq, dh), band(k), band(v),
               qp.flatten(0, 1), kp, window=window)
    return o.reshape(b, s, hq, dh)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*n_rep, Dh) for GQA."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def attend(q, k, v, q_pos, kv_pos, *, window: int = 0,
           bidirectional: bool = False):
    """Causal attention masked by original token positions.

    q (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh); q_pos (B, Sq); kv_pos
    (B, Skv) with ``INVALID_POS`` for empty slots; ``window`` > 0 keeps
    only keys with ``kv_pos > q_pos - window``; ``bidirectional`` keeps
    every valid key (the encoder, cross attention).  Logits and the value
    product accumulate in fp32, the probabilities round to the value dtype
    first, as the JAX package does.  Differentiable: the training forward
    runs on it.
    """
    hq, dh = q.shape[2], q.shape[3]
    k = repeat_kv(k, hq // k.shape[2])
    v = repeat_kv(v, hq // v.shape[2])
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kp = kv_pos[:, None, None, :]
    qp = q_pos[:, None, :, None]
    mask = kp != INVALID_POS
    if not bidirectional:
        mask = mask & (kp <= qp)
        if window > 0:
            mask = mask & (kp > qp - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention projections and MLP
# ---------------------------------------------------------------------------

def attention_qkv(attn, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                  rope: bool = True):
    """x (B,S,D), positions (B,S) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh).

    ``attn`` holds ``wq``/``wk``/``wv`` (in, out) and, with
    ``cfg.qkv_bias``, ``bq``/``bk``/``bv``, added before RoPE (so a relink
    rotates the biased K exactly).  No RoPE with ``rope=False`` (the
    encoder) or learned positions (``cfg.learned_pos_emb``)."""
    b, s, _ = x.shape
    q, k, v = x @ attn.wq, x @ attn.wk, x @ attn.wv
    if cfg.qkv_bias:
        q, k, v = q + attn.bq, k + attn.bk, v + attn.bv
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if rope and not cfg.learned_pos_emb:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(wo: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ wo


def swiglu(w_gate, w_up, w_down, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(w_up, b_up, w_down, b_down, x: torch.Tensor) -> torch.Tensor:
    """whisper's MLP: the tanh GELU (``jax.nn.gelu``'s default), biases
    on both projections."""
    h = F.gelu(x @ w_up + b_up, approximate="tanh")
    return h @ w_down + b_down
