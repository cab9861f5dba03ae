"""Mixture-of-experts FFN with capacity dispatch (port of the JAX package's
``models/moe.py``).

The experts' weights are stacked on a leading axis, ``(E, ·, ·)``, and
dispatch fills an ``(E, C, D)`` capacity buffer, as the reference lays it
out; the three expert products are batched matrix products over it.  A
(token, choice) pair past its expert's capacity is dropped: its gate counts
zero, so the token keeps the shared experts' output (deepseek) or only the
residual (granite, which has none).

Which pairs drop depends on every row the pass carries (``T = B·S``,
padding rows and idle decode slots included), so the routing follows the
reference step for step: fp32 logits (TF32 off for that product on the
card), softmax, top-k with ties to the lower expert index (as
``jax.lax.top_k``), gates renormalised over the k choices, and a pair's
position in its expert's buffer counted over the token-major, choice-minor
order of all pairs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import torch_dtype


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class SharedExperts(nn.Module):
    """deepseek's always-on experts, one SwiGLU of ``d_ff *
    num_shared_experts`` hidden units."""

    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.w_gate = _weight((d, f), dtype, device)
        self.w_up = _weight((d, f), dtype, device)
        self.w_down = _weight((f, d), dtype, device)


class MoE(nn.Module):
    """``router`` (D, E) fp32, ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D) in the parameter dtype, and ``shared`` when the config has
    shared experts."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = _weight((d, e), torch.float32, device)
        self.w_gate = _weight((e, d, f), dtype, device)
        self.w_up = _weight((e, d, f), dtype, device)
        self.w_down = _weight((e, f, d), dtype, device)
        self.shared = (SharedExperts(d, f * cfg.num_shared_experts, dtype,
                                     device)
                       if cfg.num_shared_experts else None)


@contextlib.contextmanager
def _full_fp32():
    """fp32 products in full fp32 on the card (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def capacity(cfg, t: int, capacity_factor: float = 1.25) -> int:
    """Slots per expert for ``t`` routed rows: ``t`` up to 64 rows (no
    pair can drop), else ``int(capacity_factor · k · t / E)``."""
    if t <= 64:
        return t
    return max(1, int(capacity_factor * cfg.experts_per_token * t
                      / cfg.num_experts))


def route(router: torch.Tensor, cfg, xt: torch.Tensor,
          capacity_factor: float = 1.25):
    """Routing of ``xt`` (T, D): ``(probs (T, E), gate_idx (T, k),
    gate_vals (T, k), pos (T, k), keep (T, k), capacity)``.  ``pos`` is a
    pair's place in its expert's buffer, ``keep`` whether it fits."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    with _full_fp32():
        logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: equal values in ascending index order
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(gate_idx, e)                         # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos = ((torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
           * onehot).sum(dim=-1)
    cap = capacity(cfg, t, capacity_factor)
    return probs, gate_idx, gate_vals, pos, pos < cap, cap


def moe_ffn(params: MoE, cfg, x: torch.Tensor, *,
            capacity_factor: float = 1.25):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32 scalar).
    The aux loss is the reference's Switch-style load-balance term;
    serving drops it."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_idx, gate_vals, pos, keep, cap = route(
        params.router, cfg, xt, capacity_factor)

    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * (me * ce).sum()

    # gather dispatch into the (E, C) buffer; column C is the drop bin
    slot = torch.where(keep, pos, cap)
    flat_e, flat_s = gate_idx.reshape(-1), slot.reshape(-1)
    src = torch.zeros((e, cap + 1), dtype=torch.long, device=x.device)
    src[flat_e, flat_s] = torch.arange(
        t, device=x.device).repeat_interleave(k)
    filled = torch.zeros((e, cap + 1), dtype=torch.bool, device=x.device)
    filled[flat_e, flat_s] = True

    cd = torch_dtype(cfg.compute_dtype)
    xe = xt.to(cd)[src[:, :cap]] * filled[:, :cap, None].to(cd)  # (E, C, D)
    h = F.silu(torch.bmm(xe, params.w_gate)) * torch.bmm(xe, params.w_up)
    ye = torch.bmm(h, params.w_down)                             # (E, C, D)

    # combine: each token's k outputs (a dropped pair reads a clamped slot
    # and weighs zero, as the reference's gather does)
    gathered = ye[flat_e, flat_s.clamp(max=cap - 1)].reshape(t, k, d)
    out = (gathered * (gate_vals * keep).to(cd)[..., None]).sum(dim=1)
    if params.shared is not None:
        sp = params.shared
        out = out + (F.silu(xt @ sp.w_gate) * (xt @ sp.w_up)) @ sp.w_down
    return out.reshape(b, s, d).to(x.dtype), aux

