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
    shared experts.  A tensor-parallel rank holds the whole router,
    ``experts`` of the routed experts and ``shared_ff`` of the shared
    experts' hidden units (both whole by default)."""

    def __init__(self, cfg, dtype, device, experts: int = 0,
                 shared_ff: int = 0):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        n = experts or e
        self.router = _weight((d, e), torch.float32, device)
        self.w_gate = _weight((n, d, f), dtype, device)
        self.w_up = _weight((n, d, f), dtype, device)
        self.w_down = _weight((n, f, d), dtype, device)
        self.shared = (SharedExperts(
            d, shared_ff or f * cfg.num_shared_experts, dtype, device)
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
            capacity_factor: float = 1.25, sharding=None):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32 scalar).
    The aux loss is the reference's Switch-style load-balance term;
    serving drops it.

    With ``sharding`` (a tensor-parallel rank's plan that cuts the routed
    or the shared experts) every rank routes all ``T`` rows with the whole
    router over the whole ``E``, so the choices, buffer positions and
    drops are the unsharded pass's; the rank fills an ``(E/M, C, D)``
    buffer of the same ``C`` for its own experts, sums its pairs' products
    over the k choices in fp32 (``sharding.expert_partial``), and the
    ranks' sums meet in one fp32 all-reduce, rounded once, as one card's
    sum over the k choices accumulates in fp32 and rounds once.  A cut of
    the shared experts (row-parallel on their hidden units) rides in the
    same all-reduce and rounds as on one card (``sharding.reduce``)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_idx, gate_vals, pos, keep, cap = route(
        params.router, cfg, xt, capacity_factor)

    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx, e).float().sum(dim=1).mean(dim=0)
    aux = e * (me * ce).sum()

    # the rank's experts [lo, lo + n): all of them without a cut
    lo, n = (0, e) if sharding is None else sharding.expert_range
    mine = (gate_idx >= lo) & (gate_idx < lo + n)
    # gather dispatch into the (n, C) buffer; column C is the drop bin,
    # which also takes the pairs of another rank's experts
    slot = torch.where(keep & mine, pos, cap)
    flat_e = (gate_idx - lo).clamp(0, n - 1).reshape(-1)
    flat_s = slot.reshape(-1)
    src = torch.zeros((n, cap + 1), dtype=torch.long, device=x.device)
    src[flat_e, flat_s] = torch.arange(
        t, device=x.device).repeat_interleave(k)
    filled = torch.zeros((n, cap + 1), dtype=torch.bool, device=x.device)
    filled[flat_e, flat_s] = True

    cd = torch_dtype(cfg.compute_dtype)
    xe = xt.to(cd)[src[:, :cap]] * filled[:, :cap, None].to(cd)  # (n, C, D)
    h = F.silu(torch.bmm(xe, params.w_gate)) * torch.bmm(xe, params.w_up)
    ye = torch.bmm(h, params.w_down)                             # (n, C, D)

    # combine: each token's k outputs (a dropped pair reads a clamped slot
    # and weighs zero, as the reference's gather does)
    gathered = ye[flat_e, flat_s.clamp(max=cap - 1)].reshape(t, k, d)
    contrib = gathered * (gate_vals * (keep & mine)).to(cd)[..., None]
    sp = params.shared
    if sharding is None:
        out = contrib.sum(dim=1)
        if sp is not None:
            out = out + (F.silu(xt @ sp.w_gate) * (xt @ sp.w_up)) @ sp.w_down
        return out.reshape(b, s, d).to(x.dtype), aux
    # each part an fp32 partial sum where its experts are cut, else
    # computed whole in the compute dtype as on one card
    whole, partial = {}, {}
    if sharding.experts:
        partial["routed"] = sharding.expert_partial(contrib, gate_idx)
    else:
        whole["routed"] = contrib.sum(dim=1)
    if sp is not None:
        hidden = F.silu(xt @ sp.w_gate) * (xt @ sp.w_up)
        if sharding.mlp:
            partial["shared"] = sharding.partial_product(hidden, sp.w_down)
        else:
            whole["shared"] = hidden @ sp.w_down
    whole.update(zip(partial, sharding.reduce(list(partial.values()), cd)))
    out = whole["routed"]
    if sp is not None:
        out = out + whole["shared"]
    return out.reshape(b, s, d).to(x.dtype), aux

