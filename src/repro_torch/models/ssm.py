"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060] (port of the
JAX package's ``models/ssm.py``).

The chunked SSD algorithm: the intra-chunk terms of every chunk (the
quadratic output term, the chunk's state contribution and its decay) come
from one call of the ``ssd_chunk`` dispatcher, which launches the CUDA
kernel on the card; only the O(T/chunk) inter-chunk composition
``H_c = a_c · H_{c-1} + S_c`` stays in PyTorch, a loop over the chunks (the
JAX package runs it as an associative scan).  B and C are shared by the
heads.

Training differentiates :func:`ssd_chunked_train` instead, the
counterpart of the jnp ``ssd_chunked`` that the JAX trainer
differentiates: the kernel has no backward, so the training pass calls
neither it nor its plain version.

State caches (decode), per layer:
  ssd state  (B, H, ds, hd) fp32  the recurrent summary
  conv state (B, W-1, di)         the causal conv's input tail
MPIC does not apply here: the state depends on the whole prefix.

Tensor parallelism: a rank's :class:`SSM` holds its SSD heads (``heads``
of them, and their ``heads x ssm_head_dim`` channels: each half of
``in_proj``'s ``[x | z]``, ``dt_proj``'s columns, ``dt_bias``, ``A_log``,
``D``, the conv and ``out_norm``) and the whole ``bc_proj``; the passes
read those widths from the parameters' shapes, and with the rank's plan
(``sharding``) ``out_norm`` normalises over every rank's channels and
``out_proj`` ends in a row-parallel sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from repro_torch.models.layers import rmsnorm


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class SSM(nn.Module):
    """The leaves of the JAX package's ``init_ssm``, in its layout:
    projections ``(in, out)`` in the parameter dtype; ``dt_bias``,
    ``A_log`` and ``D`` always fp32."""

    def __init__(self, cfg, dtype, device, heads: int = 0):
        super().__init__()
        nh = heads or cfg.ssm_num_heads
        d, di, ds = cfg.d_model, nh * cfg.ssm_head_dim, cfg.ssm_state
        w = cfg.ssm_conv_width

        def empty(*shape, dt=dtype):
            return _param(torch.empty(shape, dtype=dt, device=device))

        self.in_proj = empty(d, 2 * di)          # x, z
        self.bc_proj = empty(d, 2 * ds)          # B, C
        self.dt_proj = empty(d, nh)
        self.dt_bias = empty(nh, dt=torch.float32)
        self.conv_w = empty(w, di)
        self.conv_b = _param(torch.zeros(di, dtype=dtype, device=device))
        self.A_log = empty(nh, dt=torch.float32)
        self.D = empty(nh, dt=torch.float32)
        self.out_norm = _param(torch.ones(di, dtype=dtype, device=device))
        self.out_proj = empty(di, d)


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv, summed tap by tap in x's dtype, then SiLU.
    x (B, T, di), w (W, di); tail (B, W-1, di) or zeros."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)         # (B, T+W-1, di)
    t = x.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + t, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x, bm, cm, log_a, dtv, h0):
    """Chunked SSD core, fp32.

    x     (B, NC, Q, H, hd)   inputs (already conv'd and activated)
    bm/cm (B, NC, Q, ds)      input/output projections (shared by heads)
    log_a (B, NC, Q, H)       per-step log decay (negative)
    dtv   (B, NC, Q, H)       discretization step
    h0    (B, H, ds, hd)      incoming state
    returns y (B, NC, Q, H, hd), h_final (B, H, ds, hd)

    The dispatcher reads x, log_a and dtv in place through permuted views
    (its contract layout is (B, NC, H, Q, .)).
    """
    nc = x.shape[1]
    y_intra, s_c, a_c = ssd_chunk(x.permute(0, 1, 3, 2, 4), bm, cm,
                                  log_a.permute(0, 1, 3, 2),
                                  dtv.permute(0, 1, 3, 2))
    # the state entering each chunk: H_c = a_c · H_{c-1} + S_c
    h = h0
    h_in = torch.empty_like(s_c)                          # (B, NC, H, ds, hd)
    for c in range(nc):
        h_in[:, c] = h
        h = torch.addcmul(s_c[:, c], a_c[:, c, :, None, None], h)
    cum = torch.cumsum(log_a, dim=2)                      # (B, NC, Q, H)
    y_inter = torch.einsum("bnqs,bnhsd->bnqhd", cm, h_in) \
        * torch.exp(cum)[..., None]
    return y_intra.permute(0, 1, 3, 2, 4) + y_inter, h


def ssd_chunked_train(x, bm, cm, log_a, dtv, h0):
    """The chunked SSD core of the training pass, fp32 and differentiable:
    the arguments and results of :func:`ssd_chunked`.

    The intra-chunk terms are batched products over the chunk axis, as in
    the JAX package's jnp ``ssd_chunked``; the chunk states compose in a
    loop over the chunks that stacks them (no buffer written in place).
    The causal mask selects with ``torch.where`` before the exponent where
    the reference multiplies by a lower-triangular mask: a masked pair's
    exponent ``cum_q - cum_k`` is positive and overflows at a large dt,
    which gives the reference inf * 0 = NaN.  Both agree, values and
    gradients, wherever the reference's are finite."""
    q = x.shape[2]
    cum = torch.cumsum(log_a, dim=2)                      # (B, NC, Q, H)
    # intra-chunk: (L o C B^T) . (dt X)
    cb = torch.einsum("bnqs,bnks->bnqk", cm, bm)          # (B, NC, Q, Q)
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, NC, Q, K, H)
    decay = torch.exp(torch.where(tril[None, None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
    scores = cb[..., None] * decay * dtv[:, :, None, :, :]
    y_intra = torch.einsum("bnqkh,bnkhd->bnqhd", scores, x)
    # each chunk's state contribution and decay
    total = cum[:, :, -1, :]                              # (B, NC, H)
    wgt = torch.exp(total[:, :, None, :] - cum) * dtv     # (B, NC, Q, H)
    s_c = torch.einsum("bnqs,bnqh,bnqhd->bnhsd", bm, wgt, x)
    a_c = torch.exp(total)
    # the state entering each chunk: H_c = a_c . H_{c-1} + S_c
    h, h_in = h0, []
    for c in range(x.shape[1]):
        h_in.append(h)
        h = a_c[:, c, :, None, None] * h + s_c[:, c]
    y_inter = torch.einsum("bnqs,bnhsd->bnqhd", cm, torch.stack(h_in, 1)) \
        * torch.exp(cum)[..., None]
    return y_intra + y_inter, h


def _widths(params: SSM, cfg):
    """(channels, heads, head dim) of ``params``: the model's, or a
    tensor-parallel rank's."""
    nh = params.A_log.shape[0]
    return nh * cfg.ssm_head_dim, nh, cfg.ssm_head_dim


def _out(params: SSM, cfg, y, z, sharding):
    """The gated ``out_norm`` and ``out_proj``; a rank's channels normed
    over every rank's and its partial product summed."""
    g = F.silu(z)
    if sharding is None:
        return (rmsnorm(params.out_norm, y) * g) @ params.out_proj
    return sharding.row_parallel(
        sharding.rms_norm(params.out_norm, y, cfg.ssm_inner) * g,
        params.out_proj)


def ssm_forward(params: SSM, cfg, x, state=None, dt_mask=None,
                tail_start=None, *, train: bool = False, sharding=None):
    """Full-sequence (prefill, or with ``train`` training) SSD pass.

    x (B, T, D) with T a multiple of ``cfg.ssm_chunk`` (the caller pads; a
    training sequence is not padded, and a multiple is required as the
    JAX package asserts it).  ``train`` runs :func:`ssd_chunked_train`, the
    differentiable core, where serving runs :func:`ssd_chunked` (the
    kernel).
    dt_mask (B, T): 0 on padding steps, which forces dt = 0 there (the
    state neither decays nor absorbs input) and zeroes their conv input.
    tail_start (B,): per-row start of the last W-1 real inputs, the decode
    conv state (default T-(W-1)), clamped at 0.
    ``sharding``: a tensor-parallel rank's plan, where its SSD heads are
    cut (``params`` its shard).
    Returns (out (B, T, D), new state {"h", "conv"}).
    """
    b, t, _ = x.shape
    ds, q = cfg.ssm_state, cfg.ssm_chunk
    di, nh, hd = _widths(params, cfg)
    if t % q:
        raise ValueError(f"seq {t} not divisible by ssm_chunk {q}")
    nc = t // q

    xin, z = torch.chunk(x @ params.in_proj, 2, dim=-1)
    if dt_mask is not None:
        xin = xin * dt_mask[..., None].to(xin.dtype)
    conv_tail = None if state is None else state["conv"]
    xc = _causal_conv(xin, params.conv_w, params.conv_b, conv_tail)

    bm, cm = torch.chunk((x @ params.bc_proj).float(), 2, dim=-1)
    dtv = F.softplus((x @ params.dt_proj).float() + params.dt_bias)
    if dt_mask is not None:
        dtv = dtv * dt_mask[..., None]
    log_a = -torch.exp(params.A_log) * dtv                 # (B, T, nh)

    xh = xc.float().reshape(b, nc, q, nh, hd)
    h0 = (torch.zeros((b, nh, ds, hd), dtype=torch.float32, device=x.device)
          if state is None else state["h"].float())
    core = ssd_chunked_train if train else ssd_chunked
    y, h_final = core(
        xh, bm.reshape(b, nc, q, ds), cm.reshape(b, nc, q, ds),
        log_a.reshape(b, nc, q, nh), dtv.reshape(b, nc, q, nh), h0)
    y = y + params.D[:, None] * xh
    y = y.reshape(b, t, di).to(x.dtype)

    out = _out(params, cfg, y, z, sharding)
    w1 = cfg.ssm_conv_width - 1
    if tail_start is None:
        conv_state = xin[:, t - w1:, :]
    else:
        # a clamped per-row slice, as jax.lax.dynamic_slice_in_dim takes it
        start = tail_start.long().clamp(0, t - w1)
        idx = start[:, None] + torch.arange(w1, device=x.device)
        conv_state = xin[torch.arange(b, device=x.device)[:, None], idx]
    return out, {"h": h_final, "conv": conv_state}


def ssm_decode(params: SSM, cfg, x, state, *, sharding=None):
    """One decode step.  x (B, 1, D); state {"h", "conv"} -> (out, state);
    ``sharding`` as in :func:`ssm_forward`."""
    b = x.shape[0]
    di, nh, hd = _widths(params, cfg)

    xin, z = torch.chunk(x @ params.in_proj, 2, dim=-1)    # (B, 1, di)
    buf = torch.cat([state["conv"].to(xin.dtype), xin], dim=1)  # (B, W, di)
    xc = F.silu(torch.einsum("bwd,wd->bd", buf, params.conv_w)
                + params.conv_b)[:, None, :]               # (B, 1, di)

    bm, cm = torch.chunk((x @ params.bc_proj).float()[:, 0], 2, dim=-1)
    dtv = F.softplus((x @ params.dt_proj).float()[:, 0] + params.dt_bias)
    a = torch.exp(-torch.exp(params.A_log) * dtv)          # (B, nh)

    xh = xc.float().reshape(b, nh, hd)
    h = state["h"].float()
    h = a[:, :, None, None] * h + torch.einsum("bs,bh,bhd->bhsd", bm, dtv, xh)
    y = torch.einsum("bs,bhsd->bhd", cm, h) + params.D[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)

    out = _out(params, cfg, y, z, sharding)
    return out, {"h": h, "conv": buf[:, 1:, :]}


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device=None,
                   heads: int = 0) -> dict:
    """Zero state for ``batch`` rows at ``heads`` SSD heads (a
    tensor-parallel rank's; the model's by default)."""
    nh = heads or cfg.ssm_num_heads
    return {
        "h": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_head_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             nh * cfg.ssm_head_dim), dtype=dtype,
                            device=device),
    }
