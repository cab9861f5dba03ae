"""Plain PyTorch version of the SSD intra-chunk step (mirror of the JAX
package's ``kernels/ssd_chunk/ref.py``).

Per (batch, chunk, head), given the chunk's inputs

  x   (Q, hd)   conv'd inputs
  bm  (Q, ds)   input projection (shared by the heads)
  cm  (Q, ds)   output projection (shared by the heads)
  la  (Q,)      log decay (negative)
  dt  (Q,)      discretization step

it gives

  y_intra (Q, hd)  = (L ∘ C Bᵀ) · (dt · X)                 intra-chunk output
  s_c     (ds, hd) = Σ_q exp(total − cum_q)·dt_q·B_q ⊗ X_q   chunk state
  a_c     ()       = exp(total)                            chunk decay

with ``cum = cumsum(la)``, ``total = cum[-1]`` and
``L[q, k] = exp(cum_q − cum_k)`` for ``k <= q``.  The entries ``k > q`` are
selected away (``torch.where``) as the Pallas kernel does, where the JAX
oracle multiplies by a lower-triangular mask: the two agree wherever the
oracle is finite, and a large ``dt``, whose masked ``exp`` overflows, gives
``inf · 0 = NaN`` only in the oracle.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(x, bm, cm, la, dt):
    """x (B,NC,H,Q,hd), bm/cm (B,NC,Q,ds), la/dt (B,NC,H,Q), fp32.

    Returns y_intra (B,NC,H,Q,hd), s_c (B,NC,H,ds,hd), a_c (B,NC,H)."""
    q = x.shape[-2]
    cum = torch.cumsum(la, dim=-1)                          # (B,NC,H,Q)
    cb = torch.einsum("bnqs,bnks->bnqk", cm, bm)            # (B,NC,Q,Q)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril()
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    scores = torch.where(causal, cb[:, :, None] * torch.exp(diff)
                         * dt[..., None, :], 0.0)            # (B,NC,H,Q,Q)
    y_intra = torch.einsum("bnhqk,bnhkd->bnhqd", scores, x)
    total = cum[..., -1]                                    # (B,NC,H)
    wgt = torch.exp(total[..., None] - cum) * dt            # (B,NC,H,Q)
    s_c = torch.einsum("bnqs,bnhq,bnhqd->bnhsd", bm, wgt, x)
    return y_intra, s_c, torch.exp(total)
