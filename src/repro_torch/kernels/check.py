"""The tolerance a kernel is held to against its plain version.

Both compute in fp32 from the same inputs and round once to the output's
dtype, so they differ only by the order of their fp32 sums and, for a
bf16 output, by the rounding of two slightly different fp32 values.  Per
element, ``|out - ref|`` may be at most:

- fp32 output: ``1e-4``;
- bf16 output: one bf16 ulp of ``max(|out|, |ref|)`` (two round-to-nearest
  results of nearly equal values are at most one ulp apart), plus
  ``2**-17 * v_absmax`` for the fp32 sums, where ``v_absmax`` bounds the
  values the attention averages (an attention output is a convex
  combination of them).

A limit proportional to each element catches what a flat ``atol`` of the
outputs' own size lets through: a dropped key among ~1.3k moves the
outputs by ~1e-3, several ulps of values of order 0.03.

The SSD chunk kernel has a limit of its own (:func:`ssd_limit`):
``|out - ref| <= 1e-4 + 1e-4 * |ref|`` per element, the tolerance the JAX
package holds its Pallas kernel to (``tests/test_ssd_kernel.py``).  Its
outputs are fp32 sums of up to Q·ds products (8192 at Q 64, ds 128) whose
size grows with the inputs' (order 1-10 at random inputs, the chunk state
more), so their sum-order differences are relative to the value: a flat
1e-4 would fail a correct kernel on the largest elements, while a dropped
key or a wrong decay moves an element by a sizeable share of itself.
"""
from __future__ import annotations

import torch

FP32_ATOL = 1e-4
SUM_ORDER = 2.0 ** -17
SSD_ATOL = 1e-4
SSD_RTOL = 1e-4


def error_limit(out: torch.Tensor, ref: torch.Tensor,
                v_absmax: float) -> torch.Tensor:
    """Per-element fp32 limit on ``|out - ref|`` (see the module doc)."""
    if out.dtype == torch.float32:
        return torch.full(out.shape, FP32_ATOL, device=out.device)
    if out.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {out.dtype}")
    m = torch.maximum(out.float().abs(), ref.float().abs())
    # m = f * 2**e with f in [0.5, 1): bf16 (8 significant bits) ulp 2**(e-8)
    ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m).exponent - 8)
    return torch.where(m > 0, ulp, 0.0) + SUM_ORDER * float(v_absmax)


def ssd_limit(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-element fp32 limit of the SSD chunk kernel (see the module
    doc)."""
    return SSD_ATOL + SSD_RTOL * ref.float().abs()


def compare(out: torch.Tensor, ref: torch.Tensor, v_absmax: float = 0.0,
            rows=None, *, limit=None) -> dict:
    """``max_abs_err``, ``max_abs_ref`` and ``worst`` (the largest
    ``|out - ref| / limit``; the kernel passes iff it is at most 1) over
    the rows selected by the boolean mask ``rows`` (all rows if None).
    ``limit(out, ref)`` gives the per-element limit; by default
    :func:`error_limit` with ``v_absmax``.  A NaN anywhere makes ``worst``
    NaN, which fails ``worst <= 1``."""
    if rows is not None:
        out, ref = out[rows], ref[rows]
    err = (out.float() - ref.float()).abs()
    lim = (error_limit(out, ref, v_absmax) if limit is None
           else limit(out, ref))
    return {"max_abs_err": err.max().item(),
            "max_abs_ref": ref.float().abs().max().item(),
            "worst": (err / lim).max().item()}


def v_absmax(v_pool: torch.Tensor, v_scale=None) -> float:
    """Largest magnitude a value read from ``v_pool`` can have."""
    if v_scale is not None:
        return 128.0 * v_scale.abs().max().item()
    return v_pool.abs().max().item()
