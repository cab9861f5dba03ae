"""AdamW and a cosine schedule with warmup (port of the JAX package's
``training/optimizer.py``, its own algorithm rather than
``torch.optim.AdamW``).

The API is the reference's functional one, on named tensors:
``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``, then :func:`apply_updates` adds the updates.  ``params`` is a
:class:`~repro_torch.models.transformer.Transformer` or a mapping from
names to tensors; ``grads`` a mapping with the same names.  The moments
are fp32 whatever the parameter dtype (mixed-precision training); the
gradients are clipped to a global norm first; the decoupled weight decay
applies to tensors of two or more dimensions only; each update is cast to
its parameter's dtype and then added.  The update runs tensor by tensor,
so it needs one parameter's fp32 temporaries at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Union

import numpy as np
import torch


def _named(tensors) -> Dict[str, torch.Tensor]:
    if isinstance(tensors, torch.nn.Module):
        return dict(tensors.named_parameters())
    return dict(tensors)


class AdamWState(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in _named(params).items()}
        return AdamWState(0, mu, {n: m.clone() for n, m in mu.items()})

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) \
            else float(np.float32(self.lr))

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params):
        params = _named(params)
        step = state.step + 1
        if self.grad_clip > 0:
            # global-norm clip; the scale stays on the device
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = None
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(step))
        bc2 = float(f32(1) - f32(self.b2) ** f32(step))
        lr = self._lr(step)
        decay = float(f32(lr) * f32(self.weight_decay))
        updates, mu, nu = {}, {}, {}
        for name, p in params.items():
            g = grads[name].float()
            if scale is not None:
                g = g * scale
            m = self.b1 * state.mu[name] + (1 - self.b1) * g
            n = self.b2 * state.nu[name] + (1 - self.b2) * g * g
            u = -(lr * (m / bc1) / (torch.sqrt(n / bc2) + self.eps))
            if p.ndim >= 2:         # decoupled weight decay on matrices only
                u = u - decay * p.float()
            updates[name] = u.to(p.dtype)
            mu[name], nu[name] = m, n
        return updates, AdamWState(step, mu, nu)


@torch.no_grad()
def apply_updates(params, updates: Mapping[str, torch.Tensor]):
    """Add each update to its parameter, in place (the reference returns
    new arrays from a donated jit); returns ``params``."""
    for name, p in _named(params).items():
        p.add_(updates[name].to(p.dtype))
    return params


def cosine_warmup(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; computed in fp32 as the
    reference computes it, the cosine rounded from fp64 (XLA's fp32 cosine
    lies within an ulp of that)."""
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5) * (
            f32(1) + f32(np.cos(np.float64(f32(math.pi) * prog)))))
        return float(cos)
    return sched
