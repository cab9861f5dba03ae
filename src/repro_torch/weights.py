"""Weight bridge: the JAX package's parameter pytree, as numpy, into the
port's modules.

``params_from_numpy(tree, cfg)`` takes the tree of ``repro.models.Model.
init`` after ``jax.tree_util.tree_map(np.asarray, ...)`` (a bf16 leaf goes
through fp32 on the way, which is exact) and returns a
:class:`~repro_torch.models.transformer.Transformer` whose every weight
equals the JAX one.  The layer-stacked ``(L, ...)`` leaves are unstacked
into the module list.  The tests use it so that both packages compute with
the same weights; a machine without JAX uses the port's seeded
``init_params`` instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.transformer import Transformer


def params_from_numpy(tree: dict, cfg, device=None, dtype=None) -> Transformer:
    """``dtype`` (a torch dtype) defaults to ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.param_dtype)
    params = Transformer(cfg, device=dev)

    def put(param: torch.nn.Parameter, arr) -> None:
        a = np.array(arr, dtype=np.float32)
        if a.shape != tuple(param.shape):
            raise ValueError(f"weight shape {a.shape} != {tuple(param.shape)}")
        param.data = torch.from_numpy(a).to(device=dev, dtype=dt)

    layers = tree["layers"]
    with torch.no_grad():
        put(params.embed, tree["embed"])
        put(params.final_norm, tree["final_norm"]["scale"])
        put(params.lm_head, tree["lm_head"])
        for i, lp in enumerate(params.layers):
            put(lp.attn_norm, layers["attn_norm"]["scale"][i])
            put(lp.mlp_norm, layers["mlp_norm"]["scale"][i])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(lp.attn, name), layers["attn"][name][i])
            for name in ("w_gate", "w_up", "w_down"):
                put(getattr(lp.mlp, name), layers["mlp"][name][i])
    return params
