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

SSM_FP32 = ("dt_bias", "A_log", "D")


def params_from_numpy(tree: dict, cfg, device=None, dtype=None) -> Transformer:
    """``dtype`` (a torch dtype) defaults to ``cfg.param_dtype``; the SSM
    leaves the JAX package keeps in fp32 (``dt_bias``, ``A_log``, ``D``)
    stay fp32.  A model with tied embeddings has no ``lm_head`` leaf.  A
    hybrid's layers carry the ``ssm`` leaves and the ``attn_mix_norm`` /
    ``ssm_mix_norm`` scales beside the attention's; a MoE's carry ``moe``
    (``router``, fp32, the stacked ``w_gate``/``w_up``/``w_down`` and, with
    shared experts, ``shared``) in place of ``mlp``."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.param_dtype)
    params = Transformer(cfg, device=dev)

    def put(param: torch.nn.Parameter, arr, to=None) -> None:
        a = np.array(arr, dtype=np.float32)
        if a.shape != tuple(param.shape):
            raise ValueError(f"weight shape {a.shape} != {tuple(param.shape)}")
        param.data = torch.from_numpy(a).to(device=dev, dtype=to or dt)

    layers = tree["layers"]
    with torch.no_grad():
        put(params.embed, tree["embed"])
        put(params.final_norm, tree["final_norm"]["scale"])
        if params.lm_head is not None:
            put(params.lm_head, tree["lm_head"])
        def put_ssm(ssm_mod, i: int) -> None:
            ssm = layers["ssm"]
            for name, p in ssm_mod.named_parameters():
                leaf = ssm[name]["scale"] if name == "out_norm" \
                    else ssm[name]
                put(p, leaf[i], torch.float32 if name in SSM_FP32 else None)

        for i, lp in enumerate(params.layers):
            if cfg.arch_type == "ssm":
                put(lp.norm, layers["norm"]["scale"][i])
                put_ssm(lp.ssm, i)
                continue
            put(lp.attn_norm, layers["attn_norm"]["scale"][i])
            put(lp.mlp_norm, layers["mlp_norm"]["scale"][i])
            for name in ("wq", "wk", "wv", "wo") + (
                    ("bq", "bk", "bv") if cfg.qkv_bias else ()):
                put(getattr(lp.attn, name), layers["attn"][name][i])
            if cfg.arch_type == "moe":
                moe = layers["moe"]
                put(lp.moe.router, moe["router"][i], torch.float32)
                for name in ("w_gate", "w_up", "w_down"):
                    put(getattr(lp.moe, name), moe[name][i])
                    if lp.moe.shared is not None:
                        put(getattr(lp.moe.shared, name),
                            moe["shared"][name][i])
            else:
                for name in ("w_gate", "w_up", "w_down"):
                    put(getattr(lp.mlp, name), layers["mlp"][name][i])
            if cfg.hybrid:
                put_ssm(lp.ssm, i)
                for name in ("attn_mix_norm", "ssm_mix_norm"):
                    put(getattr(lp, name), layers[name]["scale"][i])
    return params
