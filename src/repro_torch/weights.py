"""Weight bridge: the JAX package's parameter pytree, as numpy, into the
port's modules, and the port's parameters back into that tree.

``params_from_numpy(tree, cfg)`` takes the tree of ``repro.models.Model.
init`` after ``jax.tree_util.tree_map(np.asarray, ...)`` (a bf16 leaf goes
through fp32 on the way, which is exact) and returns a
:class:`~repro_torch.models.transformer.Transformer` whose every weight
equals the JAX one.  The layer-stacked ``(L, ...)`` leaves are unstacked
into the module lists.  The tests use it so that both packages compute
with the same weights; a machine without JAX uses the port's seeded
``init_params`` instead.

:func:`reference_tree` is the inverse: the port's parameters (or any
tensors named as they are, such as their gradients) in the JAX tree's
layout, layers stacked on axis 0 as ``jax.vmap`` stacks them, keys sorted
as JAX's tree functions leave them.  Checkpoints are written in it, so
that both packages read each other's; :func:`params_to_numpy` gives it
as numpy.

A module parameter's name is its path in the tree: ``layers.3.attn.wq``
is ``tree["layers"]["attn"]["wq"][3]``, and an RMS norm's scale, a bare
parameter in the port (``layers.3.attn_norm``, ``final_norm``), is the
norm's ``"scale"`` leaf.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.transformer import Transformer

# leaves the JAX package keeps in fp32 whatever the parameter dtype: the
# SSM's dt_bias, A_log and D, and the MoE router
FP32_LEAVES = ("dt_bias", "A_log", "D", "router")
STACKED = ("layers", "enc_layers")


def leaf_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A parameter's name -> (its keys in the JAX tree, its layer index
    on the stacked axis or None)."""
    parts = name.split(".")
    index = None
    if parts[0] in STACKED:
        index = int(parts[1])
        parts = [parts[0], *parts[2:]]
    if parts[-1].endswith("norm"):
        parts.append("scale")
    return tuple(parts), index


def _n_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def params_from_numpy(tree: dict, cfg, device=None, dtype=None) -> Transformer:
    """``dtype`` (a torch dtype) defaults to ``cfg.param_dtype``; the
    leaves the JAX package keeps in fp32 (:data:`FP32_LEAVES`) stay fp32.
    The leaves may be numpy arrays or CPU tensors (a loaded checkpoint's).
    Every leaf of ``tree`` must fill a parameter and every parameter must
    find its leaf: a model with tied embeddings has no ``lm_head``, a
    MoE's layers carry ``moe`` in place of ``mlp``, a hybrid's the ``ssm``
    leaves and the mixing norms, whisper's ``cross_attn``, ``cross_norm``,
    the layer norms' and the MLP's biases, and at the top ``pos_embed``,
    ``enc_layers``, ``enc_norm`` and ``enc_pos_embed``."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.param_dtype)
    params = Transformer(cfg, device=dev)
    paths = set()
    with torch.no_grad():
        for name, param in params.named_parameters():
            path, index = leaf_path(name)
            paths.add(path)
            leaf = tree
            for key in path:
                leaf = leaf[key]
            if index is not None:
                leaf = leaf[index]
            if isinstance(leaf, torch.Tensor):
                a = leaf.detach().float().cpu()
            else:
                a = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if tuple(a.shape) != tuple(param.shape):
                raise ValueError(f"{name}: weight shape {tuple(a.shape)} != "
                                 f"{tuple(param.shape)}")
            to = torch.float32 if path[-1] in FP32_LEAVES else dt
            param.data = a.to(device=dev, dtype=to)
    if _n_leaves(tree) != len(paths):
        raise ValueError(f"{cfg.name}: the tree has {_n_leaves(tree)} "
                         f"leaves, the model {len(paths)}")
    return params


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def reference_tree(tensors: Union[Transformer, Mapping[str, torch.Tensor]]
                   ) -> dict:
    """The JAX package's tree of ``tensors`` (a ``Transformer``, or a
    mapping from its parameter names to tensors such as their
    gradients): detached CPU tensors in their own dtype, layers stacked on
    axis 0, keys sorted."""
    if isinstance(tensors, torch.nn.Module):
        tensors = dict(tensors.named_parameters())
    tree: dict = {}
    stacks: dict = {}
    for name, t in tensors.items():
        path, index = leaf_path(name)
        t = t.detach().cpu()
        if index is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        else:
            stacks.setdefault(path, {})[index] = t
    for path, by_layer in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack([by_layer[i]
                                      for i in range(len(by_layer))])
    return _sorted(tree)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()


def params_to_numpy(params: Transformer) -> dict:
    """:func:`reference_tree` as numpy, a bf16 leaf as fp32 (exact)."""
    return _to_numpy(reference_tree(params))
