"""Shared set-up for the port's parity tests: one small fp32 llava config
built in both packages, and the JAX weights carried into the port.

Everything runs on the CPU: the JAX side with its plain ``ref`` kernels or
Pallas in interpret mode, the port with ``device="cpu"``.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.models import build_model as torch_build_model
from repro_torch.weights import params_from_numpy

ARCH = "llava-1.6-7b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def smoke_configs(**over):
    """(JAX config, port config): the llava smoke config in fp32."""
    return (dataclasses.replace(jax_smoke_config(ARCH), **FP32, **over),
            dataclasses.replace(torch_smoke_config(ARCH), **FP32, **over))


def build_pair(seed: int = 0, **over):
    """Both models and their parameters, the port's carried over from the
    JAX ones: (jax_model, jax_params, torch_model, torch_params)."""
    jcfg, tcfg = smoke_configs(**over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = torch_build_model(tcfg)
    return jmodel, jparams, tmodel, params_from_numpy(tree, tcfg, "cpu")
