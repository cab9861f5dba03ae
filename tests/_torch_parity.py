"""Shared set-up for the port's parity tests: one small fp32 config (llava
unless a test names another arch) built in both packages, and the JAX
weights carried into the port.

Everything runs on the CPU: the JAX side with its plain ``ref`` kernels or
Pallas in interpret mode, the port with ``device="cpu"``.
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.experimental.compilation_cache import compilation_cache

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.models import build_model as torch_build_model
from repro_torch.weights import params_from_numpy

ARCH = "llava-1.6-7b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def smoke_configs(arch: str = ARCH, **over):
    """(JAX config, port config): the arch's smoke config in fp32."""
    return (dataclasses.replace(jax_smoke_config(arch), **FP32, **over),
            dataclasses.replace(torch_smoke_config(arch), **FP32, **over))


def build_pair(seed: int = 0, arch: str = ARCH, **over):
    """Both models and their parameters, the port's carried over from the
    JAX ones: (jax_model, jax_params, torch_model, torch_params)."""
    jcfg, tcfg = smoke_configs(arch, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = torch_build_model(tcfg)
    return jmodel, jparams, tmodel, params_from_numpy(tree, tcfg, "cpu")


_CACHE_OPTIONS = {"jax_compilation_cache_dir": None,
                  "jax_persistent_cache_min_compile_time_secs": 0,
                  "jax_persistent_cache_min_entry_size_bytes": 0}


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache, for the module that imports
    this fixture: every JAX engine the parity tests build compiles its
    steps anew, to executables the cache then loads instead.  The
    executables are the same, so is every result; the cache is off again
    after the module."""
    saved = {name: getattr(jax.config, name) for name in _CACHE_OPTIONS}
    options = dict(_CACHE_OPTIONS, jax_compilation_cache_dir=str(
        tmp_path_factory.mktemp("jax_compile_cache")))
    for name, value in options.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()



def jax_traffic(jmodel, jparams, setup: str):
    """The JAX engine's answer to ``_torch_sharded.SETUPS[setup]``'s
    stream (unsharded, paged passes on their ``ref`` backend): the same
    per-request dicts as ``_torch_sharded.run_traffic``."""
    from repro.core import Prompt, text_segment
    from repro.data import image_embeds, make_dialogues
    from repro.serving import EngineConfig, MPICEngine, Request

    from _torch_sharded import SETUPS, run_traffic
    over, policies = SETUPS[setup]
    eng = MPICEngine(jmodel, jparams, EngineConfig(
        paged_backend="ref", pipelined=False, **over))
    pkg = {"make_dialogues": make_dialogues, "image_embeds": image_embeds,
           "text_segment": text_segment, "Prompt": Prompt,
           "Request": Request}
    return run_traffic(eng, pkg, jmodel.cfg.d_model,
                       jmodel.cfg.media_token_len, policies)
