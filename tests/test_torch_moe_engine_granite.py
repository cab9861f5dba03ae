"""The port's engine against the JAX engine on the smoke
granite-moe-1b-a400m (G 2 at head dim 64, four experts top-2, none
shared): as ``test_torch_moe_engine.py`` (``_torch_moe_serve``'s setups
and checks) under ``mpic``, ``full_recompute`` and ``cacheblend`` on an
fp32 and an int8 pool, also on two tensor-parallel ranks; chunked
``mpic`` runs on deepseek alone.
"""
import pytest

import _torch_moe_serve as ms
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

ARCH = "granite-moe-1b-a400m"
SETUPS = ms.setups(chunked=False)


@pytest.fixture(scope="module", autouse=True)
def ranks():
    """Two ranks serving every setup tensor-parallel, started with the
    module so that they run while the JAX engine serves."""
    started = ms.start_ranks(ARCH, SETUPS)
    yield started
    started.close()


@pytest.fixture(scope="module", params=SETUPS, ids=ms.ids(SETUPS))
def served(request):
    return (request.param, *ms.serve_both(ARCH, *request.param))


def test_moe_engine_greedy_tokens_identical(served):
    ms.check_tokens(*served)


def test_moe_engine_first_token_logits_agree(served):
    ms.check_logits(*served[1:3])


def test_moe_ranks_serve_the_jax_engines_tokens(served, ranks):
    ms.check_ranks(*served, ranks.results())
