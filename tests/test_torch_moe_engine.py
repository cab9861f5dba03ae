"""The port's engine against the JAX engine on the smoke deepseek-moe-16b
(MHA, four experts top-2 and one shared): three two-image dialogues and
one MRAG request, two decode slots, under ``mpic``, ``full_recompute`` and
``cacheblend`` on an fp32 and an int8 pool, and ``mpic`` chunked at 32
tokens; and two gloo ranks serving every setup tensor-parallel (two of
the four experts a rank) against the same runs.  The checks are
``_torch_moe_serve``'s; granite-moe-1b-a400m is
``test_torch_moe_engine_granite.py``.
"""
import pytest

import _torch_moe_serve as ms
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

ARCH = "deepseek-moe-16b"
SETUPS = ms.setups(chunked=True)


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
