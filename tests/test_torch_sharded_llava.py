"""Tensor-parallel serving of the paper's llava-1.6-7b (fp32 smoke: MHA,
4 heads) over two gloo ranks on the CPU, against the JAX package's
unsharded engine: the same stream and setups as
``test_torch_sharded.py`` (paged fp32 pool under mpic, cacheblend and
full_recompute with an MRAG request; the dense cache; the int8 pool),
with two kv heads on each rank.

Tolerances as in ``test_torch_sharded.py``: tokens, counts and linked
media exact; first-token logits within 1e-4 relative, on the int8 pool
within 1e-4 relative of the port's unsharded int8 engine and 1e-3
absolute of the JAX one.
"""
import jax
import numpy as np
import pytest

from repro_torch.serving import EngineConfig, MPICEngine

from _torch_parity import build_pair, jax_traffic
from _torch_parity import jax_compile_cache  # noqa: F401
from _torch_sharded import SETUPS, Ranks, _torch_pkg, check_requests, \
    run_traffic

ARCH = "llava-1.6-7b"


@pytest.fixture(scope="module")
def runs():
    jm, jp, tm, tp = build_pair(arch=ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    two = Ranks(2, tm.cfg, tree, [(s, "serve", {"setup": s})
                                  for s in SETUPS])
    try:
        ref = {s: jax_traffic(jm, jp, s) for s in SETUPS}
        eng = MPICEngine(tm, tp, EngineConfig(**SETUPS["int8"][0]),
                         device="cpu")
        port_int8 = run_traffic(eng, _torch_pkg(), tm.cfg.d_model,
                                tm.cfg.media_token_len, SETUPS["int8"][1])
        eng.close()
    finally:
        r2 = two.results()
    return ref, port_int8, r2


@pytest.mark.parametrize("setup", list(SETUPS))
def test_two_ranks_serve_the_jax_engines_tokens(runs, setup):
    ref, port_int8, r2 = runs
    for rank in (0, 1):
        res = r2[rank][setup]
        assert res["facts"]["attn_sharded"]
        assert res["facts"]["local_kv_heads"] == 2
        check_requests(res["requests"], ref[setup],
                       atol=1e-3 if setup == "int8" else None)
        if setup == "int8":
            check_requests(res["requests"], port_int8)
    # both ranks chose the same tokens from the same gathered logits
    for a, b in zip(r2[0][setup]["requests"], r2[1][setup]["requests"]):
        assert a["tokens"] == b["tokens"]
        np.testing.assert_array_equal(a["first"], b["first"])
