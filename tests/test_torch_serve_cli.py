"""The port's serving CLI (``python -m repro_torch.launch.serve``) against
the JAX package's (``python -m repro.launch.serve``).

``--help`` lists exactly the ported flags; for a set of command lines both
CLIs build equal ``EngineConfig`` fields, and the same static library
(peers, fault plan); a ``--device cpu`` run under ``mpic,full_recompute,
bogus`` fails only the bogus request and prints the JAX CLI's ``reused``
and ``tokens`` per request when it serves the JAX CLI's weights, and so
does a run of the MoE granite-moe-1b-a400m with ``--freeze-idle-s``, and
a run through a two-replica cluster (``--replicas 2 --router affinity
--deadline-s``), which also prints each request's replica, and a
tensor-parallel run over two ranks (``--mesh 1x2``), also with two
replicas, peers, a block server and the idle sweep, and with the MoE
granite (its experts cut over the ranks); without
``--device cpu`` and without a card the run exits non-zero.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.weights import params_from_numpy

# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = {"--arch", "--device", "--requests", "--policy", "--mpic-k",
          "--max-new-tokens", "--slots", "--max-seq-len", "--paged",
          "--no-paged", "--pipelined", "--no-pipelined", "--prefill-chunk",
          "--peers", "--serve-blocks", "--fault-plan", "--fault-seed",
          "--freeze-idle-s", "--replicas", "--fleet", "--router",
          "--deadline-s", "--mesh", "--help"}
ARGVS = [
    [],
    ["--no-paged", "--slots", "2", "--max-seq-len", "1024"],
    ["--no-pipelined", "--prefill-chunk", "64", "--policy",
     "mpic,cacheblend", "--mpic-k", "16", "--requests", "2"],
    ["--peers", "127.0.0.1:1, 127.0.0.1:2", "--fault-plan",
     "peer.request:blackhole;engine.step:crash:start=3", "--fault-seed", "5"],
    ["--fault-plan", "loader.fetch:stall:delay=0.1", "--paged",
     "--pipelined", "--max-new-tokens", "3", "--serve-blocks", "0"],
    ["--arch", "granite-moe-1b-a400m", "--freeze-idle-s", "2.5"],
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_help_lists_exactly_the_ported_flags():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--help"],
        capture_output=True, text=True, env=_env(), timeout=120, check=True)
    assert set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", out.stdout)) \
        == PORTED


class _Built(Exception):
    pass


def _reference_build(argv, monkeypatch):
    """What the JAX CLI hands its engine for ``argv``: the engine config,
    the static library and the fault plan (the engine is never built)."""
    seen = {}

    class Model:
        def init(self, key):
            return None

    def engine(model, params, cfg, *, mesh, static_library, faults):
        seen.update(cfg=cfg, lib=static_library, faults=faults)
        raise _Built

    monkeypatch.setattr(jax_serve, "build_model", lambda cfg: Model())
    monkeypatch.setattr(jax_serve, "MPICEngine", engine)
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    with pytest.raises(_Built):
        jax_serve.main()
    return seen


def _library(lib):
    if lib is None:
        return None
    peers = [t.address for t in lib.network.transports] if lib.network \
        else None
    return peers, lib.faults.stats() if lib.faults else None


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_engine_config_and_library_match_the_reference(argv, monkeypatch):
    ref = _reference_build(argv, monkeypatch)
    args = serve.build_parser().parse_args([*argv, "--device", "cpu"])
    cfg = serve.engine_config(args)
    shared = ({f.name for f in dataclasses.fields(cfg)}
              & {f.name for f in dataclasses.fields(ref["cfg"])})
    assert {"max_seq_len", "decode_slots", "paged", "pipelined",
            "prefill_chunk_tokens", "freeze_idle_s"} <= shared
    assert {n: getattr(cfg, n) for n in shared} \
        == {n: getattr(ref["cfg"], n) for n in shared}
    _, eng, faults = serve.build(args)
    try:
        assert eng.cfg == cfg
        want = _library(ref["lib"])
        if want is None:
            # the engine's own library, with the plan when there is one
            assert eng.static_lib.network is None and ref["faults"] is None
        else:
            assert _library(eng.static_lib) == want
        assert (faults.stats() if faults else None) == \
            (ref["faults"].stats() if ref["faults"] else None)
        assert eng.faults is faults
    finally:
        eng.close()


def _requests(text):
    """(reused, tokens) of each served request, and the failed lines."""
    served = [(int(a), int(b)) for a, b in re.findall(
        r"^  req\d+: ttft=.*reused=\s*(\d+)\s+tokens=(\d+)$", text, re.M)]
    failed = re.findall(r"^  req\d+: FAILED — (.*)$", text, re.M)
    return served, failed


_JAX_RUNS = {}
_TREES = {}
BOGUS_ARGV = ["--requests", "3", "--policy", "mpic,full_recompute,bogus",
              "--max-new-tokens", "4"]


def _jax_cli(argv, monkeypatch, capture):
    """The JAX CLI's output for ``argv``, run once a module (``capture``:
    the test's capsys or capfd, read empty first)."""
    if tuple(argv) not in _JAX_RUNS:
        monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
        jax_serve.main()
        _JAX_RUNS[tuple(argv)] = capture.readouterr().out
    return _JAX_RUNS[tuple(argv)]


def _params(arch):
    """The JAX CLI's weights of ``arch``'s smoke config (seed 0), in the
    port (drawn once a module)."""
    if arch not in _TREES:
        _TREES[arch] = jax.tree_util.tree_map(
            np.asarray, jax_build_model(jax_smoke_config(arch)).init(
                jax.random.PRNGKey(0)))
    return params_from_numpy(_TREES[arch], get_smoke_config(arch), "cpu")


def test_cpu_run_fails_only_the_bogus_request_as_the_reference(
        monkeypatch, capsys):
    serve.main([*BOGUS_ARGV, "--device", "cpu"],
               params=_params("llava-1.6-7b"))
    port = _requests(capsys.readouterr().out)
    ref = _requests(_jax_cli(BOGUS_ARGV, monkeypatch, capsys))
    assert port[0] == ref[0]
    assert [r > 0 for r, _ in port[0]] == [True, False]
    assert [t for _, t in port[0]] == [4, 4]
    assert len(port[1]) == len(ref[1]) == 1
    assert port[1][0].startswith("unknown policy 'bogus'")


def test_cpu_mesh_run_serves_the_references_tokens(monkeypatch, capfd):
    """``--mesh 1x2 --device cpu``: two gloo ranks spawned by the CLI on
    the JAX CLI's weights (handed whole to the ranks, which cut them),
    rank 0 alone printing, against the JAX CLI unsharded: the same
    ``reused`` and ``tokens`` per request, the mesh in the header and the
    backend on its own line."""
    serve.main([*BOGUS_ARGV, "--device", "cpu", "--mesh", "1x2"],
               params=_params("llava-1.6-7b"))
    port = capfd.readouterr().out
    ref = _jax_cli(BOGUS_ARGV, monkeypatch, capfd)
    assert _requests(port)[0] == _requests(ref)[0]
    assert len(_requests(port)[0]) == 2
    assert len(_requests(port)[1]) == len(_requests(ref)[1]) == 1
    assert port.count("\narch=") == 1 and "mesh=1x2 replicas=1" in port
    assert "  tensor_parallel: backend=gloo ranks=2 device=cpu" in port


GRANITE = "granite-moe-1b-a400m"
GRANITE_ARGV = ["--arch", GRANITE, "--requests", "2", "--policy",
                "mpic,full_recompute", "--max-new-tokens", "4",
                "--freeze-idle-s", "5"]


def test_cpu_run_of_the_moe_granite_as_the_reference(monkeypatch, capsys):
    """The smoke granite-moe-1b-a400m (G 2, 32 experts at smoke size 4,
    top-2) through both CLIs on the JAX CLI's weights, with the idle
    sweep on: the same ``reused`` and ``tokens`` per request."""
    serve.main([*GRANITE_ARGV, "--device", "cpu"], params=_params(GRANITE))
    port = _requests(capsys.readouterr().out)
    ref = _requests(_jax_cli(GRANITE_ARGV, monkeypatch, capsys))
    assert port == ref
    assert [r > 0 for r, _ in port[0]] == [True, False]
    assert [t for _, t in port[0]] == [4, 4] and not port[1]


def test_cpu_mesh_run_of_the_moe_granite_as_the_reference(monkeypatch,
                                                          capfd):
    """The same granite run with ``--mesh 1x2``: two gloo ranks, each
    holding 2 of the 4 experts and routing every row over all 4, rank 0
    printing the JAX CLI's unsharded ``reused`` and ``tokens``."""
    serve.main([*GRANITE_ARGV, "--device", "cpu", "--mesh", "1x2"],
               params=_params(GRANITE))
    port = capfd.readouterr().out
    ref = _jax_cli(GRANITE_ARGV, monkeypatch, capfd)
    assert _requests(port) == _requests(ref)
    assert [t for _, t in _requests(port)[0]] == [4, 4]
    assert port.count("\narch=") == 1 and "mesh=1x2 replicas=1" in port
    assert "  tensor_parallel: backend=gloo ranks=2 device=cpu" in port


def _cluster_requests(text):
    """(reused, tokens, replica) of each served request, in print order."""
    return [tuple(int(x) for x in m) for m in re.findall(
        r"^  req\d+: ttft=.*reused=\s*(\d+)\s+tokens=(\d+) "
        r"replica=(\d+)$", text, re.M)]


def test_cpu_cluster_run_as_the_reference(monkeypatch, capsys):
    """``--replicas 2 --router affinity --deadline-s 60`` through both CLIs
    on the JAX CLI's weights: the same requests on the same replicas with
    the same ``reused`` and ``tokens``, none reaped."""
    argv = ["--requests", "3", "--replicas", "2", "--router", "affinity",
            "--deadline-s", "60", "--max-new-tokens", "4"]
    serve.main([*argv, "--device", "cpu"], params=_params("llava-1.6-7b"))
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    jax_serve.main()
    ref = capsys.readouterr().out
    assert _cluster_requests(port) == _cluster_requests(ref)
    assert len(_cluster_requests(port)) == 3
    assert {r for *_, r in _cluster_requests(port)} == {0, 1}
    assert "DEADLINE" not in port and "replicas=2 router=affinity" in port


def test_cpu_mesh_cluster_run_with_the_system_half_as_the_reference(
        monkeypatch, capfd):
    """``--mesh 1x2 --replicas 2`` with ``--peers`` (a dead one: every
    image is local), ``--serve-blocks 0`` (rank 0 alone serves) and
    ``--freeze-idle-s``, on the JAX CLI's weights, against the JAX CLI's
    unsharded ``--replicas 2`` run: the same ``reused`` and ``tokens`` per
    request, one block server, the mesh and the router in the header."""
    argv = ["--requests", "3", "--replicas", "2", "--router", "affinity",
            "--max-new-tokens", "4", "--peers", "127.0.0.1:1",
            "--serve-blocks", "0", "--freeze-idle-s", "5"]
    serve.main([*argv, "--device", "cpu", "--mesh", "1x2"],
               params=_params("llava-1.6-7b"))
    port = capfd.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve.py", *argv])
    jax_serve.main()
    ref = capfd.readouterr().out
    served = sorted(r[:2] for r in _cluster_requests(port))
    assert served == sorted(r[:2] for r in _cluster_requests(ref))
    assert len(served) == 3 and all(t == 4 for _, t in served)
    assert port.count("serving KV blocks to peers at") == 1
    assert "mesh=1x2 replicas=2 router=affinity" in port
    assert "  tensor_parallel: backend=gloo ranks=2 device=cpu" in port


def test_default_device_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "1"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
