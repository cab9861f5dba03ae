"""Package rules of the port: it never imports JAX, the JAX package or
``msgpack`` (the card's machine has none of them), its entry points mean
the card unless the CPU is asked for, and a CPU run launches no CUDA
kernel."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import make_dialogues
from repro_torch.kernels import KERNELS
from repro_torch.kernels._build import reset_launches
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, MPICEngine, Request

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
            f"{path}: imports {mod}"


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    env_path = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _small_model():
    cfg = dataclasses.replace(get_smoke_config("llava-1.6-7b"),
                              param_dtype="float32", compute_dtype="float32")
    return cfg, build_model(cfg)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None is valid here")
    cfg, model = _small_model()
    params = model.init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MPICEngine(model, params, EngineConfig(max_seq_len=128))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(seed=0)


@pytest.mark.parametrize("pool_dtype", ["", "int8"])
def test_cpu_run_launches_no_kernel(pool_dtype):
    cfg, model = _small_model()
    params = model.init(seed=0, device="cpu")
    eng = MPICEngine(model, params, EngineConfig(
        max_seq_len=256, decode_slots=2, pool_dtype=pool_dtype),
        device="cpu")
    reset_launches(KERNELS.values())
    samples = make_dialogues(n=2, n_images=1, d_model=cfg.d_model,
                             media_len=cfg.media_token_len)
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    reqs = [eng.submit(Request(prompt=s.prompt, max_new_tokens=3,
                               policy_kwargs={"k": 4})) for s in samples]
    eng.run()
    assert all(r.done and len(r.output_tokens) == 3 for r in reqs)
    assert all(k.launches == 0 for k in KERNELS.values())


def test_unknown_policy_fails_only_that_request():
    cfg, model = _small_model()
    eng = MPICEngine(model, model.init(seed=0, device="cpu"),
                     EngineConfig(max_seq_len=256, decode_slots=1),
                     device="cpu")
    s = make_dialogues(n=1, n_images=0, d_model=cfg.d_model)[0]
    bad = eng.submit(Request(prompt=s.prompt, policy="cache_blend",
                             max_new_tokens=2))
    good = eng.submit(Request(prompt=s.prompt, max_new_tokens=2))
    eng.run()
    assert bad.error and "cache_blend" in bad.error and not bad.done
    assert good.done and eng.pool.free_pages == eng.pool.cfg.num_pages - 1
