"""The port's dry run on ``meta`` (``repro_torch.launch.dryrun``): the
serving selftest at ``model 8``, ``--all`` with one ``ok`` or
``skipped`` row per (arch x shape), the reference's row keys and no
``error`` (internvl2-76b's and deepseek-moe-16b's decode rows checked at
full width), the
kernels' dispatchers on ``meta`` tensors, and a run of the module's entry
that imports neither ``jax`` nor the JAX package.  Nothing here allocates a weight: every
tensor lives on ``meta``."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.selective_attn.ops import (
    selective_attention,
    selective_attention_paged,
)
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import Roofline

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the reference's row keys: Roofline.to_dict() and the run's own
ROW_KEYS = set(Roofline("a", "s", "m", "k", 0.0, 0.0, 0.0, 0.0, 1)
               .to_dict()) | {"status", "lower_s", "compile_s", "coll_ops"}
TRACED = {"internvl2-76b", "phi3-medium-14b", "yi-9b", "stablelm-1.6b",
          "qwen2.5-14b", "deepseek-moe-16b", "granite-moe-1b-a400m",
          "mamba2-130m", "hymba-1.5b", "whisper-small"}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_serving_selftest_on_meta(capsys):
    assert dryrun.serving_selftest() == 0
    assert "serving selftest OK" in capsys.readouterr().out


def test_all_rows_are_ok_or_skipped(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["shape"]) for r in rows] == [
        (a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    for r in rows:
        assert r["status"] in ("ok", "skipped"), r
        if r["status"] == "skipped":
            assert "ROADMAP.md" in r["reason"] or \
                "step_kind" in r["reason"], r
        else:
            assert ROW_KEYS <= set(r)
    ok = {(r["arch"], r["shape"]) for r in rows if r["status"] == "ok"}
    assert ok == {(a, s) for a in TRACED
                  for s in ("prefill_32k", "decode_32k")}
    assert "20 ok, 20 skipped, 0 errors" in capsys.readouterr().out
    for r in rows:
        if r["status"] == "skipped":
            assert "item 6" in r["reason"] or "step_kind" in r["reason"], r

    def row(arch):
        return rows[ASSIGNED_ARCHS.index(arch) * 4
                    + list(INPUT_SHAPES).index("decode_32k")]

    _check_internvl2_decode(row("internvl2-76b"))
    _check_deepseek_decode(row("deepseek-moe-16b"))


def _check_internvl2_decode(row):
    """internvl2-76b's decode_32k row at full width."""
    cfg = get_config("internvl2-76b")
    assert (row["arch"], row["shape"], row["step"]) == (
        "internvl2-76b", "decode_32k", "decode")
    assert row["device"] == "meta"
    assert (row["mesh"], row["chips"]) == ("32x8", 256)
    # the vocab-parallel embedding, two row products a layer, the gather
    assert row["coll_ops"] == 2 * cfg.num_layers + 2
    mem = row["memory_per_device"]
    # rank 0 holds about an eighth of the weights: attention, the MLP and
    # the vocabulary are cut, the norms are not
    assert 0.124 < mem["params"] / (2 * cfg.n_params()) < 0.126
    # 4 rows (128 / data 32) of 32768 slots at one kv head of 8
    assert mem["cache"] == 2 * cfg.num_layers * 4 * 32768 * 128 * 2 + \
        4 * 32768 * 4
    assert row["bytes_per_device"] > mem["params"]
    assert row["bottleneck"] == "memory"


def _check_deepseek_decode(row):
    """deepseek-moe-16b's decode_32k row at full width: rank 0 of ``model
    8`` holds 8 of the 64 routed experts, 2 of the 16 kv heads, an eighth
    of the shared experts and of the vocabulary, and the whole fp32
    router (512 KB a layer)."""
    cfg = get_config("deepseek-moe-16b")
    assert (row["arch"], row["step"], row["device"]) == (
        "deepseek-moe-16b", "decode", "meta")
    # the embedding, per layer the attention's row product and the
    # experts' combine (routed and shared in one all-reduce), the gather
    assert row["coll_ops"] == 2 * cfg.num_layers + 2
    shard, sh = dryrun.shard_on_meta(cfg, dryrun.RecordingMesh(model=8))
    assert sh.widths.experts == 8 and sh.expert_range == (0, 8)
    experts = sum(p.numel() for n, p in shard.named_parameters()
                  if ".moe.w_" in n)
    assert experts * 8 == 3 * cfg.num_layers * cfg.num_experts * \
        cfg.d_model * cfg.d_ff
    router = cfg.num_layers * cfg.d_model * cfg.num_experts * 4
    mem = row["memory_per_device"]
    whole = 2 * cfg.n_params() - cfg.num_layers * cfg.d_model \
        * cfg.num_experts * 2
    assert 0.124 < (mem["params"] - router) / whole < 0.126
    # 4 rows (128 / data 32) of 32768 slots at 2 kv heads of 16
    assert mem["cache"] == 2 * cfg.num_layers * 4 * 32768 * 2 * 128 * 2 + \
        4 * 32768 * 4
    assert row["bottleneck"] == "memory"


def test_dispatchers_give_shapes_on_meta():
    """``meta`` runs the plain versions, which compute shapes only."""
    b, sq, hq, hkv, dh, p, ps = 2, 5, 8, 2, 64, 9, 16
    i32 = torch.int32
    q, kv = _meta(b, sq, hq, dh), _meta(b, 40, hkv, dh)
    pos, kv_pos = _meta(b, sq, dtype=i32), _meta(b, 40, dtype=i32)
    assert selective_attention(q, kv, kv, pos, kv_pos).shape == q.shape
    pool, table = _meta(p, ps, hkv, dh), _meta(b, 3, dtype=i32)
    lens = _meta(b, dtype=i32)
    assert selective_attention_paged(q, pool, pool, table, pos, lens,
                                     window=8).device.type == "meta"
    assert paged_attention(_meta(b, hq, dh), pool, pool, table,
                           lens).shape == (b, hq, dh)
    x = _meta(1, 3, 4, 16, 8)
    out = ssd_chunk(x, _meta(1, 3, 16, 32), _meta(1, 3, 16, 32),
                    _meta(1, 3, 4, 16), _meta(1, 3, 4, 16))
    assert all(t.device.type == "meta" for t in out)


def test_entry_runs_without_jax():
    """``python -m repro_torch.launch.dryrun --serving-selftest`` and
    ``--arch internvl2-76b --shape decode_32k``'s code in one fresh
    process: exit 0, and neither ``jax`` nor ``repro`` was imported."""
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun\n"
        "assert dryrun.main(['--serving-selftest']) == 0\n"
        "assert dryrun.main(['--arch', 'internvl2-76b', '--shape', "
        "'decode_32k']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "serving selftest OK" in done.stdout
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in done.stdout


@pytest.mark.parametrize("kind", ["serve_decode", "serve_prefill"])
def test_trace_serving_runs_the_plans_collectives(kind):
    """A rank of a 2-wide axis on the selftest config: the pool's half of
    the kv heads, whole-vocabulary logits, the plan's collectives."""
    mesh = dryrun.RecordingMesh(model=2)
    cfg = dryrun.SELFTEST_CONFIG
    local, out, calls = dryrun.trace_serving(cfg, kind, mesh, slots=4,
                                             kv_len=64, s_sel=16)
    assert local[0].shape[3] == cfg.num_kv_heads // 2
    assert out.shape[-1] == cfg.vocab_size
    rows, tokens = local[2].shape
    assert (rows, tokens) == ((4, 1) if kind == "serve_decode" else (1, 16))
    assert calls == dryrun.plan_collectives(cfg, mesh, rows, tokens)
