"""Cold-start rehydration of a spool directory (``KVLibrary(rehydrate=True)``
/ ``rehydrate_spool``) in the port against the JAX package's, over one
directory written by either package.

The directory holds two live blocks of user ``u`` (fp or int8), one of the
shared ``"*"`` scope, a block whose TTL has run out, a file without a
``__meta__`` sidecar and a file of junk bytes.  Copies of it rehydrate in
both packages with equal counts (3 rehydrated, 1 skipped, 1 corrupt,
1 expired) and the same files left (junk and expired unlinked); every
rehydrated block is a disk-tier entry without a payload whose first
lookup is a verified read of the original bytes, exact.  A scope that
already holds a live entry keeps it; a file swapped under a rehydrated
entry fails its verified read (a counted miss).  The engine serves the
same tokens from a rehydrated library as from the memory library it
spooled, every lookup a disk hit.  No test combines ``@given`` with
``tmp_path``.
"""
import shutil
import time

import numpy as np
import pytest
import torch

from repro.cache import KVLibrary as JaxLibrary
from repro.cache.backends import KVPayload as JaxPayload
from repro_torch.cache import KVLibrary
from repro_torch.cache.backends import KVPayload
from repro_torch.data import make_dialogues
from repro_torch.serving import EngineConfig, MPICEngine, Request

from _torch_serve import build_gqa_pair
# autouse: JAX's persistent compilation cache while this module runs
from _torch_parity import jax_compile_cache  # noqa: F401

BLOCKS = [("u", "a"), ("u", "b")]
COUNTS = {"rehydrated": 3, "skipped": 1, "corrupt": 1, "expired": 1}
TTL = 0.3


def _kv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
                 for _ in range(2))


def _lib(pkg, spool, **kw):
    if pkg == "jax":
        return JaxLibrary(spool_dir=str(spool), **kw)
    if kw.get("rehydrate"):
        kw["device"] = "cpu"
    return KVLibrary(spool_dir=str(spool), **kw)


def _arrays(pkg, k, v):
    return (k, v) if pkg == "jax" else (torch.from_numpy(k),
                                        torch.from_numpy(v))


def _write_spool(pkg, spool, quantize):
    """The directory described above, written by one package."""
    lib = _lib(pkg, spool, quantize=quantize)
    shared = _lib(pkg, spool, quantize=quantize, shared=True)
    for i, (user, media) in enumerate(BLOCKS):
        lib.put(user, media, *_arrays(pkg, *_kv(i)))
        assert lib.spool_now(user, media)
    shared.put("anyone", "rag", *_arrays(pkg, *_kv(7)))
    assert shared.spool_now("anyone", "rag")
    lib.put("u", "old", *_arrays(pkg, *_kv(8)), ttl=TTL)
    assert lib.spool_now("u", "old")
    raw = JaxPayload if pkg == "jax" else KVPayload
    lib.disk.put("nosidecar", raw(*_arrays(pkg, *_kv(9))))   # no meta
    (spool / "junk.npz").write_bytes(b"not a zip file at all")
    time.sleep(TTL + 0.05)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rehydration_rules_match_reference(writer, quantize, tmp_path):
    src = tmp_path / "spool"
    _write_spool(writer, src, quantize)
    libs, files = {}, {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        shutil.copytree(src, d)
        libs[pkg] = _lib(pkg, d, quantize=quantize, rehydrate=True)
        files[pkg] = sorted(p.name for p in d.iterdir())
    assert libs["torch"].rehydrate_stats == libs["jax"].rehydrate_stats \
        == COUNTS
    assert files["torch"] == files["jax"]
    assert "junk.npz" not in files["torch"]
    assert len(files["torch"]) == 4     # 3 blocks and the legacy file
    lib, jlib = libs["torch"], libs["jax"]
    for i, (user, media) in enumerate(BLOCKS):
        assert lib.peek_tier(user, media) == "disk"
        e = lib._entries[(user, media)]
        assert e.payload.k is None and e.payload.qk is None
        assert e.meta.key == jlib._entries[(user, media)].meta.key
        got, want = lib.get(user, media), jlib.get(user, media)
        for t, j in ((got.k, want.k), (got.v, want.v)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        if not quantize:
            np.testing.assert_array_equal(got.k.numpy(), _kv(i)[0])
    assert lib.peek_tier("u", "old") is None
    st = lib.stats()
    assert st["tiers"]["disk"]["hits"] == 2
    assert st["tiers"]["disk"]["fetches"] == 2
    assert st["tiers"]["disk"]["corrupt"] == 0
    shared = KVLibrary(spool_dir=str(tmp_path / "torch"), shared=True,
                       rehydrate=True, device="cpu")
    assert shared.get("someone", "rag") is not None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_live_entry_wins_over_the_spool(pkg, tmp_path):
    lib = _lib(pkg, tmp_path)
    lib.put("u", "a", *_arrays(pkg, *_kv(0)))
    assert lib.spool_now("u", "a")
    fresh = _lib(pkg, tmp_path)
    fresh.put("u", "a", *_arrays(pkg, *_kv(5)))
    stats = (fresh.rehydrate_spool() if pkg == "jax"
             else fresh.rehydrate_spool("cpu"))
    assert stats == {"rehydrated": 0, "skipped": 1, "corrupt": 0,
                     "expired": 0}
    assert fresh.peek_tier("u", "a") != "disk"
    np.testing.assert_array_equal(np.asarray(fresh.get("u", "a").k),
                                  _kv(5)[0])


def test_swapped_file_fails_its_verified_read(tmp_path):
    lib = _lib("torch", tmp_path)
    for i, (user, media) in enumerate(BLOCKS):
        lib.put(user, media, *_arrays("torch", *_kv(i)))
        assert lib.spool_now(user, media)
    paths = [lib.disk.path_for(lib._entries[s].meta.key) for s in BLOCKS]
    cold = _lib("torch", tmp_path, rehydrate=True)
    assert cold.rehydrate_stats["rehydrated"] == 2
    shutil.copyfile(paths[1], paths[0])          # b's bytes under a's key
    assert cold.get(*BLOCKS[0]) is None
    assert cold.peek_tier(*BLOCKS[0]) is None
    st = cold.stats()
    assert st["tiers"]["disk"]["corrupt"] == 1
    assert cold.get(*BLOCKS[1]) is not None


def test_rehydrate_needs_a_device_without_a_card(tmp_path, monkeypatch):
    """``device=None`` means the card: without one, rehydration raises
    rather than landing the blocks on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVLibrary(spool_dir=str(tmp_path), rehydrate=True)


@pytest.mark.parametrize("pool", ["", "int8"], ids=["fp32", "int8"])
def test_engine_serves_a_rehydrated_spool(pool, tmp_path):
    """Upload and spool into one library, rehydrate a fresh one from its
    directory, serve the same requests: tokens and first logits equal the
    memory library's, every media lookup a verified disk hit."""
    _, _, model, params = build_gqa_pair("qwen-g5")
    cfg = model.cfg
    samples = make_dialogues(n=3, n_images=2, d_model=cfg.d_model,
                             media_len=cfg.media_token_len)

    def run(lib, upload):
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=256, decode_slots=2, pool_dtype=pool),
            static_library=lib, device="cpu")
        firsts = []
        finalize = eng._finalize_prefill

        def record(req, result, *rest):
            firsts.append(np.asarray(result.first_logits))
            return finalize(req, result, *rest)

        eng._finalize_prefill = record
        if upload:
            for s in samples:
                for _, seg in s.prompt.media_segments():
                    eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
                    assert lib.spool_now(s.prompt.user_id, seg.media_id)
        reqs = [eng.submit(Request(prompt=s.prompt, max_new_tokens=5,
                                   policy_kwargs={"k": 8}))
                for s in samples]
        eng.run()
        eng.close()
        return [r.output_tokens for r in reqs], firsts

    control = run(KVLibrary(), upload=True)
    spool = tmp_path / "spool"
    spooled = run(KVLibrary(spool_dir=str(spool)), upload=True)
    cold = KVLibrary(spool_dir=str(spool), rehydrate=True, device="cpu")
    assert cold.rehydrate_stats == {"rehydrated": 6, "skipped": 0,
                                    "corrupt": 0, "expired": 0}
    tokens, firsts = run(cold, upload=False)
    assert tokens == control[0] == spooled[0]
    for a, b in zip(firsts, control[1]):
        np.testing.assert_array_equal(a, b)
    st = cold.stats()
    assert st["tiers"]["disk"]["hits"] == 6 and st["misses"] == 0
    assert st["tiers"]["disk"]["fetches"] == 6
    assert st["tiers"]["disk"]["corrupt"] == 0
