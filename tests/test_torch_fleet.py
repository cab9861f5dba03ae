"""The port's multi-process fleet (``repro_torch.launch.fleet``) against
the JAX package's wire format and heartbeat routing, and one live run.

Request and upload blobs are byte-equal between the two packages (the
zip entries' timestamps pinned), and each package decodes the other's.
The live run spawns two port hosts on the CPU (``--device cpu``: the
smoke llava, seeded weights), uploads each dialogue's two images to one
host (by the SHA-1 of its first image id), every block spooled at once;
it submits four requests, kills the host serving one of them at once,
lets the supervisor find the death and restart the host, which
rehydrates every block it had spooled, and only then routes the requests
again; then it drains.  Every result equals the tokens of an in-process
port engine serving the same requests, and a port host's heartbeat fed
to the JAX ``heartbeat_view`` gives the port's view.
"""
import contextlib
import hashlib
import os
import time

import numpy as np
import pytest

from repro.core import Prompt as JaxPrompt
from repro.core import media_segment as jax_media
from repro.core import text_segment as jax_text
from repro.launch import fleet as jax_fleet
from repro.serving import Request as JaxRequest
from repro.serving import heartbeat_view as jax_heartbeat_view
from repro_torch.configs import get_smoke_config
from repro_torch.core import Prompt, media_segment, text_segment
from repro_torch.data import make_dialogues
from repro_torch.launch import fleet
from repro_torch.models import build_model
from repro_torch.serving import (
    EngineConfig,
    MPICEngine,
    Request,
    heartbeat_view,
)

ARCH = "llava-1.6-7b"
MAX_NEW = 4
MAX_SEQ = 256


@contextlib.contextmanager
def _frozen_clock():
    """Pin ``time.time``: a zip entry's timestamp is part of its bytes."""
    real = time.time
    time.time = lambda: 1_700_000_000.0
    try:
        yield
    finally:
        time.time = real


def _request_pair():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((6, 16)).astype(np.float32)
    toks = rng.integers(8, 200, 7).astype(np.int32)
    kw = dict(max_new_tokens=5, policy="mpic", policy_kwargs={"k": 4},
              priority=2, seed=99, deadline_s=12.5, freeze_after=3)
    j = JaxRequest(prompt=JaxPrompt([jax_text(toks), jax_media("m0", emb),
                                     jax_text(toks[:3])], user_id="u9"), **kw)
    t = Request(prompt=Prompt([text_segment(toks), media_segment("m0", emb),
                               text_segment(toks[:3])], user_id="u9"), **kw)
    t.req_id = j.req_id = "req-wire"
    return j, t


def _fields(req):
    segs = [(s.kind, s.length, s.media_id,
             None if s.tokens is None else np.asarray(s.tokens).tolist(),
             None if s.embeds is None else np.asarray(s.embeds).tolist())
            for s in req.prompt.segments]
    return (req.req_id, req.prompt.user_id, segs, req.policy,
            req.policy_kwargs, req.max_new_tokens, req.priority, req.seed,
            req.deadline_s, req.session_id, req.freeze_after)


def test_request_blobs_are_byte_equal_and_cross_decode():
    j, t = _request_pair()
    with _frozen_clock():
        jblob, tblob = jax_fleet.encode_request(j), fleet.encode_request(t)
    assert tblob == jblob
    assert _fields(fleet.decode_request(jblob)) == _fields(j)
    assert _fields(jax_fleet.decode_request(tblob)) == _fields(t)


def test_upload_blobs_are_byte_equal_and_cross_decode():
    emb = np.random.default_rng(1).standard_normal((8, 32)).astype(np.float32)
    with _frozen_clock():
        jblob = jax_fleet.encode_upload("u9", "mx", emb, ttl=60.0,
                                        dynamic=True)
        tblob = fleet.encode_upload("u9", "mx", emb, ttl=60.0, dynamic=True)
    assert tblob == jblob
    for header, arrays in (fleet.unpack_blob(jblob),
                           jax_fleet.unpack_blob(tblob)):
        assert header == {"user_id": "u9", "media_id": "mx", "ttl": 60.0,
                          "dynamic": True}
        np.testing.assert_array_equal(arrays["embeds"], emb)


def _dialogues():
    cfg = get_smoke_config(ARCH)
    return cfg, make_dialogues(n=3, n_images=2, d_model=cfg.d_model,
                               media_len=cfg.media_token_len, style="mmdu")


def _requests(samples):
    """Four requests: the three dialogues, and the first again, seeded."""
    prompts = [s.prompt for s in samples] + [samples[0].prompt]
    return [Request(prompt=p, max_new_tokens=MAX_NEW, policy="mpic",
                    policy_kwargs={"k": 8}, seed=i)
            for i, p in enumerate(prompts)]


def _owner(sample, hosts=2):
    return int(hashlib.sha1(sample.media_ids[0].encode()).hexdigest(),
               16) % hosts


@pytest.fixture(scope="module")
def reference_tokens():
    """The four requests through one in-process port engine."""
    cfg, samples = _dialogues()
    model = build_model(cfg)
    eng = MPICEngine(model, model.init(seed=0, device="cpu"),
                     EngineConfig(max_seq_len=MAX_SEQ, decode_slots=2),
                     device="cpu")
    for s in samples:
        for _, seg in s.prompt.media_segments():
            eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
    reqs = _requests(samples)
    for r in reqs:
        eng.submit(r)
    eng.run()
    eng.close()
    return [list(r.output_tokens) for r in reqs]


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    cfg, samples = _dialogues()
    sup = fleet.FleetSupervisor(
        2, base_dir=str(tmp_path_factory.mktemp("fleet")), device="cpu",
        max_seq_len=MAX_SEQ, hbm_bytes=1, host_bytes=1, linger_s=30.0)
    try:
        sup.start(timeout_s=60)
        for s in samples:
            for _, seg in s.prompt.media_segments():
                sup.upload(s.prompt.user_id, seg.media_id, seg.embeds,
                           host=_owner(s))
        sup.heartbeat()                 # the routers see the media maps
        victim = _owner(samples[1])
        spooled = sorted(os.listdir(sup.hosts[victim].spec.spool_dir))
        reqs = _requests(samples)
        for r in reqs:
            sup.submit(r)
        in_flight_on_victim = [r.req_id for r in reqs
                               if sup.inflight[r.req_id].host == victim]
        sup.kill_host(victim)
        sup.heartbeat()                 # the death, its requeue, the restart
        sup.wait_healthy([victim], timeout_s=60)
        rehydrated = dict(sup.hosts[victim].health["rehydrate"])
        sup.run_until_done(timeout_s=60)
        health = dict(sup.hosts[0].health)
        report = sup.report()
        sup.drain(timeout_s=60)
        return {"reqs": reqs, "results": dict(sup.results),
                "report": report, "victim": victim, "spooled": spooled,
                "in_flight": in_flight_on_victim, "rehydrated": rehydrated,
                "health": health,
                "exit": [h.proc.returncode for h in sup.hosts],
                "logs": [open(sup.log_path(i)).read() for i in range(2)]}
    finally:
        sup.stop()


@pytest.mark.timeout(180)
def test_killed_host_rejoins_warm_and_every_result_matches(
        fleet_run, reference_tokens):
    run = fleet_run
    assert run["in_flight"], "nothing was in flight on the killed host"
    rep = run["report"]
    assert rep["deaths"] == 1 and rep["restarts"] == 1
    assert rep["requeued"] == len(run["in_flight"])
    assert rep["completed"] == 4 and rep["failed"] == 0
    # every block the killed host had spooled came back at its restart
    assert len(run["spooled"]) == 2
    assert run["rehydrated"]["rehydrated"] == len(run["spooled"])
    for r, want in zip(run["reqs"], reference_tokens):
        row = run["results"][r.req_id]
        assert row["state"] == "done" and row["tokens"] == want, row
        assert row["n_reused"] > 0          # the images were linked
    assert run["exit"] == [0, 0]
    for log in run["logs"]:
        assert "exit steps=" in log and "launches=" in log


@pytest.mark.timeout(180)
def test_port_heartbeat_gives_the_reference_view(fleet_run):
    health = fleet_run["health"]
    assert health["media"] and health["load"]["total_pages"] > 0
    _, samples = _dialogues()
    emb = np.zeros((2, 4), np.float32)
    for s in samples:
        toks = np.asarray([9, 10, 11], np.int32)
        treq = Request(prompt=Prompt(
            [text_segment(toks)] + [media_segment(m, emb)
                                    for m in s.media_ids], user_id="u0"))
        jreq = JaxRequest(prompt=JaxPrompt(
            [jax_text(toks)] + [jax_media(m, emb) for m in s.media_ids],
            user_id="u0"))
        tv = heartbeat_view(0, "127.0.0.1:1", health, treq)
        jv = jax_heartbeat_view(0, "127.0.0.1:1", health, jreq)
        assert vars(tv) == vars(jv)
