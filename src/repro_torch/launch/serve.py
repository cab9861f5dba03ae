"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(port of the JAX package's ``launch/serve.py``).

Boots an MPIC engine for the chosen architecture (or, with ``--replicas
N``, an :class:`~repro_torch.serving.cluster.MPICCluster` of N replicas
behind ``--router``), uploads every image of a synthetic MMDU-style
request stream (user ``u1``), submits the requests, runs to the end, and
prints one line per request (its replica on a cluster) and the report.
``--fleet N`` serves the stream through a supervised fleet of N engine
host processes instead (``launch/fleet.py``).  ``--deadline-s`` gives
every request a wall-clock budget; a request past it is reaped.

By default it runs on the card and serves the full-width config
(``configs.get_config``) with seeded random weights and images of the
config's ``media_token_len`` tokens, and it raises without a card.
``--device cpu`` serves the smoke config (``get_smoke_config``) with the
JAX launcher's 24-token images on the kernels' plain versions.  A prompt
longer than ``--max-seq-len`` stops the run at its submit, as in the JAX
launcher: full-width llava's prompts take 1,298-1,321 tokens, so a card
run passes ``--max-seq-len 2048``.

``--no-paged`` / ``--no-pipelined`` select the dense-cache and sequential
baselines, ``--prefill-chunk`` chunks long prefills across engine steps.
The network KV tier spans processes: ``--serve-blocks PORT`` exports this
server's static library to peers, and ``--peers host:port[,...]`` pulls
locally missing media KV from theirs before falling back to recompute.
``--fault-plan`` injects seeded faults (``cache/faults.py``).
``--freeze-idle-s`` spools frozen session snapshots idle that long
(``serving/sessions.py``).

``--policy`` takes a comma-separated trace cycled over the requests; an
unknown policy name fails that request, and the server keeps serving.

``--mesh DxM`` (``auto``: ``1 x`` every visible card) serves over a
``data D x model M`` mesh of D·M ranks: the launcher spawns D·M processes
joined by ``torch.distributed`` (``launch/mesh.py``); world rank
``d·M + m`` serves model shard ``m`` of the weights (drawn directly,
never whole; every family: attention by kv heads, the MLP, a MoE's
routed and shared experts, the SSM's and hybrid's SSD heads, whisper's
encoder and decoder, each where the axis divides it) and decodes the
slots of data shard ``d`` (all of them where D does not divide
``--slots``), on the same stream; prefills run on every data rank, the
paged pool is whole over ``data`` (each decode step's new K/V rows
gathered into every copy) and the dense cache holds the rank's slots.
Rank 0 prints the lines, with ``mesh=DxM`` in the header and the backend
on a line of its own: NCCL when every rank has a card of its own, gloo
on the CPU and when the ranks share fewer cards.  ``--device`` passes
through to the ranks.  Under a mesh every flag above works as without
one: ``--replicas`` gives each replica an engine over the mesh,
``--peers`` pulls on rank 0 (the others read what it pulled from the
spool that the ranks share), ``--serve-blocks`` serves rank 0's library,
``--freeze-idle-s`` and ``--deadline-s`` go by rank 0's clock, and
``--fault-plan`` reaches every rank.
``--mesh`` with ``--fleet`` is an error: the JAX launcher's ``--fleet``
returns before it reads ``--mesh``, so neither package has that path.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
from typing import List, Optional, Tuple, Union

import torch
import torch.multiprocessing as mp

from repro_torch.cache import FaultPlan, KVLibrary, KVPeerServer
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.data import image_embeds, make_dialogues
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    ServingMesh,
    free_port,
    make_serving_mesh,
)
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.serving import (
    ClusterConfig,
    EngineConfig,
    MPICCluster,
    MPICEngine,
    Request,
)

SMOKE_MEDIA_LEN = 24        # the JAX launcher's image length on the CPU


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a synthetic multimodal request stream through "
                    "the port's MPIC engine.")
    ap.add_argument("--arch", default="llava-1.6-7b")
    ap.add_argument("--device", default=None,
                    help="'cpu' serves the smoke config on the plain "
                         "PyTorch path; default: the card, at full width")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--policy", default="mpic",
                    help="policy per request, comma-separated trace cycled "
                         "over the stream (mpic, prefix_caching, full_reuse,"
                         " cacheblend, full_recompute); unknown names fail "
                         "per-request, not the server")
    ap.add_argument("--mpic-k", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--paged", dest="paged", action="store_true",
                    default=True, help="pool-backed decode path (default)")
    ap.add_argument("--no-paged", dest="paged", action="store_false",
                    help="dense batch-cache baseline")
    ap.add_argument("--pipelined", dest="pipelined", action="store_true",
                    default=True, help="pipelined admission (default)")
    ap.add_argument("--no-pipelined", dest="pipelined",
                    action="store_false",
                    help="sequential admission baseline")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help=">0: chunk long prefills across engine steps")
    ap.add_argument("--freeze-idle-s", type=float, default=0.0,
                    help=">0: frozen session snapshots idle this many "
                         "seconds are spooled to the disk tier (freeze/"
                         "thaw session store, see serving/sessions.py)")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1: serve through an MPICCluster of N "
                         "data-parallel engine replicas")
    ap.add_argument("--fleet", type=int, default=0,
                    help=">0: serve through a supervised MULTI-PROCESS "
                         "fleet of N engine hosts (one process + spool "
                         "dir + peer block server each) behind the "
                         "heartbeat router — see launch/fleet.py")
    ap.add_argument("--router", default="affinity",
                    choices=["random", "least_loaded", "affinity"],
                    help="cluster routing policy (with --replicas > 1)")
    ap.add_argument("--peers", default="",
                    help="comma-separated host:port peer block servers — "
                         "enables the network KV tier (a local cache miss "
                         "pulls the peer's spooled entry instead of "
                         "recomputing)")
    ap.add_argument("--serve-blocks", type=int, default=None,
                    metavar="PORT",
                    help="export this server's static KV library to peers "
                         "on PORT (0 = pick a free port)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget from arrival; "
                         "requests not finished in time are reaped "
                         "(terminal DEADLINE state, resources freed)")
    ap.add_argument("--fault-plan", default="",
                    help="chaos testing: ';'-separated fault rules "
                         "site:kind[:k=v,...] (see cache/faults.py), e.g. "
                         "'peer.request:blackhole;loader.fetch:stall:"
                         "delay=0.5,stop=1'")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for fault-plan probability draws")
    ap.add_argument("--mesh", default="none",
                    help="'none' (default), 'auto' (every visible card on "
                         "model) or 'DxM': serving over data D x model M "
                         "ranks")
    return ap


def parse_mesh(spec: str) -> Optional[Tuple[int, int]]:
    """'none' -> None; 'auto' -> (1, 0), every visible card; 'DxM' ->
    (D, M)."""
    if spec in ("none", ""):
        return None
    if spec == "auto":
        return 1, 0
    data, model = (int(x) for x in spec.lower().split("x"))
    return data, model


def engine_config(args: argparse.Namespace) -> EngineConfig:
    return EngineConfig(
        max_seq_len=args.max_seq_len, decode_slots=args.slots,
        paged=args.paged, pipelined=args.pipelined,
        prefill_chunk_tokens=args.prefill_chunk,
        freeze_idle_s=args.freeze_idle_s)


def build(args: argparse.Namespace, params=None,
          mesh: Optional[ServingMesh] = None
          ) -> Tuple[ModelConfig, Union[MPICEngine, MPICCluster],
                     Optional[FaultPlan]]:
    """The model config, the engine (a cluster with ``--replicas`` > 1)
    and the fault plan that ``args`` ask for.  ``params`` (on the
    engine's device; whole, also under a mesh) replace the seeded
    weights; the static library gets the peers and the plan, when given.
    Under ``mesh`` the engine serves this rank's shard, drawn directly
    when no ``params`` are given."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = (get_config(args.arch) if device.type == "cuda"
           else get_smoke_config(args.arch))
    peers = [p.strip() for p in args.peers.split(",") if p.strip()]
    faults = (FaultPlan.parse(args.fault_plan, seed=args.fault_seed)
              if args.fault_plan else None)
    model = build_model(cfg)
    if params is None and mesh is not None:
        from repro_torch.serving.sharding import ServingSharding
        params = init_params(cfg, seed=0, device=device,
                             sharding=ServingSharding(mesh, cfg))
    elif params is None:
        params = model.init(seed=0, device=device)
    if args.replicas > 1:
        return cfg, MPICCluster(model, params, engine_config(args),
                                ClusterConfig(replicas=args.replicas,
                                              router=args.router,
                                              peers=peers or None,
                                              serve_port=args.serve_blocks,
                                              deadline_s=args.deadline_s,
                                              faults=faults,
                                              on_stuck="report"),
                                device=device, mesh=mesh), faults
    static_lib = (KVLibrary(peers=peers, faults=faults, device=device,
                            mesh=mesh) if peers or faults else None)
    eng = MPICEngine(model, params, engine_config(args),
                     static_library=static_lib, device=device, faults=faults,
                     mesh=mesh)
    return cfg, eng, faults


def serve(args: argparse.Namespace, cfg: ModelConfig,
          eng: Union[MPICEngine, MPICCluster], policies: List[str],
          faults: Optional[FaultPlan]) -> None:
    """Upload the stream's images, submit its requests under the cycled
    policies, run the engine or cluster, and print the results (under a
    mesh every rank runs this; the caller silences all but rank 0)."""
    media_len = (cfg.media_token_len if eng.device.type == "cuda"
                 else SMOKE_MEDIA_LEN)
    dialogues = make_dialogues(n=args.requests, n_images=2,
                               d_model=cfg.d_model, media_len=media_len,
                               style="mmdu", user_id="u1")
    seen = set()
    for d in dialogues:
        for mid in d.media_ids:
            if mid not in seen:
                eng.upload("u1", mid, image_embeds(mid, media_len,
                                                   cfg.d_model))
                seen.add(mid)
    for i, d in enumerate(dialogues):
        policy = policies[i % len(policies)]
        kw = {"k": args.mpic_k} if policy == "mpic" else {}
        eng.submit(Request(prompt=d.prompt,
                           max_new_tokens=args.max_new_tokens,
                           policy=policy, policy_kwargs=kw,
                           deadline_s=args.deadline_s))
    done = eng.run()
    mesh = getattr(eng, "mesh", None)
    print(f"\narch={cfg.name} policy={args.policy} paged={args.paged} "
          f"pipelined={args.pipelined} device={eng.device.type} "
          + (f"mesh={mesh.data}x{mesh.model} " if mesh is not None else "")
          + f"replicas={args.replicas}"
          + (f" router={args.router}" if args.replicas > 1 else ""))
    if mesh is not None:
        print(f"  tensor_parallel: backend={mesh.backend} "
              f"ranks={mesh.world} device={eng.device}")
    for r in done:
        rep = f" replica={r.replica}" if args.replicas > 1 else ""
        print(f"  {r.req_id}: ttft={r.ttft * 1e3:7.0f} ms  "
              f"reused={r.prefill_stats.get('n_reused', 0):4d}  "
              f"tokens={len(r.output_tokens)}{rep}")
    for r in eng.failed:
        print(f"  {r.req_id}: FAILED — {r.error}")
    for r in eng.expired:
        print(f"  {r.req_id}: DEADLINE — {r.error}")
    if faults is not None:
        print(f"  fault_plan: {faults.stats()}")
    for k, v in eng.report().items():
        print(f"  {k}: {v}")


def main(argv: Optional[List[str]] = None, *, params=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    policies = [p.strip() for p in args.policy.split(",") if p.strip()]
    if not policies:
        ap.error("--policy needs at least one policy name")
    shape = parse_mesh(args.mesh)
    if shape is not None and args.fleet > 0:
        ap.error("--mesh with --fleet: the JAX launcher's --fleet returns "
                 "before it reads --mesh, so neither package serves a fleet "
                 "over a mesh")
    if args.fleet > 0:
        # the supervisor builds the hosts, uploads and submits
        from repro_torch.launch.fleet import run_fleet
        run_fleet(hosts=args.fleet, requests=args.requests, arch=args.arch,
                  policy=args.policy, max_new_tokens=args.max_new_tokens,
                  mpic_k=args.mpic_k, router=args.router,
                  deadline_s=args.deadline_s,
                  freeze_idle_s=args.freeze_idle_s,
                  max_seq_len=args.max_seq_len, device=args.device)
        return
    if shape is not None:
        _serve_mesh(sys.argv[1:] if argv is None else argv, args, shape,
                    params)
        return
    cfg, eng, faults = build(args, params)
    _run(args, cfg, eng, policies, faults)


def _run(args: argparse.Namespace, cfg: ModelConfig,
         eng: Union[MPICEngine, MPICCluster], policies: List[str],
         faults: Optional[FaultPlan], rank: int = 0) -> None:
    """:func:`serve` beside the block server that ``--serve-blocks`` asks
    for (a cluster's own; under a mesh, rank 0's alone), then close
    both."""
    peer_server = None if args.replicas <= 1 else eng.peer_server
    try:
        if args.serve_blocks is not None and args.replicas <= 1 \
                and rank == 0:
            peer_server = KVPeerServer(eng.static_lib, port=args.serve_blocks)
        if peer_server is not None:
            print(f"serving KV blocks to peers at {peer_server.address}")
        serve(args, cfg, eng, policies, faults)
    finally:
        if peer_server is not None:
            peer_server.close()
        eng.close()


def _serve_mesh(argv, args, shape, params) -> None:
    """Spawn the mesh's ranks and wait for them (one rank: in this
    process); any rank's failure raises here."""
    data, model = shape
    if model == 0:
        if resolve_device(args.device).type != "cuda":
            raise ValueError("--mesh auto means every visible card; on the "
                             "CPU give --mesh DxM")
        model = max(torch.cuda.device_count() // data, 1)
    world = data * model
    if world == 1:
        _rank_main(0, argv, (1, 1), None, params)
        return
    mp.start_processes(_rank_main, args=(argv, (data, model), free_port(),
                                         params),
                       nprocs=world, join=True, start_method="spawn")


def _rank_main(rank: int, argv, shape: Tuple[int, int], port: Optional[int],
               params) -> None:
    """One rank of ``--mesh``: its process group, its engine over its
    shard and slots, the stream; only rank 0 prints."""
    args = build_parser().parse_args(argv)
    policies = [p.strip() for p in args.policy.split(",") if p.strip()]
    data, model = shape
    if resolve_device(args.device).type == "cpu":
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (data * model)))
    mesh = make_serving_mesh(data, model, device=args.device, rank=rank,
                             init_method=(None if port is None else
                                          f"tcp://127.0.0.1:{port}"))
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else \
        contextlib.nullcontext()
    try:
        with quiet:
            cfg, eng, faults = build(args, params, mesh)
            _run(args, cfg, eng, policies, faults, rank)
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
