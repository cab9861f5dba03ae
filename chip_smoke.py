#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``: the kernels are
built from ``src/repro_torch/csrc`` at first use), and no JAX.  Phases, each
timed on its own line:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build the six CUDA kernels (one ``nvcc`` per source, in parallel);
3. serve full-width llava-1.6-7b (seeded random weights) on a bf16 page
   pool: four two-image MMDU-style dialogues (576-token images, mpic k=32,
   8 new tokens each) plus one MRAG-linked image, through the engine a user
   calls (uploads included); the prefill, decode and dense kernels must
   have launched;
4. the same traffic on an int8 page pool, through the int8 kernels;
5. the same traffic under each of the paper's baselines on a bf16 pool
   (``full_recompute``, ``prefix_caching`` with the system prompt's KV in
   the engine's prefix store, ``full_reuse``, ``cacheblend`` r=0.15), under
   dense ``mpic`` on the engine's dense cache (``paged=False``), and under
   ``cacheblend`` and ``full_recompute`` on an int8 pool; the dense
   selective attention must have launched in every run;
5b. serve full-width mamba2-130m (seeded random weights) through the same
   engine with ``paged=True``, which falls back to its dense cache: the
   four dialogues with their images inlined (no upload) plus one text-only
   request, once under ``full_recompute`` and once under ``mpic`` k=32
   (rewritten to ``full_recompute``); the SSD chunk kernel must have
   launched once per layer of every prefill, every launch on its
   tensor-core route; one mamba2 prefill under ``torch.profiler``; then
   one warm llava paged decode step per pool
   (phase 3's dialogues on a fresh engine, all four slots decoding): three
   on the host clock, one under the profiler (device busy time, the
   decode kernels' device time per call, the top kernels);
5c. phase 3's traffic with its media KV on local disk: the static and
   dynamic libraries spool every block to a temporary directory (removed
   at the end; its free space is printed first) right after its upload,
   so every request's media comes back through the parallel loader.  Four
   runs: a memory-only control on a bf16 pool, then from disk a bf16 pool
   pipelined, the same sequential (``pipelined=False``), and an int8 pool
   fed from a ``quantize=True`` library.  Gates: the disk runs' every
   media lookup is a verified disk hit and the bytes on the card hash to
   their keys; the int8 run links every block from its int8 bytes
   (``direct_links``, no dequantization); the bf16 disk runs give the
   control's greedy tokens and first-token logits within 1e-3; the
   prefill, decode and dense kernels of each pool launched.  A fifth run
   starts cold: fresh libraries rehydrate the bf16 pipelined run's spool
   directories (``KVLibrary(rehydrate=True)``; every spooled block must
   come back, 8 static and 1 dynamic) and serve its traffic with no
   upload, every lookup a verified disk hit, tokens and first-token
   logits equal to the control's exactly.  Printed per
   run: the upload time (spooling included), each request's load busy,
   blocked, compute and overlap ms, TTFT, prefill alone, the decode step
   (and over the steps with a load in flight), and the disk's bytes read
   and the share of read time spent on SHA-1; and the paper's Eq. 1 per
   request (``cache.transfer.plan_transfers`` from where its images lay
   before it was served, a miss costing the least time of its image's
   upload pass): ``parallel_s`` and ``sequential_s`` from ``TIER_BW``'s
   assumed disk rate and from the rate the run's reads reached, beside the
   measured TTFT (printed, not gated);
5f. phase 3's traffic with its media KV pulled from a peer over the
   network tier, in one process: a serving host uploads the eight static
   images into a bf16 library and an int8 one (``quantize=True``), each
   behind a ``KVPeerServer`` on loopback; a receiving host whose static
   library is empty and peered with one of them (``KVLibrary(peers=...)``,
   transports with a 60 s timeout: a 302 MB bf16 block is serialized
   before the answer) serves the traffic on a bf16 pool from the bf16 host
   and on an int8 pool from the int8 host, uploading only the MRAG image.
   Gates: every static lookup a verified network pull (promotes 8, misses
   0), the bytes on the card hash to their keys, no request recomputes an
   image, the int8 run links every block from its int8 bytes, tokens and
   first-token logits (within 1e-3) equal phase 5c's memory control (bf16)
   and int8 library (int8), the pool's prefill and decode kernels and the
   dense kernel launched.  Then the receiving host with no peer (every
   image recomputed), under ``peer.request:blackhole`` (the breaker must
   open and skip) and under ``peer.body:corrupt``: every request finishes,
   every pull is a counted miss, and the tokens equal the no-peer run's.
   Printed per run: TTFT, load, blocked, compute and overlap per request,
   the decode step with pulls in flight, the bytes pulled, the fetch
   seconds and their SHA-1 share, and the network tier's counters;
5h. sessions (``serve_sessions``), on a bf16 and an int8 pool of 4 slots
   of 2048 tokens, phase 3's first dialogue with its images in a library
   that spools to a temporary directory: served uninterrupted, then with
   ``freeze_after=4`` (frozen, spooled at once) and thawed: gates
   ``frozen[:-1] + thawed == uninterrupted`` and the adopted pages (on
   int8 also the scale rows) byte-equal on the card to the pool at
   freeze; a ``full_recompute`` session frozen in memory and thawed with a
   64-token suffix, against a cold ``full_recompute`` of the whole
   history: the same first token and first-token logits within 10 %
   relative RMS (``SESSION_REL_RMS``; the max diff is printed beside
   1e-3); ``fork(handle, 3)``: no page beyond the parent's footprint,
   ``pages_shared`` 3x its pages, ``cow_copies`` 2 after the first decode
   step, greedy children identical, sampled ones (``seed + i``) diverging;
   a second engine whose library peers with the first's ``KVPeerServer``
   (and an empty one) thaws by pulling the salted block, to the first
   thaw's tokens, and a wrong salt raises ``LookupError`` with a 404 from
   every peer; an engine with ``freeze_idle_s`` spools an idle snapshot
   and thaws it from the file.  Printed: freeze (with and without its
   spool), spool, thaw from disk, from memory with the suffix and pulled,
   the suffix's prefill alone beside the cold prefill alone, the
   snapshot's MiB, ``cow_copies`` and ``pages_shared``;
5j. the cluster (``serve_cluster``, after 5h, llava still loaded): an
   ``MPICCluster`` of two replicas over the one llava module, each with a
   pool of 4 slots of 2048 tokens, behind the affinity router, serving
   phase 3's traffic twice (the second round once the first is served, so
   that it finds its images warm), on a bf16 and an int8 pool: (a) clean;
   (b) under ``engine.step:crash`` on ``replica1`` at its second step; (c)
   both rounds at once, the second with a budget of 1 ms.  Gates: every
   request of (a) and (b) (of (c)'s first round) gives phase 3's (phase
   4's) greedy tokens and first-token logits within 1e-3; (b) quarantines
   replica 1 with requeues; (c) reaps a request; after each run every page
   of both pools is free and no pin is held; kernels 1, 3 and 5 (2 and 4 on
   int8) launched.  Printed: routing per replica, warm hits in the second
   round, TTFT and decode step per replica, peak memory.  Then one engine
   with the fleet's slot layout (2 slots) serves the four dialogues without
   the MRAG query: the tokens 5k is held to;
5g. llava's weights freed, the serving CLI as a user starts it, in a
   subprocess: ``python -m repro_torch.launch.serve --arch llava-1.6-7b
   --requests 4 --policy mpic,full_recompute --max-seq-len 2048
   --serve-blocks 0``, once paged and once ``--no-paged``, and the MoE
   ``--arch granite-moe-1b-a400m`` at full width with ``--freeze-idle-s
   30`` (``MOE_CLI_ARGS``).  Gates: exit 0,
   the peer server's address printed, four requests of 8 tokens,
   ``reused`` above 0 under ``mpic`` and 0 under ``full_recompute``.
   Printed: its wall time, and sampled every half second the card's
   memory in use at most (nvidia-smi) and the process's resident memory
   at most.  Then the same command line through a cluster
   (``CLUSTER_CLI_ARGS``: ``--replicas 2 --router affinity --deadline-s
   60``), gated alike and to print each request's replica and no reaped
   request;
5k. the fleet (``serve_fleet``, after 5g; this process holds no model): a
   ``FleetSupervisor`` of two engine host processes at full width on the
   card (2 slots of 2048 tokens, the affinity router, a 60 s peer
   timeout, every block spooled at once): each dialogue's images uploaded
   to one host (the SHA-1 of its first image id), phase 3's dialogues
   routed, the host serving one of them killed at once, its restart and
   warm rejoin awaited (its spool rehydrated) before the requests go out
   again, a second round, a session frozen (spooled) after 4 tokens on
   host 0, host 0 killed and restarted, the handle thawed on host 1
   (pulled from host 0), a drain.  Gates: every result and the resumed
   session equal the tokens of 5j's 2-slot engine (which are phase 3's for
   the first three dialogues; printed); deaths equal the two kills; the
   killed host rehydrates every block it spooled; both hosts exit 0; each
   host's log shows kernels 1, 3 and 5 launched.  Printed: start-up and
   kill-to-rejoin seconds, each request's latency, the bytes pulled
   between hosts, the card's memory in use at each step (nvidia-smi);
5d. serve the GQA decoders at full width (seeded random weights, bf16,
   one model at a time, each freed before the next;
   phase 3's traffic with 576-token images): qwen2.5-14b (G 5, QKV bias)
   under ``mpic`` on both pools, ``mpic`` on the dense cache,
   ``full_recompute``, both chunked (``prefill_chunk_tokens=64``), both
   chunked again with a planted fault (each chunk blind to the K/V of the
   chunk before it), ``mpic`` in one chunk (``prefill_chunk_tokens=512``),
   sampled twice (temperature 0.8, top-k 8, one seed per request) and at
   top-k 1; yi-9b (G 8), phi3-medium-14b (G 4) and stablelm-1.6b (MHA,
   head dim 64) under ``mpic`` on both pools.  Gates: each run's kernels
   launched (the prefill kernel of its pool for monolithic paged ``mpic``,
   the decode kernel of its pool, the dense kernel in the uploads and, more
   often, in the chunked runs); every prefill of a chunked run went
   through ``ChunkedPrefillTask``, in more than one chunk at 64 and in one
   at 512; the one-chunk run's first-token logits equal the dense
   monolithic run's bit for bit; the chunked runs' differ from the
   monolithic run's by at most 10 % relative RMS per request (bf16
   rounding; see ``CHUNK_REL_RMS``), and the faulty runs' by more in every
   request; the two sampled runs give the same tokens and top-k 1 the
   greedy ones.  The peak device memory of each model is printed;
5e. the GQA models freed, serve full-width hymba-1.5b (seeded random bf16
   weights; attention at G 5, head dim 64, a 2048-token window, beside 25
   SSD heads of state 16 in every layer) with ``paged=True``, which lands
   on the dense cache, ``max_seq_len`` 8192: a 6,000-token text request
   first, then phase 3's traffic, under ``mpic`` k=32 (rewritten to
   ``full_recompute``) and under ``full_recompute``.  Gates: every request
   served as ``full_recompute``; kernel 5 launched once a layer in every
   upload, prefill and decode step, kernel 6 once a layer in every upload
   and prefill, every launch on its CUDA-core route, nothing else; the two
   runs' tokens equal.  Then a contiguous prefill of 2w and of 4w tokens
   into exactly that many slots takes ``banded_attend`` in every layer,
   into one slot more the windowed dense attention: last-token logits
   within 10 % relative RMS (``BANDED_REL_RMS``), and a planted fault,
   the band without its window, above it; kernel 5's time for the
   banded call is printed beside the same call with window 0.  The peak
   device memory is printed;
5i. the MoE decoders at full width (``serve_moe``, after 5d's models are
   freed), phase 3's traffic: deepseek-moe-16b (28 layers, MHA at Dh 128,
   64 experts top-6 and 2 shared; ~31 GiB of seeded bf16 weights) under
   ``mpic`` on both pools and ``full_recompute``, then
   granite-moe-1b-a400m (24 layers, G 2 at Dh 64, 32 experts top-8) under
   ``mpic`` on both pools; each run's kernels gated as in 5d, the peak
   device memory printed; after each model one untimed upload and full
   prefill count the (token, choice) pairs capacity dropped in every
   layer (deepseek's upload must drop some, ``MOE_DROP_GATES``); the decode
   step printed beside its least time (``roofline.step_cost``) with every
   expert's weights read and with the routed experts' alone;
5l. whisper-small at full width (``serve_whisper``, after 5e; seeded bf16
   weights, 0.61 GB) on the dense cache: four seeded audio inputs of 1500
   frames encoded at once, their cross K/V put into a cache of 4 rows of
   512 slots, four decoder prompts of 448, 320, 192 and 64 tokens each
   prefilled into its row, then 8 greedy decode steps of all rows
   (``run_whisper``).  Gates: kernel 5 alone launched, on the tensor cores
   once per encoder layer and twice per decoder layer (self, cross) in
   each prefill, on the split keys twice per decoder layer in each decode
   step; every logit finite; each request's prefill and decode logits
   within ``WHISPER_REL_RMS`` of ``Model.forward`` over its prompt and
   generated tokens, and above it when it attends to another request's
   cross K/V (the planted fault).  Printed: encode, cross K/V, each
   prefill, the decode step, peak memory;
5m. the trainer on the card (``train_on_card``): ``python -m
   repro_torch.launch.train --arch stablelm-1.6b --full --steps 30 --ckpt
   ...`` in a subprocess (batch 8, seq 64): exit 0, the reference's lines,
   finite losses, the last logged below the first, the checkpoint written;
   then granite-moe-1b-a400m (batch 8, its capacity drops counted) and
   whisper-small (batch 4, seeded audio frames) at full width for 3 steps
   each through ``train()`` in this process: finite losses, no kernel
   launched, whisper's checkpoint written and loaded back bit-equal.
   Printed: the step time, the card's memory (the subprocess, sampled) or
   the peak allocated (in process).  Only ``layers.attend`` may run here;
   the plain versions still raise;
5n. the SSM and the hybrid trained at full width (``train_ssm_on_card``):
   ``python -m repro_torch.launch.train --arch mamba2-130m --full --steps
   3`` and the same for hymba-1.5b, called in this process (batch 8 x 64,
   one SSD chunk): the reference's lines, finite losses, no kernel
   launched (the SSD runs ``ssd_chunked_train``). Printed: the step time,
   the peak allocated above what was held, the losses;
5o. internvl2-76b tensor-parallel (``serve_tensor_parallel``): with four
   cards or more, four NCCL ranks at full depth, a card each; otherwise two
   gloo ranks on card 0 at 16 of its 80 layers (its setup printed on its
   own line). Each rank, a spawned process, draws its shard of the seeded
   weights (never the whole model), then serves phase 3's traffic with
   256-token images under ``mpic`` and ``full_recompute`` on a bf16 pool
   and ``mpic`` on an int8 pool, ``mpic`` again with a fault planted on
   the last rank (its view of each linked entry one kv head off), and an
   exact check: fp32 weights at full width and 2 layers under ``mpic`` on
   an fp32 and on an int8 pool. Gates: every rank gives the same tokens,
   finite first logits and launches kernels 1/3 (2/4 on int8) and 5, the
   bf16 runs none on the CUDA cores; against the unsharded engine of the
   same depth on the same card (after the ranks exit) the exact checks'
   tokens equal and their first-token logits within 1e-3 (max |diff| over
   max |logit|); the bf16 runs' relative RMS within 1.5 times the floor
   that the unsharded engine shows with its row-parallel products split
   and summed in fp32 as the ranks do, and the planted fault's above it
   (bf16 tokens printed per request, not gated).
   Printed per rank: TTFT, prefill alone, decode step, uploads, peak
   memory, launches by kernel and route; phase 6 adds kernels 1-4 at rank
   0's shard shape (32 query heads on 4 kv heads with two ranks).  Each
   rank records the collectives of its passes; those of its first paged
   decode step and paged prefill in each ``mpic`` run must equal, kind,
   count and bytes, what the dry run's recording mesh counts on ``meta``
   for the same config, rank and shapes (``launch.dryrun.trace_serving``);
5p. the paper's system half on 5o's ranks (``_tp_system``, in the same
   processes after 5o's bf16 runs, on the same weights): a warm memory
   run on each pool, which the tiers are read against; every image
   spooled at its upload (host budget 0) into one directory the ranks
   share, on a bf16 and an int8 pool (rank 0 alone writes); the dialogue
   images pulled from a block server that this process runs over that
   spool once rank 0 reports it whole (rank 0 pulls and writes, the others
   read its files), on both pools; a ``full_recompute`` session frozen
   after 4 tokens and spooled, thawed from disk, thawed with a 64-token
   turn beside a cold recompute, forked into 2; two replicas over the
   mesh (affinity) with an aging queue and a priority a request; rank 1's
   disk reads failing. Gates (``tp_system_check``): the warm memory,
   disk and peer runs' tokens equal each rank's 5o memory run on the same
   pool, exactly; the session's ranks equal, its resume exact, its suffix
   thaw within 10 % relative RMS of the cold run with the same first
   token or a near tie that the run measures (``first_token_tie``), its
   forks identical; the replicas' tokens equal the memory run's, one
   admission order and routing on every rank; the planted fault raising
   ``RankDivergence`` on every rank; kernels 1/3 (2/4) and 5 on each
   rank. Printed per rank: TTFT against the warm memory run, load and
   blocked a request, spool files written and bytes read, the libraries'
   sync a step, the session's freeze, spool, thaw and fork ms and its
   first-token margins, the seconds the phase took;
5q. the families whose routed experts or SSD heads the ``model`` axis cuts
   (``serve_tensor_families``): deepseek-moe-16b at full width and depth
   over two gloo ranks on card 0 (each ~16 GiB: 32 of the 64 experts, 8 of
   the 16 heads, half the shared experts and of the vocabulary; four NCCL
   ranks with four cards) under phase 5o's runs and traffic and the exact
   check in fp32 at 2 layers on both pools, each with a fault planted on
   the last rank (its expert slice one expert early); mamba2-130m (12 of its
   24 SSD heads a rank), hymba-1.5b (its attention and 25 SSD heads whole
   on each rank, the MLP cut) and whisper-small (6 of its 12 heads) over
   two ranks, mamba2 and hymba under ``full_recompute`` on the dense cache
   (hymba's 6,000-token request first), whisper through 5l's pass; then
   each model's unsharded engine on the same card.  Gates: every rank's
   tokens equal and its first logits finite; each model's kernels on
   every rank (deepseek 1/3, 2/4 on int8, and 5; mamba2 6; hymba 5 and 6;
   whisper 5); every bf16 run's first-token logits within 1.5x the floor
   that the unsharded engine shows with its row products, experts'
   combine and shared experts cut as the ranks cut them (the bf16
   fault's reading printed beside it); the exact check's tokens and
   logits within 1e-3, on the fp32 pool the pairs every routing pass
   drops, equal to the unsharded engine's, its fault's logits above
   1e-3; each rank's
   live collectives of its first prefill and decode pass equal to the dry
   run's recording.  Printed per rank and for the unsharded engine: TTFT,
   prefill alone, decode step, peak memory, each step's least time and
   roofline share; deepseek's experts' all-reduce timed alone;
5r. the ``data`` axis of the serving mesh (``serve_data_axis``):
   llava-1.6-7b at full width and depth on ``data 2 x model 2``, four
   gloo ranks on card 0 (each ~6.3 GiB: half the heads, the MLP and the
   vocabulary; NCCL with four cards), each decoding 2 of the 4 slots of
   5o's traffic (the prefills on every data rank, the paged pool whole
   over ``data``, every decode step's new K/V rows and logits gathered
   over ``data``) under ``TP_RUNS`` and the exact check in fp32 at 2
   layers on both pools, with a fault planted on data rank 1 (its gather
   of the rows one slot off); then the dry run's long decode
   (``specs.make_step_fn("decode")``) on a seeded ring of llava's
   8,192-slot window, 4,096 slots a data rank, 8 steps past the wrap
   (seeded tokens fed), its attention merged over ``data`` through kernel 5's
   log-sum-exp, in bf16 and in fp32 at 2 layers (with a second fault on
   data rank 1: its log-sum-exp one more than it is); hymba-1.5b on
   ``data 2 x model 1`` (the dense cache's two rows a rank) under
   ``full_recompute``; then each model unsharded on the same card.
   Gates: every rank's tokens equal and first logits finite; each data
   rank's pool digest (and int8 scales) equal to its data peer's, and
   the row fault's different; the exact checks' tokens and logits
   within 1e-3 of the unsharded engine's; the bf16 runs within 1.5x the
   floor (the unsharded engine with its row products split as the ranks
   split them; the long decode's floor also splits the ring in 2 and
   merges through the log-sum-exp in one process; hymba's runs the
   ranks' products on model 1); the long decode in fp32 within 1e-3 and
   the log-sum-exp fault above it; kernels 1/3 (2/4) and 5 on each
   llava rank, 5 on the split route in the long decode, 5 and 6 on each
   hymba rank; each rank's live collectives of its first paged decode
   step and prefill, and of the long decode's first step, equal to the
   dry run's recording (kind, axis, group, count, bytes).  Printed per
   rank: slots, TTFT, prefill alone, decode step, the data gathers'
   bytes and ms a step, peak memory, each step's least time (phase 8),
   the long decode's step; the same for the unsharded engines; phase 6
   adds kernel 5 with its log-sum-exp at the long decode's rank slice
   (1 query, 16 heads, 4,096 keys), timed beside SDPA and its bound;
6. each kernel against its plain PyTorch version on the state phases 3-5b
   left (layer 0 of the live pool or the captured dense-attention and SSD
   inputs) and on synthetic shapes (32 query heads on 8 kv heads, window
   64; the paged prefill and decode on both pools in fp32 and in bf16 (the
   prefill's bf16 calls run its tensor-core kernel); the dense selective
   attention in bf16 through its tensor-core route (Sq 101) and its
   split-key route (Sq 1), and in fp32 through the CUDA cores; the registers,
   shared memory, spills and resident blocks per SM of the bf16 prefill
   kernel, of every decode kernel instantiation and of every bf16 dense
   instantiation are printed, and a spill fails; the SSD chunk at the JAX
   package's test shapes, Q = 128, pad rows and a large dt, on the captured
   live inputs of the dialogues (21 chunks) and of the text request (6),
   with the registers, shared memory, spills and blocks per SM of every
   SSD instantiation), then timed beside its plain version, a PyTorch
   yardstick where one exists and its bound; the dense attention prints the
   route each of its four main-path shapes took; every kernel's device time
   a call comes from ``torch.profiler`` beside the CUDA-event times (the
   paged prefill's and the dense attention's beside SDPA's, the SSD chunk's
   at both live shapes beside its CUDA-core route, the first port's
   kernel); the limit is per element
   (``repro_torch/kernels/check.py``): one bf16 ulp of the value for bf16
   outputs, 1e-4 for fp32 ones, 1e-4 + 1e-4 |ref| for the SSD chunk; each
   bound from ``repro_torch.roofline``'s kernel costs;
   kernels 1-5 also at each GQA model's layer-0 shapes from phase 5d
   (qwen2.5-14b G 5, yi-9b G 8, phi3-medium-14b G 4, stablelm-1.6b G 1 at
   head dim 64: both pools' prefill and decode and the upload on the
   tensor cores; qwen's dense mpic prefill and 64-token chunk on the
   tensor cores and its dense decode step on the split keys), each with
   its device time, bound and SDPA's time; kernel 5 at hymba-1.5b's
   upload, long prefill and decode step (the window biting in the last
   two), kernel 6 on the CUDA-core route at hymba's captured dialogue and
   long-request inputs, with the resources of its (Q 64, hd 64, ds 16)
   instantiation; kernels 1-5 at deepseek-moe-16b's and
   granite-moe-1b-a400m's layer-0 shapes (both pools' prefill and decode,
   the upload); kernel 5 at whisper-small's layer-0 shapes from 5l (the
   encoder's 1500 x 1500 with every query at the last frame's position
   and the first prefill's self and cross on the tensor cores, a decode
   step's self and cross on the split keys), each with its device time,
   bound and SDPA's time; and at phase 5q's rank 0: kernels 1-4 at
   deepseek's 8 kv heads (G 1), kernel 5 at whisper's 6 heads, kernel 6
   at mamba2's 12 heads on the tensor cores;
7. a small fp32 model served by the same engine on the card and on the CPU
   (plain versions) under every policy and on the dense cache, and under
   ``mpic`` with its media on disk and pipelined admission on both pools,
   and the small fp32 mamba2 under ``full_recompute`` and ``mpic``: same
   greedy tokens, first-token logits within 1e-3 (the int8 pool with its
   media in memory: within 5e-2, tokens printed); then qwen2.5-14b's
   smoke config at G 5 (10 query heads on 2 kv heads) with nonzero QKV
   biases under ``mpic`` on both pools, chunked ``mpic`` and
   ``full_recompute`` and seeded sampling, and hymba-1.5b's smoke config
   at G 5 under ``full_recompute`` and ``mpic`` (rewritten) with an MRAG
   image of two windows uploaded through ``banded_attend``, card against
   CPU alike; the smoke deepseek-moe-16b in fp32 under ``mpic`` on both
   pools and ``full_recompute`` (its prompts pass T = 64: the card's runs
   must drop pairs); a freeze / thaw / suffix thaw / fork round on the
   smoke llava in fp32 (same tokens, suffix first-token logits within
   1e-3, ``cow_copies`` 1); whisper-small's smoke config in fp32 through
   5l's pass (same tokens, logits within 1e-3); and three train steps of
   the smoke yi-9b and whisper-small in fp32 from the same weights on the
   same batches (losses within 1e-4 relative), and so mamba2-130m and
   hymba-1.5b (hymba at 128 tokens, two smoke windows: the band);
8. every step an earlier phase timed beside its least time on this card
   (``repro_torch.roofline``: the larger of its operations over the bf16
   peak, its bytes over HBM's rate and its collectives over NVLink's; the
   least work of the passes each serving run recorded: real rows only,
   each query's visible keys, a MoE's routed experts, and the weights and
   KV once a step: once for a request's whole prefill, however many
   passes or chunks it ran), what bounds it, ``roofline_share`` and
   ``mfu``, and the host time the recording itself took inside each
   measured step (its share printed), with the
   card's name and power limit: llava's prefill and decode step per policy
   and pool (3-5), mamba2's (5b, and its profiled prefill), each GQA and
   MoE model's (5d, 5i), hymba's (5e), whisper's encode, cross K/V,
   prefills and decode step (5l), the training steps (5m, 5n), each
   rank's prefill and decode step (5o, 5q; the ranks' work adds up on a
   card they share).  A share above 1.05 fails the run, naming the step (the
   count would overstate the work).  Then ``python -m
   repro_torch.launch.dryrun --serving-selftest`` and ``--arch
   internvl2-76b --shape decode_32k`` in subprocesses: exit 0, and the
   card's memory in use no higher while they run.

During the serving phases the plain versions and ``layers.attend`` raise
if called.  Each serving run resets the kernels' launch counts (and the
dense attention's count per route) before its uploads and reads them after
its last request; a run whose dense attention took the CUDA cores, a
mamba2 run whose SSD chunk did, or a hymba run whose SSD chunk did not,
fails.  It prints one JSON line
``{"kernels": [...]}``, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the last line.  Without a card it exits 2.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import os
import pickle
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

K_MPIC = 32
MAX_NEW = 8
KERNEL_FILES = {
    "sel_attn": ("src/repro_torch/csrc/selective_attn.cu",
                 "src/repro/kernels/selective_attn/selective_attn.py:30"),
    "sel_attn_paged": ("src/repro_torch/csrc/selective_attn.cu",
                       "src/repro/kernels/selective_attn/selective_attn.py:77"),
    "sel_attn_paged_q8": ("src/repro_torch/csrc/selective_attn.cu",
                          "src/repro/kernels/selective_attn/selective_attn.py:127"),
    "paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                   "src/repro/kernels/paged_attn/paged_attn.py:22"),
    "paged_attn_q8": ("src/repro_torch/csrc/paged_attn.cu",
                      "src/repro/kernels/paged_attn/paged_attn.py:70"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk/ssd_chunk.py:19"),
}
TOLERANCE = ("per element: bf16 one ulp of max(|out|,|ref|) + 2^-17 max|V|, "
             "fp32 1e-4 (repro_torch/kernels/check.py)")
LIBRARY_CALL = ("torch.nn.functional.scaled_dot_product_attention over K/V "
                "gathered (and dequantized) beforehand, gather excluded")
DENSE_LIBRARY_CALL = ("torch.nn.functional.scaled_dot_product_attention "
                      "with a boolean mask built from the positions "
                      "beforehand (K/V repeated to the query heads for GQA)")
SSD_TOLERANCE = ("per element: fp32 1e-4 + 1e-4 |ref| "
                 "(repro_torch/kernels/check.py ssd_limit)")
SSD_LIBRARY_CALL = ("none: no single PyTorch call computes this function "
                    "(the plain version is five einsums and a cumsum)")
MEDIA_LEN = 576                           # llava's tokens per image
GQA_ARCHS = ("qwen2.5-14b", "yi-9b", "phi3-medium-14b", "stablelm-1.6b")
GQA_CHUNK = 64                            # prefill_chunk_tokens of 5d
# a chunk larger than every mpic selection (210-233 tokens) but not than
# the prompts (1298-1321): each mpic prefill runs as one chunk of
# ChunkedPrefillTask, which must equal the monolithic dense run bit for bit
GQA_ONE_CHUNK = 512
SAMPLED = {"greedy": False, "temperature": 0.8, "top_k": 8}
SEEDS = [11, 12, 13, 14]
# chunked against monolithic first-token logits, as the RMS of their
# difference over the RMS of the logits, per request.  Chunking changes
# which rows share a matrix product and an attention tile, so only the
# bf16 rounding of the activations, which 48 layers of random weights
# amplify to a few per cent (2.0-2.9 %); the one-chunk run shows that the
# chunked path adds nothing else.  A planted fault, each chunk blind to
# the K/V of the chunk before it (see hide_previous_chunk), must read
# above the limit in every request: both sides are printed
CHUNK_REL_RMS = 0.1
HYMBA = "hymba-1.5b"
HYMBA_SEQ = 8192                          # max_seq_len of phase 5e
HYMBA_LONG = 6000                         # text tokens of its long request
# banded against windowed last-token logits (phase 5e), as the RMS of their
# difference over the RMS of the windowed ones: one function of the same
# inputs through one kernel, the banded call over the fresh K/V and the
# windowed one over the cache's slots (one empty slot more), so at most the
# sum order inside the kernel may differ, which 32 layers of bf16
# activations amplify as they amplify chunking's (CHUNK_REL_RMS); a band
# that drops keys a query sees moves the logits by far more
BANDED_REL_RMS = 0.1
# runs served with that planted fault, and the sound run each is held to
BLIND_RUNS = {"qwen2.5-14b:mpic_chunked_blind": "qwen2.5-14b:mpic",
              "qwen2.5-14b:full_recompute_chunked_blind":
                  "qwen2.5-14b:full_recompute"}


def _gqa_runs(arch: str) -> list:
    """(label, policy, kwargs, pool dtype, paged, engine kwargs, seeds) of
    the phase-5d runs of one model: qwen2.5-14b under mpic on both pools,
    mpic on the dense cache (its dense prefill and decode are phase 6's
    G-5 inputs of the dense kernel, and its first logits the one-chunk
    run's reference), full_recompute, both chunked, both chunked with the
    planted fault, mpic in one chunk, sampled twice and at top_k 1; the
    other three under mpic on both pools."""
    mpic = {"k": K_MPIC}
    runs = [(f"{arch}:mpic", "mpic", mpic, "", True, None, None),
            (f"{arch}:mpic_int8", "mpic", mpic, "int8", True, None, None)]
    if arch != "qwen2.5-14b":
        return runs
    chunk = {"prefill_chunk_tokens": GQA_CHUNK}
    return runs + [
        (f"{arch}:mpic_dense", "mpic", mpic, "", False, None, None),
        (f"{arch}:full_recompute", "full_recompute", {}, "", True, None,
         None),
        (f"{arch}:mpic_chunked", "mpic", mpic, "", True, chunk, None),
        (f"{arch}:full_recompute_chunked", "full_recompute", {}, "", True,
         chunk, None),
        (f"{arch}:mpic_chunked_blind", "mpic", mpic, "", True, chunk, None),
        (f"{arch}:full_recompute_chunked_blind", "full_recompute", {}, "",
         True, chunk, None),
        (f"{arch}:mpic_one_chunk", "mpic", mpic, "", True,
         {"prefill_chunk_tokens": GQA_ONE_CHUNK}, None),
        (f"{arch}:sampled_a", "mpic", mpic, "", True, SAMPLED, SEEDS),
        (f"{arch}:sampled_b", "mpic", mpic, "", True, SAMPLED, SEEDS),
        (f"{arch}:top_k1", "mpic", mpic, "", True, {**SAMPLED, "top_k": 1},
         SEEDS)]


MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m")


def _moe_runs(arch: str) -> list:
    """The phase-5i runs of one MoE model, in ``_gqa_runs``'s form: mpic on
    both pools, and for deepseek-moe-16b full_recompute too."""
    mpic = {"k": K_MPIC}
    runs = [(f"{arch}:mpic", "mpic", mpic, "", True, None, None),
            (f"{arch}:mpic_int8", "mpic", mpic, "int8", True, None, None)]
    if arch == "deepseek-moe-16b":
        runs.append((f"{arch}:full_recompute", "full_recompute", {}, "",
                     True, None, None))
    return runs


# phase 5h: a session frozen after this many tokens, and the next turn's
# suffix its thaw prefills
SESSION_FREEZE_AFTER = 4
SESSION_SUFFIX = 64
# the suffix thaw against a cold recompute of the whole history: the same
# first greedy token and first-token logits within 10 % relative RMS (the
# chunked gate's limit) on both pools.  The snapshot's last tokens were
# written by decode steps and its suffix attends through the paged kernel,
# the cold pass computes all of them in one dense prefill, so on bf16 the
# two differ by bf16 rounding, which layers of random weights amplify
# (smoke llava on the CPU: 4.0e-3 max, 3.6e-3 relative RMS; in fp32 both
# agree within 1e-3, phase 7 and tests/test_torch_sessions.py); on int8
# the thawed pages and the cold pass's were also requantized at different
# writes.  Both sides are printed beside 1e-3
SESSION_REL_RMS = 0.1

# layer 0's dense-attention inputs that phase 6 holds against the plain
# version at each model's own shapes: run label -> {kind of call: name}
# (see capture_dense); every model's upload, and qwen2.5-14b's dense
# prefill and decode and a 64-token chunk
GQA_CAPTURES = {
    **{f"{arch}:mpic": {"upload": f"{arch}:upload"} for arch in GQA_ARCHS},
    "qwen2.5-14b:mpic_dense": {"prefill": "qwen2.5-14b:dense_mpic",
                               "decode": "qwen2.5-14b:dense_decode"},
    "qwen2.5-14b:mpic_chunked": {"prefill": "qwen2.5-14b:chunk"},
}

GQA_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_abs_err", "worst", "route", "shape",
            "window0_ms", "window0_device_ms", "rel_rms",
            "rel_rms_unbanded_fault")
# layer 0's dense-attention inputs of hymba's first run (mpic, served as
# full_recompute; its long request first): kind of call -> name
HYMBA_CAPTURES = {"upload": f"{HYMBA}:upload",
                  "prefill": f"{HYMBA}:long_prefill",
                  "decode": f"{HYMBA}:dense_decode"}
GQA_RUNS = [(arch, _gqa_runs(arch)) for arch in GQA_ARCHS]
MOE_RUNS = [(arch, _moe_runs(arch)) for arch in MOE_ARCHS]
MOE_CAPTURES = {f"{arch}:mpic": {"upload": f"{arch}:upload"}
                for arch in MOE_ARCHS}
# (model, pass) whose capacity must drop pairs: deepseek's upload routes
# 576 rows into 67 slots an expert for a mean load of 54; the other
# counts are printed
MOE_DROP_GATES = {("deepseek-moe-16b", "upload")}
# (name, policy, policy kwargs, pool dtype, paged) of the phase-5 runs
POLICY_RUNS = [
    ("full_recompute", "full_recompute", {}, "", True),
    ("prefix_caching", "prefix_caching", {}, "", True),
    ("full_reuse", "full_reuse", {}, "", True),
    ("cacheblend", "cacheblend", {"r": 0.15}, "", True),
    ("mpic_dense", "mpic", {"k": K_MPIC}, "", False),
    ("cacheblend_int8", "cacheblend", {"r": 0.15}, "int8", True),
    ("full_recompute_int8", "full_recompute", {}, "int8", True),
]
# (name, pool dtype, library quantize, pipelined, media spooled to disk,
# run whose spool directory a cold library rehydrates instead of uploading)
# of the phase-5c runs; the memory-only control first
DISK_RUNS = [
    ("memory_bf16", "", False, True, False, None),
    ("disk_bf16", "", False, True, True, None),
    ("disk_bf16_sequential", "", False, False, True, None),
    ("disk_int8", "int8", True, True, True, None),
    ("disk_bf16_rehydrated", "", False, True, True, "disk_bf16"),
]
# (name, pool dtype, the serving host pulled from, fault plan) of the
# phase-5f runs: the fault runs after the no-peer run they are held to
NET_RUNS = [
    ("net_bf16", "", "bf16", ""),
    ("net_int8", "int8", "int8", ""),
    ("net_none", "", None, ""),
    ("net_blackhole", "", "bf16", "peer.request:blackhole:delay=0.05"),
    ("net_corrupt", "", "bf16", "peer.body:corrupt"),
]
# the transports' timeout: it runs per socket operation, and the serving
# host answers only once it has serialized a 302 MB bf16 block (the
# reference's 2 s default was set for 24-token blocks); a blackhole waits
# its rule's delay instead
NET_TIMEOUT_S = 60.0
# phase 5g's command line, run once paged and once with --no-paged, and
# the MoE granite-moe-1b-a400m's, with the idle sweep on
CLI_ARGS = ["--arch", "llava-1.6-7b", "--requests", "4", "--policy",
            "mpic,full_recompute", "--max-seq-len", "2048",
            "--serve-blocks", "0"]
MOE_CLI_ARGS = ["--arch", "granite-moe-1b-a400m", "--requests", "4",
                "--policy", "mpic,full_recompute", "--max-seq-len", "2048",
                "--serve-blocks", "0", "--freeze-idle-s", "30"]
# and through a cluster of two replicas, every request with a budget
CLUSTER_CLI_ARGS = [*CLI_ARGS, "--replicas", "2", "--router", "affinity",
                    "--deadline-s", "60"]
# phase 5j: each replica's pool (phase 3's), the crash of run (b) (replica
# 1 at its second step, after its first prefill), and the budget of run
# (c)'s second round, which waits behind the first round's prefills
CLUSTER_SLOTS = 4
CLUSTER_CRASH = "engine.step:crash:target=replica1,start=1"
CLUSTER_DEADLINE_S = 1e-3
# phase 5k: each host's decode slots, the freeze point of its session, and
# the seconds a host may take to start (a full-width model's weights)
FLEET_SLOTS = 2
FLEET_FREEZE_AFTER = 4
FLEET_START_S = 600.0
# phase 5l: whisper-small's decoder prompts (at most its 448-token
# context), each prefilled into its own row of a dense cache of this many
# slots, beside four seeded audio inputs of 1500 frames
WHISPER = "whisper-small"
WHISPER_PROMPTS = (448, 320, 192, 64)
WHISPER_KV_LEN = 512
# each request's prefill and decode logits against Model.forward over its
# prompt and generated tokens, as the RMS of their difference over the RMS
# of forward's: kernel 5 on both sides, the decode step on its split-key
# route where forward takes the tensor cores, so only the order of bf16
# work differs (the same passes in bf16 against fp32 read ~1 % on the
# CPU); a request attending to another request's cross K/V (the planted
# fault, run_whisper's cross_of) reads ~72 % on the CPU
WHISPER_REL_RMS = 0.05
# phase 5m: the trainer's command line (batch 8, seq 64 by default)
TRAIN_ARGS = ["--arch", "stablelm-1.6b", "--full", "--steps", "30"]
# (arch, steps, batch) of 5m's in-process full-width runs through train()
TRAIN_RUNS = (("granite-moe-1b-a400m", 3, 8), (WHISPER, 3, 4))
TRAIN_SEQ = 64
# phase 5n: the SSM and the hybrid trained at full width through the
# launcher (batch 8, seq 64: one SSD chunk), and phase 7's small fp32
# train steps per arch (hymba at two smoke windows: the band)
SSM_TRAIN_ARCHS = ("mamba2-130m", HYMBA)
SSM_TRAIN_STEPS = 3
SMALL_TRAIN_SEQ = {HYMBA: 128}
# phase 5o: internvl2-76b tensor-parallel; with fewer than 4 cards two gloo
# ranks share card 0 at TP_DEPTH layers, then the unsharded engine of the
# same depth serves the same traffic on the same card
TP_ARCH = "internvl2-76b"
TP_DEPTH = 16
TP_MEDIA_LEN = 256
TP_RUNS = (("mpic", ""), ("full_recompute", ""), ("mpic", "int8"))
TP_LABELS = tuple(f"{p}-{pool or 'bf16'}" for p, pool in TP_RUNS)
# the bf16 runs' first-token logits against the unsharded engine's, as
# relative RMS: the ranks' fp32 partial sums add in another order than one
# product's, a bf16 value now and then rounds the other way, and through
# 16 layers of seeded weights that alone moves the logits by ~1-2e-2;
# greedy tokens then part where two logits lie that close.  The run
# measures that floor itself (the unsharded engine with its row products
# split in the ranks' halves, mpic) and holds every bf16 run within
# TP_FLOOR_FACTOR times it; a fault planted on the last rank (its view of
# each linked entry one kv head off, TP_FAULT) must read above that
# limit.  The exact check runs fp32 weights on an fp32 and an int8 pool
# (TP_FP32_POOLS) at full width and TP_FP32_DEPTH layers: the same
# tokens, logits within TP_FP32_REL (max |diff| over max |logit|)
TP_FLOOR_FACTOR = 1.5
TP_FAULT = "mpic-bf16-fault"
TP_FP32_DEPTH = 2
TP_FP32_POOLS = ("", "int8")
TP_FP32_REL = 1e-3
TP_JOIN_S = 900.0
# phase 5p: the paper's system half on 5o's ranks, weights and shape.
# Every image spooled (host budget 0) into one directory the ranks share,
# on both pools; the dialogue images pulled from a block server that this
# process runs over that spool (rank 0 pulls, the others read what it
# writes); a session frozen after SESSION_FREEZE_AFTER tokens and spooled,
# thawed from disk, thawed again with a TP_SUFFIX-token turn, forked into
# TP_FORKS; two replicas (affinity) with an aging queue (TP_AGING_S, one
# priority a request from TP_PRIORITIES); rank 1's own disk reads failing
# (TP_READ_FAULT), which must raise on every rank
TP_SUFFIX = 64
TP_FORKS = 2
# the suffix thaw's first greedy token against the cold recompute's: the
# same, or a near tie, which the run reads from its own logits: where the
# two runs' top tokens a (cold) and b (thawed) differ, the gap between
# them moved by (cold[a] - cold[b]) + (thawed[b] - thawed[a]), and that
# move is a tie when it is no larger than TP_TIE_SIGMAS times the spread
# of the same difference over two tokens taken at random (sqrt(2) times
# the RMS of thawed - cold over the vocabulary).  A fault that moves the
# logits moves that floor with them, and the relative RMS gate still holds
TP_TIE_SIGMAS = 3.0
TP_AGING_S = 0.5
TP_PRIORITIES = (0, 2, 1, 0)
TP_READ_FAULT = "disk.read:io_error"
TP_PEER_TIMEOUT_S = 60.0
# phase 5q: the families whose routed experts or SSD heads the model axis
# cuts, at full width, each on its ranks and then unsharded on the same
# card once the ranks have exited.  deepseek-moe-16b at full depth (28
# layers, 31.45 GiB of bf16 weights): two gloo ranks of ~16 GiB on one
# card (32 of its 64 experts and 8 of its 16 heads a rank), four NCCL
# ranks with four cards; TP_RUNS with 5o's traffic and the exact check in
# fp32 at TP_FP32_DEPTH layers on both pools (the same tokens, first-token
# logits within TP_FP32_REL; on the fp32 pool the same pairs dropped by
# every routing pass: an int8 pool's rounding of K/V that differ in their
# last fp32 bits can move a pair across its expert's capacity), each with
# a planted fault (TQ_FAULT, TQ_FAULT_FP32: the last rank's expert slice
# one expert early, so that it adds another rank's expert's pairs with
# its own weights and leaves its last expert's unserved).  At 28 layers
# the bf16 floor is most of the distance between unrelated logits (a
# bf16 rounding that moves one routing choice moves which pairs the
# capacity drops, and that cascades), so the fault is gated in the exact
# check, where the limit is TP_FP32_REL, and its bf16 reading is printed
# beside the bf16 limit.  mamba2-130m (12 of its 24
# SSD heads a rank), hymba-1.5b (its 5 kv heads and 25 SSD heads do not
# divide: attention and the SSM whole on each rank, the MLP cut) and
# whisper-small (6 of its 12 heads, encoder and decoder) on two ranks:
# mamba2 and hymba full_recompute on the dense cache (hymba's HYMBA_LONG
# request first), whisper run_whisper's four 1500-frame inputs.  The bf16
# runs are held within TP_FLOOR_FACTOR times the floor the unsharded
# engine shows with its row products, its experts' combine and its shared
# experts cut as the ranks cut them (``_split_plan``)
TQ_MOE = "deepseek-moe-16b"
TQ_SSM = ("mamba2-130m", HYMBA)
TQ_ARCHS = (TQ_MOE, *TQ_SSM, WHISPER)
TQ_FAULT = "mpic-bf16-fault"
TQ_FAULT_FP32 = "mpic-fp32-fault"
# the experts' all-reduce timed alone on the ranks: (2, rows, d_model) fp32
# (the routed and the shared partial sums) for a 4-slot decode step and a
# 1024-row prefill, TQ_COLL_ITERS calls after three warm ones
TQ_COLL_ROWS = (4, 1024)
TQ_COLL_ITERS = 20
TQ_SEQ = {HYMBA: HYMBA_SEQ}
TQ_SMALL_WORLD = 2
# phase 5r: the data axis of the serving mesh.  llava-1.6-7b at full width
# and depth on data 2 x model 2: four ranks (gloo on one card, each ~6.3
# GiB of weights: half the heads, the MLP and the vocabulary; NCCL with
# four cards), each decoding 2 of the 4 slots of 5o's traffic with the
# prefills on every data rank and the paged pool whole over data; TP_RUNS
# and the exact check in fp32 at TP_FP32_DEPTH layers on both pools, then
# the dry run's long decode (specs.make_step_fn("decode")) on a ring of
# llava's 8,192-slot window, 4,096 slots a data rank, TR_LONG_STEPS steps
# TR_LONG_PAST positions past the wrap (each fed a seeded token, the same
# in every run), in bf16 and in fp32 at
# TP_FP32_DEPTH layers.  Planted faults, both on data rank 1 and both in
# the fp32 runs: its gather of the slots' new K/V rows one slot off
# (TR_ROW_FAULT: its pool must then differ from its data peer's), its
# log-sum-exp one more than it is before the long decode's merge
# (TR_LSE_FAULT: the logits must then read above TP_FP32_REL).
# hymba-1.5b on data 2 x model 1: the dense cache cut on its batch, two
# slots' rows a rank, full_recompute on 5q's four dialogues
TR_ARCH = "llava-1.6-7b"
TR_SHAPE = (2, 2)
TR_SSM_SHAPE = (2, 1)
TR_LONG_SEQ = 40000                 # past 32k tokens: the ring of the window
TR_LONG_PAST = 100
TR_LONG_STEPS = 8
TR_ROW_FAULT = "mpic-fp32-rowfault"
TR_LSE_FAULT = 1.0


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_memory_mib() -> int:
    """Device memory in use on the card, every process's (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return int(out.stdout.split()[0])


def rss_mib(pid: int) -> float:
    """A live process's resident memory (``/proc/<pid>/statm``), 0 once it
    is gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return 0.0
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def run_watched(cmd, env, timeout_s: float):
    """Run ``cmd`` from the checkout's root, sampling the card's memory in
    use and the process's resident memory every half second.  Returns the
    exit code, stdout, stderr, wall seconds and the two sampled maxima
    (MiB); kills the process and raises past ``timeout_s``."""
    with tempfile.TemporaryFile("w+") as fo, \
            tempfile.TemporaryFile("w+") as fe:
        t = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, env=env,
                                cwd=ROOT, text=True)
        card_mib, rss_max, sampled = 0, 0.0, 0.0
        try:
            while proc.poll() is None:
                now = time.perf_counter()
                if now - t > timeout_s:
                    raise RuntimeError(f"{cmd} ran over {timeout_s} s")
                if now - sampled >= 0.5:
                    card_mib = max(card_mib, card_memory_mib())
                    rss_max, sampled = max(rss_max, rss_mib(proc.pid)), now
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t
        fo.seek(0)
        fe.seek(0)
        return proc.returncode, fo.read(), fe.read(), wall, card_mib, rss_max


# -- phase 8: the least time of every step the card times -----------------
# (module level: the tensor-parallel ranks of phase 5o record their passes
# too)

@contextlib.contextmanager
def recording_passes(into, idle_pos=None, mesh=None):
    """Keep in ``into`` one record per serving pass run inside the block:
    its kind (``"decode"``: a paged decode step or ``Model.decode_step``;
    else ``"prefill"``), the request whose prefill runs it (an engine's
    ``_begin_prefill`` or a chunk's ``ChunkedPrefillTask.advance``; None
    outside both), the config the weights have (and a tensor-parallel
    rank's widths and routed experts), and what decides its least
    work (the queries' positions, the valid lengths or the dense cache's
    positions after the pass's writes, the pool's dtype, whether it
    computed logits, and a MoE's routing: each layer's expert choices),
    and with a live ``mesh`` the collectives it ran (those since the pass
    before: the pass's embedding runs just before it).  Inside the timed
    window the recording clones only the small position tensors (the
    routing is held, not copied); :func:`pass_costs` reads them after the
    run.  Each record's ``record_s`` is the host time the recording spent
    on that pass.  ``idle_pos`` is the position at which the engine's idle
    dense slots decode (``max_seq_len - 1``)."""
    import repro_torch.models.moe as moe_mod
    import repro_torch.models.transformer as tf
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import MPICEngine
    from repro_torch.serving.scheduler import ChunkedPrefillTask

    clock = time.perf_counter
    real = (tf.forward_with_cache, tf.selective_prefill_paged,
            tf.decode_paged, moe_mod.route, Model.decode_step,
            MPICEngine._begin_prefill, ChunkedPrefillTask.advance)
    current, seen, decoding, request = [None], [0], [False], [None]

    def run(rec, t0, fn, params, *args, **kwargs):
        rec["routes"], rec["req"] = [], request[0]
        sh = params.sharding
        if sh is not None:
            rec["widths"], rec["expert_range"] = sh.widths, sh.expert_range
        into.append(rec)
        current[0] = rec
        rec["record_s"] = clock() - t0
        try:
            return fn(params, *args, **kwargs)
        finally:
            t1 = clock()
            current[0] = None
            rec["calls"] = stream[seen[0]:]
            seen[0] = len(stream)
            rec["record_s"] += clock() - t1

    def decode_step(self, *args, **kwargs):
        decoding[0] = True
        try:
            return real[4](self, *args, **kwargs)
        finally:
            decoding[0] = False

    def prefilling(req_id, fn, *args):
        outer, request[0] = request[0], req_id
        try:
            return fn(*args)
        finally:
            request[0] = outer

    def dense(params, cfg, embeds, positions, cache, write_idx, **kw):
        t0 = clock()
        rec = {"kind": "decode" if decoding[0] else "prefill",
               "cfg": cfg, "q_pos": positions.clone(), "int8": False,
               "window": kw.get("window"), "logits": kw.get("logits", True),
               "idle_pos": idle_pos}
        out = run(rec, t0, real[0], params, cfg, embeds, positions, cache,
                  write_idx, **kw)
        t1 = clock()
        if "pos" in cache:
            # held, not copied: it names the cache the pass wrote
            rec["cache"] = cache["pos"]
            rec["kv_pos"] = cache["pos"].clone()
        rec["record_s"] += clock() - t1
        return out

    def paged_prefill(params, cfg, embeds, sel_positions, pool_k, pool_v,
                      page_table, lengths, *args, **kw):
        t0 = clock()
        return run({"kind": "prefill", "cfg": cfg,
                    "q_pos": sel_positions.clone(),
                    "lengths": lengths.clone(), "page_size": pool_k.shape[1],
                    "int8": pool_k.element_size() == 1, "logits": True},
                   t0, real[1], params, cfg, embeds, sel_positions, pool_k,
                   pool_v, page_table, lengths, *args, **kw)

    def paged_decode(params, cfg, embeds, positions, pool_k, pool_v,
                     page_table, lengths, *args, **kw):
        t0 = clock()
        return run({"kind": "decode", "cfg": cfg, "lengths": lengths.clone(),
                    "page_size": pool_k.shape[1],
                    "int8": pool_k.element_size() == 1, "logits": True},
                   t0, real[2], params, cfg, embeds, positions, pool_k,
                   pool_v, page_table, lengths, *args, **kw)

    def route(*args, **kwargs):
        out = real[3](*args, **kwargs)
        if current[0] is not None:
            t0 = clock()
            current[0]["routes"].append(out[1])     # a new tensor a call
            current[0]["record_s"] += clock() - t0
        return out

    def begin_prefill(self, req, *args):
        return prefilling(req.req_id, real[5], self, req, *args)

    def advance(self):
        return prefilling(self.req.req_id, real[6], self)

    (tf.forward_with_cache, tf.selective_prefill_paged, tf.decode_paged,
     moe_mod.route, Model.decode_step, MPICEngine._begin_prefill,
     ChunkedPrefillTask.advance) = (dense, paged_prefill, paged_decode,
                                    route, decode_step, begin_prefill,
                                    advance)
    try:
        with (record_collectives(mesh) if mesh is not None
              else contextlib.nullcontext([])) as stream:
            yield into
    finally:
        (tf.forward_with_cache, tf.selective_prefill_paged, tf.decode_paged,
         moe_mod.route, Model.decode_step, MPICEngine._begin_prefill,
         ChunkedPrefillTask.advance) = real


def collective_record_s() -> float:
    """Host seconds that ``record_collectives`` adds to one collective:
    20,000 calls on a one-rank mesh (its collectives are the identity)
    with and without the recording, the best of three each, the
    difference a call."""
    n = 20000
    import torch

    from repro_torch.launch.mesh import ServingMesh, record_collectives
    mesh = ServingMesh(data=1, model=1, rank=0, backend="gloo",
                       device=torch.device("cpu"))
    x = torch.zeros(8)

    def calls():
        t = time.perf_counter()
        for _ in range(n):
            mesh.all_reduce(x)
        return time.perf_counter() - t

    bare = min(calls() for _ in range(3))
    with record_collectives(mesh):
        recorded = min(calls() for _ in range(3))
    return max(recorded - bare, 0.0) / n


def _real_prefix(q: np.ndarray) -> int:
    """Selected positions padded to their bucket: the strictly increasing
    prefix is the selection, the zeros after it the padding."""
    stops = np.nonzero(q[1:] <= q[:-1])[0]
    return int(stops[0]) + 1 if len(stops) else len(q)


def _pass_rows(rec, seq):
    """(rows, which of the pass's rows x tokens are real) of one recorded
    pass: padding, idle slots and invalid positions left out; a prefill's
    rows tagged with ``seq`` (and a dense cache's row), the sequence they
    belong to."""
    from repro_torch.models.layers import INVALID_POS
    from repro_torch.roofline.analysis import Row

    logits = rec["logits"]
    if "lengths" in rec and rec["kind"] == "decode":
        lens = rec["lengths"].cpu().numpy()
        real = lens > 0
        return [Row([int(n) - 1], int(n)) for n in lens[real]], real
    if "lengths" in rec:                            # the paged prefill
        q = rec["q_pos"].cpu().numpy()[0]
        n = _real_prefix(q)
        return ([Row(q[:n], int(rec["lengths"].cpu()[0]), logits, seq)],
                np.arange(len(q)) < n)
    qs = rec["q_pos"].cpu().numpy()                 # the dense cache
    kv = rec["kv_pos"].cpu().numpy() if "kv_pos" in rec else None
    rows, real = [], []
    for b, q in enumerate(qs):
        keep = q != INVALID_POS
        if rec["kind"] == "decode" and rec["idle_pos"] is not None:
            keep &= q != rec["idle_pos"]
        real.append(keep)
        if keep.any():
            keys = (kv[b][kv[b] != INVALID_POS] if kv is not None
                    else int(q[keep].max()) + 1)
            rows.append(Row(q[keep], keys, logits,
                            None if seq is None else (seq, b)))
    return rows, np.concatenate(real)


def pass_costs(records, all_experts: bool = False) -> list:
    """The least work of each step the records hold: one dict for every
    decode pass, and one for every request's prefill, however many passes
    or chunks it ran (its rows share their sequence, so its weights, KV
    and tokens count once: ``roofline.step_cost``); a prefill pass outside
    any request is a step of its own.  Each dict: the ``kind``, the
    ``cost`` (a MoE's distinct experts per layer from the routing of the
    real rows, or every expert with ``all_experts``), the real
    ``tokens``, the ``wire`` bytes of the collectives' real rows, the
    ``passes`` and the host seconds the recording took (``record_s``).  A
    tensor-parallel rank's step counts its own widths and, of the routed
    experts, its own."""
    from repro_torch.roofline.analysis import collective_bytes, step_cost

    steps = {}
    for i, rec in enumerate(records):
        key = (i if rec["kind"] == "decode" or rec["req"] is None
               else ("req", rec["req"]))
        steps.setdefault(key, []).append(rec)
    out = []
    for key, recs in steps.items():
        first = recs[0]
        cfg = first["cfg"]
        rows, experts, wire, coll_s = [], None, 0.0, 0.0
        if recs[0]["routes"]:
            experts = [set() for _ in range(cfg.num_layers)]
        lo, n = first.get("expert_range", (0, cfg.num_experts))
        for rec in recs:
            # a request's KV: its pages, or each dense cache it writes (a
            # miss's recompute and full_reuse's text pass have their own)
            seq = None if isinstance(key, int) else (
                key, id(rec["cache"]) if "cache" in rec else "pages")
            r, real = _pass_rows(rec, seq)
            rows += r
            # every collective of a pass is linear in its rows: the least
            # work moves the real rows' share, each at its axis's link
            stats = collective_bytes(rec.get("calls", ()))
            # (a data rank's pass whose own slots are all idle has none)
            share = float(np.mean(real)) if len(real) else 0.0
            wire += stats.total_bytes * share
            coll_s += stats.least_s * share
            for layer, idx in enumerate(rec["routes"]):   # (rows x tokens, k)
                idx = idx.cpu().numpy()
                if len(idx) != len(real):
                    raise RuntimeError(f"{len(idx)} routed rows, "
                                       f"{len(real)} in the pass")
                idx = idx[real]
                experts[layer].update(np.unique(
                    idx[(idx >= lo) & (idx < lo + n)]).tolist())
        if experts is not None:
            experts = [n if all_experts else len(e) for e in experts]
        out.append({
            "kind": first["kind"],
            "cost": step_cost(cfg, rows,
                              kv_dtype="int8" if first["int8"] else None,
                              page_size=first.get("page_size", 16),
                              window=first.get("window"), experts=experts,
                              widths=first.get("widths")),
            "tokens": sum(len(r.q_pos) for r in rows), "wire": wire,
            "coll_s": coll_s,
            "passes": len(recs),
            "coll_ops": sum(len(rec.get("calls", ())) for rec in recs),
            "record_s": sum(rec["record_s"] for rec in recs)})
    return out


def least_row(step: str, measured_ms: float, cost, model_flops: float, *,
              chips: int = 1, coll_bytes: float = 0.0,
              coll_s=None, note: str = "") -> dict:
    """One line of phase 8: a step's measured time beside its least time
    on the card (the largest of its operations over the bf16 peak, its
    bytes over HBM's rate and its collectives' wire bytes over their
    axis's link, ``coll_s``, or NVLink's without it), what bounds it,
    ``roofline_share`` and ``mfu`` (``model_flops``, 2ND or 6ND, on
    ``chips`` cards)."""
    from repro_torch.roofline.analysis import (
        CollectiveStats,
        least_time,
        mfu,
        roofline_share,
    )

    rl = cost.roofline("", "", "", step, chips=chips,
                       model_flops_global=model_flops,
                       coll=CollectiveStats(coll_bytes, {}, 0, coll_s))
    return {"step": step, "measured_ms": measured_ms,
            "least_ms": least_time(rl) * 1e3,
            "bound_by": {"compute": "operations", "memory": "bytes",
                         "collective": "collective bytes"}[rl.bottleneck],
            "share": roofline_share(measured_ms / 1e3, rl),
            "mfu": mfu(measured_ms / 1e3, model_flops, chips),
            "flops": rl.flops_per_device, "bytes": rl.bytes_per_device,
            "coll_bytes": coll_bytes, "note": note}


def _total(costs):
    total = costs[0]
    for c in costs[1:]:
        total = total + c
    return total


def served_rows(label: str, costs, n_requests: int, decode_steps: int,
                prefill_ms: float, decode_ms: float, *, n_params: int,
                scale: float = 1, chips: int = 1, note: str = "",
                collective_s: float = 0.0) -> list:
    """Phase 8's lines of one serving run from its :func:`pass_costs`:
    the prefill (the mean least work of a request's prefill, beside the
    engine's mean prefill alone) and the decode step (the mean least work
    of its decode passes, beside the engine's mean decode step); 2ND model
    FLOPs of ``n_params`` (the whole model's active parameters).
    ``scale``: ranks a card (their work adds up there).  Each line also
    carries ``record_ms``, the host time the recording spent in the
    measured mean (``collective_s`` a recorded collective).  Raises when
    the recorded steps are not the engine's: a prefill a request, a
    decode pass a decode step."""
    decode = [c for c in costs if c["kind"] == "decode"]
    prefill = [c for c in costs if c["kind"] == "prefill"]
    if len(decode) != decode_steps or len(prefill) != n_requests:
        raise RuntimeError(f"{label}: {len(prefill)} prefills and "
                           f"{len(decode)} decode passes recorded, the "
                           f"engine timed {n_requests} and {decode_steps}")
    out = []
    for name, parts, ms in (("prefill", prefill, prefill_ms),
                            ("decode step", decode, decode_ms)):
        if not parts or not ms:
            continue
        n = len(parts)
        tokens = sum(c["tokens"] for c in parts) / n
        row = least_row(
            f"{label} {name}", ms,
            _total([c["cost"] for c in parts]).scaled(scale / n),
            2.0 * n_params * tokens, chips=chips,
            coll_bytes=sum(c["wire"] for c in parts) / n,
            coll_s=sum(c["coll_s"] for c in parts) / n, note=note)
        row["record_ms"] = 1e3 * sum(c["record_s"] for c in parts) / n
        if collective_s:
            row["record_ms"] += 1e3 * collective_s * sum(
                c["coll_ops"] for c in parts) / n
        out.append(row)
    return out


def run_dry_runs(env) -> None:
    """``python -m repro_torch.launch.dryrun --serving-selftest`` and
    ``--arch internvl2-76b --shape decode_32k`` in processes of their own,
    both at once: each must exit 0 (no JAX on this machine) with the
    card's memory in use no higher than before (meta tensors only)."""
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", *args]
            for args in (["--serving-selftest"], ["--arch", "internvl2-76b",
                                                  "--shape", "decode_32k"])]
    before = card_memory_mib()
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(lambda c: run_watched(c, env, 300), cmds))
    for cmd, (rc, out, err, wall, card_mib, _) in zip(cmds, done):
        args = cmd[3:]
        print(f"$ {' '.join(cmd[1:])}\n  exit {rc} in {wall:.2f} s; the "
              f"card's memory in use at most {card_mib} MiB ({before} MiB "
              "before the two started)")
        for line in out.splitlines():
            print(f"  | {line}")
        if rc != 0 or card_mib > before:
            raise RuntimeError(f"the dry run {args} failed (exit {rc}, "
                               f"card {before} -> {card_mib} MiB):\n"
                               f"{err[-3000:]}")


# -- phases 5j and 5k: the cluster and the fleet -------------------------
# (module level, so that they can be driven on their own: the device, the
# model and the plain-version guard are arguments)

GUARDED = (("repro_torch.kernels.selective_attn.ops", "selective_attention_ref"),
           ("repro_torch.kernels.selective_attn.ops",
            "selective_attention_paged_ref"),
           ("repro_torch.kernels.paged_attn.ops", "paged_attention_ref"),
           ("repro_torch.models.layers", "attend"),
           ("repro_torch.kernels.ssd_chunk.ops", "ssd_chunk_ref"))


@contextlib.contextmanager
def no_plain_versions(training=False):
    """The plain versions and ``layers.attend`` raise while serving on the
    card: every attention and SSD chunk step there must go through a
    kernel.  While ``training``, ``layers.attend`` runs (the training
    forward's attention, which the kernels, having no backward, do not
    serve) and the plain versions still raise."""
    import importlib

    saved = [(mod, name, getattr(mod, name)) for mod, name in
             ((importlib.import_module(m), n) for m, n in GUARDED)
             if not (training and name == "attend")]

    def forbid(name):
        def call(*args, **kwargs):
            raise RuntimeError(f"{name} was called while serving on "
                               "the card")
        return call

    for mod, name, _ in saved:
        setattr(mod, name, forbid(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def snapshot(eng):
    """Layer 0 of an engine's pool and the live decode / newest prefill
    shapes (phase 6 holds kernels 1-4 to their plain versions there)."""
    import torch

    from repro_torch.core.linker import bucket
    from repro_torch.core.select import mpic_selection, selection_indices

    dev = eng.device
    pool, ps = eng.pool, eng.cfg.page_size
    lengths = np.asarray([r.cur_len for r in eng.running], np.int32)
    mp = bucket(max(pool.pages_for(int(n)) for n in lengths), 1)
    last = max(eng.running, key=lambda r: r.t_admitted)
    sel = selection_indices(mpic_selection(last.prompt, K_MPIC))
    q_pos = np.zeros((bucket(len(sel), 16),), np.int32)
    q_pos[:len(sel)] = sel
    row = eng._page_tables[last.slot]
    pmp = min(bucket(pool.pages_for(last.prompt.total_len)), len(row))
    q8 = pool.quantized
    return {
        "k": pool.k[0].clone(), "v": pool.v[0].clone(),
        "ks": pool.k_scale[0].clone() if q8 else None,
        "vs": pool.v_scale[0].clone() if q8 else None,
        "decode_pt": torch.as_tensor(eng._page_tables[:, :mp].copy(),
                                     device=dev),
        "decode_len": torch.as_tensor(lengths, device=dev),
        "prefill_pt": torch.as_tensor(row[None, :pmp].copy(), device=dev),
        "q_pos": torch.as_tensor(q_pos[None], device=dev),
        "prefill_len": torch.tensor([last.prompt.total_len],
                                    dtype=torch.int32, device=dev),
        "n_sel": len(sel), "ps": ps,
    }


def phase3_requests(d_model, media_len, mrag=True, **request_kw):
    """Phase 3's traffic: four two-image MMDU-style dialogues (``mpic``
    k=32, 8 new tokens), the last with the MRAG query (``mrag``); returns
    the dialogues, the MRAG image and a function that makes the requests
    anew."""
    from repro_torch.data import image_embeds, make_dialogues
    from repro_torch.serving import Request

    samples = make_dialogues(n=4, n_images=2, d_model=d_model,
                             media_len=media_len, style="mmdu")
    rag = image_embeds("rag-0", media_len, d_model)

    def requests():
        reqs = [Request(prompt=s.prompt, max_new_tokens=MAX_NEW,
                        policy="mpic", policy_kwargs={"k": K_MPIC},
                        **request_kw) for s in samples]
        if mrag:
            reqs[-1].retrieval_query = rag.mean(0)
        return reqs

    return samples, rag, requests


def _free_and_unpinned(label, engines, libraries):
    """Every page of every pool back (the scratch page aside) and no pin
    held in any library, or raise."""
    pages = [(e.pool.free_pages, e.pool.cfg.num_pages - 1) for e in engines]
    pins = sum(e.meta.pins for lib in libraries
               for e in lib._entries.values())
    if any(free != total for free, total in pages) or pins:
        raise RuntimeError(f"{label}: pages (free, total) {pages}, pins "
                           f"{pins} after the run")
    return pages


def serve_fleet_reference(model, params, guard, runs, *, device=None,
                          media_len=MEDIA_LEN):
    """One engine with the fleet hosts' slot layout (2 slots of 2048
    tokens, bf16 pool) serving phase 3's dialogues without the MRAG query
    (a fleet request carries none): the tokens phase 5k is held to, and
    the freeze reference of its first dialogue."""
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.serving import EngineConfig, MPICEngine

    samples, _, requests = phase3_requests(model.cfg.d_model, media_len,
                                           mrag=False)
    with guard():
        _build.reset_launches(KERNELS.values())
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=2048, decode_slots=FLEET_SLOTS), device=device)
        for s in samples:
            for _, seg in s.prompt.media_segments():
                eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
        reqs = requests()
        for r in reqs:
            eng.submit(r)
        eng.run()
        launches = {k: v.launches for k, v in KERNELS.items()}
        eng.close()
    if not all(r.done and len(r.output_tokens) == MAX_NEW for r in reqs):
        raise RuntimeError("fleet reference: a request did not finish")
    runs["fleet_reference"] = {"launches": launches,
                               "tokens": [r.output_tokens for r in reqs]}
    print(f"  fleet reference (one engine, {FLEET_SLOTS} slots, no MRAG "
          f"query): tokens {[r.output_tokens for r in reqs]}", flush=True)
    return [list(r.output_tokens) for r in reqs]


def serve_cluster(model, params, refs, guard, runs, *, device=None,
                  media_len=MEDIA_LEN):
    """Phase 5j: an ``MPICCluster`` of two replicas over one model, each
    with a pool of 4 slots of 2048 tokens, behind the affinity router,
    serving phase 3's traffic twice, on a bf16 and an int8 pool: (a)
    clean, the second round after the first; (b) with ``replica1``
    crashing at its second step; (c) both rounds at once, the second with
    a budget of ``CLUSTER_DEADLINE_S``.  ``refs[pool]`` holds phase 3's
    (phase 4's) tokens and first-token logits of each request."""
    import torch

    from repro_torch.cache import FaultPlan
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.serving import (
        ClusterConfig,
        EngineConfig,
        MPICCluster,
        State,
    )

    samples, rag, requests = phase3_requests(model.cfg.d_model, media_len)
    for pool_dtype in ("", "int8"):
        pool = pool_dtype or "bf16"
        want_tokens, want_firsts = refs[pool_dtype]
        want = ["sel_attn", "sel_attn_paged_q8" if pool_dtype else
                "sel_attn_paged", "paged_attn_q8" if pool_dtype else
                "paged_attn"]
        for mode in ("clean", "crash", "deadline"):
            label = f"cluster_{pool}_{mode}"
            if device is None:
                torch.cuda.reset_peak_memory_stats()
            plan = FaultPlan.parse(CLUSTER_CRASH) if mode == "crash" else None
            with guard():
                _build.reset_launches(KERNELS.values())
                cl = MPICCluster(model, params, EngineConfig(
                    max_seq_len=2048, decode_slots=CLUSTER_SLOTS,
                    page_size=16, pool_dtype=pool_dtype), ClusterConfig(
                        replicas=2, router="affinity", faults=plan),
                    device=device)
                firsts = {}
                for e in cl.engines:
                    def record(req, result, *rest, _fin=e._finalize_prefill):
                        firsts[req.req_id] = np.asarray(result.first_logits,
                                                        np.float32)
                        return _fin(req, result, *rest)
                    e._finalize_prefill = record
                t_up = time.perf_counter()
                for s in samples:
                    for _, seg in s.prompt.media_segments():
                        cl.upload(s.prompt.user_id, seg.media_id, seg.embeds)
                cl.upload("*", "rag-0", rag, dynamic=True)
                upload_s = time.perf_counter() - t_up
                # a request's clock starts when it is made: each round is
                # made when it is submitted
                rounds = []
                if mode == "deadline":
                    rounds = [requests(), requests()]
                    for r in rounds[1]:
                        r.deadline_s = CLUSTER_DEADLINE_S
                    for r in rounds[0] + rounds[1]:
                        cl.submit(r)
                    cl.run()
                else:
                    for _ in range(2):
                        rounds.append(requests())
                        for r in rounds[-1]:
                            cl.submit(r)
                        cl.run()
                if device is None:
                    torch.cuda.synchronize()
                launches = {k: v.launches for k, v in KERNELS.items()}
            rep = cl.report()
            engines, libs = cl.engines, (cl.static_lib, cl.dynamic_lib)
            pages = _free_and_unpinned(label, engines, libs)
            round2 = {r.req_id for r in rounds[1]}
            warm = sum(1 for d in cl.decisions if d.req_id in round2
                       and d.warmth.get("hbm", 0) == 2)
            reqs = rounds[0] + rounds[1]
            per = {e.replica_id: e.report() for e in engines}
            peak = (torch.cuda.max_memory_allocated() / 2**30
                    if device is None else 0.0)
            print(f"  {label}: routed per replica "
                  f"{rep['routing']['per_replica']}, warm hits in round 2 "
                  f"{warm}/{len(round2)}, requeued {rep['requeued']}, "
                  f"quarantined {sorted(rep['quarantined'])}, expired "
                  f"{len(cl.expired)}; uploads {upload_s:.3f} s; pages "
                  f"(free, total) {pages}; peak "
                  f"{peak:.2f} GiB", flush=True)
            for rid, r in per.items():
                if r:
                    print(f"    replica {rid}: {r['requests']} requests, "
                          f"TTFT mean {r['mean_ttft_s'] * 1e3:.2f} ms, "
                          f"decode step mean "
                          f"{r['mean_decode_step_s'] * 1e3:.2f} ms over "
                          f"{r['decode_steps']} steps")
            print(f"    launches {launches}", flush=True)
            bad = []
            for i, r in enumerate(reqs):
                j = i % len(want_tokens)
                if mode == "deadline" and r.req_id in round2:
                    continue
                if not r.done or r.output_tokens != want_tokens[j]:
                    bad.append((r.req_id, r.state.value, r.output_tokens,
                                want_tokens[j]))
                    continue
                diff = float(np.abs(firsts[r.req_id] - want_firsts[j]).max())
                if not diff <= 1e-3:
                    bad.append((r.req_id, "first logits", diff))
            if bad:
                raise RuntimeError(f"{label}: requests differ from phase "
                                   f"3/4's: {bad}")
            if mode == "crash" and (sorted(rep["quarantined"]) != [1]
                                    or rep["requeued"] < 1):
                raise RuntimeError(f"{label}: replica 1 not quarantined "
                                   f"with requeues: {rep['quarantined']}, "
                                   f"{rep['requeued']}")
            if mode == "deadline" and not any(
                    r.state is State.DEADLINE for r in reqs):
                raise RuntimeError(f"{label}: no request reached its "
                                   "deadline")
            for name in want if device is None else ():
                if launches[name] <= 0:
                    raise RuntimeError(f"{label}: {name} never launched")
            runs[label] = {
                "launches": launches, "upload_s": upload_s,
                "routed": rep["routing"]["per_replica"], "warm_hits": warm,
                "requeued": rep["requeued"],
                "quarantined": sorted(rep["quarantined"]),
                "expired": len(cl.expired), "peak_gib": peak,
                "per_replica": {rid: {
                    "mean_ttft_ms": r["mean_ttft_s"] * 1e3,
                    "mean_decode_step_ms": r["mean_decode_step_s"] * 1e3}
                    for rid, r in per.items() if r}}
            cl.close()
            del cl, engines, libs, firsts
            gc.collect()
            if device is None:
                torch.cuda.empty_cache()


def _host_launches(log_text):
    """The largest launch count of each kernel over a host log's
    ``launches=`` lines (each process counts from 0)."""
    best: dict = {}
    for line in log_text.splitlines():
        m = re.search(r"launches=(\{.*\})", line)
        if m:
            for name, n in json.loads(m.group(1)).items():
                best[name] = max(best.get(name, 0), n)
    return best


def serve_fleet(reference, phase3_tokens, weight_bytes, *, device=None,
                media_len=MEDIA_LEN, d_model=None):
    """Phase 5k: a ``FleetSupervisor`` of two engine hosts at full width on
    the card (2 slots of 2048 tokens, affinity router), this process
    holding no model.  Each dialogue's images go to one host (by the SHA-1
    of its first image id), every block spooled at once; the first round
    of phase 3's dialogues is routed, the host serving one of them killed
    at once, its restart awaited (its spool rehydrated) before the
    requests go out again; a second round; a session frozen (spooled) on
    host 0, host 0 killed and restarted, the handle thawed on host 1; a
    drain.  ``reference`` holds the tokens of one engine with the hosts'
    slot layout."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.fleet import FleetSupervisor

    on_card = device is None
    if on_card:
        held = torch.cuda.memory_allocated()
        print(f"  this process holds {held / 2**30:.2f} GiB "
              "(torch.cuda.memory_allocated)", flush=True)
        if not held < weight_bytes / 2:
            raise RuntimeError("phase 5k: this process still holds a model")
    d_model = d_model or get_config("llava-1.6-7b").d_model
    samples, _, requests = phase3_requests(d_model, media_len, mrag=False)
    owner = [int(hashlib.sha1(s.media_ids[0].encode()).hexdigest(), 16) % 2
             for s in samples]
    base = tempfile.mkdtemp(prefix="mpic_smoke_fleet_")
    sup = FleetSupervisor(
        2, arch="llava-1.6-7b", base_dir=base, router="affinity",
        slots=FLEET_SLOTS, max_seq_len=2048, peer_timeout_s=NET_TIMEOUT_S,
        hbm_bytes=1, host_bytes=1, linger_s=60.0,
        start_grace_s=FLEET_START_S, device=device)
    out, card = {}, []

    def memory(note):
        if on_card:
            card.append((note, card_memory_mib()))
            print(f"  card memory in use {card[-1][1]} MiB ({note}, "
                  "nvidia-smi)", flush=True)

    def restart(host_id):
        """Kill a host, find its death, await its restart and rejoin."""
        deaths = sup.deaths
        t = time.perf_counter()
        sup.kill_host(host_id)
        sup.heartbeat()
        if sup.deaths != deaths + 1:
            raise RuntimeError(f"phase 5k: the death of host {host_id} was "
                               "not seen")
        memory(f"host {host_id} killed")
        sup.wait_healthy([host_id], timeout_s=FLEET_START_S)
        rejoin = time.perf_counter() - t
        memory(f"host {host_id} rejoined")
        return rejoin

    try:
        memory("before the hosts")
        t = time.perf_counter()
        sup.start(timeout_s=FLEET_START_S)
        out["start_s"] = time.perf_counter() - t
        memory("both hosts up")
        t = time.perf_counter()
        for s, host in zip(samples, owner):
            for _, seg in s.prompt.media_segments():
                sup.upload(s.prompt.user_id, seg.media_id, seg.embeds,
                           host=host)
        out["upload_s"] = time.perf_counter() - t
        sup.heartbeat()                 # the media maps, for the router
        victim = owner[1]
        spooled = sorted(f for f in os.listdir(
            sup.hosts[victim].spec.spool_dir) if f.endswith(".npz"))
        round1 = requests()
        for r in round1:
            sup.submit(r)
        in_flight = [r.req_id for r in round1
                     if sup.inflight[r.req_id].host == victim]
        out["rejoin_s"] = restart(victim)
        rehydrated = sup.hosts[victim].health["rehydrate"]
        print(f"  round 1 routed to hosts "
              f"{[sup.inflight[r.req_id].host for r in round1]}; host "
              f"{victim} killed with {in_flight} in flight, rejoined in "
              f"{out['rejoin_s']:.3f} s, rehydrated {rehydrated} of "
              f"{len(spooled)} spooled blocks", flush=True)
        if not in_flight or rehydrated.get("rehydrated") != len(spooled):
            raise RuntimeError(f"phase 5k: in flight {in_flight}, "
                               f"rehydrated {rehydrated} of {spooled}")
        sup.run_until_done(timeout_s=600)
        round2 = requests()
        for r in round2:
            sup.submit(r)
        sup.run_until_done(timeout_s=600)
        memory("two rounds served")
        # a session frozen (and spooled) on host 0 after 4 tokens, host 0
        # killed, the handle thawed on host 1
        fz = requests()[0]
        fz.freeze_after = FLEET_FREEZE_AFTER
        sup.submit(fz, host=0)
        sup.run_until_done(timeout_s=600)
        row = sup.results[fz.req_id]
        if row["state"] != "frozen" or not row.get("session"):
            raise RuntimeError(f"phase 5k: not frozen: {row}")
        out["rejoin_0_s"] = restart(0)
        t = time.perf_counter()
        rid = sup.thaw(1, row["session"])
        out["thaw_s"] = time.perf_counter() - t
        sup.run_until_done(timeout_s=600)
        thawed = sup.results[rid]
        sup.heartbeat()
        pulled = sum((h.health or {}).get("network", {}).get("bytes_read", 0)
                     for h in sup.hosts)
        rep = sup.report()
        t = time.perf_counter()
        sup.drain(timeout_s=600)
        out["drain_s"] = time.perf_counter() - t
        exits = [h.proc.returncode for h in sup.hosts]
        logs = []
        for i in range(2):
            with open(sup.log_path(i)) as f:
                logs.append(f.read())
    finally:
        sup.stop()
        shutil.rmtree(base, ignore_errors=True)
    bad = []
    for r, want in zip(round1 + round2, reference + reference):
        got = sup.results[r.req_id]
        if got["state"] != "done" or got["tokens"] != want:
            bad.append((r.req_id, got["state"], got["tokens"], want))
    resumed = row["tokens"][:-1] + thawed["tokens"]
    hosts = [_host_launches(text) for text in logs]
    print(f"  results: {[(r.req_id, sup.results[r.req_id]['host']) for r in round1 + round2]}; "
          f"deaths {rep['deaths']} for 2 kills, requeued {rep['requeued']}, "
          f"restarts {rep['restarts']}; resumed session on host "
          f"{thawed['host']} == uninterrupted: {resumed == reference[0]} "
          f"(thaw call {out['thaw_s']:.3f} s); bytes pulled between hosts "
          f"{pulled} (the restarted hosts' counters); host exit codes "
          f"{exits}; host launches {hosts}", flush=True)
    lat = {k: round(v, 3) for k, v in sup.latency_s.items()}
    print(f"  start-up {out['start_s']:.3f} s (both hosts), kill to rejoin "
          f"{out['rejoin_s']:.3f} s (host {victim}) and "
          f"{out['rejoin_0_s']:.3f} s (host 0); uploads "
          f"{out['upload_s']:.3f} s; drain {out['drain_s']:.3f} s; "
          f"latency_s per request {lat}", flush=True)
    same3 = [a == b for a, b in zip(reference[:3], phase3_tokens[:3])]
    print(f"  the reference's tokens equal phase 3's (dialogues 1-3; the "
          f"4th carries no MRAG query here): {same3}", flush=True)
    want = ("sel_attn", "sel_attn_paged", "paged_attn")
    if bad or resumed != reference[0] or rep["deaths"] != 2 \
            or exits != [0, 0] or (on_card and not all(
                h.get(k, 0) > 0 for h in hosts for k in want)):
        raise RuntimeError(f"phase 5k failed: differing {bad}, resumed "
                           f"{resumed} against {reference[0]}, deaths "
                           f"{rep['deaths']}, exits {exits}, launches "
                           f"{hosts}")
    runs_fleet = {**{k: round(v, 6) for k, v in out.items()},
                  "deaths": rep["deaths"], "requeued": rep["requeued"],
                  "restarts": rep["restarts"], "pulled_bytes": pulled,
                  "latency_s": lat, "card_mib": card,
                  "host_launches": hosts, "rehydrated": rehydrated,
                  "reference_equals_phase3": same3}
    print(f"fleet: {json.dumps(runs_fleet)}", flush=True)
    return runs_fleet


# -- phases 5l and 5m: whisper-small and the trainer --------------------------

def whisper_traffic(cfg, seed: int = 31):
    """Phase 5l's traffic for ``cfg``: four seeded audio inputs (4,
    encoder_seq, d_model) fp32 at the scale of the JAX package's whisper
    tests (N(0, 0.02)) and four decoder prompts of ``WHISPER_PROMPTS``
    tokens."""
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((len(WHISPER_PROMPTS), cfg.encoder_seq,
                                  cfg.d_model)) * 0.02).astype(np.float32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in WHISPER_PROMPTS]
    return audio, prompts


@contextlib.contextmanager
def recording_dense(names, into):
    """Keep a copy of the inputs of the next ``len(names)`` dense
    selective-attention calls of the model's passes, under ``names`` in
    ``into`` (with the window: ``dense_case``'s arguments)."""
    import repro_torch.models.transformer as tf

    real, pending = tf.selective_attention, list(names)

    def recording(q, k, v, q_pos, kv_pos, *, window=0):
        if pending:
            into[pending.pop(0)] = tuple(t.clone() for t in
                                         (q, k, v, q_pos, kv_pos)) + (window,)
        return real(q, k, v, q_pos, kv_pos, window=window)

    tf.selective_attention = recording
    try:
        yield
    finally:
        tf.selective_attention = real


def run_whisper(model, params, audio, prompts, *, device=None,
                cross_of=None, capture=None):
    """Phase 5l's pass: the encoder over every audio input at once, their
    cross K/V into the rows of a dense cache of ``WHISPER_KV_LEN`` slots,
    each prompt prefilled into its own row, then ``MAX_NEW`` greedy decode
    steps of all rows.  Row ``b`` reads the cross K/V of request
    ``cross_of[b]`` (the planted fault; its own by default).  With
    ``capture`` (a dict), layer 0's dense-attention inputs of the encoder,
    of the first prompt's prefill and of the first decode step go there.
    Returns fp32 numpy logits (``prefill``: one (S_b, V) per request;
    ``decode``: (MAX_NEW, B, V)), the tokens (B, 1 + MAX_NEW) and host
    seconds (``encode_s``, ``cross_kv_s``, ``prefill_s`` per request,
    ``decode_s`` per step), each stage ended by a device sync."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    last = [0.0]

    def lap():
        """Seconds since the last lap, after a device sync."""
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        last[0], dt = now, now - last[0]
        return dt

    def recorded(names):
        return (recording_dense(names, capture) if capture is not None
                else contextlib.nullcontext())

    n = len(prompts)
    out = {"prefill": [], "decode": [], "prefill_s": [], "decode_s": []}
    cache = model.make_cache(n, WHISPER_KV_LEN, device=dev)
    lap()
    with recorded(["encoder"]):
        enc = model.encode_audio(params, torch.as_tensor(audio, device=dev))
    out["encode_s"] = lap()
    ck, cv = model.cross_kv(params, enc)
    if cross_of is not None:
        ck, cv = ck[:, cross_of], cv[:, cross_of]
    cache["cross_k"], cache["cross_v"] = ck, cv
    out["cross_kv_s"] = lap()
    del enc
    firsts = []
    for b, toks in enumerate(prompts):
        row = {k: v[b:b + 1] if k == "pos" else v[:, b:b + 1]
               for k, v in cache.items()}
        with recorded(["prefill_self", "prefill_cross"] if b == 0 else []):
            logits, _ = model.prefill(params, torch.as_tensor(
                toks[None], device=dev), row)
        out["prefill_s"].append(lap())
        firsts.append(int(logits[0, -1].argmax()))
        out["prefill"].append(logits[0].float().cpu().numpy())
        lap()
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=dev)
    tok = torch.tensor(firsts, dtype=torch.int32, device=dev)[:, None]
    tokens = [tok]
    lap()
    for step in range(MAX_NEW):
        pos = (lens + step)[:, None]
        with recorded(["decode_self", "decode_cross"] if step == 0 else []):
            logits, cache = model.decode_step(params, tok, pos, cache, pos)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        tokens.append(tok)
        out["decode_s"].append(lap())
        out["decode"].append(logits.float().cpu().numpy())
        lap()
    out["decode"] = np.stack(out["decode"])
    out["tokens"] = torch.cat(tokens, 1).cpu().numpy()
    return out


def whisper_rel_rms(model, params, audio, prompts, out, *, device=None):
    """Per request, the RMS of (its prefill logits, then its decode
    logits) minus ``Model.forward``'s over its prompt and generated tokens,
    over the RMS of forward's."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    rel = []
    for b, toks in enumerate(prompts):
        seq = np.concatenate([toks, out["tokens"][b, :MAX_NEW]])
        full = model.forward(params, torch.as_tensor(seq[None], device=dev),
                             audio_embeds=torch.as_tensor(audio[b:b + 1],
                                                          device=dev))
        full = full[0].float().cpu().numpy()
        got = np.concatenate([out["prefill"][b], out["decode"][:, b]])
        rel.append(float(np.sqrt(np.mean((got - full) ** 2)
                                 / np.mean(full ** 2))))
    return rel


def whisper_least(cfg, out) -> list:
    """Phase 8's lines of 5l's pass: the encoder over 4 x 1500 frames and
    the cross K/V (2ND of the weights they multiply), each prefill, and
    the mean decode step after the first, beside their least times."""
    from repro_torch.roofline.analysis import (
        Row,
        cross_kv_cost,
        encode_cost,
        step_cost,
    )

    b, frames = len(WHISPER_PROMPTS), cfg.encoder_seq
    n_params = cfg.n_active_params()
    rows = []
    for name, cost, ms in (
            ("encode", encode_cost(cfg, b, frames), out["encode_s"] * 1e3),
            ("cross K/V", cross_kv_cost(cfg, b, frames),
             out["cross_kv_s"] * 1e3)):
        rows.append(least_row(f"{cfg.name} {name}", ms, cost,
                              cost.weight_flops))
    for n, sec in zip(WHISPER_PROMPTS, out["prefill_s"]):
        rows.append(least_row(
            f"{cfg.name} prefill of {n} tokens", sec * 1e3,
            step_cost(cfg, [Row(np.arange(n), n)], cross_frames=frames),
            2.0 * n_params * n))
    steps = range(1, MAX_NEW)
    cost = _total([step_cost(cfg, [Row([n + i], n + i + 1)
                                   for n in WHISPER_PROMPTS],
                             cross_frames=frames) for i in steps])
    rows.append(least_row(
        f"{cfg.name} decode step (steps 2-{MAX_NEW})",
        float(np.mean(out["decode_s"][1:])) * 1e3,
        cost.scaled(1 / len(steps)), 2.0 * n_params * b))
    return rows


def serve_whisper(guard, runs, capture):
    """Phase 5l: full-width whisper-small with seeded bf16 weights on the
    dense cache (``run_whisper``).  Gates: kernel 5 alone launched, on the
    tensor cores once per encoder layer and per decoder layer twice (self
    and cross) in each prefill, on the split keys twice per decoder layer
    in each decode step; every logit finite; each request within
    ``WHISPER_REL_RMS`` of ``Model.forward``, and above it with another
    request's cross K/V.  Layer 0's inputs go to ``capture`` for phase 6.
    """
    import torch

    import repro_torch.kernels.selective_attn.ops as sel_ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.models import build_model

    cfg = get_config(WHISPER)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # what earlier phases keep
    params = model.init(seed=0)
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    audio, prompts = whisper_traffic(cfg)
    print(f"{cfg.name}: {cfg.encoder_layers} encoder and {cfg.num_layers} "
          f"decoder layers, d_model {cfg.d_model}, {nbytes / 2**30:.2f} GiB "
          f"of seeded weights; audio {audio.shape}, prompts "
          f"{list(WHISPER_PROMPTS)} tokens into {WHISPER_KV_LEN} slots a row")
    with guard():
        _build.reset_launches(KERNELS.values())
        out = run_whisper(model, params, audio, prompts, capture=capture)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in KERNELS.items()}
        routes = dict(sel_ops.SEL_ATTN.route_launches)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    n, layers = len(prompts), cfg.num_layers
    want_routes = {sel_ops.TENSOR_CORES: cfg.encoder_layers + 2 * layers * n,
                   sel_ops.SPLIT_KEYS: 2 * layers * MAX_NEW}
    print(f"  encode {out['encode_s'] * 1e3:.2f} ms (4 x {cfg.encoder_seq} "
          f"frames), cross K/V {out['cross_kv_s'] * 1e3:.2f} ms, prefill "
          f"{[round(x * 1e3, 2) for x in out['prefill_s']]} ms, decode step "
          f"mean {np.mean(out['decode_s'][1:]) * 1e3:.2f} ms (first "
          f"{out['decode_s'][0] * 1e3:.2f}); peak {peak:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB earlier phases hold")
    print(f"  launches {launches}; sel_attn by route {routes}; tokens "
          f"{out['tokens'].tolist()}", flush=True)
    if any(n_ for name, n_ in launches.items() if name != "sel_attn") or \
            {r: c for r, c in routes.items() if c} != want_routes or \
            launches["sel_attn"] != sum(want_routes.values()):
        raise RuntimeError(f"{WHISPER}: kernel launches {launches}, routes "
                           f"{routes}, want {want_routes}")
    if not all(np.isfinite(x).all() for x in [*out["prefill"],
                                              out["decode"]]):
        raise RuntimeError(f"{WHISPER}: non-finite logits")
    with guard():
        rel = whisper_rel_rms(model, params, audio, prompts, out)
        faulty = run_whisper(model, params, audio, prompts,
                             cross_of=[1, 2, 3, 0])
        rel_fault = whisper_rel_rms(model, params, audio, prompts, faulty)
    print(f"  against Model.forward: relative RMS {[f'{r:.3e}' for r in rel]}"
          f" (limit {WHISPER_REL_RMS}); another request's cross K/V "
          f"{[f'{r:.3e}' for r in rel_fault]}", flush=True)
    print(f"  the planted fault's pass, warm: encode "
          f"{faulty['encode_s'] * 1e3:.2f} ms, cross K/V "
          f"{faulty['cross_kv_s'] * 1e3:.2f} ms, prefill "
          f"{[round(x * 1e3, 2) for x in faulty['prefill_s']]} ms, decode "
          f"step mean {np.mean(faulty['decode_s']) * 1e3:.2f} ms",
          flush=True)
    if not max(rel) <= WHISPER_REL_RMS < min(rel_fault):
        raise RuntimeError(f"{WHISPER}: the forward gate failed: {rel}, "
                           f"planted fault {rel_fault}")
    runs[f"{WHISPER}:serve"] = {
        "model": WHISPER, "launches": launches, "sel_attn_routes": routes,
        "encode_ms": out["encode_s"] * 1e3,
        "cross_kv_ms": out["cross_kv_s"] * 1e3,
        "prefill_ms": [x * 1e3 for x in out["prefill_s"]],
        "decode_step_ms": [x * 1e3 for x in out["decode_s"]],
        "warm_ms": {k: np.multiply(faulty[f"{k}_s"], 1e3).tolist()
                    for k in ("encode", "cross_kv", "prefill", "decode")},
        "peak_gib": peak, "rel_rms": rel, "rel_rms_fault": rel_fault,
        "prompt_tokens": list(WHISPER_PROMPTS),
        "least": whisper_least(cfg, out)}
    del model, params, out, faulty
    gc.collect()
    torch.cuda.empty_cache()


def _timed(batches, stamps):
    """``batches`` recording the host clock, after a device sync, at each
    batch taken: the end of the step before it."""
    import torch

    for b in batches:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        yield b


def train_least(cfg, batch: int, seq: int, step_ms: float) -> dict:
    """Phase 8's line of a training step: 6ND model FLOPs."""
    from repro_torch.configs import InputShape
    from repro_torch.roofline.analysis import model_flops, train_cost

    return least_row(f"{cfg.name} train step (batch {batch} x {seq})",
                     float(step_ms), train_cost(cfg, batch, seq),
                     model_flops(cfg, InputShape("train", seq, batch,
                                                 "train"), "train"))


def train_on_card(guard, env):
    """Phase 5m: the launcher as a subprocess (``TRAIN_ARGS``, with
    ``--ckpt``), then ``TRAIN_RUNS`` in this process through ``train()``;
    the last also writes its checkpoint and loads it back.  Gates: exit
    0, the reference's lines, finite losses, the last logged one below the
    first; no kernel launched while training; the loaded parameters
    bit-equal."""
    import torch

    import repro_torch.models.moe as moe_mod
    from repro_torch.configs import get_config
    from repro_torch.data import train_batches, with_audio
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.models import build_model
    from repro_torch.training import (
        TrainConfig,
        load_checkpoint,
        save_checkpoint,
        train,
    )
    from repro_torch.weights import params_from_numpy, reference_tree

    result = {}
    tmp = tempfile.mkdtemp(prefix="mpic_smoke_train_")
    try:
        ckpt = os.path.join(tmp, "stablelm.msgpack")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
               "--ckpt", ckpt]
        baseline = card_memory_mib()
        rc, out, err, wall, card_mib, rss = run_watched(cmd, env, 900)
        print(f"$ {' '.join(cmd[1:])}\n  exit {rc} in {wall:.3f} s; the "
              f"card's memory in use at most {card_mib} MiB (nvidia-smi, "
              f"{baseline} MiB before it started), its resident memory at "
              "most " + (f"{rss:.0f} MiB" if rss else "not readable here"))
        for line in out.splitlines():
            print(f"  | {line}")
        if rc != 0:
            raise RuntimeError(f"the trainer exited {rc}: {err[-3000:]}")
        # devices: the cards the process sees (the trainer takes one)
        head = re.match(r"arch=(\S+) params=([\d.]+)M devices=\d+$",
                        out.splitlines()[0])
        logged = [(int(s), float(loss), float(t)) for s, loss, t in
                  re.findall(r"^step +(\d+)  loss (\S+)  \((\S+)s\)$", out,
                             re.M)]
        losses = [loss for _, loss, _ in logged]
        size = os.path.getsize(ckpt)
        # every parameter as 4 bytes at least (bf16 goes as fp32); the
        # printed count is rounded to 0.1 M
        n_params = (float(head[2]) - 0.05) * 1e6 if head else 0.0
        arch = get_config(TRAIN_ARGS[TRAIN_ARGS.index("--arch") + 1]).name
        if (not head or head[1] != arch or len(logged) < 2
                or not np.isfinite(losses).all()
                or not losses[-1] < losses[0] or size < 4 * n_params):
            raise RuntimeError(f"the trainer's output is wrong:\n{out}")
        (s0, _, t0), (s1, _, t1) = logged[0], logged[-1]
        step_ms = (t1 - t0) / (s1 - s0) * 1e3
        print(f"  {arch}: {head[2]}M parameters, loss {losses[0]:.4f}"
              f" -> {losses[-1]:.4f}; {step_ms:.1f} ms a step after the "
              f"first (its log's clock, steps {s0}-{s1}); checkpoint "
              f"{size / 2**30:.2f} GiB", flush=True)
        result[arch] = {
            "wall_s": wall, "card_mib_max": card_mib,
            "card_mib_before": baseline, "rss_mib_max": rss,
            "losses": logged, "step_ms": step_ms, "ckpt_bytes": size,
            "least": [train_least(get_config(
                TRAIN_ARGS[TRAIN_ARGS.index("--arch") + 1]), 8, 64,
                step_ms)]}

        drops = []
        route = moe_mod.route

        def counting(*args, **kwargs):
            got = route(*args, **kwargs)
            drops.append(int((~got[4]).sum()))
            return got

        for arch, steps, batch in TRAIN_RUNS:
            cfg = get_config(arch)
            model = build_model(cfg)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            params = model.init(seed=0)
            data = train_batches(batch=batch, seq=TRAIN_SEQ,
                                 vocab=cfg.vocab_size, d_model=cfg.d_model)
            if cfg.is_encoder_decoder:
                data = with_audio(data, encoder_seq=cfg.encoder_seq,
                                  d_model=cfg.d_model)
            stamps = []
            drops.clear()
            moe_mod.route = counting
            try:
                with guard():
                    _build.reset_launches(KERNELS.values())
                    params, opt_state, hist = train(
                        model, params, _timed(data, stamps),
                        TrainConfig(steps=steps, log_every=1))
                    torch.cuda.synchronize()
                    stamps.append(time.perf_counter())
                    launches = {k: v.launches for k, v in KERNELS.items()}
            finally:
                moe_mod.route = route
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
            losses = [loss for _, loss in hist]
            print(f"  {arch} ({cfg.num_layers} layers, d_model "
                  f"{cfg.d_model}), batch {batch} x {TRAIN_SEQ}: losses "
                  f"{[round(x, 4) for x in losses]}, steps after the first "
                  f"{[round(x, 1) for x in step_ms]} ms, peak {peak:.2f} GiB "
                  f"above the {held / 2**30:.2f} GiB held before"
                  + (f"; (token, choice) pairs dropped by capacity "
                     f"{sum(drops)} over {len(drops)} routed passes"
                     if cfg.arch_type == "moe" else ""), flush=True)
            if not np.isfinite(losses).all() or any(launches.values()):
                raise RuntimeError(f"{arch}: losses {losses}, kernel "
                                   f"launches while training {launches}")
            result[arch] = {"losses": losses, "step_ms": step_ms,
                            "peak_gib": peak, "least": [train_least(
                                cfg, batch, TRAIN_SEQ, np.mean(step_ms))]}
            if cfg.arch_type == "moe":
                result[arch]["dropped_pairs"] = sum(drops)
            if arch == TRAIN_RUNS[-1][0]:
                path = os.path.join(tmp, f"{arch}.msgpack")
                t = time.perf_counter()
                save_checkpoint(path, {"params": reference_tree(params),
                                       "step": steps})
                back = params_from_numpy(load_checkpoint(path)["params"],
                                         cfg)
                same = all(torch.equal(a, b) for a, b in zip(
                    back.parameters(), params.parameters()))
                print(f"  {arch}: checkpoint of {os.path.getsize(path) / 2**20:.1f}"
                      f" MiB written and loaded back in "
                      f"{time.perf_counter() - t:.2f} s, parameters "
                      f"bit-equal {same}", flush=True)
                if not same:
                    raise RuntimeError(f"{arch}: the checkpoint's "
                                       "parameters differ")
                del back
            del model, params, opt_state, data
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train runs: {json.dumps(result)}", flush=True)
    return result


def train_ssm_on_card(guard):
    """Phase 5n: ``python -m repro_torch.launch.train --arch <a> --full
    --steps 3`` for mamba2-130m and hymba-1.5b, called in this process so
    that the step times (host clock after a device sync, at each batch
    taken), the peak memory and the launch counts can be read.  Gates: the
    reference's lines, finite losses, no kernel launched (the SSD runs
    through ``ssd_chunked_train``; only ``layers.attend`` may run)."""
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.launch import train as launch_train

    result = {}
    real = launch_train.train
    for arch in SSM_TRAIN_ARCHS:
        cfg = get_config(arch)
        stamps = []
        launch_train.train = lambda model, params, data, tc, **kw: real(
            model, params, _timed(data, stamps), tc, **kw)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = io.StringIO()
        try:
            with guard(), contextlib.redirect_stdout(out):
                _build.reset_launches(KERNELS.values())
                params, opt_state, hist = launch_train.main(
                    ["--arch", arch, "--full", "--steps",
                     str(SSM_TRAIN_STEPS)])
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                launches = {k: v.launches for k, v in KERNELS.items()}
        finally:
            launch_train.train = real
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        lines = out.getvalue().splitlines()
        losses = [loss for _, loss in hist]
        step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
        for line in lines:
            print(f"  | {line}")
        print(f"  {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"ssm_chunk {cfg.ssm_chunk}), batch 8 x 64: losses "
              f"{[round(x, 4) for x in losses]}, steps after the first "
              f"{[round(x, 1) for x in step_ms]} ms, peak {peak:.2f} GiB "
              f"above the {held / 2**30:.2f} GiB held before; launches "
              f"{launches}", flush=True)
        head = re.fullmatch(rf"arch={re.escape(cfg.name)} params=[\d.]+M "
                            r"devices=\d+", lines[0]) if lines else None
        if (not head or len(losses) != SSM_TRAIN_STEPS
                or not np.isfinite(losses).all() or any(launches.values())):
            raise RuntimeError(f"{arch}: the launcher's lines {lines}, "
                               f"kernel launches {launches}")
        result[arch] = {"losses": losses, "step_ms": step_ms,
                        "peak_gib": peak,
                        "least": [train_least(cfg, 8, 64, np.mean(step_ms))]}
        del params, opt_state
        gc.collect()
        torch.cuda.empty_cache()
    print(f"ssm train runs: {json.dumps(result)}", flush=True)
    return result


def tp_traffic(eng, policy: str, snap_paged: bool = False,
               media_len: int = TP_MEDIA_LEN, upload_static: bool = True):
    """Phase 3's traffic at internvl2's image length (four two-image
    dialogues, 8 new tokens, the last with the MRAG query) under one
    policy, through ``eng`` with the plain versions forbidden and the
    launch counts reset first (``upload_static=False`` leaves the
    dialogue images to the library's peers).  Returns tokens, first-token
    logits, the launches (by route), TTFT, load and blocked time and
    decode step, the peak memory of this process and, with
    ``snap_paged``, a CPU copy of the pool's layer-0 snapshot once every
    slot decodes."""
    import torch

    from repro_torch.kernels import KERNELS, _build
    import repro_torch.kernels.selective_attn.ops as sel_ops
    from repro_torch.serving import Request, State

    d = eng.model.cfg.d_model
    cuda = eng.device.type == "cuda"
    samples, rag, _ = phase3_requests(d, media_len)
    firsts = {}
    finalize = eng._finalize_prefill

    def record(req, result, *rest):
        firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
        return finalize(req, result, *rest)

    eng._finalize_prefill = record
    # the host time of each step's broadcast of the libraries' changes
    sync_s = [0.0]
    sync = eng._sync_libraries

    def timed_sync():
        t0 = time.perf_counter()
        sync()
        sync_s[0] += time.perf_counter() - t0

    eng._sync_libraries = timed_sync
    snap = None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # (a rehearsal on the CPU runs the plain versions)
    with no_plain_versions() if cuda else contextlib.nullcontext():
        _build.reset_launches(KERNELS.values())
        t = time.perf_counter()
        for smp in samples if upload_static else ():
            for _, seg in smp.prompt.media_segments():
                eng.upload(smp.prompt.user_id, seg.media_id, seg.embeds)
        eng.upload("*", "rag-0", rag, dynamic=True)
        if cuda:
            torch.cuda.synchronize()
        upload_s = time.perf_counter() - t
        reqs = [Request(prompt=smp.prompt, max_new_tokens=MAX_NEW,
                        policy=policy, policy_kwargs={"k": K_MPIC}
                        if policy == "mpic" else {}) for smp in samples]
        reqs[-1].retrieval_query = rag.mean(0)
        passes = []
        with recording_passes(passes, mesh=eng.sharding and
                              eng.sharding.mesh):
            for r in reqs:
                eng.submit(r)
            steps = 0
            while eng.queue or any(eng.running):
                eng.step()
                steps += 1
                if steps > 10 * MAX_NEW * len(reqs):
                    raise RuntimeError("engine made no progress")
                if snap_paged and snap is None and all(
                        r is not None and r.state is State.RUNNING
                        for r in eng.running):
                    snap = {k: v.cpu() if torch.is_tensor(v) else v
                            for k, v in snapshot(eng).items()}
        if cuda:
            torch.cuda.synchronize()
        launches = {k: v.launches for k, v in KERNELS.items()}
        routes = dict(sel_ops.SEL_ATTN.route_launches)
    eng._finalize_prefill = finalize
    del eng._sync_libraries
    rep = eng.report()
    # the collectives of the first paged decode step and paged prefill,
    # with the shapes that decide them
    paged = {rec["kind"]: rec for rec in reversed(passes)
             if "lengths" in rec}
    return {
        "costs": pass_costs(passes),
        "collectives": {kind: {"shape": tuple(rec["q_pos"].shape)
                               if kind == "prefill"
                               else tuple(rec["lengths"].shape),
                               "calls": rec.get("calls", [])}
                        for kind, rec in paged.items()},
        "tokens": [list(r.output_tokens) for r in reqs],
        "firsts": np.stack([firsts[r.req_id] for r in reqs]),
        "done": [r.done for r in reqs],
        "linked_rag": "rag-0" in reqs[-1].linked_media,
        "prompt_tokens": [r.prompt.total_len for r in reqs],
        "launches": launches, "sel_attn_routes": routes,
        "upload_s": upload_s, "mean_ttft_ms": rep["mean_ttft_s"] * 1e3,
        "mean_prefill_ms": rep["mean_prefill_s"] * 1e3,
        "mean_load_ms": rep["scheduler"]["mean_load_s"] * 1e3,
        "mean_blocked_ms": rep["scheduler"]["mean_load_blocked_s"] * 1e3,
        "mean_decode_step_ms": rep["mean_decode_step_s"] * 1e3,
        "decode_steps": rep["decode_steps"],
        "sync_ms_per_step": sync_s[0] / max(steps, 1) * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
        else 0.0,
        "snap": snap}


def _tp_engine(cfg, params, pool, mesh=None, device=None, **kw):
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, MPICEngine
    return MPICEngine(build_model(cfg), params, EngineConfig(
        max_seq_len=2048, decode_slots=4, page_size=16, pool_dtype=pool),
        mesh=mesh, device=device, **kw)


def _fp32(cfg):
    """The exact check's model: ``cfg``'s widths, ``TP_FP32_DEPTH``
    layers, fp32 weights and compute."""
    return dataclasses.replace(cfg, num_layers=TP_FP32_DEPTH,
                               param_dtype="float32", compute_dtype="float32")


def _plant_fault(eng) -> None:
    """The last rank's view of every linked entry starts one kv head
    early (``TP_FAULT``): its attention reads a neighbour's K/V of the
    media, and the all-reduce hands that to every rank."""
    from repro_torch.serving.sharding import EntryShard

    plan = eng.sharding
    lo, n = plan._heads
    if plan.mesh.model_rank == plan.mesh.model - 1 and plan.attn:
        plan.entry = lambda e: None if e is None else EntryShard(
            e, lo - 1, n)


def _tp_suite(cfg, params, mesh, device, media_len, snap=False,
              fault=False, system=None):
    """``TP_RUNS`` on bf16 ``params`` (with ``fault`` under a mesh, also
    ``TP_FAULT``'s ``mpic`` run; with ``system``, phase 5p's runs under
    ``"system"``) and the exact check's ``mpic`` on fresh fp32 weights
    (seed 1) on each of ``TP_FP32_POOLS``: {label: ``tp_traffic``'s
    result}.  Under a mesh the weights are this rank's shards; ``snap``
    keeps the pool snapshots of the ``mpic`` runs.  ``params`` is emptied
    (the caller's bf16 weights go before the fp32 ones are drawn)."""
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sharding import ServingSharding

    out = {}
    for policy, pool in TP_RUNS:
        eng = _tp_engine(cfg, params[0], pool, mesh, device)
        out[f"{policy}-{pool or 'bf16'}"] = tp_traffic(
            eng, policy, snap_paged=snap and policy == "mpic",
            media_len=media_len)
        if eng.pool is not None:
            out["pool_shape"] = tuple(eng.pool.k.shape)
        eng.close()
    if fault and mesh is not None:
        eng = _tp_engine(cfg, params[0], "", mesh, device)
        _plant_fault(eng)
        out[TP_FAULT] = tp_traffic(eng, "mpic", media_len=media_len)
        eng.sharding.__dict__.pop("entry", None)
        eng.close()
    if system is not None and mesh is not None:
        out["system"] = _tp_system(cfg, params[0], mesh, device, media_len,
                                   system)
    params.clear()
    gc.collect()
    cfg32 = _fp32(cfg)
    sharding = None if mesh is None else ServingSharding(mesh, cfg32)
    p32 = init_params(cfg32, seed=1, device=device, sharding=sharding)
    for pool in TP_FP32_POOLS:
        eng = _tp_engine(cfg32, p32, pool, mesh, device)
        out[f"mpic-{pool + '-' if pool else ''}fp32"] = tp_traffic(
            eng, "mpic", media_len=media_len)
        eng.close()
    del eng, p32
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _disk_io(lib) -> dict:
    """A library's spool files written, and its disk and network reads."""
    tiers = lib.stats()["tiers"]
    return {"files_written": lib.disk.stats()["puts"],
            "bytes_written": tiers["disk"]["bytes_written"],
            "disk_fetches": tiers["disk"]["fetches"],
            "bytes_read": tiers["disk"]["bytes_read"],
            "disk_fetch_s": tiers["disk"]["fetch_s"],
            "network_fetches": tiers.get("network", {}).get("fetches", 0)}


def first_token_tie(thawed, cold) -> dict:
    """The two runs' first-token logits side by side: each run's top two
    tokens and their margin, the logits of both at the cold run's top
    token ``a`` and the thawed run's ``b``, the move of the gap between
    them, the noise floor (``TP_TIE_SIGMAS`` x sqrt(2) x RMS of thawed -
    cold) and whether the first tokens agree or the move lies within that
    floor."""
    thawed = np.asarray(thawed, np.float64).reshape(-1)
    cold = np.asarray(cold, np.float64).reshape(-1)
    top = {name: [int(i) for i in np.argsort(-x, kind="stable")[:2]]
           for name, x in (("thawed", thawed), ("cold", cold))}
    a, b = top["cold"][0], top["thawed"][0]
    move = float((cold[a] - cold[b]) + (thawed[b] - thawed[a]))
    floor = TP_TIE_SIGMAS * float(np.sqrt(2.0 * np.mean(
        (thawed - cold) ** 2)))
    return {"top2": top,
            "margins": {name: float(x[top[name][0]] - x[top[name][1]])
                        for name, x in (("thawed", thawed), ("cold", cold))},
            "at_a": [float(thawed[a]), float(cold[a])],
            "at_b": [float(thawed[b]), float(cold[b])],
            "gap_move": move, "tie_floor": floor,
            "ok": a == b or move <= floor}


def _tp_sessions(cfg, params, mesh, device, media_len, spool):
    """Phase 5p's sessions on one rank: phase 3's first dialogue under
    ``full_recompute`` uninterrupted, then frozen after
    ``SESSION_FREEZE_AFTER`` tokens and spooled (rank 0 writes the whole
    snapshot, gathered over the ranks' heads), thawed from disk, thawed
    again with a ``TP_SUFFIX``-token turn beside a cold ``full_recompute``
    of the whole history, and forked into ``TP_FORKS``; the launches of
    all of it."""
    import torch

    from repro_torch.cache import KVLibrary
    from repro_torch.cache.library import TIER_DISK
    from repro_torch.core import Prompt, text_segment
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.serving import Request

    cuda = mesh.device.type == "cuda"
    lib = KVLibrary(spool_dir=spool, device=device, mesh=mesh)
    eng = _tp_engine(cfg, params, "", mesh, device, static_library=lib)
    prompt = phase3_requests(cfg.d_model, media_len)[0][0].prompt
    secs, firsts = {}, []

    def timed(fn, key):
        def call(*args, **kwargs):
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
            secs[key] = time.perf_counter() - t
            return got
        return call

    def request(**kw):
        return Request(prompt=prompt, max_new_tokens=MAX_NEW,
                       policy="full_recompute", **kw)

    with no_plain_versions() if cuda else contextlib.nullcontext():
        _build.reset_launches(KERNELS.values())
        for _, seg in prompt.media_segments():
            eng.upload(prompt.user_id, seg.media_id, seg.embeds)
        base = eng.submit(request())
        eng.run()
        freeze, spool_now = eng.sessions.freeze, lib.spool_now
        eng.sessions.freeze = timed(freeze, "freeze_spooled_ms")
        lib.spool_now = timed(spool_now, "spool_ms")
        fz = eng.submit(request(freeze_after=SESSION_FREEZE_AFTER))
        eng.run()
        eng.sessions.freeze, lib.spool_now = freeze, spool_now
        h = eng.sessions.handles[fz.session_id]
        spooled = lib.peek_tier(h.user_id, h.media_id,
                                salt=h.cache_salt) == TIER_DISK
        th = timed(eng.thaw, "thaw_from_disk_ms")(h)
        eng.run()
        suffix = [int(t) for t in np.random.default_rng(21).integers(
            8, 200, TP_SUFFIX)]
        prefill = eng._prefiller.prefill

        def keep(*args):
            logits = prefill(*args)
            firsts.append(np.asarray(logits, np.float32))
            return logits

        eng._prefiller.prefill = keep
        th2 = timed(eng.thaw, "thaw_with_suffix_ms")(
            h, suffix, max_new_tokens=MAX_NEW)
        eng._prefiller.prefill = prefill
        eng.run()
        cold = Request(prompt=Prompt(list(prompt.segments) + [
            text_segment(fz.output_tokens + suffix)],
            user_id=prompt.user_id), max_new_tokens=MAX_NEW,
            policy="full_recompute")
        finalize = eng._finalize_prefill

        def record(req, result, *rest):
            firsts.append(np.asarray(result.first_logits, np.float32))
            return finalize(req, result, *rest)

        eng._finalize_prefill = record
        eng.submit(cold)
        eng.run()
        eng._finalize_prefill = finalize
        kids = timed(eng.fork, "fork_ms")(h, TP_FORKS,
                                          max_new_tokens=MAX_NEW)
        eng.run()
        if cuda:
            torch.cuda.synchronize()
        launches = {k: v.launches for k, v in KERNELS.items()}
    eng.close()
    diff = firsts[0] - firsts[1]
    return {"tokens": {"base": base.output_tokens, "frozen": fz.output_tokens,
                       "thawed": th.output_tokens,
                       "suffix_thawed": th2.output_tokens,
                       "cold": cold.output_tokens,
                       "forks": [k.output_tokens for k in kids]},
            "done": [r.done for r in (base, th, th2, cold, *kids)],
            "spooled": spooled, "n_ctx": h.n_ctx,
            "suffix_rel_rms": float(np.linalg.norm(diff)
                                    / np.linalg.norm(firsts[1])),
            "first_token": first_token_tie(firsts[0], firsts[1]),
            **{k: v * 1e3 for k, v in secs.items()},
            "launches": launches, **_disk_io(lib)}


def _tp_replicas(cfg, params, mesh, device, media_len):
    """Phase 5p's cluster on one rank: two replicas over the mesh, the
    affinity router, an aging queue and phase 3's traffic with a priority
    a request; returns the tokens by request, each replica's admission
    order, the routing and the launches."""
    import torch

    from repro_torch.kernels import KERNELS, _build
    from repro_torch.models import build_model
    from repro_torch.serving import (ClusterConfig, EngineConfig,
                                     MPICCluster)

    cuda = mesh.device.type == "cuda"
    cluster = MPICCluster(build_model(cfg), params, EngineConfig(
        max_seq_len=2048, decode_slots=4, page_size=16,
        queue_aging_s=TP_AGING_S), ClusterConfig(
        replicas=2, router="affinity"), mesh=mesh, device=device)
    samples, rag, requests = phase3_requests(cfg.d_model, media_len)
    reqs = requests()
    admitted = []
    for eng in cluster.engines:
        def pop(_pop=eng.scheduler.pop, replica=eng.replica_id):
            req, handle = _pop()
            admitted.append((replica, reqs.index(req)))
            return req, handle
        eng.scheduler.pop = pop
    with no_plain_versions() if cuda else contextlib.nullcontext():
        _build.reset_launches(KERNELS.values())
        for smp in samples:
            for _, seg in smp.prompt.media_segments():
                cluster.upload(smp.prompt.user_id, seg.media_id, seg.embeds)
        cluster.upload("*", "rag-0", rag, dynamic=True)
        for r, priority in zip(reqs, TP_PRIORITIES):
            r.priority = priority
            cluster.submit(r)
        cluster.run()
        if cuda:
            torch.cuda.synchronize()
        launches = {k: v.launches for k, v in KERNELS.items()}
    rep = cluster.report()
    cluster.close()
    return {"tokens": [list(r.output_tokens) for r in reqs],
            "done": [r.done for r in reqs], "admitted": admitted,
            "routed": [d.replica for d in cluster.decisions],
            "mean_ttft_ms": rep["mean_ttft_s"] * 1e3, "launches": launches}


def _tp_system(cfg, params, mesh, device, media_len, system):
    """Phase 5p on one rank, on 5o's bf16 weights: {label: result}.
    ``system``: the spool root the ranks share, the queue to the parent
    (rank 0 says there when its spool of every image is whole) and the
    queue the parent's block server's address comes back on."""
    import torch

    from repro_torch.cache import FaultPlan, KVLibrary
    from repro_torch.cache.library import RankDivergence
    from repro_torch.cache.net import PeerTransport

    t = time.perf_counter()
    root = system["root"]
    out = {}

    def spooled(name, faults=None):
        return [KVLibrary(shared=shared, spool_dir=os.path.join(root, name),
                          hbm_capacity=0, host_capacity=0, device=device,
                          faults=faults, mesh=mesh)
                for shared in (False, True)]

    def settle():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # the warm memory run each tier is read against: 5o's ran first in
    # these processes and paid their warm-up
    for pool in ("", "int8"):
        eng = _tp_engine(cfg, params, pool, mesh, device)
        res = tp_traffic(eng, "mpic", media_len=media_len)
        res.pop("snap")
        out[f"memory-{pool or 'bf16'}"] = res
        eng.close()
        settle()
    for pool in ("", "int8"):
        static, dynamic = spooled("disk")
        eng = _tp_engine(cfg, params, pool, mesh, device,
                         static_library=static, dynamic_library=dynamic)
        res = tp_traffic(eng, "mpic", media_len=media_len)
        res.pop("snap")
        out[f"disk-{pool or 'bf16'}"] = dict(res, **_disk_io(static))
        eng.close()
        settle()
    if mesh.rank == 0:
        system["to_parent"].put(pickle.dumps(
            ("spool", os.path.join(root, "disk"))))
    addr = system["from_parent"].get(timeout=TP_JOIN_S)
    for pool in ("", "int8"):
        label = f"peer-{pool or 'bf16'}"
        static = KVLibrary(peers=[PeerTransport(
            addr, timeout_s=TP_PEER_TIMEOUT_S)], device=device,
            spool_dir=os.path.join(root, label), mesh=mesh)
        eng = _tp_engine(cfg, params, pool, mesh, device,
                         static_library=static)
        res = tp_traffic(eng, "mpic", media_len=media_len,
                         upload_static=False)
        res.pop("snap")
        out[label] = dict(res, **_disk_io(static))
        eng.close()
        settle()
    out["sessions"] = _tp_sessions(cfg, params, mesh, device, media_len,
                                   os.path.join(root, "sessions"))
    settle()
    out["replicas"] = _tp_replicas(cfg, params, mesh, device, media_len)
    settle()
    # the planted divergence: rank 1's own reads of the spool fail
    static, dynamic = spooled("fault", FaultPlan.parse(TP_READ_FAULT)
                              if mesh.rank == 1 else None)
    eng = _tp_engine(cfg, params, "", mesh, device, static_library=static,
                     dynamic_library=dynamic)
    try:
        tp_traffic(eng, "mpic", media_len=media_len)
        out["fault"] = {"raised": None}
    except RankDivergence as exc:
        out["fault"] = {"raised": str(exc)}
    finally:
        eng.close()
    settle()
    out["seconds"] = time.perf_counter() - t
    return out


def _tp_rank(rank, world, port, cfg, device, media_len, out_q,
             system=None):
    """One rank of phases 5o and 5p: its process group, its shard of the
    seeded weights drawn directly (``init_params(sharding=)``), then
    ``_tp_suite``; its results (and rank 0's pool snapshots) go to
    ``out_q``."""
    import torch

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sharding import ServingSharding

    mesh = None
    try:
        mesh = make_serving_mesh(1, world, rank=rank, timeout_s=TP_JOIN_S,
                                 init_method=f"tcp://127.0.0.1:{port}",
                                 device=device)
        if mesh.device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        t = time.perf_counter()
        params = init_params(cfg, seed=0, device=mesh.device,
                             sharding=ServingSharding(mesh, cfg))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t, "device": str(mesh.device),
               "backend": mesh.backend,
               "weights_gib": sum(p.numel() * p.element_size() for p in
                                  params.parameters()) / 2**30}
        held = [params]
        del params
        res["runs"] = _tp_suite(cfg, held, mesh, mesh.device, media_len,
                                snap=rank == 0,
                                fault=cfg.num_layers <= TP_DEPTH,
                                system=system)
        res["pool_shape"] = res["runs"].pop("pool_shape")
        res["system"] = res["runs"].pop("system", None)
        # by value: a tensor shared by descriptor dies with this process
        out_q.put(pickle.dumps((rank, res, None)))
    except BaseException:
        import traceback
        out_q.put(pickle.dumps((rank, None, traceback.format_exc())))
    finally:
        if mesh is not None:
            mesh.close()


def tp_block_server(spool: str, world: int, to_ranks):
    """Phase 5p (b)'s peer: a block server in this process over a library
    rehydrated from the ranks' spool (on the CPU: a spooled block is served
    from its file), its address sent to every rank."""
    from repro_torch.cache import KVLibrary, KVPeerServer

    lib = KVLibrary(spool_dir=spool, rehydrate=True, device="cpu")
    server = KVPeerServer(lib)
    print(f"  5p: a block server at {server.address} over the ranks' spool "
          f"(rehydrated {lib.rehydrate_stats})", flush=True)
    for _ in range(world):
        to_ranks.put(server.address)
    return server


def tp_system_check(got, world: int, key: str, cuda: bool) -> dict:
    """Phase 5p's gates and lines over every rank's results: the warm
    memory, disk and peer runs' tokens equal to the rank's memory run of
    5o on the same pool, rank 0 alone writing the spool and pulling, each
    tier's TTFT against the warm memory run; the session's ranks equal,
    its resume exact, its suffix thaw within ``SESSION_REL_RMS`` of a cold
    recompute with the same first token or a near tie
    (:func:`first_token_tie`), its forks greedy identical; the replicas' tokens equal to the memory run's, one
    admission order and routing on every rank; the planted read fault
    raised on every rank.  Kernels 1/3/5 (2/4 on int8) on each rank.
    Returns the runs for the kernels' line."""
    failed = []
    sysres = [got[r]["system"] for r in range(world)]
    runs = {}

    def need(label):
        paged = ("sel_attn_paged_q8", "paged_attn_q8") \
            if "int8" in label else ("sel_attn_paged", "paged_attn")
        return ("sel_attn",) + paged

    def kernels_ok(label, launches):
        return not cuda or all(launches[n] > 0 for n in need(label))

    for pool in ("bf16", "int8"):
        for r, res in enumerate(sysres):
            warm = res[f"memory-{pool}"]
            same = warm["tokens"] == got[r]["runs"][f"mpic-{pool}"]["tokens"]
            print(f"  5p rank {r} memory-{pool} (warm): TTFT mean "
                  f"{warm['mean_ttft_ms']:.2f} ms, load "
                  f"{warm['mean_load_ms']:.2f} ms, blocked "
                  f"{warm['mean_blocked_ms']:.2f} ms a request, decode step "
                  f"{warm['mean_decode_step_ms']:.2f} ms, the libraries' sync"
                  f" {warm['sync_ms_per_step']:.3f} ms a step; tokens equal "
                  f"to 5o's memory run's {same}", flush=True)
            if not (same and all(warm["done"])):
                failed.append(f"memory-{pool} rank {r}")
    for label in ("disk-bf16", "disk-int8", "peer-bf16", "peer-int8"):
        memory = f"mpic-{label.split('-')[1]}"
        for r, res in enumerate(sysres):
            run = res[label]
            mem = got[r]["runs"][memory]
            warm = res[f"memory-{label.split('-')[1]}"]
            lead = r == 0
            print(f"  5p rank {r} {label}: TTFT mean {run['mean_ttft_ms']:.2f}"
                  f" ms, {run['mean_ttft_ms'] / warm['mean_ttft_ms']:.3f}x the"
                  f" warm memory run's {warm['mean_ttft_ms']:.2f}, load "
                  f"{run['mean_load_ms']:.2f} ms, blocked "
                  f"{run['mean_blocked_ms']:.2f} ms a request; spool files "
                  f"written {run['files_written']} ({run['bytes_written'] / 2**20:.1f}"
                  f" MiB), disk reads {run['disk_fetches']} "
                  f"({run['bytes_read'] / 2**20:.1f} MiB in "
                  f"{run['disk_fetch_s']:.3f} s), peer pulls "
                  f"{run['network_fetches']}; tokens equal to the memory "
                  f"run's {run['tokens'] == mem['tokens']}; launches "
                  f"{run['launches']}", flush=True)
            if label.startswith("peer"):
                # rank 0 pulls and writes, the others read its files
                io = ((run["network_fetches"] > 0) == lead
                      and (run["disk_fetches"] > 0) != lead)
            else:
                io = run["disk_fetches"] > 0
            ok = (run["tokens"] == mem["tokens"] and all(run["done"])
                  and run["linked_rag"] and io
                  and (run["files_written"] > 0) == lead
                  and kernels_ok(label, run["launches"]))
            if not ok:
                failed.append(f"{label} rank {r}")
        runs[f"{key}:system-{label}"] = {
            "model": key, "world": world, "launches": sysres[0][label][
                "launches"],
            "launches_by_rank": [res[label]["launches"] for res in sysres],
            **{k: [res[label][k] for res in sysres] for k in (
                "mean_ttft_ms", "mean_load_ms", "mean_blocked_ms",
                "files_written", "bytes_read")},
            "warm_memory_ttft_ms": [res[f"memory-{label.split('-')[1]}"][
                "mean_ttft_ms"] for res in sysres]}
    sess = [res["sessions"] for res in sysres]
    for r, s in enumerate(sess):
        tok = s["tokens"]
        resumed = tok["frozen"][:-1] + tok["thawed"] == tok["base"]
        forks = all(k[:len(tok["thawed"])] == tok["thawed"]
                    for k in tok["forks"])
        first = tok["suffix_thawed"][0] == tok["cold"][0]
        tie = s["first_token"]
        print(f"  5p rank {r} sessions: frozen after "
              f"{SESSION_FREEZE_AFTER} tokens (n_ctx {s['n_ctx']}), spooled "
              f"{s['spooled']}: freeze with its spool "
              f"{s['freeze_spooled_ms']:.2f} ms (spool {s['spool_ms']:.2f}),"
              f" thaw from disk {s['thaw_from_disk_ms']:.2f} ms, thaw with "
              f"a {TP_SUFFIX}-token turn {s['thaw_with_suffix_ms']:.2f} ms, "
              f"fork into {TP_FORKS} {s['fork_ms']:.2f} ms; resume exact "
              f"{resumed}; the suffix thaw against a cold full_recompute: "
              f"relative RMS {s['suffix_rel_rms']:.3e} (limit "
              f"{SESSION_REL_RMS}), first token equal {first}; forks greedy "
              f"identical {forks}; tokens equal to rank 0's "
              f"{tok == sess[0]['tokens']}; launches {s['launches']}",
              flush=True)
        print(f"  5p rank {r} sessions, first-token logits: top two "
              f"(token, margin) thawed {tie['top2']['thawed']} "
              f"{tie['margins']['thawed']:.4e}, cold {tie['top2']['cold']} "
              f"{tie['margins']['cold']:.4e}; thawed / cold at the cold "
              f"run's top token {tie['at_a'][0]:.4e} / {tie['at_a'][1]:.4e},"
              f" at the thawed run's {tie['at_b'][0]:.4e} / "
              f"{tie['at_b'][1]:.4e}; the gap between them moved "
              f"{tie['gap_move']:.4e} against a noise floor of "
              f"{tie['tie_floor']:.4e} ({TP_TIE_SIGMAS} x sqrt(2) x RMS of "
              f"thawed - cold): the same token or a near tie {tie['ok']}",
              flush=True)
        if not (resumed and forks and tie["ok"] and s["spooled"]
                and all(s["done"]) and tok == sess[0]["tokens"]
                and s["suffix_rel_rms"] <= SESSION_REL_RMS
                and kernels_ok("sessions", s["launches"])):
            failed.append(f"sessions rank {r}")
    runs[f"{key}:system-sessions"] = {
        "model": key, "world": world, "launches": sess[0]["launches"],
        "launches_by_rank": [s["launches"] for s in sess],
        **{k: [s[k] for s in sess] for k in (
            "freeze_spooled_ms", "spool_ms", "thaw_from_disk_ms",
            "thaw_with_suffix_ms", "fork_ms", "suffix_rel_rms")},
        "first_token": [s["first_token"] for s in sess]}
    reps = [res["replicas"] for res in sysres]
    for r, rp in enumerate(reps):
        mem = got[r]["runs"]["mpic-bf16"]
        print(f"  5p rank {r} replicas: routed {rp['routed']}, admitted "
              f"(replica, request) {rp['admitted']}, TTFT mean "
              f"{rp['mean_ttft_ms']:.2f} ms; tokens equal to the one-engine "
              f"run's {rp['tokens'] == mem['tokens']}; launches "
              f"{rp['launches']}", flush=True)
        if not (rp["tokens"] == mem["tokens"] and all(rp["done"])
                and rp["admitted"] == reps[0]["admitted"]
                and rp["routed"] == reps[0]["routed"]
                and kernels_ok("replicas", rp["launches"])):
            failed.append(f"replicas rank {r}")
    runs[f"{key}:system-replicas"] = {
        "model": key, "world": world, "launches": reps[0]["launches"],
        "launches_by_rank": [rp["launches"] for rp in reps],
        "mean_ttft_ms": [rp["mean_ttft_ms"] for rp in reps]}
    for r, res in enumerate(sysres):
        raised = res["fault"]["raised"]
        print(f"  5p rank {r} planted read fault ({TP_READ_FAULT} on rank "
              f"1): raised {raised!r}; the phase took {res['seconds']:.1f} "
              "s on this rank", flush=True)
        if not raised:
            failed.append(f"fault rank {r} did not raise")
    if failed:
        raise RuntimeError("phase 5p: " + "; ".join(failed))
    return runs


def tp_collectives_check(cfg, label: str, per) -> dict:
    """Each rank's live collectives in its first paged decode step and
    paged prefill of run ``label`` against what the dry run's recording
    mesh counts on ``meta`` for the same config, rank and shapes (the
    serving steps of ``launch.dryrun.trace_serving``, on a bf16 pool: the
    collectives run on activations, whatever the pool holds).  Raises
    when they differ in count, kind or bytes."""
    from repro_torch.launch.dryrun import trace_serving
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.roofline.analysis import collective_bytes

    out = {}
    for r, res in enumerate(per):
        for kind, step in (("decode", "serve_decode"),
                           ("prefill", "serve_prefill")):
            live = res["collectives"][kind]
            shape = live["shape"]
            traced = trace_serving(
                cfg, step, RecordingMesh(len(per), r), slots=shape[0],
                kv_len=2048, s_sel=shape[1] if kind == "prefill" else None)[2]
            got, want = live["calls"], traced
            print(f"  {label} rank {r} {kind} {shape}: {len(got)} "
                  f"collectives, {collective_bytes(got).total_bytes:.0f} "
                  f"wire bytes live; the dry run's {len(want)}, "
                  f"{collective_bytes(want).total_bytes:.0f}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 5o {label} rank {r} {kind}: live "
                                   f"collectives {got}, the dry run's {want}")
            out[f"rank {r} {kind}"] = {
                "count": len(got),
                "wire_bytes": collective_bytes(got).total_bytes}
    return out


def _rel(got, ref):
    """(relative RMS, max |diff| over max |ref|) of two logit stacks."""
    diff = got - ref
    return (float(np.linalg.norm(diff) / np.linalg.norm(ref)),
            float(np.abs(diff).max() / np.abs(ref).max()))


def serve_tensor_parallel(*, device=None, cfg=None,
                          media_len: int = TP_MEDIA_LEN):
    """Phase 5o: internvl2-76b tensor-parallel.  With four cards or more,
    four NCCL ranks at full depth (one card each); otherwise two gloo ranks
    on card 0 at ``TP_DEPTH`` layers, then the unsharded engine of that
    depth on the same card once the ranks have exited.  Each rank draws
    its shard of the seeded weights (never the whole model) and serves
    ``TP_RUNS`` in bf16 (at ``TP_DEPTH``, also ``TP_FAULT``), then the
    exact check (``_fp32``) on each of ``TP_FP32_POOLS``.  Gates: every
    rank finishes every request with the same tokens, finite first logits,
    kernels 1/3 (2/4 on int8) and 5 launched on each rank, the bf16 runs
    none on the CUDA cores; against the unsharded engine the exact
    checks' tokens equal and their first-token logits within
    ``TP_FP32_REL``; at ``TP_DEPTH``, the bf16 runs' relative RMS within
    ``TP_FLOOR_FACTOR`` times the floor that the unsharded engine shows
    with its row products split as the ranks split them, and the planted
    fault's above that (bf16 tokens printed, not gated).
    Returns (the runs by label, rank 0's pool snapshots by pool, the world
    size).  ``device``, ``cfg`` (the whole model's, its depth as given)
    and ``media_len`` rehearse it on the CPU."""
    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (
        backend_for,
        free_port,
        make_serving_mesh,
    )
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sharding import ServingSharding, _fp32_matmul

    full = get_config(TP_ARCH)
    cuda = device is None
    cards = torch.cuda.device_count() if cuda else 0
    world, depth = (4, full.num_layers) if cards >= 4 else (2, TP_DEPTH)
    if cfg is None:
        cfg = dataclasses.replace(full, num_layers=depth)
    depth = cfg.num_layers
    backend = backend_for(torch.device("cuda" if cuda else "cpu"), world)
    used = min(world, cards) if cuda else 1
    print(f"tensor_parallel: {TP_ARCH} world size {world}, backend "
          f"{backend}, depth {depth} of {full.num_layers} layers (the exact "
          f"check {TP_FP32_DEPTH}, fp32), cards {cards}", flush=True)
    # the host time the ranks' recording adds to each collective
    coll_record_s = collective_record_s()
    print(f"  recording a collective: {coll_record_s * 1e6:.3f} us on the "
          "host", flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    # phase 5p: the spool the ranks share, and the block server this
    # process runs over it once rank 0 says that every image is spooled
    system = {"root": tempfile.mkdtemp(prefix="tp_system_"),
              "to_parent": q, "from_parent": ctx.Queue()}
    peer = None
    port = free_port()
    t = time.perf_counter()
    procs = [ctx.Process(target=_tp_rank, args=(
        r, world, port, cfg, device, media_len, q, system))
        for r in range(world)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < world:
            if time.perf_counter() - t > TP_JOIN_S:
                raise RuntimeError(f"phase 5o: no result from ranks "
                                   f"{sorted(set(range(world)) - set(got))}"
                                   f" in {TP_JOIN_S:.0f} s")
            try:
                msg = pickle.loads(q.get(timeout=5.0))
                if isinstance(msg[0], str):
                    peer = tp_block_server(msg[1], world,
                                           system["from_parent"])
                    continue
                rank, res, err = msg
            except queue.Empty:
                # a rank that died before it could report (its start-up)
                dead = [r for r, proc in enumerate(procs)
                        if r not in got and proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"phase 5o: ranks {dead} exited "
                                       "without a result")
                continue
            if err is not None:
                raise RuntimeError(f"phase 5o: rank {rank} failed:\n{err}")
            got[rank] = res
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        if peer is not None:
            peer.close()
        shutil.rmtree(system["root"], ignore_errors=True)
    ranks_s = time.perf_counter() - t
    bad = [proc.exitcode for proc in procs if proc.exitcode != 0]
    if bad:
        raise RuntimeError(f"phase 5o: rank exit codes {bad}")
    runs, snaps = {}, {}
    key = f"{TP_ARCH}:tp{world}"
    for label in got[0]["runs"]:
        per = [got[r]["runs"][label] for r in range(world)]
        r0 = per[0]
        paged = ("sel_attn_paged_q8", "paged_attn_q8") \
            if "int8" in label else ("sel_attn_paged", "paged_attn")
        need = ("sel_attn",) + (paged if label.startswith("mpic")
                                else paged[1:])
        for r, res in enumerate(per):
            if (not all(res["done"]) or not res["linked_rag"]
                    or res["tokens"] != r0["tokens"]
                    or not np.isfinite(res["firsts"]).all()
                    or (cuda and any(res["launches"][n] == 0
                                     for n in need))
                    or (not label.endswith("fp32")
                        and res["sel_attn_routes"].get("cuda_cores"))):
                raise RuntimeError(f"phase 5o {label}: rank {r}: "
                                   f"{ {k: v for k, v in res.items() if k not in ('firsts', 'snap')} }")
            print(f"  rank {r} {label}: TTFT mean {res['mean_ttft_ms']:.2f}"
                  f" ms (prefill alone {res['mean_prefill_ms']:.2f} ms), "
                  f"decode step {res['mean_decode_step_ms']:.2f} ms over "
                  f"{res['decode_steps']} steps (the libraries' sync "
                  f"{res['sync_ms_per_step']:.3f} ms a step), uploads "
                  f"{res['upload_s']:.3f} s, peak {res['peak_gib']:.2f} GiB "
                  f"(this rank's process); launches {res['launches']}, "
                  f"sel_attn by route {res['sel_attn_routes']}", flush=True)
        if r0["snap"] is not None:
            snaps[label.split("-")[1]] = r0["snap"]
        runs[f"{key}:{label}"] = {
            "model": key, "world": world, "backend": backend,
            "depth": TP_FP32_DEPTH if label.endswith("fp32") else depth,
            "launches": r0["launches"],
            "launches_by_rank": [res["launches"] for res in per],
            **{k: [res[k] for res in per] for k in (
                "mean_ttft_ms", "mean_prefill_ms", "mean_decode_step_ms",
                "sync_ms_per_step", "upload_s", "peak_gib")},
            "prompt_tokens": r0["prompt_tokens"],
            "sel_attn_routes": r0["sel_attn_routes"]}
        if label in TP_LABELS:
            # each rank's steps beside their least time on the cards the
            # ranks share (the ranks' work adds up on a shared card)
            runs[f"{key}:{label}"]["least"] = [
                row for r, res in enumerate(per)
                for row in served_rows(
                    f"{key}:{label} rank {r}", res["costs"],
                    len(res["done"]), res["decode_steps"],
                    res["mean_prefill_ms"], res["mean_decode_step_ms"],
                    n_params=cfg.n_active_params(), scale=world / used,
                    chips=used, note=f"{world} ranks on {used} card(s)",
                    collective_s=coll_record_s)]
        if label.startswith("mpic") and label in TP_LABELS:
            runs[f"{key}:{label}"]["collectives"] = tp_collectives_check(
                cfg, label, per)
    print(f"  ranks: {[got[r]['device'] for r in range(world)]}, pool "
          f"{got[0]['pool_shape']} a rank, weights "
          f"{[round(got[r]['weights_gib'], 2) for r in range(world)]} GiB, "
          f"drawn in {[round(got[r]['init_s'], 1) for r in range(world)]} "
          f"s; {ranks_s:.1f} s from spawn to the last result", flush=True)
    # the unsharded engine on the same card: the bf16 runs where the depth
    # fits one card, and the exact check
    if depth > TP_DEPTH:
        print(f"  unsharded bf16 runs: not run ({depth} layers do not fit "
              "one card)")
        cfg32 = _fp32(cfg)
        p32 = init_params(cfg32, seed=1, device=device)
        whole = {}
        for pool in TP_FP32_POOLS:
            eng = _tp_engine(cfg32, p32, pool, None, device)
            whole[f"mpic-{pool + '-' if pool else ''}fp32"] = tp_traffic(
                eng, "mpic", media_len=media_len)
            eng.close()
        del eng, p32
    else:
        t = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        if cuda:
            torch.cuda.synchronize()
        print(f"  unsharded {depth}-layer model: "
              f"{sum(p.numel() * p.element_size() for p in params.parameters()) / 2**30:.2f}"
              f" GiB drawn in {time.perf_counter() - t:.1f} s", flush=True)
        # the bf16 floor: the same weights in one process (a 1x1 mesh, no
        # collective), every row-parallel product cut in the ranks' halves
        # whose fp32 partial sums are added and rounded once, as the ranks'
        # all-reduce adds them
        plan = ServingSharding(make_serving_mesh(1, 1, device=device), cfg)

        def split_rows(x, w):
            k = w.shape[0] // world
            parts = [_fp32_matmul(x[..., i * k:(i + 1) * k],
                                  w[i * k:(i + 1) * k]) for i in range(world)]
            return sum(parts[1:], parts[0]).to(x.dtype)

        plan.row_parallel = split_rows
        params.sharding = plan
        floors = {}
        for pool in ("", "int8"):
            eng = _tp_engine(cfg, params, pool, None, device)
            floors[f"mpic-{pool or 'bf16'}"] = tp_traffic(
                eng, "mpic", media_len=media_len)
            eng.close()
        params.sharding = None
        held = [params]
        del params, eng
        whole = _tp_suite(cfg, held, None, device, media_len)
        whole.pop("pool_shape")
    failed = []
    limits = {}
    if depth <= TP_DEPTH:
        for label, floor in floors.items():
            ref = whole[label]
            floor_rel, floor_max = _rel(floor["firsts"], ref["firsts"])
            limits[label] = TP_FLOOR_FACTOR * floor_rel
            print(f"  floor of {label}, the unsharded engine with its "
                  f"row-parallel products split in {world} and summed in "
                  f"fp32: first-token logits relative RMS {floor_rel:.2e}, "
                  f"max {floor_max:.2e}; tokens equal "
                  f"{floor['tokens'] == ref['tokens']}; the limit "
                  f"{TP_FLOOR_FACTOR} x {floor_rel:.2e} = "
                  f"{limits[label]:.2e}", flush=True)
            runs[f"{key}:{label}"].update(floor_rel=floor_rel,
                                          floor_rel_max=floor_max)
        # the int8 pool's runs against its floor, the others the bf16's
        for label in whole:
            limits.setdefault(label, limits["mpic-int8" if "int8" in label
                                            else "mpic-bf16"])
        whole[TP_FAULT] = whole["mpic-bf16"]
        limits[TP_FAULT] = limits["mpic-bf16"]
    for label, ref in whole.items():
        r0 = got[0]["runs"][label]
        rel, rel_max = _rel(r0["firsts"], ref["firsts"])
        same = r0["tokens"] == ref["tokens"]
        lead = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                     len(x)) for x, y in zip(r0["tokens"], ref["tokens"])]
        exact = label.endswith("fp32")
        print(f"  unsharded {label}: TTFT mean {ref['mean_ttft_ms']:.2f} ms,"
              f" decode step {ref['mean_decode_step_ms']:.2f} ms, peak "
              f"{ref['peak_gib']:.2f} GiB; tokens equal to rank 0's {same} "
              f"(equal leading tokens {lead} of {MAX_NEW}); first-token "
              f"logits relative RMS {rel:.2e}, max |diff| over max |logit| "
              f"{rel_max:.2e} (limit "
              + (f"{TP_FP32_REL} on the latter" if exact
                 else f"{limits[label]:.2e} on the former, "
                 + ("which this planted fault must exceed"
                    if label == TP_FAULT else "not above")) + ")",
              flush=True)
        runs[f"{key}:{label}"].update(
            unsharded_mean_ttft_ms=ref["mean_ttft_ms"],
            unsharded_mean_decode_step_ms=ref["mean_decode_step_ms"],
            unsharded_peak_gib=ref["peak_gib"], first_logits_rel=rel,
            first_logits_rel_max=rel_max, tokens_equal=same,
            equal_leading_tokens=lead)
        if exact:
            ok = same and rel_max <= TP_FP32_REL
        elif label == TP_FAULT:
            ok = rel > limits[label]
        else:
            ok = rel <= limits[label]
        if not ok:
            failed.append(f"{label}: tokens {r0['tokens']} vs unsharded "
                          f"{ref['tokens']}, logits rel {rel} / {rel_max}"
                          + ("" if exact else f", limit {limits[label]}"))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError("phase 5o: " + "; ".join(failed))
    # phase 5p's gates, once 5o's have all held
    runs.update(tp_system_check(got, world, key, cuda))
    return runs, snaps, world


@contextlib.contextmanager
def counting_drops(into):
    """Inside the block every MoE routing pass's (rows, dropped pairs) is
    appended to ``into``, in the order the passes route (one a layer)."""
    import repro_torch.models.moe as moe_mod

    real = moe_mod.route

    def counting(*args, **kwargs):
        out = real(*args, **kwargs)
        into.append((int(out[1].shape[0]), int((~out[4]).sum())))
        return out

    moe_mod.route = counting
    try:
        yield into
    finally:
        moe_mod.route = real


@contextlib.contextmanager
def capture_first_ssd(into):
    """A CPU copy of the first SSD chunk call's inputs (layer 0 of the
    first prefill), strides and all, in ``into["args"]``."""
    import repro_torch.models.ssm as ssm_mod

    real = ssm_mod.ssd_chunk

    def recording(*args):
        if "args" not in into:
            into["args"] = tuple(t.clone().cpu() for t in args)
        return real(*args)

    ssm_mod.ssd_chunk = recording
    try:
        yield
    finally:
        ssm_mod.ssd_chunk = real


def _split_plan(cfg, world: int, device):
    """The floor's plan: one process (a 1 x 1 mesh, no collective) that
    cuts what ``world`` ranks cut as they cut it (attention's and the
    MLP's row products, the SSM's ``out_proj``, the shared experts' down
    projection in ``world`` row blocks, the routed experts' combine in
    ``world`` expert groups), each part's fp32 sum added in fp32 and
    rounded once, as the ranks' all-reduce adds them."""
    from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
    from repro_torch.serving.sharding import ServingSharding, _fp32_matmul

    plan = ServingSharding(make_serving_mesh(1, 1, device=device), cfg)
    ranks = ServingSharding(ServingMesh(1, world, 0, "gloo", plan.mesh.device),
                            cfg)
    plan.attn, plan.mlp, plan.vocab = ranks.attn, ranks.mlp, ranks.vocab
    plan.experts, plan.ssm = ranks.experts, ranks.ssm

    def split_partial(x, w):
        k = w.shape[0] // world
        parts = [_fp32_matmul(x[..., i * k:(i + 1) * k], w[i * k:(i + 1) * k])
                 for i in range(world)]
        return sum(parts[1:], parts[0])

    def split_experts(contrib, gate_idx):
        n = cfg.num_experts // world
        parts = [(contrib.float() * ((gate_idx >= i * n)
                                     & (gate_idx < (i + 1) * n))[..., None]
                  ).sum(dim=1) for i in range(world)]
        return sum(parts[1:], parts[0])

    plan.partial_product = split_partial
    plan.row_parallel = lambda x, w: split_partial(x, w).to(x.dtype)
    plan.expert_partial = split_experts
    return plan


def tq_ssm_traffic(eng, media_len: int, long_prompt=None, ssd_into=None):
    """Phase 5q's traffic of the SSM and the hybrid on the dense cache:
    four two-image dialogues (their media inlined by the prefill; after
    ``long_prompt`` where given) under ``full_recompute``, ``MAX_NEW``
    tokens each, the plain versions forbidden on the card and the launch
    counts reset first.  Returns what ``tp_traffic`` does (tokens,
    first-token logits, launches by kernel and route, TTFT, prefill alone,
    decode step, peak) and the collectives of the first prefill and the
    first decode pass with their shapes; ``ssd_into`` takes the first SSD
    chunk call's inputs."""
    import torch

    import repro_torch.kernels.selective_attn.ops as sel_ops
    import repro_torch.kernels.ssd_chunk.ops as ssd_ops
    from repro_torch.data import make_dialogues
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.serving import Request

    cfg = eng.model.cfg
    cuda = eng.device.type == "cuda"
    samples = make_dialogues(n=4, n_images=2, d_model=cfg.d_model,
                             media_len=media_len, style="mmdu")
    prompts = [long_prompt] * (long_prompt is not None) + [
        s.prompt for s in samples]
    firsts = {}
    finalize = eng._finalize_prefill

    def record(req, result, *rest):
        firsts[req.req_id] = np.asarray(result.first_logits, np.float32)
        return finalize(req, result, *rest)

    eng._finalize_prefill = record
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with (no_plain_versions() if cuda else contextlib.nullcontext()), (
            capture_first_ssd(ssd_into) if ssd_into is not None
            else contextlib.nullcontext()):
        _build.reset_launches(KERNELS.values())
        reqs = [Request(prompt=p, max_new_tokens=MAX_NEW,
                        policy="full_recompute") for p in prompts]
        passes = []
        with recording_passes(passes, idle_pos=eng.cfg.max_seq_len - 1,
                              mesh=eng.mesh):
            for r in reqs:
                eng.submit(r)
            steps = 0
            while eng.queue or any(eng.running):
                eng.step()
                steps += 1
                if steps > 10 * MAX_NEW * len(reqs):
                    raise RuntimeError("engine made no progress")
        if cuda:
            torch.cuda.synchronize()
        launches = {k: v.launches for k, v in KERNELS.items()}
        routes = {"sel_attn": dict(sel_ops.SEL_ATTN.route_launches),
                  "ssd_chunk": dict(ssd_ops.SSD_CHUNK.route_launches)}
    eng._finalize_prefill = finalize
    rep = eng.report()
    prefill = next(p for p in passes if p["kind"] == "prefill")
    decode = next(p for p in passes if p["kind"] == "decode")
    return {
        "costs": pass_costs(passes),
        "collectives": {
            "prefill": {"rows": 1, "tokens": int(prefill["q_pos"].shape[1]),
                        "calls": prefill.get("calls", [])},
            "decode": {"rows": int(decode["q_pos"].shape[0]),
                       "tokens": eng.cfg.max_seq_len,
                       "calls": decode.get("calls", [])}},
        "tokens": [list(r.output_tokens) for r in reqs],
        "firsts": np.stack([firsts[r.req_id] for r in reqs]),
        "done": [r.done and r.prefill_stats.get("policy") == "full_recompute"
                 for r in reqs],
        "prompt_tokens": [r.prompt.total_len for r in reqs],
        "launches": launches, "routes": routes,
        "mean_ttft_ms": rep["mean_ttft_s"] * 1e3,
        "mean_prefill_ms": rep["mean_prefill_s"] * 1e3,
        "mean_decode_step_ms": rep["mean_decode_step_s"] * 1e3,
        "decode_steps": rep["decode_steps"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
        else 0.0}


def tq_whisper(cfg, model, params, device, mesh=None, capture=None):
    """Phase 5q's whisper run: ``run_whisper`` of ``whisper_traffic(cfg)``
    (``cfg`` the whole model's) through ``model`` and ``params`` (a rank's
    shard under ``mesh``), the plain versions forbidden on the card and
    the launch counts reset first; ``capture`` takes layer 0's
    dense-attention inputs (CPU copies).  Returns tokens, each prompt's
    last prefill logits (``firsts``), launches, encode / prefill / decode
    times, peak and the first decode pass's collectives."""
    import torch

    import repro_torch.kernels.selective_attn.ops as sel_ops
    from repro_torch.kernels import KERNELS, _build

    cuda = torch.device(device if device is not None else "cuda").type \
        == "cuda"
    audio, prompts = whisper_traffic(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    live = {} if capture is not None else None
    with no_plain_versions() if cuda else contextlib.nullcontext():
        _build.reset_launches(KERNELS.values())
        passes = []
        with recording_passes(passes, mesh=mesh):
            out = run_whisper(model, params, audio, prompts, device=device,
                              capture=live)
        launches = {k: v.launches for k, v in KERNELS.items()}
        routes = {"sel_attn": dict(sel_ops.SEL_ATTN.route_launches)}
    if capture is not None:
        capture.update({k: tuple(t.cpu() if torch.is_tensor(t) else t
                                 for t in v) for k, v in live.items()})
    decode = next(p for p in passes if p["kind"] == "decode")
    firsts = np.stack([p[-1] for p in out["prefill"]])
    return {
        "costs": pass_costs(passes),
        "collectives": {"decode": {
            "rows": int(decode["q_pos"].shape[0]), "tokens": WHISPER_KV_LEN,
            "calls": decode.get("calls", [])}},
        "tokens": out["tokens"].tolist(), "firsts": firsts,
        "done": [bool(np.isfinite(out["decode"]).all())] * len(prompts),
        "prompt_tokens": [len(p) for p in prompts],
        "launches": launches, "routes": routes,
        "encode_ms": out["encode_s"] * 1e3,
        "mean_ttft_ms": (out["encode_s"] + out["cross_kv_s"]
                         + float(np.mean(out["prefill_s"]))) * 1e3,
        "mean_prefill_ms": float(np.mean(out["prefill_s"])) * 1e3,
        "mean_decode_step_ms": float(np.mean(out["decode_s"][1:])) * 1e3,
        "decode_steps": MAX_NEW,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
        else 0.0}


def _plant_expert_fault(plan):
    """``TQ_FAULT`` on the last rank: its expert slice starts one expert
    early (its first weights serve another rank's expert, its last
    expert's pairs go unserved).  Returns the slice to restore."""
    saved = plan.expert_range
    if plan.mesh.rank == plan.mesh.model - 1 and plan.experts:
        lo, n = saved
        plan.expert_range = (lo - 1, n)
    return saved


def _tq_moe(cfg, held, mesh, device, media_len, *, runs=TP_RUNS,
            fault=False, fp32=True, snap=False):
    """deepseek's runs of phase 5q: ``runs`` (policy, pool) on
    ``held[0]`` (a rank's shard under ``mesh``; whole, or carrying the
    floor's plan, without), with ``fp32`` the exact check on fresh fp32
    weights (seed 1, ``TP_FP32_DEPTH`` layers; ``held`` is emptied
    first), with ``fault`` ``TQ_FAULT``'s run and ``TQ_FAULT_FP32``'s.
    Every run counts the pairs each routing pass drops (``drops``)."""
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sharding import ServingSharding

    def serve(c, params, policy, pool, snap_paged=False):
        eng = _tp_engine(c, params, pool, mesh, device)
        try:
            drops = []
            with counting_drops(drops):
                r = tp_traffic(eng, policy, snap_paged=snap_paged,
                               media_len=media_len)
            r["drops"] = drops
            if eng.pool is not None:
                r["pool_shape"] = tuple(eng.pool.k.shape)
            return r
        finally:
            eng.close()

    def faulty(label, c, params):
        plan = params.sharding
        saved = _plant_expert_fault(plan)
        try:
            out[label] = serve(c, params, "mpic", "")
        finally:
            plan.expert_range = saved

    out = {}
    for policy, pool in runs:
        out[f"{policy}-{pool or 'bf16'}"] = serve(
            cfg, held[0], policy, pool, snap and policy == "mpic")
    if fault:
        faulty(TQ_FAULT, cfg, held[0])
    if fp32:
        held.clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        cfg32 = _fp32(cfg)
        p32 = init_params(cfg32, seed=1, device=device, sharding=None
                          if mesh is None else ServingSharding(mesh, cfg32))
        for pool in TP_FP32_POOLS:
            out[f"mpic-{pool + '-' if pool else ''}fp32"] = serve(
                cfg32, p32, "mpic", pool)
        if fault:
            faulty(TQ_FAULT_FP32, cfg32, p32)
        del p32
    return out


def _tq_suite(cfg, held, mesh, device, media_len, *, capture=None,
              floor=False):
    """Phase 5q's runs of one model (``cfg`` the whole model's) on
    ``held[0]``: a rank's shard under ``mesh``; else whole, carrying the
    floor's plan with ``floor`` (deepseek then serves its ``mpic`` runs
    alone).  ``capture`` (rank 0's) takes deepseek's pool snapshots,
    whisper's layer-0 attention inputs and mamba2's first SSD chunk
    inputs."""
    from repro_torch.core import Prompt, text_segment
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, MPICEngine

    if cfg.arch_type == "moe":
        if floor:
            return _tq_moe(cfg, held, None, device, media_len,
                           runs=(("mpic", ""), ("mpic", "int8")), fp32=False)
        return _tq_moe(cfg, held, mesh, device, media_len,
                       fault=mesh is not None, snap=capture is not None)
    model = build_model(cfg) if mesh is None else \
        held[0].sharding.local_model()
    if cfg.is_encoder_decoder:
        return {"serve": tq_whisper(cfg, model, held[0], device, mesh,
                                    capture)}
    eng = MPICEngine(build_model(cfg), held[0], EngineConfig(
        max_seq_len=HYMBA_SEQ if cfg.hybrid else 2048, decode_slots=4,
        paged=True), mesh=mesh, device=device)
    long_prompt = Prompt([text_segment(np.random.default_rng(7).integers(
        8, 200, HYMBA_LONG))], user_id="u0") if cfg.hybrid else None
    try:
        return {"full_recompute": tq_ssm_traffic(
            eng, media_len, long_prompt,
            capture if capture is not None and cfg.attn_free else None)}
    finally:
        eng.close()


def _all_reduce_ms(mesh, shape) -> float:
    """Milliseconds of one ``mesh.all_reduce`` of an fp32 tensor of
    ``shape`` on the mesh's device: ``TQ_COLL_ITERS`` calls after three
    warm ones, each rank in step (every rank calls it)."""
    import torch

    x = torch.zeros(shape, dtype=torch.float32, device=mesh.device)
    cuda = mesh.device.type == "cuda"
    for _ in range(3):
        mesh.all_reduce(x)
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TQ_COLL_ITERS):
        mesh.all_reduce(x)
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / TQ_COLL_ITERS * 1e3


def _tq_rank(rank, world, port, cfgs, device, media_len, out_q):
    """One rank of phase 5q: its process group, then for each model its
    shard of the seeded weights drawn directly (``init_params(
    sharding=)``) and ``_tq_suite``; the results (rank 0's captures too)
    go to ``out_q``, pickled by value."""
    import torch

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sharding import ServingSharding

    mesh = None
    try:
        mesh = make_serving_mesh(1, world, rank=rank, timeout_s=TP_JOIN_S,
                                 init_method=f"tcp://127.0.0.1:{port}",
                                 device=device)
        cuda = mesh.device.type == "cuda"
        if not cuda:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        res = {}
        for arch, cfg in cfgs.items():
            t = time.perf_counter()
            params = init_params(cfg, seed=0, device=mesh.device,
                                 sharding=ServingSharding(mesh, cfg))
            if cuda:
                torch.cuda.synchronize()
            plan = params.sharding
            info = {"init_s": time.perf_counter() - t,
                    "device": str(mesh.device), "backend": mesh.backend,
                    "cuts": plan.cuts, "widths": plan.widths,
                    "weights_gib": sum(p.numel() * p.element_size() for p in
                                       params.parameters()) / 2**30}
            held = [params]
            del params
            capture = {} if rank == 0 else None
            runs = _tq_suite(cfg, held, mesh, mesh.device, media_len,
                             capture=capture)
            if cfg.arch_type == "moe":
                info["experts_all_reduce_ms"] = {
                    rows: _all_reduce_ms(mesh, (2, rows, cfg.d_model))
                    for rows in TQ_COLL_ROWS}
            res[arch] = {**info, "runs": runs, "capture": capture}
            held.clear()
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        out_q.put(pickle.dumps((rank, res, None)))
    except BaseException:
        import traceback
        out_q.put(pickle.dumps((rank, None, traceback.format_exc())))
    finally:
        if mesh is not None:
            mesh.close()


def _tq_spawn(world: int, cfgs, device, media_len) -> list:
    """Phase 5q's ranks of one world size, spawned; every rank's results
    in rank order.  Raises on a rank's error, a rank that died without a
    result, a non-zero exit, or past ``TP_JOIN_S``."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t = time.perf_counter()
    procs = [ctx.Process(target=_tq_rank, args=(
        r, world, port, cfgs, device, media_len, q)) for r in range(world)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < world:
            if time.perf_counter() - t > TP_JOIN_S:
                raise RuntimeError(f"phase 5q: no result from ranks "
                                   f"{sorted(set(range(world)) - set(got))}"
                                   f" in {TP_JOIN_S:.0f} s")
            try:
                rank, res, err = pickle.loads(q.get(timeout=5.0))
            except queue.Empty:
                dead = [r for r, proc in enumerate(procs)
                        if r not in got and proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"phase 5q: ranks {dead} exited "
                                       "without a result")
                continue
            if err is not None:
                raise RuntimeError(f"phase 5q: rank {rank} failed:\n{err}")
            got[rank] = res
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    bad = [proc.exitcode for proc in procs if proc.exitcode != 0]
    if bad:
        raise RuntimeError(f"phase 5q: rank exit codes {bad}")
    print(f"  {world} ranks of {sorted(cfgs)}: "
          f"{time.perf_counter() - t:.1f} s from spawn to the last result",
          flush=True)
    return [got[r] for r in range(world)]


def tq_collectives_check(cfg, label: str, per) -> dict:
    """Each rank's live collectives in the first prefill and decode pass
    of a dense-cache run (``tq_ssm_traffic``, ``tq_whisper``) against
    what the dry run's recording mesh counts on ``meta`` for the same
    config, rank and shapes (``launch.dryrun.trace_step``).  Raises when
    they differ in count, kind or bytes."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import ProductionMesh
    from repro_torch.roofline.analysis import collective_bytes

    mesh = ProductionMesh(("data", "model"), (1, len(per)))
    out = {}
    for kind, live in per[0]["collectives"].items():
        want = trace_step(cfg, kind, InputShape(
            "5q", live["tokens"], live["rows"], kind), mesh)[2]
        for r, res in enumerate(per):
            got = res["collectives"][kind]["calls"]
            print(f"  {label} rank {r} {kind} ({live['rows']} rows): "
                  f"{len(got)} collectives, "
                  f"{collective_bytes(got).total_bytes:.0f} wire bytes "
                  f"live; the dry run's {len(want)}, "
                  f"{collective_bytes(want).total_bytes:.0f}", flush=True)
            if got != want:
                raise RuntimeError(f"phase 5q {label} rank {r} {kind}: live "
                                   f"collectives {got}, the dry run's {want}")
            out[f"rank {r} {kind}"] = {
                "count": len(got),
                "wire_bytes": collective_bytes(got).total_bytes}
    return out


# the kernels each model's runs must launch on every rank (int8 pools:
# kernels 2 and 4 in place of 1 and 3; deepseek's full_recompute runs
# kernel 5 in place of 1)
TQ_KERNELS = {"moe": ("sel_attn", "sel_attn_paged", "paged_attn"),
              "ssm": ("ssd_chunk",), "hybrid": ("sel_attn", "ssd_chunk"),
              "audio": ("sel_attn",)}


def serve_tensor_families(*, device=None, cfgs=None,
                          media_len: int = TP_MEDIA_LEN):
    """Phase 5q (see ``TQ_MOE``): deepseek-moe-16b over two gloo ranks on
    one card at full depth (four NCCL ranks with four cards), mamba2-130m,
    hymba-1.5b and whisper-small over two ranks, then each model's
    unsharded engine on the same card.  Gates: every rank ends every
    request with the same tokens and finite first logits; each model's
    kernels (``TQ_KERNELS``) launched on every rank; every bf16 run's
    first-token logits within ``TP_FLOOR_FACTOR`` times the floor
    (``_split_plan``) of the unsharded engine's; deepseek's exact check
    (fp32, ``TP_FP32_DEPTH`` layers, both pools): the unsharded engine's
    tokens, logits within ``TP_FP32_REL``, on the fp32 pool the pairs
    every routing pass drops, and the planted fault's logits above that
    limit; each rank's live collectives equal to the dry run's
    recording.  Returns (runs by label, rank 0's
    paged snapshots by (key, pool), rank 0's captures by model key).
    ``device``, ``cfgs`` ({arch: whole config}) and ``media_len``
    rehearse it on the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import backend_for
    from repro_torch.models.transformer import init_params

    cuda = device is None
    cards = torch.cuda.device_count() if cuda else 0
    cfgs = cfgs or {arch: get_config(arch) for arch in TQ_ARCHS}
    worlds = {arch: (4 if cards >= 4 and cfg.arch_type == "moe"
                     else TQ_SMALL_WORLD) for arch, cfg in cfgs.items()}
    coll_record_s = collective_record_s()
    got = {}
    for world in sorted(set(worlds.values()), reverse=True):
        group = {a: c for a, c in cfgs.items() if worlds[a] == world}
        print(f"tensor_families: {sorted(group)} over {world} ranks, "
              f"backend {backend_for(torch.device('cuda' if cuda else 'cpu'), world)}, "
              f"cards {cards}", flush=True)
        per = _tq_spawn(world, group, device, media_len)
        for arch in group:
            got[arch] = [p[arch] for p in per]
    runs, snaps, captures, failed = {}, {}, {}, []
    for arch, cfg in cfgs.items():
        per_rank = got[arch]
        world = len(per_rank)
        used = min(world, cards) if cuda else 1
        key = f"{arch}:tp{world}"
        print(f"  {key}: cuts {per_rank[0]['cuts']}, widths "
              f"{per_rank[0]['widths']}, weights "
              f"{[round(p['weights_gib'], 2) for p in per_rank]} GiB a rank "
              f"(drawn in {[round(p['init_s'], 1) for p in per_rank]} s) on "
              f"{[p['device'] for p in per_rank]}", flush=True)
        if "experts_all_reduce_ms" in per_rank[0]:
            print(f"  {key}: the experts' all-reduce (routed and shared "
                  f"partial sums, fp32, one a layer) alone, ms a call by "
                  f"rows: {[p['experts_all_reduce_ms'] for p in per_rank]}",
                  flush=True)
        if per_rank[0]["capture"]:
            captures[key] = per_rank[0]["capture"]
        family = "moe" if cfg.arch_type == "moe" else (
            "hybrid" if cfg.hybrid else "ssm" if cfg.attn_free else "audio")
        for label in per_rank[0]["runs"]:
            per = [p["runs"][label] for p in per_rank]
            r0 = per[0]
            need = TQ_KERNELS[family]
            if family == "moe" and not label.startswith("mpic"):
                need = tuple(n for n in need if n != "sel_attn_paged")
            if "int8" in label:
                need = tuple(n + "_q8" if n != "sel_attn" else n
                             for n in need)
            for r, res in enumerate(per):
                if (not all(res["done"]) or res["tokens"] != r0["tokens"]
                        or not np.isfinite(res["firsts"]).all()
                        or (cuda and any(res["launches"][n] == 0
                                         for n in need))):
                    raise RuntimeError(
                        f"phase 5q {key} {label}: rank {r}: "
                        f"{ {k: v for k, v in res.items() if k not in ('firsts', 'snap', 'costs')} }")
                print(f"  rank {r} {label}: TTFT mean "
                      f"{res['mean_ttft_ms']:.2f} ms (prefill alone "
                      f"{res['mean_prefill_ms']:.2f} ms), decode step "
                      f"{res['mean_decode_step_ms']:.2f} ms over "
                      f"{res['decode_steps']} steps, peak "
                      f"{res['peak_gib']:.2f} GiB (this rank's process); "
                      f"launches { {k: n for k, n in res['launches'].items() if n} }",
                      flush=True)
            if r0.get("snap") is not None:
                snaps[key, label.split("-")[1]] = r0["snap"]
            run = runs[f"{key}:{label}"] = {
                "model": key, "world": world, "backend": per_rank[0]["backend"],
                "depth": TP_FP32_DEPTH if "fp32" in label
                else cfg.num_layers,
                "launches": r0["launches"],
                "launches_by_rank": [res["launches"] for res in per],
                **{k: [res[k] for res in per] for k in (
                    "mean_ttft_ms", "mean_prefill_ms", "mean_decode_step_ms",
                    "peak_gib")},
                "prompt_tokens": r0["prompt_tokens"]}
            if "experts_all_reduce_ms" in per_rank[0]:
                run["experts_all_reduce_ms"] = [
                    p["experts_all_reduce_ms"] for p in per_rank]
            if "drops" in r0:
                run["dropped_pairs"] = sum(d for _, d in r0["drops"])
            if label in TP_LABELS or label in ("full_recompute", "serve"):
                run["least"] = [
                    row for r, res in enumerate(per)
                    for row in served_rows(
                        f"{key}:{label} rank {r}", res["costs"],
                        len(res["done"]), res["decode_steps"],
                        res["mean_prefill_ms"], res["mean_decode_step_ms"],
                        n_params=cfg.n_active_params(), scale=world / used,
                        chips=used, note=f"{world} ranks on {used} card(s)",
                        collective_s=coll_record_s)]
                for row in run["least"]:
                    print(f"    {row['step']}: {row['measured_ms']:.3f} ms "
                          f"/ least {row['least_ms']:.4f} ms "
                          f"({row['bound_by']}), share {row['share']:.4f}",
                          flush=True)
            if family == "moe" and label in ("mpic-bf16", "mpic-int8"):
                run["collectives"] = tp_collectives_check(cfg, f"{key} "
                                                          f"{label}", per)
            elif family != "moe":
                run["collectives"] = tq_collectives_check(
                    cfg, f"{key} {label}", per)
        # the unsharded engine on the same card, once the ranks are gone:
        # the floor (the ranks' cut in one process), then the same runs
        t = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        params.sharding = _split_plan(cfg, world, device)
        floors = _tq_suite(cfg, [params], None, device, media_len,
                           floor=True)
        params.sharding = None
        whole = _tq_suite(cfg, [params], None, device, media_len)
        del params
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        print(f"  {key}: the unsharded engine's runs took "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        limits = {}
        for label, floor in floors.items():
            floor_rel, floor_max = _rel(floor["firsts"],
                                        whole[label]["firsts"])
            limits[label] = TP_FLOOR_FACTOR * floor_rel
            print(f"  {key} floor of {label}, the unsharded engine with "
                  f"the ranks' cut in {world}: first-token logits relative "
                  f"RMS {floor_rel:.2e}, max {floor_max:.2e}; tokens equal "
                  f"{floor['tokens'] == whole[label]['tokens']}; the limit "
                  f"{TP_FLOOR_FACTOR} x {floor_rel:.2e} = "
                  f"{limits[label]:.2e}", flush=True)
            runs[f"{key}:{label}"].update(floor_rel=floor_rel,
                                          floor_rel_max=floor_max)
        for label, ref in whole.items():
            limits.setdefault(label, limits.get(
                "mpic-int8" if "int8" in label else "mpic-bf16"))
        if TQ_FAULT in got[arch][0]["runs"]:
            whole[TQ_FAULT], limits[TQ_FAULT] = whole["mpic-bf16"], \
                limits["mpic-bf16"]
            whole[TQ_FAULT_FP32] = whole["mpic-fp32"]
        for label, ref in whole.items():
            r0 = got[arch][0]["runs"][label]
            rel, rel_max = _rel(r0["firsts"], ref["firsts"])
            same = r0["tokens"] == ref["tokens"]
            exact = label.endswith("fp32") or label == TQ_FAULT_FP32
            drops_same = r0.get("drops") == ref.get("drops")
            print(f"  unsharded {key} {label}: TTFT mean "
                  f"{ref['mean_ttft_ms']:.2f} ms (prefill alone "
                  f"{ref['mean_prefill_ms']:.2f}), decode step "
                  f"{ref['mean_decode_step_ms']:.2f} ms, peak "
                  f"{ref['peak_gib']:.2f} GiB; rank 0's tokens equal {same}; "
                  f"first-token logits relative RMS {rel:.2e}, max |diff| "
                  f"over max |logit| {rel_max:.2e} (limit "
                  + (f"{TP_FP32_REL} on the latter"
                     + (", which this planted fault must exceed"
                        if label == TQ_FAULT_FP32 else "") if exact
                     else f"{limits[label]:.2e} on the former"
                     + (", the planted fault's reading beside it"
                        if label == TQ_FAULT else ", not above")) + ")"
                  + (f"; pairs dropped, every routing pass: equal "
                     f"{drops_same} ({sum(d for _, d in ref['drops'])} "
                     f"unsharded, {sum(d for _, d in r0['drops'])} rank 0)"
                     if "drops" in ref else ""), flush=True)
            runs[f"{key}:{label}"].update(
                unsharded_mean_ttft_ms=ref["mean_ttft_ms"],
                unsharded_mean_prefill_ms=ref["mean_prefill_ms"],
                unsharded_mean_decode_step_ms=ref["mean_decode_step_ms"],
                unsharded_peak_gib=ref["peak_gib"], first_logits_rel=rel,
                first_logits_rel_max=rel_max, tokens_equal=same)
            if label == TQ_FAULT_FP32:
                ok = rel_max > TP_FP32_REL
            elif exact:
                # the pairs dropped: on the fp32 pool, where the ranks'
                # activations are the unsharded engine's to fp32 rounding
                ok = (same and rel_max <= TP_FP32_REL and (
                    "int8" in label or (drops_same and any(
                        d for _, d in ref["drops"]))))
            elif label == TQ_FAULT:
                ok = True
            else:
                ok = rel <= limits[label]
            if not ok:
                failed.append(f"{key} {label}: tokens {r0['tokens']} vs "
                              f"unsharded {ref['tokens']}, logits rel {rel} /"
                              f" {rel_max}" + ("" if exact else
                                               f", limit {limits[label]}")
                              + (f", drops equal {drops_same}"
                                 if exact else ""))
    if failed:
        raise RuntimeError("phase 5q: " + "; ".join(failed))
    return runs, snaps, captures


# ---------------------------------------------------------------------------
# phase 5r: the data axis of the serving mesh
# ---------------------------------------------------------------------------

def pool_digest(eng) -> dict:
    """A digest of the engine's pool (and an int8 pool's scales), every
    page but the scratch page (idle slots' padding writes land there): per
    tensor the int64 sum of its 32-bit words (16-bit and 8-bit values
    packed) each weighted by its index mod 65,521 plus one, over a
    layer's pages at a time on the device.  Two pools whose digests
    agree hold the same bytes but for a collision; a row written one slot
    off moves it."""
    import torch

    pool = eng.pool
    keep = torch.tensor([p for p in range(pool.cfg.num_pages)
                         if p != eng._scratch_page], device=pool.k.device)
    out = {}
    names = ("k", "v") + (("k_scale", "v_scale") if pool.quantized else ())
    for name in names:
        t = getattr(pool, name)
        total = 0
        for layer in range(t.shape[0]):
            words = t[layer].index_select(0, keep).contiguous().view(
                torch.int32).reshape(-1).to(torch.int64)
            w = torch.arange(words.numel(), device=words.device) % 65521 + 1
            total += int((words * w).sum())
        out[name] = total
    return out


def _shift_rows(plan) -> None:
    """``TR_ROW_FAULT``: this data rank gathers every slot's new K/V rows
    one slot off (a roll over the slots), so that it writes each slot's
    row where its neighbour's belongs; the logits' gather stays right."""
    import torch

    real = plan.gather_slots

    def shifted(x, slots, dim=0):
        out = real(x, slots, dim)
        return torch.roll(out, 1, dims=dim) if dim == 2 else out

    plan.gather_slots = shifted


def _offset_lse(plan) -> None:
    """``TR_LSE_FAULT``: this data rank's log-sum-exp reads one more than
    it is before the long decode's merge."""
    real = plan.merge_kv_slices
    plan.merge_kv_slices = lambda out, lse: real(out, lse + TR_LSE_FAULT)


def _timed_gathers(plan, into: dict) -> None:
    """The host seconds of every ``share_rows`` and ``gather_slots`` call
    (the data gathers of a decode step and their writes), synchronized on
    the card before and after, summed into ``into``."""
    import torch

    for name in ("share_rows", "gather_slots"):
        real = getattr(plan, name)

        def timed(*args, _real=real, _name=name, **kw):
            if plan.mesh.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*args, **kw)
            if plan.mesh.device.type == "cuda":
                torch.cuda.synchronize()
            into[_name] = into.get(_name, 0.0) + time.perf_counter() - t0
            return out

        setattr(plan, name, timed)


def ring_cache(cfg, device, plan=None, seed: int = 7) -> dict:
    """A seeded dense cache of batch 1 holding a wrapped ring of
    ``cfg.sliding_window`` slots (positions ``at - W .. at - 1``, each at
    slot ``p % W``, ``at = W + TR_LONG_PAST``) in the compute dtype, drawn
    a layer at a time from one generator, the same numbers on every rank;
    with ``plan`` only the rank's slice of the slots and its kv heads."""
    import torch

    from repro_torch.device import torch_dtype

    w, dt = cfg.sliding_window, torch_dtype(cfg.compute_dtype)
    at = w + TR_LONG_PAST
    lo, n = plan.kv_slice(w) if plan is not None else (0, w)
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (1, w, cfg.num_kv_heads, cfg.head_dim)
    k, v = [], []
    for _ in range(cfg.num_layers):
        for into in (k, v):
            t = torch.randn(shape, generator=gen, device=device).to(dt)
            if plan is not None:
                t = plan.local_heads(t, 2)
            into.append(t[:, lo:lo + n].clone())
    pos = torch.arange(at - w, at, device=device, dtype=torch.int32)
    ring = torch.empty((1, w), dtype=torch.int32, device=device)
    ring[0, pos % w] = pos
    return {"k": torch.stack(k), "v": torch.stack(v),
            "pos": ring[:, lo:lo + n].contiguous()}


def long_decode_run(cfg, params, device, plan=None,
                    steps: int = TR_LONG_STEPS):
    """The dry run's ``long_500k`` step (``specs.make_step_fn("decode")``)
    from :func:`ring_cache` for ``steps`` steps past the wrap, each fed a
    seeded token (the same in every run, so that every step's logits
    compare across runs whatever their argmax), through ``params`` (a
    rank's shard under ``plan``, whose data axis the batch of 1 does not
    divide: the KV sequence on ``data``).  Returns the logits of every
    step, the mean step ms (after one warm step), the kernels' launches
    and dense routes over the steps, the collectives of the first step
    and the peak memory."""
    import torch

    import repro_torch.kernels.selective_attn.ops as sel_ops
    from repro_torch.configs import InputShape
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import record_collectives
    from repro_torch.models import build_model

    from repro_torch.device import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = plan.local_model() if plan is not None else build_model(cfg)
    local = model.cfg
    cache = ring_cache(cfg, device, plan)
    shape = InputShape("long_decode", TR_LONG_SEQ, 1, "decode")
    fn = S.make_step_fn(local, "decode", shape, model)
    at = cfg.sliding_window + TR_LONG_PAST
    fed = np.random.default_rng(11).integers(1, cfg.vocab_size, steps)
    out, times, calls = [], [], []
    with (no_plain_versions() if cuda else contextlib.nullcontext()), \
            torch.inference_mode():
        _build.reset_launches(KERNELS.values())
        for i in range(steps):
            p = torch.full((1, 1), at + i, dtype=torch.int32, device=device)
            tok = torch.full((1, 1), int(fed[i]), dtype=torch.int32,
                             device=device)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (record_collectives(plan.mesh) if plan is not None
                  and i == 0 else contextlib.nullcontext([])) as got:
                logits, cache = fn(params, cache, tok, p)
            if cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            calls = calls or list(got)
            out.append(logits[0].float().cpu().numpy())
        launches = {k: v.launches for k, v in KERNELS.items()}
        routes = dict(sel_ops.SEL_ATTN.route_launches)
    return {"logits": np.stack(out), "step_ms": float(np.mean(times[1:]))
            * 1e3, "launches": launches, "routes": routes, "calls": calls,
            "slots": tuple(cache["k"].shape),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
            else 0.0}


def _tr_llava(cfg, mesh, device, media_len) -> dict:
    """One rank of phase 5r's llava: its shard of the seeded weights
    (``init_params(sharding=)``), ``TP_RUNS`` on 5o's traffic (each with
    its pool's digest and the data gathers' seconds), the exact check in
    fp32 at ``TP_FP32_DEPTH`` layers on both pools, the row fault in that
    check (``TR_ROW_FAULT``, on data rank 1), and the long decode in bf16
    at full depth and in fp32 with and without the log-sum-exp fault
    (``TR_LSE_FAULT``, on data rank 1)."""
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sharding import ServingSharding

    cuda = mesh.device.type == "cuda"
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device=device,
                         sharding=ServingSharding(mesh, cfg))
    if cuda:
        torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t, "device": str(mesh.device),
           "backend": mesh.backend,
           "coords": (mesh.rank, mesh.data_rank, mesh.model_rank),
           "weights_gib": sum(p.numel() * p.element_size()
                              for p in params.parameters()) / 2**30,
           "runs": {}}

    def serve(label, whole, prm, pool, policy, fault=None):
        eng = _tp_engine(whole, prm, pool, mesh, device)
        gathers = {}
        _timed_gathers(eng.sharding, gathers)
        if fault is not None and mesh.data_rank == 1:
            fault(eng.sharding)
        out = tp_traffic(eng, policy, media_len=media_len)
        out["digest"] = pool_digest(eng)
        out["slots"] = eng._own
        out["gather_ms_per_step"] = (1e3 * sum(gathers.values())
                                     / max(out["decode_steps"], 1))
        res["runs"][label] = out
        eng.close()
        del eng
        gc.collect()

    for policy, pool in TP_RUNS:
        serve(f"{policy}-{pool or 'bf16'}", cfg, params, pool, policy)
    res["long-bf16"] = long_decode_run(cfg, params, device, params.sharding)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cfg32 = _fp32(cfg)
    p32 = init_params(cfg32, seed=1, device=device,
                      sharding=ServingSharding(mesh, cfg32))
    for pool in TP_FP32_POOLS:
        serve(f"mpic-{pool + '-' if pool else ''}fp32", cfg32, p32, pool,
              "mpic")
    serve(TR_ROW_FAULT, cfg32, p32, "", "mpic", fault=_shift_rows)
    res["long-fp32"] = long_decode_run(cfg32, p32, device, p32.sharding)
    if mesh.data_rank == 1:
        _offset_lse(p32.sharding)
    res["long-fp32-fault"] = long_decode_run(cfg32, p32, device,
                                             p32.sharding, steps=1)
    del p32
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def _tr_hymba(cfg, mesh, device) -> dict:
    """One rank of phase 5r's hymba on ``data 2 x model 1``: the whole
    seeded weights, ``tq_ssm_traffic``'s four dialogues on the dense cache
    (each rank holds its two slots' rows)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import EngineConfig, MPICEngine
    from repro_torch.serving.sharding import ServingSharding

    params = init_params(cfg, seed=0, device=device,
                         sharding=ServingSharding(mesh, cfg))
    eng = MPICEngine(build_model(cfg), params, EngineConfig(
        max_seq_len=2048, decode_slots=4), mesh=mesh, device=device)
    try:
        out = tq_ssm_traffic(eng, TP_MEDIA_LEN)
        out["cache_rows"] = int(eng._batch_cache["k"].shape[1])
        out["slots"] = eng._own
    finally:
        eng.close()
    del params, eng
    gc.collect()
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tr_rank(rank, shape, port, cfg, device, media_len, out_q):
    """One rank of phase 5r (world rank ``rank`` of a ``data x model``
    mesh of ``shape``): llava's suite on ``2 x 2``, hymba's on ``2 x 1``;
    its results go to ``out_q``, pickled by value."""
    import torch

    from repro_torch.launch.mesh import make_serving_mesh

    mesh = None
    try:
        mesh = make_serving_mesh(*shape, rank=rank, timeout_s=TP_JOIN_S,
                                 init_method=f"tcp://127.0.0.1:{port}",
                                 device=device)
        if mesh.device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // mesh.world))
        res = (_tr_hymba(cfg, mesh, mesh.device) if cfg.hybrid else
               _tr_llava(cfg, mesh, mesh.device, media_len))
        out_q.put(pickle.dumps((rank, res, None)))
    except BaseException:
        import traceback
        out_q.put(pickle.dumps((rank, None, traceback.format_exc())))
    finally:
        if mesh is not None:
            mesh.close()


def _tr_spawn(shape, cfg, device, media_len) -> list:
    """Phase 5r's ranks of one mesh, spawned; every rank's results in rank
    order.  Raises on a rank's error, a rank that died without a result, a
    non-zero exit, or past ``TP_JOIN_S``."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t = time.perf_counter()
    procs = [ctx.Process(target=_tr_rank, args=(
        r, shape, port, cfg, device, media_len, q)) for r in range(world)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        while len(got) < world:
            if time.perf_counter() - t > TP_JOIN_S:
                raise RuntimeError(f"phase 5r: no result from ranks "
                                   f"{sorted(set(range(world)) - set(got))}"
                                   f" in {TP_JOIN_S:.0f} s")
            try:
                rank, res, err = pickle.loads(q.get(timeout=5.0))
            except queue.Empty:
                dead = [r for r, proc in enumerate(procs)
                        if r not in got and proc.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"phase 5r: ranks {dead} exited "
                                       "without a result")
                continue
            if err is not None:
                raise RuntimeError(f"phase 5r: rank {rank} failed:\n{err}")
            got[rank] = res
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    bad = [proc.exitcode for proc in procs if proc.exitcode != 0]
    if bad:
        raise RuntimeError(f"phase 5r: rank exit codes {bad}")
    print(f"  {shape[0]} x {shape[1]} ranks of {cfg.name}: "
          f"{time.perf_counter() - t:.1f} s from spawn to the last result",
          flush=True)
    return [got[r] for r in range(world)]


def _split_keys_attention(data: int):
    """The long decode's floor: ``transformer.selective_attention`` over
    a ring cut in ``data`` slices of its slots, each through kernel 5 with
    its log-sum-exp and merged in fp32 as the data ranks merge them
    (``ServingSharding.merge_kv_slices``), in one process."""
    import torch

    import repro_torch.models.transformer as tf

    real = tf.selective_attention

    def split(q, k, v, q_pos, kv_pos, *, window=0, return_lse=False):
        n = k.shape[1] // data
        outs, lses = zip(*(real(q, k[:, i * n:(i + 1) * n].contiguous(),
                                v[:, i * n:(i + 1) * n].contiguous(), q_pos,
                                kv_pos[:, i * n:(i + 1) * n].contiguous(),
                                window=window, return_lse=True)
                           for i in range(data)))
        lse = torch.stack(lses)
        m = lse.max(0).values
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        w = torch.exp(lse - m)[..., None]
        num = (torch.stack(outs).float() * w).sum(0)
        den = w.sum(0)
        return torch.where(den > 0, num / den.clamp_min(1e-30),
                           torch.zeros_like(num)).to(q.dtype)

    return real, split


def tr_collectives_check(cfg, label: str, per, shape) -> dict:
    """Each rank's live collectives in its first paged decode step and
    paged prefill of run ``label`` against the dry run's recording of the
    same config, world rank and shapes on ``meta`` (``trace_serving``
    under a ``RecordingMesh`` of the same ``data x model``): kind, axis,
    group, count and bytes.  Raises when they differ."""
    from repro_torch.launch.dryrun import trace_serving
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.roofline.analysis import collective_bytes

    data, model = shape
    out = {}
    for r, res in enumerate(per):
        for kind, step in (("decode", "serve_decode"),
                           ("prefill", "serve_prefill")):
            live = res["runs"][label]["collectives"][kind]
            shp = live["shape"]
            slots = shp[0] * data if kind == "decode" else shp[0]
            traced = trace_serving(
                cfg, step, RecordingMesh(model, r, data=data), slots=slots,
                kv_len=2048, s_sel=shp[1] if kind == "prefill" else None)[2]
            got = live["calls"]
            stats = collective_bytes(got)
            print(f"  {label} rank {r} {kind} {shp}: {len(got)} collectives "
                  f"({sum(c.axis == 'data' for c in got)} on data), "
                  f"{stats.total_bytes:.0f} wire bytes live; the dry run's "
                  f"{len(traced)}, "
                  f"{collective_bytes(traced).total_bytes:.0f}", flush=True)
            if got != traced:
                raise RuntimeError(f"phase 5r {label} rank {r} {kind}: live "
                                   f"collectives {got}, the dry run's "
                                   f"{traced}")
            out[f"rank {r} {kind}"] = {
                "count": len(got), "wire_bytes": stats.total_bytes,
                "data_bytes": stats.by_axis.get("data", 0.0)}
    return out


def serve_data_axis(*, device=None, cfg=None, hymba_cfg=None,
                    media_len: int = TP_MEDIA_LEN):
    """Phase 5r (see ``TR_SHAPE``).  Returns its runs by label.
    ``device``, ``cfg`` and ``hymba_cfg`` (the whole models') and
    ``media_len`` rehearse it on the CPU."""
    import torch

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import ProductionMesh, backend_for
    from repro_torch.models.transformer import init_params

    cuda = device is None
    dev = torch.device("cuda" if cuda else "cpu")
    cfg = cfg or get_config(TR_ARCH)
    hymba_cfg = hymba_cfg or get_config(HYMBA)
    world = TR_SHAPE[0] * TR_SHAPE[1]
    cards = torch.cuda.device_count() if cuda else 0
    backend = backend_for(dev, world)
    print(f"data_axis: {cfg.name} at {cfg.num_layers} layers on data "
          f"{TR_SHAPE[0]} x model {TR_SHAPE[1]} ({world} ranks, backend "
          f"{backend}, cards {cards}); {hymba_cfg.name} on data "
          f"{TR_SSM_SHAPE[0]} x model {TR_SSM_SHAPE[1]}", flush=True)
    coll_record_s = collective_record_s()
    per = _tr_spawn(TR_SHAPE, cfg, device, media_len)
    key = f"{cfg.name}:data{TR_SHAPE[0]}x{TR_SHAPE[1]}"
    runs, failed = {}, []
    used = min(world, cards) if cuda else 1
    # -- the ranks' own gates ------------------------------------------------
    for label in per[0]["runs"]:
        ranks = [p["runs"][label] for p in per]
        r0 = ranks[0]
        paged = ("sel_attn_paged_q8", "paged_attn_q8") \
            if "int8" in label else ("sel_attn_paged", "paged_attn")
        need = ("sel_attn",) + (paged if label.startswith("mpic")
                                else paged[1:])
        fault = label == TR_ROW_FAULT
        for r, res in enumerate(ranks):
            if (not all(res["done"]) or not res["linked_rag"]
                    or (not fault and res["tokens"] != r0["tokens"])
                    or not np.isfinite(res["firsts"]).all()
                    or (cuda and any(res["launches"][n] == 0
                                     for n in need))
                    or (not label.endswith("fp32") and not fault
                        and res["sel_attn_routes"].get("cuda_cores"))):
                raise RuntimeError(f"phase 5r {label}: rank {r}: "
                                   f"{ {k: v for k, v in res.items() if k not in ('firsts', 'snap', 'costs')} }")
            data_bytes = sum(c.result_bytes for c in res["collectives"].get(
                "decode", {}).get("calls", []) if c.axis == "data")
            print(f"  rank {r} {per[r]['coords']} {label}: slots "
                  f"{res['slots']}, TTFT mean {res['mean_ttft_ms']:.2f} ms "
                  f"(prefill alone {res['mean_prefill_ms']:.2f} ms), decode "
                  f"step {res['mean_decode_step_ms']:.2f} ms over "
                  f"{res['decode_steps']} steps, data gathers "
                  f"{data_bytes} bytes and "
                  f"{res['gather_ms_per_step']:.3f} ms a step, peak "
                  f"{res['peak_gib']:.2f} GiB; launches {res['launches']}",
                  flush=True)
        # every data rank's pool equals its data peer's (same model rank)
        m = TR_SHAPE[1]
        same = [ranks[r]["digest"] == ranks[r + m]["digest"]
                for r in range(world - m)]
        print(f"  {label}: pool digests equal to the data peer's "
              f"{same}", flush=True)
        if fault:
            if all(same):
                failed.append(f"{label}: the planted row fault left every "
                              "data peer's pool equal")
        elif not all(same):
            failed.append(f"{label}: data peers' pools differ {same}")
        runs[f"{key}:{label}"] = {
            "model": key, "world": world, "backend": backend,
            "depth": TP_FP32_DEPTH if label.endswith("fp32") or fault
            else cfg.num_layers,
            "launches": r0["launches"],
            "launches_by_rank": [res["launches"] for res in ranks],
            "pools_equal_to_data_peer": same,
            **{k: [res[k] for res in ranks] for k in (
                "mean_ttft_ms", "mean_prefill_ms", "mean_decode_step_ms",
                "gather_ms_per_step", "upload_s", "peak_gib")}}
        if label in TP_LABELS:
            runs[f"{key}:{label}"]["least"] = [
                row for r, res in enumerate(ranks)
                for row in served_rows(
                    f"{key}:{label} rank {r}", res["costs"],
                    len(res["done"]), res["decode_steps"],
                    res["mean_prefill_ms"], res["mean_decode_step_ms"],
                    n_params=cfg.n_active_params(), scale=world / used,
                    chips=used, note=f"{world} ranks on {used} card(s)",
                    collective_s=coll_record_s)]
        if label.startswith("mpic") and label in TP_LABELS:
            runs[f"{key}:{label}"]["collectives"] = tr_collectives_check(
                cfg, label, per, TR_SHAPE)
    for r, p in enumerate(per):
        print(f"  rank {r} {p['coords']}: {p['device']}, "
              f"{p['weights_gib']:.2f} GiB of weights drawn in "
              f"{p['init_s']:.1f} s", flush=True)
    # the long decode's live collectives against the dry run's
    traced = trace_step(cfg, "decode", InputShape(
        "long_decode", TR_LONG_SEQ, 1, "decode"), ProductionMesh(
        ("data", "model"), TR_SHAPE))[2]
    for r, p in enumerate(per):
        lb = p["long-bf16"]
        if lb["calls"] != traced:
            raise RuntimeError(f"phase 5r long decode rank {r}: live "
                               f"collectives {lb['calls']}, the dry run's "
                               f"{traced}")
        if cuda and lb["routes"].get("split_keys", 0) < cfg.num_layers:
            raise RuntimeError(f"phase 5r long decode rank {r}: kernel 5's "
                               f"split route {lb['routes']}")
    # -- the unsharded engine on the same card, once the ranks are gone ------
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    if cuda:
        torch.cuda.synchronize()
    print(f"  unsharded {cfg.num_layers}-layer model drawn in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    plan = _split_plan(cfg, TR_SHAPE[1], device)
    params.sharding = plan
    floors = {}
    for pool in ("", "int8"):
        eng = _tp_engine(cfg, params, pool, None, device)
        floors[f"mpic-{pool or 'bf16'}"] = tp_traffic(eng, "mpic",
                                                      media_len=media_len)
        eng.close()
    import repro_torch.models.transformer as tf
    real_attn, split_attn = _split_keys_attention(TR_SHAPE[0])
    tf.selective_attention = split_attn
    try:
        long_floor = long_decode_run(cfg, params, device)
    finally:
        tf.selective_attention = real_attn
    params.sharding = None
    long_whole = long_decode_run(cfg, params, device)
    held = [params]
    del params
    whole = _tp_suite(cfg, held, None, device, media_len)
    whole.pop("pool_shape")
    cfg32 = _fp32(cfg)
    p32 = init_params(cfg32, seed=1, device=device)
    long32 = long_decode_run(cfg32, p32, device)
    del p32
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = {}
    for label, floor in floors.items():
        fr, fm = _rel(floor["firsts"], whole[label]["firsts"])
        limits[label] = TP_FLOOR_FACTOR * fr
        print(f"  floor of {label} (row products split in "
              f"{TR_SHAPE[1]}): first-token logits relative RMS {fr:.2e}, "
              f"max {fm:.2e}; the limit {limits[label]:.2e}", flush=True)
    for label in whole:
        limits.setdefault(label, limits["mpic-int8" if "int8" in label
                                        else "mpic-bf16"])
    whole[TR_ROW_FAULT] = whole["mpic-fp32"]
    for label, ref in whole.items():
        for r, p in enumerate(per):
            got = p["runs"][label]
            rel, rel_max = _rel(got["firsts"], ref["firsts"])
            same = got["tokens"] == ref["tokens"]
            exact = label.endswith("fp32")
            if label == TR_ROW_FAULT:
                print(f"  {label} rank {r}: tokens equal to the unsharded "
                      f"engine's {same} (the fault moves the pool, read "
                      "above)", flush=True)
                continue
            if r == 0:
                print(f"  unsharded {label}: TTFT mean "
                      f"{ref['mean_ttft_ms']:.2f} ms, prefill alone "
                      f"{ref['mean_prefill_ms']:.2f} ms, decode step "
                      f"{ref['mean_decode_step_ms']:.2f} ms, peak "
                      f"{ref['peak_gib']:.2f} GiB", flush=True)
            print(f"  rank {r} {label}: tokens equal {same}; first-token "
                  f"logits relative RMS {rel:.2e}, max {rel_max:.2e} "
                  f"(limit {TP_FP32_REL if exact else limits[label]:.2e} "
                  f"on the {'latter' if exact else 'former'})", flush=True)
            ok = (same and rel_max <= TP_FP32_REL) if exact else \
                rel <= limits[label]
            if not ok:
                failed.append(f"{label} rank {r}: tokens {got['tokens']} vs "
                              f"{ref['tokens']}, rel {rel} / {rel_max}")
        runs[f"{key}:{label}"].update(
            unsharded_mean_ttft_ms=ref["mean_ttft_ms"],
            unsharded_mean_prefill_ms=ref["mean_prefill_ms"],
            unsharded_mean_decode_step_ms=ref["mean_decode_step_ms"],
            unsharded_peak_gib=ref["peak_gib"])
    # -- the long decode -----------------------------------------------------
    lf_rel = _rel(long_floor["logits"], long_whole["logits"])[0]
    long_limit = TP_FLOOR_FACTOR * lf_rel
    print(f"  long decode: a ring of {cfg.sliding_window} slots, "
          f"{per[0]['long-bf16']['slots'][2]} a data rank, "
          f"{TR_LONG_STEPS} steps past the wrap; unsharded step "
          f"{long_whole['step_ms']:.2f} ms (peak {long_whole['peak_gib']:.2f}"
          f" GiB); its floor (row products split in {TR_SHAPE[1]}, keys in "
          f"{TR_SHAPE[0]} merged by log-sum-exp): relative RMS {lf_rel:.2e},"
          f" the limit {long_limit:.2e}", flush=True)
    long_rows = []
    for r, p in enumerate(per):
        lb, l32, lf = p["long-bf16"], p["long-fp32"], p["long-fp32-fault"]
        rel_b = _rel(lb["logits"], long_whole["logits"])[0]
        rel_32 = _rel(l32["logits"], long32["logits"])[1]
        rel_f = _rel(lf["logits"], long32["logits"][:1])[1]
        print(f"  rank {r} long decode: step {lb['step_ms']:.2f} ms, bf16 "
              f"relative RMS {rel_b:.2e} (limit {long_limit:.2e}), fp32 at "
              f"{TP_FP32_DEPTH} layers max {rel_32:.2e} (limit "
              f"{TP_FP32_REL}), with the log-sum-exp fault on data rank 1 "
              f"{rel_f:.2e}; kernel 5 by route {lb['routes']}; "
              f"{len(lb['calls'])} collectives "
              f"({sum(c.axis == 'data' for c in lb['calls'])} on data), "
              f"peak {lb['peak_gib']:.2f} GiB", flush=True)
        if rel_b > long_limit or rel_32 > TP_FP32_REL:
            failed.append(f"long decode rank {r}: bf16 {rel_b} (limit "
                          f"{long_limit}), fp32 {rel_32}")
        data_rank = per[r]["coords"][1]
        if data_rank == 1 and rel_f <= TP_FP32_REL:
            failed.append(f"long decode rank {r}: the planted log-sum-exp "
                          f"fault reads {rel_f}, not above {TP_FP32_REL}")
        long_rows.append({"step_ms": lb["step_ms"], "rel_bf16": rel_b,
                          "rel_fp32": rel_32, "rel_fault": rel_f})
    runs[f"{key}:long_decode"] = {
        "model": key, "world": world, "backend": backend,
        "depth": cfg.num_layers, "launches": per[0]["long-bf16"]["launches"],
        "ranks": long_rows, "unsharded_step_ms": long_whole["step_ms"],
        "floor_rel": lf_rel, "limit": long_limit}
    # -- hymba on data 2 x model 1 ------------------------------------------
    hper = _tr_spawn(TR_SSM_SHAPE, hymba_cfg, device, media_len)
    hparams = init_params(hymba_cfg, seed=0, device=device)
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, MPICEngine
    href = {}
    # the unsharded engine, and beside it the same with the ranks' plan on
    # model 1 (every product through the plan's fp32-result matmul, as the
    # ranks run them): the ranks' own arithmetic in one process
    for name, plan in (("whole", None),
                       ("plan", _split_plan(hymba_cfg, 1, device))):
        hparams.sharding = plan
        eng = MPICEngine(build_model(hymba_cfg), hparams, EngineConfig(
            max_seq_len=2048, decode_slots=4), device=device)
        href[name] = tq_ssm_traffic(eng, TP_MEDIA_LEN)
        eng.close()
    hparams.sharding = None
    del eng, hparams
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    hkey = f"{hymba_cfg.name}:data{TR_SSM_SHAPE[0]}x{TR_SSM_SHAPE[1]}"
    floor = _rel(href["plan"]["firsts"], href["whole"]["firsts"])[0]
    for r, res in enumerate(hper):
        rel = _rel(res["firsts"], href["whole"]["firsts"])[0]
        rel_plan = _rel(res["firsts"], href["plan"]["firsts"])[1]
        print(f"  {hkey} rank {r}: slots {res['slots']} ({res['cache_rows']}"
              f" rows of the dense cache), TTFT {res['mean_ttft_ms']:.2f} ms,"
              f" prefill alone {res['mean_prefill_ms']:.2f} ms, decode step "
              f"{res['mean_decode_step_ms']:.2f} ms (unsharded "
              f"{href['whole']['mean_decode_step_ms']:.2f}), peak "
              f"{res['peak_gib']:.2f} GiB; first-token logits relative RMS "
              f"{rel:.2e} from the unsharded engine's (its floor, the ranks' "
              f"products in one process, {floor:.2e}; limit "
              f"{TP_FLOOR_FACTOR} x the floor), max {rel_plan:.2e} from the "
              f"floor run's (limit {TP_FP32_REL}); bf16 tokens equal to "
              f"the floor run's {res['tokens'] == href['plan']['tokens']} "
              f"(printed: a rank decodes 2 slots where it decodes 4, and "
              f"bf16 rounds those products another way); launches "
              f"{res['launches']}", flush=True)
        if (not all(res["done"]) or res["tokens"] != hper[0]["tokens"]
                or not np.isfinite(res["firsts"]).all()
                or res["cache_rows"] != 2 or rel_plan > TP_FP32_REL
                or rel > TP_FLOOR_FACTOR * floor
                or (cuda and (res["launches"]["sel_attn"] == 0
                              or res["launches"]["ssd_chunk"] == 0))):
            failed.append(f"{hkey} rank {r}: tokens {res['tokens']}, rel "
                          f"{rel_max}, launches {res['launches']}")
    runs[hkey] = {"model": hkey, "world": 2,
                  "launches": hper[0]["launches"],
                  "launches_by_rank": [res["launches"] for res in hper],
                  **{k: [res[k] for res in hper] for k in (
                      "mean_ttft_ms", "mean_prefill_ms",
                      "mean_decode_step_ms", "peak_gib")},
                  "unsharded_mean_decode_step_ms":
                      href["whole"]["mean_decode_step_ms"],
                  "floor_rel": floor}
    if failed:
        raise RuntimeError("phase 5r: " + "; ".join(failed))
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import repro_torch.kernels.paged_attn.ops as paged_ops
    import repro_torch.kernels.selective_attn.ops as sel_ops
    import repro_torch.kernels.ssd_chunk.ops as ssd_ops
    import repro_torch.models.layers as layers
    import repro_torch.models.moe as moe_mod
    import repro_torch.models.ssm as ssm_mod
    import repro_torch.models.transformer as tf
    from repro_torch.cache import (
        TIER_DISK,
        FaultPlan,
        KVLibrary,
        KVPeerServer,
        PeerTransport,
        TransferPlan,
        content_key,
        plan_transfers,
    )
    from repro_torch.cache.backends import TIER_BW
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import Prompt, text_segment
    from repro_torch.core.policies import full_recompute
    from repro_torch.core.linker import bucket, precompute_media_kv
    from repro_torch.core.select import mpic_selection, selection_indices
    from repro_torch.data import (
        SYSTEM_PROMPT,
        ByteTokenizer,
        image_embeds,
        make_dialogues,
    )
    from repro_torch.device import resolve_device
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.check import compare, ssd_limit, v_absmax
    from repro_torch.kernels.paged_attn.ops import paged_attention
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    from repro_torch.kernels.selective_attn.ops import (
        selective_attention,
        selective_attention_paged,
    )
    from repro_torch.kernels.selective_attn.ref import (
        INVALID_POS,
        selective_attention_paged_ref,
        selective_attention_ref,
    )
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import (
        Row,
        dense_attention_kernel_cost,
        kernel_bound,
        paged_decode_kernel_cost,
        paged_prefill_kernel_cost,
        ssd_chunk_kernel_cost,
        step_cost,
        valid_keys_decode,
    )
    from repro_torch.serving import EngineConfig, MPICEngine, Request, State

    # fp32 products in full fp32 on the card (the CPU reference has no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)

    # -- 1. the card ------------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  {name}: {line.strip()}")
    print(f"built {sorted(secs)} in {secs}")
    phase("build", t0)

    # -- 3/4/5. serve full-width llava-1.6-7b ---------------------------------
    cfg = get_config("llava-1.6-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    llava_bytes = nbytes
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{nbytes / 2**30:.2f} GiB of seeded weights")
    phase("init", t0)

    @contextlib.contextmanager
    def capture_dense(cases, eng):
        """Keep a copy of the inputs of the first dense-attention call of
        each kind (``"prefill"``: one sequence against a full slot;
        ``"decode"``: every slot, one query, once all slots are busy;
        ``"upload"``: a contiguous media prefill), i.e. layer 0 of the first
        such pass, under the names ``cases`` gives."""
        real = tf.selective_attention
        max_seq_len, slots = eng.cfg.max_seq_len, eng.cfg.decode_slots

        def kind(q, k):
            if q.shape[0] == 1 and k.shape[1] == max_seq_len and q.shape[1] > 1:
                return "prefill"
            # an idle slot sees only the one key it writes: wait for a step
            # in which every slot serves a request
            if q.shape[1] == 1 and q.shape[0] == slots and all(
                    r is not None and r.state is State.RUNNING
                    for r in eng.running):
                return "decode"
            if q.shape[0] == 1 and q.shape[1] == k.shape[1]:
                return "upload"
            return None

        def recording(q, k, v, q_pos, kv_pos, *, window=0):
            name = cases.get(kind(q, k))
            if name is not None and name not in captured:
                captured[name] = tuple(t.clone() for t in
                                       (q, k, v, q_pos, kv_pos)) + (window,)
            return real(q, k, v, q_pos, kv_pos, window=window)

        tf.selective_attention = recording
        try:
            yield
        finally:
            tf.selective_attention = real

    @contextlib.contextmanager
    def hide_previous_chunk(mdl):
        """The chunked gate's planted fault: while a chunked prefill runs
        a chunk, the slots that the chunk before it wrote read invalid, so
        it attends as if that chunk had written no K/V; they are restored
        after it, so the cache the engine splices is whole."""
        previous = {}       # id of a dense cache's pos -> (pos, its rows)

        def blind(real, cache_at):
            def call(*args, **kwargs):
                cache, write_idx = cache_at(args, kwargs)
                if write_idx is None:           # a plain prefill from 0
                    return real(*args, **kwargs)
                pos = cache["pos"]
                pos_rows = previous.get(id(pos), (None, None))[1]
                if pos_rows is not None:
                    saved = pos[0, pos_rows].clone()
                    pos[0, pos_rows] = INVALID_POS
                out = real(*args, **kwargs)
                if pos_rows is not None:
                    pos[0, pos_rows] = saved
                previous[id(pos)] = (pos, write_idx[0].long())
                return out
            return call

        # the model is a frozen dataclass: patch its class for the run
        # (args[0] is the model)
        cls = type(mdl)
        real = cls.prefill, cls.selective_prefill
        cls.prefill = blind(real[0], lambda a, kw: (
            a[3], kw.get("write_idx")))
        cls.selective_prefill = blind(real[1], lambda a, kw: (a[4], a[5]))
        try:
            yield
        finally:
            cls.prefill, cls.selective_prefill = real

    captured = {}
    first_logits = {}       # label -> (requests, V) first-token logits
    sys_toks = ByteTokenizer().encode(SYSTEM_PROMPT, bos=True)

    def serve(label, policy="mpic", kwargs=None, pool_dtype="", paged=True,
              snap_paged=False, cases=None, served=None, engine_kw=None,
              seeds=None, max_seq_len=2048, ahead=()):
        """Phase 3's traffic under one policy and cache; ``served`` is the
        (model, params) pair (llava's by default), ``engine_kw`` more
        ``EngineConfig`` fields, ``seeds`` the requests' sampling seeds,
        ``ahead`` prompts submitted before the dialogues."""
        mdl, prm = served or (model, params)
        scfg = mdl.cfg
        eng = MPICEngine(mdl, prm, EngineConfig(
            max_seq_len=max_seq_len, decode_slots=4, page_size=16,
            pool_dtype=pool_dtype, paged=paged, **(engine_kw or {})))
        # a model without paged decode lands on the dense cache
        paged = eng._paged
        # set-up: the system prompt's KV in the prefix store, built as the
        # JAX package's benchmarks build it
        n_sys = len(sys_toks)
        sc = mdl.make_cache(1, n_sys + 1)
        _, sc = mdl.prefill(prm, torch.as_tensor(
            sys_toks[None], dtype=torch.int32, device=dev), sc)
        eng.prefix_store.put(sys_toks, sc["k"][:, 0, :n_sys].clone(),
                             sc["v"][:, 0, :n_sys].clone())
        del sc
        samples = make_dialogues(n=4, n_images=2, d_model=scfg.d_model,
                                 media_len=MEDIA_LEN, style="mmdu")
        rag = image_embeds("rag-0", MEDIA_LEN, scfg.d_model)

        nonfinite = []
        firsts = {}
        finalize = eng._finalize_prefill
        step_name = "_decode_paged_step" if paged else "_decode_dense_step"
        decode_step = getattr(eng, step_name)

        def checked_finalize(req, result, *rest):
            if not np.isfinite(result.first_logits).all():
                nonfinite.append(f"first logits of {req.req_id}")
            firsts[req.req_id] = result.first_logits
            return finalize(req, result, *rest)

        def checked_decode(live):
            out = decode_step(live)
            live, logits = out if paged else (live, out)
            if logits is not None and not np.isfinite(
                    logits[[r.slot for r in live]]).all():
                nonfinite.append("decode logits")
            return out

        eng._finalize_prefill = checked_finalize
        setattr(eng, step_name, checked_decode)
        snap = None
        with no_plain_versions(), capture_dense(cases or {}, eng):
            _build.reset_launches(KERNELS.values())     # the main path only
            t_up = time.perf_counter()
            for s in samples:
                for _, seg in s.prompt.media_segments():
                    eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
            eng.upload("*", "rag-0", rag, dynamic=True)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t_up
            # the requests arrive once their images are stored: TTFT counts
            # queueing and prefill, not the uploads
            reqs = [Request(prompt=p, max_new_tokens=MAX_NEW,
                            policy=policy, policy_kwargs=dict(kwargs or {}))
                    for p in [*ahead, *(s.prompt for s in samples)]]
            reqs[-1].retrieval_query = rag.mean(0)
            for r, seed in zip(reqs, seeds or ()):
                r.seed = seed
            passes = []
            t_serve = time.perf_counter()
            with recording_passes(passes, idle_pos=max_seq_len - 1):
                for r in reqs:
                    eng.submit(r)
                steps = 0
                while eng.queue or any(eng.running):
                    eng.step()
                    steps += 1
                    if steps > 10 * MAX_NEW * len(reqs):
                        raise RuntimeError("engine made no progress")
                    if snap_paged and snap is None and all(
                            r is not None and r.state is State.RUNNING
                            for r in eng.running):
                        snap = snapshot(eng)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t_serve
            launches = {k: v.launches for k, v in KERNELS.items()}
            routes = dict(sel_ops.SEL_ATTN.route_launches)
            ssd_routes = dict(ssd_ops.SSD_CHUNK.route_launches)

        if nonfinite:
            raise RuntimeError(f"{label}: non-finite logits: {nonfinite}")
        for r in reqs:
            if not r.done or len(r.output_tokens) != MAX_NEW:
                raise RuntimeError(f"{label}: {r.req_id} did not finish: "
                                   f"{r.state} {r.error}")
        # the served models are bf16 at head dim 128 or 64: every dense
        # pass takes one of the two bf16 routes, never the CUDA cores
        if routes.get(sel_ops.CUDA_CORES):
            raise RuntimeError(f"{label}: sel_attn took the CUDA cores: "
                               f"{routes}")
        if "rag-0" not in reqs[-1].linked_media:
            raise RuntimeError(f"{label}: MRAG did not link its image")
        if snap_paged and snap is None:
            raise RuntimeError(f"{label}: never saw all slots running")
        rep = eng.report()
        tokens = rep["total_tokens"]
        n_rec = [r.prefill_stats["n_recomputed"] for r in reqs]
        chunks = [r.prefill_stats.get("chunks", 1) for r in reqs]
        print(f"  prompts {[r.prompt.total_len for r in reqs]} tokens, "
              f"recomputed {n_rec} (mean {np.mean(n_rec):.1f}), "
              f"linked {reqs[-1].linked_media}"
              + (f", chunks {chunks}" if max(chunks) > 1 else ""))
        print(f"  uploads {upload_s:.3f} s for 9 images; served {len(reqs)} "
              f"requests in {serve_s:.3f} s ({steps} steps)"
              + ("" if paged else ", dense cache"))
        print(f"  TTFT mean {rep['mean_ttft_s'] * 1e3:.2f} ms (p90 "
              f"{rep['p90_ttft_s'] * 1e3:.2f} ms, prefill alone "
              f"{rep['mean_prefill_s'] * 1e3:.2f} ms); decode step mean "
              f"{rep['mean_decode_step_s'] * 1e3:.2f} ms over "
              f"{rep['decode_steps']} steps; {tokens / serve_s:.1f} tokens/s")
        prefills = [(r.t_first_token - r.t_admitted) * 1e3 for r in reqs]
        print(f"  prefill alone per request, in submission order: "
              f"{[round(t, 2) for t in prefills]} ms")
        print(f"  launches {launches}; sel_attn by route {routes}"
              + (f"; ssd_chunk by route {ssd_routes}" if ssd_routes else ""),
              flush=True)
        costs = pass_costs(passes)
        least = served_rows(
            label if ":" in label else f"{scfg.name}:{label}", costs,
            len(reqs), rep["decode_steps"], rep["mean_prefill_s"] * 1e3,
            rep["mean_decode_step_s"] * 1e3,
            n_params=scfg.n_active_params())
        if scfg.arch_type == "moe":
            # the decode step's floors: every expert's weights read (the
            # capacity layout's bmm reads them all) and the routed ones
            for key, cs in (("all", pass_costs(passes, all_experts=True)),
                            ("routed", costs)):
                dec = [c["cost"] for c in cs if c["kind"] == "decode"]
                moe_floors[label, key] = _total(dec).scaled(
                    1 / len(dec)).least_s * 1e3
        del passes
        runs[label] = {
            "policy": policy, "pool": pool_dtype or "bf16", "paged": paged,
            "least": least, "prefill_ms": prefills,
            "mean_ttft_ms": rep["mean_ttft_s"] * 1e3,
            "p90_ttft_ms": rep["p90_ttft_s"] * 1e3,
            "mean_prefill_ms": rep["mean_prefill_s"] * 1e3,
            "mean_decode_step_ms": rep["mean_decode_step_s"] * 1e3,
            "mean_recomputed": float(np.mean(n_rec)), "chunks": chunks,
            # whether each prefill went through ChunkedPrefillTask
            "chunked_prefill": ["chunks" in r.prefill_stats for r in reqs],
            "upload_s": upload_s, "launches": launches,
            "decode_steps": rep["decode_steps"],
            "prompt_tokens": [r.prompt.total_len for r in reqs],
            "policies": [r.prefill_stats["policy"] for r in reqs],
            "sel_attn_routes": routes, "ssd_chunk_routes": ssd_routes}
        first_logits[label] = np.stack([firsts[r.req_id] for r in reqs])
        # the wrapped methods make a cycle through the engine and its pool
        eng.close()
        del eng, finalize, decode_step, checked_finalize, checked_decode
        gc.collect()
        torch.cuda.empty_cache()
        return reqs, launches, snap

    runs = {}
    runs_cli = {}           # phase 5g: the CLI's runs, in subprocesses
    moe_floors = {}         # phase 5i: (run, "all"/"routed") -> ms
    t0 = time.perf_counter()
    print("serve, bf16 pool, mpic:")
    reqs16, launches16, snap16 = serve(
        "mpic", kwargs={"k": K_MPIC}, snap_paged=True,
        cases={"upload": "upload"})
    phase("serve_bf16", t0)
    t0 = time.perf_counter()
    print("serve, int8 pool, mpic:")
    reqs8, launches8, snap8 = serve(
        "mpic_int8", kwargs={"k": K_MPIC}, pool_dtype="int8", snap_paged=True)
    agree = sum(a.output_tokens[0] == b.output_tokens[0]
                for a, b in zip(reqs16, reqs8))
    print(f"  first tokens equal to the bf16 pool's: {agree}/{len(reqs8)} "
          "(information only)")
    phase("serve_int8", t0)
    for name, launches in (("sel_attn_paged", launches16),
                           ("paged_attn", launches16),
                           ("sel_attn", launches16),
                           ("sel_attn_paged_q8", launches8),
                           ("paged_attn_q8", launches8),
                           ("sel_attn", launches8)):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} never launched on the main path")

    t0 = time.perf_counter()
    for label, policy, kwargs, pool_dtype, paged in POLICY_RUNS:
        print(f"serve, {'dense cache' if not paged else pool_dtype or 'bf16'}"
              f"{' pool' if paged else ''}, {policy} {kwargs}:")
        cases = {}
        if label == "full_recompute":
            cases = {"prefill": "full_recompute"}
        elif label == "mpic_dense":
            cases = {"prefill": "dense_mpic", "decode": "dense_decode"}
        serve(label, policy, kwargs, pool_dtype, paged, cases=cases)
        if runs[label]["launches"]["sel_attn"] <= 0:
            raise RuntimeError(f"{label}: sel_attn never launched")
    phase("serve_policies", t0)
    missing = {"upload", "full_recompute", "dense_mpic",
               "dense_decode"} - set(captured)
    if missing:
        raise RuntimeError(f"dense attention inputs never seen: {missing}")

    # -- 5b. serve full-width mamba2-130m on the dense fallback cache -------
    t0 = time.perf_counter()
    mcfg = get_config("mamba2-130m")
    mmodel = build_model(mcfg)
    mparams = mmodel.init(seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in mparams.parameters())
    print(f"{mcfg.name}: {mcfg.num_layers} layers, d_model {mcfg.d_model}, "
          f"{mcfg.ssm_num_heads} SSM heads of {mcfg.ssm_head_dim}, state "
          f"{mcfg.ssm_state}, chunk {mcfg.ssm_chunk}, "
          f"{nbytes / 2**30:.2f} GiB of seeded weights")
    ssd_live = {}

    @contextlib.contextmanager
    def capture_ssd(into):
        """Keep in ``into`` a copy of the inputs of the first SSD chunk
        call at each chunk count (layer 0 of the first prefill of that
        length), strides and all: mamba2's dialogues' 21 chunks and its
        text request's 6; hymba's uploads' 9, dialogues' 21 and long
        request's."""
        real = ssm_mod.ssd_chunk

        def recording(*args):
            nc = args[0].shape[1]
            if nc not in into:
                into[nc] = tuple(t.clone() for t in args)
            return real(*args)

        ssm_mod.ssd_chunk = recording
        try:
            yield
        finally:
            ssm_mod.ssd_chunk = real

    def serve_ssm(label, policy, kwargs):
        eng = MPICEngine(mmodel, mparams, EngineConfig(
            max_seq_len=2048, decode_slots=4, paged=True))
        if eng.pool is not None or set(eng._batch_cache) != {"ssm_h",
                                                             "ssm_conv"}:
            raise RuntimeError(f"{label}: the SSM did not land on the "
                               "dense cache")
        samples = make_dialogues(n=4, n_images=2, d_model=mcfg.d_model,
                                 media_len=MEDIA_LEN, style="mmdu")
        prompts = [s.prompt for s in samples] + [Prompt([text_segment(
            np.random.default_rng(5).integers(8, 200, 333))],
            user_id="u0")]
        nonfinite = []
        finalize, decode_step = eng._finalize_prefill, eng._decode_dense_step

        def checked_finalize(req, result, *rest):
            if not np.isfinite(result.first_logits).all():
                nonfinite.append(f"first logits of {req.req_id}")
            return finalize(req, result, *rest)

        def checked_decode(live):
            logits = decode_step(live)
            if not np.isfinite(logits[[r.slot for r in live]]).all():
                nonfinite.append("decode logits")
            return logits

        eng._finalize_prefill = checked_finalize
        eng._decode_dense_step = checked_decode
        with no_plain_versions(), capture_ssd(ssd_live):
            _build.reset_launches(KERNELS.values())     # the main path only
            reqs = [Request(prompt=p, max_new_tokens=MAX_NEW, policy=policy,
                            policy_kwargs=dict(kwargs)) for p in prompts]
            passes = []
            t_serve = time.perf_counter()
            with recording_passes(passes, idle_pos=eng.cfg.max_seq_len - 1):
                for r in reqs:
                    eng.submit(r)
                steps = 0
                while eng.queue or any(eng.running):
                    eng.step()
                    steps += 1
                    if steps > 10 * MAX_NEW * len(reqs):
                        raise RuntimeError("engine made no progress")
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t_serve
            launches = {k: v.launches for k, v in KERNELS.items()}
            routes = dict(ssd_ops.SSD_CHUNK.route_launches)
        if nonfinite:
            raise RuntimeError(f"{label}: non-finite logits: {nonfinite}")
        for r in reqs:
            if not r.done or len(r.output_tokens) != MAX_NEW:
                raise RuntimeError(f"{label}: {r.req_id} did not finish: "
                                   f"{r.state} {r.error}")
            if r.prefill_stats["policy"] != "full_recompute":
                raise RuntimeError(f"{label}: {r.req_id} ran "
                                   f"{r.prefill_stats['policy']}")
        want = mcfg.num_layers * len(reqs)
        if launches["ssd_chunk"] != want or any(
                n for k, n in launches.items() if k != "ssd_chunk"):
            raise RuntimeError(f"{label}: launches {launches}, want "
                               f"ssd_chunk {want} and nothing else")
        # mamba2-130m's chunks (Q 64, hd 64, ds 128) are the tensor cores'
        if routes != {ssd_ops.TENSOR_CORES: want}:
            raise RuntimeError(f"{label}: ssd_chunk routes {routes}, want "
                               f"all {want} on the tensor cores")
        rep = eng.report()
        lens = [r.prompt.total_len for r in reqs]
        chunks = [-(-n // mcfg.ssm_chunk) for n in lens]
        print(f"  prompts {lens} tokens ({chunks} chunks of "
              f"{mcfg.ssm_chunk}), policies "
              f"{sorted({r.prefill_stats['policy'] for r in reqs})}")
        print(f"  served {len(reqs)} requests in {serve_s:.3f} s ({steps} "
              f"steps)")
        print(f"  TTFT mean {rep['mean_ttft_s'] * 1e3:.2f} ms (p90 "
              f"{rep['p90_ttft_s'] * 1e3:.2f} ms, prefill alone "
              f"{rep['mean_prefill_s'] * 1e3:.2f} ms); decode step mean "
              f"{rep['mean_decode_step_s'] * 1e3:.2f} ms over "
              f"{rep['decode_steps']} steps; "
              f"{rep['total_tokens'] / serve_s:.1f} tokens/s")
        print(f"  launches {launches}; ssd_chunk by route {routes}",
              flush=True)
        least = served_rows(
            f"{mcfg.name}:{label}", pass_costs(passes), len(reqs),
            rep["decode_steps"], rep["mean_prefill_s"] * 1e3,
            rep["mean_decode_step_s"] * 1e3,
            n_params=mcfg.n_active_params())
        runs[label] = {
            "model": mcfg.name, "policy": policy, "pool": None,
            "paged": False, "least": least,
            "mean_ttft_ms": rep["mean_ttft_s"] * 1e3,
            "p90_ttft_ms": rep["p90_ttft_s"] * 1e3,
            "mean_prefill_ms": rep["mean_prefill_s"] * 1e3,
            "mean_decode_step_ms": rep["mean_decode_step_s"] * 1e3,
            "mean_recomputed": float(np.mean(
                [r.prefill_stats["n_recomputed"] for r in reqs])),
            "launches": launches, "ssd_chunk_routes": routes}
        eng.close()
        del eng, finalize, decode_step, checked_finalize, checked_decode
        gc.collect()

    for label, policy, kwargs in (("ssm_full_recompute", "full_recompute", {}),
                                  ("ssm_mpic", "mpic", {"k": K_MPIC})):
        print(f"serve {mcfg.name}, paged=True (dense fallback), {policy} "
              f"{kwargs}:")
        serve_ssm(label, policy, kwargs)

    def device_kernels(prof):
        """(name, device ms, launches) of every device activity the
        profile saw, largest first, and their summed time (device busy)."""
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda k: -k[1])
        return kernels, sum(ms for _, ms, _ in kernels)

    def device_ms(fn, iters, floor_ms=None):
        """Device time of one call: every device activity of ``iters``
        back-to-back calls under torch.profiler, summed, over ``iters``.
        A profile is a reading only when it saw device activity and, given
        ``floor_ms`` (the call's bound), no less time than that: the
        profiler sometimes records no device activity for a whole profile,
        or only part of it.  None (not measured) when three tries gave no
        reading."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            _, busy = device_kernels(prof)
            if busy > 0 and (floor_ms is None or busy / iters >= floor_ms):
                return busy / iters
        return None

    def events_ms(fn, iters: int) -> float:
        """Time of one call: CUDA events around ``iters`` back-to-back
        calls after three warm ones."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    # where a mamba2 prefill's time goes: device busy time of one profiled
    # prefill against the median host time of three unprofiled ones
    prompt = make_dialogues(n=1, n_images=2, d_model=mcfg.d_model,
                            media_len=MEDIA_LEN, style="mmdu")[0].prompt

    def ssm_prefill():
        full_recompute(mmodel, mparams, prompt, kv_len=2048)
        torch.cuda.synchronize()

    with no_plain_versions():
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            ssm_prefill()
            walls.append((time.perf_counter() - t) * 1e3)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ssm_prefill()
    kernels_ms, busy = device_kernels(prof)
    wall = float(np.median(walls))
    ssd_in_prefill = [(ms, n) for name, ms, n in kernels_ms
                      if "ssd_chunk" in name]
    ssd_prefill_ms = sum(ms for ms, _ in ssd_in_prefill)
    print(f"  one prefill of {prompt.total_len} tokens: {wall:.2f} ms on the "
          f"host clock (median of {[round(w, 2) for w in walls]}), device "
          + (f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %) under the "
             f"profiler, ssd_chunk {ssd_prefill_ms:.3f} ms of it in "
             f"{sum(n for _, n in ssd_in_prefill)} launches" if busy > 0
             else "time not measured (the profiler saw no device "
             "activity)"))
    for name, ms, n in kernels_ms[:8]:
        print(f"    {ms:8.3f} ms  {n:5d}x  {name[:90]}")
    runs["ssm_full_recompute"]["least"].append(least_row(
        f"{mcfg.name} one prefill of {prompt.total_len} tokens", wall,
        step_cost(mcfg, [Row(np.arange(prompt.total_len),
                             prompt.total_len)]),
        2.0 * mcfg.n_active_params() * prompt.total_len))
    runs["ssm_full_recompute"]["profiled_prefill"] = {
        "tokens": prompt.total_len, "wall_ms": wall,
        "device_busy_ms": busy if busy > 0 else None,
        "ssd_chunk_device_ms": ssd_prefill_ms if busy > 0 else None,
        "top_kernels": [[name[:90], ms, n] for name, ms, n in kernels_ms[:8]]}
    del prof
    torch.cuda.empty_cache()
    phase("serve_ssm", t0)

    # where a paged decode step's time goes, on each pool: the four
    # dialogues of phase 3 under mpic again, on a fresh engine, stepped
    # until all four slots decode; three steps on the host clock (median),
    # then one under torch.profiler.  It runs after every serving run, as
    # the mamba2 profile does, so that no run's numbers carry the
    # profiler's start-up.
    t0 = time.perf_counter()

    def profile_decode(pool_dtype):
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=2048, decode_slots=4, page_size=16,
            pool_dtype=pool_dtype))
        samples = make_dialogues(n=4, n_images=2, d_model=cfg.d_model,
                                 media_len=cfg.media_token_len, style="mmdu")
        reqs = [Request(prompt=s.prompt, max_new_tokens=4 * MAX_NEW,
                        policy="mpic", policy_kwargs={"k": K_MPIC})
                for s in samples]
        walls = []
        with no_plain_versions():
            for s in samples:
                for _, seg in s.prompt.media_segments():
                    eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
            for r in reqs:
                eng.submit(r)
            for _ in range(len(reqs)):          # one admission a step
                eng.step()
            if not all(r.state is State.RUNNING for r in reqs):
                raise RuntimeError("decode profile: not every slot decodes: "
                                   f"{[(r.state, r.error) for r in reqs]}")
            lengths = [r.cur_len for r in reqs]
            for _ in range(3):
                t = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                eng.step()
                torch.cuda.synchronize()
            eng.run()
        eng.close()
        if not all(r.done for r in reqs):
            raise RuntimeError(f"decode profile: {[r.error for r in reqs]}")
        kernels_ms, busy = device_kernels(prof)
        wall = float(np.median(walls))
        # one paged_attention call is its split kernel and its merge kernel
        # (split_kv.cuh's; the paged step runs no other)
        calls = max((n for name, _, n in kernels_ms
                     if "paged_decode_split" in name), default=0)
        per_call = (sum(ms for name, ms, _ in kernels_ms
                        if "paged_decode_split" in name
                        or "split_merge_kernel" in name) / calls
                    if calls else None)
        print(f"  {pool_dtype or 'bf16'} pool, one decode step, 4 slots at "
              f"{lengths} tokens: {wall:.2f} ms on the host clock (median "
              f"of {[round(w, 2) for w in walls]}), device "
              + (f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %) under the "
                 f"profiler; paged_attention {per_call:.4f} ms a call on "
                 f"the device ({calls} calls)" if busy > 0 and calls else
                 "time not measured (the profiler saw no device activity)"))
        for name, ms, n in kernels_ms[:8]:
            print(f"    {ms:8.3f} ms  {n:5d}x  {name[:90]}")
        del eng, prof
        gc.collect()
        torch.cuda.empty_cache()
        return {"lengths": lengths, "wall_ms": wall, "walls_ms": walls,
                "device_busy_ms": busy if busy > 0 else None,
                "paged_attn_device_ms": per_call,
                "top_kernels": [[name[:90], ms, n]
                                for name, ms, n in kernels_ms[:8]]}

    decode_profiles = {"paged_attn": profile_decode(""),
                       "paged_attn_q8": profile_decode("int8")}
    phase("decode_profile", t0)

    # -- 5c. media KV on local disk, loaded in parallel with recompute -----
    # phase 3's traffic once more, with the static and dynamic libraries
    # spooling every block to a temporary directory right after its upload,
    # so that each request's media comes back from disk through the loader
    t0 = time.perf_counter()
    # a miss's cost in Eq. 1: recomputing one image's KV (its upload pass)
    recompute_s = step_cost(cfg, [Row(np.arange(MEDIA_LEN), MEDIA_LEN,
                                      logits=False)]).least_s
    spool_root = tempfile.mkdtemp(prefix="mpic_smoke_spool_")
    print(f"spool directory {spool_root}: "
          f"{shutil.disk_usage(spool_root).free / 2**30:.1f} GiB free")

    def serve_tiered(label, static, dynamic, pool_dtype, pipelined=True, *,
                     upload_static=True, spool=False, rehydrated=False):
        """Phase 3's traffic (mpic k=32) through an engine over ``static``
        and ``dynamic``.  ``upload_static`` uploads the dialogues' images
        (else they come from a rehydrated spool or from a peer), ``spool``
        spools every block right after its upload, ``rehydrated`` says
        the dynamic library's block came from a spool too.  Every request
        must finish with finite first logits and the MRAG image linked.
        Returns what the run measured."""
        eng = MPICEngine(model, params, EngineConfig(
            max_seq_len=2048, decode_slots=4, page_size=16,
            pool_dtype=pool_dtype, pipelined=pipelined),
            static_library=static, dynamic_library=dynamic)
        samples = make_dialogues(n=4, n_images=2, d_model=cfg.d_model,
                                 media_len=cfg.media_token_len, style="mmdu")
        rag = image_embeds("rag-0", cfg.media_token_len, cfg.d_model)
        firsts, decode_windows = {}, []
        finalize, decode_step = eng._finalize_prefill, eng._decode_paged_step

        def recording_finalize(req, result, *rest):
            firsts[req.req_id] = result.first_logits
            return finalize(req, result, *rest)

        def timed_decode(live):
            t = time.perf_counter()
            out = decode_step(live)
            decode_windows.append((t, time.perf_counter()))
            return out

        eng._finalize_prefill = recording_finalize
        eng._decode_paged_step = timed_decode
        with no_plain_versions():
            _build.reset_launches(KERNELS.values())     # the main path only
            t_up = time.perf_counter()
            for s in samples:
                for _, seg in s.prompt.media_segments():
                    if not upload_static:
                        continue
                    eng.upload(s.prompt.user_id, seg.media_id, seg.embeds)
                    if spool and not static.spool_now(s.prompt.user_id,
                                                      seg.media_id):
                        raise RuntimeError(f"{label}: {seg.media_id} did "
                                           "not spool")
            if rehydrated:
                # the retriever's index is not part of the spool
                eng.retriever.add("rag-0", rag)
            else:
                eng.upload("*", "rag-0", rag, dynamic=True)
                if spool and not dynamic.spool_now("*", "rag-0"):
                    raise RuntimeError(f"{label}: rag-0 did not spool")
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t_up
            reqs = [Request(prompt=s.prompt, max_new_tokens=MAX_NEW,
                            policy="mpic", policy_kwargs={"k": K_MPIC})
                    for s in samples]
            reqs[-1].retrieval_query = rag.mean(0)
            # Eq. 1 for each request from where its images lie now: a hit
            # loads at its tier's rate, a miss recomputes the image (its
            # upload pass's least time)
            plans = [plan_transfers(
                static, s.prompt.user_id,
                [seg.media_id for _, seg in s.prompt.media_segments()],
                lambda m: recompute_s) for s in samples]
            t_serve = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            steps = 0
            while eng.queue or any(eng.running):
                eng.step()
                steps += 1
                if steps > 10 * MAX_NEW * len(reqs):
                    raise RuntimeError("engine made no progress")
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t_serve
            launches = {k: v.launches for k, v in KERNELS.items()}
            loads = [iv for h in eng.scheduler._recent_handles
                     for iv in h.intervals()]
        eng.close()
        for r in reqs:
            if not r.done or len(r.output_tokens) != MAX_NEW:
                raise RuntimeError(f"{label}: {r.req_id} did not finish: "
                                   f"{r.state} {r.error}")
            if not np.isfinite(firsts[r.req_id]).all():
                raise RuntimeError(f"{label}: non-finite first logits")
        if "rag-0" not in reqs[-1].linked_media:
            raise RuntimeError(f"{label}: MRAG did not link its image")
        out = {"reqs": reqs, "tokens": [r.output_tokens for r in reqs],
               "first": np.stack([firsts[r.req_id] for r in reqs]),
               "recomputed": [r.prefill_stats["n_recomputed"] for r in reqs],
               # per request, the media it recomputed for want of a block
               "misses": [r.prefill_stats["misses"] for r in reqs],
               "placed": sum(len(r.prompt.media_segments()) for r in reqs),
               "launches": launches, "loads": loads,
               "decode_windows": decode_windows, "upload_s": upload_s,
               "serve_s": serve_s, "steps": steps, "report": eng.report(),
               "load_failures": eng.loader.load_failures, "plans": plans}
        del eng, finalize, decode_step, recording_finalize, timed_decode
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def report_tiered(label, out, tier, st, **extra):
        """Print a tiered run's loads, TTFT and decode steps and the lower
        tier's bytes, fetch seconds and SHA-1 share, and record the run."""
        reqs, rep = out["reqs"], out["report"]
        busy = [any(a < d and c < b for c, d in out["loads"])
                for a, b in out["decode_windows"]]
        steps_ms = np.asarray([(b - a) * 1e3
                               for a, b in out["decode_windows"]])
        in_flight = steps_ms[np.asarray(busy, bool)]
        per_req = {key: [round(getattr(r, key) * 1e3, 2) for r in reqs]
                   for key in ("load_s", "load_blocked_s", "compute_s",
                               "overlap_s")}
        t = st["tiers"].get(tier)           # None: a library without peers
        verify_share = (t["verify_s"] / t["fetch_s"] if t and t["fetch_s"]
                        else None)
        verb = "read" if tier == "disk" else "pulled"
        print(f"  {label}: uploads {out['upload_s'] * 1e3:.1f} ms; served "
              f"in {out['serve_s']:.3f} s ({out['steps']} steps)")
        print(f"    per request, ms: TTFT "
              f"{[round(r.ttft * 1e3, 2) for r in reqs]}, load busy "
              f"{per_req['load_s']}, blocked {per_req['load_blocked_s']}, "
              f"compute {per_req['compute_s']}, overlap "
              f"{per_req['overlap_s']}")
        print(f"    TTFT mean {rep['mean_ttft_s'] * 1e3:.2f} ms (p90 "
              f"{rep['p90_ttft_s'] * 1e3:.2f}), prefill alone "
              f"{rep['mean_prefill_s'] * 1e3:.2f} ms; decode step mean "
              f"{steps_ms.mean():.2f} ms over {len(steps_ms)} steps, "
              + (f"{in_flight.mean():.2f} ms over the {len(in_flight)} with "
                 "a load in flight" if len(in_flight) else
                 "none with a load in flight"))
        print(f"    {tier}: " + (
            f"{t['bytes_read'] / 2**20:.1f} MiB {verb} in {t['fetches']} "
            f"blocks ({t['fetch_misses']} missed), {t['fetch_s'] * 1e3:.1f} "
            f"ms of fetches, SHA-1 {t['verify_s'] * 1e3:.1f} ms of them "
            f"({'-' if verify_share is None else f'{verify_share:.1%}'}), "
            f"then {t['copy_s'] * 1e3:.1f} ms staging and copying to the "
            "card" if t else "none") + f"; direct links "
              f"{st['direct_links']}, dequants {st['dequants']}; launches "
              f"{out['launches']}", flush=True)
        runs[label] = {
            "policy": "mpic", "paged": True,
            "upload_ms": out["upload_s"] * 1e3,
            "ttft_ms": [r.ttft * 1e3 for r in reqs],
            "mean_ttft_ms": rep["mean_ttft_s"] * 1e3,
            "p90_ttft_ms": rep["p90_ttft_s"] * 1e3,
            "mean_prefill_ms": rep["mean_prefill_s"] * 1e3,
            "mean_decode_step_ms": float(steps_ms.mean()),
            "decode_step_ms_loads_in_flight": (
                float(in_flight.mean()) if len(in_flight) else None),
            "decode_steps_loads_in_flight": int(len(in_flight)),
            "per_request_ms": per_req, "recomputed": out["recomputed"],
            "scheduler": rep["scheduler"], tier: t,
            f"{tier}_verify_share": verify_share,
            "direct_links": st["direct_links"], "dequants": st["dequants"],
            "launches": out["launches"], **extra}

    def serve_disk(label, pool_dtype, quantize, pipelined, on_disk, source):
        def library(name, **kw):
            if source is not None:
                # a cold start: the blocks another run spooled, re-indexed
                return KVLibrary(spool_dir=os.path.join(spool_root, source,
                                                        name),
                                 quantize=quantize, rehydrate=True, **kw)
            where = os.path.join(spool_root, label, name) if on_disk else None
            return KVLibrary(spool_dir=where, quantize=quantize, **kw)

        static, dynamic = library("static"), library("dynamic", shared=True)
        out = serve_tiered(label, static, dynamic, pool_dtype, pipelined,
                           upload_static=source is None, spool=on_disk,
                           rehydrated=source is not None)
        placed = out["placed"]
        if source is not None:
            got = (static.rehydrate_stats, dynamic.rehydrate_stats)
            want = ({"rehydrated": placed, "skipped": 0, "corrupt": 0,
                     "expired": 0},
                    {"rehydrated": 1, "skipped": 0, "corrupt": 0,
                     "expired": 0})
            print(f"    rehydrated from {source}'s spool: static "
                  f"{got[0]}, dynamic {got[1]}")
            if got != want:
                raise RuntimeError(f"{label}: rehydrated {got}, expected "
                                   f"{want}")
        st, dst = static.stats(), dynamic.stats()
        disk = st["tiers"]["disk"]
        if on_disk:
            # every media lookup was a verified disk read, and the bytes on
            # the card hash to the keys they were stored under
            if (disk["hits"], disk["corrupt"], st["misses"]) != (placed, 0, 0):
                raise RuntimeError(f"{label}: disk hits {disk['hits']} of "
                                   f"{placed} placed, corrupt "
                                   f"{disk['corrupt']}, misses {st['misses']}")
            if dst["tiers"]["disk"]["hits"] != 1:
                raise RuntimeError(f"{label}: rag-0 not read from disk")
            for key, e in static._entries.items():
                if content_key(e.payload, key) != e.meta.key:
                    raise RuntimeError(f"{label}: {key} changed on its way "
                                       "back from disk")
        if quantize and (st["direct_links"], st["dequants"],
                         dst["direct_links"]) != (placed, 0, 1):
            raise RuntimeError(f"{label}: direct links {st['direct_links']} "
                               f"of {placed}, dequants {st['dequants']}, "
                               f"MRAG {dst['direct_links']}")
        if out["load_failures"]:
            raise RuntimeError(f"{label}: {out['load_failures']} failed "
                               "loads")
        prefill_name = "sel_attn_paged_q8" if pool_dtype else "sel_attn_paged"
        decode_name = "paged_attn_q8" if pool_dtype else "paged_attn"
        # the dense kernel runs in the uploads, which a cold start skips
        for name in (prefill_name, decode_name) + (
                ("sel_attn",) if source is None else ()):
            if out["launches"][name] <= 0:
                raise RuntimeError(f"{label}: {name} never launched")
        report_tiered(label, out, "disk", st, pool=pool_dtype or "bf16",
                      library=("disk" if on_disk else "memory")
                      + (", int8" if quantize else ""), pipelined=pipelined,
                      rehydrated=static.rehydrate_stats.get("rehydrated"))
        # the paper's Eq. 1 beside what the run measured, from TIER_BW's
        # assumed disk rate and from the rate this run's reads reached
        rate = disk["bytes_read"] / disk["fetch_s"] if disk["fetch_s"] \
            else None
        modelled = {}
        for name, bw in (("TIER_BW", TIER_BW),
                         ("measured", {**TIER_BW, "disk": rate or TIER_BW[
                             "disk"]})):
            plans = [TransferPlan(p.hits, p.misses, sum(
                n / bw[t] for _, t, n in p.hits), p.compute_s)
                for p in out["plans"]]
            modelled[name] = {
                "parallel_ms": [p.parallel_s * 1e3 for p in plans],
                "sequential_ms": [p.sequential_s * 1e3 for p in plans]}
        rep = out["report"]
        print(f"    Eq. 1 per request (hits {[len(p.hits) for p in out['plans']]}"
              f", misses {[len(p.misses) for p in out['plans']]}, a miss "
              f"{recompute_s * 1e3:.3f} ms): parallel "
              f"{[round(x, 3) for x in modelled['TIER_BW']['parallel_ms']]} "
              f"ms / sequential "
              f"{[round(x, 3) for x in modelled['TIER_BW']['sequential_ms']]}"
              f" ms at TIER_BW's {TIER_BW['disk'] / 1e9:.2f} GB/s disk; "
              f"parallel "
              f"{[round(x, 3) for x in modelled['measured']['parallel_ms']]}"
              f" / sequential "
              f"{[round(x, 3) for x in modelled['measured']['sequential_ms']]}"
              f" ms at the measured "
              + (f"{rate / 1e9:.3f} GB/s" if rate else "rate (no disk read)")
              + f"; measured TTFT mean {rep['mean_ttft_s'] * 1e3:.2f} ms "
              f"({'pipelined' if pipelined else 'sequential'})", flush=True)
        runs[label]["transfer_plan"] = {**modelled,
                                        "measured_disk_bytes_per_s": rate}
        del static, dynamic
        return out

    try:
        disk_out = {}
        for (label, pool_dtype, quantize, pipelined, on_disk,
             source) in DISK_RUNS:
            print(f"serve from disk: {label} ({pool_dtype or 'bf16'} pool, "
                  f"{'disk' if on_disk else 'memory'} library"
                  f"{', int8' if quantize else ''}, "
                  f"pipelined={pipelined}"
                  f"{f', rehydrated from {source}' if source else ''}):")
            disk_out[label] = serve_disk(label, pool_dtype, quantize,
                                         pipelined, on_disk, source)
    finally:
        shutil.rmtree(spool_root, ignore_errors=True)
    control_tokens = disk_out["memory_bf16"]["tokens"]
    control_first = disk_out["memory_bf16"]["first"]
    for label in ("disk_bf16", "disk_bf16_sequential",
                  "disk_bf16_rehydrated"):
        tokens, first = disk_out[label]["tokens"], disk_out[label]["first"]
        diff = float(np.abs(first - control_first).max())
        print(f"  {label} against the memory-only control: tokens identical "
              f"{tokens == control_tokens}, first-logit max diff {diff:.2e}")
        # the rehydrated run reads the very bytes the control computed
        limit = 0.0 if label == "disk_bf16_rehydrated" else 1e-3
        if tokens != control_tokens or not diff <= limit:
            raise RuntimeError(f"{label} disagrees with the memory-only run")
    phase("serve_disk", t0)

    # -- 5f. media KV pulled from a peer over the network tier ---------------
    # a serving host uploads phase 3's eight static images into a bf16
    # library and an int8 one, each behind a KVPeerServer on loopback; a
    # receiving host with an empty static library peered with one of them
    # serves phase 3's traffic, so that every static lookup is a pull from
    # the serving host's card, through the wire format, onto this card.
    # Then the receiving host with no peer (every image recomputed), and
    # under a blackholed and a corrupting peer, which must give the no-peer
    # run's tokens
    t0 = time.perf_counter()
    host = MPICEngine(model, params, EngineConfig(
        max_seq_len=2048, decode_slots=4, page_size=16))
    host8 = KVLibrary(quantize=True)
    with no_plain_versions():
        t_up = time.perf_counter()
        for s in make_dialogues(n=4, n_images=2, d_model=cfg.d_model,
                                media_len=cfg.media_token_len, style="mmdu"):
            for _, seg in s.prompt.media_segments():
                host.upload(s.prompt.user_id, seg.media_id, seg.embeds)
                e = host.static_lib.get(s.prompt.user_id, seg.media_id)
                host8.put(s.prompt.user_id, seg.media_id, e.k, e.v)
        torch.cuda.synchronize()
    servers = {"bf16": KVPeerServer(host.static_lib),
               "int8": KVPeerServer(host8)}
    print(f"serving host: 8 images into a bf16 and an int8 library in "
          f"{time.perf_counter() - t_up:.3f} s, served at "
          f"{servers['bf16'].address} and {servers['int8'].address}")
    net_out = {}
    try:
        for label, pool_dtype, source, spec in NET_RUNS:
            plan = FaultPlan.parse(spec) if spec else None
            peers = ([PeerTransport(servers[source].address,
                                    timeout_s=NET_TIMEOUT_S)]
                     if source else None)
            static = KVLibrary(peers=peers, faults=plan)
            dynamic = KVLibrary(shared=True, quantize=pool_dtype == "int8")
            print(f"serve from a peer: {label} ({pool_dtype or 'bf16'} pool, "
                  + (f"pulling from the {source} host" if source
                     else "no peer") + (f", fault plan {spec!r}" if spec
                                        else "") + "):")
            out = net_out[label] = serve_tiered(label, static, dynamic,
                                                pool_dtype,
                                                upload_static=False)
            st = static.stats()
            net = st["tiers"].get("network")
            placed = out["placed"]
            report_tiered(label, out, "network", st,
                          pool=pool_dtype or "bf16", peer=source,
                          fault_plan=spec or None)
            if net is not None:
                print(f"    network tier: promotes {net['promotes']}, "
                      f"timeouts {net['timeouts']}, retries "
                      f"{net['retries']}, breaker skips "
                      f"{net['breaker_skips']}, breakers {net['breakers']}; "
                      f"misses {st['misses']}"
                      + (f"; fault plan {plan.stats()}" if plan else ""))
            prefill_name = ("sel_attn_paged_q8" if pool_dtype
                            else "sel_attn_paged")
            decode_name = "paged_attn_q8" if pool_dtype else "paged_attn"
            for name in (prefill_name, decode_name, "sel_attn"):
                if out["launches"][name] <= 0:
                    raise RuntimeError(f"{label}: {name} never launched")
            if out["load_failures"]:
                raise RuntimeError(f"{label}: {out['load_failures']} failed "
                                   "loads")
            media = [[seg.media_id for _, seg in r.prompt.media_segments()]
                     for r in out["reqs"]]
            if spec or not source:
                # every lookup missed: a counted miss, the image recomputed
                pulled = 0 if net is None else net["promotes"]
                if (st["misses"], pulled) != (placed, 0) or (
                        net is not None and net["fetch_misses"] != placed) \
                        or out["misses"] != media:
                    raise RuntimeError(f"{label}: misses {st['misses']} of "
                                       f"{placed}, network {net}, "
                                       f"recomputed {out['misses']}")
                # a blackholed peer trips its breaker; a corrupting one
                # answers, so its breaker stays closed
                opened = net and net["breakers"][peers[0].address]["opened"]
                if spec and (opened > 0) != spec.startswith(
                        "peer.request:blackhole") or (
                        opened and not net["breaker_skips"]):
                    raise RuntimeError(f"{label}: breaker opened {opened} "
                                       f"times, skipped "
                                       f"{net['breaker_skips']}")
                continue
            # every static lookup a verified pull; the bytes on the card
            # hash to their keys; no image recomputed, and the int8 blocks
            # linked from their int8 bytes
            if (net["promotes"], net["fetch_misses"], st["misses"],
                    net["breaker_skips"]) != (placed, 0, 0, 0) \
                    or any(out["misses"]):
                raise RuntimeError(f"{label}: network {net}, misses "
                                   f"{st['misses']} of {placed}, recomputed "
                                   f"{out['misses']}")
            for key, e in static._entries.items():
                if content_key(e.payload, key) != e.meta.key:
                    raise RuntimeError(f"{label}: {key} changed on the wire")
            if pool_dtype and (st["direct_links"], st["dequants"]) != (
                    placed, 0):
                raise RuntimeError(f"{label}: direct links "
                                   f"{st['direct_links']} of {placed}, "
                                   f"dequants {st['dequants']}")
            del static, dynamic
        for label, srv in servers.items():
            print(f"  the {label} host served {srv.stats()}")
    finally:
        for srv in servers.values():
            srv.close()
        host.close()
    del host, host8, servers
    gc.collect()
    torch.cuda.empty_cache()
    # the pulls against the same pool served from a local library (phase
    # 5c's memory control and its int8 library); the faulty peers against
    # no peer at all
    for label, control in (("net_bf16", disk_out["memory_bf16"]),
                           ("net_int8", disk_out["disk_int8"]),
                           ("net_blackhole", net_out["net_none"]),
                           ("net_corrupt", net_out["net_none"])):
        out = net_out[label]
        diff = float(np.abs(out["first"] - control["first"]).max())
        same = out["tokens"] == control["tokens"]
        print(f"  {label} against its control: tokens identical {same}, "
              f"first-logit max diff {diff:.2e}, recomputed "
              f"{out['recomputed']} against {control['recomputed']}")
        runs[label].update(tokens_equal_control=same,
                           first_logit_max_diff=diff)
        if not same or not diff <= 1e-3 or (
                out["recomputed"] != control["recomputed"]):
            raise RuntimeError(f"{label} disagrees with its control")
    phase("serve_network", t0)

    # -- 5h. sessions: freeze, thaw and fork of llava's decode state --------
    # phase 3's first dialogue on a pool of 4 slots of 2048 tokens, its
    # images uploaded into a library that spools to a temporary directory:
    # uninterrupted, then frozen at 4 tokens (spooled at once) and thawed
    # (resume parity; on int8 the adopted pages and scale rows byte-equal to
    # the pool at freeze); a full_recompute session frozen in memory and
    # thawed with a 64-token suffix (against a cold full_recompute of the
    # whole history); the first session forked
    # into 3 greedy and 3 sampled children (copy-on-write), thawed by a
    # second engine that pulls the salted block from the first's
    # KVPeerServer (and a wrong salt missing on every peer), and spooled by
    # the idle sweep and thawed from the file
    t0 = time.perf_counter()

    def timed(fn, into, key):
        """``fn`` whose wall seconds (the card synchronized at both ends)
        go to ``into[key]``."""
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into[key] = time.perf_counter() - t
            return out
        return call

    def serve_sessions(pool_dtype, spool):
        label = f"sessions_{pool_dtype or 'bf16'}"
        q8 = pool_dtype == "int8"
        prompt = make_dialogues(n=4, n_images=2, d_model=cfg.d_model,
                                media_len=MEDIA_LEN,
                                style="mmdu")[0].prompt
        lib = KVLibrary(spool_dir=spool)
        out, secs = {}, {}

        def engine(library=lib, **kw):
            return MPICEngine(model, params, EngineConfig(
                max_seq_len=2048, decode_slots=4, page_size=16,
                pool_dtype=pool_dtype, **kw), static_library=library)

        def request(policy="mpic", **kw):
            return Request(prompt=prompt, max_new_tokens=MAX_NEW,
                           policy=policy, policy_kwargs={"k": K_MPIC}
                           if policy == "mpic" else {}, **kw)

        def decode_until(eng, req, n):
            for _ in range(10 * MAX_NEW):
                if len(req.output_tokens) >= n:
                    return
                eng.step()
            raise RuntimeError(f"{label}: {req.req_id} made no progress")

        def disk_written():
            return lib.stats()["tiers"]["disk"]["bytes_written"]

        with no_plain_versions():
            _build.reset_launches(KERNELS.values())
            eng = engine()
            for _, seg in prompt.media_segments():
                eng.upload(prompt.user_id, seg.media_id, seg.embeds)
            base = eng.submit(request())
            eng.run()
            # -- resume parity: frozen at 4 tokens, spooled, thawed
            exported = {}
            export = eng.pool.export_session

            def keeping(page_table, n_tokens):
                snap = export(page_table, n_tokens)
                exported.update(snap)       # the pool's bytes at freeze
                return snap

            eng.pool.export_session = keeping
            freeze, spool_now = eng.sessions.freeze, lib.spool_now
            eng.sessions.freeze = timed(freeze, secs, "freeze_spooled")
            lib.spool_now = timed(spool_now, secs, "spool")
            written = disk_written()
            fz = eng.submit(request(freeze_after=SESSION_FREEZE_AFTER))
            eng.run()
            eng.pool.export_session = export
            eng.sessions.freeze, lib.spool_now = freeze, spool_now
            if fz.state is not State.FROZEN:
                raise RuntimeError(f"{label}: {fz.req_id} is {fz.state}")
            h = eng.sessions.handles[fz.session_id]
            snapshot_mib = (disk_written() - written) / 2**20
            if lib.peek_tier(h.user_id, h.media_id,
                             salt=h.cache_salt) != TIER_DISK:
                raise RuntimeError(f"{label}: the snapshot was not spooled")
            th = timed(eng.thaw, secs, "thaw_from_disk")(h)
            pages = torch.as_tensor(eng._page_tables[th.slot][
                :eng.pool.pages_for(h.n_ctx)], device=dev).long()
            n = h.n_ctx
            pool = eng.pool
            if q8:
                adopted = all(torch.equal(
                    buf[:, pages].flatten(1, 2)[:, :n], exported[name][:, :n])
                    for buf, name in ((pool.k, "qk"), (pool.v, "qv"))) and \
                    torch.equal(pool.k_scale[:, pages], exported["k_scale"]) \
                    and torch.equal(pool.v_scale[:, pages],
                                    exported["v_scale"])
            else:
                adopted = all(torch.equal(
                    buf[:, pages].flatten(1, 2)[:, :n], exported[name])
                    for buf, name in ((pool.k, "k"), (pool.v, "v")))
            eng.run()
            resumed = fz.output_tokens[:-1] + th.output_tokens
            print(f"  resume: frozen after {SESSION_FREEZE_AFTER} tokens "
                  f"(n_ctx {n}), snapshot {snapshot_mib:.1f} MiB; freeze "
                  f"with its spool {secs['freeze_spooled'] * 1e3:.2f} ms "
                  f"(spool {secs['spool'] * 1e3:.2f}), thaw from disk "
                  f"{secs['thaw_from_disk'] * 1e3:.2f} ms; adopted pages "
                  f"{'and scale rows ' if q8 else ''}equal to the pool at "
                  f"freeze: {adopted}; frozen[:-1] + thawed == "
                  f"uninterrupted: {resumed == base.output_tokens}",
                  flush=True)
            if not adopted or resumed != base.output_tokens:
                raise RuntimeError(f"{label}: resume parity failed: "
                                   f"{resumed} against {base.output_tokens}")
            # -- a suffix thaw from memory against a cold recompute: the
            # session's own prefill recomputes every token too (an mpic
            # prefill's KV approximates full attention's by design)
            r2 = eng.submit(request("full_recompute"))
            decode_until(eng, r2, SESSION_FREEZE_AFTER)
            h2 = timed(eng.freeze, secs, "freeze_in_memory")(r2.req_id)
            suffix = [int(t) for t in np.random.default_rng(21).integers(
                8, 200, SESSION_SUFFIX)]
            firsts = []
            prefill = eng._prefiller.prefill

            def suffix_prefill(*args):
                torch.cuda.synchronize()        # the adopt's copies first
                t = time.perf_counter()
                logits = prefill(*args)
                key = "suffix_prefill_again" if firsts else "suffix_prefill"
                secs[key] = time.perf_counter() - t
                firsts.append(logits)
                return logits

            # the same thaw twice: the first call at a new prefill shape
            # may load kernels, the second is the warm cost
            eng._prefiller.prefill = suffix_prefill
            th2 = timed(eng.thaw, secs, "thaw_with_suffix")(
                h2, suffix, max_new_tokens=MAX_NEW)
            eng.run()
            timed(eng.thaw, secs, "thaw_with_suffix_again")(
                h2, suffix, max_new_tokens=MAX_NEW)
            eng._prefiller.prefill = prefill
            eng.run()
            firsts.pop()
            cold = Request(prompt=Prompt(list(prompt.segments) + [
                text_segment(r2.output_tokens + suffix)],
                user_id=prompt.user_id), max_new_tokens=MAX_NEW,
                policy="full_recompute")
            finalize = eng._finalize_prefill

            def record(req, result, *rest):
                firsts.append(np.asarray(result.first_logits, np.float32))
                return finalize(req, result, *rest)

            eng._finalize_prefill = record
            eng.submit(cold)
            eng.run()
            eng._finalize_prefill = finalize
            diff = float(np.abs(firsts[0] - firsts[1]).max())
            rel = float(np.sqrt(np.mean((firsts[0] - firsts[1]) ** 2)
                                / np.mean(firsts[1] ** 2)))
            same = th2.output_tokens == cold.output_tokens
            cold_ms = (cold.t_first_token - cold.t_admitted) * 1e3
            print(f"  suffix thaw ({SESSION_SUFFIX} tokens after n_ctx "
                  f"{h2.n_ctx}) against a cold full_recompute of "
                  f"{cold.prompt.total_len} tokens: first-logit max diff "
                  f"{diff:.3e} (1e-3: {diff <= 1e-3}), relative RMS "
                  f"{rel:.3e} (limit {SESSION_REL_RMS}), greedy tokens "
                  f"equal {same}; the suffix's prefill alone "
                  f"{secs['suffix_prefill'] * 1e3:.2f} ms, again "
                  f"{secs['suffix_prefill_again'] * 1e3:.2f} ms (the whole "
                  f"thaw from memory {secs['thaw_with_suffix'] * 1e3:.2f} "
                  f"ms, again {secs['thaw_with_suffix_again'] * 1e3:.2f}; "
                  f"its freeze {secs['freeze_in_memory'] * 1e3:.2f} ms) "
                  f"against the cold prefill alone {cold_ms:.2f} ms",
                  flush=True)
            first_same = th2.output_tokens[0] == cold.output_tokens[0]
            if not (rel <= SESSION_REL_RMS and first_same):
                raise RuntimeError(f"{label}: suffix thaw differs from the "
                                   f"cold recompute (relative RMS {rel}, "
                                   f"first tokens equal {first_same})")
            # -- fork: copy-on-write children
            pool = eng.pool
            free0, shared0, cow0 = (pool.free_pages, pool.pages_shared,
                                    pool.cow_copies)
            kids = eng.fork(h, 3)
            parent = pool.pages_for(h.n_ctx + 1)
            allocated = free0 - pool.free_pages
            shared = pool.pages_shared - shared0
            eng.step()
            cow = pool.cow_copies - cow0
            eng.run()
            greedy_same = len({tuple(k.output_tokens) for k in kids}) == 1
            sampler = engine(greedy=False, temperature=0.8, top_k=8)
            sampled = sampler.fork(h, 3)
            sampler.run()
            sampler.close()
            diverged = len({tuple(k.output_tokens) for k in sampled}) > 1
            print(f"  fork(handle, 3): {allocated} pages allocated for a "
                  f"parent of {parent}, pages_shared {shared} (want "
                  f"{parent * 3}), cow_copies after the first decode step "
                  f"{cow} (want 2); greedy children identical "
                  f"{greedy_same}; sampled children (seeds {h.seed}..) "
                  f"diverge {diverged}", flush=True)
            if (allocated, shared, cow) != (parent, parent * 3, 2) or \
                    not greedy_same or not diverged:
                raise RuntimeError(f"{label}: fork gates failed")
            eng.close()
            # -- resume anywhere: a second host pulls the salted block
            servers = [KVPeerServer(lib), KVPeerServer(KVLibrary())]
            try:
                remote = KVLibrary(peers=[PeerTransport(
                    srv.address, timeout_s=NET_TIMEOUT_S)
                    for srv in servers])
                other = engine(remote)
                wrong = type(h).from_json({**h.to_json(),
                                           "cache_salt": "0" * 16})
                try:
                    other.thaw(wrong)
                    raise RuntimeError(f"{label}: a wrong salt thawed")
                except LookupError:
                    pass
                statuses = [t.last_status for t in remote.network.transports]
                misses = remote.stats()["misses"]
                th3 = timed(other.thaw, secs, "thaw_pulled")(h)
                other.run()
                other.close()
                pulled = remote.stats()["tiers"]["network"]
            finally:
                for srv in servers:
                    srv.close()
            print(f"  resume anywhere: the wrong salt missed on every peer "
                  f"({statuses}, library misses {misses}); the right one "
                  f"pulled in {secs['thaw_pulled'] * 1e3:.2f} ms (promotes "
                  f"{pulled['promotes']}), tokens equal to the first host's "
                  f"thaw {th3.output_tokens == th.output_tokens}", flush=True)
            if statuses != [404, 404] or misses != 1 or \
                    pulled["promotes"] != 1 or \
                    th3.output_tokens != th.output_tokens:
                raise RuntimeError(f"{label}: resume anywhere failed")
            # -- the idle sweep spools a snapshot; its thaw reads it back
            idle = engine(freeze_idle_s=30.0)
            r4 = idle.submit(request())
            decode_until(idle, r4, SESSION_FREEZE_AFTER)
            h4 = idle.freeze(r4.req_id)
            h4.frozen_at -= 60.0
            reads = lib.stats()["tiers"]["disk"]["fetches"]
            idle.step()
            swept = lib.peek_tier(h4.user_id, h4.media_id,
                                  salt=h4.cache_salt) == TIER_DISK
            th4 = idle.thaw(h4)
            idle.run()
            read_back = lib.stats()["tiers"]["disk"]["fetches"] - reads
            idle.close()
            print(f"  idle sweep: spooled {swept}, thaw read the file back "
                  f"({read_back} disk read), resumed with "
                  f"{th4.output_tokens[:1]} == [{h4.next_token}]", flush=True)
            if not swept or read_back != 1 or \
                    th4.output_tokens[0] != h4.next_token:
                raise RuntimeError(f"{label}: idle sweep failed")
            launches = {k: v.launches for k, v in KERNELS.items()}
        want = (("sel_attn_paged_q8", "paged_attn_q8") if q8
                else ("sel_attn_paged", "paged_attn")) + ("sel_attn",)
        if any(launches[name] <= 0 for name in want):
            raise RuntimeError(f"{label}: launches {launches}")
        print(f"  launches {launches}", flush=True)
        out.update(
            pool=pool_dtype or "bf16", n_ctx=n, snapshot_mib=snapshot_mib,
            **{f"{k}_ms": v * 1e3 for k, v in secs.items()},
            cold_prefill_ms=cold_ms, suffix_first_logit_max_diff=diff,
            suffix_first_logit_rel_rms=rel, suffix_tokens_equal=same,
            pages_allocated=allocated, pages_shared=shared,
            cow_copies=cow, parent_pages=parent,
            sessions=lib.stats()["sessions"], launches=launches)
        runs[label] = out
        del lib, exported
        gc.collect()
        torch.cuda.empty_cache()

    sessions_root = tempfile.mkdtemp(prefix="mpic_smoke_sessions_")
    try:
        for pool_dtype in ("", "int8"):
            print(f"sessions, {pool_dtype or 'bf16'} pool:")
            serve_sessions(pool_dtype, os.path.join(sessions_root,
                                                    pool_dtype or "bf16"))
    finally:
        shutil.rmtree(sessions_root, ignore_errors=True)
    phase("serve_sessions", t0)

    # -- 5j. the cluster: two replicas over llava ------------------------------
    t0 = time.perf_counter()
    print("serve_cluster: two replicas, affinity router, phase 3's traffic "
          "twice:")
    serve_cluster(model, params, {
        "": ([r.output_tokens for r in reqs16], first_logits["mpic"]),
        "int8": ([r.output_tokens for r in reqs8], first_logits["mpic_int8"])},
        no_plain_versions, runs)
    fleet_reference = serve_fleet_reference(model, params, no_plain_versions,
                                            runs)
    phase("serve_cluster", t0)

    # -- 5d. serve the GQA decoders at full width -----------------------------
    # llava's weights go first: each model is freed before the next is built
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5g. the serving CLI, as a user starts it -----------------------------
    # llava's weights are freed: each run builds its own in a subprocess
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    for key, args in (("paged", CLI_ARGS),
                      ("--no-paged", [*CLI_ARGS, "--no-paged"]),
                      ("granite-moe-1b-a400m", MOE_CLI_ARGS),
                      ("--replicas 2", CLUSTER_CLI_ARGS)):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
        baseline = card_memory_mib()
        rc, out, err, wall, card_mib, rss = run_watched(cmd, env, 600)
        print(f"$ {' '.join(cmd[1:])}\n  exit {rc} in {wall:.3f} s; "
              "sampled every half second: the card's memory in use at most "
              f"{card_mib} MiB (nvidia-smi, {baseline} MiB before it "
              "started), its resident memory at most "
              + (f"{rss:.0f} MiB" if rss else "not readable here"))
        if rc != 0:
            raise RuntimeError(f"the CLI exited {rc}: {err[-3000:]}")
        lines = re.findall(r"^  req(\d+): ttft=\s*(\d+) ms\s+reused=\s*(\d+)"
                           r"\s+tokens=(\d+)( replica=\d+)?$", out, re.M)
        for line in out.splitlines():
            if line.startswith(("serving KV blocks", "arch=", "  req",
                                "  mean_ttft_s", "  p90_ttft_s",
                                "  mean_decode_step_s")):
                print(f"  | {line}")
        # requests alternate mpic and full_recompute in submission order
        reused = {int(n) % 2: [] for n, *_ in lines}
        for n, _, r, _, _ in lines:
            reused[int(n) % 2].append(int(r))
        # a cluster's lines carry their replica, the others' none
        replicas = [rep for *_, rep in lines]
        if ("serving KV blocks to peers at 127.0.0.1:" not in out
                or len(lines) != 4 or "FAILED" in out or "DEADLINE" in out
                or any(int(t) != MAX_NEW for *_, t, _ in lines)
                or not min(reused[0]) > 0 or any(reused[1])
                or not all(bool(r) == (args is CLUSTER_CLI_ARGS)
                           for r in replicas)):
            raise RuntimeError(f"the CLI's output is wrong:\n{out}")
        runs_cli[key] = {
            "wall_s": wall, "card_mib_max": card_mib,
            "card_mib_before": baseline, "rss_mib_max": rss,
            "ttft_ms": [int(t) for _, t, _, _, _ in lines],
            "reused": [int(r) for _, _, r, _, _ in lines],
            "replica": [r.split("=")[1] if r else None
                        for *_, r in lines]}
    print(f"cli runs: {json.dumps(runs_cli)}")
    phase("serve_cli", t0)

    # -- 5k. the fleet: two engine host processes ------------------------------
    t0 = time.perf_counter()
    print("serve_fleet: two host processes at full width:")
    serve_fleet(fleet_reference, [r.output_tokens for r in reqs16],
                llava_bytes)
    phase("serve_fleet", t0)

    t0 = time.perf_counter()
    gqa_snaps, gqa_peaks = {}, {}

    def serve_models(model_runs, captures, after=None):
        """Each model of ``model_runs`` in turn: built with seeded weights,
        served under its runs (phase 3's traffic; each run's kernels
        gated), its two pools snapshotted for phase 6, its peak device
        memory printed, ``after(arch, model, params)`` called, then
        freed."""
        for arch, arch_runs in model_runs:
            serve_model(arch, arch_runs, captures, after)

    def serve_model(arch, gqa_runs, captures, after):
        gcfg = get_config(arch)
        gmodel = build_model(gcfg)
        torch.cuda.reset_peak_memory_stats()
        gparams = gmodel.init(seed=0)
        torch.cuda.synchronize()
        nbytes = sum(p.numel() * p.element_size()
                     for p in gparams.parameters())
        print(f"{gcfg.name}: {gcfg.num_layers} layers, d_model "
              f"{gcfg.d_model}, {gcfg.num_heads} query heads on "
              f"{gcfg.num_kv_heads} kv heads (G "
              f"{gcfg.num_heads // gcfg.num_kv_heads}), head dim "
              f"{gcfg.head_dim}, qkv_bias {gcfg.qkv_bias}, "
              + (f"{gcfg.num_experts} experts of {gcfg.d_ff} top-"
                 f"{gcfg.experts_per_token} + {gcfg.num_shared_experts} "
                 "shared, " if gcfg.arch_type == "moe" else "")
              + f"{nbytes / 2**30:.2f} GiB of seeded weights", flush=True)
        uploads = 9 * gcfg.num_layers       # kernel 5 in the uploads alone
        for (label, policy, kwargs, pool_dtype, paged, engine_kw,
             seeds) in gqa_runs:
            snap_paged = label in (f"{arch}:mpic", f"{arch}:mpic_int8")
            print(f"serve {label}, "
                  f"{pool_dtype or 'bf16'} {'pool' if paged else 'dense'}, "
                  f"{policy} {kwargs} {engine_kw or ''}"
                  + (" (planted fault: each chunk blind to the one before)"
                     if label in BLIND_RUNS else "") + ":")
            with (hide_previous_chunk(gmodel) if label in BLIND_RUNS
                  else contextlib.nullcontext()):
                reqs, launches, snap = serve(
                    label, policy, kwargs, pool_dtype, paged,
                    snap_paged=snap_paged, cases=captures.get(label),
                    served=(gmodel, gparams), engine_kw=engine_kw,
                    seeds=seeds)
            runs[label]["model"] = arch
            runs[label]["tokens"] = [r.output_tokens for r in reqs]
            if snap is not None:
                gqa_snaps[arch, pool_dtype or "bf16"] = snap
            q8 = pool_dtype == "int8"
            want = ["sel_attn"]
            if paged:
                want.append("paged_attn_q8" if q8 else "paged_attn")
            if paged and policy == "mpic" and not (engine_kw or {}).get(
                    "prefill_chunk_tokens"):
                want.append("sel_attn_paged_q8" if q8 else "sel_attn_paged")
            for name in want:
                if launches[name] <= 0:
                    raise RuntimeError(f"{label}: {name} never launched")
            chunk = (engine_kw or {}).get("prefill_chunk_tokens")
            if chunk:
                chunks = runs[label]["chunks"]
                if not all(runs[label]["chunked_prefill"]) or (
                        chunks != [1] * len(chunks) if chunk == GQA_ONE_CHUNK
                        else min(chunks) <= 1):
                    raise RuntimeError(f"{label}: chunks {chunks}, through "
                                       "ChunkedPrefillTask "
                                       f"{runs[label]['chunked_prefill']}")
                if launches["sel_attn"] <= uploads:
                    raise RuntimeError(f"{label}: sel_attn launched only in "
                                       "the uploads")
        gqa_peaks[arch] = torch.cuda.max_memory_allocated()
        for label, *_ in gqa_runs:
            runs[label]["model_peak_gib"] = gqa_peaks[arch] / 2**30
        print(f"  {gcfg.name}: peak device memory "
              f"{gqa_peaks[arch] / 2**30:.2f} GiB "
              "(torch.cuda.max_memory_allocated)", flush=True)
        if after is not None:
            after(arch, gmodel, gparams)
        del gparams, gmodel
        gc.collect()
        torch.cuda.empty_cache()

    serve_models(GQA_RUNS, GQA_CAPTURES)
    # qwen's gates: chunked against monolithic first-token logits; seeded
    # sampling reproducible, top-k 1 greedy
    q = "qwen2.5-14b"

    def rel_rms(a, b):
        """Per request: RMS of a - b over the RMS of b."""
        return np.sqrt(np.mean((a - b) ** 2, axis=1)
                       / np.mean(b ** 2, axis=1))

    def compared(a, b):
        fa, fb = first_logits[a], first_logits[b]
        return (float(np.abs(fa - fb).max()), float(rel_rms(fa, fb).max()),
                bool((fa.argmax(1) == fb.argmax(1)).all()))

    for a, b in ((f"{q}:mpic_dense", f"{q}:mpic"),
                 (f"{q}:mpic", f"{q}:full_recompute"),
                 (f"{q}:mpic_int8", f"{q}:mpic")):
        diff, rel, same = compared(a, b)
        print(f"  {a} against {b}: first-logit max diff {diff:.3e}, "
              f"relative RMS {rel:.3e}, first tokens equal {same} "
              "(information)")
    for chunked, mono in ((f"{q}:mpic_chunked", f"{q}:mpic"),
                          (f"{q}:full_recompute_chunked",
                           f"{q}:full_recompute"), *BLIND_RUNS.items()):
        diff, rel, same = compared(chunked, mono)
        per_request = rel_rms(first_logits[chunked], first_logits[mono])
        tokens_same = runs[chunked]["tokens"] == runs[mono]["tokens"]
        runs[chunked].update(first_logit_max_diff=diff,
                             first_logit_rel=per_request.tolist(),
                             limit=CHUNK_REL_RMS,
                             tokens_equal_monolithic=tokens_same)
        print(f"  {chunked} against {mono}: first-logit max diff "
              f"{diff:.3e}, relative RMS per request "
              f"{[f'{x:.3e}' for x in per_request]} (limit "
              f"{CHUNK_REL_RMS}), first tokens equal {same}, all tokens "
              f"equal {tokens_same}")
        if chunked in BLIND_RUNS:
            # the gate must catch the planted fault in every request
            if not per_request.min() > CHUNK_REL_RMS:
                raise RuntimeError(f"the chunked gate cannot tell {chunked} "
                                   f"from {mono}")
        elif not rel <= CHUNK_REL_RMS:
            raise RuntimeError(f"{chunked} disagrees with {mono}")
    # one chunk through ChunkedPrefillTask: the same products as the
    # monolithic dense run, so the same bits
    one, ref = f"{q}:mpic_one_chunk", f"{q}:mpic_dense"
    diff, rel, same = compared(one, ref)
    tokens_same = runs[one]["tokens"] == runs[f"{q}:mpic"]["tokens"]
    runs[one].update(first_logit_max_diff=diff,
                     tokens_equal_monolithic=tokens_same)
    print(f"  {one} against {ref}: first-logit max diff {diff:.3e} (must "
          f"be 0); all tokens equal to {q}:mpic's {tokens_same}")
    if diff != 0.0:
        raise RuntimeError(f"{one} differs from {ref}")
    sampled = [runs[f"{q}:sampled_{x}"]["tokens"] for x in "ab"]
    top1, greedy = runs[f"{q}:top_k1"]["tokens"], runs[f"{q}:mpic"]["tokens"]
    print(f"  {q} sampled twice (temperature 0.8, top_k 8): tokens "
          f"identical {sampled[0] == sampled[1]}; differ from greedy "
          f"{sampled[0] != greedy}; top_k 1 equals greedy {top1 == greedy}")
    if sampled[0] != sampled[1] or top1 != greedy:
        raise RuntimeError("seeded sampling is not reproducible or top_k 1 "
                           "is not greedy")
    missing = {n for c in GQA_CAPTURES.values() for n in c.values()} \
        - set(captured)
    if missing:
        raise RuntimeError(f"dense attention inputs never seen: {missing}")
    phase("serve_gqa", t0)

    # -- 5i. serve the MoE decoders at full width ----------------------------
    # deepseek-moe-16b (MHA at Dh 128; 64 experts top-6 and 2 shared; ~31
    # GiB of seeded bf16 weights) under mpic on both pools and
    # full_recompute, then granite-moe-1b-a400m (G 2 at Dh 64; 32 experts
    # top-8) under mpic on both pools, phase 3's traffic.  After a model's
    # runs, one upload and one full prefill count the (token, choice) pairs
    # that capacity dropped in every layer (an untimed pass: the count
    # reads the card)
    t0 = time.perf_counter()
    moe_drops = {}

    def count_drops(arch, mdl, prm):
        mc = mdl.cfg
        counts = []
        route = moe_mod.route

        def counting(router, rcfg, xt, *args, **kwargs):
            out = route(router, rcfg, xt, *args, **kwargs)
            counts.append((xt.shape[0], out[5], int((~out[4]).sum())))
            return out

        p0 = make_dialogues(n=1, n_images=2, d_model=mc.d_model,
                            media_len=MEDIA_LEN, style="mmdu")[0].prompt
        emb = p0.media_segments()[0][1].embeds
        n = p0.total_len
        moe_mod.route = counting
        try:
            with no_plain_versions():
                precompute_media_kv(mdl, prm, torch.as_tensor(
                    np.asarray(emb, np.float32), device=dev))
                upload, counts[:] = list(counts), []
                mdl.prefill(prm, torch.as_tensor(
                    p0.flat_tokens()[None], device=dev),
                    mdl.make_cache(1, n + 1), media_embeds=torch.as_tensor(
                        p0.flat_media_embeds(mc.d_model)[None], device=dev),
                    media_mask=torch.as_tensor(p0.media_mask()[None],
                                               device=dev))
                prefill = list(counts)
        finally:
            moe_mod.route = route
        moe_drops[arch] = {}
        for name, calls in (("upload", upload), ("full_prefill", prefill)):
            rows, cap = calls[0][0], calls[0][1]
            by_layer = [d for _, _, d in calls]
            moe_drops[arch][name] = {
                "rows": rows, "capacity": cap,
                "mean_load": rows * mc.experts_per_token / mc.num_experts,
                "pairs_per_layer": rows * mc.experts_per_token,
                "dropped_by_layer": by_layer}
            print(f"  {arch} {name}: T {rows}, capacity {cap} against a "
                  f"mean load of "
                  f"{rows * mc.experts_per_token / mc.num_experts:.1f}; "
                  f"pairs dropped {sum(by_layer)} of "
                  f"{rows * mc.experts_per_token * len(calls)} over "
                  f"{len(calls)} layers ({by_layer})", flush=True)
            if len(calls) != mc.num_layers or (
                    (arch, name) in MOE_DROP_GATES and not sum(by_layer)):
                raise RuntimeError(f"{arch} {name}: capacity never bit "
                                   f"({calls})")

    serve_models(MOE_RUNS, MOE_CAPTURES, after=count_drops)
    for arch in MOE_ARCHS:
        # the decode step's least time (roofline.step_cost, the mean over
        # the run's steps) with every expert's weights read, as the
        # capacity layout's batched products read them, and with the
        # experts the live rows routed to alone
        label = f"{arch}:mpic"
        step = runs[label]["mean_decode_step_ms"]
        floor_all = moe_floors[label, "all"]
        floor_routed = moe_floors[label, "routed"]
        print(f"  {arch}: decode step {step:.2f} ms against a least time "
              f"of {floor_all:.2f} ms with every expert's weights read and "
              f"{floor_routed:.2f} ms with the routed experts' alone "
              f"({card})", flush=True)
        for label, *_ in dict(MOE_RUNS)[arch]:
            runs[label].update(all_experts_floor_ms=floor_all,
                               routed_experts_floor_ms=floor_routed,
                               capacity_drops=moe_drops[arch])
    d = "deepseek-moe-16b"
    same = runs[f"{d}:mpic"]["tokens"] == runs[f"{d}:full_recompute"]["tokens"]
    print(f"  {d} mpic against full_recompute: tokens identical {same} "
          "(information)")
    missing = {n for c in MOE_CAPTURES.values() for n in c.values()} \
        - set(captured)
    if missing:
        raise RuntimeError(f"dense attention inputs never seen: {missing}")
    phase("serve_moe", t0)

    # -- 5e. serve full-width hymba-1.5b on the dense cache ------------------
    # the hybrid: attention (G 5, Dh 64, a 2048-token window) and SSD heads
    # (25 of 64, state 16) in every layer; paged=True lands on the dense
    # cache.  Its attention runs kernel 5 in every upload, prefill and
    # decode step, its SSD heads kernel 6 on the CUDA-core route in every
    # upload and prefill.  A ~6,000-token request, submitted first, makes
    # the window mask keys in its prefill and in every decode step.
    t0 = time.perf_counter()
    hcfg = get_config(HYMBA)
    hmodel = build_model(hcfg)
    torch.cuda.reset_peak_memory_stats()
    hparams = hmodel.init(seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in hparams.parameters())
    hw, hl = hcfg.sliding_window, hcfg.num_layers
    print(f"{hcfg.name}: {hl} layers, d_model {hcfg.d_model}, "
          f"{hcfg.num_heads} query heads on {hcfg.num_kv_heads} kv heads (G "
          f"{hcfg.num_heads // hcfg.num_kv_heads}), head dim "
          f"{hcfg.head_dim}, window {hw}; {hcfg.ssm_num_heads} SSM heads "
          f"of {hcfg.ssm_head_dim}, state {hcfg.ssm_state}, chunk "
          f"{hcfg.ssm_chunk}; {nbytes / 2**30:.2f} GiB of seeded weights",
          flush=True)
    long_prompt = Prompt([text_segment(np.random.default_rng(7).integers(
        8, 200, HYMBA_LONG))], user_id="u0")
    hymba_ssd = {}
    for label, policy, kwargs in ((f"{HYMBA}:mpic", "mpic", {"k": K_MPIC}),
                                  (f"{HYMBA}:full_recompute",
                                   "full_recompute", {})):
        print(f"serve {label}, paged=True (dense fallback), {policy} "
              f"{kwargs}, max_seq_len {HYMBA_SEQ}, a {HYMBA_LONG}-token "
              "request first:")
        with capture_ssd(hymba_ssd):
            reqs, launches, _ = serve(
                label, policy, kwargs, served=(hmodel, hparams),
                cases=HYMBA_CAPTURES if policy == "mpic" else None,
                max_seq_len=HYMBA_SEQ, ahead=[long_prompt])
        run = runs[label]
        run["model"] = HYMBA
        run["tokens"] = [r.output_tokens for r in reqs]
        if run["paged"] or set(run["policies"]) != {"full_recompute"}:
            raise RuntimeError(f"{label}: paged {run['paged']}, policies "
                               f"{run['policies']}")
        if not max(run["prompt_tokens"]) > 2 * hw:
            raise RuntimeError(f"{label}: no prompt reaches past two windows")
        # one launch a layer of every upload (9 images) and prefill, and of
        # kernel 5 in every decode step; nothing else
        passes = 9 + len(reqs)
        want = {"sel_attn": hl * (passes + run["decode_steps"]),
                "ssd_chunk": hl * passes}
        got = {k: n for k, n in launches.items() if n or k in want}
        if got != want:
            raise RuntimeError(f"{label}: launches {got}, want {want}")
        if run["ssd_chunk_routes"] != {ssd_ops.CUDA_CORES: want["ssd_chunk"]}:
            raise RuntimeError(f"{label}: ssd_chunk routes "
                               f"{run['ssd_chunk_routes']}, want all on the "
                               "CUDA cores")
    hymba_peak = torch.cuda.max_memory_allocated()
    for label in (f"{HYMBA}:mpic", f"{HYMBA}:full_recompute"):
        runs[label]["model_peak_gib"] = hymba_peak / 2**30
    tokens_same = (runs[f"{HYMBA}:mpic"]["tokens"]
                   == runs[f"{HYMBA}:full_recompute"]["tokens"])
    print(f"  mpic (as full_recompute) against full_recompute: tokens "
          f"identical {tokens_same}; peak device memory "
          f"{hymba_peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)",
          flush=True)
    if not tokens_same:
        raise RuntimeError(f"{HYMBA}: the rewritten mpic run differs from "
                           "full_recompute")
    missing = set(HYMBA_CAPTURES.values()) - set(captured)
    if missing:
        raise RuntimeError(f"dense attention inputs never seen: {missing}")

    # banded_attend at full width: a contiguous prefill of 2w (4w) tokens
    # into exactly 2w (4w) slots takes the banded branch in every layer,
    # into one slot more the windowed dense attention over the cache
    band_toks = torch.randint(
        8, hcfg.vocab_size, (1, 4 * hw), device=dev, dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(0))

    def banded_prefill(n, slots, unbanded=False):
        """Last-token logits of the first ``n`` tokens prefilled into
        ``slots`` slots, the sequence lengths of the banded calls, and layer
        0's inputs to the first one.  ``unbanded`` plants a fault: the
        banded calls attend over every earlier key, the window ignored."""
        calls, first = [], []
        real = tf.banded_attend

        def counting(q, k, v, positions, window):
            if not first:
                first.append((q.clone(), k.clone(), v.clone(),
                              positions.clone(), window))
            calls.append(q.shape[1])
            if unbanded:
                return selective_attention(q, k, v, positions, positions)
            return real(q, k, v, positions, window)

        tf.banded_attend = counting
        try:
            with no_plain_versions():
                logits, cache = hmodel.prefill(
                    hparams, band_toks[:, :n], hmodel.make_cache(1, slots))
                last = logits[0, -1].float().cpu().numpy()
        finally:
            tf.banded_attend = real
        del logits, cache
        return last, calls, first

    banded = {}
    for n in (2 * hw, 4 * hw):
        name = f"banded_{n // hw}w"
        lb, calls_b, first = banded_prefill(n, n)
        lw, calls_w, _ = banded_prefill(n, n + 1)
        lf, _, _ = banded_prefill(n, n, unbanded=True)

        def rel_rms(a):
            return float(np.sqrt(np.mean((a - lw) ** 2) / np.mean(lw ** 2)))

        rel, rel_fault = rel_rms(lb), rel_rms(lf)
        if calls_b != [n] * hl or calls_w:
            raise RuntimeError(f"{name}: banded calls {calls_b} into {n} "
                               f"slots, {calls_w} into {n + 1}")
        if not (np.isfinite(lb).all() and rel <= BANDED_REL_RMS):
            raise RuntimeError(f"{name}: banded against windowed relative "
                               f"RMS {rel}")
        # the gate must catch the planted fault
        if not rel_fault > BANDED_REL_RMS:
            raise RuntimeError(f"{name}: the banded gate cannot tell a band "
                               f"without its window ({rel_fault})")
        q, k, v, pos, win = first[0]

        def band(window):
            return lambda: selective_attention(q, k, v, pos, pos,
                                               window=window)

        banded[name] = {
            "rel_rms": rel, "rel_rms_unbanded_fault": rel_fault,
            "route": sel_ops.dense_route(
                q.dtype, q.shape[3], q.shape[1], q.shape[2], k.shape[2]),
            "ms": events_ms(band(win), 10),
            "device_ms": device_ms(band(win), 10),
            "window0_ms": events_ms(band(0), 10),
            "window0_device_ms": device_ms(band(0), 10),
            "shape": f"q {tuple(q.shape)} bf16, k/v {tuple(k.shape)}, "
                     f"kv_pos = the queries' positions, window {win}"}
        b = banded[name]
        print(f"  {name}: {n} tokens into {n} slots (banded in all {hl} "
              f"layers) against {n + 1} (windowed): last-token logits "
              f"relative RMS {rel:.3e} (limit {BANDED_REL_RMS}; the band "
              f"without its window, a planted fault: {rel_fault:.3e}); "
              f"kernel 5 "
              f"at layer 0 via {b['route']}: {b['ms']:.4f} ms (device "
              f"{b['device_ms']}) with the window, {b['window0_ms']:.4f} ms "
              f"(device {b['window0_device_ms']}) with window 0", flush=True)
        del first, q, k, v, pos
    del hparams, hmodel, band_toks
    gc.collect()
    torch.cuda.empty_cache()
    phase("serve_hymba", t0)

    # -- 5l. whisper-small at full width ---------------------------------------
    t0 = time.perf_counter()
    print(f"serve_whisper: {WHISPER} on the dense cache:")
    whisper_captured = {}
    serve_whisper(no_plain_versions, runs, whisper_captured)
    captured.update({f"{WHISPER}:{k}": v for k, v in whisper_captured.items()})
    del whisper_captured
    phase("serve_whisper", t0)

    # -- 5m. the trainer on the card -------------------------------------------
    t0 = time.perf_counter()
    print("train: the launcher, then train() in this process:")
    trained = train_on_card(lambda: no_plain_versions(training=True), env)
    phase("train", t0)

    # -- 5n. the SSM and the hybrid trained at full width -------------------
    t0 = time.perf_counter()
    trained.update(train_ssm_on_card(
        lambda: no_plain_versions(training=True)))
    phase("train_ssm", t0)

    # -- 5o. internvl2-76b tensor-parallel ------------------------------------
    t0 = time.perf_counter()
    tp_runs, tp_snaps, tp_world = serve_tensor_parallel()
    runs.update(tp_runs)
    tp_key = f"{TP_ARCH}:tp{tp_world}"
    for pool_name, snap in tp_snaps.items():
        gqa_snaps[tp_key, pool_name] = {
            k: v.to(dev) if torch.is_tensor(v) else v
            for k, v in snap.items()}
    phase("serve_tensor_parallel", t0)

    # -- 5q. the MoE, SSM, hybrid and encoder-decoder families ---------------
    t0 = time.perf_counter()
    tq_runs, tq_snaps, tq_captures = serve_tensor_families()
    runs.update(tq_runs)

    def to_dev(v):
        return v.to(dev) if torch.is_tensor(v) else v

    for (key, pool_name), snap in tq_snaps.items():
        gqa_snaps[key, pool_name] = {k: to_dev(v) for k, v in snap.items()}
    # rank 0's shapes for phase 6: deepseek's paged pool (kernels 1-4),
    # whisper's layer-0 attention (kernel 5), mamba2's SSD chunk (kernel 6)
    tq_moe_key = next(key for key, _ in tq_snaps)
    tq_whisper_key, tq_ssd_key = (next(k for k in tq_captures if
                                       k.startswith(arch + ":"))
                                  for arch in (WHISPER, "mamba2-130m"))
    captured.update({f"{tq_whisper_key}:{k}": tuple(to_dev(t) for t in v)
                     for k, v in tq_captures[tq_whisper_key].items()})
    tq_ssd = tuple(to_dev(t) for t in tq_captures[tq_ssd_key]["args"])
    del tq_captures
    phase("serve_tensor_families", t0)

    # -- 5r. the data axis: llava on data 2 x model 2, hymba on 2 x 1 -------
    t0 = time.perf_counter()
    runs.update(serve_data_axis())
    phase("serve_data_axis", t0)

    # -- 6. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, dh = cfg.num_heads, cfg.head_dim

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def gather(pool, scale, pt, ps, dtype):
        """(B, mp*ps, Hkv, Dh) in ``dtype``: the pages of ``pt`` in order."""
        b, mp = pt.shape
        g = pool[pt.long()].reshape(b, mp * ps, *pool.shape[2:]).float()
        if scale is not None:
            g = g * scale[pt.long()].repeat_interleave(ps, dim=1)[..., None]
        return g.to(dtype)

    def decode_case(q, k, v, ks, vs, pt, lens, window):
        out = paged_attention(q, k, v, pt, lens, k_scale=ks, v_scale=vs,
                              window=window)
        ref = paged_attention_ref(q, k, v, pt, lens, ks, vs, window=window)
        return compare(out, ref, v_absmax(v, vs), rows=lens > 0), out

    def prefill_case(q, k, v, ks, vs, pt, q_pos, lens, window):
        out = selective_attention_paged(q, k, v, pt, q_pos, lens,
                                        k_scale=ks, v_scale=vs, window=window)
        ref = selective_attention_paged_ref(
            q.transpose(1, 2), k, v, pt, q_pos, lens, ks, vs,
            window=window).transpose(1, 2)
        return compare(out, ref, v_absmax(v, vs)), out

    def decode_main(snap, hq, dh, window):
        """Kernels 3-4 on a pool snapshot at its live decode shape: the
        check, the bound and the events times; and the kernel's call."""
        k, v, ks, vs, ps = snap["k"], snap["v"], snap["ks"], snap["vs"], \
            snap["ps"]
        pt, lens = snap["decode_pt"], snap["decode_len"]
        b, mp = pt.shape
        q = randn(b, hq, dh, dtype=torch.bfloat16)
        check, _ = decode_case(q, k, v, ks, vs, pt, lens, window)
        kg = gather(k, ks, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        vg = gather(v, vs, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        idx = torch.arange(mp * ps, device=dev)[None]
        mask = idx < lens[:, None]
        if window > 0:
            mask &= idx > lens[:, None] - 1 - window
        q4 = q[:, :, None, :]
        n_keys = valid_keys_decode(lens.cpu().numpy(), ps, mp, window)
        bound_ms, bound_by = kernel_bound(*paged_decode_kernel_cost(
            n_keys, batch=b, hq=hq, hkv=k.shape[2], dh=dh,
            q_item=q.element_size(), kv_item=k.element_size(),
            table_numel=pt.numel(), page_size=ps, quantized=ks is not None),
            q.dtype)

        def kernel():
            return paged_attention(q, k, v, pt, lens, k_scale=ks, v_scale=vs,
                                   window=window)

        return {
            **check, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": events_ms(kernel, 50),
            "plain_ms": events_ms(lambda: paged_attention_ref(
                q, k, v, pt, lens, ks, vs, window=window), 10),
            "library_ms": events_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask[:, None, None, :]), 50),
            "shape": f"q {tuple(q.shape)} bf16, pool layer 0 {k.dtype} "
                     f"({k.shape[2]} kv heads), page table "
                     f"{tuple(pt.shape)}, lengths {lens.tolist()}, window "
                     f"{window}"}, kernel

    def prefill_main(snap, hq, dh, window):
        """Kernels 1-2 on a pool snapshot at its newest request's
        selective prefill: the check, the bound, the events and device
        times beside SDPA's."""
        k, v, ks, vs, ps = snap["k"], snap["v"], snap["ks"], snap["vs"], \
            snap["ps"]
        pt, q_pos, lens = snap["prefill_pt"], snap["q_pos"], \
            snap["prefill_len"]
        n_sel = snap["n_sel"]
        b, sq = q_pos.shape
        mp = pt.shape[1]
        q = randn(b, sq, hq, dh, dtype=torch.bfloat16)
        check, _ = prefill_case(q, k, v, ks, vs, pt, q_pos, lens, window)
        kg = gather(k, ks, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        vg = gather(v, vs, pt, ps, q.dtype).repeat_interleave(
            hq // k.shape[2], dim=2).transpose(1, 2).contiguous()
        idx = torch.arange(mp * ps, device=dev)[None, None, :]
        qp = q_pos[:, :, None]
        mask = (idx < lens[:, None, None]) & (idx <= qp)
        if window > 0:
            mask &= idx > qp - window
        qt = q.transpose(1, 2).contiguous()
        length = int(lens[0])
        bound_ms, bound_by = kernel_bound(*paged_prefill_kernel_cost(
            q_pos[0].cpu().numpy(), length, window, q_numel=q.numel(),
            hq=hq, hkv=k.shape[2], dh=dh, q_item=q.element_size(),
            kv_item=k.element_size(), table_numel=pt.numel(),
            page_size=ps, quantized=ks is not None), q.dtype)

        def kernel():
            return selective_attention_paged(q, k, v, pt, q_pos, lens,
                                             k_scale=ks, v_scale=vs,
                                             window=window)

        def library():
            return F.scaled_dot_product_attention(qt, kg, vg,
                                                  attn_mask=mask[:, None])

        return {
            **check, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": events_ms(kernel, 20),
            "plain_ms": events_ms(lambda: selective_attention_paged_ref(
                qt, k, v, pt, q_pos, lens, ks, vs, window=window), 5),
            "library_ms": events_ms(library, 20),
            "device_ms": device_ms(kernel, 20, bound_ms),
            "library_device_ms": device_ms(library, 20, bound_ms),
            "shape": f"q {tuple(q.shape)} bf16 ({n_sel} selected), "
                     f"pool layer 0 {k.dtype} ({k.shape[2]} kv heads), page "
                     f"table {tuple(pt.shape)}, length {length}, window "
                     f"{window}"}

    results = {}
    window = cfg.sliding_window
    for name, snap in (("paged_attn", snap16), ("paged_attn_q8", snap8)):
        res, _ = decode_main(snap, hq, dh, window)
        results[name] = {
            **res, "device_ms": decode_profiles[name]["paged_attn_device_ms"],
            "profiled_decode_step": decode_profiles[name]}
    for name, snap in (("sel_attn_paged", snap16),
                       ("sel_attn_paged_q8", snap8)):
        results[name] = prefill_main(snap, hq, dh, window)
    # the same at each GQA model's layer 0, from its served runs
    gqa_results, gqa_paged = {}, []
    # (internvl2's rank 0 of phase 5o at its shard's heads)
    # (and deepseek's rank 0 of phase 5q)
    tp_cfg, tq_cfg = get_config(TP_ARCH), get_config(TQ_MOE)
    tq_world = int(tq_moe_key.rpartition(":tp")[2])
    paged_shapes = [(arch, get_config(arch).num_heads, get_config(arch))
                    for arch in (*GQA_ARCHS, *MOE_ARCHS)] + [
        (tp_key, tp_cfg.num_heads // tp_world, tp_cfg),
        (tq_moe_key, tq_cfg.num_heads // tq_world, tq_cfg)]
    for arch, heads, acfg in paged_shapes:
        by_kernel = gqa_results[arch] = {}
        for pool_name, suffix in (("bf16", ""), ("int8", "_q8")):
            args = (gqa_snaps.pop((arch, pool_name)), heads,
                    acfg.head_dim, acfg.sliding_window)
            res, kernel = decode_main(*args)
            by_kernel["paged_attn" + suffix] = {
                **res, "device_ms": device_ms(kernel, 20, res["bound_ms"])}
            by_kernel["sel_attn_paged" + suffix] = prefill_main(*args)
        gqa_paged += [(f"{name} at {arch} G "
                       f"{acfg.num_heads // acfg.num_kv_heads}", r)
                      for name, r in by_kernel.items()]
    for name, r in [*results.items(), *gqa_paged]:
        if not r["worst"] <= 1.0:
            raise RuntimeError(f"{name}: main-path error {r}")
    del snap16, snap8, gqa_snaps
    for name, r in [*results.items(), *gqa_paged]:
        print(f"  {name}: main path max |err| {r['max_abs_err']:.3e}, "
              f"max |ref| {r['max_abs_ref']:.3e}, err/limit "
              f"{r['worst']:.3f}; device {r['device_ms']} ms a call"
              + (f" (SDPA {r['library_device_ms']})"
                 if "library_device_ms" in r else "")
              + f"; bound {r['bound_ms']:.4f} ms; {r['shape']}")

    # synthetic shape: GQA group 4 with a window that bites, a ragged query
    # count, an idle row and scratch-padded page tables; fp32 q (the
    # CUDA-core kernels), then the prefill in bf16 (the tensor-core kernel)
    syn_hq, syn_hkv, syn_win, syn_ps, syn_p = 32, 8, 64, 16, 160
    syn_lens = [0, 300, 1000]
    perm = torch.randperm(syn_p - 1, generator=gen, device=dev) + 1
    syn_pt = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(syn_lens):
        npg = -(-n // syn_ps)
        syn_pt[i, :npg] = perm[used:used + npg]
        used += npg
    lens = torch.tensor(syn_lens, dtype=torch.int32, device=dev)
    shape = (syn_p, syn_ps, syn_hkv, dh)
    pools = {
        False: (randn(*shape, dtype=torch.float32),
                randn(*shape, dtype=torch.float32), None, None),
        True: (torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8),
               torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8),
               torch.rand((syn_p, syn_hkv), generator=gen,
                          device=dev) * 0.02 + 1e-3,
               torch.rand((syn_p, syn_hkv), generator=gen,
                          device=dev) * 0.02 + 1e-3),
    }
    sq = 101
    q_pos = torch.stack([torch.sort(torch.randperm(
        max(n, sq), generator=gen, device=dev)[:sq])[0]
        for n in syn_lens]).to(torch.int32)
    for q8 in (False, True):
        k, v, ks, vs = pools[q8]
        kb, vb = (k, v) if q8 else (k.to(torch.bfloat16), v.to(torch.bfloat16))
        qd = randn(3, syn_hq, dh, dtype=torch.float32)
        qp = randn(3, sq, syn_hq, dh, dtype=torch.float32)
        suffix = "_q8" if q8 else ""
        def syn_prefill(q, k, v, ks, vs, pt, lens, window):
            return prefill_case(q, k, v, ks, vs, pt, q_pos, lens, window)

        for name, case, qs in (
                ("paged_attn" + suffix, decode_case, (qd, qd.bfloat16())),
                ("sel_attn_paged" + suffix, syn_prefill, (qp, qp.bfloat16()))):
            check_f, out_f = case(qs[0], k, v, ks, vs, syn_pt, lens, syn_win)
            check_b, out_b = case(qs[1], kb, vb, ks, vs, syn_pt, lens, syn_win)
            for what, check, out in (("fp32", check_f, out_f),
                                     ("bf16", check_b, out_b)):
                if not torch.all(out[0] == 0):
                    raise RuntimeError(f"{name}: {what} idle row is not zero")
                if not check["worst"] <= 1.0:
                    raise RuntimeError(f"{name}: synthetic {what} GQA error "
                                       f"{check}")
            results[name].update(
                synthetic_err=check_f["max_abs_err"],
                synthetic_bf16_err=check_b["max_abs_err"],
                synthetic_err_over_limit={"fp32": check_f["worst"],
                                          "bf16": check_b["worst"]})
            print(f"  {name} synthetic GQA: err/limit fp32 "
                  f"{check_f['worst']:.3f}, bf16 {check_b['worst']:.3f} (max "
                  f"|err| {check_b['max_abs_err']:.3e})")
    # the bf16 prefill kernel's instantiations, as the card reports them
    # (local memory is what spills, 0 when nothing does)
    for q8 in (False, True):
        for d in (64, 128):
            fn = f"sel_attn_paged_mma_kernel<{d}, {int(q8)}>"
            res = sel_ops.paged_mma_resources(d, q8)
            print(f"  {fn}: {res['registers']} registers, "
                  f"{res['local_bytes']} bytes local memory, "
                  f"{res['static_smem_bytes']} + {res['smem_bytes']} bytes "
                  f"static + dynamic smem, {res['blocks_per_sm']} blocks of "
                  f"{res['threads']} threads per SM")
            if res["local_bytes"] != 0:
                raise RuntimeError(f"{fn} spills: {res}")
            if d == dh:
                results["sel_attn_paged_q8" if q8 else
                        "sel_attn_paged"]["resources"] = {"kernel": fn, **res}
    # every instantiation of the split-key decode kernel: each q dtype and
    # pool, Dh 64 and 128, one query head per block (G 1) and the wide tile
    # (G 2-8)
    for q_dt in (torch.float32, torch.bfloat16):
        for q8 in (False, True):
            for d in (64, 128):
                for group in (1, 8):
                    res = paged_ops.decode_resources(q_dt, q8, d, group)
                    qn = str(q_dt)[6:]
                    fn = (f"paged_decode_split_kernel<q {qn}, "
                          f"{'int8' if q8 else qn} pool, Dh {d}, "
                          f"{res['heads_per_block']} heads a block>")
                    print(f"  {fn}: {res['registers']} registers, "
                          f"{res['local_bytes']} bytes local memory, "
                          f"{res['static_smem_bytes']} bytes static smem, "
                          f"{res['blocks_per_sm']} blocks of "
                          f"{res['threads']} threads per SM")
                    if res["local_bytes"] != 0:
                        raise RuntimeError(f"{fn} spills: {res}")
                    row = results["paged_attn_q8" if q8 else "paged_attn"]
                    row.setdefault("instantiations", []).append(
                        {"kernel": fn, **res})
                    if (q_dt == torch.bfloat16 and d == dh
                            and group == (1 if hq == cfg.num_kv_heads
                                          else 8)):
                        row["resources"] = {"kernel": fn, **res}

    # dense selective attention: the main-path inputs phases 3-5 captured,
    # then synthetic GQA shapes
    def dense_ref(q, k, v, q_pos, kv_pos, window):
        return selective_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos,
            kv_pos, window=window).transpose(1, 2)

    def dense_mask(q_pos, kv_pos, window):
        """(B, Sq, Skv) bool: the (query, key) pairs the function keeps."""
        kp = kv_pos.long()[:, None, :]
        qp = q_pos.long()[:, :, None]
        m = (kp != INVALID_POS) & (kp <= qp)
        if window > 0:
            m &= kp > qp - window
        return m

    def dense_case(q, k, v, q_pos, kv_pos, window, timed=True, lse=False):
        """One dense call held per element to its plain version (with
        ``lse`` also each row's log-sum-exp, to 1e-4 of its size), then
        timed beside the plain version, SDPA and its bound."""
        before = dict(sel_ops.SEL_ATTN.route_launches)
        out = selective_attention(q, k, v, q_pos, kv_pos, window=window,
                                  return_lse=lse)
        route, = [r for r, n in sel_ops.SEL_ATTN.route_launches.items()
                  if n != before.get(r, 0)]
        extra = {}
        if lse:
            out, got = out
            want = selective_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                q_pos, kv_pos, window=window,
                return_lse=True)[1].transpose(1, 2)
            live = ~torch.isinf(want)
            err = float((got - want)[live].abs().max()) if live.any() \
                else 0.0
            limit = 1e-4 * (1 + float(want[live].abs().max()))
            if not torch.equal(torch.isinf(got), ~live) or err > limit:
                raise RuntimeError(f"sel_attn: log-sum-exp off by {err} "
                                   f"(limit {limit})")
            extra = {"lse_max_abs_err": err, "lse_limit": limit}
        res = {**compare(out, dense_ref(q, k, v, q_pos, kv_pos, window),
                         v_absmax(v)), "out": out, "route": route, **extra}
        if not timed:
            return res
        b, sq, hq_, dh_ = q.shape
        skv, hkv_ = k.shape[1], k.shape[2]
        mask = dense_mask(q_pos, kv_pos, window)
        pairs = int(mask.sum())
        keys = int(mask.any(dim=1).sum())      # keys some query keeps
        nbytes, flops = dense_attention_kernel_cost(
            pairs, keys, q_numel=q.numel(),
            pos_numel=q_pos.numel() + kv_pos.numel(), hq=hq_, hkv=hkv_,
            dh=dh_, item=q.element_size())
        # the log-sum-exp: one fp32 value a (query, head) row written
        bound_ms, bound_by = kernel_bound(
            nbytes + (b * sq * hq_ * 4 if lse else 0), flops, q.dtype)
        rep = hq_ // hkv_
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        m4 = mask[:, None]

        def kernel():
            return selective_attention(q, k, v, q_pos, kv_pos, window=window,
                                       return_lse=lse)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)

        res.update(
            bound_ms=bound_ms, bound_by=bound_by,
            ms=events_ms(kernel, 20),
            plain_ms=events_ms(lambda: dense_ref(
                q, k, v, q_pos, kv_pos, window), 5),
            library_ms=events_ms(library, 20),
            device_ms=device_ms(kernel, 20, bound_ms),
            library_device_ms=device_ms(library, 20, bound_ms),
            shape=f"q {tuple(q.shape)} {str(q.dtype)[6:]}, k/v "
                  f"{tuple(k.shape)}, {keys} of {b * skv} key slots kept, "
                  f"{pairs} (query, key) pairs, window {window}")
        return res

    dense = {}
    # llava's four main-path shapes, then each GQA model's upload and
    # qwen2.5-14b's dense mpic prefill and 64-token chunk on the tensor
    # cores, its dense decode step (5 rows a kv head) on the split keys
    gqa_routes = {"upload": sel_ops.TENSOR_CORES,
                  "dense_mpic": sel_ops.TENSOR_CORES,
                  "chunk": sel_ops.TENSOR_CORES,
                  "long_prefill": sel_ops.TENSOR_CORES,
                  "dense_decode": sel_ops.SPLIT_KEYS,
                  # whisper's: the encoder (every query at the last frame's
                  # position), the first prompt's prefill (self and cross
                  # over 1500 frames), a decode step's self and cross
                  "encoder": sel_ops.TENSOR_CORES,
                  "prefill_self": sel_ops.TENSOR_CORES,
                  "prefill_cross": sel_ops.TENSOR_CORES,
                  "decode_self": sel_ops.SPLIT_KEYS,
                  "decode_cross": sel_ops.SPLIT_KEYS}
    gqa_dense = [n for caps in (GQA_CAPTURES, MOE_CAPTURES)
                 for c in caps.values() for n in c.values()] + \
        list(HYMBA_CAPTURES.values()) + \
        [n for n in captured if n.startswith(f"{WHISPER}:")]
    # hymba's layer-0 shapes: kernel 5 at the upload, the long request's
    # prefill and a decode step with it (the window biting in both), the
    # banded calls of phase 5e; kernel 6 below
    gqa_results[HYMBA] = {"sel_attn": dict(banded)}
    gqa_results[WHISPER], gqa_results[tq_whisper_key] = {}, {}
    for name in ("dense_mpic", "full_recompute", "dense_decode", "upload",
                 *gqa_dense):
        res = dense_case(*captured[name])
        res.pop("out")
        if not res["worst"] <= 1.0:
            raise RuntimeError(f"sel_attn: main-path error at {name}: {res}")
        arch, _, case = name.rpartition(":")
        if res["route"] == sel_ops.CUDA_CORES or (
                arch and res["route"] != gqa_routes[case]):
            raise RuntimeError(f"sel_attn: {name} took {res['route']}")
        dense[name] = res
        if arch:
            gqa_results[arch].setdefault("sel_attn", {})[case] = res
    del captured
    syn = {}
    # (name, dtype, Sq, Skv): GQA 32/8 with a window of 64, positions in a
    # random order, ~10% of the slots empty; query 0 of sequence 0 at
    # position 2 sees no key at all.  Sq 101 runs the tensor cores (bf16),
    # Sq 1 the split keys; fp32 the CUDA cores
    for name, dtype, sq, skv in (("bf16", torch.bfloat16, 101, 300),
                                 ("bf16_decode", torch.bfloat16, 1, 2048),
                                 ("fp32", torch.float32, 101, 300)):
        b = 2
        q = randn(b, sq, syn_hq, dh, dtype=dtype)
        k = randn(b, skv, syn_hkv, dh, dtype=dtype)
        v = randn(b, skv, syn_hkv, dh, dtype=dtype)
        kv_pos = torch.stack([torch.randperm(skv, generator=gen, device=dev)
                              + 5 for _ in range(b)]).to(torch.int32)
        kv_pos[torch.rand((b, skv), generator=gen, device=dev) < 0.1] = \
            INVALID_POS
        q_pos = torch.stack([torch.randperm(skv + 10, generator=gen,
                                            device=dev)[:sq]
                             for _ in range(b)]).to(torch.int32)
        q_pos[0, 0] = 2
        res = dense_case(q, k, v, q_pos, kv_pos, syn_win,
                         timed=name == "bf16")
        if not torch.all(res.pop("out")[0, 0] == 0):
            raise RuntimeError("sel_attn: fully masked row is not zero")
        if not res["worst"] <= 1.0:
            raise RuntimeError(f"sel_attn: synthetic error ({name}): {res}")
        if dtype == torch.bfloat16 and res["route"] == sel_ops.CUDA_CORES:
            raise RuntimeError(f"sel_attn: synthetic {name} took the CUDA "
                               "cores")
        syn[name] = res
    # the long decode's rank slice (phase 5r): one query of llava's heads
    # on model 2 (16 on 16) over a data rank's 4,096 slots of the window's
    # ring (positions TR_LONG_PAST past the wrap), through the split keys
    # with each row's log-sum-exp
    w = cfg.sliding_window
    at = w + TR_LONG_PAST
    ring = torch.arange(at - w, at, device=dev, dtype=torch.int32)
    kv_pos = torch.empty(w, dtype=torch.int32, device=dev)
    kv_pos[ring % w] = ring
    n, h = w // TR_SHAPE[0], cfg.num_heads // TR_SHAPE[1]
    res = dense_case(randn(1, 1, h, dh, dtype=torch.bfloat16),
                     randn(1, n, h, dh, dtype=torch.bfloat16),
                     randn(1, n, h, dh, dtype=torch.bfloat16),
                     torch.full((1, 1), at, dtype=torch.int32, device=dev),
                     kv_pos[None, :n].contiguous(), w, lse=True)
    res.pop("out")
    if not res["worst"] <= 1.0 or res["route"] != sel_ops.SPLIT_KEYS:
        raise RuntimeError(f"sel_attn: the long decode's slice: {res}")
    dense["long_decode_lse"] = res
    head = dense["dense_mpic"]
    results["sel_attn"] = {
        **{key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "shape",
                                      "device_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in dense.values()),
        "max_abs_ref": max(r["max_abs_ref"] for r in dense.values()),
        "worst": max(r["worst"] for r in [*dense.values(), *syn.values()]),
        "synthetic_err": max(r["max_abs_err"] for r in syn.values()),
        "device_ms_by_shape": {n: r["device_ms"] for n, r in dense.items()},
        "library_device_ms_by_shape": {n: r["library_device_ms"]
                                       for n, r in dense.items()},
        "route_by_shape": {n: r["route"] for n, r in dense.items()},
        "cases": {**dense, **{f"synthetic_{n}": r for n, r in syn.items()}}}
    for name, r in results["sel_attn"]["cases"].items():
        timing = (f"; {r['ms']:.4f} ms (device {r['device_ms']}, plain "
                  f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, device "
                  f"{r['library_device_ms']}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']})" if "ms" in r else "")
        print(f"  sel_attn {name} via {r['route']}: max |err| "
              f"{r['max_abs_err']:.3e}, err/limit {r['worst']:.3f}{timing}; "
              f"{r.get('shape', '')}")
    # the dense bf16 instantiations, as the card reports them (local memory
    # is what spills, 0 when nothing does): the tensor-core kernel with
    # 128- and 64-row blocks at the main path's 2048 slots, the split-key
    # kernel at one row and at the wide tile
    dense_instances = ([(sel_ops.TENSOR_CORES, d, 2048, rows)
                        for d in (64, 128) for rows in (128, 64)]
                       + [(sel_ops.SPLIT_KEYS, d, rows, 0) for d in (64, 128)
                          for rows in (1, 16)])
    for route, d, arg, block_rows in dense_instances:
        if route == sel_ops.TENSOR_CORES:
            res = sel_ops.dense_resources(route, d, arg, block_rows)
            fn = f"sel_attn_mma_kernel<{d}, {block_rows} rows> (Skv {arg})"
        else:
            res = sel_ops.dense_resources(route, d, arg)
            fn = f"sel_attn_split_kernel<{d}, {res['rows_per_block']}>"
        print(f"  {fn}: {res['registers']} registers, "
              f"{res['local_bytes']} bytes local memory, "
              f"{res['static_smem_bytes']} + {res['smem_bytes']} bytes "
              f"static + dynamic smem, {res['blocks_per_sm']} blocks of "
              f"{res['threads']} threads per SM")
        if res["local_bytes"] != 0:
            raise RuntimeError(f"{fn} spills: {res}")
        results["sel_attn"].setdefault("instantiations", []).append(
            {"kernel": fn, **res})
        if d == dh and arg in (2048, 1):
            results["sel_attn"].setdefault("resources", {})[fn] = res

    # SSD chunk: the layer-0 inputs captured from live mamba2 prefills (the
    # dialogues' 21 chunks, the text request's 6), then synthetic shapes
    def ssd_case(args, timed=False):
        before = dict(ssd_ops.SSD_CHUNK.route_launches)
        out = ssd_chunk(*args)
        route, = [r for r, n in ssd_ops.SSD_CHUNK.route_launches.items()
                  if n != before.get(r, 0)]
        checks = [compare(o, r, limit=ssd_limit)
                  for o, r in zip(out, ssd_chunk_ref(*args))]
        res = {"max_abs_err": max(c["max_abs_err"] for c in checks),
               "max_abs_ref": max(c["max_abs_ref"] for c in checks),
               "worst": max(c["worst"] for c in checks), "route": route}
        if not all(bool(torch.isfinite(o).all()) for o in out):
            res["worst"] = float("inf")
        if not timed:
            return res
        x, bm = args[0], args[1]
        b, nc, h, q, hd = x.shape
        ds = bm.shape[-1]
        nbytes, flops = ssd_chunk_kernel_cost(
            b=b, nc=nc, h=h, q=q, hd=hd, ds=ds,
            in_numel=sum(t.numel() for t in args),
            out_numel=sum(t.numel() for t in out))
        bound_ms, bound_by = kernel_bound(nbytes, flops, torch.float32)

        def kernel():
            return ssd_chunk(*args)

        def cuda_cores():   # the first port's kernel
            return ssd_ops.launch_route(ssd_ops.CUDA_CORES, *args)

        res.update(
            bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
            heads_per_block=ssd_ops.plan_head_groups(
                b, nc, h, torch.cuda.get_device_properties(
                    dev).multi_processor_count)
            if route == ssd_ops.TENSOR_CORES else 1,
            ms=events_ms(kernel, 50),
            plain_ms=events_ms(lambda: ssd_chunk_ref(*args), 10),
            library_ms=None,
            device_ms=device_ms(kernel, 20, bound_ms),
            cuda_cores_ms=events_ms(cuda_cores, 50),
            cuda_cores_device_ms=device_ms(cuda_cores, 20, bound_ms),
            shape=f"x {tuple(x.shape)} (B, NC, H, Q, hd) read through the "
                  f"model's layout, bm/cm {tuple(bm.shape)}, fp32")
        return res

    live_nc, text_nc = max(ssd_live), min(ssd_live)
    ssd = {"live": ssd_case(ssd_live[live_nc], timed=True),
           "text": ssd_case(ssd_live[text_nc], timed=True)}
    del ssd_live
    # hymba's SSD heads (25 of 64, state 16) on the CUDA-core route: the
    # captured layer-0 inputs of a dialogue's prefill and the long one's
    hymba_ssd_cases = {}
    for name, n in (("dialogue", runs[f"{HYMBA}:mpic"]["prompt_tokens"][1]),
                    ("long", HYMBA_LONG)):
        nc = -(-n // hcfg.ssm_chunk)
        res = hymba_ssd_cases[name] = ssd_case(hymba_ssd[nc], timed=True)
        if res["route"] != ssd_ops.CUDA_CORES or not res["worst"] <= 1.0:
            raise RuntimeError(f"ssd_chunk: hymba's {name} shape: {res}")
        print(f"  ssd_chunk at {HYMBA}'s {name} ({nc} chunks) via "
              f"{res['route']}: max |err| {res['max_abs_err']:.3e}, "
              f"err/limit {res['worst']:.3f}; {res['ms']:.4f} ms (device "
              f"{res['device_ms']}; plain {res['plain_ms']:.4f}, bound "
              f"{res['bound_ms']:.4f} by {res['bound_by']}); {res['shape']}")
    gqa_results[HYMBA]["ssd_chunk"] = hymba_ssd_cases
    del hymba_ssd
    # mamba2's rank 0 of phase 5q: 12 of its 24 heads, the tensor cores
    res = ssd_case(tq_ssd, timed=True)
    if res["route"] != ssd_ops.TENSOR_CORES or not res["worst"] <= 1.0:
        raise RuntimeError(f"ssd_chunk: {tq_ssd_key}'s rank 0 shape: {res}")
    print(f"  ssd_chunk at {tq_ssd_key} rank 0 ({tq_ssd[0].shape[2]} heads) "
          f"via {res['route']}: max |err| {res['max_abs_err']:.3e}, "
          f"err/limit {res['worst']:.3f}; {res['ms']:.4f} ms (device "
          f"{res['device_ms']}; plain {res['plain_ms']:.4f}, bound "
          f"{res['bound_ms']:.4f} by {res['bound_by']}); {res['shape']}")
    gqa_results[tq_ssd_key] = {"ssd_chunk": {"rank0_prefill": res}}
    del tq_ssd

    def ssd_inputs(b, nc, h, q, hd, ds, dt_hi=0.2):
        return (randn(b, nc, h, q, hd, dtype=torch.float32),
                randn(b, nc, q, ds, dtype=torch.float32),
                randn(b, nc, q, ds, dtype=torch.float32),
                -(0.01 + 0.39 * torch.rand((b, nc, h, q), generator=gen,
                                           device=dev)),
                0.01 + (dt_hi - 0.01) * torch.rand((b, nc, h, q),
                                                   generator=gen, device=dev))

    for shape in ((1, 2, 2, 8, 16, 8), (2, 3, 4, 16, 32, 16),
                  (1, 4, 3, 32, 64, 128), (2, 2, 5, 64, 64, 16),
                  (1, 3, 2, 128, 64, 128)):
        ssd[f"synthetic_{shape}"] = ssd_case(ssd_inputs(*shape))
    x, bm, cm, la, dt = ssd_inputs(1, 3, 4, 64, 64, 128)
    la[:, -1, :, 29:] = 0.0                 # the last chunk's pad steps
    dt[:, -1, :, 29:] = 0.0
    ssd["synthetic_pad_rows"] = ssd_case((x, bm, cm, la, dt))
    ssd["synthetic_large_dt"] = ssd_case(
        (x, bm, cm, torch.full_like(la, -60.0), torch.full_like(dt, 4.0)))
    for name, r in ssd.items():
        if not r["worst"] <= 1.0:
            raise RuntimeError(f"ssd_chunk: error at {name}: {r}")
        timing = (f"; {r['ms']:.4f} ms (device {r['device_ms']}, G "
                  f"{r['heads_per_block']}; the CUDA-core route: "
                  f"{r['cuda_cores_ms']:.4f}, device "
                  f"{r['cuda_cores_device_ms']}; plain {r['plain_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} by {r['bound_by']})"
                  if "ms" in r else "")
        print(f"  ssd_chunk {name} via {r['route']}: max |err| "
              f"{r['max_abs_err']:.3e}, max |ref| {r['max_abs_ref']:.3e}, "
              f"err/limit {r['worst']:.3f}{timing}; {r.get('shape', '')}")
    for name in ("live", "text"):
        if ssd[name]["route"] != ssd_ops.TENSOR_CORES:
            raise RuntimeError(f"ssd_chunk: the {name} shape took "
                               f"{ssd[name]['route']}")
    # every SSD instantiation, as the card reports it (local memory is what
    # spills, 0 when nothing does): the tensor-core kernel at Q 32, 64 and
    # 128, the CUDA-core kernel at each of its register tiles
    ssd_instances = ([(ssd_ops.TENSOR_CORES, q, 64, 128, f"ssd_chunk_mma_"
                       f"kernel<{q}>") for q in ssd_ops.MMA_Q]
                     + [(ssd_ops.CUDA_CORES, q, d, st, f"ssd_chunk_kernel<"
                         f"{uv}> (Q {q}, hd {d}, ds {st})")
                        for uv, q, d, st in ((1, 8, 16, 8), (2, 64, 64, 128),
                                             (2, 64, 64, 16),
                                             (4, 128, 128, 128))])
    for route, q, d, st, fn in ssd_instances:
        res = ssd_ops.ssd_resources(route, q, d, st)
        print(f"  {fn}: {res['registers']} registers, {res['local_bytes']} "
              f"bytes local memory, {res['static_smem_bytes']} + "
              f"{res['smem_bytes']} bytes static + dynamic smem, "
              f"{res['blocks_per_sm']} blocks of {res['threads']} threads "
              "per SM")
        if res["local_bytes"] != 0:
            raise RuntimeError(f"{fn} spills: {res}")
        ssd.setdefault("instantiations", []).append({"kernel": fn, **res})
    instances = ssd.pop("instantiations")
    live, text = ssd["live"], ssd["text"]
    results["ssd_chunk"] = {
        **{key: live[key] for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "shape",
                                      "device_ms", "cuda_cores_ms",
                                      "cuda_cores_device_ms",
                                      "heads_per_block")},
        "max_abs_err": max(live["max_abs_err"], text["max_abs_err"]),
        "max_abs_ref": max(live["max_abs_ref"], text["max_abs_ref"]),
        "worst": max(r["worst"] for r in ssd.values()),
        "synthetic_err": max(r["max_abs_err"] for n, r in ssd.items()
                             if n.startswith("synthetic")),
        "device_ms_by_shape": {n: ssd[n]["device_ms"]
                               for n in ("live", "text")},
        "route_by_shape": {n: r["route"] for n, r in ssd.items()},
        "resources": next(i for i in instances
                          if i["kernel"] == "ssd_chunk_mma_kernel<64>"),
        # the CUDA-core instantiation hymba's SSD heads run
        "resources_ds16": next(i for i in instances if i["kernel"].endswith(
            "(Q 64, hd 64, ds 16)")),
        "instantiations": instances,
        "cases": ssd}
    torch.cuda.synchronize()
    phase("kernels", t0)

    # -- 7. small reference: the engine on the card against the CPU ---------
    t0 = time.perf_counter()
    def small_reference(name, smodel, p_cpu, small_runs, rag_len=None):
        """Each run on the card and on the CPU: the same greedy (or seeded)
        tokens, first-token logits within the run's limit.  With
        ``rag_len`` the last request also links a retrieved image of that
        many tokens (MRAG); its upload must take the banded branch in every
        layer when it spans two windows or more."""
        small = smodel.cfg
        p_gpu = copy.deepcopy(p_cpu).to(dev)
        small_spool = tempfile.mkdtemp(prefix="mpic_smoke_small_")
        try:
            for run, (policy, kwargs, pool_dtype, paged, logit_tol, on_disk,
                      engine_kw) in enumerate(small_runs):
                outs = {}
                for where, p in (("cpu", p_cpu), (None, p_gpu)):
                    lib = KVLibrary(spool_dir=os.path.join(
                        small_spool, f"{run}-{where}") if on_disk else None,
                        quantize=on_disk and pool_dtype == "int8")
                    eng = MPICEngine(smodel, p, EngineConfig(
                        max_seq_len=320, decode_slots=2,
                        pool_dtype=pool_dtype, paged=paged,
                        **(engine_kw or {})), static_library=lib,
                        device=where)
                    n_sys = len(sys_toks)
                    sc = smodel.make_cache(1, n_sys + 1, device=eng.device)
                    _, sc = smodel.prefill(p, torch.as_tensor(
                        sys_toks[None], dtype=torch.int32,
                        device=eng.device), sc)
                    eng.prefix_store.put(sys_toks, sc["k"][:, 0, :n_sys],
                                         sc["v"][:, 0, :n_sys])
                    firsts = {}
                    finalize = eng._finalize_prefill

                    def record(req, result, *rest, firsts=firsts,
                               finalize=finalize):
                        firsts[req.req_id] = result.first_logits
                        return finalize(req, result, *rest)

                    eng._finalize_prefill = record
                    samples = make_dialogues(n=3, n_images=2,
                                             d_model=small.d_model,
                                             media_len=small.media_token_len,
                                             seed=3)
                    for s in samples:
                        for _, seg in s.prompt.media_segments():
                            eng.upload(s.prompt.user_id, seg.media_id,
                                       seg.embeds)
                            if on_disk:
                                lib.spool_now(s.prompt.user_id, seg.media_id)
                    rs = [Request(prompt=s.prompt, max_new_tokens=MAX_NEW,
                                  policy=policy, policy_kwargs=kwargs, seed=i)
                          for i, s in enumerate(samples)]
                    bands = []
                    if rag_len:
                        rag = image_embeds("rag-0", rag_len, small.d_model)
                        real_band = tf.banded_attend

                        def band(*args, real_band=real_band, bands=bands):
                            bands.append(args[0].shape[1])
                            return real_band(*args)

                        tf.banded_attend = band
                        try:
                            eng.upload("*", "rag-0", rag, dynamic=True)
                        finally:
                            tf.banded_attend = real_band
                        rs[-1].retrieval_query = rag.mean(0)
                    for r in rs:
                        eng.submit(r)
                    eng.run()
                    eng.close()
                    if not all(r.done for r in rs):
                        raise RuntimeError(f"{name}, {policy}: unfinished "
                                           f"{[r.error for r in rs]}")
                    if rag_len and ("rag-0" not in rs[-1].linked_media or (
                            rag_len >= 2 * small.sliding_window
                            and bands != [rag_len] * small.num_layers)):
                        raise RuntimeError(f"{name}, {policy}: MRAG linked "
                                           f"{rs[-1].linked_media}, banded "
                                           f"calls {bands}")
                    if smodel.cfg.hybrid and {r.prefill_stats["policy"]
                                              for r in rs} != {
                                                  "full_recompute"}:
                        raise RuntimeError(f"{name}, {policy}: not served "
                                           "as full_recompute")
                    st = lib.stats()
                    if on_disk and (st["tiers"]["disk"]["hits"],
                                    st["direct_links"]
                                    ) != (6, 6 if pool_dtype else 0):
                        raise RuntimeError(f"{name}, {policy} from disk: "
                                           f"{st['tiers']['disk']} {st}")
                    if (engine_kw or {}).get("prefill_chunk_tokens") and \
                            min(r.prefill_stats.get("chunks", 1)
                                for r in rs) <= 1:
                        raise RuntimeError(f"{name}, {policy}: not chunked")
                    outs[where] = ([r.output_tokens for r in rs],
                                   np.stack([firsts[r.req_id] for r in rs]))
                diff = float(np.abs(outs["cpu"][1] - outs[None][1]).max())
                same = outs["cpu"][0] == outs[None][0]
                where = ("dense cache" if eng.pool is None
                         else f"{pool_dtype or 'fp32'} pool")
                print(f"{name}, {policy} on the {where}"
                      f"{', media from disk, pipelined' if on_disk else ''}"
                      f"{f', {engine_kw}' if engine_kw else ''}: "
                      f"card vs CPU first-logit max diff {diff:.2e}, tokens "
                      f"identical {same}")
                if not diff <= logit_tol or ((pool_dtype == "" or on_disk)
                                             and not same):
                    raise RuntimeError("the card's engine disagrees with "
                                       "the CPU's")
        finally:
            shutil.rmtree(small_spool, ignore_errors=True)

    small = dataclasses.replace(get_smoke_config("llava-1.6-7b"),
                                param_dtype="float32", compute_dtype="float32")
    smodel = build_model(small)
    # (policy, kwargs, pool dtype, paged, first-logit limit, media on disk,
    # engine kwargs): the disk runs spool every block after its upload and
    # admit pipelined, the int8 one from a quantize=True library (the
    # direct int8 link)
    small_reference("small fp32 model", smodel, smodel.init(
        seed=1, device="cpu"), [
        ("mpic", {"k": 8}, "", True, 1e-3, False, None),
        ("mpic", {"k": 8}, "int8", True, 5e-2, False, None),
        ("cacheblend", {"r": 0.15}, "", True, 1e-3, False, None),
        ("full_recompute", {}, "", True, 1e-3, False, None),
        ("prefix_caching", {}, "", True, 1e-3, False, None),
        ("full_reuse", {}, "", True, 1e-3, False, None),
        ("mpic", {"k": 8}, "", False, 1e-3, False, None),
        ("mpic", {"k": 8}, "", True, 1e-3, True, None),
        ("mpic", {"k": 8}, "int8", True, 1e-3, True, None)])
    # qwen2.5-14b's smoke config at its own G 5 (10 query heads on 2 kv
    # heads) with nonzero QKV biases: mpic on both pools, chunked mpic and
    # full_recompute (chunks of 32), seeded sampling
    small = dataclasses.replace(get_smoke_config("qwen2.5-14b"),
                                num_heads=10, num_kv_heads=2,
                                param_dtype="float32", compute_dtype="float32")
    smodel = build_model(small)
    p_cpu = smodel.init(seed=1, device="cpu")
    bias_gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lp in p_cpu.layers:
            for b in (lp.attn.bq, lp.attn.bk, lp.attn.bv):
                b.copy_(torch.randn(b.shape, generator=bias_gen) * 0.5)
    chunk = {"prefill_chunk_tokens": 32}
    small_reference("small fp32 qwen2.5-14b (G 5, QKV bias)", smodel, p_cpu, [
        ("mpic", {"k": 8}, "", True, 1e-3, False, None),
        ("mpic", {"k": 8}, "int8", True, 5e-2, False, None),
        ("mpic", {"k": 8}, "", True, 1e-3, False, chunk),
        ("full_recompute", {}, "", True, 1e-3, False, chunk),
        ("mpic", {"k": 8}, "", True, 1e-3, False, SAMPLED)])
    # hymba's smoke config at its own G 5 (10 query heads on 2 kv heads)
    # on the dense fallback cache, a window of 64: the dialogues' prompts
    # (178-201 tokens) run past two windows, and the MRAG image of two
    # windows is uploaded through the banded branch
    small = dataclasses.replace(get_smoke_config(HYMBA), num_heads=10,
                                num_kv_heads=2, param_dtype="float32",
                                compute_dtype="float32")
    smodel = build_model(small)
    small_reference("small fp32 hymba-1.5b (G 5, window 64)", smodel,
                    smodel.init(seed=1, device="cpu"), [
                        ("full_recompute", {}, "", True, 1e-3, False, None),
                        ("mpic", {"k": 8}, "", True, 1e-3, False, None)],
                    rag_len=2 * small.sliding_window)
    # the small fp32 mamba2 on the dense fallback cache: images inlined
    ssm_small = dataclasses.replace(get_smoke_config("mamba2-130m"),
                                    param_dtype="float32",
                                    compute_dtype="float32")
    smodel = build_model(ssm_small)
    p_cpu = smodel.init(seed=1, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    for policy, kwargs in (("full_recompute", {}), ("mpic", {"k": 8})):
        outs = {}
        for where, p in (("cpu", p_cpu), (None, p_gpu)):
            eng = MPICEngine(smodel, p, EngineConfig(
                max_seq_len=320, decode_slots=2, paged=True), device=where)
            firsts = {}
            finalize = eng._finalize_prefill

            def record(req, result, *rest, firsts=firsts, finalize=finalize):
                firsts[req.req_id] = result.first_logits
                return finalize(req, result, *rest)

            eng._finalize_prefill = record
            samples = make_dialogues(n=3, n_images=2,
                                     d_model=ssm_small.d_model,
                                     media_len=ssm_small.media_token_len,
                                     seed=3)
            rs = [eng.submit(Request(prompt=s.prompt, max_new_tokens=MAX_NEW,
                                     policy=policy, policy_kwargs=kwargs))
                  for s in samples]
            eng.run()
            if eng.pool is not None or not all(
                    r.done and r.prefill_stats["policy"] == "full_recompute"
                    for r in rs):
                raise RuntimeError(f"small mamba2, {policy}: "
                                   f"{[r.error for r in rs]}")
            outs[where] = ([r.output_tokens for r in rs],
                           np.stack([firsts[r.req_id] for r in rs]))
        diff = float(np.abs(outs["cpu"][1] - outs[None][1]).max())
        same = outs["cpu"][0] == outs[None][0]
        print(f"small fp32 mamba2, {policy} (served as full_recompute) on "
              f"the dense cache: card vs CPU first-logit max diff "
              f"{diff:.2e}, tokens identical {same}")
        if not diff <= 1e-3 or not same:
            raise RuntimeError("the card's engine disagrees with the CPU's")
    # the smoke deepseek-moe-16b in fp32 (4 experts top-2 and a shared
    # one): its prompts (190-208 tokens) pass T = 64, so capacity drops
    # pairs in its full and paged prefills, on the card as on the CPU
    small = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                                param_dtype="float32",
                                compute_dtype="float32")
    smodel = build_model(small)
    card_drops = []
    route = moe_mod.route

    def counting(*args, **kwargs):
        out = route(*args, **kwargs)
        if out[4].device.type == dev.type:
            card_drops.append(int((~out[4]).sum()))
        return out

    moe_mod.route = counting
    try:
        small_reference("small fp32 deepseek-moe-16b (T > 64)", smodel,
                        smodel.init(seed=1, device="cpu"), [
                            ("mpic", {"k": 8}, "", True, 1e-3, False, None),
                            ("full_recompute", {}, "", True, 1e-3, False,
                             None),
                            ("mpic", {"k": 8}, "int8", True, 5e-2, False,
                             None)])
    finally:
        moe_mod.route = route
    print(f"small fp32 deepseek-moe-16b: {sum(card_drops)} (token, choice) "
          f"pairs dropped by capacity on the card over {len(card_drops)} "
          "routed passes")
    if not sum(card_drops) > 0:
        raise RuntimeError("the small MoE never dropped a pair")
    # a freeze / thaw / suffix thaw / fork round on the smoke llava (fp32),
    # on the card and on the CPU
    small = dataclasses.replace(get_smoke_config("llava-1.6-7b"),
                                param_dtype="float32",
                                compute_dtype="float32")
    smodel = build_model(small)
    p_cpu = smodel.init(seed=1, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    toks = np.random.default_rng(22).integers(8, 200, 40)
    suffix = [int(t) for t in np.random.default_rng(23).integers(8, 200, 9)]
    small_spool = tempfile.mkdtemp(prefix="mpic_smoke_sessions_small_")
    outs = {}
    try:
        for where, p in (("cpu", p_cpu), (None, p_gpu)):
            lib = KVLibrary(spool_dir=os.path.join(small_spool, str(where)),
                            device=where)
            eng = MPICEngine(smodel, p, EngineConfig(
                max_seq_len=320, decode_slots=4), static_library=lib,
                device=where)
            fz = eng.submit(Request(prompt=Prompt([text_segment(toks)],
                                                  user_id="u0"),
                                    max_new_tokens=MAX_NEW,
                                    policy="full_recompute",
                                    freeze_after=SESSION_FREEZE_AFTER))
            eng.run()
            h = eng.sessions.handles[fz.session_id]
            th = eng.thaw(h)
            eng.run()
            firsts = []
            prefill = eng._prefiller.prefill

            def recording(*args, prefill=prefill, firsts=firsts):
                firsts.append(prefill(*args))
                return firsts[-1]

            eng._prefiller.prefill = recording
            th2 = eng.thaw(h, suffix, max_new_tokens=MAX_NEW)
            eng._prefiller.prefill = prefill
            eng.run()
            kids = eng.fork(h, 2)
            eng.run()
            eng.close()
            outs[where] = ([fz.output_tokens, th.output_tokens,
                            th2.output_tokens]
                           + [k.output_tokens for k in kids],
                           firsts[0], eng.pool.cow_copies)
    finally:
        shutil.rmtree(small_spool, ignore_errors=True)
    diff = float(np.abs(outs["cpu"][1] - outs[None][1]).max())
    same = outs["cpu"][0] == outs[None][0]
    resumed = outs[None][0][0][:-1] + outs[None][0][1]
    print(f"small fp32 llava sessions (freeze at {SESSION_FREEZE_AFTER}, "
          f"thaw, thaw with a {len(suffix)}-token suffix, fork 2): card vs "
          f"CPU suffix first-logit max diff {diff:.2e}, tokens identical "
          f"{same}, cow_copies {outs[None][2]} / {outs['cpu'][2]}")
    if not diff <= 1e-3 or not same or outs[None][2] != 1 or \
            len(resumed) != MAX_NEW:
        raise RuntimeError("the card's sessions disagree with the CPU's")
    # whisper's smoke config in fp32 through phase 5l's pass (32 frames,
    # the same prompts), on the card and on the CPU
    small = dataclasses.replace(get_smoke_config(WHISPER),
                                param_dtype="float32",
                                compute_dtype="float32")
    smodel = build_model(small)
    p_cpu = smodel.init(seed=1, device="cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    audio, prompts = whisper_traffic(small)
    with no_plain_versions():
        w_gpu = run_whisper(smodel, p_gpu, audio, prompts)
    w_cpu = run_whisper(smodel, p_cpu, audio, prompts, device="cpu")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        [*w_cpu["prefill"], w_cpu["decode"]],
        [*w_gpu["prefill"], w_gpu["decode"]]))
    same = np.array_equal(w_cpu["tokens"], w_gpu["tokens"])
    print(f"small fp32 {WHISPER} (encode, cross K/V, four prefills, "
          f"{MAX_NEW} decode steps): card vs CPU logit max diff {diff:.2e}, "
          f"tokens identical {same}")
    if not diff <= 1e-3 or not same:
        raise RuntimeError("the card's whisper disagrees with the CPU's")
    # three train steps of the smoke yi-9b, whisper, mamba2 and hymba (at
    # two windows: the band) in fp32, card against CPU, from the same
    # weights on the same batches
    from repro_torch.data import train_batches, with_audio
    from repro_torch.training import AdamW, cosine_warmup, make_train_step
    for arch in ("yi-9b", WHISPER, *SSM_TRAIN_ARCHS):
        small = dataclasses.replace(get_smoke_config(arch),
                                    param_dtype="float32",
                                    compute_dtype="float32")
        smodel = build_model(small)
        p_cpu = smodel.init(seed=1, device="cpu")
        losses = {}
        for where, p in (("cpu", p_cpu), ("cuda", copy.deepcopy(p_cpu).to(
                dev))):
            data = train_batches(batch=2,
                                 seq=SMALL_TRAIN_SEQ.get(arch, TRAIN_SEQ),
                                 vocab=small.vocab_size, d_model=small.d_model)
            if small.is_encoder_decoder:
                data = with_audio(data, encoder_seq=small.encoder_seq,
                                  d_model=small.d_model)
            opt = AdamW(lr=cosine_warmup(1e-3, 1, 3))
            step, state = make_train_step(smodel, opt), opt.init(p)
            with (no_plain_versions(training=True) if where == "cuda"
                  else contextlib.nullcontext()):
                losses[where] = []
                for _ in range(3):
                    batch = {k: torch.as_tensor(v, device=p.embed.device)
                             for k, v in next(data).items()}
                    p, state, loss = step(p, state, batch)
                    losses[where].append(float(loss))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        print(f"small fp32 {arch}: three train steps, card losses "
              f"{losses['cuda']} vs CPU {losses['cpu']}: relative "
              f"{rel:.2e}")
        if not rel <= 1e-4:
            raise RuntimeError(f"{arch}: the card's training disagrees with "
                               "the CPU's")
    phase("small_reference", t0)

    # -- 8. every timed step beside its least time on this card --------------
    t0 = time.perf_counter()
    least_times = [row for r in [*runs.values(), *trained.values()]
                   for row in r.get("least", [])]
    print(f"least times ({card}; peaks of the H100 SXM data sheet at 700 "
          "W: 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink): measured "
          "/ least, what bounds it, roofline share, MFU")
    for row in least_times:
        print(f"  {row['step']}: {row['measured_ms']:.3f} ms / "
              f"{row['least_ms']:.4f} ms ({row['bound_by']}), share "
              f"{row['share']:.4f}, mfu {row['mfu']:.4f}"
              + (f", recording {row['record_ms']:.4f} ms of the measured"
                 if "record_ms" in row else "")
              + (f" [{row['note']}]" if row["note"] else ""))
    recorded = [row for row in least_times if "record_ms" in row]
    if recorded:
        worst = max(recorded, key=lambda r: r["record_ms"] / r["measured_ms"])
        total = (sum(r["record_ms"] for r in recorded)
                 / sum(r["measured_ms"] for r in recorded))
        print(f"the recording's host time in the timed steps: at most "
              f"{worst['record_ms'] / worst['measured_ms']:.4%} of a "
              f"measured step ({worst['step']}), {total:.4%} over all of "
              "them", flush=True)
    print(f"least times: {json.dumps({'card': card, 'steps': least_times})}",
          flush=True)
    run_dry_runs(env)
    over = [f"{row['step']} (share {row['share']:.3f})"
            for row in least_times if row["share"] > 1.05]
    if over:
        raise RuntimeError("steps faster than their least time (the count "
                           f"overstates their work): {over}")
    phase("least_times", t0)

    # -- report ------------------------------------------------------------
    # launches: every serving run's count, each reset before its first
    # upload or request
    launches = {name: sum(r["launches"][name] for r in runs.values())
                for name in KERNEL_FILES}
    for label, r in runs.items():
        print(f"run {label}: " + json.dumps(
            {k: v for k, v in r.items() if k != "launches"}))
    rows = []
    for name in ("sel_attn", "sel_attn_paged", "sel_attn_paged_q8",
                 "paged_attn", "paged_attn_q8", "ssd_chunk"):
        r = results[name]
        source, replaces = KERNEL_FILES[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_run": {label: run["launches"][name]
                                for label, run in runs.items()},
            "max_abs_err": r["max_abs_err"], "max_abs_ref": r["max_abs_ref"],
            "err_over_limit": r["worst"],
            "tolerance": SSD_TOLERANCE if name == "ssd_chunk" else TOLERANCE,
            "synthetic_err": r["synthetic_err"],
            **{key: r[key] for key in ("synthetic_bf16_err",
                                       "synthetic_err_over_limit",
                                       "resources", "resources_ds16",
                                       "instantiations",
                                       "device_ms", "device_ms_by_shape",
                                       "library_device_ms",
                                       "library_device_ms_by_shape",
                                       "route_by_shape", "heads_per_block",
                                       "cuda_cores_ms",
                                       "cuda_cores_device_ms",
                                       "profiled_decode_step")
               if key in r},
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": {"sel_attn": DENSE_LIBRARY_CALL,
                        "ssd_chunk": SSD_LIBRARY_CALL}.get(name,
                                                           LIBRARY_CALL),
            "shape": r["shape"], "card": card}
        if "cases" in r:
            row["cases"] = r["cases"]
        for arch, by_kernel in gqa_results.items():
            # each GQA model's layer-0 shapes (the dense attention's under
            # "cases" too) and its runs' launches
            if name not in by_kernel:
                continue
            cases = (by_kernel[name] if name in ("sel_attn", "ssd_chunk")
                     else {"main_path": by_kernel[name]})
            row[arch] = {
                "launches": sum(run["launches"][name] for run in runs.values()
                                if run.get("model") == arch),
                **{case: {key: g[key] for key in GQA_KEYS if key in g}
                   for case, g in cases.items()}}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
