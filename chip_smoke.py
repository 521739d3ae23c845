"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA device; it imports
nothing of JAX or of the JAX package. Phases (any failure exits non-zero;
each phase prints its seconds):

  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     float32 matmuls and convolutions are set to full float32 (TF32 off);
  2. the build: every CUDA source of the port, compiled from the checkout
     (one nvcc per source, all started together), naming each kernel that
     spills and printing any ptxas C7518 line (wgmma serialized);
  3. each kernel against its plain PyTorch version on the same inputs, at
     the main paths' shapes in bf16 and at ragged, fully masked and
     float32 edge shapes, with kernel, plain, library and bound times:
     the flash forwards at the serving shapes (L = 384), all on their
     wgmma route (timed beside the same call on the mma_sync route), and
     at edge cases of each route (wgmma: ragged 131 x 120 and, with
     192-row tiles, 140 x 383 x 120, with a fully masked bh and, with a 2-D
     bias, a fully masked query row, in every gate and bias mode; mma_sync:
     dh 16, a 2-D bias with j = 77; f32),
     each row naming its route; the flash
     backwards (B1b ungated, B2b gated, one 2-D-bias case) at the training
     shapes (pair axial at L = 128 and 256), every dq and every dkv on its
     wgmma route (each timed beside the same call on the mma_sync route),
     and at edge cases in every gate and bias
     mode, each row naming its dq and dkv routes (wgmma: ragged 131 x 76,
     140 x 383 x 383 past one wave of query and key tiles, 7 x 1000 with i
     under one query stage, each with a fully masked bh; mma_sync: j = 77
     and dh 16; f32); the int8 product (B4) at the
     served int8 request's ten dense-layer shapes (L = 384), all on its
     wgmma route, and at edge cases of each route (wgmma: ragged m, n = 16
     with one row, k = 1024; cp_async: ragged (m, k, n), a misaligned x,
     n = 8; f32), each row naming its route; the
     block-sparse forward and backward (B5) at the sparse request's pair
     axial shape (L = 384), the sparse train step's (crop 256) and n = 4096,
     B5f, B5 dq and B5 dkv on their wgmma routes, checked and timed again
     on the mma_sync routes, beside B1f and the dense dkv kernel on the
     dense pass of the same shape; n = 1024 with a masked batch element and
     n = 400 (ragged tiles; both on the wgmma routes); block sizes 32-128,
     head widths 16 and 32 (mma_sync), f32 and a ragged length; the lse flash kernel (B3)
     at the SP request's ring-hop shape (L = 384, 4 shards: 8 x 1,920 x
     36,864; timed unmasked, checked again with one (bh) row fully
     masked), f32 and ragged, and its backward through lse (random g and
     g_lse) at the L = 128 hop shape, its dq and dkv on the wgmma route
     (each timed beside the same call on the mma_sync route);
  4. the main path through `predict_structure`:
     (a) one request in float32 on the card and on the CPU with the same
         parameters: logits, confidence, stress and distances; at L = 64,
         again with int8 weights, and sparse (layer 0) at L = 128;
     (b) the serving configuration (dim 256, depth 2, heads 8, dim_head
         64, bf16) on three requests, L = 128, 256, 384, each with a
         seeded 20-row MSA, 200 MDS iterations, after one untimed warm-up
         request; latency, finiteness and kernel launch counts (6 per
         trunk layer, every one on the flash forward's wgmma route);
     (c) the same with attn_gate=True at depth 1, where the fused kernel
         carries every attention (wgmma route);
     (d) the same with int8 weights through `resident_params`: 22 int8
         products a trunk layer, every one on B4's wgmma route (none on
         cp_async), the flash launches unchanged;
     (e) the same with sparse_self_attn=(True, False): 2 sparse (every
         one on B5f's wgmma route) and 10 flash forwards a request;
     (f) the int8 model against the f32 model on its dequantized weights;
  8. the serving engine on the card (`serving/engine.py ServingEngine`, each
     (bucket, batch rung) a captured pair of CUDA graphs,
     `serving/executable.py`), after phase 4:
     (a) for each arm (f32 weights, gated at depth 1, int8, sparse layer 0)
         one captured (bucket 384, batch 2) request against eager
         `predict_structure` on the same padded inputs, bit for bit on
         coords, confidence, stress and logits, on two batches in turn;
         the capture's launches all on the wgmma routes;
     (b) the served config through the engine: buckets (128, 256, 384),
         max_batch 4 with the batch ladder, 24 seeded requests of 40-384
         residues with 20-row MSAs, then the same stream again: all
         complete, at most buckets x rungs captures, mean batch > 1, the
         second pass from the cache; throughput, p50/p95 latency, capture
         seconds a (bucket, rung), peak memory;
     (c) eager against captured at L = 128, 256, 384, batch 1: request ms,
         the launches the host issues and the device's busy share;
  6. the training path: `make_train_step` (the eager step) and train_pre's
     step on the card, `CapturedTrainStep` (the same step as a CUDA graph,
     `training/executable.py`):
     (a) dim 256, depth 1, heads 8, dim_head 64, accum 2, f32, 3 eager
         steps on the card and on the CPU from the same params and
         batches: loss, grad_norm, the first step's gradients leaf by leaf,
         the params after 3 steps; at L = 64, and sparse (every layer) at
         L = 128;
     (b) train_pre's defaults in bf16 (dim 256, depth 1, heads 8, dim_head
         64, batch 1, accum 16) at L = 128 and 256, captured: one untimed
         replay, 5 timed ones; step ms, MFU, capture seconds, peak memory,
         finite nonzero gradients, and 2 * depth * accum launches of each
         kernel per step in the replays (every forward, dq and dkv launch
         on its wgmma route);
     (c) the same with attn_gate=True at L = 128: the fused pair only;
     (e) the same sparse at L = 256 (max_seq_len 256): the three sparse
         kernels only, every B5f, B5 dq and B5 dkv launch on its wgmma
         route;
     (f) make_train_step refuses an int8 config;
     (d) 30 captured steps on one repeated batch at lr 1e-3 lower the loss;
     (g) captured against eager from the same params over 3 batches, with
         a warmup, cosine decay, clipping and weight decay, bit for bit on
         loss, grad_norm and every param leaf: f32 depth 2 at L = 64,
         the bf16 defaults at L = 128 dense and L = 256 sparse, and at
         L = 128 with remat_policy "dots"; every captured flash and sparse
         launch of the bf16 runs on its wgmma route;
     (h) eager against captured at crop 128, crop 128 gated and crop 256:
         step ms (host clock, median of 5, in turns), the launches the host
         issues, device ms and busy share under torch.profiler, capture
         seconds, peak memory;
     (i) the crop-256 captured step's peak memory and step ms under no
         remat, remat, remat_policy "dots" and "dots_no_batch";
     (j) `python -m alphafold2_tpu_torch.train_pre --steps 3 --bf16` runs
         its captured step;
  7. sequence-parallel serving (`parallel/sp_trunk.py alphafold2_apply_sp`,
     the ring's hops on B3):
     (a) f32, dim 64, depth 2, L = 64: 4 shards on the card against 4 CPU
         shards and against the dense forward on the card, "sp_seq" and
         "sp_msa", flat and aligned;
     (b) the serving configuration at L = 384 through
         `predict_structure(model_apply_fn=...)` with 4 shards on one card,
         after a warm-up: latency beside the dense request, finiteness,
         agreement with the dense request (within 1.5x the dense request's
         distance from the f32 request), and 40 B1f and 32 B3 launches,
         all 72 on the wgmma route;
     (c) the gradient of sum(ring_attention(...)^2), 4 shards, one
         shard's keys masked, card against CPU, in f32 and in bf16 (every
         hop's dq and dkv on the wgmma route): B3's backward;
     (d) (b) over distinct cards when the host has two or more;
  9. checkpoints and recovery (`training/checkpoint.py`,
     `training/resilience.py`) at train_pre's defaults (bf16, crop 128,
     accum 16), captured; each against the uninterrupted captured run bit
     for bit (loss, grad_norm, every param and AdamW moment and count),
     with no capture redone:
     (a) 6 steps saved at 2 and 4 (the checkpoint's bytes, save ms); a
         fresh state restored from step 2 through `open_or_init` (restore
         ms), then captured, runs steps 2-3;
     (b) `nan_grads` at step 2 rolled back by the guard's device snapshot;
         the guard's cost: step ms with and without it (CUDA events,
         median of 5, in turns) and the launches a guarded step issues;
     (c) `step_exception` at step 3 (max_restarts 1): restored from step 2
         into the live graph's tensors; step 4's file truncated and
         `step_exception` at 5: the restore falls back to step 2;
     (d) the restored step-4 params served by the engine (captured, L =
         128 and 256) bit for bit `predict_structure` on the params in
         memory, and in float32 card against CPU (phase 4's tolerances);
     its launches (the flash forward and both backward kernels, in the
     wrappers' counts and the replays') read just after;
  10. the template tower and trunk_schedule="branch_parallel":
     (a) a templated request (T = 2, a partial templates_mask, the last 5
         of L = 64 residues padded, a 20-row MSA), f32 (dim 64, depth 2),
         on the card and on the CPU with the same parameters, at phase
         4a's tolerances on valid pairs: int and float templates, gated
         and not; 22 flash forwards (10 the tower's) on the f32 route;
     (b) the serving configuration at L = 384 with T = 4 int templates
         beside the same request without templates: request and forward
         ms, finiteness, 22 flash forwards a templated request, all on the
         wgmma route (the joint attention's included);
     (c) B1f at the joint attention's shape (1,179,648 x 5 x 5, bf16)
         against its plain version, timed beside the mma_sync route, the
         dense einsum and SDPA, with its bound; B1b and B2b there; one
         tower layer's gradient, f32 card vs CPU, and bf16 with every dq
         and dkv on the wgmma route;
     (d) branch_parallel against serial, bit for bit: the eager forward
         at L = 384, one captured engine request (bucket 384, rung 1) and
         3 captured train steps at train_pre's defaults with a 20-row MSA;
         their ms (median of 5, in turns), busy share and the ms the two
         streams' kernels overlap (torch.profiler's trace);
  11. the full-atom path (`training/e2e.py predict_structure`: the trunk
     on the x3 elongated sequence -> distogram -> MDS with the mirror fix
     -> the side-chain lift -> the refiner; the ESM-1b embedder,
     `models/embedder.py`):
     (a) f32, card against CPU on the same parameters: the embedder (2
         layers at ESM-1b's width 1280, 20 heads, batch 2, one row padded,
         one <mask> token; representations 1e-4 * max(1, |ref|)), then e2e
         `predict_structure` at L = 32 (grid 96) on its embeddings, 20 MDS
         iterations, classical init, refiner depth 2 with a non-zero
         coordinate head: logits 1e-4, confidence 1e-5, the refined
         cloud's pairwise distances 1e-2 A, the phi ratios equal;
     (b) ESM-1b at full width (33 layers, random weights drawn on the
         card) at L = 128 and 384, f32 and bf16: ms, 33 B1f launches an
         embed (every bf16 one on the wgmma route), peak memory, each
         residue's bf16 cosine with f32 >= 0.99; B1f alone at the
         embedder's shapes (20, L + 2, L + 2) at dh 64, bf16 and f32,
         against its plain version, with SDPA and the bound;
     (c) the full-atom request at the serving config (bf16 trunk, f32
         geometry, 200 MDS iterations, classical init, refiner depth 2) at
         L = 128 and 256 on ESM-1b embeddings: B1f's first launch at each
         of the request's shapes (the embedder's, the pair axial (8 x 3L,
         3L, 3L), the embedds cross (8, 9L^2, 9L^2)) held against its
         plain version on sampled rows, with its ms and bound; each
         stage's ms (embed, trunk, distogram, MDS + mirror, side chains,
         refiner; events from `predict_structure`'s stage hook), the
         request's host ms and peak memory, finiteness, its 45 flash
         launches all on the wgmma route;
     (d) `python -m alphafold2_tpu_torch.predict --full-atom --bf16` on 64
         residues in a process of its own: rc 0, a PDB of 4 L atoms;
  12. end-to-end structure training (`training/e2e.py e2e_loss_fn`, the
     eager `make_train_step`; `CapturedTrainStep` refuses an E2EConfig,
     naming A8-e2e-capture):
     (a) f32, 3 steps of 2 microbatches on the card and on the CPU from
         the same params (dim 256, depth 1, L = 24, an 8-row MSA, 20 MDS
         iterations from the classical init), phase 6a's comparison and
         tolerances; every flash launch on the f32 route;
     (b) the step at the north-star model's widths less reversibility
         (dim 256, depth 2 with remat, 8 heads of 64, tied MSA rows, the
         aligned crosses with KV compression 4, ff_chunk_size 32768,
         refiner dim 64 depth 2 in atom chunks of 256, 25 MDS iterations,
         bf16) at crop 384 (grid 1152) with 128 MSA rows, accum 2: step
         ms (CUDA events, median of 5 after an untimed step), MFU, peak
         memory, launches (all on the wgmma routes), device ms by kind and
         busy share (torch.profiler), one microbatch by stage;
     (c) the first B1f and B1b launch at each of (b)'s shapes against its
         plain version on sampled rows, on the wgmma route, then timed at
         its shape beside SDPA and its bound;
     (d) `python -m alphafold2_tpu_torch.train_end2end` on the card (msa
         in a process of its own; esm at ESM-1b's width, none, and a
         bit-exact resume through its `main`), and 20 steps on one
         microbatch at (b)'s widths and crop 128 lowering the loss;
  13. the reversible trunk (`models/reversible.py`: the O(1)-memory
     backward as a `torch.autograd.Function`; `training/presets.py
     north_star_e2e_config`; `train_end2end --reversible`):
     (a) f32, 3 distogram steps of 2 microbatches on the card and on the
         CPU from the same params (dim 256, 8 heads of 64, depth 2, layer
         0 sparse, tied MSA rows, aligned crosses with KV compression 2, L
         = 64, 16 MSA rows), phase 6a's comparison and tolerances, every
         flash and B5 launch on its f32 route; the card's trunk gradient
         with reverse=True against reverse=False (1e-4 of each leaf's
         largest);
     (b) bf16 at the north-star widths, grid 384, 128 rows, depth 2 and 4:
         each leaf's reversible gradient against plain autograd's and the
         layer-0 input rebuilt from the output, held to bounds stated
         before the first run (`REV_GRAD_BOUND`, `REV_RECON_ULPS`);
     (c) the reversible distogram step captured (train_pre's defaults,
         depth 1, crop 128, accum 16, a 20-row MSA): 3 replays bit for bit
         3 eager steps, all on wgmma; its captured ms beside the
         sequential step's on the same batch and 6h's;
     (d) the north-star e2e step, reversible (`north_star_e2e_config(2)`:
         crop 384, grid 1152, 128 rows, accum 2, bf16, eager): step ms,
         MFU, peak memory, busy share, device ms by kind, 40 B1f and 20 +
         20 B1b launches a step, all on wgmma; one step of depth 4 and of
         depth 2 from fresh states: peak(4) - peak(2) < 1 GiB, and the
         depth-2 peak below 12b's remat peak;
     (e) `train_end2end.main --reversible --bf16 --len 32`: 3 steps against
         2 saved then 1 resumed, bit for bit;
  14. the relaxation (`refinement.py relax`, `refine`), the e2e step at
     depth through `--trunk-segments` (`training/segmented.py`: on CUDA
     the monolithic reversible step) and bucketed pretraining (`train_pre
     --data native --len-buckets`, the C++ loader of `runtime/native.py`):
     (a) relax, f32, 2 noisy 384-residue backbones with two chain breaks,
         200 iterations, card against CPU (coords 1e-4 A, history 1e-5 *
         max(1, |ref|)); ms a relax at L = 384 and 1024, its launches;
     (b) f32, depth 5, grid 48, 8 MSA rows, K = 3: from the random MDS init
         3 free steps card against CPU at phase 6a's tolerances; from the
         classical init, each of 3 steps' microbatches from the same params
         on both devices: the loss within 1e-5, the gradients at 6a's
         measure once the card starts from the CPU's init, and the init's
         departure (the top-3 eigenvectors of its Gram matrix, through the
         card's eigh of the CPU's own matrix and from each device's own)
         within the f32 eigensolver's bound;
     (c) `train_pre --data native --len-buckets 64,128,256 --len 256 --bf16
         --accum 2 --steps 200` in this process: finite losses, one capture
         a bucket, every launch on wgmma; the captured step against the
         eager one bit for bit over 256, 256, 64, 128, 256 (64 and 128
         captured in mid-run); each bucket's captured step ms and the
         loader's batches/s at 2 threads;
     (d) `predict --full-atom --bf16` at L = 128 -> `refine` on the card and
         with --device cpu: the PDB parses back with its CA B-factors, its
         bond energy falls, card within 1e-3 A of the CPU;
  15. live dropout in the captured train step and the random MDS init in
     the captured engine, drawn from generators on the card registered
     with the graphs (`utils/rng.py`):
     (a) train_pre's widths (dim 256, depth 1, heads 8, dim_head 64), bf16,
         crop 128, accum 2, ff_dropout 0.1: 3 captured steps with three
         step rngs against 3 eager ones on the card, bit for bit on loss,
         grad_norm and every param, AdamW moment and count; one batch
         under two rngs gives two losses; every B1f and B1b launch on
         wgmma, counted into the kernels line;
     (b) attn_dropout = ff_dropout = 0.1 with a 20-row MSA, each the same
         check: remat with remat_policy "dots", branch_parallel, and the
         reversible step (13c's config, accum 16);
     (c) `ServingEngine(mds_init="random", cache_capacity=0)` at the
         served config, buckets 128 / 256: each bucket's captured request
         against eager `predict_structure` on the card from a generator
         seeded with the engine's seed for that call, bit for bit; the
         next call starts from another init; four requests served; every
         B1f launch on wgmma, counted into the kernels line; f32 at L = 64,
         the card's init handed to the CPU: phase 4a's tolerances;
     (d) timings, reported: the captured crop-128 step (accum 16) without
         dropout, with ff_dropout and with both (the eager ff-dropout step
         beside it); a captured L = 384 request, random init against
         classical: ms, launches, busy share;
  16. attention dropout inside the block-sparse kernels (csrc/philox.cuh:
     the keep bits of each (bh, query, key) from a seed drawn on the card at
     the layer's rng position, `sparse.draw_seed`):
     (a) B5f, B5 dq and B5 dkv with dropout 0.1 and 0.5 on every route
         (wgmma at (2048, 256, 64) and (3072, 384, 64), mma_sync at block
         size 32 and at dh 32, f32) against their plain versions from the
         same seed, at phase 3's tolerances (the bf16 backward's bound on
         the dropped function, `sparse_dropout_bf16_bound`); lse the
         undropped one; rate 0 bit for bit the kernels without dropout; a
         second seed another output;
     (b) the sparse train step (train_pre's widths, bf16, crop 256, layer
         0 sparse at max_seq_len 256, attention and FF dropout 0.1, accum
         2): 3 captured steps with three step rngs against 3 eager ones bit
         for bit (loss, grad_norm, every param, AdamW moment and count);
         one batch under two rngs gives two losses; every B5 launch on
         wgmma and dropping, no plain or gather version called;
     (c) attention dropout 0.2: remat "dots" against the sequential eager
         step (bf16, crop 128) bit for bit; the reversible trunk (f32,
         13a's config) against plain autograd through the same masks, 13a's
         tolerance;
     (d) `sparse_attention_apply` in f32 at L = 128 with a padded mask,
         card against CPU from one seed tensor: out 1e-5 * max(1, |ref|),
         each gradient leaf 1e-4 of its largest entry;
     (e) times, reported: the captured crop-256 sparse step (accum 16) with
         no dropout, FF dropout and attention + FF dropout; each B5 kernel
         at (2048, 256, 64, 0.66 active) with and without dropout, its
         plain version, SDPA with dropout_p 0.1 and the bound;
  17. the telemetry plane (`alphafold2_tpu_torch/telemetry/`): the tracer,
     the registry and its Prometheus text, the cost and goodput ledgers, the
     flight book and recorder, the SLO engine and the ops server, wired into
     the engine and `train_pre`:
     (a) the served config through an instrumented engine with no
         precompile (buckets 128 / 256 / 384, rungs 1, 2, 4; phase 8b's 24
         requests), a thread scraping /metrics, /healthz and /statusz while
         it captures: every scrape 200, each request's lifecycle spans and
         /explainz flight, /metrics = stats(), serve-goodput causes summing
         to the wall within 1e-9 s, each cell's FLOPs `model_fwd_flops`
         and its device-seconds EMA (CUDA events) within its host windows
         and 2x its events' median, the SLO burn gauges, MFU only under a
         declared peak, every B1f launch on wgmma;
     (b) the same requests through an engine with no telemetry: bit for
         bit; a captured L = 384 request both ways (host clock, median of
         5 in turns);
     (c) `train_pre` (bf16, crop 128, accum 2) with `--metrics-log`,
         `--eval-every 2` and `--trace-out` against a run without: bit for
         bit, the goodput buckets summing to the wall with the capture in
         "compile"; one captured step bare and instrumented (host clock,
         median of 5 in turns);
     (d) a 2 s `/profilez` capture while serving: results bit for bit
         (b)'s, a Chrome trace, 429 on a second call; which kernels of the
         replayed graphs the trace shows, by name;
  18. trunk-depth early exit (`predict_structure(early_exit_depths=,
     early_exit_kl=)`, serving/pipeline.py `staged_trunk_logits`; the
     engine's staged executable, one CUDA graph a stage):
     (a) the served widths in float32 at depth 4, checkpoints (1, 2, 3), a
         batch of 4 distinct L = 64 requests with 4-row MSAs: the
         per-sample KLs on the CPU, the threshold at the geometric midpoint
         of their widest gap that leaves some samples exiting and some not
         (failing when that gap is under 1e3 x the card-vs-CPU KL
         difference); card against CPU: exit_depth equal, phase 4a's
         tolerances;
     (b) the served config (bf16) at depth 4 through `ServingEngine`
         (buckets 128 / 256 / 384, rungs 1, 2, 4, 20 MSA rows), classical
         and random init, at thresholds 1e-12 (nothing exits: bit for bit
         the engine without early exit), 1e9 (every sample exits at depth
         2: stages 3 and 4 never replayed, the logits the model cut to
         depth 2's) and the midpoint rule (mixed exits): every result bit
         for bit the eager staged `predict_structure` on the padded batch,
         the `dense@exit{d}@b{B}` cells counting their requests and summing
         to the engine's chip-seconds within 1e-6, every B1f launch on
         wgmma, counted into the kernels line;
     (c) times, reported: an L = 384 request at rung 1 (host clock and
         events, median of 5 in turns): (b)'s plain depth-4 executable and
         staged ones with nothing exiting and with everything exiting at
         depth 2, and a plain depth-2 one; each stage graph's events
         (median of 5) and the kernel time of one more call of the plain
         depth-4 and the nothing-exiting arms under torch.profiler, so the
         stages' cost splits into device work and the host's gaps;
  19. the serving fleet (`serving/fleet.py ServingFleet`: N captured
     engines on one card behind one admission queue, the card's lock
     (`serving/executable.py device_lock`) making each capture exclusive
     among them), phase 8b's stream at the served config with no result
     cache, each result held bit for bit against a bare `ServingEngine`'s
     at the rung that served it:
     (a) 2 replicas, every (bucket, rung) captured at build, the stream
         twice; `fleet_requests_total` once a request; one engine's graph
         pool bytes;
     (b) 3 replicas, no precompile, r0 killed (latched) and r2 flapping 3
         times: replicas capture while others replay, r2's reinstatement
         probe captures a fresh engine; a scraper on
         `ops_server_for_fleet` and a /profilez (200, then 429); nothing
         lost, no CaptureError, r1 never drained, r2 reinstated;
     (c) the int8 degraded tier at 50 MDS iterations with both full
         replicas killed: every answer degraded, bit for bit a bare int8
         engine's, every B4 launch on wgmma;
     (d) pools and the cascade at depth 4: an int8 draft pool (50
         iterations, early exit at (1, 2)) and a full pool; accepted drafts
         bit for bit the draft engine's, escalations the full engine's;
     (e) five drain / reinstate cycles of one replica (its graphs released
         under the card's lock, a fresh engine captured by its probe):
         memory allocated flat (the fifth within 5% of the first);
     (f) reported: requests/s, p50, p95 through the bare engine, a 1- and
         a 2-replica fleet in turns; a hedged fleet's hedges and wasted
         chip-seconds; the fleet chaos recipe through `serve` at the
         served widths (rc 0, nothing lost, requeues, sheds, degraded);
  20. the sequence-parallel serving arm (`serving/sp_arm.py`: the engine's
     `sp_shards`, each SP bucket's sharded forward captured into its graph
     one) and the replica autoscaler (`serving/autoscale.py`), the served
     config, 4 shards on one card (`sp_devices=["cuda:0"] * 4`):
     (a) the SP engine, sp_msa at 256 and sp_seq at 384 forced, 128 dense
         by the plan, every (bucket, rung) captured at build: phase 8b's
         stream, each result bit for bit eager `predict_structure(
         model_apply_fn=the bucket's SP forward)` at its rung; 32 B3
         launches recorded in each sp_seq graph; within phase 7b's
         yardstick of the dense request (over the SP-bucket requests); an
         engine left to the heuristic by a small `sp_hbm_gb` (sp_seq
         everywhere), one request bit for bit eager; no CaptureError;
     (b) reported: L = 384 through the SP and the dense (384, rung 1)
         executables (host clock, median of 5, in turns); each SP
         capture's seconds;
     (c) a fleet with the autoscaler (min 1, max 3, the verify skill's
         autoscaler recipe's policy) and a scale_flap plan, phase 8b's
         stream twice as one burst, then a grace: scale-up and scale-down, acted events spaced
         by the cooldowns, the flap absorbed, nothing lost, no
         CaptureError, every scrape 200, every result bit for bit the bare
         engine's at its rung, memory allocated flat (5%); each scale-up's
         build seconds, the longest gap between completions;
     (d) the same with pools: a dense pool (128 / 256) and an sp_shards
         pool (the SP engine's config), a per-pool autoscaler each, each
         result bit for bit its pool's bare engine;
  21. pipelined dispatch (the engine's `pipeline_depth`: the worker
     enqueues through `CapturedExecutable.enqueue`, a settle thread waits
     by polling an event under the card's capture lock), phase 8b's stream
     at the served config with no result cache:
     (a) engines at depths 0, 1 and 2 (every (bucket, rung) captured at
         build), the classical and the random init, the stream through
         them in turns (0, 1, 2, 2, 1, 0): every result bit for bit the
         depth-0 engine's executable on the batch that served it (its
         padded inputs and init index recorded), no CaptureError,
         `serve_pipeline_inflight` never past the depth;
     (b) at depth 2 (random init), the stream pass after pass while a
         second engine on the card precompiles its 9 graphs on another
         thread and a thread scrapes the engine's ops server: bit for bit
         (a)'s, every scrape 200, no CaptureError;
     (c) a 2-replica fleet at depth 2 under 19b's kill of r0: nothing
         lost, every result bit for bit the depth-0 engine's at its rung;
         a warm-up and 3 drain and reinstate cycles of r0 with a burst in
         flight: nothing lost, memory allocated over the 3 flat (5%);
     (d) reported, no limit: requests/s, p50, p95, mean latency, mean
         batch and the overlap ratio of each turn of (a), and one more
         pass a depth and init, each under a torch.profiler of its
         own (the card's busy share: the union of the kernels' intervals
         over the pass's wall), each beside the card's name and power
         limit; the settle thread's event queries; which host waits for
         the card keep the interpreter lock (`gil_probe`);
  22. the sequence-parallel training step (`parallel/train.py
     make_sp_train_step`, `sp_distogram_loss_fn`, `sp_e2e_loss_fn`; the
     captured SP step), 4 shards on one card, tied MSA rows, aligned
     crosses with KV compression 4; (b) and (c) at depth 2, the least depth
     at which the first layer's MSA<-pair ring reaches the loss, so that
     B3's dq and dkv run:
     (a) f32, dim 256, depth 1, L = 64, 8 MSA rows, accum 2, 3 steps on
         the card (["cuda:0"] * 4) and on 4 CPU shards from the same
         params: phase 6a's tolerances, every B1f, B1b and B3 launch
         counted exactly on the f32 route;
     (b) train_pre's widths in bf16, crop 256, a 20-row MSA, accum 16:
         the captured SP step bit for bit the eager one over 3 steps; the
         capture records one step's B1f, B1b, B3 forward, dq and dkv
         exactly, all on wgmma; the first step's loss and grad_norm within
         1.5x the dense bf16 step's distance from the dense f32 step, plus
         1e-5; reported: the captured SP and dense steps' ms (median of 5)
         and peak memory;
     (c) the e2e step at phase 12b's widths less remat, 128 MSA rows,
         accum 2, eager: one SP step tried at crop 384 (fits or out of
         memory, recorded), then SP against dense at crop 256 within (b)'s
         bound, every B1f, dq and dkv launch on wgmma, B3's counted;
         reported: the steps' ms (median of 3) and peak memory;
     (d) `train_pre --sp-shards 1 --bf16` (captured) and `train_end2end
         --sp-shards 1` on the card; `--sp-shards 4` refused with the
         mesh's device-count error on a host with fewer cards, else one
         eager step over distinct cards;
  5. a `kernels` JSON line (sixteen kernels: the two flash forwards, the
     four flash backward kernels, the int8 product, the three sparse
     kernels, the three sparse kernels with dropout, B3's forward and its
     two backward kernels), the card line, and the final `ok` JSON line.

A detailed record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import io
import json
import math
import shutil
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import alphafold2_tpu_torch  # noqa: E402
from alphafold2_tpu_torch.device import tree_leaves  # noqa: E402
from alphafold2_tpu_torch import (  # noqa: E402
    Alphafold2Config,
    alphafold2_apply,
    alphafold2_init,
    predict_structure,
)
from alphafold2_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    flash_kernel,
    quant,
    quant_kernel,
    sparse,
    sparse_kernel,
)
from alphafold2_tpu_torch.constants import AA_ORDER, PAD_TOKEN_ID  # noqa: E402
from alphafold2_tpu_torch.geometry import (  # noqa: E402
    calc_phis,
    scn_backbone_mask,
)
from alphafold2_tpu_torch.geometry.distogram import distogram_confidence  # noqa: E402
from alphafold2_tpu_torch.geometry.pdb import parse_pdb  # noqa: E402
from alphafold2_tpu_torch.models.alphafold2 import template_tower_apply  # noqa: E402
from alphafold2_tpu_torch.models.embedder import (  # noqa: E402
    ESM_IDX,
    EmbedderConfig,
    embed_sequences,
    embedder_apply,
    embedder_init,
    esm_tokenize,
)
from alphafold2_tpu_torch.ops.attention import AttentionConfig, attention_init  # noqa: E402
from alphafold2_tpu_torch.models.convert import train_state_to_jax  # noqa: E402
from alphafold2_tpu_torch.models.refiner import RefinerConfig  # noqa: E402
from alphafold2_tpu_torch import refine, refinement, train_end2end, train_pre  # noqa: E402
from alphafold2_tpu_torch.runtime import NativePrefetchLoader  # noqa: E402
from alphafold2_tpu_torch.training import segmented  # noqa: E402
from alphafold2_tpu_torch.telemetry import profiling  # noqa: E402
from alphafold2_tpu_torch.parallel import (  # noqa: E402
    alphafold2_apply_sp,
    make_mesh,
    make_sp_train_step,
    ring_attention,
    sp_distogram_loss_fn,
    sp_e2e_loss_fn,
)
from alphafold2_tpu_torch.serving.bucketing import BucketLadder, pad_batch  # noqa: E402
from alphafold2_tpu_torch.serving.autoscale import ReplicaAutoscaler, ScalePolicy  # noqa: E402
from alphafold2_tpu_torch.serving.engine import ServingConfig, ServingEngine  # noqa: E402
from alphafold2_tpu_torch.serving.executable import (  # noqa: E402
    CapturedExecutable,
    GraphPool,
)
from alphafold2_tpu_torch.reliability.faults import Fault, FaultPlan, InjectedFault  # noqa: E402
from alphafold2_tpu_torch.serving import executable as executable_mod  # noqa: E402
from alphafold2_tpu_torch.serving.cascade import CascadePolicy  # noqa: E402
from alphafold2_tpu_torch.serving.errors import QueueFullError  # noqa: E402
from alphafold2_tpu_torch.serving.executable import device_lock  # noqa: E402
from alphafold2_tpu_torch.serving.featurize import featurize_request  # noqa: E402
from alphafold2_tpu_torch.serving.fleet import FleetConfig, PoolSpec, ServingFleet  # noqa: E402
from alphafold2_tpu_torch.serving.quant_residency import resident_params  # noqa: E402
from alphafold2_tpu_torch.training.checkpoint import (  # noqa: E402
    VerifiedCheckpointManager,
    open_or_init,
    restore_params_for_inference,
)
from alphafold2_tpu_torch.training import e2e, presets  # noqa: E402
from alphafold2_tpu_torch.models import reversible  # noqa: E402
from alphafold2_tpu_torch.training.data import (  # noqa: E402
    DataConfig,
    synthetic_microbatch_fn,
    synthetic_structure_batches,
)
from alphafold2_tpu_torch.training.executable import CapturedTrainStep  # noqa: E402
from alphafold2_tpu_torch.training.harness import (  # noqa: E402
    TrainConfig,
    distogram_loss_fn,
    make_train_step,
    train_state_init,
    with_fault_injection,
)
from alphafold2_tpu_torch.training.resilience import StepGuard, run_resilient  # noqa: E402
from alphafold2_tpu_torch.utils.flops import train_step_flops  # noqa: E402
from alphafold2_tpu_torch.utils.rng import Streams, fold_in  # noqa: E402
from alphafold2_tpu_torch.telemetry import (  # noqa: E402
    FlightBook,
    FlightRecorder,
    ProfileCapturer,
    ServeGoodputLedger,
    SloEngine,
    Tracer,
    default_slo_config,
    device_memory_gauges,
    host_memory_gauges,
    ops_server_for_engine,
    ops_server_for_fleet,
    parse_prometheus_text,
)
from alphafold2_tpu_torch.utils.flops import model_fwd_flops  # noqa: E402
from alphafold2_tpu_torch.serving.engine import pad_msa_batch  # noqa: E402
from alphafold2_tpu_torch.serving.pipeline import staged_front, staged_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / f32 (no TF32)
BF16_ULP = 2.0 ** -7        # bf16 spacing relative to the value, upper bound
SOURCES = {
    "flash_fwd": "alphafold2_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd": "alphafold2_tpu_torch/csrc/flash_bwd.cu",
    "quant_matmul": "alphafold2_tpu_torch/csrc/quant_matmul.cu",
    "sparse_attn": "alphafold2_tpu_torch/csrc/sparse_attn.cu",
}
REPLACES = {
    "flash_fwd": "alphafold2_tpu/ops/flash_kernel.py:197",
    "flash_fwd_fused": "alphafold2_tpu/ops/flash_kernel.py:579",
    "flash_bwd_dq": "alphafold2_tpu/ops/flash_kernel.py:389",
    "flash_bwd_dkv": "alphafold2_tpu/ops/flash_kernel.py:401",
    "flash_bwd_fused_dq": "alphafold2_tpu/ops/flash_kernel.py:753",
    "flash_bwd_fused_dkv": "alphafold2_tpu/ops/flash_kernel.py:772",
    "quant_matmul": "alphafold2_tpu/ops/quant_kernel.py:133",
    "sparse_fwd": "alphafold2_tpu/ops/sparse_kernel.py:173",
    "sparse_bwd_dq": "alphafold2_tpu/ops/sparse_kernel.py:304",
    "sparse_bwd_dkv": "alphafold2_tpu/ops/sparse_kernel.py:318",
    # B3: flash_attention_lse :323 -> _flash_core_lse :318 -> _forward :197;
    # _bwd_lse :442 -> _bwd_impl :357 -> :389, :401
    "flash_fwd_lse": "alphafold2_tpu/ops/flash_kernel.py:323",
    "flash_bwd_lse_dq": "alphafold2_tpu/ops/flash_kernel.py:389",
    "flash_bwd_lse_dkv": "alphafold2_tpu/ops/flash_kernel.py:401",
}
COUNTED = (flash_kernel, quant_kernel, sparse_kernel)  # the modules with launch counts
RECORD = {"phases": {}}


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def sync():
    torch.cuda.synchronize()


def reset_launches():
    for module in COUNTED:
        module.reset_launches()


def launch_counts():
    """Every kernel's launches since the last reset_launches()."""
    return {name: n for module in COUNTED for name, n in module.LAUNCHES.items()}


def time_ms(fn, reps):
    """Mean device time of `reps` calls (CUDA events), after one warm-up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# --- phase 1: the card -----------------------------------------------------------


def phase_card():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    if Path(alphafold2_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("alphafold2_tpu_torch was not imported from this checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; TF32 off "
        f"(float32 matmuls and convolutions in full float32)")
    RECORD["card"] = smi
    return smi


# --- phase 2: the build ----------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    built = cuda_build.build()
    seconds = time.perf_counter() - t0
    for b in built.values():
        log(f"[build] {b.name}: {b.path.name} in {b.seconds:.1f} s")
        kernel = None
        for line in b.log.splitlines():  # ptxas -v: name each kernel that spills
            if "Function properties for" in line:
                kernel = line.split("Function properties for")[-1].strip()
            elif "bytes spill stores" in line and not line.strip().startswith("0 bytes stack"):
                log(f"[build]   {kernel}: {line.strip()}")
            if "C7518" in line:  # ptxas serialized a kernel's wgmma
                log(f"[build]   {b.name}.cu: {line.strip()}")
    log(f"[build] all sources built in {seconds:.1f} s")
    RECORD["phases"]["build_s"] = seconds


# --- phase 3: kernels against their plain versions --------------------------------


def make_inputs(BH, i, j, dh, dtype, *, masked_bh=(), key_drop=0.05, gated=False,
                bias2d=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(BH, i, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(BH, j, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(BH, j, dh, generator=g, device=dev).to(dtype)
    keep = torch.rand(BH, j, generator=g, device=dev) >= key_drop
    keep[:, 0] = True
    for b in masked_bh:
        keep[b] = False
    bias = torch.where(keep, 0.0, float("-inf"))
    if bias2d:
        bias = (torch.randn(BH, i, j, generator=g, device=dev) + bias[:, None, :]).contiguous()
        if i > 3:
            bias[0, 3] = float("-inf")  # one fully masked query row
    gate = torch.randn(BH, i, dh, generator=g, device=dev).to(dtype) if gated else None
    return q, k, v, bias, gate


def bound_terms(q, k, v, bias, gate):
    """The two floors of the work, in ms: operations / peak (4*BH*i*j*dh,
    QK^T and PV) and bytes moved / HBM rate (every input read once, every
    output (out, lse) written once)."""
    BH, i, dh = q.shape
    j = k.shape[1]
    flops = 4.0 * BH * i * j * dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, bias) + ((gate,) if gate is not None else ()))
    nbytes += q.numel() * q.element_size() + BH * i * 4
    return flops / PEAK_FLOPS[q.dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def sdpa_mask_ms(q, k, v, mask, scale, reps, g=None, wrt=None, mask_grad=False, heads=None,
                 dropout_p=0.0):
    """F.scaled_dot_product_attention with `mask` (additive, or boolean)
    and attention dropout `dropout_p`,
    forward, or with `wrt` its backward alone for the gradients "q", "kv"
    or "qkv" on a retained graph: a yardstick the port never calls. With
    `mask_grad` the additive mask requires grad, so the backward also
    computes the mask's gradient (the 2-D bias's d_bias, which B2b's dq
    kernel writes: "q" and "qkv" take it). The folded (BH, n, dh) tensors
    go in as one batch of BH heads, or with `heads` as (BH / heads, heads)
    (SDPA's grid takes at most 65,535 heads); mask None: no mask (the same
    function where every key is kept). None when no fused backend takes
    the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused_only = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.FLASH_ATTENTION]
    if heads is None:  # cuDNN's graph fails to execute on the (B L^2, heads) layout
        fused_only.append(SDPBackend.CUDNN_ATTENTION)
    split = ((lambda t: t[None]) if heads is None
             else (lambda t: t.reshape(t.shape[0] // heads, heads, *t.shape[1:])))
    q4, k4, v4 = (split(t.detach()).requires_grad_(wrt is not None) for t in (q, k, v))
    mask = mask if heads is None or mask is None else split(mask[0])
    if mask_grad:
        mask = mask.detach().requires_grad_(True)
    try:
        with sdpa_kernel(fused_only):
            if wrt is None:
                return time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=scale, dropout_p=dropout_p), reps)
            out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale,
                                                 dropout_p=dropout_p)
            extra = (mask,) if mask_grad else ()
            inputs = {"q": (q4,) + extra, "kv": (k4, v4), "qkv": (q4, k4, v4) + extra}[wrt]
            return time_ms(lambda: torch.autograd.grad(out, inputs, split(g),
                                                       retain_graph=True), reps)
    except RuntimeError as e:  # no fused backend takes this shape: no yardstick
        log(f"[library] none ({str(e).splitlines()[0][:100]})")
        return None


def dense_mask(q, k, bias):
    """The additive mask SDPA takes for a key-side (BH, j) or 2-D (BH, i, j)
    bias, cast before expanding (a key-side mask stays a stride-0 view)."""
    BH, i, _ = q.shape
    mask = bias.to(q.dtype)
    return (mask if mask.dim() == 3 else mask[:, None, :].expand(BH, i, k.shape[1]))[None]


def library_ms(q, k, v, bias, gate, scale, reps, heads=None):
    """One PyTorch call computing the same function: scaled_dot_product_attention
    with the bias as an additive mask (a yardstick only; the port never
    calls it). The gated kernel has no one-call equivalent: None."""
    if gate is not None:
        return None
    return sdpa_mask_ms(q, k, v, dense_mask(q, k, bias), scale, reps, heads=heads)


def counted_fwd(name, which, fn, args):
    """One call of a forward wrapper, which must count one launch under its
    own key and one under its route's (`flash_kernel.route`), none else."""
    before = dict(flash_kernel.LAUNCHES)
    out = fn(*args)
    sync()
    counted = {key: n - before[key] for key, n in flash_kernel.LAUNCHES.items()}
    if counted != {key: int(key in (name, f"flash_fwd_{which}")) for key in counted}:
        fail(f"{name} did not count one launch on its {which} route: {counted}")
    return out


def check_kernel(name, label, BH, i, j, dh, dtype, *, timed, masked_bh=(),
                 gated=False, bias2d=False, heads=None):
    q, k, v, bias, gate = make_inputs(BH, i, j, dh, dtype, masked_bh=masked_bh,
                                      gated=gated, bias2d=bias2d)
    scale = dh ** -0.5
    fn = getattr(flash_kernel, name)
    args = (q, k, v, bias, scale) + ((gate,) if name == "flash_fwd_fused" else ())
    which = flash_kernel.route(q, k, v, bias, gate)
    out, lse = counted_fwd(name, which, fn, args)
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q, k, v, bias, scale, gate)
    sync()
    # f32: both sides compute in f32 in another order. bf16: the kernel
    # rounds the probabilities to bf16 for P.V (~2^-9 of the output's
    # spread) and both round the output once: one bf16 ulp of the largest
    # output bounds both
    ref_max = ref_out.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if dtype == torch.float32 else BF16_ULP * ref_max
    err = (out.float() - ref_out.float()).abs().max().item()
    empty_ok = torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    if masked_bh:
        zero_ok = bool((out[list(masked_bh)] == 0).all()) and bool(
            torch.isposinf(lse[list(masked_bh)]).all())
    else:
        zero_ok = True
    ok = err <= tol and lse_err <= 1e-4 and empty_ok and zero_ok and torch.isfinite(out).all()
    row = {"kernel": name, "case": label, "shape": [BH, i, j, dh], "dtype": str(dtype),
           "route": which, "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
           "ok": bool(ok)}
    if timed:
        t_ops, t_bytes = bound_terms(q, k, v, bias, gate)
        est = max(1e-3, max(t_ops, t_bytes) * 50 / 1e3)  # rough seconds
        reps = max(2, min(20, int(1.0 / est)))
        row["kernel_ms"] = time_ms(lambda: fn(*args), reps)
        if which == "wgmma":  # the same call on the kernel the wgmma route replaced
            row["mma_sync_ms"] = time_ms(lambda: flash_kernel.launch_fwd(
                q, k, v, bias, scale, gate, name, which="mma_sync"), reps)
        row["plain_ms"] = time_ms(lambda: flash_kernel.flash_fwd_plain(q, k, v, bias, scale, gate),
                                  max(1, reps // 4))
        row["library_ms"] = library_ms(q, k, v, bias, gate, scale, reps, heads)
        row["ops_ms"], row["bytes_ms"] = t_ops, t_bytes
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    times = "".join(
        f" {key}={row[key]:.3f}" for key in ("kernel_ms", "mma_sync_ms", "plain_ms",
                                             "library_ms", "bound_ms")
        if row.get(key) is not None
    )
    log(f"[kernels] {name:15s} {label:22s} {str(tuple(row['shape'])):26s} "
        f"{str(dtype).split('.')[-1]:8s} {which:8s} max|d|={err:.3e} (tol {tol:.3e}) "
        f"lse|d|={lse_err:.2e}{times} {'ok' if ok else 'FAIL'}")
    del q, k, v, bias, gate, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return row


# the main path's attention shapes at L = 384, one request, heads 8,
# 20 MSA rows: (BH, i, j)
SLICE_SHAPES = {
    "pair axial": (3072, 384, 384),
    "cross pair<-msa": (8, 147456, 7680),
    "cross msa<-pair": (8, 7680, 147456),
}


def phase_kernels():
    """The flash forwards at the served shapes, timed, which must take the
    wgmma route; then edge cases: ragged 131 x 120 and 140 x 383 x 120
    (wgmma in every mode, with 128-row tiles and, without a 2-D bias,
    192-row ones: ragged i and j, a fully masked bh, with a 2-D bias a
    fully masked query row, gated + 2-D bias), ragged 131 x 77 (wgmma, and
    with a 2-D bias the mma_sync route: j % 4 != 0), dh 16 (mma_sync),
    f32."""
    rows = []
    for label, (BH, i, j) in SLICE_SHAPES.items():
        rows.append(check_kernel("flash_fwd", label, BH, i, j, 64, torch.bfloat16, timed=True))
        rows.append(check_kernel("flash_fwd_fused", label + " gated", BH, i, j, 64,
                                 torch.bfloat16, timed=True, gated=True))
    rows.append(check_kernel("flash_fwd_fused", "pair axial bias2d", 3072, 384, 384, 64,
                             torch.bfloat16, timed=True, bias2d=True))
    served = [r for r in rows if r["route"] != "wgmma"]
    if served:
        fail("served shapes off the wgmma route: " + ", ".join(r["case"] for r in served))
    edges = [
        ("ragged wgmma", 5, 131, 120, 64, torch.bfloat16, (1,)),
        ("ragged wgmma 192-row tiles", 140, 383, 120, 64, torch.bfloat16, (1,)),
        ("ragged", 5, 131, 77, 64, torch.bfloat16, (1,)),
        ("ragged f32", 5, 131, 77, 64, torch.float32, (1,)),
        ("tiny i, long j", 3, 7, 1000, 32, torch.float32, ()),
        ("dh16 masked", 4, 20, 20, 16, torch.bfloat16, (0, 3)),
        ("msa width pass", 3072, 20, 20, 64, torch.float32, ()),
    ]
    for label, BH, i, j, dh, dtype, masked in edges:
        rows.append(check_kernel("flash_fwd", label, BH, i, j, dh, dtype, timed=False,
                                 masked_bh=masked))
        rows.append(check_kernel("flash_fwd_fused", label + " gated", BH, i, j, dh, dtype,
                                 timed=False, masked_bh=masked, gated=True))
        rows.append(check_kernel("flash_fwd_fused", label + " bias2d", BH, i, j, dh, dtype,
                                 timed=False, masked_bh=masked, bias2d=True))
        rows.append(check_kernel("flash_fwd_fused", label + " gated bias2d", BH, i, j, dh,
                                 dtype, timed=False, masked_bh=masked, gated=True,
                                 bias2d=True))
    wgmma_edges = [r for r in rows if r["case"].startswith("ragged wgmma")]
    if any(r["route"] != "wgmma" for r in wgmma_edges):
        fail("the ragged wgmma edge cases left the wgmma route")
    RECORD["kernels"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             + ", ".join(f"{r['kernel']} {r['case']}" for r in bad))
    return rows


# --- phase 3, backward: the backward kernels against their plain versions ---------


def bwd_bound_terms(q, k, bias, dq_side):
    """The floors of one backward kernel, in ms. Operations: the dq kernel
    needs S, dP and dQ (6 * BH * i * j * dh), the dkv kernel S, dP, dK and
    dV (8 * ...); the pair's floor is 10 (S and dP once). Bytes: q, k, v,
    dO, lse, delta and the bias read once, its outputs (dq and d_bias, or
    dk and dv) written once."""
    BH, i, dh = q.shape
    j = k.shape[1]
    el = q.element_size()
    inputs = (2 * BH * i * dh + 2 * BH * j * dh) * el + 2 * BH * i * 4 + bias.numel() * 4
    if dq_side:
        ops = 6.0 * BH * i * j * dh
        nbytes = inputs + BH * i * dh * el + (bias.numel() * 4 if bias.dim() == 3 else 0)
    else:
        ops = 8.0 * BH * i * j * dh
        nbytes = inputs + 2 * BH * j * dh * el
    return ops / PEAK_FLOPS[q.dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, gate=None, g_lse=None):
    """Elementwise bound on |bf16 kernel - flash_bwd_plain| for (dq, dk,
    dv). The kernels round dS (and P, for dv) to bf16 before their
    products, a relative error of at most 2^-8 per element (half an ulp
    of bf16's 8-bit significand), so a sum moves by at most 2^-8 times the
    same sum over absolute values; then each side rounds its f32 result to
    bf16 once, and two values that straddle a rounding boundary land one
    bf16 ulp apart (at most 2^-7 of the value). So dq: 2^-8 scale |dS|
    |K|, dk: 2^-8 scale |dS|^T |Q|, dv: 2^-8 P^T |dO|, each plus 2^-7 |ref|.
    dS itself is P (dP - delta), where dP_ij = dO_i . V_j and delta_i =
    dO_i . O_i are each a sum of dh products in f32, summed in another
    order on the two sides: each differs by at most dh 2^-23 (a unit of
    f32 a term, rounding or truncating) of its sum of absolute products,
    so dS by E = P dh 2^-23 (|dO| |V|^T + rowsum(|dO| |O|)). That term
    matters only where dP and delta cancel (a row with one unmasked key,
    whose exact dS is 0): there the rest of the bound is 0 as well. It
    adds scale E |K| to dq and scale E^T |Q| to dk; the other f32 orders
    differ by ~2^-23 of the same absolute sums, inside the bound. With an
    lse cotangent g_lse (B3) the same holds for ds = p (g.v - (delta -
    g_lse)). Returns three f32 tensors."""
    BH, i, dh = q.shape
    # |dO| |O| of delta's sum (the raw cotangent and the output the forward gave)
    delta_abs = (g.float().abs() * out.float().abs()).sum(dim=-1)
    if g_lse is None:
        ref_dq, ref_dk, ref_dv, _, _ = flash_kernel.flash_bwd_plain(q, k, v, bias, out, lse, g,
                                                                    scale, gate)
        g, delta, _ = flash_kernel.cotangent_terms(out, g, gate)
    else:
        ref_dq, ref_dk, ref_dv = flash_kernel.flash_bwd_lse_plain(q, k, v, bias, out, lse, g,
                                                                  g_lse, scale)
        delta = flash_kernel.lse_delta(out, g, g_lse)
    bdq = torch.empty((BH, i, dh), dtype=torch.float32, device=q.device)
    bdk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    bdv = torch.zeros_like(bdk)
    edq, edk = torch.empty_like(bdq), torch.zeros_like(bdk)
    ka, va = k.float().abs(), v.float().abs()
    for r0, r1, qs, gs, p, ds in flash_kernel.bwd_tiles(q, k, v, bias, lse, g, delta, scale):
        ds = ds.abs()
        bdq[:, r0:r1] = torch.bmm(ds, ka) * scale
        bdk += torch.bmm(ds.transpose(1, 2), qs.abs()) * scale
        bdv += torch.bmm(p.transpose(1, 2), gs.abs())
        e = p * (dh * 2.0 ** -23) * (torch.bmm(gs.abs(), va.transpose(1, 2))
                                     + delta_abs[:, r0:r1, None])
        edq[:, r0:r1] = torch.bmm(e, ka) * scale
        edk += torch.bmm(e.transpose(1, 2), qs.abs()) * scale
    return tuple(2.0 ** -8 * b + e + BF16_ULP * r.float().abs()
                 for b, e, r in ((bdq, edq, ref_dq), (bdk, edk, ref_dk), (bdv, 0.0, ref_dv)))


def quant_bound(x, qw, scale, ref):
    """Elementwise bound on |quant_matmul kernel - quant_matmul_plain|. The
    two sum the same k products in another order (the plain version scales
    each weight before the product, the kernel scales the f32 sum once), a
    difference of at most k * 2^-24 * s * sum |x||q| per output (k roundings
    of at most one f32 unit each over the absolute sum); in bf16 each side
    then rounds its f32 result once, two values straddling a rounding
    boundary land one bf16 ulp (at most 2^-7 of the value) apart."""
    k = x.shape[1]
    bound = k * 2.0 ** -24 * scale.float().abs()[None, :] * (x.float().abs() @ qw.float().abs())
    if x.dtype == torch.bfloat16:
        bound = bound + BF16_ULP * ref.float().abs()
    return bound


def sparse_dense_bias(bias, table, heads):
    """(BH, n, n) f32: the key bias where the block layout is active, -inf
    elsewhere, so dense attention with this 2-D bias is the block-sparse
    attention (bias (BH / heads, n); table a sparse_kernel.BlockTable)."""
    B, bs = table.n_blocks, table.block_size
    active = torch.zeros((B, B + 1), dtype=torch.bool, device=bias.device)
    cols = torch.where(table.idx >= 0, table.idx.long(), B)  # padding -> a dropped column
    active.scatter_(1, cols, True)
    active = active[:, :B].repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    rows = bias.repeat_interleave(heads, 0)[:, None, :]
    return torch.where(active[None], rows, float("-inf")).contiguous()


def sparse_bwd_bf16_bound(q, k, v, bias, table, heads, out, lse, g, scale):
    """`flash_bwd_bf16_bound` of the dense attention the block-sparse one
    equals (`sparse_dense_bias`): the sparse kernels round dS and P to bf16
    before their products as the flash ones do."""
    return flash_bwd_bf16_bound(q, k, v, sparse_dense_bias(bias, table, heads), out, lse, g,
                                scale)


def sdpa_backward_ms(q, k, v, bias, g, scale, wrt, reps, heads=None):
    """The backward alone of F.scaled_dot_product_attention with the same
    additive mask, for the gradients `wrt` ("q", "kv" or "qkv"), on a
    retained graph (a yardstick; the port never calls it); a 2-D bias's mask
    requires grad (the memory-efficient backend differentiates it). None
    when no fused backend takes the shape or that gradient."""
    return sdpa_mask_ms(q, k, v, dense_mask(q, k, bias), scale, reps, g, wrt,
                        mask_grad=bias.dim() == 3, heads=heads)


def check_bwd(label, BH, i, j, dh, dtype, *, timed, masked_bh=(), gated=False,
              bias2d=False, heads=None):
    """One backward pair (B1b when neither gated nor bias2d, else B2b) on
    the forward kernel's out and lse, against flash_bwd_plain; one launch of
    each kernel, counted again under its route (`dq_route`, `dkv_route`).
    Timed: each kernel, each call again on the mma_sync route when it takes
    wgmma, the plain versions and the SDPA backward.

    Tolerances: f32, 1e-5 * max(1, max|ref|) per output (both in f32,
    another summation order). bf16, elementwise, flash_bwd_bf16_bound:
    2^-8 times the absolute sum behind each output (the kernels round dS
    and P to bf16, half an ulp, before their products) plus one bf16 ulp
    of the output (2^-7 of it: the two sides round their f32 results once
    each). d_bias
    is f32 on both sides: 1e-5 * max(1, max|ref|). d_gate is the same
    elementwise code on both sides: equal."""
    q, k, v, bias, gate = make_inputs(BH, i, j, dh, dtype, masked_bh=masked_bh,
                                      gated=gated, bias2d=bias2d, seed=3)
    scale = dh ** -0.5
    fused = gated or bias2d
    if fused:
        out, lse = flash_kernel.flash_fwd_fused(q, k, v, bias, scale, gate)
    else:
        out, lse = flash_kernel.flash_fwd(q, k, v, bias, scale)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda").to(dtype)
    names = (("flash_bwd_fused_dq", "flash_bwd_fused_dkv") if fused
             else ("flash_bwd_dq", "flash_bwd_dkv"))
    which = flash_kernel.dkv_route(q, k, v, bias)
    dq_which = flash_kernel.dq_route(q, k, v, bias)
    routes = (f"flash_bwd_dq_{dq_which}", f"flash_bwd_dkv_{which}")
    before = dict(flash_kernel.LAUNCHES)
    if fused:
        dq, dk, dv, d_bias, d_gate = flash_kernel.flash_bwd_fused(
            q, k, v, bias, gate, out, lse, g, scale)
    else:
        (dq, dk, dv), d_bias, d_gate = flash_kernel.flash_bwd(
            q, k, v, bias, out, lse, g, scale), None, None
    sync()
    counted = {key: n - before[key] for key, n in flash_kernel.LAUNCHES.items()}
    if counted != {key: int(key in names + routes) for key in counted}:
        fail(f"{names} did not count one launch each, on their routes {routes}: {counted}")
    ref = flash_kernel.flash_bwd_plain(q, k, v, bias, out, lse, g, scale, gate)
    sync()
    if dtype == torch.float32:
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref[:3]]
    else:
        bounds = flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, gate)
    errs, ratios = [], []
    for got, want, bound in zip((dq, dk, dv), ref[:3], bounds):
        diff = (got.float() - want.float()).abs()
        bound = torch.as_tensor(bound, device=diff.device)
        errs.append(diff.max().item())
        # |d| / bound, with 0 / 0 (a gradient that is 0 on both sides) as 0
        ratio = torch.where(bound > 0, diff / bound, torch.where(diff > 0, math.inf, 0.0))
        ratios.append(ratio.max().item())
    ok = all(r <= 1.0 for r in ratios) and all(
        bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    row = {"kernel": names[0].rsplit("_", 1)[0], "case": label, "shape": [BH, i, j, dh],
           "dtype": str(dtype), "dq_route": dq_which, "dkv_route": which, "dq_err": errs[0],
           "dkv_err": max(errs[1:]), "bound_ratio": max(ratios)}
    if bias2d:
        db_err = (d_bias - ref[3]).abs().max().item()
        ok = ok and db_err <= 1e-5 * max(1.0, ref[3].abs().max().item())
        row["dq_err"] = max(row["dq_err"], db_err)
        row["d_bias_err"] = db_err
    if gated:
        ok = ok and torch.equal(d_gate, ref[4])
    for b in masked_bh:
        ok = ok and all(bool((t[b] == 0).all()) for t in (dq, dk, dv))
    row["ok"] = bool(ok)
    if timed:
        g_eff, delta, _ = flash_kernel.cotangent_terms(out, g, gate)
        args = (q, k, v, bias, lse, g_eff, delta, scale)
        reps = 10
        row["dq_ms"] = time_ms(lambda: flash_kernel.launch_dq(*args, names[0]), reps)
        row["dkv_ms"] = time_ms(lambda: flash_kernel.launch_dkv(*args, names[1]), reps)
        # the same calls on the kernels the wgmma routes replaced
        if dq_which == "wgmma":
            row["dq_mma_sync_ms"] = time_ms(lambda: flash_kernel.launch_dq(
                *args, names[0], which="mma_sync"), reps)
        if which == "wgmma":
            row["dkv_mma_sync_ms"] = time_ms(lambda: flash_kernel.launch_dkv(
                *args, names[1], which="mma_sync"), reps)
        row["dq_plain_ms"] = time_ms(lambda: flash_kernel.flash_bwd_dq_plain(*args), 2)
        row["dkv_plain_ms"] = time_ms(lambda: flash_kernel.flash_bwd_dkv_plain(*args), 2)
        # the gate acts outside the kernels (cotangent_terms): fed g_eff, the
        # SDPA backward computes what they compute, gated or not
        lib_q = sdpa_backward_ms(q, k, v, bias, g_eff, scale, "q", reps, heads)
        lib_kv = sdpa_backward_ms(q, k, v, bias, g_eff, scale, "kv", reps, heads)
        row["dq_library_ms"], row["dkv_library_ms"] = lib_q, lib_kv
        for side, dq_side in (("dq", True), ("dkv", False)):
            t_ops, t_bytes = bwd_bound_terms(q, k, bias, dq_side)
            row[f"{side}_ops_ms"], row[f"{side}_bytes_ms"] = t_ops, t_bytes
            row[f"{side}_bound_ms"] = max(t_ops, t_bytes)
        BHij = float(BH) * i * j * dh
        el = q.element_size()
        # q and dO read, dq written; k and v read, dk and dv written; lse
        # and delta read; the bias read (and d_bias written)
        pair_bytes = ((3 * BH * i * dh + 4 * BH * j * dh) * el + 2 * BH * i * 4
                      + bias.numel() * 4 * (2 if bias2d else 1))
        row["kernel_ms"] = row["dq_ms"] + row["dkv_ms"]
        row["plain_ms"] = row["dq_plain_ms"] + row["dkv_plain_ms"]
        row["library_ms"] = (None if lib_q is None
                             else sdpa_backward_ms(q, k, v, bias, g_eff, scale, "qkv", reps,
                                              heads))
        row["bound_ms"] = max(10 * BHij / PEAK_FLOPS[dtype], pair_bytes / HBM_BYTES_PER_S) * 1e3
        row["kernel_ops_ms"] = 14 * BHij / PEAK_FLOPS[dtype] * 1e3
    times = "".join(
        f" {key}={row[key]:.3f}" for key in ("dq_ms", "dq_mma_sync_ms", "dq_library_ms",
                                             "dq_bound_ms", "dkv_ms", "dkv_mma_sync_ms",
                                             "dkv_library_ms", "dkv_bound_ms", "plain_ms",
                                             "library_ms", "bound_ms")
        if row.get(key) is not None
    )
    log(f"[bwd] {row['kernel']:15s} {label:24s} {str(tuple(row['shape'])):24s} "
        f"{str(dtype).split('.')[-1]:8s} dq {dq_which:8s} dkv {which:8s} "
        f"dq|d|={row['dq_err']:.3e} "
        f"dkv|d|={row['dkv_err']:.3e} "
        f"(bound ratio {row['bound_ratio']:.3f}){times} {'ok' if ok else 'FAIL'}")
    del q, k, v, bias, gate, out, lse, g, ref
    torch.cuda.empty_cache()
    return row


def phase_bwd_kernels():
    rows = []
    for L in (128, 256):
        BH = L * 8  # pair axial: L rows of the L x L grid, 8 heads
        rows.append(check_bwd(f"pair axial L={L}", BH, L, L, 64, torch.bfloat16, timed=True))
        rows.append(check_bwd(f"pair axial L={L} gated", BH, L, L, 64, torch.bfloat16,
                              timed=True, gated=True))
    rows.append(check_bwd("pair axial L=128 bias2d", 1024, 128, 128, 64, torch.bfloat16,
                          timed=True, bias2d=True))
    off = [r["case"] for r in rows if r["dkv_route"] != "wgmma"]
    if off:
        fail("trained backward shapes off the wgmma dkv route: " + ", ".join(off))
    off = [r["case"] for r in rows if r["dq_route"] != "wgmma"]
    if off:
        fail("trained backward shapes off the wgmma dq route: " + ", ".join(off))
    edges = [
        # the dq and dkv kernels' wgmma routes: ragged i and j; 420 query
        # and key tiles, past one wave (with a 2-D bias j % 4 != 0:
        # mma_sync); i < 64, long j
        ("ragged wgmma", 5, 131, 76, 64, torch.bfloat16, (1,)),
        ("past one wave", 140, 383, 383, 64, torch.bfloat16, (1,)),
        ("short i, long j", 3, 7, 1000, 64, torch.bfloat16, (1,)),
        ("ragged", 5, 131, 77, 64, torch.bfloat16, (1,)),
        ("ragged f32", 5, 131, 77, 64, torch.float32, (1,)),
        ("tiny i, long j", 3, 7, 1000, 32, torch.float32, ()),
        ("dh16 masked", 4, 20, 20, 16, torch.bfloat16, (0, 3)),
    ]
    for label, BH, i, j, dh, dtype, masked in edges:
        for gated, bias2d, suffix in ((False, False, ""), (True, False, " gated"),
                                      (False, True, " bias2d"), (True, True, " gated bias2d")):
            rows.append(check_bwd(label + suffix, BH, i, j, dh, dtype, timed=False,
                                  masked_bh=masked, gated=gated, bias2d=bias2d))
    wgmma_edges = [r for r in rows if r["case"].startswith(("ragged wgmma", "past one wave",
                                                             "short i, long j"))
                   and not ("bias2d" in r["case"] and r["shape"][2] % 4)]
    if len(wgmma_edges) != 10 or any(r[key] != "wgmma" for r in wgmma_edges
                                     for key in ("dq_route", "dkv_route")):
        fail("the wgmma dq or dkv edge cases left the wgmma route")
    RECORD["bwd_kernels"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} backward check(s) disagree with the plain version: "
             + ", ".join(f"{r['kernel']} {r['case']}" for r in bad))
    return rows


# --- phase 3, B3: the lse flash kernels of the ring hops ---------------------------


def lse_library_ms(q, k, v, bias, scale, reps):
    """One PyTorch call computing out and lse with an additive mask:
    aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True) (a
    yardstick only). Where this torch lacks it or it refuses the shape,
    F.scaled_dot_product_attention's out-only time, labelled so. Returns
    (ms or None, label)."""
    mask = dense_mask(q, k, bias)
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    try:
        op = torch.ops.aten._scaled_dot_product_efficient_attention
        ms = time_ms(lambda: op(q4, k4, v4, mask, True, scale=scale), reps)
        return ms, "aten._scaled_dot_product_efficient_attention (out and lse)"
    except (AttributeError, RuntimeError) as e:
        log(f"[library] efficient attention with lse: none ({str(e).splitlines()[0][:100]})")
        return sdpa_mask_ms(q, k, v, mask, scale, reps), "scaled_dot_product_attention (out only)"


def check_lse(label, BH, i, j, dh, dtype, *, timed, masked_bh=()):
    """B3's forward (`flash_fwd_lse`) against flash_fwd_plain: out within
    one bf16 ulp of the largest output (f32: 1e-5 * max(1, max|ref|)), lse
    1e-4 where finite and +inf exactly where the plain version has it (a
    (bh) row with every key masked: zeros and +inf)."""
    q, k, v, bias, _ = make_inputs(BH, i, j, dh, dtype, masked_bh=masked_bh, seed=5)
    scale = dh ** -0.5
    which = flash_kernel.route(q, k, v, bias)
    out, lse = counted_fwd("flash_fwd_lse", which, flash_kernel.flash_fwd_lse,
                           (q, k, v, bias, scale))
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q, k, v, bias, scale)
    ref_max = ref_out.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if dtype == torch.float32 else BF16_ULP * ref_max
    err = (out.float() - ref_out.float()).abs().max().item()
    fin = torch.isfinite(ref_lse)
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
    ok = (err <= tol and lse_err <= 1e-4 and bool(torch.isfinite(out).all())
          and torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse)))
    for b in masked_bh:
        ok = ok and bool((out[b] == 0).all()) and bool(torch.isposinf(lse[b]).all())
    row = {"kernel": "flash_fwd_lse", "case": label, "shape": [BH, i, j, dh],
           "dtype": str(dtype), "route": which, "max_abs_err": err, "tol": tol,
           "lse_max_abs_err": lse_err, "ok": bool(ok)}
    if timed:
        t_ops, t_bytes = bound_terms(q, k, v, bias, None)
        row["kernel_ms"] = time_ms(lambda: flash_kernel.flash_fwd_lse(q, k, v, bias, scale), 20)
        if which == "wgmma":
            row["mma_sync_ms"] = time_ms(lambda: flash_kernel.launch_fwd(
                q, k, v, bias, scale, None, "flash_fwd_lse", which="mma_sync"), 20)
        row["plain_ms"] = time_ms(lambda: flash_kernel.flash_fwd_plain(q, k, v, bias, scale), 3)
        row["library_ms"], row["library"] = lse_library_ms(q, k, v, bias, scale, 20)
        row["ops_ms"], row["bytes_ms"] = t_ops, t_bytes
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    times = "".join(f" {key}={row[key]:.3f}" for key in
                    ("kernel_ms", "mma_sync_ms", "plain_ms", "library_ms", "bound_ms")
                    if row.get(key) is not None)
    log(f"[lse] {label:26s} {str((BH, i, j, dh)):26s} {str(dtype).split('.')[-1]:8s} {which:8s} "
        f"max|d|={err:.3e} (tol {tol:.3e}) lse|d|={lse_err:.2e}{times}"
        f"{' (' + row['library'] + ')' if timed else ''} {'ok' if ok else 'FAIL'}")
    del q, k, v, bias, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return row


def check_lse_bwd(label, BH, i, j, dh, dtype, *, timed, masked_bh=()):
    """B3's backward (`flash_bwd_lse`, the B1b kernels with delta - g_lse)
    on the forward kernel's out and lse, with a random g and a random g_lse
    (also on the empty rows, whose gradients must stay exact zeros),
    against flash_bwd_lse_plain. Tolerances as `check_bwd`: f32 1e-5 *
    max(1, max|ref|); bf16 elementwise `flash_bwd_bf16_bound` with the lse
    cotangent."""
    q, k, v, bias, _ = make_inputs(BH, i, j, dh, dtype, masked_bh=masked_bh, seed=6)
    scale = dh ** -0.5
    out, lse = flash_kernel.flash_fwd_lse(q, k, v, bias, scale)
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    names = ("flash_bwd_lse_dq", "flash_bwd_lse_dkv")
    which = flash_kernel.dkv_route(q, k, v, bias)
    dq_which = flash_kernel.dq_route(q, k, v, bias)
    routes = (f"flash_bwd_dq_{dq_which}", f"flash_bwd_dkv_{which}")
    before = dict(flash_kernel.LAUNCHES)
    dq, dk, dv = flash_kernel.flash_bwd_lse(q, k, v, bias, out, lse, g, g_lse, scale)
    sync()
    counted = {key: n - before[key] for key, n in flash_kernel.LAUNCHES.items()}
    if counted != {key: int(key in names + routes) for key in counted}:
        fail(f"{names} did not count one launch each, on their routes {routes}: {counted}")
    ref = flash_kernel.flash_bwd_lse_plain(q, k, v, bias, out, lse, g, g_lse, scale)
    if dtype == torch.float32:
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    else:
        bounds = flash_bwd_bf16_bound(q, k, v, bias, out, lse, g, scale, g_lse=g_lse)
    errs, ratios = [], []
    for got, want, bound in zip((dq, dk, dv), ref, bounds):
        diff = (got.float() - want.float()).abs()
        bound = torch.as_tensor(bound, device=diff.device)
        errs.append(diff.max().item())
        ratio = torch.where(bound > 0, diff / bound, torch.where(diff > 0, math.inf, 0.0))
        ratios.append(ratio.max().item())
    ok = all(r <= 1.0 for r in ratios) and all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    for b in masked_bh:
        ok = ok and all(bool((t[b] == 0).all()) for t in (dq, dk, dv))
    row = {"kernel": "flash_bwd_lse", "case": label, "shape": [BH, i, j, dh],
           "dtype": str(dtype), "dq_route": dq_which, "dkv_route": which, "dq_err": errs[0],
           "dkv_err": max(errs[1:]), "bound_ratio": max(ratios), "ok": bool(ok)}
    if timed:
        args = (q, k, v, bias, lse, g, flash_kernel.lse_delta(out, g, g_lse).contiguous(), scale)
        row["dq_ms"] = time_ms(lambda: flash_kernel.launch_dq(*args, names[0]), 10)
        row["dkv_ms"] = time_ms(lambda: flash_kernel.launch_dkv(*args, names[1]), 10)
        # the same calls on the kernels the wgmma routes replaced
        if dq_which == "wgmma":
            row["dq_mma_sync_ms"] = time_ms(lambda: flash_kernel.launch_dq(
                *args, names[0], which="mma_sync"), 10)
        if which == "wgmma":
            row["dkv_mma_sync_ms"] = time_ms(lambda: flash_kernel.launch_dkv(
                *args, names[1], which="mma_sync"), 10)
        row["dq_plain_ms"] = time_ms(lambda: flash_kernel.flash_bwd_dq_plain(*args), 2)
        row["dkv_plain_ms"] = time_ms(lambda: flash_kernel.flash_bwd_dkv_plain(*args), 2)
        # no PyTorch call takes an lse cotangent: no library time
        row["dq_library_ms"] = row["dkv_library_ms"] = None
        for side, dq_side in (("dq", True), ("dkv", False)):
            t_ops, t_bytes = bwd_bound_terms(q, k, bias, dq_side)
            row[f"{side}_ops_ms"], row[f"{side}_bytes_ms"] = t_ops, t_bytes
            row[f"{side}_bound_ms"] = max(t_ops, t_bytes)
    times = "".join(f" {key}={row[key]:.3f}" for key in
                    ("dq_ms", "dq_mma_sync_ms", "dkv_ms", "dkv_mma_sync_ms", "dq_plain_ms",
                     "dkv_plain_ms", "dq_bound_ms", "dkv_bound_ms") if row.get(key) is not None)
    log(f"[lse bwd] {label:22s} {str((BH, i, j, dh)):24s} {str(dtype).split('.')[-1]:8s} "
        f"dq {dq_which:8s} dkv {which:8s} "
        f"dq|d|={errs[0]:.3e} dkv|d|={max(errs[1:]):.3e} (bound ratio {max(ratios):.3f})"
        f"{times} {'ok' if ok else 'FAIL'}")
    del q, k, v, bias, out, lse, g, g_lse, dq, dk, dv, ref
    torch.cuda.empty_cache()
    return row


def phase_lse_kernels():
    """B3 at the hop shape of the served SP request (L = 384, 4 shards, flat
    MSA<-pair cross: 8 (batch x heads) rows of 5 * 96 = 1,920 MSA queries
    against 96 * 384 = 36,864 pair keys, bf16), timed as the served request
    gives it (no row fully masked, so the bound counts work the kernel must
    do); the same shape with one (bh) row whose every key is masked, in f32
    and at a ragged length, untimed; the backward through lse at the L = 128
    hop shape (640 x 4,096), timed unmasked, and the same edges."""
    rows = [
        check_lse("hop L=384 P=4", 8, 1920, 36864, 64, torch.bfloat16, timed=True),
        check_lse("hop L=384 P=4 masked row", 8, 1920, 36864, 64, torch.bfloat16,
                  timed=False, masked_bh=(3,)),
        check_lse("hop L=128 P=4", 8, 640, 4096, 64, torch.bfloat16, timed=False,
                  masked_bh=(3,)),
        check_lse("hop L=128 P=4 f32", 8, 640, 4096, 64, torch.float32, timed=False,
                  masked_bh=(3,)),
        check_lse("ragged", 5, 131, 77, 64, torch.bfloat16, timed=False, masked_bh=(1,)),
        check_lse("ragged f32 dh 16", 5, 131, 77, 16, torch.float32, timed=False,
                  masked_bh=(1,)),
    ]
    bwd = [
        check_lse_bwd("hop L=128 P=4", 8, 640, 4096, 64, torch.bfloat16, timed=True),
        check_lse_bwd("hop L=128 P=4 masked row", 8, 640, 4096, 64, torch.bfloat16,
                      timed=False, masked_bh=(3,)),
        check_lse_bwd("hop L=128 P=4 f32", 8, 640, 4096, 64, torch.float32, timed=False,
                      masked_bh=(3,)),
        check_lse_bwd("ragged", 5, 131, 77, 64, torch.bfloat16, timed=False, masked_bh=(1,)),
        check_lse_bwd("ragged f32 dh 32", 5, 131, 77, 32, torch.float32, timed=False,
                      masked_bh=(1,)),
    ]
    if rows[0]["route"] != "wgmma" or rows[1]["route"] != "wgmma":
        fail("B3's forward at the served hop shape left the wgmma route")
    if any(r[key] != "wgmma" for r in bwd[:2] for key in ("dq_route", "dkv_route")):
        fail("B3's backward at the hop shape left the wgmma dq or dkv route")
    RECORD["lse_kernels"] = rows + bwd
    bad = [r for r in rows + bwd if not r["ok"]]
    if bad:
        fail(f"{len(bad)} B3 check(s) disagree with the plain version: "
             + ", ".join(f"{r['kernel']} {r['case']}" for r in bad))
    return rows, bwd


# --- phase 3, int8: the quant_matmul kernel against its plain version ---------------

# the served int8 request's dense layers at L = 384 (dim 256, 8 heads of 64,
# 20 MSA rows, GEGLU 4x): (m, k, n); the crosses reuse these shapes
QUANT_SHAPES = {
    "pair q": (147456, 256, 512),
    "pair kv": (147456, 256, 1024),
    "pair out": (147456, 512, 256),
    "pair ff in": (147456, 256, 2048),
    "pair ff out": (147456, 1024, 256),
    "msa q": (7680, 256, 512),
    "msa kv": (7680, 256, 1024),
    "msa out": (7680, 512, 256),
    "msa ff in": (7680, 256, 2048),
    "msa ff out": (7680, 1024, 256),
}


def check_quant(label, m, k, n, dtype, *, timed, per_tensor=False, misaligned=False):
    """quant_matmul on the card against quant_matmul_plain, elementwise
    within `quant_bound`; channel n // 2 is all zero (scale 0: exact
    zeros out). The row names the route the call took (`route`), and the
    launch must count under it. `misaligned`: x is a contiguous view
    starting 2 bytes past a 16-byte boundary (TMA cannot address it)."""
    g = torch.Generator(device="cuda").manual_seed(m + n)
    w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
    w[:, n // 2] = 0.0
    qw, scale = quant.quantize_weight(w, per_channel=not per_tensor)
    scale = scale.reshape(-1).expand(n).contiguous()
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    del w
    if misaligned:
        buf = torch.empty(m * k + 8, dtype=dtype, device="cuda")
        buf[1:1 + m * k] = x.reshape(-1)
        x = buf[1:1 + m * k].view(m, k)
    which = quant_kernel.route(x, qw)
    before = dict(quant_kernel.LAUNCHES)
    y = quant.quant_matmul(x, qw, scale)
    sync()
    counted = {name: n - before[name] for name, n in quant_kernel.LAUNCHES.items()}
    if counted != {name: int(name in ("quant_matmul", f"quant_matmul_{which}"))
                   for name in counted}:
        fail(f"quant_matmul did not count one launch on its {which} route: {counted}")
    ref = quant_kernel.quant_matmul_plain(x, qw, scale)
    bound = quant_bound(x, qw, scale, ref)
    diff = (y.float() - ref.float()).abs()
    ratio = torch.where(bound > 0, diff / bound, torch.where(diff > 0, math.inf, 0.0))
    err, worst = diff.max().item(), ratio.max().item()
    ok = worst <= 1.0 and bool(torch.isfinite(y).all()) and bool((y[:, n // 2] == 0).all())
    row = {"kernel": "quant_matmul", "case": label, "shape": [m, k, n], "dtype": str(dtype),
           "route": which, "max_abs_err": err, "bound_ratio": worst, "ok": bool(ok)}
    del bound, diff, ratio, ref
    if timed:
        el = x.element_size()
        t_ops = 2.0 * m * k * n / PEAK_FLOPS[dtype] * 1e3
        t_bytes = (m * k * el + k * n + 4 * n + m * n * el) / HBM_BYTES_PER_S * 1e3
        w_deq = quant.dequantize_weight(qw, scale).to(dtype)  # made beforehand
        row["kernel_ms"] = time_ms(lambda: quant_kernel.launch(x, qw, scale), 10)
        row["plain_ms"] = time_ms(lambda: quant_kernel.quant_matmul_plain(x, qw, scale), 3)
        row["library_ms"] = time_ms(lambda: torch.matmul(x, w_deq), 10)
        row["ops_ms"], row["bytes_ms"] = t_ops, t_bytes
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    times = "".join(f" {key}={row[key]:.3f}" for key in
                    ("kernel_ms", "plain_ms", "library_ms", "bound_ms") if key in row)
    log(f"[quant] {label:18s} {str((m, k, n)):22s} {str(dtype).split('.')[-1]:8s} "
        f"{which:8s} max|d|={err:.3e} (bound ratio {worst:.3f}){times} "
        f"{'ok' if ok else 'FAIL'}")
    del x, qw, scale, y
    torch.cuda.empty_cache()
    return row


def phase_quant_kernels():
    """B4 at the served int8 request's bf16 shapes (L = 384), which must
    take the wgmma route, and at edge cases: on the wgmma route a ragged m,
    n = 16 with one row, k = 1024 with a ragged m; on the cp_async route a
    ragged (m, k, n), a misaligned x and one row of n = 8; f32 and a
    per-tensor scale. Tolerance (`quant_bound`): k * 2^-24 * s * sum |x||q|
    per output, plus one bf16 ulp of the output in bf16."""
    rows = [check_quant(label, m, k, n, torch.bfloat16, timed=True)
            for label, (m, k, n) in QUANT_SHAPES.items()]
    served = [r for r in rows if r["route"] != "wgmma"]
    if served:
        fail("served shapes off the wgmma route: " + ", ".join(r["case"] for r in served))
    rows += [
        check_quant("ragged m", 1000, 256, 512, torch.bfloat16, timed=False),
        check_quant("n 16, one row", 1, 256, 16, torch.bfloat16, timed=False),
        check_quant("k 1024 ragged m", 1000, 1024, 256, torch.bfloat16, timed=False),
        check_quant("ragged", 1000, 200, 300, torch.bfloat16, timed=False),
        check_quant("misaligned x", 1000, 256, 512, torch.bfloat16, timed=False,
                    misaligned=True),
        check_quant("ragged f32", 1000, 200, 300, torch.float32, timed=False),
        check_quant("per-tensor scale", 1000, 200, 300, torch.bfloat16, timed=False,
                    per_tensor=True),
        check_quant("msa q f32", 7680, 256, 512, torch.float32, timed=False),
        check_quant("one row", 1, 256, 8, torch.bfloat16, timed=False),
    ]
    RECORD["quant_kernels"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} quant_matmul check(s) disagree with the plain version: "
             + ", ".join(r["case"] for r in bad))
    return rows


# --- phase 3, sparse: the block-sparse kernels against their plain versions ---------


def sparse_inputs(b, heads, n, dh, dtype, scfg, *, masked_b=(), seed=0):
    """Folded q, k, v, dO (b * heads, n, dh), a key bias (b, n) with 5% of
    the keys (and every key of the batch elements `masked_b`) masked, and
    the layout's table on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b * heads, n, dh, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    keep = torch.rand(b, n, generator=g, device="cuda") >= 0.05
    keep[:, 0] = True
    for i in masked_b:
        keep[i] = False
    bias = torch.where(keep, 0.0, float("-inf")).contiguous()
    table = sparse.kernel_table(n // scfg.block_size, scfg, "cuda")
    return q, k, v, do, bias, table


def sparse_bound_terms(q, bias, table, kind):
    """The floors of one sparse kernel, in ms, over the ACTIVE block pairs:
    operations 4 (forward), 6 (dq: S, dP, dQ) or 8 (dkv: S, dP, dK, dV)
    times BH * nnz * bs^2 * dh; bytes: each input read once (q, k, v, the
    bias, the table; dO, lse and delta in the backward), each output
    written once."""
    BH, n, dh = q.shape
    el = q.element_size()
    work = float(BH) * table.nnz * table.block_size ** 2 * dh
    fixed = bias.numel() * 4 + (table.idx.numel() + table.counts.numel()) * 4
    if kind == "fwd":
        ops = 4 * work
        nbytes = 4 * BH * n * dh * el + BH * n * 4 + fixed
    elif kind == "dq":
        ops = 6 * work
        nbytes = 5 * BH * n * dh * el + 2 * BH * n * 4 + fixed
    else:
        ops = 8 * work
        nbytes = 6 * BH * n * dh * el + 2 * BH * n * 4 + fixed
    return ops / PEAK_FLOPS[q.dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def check_sparse(label, b, heads, n, dh, dtype, scfg, *, timed, masked_b=()):
    """B5f, B5 dq and B5 dkv on the card against sparse_fwd_plain and
    sparse_bwd_plain, each on the route `sparse_kernel.route` /
    `bwd_route` picks and, where that is wgmma, on the mma_sync route too,
    on the same inputs. Timed on the picked and the mma_sync routes, beside
    B1f's forward and the dense dkv kernel on the dense pass of the same
    shape (every key block active). Tolerances: the
    forward's are B1's (f32 1e-5 * max(1, max|ref|); bf16 one bf16 ulp of
    the largest output; lse 1e-4); the backward's f32 1e-5 * max(1,
    max|ref|) and bf16 `sparse_bwd_bf16_bound` (flash_bwd_bf16_bound of the
    dense attention the sparse one equals), the backward reading the
    route's lse. Batch elements `masked_b` give zeros in every output and
    lse = +inf."""
    q, k, v, do, bias, table = sparse_inputs(b, heads, n, dh, dtype, scfg, masked_b=masked_b)
    scale = dh ** -0.5
    args = (q, k, v, bias, table, heads)
    which = sparse_kernel.route(q, table)
    bwd_which = sparse_kernel.bwd_route(q, table)
    before = dict(sparse_kernel.LAUNCHES)
    out, lse = sparse_kernel.sparse_fwd(*args, scale)
    dq, dk, dv = sparse_kernel.sparse_bwd(*args, out, lse, do, scale)
    sync()
    counted = ("sparse_fwd", f"sparse_fwd_{which}", "sparse_bwd_dq", "sparse_bwd_dkv",
               f"sparse_bwd_dq_{bwd_which}", f"sparse_bwd_dkv_{bwd_which}")
    if any(sparse_kernel.LAUNCHES[name] - before[name] != int(name in counted) for name in before):
        fail(f"the sparse kernels did not count their launches ({which}, {bwd_which} routes)")
    ref_out, ref_lse = sparse_kernel.sparse_fwd_plain(*args, scale)
    ref_max = ref_out.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if dtype == torch.float32 else BF16_ULP * ref_max
    fin = torch.isfinite(ref_lse)

    def fwd_errors(got_out, got_lse):
        err = (got_out.float() - ref_out.float()).abs().max().item()
        lse_err = (got_lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
        good = (err <= tol and lse_err <= 1e-4 and bool(torch.isfinite(got_out).all())
                and torch.equal(torch.isposinf(got_lse), torch.isposinf(ref_lse)))
        return err, lse_err, good

    err, lse_err, ok = fwd_errors(out, lse)
    # on the wgmma route: the route it replaced, on the same call
    others = {"mma_sync": {"which": "mma_sync"}} if which == "wgmma" else {}
    other = {}
    for name, kw in others.items():
        e, le, good = fwd_errors(*sparse_kernel.sparse_fwd(*args, scale, **kw))
        other[name] = (e, le)
        ok = ok and good
    ref = sparse_kernel.sparse_bwd_plain(*args, out, lse, do, scale)
    if dtype == torch.float32:
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    else:
        bounds = sparse_bwd_bf16_bound(*args, out, lse, do, scale)
    delta = flash_kernel.cotangent_terms(out, do)[1]
    bwd = (q, k, v, bias, table, heads, lse, do, delta, scale)
    # on the wgmma routes: the backward route they replaced, on the same call
    grads = {bwd_which: (dq, dk, dv)}
    if bwd_which == "wgmma":
        grads["mma_sync"] = ((sparse_kernel.launch_dq(*bwd, which="mma_sync"),)
                             + sparse_kernel.launch_dkv(*bwd, which="mma_sync"))
    bwd_errs, ratios = {}, []
    for name, got_grads in grads.items():
        errs = []
        for got, want, bound in zip(got_grads, ref, bounds):
            diff = (got.float() - want.float()).abs()
            bound = torch.as_tensor(bound, device=diff.device)
            errs.append(diff.max().item())
            ratio = torch.where(bound > 0, diff / bound, torch.where(diff > 0, math.inf, 0.0))
            ratios.append(ratio.max().item())
            ok = ok and bool(torch.isfinite(got).all())
        bwd_errs[name] = errs
        for i in masked_b:
            rows = slice(i * heads, (i + 1) * heads)
            ok = ok and all(bool((t[rows] == 0).all()) for t in got_grads)
    ok = ok and all(r <= 1.0 for r in ratios)
    errs = bwd_errs[bwd_which]
    for i in masked_b:
        rows = slice(i * heads, (i + 1) * heads)
        ok = ok and bool((out[rows] == 0).all()) and bool(torch.isposinf(lse[rows]).all())
    del ref, bounds, grads
    row = {"case": label, "shape": [b * heads, n, dh], "block_size": scfg.block_size,
           "dtype": str(dtype), "active": table.nnz / table.n_blocks ** 2, "route": which,
           "fwd_err": err, "lse_err": lse_err,
           **{f"{name}_fwd_err": e for name, (e, _) in other.items()},
           **{f"{name}_lse_err": le for name, (_, le) in other.items()},
           "bwd_route": bwd_which, "dq_err": errs[0], "dkv_err": max(errs[1:]),
           **{f"{name}_dq_err": e[0] for name, e in bwd_errs.items() if name != bwd_which},
           **{f"{name}_dkv_err": max(e[1:]) for name, e in bwd_errs.items() if name != bwd_which},
           "bound_ratio": max(ratios), "ok": bool(ok)}
    if timed:
        reps = 10
        row["fwd_ms"] = time_ms(lambda: sparse_kernel.sparse_fwd(*args, scale), reps)
        for name, kw in others.items():
            row[f"fwd_{name}_ms"] = time_ms(
                lambda kw=kw: sparse_kernel.sparse_fwd(*args, scale, **kw), reps)
        if which == "wgmma":
            # B1f and the dense dkv kernel on the dense pass of the same shape
            # (every key block active)
            dense_bias = bias[torch.arange(b * heads, device="cuda") // heads].contiguous()
            row["fwd_dense_b1f_ms"] = time_ms(
                lambda: flash_kernel.flash_fwd(q, k, v, dense_bias, scale), reps)
            dense_lse = flash_kernel.flash_fwd(q, k, v, dense_bias, scale)[1]
            row["dkv_dense_ms"] = time_ms(lambda: flash_kernel.launch_dkv(
                q, k, v, dense_bias, dense_lse, do, delta, scale, "flash_bwd_dkv"), reps)
            del dense_bias, dense_lse
        row["dq_ms"] = time_ms(lambda: sparse_kernel.launch_dq(*bwd), reps)
        row["dkv_ms"] = time_ms(lambda: sparse_kernel.launch_dkv(*bwd), reps)
        if bwd_which == "wgmma":
            row["dq_mma_sync_ms"] = time_ms(
                lambda: sparse_kernel.launch_dq(*bwd, which="mma_sync"), reps)
            row["dkv_mma_sync_ms"] = time_ms(
                lambda: sparse_kernel.launch_dkv(*bwd, which="mma_sync"), reps)
        row["fwd_plain_ms"] = time_ms(lambda: sparse_kernel.sparse_fwd_plain(*args, scale), 2)
        row["dq_plain_ms"] = time_ms(lambda: sparse_kernel.sparse_bwd_dq_plain(*bwd), 2)
        row["dkv_plain_ms"] = time_ms(lambda: sparse_kernel.sparse_bwd_dkv_plain(*bwd), 2)
        # the boolean mask that expands the block layout and the key mask
        mask = torch.isfinite(sparse_dense_bias(bias, table, heads))[None]
        row["fwd_library_ms"] = sdpa_mask_ms(q, k, v, mask, scale, reps)
        row["dq_library_ms"] = sdpa_mask_ms(q, k, v, mask, scale, reps, do, "q")
        row["dkv_library_ms"] = sdpa_mask_ms(q, k, v, mask, scale, reps, do, "kv")
        del mask
        for kind in ("fwd", "dq", "dkv"):
            t_ops, t_bytes = sparse_bound_terms(q, bias, table, kind)
            row[f"{kind}_ops_ms"], row[f"{kind}_bytes_ms"] = t_ops, t_bytes
            row[f"{kind}_bound_ms"] = max(t_ops, t_bytes)
    times = "".join(f" {key}={row[key]:.3f}" for key in
                    ("fwd_ms", "fwd_mma_sync_ms",
                     "fwd_dense_b1f_ms", "dq_ms", "dq_mma_sync_ms", "dkv_ms", "dkv_mma_sync_ms",
                     "dkv_dense_ms", "fwd_plain_ms", "fwd_library_ms", "dq_library_ms",
                     "dkv_library_ms", "fwd_bound_ms", "dq_bound_ms", "dkv_bound_ms")
                    if row.get(key) is not None)
    sync_err = "".join(f" {name} fwd|d|={e:.2e} lse|d|={le:.1e}"
                       for name, (e, le) in other.items())
    sync_err += "".join(f" {name} dq|d|={e[0]:.2e} dkv|d|={max(e[1:]):.2e}"
                        for name, e in bwd_errs.items() if name != bwd_which)
    log(f"[sparse] {label:20s} {str(tuple(row['shape'])):18s} bs {scfg.block_size:3d} "
        f"{str(dtype).split('.')[-1]:8s} active {row['active']:.2f} {which}/{bwd_which} "
        f"fwd|d|={err:.2e} (tol {tol:.2e}) lse|d|={lse_err:.1e} dq|d|={errs[0]:.2e} "
        f"dkv|d|={max(errs[1:]):.2e}{sync_err} (bound ratio {max(ratios):.3f}){times} "
        f"{'ok' if ok else 'FAIL'}")
    del q, k, v, do, bias, out, lse, dq, dk, dv, delta, bwd
    torch.cuda.empty_cache()
    return row


def check_sparse_apply(label, n, dtype):
    """`sparse_attention_apply` at a ragged length (the wrapper pads to a
    block multiple, then unpads) through the kernels on the card against
    the same call on CPU copies, which runs the gather version
    (`block_sparse_attention`), one batch element fully masked: f32, 1e-5 *
    max(1, max|ref|)."""
    cfg = AttentionConfig(dim=64, heads=2, dim_head=32, dtype=dtype)
    params = attention_init(torch.Generator().manual_seed(1), cfg, "cuda")
    scfg = sparse.SparseConfig(block_size=16, max_seq_len=256)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(3, n, 64, generator=g, device="cuda")
    mask = torch.rand(3, n, generator=g, device="cuda") >= 0.1
    mask[1] = False
    before = sparse_kernel.LAUNCHES["sparse_fwd"]
    got = sparse.sparse_attention_apply(params, cfg, scfg, x, mask=mask)
    sync()
    launched = sparse_kernel.LAUNCHES["sparse_fwd"] - before
    cpu_params = {name: {key: t.cpu() for key, t in d.items()} for name, d in params.items()}
    want = sparse.sparse_attention_apply(cpu_params, cfg, scfg, x.cpu(), mask=mask.cpu())
    err = (got.cpu().float() - want.float()).abs().max().item()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    ok = launched == 1 and err <= tol and got.shape == (3, n, 64)
    log(f"[sparse] {label:20s} apply n={n} (padded to {-(-n // 16) * 16}) "
        f"{str(dtype).split('.')[-1]:8s} |d|={err:.2e} (tol {tol:.2e}), {launched} launch "
        f"{'ok' if ok else 'FAIL'}")
    return {"case": label, "n": n, "dtype": str(dtype), "apply_err": err, "ok": bool(ok)}


def phase_sparse_kernels():
    """B5 at the sparse request's pair-axial shape (L = 384, max_seq_len
    384: nr = 6, 56% of blocks active), at a genuinely sparse long length
    (n = 4096, the default max_seq_len 2048: 25% active; BH = 8 so the
    gather plain version fits), and at the edges: block sizes 32, 64, 128,
    head widths 16 and 32, fully masked batch elements, f32, and a ragged
    length through the wrapper."""
    served = sparse.SparseConfig(block_size=16, max_seq_len=384)
    trained = sparse.SparseConfig(block_size=16, max_seq_len=256)
    long = sparse.SparseConfig(block_size=16, max_seq_len=2048)
    rows = [
        check_sparse("pair axial L=384", 384, 8, 384, 64, torch.bfloat16, served, timed=True),
        check_sparse("long n=4096", 1, 8, 4096, 64, torch.bfloat16, long, timed=True),
        check_sparse("pair axial crop 256", 256, 8, 256, 64, torch.bfloat16, trained,
                     timed=True),
        # n = 1024 at BH 6, one batch element masked
        check_sparse("masked element n=1024", 3, 2, 1024, 64, torch.bfloat16,
                     sparse.SparseConfig(block_size=16, max_seq_len=512), timed=False,
                     masked_b=(1,)),
        # 25 blocks: a ragged last key tile, query stage and query tile
        check_sparse("ragged n=400", 3, 2, 400, 64, torch.bfloat16,
                     sparse.SparseConfig(block_size=16, max_seq_len=512), timed=False,
                     masked_b=(1,)),
    ]
    off = [f"{r['case']} ({r['route']}, {r['bwd_route']})" for r in rows
           if "wgmma" != r["route"] or "wgmma" != r["bwd_route"]]
    if off:
        fail("bf16 dh 64 bs 16 rows of B5f, B5 dq or B5 dkv off the wgmma route: "
             + ", ".join(off))
    edges = [
        ("bs 32", 4, 2, 384, 64, torch.bfloat16, 32, 384, (1,)),
        ("bs 64", 4, 2, 512, 64, torch.bfloat16, 64, 512, ()),
        ("bs 128", 2, 2, 1024, 64, torch.bfloat16, 128, 1024, (1,)),
        ("dh 16 masked", 4, 4, 384, 16, torch.bfloat16, 16, 384, (1, 3)),
        ("dh 32", 4, 4, 384, 32, torch.bfloat16, 16, 384, ()),
        ("f32", 4, 2, 384, 64, torch.float32, 16, 384, (2,)),
        ("f32 bs 128 dh 32", 2, 2, 512, 32, torch.float32, 128, 512, (1,)),
        ("f32 bs 32 dh 16", 3, 2, 256, 16, torch.float32, 32, 256, ()),
    ]
    for label, b, heads, n, dh, dtype, bs, msl, masked in edges:
        scfg = sparse.SparseConfig(block_size=bs, max_seq_len=msl)
        rows.append(check_sparse(label, b, heads, n, dh, dtype, scfg, timed=False,
                                 masked_b=masked))
    rows.append(check_sparse_apply("ragged f32", 200, torch.float32))
    RECORD["sparse_kernels"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} sparse check(s) disagree with the plain versions: "
             + ", ".join(r["case"] for r in bad))
    return rows


# --- phase 4: the main path -------------------------------------------------------


def request_inputs(L, rows, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 20, (1, L)).astype(np.int32)
    msa = rng.integers(0, 21, (1, rows, L)).astype(np.int32)
    msa[0, 0] = tokens[0]
    msa_mask = rng.random((1, rows, L)) > 0.1
    msa_mask[0, 0] = True
    return tokens, msa, msa_mask


def pairwise(c):
    c = c.double()
    return torch.cdist(c, c)


def cpu_vs_card(label, cfg, L, expect, params=None):
    """One request at length L in float32 on the card and on the CPU with
    the same parameters (each side's tree through `resident_params`, so an
    int8 config quantizes on its own device, bit-equal): seeded, or the
    `params` pair (CPU tree, card tree) given. Tolerance: logits
    1e-4 (float32 kernels vs CPU matmuls in another summation order);
    confidence 1e-5; distances 1e-2 A and stress 1e-3 relative (200
    Guttman steps carry the logits' float noise). `expect`: the card's
    kernel launches (every other kernel 0)."""
    if params is None:
        params = tuple(alphafold2_init(cfg, torch.Generator().manual_seed(0), dev)
                       for dev in ("cpu", "cuda"))
    params_cpu, params_gpu = (resident_params(p, cfg)[0] for p in params)
    tokens, msa, msa_mask = request_inputs(L, 20, seed=1)
    kw = dict(msa=msa, msa_mask=msa_mask, mds_iters=200)
    reset_launches()
    gpu = predict_structure(params_gpu, cfg, tokens, device="cuda", **kw)
    sync()
    launches = launch_counts()
    cpu = predict_structure(params_cpu, cfg, tokens, device="cpu", **kw)
    g = {k: v.cpu() for k, v in gpu.items()}
    d_logits = (g["distogram_logits"] - cpu["distogram_logits"]).abs().max().item()
    d_conf = (g["confidence"] - cpu["confidence"]).abs().max().item()
    d_stress = ((g["stress"] - cpu["stress"]).abs() / cpu["stress"].abs()).max().item()
    d_dist = (pairwise(g["coords"]) - pairwise(cpu["coords"])).abs().max().item()
    ok = d_logits <= 1e-4 and d_conf <= 1e-5 and d_stress <= 1e-3 and d_dist <= 1e-2
    log(f"[main {label}] L={L} f32 card vs cpu: logits |d|={d_logits:.2e} (1e-4), "
        f"confidence |d|={d_conf:.2e} (1e-5), stress rel={d_stress:.2e} (1e-3), "
        f"distances |d|={d_dist:.2e} A (1e-2); launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"][f"cpu_vs_card_{label}"] = {
        "L": L, "config": repr(cfg), "logits": d_logits, "confidence": d_conf,
        "stress_rel": d_stress, "distances": d_dist, "launches": launches, "ok": ok,
    }
    if not ok:
        fail(f"the card and the CPU disagree on the L={L} request ({label})")
    want = {name: expect.get(name, 0) for name in launches}
    if launches != want:
        fail(f"card vs cpu {label}: launches {launches} != expected {want}")


def serve_requests(label, cfg, lengths, expect):
    """Drive predict_structure over one request per length on the tree
    `resident_params` serves for cfg (int8 configs quantize once); counts
    are set to 0 just before and read just after (`expect` names the
    kernels that launch; every other kernel must not). One untimed request
    first, so the first timed one does not pay the libraries' first-call
    set-up."""
    expect = {name: expect.get(name, 0) for name in launch_counts()}
    params, residency = resident_params(
        alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda"), cfg)
    reqs = [request_inputs(L, 20, seed=10 + n) for n, L in enumerate(lengths)]
    tokens, msa, msa_mask = reqs[0]
    predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask, mds_iters=200,
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launches()
    results = []
    for (tokens, msa, msa_mask), L in zip(reqs, lengths):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask,
                                mds_iters=200, device="cuda")
        end.record()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        shapes_ok = (tuple(out["coords"].shape) == (1, L, 3)
                     and tuple(out["distogram_logits"].shape) == (1, L, L, 37))
        results.append({"L": L, "device_ms": start.elapsed_time(end), "wall_ms": wall,
                        "stress": float(out["stress"][0]),
                        "confidence": float(out["confidence"].mean()),
                        "finite": finite, "shapes_ok": shapes_ok})
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in results:
        log(f"[main {label}] L={r['L']}: {r['device_ms']:.1f} ms (events), "
            f"{r['wall_ms']:.1f} ms (host), stress {r['stress']:.4f}, "
            f"mean confidence {r['confidence']:.4f}, finite={r['finite']}")
    log(f"[main {label}] launches {launches} (expected {expect}); peak memory {peak:.2f} GiB; "
        f"weights {residency['weight_dtype']} {residency['weight_bytes']:,} bytes resident "
        f"({residency['fp32_weight_bytes']:,} in f32)")
    RECORD["phases"][f"serve_{label}"] = {"requests": results, "launches": launches,
                                          "peak_gib": peak, "config": repr(cfg),
                                          "residency": residency}
    if not all(r["finite"] and r["shapes_ok"] for r in results):
        fail(f"main path {label}: non-finite outputs or wrong shapes")
    if launches != expect:
        fail(f"main path {label}: launches {launches} != expected {expect}")
    return launches


def phase_int8_vs_f32(cfg, L):
    """The served int8 config (bf16) on the card against the f32-weight
    model on the dequantized tree (the same weights, cast to bf16 per call):
    logits within 4 bf16 ulps of the largest logit (the bf16 bound of
    tests/test_torch_train.py: the int8 path multiplies bf16 activations by
    the exact int8 values and scales the f32 sum, the f32 path rounds each
    dequantized weight to bf16 first). Also, for information, the mean
    distogram KL of the int8 model from the f32 master weights."""
    f32_cfg = dataclasses.replace(cfg, weight_dtype="f32")
    master = alphafold2_init(f32_cfg, torch.Generator().manual_seed(0), "cuda")
    qtree, _ = resident_params(master, cfg)
    tokens, msa, msa_mask = request_inputs(L, 20, seed=3)
    with torch.inference_mode():
        run = lambda p, c: alphafold2_apply(p, c, tokens, msa, msa_mask=msa_mask,  # noqa: E731
                                            device="cuda").float()
        l8 = run(qtree, cfg)
        ldeq = run(quant.dequantize_tree(qtree), f32_cfg)
        l32 = run(master, f32_cfg)
    d = (l8 - ldeq).abs().max().item()
    bound = 4 * BF16_ULP * ldeq.abs().max().item()
    p32 = torch.log_softmax(l32, dim=-1)
    kl = (p32.exp() * (p32 - torch.log_softmax(l8, dim=-1))).sum(-1).mean().item()
    ok = d <= bound and bool(torch.isfinite(l8).all())
    log(f"[main f] int8 vs f32 on the dequantized tree, L={L} bf16: logits |d|={d:.4f} "
        f"(bound {bound:.4f}); mean distogram KL(f32 master || int8) = {kl:.3e} nats "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["int8_vs_f32"] = {"L": L, "logits": d, "bound": bound, "kl": kl, "ok": ok}
    if not ok:
        fail("the int8 model strays from the f32 model on its dequantized weights")


def phase_main():
    f32 = Alphafold2Config(dim=256, depth=2, heads=8, dim_head=64, max_seq_len=64)
    cpu_vs_card("a", f32, 64, {"flash_fwd": 12, "flash_fwd_f32": 12})
    cpu_vs_card("a int8", dataclasses.replace(f32, weight_dtype="int8"), 64,
                {"flash_fwd": 12, "flash_fwd_f32": 12, "quant_matmul": 44,
                 "quant_matmul_f32": 44})
    # max_seq_len 128: 75% of the 8 blocks active
    cpu_vs_card("a sparse", dataclasses.replace(f32, max_seq_len=128,
                                                sparse_self_attn=(True, False)), 128,
                {"flash_fwd": 10, "flash_fwd_f32": 10, "sparse_fwd": 2, "sparse_fwd_f32": 2})
    lengths = (128, 256, 384)
    cfg = Alphafold2Config(dim=256, depth=2, heads=8, dim_head=64, max_seq_len=384,
                           dtype=torch.bfloat16)
    # 6 attentions per layer reach the kernel: 2 pair axial, 2 MSA axial
    # (tied rows off), 2 cross; every served flash forward on the wgmma route
    flash = 6 * 2 * len(lengths)
    served = serve_requests("b", cfg, lengths, {"flash_fwd": flash, "flash_fwd_wgmma": flash})
    gated_cfg = dataclasses.replace(cfg, depth=1, attn_gate=True)
    gated = serve_requests("c", gated_cfg, lengths, {"flash_fwd_fused": flash // 2,
                                                     "flash_fwd_wgmma": flash // 2})
    # int8: 22 dense layers a trunk layer (6 pair axial, 6 MSA axial, 3 + 3
    # cross, 2 + 2 feed-forward), every one on the wgmma route; the
    # attention kernels unchanged
    int8_cfg = dataclasses.replace(cfg, weight_dtype="int8")
    int8 = serve_requests("d", int8_cfg, lengths,
                          {"flash_fwd": flash, "flash_fwd_wgmma": flash,
                           "quant_matmul": 22 * 2 * len(lengths),
                           "quant_matmul_wgmma": 22 * 2 * len(lengths)})
    # sparse layer 0: its 2 pair axial passes go sparse (every B5f launch on
    # the wgmma route), the other 10 stay flash
    sparse_cfg = dataclasses.replace(cfg, sparse_self_attn=(True, False))
    sparse_run = serve_requests("e", sparse_cfg, lengths,
                                {"flash_fwd": 10 * len(lengths), "flash_fwd_wgmma": 10 * len(lengths),
                                 "sparse_fwd": 2 * len(lengths),
                                 "sparse_fwd_wgmma": 2 * len(lengths)})
    phase_int8_vs_f32(int8_cfg, 128)
    return {"flash_fwd": served["flash_fwd"], "flash_fwd_fused": gated["flash_fwd_fused"],
            "quant_matmul_wgmma": int8["quant_matmul_wgmma"],
            "sparse_fwd": sparse_run["sparse_fwd"]}


# --- phase 8: the serving engine on the card --------------------------------------

ENGINE_BUCKETS = (128, 256, 384)
ENGINE_ROWS = 20  # MSA rows of every served request
# (label, config fields over the served config, the captured launches of one
# forward at L = 384: every flash forward and int8 product on its wgmma route)
ENGINE_ARMS = (
    ("f32 weights", {}, {"flash_fwd": 12, "flash_fwd_wgmma": 12}),
    ("gated", {"depth": 1, "attn_gate": True}, {"flash_fwd_fused": 6, "flash_fwd_wgmma": 6}),
    ("int8", {"weight_dtype": "int8"},
     {"flash_fwd": 12, "flash_fwd_wgmma": 12, "quant_matmul": 44, "quant_matmul_wgmma": 44}),
    ("sparse layer 0", {"sparse_self_attn": (True, False)},
     {"flash_fwd": 10, "flash_fwd_wgmma": 10, "sparse_fwd": 2, "sparse_fwd_wgmma": 2}),
)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def served_config(**fields):
    """The serving configuration (dim 256, depth 2, heads 8, dim_head 64,
    bf16) at max_seq_len 384, with `fields` over it."""
    return Alphafold2Config(**{**dict(dim=256, depth=2, heads=8, dim_head=64,
                                      max_seq_len=384, dtype=torch.bfloat16), **fields})


def engine_batch(lengths, bucket, seed, msa_rows=ENGINE_ROWS):
    """A padded batch as the engine assembles it, one seeded request a
    length with a 20-row MSA (`msa_rows` rows): tokens and mask (b, bucket),
    msa and msa_mask (b, msa_rows, bucket)."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 20, L).astype(np.int32) for L in lengths]
    tokens, mask, _ = pad_batch(rows, bucket, len(lengths))
    msa = np.full((len(lengths), msa_rows, bucket), PAD_TOKEN_ID, np.int32)
    msa_mask = np.zeros(msa.shape, bool)
    for i, (row, L) in enumerate(zip(rows, lengths)):
        msa[i, :, :L] = rng.integers(0, 21, (msa_rows, L))
        msa[i, 0, :L] = row
        msa_mask[i, :, :L] = rng.random((msa_rows, L)) > 0.1
        msa_mask[i, 0, :L] = True
    return tokens, mask, msa, msa_mask


def phase_engine_capture():
    """(a) Each arm's (bucket 384, batch 2) request captured
    (`serving/executable.py CapturedExecutable`: the forward and the
    distogram geometry in one graph, eigh eager, the MDS init and 200
    Guttman steps in a second graph), then replayed on a batch of two
    seeded requests (L = 384 and 300, 20-row MSAs) and held against eager
    `predict_structure` on the same padded inputs, bit for bit on coords,
    confidence, stress and logits; then replayed on a second batch and held
    again (the graphs' TMA descriptors and addresses must serve new
    inputs). The launches the capture recorded: every flash forward and
    int8 product on its wgmma route."""
    results = []
    for label, fields, expect in ENGINE_ARMS:
        cfg = served_config(**fields)
        params, _ = resident_params(
            alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda"), cfg)
        torch.cuda.reset_peak_memory_stats()
        exe = CapturedExecutable(params, cfg, batch=2, bucket=384, msa_rows=ENGINE_ROWS,
                                 mds_iters=200, device=torch.device("cuda", 0),
                                 pool=GraphPool())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {name: expect.get(name, 0) for name in launch_counts()}
        captured = {name: exe.launches.get(name, 0) for name in want}
        replays = []
        for seed in (41, 42):
            batch = engine_batch((384, 300), 384, seed)
            got = exe(*batch)
            got["distogram_logits"] = exe.logits.clone()
            ref = predict_structure(params, cfg, batch[0], mask=batch[1], msa=batch[2],
                                    msa_mask=batch[3], mds_iters=200, device="cuda")
            sync()
            diffs = {k: (got[k].float() - ref[k].float()).abs().max().item() for k in got}
            equal = all(torch.equal(got[k], ref[k]) for k in got)
            finite = all(bool(torch.isfinite(v).all()) for v in got.values())
            replays.append({"seed": seed, "bit_equal": equal, "max_abs_diff": diffs,
                            "finite": finite})
        ok = captured == want and all(r["bit_equal"] and r["finite"] for r in replays)
        log(f"[engine a] {label}: capture {exe.seconds:.2f} s, peak {peak:.2f} GiB; captured "
            f"vs eager bit-equal on two batches: {[r['bit_equal'] for r in replays]} "
            f"(max |d| {max(max(r['max_abs_diff'].values()) for r in replays):.2e}); captured "
            f"launches {dict((k, n) for k, n in captured.items() if n)} "
            f"{'ok' if ok else 'FAIL'}")
        results.append({"arm": label, "config": repr(cfg), "capture_s": exe.seconds,
                        "peak_gib": peak, "captured_launches": captured, "replays": replays,
                        "ok": ok})
        del exe
    RECORD["phases"]["engine_capture"] = results
    if not all(r["ok"] for r in results):
        fail("a captured request differs from the eager one, or left its wgmma route "
             "(phase 8a)")


def engine_request(L, rng):
    """One seeded request of L residues with a 20-row MSA (row 0 the query,
    10% of the other cells masked): (sequence, msa, msa_mask)."""
    tokens = rng.integers(0, 20, L)
    msa = rng.integers(0, 21, (ENGINE_ROWS, L)).astype(np.int32)
    msa[0] = tokens
    msa_mask = rng.random((ENGINE_ROWS, L)) > 0.1
    msa_mask[0] = True
    return "".join(AA_ORDER[t] for t in tokens), msa, msa_mask


def engine_stream(n=24, seed=60):
    """Phase 8b's stream: n seeded requests of 40-384 residues."""
    rng = np.random.default_rng(seed)
    return [engine_request(int(rng.integers(40, 385)), rng) for _ in range(n)]


def phase_engine_stream():
    """(b) The served config through `ServingEngine` on the card: buckets
    (128, 256, 384), max_batch 4 with the batch ladder (rungs 1, 2, 4),
    every (bucket, rung) captured at build (`precompile`); counts set to 0
    just before the build and read after the streams. A seeded stream of
    24 requests with lengths 40-384, each with a 20-row MSA, submitted at
    once, then the same stream again. Every request completes, finite and
    of its length; at most buckets x rungs captures; mean batch > 1; the
    second pass all cache hits. Throughput and p50/p95 latency of the
    first pass (host clock). Launches: the wrappers count the warm-ups and
    the captures; the engine reports what its replays launched (captured
    launches x replays), every flash forward on the wgmma route."""
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    scfg = ServingConfig(buckets=ENGINE_BUCKETS, max_batch=4, batch_ladder=True,
                         msa_rows=ENGINE_ROWS, mds_iters=200, request_timeout_s=600.0,
                         precompile=True)
    stream = engine_stream()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    engine = ServingEngine(params, cfg, scfg, device="cuda")
    build_s = time.perf_counter() - t0
    passes = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            reqs = [engine.submit(seq, msa=msa, msa_mask=mm) for seq, msa, mm in stream]
            results = [r.result(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
            lat = sorted(r.latency_s for r in results)
            passes.append({
                "wall_s": wall, "requests_per_s": len(results) / wall,
                "p50_s": lat[len(lat) // 2], "p95_s": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
                "from_cache": sum(r.from_cache for r in results),
                "ok": all(r.coords.shape == (len(seq), 3) and np.isfinite(r.coords).all()
                          and np.isfinite(r.confidence).all()
                          for r, (seq, _, _) in zip(results, stream)),
            })
    finally:
        engine.shutdown(drain=False)
    stats = engine.stats()
    wrappers = {k: n for k, n in launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    replayed = stats["launches"]
    routes_ok = (replayed.get("flash_fwd", 0) > 0
                 and replayed["flash_fwd"] == replayed.get("flash_fwd_wgmma", 0)
                 and not any(replayed.get(f"flash_fwd_{r}") for r in ("mma_sync", "f32")))
    rungs = len(stats["batch_shapes"])
    ok = (all(p["ok"] for p in passes) and stats["requests"]["failed"] == 0
          and stats["requests"]["completed"] == 2 * len(stream)
          and len(stats["captures"]) <= len(ENGINE_BUCKETS) * rungs
          and stats["batches"]["mean_requests_per_batch"] > 1
          and passes[1]["from_cache"] == len(stream) and routes_ok)
    for c in stats["captures"]:
        log(f"[engine b] bucket {c['bucket']} rung {c['batch']}: captured in "
            f"{c['seconds']:.2f} s, {c['replays']} replays")
    first = passes[0]
    log(f"[engine b] build (every capture) {build_s:.1f} s, peak memory {peak:.2f} GiB; pass 1: "
        f"{first['requests_per_s']:.2f} requests/s, latency p50 {first['p50_s'] * 1e3:.1f} ms "
        f"p95 {first['p95_s'] * 1e3:.1f} ms, mean batch "
        f"{stats['batches']['mean_requests_per_batch']:.2f}; pass 2: "
        f"{passes[1]['from_cache']} of {len(stream)} from the cache; replayed launches "
        f"{replayed}; wrapper counts (warm-ups and captures) {wrappers} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["engine_stream"] = {
        "build_s": build_s, "peak_gib": peak, "passes": passes, "captures": stats["captures"],
        "batches": stats["batches"], "requests": stats["requests"], "latency": stats["latency"],
        "replayed_launches": replayed, "wrapper_launches": wrappers, "ok": ok}
    if not ok:
        fail("the engine's stream failed its checks (phase 8b)")
    return replayed


def phase_engine():
    phase_engine_capture()
    replayed = phase_engine_stream()
    phase_engine_timing()
    return replayed


def profile_request(fn):
    """One call of fn under torch.profiler: the launches the host issued
    (kernel launch calls, graph launches, copies) and the device time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    out = {"kernel_launches": 0, "graph_launches": 0, "copies": 0, "device_ms": 0.0,
           "device_kernels": 0}
    for a in prof.key_averages():
        if getattr(a, "is_user_annotation", False):
            continue  # a record_function's device span: its kernels count on their own
        if a.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(a, "self_device_time_total", None)
            out["device_ms"] += (us if us is not None else a.self_cuda_time_total) / 1e3
            out["device_kernels"] += a.count
        elif a.key in LAUNCH_APIS:
            out["kernel_launches"] += a.count
        elif a.key == "cudaGraphLaunch":
            out["graph_launches"] += a.count
        elif a.key.startswith("cudaMemcpy"):
            out["copies"] += a.count
    return out


def stage_ms(exe, reps=3):
    """Mean ms (CUDA events) of a captured request's three stages on the
    inputs of its last call: graph one (forward, distogram geometry), the
    eager eigh, graph two (MDS init, Guttman steps)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    total = [0.0, 0.0, 0.0]
    with torch.inference_mode():
        for _ in range(reps):
            events[0].record()
            exe.graphs[0].replay()
            events[1].record()
            exe._eigh()
            events[2].record()
            exe.graphs[1].replay()
            events[3].record()
            sync()
            for i in range(3):
                total[i] += events[i].elapsed_time(events[i + 1]) / reps
    return total


def phase_engine_timing(reps=5):
    """(c) One request (batch 1, a 20-row MSA, 200 MDS iterations) of the
    served config at L = 128, 256 and 384, eager `predict_structure` against
    its captured executable, each ending with its outputs on the host:
    request ms on the host clock (mean of `reps`, the two in turns after a
    warm-up of each), then one more of each under torch.profiler: the
    launches the host issued and the device's busy share (kernel time over
    the unprofiled request time)."""
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    pool = GraphPool()
    rows = []
    for L in ENGINE_BUCKETS:
        exe = CapturedExecutable(params, cfg, batch=1, bucket=L, msa_rows=ENGINE_ROWS,
                                 mds_iters=200, device=torch.device("cuda", 0), pool=pool)
        tokens, mask, msa, msa_mask = engine_batch((L,), L, seed=50 + L)

        def eager():
            out = predict_structure(params, cfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                                    mds_iters=200, device="cuda")
            return {k: out[k].cpu() for k in ("coords", "confidence", "stress")}

        def captured():
            return {k: v.cpu() for k, v in exe(tokens, mask, msa, msa_mask).items()}

        ms = {"eager": [], "captured": []}
        eager(), captured()
        for order in [("eager", "captured"), ("captured", "eager")] * ((reps + 1) // 2):
            for name in order:
                t0 = time.perf_counter()
                (eager if name == "eager" else captured)()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        row = {"L": L, "capture_s": exe.seconds, "stages_ms": stage_ms(exe)}
        for name, fn in (("eager", eager), ("captured", captured)):
            mean = sum(ms[name][:reps]) / reps
            prof = profile_request(fn)
            row[name] = {"request_ms": mean, "runs_ms": ms[name][:reps], **prof,
                         "busy_share": prof["device_ms"] / mean if prof["device_kernels"]
                         else None}
        rows.append(row)
        e, c = row["eager"], row["captured"]
        busy = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
        log(f"[engine c] L={L}: eager {e['request_ms']:.2f} ms ({e['kernel_launches']} kernel "
            f"launches, {e['copies']} copies, busy {busy(e['busy_share'])}), captured "
            f"{c['request_ms']:.2f} ms ({c['kernel_launches']} kernel launches, "
            f"{c['graph_launches']} graph launches, {c['copies']} copies, busy "
            f"{busy(c['busy_share'])}); capture {exe.seconds:.2f} s; a captured request's "
            f"stages (events): graph one {row['stages_ms'][0]:.2f} ms, eigh "
            f"{row['stages_ms'][1]:.2f} ms, graph two {row['stages_ms'][2]:.2f} ms")
    RECORD["phases"]["engine_timing"] = rows
    return rows


# --- phase 6: the training path ---------------------------------------------------

# leaves the sequence-only distogram path does not read: the MSA stream's,
# the embedding projection's and the template tower's (their gradient is
# exactly 0, as in JAX)
UNREAD_ON_SEQUENCE_PATH = ("msa_pos_emb", "msa_num_pos_emb", "embedd_project",
                           "msa_attn", "seq_cross", "msa_cross", "msa_ff", "template_emb",
                           "template_pos_emb", "template_pos_emb_ax", "template_tower")


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from named_leaves(val, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for n, val in enumerate(tree):
            yield from named_leaves(val, f"{prefix}{n}.")
    else:
        yield prefix[:-1], tree


def phase_train_parity(label, cfg, L, expect):
    """The same params and batches on the card and the CPU, f32, at crop L.
    Tolerances: loss 1e-5 absolute and grad_norm 1e-5 relative (the same
    f32 function summed in another order: kernels vs CPU matmuls and the
    CPU's dense attention); each first-step gradient leaf 1e-4 of that
    leaf's largest entry (a leaf the path does not read must be exactly 0
    on both); params after 3 steps 1e-5, except entries of a read leaf
    whose first-step gradient is at most 1e-3 of the leaf's largest, which
    may differ by 2 * lr * 3: Adam normalises each entry's step to about lr
    whatever the gradient's size, so an entry whose gradient is rounding
    noise can step +lr on one side and -lr on the other. The count of such
    entries, and of entries past 1e-6, is recorded beside it. `expect`: each
    named kernel's launches over the 3 steps (every other kernel 0)."""
    tcfg = TrainConfig(grad_accum=2)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=5), 2)
    states = {dev: train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), dev)
              for dev in ("cuda", "cpu")}
    steps = {dev: make_train_step(cfg, tcfg, device=dev) for dev in states}
    card_vs_cpu_steps(f"train {label}", f"train_parity_{label}",
                      f"L={L} f32 depth {cfg.depth}", repr(cfg), states, steps, fetch, tcfg,
                      expect)


def card_vs_cpu_steps(tag, key, what, config, states, steps, fetch, tcfg, expect, *,
                      loss_tol=1e-5, norm_tol=1e-5, grad_tol=1e-4, params_tol=1e-5):
    """3 steps of `steps["cuda"]` and `steps["cpu"]` on their `states` (the
    same params) over the same batches, held at phase 6a's tolerances (the
    keyword arguments; `phase_train_parity`'s docstring); RECORD[phases][key]."""
    reset_launches()
    per_step, grad_ratio, small_grad = [], 0.0, []
    for n in range(3):
        batch = fetch(n)
        m = {dev: {k: float(v) for k, v in steps[dev](states[dev], batch)[1].items()}
             for dev in states}
        per_step.append({"loss": m["cuda"]["loss"], "loss_cpu": m["cpu"]["loss"],
                         "grad_norm": m["cuda"]["grad_norm"],
                         "grad_norm_cpu": m["cpu"]["grad_norm"]})
        if n == 0:  # no clipping: the leaves' .grad is the mean gradient
            for gl, cl in zip(states["cuda"]["optimizer"].leaves,
                              states["cpu"]["optimizer"].leaves):
                d = (gl.grad.cpu() - cl.grad).abs().max().item()
                scale_ = cl.grad.abs().max().item()
                # a leaf the path does not read (gradient 0 on both) is held tight
                small_grad.append(cl.grad.abs() <= 1e-3 * scale_ if scale_
                                  else torch.zeros_like(cl.grad, dtype=torch.bool))
                grad_ratio = max(grad_ratio, d / (grad_tol * scale_) if scale_ else
                                 (0.0 if d == 0 else float("inf")))
    sync()
    launches = launch_counts()
    d_params, d_noisy, past, n_noisy = 0.0, 0.0, 0, 0
    for gp, cp, noisy in zip(states["cuda"]["optimizer"].leaves,
                             states["cpu"]["optimizer"].leaves, small_grad):
        d = (gp.detach().cpu() - cp.detach()).abs()
        d_params = max(d_params, d[~noisy].max().item() if (~noisy).any() else 0.0)
        d_noisy = max(d_noisy, d[noisy].max().item() if noisy.any() else 0.0)
        past += int((d > 1e-6).sum())
        n_noisy += int(noisy.sum())
    d_loss = max(abs(r["loss"] - r["loss_cpu"]) for r in per_step)
    d_norm = max(abs(r["grad_norm"] - r["grad_norm_cpu"]) / r["grad_norm_cpu"] for r in per_step)
    noisy_tol = 2 * tcfg.learning_rate * 3
    ok = (d_loss <= loss_tol and d_norm <= norm_tol and grad_ratio <= 1.0
          and d_params <= params_tol and d_noisy <= noisy_tol)
    log(f"[{tag}] {what}, 3 steps, card vs cpu: loss |d|={d_loss:.2e} ({loss_tol:.0e}), "
        f"grad_norm rel={d_norm:.2e} ({norm_tol:.0e}), first-step grads worst/tol="
        f"{grad_ratio:.3f} (tol {grad_tol:.0e} of each leaf's largest), "
        f"params |d|={d_params:.2e} ({params_tol:.0e}; {past} entries past 1e-6), "
        f"{n_noisy} entries with a rounding-level gradient |d|={d_noisy:.2e} ({noisy_tol:.1e}); "
        f"losses {[round(r['loss'], 5) for r in per_step]}; launches "
        f"{dict((k, v) for k, v in launches.items() if v)} {'ok' if ok else 'FAIL'}")
    RECORD["phases"][key] = {"what": what, "config": config, "steps": per_step,
                             "grad_ratio": grad_ratio, "params_max_abs": d_params,
                             "params_past_1e-6": past, "small_grad_entries": n_noisy,
                             "small_grad_params_max_abs": d_noisy, "launches": launches,
                             "tolerances": [loss_tol, norm_tol, grad_tol, params_tol], "ok": ok}
    if not ok:
        fail(f"the card and the CPU disagree on the f32 training steps ({tag})")
    want = {name: expect.get(name, 0) for name in launches}
    if launches != want:
        fail(f"{tag}: launches over 3 steps {launches} != expected {want}")


def train_run(label, cfg, L, tcfg, timed_steps, expect):
    """Drive train_pre's step on the card as train_pre does, captured
    (`training/executable.py CapturedTrainStep`), at length L: the counts
    set to 0 and the peak memory reset just before the capture (its
    warm-up step launches each kernel once, the capture records it once),
    one untimed replay, then `timed_steps` timed ones (CUDA events).
    Checks a finite loss, a finite nonzero gradient on every leaf the path
    reads (exactly 0 on the others), and `expect` launches of each kernel
    per step in the replays (the capture's launches times the replays; 0
    of the rest). Returns the wrappers' counts of the run."""
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=7),
                                    tcfg.grad_accum)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step = CapturedTrainStep(cfg, tcfg, state, fetch(0))
    capture_s = next(iter(step.captures.values())).seconds
    step(state, fetch(0))
    sync()
    before = step.replayed_launches()
    times, metrics = [], []
    for n in range(1, timed_steps + 1):
        batch = fetch(n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, batch)
        end.record()
        sync()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = launch_counts()
    replayed = {k: n - before.get(k, 0) for k, n in step.replayed_launches().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad_leaves = []
    for name, leaf in named_leaves(state["params"]):
        g = leaf.grad
        unread = any(part in name.split(".") for part in UNREAD_ON_SEQUENCE_PATH)
        if unread and bool((g != 0).any()):
            bad_leaves.append(f"{name} (unread, nonzero)")
        if not unread and not (bool(torch.isfinite(g).all()) and g.abs().max().item() > 0):
            bad_leaves.append(name)
    step_ms = sorted(times)[len(times) // 2]
    flops = train_step_flops(cfg, L, 0, 0, grad_accum=tcfg.grad_accum) - sparse_skipped_flops(
        cfg, L, tcfg.grad_accum)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    per_step = {k: v / timed_steps for k, v in replayed.items()}
    row = {"L": L, "config": repr(cfg), "grad_accum": tcfg.grad_accum, "step_ms": times,
           "median_step_ms": step_ms, "train_step_flops": flops, "mfu": mfu,
           "capture_s": capture_s, "peak_gib": peak, "metrics": metrics,
           "wrapper_launches": launches, "replayed_launches": replayed,
           "bad_leaves": bad_leaves}
    log(f"[train {label}] L={L}, captured: step {step_ms:.2f} ms median of {timed_steps} "
        f"({', '.join(f'{t:.2f}' for t in times)}), MFU {mfu:.4f} of 989 TFLOP/s bf16 "
        f"({flops / 1e12:.3f} TFLOP a step), capture {capture_s:.2f} s, peak {peak:.2f} GiB, "
        f"loss {metrics[-1]['loss']:.4f}, grad_norm {metrics[-1]['grad_norm']:.4f}; "
        f"launches per step {per_step}")
    RECORD["phases"][f"train_{label}_L{L}"] = row
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics):
        fail(f"training {label} L={L}: a non-finite loss or grad_norm")
    if bad_leaves:
        fail(f"training {label} L={L}: zero or non-finite gradients on {bad_leaves[:5]}")
    for name in set(per_step) | set(expect):
        if per_step.get(name, 0) != expect.get(name, 0):
            fail(f"training {label} L={L}: {name} launched {per_step.get(name, 0)} times a "
                 f"step, expected {expect.get(name, 0)}")
    return launches


def sparse_skipped_flops(cfg, L, grad_accum):
    """The attention FLOPs a step's sparse layers skip, which
    `train_step_flops` (dense) counts: QK^T and PV over the inactive blocks
    of both pair axial passes, 3x for forward and backward."""
    n_sparse = sum(cfg.layer_sparse)
    if not n_sparse:
        return 0.0
    inactive = 1.0 - sparse.active_fraction(L, cfg.sparse_config())
    return grad_accum * 3.0 * n_sparse * 2 * 4.0 * L * L * L * cfg.heads * cfg.dim_head * inactive


def phase_train():
    # depth 1 keeps the script's length near its budget (the CPU side of
    # the parity runs dominates); 6g holds depth 2 captured against eager
    f32 = Alphafold2Config(dim=256, depth=1, heads=8, dim_head=64, max_seq_len=2048)
    three = 2 * f32.depth * 2 * 3  # two pair axial passes a layer, accum 2, 3 steps
    phase_train_parity("a", f32, 64, {name: three for name in
                                      ("flash_fwd", "flash_fwd_f32", "flash_bwd_dq",
                                       "flash_bwd_dq_f32", "flash_bwd_dkv",
                                       "flash_bwd_dkv_f32")})
    # max_seq_len 128: 75% of the 8 blocks active; every layer sparse
    phase_train_parity("a sparse", dataclasses.replace(f32, max_seq_len=128,
                                                       sparse_self_attn=True), 128,
                       {name: three for name in ("sparse_fwd", "sparse_fwd_f32", "sparse_bwd_dq",
                                                 "sparse_bwd_dkv", "sparse_bwd_dq_f32",
                                                 "sparse_bwd_dkv_f32")})
    tcfg = TrainConfig(grad_accum=16)
    cfg = train_pre_config()
    per = 2 * cfg.depth * tcfg.grad_accum  # two pair-axial attentions a layer
    # every bf16 dq and dkv launch on the wgmma route
    plain = {"flash_fwd": per, "flash_fwd_wgmma": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
             "flash_bwd_dq_wgmma": per, "flash_bwd_dkv_wgmma": per}
    launches = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for L in (128, 256):
        counts = train_run("b", cfg, L, tcfg, 5, plain)
        for name in launches:
            launches[name] += counts[name]
    gated = train_run("c", dataclasses.replace(cfg, attn_gate=True), 128, tcfg, 2,
                      {"flash_fwd_fused": per, "flash_fwd_wgmma": per, "flash_bwd_fused_dq": per,
                       "flash_bwd_fused_dkv": per, "flash_bwd_dq_wgmma": per,
                       "flash_bwd_dkv_wgmma": per})
    # train_pre's defaults, sparse, at crop 256 with max_seq_len 256: 66% of
    # the 16 blocks active (train_pre's own 2048 would make every block
    # active); every B5f, B5 dq and B5 dkv launch on the wgmma route
    sparse_run = train_run("e", dataclasses.replace(cfg, sparse_self_attn=True, max_seq_len=256),
                           256, tcfg, 3, {"sparse_fwd": per, "sparse_fwd_wgmma": per,
                                          "sparse_bwd_dq": per, "sparse_bwd_dkv": per,
                                          "sparse_bwd_dq_wgmma": per,
                                          "sparse_bwd_dkv_wgmma": per})
    int8_cfg = dataclasses.replace(cfg, weight_dtype="int8")
    try:
        make_train_step(int8_cfg, tcfg, device="cuda")
    except ValueError as e:
        log(f"[train f] make_train_step on an int8 config raises: {str(e)[:80]}... ok")
    else:
        fail("make_train_step accepted an int8 config")
    phase_overfit()
    phase_train_capture()
    phase_train_timing()
    phase_train_remat()
    phase_train_cli()
    # the backward kernels' launches on the training path (the forwards'
    # are the serving path's, phase 4)
    return dict(launches, flash_bwd_fused_dq=gated["flash_bwd_fused_dq"],
                flash_bwd_fused_dkv=gated["flash_bwd_fused_dkv"],
                sparse_bwd_dq=sparse_run["sparse_bwd_dq"],
                sparse_bwd_dkv=sparse_run["sparse_bwd_dkv"])


def phase_overfit():
    """(d) 30 captured steps on one repeated batch at lr 1e-3 lower the loss
    by more than 0.3 (the JAX package's tests/test_training.py
    criterion)."""
    cfg = train_pre_config()
    tcfg = TrainConfig(learning_rate=1e-3, grad_accum=2)
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    batch = synthetic_microbatch_fn(DataConfig(batch_size=2, max_len=64, seed=3), 2)(0)
    step = CapturedTrainStep(cfg, tcfg, state, batch)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(30)]
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] - 0.3
    log(f"[train d] overfit one batch, 30 steps at lr 1e-3: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["overfit"] = {"losses": losses, "ok": ok}
    if not ok:
        fail(f"30 steps on one batch did not lower the loss by 0.3: {losses}")


# the six route families of the trained kernels: (launches of the family's
# wrappers, the wgmma route's own count)
ROUTE_FAMILIES = (
    (("flash_fwd", "flash_fwd_fused"), "flash_fwd_wgmma"),
    (("flash_bwd_dq", "flash_bwd_fused_dq"), "flash_bwd_dq_wgmma"),
    (("flash_bwd_dkv", "flash_bwd_fused_dkv"), "flash_bwd_dkv_wgmma"),
    (("sparse_fwd",), "sparse_fwd_wgmma"),
    (("sparse_bwd_dq",), "sparse_bwd_dq_wgmma"),
    (("sparse_bwd_dkv",), "sparse_bwd_dkv_wgmma"),
)


def on_wgmma(launches):
    """Every flash and sparse launch in `launches` on its wgmma route (and
    at least one launch)."""
    total = 0
    for names, wgmma in ROUTE_FAMILIES:
        n = sum(launches.get(k, 0) for k in names)
        if launches.get(wgmma, 0) != n:
            return False
        total += n
    return total > 0


def train_pre_config(**fields):
    """train_pre's defaults (dim 256, depth 1, heads 8, dim_head 64) in
    bf16, with `fields` over them."""
    return Alphafold2Config(**{**dict(dim=256, depth=1, heads=8, dim_head=64, max_seq_len=2048,
                                      dtype=torch.bfloat16), **fields})


def capture_vs_eager(label, cfg, L, grad_accum, wgmma, msa_rows=0, batches=None, rngs=None, *,
                     sp_mesh=None, tag="train g"):
    """Train_pre's step captured (`CapturedTrainStep`) against the eager
    step (`make_train_step`) from the same seeded params over the same 3
    batches at crop L (with a `msa_rows`-row MSA when nonzero; or over
    `batches`, whose shapes the capture meets in turn, each captured at its
    first batch), with a warmup from lr 0, cosine decay, clipping that acts
    and weight decay: loss and grad_norm every step and every param leaf,
    AdamW moment and count at the end bit for bit (no tolerance: the same
    ops on the same buffers). `rngs`: each step's dropout seed (both arms
    get a CPU generator seeded with it; None: no rng). `wgmma`: every flash
    and sparse launch each capture recorded on its wgmma route. `sp_mesh`:
    the sequence-parallel step over that mesh (`make_sp_train_step`
    against `CapturedTrainStep(..., loss_fn=sp_distogram_loss_fn(mesh))`).
    Returns (the captured step, its state, the last batch)."""
    tcfg = TrainConfig(grad_accum=grad_accum, warmup_steps=1, decay_steps=3, decay_floor=0.1,
                       max_grad_norm=0.05, weight_decay=0.01)
    if batches is None:
        fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=9,
                                                   msa_rows=msa_rows), grad_accum)
        batches = [fetch(n) for n in range(3)]
    eager_state, cap_state = (train_state_init(cfg, tcfg, torch.Generator().manual_seed(0),
                                               "cuda") for _ in range(2))
    if sp_mesh is None:
        eager, loss_fn = make_train_step(cfg, tcfg, device="cuda"), distogram_loss_fn
    else:
        eager, loss_fn = make_sp_train_step(cfg, tcfg, sp_mesh), sp_distogram_loss_fn(sp_mesh)
    reset_launches()
    captured = CapturedTrainStep(cfg, tcfg, cap_state, batches[0], loss_fn=loss_fn)
    capture = next(iter(captured.captures.values()))
    steps = []
    for n, batch in enumerate(batches):
        rng = (lambda: None) if rngs is None else (
            lambda: torch.Generator().manual_seed(rngs[n]))
        _, e = eager(eager_state, batch, rng())
        _, c = captured(cap_state, batch, rng())
        steps.append({"loss": float(c["loss"]), "grad_norm": float(c["grad_norm"]),
                      "loss_equal": torch.equal(e["loss"], c["loss"]),
                      "grad_norm_equal": torch.equal(e["grad_norm"], c["grad_norm"]),
                      "loss_diff": abs(float(e["loss"]) - float(c["loss"]))})
    pairs = list(zip(eager_state["optimizer"].state_tensors(),
                     cap_state["optimizer"].state_tensors()))
    unequal = sum(not torch.equal(a, b) for a, b in pairs)
    d_params = max((a.detach() - b.detach()).abs().max().item() for a, b in pairs)
    captures = list(captured.captures.values())
    routes = all(on_wgmma(c.launches) for c in captures) if wgmma else None
    ok = (all(r["loss_equal"] and r["grad_norm_equal"] for r in steps) and unequal == 0
          and cap_state["step"] == len(batches) and routes is not False)
    log(f"[{tag}] {label}: L={L}, accum {grad_accum}, captured vs eager over {len(batches)} "
        f"steps: loss and grad_norm bit-equal "
        f"{[r['loss_equal'] and r['grad_norm_equal'] for r in steps]}, "
        f"{unequal} of {len(pairs)} params, moments and counts differ (max |d| "
        f"{d_params:.2e}); {len(captures)} captures; losses "
        f"{[round(r['loss'], 5) for r in steps]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in steps]}; capture {capture.seconds:.2f} s, "
        f"captured launches {capture.launches}"
        f"{'' if routes is None else ', all on wgmma' if routes else ', OFF wgmma'} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"][f"train_capture_{label}"] = {
        "L": L, "config": repr(cfg), "grad_accum": grad_accum, "steps": steps,
        "params_unequal": unequal, "params_max_abs": d_params,
        "capture_s": [c.seconds for c in captures],
        "captured_launches": [c.launches for c in captures], "on_wgmma": routes, "ok": ok}
    if not ok:
        fail(f"the captured train step differs from the eager one, or left its wgmma route "
             f"({label}, {tag})")
    return captured, cap_state, batches[-1]


def phase_train_capture():
    """(g) captured against eager, bit for bit: f32 depth 2 at L = 64 (accum
    2), train_pre's bf16 defaults at L = 128 dense and at L = 256 sparse
    (max_seq_len 256), and at L = 128 with remat and remat_policy "dots"."""
    f32 = Alphafold2Config(dim=256, depth=2, heads=8, dim_head=64, max_seq_len=2048)
    capture_vs_eager("f32", f32, 64, 2, wgmma=False)
    capture_vs_eager("bf16 dense", train_pre_config(), 128, 16, wgmma=True)
    capture_vs_eager("bf16 sparse", train_pre_config(sparse_self_attn=True, max_seq_len=256),
                     256, 16, wgmma=True)
    capture_vs_eager("bf16 remat dots", train_pre_config(remat=True, remat_policy="dots"), 128,
                     16, wgmma=True)


def host_ms(fn):
    """Host clock around one call, from a synchronized card to its end."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def phase_train_timing(reps=5):
    """(h) train_pre's bf16 step (accum 16), eager against captured, at crop
    128, crop 128 gated and crop 256: each arm from its own seeded state
    on one repeated batch; each arm's peak memory above what was allocated
    before its state was made (its state, then one step for the eager
    arm, its capture and one replay for the captured one); step ms on the host
    clock (synchronized, median of `reps`, the two arms in turns after a
    warm-up of each); then one more step of each under torch.profiler: the
    launches the host issued and the device time, busy = device ms over
    the step's median."""
    rows = []
    for label, cfg, L in (("crop 128", train_pre_config(), 128),
                          ("crop 128 gated", train_pre_config(attn_gate=True), 128),
                          ("crop 256", train_pre_config(), 256)):
        tcfg = TrainConfig(grad_accum=16)
        batch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=11), 16)(0)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eager_state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
        eager = make_train_step(cfg, tcfg, device="cuda")
        eager(eager_state, batch)
        sync()
        eager_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cap_state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
        captured = CapturedTrainStep(cfg, tcfg, cap_state, batch)
        captured(cap_state, batch)
        sync()
        cap_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        arms = {"eager": lambda: eager(eager_state, batch),
                "captured": lambda: captured(cap_state, batch)}
        ms = {"eager": [], "captured": []}
        for order in [("eager", "captured"), ("captured", "eager")] * ((reps + 1) // 2):
            for name in order:
                ms[name].append(host_ms(arms[name]))
        row = {"label": label, "L": L, "config": repr(cfg),
               "capture_s": next(iter(captured.captures.values())).seconds}
        for name, peak in (("eager", eager_peak), ("captured", cap_peak)):
            median = sorted(ms[name][:reps])[reps // 2]
            prof = profile_request(arms[name])
            row[name] = {"step_ms": median, "runs_ms": ms[name][:reps], "peak_gib": peak,
                         **prof, "busy_share": prof["device_ms"] / median
                         if prof["device_kernels"] else None}
        rows.append(row)
        e, c = row["eager"], row["captured"]
        busy = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
        log(f"[train h] {label}: eager {e['step_ms']:.2f} ms ({e['kernel_launches']} kernel "
            f"launches, {e['copies']} copies, device {e['device_ms']:.2f} ms, busy "
            f"{busy(e['busy_share'])}, peak {e['peak_gib']:.2f} GiB), captured "
            f"{c['step_ms']:.2f} ms ({c['kernel_launches']} kernel launches, "
            f"{c['graph_launches']} graph launches, {c['copies']} copies, device "
            f"{c['device_ms']:.2f} ms, busy {busy(c['busy_share'])}, peak {c['peak_gib']:.2f} "
            f"GiB); capture {row['capture_s']:.2f} s")
        del eager_state, cap_state, captured, arms
    RECORD["phases"]["train_timing"] = rows


def phase_train_remat(steps=3):
    """(i) train_pre's bf16 step at crop 256, captured, under no remat,
    remat, remat_policy "dots" and "dots_no_batch": peak memory over the
    capture and the steps, step ms (CUDA events, median of `steps` after
    one untimed replay)."""
    rows = []
    tcfg = TrainConfig(grad_accum=16)
    batch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=256, seed=12), 16)(0)
    for label, fields in (("no remat", {}), ("remat", {"remat": True}),
                          ("dots", {"remat": True, "remat_policy": "dots"}),
                          ("dots_no_batch", {"remat": True, "remat_policy": "dots_no_batch"})):
        cfg = train_pre_config(**fields)
        state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
        sync()
        torch.cuda.reset_peak_memory_stats()
        step = CapturedTrainStep(cfg, tcfg, state, batch)
        step(state, batch)
        times = []
        for _ in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _, m = step(state, batch)
            end.record()
            sync()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        row = {"label": label, "config": repr(cfg), "step_ms": times,
               "median_step_ms": sorted(times)[steps // 2], "peak_gib": peak,
               "capture_s": next(iter(step.captures.values())).seconds,
               "loss": float(m["loss"])}
        rows.append(row)
        log(f"[train i] crop 256 captured, {label}: step {row['median_step_ms']:.2f} ms median "
            f"of {steps}, peak {peak:.3f} GiB, capture {row['capture_s']:.2f} s, loss "
            f"{row['loss']:.4f}")
        if not math.isfinite(row["loss"]):
            fail(f"training crop 256 {label}: a non-finite loss (phase 6i)")
        del state, step
    RECORD["phases"]["train_remat"] = rows


def phase_train_cli():
    """(j) `python -m alphafold2_tpu_torch.train_pre --steps 3 --bf16` in a
    process of its own: it captures the step and runs 3 replays."""
    cmd = [sys.executable, "-m", "alphafold2_tpu_torch.train_pre", "--steps", "3", "--bf16"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    losses = [float(line.split("loss")[1].split()[0]) for line in lines
              if line.startswith("step ")]
    ok = (out.returncode == 0 and any("captured the step as a CUDA graph" in line
                                      for line in lines)
          and lines[-1:] == ["done"] and len(losses) == 2
          and all(math.isfinite(x) for x in losses))
    log(f"[train j] {' '.join(cmd[1:])}: rc {out.returncode} in {seconds:.1f} s; "
        + " | ".join(lines) + f" {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["train_cli"] = {"cmd": cmd[1:], "rc": out.returncode, "stdout": lines,
                                     "stderr_tail": out.stderr[-2000:], "seconds": seconds,
                                     "ok": ok}
    if not ok:
        fail(f"train_pre on the card did not run its captured step (phase 6j): "
             f"{out.stderr[-1000:]}")


# --- phase 7: sequence-parallel serving -------------------------------------------


def sp_apply(mesh, schedule="sp_seq"):
    return functools.partial(alphafold2_apply_sp, mesh=mesh, schedule=schedule)


def phase_sp_parity():
    """(a) f32, dim 64, depth 2, 4 heads of 16, an 8-row MSA, L = 64, the
    last 5 residues padded: alphafold2_apply_sp over 4 shards on the card
    (["cuda:0"] * 4) against the same over 4 CPU shards on the same params,
    and against the port's dense alphafold2_apply on the card, for "sp_seq"
    and "sp_msa", flat and aligned. Tolerance: logits 1e-4 on valid pairs
    (section 2's request tolerance: f32 kernels against CPU matmuls and the
    CPU's dense attention, another summation order)."""
    L, rows = 64, 8
    mesh_gpu = make_mesh({"seq": 4}, devices=["cuda:0"] * 4)
    mesh_cpu = make_mesh({"seq": 4}, devices=["cpu"] * 4)
    tokens, msa, msa_mask = request_inputs(L, rows, seed=21)
    mask = np.ones((1, L), bool)
    mask[:, -5:] = False
    valid = torch.from_numpy(mask[:, :, None] & mask[:, None, :])
    results = []
    for mode in ("flat", "aligned"):
        cfg = Alphafold2Config(dim=64, depth=2, heads=4, dim_head=16, max_seq_len=L,
                               max_num_msa=rows, cross_attn_mode=mode)
        params = {dev: alphafold2_init(cfg, torch.Generator().manual_seed(0), dev)
                  for dev in ("cuda", "cpu")}
        with torch.inference_mode():
            dense = alphafold2_apply(params["cuda"], cfg, tokens, msa, mask=mask,
                                     msa_mask=msa_mask, device="cuda").cpu()
            for schedule in ("sp_seq", "sp_msa"):
                reset_launches()
                card = sp_apply(mesh_gpu, schedule)(params["cuda"], cfg, tokens, msa,
                                                    mask=mask, msa_mask=msa_mask)
                sync()
                launches = {k: n for k, n in launch_counts().items() if n}
                cpu = sp_apply(mesh_cpu, schedule)(params["cpu"], cfg, tokens, msa,
                                                   mask=mask, msa_mask=msa_mask)
                card = card.cpu()
                d_cpu = (card - cpu).abs()[valid].max().item()
                d_dense = (card - dense).abs()[valid].max().item()
                ok = (d_cpu <= 1e-4 and d_dense <= 1e-4 and bool(torch.isfinite(card).all())
                      and card.device.type == "cpu" and tuple(card.shape) == (1, L, L, 37))
                # sp_seq: every trunk layer's MSA<-pair ring, P^2 = 16 hops
                if schedule == "sp_seq":
                    ok = ok and launches.get("flash_fwd_lse", 0) == 16 * cfg.depth
                log(f"[sp a] {mode:7s} {schedule}: card vs cpu logits |d|={d_cpu:.2e}, card sp "
                    f"vs card dense {d_dense:.2e} (1e-4); launches {launches} "
                    f"{'ok' if ok else 'FAIL'}")
                results.append({"mode": mode, "schedule": schedule, "card_vs_cpu": d_cpu,
                                "sp_vs_dense": d_dense, "launches": launches, "ok": ok})
    RECORD["phases"]["sp_parity"] = results
    if not all(r["ok"] for r in results):
        fail("sequence-parallel forward: card, CPU and dense disagree (phase 7a)")


def request_summary(out, L):
    c = out["coords"][0].double()
    return {"logits": out["distogram_logits"][0].float(), "confidence": out["confidence"][0],
            "distances": torch.cdist(c, c), "stress": out["stress"][0],
            "finite": all(bool(torch.isfinite(v).all()) for v in out.values()),
            "shapes_ok": tuple(out["coords"].shape) == (1, L, 3)}


def phase_sp_request(label, devices):
    """(b) the served configuration (dim 256, depth 2, heads 8, dim_head 64,
    bf16, a 20-row MSA, 200 MDS iterations) at L = 384 through
    predict_structure(model_apply_fn=the SP forward) with 4 shards on
    `devices`, after one warm-up request of each kind; counts set to 0 just
    before one SP request and read just after: per trunk layer 5 B1f a
    shard (pair row and column passes, MSA row and column passes, the
    gathered pair<-MSA cross) and P^2 = 16 B3 forwards (the MSA<-pair ring).
    Latency: CUDA events on the first card and the host clock, dense and SP
    requests in turns (dense, SP, SP, dense).

    Bound against the dense request on the same params: both round their
    activations to bf16 at every op, in other places (each ring hop's
    output is rounded before its merge, each shard projects its own rows),
    so neither is the exact answer. The f32 request on the same params is
    the yardstick: the SP request's distance from it (logits, confidence,
    distances) must stay within 1.5x the dense bf16 request's own distance
    from it, plus 1e-5 (a floor for a distance of 0). The last layer's
    MSA<-pair ring does not reach the logits (the head reads the pair
    stream), so this checks half of the B3 launches it counts only for
    finiteness; B3's agreement rests on phase 3 and on (a) and (c)."""
    L, P = 384, 4
    cfg = Alphafold2Config(dim=256, depth=2, heads=8, dim_head=64, max_seq_len=L,
                           dtype=torch.bfloat16)
    mesh = make_mesh({"seq": P}, devices=devices)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), mesh.devices[0])
    tokens, msa, msa_mask = request_inputs(L, 20, seed=31)
    kw = dict(msa=msa, msa_mask=msa_mask, mds_iters=200)
    run_sp = lambda: predict_structure(params, cfg, tokens, model_apply_fn=sp_apply(mesh),  # noqa: E731
                                       **kw)
    run_dense = lambda: predict_structure(params, cfg, tokens, device=mesh.devices[0],  # noqa: E731
                                          **kw)
    run_dense()
    run_sp()
    sync()
    times = {"dense": [], "sp": []}
    for kind in ("dense", "sp", "sp", "dense"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        if kind == "sp":
            reset_launches()
            out = run_sp()
            end.record()
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            launches = launch_counts()
            sp = request_summary(out, L)
        else:
            out = run_dense()
            end.record()
            sync()
            dense = request_summary(out, L)
        times[kind].append({"device_ms": start.elapsed_time(end),
                            "wall_ms": (time.perf_counter() - t0) * 1e3})
    f32_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    ref = request_summary(predict_structure(params, f32_cfg, tokens, device=mesh.devices[0],
                                            **kw), L)
    sync()
    expect = {name: 0 for name in launches}
    expect.update(flash_fwd=5 * P * cfg.depth, flash_fwd_lse=P * P * cfg.depth,
                  flash_fwd_wgmma=(5 * P + P * P) * cfg.depth)
    d = {}
    ok = sp["finite"] and sp["shapes_ok"] and launches == expect
    for key in ("logits", "confidence", "distances"):
        d_sp = (sp[key] - ref[key]).abs().max().item()
        d_dense = (dense[key] - ref[key]).abs().max().item()
        d[key] = {"sp_vs_dense": (sp[key] - dense[key]).abs().max().item(),
                  "sp_vs_f32": d_sp, "dense_vs_f32": d_dense, "bound": 1.5 * d_dense + 1e-5}
        ok = ok and d_sp <= d[key]["bound"]
    row = {"devices": [str(x) for x in mesh.devices], "L": L, "shards": P,
           "config": repr(cfg), "times": times, "launches": launches, "expected": expect,
           "diffs": d, "stress": {"sp": float(sp["stress"]), "dense": float(dense["stress"]),
                                  "f32": float(ref["stress"])}, "ok": bool(ok)}
    fmt = lambda rs: ", ".join(f"{r['device_ms']:.1f} ms ({r['wall_ms']:.1f} host)" for r in rs)  # noqa: E731
    log(f"[sp {label}] L={L} bf16 {P} shards on {row['devices']}: SP request {fmt(times['sp'])}; "
        f"dense {fmt(times['dense'])}; finite={sp['finite']}")
    for key, v in d.items():
        log(f"[sp {label}]   {key}: |SP - dense| {v['sp_vs_dense']:.3e}; from the f32 request: "
            f"SP {v['sp_vs_f32']:.3e}, dense {v['dense_vs_f32']:.3e} (bound {v['bound']:.3e})")
    log(f"[sp {label}] launches {launches} (expected {expect}) {'ok' if ok else 'FAIL'}")
    RECORD["phases"][f"sp_request_{label}"] = row
    if not ok:
        fail(f"sequence-parallel request {label}: launches, finiteness or agreement failed")
    return launches


def phase_sp_ring_grad():
    """(c) the gradient of sum(ring_attention(q, k, v)^2) over 4 shards on
    the card (["cuda:0"] * 4, B3 forward and backward through real merges)
    against the same over 4 CPU shards (the plain version under autograd,
    f32), b 1, n 1,024 (256 a shard), 2 heads of 64, the second shard's keys
    all masked and 5% of the others; in f32, then in bf16 (inputs rounded
    once, the CPU in f32 on the same rounded values). Counts set to 0 just
    before each card run's forward and backward, read after: P^2 = 16
    launches of each B3 kernel, the forwards, dq and dkv kernels on the f32
    route in f32 and on the wgmma route in bf16. Tolerance: out and each
    gradient, f32 1e-5 * max(1, max|ref|) (f32 on both sides, another
    summation order); bf16 2^-5 * max(1, max|ref|) (each hop's output is
    rounded to bf16 before its merge, and the kernels round P and dS to
    bf16: the card test's bound, test_ring_attention_on_card_matches_cpu_shards).
    Returns the B3 kernels' launches, summed over the two runs."""
    P, n, h, dh = 4, 1024, 2, 64
    gen = torch.Generator().manual_seed(41)
    q, k, v = (torch.randn(1, n, h, dh, generator=gen) for _ in range(3))
    mask = torch.rand(1, n, generator=gen) >= 0.05
    mask[:, n // P:2 * n // P] = False
    total, rows = {}, []
    for dtype, route, rel in ((torch.float32, "f32", 1e-5), (torch.bfloat16, "wgmma", 2.0 ** -5)):
        inputs = [t.to(dtype).float() for t in (q, k, v)]
        grads, outs = {}, {}
        for dev, dt in (("cuda", dtype), ("cpu", torch.float32)):
            mesh = make_mesh({"seq": P}, devices=[dev] * P)
            leaves = [t.to(dev, dt).requires_grad_() for t in inputs]
            if dev == "cuda":
                reset_launches()
            out = mesh.unshard(ring_attention(*(mesh.shard(t, 1) for t in leaves), mesh,
                                              masks=mesh.shard(mask.to(dev), 1)), 1)
            grads[dev] = torch.autograd.grad((out.float() ** 2).sum(), leaves)
            if dev == "cuda":
                sync()
                launches = launch_counts()
            outs[dev] = out.detach().float().cpu()
        errs = {"out": (outs["cuda"] - outs["cpu"]).abs().max().item()}
        ok = errs["out"] <= rel * max(1.0, outs["cpu"].abs().max().item())
        for name, gc, gp in zip("qkv", grads["cuda"], grads["cpu"]):
            errs[f"d{name}"] = (gc.float().cpu() - gp).abs().max().item()
            ok = ok and errs[f"d{name}"] <= rel * max(1.0, gp.abs().max().item())
            ok = ok and bool(torch.isfinite(gc).all())
        expect = {name: 0 for name in launches}
        expect.update({"flash_fwd_lse": P * P, f"flash_fwd_{route}": P * P,
                       "flash_bwd_lse_dq": P * P, "flash_bwd_lse_dkv": P * P,
                       f"flash_bwd_dq_{route}": P * P, f"flash_bwd_dkv_{route}": P * P})
        ok = ok and launches == expect
        kind = str(dtype).split(".")[-1]
        log(f"[sp c] ring attention {kind} grad, card vs cpu: "
            f"{', '.join(f'{k} |d|={e:.2e}' for k, e in errs.items())} ({rel:g} of the largest); "
            f"launches {launches} {'ok' if ok else 'FAIL'}")
        rows.append({"dtype": kind, "errs": errs, "tol_rel": rel, "launches": launches,
                     "ok": bool(ok)})
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
    RECORD["phases"]["sp_ring_grad"] = rows
    if not all(r["ok"] for r in rows):
        fail("ring attention's gradient on the card disagrees with the CPU's (phase 7c)")
    return total


def phase_sp():
    phase_sp_parity()
    launches = phase_sp_request("b", ["cuda:0"] * 4)
    launches.update({k: n for k, n in phase_sp_ring_grad().items() if k.startswith("flash_bwd_lse")})
    cards = torch.cuda.device_count()
    if cards >= 2:
        phase_sp_request("d", [f"cuda:{s % cards}" for s in range(4)])
    else:
        log(f"[sp d] {cards} card on this host: the SP request over distinct cards is skipped")
    return {k: launches[k] for k in ("flash_fwd_lse", "flash_bwd_lse_dq", "flash_bwd_lse_dkv")}


# --- phase 9: checkpoints and recovery ---------------------------------------------

CKPT_WORK = ROOT / "build" / "phase9"  # checkpoints of the run, removed at its end
CKPT_BUCKETS = (128, 256)


def device_copy(state):
    """(update count, a device clone of every tensor a step updates)."""
    with torch.no_grad():
        return state["step"], [t.detach().clone()
                               for t in state["optimizer"].state_tensors()]


def equals(state, ref):
    """The state bit for bit the reference `device_copy`."""
    step, tensors = ref
    live = state["optimizer"].state_tensors()
    return (state["step"] == step and len(live) == len(tensors)
            and all(torch.equal(a, b) for a, b in zip(live, tensors)))


def fresh_captured(cfg, tcfg, batch):
    """A new seeded train state on the card and its captured step."""
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    return state, CapturedTrainStep(cfg, tcfg, state, batch)


def quiet(fn, *args, **kwargs):
    """fn's result and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().strip().splitlines()


def phase_ckpt():
    """9: checkpoints and recovery at train_pre's defaults (bf16, dim 256,
    depth 1, heads 8, dim_head 64, crop 128, batch 1, accum 16), captured,
    as train_pre runs on the card; counts set to 0 just before, read just
    after (wrapper launches: the warm-ups and captures; the replays'
    launches from each capture). Every comparison is bit for bit against
    the uninterrupted captured run (loss, grad_norm, every param and AdamW
    moment and count); no capture happens again in a run.
    (a) the uninterrupted run of 6 steps, saved at steps 2 and 4 (save ms,
        the checkpoint's bytes); a fresh state restored from step 2 through
        `open_or_init` (restore ms, a fresh manager's verified restore),
        then captured, runs steps 2 and 3: equal at step 4;
    (b) `nan_grads` at step 2 under `run_resilient`: rolled back by the
        guard's device snapshot, equal at step 4; the guard's cost: step ms
        with and without it (CUDA events, median of 5, arms in turns) and
        the launches a guarded and a plain step issue (torch.profiler);
    (c) `step_exception` at step 3, max_restarts 1, saved every 2 steps:
        restored from step 2 into the live graph's tensors (their addresses
        kept), equal at step 4; `ckpt_corrupt` truncating step 4's file and
        `step_exception` at step 5: the restore falls back to step 2, equal
        at step 6;
    (d) the step-4 params restored by `restore_params_for_inference` served
        by `ServingEngine` (buckets 128 and 256, batch 1, 200 MDS
        iterations, captured): each result bit for bit `predict_structure`
        on the params the resumed run holds in memory; then (its launches
        read first) the same weights in float32 on the card against the
        CPU at L = 128 with a 20-row MSA, phase 4's tolerances."""
    cfg, tcfg = train_pre_config(), TrainConfig(grad_accum=16)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=128, seed=13), 16)
    shutil.rmtree(CKPT_WORK, ignore_errors=True)
    CKPT_WORK.mkdir(parents=True)
    rec, ok = {}, {}
    sync()
    reset_launches()
    steps_run = []  # every CapturedTrainStep of the phase

    # (a) the uninterrupted run, then a resume from step 2
    ref_state, ref_step = fresh_captured(cfg, tcfg, fetch(0))
    steps_run.append(ref_step)
    mgr_a = VerifiedCheckpointManager(str(CKPT_WORK / "a"))
    ref_metrics, refs, save_ms = [], {}, []
    for n in range(6):
        _, m = ref_step(ref_state, fetch(n))
        ref_metrics.append(m)
        if ref_state["step"] in (2, 4):
            sync()
            t0 = time.perf_counter()
            mgr_a.save(ref_state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            refs[ref_state["step"]] = device_copy(ref_state)
    refs[6] = device_copy(ref_state)
    npz = Path(mgr_a._state_path(2))
    rec["ckpt_bytes"] = npz.stat().st_size
    rec["manifest_bytes"] = Path(mgr_a._manifest_path(2)).stat().st_size
    rec["save_ms"] = save_ms
    resume_dir = CKPT_WORK / "resume"
    resume_dir.mkdir()
    for src in (npz, Path(mgr_a._manifest_path(2))):
        shutil.copy(src, resume_dir / src.name)
    (mgr_b, state_b, resumed), _ = quiet(open_or_init, str(resume_dir), train_state_init, cfg,
                                         tcfg, torch.Generator().manual_seed(1), "cuda")
    restore_ms = []
    for _ in range(3):  # a fresh manager each time: the sha256 check included
        sync()
        t0 = time.perf_counter()
        VerifiedCheckpointManager(str(resume_dir)).restore(into=state_b, step=2)
        sync()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    rec["restore_ms"] = restore_ms
    cap_b = CapturedTrainStep(cfg, tcfg, state_b, fetch(2))
    steps_run.append(cap_b)
    metrics_b = [cap_b(state_b, fetch(n))[1] for n in (2, 3)]
    same_metrics = all(torch.equal(m[k], ref_metrics[n][k]) for m, n in zip(metrics_b, (2, 3))
                       for k in ("loss", "grad_norm"))
    ok["a"] = resumed and same_metrics and equals(state_b, refs[4])
    log(f"[ckpt a] checkpoint {rec['ckpt_bytes']:,} bytes (+ manifest "
        f"{rec['manifest_bytes']:,}), save {', '.join(f'{t:.1f}' for t in save_ms)} ms, "
        f"restore {', '.join(f'{t:.1f}' for t in restore_ms)} ms; resumed from step 2 "
        f"through open_or_init, then captured: steps 2-3 loss and grad_norm bit-equal "
        f"{same_metrics}, state at step 4 bit-equal {equals(state_b, refs[4])} "
        f"{'ok' if ok['a'] else 'FAIL'}")

    # (b) NaN rollback under the guard, then the guard's cost
    state_g, cap_g = fresh_captured(cfg, tcfg, fetch(0))
    steps_run.append(cap_g)
    graph = next(iter(cap_g.captures.values())).graph
    inj = FaultPlan(faults=(Fault("nan_grads", at=2),)).injector()
    _, out_b = quiet(run_resilient, with_fault_injection(cap_g, inj), state_g, fetch, steps=4)
    capture = next(iter(cap_g.captures.values()))
    equal_b, replays_b = equals(state_g, refs[4]), capture.replays
    ok["b"] = (inj.exhausted() and len(cap_g.captures) == 1 and capture.graph is graph
               and replays_b == 5 and equal_b)
    guard = StepGuard(state_g)
    batch = fetch(4)

    def plain():
        return cap_g(state_g, batch)

    def guarded():
        return guard.check(*cap_g(state_g, batch))

    arms = {"plain": plain, "guarded": guarded}
    ms = {"plain": [], "guarded": []}
    for order in [("plain", "guarded"), ("guarded", "plain")] * 3:
        for name in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            arms[name]()
            end.record()
            sync()
            ms[name].append(start.elapsed_time(end))
    prof = {name: profile_request(fn) for name, fn in arms.items()}
    snapshot = state_g["optimizer"].state_tensors()  # what the guard copies
    snap_bytes = sum(t.numel() * t.element_size() for t in snapshot)
    rec["guard"] = {"step_ms": {k: v[:5] for k, v in ms.items()},
                    "median_ms": {k: sorted(v[:5])[2] for k, v in ms.items()},
                    "profile": prof, "snapshot_bytes": snap_bytes,
                    "snapshot_tensors": len(snapshot), "run_output": out_b}
    g = rec["guard"]
    log(f"[ckpt b] nan_grads at step 2 rolled back ({' | '.join(out_b)}): state at step 4 "
        f"bit-equal {equal_b}, captures {len(cap_g.captures)} (the same graph), replays "
        f"{replays_b}; guard: step {g['median_ms']['guarded']:.2f} ms "
        f"against {g['median_ms']['plain']:.2f} without (median of 5, in turns), host "
        f"launches {prof['guarded']['kernel_launches']} kernels + "
        f"{prof['guarded']['graph_launches']} graph, {prof['guarded']['copies']} copies "
        f"against {prof['plain']['kernel_launches']} + {prof['plain']['graph_launches']}, "
        f"{prof['plain']['copies']}; snapshot {snap_bytes:,} bytes in {len(snapshot)} "
        f"tensors {'ok' if ok['b'] else 'FAIL'}")

    # (c) restarts in place: from the step-2 checkpoint, then past a torn step 4
    results_c = []
    for label, faults, steps, want in (
            ("step_exception at 3", (Fault("step_exception", at=3),), 4, 4),
            ("step 4 torn, step_exception at 5",
             (Fault("ckpt_corrupt", at=4, mode="truncate"), Fault("step_exception", at=5)),
             6, 6)):
        state_c, cap_c = fresh_captured(cfg, tcfg, fetch(0))
        steps_run.append(cap_c)
        ptrs = [t.data_ptr() for t in state_c["optimizer"].state_tensors()]
        inj = FaultPlan(faults=faults).injector()
        mgr_c = VerifiedCheckpointManager(str(CKPT_WORK / f"c{len(results_c)}"),
                                          save_interval_steps=2,
                                          fault_hook=inj.checkpoint_hook())
        _, out_c = quiet(run_resilient, with_fault_injection(cap_c, inj), state_c, fetch,
                         steps=steps, mgr=mgr_c, max_restarts=1)
        kept = [t.data_ptr() for t in state_c["optimizer"].state_tensors()] == ptrs
        good = (inj.exhausted() and len(cap_c.captures) == 1 and kept
                and any("from checkpoint step 2" in line for line in out_c)
                and equals(state_c, refs[want]))
        results_c.append({"label": label, "output": out_c, "addresses_kept": kept, "ok": good})
        log(f"[ckpt c] {label}: {' | '.join(out_c)}; addresses kept {kept}, captures "
            f"{len(cap_c.captures)}, state at step {want} bit-equal "
            f"{equals(state_c, refs[want])} {'ok' if good else 'FAIL'}")
        del state_c, cap_c
    ok["c"] = all(r["ok"] for r in results_c)
    rec["restarts"] = results_c
    train_replayed = {}
    for st in steps_run:
        for k, n in st.replayed_launches().items():
            train_replayed[k] = train_replayed.get(k, 0) + n
    del cap_g, state_g, guard, arms

    # (d) serving the restored params
    ckpt_dir = str(CKPT_WORK / "a")
    (params_r, step_r, _), _ = quiet(restore_params_for_inference, ckpt_dir, lambda: alphafold2_init(
        cfg, torch.Generator().manual_seed(2), "cuda"))
    engine = ServingEngine(params_r, cfg, ServingConfig(
        buckets=CKPT_BUCKETS, max_batch=1, mds_iters=200, request_timeout_s=600.0,
        precompile=True, params_tag=f"{ckpt_dir}@step{step_r}"), device="cuda")
    rng = np.random.default_rng(14)
    served = []
    try:
        for L in CKPT_BUCKETS:
            tokens = rng.integers(0, 20, L)
            res = engine.predict("".join(AA_ORDER[t] for t in tokens), timeout=600)
            padded, mask, _ = pad_batch([tokens], L, 1)
            with torch.inference_mode():
                ref = predict_structure(state_b["params"], cfg, padded, mask=mask,
                                        mds_iters=200, device="cuda")
            equal = (np.array_equal(res.coords, ref["coords"][0, :L].cpu().numpy())
                     and np.array_equal(res.confidence, ref["confidence"][0, :L].cpu().numpy())
                     and res.stress == float(ref["stress"][0]))
            served.append({"L": L, "bit_equal": equal, "stress": res.stress,
                           "finite": bool(np.isfinite(res.coords).all())})
        engine_stats = engine.stats()
    finally:
        engine.shutdown()
    sync()
    launches = launch_counts()  # before (d)'s CPU comparison, which sets them to 0
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    (params_cpu, _, _), _ = quiet(restore_params_for_inference, ckpt_dir, lambda: alphafold2_init(
        f32, torch.Generator().manual_seed(2), "cpu"))
    cpu_vs_card("ckpt d", f32, 128, {"flash_fwd": 6, "flash_fwd_f32": 6},
                params=(params_cpu, params_r))
    ok["d"] = step_r == 4 and all(r["bit_equal"] and r["finite"] for r in served)
    log(f"[ckpt d] restored step {step_r} served through the engine (captured, params_tag "
        f"'{engine.cfg.params_tag}'): bit-equal to predict_structure on the params in memory "
        f"{[(r['L'], r['bit_equal']) for r in served]}; captures "
        f"{len(engine_stats['captures'])} {'ok' if ok['d'] else 'FAIL'}")
    rec["served"] = served

    serve_replayed = engine_stats["launches"]
    rec.update(wrapper_launches=launches, train_replayed_launches=train_replayed,
               serve_replayed_launches=serve_replayed, ok=ok)
    RECORD["phases"]["ckpt"] = rec
    shutil.rmtree(CKPT_WORK, ignore_errors=True)
    path = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    missing = [k for k in path if not launches.get(k)]
    log(f"[ckpt] wrapper launches {dict((k, n) for k, n in launches.items() if n)}; replayed: "
        f"training {dict((k, n) for k, n in train_replayed.items() if n)}, serving "
        f"{dict((k, n) for k, n in serve_replayed.items() if n)}")
    if not all(ok.values()):
        fail(f"checkpoints and recovery: {', '.join(k for k, v in ok.items() if not v)} "
             f"failed (phase 9)")
    if missing or not train_replayed.get("flash_bwd_dq") or not serve_replayed.get("flash_fwd"):
        fail(f"phase 9 did not launch {missing or 'its replayed kernels'}")


# --- phase 10: the template tower and the branch-parallel schedule -----------------

TEMPLATES_T = 4   # AF2's template count
TOWER_FLASH = 5   # flash forwards a tower layer: 2 pair axial, 2 template axial, the joint
JOINT_BH = 384 * 384 * 8  # the joint attention at L = 384, 8 heads: b * L^2 * heads


def template_inputs(L, T, kind, seed):
    """Seeded templates (1, T, L, L), int buckets in [0, 37) or float
    distances in [0, 25) A (bucketed by the model), and a templates_mask
    with ~70% of its entries true."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        templates = rng.integers(0, 37, (1, T, L, L)).astype(np.int32)
    else:
        templates = rng.uniform(0.0, 25.0, (1, T, L, L)).astype(np.float32)
    return templates, rng.random((1, T, L, L)) > 0.3


def templates_cpu_vs_card(label, cfg, L, kind, expect, pad=5):
    """(a) One templated request (T = 2, a partial templates_mask, a
    20-row MSA, the last `pad` residues padded) in float32 on the card and
    on the CPU with the same parameters, at phase 4a's tolerances on valid
    pairs and residues (on padded query rows the card's flash path and
    the CPU's dense path give different finite values that no valid
    output reads); `expect`: the card's launches."""
    params = [alphafold2_init(cfg, torch.Generator().manual_seed(0), dev)
              for dev in ("cpu", "cuda")]
    tokens, msa, msa_mask = request_inputs(L, 20, seed=5)
    mask = np.ones((1, L), bool)
    mask[:, L - pad:] = False
    tokens[~mask] = PAD_TOKEN_ID
    msa[:, :, L - pad:] = PAD_TOKEN_ID
    msa_mask[:, :, L - pad:] = False
    templates, tmask = template_inputs(L, 2, kind, seed=6)
    kw = dict(mask=mask, msa=msa, msa_mask=msa_mask, templates=templates,
              templates_mask=tmask, mds_iters=200)
    reset_launches()
    gpu = predict_structure(params[1], cfg, tokens, device="cuda", **kw)
    sync()
    launches = launch_counts()
    cpu = predict_structure(params[0], cfg, tokens, device="cpu", **kw)
    g = {k: v.cpu() for k, v in gpu.items()}
    valid = torch.from_numpy(mask[0])
    pair = valid[:, None] & valid[None, :]
    logits = (g["distogram_logits"][0][pair], cpu["distogram_logits"][0][pair])
    d_logits = (logits[0] - logits[1]).abs().max().item()
    d_conf = (g["confidence"] - cpu["confidence"]).abs().max().item()
    d_stress = ((g["stress"] - cpu["stress"]).abs() / cpu["stress"].abs()).max().item()
    d_dist = (pairwise(g["coords"][:, valid])
              - pairwise(cpu["coords"][:, valid])).abs().max().item()
    want = {name: expect.get(name, 0) for name in launches}
    ok = (d_logits <= 1e-4 and d_conf <= 1e-5 and d_stress <= 1e-3 and d_dist <= 1e-2
          and launches == want)
    log(f"[templates a] {label}: L={L} ({pad} padded), T=2 {kind}, f32 card vs cpu: logits "
        f"|d|={d_logits:.2e} (1e-4), confidence |d|={d_conf:.2e} (1e-5), stress "
        f"rel={d_stress:.2e} (1e-3), distances |d|={d_dist:.2e} A (1e-2); launches "
        f"{dict((k, n) for k, n in launches.items() if n)} {'ok' if ok else 'FAIL'}")
    return {"label": label, "L": L, "kind": kind, "config": repr(cfg), "logits": d_logits,
            "confidence": d_conf, "stress_rel": d_stress, "distances": d_dist,
            "launches": launches, "ok": ok}


def phase_templates_parity():
    rows = []
    for gate in (False, True):
        cfg = Alphafold2Config(dim=64, depth=2, heads=2, dim_head=32, max_seq_len=64,
                               attn_gate=gate)
        n = TOWER_FLASH * cfg.template_attn_depth + 6 * cfg.depth
        name = "flash_fwd_fused" if gate else "flash_fwd"
        for kind in ("int", "float"):
            rows.append(templates_cpu_vs_card(f"{kind}{' gated' if gate else ''}", cfg, 64,
                                              kind, {name: n, "flash_fwd_f32": n}))
    RECORD["phases"]["templates_parity"] = rows
    if not all(r["ok"] for r in rows):
        fail("the templated request: the card and the CPU disagree, or launches differ "
             "(phase 10a)")


def forward_ms(fn, reps):
    """Device ms (CUDA events) of each of `reps` calls."""
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        out.append(start.elapsed_time(end))
    return out


def phase_templates_request(reps=3):
    """(b) The served config (bf16) at L = 384 with T = 4 int templates
    (a partial templates_mask) and a 20-row MSA through
    `predict_structure`, beside the same request without templates:
    request ms (events and host clock) and the forward's ms
    (`alphafold2_apply`, events), the two in turns after a warm-up of
    each; finiteness; the templated request's launches (counts set to 0
    just before it, read just after): the tower's 5 flash forwards a
    layer and the trunk's 6, every one on the wgmma route, the joint
    attention's included."""
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    L = 384
    tokens, msa, msa_mask = request_inputs(L, 20, seed=7)
    templates, tmask = template_inputs(L, TEMPLATES_T, "int", seed=8)
    arms = {
        "templated": dict(templates=templates, templates_mask=tmask),
        "plain": {},
    }

    def request(arm):
        return predict_structure(params, cfg, tokens, msa=msa, msa_mask=msa_mask,
                                 mds_iters=200, device="cuda", **arms[arm])

    def forward(arm):
        with torch.inference_mode():
            return alphafold2_apply(params, cfg, tokens, msa, msa_mask=msa_mask,
                                    device="cuda", **arms[arm])

    for arm in arms:
        request(arm)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = request("templated")
    sync()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    n = TOWER_FLASH * cfg.template_attn_depth + 6 * cfg.depth
    want = {name: {"flash_fwd": n, "flash_fwd_wgmma": n}.get(name, 0) for name in launches}
    times = {arm: {"request_ms": [], "host_ms": [], "forward_ms": []} for arm in arms}
    for order in [("templated", "plain"), ("plain", "templated")] * ((reps + 1) // 2):
        for arm in order:
            t0 = time.perf_counter()
            times[arm]["request_ms"] += forward_ms(lambda: request(arm), 1)
            times[arm]["host_ms"].append((time.perf_counter() - t0) * 1e3)
            times[arm]["forward_ms"] += forward_ms(lambda: forward(arm), 1)
    med = {arm: {k: sorted(v[:reps])[reps // 2] for k, v in t.items()} for arm, t in times.items()}
    tower_ms = med["templated"]["forward_ms"] - med["plain"]["forward_ms"]
    ok = finite and launches == want
    log(f"[templates b] L={L}, T={TEMPLATES_T}, bf16, 20-row MSA: templated request "
        f"{med['templated']['request_ms']:.2f} ms (events; host {med['templated']['host_ms']:.2f}),"
        f" forward {med['templated']['forward_ms']:.2f} ms; without templates "
        f"{med['plain']['request_ms']:.2f} ms (host {med['plain']['host_ms']:.2f}), forward "
        f"{med['plain']['forward_ms']:.2f} ms; the tower {tower_ms:.2f} ms (forward difference, "
        f"medians of {reps}); peak {peak:.2f} GiB; finite={finite}; launches "
        f"{dict((k, v) for k, v in launches.items() if v)} (expected {n} flash_fwd, all wgmma) "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["templates_request"] = {
        "L": L, "T": TEMPLATES_T, "config": repr(cfg), "times": times, "medians": med,
        "tower_ms": tower_ms, "peak_gib": peak, "finite": finite, "launches": launches,
        "ok": ok}
    if not ok:
        fail("the templated request at L = 384 is not finite or left the wgmma route "
             "(phase 10b)")
    return launches


def dense_joint_ms(BH, reps=10):
    """The joint attention's call (bf16 q, k, v (BH, 5, 64), a key-side
    mask) as `attention_apply`'s dense einsum computes it (f32 logits,
    softmax, P.V): the JAX rule's choice at this shape."""
    q, k, v, bias, _ = make_inputs(BH, 5, 5, 64, torch.bfloat16)
    scale = 64 ** -0.5

    def dense():
        s = torch.bmm(q, k.transpose(1, 2)).float() * scale + bias[:, None, :]
        return torch.bmm(torch.softmax(s, dim=-1).to(q.dtype), v)

    ms = time_ms(dense, reps)
    del q, k, v, bias
    torch.cuda.empty_cache()
    return ms


def tower_layer_grads(dtype, device, L=32, T=TEMPLATES_T):
    """The gradient of sum(w * tower(x)) over valid pairs, one tower layer
    (dim 128, heads 2, dim_head 64; L = 32 with 4 padded residues, T int
    templates, a partial templates_mask), in the tower's leaves, the
    template embeddings and x; the same seeded inputs on either device.
    Returns ({name: grad on the CPU, f32}, launches)."""
    cfg = Alphafold2Config(dim=128, depth=1, heads=2, dim_head=64, max_seq_len=L,
                           template_attn_depth=1, dtype=dtype)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, L, L, cfg.dim, generator=g)
    w = torch.randn(1, L, L, cfg.dim, generator=g)
    mask = torch.ones(1, L, dtype=torch.bool)
    mask[:, L - 4:] = False
    templates, tmask = template_inputs(L, T, "int", seed=2)
    pair = (mask[:, :, None] & mask[:, None, :]).to(device)
    x = x.to(device).to(dtype).requires_grad_(True)
    leaves = {"x": x}
    for name in ("template_emb", "template_pos_emb", "template_pos_emb_ax"):
        leaves[name] = params[name]["table"]
    leaves.update(named_leaves(params["template_tower"], "template_tower."))
    for t in leaves.values():
        t.requires_grad_(True)
    reset_launches()
    out = template_tower_apply(params, cfg, x, (mask[:, :, None] | mask[:, None, :]).to(device),
                               torch.from_numpy(templates).long().to(device),
                               torch.from_numpy(tmask).to(device), None)
    loss = (out.float() * w.to(device) * pair[..., None]).sum()
    # the last layer's template FF feeds nothing: its gradient is 0, as in JAX
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    if device != "cpu":
        sync()
    launches = launch_counts()
    return {k: (torch.zeros(t.shape) if gr is None else gr.float().cpu())
            for (k, t), gr in zip(leaves.items(), grads)}, launches


def phase_templates_kernels():
    """(c) B1f at the joint attention's shape at L = 384, T = 4, 8 heads:
    (1,179,648, 5, 5) bf16 against its plain version (phase 3's bound),
    timed beside the same call on the mma_sync route, the dense einsum and
    SDPA, with its bound; B1b and B2b at j = T + 1 on that shape (phase
    3's backward bound, timed). Then the gradient of one tower layer: f32
    on the card against the CPU (each leaf 1e-4 of its largest entry,
    phase 6a's first-step bound), and bf16 on the card (every dq and dkv
    on the wgmma route; its cosine with the f32 card gradient over every
    leaf at least 0.99)."""
    row = check_kernel("flash_fwd", "joint attention", JOINT_BH, 5, 5, 64, torch.bfloat16,
                       timed=True, heads=8)
    row["dense_ms"] = dense_joint_ms(JOINT_BH)
    log(f"[templates c] B1f at the joint shape: kernel {row['kernel_ms']:.3f} ms "
        f"({row['route']}; mma_sync {row.get('mma_sync_ms', float('nan')):.3f}), plain "
        f"{row['plain_ms']:.3f}, dense einsum {row['dense_ms']:.3f}, SDPA "
        f"{'none' if row['library_ms'] is None else format(row['library_ms'], '.3f')}, bound "
        f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    bwd = [check_bwd("joint attention", JOINT_BH, 5, 5, 64, torch.bfloat16, timed=True,
                     heads=8),
           check_bwd("joint attention gated", JOINT_BH, 5, 5, 64, torch.bfloat16, timed=True,
                     gated=True, heads=8)]
    ref, _ = tower_layer_grads(torch.float32, "cpu")
    card, f32_launches = tower_layer_grads(torch.float32, "cuda")
    bf16, bf16_launches = tower_layer_grads(torch.bfloat16, "cuda")
    worst = max((card[k] - ref[k]).abs().max().item() / max(ref[k].abs().max().item(), 1e-30)
                for k in ref)
    flat = lambda gr: torch.cat([v.flatten() for v in gr.values()])  # noqa: E731
    cosine = F.cosine_similarity(flat(bf16), flat(card), dim=0).item()
    n = TOWER_FLASH  # one tower layer: each flash forward's backward once
    bf16_ok = (bf16_launches.get("flash_bwd_dq", 0) == n
               and bf16_launches.get("flash_bwd_dq_wgmma", 0) == n
               and bf16_launches.get("flash_bwd_dkv_wgmma", 0) == n
               and bf16_launches.get("flash_fwd_wgmma", 0) == n)
    finite = all(bool(torch.isfinite(v).all()) for v in bf16.values())
    grad_ok = worst <= 1e-4 and cosine >= 0.99 and bf16_ok and finite
    log(f"[templates c] one tower layer's gradient ({len(ref)} leaves): f32 card vs cpu, worst "
        f"leaf |d| / max|leaf| = {worst:.2e} (1e-4); bf16 card cosine with f32 {cosine:.5f} "
        f"(0.99), finite={finite}; bf16 launches "
        f"{dict((k, v) for k, v in bf16_launches.items() if v)} {'ok' if grad_ok else 'FAIL'}")
    RECORD["phases"]["templates_kernels"] = {
        "fwd": row, "bwd": bwd, "tower_grad": {
            "f32_worst_rel": worst, "bf16_cosine": cosine, "f32_launches": f32_launches,
            "bf16_launches": bf16_launches, "ok": grad_ok}}
    bad = [r["case"] for r in [row] + bwd if not r["ok"]]
    if bad or row["route"] != "wgmma" or any(r["dq_route"] != "wgmma" or r["dkv_route"] != "wgmma"
                                             for r in bwd):
        fail(f"the joint attention's kernels disagree or left the wgmma route: {bad} "
             f"(phase 10c)")
    if not grad_ok:
        fail("the tower layer's gradient: card and CPU disagree, or bf16 left the wgmma "
             "routes (phase 10c)")
    return row, bwd


def kernel_timeline(fn):
    """fn once under torch.profiler; from its trace, the device kernels'
    busy ms (the union of their intervals), the ms two or more kernels run
    at once, the ms kernels of two or more streams run at once, and the
    kernels' count a stream."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    path = ROOT / "build" / "phase10_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    kernels = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
               for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    points = sorted([(s, 1, st) for s, _, st in kernels] + [(e, -1, st) for _, e, st in kernels],
                    key=lambda p: (p[0], p[1]))
    active, busy, multi, cross, last = {}, 0.0, 0.0, 0.0, None
    for t, step, st in points:
        if last is not None:
            running = sum(active.values())
            busy += (t - last) * (running >= 1)
            multi += (t - last) * (running >= 2)
            cross += (t - last) * (sum(n > 0 for n in active.values()) >= 2)
        active[st] = active.get(st, 0) + step
        last = t
    per_stream = {}
    for _, _, st in kernels:
        per_stream[str(st)] = per_stream.get(str(st), 0) + 1
    return {"busy_ms": busy / 1e3, "concurrent_ms": multi / 1e3, "cross_stream_ms": cross / 1e3,
            "kernels": len(kernels), "per_stream": per_stream}


def timed_turns(arms, reps):
    """Host ms of each arm's calls (synchronized), the arms in turns after
    a warm-up of each; then one more call of each under the profiler.
    Returns {arm: {"runs_ms", "median_ms", timeline..., "busy_share"}}."""
    for fn in arms.values():
        fn()
    runs = {name: [] for name in arms}
    names = list(arms)
    for order in [names, names[::-1]] * ((reps + 1) // 2):
        for name in order:
            runs[name].append(host_ms(arms[name]))
    out = {}
    for name, fn in arms.items():
        median = sorted(runs[name][:reps])[reps // 2]
        tl = kernel_timeline(fn)
        out[name] = {"runs_ms": runs[name][:reps], "median_ms": median, **tl,
                     "busy_share": tl["busy_ms"] / median}
    return out


def schedule_line(label, rows):
    return "; ".join(
        f"{name} {r['median_ms']:.2f} ms (busy {r['busy_share']:.3f}, two streams at once "
        f"{r['cross_stream_ms']:.3f} ms, kernels at once {r['concurrent_ms']:.3f} ms, "
        f"kernels a stream {r['per_stream']})" for name, r in rows.items())


def phase_schedule(reps=5):
    """(d) trunk_schedule="branch_parallel" against "serial" on the same
    params: the served config's eager forward at L = 384 (20-row MSA), one
    captured engine request (bucket 384, rung 1, `CapturedExecutable`) and
    3 captured train steps at train_pre's defaults (bf16, crop 128, accum
    16) with a 20-row MSA (without one the schedule is the serial one), all
    bit for bit; the branch-parallel runs' launches on the wgmma routes.
    Then request and step ms for both schedules (host clock, median of
    `reps`, in turns) and one more of each under the profiler: the busy
    share (the union of kernel intervals over the median) and the ms the
    kernels of two streams overlap."""
    serial = served_config()
    bp = served_config(trunk_schedule="branch_parallel")
    params = alphafold2_init(serial, torch.Generator().manual_seed(0), "cuda")
    L = 384
    tokens, msa, msa_mask = request_inputs(L, 20, seed=9)
    rec = {}

    def forward(cfg):
        with torch.inference_mode():
            return alphafold2_apply(params, cfg, tokens, msa, msa_mask=msa_mask, device="cuda")

    reset_launches()
    eager = {name: forward(cfg) for name, cfg in (("serial", serial), ("branch_parallel", bp))}
    sync()
    eager_equal = torch.equal(eager["serial"], eager["branch_parallel"])
    eager_diff = (eager["serial"].float() - eager["branch_parallel"].float()).abs().max().item()
    eager_launches = launch_counts()
    rec["forward"] = timed_turns({"serial": lambda: forward(serial),
                                  "branch_parallel": lambda: forward(bp)}, reps)
    log(f"[schedule d] eager forward L={L}: logits bit-equal {eager_equal} "
        f"(max |d| {eager_diff:.2e});"
        f" {schedule_line('forward', rec['forward'])}")
    del eager

    pool = GraphPool()
    batch = engine_batch((L,), L, seed=51)
    exes = {name: CapturedExecutable(params, cfg, batch=1, bucket=L, msa_rows=ENGINE_ROWS,
                                     mds_iters=200, device=torch.device("cuda", 0), pool=pool)
            for name, cfg in (("serial", serial), ("branch_parallel", bp))}
    outs = {}
    for name, exe in exes.items():
        outs[name] = exe(*batch)
        outs[name]["distogram_logits"] = exe.logits.clone()
    sync()
    request_equal = all(torch.equal(outs["serial"][k], outs["branch_parallel"][k])
                        for k in outs["serial"])
    bp_captured = exes["branch_parallel"].launches
    rec["request"] = timed_turns(
        {name: (lambda exe=exe: {k: v.cpu() for k, v in exe(*batch).items()})
         for name, exe in exes.items()}, reps)
    log(f"[schedule d] captured request (bucket {L}, rung 1): bit-equal {request_equal}; "
        f"branch_parallel captured launches {dict((k, v) for k, v in bp_captured.items() if v)};"
        f" {schedule_line('request', rec['request'])}")
    del exes, outs

    tcfg = TrainConfig(grad_accum=16)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=128, msa_rows=20, seed=9),
                                    16)
    batches = [fetch(n) for n in range(3)]
    steps, states = {}, {}
    for name, cfg in (("serial", train_pre_config()),
                      ("branch_parallel", train_pre_config(trunk_schedule="branch_parallel"))):
        states[name] = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
        steps[name] = CapturedTrainStep(cfg, tcfg, states[name], batches[0])
    metrics = {name: [steps[name](states[name], b)[1] for b in batches] for name in steps}
    sync()
    train_equal = all(torch.equal(a[k], b[k]) for a, b in zip(metrics["serial"],
                                                             metrics["branch_parallel"])
                      for k in ("loss", "grad_norm"))
    pairs = list(zip(states["serial"]["optimizer"].leaves,
                     states["branch_parallel"]["optimizer"].leaves))
    params_unequal = sum(not torch.equal(a, b) for a, b in pairs)
    bp_train = next(iter(steps["branch_parallel"].captures.values())).launches
    rec["train"] = timed_turns({name: (lambda name=name: steps[name](states[name], batches[0]))
                                for name in steps}, reps)
    log(f"[schedule d] 3 captured train steps (crop 128, accum 16, 20-row MSA): loss and "
        f"grad_norm bit-equal {train_equal}, {params_unequal} of {len(pairs)} param leaves "
        f"differ; losses {[round(float(m['loss']), 5) for m in metrics['branch_parallel']]}; "
        f"branch_parallel captured launches {dict((k, v) for k, v in bp_train.items() if v)}; "
        f"{schedule_line('step', rec['train'])}")
    del steps, states

    overlap = {k: rec[k]["branch_parallel"]["cross_stream_ms"] for k in ("forward", "request",
                                                                         "train")}
    routes = (on_wgmma(eager_launches) and on_wgmma(bp_captured) and on_wgmma(bp_train))
    ok = (eager_equal and request_equal and train_equal and params_unequal == 0
          and routes and overlap["forward"] > 0)
    rec.update({"eager_equal": eager_equal, "request_equal": request_equal,
                "train_equal": train_equal, "params_unequal": params_unequal,
                "overlap_ms": overlap, "on_wgmma": routes, "ok": ok})
    RECORD["phases"]["schedule"] = rec
    log(f"[schedule d] two streams at once (branch_parallel): forward {overlap['forward']:.3f} "
        f"ms, captured request {overlap['request']:.3f} ms, captured step "
        f"{overlap['train']:.3f} ms; all on wgmma {routes} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("branch_parallel differs from serial, left the wgmma routes, or its streams "
             "never overlapped (phase 10d)")
    return {"flash_fwd": eager_launches["flash_fwd"]}


def phase_templates():
    phase_templates_parity()
    launches = phase_templates_request()
    phase_templates_kernels()
    phase_schedule()
    return launches


# --- phase 11: the full-atom path --------------------------------------------------

ESM1B_FLASH = 33      # B1f launches an ESM-1b embed: one self-attention a layer
E2E_TRUNK_FLASH = 6   # flash forwards a trunk layer with the embedds grid stream
ESM1B_LENGTHS = (128, 384)     # (b)'s residues
FULL_ATOM_LENGTHS = (128, 256)  # (c)'s residues: grids 384 and 768


def to_device(tree, device):
    """A parameter tree's tensors copied to `device`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def full_atom_params(ecfg, device, seed=0):
    """End-to-end parameters from a seed, the refiner's coordinate head
    given random non-zero weights (it is zero at init: the identity)."""
    params = e2e.e2e_params_init(ecfg, torch.Generator().manual_seed(seed), device)
    g = torch.Generator().manual_seed(seed + 1)
    for layer in params["refiner"]["layers"]:
        for t in layer["coord_mlp"]["l2"].values():
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return params


def phi_ratio(cloud):
    """The fraction of negative phis of a (b, L, 14, 3) cloud's backbone."""
    b, L = cloud.shape[:2]
    n_mask, ca_mask = scn_backbone_mask(np.zeros((1, L)), l_aa=3)
    bb = cloud[:, :, :3].reshape(b, 3 * L, 3).transpose(1, 2)
    return calc_phis(bb, n_mask, ca_mask).tolist()


def phase_full_atom_parity():
    """(a) f32, the card against the CPU on the same parameters: the
    embedder (2 layers at ESM-1b's width, batch 2, one row's last quarter
    padded, one <mask> token; representations on valid tokens at 1e-4 *
    max(1, |ref|)), then e2e `predict_structure` at L = 32 (grid 96) on its
    embeddings (x3), 20 MDS iterations, classical init, refiner depth 2
    with a non-zero coordinate head: logits 1e-4, confidence 1e-5, the
    refined cloud's pairwise distances 1e-2 A on the cloud mask, the phi
    ratios equal. Launches: 2 B1f for the embed, 12 for the trunk, all on
    the f32 route."""
    ecfg = EmbedderConfig(num_layers=2, dim=1280, heads=20, max_len=64)
    cpu_p = embedder_init(ecfg, torch.Generator().manual_seed(0), "cpu")
    gpu_p = to_device(cpu_p, "cuda")
    L = 32
    rng = np.random.default_rng(11)
    seq = rng.integers(0, 20, (2, L)).astype(np.int32)
    mask = np.ones((2, L), bool)
    mask[1, 3 * L // 4:] = False
    tokens, fmask = esm_tokenize(seq, mask)
    tokens[0, 5] = ESM_IDX["<mask>"]
    with torch.inference_mode():
        reset_launches()
        g = embedder_apply(gpu_p, ecfg, tokens, fmask)
        sync()
        emb_launches = launch_counts()
        c = embedder_apply(cpu_p, ecfg, tokens, fmask)
        ref = c[fmask]
        d_repr = (g.cpu()[fmask] - ref).abs().max().item()
        repr_tol = 1e-4 * max(1.0, ref.abs().max().item())
        emb = np.repeat(embed_sequences(cpu_p, ecfg, seq[:1]).numpy(), 3, axis=1)

    cfg = Alphafold2Config(dim=64, depth=2, heads=2, dim_head=32, max_seq_len=3 * L)
    e2e_cfg = e2e.E2EConfig(model=cfg, mds_iters=20, mds_init="classical")
    params = full_atom_params(e2e_cfg, "cpu")
    out = {}
    with torch.inference_mode():
        reset_launches()
        out["cuda"] = e2e.predict_structure(to_device(params, "cuda"), e2e_cfg, seq[:1],
                                            embedds=emb, device="cuda")
        sync()
        e2e_launches = launch_counts()
        out["cpu"] = e2e.predict_structure(params, e2e_cfg, seq[:1], embedds=emb, device="cpu")
    g_out = {k: v.cpu() for k, v in out["cuda"].items()}
    c_out = out["cpu"]
    d_logits = (g_out["distogram_logits"] - c_out["distogram_logits"]).abs().max().item()
    conf = [distogram_confidence(torch.softmax(o["distogram_logits"], dim=-1))
            for o in (g_out, c_out)]
    d_conf = (conf[0] - conf[1]).abs().max().item()
    sel = c_out["cloud_mask"][0].reshape(-1)
    clouds = [o["refined"][0].reshape(-1, 3)[sel] for o in (g_out, c_out)]
    d_dist = (pairwise(clouds[0]) - pairwise(clouds[1])).abs().max().item()
    phis = [phi_ratio(o["refined"]) for o in (g_out, c_out)]
    moved = (c_out["refined"] - c_out["proto"]).abs().max().item()
    finite = all(bool(torch.isfinite(v.float()).all()) for v in g_out.values())
    n = E2E_TRUNK_FLASH * cfg.depth
    want_emb = {k: {"flash_fwd": 2, "flash_fwd_f32": 2}.get(k, 0) for k in emb_launches}
    want_e2e = {k: {"flash_fwd": n, "flash_fwd_f32": n}.get(k, 0) for k in e2e_launches}
    ok = (d_repr <= repr_tol and d_logits <= 1e-4 and d_conf <= 1e-5 and d_dist <= 1e-2
          and phis[0] == phis[1] and moved > 1e-3 and finite and emb_launches == want_emb
          and e2e_launches == want_e2e)
    log(f"[full-atom a] embedder (2 layers, 1280, 20 heads, batch 2, padded, <mask>), f32 card "
        f"vs cpu: representations |d|={d_repr:.2e} (tol {repr_tol:.2e}); e2e L={L} (grid "
        f"{3 * L}), ESM embeddings, 20 MDS iterations: logits |d|={d_logits:.2e} (1e-4), "
        f"confidence |d|={d_conf:.2e} (1e-5), refined distances |d|={d_dist:.2e} A (1e-2), "
        f"phi ratio card {phis[0]} cpu {phis[1]}, the refiner moved atoms {moved:.3f} A; "
        f"launches embed {dict((k, v) for k, v in emb_launches.items() if v)}, e2e "
        f"{dict((k, v) for k, v in e2e_launches.items() if v)} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["full_atom_parity"] = {
        "repr": d_repr, "repr_tol": repr_tol, "logits": d_logits, "confidence": d_conf,
        "distances": d_dist, "phi_ratio": phis, "refiner_moved": moved, "finite": finite,
        "embed_launches": emb_launches, "e2e_launches": e2e_launches, "ok": ok}
    if not ok:
        fail("the full-atom path: the card and the CPU disagree, or launches differ "
             "(phase 11a)")


def phase_esm1b(params, reps=5):
    """(b) ESM-1b at full width (33 layers, 1280, 20 heads, max_len 1024;
    random weights drawn on the card) at L = 128 and 384 residues, f32
    and bf16: ms (CUDA events, median of `reps` after a warm-up), B1f
    launches (33 an embed; every bf16 one on the wgmma route), peak
    memory, and each residue's bf16 representation's cosine with f32
    (>= 0.99). Then B1f alone at the embedder's shapes, (20, L + 2, L + 2)
    at dh 64 in bf16 and f32, against its plain version, with the
    mma_sync route, SDPA and the bound (phase 3's check)."""
    cfg = EmbedderConfig()
    rows, kernel_rows = [], []
    for L in ESM1B_LENGTHS:
        seq = np.random.default_rng(L).integers(0, 20, (1, L)).astype(np.int32)
        reps_out = {}
        for dtype in (torch.float32, torch.bfloat16):
            c = dataclasses.replace(cfg, dtype=dtype)
            with torch.inference_mode():
                embed_sequences(params, c, seq)
                sync()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                reps_out[dtype] = embed_sequences(params, c, seq).float()
                sync()
                launches = launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                ms = sorted(forward_ms(lambda: embed_sequences(params, c, seq), reps))[reps // 2]
            route = "wgmma" if dtype == torch.bfloat16 else "f32"
            want = {k: {"flash_fwd": ESM1B_FLASH, f"flash_fwd_{route}": ESM1B_FLASH}.get(k, 0)
                    for k in launches}
            finite = bool(torch.isfinite(reps_out[dtype]).all())
            row = {"L": L, "dtype": str(dtype), "ms": ms, "peak_gib": peak, "launches": launches,
                   "finite": finite, "ok": finite and launches == want}
            rows.append(row)
        cos = F.cosine_similarity(reps_out[torch.bfloat16], reps_out[torch.float32], dim=-1)
        rows[-1]["min_cosine"] = cos.min().item()
        rows[-1]["ok"] = rows[-1]["ok"] and rows[-1]["min_cosine"] >= 0.99
        for r in rows[-2:]:
            log(f"[full-atom b] ESM-1b (33 x 1280, 20 heads) L={L} {r['dtype'].split('.')[-1]}: "
                f"{r['ms']:.2f} ms (events, median of {reps}), peak {r['peak_gib']:.2f} GiB, "
                f"launches {dict((k, v) for k, v in r['launches'].items() if v)}"
                + (f", min residue cosine bf16 vs f32 {r['min_cosine']:.5f} (>= 0.99)"
                   if "min_cosine" in r else "") + f" {'ok' if r['ok'] else 'FAIL'}")
        for dtype in (torch.bfloat16, torch.float32):
            kernel_rows.append(check_kernel("flash_fwd", f"ESM-1b L={L}", 20, L + 2, L + 2, 64,
                                            dtype, timed=True))
    RECORD["phases"]["esm1b"] = rows
    RECORD["phases"]["esm1b_kernels"] = kernel_rows
    if not all(r["ok"] for r in rows):
        fail("ESM-1b at full width: not finite, launches off B1f's wgmma route in bf16, or "
             "bf16 strays from f32 (phase 11b)")
    if not all(r["ok"] for r in kernel_rows) or any(
            r["route"] != "wgmma" for r in kernel_rows if "bfloat16" in r["dtype"]):
        fail("B1f at the embedder's shapes disagrees with its plain version or left the "
             "wgmma route in bf16 (phase 11b)")


class StageEvents:
    """A `stage` hook for `e2e.predict_structure` (and the embed before it):
    CUDA events around each stage, read after a sync."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.events.setdefault(name, []).append((start, end))

    def ms(self):
        sync()
        return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self.events.items()}


@contextlib.contextmanager
def kept_flash_calls(kept):
    """While open, the first B1f call at each (q shape, k shape, dtype)
    keeps its inputs and outputs in `kept` (clones): the path's own
    tensors, held against the plain version afterwards."""
    launch = flash_kernel.flash_fwd

    def keeping(q, k, v, bias, scale):
        out, lse = launch(q, k, v, bias, scale)
        key = (tuple(q.shape), tuple(k.shape), str(q.dtype))
        if key not in kept:
            kept[key] = tuple(t.clone() for t in (q, k, v, bias)) + (scale, out.clone(),
                                                                      lse.clone())
        return out, lse

    flash_kernel.flash_fwd = keeping
    try:
        yield kept
    finally:
        flash_kernel.flash_fwd = launch


def sampled(n, k, gen):
    """At most k indices of range(n), on the card: the first and last k // 4
    (the largest offsets) and the rest drawn between them, sorted."""
    if n <= k:
        return torch.arange(n, device="cuda")
    edge = k // 4
    mid = torch.randperm(n - 2 * edge, generator=gen)[:k - 2 * edge].sort().values + edge
    return torch.cat([torch.arange(edge), mid, torch.arange(n - edge, n)]).cuda()


def check_path_flash(label, call, reps=2):
    """B1f's output and lse from the path's own launch, held against its
    plain version on the same inputs: at most 64 of the (batch x head)
    rows and 256 query rows, each against all keys (the full plain run of
    a (9L^2)^2 cross is out of reach), with phase 3's tolerance. Then
    the kernel's ms on those inputs (CUDA events, mean of `reps`) beside
    its bound and SDPA's ms on the same inputs: unmasked where every key
    is kept (the synthetic request's mask is all ones, so its bias is 0
    and an unmasked call computes the same function), else with the bias
    as its additive mask."""
    q, k, v, bias, scale, out, lse = call
    BH, i, dh = q.shape
    gen = torch.Generator().manual_seed(i)
    bh, rows = sampled(BH, 64, gen), sampled(i, 256, gen)
    ref_out, ref_lse = flash_kernel.flash_fwd_plain(q[bh][:, rows].contiguous(), k[bh], v[bh],
                                                    bias[bh], scale)
    got, got_lse = out[bh][:, rows], lse[bh][:, rows]
    ref_max = ref_out.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if q.dtype == torch.float32 else BF16_ULP * ref_max
    err = (got.float() - ref_out.float()).abs().max().item()
    lse_err = (got_lse - ref_lse).abs().max().item()
    which = flash_kernel.route(q, k, v, bias)
    ok = err <= tol and lse_err <= 1e-4 and bool(torch.isfinite(out).all())
    t_ops, t_bytes = bound_terms(q, k, v, bias, None)
    row = {"kernel": "flash_fwd", "case": label, "shape": [BH, i, k.shape[1], dh],
           "dtype": str(q.dtype), "route": which, "probechecked": [len(bh), len(rows)],
           "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
           "kernel_ms": time_ms(lambda: flash_kernel.flash_fwd(q, k, v, bias, scale), reps),
           "unmasked": bool((bias == 0).all()),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ok": ok}
    row["library_ms"] = (sdpa_mask_ms(q, k, v, None, scale, reps) if row["unmasked"]
                         else library_ms(q, k, v, bias, None, scale, reps))
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.3f}"
    log(f"[full-atom c] B1f {label:24s} {str(tuple(row['shape'])):30s} "
        f"{str(q.dtype).split('.')[-1]:8s} {which:8s} {len(bh)} x {len(rows)} rows vs plain: "
        f"max|d|={err:.3e} (tol {tol:.3e}) lse|d|={lse_err:.2e} kernel_ms={row['kernel_ms']:.3f} "
        f"sdpa_ms={lib}{'' if row['unmasked'] else ' (masked)'} "
        f"bound_ms={row['bound_ms']:.3f} {'ok' if ok else 'FAIL'}")
    return row


def phase_full_atom_request(esm_params, reps=3):
    """(c) The full-atom request at the serving config (dim 256, depth 2,
    heads 8, dim_head 64, bf16 trunk, f32 geometry, 200 MDS iterations,
    classical init, refiner depth 2) at L = 128 (grid 384) and 256 (grid
    768), on ESM-1b (bf16) embeddings: the embed and `e2e.predict_structure`.
    A warm-up request keeps the first B1f launch at each of its shapes
    (the embedder's, the pair grid's axial (8 x 3L, 3L, 3L) and the
    embedds stream's cross (8, 9L^2, 9L^2)), each held against the plain
    version. One request (synchronised): its host ms, peak memory,
    finiteness and flash launches (counts set to 0 just before it, read
    just after: 33 for the embed and 6 a trunk layer, every one on the
    wgmma route). Then `reps` requests with CUDA events around each stage
    (the `stage` hook of `predict_structure`): medians."""
    rows = []
    for L in FULL_ATOM_LENGTHS:
        cfg = served_config(max_seq_len=3 * L, num_embedds=EmbedderConfig().dim)
        ecfg = e2e.E2EConfig(model=cfg, mds_iters=200, mds_init="classical")
        params = full_atom_params(ecfg, "cuda")
        seq = np.random.default_rng(100 + L).integers(0, 20, (1, L)).astype(np.int32)
        esm_cfg = EmbedderConfig(dtype=torch.bfloat16)

        def request(stage=None):
            with (stage or (lambda name: contextlib.nullcontext()))("embed"):
                emb = torch.repeat_interleave(
                    embed_sequences(esm_params, esm_cfg, seq).float(), 3, dim=1)
            return e2e.predict_structure(params, ecfg, seq, embedds=emb, device="cuda",
                                         stage=stage)

        with torch.inference_mode():
            with kept_flash_calls({}) as kept:
                request()
            sync()
            kernel_rows = [check_path_flash(f"full-atom L={L} {'x'.join(map(str, key[0]))}",
                                            call) for key, call in kept.items()]
            del kept
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            out = request()
            sync()
            host = (time.perf_counter() - t0) * 1e3
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            timer = StageEvents()
            for _ in range(reps):
                request(timer)
            stage_ms = timer.ms()
            med = {name: sorted(v)[reps // 2] for name, v in stage_ms.items()}
            finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values()
                         if v.is_floating_point())
        n = ESM1B_FLASH + E2E_TRUNK_FLASH * cfg.depth
        want = {k: {"flash_fwd": n, "flash_fwd_wgmma": n}.get(k, 0) for k in launches}
        kernels_ok = (all(r["ok"] and r["route"] == "wgmma" for r in kernel_rows)
                      and any(r["shape"][1] == 9 * L * L for r in kernel_rows))
        ok = finite and launches == want and kernels_ok
        row = {"L": L, "grid": 3 * L, "atoms": 14 * L, "stage_ms": med, "stage_samples": stage_ms,
               "host_ms": host, "peak_gib": peak, "finite": finite, "launches": launches,
               "kernels": kernel_rows, "ok": ok}
        rows.append(row)
        log(f"[full-atom c] served config bf16, L={L} (grid {3 * L}, {14 * L} atoms), 200 MDS "
            f"iterations: " + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
            + f" ms (events, medians of {reps}); the request {host:.1f} ms (host); peak "
            f"{peak:.2f} GiB; finite={finite}; launches "
            f"{dict((k, v) for k, v in launches.items() if v)} (expected {n}, all wgmma); "
            f"B1f at the path's {len(kernel_rows)} shapes vs plain "
            f"{'ok' if kernels_ok else 'FAIL'} {'ok' if ok else 'FAIL'}")
        del params, out
        torch.cuda.empty_cache()
    RECORD["phases"]["full_atom_request"] = rows
    if not all(r["ok"] for r in rows):
        fail("the full-atom request is not finite, left B1f's wgmma route, or B1f at its "
             "shapes disagrees with the plain version (phase 11c)")
    return rows


def phase_full_atom_cli(L=64):
    """(d) `python -m alphafold2_tpu_torch.predict --full-atom` in a process
    of its own on one sequence of 64 residues: rc 0, a PDB of 4 L atoms
    (N, CA, C, O) that parses back, and the printed mean confidence."""
    seq = "".join(np.random.default_rng(64).choice(list(AA_ORDER), L))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    pdb = out_dir / "full_atom.pdb"
    cmd = [sys.executable, "-m", "alphafold2_tpu_torch.predict", "--seq", seq, "--full-atom",
           "--bf16", "--out", str(pdb)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    conf = [line for line in lines if line.startswith("mean confidence")]
    atoms = []
    if res.returncode == 0 and pdb.exists():
        s = parse_pdb(str(pdb))
        atoms = [a.name for a in s.atoms]
        finite = bool(np.isfinite(s.coords()).all())
    else:
        finite = False
    ok = (res.returncode == 0 and atoms == ["N", "CA", "C", "O"] * L and finite
          and len(conf) == 1)
    log(f"[full-atom d] predict --full-atom --bf16, {L} residues: rc {res.returncode} in "
        f"{seconds:.1f} s; {len(atoms)} atoms; " + " | ".join(lines)
        + f" {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["full_atom_cli"] = {"cmd": cmd[1:], "rc": res.returncode, "stdout": lines,
                                         "stderr_tail": res.stderr[-2000:], "atoms": len(atoms),
                                         "seconds": seconds, "ok": ok}
    if not ok:
        fail(f"predict --full-atom on the card failed (phase 11d): {res.stderr[-1000:]}")


def phase_full_atom():
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"full_atom_{key}_s"] = time.perf_counter() - t
        log(f"[time] full-atom {key}: {RECORD['phases'][f'full_atom_{key}_s']:.1f} s")
        return result

    timed("a", phase_full_atom_parity)
    esm_params = embedder_init(EmbedderConfig(), torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    timed("b", phase_esm1b, esm_params)
    timed("c", phase_full_atom_request, esm_params)
    del esm_params
    torch.cuda.empty_cache()
    timed("d", phase_full_atom_cli)


# --- phase 12: end-to-end structure training ----------------------------------------

E2E_CROP = 384    # (b)'s residues: the north-star crop, a 1152-token grid
E2E_ROWS = 128    # (b)'s MSA rows (the north-star preset's)
E2E_WORK = ROOT / "build" / "phase12"  # the CLI's checkpoints, removed at the phase's end
SOLVER_MARKERS = ("syev", "sytrd", "sytd2", "ormtr", "orgtr", "stedc", "steqr", "gesvd",
                  "larf", "lascl", "cusolver", "magma", "jacobi")


def e2e_north_star(crop, **model):
    """The port's north-star preset (`training/presets.py
    north_star_e2e_config`) at depth 2, less reversibility: dim 256, 8
    heads of 64, tied MSA rows, the column-aligned crosses with KV
    compression 4, ff_chunk_size 32768, `remat` in place of the reversible
    trunk, bf16; refiner dim 64, depth 2, atom chunks of 256; 25 MDS
    iterations from the classical init; the port's attention defaults.
    `model`: further overrides of the model config."""
    ecfg, _, _ = presets.north_star_e2e_config(2, model_overrides={
        "reversible": False, "remat": True, "max_seq_len": max(2048, 3 * crop), **model})
    return ecfg


def structure_fetch(crop, rows, grad_accum, seed, batch_size=1):
    return synthetic_microbatch_fn(DataConfig(batch_size=batch_size, max_len=crop,
                                              msa_rows=rows, seed=seed), grad_accum,
                                   source=synthetic_structure_batches)


def e2e_parity_state(ecfg, tcfg, device):
    """A seeded e2e train state on `device` whose refiner coordinate head
    has seeded random weights (it is zero at init): the same numbers on
    every device."""
    state = e2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), device)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer in state["params"]["refiner"]["layers"]:
            for t in layer["coord_mlp"]["l2"].values():
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return state


def phase_e2e_parity(L=24, rows=8):
    """(a) f32, 3 e2e steps of 2 microbatches on the card and on the CPU
    from the same params (the refiner's coordinate head given the same
    random weights on both: it is zero at init) and batches: dim 256,
    depth 1, 8 heads of 64, L = 24 (grid 72), an 8-row MSA (flat crosses),
    20 MDS iterations from the classical init, refiner dim 64 depth 2.
    Phase 6a's comparison and tolerances (`card_vs_cpu_steps`); the
    classical init's eigenvectors may differ in sign between the card's and
    the CPU's `eigh`, which moves neither the loss nor its gradients (the
    mirror fix, then the Kabsch alignment). Every flash launch on the f32
    route: 6 forwards a layer a microbatch, and as many dq and dkv but the
    last layer's msa<-pair cross, whose output reaches no loss."""
    cfg = Alphafold2Config(dim=256, depth=1, heads=8, dim_head=64, max_seq_len=3 * L)
    ecfg = e2e.E2EConfig(model=cfg, refiner=RefinerConfig(num_tokens=14, dim=64, depth=2),
                         mds_iters=20, mds_init="classical")
    tcfg = TrainConfig(grad_accum=2)
    states, steps = {}, {}
    for dev in ("cuda", "cpu"):
        states[dev] = e2e_parity_state(ecfg, tcfg, dev)
        steps[dev] = make_train_step(ecfg, tcfg, loss_fn=e2e.e2e_loss_fn, device=dev)
    fwd = E2E_TRUNK_FLASH * cfg.depth * tcfg.grad_accum * 3
    bwd = (E2E_TRUNK_FLASH * cfg.depth - 1) * tcfg.grad_accum * 3
    card_vs_cpu_steps("e2e a", "e2e_parity", f"L={L} (grid {3 * L}) f32 depth {cfg.depth}, "
                      f"{rows} MSA rows, 20 MDS iterations", repr(ecfg), states, steps,
                      structure_fetch(L, rows, 2, seed=5), tcfg,
                      {"flash_fwd": fwd, "flash_fwd_f32": fwd, "flash_bwd_dq": bwd,
                       "flash_bwd_dq_f32": bwd, "flash_bwd_dkv": bwd, "flash_bwd_dkv_f32": bwd})


@contextlib.contextmanager
def kept_train_calls(kept, counts):
    """While open, every B1f and B1b call is counted by its shape in
    `counts`, and the first at each (kind, q shape, k shape, dtype) keeps
    in `kept` its routes, whether its bias is 0 everywhere, and clones of
    a sample of its rows: at most 64 (batch x head) rows (`sampled`), the
    forward's at most 256 query rows of each against all keys; the
    backward's every row of those (dq, dk and dv each read them all)."""
    fwd, bwd = flash_kernel.flash_fwd, flash_kernel.flash_bwd
    gen = torch.Generator().manual_seed(12)

    def key_of(kind, q, k):
        key = (kind, tuple(q.shape), tuple(k.shape), str(q.dtype))
        counts[key] = counts.get(key, 0) + 1
        return key if key not in kept else None

    def keeping_fwd(q, k, v, bias, scale):
        out, lse = fwd(q, k, v, bias, scale)
        key = key_of("fwd", q, k)
        if key is not None:
            bh, rows = sampled(q.shape[0], 64, gen), sampled(q.shape[1], 256, gen)
            kept[key] = {"route": flash_kernel.route(q, k, v, bias),
                         "unmasked": bool((bias == 0).all()), "scale": scale,
                         "q": q[bh][:, rows].clone(), "k": k[bh].clone(), "v": v[bh].clone(),
                         "bias": bias[bh].clone(), "out": out[bh][:, rows].clone(),
                         "lse": lse[bh][:, rows].clone()}
        return out, lse

    def keeping_bwd(q, k, v, bias, out, lse, g, scale):
        dq, dk, dv = bwd(q, k, v, bias, out, lse, g, scale)
        key = key_of("bwd", q, k)
        if key is not None:
            bh = sampled(q.shape[0], 64, gen)
            kept[key] = {"dq_route": flash_kernel.dq_route(q, k, v, bias),
                         "dkv_route": flash_kernel.dkv_route(q, k, v, bias),
                         "unmasked": bool((bias == 0).all()), "scale": scale,
                         **{name: t[bh].clone() for name, t in
                            (("q", q), ("k", k), ("v", v), ("bias", bias), ("out", out),
                             ("lse", lse), ("g", g), ("dq", dq), ("dk", dk), ("dv", dv))}}
        return dq, dk, dv

    flash_kernel.flash_fwd, flash_kernel.flash_bwd = keeping_fwd, keeping_bwd
    try:
        yield kept
    finally:
        flash_kernel.flash_fwd, flash_kernel.flash_bwd = fwd, bwd


def e2e_shape_row(key, call, per_step, reps=3):
    """One kept B1f or B1b call of the e2e step held against its plain
    version on its sampled rows (phase 3's tolerances: the forward one bf16
    ulp of the largest output and lse 1e-4; the backward elementwise,
    `flash_bwd_bf16_bound`), then timed at its shape on seeded inputs with
    every key kept (the step's bias is 0 everywhere: the synthetic mask is
    all ones): the kernel (dq and dkv apart), SDPA unmasked (the same
    function there; the backward for the gradients each kernel gives) and
    the bound."""
    kind, qs, ks, dtype = key
    BH, i, dh = qs
    j = ks[1]
    scale = call["scale"]
    q, k, v, bias, _ = make_inputs(BH, i, j, dh, torch.bfloat16 if "bfloat16" in dtype
                                   else torch.float32, key_drop=0.0, seed=12)
    row = {"kernel": f"flash_{kind}", "shape": [BH, i, j, dh], "dtype": dtype,
           "launches_per_step": per_step, "unmasked": call["unmasked"]}
    if kind == "fwd":
        ref_out, ref_lse = flash_kernel.flash_fwd_plain(call["q"], call["k"], call["v"],
                                                        call["bias"], scale)
        ref_max = ref_out.float().abs().max().item()
        tol = BF16_ULP * ref_max if "bfloat16" in dtype else 1e-5 * max(1.0, ref_max)
        err = (call["out"].float() - ref_out.float()).abs().max().item()
        lse_err = (call["lse"] - ref_lse).abs().max().item()
        t_ops, t_bytes = bound_terms(q, k, v, bias, None)
        row.update(route=call["route"], max_abs_err=err, tol=tol, lse_max_abs_err=lse_err,
                   ok=err <= tol and lse_err <= 1e-4 and call["route"] == "wgmma",
                   kernel_ms=time_ms(lambda: flash_kernel.flash_fwd(q, k, v, bias, scale), reps),
                   library_ms=sdpa_mask_ms(q, k, v, None, scale, reps),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        return row
    args = [call[n] for n in ("q", "k", "v", "bias", "out", "lse", "g")]
    bounds = flash_bwd_bf16_bound(*args, scale)
    refs = flash_kernel.flash_bwd_plain(*args, scale)[:3]
    worst = max(((call[n].float() - r.float()).abs() / b).max().item()
                for n, r, b in zip(("dq", "dk", "dv"), refs, bounds))
    out, lse = flash_kernel.flash_fwd(q, k, v, bias, scale)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(13),
                    device="cuda").to(q.dtype)
    kargs = (q, k, v, bias, lse) + flash_kernel.cotangent_terms(out, g)[:2] + (scale,)
    row.update(dq_route=call["dq_route"], dkv_route=call["dkv_route"], worst_over_bound=worst,
               ok=worst <= 1.0 and call["dq_route"] == call["dkv_route"] == "wgmma",
               dq_ms=time_ms(lambda: flash_kernel.launch_dq(*kargs, "flash_bwd_dq"), reps),
               dkv_ms=time_ms(lambda: flash_kernel.launch_dkv(*kargs, "flash_bwd_dkv"), reps),
               dq_library_ms=sdpa_mask_ms(q, k, v, None, scale, reps, g=g, wrt="q"),
               dkv_library_ms=sdpa_mask_ms(q, k, v, None, scale, reps, g=g, wrt="kv"))
    for side, dq_side in (("dq", True), ("dkv", False)):
        t_ops, t_bytes = bwd_bound_terms(q, k, bias, dq_side)
        row[f"{side}_bound_ms"] = max(t_ops, t_bytes)
        row[f"{side}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return row


def profile_step(fn):
    """fn once under torch.profiler: device ms by kind (profiling.py's
    kinds, with cuSOLVER's eigh and SVD kernels apart from "other"), the
    busy ms (the union of the kernels' intervals in its trace), the host
    ms around it, and the ten slowest kernel names of "other". Device
    activity only: the host's ops would multiply the trace's events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        host = (time.perf_counter() - t0) * 1e3
    kinds, other = {}, []
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CUDA or getattr(a, "is_user_annotation",
                                                                      False):
            continue
        us = getattr(a, "self_device_time_total", None)
        ms = (us if us is not None else a.self_cuda_time_total) / 1e3
        kind = profiling.kernel_kind(a.key)
        if any(m in a.key.lower() for m in SOLVER_MARKERS):
            kind = "eigh / SVD (cuSOLVER)"
        elif kind.startswith("other"):
            other.append((ms, a.key[:80], a.count))
        row = kinds.setdefault(kind, {"device_ms": 0.0, "launches": 0})
        row["device_ms"] += ms
        row["launches"] += a.count
    path = E2E_WORK / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    path.unlink()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"kinds": kinds, "busy_ms": busy / 1e3, "host_ms": host,
            "other_top": sorted(other, reverse=True)[:10]}


def time_e2e_step(ecfg, crop, rows, accum, reps, first_step=contextlib.nullcontext):
    """The eager e2e train step (`make_train_step`, `e2e_loss_fn`, lr 3e-4)
    of a seeded state on `crop`-residue structures with `rows` MSA rows,
    `accum` microbatches a step: one untimed step (inside `first_step()`),
    then, launch counts set to 0 and the peak memory reset just before,
    `reps` timed steps (CUDA events around each), read just after. Returns
    the state, step and fetch (for more steps), the times and their
    median, the metrics, the untimed step's metrics and seconds, the
    launches, the peak GiB, `train_step_flops(cfg, 3 crop, rows, crop,
    accum)` and MFU (over 989 TFLOP/s bf16)."""
    tcfg = TrainConfig(grad_accum=accum)
    state = e2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    fetch = structure_fetch(crop, rows, accum, seed=9)
    step = make_train_step(ecfg, tcfg, loss_fn=e2e.e2e_loss_fn, device="cuda")
    t0 = time.perf_counter()
    with first_step():
        _, first = step(state, fetch(0))
    first = {k: float(v) for k, v in first.items()}
    untimed_s = time.perf_counter() - t0
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, metrics = [], []
    for n in range(1, reps + 1):
        batch = fetch(n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, batch)
        end.record()
        sync()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = launch_counts()
    step_ms = sorted(times)[reps // 2]
    flops = train_step_flops(ecfg.model, 3 * crop, rows, crop, grad_accum=accum)
    return {"state": state, "step": step, "fetch": fetch, "times": times, "step_ms": step_ms,
            "metrics": metrics, "first": first, "untimed_s": untimed_s, "launches": launches,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "flops": flops,
            "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]}


def north_star_step(depth=48):
    """The port's north-star preset (`north_star_e2e_config(depth)`: crop
    384, 128 MSA rows, bf16, reversible) for one timed step of one
    microbatch after an untimed one (`time_e2e_step`). Not a phase of the
    script: run it as

        python3 -c "import chip_smoke as c; c.north_star_step(48)"

    It logs the card, step ms, MFU, peak memory and the launches, and
    writes them to chiprun_out/north_star_step.json."""
    smi = phase_card()
    ecfg, crop, rows = presets.north_star_e2e_config(depth)
    run = time_e2e_step(ecfg, crop, rows, 1, 1)
    row = {"card": smi, "config": f"north_star_e2e_config({depth})", "crop": crop,
           "rows": rows, "accum": 1,
           "params": sum(t.numel() for t in run["state"]["optimizer"].leaves), "untimed_step_s": run["untimed_s"], "step_ms": run["step_ms"],
           "train_step_flops": run["flops"], "mfu": run["mfu"], "peak_gib": run["peak_gib"],
           "metrics": run["metrics"], "launches": {k: v for k, v in run["launches"].items() if v}}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "north_star_step.json").write_text(json.dumps(row, indent=1))
    log(json.dumps(row))
    return row


def phase_e2e_step(crop=E2E_CROP, rows=E2E_ROWS, reps=5):
    """(b) The e2e step at the north-star model's widths less reversibility
    (`e2e_north_star`), crop `crop` (a (3 crop)^2 grid), `rows` MSA rows,
    batch 1, 2 microbatches, lr 3e-4, eager (`make_train_step`; the
    capture refuses it, A8-e2e-capture). One untimed step, in which (c)
    keeps the first B1f and B1b launch at each shape (`kept_train_calls`).
    Then, counts set to 0 and the peak memory reset just before, `reps`
    timed steps (CUDA events around each; the median), read just after:
    launches (every B1f, dq and dkv launch on its wgmma route), peak
    memory, finite losses. MFU = `train_step_flops(cfg, 3 crop, rows,
    crop, 2)` / step time / 989 TFLOP/s. One more step under torch.profiler
    (device ms by kind, busy share = busy ms / the step's host ms), and
    one more microbatch by stage: CUDA events around each stage of
    `predict_structure` (its `stage` hook), `structure_loss` and the
    backward, with the bytes its forward leaves saved for the backward and
    the backward's peak.
    (c) Each kept launch against its plain version, timed at its shape
    (`e2e_shape_row`). Returns the counted run's launches."""
    ecfg = e2e_north_star(crop)
    kept, per_shape = {}, {}
    run = time_e2e_step(ecfg, crop, rows, 2, reps,
                        first_step=lambda: kept_train_calls(kept, per_shape))
    state, step, fetch = run["state"], run["step"], run["fetch"]
    times, metrics, first = run["times"], run["metrics"], run["first"]
    launches, peak, untimed_s = run["launches"], run["peak_gib"], run["untimed_s"]
    prof = profile_step(lambda: step(state, fetch(reps + 1)))
    timer = StageEvents()
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in fetch(reps + 2).items()}
    sync()
    held = torch.cuda.memory_allocated()
    out = e2e.predict_structure(state["params"], ecfg, mb["seq"], mask=mb["mask"],
                                msa=mb["msa"], msa_mask=mb["msa_mask"], device="cuda",
                                stage=timer)
    with timer("loss"):
        loss = e2e.structure_loss(out, ecfg, mb)
    del out
    sync()
    saved = (torch.cuda.memory_allocated() - held) / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with timer("backward"):
        loss.backward()
    stages = {name: v[0] for name, v in timer.ms().items()}
    backward_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    del loss, mb
    step_ms, flops, mfu = run["step_ms"], run["flops"], run["mfu"]
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in metrics + [first])
    per = {k: v / reps for k, v in launches.items() if v}
    wgmma = on_wgmma(launches)
    del run, state, step
    torch.cuda.empty_cache()
    t_rows = time.perf_counter()
    kernel_rows = [e2e_shape_row(key, call, per_shape[key]) for key, call in sorted(kept.items())]
    t_rows = time.perf_counter() - t_rows
    del kept
    torch.cuda.empty_cache()
    busy = prof["busy_ms"] / prof["host_ms"]
    row = {"crop": crop, "grid": 3 * crop, "rows": rows, "config": repr(ecfg),
           "step_ms": times, "median_step_ms": step_ms, "untimed_step_s": untimed_s,
           "train_step_flops": flops, "mfu": mfu, "peak_gib": peak, "metrics": metrics,
           "first": first, "launches": launches, "launches_per_step": per, "profile": prof,
           "busy_share": busy, "microbatch_stage_ms": stages,
           "microbatch_saved_gib": saved, "microbatch_backward_peak_gib": backward_peak,
           "kernels": kernel_rows,
           "launches_per_shape_per_step": {str(k): v for k, v in per_shape.items()}}
    RECORD["phases"]["e2e_step"] = row
    log(f"[e2e b] north-star widths (dim 256, depth 2, remat, aligned crosses, compress 4, "
        f"tied rows, bf16), crop {crop} (grid {3 * crop}), {rows} MSA rows, accum 2, eager: "
        f"step {step_ms:.1f} ms median of {reps} ({', '.join(f'{t:.1f}' for t in times)}), "
        f"MFU {mfu:.4f} of 989 TFLOP/s ({flops / 1e12:.2f} TFLOP a step), peak {peak:.2f} GiB, "
        f"busy {busy:.3f} ({prof['busy_ms']:.1f} of {prof['host_ms']:.1f} ms), losses "
        f"{[round(m['loss'], 4) for m in metrics]}; launches a step {per}; the untimed step "
        f"{untimed_s:.1f} s, (c)'s checks and timings {t_rows:.1f} s")
    log("[e2e b] device ms by kind: " + ", ".join(
        f"{k} {v['device_ms']:.1f} ({v['launches']})"
        for k, v in sorted(prof["kinds"].items(), key=lambda kv: -kv[1]["device_ms"])))
    log("[e2e b] one microbatch by stage (events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()) + f" ms; its forward saved {saved:.2f} GiB "
        f"for the backward, whose peak is {backward_peak:.2f} GiB over the state")
    for r in kernel_rows:
        if r["kernel"] == "flash_fwd":
            detail = (f"{r['route']:6s} max|d|={r['max_abs_err']:.3e} (tol {r['tol']:.3e}) "
                      f"lse|d|={r['lse_max_abs_err']:.2e} kernel_ms={r['kernel_ms']:.3f} "
                      f"sdpa_ms={r['library_ms']} bound_ms={r['bound_ms']:.3f}")
        else:
            detail = (f"dq {r['dq_route']} dkv {r['dkv_route']} worst/bound="
                      f"{r['worst_over_bound']:.3f} dq_ms={r['dq_ms']:.3f} dkv_ms="
                      f"{r['dkv_ms']:.3f} sdpa dq={r['dq_library_ms']} dkv={r['dkv_library_ms']} "
                      f"bound dq={r['dq_bound_ms']:.3f} dkv={r['dkv_bound_ms']:.3f}")
        log(f"[e2e c] {r['kernel']:9s} {str(tuple(r['shape'])):26s} x{r['launches_per_step']} a "
            f"step: {detail} {'ok' if r['ok'] else 'FAIL'}")
    if not finite:
        fail("the e2e step at the north-star widths gave a non-finite loss or grad_norm "
             "(phase 12b)")
    if not wgmma:
        fail(f"the e2e step launched off the wgmma routes: {launches} (phase 12b)")
    kinds = {r["kernel"] for r in kernel_rows}
    if kinds != {"flash_fwd", "flash_bwd"} or not all(r["ok"] for r in kernel_rows):
        fail("B1f or B1b at the e2e step's shapes disagrees with its plain version, left the "
             "wgmma route, or was not launched (phase 12c)")
    return launches


def phase_e2e_overfit(crop=128, rows=E2E_ROWS, steps=20):
    """(d) 20 steps on one repeated microbatch at (b)'s widths, crop 128
    (grid 384), lr 1e-3, one microbatch a step: the least of the last 5
    losses at most 0.9 of the first."""
    ecfg = e2e_north_star(crop)
    tcfg = TrainConfig(learning_rate=1e-3, grad_accum=1)
    state = e2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    batch = structure_fetch(crop, rows, 1, seed=3)(0)
    step = make_train_step(ecfg, tcfg, loss_fn=e2e.e2e_loss_fn, device="cuda")
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
    ok = all(math.isfinite(x) for x in losses) and min(losses[-5:]) <= 0.9 * losses[0]
    RECORD["phases"]["e2e_overfit"] = {"losses": losses, "ok": ok}
    return ok, losses


def cli_run(argv):
    """train_end2end's main in this process, on the card (no --device):
    (its state, its last metrics, the lines it printed, seconds)."""
    t0 = time.perf_counter()
    (state, metrics), lines = quiet(train_end2end.main, argv)
    sync()
    return state, metrics, lines, time.perf_counter() - t0


def phase_e2e_cli():
    """(d) `python -m alphafold2_tpu_torch.train_end2end` on the card:
    --steps 3 --dim 256 --heads 8 --dim-head 64 --len 64 --msa-rows 20
    --bf16 in a process of its own (rc 0, finite losses); then its `main`
    in this process with --features esm at ESM-1b's width (1280, 33
    layers, 20 heads, random weights; the embedder in f32 as the JAX CLI
    runs it: its 33 B1f launches a microbatch on the f32 route, every
    other B1f, dq and dkv launch, the flat crosses over the 192^2 grid
    among them, on the wgmma route), with --features none, and a resume:
    3 steps against 2 steps saved then 1 resumed, bit for bit (every
    param, moment and count); and
    the overfit check (`phase_e2e_overfit`)."""
    base = ["--dim", "256", "--heads", "8", "--dim-head", "64", "--len", "64", "--bf16"]
    rows = []
    cmd = [sys.executable, "-m", "alphafold2_tpu_torch.train_end2end", "--steps", "3", *base,
           "--msa-rows", "20"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    losses = [float(x.split()[3]) for x in lines if x.startswith("step ")]
    ok = res.returncode == 0 and "done" in lines and len(losses) == 2 and all(
        math.isfinite(x) for x in losses)
    rows.append({"run": "msa (process)", "cmd": cmd[1:], "rc": res.returncode, "stdout": lines,
                 "stderr_tail": res.stderr[-2000:], "seconds": time.perf_counter() - t0,
                 "ok": ok})
    reset_launches()
    state, metrics, lines, secs = cli_run([*base, "--steps", "2", "--features", "esm",
                                           "--esm-dim", "1280", "--esm-layers", "33",
                                           "--esm-heads", "20"])
    launches = launch_counts()
    embeds = ESM1B_FLASH * 2 * 2  # 2 steps of 2 microbatches (the CLI's --accum)
    trunk = {k: v - (embeds if k in ("flash_fwd", "flash_fwd_f32") else 0)
             for k, v in launches.items()}
    ok = (state["step"] == 2 and math.isfinite(float(metrics["loss"]))
          and launches["flash_fwd_f32"] == embeds and on_wgmma(trunk)
          and launches["flash_bwd_dq"] > 0)
    rows.append({"run": "esm (ESM-1b width)", "lines": lines, "seconds": secs,
                 "launches": {k: v for k, v in launches.items() if v}, "ok": ok})
    del state
    state, metrics, lines, secs = cli_run([*base, "--steps", "2", "--features", "none"])
    rows.append({"run": "none", "lines": lines, "seconds": secs,
                 "ok": state["step"] == 2 and math.isfinite(float(metrics["loss"]))})
    shutil.rmtree(E2E_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    whole = cli_run([*base, "--steps", "3"])[0]
    cli_run([*base, "--steps", "2", "--ckpt-dir", str(E2E_WORK / "b")])
    resumed, _, lines, _ = cli_run([*base, "--steps", "1", "--ckpt-dir", str(E2E_WORK / "b")])
    same = [np.array_equal(np.asarray(a), np.asarray(b)) and pa == pb for (pa, a), (pb, b) in
            zip(train_state_to_jax(whole), train_state_to_jax(resumed))]
    ok = (resumed["step"] == whole["step"] == 3 and all(same) and len(same) > 0
          and any("resumed from step 2" in x for x in lines))
    rows.append({"run": "resume", "leaves": len(same), "equal": sum(same),
                 "seconds": time.perf_counter() - t0, "ok": ok})
    shutil.rmtree(E2E_WORK, ignore_errors=True)
    del whole, resumed
    torch.cuda.empty_cache()
    ok, losses = phase_e2e_overfit()
    rows.append({"run": "overfit", "losses": losses, "ok": ok})
    for r in rows:
        detail = {k: v for k, v in r.items() if k in ("rc", "seconds", "launches", "leaves",
                                                       "equal", "losses")}
        log(f"[e2e d] {r['run']}: {detail} | "
            + " | ".join(r.get("stdout", r.get("lines", []))[-3:])
            + f" {'ok' if r['ok'] else 'FAIL'}")
    RECORD["phases"]["e2e_cli"] = rows
    if not all(r["ok"] for r in rows):
        bad = [r["run"] for r in rows if not r["ok"]]
        fail(f"train_end2end on the card failed (phase 12d): {bad} "
             f"{rows[0]['stderr_tail'][-800:] if not rows[0]['ok'] else ''}")


def phase_e2e_capture_refused():
    """On the card `CapturedTrainStep` refuses an E2EConfig, naming
    A8-e2e-capture."""
    ecfg = e2e.E2EConfig(model=Alphafold2Config(dim=32, depth=1, heads=2, dim_head=16,
                                                max_seq_len=48), mds_iters=5,
                         mds_init="classical")
    tcfg = TrainConfig(grad_accum=1)
    state = e2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    try:
        CapturedTrainStep(ecfg, tcfg, state, structure_fetch(8, 2, 1, seed=0)(0))
    except ValueError as e:
        if "A8-e2e-capture" not in str(e):
            fail(f"CapturedTrainStep refused an E2EConfig without naming A8-e2e-capture: {e}")
        log(f"[e2e] CapturedTrainStep on an E2EConfig raises: {str(e)[:90]}... ok")
    else:
        fail("CapturedTrainStep accepted an E2EConfig")


def phase_e2e_train():
    """12: end-to-end structure training. Returns (b)'s launches."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"e2e_{key}_s"] = time.perf_counter() - t
        log(f"[time] e2e {key}: {RECORD['phases'][f'e2e_{key}_s']:.1f} s")
        return result

    timed("a", phase_e2e_parity)
    phase_e2e_capture_refused()
    launches = timed("bc", phase_e2e_step)
    timed("d", phase_e2e_cli)
    return launches


# --- phase 13: the reversible trunk --------------------------------------------------

REV_WORK = ROOT / "build" / "phase13"  # 13e's checkpoints, removed at the phase's end
# 13b's bounds, stated before the phase first ran on the card: each leaf's
# bf16 reversible gradient against plain autograd's, max |d| over the
# leaf's largest entry; the rebuilt layer-0 input's max |d| in bf16 ulps
# (2^-7) of the largest input entry
REV_GRAD_BOUND = 0.25
REV_RECON_ULPS = 16
REV_FLASH = 5  # B1f launches a reversible layer's forward with tied MSA rows


def reversible_parity_config(**fields):
    """13a's config: dim 256, 8 heads of 64, depth 2, layer 0 sparse
    (max_seq_len 64, 2 local blocks of 16: 7/8 of the blocks active at L =
    64), tied MSA rows, the aligned crosses with KV compression 2, f32,
    attn_flash=True: the CPU runs the flash path's plain version, as the
    card runs the kernels. Under "auto" the CPU would take the dense path
    at this size, and the two paths differ on a valid row whose keys are
    all masked, which the aligned crosses make of every valid pair
    position in a padded MSA column (ROADMAP C): dense averages the masked
    keys' values, flash gives zeros."""
    return Alphafold2Config(**{**dict(
        dim=256, depth=2, heads=8, dim_head=64, max_seq_len=64, reversible=True,
        sparse_self_attn=(True, False), sparse_num_local_blocks=2, msa_tie_row_attn=True,
        cross_attn_mode="aligned", cross_attn_compress_ratio=2, attn_flash=True), **fields})


def trunk_inputs(cfg, n, rows, cols, seed):
    """Seeded trunk streams on the card in cfg.dtype: x (1, n, n, dim), m
    (1, rows, cols, dim), and random cotangents for both."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    make = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(cfg.dtype)  # noqa: E731
    return (make(1, n, n, cfg.dim), make(1, rows, cols, cfg.dim),
            make(1, n, n, cfg.dim), make(1, rows, cols, cfg.dim))


def trunk_grads(layers, cfg, x, m, gx, gm, reverse):
    """The gradient of sum(out * g) over both outputs of
    `reversible_trunk_apply`, in the inputs and every param leaf."""
    leaves = reversible.param_leaves(layers)
    x, m = x.clone().requires_grad_(True), m.clone().requires_grad_(True)
    xo, mo = reversible.reversible_trunk_apply(layers, cfg, x, m, reverse=reverse)
    loss = (xo.float() * gx.float()).sum() + (mo.float() * gm.float()).sum()
    return torch.autograd.grad(loss, [x, m] + leaves)


def grad_errors(got, want):
    """Each gradient's max |d| over its largest entry in `want`."""
    return [(a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
            for a, b in zip(got, want)]


def phase_rev_parity():
    """(a) f32: 3 distogram steps of 2 microbatches on the card and on the
    CPU from the same params and batches (L = 64, a 16-row MSA;
    `reversible_parity_config`), phase 6a's comparison and tolerances.
    Every flash and B5 launch on its f32 route: a microbatch runs each
    layer's 5 attentions that reach a kernel (2 pair axial, the MSA column
    pass, 2 crosses; the tied MSA row pass is the dense einsum) in the
    forward and again in the backward's recompute, whose vjp launches each
    one's dq and dkv; layer 0's pair axial passes are B5's. Then on the
    card the trunk's gradient (random streams and cotangents) with
    reverse=True against reverse=False, within 1e-4 of each leaf's
    largest entry (6a's gradient tolerance)."""
    cfg = reversible_parity_config()
    tcfg = TrainConfig(grad_accum=2)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=64, msa_rows=16, seed=5), 2)
    states = {dev: train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), dev)
              for dev in ("cuda", "cpu")}
    steps = {dev: make_train_step(cfg, tcfg, device=dev) for dev in states}
    micro = tcfg.grad_accum * 3
    flash = (REV_FLASH * cfg.depth - 2 * sum(cfg.layer_sparse)) * micro
    sparse_n = 2 * sum(cfg.layer_sparse) * micro
    expect = {}
    for name, n in (("flash_fwd", 2 * flash), ("flash_bwd_dq", flash), ("flash_bwd_dkv", flash),
                    ("sparse_fwd", 2 * sparse_n), ("sparse_bwd_dq", sparse_n),
                    ("sparse_bwd_dkv", sparse_n)):
        expect[name] = expect[f"{name}_f32"] = n
    card_vs_cpu_steps("rev a", "rev_parity", "L=64 f32 depth 2 reversible, layer 0 sparse, "
                      "16 MSA rows", repr(cfg), states, steps, fetch, tcfg, expect)
    layers = states["cuda"]["params"]["trunk"]
    x, m, gx, gm = trunk_inputs(cfg, 64, 16, 64, seed=21)
    errs = grad_errors(trunk_grads(layers, cfg, x, m, gx, gm, True),
                       trunk_grads(layers, cfg, x, m, gx, gm, False))
    ok = max(errs) <= 1e-4
    log(f"[rev a] the card's trunk gradient, reverse=True vs reverse=False (f32, "
        f"{len(errs)} leaves): worst {max(errs):.2e} of each leaf's largest (tol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["rev_parity"]["reverse_vs_plain_worst"] = max(errs)
    if not ok:
        fail("the reversible trunk's f32 gradient on the card departs from plain autograd's "
             "(phase 13a)")


def phase_rev_drift(crop=128, rows=E2E_ROWS):
    """(b) bf16 at the north-star widths (`presets.north_star_e2e_config`'s
    model), pair grid 3 crop, `rows` MSA rows, depth 2 and 4, random
    streams and cotangents: each leaf's reversible gradient against
    plain autograd's (max |d| over the leaf's largest entry), and the
    layer-0 input rebuilt from the trunk's output (`reconstruct_input`)
    against the forward's, max |d| in bf16 ulps of the largest input
    entry. A finding, held to REV_GRAD_BOUND and REV_RECON_ULPS (stated
    before the first run) and to finite values."""
    probeout = []
    for depth in (2, 4):
        cfg = presets.north_star_e2e_config(depth)[0].model
        layers = reversible.reversible_trunk_init(torch.Generator().manual_seed(depth), cfg,
                                                  "cuda")
        for t in reversible.param_leaves(layers):
            t.requires_grad_(True)
        names = [name for name, _ in named_leaves(layers)]
        x, m, gx, gm = trunk_inputs(cfg, 3 * crop, rows, 3 * crop, seed=30 + depth)
        rev = trunk_grads(layers, cfg, x, m, gx, gm, True)
        plain = trunk_grads(layers, cfg, x, m, gx, gm, False)
        finite = all(bool(torch.isfinite(g).all()) for g in rev)
        errs = grad_errors(rev, plain)
        del rev, plain
        with torch.no_grad():
            out = reversible.forward_state(layers, cfg, (x, x, m, m))
            back = reversible.reconstruct_input(layers, cfg, out)
        recon = [(a.float() - b.float()).abs().max().item()
                 / (BF16_ULP * b.float().abs().max().item()) for a, b in zip(back, (x, x, m, m))]
        finite = finite and all(bool(torch.isfinite(t).all()) for t in back)
        del out, back
        order = sorted(range(len(errs)), key=lambda i: -errs[i])
        row = {"depth": depth, "grid": 3 * crop, "rows": rows, "leaves": len(errs) - 2,
               "input_grad_err": errs[:2], "worst_leaf_err": max(errs[2:]),
               "median_leaf_err": sorted(errs[2:])[(len(errs) - 2) // 2],
               "worst": [(["x", "m"] + names)[i] for i in order[:5]],
               "worst_errs": [errs[i] for i in order[:5]], "recon_ulps": recon,
               "finite": finite}
        row["ok"] = finite and max(errs) <= REV_GRAD_BOUND and max(recon) <= REV_RECON_ULPS
        probeout.append(row)
        log(f"[rev b] bf16 depth {depth}, grid {3 * crop}, {rows} rows: reversible vs plain "
            f"gradient, worst leaf {row['worst_leaf_err']:.3e} (median "
            f"{row['median_leaf_err']:.3e}, inputs x {errs[0]:.3e} m {errs[1]:.3e}; bound "
            f"{REV_GRAD_BOUND}), worst at {row['worst'][:3]}; layer-0 input rebuilt to "
            f"(x1, x2, m1, m2) {', '.join(f'{u:.2f}' for u in recon)} ulps of the largest "
            f"(bound {REV_RECON_ULPS}) {'ok' if row['ok'] else 'FAIL'}")
        del layers, x, m, gx, gm
        torch.cuda.empty_cache()
    RECORD["phases"]["rev_drift"] = probeout
    if not all(r["ok"] for r in probeout):
        fail("the bf16 reversible trunk went non-finite or past its stated bounds (phase 13b)")


def captured_ms(step, state, batch, reps=5, make_rng=lambda: None):
    """A captured step's replay: one untimed, then `reps` timed (CUDA
    events); the median ms. make_rng: each call's rng."""
    step(state, batch, make_rng())
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, make_rng())
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2], times


def phase_rev_capture(L=128):
    """(c) the reversible distogram step captured: train_pre's bf16
    defaults with reversible=True (depth 1) at crop L, accum 16, on a batch
    with a 20-row MSA: 3 replays bit for bit 3 eager steps
    (`capture_vs_eager`, every flash launch on the wgmma route). Then its
    captured ms (median of 5 replays) beside the sequential config's on
    the same batch, and 6h's sequential crop-128 step (no MSA) from this
    run."""
    cfg = train_pre_config(reversible=True)
    captured, state, batch = capture_vs_eager("bf16 reversible", cfg, L, 16, wgmma=True,
                                              msa_rows=20)
    rev_ms, rev_times = captured_ms(captured, state, batch)
    capture = next(iter(captured.captures.values()))
    del captured, state
    seq_cfg = train_pre_config()
    seq_state = train_state_init(seq_cfg, TrainConfig(grad_accum=16),
                                 torch.Generator().manual_seed(0), "cuda")
    seq_step = CapturedTrainStep(seq_cfg, TrainConfig(grad_accum=16), seq_state, batch)
    seq_ms, seq_times = captured_ms(seq_step, seq_state, batch)
    del seq_step, seq_state
    h = next((r["captured"]["step_ms"] for r in RECORD["phases"].get("train_timing", [])
              if r["label"] == "crop 128"), None)
    RECORD["phases"]["rev_capture"] = {
        "L": L, "config": repr(cfg), "rev_step_ms": rev_times, "rev_median_ms": rev_ms,
        "seq_same_batch_ms": seq_times, "seq_median_ms": seq_ms, "train_h_captured_ms": h,
        "captured_launches": capture.launches, "capture_s": capture.seconds}
    log(f"[rev c] crop {L}, accum 16, 20 MSA rows, captured: reversible depth 1 "
        f"{rev_ms:.2f} ms, sequential {seq_ms:.2f} ms on the same batch (median of 5); "
        f"6h's sequential crop-128 step without an MSA {h if h is None else round(h, 2)} ms; "
        f"capture {capture.seconds:.2f} s, launches a step {capture.launches}")


def e2e_peak_step(ecfg, crop, rows):
    """One e2e step (accum 2) of a fresh seeded state, its AdamW moments
    made first: the peak memory allocated over the step (GiB)."""
    tcfg = TrainConfig(grad_accum=2)
    state = e2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    state["optimizer"].init_state()
    step = make_train_step(ecfg, tcfg, loss_fn=e2e.e2e_loss_fn, device="cuda")
    sync()
    torch.cuda.reset_peak_memory_stats()
    _, m = step(state, structure_fetch(crop, rows, 2, seed=9)(0))
    loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    torch.cuda.empty_cache()
    return peak, loss


def phase_rev_e2e(reps=3):
    """(d) the north-star e2e step, reversible (`north_star_e2e_config(2)`:
    crop 384, grid 1152, 128 MSA rows, bf16), accum 2, eager: one untimed
    step, then, counts set to 0 and the peak reset just before, `reps`
    timed steps (CUDA events; the median), read just after: launches (5
    B1f a layer in the forward and 5 more in the recompute, 5 dq and 5 dkv
    in the backward, a microbatch; every one on its wgmma route), peak
    memory (its AdamW moments made in the untimed step), MFU
    (`train_step_flops`, mult 4). One more step under torch.profiler
    (device ms by kind, busy share). Then one step of
    `north_star_e2e_config(4)` and of depth 2 again from fresh states
    (`e2e_peak_step`): peak(4) - peak(2) < 1 GiB, and the depth-2 peak
    below 12b's remat peak. Returns the counted run's launches."""
    ecfg, crop, rows = presets.north_star_e2e_config(2)
    run = time_e2e_step(ecfg, crop, rows, 2, reps)
    state, step, fetch = run["state"], run["step"], run["fetch"]
    times, metrics, launches, peak = run["times"], run["metrics"], run["launches"], run["peak_gib"]
    step_ms, flops, mfu = run["step_ms"], run["flops"], run["mfu"]
    prof = profile_step(lambda: step(state, fetch(reps + 1)))
    del run, state, step
    torch.cuda.empty_cache()
    peak2, loss2 = e2e_peak_step(ecfg, crop, rows)
    peak4, loss4 = e2e_peak_step(presets.north_star_e2e_config(4)[0], crop, rows)
    per = {k: v / reps for k, v in launches.items() if v}
    flash = REV_FLASH * ecfg.model.depth * 2
    want = {"flash_fwd": 2 * flash, "flash_bwd_dq": flash, "flash_bwd_dkv": flash}
    counts_ok = all(per.get(k, 0) == n for k, n in want.items()) and on_wgmma(launches)
    remat_peak = RECORD["phases"].get("e2e_step", {}).get("peak_gib")
    busy = prof["busy_ms"] / prof["host_ms"]
    finite = all(math.isfinite(v) for r in metrics for v in r.values()) and all(
        math.isfinite(x) for x in (loss2, loss4))
    memory_ok = peak4 - peak2 < 1.0 and remat_peak is not None and peak < remat_peak
    row = {"crop": crop, "grid": 3 * crop, "rows": rows, "config": repr(ecfg),
           "step_ms": times, "median_step_ms": step_ms, "train_step_flops": flops, "mfu": mfu,
           "peak_gib": peak, "fresh_peak_depth2_gib": peak2, "fresh_peak_depth4_gib": peak4,
           "remat_peak_gib_12b": remat_peak, "metrics": metrics, "launches": launches,
           "launches_per_step": per, "profile": prof, "busy_share": busy,
           "ok": finite and counts_ok and memory_ok}
    RECORD["phases"]["rev_e2e"] = row
    log(f"[rev d] the north-star e2e step, reversible (dim 256, depth 2, aligned crosses, "
        f"compress 4, tied rows, bf16), crop {crop} (grid {3 * crop}), {rows} MSA rows, accum "
        f"2, eager: step {step_ms:.1f} ms median of {reps} ({', '.join(f'{t:.1f}' for t in times)}"
        f"), MFU {mfu:.4f} of 989 TFLOP/s ({flops / 1e12:.2f} TFLOP a step), peak {peak:.2f} "
        f"GiB (12b's remat {remat_peak if remat_peak is None else round(remat_peak, 2)}), busy "
        f"{busy:.3f} ({prof['busy_ms']:.1f} of {prof['host_ms']:.1f} ms), losses "
        f"{[round(r['loss'], 4) for r in metrics]}; launches a step {per}")
    log("[rev d] device ms by kind: " + ", ".join(
        f"{k} {v['device_ms']:.1f} ({v['launches']})"
        for k, v in sorted(prof["kinds"].items(), key=lambda kv: -kv[1]["device_ms"])))
    log(f"[rev d] one step from a fresh state: peak depth 2 {peak2:.3f} GiB, depth 4 "
        f"{peak4:.3f} GiB (+{peak4 - peak2:.3f}, bound 1 GiB) {'ok' if row['ok'] else 'FAIL'}")
    if not finite:
        fail("the reversible north-star e2e step gave a non-finite value (phase 13d)")
    if not counts_ok:
        fail(f"the reversible e2e step's launches a step {per} != {want}, or off the wgmma "
             f"routes (phase 13d)")
    if not memory_ok:
        fail(f"the reversible e2e step's peak memory grew {peak4 - peak2:.3f} GiB from depth 2 "
             f"to 4, or its peak {peak:.2f} GiB is not below the remat step's {remat_peak} "
             f"(phase 13d)")
    return launches


def phase_rev_cli():
    """(e) train_end2end's `main` in this process with --reversible --bf16
    --len 32 (dim 256, 8 heads of 64): 3 steps against 2 steps saved to
    --ckpt-dir then 1 resumed, bit for bit (every param, moment and
    count)."""
    base = ["--dim", "256", "--heads", "8", "--dim-head", "64", "--len", "32", "--bf16",
            "--reversible"]
    shutil.rmtree(REV_WORK, ignore_errors=True)
    t0 = time.perf_counter()
    whole, metrics, _, _ = cli_run([*base, "--steps", "3"])
    cli_run([*base, "--steps", "2", "--ckpt-dir", str(REV_WORK)])
    resumed, _, lines, _ = cli_run([*base, "--steps", "1", "--ckpt-dir", str(REV_WORK)])
    same = [np.array_equal(np.asarray(a), np.asarray(b)) and pa == pb for (pa, a), (pb, b) in
            zip(train_state_to_jax(whole), train_state_to_jax(resumed))]
    shutil.rmtree(REV_WORK, ignore_errors=True)
    ok = (resumed["step"] == whole["step"] == 3 and all(same) and len(same) > 0
          and any("resumed from step 2" in x for x in lines)
          and math.isfinite(float(metrics["loss"])))
    RECORD["phases"]["rev_cli"] = {"leaves": len(same), "equal": sum(same),
                                   "seconds": time.perf_counter() - t0, "ok": ok}
    log(f"[rev e] train_end2end --reversible --bf16 --len 32: 3 steps vs 2 + 1 resumed, "
        f"{sum(same)} of {len(same)} leaves equal, {time.perf_counter() - t0:.1f} s | "
        + " | ".join(lines[-2:]) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("train_end2end --reversible did not resume bit for bit (phase 13e)")
    del whole, resumed
    torch.cuda.empty_cache()


def phase_reversible():
    """13: the reversible trunk. Returns (d)'s launches."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"rev_{key}_s"] = time.perf_counter() - t
        log(f"[time] rev {key}: {RECORD['phases'][f'rev_{key}_s']:.1f} s")
        return result

    timed("a", phase_rev_parity)
    timed("b", phase_rev_drift)
    timed("c", phase_rev_capture)
    launches = timed("d", phase_rev_e2e)
    timed("e", phase_rev_cli)
    return launches


# --- phase 14: the relaxation, the segmented step, bucketed pretraining -------------

PRE_WORK = ROOT / "build" / "phase14"  # 14d's PDB files, removed at the phase's end
BUCKETS = (64, 128, 256)  # 14c's length buckets: train_pre's crops
SEG_K = 3  # 14b's --trunk-segments (depth 5)


def noisy_backbone(L, b, seed):
    """(b, 3L, 3) helix backbones with 0.3 A of noise, the chain cut after
    residues L / 3 and 2 L / 3 (each later piece moved 12 A away), and the
    peptide mask (b, L - 1) that keeps those two bonds out."""
    t = 0.6 * np.arange(3 * L)
    bb = np.stack([2 * np.cos(t), 2 * np.sin(t), -0.16 * t], -1).astype(np.float32)
    rs = np.random.RandomState(seed)
    coords = bb[None] + 0.3 * rs.randn(b, 3 * L, 3).astype(np.float32)
    peptide = np.ones((b, L - 1), bool)
    for cut in (L // 3, 2 * L // 3):
        peptide[:, cut - 1] = False
        coords[:, 3 * cut:] += np.asarray([12.0, 0.0, 0.0], np.float32)
    return coords, peptide


def phase_relax_parity(L=384, iters=200):
    """(a) `refinement.py relax`, f32: 2 noisy 384-residue backbones with
    two chain breaks, 200 iterations, on the card and on the CPU: relaxed
    coords within 1e-4 A, history within 1e-5 * max(1, |ref|), the energy
    lowered. Then ms a relax (CUDA events, mean of 3 after one) at L = 384
    and 1024 (b = 2), and the launches the host issues for one relax at L
    = 1024 (torch.profiler)."""
    coords, peptide = noisy_backbone(L, 2, seed=14)
    card, card_hist = refinement.relax(torch.from_numpy(coords).cuda(), iters=iters,
                                       peptide_mask=torch.from_numpy(peptide).cuda())
    cpu, cpu_hist = refinement.relax(torch.from_numpy(coords), iters=iters,
                                     peptide_mask=torch.from_numpy(peptide))
    d = (card.cpu() - cpu).abs().max().item()
    h = ((card_hist.cpu() - cpu_hist).abs() / cpu_hist.abs().clamp_min(1.0)).max().item()
    e0, e1 = (refinement.backbone_bond_energy(torch.from_numpy(x), peptide_mask=peptide)
              for x in (coords, cpu.numpy()))
    timing = {}
    for n in (384, 1024):
        c, p = (torch.from_numpy(a).cuda() for a in noisy_backbone(n, 2, seed=n))
        timing[n] = time_ms(lambda: refinement.relax(c, iters=iters, peptide_mask=p), 3)
    prof = profile_request(lambda: refinement.relax(c, iters=iters, peptide_mask=p))
    ok = d <= 1e-4 and h <= 1e-5 and bool((e1 < e0).all())
    RECORD["phases"]["relax"] = {"L": L, "iters": iters, "coords_max_abs": d,
                                 "history_max_rel": h, "energy_before": e0.tolist(),
                                 "energy_after": e1.tolist(), "ms": timing,
                                 "launches_per_relax": prof["kernel_launches"],
                                 "device_ms_per_relax": prof["device_ms"], "ok": ok}
    log(f"[relax a] relax, b 2, L {L}, 2 chain breaks, {iters} iterations, f32, card vs cpu: "
        f"coords |d| {d:.2e} (tol 1e-4 A), history rel {h:.2e} (tol 1e-5); energy "
        f"{[round(x, 2) for x in e0.tolist()]} -> {[round(x, 4) for x in e1.tolist()]}; ms a "
        f"relax at L 384 {timing[384]:.2f}, 1024 {timing[1024]:.2f}; {prof['kernel_launches']} "
        f"launches ({prof['device_ms']:.2f} device ms) a relax at L 1024 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("relax on the card departs from the CPU's, or did not lower the energy (phase 14a)")


def depth_parity_config(mds_init):
    """14b's e2e config: dim 64, 2 heads of 32, depth 5, reversible, tied
    MSA rows (5 flash attentions a layer), attn_flash=True (the CPU runs the
    flash path's plain version, ROADMAP C), 20 MDS iterations from
    `mds_init`, refiner dim 64 depth 2; f32."""
    model = Alphafold2Config(dim=64, depth=5, heads=2, dim_head=32, max_seq_len=48,
                             reversible=True, msa_tie_row_attn=True, attn_flash=True)
    return e2e.E2EConfig(model=model, refiner=RefinerConfig(num_tokens=14, dim=64, depth=2),
                         mds_iters=20, mds_init=mds_init)


MDS_MODULE = importlib.import_module("alphafold2_tpu_torch.geometry.mds")


@contextlib.contextmanager
def mds_trace(trace, starts=None):
    """While open, each MDS of `predict_structure` appends to `trace` its
    input distances, its start (`initial_coords`), the Guttman iterations
    it took before the freeze and its fraction of negative phis (the
    mirror fix's input), all copied to the host. With `starts`, the n-th
    MDS starts from starts[n] instead of its own init."""
    init, guttman, phis = (MDS_MODULE.initial_coords, MDS_MODULE.guttman,
                           MDS_MODULE.calc_phis)

    def traced_init(pre, kind="classical", generator=None):
        x = init(pre, kind, generator)
        if starts is not None:
            x = starts[len(trace)].to(x.device)
        trace.append({"dist": pre.detach().cpu(), "start": x.detach().cpu()})
        return x

    def traced_guttman(*args, **kw):
        out = guttman(*args, **kw)
        h = out[1].detach().cpu()
        trace[-1]["iters"] = int((h[1:] != h[:-1]).any(-1).sum()) + 1 if len(h) else 0
        return out

    def traced_phis(*args, **kw):
        r = phis(*args, **kw)
        trace[-1]["phi_prop"] = r.detach().cpu().tolist()
        return r

    MDS_MODULE.initial_coords = traced_init
    MDS_MODULE.guttman = traced_guttman
    MDS_MODULE.calc_phis = traced_phis
    try:
        yield trace
    finally:
        MDS_MODULE.initial_coords = init
        MDS_MODULE.guttman = guttman
        MDS_MODULE.calc_phis = phis


def detached_params(tree, device):
    """A parameter tree's tensors copied to `device` as fresh leaves that
    require grad."""
    if isinstance(tree, dict):
        return {k: detached_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [detached_params(v, device) for v in tree]
    return tree.detach().to(device).requires_grad_(True)


def microbatch_grads(params, ecfg, mb, device, starts=None):
    """One microbatch's e2e loss and gradients (host copies) at `params`
    on `device`, and its MDS trace (`mds_trace`)."""
    leaves = list(tree_leaves(params))
    trace = []
    with mds_trace(trace, starts):
        loss = e2e.e2e_loss_fn(params, ecfg, {k: torch.as_tensor(v).to(device)
                                              for k, v in mb.items()}, None, device)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (loss.item(), [torch.zeros_like(p).cpu() if g is None else g.cpu()
                          for p, g in zip(leaves, grads)], trace)


def grad_ratio(got, want, tol=1e-4):
    """The worst leaf's max |got - want| over tol times its largest |want|
    (phase 6a's first-step gradient measure)."""
    worst = 0.0
    for a, b in zip(got, want):
        d, scale_ = (a - b).abs().max().item(), b.abs().max().item()
        worst = max(worst, d / (tol * scale_) if scale_ else (0.0 if d == 0 else math.inf))
    return worst


def top3(start):
    """The classical init's top-3 eigenvectors, (b, N, 3) f64, from its
    start (the eigenvectors scaled by the roots of their eigenvalues)."""
    x = start.double()
    return x / x.norm(dim=-2, keepdim=True).clamp_min(1e-300)


def subspace_sin(a, b):
    """The sine of the largest principal angle between the spans of two
    (b, N, 3) orthonormal column sets (the worst structure)."""
    resid = b - a @ (a.transpose(-1, -2) @ b)
    return torch.linalg.matrix_norm(resid, ord=2).max().item()


def shape_departure(a, b):
    """How far two (b, N, 3) point sets are apart up to an isometry: the
    largest difference of their pairwise distances over the largest
    distance."""
    da, db = torch.cdist(a.double(), a.double()), torch.cdist(b.double(), b.double())
    return ((da - db).abs().max() / db.abs().max()).item()


def classical_init_probe(ecfg, tcfg, fetch, steps=3, card="cuda"):
    """The classical MDS init, `card` (default CUDA) against CPU, on `steps`
    of `fetch`'s batches along the CPU's own trajectory (its state after n
    steps, copied to the card for step n, so both devices start each step
    from the same params). For each microbatch:
      - the init's input distances, card against CPU (relative);
      - the CPU's Gram matrix: its spectral norm, its top eigenvalues and
        the gap l3 - l4 that bounds how far its top-3 eigenvectors move;
      - eigh alone: the card's eigh of the CPU's own Gram matrix against the
        CPU's, as the sine of the angle between the top-3 spans and the
        starts' departure up to an isometry (`shape_departure`);
      - the starts each device reached from its own distances, the same two
        measures, beside the perturbation bound ||dG||_2 / (l3 - l4) (Davis
        and Kahan) from the two devices' Gram matrices;
      - the Guttman iterations taken before the freeze and the mirror fix's
        negative-phi fraction on each device;
      - the gradients, card against CPU at phase 6a's measure
        (`grad_ratio`), from the card's own start and from the CPU's start
        handed to the card.
    Returns a row of these a microbatch."""
    state = e2e_parity_state(ecfg, tcfg, "cpu")
    cpu_step = make_train_step(ecfg, tcfg, loss_fn=e2e.e2e_loss_fn, device="cpu")
    rows = []
    for n in range(steps):
        batch = fetch(n)
        for j in range(len(next(iter(batch.values())))):
            mb = {k: v[j] for k, v in batch.items()}
            l_cpu, g_cpu, t_cpu = microbatch_grads(detached_params(state["params"], "cpu"),
                                                   ecfg, mb, "cpu")
            l_card, g_card, t_card = microbatch_grads(
                detached_params(state["params"], card), ecfg, mb, card)
            _, g_same, _ = microbatch_grads(detached_params(state["params"], card), ecfg,
                                            mb, card, starts=[t["start"] for t in t_cpu])
            for k, (tc, tg) in enumerate(zip(t_cpu, t_card)):
                gram_cpu = MDS_MODULE.classical_gram(tc["dist"])
                evals = torch.linalg.eigvalsh(gram_cpu.double())[..., -4:]
                gap = (evals[..., 1] - evals[..., 0]).min().item()
                d_gram = torch.linalg.matrix_norm(
                    MDS_MODULE.classical_gram(tg["dist"].double())
                    - MDS_MODULE.classical_gram(tc["dist"].double()), ord=2).max().item()
                solver = MDS_MODULE.classical_embed(
                    *torch.linalg.eigh(gram_cpu.to(card))).cpu()
                rows.append({
                    "step": n, "microbatch": j, "mds": k,
                    "dist_rel": ((tg["dist"] - tc["dist"]).abs().max()
                                 / tc["dist"].abs().max()).item(),
                    "top_evals": evals.tolist(), "gap": gap,
                    "gram_norm": torch.linalg.matrix_norm(gram_cpu.double(), ord=2).max().item(),
                    "rel_gap": gap / evals[..., 1].max().item(),
                    "eigh_sin": subspace_sin(top3(tc["start"]), top3(solver)),
                    "eigh_shape": shape_departure(solver, tc["start"]),
                    "own_sin": subspace_sin(top3(tc["start"]), top3(tg["start"])),
                    "dk_bound": d_gram / gap,
                    "own_shape": shape_departure(tg["start"], tc["start"]),
                    "iters": (tg.get("iters"), tc.get("iters")),
                    "phi_prop": (tg.get("phi_prop"), tc.get("phi_prop")),
                    "loss": (l_card, l_cpu),
                    "grad_ratio_own_start": grad_ratio(g_card, g_cpu),
                    "grad_ratio_cpu_start": grad_ratio(g_same, g_cpu)})
        cpu_step(state, batch)
    return rows


def phase_segmented_parity(L=16, rows=8):
    """(b) f32, L = 16 (grid 48), an 8-row MSA, accum 2, depth 5
    (`depth_parity_config`), the step of `train_end2end --reversible
    --trunk-segments 3` (`segmented.make_segmented_train_step`: on CUDA the
    monolithic reversible step).
    From the random MDS init (the same CPU draw on both devices): 3 free
    steps, card against CPU at phase 6a's tolerances (`card_vs_cpu_steps`),
    every flash launch on the f32 route.
    From the classical init (`classical_init_probe`, 3 steps' 6
    microbatches, both devices from the same params each step): each
    microbatch's loss within 1e-5; its gradients within phase 6a's measure
    once the card is handed the CPU's start (so everything but the init
    agrees); and the init's departure within the f32 eigensolver's bound:
    the top-3 eigenvectors' span moves by at most (||dG||_2 + 2 n eps
    ||G||_2) / (l3 - l4), dG the two devices' Gram matrices' difference, n
    the grid, eps f32's machine epsilon (each solver's backward error is
    at most n eps ||G||), and the card's eigh of the CPU's own Gram matrix
    by at most 2 n eps ||G||_2 / (l3 - l4). The gradients from each
    device's own start are recorded, not held: where l3 - l4 is a few
    percent of l3 the start moves by ~1e-5 and the gradients by up to ~1e-3
    of a leaf's largest entry (ROADMAP C)."""
    tcfg = TrainConfig(grad_accum=2)
    fetch = structure_fetch(L, rows, 2, seed=5)
    ecfg = depth_parity_config("random")
    states = {dev: e2e_parity_state(ecfg, tcfg, dev) for dev in ("cuda", "cpu")}
    steps = {dev: segmented.make_segmented_train_step(ecfg, tcfg, SEG_K, device=dev)
             for dev in states}
    flash = REV_FLASH * ecfg.model.depth * tcfg.grad_accum * 3
    expect = {}
    for name, n in (("flash_fwd", 2 * flash), ("flash_bwd_dq", flash), ("flash_bwd_dkv", flash)):
        expect[name] = expect[f"{name}_f32"] = n
    card_vs_cpu_steps("seg b", "segmented_parity", f"L={L} (grid {3 * L}) f32 depth 5 "
                      f"reversible, --trunk-segments {SEG_K}, {rows} MSA rows, the random MDS "
                      f"init", repr(ecfg), states, steps, fetch, tcfg, expect)
    del states, steps

    ecfg = depth_parity_config("classical")
    probe = classical_init_probe(ecfg, tcfg, fetch)
    eps, n = torch.finfo(torch.float32).eps, 3 * L
    for r in probe:
        solver = 2 * n * eps * r["gram_norm"] / r["gap"]
        r["eigh_bound"], r["own_bound"] = solver, r["dk_bound"] + solver
        r["ok"] = (r["eigh_sin"] <= solver and r["own_sin"] <= r["own_bound"]
                   and abs(r["loss"][0] - r["loss"][1]) <= 1e-5
                   and r["grad_ratio_cpu_start"] <= 1.0)
        log(f"[seg b] classical init, step {r['step']} microbatch {r['microbatch']}: init input "
            f"rel {r['dist_rel']:.2e}; (l3 - l4) / l3 {r['rel_gap']:.3f}; top-3 span sin: card's "
            f"eigh of the CPU's Gram {r['eigh_sin']:.2e} (bound {solver:.2e}), own start "
            f"{r['own_sin']:.2e} (bound {r['own_bound']:.2e}); start shape {r['eigh_shape']:.2e} "
            f"/ {r['own_shape']:.2e}; Guttman iterations {r['iters']}, negative-phi fractions "
            f"{r['phi_prop']}; loss |d| {abs(r['loss'][0] - r['loss'][1]):.2e}; grads worst/tol "
            f"from the own start {r['grad_ratio_own_start']:.3f}, from the CPU's start "
            f"{r['grad_ratio_cpu_start']:.3f} {'ok' if r['ok'] else 'FAIL'}")
    RECORD["phases"]["classical_init"] = {"config": repr(ecfg), "rows": probe,
                                          "ok": all(r["ok"] for r in probe)}
    if not all(r["ok"] for r in probe):
        fail("the classical MDS init's card-vs-CPU departure is not the f32 eigensolver's, or "
             "the rest of the step disagrees from the same start (phase 14b)")


def bucket_groups(accum, want=(2, 1, 1, 1), seed=0):
    """Microbatch stacks from train_pre's native stream (its pool, the C++
    loader at 2 threads, `bucketed_microbatches`) over BUCKETS: `want[0]`
    stacks at 256, then `want[1:]` at 64, 128 and 256 (the order the
    capture meets them in). Also the loader's batches/s at 2 threads on
    the same pool (400 batches after 8)."""
    top = BUCKETS[-1]
    args = argparse.Namespace(len_buckets=",".join(map(str, BUCKETS)), max_len=top, batch=1)
    stream = quiet(train_pre.native_stream, args, DataConfig(batch_size=1, max_len=top,
                                                              seed=seed),
                   TrainConfig(grad_accum=accum))[0]
    by = {bl: [] for bl in BUCKETS}
    while (len(by[256]) < want[0] + want[3] or len(by[64]) < want[1]
           or len(by[128]) < want[2]):
        g = next(stream)
        by[g["seq"].shape[-1]].append(g)
    stream.close()  # its loader with it
    order = (by[256][:want[0]] + by[64][:want[1]] + by[128][:want[2]]
             + by[256][want[0]:want[0] + want[3]])
    loader = NativePrefetchLoader(train_pre.native_pool(top, seed), batch_size=1, max_len=top,
                                  seed=seed, n_threads=2, buckets=BUCKETS)
    for _ in range(8):
        loader.next()
    t0 = time.perf_counter()
    for _ in range(400):
        loader.next()
    rate = 400 / (time.perf_counter() - t0)
    loader.close()
    return order, rate


def phase_bucketed_pretrain(steps=200, accum=2):
    """(c) bucketed pretraining: `train_pre.main` in this process with
    --data native --len-buckets 64,128,256 --len 256 --bf16 --accum 2
    --steps 200 (the pool draws L from [32, 1024), so about 1 protein in 30
    lands in the 64 bucket: 200 steps of 2 microbatches meet it with
    probability ~1 - 1e-6): rc 0, finite losses, one capture a bucket (3),
    and every B1f, dq and dkv launch of the captures on wgmma. Then, on
    stacks of the same stream, `capture_vs_eager` over 256, 256, 64, 128,
    256: each bucket's captured step bit for bit the eager step, the 64
    and 128 buckets captured in mid-run after steps at 256, the params,
    moments and counts bit for bit at the end; each bucket's captured step
    ms (`captured_ms`) beside the loader's batches/s at 2 threads. Returns
    the CLI run's launches."""
    argv = ["--data", "native", "--len-buckets", ",".join(map(str, BUCKETS)), "--len",
            str(BUCKETS[-1]), "--bf16", "--accum", str(accum), "--steps", str(steps)]
    reset_launches()
    t0 = time.perf_counter()
    (state, metrics), lines = quiet(train_pre.main, argv)
    sync()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    del state
    captured_lines = [x for x in lines if x.startswith("captured the step for bucket")]
    buckets_seen = sorted({int(x.split()[5]) for x in captured_lines})
    losses = [float(x.split()[3]) for x in lines if x.startswith("step ")]
    cli_ok = ("done" in lines and buckets_seen == list(BUCKETS) and len(captured_lines) == 3
              and losses and all(math.isfinite(v) for v in losses) and on_wgmma(launches)
              and math.isfinite(float(metrics["loss"])))
    log(f"[pre c] train_pre {' '.join(argv)}: {seconds:.1f} s, captures {captured_lines}, "
        f"losses {losses}; launches (warm-ups and captures) "
        f"{dict((k, v) for k, v in launches.items() if v)} {'ok' if cli_ok else 'FAIL'}")
    cfg = train_pre_config()
    groups, rate = bucket_groups(accum)
    captured, state, _ = capture_vs_eager("bf16 buckets", cfg, "64/128/256", accum, wgmma=True,
                                          batches=groups)
    step_ms = {}
    for g in groups[1:4]:
        bl = g["seq"].shape[-1]
        step_ms[bl] = captured_ms(captured, state, g)[0]
    del captured, state
    torch.cuda.empty_cache()
    RECORD["phases"]["bucketed_pretrain"] = {
        "argv": argv, "seconds": seconds, "lines": lines, "launches": launches,
        "captures": captured_lines, "captured_step_ms": step_ms,
        "loader_batches_per_s": rate, "ok": cli_ok}
    log(f"[pre c] captured step ms by bucket (median of 5, accum {accum}): "
        + ", ".join(f"{bl}: {ms:.2f}" for bl, ms in step_ms.items())
        + f"; steps/s {', '.join(f'{bl}: {1e3 / ms:.1f}' for bl, ms in step_ms.items())}; "
        f"the loader at 2 threads {rate:.0f} batches/s")
    if not cli_ok:
        fail("train_pre --data native --len-buckets did not run its three captured buckets "
             "on wgmma with finite losses (phase 14c)")
    return launches


def phase_refine_chain(L=128):
    """(d) `python -m alphafold2_tpu_torch.predict --full-atom --bf16` on
    128 residues in a process of its own, then `refine.main` on its PDB on
    the card and with --device cpu: the output parses back (N/CA/C of
    every residue), keeps the CA B-factors, has a lower bond energy than
    its input, and the card's relaxed coordinates lie within 1e-3 A of the
    CPU's."""
    shutil.rmtree(PRE_WORK, ignore_errors=True)
    PRE_WORK.mkdir(parents=True)
    seq = "".join(np.random.default_rng(L).choice(list(AA_ORDER), L))
    src, card_out, cpu_out = (str(PRE_WORK / f"{n}.pdb") for n in ("predicted", "card", "cpu"))
    cmd = [sys.executable, "-m", "alphafold2_tpu_torch.predict", "--seq", seq, "--full-atom",
           "--bf16", "--out", src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    predict_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"predict --full-atom failed (phase 14d): {res.stderr[-1000:]}")
    t0 = time.perf_counter()
    card_xyz, card_lines = quiet(refine.main, [src, card_out])
    refine_s = time.perf_counter() - t0
    cpu_xyz, _ = quiet(refine.main, [src, cpu_out, "--device", "cpu"])
    inp = parse_pdb(src).select_atoms(("N", "CA", "C"))
    card = parse_pdb(card_out)
    energy = [float(refinement.backbone_bond_energy(
        torch.from_numpy(s.coords()[None]), peptide_mask=np.ones((1, L - 1), bool))[0])
        for s in (inp, card)]
    d = float(np.abs(card_xyz - cpu_xyz).max())
    ca_in = [a.bfactor for a in inp.atoms if a.name == "CA"]
    ca_out = [a.bfactor for a in card.atoms if a.name == "CA"]
    ok = ([a.name for a in card.atoms] == ["N", "CA", "C"] * L and ca_in == ca_out
          and any(ca_in) and energy[1] < energy[0] and d <= 1e-3
          and bool(np.isfinite(card.coords()).all()))
    RECORD["phases"]["refine_chain"] = {
        "L": L, "predict_s": predict_s, "refine_card_s": refine_s, "energy": energy,
        "card_vs_cpu_max_abs": d, "lines": card_lines, "ok": ok}
    log(f"[relax d] predict --full-atom --bf16 ({L} residues, {predict_s:.1f} s) -> refine on "
        f"the card ({refine_s:.2f} s): bond energy {energy[0]:.2f} -> {energy[1]:.4f}, CA "
        f"B-factors kept {ca_in == ca_out}, card vs --device cpu |d| {d:.2e} A (tol 1e-3) | "
        + " | ".join(card_lines) + f" {'ok' if ok else 'FAIL'}")
    shutil.rmtree(PRE_WORK, ignore_errors=True)
    if not ok:
        fail("predict --full-atom -> refine on the card failed its checks (phase 14d)")


def phase_relax_segmented_buckets():
    """14: the relaxation, the e2e step at depth (--trunk-segments) with the
    classical init's card-vs-CPU departure, bucketed pretraining, the CLI
    chain. Returns (c)'s launches."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"p14_{key}_s"] = time.perf_counter() - t
        log(f"[time] p14 {key}: {RECORD['phases'][f'p14_{key}_s']:.1f} s")
        return result

    timed("a", phase_relax_parity)
    timed("b", phase_segmented_parity)
    launches = timed("c", phase_bucketed_pretrain)
    timed("d", phase_refine_chain)
    return launches


# --- phase 15: live dropout in the captured step, the random init in the engine -----

DROPOUT = 0.1  # phase 15's dropout rate


def seeded(seed):
    """A fresh CPU generator seeded with `seed` at each call (a step's rng)."""
    return lambda: torch.Generator().manual_seed(seed)


def two_rngs_differ(captured, state, batch, seeds=(31, 32)):
    """One batch replayed under two rngs: the two losses (the masks are
    drawn at each replay, not frozen at capture)."""
    return [float(captured(state, batch, seeded(s)())[1]["loss"]) for s in seeds]


def phase_dropout_step(L=128, accum=2):
    """(a) train_pre's widths (dim 256, depth 1, heads 8, dim_head 64) in
    bf16 at crop L, accum 2, ff_dropout 0.1: the captured step against the
    eager step over 3 steps with three step rngs, bit for bit
    (`capture_vs_eager`), every B1f and B1b launch on its wgmma route;
    then one batch replayed under two rngs gives two losses. Returns the
    launches: the wrappers' counts from a reset just before to just after
    (the eager steps, the warm-up, the capture) plus the replays' (the
    capture's launches times its replays)."""
    cfg = train_pre_config(ff_dropout=DROPOUT)
    captured, state, batch = capture_vs_eager("ff dropout", cfg, L, accum, wgmma=True,
                                              rngs=[21, 22, 23])
    losses = two_rngs_differ(captured, state, batch)
    sync()
    launches = launch_counts()
    for name, n in captured.replayed_launches().items():
        launches[name] = launches.get(name, 0) + n
    ok = losses[0] != losses[1] and len(captured.captures) == 1
    log(f"[dropout a] ff_dropout {DROPOUT}, crop {L}, accum {accum}: one batch under two rngs, "
        f"losses {losses}; launches {dict((k, n) for k, n in launches.items() if n)} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["dropout_step"] = {"L": L, "grad_accum": accum, "config": repr(cfg),
                                        "two_rng_losses": losses, "launches": launches,
                                        "ok": ok}
    if not ok:
        fail("the captured dropout step replays frozen masks (phase 15a)")
    return launches


def phase_dropout_schedules(L=128, accum=2, rows=20):
    """(b) attn_dropout = ff_dropout = 0.1 with a 20-row MSA, each captured
    against eager over 3 steps with three step rngs, bit for bit, and one
    batch under two rngs giving two losses: remat with remat_policy "dots"
    and branch_parallel (train_pre's widths, bf16, crop L, accum 2), and
    the reversible step (13c's config: the same widths, reversible=True,
    accum 16). Live attention dropout keeps the dense einsum, as in JAX:
    these steps launch no flash kernel."""
    both = dict(attn_dropout=DROPOUT, ff_dropout=DROPOUT)
    results = []
    for label, cfg, acc in (
            ("remat dots", train_pre_config(remat=True, remat_policy="dots", **both), accum),
            ("branch_parallel", train_pre_config(trunk_schedule="branch_parallel", **both),
             accum),
            ("reversible", train_pre_config(reversible=True, **both), 16)):
        captured, state, batch = capture_vs_eager(f"dropout {label}", cfg, L, acc, wgmma=False,
                                                  msa_rows=rows, rngs=[41, 42, 43])
        losses = two_rngs_differ(captured, state, batch)
        launches = next(iter(captured.captures.values())).launches
        ok = losses[0] != losses[1]
        log(f"[dropout b] {label}: one batch under two rngs, losses {losses}; captured "
            f"launches {launches} {'ok' if ok else 'FAIL'}")
        results.append({"label": label, "config": repr(cfg), "grad_accum": acc,
                        "two_rng_losses": losses, "captured_launches": launches, "ok": ok})
        del captured, state
    RECORD["phases"]["dropout_schedules"] = results
    if not all(r["ok"] for r in results):
        fail("a captured dropout step replays frozen masks (phase 15b)")


def phase_random_init_engine(rows=ENGINE_ROWS):
    """(c) `ServingEngine(mds_init="random", cache_capacity=0)` at the served
    config (bf16), buckets 128 / 256, max_batch 2, 200 MDS iterations: at
    each bucket a padded batch of two requests through the engine's device
    call (`_call_executable`, which counts the calls) against eager
    `predict_structure` on the card from a generator on the card seeded
    with the engine's seed for that call (`init_seed`), bit for bit on
    coords, confidence and stress; the same batch again, the next call,
    starts from another init (other coords); then four requests through
    `predict`, all finite. Then the f32 served config at bucket 64: the
    card's init (the draw of the call's generator) handed to the CPU's
    `predict_structure`, at phase 4a's tolerances. Returns the bf16
    engine's B1f launches: the wrappers' counts from a reset just before
    (the warm-ups, the captures, the eager references) plus each
    executable's captured launches times its replays."""
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    scfg = ServingConfig(buckets=(128, 256), max_batch=2, msa_rows=rows, mds_iters=200,
                         mds_init="random", cache_capacity=0, seed=7)
    reset_launches()
    eng = ServingEngine(params, cfg, scfg)
    checks = []
    try:
        for bucket, lengths in ((128, (128, 90)), (256, (256, 200))):
            batch = engine_batch(lengths, bucket, seed=bucket)
            outs = [eng._call_executable(bucket, *batch) for _ in range(2)]
            index = eng._batch_counter - 1  # the first of the two calls
            ref = predict_structure(
                params, cfg, batch[0], mask=batch[1], msa=batch[2], msa_mask=batch[3],
                mds_iters=200, mds_init="random",
                generator=torch.Generator("cuda").manual_seed(eng.init_seed(index)),
                device="cuda")
            sync()
            equal = all(torch.equal(outs[0][k], ref[k]) for k in outs[0])
            other = not torch.equal(outs[0]["coords"], outs[1]["coords"])
            finite = all(bool(torch.isfinite(v).all()) for o in outs for v in o.values())
            checks.append({"bucket": bucket, "index": index, "bit_equal": equal,
                           "next_call_differs": other, "finite": finite})
        seqs = ["".join(AA_ORDER[(7 * i + j) % 20] for j in range(n))
                for i, n in enumerate((60, 128, 150, 256))]
        served = [eng.predict(q, timeout=600) for q in seqs]
        served_ok = all(np.isfinite(r.coords).all() and np.isfinite(r.stress) for r in served)
    finally:
        eng.shutdown()
    sync()
    launches = launch_counts()
    for exe in eng._executables.values():
        for name, n in exe.launches.items():
            launches[name] = launches.get(name, 0) + n * exe.replays
    routes = on_wgmma(launches)
    f32 = phase_random_init_cpu(rows)
    ok = (all(c["bit_equal"] and c["next_call_differs"] and c["finite"] for c in checks)
          and served_ok and routes and len(eng._executables) <= 4 and f32["ok"])
    log(f"[dropout c] random-init engine: captured vs eager {checks}; 4 requests served, "
        f"finite {served_ok}; {len(eng._executables)} executables; launches "
        f"{dict((k, n) for k, n in launches.items() if n)}"
        f"{', all on wgmma' if routes else ', OFF wgmma'} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["random_init_engine"] = {
        "config": repr(cfg), "checks": checks, "served_finite": served_ok,
        "executables": len(eng._executables), "launches": launches, "on_wgmma": routes,
        "cpu_vs_card": f32, "ok": ok}
    if not ok:
        fail("the random-init engine's captured request differs from the eager one, its "
             "init is frozen, or the card disagrees with the CPU (phase 15c)")
    return launches


def phase_random_init_cpu(rows, L=64):
    """15c's f32 check: the served config in float32, an engine at bucket
    64 with the random init; its first call's output on the card, and the
    CPU's `predict_structure` on the same parameters started from the
    card's init (`geometry.mds.initial_coords` patched in the pipeline to
    return it): logits 1e-4, confidence 1e-5, stress 1e-3 relative,
    distances 1e-2 A (phase 4a's)."""
    cfg = served_config(dtype=torch.float32, max_seq_len=L)
    params_cpu, params_gpu = (alphafold2_init(cfg, torch.Generator().manual_seed(0), dev)
                              for dev in ("cpu", "cuda"))
    eng = ServingEngine(params_gpu, cfg, ServingConfig(
        buckets=(L,), max_batch=1, msa_rows=rows, mds_iters=200, mds_init="random",
        cache_capacity=0, seed=7))
    batch = engine_batch((L,), L, seed=61)
    try:
        g = {k: v.cpu() for k, v in eng._call_executable(L, *batch).items()}
        g["distogram_logits"] = eng._executables[(L, 1)].logits.cpu()
    finally:
        eng.shutdown()
    init = 2.0 * torch.rand((1, L, 3), generator=torch.Generator("cuda").manual_seed(
        eng.init_seed(1)), device="cuda") - 1.0
    pipeline = importlib.import_module("alphafold2_tpu_torch.serving.pipeline")
    original = pipeline.initial_coords
    pipeline.initial_coords = lambda distances, kind, generator: init.cpu()
    try:
        cpu = predict_structure(params_cpu, cfg, batch[0], mask=batch[1], msa=batch[2],
                                msa_mask=batch[3], mds_iters=200, mds_init="random",
                                device="cpu")
    finally:
        pipeline.initial_coords = original
    d = {"logits": (g["distogram_logits"] - cpu["distogram_logits"]).abs().max().item(),
         "confidence": (g["confidence"] - cpu["confidence"]).abs().max().item(),
         "stress_rel": ((g["stress"] - cpu["stress"]).abs() / cpu["stress"].abs()).max().item(),
         "distances": (pairwise(g["coords"]) - pairwise(cpu["coords"])).abs().max().item()}
    ok = (d["logits"] <= 1e-4 and d["confidence"] <= 1e-5 and d["stress_rel"] <= 1e-3
          and d["distances"] <= 1e-2)
    log(f"[dropout c] f32 L={L}, the card's random init on both: logits |d|={d['logits']:.2e} "
        f"(1e-4), confidence |d|={d['confidence']:.2e} (1e-5), stress rel="
        f"{d['stress_rel']:.2e} (1e-3), distances |d|={d['distances']:.2e} A (1e-2) "
        f"{'ok' if ok else 'FAIL'}")
    return {"L": L, **d, "ok": ok}


def phase_dropout_timing(L=128, reps=5):
    """(d) timings, reported with no limit. train_pre's bf16 step (accum 16)
    at crop L, captured, without dropout, with ff_dropout 0.1 and with
    attention and feed-forward dropout 0.1 (the dense einsum): median ms of
    `reps` replays (CUDA events, after one untimed), and the ff-dropout
    step's eager ms (host clock, median of 3). Then one served request
    (batch 1, a 20-row MSA, 200 MDS iterations) at L = 384, captured, with
    the random init against the classical one: request ms on the host clock
    (mean of `reps`, in turns after a warm-up), the launches the host
    issued and the device's busy share (torch.profiler)."""
    tcfg = TrainConfig(grad_accum=16)
    batch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=11), 16)(0)
    steps = []
    for label, fields in (("no dropout", {}), ("ff 0.1", dict(ff_dropout=DROPOUT)),
                          ("attn+ff 0.1", dict(attn_dropout=DROPOUT, ff_dropout=DROPOUT))):
        cfg = train_pre_config(**fields)
        state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
        step = CapturedTrainStep(cfg, tcfg, state, batch)
        median, times = captured_ms(step, state, batch, reps, make_rng=seeded(5))
        row = {"label": label, "captured_ms": median, "captured_runs_ms": times,
               "capture_s": next(iter(step.captures.values())).seconds}
        del step
        if label == "ff 0.1":
            eager = make_train_step(cfg, tcfg, device="cuda")
            runs = [host_ms(lambda: eager(state, batch, seeded(5)())) for _ in range(3)]
            row.update(eager_ms=sorted(runs)[1], eager_runs_ms=runs)
        steps.append(row)
        del state
        log(f"[dropout d] crop {L}, accum 16, captured step {label}: {median:.2f} ms "
            f"(runs {[round(t, 2) for t in times]})"
            + (f"; eager {row['eager_ms']:.2f} ms" if "eager_ms" in row else ""))
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    pool, streams = GraphPool(), Streams("cuda")
    exes = {init: CapturedExecutable(params, cfg, batch=1, bucket=384, msa_rows=ENGINE_ROWS,
                                     mds_iters=200, device=torch.device("cuda", 0), pool=pool,
                                     mds_init=init, streams=streams)
            for init in ("classical", "random")}
    inputs = engine_batch((384,), 384, seed=434)
    calls = {"n": 0}

    def request(init):
        calls["n"] += 1
        out = exes[init](*inputs, seed=fold_in(7, calls["n"]))
        return {k: v.cpu() for k, v in out.items()}

    arms = {init: functools.partial(request, init) for init in exes}
    ms = {init: [] for init in exes}
    for fn in arms.values():
        fn()
    for order in [("classical", "random"), ("random", "classical")] * ((reps + 1) // 2):
        for init in order:
            t0 = time.perf_counter()
            arms[init]()
            ms[init].append((time.perf_counter() - t0) * 1e3)
    served = {}
    for init, fn in arms.items():
        mean = sum(ms[init][:reps]) / reps
        prof = profile_request(fn)
        served[init] = {"request_ms": mean, "runs_ms": ms[init][:reps], **prof,
                        "captured_launches": exes[init].launches,
                        "busy_share": prof["device_ms"] / mean if prof["device_kernels"]
                        else None}
    busy = lambda v: "not measured" if v is None else f"{v:.3f}"  # noqa: E731
    c, r = served["classical"], served["random"]
    log(f"[dropout d] L=384 captured request: classical init {c['request_ms']:.2f} ms "
        f"({c['kernel_launches']} kernel launches, {c['graph_launches']} graph launches, "
        f"busy {busy(c['busy_share'])}), random init {r['request_ms']:.2f} ms "
        f"({r['kernel_launches']} kernel launches, {r['graph_launches']} graph launches, "
        f"busy {busy(r['busy_share'])}); captured B1f launches "
        f"{c['captured_launches'].get('flash_fwd', 0)} / {r['captured_launches'].get('flash_fwd', 0)}")
    RECORD["phases"]["dropout_timing"] = {"steps": steps, "served_384": served}


def phase_dropout_random_init():
    """15: live dropout in the captured train step and the random MDS init
    in the captured engine. Returns (a)'s and (c)'s launches."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"dropout_{key}_s"] = time.perf_counter() - t
        log(f"[time] dropout {key}: {RECORD['phases'][f'dropout_{key}_s']:.1f} s")
        return result

    launches = dict(timed("a", phase_dropout_step))
    timed("b", phase_dropout_schedules)
    for name, n in timed("c", phase_random_init_engine).items():
        launches[name] = launches.get(name, 0) + n
    timed("d", phase_dropout_timing)
    return launches

# --- phase 16: attention dropout inside the block-sparse kernels ---------------------

SPARSE_DROPOUT_RATES = (0.1, 0.5)  # 16a's rates
SPARSE_DROPOUT = 0.1  # 16b, 16d and 16e's attention dropout
SPARSE_RECOMPUTE_DROPOUT = 0.2  # 16c's
DROP_KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
# 32-bit integer operations an element's keep bit costs: one Philox4x32-10
# call (10 rounds of two mul.hi, two mul.lo, four xor and two key adds, and
# four compares: ~104) serves a group of four elements (csrc/philox.cuh)
PHILOX_OPS = 26


def sparse_dropout_bf16_bound(q, k, v, bias, table, heads, out, lse, g, scale, rate, seed):
    """`sparse_bwd_bf16_bound` with attention dropout, from the same
    derivation on the dropped function: dS = P (dP Z - delta) and dV = (P
    Z)^T dO with Z = keep / (1 - rate) (the plain version's bits,
    `philox_keep`). The kernels round dS and P Z to bf16 before their
    products, half an ulp (2^-8) each, so dq moves by at most 2^-8 scale
    |dS| |K|, dk by 2^-8 scale |dS|^T |Q| and dv by 2^-8 (P Z)^T |dO|; dP Z
    differs between the sides by Z dh 2^-23 |dO| |V|^T (dP a sum of dh f32
    products, in another order; the product by Z rounds both sides alike)
    and delta by dh 2^-23 rowsum(|dO| |O|), so E = P dh 2^-23 (Z |dO| |V|^T
    + rowsum(|dO| |O|)) adds scale E |K| to dq and scale E^T |Q| to dk.
    Every absolute sum carries the keep factors, up to 1 / (1 - rate): the
    bound grows with the rate as the errors do. Plus one bf16 ulp of each
    output. Returns (the plain version's (dq, dk, dv), the three bounds)."""
    BH, n, dh = q.shape
    ref = sparse_kernel.sparse_bwd_plain(q, k, v, bias, table, heads, out, lse, g, scale,
                                         dropout_rate=rate, seed=seed)
    dense = sparse_dense_bias(bias, table, heads)
    delta = flash_kernel.cotangent_terms(out, g)[1]
    delta_abs = (g.float().abs() * out.float().abs()).sum(dim=-1)
    kf, vf = k.float(), v.float()
    ka, va = kf.abs(), vf.abs()
    bdq = torch.empty((BH, n, dh), dtype=torch.float32, device=q.device)
    bdk, bdv = torch.zeros_like(bdq), torch.zeros_like(bdq)
    edq, edk = torch.empty_like(bdq), torch.zeros_like(bdq)
    bh = torch.arange(BH, device=q.device)[:, None, None]
    cols = torch.arange(n, device=q.device)[None, None, :]
    step = max(1, flash_kernel.BWD_TILE_ELEMS // (BH * n))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        qs, gs = q[:, r0:r1].float(), g[:, r0:r1].float()
        p = torch.exp(torch.bmm(qs, kf.transpose(1, 2)) * scale + dense[:, r0:r1]
                      - lse[:, r0:r1, None])
        rows = torch.arange(r0, r1, device=q.device)[None, :, None]
        z = torch.where(sparse_kernel.philox_keep(seed, bh, rows, cols, rate),
                        1.0 / (1.0 - rate), 0.0)
        ds = (p * (z * torch.bmm(gs, vf.transpose(1, 2)) - delta[:, r0:r1, None])).abs()
        bdq[:, r0:r1] = torch.bmm(ds, ka) * scale
        bdk += torch.bmm(ds.transpose(1, 2), qs.abs()) * scale
        bdv += torch.bmm((p * z).transpose(1, 2), gs.abs())
        e = p * (dh * 2.0 ** -23) * (z * torch.bmm(gs.abs(), va.transpose(1, 2))
                                     + delta_abs[:, r0:r1, None])
        edq[:, r0:r1] = torch.bmm(e, ka) * scale
        edk += torch.bmm(e.transpose(1, 2), qs.abs()) * scale
        del p, z, ds, e
    bounds = tuple(2.0 ** -8 * b + e + BF16_ULP * r.float().abs()
                   for b, e, r in ((bdq, edq, ref[0]), (bdk, edk, ref[1]), (bdv, 0.0, ref[2])))
    return ref, bounds


def check_sparse_dropout(label, b, heads, n, dh, dtype, scfg, rate, *, masked_b=()):
    """(a) B5f, B5 dq and B5 dkv with attention dropout at `rate` on the
    route the call's shape picks, from one seed tensor on the card, against
    sparse_fwd_plain and sparse_bwd_plain with the same seed (the plain
    versions draw the same bits, `philox_keep`), at phase 3's tolerances:
    the forward f32 1e-5 * max(1, max|ref|), bf16 one bf16 ulp of the
    largest output, lse 1e-4 and equal to the lse without dropout (the
    undropped P's); the backward f32 1e-5 * max(1, max|ref|), bf16
    `sparse_dropout_bf16_bound`. Each kernel counts one launch under its
    name, its route and its dropout count. Rate 0 with the seed gives the
    kernels without dropout bit for bit, forward and backward; a second
    seed gives another output. Batch elements `masked_b`: zeros, lse =
    +inf, zero gradients."""
    q, k, v, do, bias, table = sparse_inputs(b, heads, n, dh, dtype, scfg, masked_b=masked_b,
                                             seed=7)
    scale = dh ** -0.5
    args = (q, k, v, bias, table, heads)
    gen = torch.Generator(device="cuda").manual_seed(1000 * n + int(rate * 100))
    seed, other_seed = sparse.draw_seed(gen, "cuda"), sparse.draw_seed(gen, "cuda")
    drop = dict(dropout_rate=rate, seed=seed)
    which = sparse_kernel.route(q, table)
    before = dict(sparse_kernel.LAUNCHES)
    out, lse = sparse_kernel.sparse_fwd(*args, scale, **drop)
    grads = sparse_kernel.sparse_bwd(*args, out, lse, do, scale, **drop)
    sync()
    counted = {f"{kernel}{suffix}" for kernel in DROP_KERNELS
               for suffix in ("", f"_{which}", "_dropout")}
    counts = all(sparse_kernel.LAUNCHES[name] - before[name] == int(name in counted)
                 for name in before)
    # without dropout: no seed, and rate 0 with the seed, bit for bit
    off_out, off_lse = sparse_kernel.sparse_fwd(*args, scale)
    zero_out, zero_lse = sparse_kernel.sparse_fwd(*args, scale, dropout_rate=0.0, seed=seed)
    off_grads = sparse_kernel.sparse_bwd(*args, off_out, off_lse, do, scale)
    zero_grads = sparse_kernel.sparse_bwd(*args, zero_out, zero_lse, do, scale,
                                          dropout_rate=0.0, seed=seed)
    rate0 = (torch.equal(off_out, zero_out) and torch.equal(off_lse, zero_lse)
             and all(torch.equal(a, z) for a, z in zip(off_grads, zero_grads)))
    lse_undropped = torch.equal(lse, off_lse)
    other = not torch.equal(sparse_kernel.sparse_fwd(*args, scale, dropout_rate=rate,
                                                     seed=other_seed)[0], out)
    again = sparse_kernel.sparse_fwd(*args, scale, **drop)
    deterministic = torch.equal(again[0], out) and torch.equal(again[1], lse)
    del off_out, zero_out, off_grads, zero_grads, again
    ref_out, ref_lse = sparse_kernel.sparse_fwd_plain(*args, scale, **drop)
    ref_max = ref_out.float().abs().max().item()
    tol = 1e-5 * max(1.0, ref_max) if dtype == torch.float32 else BF16_ULP * ref_max
    fin = torch.isfinite(ref_lse)
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0
    ok = (err <= tol and lse_err <= 1e-4 and bool(torch.isfinite(out).all())
          and torch.equal(torch.isposinf(lse), torch.isposinf(ref_lse)))
    del ref_out, ref_lse
    if dtype == torch.float32:
        ref = sparse_kernel.sparse_bwd_plain(*args, out, lse, do, scale, **drop)
        bounds = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    else:
        ref, bounds = sparse_dropout_bf16_bound(*args, out, lse, do, scale, rate, seed)
    errs, ratios = [], []
    for got, want, bound in zip(grads, ref, bounds):
        diff = (got.float() - want.float()).abs()
        bound = torch.as_tensor(bound, device=diff.device)
        errs.append(diff.max().item())
        ratios.append(torch.where(bound > 0, diff / bound,
                                  torch.where(diff > 0, math.inf, 0.0)).max().item())
        ok = ok and bool(torch.isfinite(got).all())
    for i in masked_b:
        rows = slice(i * heads, (i + 1) * heads)
        ok = ok and bool((out[rows] == 0).all()) and bool(torch.isposinf(lse[rows]).all())
        ok = ok and all(bool((t[rows] == 0).all()) for t in grads)
    ok = (ok and max(ratios) <= 1.0 and counts and rate0 and lse_undropped and other
          and deterministic)
    row = {"case": label, "rate": rate, "shape": [b * heads, n, dh],
           "block_size": scfg.block_size, "dtype": str(dtype),
           "active": table.nnz / table.n_blocks ** 2, "route": which, "fwd_err": err,
           "fwd_tol": tol, "lse_err": lse_err, "dq_err": errs[0], "dkv_err": max(errs[1:]),
           "bound_ratio": max(ratios), "counts": counts, "rate0_bit_equal": rate0,
           "lse_undropped": lse_undropped, "second_seed_differs": other,
           "deterministic": deterministic, "ok": bool(ok)}
    log(f"[sparse dropout a] {label:14s} rate {rate} {str(tuple(row['shape'])):16s} bs "
        f"{scfg.block_size:3d} {str(dtype).split('.')[-1]:8s} {which}: fwd|d|={err:.2e} "
        f"(tol {tol:.2e}) lse|d|={lse_err:.1e} dq|d|={errs[0]:.2e} dkv|d|={max(errs[1:]):.2e} "
        f"(bound ratio {max(ratios):.3f}); counts {counts}, rate 0 bit-equal {rate0}, lse "
        f"undropped {lse_undropped}, 2nd seed differs {other} {'ok' if ok else 'FAIL'}")
    del q, k, v, do, bias, out, lse, grads, ref, bounds
    torch.cuda.empty_cache()
    return row


def phase_sparse_dropout_kernels():
    """(a) the three kernels with dropout against their plain versions at
    rates 0.1 and 0.5 on every route: wgmma at the trained (2048, 256, 64)
    and served (3072, 384, 64) shapes, mma_sync at block size 32 and at
    dh 32, f32; masked batch elements on three of them."""
    cases = [
        ("trained wgmma", 256, 8, 256, 64, torch.bfloat16, 16, 256, ()),
        ("served wgmma", 384, 8, 384, 64, torch.bfloat16, 16, 384, ()),
        ("mma_sync bs 32", 4, 2, 384, 64, torch.bfloat16, 32, 384, (1,)),
        ("mma_sync dh 32", 4, 4, 384, 32, torch.bfloat16, 16, 384, (2,)),
        ("f32", 4, 2, 384, 64, torch.float32, 16, 384, (2,)),
    ]
    rows = []
    for label, b, heads, n, dh, dtype, bs, msl, masked in cases:
        scfg = sparse.SparseConfig(block_size=bs, max_seq_len=msl)
        for rate in SPARSE_DROPOUT_RATES:
            rows.append(check_sparse_dropout(label, b, heads, n, dh, dtype, scfg, rate,
                                             masked_b=masked))
    want = {"trained wgmma": "wgmma", "served wgmma": "wgmma", "mma_sync bs 32": "mma_sync",
            "mma_sync dh 32": "mma_sync", "f32": "f32"}
    off = [r["case"] for r in rows if r["route"] != want[r["case"]]]
    RECORD["phases"]["sparse_dropout_kernels"] = rows
    if off or not all(r["ok"] for r in rows):
        fail("a block-sparse kernel with dropout disagrees with its plain version, left its "
             f"route or miscounted (phase 16a): {[r['case'] for r in rows if not r['ok']]} "
             f"{off}")
    return rows


@contextlib.contextmanager
def plain_versions_refused():
    """Inside: the gather version and B5's plain versions raise when called
    (a CUDA tensor must reach the kernels)."""
    def refused(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain or gather version of B5")

    saved = [(sparse, "block_sparse_attention")] + [
        (sparse_kernel, name) for name in ("sparse_fwd_plain", "sparse_bwd_plain",
                                           "sparse_bwd_dq_plain", "sparse_bwd_dkv_plain")]
    originals = [getattr(module, name) for module, name in saved]
    for module, name in saved:
        setattr(module, name, refused)
    try:
        yield
    finally:
        for (module, name), fn in zip(saved, originals):
            setattr(module, name, fn)


def sparse_dropout_config(**fields):
    """train_pre's widths (dim 256, depth 1, heads 8, dim_head 64) in bf16
    with layer 0 sparse at max_seq_len 256 (0.66 of the blocks active at
    crop 256), `fields` over them."""
    return train_pre_config(**{**dict(sparse_self_attn=True, max_seq_len=256), **fields})


def phase_sparse_dropout_step(L=256, accum=2):
    """(b) the sparse train step with attention and FF dropout 0.1 (bf16,
    crop L, accum 2): the captured step against the eager step over 3
    steps with three step rngs, bit for bit (`capture_vs_eager`: loss,
    grad_norm, every param, AdamW moment and count), every B5 launch of
    the capture on wgmma; one batch under two rngs gives two losses; no
    plain or gather version runs (`plain_versions_refused`). Returns the
    launches from a reset just before to just after: the eager steps, the
    warm-up and capture, and the replays (the capture's launches times its
    replays); every B5 launch among them drops."""
    cfg = sparse_dropout_config(attn_dropout=SPARSE_DROPOUT, ff_dropout=SPARSE_DROPOUT)
    with plain_versions_refused():
        captured, state, batch = capture_vs_eager("sparse dropout", cfg, L, accum, wgmma=True,
                                                  rngs=[61, 62, 63])
        losses = two_rngs_differ(captured, state, batch, seeds=(64, 65))
    sync()
    launches = launch_counts()
    for name, n in captured.replayed_launches().items():
        launches[name] = launches.get(name, 0) + n
    capture = next(iter(captured.captures.values()))
    dropping = all(launches[f"{k}_dropout"] == launches[k] > 0 for k in DROP_KERNELS)
    ok = (losses[0] != losses[1] and len(captured.captures) == 1 and on_wgmma(launches)
          and dropping)
    log(f"[sparse dropout b] crop {L}, accum {accum}, attn and ff dropout {SPARSE_DROPOUT}: "
        f"one batch under two rngs, losses {losses}; captured launches {capture.launches}; "
        f"launches {dict((k, n) for k, n in launches.items() if n and k.startswith('sparse'))}"
        f"{', all on wgmma' if on_wgmma(launches) else ', OFF wgmma'}, every B5 launch "
        f"dropping {dropping} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["sparse_dropout_step"] = {
        "L": L, "grad_accum": accum, "config": repr(cfg), "two_rng_losses": losses,
        "captured_launches": capture.launches, "launches": launches, "ok": ok}
    del captured, state
    if not ok:
        fail("the captured sparse dropout step replays frozen masks, left wgmma or ran B5 "
             "without dropout (phase 16b)")
    return launches


def rev_dropout_grads(layers, cfg, x, m, gx, gm, reverse, rng_seed):
    """`trunk_grads` with dropout: the loss sum(out * g) of
    `reversible_trunk_apply` under a CPU generator seeded `rng_seed`, and
    its gradient in the inputs and every param leaf."""
    leaves = reversible.param_leaves(layers)
    x, m = x.clone().requires_grad_(True), m.clone().requires_grad_(True)
    xo, mo = reversible.reversible_trunk_apply(layers, cfg, x, m, reverse=reverse,
                                               rng=torch.Generator().manual_seed(rng_seed))
    loss = (xo.float() * gx.float()).sum() + (mo.float() * gm.float()).sum()
    return loss.item(), torch.autograd.grad(loss, [x, m] + leaves)


def phase_sparse_dropout_recompute(L=128, accum=2):
    """(c) the recomputes redraw the forward's masks, layer 0 sparse with
    attention dropout 0.2: the eager bf16 step (train_pre's widths, crop
    L, accum 2, max_seq_len L) with remat and remat_policy "dots" against
    the sequential step from the same params, batch and rng, bit for bit
    on loss, grad_norm and every param; the reversible trunk in f32
    (`reversible_parity_config`: depth 2, L = 64, a 16-row MSA) with
    reverse=True against plain autograd through the same masks, its loss
    within 1e-5 relative and each gradient leaf within 1e-4 of its largest
    entry (13a's tolerance), another rng another loss; B5 dropping on its
    wgmma and f32 routes."""
    tcfg = TrainConfig(grad_accum=accum)
    batch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=13), accum)(0)
    fields = dict(max_seq_len=L, attn_dropout=SPARSE_RECOMPUTE_DROPOUT)
    runs = {}
    reset_launches()
    with plain_versions_refused():
        for label, extra in (("sequential", {}),
                             ("remat dots", dict(remat=True, remat_policy="dots"))):
            cfg = sparse_dropout_config(**fields, **extra)
            state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
            _, metrics = make_train_step(cfg, tcfg, device="cuda")(
                state, batch, torch.Generator().manual_seed(71))
            runs[label] = (metrics, [t.detach().clone() for t in state["optimizer"].leaves])
            del state
        sync()
        remat_launches = launch_counts()
        (ms, ps), (mr, pr) = runs["sequential"], runs["remat dots"]
        remat_equal = (torch.equal(ms["loss"], mr["loss"])
                       and torch.equal(ms["grad_norm"], mr["grad_norm"])
                       and all(torch.equal(a, b) for a, b in zip(ps, pr)))
        cfg = reversible_parity_config(attn_dropout=SPARSE_RECOMPUTE_DROPOUT)
        layers = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")["trunk"]
        for t in reversible.param_leaves(layers):
            t.requires_grad_(True)
        x, m, gx, gm = trunk_inputs(cfg, 64, 16, 64, seed=23)
        reset_launches()
        loss_rev, rev = rev_dropout_grads(layers, cfg, x, m, gx, gm, True, 72)
        sync()
        rev_launches = launch_counts()
        loss_plain, plain = rev_dropout_grads(layers, cfg, x, m, gx, gm, False, 72)
        loss_other, _ = rev_dropout_grads(layers, cfg, x, m, gx, gm, False, 73)
    errs = grad_errors(rev, plain)
    loss_rel = abs(loss_rev - loss_plain) / abs(loss_plain)
    dropping = (remat_launches["sparse_fwd_dropout"] > 0
                and remat_launches["sparse_bwd_dq_dropout"] > 0
                and all(rev_launches[f"{k}_dropout"] == rev_launches[f"{k}_f32"] > 0
                        for k in DROP_KERNELS))
    ok = (remat_equal and loss_rel <= 1e-5 and max(errs) <= 1e-4 and loss_other != loss_plain
          and dropping)
    log(f"[sparse dropout c] remat dots vs sequential (bf16, crop {L}, accum {accum}): loss, "
        f"grad_norm and params bit-equal {remat_equal} (losses {float(ms['loss']):.6f} / "
        f"{float(mr['loss']):.6f}); reversible vs plain autograd (f32, {len(errs)} leaves): loss "
        f"rel {loss_rel:.2e} (1e-5), worst leaf {max(errs):.2e} of its largest (1e-4), another "
        f"rng {loss_other:.4f} vs {loss_plain:.4f}; B5 dropping {dropping} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["sparse_dropout_recompute"] = {
        "remat_bit_equal": remat_equal, "remat_launches": remat_launches,
        "reversible_loss_rel": loss_rel, "reversible_worst_leaf": max(errs),
        "reversible_launches": rev_launches, "ok": ok}
    if not ok:
        fail("a recompute with sparse attention dropout departs from the sequential step "
             "(phase 16c)")


def phase_sparse_dropout_cpu(L=128):
    """(d) `sparse_attention_apply` in f32 at L = 128 (batch 2, dim 128, 4
    heads of 32, block size 16; batch element 1's last 28 keys padded,
    element 0's keys 5% masked), attention dropout 0.1, one seed tensor
    handed to the card and to the CPU (`sparse.draw_seed` returning it:
    the layer's one draw): the output within 1e-5 * max(1, |ref|); the
    gradient of sum(out * g) in x and every param within 1e-4 of each
    leaf's largest entry; the card's call on B5's f32 dropout kernels."""
    cfg = AttentionConfig(dim=128, heads=4, dim_head=32, dropout=SPARSE_DROPOUT)
    scfg = sparse.SparseConfig(block_size=16, max_seq_len=L)
    gen = torch.Generator(device="cuda").manual_seed(81)
    x = torch.randn(2, L, 128, generator=gen, device="cuda")
    g = torch.randn(2, L, 128, generator=gen, device="cuda")
    mask = torch.rand(2, L, generator=gen, device="cuda") >= 0.05
    mask[1, L - 28:] = False
    seed = sparse.draw_seed(gen, "cuda")
    params = attention_init(torch.Generator().manual_seed(82), cfg, "cpu")
    reset_launches()
    got = {}
    draw = sparse.draw_seed
    sparse.draw_seed = lambda rng, device: seed.to(device)
    try:
        for dev in ("cuda", "cpu"):
            p = {name: {key: t.to(dev).requires_grad_() for key, t in d.items()}
                 for name, d in params.items()}
            xx = x.detach().to(dev).requires_grad_()
            out = sparse.sparse_attention_apply(p, cfg, scfg, xx, mask=mask.to(dev),
                                                rng=torch.Generator(dev))
            leaves = [xx] + list(tree_leaves(p))
            got[dev] = (out.detach().cpu(), [t.cpu() for t in torch.autograd.grad(
                out, leaves, g.to(dev))])
            if dev == "cuda":
                sync()
                launches = launch_counts()
    finally:
        sparse.draw_seed = draw
    err = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
    tol = 1e-5 * max(1.0, got["cpu"][0].abs().max().item())
    errs = grad_errors(got["cuda"][1], got["cpu"][1])
    dropping = all(launches[f"{k}_dropout"] == launches[f"{k}_f32"] == 1 for k in DROP_KERNELS)
    ok = err <= tol and max(errs) <= 1e-4 and dropping
    log(f"[sparse dropout d] f32 L={L}, one seed on both devices: out |d|={err:.2e} (tol "
        f"{tol:.2e}), worst gradient leaf {max(errs):.2e} of its largest (1e-4), "
        f"{len(errs)} leaves; the card on B5's f32 dropout kernels {dropping} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["sparse_dropout_cpu"] = {"out_err": err, "out_tol": tol,
                                              "grad_worst": max(errs), "ok": ok}
    if not ok:
        fail("sparse attention with dropout on the card departs from the CPU from one seed "
             "(phase 16d)")


def dropout_bound_terms(q, bias, table, kind):
    """`sparse_bound_terms` with dropout: the same bytes (and the seed's
    16), the tensor cores' operations as without, and PHILOX_OPS 32-bit
    integer operations for each active element's keep bit on the CUDA
    cores at the float32 rate (67 TFLOP/s: the integer pipes are no
    faster). Operations: the larger of the two units' times (they run
    side by side). Returns (ops_ms, bytes_ms)."""
    ops_ms, bytes_ms = sparse_bound_terms(q, bias, table, kind)
    elements = float(q.shape[0]) * table.nnz * table.block_size ** 2
    philox_ms = PHILOX_OPS * elements / PEAK_FLOPS[torch.float32] * 1e3
    return max(ops_ms, philox_ms), bytes_ms + 16 / HBM_BYTES_PER_S * 1e3


def phase_sparse_dropout_timing(L=256, reps=5):
    """(e) times, reported. The captured crop-L sparse step (train_pre's
    widths, bf16, layer 0 sparse, accum 16) with no dropout, FF dropout
    0.1, and attention and FF dropout 0.1: median ms of `reps` replays
    (CUDA events, after one untimed). Each B5 kernel at (2048, 256, 64,
    0.66 active), with and without dropout 0.1 in turns (off, on, on, off;
    CUDA events, mean of 20 each), beside its plain version with dropout
    on the card (the gather version, 2 calls), SDPA with the layout as a
    boolean mask and dropout_p 0.1 (forward, or the backward for the
    kernel's gradients) and `dropout_bound_terms`."""
    tcfg = TrainConfig(grad_accum=16)
    batch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=11), 16)(0)
    steps = []
    for label, fields in (("no dropout", {}), ("ff 0.1", dict(ff_dropout=SPARSE_DROPOUT)),
                          ("attn+ff 0.1", dict(attn_dropout=SPARSE_DROPOUT,
                                               ff_dropout=SPARSE_DROPOUT))):
        cfg = sparse_dropout_config(**fields)
        state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
        step = CapturedTrainStep(cfg, tcfg, state, batch)
        median, times = captured_ms(step, state, batch, reps, make_rng=seeded(5))
        steps.append({"label": label, "captured_ms": median, "captured_runs_ms": times,
                      "captured_launches": next(iter(step.captures.values())).launches})
        del step, state
        log(f"[sparse dropout e] crop {L}, accum 16, captured sparse step {label}: "
            f"{median:.2f} ms (runs {[round(t, 2) for t in times]})")
    q, k, v, do, bias, table = sparse_inputs(256, 8, 256, 64, torch.bfloat16,
                                             sparse.SparseConfig(block_size=16, max_seq_len=256))
    scale, heads = 0.125, 8
    args = (q, k, v, bias, table, heads)
    drop = dict(dropout_rate=SPARSE_DROPOUT,
                seed=sparse.draw_seed(torch.Generator(device="cuda").manual_seed(91), "cuda"))
    out, lse = sparse_kernel.sparse_fwd(*args, scale, **drop)
    delta = flash_kernel.cotangent_terms(out, do)[1]
    bwd = (q, k, v, bias, table, heads, lse, do, delta, scale)
    calls = {"fwd": (lambda **kw: sparse_kernel.sparse_fwd(*args, scale, **kw)),
             "dq": (lambda **kw: sparse_kernel.launch_dq(*bwd, **kw)),
             "dkv": (lambda **kw: sparse_kernel.launch_dkv(*bwd, **kw))}
    plains = {"fwd": lambda: sparse_kernel.sparse_fwd_plain(*args, scale, **drop),
              "dq": lambda: sparse_kernel.sparse_bwd_dq_plain(*bwd, **drop),
              "dkv": lambda: sparse_kernel.sparse_bwd_dkv_plain(*bwd, **drop)}
    mask = torch.isfinite(sparse_dense_bias(bias, table, heads))[None]
    row = {"shape": [256 * heads, 256, 64], "active": table.nnz / table.n_blocks ** 2}
    for kind, fn in calls.items():
        off = [time_ms(fn, 20)]
        on = [time_ms(lambda: fn(**drop), 20), time_ms(lambda: fn(**drop), 20)]
        off.append(time_ms(fn, 20))
        row[f"{kind}_ms"], row[f"{kind}_nodrop_ms"] = sum(on) / 2, sum(off) / 2
        row[f"{kind}_runs_ms"], row[f"{kind}_nodrop_runs_ms"] = on, off
        row[f"{kind}_plain_ms"] = time_ms(plains[kind], 2)
        wrt = {"fwd": None, "dq": "q", "dkv": "kv"}[kind]
        row[f"{kind}_library_ms"] = sdpa_mask_ms(q, k, v, mask, scale, 10,
                                                 None if wrt is None else do, wrt,
                                                 dropout_p=SPARSE_DROPOUT)
        t_ops, t_bytes = dropout_bound_terms(q, bias, table, kind)
        row[f"{kind}_ops_ms"], row[f"{kind}_bytes_ms"] = t_ops, t_bytes
        row[f"{kind}_bound_ms"] = max(t_ops, t_bytes)
        lib = row[f"{kind}_library_ms"]
        log(f"[sparse dropout e] B5 {kind} (2048, 256, 64, {row['active']:.2f}) dropout "
            f"{SPARSE_DROPOUT}: {row[f'{kind}_ms']:.4f} ms (runs "
            f"{[round(t, 4) for t in on]}) against {row[f'{kind}_nodrop_ms']:.4f} without "
            f"({[round(t, 4) for t in off]}); plain {row[f'{kind}_plain_ms']:.3f}, SDPA "
            f"dropout_p {SPARSE_DROPOUT} {'none' if lib is None else f'{lib:.4f}'}, bound "
            f"{row[f'{kind}_bound_ms']:.4f} ({'operations' if t_ops >= t_bytes else 'bytes'})")
    RECORD["phases"]["sparse_dropout_timing"] = {"steps": steps, "kernels": row}
    del q, k, v, do, out, lse, delta, mask
    torch.cuda.empty_cache()
    return row


def phase_sparse_dropout():
    """16: attention dropout inside the block-sparse kernels. Returns (a)'s
    rows, (b)'s launches and (e)'s kernel times."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"sparse_dropout_{key}_s"] = time.perf_counter() - t
        log(f"[time] sparse dropout {key}: {RECORD['phases'][f'sparse_dropout_{key}_s']:.1f} s")
        return result

    rows = timed("a", phase_sparse_dropout_kernels)
    launches = timed("b", phase_sparse_dropout_step)
    timed("c", phase_sparse_dropout_recompute)
    timed("d", phase_sparse_dropout_cpu)
    times = timed("e", phase_sparse_dropout_timing)
    return rows, launches, times


# --- phase 5: the kernels line -----------------------------------------------------


# --- phase 17: the telemetry plane -----------------------------------------------------

TELEMETRY_WORK = ROOT / "build" / "phase17"  # flight bundles, traces, logs; removed at the end
H100_PEAK_BF16 = 989e12  # dense bf16, declared only once the card's name says H100
SCRAPED = ("/metrics", "/healthz", "/statusz")


class FreezableClock:
    """`time.monotonic` until `freeze()`: then every read is one instant, so
    a ledger's buckets and its wall are read at the same time."""

    def __init__(self):
        self.frozen = None

    def __call__(self):
        return time.monotonic() if self.frozen is None else self.frozen

    def freeze(self):
        self.frozen = time.monotonic()


def http_get(url, timeout=10):
    """(status, body) of one GET; an HTTP error status is an answer too."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def scrape_loop(base, stop, out, pause_s=0.02):
    """GET /metrics, /healthz and /statusz in turn, `pause_s` between
    rounds, until `stop` is set, appending (path, status, t0, t1) on the
    perf_counter clock. The pause keeps the loop from holding the GIL
    between rounds, which the worker's capture needs too."""
    while not stop.wait(pause_s):
        for path in SCRAPED:
            t0 = time.perf_counter()
            try:
                code = http_get(base + path)[0]
            except Exception as e:  # noqa: BLE001 — a refused scrape is a result
                code = repr(e)
            out.append((path, code, t0, time.perf_counter()))


def nested_seconds(span, inner):
    """The seconds of `inner` spans inside `span` on its thread."""
    t0, t1 = span["ts_s"], span["ts_s"] + span["dur_s"]
    return sum(s["dur_s"] for s in inner
               if s["tid"] == span["tid"] and t0 <= s["ts_s"] and s["ts_s"] + s["dur_s"] <= t1)


def phase_telemetry_engine(smi, plane):
    """(a) The served config (dim 256, depth 2, heads 8, dim_head 64, bf16;
    buckets 128 / 256 / 384, rungs 1, 2, 4; 20-row MSAs, 200 MDS
    iterations; no result cache, no assembly wait) through a fully
    instrumented `ServingEngine`: a live tracer, its private cost ledger,
    a serve-goodput ledger on a freezable clock, a `FlightBook`, a
    `FlightRecorder` as its incident hook, and an `OpsServer` (port 0)
    with the stock serving SLOs and a `ProfileCapturer` on the engine's
    graph lock. No precompile: phase 8b's stream of 24 requests captures
    each (bucket, rung) it meets while a thread scrapes /metrics, /healthz
    and /statusz in a loop. Checks: no capture fails and every scrape
    answers 200 (some during a capture); each request's enqueue and
    queue_wait spans carry its trace id and its batch, execute and respond
    spans list it; /explainz?trace_id= returns each flight; /metrics parses
    and its counters equal stats(); the goodput causes sum to the frozen
    wall within 1e-9 s with idle left over; each cell's analytic FLOPs are
    `model_fwd_flops` at its bucket; each execute span's event time is at
    most its host window less any capture in it; each measured cell's EMA
    is > 0, at most its largest such window and at most 2x the median of
    its event times; the SLO engine publishes its burn rates; no cell has
    an MFU until a peak is declared (989 TFLOP/s, only on an H100), then
    each measured one does; every B1f launch on wgmma."""
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    scfg = ServingConfig(buckets=ENGINE_BUCKETS, max_batch=4, batch_ladder=True,
                         msa_rows=ENGINE_ROWS, mds_iters=200, request_timeout_s=600.0,
                         cache_capacity=0, max_wait_s=0.0)
    tracer = Tracer()
    clock = FreezableClock()
    goodput = ServeGoodputLedger(clock=clock)
    recorder = FlightRecorder(str(TELEMETRY_WORK / "flight"), tracer=tracer)
    engine = ServingEngine(params, cfg, scfg, tracer=tracer, goodput=goodput,
                           flights=FlightBook(), incident_hook=recorder.incident)
    plane.update(params=params, cfg=cfg, scfg=scfg, engine=engine, tracer=tracer)
    registry = engine.metrics.registry
    goodput.registry = registry  # its gauges on the engine's /metrics
    recorder.bind(registry=registry, stats_fn=engine.stats)
    slo = SloEngine(registry, default_slo_config("serving"), on_page=recorder.slo_page_hook)
    profiler = ProfileCapturer(str(TELEMETRY_WORK / "profiles"), registry=registry,
                               max_duration_s=2.0, min_interval_s=30.0, lock=engine.graph_lock)
    ops = ops_server_for_engine(engine, tracer=tracer, slo=slo, recorder=recorder,
                                profiler=profiler, tick_interval_s=0.1)
    ops.add_tick(lambda: host_memory_gauges(registry))
    ops.add_tick(lambda: device_memory_gauges(registry))
    ops.add_tick(engine.sample_gauges)
    ops.start()
    plane.update(ops=ops, profiler=profiler)
    stream = engine_stream()
    scrapes, stop = [], threading.Event()
    scraper = threading.Thread(target=scrape_loop, args=(ops.url, stop, scrapes),
                               name="af2-smoke-scraper", daemon=True)
    scraper.start()
    t0 = time.perf_counter()
    reqs = [engine.submit(seq, msa=msa, msa_mask=mm) for seq, msa, mm in stream]
    results = [r.result(timeout=600) for r in reqs]
    stream_s = time.perf_counter() - t0
    stop.set()
    scraper.join(30)
    ops.tick()
    stats = engine.stats()
    spans = tracer.spans()
    captures = [s for s in spans if s["name"] == "serving_capture"]
    origin = tracer._t_origin
    during = sum(1 for _, _, a, b in scrapes
                 if any(c["ts_s"] <= b - origin and a - origin <= c["ts_s"] + c["dur_s"]
                        for c in captures))
    counters = stats["telemetry"]["metrics"]["counters"]
    captures_ok = (len(stats["captures"]) == len(captures) > 0
                   and stats["requests"]["completed"] == len(stream)
                   and stats["requests"]["failed"] == 0
                   and not any(k.startswith("serving_capture_failed_total") for k in counters)
                   and all(r.coords.shape == (len(q[0]), 3) and np.isfinite(r.coords).all()
                           for r, q in zip(results, stream)))
    scrapes_ok = bool(scrapes) and all(code == 200 for _, code, _, _ in scrapes) and during > 0

    def spans_of(tid):
        return {s["name"] for s in spans if s["attrs"].get("trace_id") == tid
                or tid in s["attrs"].get("trace_ids", ())}

    lifecycle = {"serving.enqueue", "serving.queue_wait", "serving.batch", "serving.execute",
                 "serving.respond"}
    spans_ok = all(lifecycle <= spans_of(r.trace_id) for r in reqs)
    explain_ok = True
    for r in reqs:
        code, body = http_get(f"{ops.url}/explainz?trace_id={r.trace_id}")
        flight = json.loads(body)
        explain_ok &= code == 200 and flight["outcome"] == "completed" and \
            flight["trace_id"] == r.trace_id
    code, body = http_get(ops.url + "/metrics")
    parsed = parse_prometheus_text(body.decode())
    metrics_ok = (code == 200
                  and parsed[("serving_requests_total", (("outcome", "completed"),))]
                  == stats["requests"]["completed"]
                  and parsed[("serving_batches_total", ())] == stats["batches"]["count"]
                  and sum(v for (n, _), v in parsed.items() if n == "serving_capture_total")
                  == len(stats["captures"]))
    burn = {(dict(k)["objective"], dict(k)["window"]) for (n, k), _ in parsed.items()
            if n == "slo_burn_rate"}
    slo_ok = burn == {(o.name, w) for o in slo.config.objectives for w in ("fast", "slow")}
    clock.freeze()
    totals, wall = goodput.totals("engine"), goodput.wall("engine")
    goodput_ok = (abs(sum(totals.values()) - wall) <= 1e-9 and totals["idle"] > 0
                  and totals["compile"] > 0 and totals["execute"] > 0)
    # the cells: analytic FLOPs, and the EMA against the host windows and
    # the event times of that cell's dispatches
    executes = [s for s in spans if s["name"] == "serving.execute"]
    cells, cells_ok = [], True
    for cell in stats["costs"]["cells"]:
        mine = [s for s in executes if (s["attrs"]["bucket"], s["attrs"]["batch"])
                == (cell["bucket"], cell["max_batch"])]
        windows = [s["dur_s"] - nested_seconds(s, captures) for s in mine]
        events = [s["attrs"]["device_ms"] / 1e3 for s in mine]
        flops_ok = cell["forward_flops"] == model_fwd_flops(cfg, n=cell["bucket"],
                                                             r=ENGINE_ROWS, c=cell["bucket"])
        row = {k: cell[k] for k in ("bucket", "max_batch", "schedule", "backend_arm",
                                    "forward_flops", "residency_bytes", "batches",
                                    "ema_batch_seconds")}
        ok = flops_ok and cell["batches"] == len(mine) and "mfu" not in cell
        if mine:
            ema = cell["ema_batch_seconds"]
            ok &= (all(e <= w for e, w in zip(events, windows)) and 0 < ema <= max(windows)
                   and ema <= 2 * float(np.median(events)))
            row.update(event_ms=[e * 1e3 for e in events], window_ms=[w * 1e3 for w in windows])
        row["ok"] = ok
        cells_ok &= ok
        cells.append(row)
    peak = H100_PEAK_BF16 if "H100" in smi else None
    engine.costs.set_peak(peak)
    mfu = {f"{c['bucket']}@b{c['max_batch']}": c.get("mfu")
           for c in engine.costs.cells() if c["batches"]}
    mfu_ok = peak is None or all(v is not None for v in mfu.values())
    ok = (captures_ok and scrapes_ok and spans_ok and explain_ok and metrics_ok and slo_ok
          and goodput_ok and cells_ok and mfu_ok)
    for row in cells:
        if row["batches"]:
            log(f"[telemetry a] cell {row['bucket']} rung {row['max_batch']}: "
                f"{row['batches']} batches, EMA {row['ema_batch_seconds'] * 1e3:.3f} ms, events "
                f"{[round(x, 3) for x in row['event_ms']]} ms in host windows "
                f"{[round(x, 3) for x in row['window_ms']]} ms, forward "
                f"{row['forward_flops']:.4g} FLOPs, {row['residency_bytes']:,} bytes priced "
                f"{'ok' if row['ok'] else 'FAIL'}")
    log(f"[telemetry a] {len(stream)} requests in {stream_s:.2f} s, {len(captures)} captures "
        f"(each under its batch's trace ids), {len(scrapes)} scrapes all 200: "
        f"{scrapes_ok} ({during} during a capture); lifecycle spans {spans_ok}, /explainz "
        f"{explain_ok}, /metrics = stats() {metrics_ok}, SLO burn gauges {slo_ok}; goodput "
        f"{dict((k, round(v, 4)) for k, v in totals.items())} = wall {wall:.4f} s: "
        f"{goodput_ok}; MFU under {peak / 1e12 if peak else 'no'} TFLOP/s declared "
        f"({smi}): {dict((k, round(v, 5) if v else v) for k, v in mfu.items())} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["telemetry_engine"] = {
        "card": smi, "stream_s": stream_s, "captures": stats["captures"],
        "scrapes": len(scrapes), "scrapes_during_capture": during,
        "scrape_codes": sorted({str(c) for _, c, _, _ in scrapes}), "spans_ok": spans_ok,
        "explainz_ok": explain_ok, "metrics_ok": metrics_ok, "slo_burn_gauges": sorted(burn),
        "goodput": totals, "goodput_wall_s": wall, "cells": cells, "peak_flops": peak,
        "mfu": mfu, "span_summary": stats["telemetry"]["spans"], "ok": ok}
    if not ok:
        fail("the instrumented engine failed a telemetry check (phase 17a)")


def telemetry_requests():
    """17b's requests: one of each bucket's length, 20-row MSAs."""
    rng = np.random.default_rng(170)
    return [engine_request(L, rng) for L in (100, 250, 384)]


def median_ci(diffs):
    """The median of paired differences and its distribution-free 95%
    interval: the order statistics k and n - k + 1 (1-based) of the sorted
    differences, k the largest with P(Binomial(n, 1/2) < k) <= 0.025."""
    d, n = sorted(diffs), len(diffs)
    k, tail = 0, 0.0
    while tail + math.comb(n, k) / 2 ** n <= 0.025:
        tail += math.comb(n, k) / 2 ** n
        k += 1
    return float(np.median(d)), (d[k - 1], d[n - k]) if k else (d[0], d[-1])


def phase_telemetry_no_number(plane, pairs=40):
    """(b) Telemetry changes no number: 17b's three requests (L = 100, 250,
    384), one at a time (each a rung-1 batch), through the instrumented
    engine of (a) and through an engine with nothing passed in (the same
    params and config; no CUDA events, no spans, private ledgers): coords,
    confidence and stress bit for bit. Then the L = 384 request through
    both, host clock around `predict`, `pairs` pairs in turns: the median
    of the paired differences and its 95% interval is the
    instrumentation's cost."""
    inst = plane["engine"]
    plain = ServingEngine(plane["params"], plane["cfg"], plane["scfg"])
    plane["plain"] = plain
    reqs = telemetry_requests()
    got = {}
    for name, eng in (("instrumented", inst), ("plain", plain)):
        got[name] = [eng.predict(q, msa=m, msa_mask=mm, timeout=600) for q, m, mm in reqs]
    equal = all(np.array_equal(a.coords, b.coords) and np.array_equal(a.confidence, b.confidence)
                and a.stress == b.stress for a, b in zip(got["instrumented"], got["plain"]))
    last = reqs[-1]
    times = {"instrumented": [], "plain": []}
    for i in range(pairs):
        # alternate which engine goes first, so drift reaches both alike
        order = (("instrumented", inst), ("plain", plain))
        for name, eng in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            eng.predict(last[0], msa=last[1], msa_mask=last[2], timeout=600)
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    diffs = [a - b for a, b in zip(times["instrumented"], times["plain"])]
    diff, (lo, hi) = median_ci(diffs)
    slower = sum(d > 0 for d in diffs)
    plane["reference"] = got["instrumented"]
    log(f"[telemetry b] instrumented vs plain engine, L = 100 / 250 / 384: bit-equal {equal}; "
        f"a captured L = 384 request {med['instrumented']:.2f} / {med['plain']:.2f} ms "
        f"(host clock, medians of {pairs} pairs in turns); paired difference {diff:+.3f} ms, "
        f"95% interval [{lo:+.3f}, {hi:+.3f}] ms, instrumented slower in {slower} of {pairs} "
        f"{'ok' if equal else 'FAIL'}")
    RECORD["phases"]["telemetry_no_number"] = {
        "bit_equal": equal, "request_ms": times, "median_ms": med,
        "paired_diff_ms": diff, "paired_diff_ci95_ms": [lo, hi], "instrumented_slower": slower}
    if not equal:
        fail("telemetry changed a served number (phase 17b)")


def phase_telemetry_train(steps=22, reps=10):
    """(c) The trained path: `train_pre.main` (its defaults in bf16 at crop
    128, accum 2, `steps` steps, captured) without telemetry, then with
    `--metrics-log`, `--eval-every 2` and `--trace-out` (the CLI's own
    `build_train_telemetry`). Checks: the final params and the last loss
    and grad_norm bit for bit the run without telemetry; the goodput
    buckets the CLI published at its last step (its trace's metrics
    sidecar) sum to its published wall within 1e-9 s, and that wall is at
    most the host wall of the whole `main` call; the capture (the
    `train_compile` span) lands in "compile", the replays in "step"; the
    JSONL lines parse (a loss a step, an eval loss every 2nd); the Chrome
    trace loads with a train.step a step and a train.eval every 2nd.
    Then the step ms both ways: instrumented, the CLI loop's own spans
    (train.step, the replay's launch, plus train.metrics_fetch, the
    logger's sync and copy) on its replayed steps without an eval (median
    of them); bare, one `CapturedTrainStep` call and its loss fetch on the
    host clock from a synced card (median of `reps`), the same step
    without the loop's telemetry."""
    argv = ["--steps", str(steps), "--len", "128", "--accum", "2", "--bf16"]
    (plain_state, plain_metrics), _ = quiet(train_pre.main, argv)
    log_path, trace_path = TELEMETRY_WORK / "train.jsonl", TELEMETRY_WORK / "train_trace.json"
    t0 = time.perf_counter()
    (state, metrics), lines = quiet(train_pre.main, argv + [
        "--metrics-log", str(log_path), "--eval-every", "2", "--trace-out", str(trace_path)])
    main_s = time.perf_counter() - t0
    equal = (torch.equal(metrics["loss"], plain_metrics["loss"])
             and torch.equal(metrics["grad_norm"], plain_metrics["grad_norm"])
             and all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]),
                                                        tree_leaves(plain_state["params"]))))
    del plain_state
    sidecar = json.load(open(f"{trace_path}.metrics.json"))
    gauges = sidecar["gauges"]
    totals = {k[len('train_bucket_seconds{bucket="'):-2]: v for k, v in gauges.items()
              if k.startswith("train_bucket_seconds{")}
    wall = gauges["train_wall_seconds"]
    records = [json.loads(line) for line in open(log_path)]
    events = json.load(open(trace_path))["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    names = [e["name"] for e in spans]
    compile_span = [e["dur"] / 1e6 for e in spans if e["name"] == "train_compile"]
    ok = (equal and abs(sum(totals.values()) - wall) <= 1e-9 and wall <= main_s
          and totals["step"] > 0 and len(compile_span) == 1
          and 0 < compile_span[0] <= totals["compile"]
          and sidecar["counters"]["train_steps_total"] == steps
          and [r["step"] for r in records] == list(range(steps))
          and sum("eval_loss" in r for r in records) == steps // 2
          and names.count("train.step") == steps and names.count("train.eval") == steps // 2)
    # instrumented: the CLI's spans on its replays that ran no eval
    by_step = {}
    for e in spans:
        if e["name"] in ("train.step", "train.metrics_fetch"):
            by_step.setdefault(e["args"]["step"], []).append(e["dur"] / 1e3)
    clean = [n for n in range(1, steps) if (n + 1) % 2]
    times = {"instrumented": [sum(by_step[n]) for n in clean], "bare": []}
    # bare: the same captured step alone
    cfg = train_pre_config()
    tcfg = TrainConfig(grad_accum=2)
    fresh = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=128, seed=0), 2)
    step = CapturedTrainStep(cfg, tcfg, fresh, fetch(0))
    batch = fetch(0)

    def bare():
        _, m = step(fresh, batch)
        m["loss"].cpu()

    bare()
    times["bare"] = [host_ms(bare) for _ in range(reps)]
    ok &= all(len(by_step[n]) == 2 for n in clean)
    med = {k: float(np.median(v)) for k, v in times.items()}
    replayed = step.replayed_launches()
    log(f"[telemetry c] train_pre --len 128 --accum 2 --bf16, {steps} steps: with telemetry "
        f"bit-equal {equal}; goodput {dict((k, round(v, 4)) for k, v in totals.items() if v)} "
        f"= wall {wall:.4f} s of main's {main_s:.4f} s (the capture {compile_span} s in "
        f"compile); {len(records)} JSONL records, {len(names)} spans; a captured step "
        f"{med['instrumented']:.3f} ms in the CLI's loop (train.step + train.metrics_fetch, "
        f"median of its {len(clean)} replays without an eval), {med['bare']:.3f} ms bare "
        f"(host clock, median of {reps}) {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["telemetry_train"] = {
        "bit_equal": equal, "goodput": totals, "wall_s": wall, "main_s": main_s,
        "compile_span_s": compile_span, "records": records, "span_names": sorted(set(names)),
        "step_ms": times, "median_ms": med, "ok": ok}
    if not ok:
        fail("the trained path under telemetry failed a check (phase 17c)")
    return replayed


def phase_telemetry_profilez(plane):
    """(d) `/profilez` while serving: a 2 s bounded capture on (a)'s ops
    server (`torch.profiler`, started and stopped under the engine's graph
    lock) while 17b's requests are served one at a time; their results bit
    for bit 17b's; the capture writes a Chrome trace that loads; a second
    call within `min_interval_s` answers 429. Reported: whether the
    kernels replayed inside the captured graphs appear in the trace, and
    by what names."""
    ops, engine = plane["ops"], plane["engine"]
    code, body = http_get(ops.url + "/profilez?duration_s=2")
    info = json.loads(body)
    served = [engine.predict(q, msa=m, msa_mask=mm, timeout=600)
              for q, m, mm in telemetry_requests()]
    deadline = time.monotonic() + 60
    while plane["profiler"].snapshot()["running"] is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    snap = plane["profiler"].snapshot()
    again = http_get(ops.url + "/profilez?duration_s=2")[0]
    equal = all(np.array_equal(a.coords, b.coords) and np.array_equal(a.confidence, b.confidence)
                and a.stress == b.stress for a, b in zip(served, plane["reference"]))
    trace_ok, kernels, graph_launches = False, {}, 0
    try:
        events = json.load(open(info["trace"]))["traceEvents"]
        trace_ok = True
        for e in events:
            if e.get("cat") == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0) + 1
            elif e.get("name") in ("cudaGraphLaunch", "cuGraphLaunch"):
                graph_launches += 1
    except (OSError, KeyError, ValueError):
        pass
    flash = {k: n for k, n in kernels.items() if "flash" in k.lower()}
    ok = (code == 200 and trace_ok and equal and again == 429
          and not snap["captures"][-1].get("error"))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"[telemetry d] /profilez 2 s: {code}, trace {info.get('trace')} loads {trace_ok}; "
        f"served during it bit-equal to 17b {equal}; again within min_interval_s: {again}; "
        f"{sum(kernels.values())} kernel events, {graph_launches} graph launches; flash kernels "
        f"in the trace: {flash if flash else 'none'}; most frequent kernels {top} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["telemetry_profilez"] = {
        "status": code, "info": info, "second_status": again, "bit_equal": equal,
        "trace_loads": trace_ok, "kernel_events": sum(kernels.values()),
        "graph_launches": graph_launches, "flash_kernels": flash, "top_kernels": top,
        "capture": snap["captures"][-1], "ok": ok}
    if not ok:
        fail("/profilez while serving failed a check (phase 17d)")


def phase_telemetry(smi):
    """17: the telemetry plane on the card. Counts set to 0 just before (a)
    and read after (d): the returned launches are the wrappers' counts
    (every engine's warm-ups and captures, the CLI runs' and (c)'s step's
    warm-ups and captures) plus what the replays launched (each
    executable's captured launches times its replays, (c)'s timed step's
    replays)."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"telemetry_{key}_s"] = time.perf_counter() - t
        log(f"[time] telemetry {key}: {RECORD['phases'][f'telemetry_{key}_s']:.1f} s")
        return result

    shutil.rmtree(TELEMETRY_WORK, ignore_errors=True)
    TELEMETRY_WORK.mkdir(parents=True)
    plane = {}
    reset_launches()
    try:
        timed("a", phase_telemetry_engine, smi, plane)
        timed("b", phase_telemetry_no_number, plane)
        timed("d", phase_telemetry_profilez, plane)
        replayed = timed("c", phase_telemetry_train)
    finally:
        if "ops" in plane:
            plane["ops"].stop()
        for key in ("engine", "plain"):
            if key in plane:
                plane[key].shutdown(drain=False)
        shutil.rmtree(TELEMETRY_WORK, ignore_errors=True)
    sync()
    launches = launch_counts()
    for key in ("engine", "plain"):
        for exe in plane[key]._executables.values():
            for name, n in exe.launches.items():
                launches[name] = launches.get(name, 0) + n * exe.replays
    for name, n in replayed.items():
        launches[name] = launches.get(name, 0) + n
    if not on_wgmma(launches):
        fail(f"a phase 17 flash launch left its wgmma route: {launches}")
    log(f"[telemetry] launches (wrappers and replays) "
        f"{dict((k, n) for k, n in launches.items() if n)}, all on wgmma")
    RECORD["phases"]["telemetry_launches"] = launches
    return launches


# --- phase 18: trunk-depth early exit on the card ---------------------------------

EXIT_DEPTHS = (1, 2, 3)  # checkpoints; the model's depth 4 is the last


def stage_kls(params, cfg, tokens, mask, msa, msa_mask, device, depths=EXIT_DEPTHS):
    """Per-sample masked-mean KL(prev || cur) at each later checkpoint
    (rows: depths[1:], then cfg.depth) from the staged trunk's own stages
    with nothing freezing, float64 on the host."""
    checkpoints = tuple(depths) + (cfg.depth,)
    with torch.inference_mode():
        t = lambda a, dt: torch.as_tensor(a, dtype=dt).to(device)  # noqa: E731
        state = staged_front(params, cfg, t(tokens, torch.long), t(msa, torch.long),
                             mask=t(mask, torch.bool), msa_mask=t(msa_mask, torch.bool),
                             upto=checkpoints[0])
        rows = []
        for start, stop in zip(checkpoints[:-1], checkpoints[1:]):
            prev = state["prev_logp"].clone()
            staged_step(params, cfg, state, start, stop, exit_kl=1e-30)
            cur = state["prev_logp"]
            kl = ((prev.exp() * (prev - cur)).sum(-1) * state["pm"]).sum((1, 2)) / state["denom"]
            rows.append(kl.double().cpu().numpy())
    return np.stack(rows)


def exit_threshold(kls):
    """The geometric midpoint of the widest gap (in log space) between the
    sorted KLs of the checkpoints that can exit (every row but the last)
    among the gaps that leave at least one sample exiting and one not (a
    sample exits when one of its KLs is at or under the threshold).
    Returns (threshold, the KL under it, the KL over it)."""
    first = kls[:-1].min(axis=0)
    v = np.sort(kls[:-1].ravel())
    best = None
    for lo, hi in zip(v[:-1], v[1:]):
        mid = math.sqrt(lo * hi)
        if 0 < int((first <= mid).sum()) < len(first) and (
                best is None or hi / lo > best[2] / best[1]):
            best = (mid, lo, hi)
    if best is None:
        fail(f"no KL threshold splits the samples: {kls}")
    return best


def phase_exit_parity(L=64):
    """(a) Card against CPU in float32 (see the module docstring)."""
    cfg = served_config(dtype=torch.float32, depth=4, max_seq_len=L)
    params = {dev: alphafold2_init(cfg, torch.Generator().manual_seed(0), dev)
              for dev in ("cpu", "cuda")}
    tokens, mask, msa, msa_mask = engine_batch((L,) * 4, L, seed=81, msa_rows=4)
    kls_cpu = stage_kls(params["cpu"], cfg, tokens, mask, msa, msa_mask, "cpu")
    threshold, lo, hi = exit_threshold(kls_cpu)
    kls_card = stage_kls(params["cuda"], cfg, tokens, mask, msa, msa_mask, "cuda")
    kl_diff = float(np.abs(kls_card - kls_cpu).max())
    kw = dict(mask=mask, msa=msa, msa_mask=msa_mask, mds_iters=200,
              early_exit_depths=EXIT_DEPTHS, early_exit_kl=threshold)
    reset_launches()
    card = predict_structure(params["cuda"], cfg, tokens, device="cuda", **kw)
    sync()
    launches = launch_counts()
    cpu = predict_structure(params["cpu"], cfg, tokens, device="cpu", **kw)
    g = {k: v.cpu() for k, v in card.items()}
    d = {"logits": (g["distogram_logits"] - cpu["distogram_logits"]).abs().max().item(),
         "confidence": (g["confidence"] - cpu["confidence"]).abs().max().item(),
         "stress_rel": ((g["stress"] - cpu["stress"]).abs() / cpu["stress"].abs()).max().item(),
         "distances": (pairwise(g["coords"]) - pairwise(cpu["coords"])).abs().max().item()}
    exits_card, exits_cpu = g["exit_depth"].tolist(), cpu["exit_depth"].tolist()
    mixed = min(exits_cpu) < cfg.depth == max(exits_cpu)
    ok = (hi - lo >= 1e3 * kl_diff and exits_card == exits_cpu and mixed
          and d["logits"] <= 1e-4 and d["confidence"] <= 1e-5 and d["stress_rel"] <= 1e-3
          and d["distances"] <= 1e-2)
    log(f"[exit a] f32 depth 4, L={L}, 4 requests, 4 MSA rows: KLs (CPU) "
        f"{np.round(kls_cpu, 6).tolist()}; threshold {threshold:.6g} in the gap ({lo:.6g}, {hi:.6g}) = {hi - lo:.3e}, card vs "
        f"CPU KL |d| {kl_diff:.3e} (gap >= 1e3 x); exit_depth card {exits_card} CPU "
        f"{exits_cpu}; logits |d|={d['logits']:.2e} (1e-4), confidence |d|="
        f"{d['confidence']:.2e} (1e-5), stress rel={d['stress_rel']:.2e} (1e-3), distances "
        f"|d|={d['distances']:.2e} A (1e-2); launches {launches} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["exit_parity"] = {
        "L": L, "kls_cpu": kls_cpu.tolist(), "kls_card": kls_card.tolist(),
        "threshold": threshold, "gap": [lo, hi], "kl_diff": kl_diff,
        "exit_depth": {"card": exits_card, "cpu": exits_cpu}, **d, "launches": launches,
        "ok": ok}
    if not ok:
        fail("early exit: the card and the CPU disagree, or the threshold's gap is too "
             "narrow (phase 18a)")
    return launches


def exit_padded(reqs, bucket, shape):
    """The padded batch the engine assembles for `reqs` ((sequence, msa,
    msa_mask) each) at (bucket, rung)."""
    rows = [np.asarray([AA_ORDER.index(c) for c in seq], np.int32) for seq, _, _ in reqs]
    tokens, mask, _ = pad_batch(rows, bucket, shape)
    live = [types.SimpleNamespace(length=len(seq), tokens=row, msa=msa, msa_mask=mm)
            for (seq, msa, mm), row in zip(reqs, rows)]
    msa, msa_mask = pad_msa_batch(live, bucket, shape, ENGINE_ROWS)
    return tokens, mask, msa, msa_mask


def exit_engine(params, cfg, mds_init, threshold):
    """The served engine (buckets 128 / 256 / 384, rungs 1, 2, 4, 200 MDS
    iterations, 20 MSA rows); early exit at `threshold` (None: off)."""
    exit_kw = ({} if threshold is None
               else dict(early_exit_depths=EXIT_DEPTHS, early_exit_kl=threshold))
    return ServingEngine(params, cfg, ServingConfig(
        buckets=ENGINE_BUCKETS, max_batch=4, batch_ladder=True, msa_rows=ENGINE_ROWS,
        mds_iters=200, max_wait_s=0.5, request_timeout_s=600.0, mds_init=mds_init,
        cache_capacity=0 if mds_init == "random" else 256, seed=7, **exit_kw))


def phase_exit_engine():
    """(b) The staged executable through the engine (see the module
    docstring). Returns the launches: the wrappers' counts from a reset
    just before (warm-ups, captures, eager references) plus what every
    engine's replays launched (each stage graph by its own replays); and
    (c)'s arms at bucket 384, rung 1: the plain engine's executable, the
    staged ones with nothing exiting and with everything exiting at 2, and
    the params."""
    cfg = served_config(depth=4)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    cut = dataclasses.replace(cfg, depth=2)
    rng = np.random.default_rng(83)
    # (label, init, threshold, request lengths -> bucket, rung)
    plan = [("none", "classical", 1e-12, (384,)),
            ("all", "classical", 1e9, (256, 250, 200, 180)),
            ("all rung 1", "classical", 1e9, (380,)),
            ("mid", "classical", None, (128, 120, 100, 90)),
            ("mid random", "random", None, (128, 70)),
            ("all random", "random", 1e9, (200,))]
    reset_launches()
    engines, rows, arms = [], [], {}
    try:
        for label, init, threshold, lengths in plan:
            reqs = [engine_request(L, rng) for L in lengths]
            bucket = min(b for b in ENGINE_BUCKETS if b >= max(lengths))
            shape = min(r for r in (1, 2, 4) if r >= len(lengths))
            tokens, mask, msa, msa_mask = exit_padded(reqs, bucket, shape)
            if threshold is None:
                kls = stage_kls(params, cfg, tokens[:len(reqs)], mask[:len(reqs)],
                                msa[:len(reqs)], msa_mask[:len(reqs)], "cuda")
                threshold = exit_threshold(kls)[0]
            eng = exit_engine(params, cfg, init, threshold)
            engines.append(eng)
            handles = [eng.submit(seq, msa=m, msa_mask=mm) for seq, m, mm in reqs]
            results = [h.result(timeout=600) for h in handles]
            exe = eng._executables[(bucket, shape)]
            logits = exe.logits.clone()
            gen = (torch.Generator("cuda").manual_seed(eng.init_seed(eng._batch_counter))
                   if init == "random" else None)
            ref = predict_structure(params, cfg, tokens, mask=mask, msa=msa, msa_mask=msa_mask,
                                    mds_iters=200, mds_init=init, generator=gen, device="cuda",
                                    early_exit_depths=EXIT_DEPTHS, early_exit_kl=threshold)
            sync()
            equal = all(np.array_equal(r.coords, ref["coords"][i, :L].cpu().numpy())
                        and np.array_equal(r.confidence, ref["confidence"][i, :L].cpu().numpy())
                        and r.stress == float(ref["stress"][i])
                        and r.exit_depth == int(ref["exit_depth"][i])
                        for i, (r, L) in enumerate(zip(results, lengths)))
            equal = equal and torch.equal(logits, ref["distogram_logits"])
            exits = [r.exit_depth for r in results]
            stats = eng.stats()
            cells = {c["schedule"]: c for c in stats["costs"]["cells"]
                     if c["bucket"] == bucket}
            counted = all(cells[f"dense@exit{d}@b{shape}" if d < cfg.depth
                                else f"dense@b{shape}"]["requests"] == exits.count(d)
                          for d in (2, 3, 4))
            total = sum(c["device_seconds"] * c["chips"] for c in stats["costs"]["cells"])
            summed = abs(total - eng.costs.fleet_chip_seconds_total()) <= 1e-6 * total
            row = {"label": label, "init": init, "threshold": threshold, "bucket": bucket,
                   "rung": shape, "exit_depth": exits, "bit_equal_eager": equal,
                   "stage_replays": list(exe.stage_replays),
                   "stage_launches": exe.stage_launches, "cells_count": counted,
                   "chip_seconds": total, "cells_sum_total": summed}
            check = equal and counted and summed and total > 0
            if label == "all rung 1":
                arms["staged, all exit at 2"] = exe
            if label == "none":
                plain = exit_engine(params, cfg, init, None)
                engines.append(plain)
                same = [plain.submit(seq, msa=m, msa_mask=mm) for seq, m, mm in reqs]
                same = [h.result(timeout=600) for h in same]
                arms["staged, none exit"] = exe
                arms["plain depth 4"] = plain._executables[(bucket, shape)]
                row["bit_equal_plain_engine"] = all(
                    np.array_equal(a.coords, b.coords)
                    and np.array_equal(a.confidence, b.confidence) and a.stress == b.stress
                    for a, b in zip(results, same))
                check = (check and row["bit_equal_plain_engine"]
                         and exits == [cfg.depth] * len(exits)
                         and exe.stage_replays == [1, 1, 1, 1])
            elif label.startswith("all"):
                with torch.inference_mode():
                    cut_logits = alphafold2_apply(
                        dict(params, trunk=params["trunk"][:2]), cut, tokens, msa, mask=mask,
                        msa_mask=msa_mask, device="cuda").float()
                row["logits_equal_cut_model"] = torch.equal(logits, cut_logits)
                skipped = all(exe.stage_launches[k] for k in (2, 3))
                launched = exe.replayed_launches()
                want = {}
                for launches in (exe.stage_launches[0], exe.stage_launches[1],
                                 exe.tail_launches):
                    for name, n in launches.items():
                        want[name] = want.get(name, 0) + n
                check = (check and row["logits_equal_cut_model"] and exits == [2] * len(exits)
                         and exe.stage_replays == [1, 1, 0, 0] and skipped
                         and launched == want)
            else:
                check = check and min(exits) < cfg.depth == max(exits)
            row["ok"] = check
            rows.append(row)
            log(f"[exit b] {label} ({init}, kl {threshold:.6g}): bucket {bucket} rung {shape}, "
                f"exit_depth {exits}, stage replays {exe.stage_replays}, bit-equal eager "
                f"{equal}" + (f", plain engine {row['bit_equal_plain_engine']}"
                              if "bit_equal_plain_engine" in row else "")
                + (f", logits = depth-2 model {row['logits_equal_cut_model']}"
                   if "logits_equal_cut_model" in row else "")
                + f"; cells count {counted}, sum {total:.6f} s = total {summed} "
                  f"{'ok' if check else 'FAIL'}")
    finally:
        for eng in engines:
            eng.shutdown(drain=False)
    sync()
    launches = launch_counts()
    for eng in engines:
        for name, n in eng.stats()["launches"].items():
            launches[name] = launches.get(name, 0) + n
    routes = on_wgmma(launches)
    log(f"[exit b] launches (wrappers and replays) "
        f"{dict((k, n) for k, n in launches.items() if n)}"
        f"{', all on wgmma' if routes else ', OFF wgmma'}")
    RECORD["phases"]["exit_engine"] = {"config": repr(cfg), "rows": rows,
                                       "launches": launches, "on_wgmma": routes}
    if not (routes and all(r["ok"] for r in rows)):
        fail("the staged engine differs from eager or from the plain engine, ran a skipped "
             "stage, billed wrongly or left wgmma (phase 18b)")
    return launches, arms, params


def phase_exit_timing(built, params4, reps=5):
    """(c) Times, reported with no limit (see the module docstring): (b)'s
    executables at bucket 384, rung 1 (`built`) and a plain depth-2 one
    captured here on the first two layers of the same params. Returns the
    launches of this phase's replays (each stage graph by its own)."""
    cfg2 = served_config(depth=2)
    params2 = dict(params4, trunk=params4["trunk"][:2])
    arms = {"plain depth 4": built["plain depth 4"],
            "staged, none exit": built["staged, none exit"],
            "staged, all exit at 2": built["staged, all exit at 2"],
            "plain depth 2": CapturedExecutable(
                params2, cfg2, batch=1, bucket=384, msa_rows=ENGINE_ROWS, mds_iters=200,
                device=torch.device("cuda", 0), pool=GraphPool())}
    before = {name: exe.replayed_launches() for name, exe in arms.items()}
    batch = engine_batch((384,), 384, seed=91)
    outs = {}
    for name, exe in arms.items():
        outs[name] = exe(*batch)
    sync()
    host = {name: [] for name in arms}
    device = {name: [] for name in arms}
    for _ in range(reps):
        for name, exe in arms.items():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            sync()
            t0 = time.perf_counter()
            exe(*batch, events=events)
            sync()
            host[name].append((time.perf_counter() - t0) * 1e3)
            device[name].append(events[0].elapsed_time(events[1]))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    times = {name: {"host_ms": med(host[name]), "events_ms": med(device[name]),
                    "stage_replays": list(exe.stage_replays)} for name, exe in arms.items()}
    for name in ("plain depth 4", "staged, none exit"):
        prof = profile_request(lambda exe=arms[name]: exe(*batch))
        times[name]["kernel_ms"] = prof["device_ms"]
        times[name]["kernels"] = prof["device_kernels"]
        times[name]["graph_launches"] = prof["graph_launches"]
    # each stage graph alone on the last call's inputs (events, median of
    # 5): a later stage less a trunk layer is its head, KL and state copies
    staged = arms["staged, none exit"]
    stage_ms = []
    with torch.inference_mode():
        for graph in staged.stage_graphs:
            runs = []
            for _ in range(reps):
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
                graph.replay()
                events[1].record()
                sync()
                runs.append(events[0].elapsed_time(events[1]))
            stage_ms.append(med(runs))
    plain4, none_exit = times["plain depth 4"]["host_ms"], times["staged, none exit"]["host_ms"]
    exit2, plain2 = times["staged, all exit at 2"]["host_ms"], times["plain depth 2"]["host_ms"]
    layer_ms = (times["plain depth 4"]["events_ms"] - times["plain depth 2"]["events_ms"]) / 2
    derived = {"per_stage_overhead_ms": (none_exit - plain4) / 3,
               "skipped_segment_saves_ms": (none_exit - exit2) / 2,
               "exit2_over_plain2_ms": exit2 - plain2,
               "stage_graph_ms": stage_ms, "layer_ms": layer_ms,
               "stage_device_overhead_ms": [t - layer_ms for t in stage_ms[1:]],
               "kernel_ms_overhead_per_stage": (times["staged, none exit"]["kernel_ms"]
                                                - times["plain depth 4"]["kernel_ms"]) / 3,
               "idle_ms": {name: t["host_ms"] - t["kernel_ms"] for name, t in times.items()
                           if "kernel_ms" in t}}
    same = all(torch.equal(outs["plain depth 4"][k], outs["staged, none exit"][k])
               for k in ("coords", "confidence", "stress"))
    for name, t in times.items():
        log(f"[exit c] L=384 rung 1, {name}: {t['host_ms']:.3f} ms host, {t['events_ms']:.3f} "
            f"ms events (median of {reps}), stage replays {t['stage_replays']}"
            + (f"; one more under the profiler: {t['kernel_ms']:.3f} ms in {t['kernels']} "
               f"kernels, {t['graph_launches']} graph launches" if "kernel_ms" in t else ""))
    log(f"[exit c] stage graphs alone (events, median of {reps}): "
        f"{[round(x, 3) for x in stage_ms]} ms; a trunk layer (plain 4 less plain 2, / 2) "
        f"{layer_ms:.3f} ms, so a later stage's head, KL and copies "
        f"{[round(x, 3) for x in derived['stage_device_overhead_ms']]} ms; kernel time a "
        f"later stage over plain {derived['kernel_ms_overhead_per_stage']:.3f} ms; host "
        f"less kernel time {dict((k, round(v, 3)) for k, v in derived['idle_ms'].items())}")
    log(f"[exit c] per later stage (head, KL, one host read): "
        f"{derived['per_stage_overhead_ms']:.3f} ms; a skipped segment saves "
        f"{derived['skipped_segment_saves_ms']:.3f} ms; exit-at-2 over plain depth 2: "
        f"{derived['exit2_over_plain2_ms']:.3f} ms; none-exit = plain depth 4 bit for bit: "
        f"{same}")
    RECORD["phases"]["exit_timing"] = {"times": times, "derived": derived,
                                       "none_exit_equals_plain": same}
    if not same:
        fail("the staged executable with nothing exiting differs from the plain one (18c)")
    launches = {}
    for name, exe in arms.items():
        for kernel, n in exe.replayed_launches().items():
            launches[kernel] = launches.get(kernel, 0) + n - before[name].get(kernel, 0)
    return launches


def phase_early_exit():
    """18: trunk-depth early exit. Counts set to 0 just before (b); the
    returned launches are (a)'s, (b)'s (wrappers and replays) and (c)'s
    (the wrappers' warm-ups and captures, and the replays)."""
    def timed(key, fn):
        t = time.perf_counter()
        result = fn()
        RECORD["phases"][f"exit_{key}_s"] = time.perf_counter() - t
        log(f"[time] early exit {key}: {RECORD['phases'][f'exit_{key}_s']:.1f} s")
        return result

    launches = timed("a", phase_exit_parity)
    engine, arms, params = timed("b", phase_exit_engine)
    reset_launches()
    replays = timed("c", lambda: phase_exit_timing(arms, params))
    timing = launch_counts()
    if not on_wgmma(_merged(timing, replays)):
        fail(f"a phase 18c flash launch left its wgmma route: {timing}, {replays}")
    return _merged(launches, engine, timing, replays)


# --- phase 19: the serving fleet on the card -------------------------------------

FLEET_WORK = ROOT / "build" / "phase19"  # the ops server's profiles, the CLI's stats
# the CLI recipe's model and device flags: the served widths on the card
FLEET_CLI_MODEL = ["--buckets", "128,256,384", "--bf16", "--dim", "256", "--depth", "2",
                   "--heads", "8", "--dim-head", "64", "--mds-iters", "200"]
FLEET_TIMEOUT = 600.0  # every fleet wait's bound, seconds


class TrackedFleet(ServingFleet):
    """The fleet with every engine its default factory builds kept in
    `ENGINES` (a drained replica's too), so its replays count."""

    def _default_factory(self, name, cfg, fault_hook):
        engine = super()._default_factory(name, cfg, fault_hook)
        FLEET_ENGINES.append(engine)
        return engine


FLEET_ENGINES = []


def fleet_scfg(**fields):
    """The served engine config of phase 19: 8b's (buckets 128 / 256 / 384,
    rungs 1, 2, 4, 20 MSA rows, 200 MDS iterations) with no result cache,
    so the second pass of a stream is computed again."""
    base = dict(buckets=ENGINE_BUCKETS, max_batch=4, batch_ladder=True, msa_rows=ENGINE_ROWS,
                mds_iters=200, request_timeout_s=FLEET_TIMEOUT, cache_capacity=0)
    return ServingConfig(**{**base, **fields})


def fleet_cfg(**fields):
    """No heartbeats (a probe would capture behind the stream's back), the
    fleet's deadline at FLEET_TIMEOUT."""
    return FleetConfig(**{**dict(probe_interval_s=3600.0, default_timeout_s=FLEET_TIMEOUT),
                          **fields})


def run_stream(server, stream):
    """Submit `stream` to `server` (a fleet or an engine) at once (a
    queue-full submission retried after its advice) and wait: (results or
    exceptions, wall seconds)."""
    t0 = time.perf_counter()
    reqs = []
    for seq, msa, mm in stream:
        while True:
            try:
                reqs.append(server.submit(seq, msa=msa, msa_mask=mm))
                break
            except QueueFullError as e:
                time.sleep(min(0.05, e.retry_after_s or 0.005))
    out = []
    for r in reqs:
        try:
            out.append(r.result(timeout=FLEET_TIMEOUT))
        except Exception as e:  # noqa: BLE001 — an outcome, checked by the caller
            out.append(e)
    return out, time.perf_counter() - t0


def served_rungs(tracer):
    """(trace id, replica) -> the batch rung of the last `serving.execute`
    span that served it."""
    rungs = {}
    for s in sorted(tracer.spans(), key=lambda s: s["ts_s"]):
        if s["name"] == "serving.execute":
            for tid in s["attrs"].get("trace_ids", ()):
                rungs[(tid, s["attrs"].get("replica", ""))] = s["attrs"]["batch"]
    return rungs


def bare_result(engine, request, rung, cache):
    """What `engine` (a bare ServingEngine) serves for `request` in a batch
    of `rung` rows (the request, then the filler rows the engine repeats
    it into), through the engine's own executable, under the card's lock:
    coords, confidence, stress (and exit_depth). Memoized in `cache`."""
    seq, msa, mm = request
    key = (id(engine), seq, rung)
    if key not in cache:
        fb = featurize_request(seq, msa, mm, ladder=engine._ladder,
                               msa_rows=engine.cfg.msa_rows)
        tokens, mask, _ = pad_batch([fb.tokens], fb.bucket, rung)
        m = mmask = None
        if engine.cfg.msa_rows:
            live = [types.SimpleNamespace(length=len(fb.tokens), tokens=fb.tokens, msa=fb.msa,
                                          msa_mask=fb.msa_mask)]
            m, mmask = pad_msa_batch(live, fb.bucket, rung, engine.cfg.msa_rows)
        with engine.graph_lock or contextlib.nullcontext():
            out = engine._realize(engine._call_executable(fb.bucket, tokens, mask, m, mmask))
        L = len(fb.tokens)
        cache[key] = {"coords": out["coords"][0, :L], "confidence": out["confidence"][0, :L],
                      "stress": float(out["stress"][0]), "bucket": fb.bucket,
                      "exit_depth": int(out["exit_depth"][0]) if "exit_depth" in out else 0}
    return cache[key]


def same_bits(result, ref):
    return (np.array_equal(result.coords, ref["coords"])
            and np.array_equal(result.confidence, ref["confidence"])
            and result.stress == ref["stress"] and result.bucket == ref["bucket"])


def held_to(results, stream, rungs, engine_of, cache):
    """Each result against its bare engine at the rung that served it:
    [(index, replica, rung, bit_equal)]."""
    rows = []
    for i, (res, req) in enumerate(zip(results, stream)):
        if isinstance(res, Exception):
            rows.append((i, None, None, False))
            continue
        rung = rungs.get((res.trace_id, res.replica))
        ok = rung is not None and same_bits(res, bare_result(engine_of(res), req, rung, cache))
        rows.append((i, res.replica, rung, ok))
    return rows


class FailureLog:
    """Every exception a replica's batch failed with (the engine's
    `_fail_live`) and every CaptureError made, while open."""

    def __enter__(self):
        self.failures, self.captures = [], []
        self._fail_live = ServingEngine._fail_live
        self._capture_error = executable_mod.capture_error
        log_ = self

        def fail_live(engine, bucket, live, e, *args, **kwargs):
            log_.failures.append(e)
            return log_._fail_live(engine, bucket, live, e, *args, **kwargs)

        def capture_error(*args):
            err = log_._capture_error(*args)
            log_.captures.append(err)
            return err

        ServingEngine._fail_live = fail_live
        executable_mod.capture_error = capture_error
        return self

    def __exit__(self, *exc):
        ServingEngine._fail_live = self._fail_live
        executable_mod.capture_error = self._capture_error
        return False

    def only_injected(self):
        return not self.captures and all(isinstance(e, InjectedFault) for e in self.failures)


def phase_fleet_idempotency(state):
    """(a) `FleetConfig(replicas=2)` with every (bucket, rung) captured at
    build, phase 8b's stream twice (no result cache: the second pass is
    served again): every result bit for bit what a bare `ServingEngine` on
    the card serves for the same sequence and bucket at the rung its batch
    ran (spans of a live tracer give the rung; the bare engine's own
    executable runs the request padded to that rung under the card's
    lock); `fleet_requests_total` counts each request once, at its
    terminal outcome. Graph-pool bytes: allocated and reserved across the
    bare engine's build (the card's pool made by its captures, largest
    first) and across the 2-replica fleet's (the same shapes again, in
    the same pool)."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    sync()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    bare = ServingEngine(params, cfg, fleet_scfg(precompile=True), device="cuda")
    sync()
    pool_bytes = {"allocated": torch.cuda.memory_allocated() - alloc0,
                  "reserved": torch.cuda.memory_reserved() - res0,
                  "captures": len(bare._executables)}
    state["bare"] = bare
    tracer = Tracer(max_spans=1_000_000)
    alloc1, res1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    fleet = TrackedFleet(params, cfg, fleet_scfg(precompile=True), fleet_cfg(replicas=2),
                         tracer=tracer, device="cuda")
    sync()
    pool_bytes.update(fleet_allocated=torch.cuda.memory_allocated() - alloc1,
                      fleet_reserved=torch.cuda.memory_reserved() - res1)
    state["fleet2"] = fleet
    results = []
    with FailureLog() as failures:
        for _ in range(2):
            results += run_stream(fleet, stream)[0]
    rungs = served_rungs(tracer)
    rows = held_to(results, stream * 2, rungs, lambda res: bare, state["refs"])
    state["first"] = {res.seq: (res, rungs[(res.trace_id, res.replica)])
                      for res in results[:len(stream)] if not isinstance(res, Exception)}
    stats = fleet.stats()
    reqs = stats["requests"]
    c = stats["telemetry"]["metrics"]["counters"]
    counted = (reqs["submitted"] == reqs["completed"] == 2 * len(stream)
               and reqs["failed"] == reqs["shed"] == reqs["in_flight"] == 0
               and c['fleet_requests_total{outcome="completed"}'] == 2 * len(stream)
               and stats["latency"]["count"] == 2 * len(stream))
    equal = all(ok for *_, ok in rows)
    by_rung = sorted({r for _, _, r, _ in rows if r})
    # both replicas built and served (a replica whose build failed would
    # leave the other to serve alone)
    both = all(stats["replicas"][n]["engine"] is not None and any(r[1] == n for r in rows)
               for n in ("r0", "r1"))
    ok = equal and counted and both and failures.only_injected() and not failures.failures
    log(f"[fleet a] 2 replicas, {len(stream)} requests x 2: bit for bit the bare engine at "
        f"the served rung {sum(r[3] for r in rows)}/{len(rows)} (rungs {by_rung}; by replica "
        f"{dict((n, sum(1 for r in rows if r[1] == n)) for n in ('r0', 'r1'))}); "
        f"fleet_requests_total once each {counted}; the bare engine's build (9 captures) "
        f"{pool_bytes['allocated'] / 2**20:.1f} MiB allocated, "
        f"{pool_bytes['reserved'] / 2**20:.1f} MiB reserved; the 2-replica fleet's (18 more "
        f"in the card's pool) {pool_bytes['fleet_allocated'] / 2**20:.1f} / "
        f"{pool_bytes['fleet_reserved'] / 2**20:.1f} MiB; failures "
        f"{[repr(e)[:200] for e in failures.failures + failures.captures]} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["fleet_idempotency"] = {
        "rows": rows, "requests": reqs, "pool_bytes": pool_bytes, "ok": ok}
    if not ok:
        fail("the fleet's results differ from the bare engine's, or its counters miscount "
             "(phase 19a)")


def fleet_ops(fleet, tick_s=0.05):
    """`ops_server_for_fleet` with a profiler on the card's lock."""
    profiler = ProfileCapturer(str(FLEET_WORK / "profiles"), registry=fleet.registry,
                               max_duration_s=2.0, min_interval_s=30.0,
                               lock=device_lock("cuda"))
    ops = ops_server_for_fleet(fleet, slo=SloEngine(fleet.registry,
                                                    default_slo_config("fleet")),
                               profiler=profiler, tick_interval_s=tick_s)
    ops.add_tick(lambda: host_memory_gauges(fleet.registry))
    ops.add_tick(lambda: device_memory_gauges(fleet.registry))
    ops.add_tick(fleet.sample_gauges)
    ops.start()
    return ops, profiler


def phase_fleet_chaos(state):
    """(b) `FleetConfig(replicas=3)` with no precompile under a plan: r0
    killed at its first dispatch (latched), r2 flapping at its third (3
    failures). The stream's first (bucket, rung)s are captured by each
    replica as it meets them, while the others replay theirs; r2's
    reinstatement probe builds a fresh engine and captures while r1
    serves. A thread scrapes /metrics, /healthz and /statusz of
    `ops_server_for_fleet` throughout; one /profilez mid-stream (200,
    then 429 on a second call once it has ended). Checks: nothing lost,
    no CaptureError and no failure but the injected ones, r1 never
    drained, r2 reinstated, requeues counted, every scrape 200, every
    result (requeued ones included) bit for bit the bare engine's at its
    rung."""
    cfg, params, stream, bare = state["cfg"], state["params"], state["stream"], state["bare"]
    plan = FaultPlan(faults=(Fault("kill_replica", replica="r0", at=0),
                             Fault("flap_replica", replica="r2", at=2, count=3)))
    injector = plan.injector()
    tracer = Tracer(max_spans=1_000_000)
    with FailureLog() as failures:
        fleet = TrackedFleet(params, cfg, fleet_scfg(), fleet_cfg(replicas=3, reprobe_interval_s=0.2),
                             tracer=tracer, injector=injector, device="cuda")
        ops, profiler = fleet_ops(fleet)
        scrapes, stop = [], threading.Event()
        scraper = threading.Thread(target=scrape_loop, args=(ops.url, stop, scrapes),
                                   name="af2-smoke-fleet-scraper", daemon=True)
        scraper.start()
        try:
            box = {}
            runner = threading.Thread(target=lambda: box.update(out=run_stream(fleet, stream)),
                                      name="af2-smoke-fleet-stream", daemon=True)
            runner.start()
            code, body = http_get(ops.url + "/profilez?duration_s=1")
            deadline = time.monotonic() + 60
            while profiler.snapshot()["running"] is not None and time.monotonic() < deadline:
                time.sleep(0.05)
            again = http_get(ops.url + "/profilez?duration_s=1")[0]
            runner.join(FLEET_TIMEOUT)
            results, wall = box["out"]
            deadline = time.monotonic() + 60
            while (fleet.stats()["health"]["targets"]["r2"]["reinstatements"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            stop.set()
            scraper.join(30)
            ops.stop()
        stats = fleet.stats()
        fleet.shutdown(drain=True, timeout=60)
    rungs = served_rungs(tracer)
    rows = held_to(results, stream, rungs, lambda res: bare, state["refs"])
    requeued = [r for r in results if not isinstance(r, Exception) and r.requeues]
    as_19a = sum(1 for r in requeued if r.seq in state["first"]
                 and state["first"][r.seq][1] == rungs.get((r.trace_id, r.replica))
                 and np.array_equal(r.coords, state["first"][r.seq][0].coords))
    targets = stats["health"]["targets"]
    reqs = stats["requests"]
    c = stats["telemetry"]["metrics"]["counters"]
    checks = {
        "nothing lost": reqs["failed"] == 0 and reqs["in_flight"] == 0
        and reqs["completed"] == len(stream),
        "only injected failures, no CaptureError": failures.only_injected(),
        "r1 never drained": targets["r1"]["drains"] == 0,
        "r2 reinstated": targets["r2"]["reinstatements"] >= 1,
        "requeues counted": c["fleet_requeue_total"] > 0 and len(requeued) > 0,
        "bit for bit the bare engine": all(ok for *_, ok in rows),
        "scrapes 200": bool(scrapes) and all(code_ == 200 for _, code_, _, _ in scrapes),
        "profilez 200 then 429": code == 200 and again == 429,
    }
    ok = all(checks.values())
    captures = {name: len(rep["engine"]["captures"]) if rep["engine"] else None
                for name, rep in stats["replicas"].items()}
    log(f"[fleet b] 3 replicas, no precompile, {len(stream)} requests in {wall:.2f} s under "
        f"{injector.delivered}: {reqs}; {len(requeued)} requeued (bit for bit 19a's at the "
        f"same rung: {as_19a}); drains/reinstatements "
        f"{dict((n, (t['drains'], t['reinstatements'])) for n, t in targets.items())}; "
        f"captures by replica {captures}; {len(scrapes)} scrapes; /profilez {code}, "
        f"again {again}; {checks} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["fleet_chaos"] = {
        "requests": reqs, "checks": checks, "rows": rows, "delivered": injector.delivered,
        "health": targets, "captures": captures, "requeued_as_19a": as_19a,
        "scrapes": len(scrapes), "profilez": [code, again], "wall_s": wall, "ok": ok}
    if not ok:
        fail(f"the fleet under chaos failed a check (phase 19b): {checks}")


def quant_on_wgmma(launches):
    n = launches.get("quant_matmul", 0)
    return n > 0 and launches.get("quant_matmul_wgmma", 0) == n


DEGRADED_ITERS = 50  # the degraded tier's (and the cascade draft's) MDS iterations


def phase_fleet_degraded(state):
    """(c) The degraded tier: `FleetConfig(replicas=2,
    degraded_weight_dtype="int8", degraded_mds_iters=50)` with both full
    replicas killed: every response degraded=True and bit for bit a bare
    int8 engine's at 50 MDS iterations (at its rung); the int8 products'
    launches all on B4's wgmma route."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    icfg = dataclasses.replace(cfg, weight_dtype="int8")
    bare8 = ServingEngine(params, icfg, fleet_scfg(mds_iters=DEGRADED_ITERS), device="cuda")
    FLEET_ENGINES.append(bare8)
    plan = FaultPlan(faults=(Fault("kill_replica", replica="r0", at=0),
                             Fault("kill_replica", replica="r1", at=0)))
    tracer = Tracer(max_spans=1_000_000)
    with FailureLog() as failures:
        fleet = TrackedFleet(params, cfg, fleet_scfg(),
                             fleet_cfg(replicas=2, degraded_weight_dtype="int8",
                                       degraded_mds_iters=DEGRADED_ITERS), tracer=tracer,
                             injector=plan.injector(), device="cuda")
        results, wall = run_stream(fleet, stream)
        stats = fleet.stats()
        fleet.shutdown(drain=True, timeout=60)
    rows = held_to(results, stream, served_rungs(tracer), lambda res: bare8, state["refs"])
    bare8.shutdown(drain=False, timeout=60)
    bare8.release_graphs(60)
    degraded = stats["replicas"]["degraded"]["engine"]["launches"]
    ok = (all(ok_ for *_, ok_ in rows) and failures.only_injected()
          and all(not isinstance(r, Exception) and r.degraded for r in results)
          and stats["requests"]["degraded"] == len(stream) and quant_on_wgmma(degraded))
    log(f"[fleet c] both full replicas killed: {stats['requests']['degraded']} of "
        f"{len(stream)} degraded, bit for bit the bare int8 engine at {DEGRADED_ITERS} "
        f"iterations "
        f"{sum(r[3] for r in rows)}/{len(rows)}; the degraded tier's replayed launches "
        f"{degraded} in {wall:.2f} s {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["fleet_degraded"] = {"rows": rows, "requests": stats["requests"],
                                          "launches": degraded, "ok": ok}
    if not ok:
        fail("the degraded tier failed a check (phase 19c)")


CASCADE_DEPTH = 4  # exit depths (1, 2) must lie under the model's depth: phase 18's


def phase_fleet_cascade(state):
    """(d) Capability pools and the cascade at the served widths, depth 4
    (the draft's exit depths (1, 2) must lie under the model's): a draft
    pool (int8, 50 MDS iterations, early exit at (1, 2) with a KL gate of
    1e9, so every draft exits at depth 2; buckets 128 / 256) and a full
    pool (buckets 128 / 256 / 384), a `CascadePolicy` whose confidence gate
    sits between the stream's draft confidences (from the bare draft
    engine: about half accept). Each accepted draft bit for bit the bare
    draft engine's, each escalation and bypass (L > 256) the bare full
    engine's, at their rungs; the cascade ledger's served tiers sum to
    the requests."""
    stream = state["stream"]
    cfg4 = served_config(depth=CASCADE_DEPTH)
    params4 = alphafold2_init(cfg4, torch.Generator().manual_seed(0), "cuda")
    draft_spec = dict(buckets=ENGINE_BUCKETS[:2], mds_iters=DEGRADED_ITERS,
                      early_exit_depths=(1, 2),
                      early_exit_kl=1e9)
    draft = ServingEngine(params4, dataclasses.replace(cfg4, weight_dtype="int8"),
                          fleet_scfg(**draft_spec), device="cuda")
    full = ServingEngine(params4, cfg4, fleet_scfg(), device="cuda")
    FLEET_ENGINES.extend([draft, full])
    confs = sorted(float(np.asarray(bare_result(draft, req, 1, state["refs"])["confidence"],
                                    np.float64).mean())
                   for req in stream if len(req[0]) <= ENGINE_BUCKETS[1])
    gate = 0.5 * (confs[len(confs) // 2 - 1] + confs[len(confs) // 2])
    pools = (PoolSpec("draft", replicas=1, weight_dtype="int8", **draft_spec),
             PoolSpec("full", replicas=1))
    tracer = Tracer(max_spans=1_000_000)
    with FailureLog() as failures:
        fleet = TrackedFleet(params4, cfg4, fleet_scfg(),
                             fleet_cfg(pools=pools, cascade_policy=CascadePolicy(
                                 draft_pool="draft", min_confidence=gate)),
                             tracer=tracer, device="cuda")
        results, wall = run_stream(fleet, stream)
        stats = fleet.stats()
        fleet.shutdown(drain=True, timeout=60)
    rungs = served_rungs(tracer)
    rows = held_to(results, stream, rungs,
                   lambda res: draft if res.tier == "draft" else full, state["refs"])
    for engine in (draft, full):
        engine.shutdown(drain=False, timeout=60)
        engine.release_graphs(60)
    tiers = stats["cascade"]["tiers"]
    served = sum(tiers.get(t, {}).get("count", 0) for t in ("draft", "escalated", "full"))
    kinds = {t: sum(1 for r in results if not isinstance(r, Exception) and r.tier == t)
             for t in ("draft", "escalated", "full")}
    exits = {r.exit_depth for r in results if not isinstance(r, Exception)
             and r.tier == "draft"}
    ok = (all(ok_ for *_, ok_ in rows) and failures.only_injected() and not failures.failures
          and served == len(stream) and kinds["draft"] > 0 and kinds["escalated"] > 0
          and exits == {2})
    log(f"[fleet d] cascade at depth {CASCADE_DEPTH}, gate {gate:.6f}: {kinds} "
        f"(draft exit depths {sorted(exits)}), ledger tiers {served} = {len(stream)} "
        f"requests, bit for bit their bare pool engines {sum(r[3] for r in rows)}/{len(rows)} "
        f"in {wall:.2f} s {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["fleet_cascade"] = {"rows": rows, "gate": gate, "kinds": kinds,
                                         "cascade": stats["cascade"], "ok": ok}
    if not ok:
        fail("the cascade failed a check (phase 19d)")


def phase_fleet_memory(state, cycles=5):
    """(e) Five drain and reinstate cycles of r0 (replicas 2, no
    precompile): each cycle takes r0 down through the health monitor's
    drain path (`force_down`, the path a failure and a rolling update
    take: its engine shut down, its graphs released under the card's
    lock), its reinstatement probe builds and captures a fresh engine, and
    one request is served. Memory allocated after `gc.collect()` under the
    card's lock each cycle: the fifth within 5% of the first."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    fleet = TrackedFleet(params, cfg, fleet_scfg(), fleet_cfg(replicas=2, reprobe_interval_s=0.05),
                         device="cuda")
    lock = device_lock("cuda")
    allocated, reserved, served = [], [], []
    try:
        for k in range(cycles):
            fleet._health.force_down("r0", "phase 19e drain cycle")
            deadline = time.monotonic() + 60
            while (fleet.stats()["health"]["targets"]["r0"]["reinstatements"] < k + 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            seq, msa, mm = stream[k]
            served.append(fleet.submit(seq, msa=msa, msa_mask=mm)
                          .result(timeout=FLEET_TIMEOUT).replica)
            with lock:
                gc.collect()
                torch.cuda.synchronize()
                allocated.append(torch.cuda.memory_allocated())
                reserved.append(torch.cuda.memory_reserved())
        targets = fleet.stats()["health"]["targets"]
    finally:
        fleet.shutdown(drain=True, timeout=60)
    ok = (targets["r0"]["reinstatements"] == cycles and targets["r0"]["drains"] == cycles
          and abs(allocated[-1] - allocated[0]) <= 0.05 * allocated[0])
    log(f"[fleet e] {cycles} drain/reinstate cycles of r0 (served by {served}): allocated "
        f"{[round(a / 2**20, 1) for a in allocated]} MiB, reserved "
        f"{[round(r / 2**20, 1) for r in reserved]} MiB; r0 {targets['r0']} "
        f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["fleet_memory"] = {"allocated": allocated, "reserved": reserved,
                                        "served_by": served, "health": targets["r0"], "ok": ok}
    if not ok:
        fail("memory grew over the fleet's drain/reinstate cycles (phase 19e)")


def stream_numbers(results, wall):
    lat = sorted(r.latency_s for r in results if not isinstance(r, Exception))
    return {"requests_per_s": len(results) / wall, "wall_s": wall,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p95_ms": 1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "failed": sum(isinstance(r, Exception) for r in results)}


def phase_fleet_timing(state, smi):
    """(f) Reported, no limit: phase 8b's stream (no cache) through the
    bare engine, a 1-replica fleet and a 2-replica fleet, all captured at
    build, in turns (bare, 1, 2, 2, 1, bare): requests/s, p50 and p95
    (host clock); a 2-replica fleet with `hedge_p95_factor=2` over the
    stream twice: hedges issued and hedge_wasted_chip_seconds_total; then
    the verify skill's fleet recipe through the CLI at the served widths
    (its own process): rc 0, nothing lost, requeues, sheds and degraded
    answers, the registry's counters the same numbers."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    fleet1 = TrackedFleet(params, cfg, fleet_scfg(precompile=True), fleet_cfg(replicas=1),
                          device="cuda")
    arms = {"bare": state["bare"], "fleet1": fleet1, "fleet2": state["fleet2"]}
    turns = []
    try:
        for name in ("bare", "fleet1", "fleet2", "fleet2", "fleet1", "bare"):
            results, wall = run_stream(arms[name], stream)
            turns.append({"arm": name, **stream_numbers(results, wall)})
    finally:
        fleet1.shutdown(drain=True, timeout=60)
        state["fleet2"].shutdown(drain=True, timeout=60)
    hedged = TrackedFleet(params, cfg, fleet_scfg(precompile=True),
                          fleet_cfg(replicas=2, hedge_p95_factor=2.0), device="cuda")
    try:
        hedge_runs = [stream_numbers(*run_stream(hedged, stream)) for _ in range(2)]
        hstats = hedged.stats()
    finally:
        hedged.shutdown(drain=True, timeout=60)
    hedging = hstats["hedging"]
    out = FLEET_WORK / "cli.json"
    argv = [sys.executable, "-m", "alphafold2_tpu_torch.serve", "--demo", "24",
            "--replicas", "3", *FLEET_CLI_MODEL, "--max-batch", "2", "--queue-size", "4", "--fleet-queue", "4",
            "--degrade-depth", "3", "--reprobe-interval", "0.3",
            "--degraded-weight-dtype", "int8", "--fault-plan",
            "docs/examples/fleet_chaos_plan.json", "--stats-json", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    cli = json.loads(out.read_text()) if out.exists() else {}
    reqs = cli.get("requests", {})
    c = cli.get("telemetry", {}).get("metrics", {}).get("counters", {})
    cli_ok = (proc.returncode == 0 and reqs.get("failed") == 0 and reqs.get("in_flight") == 0
              and reqs.get("requeued", 0) >= 1 and reqs.get("shed", 0) >= 1
              and reqs.get("degraded", 0) >= 1
              and c.get("fleet_requeue_total") == reqs.get("requeued")
              and c.get("fleet_degraded_total") == reqs.get("degraded")
              and sum(v for k, v in c.items() if k.startswith("fleet_shed_total"))
              == reqs.get("shed"))
    summary = [line for line in proc.stdout.splitlines()
               if line.startswith(("fleet served", "replicas:", "faults delivered"))]
    for t in turns:
        log(f"[fleet f] {t['arm']}: {t['requests_per_s']:.2f} requests/s, p50 "
            f"{t['p50_ms']:.1f} ms, p95 {t['p95_ms']:.1f} ms ({smi})")
    log(f"[fleet f] hedged 2-replica fleet (p95 x2), two passes: "
        f"{[round(h['requests_per_s'], 2) for h in hedge_runs]} requests/s, {hedging}")
    log(f"[fleet f] CLI chaos recipe at the served widths: rc {proc.returncode} in "
        f"{cli_s:.1f} s, {reqs}; {summary} {'ok' if cli_ok else 'FAIL'}")
    RECORD["phases"]["fleet_timing"] = {
        "turns": turns, "hedged": hedge_runs, "hedging": hedging, "card": smi,
        "cli": {"rc": proc.returncode, "seconds": cli_s, "requests": reqs,
                "summary": summary, "stderr_tail": proc.stderr[-4000:], "ok": cli_ok}}
    if not cli_ok:
        fail(f"the fleet CLI's chaos recipe failed its invariants (phase 19f): rc "
             f"{proc.returncode}, {reqs}\n{proc.stderr[-2000:]}")


def phase_fleet(smi):
    """19: the serving fleet on the card. Counts set to 0 just before (a)
    and read after (f): the returned launches are the wrappers' (every
    engine's warm-ups and captures, the bare references' calls) plus what
    every engine's replays launched (a drained replica's included)."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"fleet_{key}_s"] = time.perf_counter() - t
        log(f"[time] fleet {key}: {RECORD['phases'][f'fleet_{key}_s']:.1f} s")
        return result

    shutil.rmtree(FLEET_WORK, ignore_errors=True)
    FLEET_WORK.mkdir(parents=True)
    cfg = served_config()
    state = {"cfg": cfg, "params": alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda"),
             "stream": engine_stream(), "refs": {}}
    FLEET_ENGINES.clear()
    reset_launches()
    try:
        timed("a", phase_fleet_idempotency, state)
        timed("b", phase_fleet_chaos, state)
        timed("c", phase_fleet_degraded, state)
        timed("d", phase_fleet_cascade, state)
        timed("e", phase_fleet_memory, state)
        timed("f", phase_fleet_timing, state, smi)
    finally:
        for key in ("fleet2",):
            if key in state:
                state[key].shutdown(drain=False, timeout=60)
        if "bare" in state:
            state["bare"].shutdown(drain=False, timeout=60)
            state["bare"].release_graphs(60)
        shutil.rmtree(FLEET_WORK, ignore_errors=True)
    sync()
    launches = launch_counts()
    for engine in FLEET_ENGINES + [state["bare"]]:
        for name, n in engine.stats()["launches"].items():
            launches[name] = launches.get(name, 0) + n
    if not on_wgmma(launches) or not quant_on_wgmma(launches):
        fail(f"a phase 19 flash or int8 launch left its wgmma route: {launches}")
    log(f"[fleet] launches (wrappers and replays) "
        f"{dict((k, n) for k, n in launches.items() if n)}, all on wgmma")
    RECORD["phases"]["fleet_launches"] = launches
    FLEET_ENGINES.clear()
    return launches


# --- phase 20: the SP serving arm and the replica autoscaler ------------------------

SP_CARD = ["cuda:0"] * 4  # 20a-20d's mesh: four shards on one card
SP_SCHEDULES = ((256, "sp_msa"), (384, "sp_seq"))  # 128 left to the plan: dense
# the verify skill's autoscaler recipe's policy: every acted event at least its
# cooldown after the last
SCALE_POLICY = dict(min_replicas=1, max_replicas=3, up_queue_wait_p95_s=0.5, up_occupancy=0.5,
                    up_sustain=1, down_sustain=2, up_cooldown_s=0.5, down_cooldown_s=2.0)
SCALE_TICK_S = 0.2


def sp_scfg(**fields):
    """Phase 19's served engine config with the SP arm: 4 shards, sp_msa at
    256 and sp_seq at 384 forced, 128 to the heuristic (dense)."""
    return fleet_scfg(**{**dict(sp_shards=4, sp_schedules=SP_SCHEDULES), **fields})


def sp_launches_on_wgmma(launches):
    """Every B1f, B2f and B3 forward launch in `launches` on the wgmma
    route, and at least one B3 launch."""
    fwd = sum(launches.get(k, 0) for k in ("flash_fwd", "flash_fwd_fused", "flash_fwd_lse"))
    return launches.get("flash_fwd_lse", 0) > 0 and launches.get("flash_fwd_wgmma", 0) == fwd


def eager_result(params, cfg, request, rung, forward_for, cache, tag):
    """Eager `predict_structure` (the forward `forward_for(bucket)` gives,
    or, for None, the dense one on the card) on `request` padded to its bucket and to `rung`
    rows as the engine pads it, under the card's lock; row 0 sliced to its
    length, as `bare_result`. Memoized in `cache` by (tag, sequence, rung)."""
    seq, msa, mm = request
    key = (tag, seq, rung)
    if key not in cache:
        fb = featurize_request(seq, msa, mm, ladder=BucketLadder(ENGINE_BUCKETS),
                               msa_rows=ENGINE_ROWS)
        tokens, mask, _ = pad_batch([fb.tokens], fb.bucket, rung)
        live = [types.SimpleNamespace(length=len(fb.tokens), tokens=fb.tokens, msa=fb.msa,
                                      msa_mask=fb.msa_mask)]
        m, mmask = pad_msa_batch(live, fb.bucket, rung, ENGINE_ROWS)
        forward = forward_for(fb.bucket)
        kw = dict(model_apply_fn=forward) if forward is not None else dict(device="cuda")
        with device_lock("cuda"):
            out = predict_structure(params, cfg, tokens, mask=mask, msa=m, msa_mask=mmask,
                                    mds_iters=200, **kw)
            out = {k: out[k].cpu().numpy() for k in ("coords", "confidence", "stress")}
        L = len(fb.tokens)
        cache[key] = {"coords": out["coords"][0, :L], "confidence": out["confidence"][0, :L],
                      "stress": float(out["stress"][0]), "bucket": fb.bucket}
    return cache[key]


def phase_sp_engine(state):
    """(a) The SP engine at the served config (`sp_scfg`, every (bucket,
    rung) captured at build, largest first; 4 shards on one card): the plan
    dense / sp_msa / sp_seq at 128 / 256 / 384; phase 8b's stream served
    once; every result bit for bit eager `predict_structure(model_apply_fn=
    the bucket's SP forward)` (the dense forward at 128) at the rung its
    batch ran (a live tracer's spans give it); each sp_seq graph recorded
    P^2 x depth = 32 B3 launches, the sp_msa and dense graphs none; no
    CaptureError and no failed batch. Against dense: over the requests of
    the SP buckets, the largest distance of the SP results (confidence,
    pairwise distances) from the f32 eager request stays within 1.5x the
    dense bf16 eager request's largest plus 1e-5 (phase 7b's yardstick,
    over the stream). Then an engine whose small `sp_hbm_gb` (1e-4) leaves
    the plan to the heuristic: sp_seq at every bucket, one request at 128
    bit for bit eager."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    tracer = Tracer(max_spans=1_000_000)
    with FailureLog() as failures:
        t0 = time.perf_counter()
        eng = ServingEngine(params, cfg, sp_scfg(precompile=True), device="cuda",
                            sp_devices=SP_CARD, tracer=tracer)
        build_s = time.perf_counter() - t0
        state["sp_engine"] = eng
        FLEET_ENGINES.append(eng)
        results, wall = run_stream(eng, stream)
    snap = eng.stats()
    plan = {int(b): r["schedule"] for b, r in snap["sp"]["schedules"].items()}
    rungs = served_rungs(tracer)
    rows = []
    for res, req in zip(results, stream):
        if isinstance(res, Exception):
            rows.append((None, None, False))
            continue
        rung = rungs.get((res.trace_id, ""))
        ok = rung is not None and same_bits(res, eager_result(params, cfg, req, rung,
                                                               eng._apply_fns.get,
                                                               state["refs"], "sp"))
        rows.append((res.bucket, rung, ok))
    b3 = {(b, s): exe.launches.get("flash_fwd_lse", 0)
          for (b, s), exe in sorted(eng._executables.items())}
    b3_ok = all(n == (16 * cfg.depth if plan[b] == "sp_seq" else 0) for (b, _), n in b3.items())
    # phase 7b's yardstick over the stream's SP-bucket requests
    sp_idx = [i for i, r in enumerate(results)
              if not isinstance(r, Exception) and plan[r.bucket] != "dense"]
    far = {"confidence": [0.0, 0.0], "distances": [0.0, 0.0]}
    for i in sp_idx:
        ref, dense = state["f32"][i], state["dense"][i]
        res = results[i]
        sp_d = torch.from_numpy(np.asarray(res.coords, np.float64))
        for key, got, want, base in (
                ("confidence", torch.from_numpy(res.confidence.astype(np.float64)),
                 ref["confidence"], dense["confidence"]),
                ("distances", torch.cdist(sp_d, sp_d), ref["distances"], dense["distances"])):
            far[key][0] = max(far[key][0], (got - want).abs().max().item())
            far[key][1] = max(far[key][1], (base - want).abs().max().item())
    yard_ok = all(sp <= 1.5 * dn + 1e-5 for sp, dn in far.values())
    # the heuristic's own plan under a budget nothing dense fits
    heur = ServingEngine(params, cfg, fleet_scfg(sp_shards=4, sp_hbm_gb=1e-4), device="cuda",
                         sp_devices=SP_CARD)
    FLEET_ENGINES.append(heur)
    with FailureLog() as failures_h:
        req = engine_request(100, np.random.default_rng(70))
        got = heur.submit(req[0], msa=req[1], msa_mask=req[2]).result(timeout=FLEET_TIMEOUT)
    heur_plan = {int(b): r["schedule"] for b, r in heur.stats()["sp"]["schedules"].items()}
    heur_ok = (set(heur_plan.values()) == {"sp_seq"} and not failures_h.captures
               and same_bits(got, eager_result(params, cfg, req, 1, heur._apply_fns.get,
                                               state["refs"], "heuristic")))
    heur.shutdown(drain=False, timeout=60)
    heur.release_graphs(60)
    ok = (plan == {128: "dense", 256: "sp_msa", 384: "sp_seq"} and all(r[2] for r in rows)
          and b3_ok and yard_ok and heur_ok and not failures.captures and not failures.failures
          and snap["requests"]["completed"] == len(stream))
    state["sp_results"] = results
    log(f"[sp-serve a] SP engine built in {build_s:.2f} s ({len(eng._executables)} captures), "
        f"plan {plan}; {len(stream)} requests in {wall:.2f} s, bit for bit eager at the served "
        f"rung {sum(r[2] for r in rows)}/{len(rows)} (rungs {sorted({r[1] for r in rows if r[1]})}"
        f"); B3 a graph {b3} (32 each sp_seq graph); over {len(sp_idx)} SP-bucket requests, "
        f"largest distance from f32: " + ", ".join(
            f"{k} SP {v[0]:.3e} dense {v[1]:.3e} (bound {1.5 * v[1] + 1e-5:.3e})"
            for k, v in far.items())
        + f"; heuristic plan at sp_hbm_gb 1e-4 {heur_plan}, its request bit for bit {heur_ok}; "
          f"failures {[repr(e)[:200] for e in failures.failures + failures.captures]} "
          f"{'ok' if ok else 'FAIL'}")
    RECORD["phases"]["sp_engine"] = {
        "build_s": build_s, "plan": plan, "rows": rows, "b3_per_graph": {
            f"{b}x{s}": n for (b, s), n in b3.items()}, "yardstick": far, "wall_s": wall,
        "heuristic_plan": heur_plan, "heuristic_ok": heur_ok,
        "captures": snap["captures"], "ok": ok}
    if not ok:
        fail("the SP engine failed a check (phase 20a)")


def phase_sp_times(state, smi, reps=5):
    """(b) Reported, no limit: a request at L = 384 through the SP engine's
    (384, rung 1) executable beside the bare dense engine's, each call
    copying in, replaying and bringing the outputs to the host under the
    card's lock (host clock, median of 5, in turns dense, SP, SP, dense,
    ...); each SP capture's seconds at build."""
    sp, dense = state["sp_engine"], state["bare"]
    tokens, mask, msa, msa_mask = engine_batch((384,), 384, seed=71)

    def call(engine):
        t = time.perf_counter()
        with engine.graph_lock:
            engine._realize(engine._call_executable(384, tokens, mask, msa, msa_mask))
        return (time.perf_counter() - t) * 1e3

    call(sp), call(dense)
    times = {"dense": [], "sp": []}
    for k in range(reps):
        for name in (("dense", "sp") if k % 2 == 0 else ("sp", "dense")):
            times[name].append(call(sp if name == "sp" else dense))
    med = {k: float(np.median(v)) for k, v in times.items()}
    captures = {f"{c['bucket']}x{c['batch']}": c["seconds"] for c in sp.stats()["captures"]}
    log(f"[sp-serve b] L = 384, rung 1, host clock: SP (sp_seq, 4 shards on one card) median "
        f"{med['sp']:.2f} ms {[round(t, 2) for t in times['sp']]}, dense {med['dense']:.2f} ms "
        f"{[round(t, 2) for t in times['dense']]} ({smi}); SP capture seconds {captures}")
    RECORD["phases"]["sp_times"] = {"ms": times, "median_ms": med, "captures_s": captures,
                                    "card": smi}


class ScaleTimedFleet(TrackedFleet):
    """The tracked fleet with each `add_replica`'s build seconds kept."""

    def __init__(self, *args, **kwargs):
        self.builds = []
        super().__init__(*args, **kwargs)

    def add_replica(self, pool=None):
        t = time.perf_counter()
        try:
            return super().add_replica(pool=pool)
        finally:
            self.builds.append(time.perf_counter() - t)


def allocated_now():
    with device_lock("cuda"):
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()


def autoscale_run(state, label, pools=None):
    """A fleet at the served config (every replica precompiled at build,
    on the card) with `ReplicaAutoscaler`s (one a pool under `pools`) on
    their own control threads at the verify skill's autoscaler recipe's
    policy and a `scale_flap` plan (4 forced demands from tick 2), a scraper on the
    fleet's ops server; phase 8b's stream twice as one burst, then a grace
    until every pool is back at its floor and the retired replicas are
    gone. Checks: at least one scale-up and one scale-down, acted events
    spaced at least their cooldowns, the flap delivered and some demand
    suppressed, nothing lost, no CaptureError and no failed batch, every
    scrape 200, every result bit for bit its bare reference at the rung
    its batch ran, memory allocated after the cycles within 5% of before.
    Reports each scale-up's build seconds and the longest gap between two
    completions in the burst (the longest serving stall)."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    plan = FaultPlan(faults=(Fault("scale_flap", at=2, count=4),))
    injector = plan.injector()
    tracer = Tracer(max_spans=1_000_000)
    policy = ScalePolicy(**SCALE_POLICY)
    names = [p.name for p in pools] if pools else [""]
    with FailureLog() as failures:
        fleet = ScaleTimedFleet(params, cfg, fleet_scfg(precompile=True),
                                fleet_cfg(**({"pools": pools} if pools else {"replicas": 1})),
                                tracer=tracer, injector=injector, device="cuda",
                                sp_devices=SP_CARD)
        before = allocated_now()
        ops, _ = fleet_ops(fleet)
        scalers = [ReplicaAutoscaler(fleet, policy, pool=p, fault_hook=injector.autoscale_hook(),
                                     max_events=100_000) for p in names]
        scrapes, stop = [], threading.Event()
        scraper = threading.Thread(target=scrape_loop, args=(ops.url, stop, scrapes),
                                   name="af2-smoke-scale-scraper", daemon=True)
        scraper.start()
        try:
            for sc in scalers:
                sc.start(SCALE_TICK_S)
            burst = stream * 2
            t0 = time.perf_counter()
            reqs = []
            for seq, msa, mm in burst:
                while True:
                    try:
                        r = fleet.submit(seq, msa=msa, msa_mask=mm)
                        break
                    except QueueFullError as e:
                        time.sleep(min(0.05, e.retry_after_s or 0.005))
                reqs.append(r)
            results = []
            for r in reqs:
                try:
                    results.append(r.result(timeout=FLEET_TIMEOUT))
                except Exception as e:  # noqa: BLE001 — an outcome, checked below
                    results.append(e)
            wall = time.perf_counter() - t0
            # the grace: until the flap is spent, no scaler is mid-action
            # (a replica being built is not counted yet) and every pool is
            # back at its floor with the retired replicas gone
            floor = policy.min_replicas * len(names)
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline and not (
                    injector.exhausted()
                    and not any(sc._tick_gate.locked() for sc in scalers)
                    and fleet.replica_count() <= floor
                    and len(fleet._health.snapshot()["targets"]) <= floor):
                time.sleep(0.05)
        finally:
            for sc in scalers:
                sc.stop()
            stop.set()
            scraper.join(30)
            ops.stop()
        after = allocated_now()
        stats = fleet.stats()
        counts = {p or "fleet": fleet.replica_count(p) if p else fleet.replica_count()
                  for p in names}
        targets = {n: t["state"] for n, t in fleet._health.snapshot()["targets"].items()}
        fleet.shutdown(drain=True, timeout=60)
    rungs = served_rungs(tracer)
    # a copy in flight beside an identical request shares its computation
    # (the engine coalesces them): its rung is the served copy's
    served = {r.seq: rungs[(r.trace_id, r.replica)] for r in results
              if not isinstance(r, Exception) and (r.trace_id, r.replica) in rungs}

    def reference(res):
        req = next(q for q in burst if q[0] == res.seq)
        rung = rungs.get((res.trace_id, res.replica), served.get(res.seq))
        if rung is None:
            return None
        if pools and fleet._replica_pool.get(res.replica) == "long":
            return same_bits(res, bare_result(state["sp_engine"], req, rung, state["refs"]))
        return same_bits(res, bare_result(state["bare"], req, rung, state["refs"]))

    bits = [not isinstance(r, Exception) and bool(reference(r)) for r in results]
    events = [e for sc in scalers for e in sc.scale_events()]
    by_pool = {sc.pool or "fleet": [e["action"] for e in sc.scale_events()] for sc in scalers}
    spaced = all(all(b["ts"] - a["ts"] >= (policy.up_cooldown_s if b["action"] == "up"
                                           else policy.down_cooldown_s)
                     for a, b in zip(ev, ev[1:]))
                 for ev in ([e for e in sc.scale_events()] for sc in scalers))
    suppressed = sum(sc.snapshot()["decisions"]["suppressed"] for sc in scalers)
    reqs_ = stats["requests"]
    # the longest stall: the largest gap between two consecutive ends of
    # the burst's batches (a capture holds the card's lock in between)
    ids = {r.trace_id for r in results if not isinstance(r, Exception)}
    ends = sorted(sp_["ts_s"] + sp_["dur_s"] for sp_ in tracer.spans()
                  if sp_["name"] == "serving.execute"
                  and ids.intersection(sp_["attrs"].get("trace_ids", ())))
    gaps = np.diff(ends) if len(ends) > 1 else np.zeros(1)
    checks = {
        "scaled up and down": any(e["action"] == "up" for e in events)
        and any(e["action"] == "down" for e in events),
        "acted events spaced by the cooldowns": spaced,
        "scale_flap absorbed": injector.exhausted() and suppressed >= 1,
        "nothing lost": reqs_["failed"] == 0 and reqs_["in_flight"] == 0
        and reqs_["completed"] == len(burst) and all(not isinstance(r, Exception)
                                                     for r in results),
        "no CaptureError, no failed batch": not failures.captures and not failures.failures,
        "scrapes 200": bool(scrapes) and all(c == 200 for _, c, _, _ in scrapes),
        "bit for bit the bare engines": all(bits),
        "memory flat (5%)": abs(after - before) <= 0.05 * before,
    }
    ok = all(checks.values())
    reasons = {sc.pool or "fleet": collections.Counter(
        e.get("reason", "") for e in sc.events() if e["action"] == "suppressed")
        for sc in scalers}
    row = {"events": events, "by_pool": by_pool, "builds_s": fleet.builds,
           "replicas_at_end": counts, "targets_at_end": targets,
           "suppressed_by": {k: dict(v) for k, v in reasons.items()},
           "longest_stall_s": float(gaps.max()), "wall_s": wall, "requests": reqs_,
           "delivered": injector.delivered, "suppressed": suppressed,
           "allocated": [before, after], "scrapes": len(scrapes), "bits": sum(bits),
           "checks": checks, "ok": ok}
    log(f"[sp-serve {label}] {len(burst)} requests in {wall:.2f} s; scale events {by_pool}, "
        f"{suppressed} suppressed ({row['suppressed_by']}), flap {injector.delivered}; replicas "
        f"at the end {counts}, targets {targets}; scale-up builds "
        f"{[round(b, 2) for b in fleet.builds]} s; longest gap between batch ends "
        f"{gaps.max() * 1e3:.1f} ms; allocated {before / 2**20:.1f} -> {after / 2**20:.1f} MiB; "
        f"bit for bit {sum(bits)}/{len(bits)}; {len(scrapes)} scrapes; {checks} "
        f"{'ok' if ok else 'FAIL'}")
    return row


def phase_sp_serving(smi):
    """20: the SP serving arm and the replica autoscaler on the card. Counts
    set to 0 just before (a) and read after (d): the wrappers' (every
    engine's warm-ups and captures, the eager references) plus every
    engine's replays. The yardstick's dense and f32 references run before
    the reset (the f32 ones on the f32 route)."""
    def timed(key, fn, *args, **kw):
        t = time.perf_counter()
        result = fn(*args, **kw)
        RECORD["phases"][f"sp_serving_{key}_s"] = time.perf_counter() - t
        log(f"[time] sp serving {key}: {RECORD['phases'][f'sp_serving_{key}_s']:.1f} s")
        return result

    shutil.rmtree(FLEET_WORK, ignore_errors=True)
    FLEET_WORK.mkdir(parents=True)
    cfg = served_config()
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda")
    stream = engine_stream()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    state = {"cfg": cfg, "params": params, "stream": stream, "refs": {}, "f32": [], "dense": []}
    for seq, msa, mm in stream:  # 7b's yardstick: rung 1, as a lone request runs
        fb = featurize_request(seq, msa, mm, ladder=BucketLadder(ENGINE_BUCKETS),
                               msa_rows=ENGINE_ROWS)
        tokens, mask, _ = pad_batch([fb.tokens], fb.bucket, 1)
        live = [types.SimpleNamespace(length=len(fb.tokens), tokens=fb.tokens, msa=fb.msa,
                                      msa_mask=fb.msa_mask)]
        m, mmask = pad_msa_batch(live, fb.bucket, 1, ENGINE_ROWS)
        for key, c in (("f32", f32), ("dense", cfg)):
            out = predict_structure(params, c, tokens, mask=mask, msa=m, msa_mask=mmask,
                                    mds_iters=200, device="cuda")
            L = len(fb.tokens)
            xyz = out["coords"][0, :L].double().cpu()
            state[key].append({"confidence": out["confidence"][0, :L].double().cpu(),
                               "distances": torch.cdist(xyz, xyz)})
    sync()
    FLEET_ENGINES.clear()
    reset_launches()
    try:
        state["bare"] = ServingEngine(params, cfg, fleet_scfg(precompile=True), device="cuda")
        FLEET_ENGINES.append(state["bare"])
        timed("a", phase_sp_engine, state)
        timed("b", phase_sp_times, state, smi)
        RECORD["phases"]["sp_autoscale"] = timed("c", autoscale_run, state, "c")
        pools = (PoolSpec("short", replicas=1, buckets=ENGINE_BUCKETS[:2]),
                 PoolSpec("long", replicas=1, sp_shards=4, sp_schedules=SP_SCHEDULES))
        RECORD["phases"]["sp_pools"] = timed("d", autoscale_run, state, "d", pools=pools)
    finally:
        for key in ("sp_engine", "bare"):
            if key in state:
                state[key].shutdown(drain=False, timeout=60)
                state[key].release_graphs(60)
        shutil.rmtree(FLEET_WORK, ignore_errors=True)
    sync()
    launches = launch_counts()
    for engine in FLEET_ENGINES:
        for name, n in engine.stats()["launches"].items():
            launches[name] = launches.get(name, 0) + n
    FLEET_ENGINES.clear()
    for key, sub in (("sp_autoscale", "c"), ("sp_pools", "d")):
        if not RECORD["phases"][key]["ok"]:
            fail(f"the autoscaler failed a check on the card (phase 20{sub}): "
                 f"{RECORD['phases'][key]['checks']}")
    if not sp_launches_on_wgmma(launches):
        fail(f"a phase 20 flash launch left its wgmma route, or no B3 ran: {launches}")
    log(f"[sp-serve] launches (wrappers and replays) "
        f"{dict((k, n) for k, n in launches.items() if n)}, every B1f and B3 on wgmma")
    RECORD["phases"]["sp_serving_launches"] = launches
    return launches


# --- phase 21: pipelined dispatch on the card ----------------------------------------

PIPE_DEPTHS = (0, 1, 2)
PIPE_TURNS = (0, 1, 2, 2, 1, 0)  # the depths in turns (21a, 21d)
PIPE_INITS = ("classical", "random")


class RecordingEngine(ServingEngine):
    """The engine with each device call's padded batch and init index kept
    (`calls`), so every result can be held against the depth-0 engine's
    executable on the same batch; `timeline` holds each call's host window
    and each batch's response time; `max_inflight` is the largest
    `serve_pipeline_inflight` it published."""

    def __init__(self, *args, **kwargs):
        self.calls, self.timeline, self.max_inflight = [], [], 0
        super().__init__(*args, **kwargs)
        publish = self.metrics.pipeline_inflight_delta

        def delta(n):
            publish(n)
            gauges = self.metrics.registry.snapshot()["gauges"]
            self.max_inflight = max(self.max_inflight, int(gauges["serve_pipeline_inflight"]))

        self.metrics.pipeline_inflight_delta = delta

    def _call_executable(self, bucket, tokens, mask, msa=None, msa_mask=None):
        t0 = time.perf_counter()
        out = super()._call_executable(bucket, tokens, mask, msa, msa_mask)
        with self._counter_lock:
            index = self._batch_counter
        self.calls.append((bucket, tokens.copy(), mask.copy(), msa.copy(), msa_mask.copy(),
                           index))
        self.timeline.append(("call", bucket, tokens.shape[0], t0, time.perf_counter()))
        return out

    def _respond(self, bucket, shape, live, *args, **kwargs):
        self.timeline.append(("done", bucket, shape, time.perf_counter(), None))
        return super()._respond(bucket, shape, live, *args, **kwargs)


def pipe_scfg(**fields):
    """Phase 8b's served engine config (buckets 128 / 256 / 384, rungs 1, 2,
    4, 20 MSA rows, 200 MDS iterations), every (bucket, rung) captured at
    build, no result cache."""
    return fleet_scfg(precompile=True, **fields)


def held_to_depth0(engine, ref_engine, results, stream, cache):
    """Each result against the depth-0 engine's executable on the batch
    `engine` ran it in (`RecordingEngine.calls`: the padded inputs and the
    init index; the request's row is the first that holds its tokens):
    [(index, rung, bit_equal)]. Memoized in `cache` by the batch (and the
    index, for the random init)."""
    rows = []
    random_init = ref_engine.cfg.mds_init == "random"
    for i, (res, (seq, msa, mm)) in enumerate(zip(results, stream)):
        if isinstance(res, Exception):
            rows.append((i, None, False))
            continue
        fb = featurize_request(seq, msa, mm, ladder=ref_engine._ladder, msa_rows=ENGINE_ROWS)
        L = len(fb.tokens)
        found = [(call, r) for call in engine.calls for r in range(call[1].shape[0])
                 if call[0] == fb.bucket and int(call[2][r].sum()) == L
                 and np.array_equal(call[1][r, :L], fb.tokens)]
        if not found:
            rows.append((i, None, False))
            continue
        (bucket, tokens, mask, msa_b, mmask_b, index), r = found[0]
        key = (bucket, tokens.tobytes(), msa_b.tobytes(), mmask_b.tobytes(),
               index if random_init else None)
        if key not in cache:
            exe = ref_engine._executables[(bucket, tokens.shape[0])]
            with ref_engine.graph_lock or contextlib.nullcontext():
                out = exe(tokens, mask, msa_b, mmask_b, seed=ref_engine.init_seed(index))
                cache[key] = {k: v.cpu().numpy() for k, v in out.items()}
        ref = cache[key]
        ok = (np.array_equal(res.coords, ref["coords"][r, :L])
              and np.array_equal(res.confidence, ref["confidence"][r, :L])
              and res.stress == float(ref["stress"][r]) and res.bucket == bucket)
        rows.append((i, tokens.shape[0], ok))
    return rows


def pipe_pass(engine, ref_engine, stream, cache, window=None):
    """One pass of `stream` through `engine` (submitted at once), held to
    depth 0: the numbers of phase 19f's turns, the pass's mean latency,
    mean batch, dispatch order and timeline, the settle thread's event
    queries (count, longest, total host time), and (depth > 0) the overlap
    ratio from the engine's counters. `window`: a context around the pass
    alone (not its references), e.g. a profiler."""
    engine.calls.clear()
    engine.timeline.clear()
    before = engine.stats()
    queries = []  # the host seconds of each event query the settle thread made
    query = torch.cuda.Event.query

    def timed_query(event):
        t0 = time.perf_counter()
        done = query(event)
        queries.append(time.perf_counter() - t0)
        return done

    torch.cuda.Event.query = timed_query
    try:
        with window if window is not None else contextlib.nullcontext():
            results, wall = run_stream(engine, stream)
            sync()
    finally:
        torch.cuda.Event.query = query
    after = engine.stats()
    rows = held_to_depth0(engine, ref_engine, results, stream, cache)
    batches = after["batches"]["count"] - before["batches"]["count"]
    lat = [r.latency_s for r in results if not isinstance(r, Exception)]
    out = {"depth": engine.cfg.pipeline_depth, **stream_numbers(results, wall),
           "mean_ms": 1e3 * sum(lat) / max(1, len(lat)),
           "mean_batch": len(results) / batches if batches else 0.0,
           "bit_equal": sum(ok for *_, ok in rows), "requests": len(rows),
           "rungs": sorted({r for _, r, _ in rows if r}),
           "queries": len(queries), "query_ms_max": 1e3 * max(queries, default=0.0),
           "query_ms_total": 1e3 * sum(queries),
           "order": [(c[0], c[1].shape[0]) for c in engine.calls],  # (bucket, rung) a call
           # ("call", bucket, rung, start, end) a device call and ("done", bucket, rung,
           # t) a batch's response, host seconds from the pass's first call
           "timeline": [(kind, b, r, t0 - engine.timeline[0][3],
                         None if t1 is None else t1 - engine.timeline[0][3])
                        for kind, b, r, t0, t1 in engine.timeline]}
    if engine.cfg.pipeline_depth:
        span = after["pipeline"]["span_seconds"] - before["pipeline"]["span_seconds"]
        billed = after["pipeline"]["window_seconds"] - before["pipeline"]["window_seconds"]
        out["overlap_ratio"] = span / billed if billed > 0 else 0.0
    return out


def kernel_union_us(events):
    """The union of a Chrome trace's kernel intervals, in microseconds."""
    busy, end = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") == "kernel"):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return busy


def pipe_profiled(engines, state, init):
    """(d)'s busy shares: one more pass of each depth, each pass alone in a
    torch.profiler of the card's activity; from its Chrome trace,
    the union of the kernels' intervals over the pass's wall (None when the
    trace shows no kernel)."""
    out = []
    for d in PIPE_DEPTHS:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        t = pipe_pass(engines[d], engines[0], state["stream"], state["refs"][init], window=prof)
        path = ROOT / "build" / "phase21_trace.json"
        path.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(path))
        busy = kernel_union_us(json.loads(path.read_text())["traceEvents"])
        path.unlink()
        t.update(device_ms=busy / 1e3, busy_share=busy / (1e6 * t["wall_s"]) if busy else None)
        out.append(t)
    return out


def gil_probe(reps=3, queued=40):
    """(d) Which host waits for the card keep the interpreter lock: a thread
    ticks every millisecond while the main thread waits, `reps` times
    each, for `queued` f32 4096^2 products queued on the card (~100 ms)
    in `torch.linalg.eigh` (a 64 x 64 matrix, and a (4, 384, 384) one: the
    classical init's Gram matrices at bucket 384, rung 4), in
    `Tensor.item`, in `Event.synchronize` and in an `Event.query` polled
    between 0.2 ms sleeps (`CapturedExecutable._wait_for_card`): each
    kind's longest gap between ticks (the median over `reps`) beside its
    wait."""
    x = torch.randn(4096, 4096, device="cuda")
    y = torch.empty_like(x)
    g = torch.eye(64, device="cuda") * 2.0
    m = torch.randn(4, 384, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    gram = m @ m.transpose(1, 2) + torch.eye(384, device="cuda")
    ticks, stop = [], threading.Event()

    def ticker():
        while not stop.is_set():
            ticks.append(time.perf_counter())
            time.sleep(1e-3)

    def poll():
        event = torch.cuda.Event()
        event.record()
        while not event.query():
            time.sleep(2e-4)

    def synced():
        event = torch.cuda.Event()
        event.record()
        event.synchronize()

    waits = {"eigh 64": lambda: torch.linalg.eigh(g),
             "eigh (4, 384, 384)": lambda: torch.linalg.eigh(gram),
             "item": lambda: y[0, 0].item(),
             "event_synchronize": synced, "event_query_poll": poll}
    thread = threading.Thread(target=ticker, name="af2-smoke-ticker", daemon=True)
    thread.start()
    out = {}
    try:
        for name, wait in waits.items():
            gaps, spans = [], []
            for _ in range(reps):
                sync()
                for _ in range(queued):
                    torch.matmul(x, x, out=y)
                t0 = time.perf_counter()
                wait()
                t1 = time.perf_counter()
                inside = [t for t in list(ticks) if t0 <= t <= t1]
                points = [t0] + inside + [t1]
                gaps.append(max(b - a for a, b in zip(points, points[1:])))
                spans.append(t1 - t0)
            out[name] = {"wait_ms": 1e3 * sorted(spans)[reps // 2],
                         "longest_gap_ms": 1e3 * sorted(gaps)[reps // 2]}
    finally:
        stop.set()
        thread.join(10)
    return out


def pipe_concurrent_capture(engines, state, init):
    """(b) The depth-2 engine serves the stream, pass after pass, while a
    second engine on the card precompiles its 9 (bucket, rung) graphs on
    another thread and a thread scrapes /metrics, /healthz and /statusz of
    the engine's ops server: every pass bit for bit depth 0, every scrape
    200, no CaptureError and no failed batch, the second engine built."""
    engine, ref = engines[2], engines[0]
    ops = ops_server_for_engine(engine, tick_interval_s=0.05)
    ops.start()
    scrapes, stop = [], threading.Event()
    scraper = threading.Thread(target=scrape_loop, args=(ops.url, stop, scrapes),
                               name="af2-smoke-pipe-scraper", daemon=True)
    box = {}

    def build():
        try:
            box["engine"] = ServingEngine(state["params"], state["cfg"],
                                          pipe_scfg(mds_init=init), device="cuda")
        except Exception as e:  # noqa: BLE001 — checked below
            box["error"] = e

    building = threading.Thread(target=build, name="af2-smoke-pipe-build", daemon=True)
    passes = []
    with FailureLog() as failures:
        scraper.start()
        try:
            building.start()
            while building.is_alive() or len(passes) < 2:
                passes.append(pipe_pass(engine, ref, state["stream"], state["refs"][init]))
                if len(passes) >= 20:
                    break
            building.join(FLEET_TIMEOUT)
        finally:
            stop.set()
            scraper.join(30)
            ops.stop()
            if "engine" in box:
                box["engine"].shutdown(drain=False, timeout=60)
                box["engine"].release_graphs(60)
                FLEET_ENGINES.append(box["engine"])
    checks = {
        "bit for bit depth 0": all(p["bit_equal"] == p["requests"] for p in passes),
        "nothing lost": all(p["failed"] == 0 for p in passes),
        "second engine built while serving": "engine" in box and not building.is_alive()
        and len(box["engine"]._executables) == len(ENGINE_BUCKETS) * 3,
        "no CaptureError, no failed batch": not failures.captures and not failures.failures,
        "scrapes 200": bool(scrapes) and all(code == 200 for _, code, _, _ in scrapes),
    }
    return {"passes": passes, "scrapes": len(scrapes), "checks": checks,
            "error": repr(box.get("error")), "ok": all(checks.values())}


def phase_pipeline_depths(state, smi):
    """(a) and (d) for each init, (b) for the random one (whose enqueue
    never waits, so the most work is in flight when the capture comes):
    engines at depths 0, 1 and 2 (every (bucket, rung) captured at build,
    no cache); the stream through them in turns 0, 1, 2, 2, 1, 0, every
    result bit for bit the depth-0 engine's executable on its batch,
    `serve_pipeline_inflight` never past the depth; (b) at depth 2; (d)
    one more pass of each depth under torch.profiler."""
    out = {}
    for init in PIPE_INITS:
        state["refs"][init] = {}
        engines = {}
        t0 = time.perf_counter()
        try:
            for d in PIPE_DEPTHS:
                engines[d] = RecordingEngine(state["params"], state["cfg"],
                                             pipe_scfg(mds_init=init, pipeline_depth=d),
                                             device="cuda")
                FLEET_ENGINES.append(engines[d])
            build_s = time.perf_counter() - t0
            with FailureLog() as failures:
                turns = [pipe_pass(engines[d], engines[0], state["stream"], state["refs"][init])
                         for d in PIPE_TURNS]
            t1 = time.perf_counter()
            concurrent = (pipe_concurrent_capture(engines, state, init) if init == "random"
                          else None)
            t2 = time.perf_counter()
            profiled = pipe_profiled(engines, state, init)
            log(f"[time] pipeline {init}: builds {build_s:.1f} s, turns {t1 - t0 - build_s:.1f} "
                f"s, (b) {t2 - t1:.1f} s, profiled passes {time.perf_counter() - t2:.1f} s")
        finally:
            for d, engine in engines.items():
                if init == "classical" and d == 0:
                    # (c)'s bare engine: its executables serve the references
                    state["bare"] = engine
                    continue
                engine.shutdown(drain=False, timeout=60)
                engine.release_graphs(60)
        inflight = {d: engines[d].max_inflight for d in PIPE_DEPTHS}
        checks = {
            "bit for bit depth 0": all(t["bit_equal"] == t["requests"]
                                       for t in turns + profiled),
            "nothing lost": all(t["failed"] == 0 for t in turns + profiled),
            "no CaptureError, no failed batch": not failures.captures
            and not failures.failures,
            "inflight within the depth": all(inflight[d] <= d for d in PIPE_DEPTHS)
            and inflight[2] >= 1,
        }
        ok = all(checks.values())
        for t in turns + profiled:
            busy = t.get("busy_share")
            log(f"[pipeline d] {init} depth {t['depth']}: {t['requests_per_s']:.2f} requests/s, "
                f"p50 {t['p50_ms']:.1f} ms, p95 {t['p95_ms']:.1f} ms, mean {t['mean_ms']:.1f} "
                f"ms, mean batch {t['mean_batch']:.2f}"
                + (f", overlap {t['overlap_ratio']:.3f}, {t['queries']} event queries (longest "
                   f"{t['query_ms_max']:.2f} ms, {t['query_ms_total']:.1f} ms in all)"
                   if "overlap_ratio" in t else "")
                + (f", busy {'not measured' if busy is None else f'{busy:.3f}'} (profiled)"
                   if "device_ms" in t else "") + f" ({smi})")
        log(f"[pipeline a] {init}: 3 engines built in {build_s:.1f} s; turns {PIPE_TURNS}: bit "
            f"for bit depth 0 {[t['bit_equal'] for t in turns]}/{len(state['stream'])} (rungs "
            f"{sorted({r for t in turns for r in t['rungs']})}); max inflight {inflight}; "
            f"{checks} {'ok' if ok else 'FAIL'}")
        c = concurrent
        if c is not None:
            log(f"[pipeline b] {init}, depth 2 beside a precompiling engine: "
                f"{len(c['passes'])} passes ({[p['bit_equal'] for p in c['passes']]} bit for "
                f"bit), {c['scrapes']} scrapes; {c['checks']} {'ok' if c['ok'] else 'FAIL'}")
            checks.update({f"(b) {k}": v for k, v in c["checks"].items()})
        out[init] = {"build_s": build_s, "turns": turns, "profiled": profiled,
                     "inflight": inflight, "concurrent": concurrent, "checks": checks,
                     "card": smi, "ok": all(checks.values())}
    return out


def phase_pipeline_fleet(state):
    """(c) A 2-replica fleet at depth 2 (no precompile) under phase 19b's
    kill (r0 latched at its first dispatch), the stream once: nothing
    lost, no CaptureError and no failure but the injected ones, every
    result bit for bit the depth-0 engine's at the rung its batch ran.
    Then a fresh 2-replica fleet at depth 2 through a warm-up and 3 drain
    and reinstate cycles of r0, each drain taken with the same burst of 4
    requests in flight: nothing lost, each result bit for bit, memory
    allocated after each of the 3 cycles within 5% of the first of them
    (the warm-up's reading is reported; on an H100 it read 5.5% above the
    later, flat ones: PERF.md §6)."""
    cfg, params, stream = state["cfg"], state["params"], state["stream"]
    bare = state["bare"]
    injector = FaultPlan(faults=(Fault("kill_replica", replica="r0", at=0),)).injector()
    tracer = Tracer(max_spans=1_000_000)
    with FailureLog() as failures:
        fleet = TrackedFleet(params, cfg, fleet_scfg(pipeline_depth=2),
                             fleet_cfg(replicas=2, reprobe_interval_s=0.2), tracer=tracer,
                             injector=injector, device="cuda")
        try:
            results, wall = run_stream(fleet, stream)
            stats = fleet.stats()
        finally:
            fleet.shutdown(drain=True, timeout=60)
    rows = held_to(results, stream, served_rungs(tracer), lambda res: bare, state["fleet_refs"])
    reqs = stats["requests"]
    requeued = sum(1 for r in results if not isinstance(r, Exception) and r.requeues)
    kill = {"nothing lost": reqs["failed"] == 0 and reqs["in_flight"] == 0
            and reqs["completed"] == len(stream),
            "only injected failures, no CaptureError": failures.only_injected(),
            "requeues counted": stats["telemetry"]["metrics"]["counters"]
            ["fleet_requeue_total"] > 0 and requeued > 0,
            "bit for bit the bare engine": all(ok for *_, ok in rows)}
    tracer = Tracer(max_spans=1_000_000)
    fleet = TrackedFleet(params, cfg, fleet_scfg(pipeline_depth=2),
                         fleet_cfg(replicas=2, reprobe_interval_s=0.05), tracer=tracer,
                         device="cuda")
    allocated, burst_rows, served_by, in_flight_at_drain = [], [], [], []
    with FailureLog() as cycle_failures:
        try:
            burst = stream[:4]
            for k in range(4):
                pending = [fleet.submit(seq, msa=msa, msa_mask=mm) for seq, msa, mm in burst]
                # drain r0 once a batch of the burst is in flight on it (up
                # to 10 s; whether one was is reported)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    engine = fleet._replicas["r0"].engine
                    if engine is not None and engine.metrics.pipeline_snapshot()["inflight"]:
                        in_flight_at_drain.append(True)
                        break
                    time.sleep(5e-4)
                else:
                    in_flight_at_drain.append(False)
                fleet._health.force_down("r0", "phase 21c drain cycle")
                got = []
                for p in pending:
                    try:
                        got.append(p.result(timeout=FLEET_TIMEOUT))
                    except Exception as e:  # noqa: BLE001 — an outcome, checked below
                        got.append(e)
                deadline = time.monotonic() + 60
                while (fleet.stats()["health"]["targets"]["r0"]["reinstatements"] < k + 1
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                served_by.append([getattr(r, "replica", None) for r in got])
                burst_rows += held_to(got, burst, served_rungs(tracer), lambda res: bare,
                                      state["fleet_refs"])
                allocated.append(allocated_now())
            targets = fleet.stats()["health"]["targets"]
        finally:
            fleet.shutdown(drain=True, timeout=60)
    cycles = {"nothing lost, bit for bit": all(ok for *_, ok in burst_rows),
              "no CaptureError, no failed batch": not cycle_failures.captures
              and not cycle_failures.failures,
              "r0 drained and reinstated 4 times": targets["r0"]["drains"] == 4
              and targets["r0"]["reinstatements"] == 4,
              "allocated flat": max(allocated[1:]) - min(allocated[1:])
              <= 0.05 * allocated[1]}
    ok = all(kill.values()) and all(cycles.values())
    log(f"[pipeline c] 2 replicas at depth 2, r0 killed: {len(stream)} requests in "
        f"{wall:.2f} s, {reqs}, {requeued} requeued, {injector.delivered}; {kill}; a warm-up "
        f"and 3 drain cycles under a burst of 4 (a batch in flight on r0 at the drain: "
        f"{in_flight_at_drain}; served by {served_by}): allocated "
        f"{[round(a / 2**20, 1) for a in allocated]} MiB; {cycles} {'ok' if ok else 'FAIL'}")
    return {"kill": kill, "rows": rows, "requests": reqs, "requeued": requeued,
            "cycles": cycles, "allocated": allocated, "served_by": served_by,
            "in_flight_at_drain": in_flight_at_drain, "ok": ok}


def phase_pipeline(smi):
    """21: pipelined dispatch in the captured engine. Counts set to 0 just
    before (a) and read after (c): the wrappers' (every engine's warm-ups
    and captures, the depth-0 references' replays counted by the
    executables) plus every engine's replays; every B1f launch on wgmma."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"pipeline_{key}_s"] = time.perf_counter() - t
        log(f"[time] pipeline {key}: {RECORD['phases'][f'pipeline_{key}_s']:.1f} s")
        return result

    cfg = served_config()
    state = {"cfg": cfg, "params": alphafold2_init(cfg, torch.Generator().manual_seed(0), "cuda"),
             "stream": engine_stream(), "refs": {}, "fleet_refs": {}}
    FLEET_ENGINES.clear()
    reset_launches()
    try:
        depths = timed("abd", phase_pipeline_depths, state, smi)
        fleet = timed("c", phase_pipeline_fleet, state)
        gil = gil_probe()
        log("[pipeline d] the longest gap of a 1 ms ticker thread while the main thread "
            "waits for ~100 ms of queued card work, by wait: "
            + ", ".join(f"{k} {v['longest_gap_ms']:.1f} ms of {v['wait_ms']:.1f}"
                        for k, v in gil.items()) + f" ({smi})")
    finally:
        for engine in FLEET_ENGINES:
            engine.shutdown(drain=False, timeout=60)
            engine.release_graphs(60)
    RECORD["phases"]["pipeline"] = {"depths": depths, "fleet": fleet, "gil": gil}
    sync()
    launches = launch_counts()
    for engine in FLEET_ENGINES:
        for name, n in engine.stats()["launches"].items():
            launches[name] = launches.get(name, 0) + n
    FLEET_ENGINES.clear()
    for init, r in depths.items():
        if not r["ok"]:
            fail(f"pipelined dispatch failed a check on the card (phase 21a-b, {init}): "
                 f"{r['checks']}"
                 + (f" {r['concurrent']['error']}" if r["concurrent"] else ""))
    if not fleet["ok"]:
        fail(f"the pipelined fleet failed a check (phase 21c): {fleet['kill']} "
             f"{fleet['cycles']}")
    if not on_wgmma(launches):
        fail(f"a phase 21 flash launch left its wgmma route: {launches}")
    log(f"[pipeline] launches (wrappers and replays) "
        f"{dict((k, n) for k, n in launches.items() if n)}, all on wgmma")
    RECORD["phases"]["pipeline_launches"] = launches
    return launches


# --- phase 22: the sequence-parallel training step ------------------------------------

SP_TRAIN_P = 4  # shards, all on the first card


def sp_train_config(**fields):
    """train_pre's widths (dim 256, heads 8, dim_head 64, bf16) at depth 2
    with tied MSA rows and the aligned crosses with KV compression 4: the
    ring cross runs, and at depth 2 its first layer's backward reaches the
    loss (the last layer's MSA<-pair ring feeds only the MSA stream, which
    the head does not read). `fields` over them."""
    return train_pre_config(**{**dict(depth=2, msa_tie_row_attn=True, cross_attn_mode="aligned",
                                      cross_attn_compress_ratio=4), **fields})


def sp_step_launches(P, depth, microbatches, route):
    """The flash launches of `microbatches` SP distogram microbatches with
    an MSA, tied rows and aligned crosses: a layer a shard 4 B1f (the pair
    rows and columns, the MSA columns, the gathered pair<-MSA cross; the
    tied MSA rows are an einsum) and P B3 hops of the MSA<-pair ring; every
    B1f has its B1b dq and dkv, every ring but the last layer's its B3 dq
    and dkv (P^2 each a ring call). Each route-counted on `route`."""
    fwd = 4 * P * depth * microbatches
    ring = P * P * depth * microbatches
    ring_bwd = P * P * (depth - 1) * microbatches
    return {"flash_fwd": fwd, "flash_fwd_lse": ring, f"flash_fwd_{route}": fwd + ring,
            "flash_bwd_dq": fwd, "flash_bwd_dkv": fwd, "flash_bwd_lse_dq": ring_bwd,
            "flash_bwd_lse_dkv": ring_bwd, f"flash_bwd_dq_{route}": fwd + ring_bwd,
            f"flash_bwd_dkv_{route}": fwd + ring_bwd}


def exact(launches, expect):
    """launches == expect on every name either names (0 where absent)."""
    return all(launches.get(k, 0) == expect.get(k, 0) for k in set(launches) | set(expect))


def first_step_metrics(cfg, tcfg, batch):
    """One eager dense distogram step of a fresh seeded state on the card:
    its loss and grad_norm (floats)."""
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    _, m = make_train_step(cfg, tcfg, device="cuda")(state, batch)
    out = {k: float(v) for k, v in m.items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def card_and_cpu(cfg, tcfg, sp):
    """The same seeded params on the card and on the CPU, and each
    device's step: the SP step over 4 shards of that device when `sp`,
    else the dense step. Keyed "cuda" and "cpu" (`card_vs_cpu_steps`)."""
    states, steps = {}, {}
    for dev in ("cuda:0", "cpu"):
        key = dev.split(":")[0]
        states[key] = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), dev)
        steps[key] = (make_sp_train_step(cfg, tcfg, make_mesh({"seq": SP_TRAIN_P},
                                                               devices=[dev] * SP_TRAIN_P))
                      if sp else make_train_step(cfg, tcfg, device=dev))
    return states, steps


def yardstick(sp, dense, f32):
    """7b's bound carried to the step: SP's distance from the f32 step
    within 1.5x the dense bf16 step's own, plus 1e-5, for loss and
    grad_norm. Returns (rows, ok)."""
    rows, ok = {}, True
    for key in ("loss", "grad_norm"):
        d_sp, d_dense = abs(sp[key] - f32[key]), abs(dense[key] - f32[key])
        rows[key] = {"sp": sp[key], "dense": dense[key], "f32": f32[key], "sp_vs_f32": d_sp,
                     "dense_vs_f32": d_dense, "bound": 1.5 * d_dense + 1e-5}
        ok = ok and d_sp <= rows[key]["bound"]
    return rows, ok


def phase_sp_train_parity(L=64, rows=8, accum=2):
    """(a) f32, the SP distogram step (`make_sp_train_step`) over 4 shards
    of the card (["cuda:0"] * 4) against the same over 4 CPU shards from
    the same params and batches: dim 256, depth 1, 8 heads of 64, L = 64,
    tied rows, aligned crosses with KV compression 4, 8 MSA rows, accum 2,
    3 steps, `attn_flash=True` on both (the padded MSA columns' empty key
    sets: flash gives zeros on both devices). Phase 6a's comparison and
    tolerances (`card_vs_cpu_steps`), with every B1f / B1b / B3 launch
    counted exactly on the f32 route: at depth 1 the ring's output reaches
    no loss, so B3's dq and dkv are 0 here (they run in (b) and (c), and
    card against CPU in 7c). At depth 2 the dense step of this config
    itself departs from the CPU past 6a's grad_norm tolerance at some data
    seeds (`sp_train_drift`, not a phase)."""
    cfg = sp_train_config(depth=1, dtype=torch.float32, attn_flash=True, max_seq_len=L)
    tcfg = TrainConfig(grad_accum=accum)
    fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, msa_rows=rows, seed=5),
                                    accum)
    states, steps = card_and_cpu(cfg, tcfg, sp=True)
    expect = sp_step_launches(SP_TRAIN_P, cfg.depth, 3 * accum, "f32")
    card_vs_cpu_steps("sp_train a", "sp_train_parity", f"SP over {SP_TRAIN_P} shards, L={L} f32 "
                      f"depth {cfg.depth}, {rows} rows", repr(cfg), states, steps, fetch, tcfg,
                      expect)
    return launch_counts()


def sp_train_drift(seeds=(5, 6), L=64, rows=8, accum=2):
    """Not a phase of the script: (a)'s card-vs-CPU comparison for the SP
    step and for the dense step at the same config, at each data seed,
    reported without failing (`RECORD["phases"]["sp_train_drift_<arm>_<seed>"]`):
    whether the SP step's distance from the CPU is the config's own. Run as
        python3 -c "import chip_smoke as c; c.phase_card(); c.phase_build(); c.sp_train_drift()"
    """
    cfg = sp_train_config(dtype=torch.float32, attn_flash=True, max_seq_len=L)
    tcfg = TrainConfig(grad_accum=accum)
    out = {}
    for seed in seeds:
        fetch = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, msa_rows=rows,
                                                   seed=seed), accum)
        for arm in ("dense", "sp"):
            states, steps = card_and_cpu(cfg, tcfg, sp=arm == "sp")
            key = f"sp_train_drift_{arm}_{seed}"
            try:
                card_vs_cpu_steps(f"sp_train drift {arm} seed {seed}", key, arm, repr(cfg),
                                  states, steps, fetch, tcfg, {})
            except SystemExit as e:
                log(f"[sp_train drift] {arm} seed {seed}: {e}")
            out[key] = RECORD["phases"][key]["steps"]
    return out


def captured_arm(cfg, tcfg, batch, loss_fn, reps=5):
    """A fresh seeded state's captured step (`CapturedTrainStep`) on one
    batch: the process's peak allocated memory (GiB) from a reset just
    before the state is made (the state, AdamW moments, the warm-up, the
    capture and the replays, over whatever else the process holds),
    capture seconds and the replays' median ms (`captured_ms`, CUDA
    events). The counts are set to 0 before and read after."""
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    step = CapturedTrainStep(cfg, tcfg, state, batch, loss_fn=loss_fn)
    ms, times = captured_ms(step, state, batch, reps=reps)
    sync()
    launches = _merged(launch_counts(), step.replayed_launches())
    out = {"step_ms": ms, "times": times, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "capture_s": next(iter(step.captures.values())).seconds, "launches": launches}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sp_train_captured(smi, L=256, rows=20, accum=16):
    """(b) bf16 at train_pre's widths, captured: `sp_train_config()`, crop
    256, a 20-row MSA, accum 16, 4 shards on the card:
      - the captured SP step (`CapturedTrainStep(loss_fn=sp_distogram_
        loss_fn(mesh))`) against the eager `make_sp_train_step` over 3
        batches, bit for bit (`capture_vs_eager`: loss, grad_norm, every
        param, AdamW moment and count);
      - the capture's launches exactly `sp_step_launches` for one step on
        the wgmma route: B3's dq and dkv recorded in the graph;
      - the first step's loss and grad_norm within 1.5x the dense bf16
        step's own distance from the dense f32 step, plus 1e-5, all three
        from the same params and batch (`yardstick`);
      - reported: the captured SP and dense steps on one batch (median of
        5 replays, CUDA events) and their peak memory (`captured_arm`)."""
    cfg = sp_train_config()
    mesh = make_mesh({"seq": SP_TRAIN_P}, devices=["cuda:0"] * SP_TRAIN_P)
    captured, state, last = capture_vs_eager("sp bf16", cfg, L, accum, wgmma=False,
                                             msa_rows=rows, sp_mesh=mesh, tag="sp_train b")
    capture = next(iter(captured.captures.values()))
    expect = sp_step_launches(SP_TRAIN_P, cfg.depth, accum, "wgmma")
    counts_ok = exact(capture.launches, expect)
    sp_first = RECORD["phases"]["train_capture_sp bf16"]["steps"][0]
    launches = _merged(launch_counts(), captured.replayed_launches())
    del captured, state
    # the bound: the same first batch and schedule as capture_vs_eager's
    tcfg = TrainConfig(grad_accum=accum, warmup_steps=1, decay_steps=3, decay_floor=0.1,
                       max_grad_norm=0.05, weight_decay=0.01)
    first = synthetic_microbatch_fn(DataConfig(batch_size=1, max_len=L, seed=9, msa_rows=rows),
                                    accum)(0)
    dense = first_step_metrics(cfg, tcfg, first)
    f32 = first_step_metrics(dataclasses.replace(cfg, dtype=torch.float32), tcfg, first)
    bound, bound_ok = yardstick(sp_first, dense, f32)
    arms = {"sp": captured_arm(cfg, tcfg, last, sp_distogram_loss_fn(mesh)),
            "dense": captured_arm(cfg, tcfg, last, distogram_loss_fn)}
    for arm in arms.values():
        launches = _merged(launches, arm.pop("launches"))
    ok = counts_ok and bound_ok
    log(f"[sp_train b] the capture's launches {'==' if counts_ok else '!='} one step's "
        f"{expect} ({capture.launches}); first step: "
        + "; ".join(f"{k} SP {v['sp']:.6f} dense {v['dense']:.6f} f32 {v['f32']:.6f}, |SP - f32| "
                    f"{v['sp_vs_f32']:.3e} (bound {v['bound']:.3e})" for k, v in bound.items())
        + f" {'ok' if ok else 'FAIL'}")
    log(f"[sp_train b] captured step, L={L}, accum {accum}, {rows} rows, bf16 ({smi}): SP "
        f"{arms['sp']['step_ms']:.2f} ms (median of 5), peak {arms['sp']['peak_gib']:.2f} GiB, "
        f"capture {arms['sp']['capture_s']:.2f} s; dense {arms['dense']['step_ms']:.2f} ms, "
        f"peak {arms['dense']['peak_gib']:.2f} GiB, capture {arms['dense']['capture_s']:.2f} s")
    RECORD["phases"]["sp_train_captured"] = {
        "L": L, "rows": rows, "grad_accum": accum, "config": repr(cfg), "card": smi,
        "captured_launches": capture.launches, "expected": expect, "counts_ok": counts_ok,
        "bound": bound, "arms": arms, "ok": ok}
    if not ok:
        fail("the captured SP step's launches or its first step's agreement failed (phase 22b)")
    return launches


def sp_e2e_step(ecfg, crop, rows, accum, mesh=None, reps=0, seed=9):
    """The eager e2e step of a fresh seeded state on the card at `crop`
    (`make_sp_train_step(loss_fn=sp_e2e_loss_fn(mesh))`, or the dense
    `make_train_step(loss_fn=e2e_loss_fn)` without a mesh): the first
    step's metrics, then `reps` more steps timed (CUDA events); the
    counts set to 0 and the peak memory reset before the state is made,
    both read after."""
    tcfg = TrainConfig(grad_accum=accum)
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = e2e.e2e_train_state_init(ecfg, tcfg, torch.Generator().manual_seed(0), "cuda")
    step = (make_train_step(ecfg, tcfg, loss_fn=e2e.e2e_loss_fn, device="cuda") if mesh is None
            else make_sp_train_step(ecfg, tcfg, mesh, loss_fn=sp_e2e_loss_fn(mesh)))
    fetch = structure_fetch(crop, rows, accum, seed=seed)
    try:
        _, m = step(state, fetch(0))
        first = {k: float(v) for k, v in m.items()}
        times = []
        for n in range(1, reps + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, fetch(n))
            end.record()
            sync()
            times.append(start.elapsed_time(end))
        sync()
        return {"first": first, "times": times,
                "step_ms": sorted(times)[len(times) // 2] if times else None,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": launch_counts()}
    finally:
        del state, step
        gc.collect()
        torch.cuda.empty_cache()


def phase_sp_train_e2e(smi, rows=E2E_ROWS, accum=2):
    """(c) the e2e step, eager, at phase 12b's widths less remat (the SP
    trunk has none): `e2e_north_star(crop, remat=False)`, 128 MSA rows,
    accum 2, SP over 4 shards of the card against the dense step, from the
    same params and batches. Crop 384 if the SP step fits the card (one
    step tried first; an out-of-memory error is recorded), else 256; the
    checked comparison runs at 256 whatever the probe says, because its
    f32 yardstick (the dense f32 step, with remat) needs twice 12b's bf16
    activations, past the card at 384. Checks at 256: the SP step's first
    loss and grad_norm within `yardstick` of the dense bf16 and f32 steps;
    every B1f, dq and dkv launch on wgmma, B3's forward 16 a ring call
    (depth x accum of them) and its dq and dkv 16 a ring whose output
    reaches the loss (the first layer's). Reported: the SP step's ms
    (median of 3 after the first) and peak memory, the dense step's."""
    mesh = make_mesh({"seq": SP_TRAIN_P}, devices=["cuda:0"] * SP_TRAIN_P)
    probe = {"crop": E2E_CROP}
    try:
        r = sp_e2e_step(e2e_north_star(E2E_CROP, remat=False), E2E_CROP, rows, accum, mesh)
        probe.update(fits=True, peak_gib=r["peak_gib"], loss=r["first"]["loss"])
    except torch.cuda.OutOfMemoryError as e:
        probe.update(fits=False, error=str(e).splitlines()[0][:300])
    log(f"[sp_train c] the SP e2e step at crop {E2E_CROP} (grid {3 * E2E_CROP}, no remat): "
        + (f"fits, peak {probe['peak_gib']:.2f} GiB" if probe["fits"]
           else f"out of memory ({probe['error']})"))
    crop = 256
    ecfg = e2e_north_star(crop, remat=False)
    sp = sp_e2e_step(ecfg, crop, rows, accum, mesh, reps=3)
    dense = sp_e2e_step(ecfg, crop, rows, accum, reps=3)
    f32 = sp_e2e_step(e2e_north_star(crop, remat=True, dtype=torch.float32), crop, rows,
                      accum)["first"]
    bound, bound_ok = yardstick(sp["first"], dense["first"], f32)
    lz = sp["launches"]
    steps = 4  # the first and 3 timed
    ring, ring_bwd = (SP_TRAIN_P ** 2 * ecfg.model.depth * accum * steps,
                      SP_TRAIN_P ** 2 * (ecfg.model.depth - 1) * accum * steps)
    routes_ok = (lz.get("flash_fwd_lse", 0) == ring and lz.get("flash_bwd_lse_dq", 0) == ring_bwd
                 and lz.get("flash_bwd_lse_dkv", 0) == ring_bwd
                 and lz.get("flash_fwd_wgmma", 0) == lz.get("flash_fwd", 0) + ring
                 and all(lz.get(f"flash_bwd_{k}_wgmma", 0)
                         == lz.get(f"flash_bwd_{k}", 0) + lz.get(f"flash_bwd_lse_{k}", 0)
                         for k in ("dq", "dkv")))
    ok = bound_ok and routes_ok and all(math.isfinite(v) for v in sp["first"].values())
    log(f"[sp_train c] e2e step at crop {crop} (grid {3 * crop}), {rows} rows, accum {accum}, "
        f"bf16, eager ({smi}): SP {sp['step_ms']:.1f} ms (median of 3: "
        f"{', '.join(f'{t:.1f}' for t in sp['times'])}), peak {sp['peak_gib']:.2f} GiB; dense "
        f"{dense['step_ms']:.1f} ms, peak {dense['peak_gib']:.2f} GiB; first step "
        + "; ".join(f"{k} SP {v['sp']:.5f} dense {v['dense']:.5f} f32 {v['f32']:.5f} "
                    f"(|SP - f32| {v['sp_vs_f32']:.3e}, bound {v['bound']:.3e})"
                    for k, v in bound.items())
        + f"; SP launches {dict((k, n) for k, n in lz.items() if n)}"
        + f"{'' if routes_ok else ' (OFF wgmma or a B3 count wrong)'} {'ok' if ok else 'FAIL'}")
    RECORD["phases"]["sp_train_e2e"] = {
        "probe_384": probe, "crop": crop, "rows": rows, "grad_accum": accum,
        "config": repr(ecfg), "card": smi, "sp": sp, "dense": dense, "f32_first": f32,
        "bound": bound, "routes_ok": routes_ok, "ok": ok}
    if not ok:
        fail("the SP e2e step disagrees with the dense one, or left wgmma (phase 22c)")
    return _merged(lz, dense["launches"])


def phase_sp_train_cli():
    """(d) the CLIs on the card, in this process: `train_pre --sp-shards 1
    --bf16` (captured: the startup line says so) and `train_end2end
    --sp-shards 1` finish finite; `--sp-shards 4` on a host with fewer
    than 4 cards exits with the mesh's device-count error, with 4 or more
    the eager step over distinct cards runs one step."""
    cards = torch.cuda.device_count()
    rows = []
    runs = [(train_pre, ["--steps", "3", "--bf16", "--accum", "2", "--sp-shards", "1"],
             "the step runs captured as a CUDA graph"),
            (train_end2end, ["--steps", "2", "--sp-shards", "1"], "sequence-parallel trunk")]
    if cards >= SP_TRAIN_P:
        runs.append((train_pre, ["--steps", "1", "--bf16", "--accum", "2", "--len", "128",
                                 "--sp-shards", str(SP_TRAIN_P)], "the step runs eager"))
    for module, argv, says in runs:
        t0 = time.perf_counter()
        (state, metrics), lines = quiet(module.main, argv)
        sync()
        ok = (any(says in line for line in lines) and lines[-1:] == ["done"]
              and all(math.isfinite(float(v)) for v in metrics.values()))
        rows.append({"cmd": [module.__name__.split(".")[-1], *argv], "lines": lines,
                     "seconds": time.perf_counter() - t0, "ok": ok})
        log(f"[sp_train d] {' '.join(rows[-1]['cmd'])}: {rows[-1]['seconds']:.1f} s; "
            + " | ".join(lines) + f" {'ok' if ok else 'FAIL'}")
    if cards < SP_TRAIN_P:
        try:
            quiet(train_pre.main, ["--steps", "1", "--bf16", "--sp-shards", str(SP_TRAIN_P)])
            refused = None
        except ValueError as e:
            refused = str(e)
        ok = refused is not None and f"needs {SP_TRAIN_P} CUDA devices" in refused
        rows.append({"cmd": ["train_pre", "--sp-shards", str(SP_TRAIN_P)], "refused": refused,
                     "ok": ok})
        log(f"[sp_train d] {cards} card on this host: train_pre --sp-shards {SP_TRAIN_P} "
            f"refused ({refused}) {'ok' if ok else 'FAIL'}; the step over distinct cards is "
            f"skipped")
    RECORD["phases"]["sp_train_cli"] = rows
    if not all(r["ok"] for r in rows):
        fail("an SP training CLI failed on the card (phase 22d)")


def phase_sp_train(smi):
    """22: the sequence-parallel training step on the card. Returns the
    flash launches of (a)'s card steps, (b)'s eager, captured and timed
    steps (the wrappers' counts and the replays') and (c)'s steps."""
    def timed(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        RECORD["phases"][f"sp_train_{key}_s"] = time.perf_counter() - t
        log(f"[time] sp_train {key}: {RECORD['phases'][f'sp_train_{key}_s']:.1f} s")
        return result

    launches = timed("a", phase_sp_train_parity)
    launches = _merged(launches, timed("b", phase_sp_train_captured, smi))
    launches = _merged(launches, timed("c", phase_sp_train_e2e, smi))
    timed("d", phase_sp_train_cli)
    return {k: n for k, n in launches.items() if k.startswith("flash_")}


def _merged(*counts):
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


SPARSE_LINE_CASES = ("pair axial L=384", "long n=4096")  # B5's timed rows in the kernels line


def kernels_line(rows, bwd_rows, quant_rows, sparse_rows, lse_rows, lse_bwd_rows, launches,
                 dropout_rows, dropout_times):
    """One entry per kernel. Forwards: numbers summed over the serving
    path's three attention shapes at L = 384 in bf16 (one launch of each;
    B2f gated). Backwards: summed over the training path's pair-axial
    shapes at L = 128 and 256 in bf16 (B1b ungated, B2b gated; each entry
    the time of its own kernel, on its wgmma route, its
    own plain version, its own bound, and the SDPA backward for the
    gradients it produces). B4: summed over the
    served int8 request's ten dense-layer shapes at L = 384 (one launch of
    each, all on the wgmma route: the row is that route's, its launches
    the main path's wgmma-route launches; max_abs_err over every checked
    case of both bf16 routes and f32), library torch.matmul on the
    dequantized bf16 weight. B5: summed
    over the pair-axial shape at L = 384 and the long n = 4096 case
    (SPARSE_LINE_CASES; B5f on its wgmma route), each
    kernel with its own plain version, bound and SDPA yardstick (forward,
    or the backward for the gradients it produces). B3: the forward at the
    SP request's hop shape (L = 384, 4 shards), library the efficient
    attention call that returns lse; the backward kernels at the L = 128
    hop shape, each with its own plain version and bound, no library call
    (none takes an lse cotangent). Launches: from the main paths' runs
    (serving for the forwards and B4; training for the backwards, the
    wrappers' counts over phase 6b, 6c and 6e's captured steps: each
    kernel once in the warm-up and once in the capture, the replays
    launching what the capture recorded; B3's forward from the SP request,
    its backward from the ring's gradient in f32 and in bf16; phase 12b's
    5 counted e2e steps and phase 13d's 3 counted reversible ones add their
    B1f, dq and dkv launches, and so does phase 14c's bucketed CLI run
    (each bucket's warm-up and capture), phase 15a's dropout step (its
    eager steps, warm-up, capture and replays) and phase 15c's
    random-init engine (its warm-ups, captures, replays and eager
    references), and phase 16b's sparse dropout step). B5 with attention
    dropout (`<kernel>_dropout`, the same sources' Dropout<true>
    instantiations): max_abs_err over phase 16a's checks (every route, rates
    0.1 and 0.5), times from 16e at (2048, 256, 64, 0.66 active) with
    dropout 0.1 (plain: the gather version with dropout; library: SDPA with
    dropout_p 0.1), launches from 16b (its eager steps, warm-up, capture
    and replays: the dropout counts). Phase 17 adds its engines' and its
    train steps' B1f, dq and dkv launches (the wrappers' counts: warm-ups,
    captures, the eval forward; plus the engines' and its timed step's
    replays). Phase 18 adds its B1f launches: (a)'s f32 request on the
    card, (b)'s engines (warm-ups, captures, eager references, and each
    stage graph's captured launches times its own replays) and (c)'s
    executables (likewise). Phase 19 adds its B1f and B4 launches: every
    fleet replica's and bare reference engine's warm-ups and captures, and
    their replays (a drained replica's included). Phase 20 adds its B1f, B3
    and B4 launches likewise (the SP engines', the autoscaled fleets' and
    the bare references' warm-ups, captures and replays, and the eager
    references after the counts' reset: B3 in the captured SP graphs for
    the first time). Phase 21 adds its B1f launches: every engine's and
    fleet replica's warm-ups, captures and replays at depths 0, 1 and 2,
    the depth-0 references' replays included. Phase 22 adds its B1f, B1b and
    B3 launches: (a)'s card steps, (b)'s eager steps, the captured steps'
    warm-ups, captures and replays, and (c)'s SP and dense e2e steps."""
    out = []
    for name in ("flash_fwd", "flash_fwd_fused"):
        timed = [r for r in rows if r["kernel"] == name and "kernel_ms" in r
                 and "bias2d" not in r["case"]]
        checked = [r for r in rows if r["kernel"] == name]
        lib = [r["library_ms"] for r in timed]
        out.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES["flash_fwd"],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["kernel_ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            # which floor dominates the summed bound
            "bound_by": "operations" if sum(r["ops_ms"] for r in timed)
            >= sum(r["bytes_ms"] for r in timed) else "bytes",
            "library_ms": None if any(x is None for x in lib) else sum(lib),
        })
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused_dq", "flash_bwd_fused_dkv"):
        pair, side = name.rsplit("_", 1)
        timed = [r for r in bwd_rows if r["kernel"] == pair and "dq_ms" in r
                 and "bias2d" not in r["case"]]
        checked = [r for r in bwd_rows if r["kernel"] == pair]
        lib = [r[f"{side}_library_ms"] for r in timed]
        out.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES["flash_bwd"],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r[f"{side}_err"] for r in checked),
            "ms": sum(r[f"{side}_ms"] for r in timed),
            "plain_ms": sum(r[f"{side}_plain_ms"] for r in timed),
            "bound_ms": sum(r[f"{side}_bound_ms"] for r in timed),
            "bound_by": "operations" if sum(r[f"{side}_ops_ms"] for r in timed)
            >= sum(r[f"{side}_bytes_ms"] for r in timed) else "bytes",
            "library_ms": None if any(x is None for x in lib) else sum(lib),
        })
    timed = [r for r in quant_rows if "kernel_ms" in r]
    out.append({
        "name": "quant_matmul",
        "route": "cuda",
        "source": SOURCES["quant_matmul"],
        "replaces": REPLACES["quant_matmul"],
        "launches": launches["quant_matmul_wgmma"],
        "max_abs_err": max(r["max_abs_err"] for r in quant_rows),
        "ms": sum(r["kernel_ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations" if sum(r["ops_ms"] for r in timed)
        >= sum(r["bytes_ms"] for r in timed) else "bytes",
        "library_ms": sum(r["library_ms"] for r in timed),
    })
    timed = [r for r in sparse_rows if "fwd_ms" in r and r["case"] in SPARSE_LINE_CASES]
    checked = [r for r in sparse_rows if "fwd_err" in r]
    for name, kind, err in (("sparse_fwd", "fwd", "fwd_err"), ("sparse_bwd_dq", "dq", "dq_err"),
                            ("sparse_bwd_dkv", "dkv", "dkv_err")):
        lib = [r[f"{kind}_library_ms"] for r in timed]
        out.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES["sparse_attn"],
            "replaces": REPLACES[name],
            "launches": launches[name],
            # B5f: both bf16 routes' errors
            "max_abs_err": max(r[key] for r in checked for key in r
                               if key == err or (kind == "fwd" and key.endswith("_fwd_err"))),
            "ms": sum(r[f"{kind}_ms"] for r in timed),
            "plain_ms": sum(r[f"{kind}_plain_ms"] for r in timed),
            "bound_ms": sum(r[f"{kind}_bound_ms"] for r in timed),
            "bound_by": "operations" if sum(r[f"{kind}_ops_ms"] for r in timed)
            >= sum(r[f"{kind}_bytes_ms"] for r in timed) else "bytes",
            "library_ms": None if any(x is None for x in lib) else sum(lib),
        })
    for name, kind in (("sparse_fwd", "fwd"), ("sparse_bwd_dq", "dq"),
                       ("sparse_bwd_dkv", "dkv")):
        t = dropout_times
        out.append({
            "name": f"{name}_dropout",
            "route": "cuda",
            "source": SOURCES["sparse_attn"],
            "replaces": REPLACES[name],
            "launches": launches[f"{name}_dropout"],
            "max_abs_err": max(r[f"{kind}_err"] for r in dropout_rows),
            "ms": t[f"{kind}_ms"],
            "plain_ms": t[f"{kind}_plain_ms"],
            "bound_ms": t[f"{kind}_bound_ms"],
            "bound_by": "operations" if t[f"{kind}_ops_ms"] >= t[f"{kind}_bytes_ms"] else "bytes",
            "library_ms": t[f"{kind}_library_ms"],
        })
    timed = [r for r in lse_rows if "kernel_ms" in r]
    lib = [r["library_ms"] for r in timed]
    out.append({
        "name": "flash_fwd_lse",
        "route": "cuda",
        "source": SOURCES["flash_fwd"],
        "replaces": REPLACES["flash_fwd_lse"],
        "launches": launches["flash_fwd_lse"],
        "max_abs_err": max(r["max_abs_err"] for r in lse_rows),
        "ms": sum(r["kernel_ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations" if sum(r["ops_ms"] for r in timed)
        >= sum(r["bytes_ms"] for r in timed) else "bytes",
        "library_ms": None if any(x is None for x in lib) else sum(lib),
    })
    timed = [r for r in lse_bwd_rows if "dq_ms" in r]
    for name, side in (("flash_bwd_lse_dq", "dq"), ("flash_bwd_lse_dkv", "dkv")):
        out.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES["flash_bwd"],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(r[f"{side}_err"] for r in lse_bwd_rows),
            "ms": sum(r[f"{side}_ms"] for r in timed),
            "plain_ms": sum(r[f"{side}_plain_ms"] for r in timed),
            "bound_ms": sum(r[f"{side}_bound_ms"] for r in timed),
            "bound_by": "operations" if sum(r[f"{side}_ops_ms"] for r in timed)
            >= sum(r[f"{side}_bytes_ms"] for r in timed) else "bytes",
            "library_ms": None,
        })
    return out


def main():
    t0 = time.perf_counter()
    seconds = RECORD["phases"]

    def timed_phase(key, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        seconds[f"{key}_s"] = time.perf_counter() - t
        log(f"[time] {key}: {seconds[f'{key}_s']:.1f} s")
        return result

    smi = phase_card()
    phase_build()
    rows = timed_phase("kernels", phase_kernels)
    bwd_rows = timed_phase("bwd_kernels", phase_bwd_kernels)
    quant_rows = timed_phase("quant_kernels", phase_quant_kernels)
    sparse_rows = timed_phase("sparse_kernels", phase_sparse_kernels)
    lse_rows, lse_bwd_rows = timed_phase("lse_kernels", phase_lse_kernels)
    launches = timed_phase("main", phase_main)
    timed_phase("engine", phase_engine)
    launches.update(timed_phase("train", phase_train))
    launches.update(timed_phase("sp", phase_sp))
    timed_phase("ckpt", phase_ckpt)
    timed_phase("templates", phase_templates)
    timed_phase("full_atom", phase_full_atom)
    for name, n in timed_phase("e2e_train", phase_e2e_train).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("reversible", phase_reversible).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("relax_segmented_buckets", phase_relax_segmented_buckets).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("dropout_random_init", phase_dropout_random_init).items():
        launches[name] = launches.get(name, 0) + n
    dropout_rows, dropout_launches, dropout_times = timed_phase("sparse_dropout",
                                                                phase_sparse_dropout)
    for name, n in dropout_launches.items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("telemetry", phase_telemetry, smi).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("early_exit", phase_early_exit).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("fleet", phase_fleet, smi).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("sp_serving", phase_sp_serving, smi).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("pipeline", phase_pipeline, smi).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed_phase("sp_train", phase_sp_train, smi).items():
        launches[name] = launches.get(name, 0) + n
    kernels = kernels_line(rows, bwd_rows, quant_rows, sparse_rows, lse_rows, lse_bwd_rows,
                           launches, dropout_rows, dropout_times)
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on the main path")
    RECORD["kernels_line"] = kernels
    RECORD["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(f"[done] {RECORD['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
