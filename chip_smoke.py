#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each fatal on failure (non-zero exit):

1. setup: card name and power limit, torch/CUDA versions, TF32 off, the
   kernels built from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel) with their ``-Xptxas -v`` lines and each library's
   SASS counts of HMMA (bf16 tensor cores), FFMA and LDGSTS (cp.async),
   then each kernel's launch at the main path's and the trainer's shapes:
   resident CTAs, grid, dynamic shared memory and work items (the dgrad's
   reader-list chunks; K3's three launches and its emission's batch
   chunks; K6's grid per factor);
2. every CUDA kernel against its plain PyTorch version on the card: the
   fused chain (K1) on ragged chains with J ∈ {1,2,3,4}, block 16 and 128,
   and a batch that is no multiple of the tile, then on a grid of blocks
   8 to 128 (24: no power of two; 100: no multiple of the MMA depth), J up
   to 6 and B ∈ {1, 37, 4096}, with K4 on the same grid; the single factor (K6)
   with bk ≠ bn; the quantized chain (K4) on the same chains for int8,
   fp8 e4m3 and fp8 e5m2 codes with per-block and per-row scales, every
   batch tile, f32 and bf16 activations; the chain dgrad (K2, K5-dgrad on
   the three code types, per-block and per-row) on K1's grid, every tile at
   B = 37, on chains with a skewed fan-in and with unread input blocks, and
   twice on each chain (bitwise-equal dx); the wgrad (K3, K5-wgrad: dvalues,
   dscales) on ragged chains, blocks 16 and 128, J ≤ 4, then on K1's grid
   with the dgrad's skewed and unread chains, every launch twice (bitwise-
   equal dvalues); K6 on random factors of the up-projection's layout at
   B = 128 and 4096, every tile; f32 within 1e-5·max|y|, bf16 within
   3e-2·max|y|;
3. the main path at full width: gemma-2b's MLP up-projection
   ``W (2048, 16384)`` (d_model 2048, d_ff 16384) from a seed, factorized on
   the card into J = 3 block-sparse factors (block 128, k 4), then
   ``apply("auto" | "fused" | "bsr")`` at B = 128 and 4096, each checked
   against the plain version and against ``x @ op.todense()``; the kernel
   launch counters are zeroed before and read after, and must have risen;
4. the quantized path: that chain through ``quantize_chain`` (int8
   per-block and per-row, fp8 e4m3, fp8 e5m2), ``weight_bytes`` against
   the f32 chain's, ΔRE = RE(quantized) − RE(f32) against W within the
   reference's thresholds, and ``apply("fused" | "bsr" | "dense" |
   "auto")`` at B = 128 and 4096 in f32 and bf16, each checked against the
   plain version and ``x @ op.todense()``; counters zeroed before, read
   after; then K4 with bf16 x on each form against its plain version,
   beside K1 bf16 and the plain version itself with each factor's slots
   summed in reverse (K4 within 1.25× the larger of the two), on that
   chain and on a block-16 chain (2048 → 2048 → 16384, k 4);
5. measured dispatch: a fresh table under ``build/``, filled by
   ``apply(autotune=True)`` for the f32 and the int8 operator at both
   batches; ``auto`` must then report ``source == "measured"``, pick the
   fastest measured backend and run the fused tile the table holds;
6. training applies at full width (slice 3): the f32 operator (gradient
   wrt x and the values) and the int8 one (wrt x and the scales), f32 and
   bf16, B = 128 and 4096, fwd+bwd through ``fused`` (K1+K2+K3,
   K4+K5), ``bsr`` and ``dense``, held against the plain versions and
   autograd of ``x @ op.todense()``, with fwd and fwd+bwd times and
   ``apply("auto")``'s report under grad; counters zeroed before, read
   after, K2/K3/K5 required;
7. the trainer: ``repro_torch.launch.train --arch gemma_2b --faust
   --steps 3 --batch 8 --seq 128`` (full width and depth, bf16, remat,
   FAµST unembedding) on a fresh autotune table; loss, step time and
   tokens/s per step, peak memory, the captured FAµST dispatch and the batch
   tile each fused kernel ran at; finite losses and K2/K3 launches required,
   K2 at ``DGRAD_BT`` and K3 at ``WGRAD_BT``; then one more step under
   ``torch.profiler``: device busy time and idle share, device time by
   kernel family (K1/K4, K2, K3 and its three launches, dense matmul,
   elementwise, other);
8. the batched factorizer at workload scale: gemma-2b's 18 MLP
   up-projections as one stack ``(18, 2048, 16384)`` f32 through
   ``factorize`` (slice 1's spec, one solve per step for the stack):
   seconds, each matrix's RE, peak memory; matrices 0 and 17 again through
   the sequential route (RE within 1e-3); each of the 18 operators through
   ``apply("fused")`` against ``x @ todense()``, 18 K1 launches;
9. the other strategies: ``"meg"`` on a 204 × 8193 synthetic gain matrix
   (J = 4, k = 10, s = 816), ``"dictionary"`` on 10,000 8×8 patches of a
   noisy 512 × 512 image (a 64 × 128 MOD dictionary, J = 4, k = 4), flat
   ``"palm4msa"`` on an up-projection (also packed and applied fused):
   RE, seconds, every feasible backend against ``todense()``;
10. composition: ``hstack``, ``block_diag``, ``vstack`` of two
   up-projections and ``op.T @ op``, B = 128 and 4096, f32 and bf16,
   against the dense product; K1 and K6 launches required;
11. measured dispatch under grad: a fresh table filled by
   ``apply(autotune=True)`` in training applies (f32 and int8 operators,
   f32 and bf16 x, both batches); ``auto`` under grad must read it, pick
   the fastest measured backend and run within 10 % of it forced, at the
   table's fused tile and at the default one, whichever is faster;
12. times (CUDA events, warm-up, then 20 launches; 5 for the wgrads) of
   each kernel, its plain version and one PyTorch call computing the same
   function (``torch.matmul`` on the materialized matrix; none for the
   wgrad), beside the card's bound, the cost of an empty launch, and
   ``apply("auto")`` with the model alone and with the table beside the
   forced backend it picks; every kernel also with a cold L2 (a 256 MB
   buffer written between launches); the batch-tile sweeps of K1, K6, K2
   and K3 in f32 and bf16; K1, K2 and K3 also at the trainer's shapes (the
   FAµST unembedding, bf16, B = 1024);
13. serving and streaming refresh (slice 8) at gemma-2b's full width, its
   depth cut to ``SERVE_LAYERS`` = 4 of 18 layers (the engine's ragged
   replays are most of this phase's time), with the trainer's FAµST
   unembedding: (a) ``Engine`` +
   ``LMExecutor`` (8 slots of 1088 tokens, bf16) on 24 requests (prompts
   uniform over 32–1000 from numpy seed 0, two fixed at 512 and 700;
   budgets 16–64; 12 at the start, 4 more every 10 steps; one live
   request evicted at step 20): prefill and decode seconds, tokens/s,
   TTFT and TPOT at p50/p90, occupancy, ``backend_counts()``, peak memory,
   K1/K6 counts (zeroed before, must rise), every request ``done`` with
   no retry, failure, quarantine, timeout or rejection, and the
   teacher-forced check (``forward_train`` over prompt + generated with
   every FAµST projection on the dense backend, so no kernel runs on that
   side: the chosen token within 3e-2·max|logits| of each row's maximum);
   tokens/s over the run's wall time (decode-only beside it); one steady
   decode step at B = 8 under ``torch.profiler`` beside the weight-bytes
   bound; (b) the same engine in f32 (8 requests, prompts ≤ 256, 16
   tokens; teacher-forced within 1e-4; the f32 head's K1 and K6 against
   their plain versions at B ∈ {1, 3, 8}); (c) the head at B ∈ {1, 3, 8}: K1
   and K6 against their plain versions, ``apply`` on every backend and
   ``auto``, the bound and ``torch.matmul`` on the dense head; the engine
   with the head forced to fused, bsr and dense (TPOT each, the first
   decode step's logits against dense within 3e-2); (d) compressed MLPs
   (slice 15): the f32 model from seed 0 with its 12 MLP weights
   compressed on the card by ``compress_model`` (block 128, J = 2, k 4,
   ``STREAM_SWEEPS`` sweeps; one bucket of the 8 2048 × 16384 ``w_up``/
   ``w_gate``, one of the 4 ``w_down``): seconds, seconds a matrix, peak
   memory, each matrix's RE against its dense weight, ``s_tot`` and RCG;
   ``layers.0.mlp.w_down`` compressed again alone (RE within the batched −
   sequential limit 1e-3); the chains installed by
   ``FaustLinear.from_blockfaust`` into that f32 model and its bf16 copy
   (each layer's factors and ``todense()`` equal to its chain's, no dense
   MLP key left); the bf16 model served (8 requests, prompts ≤ 256, 32
   tokens, seed 4), every request ``done``, K1 launches required, every
   served token within 3e-2·max|logits| of the f32 compressed copy's
   maximum, K1/K6 launches per step, TPOT, layer 0's ``w_up``/``w_gate``/
   ``w_down`` chains through K1 and K6 against their plain versions at B
   = 1, 8 and the trace's longest prompt (its prefill rows);
   (e) streaming into (a)'s live engine: ``StreamingFaust.track`` of the
   head's f32 ``todense()`` (2048 × 256000) at 10/10 sweeps (the
   reference's defaults are 40/40), the tracked chain published, a 1 %
   Gaussian drift, ``update``, ``hot_swap(guard=0.5)`` of the refresh
   between two steps while requests are live (accepted), four requests
   after it (teacher-forced against the swapped model), a regressed chain
   rejected (``swap_rejects == 1``), and ``quantized_swap`` of the refresh
   into an int8 chain applied by K4 at B ∈ {1, 8} against its plain
   version;
14. the rest of training (slice 9) through ``repro_torch.launch.train``'s
   path at gemma-2b's full width (``--faust --batch 8 --seq 128``, bf16,
   FAµST unembedding), on a fresh read-only autotune table: (a) 18
   layers, ``--compress-grads 0.01``, 4 steps: loss, step time, the EF
   residual's norm and tokens/s per step, peak memory, a profiled step's
   idle share, K2/K3 launches, one more step with
   ``set_sync_debug_mode("error")`` around the compression and the guarded
   update (the whole step under ``"warn"``, its warnings counted), then
   the top-k selection at the embedding's size against the stable sort
   and ``torch.topk``; (b) 2 layers with EF (a state of about 10 GB; the
   free disk checked first): 4 steps uninterrupted, then
   ``checkpoint_every=2`` with SIGTERM raised in-process after step 2, then
   a fresh trainer resuming for steps 2-3: losses within 1e-6 relative,
   every restored tensor bit for bit the saved one, bytes and seconds of
   the save (snapshot, hash, write) and the restore, the directory removed
   after; (c) 18 layers, 4 steps, ``recompress_every=2`` on the
   reference's default targets and spec: each tick's action, RE, sweeps
   and seconds, K1 launches, the record on the heartbeat; (d)
   ``launch.calibrate`` into a temporary ``REPRO_TORCH_ROOFLINE``: each
   constant beside the data sheet's (within 0.3-1.1×, the launch time and
   the builtin link rate excepted), a dispatch priced by it, the builtin
   constants restored;
15. the partial-rotary, sliding-window and MoE architectures (slice 10)
   at their published widths, bf16, each with the trainer's FAµST
   unembedding (``--faust``: 2 factors, block 16, k 4, untied), on a
   fresh read-only autotune table; every run's parameter sizes (all but
   the norms') equal to ``stored_param_count`` of its config, K1/K2/K3
   (and K6) counts zeroed before each run and required, the head's K1
   and K6 against their plain versions at B = 1, 8 and the longest
   prompt's rows, each trained head's K2 and K3 against theirs at the
   trainer's B·S rows: (a) gemma3-27b cut to one stage unit (five local layers, one
   global), ``launch.train --faust --steps 3 --batch 1 --seq 2048`` (the
   local layers run banded: window 1024 < 2048), then served (8 slots of
   2112 tokens; prompts 64, 200, 512, 1024, 1536, 2048, budgets 16-48:
   banded prefills, ring caches that wrap); (b) granite-moe-3b,
   ``launch.train --faust --steps 3 --batch 8 --seq 128`` cut to
   ``GRANITE_TRAIN_LAYERS`` = 8 of its 32 layers at the
   published capacity factor 1.25 (cross entropy and aux loss of the
   trained model; the MoE layers' share of the step's device time,
   estimated from one layer's timed forward and backward), then served
   at full depth (8 requests, prompts 32-512) drop-free at capacity
   factor E/k = 5 with the teacher-forced check, and again at 1.25 with its prefills' drop
   share and the tokens it shares with the drop-free run; (c)
   llama4-maverick cut to one MoE layer (34.7 GB), drop-free: prefill of
   256 tokens and a decode step at B = 1 and 8 beside two bounds (every
   expert's weights, and only the experts its tokens reach), then 4
   requests; (d) chatglm3-6b and nemotron-4-15b at full depth, served (8
   requests, prompts 32-512).  Every serving run: every request ``done``,
   TTFT/TPOT, tokens/s, peak memory, the teacher-forced check within
   3e-2·max|logits| (for MoE on the served run's expert choices, each
   one that differs from the reference's own a near-tie: its f32 router
   probability within ``ROUTE_TIE_TOL`` of the reference's k-th);
16. the mamba2 (SSD) and zamba2 (shared block) architectures (slice 11)
   at their published widths, bf16, the same FAµST unembedding untied, on
   a fresh read-only autotune table, with the same counts, parameter and
   kernel checks as phase 15: (a) mamba2-2.7b cut to
   ``MAMBA2_TRAIN_LAYERS`` = 16 of its 64 layers,
   ``launch.train --faust --steps 3 --batch 4 --seq 1024`` (four SSD chunks
   a sequence: the inter-chunk loop runs); (b) zamba2-7b cut to two whole
   units of five ssm layers and the shared block (12 layers: the full
   5.74 G's AdamW state does not fit), same flags;
   (c) both served, cut to ``MAMBA2_SERVE_LAYERS`` = 16 of mamba2's 64
   layers and ``ZAMBA2_SERVE_LAYERS`` = 18 of zamba2's 81 (three units;
   ``ssm_serve_probe.py`` runs them at both depths), 8 slots of
   1160 tokens, 10 requests: prompts 300, 200, 256, 480, 512, 700, 1024 and
   three uniform over 32-256, budgets 16-48, one eviction at step 6 (of
   the 300-token request: its re-prefill is ragged and replays too); each prefill's split recorded (the prefix every
   chunked path takes, ``lm.prefill_length``: 300 and 480 are the band
   the reference's SSD rejects); the teacher-forced check against an f32
   copy of the model (attention and the SSD each over the whole sequence
   as one chunk): each served token within 3e-2·max|logits| of the f32
   row's maximum, or a tie at bf16's resolution (its gap at most twice the
   bf16 model's own one-pass error on that row, such ties at most 5 % of
   the positions: over 64-81 random layers bf16 rounding alone moves the
   logits by several 1e-2); zamba2's pool one ``MambaCache`` an ssm layer
   and one ``KVCache`` a shared position (15 and 3); two faults planted in zamba2's
   serving path (every mamba state zeroed after each prefill; each shared
   occurrence decoding against the next one's ``KVCache``), two requests
   each (prompts 256 and 512, 32 tokens), which that bf16 check must fail; (d) both
   f32 copies served (2 requests, prompts 300 and 1024, an eviction)
   and held
   teacher-forced within 1e-4: the aligned prefill, the replays, the
   recurrent decode and the re-prefill against one chunked pass; (e) a
   mamba2 decode step at B = 1 and 8 after 256-token prefills: host
   seconds, launches, busy time and idle share beside the bound of the
   weights read once and the state read and written;
17. the modality front ends (slice 12) at their published widths and full
   depth (musicgen's trainer cut), bf16, the same FAµST unembedding
   untied, on a fresh read-only autotune table, with phase 15's counts,
   parameter and kernel checks:
   (a) internvl2-2b (24 layers), ``launch.train --faust --steps 3 --batch
   4 --seq 1024`` (two attention chunks and 256 image positions a row,
   ``vision_embeds`` from the data pipeline), K1, K2 and K3 each launched
   exactly once a step; (b) musicgen-medium cut to
   ``MUSICGEN_TRAIN_LAYERS`` = 12 of its 48 layers (full depth until PR
   27), ``--batch 8 --seq 1024`` (tokens ``(8, 4, 1024)``), each launched four times a step, once
   per codebook's head, every head's K2 and K3 against their plain
   versions at the trainer's 8192 rows; (c) both served, 8 slots of 1088
   tokens, 8 requests, budgets 16-32, one eviction at step 4: internvl2's
   prompts 256, 300, 512, 600, 1024 and three over 256-512, each request
   with its own ``vision_embeds`` from numpy; musicgen's ``(4, S)`` with S
   64, 128, 256, 512, 600, 1024 and two over 32-512; only the 600-token
   prompts replay, every prefix holds the image positions; every request
   ``done``; the teacher-forced check against each model's f32 copy with
   the same ``vision_embeds``, phase 16's tie clause applied to every
   codebook on its own; two faults planted, two requests each (prompts
   256 and 512, 32 tokens), which that check must fail: internvl2 prefilled
   as a text model (``vision_embeds`` unread), musicgen's decode sinusoid
   at position 0 instead of each row's own; (d) every head's K1 and K6
   against their plain versions at B = 1, 8 and the trainer's rows;
18. the FAµST operator on a mesh (slice 13): (d) a 1 × 1 mesh over NCCL
   (world size 1) in this process, the up-projection's sharded apply
   beside its fused apply (f32 and bf16, B = 128 and 4096, medians of
   alternating calls; K1 against the plain version, one output gather a
   call); then four ranks spawned on this card, a 2 × 2 ``("data",
   "model")`` mesh over ``gloo`` (CUDA collectives staged through host
   memory; the kernels built before any rank starts), each rank: (a) the
   up-projection factorized with ``FactorizeSpec(mesh=)`` (rank 0 solves;
   every rank's chain digest equal), the sharded apply against the
   single-card fused apply, forward and fwd+bwd (``dx``, ``dvalues``), f32
   and bf16, B = 128 and 4096, one K1 a segment a rank, one K2 and one K3
   a segment backward, boundary gathers only at crossings; its int8 form
   (K4, K5; ``dscales``); a local-support chain (one K1, no boundary
   gather, ``collective_bytes`` 0), a chain of 127 out-blocks (replicated,
   one K1), a chain that does not pack (replicated, K6 per factor); the
   report under ``auto``; (b) gemma-2b's FAµST head (2048 → 2048 → 256000,
   block 16, k 4, bf16) as a ``FaustLinear`` with ``shard``: each segment's
   K1 at B = 1 and 8 and K2/K3 at 1024 rows at the rank's plan against the
   plain versions, the sharded head against the unsharded one; (c) gemma-2b
   at full width, ``SERVE_LAYERS`` deep, split by ``LM.shard_`` and served
   under its decode policy (slice 16: the pool's rows over data, each
   cache's positions over model, every module's weights gathered just
   before it runs, the embedding table read in place), with that head
   sharded (forced onto ``fused_sharded``): ``Engine`` +
   ``LMExecutor(mesh=)`` over 4 slots on 4 requests (a 509-token prompt
   evicted at step 4, its re-prefill replaying across the positions'
   split, and three over 32–256 from numpy seed 0; budgets 4–8), every
   request ``done``, each rank's pool bytes (a quarter of the
   global-attention K/V), the bytes each decode step moves, and
   ``Server(mesh=)``; two planted faults on two requests each: each
   crossing reading only the rank's block (no all-gather), and each rank
   attending over its own block of the positions (the merge skipped);
   every rank's tokens equal; on rank 0, after every collective and on a
   whole copy of the model, the teacher-forced check (within 3e-2) and
   the unsharded engine's tokens, which the sound run must match and
   each planted run must fail (the skipped merge: either); (e), after
   (d) on the same 1 × 1 NCCL mesh: gemma-2b at full width,
   ``SERVE_LAYERS`` deep, split by ``LM.shard_`` and served on phase 13
   (d)'s trace beside the unsharded engine on it: the same tokens, TTFT,
   TPOT and peak memory, K1 launched, no collective.  No time of the
   four ranks is a multi-GPU number: they share one card;
19. the language model trained on a mesh (slice 14): (a) a 1 × 1 NCCL mesh
   in this process: gemma-2b at full width cut to ``MT_NCCL_LAYERS`` = 4
   of its 18 layers through ``Trainer(mesh=)``
   with ``launch.train``'s ``--faust --steps 3 --batch 8 --seq 128``
   (bf16, remat, the head forced onto ``fused``), beside the unsharded
   ``Trainer`` on the same seed: the losses, step times, peak memory,
   K1/K2/K3 a step (one each), collective calls by purpose; a sharded save
   at step 2 restored into an unsharded ``Trainer`` that runs step 3 to
   the mesh's loss; (b) four ranks spawned on this card over
   ``gloo``, a 2 × 2 ``("data", "model")`` mesh, gemma-2b at full width cut
   to ``MT_LAYERS`` layers under its ``CP_POLICY`` (rows over data, the
   sequence over model): the state bytes a rank holds (about a quarter of
   the whole); ``MT_STEPS`` steps with SIGTERM to rank 2 after step 1
   (every rank saves step 1 and stops), the losses equal on every rank and within
   ``MT_TOL`` of the unsharded trainer's (losses and gradient norms), run
   in this process; that
   checkpoint resumed on a 4 × 1 mesh and in this process unsharded, each
   to the uninterrupted run's step-2 loss; one step in f32 within
   ``MT_TOL`` of unsharded (the loss check holds the losses and the
   gradient norms); a planted fault (keys and values not gathered over the
   sequence, f32) that must fail it; (c) ``pipeline_apply`` on pod 4
   × data 1 of those ranks (d 16, b 24, 6 microbatches) against the
   sequential oracle, and its backward (the loss ``Σ y · gy``): every
   rank's ``dx`` and its stage's parameter gradients within rtol 2e-4 /
   atol 2e-5 of the sequential walk's under autograd on one rank, the
   other stages' rows zero.  The ranks start once (a)'s mesh run is over, and
   run beside (a)'s restore and (b)'s unsharded runs in this process;
20. the report (slice 17): (a) ``launch.dryrun`` of gemma-2b × train_4k,
   prefill_32k and decode_32k on the 16 × 16 mesh and of its ``faust``
   variant × train_4k, four processes on the CPU (fake tensors, no card)
   beside (b)-(d): each record's roofline terms at the H100 constants,
   its peak GB a rank and its seconds; (b) the dry run of phase 19 (a)'s
   configuration (4 layers, 8 × 128, bf16, the head forced fused) on a
   1 × 1 mesh (like (c)'s, in a CPU process of its own beside the card
   work), logged before the real step, then one step of that model
   on a 1 × 1 NCCL mesh: ``FlopCounterMode``'s flops must equal the
   predicted matmul flops, K1/K2/K3 the predicted launches (one each),
   ``max_memory_allocated`` within ``REPORT_MEM_TOL`` = 10 % of the
   predicted peak; (c) the dry run of phase 19 (b)'s configuration on
   each rank of a fake 2 × 2 mesh: its collectives by purpose (calls and
   bytes, ``distributed/layout.py``) must equal what each of phase 19
   (b)'s ranks counted in its first step; (d) a planted fault, the
   kernels' flop formulas removed, must fail (b)'s flop check.

Prints one JSON object per line; the last three lines are the kernels
summary, the card's ``name, power.limit`` and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TABLE = ROOT / "build" / "chip_smoke_autotune.json"  # this run's own measured table
HBM_BW = 3.35e12  # B/s, H100 SXM data sheet
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # FLOP/s: FFMA f32, dense bf16 tensor cores
TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # max|kernel − plain| / max|plain|
# a served MoE expert choice the reference did not make: its f32 router
# probability at most this far (relative) below the reference's k-th (a
# near-tie; granite-moe-3b's 32 bf16 layers read at most 0.043 on an H100,
# experts shifted by one read 0.98)
ROUTE_TIE_TOL = 0.1
DENSE_TOL = 1e-4  # vs x @ todense(): another association order of the same f32 products
# ΔRE = RE(quantized) − RE(f32) bounds: the reference's thresholds
# (benchmarks/quantized_re.py THRESHOLDS)
DRE_MAX = {"int8": 8e-3, "fp8_e4m3": 1e-1, "fp8_e5m2": 1.5e-1}
QUANTS = (("int8", "per_block"), ("int8", "per_row"), ("fp8_e4m3", "per_block"),
          ("fp8_e5m2", "per_block"))
AUTO_SLACK = 1.10  # a table-steered auto apply within 10 % of its forced backend
ITERS = 20


def log(obj) -> None:
    if _ROWS is not None:  # a phase-18 rank: the parent prints them
        _ROWS.append(obj)
        return
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(y, ref) -> tuple[float, float]:
    """(max |y − ref|, that over max |ref|)."""
    err = float((y.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def time_ms(fn, iters: int = ITERS) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(fns: dict, rounds: int) -> dict:
    """Per-call times (ms) of each of ``fns``, called in turn one call at
    a time (the order rotated each round), ``rounds`` calls each: one CUDA
    event between consecutive calls, read after a single synchronize.  A
    host-paced call varies with the host's load; calls this close in time
    see the same load, so the variants' medians compare the calls and not
    the moments they ran in."""
    import torch

    names = list(fns)
    for _ in range(3):
        for k in names:
            fns[k]()
    torch.cuda.synchronize()
    order, events = [], [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    for r in range(rounds):
        for k in names[r % len(names):] + names[:r % len(names)]:
            fns[k]()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            order.append(k)
            events.append(ev)
    events[-1].synchronize()
    out = {k: [] for k in names}
    for k, a, b in zip(order, events, events[1:]):
        out[k].append(a.elapsed_time(b))
    return out


def time_ms_cold(fn, iters: int = 10) -> float:
    """Mean time of ``fn`` with the 50 MB L2 flushed before each launch:
    a 256 MB buffer is written between launches, outside the timed span."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def _plan(dims, blk, k):
    """The ChainPlan of a chain over ``dims`` at block ``blk`` with ``k``
    input blocks per output block (an int, or one per factor)."""
    from repro_torch.core.compress import ChainPlan

    ib = tuple(-(-d // blk) for d in dims[:-1])
    ob = tuple(-(-d // blk) for d in dims[1:])
    kb = tuple(min(k, i) for i in ib) if isinstance(k, int) else tuple(k)
    offs = [0]
    for o, kk in zip(ob, kb):
        offs.append(offs[-1] + o * kk)
    return ChainPlan(blk, ib, ob, kb, tuple(offs), tuple(dims[:-1]), tuple(dims[1:]))


# the gemma-2b up-projection as factorized on the card (F_1 16x6, F_2 16x4,
# F_3 128x4 out blocks x slots) and the trainer's FAµST unembedding
UP_PROJ = ((2048, 2048, 2048, 16384), 128, (6, 4, 4))
UNEMBED = ((2048, 2048, 256000), 16, 4)


def launch_configs(card_line: str) -> list[dict]:
    """Each kernel's launch at the main path's and the trainer's shapes, at
    its default tile: resident CTAs, grid, shared memory, items (the dgrad's
    reader-list chunks, the wgrad's three launches and its emission's batch
    chunks) per factor; K6's grid per factor of the up-projection."""
    import torch

    from repro_torch.kernels import bsr_matmul, chain_bwd
    from repro_torch.kernels.chain import DGRAD_BT, FORWARD_BT, WGRAD_BT, chain_schedule, launch_config

    rows = []
    cases = [("up-projection", UP_PROJ, b, dt, q) for b in (128, 4096)
             for dt in (torch.float32, torch.bfloat16) for q in (None, torch.int8)]
    cases.append(("unembedding", UNEMBED, 1024, torch.bfloat16, None))
    for name, layout, b, dtype, qdtype in cases:
        plan = _plan(*layout)
        sched = chain_schedule(plan, b, FORWARD_BT)
        cfg = launch_config(dtype, plan.block, FORWARD_BT, qdtype)
        row = {"phase": "launch_config", "card": card_line, "chain": name,
               "kernel": "chain_matmul" if qdtype is None else "chain_matmul_q",
               "dtype": str(dtype).removeprefix("torch."), "batch": b, "bt": FORWARD_BT,
               "block": plan.block, "blkp": sched.blkp, "group": sched.group, "ctas": cfg["ctas"],
               "grid": min(cfg["ctas"], max(sched.items)), "smem_bytes": cfg["smem_bytes"],
               "items_per_factor": list(sched.items), "barriers": plan.n_factors - 1}
        log(row)
        rows.append(row)
        # the dgrad walks the factors in reverse; a split factor adds a barrier
        cfg = chain_bwd.launch_config(dtype, plan.block, DGRAD_BT, qdtype)
        dsched = chain_bwd.dgrad_schedule(plan, b, DGRAD_BT, cfg["ctas"])
        chunks = [f[3] for f in dsched.factors]
        row = {"phase": "launch_config", "card": card_line, "chain": name,
               "kernel": "chain_dgrad" if qdtype is None else "chain_dgrad_q",
               "dtype": str(dtype).removeprefix("torch."), "batch": b, "bt": DGRAD_BT,
               "block": plan.block, "blkp": dsched.blkp, "group": dsched.group, "ctas": cfg["ctas"],
               "grid": min(cfg["ctas"], max(dsched.items)), "smem_bytes": cfg["smem_bytes"],
               "items_per_factor": list(dsched.items), "chunks_per_factor": chunks,
               "barriers": plan.n_factors - 1 + sum(c > 1 for c in chunks) + (qdtype is not None)}
        log(row)
        rows.append(row)
        # the wgrad: the recompute (factors 1..J-1) and the walk (J..2) are
        # cooperative, the emission one CTA an item
        cfg = chain_bwd.wgrad_launch_config(dtype, plan.block, WGRAD_BT, qdtype)
        ctas = tuple(cfg[k]["ctas"] for k in ("recompute", "walk", "emit"))
        wsched = chain_bwd.wgrad_schedule(plan, b, WGRAD_BT, chain_bwd.EMIT_ROWS[dtype], ctas)
        row = {"phase": "launch_config", "card": card_line, "chain": name,
               "kernel": "chain_wgrad" if qdtype is None else "chain_wgrad_q",
               "dtype": str(dtype).removeprefix("torch."), "batch": b, "bt": WGRAD_BT, "block": plan.block,
               "blkp": wsched.blkp, "group": wsched.group, "launches": cfg,
               "grid": {"recompute": min(ctas[0], max(wsched.fwd_items, default=1)),
                        "walk": min(ctas[1], wsched.walk_items), "emit": sum(wsched.emit_items)},
               "recompute_items_per_factor": list(wsched.fwd_items),
               "walk_items_per_factor": list(wsched.walk.items[1:]),
               "walk_chunks_per_factor": [f[3] for f in wsched.walk.factors[1:]],
               "emit_items_per_factor": list(wsched.emit_items), "emit_chunks": wsched.chunks,
               "emit_chunk_rows": wsched.chunk_rows}
        log(row)
        rows.append(row)
    plan = _plan(*UP_PROJ)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = bsr_matmul.launch_config(dtype, bsr_matmul.BSR_BT)
        for b in (128, 4096):
            row = {"phase": "launch_config", "card": card_line, "chain": "up-projection", "kernel": "bsr_matmul",
                   "dtype": str(dtype).removeprefix("torch."), "batch": b, "bt": bsr_matmul.BSR_BT, **cfg,
                   "grid_per_factor": [[-(-b // bsr_matmul.BSR_BT), o * -(-plan.block // 128)]
                                       for o in plan.out_blocks]}
            log(row)
            rows.append(row)
    return rows


def sass_counts(lib) -> dict | None:
    """Tensor-core (HMMA), FFMA and cp.async (LDGSTS) instructions in a
    built kernel library's SASS, by ``cuobjdump -sass``; None without the
    tool."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True, timeout=300).stdout
    return {op: sass.count(op) for op in ("HMMA", "FFMA", "LDGSTS")}


def setup() -> dict:
    import torch

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in text.splitlines() if "Used" in ln or "Compiling entry" in ln]
        for name, text in logs.items()
    }
    info = {
        "phase": "setup",
        "sass": sass_counts(build.library_path("chain_matmul")),
        "sass_dgrad": sass_counts(build.library_path("chain_dgrad")),
        "sass_wgrad": sass_counts(build.library_path("chain_wgrad")),
        "sass_bsr": sass_counts(build.library_path("bsr_matmul")),
        "card": card(),
        "device_name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "build_s": build_s,
        "ptxas": ptxas,
    }
    log(info)
    return info


def _random_chain(dims, blk, k, seed, dev):
    import torch

    from repro_torch.core.compress import BlockFaust, random_block_factor

    g = torch.Generator().manual_seed(seed)
    factors = tuple(
        random_block_factor(dims[j], dims[j + 1], blk, blk, k, generator=g, device=dev)
        for j in range(len(dims) - 1)
    )
    return BlockFaust(factors, torch.ones((), device=dev)), g


def check_kernels(dev) -> list[dict]:
    """Phase 2: each kernel against its plain version on the same inputs."""
    import torch

    from repro_torch.core.compress import pack_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.chain import SUPPORTED_BT, chain_matmul, chain_matmul_plain
    from repro_torch.kernels.ops import chain_meta

    rows = []
    dims_by_blk = {16: (40, 72, 56, 90, 33), 128: (200, 300, 260, 330, 150)}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for blk, dims in dims_by_blk.items():
            for n_factors in (1, 2, 3, 4):
                for bt in (SUPPORTED_BT if n_factors == 3 else (32,)):
                    bf, g = _random_chain(dims[: n_factors + 1], blk, 3, 7 * n_factors + blk, dev)
                    pc = pack_chain(bf).to(dtype=dtype)
                    plan = pc.plan
                    x = torch.randn((37, dims[0]), generator=g)
                    x = torch.nn.functional.pad(x, (0, plan.in_blocks[0] * blk - dims[0]))
                    x = x.to(dev, dtype)
                    meta = chain_meta(plan, pc.in_idx)
                    yk = chain_matmul(x, pc.values, meta, plan=plan, bt=bt)
                    yp = chain_matmul_plain(x, pc.values, meta, plan=plan)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err, rel = rel_err(yk, yp)
                    row = {"phase": "kernel_check", "kernel": "chain_matmul", "dtype": dname,
                           "J": n_factors, "block": blk, "dims": list(dims[: n_factors + 1]),
                           "batch": 37, "bt": bt, "max_abs_err": err, "rel_err": rel,
                           "tol": TOL[dname]}
                    log(row)
                    require(rel <= TOL[dname], f"chain_matmul disagrees with its plain version: {row}")
                    rows.append(row)
        for batch, (o, k, bk, bn, n_in) in zip(
            (37, 130, 5), ((6, 3, 64, 128, 9), (4, 2, 128, 96, 3), (3, 2, 32, 160, 5))
        ):
            g = torch.Generator().manual_seed(batch)
            idx = torch.stack([torch.randperm(n_in, generator=g)[:k] for _ in range(o)])
            idx = torch.sort(idx, dim=1).values.to(torch.int32).to(dev)
            values = (torch.randn((o, k, bk, bn), generator=g) / math.sqrt(k * bk)).to(dev, dtype)
            x = torch.randn((batch, n_in * bk), generator=g).to(dev, dtype)
            yp = bsr_matmul_plain(x, values, idx)
            for bt in SUPPORTED_BT:
                yk = bsr_matmul(x, values, idx, bt=bt)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                err, rel = rel_err(yk, yp)
                row = {"phase": "kernel_check", "kernel": "bsr_matmul", "dtype": dname,
                       "values_shape": [o, k, bk, bn], "batch": batch, "bt": bt,
                       "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                log(row)
                require(rel <= TOL[dname], f"bsr_matmul disagrees with its plain version: {row}")
                rows.append(row)
    return rows


def check_quantized_kernel(dev) -> list[dict]:
    """Phase 2, K4: the quantized chain kernel against its plain version on
    the chains K1 is checked on, for every code type and scale scheme."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import SUPPORTED_BT, chain_matmul, chain_matmul_q_plain
    from repro_torch.kernels.ops import chain_meta

    rows = []
    dims_by_blk = {16: (40, 72, 56, 90, 33), 128: (200, 300, 260, 330, 150)}
    for blk, dims in dims_by_blk.items():
        for n_factors in (1, 2, 3, 4):
            bf, g = _random_chain(dims[: n_factors + 1], blk, 3, 7 * n_factors + blk, dev)
            pc = pack_chain(bf)
            plan = pc.plan
            x0 = torch.randn((37, dims[0]), generator=g)
            x0 = torch.nn.functional.pad(x0, (0, plan.in_blocks[0] * blk - dims[0]))
            meta = chain_meta(plan, pc.in_idx)
            for qdtype, scheme in [(d, s) for d in DRE_MAX for s in ("per_block", "per_row")]:
                q = quantize_chain(pc, qdtype, scheme)
                scales = expand_scales(q.scales, blk).contiguous()
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x = x0.to(dev, dtype)
                    yp = chain_matmul_q_plain(x, q.values, scales, meta, plan=plan)
                    for bt in (SUPPORTED_BT if n_factors == 3 else (16,)):
                        yk = chain_matmul(x, q.values, meta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        err, rel = rel_err(yk, yp)
                        row = {"phase": "kernel_check", "kernel": "chain_matmul_q", "dtype": dname,
                               "quant": q.qscheme, "J": n_factors, "block": blk,
                               "dims": list(dims[: n_factors + 1]), "batch": 37, "bt": bt,
                               "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                        log(row)
                        require(yk.dtype == dtype and rel <= TOL[dname],
                                f"chain_matmul_q disagrees with its plain version: {row}")
                        rows.append(row)
    return rows


# (block, J) of the grid check: blocks 8 to 128, 24 (no power of two) and 100
# (no multiple of the MMA depth 16); J up to 6, so each ping-pong buffer of the
# workspace is written again after the grid barrier of a later factor
GRID = ((8, 6), (16, 5), (24, 6), (64, 4), (100, 3), (128, 6))


def check_chain_grid(dev, batches=(1, 37, 4096)) -> list[dict]:
    """Phase 2, K1 and K4 on the persistent schedule: the GRID of blocks and
    depths at batches below, at and far above one tile, every tile at
    B = 37; f32 and bf16; K4 for int8, e4m3 and e5m2, per-block (scales as
    stored, one a block, and as rows) and per-row."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import (
        SUPPORTED_BT,
        chain_matmul,
        chain_matmul_plain,
        chain_matmul_q_plain,
    )
    from repro_torch.kernels.ops import chain_meta

    rows = []
    forms = [(None, None, None)] + [(d, sch, lay) for d in DRE_MAX for sch, lay in
                                    (("per_block", "block"), ("per_block", "rows"), ("per_row", "rows"))]
    for blk, n_factors in GRID:
        base = (40, 72, 56, 90, 33, 61, 47) if blk <= 24 else (200, 300, 260, 330, 150, 210, 190)
        dims = base[: n_factors + 1]
        bf, g = _random_chain(dims, blk, 3, 100 * blk + n_factors, dev)
        pc = pack_chain(bf)
        plan = pc.plan
        meta = chain_meta(plan, pc.in_idx)
        for b in batches:
            x0 = torch.randn((b, dims[0]), generator=g)
            x0 = torch.nn.functional.pad(x0, (0, plan.in_blocks[0] * blk - dims[0]))
            for qdtype, scheme, layout in forms:
                q = None if qdtype is None else quantize_chain(pc, qdtype, scheme)
                scales = None if q is None else (q.scales if layout == "block" else
                                                 expand_scales(q.scales, blk).contiguous())
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x = x0.to(dev, dtype)
                    if q is None:
                        values = pc.values.to(dtype)
                        yp = chain_matmul_plain(x, values, meta, plan=plan)
                    else:
                        values = q.values
                        yp = chain_matmul_q_plain(x, values, scales, meta, plan=plan)
                    for bt in SUPPORTED_BT if b == 37 else (16, 64):
                        yk = chain_matmul(x, values, meta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        err, rel = rel_err(yk, yp)
                        row = {"phase": "kernel_check", "kernel": "chain_matmul" + ("" if q is None else "_q"),
                               "dtype": dname, "quant": None if q is None else q.qscheme, "scales": layout,
                               "J": n_factors, "block": blk, "dims": list(dims), "batch": b, "bt": bt,
                               "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                        log(row)
                        require(yk.dtype == dtype and rel <= TOL[dname],
                                f"{row['kernel']} disagrees with its plain version: {row}")
                        rows.append(row)
    return rows


def check_dgrad_grid(dev, batches=(1, 37, 4096)) -> list[dict]:
    """Phase 2, K2 and K5-dgrad on their persistent gather schedule: K1's
    GRID of blocks and depths at batches below, at and far above one tile
    (small batches split the reader lists into chunks), every tile at
    B = 37; f32 and bf16; K5 for int8, e4m3 and e5m2, per-block and per-row;
    then chains whose every output block reads input block 0 (a skewed
    fan-in) and chains that leave input blocks unread.  Each launch runs
    twice and must give the same bits (the sum has a fixed order)."""
    import dataclasses

    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import SUPPORTED_BT
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_dgrad_plain, dgrad_meta

    forms = [(None, None)] + [(d, sch) for d in DRE_MAX for sch in ("per_block", "per_row")]

    def check(pc, dims, g, chain, batches):
        rows, plan, blk = [], pc.plan, pc.plan.block
        meta = dgrad_meta(plan, pc.in_idx)
        for b in batches:
            dy0 = torch.randn((b, plan.out_blocks[-1] * blk), generator=g)
            for qdtype, scheme in forms:
                q = None if qdtype is None else quantize_chain(pc, qdtype, scheme)
                scales = None if q is None else expand_scales(q.scales, blk).contiguous()
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    dy = dy0.to(dev, dtype)
                    values = pc.values.to(dtype) if q is None else q.values
                    want = chain_dgrad_plain(dy, values, meta, plan=plan, scales=scales)
                    for bt in SUPPORTED_BT if b == 37 else (16, 64):
                        got = chain_dgrad(dy, values, meta, plan=plan, bt=bt, scales=scales)
                        again = chain_dgrad(dy, values, meta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        err, rel = rel_err(got, want)
                        row = {"phase": "kernel_check", "kernel": "chain_dgrad" + ("" if q is None else "_q"),
                               "output": "dx", "chain": chain, "dtype": dname,
                               "quant": None if q is None else q.qscheme, "J": plan.n_factors, "block": blk,
                               "dims": list(dims), "batch": b, "bt": bt, "max_abs_err": err, "rel_err": rel,
                               "tol": TOL[dname], "bitwise_repeat": bool(torch.equal(got, again))}
                        log(row)
                        require(got.dtype == dtype and bool(torch.isfinite(got).all()) and rel <= TOL[dname],
                                f"{row['kernel']} disagrees with its plain version: {row}")
                        require(row["bitwise_repeat"], f"{row['kernel']} is not deterministic: {row}")
                        rows.append(row)
        return rows

    rows = []
    for blk, n_factors in GRID:
        base = (40, 72, 56, 90, 33, 61, 47) if blk <= 24 else (200, 300, 260, 330, 150, 210, 190)
        dims = base[: n_factors + 1]
        bf, g = _random_chain(dims, blk, 3, 100 * blk + n_factors, dev)
        rows += check(pack_chain(bf), dims, g, "grid", batches)
    for blk, dims in ((16, (40, 72, 56, 90)), (128, (200, 300, 260, 330))):
        bf, g = _random_chain(dims, blk, 3, 9 * blk, dev)
        pc = pack_chain(bf)
        skew = torch.zeros_like(pc.in_idx)  # every slot reads input block 0
        unread = torch.minimum(pc.in_idx, torch.ones_like(pc.in_idx))  # blocks >= 2 have no reader
        for chain, idx in (("skewed fan-in", skew), ("unread blocks", unread)):
            rows += check(dataclasses.replace(pc, in_idx=idx), dims, g, chain, (37, 4096))
    return rows


def check_wgrad_grid(dev, batches=(1, 37, 4096)) -> list[dict]:
    """Phase 2, K3 and K5-wgrad (recompute on K1's loop, walk on K2's
    gather schedule, emission): K1's GRID at batches below, at and far
    above one tile (small chains cut the emission's batch in chunks), every
    tile at B = 37; f32 and bf16; K5 for int8, e4m3 and e5m2, per-block
    scales as stored and as rows and per-row; then the dgrad's skewed and
    unread chains.  Each launch runs twice and must give the same bits."""
    import dataclasses

    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import SUPPORTED_BT, WGRAD_BT
    from repro_torch.kernels.chain_bwd import chain_wgrad, chain_wgrad_plain, wgrad_meta

    forms = [(None, None, None)] + [(d, sch, lay) for d in DRE_MAX for sch, lay in
                                    (("per_block", "block"), ("per_block", "rows"), ("per_row", "rows"))]

    def check(pc, dims, g, chain, batches):
        rows, plan, blk = [], pc.plan, pc.plan.block
        meta = wgrad_meta(plan, pc.in_idx)
        for b in batches:
            x0 = torch.randn((b, plan.in_blocks[0] * blk), generator=g)
            dy0 = torch.randn((b, plan.out_blocks[-1] * blk), generator=g)
            for qdtype, scheme, layout in forms:
                q = None if qdtype is None else quantize_chain(pc, qdtype, scheme)
                scales = None if q is None else (q.scales if layout == "block" else
                                                 expand_scales(q.scales, blk).contiguous())
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x, dy = x0.to(dev, dtype), dy0.to(dev, dtype)
                    values = pc.values.to(dtype) if q is None else q.values
                    want = chain_wgrad_plain(x, dy, values, meta, plan=plan, scales=scales)
                    for bt in SUPPORTED_BT if b == 37 else (16, WGRAD_BT):
                        got = chain_wgrad(x, dy, values, meta, plan=plan, bt=bt, scales=scales)
                        again = chain_wgrad(x, dy, values, meta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        err, rel = rel_err(got, want)
                        row = {"phase": "kernel_check", "kernel": "chain_wgrad" + ("" if q is None else "_q"),
                               "output": "dvalues", "chain": chain, "dtype": dname,
                               "quant": None if q is None else q.qscheme, "scales": layout, "J": plan.n_factors,
                               "block": blk, "dims": list(dims), "batch": b, "bt": bt, "max_abs_err": err,
                               "rel_err": rel, "tol": TOL[dname], "bitwise_repeat": bool(torch.equal(got, again))}
                        log(row)
                        require(got.dtype == torch.float32 and bool(torch.isfinite(got).all())
                                and rel <= TOL[dname], f"{row['kernel']} disagrees with its plain version: {row}")
                        require(row["bitwise_repeat"], f"{row['kernel']} is not deterministic: {row}")
                        rows.append(row)
        return rows

    rows = []
    for blk, n_factors in GRID:
        base = (40, 72, 56, 90, 33, 61, 47) if blk <= 24 else (200, 300, 260, 330, 150, 210, 190)
        dims = base[: n_factors + 1]
        bf, g = _random_chain(dims, blk, 3, 200 * blk + n_factors, dev)
        rows += check(pack_chain(bf), dims, g, "grid", batches)
    for blk, dims in ((16, (40, 72, 56, 90)), (128, (200, 300, 260, 330))):
        bf, g = _random_chain(dims, blk, 3, 11 * blk, dev)
        pc = pack_chain(bf)
        skew = torch.zeros_like(pc.in_idx)  # every slot reads input block 0
        unread = torch.minimum(pc.in_idx, torch.ones_like(pc.in_idx))  # blocks >= 2 have no reader
        for chain, idx in (("skewed fan-in", skew), ("unread blocks", unread)):
            rows += check(dataclasses.replace(pc, in_idx=idx), dims, g, chain, (37, 4096))
    return rows


def check_bsr_layout(dev, batches=(128, 4096)) -> list[dict]:
    """Phase 2, K6 on random factors of the up-projection's layout (F_1
    16x6, F_2 16x4, F_3 128x4 out blocks x slots of 128 x 128) at the main
    path's batches, every tile, f32 and bf16."""
    import torch

    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.chain import SUPPORTED_BT

    from repro_torch.core.compress import random_block_factor

    dims, blk, ks = UP_PROJ
    g = torch.Generator().manual_seed(17)
    factors = [random_block_factor(dims[j], dims[j + 1], blk, blk, ks[j], generator=g, device=dev)
               for j in range(len(ks))]
    rows = []
    for b in batches:
        x0 = torch.randn((b, UP_PROJ[0][0]), generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x = x0.to(dev, dtype)
            for j, f in enumerate(factors):
                values = f.values.to(dtype)
                want = bsr_matmul_plain(x, values, f.in_idx)
                for bt in SUPPORTED_BT:
                    got = bsr_matmul(x, values, f.in_idx, bt=bt)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    err, rel = rel_err(got, want)
                    row = {"phase": "kernel_check", "kernel": "bsr_matmul", "chain": "up-projection", "factor": j + 1,
                           "dtype": dname, "values_shape": list(values.shape), "batch": b, "bt": bt,
                           "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                    log(row)
                    require(got.dtype == dtype and rel <= TOL[dname], f"bsr_matmul disagrees with its plain version: {row}")
                    rows.append(row)
                x = want
    return rows


def _plain_q_slots_reversed(x, values, scales, meta, plan):
    """K4's plain version with each factor's slots summed last to first (in
    f32, the intermediates rounded to x's dtype as the plain version does):
    the reference's own arithmetic in another summation order."""
    from repro_torch.kernels import ref

    v = ref.dequant_values(values, scales)
    y = x
    for j in range(plan.n_factors):
        vj, ij = ref.factor_slices(v, meta[:, 0], plan, j)
        acc = sum(ref.bsr_matmul_ref(y.float(), vj[:, k:k + 1], ij[:, k:k + 1])
                  for k in reversed(range(plan.k_blocks[j])))
        y = ref._mask_tail(acc.to(x.dtype), plan.out_feats[j])
    return y


def check_k4_rounding(op, qops: dict, batches=(128, 4096), block16=((2048, 2048, 16384), 1024)) -> list[dict]:
    """Phase 4, the repaired K4 with bf16 x: on the main path's chain and on
    a random block-16 chain with the unembedding's block and k (``block16``:
    dims, batch), each quantized form (per-block scales as stored and as rows)
    against its plain version (f32 dequantized values, the reference's
    chain.py:104), beside K1 bf16 on the same chain and batch and the plain
    version itself with its slots summed in reverse.  Error ‖y − plain‖ /
    ‖plain‖ (the max of a bf16 output is one rounding flip, whose size steps
    by 2× with its binade); K4 must stay within 1.25× the larger of the
    other two."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import chain_matmul, chain_matmul_plain, chain_matmul_q_plain
    from repro_torch.kernels.ops import chain_meta

    def norm_err(y, ref):
        return float(torch.linalg.vector_norm(y.float() - ref.float()) / torch.linalg.vector_norm(ref.float()))

    dev = op.device
    g = torch.Generator().manual_seed(6)
    cases = [("up-projection", op._packed, {name: qop.rep for name, qop in qops.items()}, b) for b in batches]
    if block16:
        dims, b = block16
        bf, _ = _random_chain(dims, 16, 4, 8, dev)
        pc = pack_chain(bf)
        cases.append(("block 16 " + "x".join(map(str, dims)), pc,
                      {f"{d}:{sch}": quantize_chain(pc, d, sch) for d, sch in QUANTS}, b))
    rows = []
    for chain, pc, quants, b in cases:
        pc = pc.to(dtype=torch.bfloat16)
        meta = chain_meta(pc.plan, pc.in_idx)
        x = torch.randn((b, pc.plan.in_blocks[0] * pc.plan.block), generator=g).to(dev, torch.bfloat16)
        k1 = norm_err(chain_matmul(x, pc.values, meta, plan=pc.plan), chain_matmul_plain(x, pc.values, meta, plan=pc.plan))
        for qscheme, q in quants.items():
            layouts = [("rows", expand_scales(q.scales, q.plan.block).contiguous())]
            if q.scales.ndim == 1:
                layouts.insert(0, ("block", q.scales))
            for layout, scales in layouts:
                ref = chain_matmul_q_plain(x, q.values, scales, meta, plan=q.plan)
                y = chain_matmul(x, q.values, meta, plan=q.plan, scales=scales)
                k4 = norm_err(y, ref)
                floor = norm_err(_plain_q_slots_reversed(x, q.values, scales, meta, q.plan), ref)
                row = {"phase": "k4_rounding", "chain": chain, "qscheme": qscheme, "scales": layout, "batch": b,
                       "k4_norm_err": k4, "k1_norm_err": k1, "reversed_slots_norm_err": floor,
                       "k4_over_k1": k4 / k1 if k1 else None,
                       "reversed_slots_over_k1": floor / k1 if k1 else None,
                       "k4_over_bar": k4 / max(k1, floor) if max(k1, floor) else None,
                       "k4_max_rel_err": rel_err(y, ref)[1]}
                log(row)
                require(k4 <= 1.25 * max(k1, floor), f"K4 bf16 rounds more than the reference: {row}")
                rows.append(row)
    return rows


def check_backward_kernels(dev) -> list[dict]:
    """Phase 2, slice 3: K2 (chain_dgrad), K3 (chain_wgrad) and K5 (both on
    codes) against their plain versions on the chains K1 is checked on:
    dx, dvalues and, for codes, dscales = Σ_c q·dv."""
    import torch

    from repro_torch.core.compress import expand_scales, pack_chain, quantize_chain
    from repro_torch.kernels.chain import SUPPORTED_BT
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )

    rows = []
    dims_by_blk = {16: (40, 72, 56, 90, 33), 128: (200, 300, 260, 330, 150)}
    forms = [(None, None)] + [(d, s) for d in DRE_MAX for s in ("per_block", "per_row")]
    for blk, dims in dims_by_blk.items():
        for n_factors in (1, 2, 3, 4):
            bf, g = _random_chain(dims[: n_factors + 1], blk, 3, 7 * n_factors + blk, dev)
            pc = pack_chain(bf)
            plan = pc.plan
            x0 = torch.randn((37, dims[0]), generator=g)
            x0 = torch.nn.functional.pad(x0, (0, plan.in_blocks[0] * blk - dims[0]))
            dy0 = torch.randn((37, plan.out_blocks[-1] * blk), generator=g)
            dmeta, wmeta = dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
            for qdtype, scheme in forms:
                q = pc if qdtype is None else quantize_chain(pc, qdtype, scheme)
                scales = None if qdtype is None else expand_scales(q.scales, blk).contiguous()
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x, dy = x0.to(dev, dtype), dy0.to(dev, dtype)
                    values = q.values if qdtype is not None else q.values.to(dtype)
                    dx_p = chain_dgrad_plain(dy, values, dmeta, plan=plan, scales=scales)
                    dv_p = chain_wgrad_plain(x, dy, values, wmeta, plan=plan, scales=scales)
                    for bt in (SUPPORTED_BT if n_factors == 3 else (16,)):
                        dx = chain_dgrad(dy, values, dmeta, plan=plan, bt=bt, scales=scales)
                        dv = chain_wgrad(x, dy, values, wmeta, plan=plan, bt=bt, scales=scales)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        outs = {"dx": (dx, dx_p), "dvalues": (dv, dv_p)}
                        if scales is not None:
                            outs["dscales"] = tuple(torch.sum(values.float() * d, dim=2) for d in (dv, dv_p))
                        for what, (got, want) in outs.items():
                            err, rel = rel_err(got, want)
                            kernel = ("chain_dgrad" if what == "dx" else "chain_wgrad") + ("_q" if scales is not None else "")
                            row = {"phase": "kernel_check", "kernel": kernel, "output": what, "dtype": dname,
                                   "quant": q.qscheme, "J": n_factors, "block": blk,
                                   "dims": list(dims[: n_factors + 1]), "batch": 37, "bt": bt,
                                   "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
                            log(row)
                            require(bool(torch.isfinite(got).all()) and rel <= TOL[dname],
                                    f"{kernel} disagrees with its plain version: {row}")
                            rows.append(row)
    return rows


def main_path(dev, in_f: int = 2048, out_f: int = 16384, batches=(128, 4096)):
    """Phase 3: factorize → pack → apply through the user entry points."""
    import numpy as np
    import torch

    from repro_torch.api import FactorizeSpec, factorize, last_report
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul

    w = np.random.default_rng(0).standard_normal((in_f, out_f), dtype=np.float32) / np.sqrt(in_f)
    chain_matmul.launches = chain_matmul.q_launches = bsr_matmul.launches = 0
    t0 = time.perf_counter()
    op, info = factorize(
        w, FactorizeSpec(strategy="hierarchical", n_factors=3, block=128, k_first=4, k_mid=4),
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fact_s = time.perf_counter() - t0
    w_dev = torch.as_tensor(w, device=dev)
    plan = op._packed.plan
    log({"phase": "factorize", "shape": [in_f, out_f], "seconds": fact_s,
         "rel_error_fro": float(op.rel_error_fro(w_dev)), "s_tot": op.s_tot, "rcg": op.rcg,
         "sweeps": info.n_sweeps, "global_losses": info.hierarchical.global_losses,
         "plan": {"block": plan.block, "in_blocks": plan.in_blocks,
                  "out_blocks": plan.out_blocks, "k_blocks": plan.k_blocks,
                  "n_steps": plan.n_steps, "max_blocks": plan.max_blocks}})
    dense = op.todense()
    g = torch.Generator().manual_seed(1)
    for b in batches:
        x = torch.randn((b, in_f), generator=g).to(dev)
        y_dense = x @ dense
        for backend in ("auto", "fused", "bsr"):
            y = op.apply(x, backend, device=dev)
            report = last_report()
            y_plain = op.apply(x, report.backend, use_kernel=False, device=dev)
            err_p, rel_p = rel_err(y, y_plain)
            err_d, rel_d = rel_err(y, y_dense)
            row = {"phase": "apply", "batch": b, "requested": backend,
                   "report": report.as_row(), "max_abs_err_plain": err_p, "rel_err_plain": rel_p,
                   "max_abs_err_dense": err_d, "rel_err_dense": rel_d,
                   "finite": bool(torch.isfinite(y).all()), "shape": list(y.shape)}
            log(row)
            require(row["finite"] and tuple(y.shape) == (b, out_f), f"bad output: {row}")
            require(rel_p <= TOL["float32"], f"{backend} apply disagrees with the plain version")
            require(rel_d <= DENSE_TOL, f"{backend} apply disagrees with x @ todense()")
    launches = {"chain_matmul": chain_matmul.launches, "bsr_matmul": bsr_matmul.launches}
    log({"phase": "launches", **launches})
    if dev.type == "cuda":
        require(all(n > 0 for n in launches.values()), f"a kernel of the path never ran: {launches}")
    return op, launches, w_dev


def quantized_path(op, w_dev, batches=(128, 4096)) -> tuple[dict, dict]:
    """Phase 4: the main path's chain quantized, served through every
    backend; returns ({qscheme: op}, launch counts of this phase)."""
    import torch

    from repro_torch.api import FaustOp, last_report
    from repro_torch.core.compress import quantize_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul

    dev = op.device
    m, n = op.shape
    f32_bytes = op._packed.weight_bytes
    re_f32 = float(op.rel_error_fro(w_dev))
    chain_matmul.launches = chain_matmul.q_launches = bsr_matmul.launches = 0
    qops = {}
    g = torch.Generator().manual_seed(2)
    xs = {b: torch.randn((b, m), generator=g).to(dev) for b in batches}
    for qdtype, scheme in QUANTS:
        qop = FaustOp.from_packed(quantize_chain(op._packed, qdtype, scheme), device=dev)
        qops[qop.rep.qscheme] = qop
        dense = qop.todense()
        dre = float(qop.rel_error_fro(w_dev)) - re_f32
        row = {"phase": "quantize", "qscheme": qop.rep.qscheme, "weight_bytes": qop.rep.weight_bytes,
               "f32_weight_bytes": f32_bytes, "bytes_ratio": qop.rep.weight_bytes / f32_bytes,
               "rel_error_fro": re_f32 + dre, "delta_re": dre, "delta_re_max": DRE_MAX[qdtype]}
        log(row)
        require(row["bytes_ratio"] <= 0.26, f"quantized chain is not ~4x smaller: {row}")
        require(abs(dre) <= DRE_MAX[qdtype], f"quantization error over the threshold: {row}")
        for b, x32 in xs.items():
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                x = x32.to(dtype)
                y_dense = x.float() @ dense
                for backend in ("fused", "bsr", "dense", "auto"):
                    y = qop.apply(x, backend, device=dev)
                    report = last_report()
                    y_plain = qop.apply(x, report.backend, use_kernel=False, device=dev)
                    err_p, rel_p = rel_err(y, y_plain)
                    err_d, rel_d = rel_err(y, y_dense)
                    row = {"phase": "apply_quantized", "qscheme": qop.rep.qscheme, "dtype": dname,
                           "batch": b, "requested": backend, "report": report.as_row(),
                           "max_abs_err_plain": err_p, "rel_err_plain": rel_p,
                           "max_abs_err_dense": err_d, "rel_err_dense": rel_d,
                           "finite": bool(torch.isfinite(y).all()), "shape": list(y.shape)}
                    log(row)
                    require(row["finite"] and tuple(y.shape) == (b, n) and y.dtype == dtype,
                            f"bad output: {row}")
                    require(rel_p <= TOL[dname], f"{backend} quantized apply disagrees with the plain version")
                    require(rel_d <= (DENSE_TOL if dtype == torch.float32 else TOL[dname]),
                            f"{backend} quantized apply disagrees with x @ todense()")
    launches = {"chain_matmul": chain_matmul.launches, "chain_matmul_q": chain_matmul.q_launches,
                "bsr_matmul": bsr_matmul.launches}
    log({"phase": "launches_quantized", **launches})
    if dev.type == "cuda":
        require(launches["chain_matmul_q"] > 0 and launches["bsr_matmul"] > 0,
                f"a kernel of the quantized path never ran: {launches}")
    return qops, launches


def measured_dispatch(ops: dict, batches=(128, 4096)) -> dict:
    """Phase 5: fill a fresh table through ``apply(autotune=True)``; then
    ``auto`` must follow it.  Returns {(name, batch): table entry}."""
    import torch

    from repro_torch.api import autotune, dispatch, last_report
    from repro_torch.kernels.chain import FORWARD_BT, chain_matmul

    TABLE.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = str(TABLE)
    os.environ.pop("REPRO_AUTOTUNE", None)  # read-only: only autotune=True measures
    autotune.reload()
    entries = {}
    g = torch.Generator().manual_seed(3)
    for name, op in ops.items():
        for b in batches:
            x = torch.randn((b, op.shape[0]), generator=g).to(op.device)
            op.apply(x, autotune=True, device=op.device)
            entry = autotune.lookup(autotune.key_for_op(op, batch=b, dtype=x.dtype))
            require(entry is not None, f"{name} B={b}: no table entry after apply(autotune=True)")
            before = (chain_matmul.launches, chain_matmul.q_launches)
            y = op.apply(x, device=op.device)
            report = last_report()
            fastest = min(entry["us"], key=lambda k: (entry["us"][k], dispatch._ORDER[k]))
            row = {"phase": "measured_dispatch", "op": name, "batch": b, "key":
                   autotune.key_for_op(op, batch=b, dtype=x.dtype), "entry": entry,
                   "report": report.as_row(), "finite": bool(torch.isfinite(y).all())}
            log(row)
            require(report.source == "measured", f"auto did not read the table: {row}")
            require(report.backend == fastest, f"auto did not pick the fastest measured backend: {row}")
            # the card's entries always carry the tile sweep's winner
            require(report.bt == entry.get("bt", FORWARD_BT), f"auto did not take the table's fused tile: {row}")
            if report.backend == "fused" and op.device.type == "cuda":
                require((chain_matmul.launches, chain_matmul.q_launches) != before,
                        f"auto picked fused but launched no chain kernel: {row}")
            entries[(name, b)] = entry
    return entries


def measure(op, card_line: str) -> tuple[list[dict], float]:
    """Phase 12: kernel, plain and library times at the main path's shapes;
    every row names the card and its power limit."""
    import torch

    from repro_torch.core.compress import unpack_chain
    from repro_torch.kernels.bsr_matmul import BSR_BT, bsr_matmul, bsr_matmul_plain
    from repro_torch.launch.calibrate import measure_t_launch_us
    from repro_torch.kernels.chain import FORWARD_BT, SUPPORTED_BT, chain_matmul, chain_matmul_plain
    from repro_torch.kernels.ops import chain_meta

    dev = op.device
    t_launch_us = measure_t_launch_us(device=dev)
    log({"phase": "t_launch", "card": card_line, "t_launch_us": t_launch_us})
    m, n = op.shape
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        elt = torch.empty((), dtype=dtype).element_size()
        pc = op._packed.to(dtype=dtype)
        plan, s_tot = pc.plan, pc.values.numel()
        bf = unpack_chain(pc)
        a_dense = op.todense().to(dtype)
        meta = chain_meta(plan, pc.in_idx)
        for b in (128, 4096):
            x = torch.randn((b, m), device=dev).to(dtype)

            # every width of this chain is a block multiple: no pad, no slice
            def k6(fn=bsr_matmul):
                y = x
                for f in bf.factors:
                    y = fn(y, f.values, f.in_idx)
                return y

            fns = {
                "chain_matmul": (lambda: chain_matmul(x, pc.values, meta, plan=plan),
                                 lambda: chain_matmul_plain(x, pc.values, meta, plan=plan), 1),
                "bsr_matmul": (k6, lambda: k6(bsr_matmul_plain), plan.n_factors),
            }
            tiles = {"chain_matmul": FORWARD_BT, "bsr_matmul": BSR_BT}
            flops = 2.0 * b * s_tot
            byts = elt * s_tot + elt * b * (m + n)
            t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
            for name, (kern, plain, per_call) in fns.items():
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"{name} {dname} B={b} disagrees with its plain version")
                row = {"phase": "time", "card": card_line, "kernel": name, "dtype": dname, "batch": b,
                       "bt": tiles[name], "launches_per_apply": per_call, "max_abs_err": err, "rel_err": rel,
                       "ms": time_ms(kern), "cold_ms": time_ms_cold(kern), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(lambda: torch.matmul(x, a_dense)),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": byts}
                log(row)
                rows.append(row)
    # end to end: one op.apply per backend, host work (padding, step table,
    # allocation, λ) included
    for b in (128, 4096):
        x = torch.randn((b, m), device=dev)
        log({"phase": "apply_time", "card": card_line, "dtype": "float32", "batch": b,
             **{f"{be}_ms": time_ms(lambda be=be: op.apply(x, be, device=dev))
                for be in ("fused", "bsr", "dense")},
             "auto_picks": op.dispatch_for(b).backend})

    # batch-tile sweeps: the data behind FORWARD_BT (K1) and BSR_BT (K6,
    # three launches)
    for dtype in (torch.float32, torch.bfloat16):
        pc = op._packed.to(dtype=dtype)
        bf = unpack_chain(pc)
        meta = chain_meta(pc.plan, pc.in_idx)
        for b in (128, 4096):
            x = torch.randn((b, m), device=dev).to(dtype)

            def k6(bt):
                y = x
                for f in bf.factors:
                    y = bsr_matmul(y, f.values, f.in_idx, bt=bt)
                return y

            head = {"card": card_line, "dtype": str(dtype).removeprefix("torch."), "batch": b}
            log({"phase": "bt_sweep", **head, **{
                f"chain_matmul_bt{bt}_ms": time_ms(lambda bt=bt: chain_matmul(x, pc.values, meta, plan=pc.plan, bt=bt))
                for bt in SUPPORTED_BT}})
            log({"phase": "bsr_bt_sweep", **head, **{f"bsr_matmul_bt{bt}_ms": time_ms(lambda bt=bt: k6(bt))
                                                     for bt in SUPPORTED_BT}})
    return rows, t_launch_us


def measure_quantized(qops: dict, ops: dict, card_line: str, batches=(128, 4096)) -> list[dict]:
    """Phase 12, slice 2: K4 per code type at both batches beside its bound,
    its plain version and ``torch.matmul`` on the dequantized dense
    matrix, with the scales as the chain stores them (per block or per
    row, as the fused apply passes them); then ``apply("auto")`` on the
    model alone and on the table, beside the forced backend the table
    picks."""
    import torch

    from repro_torch.api import last_report
    from repro_torch.kernels.chain import FORWARD_BT, chain_matmul, chain_matmul_q_plain
    from repro_torch.kernels.ops import chain_meta

    rows = []
    for qscheme in ("int8:per_block", "int8:per_row", "fp8_e4m3:per_block", "fp8_e5m2:per_block"):
        qop = qops[qscheme]
        q = qop.rep
        dev, (m, n) = qop.device, qop.shape
        plan, s_tot = q.plan, q.values.numel()
        scales = q.scales.contiguous()
        meta = chain_meta(plan, q.in_idx)
        dense = qop.todense()
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            elt = torch.empty((), dtype=dtype).element_size()
            a_dense = dense.to(dtype)
            for b in batches:
                x = torch.randn((b, m), device=dev).to(dtype)
                kern = lambda: chain_matmul(x, q.values, meta, plan=plan, scales=scales)  # noqa: E731
                plain = lambda: chain_matmul_q_plain(x, q.values, scales, meta, plan=plan)  # noqa: E731
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"chain_matmul_q {qscheme} {dname} B={b} disagrees with its plain version")
                flops = 2.0 * b * s_tot
                byts = q.values.element_size() * s_tot + 4 * scales.numel() + elt * b * (m + n)
                t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
                row = {"phase": "time", "card": card_line, "kernel": "chain_matmul_q", "quant": qscheme,
                       "dtype": dname, "batch": b, "bt": FORWARD_BT, "launches_per_apply": 1, "max_abs_err": err,
                       "rel_err": rel, "ms": time_ms(kern), "cold_ms": time_ms_cold(kern), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(lambda: torch.matmul(x, a_dense)),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": byts}
                log(row)
                rows.append(row)

    # auto: the model alone (table off) and the table, beside the forced
    # backend the table picks (at the table's tile), in alternation
    for name, op in ops.items():
        for b in batches:
            x = torch.randn((b, op.shape[0]), device=op.device)
            os.environ["REPRO_AUTOTUNE"] = "off"
            op.apply(x, device=op.device)
            model = last_report()
            model_ms = time_ms(lambda: op.apply(x, device=op.device))
            del os.environ["REPRO_AUTOTUNE"]
            op.apply(x, device=op.device)
            tuned = last_report()
            t0 = time.perf_counter()
            for _ in range(1000):
                op.dispatch_for(b)
            dispatch_us = (time.perf_counter() - t0) * 1e3  # µs per table-hit decision, host
            # at B = 128 a call is host-paced (samples of 20 calls read 0.19-0.36
            # ms for the same work): medians of single calls that alternate
            timing = interleaved_ms({"forced": lambda: op.apply(x, tuned.backend, bt=tuned.bt, device=op.device),
                                     "auto": lambda: op.apply(x, device=op.device)}, 800 if b < 1024 else 60)
            row = {"phase": "auto_time", "card": card_line, "op": name, "batch": b,
                   "model_picks": model.backend, "model_source": model.source, "auto_model_ms": model_ms,
                   "table_picks": tuned.backend, "table_source": tuned.source, "table_bt": tuned.bt,
                   "auto_table_ms": statistics.median(timing["auto"]),
                   "forced_ms": statistics.median(timing["forced"]), "calls": len(timing["auto"]),
                   "quantiles_ms": {k: [_pct(v, q) for q in (0, 0.1, 0.5, 0.9, 1)] for k, v in timing.items()},
                   "dispatch_us": dispatch_us}
            row["auto_over_forced"] = row["auto_table_ms"] / row["forced_ms"]
            log(row)
            require(model.source == "model" and tuned.source == "measured", f"wrong sources: {row}")
            require(row["auto_over_forced"] <= AUTO_SLACK, f"auto is slower than its forced backend: {row}")
            rows.append(row)
    return rows


def _bwd_counts() -> dict:
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_wgrad

    return {"chain_matmul": chain_matmul.launches, "chain_matmul_q": chain_matmul.q_launches,
            "bsr_matmul": bsr_matmul.launches, "chain_dgrad": chain_dgrad.launches,
            "chain_wgrad": chain_wgrad.launches, "chain_dgrad_q": chain_dgrad.q_launches,
            "chain_wgrad_q": chain_wgrad.q_launches}


def _zero_counts() -> None:
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul
    from repro_torch.kernels.chain_bwd import chain_dgrad, chain_wgrad

    chain_matmul.launches = chain_matmul.q_launches = bsr_matmul.launches = 0
    chain_dgrad.launches = chain_dgrad.q_launches = chain_wgrad.launches = chain_wgrad.q_launches = 0


def _trainable(op):
    """A copy of ``op`` whose trained tensor (the values of an f32 chain,
    the scales of a quantized one) is a fresh leaf that requires grad."""
    import dataclasses

    from repro_torch.api import FaustOp

    pc = op._packed
    name = "scales" if pc.quantized else "values"
    leaf = getattr(pc, name).detach().clone().requires_grad_(True)
    return FaustOp(dataclasses.replace(pc, **{name: leaf})), leaf


def training_path(ops: dict, card_line: str, batches=(128, 4096)) -> tuple[list[dict], dict]:
    """Phase 6, slice 3: FaustOp-level training applies at full width.  For
    the f32 chain (gradient wrt x and the values) and its int8 per-block
    form (wrt x and the scales), f32 and bf16 x, both batches: fwd+bwd
    through ``fused`` (K1+K2+K3, K4+K5), ``bsr`` and ``dense``, each held
    against the plain versions and against autograd of x @ op.todense();
    fwd and fwd+bwd times; ``apply("auto")``'s report under grad.  Counts
    zeroed before, read after."""
    import torch

    from repro_torch.api import last_report

    _zero_counts()
    rows = []
    g = torch.Generator().manual_seed(4)
    for name, op in ops.items():
        m, n = op.shape
        dev = op.device
        for b in batches:
            x32 = torch.randn((b, m), generator=g).to(dev)
            w = torch.randn((b, n), generator=g).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                top, leaf = _trainable(op)

                def grads(backend, use_kernel=None, dense=False):
                    x = x32.to(dtype, copy=True).requires_grad_(True)
                    leaf.grad = None
                    if dense:
                        y = x.float() @ top.todense()
                    else:
                        y = top.apply(x, backend, use_kernel=use_kernel, device=dev)
                    (y.float() * w).sum().backward()
                    return y.detach(), x.grad.detach().clone(), leaf.grad.detach().clone()

                _, dx_d, dl_d = grads(None, dense=True)
                for backend in ("fused", "bsr", "dense"):
                    y, dx, dl = grads(backend)
                    report = last_report()
                    _, dx_p, dl_p = grads(backend, use_kernel=False)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    errs = {"dx_plain": rel_err(dx, dx_p), "dleaf_plain": rel_err(dl, dl_p),
                            "dx_dense": rel_err(dx, dx_d), "dleaf_dense": rel_err(dl, dl_d)}
                    x = x32.to(dtype, copy=True).requires_grad_(True)
                    with torch.no_grad():
                        fwd_ms = time_ms(lambda: top.apply(x, backend, device=dev), iters=5)
                    fwdbwd_ms = time_ms(lambda: top.apply(x, backend, device=dev).backward(w.to(dtype)), iters=5)
                    row = {"phase": "train_apply", "card": card_line, "op": name, "dtype": dname, "batch": b,
                           "backend": backend, "grad_wrt": "scales" if op._packed.quantized else "values",
                           "report": report.as_row(), "fwd_ms": fwd_ms, "fwd_bwd_ms": fwdbwd_ms,
                           **{f"rel_err_{k}": v[1] for k, v in errs.items()},
                           "finite": bool(torch.isfinite(dx).all() and torch.isfinite(dl).all())}
                    log(row)
                    tol_dense = DENSE_TOL if dtype == torch.float32 else TOL[dname]
                    require(row["finite"] and report.grad, f"bad training apply: {row}")
                    require(errs["dx_plain"][1] <= TOL[dname] and errs["dleaf_plain"][1] <= TOL[dname],
                            f"{backend} gradients disagree with the plain versions: {row}")
                    require(errs["dx_dense"][1] <= tol_dense and errs["dleaf_dense"][1] <= tol_dense,
                            f"{backend} gradients disagree with autograd of x @ todense(): {row}")
                    rows.append(row)
                x = x32.to(dtype, copy=True).requires_grad_(True)
                top.apply(x, device=dev)
                auto = last_report()
                log({"phase": "train_auto", "op": name, "dtype": dname, "batch": b, "report": auto.as_row()})
                require(auto.grad, f"auto under autograd was not priced for training: {auto.as_row()}")
    counts = _bwd_counts()
    log({"phase": "launches_train_apply", **counts})
    if any(op.device.type == "cuda" for op in ops.values()):
        require(all(counts[k] > 0 for k in ("chain_dgrad", "chain_wgrad", "chain_dgrad_q", "chain_wgrad_q")),
                f"a backward kernel of the training apply never ran: {counts}")
    return rows, counts


def train_lm(card_line: str, argv=None) -> dict:
    """Phase 7, slice 3: ``repro_torch.launch.train``'s own path at
    gemma-2b's full width and depth with a FAµST unembedding (the reference
    CLI's defaults: bf16, remat, block 16, k 4, 2 factors, untied), on a
    fresh autotune table so ``auto`` is the model's choice.  Per step: loss,
    step time, tokens/s; peak memory; the captured FAµST dispatch; the
    kernel counts of the phase, which must include K2 and K3."""
    import torch

    from repro_torch.api import autotune
    from repro_torch.kernels import ops
    from repro_torch.kernels.chain import DGRAD_BT, WGRAD_BT
    from repro_torch.launch import train

    table = ROOT / "build" / "chip_smoke_train_autotune.json"
    table.unlink(missing_ok=True)
    saved = {k: os.environ.get(k) for k in ("REPRO_TORCH_AUTOTUNE_TABLE", "REPRO_AUTOTUNE")}
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = str(table)
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.reload()
    argv = argv or ["--arch", "gemma_2b", "--faust", "--steps", "3", "--batch", "8", "--seq", "128"]
    args = train.parse_args(argv)
    # the batch tile each fused kernel runs at: the wrappers the fused apply
    # calls, wrapped for this phase
    tiles: dict[str, list[int]] = {}
    wrapped = {name: getattr(ops, name) for name in ("chain_matmul", "chain_dgrad", "chain_wgrad")}

    def recorder(name, fn):
        def call(*a, **k):
            tiles.setdefault(name, [])
            if k["bt"] not in tiles[name]:
                tiles[name].append(k["bt"])
            return fn(*a, **k)
        return call

    try:
        for name, fn in wrapped.items():
            setattr(ops, name, recorder(name, fn))
        trainer = train.build(args)
        if trainer.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        out = trainer.run(resume=args.resume)
        wall_s = time.perf_counter() - t0
        counts = _bwd_counts()
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
        profile = profile_step(trainer, out, card_line) if trainer.device.type == "cuda" else None
    finally:  # the later phases read phase 5's table again, through the wrappers themselves
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reload()
    n_params = sum(p.numel() for p in out["model"].parameters())
    tokens = args.batch * args.seq
    for h in out["history"]:
        log({"phase": "train_step", "card": card_line, "step": h["step"], "loss": h["loss"],
             "step_time_s": h["step_time_s"], "tokens_per_s": tokens / h["step_time_s"],
             "grad_norm": h.get("grad_norm"), "lr": h.get("lr"), "skipped": h["skipped"]})
    rep = trainer.faust_dispatch
    row = {"phase": "train_lm", "card": card_line, "argv": argv, "n_layers": trainer.cfg.n_layers,
           "d_model": trainer.cfg.d_model, "vocab": trainer.cfg.vocab, "dtype": trainer.cfg.dtype,
           "remat": trainer.cfg.remat, "faust_unembed": str(trainer.cfg.faust_unembed), "params": n_params,
           "wall_s": wall_s,
           "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                       if trainer.device.type == "cuda" else None),
           "faust_dispatch": None if rep is None else rep.as_row(), "fused_tiles": tiles, "launches": counts,
           "profile": profile}
    log(row)
    losses = [h["loss"] for h in out["history"]]
    require(len(losses) == args.steps and all(math.isfinite(v) for v in losses), f"bad losses: {losses}")
    require(rep is not None and rep.grad, f"no FAµST dispatch priced for training was captured: {row}")
    if trainer.device.type == "cuda":
        require(counts["chain_dgrad"] > 0 and counts["chain_wgrad"] > 0,
                f"the trainer never ran K2/K3: {counts}")
    if rep.backend == "fused":  # each fused kernel at its own tile: K1 at the dispatch's, K2 and K3 at theirs
        require(tiles == {"chain_matmul": [rep.bt], "chain_dgrad": [DGRAD_BT], "chain_wgrad": [WGRAD_BT]},
                f"the fused apply ran other tiles: {tiles}")
    del out
    return row


# kernel families of a trainer step, by the device kernel's name
# (K3's recompute and walk run K1's and K2's kernels in namespaces named
# wgrad_fwd and wgrad_bwd, its emission is wgrad_emit_kernel: first match wins)
FAMILIES = (("K3 chain_wgrad", ("wgrad",)), ("K1/K4 chain_matmul", ("chain_fwd_kernel",)),
            ("K2 chain_dgrad", ("chain_dgrad",)), ("K6 bsr_matmul", ("bsr_matmul_kernel",)),
            ("dense matmul", ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),
            ("elementwise and reductions", ("elementwise", "reduce_kernel", "Memset", "Memcpy")))


def device_spans(prof, step_s: float) -> dict:
    """A ``torch.profiler`` trace of one step of ``step_s`` host seconds:
    the device's busy time (the union of kernel spans), its idle share,
    device time by kernel family and the ten costliest kernels."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b, _ in spans:  # union of the kernel spans
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    families = {fam: 0.0 for fam, _ in FAMILIES} | {"other": 0.0}
    for name, us in by_name.items():
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)), "other")
        families[fam] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"step_s": step_s, "device_busy_ms": busy_us / 1e3, "n_kernels": len(spans),
            "device_idle_share": (1.0 - busy_us / 1e6 / step_s) if spans else None,
            "family_ms": families, "top_kernels_ms": [[n[:120], us / 1e3] for n, us in top]}


def profile_step(trainer, out, card_line: str, phase: str = "train_profile") -> dict:
    """Phase 7 (and 14), one more steady step of the trained model under
    ``torch.profiler``: the host's step time, the device's busy time (the
    union of kernel spans) and idle share, and device time by kernel family
    and by the ten costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    from repro_torch.data.pipeline import DataIterator
    from repro_torch.runtime.trainer import make_train_step

    step_fn = make_train_step(out["model"], trainer.opt_cfg, trainer.tcfg)
    data = DataIterator(trainer.data_cfg)
    batches = [{k: torch.from_numpy(v).to(trainer.device) for k, v in next(data).items()} for _ in range(2)]
    float(step_fn(batches[0], out["opt"], out.get("ef"))["loss"])  # warm: the step's allocations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(step_fn(batches[1], out["opt"], out.get("ef"))["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    row = {"phase": phase, "card": card_line, "loss": loss, **device_spans(prof, step_s)}
    log(row)
    require(math.isfinite(loss), f"the profiled step's loss is not finite: {row}")
    return {k: row[k] for k in ("step_s", "device_busy_ms", "device_idle_share", "family_ms")}


def measure_backward(op, qop, card_line: str, batches=(128, 4096)) -> list[dict]:
    """Phase 12, slice 3: K2, K3 and K5 (its dgrad and wgrad halves on int8
    codes, scales as the chain stores them) at the main path's shapes
    beside their bound, their plain versions, a cold-L2 time and, for the
    dgrads, one PyTorch call computing the same function (``dy @
    A_denseᵀ``); then K2's and K3's batch-tile sweeps (the data behind
    ``DGRAD_BT`` and ``WGRAD_BT``)."""
    import torch

    from repro_torch.kernels.chain import DGRAD_BT, SUPPORTED_BT, WGRAD_BT
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )

    rows = []
    m, n = op.shape
    dev = op.device
    q = qop._packed
    qscales = q.scales.contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        elt = torch.empty((), dtype=dtype).element_size()
        pc = op._packed.to(dtype=dtype)
        plan = pc.plan
        sizes = [plan.offsets[j + 1] - plan.offsets[j] for j in range(plan.n_factors)]
        s_tot = pc.values.numel()
        s_j = [sz * plan.block * plan.block for sz in sizes]
        dm, wm = dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
        a_dense, aq_dense = op.todense().to(dtype), qop.todense().to(dtype)
        q_bytes = s_tot + 4 * qscales.numel()  # int8 codes and f32 scales
        for b in batches:
            x = torch.randn((b, m), device=dev).to(dtype)
            dy = torch.randn((b, n), device=dev).to(dtype)
            w_flops = 2.0 * b * (sum(s_j[:-1]) + s_tot + sum(s_j[1:]))
            cases = {
                "chain_dgrad": (lambda: chain_dgrad(dy, pc.values, dm, plan=plan),
                                lambda: chain_dgrad_plain(dy, pc.values, dm, plan=plan),
                                lambda: torch.matmul(dy, a_dense.T), 2.0 * b * s_tot,
                                elt * (s_tot + b * (m + n))),
                "chain_wgrad": (lambda: chain_wgrad(x, dy, pc.values, wm, plan=plan),
                                lambda: chain_wgrad_plain(x, dy, pc.values, wm, plan=plan),
                                None, w_flops, elt * (s_tot + b * (m + n)) + 4 * s_tot),
                "chain_dgrad_q": (lambda: chain_dgrad(dy, q.values, dm, plan=plan, scales=qscales),
                                  lambda: chain_dgrad_plain(dy, q.values, dm, plan=plan, scales=qscales),
                                  lambda: torch.matmul(dy, aq_dense.T), 2.0 * b * s_tot,
                                  q_bytes + elt * b * (m + n)),
                "chain_wgrad_q": (lambda: chain_wgrad(x, dy, q.values, wm, plan=plan, scales=qscales),
                                  lambda: chain_wgrad_plain(x, dy, q.values, wm, plan=plan, scales=qscales),
                                  None, w_flops, q_bytes + elt * b * (m + n) + 4 * s_tot),
            }
            for name, (kern, plain, lib, flops, byts) in cases.items():
                err, rel = rel_err(kern(), plain())
                require(rel <= TOL[dname], f"{name} {dname} B={b} disagrees with its plain version")
                t_ops, t_bytes = flops / PEAK[dname], byts / HBM_BW
                dgrad = name.startswith("chain_dgrad")
                row = {"phase": "time", "card": card_line, "kernel": name, "dtype": dname, "batch": b,
                       "quant": q.qscheme if name.endswith("_q") else None,
                       "bt": DGRAD_BT if dgrad else WGRAD_BT, "launches_per_apply": 1,
                       "max_abs_err": err, "rel_err": rel, "ms": time_ms(kern),
                       "cold_ms": time_ms_cold(kern, iters=10),
                       "plain_ms": time_ms(plain),
                       "library_ms": None if lib is None else time_ms(lib),
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": byts}
                log(row)
                rows.append(row)
            log({"phase": "dgrad_bt_sweep", "card": card_line, "dtype": dname, "batch": b,
                 **{f"chain_dgrad_bt{bt}_ms": time_ms(lambda bt=bt: chain_dgrad(dy, pc.values, dm, plan=plan, bt=bt))
                    for bt in SUPPORTED_BT}})
            log({"phase": "wgrad_bt_sweep", "card": card_line, "dtype": dname, "batch": b,
                 **{f"chain_wgrad_bt{bt}_ms": time_ms(lambda bt=bt: chain_wgrad(x, dy, pc.values, wm, plan=plan, bt=bt))
                    for bt in SUPPORTED_BT},
                 **{f"chain_wgrad_q_bt{bt}_ms": time_ms(
                     lambda bt=bt: chain_wgrad(x, dy, q.values, wm, plan=plan, bt=bt, scales=qscales))
                    for bt in SUPPORTED_BT}})
    return rows


def measure_unembed(card_line: str, dev, b: int = 1024, dims=(2048, 2048, 256000)) -> list[dict]:
    """Phase 12, slice 3: K1, K2 and K3 at the shapes the trainer gives them:
    the ``--faust`` unembedding (2048 → 2048 → 256000, block 16, k 4, bf16)
    at B = 8·128 tokens, on random values of that layout, beside their
    bound, plain versions and, for K1/K2, one ``torch.matmul`` on the
    dense matrix."""
    import torch

    from repro_torch.core.compress import pack_chain
    from repro_torch.kernels.chain import SUPPORTED_BT, chain_matmul, chain_matmul_plain
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )
    from repro_torch.kernels.ops import chain_meta

    blk = 16
    bf, g = _random_chain(dims, blk, 4, 5, dev)
    pc = pack_chain(bf).to(dtype=torch.bfloat16)
    plan, s_tot = pc.plan, pc.values.numel()
    m, n = dims[0], dims[-1]
    s_j = [(plan.offsets[j + 1] - plan.offsets[j]) * blk * blk for j in range(plan.n_factors)]
    x = torch.randn((b, m), generator=g).to(dev, torch.bfloat16)
    dy = torch.randn((b, n), generator=g).to(dev, torch.bfloat16)
    fm, dm, wm = chain_meta(plan, pc.in_idx), dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
    a_dense = bf.todense().to(torch.bfloat16)
    edge = 2 * (s_tot + b * (m + n))
    cases = {
        "chain_matmul": (lambda: chain_matmul(x, pc.values, fm, plan=plan),
                         lambda: chain_matmul_plain(x, pc.values, fm, plan=plan),
                         lambda: torch.matmul(x, a_dense), 2.0 * b * s_tot, edge),
        "chain_dgrad": (lambda: chain_dgrad(dy, pc.values, dm, plan=plan),
                        lambda: chain_dgrad_plain(dy, pc.values, dm, plan=plan),
                        lambda: torch.matmul(dy, a_dense.T), 2.0 * b * s_tot, edge),
        "chain_wgrad": (lambda: chain_wgrad(x, dy, pc.values, wm, plan=plan),
                        lambda: chain_wgrad_plain(x, dy, pc.values, wm, plan=plan), None,
                        2.0 * b * (sum(s_j[:-1]) + s_tot + sum(s_j[1:])), edge + 4 * s_tot),
    }
    rows = []
    for name, (kern, plain, lib, flops, byts) in cases.items():
        err, rel = rel_err(kern(), plain())
        require(rel <= TOL["bfloat16"], f"{name} at the unembedding's shape disagrees with its plain version")
        t_ops, t_bytes = flops / PEAK["bfloat16"], byts / HBM_BW
        row = {"phase": "time", "card": card_line, "kernel": name, "chain": f"unembedding {m}x{n} block 16 k 4",
               "dtype": "bfloat16", "batch": b, "launches_per_apply": 1, "max_abs_err": err, "rel_err": rel,
               "ms": time_ms(kern, iters=3), "plain_ms": time_ms(plain, iters=3),
               "cold_ms": time_ms_cold(kern, iters=3),
               "library_ms": None if lib is None else time_ms(lib, iters=3),
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops, "bytes": byts}
        log(row)
        rows.append(row)
    log({"phase": "wgrad_bt_sweep", "card": card_line, "chain": "unembedding", "dtype": "bfloat16", "batch": b,
         **{f"chain_wgrad_bt{bt}_ms": time_ms(lambda bt=bt: chain_wgrad(x, dy, pc.values, wm, plan=plan, bt=bt), iters=3)
            for bt in SUPPORTED_BT}})
    return rows


# ---------------------------------------------------------------------------
# Slice 7: the factorizer at workload scale, composition, grad dispatch
# ---------------------------------------------------------------------------

GEMMA_UP = (18, 2048, 16384)  # gemma-2b: n_layers, d_model, d_ff (src/repro/configs/gemma_2b.py)
BATCHED_RE_GAP = 1e-3  # batched against sequential RE on the card: bmm and mm sum in other orders


def _free() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def factorize_batched(dev, shape=GEMMA_UP, block: int = 128, batch: int = 128, check=(0, -1)) -> dict:
    """Phase 8: every MLP up-projection of gemma-2b as one stack ``(18,
    2048, 16384)`` f32 (seed 0, /√2048) through ``factorize(ws, spec)``
    with slice 1's spec (block 128, k 4, J = 3, 40/40 sweeps): the batched
    route's seconds, each matrix's RE and the peak memory; the sequential
    route on the first and last matrix, whose RE must lie within 1e-3 of
    the batched run's; then each operator through ``apply("fused")`` at
    B = 128 against ``x @ op.todense()``, K1 launched once per operator."""
    import torch

    from repro_torch.api import FactorizeSpec, factorize
    from repro_torch.kernels.chain import chain_matmul

    n, d_in, d_out = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = torch.randn(shape, generator=gen, device=dev) / math.sqrt(d_in)
    spec = FactorizeSpec(strategy="hierarchical", n_factors=3, block=block, k_first=4, k_mid=4)
    cuda = dev.type == "cuda"
    _free()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    op, info = factorize(ws, spec, device=dev)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    res = [float(o.rel_error_fro(w)) for o, w in zip(info.ops, ws)]
    row = {"phase": "factorize_batched", "shape": list(shape), "block": block, "seconds": seconds,
           "seconds_per_matrix": seconds / n, "rel_error_fro": res, "peak_memory_gb": peak,
           "stack_gb": ws.numel() * 4 / 1e9, "sweeps": info.n_sweeps, "op": repr(op),
           "s_tot": [o.s_tot for o in info.ops], "cache": vars(info.hierarchical.cache)}
    log(row)
    require(info.batched and len(info.ops) == n and op.kind == "block_diag", f"not the batched route: {row}")
    require(all(math.isfinite(r) and r < 1.0 for r in res), f"a batched factorization failed: {row}")
    seq = {}
    for i in check:
        i = i % n
        t0 = time.perf_counter()
        sop, sinfo = factorize(ws[i], spec, device=dev)
        if cuda:
            torch.cuda.synchronize()
        seq[i] = {"seconds": time.perf_counter() - t0, "rel_error_fro": float(sop.rel_error_fro(ws[i])),
                  "batched_rel_error_fro": res[i]}
        seq[i]["gap"] = abs(seq[i]["rel_error_fro"] - res[i])
        del sop, sinfo
    log({"phase": "factorize_sequential", "matrices": seq, "gap_max": BATCHED_RE_GAP})
    require(all(v["gap"] <= BATCHED_RE_GAP for v in seq.values()),
            f"batched and sequential RE differ by more than {BATCHED_RE_GAP}: {seq}")
    before = chain_matmul.launches
    g = torch.Generator(device=dev).manual_seed(5)
    errs = []
    for o in info.ops:
        x = torch.randn((batch, d_in), generator=g, device=dev)
        y = o.apply(x, "fused", device=dev)
        errs.append(rel_err(y, x @ o.todense())[1])
    launches = chain_matmul.launches - before
    row = {"phase": "factorize_batched_apply", "batch": batch, "rel_err_dense": errs, "k1_launches": launches}
    log(row)
    require(max(errs) <= DENSE_TOL, f"a batched operator's fused apply disagrees with x @ todense(): {row}")
    if cuda:
        require(launches == n, f"K1 did not run once per operator: {row}")
    del ws
    _free()
    return {"ops": info.ops, "seconds": seconds, "rel_error_fro": res, "peak_memory_gb": peak, "sequential": seq}


def noisy_image(size: int = 512, sigma: float = 30.0, seed: int = 0):
    """A cartoon-and-texture image (``benchmarks/common.py``'s
    ``piecewise_smooth_image``) plus Gaussian noise of std ``sigma``:
    (clean, noisy), numpy f32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = 80 * (x + y)
    for _ in range(6):
        cx, cy, rad, amp = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.3), rng.uniform(-70, 70)
        img += amp * ((x - cx) ** 2 + (y - cy) ** 2 < rad**2)
    img = np.clip(img + 15 * np.sin(14 * np.pi * x) * (y > 0.5), 0, 255).astype(np.float32)
    return img, (img + sigma * rng.standard_normal(img.shape)).astype(np.float32)


def _check_backends(name, op, dev, batches=(128,)) -> list[dict]:
    """Every feasible backend of a leaf against ``x @ op.todense()``."""
    import torch

    rows = []
    dense = op.todense()
    g = torch.Generator(device=dev).manual_seed(6)
    for b in batches:
        x = torch.randn((b, op.shape[0]), generator=g, device=dev)
        want = x @ dense
        for backend in op.feasible_backends():
            y = op.apply(x, backend, device=dev)
            rows.append({"strategy": name, "backend": backend, "batch": b, "rel_err_dense": rel_err(y, want)[1]})
            require(rows[-1]["rel_err_dense"] <= DENSE_TOL, f"{name} {backend} disagrees with x @ todense(): {rows[-1]}")
    return rows


def strategies(dev, w, meg=(204, 8193), image=512, n_patches=10_000, sweeps=(40, 40)) -> dict:
    """Phase 9: the other strategies at the paper's sizes.  ``"meg"`` on a
    204 × 8193 synthetic gain matrix (§V: J = 4, k = 10, s = 4·204);
    ``"dictionary"`` (Fig. 11) on 10,000 8×8 patches of a noisy 512 × 512
    image: a 64 × 128 MOD dictionary factorized with J = 4, k = 4
    (``benchmarks/denoising.py``'s spec) while its OMP codes are refit;
    the flat ``"palm4msa"`` on one up-projection ``w`` (block-column
    constraints as the block route's, 40 sweeps), also packed and applied
    fused.  For each: RE, seconds, every feasible backend against
    ``todense()``."""
    import torch

    from repro_torch.api import FactorizeSpec, factorize
    from repro_torch.core import dictionary as D
    from repro_torch.core import projections as P
    from repro_torch.core.hierarchical import HierarchicalSpec
    from repro_torch.data.synthetic import synthetic_leadfield

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    # "meg"
    m, n = meg
    g = torch.as_tensor(synthetic_leadfield(m, n), device=dev)
    t0 = time.perf_counter()
    op, info = factorize(g, FactorizeSpec(strategy="meg", n_factors=4, k=10, s=4 * m,
                                          n_iter_two=sweeps[0], n_iter_global=sweeps[1]), device=dev)
    sync()
    row = {"phase": "strategy", "strategy": "meg", "shape": [m, n], "seconds": time.perf_counter() - t0,
           "rel_error_fro": float(op.rel_error_fro(g)), "rel_error_spec": float(op.rel_error_spec(g)),
           "s_tot": op.s_tot, "rcg": op.rcg, "sweeps": info.n_sweeps,
           "applies": _check_backends("meg", op, dev)}
    log(row)
    require(math.isfinite(row["rel_error_fro"]) and row["rel_error_fro"] < 1.0, f"meg failed: {row}")
    out["meg"] = row
    # "dictionary"
    patch, atoms = 8, 128
    _, noisy = noisy_image(image)
    patches = D.extract_patches(torch.as_tensor(noisy, device=dev), patch)
    pick = torch.randperm(patches.shape[1], generator=torch.Generator().manual_seed(0))[:n_patches]
    y = patches[:, pick.to(dev)]
    y = y - y.mean(dim=0, keepdim=True)
    t0 = time.perf_counter()
    init = torch.randperm(y.shape[1], generator=torch.Generator().manual_seed(0))[:atoms]
    d_ddl, _ = D.learn_dictionary_mod(y, atoms, 5, 10, init)
    gamma0 = D.omp(y, d_ddl, 5)
    sync()
    ddl_s = time.perf_counter() - t0
    mm = patch * patch
    hier = HierarchicalSpec(
        tuple(P.make_proj("col", k=4) for _ in range(3)),
        tuple(P.make_proj("global", k=max(int(1.4 * mm * mm * 0.5 ** (ell - 1)), 2 * mm)) for ell in range(1, 4)),
        (mm,) * 3, n_iter_two=30, n_iter_global=30,
    )
    t0 = time.perf_counter()
    op, info = factorize(d_ddl, FactorizeSpec(strategy="dictionary", hier=hier, dict_y=y, dict_gamma0=gamma0,
                                              dict_sparse_coding=lambda yy, dd: D.omp(yy, dd, 5)), device=dev)
    sync()
    fit = lambda d, c: float(torch.linalg.norm(y - d @ c) / torch.linalg.norm(y))  # noqa: E731
    row = {"phase": "strategy", "strategy": "dictionary", "patches": list(y.shape), "atoms": atoms,
           "ddl_seconds": ddl_s, "seconds": time.perf_counter() - t0,
           "rel_error_fro": float(op.rel_error_fro(d_ddl)), "data_fit_ddl": fit(d_ddl, gamma0),
           "data_fit_faust": fit(op.todense(), info.gamma), "s_tot": op.s_tot, "rcg": op.rcg,
           "sweeps": info.n_sweeps, "applies": _check_backends("dictionary", op, dev)}
    log(row)
    require(math.isfinite(row["data_fit_faust"]) and row["data_fit_faust"] < 1.0, f"dictionary failed: {row}")
    out["dictionary"] = row
    # flat "palm4msa" on an up-projection, A = W (d_model ≤ d_ff: blockcol budgets)
    d_in, d_out = w.shape
    blk = 128 if d_in % 128 == 0 else 16
    projs = (P.make_proj("blockcol", bm=blk, bn=blk, k_per_col=4), P.make_proj("blockcol", bm=blk, bn=blk, k_per_col=4),
             P.make_proj("blockcol", bm=blk, bn=blk, k_per_col=max(d_in // blk // 2, 2)))
    t0 = time.perf_counter()
    op, info = factorize(w, FactorizeSpec(strategy="palm4msa", projs=projs, dims=(d_out, d_in, d_in, d_in),
                                          n_iter=sweeps[1]), device=dev)
    sync()
    packed = op.to("packed", block=blk)
    row = {"phase": "strategy", "strategy": "palm4msa", "shape": [d_in, d_out], "seconds": time.perf_counter() - t0,
           "rel_error_fro": float(op.rel_error_fro(w)), "s_tot": op.s_tot, "packed_s_tot": packed.s_tot,
           "sweeps": info.n_sweeps, "applies": _check_backends("palm4msa", op, dev)
           + _check_backends("palm4msa packed", packed, dev)}
    log(row)
    require(math.isfinite(row["rel_error_fro"]) and row["rel_error_fro"] < 1.0, f"palm4msa failed: {row}")
    out["palm4msa"] = row
    _free()
    return out


def compose(ops, batches=(128, 4096)) -> dict:
    """Phase 10: composites of two up-projections from phase 8:
    ``hstack`` (GeGLU's gate and up pair, 2048 → 32768), ``block_diag``,
    ``vstack`` and ``op.T @ op``, each at both batches in f32 and bf16
    through ``auto``, ``bsr`` and (where every leaf is fusable) ``fused``,
    against the dense product; K1 and K6 launches must rise."""
    import torch

    from repro_torch.api import block_diag, hstack, vstack
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul

    a, b = ops[0], ops[1]
    dev = a.device
    da, db = a.todense(), b.todense()
    cases = {
        "hstack": (hstack([a, b]), lambda x: torch.cat([x @ da, x @ db], -1)),
        "block_diag": (block_diag([a, b]), lambda x: torch.cat([x[:, :da.shape[0]] @ da, x[:, da.shape[0]:] @ db], -1)),
        "vstack": (vstack([a, b]), lambda x: x[:, :da.shape[0]] @ da + x[:, da.shape[0]:] @ db),
        "gram": (a.T @ a, lambda x: (x @ da.T) @ da),
    }
    k1, k6 = chain_matmul.launches, bsr_matmul.launches
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, (op, dense) in cases.items():
        backends = ("auto", "bsr") + (("fused",) if all(not leaf.adjoint for leaf in op.leaves()) else ())
        for bsz in batches:
            x32 = torch.randn((bsz, op.shape[0]), generator=g, device=dev)
            want = dense(x32)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                for backend in backends:
                    y = op.apply(x32.to(dtype), backend, device=dev)
                    err = rel_err(y, want)[1]
                    row = {"phase": "compose", "op": name, "shape": list(op.shape), "batch": bsz, "dtype": dname,
                           "requested": backend, "rel_err_dense": err, "dtype_out": str(y.dtype)}
                    rows.append(row)
                    require(tuple(y.shape) == (bsz, op.shape[1]) and y.dtype == dtype, f"bad output: {row}")
                    require(err <= (DENSE_TOL if dtype == torch.float32 else TOL[dname]),
                            f"{name} {backend} disagrees with the dense product: {row}")
    launches = {"chain_matmul": chain_matmul.launches - k1, "bsr_matmul": bsr_matmul.launches - k6}
    log({"phase": "compose", "rows": rows, "launches": launches})
    if dev.type == "cuda":
        require(all(v > 0 for v in launches.values()), f"a composite never ran K1 or K6: {launches}")
    return {"launches": launches, "max_rel_err": max(r["rel_err_dense"] for r in rows)}


def grad_dispatch(ops: dict, card_line: str, batches=(128, 4096)) -> list[dict]:
    """Phase 11: measured dispatch under grad.  A fresh table under
    ``build/`` filled by ``apply(autotune=True)`` in training applies (x
    and the values, or the scales, require grad) for the f32 and the int8
    per-block operator, f32 and bf16 x, both batches; ``auto`` under grad
    must then read the table, pick the fastest measured backend, and run
    fwd+bwd within ``AUTO_SLACK`` of that backend forced, at the table's
    fused tile or at the default tile, whichever is faster: a table whose
    tile is slower than the default fails.  Times are medians of single
    calls that alternate the three variants (800 calls each at B < 1024,
    60 above)."""
    import torch

    from repro_torch.api import autotune, dispatch, last_report

    table = ROOT / "build" / "chip_smoke_grad_autotune.json"
    table.unlink(missing_ok=True)
    saved = {k: os.environ.get(k) for k in ("REPRO_TORCH_AUTOTUNE_TABLE", "REPRO_AUTOTUNE")}
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = str(table)
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.reload()
    rows = []
    g = torch.Generator().manual_seed(8)
    try:
        for name, op in ops.items():
            dev = op.device
            top, _ = _trainable(op)
            for bsz in batches:
                for dtype in (torch.float32, torch.bfloat16):
                    dname = str(dtype).removeprefix("torch.")
                    x = torch.randn((bsz, op.shape[0]), generator=g).to(dev, dtype).requires_grad_(True)
                    w = torch.randn((bsz, op.shape[1]), generator=g).to(dev, dtype)
                    model = top.dispatch_for(bsz, dtype, grad=True)
                    top.apply(x, autotune=True, device=dev).backward(w)
                    key = autotune.key_for_op(top, batch=bsz, dtype=dtype, grad=True)
                    entry = autotune.lookup(key)
                    require(entry is not None, f"{name} {dname} B={bsz}: no grad key after apply(autotune=True)")
                    top.apply(x, device=dev).backward(w)
                    rep = last_report()
                    fastest = min(entry["us"], key=lambda k: (entry["us"][k], dispatch._ORDER[k]))
                    # in turns: auto; its pick forced at the table's tile (what
                    # auto adds: the decision); and at the default tile (what the
                    # table's tile buys)
                    runs = {"auto": lambda: top.apply(x, device=dev).backward(w),
                            "forced": lambda: top.apply(x, rep.backend, device=dev, bt=rep.bt).backward(w),
                            "forced_default_tile": lambda: top.apply(x, rep.backend, device=dev).backward(w)}
                    # a bf16 step at B = 128 is host-paced, and a sample of 20
                    # consecutive calls read 0.48-1.8 ms for the same work as the
                    # host's load moved: the variants alternate call by call
                    # and each one's median over 800 (B < 1024) or 60 calls is
                    # compared
                    timing = interleaved_ms(runs, 800 if bsz < 1024 else 60)
                    med = {k: statistics.median(v) for k, v in timing.items()}
                    auto_ms = med["auto"]
                    forced_ms = min(med["forced"], med["forced_default_tile"])
                    row = {"phase": "grad_dispatch", "card": card_line, "op": name, "dtype": dname, "batch": bsz,
                           "key": key, "entry": entry, "report": rep.as_row(), "model_pick": model.backend,
                           "auto_fwd_bwd_ms": auto_ms, "forced_fwd_bwd_ms": med["forced"],
                           "forced_default_tile_ms": med["forced_default_tile"],
                           "calls": len(timing["auto"]),
                           "quantiles_ms": {k: [_pct(v, q) for q in (0, 0.1, 0.5, 0.9, 1)]
                                            for k, v in timing.items()},
                           "auto_over_forced": auto_ms / forced_ms}
                    log(row)
                    require(rep.grad and rep.source == "measured", f"auto under grad did not read the table: {row}")
                    require(rep.backend == fastest, f"auto under grad did not pick the fastest measured backend: {row}")
                    require(auto_ms <= AUTO_SLACK * forced_ms,
                            f"auto under grad is slower than its pick forced at the better tile: {row}")
                    rows.append(row)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reload()
    return rows


# ---------------------------------------------------------------------------
# Slice 8: serving and streaming refresh (phase 13)
# ---------------------------------------------------------------------------

SERVE_TOL = {"bfloat16": 3e-2, "float32": 1e-4}  # teacher-forced: chosen logit within tol·max|logits| of the max
SERVE_SLOTS, SERVE_MAX_LEN = 8, 1088  # prompts ≤ 1000 plus ≤ 64 new tokens
SERVE_LAYERS = 4  # phase 13's depth, of gemma-2b's 18: keeps the whole script well inside its time limit
STREAM_SWEEPS = 10  # n_iter_two = n_iter_global: the reference's defaults are 40/40
STREAM_DRIFT = 1e-2  # ‖εG‖ / ‖W0‖


def serve_config(**kw):
    """gemma-2b at full width, ``SERVE_LAYERS`` deep, with the trainer's
    FAµST unembedding (2048 → 2048 → 256000, block 16, k 4), untied, bf16."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.layers.faust_linear import FaustSpec

    return dataclasses.replace(get_config("gemma_2b"), faust_unembed=FaustSpec(2, 16, 4), tie_embeddings=False,
                               n_layers=SERVE_LAYERS, stages=((SERVE_LAYERS, ("attn",)),), **kw)


def _serve_counts() -> dict:
    from repro_torch.kernels.bsr_matmul import bsr_matmul
    from repro_torch.kernels.chain import chain_matmul

    return {"chain_matmul": chain_matmul.launches, "bsr_matmul": bsr_matmul.launches,
            "chain_matmul_q": chain_matmul.q_launches}


def _pct(values, q: float) -> float | None:
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q
    lo, hi = math.floor(pos), math.ceil(pos)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def _trace(n_req: int, seed: int, lengths: tuple, budgets: tuple, fixed: tuple, vocab: int, codebooks: int = 1):
    """Prompts (numpy seed ``seed``, lengths uniform over ``lengths`` with
    the first ``len(fixed)`` set to ``fixed``; ``(codebooks, n)`` each for
    an audio model) and budgets."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lengths[0], lengths[1] + 1, size=n_req)
    lens[:len(fixed)] = fixed
    budget = rng.integers(budgets[0], budgets[1] + 1, size=n_req)
    shape = (lambda n: int(n)) if codebooks == 1 else (lambda n: (codebooks, int(n)))
    prompts = [rng.integers(0, vocab, size=shape(n)).astype(np.int32) for n in lens]
    return prompts, [int(b) for b in budget]


def _vision_extras(cfg, n_req: int, seed: int) -> list[dict]:
    """Each request's own ``vision_embeds (n_vision_tokens, d_model)``,
    f32 N(0, 1) × 0.02 from numpy ``seed`` (the data pipeline's stand-in
    patch embeddings); empty dicts for a model without vision tokens."""
    import numpy as np

    if not cfg.n_vision_tokens:
        return [{} for _ in range(n_req)]
    rng = np.random.default_rng(seed)
    return [{"vision_embeds": rng.standard_normal((cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
             * np.float32(0.02)} for _ in range(n_req)]


def drive(engine, prompts, budgets, first: int, every: tuple[int, int] | None = None,
          evict_step: int | None = None, extras: list | None = None) -> tuple[list[str], int]:
    """Submit ``first`` requests, then ``every[1]`` more every ``every[0]``
    engine steps; evict the lowest-slot live request at ``evict_step`` (or
    the first step after it with one live); step until every request is
    submitted and finished.  ``extras`` are the requests' side inputs.
    Returns the rids and the steps taken."""
    extras = extras or [{} for _ in prompts]

    def submit(lo, hi):
        return [engine.submit(prompts[i], budgets[i], extras=extras[i]) for i in range(lo, min(hi, len(prompts)))]

    rids = submit(0, first)
    step, evicted = 0, False
    while engine.n_pending or len(rids) < len(prompts):
        if every and step and step % every[0] == 0 and len(rids) < len(prompts):
            rids += submit(len(rids), len(rids) + every[1])
        if evict_step is not None and step >= evict_step and not evicted and engine.running:
            victim = min(engine.running.values(), key=lambda r: r.slot)
            require(engine.evict(victim.rid), f"eviction of {victim.rid} refused")
            evicted = True
        engine.step()
        step += 1
        require(step < 100_000, "the engine did not drain")
    return rids, step


@contextlib.contextmanager
def faust_backend(model, backend: str, head_only: bool = False):
    """Every ``FaustLinear`` of ``model`` (or only its unembedding) forced
    to ``backend``; restored on exit."""
    from repro_torch.layers.faust_linear import FaustLinear

    mods = [model.unembed.faust] if head_only else [m for m in model.modules() if isinstance(m, FaustLinear)]
    saved = [m.backend for m in mods]
    for m in mods:
        m.backend = backend
    try:
        yield
    finally:
        for m, b in zip(mods, saved):
            m.backend = b


def teacher_forced(model, engine, rids, prompts, tol: float, routes=None, exact=None,
                   enforce: bool = True, extras: list | None = None) -> dict:
    """For each request, ``forward_train`` under ``no_grad`` over prompt +
    generated, with every FAµST projection on the dense backend (``x @
    todense()``, no K1 or K6), so the served tokens are held against a path
    that runs none of the kernels: at every generated position the chosen
    token's logit must lie within ``tol·max|logits|`` of that row's
    maximum.  Counts the positions where it was the exact argmax.
    Attention and the SSD each take the whole sequence as one chunk (any
    length; the SSD's chunking changes its result only by rounding), so
    the served run's prefill, replays and decode steps are held against
    one chunked pass.

    ``routes`` (a MoE model's :meth:`RoutedExecutor.choices`, one per
    request) makes the reference send each token to the experts the served
    run chose (``repro_torch.layers.moe.top_experts`` replaced while it
    runs): rounding moves the router's logits of the two paths apart, and
    where two experts nearly tie that flips a choice and, with it, a
    token's whole expert output.  Each (layer, position) pair whose served
    choice differs from the reference's own is a ``routing_flip``, and must
    be a near-tie: the least f32 router probability, in the reference, of
    the experts it was sent to lies within ``ROUTE_TIE_TOL`` (relative) of
    the reference's own k-th largest.  A routing fault on the serving side
    sends tokens to experts far below that.

    ``exact`` (an f32 copy of a bf16 ``model``, :func:`exact_copy`) is the
    reference instead: the exact function of the served weights.  Over
    64-81 random mamba layers bf16's own rounding moves the logits by
    several 1e-2 of max|logits|: the bf16 one-pass forward lands that far
    from the f32 one, and two bf16 passes (served, one-pass) that far from
    each other (PERF.md §6).  So a served token may trail the f32 row's
    maximum by more than ``tol`` only where the row is a tie at bf16's
    resolution: its gap at most ``SSM_TIE`` times that row's error of the
    bf16 one-pass forward (max|bf16 − f32| / max|f32|), as two bf16 passes
    each that far off can swap candidates that close; and such ties are
    rare, at most ``SSM_TIE_SHARE`` of the positions.  A served path that
    computes another function trails by more, and at more positions (the
    planted faults of :func:`planted_fault`).  Reports the positions each
    clause holds, the ties' share, the worst gap over error of the ties
    and of the positions neither holds, and the bf16 rows' own gap beside
    them.

    A vision model's requests are held with their own ``extras``
    (``vision_embeds``) on both sides.  An audio model's prompts and
    outputs are ``(K, n)``: every codebook's token at every position is
    held against its head's logits, and each clause (the ties' share
    too) must hold for every codebook on its own; ``codebooks`` reports
    each one's counts.

    ``enforce=False`` returns the verdict (``passed``) instead of failing."""
    import numpy as np
    import torch

    from repro_torch.layers import moe as moe_mod

    require(routes is None or exact is None, "teacher_forced: one reference, routed or exact")
    dev = model.embed.table.device
    extras = extras or [{} for _ in prompts]
    gaps, errs, own, books = [], [], [], []
    exact_argmax = 0
    flips = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    tie_gap = torch.zeros((), dtype=torch.float32, device=dev)
    real_top = moe_mod.top_experts
    for i, (rid, prompt) in enumerate(zip(rids, prompts)):
        gen = engine.result(rid)
        full = np.concatenate([prompt, gen], axis=-1).astype(np.int64)  # (L,) or (K, L)
        if routes is not None:
            forced = [torch.as_tensor(c[:len(full)], device=dev) for c in routes[i]]
            layer = iter(range(len(forced)))

            def replay(probs, k):
                nonlocal flips, pairs, tie_gap
                want = forced[next(layer)][None]
                pairs = pairs + (want[..., 0] >= 0).sum()
                own = real_top(probs, k)  # descending: the k-th largest last
                use = torch.where(want >= 0, want, own)
                flipped = (use.sort(dim=-1).values != own.sort(dim=-1).values).any(dim=-1)
                kth = probs.gather(-1, own[..., -1:])
                gap = (kth - probs.gather(-1, use)).amax(dim=-1) / kth[..., 0]
                flips = flips + flipped.sum()
                tie_gap = torch.maximum(tie_gap, torch.where(flipped, gap, 0.0).amax())
                return use

            moe_mod.top_experts = replay
        tokens = torch.as_tensor(full, device=dev)[None]
        n_prompt, n_gen, length = prompt.shape[-1], gen.shape[-1], full.shape[-1]
        rows = slice(n_prompt - 1, n_prompt - 1 + n_gen)
        side = {k: torch.as_tensor(v, device=dev)[None] for k, v in extras[i].items()}
        try:
            with torch.no_grad(), faust_backend(model, "dense"):
                b = model.forward_train(tokens, chunk=length, **side)[0, rows]
                if exact is not None:
                    with faust_backend(exact, "dense"):
                        f = exact.forward_train(tokens, chunk=length, **side)[0, rows]
        finally:
            moe_mod.top_experts = real_top
        k = gen.shape[0] if gen.ndim == 2 else 1
        # every (position, codebook) as one row: logits (n, K, V) → (n·K, V), tokens (K, n) → (n·K,)
        b = b.reshape(n_gen * k, -1)
        f = f.reshape(n_gen * k, -1) if exact is not None else None
        ref = b if exact is None else f
        chosen = torch.as_tensor(np.asarray(gen).T.reshape(-1), device=dev, dtype=torch.int64)[:, None]
        books.append(torch.arange(k, device=dev).repeat(n_gen))
        scale = ref.abs().amax(dim=-1).clamp_min(1e-30)
        gaps.append((ref.amax(dim=-1) - ref.gather(1, chosen)[:, 0]) / scale)
        if exact is not None:
            errs.append((b - f).abs().amax(dim=-1) / scale)
            own.append((b.amax(dim=-1) - b.gather(1, chosen)[:, 0]) / b.abs().amax(dim=-1).clamp_min(1e-30))
        exact_argmax += int((ref.argmax(dim=-1) == chosen[:, 0]).sum())
        del b, ref
    gap, book = torch.cat(gaps), torch.cat(books)
    within = gap <= tol
    out = {"positions": int(gap.numel()), "exact_argmax": exact_argmax, "worst_gap_rel": float(gap.max()),
           "tol": tol, "reference": "dense"}
    ok = bool(within.all())
    tie = over = None
    if exact is not None:
        err = torch.cat(errs).clamp_min(1e-30)
        tie = ~within & (gap <= SSM_TIE * err)
        over = ~within & ~tie
        ratio = gap / err
        out.update(reference="f32 copy, dense", within_tol=int(within.sum()), bf16_ties=int(tie.sum()),
                   beyond=int(over.sum()), tie_factor=SSM_TIE, tie_share=float(tie.float().mean()),
                   tie_share_max=SSM_TIE_SHARE,
                   worst_tie_gap_over_err=float(ratio[tie].max()) if bool(tie.any()) else None,
                   worst_beyond_gap_over_err=float(ratio[over].max()) if bool(over.any()) else None,
                   bf16_err_rel={"max": float(err.max()), "median": float(err.median())},
                   bf16_vs_bf16_worst_gap_rel=float(torch.cat(own).max()))
        ok = not bool(over.any()) and out["tie_share"] <= SSM_TIE_SHARE
    if int(book.max()) > 0:  # per codebook: each must pass on its own
        out["codebooks"] = []
        for k in range(int(book.max()) + 1):
            mine = book == k
            rec = {"codebook": k, "positions": int(mine.sum()), "within_tol": int((within & mine).sum()),
                   "worst_gap_rel": float(gap[mine].max())}
            passed = bool(within[mine].all())
            if exact is not None:
                rec.update(bf16_ties=int((tie & mine).sum()), beyond=int((over & mine).sum()),
                           tie_share=float(tie[mine].float().mean()))
                passed = rec["beyond"] == 0 and rec["tie_share"] <= SSM_TIE_SHARE
            rec["passed"] = passed
            out["codebooks"].append(rec)
            ok = ok and passed
    if routes is not None:
        out.update(reference="dense, the served run's expert choices", routing_pairs=int(pairs),
                   routing_flips=int(flips), routing_flip_share=int(flips) / max(int(pairs), 1),
                   routing_flip_worst_prob_gap=float(tie_gap), routing_tie_tol=ROUTE_TIE_TOL)
        require(out["routing_flip_worst_prob_gap"] <= ROUTE_TIE_TOL,
                f"a served expert choice is no near-tie of the reference's: {out}")
    out["passed"] = ok
    if enforce:
        require(ok, f"teacher-forced check failed: {out}")
    return out


class RoutedExecutor:
    """An executor proxy that records every MoE layer's expert choices of a
    served run by request and position, for :func:`teacher_forced`.  Each
    forward says which (request, first position) its rows are, and
    ``repro_torch.layers.moe.route`` is wrapped (:meth:`recording`) to keep
    the ``dest`` of each call: no device work is added.  Prompts above
    ``attn_chunk`` must be multiples of it (a ragged one would replay its
    tail inside the prefill, unrecorded)."""

    def __init__(self, inner, prompts):
        import numpy as np

        self.inner = inner
        self._index = {np.asarray(p).tobytes(): i for i, p in enumerate(prompts)}
        self._n_prompts = len(prompts)
        self._slot = {}  # slot → [request, next position]
        self._calls = []  # per forward: its rows and each MoE layer's (dest, capacity)
        self._cur = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill_forward(self, slot, prompt, extras):
        import numpy as np

        n, chunk = len(prompt), self.inner.cfg.attn_chunk
        require(n <= chunk or n % chunk == 0, f"a ragged prefill of {n} tokens is not recorded")
        req = self._index[np.asarray(prompt).tobytes()]
        self._slot[slot] = [req, n]
        self._cur = {"rows": [(req, 0)], "layers": []}
        self._calls.append(self._cur)
        return self.inner.prefill_forward(slot, prompt, extras)

    def decode_forward(self, slots, tokens):
        self._cur = {"rows": [tuple(self._slot[s]) for s in slots], "layers": []}
        for s in slots:
            self._slot[s][1] += 1
        self._calls.append(self._cur)
        return self.inner.decode_forward(slots, tokens)

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.layers import moe as moe_mod

        real = moe_mod.route

        def route(logits, spec):
            r = real(logits, spec)
            self._cur["layers"].append((r.dest, moe_mod.capacity_per_group(logits.shape[1], spec), spec.top_k))
            return r

        moe_mod.route = route
        try:
            yield self
        finally:
            moe_mod.route = real

    def choices(self, length: int) -> list[list]:
        """Per request, per MoE layer: ``(length, k)`` expert ids by
        position, −1 where the served run computed none."""
        import numpy as np

        out = None
        for call in self._calls:
            for layer, (dest, c, k) in enumerate(call["layers"]):
                experts = (dest.cpu().numpy() // c).reshape(dest.shape[0], -1, k)
                if out is None:
                    out = [[np.full((length, k), -1, np.int64) for _ in call["layers"]]
                           for _ in range(self._n_prompts)]
                for (req, pos), e in zip(call["rows"], experts):
                    out[req][layer][pos:pos + len(e)] = e
        return out


def weight_bound(model, batch: int) -> dict:
    """The decode step's weight bytes (every parameter read once but the
    embedding table, of which the step reads ``batch`` rows) over the
    card's memory rate."""
    table = model.embed.table
    byts = sum(p.numel() * p.element_size() for n, p in model.named_parameters() if n != "embed.table")
    byts += sum(b.numel() * b.element_size() for b in model.buffers())
    byts += batch * table.shape[1] * table.element_size()
    return {"weight_bytes": byts, "weight_bound_ms": byts / HBM_BW * 1e3}


def engine_report(name: str, card_line: str, engine, steps: int, counts: dict, wall_s: float) -> dict:
    import torch

    es = engine.stats
    states = {}
    for r in engine.done.values():
        states[r.state] = states.get(r.state, 0) + 1
    ttft, tpot = list(es.ttft_s.values()), list(es.tpot_s.values())
    row = {"phase": name, "card": card_line, "requests": len(engine.done), "states": states,
           "prefill_s": es.prefill_s, "decode_s": es.decode_s, "wall_s": wall_s,
           "tokens_decoded": es.tokens_decoded,
           # end to end: every token the run delivered over its wall time;
           # decode_tokens_per_s is the decode layer's rate (decode_s only)
           "tokens_per_s": es.tokens_decoded / wall_s, "decode_tokens_per_s": es.tokens_per_s,
           "ttft_p50_s": _pct(ttft, 0.5), "ttft_p90_s": _pct(ttft, 0.9),
           "tpot_p50_s": _pct(tpot, 0.5), "tpot_p90_s": _pct(tpot, 0.9),
           "steps": es.steps, "drive_steps": steps, "occupancy": dict(sorted(es.occupancy.items())),
           "admitted": es.admitted, "completed": es.completed, "evicted": es.evicted, "swaps": es.swaps,
           "swap_rejects": es.swap_rejects, "retries": es.retries, "failed": es.failed,
           "quarantined": es.quarantined, "timed_out": es.timed_out, "rejected": es.rejected,
           "demotions": es.demotions, "backend_counts": es.backend_counts(),
           "faust_dispatch": None if es.faust_dispatch is None else es.faust_dispatch.as_row(),
           "launches": counts, "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    require(states == {"done": len(engine.done)}, f"{name}: not every request is done: {row}")
    bad = {k: row[k] for k in ("retries", "failed", "quarantined", "timed_out", "rejected") if row[k]}
    require(not bad, f"{name}: the supervision fired in a zero-fault run: {bad}")
    return row


def serve_run(name: str, card_line: str, model, n_req: int, lengths: tuple, budgets: tuple, fixed: tuple = (),
              first: int | None = None, every=None, evict_step=None, seed: int = 0, check: bool = True,
              kernels: bool = True, max_len: int = SERVE_MAX_LEN, exact=None, mesh=None) -> dict:
    """One engine over ``model`` (``SERVE_SLOTS`` slots of ``max_len``
    tokens, on ``mesh`` when given): the trace of :func:`_trace` through
    :func:`drive` (a vision model's requests each with its own
    :func:`_vision_extras`), K1/K6 counters zeroed before and read after,
    the report, and (``check``) the teacher-forced check of every request
    (against ``exact``, an f32 copy, when given)."""
    import torch

    from repro_torch.runtime.engine import Engine, LMExecutor

    cfg = model.cfg
    prompts, budget = _trace(n_req, seed, lengths, budgets, fixed, cfg.vocab, cfg.n_codebooks)
    extras = _vision_extras(cfg, n_req, seed + 1000)
    torch.cuda.reset_peak_memory_stats()
    ex = LMExecutor(model, max_len, SERVE_SLOTS, mesh=mesh)
    moe = check and model.cfg.moe is not None
    if moe:  # the MoE reference replays the served expert choices (teacher_forced)
        ex = RoutedExecutor(ex, prompts)
    engine = Engine(ex)
    _zero_counts()
    t0 = time.perf_counter()
    with ex.recording() if moe else contextlib.nullcontext():
        rids, steps = drive(engine, prompts, budget, first or n_req, every, evict_step, extras)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _serve_counts()
    row = engine_report(name, card_line, engine, steps, counts, wall_s)
    row["prompt_lengths"] = [p.shape[-1] for p in prompts]
    if evict_step is not None:
        require(engine.stats.evicted == 1, f"{name}: {engine.stats.evicted} evictions, want 1")
    if kernels:
        require(counts["chain_matmul"] + counts["bsr_matmul"] > 0, f"{name}: serving launched neither K1 nor K6: {row}")
    if check:
        routes = ex.choices(max_len) if moe else None
        row["teacher_forced"] = teacher_forced(model, engine, rids, prompts, SERVE_TOL[model.cfg.dtype], routes,
                                               exact=exact, extras=extras)
    log(row)
    return {"row": row, "engine": engine, "rids": rids, "prompts": prompts, "extras": extras}


def profile_decode(card_line: str, model, batch: int = SERVE_SLOTS, prompt_len: int = 256) -> dict:
    """One steady decode step at ``batch`` live rows under
    ``torch.profiler``: host time, device busy time and idle share, device
    time by kernel family, beside the weight-bytes bound."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.engine import LMExecutor

    ex = LMExecutor(model, SERVE_MAX_LEN, batch)
    rng = np.random.default_rng(3)
    for slot in range(batch):
        ex.prefill_forward(slot, rng.integers(0, model.cfg.vocab, size=prompt_len).astype(np.int32), {})
    slots, toks = list(range(batch)), rng.integers(0, model.cfg.vocab, size=(batch, 1))
    for _ in range(2):
        ex.decode_forward(slots, toks)
    _zero_counts()
    t0 = time.perf_counter()
    ex.decode_forward(slots, toks)
    step_s = time.perf_counter() - t0
    counts = _serve_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.decode_forward(slots, toks)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    row = {"phase": "serve_profile", "card": card_line, "dtype": model.cfg.dtype, "batch": batch,
           "prompt_len": prompt_len, "unprofiled_step_s": step_s, "launches_per_step": counts,
           **device_spans(prof, prof_s), **weight_bound(model, batch)}
    log(row)
    return row


def _factor_walk(fn, x, bf):
    """``x`` through every factor of ``bf`` by ``fn`` (K6 or its plain
    version), λ left out."""
    for f in bf.factors:
        x = fn(x, f.values, f.in_idx)
    return x


def check_chains(card_line: str, dev, phase: str, chains: dict, batches) -> list[dict]:
    """K1 and K6 on the serving model's chains (name → ``BlockFaust``, in
    the model's dtype) at the batches its path gives them, each against its
    plain version on the same card tensors: K1 at the tile ``auto``
    reports, K6 factor by factor on the kernel's own input.  One K1 launch
    and one K6 launch a factor per check, counted."""
    import torch

    from repro_torch.api import FaustOp
    from repro_torch.core.compress import pack_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.chain import chain_matmul, chain_matmul_plain
    from repro_torch.kernels.ops import chain_meta

    g = torch.Generator().manual_seed(13)
    rows = []
    for name, bf in chains.items():
        with torch.no_grad():
            pc = pack_chain(bf)
            meta = chain_meta(pc.plan, pc.in_idx)
            op = FaustOp(bf)
            dtype = pc.values.dtype
            dname = str(dtype).removeprefix("torch.")
            for b in batches:
                x = torch.randn((b, op.shape[0]), generator=g).to(dev, dtype)
                bt = op.dispatch_for(b, dtype).bt
                _zero_counts()
                k1_err, k1_rel = rel_err(chain_matmul(x, pc.values, meta, plan=pc.plan, bt=bt),
                                         chain_matmul_plain(x, pc.values, meta, plan=pc.plan))
                h, k6_rel = x, 0.0
                for f in bf.factors:
                    hk = bsr_matmul(h, f.values, f.in_idx)
                    k6_rel = max(k6_rel, rel_err(hk, bsr_matmul_plain(h, f.values, f.in_idx))[1])
                    h = hk
                torch.cuda.synchronize()
                counts = _serve_counts()
                row = {"phase": phase, "card": card_line, "chain": name, "dtype": dname, "batch": b, "bt": bt,
                       "k1_max_abs_err": k1_err, "k1_rel_err": k1_rel, "k6_rel_err": k6_rel, "tol": TOL[dname],
                       "launches": counts}
                log(row)
                require(counts["chain_matmul"] == 1 and counts["bsr_matmul"] == len(bf.factors),
                        f"{name} at B = {b}: launches {counts}")
                require(k1_rel <= TOL[dname] and k6_rel <= TOL[dname],
                        f"{name} {dname} at B = {b}: K1 {k1_rel}, K6 {k6_rel} against their plain versions")
                rows.append(row)
    return rows


def serve_head(card_line: str, dev, model) -> list[dict]:
    """Phase 13c: the model's unembedding chain in bf16 at decode batches:
    K1 and K6 against their plain versions (:func:`check_chains`),
    ``apply`` on every backend and ``auto``, beside the bound and
    ``torch.matmul`` on the dense head."""
    import torch

    from repro_torch.api import FaustOp
    from repro_torch.core.compress import pack_chain
    from repro_torch.kernels.bsr_matmul import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.chain import chain_matmul, chain_matmul_plain
    from repro_torch.kernels.ops import chain_meta
    from repro_torch.runtime.engine import unembed_blockfaust

    bf = unembed_blockfaust(model)
    require(bf.factors[0].values.dtype == torch.bfloat16, "serve_head times the bf16 head")
    checks = check_chains(card_line, dev, "serve_head_check", {"unembed": bf}, (1, 3, 8))
    op = FaustOp(bf)
    pc = pack_chain(bf)
    meta = chain_meta(pc.plan, pc.in_idx)
    s_tot = pc.values.numel()
    m, n = op.shape
    with torch.no_grad():
        a_dense = bf.todense().to(torch.bfloat16)
    g = torch.Generator().manual_seed(13)
    rows = []
    for b, chk in zip((1, 3, 8), checks):
        x = torch.randn((b, m), generator=g).to(dev, torch.bfloat16)
        flops, byts = 2.0 * b * s_tot, 2.0 * (s_tot + b * (m + n))
        t_ops, t_bytes = flops / PEAK["bfloat16"], byts / HBM_BW
        with torch.no_grad():
            row = {"phase": "serve_head", "card": card_line, "batch": b, "dtype": "bfloat16", "s_tot": s_tot,
                   **{k: chk[k] for k in ("k1_max_abs_err", "k1_rel_err", "k6_rel_err")},
                   "k1_ms": time_ms(lambda: chain_matmul(x, pc.values, meta, plan=pc.plan)),
                   "k1_plain_ms": time_ms(lambda: chain_matmul_plain(x, pc.values, meta, plan=pc.plan)),
                   "k6_ms": time_ms(lambda: _factor_walk(bsr_matmul, x, bf)),
                   "k6_plain_ms": time_ms(lambda: _factor_walk(bsr_matmul_plain, x, bf)),
                   **{f"apply_{bk}_ms": time_ms(lambda bk=bk: op.apply(x, bk, device=dev))
                      for bk in ("fused", "bsr", "dense", "auto")},
                   "auto_pick": op.dispatch_for(b, torch.bfloat16).backend,
                   "library_ms": time_ms(lambda: torch.matmul(x, a_dense)),
                   "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "dense_head_bytes": a_dense.numel() * 2}
        log(row)
        rows.append(row)
    del a_dense
    return rows


def serve_forced(card_line: str, model) -> dict:
    """Phase 13c: the engine with the head's backend forced to fused, bsr
    and dense in turn (8 requests, prompts ≤ 256, 16 tokens): TPOT each;
    the first decode step's logits of fused and bsr against dense."""
    import numpy as np
    import torch

    from repro_torch.runtime.engine import LMExecutor

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, size=n).astype(np.int32) for n in (100, 37)]
    out, logits = {}, {}
    for backend in ("fused", "bsr", "dense"):
        with faust_backend(model, backend, head_only=True):
            res = serve_run(f"serve_forced_{backend}", card_line, model, 8, (32, 256), (16, 16), seed=2, check=False,
                            kernels=backend != "dense")
            out[backend] = {k: res["row"][k] for k in ("tpot_p50_s", "tpot_p90_s", "tokens_per_s", "launches")}
            ex = LMExecutor(model, 64, 2)
            for slot, p in enumerate(prompts):
                ex.prefill_forward(slot, p, {})
            logits[backend] = ex.decode_forward([0, 1], [[11], [12]]).float()
    require(out["bsr"]["launches"]["bsr_matmul"] > 0, f"the forced-bsr engine launched no K6: {out}")
    require(out["fused"]["launches"]["chain_matmul"] > 0, f"the forced-fused engine launched no K1: {out}")
    errs = {b: rel_err(logits[b], logits["dense"])[1] for b in ("fused", "bsr")}
    row = {"phase": "serve_forced", "card": card_line, "backends": out, "first_step_rel_err_vs_dense": errs}
    log(row)
    require(all(e <= TOL["bfloat16"] for e in errs.values()), f"forced heads disagree with dense: {row}")
    return row


def serve_stream(card_line: str, dev, model, engine) -> dict:
    """Phase 13e: streaming refresh of the head into the live engine of
    (a).  Cold-track ``W0`` (the head's f32 ``todense()``) at
    ``STREAM_SWEEPS`` sweeps, publish the tracked chain (a staged re-pack),
    drift ``W1 = W0 + εG``, ``update``, guarded ``hot_swap`` of the refresh
    between two steps while requests are live, four more requests after it
    (teacher-forced against the swapped model), a regressed chain rejected,
    and the refresh through ``quantized_swap`` applied by K4."""
    from dataclasses import asdict

    import numpy as np
    import torch

    from repro_torch.api import FaustOp
    from repro_torch.core.compress import pack_chain, quantize_chain
    from repro_torch.kernels.chain import chain_matmul, chain_matmul_q_plain
    from repro_torch.kernels.ops import chain_meta
    from repro_torch.layers.faust_linear import factorize_spec
    from repro_torch.runtime import faults
    from repro_torch.streaming import StreamingConfig, StreamingFaust, hot_swap
    from repro_torch.streaming.swap import quantized_swap, refreshed_chain, sketched_swap_err

    ex = engine.executor
    head0 = ex.unembed_blockfaust()
    with torch.no_grad():
        w0 = head0.to(dtype=torch.float32).todense()
    spec = factorize_spec(model.cfg.faust_unembed, STREAM_SWEEPS, STREAM_SWEEPS)
    # the cold fit's own RE exceeds the default full_above (0.5): a drift
    # estimate includes it, so 2.0 keeps a 1 % drift on the warm path
    scfg = StreamingConfig(full_above=2.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sf = StreamingFaust.track(w0, spec, scfg, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    with torch.no_grad():
        re_cold = float(sf.op.rel_error_fro(w0))
    cold = refreshed_chain(sf, like=head0)
    cold_vs_head = sketched_swap_err(head0, cold)
    g = torch.Generator(device=dev).manual_seed(1)
    noise = torch.randn(w0.shape, generator=g, device=dev)
    eps = STREAM_DRIFT * float(torch.linalg.norm(w0)) / float(torch.linalg.norm(noise))
    w1 = w0 + eps * noise
    del noise
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab, size=int(n)).astype(np.int32) for n in rng.integers(32, 257, size=8)]
    budgets = [32] * 4 + [16] * 4
    before = [engine.submit(p, b) for p, b in zip(prompts[:4], budgets[:4])]
    engine.step()
    publish = hot_swap(engine, cold)  # the serving head is what the tracker published
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = sf.update(w1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with torch.no_grad():
        re_w1, re_w0 = float(sf.op.rel_error_fro(w1)), float(sf.op.rel_error_fro(w0))
    chain = refreshed_chain(sf, like=ex.unembed_blockfaust())
    old = ex.unembed_blockfaust()
    live = len(engine.running)
    swap = hot_swap(engine, chain, guard=0.5)
    after = [engine.submit(p, b) for p, b in zip(prompts[4:], budgets[4:])]
    rejected = hot_swap(engine, faults.regressed_chain(chain), guard=0.5)
    engine.run()
    tf = teacher_forced(model, engine, after, prompts[4:], SERVE_TOL[model.cfg.dtype])
    # the refresh into an int8 serving chain, applied by K4
    old_q = quantize_chain(pack_chain(old), "int8", "per_block")
    new_q, qswap = quantized_swap(old_q, chain)
    qop = FaustOp(new_q)
    meta = chain_meta(new_q.plan, new_q.in_idx)
    k4 = []
    _zero_counts()
    gx = torch.Generator().manual_seed(17)
    for b in (1, 8):
        x = torch.randn((b, qop.shape[0]), generator=gx).to(dev, torch.bfloat16)
        y = qop.apply(x, "fused", device=dev)
        yk = chain_matmul(x, new_q.values, meta, plan=new_q.plan, scales=new_q.scales)
        plain = chain_matmul_q_plain(x, new_q.values, new_q.scales, meta, plan=new_q.plan)
        k4.append({"batch": b, "rel_err": rel_err(yk, plain)[1], "apply_rel_err": rel_err(y, new_q.lam * plain)[1],
                   "ms": time_ms(lambda: qop.apply(x, "fused", device=dev))})
    torch.cuda.synchronize()
    k4_launches = _serve_counts()["chain_matmul_q"]
    es = engine.stats
    row = {"phase": "serve_stream", "card": card_line, "target": list(w0.shape), "sweeps_cold": sf.cold_sweeps,
           "n_iter_two": STREAM_SWEEPS, "n_iter_global": STREAM_SWEEPS, "cold_s": cold_s, "re_cold_w0": re_cold,
           "cold_vs_head_sketched_re": cold_vs_head, "publish": asdict(publish),
           "drift_eps": eps, "update": asdict(rec), "warm_s": warm_s, "re_w1": re_w1, "re_w0": re_w0,
           "live_at_swap": live, "swap": asdict(swap), "rejected_swap": asdict(rejected),
           "swaps": es.swaps, "swap_rejects": es.swap_rejects, "teacher_forced_after_swap": tf,
           "quantized_swap": asdict(qswap), "k4": k4, "k4_launches": k4_launches,
           "requests": {r: engine.done[r].state for r in before + after}}
    log(row)
    require(publish.accepted and swap.accepted, f"a refresh was not published: {row}")
    require(live > 0, "the refresh was published with no request live")
    require(not rejected.accepted and math.isfinite(rejected.rel_err), f"the regressed chain was not rejected: {row}")
    require(es.swap_rejects == 1, f"swap_rejects {es.swap_rejects}, want 1")
    require(all(engine.done[r].state == "done" for r in before + after), f"a request did not finish: {row}")
    require(k4_launches > 0 and all(c["rel_err"] <= TOL["bfloat16"] and c["apply_rel_err"] <= TOL["bfloat16"]
                                    for c in k4), f"K4 on the quantized refresh: {k4}")
    del w0, w1
    return row


def serve(card_line: str, dev) -> dict:
    """Phase 13: serving and streaming refresh at gemma-2b's full width,
    ``SERVE_LAYERS`` deep (a–e, module docstring)."""
    from repro_torch.models.lm import LM
    from repro_torch.runtime.engine import unembed_blockfaust

    _free()
    out = {}
    cfg = serve_config()
    model = LM(cfg, seed=0, device=dev)
    a = serve_run("serve_engine", card_line, model, 24, (32, 1000), (16, 64), fixed=(512, 700), first=12,
                  every=(10, 4), evict_step=20)
    out["engine"] = a["row"]
    out["profile"] = profile_decode(card_line, model)
    out["head"] = serve_head(card_line, dev, model)
    out["forced"] = serve_forced(card_line, model)
    out["stream"] = serve_stream(card_line, dev, model, a["engine"])
    # (d)'s trace on this model: the dense MLP beside the FAµST one
    out["dense_mlp_short"] = serve_run("serve_engine_dense_mlp_short", card_line, model, 8, (32, 256), (32, 32),
                                       seed=4, check=False)["row"]
    del model, a
    _free()
    model = LM(serve_config(dtype="float32"), seed=0, device=dev)
    out["engine_f32"] = serve_run("serve_engine_f32", card_line, model, 8, (32, 256), (16, 16), seed=1)["row"]
    # the f32 head's K1 and K6 at the decode batches (b) ran
    out["head_f32"] = check_chains(card_line, dev, "serve_chain_check", {"unembed": unembed_blockfaust(model)},
                                   (1, 3, 8))
    del model
    _free()
    exact, model, out["compress"] = compressed_mlp(card_line, dev)
    run = serve_run("serve_engine_faust_mlp", card_line, model, 8, (32, 256), (32, 32), seed=4, exact=exact)
    d = run["row"]
    tf = d["teacher_forced"]
    require(tf["within_tol"] == tf["positions"],
            f"a served token trails the f32 compressed copy's maximum by more than {SERVE_TOL['bfloat16']}: {tf}")
    require(d["launches"]["chain_matmul"] > 0, f"the compressed model's serving launched no K1: {d['launches']}")
    # one layer's MLP chains at decode batches 1 and 8 and at the longest
    # prefill of the trace (one request's prompt rows)
    mlp = model.layers[0].mlp
    d["chains"] = check_chains(card_line, dev, "serve_chain_check",
                               {f"layers.0.mlp.{w}": getattr(mlp, w).blockfaust() for w in ("w_up", "w_gate", "w_down")},
                               (1, 8, max(d["prompt_lengths"])))
    d["profile"] = profile_decode(card_line, model)
    log({"phase": "serve_faust_mlp", "card": card_line, "source": "compress_model", "tpot_p50_s": d["tpot_p50_s"],
         "engine_tpot_p50_s": out["engine"]["tpot_p50_s"],
         "dense_mlp_same_trace_tpot_p50_s": out["dense_mlp_short"]["tpot_p50_s"],
         "backend_counts": d["backend_counts"], "launches_per_step": d["profile"]["launches_per_step"],
         "step_s": d["profile"]["step_s"], "dense_mlp_step_s": out["profile"]["step_s"]})
    out["faust_mlp"] = d
    del model, exact, run
    _free()
    return out


def _in_dtype(bf, dtype):
    """``bf`` with its values and λ in ``dtype`` (what a layer of that dtype
    built from it holds)."""
    from repro_torch.core.compress import BlockFaust

    return BlockFaust(tuple(f.to(dtype=dtype) for f in bf.factors), bf.lam.to(dtype))


def compressed_mlp(card_line: str, dev):
    """Phase 13 (d)'s model: the f32 ``serve_config`` LM from seed 0 with
    every MLP weight compressed on the card by ``compress_model`` (block
    128, J = 2, k 4, ``STREAM_SWEEPS`` sweeps: the reference's defaults are
    40/40), the 12 chains installed by ``FaustLinear.from_blockfaust`` into
    it and into its bf16 copy.  Logs the compression (seconds, peak memory,
    each matrix's RE against its dense weight, ``s_tot`` and RCG), the
    check of ``layers.0.mlp.w_down`` compressed again alone (the sequential
    route, RE within ``BATCHED_RE_GAP``) and the installation (each layer's
    factors and ``todense()`` equal to its chain's in the layer's dtype).
    Returns (the f32 model, the bf16 model, the rows)."""
    import torch

    from repro_torch.core import compress_layers, compress_model
    from repro_torch.layers.faust_linear import FaustLinear
    from repro_torch.models.lm import LM

    exact = LM(serve_config(dtype="float32"), seed=0, device=dev)
    dense = {k: v.detach().clone() for k, v in exact.named_parameters() if ".mlp." in k}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chains = compress_model(exact, select=lambda n: ".mlp." in n, n_iter_two=STREAM_SWEEPS,
                            n_iter_global=STREAM_SWEEPS, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(sorted(chains) == sorted(dense), f"compress_model chose {sorted(chains)}, want {sorted(dense)}")

    def re(bf, w):
        return float(torch.linalg.norm(w - bf.todense()) / torch.linalg.norm(w))

    per = {n: {"shape": list(dense[n].shape), "re": re(bf, dense[n]), "s_tot": bf.s_tot, "rcg": bf.rcg(),
               "k": [f.k for f in bf.factors]} for n, bf in chains.items()}
    row = {"phase": "compress_model", "card": card_line, "matrices": len(chains), "sweeps": STREAM_SWEEPS,
           "reference_sweeps": 40, "seconds": seconds, "seconds_per_matrix": seconds / len(chains),
           "slice7_seconds_per_matrix_40_sweeps": 3.68, "max_memory_allocated_gb": peak,
           "re_max": max(p["re"] for p in per.values()), "re_min": min(p["re"] for p in per.values()),
           "chains": per}
    log(row)
    name = "layers.0.mlp.w_down"
    t0 = time.perf_counter()
    alone = compress_layers({name: dense[name]}, n_iter_two=STREAM_SWEEPS, n_iter_global=STREAM_SWEEPS,
                            device=dev)[name]
    torch.cuda.synchronize()
    again = {"phase": "compress_model_alone", "card": card_line, "matrix": name, "seconds": time.perf_counter() - t0,
             "re_alone": re(alone, dense[name]), "re_batched": per[name]["re"], "limit": BATCHED_RE_GAP}
    again["gap"] = abs(again["re_alone"] - again["re_batched"])
    log(again)
    require(again["gap"] <= BATCHED_RE_GAP, f"{name} compressed alone: {again}")
    del dense, alone
    model = LM(serve_config(), device=dev)
    model.load_state_dict({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                           for k, v in exact.state_dict().items()})
    worst = 0.0
    for n, bf in chains.items():
        layer, _, w = n.split(".")[1:]
        for m in (exact, model):
            dtype = m.embed.table.dtype
            mlp = m.layers[int(layer)].mlp
            setattr(mlp, w, FaustLinear.from_blockfaust(bf, dtype=dtype))
            want = _in_dtype(bf, dtype)
            with torch.no_grad():
                got = getattr(mlp, w).blockfaust()
                same = all(torch.equal(a.values, b.values) and torch.equal(a.in_idx, b.in_idx)
                           for a, b in zip(got.factors, want.factors)) and torch.equal(got.lam, want.lam)
                diff = float((getattr(mlp, w).todense() - want.todense()).abs().max())
            require(same and diff == 0.0, f"{n} installed in {dtype}: factors equal {same}, todense off by {diff}")
            worst = max(worst, diff)
    installed = {"phase": "compress_model_installed", "card": card_line, "layers": len(chains),
                 "dtypes": ["float32", "bfloat16"], "todense_max_abs_diff": worst,
                 "dense_mlp_keys_left": [k for k in model.state_dict() if k in per]}
    log(installed)
    require(not installed["dense_mlp_keys_left"], f"dense MLP weights left in the state dict: {installed}")
    return exact, model, {"compress": row, "alone": again, "installed": installed}


# ---------------------------------------------------------------------------
# Slice 9: the rest of training (phase 14)
# ---------------------------------------------------------------------------

RESILIENT_ARGV = ("--arch", "gemma_2b", "--faust", "--batch", "8", "--seq", "128")
EF_RATIO = "0.01"
RESUME_LAYERS = 2  # (b)'s depth: full width, a state of about 10 GB on disk
RESUME_RTOL = 1e-6  # resumed losses against the uninterrupted run's, relative
# (c)'s spec: None is the reference's default (block 8, 8/8 sweeps;
# src/repro/runtime/trainer.py:291-294)
RECOMPRESS_SPEC = None
CALIB_RANGE = (0.3, 1.1)  # a measured constant over its data-sheet value
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"


@contextlib.contextmanager
def _fresh_tables(name: str):
    """A fresh autotune table ``build/<name>.json`` in read-only mode (so
    ``auto`` is the model's choice, as in phase 7), the old one after."""
    from repro_torch.api import autotune

    table = ROOT / "build" / f"{name}.json"
    table.unlink(missing_ok=True)
    saved = {k: os.environ.get(k) for k in ("REPRO_TORCH_AUTOTUNE_TABLE", "REPRO_AUTOTUNE")}
    os.environ["REPRO_TORCH_AUTOTUNE_TABLE"] = str(table)
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.reload()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.reload()


def _resilient_trainer(argv, n_layers: int | None = None, **tcfg):
    """``repro_torch.launch.train``'s trainer for ``RESILIENT_ARGV + argv``,
    its depth cut to ``n_layers`` and its ``TrainConfig`` fields replaced by
    ``tcfg`` where given; and the parsed arguments."""
    import dataclasses

    from repro_torch.launch import train
    from repro_torch.runtime.trainer import Trainer

    args = train.parse_args([*RESILIENT_ARGV, *argv])
    base = train.build(args)
    if n_layers is None and not tcfg:
        return base, args
    cfg = base.cfg if n_layers is None else dataclasses.replace(base.cfg, n_layers=n_layers,
                                                                  stages=((n_layers, ("attn",)),))
    return Trainer(cfg, base.data_cfg, base.opt_cfg, dataclasses.replace(base.tcfg, **tcfg), device=base.device), args


def _state_leaves(out) -> list:
    from repro_torch.checkpoint.manager import _leaves
    from repro_torch.runtime.trainer import state_tree

    return _leaves(state_tree(out["model"], out["opt"], out["ef"]))


def _same_bits(a, b) -> bool:
    import torch

    view = (lambda t: t.view(torch.int16)) if a.dtype == torch.bfloat16 else (lambda t: t)  # noqa: E731
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(view(a), view(b))


def _step_rows(phase: str, card_line: str, hist, tokens: int) -> None:
    for h in hist:
        log({"phase": phase, "card": card_line, "step": h["step"], "loss": h["loss"],
             "step_time_s": h["step_time_s"], "tokens_per_s": tokens / h["step_time_s"],
             "ef_residual_norm": h.get("ef_residual_norm"), "recompress_re": h.get("recompress_re"),
             "skipped": h["skipped"]})


def ef_sync_check(trainer, out) -> dict:
    """One more compressed step with ``set_sync_debug_mode("error")`` around
    the compression and the guarded update (as ``test_torch_gpu.py`` holds
    the update), inside ``"warn"`` around the whole step: a read-back in
    the compression or the update raises; the forward's and backward's are
    counted."""
    import warnings

    import torch

    from repro_torch.data.pipeline import DataIterator
    from repro_torch.runtime import trainer as trainer_mod

    ran = []

    def strict(real):
        def call(*a, **k):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
                ran.append(real.__name__)
        return call

    real = {n: getattr(trainer_mod, n) for n in ("ef_topk_compress", "guarded_update")}
    step_fn = trainer_mod.make_train_step(out["model"], trainer.opt_cfg, trainer.tcfg)
    batch = {k: torch.from_numpy(v).to(trainer.device) for k, v in next(DataIterator(trainer.data_cfg)).items()}
    torch.cuda.synchronize()
    try:
        for n, fn in real.items():
            setattr(trainer_mod, n, strict(fn))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                metrics = step_fn(batch, out["opt"], out["ef"])
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        for n, fn in real.items():
            setattr(trainer_mod, n, fn)
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]
    return {"strict_parts": ran, "loss": float(metrics["loss"]), "step_sync_warnings": len(syncs),
            "first_sync_warnings": syncs[:3]}


def time_topk(card_line: str, n: int, ratio: float) -> dict:
    """The EF selection at the embedding gradient's size: ``topk_mask_flat``
    (``torch.topk``'s k-th value, then ties in index order) against the
    plain stable sort of ``core.projections`` (the same set required), and
    ``torch.topk`` alone (the library call; its set may differ at ties)."""
    import torch

    from repro_torch.core.projections import _topk_mask_flat
    from repro_torch.optim.compression import n_kept, topk_mask_flat

    k = n_kept(n, ratio)
    v = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    same = bool(torch.equal(topk_mask_flat(v, k), _topk_mask_flat(v, k).float()))
    _free()
    row = {"phase": "ef_topk_time", "card": card_line, "n": n, "k": k, "same_set": same,
           "selection_ms": time_ms(lambda: topk_mask_flat(v, k), iters=5),
           "stable_sort_ms": time_ms(lambda: _topk_mask_flat(v, k), iters=3),
           "torch_topk_ms": time_ms(lambda: torch.topk(v.abs(), k, sorted=False), iters=5),
           "bound_ms": 4.0 * n * 2 / HBM_BW * 1e3}  # read v, write the f32 mask
    log(row)
    require(same, f"the selection's set is not the stable sort's: {row}")
    del v
    _free()
    return row


def ef_run(card_line: str) -> dict:
    """Phase 14 (a): gemma-2b at full width and depth, ``--compress-grads``
    for 4 steps: loss, step time, the EF residual's norm and tokens/s per
    step, peak memory, a profiled step's idle share, the sync check, K2 and
    K3 launches; then the selection's time at the embedding's size."""
    import torch

    _free()
    trainer, args = _resilient_trainer(["--steps", "4", "--compress-grads", EF_RATIO, "--checkpoint-dir",
                                        str(CKPT_ROOT / "ef"), "--checkpoint-every", "1000"])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = trainer.run(resume=args.resume)
    wall_s = time.perf_counter() - t0
    counts = _bwd_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    _step_rows("train_ef_step", card_line, out["history"], args.batch * args.seq)
    profile = profile_step(trainer, out, card_line, "train_ef_profile")
    sync = ef_sync_check(trainer, out)
    n_embed = out["model"].embed.table.numel()
    ef_gb = sum(r.numel() for r in out["ef"].residual.values()) * 4 / 1e9
    row = {"phase": "train_ef", "card": card_line, "n_layers": trainer.cfg.n_layers, "ratio": float(EF_RATIO),
           "wall_s": wall_s, "max_memory_allocated_gb": peak, "ef_residual_gb": ef_gb, "launches": counts,
           "profile": profile, "sync": sync, "losses": [h["loss"] for h in out["history"]]}
    log(row)
    losses = row["losses"]
    require(len(losses) == 4 and all(math.isfinite(v) for v in losses), f"bad EF losses: {losses}")
    require(all("ef_residual_norm" in h and math.isfinite(h["ef_residual_norm"]) for h in out["history"]),
            "no finite EF residual norm in a step")
    require(counts["chain_dgrad"] > 0 and counts["chain_wgrad"] > 0, f"the EF trainer never ran K2/K3: {counts}")
    require(sync["strict_parts"] == ["ef_topk_compress", "guarded_update"], f"the sync check did not run: {sync}")
    del out, trainer
    _free()
    row["topk"] = time_topk(card_line, n_embed, float(EF_RATIO))
    return row


def preempt_resume(card_line: str) -> dict:
    """Phase 14 (b): full width at ``RESUME_LAYERS`` layers with EF: 4 steps
    uninterrupted; then ``checkpoint_every=2`` with SIGTERM raised after
    step 2 (save, clean exit); then a fresh trainer resuming for steps 2-3.
    The losses within ``RESUME_RTOL``, the restored state bit for bit; the
    bytes, a save's seconds (snapshot, hash, write) and the restore's."""
    import shutil
    import signal

    _free()
    folder = CKPT_ROOT / "resume"
    shutil.rmtree(folder, ignore_errors=True)
    argv = ["--steps", "4", "--compress-grads", EF_RATIO, "--checkpoint-dir", str(folder),
            "--checkpoint-every", "1000"]
    full_t, _ = _resilient_trainer(argv, n_layers=RESUME_LAYERS)
    full = full_t.run(resume=False)
    want = [h["loss"] for h in full["history"]]
    nbytes = sum(t.numel() * t.element_size() for _, t in _state_leaves(full))
    del full, full_t
    _free()
    folder.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(folder).free
    require(free >= 1.2 * nbytes, f"{free / 1e9:.1f} GB free under {folder}: a checkpoint takes "
                                  f"{nbytes / 1e9:.1f} GB (and 20 % room)")
    first_t, _ = _resilient_trainer(argv, n_layers=RESUME_LAYERS, checkpoint_every=2)
    beat = first_t._heartbeat

    def preempt_after_step_2(step):
        beat(step)
        if step == 1:
            signal.raise_signal(signal.SIGTERM)

    first_t._heartbeat = preempt_after_step_2
    first = first_t.run(resume=False)
    saved = {n: t for n, t in _state_leaves(first)}
    steps_on_disk = first_t.ckpt.all_steps()
    second_t, _ = _resilient_trainer(argv, n_layers=RESUME_LAYERS)
    restore = second_t.ckpt.restore_latest
    mismatched = []

    def checked_restore(target, shardings=None):
        out = restore(target, shardings)
        from repro_torch.checkpoint.manager import _leaves

        mismatched.extend(n for n, t in _leaves(target) if not _same_bits(t, saved[n]))
        return out

    second_t.ckpt.restore_latest = checked_restore
    del first
    second = second_t.run(resume=True)
    got = [h["loss"] for h in first_t.history + second["history"]]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))
    save = first_t.saves[0] if first_t.saves else {}
    row = {"phase": "train_resume", "card": card_line, "n_layers": RESUME_LAYERS, "losses": got,
           "uninterrupted": want, "max_rel_diff": rel, "steps": [h["step"] for h in first_t.history + second["history"]],
           "steps_on_disk": steps_on_disk, "state_bytes": nbytes, "saved_bytes": save.get("bytes"),
           "snapshot_s": save.get("snapshot_s"), "hash_s": save.get("hash_s"), "write_s": first_t.ckpt.last_write_s,
           "restore_s": (second_t.resumed or {}).get("restore_s"), "resumed_step": (second_t.resumed or {}).get("step"),
           "leaves": len(saved), "mismatched_leaves": mismatched[:8], "disk_free_gb": free / 1e9}
    log(row)
    require(row["steps"] == [0, 1, 2, 3] and steps_on_disk == [2] and row["resumed_step"] == 2,
            f"preemption did not save at step 2 and resume there: {row}")
    require(not mismatched and len(saved) > 0, f"restored leaves differ from the saved ones: {row}")
    require(rel <= RESUME_RTOL, f"resumed losses differ from the uninterrupted run's: {row}")
    del second, second_t, first_t, saved
    shutil.rmtree(folder, ignore_errors=True)
    _free()
    return row


def recompress_run(card_line: str) -> dict:
    """Phase 14 (c): full width and depth, 4 steps, ``recompress_every=2``
    on the reference's default targets and spec: each tick's action, RE,
    sweeps and seconds, the K1 launches, the heartbeat's record."""
    _free()
    hb = ROOT / "build" / "chip_smoke_heartbeat.json"
    hb.parent.mkdir(parents=True, exist_ok=True)
    hb.unlink(missing_ok=True)
    trainer, args = _resilient_trainer(["--steps", "4", "--checkpoint-dir", str(CKPT_ROOT / "recompress"),
                                        "--checkpoint-every", "1000"], recompress_every=2,
                                       heartbeat_path=str(hb), recompress_spec=RECOMPRESS_SPEC)
    ticks = []
    tick = trainer._recompress

    def recorded(model, step_idx):
        recs = tick(model, step_idx)
        ticks.append({"step": step_idx, "weights": recs})
        return recs

    trainer._recompress = recorded
    _zero_counts()
    out = trainer.run(resume=args.resume)
    counts = _bwd_counts()
    _step_rows("train_recompress_step", card_line, out["history"], args.batch * args.seq)
    beat = json.loads(hb.read_text())
    row = {"phase": "train_recompress", "card": card_line, "spec": str(RECOMPRESS_SPEC or "reference default"),
           "ticks": ticks, "tracked": sorted(trainer.streaming), "launches": counts,
           "heartbeat": beat.get("recompress"), "losses": [h["loss"] for h in out["history"]]}
    log(row)
    require([t["step"] for t in ticks] == [1, 3] and row["tracked"] == ["embed/table"],
            f"recompression ticked elsewhere or tracked other weights: {row}")
    require(all(math.isfinite(r["re"]) for t in ticks for r in t["weights"].values()), f"a non-finite RE: {row}")
    require(beat.get("recompress", {}).get("step") == 3 and "embed/table" in beat["recompress"]["weights"],
            f"the heartbeat lacks the recompression record: {beat}")
    require(counts["chain_matmul"] > 0 and all(math.isfinite(v) for v in row["losses"]), f"bad run: {row}")
    del out, trainer
    _free()
    return row


def calibration(card_line: str) -> dict:
    """Phase 14 (d): ``launch.calibrate`` into a temporary cache, each
    measured constant beside its data-sheet value (within ``CALIB_RANGE``
    but the launch time and the builtin link rate), a dispatch decision
    priced by the measured source; the builtin constants restored."""
    import torch

    from repro_torch.api import dispatch
    from repro_torch.launch import calibrate, roofline

    path = ROOT / "build" / "chip_smoke_roofline.json"
    path.unlink(missing_ok=True)
    saved = os.environ.get("REPRO_TORCH_ROOFLINE")
    os.environ["REPRO_TORCH_ROOFLINE"] = str(path)
    try:
        t0 = time.perf_counter()
        rec = calibrate.calibrate()
        calibrate.write(rec)
        seconds = time.perf_counter() - t0
        consts, source = roofline.roofline_constants()
        rep = dispatch.choose_backend(batch=128, shape=(2048, 16384), s_tot=11_010_048, inner_dims=(2048, 2048),
                                      n_factors=3, dtype=torch.bfloat16)
    finally:
        if saved is None:
            os.environ.pop("REPRO_TORCH_ROOFLINE", None)
        else:
            os.environ["REPRO_TORCH_ROOFLINE"] = saved
        roofline.reload()
        path.unlink(missing_ok=True)
    builtin = roofline._BUILTIN
    ratios = {k: rec[k] / builtin[k] for k in builtin}
    row = {"phase": "calibrate", "card": card_line, "seconds": seconds, "measured": {k: rec[k] for k in builtin},
           "datasheet": builtin, "ratio": ratios, "source": source, "dispatch_roofline": rep.roofline,
           "after": roofline.roofline_constants()[1], "meta": rec["meta"]}
    log(row)
    require(source == f"measured:{path}" and rep.roofline == source, f"dispatch did not price with the cache: {row}")
    require(row["after"] == roofline.BUILTIN_SOURCE, f"the builtin constants were not restored: {row}")
    for k in ("peak_flops", "peak_flops_f32", "hbm_bw"):
        require(CALIB_RANGE[0] <= ratios[k] <= CALIB_RANGE[1], f"{k} is {ratios[k]:.3f}× its data-sheet value: {row}")
    return row


def train_resilient(card_line: str) -> dict:
    """Phase 14, slice 9 (module docstring)."""
    with _fresh_tables("chip_smoke_resilient_autotune"):
        out = {"ef": ef_run(card_line), "resume": preempt_resume(card_line), "recompress": recompress_run(card_line)}
    out["calibrate"] = calibration(card_line)
    return out


# ---------------------------------------------------------------------------
# Slice 10: partial rotary, sliding-window and MoE architectures (phase 15)
# ---------------------------------------------------------------------------

ARCH_HEAD = (2, 16, 4)  # the trainer's --faust defaults: factors, block, k
GEMMA3_UNIT = ("local",) * 5 + ("attn",)  # gemma3's stage unit (src/repro/configs/gemma3_27b.py)
GEMMA3_TRAIN_ARGV = ("--arch", "gemma3_27b", "--faust", "--steps", "3", "--batch", "1", "--seq", "2048")
GRANITE_TRAIN_ARGV = ("--arch", "granite_moe_3b", "--faust", "--steps", "3", "--batch", "8", "--seq", "128")
# the trainers' depths, cut (granite's from its full 32, mamba2's from 64,
# zamba2's from 36, musicgen's from 48) to make room for phase 18 (c)'s
# sharded serving; the served models stay at full depth
GRANITE_TRAIN_LAYERS = 8
GEMMA3_PROMPTS = (64, 200, 512, 1024, 1536, 2048)  # above attn_chunk 512 only multiples of it: no replay
ARCH_MAX_LEN = 2112  # gemma3's longest prompt and 48 new tokens, with room
LLAMA4_PROMPT = 256  # prefill and decode at B = 1 and 8


def arch_config(arch: str, n_layers: int | None = None, unit: tuple | None = None, dropfree: bool = False):
    """``arch``'s published config with the FAµST unembedding
    ``ARCH_HEAD`` (untied), bf16; its depth cut to ``n_layers`` layers of
    ``unit`` where given; with ``dropfree`` its MoE capacity factor E/k,
    under which a sequence routes as its tokens one by one do."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.layers.faust_linear import FaustSpec

    cfg = dataclasses.replace(get_config(arch), faust_unembed=FaustSpec(*ARCH_HEAD), tie_embeddings=False)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, stages=((n_layers // len(unit), unit),))
    if dropfree:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _lm(cfg, dev):
    """``LM(cfg)`` from seed 0 on ``dev``."""
    from repro_torch.models.lm import LM

    return LM(cfg, seed=0, device=dev)


def param_check(name: str, model) -> dict:
    """The model's parameter sizes, summed over every parameter but the
    norms', against ``stored_param_count`` of the config it was built from
    (``param_count`` with the FAµST head counted by what it stores)."""
    from repro_torch.configs.base import param_count, stored_param_count

    counted = sum(p.numel() for n, p in model.named_parameters() if "norm" not in n)
    row = {"params": sum(p.numel() for p in model.parameters()), "params_counted": counted,
           "stored_param_count": stored_param_count(model.cfg), "param_count": param_count(model.cfg)}
    require(counted == row["stored_param_count"],
            f"{name}: parameters {counted} != stored_param_count {row['stored_param_count']}")
    return row


def _moes(model) -> list:
    return [layer.moe for layer in model.layers if layer.kind == "moe"]


@contextlib.contextmanager
def moe_capacity(model, capacity_factor: float):
    """Every MoE layer of ``model`` at ``capacity_factor``; restored on exit."""
    import dataclasses

    mods = _moes(model)
    saved = [m.spec for m in mods]
    for m in mods:
        m.spec = dataclasses.replace(m.spec, capacity_factor=capacity_factor)
    try:
        yield
    finally:
        for m, spec in zip(mods, saved):
            m.spec = spec


@contextlib.contextmanager
def moe_routing(model):
    """Each MoE forward's routing recomputed from its input by ``route``
    and counted: (token, k) pairs, pairs dropped, and per forward the
    distinct experts its tokens reach (each forward syncs the host: not
    for timed runs)."""
    import torch

    from repro_torch.layers.moe import route

    stats = {"pairs": 0, "dropped": 0, "experts": []}

    def hook(mod, args, out):
        with torch.no_grad():
            r = route(args[0].float() @ mod.router, mod.spec)
        slots = r.slot_src.shape[1]
        kept = r.dest[r.dest < slots]
        stats["pairs"] += r.dest.numel()
        stats["dropped"] += int((r.dest == slots).sum())
        stats["experts"].append(int(torch.unique(kept // (slots // mod.spec.n_experts)).numel()))

    handles = [m.register_forward_hook(hook) for m in _moes(model)]
    try:
        yield stats
    finally:
        for h in handles:
            h.remove()


def head_chains(name: str, model) -> dict:
    """Each FAµST unembedding head of ``model`` as a ``BlockFaust`` on
    detached views of its parameters: ``{name}.unembed``, or
    ``{name}.unembed[k]`` for each codebook's head of an audio model."""
    import dataclasses

    from repro_torch.layers.faust_linear import StackedFaustLinear
    from repro_torch.runtime.engine import unembed_blockfaust

    head = model.unembed.faust
    if not isinstance(head, StackedFaustLinear):
        return {f"{name}.unembed": unembed_blockfaust(model)}
    out = {}
    for k in range(head.n):
        bf = head.blockfaust(k)
        out[f"{name}.unembed[{k}]"] = type(bf)(
            tuple(dataclasses.replace(f, values=f.values.detach()) for f in bf.factors), bf.lam.detach())
    return out


def arch_train(card_line: str, name: str, argv, n_layers: int | None = None, unit: tuple | None = None,
               per_step: int | None = None) -> dict:
    """``repro_torch.launch.train``'s trainer for ``argv`` (depth cut to
    ``n_layers`` of ``unit`` where given) on a fresh read-only autotune
    table: losses, step seconds, tokens/s, peak GB, K1/K2/K3 launches
    (zeroed before, each required), the banded attention calls, the
    parameter count, one more step under the profiler, K2 and K3 against
    their plain versions on the trained head at B·S rows
    (:func:`arch_head_bwd`), and for MoE the cross entropy and aux loss of
    the trained model and an estimate of the MoE layers' share of the
    step's device time: the layers' count × one layer's forward and
    forward + backward, timed alone on random inputs, over the profiled
    step's device busy time (an estimate, not a reading of the trace).
    Every head of the unembedding is checked (:func:`head_chains`); with
    ``per_step`` K1, K2 and K3 must each have launched exactly that many
    times a step (one per head)."""
    import dataclasses

    import torch

    from repro_torch.core.compress import pack_chain
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.launch import train
    from repro_torch.layers import attention
    from repro_torch.runtime.trainer import Trainer

    args = train.parse_args([*argv, "--checkpoint-dir", str(CKPT_ROOT / "archs")])  # 3 steps: nothing saved
    base = train.build(args)
    cfg = base.cfg if n_layers is None else dataclasses.replace(
        base.cfg, n_layers=n_layers, stages=((n_layers // len(unit), unit),))
    trainer = Trainer(cfg, base.data_cfg, base.opt_cfg, base.tcfg, device=base.device)
    banded = {"calls": 0}
    plain_banded = attention.banded_attention_ref

    def counting(*a, **k):
        banded["calls"] += 1
        return plain_banded(*a, **k)

    cuda = trainer.device.type == "cuda"
    _free()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    attention.banded_attention_ref = counting
    try:
        _zero_counts()
        t0 = time.perf_counter()
        out = trainer.run(resume=False)
        wall_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
        counts = _bwd_counts()
    finally:
        attention.banded_attention_ref = plain_banded
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    model = out["model"]
    tokens = args.batch * args.seq
    hist = out["history"]
    _step_rows(f"{name}_train_step", card_line, hist, tokens)
    row = {"phase": f"{name}_train", "card": card_line, "argv": list(argv), "n_layers": cfg.n_layers,
           "stages": cfg.stages, "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.dtype, "remat": cfg.remat,
           "faust_unembed": str(cfg.faust_unembed), **param_check(name, model), "wall_s": wall_s,
           "losses": [h["loss"] for h in hist], "step_time_s": [h["step_time_s"] for h in hist],
           "tokens_per_s": [tokens / h["step_time_s"] for h in hist], "max_memory_allocated_gb": peak,
           "launches": counts, "banded_attention_calls": banded["calls"],
           "faust_dispatch": None if trainer.faust_dispatch is None else trainer.faust_dispatch.as_row()}
    if cfg.moe is not None:
        batch = {k: torch.from_numpy(v).to(trainer.device) for k, v in next(DataIterator(trainer.data_cfg)).items()}
        with torch.no_grad():
            _, met = model.train_loss(batch)
        row.update(ce=float(met["ce"]), aux=float(met["aux"]))
    row["profile"] = profile_step(trainer, out, card_line, phase=f"{name}_train_profile") if cuda else None
    if cfg.moe is not None and cuda:
        moe = model.layers[0].moe
        x = torch.randn((args.batch, args.seq, cfg.d_model), device=trainer.device).to(torch.bfloat16)
        xg = x.clone().requires_grad_(True)

        def fwd_bwd():
            y, aux = moe(xg)
            (y.float().sum() + aux).backward()

        with torch.no_grad():
            fwd_ms = time_ms(lambda: moe(x))
        fwd_bwd_ms = time_ms(fwd_bwd)
        model.zero_grad(set_to_none=True)
        # remat: every layer's forward runs again in the backward
        est = cfg.n_layers * (fwd_ms + fwd_bwd_ms)
        row["moe"] = {"layer_fwd_ms": fwd_ms, "layer_fwd_bwd_ms": fwd_bwd_ms, "step_est_ms": est,
                      "share_of_device_busy_est": est / row["profile"]["device_busy_ms"]}
    log(row)
    require(len(hist) == args.steps and all(math.isfinite(h["loss"]) for h in hist), f"{name}: bad losses: {row}")
    if cuda:
        require(all(counts[k] > 0 for k in ("chain_matmul", "chain_dgrad", "chain_wgrad")),
                f"{name}: the trainer did not run K1, K2 and K3: {counts}")
        if per_step is not None:
            require(all(counts[k] == per_step * args.steps for k in ("chain_matmul", "chain_dgrad", "chain_wgrad")),
                    f"{name}: K1/K2/K3 launches {counts}, want {per_step} each a step")
    if cfg.window is not None and args.seq > cfg.window:
        require(banded["calls"] > 0, f"{name}: no local layer ran banded at seq {args.seq}")
    if cfg.moe is not None:
        require(math.isfinite(row["ce"]) and row["aux"] > 0, f"{name}: no aux loss: {row}")
    with torch.no_grad():
        heads = {label: pack_chain(bf) for label, bf in head_chains(name, model).items()}
    del out, model, trainer
    _free()
    row["head_bwd_check"] = [arch_head_bwd(card_line, label, pc, tokens) for label, pc in heads.items()] if cuda \
        else None
    return row


def arch_head_bwd(card_line: str, name: str, pc, rows: int) -> dict:
    """K2 and K3 against their plain versions on a trained bf16 head
    ``pc`` (packed; ``name`` its :func:`head_chains` label) at the
    trainer's ``rows`` = B·S rows and at the tiles
    the fused backward runs them (``DGRAD_BT``, ``WGRAD_BT``), on the same
    card tensors; ``dy`` zero past the vocab, as the slice of the padded
    output gives it.  One launch of each, counted."""
    import torch

    from repro_torch.kernels.chain import DGRAD_BT, WGRAD_BT
    from repro_torch.kernels.chain_bwd import (
        chain_dgrad,
        chain_dgrad_plain,
        chain_wgrad,
        chain_wgrad_plain,
        dgrad_meta,
        wgrad_meta,
    )

    plan, values = pc.plan, pc.values
    require(values.dtype == torch.bfloat16, f"{name}: the trained head is {values.dtype}, not bf16")
    dev = values.device
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((rows, plan.in_blocks[0] * plan.block), generator=g, device=dev).to(torch.bfloat16)
    x[:, plan.in_features:] = 0  # the path pads x with zeros
    dy = torch.zeros((rows, plan.out_blocks[-1] * plan.block), dtype=torch.bfloat16, device=dev)
    dy[:, :plan.out_features] = torch.randn((rows, plan.out_features), generator=g, device=dev)
    dm, wm = dgrad_meta(plan, pc.in_idx), wgrad_meta(plan, pc.in_idx)
    _zero_counts()
    dx = chain_dgrad(dy, values, dm, plan=plan, bt=DGRAD_BT)
    dv = chain_wgrad(x, dy, values, wm, plan=plan, bt=WGRAD_BT)
    torch.cuda.synchronize()
    counts = _bwd_counts()
    dx_err, dx_rel = rel_err(dx, chain_dgrad_plain(dy, values, dm, plan=plan))
    del dx
    dv_err, dv_rel = rel_err(dv, chain_wgrad_plain(x, dy, values, wm, plan=plan))
    row = {"phase": "arch_head_bwd_check", "card": card_line, "chain": name, "dtype": "bfloat16",
           "rows": rows, "dims": [plan.in_features, *plan.out_feats], "padded_out": plan.out_blocks[-1] * plan.block,
           "dgrad_bt": DGRAD_BT, "wgrad_bt": WGRAD_BT, "k2_max_abs_err": dx_err, "k2_rel_err": dx_rel,
           "k3_max_abs_err": dv_err, "k3_rel_err": dv_rel, "tol": TOL["bfloat16"],
           "launches": {k: counts[k] for k in ("chain_dgrad", "chain_wgrad")}}
    log(row)
    require(counts["chain_dgrad"] == 1 and counts["chain_wgrad"] == 1, f"{name}: launches {counts}")
    require(dx_rel <= TOL["bfloat16"] and dv_rel <= TOL["bfloat16"],
            f"{name} at {rows} rows: K2 {dx_rel}, K3 {dv_rel} against their plain versions")
    del dv, x, dy
    _free()
    return row


def arch_heads(card_line: str, dev, name: str, model, rows: int) -> list[dict]:
    """K1 (and K6) against their plain versions on each of ``model``'s bf16
    heads (:func:`head_chains`), at decode batches 1 and 8 and at ``rows``
    rows (a whole sequence's forward)."""
    return check_chains(card_line, dev, "arch_head_check", head_chains(name, model), (1, 8, rows))


def arch_serve(card_line: str, dev, name: str, model, n_req: int, lengths: tuple, budgets: tuple,
               fixed: tuple = (), seed: int = 0, max_len: int = SERVE_MAX_LEN) -> dict:
    """The engine over ``model`` on a trace (:func:`serve_run`, every
    request ``done``, the teacher-forced check), its parameter count and
    its head's K1 against plain."""
    params = param_check(name, model)
    res = serve_run(f"{name}_serve", card_line, model, n_req, lengths, budgets, fixed=fixed, seed=seed,
                    max_len=max_len)
    row = res["row"]
    row.update(params)
    row["head_checks"] = arch_heads(card_line, dev, name, model, max(row["prompt_lengths"]))
    log({"phase": f"{name}_serve_summary", "card": card_line, **params,
         **{k: row[k] for k in ("tokens_per_s", "ttft_p50_s", "tpot_p50_s", "prefill_s", "decode_s", "wall_s",
                                "max_memory_allocated_gb", "launches", "teacher_forced")},
         "head_k1_rel_err": max(c["k1_rel_err"] for c in row["head_checks"])})
    return res


def moe_decode(card_line: str, model, batch: int, prompt_len: int = LLAMA4_PROMPT) -> dict:
    """A MoE model's prefill of ``batch × prompt_len`` tokens and its
    decode step at ``batch`` live rows: prefill seconds, the step's host
    seconds (median of 5), one step under the profiler, and the step's two
    bounds: every weight read once (every expert; what the dense-capacity
    einsums read) and only the experts its tokens reach (counted from the
    step's routing)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.lm import DTYPES, make_caches
    from repro_torch.runtime.engine import LMExecutor

    cfg = model.cfg
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(batch, prompt_len)), device=model.embed.table.device)
    spans = []
    with torch.no_grad():
        for _ in range(3):
            caches = make_caches(cfg, batch, prompt_len + 8, DTYPES[cfg.dtype], tokens.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(tokens, caches)
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t0)
    del caches
    ex = LMExecutor(model, prompt_len + 64, batch)
    for slot in range(batch):
        ex.prefill_forward(slot, tokens[slot].cpu().numpy().astype(np.int32), {})
    slots, toks = list(range(batch)), rng.integers(0, cfg.vocab, size=(batch, 1))
    ex.decode_forward(slots, toks)
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        ex.decode_forward(slots, toks)
        steps.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.decode_forward(slots, toks)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    with moe_routing(model) as routed:
        ex.decode_forward(slots, toks)
    spec = cfg.moe
    glu = 3 if spec.act in ("geglu", "swiglu") else 2
    expert_bytes = glu * cfg.d_model * spec.d_ff * model.layers[0].moe.w_up.element_size()
    bound = weight_bound(model, batch)
    unread = sum(spec.n_experts - e for e in routed["experts"]) * expert_bytes
    active_bytes = bound["weight_bytes"] - unread
    row = {"phase": "moe_decode", "card": card_line, "arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
           "capacity_factor": spec.capacity_factor, "prefill_s": statistics.median(spans),
           "decode_step_s": statistics.median(steps), "decode_step_s_all": steps,
           "experts_reached": routed["experts"], "all_experts_bytes": bound["weight_bytes"],
           "all_experts_bound_ms": bound["weight_bound_ms"], "active_experts_bytes": active_bytes,
           "active_experts_bound_ms": active_bytes / HBM_BW * 1e3, **device_spans(prof, prof_s)}
    log(row)
    require(routed["dropped"] == 0, f"a decode step dropped tokens at capacity factor {spec.capacity_factor}")
    return row


def archs(card_line: str, dev) -> dict:
    """Phase 15, slice 10: the partial-rotary, sliding-window and MoE
    architectures at their published widths with the FAµST unembedding
    (module docstring); every model freed before the next."""
    import numpy as np
    import torch

    from repro_torch.models.lm import DTYPES, make_caches

    out = {}
    with _fresh_tables("chip_smoke_archs_autotune"):
        # gemma3-27b: one stage unit (five local layers, one global) at seq 2048, so the local layers run banded
        out["gemma3_train"] = arch_train(card_line, "gemma3", GEMMA3_TRAIN_ARGV, 6, GEMMA3_UNIT)
        out["granite_train"] = arch_train(card_line, "granite", GRANITE_TRAIN_ARGV, GRANITE_TRAIN_LAYERS, ("moe",))
        model = _lm(arch_config("gemma3_27b", 6, GEMMA3_UNIT), dev)
        res = arch_serve(card_line, dev, "gemma3", model, len(GEMMA3_PROMPTS), (64, 64), (16, 48),
                         fixed=GEMMA3_PROMPTS, seed=21, max_len=ARCH_MAX_LEN)
        out["gemma3_serve"] = res["row"]
        caps = sorted({c.capacity for c in res["engine"].executor.pool})
        require(caps == [model.cfg.window, ARCH_MAX_LEN], f"gemma3's pool capacities {caps}")
        del model, res
        _free()
        # granite-moe-3b, full depth: teacher-forced drop-free (cf = E/k), then the published factor beside it
        published = arch_config("granite_moe_3b").moe.capacity_factor
        model = _lm(arch_config("granite_moe_3b", dropfree=True), dev)
        res = arch_serve(card_line, dev, "granite", model, 8, (32, 512), (16, 48), seed=22)
        out["granite_serve"] = res["row"]
        with moe_capacity(model, published):
            pub = serve_run("granite_serve_published_cf", card_line, model, 8, (32, 512), (16, 48), seed=22,
                            check=False)
            # what those prefills routed (a prompt ≤ attn_chunk prefills in one piece)
            with moe_routing(model) as routed, torch.no_grad():
                for p in pub["prompts"]:
                    caches = make_caches(model.cfg, 1, len(p), DTYPES[model.cfg.dtype], dev)
                    model.prefill(torch.as_tensor(p[None], device=dev), caches)
        same = [int(np.sum(pub["engine"].result(b) == res["engine"].result(a)))
                for a, b in zip(res["rids"], pub["rids"])]
        row = {"phase": "granite_published_cf", "card": card_line, "capacity_factor": published,
               "dropfree_capacity_factor": model.cfg.moe.capacity_factor, "prefill_pairs": routed["pairs"],
               "prefill_dropped": routed["dropped"], "prefill_drop_share": routed["dropped"] / routed["pairs"],
               "tokens_equal_to_dropfree": sum(same),
               "tokens": sum(len(res["engine"].result(r)) for r in res["rids"]),
               **{k: pub["row"][k] for k in ("tokens_per_s", "ttft_p50_s", "tpot_p50_s", "wall_s", "launches")}}
        log(row)
        require(routed["dropped"] > 0, f"granite's published capacity factor dropped nothing: {row}")
        out["granite_published_cf"] = row
        del model, res, pub
        _free()
        # llama4-maverick: one layer at full width (34.7 GB), serving only, drop-free
        model = _lm(arch_config("llama4_maverick", 1, ("moe",), dropfree=True), dev)
        out["llama4_decode"] = [moe_decode(card_line, model, b) for b in (1, 8)]
        out["llama4_serve"] = arch_serve(card_line, dev, "llama4", model, 4, (32, 512), (16, 32), seed=23)["row"]
        del model
        _free()
        for arch, name in (("chatglm3_6b", "chatglm3"), ("nemotron4_15b", "nemotron")):
            model = _lm(arch_config(arch), dev)
            out[f"{name}_serve"] = arch_serve(card_line, dev, name, model, 8, (32, 512), (16, 48), seed=24)["row"]
            del model
            _free()
    launches = {}
    for row in (out["gemma3_train"], out["granite_train"], *(out[f"{n}_serve"] for n in
                ("gemma3", "granite", "llama4", "chatglm3", "nemotron"))):
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    log({"phase": "archs", "card": card_line, "launches": launches})
    return out


# ---------------------------------------------------------------------------
# Slice 11: the mamba2 (ssm) and zamba2 (ssm + shared) architectures (phase 16)
# ---------------------------------------------------------------------------

MAMBA2_TRAIN_ARGV = ("--arch", "mamba2_2p7b", "--faust", "--steps", "3", "--batch", "4", "--seq", "1024")
ZAMBA2_TRAIN_ARGV = ("--arch", "zamba2_7b", "--faust", "--steps", "3", "--batch", "4", "--seq", "1024")
ZAMBA2_UNIT = ("ssm",) * 5 + ("shared",)  # zamba2's stage unit (src/repro/configs/zamba2_7b.py)
ZAMBA2_TRAIN_LAYERS = 12  # two whole units (the full 81's AdamW state does not fit the card)
MAMBA2_TRAIN_LAYERS = 16  # of 64
# (c)-(e)'s served depths: at full depth (64 and 81 layers) the replay-bound serving took 131-158 s a
# model, most of the script's time limit (PERF.md); three of zamba2's units keep its shared block at three
# positions, each with its own KVCache
MAMBA2_SERVE_LAYERS = 16
ZAMBA2_SERVE_LAYERS = 18
# 300 and 480 lie in the band the reference's SSD rejects (above ssm.chunk 256, below attn_chunk 512);
# 300 first: the eviction takes the lowest slot's request, so its re-prefill lands in the band too
SSM_PROMPTS = (300, 200, 256, 480, 512, 700, 1024)
# the random prompts': within one SSD chunk, so they prefill whole; the fixed ones hold the band, the
# replays above attn_chunk and the ragged re-prefill (a random 425 replayed 169 tokens in each bf16 run)
SSM_LENGTHS = (32, 256)
SSM_REQUESTS = 10
SSM_EVICT_STEP = 6
SSM_MAX_LEN = 1160  # the longest prompt and 48 new tokens, with room
SSM_DECODE_PROMPT = 256
# teacher_forced(exact=): a bf16 tie's gap in units of the bf16 forward's own error, and the share of
# positions the ties may hold (sound runs on an H100: gap/err ≤ 0.96, ties 0.5-1.3 %; planted faults:
# 3.21 and 18.07 beyond, 25 % and 84 % outside the tolerance)
SSM_TIE, SSM_TIE_SHARE = 2.0, 0.05
SSM_F32_PROMPTS = (300, 1024)  # the f32 runs' two requests (300: in the band the reference's SSD rejects)
SSM_PLANTED_PROMPTS = (256, 512)  # a planted fault's two requests: aligned, so no replays to wait for


@contextlib.contextmanager
def prefill_splits():
    """Every ``LMExecutor.prefill_forward`` recorded as (prompt, prefix
    prefilled whole); the rest is replayed through decode."""
    import numpy as np

    from repro_torch.models.lm import prefill_length
    from repro_torch.runtime.engine import LMExecutor

    real = LMExecutor.prefill_forward
    seen = []

    def recording(self, slot, prompt, extras):
        seen.append((np.asarray(prompt), prefill_length(self.cfg, np.asarray(prompt).shape[-1])))
        return real(self, slot, prompt, extras)

    LMExecutor.prefill_forward = recording
    try:
        yield seen
    finally:
        LMExecutor.prefill_forward = real


def exact_copy(model):
    """An f32 copy of ``model`` (its weights converted exactly), on its
    device."""
    import dataclasses

    cfg = dataclasses.replace(model.cfg, dtype="float32")
    exact = _lm(cfg, model.embed.table.device)
    exact.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in model.state_dict().items()})
    return exact


@contextlib.contextmanager
def planted_fault(kind: str):
    """A wrong serving path, planted in ``LMExecutor`` while the block
    runs, to show that the bf16 teacher-forced check fails it:
    ``"ssm_state_zeroed"`` zeroes every mamba layer's recurrent state of
    the slot after each prefill; ``"kv_of_next_occurrence"`` runs each
    shared-block occurrence's decode against the next occurrence's
    ``KVCache`` (the last against the first's); ``"vision_ignored"``
    prefills a vision model as a text model (its token embeddings at the
    image positions, the request's ``vision_embeds`` unread);
    ``"sinusoid_at_zero"`` adds an audio model's sinusoid at position 0 in
    every decode step (the replays' too) instead of each row's own."""
    from repro_torch.layers.attention import KVCache
    from repro_torch.layers.mamba2 import MambaCache
    from repro_torch.models import lm as lm_mod
    from repro_torch.runtime.engine import LMExecutor

    if kind == "vision_ignored":
        name, real = "prefill_forward", LMExecutor.prefill_forward

        def faulty(self, slot, prompt, extras):
            front = lm_mod.LM._front
            lm_mod.LM._front = lambda model, tokens, vision_embeds: model._embed_tokens(tokens)
            try:
                return real(self, slot, prompt, extras)
            finally:
                lm_mod.LM._front = front
    elif kind == "sinusoid_at_zero":
        name, real = "_decode", LMExecutor._decode

        def faulty(self, tokens, slot_idx):
            sinusoid = lm_mod.sinusoid
            lm_mod.sinusoid = lambda d_model, pos0, s, device: sinusoid(d_model, 0, s, device)
            try:
                return real(self, tokens, slot_idx)
            finally:
                lm_mod.sinusoid = sinusoid
    elif kind == "ssm_state_zeroed":
        name, real = "prefill_forward", LMExecutor.prefill_forward

        def faulty(self, slot, prompt, extras):
            logits = real(self, slot, prompt, extras)
            for c in self.pool:
                if isinstance(c, MambaCache):
                    c.ssm[slot].zero_()
            return logits
    else:
        require(kind == "kv_of_next_occurrence", f"unknown planted fault {kind!r}")
        name, real = "_decode", LMExecutor._decode

        def faulty(self, tokens, slot_idx):
            idx = [i for i, c in enumerate(self.pool) if isinstance(c, KVCache)]
            own = [self.pool[i] for i in idx]
            for i, c in zip(idx, own[1:] + own[:1]):
                self.pool[i] = c
            try:
                return real(self, tokens, slot_idx)
            finally:
                for i, c in zip(idx, own):
                    self.pool[i] = c

    setattr(LMExecutor, name, faulty)
    try:
        yield
    finally:
        setattr(LMExecutor, name, real)


def planted_serve(card_line: str, name: str, model, exact, kind: str, prompts: tuple = SSM_PLANTED_PROMPTS,
                  max_len: int = SSM_MAX_LEN) -> dict:
    """Two requests (``prompts``, prefilled whole, then decode) served by
    ``model`` under :func:`planted_fault` ``kind``; the bf16 teacher-forced
    check against ``exact`` must fail them."""
    with planted_fault(kind):
        res = serve_run(f"{name}_planted_{kind}", card_line, model, 2, SSM_LENGTHS, (32, 32),
                        fixed=prompts, seed=27, max_len=max_len, check=False)
    tf = teacher_forced(model, res["engine"], res["rids"], res["prompts"], SERVE_TOL[model.cfg.dtype],
                        exact=exact, enforce=False, extras=res["extras"])
    row = {"phase": f"{name}_planted_fault", "card": card_line, "fault": kind, "teacher_forced": tf}
    log(row)
    require(not tf["passed"], f"{name}: the planted fault {kind!r} passed the teacher-forced check: {row}")
    return row


def ssm_serve(card_line: str, dev, name: str, model, exact) -> dict:
    """The engine over the bf16 ``model`` (:func:`serve_run`) on
    ``SSM_REQUESTS`` requests (prompts ``SSM_PROMPTS`` and random ones over
    ``SSM_LENGTHS``, budgets 16-48, one live request evicted at step
    ``SSM_EVICT_STEP``), every request ``done``, each prefill's split
    recorded (the prompts in the band the reference's SSD rejects and the
    eviction's ragged re-prefill must have been served), the teacher-forced
    check against ``exact`` (:func:`teacher_forced`), its parameter
    count and its head's K1 against plain."""
    params = param_check(name, model)
    chunk, attn = model.cfg.ssm.chunk, model.cfg.attn_chunk
    with prefill_splits() as seen:
        res = serve_run(f"{name}_serve", card_line, model, SSM_REQUESTS, SSM_LENGTHS, (16, 48), fixed=SSM_PROMPTS,
                        seed=25, max_len=SSM_MAX_LEN, evict_step=SSM_EVICT_STEP, check=False)
    row = res["row"]
    prompts = {p.tobytes() for p in res["prompts"]}
    splits = [(len(p), head) for p, head in seen]
    band = [n for n, _ in splits if chunk < n < attn and n % chunk]
    again = [(len(p), head) for p, head in seen if p.tobytes() not in prompts]  # prompt + generated
    row["prefills"] = {"ssm_chunk": chunk, "attn_chunk": attn, "prefills": splits,
                       "replayed_tokens": sum(n - h for n, h in splits), "reference_ssd_rejects": band,
                       "reprefill": again}
    require(len(band) >= 2, f"{name}: fewer than two prompts in the band the reference's SSD rejects: {row}")
    require(len(again) == 1 and again[0][0] % chunk, f"{name}: the eviction's re-prefill is not ragged: {row}")
    row["teacher_forced"] = teacher_forced(model, res["engine"], res["rids"], res["prompts"],
                                           SERVE_TOL[model.cfg.dtype], exact=exact)
    row.update(params)
    row["head_checks"] = arch_heads(card_line, dev, name, model, max(row["prompt_lengths"]))
    log({"phase": f"{name}_serve_summary", "card": card_line, **params,
         **{k: row[k] for k in ("tokens_per_s", "ttft_p50_s", "tpot_p50_s", "prefill_s", "decode_s", "wall_s",
                                "max_memory_allocated_gb", "launches", "teacher_forced", "prefills")},
         "head_k1_rel_err": max(c["k1_rel_err"] for c in row["head_checks"])})
    return res


def ssm_serve_f32(card_line: str, name: str, exact) -> dict:
    """The f32 copy served (:func:`serve_run`: prompts ``SSM_F32_PROMPTS``,
    an eviction) and held teacher-forced within 1e-4: the aligned prefill,
    the replays, the recurrent decode and the re-prefill against one
    chunked pass."""
    return serve_run(f"{name}_serve_f32", card_line, exact, len(SSM_F32_PROMPTS), SSM_LENGTHS, (8, 16),
                     fixed=SSM_F32_PROMPTS, seed=26, max_len=SSM_MAX_LEN, evict_step=3)["row"]


def state_bytes(caches, batch: int) -> int:
    """What a decode step of ``batch`` rows must read and write of the
    mamba layers' state: each row's recurrent state, conv history and
    position, once each way."""
    from repro_torch.layers.mamba2 import MambaCache

    per_row = sum(sum(t[0].numel() * t.element_size() for t in c) for c in caches if isinstance(c, MambaCache))
    return 2 * batch * per_row


def ssm_decode(card_line: str, model, batch: int, prompt_len: int = SSM_DECODE_PROMPT) -> dict:
    """A mamba model's decode step at ``batch`` live rows after prefills of
    ``prompt_len`` tokens: the step's host seconds (median of 5), kernel
    launches, one step under the profiler, beside the bound of the weights
    read once and the state read and written (:func:`state_bytes`)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.engine import LMExecutor

    cfg = model.cfg
    rng = np.random.default_rng(12)
    ex = LMExecutor(model, prompt_len + 64, batch)
    for slot in range(batch):
        ex.prefill_forward(slot, rng.integers(0, cfg.vocab, size=prompt_len).astype(np.int32), {})
    slots, toks = list(range(batch)), rng.integers(0, cfg.vocab, size=(batch, 1))
    for _ in range(2):
        ex.decode_forward(slots, toks)
    _zero_counts()
    ex.decode_forward(slots, toks)
    counts = _serve_counts()
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        ex.decode_forward(slots, toks)
        steps.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.decode_forward(slots, toks)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    bound = weight_bound(model, batch)
    state = state_bytes(ex.pool, batch)
    row = {"phase": "ssm_decode", "card": card_line, "arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
           "decode_step_s": statistics.median(steps), "decode_step_s_all": steps, "launches_per_step": counts,
           **bound, "state_bytes": state, "weight_state_bytes": bound["weight_bytes"] + state,
           "weight_state_bound_ms": (bound["weight_bytes"] + state) / HBM_BW * 1e3, **device_spans(prof, prof_s)}
    log(row)
    require(counts["chain_matmul"] + counts["bsr_matmul"] > 0, f"the decode step launched neither K1 nor K6: {row}")
    return row


def ssm_archs(card_line: str, dev) -> dict:
    """Phase 16, slice 11: mamba2-2.7b and zamba2-7b at their published
    widths with the FAµST unembedding (module docstring); every model
    freed before the next."""
    from repro_torch.layers.attention import KVCache
    from repro_torch.layers.mamba2 import MambaCache

    out = {}
    with _fresh_tables("chip_smoke_ssm_autotune"):
        out["mamba2_train"] = arch_train(card_line, "mamba2", MAMBA2_TRAIN_ARGV, MAMBA2_TRAIN_LAYERS, ("ssm",))
        out["zamba2_train"] = arch_train(card_line, "zamba2", ZAMBA2_TRAIN_ARGV, ZAMBA2_TRAIN_LAYERS, ZAMBA2_UNIT)
        out.update(ssm_serving(card_line, dev, MAMBA2_SERVE_LAYERS, ZAMBA2_SERVE_LAYERS))
    launches = {}
    for row in (out["mamba2_train"], out["zamba2_train"], out["mamba2_serve"], out["mamba2_serve_f32"],
                out["zamba2_serve"], out["zamba2_serve_f32"]):
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    log({"phase": "ssm_archs", "card": card_line, "launches": launches})
    return out


def ssm_serving(card_line: str, dev, mamba_layers: int | None, zamba_layers: int | None) -> dict:
    """Phase 16 (c)-(e): mamba2 cut to ``mamba_layers`` and zamba2 to
    ``zamba_layers`` (whole units; ``None``: full depth) served, bf16 and
    f32, zamba2's two planted faults, mamba2's decode step; the rows and
    the seconds it took."""
    from repro_torch.configs import get_config
    from repro_torch.layers.attention import KVCache
    from repro_torch.layers.mamba2 import MambaCache

    t0 = time.perf_counter()
    out = {}
    model = _lm(arch_config("mamba2_2p7b", mamba_layers, ("ssm",)), dev)
    exact = exact_copy(model)
    out["mamba2_serve"] = ssm_serve(card_line, dev, "mamba2", model, exact)["row"]
    out["mamba2_decode"] = [ssm_decode(card_line, model, b) for b in (1, 8)]
    del model
    _free()
    # the f32 model served: prefill, replays, recurrent decode and eviction against one chunked pass at 1e-4
    out["mamba2_serve_f32"] = ssm_serve_f32(card_line, "mamba2", exact)
    del exact
    _free()
    model = _lm(arch_config("zamba2_7b", zamba_layers, ZAMBA2_UNIT), dev)
    exact = exact_copy(model)
    res = ssm_serve(card_line, dev, "zamba2", model, exact)
    out["zamba2_serve"] = res["row"]
    pool = res["engine"].executor.pool
    kinds = {"MambaCache": sum(isinstance(c, MambaCache) for c in pool),
             "KVCache": sum(isinstance(c, KVCache) for c in pool)}
    log({"phase": "zamba2_pool", "card": card_line, "caches": kinds, "layers": len(pool)})
    want = {"MambaCache": model.cfg.layer_kinds().count("ssm"), "KVCache": model.cfg.layer_kinds().count("shared")}
    require(kinds == want and (zamba_layers is not None or want == {"MambaCache": 68, "KVCache": 13}),
            f"zamba2's pool holds {kinds}, want {want}")
    del res, pool
    out["zamba2_planted"] = [planted_serve(card_line, "zamba2", model, exact, kind)
                             for kind in ("ssm_state_zeroed", "kv_of_next_occurrence")]
    del model
    _free()
    out["zamba2_serve_f32"] = ssm_serve_f32(card_line, "zamba2", exact)
    del exact
    _free()
    layers = {"mamba2": mamba_layers or get_config("mamba2_2p7b").n_layers,
              "zamba2": zamba_layers or get_config("zamba2_7b").n_layers}
    log({"phase": "ssm_serving", "card": card_line, "layers": layers, "seconds": time.perf_counter() - t0})
    return out


# ---------------------------------------------------------------------------
# Slice 12: the modality front ends (phase 17)
# ---------------------------------------------------------------------------

INTERNVL2_TRAIN_ARGV = ("--arch", "internvl2_2b", "--faust", "--steps", "3", "--batch", "4", "--seq", "1024")
MUSICGEN_TRAIN_ARGV = ("--arch", "musicgen_medium", "--faust", "--steps", "3", "--batch", "8", "--seq", "1024")
MUSICGEN_TRAIN_LAYERS = 12  # of 48
# served prompts: above attn_chunk 512 only the 600s are ragged (512 prefilled, 88 replayed); internvl2's
# hold its 256 image positions, its three random ones stay within 256-512 so that they prefill whole
INTERNVL2_PROMPTS = (256, 300, 512, 600, 1024)
INTERNVL2_LENGTHS = (256, 512)
MUSICGEN_PROMPTS = (64, 128, 256, 512, 600, 1024)
MUSICGEN_LENGTHS = (32, 512)
MODALITY_REQUESTS = 8
MODALITY_BUDGETS = (16, 32)
MODALITY_EVICT_STEP = 4  # the first prompt's request (slot 0): its re-prefill is prompt + generated
MODALITY_MAX_LEN = 1088  # the longest prompt and 32 new tokens, with room
MODALITY_PLANTED_PROMPTS = (256, 512)  # a planted fault's two requests: aligned, so no replays to wait for
MODALITY_REPLAYED = [600]  # the prompt lengths that may replay


def modality_serve(card_line: str, dev, name: str, model, exact, prompts: tuple, lengths: tuple, seed: int,
                   rows: int) -> dict:
    """The engine over the bf16 ``model`` (:func:`serve_run`) on
    ``MODALITY_REQUESTS`` requests (prompts ``prompts`` and random ones
    over ``lengths``, a vision model's each with its own
    ``vision_embeds``; budgets 16-32; one live request evicted at step
    ``MODALITY_EVICT_STEP``), every request ``done``, each prefill's split
    recorded (only the 600-token prompts may replay, and every prefix holds
    the image positions), the teacher-forced check against ``exact`` per
    codebook with each request's extras (:func:`teacher_forced`), the
    parameter count, and every head's K1 and K6 against their plain
    versions at B = 1, 8 and the trainer's ``rows``."""
    params = param_check(name, model)
    with prefill_splits() as seen:
        res = serve_run(f"{name}_serve", card_line, model, MODALITY_REQUESTS, lengths, MODALITY_BUDGETS,
                        fixed=prompts, seed=seed, max_len=MODALITY_MAX_LEN, evict_step=MODALITY_EVICT_STEP,
                        check=False)
    row = res["row"]
    splits = [(p.shape[-1], head) for p, head in seen]
    replayed = sorted({n for n, head in splits if head < n})
    row["prefills"] = {"attn_chunk": model.cfg.attn_chunk, "n_vision_tokens": model.cfg.n_vision_tokens,
                       "prefills": splits, "replayed_lengths": replayed,
                       "replayed_tokens": sum(n - head for n, head in splits)}
    require(len(splits) == MODALITY_REQUESTS + 1, f"{name}: {len(splits)} prefills, want one a request and the "
                                                  f"eviction's: {row['prefills']}")
    require(replayed == MODALITY_REPLAYED, f"{name}: replayed prompts {replayed}, want only {MODALITY_REPLAYED}")
    require(all(head >= model.cfg.n_vision_tokens for _, head in splits), f"{name}: a prefix without every image "
                                                                          f"position: {row['prefills']}")
    row["teacher_forced"] = teacher_forced(model, res["engine"], res["rids"], res["prompts"],
                                           SERVE_TOL[model.cfg.dtype], exact=exact, extras=res["extras"])
    row.update(params)
    row["head_checks"] = arch_heads(card_line, dev, name, model, rows)
    log({"phase": f"{name}_serve_summary", "card": card_line, **params,
         **{k: row[k] for k in ("tokens_per_s", "ttft_p50_s", "tpot_p50_s", "prefill_s", "decode_s", "wall_s",
                                "max_memory_allocated_gb", "launches", "teacher_forced", "prefills")},
         "head_k1_rel_err": max(c["k1_rel_err"] for c in row["head_checks"])})
    return res


def modality(card_line: str, dev) -> dict:
    """Phase 17, slice 12: internvl2-2b (vision) and musicgen-medium (four
    codebooks, sinusoidal positions) at their published widths and full
    depth with the FAµST unembedding (module docstring); every model freed
    before the next."""
    out = {}
    with _fresh_tables("chip_smoke_modality_autotune"):
        out["internvl2_train"] = arch_train(card_line, "internvl2", INTERNVL2_TRAIN_ARGV, per_step=1)
        out["musicgen_train"] = arch_train(card_line, "musicgen", MUSICGEN_TRAIN_ARGV, MUSICGEN_TRAIN_LAYERS, ("attn",),
                                           per_step=4)
        serving = (("internvl2_2b", "internvl2", INTERNVL2_PROMPTS, INTERNVL2_LENGTHS, 31, "vision_ignored",
                    INTERNVL2_TRAIN_ARGV),
                   ("musicgen_medium", "musicgen", MUSICGEN_PROMPTS, MUSICGEN_LENGTHS, 32, "sinusoid_at_zero",
                    MUSICGEN_TRAIN_ARGV))
        for arch, name, prompts, lengths, seed, fault, argv in serving:
            rows = int(argv[argv.index("--batch") + 1]) * int(argv[argv.index("--seq") + 1])
            model = _lm(arch_config(arch), dev)
            exact = exact_copy(model)
            out[f"{name}_serve"] = modality_serve(card_line, dev, name, model, exact, prompts, lengths, seed,
                                                  rows)["row"]
            out[f"{name}_planted"] = planted_serve(card_line, name, model, exact, fault, MODALITY_PLANTED_PROMPTS,
                                                   MODALITY_MAX_LEN)
            del model, exact
            _free()
    launches = {}
    for row in (out["internvl2_train"], out["musicgen_train"], out["internvl2_serve"], out["musicgen_serve"]):
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    log({"phase": "modality", "card": card_line, "launches": launches})
    return out


# ---------------------------------------------------------------------------
# Slice 13: the FAµST operator on a mesh (phase 18)
# ---------------------------------------------------------------------------

MESH = (2, 2)  # ("data", "model"): four ranks sharing the one card over gloo
MESH_TIMEOUT_S = 240  # a rank waiting in a collective longer than this fails
MESH_JOIN_S = 900  # the whole 4-rank run
# (c): four ranks gather every layer's weights through host memory each
# forward (≈ 2 s a forward on one card), so the trace is short: 4
# requests over 4 slots (two rows a data rank), budgets 4-8, the first a
# fixed 509-token prompt with 8 tokens, evicted at step 4: its re-prefill
# (509 + 5) prefills 512 positions split over the model ranks at 288 and
# replays 2 through the split cache's decode.  The planted faults run 2
# requests of 4 tokens: the skipped boundary gather on prompts 64 and 128,
# the skipped merge on 320 and 400 (positions in both blocks)
MESH_REQUESTS, MESH_LENGTHS, MESH_BUDGETS, MESH_SLOTS = 4, (32, 256), (4, 8), 4
MESH_FIXED, MESH_FIRST_BUDGET, MESH_EVICT_STEP = (509,), 8, 4
MESH_PLANTED_PROMPTS, MESH_MERGE_PLANTED_PROMPTS, MESH_PLANTED_BUDGET = (64, 128), (320, 400), 4
MESH_SERVER_TOKENS = 2  # Server(mesh=): two 32-token prompts
# the skipped merge's runs scale every layer's attention values and output
# (wv, wo) by this, on the sharded model and on rank 0's whole copy: at
# random init attention moves the residual stream too little for a wrong
# one to move a greedy token or the teacher-forced gap (unscaled on the
# card: 8 of 8 positions exact with the merge skipped)
MESH_PLANTED_GAIN = 8.0
MESH_MAX_LEN = 576  # the longest prompt and its tokens, with room; 288 positions a model rank
MESH_UP = ((2048, 16384), 128)  # (a): phase 3's up-projection and block
MESH_BATCHES = (128, 4096)
MESH_ODD_BLOCKS = 127  # (a)'s replicated chain: out-blocks that do not divide the model axis
MESH_HEAD = ((2048, 256000), 16, 4, 1024)  # (b): the head's (in, out), block, k, and K2/K3 rows
MESH_ROUNDS = 5  # alternating timed calls a variant in the 4-rank run (one card shared by four ranks)
NCCL_ROUNDS = 50  # the 1 × 1 NCCL mesh's alternating calls a variant
_ROWS = None  # a mesh rank's rows, saved for the parent instead of printed


def _mesh_counts() -> dict:
    from repro_torch.kernels.chain_sharded import COLLECTIVES

    return {**_bwd_counts(), **{f"coll_{k}": v for k, v in COLLECTIVES.items()}}


def _zero_mesh_counts() -> None:
    from repro_torch.kernels.chain_sharded import COLLECTIVES

    _zero_counts()
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))


def _digest(tensors) -> str:
    """A digest of the tensors' bits (the ranks' copies compared)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _local_chain(dev, dims, blk: int, k: int = 4, seed: int = 40):
    """A chain whose out-blocks read only input blocks of their own model
    rank (two ranks): no boundary crosses, one K1 a rank."""
    import numpy as np
    import torch

    from repro_torch.core.compress import BlockFaust, BlockSparseFactor

    rng = np.random.default_rng(seed)
    factors = []
    for in_f, out_f in zip(dims[:-1], dims[1:]):
        ob, per = out_f // blk, (in_f // blk) // MESH[1]
        idx = np.stack([np.sort(rng.choice(per, size=k, replace=False)) + (o // (ob // MESH[1])) * per
                        for o in range(ob)]).astype(np.int32)
        vals = (rng.standard_normal((ob, k, blk, blk)) / np.sqrt(k * blk)).astype(np.float32)
        factors.append(BlockSparseFactor(torch.as_tensor(vals, device=dev), torch.as_tensor(idx, device=dev),
                                         in_f, out_f))
    return BlockFaust(tuple(factors), torch.ones((), device=dev))


def _mesh_grads(op, x, dy, backend: str):
    """(y, dx, d trained tensor) of ``sum(op.apply(x) * dy)`` on a fresh
    leaf copy of ``op``'s trained tensor (:func:`_trainable`)."""
    top, leaf = _trainable(op)
    top = top.with_sharding(op.shard) if op.shard is not None else top
    xg = x.clone().requires_grad_(True)
    y = top.apply(xg, backend, device=x.device)
    (y.float() * dy).sum().backward()
    return y.detach(), xg.grad, leaf.grad


def mesh_operator(card_line: str, dev, mesh) -> dict:
    """Phase 18 (a) on one rank: phase 3's up-projection factorized with
    ``FactorizeSpec(mesh=)`` (rank 0 solves), the sharded apply against
    the single-card fused apply on the same card (f32 and bf16, B = 128 and
    4096, forward and fwd+bwd; int8), a local-support chain, a replicated
    chain (127 out-blocks), a chain that does not pack, the report under
    ``auto``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api import FactorizeSpec, FaustOp, factorize, last_report
    from repro_torch.api.operator import ShardSpec
    from repro_torch.core.compress import BlockFaust, pack_chain, quantize_chain, random_block_factor
    from repro_torch.kernels import chain_sharded as cs

    spec = ShardSpec(mesh)
    (d, n), blk = MESH_UP
    w = np.random.default_rng(0).standard_normal((d, n), dtype=np.float32) / np.sqrt(d)
    t0 = time.perf_counter()
    op, info = factorize(w, FactorizeSpec(strategy="hierarchical", n_factors=3, block=blk, k_first=4, k_mid=4,
                                          mesh=mesh), device=dev)
    torch.cuda.synchronize()
    plan = op._shard_plan()
    nseg = plan.n_launches
    out = {"factorize_s": time.perf_counter() - t0, "chain_digest": _digest(op._tensors()),
           "summary": {k: v for k, v in plan.summary().items()}, "rows": []}
    log({"phase": "mesh_factorize", "card": card_line, "seconds": out["factorize_s"], "digest": out["chain_digest"],
         "sharded": op.shard == spec, "summary": out["summary"], "sweeps": info.n_sweeps})
    require(op.shard == spec and plan.mode == "model", f"the placed operator: {out['summary']}")
    g = torch.Generator().manual_seed(1)
    launches = dict.fromkeys(("chain_matmul", "chain_dgrad", "chain_wgrad", "chain_matmul_q", "chain_dgrad_q",
                              "chain_wgrad_q", "bsr_matmul"), 0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for b in MESH_BATCHES:
            x = torch.randn((b, d), generator=g).to(dev, dtype)
            dy = torch.randn((b, n), generator=g).to(dev)
            with torch.no_grad():
                _zero_mesh_counts()
                y = op.apply(x, "fused_sharded", device=dev)
                torch.cuda.synchronize()
                fwd = _mesh_counts()
                y1 = op.apply(x, "fused", device=dev)
            _zero_mesh_counts()
            ys, dxs, dvs = _mesh_grads(op, x, dy, "fused_sharded")
            torch.cuda.synchronize()
            bwd = _mesh_counts()
            add(fwd), add(bwd)
            y1g, dx1, dv1 = _mesh_grads(op.with_sharding(None), x, dy, "fused")
            with torch.no_grad():
                times = interleaved_ms({"sharded": lambda: op.apply(x, "fused_sharded", device=dev),
                                        "fused": lambda: op.apply(x, "fused", device=dev)}, MESH_ROUNDS)
            row = {"phase": "mesh_apply", "card": card_line, "dtype": dname, "batch": b,
                   "rel_err": rel_err(y, y1)[1], "rel_err_fwdbwd_y": rel_err(ys, y1g)[1],
                   "rel_err_dx": rel_err(dxs, dx1)[1], "rel_err_dvalues": rel_err(dvs, dv1)[1],
                   "tol": TOL[dname], "fwd_launches": fwd, "fwdbwd_launches": bwd,
                   "sharded_ms_p50": statistics.median(times["sharded"]),
                   "fused_ms_p50": statistics.median(times["fused"]),
                   "timing": "one card shared by four ranks (not a multi-GPU number)"}
            log(row)
            out["rows"].append(row)
            require(max(row["rel_err"], row["rel_err_fwdbwd_y"], row["rel_err_dx"], row["rel_err_dvalues"])
                    <= TOL[dname], f"the sharded apply disagrees with the fused one: {row}")
            require(fwd["chain_matmul"] == nseg and fwd["coll_boundary_gather"] == len(plan.crossing_feats),
                    f"forward launches {fwd}, want {nseg} K1")
            require(bwd["chain_dgrad"] == nseg and bwd["chain_wgrad"] == nseg, f"backward launches {bwd}")
    # int8 (K4, K5): the codes split by out-block with their scales
    qop = FaustOp(quantize_chain(pack_chain(op.rep), "int8", "per_block"), shard=spec)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        x = torch.randn((MESH_BATCHES[0], d), generator=g).to(dev, dtype)
        dy = torch.randn((MESH_BATCHES[0], n), generator=g).to(dev)
        _zero_mesh_counts()
        ys, dxs, dss = _mesh_grads(qop, x, dy, "fused_sharded")
        torch.cuda.synchronize()
        counts = _mesh_counts()
        add(counts)
        y1, dx1, ds1 = _mesh_grads(qop.with_sharding(None), x, dy, "fused")
        row = {"phase": "mesh_apply_int8", "card": card_line, "dtype": dname, "batch": MESH_BATCHES[0],
               "rel_err": rel_err(ys, y1)[1], "rel_err_dx": rel_err(dxs, dx1)[1],
               "rel_err_dscales": rel_err(dss, ds1)[1], "tol": TOL[dname], "launches": counts}
        log(row)
        out["rows"].append(row)
        require(max(row["rel_err"], row["rel_err_dx"], row["rel_err_dscales"]) <= TOL[dname], f"int8: {row}")
        require(counts["chain_matmul_q"] == nseg and counts["chain_dgrad_q"] == nseg
                and counts["chain_wgrad_q"] == nseg, f"int8 launches {counts}")
    # a local-support chain, a replicated one, one that does not pack
    gen = torch.Generator().manual_seed(41)
    odd = BlockFaust(tuple(random_block_factor(i, o, blk, blk, 4, generator=gen, device=dev)
                           for i, o in ((d, d), (d, MESH_ODD_BLOCKS * blk))), torch.ones((), device=dev))
    mixed = BlockFaust((random_block_factor(d, d, blk, blk, 4, generator=gen, device=dev),
                        random_block_factor(d, 2 * d, blk // 2, blk // 2, 4, generator=gen, device=dev)),
                       torch.ones((), device=dev))
    x = torch.randn((MESH_BATCHES[0], d), generator=g).to(dev)
    for name, bf, want_mode, kernel, want in (("local", _local_chain(dev, (d,) * 4, blk), "model", "chain_matmul", 1),
                                              ("replicated", odd, "replicated", "chain_matmul", 1),
                                              ("per_factor", mixed, "replicated", "bsr_matmul", 2)):
        sop = FaustOp(cs.place_blockfaust(bf, mesh), shard=spec)
        p = sop._shard_plan()
        with torch.no_grad():
            _zero_mesh_counts()
            y = sop.apply(x, "fused_sharded", device=dev)
            torch.cuda.synchronize()
            counts = _mesh_counts()
            add(counts)
            y1 = sop.apply(x, "fused" if p.fusable else "bsr", device=dev)
        row = {"phase": "mesh_chain", "card": card_line, "chain": name, "summary": p.summary(),
               "batch": MESH_BATCHES[0], "collective_bytes": p.collective_bytes(MESH_BATCHES[0], 4),
               "rel_err": rel_err(y, y1)[1],
               "launches": counts}
        log(row)
        out["rows"].append(row)
        require(p.mode == want_mode and counts[kernel] == want and row["rel_err"] <= TOL["float32"],
                f"{name}: {row}")
        if name == "local":
            require(p.crossing_feats == () and row["collective_bytes"] == 0
                    and counts["coll_boundary_gather"] == 0, f"the local chain gathered: {row}")
    for b in MESH_BATCHES:
        with torch.no_grad():
            op.apply(torch.randn((b, d), generator=g).to(dev), "auto", device=dev)
        log({"phase": "mesh_auto", "card": card_line, "batch": b, "report": last_report().as_row()})
    out["launches"] = launches
    log({"phase": "mesh_operator_launches", "card": card_line, "launches": launches})
    require(all(v > 0 for v in launches.values()), f"a kernel of the sharded path never ran: {launches}")
    return out


def mesh_head(card_line: str, dev, mesh) -> dict:
    """Phase 18 (b) on one rank: gemma-2b's FAµST head (2048 → 2048 →
    256000, block 16, k 4, bf16) as a ``FaustLinear`` with ``shard``: this
    rank's K1 at B = 1 and 8 and its K2/K3 at 1024 rows, each segment at
    this rank's plan, against their plain versions; the sharded head
    against the unsharded one."""
    import torch

    from repro_torch.api.operator import ShardSpec
    from repro_torch.kernels import chain_sharded as cs
    from repro_torch.kernels.chain import FORWARD_BT, chain_matmul, chain_matmul_plain
    from repro_torch.kernels.chain_bwd import (DGRAD_BT, WGRAD_BT, chain_dgrad, chain_dgrad_plain, chain_wgrad,
                                               chain_wgrad_plain, dgrad_meta, wgrad_meta)
    from repro_torch.kernels.ops import chain_meta
    from repro_torch.layers.faust_linear import FaustLinear, FaustSpec

    (d, vocab), blk, k, rows_bwd = MESH_HEAD
    head = FaustLinear(d, vocab, FaustSpec(2, blk, k, shard=ShardSpec(mesh)),
                       generator=torch.Generator().manual_seed(5), dtype=torch.bfloat16, device=dev)
    bf = head.blockfaust()
    plan = cs.plan_shard(bf, mesh)
    p = mesh.coord["model"]
    g = torch.Generator().manual_seed(6)
    rows = []
    with torch.no_grad():
        for s, seg in enumerate(plan.segments):
            vals, idx = cs.segment_values(bf, seg, p), cs.segment_idx(bf, seg, p)
            sp = seg.plan
            meta = chain_meta(sp, idx)
            for b in (1, 8):
                x = torch.randn((b, sp.in_features), generator=g).to(dev, torch.bfloat16)
                _zero_counts()
                err = rel_err(chain_matmul(x, vals, meta, plan=sp, bt=FORWARD_BT),
                              chain_matmul_plain(x, vals, meta, plan=sp))[1]
                k1 = _bwd_counts()["chain_matmul"]
                rows.append({"kernel": "chain_matmul", "segment": s, "batch": b, "rel_err": err, "launches": k1})
            x = torch.randn((rows_bwd, sp.in_features), generator=g).to(dev, torch.bfloat16)
            dy = torch.randn((rows_bwd, sp.out_features), generator=g).to(dev, torch.bfloat16)
            dm, wm = dgrad_meta(sp, idx), wgrad_meta(sp, idx)
            _zero_counts()
            dgrad = rel_err(chain_dgrad(dy, vals, dm, plan=sp, bt=DGRAD_BT), chain_dgrad_plain(dy, vals, dm, plan=sp))[1]
            wgrad = rel_err(chain_wgrad(x, dy, vals, wm, plan=sp, bt=WGRAD_BT),
                            chain_wgrad_plain(x, dy, vals, wm, plan=sp))[1]
            c = _bwd_counts()
            rows.append({"kernel": "chain_dgrad", "segment": s, "batch": rows_bwd, "rel_err": dgrad,
                         "launches": c["chain_dgrad"]})
            rows.append({"kernel": "chain_wgrad", "segment": s, "batch": rows_bwd, "rel_err": wgrad,
                         "launches": c["chain_wgrad"]})
        for b in (1, 8):
            x = torch.randn((b, d), generator=g).to(dev, torch.bfloat16)
            y, y1 = head(x, "fused_sharded"), head(x, "fused")
            rows.append({"kernel": "head", "batch": b, "rel_err": rel_err(y, y1)[1], "shape": list(y.shape)})
    row = {"phase": "mesh_head", "card": card_line, "rank_model_coord": p, "summary": plan.summary(),
           "segment_plans": [{"in_blocks": s.plan.in_blocks, "out_blocks": s.plan.out_blocks} for s in plan.segments],
           "checks": rows, "tol": TOL["bfloat16"]}
    log(row)
    require(all(r["rel_err"] <= TOL["bfloat16"] for r in rows), f"the head's kernels disagree: {row}")
    require(all(r.get("launches", 1) == 1 for r in rows), f"the head's checks launched: {row}")
    return row


@contextlib.contextmanager
def boundary_gather_skipped():
    """While it runs, a model-mode apply skips each crossing all-gather and
    reads only this rank's block of the activation (zeros elsewhere)."""
    import torch

    from repro_torch.kernels import chain_sharded as cs

    real = cs._BoundaryGather.apply

    def local_only(y, group):
        n, p = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        out = y.new_zeros((y.shape[0], y.shape[1] * n))
        out[:, p * y.shape[1]:(p + 1) * y.shape[1]] = y
        return out

    cs._BoundaryGather.apply = local_only
    try:
        yield
    finally:
        cs._BoundaryGather.apply = real


def _layout_counts() -> dict:
    """The model's collectives since the last call (``distributed/layout``:
    calls and bytes by purpose), zeroed."""
    from repro_torch.distributed.layout import BYTES, COLLECTIVES

    out = {"calls": dict(COLLECTIVES), "bytes": dict(BYTES)}
    for d in (COLLECTIVES, BYTES):
        d.update(dict.fromkeys(d, 0))
    return out


def pool_bytes(ex) -> dict:
    """The bytes of an executor's slot pool on this rank: the K/V of the
    caches a decode policy splits (``lm.SPLIT_KV_KINDS``), the same K/V
    whole (every slot, every position), and the rest."""
    from repro_torch.models.lm import SPLIT_KV_KINDS

    cfg = ex.cfg
    kinds = cfg.layer_kinds()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    kv = nbytes(t for kind, c in zip(kinds, ex.pool) if kind in SPLIT_KV_KINDS for t in (c.k, c.v))
    n_split = sum(kind in SPLIT_KV_KINDS for kind in kinds)
    whole = 2 * n_split * ex.n_slots * cfg.n_kv_heads * ex.max_len * cfg.head_dim * ex.pool[0].k.element_size()
    return {"split_kv": kv, "split_kv_whole": whole, "rest": nbytes(t for c in ex.pool for t in c) - kv}


def _mesh_engine(name: str, card_line: str, model, mesh, prompts, budgets, evict_step: int | None = None) -> dict:
    """``Engine(LMExecutor(model, MESH_MAX_LEN, MESH_SLOTS, mesh=))`` on the
    trace (one eviction at ``evict_step``): the report with the kernels'
    and both collectives' counts (the sharded head's, the model's calls and
    bytes by purpose), this rank's pool bytes and idle steps."""
    import torch

    from repro_torch.runtime.engine import Engine, LMExecutor

    torch.cuda.reset_peak_memory_stats()
    ex = LMExecutor(model, MESH_MAX_LEN, MESH_SLOTS, mesh=mesh)
    engine = Engine(ex)
    _zero_mesh_counts()
    _layout_counts()
    t0 = time.perf_counter()
    rids, steps = drive(engine, prompts, budgets, len(prompts), evict_step=evict_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _mesh_counts()
    row = engine_report(name, card_line, engine, steps, counts, wall_s)
    model_coll = _layout_counts()
    forwards = engine.stats.steps + engine.stats.admitted
    row.update(model_collectives=model_coll, pool_bytes=pool_bytes(ex), idle_steps=ex.idle_steps,
               rows_axes=list(ex.rows), kv_block=None if ex.kv is None else [ex.kv.start, ex.kv.local],
               bytes_per_decode_step={k: v / max(engine.stats.steps, 1) for k, v in model_coll["bytes"].items()
                                      if k in ("kv_merge", "row_gather")},
               param_gather_bytes_per_forward=model_coll["bytes"]["param_gather"] / max(forwards, 1))
    if evict_step is not None:
        require(engine.stats.evicted == 1, f"{name}: {engine.stats.evicted} evictions, want 1")
    tokens = [engine.result(r).tolist() for r in rids]
    row["tokens_digest"] = _digest([torch.as_tensor(sum(tokens, []))])
    return {"row": row, "engine": engine, "rids": rids, "tokens": tokens}


def _louder(model) -> None:
    """Scale every layer's attention ``wv`` and ``wo`` (this rank's blocks
    of them on a mesh) by ``MESH_PLANTED_GAIN``, in place."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("attn.wv", "attn.wo")):
                p.mul_(MESH_PLANTED_GAIN)


@contextlib.contextmanager
def merge_skipped():
    """While it runs, each rank of a split KV cache attends over its own
    block of the positions only: the blocks' log-sum-exp merge over the
    ``kv_seq`` group is skipped."""
    from repro_torch.layers import attention

    real = attention.merge_blocks
    attention.merge_blocks = lambda t, seq, op="sum": t
    try:
        yield
    finally:
        attention.merge_blocks = real


def mesh_serve(card_line: str, dev, mesh) -> dict:
    """Phase 18 (c) on one rank: gemma-2b at full width, ``SERVE_LAYERS``
    deep, split by ``LM.shard_`` and served under its decode policy (the
    pool's rows over data, the caches' positions over model, the weights
    gathered a module at a time), its FAµST head sharded too (forced onto
    ``fused_sharded``), through ``Engine`` + ``LMExecutor(mesh=)`` (4 slots)
    and ``Server(mesh=)``; then the two planted faults; rank 0 alone, after
    every collective: the teacher-forced checks and the unsharded engine
    on a whole copy of the model."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api.operator import ShardSpec
    from repro_torch.distributed.layout import sum_over
    from repro_torch.models.lm import LM
    from repro_torch.runtime.server import Server

    cfg = serve_config()
    cfg = dataclasses.replace(cfg, faust_unembed=dataclasses.replace(cfg.faust_unembed, shard=ShardSpec(mesh)))
    plain = LM(cfg, seed=0, device=dev) if mesh.rank == 0 else None  # the unsharded engine's and the reference
    model = LM(cfg, seed=0, device=dev)
    model.shard_(mesh)
    _free()
    prompts, budgets = _trace(MESH_REQUESTS, 0, MESH_LENGTHS, MESH_BUDGETS, MESH_FIXED, cfg.vocab)
    budgets[0] = MESH_FIRST_BUDGET
    planted_prompts, _ = _trace(2, 27, MESH_LENGTHS, MESH_BUDGETS, MESH_PLANTED_PROMPTS, cfg.vocab)
    merge_prompts, _ = _trace(2, 28, MESH_LENGTHS, MESH_BUDGETS, MESH_MERGE_PLANTED_PROMPTS, cfg.vocab)
    planted_budgets = [MESH_PLANTED_BUDGET] * 2
    t0 = time.perf_counter()
    sum_over(torch.ones((), device=dev), mesh)  # every rank has built its model
    out = {"skew_s": time.perf_counter() - t0}
    with faust_backend(model, "fused_sharded", head_only=True):
        run = _mesh_engine("mesh_serve_engine", card_line, model, mesh, prompts, budgets,
                           evict_step=MESH_EVICT_STEP)
        srv_tokens = np.stack([p[:MESH_LENGTHS[0]] for p in prompts[1:3]])
        _zero_mesh_counts()
        gen, stats = Server(model, 64, mesh=mesh).generate({"tokens": srv_tokens}, MESH_SERVER_TOKENS)
        server_launches = _mesh_counts()
        with boundary_gather_skipped():
            bad = _mesh_engine("mesh_serve_planted", card_line, model, mesh, planted_prompts, planted_budgets)
        _louder(model)
        with merge_skipped():
            bad_merge = _mesh_engine("mesh_serve_planted_merge", card_line, model, mesh, merge_prompts,
                                     planted_budgets)
    row = run["row"]
    row["prompt_lengths"] = [len(p) for p in prompts]
    row["server"] = {"mesh_axes": stats.mesh_axes, "tokens": gen.tolist(), "faust_dispatch": stats.faust_dispatch.backend,
                     "launches": server_launches}
    row["skew_s"] = out["skew_s"]
    require(row["launches"]["chain_matmul"] > 0 and row["launches"]["coll_boundary_gather"] > 0,
            f"the sharded head never ran: {row['launches']}")
    require(stats.mesh_axes == dict(mesh.shape) and stats.faust_dispatch.backend == "fused_sharded",
            f"Server(mesh=): {row['server']}")
    pb = row["pool_bytes"]
    require(4 * pb["split_kv"] == pb["split_kv_whole"],
            f"a rank of 2 x 2 holds {pb['split_kv']} of {pb['split_kv_whole']} global-attention K/V bytes, want 1/4")
    coll = row["model_collectives"]["calls"]
    require(coll["param_gather"] > 0 and coll["kv_merge"] > 0 and coll["row_gather"] > 0,
            f"the decode policy's placement never ran: {coll}")
    out.update(tokens=run["tokens"], planted_tokens=bad["tokens"], planted_merge_tokens=bad_merge["tokens"],
               server_tokens=gen.tolist(), launches=row["launches"], pool_bytes=pb, idle_steps=row["idle_steps"],
               bytes_per_decode_step=row["bytes_per_decode_step"],
               param_gather_bytes_per_forward=row["param_gather_bytes_per_forward"])
    del model
    _free()
    if mesh.rank == 0:
        row["teacher_forced"] = teacher_forced(plain, run["engine"], run["rids"], prompts, SERVE_TOL["bfloat16"])
        with faust_backend(plain, "fused", head_only=True):
            whole = _mesh_engine("mesh_serve_unsharded", card_line, plain, mesh, prompts, budgets,
                                 evict_step=MESH_EVICT_STEP)
        same = sum(int(a == b) for p, q in zip(run["tokens"], whole["tokens"]) for a, b in zip(p, q))
        row["tokens_equal_unsharded"] = {"equal": same, "of": sum(len(p) for p in run["tokens"])}
        require(run["tokens"] == whole["tokens"], f"the sharded engine's tokens differ from the unsharded engine's: "
                                                  f"{row['tokens_equal_unsharded']}")
        # the sound run is held to the teacher-forced check and to the
        # unsharded engine's tokens; a skipped boundary gather must fail the
        # former; a skipped merge (on the louder weights, where the
        # unsharded engine's run passes the teacher-forced check) either
        tol = SERVE_TOL["bfloat16"]
        tf_gather = teacher_forced(plain, bad["engine"], bad["rids"], planted_prompts, tol, enforce=False)
        _louder(plain)
        with faust_backend(plain, "fused", head_only=True):
            whole_merge = _mesh_engine("mesh_serve_unsharded_louder", card_line, plain, mesh, merge_prompts,
                                       planted_budgets)
        row["louder_unsharded_teacher_forced"] = teacher_forced(plain, whole_merge["engine"], whole_merge["rids"],
                                                                merge_prompts, tol)
        tf_merge = teacher_forced(plain, bad_merge["engine"], bad_merge["rids"], merge_prompts, tol, enforce=False)
        equal = bad_merge["tokens"] == whole_merge["tokens"]
        for fault, res, tf, same_tokens, failed in (
                ("boundary_gather_skipped", bad, tf_gather, None, not tf_gather["passed"]),
                ("merge_skipped", bad_merge, tf_merge, equal, not (tf_merge["passed"] and equal))):
            log({"phase": "mesh_serve_planted_fault", "card": card_line, "fault": fault, "teacher_forced": tf,
                 "tokens_equal_unsharded": same_tokens,
                 "engine": {k: res["row"][k] for k in ("wall_s", "tokens_decoded", "launches")}})
            require(failed, f"the planted fault {fault} passed the check: {tf}, tokens equal: {same_tokens}")
        row["unsharded"] = {k: whole["row"][k] for k in ("wall_s", "prefill_s", "decode_s", "ttft_p50_s",
                                                         "tpot_p50_s", "max_memory_allocated_gb")}
    row["timing"] = "one card shared by four ranks (not a multi-GPU number)"
    log(row)
    del plain
    _free()
    return out


def mesh_rank(rank: int, rendezvous: str, out_dir: str, card_line: str, device: str) -> None:
    """One of phase 18's four ranks (a spawned process): join the gloo
    group, run (a)-(c) on a 2 × 2 mesh over the parent's ``device``, save
    the rows and results to ``out_dir/rank{rank}.json`` for the parent."""
    global _ROWS
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    _ROWS = []
    os.environ["REPRO_AUTOTUNE"] = "off"  # the cost model alone: every rank decides alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    result: dict = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=math.prod(MESH),
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        from repro_torch.distributed import make_debug_mesh
        from repro_torch.distributed.mesh import TRANSPORT

        mesh = make_debug_mesh(*MESH, device=dev)
        t0 = time.perf_counter()
        result["operator"] = mesh_operator(card_line, dev, mesh)
        result["head"] = mesh_head(card_line, dev, mesh)
        result["serve"] = mesh_serve(card_line, dev, mesh)
        result["seconds"] = time.perf_counter() - t0
        result["transport"] = dict(TRANSPORT)
        result["coord"] = dict(mesh.coord)
    except Exception:  # noqa: BLE001 — reported by the parent
        result["error"] = traceback.format_exc()
    finally:
        result["rows"] = _ROWS
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result, default=str))
        dist.destroy_process_group()


def mesh_nccl(card_line: str, dev, op) -> dict:
    """Phase 18 (d): a 1 × 1 mesh over NCCL (world size 1) in this process:
    the real collectives at one rank, the sharded apply beside the plain
    fused apply (f32 and bf16, B = 128 and 4096, medians of alternating
    calls): the wrapper's cost on the card; K1 against the plain version."""
    import torch
    import torch.distributed as dist

    from repro_torch.api.operator import ShardSpec
    from repro_torch.distributed import make_debug_mesh
    from repro_torch.distributed.mesh import TRANSPORT

    folder = ROOT / "build" / "chip_smoke_mesh"
    folder.mkdir(parents=True, exist_ok=True)
    rdv = folder / "nccl_rendezvous"
    rdv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1)
    rows = []
    try:
        mesh = make_debug_mesh(1, 1, device=dev)
        sop = op.with_sharding(ShardSpec(mesh))
        g = torch.Generator().manual_seed(50)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            for b in (128, 4096):
                x = torch.randn((b, op.shape[0]), generator=g).to(dev, dtype)
                with torch.no_grad():
                    _zero_mesh_counts()
                    y = sop.apply(x, "fused_sharded", device=dev)
                    torch.cuda.synchronize()
                    counts = _mesh_counts()
                    err = rel_err(y, op.apply(x, "fused", use_kernel=False, device=dev))[1]
                    times = interleaved_ms({"sharded": lambda: sop.apply(x, "fused_sharded", device=dev),
                                            "fused": lambda: op.apply(x, "fused", device=dev)}, NCCL_ROUNDS)
                row = {"phase": "mesh_nccl_1x1", "card": card_line, "dtype": dname, "batch": b,
                       "rel_err_plain": err, "launches": counts,
                       "sharded_ms_p50": statistics.median(times["sharded"]),
                       "fused_ms_p50": statistics.median(times["fused"])}
                row["wrapper_ms"] = row["sharded_ms_p50"] - row["fused_ms_p50"]
                log(row)
                rows.append(row)
                require(err <= TOL[dname] and counts["chain_matmul"] == 1 and counts["coll_output_gather"] == 1,
                        f"the 1 x 1 mesh: {row}")
        log({"phase": "mesh_nccl_transport", "card": card_line, "transport": dict(TRANSPORT),
             "backend": dist.get_backend()})
        serve_row = mesh_serve_1x1(card_line, dev, mesh)
    finally:
        dist.destroy_process_group()
    return {"rows": rows, "serve": serve_row}


def mesh_serve_1x1(card_line: str, dev, mesh) -> dict:
    """Phase 18 (e): gemma-2b at full width, ``SERVE_LAYERS`` deep, served
    on phase 13 (d)'s trace (8 requests, prompts 32–256 from numpy seed 4,
    32 tokens) unsharded, then split by ``LM.shard_`` on the 1 × 1 NCCL
    ``mesh`` and served through ``Engine(LMExecutor(mesh=))`` under its
    decode policy: the same tokens, TTFT, TPOT and peak memory beside the
    unsharded run's, K1 launched (counts zeroed before each run)."""
    from repro_torch.models.lm import LM

    model = LM(serve_config(), seed=0, device=dev)
    trace = dict(n_req=8, lengths=(32, 256), budgets=(32, 32), seed=4, check=False)
    # a first run loads the model's kernels (lazily, on first use), so
    # neither timed run pays for it
    serve_run("mesh_serve_1x1_warmup", card_line, model, 2, (32, 256), (4, 4), seed=5, check=False)
    whole = serve_run("mesh_serve_1x1_unsharded", card_line, model, **trace)
    model.shard_(mesh)
    _layout_counts()
    run = serve_run("mesh_serve_1x1", card_line, model, **trace, mesh=mesh)
    tokens = [run["engine"].result(r).tolist() for r in run["rids"]]
    want = [whole["engine"].result(r).tolist() for r in whole["rids"]]
    keys = ("prefill_s", "decode_s", "wall_s", "ttft_p50_s", "ttft_p90_s", "tpot_p50_s", "tpot_p90_s",
            "max_memory_allocated_gb")
    row = {"phase": "mesh_serve_1x1_summary", "card": card_line, "mesh": dict(mesh.shape),
           "tokens_equal_unsharded": tokens == want, "tokens": sum(len(t) for t in tokens),
           "launches": run["row"]["launches"], "unsharded_launches": whole["row"]["launches"],
           "model_collectives": _layout_counts()["calls"], "sharded": {k: run["row"][k] for k in keys},
           "unsharded": {k: whole["row"][k] for k in keys}}
    log(row)
    require(row["tokens_equal_unsharded"], f"the 1 x 1 mesh's tokens differ from the unsharded engine's: {row}")
    require(run["row"]["launches"]["chain_matmul"] > 0, f"the 1 x 1 mesh's serving launched no K1: {row}")
    require(not any(row["model_collectives"].values()), f"a collective ran over a one-rank axis: {row}")
    del model, whole, run
    _free()
    return row


def mesh(card_line: str, dev, op) -> dict:
    """Phase 18, slice 13: the FAµST operator on a mesh (module docstring):
    (d) in this process, then (a)-(c) on four spawned ranks sharing
    ``cuda:0`` over gloo, the kernels built before any rank starts."""
    import multiprocessing
    import shutil

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out = {"nccl": mesh_nccl(card_line, dev, op)}
    _free()
    build.build()  # already built: ranks must only load, never build at once
    folder = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, str(folder / "rendezvous"), str(folder), card_line, str(dev)))
             for r in range(math.prod(MESH))]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = folder / f"rank{r}.json"
        require(path.exists(), f"mesh rank {r} saved nothing (exit code {p.exitcode})")
        res = json.loads(path.read_text())
        for row in res["rows"] if r == 0 else []:
            log(row)
        require("error" not in res, f"mesh rank {r} failed:\n{res.get('error')}")
        results.append(res)
    same = {k: len({json.dumps(res["serve"][k]) for res in results}) == 1
            for k in ("tokens", "planted_tokens", "planted_merge_tokens", "server_tokens")}
    same["chain_digest"] = len({res["operator"]["chain_digest"] for res in results}) == 1
    row = {"phase": "mesh", "card": card_line, "seconds": time.perf_counter() - t0,
           "rank_seconds": [res["seconds"] for res in results], "coords": [res["coord"] for res in results],
           "same_on_every_rank": same, "transport": [res["transport"] for res in results],
           "operator_launches": [res["operator"]["launches"] for res in results],
           "serve_launches": [res["serve"]["launches"] for res in results],
           "serve_pool_bytes": [res["serve"]["pool_bytes"] for res in results],
           "serve_idle_steps": [res["serve"]["idle_steps"] for res in results],
           "serve_skew_s": [res["serve"]["skew_s"] for res in results],
           "serve_bytes_per_decode_step": [res["serve"]["bytes_per_decode_step"] for res in results],
           "serve_param_gather_bytes_per_forward": [res["serve"]["param_gather_bytes_per_forward"]
                                                    for res in results],
           "head_checks": [[c["rel_err"] for c in res["head"]["checks"]] for res in results],
           "timing": "four ranks share one card: no time of this phase is a multi-GPU number"}
    log(row)
    require(all(same.values()), f"the ranks disagree: {same}")
    launches = {k: results[0]["operator"]["launches"][k] for k in results[0]["operator"]["launches"]}
    # the kernels line's mesh_serve_launches: (c) on rank 0 and (e)
    one = out["nccl"]["serve"]["launches"]
    serve = {k: v + one.get(k, 0) for k, v in results[0]["serve"]["launches"].items()}
    out.update(results=results, launches=launches, serve_launches=serve)
    return out


# ---------------------------------------------------------------------------
# Slice 14: the language model trained on a mesh (phase 19)
# ---------------------------------------------------------------------------

MT_ARGV = ("--arch", "gemma_2b", "--faust", "--steps", "3", "--batch", "8", "--seq", "128")
MT_LAYERS = 2  # (b)'s depth (phase 14 (b)'s): every collective of the four ranks is host-staged
MT_NCCL_LAYERS = 4  # (a)'s depth: at 18 its 25.2 GB save and restore took ≈ 50 s
MT_STEPS = 2  # (b)'s bf16 run: SIGTERM after step 1, the resumes run step 2 (each host-staged step ≈ 20 s)
MT_MESH = (2, 2)
# losses and gradient norms against the unsharded trainer's, relative (an H100: sound runs bf16 ≤ 1.1e-5,
# f32 7.4e-8; the planted fault, run in f32, 1.35e-5): f32's limit lies about tenfold from both, bf16's
# about thrice above its sound runs.  At random init attention adds little to a residual stream the
# sqrt(d)-scaled embedding dominates, so in bf16 the fault moved the loss by 7e-6 only.
MT_TOL = {"bfloat16": 3e-5, "float32": 1e-6}
MT_TIMEOUT_S = 300  # a rank waiting in a collective longer than this fails
MT_JOIN_S = 600
MT_PIPE = (4, 16, 24, 6)  # stages, d, b, microbatches (tests/test_pipeline.py's sizes)
MT_FOLDER = ROOT / "build" / "chip_smoke_mesh_train"


def _mt_counts() -> dict:
    from repro_torch.distributed.layout import COLLECTIVES

    return {**_bwd_counts(), **{f"coll_{k}": v for k, v in COLLECTIVES.items()}}


def _zero_mt_counts() -> None:
    from repro_torch.distributed.layout import COLLECTIVES

    _zero_counts()
    COLLECTIVES.update(dict.fromkeys(COLLECTIVES, 0))


def _mt_config(n_layers=None, dtype=None):
    """``launch.train``'s run of ``MT_ARGV`` and its config, cut to
    ``n_layers`` and cast to ``dtype`` where given."""
    import dataclasses

    from repro_torch.launch import train

    base = train.build(train.parse_args(list(MT_ARGV)))
    cfg = base.cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, stages=((n_layers, ("attn",)),))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return base, cfg


def _fused_head(model) -> None:
    model.unembed.faust.backend = "fused"  # one K1/K2/K3 a step, whatever a table says


def _mt_trainer(dev, mesh=None, n_layers=None, dtype=None, **tc):
    """``launch.train``'s trainer for ``MT_ARGV`` (``tc``: TrainConfig
    fields), cut to ``n_layers`` and cast to ``dtype`` where given, on
    ``mesh``; and a model from seed 0 with its head forced onto ``fused``."""
    import dataclasses

    from repro_torch.models.lm import LM
    from repro_torch.runtime.trainer import Trainer

    base, cfg = _mt_config(n_layers, dtype)
    t = Trainer(cfg, base.data_cfg, base.opt_cfg, dataclasses.replace(base.tcfg, **{"checkpoint_every": 1000, **tc}),
                mesh=mesh, device=dev)
    model = LM(cfg, seed=0, device=dev)
    _fused_head(model)
    return t, model


def _mt_run(t, model, resume=False) -> dict:
    """``t.run`` with the counts zeroed before and read after: losses,
    step times, peak GB, counts, state bytes, saves."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _zero_mt_counts()
    t0 = time.perf_counter()
    out = t.run(resume=resume, model=model)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "losses": [h["loss"] for h in out["history"]],
            "steps": [h["step"] for h in out["history"]], "step_time_s": [h["step_time_s"] for h in out["history"]],
            "grad_norm": [h["grad_norm"] for h in out["history"]],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": _mt_counts(),
            "state_bytes": t.state_bytes, "saves": t.saves, "resumed": t.resumed,
            "write_s": t.ckpt.last_write_s}


@contextlib.contextmanager
def first_step_collectives():
    """The model's collectives by purpose (``distributed/layout.py``: calls
    and bytes) in the first call of every train step the trainer makes
    meanwhile (``runtime/trainer.py`` ``make_train_step``), in the dict
    yielded: the step alone, without the loop's preemption flag or saves."""
    from repro_torch.distributed import layout
    from repro_torch.runtime import trainer

    real, seen = trainer.make_train_step, {}

    def making(*args, **kw):
        step = real(*args, **kw)

        def counted(*a, **k):
            if seen:
                return step(*a, **k)
            calls, moved = dict(layout.COLLECTIVES), dict(layout.BYTES)
            out = step(*a, **k)
            seen.update({p: {"count": layout.COLLECTIVES[p] - calls[p], "bytes": layout.BYTES[p] - moved[p]}
                         for p in calls if layout.COLLECTIVES[p] != calls[p]})
            return out

        return counted

    trainer.make_train_step = making
    try:
        yield seen
    finally:
        trainer.make_train_step = real


def _rel_diff(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _check_diff(run: dict, plain: dict, steps: slice = slice(None)) -> float:
    """The loss check: the larger relative difference of the losses and of
    the gradient norms of ``run`` from ``plain``'s steps ``steps``."""
    return max(_rel_diff(run["losses"], plain["losses"][steps]), _rel_diff(run["grad_norm"], plain["grad_norm"][steps]))


def mesh_train_nccl(card_line: str, dev, after_mesh=lambda: None) -> dict:
    """Phase 19 (a): gemma-2b at full width, ``MT_NCCL_LAYERS`` deep, unsharded and then
    on a 1 × 1 NCCL mesh in this process; then ``after_mesh()``; then the
    mesh's step-2 checkpoint restored into an unsharded trainer for step
    3."""
    import shutil

    import torch.distributed as dist

    from repro_torch.distributed import make_debug_mesh

    folder = MT_FOLDER / "a"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    free = shutil.disk_usage(folder).free / 1e9
    t, model = _mt_trainer(dev, n_layers=MT_NCCL_LAYERS, checkpoint_dir=str(folder / "plain"))
    plain = _mt_run(t, model)
    del t, model
    _free()
    rdv = folder / "nccl_rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device=dev)
        t, model = _mt_trainer(dev, mesh=mesh, n_layers=MT_NCCL_LAYERS, checkpoint_dir=str(folder / "mesh"),
                               checkpoint_every=2, keep_checkpoints=1)
        sharded = _mt_run(t, model)
        del t, model
        _free()
    finally:
        dist.destroy_process_group()
    after_mesh()
    t, model = _mt_trainer(dev, n_layers=MT_NCCL_LAYERS, checkpoint_dir=str(folder / "mesh"))
    resumed = _mt_run(t, model, resume=True)
    del t, model
    _free()
    shutil.rmtree(folder, ignore_errors=True)
    row = {"phase": "mesh_train_1x1", "card": card_line, "argv": list(MT_ARGV), "head": "fused", "disk_free_gb": free,
           "unsharded": plain, "mesh": sharded, "resumed_unsharded": resumed,
           "resume_timing": "after after_mesh(): beside phase 19 (b)'s four ranks",
           "loss_rel_diff": _check_diff(sharded, plain),
           "resume_rel_diff": _check_diff(resumed, sharded, slice(2, 3))}
    log(row)
    tol = MT_TOL["bfloat16"]
    require(len(sharded["losses"]) == 3 and row["loss_rel_diff"] <= tol,
            f"the 1 x 1 mesh's losses differ from the unsharded trainer's: {row['loss_rel_diff']}")
    require(all(sharded["launches"][k] == 3 for k in ("chain_matmul", "chain_dgrad", "chain_wgrad")),
            f"not one K1/K2/K3 a step on the mesh: {sharded['launches']}")
    require([s["step"] for s in sharded["saves"]] == [2] and resumed["resumed"]["step"] == 2
            and resumed["steps"] == [2] and row["resume_rel_diff"] <= tol,
            f"the mesh's checkpoint did not resume unsharded to its step-3 loss: {row['resume_rel_diff']}")
    return row


def mesh_train_rank(rank: int, rendezvous: str, out_dir: str, card_line: str, device: str) -> None:
    """One of phase 19's four ranks (a spawned process): (b) and (c) on
    the parent's ``device``, the rows and results saved to
    ``out_dir/rank{rank}.json`` for the parent."""
    global _ROWS
    import datetime
    import signal
    import traceback

    import torch
    import torch.distributed as dist

    _ROWS = []
    os.environ["REPRO_AUTOTUNE"] = "off"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // math.prod(MT_MESH)))  # the staged collectives' host work
    result: dict = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=math.prod(MT_MESH),
                            timeout=datetime.timedelta(seconds=MT_TIMEOUT_S))
    try:
        from repro_torch.distributed import make_debug_mesh
        from repro_torch.distributed.mesh import TRANSPORT, Mesh
        from repro_torch.distributed.pipeline import pipeline_apply
        from repro_torch.layers import attention

        t0 = time.perf_counter()
        mesh = make_debug_mesh(*MT_MESH, device=dev)
        result["coord"] = dict(mesh.coord)
        ckpt = str(Path(out_dir) / "b")
        t, model = _mt_trainer(dev, mesh=mesh, n_layers=MT_LAYERS, checkpoint_dir=ckpt, steps=MT_STEPS)
        beat = t._heartbeat

        def preempt_after_step_1(step):
            beat(step)
            if step == 0 and rank == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        t._heartbeat = preempt_after_step_1
        with first_step_collectives() as first:
            result["bf16"] = _mt_run(t, model)
        result["bf16"]["on_disk"] = t.ckpt.all_steps()
        result["bf16"]["step_collectives"] = first  # phase 20 (c) holds the dry run to them
        if rank == 0:  # every rank has returned from the save's collective finish
            Path(out_dir, "saved").touch()
        del t, model
        _free()
        t, model = _mt_trainer(dev, mesh=make_debug_mesh(4, 1, device=dev), n_layers=MT_LAYERS, checkpoint_dir=ckpt,
                               steps=MT_STEPS)
        result["resumed_4x1"] = _mt_run(t, model, resume=True)
        del t, model
        _free()
        _wait_for(Path(out_dir) / "go")  # the parent's full-depth run is over: room on the card for f32
        t, model = _mt_trainer(dev, mesh=mesh, n_layers=MT_LAYERS, dtype="float32", steps=1,
                               checkpoint_dir=str(Path(out_dir) / "f32"))
        result["f32"] = _mt_run(t, model)
        del t, model
        _free()
        real = attention.gather_kv
        attention.gather_kv = lambda k, v, seq: (k, v, seq.positions(k.device))  # each chunk attends to itself
        try:
            t, model = _mt_trainer(dev, mesh=mesh, n_layers=MT_LAYERS, dtype="float32", steps=1,
                                   checkpoint_dir=str(Path(out_dir) / "planted"))
            result["planted"] = _mt_run(t, model)
        finally:
            attention.gather_kv = real
        del t, model
        _free()
        # (c) the pod pipeline
        n_stages, d, b, n_micro = MT_PIPE
        g = torch.Generator().manual_seed(7)
        w = (torch.randn((n_stages, d, d), generator=g) / math.sqrt(d)).to(dev)
        bias = (0.1 * torch.randn((n_stages, d), generator=g)).to(dev)
        x = torch.randn((b, d), generator=g).to(dev)
        gy = torch.randn((b, d), generator=g).to(dev)  # the loss Σ y · gy, the same on every rank
        pmesh = Mesh((n_stages, 1), ("pod", "data"), device=dev)
        stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
        leaves = [t.detach().clone().requires_grad_() for t in (w, bias, x)]
        y = pipeline_apply(stage, {"w": leaves[0], "b": leaves[1]}, leaves[2], mesh=pmesh, axis="pod",
                           n_microbatches=n_micro)
        (y * gy).sum().backward()
        seq = [t.detach().clone().requires_grad_() for t in (w, bias, x)]
        ref = seq[2]
        for i in range(n_stages):
            ref = stage({"w": seq[0][i], "b": seq[1][i]}, ref)
        (ref * gy).sum().backward()
        me = pmesh.coord["pod"]
        grads = {"dx": (leaves[2].grad, seq[2].grad), "dw": (leaves[0].grad[me], seq[0].grad[me]),
                 "db": (leaves[1].grad[me], seq[1].grad[me])}
        others = [i for i in range(n_stages) if i != me]
        y, ref = y.detach(), ref.detach()
        result["pipeline"] = {
            "coord": dict(pmesh.coord), "max_abs_err": float((y - ref).abs().max()),
            "close": bool(torch.allclose(y, ref, rtol=2e-4, atol=2e-5)),
            **{f"{k}_max_abs_err": float((a - r).abs().max()) for k, (a, r) in grads.items()},
            "grads_close": all(bool(torch.allclose(a, r, rtol=2e-4, atol=2e-5)) for a, r in grads.values()),
            "other_rows_zero": not (leaves[0].grad[others].any() or leaves[1].grad[others].any())}
        result["seconds"] = time.perf_counter() - t0
        result["transport"] = dict(TRANSPORT)
    except Exception:  # noqa: BLE001 — reported by the parent
        result["error"] = traceback.format_exc()
    finally:
        result["rows"] = _ROWS
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result, default=str))
        dist.destroy_process_group()


def _wait_for(path: Path) -> None:
    """Wait for another process of phase 19 to create ``path``."""
    deadline = time.monotonic() + MT_TIMEOUT_S
    while not path.exists():
        require(time.monotonic() < deadline, f"{path.name} did not appear within {MT_TIMEOUT_S} s")
        time.sleep(0.2)


def mesh_train(card_line: str, dev) -> dict:
    """Phase 19, slice 14 (module docstring): (a) in this process; once
    its mesh run is over, four ranks spawned for (b) and (c), while this
    process restores (a)'s checkpoint, runs the unsharded 2-layer
    trainers (b) is held against and resumes (b)'s checkpoint unsharded
    once the ranks have saved it.  The ranks start their f32 runs only
    after (a) has left the card (the ``go`` file), so the card holds at
    most (a)'s resume and the ranks' bf16 runs at once."""
    import multiprocessing
    import shutil

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    folder = MT_FOLDER / "b"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    procs = []

    def spawn():
        build.build()  # already built: ranks must only load, never build at once
        ctx = multiprocessing.get_context("spawn")
        procs.extend(ctx.Process(target=mesh_train_rank, args=(r, str(folder / "rendezvous"), str(folder),
                                                                card_line, str(dev)))
                     for r in range(math.prod(MT_MESH)))
        for p in procs:
            p.start()

    try:
        out = {"a": mesh_train_nccl(card_line, dev, spawn)}
        _free()
        (folder / "go").touch()
        t, model = _mt_trainer(dev, n_layers=MT_LAYERS, checkpoint_dir=str(folder / "plain"), steps=MT_STEPS)
        plain = _mt_run(t, model)
        del t, model
        _free()
        t, model = _mt_trainer(dev, n_layers=MT_LAYERS, dtype="float32", steps=1,
                               checkpoint_dir=str(folder / "plain32"))
        plain32 = _mt_run(t, model)
        del t, model
        _free()
        _wait_for(folder / "saved")
        t, model = _mt_trainer(dev, n_layers=MT_LAYERS, checkpoint_dir=str(folder / "b"), steps=MT_STEPS)
        resumed = _mt_run(t, model, resume=True)
        del t, model
        _free()
        deadline = time.monotonic() + MT_JOIN_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = folder / f"rank{r}.json"
        require(path.exists(), f"mesh-train rank {r} saved nothing (exit code {p.exitcode})")
        res = json.loads(path.read_text())
        require("error" not in res, f"mesh-train rank {r} failed:\n{res.get('error')}")
        results.append(res)
    first = results[0]
    row = {"phase": "mesh_train", "card": card_line, "n_layers": MT_LAYERS, "mesh": list(MT_MESH),
           "seconds": time.perf_counter() - t0, "rank_seconds": [r["seconds"] for r in results],
           "coords": [r["coord"] for r in results], "unsharded": plain, "unsharded_f32": plain32,
           "bf16": [r["bf16"] for r in results], "resumed_4x1": [r["resumed_4x1"] for r in results],
           "resumed_unsharded": resumed, "f32": [r["f32"] for r in results],
           "planted": first["planted"], "pipeline": [r["pipeline"] for r in results],
           "transport": [r["transport"] for r in results],
           "state_share": [r["bf16"]["state_bytes"]["rank"] / r["bf16"]["state_bytes"]["whole"] for r in results],
           "timing": "four ranks share one card, beside this process's (a) restore and unsharded 2-layer runs: "
                     "no time of (b) or (c) is a multi-GPU number"}
    row["bf16_rel_diff"] = _check_diff(first["bf16"], plain, slice(0, 1))
    row["resume_4x1_rel_diff"] = _check_diff(first["resumed_4x1"], plain, slice(1, 2))
    row["resume_unsharded_rel_diff"] = _check_diff(resumed, plain, slice(1, 2))
    row["f32_rel_diff"] = _check_diff(first["f32"], plain32)
    row["planted_rel_diff"] = _check_diff(first["planted"], plain32)
    log(row)
    shutil.rmtree(folder, ignore_errors=True)
    tol = MT_TOL["bfloat16"]
    require(all(r["bf16"]["losses"] == first["bf16"]["losses"] for r in results)
            and all(r["f32"]["losses"] == first["f32"]["losses"] for r in results),
            "the ranks' losses differ")
    require(all(r["bf16"]["steps"] == [0] and r["bf16"]["on_disk"] == [1] for r in results),
            f"SIGTERM on rank 2 did not stop every rank after step 1: {[r['bf16']['steps'] for r in results]}")
    require(row["bf16_rel_diff"] <= tol, f"the 2 x 2 mesh's losses differ from unsharded: {row['bf16_rel_diff']}")
    require(all(r["resumed_4x1"]["resumed"]["step"] == 1 for r in results) and resumed["resumed"]["step"] == 1
            and row["resume_4x1_rel_diff"] <= tol and row["resume_unsharded_rel_diff"] <= tol,
            f"the resumes missed the step-2 loss: {row['resume_4x1_rel_diff']}, {row['resume_unsharded_rel_diff']}")
    require(row["f32_rel_diff"] <= MT_TOL["float32"], f"the f32 step differs: {row['f32_rel_diff']}")
    require(row["planted_rel_diff"] > MT_TOL["float32"],
            f"the planted fault passed the loss check: {row['planted_rel_diff']}")
    require(all(0.2 <= s <= 0.3 for s in row["state_share"]), f"a rank holds not a quarter: {row['state_share']}")
    require(all(p["close"] for p in row["pipeline"]), f"pipeline_apply disagrees: {row['pipeline']}")
    require(all(p["grads_close"] and p["other_rows_zero"] for p in row["pipeline"]),
            f"pipeline_apply's backward disagrees with the sequential walk: {row['pipeline']}")
    require(all(r["bf16"]["launches"][k] == 1 for r in results for k in ("chain_matmul", "chain_dgrad", "chain_wgrad")),
            f"not one K1/K2/K3 a step a rank: {[r['bf16']['launches'] for r in results]}")
    out["b"] = row
    out["launches"] = {k: out["a"]["mesh"]["launches"][k] for k in ("chain_matmul", "chain_dgrad", "chain_wgrad")}
    out["step_collectives"] = [r["bf16"]["step_collectives"] for r in results]
    return out


# ---------------------------------------------------------------------------
# Slice 17: the report (phase 20)
# ---------------------------------------------------------------------------

# (a)'s dry runs on the 16 x 16 mesh: (arch, cell, variant), one process each
REPORT_CELLS = (("gemma_2b", "train_4k", None), ("gemma_2b", "prefill_32k", None), ("gemma_2b", "decode_32k", None),
                ("gemma_2b", "train_4k", "faust"))
REPORT_MEM_TOL = 0.10  # (b): the real step's peak within this share of the prediction
REPORT_TIMEOUT_S = 300
_FLOP_OPS = ("chain_matmul", "chain_dgrad", "chain_wgrad", "bsr_matmul")


REPORT_FOLDER = ROOT / "build" / "chip_smoke_report"


def _report_cell():
    from repro_torch.configs.base import ShapeCell

    batch_n, seq = int(MT_ARGV[MT_ARGV.index("--batch") + 1]), int(MT_ARGV[MT_ARGV.index("--seq") + 1])
    return ShapeCell("phase19", "train", seq, batch_n)


def report_prediction(which: str, path: str) -> None:
    """Phase 20's predictions, written to ``path`` as JSON (run in a process
    of its own, beside the card work): ``"b"``, the dry run of phase 19
    (a)'s configuration on a 1 × 1 mesh; ``"c"``, phase 19 (b)'s on each
    rank of a 2 × 2 mesh, its collectives by purpose.  The process sees no
    card: its ``MT_ARGV`` ends in ``--device cpu`` (the config is the same)."""
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.mesh import abstract_rank, release

    if which == "b":
        _, cfg = _mt_config(MT_NCCL_LAYERS)
        out = dry_run(cfg, _report_cell(), abstract_rank((1, 1), ("data", "model"), 0), prepare=_fused_head)
        release()
    else:
        _, cfg = _mt_config(MT_LAYERS)
        out = []
        for r in range(math.prod(MT_MESH)):
            out.append(dry_run(cfg, _report_cell(), abstract_rank(MT_MESH, ("data", "model"), r),
                               prepare=_fused_head)["collectives"]["by_purpose"])
            release()
    Path(path).write_text(json.dumps(out))


def report_start() -> dict:
    """Phase 20's processes started (no card: fake tensors on the CPU):
    (a)'s dry runs, one each, writing ``build/dryrun/``, and the
    predictions of (b) and (c) (:func:`report_prediction`)."""
    import shutil

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    shutil.rmtree(REPORT_FOLDER, ignore_errors=True)
    REPORT_FOLDER.mkdir(parents=True)

    def start(argv):
        return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = {"a": []}
    for arch, cell, variant in REPORT_CELLS:
        procs["a"].append(start([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell", cell,
                                 "--mesh", "single", "--force"] + (["--variant", variant] if variant else [])))
    for which in ("b", "c"):
        code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]; import chip_smoke as cs; "
                f"cs.MT_ARGV, cs.MT_NCCL_LAYERS, cs.MT_LAYERS, cs.MT_MESH = "
                f"{(tuple(MT_ARGV) + ('--device', 'cpu'), MT_NCCL_LAYERS, MT_LAYERS, tuple(MT_MESH))!r}; "
                f"cs.report_prediction({which!r}, {str(REPORT_FOLDER / which)!r})")
        procs[which] = start([sys.executable, "-c", code])
    return procs


def _report_wait(procs: dict, which: str):
    """Phase 20's prediction ``which``, once its process has ended."""
    p = procs[which]
    out, _ = p.communicate(timeout=REPORT_TIMEOUT_S)
    require(p.returncode == 0, f"phase 20's prediction {which} failed:\n{out[-3000:]}")
    return json.loads((REPORT_FOLDER / which).read_text())


def report_collect(card_line: str, procs: list) -> list:
    """Phase 20 (a): wait for the dry runs and print each record's roofline
    terms (the H100 data sheet's constants, or a calibration's), its peak
    GB a rank and its seconds."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import roofline_constants, roofline_terms

    rows = []
    consts, source = roofline_constants()
    for (arch, cell, variant), p in zip(REPORT_CELLS, procs["a"], strict=True):
        out, _ = p.communicate(timeout=REPORT_TIMEOUT_S)
        require(p.returncode == 0, f"dry run {arch} x {cell} x {variant} failed:\n{out[-3000:]}")
        rec = json.loads(Path(dryrun.result_path(arch, cell, False, variant)).read_text())
        terms = roofline_terms(rec, consts)
        row = {"phase": "report_dryrun", "card": card_line, "arch": arch, "cell": cell, "variant": variant,
               "mesh": rec["mesh"], "terms": terms, "constants": source,
               "peak_gb_per_rank": rec["memory"]["peak_bytes"] / 1e9, "fits_card": rec["memory"]["fits_card"],
               "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes"], "launches": rec["launches"],
               "collective_bytes": rec["collectives"]["total_bytes"], "trace_s": rec["trace_s"]}
        log(row)
        rows.append(row)
    return rows


def _flop_formulas(on: bool, saved: dict) -> None:
    """Remove the kernels' flop formulas (``on=False``, kept in ``saved``)
    or put them back: (d)'s planted fault."""
    import torch
    from torch.utils.flop_counter import flop_registry

    for name in _FLOP_OPS:
        packet = getattr(torch.ops.repro_torch, name)
        if on:
            flop_registry[packet] = saved[name]
        else:
            saved[name] = flop_registry.pop(packet)


def report_real_step(model, opt, mesh, batch) -> dict:
    """One train step of ``model`` on ``mesh`` counted: FlopCounterMode's
    flops, K1-K6 launches, peak memory allocated over the step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import make_sharded_train_step
    from repro_torch.optim.adamw import AdamWConfig

    step = make_sharded_train_step(model, AdamWConfig(), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with FlopCounterMode(display=False) as fc:
        step(batch, opt)
    torch.cuda.synchronize()
    c = _bwd_counts()
    return {"flops": fc.get_total_flops(), "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"K1": c["chain_matmul"], "K2": c["chain_dgrad"], "K3": c["chain_wgrad"],
                         "K4": c["chain_matmul_q"], "K5": c["chain_dgrad_q"] + c["chain_wgrad_q"],
                         "K6": c["bsr_matmul"]}}


def report_predicted(card_line: str, dev, mtr: dict, procs: dict) -> dict:
    """Phase 20 (b)-(d): the dry run's predictions (``procs``' processes)
    held against real steps."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import make_debug_mesh
    from repro_torch.launch.dryrun import model_priced
    from repro_torch.models.lm import LM
    from repro_torch.optim import adamw

    cell = _report_cell()
    batch_n, seq = cell.global_batch, cell.seq_len
    # (b) phase 19 (a)'s model on its 1 x 1 NCCL mesh while the prediction
    # runs; the prediction logged before the step
    _, cfg = _mt_config(MT_NCCL_LAYERS)
    folder = MT_FOLDER / "report"
    folder.mkdir(parents=True, exist_ok=True)
    rdv = folder / "nccl_rendezvous"
    rdv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device=dev)
        with model_priced():
            model = LM(cfg, seed=0, device=dev)
            _fused_head(model)
            model.shard_(mesh)
            opt = adamw.init_state(dict(model.named_parameters()))
            g = torch.Generator().manual_seed(0)
            batch = {"tokens": torch.randint(0, cfg.vocab, (batch_n, seq), generator=g, dtype=torch.int32).to(dev)}
            pred = _report_wait(procs, "b")
            log({"phase": "report_prediction", "card": card_line, "argv": list(MT_ARGV),
                 "n_layers": MT_NCCL_LAYERS, "mesh": [1, 1], "matmul_flops": pred["cost"]["matmul_flops"],
                 "launches": pred["launches"], "peak_bytes": pred["memory"]["peak_bytes"],
                 "argument_bytes": pred["memory"]["argument_bytes"], "trace_s": pred["trace_s"]})
            real = report_real_step(model, opt, mesh, batch)
            saved: dict = {}
            _flop_formulas(False, saved)
            try:  # (d) the planted fault: the kernels' flop formula removed
                planted = report_real_step(model, opt, mesh, batch)
            finally:
                _flop_formulas(True, saved)
        del model, opt
        _free()
    finally:
        dist.destroy_process_group()
    mem_err = abs(real["peak_bytes"] - pred["memory"]["peak_bytes"]) / pred["memory"]["peak_bytes"]
    want_launches = {k: pred["launches"].get(k, 0) for k in real["launches"]}
    row_b = {"phase": "report_step", "card": card_line, "predicted_flops": pred["cost"]["matmul_flops"],
             "counted_flops": real["flops"], "predicted_launches": want_launches, "launches": real["launches"],
             "predicted_peak_bytes": pred["memory"]["peak_bytes"], "peak_bytes": real["peak_bytes"],
             "peak_rel_err": mem_err, "planted_flops": planted["flops"],
             "planted_kernel_flops_missing": pred["cost"]["matmul_flops"] - planted["flops"]}
    log(row_b)
    require(real["flops"] == pred["cost"]["matmul_flops"],
            f"(b) counted flops {real['flops']} != predicted {pred['cost']['matmul_flops']}")
    require(real["launches"] == want_launches and want_launches["K1"] == want_launches["K2"] == want_launches["K3"] == 1,
            f"(b) launches {real['launches']} != predicted {want_launches}")
    require(mem_err <= REPORT_MEM_TOL, f"(b) peak {real['peak_bytes']} is {mem_err:.3f} off the predicted "
                                       f"{pred['memory']['peak_bytes']}")
    require(planted["flops"] != pred["cost"]["matmul_flops"], "(d) the planted fault passed the flop check")
    # (c) phase 19 (b)'s four ranks: each one's first step's collectives by purpose
    got = mtr["step_collectives"]
    preds = _report_wait(procs, "c")
    row_c = {"phase": "report_collectives", "card": card_line, "mesh": list(MT_MESH), "n_layers": MT_LAYERS,
             "predicted": preds, "counted": got, "equal": preds == got}
    log(row_c)
    require(preds == got, f"(c) the ranks' collectives by purpose differ from the dry run's: {preds} vs {got}")
    return {"b": row_b, "c": row_c, "launches": real["launches"]}


def report(card_line: str, dev, mtr: dict) -> dict:
    """Phase 20, slice 17: (a)'s dry runs and (b)'s and (c)'s predictions in
    processes of their own on the CPU while (b)-(d) run on the card."""
    t0 = time.perf_counter()
    procs = report_start()
    try:
        out = report_predicted(card_line, dev, mtr, procs)
        out["a"] = report_collect(card_line, procs)
    finally:
        for p in (*procs["a"], procs["b"], procs["c"]):
            if p.poll() is None:
                p.kill()
                p.wait(10)
    out["seconds"] = time.perf_counter() - t0
    log({"phase": "report", "card": card_line, "seconds": out["seconds"]})
    return out


def _kernel_entry(name, source, replaces, launches, cases, checks, card_line, head) -> dict:
    first = next(r for r in cases if all(r.get(k) == v for k, v in head.items()))
    keys = ("chain", "quant", "dtype", "batch", "bt", "launches_per_apply", "max_abs_err", "ms", "cold_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "card": card_line,
        "launches": launches, "max_abs_err": first["max_abs_err"], "ms": first["ms"],
        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"], "headline": head,
        "check_max_rel_err": max(c["rel_err"] for c in checks if c["kernel"] == name),
        "cases": [{k: r[k] for k in keys if k in r} for r in cases],
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    info = setup()
    launch_configs(info["card"])
    checks = check_kernels(dev) + check_bsr_layout(dev) + check_quantized_kernel(dev) + check_chain_grid(dev)
    checks += check_dgrad_grid(dev) + check_wgrad_grid(dev) + check_backward_kernels(dev)
    op, launches, w_dev = main_path(dev)
    qops, qlaunches = quantized_path(op, w_dev)
    check_k4_rounding(op, qops)
    ops = {"float32": op, "int8:per_block": qops["int8:per_block"]}
    measured_dispatch(ops)
    _, train_counts = training_path(ops, info["card"])
    lm = train_lm(info["card"])
    resilient = train_resilient(info["card"])
    batched = factorize_batched(dev)
    strategies(dev, batched["ops"][0].todense())
    compose(batched["ops"][:2])
    grad_dispatch(ops, info["card"])
    del batched
    _free()
    rows, _ = measure(op, info["card"])
    rows += measure_quantized(qops, ops, info["card"])
    rows += measure_backward(op, qops["int8:per_block"], info["card"])
    rows += measure_unembed(info["card"], dev)
    srv = serve(info["card"], dev)
    serve_launches = {**srv["engine"]["launches"], "chain_matmul_q": srv["stream"]["k4_launches"]}
    arch = archs(info["card"], dev)
    ssm = ssm_archs(info["card"], dev)
    mod = modality(info["card"], dev)
    msh = mesh(info["card"], dev, op)
    mtr = mesh_train(info["card"], dev)
    rep = report(info["card"], dev, mtr)

    src = "src/repro_torch/kernels/csrc/"
    f32_b128 = {"dtype": "float32", "batch": 128}
    kernels = [
        _kernel_entry("chain_matmul", src + "chain_matmul.cu", "src/repro/kernels/chain.py:125",
                      launches["chain_matmul"], [r for r in rows if r.get("kernel") == "chain_matmul"],
                      checks, info["card"], f32_b128),
        _kernel_entry("bsr_matmul", src + "bsr_matmul.cu", "src/repro/kernels/bsr_matmul.py:63",
                      launches["bsr_matmul"], [r for r in rows if r.get("kernel") == "bsr_matmul"],
                      checks, info["card"], f32_b128),
        _kernel_entry("chain_matmul_q", src + "chain_matmul.cu",
                      "src/repro/kernels/chain.py:125", qlaunches["chain_matmul_q"],
                      [r for r in rows if r.get("kernel") == "chain_matmul_q"], checks, info["card"],
                      {"quant": "int8:per_block", **f32_b128}),
        # K2 and K3: launches in the trainer's run (phase 7); K5, the two
        # of them on codes: in the training applies (phase 6), the path
        # that trains a quantized chain
        _kernel_entry("chain_dgrad", src + "chain_dgrad.cu", "src/repro/kernels/chain_bwd.py:283",
                      lm["launches"]["chain_dgrad"], [r for r in rows if r.get("kernel") == "chain_dgrad"],
                      checks, info["card"], f32_b128),
        _kernel_entry("chain_wgrad", src + "chain_wgrad.cu", "src/repro/kernels/chain_bwd.py:433",
                      lm["launches"]["chain_wgrad"], [r for r in rows if r.get("kernel") == "chain_wgrad"],
                      checks, info["card"], f32_b128),
        _kernel_entry("chain_dgrad_q", src + "chain_dgrad.cu", "src/repro/kernels/chain_bwd.py:283",
                      train_counts["chain_dgrad_q"], [r for r in rows if r.get("kernel") == "chain_dgrad_q"],
                      checks, info["card"], {"quant": "int8:per_block", **f32_b128}),
        _kernel_entry("chain_wgrad_q", src + "chain_wgrad.cu", "src/repro/kernels/chain_bwd.py:433",
                      train_counts["chain_wgrad_q"], [r for r in rows if r.get("kernel") == "chain_wgrad_q"],
                      checks, info["card"], {"quant": "int8:per_block", **f32_b128}),
    ]
    # slice 9: phase 14's counts, the EF trainer's (a) and the recompressing one's (c)
    resilient_launches = {n: resilient["ef"]["launches"][n] + resilient["recompress"]["launches"][n]
                          for n in ("chain_matmul", "chain_dgrad", "chain_wgrad")}
    for k in kernels:  # slice 8: the serving engine's counts (K4: the quantized refresh's applies)
        if k["name"] in serve_launches:
            k["serve_launches"] = serve_launches[k["name"]]
        if k["name"] in srv["faust_mlp"]["launches"]:  # slice 15: phase 13 (d), the compressed MLPs served
            k["compressed_mlp_serve_launches"] = srv["faust_mlp"]["launches"][k["name"]]
        if k["name"] in resilient_launches:
            k["train_resilient_launches"] = resilient_launches[k["name"]]
        if k["name"] in ("chain_matmul", "bsr_matmul", "chain_dgrad", "chain_wgrad"):  # slices 10-12: phases 15-17
            k["archs_launches"] = arch["launches"][k["name"]]
            k["ssm_archs_launches"] = ssm["launches"][k["name"]]
            k["modality_launches"] = mod["launches"][k["name"]]
        # slice 13: phase 18 (a), rank 0's counts on the mesh (every kernel
        # of the sharded path); slices 13 and 16: (c)'s serving on rank 0
        # and (e)'s on the 1 x 1 mesh
        k["mesh_launches"] = msh["launches"][k["name"]]
        if k["name"] in msh["serve_launches"]:
            k["mesh_serve_launches"] = msh["serve_launches"][k["name"]]
        if k["name"] in mtr["launches"]:  # slice 14: phase 19 (a), the trainer on the 1 x 1 mesh
            k["mesh_train_launches"] = mtr["launches"][k["name"]]
        report_names = {"chain_matmul": "K1", "chain_dgrad": "K2", "chain_wgrad": "K3"}
        if k["name"] in report_names:  # slice 17: phase 20 (b)'s real step, held against the dry run
            k["report_launches"] = rep["launches"][report_names[k["name"]]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
