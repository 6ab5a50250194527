#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and nothing else; it imports ``torch`` and
``numpy`` and the port, never ``jax`` and never the reference package. It
builds every hand-written kernel from the sources in this checkout (one
``nvcc`` per source, started together), holds each against its plain torch
version on the card (integers: bit for bit, tolerance 0; floats at the
stated tolerances), drives the port's paths — the paper's LCC
pipeline, the streaming path with the device tier, online graph query
serving with its traffic plane, the SPMD data plane (the stream and query
serving with ``--spmd --pipeline``), serving (gemma2-27b prefill + decode,
DIN scoring, the MoE LMs moonshot-v1-16b-a3b at its published config and
phi3.5-moe at its published width), GNN training (gin-tu at ogb_products'
size, MACE at molecule's, GAT's hub split at ogb_products' nodes), LM
training (stablelm-1.6b at its published width, sequence 4,096; moonshot
at its published width, 1 layer) and DIN training (its published config)
— through their public entry points, checks the
port's own observability artifacts with the port's validator, and fails
(non-zero exit) if any phase fails. Each phase prints one
JSON object on a line of its own, with ``phase_wall_s``, the seconds since
the previous phase's line:

  env      versions, device name, ``nvidia-smi`` name and power limit
  build    seconds to build each library, ``-Xptxas -v`` registers / smem,
           the HGMMA (wgmma) instructions in the tensor-core B8's SASS
  checks   kernel vs plain version at the listed shapes: B9
           (``segment_sum_sorted``: the reference's test shapes, D in {1, 3,
           64, 100, 128}, E in {0, 1, 777}, a padding tail of id N,
           negative, unsorted and int64 ids, MACE's and gat-cora's
           aggregations, the geometry's switches just below and above, one
           segment over 10^6 edges, Zipf segment sizes); B8
           (``flash_attention``, both kernels: causal, window 0/64/4,096,
           softcap 0/50, non-causal, G 1/2, dh 64/128, S that no tile
           divides, in fp32 (the FMA kernel) and in bf16 (the wgmma
           kernel); fp16, dh 256, S != T, and gemma2-27b's layer [1, 8192,
           16, 2, 128] in bf16; each case asserts which kernel ran); B10
           (``embedding_bag``: the reference's test shapes, D = 18 / L =
           100, fp32/bf16/fp16 tables, sum and mean, an all-masked bag,
           B = 333, B = 1, the served [512, 100] with int32 and int64 ids,
           L = 300, an Inf row under masked positions and ids out of range;
           two calls equal bit for bit); B7 (``epoch_land`` and
           ``epoch_count``, every method,
           on four hub problems with phantom slots pointed at real rows and
           on rounds 0, 16 and 31 of the S16 problem); B1
           (``intersect_count``; E down to 1 at widths up to 16,384, the
           serving path's widest buckets); B3 (``resident_intersect``,
           both variants, slot lengths given (true, cut or
           overlong) and not given, E in {0,1,7,64,130,1000}, WB in
           {0,4,32,200}, evicted slots, S = 1 and 4,096; a hub residency
           with rows of 12,000 and near 9,754 ids, pairs in runs sharing
           slot_a and shuffled, ids below 2^16 and 2^20; an out-of-range
           slot raises); B2
           (``bitmap_intersect_count``, E x W in {1,3,256,1000} x
           {1,3,128,2048}) and B2 against B1 on 512 heavy edges of the S16
           graph packed over [0, n)
  entry    ``repro_torch.launch.lcc_run.main`` at R-MAT scale 12, --verify
  full     the epoch engine at R-MAT scale 16 / edge factor 16, p = 8, 32
           rounds, cache 256: the kernel route (``hybrid``, ``pairwise``:
           one ``epoch_land`` and one ``epoch_count`` a round, no B1) vs the
           padded plain route (``bsearch``, ``plain=True``) bit for bit, each
           timed (median of 3; 2 for the plain route) with its peak memory
           beyond the problem's tensors (the kernel route's must stay under
           1 GiB); the kernel route at scale 14 vs ``triangles_per_vertex``
  pairs    100,000 sampled edges through ``batched_pair_counts``
  stream   ``repro_torch.launch.stream_run.main`` at R-MAT scale 14 / edge
           factor 16, 16 batches, p = 8, device tier of 1,024 x 512 slots,
           every 4th batch verified bit-exact against a recount; the largest
           B3 call of each variant is held against the plain version again;
           then the first 4 of the same 16 batches on an engine wired by
           the launcher's ``build_engine``, under ``torch.profiler``, for
           the device rows and idle share (updates/s is the unprofiled
           run's), verified after them
  stream_routes  scale 12, 8 adversarial batches, per-rank tier, hub
           partition + rebalance, maintained schedule, two engines wired by
           ``stream_run.build_engine`` from the launcher's flags, with and
           without ``--no-kernel``: bit-equal after every batch, both
           verified
  query_serve  the serving and traffic planes
           (``repro_torch.launch.query_serve``): (a) ``main`` at R-MAT
           scale 12 / edge factor 16, p = 8, 1,024 Zipf queries, 20% write
           events, device tier of 1,024 slots, ``--verify`` (every answer
           against a recount of its snapshot); (b) the same graph with
           ``--ranks 8 --verify`` (512 queries), then open-loop Poisson
           arrivals at half (a)'s in-engine q/s with ``--slo --tenants 3
           --ewma-scores --verify`` (1,024 queries); (c) scale 16,
           ``--ranks 8``, 256 queries, window 64, 4,096 tier slots (the
           loop route phase ``spmd`` compares with), driven through the
           launcher's ``build_service`` and ``closed_loop``, every answer
           checked against the stream engine's ``t`` / ``lcc``, the
           store's rows and a ``lexsort`` of ``lcc``, the widest B1 and B3
           calls held against their plain versions, q/s, latency, hit
           rates and launches per microbatch; 128 further queries on the
           same service under ``torch.profiler`` (device ms, idle share);
           ``svc.verify()``; (d) scale 14, 512 queries, the kernel route
           against the plain route (``use_kernel=False``): answers, stream
           state, provider and tier stats and pair counters bit for bit
  spmd     the SPMD data plane (``distributed/spmd_runtime.py``, B5
           ``serve_landing`` and B6 ``pair_counts_landed``, the executor's;
           the block kernels ``serve_block`` and ``pair_counts`` beside
           them): (a) every kernel against the plain versions, whole,
           tolerance 0 (the landing against ``serve_block_ref``'s block),
           on edge units (the empty unit, pairs with no serve traffic: the
           empty landing, a buffer of W = 32 that clips the ladder, phantom
           positions) and on units captured from the runs below (the
           largest unit of the S14 stream, the S12 hub partition's first
           units, a window of the S16 service), each timed (from Python and
           in a CUDA graph) beside its plain version, its bound, a library
           composite (``repeat_interleave + index_select`` for the landing,
           ``index_select + F.pad + cat`` for the block) and, with a parent
           checkout's sources in ``build/parent/``, the parent's B6;
           (b) ``stream_run`` at the stream phase's argv with ``--spmd
           --pipeline``: every ``BatchResult``, ``t`` and ``lcc`` equal to
           the stream phase's loop run, verified, the ledger's pairs equal
           to the delta pairs, updates/s beside the loop route's; (c)
           ``query_serve`` S12 ``--ranks 8 --spmd --pipeline --verify`` (512
           queries), S12 ``--partition hub --ranks 8 --spmd --verify``
           (split-hub fragments shipped; 256 queries), and S16 at (c)'s argv
           with ``--spmd --pipeline``, 256 queries (beside ``query_serve``
           (c), the loop route at the same argv), every answer checked as
           in ``query_serve`` (c), measured
           == modeled, q/s, p99, peak memory beyond the service's start,
           the ledger and the ``all_to_all`` spans' ``landed_bytes``
           (equal to their payload unit by unit); (d) the first 4
           units of (c)'s first run dispatched under
           ``torch.cuda.set_sync_debug_mode("error")``
  serve_lm ``repro_torch.launch.serve.main`` on gemma2-27b at full width
           and depth (46 layers, ~55 GB of bf16 weights; the graph phases'
           device tensors are freed first): the launcher's default 32-token
           prompt (dense attention, 0 B8 launches), then a prompt of 8,192
           tokens, batch 1, 16 greedy tokens (46 B8 launches, all of the
           wgmma kernel); prefill ms,
           decode ms/token, tokens/s, peak memory; the last-token logits
           held against the plain route (B8's plain version) on the same
           weights; a second prefill, and a profiled one for the device
           split (B8, GEMMs, the rest) and the idle share; 16 decode steps
           timed one by one (median, min, max ms/token) and 4 profiled ones
           (device ms and launches per token, idle share)
  serve_din ``serve.main --arch din --batch 512`` at the full config
           (10^8 x 18 fp32 item table on the card): ms per batch, req/s
           (the launcher's mean of 3 batches, and 200 batches timed one by
           one: median, p99, min, max); ``bag_fixed`` on the batch's
           history ids (through B10) held against its plain version
  serve_moe ``serve.main`` on moonshot-v1-16b-a3b at its published config
           (48 layers, d_model 2,048, 64 experts of d_ff 1,408, top 6, vocab
           163,840, bf16: 56.1 GB of weights), a prompt of 8,192 tokens,
           batch 1, 16 greedy tokens (48 B8 launches, all of the wgmma
           kernel; finite logits): prefill ms, decode ms/token, peak
           memory; a second prefill with CUDA events around each MoE step
           (routing, dispatch tables, token gather, expert GEMMs,
           combine), a profiled one (B8, GEMMs, the rest; idle share) and
           4 profiled decode steps; then one MoE layer at its published
           width on a seeded [8,192, 2,048] input: expert ids, gates,
           ``keep``, ``slot``, ``disp_tok``, ``disp_gate`` bit-equal to a
           numpy mirror of the reference's dispatch on the host, the output
           within rel L2 2e-2 of a plain fp32 formulation, two calls equal
           bit for bit, its time, and the drops of 16 decode steps at batch
           4; then phi3.5-moe at its published width with its depth cut to
           24 layers (32 hold 83.7 GB of weights): prefill 8,192 x 1 and
           16 decode tokens (24 B8 launches)
  train_gnn ``repro_torch.launch.train.main`` on gin-tu, gat-cora, pna
           and mace (the reference's smoke batch, 20 steps each; B9 4 / 4 /
           11 / 23 times a step), then gin-tu's published config (5 layers,
           d_hidden 64) at ogb_products' shape (2,449,029 nodes, 61,859,140
           edges, 100 features, 47 classes; batch drawn on the card, edges
           sorted by destination once; the serving tensors are freed
           first), gat-cora's at full_graph_sm and mace's (2 layers, 128
           channels, l_max 2, correlation 3, 8 RBFs, 16 species) at
           molecule (128 graphs x 30 nodes x 64 edges, each graph's edges
           among its own nodes, graph_ids nondecreasing), wired by the
           launcher's own ``wire_gnn``: 1 warm-up + 5 timed steps through
           ``TrainRunner`` (ms/step, edges/s,
           peak memory, B9 launches per step, calls of the step), one
           profiled step (device split: B9, gathers, the gathers' backward
           scatters, GEMMs, the rest; idle share), for mace the graph
           energies at positions rotated by a seeded rotation (rel 1e-4 of
           the largest), and the same steps on the
           plain route (B9's plain version): every loss within rel 1e-4;
           then gat-cora's published config at ogb_products' 2,449,029
           nodes and a tenth of its edges (6,185,914; sources from a power
           law whose top 65,536 carry ~35% of them), split as the
           reference's dryrun splits it (65,536 hub rows by out-degree,
           ``split_hot_cold``; B9 8 times a step) and unsplit (4): each
           cell as above, and split == unsplit, every loss within rel 1e-4
  train_lm ``repro_torch.launch.train.main`` on stablelm-1.6b's published
           config (10 steps); the cell stablelm-1.6b x train_4k at the
           published width and depth (24 layers, d_model 2,048, bf16, remat
           on), sequence 4,096, global batch 4 in 2 microbatches
           (train_4k's 256 cut to fit one card), ``TokenStream`` data, the
           launcher's optimizer: 1 warm-up + 5 timed steps through
           ``TrainRunner`` (ms/step, tokens/s, peak memory; every loss
           finite, the first within 1.0 of ln(vocab)), one profiled step;
           the smoke config in fp32 (TF32 off) for 3 steps on the card and
           on the CPU from the same parameters, losses and parameters
           within 1e-5 relative; B8 never launched (training runs its
           differentiable plain version)
  train_moe ``repro_torch.launch.train.main --smoke`` on both MoE LMs (10
           steps); moonshot-v1-16b-a3b at its published width with its
           depth cut to 1 layer, sequence 4,096, batch 4 in 2 microbatches,
           the launcher's optimizer: 1 warm-up + 5 timed steps (ms/step,
           tokens/s, model FLOP/s on the active parameters, peak memory),
           one profiled step; both smoke configs in fp32 (TF32 off) for 3
           steps on the card and on the CPU, within 1e-5 relative; B8
           never launched
  train_din ``repro_torch.launch.train.main`` on DIN's published config
           (10 steps); the cell din x train_batch (65,536 ``CTRStream``
           requests a batch, the 10^8 x 18 item table on the card): 1
           warm-up + 5 timed steps (ms/step, samples/s, peak memory), one
           profiled step, 100,000 item rows no batch looked up unchanged
           bit for bit with zero moments; ``make_retrieval_step`` (top 100)
           over 262,144 Zipf candidates (retrieval_cand's 10^6 cut: the
           [N, 100, 144] fp32 attention features are 57.6 GB at 10^6),
           values and indices equal to a full stable sort's top 100; a
           smoke DIN step on the card against the CPU
  validate ``repro_torch.launch.stream_run`` at R-MAT scale 10, 4 batches,
           ``--device-tier`` with ``--trace --metrics --cache-trace``; the
           three artifacts accepted by ``repro_torch.obs.validate.main``
           (exit 0) in this process, with no module of ``jax`` or of the
           reference package loaded
  timing   each kernel at full-size shapes (CUDA events) beside its plain
           version, its bound and, where one exists, one PyTorch call of
           the same function: B1 at the padded engine's per-round slab; B7
           over the 32 rounds of the S16 epoch (each method; plain versions
           over the same rounds; in turns with a parent checkout's
           ``epoch_count`` when its source is in ``build/parent/``), its
           bound from this run's valid ids, edge
           arrays, landing and ``pair_ops`` compares; B3 on the
           4,096 top-degree rows of the S16 graph with their lengths
           (``launch/resident_timing.py``: ``vs_slots``, the same pairs
           shuffled and ``vs_rows``, with ids that fit the kernel's bitmap
           and again padded to 2^20, interleaved; every batch checked whole
           against ``count_bsearch_torch``), B2 on 65,536 edges
           packed over [0, 65,536), B8 at gemma2-27b's prefill layer (global
           and local, both kernels, the special-function count beside the
           bound; the global layer at softcap 0 too, in both row layouts of
           the wgmma kernel, and for 2 s back to back with the card's clock
           and power sampled; ``F.scaled_dot_product_attention``,
           causal for global, a boolean causal-window mask for local), B10
           (``launch/bag_timing.py``) at the served batch's [512, 100], at
           serve_bulk (262,144 x 100 ids over the 10^8-row table), over
           four serve_bulk batches in turn and with serve_bulk's ids
           redrawn below 256 and over the whole table
           (``F.embedding_bag`` at each),
           B9 (``time_segment_sum``) at ogb_products' aggregations
           ([61,859,140 x 64] and x 100 into 2,449,029; the row's headline,
           from Python), MACE's ([8,192 x 640], x 384, x 128 into 3,840
           segments, the readout [3,840] into 128) and gat-cora's ([10,556 x
           8 x 8], [10,556 x 8] into 2,708) — these from Python and on the
           device alone, in a CUDA graph, in five rounds — beside ``zeros +
           index_add_``, each held element by element against the plain
           output, and in turns with the parent's B9 (its wrapper and
           kernel) when its ``segment_sum_sorted.py`` and ``.cu`` are in
           ``build/parent/``

then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` summary and, last,
``{"ok": true, "device": {...}}``. The launch counts in the summary are read
from the wrappers' counters, set to 0 just before each path (``entry``
through ``pairs``; ``stream``; ``stream_routes``; each run of
``query_serve``; each run of ``spmd``, less the launches its checks add;
the 8,192-token
``serve_lm`` run; each 8,192-token prefill's run in ``serve_moe``;
``serve_din``; each launcher run and each cell's kernel
route in ``train_gnn``, the hub-split cells' too) and read just after
it; launches made by
``checks`` and ``timing`` are not in them, except for B2, whose only path is
its cross-check against B1 (the reference has no other caller of it).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

FULL_SCALE = 16
ORACLE_SCALE = 14
EDGE_FACTOR = 16
RANKS = 8
CACHE_ROWS = 256
FULL_ROUNDS = 32
N_PAIRS = 100_000
LIBRARIES = ("intersect_count", "epoch_count", "resident_intersect",
             "bitmap_popcount", "flash_attention", "flash_attention_wgmma",
             "embedding_bag", "segment_sum_sorted", "spmd_plane")
# a parent checkout's kernel sources, copied here to be timed beside this
# checkout's kernels on the same inputs in one call (absent in a plain run):
# its spmd_plane.cu and epoch_count.cu with the pair_intersect.cuh they
# include, its segment_sum_sorted.cu. A source is taken only when its C
# interface is the one called here (``parent_abi_errors``); any other is
# refused.
PARENT_DIR = os.path.join("build", "parent")
PARENT = {}  # name -> the parent's loaded library
# the C interface ``parent_pair_counts`` calls: the pair-count kernel of a
# warp a worklist position, phantoms included, on the [p, f_pad, W] block
PARENT_PAIR_PARAMS = (
    "const void* rows, const void* fetched, const void* a_idx, "
    "const void* b_idx, const void* a_len, const void* b_len, "
    "const void* mask, void* out, int p, int h, int f_pad, int w, "
    "long long e_tot, void* stream")
# the C interface that the parent's B9 wrapper (``parent_segment_sum``)
# calls: B9 of commit a09601e, a thread a run of ``ept`` edges and a chunk
# of ``vec`` floats, int32 ids
PARENT_SEGSUM_PARAMS = (
    "const void* values, const void* seg, void* out, long long e, int d, "
    "long long n, int vec, int ept, void* stream")
STREAM_ARGV = ["--scale", "14", "--edge-factor", "16", "--batches", "16",
               "--p", "8", "--cache-rows", "256", "--device-tier",
               "--device-slots", "1024", "--device-width", "512",
               "--checkpoint-every", "4"]
# the profiled pass over the stream: the first 4 of its 16 batches, a
# quarter of the updates (all 16 under the profiler took ~99 s)
STREAM_PROFILED_BATCHES = 4
ROUTES_ARGV = ["--scale", "12", "--edge-factor", "16", "--batches", "8",
               "--p", "4", "--cache-rows", "256", "--adversarial",
               "--device-tier", "--device-scope", "per_rank",
               "--device-slots", "256", "--device-width", "256",
               "--partition", "hub", "--rebalance", "--maintain-schedule"]
# the serving and traffic planes (launch/query_serve.py): (a) the verified
# run at S12; (b) cross-rank and open loop on its graph, with fewer
# queries (each --verify event recounts the whole snapshot on the host);
# (c) the static cell's graph, timed, then a profiled continuation; (d)
# both routes at S14. Depth is cut to the time limit: (c) served 9.43 q/s
# on an H100 (host-bound: 434 s for 4,096 queries, PERF.md), so it takes
# 256 here; (a) 1,024 queries, (b), (d) 512 (1,024 / 2,048, 1,024 / 256 /
# 1,024 before phase spmd joined the script).
# B1's checks at the serving path's widest buckets: wa, wb up to
# pow2_ceil of the S16 graph's max degree (9,754), E down to 1
SERVING_WIDE_B1 = ((1, 16384, 16384), (1, 16384, 1), (5, 1, 16384),
                   (64, 16384, 2048), (3, 8192, 16384))
QS_VERIFY_ARGV = ["--scale", "12", "--edge-factor", "16", "--p", "8",
                  "--queries", "1024", "--workload", "zipf",
                  "--write-frac", "0.2", "--device-tier",
                  "--device-slots", "1024", "--verify"]
QS_RANKS_QUERIES = 512
QS_OPEN_FLAGS = ["--open-loop", "poisson", "--slo", "--tenants", "3",
                 "--ewma-scores", "--queries", "1024"]
QS_TIMED_ARGV = ["--scale", "16", "--edge-factor", "16", "--p", "8",
                 "--ranks", "8", "--workload", "zipf", "--write-frac", "0.2",
                 "--batch-window", "64", "--device-tier",
                 "--device-slots", "4096"]
QS_TIMED_QUERIES = 256
QS_PROFILED_QUERIES = 128
QS_ROUTES_ARGV = ["--scale", "14", "--edge-factor", "16", "--p", "8",
                  "--queries", "512", "--workload", "zipf",
                  "--write-frac", "0.2", "--device-tier",
                  "--device-slots", "4096"]
# the SPMD data plane (phase spmd): S16 queries a route (the loop route's
# --ranks 8 beside it), the S12 hub-partition argv (no device tier, so hub
# rows are fetched and ship as fragments), units dispatched under the sync
# check, and units checked inline a run
SPMD_QS_QUERIES = 256
SPMD_HUB_ARGV = ["--scale", "12", "--edge-factor", "16", "--queries", "256",
                 "--workload", "zipf", "--write-frac", "0.2", "--partition",
                 "hub", "--ranks", "8", "--spmd", "--verify"]
SPMD_SYNC_UNITS = 4
SPMD_CHECKS_PER_RUN = 3
VS_SLOTS_PLAIN_PAIRS = 2048  # the all-pairs plain version costs ~W^2/pair
BITMAP_PAIRS = 65_536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# fp32 CUDA-core peak of the data sheet; taken as the rate of the int32
# compares too (an upper bound of it, so the bound stays a lower bound)
OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, the same sheet
# special-function units (exp2, rcp): 16 results a clock per SM (NVIDIA's
# arithmetic throughput table, compute capability 9.0) x 132 SMs x 1,980
# MHz (the card's maximum SM clock, nvidia-smi clocks.max.sm)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# the serving path: gemma2-27b at full width and depth, a prompt of the
# reference's flash cutoff (8,192; its shape prefill_32k is 32,768 x 32),
# batch 1, 16 greedy tokens; then the launcher's defaults (dense attention)
LM_ARGV = ["--arch", "gemma2-27b", "--prompt", "8192", "--batch", "1",
           "--tokens", "16"]
LM_SHORT_ARGV = ["--arch", "gemma2-27b"]
DECODE_PROFILED = 4  # decode steps traced for the device split
# steps timed one by one (synchronised) for the spread of the host clock:
# the launcher's own windows (16 tokens; DIN's 3 batches) are too short to
# give a stable number on their own
DECODE_STEADY = 16
DIN_STEADY = 200
DIN_ARGV = ["--arch", "din", "--batch", "512"]  # serve_p99 at the full config
BULK_BAGS = 262_144  # serve_bulk: the B10 timing's batch
# kernel route vs plain route, last-token logits of the 46-layer bf16 model:
# relative L2 error. The two differ only in B8's summation order: its bf16
# outputs an ulp (2^-8 relative) apart, which 46 residual layers carry into
# the logits at the percent level, not beyond a few.
LOGITS_REL_TOL = 5e-2
# B8 vs its plain version. fp32: the reference kernel test's 2e-5 as
# atol + rtol * max|plain| (the two differ in summation order only).
# bf16/fp16: both round one fp32 result to the output dtype, so each element
# may differ by one ulp of it (2^-7 / 2^-10 of its size) plus FLASH_ATOL for
# the fp32 summation noise near 0. Leaving out one 64-key tile of a late
# row's 8,192 keys moves that row's outputs by ~1e-3.
FLASH_TOL = {"float32": 2e-5}
FLASH_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
FLASH_ATOL = 1e-4
BAG_TOL = 2e-3  # the reference's embedding-bag test tolerance
# B9 vs its plain version: the reference's segment-sum test tolerance
# (rtol = atol, element by element): fp32 sums in another order, and
# atomics whose order changes from run to run
SEGSUM_TOL = 1e-5
# the training path: the launcher on the four GNN archs (the reference's
# smoke batch), then gin-tu's published config at ogb_products' shape,
# gat-cora's at full_graph_sm and mace's at molecule, 1 warm-up + 5 timed
# steps each through TrainRunner, then the same steps on the plain route
# (B9's plain version)
TRAIN_ARCHS = ("gin-tu", "gat-cora", "pna", "mace")
TRAIN_LAUNCHER_STEPS = 20
TRAIN_CELLS = (("gin-tu", "ogb_products"), ("gat-cora", "full_graph_sm"),
               ("mace", "molecule"))
TRAIN_STEPS = 6
# cells whose step is also timed with the parent's B9 in turns (when its
# wrapper and source are in build/parent/): B9 runs 23 times a MACE step
B9_TURN_CELLS = (("mace", "molecule"),)
B9_TURN_STEPS = 21  # a run of those turns: 1 warm-up + 20 timed steps
# B9 launches per step reckoned from the code: one per aggregation, plus
# the graph readout (gin smoke, mace), the softmax denominator (gat), two
# per segment_mean and one for the degrees (pna), one per coupling path
# and layer (mace: 11 x 2); the backward launches none
B9_PER_STEP = {("gin-tu", "smoke"): 4, ("gat-cora", "smoke"): 4,
               ("pna", "smoke"): 11, ("mace", "smoke"): 23,
               ("gin-tu", "ogb_products"): 5,
               ("gat-cora", "full_graph_sm"): 4, ("mace", "molecule"): 23,
               # GAT's hub split: 4 a layer (each stream's denominator and
               # aggregation); the same edges unsplit: 2 a layer
               ("gat-cora", "ogb_products_hub"): 8,
               ("gat-cora", "ogb_products_cut"): 4}
# GAT's hub split (the reference's dryrun, launch/dryrun.py:257-282) at
# ogb_products' nodes: the 65,536 sources of highest out-degree as hub rows,
# sources drawn from a power law whose top 65,536 carry ~35% of the edges
# (the dryrun's measured hot share). Edges cut to a tenth (6,185,914):
# the last layer's [E, 8 heads, 47 classes] fp32 messages are 1,504 B an
# edge, ~6.6 KB an edge at the backward's peak, ~400 GB at 61.9M
HUB_CAPACITY = 65_536
HUB_HOT_SHARE = 0.35
HUB_EDGE_CUT = 10
# kernel route vs plain route, each step's loss: relative. The routes
# differ in B9's fp32 summation order only; 6 Adam steps at lr 1e-3 carry it
TRAIN_LOSS_RTOL = 1e-4
# LM training (phase train_lm): the launcher on stablelm-1.6b's published
# config (its TokenStream of 4 x 64, 2 microbatches); the cell
# stablelm-1.6b x train_4k at the published width and depth (24 layers,
# bf16, remat on) and train_4k's sequence of 4,096, its global batch cut
# from 256 to 4 (2 microbatches of 2) to fit one card's 80 GB with the
# AdamW moments; then the smoke config in fp32 on the card against the CPU
LM_TRAIN_ARGV = ["--arch", "stablelm-1.6b", "--steps", "10"]
LM_CELL_BATCH = 4
LM_CELL_MICROBATCHES = 2
LM_FIRST_LOSS_TOL = 1.0  # |first loss - ln(vocab)| of random weights
LM_PARITY_STEPS = 3
# the card's fp32 train steps against the CPU's: the CPU parity tests'
# tolerance (tests/test_torch_lm_train.py), relative
PARITY_RTOL = 1e-5
# MoE serving (phase serve_moe): moonshot-v1-16b-a3b through the serve
# launcher at its published config (48 layers, d_model 2,048, 64 experts of
# d_ff 1,408, top 6, vocab 163,840, bf16: 56.1 GB of weights), a prompt of
# 8,192 tokens (B8 once a layer), batch 1, 16 greedy tokens; its MoE layer
# alone on a seeded [8,192, 2,048] input; phi3.5-moe at its published width
# with its depth cut from 32 to 24 layers (32 hold 83.7 GB of weights, more
# than the card's 80; 24 hold ~63 GB)
MOE_ARGV = ["--arch", "moonshot-v1-16b-a3b", "--prompt", "8192", "--batch",
            "1", "--tokens", "16"]
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 24
MOE_DECODE_BATCH = 4  # the serve launcher's default batch: c = 1
MOE_DROP_STEPS = 16  # decode steps of MOE_DECODE_BATCH tokens counted
# the MoE layer's bf16 output against a plain fp32 formulation (each
# expert's kept tokens times their gates, summed): relative L2. bf16 rounds
# the two up-projections, their SwiGLU product, the down-projection, the
# gated rows and each of the k running sums (2^-9 relative each); ~1% in
# L2 at most, so 2e-2 leaves twice that
MOE_REL_TOL = 2e-2
# MoE training (phase train_moe): the launcher's --smoke runs of both MoE
# LMs; moonshot at its published width with its depth cut from 48 to 1
# layer (48 layers with fp32 moments and the fp32 gradient buffer are ~340
# GB; on the card 4 layers ran out of its 80 GB in a step's forward, 70.25
# GiB allocated, and 2 layers in a backward, 60.79 GiB allocated and 13.72
# reserved but free, asking 5 GiB for the fp32 gradient of the [2, 4,096,
# 163,840] logits: each layer holds 8 GB of weights, moments and fp32
# gradient buffer, the 163,840-word head ~20 GB of a microbatch's
# activations), at train_4k's sequence of 4,096, batch 4 in
# 2 microbatches (as train_lm's cell); then each smoke config in fp32 on the
# card against the CPU
MOE_ARCHS = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
MOE_TRAIN_LAYERS = 1
# recsys training (phase train_din): the launcher on DIN's published
# config; the cell din x train_batch (65,536 requests, 10^8 x 18 item
# table on the card; not cut); retrieval at retrieval_cand with the
# candidates cut from 1,000,000 to 262,144: the [N, 100, 144] fp32
# attention features are 57.6 GB at 10^6
DIN_TRAIN_ARGV = ["--arch", "din", "--steps", "10"]
DIN_CELL_BATCH = 65_536
RETRIEVAL_CANDIDATES = 262_144
RETRIEVAL_TOP_K = 100
DIN_UNTOUCHED_SAMPLE = 100_000  # item rows no batch looked up, checked
# MACE's graph energies at the rotated positions against the energies, per
# graph relative to the largest |energy|: the reference's invariance
# tolerance (the coupling tensors' floor ~1e-6, fp32 sums)
ROTATION_RTOL = 1e-4
# the port's own validator on the port's --trace / --metrics / --cache-trace
# artifacts of a small streaming run on the card
VALIDATE_ARGV = ["--scale", "10", "--edge-factor", "16", "--batches", "4",
                 "--device-tier"]


def c_params(path, name):
    """The parameter list of the ``extern "C"`` function ``name`` defined
    in the source ``path``, its whitespace collapsed; None if absent."""
    with open(path) as f:
        m = re.search(r'extern "C" int ' + name + r"\s*\(([^)]*)\)",
                      f.read())
    return None if m is None else " ".join(m.group(1).split())


def parent_abi_errors(name, src, build):
    """Why the parent's ``name``.cu cannot be called here (empty if it
    can): its ``epoch_count`` entry points must be declared as this
    checkout's (the swap runs this checkout's wrapper on them), its
    ``spmd_pair_counts_launch`` as ``PARENT_PAIR_PARAMS``, its
    ``segment_sum_sorted_launch`` as ``PARENT_SEGSUM_PARAMS``."""
    if name == "epoch_count":
        own = str(build.CSRC / "epoch_count.cu")
        want = {fn: c_params(own, fn) for fn in (
            "epoch_count_launch", "epoch_land_launch",
            "epoch_count_stage_cap")}
    elif name == "segment_sum_sorted":
        want = {"segment_sum_sorted_launch": PARENT_SEGSUM_PARAMS}
    else:
        want = {"spmd_pair_counts_launch": PARENT_PAIR_PARAMS}
    return [f"{fn}({c_params(src, fn)}) is not {fn}({params})"
            for fn, params in want.items() if c_params(src, fn) != params]


def start_parent_builds(root, build):
    """One ``nvcc`` for each parent source in ``PARENT_DIR``, all started
    together; ``finish_parent_builds`` waits for them and loads each. A
    source whose C interface is not the one called here raises."""
    d = os.path.join(root, PARENT_DIR)
    started = []
    for name in ("epoch_count", "spmd_plane", "segment_sum_sorted"):
        src = os.path.join(d, f"{name}.cu")
        if os.path.exists(src):
            errors = parent_abi_errors(name, src, build)
            if errors:
                raise RuntimeError(f"{src}: another C interface than this "
                                   f"script calls: {'; '.join(errors)}")
            lib = os.path.join(d, f"lib{name}.so")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", d, "-o", lib, src]
            started.append((name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    return started


def finish_parent_builds(started):
    import ctypes

    out = []
    for name, lib, proc in started:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{err}")
        PARENT[name] = ctypes.CDLL(lib)
        out.append({"name": name, "source": os.path.join(PARENT_DIR,
                                                         f"{name}.cu"),
                    "registers": [int(x) for x in
                                  re.findall(r"Used (\d+) registers", err)],
                    "spill_store_bytes": [
                        int(x) for x in
                        re.findall(r"(\d+) bytes spill stores", err)]})
    return out


_T0 = time.perf_counter()
_LAST = [_T0]


def emit(obj) -> None:
    """Print one JSON line; a phase's record gets ``phase_wall_s``, the
    seconds since the previous phase's line (the phase's own wall)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_wall_s": now - _LAST[0]}
        _LAST[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0].strip()


def sustained(fn, torch, seconds=2.0):
    """``fn`` back to back for ``seconds``: mean ms a call (CUDA events),
    and the SM clock (MHz) and board power (W) that ``nvidia-smi`` samples
    every 200 ms meanwhile, as [min, max]."""
    fn()
    torch.cuda.synchronize()
    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        calls, t0 = 0, time.perf_counter()
        start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            calls += 20
            torch.cuda.synchronize()
        stop.record()
        torch.cuda.synchronize()
    finally:
        mon.terminate()
        text = mon.communicate(timeout=30)[0]
    samples = []
    for line in text.splitlines():
        try:
            clock, watt = (float(x) for x in line.split(","))
        except ValueError:
            continue
        samples.append((clock, watt))
    clocks = [c for c, _ in samples] or [float("nan")]
    watts = [w for _, w in samples] or [float("nan")]
    return {"ms": start.elapsed_time(stop) / calls, "calls": calls,
            "sm_clock_mhz": [min(clocks), max(clocks)],
            "power_w": [min(watts), max(watts)], "samples": len(samples)}


def pad_sorted(rng, e, w, sentinel, np):
    out = np.full((e, w), sentinel, np.int32)
    for i in range(e):
        k = int(rng.integers(0, w + 1))
        vals = np.unique(rng.integers(0, sentinel, size=k))
        out[i, : len(vals)] = vals
    return out


def global_rows(prob, ids, np):
    """(owner rank, local row index) of global vertex ids in the compiled
    problem's ``rows_ext`` slabs; id ``n`` maps to the phantom row."""
    ids = np.asarray(ids, np.int64)
    part = prob.part
    real = ids < prob.n
    safe = np.where(real, ids, 0)
    own = part.owner(safe).astype(np.int64)
    lo = np.array([part.lo(k) for k in range(prob.p)], np.int64)
    loc = np.where(real, safe - lo[own], prob.n_loc)
    return own, loc


def bound_ms(nbytes: float, ops: float):
    """(bound ms, what bounds it): the larger of the bytes over the card's
    memory rate and the operations over its peak rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def pair_ops(na, nb, torch) -> float:
    """Compares that intersecting sorted rows of valid lengths ``na``,
    ``nb`` needs, pair by pair the cheaper of a merge (na + nb) and a
    search of the shorter in the longer (ns * ceil(log2(nl + 1))): a
    count of the work, not of one algorithm's steps."""
    na, nb = na.to(torch.float64), nb.to(torch.float64)
    ns, nl = torch.minimum(na, nb), torch.maximum(na, nb)
    return float(torch.minimum(ns * torch.ceil(torch.log2(nl + 1)),
                               na + nb).sum())


def hub_problem(p, n_rounds, cache_rows, seed, np):
    """Five hubs adjacent to every live vertex (hub x hub pairs on every
    rank), 3,000 random edges, 4 isolated vertices; phantom edge slots
    pointed at real rows, so only the mask keeps them out."""
    from repro_torch.core.cache import build_static_degree_cache
    from repro_torch.core.csr import from_edges
    from repro_torch.core.rma import build_sharded_problem

    rng = np.random.default_rng(seed)
    n, live = 600, 596
    edges = [(h, v) for h in (0, 1, 150, 300, 451) for v in range(live)]
    edges += [tuple(e) for e in rng.integers(0, live, size=(3000, 2))]
    g = from_edges(np.array(edges), n, undirected=True)
    cache = (build_static_degree_cache(g.degrees, cache_rows)
             if cache_rows else None)
    prob = build_sharded_problem(g, p, n_rounds=n_rounds, cache=cache)
    phantom = ~prob.edge_mask
    prob.edge_u[phantom] = rng.integers(0, prob.n_loc, phantom.sum())
    prob.edge_vc[phantom] = rng.integers(0, prob.n_loc, phantom.sum())
    return prob


def check_epoch(dev, full, np, torch):
    """B7's two kernels against their plain versions, tolerance 0, round by
    round: ``epoch_land`` (the whole landing buffer) and ``epoch_count``
    (every method, against the plain ``bsearch`` count) on four hub problems
    (p 1-8, n_rounds 1-3, cache 0-16) and on rounds 0, NR/2 and NR-1 of the
    full-size problem ``full``; the phantom row of each rank stays 0.
    Returns (cases, max_abs_err, launches)."""
    from repro_torch.kernels import epoch_count as ec

    ec.reset_launches()
    cases, worst = [], 0
    probs = [(f"hub p{p} nr{nr} c{c}", hub_problem(p, nr, c, p, np).to_device(
        dev), None) for p, nr, c in [(1, 1, 0), (4, 1, 0), (4, 3, 8),
                                     (8, 2, 16)]]
    probs.append(("full", full, sorted({0, full.n_rounds // 2,
                                        full.n_rounds - 1})))
    for tag, dp, rounds in probs:
        index = ec.epoch_index(dp)
        width = dp.p * (dp.n_loc + 1)
        for r in rounds or range(dp.n_rounds):
            land = torch.full((max(1, dp.land_ids),), -7, dtype=torch.int32,
                              device=dev)
            ec.epoch_land(dp, index, r, land)
            torch.cuda.synchronize()
            want_land = ec.epoch_land_ref(dp, index, r, land.clone())
            err = int((land.long() - want_land.long()).abs().max())
            want = ec.epoch_count_ref(
                dp, index, r, want_land,
                torch.zeros(width, dtype=torch.int32, device=dev),
                method="bsearch")
            errs = {"epoch_land": err}
            for method in ("bsearch", "pairwise", "hybrid"):
                acc = torch.zeros(width, dtype=torch.int32, device=dev)
                ec.epoch_count(dp, index, r, land, acc, method=method)
                torch.cuda.synchronize()
                errs[method] = int((acc.long() - want.long()).abs().max())
                if int(acc.view(dp.p, -1)[:, dp.n_loc].abs().max()) != 0:
                    raise RuntimeError(f"epoch_count {tag} round {r}: a "
                                       "phantom row was written")
            cases.append({"case": tag, "round": r, "p": dp.p,
                          "landed_ids": int(index.land_len[r].sum()),
                          "sum_counts": int(want.long().sum()), "err": errs})
            worst = max(worst, *errs.values())
            if any(errs.values()):
                raise RuntimeError(f"epoch kernels {tag} round {r}: kernel "
                                   f"!= plain version {errs}")
            del land, want_land, want
    return cases, worst, ec.launches()


def epoch_pair_lengths(dprob, index, torch):
    """(na, nb) of every real edge slot of the epoch, on the device."""
    p, n_loc, s_max = dprob.p, dprob.n_loc, dprob.s_max
    c = dprob.cache_rows.shape[0]
    e_chunk = dprob.e_max // dprob.n_rounds
    dev = dprob.rows_ext.device
    rank = torch.arange(p, device=dev, dtype=torch.int64)[:, None]
    real = dprob.edge_mask
    eu = dprob.edge_u.to(torch.int64)[real]
    vc = dprob.edge_vc.to(torch.int64)[real]
    rk = rank.expand(-1, dprob.e_max)[real]
    rnd = (torch.arange(dprob.e_max, device=dev)[None, :] // e_chunk).expand(
        p, -1)[real]
    base = rk * (n_loc + 1)
    na = index.deg_ext[base + eu]
    local = vc <= n_loc
    cache = (vc > n_loc) & (vc < n_loc + 1 + c)
    item = rk * p * s_max + (vc - (n_loc + 1 + c)).clamp(min=0)
    nb = torch.where(local, index.deg_ext[base + vc.clamp(max=n_loc)],
                     index.land_len[rnd, item.clamp(max=p * p * s_max - 1)])
    if c:
        nb = torch.where(cache, index.cache_len[(vc - n_loc - 1).clamp(
            0, c - 1)], nb)
    return na, nb


def time_epoch(dprob, np, torch):
    """B7's two kernels over one epoch of the full-size problem (CUDA
    events; the mean of 5 epochs, the lower of two such means): the 32
    ``epoch_land`` and the 32 ``epoch_count`` launches of each method
    summed, every round landing into its own buffer so the two are timed
    apart; the plain versions over the same rounds; bounds from this run's
    data: ``epoch_count`` reads every valid id of the local and cache rows
    and of the landing, the edge arrays (u, v: 8 bytes a real slot; the
    mask: 1 byte a slot) and writes S, and does ``pair_ops`` compares;
    ``epoch_land`` reads and writes the landed ids and reads its index."""
    from repro_torch.kernels import epoch_count as ec

    dev = dprob.rows_ext.device
    nr = dprob.n_rounds
    index = ec.epoch_index(dprob)
    lands = [torch.empty(max(1, dprob.land_ids), dtype=torch.int32,
                         device=dev) for _ in range(nr)]
    width = dprob.p * (dprob.n_loc + 1)
    acc = torch.zeros(width, dtype=torch.int32, device=dev)

    def land_all():
        for r in range(nr):
            ec.epoch_land(dprob, index, r, lands[r])

    def count_all(method):
        for r in range(nr):
            ec.epoch_count(dprob, index, r, lands[r], acc, method=method)

    land_ms = min_ms(land_all, reps=5, warmup=1)
    count_ms = {m: min_ms(lambda m=m: count_all(m), reps=5, warmup=1)
                for m in ("hybrid", "pairwise", "bsearch")}
    parent_ms = None
    if "epoch_count" in PARENT:  # the parent's kernels in turns with these
        from repro_torch.kernels import _build

        own = _build._libs["epoch_count"]
        parent_ms = {"parent": [], "this": []}
        try:
            for who in ("parent", "this", "this", "parent"):
                _build._libs["epoch_count"] = (PARENT["epoch_count"]
                                               if who == "parent" else own)
                parent_ms[who].append(min_ms(lambda: count_all("hybrid"),
                                             reps=5, warmup=1))
        finally:
            _build._libs["epoch_count"] = own
    acc.zero_()
    count_all("hybrid")
    got = acc.clone()
    ref_lands = [l.clone() for l in lands]
    land_plain_ms = cuda_ms(
        lambda: [ec.epoch_land_ref(dprob, index, r, ref_lands[r])
                 for r in range(nr)], reps=1, warmup=0)
    want = torch.zeros_like(acc)
    count_plain_ms = cuda_ms(
        lambda: [ec.epoch_count_ref(dprob, index, r, ref_lands[r], want,
                                    method="bsearch") for r in range(nr)],
        reps=1, warmup=0)
    err = max(int((got.long() - want.long()).abs().max()),
              max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(lands, ref_lands)))
    if err:
        raise RuntimeError(f"timing: epoch kernels != plain versions ({err})")
    na, nb = epoch_pair_lengths(dprob, index, torch)
    ops_count = pair_ops(na, nb, torch)
    landed = float(index.land_len.to(torch.float64).sum())
    n_real = float(na.numel())
    count_bytes = 4.0 * (float(dprob.degrees.to(torch.float64).sum())
                         + float(index.cache_len.to(torch.float64).sum())
                         + landed) + 8.0 * n_real \
        + float(dprob.edge_mask.numel()) + 4.0 * width
    land_bytes = 8.0 * landed + 4.0 * dprob.serve_idx.numel() \
        + 12.0 * index.land_len.numel()
    c_bound, c_by = bound_ms(count_bytes, ops_count)
    l_bound, l_by = bound_ms(land_bytes, 0.0)
    del lands, ref_lands
    return {
        "rounds": nr, "real_pairs": int(n_real), "landed_ids": int(landed),
        "epoch_count": {"ms_per_epoch": count_ms,
                        "ms_per_round": {m: v / nr
                                         for m, v in count_ms.items()},
                        "plain_ms_per_epoch": count_plain_ms,
                        "plain_method": "bsearch", "bytes": count_bytes,
                        "ops": ops_count, "bound_ms_per_epoch": c_bound,
                        "bound_by": c_by, "err": err,
                        "hybrid_ms_per_epoch_in_turns": parent_ms},
        "epoch_land": {"ms_per_epoch": land_ms, "ms_per_round": land_ms / nr,
                       "plain_ms_per_epoch": land_plain_ms,
                       "bytes": land_bytes, "bound_ms_per_epoch": l_bound,
                       "bound_by": l_by}}


def hub_residency(rng, np, sent=1 << 16, universe=24_000):
    """A hub residency for B3: one row of 12,000 ids, rows near the S16
    graph's widest (9,000-9,754), short rows (0-200 ids) and evicted
    (all-sentinel) slots; ids drawn from ``[0, universe)`` so hub rows share
    thousands of ids. Returns (rows [64, 12,288], sentinel)."""
    widths = [12_000] + list(rng.integers(9_000, 9_755, 15))
    widths += list(rng.integers(0, 201, 40)) + [0] * 8
    res = np.full((len(widths), 12_288), sent, np.int32)
    for i, k in enumerate(widths):
        res[i, :k] = np.sort(rng.choice(universe, size=int(k), replace=False))
    return res, sent


def check_resident_intersect(dev, rng, np, torch):
    """B3 vs its plain version, tolerance 0, with the slot
    lengths given (the true ones; cut or overlong ones) and not given: both
    variants at ragged E, query widths 0-200, evicted slots, S = 1 and
    4,096 (W = 64); then a hub residency (``hub_residency``: rows of 12,000
    and 9,000-9,754 ids, heavy pairs) with ``vs_slots`` pairs in runs that
    share ``slot_a`` (bitmap runs) and the same pairs shuffled, and
    ``vs_rows`` pairs in runs against uploaded hub-wide rows, with ids
    below 2^16 and below 2^20 (no bitmap). An out-of-range slot raises
    before a launch. Returns (cases, max_abs_err)."""
    from repro_torch.kernels import resident_intersect as ri

    cases, worst = [], 0

    def up(x):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, np.int32)).to(dev)

    def held(case, res_t, sa, rows, sb, sent, lens_modes, perm=None):
        """Every lengths mode against the plain version; with
        ``perm``, the pairs again in that order against the same counts."""
        nonlocal worst
        orders = [("as_given", slice(None))]
        if perm is not None:
            orders.append(("shuffled", perm))
        for lens_tag, lens in lens_modes:
            want = ri.resident_intersect_ref(
                res_t, up(sa), up(rows), slots_b=up(sb), lengths=lens,
                sentinel=sent).cpu().numpy()
            for order, idx in orders:
                got = ri.resident_intersect_counts(
                    res_t, sa[idx], None if rows is None else rows[idx],
                    slots_b=None if sb is None else sb[idx], lengths=lens,
                    sentinel=sent, device=dev)
                torch.cuda.synchronize()
                if got.dtype != np.int64 or got.shape != sa.shape:
                    raise RuntimeError(f"B3 output {got.dtype} {got.shape}")
                err = int(np.abs(got - want[idx]).max()) if sa.size else 0
                worst = max(worst, err)
                if err:
                    raise RuntimeError(f"B3 {case} {lens_tag} {order}: "
                                       f"kernel != plain (err {err})")
        cases.append({**case, "lengths": [t for t, _ in lens_modes],
                      "orders": [o for o, _ in orders], "err": 0})

    def lens_modes(res, sent):
        true = (res < sent).sum(1).astype(np.int32)
        off = true + rng.integers(-3, 4, true.size).astype(np.int32)
        return [("none", None), ("true", up(true)),
                ("cut_or_overlong", up(off))]

    for s, w, sent in ((1, 16, 4096), (4096, 64, 4096)):
        res = pad_sorted(rng, s, w, sent, np)
        evicted = rng.choice(s, size=max(1, s // 16), replace=False)
        res[evicted] = sent
        res_t, modes = up(res), lens_modes(res, sent)
        for e in (0, 1, 7, 64, 130, 1000):
            sa = rng.integers(0, s, e)
            sb = rng.integers(0, s, e)
            if e:
                sa[0] = evicted[0]
                sb[-1] = evicted[0]
            held({"variant": "vs_slots", "S": s, "W": w, "E": e}, res_t, sa,
                 None, sb, sent, modes)
            for wb in (0, 4, 32, 200):
                held({"variant": "vs_rows", "S": s, "W": w, "E": e,
                      "WB": wb}, res_t, sa, pad_sorted(rng, e, wb, sent, np),
                     None, sent, modes)
    # hub rows: runs of pairs sharing slot_a, then the same pairs shuffled;
    # ids < 2^16 (bitmap runs) and < 2^20 (no bitmap: the id space is wider
    # than the kernel's bitmap)
    for sent in (1 << 16, 1 << 20):
        res, _ = hub_residency(rng, np, sent=sent)
        res_t, modes = up(res), lens_modes(res, sent)
        s = res.shape[0]
        runs = rng.integers(1, 40, 80)
        sa = np.repeat(rng.integers(0, s, runs.size), runs)[:1500]
        sb = rng.integers(0, s, sa.size)
        sb[: sa.size // 2] = rng.integers(0, 16, sa.size // 2)  # hub x hub
        held({"variant": "vs_slots", "S": s, "W": res.shape[1], "E": sa.size,
              "sentinel": sent, "hub": True}, res_t, sa, None, sb, sent,
             modes, perm=rng.permutation(sa.size))
        # uploaded rows of another hub residency: hub x hub pairs are heavy
        sa = np.repeat(rng.integers(0, s, 12), 32)
        rows = hub_residency(rng, np, sent=sent)[0][rng.integers(0, s,
                                                                 sa.size)]
        held({"variant": "vs_rows", "S": s, "W": res.shape[1], "E": sa.size,
              "WB": rows.shape[1], "sentinel": sent, "hub": True}, res_t, sa,
             rows, None, sent, modes, perm=rng.permutation(sa.size))
    before = ri.launches()
    try:
        ri.resident_intersect_counts(res_t, np.array([0, s]),
                                     slots_b=np.array([0, 0]), sentinel=sent,
                                     device=dev)
    except ValueError:
        pass
    else:
        raise RuntimeError("B3: an out-of-range slot did not raise")
    if ri.launches() != before:
        raise RuntimeError("B3: a refused call launched the kernel")
    return cases, worst


def check_bitmap(dev, rng, heavy_a, heavy_b, n, sent, np, torch):
    """B2 vs its plain version at E x W in {1,3,256,1000} x {1,3,128,2048},
    then B2 against B1 on the 512 heavy edges of the full-size graph packed
    over [0, n). Returns (cases, max_abs_err, cross-check launches)."""
    from repro_torch.core.csr import rows_to_bitmap_words
    from repro_torch.kernels import bitmap_popcount as bm
    from repro_torch.kernels import ops

    cases, worst = [], 0
    for e in (1, 3, 256, 1000):
        for w in (1, 3, 128, 2048):
            a = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
            b = rng.integers(0, 2**32, size=(e, w), dtype=np.uint32)
            got = ops.bitmap_intersect_count(a, b, device=dev)
            torch.cuda.synchronize()
            want = bm.bitmap_intersect_count_ref(
                torch.from_numpy(a.view(np.int32)).to(dev),
                torch.from_numpy(b.view(np.int32)).to(dev))
            if got.dtype != torch.int32 or got.shape != (e,):
                raise RuntimeError(f"B2 output {got.dtype} {got.shape}")
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            cases.append({"E": e, "W": w, "err": err})
            if err:
                raise RuntimeError(f"B2 {cases[-1]}: kernel != plain")
    wa = rows_to_bitmap_words(heavy_a.cpu().numpy(), n)
    wb = rows_to_bitmap_words(heavy_b.cpu().numpy(), n)
    bm.reset_launches()
    by_bitmap = ops.bitmap_intersect_count(wa, wb, device=dev)
    cross_launches = bm.launches()
    by_rows = ops.intersect_count(heavy_a, heavy_b, sentinel=sent)
    err = int((by_bitmap.long() - by_rows.long()).abs().max())
    worst = max(worst, err)
    cases.append({"cross_check_vs_intersect_count": list(heavy_a.shape),
                  "words": list(wa.shape), "err": err})
    if err:
        raise RuntimeError("B2 != B1 on the heavy edges of the full graph")
    return cases, worst, cross_launches


class CallRecorder:
    """Wraps the streaming engine's two kernel entry points: counts calls,
    keeps the inputs of the largest call of each route (to hold the kernel
    against its plain version at the path's own shapes afterwards) and the
    host seconds spent inside them. Launch counters stay in the wrappers."""

    def __init__(self, incremental, torch):
        self.mod = incremental
        self.torch = torch
        self.orig = {k: getattr(incremental, k) for k in
                     ("resident_intersect_counts", "delta_intersect_counts")}
        self.calls = {"vs_rows": 0, "vs_slots": 0, "delta": 0}
        self.pairs = dict.fromkeys(self.calls, 0)
        self.seconds = dict.fromkeys(self.calls, 0.0)
        self.largest = {}

    def _keep(self, route, e, args):
        """``args()`` copies the call's inputs: only for a new largest."""
        if e > self.largest.get(route, (0,))[0]:
            self.largest[route] = (e, args())

    def __enter__(self):
        def resident(residency, slots_a, rows_b=None, *, slots_b=None, **kw):
            route = "vs_slots" if slots_b is not None else "vs_rows"
            t0 = time.perf_counter()
            out = self.orig["resident_intersect_counts"](
                residency, slots_a, rows_b, slots_b=slots_b, **kw)
            self.seconds[route] += time.perf_counter() - t0
            self.calls[route] += 1
            self.pairs[route] += len(slots_a)
            lens = kw.get("lengths")
            self._keep(route, len(slots_a), lambda: (
                residency.clone(), slots_a.copy(),
                None if rows_b is None else rows_b.copy(),
                None if slots_b is None else slots_b.copy(),
                None if lens is None else lens.clone(),
                kw["sentinel"], out))
            return out

        def delta(rows_a, rows_b, **kw):
            t0 = time.perf_counter()
            out = self.orig["delta_intersect_counts"](rows_a, rows_b, **kw)
            self.seconds["delta"] += time.perf_counter() - t0
            self.calls["delta"] += 1
            self.pairs["delta"] += len(rows_a)
            self._keep("delta", len(rows_a),
                       lambda: (list(rows_a.shape), list(rows_b.shape)))
            return out

        self.mod.resident_intersect_counts = resident
        self.mod.delta_intersect_counts = delta
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.mod, k, fn)

    def recheck(self, dev, np):
        """Largest B3 call of each variant, again: kernel vs plain version
        on the same inputs (the tier's lengths included). Returns
        ({variant: shape}, max_abs_err)."""
        from repro_torch.kernels import resident_intersect as ri

        torch = self.torch
        shapes, worst = {}, 0
        for route in ("vs_rows", "vs_slots"):
            e, (res, sa, rows_b, slots_b, lens, sent, got) = \
                self.largest[route]
            want = ri.resident_intersect_ref(
                res, torch.from_numpy(sa.astype(np.int32)).to(dev),
                None if rows_b is None else torch.from_numpy(rows_b).to(dev),
                slots_b=(None if slots_b is None else
                         torch.from_numpy(slots_b.astype(np.int32)).to(dev)),
                lengths=lens, sentinel=sent).cpu().numpy()
            again = ri.resident_intersect_counts(
                res, sa, rows_b, slots_b=slots_b, lengths=lens, sentinel=sent,
                device=dev)
            err = int(max(np.abs(got - want).max(), np.abs(again - want).max()))
            worst = max(worst, err)
            shapes[route] = {"residency": list(res.shape), "E": e,
                             "WB": None if rows_b is None else rows_b.shape[1],
                             "lengths": lens is not None, "err": err}
            if err:
                raise RuntimeError(f"stream: B3 {route} kernel != plain "
                                   f"at the path's largest call {shapes}")
        return shapes, worst


def kernel_rows(prof, torch):
    """Device time by kernel name from a torch.profiler trace."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": ev.key[:80], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def attention_work(s, t, kh, g, dh, causal, window, itemsize):
    """(FLOP, bytes) of B8 at one shape: 4 * dh FLOP per live (query, key)
    pair, the causal limit and the window counted exactly; q, k, v read
    once and out written once."""
    import numpy as np

    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i + 1, t) if causal else np.full(s, t, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s,
                                                                   np.int64)
    pairs = float(np.clip(hi - lo, 0, None).sum()) * kh * g
    nbytes = (2.0 * s * kh * g * dh + 2.0 * t * kh * dh) * itemsize
    return pairs * 4 * dh, nbytes


def check_flash(dev, rng, np, torch):
    """B8 vs its plain version: (causal, window in {0, 64, 4096}, softcap
    in {0, 50}) and non-causal, x G in {1, 2} x dh in {64, 128}, at S that
    no tile divides (300, and 4,500 for the 4,096 window), in fp32 (the FMA
    kernel) and in bf16 (the wgmma kernel); fp16, dh 256, S != T, scores
    past the softcap's series, rows TMA cannot read in place; the full
    gemma2-27b layer shape [1, 8192, 16, 2, 128] in bf16, global and local.
    Each case asserts that the kernel ``variant`` names ran: wgmma for
    bf16/fp16 at dh 64 and 128, fma for fp32 and dh 256. Returns (cases,
    max_abs_err, launches by variant)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.attention import flash_attention_torch

    def inputs(b, s, t, kh, g, dh, dtype, pad):
        """q, k, v; with pad > 0 views of the first dh of dh + pad columns
        (rows 2 (dh + pad) bytes apart: the wgmma wrapper copies them)."""
        shapes = ((b, s, kh, g, dh + pad), (b, t, kh, dh + pad),
                  (b, t, kh, dh + pad))
        return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                .to(dev, dtype)[..., :dh] for sh in shapes]

    cases, worst = [], 0.0
    plan = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window, cap in ((True, 0, 0.0), (True, 0, 50.0),
                                    (True, 64, 0.0), (True, 64, 50.0),
                                    (True, 4096, 0.0), (True, 4096, 50.0),
                                    (False, 0, 0.0)):
            for g in (1, 2):
                for dh in (64, 128):
                    s = 4500 if window == 4096 else 300
                    plan.append((1, s, s, 2, g, dh, causal, window, cap,
                                 dtype))
    plan += [(2, 333, 333, 3, 2, 64, True, 100, 30.0, torch.float16),
             (1, 257, 257, 2, 2, 256, True, 64, 50.0, torch.float32),
             (1, 257, 257, 2, 2, 256, True, 64, 50.0, torch.bfloat16),
             (1, 200, 350, 2, 2, 128, False, 0, 50.0, torch.bfloat16),
             (1, 8192, 8192, 16, 2, 128, True, 0, 50.0, torch.bfloat16),
             (1, 8192, 8192, 16, 2, 128, True, 4096, 50.0, torch.bfloat16)]
    plan = [case + (case[5] ** -0.5, 0) for case in plan]  # scale, pad
    # scores of std ~11 against softcap 5 (the tanh's ex2 + rcp path, not
    # its series), and rows whose stride and start TMA cannot take
    plan += [(1, 300, 300, 2, 2, 128, True, 64, 5.0, torch.bfloat16, 1.0, 0),
             (1, 300, 300, 2, 1, 64, True, 0, 50.0, torch.bfloat16, 0.125,
              4)]
    fa.reset_launches()
    for b, s, t, kh, g, dh, causal, window, cap, dtype, scale, pad in plan:
        q, k, v = inputs(b, s, t, kh, g, dh, dtype, pad)
        kw = dict(scale=scale, causal=causal, window=window, softcap=cap)
        before = fa.launches_by_variant()
        got = ops.flash_attention_gqa(q, k, v, **kw)
        torch.cuda.synchronize()
        after = fa.launches_by_variant()
        ran = [name for name in after if after[name] != before[name]]
        want_kind = ("wgmma" if dtype != torch.float32 and dh in (64, 128)
                     else "fma")
        want = flash_attention_torch(q, k, v, **kw)
        if got.dtype != dtype or got.shape != q.shape:
            raise RuntimeError(f"B8 output {got.dtype} {tuple(got.shape)}")
        want = want.float()
        diff = (got.float() - want).abs()
        err = float(diff.max())
        name = str(dtype)[6:]
        if name in FLASH_ULP:  # element by element
            over = float((diff / (FLASH_ULP[name] * want.abs()
                                  + FLASH_ATOL)).max())
        else:
            over = err / (FLASH_TOL[name] * (1 + float(want.abs().max())))
        worst = max(worst, err)
        cases.append({"shape": [b, s, kh, g, dh], "T": t, "causal": causal,
                      "window": window, "softcap": cap, "dtype": name,
                      "scale": scale, "padded_rows": pad, "variant": ran,
                      "err": err, "err_over_limit": over})
        if ran != [want_kind]:
            raise RuntimeError(f"B8 {cases[-1]}: expected the {want_kind} "
                               f"kernel")
        if not over <= 1.0:
            raise RuntimeError(f"B8 {cases[-1]}: kernel != plain")
        del q, k, v, got, want, diff
    return cases, worst, fa.launches_by_variant()


def check_bag(dev, rng, np, torch):
    """B10 vs its plain version: the reference's test shapes, D = 18 /
    L = 100, fp32/bf16/fp16 tables, sum and mean, an all-masked bag, B not
    a multiple of 8, B = 1, the served batch's [512, 100] (a bag over 8
    warps) with int32 and int64 ids, bags longer than one staged tile; at
    [512, 100] an Inf row that only masked positions touch and ids out of
    range, masked and not (NaN where the plain version has NaN). Every case
    is called twice: the two outputs must be equal bit for bit. Returns
    (cases, max_abs_err, launches)."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops

    plan = [(64, 16, 16, 4, "sum", torch.float32, torch.int32),
            (128, 32, 8, 7, "mean", torch.float32, torch.int32),
            (64, 8, 16, 3, "sum", torch.float16, torch.int32)]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for mode in ("sum", "mean"):
            plan.append((100_000, 18, 333, 100, mode, dtype, torch.int32))
    for mode in ("sum", "mean"):
        for id_dtype in (torch.int32, torch.int64):
            plan.append((100_000, 18, 512, 100, mode, torch.float32,
                         id_dtype))
        plan.append((100_000, 18, 1, 100, mode, torch.float32, torch.int32))
        plan.append((100_000, 18, 40, 300, mode, torch.float32, torch.int64))
    plan += [(1000, 18, 512, 100, mode, torch.float32, id_dtype, "nan")
             for mode in ("sum", "mean")
             for id_dtype in (torch.int32, torch.int64)]
    cases, worst = [], 0.0
    eb.reset_launches()
    for n, d, b, l, mode, dtype, id_dtype, *special in plan:
        table = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)
                                 ).to(dev, dtype)
        low = 6 if special else 0  # rows 0-5 only where placed below
        ids = torch.from_numpy(rng.integers(low, n, (b, l), dtype=np.int32)
                               ).to(dev, id_dtype)
        mask = torch.from_numpy(rng.random((b, l)) < 0.8).to(dev)
        nan_bags = []
        if special:  # an Inf row under a mask; out of range, masked or not
            table[5] = float("inf")
            ids[2, 0], mask[2, 0] = n + 3, True
            ids[3, 7], mask[3, 7] = -n - 1, False
            ids[4, 9], mask[4, 9] = 5, False
            nan_bags = [2, 3, 4]
        if b > 1:
            mask[1] = False
        got = ops.embedding_bag(table, ids, mask, mode=mode)
        again = ops.embedding_bag(table, ids, mask, mode=mode)
        torch.cuda.synchronize()
        want = eb.embedding_bag_ref(table, ids, mask, mode=mode)
        if got.dtype != torch.float32 or got.shape != (b, d):
            raise RuntimeError(f"B10 output {got.dtype} {tuple(got.shape)}")
        nan = torch.isnan(want)
        err = float((got - want).abs()[~nan].max())
        worst = max(worst, err)
        cases.append({
            "N": n, "D": d, "B": b, "L": l, "mode": mode,
            "dtype": str(dtype)[6:], "ids": str(id_dtype)[6:], "err": err,
            "nan_bags": nan_bags,
            "nan_where_plain_nan": bool(torch.equal(torch.isnan(got), nan)),
            "same_bits_twice": bool(torch.equal(got.view(torch.int32),
                                                again.view(torch.int32))),
            "all_masked_bag_is_0": b == 1 or not bool(got[1].any())})
        c = cases[-1]
        if not (err <= BAG_TOL * (1 + float(want[~nan].abs().max()))
                and c["nan_where_plain_nan"] and c["same_bits_twice"]
                and c["all_masked_bag_is_0"]
                and bool(nan.any(1).nonzero().flatten().tolist() == nan_bags)):
            raise RuntimeError(f"B10 {c}: kernel != plain")
    return cases, worst, eb.launches()


def split_device_time(rows):
    """Device ms of B8, of the GEMMs (cuBLAS kernel names) and of the
    rest, from ``kernel_rows``."""
    gemm = re.compile(r"gemm|xmma|nvjet|cutlass", re.I)
    b8 = sum(r["device_ms"] for r in rows
             if re.search(r"flash_attention(_wgmma)?_kernel", r["name"]))
    mm = sum(r["device_ms"] for r in rows
             if gemm.search(r["name"]) and "flash_attention" not in r["name"])
    busy = sum(r["device_ms"] for r in rows)
    return {"busy": busy, "flash_attention": b8, "gemm": mm,
            "other": busy - b8 - mm}


def phase_serve_lm(np, torch):
    """gemma2-27b through ``repro_torch.launch.serve``: the launcher's
    default 32-token prompt (dense attention, B8 never launched), then the
    8,192-token prompt (B8 once per layer), its last-token logits held
    against the plain route (B8's plain version) on the same weights, a
    second prefill for the steady time and a profiled one for the device
    split, and a few profiled decode steps. Returns (phase record, B8
    launches on the path)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import flash_attention_torch

    def launcher(argv):
        torch.cuda.reset_peak_memory_stats()
        run = {}
        t0 = time.perf_counter()
        rc = serve.main(argv, result=run)
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"serve.main {argv} returned {rc}")
        cfg, logits = run["cfg"], run["prefill_logits"]
        batch, prompt = run["prompts"].shape
        tokens = run["tokens"].shape[1] - 1
        if (logits.shape != (batch, cfg.vocab)
                or not bool(torch.isfinite(logits).all())
                or float(logits.abs().max()) > cfg.final_softcap):
            raise RuntimeError(f"serve {argv}: bad logits {logits.shape}")
        rec = {"argv": " ".join(argv), "seconds": seconds,
               "layers": cfg.n_layers, "d_model": cfg.d_model,
               "params": cfg.param_count(), "batch": batch,
               "prompt": prompt, "tokens": tokens,
               "prefill_ms": run["prefill_s"] * 1e3,
               "decode_ms_per_token": run["decode_s"] / tokens * 1e3,
               "tokens_per_s": batch * tokens / run["decode_s"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "first_tokens": run["tokens"][0, :8].tolist()}
        return run, rec

    fa.reset_launches()
    run, short = launcher(LM_SHORT_ARGV)
    short["flash_attention_launches"] = fa.launches()
    if short["flash_attention_launches"] != 0:
        raise RuntimeError("serve_lm: a 32-token prompt launched B8")
    del run
    torch.cuda.empty_cache()

    # ---- the main path: counters to 0, run, read
    fa.reset_launches()
    run, rec = launcher(LM_ARGV)
    b8_launches = fa.launches()
    cfg = run["cfg"]
    if b8_launches != cfg.n_layers:
        raise RuntimeError(f"serve_lm: B8 launched {b8_launches} times, "
                           f"expected one per layer ({cfg.n_layers})")
    rec["flash_attention_launches"] = b8_launches
    by_variant = fa.launches_by_variant()
    if by_variant != {"wgmma": cfg.n_layers, "fma": 0}:
        raise RuntimeError(f"serve_lm: B8 launches {by_variant}, expected "
                           f"all {cfg.n_layers} of the wgmma kernel")
    rec["flash_attention_launches_by_variant"] = by_variant
    params, prompts = run["params"], run["prompts"]
    max_len = prompts.shape[1] + rec["tokens"]
    kernel_logits = run["prefill_logits"].float()
    del run

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = tfm.forward_prefill(params, prompts, cfg,
                                            max_len=max_len)
        torch.cuda.synchronize()
        return logits.float(), (time.perf_counter() - t0) * 1e3

    again, rec["prefill_ms_again"] = prefill()
    real = ops.flash_attention_gqa
    ops.flash_attention_gqa = flash_attention_torch  # the plain route
    try:
        plain_logits, rec["plain_route_prefill_ms"] = prefill()
    finally:
        ops.flash_attention_gqa = real
    diff = kernel_logits - plain_logits
    rel = float(diff.norm() / plain_logits.norm())
    rec["kernel_vs_plain_route"] = {
        "rel_l2": rel, "tolerance": LOGITS_REL_TOL,
        "max_abs": float(diff.abs().max()),
        "argmax_equal": bool(torch.equal(kernel_logits.argmax(-1),
                                         plain_logits.argmax(-1))),
        "again_max_abs": float((again - kernel_logits).abs().max())}
    if not rel <= LOGITS_REL_TOL:
        raise RuntimeError(f"serve_lm: kernel route != plain route "
                           f"{rec['kernel_vs_plain_route']}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, window_ms = prefill()
    rows = kernel_rows(prof, torch)
    split = split_device_time(rows)
    if split["busy"] > window_ms:
        raise RuntimeError("serve_lm: device busy time exceeds the window")
    rec["profiled_prefill"] = {
        "window_ms": window_ms, "device_ms": split,
        "idle_share": 1.0 - split["busy"] / window_ms,
        "top_device_kernels": rows[:10]}
    del prof
    # decode steps timed one by one (the spread of the host clock), then a
    # few under the profiler: device time per token against the host clock,
    # and the launches one token costs
    with torch.inference_mode():
        logits, cache = tfm.forward_prefill(
            params, prompts, cfg,
            max_len=prompts.shape[1] + DECODE_STEADY + DECODE_PROFILED)
        pos = prompts.shape[1]
        per_token = []
        for i in range(DECODE_STEADY):
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = tfm.forward_decode(params, tok, pos + i, cache,
                                               cfg)
            torch.cuda.synchronize()
            per_token.append((time.perf_counter() - t0) * 1e3)
        rec["decode_steady"] = {
            "tokens": DECODE_STEADY,
            "median_ms": statistics.median(per_token),
            "min_ms": min(per_token), "max_ms": max(per_token)}
        pos += DECODE_STEADY
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(DECODE_PROFILED):
                tok = logits.argmax(-1).to(torch.int32)
                logits, cache = tfm.forward_decode(params, tok, pos + i,
                                                   cache, cfg)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof, torch)
    busy = sum(r["device_ms"] for r in rows)
    rec["profiled_decode"] = {
        "tokens": DECODE_PROFILED,
        "window_ms_per_token": window_ms / DECODE_PROFILED,
        "device_ms_per_token": busy / DECODE_PROFILED,
        "launches_per_token": sum(r["calls"] for r in rows) / DECODE_PROFILED,
        "idle_share": 1.0 - busy / window_ms,
        "top_device_kernels": rows[:6]}
    del params, prompts, prof, cache, logits
    torch.cuda.empty_cache()
    return {"phase": "serve_lm", **rec, "dense_prompt_run": short}, \
        b8_launches


def moe_region_ms(run, torch):
    """``run()`` with CUDA events around each MoE step (``moe_route``,
    ``moe_dispatch``, the token gather, the expert GEMMs, the combine) on
    the current stream, no sync inside: (device ms from each step's first
    launch to its last, summed over its calls; calls; host-clock window
    ms, ending in ``synchronize``)."""
    from repro_torch.models import moe

    steps = {"route": "moe_route", "dispatch_tables": "moe_dispatch",
             "dispatch_gather": "_gather_tokens", "expert_gemms": "_experts",
             "combine": "_combine"}
    real = {k: getattr(moe, name) for k, name in steps.items()}
    marks = {k: [] for k in steps}

    def timed(key):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[key](*a, **kw)
            stop.record()
            marks[key].append((start, stop))
            return out
        return call

    for key, name in steps.items():
        setattr(moe, name, timed(key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for key, name in steps.items():
            setattr(moe, name, real[key])
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    return ms, {k: len(v) for k, v in marks.items()}, window_ms, out


def numpy_dispatch(probs, k, c, np):
    """A numpy mirror of the reference's routing and dispatch
    (``src/repro/models/moe.py:59-86``) from the router's fp32
    probabilities ``[T, E]``: top k by a stable sort (the lower index
    first among ties), gates renormalised by a left-to-right sum, then the
    tables. Returns a dict of numpy arrays."""
    t, e = probs.shape
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k].astype(np.int32)
    vals = np.take_along_axis(probs, ids, -1)
    total = vals[:, :1].copy()
    for j in range(1, k):
        total = total + vals[:, j:j + 1]
    gates = vals / np.maximum(total, np.float32(1e-9))
    flat_e = ids.reshape(-1)
    order = np.argsort(flat_e, kind="stable").astype(np.int32)
    sorted_e = flat_e[order]
    counts = np.bincount(sorted_e, minlength=e).astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    pos = np.arange(t * k, dtype=np.int32) - starts[sorted_e]
    keep = pos < c
    slot = np.where(keep, sorted_e * c + pos, e * c).astype(np.int32)
    tok = (order // k).astype(np.int32)
    disp_tok = np.full(e * c + 1, t, np.int32)
    disp_tok[slot] = np.where(keep, tok, t)
    disp_gate = np.zeros(e * c + 1, np.float32)
    disp_gate[slot] = np.where(keep, gates.reshape(-1)[order], 0.0)
    return {"expert_ids": ids, "gates": gates.astype(np.float32),
            "keep": keep, "slot": slot, "disp_tok": disp_tok,
            "disp_gate": disp_gate}


def check_moe_layer(dev, np, torch, cfg):
    """One MoE layer of ``cfg`` (its published width) on a seeded
    ``[8,192, d]`` bf16 input: the port's expert ids, ``keep``, ``slot``,
    ``disp_tok`` and ``disp_gate`` bit-equal to ``numpy_dispatch`` on the
    host from the same probabilities; its output against a plain fp32
    formulation on the card (each expert's kept tokens through its SwiGLU
    in fp32, times their gates, summed) within ``MOE_REL_TOL``; two calls
    bit-equal; its time by CUDA events and by step; the drops of
    ``MOE_DROP_STEPS`` decode steps of ``MOE_DECODE_BATCH`` tokens."""
    from repro_torch.models import moe
    from repro_torch.obs.timing import min_ms

    e, k, d, f = cfg.moe_experts, cfg.moe_top_k, cfg.d_model, cfg.d_ff
    t = 8192
    gen = torch.Generator(dev).manual_seed(7)
    p = moe.moe_init(gen, d, f, e, cfg.dtype)
    x = torch.randn((t, d), generator=gen, device=dev).to(cfg.dtype)
    c = moe.capacity(cfg.moe_capacity, t, k, e)
    with torch.inference_mode():
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        gates, ids = moe.top_k_gates(probs, k)
        tables = moe.moe_dispatch(ids.reshape(-1), gates, n_local=e, c=c,
                                  k=k)
        y = moe.moe_apply(p, x, n_experts=e, top_k=k,
                          capacity_factor=cfg.moe_capacity)
        again = moe.moe_apply(p, x, n_experts=e, top_k=k,
                              capacity_factor=cfg.moe_capacity)
    host = numpy_dispatch(probs.cpu().numpy(), k, c, np)
    got = {"expert_ids": ids, "gates": gates, "keep": tables["keep"],
           "slot": tables["slot"], "disp_tok": tables["disp_tok"],
           "disp_gate": tables["disp_gate"]}
    unequal = [name for name, want in host.items()
               if not (got[name].cpu().numpy().dtype == want.dtype
                       and np.array_equal(got[name].cpu().numpy(), want))]
    if unequal:
        raise RuntimeError(f"serve_moe: tables {unequal} differ from the "
                           f"host mirror")
    if not torch.equal(y.view(torch.int16), again.view(torch.int16)):
        raise RuntimeError("serve_moe: two calls of the MoE layer differ")
    # the plain formulation, from the host mirror's tables, in fp32
    disp_tok = torch.from_numpy(host["disp_tok"][:e * c]).to(dev).long()
    disp_gate = torch.from_numpy(host["disp_gate"][:e * c]).to(dev)
    plain = torch.zeros((t, d), dtype=torch.float32, device=dev)
    xf = x.float()
    with torch.inference_mode():
        for ex in range(e):
            rows = disp_tok[ex * c:(ex + 1) * c]
            live = rows < t
            toks, g = rows[live], disp_gate[ex * c:(ex + 1) * c][live]
            h = xf[toks]
            h = (torch.nn.functional.silu(h @ p["w_gate"][ex].float())
                 * (h @ p["w_up"][ex].float())) @ p["w_down"][ex].float()
            plain.index_add_(0, toks, h * g[:, None])
    diff = y.float() - plain
    rel = float(diff.norm() / plain.norm())
    if not rel <= MOE_REL_TOL:
        raise RuntimeError(f"serve_moe: the MoE layer is {rel} from the "
                           f"plain formulation (tolerance {MOE_REL_TOL})")

    def layer():
        with torch.inference_mode():
            moe.moe_apply(p, x, n_experts=e, top_k=k,
                          capacity_factor=cfg.moe_capacity)

    layer_ms = min_ms(layer, reps=10, warmup=2)
    steps_ms, calls, window_ms, _ = moe_region_ms(layer, torch)
    # decode at the launcher's default batch: MOE_DECODE_BATCH tokens a step
    n = MOE_DECODE_BATCH
    c_dec = moe.capacity(cfg.moe_capacity, n, k, e)
    with torch.inference_mode():
        _, dec_ids = moe.moe_route(p["router"], x[:n * MOE_DROP_STEPS], k)
    counts = np.stack([np.bincount(step.reshape(-1), minlength=e)
                       for step in dec_ids.cpu().numpy().reshape(
                           MOE_DROP_STEPS, n, k)])
    dropped = np.maximum(counts - c_dec, 0).sum(1)
    kept = host["keep"]
    flops = 2.0 * 3 * e * c * d * f
    return {"shape": [t, d], "experts": e, "top_k": k, "capacity": c,
            "slots": e * c, "assignments": t * k,
            "dropped_assignments": int((~kept).sum()),
            "tables_bit_equal_to_host_mirror": list(host),
            "plain_rel_l2": rel, "tolerance": MOE_REL_TOL,
            "max_abs_err": float(diff.abs().max()),
            "two_calls_bit_equal": True, "ms": layer_ms,
            "expert_gemm_tflops_per_s": flops / (steps_ms["expert_gemms"]
                                                 / calls["expert_gemms"])
            / 1e9,
            "steps_device_ms": steps_ms, "steps_window_ms": window_ms,
            "decode_drops": {
                "batch": n, "capacity": c_dec, "steps": MOE_DROP_STEPS,
                "assignments_a_step": n * k,
                "dropped_a_step": dropped.tolist(),
                "dropped_share": float(dropped.sum()
                                       / (MOE_DROP_STEPS * n * k))}}


def phase_serve_moe(dev, np, torch):
    """MoE serving on the card: (a) moonshot-v1-16b-a3b at its published
    config through ``repro_torch.launch.serve`` (``MOE_ARGV``: B8 once a
    layer, all of the wgmma kernel; finite last-token logits), a second
    prefill split by MoE step (``moe_region_ms``), a profiled one split by
    kernel (B8, GEMMs, the rest; idle share) and 4 profiled decode steps;
    (b) its MoE layer alone (``check_moe_layer``); (c) phi3.5-moe at its
    published width cut to ``PHI_LAYERS`` layers, prefill 8,192 x 1 and 16
    decode tokens (B8 once a layer). Each model is freed before the next is
    drawn. Returns (phase record, B8 launches by run)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.train import train_loop as tl

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("serve_moe: the fp32 router must not run in TF32")
    rec = {"phase": "serve_moe"}
    launches = {}

    # ---- (a) the main path: counters to 0, the launcher, read
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = {}
    t0 = time.perf_counter()
    if serve.main(MOE_ARGV, result=run) != 0:
        raise RuntimeError(f"serve.main {MOE_ARGV} failed")
    seconds = time.perf_counter() - t0
    cfg = run["cfg"]
    b8 = fa.launches()
    by_variant = fa.launches_by_variant()
    if b8 != cfg.n_layers or by_variant != {"wgmma": cfg.n_layers, "fma": 0}:
        raise RuntimeError(f"serve_moe: B8 launches {by_variant}, expected "
                           f"all {cfg.n_layers} of the wgmma kernel")
    launches[cfg.name] = b8
    params, prompts = run["params"], run["prompts"]
    logits = run["prefill_logits"]
    batch, prompt = prompts.shape
    tokens = run["tokens"].shape[1] - 1
    if (logits.shape != (batch, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"serve_moe: bad logits {logits.shape}")
    moon = {"argv": " ".join(MOE_ARGV), "seconds": seconds,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": str(cfg.dtype),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "batch": batch, "prompt": prompt, "tokens": tokens,
            "prefill_ms": run["prefill_s"] * 1e3,
            "decode_ms_per_token": run["decode_s"] / tokens * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "flash_attention_launches": b8,
            "flash_attention_launches_by_variant": by_variant,
            "first_tokens": run["tokens"][0, :8].tolist()}
    del run, logits

    n_prof = DECODE_PROFILED

    def prefill():
        with torch.inference_mode():
            return tfm.forward_prefill(params, prompts, cfg,
                                       max_len=prompt + n_prof)

    steps_ms, calls, window_ms, (last, cache) = moe_region_ms(prefill, torch)
    moon["prefill_ms_again"] = window_ms
    moon["prefill_moe_steps"] = {"device_ms": steps_ms, "calls": calls,
                                 "window_ms": window_ms}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof, torch)
    split = split_device_time(rows)
    if split["busy"] > window_ms:
        raise RuntimeError("serve_moe: device busy time exceeds the window")
    moon["profiled_prefill"] = {
        "window_ms": window_ms, "device_ms": split,
        "idle_share": 1.0 - split["busy"] / window_ms,
        "top_device_kernels": rows[:12]}
    del prof
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n_prof):
                tok = last.argmax(-1).to(torch.int32)
                last, cache = tfm.forward_decode(params, tok, prompt + i,
                                                 cache, cfg)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof, torch)
    busy = sum(r["device_ms"] for r in rows)
    moon["profiled_decode"] = {
        "tokens": n_prof, "window_ms_per_token": window_ms / n_prof,
        "device_ms_per_token": busy / n_prof,
        "device_gemm_ms_per_token": split_device_time(rows)["gemm"] / n_prof,
        "launches_per_token": sum(r["calls"] for r in rows) / n_prof,
        "idle_share": 1.0 - busy / window_ms,
        "top_device_kernels": rows[:6]}
    rec["moonshot"] = moon
    del params, prompts, last, cache, prof
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) one published MoE layer alone
    rec["moe_layer"] = check_moe_layer(dev, np, torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) phi3.5-moe at its published width, depth cut
    full = get_arch(PHI_ARCH).config()
    pcfg = dataclasses.replace(full, n_layers=PHI_LAYERS)
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(pcfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = 16
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, pcfg.vocab, size=(1, 8192)).astype(np.int32)).to(dev)
    prefill = tl.make_lm_prefill_step(pcfg, max_len=8192 + tokens)
    decode = tl.make_lm_decode_step(pcfg)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompts)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("serve_moe: phi3.5 logits not finite")
        t0 = time.perf_counter()
        for i in range(tokens):
            tok = logits.argmax(-1).to(torch.int32)
            logits, cache = decode(params, tok, 8192 + i, cache)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / tokens
    b8 = fa.launches()
    by_variant = fa.launches_by_variant()
    if by_variant != {"wgmma": pcfg.n_layers, "fma": 0}:
        raise RuntimeError(f"serve_moe: phi3.5 B8 launches {by_variant}")
    launches[f"{PHI_ARCH} ({PHI_LAYERS} layers)"] = b8
    rec["phi35"] = {
        "layers": pcfg.n_layers, "layers_published": full.n_layers,
        "reduced": f"depth {full.n_layers} -> {pcfg.n_layers} layers: "
                   f"{full.param_count() * 2 / 1e9:.1f} GB of bf16 weights "
                   f"at 32, more than the card holds",
        "d_model": pcfg.d_model, "experts": pcfg.moe_experts,
        "top_k": pcfg.moe_top_k, "d_ff": pcfg.d_ff,
        "params": pcfg.param_count(), "init_s": init_s,
        "batch": 1, "prompt": 8192, "tokens": tokens,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "flash_attention_launches": b8,
        "flash_attention_launches_by_variant": by_variant}
    del params, prompts, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    rec["flash_attention_launches"] = launches
    rec["matmul_allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    return rec, launches


def phase_serve_din(np, torch):
    """DIN at the full config through ``repro_torch.launch.serve`` (512
    requests), then ``bag_fixed`` on the served batch's history ids through
    B10, held against its plain version. Returns (phase record, B10
    launches on the path, the item table and the served batch's history ids
    and mask for the timing)."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.launch import serve
    from repro_torch.models.recsys import din, embedding
    from repro_torch.train import train_loop as tl

    eb.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    run = {}
    t0 = time.perf_counter()
    rc = serve.main(DIN_ARGV, result=run)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"serve.main {DIN_ARGV} returned {rc}")
    cfg, table = run["cfg"], run["params"]["item_table"]
    batch = run["batches"][0]
    pooled = {mode: embedding.bag_fixed(table, batch["hist_items"],
                                        batch["hist_mask"], mode=mode)
              for mode in ("sum", "mean")}
    torch.cuda.synchronize()
    b10_launches = eb.launches()
    if b10_launches <= 0:
        raise RuntimeError("serve_din: B10 was never launched")
    errs = {}
    for mode, got in pooled.items():
        want = eb.embedding_bag_ref(table, batch["hist_items"],
                                    batch["hist_mask"], mode=mode)
        errs[mode] = float((got - want).abs().max())
        if not errs[mode] <= BAG_TOL * (1 + float(want.abs().max())):
            raise RuntimeError(f"serve_din: B10 != plain ({mode})")
    n_req = run["probs"][0].shape[0]
    for p in run["probs"]:
        if p.shape != (n_req,) or not bool(((p >= 0) & (p <= 1)).all()):
            raise RuntimeError("serve_din: probabilities outside [0, 1]")
    rec = {"phase": "serve_din", "argv": " ".join(DIN_ARGV),
           "seconds": seconds, "requests": n_req,
           "n_items": cfg.n_items, "embed_dim": cfg.embed_dim,
           "item_table_bytes": table.numel() * table.element_size(),
           "ms_per_batch": run["batch_s"] * 1e3,
           "requests_per_s": n_req / run["batch_s"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "steady": din_steady(run, din, tl, torch),
           "mean_ctr": float(torch.stack(run["probs"]).mean()),
           "bag_fixed": {"ids": list(batch["hist_items"].shape),
                         "launches": b10_launches, "err": errs,
                         "tolerance": BAG_TOL}}
    return rec, b10_launches, table, (batch["hist_items"],
                                      batch["hist_mask"])


def din_steady(run, din, tl, torch):
    """The launcher's DIN step over its device batches, ``DIN_STEADY``
    times, each call timed alone (host clock, synchronised): the spread of
    ms per batch."""
    step = tl.make_recsys_serve_step(din.apply, run["cfg"])
    batches = run["batches"]
    ms = []
    with torch.inference_mode():
        for i in range(DIN_STEADY):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(run["params"], batches[i % len(batches)])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    n_req = batches[0]["hist_items"].shape[0]
    med = statistics.median(ms)
    return {"batches": DIN_STEADY, "median_ms": med, "min_ms": ms[0],
            "p99_ms": ms[int(0.99 * (len(ms) - 1))], "max_ms": ms[-1],
            "requests_per_s_at_median": n_req / med * 1e3}


def time_flash(np, torch):
    """B8 at gemma2-27b's prefill layer shape, bf16, softcap 50: the wgmma
    kernel (the main path's), the FMA kernel at the same shape, the plain
    version, the bound and the special-function count beside it (one exp2
    a live score; three if the softcap's tanh took the ex2 + rcp path); the
    wgmma kernel in both row layouts (query groups paired in a block, as
    dispatched, and 128 positions of one head), and for two seconds back
    to back with the card's clock and power sampled. Then the library yardstick
    ``F.scaled_dot_product_attention``, which has no softcap, beside the
    wgmma kernel at softcap 0: causal with GQA for the global layer; for
    the local layer the causal window as a boolean mask, K/V repeated to the
    query heads beforehand (outside the clock)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.attention import flash_attention_torch

    s, kh, g, dh = 8192, 16, 2, 128
    scale = 144 ** -0.5  # gemma2-27b's query scale
    gen = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((1, s, kh, g, dh), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, s, kh, dh), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, s, kh, dh), generator=gen, device="cuda").bfloat16()
    out = {}
    for layer, window in (("global", 0), ("local", 4096)):
        kw = dict(scale=scale, causal=True, window=window, softcap=50.0)
        ms = min_ms(lambda: ops.flash_attention_gqa(q, k, v, **kw), reps=5,
                    warmup=1)
        fma_ms = min_ms(lambda: fa._launch("fma", q, k, v, torch.empty_like(q),
                                           last=1, **kw), reps=2, warmup=1)
        plain = cuda_ms(lambda: flash_attention_torch(q, k, v, **kw),
                        reps=1, warmup=1)
        flops, nbytes = attention_work(s, s, kh, g, dh, True, window, 2)
        pairs = flops / (4 * dh)
        bnd, by = bound_ms(nbytes, 0.0)
        f_ms = flops / BF16_FLOPS_PER_S * 1e3
        if f_ms > bnd:
            bnd, by = f_ms, "operations"
        out[layer] = {"shape": [1, s, kh, g, dh], "window": window,
                      "softcap": 50.0, "ms": ms, "fma_ms": fma_ms,
                      "plain_ms": plain, "flop": flops, "bytes": nbytes,
                      "bound_ms": bnd, "bound_by": by,
                      "share_of_bound": bnd / ms,
                      "tflops": flops / ms / 1e9,
                      "tflops_executed": 1.5 * flops / ms / 1e9,  # hi + lo P V
                      "sfu_ops": pairs,
                      "sfu_ms": pairs / SFU_OPS_PER_S * 1e3,
                      "sfu_ops_tanh_on_sfu": 3 * pairs,
                      "sfu_ms_tanh_on_sfu": 3 * pairs / SFU_OPS_PER_S * 1e3}
    kw = dict(scale=scale, causal=True, window=0, softcap=50.0)
    out["global"]["layouts_ms"] = {
        name: min_ms(lambda: fa._launch("wgmma", q, k, v, torch.empty_like(q),
                                        last=pack, **kw), reps=5, warmup=1)
        for name, pack in (("groups_paired", 1), ("positions_stacked", 0))}
    kw0 = dict(scale=scale, causal=True, window=0, softcap=0.0)
    out["global"]["softcap0_ms"] = min_ms(
        lambda: ops.flash_attention_gqa(q, k, v, **kw0), reps=5, warmup=1)
    out["global"]["sustained"] = {
        f"softcap_{cap:g}": sustained(lambda: ops.flash_attention_gqa(
            q, k, v, **{**kw, "softcap": cap}), torch)
        for cap in (50.0, 0.0)}
    qh = q.reshape(1, s, kh * g, dh).transpose(1, 2)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    lib = min_ms(lambda: F.scaled_dot_product_attention(
        qh, kt, vt, is_causal=True, scale=scale, enable_gqa=True),
        reps=5, warmup=1)
    out["global"]["library_ms"] = lib
    i = torch.arange(s, device="cuda")
    live = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 4096)
    kr, vr = kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1)
    out["local"]["library_ms"] = min_ms(
        lambda: F.scaled_dot_product_attention(
            qh, kr, vr, attn_mask=live, scale=scale),
        reps=5, warmup=1)
    out["library_call"] = (
        "F.scaled_dot_product_attention, softcap 0: global is_causal=True, "
        "enable_gqa=True (beside the wgmma kernel's softcap0_ms); local "
        "attn_mask = causal & window 4,096 (bool), K/V repeated to 32 heads "
        "first")
    return out


def segsum_ids(kind, e, n, rng, np):
    """Segment ids for B9's checks: ``sorted`` (uniform), ``mace`` (each
    graph's 64 edges among its 30 nodes, sorted, as mace x molecule draws
    them), ``readout`` (30 nodes a graph), ``padded`` (a tail of id N),
    ``negative``, ``unsorted``, ``int64``, ``one_segment`` and ``zipf``
    (segment sizes ~ Zipf(1.5), sorted)."""
    if kind == "one_segment":
        seg = np.ones(e, np.int64)
    elif kind == "zipf":
        seg = np.sort((rng.zipf(1.5, e) - 1) % n)
    elif kind == "mace":
        seg = np.sort(np.arange(e) // 64 * 30 + rng.integers(0, 30, e))
    elif kind == "readout":
        seg = np.arange(e) // 30
    else:
        seg = np.sort(rng.integers(0, n, e))
    if kind == "padded":
        seg[-e // 4:] = n
    elif kind == "negative":
        seg[: e // 3] = -1 - rng.integers(0, 3, e // 3)
    elif kind == "unsorted":
        seg = rng.permutation(seg)
    return seg.astype(np.int64 if kind == "int64" else np.int32)


def check_segment_sum(dev, rng, np, torch):
    """B9 vs its plain version, element by element at SEGSUM_TOL: the
    reference's test shapes, D in {1, 3, 64, 100, 128} (every load width),
    E in {0, 1, 777}, a padding tail of id N, negative and unsorted ids,
    int64 ids; the GNN paths' shapes (MACE's l = 2, 1, 0 paths and
    readout, gat-cora's messages and denominator); the geometry's switches
    just below and above (one lane group a warp at D = 68 against two at
    64, one row piece at D = 128 against two at 132, steps just under and
    over MAX_STEPS); one segment over 10^6 edges and Zipf segment sizes
    with values on a 2^-10 grid (their sums are exact in fp32 in any
    order, so the plain version's own atomics cannot blur the check).
    Returns (cases, max_abs_err, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum_sorted as ss

    plan = [(512, 16, 64, "sorted"), (1024, 64, 200, "sorted")]
    for d in (1, 3, 64, 100, 128):
        for e in (0, 1, 777):
            plan.append((e, d, 300, "sorted"))
    plan += [(777, 64, 50, "padded"), (777, 100, 50, "negative"),
             (777, 3, 50, "unsorted"), (777, 64, 50, "int64"),
             (8_192, 640, 3_840, "mace"), (8_192, 384, 3_840, "mace"),
             (8_192, 128, 3_840, "mace"), (3_840, 1, 128, "readout"),
             (10_556, 64, 2_708, "sorted"), (10_556, 8, 2_708, "sorted"),
             (8_192, 640, 3_840, "unsorted"), (8_192, 8, 2_708, "negative"),
             (8_192, 64, 3_840, "sorted"), (8_192, 68, 3_840, "sorted"),
             (8_192, 128, 3_840, "padded"), (8_192, 132, 3_840, "sorted")]
    cap = ss.MAX_STEPS * 132 * ss.FILL_WARPS_PER_SM  # steps reach the cap
    plan += [(cap - 4_224, 128, cap // 8, "sorted"),
             (cap + 1, 128, cap // 8, "sorted"),
             (1_000_000, 64, 3, "one_segment"),
             (2_000_000, 64, 100_000, "zipf")]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, worst = [], 0.0
    ss.reset_launches()
    for e, d, n, kind in plan:
        seg = segsum_ids(kind, e, n, rng, np)
        vals = rng.standard_normal((e, d), dtype=np.float32)
        if kind in ("one_segment", "zipf"):
            vals = np.round(vals * 1024) / 1024
        v = torch.from_numpy(vals).to(dev)
        s = torch.from_numpy(seg).to(dev)
        got = ops.segment_sum_sorted(v, s, num_segments=n)
        torch.cuda.synchronize()
        want = ss.segment_sum_sorted_ref(v, s, num_segments=n)
        if got.dtype != torch.float32 or got.shape != (n, d):
            raise RuntimeError(f"B9 output {got.dtype} {tuple(got.shape)}")
        diff = (got - want).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        over = (float((diff / (SEGSUM_TOL * (1 + want.abs()))).max())
                if diff.numel() else 0.0)
        worst = max(worst, err)
        geo = ss.geometry(e, d, n, n_sm, v.data_ptr())
        cases.append({"E": e, "D": d, "N": n, "ids": kind, "err": err,
                      "err_over_limit": over,
                      "geometry": dataclasses.asdict(geo),
                      "largest_segment": int(np.bincount(
                          seg[(seg >= 0) & (seg < n)].astype(np.int64),
                          minlength=1).max()) if e else 0})
        if not over <= 1.0:
            raise RuntimeError(f"B9 {cases[-1]}: kernel != plain")
        del v, s, got, want, diff
    return cases, worst, ss.launches()


def gnn_cell_batch(arch_id, shape_id, dev, torch):
    """(cfg, batch on the card) for one (arch, shape) cell: the published
    config adapted by ``_adapt_cfg`` to the shape, and a batch of
    ``cell_shapes``' shapes and dtypes drawn on the card from a seeded
    generator with ``make_smoke_batch``'s structure. Node classification:
    uniform src/dst, edge_mask = rand < 0.9, normal features, uniform
    labels, every label and node unmasked. MACE's batched graphs:
    ``graph_ids = arange(n) // nodes_per_graph``, each graph's edges drawn
    among its own nodes, edge_mask = rand < 0.9, standard normal positions,
    species uniform in [0, n_species), normal fp32 energy labels."""
    from repro_torch.configs.inputs import _adapt_cfg, cell_shapes
    from repro_torch.configs.registry import get_arch

    arch = get_arch(arch_id)
    shape = arch.shapes[shape_id]
    cfg = _adapt_cfg(arch, arch.config(), shape_id, shape)
    spec = cell_shapes(arch, arch.config(), shape)
    n = spec["node_mask"][0][0]
    e = spec["edge_src"][0][0]
    gen = torch.Generator(dev).manual_seed(0)

    def ints(lo, hi, size):
        return torch.randint(lo, hi, size, generator=gen, device=dev,
                             dtype=torch.int32)

    def edges(hi, first=None):  # src, dst, mask: drawn in this order
        out = {"edge_src": ints(0, hi, (e,)), "edge_dst": ints(0, hi, (e,)),
               "edge_mask": torch.rand((e,), generator=gen, device=dev) < 0.9,
               "node_mask": torch.ones((n,), dtype=torch.bool, device=dev)}
        if first is not None:  # each edge among its own graph's nodes
            out["edge_src"] += first
            out["edge_dst"] += first
        return out

    if set(spec) == {"edge_src", "edge_dst", "edge_mask", "node_mask",
                     "node_feat", "labels", "label_mask"}:
        batch = {
            **edges(n),
            "node_feat": torch.randn(spec["node_feat"][0], generator=gen,
                                     device=dev),
            "labels": ints(0, cfg.n_classes, (n,)),
            "label_mask": torch.ones((n,), dtype=torch.bool, device=dev),
        }
    elif set(spec) == {"edge_src", "edge_dst", "edge_mask", "node_mask",
                       "node_feat", "positions", "graph_ids", "labels"}:
        g, per = shape.nodes_per_graph, shape.edges_per_graph
        first = (torch.arange(e, device=dev, dtype=torch.int32) // per) * g
        batch = {
            **edges(g, first),
            "node_feat": ints(0, cfg.n_species, (n,)),
            "positions": torch.randn((n, 3), generator=gen, device=dev),
            "graph_ids": torch.arange(n, device=dev, dtype=torch.int32) // g,
            "labels": torch.randn(spec["labels"][0], generator=gen,
                                  device=dev),
        }
    else:
        raise RuntimeError(f"{arch_id} x {shape_id}: inputs {sorted(spec)}")
    for k, (sh, dt) in spec.items():
        if tuple(batch[k].shape) != tuple(sh) or batch[k].dtype != dt:
            raise RuntimeError(f"{arch_id} x {shape_id}: {k} "
                               f"{batch[k].dtype} {tuple(batch[k].shape)}")
    return cfg, batch


def energy_rotation(cfg, params, batch, dev, np, torch):
    """MACE's graph energies at the batch's positions and at the positions
    rotated by a seeded rotation, on the kernel route: the largest change
    of a graph's energy relative to the largest |energy|; fails above
    ROTATION_RTOL."""
    from repro_torch.models.gnn import mace

    q, r = np.linalg.qr(np.random.default_rng(8).normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rot = torch.as_tensor(q, dtype=torch.float32, device=dev)
    with torch.no_grad():
        _, e = mace.apply(params, batch, cfg)
        _, e_rot = mace.apply(params, dict(
            batch, positions=batch["positions"] @ rot.T), cfg)
    rel = float((e_rot - e).abs().max() / e.abs().max())
    out = {"graphs": int(e.shape[0]), "max_abs_energy": float(e.abs().max()),
           "max_abs_change": float((e_rot - e).abs().max()),
           "rel_err": rel, "tolerance": ROTATION_RTOL,
           "finite": bool(torch.isfinite(e).all() and
                          torch.isfinite(e_rot).all())}
    if not (out["finite"] and rel <= ROTATION_RTOL):
        raise RuntimeError(f"mace: energy not rotation invariant {out}")
    return out


# the kinds of device time of a train step (``profiled_step``), matched in
# order: a GNN step's B9, the gathers (``x[src]`` and B9's backward
# ``index_select``), the scatters of the gathers' backward (``index_put_``
# with accumulate: its sort and its kernel), the GEMMs (cuBLAS's batched
# GEMV kernels of MACE's small contractions among them); an LM or DIN
# step's GEMMs, softmax, the table gradient's scatter, gathers, reductions
# and elementwise kernels
GNN_KINDS = (
    ("segment_sum_sorted", r"segment_sum_kernel"),
    ("gather_backward_scatter", r"indexing_backward|index_put|scatter"
                                r"|indexFunc|index_add|RadixSort"
                                r"|radix_sort|cub::"),
    ("gather", r"index_elementwise|gather|indexSelect|index_select"),
    ("gemm", r"gemm|gemv|xmma|nvjet|cutlass"))
TRAIN_KINDS = (
    ("gemm", r"gemm|gemv|xmma|nvjet|cutlass"),
    ("softmax", r"softmax"),
    ("embedding_backward", r"indexing_backward|index_put|RadixSort"
                           r"|radix_sort|cub::|sort"),
    ("gather", r"index_elementwise|gather|indexSelect|index_select"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise|vectorized"))


def train_cell(arch_id, shape_id, dev, np, torch, batch=None, cell=None):
    """One (arch, shape) cell through the launcher's own wiring
    (``launch.train.wire_gnn``: the batch's edges sorted once, each stream
    of a hub-split batch by its own destinations, the launcher's optimizer
    and step), ``TrainRunner`` for TRAIN_STEPS steps (the first a
    warm-up); then one profiled step (and, for MACE, the energies'
    rotation invariance, ``energy_rotation``); then the same steps on the
    plain route from the same start; for ``B9_TURN_CELLS``, with the
    parent's B9 in ``build/parent/``, the kernel route's steps again with
    this B9 and with the parent's, in turns. ``batch`` is (cfg, batch on
    the card), ``gnn_cell_batch``'s by default; ``cell`` names it in
    ``B9_PER_STEP`` (the shape by default). Returns (record, B9 launches
    of the kernel route's steps)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum_sorted as ss
    from repro_torch.launch.train import wire_gnn

    t0 = time.perf_counter()
    cfg, raw = (gnn_cell_batch(arch_id, shape_id, dev, torch)
                if batch is None else batch)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    cell = cell or shape_id
    dst_keys = [k for k in ("edge_dst", "edge_dst_cold", "edge_dst_hot")
                if k in raw]
    mask_keys = [k.replace("dst", "mask") for k in dst_keys]
    wire_s = {}

    def run(route, steps=TRAIN_STEPS):
        t0 = time.perf_counter()
        params, optim, step, data_fn = wire_gnn(arch_id, cfg, raw, 0, dev)
        torch.cuda.synchronize()
        wire_s[route] = time.perf_counter() - t0
        for k in dst_keys:
            dst = data_fn(0)[k]
            if not bool((dst[1:] >= dst[:-1]).all()):
                raise RuntimeError(f"{arch_id}: {k} not sorted")
        gid = data_fn(0).get("graph_ids")
        if gid is not None and not bool((gid[1:] >= gid[:-1]).all()):
            raise RuntimeError(f"{arch_id}: graph_ids not nondecreasing")
        ss.reset_launches()
        rec, params, opt_state = timed_steps(
            step, data_fn, params, optim.init(params), steps, np, torch,
            f"{arch_id} {route}")
        rec.update(route=route, segment_sum_sorted_launches=ss.launches(),
                   edges_per_s=n_edges / rec["ms_per_step_median"] * 1e3)
        return rec, params, opt_state, step, data_fn(0)

    n_nodes = raw["node_feat"].shape[0]
    n_edges = sum(raw[k].shape[0] for k in dst_keys)
    kernel, params, opt_state, step, batch = run("kernel")
    want = B9_PER_STEP[(arch_id, cell)] * TRAIN_STEPS
    if kernel["segment_sum_sorted_launches"] != want:
        raise RuntimeError(f"{arch_id} x {cell}: B9 launched "
                           f"{kernel['segment_sum_sorted_launches']} times "
                           f"in {TRAIN_STEPS} steps, expected {want}")
    rec = {"arch": arch_id, "shape": shape_id, "cell": cell,
           "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                      if k != "dtype"},
           "nodes": n_nodes, "edges": n_edges,
           "unmasked_edges": sum(int(batch[k].sum()) for k in mask_keys),
           "batch_gen_s": gen_s, "wire_s": wire_s,
           "b9_launches_per_step": kernel["segment_sum_sorted_launches"]
           / TRAIN_STEPS, "kernel_route": kernel}
    rec["profiled_step"], params, opt_state = profiled_step(
        step, params, opt_state, batch, GNN_KINDS, torch)
    if "positions" in batch:  # MACE: its energies, at full width
        rec["energy_rotation"] = energy_rotation(cfg, params, batch, dev, np,
                                                 torch)
    del params, opt_state, step, batch
    real = ops.segment_sum_sorted
    ops.segment_sum_sorted = ss.segment_sum_sorted_ref  # the plain route
    try:
        plain, p_params, p_state, _, _ = run("plain")
    finally:
        ops.segment_sum_sorted = real
    del p_params, p_state
    if plain["segment_sum_sorted_launches"] != 0:
        raise RuntimeError(f"{arch_id}: the plain route launched B9")
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(kernel["losses"], plain["losses"])]
    rec["plain_route"] = plain
    rec["kernel_vs_plain_route"] = {"loss_rel_err": rel,
                                    "tolerance": TRAIN_LOSS_RTOL}
    if not max(rel) <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"{arch_id} x {cell}: kernel route != plain "
                           f"route {rel}")
    parent = parent_segment_sum()
    if parent is not None and (arch_id, shape_id) in B9_TURN_CELLS:
        # the step with this B9 and with the parent's (its wrapper and
        # kernel) in turns, twice: this, parent, parent, this
        turns = {"this": [], "parent": []}
        for who in ("this", "parent", "parent", "this") * 2:
            ops.segment_sum_sorted = parent if who == "parent" else real
            try:
                r, t_params, t_state, _, _ = run(f"{who}_in_turns",
                                                 B9_TURN_STEPS)
            finally:
                ops.segment_sum_sorted = real
            turns[who].append(r["ms_per_step_median"])
            del t_params, t_state
        rec["b9_in_turns_ms_per_step"] = turns
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    return rec, kernel["segment_sum_sorted_launches"]


def phase_train_gnn(dev, np, torch):
    """The training path: ``repro_torch.launch.train.main`` on the four GNN
    archs (the reference's smoke batch, TRAIN_LAUNCHER_STEPS steps), then
    the TRAIN_CELLS at full width (``train_cell``), then GAT's hub split at
    ogb_products' nodes (``hub_split_cells``). Returns (phase record, B9
    launches on the path)."""
    from repro_torch.kernels import segment_sum_sorted as ss

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("train_gnn: fp32 GEMMs must not run in TF32")
    rec = {"phase": "train_gnn",
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "launcher": {}, "cells": []}
    launches = 0
    for arch in TRAIN_ARCHS:
        argv = ["--arch", arch, "--steps", str(TRAIN_LAUNCHER_STEPS)]
        ss.reset_launches()
        summary = launcher_run(argv, np, torch)
        n = ss.launches()
        want = B9_PER_STEP[(arch, "smoke")] * TRAIN_LAUNCHER_STEPS
        if n != want:
            raise RuntimeError(f"train.main {argv}: B9 launched {n} times "
                               f"(expected {want})")
        rec["launcher"][arch] = {**summary, "segment_sum_sorted_launches": n}
        launches += n
    for arch, shape in TRAIN_CELLS:
        cell, n = train_cell(arch, shape, dev, np, torch)
        rec["cells"].append(cell)
        launches += n
    rec["hub_split"], cells, n = hub_split_cells(dev, np, torch)
    rec["cells"].extend(cells)
    launches += n
    return rec, launches


def hub_split_batch(batch, capacity, np):
    """A plain GNN batch split into the reference's two edge streams
    (numpy edge arrays; other entries are kept as they are): the
    ``capacity`` sources of highest out-degree (``split_hot_cold``, scores
    = out-degree) form the hub table; an edge whose source is a hub goes to
    the hot stream, the rest stay cold, each stream in the batch's edge
    order. (The reference has no such helper: its dryrun declares the
    shapes only.)"""
    from repro_torch.distributed.hub_gather import split_hot_cold

    src = batch["edge_src"]
    deg = np.bincount(src, minlength=batch["node_feat"].shape[0])
    plan = split_hot_cold(src, deg, capacity)
    hot = plan.is_hot
    out = {k: v for k, v in batch.items()
           if k not in ("edge_src", "edge_dst", "edge_mask")}
    out.update(
        hub_ids=plan.hot_ids.astype(np.int32),
        edge_src_cold=src[~hot], edge_src_hub_pos=plan.hot_pos[hot],
        edge_dst_cold=batch["edge_dst"][~hot],
        edge_dst_hot=batch["edge_dst"][hot],
        edge_mask_cold=batch["edge_mask"][~hot],
        edge_mask_hot=batch["edge_mask"][hot])
    return out


def hub_split_cells(dev, np, torch):
    """gat-cora's published config at ogb_products' 2,449,029 nodes, a
    tenth of its edges (``HUB_EDGE_CUT``): sources drawn from a power law
    whose top ``HUB_CAPACITY`` ranks carry ``HUB_HOT_SHARE`` of the edges
    (rank r with P(rank <= k) = (k / n)^b, ranks mapped to nodes by a
    random permutation), destinations uniform, edge_mask = rand < 0.9;
    split by ``hub_split_batch``. ``train_cell`` on the split batch (B9 8
    times a step) and on the same edges unsplit (4): each kernel route ==
    its plain route, split == unsplit, every loss within
    ``TRAIN_LOSS_RTOL``. Returns (record, [cell records], B9 launches)."""
    from repro_torch.configs.inputs import _adapt_cfg
    from repro_torch.configs.registry import get_arch

    arch = get_arch("gat-cora")
    shape = arch.shapes["ogb_products"]
    cfg = _adapt_cfg(arch, arch.config(), "ogb_products", shape)
    n, e = shape.n_nodes, shape.n_edges // HUB_EDGE_CUT
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    b = np.log(HUB_HOT_SHARE) / np.log(HUB_CAPACITY / n)
    u = torch.rand((e,), generator=gen, device=dev, dtype=torch.float64)
    rank = torch.clamp((n * u ** (1.0 / b)).long(), max=n - 1)
    perm = torch.randperm(n, generator=gen, device=dev)
    edges = {"edge_src": perm[rank].int(),
             "edge_dst": torch.randint(0, n, (e,), generator=gen, device=dev,
                                       dtype=torch.int32),
             "edge_mask": torch.rand((e,), generator=gen, device=dev) < 0.9}
    del u, rank, perm
    nodes = {"node_feat": torch.randn((n, shape.d_feat), generator=gen,
                                      device=dev),
             "node_mask": torch.ones((n,), dtype=torch.bool, device=dev),
             "labels": torch.randint(0, cfg.n_classes, (n,), generator=gen,
                                     device=dev, dtype=torch.int32),
             "label_mask": torch.ones((n,), dtype=torch.bool, device=dev)}
    host = {k: v.cpu().numpy() for k, v in edges.items()}
    t1 = time.perf_counter()
    split = hub_split_batch({**nodes, **host}, HUB_CAPACITY, np)
    plan_s = time.perf_counter() - t1
    split = {k: torch.as_tensor(v, device=dev) for k, v in split.items()}
    unsplit = {**nodes, **edges}
    torch.cuda.synchronize()
    hot = int(split["edge_src_hub_pos"].shape[0])
    rec = {"nodes": n, "edges": e, "edges_full": shape.n_edges,
           "edge_cut": HUB_EDGE_CUT, "hub_rows": HUB_CAPACITY,
           "power_law_exponent": float(b),
           "hot_edges": hot, "hot_share": hot / e,
           "hot_share_target": HUB_HOT_SHARE,
           "batch_s": time.perf_counter() - t0, "plan_s": plan_s}
    cells, launches = [], 0
    for name, batch in (("ogb_products_hub", split),
                        ("ogb_products_cut", unsplit)):
        c, k = train_cell("gat-cora", "ogb_products", dev, np, torch,
                          batch=(cfg, batch), cell=name)
        cells.append(c)
        launches += k
    del split, unsplit, nodes, edges
    ls, lu = (c["kernel_route"]["losses"] for c in cells)
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ls, lu)]
    rec["split_vs_unsplit"] = {"loss_rel_err": rel,
                               "tolerance": TRAIN_LOSS_RTOL}
    if not max(rel) <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"gat-cora hub split != unsplit {rel}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec, cells, launches


def launcher_run(argv, np, torch):
    """``repro_torch.launch.train.main(argv)`` with its line captured and
    printed: its summary (the run's parameters and optimizer state are
    dropped, so that the next cell's peak does not hold them). Fails
    unless it returns 0 with every loss finite."""
    import contextlib
    import io

    from repro_torch.launch import train

    out, run = io.StringIO(), {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv, result=run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    losses = [m["loss"] for m in run["log"]]
    if rc != 0 or not all(np.isfinite(losses)):
        raise RuntimeError(f"train.main {argv}: rc {rc}, losses {losses}")
    summary = {"argv": " ".join(argv), "line": out.getvalue().strip(),
               "seconds": seconds, "first_loss": losses[0],
               "last_loss": losses[-1],
               "ms_per_step_median": statistics.median(
                   m["dt"] for m in run["log"][1:]) * 1e3}
    run.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def timed_steps(step, data_fn, params, opt_state, steps, np, torch,
                tag="train"):
    """``steps`` steps through ``TrainRunner`` (the first a warm-up; a
    step's time ends with its loss on the host, after the queued update):
    (record, params, opt_state). Fails if a step was retried (a retry
    would hide a fault) or a loss is not finite. The peak counts from the
    call's start."""
    from repro_torch.distributed.fault_tolerance import (
        StragglerMonitor,
        TrainRunner,
    )

    calls = [0]

    def counted(*a):
        calls[0] += 1
        return step(*a)

    runner = TrainRunner(step_fn=counted, data_fn=data_fn,
                         monitor=StragglerMonitor())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, log = runner.run(params, opt_state, start_step=0,
                                        n_steps=steps)
    torch.cuda.synchronize()
    losses = [m["loss"] for m in log]
    if calls[0] != steps or not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag}: {calls[0]} step calls for {steps} "
                           f"steps, losses {losses}")
    timed = [m["dt"] * 1e3 for m in log[1:]]
    return {"steps": steps, "step_fn_calls": calls[0], "losses": losses,
            "first_step_ms": log[0]["dt"] * 1e3,
            "ms_per_step_median": statistics.median(timed),
            "ms_per_step": timed,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "straggler_flags": len(runner.monitor.flagged)}, params, opt_state


def profiled_step(step, params, opt_state, batch, kinds, torch):
    """One train step under ``torch.profiler``: (the device time split by
    ``kinds``, the first pattern that matches a kernel's name, with the
    idle share; params, opt_state)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof, torch)
    split = {k: 0.0 for k, _ in kinds}
    split["other"] = 0.0
    for r in rows:
        kind = next((k for k, pat in kinds
                     if re.search(pat, r["name"], re.I)), "other")
        split[kind] += r["device_ms"]
    busy = sum(r["device_ms"] for r in rows)
    if busy > window_ms:
        raise RuntimeError("profiled step: device busy time exceeds the "
                           "window")
    return {"window_ms": window_ms, "device_ms": {"busy": busy, **split},
            "idle_share": 1.0 - busy / window_ms,
            "kernels": sum(r["calls"] for r in rows),
            "top_device_kernels": rows[:12]}, params, opt_state


def card_vs_cpu(make_step, params, batches, np, torch):
    """The same functional train step from the same parameters on the
    CPU and on the card: every loss and every parameter leaf within
    ``PARITY_RTOL`` (relative, a leaf in L2)."""
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        step, optim = make_step()
        state = optim.init(p)
        losses = []
        for b in batches:
            p, state, m = step(p, state, {k: torch.as_tensor(v, device=dev)
                                          for k, v in b.items()})
            losses.append(float(m["loss"]))
        out[dev] = (losses, [x.cpu() for x in tree_leaves(p)])
    (l_cpu, p_cpu), (l_card, p_card) = out["cpu"], out["cuda"]
    loss_err = max(abs(a - b) / max(abs(a), 1e-30)
                   for a, b in zip(l_cpu, l_card))
    leaf_err = max(float((a - b).norm() / max(float(a.norm()), 1e-30))
                   for a, b in zip(p_cpu, p_card))
    rec = {"steps": len(batches), "losses_cpu": l_cpu, "losses_card": l_card,
           "loss_rel_err": loss_err, "param_rel_l2_err": leaf_err,
           "tolerance": PARITY_RTOL}
    if not (loss_err <= PARITY_RTOL and leaf_err <= PARITY_RTOL):
        raise RuntimeError(f"card != CPU {rec}")
    return rec


def phase_train_lm(dev, np, torch):
    """LM training on the card: (a) ``launch.train.main`` on
    stablelm-1.6b's published config; (b) the stablelm-1.6b x train_4k
    cell (``LM_CELL_*``: the launcher's parameters and optimizer, its step
    at ``LM_CELL_MICROBATCHES``, ``TokenStream`` batches of 4 x 4,096),
    1 warm-up + 5 timed steps (ms/step, tokens/s, peak memory, every loss
    finite, the first within ``LM_FIRST_LOSS_TOL`` of ln(vocab)) and one
    profiled step; (c) the smoke config in fp32 (TF32 off, asserted) for
    ``LM_PARITY_STEPS`` steps on the card and on the CPU from the same
    parameters (``card_vs_cpu``). B8 is never launched (training runs
    its differentiable plain version at the flash cutoff; 4,096 is under
    it)."""
    import math

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.train import train_loop as tl

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("train_lm: fp32 GEMMs must not run in TF32")
    rec = {"phase": "train_lm"}
    fa.reset_launches()
    rec["launcher"] = launcher_run(LM_TRAIN_ARGV, np, torch)

    arch = get_arch("stablelm-1.6b")
    shape = arch.shapes["train_4k"]
    cfg = arch.config()
    if not cfg.remat or cfg.dtype != torch.bfloat16:
        raise RuntimeError(f"train_lm: published config {cfg}")
    steps = TRAIN_STEPS
    t0 = time.perf_counter()
    params, optim, _, _ = train.build("stablelm-1.6b", 0, dev, steps=steps)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = tl.make_lm_train_step(cfg, optim,
                                 n_microbatches=LM_CELL_MICROBATCHES)
    stream = TokenStream(cfg.vocab, LM_CELL_BATCH, shape.seq_len, seed=0)

    def data_fn(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in stream.batch_at(i).items()}

    cell, params, state = timed_steps(step, data_fn, params,
                                      optim.init(params), steps, np, torch)
    first = cell["losses"][0]
    if abs(first - math.log(cfg.vocab)) > LM_FIRST_LOSS_TOL:
        raise RuntimeError(f"train_lm: first loss {first}, ln(vocab) "
                           f"{math.log(cfg.vocab)}")
    tokens = LM_CELL_BATCH * shape.seq_len
    cell.update(
        cell="stablelm-1.6b x train_4k", seq_len=shape.seq_len,
        global_batch=LM_CELL_BATCH, global_batch_published=shape.global_batch,
        microbatches=LM_CELL_MICROBATCHES, params=cfg.param_count(),
        layers=cfg.n_layers, d_model=cfg.d_model, remat=cfg.remat,
        dtype=str(cfg.dtype), init_s=init_s, ln_vocab=math.log(cfg.vocab),
        tokens_per_step=tokens,
        tokens_per_s=tokens / cell["ms_per_step_median"] * 1e3,
        model_tflops_per_s=6.0 * cfg.param_count() * tokens
        / cell["ms_per_step_median"] / 1e9)
    cell["profiled_step"], params, state = profiled_step(
        step, params, state, data_fn(steps), TRAIN_KINDS, torch)
    rec["cell"] = cell
    del params, state, step, optim
    gc.collect()
    torch.cuda.empty_cache()

    import dataclasses as dc

    from repro_torch.train import optimizer as opt

    cfg32 = dc.replace(arch.smoke_config(), dtype=torch.float32, remat=True)
    p0 = tfm.init_params(cfg32, torch.Generator().manual_seed(0))
    small = TokenStream(cfg32.vocab, 4, 64, seed=0)

    def make_step():
        o = opt.adamw(lr=opt.cosine_schedule(
            3e-4, min(20, LM_PARITY_STEPS // 4 + 1), LM_PARITY_STEPS))
        return tl.make_lm_train_step(cfg32, o, n_microbatches=2), o

    rec["smoke_fp32_card_vs_cpu"] = card_vs_cpu(
        make_step, p0, [small.batch_at(i) for i in range(LM_PARITY_STEPS)],
        np, torch)
    rec["matmul_allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    rec["flash_attention_launches"] = fa.launches()
    if fa.launches():
        raise RuntimeError("train_lm: training launched B8")
    return rec


def phase_train_moe(dev, np, torch):
    """MoE training on the card: (a) ``launch.train.main --smoke`` on both
    MoE LMs; (b) moonshot-v1-16b-a3b at its published width with its depth
    cut to ``MOE_TRAIN_LAYERS``, at train_4k's sequence of 4,096, batch
    ``LM_CELL_BATCH`` in ``LM_CELL_MICROBATCHES`` microbatches, the
    launcher's optimizer: 1 warm-up + 5 timed steps (ms/step, tokens/s,
    model FLOP/s on ``active_param_count``, peak memory; every loss
    finite, the first within ``LM_FIRST_LOSS_TOL`` of ln(vocab)) and one
    profiled step; (c) each smoke config in fp32 (TF32 off, asserted) for
    ``LM_PARITY_STEPS`` steps on the card and on the CPU from the same
    parameters (``card_vs_cpu``). B8 is never launched."""
    import math

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError("train_moe: fp32 GEMMs must not run in TF32")
    rec = {"phase": "train_moe"}
    fa.reset_launches()
    rec["launcher"] = {arch: launcher_run(["--arch", arch, "--smoke",
                                           "--steps", "10"], np, torch)
                       for arch in MOE_ARCHS}

    arch = get_arch("moonshot-v1-16b-a3b")
    shape = arch.shapes["train_4k"]
    full = arch.config()
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    if not cfg.remat or cfg.dtype != torch.bfloat16:
        raise RuntimeError(f"train_moe: published config {cfg}")
    steps = TRAIN_STEPS
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the launcher's LM optimizer (launch/train.py::build)
    optim = opt.adamw(lr=opt.cosine_schedule(3e-4, min(20, steps // 4 + 1),
                                             steps))
    step = tl.make_lm_train_step(cfg, optim,
                                 n_microbatches=LM_CELL_MICROBATCHES)
    stream = TokenStream(cfg.vocab, LM_CELL_BATCH, shape.seq_len, seed=0)

    def data_fn(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in stream.batch_at(i).items()}

    cell, params, state = timed_steps(step, data_fn, params,
                                      optim.init(params), steps, np, torch,
                                      tag="train_moe")
    first = cell["losses"][0]
    if abs(first - math.log(cfg.vocab)) > LM_FIRST_LOSS_TOL:
        raise RuntimeError(f"train_moe: first loss {first}, ln(vocab) "
                           f"{math.log(cfg.vocab)}")
    tokens = LM_CELL_BATCH * shape.seq_len
    ms = cell["ms_per_step_median"]
    cell.update(
        cell="moonshot-v1-16b-a3b x train_4k", seq_len=shape.seq_len,
        global_batch=LM_CELL_BATCH, global_batch_published=shape.global_batch,
        microbatches=LM_CELL_MICROBATCHES, layers=cfg.n_layers,
        layers_published=full.n_layers,
        reduced=f"depth {full.n_layers} -> {cfg.n_layers} layers; global "
                f"batch {shape.global_batch} -> {LM_CELL_BATCH}",
        d_model=cfg.d_model, experts=cfg.moe_experts, top_k=cfg.moe_top_k,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        capacity_a_microbatch=moe.capacity(
            cfg.moe_capacity,
            LM_CELL_BATCH // LM_CELL_MICROBATCHES * shape.seq_len,
            cfg.moe_top_k, cfg.moe_experts),
        remat=cfg.remat, dtype=str(cfg.dtype), init_s=init_s,
        ln_vocab=math.log(cfg.vocab), tokens_per_step=tokens,
        tokens_per_s=tokens / ms * 1e3,
        model_tflops_per_s=6.0 * cfg.active_param_count() * tokens / ms
        / 1e9)
    cell["profiled_step"], params, state = profiled_step(
        step, params, state, data_fn(steps), TRAIN_KINDS, torch)
    rec["cell"] = cell
    del params, state, step, optim
    gc.collect()
    torch.cuda.empty_cache()

    rec["smoke_fp32_card_vs_cpu"] = {}
    for arch_id in MOE_ARCHS:
        cfg32 = dataclasses.replace(get_arch(arch_id).smoke_config(),
                                    dtype=torch.float32, remat=True)
        p0 = tfm.init_params(cfg32, torch.Generator().manual_seed(0))
        small = TokenStream(cfg32.vocab, 4, 64, seed=0)

        def make_step(cfg32=cfg32):
            o = opt.adamw(lr=opt.cosine_schedule(
                3e-4, min(20, LM_PARITY_STEPS // 4 + 1), LM_PARITY_STEPS))
            return tl.make_lm_train_step(cfg32, o, n_microbatches=2), o

        rec["smoke_fp32_card_vs_cpu"][arch_id] = card_vs_cpu(
            make_step, p0, [small.batch_at(i)
                            for i in range(LM_PARITY_STEPS)], np, torch)
    rec["matmul_allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    rec["flash_attention_launches"] = fa.launches()
    if fa.launches():
        raise RuntimeError("train_moe: training launched B8")
    return rec


def phase_train_din(dev, np, torch):
    """Recsys training on the card: (a) ``launch.train.main`` on DIN's
    published config; (b) the din x train_batch cell: the launcher's
    parameters, optimizer and step at ``DIN_CELL_BATCH`` requests a batch
    of ``CTRStream``, 1 warm-up + 5 timed steps (ms/step, samples/s, peak
    memory) and one profiled step; ``DIN_UNTOUCHED_SAMPLE`` item rows that
    no batch looked up keep their bits and zero moments, the rows of the
    target items moved; (c) ``make_retrieval_step(retrieval_score,
    top_k=100)`` at ``RETRIEVAL_CANDIDATES`` Zipf candidates: its values and
    indices equal the top 100 of a full stable sort of the same scores;
    then a DIN smoke step on the card against the CPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.recsys import CTRStream
    from repro_torch.launch import train
    from repro_torch.models.recsys import din
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    rec = {"phase": "train_din"}
    rec["launcher"] = launcher_run(DIN_TRAIN_ARGV, np, torch)

    cfg = get_arch("din").config()
    steps = TRAIN_STEPS
    t0 = time.perf_counter()
    params, optim, step, _ = train.build("din", 0, dev, steps=steps)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = CTRStream(cfg.n_items, cfg.n_cats, DIN_CELL_BATCH,
                       seq_len=cfg.seq_len, d_profile=cfg.d_profile, seed=0)
    t0 = time.perf_counter()
    host = [stream.batch_at(i) for i in range(steps + 1)]
    batch_s = time.perf_counter() - t0
    seen = np.unique(np.concatenate(
        [np.concatenate([b["hist_items"].ravel(), b["target_item"]])
         for b in host]))
    rng = np.random.default_rng(1)
    cand = rng.integers(0, cfg.n_items, 4 * DIN_UNTOUCHED_SAMPLE)
    cold = torch.as_tensor(
        cand[~np.isin(cand, seen)][:DIN_UNTOUCHED_SAMPLE], device=dev)
    hot = torch.as_tensor(np.unique(np.concatenate(
        [b["target_item"] for b in host[:steps]])), device=dev)
    cold_rows = params["item_table"][cold].clone()
    hot_rows = params["item_table"][hot].clone()

    def data_fn(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in host[i].items()}

    cell, params, state = timed_steps(step, data_fn, params,
                                      optim.init(params), steps, np, torch)
    untouched = {
        "rows": int(cold.numel()), "looked_up_rows": int(seen.size),
        "unchanged": bool(torch.equal(params["item_table"][cold], cold_rows)),
        "zero_moments": bool(not state.mu["item_table"][cold].any()
                             and not state.nu["item_table"][cold].any()),
        "target_rows_moved": int((params["item_table"][hot] != hot_rows)
                                 .any(1).sum()), "target_rows": int(
                                     hot.numel())}
    if not (untouched["rows"] == DIN_UNTOUCHED_SAMPLE
            and untouched["unchanged"] and untouched["zero_moments"]
            and untouched["target_rows_moved"] > 0):
        raise RuntimeError(f"train_din: rows no batch touched {untouched}")
    cell.update(
        cell="din x train_batch", batch=DIN_CELL_BATCH,
        item_table=list(params["item_table"].shape), init_s=init_s,
        host_batches_s=batch_s, untouched_rows=untouched,
        samples_per_s=DIN_CELL_BATCH / cell["ms_per_step_median"] * 1e3)
    cell["profiled_step"], params, state = profiled_step(
        step, params, state, data_fn(steps), TRAIN_KINDS, torch)
    rec["cell"] = cell
    del state, step, optim, cold_rows, hot_rows
    gc.collect()
    torch.cuda.empty_cache()

    # (c) retrieval: one user against RETRIEVAL_CANDIDATES Zipf candidates
    user = host[0]
    items = ((rng.zipf(1.3, RETRIEVAL_CANDIDATES) - 1) % cfg.n_items).astype(
        np.int32)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in {
        "hist_items": user["hist_items"][:1],
        "hist_cats": user["hist_cats"][:1],
        "hist_mask": user["hist_mask"][:1],
        "user_profile": user["user_profile"][:1],
        "cand_items": items,
        "cand_cats": (items % cfg.n_cats).astype(np.int32)}.items()}
    del host
    retrieval = tl.make_retrieval_step(din.retrieval_score, cfg,
                                       top_k=RETRIEVAL_TOP_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        vals, idx = retrieval(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        scores = din.retrieval_score(params, batch, cfg)
    order = torch.sort(scores, descending=True, stable=True).indices[
        :RETRIEVAL_TOP_K]
    top = scores[order]
    ret = {"candidates": RETRIEVAL_CANDIDATES,
           "candidates_published": 1_000_000, "top_k": RETRIEVAL_TOP_K,
           "ms": walls, "max_memory_allocated":
               torch.cuda.max_memory_allocated(),
           "distinct_top_values": int(torch.unique(top).numel()),
           "indices_dtype": str(idx.dtype),
           "equals_stable_sort": bool(torch.equal(idx.long(), order)
                                      and torch.equal(vals, top))}
    if not ret["equals_stable_sort"]:
        raise RuntimeError(f"train_din: retrieval top-k != stable sort {ret}")
    rec["retrieval"] = ret
    del params, batch, scores, vals, idx
    gc.collect()
    torch.cuda.empty_cache()

    scfg = get_arch("din").smoke_config()
    p0 = din.init_params(scfg, torch.Generator().manual_seed(0))
    small = CTRStream(scfg.n_items, scfg.n_cats, 128, seq_len=scfg.seq_len,
                      d_profile=scfg.d_profile, seed=0)

    def make_step():
        o = opt.adamw(lr=1e-3, weight_decay=0.0)
        return tl.make_recsys_train_step(din.apply, scfg, o), o

    rec["smoke_card_vs_cpu"] = card_vs_cpu(
        make_step, p0, [small.batch_at(i) for i in range(3)], np, torch)
    return rec


def phase_validate(torch):
    """``repro_torch.launch.stream_run`` at VALIDATE_ARGV on the card with
    ``--trace --metrics --cache-trace``, its three artifacts checked
    in-process by the port's validator (``repro_torch.obs.validate.main``,
    which must return 0); then no module of ``jax`` or of the reference
    package may be loaded."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import stream_run
    from repro_torch.obs import validate

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        paths = {k: os.path.join(d, f"{k}.json")
                 for k in ("trace", "metrics", "cachescope")}
        argv = VALIDATE_ARGV + ["--trace", paths["trace"],
                                "--metrics", paths["metrics"],
                                "--cache-trace", paths["cachescope"]]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = stream_run.main(argv)
        torch.cuda.synchronize()
        if rc != 0 or "final state verified bit-exact" not in out.getvalue():
            raise RuntimeError(f"stream_run {argv}: rc {rc}\n"
                               f"{out.getvalue()[-2000:]}")
        checked = io.StringIO()
        with contextlib.redirect_stdout(checked):
            vrc = validate.main(["--trace", paths["trace"],
                                 "--metrics", paths["metrics"],
                                 "--cachescope", paths["cachescope"]])
        sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    lines = [ln.replace(d, "<tmp>") for ln in checked.getvalue().splitlines()]
    if vrc != 0:
        raise RuntimeError("repro_torch.obs.validate refused the port's "
                           "artifacts:\n" + "\n".join(lines))
    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "jaxlib", "repro")
                    or m.startswith(("jax.", "jaxlib.", "repro.")))
    if loaded:
        raise RuntimeError(f"modules of jax or the reference loaded: {loaded}")
    return {"phase": "validate", "argv": " ".join(VALIDATE_ARGV),
            "stream_rc": rc, "validate_rc": vrc, "lines": lines,
            "artifact_bytes": sizes, "jax_or_reference_modules": loaded,
            "seconds": time.perf_counter() - t0}


# B9's timed shapes: (name, values shape, N, ids). gin-tu at ogb_products
# (layers 2-5 and layer 1; B9's headline row, timed from Python), MACE at
# mace x molecule (128 graphs x 30 nodes x 64 edges; the l = 2, 1, 0
# coupling paths' 5, 3, 1 x 128 channels, then the energy readout into 128
# graphs), gat-cora at full_graph_sm (8 heads x 8 channels; the softmax
# denominator a float a head)
SEGSUM_SHAPES = (
    ("D64", (61_859_140, 64), 2_449_029, "sorted"),
    ("D100", (61_859_140, 100), 2_449_029, "sorted"),
    ("mace_D640", (8_192, 640), 3_840, "mace"),
    ("mace_D384", (8_192, 384), 3_840, "mace"),
    ("mace_D128", (8_192, 128), 3_840, "mace"),
    ("mace_readout", (3_840,), 128, "readout"),
    ("gat_msg", (10_556, 8, 8), 2_708, "sorted"),
    ("gat_denom", (10_556, 8), 2_708, "sorted"),
)
SEGSUM_ROUNDS = 5  # rounds of turns below 10^6 edges (one at ogb_products)


def parent_segment_sum():
    """The parent checkout's B9 wrapper (``build/parent/
    segment_sum_sorted.py``, of the same commit as its ``.cu``) on the
    parent's library, or None without both: its module loaded beside this
    checkout's, its ``_build.load`` answering with ``PARENT``'s library, so
    a call runs the parent's Python as well as its kernel."""
    import importlib.util
    import types

    src = os.path.join(PARENT_DIR, "segment_sum_sorted.py")
    lib = PARENT.get("segment_sum_sorted")
    if lib is None or not os.path.exists(src):
        return None
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels._parent_segment_sum_sorted", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(load=lambda name: lib)
    return mod.segment_sum_sorted


def time_segment_sum(dev, np, torch):
    """B9 at every shape of ``SEGSUM_SHAPES``: the kernel from Python
    (``ms``: ``min_ms``, calls issued back to back, so below 10^6 edges it
    reads the host's launch path) and, below 10^6 edges, on the device alone
    (``device_ms``: 20 calls in a CUDA graph, warm: MACE's 31 MB stay in the
    50 MB L2); ``zeros + index_add_`` as the library call, and with the
    parent's wrapper and source in ``build/parent/`` the parent's B9 through
    its own wrapper, each timed the same ways. The three are timed in turns
    (this, library, parent, parent, library, this: a round's value is the
    lower of each's two), ``SEGSUM_ROUNDS`` rounds below 10^6 edges and one
    at ogb_products; every round's values are kept (``rounds``) with this
    kernel's ratio to the library call's in each round, and the keys above
    are the least over the rounds. Also the plain version (not at
    ogb_products' D = 100, whose masked copy of the 24.7 GB values would not
    fit beside them) and the bound (values and ids read once, out written
    once). Each timed call includes its output's zeroing. The kernel's
    output (and the parent's) is held element by element at SEGSUM_TOL
    against the plain one, or at D = 100 the library call's (every id is in
    range there, so it is the same function)."""
    from repro_torch.launch.bag_timing import graph_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum_sorted as ss

    rng = np.random.default_rng(11)
    gen = torch.Generator(dev).manual_seed(1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    parent = parent_segment_sum()
    out = {}
    for name, shape, n, kind in SEGSUM_SHAPES:
        e = shape[0]
        small = e < 1_000_000
        if small:
            seg = torch.from_numpy(segsum_ids(kind, e, n, rng, np)).to(dev)
        else:  # drawn on the card: 61.9M ids
            seg = torch.sort(torch.randint(0, n, (e,), generator=gen,
                                           device=dev,
                                           dtype=torch.int32)).values
        vals = torch.randn(shape, generator=gen, device=dev)
        d = vals[0].numel()

        def kernel():
            return ops.segment_sum_sorted(vals, seg, num_segments=n)

        def library():
            return torch.zeros((n,) + shape[1:], device=dev).index_add_(
                0, seg, vals)

        nbytes = e * d * 4.0 + e * 4.0 + n * d * 4.0
        bnd, by = bound_ms(nbytes, e * d * 1.0)
        geo = ss.geometry(e, d, n, n_sm, vals.data_ptr())
        row = {"shape": {"values": list(shape), "segments": n, "ids": kind},
               "geometry": dataclasses.asdict(geo),
               "warps_per_sm": geo.warps / n_sm,
               "bytes": nbytes, "bound_ms": bnd, "bound_by": by}
        if name != "D100":
            row["plain_ms"] = (min_ms(lambda: ss.segment_sum_sorted_ref(
                vals, seg, num_segments=n)) if small else cuda_ms(
                lambda: ss.segment_sum_sorted_ref(vals, seg, num_segments=n),
                reps=1))
            want = ss.segment_sum_sorted_ref(vals, seg, num_segments=n)
            row["err_against"] = "segment_sum_sorted_ref"
        else:
            want = library()
            row["err_against"] = "zeros + index_add_"
        want = want.reshape(n, d)
        fns = {"this": kernel, "library": library}
        if parent is not None:
            fns["parent"] = lambda: parent(vals, seg, num_segments=n)
        for who, fn in fns.items():
            if who == "library":
                continue
            diff = (fn().reshape(n, d) - want).abs()
            over = float((diff / (SEGSUM_TOL * (1 + want.abs()))).max())
            if who == "this":
                row["err"], row["err_over_limit"] = float(diff.max()), over
            else:
                row["parent_err_over_limit"] = over
            if not over <= 1.0:
                raise RuntimeError(f"timing: B9 ({who}) != plain at {name} "
                                   f"({over})")
            del diff
        clocks = {"python": lambda f: min_ms(f, reps=20 if small else 5)}
        if small:
            clocks["device"] = lambda f: graph_ms(f, 20)
        rounds = {clock: {who: [] for who in fns} for clock in clocks}
        for _ in range(SEGSUM_ROUNDS if small else 1):
            for clock, timer in clocks.items():
                turn = {who: [] for who in fns}
                for who in [*fns, *reversed(fns)]:
                    turn[who].append(timer(fns[who]))
                for who, times in turn.items():
                    rounds[clock][who].append(min(times))
        for clock, by_who in rounds.items():
            pre = "" if clock == "python" else "device_"
            for who, times in by_who.items():
                key = {"this": "", "library": "library_",
                       "parent": "parent_"}[who]
                row[f"{key}{pre}ms"] = min(times)
            by_who["this_over_library"] = [
                t / lib for t, lib in zip(by_who["this"], by_who["library"])]
            if parent is not None:
                by_who["this_over_parent"] = [
                    t / p for t, p in zip(by_who["this"], by_who["parent"])]
        row["rounds"] = rounds
        row["share_of_bound"] = bnd / row["device_ms" if small else "ms"]
        out[name] = row
        del vals, seg, want
        torch.cuda.empty_cache()
    return out


class ServeRecorder:
    """Wraps the serving engine's two kernel entry points (B1 behind
    ``batched_pair_counts``, B3 in the engine): counts calls and pairs,
    the width buckets B1 is called at, and keeps the inputs of the widest
    call of each (whose all-pairs plain version stays under 2^38
    compares) to hold the kernel against its plain version at the path's
    own shapes afterwards. Launch counters stay in the wrappers."""

    PLAIN_COMPARES = float(1 << 38)

    def __init__(self, point_query, engine):
        self.mods = {"b1": (point_query, "delta_intersect_counts"),
                     "b3": (engine, "resident_intersect_counts")}
        self.orig = {k: getattr(m, n) for k, (m, n) in self.mods.items()}
        self.calls = {"b1": 0, "b3": 0}
        self.pairs = {"b1": 0, "b3": 0}
        self.buckets = {}  # (wa, wb) of B1 -> calls
        self.widest = {}

    def _keep(self, route, e, wa, wb, args):
        if e * wa * wb > self.PLAIN_COMPARES:
            return
        if wa * wb > self.widest.get(route, (0,))[0]:
            self.widest[route] = (wa * wb, args())

    def __enter__(self):
        def b1(rows_a, rows_b, **kw):
            out = self.orig["b1"](rows_a, rows_b, **kw)
            e, wa, wb = rows_a.shape[0], rows_a.shape[1], rows_b.shape[1]
            self.calls["b1"] += 1
            self.pairs["b1"] += e
            key = f"{wa}x{wb}"
            self.buckets[key] = self.buckets.get(key, 0) + 1
            self._keep("b1", e, wa, wb, lambda: (
                rows_a.copy(), rows_b.copy(), kw["sentinel"], out))
            return out

        def b3(residency, slots_a, rows_b=None, **kw):
            out = self.orig["b3"](residency, slots_a, rows_b, **kw)
            self.calls["b3"] += 1
            self.pairs["b3"] += len(slots_a)
            self._keep("b3", len(slots_a), residency.shape[1],
                       rows_b.shape[1], lambda: (
                           residency.clone(), slots_a.copy(), rows_b.copy(),
                           kw["lengths"].clone(), kw["sentinel"], out))
            return out

        for k, fn in (("b1", b1), ("b3", b3)):
            mod, name = self.mods[k]
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for k, (mod, name) in self.mods.items():
            setattr(mod, name, self.orig[k])

    def recheck(self, dev, np, torch):
        """The widest call of each kernel, again: kernel vs plain version
        on the same inputs. Returns ({kernel: shape}, max_abs_err)."""
        from repro_torch.kernels import intersect_count as ic
        from repro_torch.kernels import resident_intersect as ri
        from repro_torch.kernels.delta_intersect import delta_intersect_counts

        shapes, worst = {}, 0
        _, (a, b, sent, got) = self.widest["b1"]
        want = ic.intersect_count_ref(torch.from_numpy(a).to(dev),
                                      torch.from_numpy(b).to(dev),
                                      sentinel=sent).cpu().numpy()
        again = delta_intersect_counts(a, b, sentinel=sent, device=dev)
        err = int(max(np.abs(got - want).max(), np.abs(again - want).max()))
        worst = max(worst, err)
        shapes["intersect_count"] = {"shape": [a.shape[0], a.shape[1],
                                               b.shape[1]], "err": err}
        _, (res, sa, rb, lens, sent, got) = self.widest["b3"]
        want = ri.resident_intersect_ref(
            res, torch.from_numpy(sa.astype(np.int32)).to(dev),
            torch.from_numpy(rb).to(dev), lengths=lens,
            sentinel=sent).cpu().numpy()
        again = ri.resident_intersect_counts(res, sa, rb, lengths=lens,
                                             sentinel=sent, device=dev)
        err_b3 = int(max(np.abs(got - want).max(),
                         np.abs(again - want).max()))
        worst = max(worst, err_b3)
        shapes["resident_intersect"] = {
            "residency": list(res.shape), "E": int(sa.shape[0]),
            "WB": int(rb.shape[1]), "err": err_b3}
        if worst:
            raise RuntimeError(f"query_serve: kernel != plain version at the "
                               f"path's widest call {shapes}")
        return shapes, worst


def run_launcher(main_fn, argv, result):
    """``main_fn(argv, result=result)`` with its printed lines captured
    (and echoed); fails unless it returns 0. Returns the lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv, result=result)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)}: returned {rc}")
    return text.splitlines()


def served_summary(res, lines):
    """The launcher run's numbers: served, q/s, latency, its verify line."""
    lat = res["latency"]
    out = {"served": res["served"], "wall_s": res["wall_s"],
           "qps_end_to_end": res["served"] / res["wall_s"],
           "qps_in_engine": lat.throughput_qps, "p50_ms": lat.p50_ms,
           "p99_ms": lat.p99_ms, "max_ms": lat.max_ms}
    want = (f"verified: {res['served']} point queries bit-exact vs "
            "recount, 0 stale cached rows")
    if want not in lines:
        raise RuntimeError(f"query_serve: no {want!r} line in {lines}")
    out["verified"] = want
    return out


class AnswerCheck:
    """Every answer of the timed run against state computed another way
    than the engine's pair counts, before the next event mutates it:
    TRIANGLES / LCC against the stream engine's incrementally maintained
    ``t`` / ``lcc``, COMMON_NEIGHBORS against ``np.intersect1d`` of the
    store's rows, TOP_K_LCC against a ``lexsort`` of ``lcc``."""

    def __init__(self, svc, np):
        self.svc, self.np = svc, np
        self.by_kind = {}
        self.seconds = 0.0

    def __call__(self, results):
        np, svc = self.np, self.svc
        t0 = time.perf_counter()
        t, lcc, store = svc.stream.t, svc.stream.lcc, svc.store
        order = None
        for r in results:
            q = r.query
            kind = q.kind.name
            if kind == "TRIANGLES":
                ok = type(r.value) is int and r.value == int(t[q.u])
            elif kind == "LCC":
                ok = r.value == lcc[q.u]
            elif kind == "COMMON_NEIGHBORS":
                want = np.intersect1d(store.row(q.u), store.row(q.v))
                ok = r.value == want.size and np.array_equal(r.ids, want)
            else:
                if order is None:
                    order = np.lexsort((np.arange(lcc.size), -lcc))
                top = order[: q.k]
                ok = (np.array_equal(r.ids, top)
                      and np.array_equal(r.values, lcc[top]))
            if not ok:
                raise RuntimeError(f"query_serve: wrong answer {q} -> "
                                   f"{r.value}")
            self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        self.seconds += time.perf_counter() - t0


def answers_of(results, np):
    """Results as plain data, for comparing two routes bit for bit."""
    return [(q.kind.name, q.u, q.v, q.k, type(r.value).__name__, r.value,
             None if r.ids is None else (r.ids.dtype.str, r.ids.tolist()),
             None if r.values is None else (r.values.dtype.str,
                                            r.values.tolist()))
            for r in results for q in (r.query,)]


def phase_query_serve(dev, np, torch):
    """The serving and traffic planes (``launch/query_serve.py``) on the
    card: (a) the launcher at S12 with ``--verify``; (b) the same graph
    with ``--ranks 8 --verify``, then open-loop Poisson arrivals at half
    (a)'s in-engine rate with SLO classes, 3 tenants and live scores;
    (c) the S16 graph timed through the launcher's own ``build_service``
    and ``closed_loop``, every answer checked against state computed
    another way, a profiled continuation for the device split, then
    ``svc.verify()``; (d) the kernel route against the plain route at
    S14, bit for bit. Returns (phase record, {kernel: launches})."""
    import dataclasses as dc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import intersect_count as ic
    from repro_torch.kernels import point_query
    from repro_torch.kernels import resident_intersect as ri
    from repro_torch.launch import query_serve
    from repro_torch.serving import engine as serving_engine

    rec = {"phase": "query_serve"}
    launches = {}

    def counted(tag, fn):
        ic.reset_launches()
        ri.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = {"intersect_count": ic.launches(),
                         "resident_intersect": ri.launches()}
        return out

    def serve(tag, argv):
        res = {}
        t0 = time.perf_counter()
        lines = counted(tag, lambda: run_launcher(
            query_serve.main, argv + ["--device", "cuda"], res))
        out = served_summary(res, lines)
        out.update(argv=" ".join(argv), seconds=time.perf_counter() - t0,
                   launches=launches[tag])
        return out, res, lines

    # (a) verified run
    rec["verified"], res_a, _ = serve("verified", QS_VERIFY_ARGV)
    del res_a
    # (b) cross-rank, then the traffic plane open loop at half (a)'s rate
    rec["ranks"], _, _ = serve("ranks", QS_VERIFY_ARGV + [
        "--ranks", "8", "--queries", str(QS_RANKS_QUERIES)])
    rate = 0.5 * rec["verified"]["qps_in_engine"]
    rec["open_loop"], _, lines = serve(
        "open_loop", QS_VERIFY_ARGV + QS_OPEN_FLAGS + ["--rate", f"{rate:.1f}"])
    for head in ("open-loop[poisson]", "slo: hit rate", "tenants[3]",
                 "  cache shares:", "ewma scores:"):
        hit = [ln for ln in lines if ln.startswith(head)]
        if not hit:
            raise RuntimeError(f"query_serve: open loop printed no {head!r}")
        rec["open_loop"][head.strip().split(":")[0].split("[")[0]] = hit[0]

    # (c) the static cell's graph, timed
    timed_argv = QS_TIMED_ARGV + ["--queries", str(QS_TIMED_QUERIES)]
    args = query_serve.parse_args(timed_argv + ["--device", "cuda"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w = query_serve.build_service(args, dev)
    svc = w.svc
    build_s = time.perf_counter() - t0
    check = AnswerCheck(svc, np)
    with ServeRecorder(point_query, serving_engine) as srec:
        t0 = time.perf_counter()
        served, n_updates = counted("timed", lambda: query_serve.closed_loop(
            args, svc, rebalancer=w.rebalancer, on_results=check))
        wall = time.perf_counter() - t0 - check.seconds
    peak = torch.cuda.max_memory_allocated() - base
    lat = svc.scheduler.latency_summary()
    n_batches = svc.scheduler.n_batches
    if served < args.queries or sum(check.by_kind.values()) != served:
        raise RuntimeError(f"query_serve: {served} served, "
                           f"{check.by_kind} checked of {args.queries}")
    recheck, recheck_err = srec.recheck(dev, np, torch)
    tl = launches["timed"]
    timed = {
        "argv": " ".join(timed_argv), "build_s": build_s,
        "served": served, "updates": n_updates,
        "checked": dict(check.by_kind),
        "check_s": check.seconds, "wall_s": wall,
        "qps_end_to_end": served / wall, "qps_in_engine": lat.throughput_qps,
        "p50_ms": lat.p50_ms, "p90_ms": lat.p90_ms, "p99_ms": lat.p99_ms,
        "max_ms": lat.max_ms, "microbatches": n_batches,
        "peak_bytes_beyond_start": peak,
        "provider_hit_rate": svc.provider.stats.hit_rate,
        "tier_hit_rate": svc.runtime.merged_device_stats().hit_rate,
        "host_pack_bytes": svc.engine.host_pack_bytes,
        "pairs": {"raw": svc.engine.n_pairs_raw,
                  "intersected": svc.engine.n_pairs_total,
                  "resident": svc.engine.n_pairs_resident},
        "launches": tl,
        "launches_note": "the counters' totals include the stream engine's "
                         "launches on the update events; engine_calls are "
                         "the query engine's own (one launch a call)",
        "b1_launches_per_microbatch": srec.calls["b1"] / n_batches,
        "b3_launches_per_microbatch": srec.calls["b3"] / n_batches,
        "engine_calls": srec.calls, "engine_pairs": srec.pairs,
        "b1_buckets": srec.buckets, "widest_calls_vs_plain": recheck}
    if tl["intersect_count"] <= 0 or tl["resident_intersect"]["vs_rows"] <= 0:
        raise RuntimeError(f"query_serve: B1 or B3 never launched {tl}")
    # the same service, profiled over further queries: device split
    args_p = type(args)(**{**vars(args), "queries": QS_PROFILED_QUERIES,
                           "seed": args.seed + 1})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        served_p, _ = counted("profiled", lambda: query_serve.closed_loop(
            args_p, svc, on_results=check))
        prof_s = time.perf_counter() - t0
    rows = kernel_rows(prof, torch)
    by_kernel = {k: sum(r["device_ms"] for r in rows if k in r["name"])
                 for k in ("intersect_count_kernel",
                           "resident_intersect_kernel")}
    busy_ms = sum(r["device_ms"] for r in rows)
    if busy_ms > prof_s * 1e3:
        raise RuntimeError(f"query_serve: device busy {busy_ms} ms exceeds "
                           f"the profiled window {prof_s * 1e3} ms")
    timed["profiled"] = {
        "queries": served_p, "checked": sum(check.by_kind.values()) - served,
        "seconds": prof_s, "device_ms": {
            "busy": busy_ms, **by_kernel},
        "idle_share": 1.0 - busy_ms / (prof_s * 1e3),
        "launches": launches["profiled"], "top_device_kernels": rows[:8]}
    del prof
    t0 = time.perf_counter()
    svc.verify()  # the stream bit-exact vs a recount, no stale cached row
    timed["verify_s"] = time.perf_counter() - t0
    timed["triangles"] = svc.triangle_count
    rec["timed"] = timed
    del svc, w, srec, check
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the kernel route against the plain route, bit for bit
    args_d = query_serve.parse_args(QS_ROUTES_ARGV + ["--device", "cuda"])
    routes = {}
    for name, use_kernel in (("kernel", None), ("plain", False)):
        w = query_serve.build_service(args_d, dev, use_kernel=use_kernel)
        svc = w.svc
        answers = []
        t0 = time.perf_counter()
        counted(name, lambda: query_serve.closed_loop(
            args_d, svc, on_results=lambda r: answers.extend(
                answers_of(r, np))))
        eng = svc.engine
        routes[name] = {
            "seconds": time.perf_counter() - t0, "answers": answers,
            "t": svc.stream.t.tolist(), "lcc": svc.stream.lcc.tolist(),
            "provider": dc.asdict(svc.provider.stats),
            "tier": dc.asdict(svc.runtime.merged_device_stats()),
            "pairs": [eng.n_pairs_raw, eng.n_pairs_total,
                      eng.n_pairs_resident, eng.host_pack_bytes]}
        if name == "kernel":
            svc.verify()
        del svc, w
    k_r, p_r = routes["kernel"], routes["plain"]
    for key in ("answers", "t", "lcc", "provider", "tier", "pairs"):
        if k_r[key] != p_r[key]:
            raise RuntimeError(f"query_serve: kernel route != plain route "
                               f"in {key}")
    kl, pl = launches["kernel"], launches["plain"]
    if kl["intersect_count"] <= 0 or kl["resident_intersect"]["vs_rows"] <= 0:
        raise RuntimeError(f"query_serve: kernel route launched {kl}")
    if pl["intersect_count"] or any(pl["resident_intersect"].values()):
        raise RuntimeError(f"query_serve: plain route launched {pl}")
    rec["routes"] = {
        "argv": " ".join(QS_ROUTES_ARGV), "queries": len(k_r["answers"]),
        "kernel_route_equals_plain_route": True,
        "seconds": {"kernel": k_r["seconds"], "plain": p_r["seconds"]},
        "pairs": k_r["pairs"], "launches": kl}
    path = {"intersect_count": 0, "resident_intersect": {}}
    for tag in ("verified", "ranks", "open_loop", "timed", "profiled",
                "kernel"):
        path["intersect_count"] += launches[tag]["intersect_count"]
        for k, n in launches[tag]["resident_intersect"].items():
            path["resident_intersect"][k] = \
                path["resident_intersect"].get(k, 0) + n
    rec["launches"] = launches
    rec["max_abs_err"] = recheck_err
    return rec, path


class SpmdRecorder:
    """Wraps the SPMD executor's two device programs as it calls them
    (``kernels/spmd_plane.py``'s ``serve_landing`` and
    ``pair_counts_landed``, read from the module at every unit; a unit is a
    pair call and the serve call whose landing it reads, if any): counts
    calls, and holds each unit against the plain versions at tolerance 0:
    the landing against ``serve_block_ref``'s block (gathered at the
    landing's positions, the rest of the block the sentinel: no second
    block is built), the counts against ``pair_counts_ref`` on that block,
    and the block kernels (``serve_block``, ``pair_counts``) on the same
    inputs. ``mode`` says when: ``"inline"`` right after the launch (it
    synchronises; before any later patch of the buffer), for a unit at
    least 1.5x the largest one checked in this run, at most
    ``SPMD_CHECKS_PER_RUN`` a run, or every unit with ``check_all``;
    ``"clone"`` copies the largest unit's inputs and outputs on the device
    (no synchronisation) and ``flush()`` checks it after the run; ``"off"``
    only counts. A check also times every kernel (CUDA events from Python,
    and on the device alone in a CUDA graph), the plain versions, B5's
    library composite and, when a parent checkout's ``spmd_plane.cu`` was
    built (``PARENT``), the parent's pair-count kernel on the block, with
    bounds; the launches it adds are kept in ``extra`` and are not the
    path's."""

    NAMES = ("serve_landing", "pair_counts_landed")

    def __init__(self, sp, np, torch):
        self.sp, self.np, self.torch = sp, np, torch
        self.orig = {k: getattr(sp, k) for k in self.NAMES}
        self.extra = dict.fromkeys(sp.launches(), 0)
        self.checks = []
        self.max_abs_err = 0
        self.run("off")

    def run(self, tag, mode="off", check_all=False):
        self.tag, self.mode, self.check_all = tag, mode, check_all
        self.done = []
        self.kept = None
        self.serving = None  # the serve call whose landing is not read yet
        self.calls = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        sp = self.sp

        def serve(rows, serve_idx, serve_len, land_off, serve_cfg, n_ids, *,
                  items):
            out = self.orig["serve_landing"](rows, serve_idx, serve_len,
                                             land_off, serve_cfg, n_ids,
                                             items=items)
            self.calls["serve_landing"] += 1
            self.serving = ((serve_idx, serve_len, list(serve_cfg),
                             int(n_ids), items), out)
            return out

        def pairs(rows, landing, land_off, *lists, pair_cfg, sentinel,
                  real):
            out = self.orig["pair_counts_landed"](
                rows, landing, land_off, *lists, pair_cfg=pair_cfg,
                sentinel=sentinel, real=real)
            self.calls["pair_counts_landed"] += 1
            served = self.serving
            self.serving = None
            unit = {"rows": rows, "landing": landing, "land_off": land_off,
                    "lists": lists, "real": real, "pair_cfg": list(pair_cfg),
                    "sentinel": sentinel, "out": out,
                    "serve": (served[0] if served is not None
                              and served[1] is landing else None)}
            self._seen(unit, out.numel() * rows.shape[2])
            return out

        sp.serve_landing, sp.pair_counts_landed = serve, pairs
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.sp, k, fn)

    def _seen(self, unit, size):
        if self.mode == "inline":
            last = self.done[-1] if self.done else 0
            if self.check_all or (size >= 1.5 * last
                                  and len(self.done) < SPMD_CHECKS_PER_RUN):
                self.done.append(size)
                self.check(unit)
        elif self.mode == "clone":
            if self.kept is None or size > self.kept[0]:
                def copy(x):
                    if isinstance(x, (tuple, list)):
                        return type(x)(copy(y) for y in x)
                    return x.clone() if hasattr(x, "clone") else x
                self.kept = (size, {k: copy(v) for k, v in unit.items()})

    def flush(self):
        """Check the unit kept in ``"clone"`` mode; free it."""
        if self.kept is not None:
            self.check(self.kept[1])
        self.kept = None

    def _err(self, name, got, want):
        torch = self.torch
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"spmd: {name} output {got.dtype} "
                               f"{tuple(got.shape)} vs {tuple(want.shape)}")
        err = 0
        if not torch.equal(got, want):  # tolerance 0; the size of the miss
            flat_o, flat_w = got.reshape(-1), want.reshape(-1)
            step = 1 << 26
            err = max(int((flat_o[i: i + step].long()
                           - flat_w[i: i + step].long()).abs().max())
                      for i in range(0, flat_o.numel(), step))
        self.max_abs_err = max(self.max_abs_err, err)
        if err:
            raise RuntimeError(f"spmd ({self.tag}): {name} kernel != plain "
                               f"version (err {err})")
        return err

    def _landing_err(self, block, landing, land_off, sentinel):
        """The landing against the block, without a second block: the
        block gathered at the landing's positions equals it, and the block
        holds no other id (its count of non-sentinel entries is the
        landing's)."""
        torch, sp = self.torch, self.sp
        p, f_rows, w = block.shape
        lens = land_off[:, 1:] - land_off[:, :-1]
        n = landing.numel()
        rows_of = (torch.arange(p, device=block.device)[:, None] * f_rows
                   + torch.arange(f_rows, device=block.device)[None, :])
        gathered = block.view(-1)[sp.flat_spans(rows_of * w, lens, n)]
        err = self._err("serve_landing", landing, gathered)
        ids = sum(int((block[j] != sentinel).sum()) for j in range(p))
        if ids != n:
            raise RuntimeError(f"spmd ({self.tag}): the block holds {ids} "
                               f"ids, the landing {n}")
        return err

    def check(self, unit):
        torch, sp = self.torch, self.sp
        from repro_torch.kernels.bucketing import pow2_ceil
        from repro_torch.launch.bag_timing import graph_ms

        torch.cuda.synchronize()
        before = sp.launches()
        rows, landing, land_off = (unit["rows"], unit["landing"],
                                   unit["land_off"])
        lists, real, sent = unit["lists"], unit["real"], unit["sentinel"]
        kw = {"pair_cfg": unit["pair_cfg"], "sentinel": sent}
        p, h, w = rows.shape
        f_exact = land_off.shape[1] - 1
        mask = lists[4]
        rec = {"run": self.tag, "shape": {
            "rows": list(rows.shape), "landed_rows": f_exact,
            "landed_ids": landing.numel(), "worklist": list(mask.shape),
            "buckets": kw["pair_cfg"], "real_sub_pairs": int(mask.sum()),
            "phantoms": int((~mask).sum())}}
        # B5: the landing, and the block kernel of the reference's layout
        if unit["serve"] is not None:
            serve_idx, serve_len, cfg, n_ids, items = unit["serve"]
            rec["shape"]["rungs"] = cfg
            rec["shape"]["landing_items"] = items.shape[0]
            block = sp.serve_block_ref(rows, serve_idx, cfg, f_exact,
                                       sentinel=sent)
            err = self._landing_err(block, landing, land_off, sent)
            args = (rows, serve_idx, serve_len, land_off, cfg, n_ids)
            kernel = self.orig["serve_landing"]
            nbytes = landing_bytes(rows, serve_idx, serve_len, landing,
                                   items, torch)
            bound, by = bound_ms(nbytes, 0.0)
            rec["serve_landing"] = {
                "err": err,
                "ms": min_ms(lambda: kernel(*args, items=items), reps=20,
                             warmup=3),
                "device_ms": graph_ms(lambda: kernel(*args, items=items),
                                      20),
                "plain_ms": cuda_ms(lambda: sp.serve_landing_ref(*args),
                                    reps=3, warmup=1),
                "library_ms": min_ms(lambda: library_landing(
                    rows, serve_idx, serve_len, land_off, cfg, n_ids,
                    torch), reps=5, warmup=1),
                "bytes": nbytes, "bound_ms": bound, "bound_by": by}
            # the parent's B5 (its source unchanged): the whole block at the
            # executor's capacity, pow2_ceil(f_exact)
            f_pad = pow2_ceil(max(f_exact, 1))
            out = sp.serve_block(rows, serve_idx, cfg, f_pad, sentinel=sent)
            torch.cuda.synchronize()
            err = self._err("serve_block", out[:, :f_exact].contiguous(),
                            block)
            if int((out[:, f_exact:] != sent).sum()):
                raise RuntimeError("spmd: serve_block's tail not sentinel")
            nbytes = serve_bytes(rows, serve_idx, cfg, out, torch)
            del out
            bound, by = bound_ms(nbytes, 0.0)
            rec["serve_block"] = {
                "err": err, "f_pad": f_pad,
                "ms": min_ms(lambda: sp.serve_block(
                    rows, serve_idx, cfg, f_pad, sentinel=sent), reps=5,
                    warmup=1),
                "plain_ms": cuda_ms(lambda: sp.serve_block_ref(
                    rows, serve_idx, cfg, f_pad, sentinel=sent), reps=1,
                    warmup=0),
                "library_ms": cuda_ms(lambda: library_block(
                    rows, serve_idx, cfg, f_pad, sent, torch), reps=3,
                    warmup=1),
                "bytes": nbytes, "bound_ms": bound, "bound_by": by}
        else:  # no serve traffic: the empty landing
            block = rows.new_full((p, 0, w), sent)
        # B6: on the landing (the path's), and on the block
        want = sp.pair_counts_ref(rows, block, *lists, **kw)
        out = unit["out"]
        if int(out[~mask].abs().sum()):
            raise RuntimeError("spmd: a phantom position counted")
        if not torch.equal(real.long(),
                           torch.nonzero(mask.reshape(-1)).reshape(-1)):
            raise RuntimeError("spmd: the real list is not the mask's")
        nbytes = pair_bytes(rows, f_exact, *lists, real, torch)
        ops = pair_ops(lists[2][mask], lists[3][mask], torch)
        bound, by = bound_ms(nbytes, ops)
        kernel = self.orig["pair_counts_landed"]
        args = (rows, landing, land_off, *lists)
        rec["pair_counts_landed"] = {
            "err": self._err("pair_counts_landed", out, want),
            "ms": min_ms(lambda: kernel(*args, **kw, real=real), reps=20,
                         warmup=3),
            "device_ms": graph_ms(lambda: kernel(*args, **kw, real=real), 20),
            "plain_ms": cuda_ms(lambda: sp.pair_counts_landed_ref(
                *args, **kw), reps=1, warmup=0),
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "bound_ms": bound, "bound_by": by}
        blk_args = (rows, block, *lists)
        got = sp.pair_counts(*blk_args, **kw, real=real)
        rec["pair_counts"] = {
            "err": self._err("pair_counts", got, want),
            "ms": min_ms(lambda: sp.pair_counts(*blk_args, **kw, real=real),
                         reps=20, warmup=3),
            "device_ms": graph_ms(
                lambda: sp.pair_counts(*blk_args, **kw, real=real), 20),
            "plain_ms": cuda_ms(lambda: sp.pair_counts_ref(*blk_args, **kw),
                                reps=1, warmup=0),
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "bound_ms": bound, "bound_by": by}
        parent = PARENT.get("spmd_plane")
        if parent is not None:  # the parent's B6: a warp a position
            launch = parent_pair_counts(parent, rows, block, lists, torch)
            if not torch.equal(launch(), want):
                raise RuntimeError("spmd: the parent's pair_counts differs")
            rec["pair_counts"]["parent_ms"] = min_ms(launch, reps=20,
                                                     warmup=3)
            rec["pair_counts"]["parent_device_ms"] = graph_ms(launch, 20)
        del want, block, got
        torch.cuda.synchronize()
        for k, n in sp.launches().items():
            self.extra[k] += n - before[k]
        self.checks.append(rec)


def parent_pair_counts(lib, rows, block, lists, torch):
    """A call of the parent checkout's B6 kernel (its
    ``spmd_pair_counts_launch``, declared as ``PARENT_PAIR_PARAMS``: a warp
    a worklist position, phantoms included) on the block; returns a
    function that launches it."""
    import ctypes

    fn = lib.spmd_pair_counts_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [ptr] * 8 + [i32] * 4 + [i64, ptr]
    fn.restype = ctypes.c_int
    p, h, w = rows.shape

    def launch():
        out = torch.empty(lists[0].shape, dtype=torch.int32,
                          device=rows.device)
        err = fn(rows.data_ptr(), block.data_ptr(),
                 *(x.data_ptr() for x in lists), out.data_ptr(), p, h,
                 block.shape[1], w, lists[0].shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent pair_counts: cudaError {err}")
        return out
    return launch


def library_landing(rows, serve_idx, serve_len, land_off, serve_cfg, n_ids,
                    torch):
    """The landing by stock torch calls: ``torch.repeat_interleave`` of the
    landed rows' bases (less their offsets), an ``arange`` added, then one
    ``index_select`` of the flattened buffer."""
    p, h, w = rows.shape
    src = torch.arange(p, device=rows.device)[None, :, None]
    bases, lens, off = [], [], 0
    for s_b, _ in serve_cfg:
        slots = serve_idx[:, :, off: off + s_b].transpose(0, 1).long()
        bases.append(((src * h + slots) * w).reshape(p, -1))
        lens.append(serve_len[:, :, off: off + s_b].transpose(0, 1)
                    .reshape(p, -1))
        off += s_b
    shift = torch.cat(bases, 1).reshape(-1) - land_off[:, :-1].reshape(-1)
    idx = torch.repeat_interleave(shift, torch.cat(lens, 1).reshape(-1),
                                  output_size=n_ids)
    idx += torch.arange(n_ids, device=rows.device)
    return torch.index_select(rows.view(-1), 0, idx)


def landing_bytes(rows, serve_idx, serve_len, landing, items,
                  torch) -> float:
    """B5's landing bytes, what the kernel must touch: each distinct
    served row's valid prefix read once, the landing written once, the work
    list (8 B an item) and, for each landed row of nonzero length only (the
    rung padding is never read), its slot, length and offset (16 B)."""
    p, h, _ = rows.shape
    keys = (serve_idx.long() + (torch.arange(p, device=rows.device)
                                * h)[:, None, None]).reshape(-1)
    lens = serve_len.reshape(-1).long()
    live = lens > 0
    keys, lens = keys[live], lens[live]
    uniq, inv = torch.unique(keys, return_inverse=True)
    per = torch.zeros(uniq.numel(), dtype=torch.long, device=rows.device)
    per.scatter_reduce_(0, inv, lens, "amax")
    return (float(per.sum()) * 4 + landing.numel() * 4.0
            + items.shape[0] * 8.0 + keys.numel() * 16.0)


def library_block(rows, serve_idx, serve_cfg, f_pad, sentinel, torch):
    """The fetched block by stock torch calls: one ``index_select`` of a
    rung's rows (at the rung's width) from the flattened buffer in
    requester order, ``F.pad`` to W, ``torch.cat`` with the sentinel tail."""
    import torch.nn.functional as F

    p, h, w = rows.shape
    flat = rows.view(p * h, w)
    base = (torch.arange(p, device=rows.device) * h)[:, None, None]
    parts, off = [], 0
    for s_b, w_b in serve_cfg:
        idx = (serve_idx[:, :, off: off + s_b].long() + base).transpose(0, 1)
        got = torch.index_select(flat[:, :w_b], 0, idx.reshape(-1))
        parts.append(F.pad(got, (0, w - w_b), value=sentinel)
                     .view(p, p * s_b, w))
        off += s_b
    n_rows = sum(x.shape[1] for x in parts)
    parts.append(rows.new_full((p, f_pad - n_rows, w), sentinel))
    return torch.cat(parts, 1)


def serve_bytes(rows, serve_idx, serve_cfg, out, torch) -> float:
    """B5's bytes: each distinct served row read once at its rung's width,
    the slot list, the block written once."""
    p, h, _ = rows.shape
    base = (torch.arange(p, device=rows.device) * h)[:, None, None]
    total, off = 0.0, 0
    for s_b, w_b in serve_cfg:
        keys = serve_idx[:, :, off: off + s_b].long() + base
        total += float(torch.unique(keys).numel()) * w_b * 4
        off += s_b
    return total + serve_idx.numel() * 4.0 + out.numel() * 4.0


def pair_bytes(rows, f_rows, a_idx, b_idx, a_len, b_len, mask, real,
               torch) -> float:
    """B6's bytes, what the kernel must touch: the ``real`` list and the
    two lengths at each real position (12 B; the phantoms are never read);
    where both lengths are nonzero, the two indices (8 B), each distinct
    row read once over its valid length and the offset (8 B) of each
    distinct fetched one; the counts written whole (``f_rows`` fetched rows
    a rank)."""
    p, h, _ = rows.shape
    stride = h + f_rows
    live = mask & (a_len > 0) & (b_len > 0)
    rank = torch.arange(p, device=rows.device)[:, None] * stride
    keys = torch.cat([(a_idx.long() + rank)[live], (b_idx.long() + rank)[live]])
    lens = torch.cat([a_len[live], b_len[live]]).long()
    uniq, inv = torch.unique(keys, return_inverse=True)
    per = torch.zeros(uniq.numel(), dtype=torch.long, device=rows.device)
    per.scatter_reduce_(0, inv, lens, "amax")
    n_fetched = int(((uniq % stride) >= h).sum())
    return (float(per.sum()) * 4 + n_fetched * 8.0 + real.numel() * 12.0
            + int(live.sum()) * 8.0 + a_idx.numel() * 4.0)


def spmd_edge_units(dev, np, torch, recorder):
    """The executor on the card over units built to reach B5 and B6's
    edges, every unit checked (``SpmdRecorder`` inline, check_all): the
    empty unit (no launch), pairs with no serve traffic (the empty landing,
    no B5), a buffer narrower than the ladder (W = 32: the rungs and
    buckets clipped to it), phantom positions at the pad slot, rows of
    length 0, and a p = 8 unit whose every row ships. The executor launches
    the landed route's kernels and never the block's (the launches of the
    recorder's checks set apart). Returns what each unit exercised."""
    from repro_torch.core.partition import partition_1d
    from repro_torch.distributed import spmd_runtime as spmd
    from repro_torch.kernels import spmd_plane as sp

    rng = np.random.default_rng(20)
    out = []

    class Rows:
        def __init__(self, rows):
            self.rows = rows

        def row(self, v):
            return self.rows[int(v)]

    for name, p, n, hi, ship in (("no_serve", 4, 256, 30, False),
                                 ("clipped_w32", 4, 256, 30, True),
                                 ("all_shipped", 8, 4096, 600, True)):
        rows = {v: np.sort(rng.choice(n, int(rng.integers(0, hi)),
                                      replace=False)).astype(np.int32)
                for v in range(n)}
        part = partition_1d(n, p)
        ex = spmd.SpmdIntersectExecutor(part, n, device=dev)
        shards = []
        for j in range(p):
            a = rng.integers(0, n, 48).astype(np.int64)
            b = rng.integers(0, n, 48).astype(np.int64)
            if not ship:  # every row held where it is read
                held = {int(v): rows[int(v)] for v in np.concatenate([a, b])}
                fetched = []
            else:
                ids = np.unique(np.concatenate([a, b]))
                own = part.owner(ids) == j
                held = {int(v): rows[int(v)] for v in ids[own]}
                fetched = [int(v) for v in ids[~own]]
            shards.append(spmd.ShardWork(j, a, b, held, fetched))
        before, extra = sp.launches(), dict(recorder.extra)
        counts, unit = ex.run(shards, Rows(rows))
        want = [np.array([np.intersect1d(rows[int(x)], rows[int(y)]).size
                          for x, y in zip(s.pair_a, s.pair_b)], np.int64)
                for s in shards]
        if not all(c.dtype == np.int64 and np.array_equal(c, w)
                   for c, w in zip(counts, want)):
            raise RuntimeError(f"spmd edge unit {name}: wrong counts")
        got = {k: sp.launches()[k] - before[k]
               - (recorder.extra[k] - extra[k]) for k in before}
        if (got["pair_counts_landed"] < 1
                or (got["serve_landing"] > 0) != ship
                or got["serve_block"] or got["pair_counts"]):
            raise RuntimeError(f"spmd edge unit {name}: launches {got}")
        out.append({"unit": name, "p": p, "W": ex._buf.w, "H": ex._buf.h,
                    "rungs_clipped_to_W": ex._pair_widths(ex._buf.w),
                    "rows_shipped": unit.total_rows,
                    "serve_launched": got["serve_landing"] > 0})
    ex = spmd.SpmdIntersectExecutor(partition_1d(16, 2), 16, device=dev)
    z = np.zeros(0, np.int64)
    before = sp.launches()
    counts, unit = ex.run([spmd.ShardWork(k, z, z, {}) for k in range(2)],
                          Rows({}))
    if sp.launches() != before or any(c.size for c in counts):
        raise RuntimeError("spmd: the empty unit launched or counted")
    out.append({"unit": "empty", "launches": 0})
    return out


def phase_spmd(dev, np, torch, stream_loop, qs_loop):
    """The SPMD data plane (``distributed/spmd_runtime.py``) on the card,
    B5 and B6 on its path: (a) both kernels against their plain versions,
    tolerance 0, on units captured from the runs below (the largest S14
    stream unit; the S12 hub partition's units with split hubs; an S16
    query microbatch) and on edge units, each timed beside its plain
    version, its bound and (B5) a library composite; (b) ``stream_run``
    with ``--spmd --pipeline`` at ``STREAM_ARGV``, every ``BatchResult``,
    ``t`` and ``lcc`` equal to phase ``stream``'s loop run of the same seed
    (``stream_loop``), verified against a recount, the ledger's pairs equal
    the engine's; (c) ``query_serve``: S12 ``--ranks 8 --spmd --pipeline
    --verify``, S12 ``--partition hub --ranks 8 --spmd --verify``, and S16
    at ``QS_TIMED_ARGV --spmd --pipeline`` (``SPMD_QS_QUERIES``, every
    answer checked, the spans of ``obs/trace.py`` summed by name) beside
    the loop route at the same argv, phase ``query_serve``'s (c)
    (``qs_loop``), then
    one more window of the S16 SPMD service with its units checked and its
    cached and resident rows audited against the store; (d) the
    first ``SPMD_SYNC_UNITS`` units of (c)'s first run dispatched under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns (phase record,
    {kernel: path launches}, the recorder)."""
    import dataclasses as dc

    from repro_torch.distributed import spmd_runtime as spmd
    from repro_torch.kernels import spmd_plane as sp
    from repro_torch.launch import query_serve, stream_run
    from repro_torch.obs import trace as obs_trace

    rec = {"phase": "spmd"}
    launches = {}
    recorder = SpmdRecorder(sp, np, torch)

    def counted(tag, fn):
        sp.reset_launches()
        extra0 = dict(recorder.extra)
        out = fn()
        torch.cuda.synchronize()
        launches[tag] = {k: n - (recorder.extra[k] - extra0[k])
                         for k, n in sp.launches().items()}
        # the landed route's kernels run; the block's never do
        if (min(launches[tag][k] for k in SpmdRecorder.NAMES) <= 0
                or launches[tag]["serve_block"]
                or launches[tag]["pair_counts"]):
            raise RuntimeError(f"spmd ({tag}): launches {launches[tag]}")
        return out

    with recorder:
        # (a) edge units
        recorder.run("edge_units", "inline", check_all=True)
        rec["edge_units"] = spmd_edge_units(dev, np, torch, recorder)

        # (b) the stream, SPMD and pipelined, against phase stream's run
        recorder.run("stream_s14", "clone")
        run = {}
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        rc = counted("stream", lambda: stream_run.main(
            STREAM_ARGV + ["--spmd", "--pipeline"], result=run))
        if rc != 0:
            raise RuntimeError(f"spmd stream_run.main returned {rc}")
        peak = torch.cuda.max_memory_allocated()
        eng = run["engine"]
        got = [dc.asdict(b) for b in run["batches"]]
        if got != stream_loop["batches"]:
            raise RuntimeError("spmd stream: a BatchResult differs from the "
                               "loop run's")
        if not (np.array_equal(eng.t, stream_loop["t"])
                and np.array_equal(eng.lcc, stream_loop["lcc"])
                and eng.t.dtype == stream_loop["t"].dtype
                and eng.lcc.dtype == stream_loop["lcc"].dtype):
            raise RuntimeError("spmd stream: t / lcc differ from the loop "
                               "run's")
        eng.verify()
        led = eng.spmd.ledger
        if led.n_pairs != eng.delta_pairs_total or led.n_collectives <= 0:
            raise RuntimeError(f"spmd stream: ledger pairs {led.n_pairs} vs "
                               f"{eng.delta_pairs_total} delta pairs")
        if eng.spmd.audit_resident(eng.store) != 0:
            raise RuntimeError("spmd stream: stale resident rows")
        rec["stream"] = {
            "argv": " ".join(STREAM_ARGV + ["--spmd", "--pipeline"]),
            "seconds": time.perf_counter() - t0,
            "batch_wall_s": run["wall_s"],
            "updates_per_s": eng.n_updates / run["wall_s"],
            "loop_updates_per_s": stream_loop["updates_per_s"],
            "equals_loop_run": True, "verified": True,
            "ledger": led.to_dict(),
            "ledger_pairs_equal_delta_pairs": True,
            "buffer": {"H": eng.spmd._buf.h, "W": eng.spmd._buf.w},
            "peak_bytes": peak, "calls": recorder.calls,
            "launches": launches["stream"]}
        del run, eng
        recorder.flush()  # the largest unit of each kernel, checked now

        # (c) query serving; (d) on the first run's first units
        sync_units = []
        real_dispatch = spmd.SpmdIntersectExecutor.dispatch

        def strict_dispatch(ex, shards, store):
            if len(sync_units) >= SPMD_SYNC_UNITS:
                return real_dispatch(ex, shards, store)
            torch.cuda.set_sync_debug_mode("error")
            try:
                pend = real_dispatch(ex, shards, store)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync_units.append({"pairs": int(pend.unit.n_pairs),
                               "rows_shipped": pend.unit.total_rows,
                               "patches": int(pend.unit.n_patches)})
            return pend

        def serve(tag, argv):
            res = {}
            t0 = time.perf_counter()
            lines = counted(tag, lambda: run_launcher(
                query_serve.main, argv + ["--device", "cuda"], res))
            out = served_summary(res, lines)
            if not any("EXACT match" in ln for ln in lines):
                raise RuntimeError(f"spmd {tag}: measured != modeled")
            out.update(argv=" ".join(argv), seconds=time.perf_counter() - t0,
                       launches=launches[tag],
                       ledger=res["svc"].engine.spmd.ledger.to_dict())
            return out

        recorder.run("qs_s12_ranks8", "off")
        spmd.SpmdIntersectExecutor.dispatch = strict_dispatch
        try:
            rec["qs_s12_ranks8"] = serve("qs_s12_ranks8", QS_VERIFY_ARGV + [
                "--ranks", "8", "--queries", str(QS_RANKS_QUERIES),
                "--spmd", "--pipeline"])
        finally:
            spmd.SpmdIntersectExecutor.dispatch = real_dispatch
        if len(sync_units) < SPMD_SYNC_UNITS:
            raise RuntimeError(f"spmd: only {len(sync_units)} units under "
                               "the sync check")
        rec["dispatch_without_sync"] = {"units": sync_units,
                                        "mode": "set_sync_debug_mode(error)"}

        frags = []
        real_ensure = spmd._ResidentShardBuffer.ensure

        def count_frags(buf, needed, unit, keep):
            frags.append(sum(key > buf.sentinel for d in needed for key in d))
            return real_ensure(buf, needed, unit, keep)

        recorder.run("qs_s12_hub", "inline")
        spmd._ResidentShardBuffer.ensure = count_frags
        try:
            rec["qs_s12_hub"] = serve("qs_s12_hub", SPMD_HUB_ARGV)
        finally:
            spmd._ResidentShardBuffer.ensure = real_ensure
        if sum(frags) <= 0:
            raise RuntimeError("spmd hub run: no split hub fragment shipped")
        rec["qs_s12_hub"]["fragment_keys_resident"] = sum(frags)

        # S16: the SPMD route; the loop route at the same argv but --spmd
        # is phase query_serve's (c) (``qs_loop``), not built again here
        recorder.run("qs_s16", "off")
        rec["qs_s16"] = {}
        argv = QS_TIMED_ARGV + ["--queries", str(SPMD_QS_QUERIES),
                                "--spmd", "--pipeline"]
        args = query_serve.parse_args(argv + ["--device", "cuda"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        w = query_serve.build_service(args, dev)
        svc = w.svc
        build_s = time.perf_counter() - t0
        check = AnswerCheck(svc, np)
        tracer = obs_trace.enable_tracing()  # spans: where time goes
        t0 = time.perf_counter()
        loop = lambda: query_serve.closed_loop(  # noqa: E731
            args, svc, rebalancer=w.rebalancer, on_results=check)
        try:
            served, n_updates = counted("qs_s16", loop)
            torch.cuda.synchronize()
        finally:
            obs_trace.disable_tracing()
        wall = time.perf_counter() - t0 - check.seconds
        if served < args.queries or sum(check.by_kind.values()) != served:
            raise RuntimeError(f"spmd s16: {served} served, "
                               f"{check.by_kind} checked")
        lat = svc.scheduler.latency_summary()
        out = {"argv": " ".join(argv), "build_s": build_s,
               "served": served, "updates": n_updates,
               "checked": dict(check.by_kind), "wall_s": wall,
               "qps_end_to_end": served / wall,
               "qps_in_engine": lat.throughput_qps,
               "p50_ms": lat.p50_ms, "p99_ms": lat.p99_ms,
               "max_ms": lat.max_ms,
               "microbatches": svc.scheduler.n_batches,
               "peak_bytes_beyond_start":
                   torch.cuda.max_memory_allocated() - base,
               "span_seconds": {
                   k: v["total_s"]
                   for k, v in tracer.phase_totals().items()}}
        ex = svc.engine.spmd
        led = ex.ledger
        a2a = [ev.get("args") or {} for ev in tracer.events
               if ev.get("name") == "all_to_all"]
        # the landing holds each shipped row's ids once: its
        # bytes are the payload's, unit by unit
        out["landed_bytes"] = sum(a["landed_bytes"] for a in a2a)
        out["landed_bytes_max_unit"] = max(
            (a["landed_bytes"] for a in a2a), default=0)
        if any(a["landed_bytes"] != a["payload_bytes"] for a in a2a):
            raise RuntimeError("spmd s16: landed bytes != payload")
        modeled = svc.runtime.serve_rows
        if not np.array_equal(led.rows_shipped, modeled):
            raise RuntimeError("spmd s16: measured != modeled")
        out["ledger"] = led.to_dict()
        out["measured_equals_modeled"] = True
        out["buffer"] = {"H": ex._buf.h, "W": ex._buf.w,
                         "f_pad": ex._f_hw}
        out["calls"] = dict(recorder.calls)
        out["launches"] = launches["qs_s16"]
        # one more window on the same service, its units checked
        recorder.run("qs_s16_window", "inline")
        args_c = type(args)(**{**vars(args), "queries": 64,
                               "seed": args.seed + 1,
                               "write_frac": 0.0})
        counted("qs_s16_window", lambda: query_serve.closed_loop(
            args_c, svc, on_results=check))
        out["checked_window_calls"] = dict(recorder.calls)
        # no stale cached or resident row (the S16 stream's recount
        # is phase query_serve's; the answers were checked above)
        cached, stale = svc.runtime.audit_freshness()
        stale_resident = ex.audit_resident(svc.store)
        if stale or stale_resident:
            raise RuntimeError(f"spmd s16: {stale} stale cached, "
                               f"{stale_resident} stale resident rows")
        out["audited_rows"] = {"cached": cached,
                               "resident": sum(map(len,
                                                   ex._buf.slot_of))}
        rec["qs_s16"]["spmd"] = out
        del svc, w, check
    rec["qs_s16"]["loop"] = {
        "from": "phase query_serve (c): the same argv without --spmd",
        **{k: qs_loop[k] for k in (
            "argv", "build_s", "served", "updates", "wall_s",
            "qps_end_to_end", "qps_in_engine", "p50_ms", "p99_ms", "max_ms",
            "microbatches", "peak_bytes_beyond_start")}}
    rec["launches"] = launches
    rec["max_abs_err"] = recorder.max_abs_err
    rec["checks"] = recorder.checks
    path = dict.fromkeys(sp.launches(), 0)
    for n in launches.values():
        for k in path:
            path[k] += n[k]
    return rec, path, recorder


SPMD_KERNELS = (  # name, id, the reference body it replaces, its line
    ("serve_landing", "B5", "_body_serve", 457),
    ("serve_block", "B5", "_body_serve", 457),
    ("pair_counts_landed", "B6", "_body_pairs", 500),
    ("pair_counts", "B6", "_body_pairs", 500))


def spmd_kernel_rows(rec, launches, recorder):
    """The kernels-line entries of B5 and B6 (the landed route's and the
    block's entry points): times, plain-version and library times and
    bound of the S16 window's largest checked unit (of the largest checked
    unit if none), every check beside them."""
    rows = []
    for name, kid, body, ref_line in SPMD_KERNELS:
        checks = [c for c in recorder.checks if name in c]
        s16 = [c for c in checks if c["run"] == "qs_s16_window"]
        top = max(s16 or checks, key=lambda c: c[name]["bytes"])
        rows.append({
            "name": name, "id": kid, "route": "cuda", "ok": True,
            "source": "src/repro_torch/kernels/csrc/spmd_plane.cu",
            "replaces": f"src/repro/distributed/spmd_runtime.py:{ref_line}",
            "replaces_note": f"{body}, a shard_map program of the SPMD "
                             "data plane; no pallas_call" + (
                                 "" if name in SpmdRecorder.NAMES else
                                 "; the reference's layout, off the "
                                 "executor's path"),
            "launches": launches[name],
            "launches_by_run": {t: n[name] for t, n in rec["launches"].items()},
            "max_abs_err": recorder.max_abs_err, "tolerance": 0,
            "shape": top["shape"], "shape_from": top["run"],
            **top[name],
            "library_is": {"serve_landing": "repeat_interleave + "
                                            "index_select of the landing",
                           "serve_block": "index_select + F.pad + cat of "
                                          "the same block"}.get(name),
            "checks": [{"run": c["run"], "shape": c["shape"], **c[name]}
                       for c in checks]})
    return rows


def main() -> int:
    # the timing statistic of every kernel time, shared with the package
    global cuda_ms, min_ms
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import async_engine, triangles
    from repro_torch.core.cache import build_static_degree_cache
    from repro_torch.core.intersect import count_bsearch_torch
    from repro_torch.core.rma import build_sharded_problem
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.kernels import _build, intersect_count as ic, ops
    from repro_torch.kernels import bitmap_popcount as bm
    from repro_torch.kernels import epoch_count as ec
    from repro_torch.kernels import resident_intersect as ri
    from repro_torch.kernels.point_query import batched_pair_counts
    from repro_torch.launch import bag_timing, lcc_run, resident_timing
    from repro_torch.obs.timing import cuda_ms, min_ms

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- env
    smi = nvidia_smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "nvidia_smi": smi})

    # -------------------------------------------------------------- build
    t0 = time.perf_counter()
    parent_started = start_parent_builds(root, _build)
    infos = _build.build_all(LIBRARIES)  # one nvcc per source, in parallel
    parent_libraries = finish_parent_builds(parent_started)
    build_wall = time.perf_counter() - t0
    libraries = []
    for name, info in infos.items():
        regs = re.findall(r"Used (\d+) registers", info.ptxas)
        smem = re.findall(r"(\d+) bytes smem", info.ptxas)
        spills = re.findall(r"(\d+) bytes spill stores", info.ptxas)
        if not regs:
            raise RuntimeError(
                f"no ptxas report in build output of {name}:\n{info.ptxas}")
        libraries.append({
            "name": name, "library": os.path.relpath(info.library, root),
            "seconds": info.seconds, "registers": [int(x) for x in regs],
            "smem_bytes": [int(x) for x in smem] or [0],  # 0 is not printed
            "spill_store_bytes": [int(x) for x in spills]})
    # the tensor-core kernel must contain wgmma: HGMMA in its SASS
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         infos["flash_attention_wgmma"].library],
        capture_output=True, text=True, check=True, timeout=120).stdout
    hgmma = [ln.split(";")[0].split("*/")[-1].strip()
             for ln in sass.splitlines() if "HGMMA" in ln]
    if not hgmma:
        raise RuntimeError("flash_attention_wgmma: no HGMMA in its SASS")
    # B9's flushes: its reduction instructions (a float4 flush is one
    # REDG.E.ADD.F32x4 on sm_90)
    b9_sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         infos["segment_sum_sorted"].library],
        capture_output=True, text=True, check=True, timeout=120).stdout
    emit({"phase": "build", "wall_s": build_wall, "libraries": libraries,
          "parent_libraries": parent_libraries,
          "segment_sum_sorted_reductions": sorted(set(re.findall(
              r"\b(?:RED|ATOM)G?\.[\w.]+", b9_sass))),
          "flash_attention_wgmma_sass": {
              "hgmma_instructions": len(hgmma),
              "kinds": sorted({ln.split()[0] + (" tnspB" if "tnspB" in ln
                                                 else "") for ln in hgmma}),
              "first": hgmma[0]}})

    # ---------------------------------------------- the full-size problem
    t0 = time.perf_counter()
    csr = rmat_graph(FULL_SCALE, EDGE_FACTOR, seed=0)
    cache = build_static_degree_cache(csr.degrees, CACHE_ROWS)
    prob = build_sharded_problem(csr, RANKS, n_rounds=FULL_ROUNDS, cache=cache)
    schedule_s = time.perf_counter() - t0
    sent, w = prob.sentinel, prob.width
    dprob = prob.to_device(dev)

    def operands(u_glob, v_glob):
        """Device rows of the (u, v) pairs at the engine's width W."""
        ou, lu = global_rows(prob, u_glob, np)
        ov, lv = global_rows(prob, v_glob, np)
        flat = dprob.rows_ext.view(-1, w)
        stride = prob.n_loc + 1
        ia = torch.from_numpy(ou * stride + lu).to(dev)
        ib = torch.from_numpy(ov * stride + lv).to(dev)
        return flat.index_select(0, ia), flat.index_select(0, ib)

    # ------------------------------------------------------------- checks
    rng = np.random.default_rng(0)
    max_abs_err = 0
    checked = []

    def check(tag, a, b, sentinel):
        nonlocal max_abs_err
        got = ops.intersect_count(a, b, sentinel=sentinel)
        torch.cuda.synchronize()
        want = ic.intersect_count_ref(a, b, sentinel=sentinel)
        if got.dtype != torch.int32 or got.shape != want.shape:
            raise RuntimeError(f"{tag}: bad output {got.dtype} {got.shape}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_abs_err = max(max_abs_err, err)
        checked.append({"case": tag, "shape": [a.shape[0], a.shape[1],
                                               b.shape[1]], "err": err})
        if err != 0:
            raise RuntimeError(f"{tag}: kernel != plain version (err {err})")

    ic.reset_launches()
    small_sent = 4096
    for e, wa, wb in [(128, 16, 32), (256, 64, 128), (128, 8, 200),
                      (1, 16, 32), (3, 16, 32), (1000, 16, 32),
                      (64, 16, 0), (64, 16, 1), (64, 0, 16)]:
        a = torch.from_numpy(pad_sorted(rng, e, wa, small_sent, np)).to(dev)
        b = torch.from_numpy(pad_sorted(rng, e, wb, small_sent, np)).to(dev)
        check("random", a, b, small_sent)
    full_a = torch.full((96, 40), small_sent, dtype=torch.int32, device=dev)
    some_b = torch.from_numpy(pad_sorted(rng, 96, 24, small_sent, np)).to(dev)
    check("all_sentinel_a", full_a, some_b, small_sent)
    check("all_sentinel_b", some_b, full_a, small_sent)
    check("all_sentinel_both", full_a, full_a, small_sent)
    check("self", some_b, some_b, small_sent)
    # the serving path's widest buckets
    wide_sent = 1 << 16
    for e, wa, wb in SERVING_WIDE_B1:
        a = torch.from_numpy(pad_sorted(rng, e, wa, wide_sent, np)).to(dev)
        b = torch.from_numpy(pad_sorted(rng, e, wb, wide_sent, np)).to(dev)
        check("serving_wide", a, b, wide_sent)
    # wide: 512 directed edges of the full-size graph whose endpoints have
    # the highest degree sums, at the engine's width
    src, dst = csr.edge_list()
    deg = csr.degrees
    heavy = np.argsort(-(deg[src] + deg[dst]), kind="stable")[:512]
    wa_rows, wb_rows = operands(src[heavy], dst[heavy])
    check("wide_full_graph", wa_rows, wb_rows, sent)
    check_launches = ic.launches()
    ri.reset_launches()
    res_cases, res_err = check_resident_intersect(dev, rng, np, torch)
    res_check_launches = ri.launches()
    bm_cases, bm_err, bm_path_launches = check_bitmap(
        dev, rng, wa_rows, wb_rows, csr.n, sent, np, torch)
    del wa_rows, wb_rows, full_a, some_b
    fl_cases, fl_err, fl_check_launches = check_flash(dev, rng, np, torch)
    bag_cases, bag_err, bag_check_launches = check_bag(dev, rng, np, torch)
    ss_cases, ss_err, ss_check_launches = check_segment_sum(dev, rng, np,
                                                            torch)
    ep_cases, ep_err, ep_check_launches = check_epoch(dev, dprob, np, torch)
    emit({"phase": "checks", "kernels": [{
        "name": "epoch_count",
        "source": "src/repro_torch/kernels/csrc/epoch_count.cu",
        "entry_points": ["epoch_land", "epoch_count"],
        "ok": True, "cases": ep_cases, "launches": ep_check_launches,
        "max_abs_err": ep_err, "tolerance": 0}, {
        "name": "segment_sum_sorted",
        "source": "src/repro_torch/kernels/csrc/segment_sum_sorted.cu",
        "ok": True, "cases": ss_cases, "launches": ss_check_launches,
        "max_abs_err": ss_err,
        "tolerance": f"per element: atol + rtol * |plain|, atol = rtol = "
                     f"{SEGSUM_TOL}"}, {
        "name": "flash_attention",
        "source": ["src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                   "src/repro_torch/kernels/csrc/flash_attention.cu"],
        "ok": True, "cases": fl_cases, "launches": fl_check_launches,
        "max_abs_err": fl_err,
        "tolerance": f"fp32: atol + rtol * max|plain|, atol = rtol = "
                     f"{FLASH_TOL['float32']}; bf16/fp16 per element: "
                     f"ulp * |plain| + {FLASH_ATOL}, ulp = {FLASH_ULP}"}, {
        "name": "embedding_bag",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "ok": True, "cases": bag_cases, "launches": bag_check_launches,
        "max_abs_err": bag_err,
        "tolerance": f"atol + rtol * max|plain|, atol = rtol = {BAG_TOL}"}, {
        "name": "intersect_count",
        "source": "src/repro_torch/kernels/csrc/intersect_count.cu",
        "ok": True, "cases": checked, "launches": check_launches,
        "max_abs_err": max_abs_err, "tolerance": 0}, {
        "name": "resident_intersect",
        "source": "src/repro_torch/kernels/csrc/resident_intersect.cu",
        "ok": True, "cases": res_cases, "launches": res_check_launches,
        "max_abs_err": res_err, "tolerance": 0}, {
        "name": "bitmap_intersect_count",
        "source": "src/repro_torch/kernels/csrc/bitmap_popcount.cu",
        "ok": True, "cases": bm_cases, "max_abs_err": bm_err,
        "tolerance": 0, "cross_check_launches": bm_path_launches}]})

    # ------------------------------------------ main path: counters to 0
    ic.reset_launches()
    ec.reset_launches()

    # -------------------------------------------------------------- entry
    t0 = time.perf_counter()
    rc = lcc_run.main(["--scale", "12", "--p", "8", "--cache-rows", "256",
                       "--verify"])
    if rc != 0:
        raise RuntimeError(f"lcc_run.main returned {rc}")
    entry_launches = ic.launches()
    entry_epoch = ec.launches()
    emit({"phase": "entry", "argv": "--scale 12 --p 8 --cache-rows 256 "
          "--verify", "rc": rc, "seconds": time.perf_counter() - t0,
          "kernel_launches": {"intersect_count": entry_launches,
                              **entry_epoch}})

    # --------------------------------------------------------------- full
    # the kernel route for two methods, then the padded plain route (the
    # oracle), each epoch's peak memory counted beyond the problem's tensors
    epoch, result, extra_peak = {}, {}, {}
    launches_per_epoch = None
    b1_before_full = ic.launches()

    def timed_epochs(tag, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = ec.launches()
        result[tag] = async_engine.lcc_pipelined(dprob, dev, **kw)
        extra_peak[tag] = torch.cuda.max_memory_allocated() - base
        once = {k: ec.launches()[k] - before[k] for k in before}
        walls = []
        for _ in range(3 if tag != "plain" else 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            async_engine.lcc_pipelined(dprob, dev, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        epoch[tag] = {"median_s": statistics.median(walls), "runs_s": walls}
        return once

    for method in ("hybrid", "pairwise"):
        once = timed_epochs(method, method=method)
        if method == "hybrid":
            launches_per_epoch = once
        if once != {"epoch_land": prob.n_rounds,
                    "epoch_count": prob.n_rounds}:
            raise RuntimeError(f"full: {method} launched {once} in an epoch "
                               f"of {prob.n_rounds} rounds")
    timed_epochs("plain", method="bsearch", plain=True)
    if ic.launches() != b1_before_full:
        raise RuntimeError("full: the epoch launched intersect_count")
    t_p, lcc_p = result["plain"]
    for method in ("hybrid", "pairwise"):
        t_k, lcc_k = result[method]
        if t_k.dtype != np.int32 or lcc_k.dtype != np.float32:
            raise RuntimeError(f"engine dtypes {t_k.dtype} {lcc_k.dtype}")
        if not np.array_equal(t_k, t_p) or not np.array_equal(lcc_k, lcc_p):
            raise RuntimeError(f"full: kernel route ({method}) != plain route")
    if extra_peak["hybrid"] >= 1 << 30:
        raise RuntimeError(f"full: the epoch took {extra_peak['hybrid']} "
                           "bytes beyond the problem (limit 1 GiB)")
    t_k, lcc_k = result["hybrid"]
    if not np.isfinite(lcc_k).all() or lcc_k.min() < 0 or lcc_k.max() > 1:
        raise RuntimeError("full: lcc outside [0, 1]")
    total = int(t_k.astype(np.int64).sum())
    if total % 3 != 0:
        raise RuntimeError(f"full: sum(t) = {total} is not a multiple of 3")

    # host oracle at the smaller scale, against the kernel route
    csr_o = rmat_graph(ORACLE_SCALE, EDGE_FACTOR, seed=0)
    t0 = time.perf_counter()
    t_o, lcc_o = async_engine.run_distributed_lcc(
        csr_o, RANKS, n_rounds=8, cache_rows=CACHE_ROWS, method="hybrid",
        device=dev)
    oracle_engine_s = time.perf_counter() - t0
    want_t = triangles.triangles_per_vertex(csr_o)
    if not np.array_equal(t_o, want_t):
        raise RuntimeError("oracle: engine t != triangles_per_vertex")
    if not np.allclose(lcc_o, triangles.lcc_scores(csr_o, want_t), rtol=1e-5):
        raise RuntimeError("oracle: engine lcc != lcc_scores (rtol 1e-5)")
    full_launches = {k: ec.launches()[k] - entry_epoch[k]
                     for k in entry_epoch}
    full_b1 = ic.launches() - entry_launches
    pulled = prob.pulled_ids_per_round()
    emit({"phase": "full", "scale": FULL_SCALE, "edge_factor": EDGE_FACTOR,
          "n": csr.n, "directed_edges": csr.m, "width": w, "p": RANKS,
          "cache_rows": CACHE_ROWS, "n_rounds": prob.n_rounds,
          "e_chunk": prob.e_max // prob.n_rounds, "s_max": prob.s_max,
          "rows_ext_bytes": int(prob.rows_ext.nbytes),
          "real_edge_slots": int(prob.edge_mask.sum()),
          "edge_slots": int(prob.edge_mask.size),
          "real_serve_slots": int((prob.serve_idx < prob.n_loc).sum()),
          "serve_slots": int(prob.serve_idx.size),
          "landed_bytes_per_epoch": int(pulled.sum()) * 4,
          "landing_ids_max_round": dprob.land_ids,
          "padded_fetch_bytes_per_epoch": int(prob.serve_idx.size) * w * 4,
          "schedule_build_s": schedule_s,
          "triangles": total // 3, "kernel_route_equals_plain_route": True,
          "epoch_wall_s": epoch,
          "plain_over_kernel": {m: epoch["plain"]["median_s"]
                                / epoch[m]["median_s"]
                                for m in ("hybrid", "pairwise")},
          "directed_edges_per_s": {m: csr.m / epoch[m]["median_s"]
                                   for m in epoch},
          "extra_peak_bytes": extra_peak,
          "kernel_launches_per_epoch": launches_per_epoch,
          "kernel_launches": full_launches,
          "intersect_count_launches": full_b1,
          "comm_bytes": int(prob.comm_bytes_per_round().sum()),
          "oracle": {"scale": ORACLE_SCALE, "n": csr_o.n,
                     "directed_edges": csr_o.m, "width": csr_o.max_degree,
                     "method": "hybrid", "exact": True,
                     "engine_s": oracle_engine_s}})

    # -------------------------------------------------------------- pairs
    before = ic.launches()
    pick = np.sort(np.random.default_rng(1).choice(csr.m, N_PAIRS,
                                                   replace=False))
    pu, pv = src[pick], dst[pick]
    ra = [csr.row(int(u)) for u in pu]
    rb = [csr.row(int(v)) for v in pv]
    t0 = time.perf_counter()
    got_kernel = batched_pair_counts(ra, rb, sentinel=sent, use_kernel=True,
                                     device=dev)
    pairs_kernel_s = time.perf_counter() - t0
    pairs_launches = ic.launches() - before
    main_path_launches = ic.launches()  # entry + full + pairs, read here
    main_path_epoch = ec.launches()
    got_host = batched_pair_counts(ra, rb, sentinel=sent, use_kernel=False)
    # the engine's per-edge count: the same kernel on the engine's operands
    # (rows at width W, read from the compiled problem)
    eng = []
    step = max(1, (1 << 30) // (4 * w))
    for lo in range(0, N_PAIRS, step):
        a, b = operands(pu[lo:lo + step], pv[lo:lo + step])
        eng.append(ops.intersect_count(a, b, sentinel=sent).cpu().numpy())
    eng = np.concatenate(eng).astype(np.int64)
    if got_kernel.dtype != np.int64 or got_host.dtype != np.int64:
        raise RuntimeError("pairs: counts must be int64")
    if not (np.array_equal(got_kernel, got_host)
            and np.array_equal(got_kernel, eng)):
        raise RuntimeError("pairs: kernel, host masks and engine disagree")
    emit({"phase": "pairs", "n_pairs": N_PAIRS, "equal": True,
          "sum_counts": int(got_kernel.sum()),
          "use_kernel_seconds": pairs_kernel_s,
          "kernel_launches": pairs_launches})
    for tag, n in (("entry epoch_land", entry_epoch["epoch_land"]),
                   ("entry epoch_count", entry_epoch["epoch_count"]),
                   ("full epoch_land", full_launches["epoch_land"]),
                   ("full epoch_count", full_launches["epoch_count"]),
                   ("pairs intersect_count", pairs_launches)):
        if n <= 0:
            raise RuntimeError(f"{tag}: the kernel was never launched")

    # ------------------------------------- stream: counters to 0, run, read
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import stream_run
    from repro_torch.streaming import incremental

    ic.reset_launches()
    ri.reset_launches()
    bm.reset_launches()
    run = {}
    with CallRecorder(incremental, torch) as rec:
        t0 = time.perf_counter()
        rc = stream_run.main(STREAM_ARGV, result=run)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    stream_launches = {"intersect_count": ic.launches(),
                       "resident_intersect": ri.launches(),
                       "bitmap_intersect_count": bm.launches()}
    if rc != 0:
        raise RuntimeError(f"stream_run.main returned {rc}")
    if stream_launches["intersect_count"] <= 0:
        raise RuntimeError("stream: intersect_count was never launched")
    for variant, n in stream_launches["resident_intersect"].items():
        if n <= 0:
            raise RuntimeError(f"stream: resident_intersect {variant} was "
                               "never launched")
    s_eng = run["engine"]
    s_rt = s_eng.runtime
    s_eng.verify()  # the launcher verified every 4th batch; once more here
    # what phase spmd's SPMD run of the same argv and seed must equal
    stream_loop = {"batches": [dataclasses.asdict(b) for b in run["batches"]],
                   "t": s_eng.t.copy(), "lcc": s_eng.lcc.copy(),
                   "updates_per_s": s_eng.n_updates / run["wall_s"]}
    largest, stream_err = rec.recheck(dev, np)
    ds = s_rt.merged_device_stats()
    stream_out = {
        "phase": "stream", "argv": " ".join(STREAM_ARGV), "rc": rc,
        "seconds": stream_s, "batch_wall_s": run["wall_s"],
        "effective_updates": s_eng.n_updates,
        "updates_per_s": s_eng.n_updates / run["wall_s"],
        "delta_pairs": s_eng.delta_pairs_total,
        "oo_resident_pairs": s_eng.oo_resident_pairs,
        "oo_host_bytes": s_eng.oo_host_bytes,
        "triangles": s_eng.triangle_count,
        "device_tier": {"resident_rows": s_rt.device.resident_rows,
                        "slots": s_rt.device.slots,
                        "max_width": s_rt.device.max_width,
                        "hit_rate": ds.hit_rate,
                        **dataclasses.asdict(ds)},
        "kernel_launches": stream_launches,
        "calls": rec.calls, "pairs": rec.pairs,
        "host_s_in_kernel_calls": rec.seconds,
        "largest_b3_calls": largest,
        "largest_b1_call": rec.largest["delta"][1]}
    del run, s_eng, s_rt, rec
    # the same stream again under torch.profiler, for the device rows only
    # (the throughput above is the unprofiled run's): an engine wired by
    # the launcher's ``build_engine``, its first STREAM_PROFILED_BATCHES
    # batches, then verified against a recount
    args_p = stream_run.parse_args(STREAM_ARGV)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng_p = stream_run.build_engine(args_p, dev)[1]
        wall_p = 0.0
        for i, batch in enumerate(stream_run.batches(args_p)):
            if i == STREAM_PROFILED_BATCHES:
                break
            tb = time.perf_counter()
            eng_p.apply_batch(batch)
            wall_p += time.perf_counter() - tb
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    eng_p.verify()
    prof_rows = kernel_rows(prof, torch)
    by_kernel = {k: sum(r["device_ms"] for r in prof_rows if k in r["name"])
                 for k in ("intersect_count_kernel",
                           "resident_intersect_kernel")}
    busy_ms = sum(r["device_ms"] for r in prof_rows)
    if busy_ms > prof_s * 1e3:
        raise RuntimeError(f"stream: device busy {busy_ms} ms exceeds the "
                           f"profiled window {prof_s * 1e3} ms")
    stream_b3_device_ms = by_kernel["resident_intersect_kernel"]
    stream_out["profiled"] = {
        "batches": STREAM_PROFILED_BATCHES,
        "seconds": prof_s, "batch_wall_s": wall_p,
        "updates_per_s": eng_p.n_updates / wall_p,
        "device_ms": {"busy": busy_ms, **by_kernel},
        "kernel_device_share_of_batch_wall": (
            sum(by_kernel.values()) / (wall_p * 1e3)),
        "idle_share": 1.0 - busy_ms / (prof_s * 1e3),
        "top_device_kernels": prof_rows[:8]}
    del eng_p, prof
    emit({**stream_out, "verified": True})

    # ----------------------------------------------------- stream_routes
    routes_args = [stream_run.parse_args(ROUTES_ARGV),
                   stream_run.parse_args(ROUTES_ARGV + ["--no-kernel"])]
    ic.reset_launches()
    ri.reset_launches()
    t0 = time.perf_counter()
    engines = [stream_run.build_engine(a, dev)[1:] for a in routes_args]
    migrated = 0
    for batch in stream_run.batches(routes_args[0]):
        results = []
        for eng, reb in engines:
            results.append(dataclasses.asdict(eng.apply_batch(batch)))
            plan = reb.maybe_rebalance(eng.store.degrees)
            migrated += 0 if plan is None else plan.n_moved
        (k_eng, _), (p_eng, _) = engines
        if results[0] != results[1]:
            raise RuntimeError(f"stream_routes: batch results differ "
                               f"{results}")
        if not (np.array_equal(k_eng.t, p_eng.t)
                and np.array_equal(k_eng.lcc, p_eng.lcc)):
            raise RuntimeError("stream_routes: kernel route != plain route")
    for eng, _ in engines:
        eng.verify()  # == triangles_per_vertex / lcc_scores of to_csr()
    routes_launches = {"intersect_count": ic.launches(),
                       "resident_intersect": ri.launches()}
    if (routes_launches["intersect_count"] <= 0
            or routes_launches["resident_intersect"]["vs_rows"] <= 0):
        raise RuntimeError(f"stream_routes: a kernel was never launched "
                           f"{routes_launches}")
    emit({"phase": "stream_routes", "argv": " ".join(ROUTES_ARGV),
          "plain_route_argv": "... --no-kernel",
          "seconds": time.perf_counter() - t0,
          "effective_updates": k_eng.n_updates,
          "triangles": k_eng.triangle_count,
          "oo_resident_pairs": k_eng.oo_resident_pairs,
          "rows_migrated": migrated // 2,
          "schedule_rebuilds": k_eng.runtime.schedule_rebuilds,
          "kernel_route_equals_plain_route": True, "verified": True,
          "kernel_launches": routes_launches})
    del engines, k_eng, p_eng

    # ------------------------------------------------------- query_serve
    qs_rec, qs_launches = phase_query_serve(dev, np, torch)
    emit(qs_rec)

    # -------------------------------------------------------------- spmd
    gc.collect()
    torch.cuda.empty_cache()
    spmd_rec, spmd_launches, spmd_checks = phase_spmd(
        dev, np, torch, stream_loop, qs_rec["timed"])
    del stream_loop
    emit(spmd_rec)

    # ------------------------------------------------------------- timing
    # round 0 of the full-size schedule, all ranks, in the engine's slabs
    e_chunk = prob.e_max // prob.n_rounds
    lo_of = np.array([prob.part.lo(k) for k in range(RANKS)], np.int64)
    u_glob = np.full((RANKS, e_chunk), prob.n, np.int64)
    v_glob = np.full((RANKS, e_chunk), prob.n, np.int64)
    for k in range(RANKS):
        u_l, v_g = prob.works[k]
        m = min(e_chunk, u_l.size)
        u_glob[k, :m] = u_l[:m].astype(np.int64) + lo_of[k]
        v_glob[k, :m] = v_g[:m]
    u_glob, v_glob = u_glob.ravel(), v_glob.ravel()
    slab = max(1, async_engine._PAIR_SLAB_BYTES // (4 * w))
    rows_a, rows_b = operands(u_glob[:slab], v_glob[:slab])
    e_t = rows_a.shape[0]
    na = (rows_a < sent).sum(1).to(torch.float64)
    nb = (rows_b < sent).sum(1).to(torch.float64)
    prefix_bytes = float((na.sum() + nb.sum()) * 4 + e_t * 4)
    b1_ops = pair_ops(na, nb, torch)
    bytes_ms = prefix_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = b1_ops / OPS_PER_S * 1e3
    kernel_ms = cuda_ms(
        lambda: ops.intersect_count(rows_a, rows_b, sentinel=sent), reps=20,
        warmup=3)
    bsearch_ms = cuda_ms(
        lambda: count_bsearch_torch(rows_a, rows_b, sent), reps=3)
    plain_ms = cuda_ms(
        lambda: ic.intersect_count_ref(rows_a, rows_b, sentinel=sent), reps=1,
        warmup=0)
    kernel_ms_again = cuda_ms(
        lambda: ops.intersect_count(rows_a, rows_b, sentinel=sent), reps=20,
        warmup=3)
    same = torch.equal(ops.intersect_count(rows_a, rows_b, sentinel=sent),
                       count_bsearch_torch(rows_a, rows_b, sent))
    if not same:
        raise RuntimeError("timing: kernel != count_bsearch_torch")
    del rows_a, rows_b
    ep_t = time_epoch(dprob, np, torch)

    # B3 on the tier's shapes over the full-size graph (launch/
    # resident_timing.py): the 4,096 highest-degree rows resident with
    # their valid lengths; vs_slots in CSR order and shuffled, vs_rows; at
    # the graph's sentinel (ids fit the kernel's bitmap) and at 2^20 (the
    # same ids, too wide for it: every pair searched)
    sh = resident_timing.tier_shapes(csr, dev)
    b3_shapes = {"ids_fit": sh, "wide_ids": resident_timing.widened(sh)}
    # every batch whole, with and without lengths, against
    # count_bsearch_torch on the gathered rows
    b3_check = resident_timing.check(b3_shapes,
                                     resident_timing.bsearch_counts(sh))
    b3_ms = resident_timing.time_batches(b3_shapes)
    b3 = {"check_vs_count_bsearch": b3_check,
          "pairs": resident_timing.shape_stats(
              sh, torch.cuda.get_device_properties(dev).multi_processor_count)}
    kw = {"lengths": sh.lens, "sentinel": sh.sentinel}
    for variant, e_v, run_k, run_p, na, nb, wb, in_bytes in (
        ("vs_slots", sh.sa.shape[0],
         lambda k: ri.resident_intersect(sh.residency, sh.sa[:k],
                                         slots_b=sh.sb[:k], **kw),
         lambda k: ri.resident_intersect_ref(sh.residency, sh.sa[:k],
                                             slots_b=sh.sb[:k], **kw),
         sh.lens[sh.sa.long()], sh.lens[sh.sb.long()], sh.residency.shape[1],
         sh.res_bytes_slots + 8.0 * sh.sa.shape[0]),
        ("vs_rows", sh.sr.shape[0],
         lambda k: ri.resident_intersect(sh.residency, sh.sr[:k],
                                         sh.rows_o[:k], **kw),
         lambda k: ri.resident_intersect_ref(sh.residency, sh.sr[:k],
                                             sh.rows_o[:k], **kw),
         sh.lens[sh.sr.long()], sh.n_other, sh.rows_o.shape[1],
         sh.res_bytes_rows + 4.0 * sh.sr.shape[0]
         + float(sh.n_other.sum()) * 4),
    ):
        k_plain = e_v if variant == "vs_rows" else min(e_v,
                                                       VS_SLOTS_PLAIN_PAIRS)
        ms_k_at_plain = min_ms(lambda: run_k(k_plain))
        ms_p = cuda_ms(lambda: run_p(k_plain), reps=1, warmup=0)
        err = int((run_k(k_plain).long() - run_p(k_plain).long()).abs().max())
        if err:
            raise RuntimeError(f"timing: B3 {variant} kernel != plain")
        ops_v = pair_ops(na, nb, torch)
        bnd, by = bound_ms(in_bytes + 4.0 * e_v, ops_v)
        b3[variant] = {
            "shape": {"residency": list(sh.residency.shape), "E": int(e_v),
                      "WB": int(wb)},
            "ms": b3_ms["ids_fit"][variant],
            "wide_ids_ms": b3_ms["wide_ids"][variant],
            "plain_ms": ms_p, "plain_pairs": int(k_plain),
            "ms_at_plain_pairs": ms_k_at_plain, "err": err,
            "bytes": in_bytes + 4.0 * e_v,
            "per_pair_prefix_bytes": float((na.sum() + nb.sum()) * 4),
            "ops": ops_v,
            "bound_ms": bnd, "bound_by": by}
    b3["vs_slots"]["shuffled_ms"] = b3_ms["ids_fit"]["vs_slots_shuffled"]
    b3["vs_slots"]["wide_ids_shuffled_ms"] = \
        b3_ms["wide_ids"]["vs_slots_shuffled"]
    del sh, b3_shapes

    # B2 on 65,536 edges of the full-size graph packed over [0, n)
    n_words = -(-csr.n // 32)
    ids = csr.adjacencies.astype(np.int64)
    # ids are distinct within a row, so a word's OR is the sum of its bits
    vbm = np.bincount(
        np.repeat(np.arange(csr.n, dtype=np.int64), deg) * n_words + ids // 32,
        weights=np.ldexp(1.0, (ids % 32).astype(np.int32)),
        minlength=csr.n * n_words).astype(np.uint32).reshape(csr.n, n_words)
    pick = np.sort(np.random.default_rng(2).choice(csr.m, BITMAP_PAIRS,
                                                   replace=False))
    words_a = torch.from_numpy(vbm[src[pick]].view(np.int32)).to(dev)
    words_b = torch.from_numpy(vbm[dst[pick]].view(np.int32)).to(dev)
    del vbm
    bm_ms = min_ms(lambda: ops.bitmap_intersect_count(words_a, words_b))
    bm_plain_ms = cuda_ms(
        lambda: bm.bitmap_intersect_count_ref(words_a, words_b), reps=3)
    got_bm = ops.bitmap_intersect_count(words_a, words_b)
    bm_timing_err = int((got_bm.long() - bm.bitmap_intersect_count_ref(
        words_a, words_b).long()).abs().max())
    if bm_timing_err:
        raise RuntimeError("timing: B2 kernel != plain")
    bm_shape = list(words_a.shape)
    bm_bound, bm_by = bound_ms(2.0 * words_a.numel() * 4 + 4.0 * BITMAP_PAIRS,
                               3.0 * words_a.numel())
    del words_a, words_b
    timing = {"phase": "timing", "shape": [e_t, w, w],
              "slabs_per_round": -(-u_glob.size // slab),
              "valid_prefix_bytes": prefix_bytes, "padded_bytes": 2.0 * e_t * w * 4,
              "ops": b1_ops, "kernel_ms": [kernel_ms, kernel_ms_again],
              "count_bsearch_torch_ms": bsearch_ms, "plain_ms": plain_ms,
              "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
              "epoch": ep_t,
              "resident_intersect": b3,
              "bitmap_intersect_count": {
                  "shape": bm_shape, "ms": bm_ms, "plain_ms": bm_plain_ms,
                  "sum_counts": int(got_bm.long().sum()),
                  "bytes": 2.0 * bm_shape[0] * bm_shape[1] * 4 + 4.0 * bm_shape[0],
                  "bound_ms": bm_bound, "bound_by": bm_by}}

    # ------------------- serving: the graph phases' device tensors go first
    del dprob, operands
    gc.collect()
    torch.cuda.empty_cache()
    lm_rec, b8_launches = phase_serve_lm(np, torch)
    emit(lm_rec)
    din_rec, b10_launches, item_table, served = phase_serve_din(np, torch)
    din_table_shape = tuple(item_table.shape)
    emit(din_rec)

    # ------------------------------------------- timing: B8 and B10 rows
    fl = time_flash(np, torch)
    bag = bag_timing.time_shapes(item_table, served)  # B10's shapes

    # ---------- training: the serving tensors go first; counters to 0 in it
    del item_table, served
    gc.collect()
    torch.cuda.empty_cache()
    moe_rec, b8_moe_launches = phase_serve_moe(dev, np, torch)
    emit(moe_rec)
    train_rec, b9_launches = phase_train_gnn(dev, np, torch)
    emit(train_rec)
    emit(phase_train_lm(dev, np, torch))
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase_train_moe(dev, np, torch))
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase_train_din(dev, np, torch))
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------- the port's validator on the port's own artifacts
    emit(phase_validate(torch))

    # ---------------------------------------------------- timing: B9 rows
    segsum = time_segment_sum(dev, np, torch)
    emit({**timing, "flash_attention": fl, "embedding_bag": bag,
          "segment_sum_sorted": segsum})

    # ------------------------------------------------------------ summary
    print(nvidia_smi_line(), flush=True)
    b3_stream = stream_launches["resident_intersect"]
    vs_rows = b3["vs_rows"]
    emit({"kernels": [{
        "name": "intersect_count", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/intersect_count.cu",
        "replaces": "src/repro/kernels/intersect_count.py:49",
        "launches": (main_path_launches + stream_launches["intersect_count"]
                     + qs_launches["intersect_count"]),
        "launches_entry": entry_launches, "launches_full": full_b1,
        "launches_pairs": pairs_launches,
        "launches_stream": stream_launches["intersect_count"],
        "launches_stream_routes": routes_launches["intersect_count"],
        "launches_query_serve": qs_launches["intersect_count"],
        "query_serve_device_ms": qs_rec["timed"]["profiled"]["device_ms"][
            "intersect_count_kernel"],
        "max_abs_err": max(max_abs_err, qs_rec["max_abs_err"]),
        "tolerance": 0,
        "shape": [e_t, w, w],
        "ms": min(kernel_ms, kernel_ms_again), "plain_ms": plain_ms,
        "count_bsearch_torch_ms": bsearch_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}, {
        "name": "epoch_count", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/epoch_count.cu",
        "replaces": "src/repro/core/async_engine.py:83",
        "replaces_note": "the body closure of _shard_body (the compiled "
                         "epoch body, B7); no pallas_call",
        "launches": main_path_epoch["epoch_count"],
        "launches_entry": entry_epoch["epoch_count"],
        "launches_full": full_launches["epoch_count"],
        "launches_per_epoch": launches_per_epoch["epoch_count"],
        "max_abs_err": max(ep_err, ep_t["epoch_count"]["err"]),
        "tolerance": 0, "shape": {
            "p": RANKS, "n_rounds": prob.n_rounds,
            "edge_slots_per_round": RANKS * (prob.e_max // prob.n_rounds),
            "width": w, "method": "hybrid"},
        "ms": ep_t["epoch_count"]["ms_per_epoch"]["hybrid"],
        "ms_is": "per epoch (32 launches)",
        "ms_by_method": ep_t["epoch_count"]["ms_per_epoch"],
        "ms_in_turns_with_parent": ep_t["epoch_count"][
            "hybrid_ms_per_epoch_in_turns"],
        "plain_ms": ep_t["epoch_count"]["plain_ms_per_epoch"],
        "bound_ms": ep_t["epoch_count"]["bound_ms_per_epoch"],
        "bound_by": ep_t["epoch_count"]["bound_by"],
        "library_ms": None}, {
        "name": "epoch_land", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/epoch_count.cu",
        "replaces": "src/repro/core/async_engine.py:63",
        "replaces_note": "the fetch closure of _shard_body (rows_ext "
                         "[serve_idx] + all_to_all); no pallas_call",
        "launches": main_path_epoch["epoch_land"],
        "launches_entry": entry_epoch["epoch_land"],
        "launches_full": full_launches["epoch_land"],
        "launches_per_epoch": launches_per_epoch["epoch_land"],
        "max_abs_err": ep_err, "tolerance": 0,
        "shape": {"p": RANKS, "n_rounds": prob.n_rounds,
                  "serve_slots_per_round": RANKS * RANKS * prob.s_max,
                  "landed_ids": ep_t["landed_ids"]},
        "ms": ep_t["epoch_land"]["ms_per_epoch"],
        "ms_is": "per epoch (32 launches)",
        "plain_ms": ep_t["epoch_land"]["plain_ms_per_epoch"],
        "bound_ms": ep_t["epoch_land"]["bound_ms_per_epoch"],
        "bound_by": ep_t["epoch_land"]["bound_by"],
        "library_ms": None}, {
        "name": "resident_intersect", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/resident_intersect.cu",
        "replaces": "src/repro/kernels/resident_intersect.py:109",
        "launches": (sum(b3_stream.values())
                     + sum(qs_launches["resident_intersect"].values())),
        "launches_stream": b3_stream,
        "launches_stream_routes": routes_launches["resident_intersect"],
        "launches_query_serve": qs_launches["resident_intersect"],
        "query_serve_device_ms": qs_rec["timed"]["profiled"]["device_ms"][
            "resident_intersect_kernel"],
        "max_abs_err": max(res_err, stream_err, qs_rec["max_abs_err"]),
        "tolerance": 0,
        "shape": vs_rows["shape"], "ms": vs_rows["ms"],
        "plain_ms": vs_rows["plain_ms"], "bound_ms": vs_rows["bound_ms"],
        "bound_by": vs_rows["bound_by"], "library_ms": None,
        "on_path_ms": stream_b3_device_ms,
        "on_path_is": "device ms of the B3 launches of the profiled "
                      "pass: the first 4 of the counted run's 16 batches",
        "variants": b3}, {
        "name": "bitmap_intersect_count", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/bitmap_popcount.cu",
        "replaces": "src/repro/kernels/bitmap_popcount.py:40",
        "path": "no caller in the reference besides its op: its path here "
                "is the checks cross-check against intersect_count",
        "launches": bm_path_launches,
        "max_abs_err": bm_err, "tolerance": 0, "shape": bm_shape,
        "ms": bm_ms, "plain_ms": bm_plain_ms, "bound_ms": bm_bound,
        "bound_by": bm_by, "library_ms": None}, {
        "name": "flash_attention", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "launches": b8_launches + sum(b8_moe_launches.values()),
        "launches_serve_lm": b8_launches,
        "launches_serve_moe": b8_moe_launches,
        "max_abs_err": fl_err, "shape": fl["global"]["shape"],
        "ms": fl["global"]["ms"], "plain_ms": fl["global"]["plain_ms"],
        "bound_ms": fl["global"]["bound_ms"],
        "bound_by": fl["global"]["bound_by"],
        "library_ms": fl["global"]["library_ms"],
        "softcap0_ms": fl["global"]["softcap0_ms"],
        "sfu_ops": fl["global"]["sfu_ops"], "sfu_ms": fl["global"]["sfu_ms"],
        "local_layer": fl["local"],
        "variants": {
            "wgmma": {
                "source": "src/repro_torch/kernels/csrc/"
                          "flash_attention_wgmma.cu",
                "takes": "bfloat16, float16 at dh 64, 128",
                "launches": lm_rec["flash_attention_launches_by_variant"][
                    "wgmma"] + sum(b8_moe_launches.values()),
                "check_launches": fl_check_launches["wgmma"],
                "ms": fl["global"]["ms"], "local_ms": fl["local"]["ms"]},
            "fma": {
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "takes": "float32; dh 256",
                "launches": lm_rec["flash_attention_launches_by_variant"][
                    "fma"],
                "check_launches": fl_check_launches["fma"],
                "ms": fl["global"]["fma_ms"],
                "local_ms": fl["local"]["fma_ms"]}}}, {
        "name": "embedding_bag", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:44",
        "path": "no model of the reference calls it: its path here is "
                "bag_fixed on the served DIN batch's history ids",
        "launches": b10_launches,
        "max_abs_err": max(bag_err, bag["served"]["mean_err"],
                           *(bag[k]["err"] for k in bag)),
        "shape": {"table": list(din_table_shape),
                  "ids": bag["serve_bulk"]["ids"]},
        "ms": bag["serve_bulk"]["ms"],
        "plain_ms": bag["serve_bulk"]["plain_ms"],
        "bound_ms": bag["serve_bulk"]["bound_ms"],
        "bound_by": bag["serve_bulk"]["bound_by"],
        "library_ms": bag["serve_bulk"]["library_ms"],
        "served": bag["served"], "rotating": bag["rotating"],
        "ptxas": next(lib for lib in libraries
                      if lib["name"] == "embedding_bag")}, {
        "name": "segment_sum_sorted", "route": "cuda", "ok": True,
        "source": "src/repro_torch/kernels/csrc/segment_sum_sorted.cu",
        "replaces": "src/repro/kernels/segment_sum_sorted.py:47",
        "launches": b9_launches,
        "launches_launcher": {a: r["segment_sum_sorted_launches"]
                              for a, r in train_rec["launcher"].items()},
        "launches_cells": {f"{c['arch']} x {c['cell']}":
                           c["kernel_route"]["segment_sum_sorted_launches"]
                           for c in train_rec["cells"]},
        "max_abs_err": max(ss_err, *(r["err"] for r in segsum.values())),
        "shape": segsum["D64"]["shape"], "ms": segsum["D64"]["ms"],
        "plain_ms": segsum["D64"]["plain_ms"],
        "bound_ms": segsum["D64"]["bound_ms"],
        "bound_by": segsum["D64"]["bound_by"],
        "library_ms": segsum["D64"]["library_ms"],
        "layer1_D100": segsum["D100"], "mace_D640": segsum["mace_D640"],
        "shapes": {k: r for k, r in segsum.items()
                   if k not in ("D64", "D100", "mace_D640")}},
        *spmd_kernel_rows(spmd_rec, spmd_launches, spmd_checks)],
        "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
