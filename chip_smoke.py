"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port (``src/repro_torch``) on one CUDA card and fails unless
every phase holds:

1. device   — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions;
2. build    — every CUDA kernel of the port (membership, intersect,
              varint_encode, varint_decode, flash_attn, moe_gemm,
              segment_spmm, flash_attn_bwd, moe_gemm_bwd,
              segment_spmm_bwd), compiled
              from the repository's sources (one ``nvcc`` per source, all
              started together); each library's ``HGMMA`` and ``UTMALDG``
              instructions counted (``cuobjdump -sass``), and flash_attn's
              and moe_gemm's, forward and backward, must have both;
3. kernels  — each kernel's wrapper against its plain PyTorch version on
              the card, bit-exact, at the test sweep shapes, edge cases and
              the full-scale engine shapes, with its time beside its bound,
              the plain version's and the library yardstick's.  Membership
              runs the back-edge shape twice: on random rows with half its
              queries members (``backedge``), and on the filter's own
              inputs (``backedge_engine``: sentinel-padded windows of the
              full graph's degrees, mostly sentinel), each also beside a
              data-aware bound (``bound_data_ms``: per row the sector of
              its last value and the sectors of its live prefix that its
              queries' searches touch); then both of its paths at K = 1,
              4, 16, 64 and M, which places the constant
              ``ops.ROW_PATH_MIN_K``.  Intersect's bound counts its ``b``
              rows by the same rule.  delta_vlen (the "ids" encoder's
              sizing-only epilogue) at the reference sweep and the
              request lanes; the varint fetch codec's encoders ("ids",
              "rows") and row decoder (compacted and onto the slots) at
              every lane case of ``tests/_codec_cases.py``, then timed at
              the full cell's top capacity (64 request lanes; one
              responder chunk of 16 lanes x 32,768 x 1,780) with no valid
              row (q1) and rows of the full graph's degrees at 1% and
              100% of the slots valid;
4. small    — ``rads_enumerate`` on a small graph, q1..q8: embeddings equal
              the brute-force oracle, every stat equals the port's own CPU
              run, cache on/off conserves fetch bytes, depth 1 == depth 2;
              and the same for bucketed storage with the varint wire;
5. full     — two runs of q1 (stages as CUDA graphs, phase 22) on a
              DBLP-sized power-law graph (310,000
              vertices; com-DBLP has 317,080, see ``SMOKE_N``), each held
              against an independent scipy triangle count, with every
              kernel's launch count read around the run: the main path
              (``sim``, default ``EngineConfig``: dense, raw wire, cache
              on, depth 2), then bucketed storage with the varint wire,
              whose raw-equivalent byte counts must equal the first run's;
              each prints membership's and intersect's launches by shape
              and their device ms estimated from phase 3's per-row times,
              and the varint codec's launches by variant (the
              bucketed/varint run must launch "encode_ids", "encode_rows"
              and "decode_rows").  The main path's run is repeated under
              ``torch.profiler`` through the timed run's
              ``runner_cache`` (a warm call from the escalated
              capacities, replaying the graphs captured there; the timed
              run stays unprofiled): the
              card's busy time, idle share, membership's device ms and
              kernels, and the top 8 other kernels (a profile of the
              bucketed/varint run takes about 4 minutes, too many for the
              script's time: ``tools/fetch_profile.py`` splits its fetch
              path);
6. lm_kernels — flash_attn and moe_gemm against their plain versions on
              the card in float32 and bfloat16, at the test sweep shapes,
              the bf16 variants' edges and the serving shapes, each row
              with the variant that ran (``ops.route``), timed beside
              their bounds (with the TFLOP/s and GB/s reached), the plain
              versions, a library yardstick and the simt variant;
7. lm_parity — OLMoE-1B-7B at full width and 2 layers: the kernel path
              against the plain path (the same model run with the
              kernels' plain versions) through prefill and 4 decode
              steps, in float32 and in bfloat16 (router pinned);
8. lm_serve — OLMoE-1B-7B at full depth and width in bfloat16 with seeded
              random weights: 4 prompts of 4,096 tokens, prefill and 64
              greedy decode steps, twice (the tokens must agree; prefill
              through the "wgmma" variants, decode through "stream"); then
              one prompt of 32,768 tokens (``prefill_32k`` cut to batch 1);
9. gnn_kernels — segment_spmm's two variants against their plain
              versions on the card.  "sum", f32 and bf16 messages: the test
              sweep shapes and edge cases (a hub row among them)
              elementwise, and the model shapes (D = 8, 56, 64 on the
              products-sized graph, GraphCast's D = 512 at the minibatch
              capacity and on the Cora-sized graph) against float64 row
              sums, timed beside the bound, the plain version and two
              library calls; the longest row with and without the hub
              split.  "gat": a small graph with a hub, masked slots, empty
              and all-masked rows at the reduced and full head shapes in
              every dtype pair, then GAT's two layers on the products-sized
              graph and on the Cora-sized graph, timed beside two bounds
              and the plain version, and the hub threshold swept;
10. gnn_parity — GAT, GraphCast, SchNet and PNA at their full config
              widths in float32 on a Cora-sized graph: the kernel path
              against the plain path, launches by variant;
11. gnn_serve — GAT (``gat-cora``, bf16, seeded random weights) on a
              seeded graph of ogbn-products' size (2,449,029 nodes,
              61,859,140 edge slots): three bit-identical forwards through
              the "gat" variant alone, one with bf16 messages, a
              ``torch.profiler`` split with no edge-sized gather or
              scatter; PyTorch's edge gathers timed four ways; then
              GraphCast at full width (16 layers, d = 512, bf16) on the
              Cora-sized graph;
12. lm_train_kernels — the training path's backward kernels against
              their plain versions on the card in float32 and bfloat16:
              flash_attn's "delta", "dkdv" and "dq" (on the forward
              kernel's own output and lse, which is held against the plain
              forward's) and moe_gemm_bwd, at the test sweep, edge shapes
              (ragged tiles, GQA 8/2 and 32/8, q_offset, D = 80) and the
              training shapes (bf16 through the "wgmma" variants),
              each call made twice and bit-identical; the training shapes
              timed beside the bound, the plain version and a library
              yardstick;
13. lm_train_parity — OLMoE-1B-7B at full width and 2 layers, one
              training step's loss and every parameter's gradient: the
              kernel path against the plain path in float32 and in
              bfloat16 (experts pinned), launches by kernel;
14. lm_train — the training cell: OLMoE-1B-7B at full width cut to 4
              layers, 4 x 4,096 tokens a step, bf16 with f32 AdamW
              moments; ``Trainer.run`` for 20 steps with a checkpoint
              every 10 and a fault injected at step 15, then an
              uninterrupted run from the same seed: the losses after the
              restore equal bit for bit, the loss falls; step ms p50/p90,
              tokens/s, peak memory, launches by kernel and variant, and
              one step under ``torch.profiler`` split by kernel.

15. gnn_train_kernels — the GNN training path's backward kernels
              against their plain versions on the card: segment_spmm's
              "sum_bwd" (a gather of the output gradient by destination)
              bit for bit at the test sweep and edge cases, timed at the
              products graph's D = 64 and GraphCast's Cora-sized bf16
              shape in turns with ``dout.index_select``, each call's host
              and device time apart; "gat_bwd" (the edge softmax's
              gradient, from the forward's saved row max, denominator and
              output; the forward with them bit-identical to the forward
              without) at 1e-4 (f32) and 2e-2 (bf16) of max |plain| on a
              small graph with a hub, masked, empty and all-masked rows at
              the test head shapes and the forward kernel's limits in every
              dtype pair, then at GAT's two products-sized layers and the
              Cora-sized graph, timed beside two bounds, the plain backward
              and the earlier design's times (its kernels' split: phase
              17's profile); each call made twice and bit-identical;
16. gnn_train_parity — the four GNNs at full width on the Cora-sized
              graph, one training step's loss and every parameter's
              gradient: the kernel path against the plain path in float32
              and in bfloat16, launches by variant, forward and backward;
17. gnn_train — the training cell: GAT (``gat-cora``, bf16 weights, f32
              AdamW moments) trained full-graph on the products-sized
              graph, ``Trainer.run`` for 20 steps with a checkpoint every
              10 and a fault injected at step 15, then an uninterrupted
              run from the same seed: the losses after the restore equal
              bit for bit, the loss falls; step ms p50/p90, nodes/s, peak
              memory, launches by variant, one step under
              ``torch.profiler`` split by kernel; GraphCast at full width
              for 3 steps on the Cora-sized graph; then GAT fed by
              ``gnn_epoch_stream`` at ``minibatch_lg``'s capacities on a
              seeded graph of its size for 4 steps, the sampler's host ms
              beside each step's.

18. dist — the ``dist`` exchange, one rank per partition over
              ``torch.distributed`` (gloo), two ranks sharing the card:
              (a) ``launch_local`` of two ``repro_torch.launch.dist_worker``
              ranks on ``cuda:0`` (dblp_bench, q1, hash partition),
              bucketed/varint, each rank's count and every logical stat
              against an in-process ``sim`` run on the card; (b) the full
              cell's recipe, ``powerlaw_graph(n, 6, seed=1)`` split 2 ways
              (bfs), q1 dense/raw with the default ``EngineConfig``, as two
              spawned ranks: the count against scipy's triangles, every
              logical stat against ``sim`` of the same partition on the
              card, each rank's wall time, peak memory, resident adjacency
              bytes and membership launches, ``wall_skew``, ``bytes_wire_*``
              and ``sim``'s wall time beside them (n: ``DIST_N``).  The
              same ranks then run phase 23's ``compressed_psum`` calls.

19. mla_serve — the serve_dsv3 cell: DeepSeek-V3 at its published
              widths in bfloat16 with seeded random weights, cut to 4
              layers (its 3 dense layers and 1 MoE layer): flash_attn at
              D != Dv against its plain version (MLA's D = 192, Dv = 128
              through "wgmma" at the cell's prefill shape, timed beside
              the bound, the plain version and SDPA; "simt" in f32 and at
              the reduced config's (24, 16)); 4 prompts of 4,096 tokens,
              prefill and 64 absorbed decode steps, twice (the tokens must
              agree), 4 naive steps from the same cache within 5e-2 of the
              absorbed ones, one profiled window; moe_gemm on the MoE
              layer's 256 experts at the prefill capacity ("wgmma") and
              at decode ("stream"), per pass and against float64, timed;
              the kernel path against the plain path in bf16 (a dense and
              the MoE layer, router pinned) and f32 (one dense layer).

20. mla_train — the train_dsv3 cell: DeepSeek-V3 at its published
              widths in bfloat16 with seeded random weights, cut to its 3
              dense layers plus the MTP head: flash_attn's backward
              kernels at D != Dv against their plain versions (the reduced
              (24, 16) and (192, 128) in f32 through "simt", (192, 128) in
              bf16 through "wgmma", timed at the cell's shape beside the
              bound, the plain backward and SDPA's), moe_gemm's backward
              at DeepSeek's expert widths (E = 256, C = 320, d = 7,168, f
              = 2,048), against plain per 16 experts, timed; one training
              step's loss and every gradient, MTP included, kernel path
              against plain path in f32 (one dense layer) and bf16; then
              10 steps of 2 x 4,096 tokens twice from one seed, the losses
              bit-equal and falling, step ms, tokens/s, peak memory,
              launches by kernel and variant, one step profiled.

21. din — DIN at its published config (tables of 50 M items, 1 M
              categories, 8 M user features; embed_dim 18, history 100)
              in bf16 with seeded weights, at RECSYS_SHAPES' batch sizes,
              nothing cut: segment_spmm "sum" at serve_bulk's user bag
              (262,144 bags of 4 rows of 18, f32 elementwise, bf16 within
              its row's sum of |msg|) and "sum_bwd" of it (bit-exact), the
              item table's gradient of train_batch's history (6,553,600
              ids) through ``TableGather``'s unique plan in f32 and bf16
              (two backwards bit-identical), each timed beside its byte
              bound, the plain version and a library call
              (``F.embedding_bag`` for the whole bag, ``index_add_`` for
              the gradient); one step's loss, logits and every gradient at
              serve_p99's batch, kernel path against plain path in f32 and
              bf16, launches by variant; serve_p99 (200 calls, ms p50/p99),
              serve_bulk (ms, rows/s) and retrieval_cand (one user against
              1,000,000 candidates and the top 10, ms), peak memory each;
              train_batch (65,536 rows a step, f32 AdamW moments, the
              example's optimizer settings) for 20 steps twice from one
              seed, losses bit-equal and falling, step ms p50/p90, rows/s,
              peak memory, launches per step by variant, one step profiled
              and split by kernel.

22. exec — the stage executables (RADS stages as CUDA graphs from
              ``StageRunner``'s slot table, the per-host store of
              ``runtime/compile_cache.py``, the background pre-warm):
              on the small graph, q1..q8 in three configurations
              (dense/raw, bucketed/varint, cache off), q1, q3 and q6
              under the ``gather`` exchange, q1 at
              ``pipeline_depth="auto"`` and q6 at caps from which it
              escalates three times, each graphed against the card's
              eager stages (``StageRunner(eager=True)``): counts,
              embeddings and every non-timing stat equal; q1 twice
              through ``runner_cache``, the second call capturing
              nothing and launching what an eager second call launches;
              a cold process (empty kernel directory and store) and a
              warm one (another empty kernel directory, the store the
              cold one filled): the warm one captures nothing that counts
              as a compile, hits every stage, builds no kernel, and each
              first call is timed beside the host's graph, partition and
              plan time; a corrupted entry warns and is captured afresh;
              then the full cell's dense/raw run of phase 5, graphed,
              against an eager run of the same cell (every stat; wall
              time, peak memory, captures, ``compile_s``).

23. mesh_plan — the production mesh plan and ``compressed_psum``: on
              phase 18's two gloo ranks sharing the card,
              ``compressed_psum`` of CUDA tensors (``PSUM_CASES``: a
              gradient-sized 64 MiB float32 tensor, a small one, all
              zeros, bfloat16), each equal bit for bit to the same call
              on CPU copies of the inputs and within 5% of the float64
              sum, each call's ms; then the argument plan of all 40 cells
              on both production meshes (fake 256 / 512-rank worlds, no
              device), one line a cell with the per-device bytes beside
              the card's memory; then the step check of DeepSeek-V3's
              decode_32k at 61 layers on the meta device, with its
              seconds.

``--lm-train-only`` runs phases 1, 2 and 12-14 and prints no result;
``--gnn-train-only`` runs phases 1, 2 and 15-17 and prints no result;
``--dist-only`` runs phases 1, 2, 18 and 23 and prints no result;
``--mla-only`` runs phases 1, 2 and 19 and prints no result;
``--mla-train-only`` runs phases 1, 2 and 20 and prints no result;
``--din-only`` runs phases 1, 2 and 21 and prints no result;
``--exec-only`` runs phases 1, 2 and 22 without its full cell and prints
no result.  Phase 22 runs after phase 5 (it takes phase 5's full run).
Each phase prints one JSON line.  Then come the kernels line, the
``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
result lines.  Exits non-zero without a result when CUDA is missing or the
repository's ``src/`` is not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM published HBM3 rate
ALU_OPS_PER_S = 67e12         # H100 SXM published non-tensor 32-bit rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM published dense bf16 tensor rate
# LM serving (phases 6-8): OLMoE-1B-7B; LM_SHAPES' prefill_32k is cut from
# batch 32 to 1 and decode_32k from batch 128 at 32k context to batch 4 at
# 4,160, to stay inside the script's time with the first-version kernels
LM_ARCH = "olmoe-1b-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 4096, 64
SERVE_MAX_LEN = 4160
LONG_PROMPT = 32768
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_DECODE = 2, 2, 300, 4
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
MOE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# moe_gemm in float32 at C = 1 (decode) is held per output row, not
# elementwise: there the plain version's einsum runs as a GEMV whose sum
# order differs from the kernel's, and outputs near 0 (sums of 1,024 terms
# of about 4) miss 1e-5 absolute; the phase prints both ratios.  bf16 there
# and every other shape are held elementwise
MOE_ROW_CHECK = ("float32", 1)
# moe_gemm in bf16 is held per pass, each elementwise at MOE_TOL (h against
# the plain version's, the output against the plain down projection of the
# kernel's own h), and against the function computed exactly in float64
# (``moe_gemm_f64``: each h element within one bf16 rounding, each output
# within the bound of every rounding).  End to end at MOE_TOL it is held
# too, except at OLMoE's expert widths through the wgmma variant
# (``end_to_end=False``; float32 is always held end to end): there the
# tensor cores' f32 sum order puts some h elements one bf16 step from the
# plain version's, and wd carries such a step past the 5e-2 floor at
# outputs near 0, as it carries the plain version's own rounding of h past
# it against the exact function (``plain_vs_exact_elem_ratio``)
SMALL_CAPS = dict(frontier_cap=1 << 12, fetch_cap=256, verify_cap=1024,
                  region_group_budget=1 << 11)
# phase 22: the small graph's three configurations, and caps from which q6
# escalates three times
EXEC_CONFIGS = {"dense/raw": {},
                "bucketed/varint": dict(storage_format="bucketed",
                                        wire_format="varint"),
                "cache_off": dict(enable_cache=False)}
ESCALATE_CAPS = dict(frontier_cap=1 << 8, fetch_cap=16, verify_cap=64,
                     region_group_budget=1 << 11)
# GNN forward (phases 9-11): GNN_SHAPES' ogb_products and full_graph_sm at
# their published sizes, neither cut, on seeded synthetic graphs
GNN_ARCHS = ("gat-cora", "graphcast", "schnet", "pna")
GNN_TOL = 1e-5            # tests/test_kernels.py::test_segment_spmm_sweep
# gat_aggregate with bf16 anywhere: each element within 3 bf16 steps of its
# row's sum of |msg| (the kernel repeats each rounding of the plain version,
# but a weight can round one way in one and the other way in the other: a
# denominator one step off moves it a step, its own rounding another, and
# the message's rounding a third), plus one step of its value where the
# output is bf16 (``_sum_ratio``)
GAT_BF16_TOL = 3 * 2.0 ** -7
EDGE_OPS = ("index_select", "scatter", "gather", "aten::index", "embedding")
GNN_PARITY_TOL = 1e-4
ZIPF_POWER = 1.795        # products_graph: ~17,000 edges on the largest hub
FULL_N = 317_080              # com-DBLP's vertex count
# The full phase runs a slightly smaller graph.  At FULL_N, q1 escalates
# the capacities four times (its largest hub lands on a device that does
# not own it, so every pair of its neighbours is a frontier row and a
# verifyE pair for one peer).  At the fourth rung the static fetch
# buffers, (8, 8, 65,536, 1,796) int32 = 28 GiB, stay resident through the
# leaf steps on (2^20, 1,796) tensors, and the 80 GB card runs out
# (`--full-n 317080` shows it).  At 310,000 three escalations suffice.
SMOKE_N = 310_000
SMOKE_MAX_DEGREE = 1780       # max degree of powerlaw_graph(SMOKE_N, 6, 1)
# phase 18 (dist) runs the full cell's recipe split 2 ways at this size
DIST_N = SMOKE_N
# phase 23: compressed_psum on phase 18's ranks, name -> (shape, dtype,
# scale of the seeded normal values): a gradient-sized tensor (64 MiB of
# float32), a small one, all zeros (the scale's 1e-12 floor), bfloat16
PSUM_CASES = {"grad_64mib_f32": ((1 << 24,), "float32", 1e-3),
              "small_f32": ((4, 1000), "float32", 3.0),
              "zeros_f32": ((4096,), "float32", 0.0),
              "bf16": ((1 << 20,), "bfloat16", 1.0)}
PSUM_TOL = 0.05          # tests/test_multidevice.py's compressed_psum bound
CUT_REASON = ("at n=317,080 the fourth capacity escalation (28 GiB fetch "
              "buffers held through 2^20-row leaf steps) runs out of device "
              "memory; 310,000 needs three escalations")
# LM training (phases 12-14): OLMoE-1B-7B at full width, cut from 16 layers
# to 4 (6.9 B parameters with bf16 weights and gradients and f32 moments,
# 12 bytes each, take 83 GB) and LM_SHAPES' train_4k from global batch 256
# to 4 sequences of 4,096 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS = 4, 4096, 4
TRAIN_PARITY_SEQ = 512     # lm_train_parity: PARITY_BATCH x 512 tokens
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_AT = 20, 10, 15
# a backward kernel's gradient against its plain version's: the largest
# |difference| over the largest |plain| (f32: sums in another order; bf16:
# the inputs and outputs rounded, sums in f32)
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# GNN training (phases 15-17): GAT on the products-sized graph, full graph
# a step, nothing cut; the sampled run takes a few steps at minibatch_lg's
# capacities on a seeded graph of its size
GNN_TRAIN_STEPS, GNN_TRAIN_CKPT_EVERY, GNN_TRAIN_FAULT_AT = 20, 10, 15
SAMPLED_STEPS = 4
# DeepSeek-V3 serving (phase 19): the published widths in bf16 with the
# depth cut from 61 layers to the 3 dense layers and 1 MoE layer (671 B
# parameters do not fit one card); serve_4k's traffic, decode absorbed
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4
MLA_NAIVE_STEPS = 4
MLA_NAIVE_TOL = 5e-2   # naive against absorbed: tests/test_arch_smoke.py
MOE_CHUNK = 16         # experts a plain or float64 moe_gemm check takes
# DeepSeek-V3 training (phase 20): the published widths in bf16 with the
# depth cut from 61 layers to its 3 dense layers plus the MTP head (4.29 B
# parameters take 51.5 GB with bf16 gradients and f32 moments; the routed
# experts of one MoE layer alone hold 11.27 B) and train_4k's global batch
# cut from 256 to 2 sequences of 4,096 tokens
MLA_TRAIN_LAYERS, MLA_TRAIN_BATCH, MLA_TRAIN_STEPS = 3, 2, 10
# train_4k's optimizer settings but the peak learning rate: at 1e-3 the
# loss of this 7,168-wide model rises over the 10 steps (21.15 -> 27.12),
# and at every rate down to 1e-4; at 1e-5 it falls at every few steps
# (tools/dsv3_lr_sweep.py)
MLA_TRAIN_LR = 1e-5
MLA_TRAIN_PARITY_SEQ = 512   # mla_train_parity: PARITY_BATCH x 512 tokens
# DIN (phase 21): the published config (configs/din.py) in bf16 with
# seeded weights, at RECSYS_SHAPES' batch sizes; nothing is cut
DIN_N_UF = 4              # din_batch_stream's multi-hot user ids a row
DIN_SERVE_BATCHES, DIN_SERVE_CALLS = 8, 200
DIN_BULK_CALLS, DIN_RETRIEVAL_CALLS = 5, 10
DIN_TRAIN_STEPS = 20
DIN_TRAIN_OPT = dict(lr=2e-3, warmup_steps=10, total_steps=300,
                     weight_decay=0.0)   # examples/serve_din.py's
# segment_spmm's launches in one DIN training step: the user bag's "sum"
# and "sum_bwd", and the three tables' gradient sums
DIN_STEP_LAUNCHES = {"sum": 4, "gat": 0, "sum_bwd": 1, "gat_bwd": 0}
DEVICE = "cuda"
SASS_OPS = ("HGMMA", "UTMALDG")   # counted in each library's SASS
TIMING_KEYS = {"compiles", "compile_s", "compile_cache_hits", "wave_s_total",
               "sme_wall_us", "dist_wall_us", "wall_us", "sme_pipeline_s",
               "dist_pipeline_s", "exec_cache_enabled", "exec_cache"}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 1: device
# --------------------------------------------------------------------------- #
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit(phase="device", name=torch.cuda.get_device_name(0),
         nvidia_smi=smi_line, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi_line


# --------------------------------------------------------------------------- #
# phase 2: build
# --------------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.intersect import kernel as inter_kernel
    from repro_torch.kernels.membership import kernel as memb_kernel
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.segment_spmm import kernel as spmm_kernel
    from repro_torch.kernels.varint import kernel as varint_kernel
    sources = [memb_kernel.SOURCE, inter_kernel.SOURCE,
               *varint_kernel.SOURCES, flash_kernel.SOURCE, moe_kernel.SOURCE,
               spmm_kernel.SOURCE, flash_kernel.BWD_SOURCE,
               moe_kernel.BWD_SOURCE, spmm_kernel.BWD_SOURCE]
    t0 = time.perf_counter()
    took = build.build(sources)
    wall = time.perf_counter() - t0
    ptxas, sass = {}, {}
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for src in sources:
        lib = build.library_path(src)
        log = lib.with_suffix(".log")
        ptxas[src.name] = ([ln for ln in log.read_text().splitlines()
                            if "registers" in ln or "spill" in ln]
                           if log.is_file() else [])
        dump = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300)
        check(dump.returncode == 0, f"cuobjdump -sass {lib.name} failed: "
                                    f"{dump.stderr[-2000:]}")
        sass[src.name] = {op: dump.stdout.count(op) for op in SASS_OPS}
    # the tensor-core variants, forward and backward: wgmma (HGMMA) fed by
    # TMA tile loads (UTMALDG)
    for src in (flash_kernel.SOURCE, moe_kernel.SOURCE,
                flash_kernel.BWD_SOURCE, moe_kernel.BWD_SOURCE):
        check(all(sass[src.name][op] > 0 for op in SASS_OPS),
              f"{src.name}: no {' or '.join(SASS_OPS)} in its SASS: "
              f"{sass[src.name]}")
    emit(phase="build", wall_s=wall,
         built={s.name: t for s, t in took.items()}, ptxas=ptxas, sass=sass)


# --------------------------------------------------------------------------- #
# phase 3: kernel vs plain version
# --------------------------------------------------------------------------- #
def _sorted_probes(M: int) -> int:
    """Entries a lower_bound over M sorted ids reads, at most."""
    return math.ceil(math.log2(M)) + 1 if M > 1 else 1


def _membership_bound_ms(B: int, M: int, K: int) -> tuple[float, str]:
    """Least time for the membership function on these shapes: queries
    read once, answers written once, and of each row what a search must
    read — the whole row when it is smaller than one 32-byte sector per
    probe per query; compares counted at the 32-bit ALU rate."""
    probes = _sorted_probes(M)
    row_bytes = B * min(4 * M, K * probes * 32)
    nbytes = B * K * 4 + B * K * 1 + row_bytes
    ops = B * K * probes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sorted_rows(gen, B, M, hi, sentinel, device, pad=True):
    """Sentinel-padded sorted rows with a spread of degrees (the engine's
    adjacency windows), generated on the card."""
    import torch
    rows = torch.randint(0, hi, (B, M), generator=gen, device=device,
                         dtype=torch.int32)
    rows = torch.sort(rows, dim=1).values
    if pad:
        deg = torch.randint(1, M + 1, (B, 1), generator=gen, device=device)
        col = torch.arange(M, device=device)
        rows = torch.where(col < deg, rows, torch.full_like(rows, sentinel))
    return rows


def engine_shapes(max_degree: int) -> dict:
    """The membership shapes the full-scale phase launches at the default
    caps: the engine runs the devices in chunks of at most
    ``CHUNK_ELEMS`` elements of a (rows, max_degree) tensor."""
    from repro_torch.configs.rads import DEFAULT_ENGINE as cfg
    from repro_torch.core.engine import _device_chunks
    nd, D = 8, max_degree
    t0, t1 = _device_chunks(nd, cfg.frontier_cap * D)[0]
    v0, v1 = _device_chunks(nd, nd * cfg.verify_cap * D)[0]
    return {
        # back-edge filter: B = devices * frontier_cap, M = K = max_degree
        "backedge": ((t1 - t0) * cfg.frontier_cap, D, D, SMOKE_N),
        # verifyE answer: B = devices * ndev * verify_cap, M = D, K = 1
        "verify": ((v1 - v0) * nd * cfg.verify_cap, D, 1, SMOKE_N),
    }


def phase_kernels(full_shapes, degrees):
    import torch
    from repro_torch.kernels.membership import ops
    from repro_torch.kernels.membership.ref import membership_ref
    dev = torch.device("cuda")
    cases = []
    for B, M, K in [(7, 16, 3), (64, 130, 9), (256, 64, 1), (3, 257, 17)]:
        rng = np.random.default_rng(B * M + K)          # the test sweep
        rows = np.sort(rng.integers(0, 300, (B, M)).astype(np.int32), axis=1)
        vals = rng.integers(0, 300, (B, K)).astype(np.int32)
        cases.append((f"sweep_{B}x{M}x{K}", torch.as_tensor(rows, device=dev),
                      torch.as_tensor(vals, device=dev)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sent = 1000
    full = _sorted_rows(gen, 300, 40, sent, sent, dev, pad=False)
    cases.append(("full_rows_no_sentinel", full,
                  torch.randint(-5, sent + 5, (300, 7), generator=gen,
                                device=dev, dtype=torch.int32)))
    padded = _sorted_rows(gen, 300, 40, sent, sent, dev)
    cases.append(("sentinel_queries", padded,
                  torch.full((300, 5), sent, device=dev, dtype=torch.int32)))
    cases.append(("m_is_1", _sorted_rows(gen, 513, 1, 4, 4, dev, pad=False),
                  torch.randint(0, 5, (513, 3), generator=gen, device=dev,
                                dtype=torch.int32)))
    cases.append(("b_not_block_multiple",
                  _sorted_rows(gen, 1001, 33, 100, 100, dev),
                  torch.randint(0, 101, (1001, 3), generator=gen, device=dev,
                                dtype=torch.int32)))
    for name, rows, vals in cases:
        got = ops.membership(rows, vals)
        want = membership_ref(rows, vals)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"membership {name} disagrees")
    emit(phase="kernels", kernel="membership", exact_cases=[c[0] for c in
                                                             cases])

    results = {}
    for name, (B, M, K, n) in full_shapes.items():
        rows = _sorted_rows(gen, B, M, n, n, dev)
        # queries: half drawn from the rows (members), half uniform
        pick = torch.randint(0, M, (B, K), generator=gen, device=dev)
        vals = torch.where(
            torch.rand((B, K), generator=gen, device=dev) < 0.5,
            torch.gather(rows, 1, pick),
            torch.randint(0, n + 1, (B, K), generator=gen, device=dev,
                          dtype=torch.int32))
        del pick
        results[name] = _time_membership(name, rows, vals)
        del rows, vals
        torch.cuda.empty_cache()
    # the back-edge filter's own inputs: both the candidate windows and the
    # rows are sorted adjacency windows padded with the sentinel n past a
    # degree of the full graph, so nearly every query is the sentinel
    B, M, K, n = full_shapes["backedge"]
    vals, rows = _intersect_inputs(gen, B, M, n, dev, torch.as_tensor(
        degrees, device=dev, dtype=torch.int32))
    results["backedge_engine"] = _time_membership(
        "backedge_engine", rows, vals,
        live_share=float((vals != n).float().mean()))
    _sweep_row_path(rows, vals)
    del rows, vals
    torch.cuda.empty_cache()
    return results


def _sweep_row_path(rows, vals):
    """Both membership paths on the back-edge rows with the first K
    columns of the candidate windows as queries, at K = 1, 4, 16, 64 and
    M: where the constant ``ops.ROW_PATH_MIN_K`` should split them."""
    import torch
    from repro_torch.kernels.membership import ops
    from repro_torch.kernels.membership.kernel import membership_cuda
    from repro_torch.kernels.membership.ref import membership_ref
    sweep = []
    for K in (1, 4, 16, 64, rows.shape[1]):
        q = vals[:, :K].contiguous()
        want = membership_ref(rows, q)
        out = torch.empty_like(want)
        row = dict(K=K, picked="row" if K >= ops.ROW_PATH_MIN_K else "query")
        for path, min_k in (("row", 1), ("query", K + 1)):
            out.zero_()
            membership_cuda(rows, q, out, min_k)
            torch.cuda.synchronize()
            check(torch.equal(out, want),
                  f"membership {path} path disagrees at K = {K}")
            row[f"{path}_ms"] = cuda_ms(
                lambda: membership_cuda(rows, q, out, min_k), iters=5)
        sweep.append(row)
        del q, want, out
    emit(phase="kernels", kernel="membership", sweep="row_path_min_k",
         row_path_min_k=ops.ROW_PATH_MIN_K, B=rows.shape[0], M=rows.shape[1],
         rows=sweep)


def _final_run_starts(rows):
    """Per row, the start of its final run: the lower_bound of its last
    value (the degree, for a sentinel-padded adjacency window)."""
    import torch
    return torch.searchsorted(rows, rows[:, -1:].contiguous(),
                              out_int32=True).view(-1)


def _row_bytes_needed(rows, vals, sentinel=None) -> int:
    """Of each sorted row, the bytes that answering its queries ``vals``
    needs by the final-run rule (``sorted_search.cuh``): the 32-byte
    sector that holds the row's last value, where the row has a query
    other than ``sentinel`` (intersect answers the sentinel without the
    row); and of its live prefix row[0:L) the sectors touched by the
    queries below the last value, one binary search over its ceil(L / 8)
    sectors each, and no more than all of them.  No search for L is
    counted, and a row counts no more than its own bytes."""
    import torch
    M = rows.shape[1]
    below = vals < rows[:, -1:]
    asks = None
    if sentinel is not None:
        asks = vals != sentinel
        below &= asks
    below = below.sum(dim=1, dtype=torch.int64)
    sectors = (_final_run_starts(rows).to(torch.int64) + 7) // 8
    search = torch.where(
        sectors > 0,
        torch.ceil(torch.log2(sectors.clamp(min=1).double())).long() + 1, 0)
    prefix = torch.minimum(sectors, below * search)
    head = 1 if asks is None else asks.any(dim=1).to(torch.int64)
    return int(torch.clamp(32 * (head + prefix), max=4 * M).sum())


def _membership_bound_data_ms(rows, vals) -> float:
    """Least time for the membership function on these inputs: queries
    read once, answers written once, and of each row what its answers
    need (:func:`_row_bytes_needed`), at the HBM rate."""
    return ((vals.numel() * 5 + _row_bytes_needed(rows, vals))
            / HBM_BYTES_PER_S * 1e3)


def _time_membership(name, rows, vals, **extra) -> dict:
    """Hold the membership kernel bit-exact against its plain version on
    ``rows``/``vals``, then time it beside its bounds, the plain version
    and the searchsorted+gather yardstick."""
    import torch
    from repro_torch.kernels.membership import ops
    from repro_torch.kernels.membership.ref import membership_ref
    (B, M), K = rows.shape, vals.shape[1]
    got = ops.membership(rows, vals)
    want = membership_ref(rows, vals)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"membership {name} disagrees")
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    del got, want
    kernel_ms = cuda_ms(lambda: ops.membership(rows, vals))
    plain_ms = cuda_ms(lambda: membership_ref(rows, vals), iters=3)
    library_ms = cuda_ms(lambda: torch.gather(
        rows, 1, torch.searchsorted(rows, vals).clamp_(max=M - 1))
        == vals, iters=3)
    bound_ms, bound_by = _membership_bound_ms(B, M, K)
    row = dict(B=B, M=M, K=K, max_abs_err=err, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by,
               bound_data_ms=_membership_bound_data_ms(rows, vals), **extra)
    emit(phase="kernels", kernel="membership", shape=name, **row)
    return row


def _intersect_bound_ms(a, b, sentinel: int) -> tuple[float, str]:
    """Least time for the intersect function on these inputs: ``a`` read
    once, the mask and the counts written once, and of each ``b`` row what
    the answers to its ``a`` row need (:func:`_row_bytes_needed`);
    compares counted at the 32-bit ALU rate."""
    import torch
    B, M = a.shape
    live = (a != sentinel).sum(dim=1, dtype=torch.int64)
    nbytes = B * M * 4 + B * M + B * 4 + _row_bytes_needed(b, a, sentinel)
    ops = int(live.sum()) * _sorted_probes(M)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _intersect_inputs(gen, B, M, n, dev, degrees=None):
    """Candidate windows ``a`` and back-edge rows ``b`` like the bucketed
    back-edge filter's: sorted ids padded with the sentinel ``n`` past a
    degree drawn from ``degrees`` (full rows when None), about half of
    ``a``'s ids taken from ``b``'s row."""
    import torch
    col = torch.arange(M, device=dev, dtype=torch.int32)

    def degree():
        if degrees is None:
            return torch.full((B, 1), M, device=dev, dtype=torch.int32)
        pick = torch.randint(0, degrees.numel(), (B, 1), generator=gen,
                             device=dev)
        return degrees[pick].clamp_(1, M)

    deg_b = degree()
    b = _sorted_rows(gen, B, M, n, n, dev, pad=False)
    b = torch.where(col < deg_b, b, n)
    take = (torch.rand((B, M), generator=gen, device=dev) * deg_b).long()
    a = torch.gather(b, 1, take.clamp_(max=M - 1))
    del take
    fresh = torch.randint(0, n, (B, M), generator=gen, device=dev,
                          dtype=torch.int32)
    a = torch.where(torch.rand((B, M), generator=gen, device=dev) < 0.5, a,
                    fresh)
    del fresh
    a = torch.sort(a, dim=1).values
    a = torch.where(col < degree(), a, n)
    return a.contiguous(), b.contiguous()


def phase_intersect(degrees, n: int, max_degree: int):
    """The intersect kernel against its plain version: the reference
    sweep, sentinel-padded windows and edges, then the bucketed back-edge
    filter's shape (B = devices * frontier_cap rows of max_degree) with
    rows padded by the full graph's degree distribution and with full
    rows, timed beside its bound and the searchsorted+gather yardstick."""
    import torch
    from repro_torch.configs.rads import DEFAULT_ENGINE as cfg
    from repro_torch.core.engine import _device_chunks
    from repro_torch.kernels.intersect import ops
    from repro_torch.kernels.intersect.ref import intersect_ref
    dev = torch.device("cuda")
    cases = []
    for B, M in [(5, 20), (33, 129), (128, 64), (17, 8), (40, 65), (9, 200)]:
        rng = np.random.default_rng(B + M)              # the test sweep
        a = np.sort(rng.integers(0, 500, (B, M)).astype(np.int32), axis=1)
        b = np.sort(rng.integers(0, 500, (B, M)).astype(np.int32), axis=1)
        cases.append((f"sweep_{B}x{M}", torch.as_tensor(a, device=dev),
                      torch.as_tensor(b, device=dev), 500))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    small_deg = torch.randint(0, 41, (64,), generator=gen, device=dev)
    for name, B, M, d in [("padded_300x40", 300, 40, small_deg),
                          ("full_rows_300x40", 300, 40, None),
                          ("m_is_1", 513, 1, small_deg),
                          ("b_not_block_multiple", 1001, 33, small_deg)]:
        cases.append((name, *_intersect_inputs(gen, B, M, 1000, dev, d),
                      1000))
    for name, a, b, sent in cases:
        got = ops.intersect(a, b, sent)
        want = intersect_ref(a, b, sent)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"intersect {name} disagrees")
    emit(phase="kernels", kernel="intersect",
         exact_cases=[c[0] for c in cases])

    t0, t1 = _device_chunks(8, cfg.frontier_cap * max_degree)[0]
    B, M = (t1 - t0) * cfg.frontier_cap, max_degree
    degrees = torch.as_tensor(degrees, device=dev, dtype=torch.int32)
    results = {}
    for name, d in (("backedge_padded", degrees), ("backedge_full", None)):
        a, b = _intersect_inputs(gen, B, M, n, dev, d)
        got = ops.intersect(a, b, n)
        want = intersect_ref(a, b, n)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"intersect {name} disagrees")
        err = max(int((got[0].to(torch.int32) - want[0].to(torch.int32))
                      .abs().max()),
                  int((got[1] - want[1]).abs().max()))
        del got, want
        kernel_ms = cuda_ms(lambda: ops.intersect(a, b, n))
        plain_ms = cuda_ms(lambda: intersect_ref(a, b, n), iters=3)
        library_ms = cuda_ms(lambda: torch.gather(
            b, 1, torch.searchsorted(b, a).clamp_(max=M - 1)) == a, iters=3)
        bound_ms, bound_by = _intersect_bound_ms(a, b, n)
        results[name] = dict(B=B, M=M, max_abs_err=err, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             live_share=float((a != n).float().mean()))
        emit(phase="kernels", kernel="intersect", shape=name,
             **results[name])
        del a, b
        torch.cuda.empty_cache()
    return results


def _id_lanes(gen, B, M, n, dev, hole_p=0.3):
    """Fetch request lanes: ascending ids below ``n`` with sentinel holes
    (cache hits and unused slots)."""
    import torch
    ids = torch.sort(torch.randint(0, n, (B, M), generator=gen, device=dev,
                                   dtype=torch.int32), dim=1).values
    holes = torch.rand((B, M), generator=gen, device=dev) < hole_p
    return ids.masked_fill_(holes, n)


def phase_delta_vlen(n: int, fetch_caps: tuple):
    """The delta_vlen kernel against its plain version: the reference
    sweep (ids up to 2^27) and edges, then the fetch encoder's shapes
    (ndev * ndev = 64 lanes of the default and the escalated fetch cap),
    timed beside its bound; no one PyTorch call computes it."""
    import torch
    from repro_torch.kernels.varint import ops
    from repro_torch.kernels.varint.ref import delta_vlen_ref
    dev = torch.device("cuda")
    cases = []
    for B, M in [(3, 16), (7, 130), (260, 64), (1, 300)]:
        rng = np.random.default_rng(B * M)              # the test sweep
        big = 1 << 27
        ids = np.full((B, M), big, np.int32)
        for r in range(B):
            k = int(rng.integers(0, M + 1))
            vals = np.sort(rng.choice(big, size=k, replace=False))
            ids[r, np.sort(rng.choice(M, k, replace=False))] = vals
        cases.append((f"sweep_{B}x{M}", torch.as_tensor(ids, device=dev), big))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases.append(("long_rows_5x4099", _id_lanes(gen, 5, 4099, 1 << 30, dev),
                  1 << 30))
    cases.append(("all_holes", torch.full((4, 70), 9, device=dev,
                                          dtype=torch.int32), 9))
    cases.append(("unsorted", torch.randint(0, 1 << 29, (9, 333),
                                            generator=gen, device=dev,
                                            dtype=torch.int32), 1 << 29))
    for name, ids, sent in cases:
        got = ops.delta_vlen(ids, sent)
        want = delta_vlen_ref(ids, sent)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"delta_vlen {name} disagrees")
    emit(phase="kernels", kernel="delta_vlen",
         exact_cases=[c[0] for c in cases])

    results = {}
    for fcap in fetch_caps:
        ids = _id_lanes(gen, 64, fcap, n, dev)
        got = ops.delta_vlen(ids, n)
        want = delta_vlen_ref(ids, n)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"delta_vlen 64x{fcap} disagrees")
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        kernel_ms = cuda_ms(lambda: ops.delta_vlen(ids, n), iters=50)
        plain_ms = cuda_ms(lambda: delta_vlen_ref(ids, n), iters=10)
        # one int32 read and two int32 writes per id; the compares are
        # a handful of 32-bit operations per id
        t_bytes = ids.numel() * 12 / HBM_BYTES_PER_S * 1e3
        t_ops = ids.numel() * 12 / ALU_OPS_PER_S * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                              else (t_ops, "operations"))
        results[fcap] = dict(B=64, M=fcap, max_abs_err=err,
                             kernel_ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by)
        emit(phase="kernels", kernel="delta_vlen", shape=f"64x{fcap}",
             **results[fcap])
    return results


def _codec_cases():
    """``tests/_codec_cases.py`` (numpy only): the wire tests' lane shapes
    and the row codec's edge cases."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _codec_cases
    return _codec_cases


def _held(name: str, got, want) -> None:
    """Every output of a codec equal to its plain version's, bit for bit
    and of one dtype."""
    import torch
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              f"{name}: output {i} disagrees with the plain version")


def _graph_rows(gen, L, m, D, n, degrees):
    """Adjacency windows ``(L, m, D)`` like the owners' answers: a degree
    drawn from the full graph's ``degrees``, that many ascending ids below
    ``n`` about n / degree apart (the graph's LEB128 sizes), then the
    sentinel ``n``."""
    import torch
    dev = degrees.device
    deg = degrees[torch.randint(0, degrees.numel(), (L, m, 1), generator=gen,
                                device=dev)].clamp_(1, D)
    gaps = torch.rand((L, m, D), generator=gen, device=dev)
    gaps.mul_((2 * (n // (deg + 1)) - 1).clamp_(min=1).float()).add_(1)
    rows = torch.cumsum(gaps.to(torch.int32), dim=-1, dtype=torch.int32)
    del gaps
    rows.clamp_(max=n - 1)
    rows.masked_fill_(torch.arange(D, device=dev) >= deg, n)
    return rows


def _bytes_bound(nbytes: float) -> tuple[float, str]:
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_varint_codec(degrees, n: int, fcap: int, max_degree: int):
    """The varint fetch codec's kernels against their plain versions on
    the card, bit for bit over whole streams, lengths, flags and decoded
    rows: every lane case of ``tests/_codec_cases.py`` (the wire tests'
    shapes, an interior sentinel, a lane with no valid row, D = 1,780 rows
    of ids >= 2^28, overflowing and raw-escape lanes), each row case
    decoded both compacted and onto the slots, and streams no encoder
    writes (cut values, degrees past m·D, lengths out of range).  Then timed at the full
    cell's top capacity: the request lanes (ndev^2 = 64 of ``fcap`` ids)
    and one responder chunk (16 lanes of ``fcap`` slots of ``max_degree``
    ids), with no valid row (what q1 feeds) and with rows of the full
    graph's degrees at 1% and 100% of the slots valid.  The plain
    versions run in lane groups, as the CPU path and the parent's card
    path do.  Bounds count the bytes that must move: zeroed stream
    capacity, written output, and the valid rows and live bytes read.  No
    one PyTorch call computes these functions: ``library_ms`` is None."""
    import torch
    from repro_torch.core import wire
    from repro_torch.core.engine import _device_chunks
    from repro_torch.kernels.varint import ops, ref
    cases = _codec_cases()
    dev = torch.device("cuda")
    names = []
    for name, fn in sorted(cases.CODEC_ID_CASES.items()):
        ids, sent, cap = fn(np.random.default_rng(0))
        ids = torch.as_tensor(ids.reshape(-1, ids.shape[-1]), device=dev)
        _held(f"encode_ids {name}", ops.encode_ids(ids, sent, cap),
              ref.encode_ids_ref(ids, sent, cap))
        names.append(f"ids:{name}")
    for name, fn in sorted(cases.CODEC_ROW_CASES.items()):
        rows, valid, sent, dcap, icap = fn(np.random.default_rng(2))
        m, D = rows.shape[-2:]
        rows = torch.as_tensor(rows.reshape(-1, m, D), device=dev)
        valid = torch.as_tensor(valid.reshape(-1, m), device=dev)
        want = ref.encode_rows_ref(rows, valid, sent, dcap, icap)
        _held(f"encode_rows {name}",
              ops.encode_rows(rows, valid, sent, dcap, icap), want)
        _held(f"decode_rows {name}",
              (ops.decode_rows(*want[:5], m, D, sent),
               ops.decode_rows(*want[:5], m, D, sent, valid=valid)),
              (ref.decode_rows_ref(*want[:5], m, D, sent),
               ref.decode_rows_ref(*want[:5], m, D, sent, valid=valid)))
        names.append(f"rows:{name}")
    for seed in cases.ARBITRARY_STREAM_SEEDS:
        streams, valid, m, D = cases.arbitrary_row_streams(seed)
        enc = [torch.as_tensor(x[0], device=dev) for x in streams]
        valid = torch.as_tensor(valid[0], device=dev)
        _held(f"decode_rows arbitrary streams {seed}",
              [ops.decode_rows(*enc, m, D, 77, valid=v) for v in (None, valid)],
              [ref.decode_rows_ref(*enc, m, D, 77, valid=v)
               for v in (None, valid)])
        names.append(f"streams:{seed}")
    emit(phase="kernels", kernel="varint_codec", exact_cases=names)

    ndev = 8
    _, degs_cap, ids_cap = wire.fetch_stream_caps(fcap, max_degree)
    t0, t1 = _device_chunks(ndev, ndev * fcap * max_degree)[0]
    L, m, D = (t1 - t0) * ndev, fcap, max_degree
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    results = {"encode_ids": {}, "encode_rows": {}, "decode_rows": {}}

    def row(kernel, mix, shape, kernel_ms, plain_ms, nbytes, **extra):
        bound_ms, bound_by = _bytes_bound(nbytes)
        results[kernel][mix] = dict(
            shape=shape, max_abs_err=0, kernel_ms=kernel_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, **extra)
        emit(phase="kernels", kernel=kernel, mix=mix, **results[kernel][mix])

    # the request lanes: every slot a hole (q1), or 70% live ids
    req_cap = wire.fetch_stream_caps(fcap, max_degree)[0]
    for mix, hole_p in (("none", 1.0), ("70pct", 0.3)):
        ids = _id_lanes(gen, ndev * ndev, fcap, n, dev, hole_p=hole_p)
        want = wire._by_lane_groups(
            lambda i: ref.encode_ids_ref(i, n, req_cap), max(fcap, req_cap),
            ids)
        _held(f"encode_ids {mix}", ops.encode_ids(ids, n, req_cap), want)
        row("encode_ids", mix, f"{ids.shape[0]}x{fcap}",
            cuda_ms(lambda: ops.encode_ids(ids, n, req_cap), iters=20),
            cuda_ms(lambda: wire._by_lane_groups(
                lambda i: ref.encode_ids_ref(i, n, req_cap),
                max(fcap, req_cap), ids), warmup=1, iters=3),
            ids.numel() * 4 + ids.shape[0] * (req_cap + 14))
        del ids, want

    # one responder chunk of rows
    deg_t = torch.as_tensor(degrees, device=dev, dtype=torch.int32)
    rows = _graph_rows(gen, L, m, D, n, deg_t)
    del deg_t
    lane = max(ids_cap, m * D)

    def plain_encode(v):
        return wire._by_lane_groups(
            lambda r, v: ref.encode_rows_ref(r, v, n, degs_cap, ids_cap),
            lane, rows, v)

    def plain_decode(enc, v):
        return wire._by_lane_groups(
            lambda *a: (ref.decode_rows_ref(*a[:5], m, D, n, valid=a[5]),),
            lane, *enc, v)[0]

    for mix, p in (("none", 0.0), ("1pct", 0.01), ("all", 1.0)):
        valid = torch.rand((L, m), generator=gen, device=dev) < p
        nvalid = int(valid.sum())
        enc = ops.encode_rows(rows, valid, n, degs_cap, ids_cap)
        want = plain_encode(valid)
        _held(f"encode_rows {mix}", enc, want)
        del want
        row("encode_rows", mix, f"{L}x{m}x{D}",
            cuda_ms(lambda: ops.encode_rows(rows, valid, n, degs_cap,
                                            ids_cap), warmup=1, iters=5),
            cuda_ms(lambda: plain_encode(valid), warmup=1, iters=1),
            L * m + nvalid * D * 4 + L * (degs_cap + ids_cap + 10),
            valid_rows=nvalid, raw_lanes=int(enc[4].sum()),
            stream_bytes=int(enc[1].sum() + enc[3].sum()))
        enc = enc[:5]
        live = int(enc[1].clamp(0, degs_cap).sum()
                   + enc[3].clamp(0, ids_cap).sum())
        got = ops.decode_rows(*enc, m, D, n, valid=valid)
        _held(f"decode_rows {mix}", (got,), (plain_decode(enc, valid),))
        del got
        row("decode_rows", mix, f"{L}x{m}x{D}",
            cuda_ms(lambda: ops.decode_rows(*enc, m, D, n, valid=valid),
                    warmup=1, iters=5),
            cuda_ms(lambda: plain_decode(enc, valid), warmup=1, iters=1),
            live + L * m + L * m * D * 4 + L * 9, live_bytes=live)
        del enc, valid
        torch.cuda.empty_cache()
    del rows
    torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------------- #
# phase 4: small graph, oracle parity on the card
# --------------------------------------------------------------------------- #
def phase_small():
    from repro_torch.configs.rads import QUERIES, EngineConfig
    from repro_torch.core import (Pattern, canonicalize, enumerate_oracle,
                                  rads_enumerate)
    from repro_torch.graph import erdos_graph, partition
    g = erdos_graph(120, 5.0, seed=5)
    pg = partition(g, 8, method="bfs")
    counts, wire = {}, {}
    for q, edges in QUERIES.items():
        pat = Pattern.from_edges(edges)
        oracle = canonicalize(enumerate_oracle(g, pat), pat)
        runs = {}
        for cache in (True, False):
            for depth in (1, 2):
                cfg = EngineConfig(**SMALL_CAPS, enable_cache=cache,
                                   pipeline_depth=depth)
                runs[cache, depth] = rads_enumerate(pg, pat, cfg,
                                                    device=DEVICE)
        cpu = rads_enumerate(pg, pat, EngineConfig(**SMALL_CAPS),
                             device="cpu")
        on, off = runs[True, 2], runs[False, 2]
        check(canonicalize(on.embeddings, pat) == oracle,
              f"{q}: embeddings differ from the oracle")
        for key in set(on.stats) | set(cpu.stats):
            if key not in TIMING_KEYS:
                check(on.stats.get(key) == cpu.stats.get(key),
                      f"{q}: stat {key} differs between cuda and cpu: "
                      f"{on.stats.get(key)!r} vs {cpu.stats.get(key)!r}")
        check(on.stats["bytes_fetch"] + on.stats["bytes_saved_cache"]
              == off.stats["bytes_fetch"],
              f"{q}: cache on/off does not conserve fetch bytes")
        for cache in (True, False):
            d1, d2 = runs[cache, 1], runs[cache, 2]
            check(d1.count == d2.count and d1.embeddings == d2.embeddings,
                  f"{q}: depth 1 and depth 2 disagree")
            for key in ("bytes_fetch", "bytes_verify", "bytes_saved_cache",
                        "cache_hits", "cache_probes"):
                check(d1.stats[key] == d2.stats[key],
                      f"{q}: depth 1/2 differ on {key}")
        counts[q] = on.count

        # bucketed storage with the varint wire, on the card and the CPU
        fmt_cfg = EngineConfig(**SMALL_CAPS, storage_format="bucketed",
                               wire_format="varint")
        bv = rads_enumerate(pg, pat, fmt_cfg, device=DEVICE)
        bv_cpu = rads_enumerate(pg, pat, fmt_cfg, device="cpu")
        check(canonicalize(bv.embeddings, pat) == oracle,
              f"{q}: bucketed/varint embeddings differ from the oracle")
        for key in set(bv.stats) | set(bv_cpu.stats):
            if key not in TIMING_KEYS:
                check(bv.stats.get(key) == bv_cpu.stats.get(key),
                      f"{q}: bucketed/varint stat {key} differs between "
                      f"cuda and cpu: {bv.stats.get(key)!r} vs "
                      f"{bv_cpu.stats.get(key)!r}")
        for key in ("bytes_fetch", "bytes_verify", "bytes_saved_cache"):
            check(bv.stats[key] == on.stats[key],
                  f"{q}: bucketed/varint {key} differs from dense/raw")
        check(bv.stats["bytes_wire_fetch"] <= bv.stats["bytes_fetch"]
              and bv.stats["bytes_wire_verify"] <= bv.stats["bytes_verify"],
              f"{q}: varint wire bytes exceed the raw accounting")
        wire[q] = (bv.stats["bytes_wire_fetch"], bv.stats["bytes_wire_verify"])
    emit(phase="small", graph="erdos_graph(120, 5.0, seed=5) bfs/8",
         counts=counts, oracle_match=True,
         bucketed_varint_wire_bytes=wire)


# --------------------------------------------------------------------------- #
# phase 5: full scale
# --------------------------------------------------------------------------- #
def _triangles(g) -> int:
    """Independent triangle count: sum of (L @ L) ∘ L, L the strictly
    lower triangle of the adjacency matrix."""
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(g.indices), dtype=np.int64),
                       g.indices, g.indptr), shape=(g.n, g.n))
    low = sp.tril(a, k=-1, format="csr")
    return int((low @ low).multiply(low).sum())


def _shape_counts(shapes: dict) -> dict:
    """Launches by shape, keyed ``"BxM[xK]"`` for JSON."""
    return {"x".join(map(str, k)): v for k, v in sorted(shapes.items())}


def _est_device_ms(shapes: dict, per_row_ms: dict) -> float:
    """Device ms of a run's launches estimated from phase 3: each launch's
    rows times the per-row time of the phase 3 shape of its kind
    ("backedge", "verify" (K = 1) or "intersect")."""
    total = 0.0
    for (B, _, *K), count in shapes.items():
        kind = "intersect" if not K else "verify" if K[0] == 1 else "backedge"
        total += count * B * per_row_ms[kind]
    return total


def phase_full(g, pg, expect: int, setup_s: float, storage: str,
               wire: str, per_row_ms: dict, profile: bool = False):
    """One full-scale q1 run in the given storage and wire formats, with
    every kernel's launch count and launch shapes set to 0 just before it
    and read just after.  With ``profile``, q1 runs once more under
    ``torch.profiler`` through the timed run's ``runner_cache`` (a warm
    call, replaying its graphs; the timed run stays unprofiled) for the
    card's time by kernel.  Returns ``(launches, stats, {wall_s, peak,
    warm})``."""
    import dataclasses

    import torch
    from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.kernels.intersect import ops as inter
    from repro_torch.kernels.membership import ops as memb
    from repro_torch.kernels.varint import ops as varint
    from repro_torch.obs import TraceRecorder
    kernels = {"membership": memb, "intersect": inter, "varint": varint}
    cfg = dataclasses.replace(DEFAULT_ENGINE, storage_format=storage,
                              wire_format=wire)
    pat = Pattern.from_edges(QUERIES["q1"])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracer = TraceRecorder(capacity=1 << 20)
    for mod in kernels.values():
        mod.launches = 0
    varint.launches_by_variant = dict.fromkeys(varint.VARIANTS, 0)
    memb.shapes.clear()
    inter.shapes.clear()
    # the profiled rerun replays this run's graphs
    rc = {} if profile else None
    t0 = time.perf_counter()
    res = rads_enumerate(pg, pat, cfg, return_embeddings=False,
                         tracer=tracer, runner_cache=rc, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernels.items()}
    launches.update({f"varint.{v}": k
                     for v, k in varint.launches_by_variant.items()})
    shapes = {"membership": dict(memb.shapes),
              "intersect": dict(inter.shapes)}
    peak = torch.cuda.max_memory_allocated()
    # host time per span kind: stages only enqueue work, so the time the
    # card needs shows up in the retire spans (the one copy per wave)
    spans: dict = {}
    for ph, name, _, _, dur, _, _ in tracer.records():
        if ph == "X" and not name.startswith("phase"):
            kind = name.split(":")[0]
            c, ms = spans.get(kind, (0, 0.0))
            spans[kind] = (c + 1, ms + dur / 1e3)
    st = res.stats
    tag = f"{storage}/{wire}"
    check(res.count == expect,
          f"full-scale q1 ({tag}) count {res.count} != scipy triangles "
          f"{expect}")
    check(launches["membership"] > 0,
          f"membership kernel never launched ({tag})")
    if storage == "bucketed":
        check(launches["intersect"] > 0, "intersect kernel never launched")
    if wire == "varint":
        for v in ("encode_ids", "encode_rows", "decode_rows"):
            check(launches[f"varint.{v}"] > 0,
                  f"varint {v} kernel never launched ({tag})")
    n = g.n
    emit(phase="full", storage=storage, wire=wire, n=n, published_n=FULL_N,
         cut=n != FULL_N, cut_reason=CUT_REASON if n == SMOKE_N else None,
         edges=g.n_edges, max_degree=g.max_degree, setup_s=setup_s,
         wall_s=wall, count=res.count, triangles_scipy=expect,
         launches=launches, n_waves=st["n_waves"], n_groups=st["n_groups"],
         sme_pipeline_s=st.get("sme_pipeline_s", 0.0),
         dist_pipeline_s=st.get("dist_pipeline_s", 0.0),
         overflow_retries=st["overflow_retries"],
         cap_escalations=st["cap_escalations"], final_caps=st["final_caps"],
         n_sme_seeds=st["n_sme_seeds"], n_dist_seeds=st["n_dist_seeds"],
         bytes_fetch=st["bytes_fetch"], bytes_verify=st["bytes_verify"],
         bytes_wire_fetch=st["bytes_wire_fetch"],
         bytes_wire_verify=st["bytes_wire_verify"],
         bytes_saved_cache=st["bytes_saved_cache"],
         cache_hit_rate=st["cache_hit_rate"],
         peak_adj_bytes=st["peak_adj_bytes"], max_memory_allocated=peak,
         host_span_count_ms=spans,
         launch_shapes={k: _shape_counts(v) for k, v in shapes.items()},
         est_kernel_device_ms={
             k: _est_device_ms(v, per_row_ms) for k, v in shapes.items()})
    run = dict(wall_s=wall, peak=peak)
    if profile:
        run["warm"] = _profile_full(pg, pat, cfg, expect, tag, rc)
    return launches, st, run


# each varint variant's passes, by the name its kernels share: a launch
# enqueues that many kernels
VARINT_PASSES = {"varint_ids": {"encode_ids": 3, "delta_vlen": 2},
                 "varint_rows": {"encode_rows": 3},
                 "varint_decode": {"decode_rows": 3}}


def _profile_full(pg, pat, cfg, expect: int, tag: str, rc: dict) -> dict:
    """q1 once more under ``torch.profiler`` (device activity only),
    through the timed run's ``runner_cache`` ``rc``: a warm call that
    starts from the capacities the timed run escalated to, replays the
    graphs it captured there and captures the SM-E ladder at them.  The card's busy time and idle share, membership's,
    intersect's and the varint codec's device ms and kernels (which must
    be this call's launches, times each varint variant's passes), and
    the top 8 other kernels.  Returns the row."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import rads_enumerate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before = _rads_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res = rads_enumerate(pg, pat, cfg, return_embeddings=False,
                             runner_cache=rc, device=DEVICE)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    launches = {k: n - before[k] for k, n in _rads_counts().items()}
    check(res.count == expect, f"profiled q1 ({tag}) count {res.count} != "
                               f"scipy triangles {expect}")
    split = _kernel_times(prof, wall, named=("membership", "intersect",
                                             *VARINT_PASSES))
    want = dict(launches)
    for name, passes in VARINT_PASSES.items():
        want[name] = sum(k * launches[f"varint.{v}"]
                         for v, k in passes.items())
    for name, row in split["named"].items():
        check(row["count"] == want[name],
              f"profiled q1 ({tag}) shows {row['count']} {name} kernels, "
              f"its launches give {want[name]}")
    row = dict(phase="full_profile", storage=cfg.storage_format,
               wire=cfg.wire_format, warm=True, launches=launches,
               captures=res.stats["compiles"], n_waves=res.stats["n_waves"],
               cap_escalations=res.stats["cap_escalations"],
               added_s=time.perf_counter() - t0, **split)
    emit(**row)
    return row


# --------------------------------------------------------------------------- #
# phase 6: LM kernels vs plain versions
# --------------------------------------------------------------------------- #
def _compare(got, want, tol: float, per_row: bool = False):
    """``(ok, max_abs_err, elem_ratio, row_ratio)``.  ``elem_ratio`` is the
    largest ``|got - want| / (tol + tol * |want|)``: the elementwise check
    of ``tests/test_kernels.py`` holds iff it is at most 1.  ``row_ratio``
    is the largest error of an output row over ``tol`` times that row's
    largest ``|want|``.  The check is elementwise, or by rows where
    ``per_row`` is set (see ``MOE_ROW_CHECK``)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    elem = float((diff / (tol + tol * w.abs())).max())
    row = float((diff.amax(-1) / (tol * w.abs().amax(-1)).clamp_min(1e-30))
                .max())
    return (row if per_row else elem) <= 1, float(diff.max()), elem, row


def _bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The larger of the byte time at the HBM rate and the operation time
    at the type's peak (bf16 tensor cores; f32 outside them)."""
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else ALU_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_work(B, Sq, Skv, H, Hk, D, causal, dtype, Dv=None):
    """(bytes, flops): q and o, k and v once each; 2·(D + Dv) flops per
    (query, key) pair kept, half the square when causal (Dv defaults to
    D)."""
    Dv = D if Dv is None else Dv
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (B * Sq * H * (D + Dv) + B * Skv * Hk * (D + Dv))
    pairs = B * H * Sq * Skv / (2 if causal else 1)
    return nbytes, 2 * pairs * (D + Dv)


def _moe_work(E, C, d, f, dtype):
    """(bytes, flops): x and out once, the three weight stacks once;
    6·E·C·d·f flops."""
    esize = 2 if dtype == "bfloat16" else 4
    return esize * (2 * E * C * d + 3 * E * d * f), 6 * E * C * d * f


def _timed(row, work, dtype):
    """The row's bound and what the kernel achieved: TFLOP/s and GB/s of
    the work it had to do."""
    nbytes, flops = work
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dtype)
    row["tflop_s"] = flops / row["kernel_ms"] / 1e9
    row["gb_s"] = nbytes / row["kernel_ms"] / 1e6
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]


def _variant_of(ops, before: dict) -> str:
    """The one variant whose count rose by one since ``before``."""
    rose = [k for k, n in ops.launches_by_variant.items()
            if n != before.get(k, 0)]
    check(len(rose) == 1 and ops.launches_by_variant[rose[0]]
          == before.get(rose[0], 0) + 1,
          f"expected one launch of one variant, got {before} -> "
          f"{ops.launches_by_variant}")
    return rose[0]


def phase_lm_kernels():
    """flash_attn and moe_gemm against their plain versions in float32 and
    bfloat16: the test sweep shapes, the tensor-core variants' edges,
    then the serving shapes, timed beside the bound, the plain version
    and the library yardstick (``scaled_dot_product_attention``; three
    ``bmm`` and ``silu``).  Each row names the variant that ran; the
    serving rows must take "wgmma" in bf16 ("stream" at decode).  Returns
    the timed rows; the kernels line takes the bfloat16 ones."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ops as moe
    from repro_torch.kernels.moe_gemm.ref import (bound_ratio, moe_down_ref,
                                                  moe_gemm_f64, moe_gemm_ref,
                                                  moe_hidden_ref)
    dev = torch.device(DEVICE)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows = {}
    plains = {
        "naive": lambda q, k, v, causal, off: flash.flash_attention_plain(
            q, k, v, causal=causal, q_offset=off),
        # the same plain version, named apart at 32k: it works 1,024
        # queries at a time, where whole (16, 32,768, 32,768) f32 scores
        # would take 68.7 GB
        "chunked": lambda q, k, v, causal, off: flash.flash_attention_plain(
            q, k, v, causal=causal, q_offset=off)}

    def held(row, got, want, tol, per_row=False):
        ok, err, elem, rowr = _compare(got, want, tol, per_row)
        row.update(max_abs_err=err, elem_ratio=elem, row_ratio=rowr, tol=tol,
                   check="row" if per_row else "elementwise")
        check(ok, f"{row['kernel']} {row['shape']} {row['dtype']} "
                  f"({row['variant']}) disagrees: max abs err {err}, "
                  f"elementwise ratio {elem}, row ratio {rowr}, tol {tol}, "
                  f"check {row['check']}")

    def flash_case(name, B, Sq, Skv, H, Hk, D, dtype, causal=True,
                   q_offset=0, plain="naive", timed=False, iters=5,
                   variant=None):
        dt = dts[dtype]
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Skv, Hk, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Skv, Hk, D), generator=gen, device=dev).to(dt)
        row = dict(kernel="flash_attn", shape=name, dtype=dtype, B=B, Sq=Sq,
                   Skv=Skv, H=H, Hk=Hk, D=D, causal=causal,
                   q_offset=q_offset, plain=plain)
        ref = plains[plain]
        before = dict(flash.launches_by_variant)
        got = flash.flash_attention_k(q, k, v, causal=causal,
                                      q_offset=q_offset)
        row["variant"] = _variant_of(flash, before)
        want = ref(q, k, v, causal, q_offset)
        torch.cuda.synchronize()
        check(variant is None or row["variant"] == variant,
              f"flash {name} {dtype} ran {row['variant']}, not {variant}")
        check(bool(torch.isfinite(got).all()), f"flash {name} not finite")
        held(row, got, want, FLASH_TOL[dtype])
        del got, want
        if timed:
            row["kernel_ms"] = cuda_ms(lambda: flash.flash_attention_k(
                q, k, v, causal=causal, q_offset=q_offset), warmup=1,
                iters=iters)
            row["plain_ms"] = cuda_ms(lambda: ref(q, k, v, causal, q_offset),
                                      warmup=1, iters=2)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row["library_ms"] = (cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
                warmup=1, iters=iters)
                if H == Hk and q_offset == 0 else None)
            del qt, kt, vt
            if row["variant"] != "simt":   # the previous kernel, same inputs
                o = torch.empty_like(q)
                row["simt_ms"] = cuda_ms(lambda: flash_kernel.flash_attn_cuda(
                    q, k, v, o, causal, q_offset, "simt"), warmup=1,
                    iters=2)
                del o
            _timed(row, _flash_work(B, Sq, Skv, H, Hk, D, causal, dtype),
                   dtype)
        emit(phase="lm_kernels", **row)
        del q, k, v
        torch.cuda.empty_cache()
        return row

    def moe_case(name, E, C, d, f, dtype, w_scale, timed=False, iters=5,
                 variant=None, end_to_end=True):
        dt = dts[dtype]
        x = torch.randn((E, C, d), generator=gen, device=dev).to(dt)
        wg, wu = ((torch.randn((E, d, f), generator=gen, device=dev)
                   * w_scale).to(dt) for _ in range(2))
        wd = (torch.randn((E, f, d), generator=gen, device=dev)
              * w_scale).to(dt)
        row = dict(kernel="moe_gemm", shape=name, dtype=dtype, E=E, C=C, d=d,
                   f=f)
        before = dict(moe.launches_by_variant)
        got = moe.moe_gemm(x, wg, wu, wd)
        row["variant"] = _variant_of(moe, before)
        want = moe_gemm_ref(x, wg, wu, wd)
        torch.cuda.synchronize()
        check(variant is None or row["variant"] == variant,
              f"moe {name} {dtype} ran {row['variant']}, not {variant}")
        tol = MOE_TOL[dtype]
        if dtype == "float32":
            held(row, got, want, tol, per_row=(dtype, C) == MOE_ROW_CHECK)
        else:
            # bf16: each pass against its plain version, elementwise at
            # tol; h and the output against the function computed exactly
            # (moe_gemm_f64: h within one bf16 rounding, the output within
            # the bound of every rounding), the plain version too, which
            # shows the bound holds a correct run; and end to end against
            # the plain version at tol, except where end_to_end is off (see
            # MOE_TOL)
            h = torch.empty((E, C, f), dtype=dt, device=dev)
            again = torch.empty_like(x)
            moe_kernel.moe_gemm_cuda(x, wg, wu, wd, h, again, row["variant"])
            h_plain = moe_hidden_ref(x, wg, wu)
            torch.cuda.synchronize()
            check(torch.equal(again, got), f"moe {name}: two launches differ")
            ok_h, err_h, elem_h, _ = _compare(h, h_plain, tol)
            row.update(h_max_abs_err=err_h, h_elem_ratio=elem_h,
                       h_share_differing=float((h != h_plain).float().mean()))
            check(ok_h, f"moe_gemm {name} bf16 ({row['variant']}) gate/up "
                        f"pass disagrees: h elementwise ratio {elem_h}")
            held(row, got, moe_down_ref(h, wd), tol)
            row["down_elem_ratio"] = row.pop("elem_ratio")
            del row["row_ratio"]
            exact = moe_gemm_f64(x, wg, wu, wd)
            ratios = dict(
                h_exact_ratio=bound_ratio(h, exact["h"], exact["h_bound"]),
                exact_ratio=bound_ratio(got, exact["out"],
                                        exact["out_bound"]),
                plain_h_exact_ratio=bound_ratio(h_plain, exact["h"],
                                                exact["h_bound"]),
                plain_exact_ratio=bound_ratio(want, exact["out"],
                                              exact["out_bound"]))
            row.update(ratios)
            # the plain version against the exact function at tol
            row["plain_vs_exact_elem_ratio"] = _compare(want, exact["out"],
                                                        tol)[2]
            del exact, h, again, h_plain
            for key, val in ratios.items():
                check(val <= 1, f"moe_gemm {name} bf16 ({row['variant']}) "
                                f"{key} {val} > 1")
            _, row["max_abs_err"], row["elem_ratio"], _ = _compare(
                got, want, tol)
            row["check"] = ("per_pass, exact, elementwise" if end_to_end
                            else "per_pass, exact")
            check(not end_to_end or row["elem_ratio"] <= 1,
                  f"moe_gemm {name} bf16 ({row['variant']}) disagrees end "
                  f"to end: elementwise ratio {row['elem_ratio']}")
        del got, want
        if timed:
            row["kernel_ms"] = cuda_ms(lambda: moe.moe_gemm(x, wg, wu, wd),
                                       warmup=1, iters=iters)
            row["plain_ms"] = cuda_ms(lambda: moe_gemm_ref(x, wg, wu, wd),
                                      warmup=1, iters=3)
            row["library_ms"] = cuda_ms(lambda: torch.bmm(
                F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd),
                warmup=1, iters=iters)
            if row["variant"] != "simt":   # the previous kernel, same inputs
                h, o = torch.empty((E, C, f), dtype=dt, device=dev), \
                    torch.empty_like(x)
                row["simt_ms"] = cuda_ms(lambda: moe_kernel.moe_gemm_cuda(
                    x, wg, wu, wd, h, o, "simt"), warmup=1,
                    iters=min(iters, 3))
                del h, o
            _timed(row, _moe_work(E, C, d, f, dtype), dtype)
        emit(phase="lm_kernels", **row)
        del x, wg, wu, wd
        torch.cuda.empty_cache()
        return row

    for dtype in ("float32", "bfloat16"):
        for S, H, Hk, D in [(64, 4, 2, 32), (128, 2, 2, 16)]:   # the sweep
            flash_case(f"sweep_{S}x{H}x{Hk}x{D}", 2, S, S, H, Hk, D, dtype)
        flash_case("ragged_100_non_causal", 1, 100, 150, 4, 1, 64, dtype,
                   causal=False)
        for E, C, d, f in [(4, 64, 32, 64), (2, 128, 16, 128)]:  # the sweep
            moe_case(f"sweep_{E}x{C}x{d}x{f}", E, C, d, f, dtype, 0.1)
        moe_case("ragged_5x37x48x40", 5, 37, 48, 40, dtype, 0.1)
    # the bf16 variants' edges: ragged query and key tiles (128 each),
    # q_offset past a tile, D = 64 (one panel), GQA 32/8 below; moe_gemm
    # at C = 8 (the last stream shape) and C = 9 (the first wgmma one)
    bf = "bfloat16"
    flash_case("ragged_q_and_kv", 1, 333, 333, 4, 2, 128, bf,
               variant="wgmma")
    flash_case("q_offset_200", 1, 300, 500, 4, 4, 128, bf, q_offset=200,
               variant="wgmma")
    flash_case("d64_gqa_14_2", 2, 1000, 1000, 14, 2, 64, bf,
               variant="wgmma")
    moe_case("c8_stream", 8, 8, 2048, 1024, bf, 64 ** -0.5,
             variant="stream")
    moe_case("c9_wgmma", 8, 9, 2048, 1024, bf, 64 ** -0.5, variant="wgmma",
             end_to_end=False)
    moe_case("ragged_c130_d72_f136", 3, 130, 72, 136, bf, 0.1,
             variant="wgmma")
    # the serving shapes: OLMoE's prefill (B*H = 64, S = 4,096, D = 128),
    # a qwen3-4b-like GQA 32/8, and the 32k prefill; the expert FFN at the
    # 4 x 4,096 prefill (C = 2,560), at decode (C = 1) and at the 32k
    # prefill (C = 5,120), weights at the model's init scale 1/sqrt(E)
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH).model
    H, D, mo = cfg.n_heads, cfg.head_dim, cfg.moe
    E, d, f = mo.n_experts, cfg.d_model, mo.d_expert

    def capacity(T):
        return max(int(T * mo.top_k / E * mo.capacity_factor), 1)

    bf16_variant = {"float32": "simt", "bfloat16": "wgmma"}
    for dtype in ("float32", "bfloat16"):
        rows["flash_attn", dtype] = flash_case(
            "serve_prefill", SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, H, H, D,
            dtype, timed=True, variant=bf16_variant[dtype])
        flash_case("gqa_32_8", 2, SERVE_PROMPT, SERVE_PROMPT, 32, 8, 128,
                   dtype, variant=bf16_variant[dtype])
        rows["moe_gemm", dtype] = moe_case(
            "serve_prefill", E, capacity(SERVE_BATCH * SERVE_PROMPT), d, f,
            dtype, E ** -0.5, timed=True, iters=3,
            variant=bf16_variant[dtype], end_to_end=False)
        rows["moe_gemm_decode", dtype] = moe_case(
            "serve_decode", E, capacity(SERVE_BATCH), d, f, dtype, E ** -0.5,
            timed=True, iters=20,
            variant="stream" if dtype == "bfloat16" else "simt")
    rows["flash_attn_32k"] = flash_case(
        "prefill_32k", 1, LONG_PROMPT, LONG_PROMPT, H, H, D, "bfloat16",
        plain="chunked", timed=True, iters=2, variant="wgmma")
    rows["moe_gemm_32k"] = moe_case(
        "prefill_32k", E, capacity(LONG_PROMPT), d, f, "bfloat16", E ** -0.5,
        timed=True, iters=2, variant="wgmma", end_to_end=False)
    return rows


# --------------------------------------------------------------------------- #
# phases 7-8: the LM serving path
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def _plain_kernels(active: bool, q_chunk: int = 1024):
    """While active, the kernel wrappers the models call (flash_attn,
    moe_gemm, segment_spmm and gat_aggregate) are swapped for their plain
    versions, so the models run the port's plain path on the card; the
    training path's backward wrappers too, and the differentiable
    segment_spmm entries (the GNNs', DIN's bag) for autograd through the
    plain versions; DIN's table gradients then sum by id with the plain
    "sum".  flash_attn's plain forward and backward take ``q_chunk``
    queries at a time (the plain versions' default).  Only the parity
    checks (phases 7, 10, 13, 16, 19-21) and serve_bulk's check of its
    first rows turn it on here; ``tools/dsv3_lr_sweep.py`` trains through
    it."""
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.flash_attn import ref as flash_ref
    from repro_torch.kernels.moe_gemm import ops as moe
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref, moe_gemm_ref
    from repro_torch.kernels.segment_spmm import ops as spmm
    if not active:
        yield
        return
    saved = (flash.flash_attention_k, flash.flash_attention_bwd_k,
             flash.flash_attention_ref, moe.moe_gemm, moe.moe_gemm_bwd_k,
             spmm.segment_spmm, spmm.gat_aggregate, spmm.segment_spmm_ad,
             spmm.gat_aggregate_ad)
    flash.flash_attention_k = flash.flash_attention_plain
    flash.flash_attention_ref = functools.partial(
        flash_ref.flash_attention_ref, q_chunk=q_chunk)
    flash.flash_attention_bwd_k = functools.partial(
        flash_ref.flash_attention_bwd_ref, q_chunk=q_chunk)
    moe.moe_gemm = moe_gemm_ref
    moe.moe_gemm_bwd_k = moe_gemm_bwd_ref
    spmm.segment_spmm = spmm.segment_spmm_plain
    spmm.gat_aggregate = spmm.gat_aggregate_plain
    # the GNN training entries: autograd through the plain versions
    spmm.segment_spmm_ad = spmm.segment_spmm_plain
    spmm.gat_aggregate_ad = (
        lambda hw, s_src, s_dst, plan, mask, acc, plan_by_src:
        spmm.gat_aggregate_plain(hw, s_src, s_dst, plan, mask, acc))
    try:
        yield
    finally:
        (flash.flash_attention_k, flash.flash_attention_bwd_k,
         flash.flash_attention_ref, moe.moe_gemm, moe.moe_gemm_bwd_k,
         spmm.segment_spmm, spmm.gat_aggregate, spmm.segment_spmm_ad,
         spmm.gat_aggregate_ad) = saved


def _lm_launches() -> dict:
    """Launches of the two LM kernels, and the same by variant."""
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.moe_gemm import ops as moe
    return {"flash_attn": flash.launches, "moe_gemm": moe.launches,
            "by_variant": {
                "flash_attn": {k: n for k, n in
                               flash.launches_by_variant.items() if n},
                "moe_gemm": {k: n for k, n in
                             moe.launches_by_variant.items() if n}}}


def _zero_lm_launches() -> None:
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.moe_gemm import ops as moe
    for ops in (flash, moe):
        ops.launches = 0
        ops.launches_by_variant = dict.fromkeys(ops.VARIANTS, 0)


def _lm_want(flash: dict, moe: dict) -> dict:
    """What ``_lm_launches`` must read: launches by variant per kernel."""
    return {"flash_attn": sum(flash.values()), "moe_gemm": sum(moe.values()),
            "by_variant": {"flash_attn": flash, "moe_gemm": moe}}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def _router(choices: list, pin: bool):
    """While active, every ``moe_block`` records its router's decision, the
    experts and their gates, into ``choices`` or, with ``pin``, takes the
    next recorded one instead of its own.  lm_parity's bf16 run pins the
    kernel path to the plain path's decisions: top-8 of 64 on bf16 scores
    flips for near-tied tokens under any change of rounding, and a flipped
    token's output changes by whole experts.  The router is plain PyTorch
    on both paths, not a kernel."""
    from repro_torch.models import layers
    orig = layers.moe_route
    pinned = iter(list(choices)) if pin else None

    def route(p, cfg, xt):
        sel, gates, probs_mean = orig(p, cfg, xt)
        if pinned is None:
            choices.append((sel, gates))
            return sel, gates, probs_mean
        sel, gates = next(pinned)
        return sel, gates, probs_mean

    layers.moe_route = route
    try:
        yield
    finally:
        layers.moe_route = orig


def _parity_run(model, prompt, feed, plain: bool, choices=None,
                pin: bool = False, absorbed: bool = False):
    """Prefill ``prompt`` and PARITY_DECODE decode steps fed ``feed``,
    through the kernel path or (``plain``) the plain path, the router
    recording or pinned (``_router``) when ``choices`` is given: ``(logits,
    cache, step logits, launches)``."""
    import torch
    from repro_torch.models import decode_step, prefill
    router = (_router(choices, pin) if choices is not None
              else contextlib.nullcontext())
    with _plain_kernels(plain), router:
        _zero_lm_launches()
        logits, cache = prefill(model, prompt,
                                max_len=PARITY_PROMPT + PARITY_DECODE)
        steps = []
        for i in range(PARITY_DECODE):
            lg, cache = decode_step(model, cache, feed[:, i],
                                    PARITY_PROMPT + i, absorbed=absorbed)
            steps.append(lg)
        torch.cuda.synchronize()
        return logits, cache, steps, _lm_launches()


def _parity_rel(a, b) -> dict:
    """Relative errors of one ``_parity_run`` against another: prefill
    logits, each cache entry, each step's logits."""
    (lk, ck, sk, _), (lp, cp, sp, _) = a, b
    rel = {"prefill_logits": _rel(lk, lp)}
    rel.update({f"cache_{k}": _rel(ck[k], cp[k]) for k in cp})
    for i, (x, y) in enumerate(zip(sk, sp)):
        rel[f"decode_{i}"] = _rel(x, y)
    return rel


def phase_lm_parity():
    """OLMoE-1B-7B at full width and PARITY_LAYERS layers: the kernel path
    against the plain path, same weights and prompt, through prefill
    (logits and cache) and PARITY_DECODE decode steps fed the same tokens.
    In float32 (the simt variants) each is held to a relative 1e-3.  In
    bfloat16 (the tensor-core and stream variants) each is held to 5e-2
    with the kernel path's router decisions pinned to the plain path's
    (see ``_router``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params
    dev = torch.device(DEVICE)
    L = PARITY_LAYERS
    want = {"float32": _lm_want({"simt": L},
                                {"simt": L * (1 + PARITY_DECODE)}),
            "bfloat16": _lm_want({"wgmma": L}, {"wgmma": L,
                                                "stream": L * PARITY_DECODE})}

    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        cfg = dataclasses.replace(get_config(LM_ARCH).model, dtype=dtype,
                                  n_layers=L)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        model = init_lm_params(gen, cfg, device=dev)
        tokens = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT
                                              + PARITY_DECODE),
                               generator=gen, device=dev)
        prompt, feed = tokens[:, :PARITY_PROMPT], tokens[:, PARITY_PROMPT:]
        chosen = [] if dtype == "bfloat16" else None
        plain = _parity_run(model, prompt, feed, True, chosen)
        kern = _parity_run(model, prompt, feed, False, chosen, pin=True)
        check(kern[3] == want[dtype], f"lm_parity {dtype} kernel path "
                                      f"launches {kern[3]} != {want[dtype]}")
        check(plain[3] == _lm_want({}, {}),
              f"lm_parity {dtype} plain path launched kernels: {plain[3]}")
        rel = _parity_rel(kern, plain)
        for key, val in rel.items():
            check(val <= tol, f"lm_parity {dtype} {key}: kernel vs plain rel "
                              f"{val} > {tol}")
        emit(phase="lm_parity", arch=LM_ARCH, n_layers=L, dtype=dtype,
             batch=PARITY_BATCH, prompt=PARITY_PROMPT,
             decode_steps=PARITY_DECODE, rel_err=rel, tol=tol,
             router="free" if chosen is None else
             f"pinned to the plain path ({len(chosen)} router calls)",
             kernel_launches=kern[3])
        del model, plain, kern
        torch.cuda.empty_cache()


def _serve_once(model, prompts, absorbed: bool = False,
                last_only: bool = False, keep_cache: bool = False):
    """Prefill with SERVE_MAX_LEN, then SERVE_DECODE greedy decode steps,
    each timed on the host clock to a synchronise.  With ``keep_cache``,
    also a copy of the cache as prefill left it (``cache0``), from which
    another decode can replay the steps."""
    import torch
    from repro_torch.models import decode_step, prefill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(model, prompts, max_len=SERVE_MAX_LEN,
                            last_only=last_only)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    nxt = logits[:, -1].argmax(-1)
    del logits
    out = {}
    if keep_cache:
        out["cache0"] = {k: v.clone() for k, v in cache.items()}
    toks, step_ms = [nxt], []
    for i in range(SERVE_DECODE):
        t0 = time.perf_counter()
        lg, cache = decode_step(model, cache, nxt, SERVE_PROMPT + i,
                                absorbed=absorbed)
        nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(lg).all()
        toks.append(nxt)
    launches = _lm_launches()
    return dict(out, tokens=torch.stack(toks, 1), prefill_s=prefill_s,
                step_ms=step_ms, finite=bool(finite), launches=launches,
                peak=torch.cuda.max_memory_allocated())


def _kernel_times(prof, wall_ms: float, top: int = 8,
                  named: tuple = ()) -> dict:
    """Device time by kernel from a ``torch.profiler`` run: the card's
    busy time (the sum of kernel times; one stream, so they do not
    overlap), its idle share of the wall time, and the top kernels.  The
    kernels whose names hold one of ``named`` are summed under that name
    and left out of the top."""
    from torch.autograd import DeviceType
    kern = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kern.append((e.key, us / 1e3, e.count))
    kern.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kern)
    out = dict(wall_ms=wall_ms, busy_ms=busy if kern else None,
               idle_share=1 - busy / wall_ms if kern else None)
    if named:
        out["named"] = {w: dict(ms=sum(ms for k, ms, _ in kern if w in k),
                                count=sum(n for k, _, n in kern if w in k))
                        for w in named}
        kern = [r for r in kern if not any(w in r[0] for w in named)]
    out["top"] = [dict(kernel=k[:80], ms=ms, count=n)
                  for k, ms, n in kern[:top]]
    return out


def _profile_serve(model, prompts, steps: int = 3, absorbed: bool = False,
                   last_only: bool = False, named: tuple = ()):
    """One prefill and ``steps`` decode steps under ``torch.profiler``:
    where the card's time goes, and how long it idles (the kernels whose
    names hold one of ``named`` summed apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, prefill
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill(model, prompts, max_len=SERVE_MAX_LEN,
                                last_only=last_only)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    pre = _kernel_times(prof, wall, named=named)
    nxt = logits[:, -1].argmax(-1)
    del logits
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = decode_step(model, cache, nxt, SERVE_PROMPT + i,
                                    absorbed=absorbed)
            nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dec = _kernel_times(prof, wall, named=named)
    emit(phase="lm_profile", arch=model.cfg.name, batch=SERVE_BATCH,
         prompt=SERVE_PROMPT, prefill=pre, decode=dict(steps=steps, **dec))
    del cache


def phase_lm_serve():
    """OLMoE-1B-7B, full depth and width, bf16, seeded random weights on
    the card: (a) SERVE_BATCH prompts of SERVE_PROMPT tokens, prefill and
    SERVE_DECODE greedy decode steps, twice; (b) one prompt of LONG_PROMPT
    tokens, prefill with ``last_only``.  Returns run (a)'s launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params, prefill
    dev = torch.device(DEVICE)
    cfg = get_config(LM_ARCH).model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_lm_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    runs = [_serve_once(model, prompts) for _ in range(2)]
    L = cfg.n_layers
    # prefill through the tensor-core variants, decode through stream
    want = _lm_want({"wgmma": L}, {"wgmma": L, "stream": L * SERVE_DECODE})
    for r in runs:
        check(r["finite"], "lm_serve (a): logits not finite")
        check(r["launches"] == want,
              f"lm_serve (a) launches {r['launches']} != {want}")
    check(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
          "lm_serve (a): two runs gave different tokens")
    _profile_serve(model, prompts)
    del prompts
    torch.cuda.empty_cache()

    long_prompt = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), generator=gen,
                                device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(model, long_prompt, last_only=True)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    long_launches = _lm_launches()
    check(logits.shape == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "lm_serve (b): logits not finite or misshapen")
    check(long_launches == _lm_want({"wgmma": L}, {"wgmma": L}),
          f"lm_serve (b) launches {long_launches}")
    long_peak = torch.cuda.max_memory_allocated()
    del logits, cache, long_prompt, model
    torch.cuda.empty_cache()

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    emit(phase="lm_serve", arch=LM_ARCH, n_layers=L, dtype=cfg.dtype,
         n_params=n_params, weight_bytes=weight_bytes, init_s=init_s,
         serve=[dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                     max_len=SERVE_MAX_LEN, decode_steps=SERVE_DECODE,
                     prefill_s=r["prefill_s"],
                     prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT
                     / r["prefill_s"],
                     decode_ms_p50=pct(r["step_ms"], 50),
                     decode_ms_p90=pct(r["step_ms"], 90),
                     decode_ms_first=r["step_ms"][0],
                     peak_bytes=r["peak"], launches=r["launches"],
                     finite=r["finite"]) for r in runs],
         tokens_equal=True,
         prefill_32k=dict(batch=1, prompt=LONG_PROMPT, last_only=True,
                          prefill_s=long_s,
                          prefill_tokens_per_s=LONG_PROMPT / long_s,
                          peak_bytes=long_peak, launches=long_launches),
         cuts={"prefill_32k": "global batch 32 -> 1",
               "decode_32k": "batch 128 at 32,768 context -> batch 4 at "
                             "4,160"})
    return runs[0]["launches"]


# --------------------------------------------------------------------------- #
# phases 9-11: the GNN forward
# --------------------------------------------------------------------------- #
def _gnn_dims(name: str) -> dict:
    """The dims of one of the port's ``GNN_SHAPES`` cells."""
    from repro_torch.configs import GNN_SHAPES
    return next(s for s in GNN_SHAPES if s.name == name).dims


def products_graph(seed: int = 0) -> dict:
    """A seeded stand-in for ogbn-products at its published size
    (``GNN_SHAPES`` ``ogb_products``): N nodes and E edge slots, all live.
    ``src`` is uniform.  ``dst`` follows a Zipf-like law: node rank
    ``N * u**ZIPF_POWER`` for a uniform ``u``, so that P(rank < r) =
    (r/N)**(1/ZIPF_POWER), mapped through a random permutation so that
    the hubs lie anywhere.  The power puts about 17,000 edges on the
    largest hub, the order of ogbn-products' largest degree, and leaves
    the mean at E/N = 25.3."""
    rng = np.random.default_rng(seed)
    dims = _gnn_dims("ogb_products")
    N, E = dims["n_nodes"], dims["n_edges"]
    src = rng.integers(0, N, E, dtype=np.int32)
    rank = (N * rng.random(E) ** ZIPF_POWER).astype(np.int32)
    np.minimum(rank, N - 1, out=rank)
    dst = rng.permutation(N).astype(np.int32)[rank]
    return dict(edge_src=src, edge_dst=dst, edge_mask=np.ones(E, bool))


def cora_graph(seed: int = 1) -> dict:
    """A seeded stand-in for Cora at ``full_graph_sm``'s published shape
    (2,708 nodes, 10,556 uniform random edges, all live, 1,433 features)
    with SchNet's positions at twice a standard normal."""
    rng = np.random.default_rng(seed)
    dims = _gnn_dims("full_graph_sm")
    N, E = dims["n_nodes"], dims["n_edges"]
    return dict(
        node_feats=rng.normal(size=(N, dims["d_feat"])).astype(np.float32),
        edge_src=rng.integers(0, N, E).astype(np.int32),
        edge_dst=rng.integers(0, N, E).astype(np.int32),
        edge_mask=np.ones(E, bool),
        positions=(2.0 * rng.normal(size=(N, 3))).astype(np.float32))


def minibatch_dst() -> tuple:
    """``(dst, N)`` of one sampled minibatch at ``minibatch_lg``'s
    capacity, ``sample_capacities(1024, (15, 10))``: each of the 1,024
    seeds takes 15 in-edges and each of its 15,360 first-hop nodes 10
    (169,984 nodes, 168,960 edges)."""
    dims = _gnn_dims("minibatch_lg")
    seeds, f0, f1 = dims["batch_nodes"], dims["fanout0"], dims["fanout1"]
    hop1 = seeds * f0
    dst = np.concatenate([np.repeat(np.arange(seeds), f0),
                          seeds + np.repeat(np.arange(hop1), f1)])
    return dst.astype(np.int32), seeds + hop1 + hop1 * f1


def _f64_sums(msgs, dst, n: int, chunk: int = 1 << 23):
    """The sums and the sums of |msg| by destination in float64, a chunk
    of edges at a time."""
    import torch
    s = torch.zeros((n, msgs.shape[1]), dtype=torch.float64,
                    device=msgs.device)
    a = torch.zeros_like(s)
    for i in range(0, msgs.shape[0], chunk):
        m = msgs[i:i + chunk].double()
        s.index_add_(0, dst[i:i + chunk], m)
        a.index_add_(0, dst[i:i + chunk], m.abs_())
    return s, a


def _elem_ratio(got, s, tol: float) -> float:
    """The largest ``|got - s| / (tol + tol * |s|)`` against the float64
    sums ``s``: the elementwise check of ``tests/test_kernels.py``, held
    against exact sums."""
    return float(((got.double() - s).abs_() / (tol + tol * s.abs())).max())


def _sum_ratio(got, s, a, out_bf16: bool, tol: float = GNN_TOL) -> float:
    """The largest error of an output element over its bound: ``tol``
    (1e-5) of the element's sum of |msg| over its row (an f32 sum of a
    long row in another order is not bit-equal, so the check scales with
    the row), plus 2**-7 of its value, one bf16 step, where the output is
    rounded to bf16.  Where the bound is 0 the error must be 0
    too (inf else)."""
    diff = (got.double() - s).abs_()
    bound = tol * a
    if out_bf16:
        bound += 2.0 ** -7 * s.abs()
    if bool(((bound == 0) & (diff > 0)).any()):
        return math.inf
    return float((diff / bound.clamp_min(1e-300)).max())


def _spmm_bound_ms(E: int, n: int, D: int, in_size: int,
                   out_size: int) -> tuple[float, str]:
    """Messages read once, the plan's perm and row pointers read once,
    the output written once; one f32 add per message element."""
    nbytes = E * D * in_size + 4 * E + 4 * (n + 1) + n * D * out_size
    return _bound(nbytes, E * D, "float32")


def _csr_mm_ms(msgs, got, plan) -> dict:
    """The library yardstick of a bf16 "sum": one ``torch.sparse.mm`` of
    the (n, E) destination incidence matrix in CSR (the plan's row
    pointers, its perm as the columns, values 1) by the messages, which
    cuSPARSE sums in f32 and rounds to bf16 as the kernel does; its
    largest difference from the kernel's ``got`` printed beside it.  None,
    with the error, where the card's build refuses it."""
    import torch
    ones = torch.ones(plan.n_edges, dtype=msgs.dtype, device=msgs.device)
    inc = torch.sparse_csr_tensor(plan.rowptr, plan.perm, ones,
                                  (plan.n, plan.n_edges))
    row = dict(library="torch.sparse.mm (CSR)")
    try:
        lib = torch.sparse.mm(inc, msgs)
        row["library_max_abs_err"] = float((lib.float() - got.float())
                                           .abs().max())
        row["library_ms"] = cuda_ms(lambda: torch.sparse.mm(inc, msgs),
                                    iters=5)
    except RuntimeError as e:
        row.update(library_ms=None, library_error=str(e)[:300])
    return row


def _gat_bounds(E: int, n: int, H: int, dout: int, in_size: int,
                acc_size: int) -> dict:
    """Two byte bounds of one GAT aggregation (``gat_aggregate``).  Each
    input once: hw, s_src, s_dst, the plan's sorted sources, live bytes
    and row pointers read once, the output written once.  Gather once:
    what the kernel's three passes must read at the least, each edge's
    source id, live byte and s_src row in every pass and its hw row in
    the last, plus the kernel's row spans, s_dst and the output.
    Operations: per edge and head the score's add and product, the
    shift, the exp, the denominator's add and the division; per value a
    product and an add; at the f32 rate."""
    flops = E * H * (6 + 2 * dout)
    once = ((n * H * dout + 2 * n * H) * in_size + 5 * E + 4 * (n + 1)
            + n * H * dout * acc_size)
    gather = (E * (3 * (4 + 1 + H * in_size) + H * dout * in_size)
              + n * (H * in_size + 16) + n * H * dout * acc_size)
    (once_ms, by), (gather_ms, _) = (_bound(once, flops, "float32"),
                                     _bound(gather, flops, "float32"))
    return dict(bound_ms=once_ms, bound_by=by, gather_once_bound_ms=gather_ms)


def _gat_graph(rng, N: int, E: int, hub: int):
    """A seeded GAT test graph of N nodes and E uniform edge slots, 10%
    masked, plus ``hub`` slots into node 5 (above the plan's threshold);
    node 7 has no in-edge, every in-edge slot of node 9 is masked."""
    src = rng.integers(0, N, E + hub).astype(np.int32)
    dst = np.concatenate([rng.integers(0, N, E), np.full(hub, 5)]).astype(
        np.int32)
    dst[dst == 7] = 8
    mask = rng.random(E + hub) >= 0.1
    mask[dst == 9] = False
    return src, dst, mask


def _gat_case(name, src, dst, mask, n, H, dout, dt, acc, gen, timed=False,
              zero_rows=()):
    """``gat_aggregate`` against ``gat_aggregate_plain`` on the card, on
    seeded random hw, s_src, s_dst: two launches bit-identical; each
    element within 1e-5 (dt and acc both f32) or ``GAT_BF16_TOL`` (bf16
    anywhere) of its row's sum of |msg| (``_sum_ratio`` against float64
    sums of the plain version's messages; the plain version's own ratio
    printed beside the kernel's); the ``zero_rows`` (empty or
    all-masked) 0.  Timed: beside both bounds and the plain version."""
    import torch
    from repro_torch.kernels.segment_spmm import ops
    dev = torch.device(DEVICE)
    plan = ops.segment_plan(dst, n, src=src, mask=mask)
    hw = torch.randn((n, H, dout), generator=gen, device=dev).to(dt)
    s_src = torch.randn((n, H), generator=gen, device=dev).to(dt)
    s_dst = torch.randn((n, H), generator=gen, device=dev).to(dt)
    args = (hw, s_src, s_dst, plan, mask, acc)
    got = ops.gat_aggregate(*args)
    again = ops.gat_aggregate(*args)
    want = ops.gat_aggregate_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"gat_aggregate {name}: two runs differ")
    E = dst.shape[0]
    row = dict(kernel="segment_spmm", variant="gat", shape=name, E=E, n=n,
               H=H, dout=dout, dtype=str(dt).split(".")[-1],
               acc_dtype=str(acc).split(".")[-1], hub_degree=ops.HUB_DEGREE,
               hub_rows=plan.n_heavy,
               max_in_degree=int((plan.rowptr[1:] - plan.rowptr[:-1]).max()),
               max_abs_err=float((got.float() - want.float()).abs().max()))
    msg = ops.gat_messages_plain(*args).reshape(E, H * dout)
    s, a = _f64_sums(msg, dst, n)
    del msg
    tol = GNN_TOL if dt == acc == torch.float32 else GAT_BF16_TOL
    out_bf16 = acc == torch.bfloat16
    row.update(row_ratio=_sum_ratio(got.reshape(n, -1), s, a, out_bf16, tol),
               plain_row_ratio=_sum_ratio(want.reshape(n, -1), s, a,
                                          out_bf16, tol),
               tol=tol, check="row sum of |msg|, float64")
    del s, a
    ok = row["row_ratio"] <= 1
    check(ok and got.dtype == acc and bool(torch.isfinite(got).all()),
          f"gat_aggregate {name} disagrees with its plain version: {row}")
    for v in zero_rows:
        check(not bool(got[v].any()),
              f"gat_aggregate {name}: row {v} (no live edge) is not 0")
    if timed:
        row["kernel_ms"] = cuda_ms(lambda: ops.gat_aggregate(*args), iters=10)
        row["plain_ms"] = cuda_ms(lambda: ops.gat_aggregate_plain(*args),
                                  iters=2)
        row["library_ms"] = None
        row.update(_gat_bounds(E, n, H, dout, hw.element_size(),
                               got.element_size()))
    del hw, s_src, s_dst, got, again, want, plan, args
    torch.cuda.empty_cache()
    return row


def phase_gnn_kernels(src_products, dst_products, n_products: int):
    """segment_spmm's "sum" and "gat" variants against their plain
    versions on the card.  The sweep shapes and edge cases, f32 and bf16
    messages summed into f32, are held elementwise at rtol = atol = 1e-5.
    At the model shapes — GAT's
    three widths on the products graph, GraphCast's minibatch capacity
    and its Cora-sized graph — a long row's f32 sum in another order is
    not bit-equal, so each element is held to 1e-5 of its row's sum of
    |msg| against a float64 sum (``_sum_ratio``), the kernel's and the
    plain version's ratios printed.  GAT's old D = 64, the minibatch and
    the bf16 Cora-sized row that GraphCast's forward runs (the kernels
    line's "sum") are timed beside the bound, the plain version and two
    library calls: ``index_add_`` in f32 or ``torch.sparse.mm`` in bf16
    (``_csr_mm_ms``), and ``segment_reduce`` over messages already sorted
    by destination.  The "gat" rows are held and timed by ``_gat_case``.
    Returns the timed rows."""
    import torch
    from repro_torch.kernels.segment_spmm import ops
    dev = torch.device(DEVICE)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    t_phase = time.perf_counter()

    cases = []
    for E, N, D in [(300, 50, 8), (1000, 128, 32), (64, 7, 4)]:
        rng = np.random.default_rng(E + N)              # the test sweep
        msgs = rng.normal(size=(E, D)).astype(np.float32)
        dst = rng.integers(0, N, E).astype(np.int32)
        cases.append((f"sweep_{E}x{N}x{D}", torch.as_tensor(msgs, device=dev),
                      torch.as_tensor(dst, device=dev), N))

    def rand_case(name, E, n, D, dst=None, keep=1.0):
        msgs = torch.randn((E, D), generator=gen, device=dev)
        if keep < 1.0:
            msgs *= (torch.rand((E, 1), generator=gen, device=dev) < keep)
        if dst is None:
            dst = torch.randint(0, n, (E,), generator=gen, device=dev,
                                dtype=torch.int32)
        cases.append((name, msgs, dst, n))

    rand_case("d1", 2000, 300, 1)
    rand_case("d75", 5000, 400, 75)
    rand_case("no_edges", 0, 5, 8)
    rand_case("empty_rows", 1000, 600, 16,
              dst=2 * torch.randint(0, 300, (1000,), generator=gen,
                                    device=dev, dtype=torch.int32))
    rand_case("one_node", 1000, 10, 16,
              dst=torch.full((1000,), 3, device=dev, dtype=torch.int32))
    rand_case("masked", 3000, 500, 8, keep=0.7)
    rand_case("hub", 5000, 400, 64,                 # node 0 above the
              dst=torch.randint(0, 400, (5000,), generator=gen, device=dev,
                                dtype=torch.int32) * (torch.rand(
                  (5000,), generator=gen, device=dev) > 0.2))   # threshold
    # each case elementwise at 1e-5 against the plain version's sums in
    # float64: the plain version itself adds in float32 with index_add_'s
    # atomics, in an order that changes from run to run, and on the hub's
    # row of about a thousand edges its own error can pass 1e-5 (printed
    # beside the kernel's), so it cannot be the yardstick there
    worst, worst_plain = {}, {}
    for dtype in ("float32", "bfloat16"):
        for name, msgs, dst, n in cases:
            m = msgs.to(dts[dtype])
            plan = ops.segment_plan(dst, n)
            got = ops.segment_spmm(m, dst, n, plan)
            again = ops.segment_spmm(m, dst, n, plan)
            want = ops.segment_spmm_plain(m, dst, n)
            s, _ = _f64_sums(m, dst, n)
            torch.cuda.synchronize()
            elem = _elem_ratio(got, s, GNN_TOL)
            check(elem <= 1 and got.dtype == torch.float32,
                  f"segment_spmm {name} {dtype} disagrees: max abs err "
                  f"{float((got.double() - s).abs().max())}, elementwise "
                  f"ratio {elem}")
            check(torch.equal(got, again),
                  f"segment_spmm {name} {dtype}: two runs differ")
            worst[f"{name}/{dtype}"] = elem
            worst_plain[f"{name}/{dtype}"] = _elem_ratio(want, s, GNN_TOL)
    emit(phase="gnn_kernels", kernel="segment_spmm", variant="sum",
         elementwise_cases=[c[0] for c in cases], tol=GNN_TOL,
         check="elementwise, float64 sums", hub_degree=ops.HUB_DEGREE,
         worst_elem_ratio=max(worst.values()),
         hub_elem_ratio=worst["hub/float32"],
         plain_hub_elem_ratio=worst_plain["hub/float32"],
         plain_worst_elem_ratio=max(worst_plain.values()))
    del cases

    mb_dst, mb_n = minibatch_dst()
    cora = cora_graph()
    n_cora = cora["node_feats"].shape[0]
    model = [
        # (name, dst, n, D, messages' dtype, out dtype, timed)
        ("gat_products_d8", dst_products, n_products, 8, "float32",
         "float32", False),
        ("gat_products_d56", dst_products, n_products, 56, "float32",
         "float32", False),
        ("gat_products_d64", dst_products, n_products, 64, "float32",
         "float32", True),
        ("gat_products_d64_bf16", dst_products, n_products, 64, "bfloat16",
         "bfloat16", True),
        ("graphcast_minibatch_d512", torch.as_tensor(mb_dst, device=dev),
         mb_n, 512, "bfloat16", "bfloat16", True),
        ("graphcast_cora_d512", torch.as_tensor(cora["edge_dst"],
                                                device=dev),
         n_cora, 512, "float32", "float32", False),
        # what GraphCast's forward in phase 11 runs: its launches and this
        # row's times stand for "sum" in the kernels line
        ("graphcast_cora_d512_bf16", torch.as_tensor(cora["edge_dst"],
                                                     device=dev),
         n_cora, 512, "bfloat16", "bfloat16", True)]
    rows = {}
    for name, dst, n, D, in_dt, out_dt, timed in model:
        E = dst.shape[0]
        plan = ops.segment_plan(dst, n)
        if name.startswith("gat_products_d8"):
            msgs = torch.rand((E, D), generator=gen, device=dev)   # exp(.)
        else:
            msgs = torch.randn((E, D), generator=gen, device=dev)
        msgs = msgs.to(dts[in_dt])
        odt = dts[out_dt]
        got = ops.segment_spmm(msgs, dst, n, plan, out_dtype=odt)
        again = ops.segment_spmm(msgs, dst, n, plan, out_dtype=odt)
        want = ops.segment_spmm_plain(msgs, dst, n, out_dtype=odt)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment_spmm {name}: two runs "
                                       f"differ")
        s, a = _f64_sums(msgs, dst, n)
        ratio = _sum_ratio(got, s, a, out_dt == "bfloat16")
        plain_ratio = _sum_ratio(want, s, a, out_dt == "bfloat16")
        err = float((got.double() - s).abs().max())
        del want, again, s, a
        check(ratio <= 1, f"segment_spmm {name}: error over its row bound "
                          f"{ratio}")
        deg = plan.rowptr[1:] - plan.rowptr[:-1]
        row = dict(kernel="segment_spmm", shape=name, E=E, n=n, D=D,
                   dtype=in_dt, out_dtype=out_dt,
                   max_in_degree=int(deg.max()), max_abs_err=err,
                   row_ratio=ratio, plain_row_ratio=plain_ratio, tol=GNN_TOL,
                   check="row sum of |msg|, float64")
        if timed:
            row["kernel_ms"] = cuda_ms(lambda: ops.segment_spmm(
                msgs, dst, n, plan, out_dtype=odt), iters=10)
            row["plain_ms"] = cuda_ms(lambda: ops.segment_spmm_plain(
                msgs, dst, n, out_dtype=odt), iters=5)
            if in_dt == "float32":
                row["library"] = "index_add_"
                row["library_ms"] = cuda_ms(lambda: torch.zeros(
                    (n, D), dtype=torch.float32, device=dev).index_add_(
                    0, dst, msgs), iters=5)
            else:
                row.update(_csr_mm_ms(msgs, got, plan))
            ordered = msgs.index_select(0, plan.perm)
            lengths = deg.long()
            row["segment_reduce_ms"] = cuda_ms(lambda: torch.segment_reduce(
                ordered, "sum", lengths=lengths, axis=0, unsafe=True),
                iters=5)
            del ordered, lengths
            row["bound_ms"], row["bound_by"] = _spmm_bound_ms(
                E, n, D, msgs.element_size(), got.element_size())
            rows[name] = row
        emit(phase="gnn_kernels", **row)
        del msgs, got, plan, deg
        torch.cuda.empty_cache()
    # the products graph's longest row alone at D = 64 f32: with the hub
    # split (a block of its own), and without it (the threshold at the
    # row's length: one group of lanes), the time no other row can hide
    longest = int(torch.bincount(dst_products).max())
    dst1 = torch.zeros(longest, dtype=torch.int32, device=dev)
    msgs = torch.randn((longest, 64), generator=gen, device=dev)
    split = ops.segment_plan(dst1, 1)
    whole = dataclasses.replace(split, n_heavy=0)
    emit(phase="gnn_kernels", shape="longest_row_d64", E=longest, D=64,
         hub_degree=ops.HUB_DEGREE,
         kernel_ms=cuda_ms(lambda: ops.segment_spmm(msgs, dst1, 1, split)),
         unsplit_ms=cuda_ms(lambda: ops.segment_spmm(msgs, dst1, 1, whole)))
    del msgs, dst1, split, whole

    # the "gat" variant: a small graph with a hub, masked slots, an empty
    # and an all-masked row, at GAT's reduced and full head shapes in
    # every dtype pair; then the products graph's two layers (bf16 model,
    # f32 sums as gat_forward runs them, layer 1 also with bf16 messages
    # and in f32) and the Cora-sized graph's, timed
    rng = np.random.default_rng(7)
    small = [torch.as_tensor(x, device=dev)
             for x in _gat_graph(rng, 300, 6000, hub=600)]
    worst = {}
    for H, dout in ((2, 4), (8, 8), (8, 7)):
        for dt in (torch.float32, torch.bfloat16):
            for acc in (torch.float32, torch.bfloat16):
                r = _gat_case(f"small_{H}x{dout}", *small, 300, H, dout, dt,
                              acc, gen, zero_rows=(7, 9))
                worst[f"{H}x{dout}/{r['dtype']}/{r['acc_dtype']}"] = r[
                    "row_ratio"]
    emit(phase="gnn_kernels", kernel="segment_spmm", variant="gat",
         shape="small (300 nodes, 6,600 slots, a 600-slot hub)",
         hub_degree=ops.HUB_DEGREE, worst=worst)
    del small
    f32, b16 = torch.float32, torch.bfloat16
    mask_p = torch.ones_like(dst_products, dtype=torch.bool)
    cora_t = [torch.as_tensor(cora[k], device=dev)
              for k in ("edge_src", "edge_dst", "edge_mask")]
    for name, graph, n, H, dout, dt, acc in [
            ("gat_products_l1", (src_products, dst_products, mask_p),
             n_products, 8, 8, b16, f32),
            ("gat_products_l2", (src_products, dst_products, mask_p),
             n_products, 8, 7, b16, f32),
            ("gat_products_l1_bf16_msgs", (src_products, dst_products,
                                           mask_p), n_products, 8, 8, b16,
             b16),
            ("gat_products_l1_f32", (src_products, dst_products, mask_p),
             n_products, 8, 8, f32, f32),
            ("gat_cora_l1", cora_t, n_cora, 8, 8, b16, f32),
            ("gat_cora_l1_f32", cora_t, n_cora, 8, 8, f32, f32),
            ("gat_cora_l2_f32", cora_t, n_cora, 8, 7, f32, f32)]:
        row = _gat_case(name, *graph, n, H, dout, dt, acc, gen, timed=True)
        emit(phase="gnn_kernels", **row)
        rows[name] = row
    # the hub split at the products graph's layer-1 shape: the kernel's
    # time at other thresholds and with no split (the plan's rows are in
    # degree order, so a threshold only sets how many lead as hubs)
    hw = torch.randn((n_products, 8, 8), generator=gen, device=dev).to(b16)
    s_src = torch.randn((n_products, 8), generator=gen, device=dev).to(b16)
    s_dst = torch.randn((n_products, 8), generator=gen, device=dev).to(b16)
    sweep = {}
    base = ops.segment_plan(dst_products, n_products, src=src_products,
                            mask=mask_p)
    deg = base.rowptr[1:] - base.rowptr[:-1]
    for t in (64, ops.HUB_DEGREE, 512, dst_products.shape[0]):
        plan = dataclasses.replace(base, n_heavy=int((deg > t).sum()))
        sweep[t] = dict(hub_rows=plan.n_heavy, kernel_ms=cuda_ms(
            lambda: ops.gat_aggregate(hw, s_src, s_dst, plan, mask_p, f32)))
        del plan
    del base, deg
    emit(phase="gnn_kernels", shape="hub_sweep", variant="gat",
         of="gat_products_l1", by_hub_degree=sweep,
         wall_s=time.perf_counter() - t_phase)
    del hw, s_src, s_dst, mask_p
    torch.cuda.empty_cache()
    return rows


def _gnn_launches(cfg) -> dict:
    """segment_spmm launches of one forward, by variant: GAT one "gat" a
    layer and no "sum"; GraphCast and SchNet one "sum" a layer; PNA sums
    the degree once, then per layer two ``_seg_mean``s (mean and std) of
    two sums each."""
    if cfg.kind == "gat":
        return {"sum": 0, "gat": cfg.n_layers}
    return {"sum": {"graphcast": cfg.n_layers, "schnet": cfg.n_layers,
                    "pna": 1 + 4 * cfg.n_layers}[cfg.kind], "gat": 0}


def _zero_gnn_launches() -> None:
    from repro_torch.kernels.segment_spmm import ops
    ops.launches = 0
    ops.launches_by_variant = dict.fromkeys(ops.VARIANTS, 0)


def phase_gnn_parity():
    """The four GNNs at their full config widths in float32 on the
    Cora-sized graph: the kernel path against the plain path (the same
    weights, ``_plain_kernels``), each held to a relative 1e-4 (max |diff|
    over max |plain|), the kernel path's launches by variant counted."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import graph_batch_from_arrays
    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.models import gnn_forward, init_gnn
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    arrays = cora_graph()
    gb = graph_batch_from_arrays(arrays, device=dev)
    res = {}
    for arch in GNN_ARCHS:
        cfg = dataclasses.replace(get_config(arch).model, dtype="float32")
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        params = init_gnn(gen, cfg, arrays["node_feats"].shape[1],
                          cfg.n_classes, device=dev)
        out = {}
        for plain in (False, True):
            with _plain_kernels(plain):
                _zero_gnn_launches()
                o = gnn_forward(params, cfg, gb)
                torch.cuda.synchronize()
                out[plain] = (o, dict(ops.launches_by_variant))
        (ok_, nk), (op, npl) = out[False], out[True]
        check(nk == _gnn_launches(cfg) and not any(npl.values()),
              f"gnn_parity {arch}: launches {nk} (plain {npl}), want "
              f"{_gnn_launches(cfg)}")
        check(bool(torch.isfinite(ok_).all()), f"gnn_parity {arch}: not "
                                               f"finite")
        rel = _rel(ok_, op)
        check(rel <= GNN_PARITY_TOL, f"gnn_parity {arch}: kernel vs plain "
                                     f"rel {rel}")
        res[arch] = dict(n_layers=cfg.n_layers, d_hidden=cfg.d_hidden,
                         out_shape=list(ok_.shape), rel_err=rel,
                         launches_per_forward=nk)
        del params, out, ok_, op
    emit(phase="gnn_parity", graph="cora-sized (2,708 nodes, 10,556 edges, "
         "1,433 features)", dtype="float32", tol=GNN_PARITY_TOL,
         models=res, wall_s=time.perf_counter() - t_phase)


def _gnn_forward_once(params, cfg, gb) -> dict:
    """One forward on the host clock to a synchronise, with the launch
    count set to 0 just before it and read just after, and the peak
    memory."""
    import torch
    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.models import gnn_forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_gnn_launches()
    t0 = time.perf_counter()
    out = gnn_forward(params, cfg, gb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(out=out, wall_ms=wall * 1e3,
                launches=dict(ops.launches_by_variant),
                peak=torch.cuda.max_memory_allocated())


def _launch_shape(fn) -> dict:
    """The longest CUDA kernel of one call of ``fn``, with its grid and
    block, from a ``torch.profiler`` trace (written under ``build/`` and
    deleted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"trace-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    kern = max((e for e in events if e.get("cat") == "kernel"),
               key=lambda e: e.get("dur", 0), default={"name": None})
    args = kern.get("args", {})
    return dict(kernel=kern["name"] and kern["name"][:80],
                grid=args.get("grid"), block=args.get("block"))


def phase_gnn_serve(products: dict):
    """GAT (``gat-cora``'s full config, bf16, seeded random weights) on the
    products-sized graph: three forwards that must be bit-identical and
    launch the "gat" variant once a layer and nothing else, one with
    ``gnn_bf16_msgs``, and a ``torch.profiler`` split of one more, which
    must hold no edge-sized ``index_select`` or ``scatter_reduce``; the
    edge gathers that GraphCast, SchNet and PNA still make, timed four
    ways; then GraphCast at full width (16 layers, d = 512, bf16) on the
    Cora-sized graph.  Returns the launches by variant of the first GAT
    forward ("gat") and of the first GraphCast forward ("sum")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.convert import graph_batch_from_arrays
    from repro_torch.distributed import ctx
    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.models import GraphBatch, gnn_forward, init_gnn
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    cfg = get_config("gat-cora").model
    dims = _gnn_dims("ogb_products")
    N, F_ = dims["n_nodes"], dims["d_feat"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    t0 = time.perf_counter()
    feats = torch.randn((N, F_), generator=gen, device=dev).to(torch.bfloat16)
    gb = GraphBatch(node_feats=feats, **{
        k: torch.as_tensor(v, device=dev) for k, v in products.items()})
    params = init_gnn(gen, cfg, F_, cfg.n_classes, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = gb.gat_plan()
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    deg = (plan.rowptr[1:] - plan.rowptr[:-1]).float()
    graph = dict(n_nodes=N, edge_slots=gb.edge_dst.shape[0],
                 live_edges=int(gb.edge_mask.sum()),
                 max_in_degree=int(deg.max()), mean_in_degree=float(
                     deg.mean()), nodes_without_in_edges=int((deg == 0).sum()),
                 hub_degree=ops.HUB_DEGREE, hub_rows=plan.n_heavy,
                 d_feat=F_, setup_s=setup_s, plan_ms=plan_ms)
    del deg
    runs = [_gnn_forward_once(params, cfg, gb) for _ in range(3)]
    want = _gnn_launches(cfg)
    for r in runs:
        check(r["launches"] == want, f"gnn_serve GAT launches "
                                     f"{r['launches']} != {want}")
        check(tuple(r["out"].shape) == (N, cfg.n_classes)
              and bool(torch.isfinite(r["out"]).all()),
              "gnn_serve GAT: output not finite or misshapen")
    check(all(torch.equal(runs[0]["out"], r["out"]) for r in runs[1:]),
          "gnn_serve GAT: three forwards are not bit-identical")
    check("dst64" not in gb._memo, "gnn_serve GAT built the int64 dst ids")
    ctx.set_flags(gnn_bf16_msgs=True)
    try:
        b16 = _gnn_forward_once(params, cfg, gb)
    finally:
        ctx.reset()
    check(b16["launches"] == want and bool(torch.isfinite(b16["out"]).all()),
          f"gnn_serve GAT bf16 messages: launches {b16['launches']} or not "
          f"finite")
    b16_rel = _rel(b16["out"], runs[0]["out"])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    E = gb.edge_src.shape[0]
    torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        gnn_forward(params, cfg, gb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = _kernel_times(prof, wall, top=10)
    edge_ops = sorted({e.name for e in prof.events()
                       if any(w in e.name for w in EDGE_OPS)
                       and any(E in shape for shape in e.input_shapes)})
    check(not edge_ops, f"gnn_serve GAT: edge-sized {edge_ops} in the "
                        f"profiled forward")
    split["edge_sized_gathers_or_scatters"] = edge_ops
    # the row gathers along the edges that GraphCast, SchNet and PNA still
    # make, at GAT's two row widths on the same tables and ids, four ways,
    # each beside its byte bound (the table and the ids read once, the
    # (E, ...) rows written once) and with the kernel it launched
    gathers = {}
    ids64 = gb.edge_src.long()
    for name, shape in (("N_8_bf16", (N, 8)), ("N_8_8_bf16", (N, 8, 8))):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        flat = x.reshape(N, -1)
        nbytes = x.numel() * x.element_size()
        wide = ids64.view(E, 1).expand(E, flat.shape[1])
        ways = {
            "index_select_int32": (lambda: x.index_select(0, gb.edge_src), 4),
            "index_select_int64": (lambda: x.index_select(0, ids64), 8),
            "embedding_int32": (lambda: torch.embedding(flat, gb.edge_src),
                                4),
            "gather_expanded_int64": (lambda: torch.gather(flat, 0, wide),
                                      8)}
        gathers[name] = {way: dict(
            ms=cuda_ms(fn, iters=5),
            bound_ms=(nbytes + id_size * E + E * nbytes // N)
            / HBM_BYTES_PER_S * 1e3, **_launch_shape(fn))
            for way, (fn, id_size) in ways.items()}
        del x, flat, wide
    del ids64
    for r in (*runs, b16):
        del r["out"]
    del gb, params, feats, prof
    torch.cuda.empty_cache()

    gcfg = get_config("graphcast").model
    arrays = cora_graph()
    n_cora, f_cora = arrays["node_feats"].shape
    cgb = graph_batch_from_arrays(arrays, device=dev)
    gen.manual_seed(6)
    gparams = init_gnn(gen, gcfg, f_cora, gcfg.n_classes, device=dev)
    gc = [_gnn_forward_once(gparams, gcfg, cgb) for _ in range(2)]
    for r in gc:
        check(r["launches"] == _gnn_launches(gcfg)
              and tuple(r["out"].shape) == (n_cora, gcfg.n_vars)
              and bool(torch.isfinite(r["out"]).all()),
              f"gnn_serve GraphCast: launches {r['launches']}, or output not "
              f"finite or misshapen")
    emit(phase="gnn_serve", arch="gat-cora", dtype=cfg.dtype,
         n_layers=cfg.n_layers, heads=cfg.n_heads, d_hidden=cfg.d_hidden,
         n_out=cfg.n_classes, graph=graph,
         forwards=[dict(wall_ms=r["wall_ms"],
                        nodes_per_s=N / (r["wall_ms"] / 1e3),
                        peak_bytes=r["peak"], launches=r["launches"])
                   for r in runs],
         bit_identical=True,
         bf16_msgs=dict(wall_ms=b16["wall_ms"], peak_bytes=b16["peak"],
                        launches=b16["launches"], rel_vs_f32_msgs=b16_rel),
         profile=split, gathers=gathers,
         graphcast=dict(arch="graphcast", dtype=gcfg.dtype,
                        n_layers=gcfg.n_layers, d_hidden=gcfg.d_hidden,
                        graph="cora-sized", forwards=[
                            dict(wall_ms=r["wall_ms"], peak_bytes=r["peak"],
                                 launches=r["launches"]) for r in gc]),
         wall_s=time.perf_counter() - t_phase)
    return {"gat": runs[0]["launches"]["gat"],
            "sum": gc[0]["launches"]["sum"]}


# --------------------------------------------------------------------------- #
# phases 12-14: LM training
# --------------------------------------------------------------------------- #
def _grad_ratio(got, want, tol: float) -> float:
    """``max |got - want|`` over ``tol`` times ``max |want|``: a gradient
    is held iff at most 1."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()
                 / (tol * w.abs().max()).clamp_min(1e-30))


def _flash_bwd_work(B, Sq, Skv, H, Hk, D, causal, dtype, Dv=None) -> dict:
    """(bytes, flops) of each backward kernel, as ``_flash_work`` counts
    the forward's: each input read once, each output written once; per
    kept (query, key) pair 4·D + 4·Dv flops in dkdv (S and dK over D, dP
    and dV over Dv) and 4·D + 2·Dv in dq (S over D, dP over Dv, dQ over
    D); delta reads O and dO (Dv defaults to D)."""
    Dv = D if Dv is None else Dv
    e = 2 if dtype == "bfloat16" else 4
    nq, nk = B * Sq * H * D, B * Skv * Hk * D
    nqv, nkv = B * Sq * H * Dv, B * Skv * Hk * Dv
    rows = B * H * Sq
    pairs = B * H * Sq * Skv / (2 if causal else 1)
    return {"delta": (e * 2 * nqv + 4 * rows, 2 * nqv),
            "dkdv": (e * (nq + nqv + 2 * nk + 2 * nkv) + 8 * rows,
                     (4 * D + 4 * Dv) * pairs),
            "dq": (e * (2 * nq + nqv + nk + nkv) + 8 * rows,
                   (4 * D + 2 * Dv) * pairs)}


def _held_grads(row, names, got, want, tol) -> None:
    """Each gradient within ``tol`` of its plain version's largest
    magnitude (``_grad_ratio``), recorded in ``row``; fails otherwise."""
    ratios = {n: _grad_ratio(g, w, tol) for n, g, w in zip(names, got, want)}
    row.setdefault("ratio", {}).update(ratios)
    row["max_abs_err"] = max(row.get("max_abs_err", 0.0), *(
        float((g.float() - w.float()).abs().max())
        for g, w in zip(got, want)))
    for n, r in ratios.items():
        check(r <= 1, f"{row['kernel']} {row['shape']} {row['dtype']} {n}: "
                      f"|kernel - plain| / max|plain| is {r * tol} > {tol}")


def _sdpa_ms(make, D, Dv, iters) -> dict:
    """The library yardstick of flash_attn: ``make()`` runs what must run
    first (the forward a backward is timed from) and returns the call to
    time.  At D == Dv PyTorch picks SDPA's backend; at D != Dv the first
    of flash, cuDNN and efficient that takes it (``library_backend``;
    ``library_refused`` says why the others refused; ``library_ms`` is
    None where all do), never the math one, which would hold the whole
    score matrix."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if D == Dv:
        return dict(library_ms=cuda_ms(make(), warmup=1, iters=iters))
    refused = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                ms = cuda_ms(make(), warmup=1, iters=iters)
        except RuntimeError as e:    # the yardstick only, never the port
            refused[backend.name] = str(e).strip().splitlines()[0][:200]
            continue
        return dict(library_ms=ms, library_backend=backend.name,
                    library_refused=refused)
    return dict(library_ms=None, library_refused=refused)


def _sdpa_bwd_ms(q, k, v, do, causal, iters, D, Dv) -> dict:
    """One SDPA backward (autograd through ``scaled_dot_product_attention``
    in its (B, H, S, D) layout, ``_sdpa_ms``), the library yardstick of
    the three backward kernels."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def make():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                           retain_graph=True)

    return _sdpa_ms(make, D, Dv, iters)


def _flash_bwd_case(phase, gen, name, B, Sq, Skv, H, Hk, D, dtype,
                    causal=True, q_offset=0, timed=False, iters=3, Dv=None):
    """flash_attn's backward kernels ("delta", "dkdv", "dq", through
    ``flash_attention_bwd_k``) against ``flash_attention_bwd_ref`` on the
    forward kernel's own output and ``lse`` (held against the plain
    forward's), q and k D wide, v, o and dO Dv wide (default D); each
    gradient held to ``TRAIN_TOL``, two calls bit-identical, dkdv and dq
    through the variant ``route_bwd`` must pick.  ``timed`` adds each
    kernel's ms beside its bound, the "simt" first version's (for a
    "wgmma" row), the plain backward's, the plain rowsum's and SDPA's
    backward (``_sdpa_bwd_ms``).  Emits the row under ``phase``."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as flash_kernel
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.flash_attn.ref import flash_attention_bwd_ref
    dev = torch.device(DEVICE)
    Dv = D if Dv is None else Dv
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = TRAIN_TOL[dtype]

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    want_variant = ("wgmma" if dtype == "bfloat16" and D % 16 == 0
                    and Dv % 16 == 0 else "simt")
    q, do = randn((B, Sq, H, D)), randn((B, Sq, H, Dv))
    k, v = randn((B, Skv, Hk, D)), randn((B, Skv, Hk, Dv))
    row = dict(kernel="flash_attn_bwd", shape=name, dtype=dtype, B=B,
               Sq=Sq, Skv=Skv, H=H, Hk=Hk, D=D, Dv=Dv, causal=causal,
               q_offset=q_offset, tol=tol)
    o, lse = flash.flash_attention_k(q, k, v, causal=causal,
                                     q_offset=q_offset, return_lse=True)
    _, lse_plain = flash.flash_attention_plain(q, k, v, causal, q_offset,
                                               return_lse=True)
    row["lse_max_abs_err"] = float((lse - lse_plain).abs().max())
    check(row["lse_max_abs_err"]
          <= 1e-4 * max(1.0, float(lse_plain.abs().max())),
          f"flash {name} {dtype}: the forward's lse is "
          f"{row['lse_max_abs_err']} from the plain forward's")
    before = dict(flash.bwd_launches)
    before_v = dict(flash.bwd_launches_by_variant)
    args = (q, k, v, o, lse, do, causal, q_offset)
    got = flash.flash_attention_bwd_k(*args)
    again = flash.flash_attention_bwd_k(*args)
    check(all(flash.bwd_launches[n] == before[n] + 2
              for n in flash.BWD_KERNELS),
          f"flash {name}: backward launches {before} -> "
          f"{flash.bwd_launches}")
    row["variant"] = want_variant
    check(flash.bwd_launches_by_variant[want_variant]
          == before_v[want_variant] + 4,
          f"flash {name} {dtype}: dkdv and dq did not run {want_variant}: "
          f"{before_v} -> {flash.bwd_launches_by_variant}")
    want = flash_attention_bwd_ref(*args)
    torch.cuda.synchronize()
    row["bit_stable"] = all(torch.equal(a, b) for a, b in zip(got, again))
    check(row["bit_stable"], f"flash {name} {dtype}: two backward calls "
                             f"differ")
    check([t.shape[-1] for t in got] == [D, D, Dv],
          f"flash {name}: gradient widths {[t.shape for t in got]}")
    _held_grads(row, ("dq", "dk", "dv"), got, want, tol)
    del got, again, want
    if timed:
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        outs = {"delta": (), "dkdv": (dk, dv), "dq": (dq,)}
        row["kernel_ms"] = {n: cuda_ms(
            lambda n=n: flash_kernel.flash_attn_bwd_cuda(
                n, q, k, v, o, lse, do, delta, outs[n], causal, q_offset,
                want_variant), warmup=1, iters=iters)
            for n in flash.BWD_KERNELS}
        if want_variant != "simt":   # the first version, same inputs
            row["simt_ms"] = {n: cuda_ms(
                lambda n=n: flash_kernel.flash_attn_bwd_cuda(
                    n, q, k, v, o, lse, do, delta, outs[n], causal,
                    q_offset, "simt"), warmup=1, iters=2)
                for n in ("dkdv", "dq")}
        delta_plain = (do.float() * o.float()).sum(-1).transpose(1, 2)
        row["delta_max_abs_err"] = float((delta - delta_plain).abs().max())
        check(row["delta_max_abs_err"]
              <= 1e-4 * float(delta_plain.abs().max()),
              f"flash {name} {dtype}: delta is {row['delta_max_abs_err']} "
              f"from the plain rowsum")
        row["plain_delta_ms"] = cuda_ms(
            lambda: (do.float() * o.float()).sum(-1).transpose(1, 2),
            warmup=1, iters=iters)
        row["bwd_ms"] = cuda_ms(lambda: flash.flash_attention_bwd_k(*args),
                                warmup=1, iters=iters)
        row["plain_ms"] = cuda_ms(lambda: flash_attention_bwd_ref(*args),
                                  warmup=1, iters=2)
        row["library_ms"] = None
        if H == Hk and q_offset == 0:
            row.update(_sdpa_bwd_ms(q, k, v, do, causal, iters, D, Dv))
        work = _flash_bwd_work(B, Sq, Skv, H, Hk, D, causal, dtype, Dv)
        row["bound_ms"], row["bound_by"] = {}, {}
        for n, (nbytes, flops) in work.items():
            row["bound_ms"][n], row["bound_by"][n] = _bound(nbytes, flops,
                                                            dtype)
        row["library_covers"] = "dq, dk, dv (one SDPA backward)"
        row["plain_covers"] = ("delta, dq, dk, dv; plain_delta_ms: delta "
                               "alone")
        del delta, dq, dk, dv, delta_plain
    emit(phase=phase, **row)
    del q, k, v, o, lse, do, lse_plain
    torch.cuda.empty_cache()
    return row


def phase_lm_train_kernels():
    """The training path's backward kernels against their plain versions
    on the card, in float32 and bfloat16: flash_attn's "delta", "dkdv"
    and "dq" (``_flash_bwd_case``) and moe_gemm's backward (the whole
    gradient through ``moe_gemm_bwd_k``, and the kernel's own da, db and
    h against ``moe_bwd_hidden_ref``).
    Shapes: the test sweep, edges (ragged tiles, GQA 8/2, q_offset 0 and
    past a tile) and the training shapes (B·H = 64, S = 4,096, D = 128,
    causal; E = 64, C = 2,560, d = 2,048, f = 1,024).  Each gradient is
    held to ``TRAIN_TOL`` of its plain version's largest magnitude, and
    each call is made twice and must give the same bits.  The training
    shapes are timed: each kernel beside its bound, the plain version and
    a library yardstick (autograd through ``scaled_dot_product_attention``;
    three ``bmm`` for moe_gemm_bwd's products, and the six ``bmm`` of the
    dense expert backward).  Returns the timed bfloat16 rows."""
    import torch
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ops as moe
    from repro_torch.kernels.moe_gemm.ref import (moe_bwd_hidden_ref,
                                                  moe_gemm_bwd_ref)
    dev = torch.device(DEVICE)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = {}

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def flash_case(*a, **k):
        return _flash_bwd_case("lm_train_kernels", gen, *a, **k)

    def moe_case(name, E, C, d, f, dtype, w_scale, timed=False, iters=3,
                 variant=None):
        dt, tol = dts[dtype], TRAIN_TOL[dtype]
        x, dy = randn((E, C, d), dt), randn((E, C, d), dt)
        wg, wu = randn((E, d, f), dt, w_scale), randn((E, d, f), dt, w_scale)
        wd = randn((E, f, d), dt, w_scale)
        row = dict(kernel="moe_gemm_bwd", shape=name, dtype=dtype, E=E, C=C,
                   d=d, f=f, tol=tol)
        before = moe.bwd_launches
        got = moe.moe_gemm_bwd_k(x, wg, wu, wd, dy)
        again = moe.moe_gemm_bwd_k(x, wg, wu, wd, dy)
        check(moe.bwd_launches == before + 2,
              f"moe {name}: backward launches {before} -> "
              f"{moe.bwd_launches}")
        want = moe_gemm_bwd_ref(x, wg, wu, wd, dy)
        torch.cuda.synchronize()
        row["bit_stable"] = all(torch.equal(a, b) for a, b in zip(got, again))
        check(row["bit_stable"], f"moe {name} {dtype}: two backward calls "
                                 f"differ")
        _held_grads(row, ("dx", "dwg", "dwu", "dwd"), got, want, tol)
        del got, again, want
        # the kernel's own outputs against the plain version of its function
        hid = [torch.empty((E, C, f), dtype=dt, device=dev) for _ in range(3)]
        row["variant"] = moe.route_bwd(dt, d, f, [
            t.data_ptr() for t in (x, wg, wu, wd, dy, *hid)])
        check(variant is None or row["variant"] == variant,
              f"moe {name} {dtype} routes to {row['variant']}, not "
              f"{variant}")
        moe_kernel.moe_gemm_bwd_cuda(x, wg, wu, wd, dy, *hid, row["variant"])
        _held_grads(row, ("da", "db", "h"), hid,
                    moe_bwd_hidden_ref(x, wg, wu, wd, dy), tol)
        if timed:
            row["kernel_ms"] = cuda_ms(lambda: moe_kernel.moe_gemm_bwd_cuda(
                x, wg, wu, wd, dy, *hid, row["variant"]), warmup=1,
                iters=iters)
            if row["variant"] != "simt":   # the first version, same inputs
                row["simt_ms"] = cuda_ms(
                    lambda: moe_kernel.moe_gemm_bwd_cuda(
                        x, wg, wu, wd, dy, *hid, "simt"), warmup=1, iters=2)
            row["bwd_ms"] = cuda_ms(lambda: moe.moe_gemm_bwd_k(
                x, wg, wu, wd, dy), warmup=1, iters=iters)
            row["plain_ms"] = cuda_ms(lambda: moe_bwd_hidden_ref(
                x, wg, wu, wd, dy), warmup=1, iters=2)
            row["library_ms"] = cuda_ms(lambda: (
                torch.bmm(x, wg), torch.bmm(x, wu),
                torch.bmm(dy, wd.transpose(1, 2))), warmup=1, iters=iters)
            da, db, h = hid
            row["dense_bwd_bmm6_ms"] = cuda_ms(lambda: (
                torch.bmm(dy, wd.transpose(1, 2)),
                torch.bmm(h.transpose(1, 2), dy),
                torch.bmm(da, wg.transpose(1, 2)),
                torch.bmm(db, wu.transpose(1, 2)),
                torch.bmm(x.transpose(1, 2), da),
                torch.bmm(x.transpose(1, 2), db)), warmup=1, iters=iters)
            e = 2 if dtype == "bfloat16" else 4
            row["bound_ms"], row["bound_by"] = _bound(
                e * (2 * E * C * d + 3 * E * d * f + 3 * E * C * f),
                6 * E * C * d * f, dtype)
            row["library_covers"] = "x wg, x wu, dy wd^T (three bmm)"
        emit(phase="lm_train_kernels", **row)
        del x, dy, wg, wu, wd, hid
        torch.cuda.empty_cache()
        return row

    for dtype in ("float32", "bfloat16"):
        for S, H, Hk, D in [(64, 4, 2, 32), (128, 2, 2, 16)]:   # the sweep
            flash_case(f"sweep_{S}x{H}x{Hk}x{D}", 2, S, S, H, Hk, D, dtype)
        flash_case("ragged_100x150_non_causal", 1, 100, 150, 4, 1, 64, dtype,
                   causal=False)
        flash_case("ragged_333_gqa_8_2", 1, 333, 333, 8, 2, 128, dtype)
        flash_case("q_offset_200", 1, 300, 500, 4, 4, 128, dtype,
                   q_offset=200)
        flash_case("d40_gqa_6_3", 2, 100, 100, 6, 3, 40, dtype)
        flash_case("ragged_255x257_gqa_32_8_d80", 1, 255, 257, 32, 8, 80,
                   dtype, q_offset=2)
        for E, C, d, f in [(4, 64, 32, 64), (2, 128, 16, 128)]:  # the sweep
            moe_case(f"sweep_{E}x{C}x{d}x{f}", E, C, d, f, dtype, 0.1)
        moe_case("ragged_5x37x48x40", 5, 37, 48, 40, dtype, 0.1,
                 variant="wgmma" if dtype == "bfloat16" else "simt")
        moe_case("unaligned_3x37x36x20", 3, 37, 36, 20, dtype, 0.1,
                 variant="simt")
        moe_case("ragged_2x257x200x136", 2, 257, 200, 136, dtype, 0.1,
                 variant="wgmma" if dtype == "bfloat16" else "simt")
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH).model
    H, D, mo = cfg.n_heads, cfg.head_dim, cfg.moe
    E, d, f = mo.n_experts, cfg.d_model, mo.d_expert
    C = max(int(TRAIN_BATCH * TRAIN_SEQ * mo.top_k / E * mo.capacity_factor),
            1)
    for dtype in ("float32", "bfloat16"):
        rows["flash_attn_bwd", dtype] = flash_case(
            "train_4k", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, H, D, dtype,
            timed=True)
        rows["moe_gemm_bwd", dtype] = moe_case(
            "train_4k", E, C, d, f, dtype, E ** -0.5, timed=True,
            variant="wgmma" if dtype == "bfloat16" else "simt")
    return rows


def _train_launches() -> dict:
    """Launches of the LM kernels, forward by variant and backward by
    kernel."""
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.moe_gemm import ops as moe
    return {"flash_attn": {k: n for k, n in flash.launches_by_variant.items()
                           if n},
            "flash_attn_bwd": {k: n for k, n in flash.bwd_launches.items()
                               if n},
            "flash_attn_bwd_by_variant": {
                k: n for k, n in flash.bwd_launches_by_variant.items() if n},
            "moe_gemm": {k: n for k, n in moe.launches_by_variant.items()
                         if n},
            "moe_gemm_bwd": {k: n for k, n in
                             moe.bwd_launches_by_variant.items() if n}}


def _zero_train_launches() -> None:
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.moe_gemm import ops as moe
    _zero_lm_launches()
    flash.bwd_launches = dict.fromkeys(flash.BWD_KERNELS, 0)
    flash.bwd_launches_by_variant = dict.fromkeys(flash.BWD_VARIANTS, 0)
    moe.bwd_launches = 0
    moe.bwd_launches_by_variant = dict.fromkeys(moe.BWD_VARIANTS, 0)


def _train_want(steps: int, n_layers: int, variant: str,
                n_moe: int | None = None, mtp: bool = False) -> dict:
    """What ``_train_launches`` must read after ``steps`` training steps
    with per-block recompute: each block's forward kernels twice a step,
    each backward kernel once; ``n_moe`` of the blocks (default all) run
    moe_gemm; an MTP head's block (``mtp``) runs without recompute, its
    forward once."""
    n_moe = n_layers if n_moe is None else n_moe
    blocks = n_layers + int(mtp)
    bwd = "wgmma" if variant == "wgmma" else "simt"
    want = {"flash_attn": {variant: (2 * n_layers + int(mtp)) * steps},
            "flash_attn_bwd": {k: blocks * steps
                               for k in ("delta", "dkdv", "dq")},
            "flash_attn_bwd_by_variant": {bwd: 2 * blocks * steps},
            "moe_gemm": {}, "moe_gemm_bwd": {}}
    if n_moe:
        want["moe_gemm"] = {variant: 2 * n_moe * steps}
        want["moe_gemm_bwd"] = {bwd: n_moe * steps}
    return want


@contextlib.contextmanager
def _train_router(choices: list, pin: bool):
    """``_router`` for a training step: while active every ``moe_block``
    records its router's experts into ``choices`` or, with ``pin``, takes
    the next recorded ones, and its gates are then its own probabilities
    of those experts (renormalised, as ``moe_route`` does), so the
    router's gradient stays on the path that runs.  The calls come in the
    same order on both paths: each block's forward, then the recompute
    of each block in reverse during the backward."""
    import torch
    from repro_torch.models import layers
    orig = layers.moe_route
    pinned = iter(list(choices)) if pin else None

    def route(p, cfg, xt):
        sel, gates, probs_mean = orig(p, cfg, xt)
        if pinned is None:
            choices.append(sel.detach())
            return sel, gates, probs_mean
        sel = next(pinned)
        probs = torch.softmax(xt.float() @ p["router"], dim=-1)
        gsel = torch.gather(probs, -1, sel)
        return sel, gsel / (gsel.sum(-1, keepdim=True) + 1e-9), probs_mean

    layers.moe_route = route
    try:
        yield
    finally:
        layers.moe_route = orig


def phase_lm_train_parity():
    """OLMoE-1B-7B at full width and PARITY_LAYERS layers, one training
    step's loss and every parameter's gradient: the kernel path against
    the plain path (``_plain_kernels``, forward and backward), same
    weights and batch, through ``lm_loss`` with per-block recompute.  In
    float32 (the simt variants and the backward kernels) each is held to
    a relative 1e-3 (a gradient: max |diff| over max |plain| of its
    tensor); in bfloat16 (the wgmma variants) to 5e-2, with the kernel
    path's experts pinned to the plain path's (``_train_router``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm_params, lm_loss
    from repro_torch.runtime import deterministic
    dev = torch.device(DEVICE)
    L = PARITY_LAYERS
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        cfg = dataclasses.replace(get_config(LM_ARCH).model, dtype=dtype,
                                  n_layers=L)
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)
        model = init_lm_params(gen, cfg, device=dev).requires_grad_(True)
        tokens, labels = (torch.randint(0, cfg.vocab, (PARITY_BATCH,
                                                       TRAIN_PARITY_SEQ),
                                        generator=gen, device=dev)
                          for _ in range(2))
        params = dict(model.named_parameters())
        chosen = [] if dtype == "bfloat16" else None

        def run(plain, pin=False):
            router = (_train_router(chosen, pin) if chosen is not None
                      else contextlib.nullcontext())
            with _plain_kernels(plain), router, deterministic():
                _zero_train_launches()
                loss = lm_loss(model, tokens, labels)
                grads = torch.autograd.grad(loss, list(params.values()))
                torch.cuda.synchronize()
                return loss.detach(), grads, _train_launches()

        lp, gp, launches_plain = run(True)
        lk, gk, launches = run(False, pin=True)
        variant = "simt" if dtype == "float32" else "wgmma"
        want = _train_want(1, L, variant)
        check(launches == want, f"lm_train_parity {dtype} kernel path "
                                f"launches {launches} != {want}")
        check(all(not n for n in launches_plain.values()),
              f"lm_train_parity {dtype} plain path launched kernels: "
              f"{launches_plain}")
        rel = {"loss": _rel(lk, lp)}
        rel.update({n: _rel(a, b) for n, a, b in zip(params, gk, gp)})
        worst = max(rel, key=rel.get)
        for key, val in rel.items():
            check(val <= tol, f"lm_train_parity {dtype} {key}: kernel vs "
                              f"plain rel {val} > {tol}")
        emit(phase="lm_train_parity", arch=LM_ARCH, n_layers=L, dtype=dtype,
             batch=PARITY_BATCH, seq=TRAIN_PARITY_SEQ, tol=tol,
             loss={"kernel": float(lk), "plain": float(lp)},
             rel_err_loss=rel["loss"], n_grads=len(gk),
             rel_err_grad_max={"param": worst, "rel": rel[worst]},
             rel_err=rel,
             router="free" if chosen is None else
             f"experts pinned to the plain path ({len(chosen)} router "
             f"calls)", kernel_launches=launches)
        del model, params, gp, gk
        torch.cuda.empty_cache()


_STEP_SPLIT = (  # (part, kernel-name substrings), matched in this order
    ("flash_attn_bwd", ("flash_bwd",)),
    ("flash_attn_fwd", ("flash_fwd",)),
    ("moe_gemm_bwd", ("moe_bwd_hidden",)),
    ("moe_gemm_fwd", ("moe_gemm_wgmma", "moe_gemm_stream", "tile_gemm")),
    ("gemm_library", ("gemm", "xmma", "nvjet", "cutlass")))


def _bwd_row(row: dict, kernel: str) -> dict:
    """The kernels line's fields for one flash_attn backward kernel, from
    phase 12's timed row: its own time and bound; beside "delta" the
    plain rowsum and no library call, beside "dkdv" and "dq" the whole
    plain backward and one SDPA backward (each computes all three
    gradients)."""
    delta = kernel == "delta"
    return dict(max_abs_err=(row["delta_max_abs_err"] if delta
                             else row["max_abs_err"]),
                kernel_ms=row["kernel_ms"][kernel],
                plain_ms=row["plain_delta_ms"] if delta else row["plain_ms"],
                bound_ms=row["bound_ms"][kernel],
                bound_by=row["bound_by"][kernel],
                library_ms=None if delta else row["library_ms"])


def _profile_train_step(tr, batch, top: int = 10,
                        parts: tuple = _STEP_SPLIT) -> dict:
    """One ``Trainer.train_step`` under ``torch.profiler``: the card's busy
    time (its kernels' device time; the trainer's ranges, which the
    profiler also puts on the device's timeline, are not kernels) and idle
    share, and the device time split by ``parts`` (by default flash_attn's
    and moe_gemm's forward and backward kernels and the library's matrix
    products: projections, head, the expert backward's ``bmm``), the
    optimizer (the kernels inside the trainer's "trainer.adamw" range) and
    the rest, whose top kernels are listed.  A first step runs under the
    profiler unrecorded (its warm-up): after the earlier phases' profiles,
    a profile's first kernels can go missing from its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        tr.train_step(batch)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "trainer.adamw"]
    split = {part: 0.0 for part, _ in parts}
    split.update(optimizer=0.0, other=0.0)
    other, busy = {}, 0.0
    for e in events:
        if e.name.startswith(("trainer.", "ProfilerStep")):   # ranges
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        if any(a <= e.time_range.start < b for a, b in ranges):
            part = "optimizer"
        else:
            part = next((p for p, keys in parts
                         if any(k in e.name for k in keys)), "other")
        split[part] += ms
        if part == "other":
            name = e.name[:240]   # a template's functor is far in
            other[name] = other.get(name, 0.0) + ms
    if not ranges:   # no device-side range: the CPU range's kernel time
        opt = sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
                  if e.name == "trainer.adamw"
                  and getattr(e, "device_type", None) != DeviceType.CUDA)
        split["optimizer"] = opt / 1e3
        split["other"] -= opt / 1e3
    top_other = sorted(other.items(), key=lambda kv: -kv[1])[:top]
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                device_ms=split, optimizer_found=bool(ranges),
                top_other=[dict(kernel=k, ms=v) for k, v in top_other])


def phase_lm_train():
    """The training cell: OLMoE-1B-7B at full width cut to TRAIN_LAYERS
    layers, bf16 weights with f32 AdamW moments, TRAIN_BATCH x TRAIN_SEQ
    tokens a step from ``lm_token_stream``.  Run 1: ``Trainer.run`` for
    TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY (the
    newest one kept) and a fault injected at step TRAIN_FAULT_AT
    (restore, replay).  Run 2: the same seed, uninterrupted and without
    checkpoints, with the launch counts set to 0 before it and read after
    it.  The losses of the steps after the restored checkpoint
    must be equal bit for bit, and the loss must fall.  Then one more step
    under ``torch.profiler``.  Returns run 2's launches, as read right
    after it."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import Prefetcher, lm_token_stream
    from repro_torch.models import init_lm_params, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_config(LM_ARCH).model,
                              n_layers=TRAIN_LAYERS)
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    t_phase = time.perf_counter()

    def loss_fn(m, b):
        return lm_loss(m, torch.as_tensor(b["tokens"], device=dev),
                       torch.as_tensor(b["labels"], device=dev))

    def run(tag, fault, ckpt_every):
        """``Trainer.run`` with checkpoints every ``ckpt_every`` steps, or,
        without (``ckpt_every`` None), the same steps through
        ``train_step`` alone: ``run`` would first write a step-0 anchor
        that an uninterrupted run never reads."""
        shutil.rmtree(ckpt_root, ignore_errors=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(14)
        model = init_lm_params(gen, cfg, device=dev)
        tr = Trainer(loss_fn, model,
                     AdamWConfig(lr=1e-3, warmup_steps=5,
                                 total_steps=TRAIN_STEPS),
                     TrainerConfig(ckpt_dir=os.path.join(ckpt_root, tag),
                                   ckpt_every=ckpt_every or 1 << 30,
                                   ckpt_keep=1, log_every=TRAIN_STEPS))
        # the host-blocking part of each save and each restore, and the
        # wait for the last save's thread
        io = {"save_s": [], "restore_s": []}
        for name in ("save", "restore"):
            def timed(*a, _f=getattr(tr, name), _k=f"{name}_s", **k):
                t0 = time.perf_counter()
                out = _f(*a, **k)
                io[_k].append(time.perf_counter() - t0)
                return out
            setattr(tr, name, timed)
        logs = []
        data = Prefetcher(lm_token_stream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                          seed=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_train_launches()
        t0 = time.perf_counter()
        if ckpt_every:
            hist = tr.run(data, TRAIN_STEPS, fault=fault, log=logs.append)
        else:
            hist = [tr.train_step(next(data)) for _ in range(TRAIN_STEPS)]
        t1 = time.perf_counter()
        tr.finish()
        io["finish_s"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        return dict(model=model, tr=tr, hist=hist, logs=logs, io=io,
                    wall_s=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated(),
                    launches=_train_launches())

    r1 = run("faulted", FaultInjector({TRAIN_FAULT_AT}), TRAIN_CKPT_EVERY)
    faults = [m for m in r1["logs"] if "fault at step" in m]
    check(len(faults) == 1 and f"injected fault at step {TRAIN_FAULT_AT}"
          in faults[0], f"lm_train run 1: expected one injected fault, got "
                        f"{faults}")
    losses1 = {h["step"]: h["loss"] for h in r1["hist"]}
    n_params = sum(p.numel() for p in r1["model"].parameters())
    del r1["model"], r1["tr"]
    gc.collect()   # the timing wrappers above make a cycle through tr
    torch.cuda.empty_cache()

    # the uninterrupted run writes no checkpoint: its losses do not depend
    # on checkpoints, and its step times then hold none
    r2 = run("uninterrupted", None, None)
    losses2 = {h["step"]: h["loss"] for h in r2["hist"]}
    check(sorted(losses2) == list(range(1, TRAIN_STEPS + 1)),
          f"lm_train run 2 steps {sorted(losses2)}")
    check(all(math.isfinite(v) for v in losses2.values()),
          "lm_train: a loss is not finite")
    restored = TRAIN_FAULT_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    replayed = list(range(restored + 1, TRAIN_STEPS + 1))
    check(all(losses1[s] == losses2[s] for s in replayed),
          f"lm_train: steps {replayed} after the restore differ: "
          f"{[(s, losses1[s], losses2[s]) for s in replayed]}")
    check(losses2[TRAIN_STEPS] < losses2[1],
          f"lm_train: the loss did not fall ({losses2[1]} -> "
          f"{losses2[TRAIN_STEPS]})")
    want = _train_want(TRAIN_STEPS, TRAIN_LAYERS, "wgmma")
    check(r2["launches"] == want,
          f"lm_train run 2 launches {r2['launches']} != {want}")
    check(r2["peak"] < 80e9, f"lm_train peak {r2['peak']} bytes")
    batch = next(iter(lm_token_stream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=2, n_steps=1)))
    profile_split = _profile_train_step(r2["tr"], batch)
    r2["tr"].finish()
    shutil.rmtree(ckpt_root, ignore_errors=True)
    secs = [h["secs"] for h in r2["hist"]]
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def pct(p):
        return float(np.percentile(np.asarray(secs) * 1e3, p))

    emit(phase="lm_train", arch=LM_ARCH, n_layers=TRAIN_LAYERS,
         dtype=cfg.dtype, n_params=n_params, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
         fault_at=TRAIN_FAULT_AT, restored_from=restored,
         losses_uninterrupted=[losses2[s] for s in sorted(losses2)],
         losses_faulted={s: losses1[s] for s in sorted(losses1)},
         replay_bit_equal=replayed,
         step_ms_p50=pct(50), step_ms_p90=pct(90),
         step_ms_first=secs[0] * 1e3,
         tokens_per_s=tokens / (pct(50) / 1e3),
         wall_s={"faulted": r1["wall_s"], "uninterrupted": r2["wall_s"]},
         checkpoint_io={"faulted": r1["io"], "uninterrupted": r2["io"]},
         peak_bytes={"faulted": r1["peak"], "uninterrupted": r2["peak"]},
         launches=r2["launches"], faulted_run_launches=r1["launches"],
         profile_step=profile_split,
         cuts={"n_layers": "16 -> 4 (all 16 hold 6.9 B parameters: 83 GB "
                           "of bf16 weights and gradients and f32 moments)",
               "train_4k": "global batch 256 -> 4 (16,384 tokens a step)"},
         phase_s=time.perf_counter() - t_phase)
    launches = r2["launches"]
    del r2
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phases 15-17: GNN training
# --------------------------------------------------------------------------- #
def _gnn_train_launches() -> dict:
    """segment_spmm's launches by variant, forward and backward."""
    from repro_torch.kernels.segment_spmm import ops
    return {**{k: n for k, n in ops.launches_by_variant.items()},
            **{k: n for k, n in ops.bwd_launches_by_variant.items()}}


def _zero_gnn_train_launches() -> None:
    from repro_torch.kernels.segment_spmm import ops
    _zero_gnn_launches()
    ops.bwd_launches_by_variant = dict.fromkeys(ops.BWD_VARIANTS, 0)


def _gnn_train_want(cfg, steps: int = 1) -> dict:
    """What ``_gnn_train_launches`` must read after ``steps`` training
    steps: the forward's launches, and one backward launch for each sum
    whose messages need a gradient (PNA: the mean's and the std's, not
    the mask counts or the degree)."""
    fwd = _gnn_launches(cfg)
    L = cfg.n_layers
    bwd = ({"sum_bwd": 0, "gat_bwd": L} if cfg.kind == "gat" else
           {"sum_bwd": {"graphcast": L, "schnet": L, "pna": 2 * L}[cfg.kind],
            "gat_bwd": 0})
    return {k: n * steps for k, n in {**fwd, **bwd}.items()}


def _sum_bwd_bound_ms(E: int, n: int, D: int, in_size: int,
                      out_size: int) -> tuple[float, str]:
    """dout read once, the plan's perm and row spans read once, each
    edge's row written once; one conversion a value."""
    nbytes = n * D * out_size + 4 * E + 16 * n + E * D * in_size
    return _bound(nbytes, E * D, "float32")


def _gat_bwd_bounds(E: int, n: int, H: int, dout: int, in_size: int,
                    acc_size: int) -> dict:
    """Two byte bounds of one ``gat_aggregate_bwd``.  Each input once: hw,
    s_src, s_dst, dout, the plan's sources and destinations (4 bytes
    each) and live bytes and its row pointers, read once, the three
    gradients written once.  Gather once: per edge the hw and s_src rows
    of its source and the dout row of its destination (rounded to hw's
    type first where the two differ: dout read once and written once at
    that width), each once, and its ids and live byte; per node s_dst, both plans' row
    spans and the gradients.  Operations: per edge and head the score's
    add and product, the shift, the exp, the weight's division and the
    gradient's few, and per value dalpha's and dhw's product and add; at
    the f32 rate."""
    flops = E * H * (12 + 4 * dout)
    grads = (n * H * dout + 2 * n * H) * in_size
    once = ((n * H * dout + 2 * n * H) * in_size + n * H * dout * acc_size
            + 9 * E + 4 * (n + 1) + grads)
    cast = n * H * dout * (acc_size + in_size) if acc_size != in_size else 0
    gather = (E * (2 * H * dout * in_size + H * in_size + 9)
              + n * (H * in_size + 32) + cast + grads)
    (once_ms, by), (gather_ms, _) = (_bound(once, flops, "float32"),
                                     _bound(gather, flops, "float32"))
    return dict(bound_ms=once_ms, bound_by=by, gather_once_bound_ms=gather_ms)


# The backward kernels' times at the same shapes before their redesign
# (the plan-order "sum_bwd" with the longer host path; "gat_bwd" in two
# kernels, by destination and by source, each destination row walked
# three times), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6):
# printed beside the new times, not measured here.
BWD_EARLIER_MS = {"sum_bwd_products_d64": 9.835,
                  "sum_bwd_graphcast_cora_d512_bf16": 0.0495,
                  "gat_bwd_products_l1": 28.84, "gat_bwd_products_l2": 32.95,
                  "gat_bwd_products_l1_f32": 44.66}


def _device_ms(fn, calls: int) -> float:
    """The card's time for one call of ``fn``, without the host's: a
    sleep kernel of about 20 ms first, ``calls`` calls enqueued behind it
    while it runs, CUDA events around them.  (``torch.profiler`` lost the
    ctypes-launched kernels after the script's earlier profiles.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _host_ms(fn, calls: int = 200) -> float:
    """The host's time for one call of ``fn``: ``calls`` calls enqueued
    back to back, without a synchronise between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took * 1e3 / calls


def _call_split(kernel, library, rounds: int, calls: int) -> dict:
    """A call's time split between host and device, for the kernel's
    wrapper and a library call of the same function, in turns (kernel,
    library, ...) ``rounds`` times, each a median: ``ms`` (CUDA events
    around 10 calls), ``host_ms`` (``_host_ms`` over ``calls``) and
    ``device_ms`` (``_device_ms`` over ``calls``)."""
    runs = {"kernel": [], "library": []}
    for _ in range(rounds):
        for side, fn in (("kernel", kernel), ("library", library)):
            runs[side].append((cuda_ms(fn, iters=10), _host_ms(fn, calls),
                               _device_ms(fn, calls)))
    return {side: dict(ms=float(np.median([r[0] for r in rs])),
                       host_ms=float(np.median([r[1] for r in rs])),
                       device_ms=float(np.median([r[2] for r in rs])),
                       ms_runs=[r[0] for r in rs])
            for side, rs in runs.items()}


def _gat_bwd_case(name, src, dst, mask, n, H, dout, dt, acc, gen,
                  timed=False, zero_rows=(), zero_scores=False):
    """``gat_aggregate_bwd`` against ``gat_aggregate_bwd_plain`` on the
    card, on seeded random hw, s_src, s_dst and output gradient, both
    from the forward's saved row statistics and output
    (``gat_aggregate_with_stats``, whose output must equal the forward's
    without them bit for bit, its ``m`` the plain ``gat_row_stats_plain``
    and its ``den`` within float32 rounding): two calls bit-identical;
    each gradient within TRAIN_TOL (1e-4 when dt and acc are f32, else
    2e-2) of its largest plain value; the ``zero_rows`` (no live in-edge)
    get no ds_dst.  ``zero_scores``: ``s_dst = -s_src``, so every
    self-loop's pre-activation is exactly 0, where leaky_relu's slope is
    1.  Timed: beside both bounds and the plain backward (its three
    kernels' split: phase 17's profile)."""
    import torch
    from repro_torch.kernels.segment_spmm import ops
    dev = torch.device(DEVICE)
    plan = ops.segment_plan(dst, n, src=src, mask=mask)
    by_src = ops.source_plan(plan)
    hw = torch.randn((n, H, dout), generator=gen, device=dev).to(dt)
    s_src = torch.randn((n, H), generator=gen, device=dev).to(dt)
    s_dst = torch.randn((n, H), generator=gen, device=dev).to(dt)
    if zero_scores:
        s_dst = -s_src
    g = torch.randn((n, H, dout), generator=gen, device=dev).to(acc)
    out, m, den = ops.gat_aggregate_with_stats(hw, s_src, s_dst, plan, mask,
                                               acc)
    plain_m, plain_den = ops.gat_row_stats_plain(s_src, s_dst, plan, mask,
                                                 acc)
    den_rtol = 1e-5 if acc == torch.float32 else 2.0 ** -7
    stats_err = float(((den - plain_den).abs()
                       / plain_den.abs()).max()) if n else 0.0
    check(torch.equal(out, ops.gat_aggregate(hw, s_src, s_dst, plan, mask,
                                             acc))
          and torch.equal(m, plain_m) and stats_err <= den_rtol,
          f"gat {name}: the forward with its row statistics differs "
          f"(den rel err {stats_err})")
    del plain_m, plain_den
    args = (hw, s_src, s_dst, plan, mask, acc, g, m, den, out)
    got = ops.gat_aggregate_bwd(*args, by_src)
    again = ops.gat_aggregate_bwd(*args, by_src)
    want = ops.gat_aggregate_bwd_plain(*args)
    torch.cuda.synchronize()
    key = "float32" if dt == acc == torch.float32 else "bfloat16"
    tol = TRAIN_TOL[key]
    names = ("dhw", "ds_src", "ds_dst")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"gat_bwd {name}: two calls differ")
    ratio = {k: _grad_ratio(a, b, tol) for k, a, b in zip(names, got, want)}
    E = dst.shape[0]
    row = dict(kernel="segment_spmm", variant="gat_bwd", shape=name, E=E,
               n=n, H=H, dout=dout, dtype=str(dt).split(".")[-1],
               acc_dtype=str(acc).split(".")[-1], hub_rows=plan.n_heavy,
               source_hub_rows=by_src.n_heavy,
               max_in_degree=int((plan.rowptr[1:] - plan.rowptr[:-1]).max()),
               max_abs_err=max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want)),
               ratio=ratio, tol=tol, check="max |diff| / max |plain|",
               fwd_stats_bit_equal=True, den_rel_err=stats_err)
    check(max(ratio.values()) <= 1
          and all(bool(torch.isfinite(a).all()) for a in got),
          f"gat_bwd {name} disagrees with its plain version: {row}")
    for v in zero_rows:
        check(not bool(got[2][v].any()),
              f"gat_bwd {name}: row {v} (no live edge) has ds_dst")
    if timed:
        row["kernel_ms"] = cuda_ms(
            lambda: ops.gat_aggregate_bwd(*args, by_src), iters=10)
        row["earlier_ms"] = BWD_EARLIER_MS.get(name)
        row["plain_ms"] = cuda_ms(
            lambda: ops.gat_aggregate_bwd_plain(*args), warmup=1, iters=2)
        row["library_ms"] = None
        row.update(_gat_bwd_bounds(E, n, H, dout, hw.element_size(),
                                   g.element_size()))
    del hw, s_src, s_dst, g, got, again, want, plan, by_src, args, out, m, den
    torch.cuda.empty_cache()
    return row


def phase_gnn_train_kernels(products: dict):
    """The GNN training path's backward kernels against their plain
    versions on the card.  "sum_bwd" (``segment_spmm_bwd``), a gather and
    a cast, bit for bit against ``segment_spmm_bwd_plain`` at the test
    sweep and edge cases (a hub row among them) for f32, bf16-into-f32
    and bf16 sums; then timed at the products graph's D = 64 (f32) and at
    GraphCast's Cora-sized bf16 shape, which the training cell runs,
    beside the bound, the plain version and ``dout.index_select(0,
    dst)`` (in turns, each call's host and device time apart).
    "gat_bwd" (``gat_aggregate_bwd``, from the forward's saved row
    statistics and output, which the forward must give with the same
    output bits as without them) against ``gat_aggregate_bwd_plain``
    (1e-4 of max |plain| in f32, 2e-2 with
    bf16 anywhere) on a small graph with a hub, masked slots, an empty and
    an all-masked row, at the test head shapes in every dtype pair and at
    the forward kernel's shape limits, and with self-loops whose scores
    are exactly 0, then at GAT's two layers on the products-sized graph
    (the training cell's shapes, each timed, and layer 1 in f32) and on
    the Cora-sized graph; each call made twice and bit-identical.
    Returns the timed rows."""
    import torch
    from repro_torch.kernels.segment_spmm import ops
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    t_phase = time.perf_counter()
    f32, b16 = torch.float32, torch.bfloat16
    pairs = {"f32": (f32, f32), "bf16_msgs": (b16, f32), "bf16": (b16, b16)}

    cases = []
    for E, N, D in [(300, 50, 8), (1000, 128, 32), (64, 7, 4)]:
        rng = np.random.default_rng(E + N)              # the test sweep
        dst = rng.integers(0, N, E).astype(np.int32)
        cases.append((f"sweep_{E}x{N}x{D}", torch.as_tensor(dst, device=dev),
                      N, D))
    for name, E, n, D in (("d1", 2000, 300, 1), ("d75", 5000, 400, 75),
                          ("no_edges", 0, 5, 8), ("masked", 3000, 500, 8)):
        cases.append((name, torch.randint(0, n, (E,), generator=gen,
                                          device=dev, dtype=torch.int32),
                      n, D))
    cases.append(("empty_rows", 2 * torch.randint(
        0, 300, (1000,), generator=gen, device=dev, dtype=torch.int32),
        600, 16))
    cases.append(("one_node", torch.full((1000,), 3, device=dev,
                                         dtype=torch.int32), 10, 16))
    cases.append(("hub", torch.randint(0, 400, (5000,), generator=gen,
                                       device=dev, dtype=torch.int32)
                  * (torch.rand((5000,), generator=gen, device=dev) > 0.2),
                  400, 64))
    for pair, (m_dt, o_dt) in pairs.items():
        for name, dst, n, D in cases:
            plan = ops.segment_plan(dst, n)
            dout = torch.randn((n, D), generator=gen, device=dev).to(o_dt)
            got = ops.segment_spmm_bwd(dout, dst, n, plan, m_dt)
            again = ops.segment_spmm_bwd(dout, dst, n, plan, m_dt)
            want = ops.segment_spmm_bwd_plain(dout, dst, m_dt)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and got.dtype == m_dt,
                  f"sum_bwd {name} {pair}: differs from its plain version "
                  f"(max abs err {float((got.float() - want.float()).abs().max()) if got.numel() else 0.0})")
            check(torch.equal(got, again), f"sum_bwd {name} {pair}: two "
                                           f"calls differ")
    emit(phase="gnn_train_kernels", kernel="segment_spmm", variant="sum_bwd",
         cases=[c[0] for c in cases], dtypes=list(pairs),
         hub_degree=ops.HUB_DEGREE, check="bit-exact, two calls identical")

    rows = {}
    cora = cora_graph()
    n_cora = cora["node_feats"].shape[0]
    dst_p = torch.as_tensor(products["edge_dst"], device=dev)
    n_p = _gnn_dims("ogb_products")["n_nodes"]
    for name, dst, n, D, (m_dt, o_dt) in (
            ("sum_bwd_products_d64", dst_p, n_p, 64, pairs["f32"]),
            ("sum_bwd_graphcast_cora_d512_bf16",
             torch.as_tensor(cora["edge_dst"], device=dev), n_cora, 512,
             pairs["bf16"])):
        plan = ops.segment_plan(dst, n)
        E = dst.shape[0]
        dout = torch.randn((n, D), generator=gen, device=dev).to(o_dt)
        got = ops.segment_spmm_bwd(dout, dst, n, plan, m_dt)
        want = ops.segment_spmm_bwd_plain(dout, dst, m_dt)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name}: differs from its plain "
                                      f"version")
        # the small shape's call is the host's: many rounds in turns
        small = E * D < 1 << 26
        split = _call_split(
            lambda: ops.segment_spmm_bwd(dout, dst, n, plan, m_dt),
            lambda: dout.index_select(0, dst), rounds=7 if small else 1,
            calls=200 if small else 10)
        row = dict(kernel="segment_spmm", variant="sum_bwd", shape=name, E=E,
                   n=n, D=D, dtype=str(m_dt).split(".")[-1],
                   dout_dtype=str(o_dt).split(".")[-1], max_abs_err=0.0,
                   check="bit-exact", kernel_ms=split["kernel"]["ms"],
                   earlier_ms=BWD_EARLIER_MS[name],
                   plain_ms=cuda_ms(lambda: ops.segment_spmm_bwd_plain(
                       dout, dst, m_dt), iters=5),
                   library="dout.index_select(0, dst)",
                   library_ms=split["library"]["ms"], split=split)
        row["bound_ms"], row["bound_by"] = _sum_bwd_bound_ms(
            E, n, D, got.element_size(), dout.element_size())
        emit(phase="gnn_train_kernels", **row)
        rows[name] = row
        del plan, dout, got, want
        torch.cuda.empty_cache()

    # "gat_bwd": the small graph at the test head shapes and at the
    # forward kernel's limits (bf16: 32 vectors of 8 values; f32: 32 of 4;
    # 21 values a row, not a multiple of 16 bytes: one value a lane)
    rng = np.random.default_rng(7)
    small = [torch.as_tensor(x, device=dev)
             for x in _gat_graph(rng, 300, 6000, hub=600)]
    worst = {}
    for H, dout_, dts in ((2, 4, None), (8, 8, None), (8, 7, None),
                          (32, 8, (b16,)), (16, 8, (f32,)), (3, 7, None)):
        for dt in dts or (f32, b16):
            check(ops.gat_shape_fits(H, dout_, dt), f"{H}x{dout_} {dt}")
            for acc in (f32, b16):
                r = _gat_bwd_case(f"small_{H}x{dout_}", *small, 300, H, dout_,
                                  dt, acc, gen, zero_rows=(7, 9))
                worst[f"{H}x{dout_}/{r['dtype']}/{r['acc_dtype']}"] = max(
                    r["ratio"].values())
    # self-loops on every tenth slot, whose scores are exactly 0
    loops = small[0].clone()
    loops[::10] = small[1][::10]
    for dt in (f32, b16):
        for acc in (f32, b16):
            r = _gat_bwd_case("small_8x8_zero_scores", loops, *small[1:], 300,
                              8, 8, dt, acc, gen, zero_rows=(7, 9),
                              zero_scores=True)
            worst[f"8x8_zero_scores/{r['dtype']}/{r['acc_dtype']}"] = max(
                r["ratio"].values())
    emit(phase="gnn_train_kernels", kernel="segment_spmm", variant="gat_bwd",
         shape="small (300 nodes, 6,600 slots, a 600-slot hub; also with "
               "a self-loop every tenth slot and s_dst = -s_src)",
         hub_degree=ops.HUB_DEGREE, tol=TRAIN_TOL, worst_ratio=worst)
    del small, loops
    src_p = torch.as_tensor(products["edge_src"], device=dev)
    mask_p = torch.ones_like(dst_p, dtype=torch.bool)
    cora_t = [torch.as_tensor(cora[k], device=dev)
              for k in ("edge_src", "edge_dst", "edge_mask")]
    for name, graph, n, H, dout_, dt, acc, timed in [
            ("gat_bwd_products_l1", (src_p, dst_p, mask_p), n_p, 8, 8, b16,
             f32, True),
            ("gat_bwd_products_l2", (src_p, dst_p, mask_p), n_p, 8, 7, b16,
             f32, True),
            ("gat_bwd_products_l1_f32", (src_p, dst_p, mask_p), n_p, 8, 8,
             f32, f32, True),
            ("gat_bwd_cora_l1", cora_t, n_cora, 8, 8, b16, f32, True)]:
        row = _gat_bwd_case(name, *graph, n, H, dout_, dt, acc, gen,
                            timed=timed)
        emit(phase="gnn_train_kernels", **row)
        rows[name] = row
    emit(phase="gnn_train_kernels", wall_s=time.perf_counter() - t_phase)
    del src_p, dst_p, mask_p
    torch.cuda.empty_cache()
    return rows


def _gnn_labels(kind: str, cfg, feats: np.ndarray, rng) -> np.ndarray:
    """Seeded labels of a model's kind: classes for GAT and PNA, the
    largest of ``n_classes`` fixed random projections of each node's
    features, which a model can learn; float targets for GraphCast (N,
    n_vars) and SchNet (N,)."""
    N = feats.shape[0]
    if kind == "graphcast":
        return rng.normal(size=(N, cfg.n_vars)).astype(np.float32)
    if kind == "schnet":
        return rng.normal(size=N).astype(np.float32)
    proj = rng.normal(size=(feats.shape[1], cfg.n_classes))
    return np.argmax(feats @ proj, axis=1).astype(np.int32)


def phase_gnn_train_parity():
    """The four GNNs at their full config widths on the Cora-sized graph,
    in float32 and in bfloat16: one training step's loss and every
    parameter's gradient (``GNNModel.loss``, ``torch.autograd.grad``
    under the trainer's deterministic mode), the kernel path against the
    plain path (``_plain_kernels``: autograd through the plain versions),
    each held to a relative 1e-3 (f32) or 5e-2 (bf16) (a gradient: max
    |diff| over max |plain| of its tensor); the kernel path's launches by
    variant, forward and backward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import graph_batch_from_arrays
    from repro_torch.models import GNNModel, init_gnn
    from repro_torch.runtime import deterministic
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    arrays = cora_graph()
    d_feat = arrays["node_feats"].shape[1]
    rng = np.random.default_rng(16)
    arrays["label_mask"] = rng.random(len(arrays["node_feats"])) < 0.5
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        res = {}
        for arch in GNN_ARCHS:
            cfg = dataclasses.replace(get_config(arch).model, dtype=dtype)
            gb = graph_batch_from_arrays(dict(arrays, labels=_gnn_labels(
                cfg.kind, cfg, arrays["node_feats"], rng)), device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(16)
            model = GNNModel(cfg, init_gnn(gen, cfg, d_feat, cfg.n_classes,
                                           device=dev)).requires_grad_(True)
            params = dict(model.named_parameters())

            def run(plain):
                with _plain_kernels(plain), deterministic():
                    _zero_gnn_train_launches()
                    loss = model.loss(gb)
                    grads = torch.autograd.grad(loss, list(params.values()))
                    torch.cuda.synchronize()
                    return loss.detach(), grads, _gnn_train_launches()

            lp, gp, launches_plain = run(True)
            lk, gk, launches = run(False)
            want = _gnn_train_want(cfg)
            check(launches == want, f"gnn_train_parity {arch} {dtype} "
                                    f"launches {launches} != {want}")
            check(not any(launches_plain.values()),
                  f"gnn_train_parity {arch} {dtype} plain path launched "
                  f"kernels: {launches_plain}")
            check(bool(torch.isfinite(lk)) and all(
                bool(torch.isfinite(g).all()) for g in gk),
                f"gnn_train_parity {arch} {dtype}: not finite")
            rel = {"loss": _rel(lk, lp)}
            rel.update({n: _rel(a, b) for n, a, b in zip(params, gk, gp)})
            worst = max(rel, key=rel.get)
            for key, val in rel.items():
                check(val <= tol, f"gnn_train_parity {arch} {dtype} {key}: "
                                  f"kernel vs plain rel {val} > {tol}")
            res[arch] = dict(n_layers=cfg.n_layers, d_hidden=cfg.d_hidden,
                             loss={"kernel": float(lk), "plain": float(lp)},
                             n_grads=len(gk), rel_err_loss=rel["loss"],
                             rel_err_grad_max={"param": worst,
                                               "rel": rel[worst]},
                             launches=launches)
            del model, params, gp, gk, gb
        emit(phase="gnn_train_parity", graph="cora-sized (2,708 nodes, "
             "10,556 edges, 1,433 features, half the labels masked)",
             dtype=dtype, tol=tol, models=res)
        torch.cuda.empty_cache()
    emit(phase="gnn_train_parity", wall_s=time.perf_counter() - t_phase)


_GNN_STEP_SPLIT = (  # (part, kernel-name substrings), matched in this order
    ("gat_bwd_node", ("gat_bwd_node_kernel",)),
    ("gat_bwd_src", ("gat_bwd_src_kernel",)),
    ("gat_bwd_dst", ("gat_bwd_dst_kernel",)),
    ("gat_fwd", ("gat_aggregate_kernel",)),
    ("sum_bwd", ("segment_sum_bwd",)),
    ("sum_fwd", ("segment_sum_kernel",)),
    ("gemm_library", ("gemm", "xmma", "nvjet", "cutlass")))


def reddit_sized_graph(seed: int = 3):
    """A seeded stand-in for ``minibatch_lg``'s graph (Reddit's size:
    232,965 nodes and 114,615,892 adjacency entries) in the port's
    ``Graph`` CSR: each entry's row uniform (multinomial degrees, mean
    492), its neighbour uniform.  Rows are not sorted and may repeat a
    neighbour: the sampler only draws from a row."""
    from repro_torch.graph import Graph
    rng = np.random.default_rng(seed)
    dims = _gnn_dims("minibatch_lg")
    N, E = dims["n_nodes"], dims["n_edges"]
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(rng.multinomial(E, np.full(N, 1.0 / N)), out=indptr[1:])
    return Graph(n=N, indptr=indptr,
                 indices=rng.integers(0, N, E, dtype=np.int32))


def phase_gnn_train(products: dict):
    """The GNN training cell: GAT (``gat-cora``'s full config, bf16
    weights, f32 AdamW moments) trained full-graph on the products-sized
    graph (2,449,029 nodes, 61,859,140 edge slots, 100 seeded features,
    labels the largest of 7 fixed random projections of the features).
    Run 1: ``Trainer.run`` for GNN_TRAIN_STEPS steps with a checkpoint
    every GNN_TRAIN_CKPT_EVERY and a fault injected at step
    GNN_TRAIN_FAULT_AT (restore, replay).  Run 2: the same seed,
    uninterrupted, with the launch counts set to 0 before it and read
    after it.  The losses after the restored checkpoint must be equal bit
    for bit, and the loss must fall.  Then one step under
    ``torch.profiler``; GraphCast at full width (bf16) for a few steps on
    the Cora-sized graph, whose launches stand for "sum" and "sum_bwd"
    (its loss must fall too);
    and a sampled run: GAT fed by ``gnn_epoch_stream`` at
    ``minibatch_lg``'s capacities (batch 1,024, fanout 15/10) on a seeded
    graph of its size, the sampler's host ms beside each step's ms.
    Returns the launches of run 2 (GAT) and of the GraphCast steps."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import graph_batch_from_arrays
    from repro_torch.data import gnn_epoch_stream
    from repro_torch.graph import sample_capacities
    from repro_torch.models import GNNModel, GraphBatch, init_gnn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    cfg = get_config("gat-cora").model
    dims = _gnn_dims("ogb_products")
    N, F_ = dims["n_nodes"], dims["d_feat"]
    ckpt_root = os.path.join(ROOT, "build", "chip_smoke_gnn_ckpt")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    t0 = time.perf_counter()
    feats = torch.randn((N, F_), generator=gen, device=dev)
    proj = torch.randn((F_, cfg.n_classes), generator=gen, device=dev)
    labels = torch.argmax(feats @ proj, dim=1).to(torch.int32)
    gb = GraphBatch(node_feats=feats.to(torch.bfloat16), labels=labels,
                    label_mask=torch.ones(N, dtype=torch.bool, device=dev),
                    **{k: torch.as_tensor(v, device=dev)
                       for k, v in products.items()})
    del feats, proj
    gb.gat_plan()
    gb.gat_source_plan()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def batches():
        while True:
            yield gb

    def run(tag, fault, ckpt_every):
        """``Trainer.run`` with checkpoints, or, without (``ckpt_every``
        None), the same steps through ``train_step`` alone."""
        shutil.rmtree(ckpt_root, ignore_errors=True)
        g = torch.Generator(device=dev)
        g.manual_seed(18)
        model = GNNModel(cfg, init_gnn(g, cfg, F_, cfg.n_classes,
                                       device=dev))
        tr = Trainer(lambda m, b: m.loss(b), model,
                     AdamWConfig(lr=1e-2, warmup_steps=3,
                                 total_steps=GNN_TRAIN_STEPS),
                     TrainerConfig(ckpt_dir=os.path.join(ckpt_root, tag),
                                   ckpt_every=ckpt_every or 1 << 30,
                                   log_every=GNN_TRAIN_STEPS))
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_gnn_train_launches()
        t0 = time.perf_counter()
        if ckpt_every:
            hist = tr.run(batches(), GNN_TRAIN_STEPS, fault=fault,
                          log=logs.append)
        else:
            hist = [tr.train_step(gb) for _ in range(GNN_TRAIN_STEPS)]
        tr.finish()
        torch.cuda.synchronize()
        return dict(tr=tr, hist=hist, logs=logs,
                    wall_s=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated(),
                    launches=_gnn_train_launches())

    r1 = run("faulted", FaultInjector({GNN_TRAIN_FAULT_AT}),
             GNN_TRAIN_CKPT_EVERY)
    faults = [m for m in r1["logs"] if "fault at step" in m]
    check(len(faults) == 1 and f"injected fault at step {GNN_TRAIN_FAULT_AT}"
          in faults[0], f"gnn_train run 1: expected one injected fault, got "
                        f"{faults}")
    losses1 = {h["step"]: h["loss"] for h in r1["hist"]}
    del r1["tr"]
    r2 = run("uninterrupted", None, None)
    losses2 = {h["step"]: h["loss"] for h in r2["hist"]}
    check(sorted(losses2) == list(range(1, GNN_TRAIN_STEPS + 1))
          and all(math.isfinite(v) for v in losses2.values()),
          f"gnn_train run 2 losses {losses2}")
    restored = GNN_TRAIN_FAULT_AT // GNN_TRAIN_CKPT_EVERY * GNN_TRAIN_CKPT_EVERY
    replayed = list(range(restored + 1, GNN_TRAIN_STEPS + 1))
    check(all(losses1[s] == losses2[s] for s in replayed),
          f"gnn_train: steps {replayed} after the restore differ: "
          f"{[(s, losses1[s], losses2[s]) for s in replayed]}")
    check(losses2[GNN_TRAIN_STEPS] < losses2[1],
          f"gnn_train: the loss did not fall ({losses2[1]} -> "
          f"{losses2[GNN_TRAIN_STEPS]})")
    want = _gnn_train_want(cfg, GNN_TRAIN_STEPS)
    check(r2["launches"] == want,
          f"gnn_train run 2 launches {r2['launches']} != {want}")
    profile_split = _profile_train_step(r2["tr"], gb, parts=_GNN_STEP_SPLIT)
    secs = [h["secs"] for h in r2["hist"]]

    def pct(x, p):
        return float(np.percentile(np.asarray(x) * 1e3, p))

    gat_launches = r2["launches"]
    shutil.rmtree(ckpt_root, ignore_errors=True)
    emit(phase="gnn_train", arch="gat-cora", dtype=cfg.dtype,
         n_layers=cfg.n_layers, heads=cfg.n_heads, d_hidden=cfg.d_hidden,
         n_out=cfg.n_classes, graph=dict(n_nodes=N, edge_slots=len(
             products["edge_dst"]), d_feat=F_, setup_s=setup_s),
         steps=GNN_TRAIN_STEPS, ckpt_every=GNN_TRAIN_CKPT_EVERY,
         fault_at=GNN_TRAIN_FAULT_AT, restored_from=restored,
         losses_uninterrupted=[losses2[s] for s in sorted(losses2)],
         losses_faulted={s: losses1[s] for s in sorted(losses1)},
         replay_bit_equal=replayed, step_ms_p50=pct(secs, 50),
         step_ms_p90=pct(secs, 90), step_ms_first=secs[0] * 1e3,
         nodes_per_s=N / (pct(secs, 50) / 1e3),
         wall_s={"faulted": r1["wall_s"], "uninterrupted": r2["wall_s"]},
         peak_bytes={"faulted": r1["peak"], "uninterrupted": r2["peak"]},
         launches=gat_launches, faulted_run_launches=r1["launches"],
         profile_step=profile_split)
    del r1, r2, gb
    gc.collect()
    torch.cuda.empty_cache()

    # GraphCast at full width (16 layers, d = 512, bf16) on the Cora-sized
    # graph: a few steps, whose launches stand for "sum" and "sum_bwd".
    # Its 16 residual layers have no normalisation, so at the reference's
    # initialisation the loss starts near 1e11; a learning rate of 1e-3
    # overshoots there (the loss rose 400-fold at the second step), 1e-4
    # takes it down
    gcfg = get_config("graphcast").model
    arrays = cora_graph()
    rng = np.random.default_rng(17)
    arrays["labels"] = _gnn_labels("graphcast", gcfg, arrays["node_feats"],
                                   rng)
    arrays["label_mask"] = np.ones(len(arrays["node_feats"]), bool)
    cgb = graph_batch_from_arrays(arrays, device=dev)
    gen.manual_seed(19)
    gmodel = GNNModel(gcfg, init_gnn(gen, gcfg, arrays["node_feats"].shape[1],
                                     gcfg.n_classes, device=dev))
    gtr = Trainer(lambda m, b: m.loss(b), gmodel,
                  AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10),
                  TrainerConfig(ckpt_dir=ckpt_root, log_every=1 << 30))
    _zero_gnn_train_launches()
    ghist = [gtr.train_step(cgb) for _ in range(3)]
    graphcast_launches = _gnn_train_launches()
    check(graphcast_launches == _gnn_train_want(gcfg, 3)
          and all(math.isfinite(h["loss"]) for h in ghist)
          and ghist[-1]["loss"] < ghist[0]["loss"],
          f"gnn_train GraphCast launches {graphcast_launches} or loss "
          f"{[h['loss'] for h in ghist]} (must fall)")
    del gmodel, gtr, cgb

    # the sampled run: GAT on minibatch_lg's capacities, fed by the epoch
    # stream over a seeded graph of its size
    t0 = time.perf_counter()
    mdims = _gnn_dims("minibatch_lg")
    graph = reddit_sized_graph()
    rng = np.random.default_rng(20)
    mfeats = rng.standard_normal((graph.n, mdims["d_feat"]),
                                 dtype=np.float32)
    mlabels = rng.integers(0, cfg.n_classes, graph.n).astype(np.int32)
    graph_s = time.perf_counter() - t0
    fanout = (mdims["fanout0"], mdims["fanout1"])
    caps = sample_capacities(mdims["batch_nodes"], fanout)
    gen.manual_seed(21)
    smodel = GNNModel(cfg, init_gnn(gen, cfg, mdims["d_feat"], cfg.n_classes,
                                    device=dev))
    str_ = Trainer(lambda m, b: m.loss(b), smodel,
                   AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10),
                   TrainerConfig(ckpt_dir=ckpt_root, log_every=1 << 30))
    stream = gnn_epoch_stream(graph, mfeats, mlabels, mdims["batch_nodes"],
                              fanout, seed=22, n_steps=SAMPLED_STEPS)
    steps = []
    _zero_gnn_train_launches()
    while True:
        t0 = time.perf_counter()
        batch = next(stream, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        sgb = graph_batch_from_arrays(batch, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = str_.train_step(sgb)
        check(sgb.edge_src.shape[0] == caps[1]
              and sgb.node_feats.shape[0] == caps[0]
              and math.isfinite(out["loss"]),
              f"gnn_train sampled step: shapes or loss {out['loss']}")
        steps.append(dict(sampler_host_ms=(t1 - t0) * 1e3,
                          copy_ms=(t2 - t1) * 1e3, step_ms=out["secs"] * 1e3,
                          live_edges=int(batch["edge_mask"].sum()),
                          nodes=int((batch["label_mask"]).sum()),
                          loss=out["loss"]))
    sampled_launches = _gnn_train_launches()
    check(len(steps) == SAMPLED_STEPS and sampled_launches
          == _gnn_train_want(cfg, SAMPLED_STEPS),
          f"gnn_train sampled run: {len(steps)} steps, launches "
          f"{sampled_launches}")
    emit(phase="gnn_train", run="sampled", arch="gat-cora", dtype=cfg.dtype,
         graph=dict(n_nodes=graph.n, adjacency_entries=int(
             graph.indices.shape[0]), d_feat=mdims["d_feat"],
             build_s=graph_s),
         batch_nodes=mdims["batch_nodes"], fanout=list(fanout),
         capacities={"nodes": caps[0], "edges": caps[1]}, steps=steps,
         launches=sampled_launches,
         graphcast=dict(arch="graphcast", dtype=gcfg.dtype,
                        n_layers=gcfg.n_layers, d_hidden=gcfg.d_hidden,
                        graph="cora-sized", steps=[dict(
                            loss=h["loss"], step_ms=h["secs"] * 1e3)
                            for h in ghist], launches=graphcast_launches),
         phase_s=time.perf_counter() - t_phase)
    del smodel, str_, graph, mfeats
    shutil.rmtree(ckpt_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return gat_launches, graphcast_launches


# --------------------------------------------------------------------------- #
# phase 18: dist
# --------------------------------------------------------------------------- #
# the caps of the two-process gate of the tests
# (tests/test_torch_dist.py::test_dist_two_process_matches_sim)
DIST_CLI_CAPS = ["--frontier-cap", str(1 << 12), "--fetch-cap", str(1 << 9),
                 "--verify-cap", str(1 << 11), "--region-budget", str(1 << 11)]
DIST_RANKS = 2
# host-local timings and the rank's own topology: not the logical result
DIST_RANK_KEYS = TIMING_KEYS | {"process_index", "process_count"}
DIST_TIMEOUT_S = 600.0


def _logical(stats: dict) -> dict:
    """A stats dict's logical part, as JSON carries it."""
    st = json.loads(json.dumps(stats, default=float))
    return {k: v for k, v in st.items() if k not in DIST_RANK_KEYS}


def _check_same_logical(got: dict, want: dict, what: str) -> None:
    got, want = _logical(got), _logical(want)
    check(set(got) == set(want),
          f"{what}: stat keys differ: {sorted(set(got) ^ set(want))}")
    for k in want:
        check(got[k] == want[k],
              f"{what}: stat {k} differs from sim: {got[k]!r} vs {want[k]!r}")


def _dist_cli(storage: str, wire: str) -> dict:
    """Part (a): ``launch_local`` of two ``dist_worker`` ranks on the card,
    held to an in-process ``sim`` run of the same partition and config."""
    import torch
    from repro_torch.configs.rads import QUERIES
    from repro_torch.core import Pattern, merge_process_stats, rads_enumerate
    from repro_torch.graph import load_dataset, partition
    from repro_torch.launch.dist_worker import (build_argparser,
                                                launch_local, worker_config)
    args = ["--dataset", "dblp_bench", "--query", "q1", "--partition",
            "hash", "--storage", storage, "--wire", wire, *DIST_CLI_CAPS,
            "--device", "cuda"]
    t0 = time.perf_counter()
    workers = launch_local(DIST_RANKS, args, timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(workers is not None, "dist_worker exited 3 (no torch.distributed "
                               "with gloo) on the card")
    cfg = worker_config(build_argparser().parse_args(args))
    sim = rads_enumerate(partition(load_dataset("dblp_bench"), DIST_RANKS,
                                   method="hash"),
                         Pattern.from_edges(QUERIES["q1"]), cfg, mode="sim",
                         return_embeddings=False, device=DEVICE)
    torch.cuda.synchronize()
    tag = f"dist_worker {storage}/{wire}"
    for rank, w in enumerate(workers):
        check(w["count"] == sim.count,
              f"{tag} rank {rank}: count {w['count']} != sim {sim.count}")
        check(w["device"] == "cuda:0", f"{tag} rank {rank} ran on "
                                       f"{w['device']}")
        check(w["launches"]["membership"] > 0,
              f"{tag} rank {rank}: membership never launched")
        if storage == "bucketed":
            check(w["launches"]["intersect"] > 0,
                  f"{tag} rank {rank}: intersect never launched")
        _check_same_logical(w["stats"], sim.stats, f"{tag} rank {rank}")
    merged = merge_process_stats([w["stats"] for w in workers])
    return dict(storage=storage, wire=wire, count=sim.count,
                command_s=wall, wall_skew=merged["wall_skew"],
                per_process_wall_us=merged["per_process_wall_us"],
                launches=[w["launches"] for w in workers],
                max_memory_allocated=[w["max_memory_allocated"]
                                      for w in workers])


def _dist_full_rank(rank: int, port: int, src: str, pg_dir: str,
                    out_dir: str) -> None:
    """Part (b), one rank (a spawned process): the partition from
    ``pg_dir``, ``rads_enumerate(mode="dist")`` of q1 with the default
    EngineConfig on ``cuda:0``, its payload JSON to ``out_dir``."""
    import datetime
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES
    from repro_torch.core import Exchange, Pattern, rads_enumerate
    from repro_torch.graph import PartitionedGraph, device_graph
    from repro_torch.kernels.membership import ops as memb
    torch.cuda.set_device(0)
    with open(os.path.join(pg_dir, "ints.json")) as f:
        ints = json.load(f)
    pg = PartitionedGraph(**ints, **{
        k: np.load(os.path.join(pg_dir, f"{k}.npy"))
        for k in ("adj", "deg", "n_local", "border", "border_dist",
                  "old2new", "new2old")})
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DIST_RANKS, rank=rank,
                            timeout=datetime.timedelta(minutes=5))
    try:
        # the rank's block, built as the driver builds it: its tensors'
        # bytes, and what the allocator gave them on the card
        before = torch.cuda.memory_allocated()
        dg = device_graph(pg, DEFAULT_ENGINE.storage_format, "cuda:0",
                          Exchange("dist").block(pg.ndev))
        resident = dict(resident_adj_bytes=dg.resident_bytes,
                        adj_allocated_bytes=torch.cuda.memory_allocated()
                        - before, adj_nloc=dg.nloc)
        del dg
        torch.cuda.reset_peak_memory_stats()
        memb.launches = 0
        t0 = time.perf_counter()
        res = rads_enumerate(pg, Pattern.from_edges(QUERIES["q1"]),
                             DEFAULT_ENGINE, mode="dist",
                             return_embeddings=False, device="cuda:0")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        payload = dict(
            rank=rank, count=res.count, wall_s=wall,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            membership_launches=memb.launches, stats=res.stats,
            psum=_psum_rank(rank), **resident)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(payload, f, default=float)


def _psum_rank(rank: int) -> dict:
    """Phase 23's part on a phase 18 rank: ``compressed_psum`` of each of
    ``PSUM_CASES`` (this rank's values seeded by its rank) on the card,
    against the same call on CPU copies and the float64 sum (both over
    the same gloo group); each call timed once warm."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((DIST_RANKS,), ("pod",), device_type="cuda")
    group = mesh.get_group("pod")
    out = {}
    for i, (name, (shape, dtype, scale)) in enumerate(PSUM_CASES.items()):
        gen = torch.Generator(device="cuda").manual_seed(1000 * i + rank)
        x = (torch.randn(shape, generator=gen, device="cuda") * scale).to(
            getattr(torch, dtype))
        compressed_psum(x, "pod", mesh)                     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = compressed_psum(x, "pod", mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = compressed_psum(x.cpu(), "pod", mesh)
        exact = x.cpu().double()
        dist.all_reduce(exact, group=group)
        got = got.cpu()
        err = float((got.double() - exact).abs().max())
        out[name] = dict(
            shape=list(shape), dtype=dtype, bytes=x.numel() * x.element_size(),
            device=str(x.device), ms=ms,
            equal_cpu=bool(torch.equal(got.view(torch.uint8),
                                       want.contiguous().view(torch.uint8))),
            rel_err_vs_exact=err / max(float(exact.abs().max()), 1e-30))
    return out


def _dist_spawn(pg, tmp: str) -> list:
    """Spawn the part (b) ranks over ``pg`` (saved under ``tmp``) and
    return their payloads; fails on a rank's exit code or a hang."""
    import multiprocessing as mp
    import socket
    pg_dir = os.path.join(tmp, "pg")
    os.makedirs(pg_dir)
    with open(os.path.join(pg_dir, "ints.json"), "w") as f:
        json.dump({k: int(getattr(pg, k)) for k in
                   ("n", "n_real", "ndev", "stride", "max_degree")}, f)
    for k in ("adj", "deg", "n_local", "border", "border_dist", "old2new",
              "new2old"):
        np.save(os.path.join(pg_dir, f"{k}.npy"), getattr(pg, k))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_full_rank,
                         args=(r, port, os.path.join(ROOT, "src"), pg_dir,
                               tmp))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    check(not hung, f"dist ranks outlived {DIST_TIMEOUT_S:.0f}s")
    codes = [p.exitcode for p in procs]
    check(not any(codes), f"dist ranks failed: exit codes {codes}")
    out = []
    for r in range(DIST_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_dist(n: int, g=None, expect: int | None = None):
    """Phase 18: the ``dist`` exchange, one rank per partition over
    ``torch.distributed`` (gloo), two ranks sharing the card.  (a) the
    worker CLI, bucketed/varint (the configuration with the most code;
    part (b) runs dense/raw), against ``sim`` on the card; (b) the full cell's recipe split 2 ways, q1 dense/raw with the
    default EngineConfig: the count against scipy's triangles, every
    logical stat against an in-process ``sim`` run of the same partition
    on the card, each rank's wall time, peak memory, resident adjacency
    and membership launches beside ``sim``'s.  ``g`` and ``expect`` are
    the recipe's graph at ``n`` and its triangle count, when phase 5 has
    them.  Returns each rank's ``compressed_psum`` results, which phase
    23 checks."""
    import tempfile

    import torch
    from repro_torch.configs.rads import DEFAULT_ENGINE, QUERIES
    from repro_torch.core import Pattern, merge_process_stats, rads_enumerate
    from repro_torch.graph import partition, powerlaw_graph
    from repro_torch.kernels.membership import ops as memb
    t0 = time.perf_counter()
    cli = _dist_cli("bucketed", "varint")
    emit(phase="dist", part="worker_cli", graph="dblp_bench hash/2",
         runs=[cli], added_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    if g is None:
        g = powerlaw_graph(n, 6, seed=1)
        expect = _triangles(g)
    pg = partition(g, DIST_RANKS, method="bfs")
    setup_s = time.perf_counter() - t0
    pat = Pattern.from_edges(QUERIES["q1"])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    memb.launches = 0
    t0 = time.perf_counter()
    sim = rads_enumerate(pg, pat, DEFAULT_ENGINE, mode="sim",
                         return_embeddings=False, device=DEVICE)
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    sim_peak = torch.cuda.max_memory_allocated()
    sim_launches = memb.launches
    check(sim.count == expect, f"dist phase: sim count {sim.count} != "
                               f"scipy triangles {expect}")
    # the ranks get the card's memory: the parent keeps only its context
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _dist_spawn(pg, tmp)
    dist_s = time.perf_counter() - t0
    for r in ranks:
        check(r["count"] == expect,
              f"dist rank {r['rank']}: count {r['count']} != scipy "
              f"triangles {expect}")
        check(r["membership_launches"] > 0,
              f"dist rank {r['rank']}: membership never launched")
        # the rank's block alone is on the card: one machine's tensors, and
        # the allocator's rounding (under 1 MB a tensor) at most beside them
        check(r["adj_nloc"] == 1 and r["resident_adj_bytes"]
              * DIST_RANKS == sim.stats["peak_adj_bytes"]
              and 0 <= r["adj_allocated_bytes"] - r["resident_adj_bytes"]
              < 4 << 20,
              f"dist rank {r['rank']}: the device graph holds "
              f"{r['resident_adj_bytes']} B ({r['adj_allocated_bytes']} B "
              f"allocated) of a {sim.stats['peak_adj_bytes']} B stack")
        _check_same_logical(r["stats"], sim.stats, f"dist rank {r['rank']}")
    merged = merge_process_stats([r["stats"] for r in ranks])
    st = merged
    emit(phase="dist", part="full", n=n, published_n=FULL_N,
         cut=n != FULL_N, cut_reason=CUT_REASON if n == SMOKE_N else None,
         ranks=DIST_RANKS, setup_s=setup_s,
         count=expect, triangles_scipy=expect,
         per_rank=[{k: r[k] for k in ("rank", "wall_s",
                                      "max_memory_allocated",
                                      "resident_adj_bytes",
                                      "adj_allocated_bytes",
                                      "membership_launches")}
                   for r in ranks],
         spawn_to_exit_s=dist_s, wall_skew=st["wall_skew"],
         per_process_wall_us=st["per_process_wall_us"],
         n_waves=st["n_waves"], cap_escalations=st["cap_escalations"],
         final_caps=st["final_caps"],
         bytes_fetch=st["bytes_fetch"], bytes_verify=st["bytes_verify"],
         bytes_wire_fetch=st["bytes_wire_fetch"],
         bytes_wire_verify=st["bytes_wire_verify"],
         bytes_wire_fetch_dev=st["bytes_wire_fetch_dev"],
         bytes_wire_verify_dev=st["bytes_wire_verify_dev"],
         peak_adj_bytes=st["peak_adj_bytes"],
         sim=dict(wall_s=sim_wall, max_memory_allocated=sim_peak,
                  membership_launches=sim_launches))
    return [r["psum"] for r in ranks]


# --------------------------------------------------------------------------- #
# phase 23: the production mesh plan and compressed_psum
# --------------------------------------------------------------------------- #
def phase_mesh_plan(psum: list) -> None:
    """Phase 23: phase 18's ranks' ``compressed_psum`` results held to
    the CPU call bit for bit and to the float64 sum within 5%; the
    argument plan of every cell on both production meshes (device-free,
    beside the card's memory); DeepSeek-V3 decode_32k's step at 61 layers
    checked on the meta device."""
    import torch
    from repro_torch.configs import all_cells
    from repro_torch.launch.dryrun import MESH_RANKS, plan_cell, step_check
    from repro_torch.launch.mesh import make_production_mesh, plan_world
    from repro_torch.launch.specs import arg_bytes, build_cell
    t_phase = time.perf_counter()
    for name in PSUM_CASES:
        for rank, res in enumerate(psum):
            r = res[name]
            check(r["device"].startswith("cuda"),
                  f"compressed_psum {name}: ran on {r['device']}")
            check(r["equal_cpu"], f"compressed_psum {name} rank {rank}: the "
                                  f"card's result differs from the CPU's")
            check(r["rel_err_vs_exact"] <= PSUM_TOL,
                  f"compressed_psum {name} rank {rank}: "
                  f"{r['rel_err_vs_exact']:.4f} of the exact sum's max")
        emit(phase="mesh_plan", part="compressed_psum", case=name,
             ranks=DIST_RANKS, backend="gloo", **{
                 k: psum[0][name][k] for k in ("shape", "dtype", "bytes")},
             ms=[res[name]["ms"] for res in psum],
             equal_cpu=[res[name]["equal_cpu"] for res in psum],
             rel_err_vs_exact=[res[name]["rel_err_vs_exact"]
                               for res in psum])
    card = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    per_cell = {cell: {} for cell in all_cells()}
    # every cell on one mesh of each fake world
    for mk, ranks in MESH_RANKS.items():
        with plan_world(ranks):
            mesh = make_production_mesh(multi_pod=mk == "multi",
                                        device_type="cpu")
            for (arch, shape), per_mesh in per_cell.items():
                per_mesh[mk] = arg_bytes(build_cell(arch, shape, mesh))
    plan_s = time.perf_counter() - t0
    for (arch, shape), per_mesh in per_cell.items():
        emit(phase="mesh_plan", part="plan", arch=arch, shape=shape,
             arg_bytes_per_device=per_mesh, card_bytes=card,
             share_of_card={mk: b["total"] / card
                            for mk, b in per_mesh.items()})
    t0 = time.perf_counter()
    cell, _ = plan_cell("deepseek-v3-671b", "decode_32k", "single")
    res = step_check(cell)
    n_layers = len(cell.arg_specs[0].blocks)
    check(res["step_check"] == "ok" and res["flops_global_step"] > 0,
          f"deepseek-v3-671b decode_32k step check: {res}")
    emit(phase="mesh_plan", part="step_check", arch="deepseek-v3-671b",
         shape="decode_32k", n_layers=n_layers, plan_s=plan_s,
         check_s=time.perf_counter() - t0, **res,
         phase_s=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------- #
# phase 19: DeepSeek-V3 serving (MLA)
# --------------------------------------------------------------------------- #
def _mla_flash_case(name, B, S, H, D, Dv, dtype, gen, variant,
                    timed=False):
    """flash_attn at D != Dv, causal, against its plain version
    elementwise at FLASH_TOL, two calls bit-identical, through
    ``variant``; ``timed`` adds the kernel's, the plain version's and
    SDPA's ms (``_sdpa_ms``) beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as flash
    dev = torch.device(DEVICE)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
    v = torch.randn((B, S, H, Dv), generator=gen, device=dev).to(dt)
    row = dict(kernel="flash_attn", shape=name, dtype=dtype, B=B, Sq=S,
               Skv=S, H=H, Hk=H, D=D, Dv=Dv, causal=True)
    before = dict(flash.launches_by_variant)
    got = flash.flash_attention_k(q, k, v, causal=True)
    row["variant"] = _variant_of(flash, before)
    again = flash.flash_attention_k(q, k, v, causal=True)
    want = flash.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(row["variant"] == variant,
          f"flash {name} {dtype} ran {row['variant']}, not {variant}")
    check(torch.equal(got, again), f"flash {name} {dtype}: two calls differ")
    check(bool(torch.isfinite(got).all()), f"flash {name} not finite")
    ok, row["max_abs_err"], row["elem_ratio"], _ = _compare(
        got, want, FLASH_TOL[dtype])
    row["tol"] = FLASH_TOL[dtype]
    check(ok, f"flash {name} {dtype} ({variant}) disagrees: max abs err "
              f"{row['max_abs_err']}, elementwise ratio {row['elem_ratio']}")
    del got, again, want
    if timed:
        row["kernel_ms"] = cuda_ms(lambda: flash.flash_attention_k(
            q, k, v, causal=True), warmup=1, iters=5)
        row["plain_ms"] = cuda_ms(lambda: flash.flash_attention_plain(
            q, k, v, causal=True), warmup=1, iters=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row.update(_sdpa_ms(lambda: lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), D, Dv, 5))
        del qt, kt, vt
        _timed(row, _flash_work(B, S, S, H, H, D, True, dtype, Dv), dtype)
    emit(phase="mla_kernels", **row)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def _moe_chunked_case(name, x, wg, wu, wd, variant, iters):
    """moe_gemm in bf16 at DeepSeek-V3's expert widths, on the model's own
    expert weights: two launches bit-identical; each pass against its
    plain version elementwise at MOE_TOL and against the function computed
    exactly (``moe_gemm_f64``), MOE_CHUNK experts at a time (the plain
    versions' float32 and float64 copies of all 256 experts' weights
    would take 45 and 90 GB); end to end against the plain version
    recorded, not held (see MOE_TOL).  Timed beside the bound, the plain
    version over the same chunks and three ``bmm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ops as moe
    from repro_torch.kernels.moe_gemm.ref import (bound_ratio, moe_down_ref,
                                                  moe_gemm_f64, moe_gemm_ref,
                                                  moe_hidden_ref)
    E, C, d = x.shape
    f = wg.shape[-1]
    tol = MOE_TOL["bfloat16"]
    row = dict(kernel="moe_gemm", shape=name, dtype="bfloat16", E=E, C=C,
               d=d, f=f, check="per_pass, exact")
    before = dict(moe.launches_by_variant)
    got = moe.moe_gemm(x, wg, wu, wd)
    row["variant"] = _variant_of(moe, before)
    h = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    again = torch.empty_like(x)
    moe_kernel.moe_gemm_cuda(x, wg, wu, wd, h, again, row["variant"])
    torch.cuda.synchronize()
    check(row["variant"] == variant,
          f"moe {name} ran {row['variant']}, not {variant}")
    check(torch.equal(again, got), f"moe {name}: two launches differ")
    del again
    chunks = [slice(e, e + MOE_CHUNK) for e in range(0, E, MOE_CHUNK)]
    worst = dict.fromkeys(("h_elem_ratio", "down_elem_ratio",
                           "h_exact_ratio", "exact_ratio", "max_abs_err",
                           "elem_ratio"), 0.0)
    for sl in chunks:
        h_plain = moe_hidden_ref(x[sl], wg[sl], wu[sl])
        exact = moe_gemm_f64(x[sl], wg[sl], wu[sl], wd[sl])
        _, err, elem, _ = _compare(got[sl], moe_down_ref(h_plain, wd[sl]),
                                   tol)
        vals = dict(
            h_elem_ratio=_compare(h[sl], h_plain, tol)[2],
            down_elem_ratio=_compare(got[sl], moe_down_ref(h[sl], wd[sl]),
                                     tol)[2],
            h_exact_ratio=bound_ratio(h[sl], exact["h"], exact["h_bound"]),
            exact_ratio=bound_ratio(got[sl], exact["out"],
                                    exact["out_bound"]),
            max_abs_err=err, elem_ratio=elem)
        worst = {key: max(worst[key], vals[key]) for key in worst}
        del h_plain, exact
    row.update(worst)
    for key in ("h_elem_ratio", "down_elem_ratio", "h_exact_ratio",
                "exact_ratio"):
        check(row[key] <= 1, f"moe_gemm {name} ({variant}) {key} "
                             f"{row[key]} > 1")
    del got, h
    row["kernel_ms"] = cuda_ms(lambda: moe.moe_gemm(x, wg, wu, wd),
                               warmup=1, iters=iters)
    row["plain_ms"] = cuda_ms(lambda: [moe_gemm_ref(x[sl], wg[sl], wu[sl],
                                                    wd[sl])
                                       for sl in chunks], warmup=1, iters=1)
    row["library_ms"] = cuda_ms(lambda: torch.bmm(
        F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd), warmup=1,
        iters=iters)
    _timed(row, _moe_work(E, C, d, f, "bfloat16"), "bfloat16")
    emit(phase="mla_kernels", **row)
    torch.cuda.empty_cache()
    return row


def phase_mla_serve():
    """The serve_dsv3 cell: DeepSeek-V3 at its published widths in bf16,
    cut to MLA_LAYERS layers (the 3 dense and 1 MoE layer), seeded random
    weights on the card.  (a) flash_attn at D != Dv against its plain
    version: the reduced config's (24, 16) in f32 and bf16 ("simt"),
    (192, 128) in f32 ("simt") and at the cell's prefill shape in bf16
    ("wgmma", timed).  (b) SERVE_BATCH prompts of SERVE_PROMPT tokens,
    prefill (``last_only``) and SERVE_DECODE absorbed decode steps,
    twice: the tokens bit-equal, prefill through "wgmma" (flash_attn once
    a layer, moe_gemm once), decode through "stream"; run 1's first
    MLA_NAIVE_STEPS steps replayed from its prefill cache, each also
    naive from the same cache (router pinned), the naive logits within
    MLA_NAIVE_TOL of the absorbed ones; one prefill and 3 steps under
    ``torch.profiler``.  (c) moe_gemm on the MoE layer's
    experts at the prefill capacity ("wgmma") and at decode ("stream"),
    timed.  (d) the kernel path against the plain path: bf16 on the dense
    and the MoE layer of (b)'s model (router pinned, as phase 7) to 5e-2,
    then one dense layer in f32 to 1e-3.  Returns the timed rows and run
    (b)'s launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gemm.ops import route as moe_route
    from repro_torch.models import (TransformerLM, cache_spec, decode_step,
                                    init_lm_params)
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_config(MLA_ARCH).model, n_layers=MLA_LAYERS)
    m, mo = cfg.mla, cfg.moe
    H, D, Dv = cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim, \
        m.v_head_dim
    n_moe = cfg.n_layers - mo.first_k_dense
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)

    def capacity(T):
        return max(int(T * mo.top_k / mo.n_experts * mo.capacity_factor), 1)

    rows = {}
    for dtype in ("float32", "bfloat16"):
        _mla_flash_case("mla_reduced_24_16", 2, 512, 4, 24, 16, dtype, gen,
                        "simt")
    _mla_flash_case("mla_192_128_f32", 1, 2048, 32, D, Dv, "float32", gen,
                    "simt")
    rows["flash_attn"] = _mla_flash_case(
        "serve_dsv3_prefill", SERVE_BATCH, SERVE_PROMPT, H, D, Dv,
        "bfloat16", gen, "wgmma", timed=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_lm_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    runs = [_serve_once(model, prompts, absorbed=True, last_only=True,
                        keep_cache=i == 0) for i in range(2)]
    want = _lm_want({"wgmma": cfg.n_layers},
                    {"wgmma": n_moe, "stream": n_moe * SERVE_DECODE})
    for r in runs:
        check(r["finite"], "mla_serve: logits not finite")
        check(r["launches"] == want,
              f"mla_serve launches {r['launches']} != {want}")
    check(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
          "mla_serve: two runs gave different tokens")
    # run 1's first steps again from its prefill cache, each step absorbed
    # and naive from the same cache and token, the naive step's router
    # pinned to the absorbed one's (see _router); the absorbed cache goes on
    cache = runs[0].pop("cache0")
    naive_rel, naive_ms = [], []
    for i in range(MLA_NAIVE_STEPS):
        tok, pos = runs[0]["tokens"][:, i], SERVE_PROMPT + i
        before = {k: v.clone() for k, v in cache.items()}
        chosen = []
        with _router(chosen, pin=False):
            absorbed, cache = decode_step(model, cache, tok, pos,
                                          absorbed=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _router(chosen, pin=True):
            lg, _ = decode_step(model, before, tok, pos, absorbed=False)
        torch.cuda.synchronize()
        naive_ms.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(absorbed.argmax(-1), runs[0]["tokens"][:, i + 1]),
              f"mla_serve: replayed step {i} gave other tokens")
        a, b = lg.float(), absorbed.float()
        naive_rel.append(float((a - b).abs().max()
                               / a.abs().max().clamp_min(1e-6)))
        del before
    check(max(naive_rel) < MLA_NAIVE_TOL,
          f"mla_serve: naive vs absorbed decode rel {naive_rel} >= "
          f"{MLA_NAIVE_TOL}")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    check(cache_bytes == sum(
        math.prod(shape) * 2 for shape, _ in cache_spec(
            cfg, SERVE_BATCH, SERVE_MAX_LEN).shapes.values()),
        "mla_serve: the cache is not cache_spec's")
    del cache, lg, absorbed
    _profile_serve(model, prompts, absorbed=True, last_only=True,
                   named=("flash_fwd_wgmma", "moe_gemm"))
    del prompts
    torch.cuda.empty_cache()

    ffn = model.blocks[-1].ffn
    E, d, f = mo.n_experts, cfg.d_model, mo.d_expert
    for key, c, variant, iters in (
            ("moe_gemm", capacity(SERVE_BATCH * SERVE_PROMPT), "wgmma", 3),
            ("moe_gemm_decode", capacity(SERVE_BATCH), "stream", 10)):
        x = torch.randn((E, c, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        rows[key] = _moe_chunked_case(
            "serve_dsv3_prefill" if key == "moe_gemm" else
            "serve_dsv3_decode", x,
            ffn["wg"], ffn["wu"], ffn["wd"], variant, iters)
        del x

    del ffn
    # the kernel path against the plain path: bf16 on (b)'s dense and MoE
    # layer, router pinned; then one dense layer in f32
    parity = {}
    pre = moe_route(torch.bfloat16, capacity(PARITY_BATCH * PARITY_PROMPT),
                    cfg.d_model, mo.d_expert)
    moe_want = {pre: 1}
    moe_want["stream"] = moe_want.get("stream", 0) + PARITY_DECODE
    cases = (("bfloat16", 5e-2, _lm_want({"wgmma": 2}, moe_want)),
             ("float32", 1e-3, _lm_want({"simt": 1}, {})))
    for dtype, tol, want in cases:
        if dtype == "bfloat16":     # (b)'s weights, shared
            pm = TransformerLM(
                dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
                    mo, first_k_dense=1)), model.embed,
                [model.blocks[0], model.blocks[-1]], model.final_norm,
                model.lm_head, model.mtp)
        else:
            del pm, model
            torch.cuda.empty_cache()
            gen.manual_seed(1)
            pm = init_lm_params(gen, dataclasses.replace(
                cfg, n_layers=1, dtype="float32", mtp_depth=0,
                moe=dataclasses.replace(mo, first_k_dense=1)), device=dev)
        tokens = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT
                                              + PARITY_DECODE),
                               generator=gen, device=dev)
        prompt, feed = tokens[:, :PARITY_PROMPT], tokens[:, PARITY_PROMPT:]
        chosen = [] if dtype == "bfloat16" else None
        plain = _parity_run(pm, prompt, feed, True, chosen, absorbed=True)
        kern = _parity_run(pm, prompt, feed, False, chosen, pin=True,
                           absorbed=True)
        check(kern[3] == want, f"mla_parity {dtype} kernel path launches "
                               f"{kern[3]} != {want}")
        check(plain[3] == _lm_want({}, {}),
              f"mla_parity {dtype} plain path launched kernels: {plain[3]}")
        rel = _parity_rel(kern, plain)
        for key, val in rel.items():
            check(val <= tol, f"mla_parity {dtype} {key}: kernel vs plain "
                              f"rel {val} > {tol}")
        parity[dtype] = dict(
            layers="dense + MoE, router pinned to the plain path"
            if dtype == "bfloat16" else "one dense layer",
            rel_err=rel, tol=tol, kernel_launches=kern[3])
        del plain, kern
    del pm
    torch.cuda.empty_cache()

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    L, B, S_max = cfg.n_layers, SERVE_BATCH, SERVE_MAX_LEN
    emit(phase="mla_serve", arch=MLA_ARCH, n_layers=L, dtype=cfg.dtype,
         n_params=n_params, weight_bytes=weight_bytes, init_s=init_s,
         serve=[dict(batch=B, prompt=SERVE_PROMPT, max_len=S_max,
                     decode_steps=SERVE_DECODE, decode="absorbed",
                     prefill_s=r["prefill_s"],
                     prefill_tokens_per_s=B * SERVE_PROMPT / r["prefill_s"],
                     decode_ms_p50=pct(r["step_ms"], 50),
                     decode_ms_p90=pct(r["step_ms"], 90),
                     decode_ms_first=r["step_ms"][0], peak_bytes=r["peak"],
                     launches=r["launches"], finite=r["finite"])
                for r in runs],
         tokens_equal=True,
         naive=dict(steps=MLA_NAIVE_STEPS, rel_vs_absorbed=naive_rel,
                    tol=MLA_NAIVE_TOL, step_ms=naive_ms),
         cache_bytes=dict(mla=cache_bytes,
                          gqa_equivalent=L * B * S_max * H * (D + Dv) * 2),
         parity=parity,
         cuts={"n_layers": "61 -> 4: the 3 dense layers and 1 MoE layer "
                           "(671 B parameters do not fit one 80 GB card)"})
    return dict(rows=rows, launches=runs[0]["launches"])

# --------------------------------------------------------------------------- #
# phase 20: DeepSeek-V3 training (MLA, the MTP loss)
# --------------------------------------------------------------------------- #
def _moe_bwd_chunked_case(name, E, C, d, f, gen, iters=3):
    """moe_gemm's backward kernel in bf16 at DeepSeek-V3's expert widths,
    on seeded weights of the init's scale: two launches bit-identical; its
    da, db and h held to TRAIN_TOL of the plain version's largest
    magnitude, MOE_CHUNK experts at a time (the plain version's float32
    copies of all 256 experts' weights would take 45 GB); timed beside
    the bound, the plain version over the same chunks and three ``bmm``."""
    import torch
    from repro_torch.kernels.moe_gemm import kernel as moe_kernel
    from repro_torch.kernels.moe_gemm import ops as moe
    from repro_torch.kernels.moe_gemm.ref import moe_bwd_hidden_ref
    dev, dt, tol = torch.device(DEVICE), torch.bfloat16, TRAIN_TOL["bfloat16"]

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dt).mul_(scale)

    x, dy = randn((E, C, d)), randn((E, C, d))
    wg, wu = randn((E, d, f), E ** -0.5), randn((E, d, f), E ** -0.5)
    wd = randn((E, f, d), E ** -0.5)
    row = dict(kernel="moe_gemm_bwd", shape=name, dtype="bfloat16", E=E,
               C=C, d=d, f=f, tol=tol)
    hid = [torch.empty((E, C, f), dtype=dt, device=dev) for _ in range(3)]
    again = [torch.empty_like(t) for t in hid]
    row["variant"] = moe.route_bwd(dt, d, f, [
        t.data_ptr() for t in (x, wg, wu, wd, dy, *hid, *again)])
    check(row["variant"] == "wgmma",
          f"moe_gemm_bwd {name} routes to {row['variant']}, not wgmma")
    for out in (hid, again):
        moe_kernel.moe_gemm_bwd_cuda(x, wg, wu, wd, dy, *out, row["variant"])
    torch.cuda.synchronize()
    row["bit_stable"] = all(torch.equal(a, b) for a, b in zip(hid, again))
    check(row["bit_stable"], f"moe_gemm_bwd {name}: two launches differ")
    del again
    chunks = [slice(e, e + MOE_CHUNK) for e in range(0, E, MOE_CHUNK)]
    names = ("da", "db", "h")
    err, top = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for sl in chunks:
        want = moe_bwd_hidden_ref(x[sl], wg[sl], wu[sl], wd[sl], dy[sl])
        for n, g, w in zip(names, hid, want):
            err[n] = max(err[n], float((g[sl].float() - w.float()).abs()
                                       .max()))
            top[n] = max(top[n], float(w.float().abs().max()))
        del want
    row["ratio"] = {n: err[n] / max(tol * top[n], 1e-30) for n in names}
    row["max_abs_err"] = max(err.values())
    for n, r in row["ratio"].items():
        check(r <= 1, f"moe_gemm_bwd {name} {n}: |kernel - plain| / "
                      f"max|plain| is {r * tol} > {tol}")
    row["kernel_ms"] = cuda_ms(lambda: moe_kernel.moe_gemm_bwd_cuda(
        x, wg, wu, wd, dy, *hid, row["variant"]), warmup=1, iters=iters)
    row["plain_ms"] = cuda_ms(lambda: [moe_bwd_hidden_ref(
        x[sl], wg[sl], wu[sl], wd[sl], dy[sl]) for sl in chunks], warmup=0,
        iters=1)
    row["library_ms"] = cuda_ms(lambda: (
        torch.bmm(x, wg), torch.bmm(x, wu), torch.bmm(dy, wd.transpose(1, 2))),
        warmup=1, iters=iters)
    row["bound_ms"], row["bound_by"] = _bound(
        2 * (2 * E * C * d + 3 * E * d * f + 3 * E * C * f),
        6 * E * C * d * f, "bfloat16")
    row["library_covers"] = "x wg, x wu, dy wd^T (three bmm)"
    row["plain_covers"] = f"{len(chunks)} chunks of {MOE_CHUNK} experts"
    emit(phase="mla_train_kernels", **row)
    del x, dy, wg, wu, wd, hid
    torch.cuda.empty_cache()
    return row


def phase_mla_train():
    """The train_dsv3 cell: DeepSeek-V3 at its published widths in bf16,
    cut to its MLA_TRAIN_LAYERS dense layers plus the MTP head.  (a) The
    backward kernels at D != Dv against ``flash_attention_bwd_ref``
    (``_flash_bwd_case``): the reduced config's (24, 16) in f32 and bf16
    ("simt"), (192, 128) in f32 ("simt") and, ragged with GQA, in bf16
    ("wgmma"), then the cell's shape in bf16 ("wgmma", timed); moe_gemm's
    backward at DeepSeek's expert widths (``_moe_bwd_chunked_case``; the
    cell has no MoE layer).  (b) The kernel path against the plain path
    (``_plain_kernels``) for one step's loss and every gradient, MTP
    included: f32 with one dense layer and the MTP head at 1e-3, bf16
    with the cell's layers at 5e-2, PARITY_BATCH x MLA_TRAIN_PARITY_SEQ
    tokens.  (c) MLA_TRAIN_STEPS ``Trainer`` steps of MLA_TRAIN_BATCH x
    TRAIN_SEQ tokens, train_4k's optimizer settings at a peak learning
    rate of MLA_TRAIN_LR, twice from the same
    seed and data, no checkpoint (one would be 51.5 GB): the losses
    bit-equal, the loss falls, launches read around run 2; then one step
    under ``torch.profiler``.  Returns the timed rows and run 2's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import Prefetcher, lm_token_stream
    from repro_torch.models import init_lm_params, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig, deterministic
    dev = torch.device(DEVICE)
    full = get_config(MLA_ARCH).model
    m, mo = full.mla, full.moe
    H, D, Dv = full.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim, \
        m.v_head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    t_phase = time.perf_counter()

    def flash_case(*a, **k):
        return _flash_bwd_case("mla_train_kernels", gen, *a, **k)

    rows = {}
    for dtype in ("float32", "bfloat16"):
        flash_case("mla_reduced_24_16", 2, 512, 512, 4, 4, 24, dtype, Dv=16)
    flash_case("mla_192_128_f32", 1, 1024, 1024, 16, 16, D, "float32", Dv=Dv)
    flash_case("mla_192_128_ragged_gqa", 1, 300, 300, 4, 2, D, "bfloat16",
               Dv=Dv)
    rows["flash_attn_bwd"] = flash_case(
        "train_dsv3", MLA_TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, H, D,
        "bfloat16", timed=True, Dv=Dv)
    C = max(int(MLA_TRAIN_BATCH * TRAIN_SEQ * mo.top_k / mo.n_experts
                * mo.capacity_factor), 1)
    rows["moe_gemm_bwd"] = _moe_bwd_chunked_case(
        "train_dsv3_experts", mo.n_experts, C, full.d_model, mo.d_expert, gen)

    # (b) the kernel path against the plain path
    parity = {}
    for dtype, L, tol in (("float32", 1, 1e-3),
                          ("bfloat16", MLA_TRAIN_LAYERS, 5e-2)):
        cfg = dataclasses.replace(full, dtype=dtype, n_layers=L)
        gen.manual_seed(21)
        model = init_lm_params(gen, cfg, device=dev).requires_grad_(True)
        tokens, labels = (torch.randint(0, cfg.vocab, (
            PARITY_BATCH, MLA_TRAIN_PARITY_SEQ), generator=gen, device=dev)
            for _ in range(2))
        params = dict(model.named_parameters())

        def run(plain):
            with _plain_kernels(plain), deterministic():
                _zero_train_launches()
                loss = lm_loss(model, tokens, labels)
                grads = torch.autograd.grad(loss, list(params.values()))
                torch.cuda.synchronize()
                return loss.detach(), grads, _train_launches()

        lp, gp, launches_plain = run(True)
        lk, gk, launches = run(False)
        want = _train_want(1, L, "simt" if dtype == "float32" else "wgmma",
                           n_moe=0, mtp=True)
        check(launches == want, f"mla_train_parity {dtype} kernel path "
                                f"launches {launches} != {want}")
        check(all(not n for n in launches_plain.values()),
              f"mla_train_parity {dtype} plain path launched kernels: "
              f"{launches_plain}")
        rel = {"loss": _rel(lk, lp)}
        rel.update({n: _rel(a, b) for n, a, b in zip(params, gk, gp)})
        check(any(n.startswith("mtp.") for n in rel),
              "mla_train_parity: no MTP gradient")
        for key, val in rel.items():
            check(val <= tol, f"mla_train_parity {dtype} {key}: kernel vs "
                              f"plain rel {val} > {tol}")
        worst = max(rel, key=rel.get)
        parity[dtype] = dict(
            n_layers=L, mtp=True, tol=tol, n_grads=len(gk),
            loss={"kernel": float(lk), "plain": float(lp)},
            rel_err_loss=rel["loss"],
            rel_err_grad_max={"param": worst, "rel": rel[worst]},
            rel_err=rel, kernel_launches=launches)
        del model, params, gp, gk
        torch.cuda.empty_cache()
    emit(phase="mla_train_parity", arch=MLA_ARCH, batch=PARITY_BATCH,
         seq=MLA_TRAIN_PARITY_SEQ, parity=parity)

    # (c) the cell, twice from the same seed and data
    cfg = dataclasses.replace(full, n_layers=MLA_TRAIN_LAYERS)

    def loss_fn(mdl, b):
        return lm_loss(mdl, torch.as_tensor(b["tokens"], device=dev),
                       torch.as_tensor(b["labels"], device=dev))

    def run_cell():
        g = torch.Generator(device=dev)
        g.manual_seed(22)
        model = init_lm_params(g, cfg, device=dev)
        tr = Trainer(loss_fn, model,
                     AdamWConfig(lr=MLA_TRAIN_LR, warmup_steps=5,
                                 total_steps=MLA_TRAIN_STEPS),
                     TrainerConfig(ckpt_dir=os.path.join(
                         ROOT, "build", "chip_smoke_ckpt", "dsv3"),
                         ckpt_every=1 << 30, log_every=MLA_TRAIN_STEPS))
        data = Prefetcher(lm_token_stream(cfg.vocab, MLA_TRAIN_BATCH,
                                          TRAIN_SEQ, seed=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_train_launches()
        t0 = time.perf_counter()
        hist = [tr.train_step(next(data)) for _ in range(MLA_TRAIN_STEPS)]
        torch.cuda.synchronize()
        return dict(model=model, tr=tr, hist=hist,
                    wall_s=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated(),
                    launches=_train_launches())

    r1 = run_cell()
    losses1 = [h["loss"] for h in r1["hist"]]
    n_params = sum(p.numel() for p in r1["model"].parameters())
    del r1["model"], r1["tr"]
    gc.collect()
    torch.cuda.empty_cache()
    r2 = run_cell()
    losses2 = [h["loss"] for h in r2["hist"]]
    check(all(math.isfinite(v) for v in losses2), "mla_train: a loss is not "
                                                  "finite")
    check(losses1 == losses2, f"mla_train: two runs differ: {losses1} vs "
                              f"{losses2}")
    check(losses2[-1] < losses2[0], f"mla_train: the loss did not fall: "
                                    f"{losses2}")
    want = _train_want(MLA_TRAIN_STEPS, MLA_TRAIN_LAYERS, "wgmma", n_moe=0,
                       mtp=True)
    check(r2["launches"] == want,
          f"mla_train run 2 launches {r2['launches']} != {want}")
    check(r2["peak"] < 80e9, f"mla_train peak {r2['peak']} bytes")
    batch = next(iter(lm_token_stream(cfg.vocab, MLA_TRAIN_BATCH, TRAIN_SEQ,
                                      seed=2, n_steps=1)))
    profile_split = _profile_train_step(r2["tr"], batch)
    r2["tr"].finish()
    secs = [h["secs"] for h in r2["hist"]]

    def pct(p):
        return float(np.percentile(np.asarray(secs) * 1e3, p))

    emit(phase="mla_train", arch=MLA_ARCH, n_layers=MLA_TRAIN_LAYERS,
         mtp_depth=cfg.mtp_depth, dtype=cfg.dtype, n_params=n_params,
         batch=MLA_TRAIN_BATCH, seq=TRAIN_SEQ, steps=MLA_TRAIN_STEPS,
         lr=MLA_TRAIN_LR,
         losses=losses2, runs_bit_equal=True,
         step_ms_p50=pct(50), step_ms_p90=pct(90), step_ms_first=secs[0] * 1e3,
         tokens_per_s=MLA_TRAIN_BATCH * TRAIN_SEQ / (pct(50) / 1e3),
         wall_s={"run1": r1["wall_s"], "run2": r2["wall_s"]},
         peak_bytes={"run1": r1["peak"], "run2": r2["peak"]},
         launches=r2["launches"], profile_step=profile_split,
         cuts={"n_layers": "61 -> 3 (its 3 dense layers) plus the MTP head: "
                           "4.29 B parameters, 51.5 GB of bf16 weights and "
                           "gradients and f32 moments (one MoE layer's "
                           "routed experts alone hold 11.27 B)",
               "train_4k": "global batch 256 -> 2 (8,192 tokens a step)"},
         phase_s=time.perf_counter() - t_phase)
    launches = r2["launches"]
    del r2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches)


# --------------------------------------------------------------------------- #
# phase 21: DIN serving and training
# --------------------------------------------------------------------------- #
_DIN_STEP_SPLIT = (  # (part, kernel-name substrings), matched in this order
    ("sum_bwd", ("segment_sum_bwd",)),
    ("sum", ("segment_sum_kernel",)),
    # the table gathers, and index_copy_'s deterministic index_put_
    ("index_ops", ("index", "Index", "gather")),
    # torch.unique, segment_plan's sorts and index_put_'s
    ("sorts", ("Sort", "sort", "unique", "Unique")),
    ("cat", ("CatArray",)),
    ("gemm_library", ("gemm", "xmma", "nvjet", "cutlass")))


def _din_cells() -> dict:
    """The batch sizes of the port's ``RECSYS_SHAPES`` cells."""
    from repro_torch.configs import RECSYS_SHAPES
    return {s.name: s.dims for s in RECSYS_SHAPES}


def _din_batch(cfg, batch: int, seed: int):
    """The first batch of ``din_batch_stream`` at ``cfg``'s table sizes,
    on the card."""
    import torch
    from repro_torch.data import din_batch_stream
    from repro_torch.models import DINBatch
    d = next(din_batch_stream(cfg.n_items, cfg.n_cates, cfg.n_user_feats,
                              batch, cfg.seq_len, seed=seed))
    return DINBatch.from_arrays(d, torch.device(DEVICE))


def _din_kernel_checks(full, cells: dict, gen) -> dict:
    """segment_spmm at DIN's shapes against its plain versions on the
    card.  "sum" at serve_bulk's user bag (``bag_plan``; B x n_uf rows of
    D = embed_dim, a row of 36 bytes in bf16, so the kernel's one-value
    lanes): f32 elementwise at GNN_TOL against the plain version, bf16
    (the path's dtype, out bf16) within its row's Σ|msg| in float64
    (``_sum_ratio``).  "sum_bwd" of that bag bit-exact.  The table
    gradient of train_batch's history (B x T item ids into the item
    table) through ``TableGather``'s own steps: ``torch.unique``, the
    plan of the inverse, "sum" into the touched rows, in f32 and bf16,
    held like the bag; the whole ``TableGather`` backward twice and
    bit-identical, its touched rows equal to the sums and the others 0.
    Each timed beside its byte bound, its plain version and a library
    call.  Returns the timed bf16 rows."""
    import torch
    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.models import TableGather
    dev = torch.device(DEVICE)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    D = full.embed_dim
    rows = {}

    # the user bag at serve_bulk: rows gathered from the user table
    B, n_uf = cells["serve_bulk"]["batch"], DIN_N_UF
    plan = ops.bag_plan(B, n_uf, dev)
    table32 = torch.randn((full.n_user_feats, D), generator=gen,
                          device=dev) * 0.01
    ids = torch.randint(0, full.n_user_feats, (B * n_uf,), generator=gen,
                        device=dev, dtype=torch.int32)
    for dtype, dt in dts.items():
        table = table32.to(dt)
        msgs = table.index_select(0, ids)
        got = ops.segment_spmm(msgs, plan.dst, B, plan, out_dtype=dt)
        again = ops.segment_spmm(msgs, plan.dst, B, plan, out_dtype=dt)
        want = ops.segment_spmm_plain(msgs, plan.dst, B, plan, out_dtype=dt)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"din bag sum {dtype}: two calls "
                                       f"differ")
        if dtype == "float32":
            ok, err, ratio, _ = _compare(got, want, GNN_TOL)
            gate = "elementwise against plain"
        else:
            s, a = _f64_sums(msgs, plan.dst, B)
            ratio = _sum_ratio(got, s, a, out_bf16=True)
            ok, err = ratio <= 1, float((got.double() - s).abs().max())
            gate = "row sum of |msg|, float64"
            del s, a
        check(ok, f"din bag sum {dtype}: ratio {ratio} over its gate")
        row = dict(kernel="segment_spmm", variant="sum", shape="din_user_bag",
                   E=B * n_uf, n=B, D=D, dtype=dtype, out_dtype=dtype,
                   max_abs_err=err, ratio=ratio, tol=GNN_TOL, check=gate,
                   kernel_ms=cuda_ms(lambda: ops.segment_spmm(
                       msgs, plan.dst, B, plan, out_dtype=dt)),
                   plain_ms=cuda_ms(lambda: ops.segment_spmm_plain(
                       msgs, plan.dst, B, plan, out_dtype=dt), iters=5),
                   library="msgs.view(B, n_uf, D).sum(1)",
                   library_ms=cuda_ms(
                       lambda: msgs.view(B, n_uf, D).sum(1)),
                   # the whole bag, gather and sum, beside one library call
                   path_ms=cuda_ms(lambda: ops.segment_spmm(
                       table.index_select(0, ids), plan.dst, B, plan,
                       out_dtype=dt)),
                   plain_path_ms=cuda_ms(lambda: ops.segment_spmm_plain(
                       table.index_select(0, ids), plan.dst, B, plan,
                       out_dtype=dt), iters=5),
                   path_library="F.embedding_bag(mode='sum')",
                   path_library_ms=cuda_ms(lambda: torch.nn.functional
                                           .embedding_bag(
                                               ids.view(B, n_uf), table,
                                               mode="sum")))
        row["bound_ms"], row["bound_by"] = _spmm_bound_ms(
            B * n_uf, B, D, msgs.element_size(), got.element_size())
        # gather + sum: the ids and the gathered rows read once, the bags
        # written once
        row["path_bound_ms"], _ = _bound(
            4 * B * n_uf + B * n_uf * D * msgs.element_size()
            + B * D * got.element_size(), B * n_uf * D, "float32")
        emit(phase="din_kernels", **row)
        rows["sum_bag", dtype] = row

        # its backward: "sum_bwd", a gather of the bags' gradients
        dout = torch.randn((B, D), generator=gen, device=dev).to(dt)
        got = ops.segment_spmm_bwd(dout, plan.dst, B, plan, dt)
        again = ops.segment_spmm_bwd(dout, plan.dst, B, plan, dt)
        want = ops.segment_spmm_bwd_plain(dout, plan.dst, dt)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, again),
              f"din bag sum_bwd {dtype}: differs from its plain version or "
              f"between two calls")
        row = dict(kernel="segment_spmm", variant="sum_bwd",
                   shape="din_user_bag", E=B * n_uf, n=B, D=D, dtype=dtype,
                   dout_dtype=dtype, max_abs_err=0.0, check="bit-exact",
                   kernel_ms=cuda_ms(lambda: ops.segment_spmm_bwd(
                       dout, plan.dst, B, plan, dt)),
                   plain_ms=cuda_ms(lambda: ops.segment_spmm_bwd_plain(
                       dout, plan.dst, dt)),
                   library="dout.repeat_interleave(n_uf, 0)",
                   library_ms=cuda_ms(lambda: dout.repeat_interleave(
                       n_uf, 0, output_size=B * n_uf)))
        row["bound_ms"], row["bound_by"] = _sum_bwd_bound_ms(
            B * n_uf, B, D, got.element_size(), dout.element_size())
        emit(phase="din_kernels", **row)
        rows["sum_bwd_bag", dtype] = row
        del table, msgs, got, again, want, dout
    del table32, ids

    # the item table's gradient at train_batch: its history's ids
    batch = _din_batch(full, cells["train_batch"]["batch"], seed=1)
    ids = batch.hist_items.reshape(-1)
    del batch
    E, V = ids.numel(), full.n_items
    for dtype, dt in dts.items():
        d_rows = (torch.randn((E, D), generator=gen, device=dev) * 1e-3
                  ).to(dt)
        uniq, inverse = torch.unique(ids, return_inverse=True)
        n = uniq.numel()
        plan = ops.segment_plan(inverse, n)
        got = ops.segment_spmm(d_rows, inverse, n, plan, out_dtype=dt)
        want = ops.segment_spmm_plain(d_rows, inverse, n, plan,
                                      out_dtype=dt)
        s, a = _f64_sums(d_rows, inverse, n)
        torch.cuda.synchronize()
        ratio = _sum_ratio(got, s, a, out_bf16=dtype == "bfloat16")
        plain_ratio = _sum_ratio(want, s, a, out_bf16=dtype == "bfloat16")
        err = float((got.double() - s).abs().max())
        check(ratio <= 1, f"din table gradient {dtype}: error over its row "
                          f"bound {ratio}")
        del s, a, want
        # TableGather's whole backward, twice: the same bits, the touched
        # rows the sums above, every other row 0
        table = torch.zeros((V, D), dtype=dt, device=dev, requires_grad=True)

        def table_grad():
            out = TableGather.apply(table, ids)
            return torch.autograd.grad(out, table, d_rows)[0]

        g1, g2 = table_grad(), table_grad()
        torch.cuda.synchronize()
        check(torch.equal(g1, g2), f"din table gradient {dtype}: two "
                                   f"backwards differ")
        touched = g1.index_select(0, uniq.long())
        check(torch.equal(touched, got)
              and int((g1 != 0).any(1).sum()) == int((got != 0).any(1).sum()),
              f"din table gradient {dtype}: the gradient is not the sums "
              f"at the touched rows and 0 elsewhere")
        del g1, g2, touched
        row = dict(kernel="segment_spmm", variant="sum",
                   shape="din_item_table_grad", E=E, n=n, V=V, D=D,
                   dtype=dtype, out_dtype=dtype, max_abs_err=err,
                   row_ratio=ratio, plain_row_ratio=plain_ratio, tol=GNN_TOL,
                   check="row sum of |msg|, float64; TableGather twice "
                         "bit-identical",
                   kernel_ms=cuda_ms(lambda: ops.segment_spmm(
                       d_rows, inverse, n, plan, out_dtype=dt)),
                   plain_ms=cuda_ms(lambda: ops.segment_spmm_plain(
                       d_rows, inverse, n, plan, out_dtype=dt), iters=5),
                   library="index_add_ into (n_unique, D)",
                   library_ms=cuda_ms(lambda: torch.zeros(
                       (n, D), dtype=dt, device=dev).index_add_(
                       0, inverse, d_rows), iters=5),
                   # the whole table gradient: TableGather's backward
                   # (unique, plan, "sum", index_copy_ into zeros) beside
                   # autograd's index_select backward (index_add_)
                   grad_ms=cuda_ms(table_grad, iters=3),
                   grad_library="index_add_ into (V, D)",
                   grad_library_ms=cuda_ms(lambda: torch.zeros(
                       (V, D), dtype=dt, device=dev).index_add_(
                       0, ids, d_rows), iters=3))
        row["bound_ms"], row["bound_by"] = _spmm_bound_ms(
            E, n, D, d_rows.element_size(), got.element_size())
        # the gradient: ids and row gradients read once, (V, D) written
        row["grad_bound_ms"], _ = _bound(
            4 * E + E * D * d_rows.element_size()
            + V * D * d_rows.element_size(), E * D, "float32")
        emit(phase="din_kernels", **row)
        rows["table_grad", dtype] = row
        del d_rows, uniq, inverse, plan, got, table
        torch.cuda.empty_cache()
    return rows


def _din_parity(full, cells: dict) -> None:
    """One training step's loss, the logits and every parameter's
    gradient at serve_p99's batch, the kernel path against the plain path
    (``_plain_kernels``), at the published table sizes in f32 and bf16;
    the kernel path's launches by variant."""
    import torch
    from repro_torch.models import DINModel, din_logits, init_din
    from repro_torch.runtime import deterministic
    dev = torch.device(DEVICE)
    B = cells["serve_p99"]["batch"]
    batch = _din_batch(full, B, seed=2)
    parity = {}
    for dtype, tol in (("float32", GNN_PARITY_TOL), ("bfloat16", 5e-2)):
        cfg = dataclasses.replace(full, dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(22)
        model = DINModel(cfg, init_din(gen, cfg, dev)).requires_grad_(True)
        params = dict(model.named_parameters())

        def run(plain):
            with _plain_kernels(plain), deterministic():
                _zero_gnn_train_launches()
                loss = model.loss(batch)
                grads = torch.autograd.grad(loss, list(params.values()))
                with torch.no_grad():
                    logits = din_logits(model.params, cfg, batch)
                torch.cuda.synchronize()
                return loss.detach(), logits, grads, _gnn_train_launches()

        lp, yp, gp, launches_plain = run(True)
        lk, yk, gk, launches = run(False)
        # the loss's bag, its three table gradients and the bag's backward;
        # the logits' bag
        want = dict(DIN_STEP_LAUNCHES, sum=DIN_STEP_LAUNCHES["sum"] + 1)
        check(launches == want, f"din_parity {dtype} kernel path launches "
                                f"{launches} != {want}")
        check(not any(launches_plain.values()),
              f"din_parity {dtype} plain path launched kernels: "
              f"{launches_plain}")
        rel = {"loss": _rel(lk, lp), "logits": _rel(yk, yp)}
        rel.update({n: _rel(a, b) for n, a, b in zip(params, gk, gp)})
        for key, val in rel.items():
            check(val <= tol, f"din_parity {dtype} {key}: kernel vs plain "
                              f"rel {val} > {tol}")
        check(torch.isfinite(yk).all() and yk.shape == (B,),
              f"din_parity {dtype}: logits not finite or not ({B},)")
        worst = max(rel, key=rel.get)
        parity[dtype] = dict(tol=tol, n_grads=len(gk),
                             loss={"kernel": float(lk), "plain": float(lp)},
                             rel_err_grad_max={"param": worst,
                                               "rel": rel[worst]},
                             rel_err=rel, kernel_launches=launches)
        del model, params, gp, gk
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="din_parity", batch=B, parity=parity)


def _din_serve(full, cells: dict, gen) -> dict:
    """The serving cells on the bf16 model: serve_p99 (DIN_SERVE_CALLS
    calls over DIN_SERVE_BATCHES batches, each call's click probabilities
    to the host's view, ms p50/p99), serve_bulk (ms, rows/s; its first
    rows held against the plain path on those rows alone at 5e-2) and
    retrieval_cand (one user against the cell's candidates plus the top
    10, ms); the peak memory of each.  Returns the launches of the
    serve_p99 calls."""
    import torch
    from repro_torch.models import (DINBatch, DINModel, din_logits, init_din,
                                    retrieval_scores)
    dev = torch.device(DEVICE)
    model = DINModel(full, init_din(gen, full, dev))
    params = model.params
    model_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    out = {}

    def serve(batch):
        with torch.no_grad():
            return torch.sigmoid(din_logits(params, full, batch))

    # serve_p99
    B = cells["serve_p99"]["batch"]
    batches = [_din_batch(full, B, seed=100 + i)
               for i in range(DIN_SERVE_BATCHES)]
    for b in batches:
        serve(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_gnn_train_launches()
    ms = []
    for i in range(DIN_SERVE_CALLS):
        t0 = time.perf_counter()
        p = serve(batches[i % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(p.shape == (B,), f"serve_p99: output {tuple(p.shape)}")
    p99_launches = _gnn_train_launches()
    check(p99_launches == dict(DIN_STEP_LAUNCHES, sum=DIN_SERVE_CALLS,
                               sum_bwd=0),
          f"serve_p99 launches {p99_launches}: one bag sum a call")
    check(bool(torch.isfinite(p).all()), "serve_p99: a score not finite")
    out["serve_p99"] = dict(batch=B, calls=DIN_SERVE_CALLS,
                            ms_p50=float(np.percentile(ms, 50)),
                            ms_p99=float(np.percentile(ms, 99)),
                            ms_first=ms[0], rows_per_s=B / (
                                np.percentile(ms, 50) / 1e3),
                            peak_bytes=torch.cuda.max_memory_allocated(),
                            launches=p99_launches)
    del batches

    # serve_bulk
    B = cells["serve_bulk"]["batch"]
    bulk = _din_batch(full, B, seed=200)
    serve(bulk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(DIN_BULK_CALLS):
        t0 = time.perf_counter()
        p = serve(bulk)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    head = DINBatch(**{f: t[:512] for f, t in vars(bulk).items()})
    with _plain_kernels(True):
        want = serve(head)
    rel = _rel(p[:512], want)
    check(p.shape == (B,) and bool(torch.isfinite(p).all()) and rel <= 5e-2,
          f"serve_bulk: shape {tuple(p.shape)}, its first rows rel {rel} "
          f"against the plain path on them alone")
    out["serve_bulk"] = dict(batch=B, calls=DIN_BULK_CALLS,
                             ms_p50=float(np.median(ms)), ms_runs=ms,
                             rows_per_s=B / (np.median(ms) / 1e3),
                             peak_bytes=peak, head_rel_vs_plain=rel)
    del bulk, head, p, want

    # retrieval_cand: one user of a serve_p99 batch
    dims = cells["retrieval_cand"]
    user = DINBatch(**{f: t[:dims["batch"]] for f, t in
                       vars(_din_batch(full, 512, seed=300)).items()})
    N = dims["n_candidates"]
    cand = torch.randint(0, full.n_items, (N,), generator=gen, device=dev)

    def retrieve():
        with torch.no_grad():
            sc = retrieval_scores(params, full, user, cand,
                                  cand % full.n_cates)
            return sc, torch.topk(sc[0].float(), 10)

    sc, top = retrieve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(DIN_RETRIEVAL_CALLS):
        t0 = time.perf_counter()
        sc, top = retrieve()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    check(sc.shape == (dims["batch"], N) and bool(torch.isfinite(sc).all())
          and torch.equal(top.values, sc[0].float().sort(
              descending=True).values[:10]),
          "retrieval_cand: scores not finite or the top 10 wrong")
    out["retrieval_cand"] = dict(batch=dims["batch"], n_candidates=N,
                                 calls=DIN_RETRIEVAL_CALLS,
                                 ms_p50=float(np.median(ms)), ms_runs=ms,
                                 peak_bytes=torch.cuda.max_memory_allocated())
    emit(phase="din_serve", dtype=full.dtype, model_bytes=model_bytes, **out)
    del model, params, user, cand, sc
    gc.collect()
    torch.cuda.empty_cache()
    return p99_launches


def _din_train(full, cells: dict) -> dict:
    """The train_batch cell: bf16 weights, f32 AdamW moments, the
    example's optimizer settings; DIN_TRAIN_STEPS ``Trainer`` steps of
    train_batch rows from ``din_batch_stream``, twice from one seed: the
    losses bit-equal and falling, launches read around run 2 (per step:
    DIN_STEP_LAUNCHES), step ms p50/p90, rows/s, peak memory; then one
    step under ``torch.profiler`` split by kernel.  Returns run 2's
    launches."""
    import torch
    from repro_torch.data import Prefetcher, din_batch_stream
    from repro_torch.models import DINBatch, DINModel, init_din
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    dev = torch.device(DEVICE)
    B = cells["train_batch"]["batch"]

    def run_cell():
        g = torch.Generator(device=dev)
        g.manual_seed(23)
        model = DINModel(full, init_din(g, full, dev))
        tr = Trainer(lambda m, b: m.loss(b), model,
                     AdamWConfig(**DIN_TRAIN_OPT),
                     TrainerConfig(ckpt_dir=os.path.join(
                         ROOT, "build", "chip_smoke_ckpt", "din"),
                         ckpt_every=1 << 30, log_every=DIN_TRAIN_STEPS))
        data = Prefetcher(DINBatch.from_arrays(d, dev)
                          for d in din_batch_stream(
                              full.n_items, full.n_cates, full.n_user_feats,
                              B, full.seq_len, seed=1,
                              n_steps=DIN_TRAIN_STEPS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_gnn_train_launches()
        t0 = time.perf_counter()
        hist = [tr.train_step(b) for b in data]
        torch.cuda.synchronize()
        return dict(model=model, tr=tr, hist=hist,
                    wall_s=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated(),
                    launches=_gnn_train_launches())

    r1 = run_cell()
    losses1 = [h["loss"] for h in r1["hist"]]
    n_params = sum(p.numel() for p in r1["model"].parameters())
    del r1["model"], r1["tr"]
    gc.collect()
    torch.cuda.empty_cache()
    r2 = run_cell()
    losses2 = [h["loss"] for h in r2["hist"]]
    check(len(losses2) == DIN_TRAIN_STEPS
          and all(math.isfinite(v) for v in losses2),
          f"din_train: {len(losses2)} steps, a loss not finite")
    check(losses1 == losses2, f"din_train: two runs differ: {losses1} vs "
                              f"{losses2}")
    check(losses2[-1] < losses2[0], f"din_train: the loss did not fall: "
                                    f"{losses2}")
    want = {k: n * DIN_TRAIN_STEPS for k, n in DIN_STEP_LAUNCHES.items()}
    check(r2["launches"] == want,
          f"din_train run 2 launches {r2['launches']} != {want}")
    profile_split = _profile_train_step(
        r2["tr"], _din_batch(full, B, seed=2), parts=_DIN_STEP_SPLIT)
    r2["tr"].finish()
    secs = np.asarray([h["secs"] for h in r2["hist"]]) * 1e3

    emit(phase="din_train", dtype=full.dtype, n_params=n_params, batch=B,
         steps=DIN_TRAIN_STEPS, opt=DIN_TRAIN_OPT, losses=losses2,
         runs_bit_equal=True, step_ms_p50=float(np.percentile(secs, 50)),
         step_ms_p90=float(np.percentile(secs, 90)),
         step_ms_first=float(secs[0]),
         rows_per_s=B / (float(np.percentile(secs, 50)) / 1e3),
         wall_s={"run1": r1["wall_s"], "run2": r2["wall_s"]},
         peak_bytes={"run1": r1["peak"], "run2": r2["peak"]},
         launches=r2["launches"],
         launches_per_step={k: n / DIN_TRAIN_STEPS
                            for k, n in r2["launches"].items()},
         profile_step=profile_split)
    launches = r2["launches"]
    del r2
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_din():
    """DIN serving and training: the published config (``configs/din.py``:
    tables of 50 M items, 1 M categories and 8 M user features, embed_dim
    18, history 100) in bf16 with seeded weights made on the card, at
    ``RECSYS_SHAPES``' batch sizes, nothing cut.  (a) segment_spmm at
    DIN's shapes (``_din_kernel_checks``); (b) the kernel path against
    the plain path (``_din_parity``); (c) the serving cells
    (``_din_serve``); (d) the training cell (``_din_train``).  Returns
    the timed rows and the launches of serve_p99 and training run 2."""
    import torch
    from repro_torch.configs import get_config
    full = get_config("din").model
    cells = _din_cells()
    gen = torch.Generator(device=torch.device(DEVICE))
    gen.manual_seed(21)
    t_phase = time.perf_counter()
    rows = _din_kernel_checks(full, cells, gen)
    _din_parity(full, cells)
    serve_launches = _din_serve(full, cells, gen)
    train_launches = _din_train(full, cells)
    emit(phase="din", phase_s=time.perf_counter() - t_phase)
    return dict(rows=rows, serve_launches=serve_launches,
                train_launches=train_launches)


# --------------------------------------------------------------------------- #
# phase 22: stage executables
# --------------------------------------------------------------------------- #
def _rads_counts() -> dict:
    """The RADS kernels' launch counts: membership, intersect and the
    varint codec by variant."""
    from repro_torch.kernels.intersect import ops as inter
    from repro_torch.kernels.membership import ops as memb
    from repro_torch.kernels.varint import ops as varint
    return {"membership": memb.launches, "intersect": inter.launches,
            **{f"varint.{v}": n
               for v, n in varint.launches_by_variant.items()}}


def _eager_runner_cache(pg, pat, cfg, mode: str = "sim") -> dict:
    """A ``runner_cache`` holding, under the driver's key for this call,
    a :class:`StageRunner` built as the driver builds it but with
    ``eager=True``: the card's eager path, to hold the graphs against."""
    import torch
    from repro_torch.core.cache import build_cache
    from repro_torch.core.engine import build_plan_data
    from repro_torch.core.exchange import Exchange
    from repro_torch.core.plan import best_plan
    from repro_torch.core.scheduler import StageRunner
    from repro_torch.graph.storage import device_graph
    exch = Exchange(mode, wire_format=cfg.wire_format)
    g = device_graph(pg, cfg.storage_format, DEVICE)
    runner = StageRunner(g, build_plan_data(best_plan(pat, cfg.plan_rho)),
                         cfg, exch, cache=build_cache(cfg, g), eager=True)
    key = (mode, id(pg), pat, cfg, None, str(torch.device(DEVICE)))
    return {key: (pg, None, runner)}


def _eager_run(pg, pat, cfg, rc: dict, **kw):
    """``rads_enumerate`` through the eager runner of ``rc``; fails if
    the driver built another runner (its key moved) or captured."""
    from repro_torch.core import rads_enumerate
    res = rads_enumerate(pg, pat, cfg, runner_cache=rc, device=DEVICE, **kw)
    check(len(rc) == 1, "the eager runner was not used: the driver's "
                        "runner key differs from _eager_runner_cache's")
    check(res.stats["compiles"] == 0 and not res.stats["exec_cache_enabled"],
          "the eager runner captured")
    return res


def _same_run(got, want, what: str, skip=()) -> None:
    """Count, embeddings and every non-timing stat equal."""
    check(got.count == want.count,
          f"{what}: count {got.count} != {want.count}")
    check(got.embeddings == want.embeddings, f"{what}: embeddings differ")
    for key in (set(got.stats) | set(want.stats)) - TIMING_KEYS - set(skip):
        check(got.stats.get(key) == want.stats.get(key),
              f"{what}: stat {key} differs between the graphed and the "
              f"eager run: {got.stats.get(key)!r} vs "
              f"{want.stats.get(key)!r}")


def _exec_child(store: str, build_dir: str, timeout: float = 300.0) -> dict:
    """This script in a fresh process (``--exec-store-child``): the
    small graph's q1 through a fresh runner with ``compile_cache_dir =
    store`` and the kernel build directory ``build_dir``, dense/raw
    first (its first call timed) then bucketed/varint."""
    spec = json.dumps(dict(store=store, build_dir=build_dir))
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--exec-store-child", spec],
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    check(p.returncode == 0 and lines,
          f"exec store child failed (rc {p.returncode}): "
          f"{p.stdout[-2000:]}{p.stderr[-4000:]}")
    return json.loads(lines[-1])


def exec_store_child(spec: str) -> None:
    """The child of :func:`_exec_child`: prints one JSON line."""
    import torch
    from pathlib import Path
    from repro_torch.configs.rads import QUERIES, EngineConfig
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.core.plan import best_plan
    from repro_torch.graph import erdos_graph, partition
    from repro_torch.kernels import build
    spec = json.loads(spec)
    build.BUILD_DIR = Path(spec["build_dir"])
    built = []
    real_build = build.build

    def counting_build(sources):
        took = real_build(sources)
        built.extend(s.name for s in took)
        return took
    build.build = counting_build
    t0 = time.perf_counter()
    g = erdos_graph(120, 5.0, seed=5)
    t1 = time.perf_counter()
    pg = partition(g, 8, method="bfs")
    t2 = time.perf_counter()
    pat = Pattern.from_edges(QUERIES["q1"])
    best_plan(pat, 1.0)
    host = dict(graph_s=t1 - t0, partition_s=t2 - t1,
                plan_s=time.perf_counter() - t2)
    runs = {}
    for name, kw in EXEC_CONFIGS.items():
        if name == "cache_off":
            continue
        rc: dict = {}
        cfg = EngineConfig(**SMALL_CAPS, compile_cache_dir=spec["store"],
                           **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rads_enumerate(pg, pat, cfg, runner_cache=rc, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runner = next(iter(rc.values()))[-1]
        st = res.stats
        runs[name] = dict(
            first_call_s=wall, count=res.count,
            embeddings=sorted(res.embeddings), compiles=st["compiles"],
            compile_s=st["compile_s"],
            compile_cache_hits=st["compile_cache_hits"],
            exec_cache=st["exec_cache"],
            exec_cache_enabled=st["exec_cache_enabled"],
            stages=len(runner._slots),
            entries=runner.exec_cache.entries(),
            stats={k: v for k, v in st.items()
                   if k not in TIMING_KEYS})
    print(json.dumps(dict(runs=runs, host=host, nvcc_built=built,
                          libraries=sorted(p.name for p in
                                           build.BUILD_DIR.glob("*.so"))),
                     default=str), flush=True)


def phase_exec(full=None):
    """Phase 22 (module docstring).  ``full``: phase 5's graphed dense/raw
    run of the full cell, ``(g, pg, expect, stats, run)``, held against
    an eager run of the same cell."""
    import tempfile
    import warnings
    import torch
    from repro_torch.configs.rads import QUERIES, EngineConfig
    from repro_torch.core import Pattern, rads_enumerate
    from repro_torch.graph import erdos_graph, partition
    from repro_torch.runtime.compile_cache import StageExecCache
    t_phase = time.perf_counter()
    pg = partition(erdos_graph(120, 5.0, seed=5), 8, method="bfs")
    # (a) q1-q8 in three configurations, graphed against eager
    small = {}
    for name, kw in EXEC_CONFIGS.items():
        captures, compile_s, wall = 0, 0.0, {"graphed": 0.0, "eager": 0.0}
        for q, edges in QUERIES.items():
            pat = Pattern.from_edges(edges)
            cfg = EngineConfig(**SMALL_CAPS, **kw)
            t0 = time.perf_counter()
            got = rads_enumerate(pg, pat, cfg, device=DEVICE)
            wall["graphed"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = _eager_run(pg, pat, cfg, _eager_runner_cache(pg, pat, cfg))
            wall["eager"] += time.perf_counter() - t0
            _same_run(got, want, f"exec {q} {name}")
            check(got.stats["compiles"] > 0, f"exec {q} {name}: no capture")
            captures += got.stats["compiles"]
            compile_s += got.stats["compile_s"]
        small[name] = dict(captures=captures, compile_s=compile_s,
                           wall_s=wall)
    # the gather exchange, dense/raw
    for q in ("q1", "q3", "q6"):
        pat = Pattern.from_edges(QUERIES[q])
        cfg = EngineConfig(**SMALL_CAPS)
        got = rads_enumerate(pg, pat, cfg, mode="gather", device=DEVICE)
        check(got.stats["compiles"] > 0, f"exec {q} gather: no capture")
        _same_run(got, _eager_run(pg, pat, cfg, _eager_runner_cache(
            pg, pat, cfg, "gather"), mode="gather"), f"exec {q} gather")
    # (b) q1 twice through runner_cache, graphed and eager: the second
    # graphed call captures nothing and launches what the eager one does
    pat = Pattern.from_edges(QUERIES["q1"])
    cfg = EngineConfig(**SMALL_CAPS)
    g_rc, e_rc = {}, _eager_runner_cache(pg, pat, cfg)
    calls = []
    for _ in range(2):
        before = _rads_counts()
        t0 = time.perf_counter()
        got = rads_enumerate(pg, pat, cfg, runner_cache=g_rc, device=DEVICE)
        t1 = time.perf_counter()
        mid = _rads_counts()
        want = _eager_run(pg, pat, cfg, e_rc)
        t2 = time.perf_counter()
        after = _rads_counts()
        _same_run(got, want, f"exec q1 call {len(calls) + 1}")
        calls.append(dict(
            wall_s=dict(graphed=t1 - t0, eager=t2 - t1),
            compiles=got.stats["compiles"], compile_s=got.stats["compile_s"],
            launches_graphed={k: mid[k] - before[k] for k in mid},
            launches_eager={k: after[k] - mid[k] for k in mid}))
    check(calls[1]["compiles"] == 0 and calls[1]["compile_s"] == 0.0,
          f"second call through runner_cache captured: {calls[1]}")
    check(calls[1]["launches_graphed"] == calls[1]["launches_eager"],
          f"the second call's replays credit other launches than the "
          f"eager run's: {calls[1]}")
    # (c) pipeline_depth="auto" (its depth steers from wall time) and (d)
    # a run that escalates its capacities
    cfg = EngineConfig(**SMALL_CAPS, pipeline_depth="auto")
    got = rads_enumerate(pg, pat, cfg, device=DEVICE)
    _same_run(got, _eager_run(pg, pat, cfg, _eager_runner_cache(pg, pat,
                                                                 cfg)),
              "exec q1 auto depth", skip=("auto_depth", "max_inflight_waves"))
    pat6 = Pattern.from_edges(QUERIES["q6"])
    cfg = EngineConfig(**ESCALATE_CAPS)
    esc = rads_enumerate(pg, pat6, cfg, device=DEVICE)
    _same_run(esc, _eager_run(pg, pat6, cfg,
                              _eager_runner_cache(pg, pat6, cfg)),
              "exec q6 escalating")
    check(esc.stats["cap_escalations"] > 0, "exec q6: no escalation")
    # (e) the store: a cold process (empty kernel directory, empty store)
    # fills it; a warm one (another empty kernel directory) must capture
    # nothing, hit every stage and build nothing; a corrupted entry warns
    # and is captured afresh
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        store = os.path.join(tmp, "store")
        cold = _exec_child(store, os.path.join(tmp, "kernels_cold"))
        warm = _exec_child(store, os.path.join(tmp, "kernels_warm"))
        check(cold["nvcc_built"], "the cold process built no kernel")
        check(not warm["nvcc_built"],
              f"the warm process ran nvcc: {warm['nvcc_built']}")
        check(warm["libraries"] == cold["libraries"],
              f"the store restored {warm['libraries']}, the cold process "
              f"built {cold['libraries']}")
        for name, w in warm["runs"].items():
            c = cold["runs"][name]
            # stages of one call that another already stored (finalize
            # reads no graph, so both formats share it) hit in the cold
            # process too
            check(c["compiles"] > 0 and c["compiles"]
                  + c["compile_cache_hits"] == c["stages"],
                  f"cold {name}: {c['compiles']} captures and "
                  f"{c['compile_cache_hits']} hits for {c['stages']} "
                  f"stages")
            check(w["compiles"] == 0 and w["exec_cache_enabled"]
                  and w["compile_cache_hits"] == w["stages"],
                  f"warm {name}: compiles {w['compiles']}, hits "
                  f"{w['compile_cache_hits']} for {w['stages']} stages")
            check((w["count"], w["embeddings"], w["stats"])
                  == (c["count"], c["embeddings"], c["stats"]),
                  f"warm {name}: results differ from the cold process's")
        entry = cold["runs"]["dense/raw"]["entries"][0]
        with open(os.path.join(store, entry + ".stagex"), "wb") as f:
            f.write(b"not an envelope")
        StageExecCache.clear_memory_memo()
        cfg = EngineConfig(**SMALL_CAPS, compile_cache_dir=store)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bad = rads_enumerate(pg, pat, cfg, device=DEVICE)
        check(any("unusable entry" in str(w.message) for w in caught),
              "a corrupted entry gave no warning")
        check(bad.stats["compiles"] == 1
              and bad.stats["exec_cache"]["errors"] == 1,
              f"a corrupted entry: compiles {bad.stats['compiles']}, "
              f"store {bad.stats['exec_cache']}")
        _same_run(bad, rads_enumerate(pg, pat, EngineConfig(**SMALL_CAPS),
                                      device=DEVICE), "exec corrupted entry")
    first_call = {}
    for kind, child in (("cold", cold), ("warm", warm)):
        first_call[kind] = dict(host=child["host"],
                                nvcc_built=child["nvcc_built"])
        for name, r in child["runs"].items():
            first_call[kind][name] = {k: r[k] for k in (
                "first_call_s", "compiles", "compile_s",
                "compile_cache_hits", "stages")}
    row = dict(phase="exec", graph="erdos_graph(120, 5.0, seed=5) bfs/8",
               small=small, runner_cache_calls=calls,
               escalations=esc.stats["cap_escalations"],
               escalation_captures=esc.stats["compiles"],
               first_call=first_call)
    # (f) the full cell: phase 5's graphed run against an eager run
    if full is not None:
        g, fpg, expect, dense, graphed = full
        from repro_torch.configs.rads import DEFAULT_ENGINE
        qpat = Pattern.from_edges(QUERIES["q1"])
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eager = _eager_run(fpg, qpat, DEFAULT_ENGINE, _eager_runner_cache(
            fpg, qpat, DEFAULT_ENGINE), return_embeddings=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(eager.count == expect, f"eager full q1 count {eager.count}")
        for key in set(dense) - TIMING_KEYS:
            check(dense[key] == eager.stats[key],
                  f"full q1 stat {key}: graphed {dense[key]!r} != eager "
                  f"{eager.stats[key]!r}")
        warm = graphed.get("warm") or {}
        row["full"] = dict(
            graphed=dict(wall_s=graphed["wall_s"], peak=graphed["peak"],
                         captures=dense["compiles"],
                         compile_s=dense["compile_s"]),
            graphed_warm_profiled=dict(
                wall_ms=warm.get("wall_ms"), busy_ms=warm.get("busy_ms"),
                idle_share=warm.get("idle_share")),
            eager=dict(wall_s=wall, peak=torch.cuda.max_memory_allocated()))
    row["phase_s"] = time.perf_counter() - t_phase
    emit(**row)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-n", type=int, default=SMOKE_N,
                    help=f"vertices of the full-scale graph (published: "
                         f"{FULL_N})")
    ap.add_argument("--skip-full", action="store_true",
                    help="stop after the small-graph phase, printing no "
                         "result (a short check of the build and kernels)")
    ap.add_argument("--lm-train-only", action="store_true",
                    help="run the device and build phases, then only the LM "
                         "training phases (12-14), printing no result")
    ap.add_argument("--gnn-train-only", action="store_true",
                    help="run the device and build phases, then only the "
                         "GNN training phases (15-17), printing no result")
    ap.add_argument("--dist-only", action="store_true",
                    help="run the device and build phases, then only the "
                         "dist and mesh-plan phases (18, 23), printing no "
                         "result")
    ap.add_argument("--mla-only", action="store_true",
                    help="run the device and build phases, then only the "
                         "DeepSeek-V3 serving phase (19), printing no "
                         "result")
    ap.add_argument("--mla-train-only", action="store_true",
                    help="run the device and build phases, then only the "
                         "DeepSeek-V3 training phase (20), printing no "
                         "result")
    ap.add_argument("--din-only", action="store_true",
                    help="run the device and build phases, then only the "
                         "DIN phase (21), printing no result")
    ap.add_argument("--exec-only", action="store_true",
                    help="run the device and build phases, then only the "
                         "stage-executable phase (22) without its full "
                         "cell, printing no result")
    ap.add_argument("--exec-store-child", metavar="SPEC",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-n", type=int, default=DIST_N,
                    help=f"vertices of the dist phase's graph (published: "
                         f"{FULL_N})")
    args = ap.parse_args()
    # growable segments instead of fixed blocks: the escalated stages
    # allocate and free tensors of several GB, which fragments fixed blocks
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, src)
    if args.exec_store_child:
        exec_store_child(args.exec_store_child)
        return
    from repro_torch.configs.rads import DEFAULT_ENGINE
    from repro_torch.graph import partition, powerlaw_graph

    smi_line = phase_device()
    phase_build()
    if args.lm_train_only:
        phase_lm_train_kernels()
        phase_lm_train_parity()
        phase_lm_train()
        return
    if args.gnn_train_only:
        products = products_graph()
        phase_gnn_train_kernels(products)
        phase_gnn_train_parity()
        phase_gnn_train(products)
        return
    if args.dist_only:
        phase_mesh_plan(phase_dist(args.dist_n))
        return
    if args.mla_only:
        phase_mla_serve()
        return
    if args.mla_train_only:
        phase_mla_train()
        return
    if args.din_only:
        phase_din()
        return
    if args.exec_only:
        phase_exec()
        return
    # the full-scale graph: its shapes and degrees drive the kernel timings
    t0 = time.perf_counter()
    g = powerlaw_graph(args.full_n, 6, seed=1)
    pg = partition(g, 8, method="bfs")
    setup_s = time.perf_counter() - t0
    if args.full_n == SMOKE_N:
        check(g.max_degree == SMOKE_MAX_DEGREE,
              f"max degree {g.max_degree} != {SMOKE_MAX_DEGREE}")
    timing = phase_kernels(engine_shapes(g.max_degree), g.degrees)
    inter = phase_intersect(g.degrees, pg.n, g.max_degree)
    # the default fetch cap, and the cap after the run's three escalations
    fcaps = (DEFAULT_ENGINE.fetch_cap, DEFAULT_ENGINE.fetch_cap << 3)
    phase_delta_vlen(pg.n, fcaps)
    codec = phase_varint_codec(g.degrees, pg.n, fcaps[-1], g.max_degree)
    phase_small()
    if args.skip_full:
        return
    t0 = time.perf_counter()
    expect = _triangles(g)
    setup_s += time.perf_counter() - t0
    # phase 3's device ms per row: the back-edge filter on its own inputs,
    # verifyE, and intersect on padded windows
    per_row_ms = {kind: r["kernel_ms"] / r["B"] for kind, r in (
        ("backedge", timing["backedge_engine"]), ("verify", timing["verify"]),
        ("intersect", inter["backedge_padded"]))}
    main_launches, dense, dense_run = phase_full(
        g, pg, expect, setup_s, "dense", "raw", per_row_ms, profile=True)
    new_launches, coded, _ = phase_full(g, pg, expect, setup_s, "bucketed",
                                        "varint", per_row_ms)
    for key in ("bytes_fetch", "bytes_verify", "bytes_saved_cache"):
        check(coded[key] == dense[key],
              f"full-scale {key}: bucketed/varint {coded[key]} != "
              f"dense/raw {dense[key]}")
    check(coded["bytes_wire_verify"] < coded["bytes_verify"],
          "varint verifyE bytes are not below the raw accounting")
    emit(phase="full_compare", peak_adj_bytes={
        "dense": dense["peak_adj_bytes"],
        "bucketed": coded["peak_adj_bytes"]},
        bytes_wire_verify={"raw": dense["bytes_wire_verify"],
                           "varint": coded["bytes_wire_verify"]},
        bytes_wire_fetch={"raw": dense["bytes_wire_fetch"],
                          "varint": coded["bytes_wire_fetch"]})
    # the stage executables: graphs against the eager path on the small
    # graph, the store across processes, and the full cell eager
    phase_exec((g, pg, expect, dense, dense_run))

    # the LM serving path: its own kernels, each launch count read around
    # the serving run (a); the graph stays on the host for phase 18
    del pg
    torch.cuda.empty_cache()
    lm_rows = phase_lm_kernels()
    phase_lm_parity()
    lm_launches = phase_lm_serve()

    # the GNN forward: the products-sized graph is built once, on the host,
    # outside every timed forward
    t0 = time.perf_counter()
    products = products_graph()
    n_products = _gnn_dims("ogb_products")["n_nodes"]
    emit(phase="gnn_graph", build_s=time.perf_counter() - t0,
         n_nodes=n_products, edge_slots=len(products["edge_dst"]))
    gnn_rows = phase_gnn_kernels(
        torch.as_tensor(products["edge_src"], device=DEVICE),
        torch.as_tensor(products["edge_dst"], device=DEVICE), n_products)
    torch.cuda.empty_cache()
    phase_gnn_parity()
    gnn_launches = phase_gnn_serve(products)
    del products

    # LM training: the backward kernels, then the training path, each
    # launch count read around the uninterrupted run of the cell
    torch.cuda.empty_cache()
    train_rows = phase_lm_train_kernels()
    phase_lm_train_parity()
    train_launches = phase_lm_train()

    # GNN training: the backward kernels, then the training path, each
    # launch count read around its run of the cell (the products graph
    # is built again, on the host, in about 3 s)
    products = products_graph()
    gnn_train_rows = phase_gnn_train_kernels(products)
    phase_gnn_train_parity()
    gat_train_launches, graphcast_train_launches = phase_gnn_train(products)
    del products

    # the dist exchange: two ranks sharing the card, on phase 5's graph
    torch.cuda.empty_cache()
    if args.dist_n == args.full_n:
        psum = phase_dist(args.dist_n, g, expect)
    else:
        psum = phase_dist(args.dist_n)
    # the mesh plan (device-free) and compressed_psum of phase 18's ranks
    phase_mesh_plan(psum)

    # DeepSeek-V3 serving: MLA's (192, 128) flash_attn and moe_gemm at
    # DeepSeek's widths, each launch count read around run (b)
    torch.cuda.empty_cache()
    mla = phase_mla_serve()

    # DeepSeek-V3 training: the backward kernels at (192, 128), each launch
    # count read around the cell's second run
    torch.cuda.empty_cache()
    mla_train = phase_mla_train()

    # DIN: the bag's and the tables' segment sums, launches read around
    # serve_p99's calls and the training cell's second run
    torch.cuda.empty_cache()
    din = phase_din()

    # membership on the back-edge filter's own inputs, against the bound
    # of what those inputs need
    t = dict(timing["backedge_engine"],
             bound_ms=timing["backedge_engine"]["bound_data_ms"],
             bound_by="bytes")
    ti = inter["backedge_padded"]
    rows = [
        ("membership", "src/repro_torch/kernels/membership/csrc/membership.cu",
         "src/repro/kernels/membership/kernel.py:40",
         main_launches["membership"], t),
        ("intersect", "src/repro_torch/kernels/intersect/csrc/intersect.cu",
         "src/repro/kernels/intersect/kernel.py:38",
         new_launches["intersect"], ti),
        # the varint fetch codec, the redesign of delta_vlen_pallas, at
        # the full cell's top capacity with what q1 feeds it: no valid row
        *((f"varint_{v}",
           f"src/repro_torch/kernels/varint/csrc/varint_{v.split('_')[0]}.cu",
           "src/repro/kernels/varint/kernel.py:67",
           new_launches[f"varint.{v}"], codec[v]["none"])
          for v in ("encode_ids", "encode_rows", "decode_rows")),
        ("flash_attn", "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "src/repro/kernels/flash_attn/kernel.py:62",
         lm_launches["flash_attn"], lm_rows["flash_attn", "bfloat16"]),
        ("moe_gemm", "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
         "src/repro/kernels/moe_gemm/kernel.py:44",
         lm_launches["moe_gemm"], lm_rows["moe_gemm", "bfloat16"]),
        # DeepSeek-V3 serving: MLA's prefill attention through the (192,
        # 128) "wgmma" instantiation, and the experts at DeepSeek's widths
        ("flash_attn_mla_d192_dv128",
         "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "src/repro/kernels/flash_attn/kernel.py:62",
         mla["launches"]["flash_attn"], mla["rows"]["flash_attn"]),
        ("moe_gemm_dsv3", "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
         "src/repro/kernels/moe_gemm/kernel.py:44",
         mla["launches"]["moe_gemm"], mla["rows"]["moe_gemm"]),
        ("segment_spmm",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35", gnn_launches["sum"],
         gnn_rows["graphcast_cora_d512_bf16"]),
        ("segment_spmm_gat",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35", gnn_launches["gat"],
         gnn_rows["gat_products_l1"]),
        # the backward kernels: no TPU kernel has a backward, so each names
        # the TPU kernel whose gradient it computes
        *((f"flash_attn_bwd_{k}",
           "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu",
           "src/repro/kernels/flash_attn/kernel.py:62",
           train_launches["flash_attn_bwd"][k],
           _bwd_row(train_rows["flash_attn_bwd", "bfloat16"], k))
          for k in ("delta", "dkdv", "dq")),
        # DeepSeek-V3 training: MLA's backward through the (192, 128)
        # instantiations
        *((f"flash_attn_bwd_{k}_mla_d192_dv128",
           "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu",
           "src/repro/kernels/flash_attn/kernel.py:62",
           mla_train["launches"]["flash_attn_bwd"][k],
           _bwd_row(mla_train["rows"]["flash_attn_bwd"], k))
          for k in ("delta", "dkdv", "dq")),
        ("moe_gemm_bwd", "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm_bwd.cu",
         "src/repro/kernels/moe_gemm/kernel.py:44",
         sum(train_launches["moe_gemm_bwd"].values()),
         train_rows["moe_gemm_bwd", "bfloat16"]),
        ("segment_spmm_sum_bwd",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm_bwd.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35",
         graphcast_train_launches["sum_bwd"],
         gnn_train_rows["sum_bwd_graphcast_cora_d512_bf16"]),
        ("segment_spmm_gat_bwd",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm_bwd.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35",
         gat_train_launches["gat_bwd"],
         gnn_train_rows["gat_bwd_products_l1"]),
        # DIN: the user bag's sum (serve_p99's launches), the training
        # step's sums (the bag and the three tables' gradients; timed at
        # the item table's) and the bag's backward, all bf16
        ("segment_spmm_din_bag",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35",
         din["serve_launches"]["sum"], din["rows"]["sum_bag", "bfloat16"]),
        ("segment_spmm_din_table_grad",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35",
         din["train_launches"]["sum"], din["rows"]["table_grad", "bfloat16"]),
        ("segment_spmm_sum_bwd_din_bag",
         "src/repro_torch/kernels/segment_spmm/csrc/segment_spmm_bwd.cu",
         "src/repro/kernels/segment_spmm/kernel.py:35",
         din["train_launches"]["sum_bwd"],
         din["rows"]["sum_bwd_bag", "bfloat16"])]
    emit(kernels=[dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"])
        for name, source, replaces, launches, r in rows])
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
