#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. device — require CUDA, print the card and its power limit, build
     every hand-written kernel from ``src/repro_torch/kernels/csrc``;
  2. kernel vs plain — the Tree-LSTM megastep kernel (K1,
     ``treelstm_megastep_sm90.cu``) against its plain PyTorch version on
     the card, at full width (H=512, A=2, M=4096) and on edge cases (M=1;
     A=1; A=3 DAG levels with shared children; a level of leaves, a padded
     level and an all-padding level, each with the schedule's live count
     and without one; H=72; absent children at the sentinel): max-abs
     error <= 1e-4 on the written block, every other row (the sentinel
     among them) bit-unchanged, two launches bitwise equal, the CUDA
     launches of its design (the product where a slot may have a child,
     the leaf launch past the live slots, at most 2 a level); the M=4096
     level timed by ``torch.profiler`` device time;
  2b. served levels — the same check on every level the serving phase
     launches (the served traffic is scored once with a tap on the
     kernel layer that keeps each level's arguments and live count),
     each level timed by ``torch.profiler`` device time, every level in
     one session, CUDA events beside, against its plain version and its
     bound (three TF32 products at 495 TFLOP/s, the 67 TFLOP/s fp32-FMA
     figure beside it), also by kind of level (level 0, all padding,
     fewer and more than 64 live slots): these times, at the main path's
     own shapes, are the ones the JSON line reports;
  3. serving — ``StructureServeEngine`` for the paper's ``tree_lstm``
     (hidden 512, input 256, arity 2, random weights from a seed) scores
     512 SST-like requests in batches of 64: every request ends ``ok``,
     no degradation, the breaker closed, one kernel launch per padded
     level; the roots match the op-by-op path on the card and the plain
     path on the CPU to 1e-4; ``pipeline.pack`` host p50/p99 (cold packs
     that harvest their solos into the graph tier) and the harvest's;
  4. training levels — one full-width training step of the paper's
     ``tree_lstm`` (the example ``examples/torch_treelstm_sentiment.py``,
     SST-like parses of seed 0 in batches of 64, pow2 buckets with the
     backward's sorted runs), taken with taps on ``ops.level_megastep``,
     ``ops.bwd_megastep`` and ``ops.scatter_add_rows``: every forward
     level through K1 as in phase 2b (its device time a step); K1's
     ptxas lines (no spills), shared memory and SASS
     (``HMMA.1688.F32.TF32``, ``LDGSTS``, ``LDSM``, no float atomic);
     every reverse level through the reverse
     megastep kernel (K2, ``bwd_megastep_sm90.cu``) against its plain
     version on the same inputs (error relative to max |plain| <= 1e-4,
     untouched rows bit-unchanged, two launches bitwise equal, the CUDA
     launches its plan designs: none on a level with no live slot, at
     most 2 on a tree level), its live slots and CTAs, timed by
     ``torch.profiler`` device time, every level in one session (CUDA
     events beside, and for its plain version) beside its bound (three
     TF32 products at 495 TFLOP/s;
     the 67 TFLOP/s fp32-FMA figure beside it); K2's ptxas lines (no
     spills), shared memory and SASS (``HMMA.1688.F32.TF32``, no float
     atomic); the step's scatter (with the
     schedule's plan, which it must have been given) and a
     duplicate-heavy case through the scatter-add kernel (K7) against
     its plain version (1e-4) and bit for bit against the plain rendering
     of its plan's summation order, timed by ``torch.profiler`` device
     time (its add and combine kernels apart) beside ``index_add_`` and
     its bound, the plans' host build time apart; the fused leg's
     gradients (every param and the external matrix) against
     ``fusion_mode="none"`` on the card within 1e-4 relative, that leg's
     backward making one K7 launch a level and one for the pulled rows;
     two backward passes of the step bitwise equal;
  5. training — the example's loop (AdamW, warmup-cosine) for
     ``TRAIN_STEPS`` steps: finite losses, step time p50/p99, steps/s,
     peak device memory, one forward megastep launch per padded level
     (the CUDA launches its live counts design), one reverse megastep per
     level with a live slot (two CUDA launches each)
     and one scatter-add launch per step; then a
     ``torch.profiler`` breakdown of one warm step;
  6-8. the paper's Var-LSTM (``var_lstm``: 128 variable-length chains
     of ``_var_lstm_graphs``, seed 0, ``max_len=64``, ``LSTMVertex``),
     GRU chains (the same chains, ``GRUVertex``) and Tree-FC
     (``tree_fc``: 64 balanced 256-leaf trees, ``pad_arity=2``,
     ``TreeFCVertex``), each at full width (hidden 512, input 256; weights
     from ``torch.Generator`` seed 0 with a nonzero bias; seeded numpy
     normal inputs), loss ``mean(readout_roots(buf)[:, h] ** 2)``: the
     main path is ``TRAIN_CELL_STEPS`` AdamW steps through
     ``execute_lazy`` with the launch counts set to 0 just before and
     read just after (one forward megastep kernel — K3, K4 or K5 — per
     level and step, each making the CUDA launches the live counts
     design: the product where a slot has a child, the leaf launch past
     the live count, at most 2 a level; one reverse megastep of the
     matching kind per level with a live slot and step, two CUDA launches
     each, one scatter-add per step), step p50/p99 and peak memory; then,
     with the params AdamW has moved, one step taken with taps on
     ``ops.level_megastep``, ``ops.bwd_megastep`` and
     ``ops.scatter_add_rows``: every forward and reverse level and the
     pulled-row scatter re-run through its kernel (with the keywords the
     main path gave it: K3/K4/K5 the level's live count) and its plain
     version (error relative to max |plain| <= 1e-4, untouched rows
     bit-unchanged, two launches bitwise equal and the CUDA launches as
     designed, timed by ``torch.profiler`` device time, every level in
     one session, CUDA events beside, the bound the products as three
     TF32 products at 495 TFLOP/s, the fp32-FMA figure beside it, a level
     of no product by bytes; K2 and K7 as in phase 4), timed beside its
     data-aware bound, K5 also by level; the ptxas lines (no spills),
     shared memory and SASS (``HMMA.1688.F32.TF32``, ``LDGSTS``,
     ``LDSM``, no float atomic) of ``cell_megastep_sm90.cu`` (K3, K4, K5
     and K9);
     the fused gradients against ``fusion_mode="none"`` within 1e-4
     relative (T + 1 K7 launches in that backward); two backward passes
     bitwise equal; the scatter plans' build time; a ``torch.profiler``
     breakdown of one warm step;
  9. K6 vs plain — the row gather/scatter kernels against their plain
     versions on the card, bit for bit, at the serving phases' shapes, a
     bf16 gather, rows not a multiple of 4 wide, n = 1 and pad lanes
     with out-of-range ids (untouched rows bit-unchanged); K6a with the
     ids on the host (carried in the launch, one launch per
     ``GATHER_CAP``, checked at the capacity and one past it, ids
     outside the rows giving zero rows) and its rows stored also into a
     pinned host buffer, bit for bit the card's;
  10. continuous Tree-LSTM serving — the serving phase's 512 parses
     submitted at once to ``ContinuousBatchEngine`` (4,096 arena rows,
     256 lanes, ``ClassificationHead(1024, 5)``, nonzero biases): a
     tapped run checks every tick's contract (its stored rows unique and
     none read by the tick; one read of the card at the end) and re-runs
     every ``TAP_EVERY``-th tick's megastep (K1 storing each lane's row
     at its arena id: within 1e-4 of max |plain|, rows no lane names
     bit-unchanged, two launches bitwise equal, one CUDA launch; timed by
     ``torch.profiler``; ``tools/k1_parent_ab.py ... k6b`` times it beside
     the earlier commit's two launches) and every root gather against
     their plain versions and times them; the main path, launch counts
     set to 0 just before and read just after, must launch one megastep
     a tick (one CUDA launch: the frontier has no live count) and no row
     scatter, and one row gather a retiring window; every request ``ok``, no
     degradation; roots and logits within 1e-4 of solo scoring on the
     card and of the plain path on the CPU (bitwise-equal roots
     counted); requests/s, latency, occupancy; host spans and a profile;
     64 parses under one profiler session: every retiring window enqueues
     no host→device copy and one device→host copy (the head's logits; K6a
     takes the root ids by value and stores the roots into pinned host
     memory);
  11. the LSTM-chain trace of ``benchmarks/bench_serving.py --full`` at
     the paper's width, replayed in real time against
     ``StructureServeEngine(batch_size=16)`` and
     ``ContinuousBatchEngine(1024 rows, 64 lanes)``: p50/p99 latency,
     throughput and their ratios; roots within 1e-4 of solo scoring;
     ``TokenReadout`` tokens independent of the order requests run in;
     one megastep and one CUDA launch a continuous tick, no row scatter;
     a tapped run for the K3 frontier (the checks of phase 10) and K6a
     checks and times; the same chains submitted at once to the engine's
     op-by-op leg (``fusion_mode="none"``: the cell in plain ops, one K6b
     row scatter a tick, the main path of K6b), launch counts set to 0
     just before and read just after, roots within 1e-4 of the fused
     engine's, every ``TAP_EVERY``-th tick's scatter kept and re-run
     against its plain version (bit for bit) and timed for K6b's row; 64
     chains under one profiler session: a retiring window (no head)
     enqueues no copy at all;
  12. decode — ``VertexServeEngine`` (LSTM, then GRU, 128 slots) over 256
     Var-LSTM chains: one K3/K4 launch a tick, final states within 1e-4
     of ``execute`` on the card and of the plain path on the CPU,
     ticks/s; every ``TAP_EVERY``-th tick re-run (no live count, as the
     engine launches it) with the checks of phase 2 and timed at M = 128
     by ``torch.profiler`` device time, events beside; a profile;
  13. the op-by-op leg (the paper's kernel-fusion ablation and serial
     baseline) — the gate kernels K8a ``lstm_gates``, K8b
     ``treelstm_gates`` and K9 ``lstm_level_fused`` against their plain
     versions at edge and full-width shapes (strided state halves, bf16
     states, random masks; two launches bitwise equal; a backward through
     each raises); the Var-LSTM batch through ``execute(fusion_mode=
     "none")`` with ``cell_impl`` "pallas" and "fused" (one K8a / K9 a
     level, buffers within 1e-4 of the K3 buffer, bf16 within 3e-2 of the
     CPU); the serving phase's 512 parses through the unfused engine with
     the "pallas" Tree-LSTM (one K8b a padded level, roots within 1e-4 of
     the fused engine's, throughput and latency beside it); unfused decode
     with the "fused" LSTM (one K9 a tick, finals within 1e-4 of
     ``execute``); ``execute_serial`` on 8 parses beside the batched
     engine; each gate kernel re-run on its main path's own launches and
     timed by ``torch.profiler`` device time, every gate kernel in one
     session, beside its bound (K9's product as three TF32 products at
     495 TFLOP/s, the fp32-FMA figure beside it);
  15. LM serving — K10 ``flash_attention`` (bf16 with D % 16 == 0 on
     its wgmma route, ``flash_attention_sm90.cu``; f32 and every other
     bf16 head dim on its tf32 route, ``flash_attention_tf32.cu``) and
     K11
     ``decode_attention`` against their plain versions on the card (f32
     and bf16; Sq 1, 63, 65, 127 and 129, Sq != Sk without ``causal``,
     windows of 24, 50 and 100, Hq = Hkv and GQA groups 2, 4, 8 and 12,
     head dims 7/16/20/32/36/40/64/80/100/128/160/256, Sq > Sk (zero
     rows), a 2,048-token prefill, a 1,024-token one at head dim 100, ``kv_len`` 0, 1 and ragged, a 4,096-row cache, a window
     across K11's split, cache rows not 16-byte aligned: within 1e-5 of
     max |plain| at f32 and 1e-2 at bf16, the plain version computing in
     f32; two launches bitwise equal; each K10 launch on the route its
     operands choose); the wgmma kernel's registers, spills and shared
     memory, and ``HGMMA`` and ``UTMALDG`` in its SASS where
     ``cuobjdump`` is there; the tf32 kernel's registers, spills and
     shared memory by instantiation (f32 and bf16) and
     ``HMMA.1688.F32.TF32`` in its SASS; the ragged head dims' cases at
     real length timed beside SDPA and the bound; K11's registers and
     spills by instantiation
     and the split (NS, grid, tile, shared memory) at granite's shape;
     then
     granite-3-8b at full width and depth (40 layers, d_model 4,096,
     GQA 32/8, head 128, d_ff 12,800, vocab 49,155 padded to 49,408;
     bf16 weights from a CUDA ``torch.Generator`` seed 0) served by
     ``ServeEngine`` (8 slots, ``max_len`` 1,024, greedy): 16 requests
     of 16-600 prompt tokens (``default_rng(0)``) and 32 new tokens, the
     second half submitted after 4 ticks.  Launch counts set to 0 just
     before and read just after: exactly 40 K10 launches a prompt and 40
     K11 a tick; every request ``ok``; tokens/s, decode tick p50/p99,
     prefill ms a bucket, peak memory; every K10 launch on the wgmma
     route.  K10 and SDPA by ``torch.profiler`` device time on each
     bucket's first-layer launch, and on its f32 copy the tf32 route and
     SDPA at f32 beside the bound (three TF32 products at 495 TFLOP/s;
     fp32 FMAs at 67 as an extra figure).  A
     tapped re-run of the same traffic keeps every ``TAP_EVERY``-th
     K10/K11 launch (re-run against the plain version and timed by
     ``torch.profiler`` beside the bound -- bf16 at 989 TFLOP/s against
     bytes at 3.35 TB/s -- and beside
     ``scaled_dot_product_attention``) and every row of logits a token
     was drawn from: each request teacher-forced through ``trunk`` in
     "train" mode must give logits within 3e-2 of max |logit| (the bf16
     model's own noise is ~2e-2, see ``LM_LOGIT_TOL``), the same token
     wherever its top-2 margin exceeds 4e-2 of max |logit|, and logits no
     farther from an f32 recompute of the same weights than 1.25 x the
     bf16 recompute's distance from it.  K11 with all 8 slots filled to
     16, 64, 256, 632 and 1,024 rows of a 1,024-row cache (granite's
     decode shape and the engine's cache, so the main path's split;
     distinct inputs whose valid rows hold 100 MB so each launch reads
     HBM): kernel, SDPA, plain and bound by ``torch.profiler`` device
     time.  SDPA, here and on the kept launches, gets the cache's rows up
     to the longest ``kv_len``, the kernel and the plain version the
     engine's whole cache.
     Profiles of one warm decode tick and of one warm 1,024-token
     prefill; and ``reduced(granite-3-8b)`` at f32 served on the card
     (the tf32 route's path, its launches counted from 0, every one on
     that route, each re-run against the plain version at the shapes the
     path gave it) must give a full recompute's greedy tokens exactly; the
     tf32 route timed on the kept granite launches' f32 copies beside
     SDPA at f32, the plain version and the bound; the same reduced model
     at the ragged head dim 20 (every launch on the tf32 route, its last
     8-column block zero-padded) exact too, its launches re-run against
     the plain version and timed;
  16. Mamba-2 serving — K12 ``ssd_chunk_scan`` against its plain version
     on the card (f32 and bf16; chunks of 128, 100, 64, 39, 37, 8, 2 and
     1, P 16, 48, 64 and 128, N 16, 40 and 128, 1 to 32 heads, x/B/C
     strided views of one ``xBC`` tensor, two of them at a row stride no
     multiple of 16 bytes: within 1e-5 of max |plain| at f32 and bf16;
     two launches bitwise equal; ``ops.ssd`` with padding, ``D`` and an
     initial state against the CPU composition; a backward refused); its
     build report (ptxas registers and spills, shared memory, SASS); then
     mamba2-370m
     at full width and depth (48 Mamba blocks, d_model 1,024, 32 heads of
     64, state 128, chunk 128, vocab 50,280; f32 weights from a CUDA
     ``torch.Generator`` seed 0) served by ``ServeEngine(pad_prompts=
     False)`` (8 slots, ``max_len`` 1,024, greedy): the LM phase's 16
     requests and four of 1, 2, 128 and 256 prompt tokens.  Launch counts
     set to 0 just before and read just after: exactly 48 K12 launches a
     prompt, none a tick, no K10/K11; every request ``ok``; tokens/s,
     decode tick p50/p99, prefill ms by prompt length, peak memory.  A
     tapped re-run keeps every ``TAP_EVERY``-th K12 launch (re-run against
     the plain version, timed by ``torch.profiler`` beside its bound --
     three TF32 products an operation at 495 TFLOP/s, 67 TFLOP/s fp32
     beside it, against 3.35 TB/s) and every row of logits a token
     was drawn from: each request teacher-forced through ``trunk`` in
     "train" mode must give logits within 1e-4 of max |logit| and the
     same token wherever its top-2 margin exceeds 2e-4.  A profile of
     one warm decode tick; ``reduced(mamba2-370m)`` at f32 served on the
     card must give a full recompute's greedy tokens exactly;
  18. composed training — the example's default leg
     (``examples/torch_treelstm_sentiment.py``): the ``TRAIN_DATA``
     SST-like parses of seed 0 composed by ``ComposedBatchSource`` into
     batches of ``BATCH`` (pow2 buckets, labels as riders), packed on
     ``SchedulePipeline.prefetch``'s background thread two batches ahead,
     AdamW warmup-cosine, ``TRAIN_STEPS`` steps, launch counts set to 0
     just before and read just after: every batch's host schedule
     byte-identical to ``pack_batch`` of its graphs at the composer's pads
     and its ext to ``pack_external``, its labels the corpus's at its
     ``sample_ids``, no pack from epoch 2 on, finite losses equal within
     1e-6 relative to the same batches packed inline on the main thread,
     one K1 a padded level, one K2 a level with a live slot, one K7 a
     step; step p50/p99, the wait in ``next()``, hit rate, shapes and the
     composer's stats beside phase 5's FIFO step;
  19. spliced serving and a warm restart — ``StructureServeEngine`` over
     phase 3's traffic with ``persist=`` a fresh store under ``build/``:
     the requests in order (cold packs, their solos harvested), then in a
     seeded permutation (every batch spliced from the graph tier and
     byte-identical to ``pack_batch``; roots bit for bit those of the same
     batches cold-packed in a fresh pipeline), then a fresh engine on the
     same store (batch disk loads and splices from per-graph disk entries:
     ``packs`` = ``graph_packs`` = 0, the same roots bit for bit), then the
     first order again (memory hits); ``pipeline.pack`` host p50/p99 of
     each kind of lookup, the harvest's and the store's writes;
  20. the examples on the card — ``torch_quickstart.main([])``;
     ``torch_encoder_decoder`` at hidden 512, input 256, batch 64 (one K3
     launch a level, counted from 0; outputs within 1e-4 of the op-by-op
     path on the same card tensors); a two-replica ``ShardedPipeline``
     whose stacked ``pack_step`` tensors equal each replica's own pack;
  21. the trainer — ``Trainer.fit`` over phase 5's model and batches
     (``warmup_cosine(3e-3, 20, 30)``, no weight decay): a clean fit with
     checkpoints every 10 steps (keep 2) whose losses are phase 5's bit
     for bit (else the largest relative difference, held to 1e-5); a
     ``FaultInjector([15])`` fit restored from step 10 (the data replayed
     from there) ending with params and moments bit for bit the clean
     fit's, as does the clean fit without the guard and with one log (its
     step p50/p99 beside); a NaN ext skipped (one ``nonfinite_skips``,
     nothing written);
     over the clean fit, one K1 a padded level, one K2 a level with a
     live slot, one K7 a step; 8 steps of ``fit(compose=, pipeline=)``,
     riders aligned with ``sample_ids``, the packer's thread gone after;
     step p50/p99, the time an async save blocks, restore ms, checkpoint
     bytes, peak memory;
  22. LM training — K10's backward (``flash_attention_bwd.cu``: dQ a CTA
     per query tile with its rows' own row sums and Δ, then dK/dV a CTA
     per KV head's key tile over its query heads; 3xTF32 ``mma.sync``, no
     float atomics): its ptxas lines, shared memory and SASS
     (``HMMA.1688.F32.TF32``, no float atomic); (a)
     ``examples/torch_train_lm.py``'s model (8 layers, d_model 512, 8/4
     heads of 64, f32) through its ``main`` (``Trainer.fit``, the
     ``AsyncPacker`` stager) for 30 steps of 8 x 128 tokens in 2
     microbatches, launch counts set to 0 just before and read just
     after: one K10 forward (tf32 route) and one backward a layer a
     microbatch a step, losses finite and falling, the first step's loss
     within 1e-4 of the CPU's on the same weights and batch; (b)
     granite-3-8b at full width (d_model 4,096, 32/8 heads of 128, d_ff
     12,800, vocab 49,155), depth cut to 2, f32, no remat, weights from a
     CUDA generator, 3 ``Trainer.fit`` steps of 2 x 1,024 tokens (the cuts
     printed), counts from 0: 2 K10 forwards and backwards a step, finite
     losses, peak memory; (c) every backward call of (a) and of (b)'s
     first step re-run on its own inputs and the edge cases (causal and
     not, windows, Sq != Sk both ways, Hkv = Hq and GQA, head dims 7-256
     with 7, 20 and 100 ragged) against autograd of ``ref.mha``: dQ, dK
     and dV within 1e-5 of max |plain| (on a call where that f32 plain
     version is itself farther from an f64 evaluation, within 1e-5 + 2×
     its distance from it), two launches bitwise equal, the saved
     log-sum-exp against ``ref.mha_lse``, K10's output bit for bit the
     same with and without the log-sum-exp store; timed by ``torch.profiler`` at (b)'s and (a)'s shapes (its
     three launches apart) beside the plain backward, SDPA's backward at
     f32 and the bound (five products, each f32 product as three TF32
     products at 495 TFLOP/s, against 3.35 TB/s);
  23. report — one JSON line per the kernel table, then the device line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
DEVICE = "cuda"
#: Full width of the paper's tree_lstm, the kernel check's level width,
#: and the served traffic.
HIDDEN, M_FULL, N_REQUESTS, BATCH = 512, 4096, 512, 64
#: The training loop: steps, and the SST-like corpus it cycles through in
#: batches of ``BATCH`` (the example's FIFO epochs).
TRAIN_STEPS, TRAIN_DATA = 30, 512
#: AdamW steps of each of the Var-LSTM, GRU and Tree-FC phases.
TRAIN_CELL_STEPS = 10
#: Published H100 SXM peaks (NVIDIA data sheet): fp32 without tensor
#: cores, dense bf16 and TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
    fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
         f"the root of a checkout")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (turns TF32 off)
from repro_torch.configs.paper import get_paper_model  # noqa: E402
from repro_torch.core.scheduler import (execute, execute_lazy,  # noqa: E402
                                        execute_serial, readout_nodes,
                                        readout_roots)
from repro_torch.core.structure import (ScatterPlan,  # noqa: E402
                                        chain, pack_batch, pack_external,
                                        random_binary_tree, random_dag)
from repro_torch.data import lm_batches, synthetic_corpus  # noqa: E402
from repro_torch.data.trees import sst_like_dataset  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.archs import reduced  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import cell_kernels as ck  # noqa: E402
from repro_torch.kernels import decode_attention as decattn  # noqa: E402
from repro_torch.kernels import decode_split  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import gather_scatter as lmgs  # noqa: E402
from repro_torch.kernels import level_megastep as lm  # noqa: E402
from repro_torch.kernels import level_megastep_bwd as lmb  # noqa: E402
from repro_torch.kernels import level_step as ls  # noqa: E402
from repro_torch.kernels import mamba_ssd as mssd  # noqa: E402
from repro_torch.models.readout import (ClassificationHead,  # noqa: E402
                                        TokenReadout)
from repro_torch.models.rnn import GRUVertex  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.pipeline import (BucketPolicy, ScheduleCache,  # noqa: E402
                                  SchedulePipeline)
from repro_torch.obs.registry import get_registry  # noqa: E402
from repro_torch.train import MetricLogger, TrainConfig, Trainer  # noqa: E402
from repro_torch.serve import (AdmissionPolicy,  # noqa: E402
                               ContinuousBatchEngine, ContinuousRequest,
                               Request, ServeEngine, StructureRequest,
                               StructureServeEngine, VertexRequest,
                               VertexServeEngine)


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def device_phase() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: "
          "this smoke run needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"card: {smi_line}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} source(s) built in "
          f"{time.perf_counter() - t0:.1f} s: {', '.join(built) or '-'}")
    one_per_source = {src: k for k, (src, _e, _a) in _build.KERNELS.items()}
    for src, k in sorted(one_per_source.items()):
        for line in _build.build_log(k).splitlines():
            if ("ptxas info" in line and "registers" in line) \
                    or "spill stores" in line:
                print(f"  {src}: {line.strip()}")
    return {"name": name, "count": count, "smi": smi_line}


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def _weights(H: int, gen: torch.Generator, dev):
    fn = get_paper_model("tree_lstm").make_vertex(hidden=H, input_dim=8)
    p = fn.init(gen, device=dev)
    # A non-zero bias exercises every bias lane of the epilogue.
    p["b"] = torch.randn(4 * H, generator=gen).mul_(0.1).to(dev)
    return tuple(p[k] for k in ("ui", "uf", "uo", "uu", "b"))


def synthetic_level(M: int, A: int, H: int, gen: torch.Generator, dev,
                    absent: float = 0.1, masked: float = 0.05):
    """One level at offset M of a 2-level buffer: children are random
    rows of level 0 or (with prob. ``absent``) the sentinel; the last
    ``masked`` share of the slots is padding."""
    R = 2 * M + 1
    buf = torch.randn(R, 2 * H, generator=gen) * 0.5
    buf[R - 1] = 0.0                                 # zero sentinel
    cids = torch.randint(0, M, (M, A), generator=gen, dtype=torch.int32)
    miss = torch.rand(M, A, generator=gen) < absent
    cids[miss] = R - 1
    cmask = (~miss).float()
    n_live = max(1, M - int(M * masked))
    nmask = torch.zeros(M)
    nmask[:n_live] = 1.0
    cids[n_live:] = R - 1
    cmask[n_live:] = 0.0
    ext = torch.randn(M + 1, 4 * H, generator=gen) * 0.5
    ext[M] = 0.0
    eids = torch.randperm(M, generator=gen).to(torch.int32)
    eids[n_live:] = M
    return (buf.to(dev), cids.to(dev), cmask.to(dev), eids.to(dev),
            nmask.to(dev), M, ext.to(dev), _weights(H, gen, dev))


def schedule_level(graphs, t: int, H: int, gen: torch.Generator, dev,
                   **pads):
    """Level ``t`` of a real packed schedule, buffer rows filled at
    random (the sentinel stays zero), and its live count as the
    schedule's ``to_device`` gives it."""
    s = pack_batch(graphs, with_runs=False, **pads)
    d = s.to_device(dev)
    R = s.T * s.M + 1
    buf = torch.randn(R, 2 * H, generator=gen) * 0.5
    buf[R - 1] = 0.0
    ext = torch.randn(s.K * s.N + 1, 4 * H, generator=gen) * 0.5
    ext[-1] = 0.0
    return (buf.to(dev), d.child_ids[t], d.child_mask[t], d.ext_ids[t],
            d.node_mask[t], t * s.M, ext.to(dev),
            _weights(H, gen, dev)), d.live[t]


def fwd_designed(M: int, live) -> int:
    """The CUDA launches K1, K3 or K4 makes on a level of ``M`` slots
    given ``live`` (None: not given, and its product grid covers every
    slot): the product where a slot may have a child, the leaf launch
    over ``[live, M)``."""
    live = M if live is None else live
    return (live > 0) + (live < M)


#: The forward megasteps, each taking a live count: kind → (the name of
#: its row, the kernel-name prefix its launches carry on the card).
FWD_KERNELS = {"treelstm": ("K1", "k1_"), "lstm": ("K3", "cell_"),
               "gru": ("K4", "cell_"), "treefc": ("K5", "cell_")}


def compare_level(kind: str, case, **kw) -> tuple:
    """K1, K3, K4 or K5 (``kind``) on one level ``case`` with the keywords
    the main path gave it (``live``) against its plain version:
    the max abs error on the written block and that error relative to
    max |plain|; rows outside the block (the sentinel among them)
    bit-unchanged, finite values, a second launch bitwise equal, and the
    CUDA launches of its design, at most 2 (at live 0 the leaf launch
    alone)."""
    buf, cids, cmask, eids, nmask, off, ext, w = case
    M = cids.shape[0]
    op, name = f"{kind}_megastep", FWD_KERNELS[kind][0]
    before = lm.CUDA_LAUNCHES[op]
    got = lm.MEGASTEPS[kind](buf.clone(), cids, eids, nmask, off, ext, *w,
                             **kw)
    made = lm.CUDA_LAUNCHES[op] - before
    again = lm.MEGASTEPS[kind](buf.clone(), cids, eids, nmask, off, ext, *w,
                               **kw)
    want = ref.level_megastep(kind, buf.clone(), cids, cmask, eids, nmask,
                              off, ext, w)
    torch.cuda.synchronize()
    err = float((got[off:off + M] - want[off:off + M]).abs().max())
    outside = torch.ones(buf.shape[0], dtype=torch.bool, device=buf.device)
    outside[off:off + M] = False
    check(bitwise_equal(got[outside], buf[outside]),
          f"{name} changed rows outside [offset, offset+M)")
    check(bool(torch.isfinite(got).all()), f"{name} wrote non-finite values")
    check(bitwise_equal(got, again), f"{name}: two launches differ at "
          f"offset {off}")
    designed = fwd_designed(M, kw.get("live"))
    check(made == designed <= 2, f"{name} at offset {off}: {made} CUDA "
          f"launches, designed {designed}")
    return err, err / max(float(want[off:off + M].abs().max()), 1e-30)


def compare(case, **kw) -> float:
    """K1 on one level through ``compare_level``: the max abs error."""
    return compare_level("treelstm", case, **kw)[0]


def time_ms(fn, n: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def bound_ms(case) -> tuple:
    """Least time for K1's level on the card, from this level's data: the
    multiply-adds its live slots need (h_k·U_f for each child a slot has,
    and hsum·U_i/U_o/U_u for a slot with any child; a leaf needs none),
    as three TF32 products at 495 TFLOP/s (K1's products run on the
    tensor cores), against each input read once (distinct child rows, the
    ext rows of live slots -- a leaf's i, o and u lanes only --, the
    weights unless no slot needs them, the bias, the indices) and the
    block written once, at 3.35 TB/s.  Absent children point at the
    buffer's last row.  Returns (bound_ms, bound_by, flops, bytes,
    bound_fma_ms), the last at the 67 TFLOP/s fp32-FMA rate."""
    buf, cids, cmask, eids, nmask, off, ext, w = case
    M, A = cids.shape
    H = w[0].shape[0]
    live = nmask != 0
    present = (cids != buf.shape[0] - 1) & live[:, None]
    n_child = present.sum(dim=1)
    inner = n_child > 0
    flops = float((n_child + 3 * inner).sum()) * H * H * 2
    rows = torch.unique(cids[present]).numel()
    lanes = (4 * torch.unique(eids[live & inner]).numel()
             + 3 * torch.unique(eids[live & ~inner]).numel())
    weights = 4 * H * H if flops > 0 else 0
    nbytes = 4 * (rows * H * 2 + lanes * H + weights + 4 * H
                  + M * (A + 2) + M * 2 * H)
    b_ms, b_by, fma_ms = priced_ms(flops, nbytes, True)
    return b_ms, b_by, flops, nbytes, fma_ms


def fwd_times(cases, reps: int = 10, kind: str = "treelstm",
              k2_rows=()) -> list:
    """K1 (or K3-K5: ``kind``) and its plain version on each level of
    ``cases`` ((case, kw) pairs, ``kw`` as the main path gave it),
    launched in place as the main path does on a copy of the level's
    buffer (levels that share a buffer share its copy: a level reads only
    rows that no re-run changes): device ms a call by ``torch.profiler``,
    every level in one session, with the kernel's CUDA-event ms beside
    (back to back, events time the host where a launch is shorter than
    its cost).  ``k2_rows``: K2's levels (``k2_level``'s), timed in the
    same session as ``k2_device_ms`` times them (each session a run takes
    raises the odds that CUPTI drops a later one's events).  Returns
    ``(ms, plain_ms, events_ms)`` a level."""
    copies, sets, events = {}, {}, []
    for i, (case, kw) in enumerate(cases):
        buf, cids, cmask, eids, nmask, off, ext, w = case
        kb, pb = copies.setdefault(buf.data_ptr(),
                                   (buf.clone(), buf.clone()))

        def kern(kb=kb, case=case, kw=kw):
            _b, cids, _cm, eids, nmask, off, ext, w = case
            lm.MEGASTEPS[kind](kb, cids, eids, nmask, off, ext, *w, **kw)

        def plain(pb=pb, case=case):
            _b, cids, cmask, eids, nmask, off, ext, w = case
            ref.level_megastep(kind, pb, cids, cmask, eids, nmask, off, ext,
                               w)

        sets[i, "kernel"] = {"calls": [kern],
                             "match": FWD_KERNELS[kind][1], "launches":
                             fwd_designed(cids.shape[0], kw.get("live"))}
        sets[i, "plain"] = {"calls": [plain], "reps": 3}
        events.append(time_ms(kern, 10, 2))
    k2 = [r for r in k2_rows if r["live"]]
    sets.update({("k2", i): k2_set(r) for i, r in enumerate(k2)})
    t = device_ms(sets, reps=reps)
    for i, r in enumerate(k2):
        r["ms"] = t["k2", i]
    return [(t[i, "kernel"], t[i, "plain"], events[i])
            for i in range(len(cases))]


def kernel_phase() -> dict:
    dev = DEVICE
    gen = torch.Generator().manual_seed(1234)
    rng = np.random.default_rng(1234)
    H = HIDDEN
    errs = {}
    full = synthetic_level(M_FULL, 2, H, gen, dev)
    errs[f"H{H}_A2_M{M_FULL}"] = compare(full)
    errs["M1"] = compare(synthetic_level(1, 2, H, gen, dev, absent=0.0,
                                         masked=0.0))
    errs["A1_M64"] = compare(synthetic_level(64, 1, H, gen, dev))
    dags = [random_dag(int(rng.integers(6, 30)), rng, max_arity=3)
            for _ in range(24)]
    T = pack_batch(dags, with_runs=False).T
    for t in (1, T // 2, T - 1):
        case, live = schedule_level(dags, t, H, gen, dev)
        errs[f"dag_A3_level{t}"] = compare(case, live=live)
    trees = [random_binary_tree(int(rng.integers(2, 40)), rng)
             for _ in range(16)]
    pads = {"pad_levels": 64, "pad_width": 512}
    for t, label in ((0, "leaves"), (3, "padded"), (40, "all_padding")):
        case, live = schedule_level(trees, t, H, gen, dev, **pads)
        errs[f"tree_{label}_level{t}"] = compare(case, live=live)
        # Without the live count the product's grid covers every slot,
        # and its tiles of no child take the leaf formula on the card.
        errs[f"tree_{label}_level{t}_no_live_count"] = compare(case)
    errs["H72_ragged"] = compare(synthetic_level(100, 2, 72, gen, dev))
    for k, v in errs.items():
        print(f"kernel vs plain: {k}: max_abs_err {v:.3e}")
    worst = max(errs.values())
    check(worst <= TOL, f"kernel disagrees with its plain version: "
          f"max_abs_err {worst:.3e} > {TOL}")

    (ms, plain_ms, ev), = fwd_times([(full, {})], reps=20)
    b_ms, b_by, flops, nbytes, fma_ms = bound_ms(full)
    print(f"timing synthetic H{H}_A2_M{M_FULL} (not a served shape): kernel "
          f"{ms:.4f} ms device ({ev:.4f} events), plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms by {b_by} (fp32 FMA {fma_ms:.4f}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); kernel at "
          f"{flops / ms / 1e9:.2f} TFLOP/s = {b_ms / ms:.1%} of bound")
    return {"max_abs_err": worst, "synthetic": {
        "ms": ms, "events_ms": ev, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "bound_fma_ms": fma_ms}}


def tapped_levels(run) -> list:
    """``run()`` with a tap on ``ops.level_megastep`` that keeps each
    level's arguments and keywords; returns them as ``(case, kw)`` pairs,
    ``case`` = (buf, child_ids, child_mask, ext_ids, node_mask, offset,
    ext, weights).  The buffer kept is the one the run finished with: a
    level reads only rows below its offset (final by then) and the zero
    sentinel, so a level re-run on a copy of it sees what the run saw."""
    levels, inner = [], ops.level_megastep

    def tap(kind, buf, *args, **kw):
        levels.append(((buf,) + args, kw))
        return inner(kind, buf, *args, **kw)

    ops.level_megastep = tap
    try:
        run()
    finally:
        ops.level_megastep = inner
    return levels


def served_level_cases() -> list:
    """Every level the serving phase launches, with its own inputs and
    keywords: the served traffic scored once through ``tapped_levels``."""
    fn, params, ds = served_traffic()

    def run():
        eng = StructureServeEngine(fn, params, batch_size=BATCH,
                                   device=DEVICE)
        for r in _requests(ds):
            eng.submit(r)
        eng.run()

    return tapped_levels(run)


#: K1's levels by kind: level 0 of a batch (leaves), the levels past a
#: batch's depth (all padding), and by live slots.
K1_CLASSES = {
    "level 0": lambda t, live: t == 0,
    "all padding": lambda t, live: t > 0 and live == 0,
    "live < 64": lambda t, live: 0 < live < 64,
    "live >= 64": lambda t, live: live >= 64}


def k1_levels(label: str, levels) -> dict:
    """K1 on tapped levels ``levels`` ((case, kw) pairs): each compared
    with its plain version (``compare``) and timed (``fwd_times``) beside
    its bound; the means a launch over all of them and by
    ``K1_CLASSES``."""
    worst = max(compare(case, **kw) for case, kw in levels)
    check(worst <= TOL, f"K1 disagrees with its plain version on a level "
          f"of {label}: max_abs_err {worst:.3e} > {TOL}")
    rows = []
    for (case, kw), (ms, plain_ms, ev) in zip(levels, fwd_times(levels)):
        M = case[1].shape[0]
        live = M if kw.get("live") is None else kw["live"]
        b_ms, b_by, flops, _nb, fma_ms = bound_ms(case)
        rows.append({"t": int(case[5]) // M, "live": live, "ms": ms,
                     "plain_ms": plain_ms, "events_ms": ev,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_fma_ms": fma_ms, "flops": flops})

    def mean(sel):
        return {k: float(np.mean([r[k] for r in sel])) for k in
                ("ms", "events_ms", "plain_ms", "bound_ms", "bound_fma_ms",
                 "live")}

    out = {"levels": len(rows), "max_abs_err": worst, **mean(rows),
           "total_ms": sum(r["ms"] for r in rows), "by_class": {}}
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    out["bound_by"] = ("operations" if by_ops >= sum(r["bound_ms"]
                                                     for r in rows) / 2
                       else "bytes")
    for name, pick in K1_CLASSES.items():
        sel = [r for r in rows if pick(r["t"], r["live"])]
        if sel:
            out["by_class"][name] = {"levels": len(sel), **mean(sel)}
            c = out["by_class"][name]
            print(f"K1, {label}, {name} (x{len(sel)}, mean live "
                  f"{c['live']:.1f}): device {c['ms']:.4f} ms (events "
                  f"{c['events_ms']:.4f}), plain {c['plain_ms']:.4f} ms, "
                  f"bound {c['bound_ms']:.5f} ms (fp32 FMA "
                  f"{c['bound_fma_ms']:.5f})")
    print(f"K1, {label}: {len(rows)} levels, max_abs_err {worst:.3e}; mean "
          f"a launch: device {out['ms']:.4f} ms (events "
          f"{out['events_ms']:.4f}), plain {out['plain_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.5f} ms by {out['bound_by']} (fp32 FMA "
          f"{out['bound_fma_ms']:.5f}), {out['bound_ms'] / out['ms']:.1%} of "
          f"bound; all levels {out['total_ms']:.4f} ms")
    return out


def served_levels_phase() -> dict:
    """Every level the serving phase launches, with its own inputs and
    keywords (``served_level_cases``), through ``k1_levels``: these
    times, at the main path's own shapes, are the ones the JSON line
    reports."""
    levels = served_level_cases()
    check(levels, "the served traffic reached no kernel level")
    return k1_levels("served levels", levels)


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------

def _requests(ds):
    return [StructureRequest(i, g, x)
            for i, (g, x) in enumerate(zip(ds.graphs, ds.inputs))]


def served_traffic():
    """The serving phase's model (random weights from seed 0) and its
    traffic (SST-like parses from seed 0)."""
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim)
    params = fn.init(torch.Generator().manual_seed(0), device=DEVICE)
    ds = sst_like_dataset(N_REQUESTS, input_dim=cfg.input_dim, seed=0)
    return fn, params, ds


def timed_calls(obj, name: str) -> list:
    """Wrap ``obj.<name>`` (on the instance) so that every call appends
    its host seconds to the returned list."""
    took, inner = [], getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            took.append(time.perf_counter() - t0)
    setattr(obj, name, timed)
    return took


def _pct(seconds, q) -> float:
    """The ``q``-th percentile of host seconds, in ms (nan for none)."""
    return float(np.percentile(np.asarray(seconds) * 1e3, q)) if seconds \
        else float("nan")


def serve_phase(card: str) -> dict:
    fn, params, ds = served_traffic()
    eng = StructureServeEngine(fn, params, batch_size=BATCH, device=DEVICE)
    reqs = _requests(ds)
    for r in reqs:
        check(eng.submit(r), f"request {r.request_id} rejected: {r.error}")
    pack_s, harvest_s = timed_calls(eng.pipeline, "pack"), \
        timed_calls(eng.pipeline.cache, "_harvest")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    get_registry().reset()
    lat = []
    t_all = time.perf_counter()
    while eng.queue:
        t0 = time.perf_counter()
        eng.step()                 # ends in a device→host copy of roots
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = lm.LAUNCHES["treelstm_megastep"]
    peak = torch.cuda.max_memory_allocated()

    h = eng.health()
    levels = sum(shape[0] * n
                 for shape, n in eng.pipeline.census.counts().items())
    print(f"serve: health {json.dumps(h)}")
    check(all(r.status == "ok" for r in reqs),
          f"{sum(r.status != 'ok' for r in reqs)} request(s) not ok: "
          f"{[r.error for r in reqs if r.status != 'ok'][:3]}")
    check(h["degradations"] == 0, f"{h['degradations']} fused → oracle "
          f"degradation(s): {eng.last_degradation}")
    check(not h["breaker_open"], "circuit breaker open")
    check(launches == levels and launches > 0,
          f"{launches} kernel launches for {levels} padded levels")
    roots = np.stack([r.root_state for r in reqs])
    check(roots.shape == (N_REQUESTS, fn.state_dim), f"roots shape {roots.shape}")
    check(bool(np.isfinite(roots).all()), "non-finite root states")

    oracle = StructureServeEngine(fn, params, batch_size=BATCH,
                                  fusion_mode="none", device=DEVICE)
    oreqs = _requests(ds)
    for r in oreqs:
        oracle.submit(r)
    oracle.run()
    o_roots = np.stack([r.root_state for r in oreqs])
    err_op = float(np.abs(roots - o_roots).max())
    check(err_op <= TOL, f"fused roots vs op-by-op on the card: "
          f"{err_op:.3e} > {TOL}")

    cpu_params = {k: v.cpu() for k, v in params.items()}
    cpu = StructureServeEngine(fn, cpu_params, batch_size=8, device="cpu")
    creqs = _requests(ds)[:16]
    for r in creqs:
        cpu.submit(r)
    cpu.run()
    err_cpu = float(np.abs(roots[:16]
                           - np.stack([r.root_state for r in creqs])).max())
    check(err_cpu <= TOL, f"card roots vs CPU plain path: {err_cpu:.3e} "
          f"> {TOL}")

    lat_ms = np.asarray(lat) * 1e3
    shapes = {f"T{t}xM{m}": n
              for (t, m, _a, _n), n in eng.pipeline.census.counts().items()}
    out = {"requests": len(reqs), "batches": eng.batches,
           "requests_per_s": len(reqs) / wall,
           "batch_p50_ms": float(np.percentile(lat_ms, 50)),
           "batch_p99_ms": float(np.percentile(lat_ms, 99)),
           "max_memory_allocated_bytes": int(peak),
           "launches": launches, "padded_levels": levels,
           "pack_p50_ms": _pct(pack_s, 50), "pack_p99_ms": _pct(pack_s, 99),
           "harvest_p50_ms": _pct(harvest_s, 50),
           "cache": {k: v for k, v in eng.pipeline.stats().items()
                     if k in ("packs", "harvests", "splices", "hits")},
           "shapes": shapes, "err_vs_opbyop": err_op,
           "err_vs_cpu": err_cpu, "card": card}
    print(f"serve: {json.dumps(out)}")
    out["roots"] = roots                 # for the unfused engine's check
    return out


def profile_phase() -> None:
    """Where a served batch's time goes, on two warm batches of the same
    traffic: one under the port's tracer (host spans; the tracer
    synchronises the card at ``h2d.ext``) and one under
    ``torch.profiler`` (wall time, time the card spent in kernels and
    copies, the top ones).  The profiler's own host overhead inflates the
    wall time, so the idle share it gives is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim)
    params = fn.init(torch.Generator().manual_seed(0), device=DEVICE)
    ds = sst_like_dataset(3 * BATCH, input_dim=cfg.input_dim, seed=1)
    eng = StructureServeEngine(fn, params, batch_size=BATCH, device=DEVICE)
    for r in _requests(ds):
        eng.submit(r)
    eng.step()                                   # warm
    with trace.install_tracer(trace.Tracer()) as tracer:
        eng.step()
    spans = {}
    for sp in tracer.snapshot():
        if sp.ph == "X":
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.dur_ms
    print("host spans of one batch (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    print(f"profile: one batch of {BATCH}: wall {wall_ms:.3f} ms (under the "
          f"profiler), card busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.1%}")
    for e in sorted(on_card, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# Phases 4-5: training
# ---------------------------------------------------------------------------

def load_example(name: str):
    """``examples/<name>.py``, loaded from the checkout (``examples/`` is
    not a package)."""
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example():
    """The training example."""
    return load_example("torch_treelstm_sentiment")


def train_setup():
    """The training phases' model (the paper's tree_lstm at full width,
    random weights and head from seed 0), the example's FIFO batches of
    SST-like parses (seed 0) and a pipeline that packs pow2 buckets with
    the backward's sorted runs."""
    ex = _example()
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim)
    params = ex.init_params(fn, 0, DEVICE)
    ds = sst_like_dataset(TRAIN_DATA, input_dim=cfg.input_dim, seed=0)
    pipe = SchedulePipeline(cfg.input_dim,
                            bucket_policy=BucketPolicy(mode="pow2"),
                            with_runs=True, device=DEVICE)
    batches = ex.fifo_batches(ds, BATCH, np.random.default_rng(0))
    return ex, fn, params, pipe, batches


def _labels(labels: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(labels.astype(np.int64)).to(DEVICE)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst error relative to max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def grads_of(ex, fn, params, b, y, fusion_mode: str):
    """Loss and gradients of one training step (no update): every param
    and the packed external matrix."""
    bx = dataclasses.replace(b, ext=b.ext.clone().requires_grad_())
    loss, _acc, grads = ex.loss_and_grads(fn, params, bx, y, fusion_mode)
    out = {**grads["cell"], "head": grads["head"], "external": bx.ext.grad}
    return float(loss), out


def priced_ms(flops: float, nbytes: float, tf32x3: bool) -> tuple:
    """(bound ms, bound_by, fp32-FMA bound ms) of work of ``flops`` and
    ``nbytes``: the bytes at 3.35 TB/s against the operations at 67
    TFLOP/s fp32, or, with ``tf32x3``, as the three TF32 products an
    operation that keep f32 accuracy on the tensor cores at 495 TFLOP/s
    (the 67 TFLOP/s figure is then the third value)."""
    t_by = nbytes / PEAK_BYTES
    t_fma = flops / PEAK_FP32_FLOPS
    t_op = 3 * flops / PEAK_TF32_FLOPS if tf32x3 else t_fma
    return (max(t_op, t_by) * 1e3, "operations" if t_op >= t_by
            else "bytes", max(t_fma, t_by) * 1e3)


def bwd_bound_ms(case) -> tuple:
    """Least time for one reverse Tree-LSTM level on the card, from this
    level's data: the multiply-adds that slots with a live child need
    (the gate recompute, (a + 3) H^2 for a slot with a children, and as
    many again for the child-row cotangents) as three TF32 products at
    495 TFLOP/s (K2's products run on the tensor cores), against each
    input read once (distinct child rows, the live slots' ext and
    gradient rows, the weights unless no slot needs them, indices and
    runs) and each touched row read and written once, at 3.35 TB/s.
    Returns (bound_ms, bound_by, flops, bytes, bound_fma_ms), the last at
    the 67 TFLOP/s fp32-FMA rate."""
    (_kind, g, _buf, cids, _cmask, eids, nmask, _off, _ext, w), _kw = case
    M, A = cids.shape
    H = w[0].shape[0]
    live = nmask != 0
    present = (cids != g.shape[0] - 1) & live[:, None]
    n_child = present.sum(dim=1)
    flops = 2.0 * float((n_child + 3 * (n_child > 0)).sum()) * H * H * 2
    rows = torch.unique(cids[present]).numel()
    erows = torch.unique(eids[live]).numel()
    weights = (4 * H * H + 4 * H) if flops > 0 else 0
    nbytes = 4 * (rows * 2 * H + erows * 4 * H + int(live.sum()) * 2 * H
                  + weights + M * (A + 2) + 3 * M * A + 2 * rows * 2 * H)
    b_ms, b_by, fma_ms = priced_ms(flops, nbytes, True)
    return b_ms, b_by, flops, nbytes, fma_ms


def scatter_bound_ms(idx: torch.Tensor, rows: torch.Tensor) -> tuple:
    """Least time for one scatter-add: the rows and indices read once and
    each touched destination row read and written once, at 3.35 TB/s."""
    n, D = rows.shape
    nbytes = 4 * (n * D + n + 2 * torch.unique(idx).numel() * D)
    return nbytes / PEAK_BYTES * 1e3, "bytes", nbytes


def heavy_scatter_case(gen: torch.Generator):
    """A duplicate-heavy scatter shaped like the step's pulled-row one:
    most rows are zero rows aimed at the sentinel, the rest spread."""
    R, D, n = 4097, 4 * HIDDEN, 32768
    idx = torch.randint(0, R, (n,), generator=gen, dtype=torch.int32)
    heavy = torch.rand(n, generator=gen) < 0.9
    idx[heavy] = R - 1
    rows = torch.randn(n, D, generator=gen)
    rows[heavy & (torch.rand(n, generator=gen) < 0.8)] = 0.0
    dst = torch.randn(R, D, generator=gen)
    return dst.to(DEVICE), idx.to(DEVICE), rows.to(DEVICE)


#: K7's two kernels, timed apart by ``torch.profiler``.
K7_PARTS = {"add_ms": ("chunk_add_kernel",),
            "combine_ms": ("run_combine_kernel",)}


def plan_build_ms(sched) -> float:
    """Host ms to build a schedule's scatter plans on the card (what
    ``to_device`` adds once per schedule): the pulled-row plan and one
    per level, copies to the card included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.scatter_plans(DEVICE)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def k7_check(label: str, dst0, idx, src, plan) -> dict:
    """K7 on one scatter's inputs with its plan: against ``index_add_``
    (error relative to max |plain| <= TOL), bit for bit against the plain
    rendering of its own summation order and against a second launch,
    rows no index points at bit-unchanged; then device ms a call (its
    add and combine apart), of its plain version and of ``index_add_``
    by ``torch.profiler``, beside its bound.  Returns the numbers."""
    got = lmb.scatter_add_rows(dst0.clone(), idx, src, plan=plan)
    again = lmb.scatter_add_rows(dst0.clone(), idx, src, plan=plan)
    want = ref.scatter_add_rows(dst0.clone(), idx, src)
    order = ref.scatter_add_rows_planned(dst0.clone(), src, plan)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    hit = torch.zeros(dst0.shape[0], dtype=torch.bool, device=DEVICE)
    hit[idx.long()] = True
    check(bitwise_equal(got[~hit], dst0[~hit]),
          f"scatter-add changed rows no index points at ({label})")
    check(bitwise_equal(got, again), f"scatter-add not repeatable bit for "
          f"bit ({label})")
    check(bitwise_equal(got, order), f"scatter-add is not the sum in its "
          f"plan's order ({label})")
    check(err <= TOL, f"scatter-add disagrees with its plain version "
          f"({label}): {err:.3e} > {TOL}")
    dk, dp, dl = dst0.clone(), dst0.clone(), dst0.clone()
    idx_long = idx.long()
    t = device_ms({"kernel": {"calls": [lambda: lmb.scatter_add_rows(
                       dk, idx, src, plan=plan)], "parts": K7_PARTS},
                   "plain": [lambda: ref.scatter_add_rows(dp, idx, src)],
                   "library": [lambda: dl.index_add_(0, idx_long, src)]},
                  reps=10)
    ms, parts = t["kernel"]
    out = {"max_abs_err": float((got - want).abs().max()),
           "max_rel_err": err, "ms": ms, **parts,
           "plain_ms": t["plain"], "library_ms": t["library"],
           "events_ms": time_ms(lambda: lmb.scatter_add_rows(
               dk, idx, src, plan=plan), 20, 3)}
    out["bound_ms"], out["bound_by"], nbytes = scatter_bound_ms(idx, src)
    share = float((idx == dst0.shape[0] - 1).float().mean())
    print(f"scatter-add, {label} (n={idx.numel()}, R={dst0.shape[0]}, "
          f"D={dst0.shape[1]}, {share:.0%} at the last row; plan: "
          f"{plan.chunks.shape[0]} chunks of <= {plan.chunk_rows}, "
          f"{plan.split_chunks} in {plan.run_start.numel() - 1} split "
          f"run(s)): error {err:.3e} of max |plain| (max abs "
          f"{out['max_abs_err']:.3e}), bitwise its plan's order, "
          f"repeatable, untouched rows kept; device ms: kernel "
          f"{ms:.4f} (add {parts['add_ms']:.4f}, combine "
          f"{parts['combine_ms']:.4f}; events {out['events_ms']:.4f}), "
          f"plain {out['plain_ms']:.4f}, index_add_ "
          f"{out['library_ms']:.4f}, bound {out['bound_ms']:.5f} by bytes "
          f"({nbytes / 1e6:.1f} MB)")
    return out


def k2_ctas(kind: str, live: int, A: int, H: int) -> tuple:
    """CTAs of K2's two launches on a level of ``live`` live slots (tiles
    times the cluster's depth split, ``level_megastep.k2_split``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tuple(g[0] * s for g, s in zip(
        lmb.k2_grid(kind, live, A, H), lmb.k2_splits(kind, live, A, H, sms)))


def k2_level(case, bound) -> dict:
    """One tapped reverse level ``case`` (the arguments and keywords the
    backward gave ``ops.bwd_megastep``, the gradient buffer as it was)
    re-run through K2 and its plain version: error relative to max
    |plain|, rows no child touches bit-unchanged, finite, a second launch
    bitwise equal, the CUDA launches the call made against the level's
    plan (none without a live slot, 2 with one contribution a row, 3
    else); then, on a level that launches, the kernel's and its plain
    version's CUDA event ms, CTAs, ``bound(case)``'s bound, and the call
    (``"call"``) that ``k2_device_ms`` times."""
    (kind, g0, buf, cids, cmask, eids, nm, off, ext, w), kw = case
    M, A = cids.shape
    key = f"{kind}_bwd_megastep.cuda_launches"
    before = lm.LAUNCHES[key]
    got = lmb.bwd_megastep(kind, g0.clone(), buf, cids, eids, nm, off, ext,
                           w, **kw)
    made = lm.LAUNCHES[key] - before
    again = lmb.bwd_megastep(kind, g0.clone(), buf, cids, eids, nm, off, ext,
                             w, **kw)
    want = ref.bwd_megastep(kind, g0.clone(), buf, cids, cmask, eids, nm,
                            off, ext, w)
    torch.cuda.synchronize()
    touched = torch.zeros(g0.shape[0], dtype=torch.bool, device=DEVICE)
    touched[cids.reshape(-1).long()] = True
    touched[-1] = False
    check(bitwise_equal(got[~touched], g0[~touched]),
          f"{kind} reverse megastep changed rows it does not touch at "
          f"offset {off}")
    check(bool(torch.isfinite(got).all()),
          f"{kind} reverse megastep wrote non-finite values")
    check(bitwise_equal(got, again), f"{kind} reverse megastep: two "
          f"launches differ at offset {off}")
    live, single = kw["live"], kw["single"]
    designed = 0 if live == 0 else 2 if single else 3
    check(made == designed, f"{kind} reverse level at offset {off}: {made} "
          f"CUDA launches, designed {designed}")
    out = {"t": off // M, "live": live, "M": M, "single": single,
           "launches": made, "max_rel_err": rel_err(got, want),
           "max_abs_err": float((got - want).abs().max())}
    if live == 0:
        return out
    H = w[0].shape[0] if kind in ("treelstm", "lstm", "gru") \
        else w[0].shape[1]
    gk, gp = g0.clone(), g0.clone()

    def kernel():
        lmb.bwd_megastep(kind, gk, buf, cids, eids, nm, off, ext, w, **kw)

    out["ctas"] = k2_ctas(kind, live, A, H)
    out["call"] = kernel
    out["events_ms"] = time_ms(kernel, n=10, warmup=2)
    out["plain_ms"] = time_ms(lambda: ref.bwd_megastep(
        kind, gp, buf, cids, cmask, eids, nm, off, ext, w), n=5, warmup=1)
    (out["bound_ms"], out["bound_by"], out["flops"], out["bytes"],
     out["bound_fma_ms"]) = bound(case)
    return out


def k2_set(r: dict) -> dict:
    """The ``device_ms`` set of K2 on one launching level (``k2_level``'s
    row): its ``k2_*`` kernels, ``launches`` of them a call."""
    return {"calls": [r["call"]], "match": "k2_", "launches": r["launches"]}


def k2_device_ms(rows, reps: int = 10) -> None:
    """Device ms a call of K2 on each launching level of ``rows``
    (``k2_level``'s), every level in one ``device_ms`` session.  Sets each
    row's ``ms``."""
    timed = [r for r in rows if r["live"]]
    t = device_ms({i: k2_set(r) for i, r in enumerate(timed)}, reps=reps)
    for i, r in enumerate(timed):
        r["ms"] = t[i]


def k2_print(label: str, r: dict) -> None:
    if r["live"] == 0:
        print(f"  {label} reverse level {r['t']:2d}: no live slot, no "
              f"launch; error {r['max_rel_err']:.3e}")
        return
    print(f"  {label} reverse level {r['t']:2d}: live {r['live']}/{r['M']}, "
          f"CTAs {r['ctas'][0]} + {r['ctas'][1]}, {r['launches']} launches; "
          f"device {r['ms']:.4f} ms (events {r['events_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
          f"{r['bound_by']} (fp32 FMA {r['bound_fma_ms']:.5f}; "
          f"{r['flops'] / 1e9:.3f} GFLOP, {r['bytes'] / 1e6:.2f} MB); "
          f"error {r['max_rel_err']:.3e}")


def k2_summary(rows) -> dict:
    """K2's row over a phase's tapped levels: the worst errors over every
    level; means per launching level (the levels ``launches`` counts) of
    device ms, event ms, plain ms and both bounds; which bound holds most
    of the bound time; the most CUDA launches a level."""
    timed = [r for r in rows if r["live"]]
    n = len(timed)
    total = sum(r["bound_ms"] for r in timed)
    by_ops = sum(r["bound_ms"] for r in timed
                 if r["bound_by"] == "operations")
    return {"levels": len(rows), "launching_levels": n,
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] for r in timed) / n for k in
               ("ms", "events_ms", "plain_ms", "bound_ms", "bound_fma_ms")},
            "bound_by": "operations" if by_ops >= total / 2 else "bytes",
            "max_launches_a_level": max(r["launches"] for r in rows)}


def k2_design(dev_sched) -> tuple:
    """(levels that launch, CUDA launches) of one K2 backward over a
    schedule, from its plan."""
    work = [single for live, single in zip(dev_sched.live,
                                           dev_sched.bwd_single) if live]
    return len(work), sum(2 if single else 3 for single in work)


#: K2's instantiations in ``bwd_megastep_sm90.cu``: kind by template code.
K2_KINDS = ("treelstm", "lstm", "gru", "treefc")


def ptxas_report(lib: str, key_re: str, label,
                 spill_free: str = "") -> dict:
    """What ``nvcc -Xptxas -v`` said when kernel ``lib`` was built, by
    entry function matching ``key_re`` (named ``label(match)``): its
    registers and spills, printed a line each.  Where ``spill_free`` names
    the kernel, none of them may spill."""
    ptxas, key = {}, None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function .*" + key_re, line)
        if m:
            key = label(m)
        elif key and ("registers" in line or "spill stores" in line):
            ptxas.setdefault(key, []).append(
                line.replace("ptxas info    :", "").strip())
    for k, lines in ptxas.items():
        print(f"{_build.KERNELS[lib][0]}, {k}: " + "; ".join(lines))
    spills = [k for k, lines in ptxas.items() for ln in lines
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    check(not (spill_free and spills),
          f"{spill_free} spills registers: {spills}")
    return ptxas


def sass_counts(lib: str, label: str,
                needs=("HMMA.1688.F32.TF32", "LDGSTS", "LDSM")) -> dict:
    """Where ``cuobjdump`` is on the machine, the counts in kernel
    ``lib``'s SASS of the TF32 ``mma.sync`` (``HMMA.1688.F32.TF32``),
    ``cp.async`` (``LDGSTS``) and ``ldmatrix`` (``LDSM``) the gathered
    product runs on, each of ``needs`` of which it must hold, and of float
    atomics (``RED``/``ATOM`` on ``.F32``), which it must not; {} without
    it."""
    cob = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cob).exists():
        return {}
    dump = subprocess.run([cob, "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, timeout=120).stdout
    sass = {k: dump.count(k) for k in ("HMMA.1688.F32.TF32", "LDGSTS",
                                       "LDSM")}
    sass["float atomics"] = len(re.findall(
        r"\b(?:RED|ATOMG?|ATOMS)\.[A-Z0-9.]*F32", dump))
    check(all(sass[k] > 0 for k in needs),
          f"{label}'s SASS lacks the tensor-core product's instructions: "
          f"{sass}")
    check(sass["float atomics"] == 0, f"{label}'s SASS has float atomics: "
          f"{sass}")
    return sass


def k1_build_report() -> dict:
    """What ``nvcc -Xptxas -v`` said of K1's kernels (the product kernel
    by arity, the leaf kernel): registers and spills, none of which may
    spill; the product kernel's dynamic shared memory a CTA by arity; and
    its SASS (``sass_counts``)."""
    lib = "treelstm_megastep"
    ptxas = ptxas_report(
        lib, r"k1_(gates|leaf)_kernel(?:ILi(\d)E)?",
        lambda m: m.group(1) + (f", A {m.group(2)}" if m.group(2) else ""),
        "K1")
    check(len(ptxas) == 5, f"K1's ptxas report names {len(ptxas)} kernels")
    smem_of = ctypes.CDLL(str(_build.library_path(lib))) \
        .treelstm_megastep_smem_bytes
    smem = {a: smem_of(a) for a in (1, 2, 3, 4)}
    sass = sass_counts(lib, "K1")
    print(f"treelstm_megastep_sm90.cu: dynamic shared memory a product CTA "
          f"by arity {smem}; SASS {sass or 'not read (no cuobjdump)'}")
    return {"ptxas": ptxas, "smem": smem, "sass": sass}


def cell_build_report() -> dict:
    """What ``nvcc -Xptxas -v`` said of the kernels of
    ``cell_megastep_sm90.cu`` (K3, K4 and K5: the product kernel and the
    leaf kernel of each kind; K9 at float and bf16 state): registers and
    spills, none of which may spill; a product CTA's dynamic shared
    memory by kind; and the SASS (``sass_counts``)."""
    lib = "lstm_megastep"
    kinds = ("lstm", "gru", "treefc")
    ptxas = ptxas_report(
        lib, r"(cell_gates|cell_leaf|k9_level)_kernelI(?:Li(\d)E|([ft]))E",
        lambda m: m.group(1) + (f", {kinds[int(m.group(2))]}"
                                if m.group(2) else
                                ", f32" if m.group(3) == "f" else ", bf16"),
        "K3-K5/K9")
    check(len(ptxas) == 8, f"cell_megastep_sm90.cu's ptxas report names "
          f"{len(ptxas)} kernels, not 8")
    smem_of = ctypes.CDLL(str(_build.library_path(lib))) \
        .cell_megastep_smem_bytes
    smem = {k: smem_of(i) for i, k in
            enumerate(kinds + ("K9 f32", "K9 bf16"))}
    sass = sass_counts(lib, "K3-K5/K9")
    print(f"cell_megastep_sm90.cu: dynamic shared memory a product CTA "
          f"by kind {smem}; SASS {sass or 'not read (no cuobjdump)'}")
    return {"ptxas": ptxas, "smem": smem, "sass": sass}


def k2_build_report() -> dict:
    """What ``nvcc -Xptxas -v`` said of each of K2's kernels (pass and
    kind, treelstm by arity): registers and spills, none of which may
    spill; their dynamic shared memory a CTA; and, where ``cuobjdump`` is
    on the machine, the TF32 ``mma.sync`` (``HMMA.1688.F32.TF32``) the
    SASS must hold and the float atomics (``RED``/``ATOM`` on ``.F32``)
    it must not."""
    lib = "treelstm_bwd_megastep"

    def label(m):
        kind = K2_KINDS[int(m.group(2))] if m.group(2) else "any"
        return f"{m.group(1)}, {kind}" + (
            f", A {m.group(3)}" if kind == "treelstm" else "")

    ptxas = ptxas_report(
        lib, r"k2_(gates|hgrad|runs)_kernel(?:ILi(\d)ELi(\d)E)?", label,
        "K2")
    check(len(ptxas) >= 9, f"K2's ptxas report names {len(ptxas)} kernels")
    smem_of = ctypes.CDLL(str(_build.library_path(lib))) \
        .bwd_megastep_smem_bytes
    smem = {f"{k}{f' A {a}' if k == 'treelstm' else ''}":
            (smem_of(i, a, 0), smem_of(i, a, 1))
            for i, k in enumerate(K2_KINDS)
            for a in ((1, 2, 3, 4) if k == "treelstm" else (1,))}
    sass = sass_counts(lib, "K2")
    print(f"bwd_megastep_sm90.cu: dynamic shared memory a CTA (gates, "
          f"hgrad) {smem}; SASS {sass or 'not read (no cuobjdump)'}")
    return {"ptxas": ptxas, "smem": smem, "sass": sass}


def k12_build_report() -> dict:
    """What ``nvcc -Xptxas -v`` said of K12's kernels (by element type,
    head-dim class, heads a y unit and row blocks a y unit): registers
    and spills, none of which may spill; the dynamic shared memory a CTA
    of each; and its SASS (``sass_counts``: the TF32 ``mma.sync``,
    ``cp.async`` and ``ldmatrix`` it must hold, no float atomic)."""
    lib = "ssd_chunk_scan"
    ptxas = ptxas_report(
        lib, r"ssd_chunk_sm90_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d)"
        r"ELi(\d)E",
        lambda m: (f"{'f32' if m.group(1) == 'f' else 'bf16'}, P <= "
                   f"{m.group(2)}, HG {m.group(3)}, R {m.group(4)}"),
        "K12")
    check(len(ptxas) == 20, f"K12's ptxas report names {len(ptxas)} "
          "kernels, not 20")
    smem_of = ctypes.CDLL(str(_build.library_path(lib))) \
        .ssd_chunk_sm90_smem_bytes
    smem = {f"P {p}, HG {hg}, R {r}": smem_of(p, hg, r)
            for p in (32, 64, 128) for hg in ((1, 2) if p <= 64 else (1,))
            for r in (1, 2)}
    sass = sass_counts(lib, "K12")
    print(f"ssd_chunk_sm90.cu: dynamic shared memory a CTA {smem}; SASS "
          f"{sass or 'not read (no cuobjdump)'}")
    return {"ptxas": ptxas, "smem": smem, "sass": sass}


def train_levels_phase() -> dict:
    """One full-width training step, its backward taken with taps on
    ``ops.bwd_megastep`` and ``ops.scatter_add_rows`` that keep each
    launch's arguments (the gradient buffer and scatter destination as
    they were before the launch).  Each reverse level and scatter is then
    re-run through its kernel and its plain version on the same CUDA
    inputs, compared and timed; the fused gradients are held against the
    op-by-op leg's and against a second fused backward, bit for bit."""
    ex, fn, params, pipe, batches = train_setup()
    graphs, inputs, labels = next(batches)
    b = pipe.pack(graphs, inputs)
    y = _labels(labels)
    levels, scatters = [], []
    inner_bwd, inner_sc = ops.bwd_megastep, ops.scatter_add_rows

    def tap_bwd(kind, g, *args, **kw):
        levels.append(((kind, g.clone()) + args, kw))
        return inner_bwd(kind, g, *args, **kw)

    def tap_sc(dst, idx, rows, plan=None):
        scatters.append((dst.clone(), idx, rows, plan))
        return inner_sc(dst, idx, rows, plan=plan)

    step = {}
    ops.bwd_megastep, ops.scatter_add_rows = tap_bwd, tap_sc
    try:
        fwd = tapped_levels(lambda: step.update(
            out=grads_of(ex, fn, params, b, y, "auto")))
    finally:
        ops.bwd_megastep, ops.scatter_add_rows = inner_bwd, inner_sc
    loss, fused = step["out"]
    T, M = b.sched.T, b.sched.M
    check(len(fwd) == T, f"{len(fwd)} forward levels for T={T}")
    check(len(levels) == T, f"{len(levels)} reverse levels for T={T}")
    check(len(scatters) == 1, f"{len(scatters)} scatters in a fused step")

    torch.set_grad_enabled(False)          # re-runs of the step's work
    k1 = k1_levels(f"the training step's forward (T{T}xM{M})", fwd)
    rows = [k2_level(case, bwd_bound_ms) for case in levels]
    k2_device_ms(rows)
    print(f"train step: T{T}xM{M}, loss {loss:.6f}")
    for r in rows:
        k2_print("treelstm", r)
    bwd = k2_summary(rows)
    check(bwd["max_rel_err"] <= TOL, f"reverse megastep disagrees with its "
          f"plain version: error {bwd['max_rel_err']:.3e} of max |plain| > "
          f"{TOL}")
    check(bwd["max_launches_a_level"] <= 2, f"K2 made "
          f"{bwd['max_launches_a_level']} CUDA launches on a tree level")
    print(f"reverse megastep: {bwd['levels']} levels ({bwd['launching_levels']}"
          f" launching), error {bwd['max_rel_err']:.3e} of max |plain| (max "
          f"abs {bwd['max_abs_err']:.3e}); mean per launching level: device "
          f"{bwd['ms']:.4f} ms (events {bwd['events_ms']:.4f}), plain "
          f"{bwd['plain_ms']:.4f} ms, bound {bwd['bound_ms']:.5f} ms by "
          f"{bwd['bound_by']} (fp32 FMA {bwd['bound_fma_ms']:.5f})")

    check(scatters[0][3] is b.dev.ext_plan, "the step's scatter did not "
          "get the schedule's plan")
    plan_ms = plan_build_ms(b.sched)
    print(f"scatter plans of the step's schedule (T{T}xM{M}: the pulled "
          f"rows and {T} levels) built in {plan_ms:.3f} ms (host, once per "
          f"schedule)")
    sc = k7_check("step's pulled-row scatter", *scatters[0])
    dst0, idx, src = heavy_scatter_case(torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    heavy_plan = ScatterPlan.build(idx, DEVICE)
    heavy_ms = (time.perf_counter() - t0) * 1e3
    heavy = k7_check("duplicate-heavy case", dst0, idx, src, heavy_plan)
    heavy["plan_ms"] = heavy_ms
    sc.update(plan_ms=plan_ms, heavy=heavy,
              max_abs_err=max(sc["max_abs_err"], heavy["max_abs_err"]))

    torch.set_grad_enabled(True)
    lm.reset_launches()
    loss_n, none = grads_of(ex, fn, params, b, y, "none")
    check(lm.LAUNCHES["scatter_add_rows"] == T + 1,
          f"{lm.LAUNCHES['scatter_add_rows']} scatter-add launches in the "
          f"op-by-op backward, designed {T + 1} (one a level and one for "
          f"the pulled rows)")
    worst = 0.0
    for k, v in fused.items():
        e = rel_err(v, none[k])
        worst = max(worst, e)
        print(f"fused vs op-by-op gradient {k}: {e:.3e} of max |op-by-op|")
    check(abs(loss - loss_n) <= TOL * max(1.0, abs(loss_n)),
          f"fused loss {loss} vs op-by-op {loss_n}")
    check(worst <= TOL, f"fused gradients vs op-by-op on the card: "
          f"{worst:.3e} > {TOL}")
    _, again = grads_of(ex, fn, params, b, y, "auto")
    same = all(bitwise_equal(v, again[k]) for k, v in fused.items())
    check(same, "two backward passes of the same step differ")
    print(f"fused vs op-by-op: worst {worst:.3e}; two backward passes "
          f"bitwise equal: {same}")
    return {"fwd": k1, "bwd": bwd, "scatter": sc, "fused_vs_none": worst}


def train_phase(card: str) -> dict:
    """The main path: the example's training loop, AdamW with a
    warmup-cosine schedule, for ``TRAIN_STEPS`` steps at full width,
    launch counts set to 0 just before and read just after; then one warm
    step under ``torch.profiler``."""
    from repro_torch.optim import warmup_cosine
    ex, fn, params, pipe, batches = train_setup()
    opt = adamw_init(params)
    lr = warmup_cosine(3e-3, 20, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    losses, step_s, pack_s, padded, work = [], [], [], 0, [0, 0]
    fwd_cuda = 0
    t_all = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        graphs, inputs, labels = next(batches)
        b = pipe.pack(graphs, inputs)
        t1 = time.perf_counter()
        work = [x + y for x, y in zip(work, k2_design(b.dev))]
        fwd_cuda += sum(fwd_designed(b.dev.M, live) for live in b.dev.live)
        loss, _acc = ex.train_step(fn, params, opt, b, _labels(labels),
                                   lr(opt.step))
        losses.append(float(loss))         # waits for the step's work
        step_s.append(time.perf_counter() - t0)
        pack_s.append(t1 - t0)
        padded += b.sched.T
    wall = time.perf_counter() - t_all
    launches = dict(lm.LAUNCHES)
    k1_cuda = lm.CUDA_LAUNCHES["treelstm_megastep"]
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.isfinite(losses).all()), f"non-finite losses: {losses}")
    check(k1_cuda == fwd_cuda <= 2 * padded, f"{k1_cuda} K1 CUDA launches, "
          f"designed {fwd_cuda} (at most 2 a level)")
    check(launches.get("treelstm_bwd_megastep", 0) == work[0],
          f"{launches.get('treelstm_bwd_megastep', 0)} reverse megastep "
          f"launches for {work[0]} levels with a live slot")
    check(launches.get("treelstm_bwd_megastep.cuda_launches", 0)
          == work[1] <= 2 * work[0],
          f"{launches.get('treelstm_bwd_megastep.cuda_launches', 0)} K2 "
          f"CUDA launches, designed {work[1]} (at most 2 a tree level)")
    check(launches.get("treelstm_megastep", 0) == padded,
          f"{launches.get('treelstm_megastep', 0)} forward megastep "
          f"launches for {padded} padded levels")
    check(launches.get("scatter_add_rows", 0) == TRAIN_STEPS,
          f"{launches.get('scatter_add_rows', 0)} scatter-add launches for "
          f"{TRAIN_STEPS} steps")
    ms = np.asarray(step_s) * 1e3
    stats = pipe.stats()
    out = {"steps": TRAIN_STEPS, "loss_first": losses[0],
           "loss_last": losses[-1], "steps_per_s": TRAIN_STEPS / wall,
           "step_p50_ms": float(np.percentile(ms, 50)),
           "step_p99_ms": float(np.percentile(ms, 99)),
           "pack_p50_ms": float(np.percentile(np.asarray(pack_s) * 1e3, 50)),
           "max_memory_allocated_bytes": int(peak),
           "padded_levels": padded, "launches": launches,
           "k1_cuda_launches": k1_cuda,
           "cache_hit_rate": stats["hit_rate"],
           "shapes": {f"T{t}xM{m}": n for (t, m, _a, _n), n
                      in pipe.census.counts().items()},
           "card": card}
    print("train losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train: {json.dumps(out)}")
    out["losses"] = losses

    graphs, inputs, labels = next(batches)
    b = pipe.pack(graphs, inputs)
    y = _labels(labels)
    profile_step(f"one warm training step (T{b.sched.T}xM{b.sched.M})",
                 lambda: float(ex.train_step(fn, params, opt, b, y,
                                             lr(opt.step))[0]))
    return out


#: Kernel-name patterns of the profiler breakdowns.
PROFILE_GROUPS = {
    "forward megastep (K1, K3-K5)": ("k1_gates_kernel", "k1_leaf_kernel",
                                     "cell_gates_kernel",
                                     "cell_leaf_kernel"),
    "K2 reverse megastep": ("k2_gates_kernel", "k2_hgrad_kernel",
                            "k2_runs_kernel"),
    "K7 add": ("chunk_add_kernel",),
    "K7 combine": ("run_combine_kernel",),
    "K6 row gather/scatter": ("gather_rows_kernel", "scatter_rows_kernel"),
    "K10/K11 attention": ("flash_attention_kernel",
                          "flash_attention_sm90_kernel",
                          "flash_attention_tf32_kernel",
                          "decode_attention_kernel"),
    "K12 SSD chunk scan": ("ssd_chunk_sm90_kernel",),
    "matmul": ("gemm", "Gemm", "cutlass", "xmma", "nvjet"),
    "copy and fill": ("Memcpy", "Memset", "copy", "fill")}


def profile_step(label: str, step) -> dict:
    """``step`` once to warm, then once under ``torch.profiler``: wall
    time, time the card spent in kernels and copies (by group of
    ``PROFILE_GROUPS`` and the top ones) and the idle share.  ``step``
    must end in a device→host read; the profiler's own host overhead
    inflates the wall time, so the idle share is an upper bound.  The
    session waits ``profiler_guard_s()`` on the host at its ends, outside
    the wall time, as ``device_ms`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    guard = profiler_guard_s()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(guard)
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(guard)
    offset = launch_offset_us(prof.events())
    if offset is not None:
        PROFILER_OFFSETS_US.append(offset)
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    sums = {k: 0.0 for k in list(PROFILE_GROUPS) + ["other"]}
    for e in on_card:
        k = next((k for k, pats in PROFILE_GROUPS.items()
                  if any(p in e.key for p in pats)), "other")
        sums[k] += e.self_device_time_total / 1e3
    print(f"profile: {label}: wall {wall_ms:.3f} ms (under the profiler), "
          f"card busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.1%}; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sums.items()))
    for e in sorted(on_card, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, **sums}


# ---------------------------------------------------------------------------
# Phases 6-8: training the Var-LSTM, GRU chains and Tree-FC
# ---------------------------------------------------------------------------

#: phase → (megastep kind, paper config of its graphs, pack pads).
CELL_PHASES = {"var_lstm": ("lstm", "var_lstm", {}),
               "gru": ("gru", "var_lstm", {}),
               "tree_fc": ("treefc", "tree_fc", {"pad_arity": 2})}
#: megastep kind → the TPU kernel its forward kernel replaces.
FORWARD_REPLACES = {"lstm": "src/repro/kernels/level_megastep.py:98",
                    "gru": "src/repro/kernels/level_megastep.py:238",
                    "treefc": "src/repro/kernels/level_megastep.py:299"}


def cell_setup(phase: str):
    """The phase's cell at full width (params from ``torch.Generator``
    seed 0, the bias drawn nonzero), its graphs (seed 0) packed once with
    the backward's sorted runs, and seeded normal inputs."""
    kind, cfg_name, pads = CELL_PHASES[phase]
    cfg = get_paper_model(cfg_name)
    fn = (GRUVertex(input_dim=cfg.input_dim, hidden=HIDDEN) if phase == "gru"
          else cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim))
    gen = torch.Generator().manual_seed(0)
    params = fn.init(gen, device=DEVICE)
    # A non-zero bias exercises every bias lane of the epilogues.
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .to(DEVICE)
    rng = np.random.default_rng(0)
    graphs = (cfg.make_graphs(128, max_len=64, rng=rng)
              if cfg_name == "var_lstm" else cfg.make_graphs(64))
    s = pack_batch(graphs, with_runs=True, **pads)
    xs = [rng.standard_normal((g.num_nodes, cfg.input_dim))
          .astype(np.float32) for g in graphs]
    ext = torch.from_numpy(pack_external(xs, s, cfg.input_dim)).to(DEVICE)
    h_lo = HIDDEN if kind == "lstm" else 0          # the h part of a state
    return kind, fn, params, s.to_device(DEVICE), ext, h_lo, s


def cell_grads(fn, params, d, ext, h_lo, fusion_mode: str = "auto"):
    """Loss ``mean(readout_roots(buf)[:, h_lo:] ** 2)`` and its gradients
    w.r.t. every param (and ``ext`` when it requires them), taken w.r.t.
    detached copies that share storage with ``params``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    buf = execute_lazy(fn, leaves, ext, d, fusion_mode)
    loss = torch.mean(readout_roots(buf, d)[:, h_lo:] ** 2)
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items()}
    if ext.requires_grad:
        grads["external"] = ext.grad
    return loss.detach(), grads


def cell_bound_ms(kind: str, case, reverse: bool) -> tuple:
    """Least time for one level on the card, from this level's data: the
    multiply-adds its live slots need (an lstm/gru slot with a
    predecessor NG*H*H, a Tree-FC slot H*H per child it has; twice that
    in reverse: recompute and child cotangents) as three TF32 products at
    495 TFLOP/s (K3-K5 and K2 run them on the tensor cores), against each
    input read once (distinct child rows, the live
    slots' ext rows -- in the lstm/gru forward a slot with no predecessor
    needs only three lanes of its row -- and, in reverse, their gradient
    rows; the weight unless no slot needs it; bias, indices and runs) and
    the block written once (in reverse: each touched row read and written
    once) at 3.35 TB/s.  Absent children point at the last row.  Returns
    (bound_ms, bound_by, flops, bytes,
    bound_fma_ms), the last at the 67 TFLOP/s fp32-FMA rate."""
    _k, lead, cids, _cmask, eids, nmask, _off, _ext, (w, _b) = case
    M, A = cids.shape
    H = w.shape[1] if kind == "treefc" else w.shape[0]
    S, G = lm.widths(kind, H)
    live = nmask != 0
    present = (cids != lead.shape[0] - 1) & live[:, None]
    if kind == "treefc":
        macs = float(present.sum()) * H * H
        read = present
    else:
        macs = float(present[:, 0].sum()) * G * H
        read = present if reverse else present[:, :1]
    flops = 2.0 * macs * (2 if reverse else 1)
    rows = torch.unique(cids[:, :read.shape[1]][read]).numel()
    if reverse or kind == "treefc":
        lanes = torch.unique(eids[live]).numel() * G
    else:
        pred = present[:, 0]
        lanes = (G * torch.unique(eids[live & pred]).numel()
                 + 3 * H * torch.unique(eids[live & ~pred]).numel())
    weights = (w.numel() if flops > 0 else 0) + G
    if reverse:
        touched = torch.unique(cids[present]).numel()
        nbytes = 4 * (rows * S + lanes + int(live.sum()) * S + weights
                      + M * (A + 2) + 3 * M * A + 2 * touched * S)
    else:
        nbytes = 4 * (rows * S + lanes + weights + M * (A + 2) + M * S)
    b_ms, b_by, fma_ms = priced_ms(flops, nbytes, True)
    return b_ms, b_by, flops, nbytes, fma_ms


def _summary(rows) -> dict:
    """Means per launch over a phase's levels (``rows``: ms, plain ms,
    bound ms, bound_by, ...), and which of the two bounds holds most of
    the bound time."""
    n = len(rows)
    by_ops = sum(r[2] for r in rows if r[3] == "operations")
    total = sum(r[2] for r in rows)
    return {"levels": n, "ms": sum(r[0] for r in rows) / n,
            "plain_ms": sum(r[1] for r in rows) / n,
            "bound_ms": total / n,
            "bound_by": "operations" if by_ops >= total / 2 else "bytes"}


def cell_levels_check(kind: str, fn, params, d, ext, h_lo) -> dict:
    """One step of the phase taken with taps on ``ops.level_megastep``,
    ``ops.bwd_megastep`` and ``ops.scatter_add_rows``; every forward and
    reverse level and the pulled-row scatter re-run through its kernel
    and its plain version on the same CUDA inputs, compared and timed;
    then the fused gradients against the op-by-op leg's and a second
    fused backward."""
    fwd, bwd, scatters = [], [], []
    inner = ops.level_megastep, ops.bwd_megastep, ops.scatter_add_rows

    def tap_fwd(k, buf, *args, **kw):
        fwd.append(((k, buf) + args, kw))
        return inner[0](k, buf, *args, **kw)

    def tap_bwd(k, g, *args, **kw):
        bwd.append(((k, g.clone()) + args, kw))
        return inner[1](k, g, *args, **kw)

    def tap_sc(dst, idx, rows, plan=None):
        scatters.append((dst.clone(), idx, rows, plan))
        return inner[2](dst, idx, rows, plan=plan)

    ops.level_megastep, ops.bwd_megastep, ops.scatter_add_rows = \
        tap_fwd, tap_bwd, tap_sc
    try:
        ext_g = ext.clone().requires_grad_()
        loss, fused = cell_grads(fn, params, d, ext_g, h_lo)
    finally:
        ops.level_megastep, ops.bwd_megastep, ops.scatter_add_rows = inner
    T, M = d.T, d.M
    print(f"{kind}: T{T}xM{M}xA{d.A}, loss {float(loss):.6f}; tapped "
          f"{len(fwd)} forward levels, {len(bwd)} reverse levels, "
          f"{len(scatters)} scatter(s)")
    check(len(fwd) == T and len(bwd) == T and len(scatters) == 1,
          f"{kind}: {len(fwd)} forward / {len(bwd)} reverse levels and "
          f"{len(scatters)} scatters for T={T}")
    check(all(c[0][0] == kind for c in fwd) and
          all(c[0][0] == kind for c in bwd), f"{kind}: another kind ran")
    check(all(kw.get("live") == d.live[t] for t, (_c, kw) in enumerate(fwd)),
          f"{kind}: the forward levels got other live counts than the "
          f"schedule's")

    f_rows, f_err, f_abs = [], 0.0, 0.0
    with torch.no_grad():
        # Each level with the keywords the main path gave it, timed by
        # torch.profiler, every forward and reverse level in one session.
        levels = [(c[1:], kw) for c, kw in fwd]
        rels = []
        for lvl, kw in levels:
            err, rel = compare_level(kind, lvl, **kw)
            f_abs, f_err = max(f_abs, err), max(f_err, rel)
            rels.append(rel)
        b_rows = [k2_level(c, lambda c: cell_bound_ms(
            kind, (kind,) + c[0][1:2] + c[0][3:], True)) for c in bwd]
        times = fwd_times(levels, kind=kind, k2_rows=b_rows)
        for (case, kw), (ms, plain_ms, ev), rel in zip(fwd, times, rels):
            f_rows.append((ms, plain_ms) + cell_bound_ms(kind, case, False)
                          + (ev, rel, case[6] // M, kw["live"]))
        check(scatters[0][3] is d.ext_plan, f"{kind}: the step's scatter "
              f"did not get the schedule's plan")
        sc = k7_check(f"{kind} pulled rows", *scatters[0])
    T_all = len(f_rows)
    # Every Tree-FC level (nine); the chains' first two, middle and last.
    shown = f_rows if T_all <= 16 else (
        f_rows[:2] + f_rows[T_all // 2:T_all // 2 + 1] + f_rows[-1:])
    for r in shown:
        print(f"  {kind} forward level {r[-2]:2d} (live {r[-1]}): kernel "
              f"{r[0]:.4f} ms (events {r[7]:.4f}), plain {r[1]:.4f} ms, "
              f"bound {r[2]:.5f} ms by {r[3]} (fp32 FMA {r[6]:.5f}; "
              f"{r[4] / 1e9:.3f} GFLOP, {r[5] / 1e6:.2f} MB); error "
              f"{r[8]:.3e} of max |plain|")
    timed = [r for r in b_rows if r["live"]]
    n_b = len(timed)
    shown = b_rows[:1] + timed[:1] + timed[n_b // 2:n_b // 2 + 1] \
        + timed[-1:]
    for i, r in enumerate(shown):
        if all(r is not q for q in shown[:i]):
            k2_print(kind, r)
    bwd_s = k2_summary(b_rows)
    check(f_err <= TOL, f"{kind} forward kernel disagrees with its plain "
          f"version: {f_err:.3e} of max |plain| > {TOL}")
    check(bwd_s["max_rel_err"] <= TOL, f"{kind} reverse megastep disagrees "
          f"with its plain version: {bwd_s['max_rel_err']:.3e} of max "
          f"|plain| > {TOL}")
    check(bwd_s["max_launches_a_level"] <= 2, f"{kind}: K2 made "
          f"{bwd_s['max_launches_a_level']} CUDA launches on a level")
    fwd_s = {**_summary(f_rows), "max_rel_err": f_err, "max_abs_err": f_abs,
             "events_ms": float(np.mean([r[7] for r in f_rows])),
             "bound_fma_ms": float(np.mean([r[6] for r in f_rows])),
             "total_ms": float(sum(r[0] for r in f_rows)),
             "by_level": [{"level": r[-2], "live": r[-1], "ms": r[0],
                           "events_ms": r[7], "plain_ms": r[1],
                           "bound_ms": r[2], "bound_by": r[3],
                           "bound_fma_ms": r[6], "rel_err": r[8]}
                          for r in f_rows]}
    sm = fwd_s
    print(f"{kind} forward: {sm['levels']} levels, error "
          f"{sm['max_rel_err']:.3e} of max |plain| (max abs "
          f"{sm['max_abs_err']:.3e}); mean per launch: kernel "
          f"{sm['ms']:.4f} ms (device; events {sm['events_ms']:.4f}), "
          f"plain {sm['plain_ms']:.4f} ms, bound {sm['bound_ms']:.5f} ms by "
          f"{sm['bound_by']} (fp32 FMA {sm['bound_fma_ms']:.5f}); all levels "
          f"{sm['total_ms']:.4f} ms")
    sm = bwd_s
    print(f"{kind} reverse: {sm['levels']} levels "
          f"({sm['launching_levels']} launching), error "
          f"{sm['max_rel_err']:.3e} of max |plain| (max abs "
          f"{sm['max_abs_err']:.3e}); mean per launching level: device "
          f"{sm['ms']:.4f} ms (events {sm['events_ms']:.4f}), plain "
          f"{sm['plain_ms']:.4f} ms, bound {sm['bound_ms']:.5f} ms by "
          f"{sm['bound_by']} (fp32 FMA {sm['bound_fma_ms']:.5f})")

    ext_n = ext.clone().requires_grad_()
    lm.reset_launches()
    loss_n, none = cell_grads(fn, params, d, ext_n, h_lo, "none")
    check(lm.LAUNCHES["scatter_add_rows"] == T + 1,
          f"{kind}: {lm.LAUNCHES['scatter_add_rows']} scatter-add launches "
          f"in the op-by-op backward, designed {T + 1}")
    worst = max(rel_err(v, none[k]) for k, v in fused.items())
    check(abs(float(loss) - float(loss_n)) <= TOL * max(1.0, float(loss_n)),
          f"{kind}: fused loss {float(loss)} vs op-by-op {float(loss_n)}")
    check(worst <= TOL, f"{kind}: fused gradients vs op-by-op on the card: "
          f"{worst:.3e} > {TOL}")
    _, again = cell_grads(fn, params, d, ext.clone().requires_grad_(), h_lo)
    same = all(bitwise_equal(v, again[k]) for k, v in fused.items())
    check(same, f"{kind}: two backward passes of the same step differ")
    print(f"{kind}: fused vs op-by-op gradients: worst {worst:.3e} of max "
          f"|op-by-op| over {', '.join(fused)}; two backward passes bitwise "
          f"equal: {same}")
    return {"fwd": fwd_s, "bwd": bwd_s, "fused_vs_none": worst,
            "scatter": sc}


def cell_train_phase(phase: str, card: str) -> dict:
    """The main path of one phase: ``TRAIN_CELL_STEPS`` AdamW steps
    through ``execute_lazy`` on one packed batch, launch counts set to 0
    just before and read just after; then the level checks with the
    params AdamW has moved, and a profile of one warm step."""
    kind, fn, params, d, ext, h_lo, s = cell_setup(phase)
    opt = adamw_init(params)

    def step():
        loss, grads = cell_grads(fn, params, d, ext, h_lo)
        adamw_update(params, grads, opt, lr=1e-3, weight_decay=0.0)
        return float(loss)                       # waits for the step's work

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_CELL_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
    launches = dict(lm.LAUNCHES)
    fwd_cuda = lm.CUDA_LAUNCHES[f"{kind}_megastep"]
    peak = torch.cuda.max_memory_allocated()
    T, n = d.T, TRAIN_CELL_STEPS
    check(bool(np.isfinite(losses).all()), f"{phase}: non-finite losses")
    # The product where a slot has a child, the leaf launch past the live
    # count, at most 2 a level.
    designed = n * sum(fwd_designed(d.M, live) for live in d.live)
    check(fwd_cuda == designed <= 2 * n * T, f"{phase}: {fwd_cuda} "
          f"{kind}_megastep CUDA launches, designed {designed}")
    work, cuda = k2_design(d)
    want = {f"{kind}_megastep": n * T, f"{kind}_bwd_megastep": n * work,
            f"{kind}_bwd_megastep.cuda_launches": n * cuda,
            "scatter_add_rows": n}
    check(cuda <= 2 * work, f"{phase}: K2 designed {cuda} CUDA launches "
          f"for {work} levels (at most 2 a level)")
    check(launches == want, f"{phase}: launches {launches}, designed {want} "
          f"({n} steps of T={T} levels)")
    ms = np.asarray(step_s) * 1e3
    out = {"phase": phase, "kind": kind, "T": T, "M": d.M, "A": d.A,
           "steps": n, "loss_first": losses[0], "loss_last": losses[-1],
           "step_p50_ms": float(np.percentile(ms, 50)),
           "step_p99_ms": float(np.percentile(ms, 99)),
           "max_memory_allocated_bytes": int(peak), "launches": launches,
           "fwd_cuda_launches": fwd_cuda, "plan_ms": plan_build_ms(s),
           "card": card}
    print(f"{phase} losses: " + " ".join(f"{x:.6f}" for x in losses))
    print(f"{phase}: {json.dumps(out)}")
    out.update(cell_levels_check(kind, fn, params, d, ext, h_lo))
    out["profile"] = profile_step(f"{phase}, one warm step (T{T}xM{d.M})",
                                  step)
    return out


# ---------------------------------------------------------------------------
# Phases 9-12: continuous and decode serving (K6, K1/K3/K4 on new paths)
# ---------------------------------------------------------------------------

#: Continuous Tree-LSTM serving: arena rows and frontier lanes.
CONT_ROWS, CONT_WIDTH = 4096, 256
#: The LSTM-chain trace of ``benchmarks/bench_serving.py --full``: seed,
#: requests, Poisson rate (1/s), chain lengths; the two engines' sizes.
TRACE_SEED, TRACE_N, TRACE_RATE = 0, 400, 300.0
TRACE_LENGTHS = (4, 6, 8, 12, 16, 24, 32)
CHAIN_ROWS, CHAIN_WIDTH, CHAIN_BATCH = 1024, 64, 16
#: Decode ticks: slots and chains.
DECODE_SLOTS, DECODE_REQUESTS = 128, 256
#: Every TAP_EVERY-th tick of a tapped run is re-run, compared and timed.
TAP_EVERY = 8


def k6_bound_ms(n: int, rows: int, D: int, elem: int,
                writes: int = 1) -> tuple:
    """Least time for one row gather/scatter: ``n`` indices read, ``rows``
    rows of ``D`` elements read once and written ``writes`` times (K6a:
    to the card and into the host buffer), at 3.35 TB/s.  Returns
    (bound_ms, bytes)."""
    nbytes = 4 * n + (1 + writes) * rows * D * elem
    return nbytes / PEAK_BYTES * 1e3, nbytes


def _gather_case(R, D, n, gen, dtype=torch.float32, outside=0):
    """A K6a case: ``src`` on the card, ``n`` ids on the host (K6a takes
    them by value), the last ``outside`` of them outside ``[0, R)``."""
    src = torch.randn(R, D, generator=gen).to(dtype).to(DEVICE)
    idx = torch.randint(0, R, (n,), generator=gen, dtype=torch.int32)
    if outside:
        idx[n - outside:] = R + torch.arange(outside, dtype=torch.int32)
        idx[n - 1] = -1
    return src, idx


def host_rows_for(src, n: int) -> torch.Tensor:
    """A page-locked host buffer of ``n`` of ``src``'s rows (K6a's host
    destination)."""
    return lmgs.host_rows(max(n, 1), src.shape[1], src.dtype, True)


def _scatter_case(R, D, n, pads, gen, dtype=torch.float32):
    dst = torch.randn(R, D, generator=gen).to(dtype).to(DEVICE)
    live = torch.randperm(R, generator=gen)[:min(n - pads, R)] \
        .to(torch.int32)
    ids = torch.cat([live, R + torch.arange(pads, dtype=torch.int32)])
    rows = torch.randn(ids.numel(), D, generator=gen).to(dtype).to(DEVICE)
    return dst, ids.to(DEVICE), rows


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_gather(src, idx, label: str) -> float:
    """K6a against its plain version (on the same ids on the card), bit
    for bit on both destinations: the rows on the card and the rows it
    stored into a pinned host buffer; an id outside ``[0, R)`` a zero row;
    one launch per ``GATHER_CAP`` ids."""
    n = idx.numel()
    host = host_rows_for(src, n)
    n0 = lm.LAUNCHES["gather_rows"]
    got = lmgs.gather_rows(src, idx, host_out=host)
    live = ((idx >= 0) & (idx < src.shape[0])).to(DEVICE)
    rows = ref.gather_rows(src, torch.where(live, idx.to(DEVICE), 0))
    want = torch.where(live[:, None], rows, torch.zeros_like(rows))
    torch.cuda.synchronize()
    check(lm.LAUNCHES["gather_rows"] - n0 == -(-n // lmgs.GATHER_CAP),
          f"gather_rows ({label}): {lm.LAUNCHES['gather_rows'] - n0} "
          f"launches for {n} ids")
    check(torch.equal(_bits(got), _bits(want)),
          f"gather_rows differs from its plain version ({label})")
    check(torch.equal(_bits(host[:n]), _bits(got.cpu())),
          f"gather_rows: the host rows differ from the card's ({label})")
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def check_scatter(dst, ids, rows, label: str) -> float:
    """K6b against its plain version: bit for bit, and every row no live
    id names keeps its bits."""
    got = lmgs.scatter_rows(dst.clone(), ids, rows)
    want = ref.scatter_rows(dst.clone(), ids, rows)
    torch.cuda.synchronize()
    check(torch.equal(_bits(got), _bits(want)),
          f"scatter_rows differs from its plain version ({label})")
    live = ids[(ids >= 0) & (ids < dst.shape[0])].long()
    keep = torch.ones(dst.shape[0], dtype=torch.bool, device=dst.device)
    keep[live] = False
    check(torch.equal(_bits(got[keep]), _bits(dst[keep])),
          f"scatter_rows changed rows no id names ({label})")
    return float((got.float() - want.float()).abs().max())


#: Spin kernels launched at the start of each profiler session of
#: ``device_ms`` and left out of its sums.
PRIMER_LAUNCHES = 8

#: Seconds ``device_ms`` waits on the host after a profiler session opens,
#: before its first launch, and again after its last synchronize, before
#: the session closes.  The profiler drops a device event whose time falls
#: outside the session's window on the host's clock, and the card's
#: timestamps can trail the host's by more than a set takes to run late in
#: a long process: a session then loses its first events, primer and marks
#: included, and every retake lost the same ones.  A retake waits longer,
#: by the lag that the lost session showed.
PROFILER_GUARD_S = 0.01

#: The least ``kernel start - its launch's start`` (µs) of each
#: ``device_ms`` and ``profile_step`` session: below zero, the card's clock trails the host's
#: by at least as much.  ``main`` prints their range.
PROFILER_OFFSETS_US: list = []


def launch_offset_us(events) -> float | None:
    """The least time from a launch call's start to its kernel's start, in
    µs, over a session's events (``prof.events()``), pairing each device
    event with the host's launch call of the same correlation id; None
    where no pair was kept.  A kernel cannot start before its launch, so
    a negative value is a lag of the card's clock behind the host's."""
    launch = {e.id: e.time_range.start for e in events
              if e.device_type != torch.autograd.DeviceType.CUDA
              and "LaunchKernel" in e.name}
    offs = [e.time_range.start - launch[e.id] for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.id in launch]
    return min(offs) if offs else None


def profiler_guard_s() -> float:
    """The host's wait at a profiler session's ends: ``PROFILER_GUARD_S``,
    or 1.5 times the card's clock lag that the last session showed plus
    10 ms, whichever is the longer."""
    lag_us = max(0.0, -PROFILER_OFFSETS_US[-1]) if PROFILER_OFFSETS_US \
        else 0.0
    return max(PROFILER_GUARD_S, 1.5 * lag_us / 1e6 + 0.01)


def device_ms(sets: dict, reps: int = 5, parts_required: bool = True
              ) -> dict:
    """Device ms a call of each of a phase's timed sets, all in ONE
    ``torch.profiler`` session (one session a set, dozens a run, has left
    CUPTI recording nothing).  ``sets``: name → a list of calls (functions
    that launch work), or a dict with ``calls`` and any of ``reps``
    (default ``reps``), ``parts`` (name → kernel-name patterns; the set's
    value is then ``(ms, {part: ms})``), ``match`` (count only the kernels
    whose name holds it) and ``launches`` (the kernels a call launches,
    where that is known).  A launch shorter than the host's launch cost
    would be timed by the host with CUDA events, so this sums the card's
    own times.  The session waits ``PROFILER_GUARD_S`` on the host after
    it opens and before it closes, opens with ``PRIMER_LAUNCHES`` spin
    kernels (CUPTI can drop a session's first events) and puts one spin
    kernel before each set and one after the last: a set's events are
    those between its marks.  A session that lost events is taken again,
    four times at most, each time with a longer wait (at least twice the
    last, and 1.5 times the card's clock lag that the lost session showed
    plus 10 ms; the first wait allows for the lag of the session before):
    a set must keep every launch where ``launches`` is given, else at least
    99 % of one device operation a call (a loss that biases its mean low by
    as much).  Where five sessions lost events, sets without ``parts`` are
    timed by CUDA events (``time_ms``) instead, and the script says so;
    with ``parts_required`` False a set with ``parts`` is then timed so
    too, its parts ``None``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    specs = {k: v if isinstance(v, dict) else {"calls": v}
             for k, v in sets.items()}
    for sp in specs.values():
        for c in sp["calls"]:
            c()
    torch.cuda.synchronize()
    lost, guard = "", profiler_guard_s()
    for attempt in range(5):
        if attempt:
            print(f"device_ms: a profiler session lost events ({lost}); "
                  f"taken again after a wait of {guard * 1e3:.0f} ms")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(guard)
            for _ in range(PRIMER_LAUNCHES):
                torch.cuda._sleep(1000)
            for sp in specs.values():
                torch.cuda._sleep(1000)
                for _ in range(sp.get("reps", reps)):
                    for c in sp["calls"]:
                        c()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(guard)
        all_events = prof.events()
        offset = launch_offset_us(all_events)
        if offset is not None:
            PROFILER_OFFSETS_US.append(offset)
        lag_s = max(0.0, -offset) / 1e6 if offset is not None else 0.0
        events = sorted((e for e in all_events
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        guard = max(2 * guard, 1.5 * lag_s + 0.01)
        if len(marks) < len(specs) + 1:
            lost = (f"{len(marks)} spin kernels for {len(specs) + 1} marks; "
                    f"least launch-to-kernel time {offset} µs")
            continue
        marks = marks[len(marks) - len(specs) - 1:]
        out = {}
        for (name, sp), lo, hi in zip(specs.items(), marks, marks[1:]):
            evs = [e for e in events[lo + 1:hi]
                   if sp.get("match", "") in e.name]
            n = sp.get("reps", reps) * len(sp["calls"])
            want = n * sp["launches"] if "launches" in sp else n - n // 100
            if len(evs) < want:
                lost = (f"{len(evs)} device operations for {want} ({name}); "
                        f"least launch-to-kernel time {offset} µs")
                break
            ms = sum(e.self_device_time_total for e in evs) / 1e3 / n
            out[name] = ms if "parts" not in sp else (ms, {
                k: sum(e.self_device_time_total for e in evs
                       if any(p in e.name for p in pats)) / 1e3 / n
                for k, pats in sp["parts"].items()})
        else:
            return out
    check(not parts_required
          or not any("parts" in sp for sp in specs.values()),
          f"torch.profiler lost events in five sessions: {lost}")
    print(f"device_ms: torch.profiler lost events in five sessions "
          f"({lost}); timed with CUDA events instead, over back-to-back "
          f"calls (the host's launch cost included): "
          + ", ".join(map(str, specs)))
    out = {name: time_ms(lambda cs=sp["calls"]: [c() for c in cs],
                         n=sp.get("reps", reps), warmup=0)
           / len(sp["calls"]) for name, sp in specs.items()}
    return {name: (ms, None) if "parts" in specs[name] else ms
            for name, ms in out.items()}


def time_k6(op: str, cases) -> dict:
    """K6a (``op`` "gather", cases ``(src, idx)``, the ids on the host:
    the kernel takes them by value and stores the rows also into a pinned
    host buffer) or K6b ("scatter", cases ``(dst, ids, rows)``): device ms
    per call of the kernel, its plain version and the one PyTorch call
    (``index_select`` on the ids on the card; for the scatter
    ``index_copy_`` on the live lanes, since it cannot drop), each scatter
    on its own copy of ``dst``; the CUDA-event time of back-to-back kernel
    launches (bound by the host's launch cost); the mean data-aware
    bound."""
    kern, plain, lib, bounds = [], [], [], []
    for case in cases:
        if op == "gather":
            src, idx = case
            hb, di = host_rows_for(src, idx.numel()), idx.to(DEVICE)
            kern.append(lambda s=src, i=idx, h=hb:
                        lmgs.gather_rows(s, i, host_out=h))
            plain.append(lambda s=src, i=di: ref.gather_rows(s, i))
            lib.append(lambda s=src, i=di: torch.index_select(s, 0, i))
            bounds.append(k6_bound_ms(idx.numel(), idx.numel(),
                                      src.shape[1], src.element_size(), 2))
            continue
        dst, ids, rows = case
        live = (ids >= 0) & (ids < dst.shape[0])
        li, lr = ids[live].long(), rows[live]
        dk, dp, dl = dst.clone(), dst.clone(), dst.clone()
        kern.append(lambda d=dk, i=ids, r=rows: lmgs.scatter_rows(d, i, r))
        plain.append(lambda d=dp, i=ids, r=rows: ref.scatter_rows(d, i, r))
        lib.append(lambda d=dl, i=li, r=lr: d.index_copy_(0, i, r))
        bounds.append(k6_bound_ms(ids.numel(), int(live.sum()),
                                  dst.shape[1], dst.element_size()))
    t = device_ms({"kernel": kern, "plain": plain, "library": lib})
    return {"ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"],
            "issue_ms": float(np.mean([time_ms(k, 20, 3)
                                       for k in kern[:4]])),
            "bound_ms": float(np.mean([b[0] for b in bounds])),
            "bytes": float(np.mean([b[1] for b in bounds])),
            "launches_timed": len(cases), "bound_by": "bytes"}


def k6_phase() -> float:
    """K6a/K6b against their plain versions on the card, bit for bit: at
    the shapes the serving phases launch, a bf16 gather, rows whose width
    is not a multiple of 4 (every vector width), n = 1, K6a at its launch
    capacity and one past it (two launches), ids outside the rows, and
    pad lanes with out-of-range ids."""
    gen = torch.Generator().manual_seed(66)
    S = 2 * HIDDEN
    worst, rows = 0.0, []
    gathers = [("roots, tree arena", (CONT_ROWS + 1, S, 37, gen)),
               ("roots, chain arena", (CHAIN_ROWS + 1, S, 9, gen)),
               ("bf16", (CONT_ROWS + 1, S, 256, gen, torch.bfloat16)),
               ("D 1027", (300, 1027, 33, gen)),
               ("bf16 D 129", (300, 129, 33, gen, torch.bfloat16)),
               ("D 130", (300, 130, 33, gen)),
               ("n 1", (CONT_ROWS + 1, S, 1, gen)),
               ("capacity", (CONT_ROWS + 1, S, lmgs.GATHER_CAP, gen)),
               ("capacity + 1, bf16", (CONT_ROWS + 1, S,
                                       lmgs.GATHER_CAP + 1, gen,
                                       torch.bfloat16)),
               ("ids outside", (CONT_ROWS + 1, S, 9, gen, torch.float32,
                                3))]
    for label, args in gathers:
        src, idx = _gather_case(*args)
        worst = max(worst, check_gather(src, idx, label))
        rows.append(f"gather {label} (R {src.shape[0]}, D {src.shape[1]}, "
                    f"n {idx.numel()}, {src.dtype})")
    scatters = [("tree frontier", (CONT_ROWS + 1, S, CONT_WIDTH,
                                   CONT_WIDTH // 6, gen)),
                ("chain frontier", (CHAIN_ROWS + 1, S, CHAIN_WIDTH,
                                    CHAIN_WIDTH // 9, gen)),
                ("decode-width state", (2 * DECODE_SLOTS + 1, HIDDEN, 128, 3,
                                        gen)),
                ("D 1027 with pads", (300, 1027, 33, 5, gen)),
                ("bf16 D 130 with pads", (300, 130, 33, 5, gen,
                                          torch.bfloat16)),
                ("n 1", (CONT_ROWS + 1, S, 1, 0, gen)),
                ("n 1, a pad lane", (CONT_ROWS + 1, S, 1, 1, gen))]
    for label, args in scatters:
        dst, ids, src = _scatter_case(*args)
        worst = max(worst, check_scatter(dst, ids, src, label))
        rows.append(f"scatter {label} (R {dst.shape[0]}, D {dst.shape[1]}, "
                    f"n {ids.numel()}, {dst.dtype})")
    for r in rows:
        print(f"K6 vs plain, bit for bit: {r}")
    print(f"K6 vs plain: {len(rows)} cases bit-equal, untouched rows "
          f"bit-unchanged, max_abs_err {worst:.1e}")
    return worst


def cont_setup():
    """The continuous Tree-LSTM phase's model (the paper's tree_lstm at
    full width, weights from seed 0 with a nonzero bias), its head
    ``ClassificationHead(1024, 5)`` and the serving phase's traffic."""
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim)
    gen = torch.Generator().manual_seed(0)
    params = fn.init(gen, device=DEVICE)
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .to(DEVICE)
    head = ClassificationHead(fn.state_dim, 5)
    hp = head.init(gen, device=DEVICE)
    hp["b"] = (torch.randn(5, generator=gen) * 0.1).to(DEVICE)
    ds = sst_like_dataset(N_REQUESTS, input_dim=cfg.input_dim, seed=0)
    return fn, params, head, hp, ds


def cont_engine(fn, params, head, hp, rows, width, device=None, **kw):
    return ContinuousBatchEngine(
        fn, params, num_rows=rows, frontier_width=width, head=head,
        head_params=hp, device=DEVICE if device is None else device,
        policy=AdmissionPolicy(min_occupancy=0.0, max_window=8), **kw)


def _cont_requests(graphs, inputs):
    return [ContinuousRequest(i, g, x)
            for i, (g, x) in enumerate(zip(graphs, inputs))]


def frontier_taps(make_engine, reqs) -> tuple:
    """One run of a continuous engine with taps on ``ops.frontier_megastep``
    and ``ops.gather_rows`` that keep, for every ``TAP_EVERY``-th tick, the
    arena and the pulled-row arena as they were before the tick, and for
    the first 24 row gathers their source; every tick's contract
    (``ops.frontier_contract_holds``: its stored rows unique, none a row
    it reads) is checked on the card and read once, after the run.
    Returns ``(ticks, gathers, engine)``: a tick is ``(snapshot or None,
    child_ids, child_mask, node_mask, out_ids, ext_ids, weights)``."""
    ticks, gathers, held = [], [], []
    inner_f, inner_g = ops.frontier_megastep, ops.gather_rows

    def tap_f(k, buf, cids, cmask, rows, nm, out, w, *, ext_ids=None):
        snap = None
        if len(ticks) % TAP_EVERY == 0:
            snap = (buf.clone(), rows.clone())
        held.append(ops.frontier_contract_holds(cids, out, buf.shape[0]))
        ticks.append((snap, cids, cmask, nm, out, ext_ids, w))
        return inner_f(k, buf, cids, cmask, rows, nm, out, w,
                       ext_ids=ext_ids)

    def tap_g(src, idx, *, host_out=None):
        if len(gathers) < 24:
            gathers.append((src.clone(), torch.as_tensor(idx).clone()))
        return inner_g(src, idx, host_out=host_out)

    ops.frontier_megastep, ops.gather_rows = tap_f, tap_g
    try:
        eng = make_engine()
        for r in reqs:
            check(eng.submit(r), f"request {r.request_id} rejected: "
                  f"{r.error}")
        eng.run()
    finally:
        ops.frontier_megastep, ops.gather_rows = inner_f, inner_g
    check(len(ticks) == eng.ticks, f"tapped {len(ticks)} frontier ticks, "
          f"the engine ran {eng.ticks}")
    check(all(r.status == "ok" for r in reqs), "a tapped request failed")
    check(bool(torch.stack(held).all()), f"a frontier tick stores a row it "
          f"reads, or one row twice: {int((~torch.stack(held)).sum())} of "
          f"{len(held)} ticks break the contract")
    return ticks, gathers, eng


def retire_copies(eng, reqs, guard_s: float, primers: int) -> list:
    """The copies each retiring window of ``eng`` enqueues: ``reqs``
    submitted and run under ONE ``torch.profiler`` session, the engine's
    ``_retire`` and ``_release`` (the freed rows' zeroing, which copies
    their ids: not the readback) each in a ``record_function`` range.  Per
    window, over the runtime calls in ``_retire`` less those in
    ``_release``: ``api``, the copies the host enqueued
    (``cudaMemcpy*``); ``h2d``/``d2h``, the card's copy events of those
    calls by direction (paired by correlation id); ``k6a``, its
    ``gather_rows_kernel`` events (0 where the profiler lost the window's
    device events).  The session waits ``guard_s`` on the host at both
    ends and opens with ``primers`` spin kernels, as ``device_ms``'s do.
    Needs only ``time`` and ``torch``: ``tools/k1_parent_ab.py`` runs its
    source on an earlier checkout's engine too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for name in ("_retire", "_release"):
        inner = getattr(eng, name)

        def wrapped(acts, inner=inner, tag=f"window{name}"):
            with record_function(tag):
                return inner(acts)

        setattr(eng, name, wrapped)
    for r in reqs:
        if not eng.submit(r):
            raise RuntimeError(f"request {r.request_id} rejected: {r.error}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(guard_s)
        for _ in range(primers):
            torch.cuda._sleep(1000)
        eng.run()
        torch.cuda.synchronize()
        time.sleep(guard_s)
    evs = prof.events()
    on_card = {}
    for e in evs:
        if e.device_type == DeviceType.CUDA:
            on_card.setdefault(e.id, []).append(e.name)
    calls = [e for e in evs if e.device_type != DeviceType.CUDA
             and e.name.startswith("cuda")]

    def ranges(tag):          # the host's ranges, not the card's copies
        return [e.time_range for e in evs if e.name == tag
                and e.device_type != DeviceType.CUDA]

    releases, out = ranges("window_release"), []
    for w in ranges("window_retire"):
        mine = [c for c in calls
                if w.start <= c.time_range.start <= w.end
                and not any(r.start <= c.time_range.start <= r.end
                            for r in releases)]
        names = [n for c in mine for n in on_card.get(c.id, [])]
        out.append({"api": sum("Memcpy" in c.name for c in mine),
                    "h2d": sum("HtoD" in n for n in names),
                    "d2h": sum("DtoH" in n for n in names),
                    "k6a": sum("gather_rows_kernel" in n for n in names)})
    return out


def check_window_copies(label: str, make_engine, reqs, head: bool) -> dict:
    """``retire_copies`` on a fresh engine: every retiring window makes no
    host→device copy and at most one device→host copy (the head's
    logits; none without a head), and the card's events of at least one
    window were kept."""
    eng = make_engine()
    per = retire_copies(eng, reqs, profiler_guard_s(), PRIMER_LAUNCHES)
    seen = [w for w in per if w["k6a"]]
    check(len(per) == eng.readbacks and per, f"{label}: profiled "
          f"{len(per)} retiring windows of {eng.readbacks}")
    check(all(w["api"] <= int(head) and w["h2d"] == 0 and w["d2h"] <= 1
              for w in per), f"{label}: a retiring window copies more than "
          f"the head's logits: {[w for w in per if w['api'] > int(head)][:3]}")
    check(bool(seen), f"{label}: the profiler kept no retiring window's "
          f"device events")
    out = {"windows": len(per), "windows_seen": len(seen),
           "h2d": max(w["h2d"] for w in per),
           "d2h": max(w["d2h"] for w in per),
           "copies_enqueued": max(w["api"] for w in per)}
    print(f"{label}: retiring windows under the profiler: {json.dumps(out)} "
          f"(the most in any window; the parent's made 1 host->device and "
          f"2 device->host copies a window)")
    return out


def tapped_frontier_run(kind, make_engine, reqs) -> dict:
    """``frontier_taps``, then each kept tick re-run through the frontier
    megastep of ``kind`` (the rows stored at ``out_ids``: one launch) and
    each gather through K6a, against their plain versions; device times,
    the bounds and (K6a) the library call.  The two-launch composition
    the tick folds is timed beside it by ``tools/k1_parent_ab.py ... k6b``
    from the earlier commit's own sources."""
    ticks, gathers, eng = frontier_taps(make_engine, reqs)
    R = eng.num_rows + 1
    name = f"{kind}_megastep"
    k_rows, fold, plain = [], [], []
    worst_k, worst_g, kept = 0.0, 0.0, 0
    for snap, cids, cmask, nm, out, eids, w in ticks:
        if snap is None:
            continue
        arena, ext = snap
        n0 = lm.CUDA_LAUNCHES[name]
        got = lm.MEGASTEPS[kind](arena.clone(), cids, eids, nm, 0, ext, *w,
                                 out_ids=out)
        again = lm.MEGASTEPS[kind](arena.clone(), cids, eids, nm, 0, ext,
                                   *w, out_ids=out)
        want = ref.frontier_megastep(kind, arena.clone(), cids, cmask,
                                     ext.index_select(0, eids), nm, out, w)
        torch.cuda.synchronize()
        check(lm.CUDA_LAUNCHES[name] - n0 == 2, f"{kind} frontier tick: "
              f"{lm.CUDA_LAUNCHES[name] - n0} CUDA launches for two ticks")
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        worst_k = max(worst_k, err)
        check(err <= TOL * scale, f"{kind} frontier megastep disagrees "
              f"with its plain version: {err:.3e} > {TOL} x max |plain| "
              f"{scale:.3e}")
        check(bitwise_equal(got, again), f"{kind} frontier megastep: two "
              f"launches on the same tick differ")
        named = torch.zeros(R, dtype=torch.bool, device=arena.device)
        named[out[(out >= 0) & (out < R)].long()] = True
        check(bitwise_equal(got[~named], arena[~named]),
              f"{kind} frontier megastep changed rows no lane names")
        kept += 1
        fb, pb = arena.clone(), arena.clone()
        fold.append(lambda fb=fb, c=(cids, eids, nm, ext, out, w):
                    lm.MEGASTEPS[kind](fb, c[0], c[1], c[2], 0, c[3], *c[5],
                                       out_ids=c[4]))
        plain.append(lambda pb=pb, c=(cids, cmask, ext.index_select(0, eids),
                                      nm, out, w):
                     ref.frontier_megastep(kind, pb, *c))
        case = (arena, cids, cmask, eids, nm, 0, ext, w)
        b = bound_ms(case) if kind == "treelstm" \
            else cell_bound_ms(kind, (kind,) + case, False)
        k_rows.append((time_ms(fold[-1], 10, 2), b[0], b[1],
                       int((nm > 0).sum())))
    for src, idx in gathers:
        worst_g = max(worst_g, check_gather(src, idx, "retired roots"))
    mean = lambda rs, k: float(np.mean([r[k] for r in rs]))  # noqa: E731
    dev_ms = device_ms({"kernel": {"calls": fold,
                                   "match": FWD_KERNELS[kind][1],
                                   "launches": 1},
                        "plain": {"calls": plain, "reps": 2}})
    k = {"levels": kept, "max_abs_err": worst_k, "ms": dev_ms["kernel"],
         "events_ms": mean(k_rows, 0),
         "plain_ms": dev_ms["plain"], "bound_ms": mean(k_rows, 1),
         "bound_by": max({r[2] for r in k_rows},
                         key=lambda by: sum(r[1] for r in k_rows
                                            if r[2] == by)),
         "live_lanes": mean(k_rows, 3), "contract_ticks": len(ticks)}
    ga = {**time_k6("gather", gathers), "max_abs_err": worst_g,
          "n_mean": float(np.mean([i.numel() for _s, i in gathers]))}
    print(f"{kind} frontier ticks (the contract held on all {len(ticks)}; "
          f"every {TAP_EVERY}th re-run, {k['live_lanes']:.1f} live lanes "
          f"of {ticks[0][1].shape[0]} on average): the megastep storing at "
          f"out_ids {k['ms']:.4f} ms device (events {k['events_ms']:.4f}; "
          f"one CUDA launch), plain {k['plain_ms']:.4f} ms, bound "
          f"{k['bound_ms']:.5f} ms by {k['bound_by']}, max_abs_err "
          f"{worst_k:.3e}; gather_rows of the retired roots "
          f"({len(gathers)} launches, n {ga['n_mean']:.1f} on average) "
          f"{ga['ms']:.4f} ms, plain {ga['plain_ms']:.4f} ms, index_select "
          f"{ga['library_ms']:.4f} ms, bound {ga['bound_ms']:.5f} ms, "
          f"back-to-back launches {ga['issue_ms']:.4f} ms apart")
    return {"megastep": k, "gather": ga, "ticks": len(ticks)}


def _latencies_ms(reqs) -> np.ndarray:
    return np.asarray([(r._finished_at - r._enqueued_at) * 1e3
                       for r in reqs])


def continuous_tree_phase(card: str) -> dict:
    """The continuous Tree-LSTM path: 512 SST-like parses submitted at
    once to ``ContinuousBatchEngine`` with a classification head; first a
    tapped run for the per-launch checks and times, then the main path
    with the launch counts set to 0 just before and read just after;
    roots against solo scoring on the card and the plain path on the CPU,
    head logits likewise."""
    fn, params, head, hp, ds = cont_setup()
    tapped = tapped_frontier_run(
        "treelstm",
        lambda: cont_engine(fn, params, head, hp, CONT_ROWS, CONT_WIDTH),
        _cont_requests(ds.graphs, ds.inputs))

    eng = cont_engine(fn, params, head, hp, CONT_ROWS, CONT_WIDTH)
    reqs = _cont_requests(ds.graphs, ds.inputs)
    for r in reqs:
        check(eng.submit(r), f"request {r.request_id} rejected: {r.error}")
    torch.cuda.synchronize()
    lm.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    h = eng.health()
    check(all(r.status == "ok" for r in reqs),
          f"{sum(r.status != 'ok' for r in reqs)} request(s) not ok: "
          f"{[r.error for r in reqs if r.status != 'ok'][:3]}")
    check(h["degradations"] == 0 and not h["breaker_open"],
          f"degradations {h['degradations']}, breaker {h['breaker_open']}")
    want = {"treelstm_megastep": eng.ticks, "gather_rows": eng.readbacks}
    check(launches == want, f"continuous launches {launches}, designed "
          f"{want} (one megastep a tick, which stores the lanes' rows: no "
          f"row scatter; one row gather a retiring window)")
    check(lm.CUDA_LAUNCHES["treelstm_megastep"] == eng.ticks,
          f"{lm.CUDA_LAUNCHES['treelstm_megastep']} K1 CUDA launches for "
          f"{eng.ticks} ticks (one a tick: the frontier has no live count)")
    check(tapped["ticks"] == eng.ticks, f"tapped run {tapped['ticks']} "
          f"ticks, main path {eng.ticks}")
    roots = np.stack([r.root_state for r in reqs])
    logits = np.stack([r.logits for r in reqs])
    check(roots.shape == (N_REQUESTS, fn.state_dim)
          and bool(np.isfinite(roots).all())
          and bool(np.isfinite(logits).all()), "bad roots or logits")

    solo = StructureServeEngine(fn, params, batch_size=1, compose=False,
                                device=DEVICE)
    sreqs = _requests(ds)
    for r in sreqs:
        solo.submit(r)
    solo.run()
    solo_roots = np.stack([r.root_state for r in sreqs])
    err_solo = float(np.abs(roots - solo_roots).max())
    bitwise = int(sum(np.array_equal(a.view(np.int32), b.view(np.int32))
                      for a, b in zip(roots, solo_roots)))
    with torch.no_grad():
        solo_logits = head.logits(hp, torch.from_numpy(solo_roots)
                                  .to(DEVICE)).cpu().numpy()
    err_logits = float(np.abs(logits - solo_logits).max())
    check(err_solo <= TOL, f"continuous roots vs solo scoring on the card: "
          f"{err_solo:.3e} > {TOL}")
    check(err_logits <= TOL, f"head logits vs the solo roots' logits: "
          f"{err_logits:.3e} > {TOL}")

    n_cpu = 64
    cpu_p = {k: v.cpu() for k, v in params.items()}
    cpu_h = {k: v.cpu() for k, v in hp.items()}
    ceng = cont_engine(fn, cpu_p, head, cpu_h, CONT_ROWS, CONT_WIDTH,
                       device="cpu")
    creqs = _cont_requests(ds.graphs[:n_cpu], ds.inputs[:n_cpu])
    for r in creqs:
        ceng.submit(r)
    ceng.run()
    err_cpu = float(np.abs(roots[:n_cpu] - np.stack(
        [r.root_state for r in creqs])).max())
    err_cpu_logits = float(np.abs(logits[:n_cpu] - np.stack(
        [r.logits for r in creqs])).max())
    check(err_cpu <= TOL and err_cpu_logits <= TOL,
          f"card vs CPU plain path: roots {err_cpu:.3e}, logits "
          f"{err_cpu_logits:.3e} > {TOL}")

    lat = _latencies_ms(reqs)
    out = {"requests": len(reqs), "requests_per_s": len(reqs) / wall,
           "wall_s": wall, "ticks": eng.ticks, "windows": eng.windows,
           "mean_lanes_per_tick": eng.lanes / eng.ticks,
           "lanes": CONT_WIDTH,
           "latency_p50_ms": float(np.percentile(lat, 50)),
           "latency_p99_ms": float(np.percentile(lat, 99)),
           "plan_hits": h["plan_hits"], "plan_misses": h["plan_misses"],
           "launches": launches, "err_vs_solo": err_solo,
           "roots_bitwise_equal_to_solo": bitwise,
           "err_logits": err_logits, "err_vs_cpu": err_cpu,
           "err_logits_vs_cpu": err_cpu_logits, "card": card}
    print(f"continuous tree_lstm: {json.dumps(out)}")
    from repro_torch.obs import trace
    eng_t = cont_engine(fn, params, head, hp, CONT_ROWS, CONT_WIDTH)
    with trace.install_tracer(trace.Tracer()) as tracer:
        t0 = time.perf_counter()
        _drain(eng_t, _cont_requests(ds.graphs, ds.inputs))
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans = {}
    for sp in tracer.snapshot():
        if sp.ph == "X":
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.dur_ms
    print(f"host spans of the same {len(ds.graphs)} parses, traced (the tracer "
          f"synchronises each window), {traced_ms:.1f} ms in all (ms, nested "
          f"spans inside cb.tick): " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(spans.items(),
                                                key=lambda kv: -kv[1])))
    profile_step(f"continuous tree_lstm, 128 parses through a fresh engine",
                 lambda: _drain(cont_engine(fn, params, head, hp, CONT_ROWS,
                                            CONT_WIDTH),
                                _cont_requests(ds.graphs[:128],
                                               ds.inputs[:128])))
    copies = check_window_copies(
        "continuous tree_lstm, 64 parses",
        lambda: cont_engine(fn, params, head, hp, CONT_ROWS, CONT_WIDTH),
        _cont_requests(ds.graphs[:64], ds.inputs[:64]), head=True)
    return {**out, **tapped, "window_copies": copies}


def _drain(eng, reqs) -> int:
    for r in reqs:
        eng.submit(r)
    eng.run()
    return sum(r.status == "ok" for r in reqs)


def poisson_trace(seed: int, n: int, rate_hz: float, lengths):
    """The seeded Poisson trace of ``benchmarks/bench_serving.py``:
    arrival offsets (s) and chain lengths, from one generator."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    lens = rng.choice(np.asarray(lengths), size=n)
    return arrivals, lens


def trace_requests(cls, lens, input_dim: int):
    """One request per chain length, inputs ``0.3 * N(0, 1)`` from seed
    ``TRACE_SEED + 1``, as the benchmark draws them."""
    rng = np.random.default_rng(TRACE_SEED + 1)
    return [cls(i, chain(int(L)), rng.standard_normal((int(L), input_dim))
                .astype(np.float32) * 0.3) for i, L in enumerate(lens)]


def replay(eng, reqs, arrivals, max_wall_s: float = 120.0):
    """Replay the trace in real time: submit each request at its arrival
    offset, stepping the engine in between.  Returns (latencies ms,
    makespan s)."""
    n, i = len(reqs), 0
    t0 = time.monotonic()
    while True:
        now = time.monotonic() - t0
        while i < n and arrivals[i] <= now:
            eng.submit(reqs[i])
            i += 1
        live = eng.step()
        if i >= n and live == 0:
            break
        if live == 0 and i < n:
            time.sleep(min(0.001, max(0.0, arrivals[i]
                                      - (time.monotonic() - t0))))
        check(time.monotonic() - t0 <= max_wall_s, "trace replay exceeded "
              f"{max_wall_s} s")
    makespan = time.monotonic() - t0
    check(all(r.status == "ok" for r in reqs),
          f"{sum(r.status != 'ok' for r in reqs)} trace request(s) not ok")
    return _latencies_ms(reqs), makespan


def chain_setup():
    cfg = get_paper_model("var_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim)
    gen = torch.Generator().manual_seed(0)
    params = fn.init(gen, device=DEVICE)
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .to(DEVICE)
    return fn, params, gen


def chain_serving_phase(card: str) -> dict:
    """The LSTM-chain trace replayed in real time against
    ``StructureServeEngine(batch_size=16)`` and
    ``ContinuousBatchEngine(num_rows=1024, frontier_width=64)``, each
    warmed on a short preamble; the continuous roots against solo scoring
    on the card; the token readout's tokens against a replay of its
    requests in another order; a tapped run of the same chains submitted
    at once for the K3 frontier and K6 checks and times."""
    fn, params, gen = chain_setup()
    X = fn.input_dim
    arrivals, lens = poisson_trace(TRACE_SEED, TRACE_N, TRACE_RATE,
                                   TRACE_LENGTHS)

    def warm(eng, cls):
        g = np.random.default_rng(99)
        for j, L in enumerate(TRACE_LENGTHS):
            eng.submit(cls(1000 + j, chain(int(L)), g.standard_normal(
                (int(L), X)).astype(np.float32)))
        eng.run()

    results = {}
    for name, make, cls in (
            ("structure", lambda: StructureServeEngine(
                fn, params, batch_size=CHAIN_BATCH, device=DEVICE),
             StructureRequest),
            ("continuous", lambda: cont_engine(fn, params, None, None,
                                               CHAIN_ROWS, CHAIN_WIDTH),
             ContinuousRequest)):
        eng = make()
        warm(eng, cls)
        reqs = trace_requests(cls, lens, X)
        ticks0 = getattr(eng, "ticks", 0)
        reads0 = getattr(eng, "readbacks", 0)
        torch.cuda.synchronize()
        lm.reset_launches()
        lat, makespan = replay(eng, reqs, arrivals)
        launches = dict(lm.LAUNCHES)
        results[name] = {
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(reqs) / makespan, "makespan_s": makespan,
            "launches": launches}
        if name == "continuous":
            ticks = eng.ticks - ticks0
            want = {"lstm_megastep": ticks,
                    "gather_rows": eng.readbacks - reads0}
            check(launches == want, f"continuous chain launches "
                  f"{launches}, designed {want} (one megastep a tick, no "
                  f"row scatter)")
            check(lm.CUDA_LAUNCHES["lstm_megastep"] == ticks,
                  f"{lm.CUDA_LAUNCHES['lstm_megastep']} K3 CUDA launches "
                  f"for {ticks} continuous chain ticks (one a tick)")
            h = eng.health()
            check(h["degradations"] == 0, "continuous chain degraded")
            results[name].update(ticks=ticks, plan_hits=h["plan_hits"],
                                 plan_misses=h["plan_misses"])
            cont_reqs = reqs
    s, c = results["structure"], results["continuous"]
    ratios = {"throughput_gain": c["requests_per_s"] / s["requests_per_s"],
              "p50_ratio": c["latency_p50_ms"] / s["latency_p50_ms"],
              "p99_ratio": c["latency_p99_ms"] / s["latency_p99_ms"]}

    solo = StructureServeEngine(fn, params, batch_size=1, compose=False,
                                device=DEVICE)
    sreqs = trace_requests(StructureRequest, lens, X)
    for r in sreqs:
        solo.submit(r)
    solo.run()
    roots = np.stack([r.root_state for r in cont_reqs])
    solo_roots = np.stack([r.root_state for r in sreqs])
    err_solo = float(np.abs(roots - solo_roots).max())
    bitwise = int(sum(np.array_equal(a.view(np.int32), b.view(np.int32))
                      for a, b in zip(roots, solo_roots)))
    check(err_solo <= TOL, f"continuous chain roots vs solo scoring: "
          f"{err_solo:.3e} > {TOL}")

    tr = TokenReadout(fn, vocab=1000)
    tp = tr.init(gen, device=DEVICE)

    def tokens(order):
        eng = cont_engine(fn, params, None, None, CHAIN_ROWS, CHAIN_WIDTH,
                          token_readout=tr, token_params=tp,
                          max_new_tokens=16, seed=0)
        base = trace_requests(ContinuousRequest, lens[:8], X)
        reqs = [base[i] for i in order]
        _drain(eng, reqs)
        check(all(r.status == "ok" for r in reqs), "token request failed")
        return {r.request_id: r.tokens for r in reqs}

    first = tokens(range(8))
    second = tokens([5, 2, 7, 0, 3, 6, 1, 4])
    check(first == second and all(len(t) == 16 for t in first.values()),
          "token readout tokens depend on the order requests ran in")

    tapped = tapped_frontier_run(
        "lstm", lambda: cont_engine(fn, params, None, None, CHAIN_ROWS,
                                    CHAIN_WIDTH),
        trace_requests(ContinuousRequest, lens, X))
    unfused = unfused_continuous(fn, params, lens, roots)
    copies = check_window_copies(
        "continuous lstm chains, 64 of the trace",
        lambda: cont_engine(fn, params, None, None, CHAIN_ROWS, CHAIN_WIDTH),
        trace_requests(ContinuousRequest, lens[:64], X), head=False)
    out = {"requests": TRACE_N, "rate_per_s": TRACE_RATE, **results,
           **ratios, "err_vs_solo": err_solo,
           "roots_bitwise_equal_to_solo": bitwise,
           "tokens_order_independent": True, "unfused": unfused,
           "window_copies": copies, "card": card}
    print(f"continuous lstm chains vs structure serving: {json.dumps(out)}")
    return {**out, **tapped}


def unfused_continuous(fn, params, lens, fused_roots) -> dict:
    """The trace's chains submitted at once to the continuous engine's
    op-by-op leg (``fusion_mode="none"``): each tick gathers its children,
    runs the cell in plain ops and scatters the states by one K6b launch,
    the main path of K6b since the fused tick stores its rows itself.
    Launch counts set to 0 just before and read just after: one row
    scatter a tick, one row gather a retiring window; roots within 1e-4 of
    the fused engine's on the trace.  A tap on ``ops.scatter_rows`` keeps
    every ``TAP_EVERY``-th tick's arena, ids and rows, on which K6b is
    then checked bit for bit against its plain version and timed beside
    it, its bound and ``index_copy_``."""
    eng = cont_engine(fn, params, None, None, CHAIN_ROWS, CHAIN_WIDTH,
                      fusion_mode="none")
    reqs = trace_requests(ContinuousRequest, lens, fn.input_dim)
    for r in reqs:
        check(eng.submit(r), f"request {r.request_id} rejected: {r.error}")
    cases, seen, inner = [], [0], ops.scatter_rows

    def tap(dst, idx, rows):
        if seen[0] % TAP_EVERY == 0:
            cases.append((dst.clone(), idx, rows.clone()))
        seen[0] += 1
        return inner(dst, idx, rows)

    torch.cuda.synchronize()
    lm.reset_launches()
    ops.scatter_rows = tap
    try:
        t0 = time.perf_counter()
        eng.run()
        wall = time.perf_counter() - t0
    finally:
        ops.scatter_rows = inner
    launches = dict(lm.LAUNCHES)
    check(all(r.status == "ok" for r in reqs) and not eng.fused,
          "an unfused continuous chain request failed")
    want = {"scatter_rows": eng.ticks, "gather_rows": eng.readbacks}
    check(launches == want, f"unfused continuous chain launches "
          f"{launches}, designed {want}")
    err = float(np.abs(np.stack([r.root_state for r in reqs])
                       - fused_roots).max())
    check(err <= TOL, f"unfused continuous roots vs the fused engine's: "
          f"{err:.3e} > {TOL}")
    worst = max(check_scatter(d, i, r, "unfused chain tick")
                for d, i, r in cases)
    sc = {**time_k6("scatter", cases), "max_abs_err": worst,
          "n_mean": float(np.mean([i.numel() for _d, i, _r in cases])),
          "live_mean": float(np.mean([int(((i >= 0) & (i < d.shape[0]))
                                          .sum()) for d, i, _r in cases]))}
    out = {"requests": len(reqs), "ticks": eng.ticks, "launches": launches,
           "requests_per_s": len(reqs) / wall, "err_vs_fused": err}
    print(f"unfused continuous lstm chains: {json.dumps(out)}")
    print(f"scatter_rows at the unfused chain ticks ({len(cases)} kept of "
          f"{eng.ticks}, n {sc['n_mean']:.1f}, {sc['live_mean']:.1f} live "
          f"lanes on average): {sc['ms']:.4f} ms device, plain "
          f"{sc['plain_ms']:.4f} ms, index_copy_ {sc['library_ms']:.4f} ms, "
          f"bound {sc['bound_ms']:.5f} ms ({sc['bytes'] / 1e6:.3f} MB), "
          f"back-to-back launches {sc['issue_ms']:.4f} ms apart, "
          f"max_abs_err {worst:.3e}")
    return {**out, "scatter": sc}


def decode_setup(cell: str, impl: str = "jnp"):
    """The decode phases' cell (``LSTMVertex`` with ``cell_impl`` ``impl``,
    or ``GRUVertex``) at full width, its params (seed 0, the bias drawn
    nonzero) and its 256 Var-LSTM chains (seed 0, ``max_len=64``) with
    seeded normal inputs."""
    cfg = get_paper_model("var_lstm")
    fn = (cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim, impl=impl)
          if cell == "lstm" else GRUVertex(input_dim=cfg.input_dim,
                                           hidden=HIDDEN))
    gen = torch.Generator().manual_seed(0)
    params = fn.init(gen, device=DEVICE)
    params["b"] = (torch.randn(params["b"].shape, generator=gen) * 0.1) \
        .to(DEVICE)
    rng = np.random.default_rng(0)
    graphs = cfg.make_graphs(DECODE_REQUESTS, max_len=64, rng=rng)
    xs = [rng.standard_normal((g.num_nodes, cfg.input_dim))
          .astype(np.float32) for g in graphs]
    return fn, params, graphs, xs


def decode_finals(fn, params, graphs, xs) -> np.ndarray:
    """Each chain's final state from ``execute`` over all the chains on
    the card (the fused leg unless ``REPRO_FUSION`` says otherwise)."""
    s = pack_batch(graphs, with_runs=False)
    d = s.to_device(DEVICE)
    ext = torch.from_numpy(pack_external(xs, s, fn.input_dim)).to(DEVICE)
    with torch.no_grad():
        nodes = readout_nodes(execute(fn, params, d, ext).buf, d) \
            .cpu().numpy()
    return np.stack([nodes[k, g.num_nodes - 1] for k, g in enumerate(graphs)])


def decode_phase(cell: str, card: str) -> dict:
    """``VertexServeEngine`` decode ticks: 256 Var-LSTM chains (seed 0,
    ``max_len=64``) with seeded normal inputs submitted at once to 128
    slots; one K3/K4 launch per tick; final states against ``execute``
    over the same chains on the card and the plain path on the CPU; then
    a tapped run whose every ``TAP_EVERY``-th tick is re-run through the
    kernel and its plain version and timed."""
    kind = "lstm" if cell == "lstm" else "gru"
    fn, params, graphs, xs = decode_setup(cell)

    def reqs_of(n):
        return [VertexRequest(i, x) for i, x in enumerate(xs[:n])]

    eng = VertexServeEngine(fn, params, num_slots=DECODE_SLOTS,
                            device=DEVICE)
    reqs = reqs_of(DECODE_REQUESTS)
    for r in reqs:
        check(eng.submit(r), f"decode request rejected: {r.error}")
    torch.cuda.synchronize()
    lm.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    check(all(r.status == "ok" for r in reqs), "a decode request failed")
    check(launches == {f"{kind}_megastep": eng.ticks},
          f"decode launches {launches} for {eng.ticks} ticks")
    finals = np.stack([r.final_state for r in reqs])

    err_exec = float(np.abs(finals - decode_finals(fn, params, graphs, xs))
                     .max())
    n_cpu = 32
    ceng = VertexServeEngine(fn, {k: v.cpu() for k, v in params.items()},
                             num_slots=n_cpu, device="cpu")
    creqs = reqs_of(n_cpu)
    _drain(ceng, creqs)
    err_cpu = float(np.abs(finals[:n_cpu] - np.stack(
        [r.final_state for r in creqs])).max())
    check(err_exec <= TOL and err_cpu <= TOL, f"decode final states vs "
          f"execute {err_exec:.3e}, vs the CPU {err_cpu:.3e} > {TOL}")

    taps, inner = [], ops.level_megastep

    def tap(k, buf, *args, **kw):
        if eng2.ticks % TAP_EVERY == 0:
            taps.append((buf.clone(),) + args)
        return inner(k, buf, *args, **kw)

    ops.level_megastep = tap
    try:
        eng2 = VertexServeEngine(fn, params, num_slots=DECODE_SLOTS,
                                 device=DEVICE)
        _drain(eng2, reqs_of(DECODE_REQUESTS))
    finally:
        ops.level_megastep = inner
    # Each kept tick as the engine launched it (no live count: the grid
    # covers every slot), against its plain version, then timed by
    # torch.profiler, every tick in one session, CUDA events beside.
    worst = max(compare_level(kind, case)[0] for case in taps)
    check(worst <= TOL, f"decode {kind} megastep vs plain: {worst:.3e}")
    ticks = [(case, {}) for case in taps]
    times = fwd_times(ticks, kind=kind)
    rows = [(ms, plain_ms) + cell_bound_ms(kind, (kind,) + case, False)
            + (ev, int((case[4] > 0).sum()))
            for case, (ms, plain_ms, ev) in zip(taps, times)]
    out = {"cell": cell, "kind": kind, "requests": DECODE_REQUESTS,
           "slots": DECODE_SLOTS, "ticks": eng.ticks,
           "ticks_per_s": eng.ticks / wall, "wall_s": wall,
           "launches": launches, "err_vs_execute": err_exec,
           "err_vs_cpu": err_cpu, "card": card,
           "tick": {"timed": len(rows), "max_abs_err": worst,
                    **_summary(rows),
                    "events_ms": float(np.mean([r[7] for r in rows])),
                    "bound_fma_ms": float(np.mean([r[6] for r in rows])),
                    "live_slots": float(np.mean([r[8] for r in rows]))}}
    t = out["tick"]
    print(f"decode {cell}: {json.dumps(out)}")
    print(f"decode {cell} ticks at M {DECODE_SLOTS} ({t['timed']} timed, "
          f"{t['live_slots']:.1f} live slots on average): {kind}_megastep "
          f"{t['ms']:.4f} ms device (events {t['events_ms']:.4f}), plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
          f"{t['bound_by']} (fp32 FMA {t['bound_fma_ms']:.5f})")
    profile_step(f"decode {cell}, 256 chains through a fresh engine",
                 lambda: _drain(VertexServeEngine(
                     fn, params, num_slots=DECODE_SLOTS, device=DEVICE),
                     reqs_of(DECODE_REQUESTS)))
    return out


# ---------------------------------------------------------------------------
# Phase 13: the op-by-op leg (K8a/K8b/K9): the kernel-fusion ablation and
# the serial baseline
# ---------------------------------------------------------------------------

#: Kernel-vs-plain shapes: K8a (M, H), K8b (M, A, H), K9 (M, H).
K8A_SHAPES = ((1, 8), (37, 50), (200, 130), (128, 512))
K8B_SHAPES = ((5, 2, 16), (64, 3, 40), (130, 2, 128), (256, 2, 512))
K9_SHAPES = ((3, 16), (64, 64), (130, 128), (128, 512))
#: Parses of the serving traffic scored by the serial baseline.
SERIAL_GRAPHS = 8
GATE_TOL, BF16_TOL = 1e-5, 3e-2
#: The TPU kernel each gate kernel replaces, and its source here.
GATE_KERNELS = {
    "lstm_gates": ("src/repro/kernels/cell_kernels.py:46", "cell_gates.cu"),
    "treelstm_gates": ("src/repro/kernels/cell_kernels.py:86",
                       "cell_gates.cu"),
    "lstm_level_fused": ("src/repro/kernels/level_step.py:53",
                         "cell_megastep_sm90.cu"),
}
GATE_WRAPPERS = {"lstm_gates": ck, "treelstm_gates": ck,
                 "lstm_level_fused": ls}


@contextlib.contextmanager
def tapped(name: str):
    """Within the block, every call of the kernel wrapper ``name`` keeps
    its arguments (in the yielded list) and then calls the wrapper: the
    tap launches nothing of its own."""
    module = GATE_WRAPPERS[name]
    inner, calls = getattr(module, name), []

    def tap(*args):
        calls.append(args)
        return inner(*args)

    setattr(module, name, tap)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def gate_kernel(name: str):
    return getattr(GATE_WRAPPERS[name], name)


def gate_check(name: str, args, bf16_out: bool = False) -> float:
    """Kernel ``name`` against its plain version on ``args``: two launches
    bitwise equal, every output finite, and the error within its bar --
    K8 1e-5 absolute, K9 1e-4 of max |plain|, a bf16 output 3e-2 absolute
    plus 3e-2 relative (one bf16 rounding).  Returns the max abs error."""
    got, again = gate_kernel(name)(*args), gate_kernel(name)(*args)
    want = getattr(ref, name)(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, again)),
          f"{name}: two launches on the same inputs differ")
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        if bf16_out:
            ok = bool((diff <= BF16_TOL + BF16_TOL * w.abs()).all())
        elif name == "lstm_level_fused":
            ok = float(diff.max()) <= TOL * float(w.abs().max())
        else:
            ok = float(diff.max()) <= GATE_TOL
        check(ok, f"{name} disagrees with its plain version: max abs err "
              f"{float(diff.max()):.3e} at shapes "
              f"{[tuple(a.shape) for a in args]}")
    return err


def gate_bound_ms(name: str, args) -> tuple:
    """Least time for one launch of K8a/K8b/K9 on ``args``: each operand
    read once and each output written once at 3.35 TB/s, against the
    arithmetic: the gate arithmetic (5 FLOPs an element for K8a and K9's
    epilogue, 3A + 2 for K8b; transcendentals not counted) at 67 TFLOP/s
    fp32, and K9's product, 2*M*H*4H, as the three TF32 products an
    operation that keep f32 accuracy on the tensor cores at 495 TFLOP/s
    (two for bf16 rows, exact in TF32).  Returns (bound_ms, bound_by,
    flops, bytes, bound_fma_ms), the last with every FLOP at the 67
    TFLOP/s fp32-FMA rate."""
    prod, splits = 0.0, 3
    if name == "lstm_gates":
        gates, c_prev = args
        M, H = c_prev.shape
        eg = gates.element_size()
        nbytes = M * H * (6 * eg + c_prev.element_size())
        flops = 5.0 * M * H
    elif name == "treelstm_gates":
        i_pre, f_pre, _o, _u, c_k, mask = args
        M, A, H = f_pre.shape
        ep = i_pre.element_size()
        nbytes = (M * H * ((5 + A) * ep + A * c_k.element_size())
                  + M * A * mask.element_size())
        flops = (3.0 * A + 2) * M * H
    else:
        h_prev, _c, ext, wh, b = args
        M, H = h_prev.shape
        e = h_prev.element_size()
        nbytes = M * H * 4 * e + (ext.numel() + wh.numel() + b.numel()) * 4
        prod = 2.0 * M * H * 4 * H
        flops = prod + 5.0 * M * H
        splits = 2 if e == 2 else 3
    t_op = (flops - prod) / PEAK_FP32_FLOPS + splits * prod / PEAK_TF32_FLOPS
    t_by = nbytes / PEAK_BYTES
    return (max(t_op, t_by) * 1e3, "operations" if t_op >= t_by
            else "bytes", flops, nbytes,
            max(flops / PEAK_FP32_FLOPS, t_by) * 1e3)


def gate_timings(name: str, calls, pending: list) -> dict:
    """Kernel ``name`` re-run on the main path's own launches (``calls``),
    each against its plain version: the worst error, the mean data-aware
    bound; the mean time a launch and the plain version's are set by
    ``time_gates(pending)``, which times every gate kernel of the phase in
    one session.  Each does a few microseconds of work behind ~20-50 us of
    host launch cost, so the times are the card's own (``torch.profiler``
    device time, as for K6) and the CUDA-event time of back-to-back
    launches is kept beside them as ``issue_ms``."""
    worst = max(gate_check(name, a) for a in calls)
    kern = [lambda a=a: gate_kernel(name)(*a) for a in calls]
    plain = [lambda a=a: getattr(ref, name)(*a) for a in calls]
    bounds = [gate_bound_ms(name, a) for a in calls]
    out = {"timed": len(calls), "max_abs_err": worst,
           "bound_ms": float(np.mean([b[0] for b in bounds])),
           "flops": float(np.mean([b[2] for b in bounds])),
           "bytes": float(np.mean([b[3] for b in bounds])),
           "bound_fma_ms": float(np.mean([b[4] for b in bounds]))}
    by_ops = sum(b[0] for b in bounds if b[1] == "operations")
    out["bound_by"] = ("operations" if by_ops >= sum(b[0] for b in bounds) / 2
                       else "bytes")
    out["issue_ms"] = float(np.mean([time_ms(k, 20, 3) for k in kern[:4]]))
    pending.append((out, kern, plain))
    return out


def time_gates(pending: list) -> None:
    """Device ms a launch of each ``gate_timings`` entry of ``pending``
    and of its plain version, all in one ``torch.profiler`` session (each
    session a run takes raises the odds that CUPTI drops a later one's
    events); sets each entry's ``ms`` and ``plain_ms``."""
    sets = {}
    for i, (_out, kern, plain) in enumerate(pending):
        sets[i, "kernel"] = {"calls": kern, "launches": 1}
        sets[i, "plain"] = plain
    t = device_ms(sets)
    for i, (out, _k, _p) in enumerate(pending):
        out["ms"], out["plain_ms"] = t[i, "kernel"], t[i, "plain"]


def gate_kernels_check() -> dict:
    """K8a/K8b/K9 against their plain versions on the card at the shapes
    above, the state halves taken as strided views of ``[M, 2H]`` (K8b's
    children of ``[M, A, 2H]``), K8a with a float32 and a bf16 ``c_prev``,
    K8b with random masks, K9 at float32 and bf16; then a backward
    through each must raise."""
    gen = torch.Generator().manual_seed(88)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(DEVICE, dtype)

    errs = {"lstm_gates": 0.0, "treelstm_gates": 0.0,
            "lstm_level_fused": 0.0}
    for M, H in K8A_SHAPES:
        for sd in (torch.float32, torch.bfloat16):
            state = randn(M, 2 * H, dtype=sd)
            errs["lstm_gates"] = max(errs["lstm_gates"], gate_check(
                "lstm_gates", (randn(M, 4 * H), state[:, :H])))
    for M, A, H in K8B_SHAPES:
        mask = (torch.rand(M, A, generator=gen) > 0.3).float().to(DEVICE)
        args = (randn(M, H), randn(M, A, H), randn(M, H), randn(M, H),
                randn(M, A, 2 * H)[..., :H], mask)
        errs["treelstm_gates"] = max(errs["treelstm_gates"],
                                     gate_check("treelstm_gates", args))
    bf16_err = 0.0
    for M, H in K9_SHAPES:
        for sd in (torch.float32, torch.bfloat16):
            state = randn(M, 2 * H, dtype=sd)
            args = (state[:, H:], state[:, :H], randn(M, 4 * H, scale=0.5),
                    randn(H, 4 * H, scale=H ** -0.5), randn(4 * H, scale=0.1))
            err = gate_check("lstm_level_fused", args,
                             bf16_out=sd == torch.bfloat16)
            if sd == torch.float32:
                errs["lstm_level_fused"] = max(errs["lstm_level_fused"], err)
            else:
                bf16_err = max(bf16_err, err)
    m, h = 3, 8
    g = randn(m, 4 * h).requires_grad_()
    c = randn(m, h).requires_grad_()
    for out in (ops.lstm_gates(g, c),
                ops.treelstm_gates(c, randn(m, 2, h), c, c, randn(m, 2, h),
                                   torch.ones(m, 2, device=DEVICE)),
                ops.lstm_level_fused(c, c, g, randn(h, 4 * h),
                                     randn(4 * h))):
        try:
            out[1].sum().backward()
        except NotImplementedError:
            continue
        fail("a backward through a gate kernel did not raise")
    print("gate kernels vs plain: " + ", ".join(
        f"{k} max_abs_err {v:.3e}" for k, v in errs.items())
        + f"; lstm_level_fused bf16 {bf16_err:.3e}; backwards raise")
    sms = lm._sm_count(torch.device(DEVICE))
    M, H = K8A_SHAPES[-1]
    V, nt = ck.k8a_geometry(M, H, sms, True)
    ctas = -(-M * (H // V) // nt)
    check(ctas >= 2 * sms, f"lstm_gates at M {M}, H {H}: {ctas} CTAs on "
          f"{sms} SMs")
    print(f"lstm_gates geometry at M {M}, H {H}: {V} columns a thread, "
          f"blocks of {nt}, {ctas} CTAs on {sms} SMs")
    return errs


def _schedule_on(d, device):
    """A copy of the device schedule ``d`` on ``device``."""
    return dataclasses.replace(d, **{
        f.name: getattr(d, f.name).to(device)
        for f in dataclasses.fields(d)
        if isinstance(getattr(d, f.name), torch.Tensor)})


def var_lstm_opbyop(card: str, pending: list) -> dict:
    """The Var-LSTM batch (T54xM128) through ``execute(fusion_mode="none")``
    with ``cell_impl`` "pallas" (K8a a level) and "fused" (K9 a level),
    launch counts set to 0 just before and read just after: buffers within
    1e-4 of max |the K3 megastep buffer|; at bf16 within 3e-2 of the plain
    path's bf16 buffer on the CPU; the forward's time (median of three)
    beside the fused leg's.  A tapped run before the main path keeps each
    level's kernel arguments for the kernel's checks and times (taps keep
    tensors alive, so the timed runs are untapped)."""
    _kind, fn, params, d, ext, _h, _s = cell_setup("var_lstm")
    cpu_args = ({k: v.cpu() for k, v in params.items()},
                _schedule_on(d, "cpu"), ext.cpu())

    def forward(f, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            buf = execute(f, params, d, ext, **kw).buf
        torch.cuda.synchronize()
        return buf, (time.perf_counter() - t0) * 1e3

    forward(fn)                                            # warm
    k3, k3_ms = forward(fn)                                # the fused leg
    k3_ms = float(np.median([k3_ms] + [forward(fn)[1] for _ in range(2)]))
    out = {"T": d.T, "M": d.M, "fused_forward_ms": k3_ms, "card": card}
    for impl, name in (("pallas", "lstm_gates"),
                       ("fused", "lstm_level_fused")):
        f = dataclasses.replace(fn, cell_impl=impl)
        with tapped(name) as calls:                        # and warm
            forward(f, fusion_mode="none")
        lm.reset_launches()
        buf, ms = forward(f, fusion_mode="none")
        launches = dict(lm.LAUNCHES)
        ms = float(np.median([ms] + [forward(f, fusion_mode="none")[1]
                                     for _ in range(2)]))
        check(launches == {name: d.T}, f"var_lstm {impl}: launches "
              f"{launches}, designed {{{name!r}: {d.T}}}")
        err = rel_err(buf, k3)
        check(err <= TOL, f"var_lstm {impl} vs the K3 buffer: {err:.3e}")
        with torch.no_grad():
            bf = execute(f, params, d, ext, fusion_mode="none",
                         dtype=torch.bfloat16).buf
            cpu = execute(f, *cpu_args, fusion_mode="none",
                          dtype=torch.bfloat16).buf
        diff = (bf.float().cpu() - cpu.float()).abs()
        check(bool((diff <= BF16_TOL + BF16_TOL * cpu.float().abs()).all()),
              f"var_lstm {impl} bf16 vs the CPU: {float(diff.max()):.3e}")
        out[impl] = {"launches": launches[name], "forward_ms": ms,
                     "err_vs_k3": err, "bf16_err_vs_cpu": float(diff.max()),
                     name: gate_timings(name, calls, pending)}
    print(f"var_lstm op by op: {json.dumps(out)}")
    print(f"var_lstm forward T{d.T}xM{d.M}: fused leg (K3) {k3_ms:.3f} ms, "
          f"op by op with K8a {out['pallas']['forward_ms']:.3f} ms, with K9 "
          f"{out['fused']['forward_ms']:.3f} ms")
    return out


def unfused_serve(card: str, serve: dict, pending: list) -> dict:
    """The fusion ablation: the serving phase's 512 parses through
    ``StructureServeEngine`` on the op-by-op leg with the K8b gate cell:
    one K8b a padded level, every request ok, no degradation, roots within
    1e-4 of the fused (K1) engine's; throughput and batch latency beside
    the fused engine's.  A tapped run of the same traffic through another
    engine comes first: it keeps every level's K8b arguments for the
    kernel's checks and times, and warms the path."""
    _fn, params, ds = served_traffic()
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim,
                         impl="pallas")

    def engine():
        return StructureServeEngine(fn, params, batch_size=BATCH,
                                    fusion_mode="none", device=DEVICE)

    with tapped("treelstm_gates") as calls:
        _drain(engine(), _requests(ds))
    eng, reqs = engine(), _requests(ds)
    for r in reqs:
        check(eng.submit(r), f"request {r.request_id} rejected: {r.error}")
    torch.cuda.synchronize()
    lm.reset_launches()
    lat = []
    t_all = time.perf_counter()
    while eng.queue:
        t0 = time.perf_counter()
        eng.step()                 # ends in a device→host copy of roots
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = dict(lm.LAUNCHES)
    levels = sum(shape[0] * n
                 for shape, n in eng.pipeline.census.counts().items())
    h = eng.health()
    check(all(r.status == "ok" for r in reqs),
          f"unfused serving: {sum(r.status != 'ok' for r in reqs)} "
          f"request(s) not ok")
    check(h["degradations"] == 0, f"unfused serving degraded: "
          f"{eng.last_degradation}")
    check(launches == {"treelstm_gates": levels}, f"unfused serving: "
          f"launches {launches} for {levels} padded levels")
    roots = np.stack([r.root_state for r in reqs])
    err = float(np.abs(roots - serve["roots"]).max())
    check(err <= TOL, f"unfused roots vs the fused engine's: {err:.3e}")
    lat_ms = np.asarray(lat) * 1e3
    out = {"requests": len(reqs), "launches": launches["treelstm_gates"],
           "padded_levels": levels, "requests_per_s": len(reqs) / wall,
           "batch_p50_ms": float(np.percentile(lat_ms, 50)),
           "batch_p99_ms": float(np.percentile(lat_ms, 99)),
           "err_vs_fused": err, "card": card}
    for k in ("requests_per_s", "batch_p50_ms", "batch_p99_ms"):
        out[f"fused_{k}"] = serve[k]
        out[f"{k}_unfused_over_fused"] = out[k] / serve[k]
    out["treelstm_gates"] = gate_timings("treelstm_gates", calls, pending)
    print(f"unfused tree_lstm serving: {json.dumps(out)}")
    return out


def unfused_decode(card: str, decode: dict, pending: list) -> dict:
    """``VertexServeEngine`` on the op-by-op leg with the K9 LSTM cell over
    the decode phase's 256 chains: one K9 a tick, final states within 1e-4
    of ``execute``; ticks/s beside the K3 decode's.  A tapped run through
    another engine first keeps every tick's K9 arguments."""
    fn, params, graphs, xs = decode_setup("lstm", impl="fused")

    def engine():
        return VertexServeEngine(fn, params, num_slots=DECODE_SLOTS,
                                 fusion_mode="none", device=DEVICE)

    with tapped("lstm_level_fused") as calls:
        _drain(engine(), [VertexRequest(i, x) for i, x in enumerate(xs)])
    eng = engine()
    reqs = [VertexRequest(i, x) for i, x in enumerate(xs)]
    for r in reqs:
        check(eng.submit(r), f"decode request rejected: {r.error}")
    torch.cuda.synchronize()
    lm.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    check(all(r.status == "ok" for r in reqs), "an unfused decode request "
          "failed")
    check(launches == {"lstm_level_fused": eng.ticks}, f"unfused decode: "
          f"launches {launches} for {eng.ticks} ticks")
    finals = np.stack([r.final_state for r in reqs])
    err = float(np.abs(finals - decode_finals(fn, params, graphs, xs)).max())
    check(err <= TOL, f"unfused decode finals vs execute: {err:.3e}")
    out = {"ticks": eng.ticks, "ticks_per_s": eng.ticks / wall,
           "k3_ticks_per_s": decode["ticks_per_s"],
           "launches": launches["lstm_level_fused"], "err_vs_execute": err,
           "card": card,
           "lstm_level_fused": gate_timings("lstm_level_fused", calls,
                                            pending)}
    print(f"unfused decode: {json.dumps(out)}")
    return out


def serial_baseline(card: str, serve: dict) -> dict:
    """The DyNet-style baseline (paper Fig. 8): ``execute_serial`` with the
    K8b gate cell over the first parses of the serving traffic, a K8b
    launch a vertex; states within 1e-4 of ``execute``'s rows; ms a graph
    beside the batched engine's ms a request."""
    _fn, params, ds = served_traffic()
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim,
                         impl="pallas")
    graphs = ds.graphs[:SERIAL_GRAPHS]
    xs = ds.inputs[:SERIAL_GRAPHS]
    execute_serial(fn, params, graphs[:1], xs[:1])             # warm
    torch.cuda.synchronize()
    lm.reset_launches()
    t0 = time.perf_counter()
    states = execute_serial(fn, params, graphs, xs)
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    vertices = sum(g.num_nodes for g in graphs)
    check(launches == {"treelstm_gates": vertices}, f"serial baseline: "
          f"launches {launches} for {vertices} vertices")
    s = pack_batch(graphs, with_runs=False)
    d = s.to_device(DEVICE)
    ext = torch.from_numpy(pack_external(xs, s, cfg.input_dim)).to(DEVICE)
    with torch.no_grad():
        nodes = readout_nodes(execute(fn, params, d, ext).buf, d).cpu() \
            .numpy()
    err = max(float(np.abs(st - nodes[k, :g.num_nodes]).max())
              for k, (st, g) in enumerate(zip(states, graphs)))
    check(err <= TOL, f"serial states vs execute: {err:.3e}")
    out = {"graphs": len(graphs), "vertices": vertices,
           "ms_per_graph": wall * 1e3 / len(graphs),
           "batched_ms_per_request": 1e3 / serve["requests_per_s"],
           "err_vs_execute": err, "card": card}
    out["serial_over_batched"] = (out["ms_per_graph"]
                                  / out["batched_ms_per_request"])
    print(f"serial baseline: {json.dumps(out)}")
    return out


def op_by_op_phase(card: str, serve: dict, decode: dict) -> dict:
    errs = gate_kernels_check()
    pending = []                     # the gate kernels' timings, one session
    chains = var_lstm_opbyop(card, pending)
    served = unfused_serve(card, serve, pending)
    dec = unfused_decode(card, decode, pending)
    time_gates(pending)
    serial = serial_baseline(card, serve)
    k9 = chains["fused"]["lstm_level_fused"]
    rows = []
    for name, part, launches in (
            ("lstm_gates", chains["pallas"]["lstm_gates"],
             chains["pallas"]["launches"]),
            ("treelstm_gates", served["treelstm_gates"],
             served["launches"]),
            ("lstm_level_fused", k9,
             chains["fused"]["launches"] + dec["launches"])):
        replaces, source = GATE_KERNELS[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs[name], part["max_abs_err"]),
            "ms": part["ms"], "plain_ms": part["plain_ms"],
            "bound_ms": part["bound_ms"], "bound_by": part["bound_by"],
            "bound_fma_ms": part["bound_fma_ms"], "library_ms": None})
    for label, part in (("lstm_gates at a Var-LSTM level",
                         chains["pallas"]["lstm_gates"]),
                        ("treelstm_gates at a served level",
                         served["treelstm_gates"]),
                        ("lstm_level_fused at a Var-LSTM level", k9),
                        ("lstm_level_fused at a decode tick",
                         dec["lstm_level_fused"])):
        issue = (f", back-to-back launches {part['issue_ms']:.4f} ms apart"
                 if "issue_ms" in part else "")
        print(f"{label}: {part['ms']:.4f} ms a launch, plain "
              f"{part['plain_ms']:.4f} ms, bound {part['bound_ms']:.5f} ms "
              f"by {part['bound_by']} (fp32 FMA {part['bound_fma_ms']:.5f}; "
              f"{part['timed']} launches){issue}")
    print(f"fusion ablation: unfused serving {served['requests_per_s']:.1f} "
          f"requests/s vs fused {served['fused_requests_per_s']:.1f} (x"
          f"{served['requests_per_s_unfused_over_fused']:.3f}); batch p50 "
          f"{served['batch_p50_ms']:.3f} vs {served['fused_batch_p50_ms']:.3f}"
          f" ms, p99 {served['batch_p99_ms']:.3f} vs "
          f"{served['fused_batch_p99_ms']:.3f} ms; decode "
          f"{dec['ticks_per_s']:.1f} ticks/s (K9) vs "
          f"{dec['k3_ticks_per_s']:.1f} (K3); serial "
          f"{serial['ms_per_graph']:.3f} ms a graph vs batched "
          f"{serial['batched_ms_per_request']:.4f} ms a request (x"
          f"{serial['serial_over_batched']:.1f})")
    return {"rows": rows, "chains": chains, "served": served,
            "decode": dec, "serial": serial}


# ---------------------------------------------------------------------------
# Phase 15: LM serving (K10 flash attention, K11 decode attention)
# ---------------------------------------------------------------------------

#: The served LM at full width and depth, its slot pool and its traffic:
#: prompt lengths from ``default_rng(0)`` in ``LM_PROMPT_RANGE``, the
#: second half submitted after ``LM_STAGGER`` ticks.
LM_ARCH, LM_SLOTS, LM_MAX_LEN = "granite-3-8b", 8, 1024
LM_REQUESTS, LM_NEW, LM_PROMPT_RANGE, LM_STAGGER = 16, 32, (16, 600), 4
#: Kernel against plain: bar relative to max |plain| by type, the plain
#: version computing in f32 on f32 copies of the inputs.
ATTN_BARS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: Served logits against a full recompute, relative to max |logit|; a
#: token whose recompute top-2 margin is wider than LM_MARGIN must match.
#: The logit bar sits above the bf16 model's own noise: on the H100 the
#: bf16 recompute is 2.19e-2 of max |logit| from an f32 recompute of the
#: same weights, and the served path 2.36e-2 from the bf16 recompute (p50
#: 1.62e-2); a serving fault (a cache row, a position, a mask) is O(1).
#: LM_FLOOR_RATIO: the served path may be at most that much farther from
#: the f32 recompute than the bf16 recompute is.
LM_LOGIT_TOL, LM_MARGIN, LM_FLOOR_RATIO = 3e-2, 4e-2, 1.25
#: K10 (B, Hq, Hkv, Sq, Sk, D, causal, window) and K11 (B, Hq, Hkv, S, D,
#: kv_len, window) edge cases, each at f32 and bf16 (K10 at bf16 takes the
#: wgmma route where D % 16 == 0, the tf32 route otherwise and at f32):
#: Sq 1, 63, 65, 127 and 129 against key tiles of 32 and 64 and query
#: tiles of 64 and 128; Sq != Sk without ``causal``; windows of 24, 50 and
#: 100 (starting inside a key tile); GQA groups 1, 2, 4, 8 and 12; head
#: dims 16, 32, 64, 80, 128, 160 and 256 (the wgmma kernel's four padded
#: widths, 64 to 256, and the tf32 kernel's four classes, 32 to 256); the
#: ragged head dims of the tf32 route, whose last 8-column block is
#: zero-padded: 20, 36 and 100 (16-byte copies at f32, 8-byte ones at
#: bf16), 7 (4-byte copies at f32, plain 2-byte ones at bf16) and 100 at
#: 1,024 tokens, and 40 (tf32 at bf16); Sq > Sk under ``causal`` (zero rows); a 2,048-token causal
#: prefill.  q is a permuted view in every case.
K10_EDGES = ((1, 32, 8, 1, 1, 128, True, None),
             (2, 4, 4, 40, 72, 64, False, None),
             (1, 8, 2, 96, 96, 64, True, 24),
             (2, 32, 8, 100, 100, 128, True, None),
             (1, 16, 2, 33, 65, 80, True, None),
             (1, 4, 1, 63, 63, 32, True, None),
             (1, 4, 4, 65, 65, 256, True, None),
             (1, 8, 1, 127, 127, 64, True, None),
             (1, 12, 1, 129, 129, 128, True, None),
             (1, 8, 2, 65, 200, 128, False, None),
             (1, 8, 2, 300, 300, 128, True, 100),
             (1, 4, 4, 129, 50, 128, True, None),
             (1, 4, 2, 100, 100, 160, True, None),
             (1, 2, 2, 70, 70, 16, False, None),
             (1, 8, 2, 100, 100, 20, True, None),
             (1, 4, 2, 129, 129, 40, True, 50),
             (2, 4, 4, 40, 72, 36, False, None),
             (1, 4, 2, 65, 65, 7, True, None),
             (1, 8, 2, 1024, 1024, 100, True, None),
             (1, 32, 8, 1024, 1024, 128, True, None),
             (1, 32, 8, 2048, 2048, 128, True, None))
#: K11's cases carry an eighth field, ``pad``: the cache rows are views of
#: rows ``D + pad`` long.  Beyond the cases above: a ``kv_len`` 0 slot
#: (zeros), a 4,096-row cache filled to 4,000 and 17, D 256 with group 1,
#: D 16 with group 8, a window of 100 across the split's shares, rows
#: whose stride is no multiple of 16 bytes, and D 20 (40-byte bf16 rows):
#: the kernel's element-wise staging.
K11_EDGES = ((8, 32, 8, 1024, 128, (1, 17, 600, 1024, 2, 333, 64, 1000),
              None, 0),
             (3, 4, 4, 33, 64, (33, 16, 1), None, 0),
             (2, 8, 2, 100, 64, (100, 41), 24, 0),
             (2, 24, 2, 50, 80, (50, 7), None, 0),
             (4, 8, 2, 100, 64, (0, 100, 37, 0), None, 0),
             (2, 32, 8, 4096, 128, (4000, 17), None, 0),
             (2, 8, 8, 300, 256, (300, 129), None, 0),
             (3, 16, 2, 200, 16, (200, 3, 150), None, 0),
             (2, 32, 8, 1024, 128, (1000, 250), 100, 0),
             (3, 8, 2, 300, 64, (300, 77, 1), None, 1),
             (3, 8, 2, 300, 20, (300, 77, 1), None, 0))
#: K11 at granite's decode shape with every slot filled to n rows of the
#: engine's ``LM_MAX_LEN``-row cache.
K11_FILLS = (16, 64, 256, 632, 1024)
#: A ragged head dim (no multiple of 8) at which the reduced f32 model's
#: K10 launches take the tf32 route with a zero-padded last block.
RAGGED_HEAD_DIM = 20
#: The ragged head dims' K10 cases timed at real length (B, Hq, Hkv, Sq,
#: Sk, D, causal, window), at f32 and bf16.
K10_RAGGED_TIMED = ((1, 8, 2, 1024, 1024, 100, True, None),
                    (1, 8, 2, 1024, 1024, 20, True, None))
#: Bytes of K/V rows a timed set of K11 inputs holds at least: twice the
#: 50 MB L2, so each launch finds its rows in HBM, as a decode tick does.
K11_COLD_BYTES = 100e6
ATTN_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
    "decode_attention": "src/repro/kernels/decode_attention.py:70"}


def attn_plain(name: str, args, kw) -> torch.Tensor:
    """The plain version of K10/K11 on f32 copies of the inputs."""
    q, k, v = (t.float() for t in args)
    if name == "flash_attention":
        return ref.mha(q, k, v, **kw)
    return ref.decode_attention(q, k, v, **kw)


def attn_kernel(name: str):
    return flash.flash_attention if name == "flash_attention" \
        else decattn.decode_attention


def attn_check(name: str, args, kw, twice: bool = True) -> tuple:
    """Kernel ``name`` against its plain version on ``args``: finite, two
    launches bitwise equal (``twice``), error within the type's bar.
    Returns (max abs err, err / max |plain|)."""
    got = attn_kernel(name)(*args, **kw)
    again = attn_kernel(name)(*args, **kw) if twice else got
    want = attn_plain(name, args, kw)
    torch.cuda.synchronize()
    check(torch.equal(_bits(got), _bits(again)),
          f"{name}: two launches on the same inputs differ")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = float((got.float() - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    check(rel <= ATTN_BARS[args[0].dtype], f"{name} disagrees with its "
          f"plain version: {rel:.3e} of max |plain| at "
          f"{[tuple(a.shape) for a in args]} {args[0].dtype} {kw}")
    return err, rel


def attn_edges_check() -> dict:
    """Both kernels on the edge cases of ``K10_EDGES``/``K11_EDGES``; K10's
    worst errors kept by route (``flash.route``: bf16 "wgmma" where D % 16
    == 0, else and at f32 "tf32"), each case's two launches counted on
    that route alone."""
    gen = torch.Generator().manual_seed(1010)
    out = {**{f"flash_attention.{r}": (0.0, 0.0) for r in flash.LIBRARIES},
           "decode_attention": (0.0, 0.0)}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen).to(DEVICE, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, Sq, Sk, D, causal, window in K10_EDGES:
            q = randn(B, Sq, Hq, D, dtype=dtype).transpose(1, 2)
            k, v = randn(B, Hkv, Sk, D, dtype=dtype), \
                randn(B, Hkv, Sk, D, dtype=dtype)
            n0 = dict(lm.LAUNCHES)
            e = attn_check("flash_attention", (q, k, v),
                           {"causal": causal, "window": window})
            key = f"flash_attention.{flash.route(dtype, D)}"
            taken = {r: lm.LAUNCHES[f"flash_attention.{r}"]
                     - n0.get(f"flash_attention.{r}", 0)
                     for r in flash.LIBRARIES}
            check(taken[key.split(".")[1]] == 2 and sum(taken.values()) == 2,
                  f"K10 at {dtype}, D {D}: launches by route {taken}, "
                  f"expected both on the {key} route")
            out[key] = tuple(map(max, out[key], e))
        for B, Hq, Hkv, S, D, kvl, window, pad in K11_EDGES:
            q = randn(B, Hq, D, dtype=dtype)
            k, v = (randn(B, Hkv, S, D + pad, dtype=dtype)[..., :D]
                    for _ in range(2))
            kv_len = torch.tensor(kvl, dtype=torch.int32, device=DEVICE)
            e = attn_check("decode_attention", (q, k, v),
                           {"kv_len": kv_len, "window": window})
            out["decode_attention"] = tuple(map(max, out["decode_attention"],
                                                e))
    for name, (err, rel) in out.items():
        print(f"{name} vs plain, edge cases: max_abs_err {err:.3e}, "
              f"{rel:.3e} of max |plain|")
    return out


def k10_build_report(lib: str, key_re: str, label, dims,
                     sass_ops) -> dict:
    """What ``nvcc -Xptxas -v`` said of each instantiation of K10's
    kernel in library ``lib`` (an entry function matching ``key_re``,
    named by ``label(match)``): registers, spills; its dynamic shared
    memory a CTA for each entry of ``dims`` (a label and the arguments of
    the library's ``*_smem_bytes``); and, where ``cuobjdump`` is
    on the machine, the count of each SASS opcode of ``sass_ops`` in the
    library, none of which may be 0."""
    lib_path = _build.library_path(lib)
    ptxas = ptxas_report(lib, key_re, label)
    smem_of = getattr(ctypes.CDLL(str(lib_path)), f"{lib}_smem_bytes")
    smem = {key: smem_of(*args) for key, args in dims.items()}
    cob = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {}
    if Path(cob).exists():
        dump = subprocess.run([cob, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        sass = {op: dump.count(op) for op in sass_ops}
        check(all(sass.values()), f"{lib}.cu's SASS lacks one of "
              f"{sass_ops}: {sass}")
    print(f"{lib}.cu: dynamic shared memory a CTA {smem}; SASS "
          f"{sass or 'not read (no cuobjdump)'}")
    return {"ptxas": ptxas, "smem": smem, "sass": sass}


def k10_build_reports() -> tuple:
    """``k10_build_report`` of the wgmma kernel (by padded head dim; TMA
    loads and ``wgmma`` in its SASS) and of the tf32 kernel (by head-dim
    class, whether D equals it and the operands' type; TF32 ``mma.sync``,
    ``cp.async`` and ``ldmatrix`` in its SASS)."""
    return (k10_build_report(
                "flash_attention_sm90", r"ILi(\d+)E",
                lambda m: f"padded head dim {m.group(1)}",
                {D: (D,) for D in (32, 64, 80, 128, 256)},
                ("HGMMA", "UTMALDG")),
            k10_build_report(
                "flash_attention_tf32", r"ILi(\d+)ELb(\d)E([ft])",
                lambda m: f"DMAX {m.group(1)}"
                + (", D = DMAX" if m.group(2) == "1" else "")
                + (", bf16" if m.group(3) == "t" else ", f32"),
                {f"{t} D {D}": (D, int(t == "bf16"))
                 for t in ("f32", "bf16")
                 for D in (20, 32, 40, 64, 80, 100, 128, 256)},
                ("HMMA.1688.F32.TF32", "LDGSTS", "LDSM")))


#: K11's three instantiation routes (``decode_attention_plan``'s code).
ROUTES = ("CUDA cores, narrow rows", "CUDA cores, 16-byte rows",
          "tensor cores (mma.sync), 16-byte rows")


def k11_build_report(shape) -> dict:
    """What ``nvcc -Xptxas -v`` said of each instantiation of K11's
    kernel (type, query heads a cluster, route), and the
    launch K11 makes at ``shape`` = (B, Hq, Hkv, D) over granite's
    1,024-row cache: NS, the grid, heads a cluster, tile rows, shared
    memory a CTA."""
    ptxas = ptxas_report(
        "decode_attention",
        r"decode_attention_kernelI(\w+?)Li(\d+)ELb(\d)ELb(\d)E",
        lambda m: (f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'}, GC "
                   f"{m.group(2)}, "
                   + ROUTES[2 if m.group(4) == "1" else int(m.group(3))]))
    B, Hq, Hkv, D = shape
    G = Hq // Hkv
    lib = ctypes.CDLL(str(_build.library_path("decode_attention")))
    plan = (ctypes.c_int * 6)()
    lib.decode_attention_plan(D, G, 1, plan)
    gc, tr, ldb, _, smem, route = plan
    ngc = -(-G // decode_split.heads_per_cta(G))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ns = decode_split.split_count(LM_MAX_LEN, B * Hkv * ngc, sms)
    grid = (B, Hkv, ngc * ns)
    print(f"K11 at granite's decode shape (B {B}, Hq {Hq}, Hkv {Hkv}, D "
          f"{D}, bf16, cache {LM_MAX_LEN} rows, {sms} SMs): NS {ns}, grid "
          f"{grid} = {B * Hkv * ngc * ns} CTAs in clusters of {ns}, {gc} "
          f"query heads a cluster, tiles of {tr} rows of {ldb} B, {smem} "
          f"B of shared memory a CTA, {ROUTES[route]}")
    check(gc == G and route == 2, f"K11 at granite's shape: {gc} heads a "
          f"cluster (the group has {G}), route {ROUTES[route]}")
    return {"ptxas": ptxas, "ns": ns, "grid": grid, "heads": gc,
            "tile_rows": tr, "smem": smem, "route": ROUTES[route]}


def k11_by_fill(shape) -> dict:
    """K11 at ``shape`` = (B, Hq, Hkv, D), bf16, as the engine calls it:
    a cache of ``LM_MAX_LEN`` rows (so the split of the main path) with
    every slot's ``kv_len`` = n, for n in ``K11_FILLS``; enough distinct
    inputs that their valid rows hold ``K11_COLD_BYTES``, the first
    checked against the plain version (two launches bitwise equal);
    device time (``torch.profiler``) of the kernel, SDPA (on the valid
    rows, ``sdpa_call``) and the plain version, and the bound."""
    B, Hq, Hkv, D = shape
    gen = torch.Generator(DEVICE).manual_seed(23)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G = Hq // Hkv
    ns = decode_split.split_count(
        LM_MAX_LEN, B * Hkv * -(-G // decode_split.heads_per_cta(G)), sms)
    out = {}
    for n in K11_FILLS:
        kw = {"kv_len": torch.full((B,), n, dtype=torch.int32,
                                   device=DEVICE), "window": None}
        calls = []
        for _ in range(max(2, -(-int(K11_COLD_BYTES) // (4 * B * Hkv * n
                                                           * D)))):
            q = torch.randn((B, Hq, D), generator=gen, device=DEVICE)
            k, v = (torch.zeros((B, Hkv, LM_MAX_LEN, D), dtype=torch.bfloat16,
                                device=DEVICE) for _ in range(2))
            for t in (k, v):
                t[:, :, :n] = torch.randn((B, Hkv, n, D), generator=gen,
                                          device=DEVICE)
            calls.append((q.to(torch.bfloat16), k, v))
        err = attn_check("decode_attention", calls[0], kw)
        kern = [lambda a=a: decattn.decode_attention(*a, **kw) for a in calls]
        d = device_ms({
            "kernel": kern,
            "sdpa": [sdpa_call("decode_attention", a, kw) for a in calls],
            "plain": {"calls": [lambda a=a: attn_plain("decode_attention",
                                                       a, kw)
                                for a in calls[:8]], "reps": 1}}, reps=3)
        t = {"copies": len(calls), "ns": ns, "max_abs_err": err[0],
             "bound_ms": attn_bound_ms("decode_attention", calls[0], kw)[0],
             "ms": d["kernel"], "sdpa_ms": d["sdpa"],
             "plain_ms": d["plain"]}
        out[n] = t
        del calls, kern
        print(f"decode_attention, every slot at {n} of {LM_MAX_LEN} rows "
              f"(NS {ns}; device time over {t['copies']} inputs): "
              f"{t['ms']:.4f} ms, SDPA {t['sdpa_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.5f} ms; "
              f"max_abs_err {t['max_abs_err']:.3e}")
    return out


def attn_bound_ms(name: str, args, kw, fp32_fma: bool = False) -> tuple:
    """Least time of one K10/K11 launch on ``args``: QK^T and PV over the
    pairs of query and valid key this launch's data has (4 * D FLOPs a
    pair a head) on the tensor cores, at 989 TFLOP/s for bf16 operands and,
    for f32 operands, as three TF32 products each at 495 TFLOP/s (the
    split that keeps f32 accuracy there); ``fp32_fma``: f32 operands at 67
    TFLOP/s, the fp32 rate of the CUDA cores, instead.  Against q, the
    valid K/V rows and the output moved once at 3.35 TB/s.  Returns
    (bound_ms, bound_by, flops, bytes)."""
    q, k, v = args
    e = q.element_size()
    if name == "flash_attention":
        B, Hq, Sq, D = q.shape
        Hkv, Sk = k.shape[1], k.shape[2]
        qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk)[None, :]
        valid = torch.ones(Sq, Sk, dtype=torch.bool)
        if kw.get("causal", True):
            valid &= kpos <= qpos
        if kw.get("window"):
            valid &= kpos > qpos - kw["window"]
        pairs = float(valid.sum()) * B * Hq
        nbytes = e * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    else:
        B, Hq, D = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        lens = kw["kv_len"].clamp(max=S).long().cpu()
        if kw.get("window"):
            lens = lens.clamp(max=kw["window"])
        rows = float(lens.sum())
        pairs = rows * Hq
        nbytes = e * (2 * B * Hq * D + 2 * rows * Hkv * D) + 4 * B
    flops = 4.0 * D * pairs
    if q.dtype == torch.bfloat16:
        t_op = flops / PEAK_BF16_FLOPS
    else:
        t_op = flops / PEAK_FP32_FLOPS if fp32_fma \
            else 3 * flops / PEAK_TF32_FLOPS
    t_by = nbytes / PEAK_BYTES
    return (max(t_op, t_by) * 1e3, "operations" if t_op >= t_by
            else "bytes", flops, nbytes)


def sdpa_call(name: str, args, kw):
    """One ``scaled_dot_product_attention`` computing what K10/K11 compute
    on ``args`` (timed only; the port never calls it).  GQA by
    ``enable_gqa`` where the installed torch has it, else by repeating
    K/V; K11's ``kv_len`` as a boolean mask."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = "enable_gqa" in (sdpa.__doc__ or "")
    q, k, v = args
    g = q.shape[1] // k.shape[1]
    if not gqa and g > 1:
        k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    extra = {"enable_gqa": True} if gqa else {}
    if name == "flash_attention":
        check(kw.get("window") is None and q.shape[2] == k.shape[2],
              "the SDPA yardstick times square causal prefills only")
        return lambda: sdpa(q, k, v, is_causal=kw.get("causal", True),
                            **extra)
    # The cache's rows up to the longest kv_len, copied before the timing:
    # rows past it are masked for every slot, and SDPA reads what it gets.
    S = max(1, min(k.shape[2], int(kw["kv_len"].max())))
    k, v = k[:, :, :S].contiguous(), v[:, :, :S].contiguous()
    mask = (torch.arange(S, device=q.device)[None, :]
            < kw["kv_len"][:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: sdpa(q4, k, v, attn_mask=mask, **extra)


def lm_traffic(vocab: int):
    rng = np.random.default_rng(0)
    lo, hi = LM_PROMPT_RANGE
    lens = rng.integers(lo, hi + 1, LM_REQUESTS)
    return [Request(i, rng.integers(0, vocab, int(n)),
                    max_new_tokens=LM_NEW) for i, n in enumerate(lens)]


def lm_serve(model, params, reqs, ticks_out=None, engine=ServeEngine,
             prefill_kernel="flash_attention", **kw):
    """The traffic through a fresh ``engine`` (``kw`` to its constructor):
    the first half at once, the rest after ``LM_STAGGER`` ticks; returns
    the engine.  ``ticks_out`` collects (seconds, admitted a prompt) a
    tick, a tick that launched ``prefill_kernel`` counting as one that
    admitted."""
    eng = engine(model, params, num_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                 **kw)
    half, live = (len(reqs) + 1) // 2, 1
    for r in reqs[:half]:
        check(eng.submit(r), f"LM request rejected: {r.error}")
    while True:
        if half < len(reqs) and (eng.ticks >= LM_STAGGER or live == 0):
            for r in reqs[half:]:
                check(eng.submit(r), f"LM request rejected: {r.error}")
            half = len(reqs)
        n0 = lm.LAUNCHES[prefill_kernel]
        t0 = time.perf_counter()
        live = eng.step()
        if ticks_out is not None:
            ticks_out.append((time.perf_counter() - t0,
                              lm.LAUNCHES[prefill_kernel] > n0))
        if live == 0 and half == len(reqs):
            return eng


class KeepRows(ServeEngine):
    """A ``ServeEngine`` that keeps every row of logits a token was drawn
    from (``rows``: request id → one ``[vocab]`` f32 row a token)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rows = {}

    def _sample(self, logits, rids):
        V = self.model.cfg.vocab
        for i, rid in enumerate(rids):
            if rid is not None:
                self.rows.setdefault(rid, []).append(
                    logits[i, :V].float().clone())
        return super()._sample(logits, rids)


def lm_recompute(model, params, reqs) -> dict:
    """Each request's tokens teacher-forced through one ``trunk`` pass in
    "train" mode over prompt + output: request id → the ``[n_out, vocab]``
    f32 logits that predict its output tokens."""
    V = model.cfg.vocab
    out = {}
    with torch.no_grad():
        for r in reqs:
            toks = list(map(int, r.prompt)) + r.output[:-1]
            x = model.embed(params, torch.tensor([toks], device=DEVICE))
            h, _ = model.trunk(params, x, mode="train",
                               positions=torch.arange(len(toks),
                                                      device=DEVICE))
            out[r.request_id] = model.logits(
                params, h)[0, len(r.prompt) - 1:, :V].float()
    return out


def logit_agreement(reqs, served: dict, want: dict,
                    margin: float = LM_MARGIN) -> dict:
    """Served rows against recomputed ones, request by request: each
    row's max error relative to the request's max |logit| (worst, p50,
    p99, and the step of the worst), the share of tokens equal to the
    recompute's argmax, and whether every token whose recompute top-2
    margin exceeds ``margin`` of max |logit| equals it."""
    rel, agree, total, clear, clear_ok, worst_at = [], 0, 0, 0, True, None
    for r in reqs:
        got = torch.stack(served[r.request_id])
        w = want[r.request_id]
        check(got.shape == w.shape, f"request {r.request_id}: "
              f"{tuple(got.shape)} served logits, {tuple(w.shape)} "
              f"recomputed")
        scale = float(w.abs().max())
        row = ((got - w).abs().amax(dim=-1) / scale).cpu().numpy()
        if not rel or row.max() > max(max(x) for x in rel):
            worst_at = (r.request_id, int(row.argmax()), len(r.prompt))
        rel.append(row)
        top = w.topk(2, dim=-1)
        sure = (top.values[:, 0] - top.values[:, 1]) > margin * scale
        out = torch.tensor(r.output, device=w.device)
        arg = top.indices[:, 0]
        clear_ok &= bool((out[sure] == arg[sure]).all())
        agree += int((out == arg).sum())
        total += len(r.output)
        clear += int(sure.sum())
    rows = np.concatenate(rel)
    return {"logit_err_rel": float(rows.max()),
            "logit_err_rel_p50": float(np.percentile(rows, 50)),
            "logit_err_rel_p99": float(np.percentile(rows, 99)),
            "worst_at": worst_at, "tokens_agree": agree / total,
            "tokens": total, "tokens_clear_margin": clear,
            "clear_margin_tokens_agree": clear_ok}


def lm_exact_f32_check(arch: str = LM_ARCH, head_dim=None, keep=None,
                       **kw) -> dict:
    """``reduced(arch)`` at f32 on the card (``kw`` to ``ServeEngine``;
    ``head_dim`` in place of the reduced config's 32): the engine's greedy
    tokens equal a full recompute's exactly (``tests/test_serve.py``'s
    assertion for the reference), with staggered admission.  ``keep``: a
    list that collects a copy of every K10 launch's (args, kw)."""
    cfg = reduced(get_config(arch))
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(0), DEVICE)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)), max_new_tokens=6)
            for i, n in enumerate((3, 5, 4, 8, 13, 2))]
    eng = ServeEngine(model, params, num_slots=2, max_len=32, **kw)
    inner = flash.flash_attention
    if keep is not None:
        def tap(q, k, v, **akw):
            keep.append(((q.clone(), k.clone(), v.clone()), akw))
            return inner(q, k, v, **akw)
        flash.flash_attention = tap
    try:
        _serve_and_recompute(model, params, reqs, eng)
    finally:
        flash.flash_attention = inner
    heads = f", head dim {cfg.dh}" if cfg.n_heads else ""
    print(f"LM f32 ({cfg.name}{heads}): {len(reqs)} requests' greedy tokens "
          f"equal a full recompute on the card")
    return {"requests": len(reqs), "head_dim": cfg.dh if cfg.n_heads else 0}


def _serve_and_recompute(model, params, reqs, eng) -> None:
    """``reqs`` through ``eng``, half after one tick; each request's greedy
    tokens then recomputed from its prompt by ``trunk`` and checked."""
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    eng.run()
    check(all(r.status == "ok" for r in reqs), "an f32 LM request failed")
    with torch.no_grad():
        for r in reqs:
            toks, want = list(map(int, r.prompt)), []
            for _ in range(len(r.output)):
                x = model.embed(params, torch.tensor([toks], device=DEVICE))
                h, _ = model.trunk(params, x, mode="train",
                                   positions=torch.arange(len(toks),
                                                          device=DEVICE))
                want.append(int(torch.argmax(model.logits(params,
                                                          h)[0, -1])))
                toks.append(want[-1])
            check(r.output == want, f"f32 request {r.request_id}: served "
                  f"{r.output}, recompute {want}")


def attn_timings(name: str, calls) -> dict:
    """K10/K11 re-run on the kept launches ``calls`` ((args, kw) pairs):
    the worst error against the plain version, then the mean device time
    a launch (``torch.profiler``) of the kernel, the plain version and
    SDPA, and the mean data-aware bound."""
    errs = [attn_check(name, a, kw, twice=False) for a, kw in calls]
    bounds = [attn_bound_ms(name, a, kw) for a, kw in calls]
    kern = [lambda a=a, kw=kw: attn_kernel(name)(*a, **kw) for a, kw in calls]
    plain = [lambda a=a, kw=kw: attn_plain(name, a, kw) for a, kw in calls]
    lib = [sdpa_call(name, a, kw) for a, kw in calls]
    t = device_ms({"kernel": kern, "plain": {"calls": plain, "reps": 1},
                   "library": lib}, reps=3)
    out = {"timed": len(calls),
           "max_abs_err": max(e[0] for e in errs),
           "max_rel_err": max(e[1] for e in errs),
           "bound_ms": float(np.mean([b[0] for b in bounds])),
           "flops": float(np.mean([b[2] for b in bounds])),
           "bytes": float(np.mean([b[3] for b in bounds])),
           "ms": t["kernel"], "plain_ms": t["plain"],
           "library_ms": t["library"],
           "issue_ms": float(np.mean([time_ms(k, 5, 1) for k in kern[:8]]))}
    by_ops = sum(b[0] for b in bounds if b[1] == "operations")
    out["bound_by"] = ("operations" if by_ops >= sum(b[0] for b in bounds) / 2
                       else "bytes")
    return out


def k10_ragged_times() -> dict:
    """The tf32 route at the ragged head dims of ``K10_RAGGED_TIMED`` at
    real length, f32 and bf16: against the plain version (two launches
    bitwise equal), then the kernel, SDPA and the plain version by
    ``torch.profiler`` device time beside the bound."""
    gen = torch.Generator().manual_seed(1011)
    out, sets, worst = {}, {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, Sq, Sk, D, causal, window in K10_RAGGED_TIMED:
            q = torch.randn((B, Sq, Hq, D), generator=gen).to(
                DEVICE, dtype).transpose(1, 2)
            k, v = (torch.randn((B, Hkv, Sk, D), generator=gen).to(
                DEVICE, dtype) for _ in range(2))
            a, kw = (q, k, v), {"causal": causal, "window": window}
            check(flash.route(dtype, D) == "tf32", f"K10 at {dtype}, D {D}:"
                  f" route {flash.route(dtype, D)}")
            err, rel = attn_check("flash_attention", a, kw)
            worst = max(worst, err)
            key = f"{str(dtype).split('.')[-1]} D {D} Sq {Sq}"
            b = attn_bound_ms("flash_attention", a, kw)
            out[key] = {"max_abs_err": err, "rel_err": rel,
                        "bound_ms": b[0], "bound_by": b[1]}
            sets[key, "ms"] = [lambda a=a, kw=kw:
                               flash.flash_attention(*a, **kw)]
            sets[key, "library_ms"] = [sdpa_call("flash_attention", a, kw)]
            sets[key, "plain_ms"] = {"calls": [lambda a=a, kw=kw:
                                               attn_plain("flash_attention",
                                                          a, kw)],
                                     "reps": 2}
    for (key, what), ms in device_ms(sets, reps=10).items():
        out[key][what] = ms
    for key, t in out.items():
        print(f"flash_attention.tf32 at a ragged head dim, {key} (device "
              f"time): {t['ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"by {t['bound_by']}; {t['rel_err']:.3e} of max |plain|")
    return {"cases": out, "max_abs_err": worst}


def lm_serving_phase(card: str) -> dict:
    """granite-3-8b at full width and depth (bf16, weights from a CUDA
    ``torch.Generator`` seed) served through ``ServeEngine``: the kernel
    edge cases, the main path with its launch counts, a tapped re-run
    (every ``TAP_EVERY``-th K10/K11 launch kept, checked and timed; every
    sampled row of logits kept for the recompute), K11 by fill, a profile
    of one warm tick, and the f32 exactness check."""
    edges = attn_edges_check()
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    L = len(model.descs)
    # Warm the kernels, cuBLAS and the allocator on one short request.
    lm_serve(model, params, [Request(i, np.arange(1, 20), max_new_tokens=2)
                             for i in range(2)])

    reqs = lm_traffic(cfg.vocab)
    ticks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    t0 = time.perf_counter()
    eng = lm_serve(model, params, reqs, ticks)
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(r.status == "ok" for r in reqs), "an LM request did not end ok: "
          + ", ".join(f"{r.request_id}:{r.status}:{r.error}" for r in reqs
                      if r.status != "ok"))
    check(launches == {"flash_attention": L * len(reqs),
                       "flash_attention.wgmma": L * len(reqs),
                       "decode_attention": L * eng.ticks},
          f"LM launches {launches}: expected {L} K10 a prompt "
          f"({len(reqs)} prompts), all on the wgmma route, and {L} K11 a "
          f"tick ({eng.ticks} ticks)")
    tokens = sum(len(r.output) for r in reqs)
    check(all(len(r.output) == LM_NEW for r in reqs),
          "an LM request stopped short of its max_new_tokens")
    decode_s = np.asarray([s for s, admitted in ticks if not admitted])
    buckets = sorted({eng.bucket(len(r.prompt)) for r in reqs})

    # Prefill time a bucket, outside the main path (host clock, synced).
    prefill_ms = {}
    with torch.no_grad():
        for b in buckets:
            toks = torch.ones((1, b), dtype=torch.long, device=DEVICE)
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                model.prefill(params, toks)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t1) * 1e3)
            prefill_ms[b] = float(np.median(runs))

    # The tapped re-run: the same traffic through a fresh engine.
    kept = {"flash_attention": [], "decode_attention": []}
    seen = {"flash_attention": 0, "decode_attention": 0}
    inner = {"flash_attention": flash.flash_attention,
             "decode_attention": decattn.decode_attention}

    def tapper(name):
        def tap(q, k, v, **kw):
            if seen[name] % TAP_EVERY == 0:
                if name == "decode_attention":
                    kw = dict(kw, kv_len=kw["kv_len"].clone())
                kept[name].append(((q.clone(), k.clone(), v.clone()), kw))
            seen[name] += 1
            return inner[name](q, k, v, **kw)
        return tap

    flash.flash_attention = tapper("flash_attention")
    decattn.decode_attention = tapper("decode_attention")
    try:
        reqs2 = lm_traffic(cfg.vocab)
        served = lm_serve(model, params, reqs2, engine=KeepRows).rows
    finally:
        flash.flash_attention = inner["flash_attention"]
        decattn.decode_attention = inner["decode_attention"]
    check([r.output for r in reqs2] == [r.output for r in reqs],
          "the tapped re-run served other tokens than the main path")
    want = lm_recompute(model, params, reqs2)
    recompute = logit_agreement(reqs2, served, want)
    # The same weights in f32, one layer upcast at a time: how far the
    # served path and the bf16 recompute each are from the f32 model.
    m32 = TransformerLM(dataclasses.replace(cfg, param_dtype="float32",
                                            compute_dtype="float32"))
    p32 = {k: F32Layers(v) if k == "layers" else _f32(v)
           for k, v in params.items()}
    truth = lm_recompute(m32, p32, reqs2)
    del p32
    recompute["vs_f32"] = logit_agreement(reqs2, served, truth)
    recompute["bf16_floor"] = logit_agreement(
        reqs2, {rid: list(w) for rid, w in want.items()}, truth)
    del served, want, truth
    served_f32 = recompute["vs_f32"]["logit_err_rel"]
    floor = recompute["bf16_floor"]["logit_err_rel"]
    check(served_f32 <= LM_FLOOR_RATIO * floor, f"served logits are "
          f"{served_f32:.3e} of max |logit| from an f32 recompute, more "
          f"than {LM_FLOOR_RATIO} x the bf16 recompute's {floor:.3e}")
    check(recompute["logit_err_rel"] <= LM_LOGIT_TOL, f"served logits vs "
          f"full recompute: {recompute['logit_err_rel']:.3e} of max |logit| "
          f"> {LM_LOGIT_TOL} (request, step, prompt length "
          f"{recompute['worst_at']}; p50 {recompute['logit_err_rel_p50']:.3e},"
          f" p99 {recompute['logit_err_rel_p99']:.3e})")
    check(recompute["clear_margin_tokens_agree"], "a served token differs "
          "from the recompute's argmax where its margin is clear")
    timings = {n: attn_timings(n, kept[n]) for n in kept}
    # The tf32 route on the kept bf16 launches' f32 copies.
    k10_calls = kept["flash_attention"]
    del kept
    f32_calls = [(tuple(t.float() for t in a), kw) for a, kw in k10_calls]
    del k10_calls
    tf32 = attn_timings("flash_attention", f32_calls)
    tf32["bound_fma_ms"] = float(np.mean(
        [attn_bound_ms("flash_attention", a, kw, fp32_fma=True)[0]
         for a, kw in f32_calls]))
    del f32_calls
    k10, k10_sets = {}, {}
    for b in buckets:
        toks = torch.ones((1, b), dtype=torch.long, device=DEVICE)
        calls = []
        orig = flash.flash_attention

        def grab(q, k, v, **kw):
            if not calls:                  # the first layer's launch
                calls.append(((q.clone(), k.clone(), v.clone()), kw))
            return orig(q, k, v, **kw)

        flash.flash_attention = grab
        try:
            with torch.no_grad():
                model.prefill(params, toks)
        finally:
            flash.flash_attention = orig
        a, kw = calls[0]
        a32 = tuple(t.float() for t in a)
        k10[b] = {"bound_ms": attn_bound_ms("flash_attention", a, kw)[0],
                  "f32_bound_ms": attn_bound_ms("flash_attention", a32,
                                                kw)[0],
                  "f32_bound_fma_ms": attn_bound_ms(
                      "flash_attention", a32, kw, fp32_fma=True)[0]}
        k10_sets.update({
            (b, "ms"): [lambda a=a, kw=kw: orig(*a, **kw)],
            (b, "sdpa_ms"): [sdpa_call("flash_attention", a, kw)],
            (b, "f32_ms"): [lambda a32=a32, kw=kw: orig(*a32, **kw)],
            (b, "f32_sdpa_ms"): [sdpa_call("flash_attention", a32, kw)]})
        del calls
    for (b, key), ms in device_ms(k10_sets, reps=10).items():
        k10[b][key] = ms
    del k10_sets

    k11_shape = (LM_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.dh)
    k11_fills = k11_by_fill(k11_shape)

    # One warm tick under the profiler: eight requests decoding.
    peng = ServeEngine(model, params, num_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    for r in lm_traffic(cfg.vocab)[:LM_SLOTS]:
        peng.submit(r)
    peng.step()
    prof = profile_step(f"one warm LM decode tick ({LM_SLOTS} slots, {L} "
                        f"layers)", peng.step)
    del peng
    # One warm prefill of the largest bucket: the card's share of it.
    toks = torch.ones((1, LM_MAX_LEN), dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        prof_prefill = profile_step(
            f"one warm LM prefill ({LM_MAX_LEN} tokens, {L} layers)",
            lambda: model.prefill(params, toks)[0].cpu())
    # The tf32 route's own path: the reduced f32 model served on the card,
    # the launch counts set to 0 just before and read just after.
    tf32_calls = []
    lm.reset_launches()
    exact = lm_exact_f32_check(keep=tf32_calls)
    f32_launches = dict(lm.LAUNCHES)
    check(f32_launches.get("flash_attention.tf32", 0)
          == f32_launches.get("flash_attention", 0) == len(tf32_calls) > 0
          and "flash_attention.wgmma" not in f32_launches,
          f"f32 LM K10 launches {f32_launches}: expected all on the tf32 "
          f"route")
    # Each of those launches again, at the shapes that path gave it,
    # against the plain version (two launches bitwise equal).
    errs = [attn_check("flash_attention", a, kw) for a, kw in tf32_calls]
    tf32["path_max_abs_err"] = max(e[0] for e in errs)
    tf32["path_max_rel_err"] = max(e[1] for e in errs)
    print(f"flash_attention.tf32 on its own path's {len(errs)} launches "
          f"(the reduced f32 model, head dim {exact['head_dim']}, Sq "
          f"{min(a[0].shape[2] for a, _ in tf32_calls)}–"
          f"{max(a[0].shape[2] for a, _ in tf32_calls)}): max_abs_err "
          f"{tf32['path_max_abs_err']:.3e} "
          f"({tf32['path_max_rel_err']:.3e} of max |plain|), two launches "
          f"bitwise equal")
    del tf32_calls, errs
    # The ragged path: the same model at head dim 20, no multiple of 8,
    # every launch on the tf32 route with its last block zero-padded.
    ragged_calls = []
    lm.reset_launches()
    exact_ragged = lm_exact_f32_check(head_dim=RAGGED_HEAD_DIM,
                                      keep=ragged_calls)
    ragged_launches = dict(lm.LAUNCHES)
    check(ragged_launches.get("flash_attention.tf32", 0)
          == ragged_launches.get("flash_attention", 0)
          == len(ragged_calls) > 0, f"f32 LM K10 launches at head dim "
          f"{RAGGED_HEAD_DIM} {ragged_launches}: expected all on the tf32 "
          f"route")
    ragged = attn_timings("flash_attention", ragged_calls)
    del ragged_calls
    ragged_edges = k10_ragged_times()
    build, tf32_build = k10_build_reports()
    k11_build = k11_build_report(k11_shape)

    out = {"arch": LM_ARCH, "params": n_params, "layers": L,
           "init_s": init_s, "requests": len(reqs), "tokens": tokens,
           "ticks": eng.ticks, "wall_s": wall, "tokens_per_s": tokens / wall,
           "tick_p50_ms": float(np.percentile(decode_s, 50) * 1e3),
           "tick_p99_ms": float(np.percentile(decode_s, 99) * 1e3),
           "prefill_ms": prefill_ms, "peak_bytes": peak,
           "launches": launches, "edges": edges, "recompute": recompute,
           "k10_buckets": k10, "timings": timings, "tf32_f32": tf32,
           "ragged_f32": ragged, "f32_launches": f32_launches,
           "ragged_launches": ragged_launches,
           "exact_ragged": exact_ragged, "ragged_edges": ragged_edges,
           "k10_build": build, "k10_tf32_build": tf32_build,
           "k11_fills": k11_fills, "k11_build": k11_build,
           "profile": prof, "profile_prefill": prof_prefill,
           "exact_f32": exact, "card": card}
    print(f"LM serving: {json.dumps(out)}")
    print(f"LM serving {LM_ARCH} ({n_params / 1e9:.2f} B params, bf16, init "
          f"{init_s:.1f} s): {len(reqs)} requests, {tokens} tokens in "
          f"{eng.ticks} ticks, {wall:.3f} s: {tokens / wall:.1f} tokens/s; "
          f"decode tick p50 {out['tick_p50_ms']:.2f} ms, p99 "
          f"{out['tick_p99_ms']:.2f} ms; peak {peak} B; prefill ms by bucket "
          + ", ".join(f"{b}: {ms:.2f}" for b, ms in prefill_ms.items()))
    print(f"LM served vs f32 recompute {served_f32:.3e} of max |logit|, "
          f"bf16 recompute vs f32 {floor:.3e}")
    print(f"LM tokens vs full recompute: logits within "
          f"{recompute['logit_err_rel']:.3e} of max |logit| (p50 "
          f"{recompute['logit_err_rel_p50']:.3e}, p99 "
          f"{recompute['logit_err_rel_p99']:.3e}), "
          f"{recompute['tokens_agree']:.1%} of {recompute['tokens']} tokens "
          f"agree, all {recompute['tokens_clear_margin']} with a clear margin")
    for b, t in k10.items():
        print(f"flash_attention at a {b}-token prefill (device time): "
              f"wgmma {t['ms']:.4f} ms, SDPA {t['sdpa_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.5f} ms; at f32: tf32 {t['f32_ms']:.4f} ms, "
              f"SDPA {t['f32_sdpa_ms']:.4f} ms, bound {t['f32_bound_ms']:.5f}"
              f" ms (3 TF32 products; {t['f32_bound_fma_ms']:.5f} ms at the "
              f"fp32 FMA rate)")
    print(f"flash_attention on the kept launches' f32 copies: tf32 route "
          f"{tf32['ms']:.4f} ms, SDPA {tf32['library_ms']:.4f} ms a launch "
          f"(device); bound {tf32['bound_ms']:.5f} ms (3 TF32 products; "
          f"{tf32['bound_fma_ms']:.5f} ms at the fp32 FMA rate), "
          f"{tf32['flops'] / 1e9:.3f} GFLOP")
    for name, t in (*timings.items(),
                    ("flash_attention.tf32 at f32", tf32),
                    (f"flash_attention.tf32 at f32, ragged head dim "
                     f"{RAGGED_HEAD_DIM}", ragged)):
        print(f"{name} on {t['timed']} kept launches: {t['ms']:.4f} ms a "
              f"launch (device), plain {t['plain_ms']:.4f}, SDPA "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.5f} ms by "
              f"{t['bound_by']}; back-to-back launches {t['issue_ms']:.4f} "
              f"ms apart; max_abs_err {t['max_abs_err']:.3e} "
              f"({t['max_rel_err']:.3e} of max |plain|)")
    rows = []
    for name, source, t, n, edge in (
            ("flash_attention.wgmma", "flash_attention_sm90.cu",
             timings["flash_attention"], launches["flash_attention.wgmma"],
             edges["flash_attention.wgmma"]),
            ("flash_attention.tf32", "flash_attention_tf32.cu", tf32,
             f32_launches["flash_attention.tf32"]
             + ragged_launches["flash_attention.tf32"],
             (max(edges["flash_attention.tf32"][0], ragged["max_abs_err"],
                  ragged_edges["max_abs_err"]), 0.0)),
            ("decode_attention", "decode_attention.cu",
             timings["decode_attention"], launches["decode_attention"],
             edges["decode_attention"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": ATTN_REPLACES[name.split(".")[0]], "launches": n,
            "max_abs_err": max(t["max_abs_err"], edge[0],
                               t.get("path_max_abs_err", 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    out["rows"] = rows
    return out


class F32Layers:
    """A model's ``layers`` upcast to f32 one layer at a time as the trunk
    walks them (an f32 copy of all 40 granite layers would be 34 GB)."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        for layer in self.layers:
            yield _f32(layer)


def _f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    return {k: _f32(v) for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


# ---------------------------------------------------------------------------
# Phase 16: Mamba-2 serving (K12 SSD chunk scan)
# ---------------------------------------------------------------------------

#: The served Mamba-2 model at full width and depth; the LM phase's slot
#: pool and traffic plus four prompts: 1 and 2 tokens (the conv tail's
#: zero rows), 128 and 256 (whole chunks, no padding).
MAMBA_ARCH, MAMBA_EXTRA_PROMPTS = "mamba2-370m", (1, 2, 128, 256)
#: K12 against plain: bar relative to max |plain| by input type.  The
#: plain version widens the same bf16 inputs to f32, so both sides do f32
#: math on identical values and bf16 is held to the f32 bar.
K12_BARS = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
#: K12 edge cases (Bt, L, H, P, N, Q, pad), each at f32 and bf16, x/B/C
#: views of one ``xBC`` tensor of ``pad`` extra columns (1: a row stride no
#: multiple of 16 bytes, so 4-byte copies): a 1,024-token prefill, a
#: 600-token prompt padded to 640, one head with a ragged chunk of 37 and
#: N 16, chunks of one position, N 16 at 32 heads, 20 chunks of 30 heads
#: of 16, a 2-token and a 39-token prompt (one chunk of 2 and of 39), chunks
#: of 8 of 5 heads of 16, P 128 in chunks of 64, and two at an odd stride
#: (mamba2-370m's shapes; P 48 and N 40 in a chunk of 100).
K12_EDGES = ((1, 1024, 32, 64, 128, 128, 0), (1, 640, 32, 64, 128, 128, 0),
             (2, 74, 1, 64, 16, 37, 0), (1, 5, 32, 64, 128, 1, 0),
             (1, 256, 32, 64, 16, 128, 0), (1, 2560, 30, 16, 16, 128, 0),
             (1, 2, 32, 64, 128, 2, 0), (1, 39, 32, 64, 128, 39, 0),
             (3, 24, 5, 16, 128, 8, 0), (1, 128, 4, 128, 128, 64, 0),
             (1, 256, 32, 64, 128, 128, 1), (1, 100, 3, 48, 40, 100, 1))
#: ``ops.ssd`` (padding to the chunk, K12, the cross-chunk code, ``D`` and
#: an initial state) against the same composition on the CPU:
#: (L, chunk, with an initial state).
K12_OPS_EDGES = ((600, 128, True), (37, 128, False), (1, 128, True))
#: Served logits against a teacher-forced recompute, relative to max
#: |logit|: the model is f32 end to end, so the bar is the f32 one of the
#: reference's tests; a token whose recompute top-2 margin is wider than
#: twice the bar cannot flip and must match.
MAMBA_LOGIT_TOL = 1e-4
MAMBA_MARGIN = 2 * MAMBA_LOGIT_TOL
#: Prompt lengths whose prefill is timed; K12 is timed alone at the
#: padded lengths of most of them and at 2 and 39 tokens (Q = min(128,
#: L): a chunk of 2 and a ragged one-chunk prompt).
MAMBA_PREFILL_LENS = (1, 16, 128, 256, 600, 1024)
K12_TIMED_LENS = (2, 16, 39, 128, 256, 640, 1024)


def k12_inputs(gen, Bt, L, H, P, N, dtype, pad: int = 0):
    """x, dt, A, B, C with x/B/C strided views of one ``xBC`` tensor (of
    ``pad`` columns more), as the model's conv output gives them."""
    Din = H * P
    xBC = torch.randn(Bt, L, Din + 2 * N + pad, generator=gen).to(DEVICE,
                                                                 dtype)
    x = xBC[..., :Din].reshape(Bt, L, H, P)
    dt = torch.nn.functional.softplus(
        torch.randn(Bt, L, H, generator=gen) - 2.0).to(DEVICE)
    A = (-torch.exp(torch.randn(H, generator=gen) * 0.5)).to(DEVICE)
    return x, dt, A, xBC[..., Din:Din + N], xBC[..., Din + N:Din + 2 * N]


def k12_plain(args):
    x, dt, A, B, C, Q = args
    return ref.ssd_chunk_diag(x.float(), dt, A, B.float(), C.float(), Q)


def k12_check(args, twice: bool = True) -> tuple:
    """K12 against its plain version on ``args`` (x, dt, A, B, C, Q):
    finite, two launches bitwise equal (``twice``), ``y_diag`` and the
    states each within the input type's bar of max |plain|.  Returns
    (max abs err, err / max |plain|)."""
    got = mssd.ssd_chunk_diag(*args)
    again = mssd.ssd_chunk_diag(*args) if twice else got
    want = k12_plain(args)
    torch.cuda.synchronize()
    errs = []
    for g, a, w, what in zip(got, again, want, ("y_diag", "states")):
        check(torch.equal(g, a), f"ssd_chunk_scan: two launches differ "
              f"({what})")
        check(bool(torch.isfinite(g).all()), f"ssd_chunk_scan: non-finite "
              f"{what}")
        err = float((g - w).abs().max())
        rel = err / max(float(w.abs().max()), 1e-30)
        check(rel <= K12_BARS[args[0].dtype], f"ssd_chunk_scan disagrees "
              f"with its plain version on {what}: {rel:.3e} of max |plain| "
              f"at x {tuple(args[0].shape)} N {args[3].shape[-1]} Q "
              f"{args[5]} {args[0].dtype}")
        errs.append((err, rel))
    return tuple(map(max, *errs))


def k12_bound_ms(args) -> tuple:
    """Least time of one K12 launch on ``args``: over the Q (Q + 1) / 2
    causal pairs j <= i of a chunk, ``C Bᵀ`` once a chunk (2 N a pair)
    and, a head, ``y_diag`` (2 P a pair) and the state (2 Q P N), as the
    three TF32 products an operation that K12 runs on the tensor cores at
    495 TFLOP/s, against x, B, C and dt read once and y_diag and the
    states written once (f32) at 3.35 TB/s (``priced_ms``).  Returns
    (bound_ms, bound_by, flops, bytes, bound_fma_ms), the last at the 67
    TFLOP/s fp32-FMA rate."""
    x, dt, A, B, C, Q = args
    Bt, L, H, P = x.shape
    N, nc, e = B.shape[-1], L // Q, x.element_size()
    pairs = Q * (Q + 1) // 2
    flops = float(Bt * nc * (2 * pairs * N + H * (2 * pairs * P
                                                  + 2 * Q * P * N)))
    nbytes = float(e * Bt * L * (H * P + 2 * N) + 4 * Bt * L * H
                   + 4 * Bt * L * H * P + 4 * Bt * nc * H * P * N)
    b_ms, b_by, fma_ms = priced_ms(flops, nbytes, True)
    return b_ms, b_by, flops, nbytes, fma_ms


def k12_edges_check() -> dict:
    """K12 on ``K12_EDGES`` (f32 and bf16), ``ops.ssd`` on
    ``K12_OPS_EDGES`` against the CPU composition, a backward refused;
    mamba2-370m's shapes at ``K12_TIMED_LENS`` timed by ``torch.profiler``
    device time beside their bound and the plain version, and with CUDA
    events around back-to-back calls (paced by the wrapper's host cost
    where the launch is short)."""
    gen = torch.Generator().manual_seed(1212)
    worst = (0.0, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for Bt, L, H, P, N, Q, pad in K12_EDGES:
            args = (*k12_inputs(gen, Bt, L, H, P, N, dtype, pad), Q)
            worst = tuple(map(max, worst, k12_check(args)))
    for L, chunk, init in K12_OPS_EDGES:
        x, dt, A, B, C = k12_inputs(gen, 1, L, 32, 64, 128, torch.float32)
        D = torch.rand(32, generator=gen).to(DEVICE)
        s0 = (torch.randn(1, 32, 64, 128, generator=gen).to(DEVICE)
              if init else None)
        n0 = lm.LAUNCHES["ssd_chunk_scan"]
        y, s = ops.ssd(x, dt, A, B, C, D, chunk=chunk, initial_state=s0)
        check(lm.LAUNCHES["ssd_chunk_scan"] == n0 + 1,
              "ops.ssd on the card did not launch K12 once")
        yc, sc = ops.ssd(*(t.cpu() for t in (x, dt, A, B, C, D)),
                         chunk=chunk,
                         initial_state=None if s0 is None else s0.cpu())
        for g, w, what in ((y, yc, "y"), (s, sc, "final state")):
            rel = float((g.cpu() - w).abs().max()) / float(w.abs().max())
            check(rel <= K12_BARS[torch.float32], f"ops.ssd on the card vs "
                  f"the CPU composition at L {L}: {what} {rel:.3e} of max "
                  f"|plain|")
    x, dt, A, B, C = k12_inputs(gen, 1, 16, 2, 16, 16, torch.float32)
    try:
        with torch.enable_grad():
            mssd.ssd_chunk_diag(x.detach().requires_grad_(), dt, A, B, C, 16)
        fail("ssd_chunk_scan took an input that needs a gradient")
    except NotImplementedError:
        pass
    print(f"ssd_chunk_scan vs plain, edge cases (f32 and bf16): max_abs_err "
          f"{worst[0]:.3e}, {worst[1]:.3e} of max |plain|; ops.ssd padded "
          f"and with an initial state within {K12_BARS[torch.float32]} of "
          f"the CPU composition; a backward refused")
    by_len, sets = {}, {}
    for L in K12_TIMED_LENS:
        a = (*k12_inputs(gen, 1, L, 32, 64, 128, torch.float32),
             min(128, L))
        _b, by, flops, nbytes, fma = k12_bound_ms(a)
        by_len[L] = {
            "events_ms": time_ms(lambda: mssd.ssd_chunk_diag(*a), 20, 3),
            "bound_ms": _b, "bound_by": by, "bound_fma_ms": fma,
            "flops": flops, "bytes": nbytes,
            "plan": mssd.ssd_plan(1, L // a[5], a[5], 32, 64, 128,
                                  lm._sm_count(a[0].device))}
        # 200 rounds: one launch is one profiler event, and a recording
        # may lose 1 % of them.
        sets[L, "ms"] = {"calls": [lambda a=a: mssd.ssd_chunk_diag(*a)],
                         "reps": 200}
        sets[L, "plain_ms"] = {"calls": [lambda a=a: k12_plain(a)],
                               "reps": 3}
    for (L, key), ms in device_ms(sets).items():
        by_len[L][key] = ms
    for L, t in by_len.items():
        print(f"ssd_chunk_scan at {L} tokens: {t['ms']:.4f} ms (device), "
              f"{t['events_ms']:.4f} ms a call back to back (CUDA events), "
              f"plain {t['plain_ms']:.4f} ms (device), bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} (fp32 FMA "
              f"{t['bound_fma_ms']:.5f}; {t['flops'] / 1e9:.3f} GFLOP, "
              f"{t['bytes'] / 1e6:.1f} MB); plan (HG, NS, R, CTAs) "
              f"{t['plan']}")
    return {"max_abs_err": worst[0], "max_rel_err": worst[1],
            "by_length": by_len}


def mamba_traffic(vocab: int):
    """The LM phase's 16 requests and four more, of ``MAMBA_EXTRA_PROMPTS``
    tokens (the second half still submitted after ``LM_STAGGER`` ticks)."""
    reqs = lm_traffic(vocab)
    rng = np.random.default_rng(1)
    return reqs + [Request(len(reqs) + i, rng.integers(0, vocab, n),
                           max_new_tokens=LM_NEW)
                   for i, n in enumerate(MAMBA_EXTRA_PROMPTS)]


def k12_kept_args(x, dt, A, B, C, Q):
    """A copy of one launch's arguments in the launch's own layout: x, B
    and C again strided views of one fresh ``xBC`` tensor where they were
    views (the model's path), else plain clones (a padded prompt)."""
    if x.is_contiguous():
        return (x.clone(), dt.clone(), A.clone(), B.clone(), C.clone(), Q)
    Bt, L, H, P = x.shape
    Din = H * P
    xBC = torch.cat([x.reshape(Bt, L, Din), B, C], dim=-1)
    return (xBC[..., :Din].reshape(Bt, L, H, P), dt.clone(), A.clone(),
            xBC[..., Din:Din + B.shape[-1]], xBC[..., Din + B.shape[-1]:], Q)


def mamba_serving_phase(card: str) -> dict:
    """mamba2-370m at full width and depth (f32, weights from a CUDA
    ``torch.Generator`` seed) served through ``ServeEngine(pad_prompts=
    False)``: the K12 edge cases, the main path with its launch counts, a
    tapped re-run (every ``TAP_EVERY``-th K12 launch kept, checked and
    timed; every sampled row of logits kept for the teacher-forced
    recompute), a profile of one warm tick, and the reduced model's f32
    exactness."""
    edges = k12_edges_check()
    build = k12_build_report()
    torch.cuda.empty_cache()
    cfg = get_config(MAMBA_ARCH)
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    L = len(model.descs)
    serve_kw = {"prefill_kernel": "ssd_chunk_scan", "pad_prompts": False}
    # Warm the kernel, cuBLAS and the allocator on two short requests.
    lm_serve(model, params, [Request(i, np.arange(1, 20), max_new_tokens=2)
                             for i in range(2)], **serve_kw)

    reqs = mamba_traffic(cfg.vocab)
    ticks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    t0 = time.perf_counter()
    eng = lm_serve(model, params, reqs, ticks, **serve_kw)
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(r.status == "ok" for r in reqs), "a Mamba request did not end "
          "ok: " + ", ".join(f"{r.request_id}:{r.status}:{r.error}"
                             for r in reqs if r.status != "ok"))
    check(launches == {"ssd_chunk_scan": L * len(reqs)},
          f"Mamba launches {launches}: expected {L} K12 a prompt "
          f"({len(reqs)} prompts), none a decode tick and no other kernel")
    check(all(len(r.output) == LM_NEW for r in reqs),
          "a Mamba request stopped short of its max_new_tokens")
    tokens = sum(len(r.output) for r in reqs)
    decode_s = np.asarray([s for s, admitted in ticks if not admitted])

    # Prefill time by prompt length, outside the main path (host clock,
    # synced).
    prefill_ms = {}
    with torch.no_grad():
        for n in MAMBA_PREFILL_LENS:
            toks = torch.ones((1, n), dtype=torch.long, device=DEVICE)
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                model.prefill(params, toks)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t1) * 1e3)
            prefill_ms[n] = float(np.median(runs))

    # The tapped re-run: the same traffic through a fresh engine.
    kept, seen = [], [0]
    inner = mssd.ssd_chunk_diag

    def tap(x, dt, A, B, C, Q):
        if seen[0] % TAP_EVERY == 0:
            kept.append(k12_kept_args(x, dt, A, B, C, Q))
        seen[0] += 1
        return inner(x, dt, A, B, C, Q)

    mssd.ssd_chunk_diag = tap
    try:
        reqs2 = mamba_traffic(cfg.vocab)
        served = lm_serve(model, params, reqs2, engine=KeepRows,
                          **serve_kw).rows
    finally:
        mssd.ssd_chunk_diag = inner
    check(seen[0] == L * len(reqs2), f"the tapped re-run launched K12 "
          f"{seen[0]} times, not {L * len(reqs2)}")
    check([r.output for r in reqs2] == [r.output for r in reqs],
          "the tapped re-run served other tokens than the main path")
    want = lm_recompute(model, params, reqs2)
    recompute = logit_agreement(reqs2, served, want, margin=MAMBA_MARGIN)
    del served, want
    check(recompute["logit_err_rel"] <= MAMBA_LOGIT_TOL, f"served logits vs "
          f"teacher-forced recompute: {recompute['logit_err_rel']:.3e} of "
          f"max |logit| > {MAMBA_LOGIT_TOL} (request, step, prompt length "
          f"{recompute['worst_at']}; p50 {recompute['logit_err_rel_p50']:.3e},"
          f" p99 {recompute['logit_err_rel_p99']:.3e})")
    check(recompute["clear_margin_tokens_agree"], "a served token differs "
          "from the recompute's argmax where its margin is clear")

    errs = [k12_check(a, twice=False) for a in kept]
    bounds = [k12_bound_ms(a) for a in kept]
    by_ops = sum(b[0] for b in bounds if b[1] == "operations")
    timings = {
        "timed": len(kept), "max_abs_err": max(e[0] for e in errs),
        "max_rel_err": max(e[1] for e in errs),
        "bound_ms": float(np.mean([b[0] for b in bounds])),
        "bound_fma_ms": float(np.mean([b[4] for b in bounds])),
        "flops": float(np.mean([b[2] for b in bounds])),
        "bytes": float(np.mean([b[3] for b in bounds])),
        # Ten rounds: a profiler recording may lose its first few events
        # (one K12 launch is one event); the loss must stay within 1 %.
        **device_ms({
            "ms": {"calls": [lambda a=a: mssd.ssd_chunk_diag(*a)
                             for a in kept], "reps": 10},
            "plain_ms": {"calls": [lambda a=a: k12_plain(a) for a in kept],
                         "reps": 1}}),
        "bound_by": ("operations" if by_ops >= sum(b[0] for b in bounds) / 2
                     else "bytes")}
    del kept

    # One warm tick under the profiler: eight requests decoding.
    peng = ServeEngine(model, params, num_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       pad_prompts=False)
    for r in mamba_traffic(cfg.vocab)[:LM_SLOTS]:
        peng.submit(r)
    peng.step()
    prof = profile_step(f"one warm Mamba-2 decode tick ({LM_SLOTS} slots, "
                        f"{L} layers)", peng.step)
    del peng
    toks = torch.ones((1, 600), dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        prof_prefill = profile_step(
            f"one warm Mamba-2 prefill (600 tokens, {L} layers)",
            lambda: model.prefill(params, toks)[0].cpu())
    exact = lm_exact_f32_check(MAMBA_ARCH, pad_prompts=False)

    out = {"arch": MAMBA_ARCH, "params": n_params, "layers": L,
           "init_s": init_s, "requests": len(reqs), "tokens": tokens,
           "ticks": eng.ticks, "wall_s": wall, "tokens_per_s": tokens / wall,
           "tick_p50_ms": float(np.percentile(decode_s, 50) * 1e3),
           "tick_p99_ms": float(np.percentile(decode_s, 99) * 1e3),
           "prefill_ms": prefill_ms, "peak_bytes": peak,
           "launches": launches, "edges": edges, "recompute": recompute,
           "timings": timings, "build": build, "profile": prof,
           "profile_prefill": prof_prefill, "exact_f32": exact,
           "card": card}
    print(f"Mamba-2 serving: {json.dumps(out)}")
    print(f"Mamba-2 serving {MAMBA_ARCH} ({n_params / 1e6:.1f} M params, "
          f"f32, init {init_s:.1f} s): {len(reqs)} requests, {tokens} tokens "
          f"in {eng.ticks} ticks, {wall:.3f} s: {tokens / wall:.1f} "
          f"tokens/s; decode tick p50 {out['tick_p50_ms']:.2f} ms, p99 "
          f"{out['tick_p99_ms']:.2f} ms; peak {peak} B; prefill ms by prompt "
          "length " + ", ".join(f"{n}: {ms:.2f}"
                                for n, ms in prefill_ms.items()))
    print(f"Mamba-2 tokens vs teacher-forced recompute: logits within "
          f"{recompute['logit_err_rel']:.3e} of max |logit| (p50 "
          f"{recompute['logit_err_rel_p50']:.3e}, p99 "
          f"{recompute['logit_err_rel_p99']:.3e}), "
          f"{recompute['tokens_agree']:.1%} of {recompute['tokens']} tokens "
          f"agree, all {recompute['tokens_clear_margin']} with a clear margin")
    t = timings
    print(f"ssd_chunk_scan on {t['timed']} kept launches: {t['ms']:.4f} ms a "
          f"launch (device), plain {t['plain_ms']:.4f}, bound "
          f"{t['bound_ms']:.5f} ms by {t['bound_by']} (fp32 FMA "
          f"{t['bound_fma_ms']:.5f}); max_abs_err "
          f"{t['max_abs_err']:.3e} ({t['max_rel_err']:.3e} of max |plain|)")
    out["rows"] = [{
        "name": "ssd_chunk_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_sm90.cu",
        "replaces": mssd.REPLACES, "launches": launches["ssd_chunk_scan"],
        "max_abs_err": max(t["max_abs_err"], edges["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "bound_fma_ms": t["bound_fma_ms"],
        "library_ms": None}]
    return out


# ---------------------------------------------------------------------------
# Phase 18: composed training (the example's default leg)
# ---------------------------------------------------------------------------

def composed_run(ex, fn, ds, prefetch: bool) -> dict:
    """``TRAIN_STEPS`` steps of the example's default leg from the init of
    seed 0: ``ComposedBatchSource`` over ``ds`` (labels as riders) into a
    fresh pipeline, packed on its background thread (``prefetch``) or
    inline on this thread; launch counts set to 0 just before and read
    just after."""
    from repro_torch.optim import warmup_cosine
    params = ex.init_params(fn, 0, DEVICE)
    opt = adamw_init(params)
    lr = warmup_cosine(3e-3, 20, TRAIN_STEPS)
    pipe = SchedulePipeline(fn.input_dim,
                            bucket_policy=BucketPolicy(mode="pow2"),
                            with_runs=True, device=DEVICE)
    source = ex.composed_source(ds, pipe, BATCH)
    batches = pipe.prefetch(source, depth=2) if prefetch \
        else (pipe.pack(*item) for item in source)
    torch.cuda.synchronize()
    lm.reset_launches()
    losses, step_s, wait_s, packs, kept = [], [], [], [], []
    try:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            b = next(batches)
            t1 = time.perf_counter()
            loss, _acc = ex.train_step(fn, params, opt, b,
                                       ex.labels_of(b, DEVICE), lr(opt.step))
            losses.append(float(loss))     # waits for the step's work
            step_s.append(time.perf_counter() - t0)
            wait_s.append(t1 - t0)
            packs.append(pipe.cache.packs)
            kept.append(b)
    finally:
        if prefetch:
            batches.close()
    return {"losses": losses, "step_s": step_s, "wait_s": wait_s,
            "packs": packs, "batches": kept, "launches": dict(lm.LAUNCHES),
            "pipe": pipe, "source": source}


def composed_train_phase(card: str, fifo: dict) -> dict:
    """The example's default leg at full width: ``TRAIN_DATA`` SST-like
    parses of seed 0 composed into batches of ``BATCH`` (pow2 buckets),
    prefetched two ahead, AdamW warmup-cosine, ``TRAIN_STEPS`` steps.
    Every batch's host schedule byte-identical to ``pack_batch`` of its
    graphs at the composer's pads and its ext to ``pack_external``; its
    labels the corpus's at its ``sample_ids``; no pack from epoch 2 on;
    one K1 a padded level, one K2 a level with a live slot, one K7 a
    step; the losses equal, within 1e-6 relative, those of the same
    batches packed inline on this thread."""
    ex = _example()
    cfg = get_paper_model("tree_lstm")
    fn = cfg.make_vertex(hidden=HIDDEN, input_dim=cfg.input_dim)
    ds = sst_like_dataset(TRAIN_DATA, input_dim=cfg.input_dim, seed=0)
    run = composed_run(ex, fn, ds, prefetch=True)
    inline = composed_run(ex, fn, ds, prefetch=False)
    losses, launches = run["losses"], run["launches"]
    plan, _ = run["pipe"].composer(BATCH).compose(
        ds.graphs, ds.inputs, {"labels": list(ds.labels)})
    nb = len(plan)
    padded, work = 0, [0, 0]
    for i, b in enumerate(run["batches"]):
        cb = plan[i % nb]
        ids = np.asarray(b.aux["sample_ids"])
        check(np.array_equal(ids, cb.sample_ids),
              f"composed step {i}: sample ids differ from the composer's")
        check(list(b.aux["labels"]) == list(ds.labels[ids]),
              f"composed step {i}: labels do not realign by sample_ids")
        want = pack_batch(cb.graphs, *cb.pads, with_runs=True)
        check(_sched_equal(b.sched, want), f"composed step {i}: the "
              f"schedule differs from pack_batch at the composer's pads "
              f"{cb.pads}")
        check(np.array_equal(b.ext.cpu().numpy(), pack_external(
            cb.inputs, want, fn.input_dim)),
            f"composed step {i}: ext differs from pack_external")
        padded += b.sched.T
        work = [x + y for x, y in zip(work, k2_design(b.dev))]
    check(all(p == nb for p in run["packs"][nb - 1:]),
          f"packs after each step {run['packs']}: not {nb} from epoch 2 on")
    check(bool(np.isfinite(losses).all()), f"non-finite losses: {losses}")
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(losses, inline["losses"]))
    check(rel <= 1e-6, f"prefetched losses vs inline: {rel:.3e} relative")
    check(launches.get("treelstm_megastep", 0) == padded,
          f"{launches.get('treelstm_megastep', 0)} K1 launches for "
          f"{padded} padded levels")
    check(launches.get("treelstm_bwd_megastep", 0) == work[0],
          f"{launches.get('treelstm_bwd_megastep', 0)} K2 launches for "
          f"{work[0]} levels with a live slot")
    check(launches.get("scatter_add_rows", 0) == TRAIN_STEPS,
          f"{launches.get('scatter_add_rows', 0)} K7 launches for "
          f"{TRAIN_STEPS} steps")
    stats = run["pipe"].stats()
    out = {"steps": TRAIN_STEPS, "batches_per_epoch": nb,
           "loss_first": losses[0], "loss_last": losses[-1],
           "max_rel_vs_inline": rel,
           "step_p50_ms": _pct(run["step_s"], 50),
           "step_p99_ms": _pct(run["step_s"], 99),
           "wait_p50_ms": _pct(run["wait_s"], 50),
           "wait_p99_ms": _pct(run["wait_s"], 99),
           "inline_step_p50_ms": _pct(inline["step_s"], 50),
           "inline_pack_p50_ms": _pct(inline["wait_s"], 50),
           "fifo_step_p50_ms": fifo["step_p50_ms"],
           "hit_rate": stats["hit_rate"], "packs": stats["packs"],
           "compiled_shapes": stats["compiled_shapes"],
           "composer": run["source"].stats.summary(),
           "launches": {k: launches.get(k, 0) for k in (
               "treelstm_megastep", "treelstm_bwd_megastep",
               "scatter_add_rows")},
           "card": card}
    print("composed losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"composed training: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 19: spliced structure serving and a warm restart
# ---------------------------------------------------------------------------

def _sched_equal(got, want) -> bool:
    return all(
        (a is None) == (w is None) and (a is None or (
            a.dtype == w.dtype and a.tobytes() == w.tobytes()))
        for a, w in ((getattr(got, f.name), getattr(want, f.name))
                     for f in dataclasses.fields(want)))


def serve_order(eng, ds, order) -> tuple:
    """Score ``ds``'s requests submitted in ``order`` through ``eng``:
    (roots by request id, [(host s, graphs, host schedule)] a pack)."""
    calls, inner = [], eng.pipeline.pack

    def pack(graphs, inputs, *a, **k):
        t0 = time.perf_counter()
        b = inner(graphs, inputs, *a, **k)
        calls.append((time.perf_counter() - t0, list(graphs), b.sched))
        return b
    eng.pipeline.pack = pack
    reqs = [StructureRequest(int(i), ds.graphs[i], ds.inputs[i])
            for i in order]
    try:
        for r in reqs:
            check(eng.submit(r), f"request {r.request_id} rejected: "
                  f"{r.error}")
        eng.run()
    finally:
        del eng.pipeline.pack
    check(all(r.status == "ok" for r in reqs),
          f"{sum(r.status != 'ok' for r in reqs)} request(s) not ok")
    roots = np.stack([r.root_state for r in
                      sorted(reqs, key=lambda r: r.request_id)])
    return roots, calls


def spliced_serving_phase(card: str) -> dict:
    """``StructureServeEngine`` over the served traffic with a fresh
    on-disk store under ``build/``: the requests in order (cold packs,
    harvested), then in a seeded permutation (every batch a new
    combination of seen graphs: spliced, byte-identical to
    ``pack_batch``, roots bit for bit those of cold packs in a fresh
    pipeline), then a fresh engine on the same store (batch disk loads
    and splices from per-graph disk entries: no pack of either kind, the
    same roots), then the first order again (memory hits).
    ``pipeline.pack`` host time for each kind of lookup."""
    import tempfile
    fn, params, ds = served_traffic()
    (ROOT / "build").mkdir(exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="sched_store_", dir=ROOT / "build"))

    def engine(cache):
        return StructureServeEngine(
            fn, params, batch_size=BATCH, device=DEVICE,
            pipeline=SchedulePipeline(
                fn.input_dim, bucket_policy=BucketPolicy(mode="pow2"),
                with_runs=False, cache=cache, device=DEVICE))

    def stats(eng):
        return eng.pipeline.cache.stats()

    order_a = np.arange(len(ds.graphs))
    order_b = np.random.default_rng(1).permutation(len(ds.graphs))
    try:
        eng = engine(ScheduleCache(persist=store))
        harvest_s = timed_calls(eng.pipeline.cache, "_harvest")
        store_s = timed_calls(eng.pipeline.cache.persist, "store")
        roots_a, cold = serve_order(eng, ds, order_a)
        s1 = stats(eng)
        check(s1["packs"] == len(cold) and s1["splices"] == 0,
              f"first pass: {s1['packs']} packs, {s1['splices']} splices "
              f"for {len(cold)} batches")
        roots_b, spliced = serve_order(eng, ds, order_b)
        s2 = stats(eng)
        check(s2["splices"] - s1["splices"] == len(spliced)
              and s2["packs"] == s1["packs"],
              f"permuted pass: {s2['splices'] - s1['splices']} splices, "
              f"{s2['packs'] - s1['packs']} packs for {len(spliced)} "
              f"batches")
        for _t, graphs, sched in cold + spliced:
            check(_sched_equal(sched, pack_batch(
                graphs, sched.T, sched.M, sched.A, sched.N,
                with_runs=False)),
                "a served schedule differs from pack_batch")
        fresh = engine(ScheduleCache(splice=False, persist=False))
        roots_c, cold_b = serve_order(fresh, ds, order_b)
        check([[id(g) for g in c[1]] for c in cold_b]
              == [[id(g) for g in c[1]] for c in spliced],
              "the fresh pipeline formed other batches")
        check(stats(fresh)["packs"] == len(cold_b),
              "the fresh pipeline did not cold-pack every batch")
        check(np.array_equal(roots_c.view(np.int32),
                             roots_b.view(np.int32)),
              "roots from spliced schedules differ from cold packs' "
              f"(max {np.abs(roots_c - roots_b).max():.3e})")

        warm = engine(ScheduleCache(persist=store))
        roots_wa, disk = serve_order(warm, ds, order_a)
        roots_wb, disk_spliced = serve_order(warm, ds, order_b)
        sw = stats(warm)
        check(sw["packs"] == 0 and sw["graph_packs"] == 0,
              f"warm restart: {sw['packs']} packs, {sw['graph_packs']} "
              f"graph packs")
        check(sw["disk_hits"] == len(disk)
              and sw["splices"] == len(disk_spliced),
              f"warm restart: {sw['disk_hits']} disk hits, "
              f"{sw['splices']} splices")
        for _t, graphs, sched in disk + disk_spliced:
            check(_sched_equal(sched, pack_batch(
                graphs, sched.T, sched.M, sched.A, sched.N,
                with_runs=False)),
                "a warm-loaded schedule differs from pack_batch")
        for got, want, what in ((roots_wa, roots_a, "disk-loaded"),
                                (roots_wb, roots_b, "warm spliced")):
            check(np.array_equal(got.view(np.int32), want.view(np.int32)),
                  f"{what} roots differ from the first engine's")
        _roots, hits = serve_order(warm, ds, order_a)
        sh = stats(warm)
        check(sh["hits"] - sw["hits"] == len(hits),
              "the repeated pass was not all memory hits")
    finally:
        shutil.rmtree(store, ignore_errors=True)

    def times(calls):
        s = [c[0] for c in calls]
        return {"p50_ms": _pct(s, 50), "p99_ms": _pct(s, 99), "n": len(s)}
    out = {"batches": len(cold),
           "pack": {"cold (harvest, persist)": times(cold),
                    "cold, splice off": times(cold_b),
                    "splice": times(spliced), "disk load": times(disk),
                    "splice from disk": times(disk_spliced),
                    "memory hit": times(hits)},
           "harvest_p50_ms": _pct(harvest_s, 50),
           "persist_store_p50_ms": _pct(store_s, 50),
           "persist_stores": len(store_s),
           "warm": {k: sw[k] for k in ("packs", "graph_packs", "disk_hits",
                                       "splices", "graph_disk_hits")},
           "card": card}
    print(f"spliced serving: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the examples on the card, and the sharded pipeline
# ---------------------------------------------------------------------------

def examples_phase(card: str) -> dict:
    """``torch_quickstart.main([])``; ``torch_encoder_decoder`` at hidden
    ``HIDDEN``, input 256, batch ``BATCH`` (one K3 a level, outputs within
    1e-4 of the op-by-op path on the same card tensors); a two-replica
    ``ShardedPipeline``'s stacked step equal to each replica's own
    pack."""
    from repro_torch.pipeline import ShardedPipeline
    qs = load_example("torch_quickstart").main([])
    check(bool(np.isfinite([qs["loss"], qs["loss2"]]).all()),
          f"quickstart losses {qs}")
    ed = load_example("torch_encoder_decoder")
    X = get_paper_model("tree_lstm").input_dim
    enc, dec, params = ed.make_model(X, HIDDEN, DEVICE)
    src, tgt = ed.make_data(BATCH, X)
    torch.cuda.synchronize()
    lm.reset_launches()
    out = ed.encode_decode(enc, dec, params, src, tgt, DEVICE)
    torch.cuda.synchronize()
    k3 = lm.LAUNCHES.get("lstm_megastep", 0)
    levels = ed.SRC_LEN + ed.TGT_LEN
    check(k3 == levels, f"encoder-decoder: {k3} K3 launches for {levels} "
          f"levels")
    plain = ed.encode_decode(enc, dec, params, src, tgt, DEVICE,
                             fusion_mode="none")
    err = max(float((out[k] - plain[k]).abs().max()) for k in out)
    check(err <= TOL, f"encoder-decoder vs op-by-op: {err:.3e} > {TOL}")
    check(bool(torch.isfinite(out["outs"]).all()), "non-finite outputs")

    ds = sst_like_dataset(TRAIN_DATA, input_dim=X, seed=0)
    sp = ShardedPipeline(X, 2, bucket_policy=BucketPolicy(mode="pow2"),
                         device=DEVICE)
    steps, sstats = sp.composer(BATCH).compose_sharded(
        ds.graphs, ds.inputs, {"labels": list(ds.labels)}, num_shards=2)
    for st in steps[:3]:
        got = sp.pack_step(st)
        for r, rep in enumerate(st.replicas):
            own = SchedulePipeline(X, cache=ScheduleCache(persist=False),
                                   device=DEVICE).pack(
                rep.graphs, rep.inputs, pads=st.pads)
            check(torch.equal(got["ext"][r], own.ext),
                  f"sharded ext of replica {r} differs from its own pack")
            for f in dataclasses.fields(own.dev):
                a, w = getattr(got["dev"], f.name), getattr(own.dev, f.name)
                if isinstance(w, torch.Tensor):
                    check(torch.equal(a[r], w), f"sharded {f.name} of "
                          f"replica {r} differs from its own pack")
            check(got["dev"].live[r] == own.dev.live,
                  f"sharded live counts of replica {r} differ")
    res = {"quickstart": qs, "encdec_k3_launches": k3,
           "encdec_err": err, "sharded_steps": len(steps),
           "sharded_node_imbalance": sstats.node_imbalance, "card": card}
    print(f"examples: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# Phase 21: the trainer
# ---------------------------------------------------------------------------

def trainer_stream(ex, items, pipe, *, counts=None, times=None,
                   replay=None, poison=None):
    """Phase 5's FIFO batches as trainer batch dicts: batch ``i`` is
    ``items[i % len(items)]`` packed by ``pipe``.  ``counts`` adds each
    batch's padded levels and its K1/K2 design; ``times`` takes the host
    clock at each request; ``replay = (injector, trainer)`` goes back to
    the trainer's newest commit after the injector fires (a loader that
    checkpoints its position); batch ``poison`` comes with a NaN ext."""
    i, fired = 0, 0
    while True:
        if replay is not None and len(replay[0].failures) > fired:
            fired = len(replay[0].failures)
            i = replay[1].ckpt.latest_step()
        if times is not None:
            times.append(time.perf_counter())
        graphs, inputs, labels = items[i % len(items)]
        b = pipe.pack(graphs, inputs)
        if counts is not None:
            counts["padded"] += b.sched.T
            counts["fwd_cuda"] += sum(fwd_designed(b.dev.M, live)
                                      for live in b.dev.live)
            k2 = k2_design(b.dev)
            counts["k2"] += k2[0]
            counts["k2_cuda"] += k2[1]
        ext = torch.full_like(b.ext, float("nan")) if i == poison else b.ext
        yield {"dev": b.dev, "ext": ext, "labels": labels.astype(np.int64)}
        i += 1


def _state_equal(a, b) -> bool:
    """Params and both AdamW moments bit for bit, and the step."""
    from repro_torch.optim.adamw import tree_leaves
    return a.step == b.step and all(
        bitwise_equal(x, y) for x, y in zip(
            *(tree_leaves({"p": s.params, "mu": s.opt.mu, "nu": s.opt.nu})
              for s in (a, b))))


def trainer_phase(card: str, fifo: dict) -> dict:
    """``Trainer.fit`` over phase 5's model and data (the paper's
    tree_lstm at full width from seed 0, the FIFO batches of 64, pow2
    buckets with sorted runs, ``warmup_cosine(3e-3, 20, 30)``, no weight
    decay): (a) a clean fit, checkpoints every 10 steps (keep 2), its
    losses bit for bit phase 5's example loop's; (b) a fault at step 15
    restored from step 10, the data replayed from there, ending bit for
    bit where (a) ends, as does (a) without the guard and with one log (no
    host read a step); (c) a NaN ext skipped, nothing written; (d) over
    (a), one K1 a padded level, one K2 a level with a live slot, one K7 a
    step; (e) 8 steps of ``fit(compose=, pipeline=)`` with the riders
    aligned to ``sample_ids`` and the packer's thread gone after."""
    import tempfile
    import threading

    from repro_torch.dist.fault import FaultInjector
    from repro_torch.obs.registry import fresh_registry
    ex, fn, _params, _pipe, fifo_iter = train_setup()
    items = [next(fifo_iter) for _ in range(TRAIN_DATA // BATCH)]

    def loss_fn(p, batch):
        loss, acc = ex.loss_and_acc(fn, p, batch["ext"], batch["dev"],
                                    batch["labels"])
        return loss, {"acc": acc}

    def trainer(loss=loss_fn, **kw):
        cfg = TrainConfig(**{"lr": 3e-3, "warmup_steps": 20,
                             "total_steps": TRAIN_STEPS,
                             "weight_decay": 0.0, "log_every": 1, **kw})
        return Trainer(loss, lambda gen: ex.init_params(
            fn, gen.initial_seed(), DEVICE), cfg, device=DEVICE)

    def pipeline():
        return SchedulePipeline(fn.input_dim,
                                bucket_policy=BucketPolicy(mode="pow2"),
                                with_runs=True, device=DEVICE)

    quiet = dict(log_fn=lambda *_: None)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            fresh_registry() as reg:
        # (a) the clean fit, launch counts from 0 (d)
        tr = trainer(ckpt_dir=f"{tmp}/a", ckpt_every=10, ckpt_keep=2)
        state = tr.init_state(0)
        saves = timed_calls(tr.ckpt, "save")
        counts = dict.fromkeys(("padded", "fwd_cuda", "k2", "k2_cuda"), 0)
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lm.reset_launches()
        t0 = time.perf_counter()
        clean, log = tr.fit(state, trainer_stream(
            ex, items, pipeline(), counts=counts, times=times),
            steps=TRAIN_STEPS, logger=MetricLogger(**quiet))
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        wall = time.perf_counter() - t0
        launches = dict(lm.LAUNCHES)
        k1_cuda = lm.CUDA_LAUNCHES["treelstm_megastep"]
        peak = torch.cuda.max_memory_allocated()
        train_s = reg.hist_stats("train.train_sec_per_step")
        step_dir = Path(tr.ckpt.directory) / f"step_{TRAIN_STEPS:09d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        kept = sorted(d.name for d in Path(tr.ckpt.directory).iterdir())
        losses = [r["loss"] for r in log.history]
        check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
              f"trainer losses: {losses}")
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(losses, fifo["losses"]))
        if losses != fifo["losses"]:
            print(f"trainer losses vs the example loop's: largest relative "
                  f"difference {rel:.3e}")
        check(rel <= 1e-5, f"trainer losses vs phase 5's: {rel:.3e} > 1e-5")
        check(kept == [f"step_{s:09d}" for s in (20, TRAIN_STEPS)],
              f"checkpoints kept: {kept}")
        check(k1_cuda == counts["fwd_cuda"] <= 2 * counts["padded"],
              f"trainer: {k1_cuda} K1 CUDA launches, designed "
              f"{counts['fwd_cuda']}")
        for name, want in (("treelstm_megastep", counts["padded"]),
                           ("treelstm_bwd_megastep", counts["k2"]),
                           ("treelstm_bwd_megastep.cuda_launches",
                            counts["k2_cuda"]),
                           ("scatter_add_rows", TRAIN_STEPS)):
            check(launches.get(name, 0) == want, f"trainer: "
                  f"{launches.get(name, 0)} {name} launches, want {want}")

        # the same fit with no host read a step (no guard, one log): what
        # the guard's read and the per-step log cost; the same end state
        tr = trainer(skip_nonfinite=False, log_every=TRAIN_STEPS)
        bare_times = []
        bare, _ = tr.fit(tr.init_state(0), trainer_stream(
            ex, items, pipeline(), times=bare_times), steps=TRAIN_STEPS,
            logger=MetricLogger(**quiet))
        torch.cuda.synchronize()
        bare_times.append(time.perf_counter())
        check(_state_equal(bare, clean), "the fit without the guard does "
              "not end bit for bit where the guarded fit ends")

        # (b) a fault at step 15: restore step 10, replay, end as (a)
        tr = trainer(ckpt_dir=f"{tmp}/b", ckpt_every=10, ckpt_keep=2)
        restores = timed_calls(tr, "maybe_restore")
        inj = FaultInjector([15])
        faulted, _ = tr.fit(tr.init_state(0), trainer_stream(
            ex, items, pipeline(), replay=(inj, tr)), steps=TRAIN_STEPS,
            logger=MetricLogger(**quiet), fault_injector=inj)
        check(inj.failures == [15] and len(restores) == 1,
              f"fault: fired {inj.failures}, {len(restores)} restores")
        check(_state_equal(faulted, clean), "the fit restored from step 10 "
              "does not end bit for bit where the clean fit ends")

        # (c) a NaN ext at step 5: skipped, nothing written
        tr = trainer()
        stream = trainer_stream(ex, items, pipeline(), poison=5)
        logger = MetricLogger(**quiet)
        state, _ = tr.fit(tr.init_state(0), stream, steps=5, logger=logger)
        before = [t.clone() for t in (state.params["head"],
                                      state.params["cell"]["ui"],
                                      state.opt.mu["head"],
                                      state.opt.nu["head"])]
        state, _ = tr.fit(state, stream, steps=6, logger=logger)
        after = (state.params["head"], state.params["cell"]["ui"],
                 state.opt.mu["head"], state.opt.nu["head"])
        check(logger.counters["nonfinite_skips"] == 1 and state.step == 6,
              f"NaN batch: {logger.counters['nonfinite_skips']} skips, "
              f"step {state.step}")
        check(all(bitwise_equal(a, b) for a, b in zip(after, before)),
              "a skipped step changed params or moments")

        # (e) composed and prefetched, riders aligned, no thread left
        ds = sst_like_dataset(TRAIN_DATA, input_dim=fn.input_dim, seed=0)
        seen = []

        def riding(p, batch):
            seen.append((batch["sample_ids"].cpu().numpy(),
                         batch["labels"].cpu().numpy()))
            return loss_fn(p, batch)

        pipe = pipeline()
        tr = trainer(loss=riding)
        threads = set(threading.enumerate())
        epochs = iter(lambda: (ds.graphs, ds.inputs,
                               {"labels": list(ds.labels)}), None)
        _, clog = tr.fit(tr.init_state(0), epochs, steps=8,
                         logger=MetricLogger(**quiet),
                         compose=pipe.composer(BATCH), pipeline=pipe)
        for t in set(threading.enumerate()) - threads:
            t.join(timeout=30)
            check(not t.is_alive(), f"thread {t.name} outlived fit()")
        check(len(seen) == 8 and all(
            np.array_equal(labels, ds.labels[ids]) for ids, labels in seen),
            "composed riders do not realign by sample_ids")
        nb = len(pipe.composer(BATCH).compose(ds.graphs, ds.inputs)[0])
        check(nb > 8 or sorted(np.concatenate(
            [ids for ids, _ in seen[:nb]]).tolist()) == list(range(len(ds))),
            "a composed epoch does not hold every sample once")
        closs = [r["loss"] for r in clog.history]
        check(bool(np.isfinite(closs).all()), f"composed losses {closs}")

    step_ms = np.diff(times) * 1e3
    bare_ms = np.diff(bare_times) * 1e3
    out = {"steps": TRAIN_STEPS, "loss_first": losses[0],
           "loss_last": losses[-1], "bitwise_vs_example": losses == fifo[
               "losses"], "max_rel_vs_example": rel,
           "steps_per_s": TRAIN_STEPS / wall,
           "step_p50_ms": float(np.percentile(step_ms, 50)),
           "step_p99_ms": float(np.percentile(step_ms, 99)),
           "train_sec_p50_ms": train_s["p50"] * 1e3,
           "unguarded_step_p50_ms": float(np.percentile(bare_ms, 50)),
           "unguarded_step_p99_ms": float(np.percentile(bare_ms, 99)),
           "example_step_p50_ms": fifo["step_p50_ms"],
           "async_save_blocks_ms": [x * 1e3 for x in saves[:-1]],
           "final_save_ms": saves[-1] * 1e3,
           "restore_ms": restores[0] * 1e3, "checkpoint_bytes": ckpt_bytes,
           "max_memory_allocated_bytes": int(peak),
           "example_max_memory_allocated_bytes": fifo[
               "max_memory_allocated_bytes"],
           "launches": {k: launches.get(k, 0) for k in (
               "treelstm_megastep", "treelstm_bwd_megastep",
               "scatter_add_rows")},
           "composed_batches_per_epoch": nb, "composed_loss_last": closs[-1],
           "card": card}
    print(f"trainer: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 22: LM training
# ---------------------------------------------------------------------------

#: (a) ``examples/torch_train_lm.py``'s model and arguments: steps at batch
#: 8 x 128 tokens in 2 microbatches, f32, a log record a step.
LM_TRAIN_ARGS = ["--steps", "30", "--batch", "8", "--seq", "128",
                 "--n-micro", "2", "--log-every", "1"]
#: (b) granite-3-8b at full width: the depth it is cut to, steps, batch and
#: tokens a sequence.
GRANITE_TRAIN = {"layers": 2, "steps": 3, "batch": 2, "seq": 1024}
#: K10's backward against autograd of its plain version: max |err| / max
#: |plain| of each of dQ, dK and dV, at f32 (the forward's bar; PERF.md §6
#: has the forward's 1.81e-6 on the same card).  On the LM example's trained
#: activations autograd of ``ref.mha`` at f32 is itself up to 2.2e-5 from
#: an f64 evaluation, and the kernel's formulation in plain f32 products
#: misses the bar against it on 45 of 480 calls (``tools/
#: k10b_precision.py``; PERF.md, PR 36): where the kernel misses the bar,
#: it must be no farther from the f64 evaluation than the bar plus
#: ``K10B_F64_FACTOR`` times the f32 plain version's own distance.
K10B_BAR, K10B_F64_FACTOR = 1e-5, 2.0
#: Its edge cases (B, Hq, Hkv, Sq, Sk, D, causal, window): causal and not,
#: a window with and without ``causal``, Sq != Sk both ways (Sq > Sk under
#: ``causal``: rows with no key), Hkv = Hq and GQA groups 2, 4 and 8, head
#: dims 7, 20, 32, 64, 100, 128 and 256 (every class of the kernel; 7, 20
#: and 100 no multiple of 8), lengths no multiple of a 64-row tile; q and
#: dO permuted views in every case.
K10B_EDGES = ((1, 4, 2, 64, 64, 64, True, None),
              (1, 4, 4, 70, 70, 32, False, None),
              (1, 8, 2, 96, 96, 64, True, 24),
              (1, 4, 1, 40, 40, 7, False, 9),
              (1, 4, 1, 65, 200, 128, False, None),
              (1, 4, 2, 129, 50, 64, True, None),
              (1, 8, 2, 100, 100, 20, True, None),
              (1, 4, 2, 129, 129, 100, True, 50),
              (1, 4, 4, 65, 65, 256, True, None),
              (1, 16, 2, 33, 65, 80, True, None),
              (2, 32, 8, 300, 300, 128, True, None))


class BwdTap:
    """Keeps the arguments of the first ``limit`` K10-backward calls made
    inside it (``flash.flash_attention_bwd``, which ``FlashAttention``'s
    backward calls, wrapped); each call runs as before."""

    def __init__(self, limit: int = 1 << 30):
        self.limit, self.calls = limit, []

    def __enter__(self):
        real = self.real = flash.flash_attention_bwd

        def tapped(q, k, v, lse, do, **kw):
            if len(self.calls) < self.limit:
                self.calls.append((tuple(t.detach() for t in (
                    q, k, v, lse, do)), dict(kw)))
            return real(q, k, v, lse, do, **kw)

        flash.flash_attention_bwd = tapped
        return self

    def __exit__(self, *exc):
        flash.flash_attention_bwd = self.real


def k10b_plain(args, kw) -> tuple:
    """dQ, dK and dV by torch autograd of ``ref.mha`` on ``args``' q, k, v
    at output gradient do (the f32 plain version)."""
    q, k, v, _lse, do = args
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        return torch.autograd.grad(ref.mha(*leaves, **kw), leaves, do)


def mha64(q, k, v, *, causal=True, window=None, scale=None):
    """``ref.mha``'s function evaluated in float64 (``ref.mha`` computes in
    float32 whatever its inputs)."""
    g = q.shape[1] // k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    valid = ref.mha_valid(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(g, 1))
    s = (s * scale).masked_fill(~valid, float("-inf"))
    w = torch.where(valid.any(-1, keepdim=True), torch.softmax(s, -1), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.repeat_interleave(g, 1))


def k10b_f64(args, kw) -> tuple:
    """dQ, dK and dV by autograd of ``mha64`` on ``args``' f32 values
    taken to float64: the yardstick for the plain version's own error."""
    q, k, v, _lse, do = args
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        return torch.autograd.grad(mha64(*leaves, **kw), leaves, do.double())


def k10b_check(args, kw, twice: bool = True) -> tuple:
    """The K10 backward on ``args`` (q, k, v, lse, do) against
    ``k10b_plain``: finite, two launches bitwise equal (``twice``), each of
    dQ, dK and dV within ``K10B_BAR`` of its max |plain| or, on a call
    where it is not, within ``K10B_BAR + K10B_F64_FACTOR`` times the plain
    version's own distance from ``k10b_f64``; and the saved lse against
    ``ref.mha_lse``.  Returns (max abs err, max err / max |plain|)
    over the three, and the same two of the kernel and of the plain
    version against ``k10b_f64``."""
    with torch.no_grad():
        return _k10b_check(args, kw, twice)


def _k10b_check(args, kw, twice: bool) -> tuple:
    q, k, v, lse, do = args
    got = flash.flash_attention_bwd(*args, **kw)
    again = flash.flash_attention_bwd(*args, **kw) if twice else got
    want = k10b_plain(args, kw)
    torch.cuda.synchronize()
    shape = tuple(q.shape) + (k.shape[1], k.shape[2], kw)
    check(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, again)),
          f"K10 backward: two launches differ at {shape}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"K10 backward: non-finite gradient at {shape}")
    errs = [(float((g - w).abs().max()), rel_err(g, w))
            for g, w in zip(got, want)]
    rel = max(e[1] for e in errs)
    f64 = k10b_f64(args, kw)
    rel64 = max(rel_err(g.double(), w) for g, w in zip(got, f64))
    plain64 = max(rel_err(g.double(), w) for g, w in zip(want, f64))
    check(rel <= K10B_BAR or rel64 <= K10B_BAR + K10B_F64_FACTOR * plain64,
          f"K10 backward disagrees with autograd of ref.mha: dQ/dK/dV "
          f"{[f'{e[1]:.3e}' for e in errs]} of max |plain| at {shape}, and "
          f"is {rel64:.3e} from float64 where the plain version is "
          f"{plain64:.3e}")
    want_lse = ref.mha_lse(q, k, **kw)
    live = torch.isfinite(want_lse)
    check(torch.equal(live, torch.isfinite(lse)) and (not live.any() or float(
        (lse - want_lse)[live].abs().max()) <= 1e-6 * float(
            want_lse[live].abs().max())),
          f"K10's log-sum-exp disagrees with ref.mha_lse at {shape}")
    return max(e[0] for e in errs), rel, rel64, plain64


def k10b_inputs(case, gen) -> tuple:
    """((q, k, v, lse, do), kw) of an edge case: q and dO permuted views,
    lse from K10's forward asked for it, whose output must be bit for bit
    the forward's without it (serving's)."""
    B, Hq, Hkv, Sq, Sk, D, causal, window = case

    def rn(*shape):
        return torch.randn(shape, generator=gen).to(DEVICE)

    kw = {"causal": causal, "window": window}
    q = rn(B, Sq, Hq, D).transpose(1, 2)
    k, v = rn(B, Hkv, Sk, D), rn(B, Hkv, Sk, D)
    do = rn(B, Sq, Hq, D).transpose(1, 2)
    o, lse = flash.flash_attention_lse(q, k, v, **kw)
    check(torch.equal(_bits(o), _bits(flash.flash_attention(q, k, v, **kw))),
          f"K10's output changed with the log-sum-exp store at {case}")
    return (q, k, v, lse, do), kw


def k10b_bound_ms(args, kw) -> tuple:
    """Least time of one K10 backward on ``args``: five products (QKᵀ and
    dO Vᵀ recomputed, Pᵀ dO, dSᵀ Q, dS K) of 2 D FLOPs a head over the
    pairs of query and valid key this call's data has, each f32 product
    as three TF32 products at 495 TFLOP/s, against q, k, v, o and dO read
    and dQ, dK and dV written once at 3.35 TB/s.  Returns (bound_ms,
    bound_by, flops, bytes)."""
    q, k = args[0], args[1]
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    pairs = float(ref.mha_valid(Sq, Sk, kw.get("causal", True),
                                kw.get("window")).sum()) * B * Hq
    flops = 5 * 2.0 * D * pairs
    nbytes = 4.0 * (4 * B * Hq * Sq * D + 4 * B * Hkv * Sk * D)
    ms, by, _ = priced_ms(flops, nbytes, tf32x3=True)
    return ms, by, flops, nbytes


def sdpa_bwd_call(args, kw):
    """The backward of one ``scaled_dot_product_attention`` at f32 on
    ``args``' q, k, v and do (its forward run once outside; timed only,
    the port never calls it): the one PyTorch call that computes what the
    K10 backward computes."""
    q, k, v, _lse, do = args
    check(kw.get("window") is None and q.shape[2] == k.shape[2]
          and kw.get("causal", True), "the SDPA yardstick times square "
          "causal attention only")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = "enable_gqa" in (sdpa.__doc__ or "")
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    g = q.shape[1] // k.shape[1]
    with torch.enable_grad():
        if gqa:
            out = sdpa(*leaves, is_causal=True, enable_gqa=True)
        else:
            out = sdpa(leaves[0], leaves[1].repeat_interleave(g, 1),
                       leaves[2].repeat_interleave(g, 1), is_causal=True)

    def call():
        with torch.enable_grad():
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    return call


def k10b_timings(calls) -> dict:
    """The K10 backward re-run on kept calls ``calls`` ((args, kw) pairs):
    mean device ms a call (``torch.profiler``) of the kernel (its two
    launches apart: dQ with the row sums, dK/dV), the plain backward
    (``ref.mha_bwd``) and SDPA's backward at f32, and the mean bound."""
    kern = [lambda a=a, kw=kw: flash.flash_attention_bwd(*a, **kw)
            for a, kw in calls]
    plain = [lambda a=a, kw=kw: ref.mha_bwd(*a, **kw) for a, kw in calls]
    lib = [sdpa_bwd_call(a, kw) for a, kw in calls]
    # The kernel with its two launches apart in a session of its own; the
    # plain version and SDPA's backward (launched from autograd's device
    # thread) in another.  Either may fall to CUDA events.
    ms, parts = device_ms({"kernel": {
        "calls": kern, "launches": 2, "parts": {
            "dq": ["dq_kernel"], "dkdv": ["dkdv_kernel"]}}}, reps=3,
        parts_required=False)["kernel"]
    t = device_ms({"plain": {"calls": plain, "reps": 1}, "library": lib},
                  reps=3)
    bounds = [k10b_bound_ms(a, kw) for a, kw in calls]
    by_ops = sum(b[0] for b in bounds if b[1] == "operations")
    return {"timed": len(calls), "ms": ms,
            "parts_ms": parts or {"dq": None, "dkdv": None},
            "plain_ms": t["plain"],
            "library_ms": t["library"],
            "bound_ms": float(np.mean([b[0] for b in bounds])),
            "bound_by": ("operations" if by_ops >= sum(b[0] for b in bounds)
                         / 2 else "bytes"),
            "flops": float(np.mean([b[2] for b in bounds])),
            "bytes": float(np.mean([b[3] for b in bounds]))}


def k10b_build_report() -> dict:
    """What ``nvcc -Xptxas -v`` said of the K10 backward's kernels (dQ and
    dK/dV by head-dim class, and for a head dim equal to its class):
    registers and spills; the dynamic shared
    memory a CTA; and its SASS: the TF32 ``mma.sync`` it runs its products
    on, no float atomic."""
    lib = "flash_attention_bwd"
    ptxas = ptxas_report(lib, r"(dkdv|dq)_kernelILi(\d+)ELb(\d)E",
                         lambda m: f"{m.group(1)} DMAX {m.group(2)}"
                                   + (" (D = DMAX)" if m.group(3) == "1"
                                      else ""))
    check(len(ptxas) == 16, f"K10 backward's ptxas report names "
          f"{len(ptxas)} kernels, not 16")
    smem_of = ctypes.CDLL(str(_build.library_path(lib))) \
        .flash_attention_bwd_smem_bytes
    smem = {f"D <= {d}": {"dkdv": smem_of(d, 0), "dq": smem_of(d, 1)}
            for d in (32, 64, 128, 256)}
    sass = sass_counts(lib, "K10 backward", needs=("HMMA.1688.F32.TF32",))
    print(f"flash_attention_bwd.cu: dynamic shared memory a CTA {smem}; "
          f"SASS {sass or 'not read (no cuobjdump)'}")
    return {"ptxas": ptxas, "smem": smem, "sass": sass}


def lm_example_train(ex) -> dict:
    """(a): ``ex.main(LM_TRAIN_ARGS)``, launch counts set to 0 just before
    and read just after, every K10 backward call kept.  Its losses finite
    and falling; one K10 forward and one backward a layer a microbatch a
    step, every forward on the tf32 route; the first step's loss that of
    the same weights and batch on the CPU (plain versions) within 1e-4."""
    cfg = ex.model_config()
    steps, batch, seq, micro = (int(LM_TRAIN_ARGS[i]) for i in (1, 3, 5, 7))
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    t0 = time.perf_counter()
    with BwdTap() as tap:
        state, logger = ex.main(LM_TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    losses = [float(r["loss"]) for r in logger.history]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"the LM example's losses: {losses}")
    check(losses[-1] < losses[0], f"the LM example's loss did not fall: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    n = steps * micro * cfg.num_layers
    want = {"flash_attention": n, "flash_attention.tf32": n,
            "flash_attention_bwd": n}
    check({k: launches.get(k, 0) for k in want} == want and
          len(tap.calls) == n, f"the LM example's launches {launches} "
          f"(kept {len(tap.calls)} backward calls), expected {want}")
    # The first step's loss on the CPU: the same weights (the trainer's
    # seed-0 CPU generator) and the first batch, plain versions.
    tlm = TransformerLM(cfg)
    params = tlm.init(torch.Generator().manual_seed(0), device="cpu")
    first = next(lm_batches(synthetic_corpus(3_000_000, cfg.vocab, seed=0),
                            batch, seq, seed=0))
    m = batch // micro
    with torch.no_grad():
        cpu = float(np.mean([float(tlm.loss(params, {
            k: torch.from_numpy(v[i * m:(i + 1) * m])
            for k, v in first.items()})[0]) for i in range(micro)]))
    first_rel = abs(losses[0] - cpu) / abs(cpu)
    check(first_rel <= TOL, f"the LM example's first loss {losses[0]} vs "
          f"{cpu} on the CPU ({first_rel:.3e})")
    out = {"steps": steps, "losses": [losses[0], losses[-1]],
           "first_loss_cpu": cpu, "first_loss_rel": first_rel,
           "wall_s": wall, "step_ms": 1e3 * wall / steps,
           "tokens_per_s": float(logger.history[-1].get("tokens_per_sec",
                                                        0.0)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    print(f"LM training (a) {cfg.name} ({cfg.param_count() / 1e6:.1f}M "
          f"params), {steps} steps of {batch} x {seq} tokens, n_micro "
          f"{micro}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first step "
          f"{first_rel:.2e} from the CPU), {out['step_ms']:.1f} ms a step "
          f"(wall, start-up included), {out['tokens_per_s']:.0f} tokens/s "
          f"at the last step, peak {out['peak_gb']:.2f} GB; launches "
          f"{launches}")
    return {**out, "calls": tap.calls}


def granite_train() -> dict:
    """(b): granite-3-8b at full width (d_model 4,096, 32/8 heads of 128,
    d_ff 12,800, vocab 49,155), its depth cut to ``GRANITE_TRAIN``'s layers,
    f32, no remat, weights from a CUDA generator (seed 0), trained through
    ``Trainer.fit`` for a few steps; launch counts set to 0 just before and
    read just after; the first step's K10 backward calls kept."""
    g = GRANITE_TRAIN
    base = get_config("granite-3-8b")
    cfg = dataclasses.replace(base, num_layers=g["layers"],
                              param_dtype="float32",
                              compute_dtype="float32", remat="none")
    print(f"LM training (b) cuts of granite-3-8b: depth {base.num_layers} -> "
          f"{cfg.num_layers}; {base.param_dtype}/{base.compute_dtype} -> "
          f"float32 (a bf16 backward needs the wgmma forward to save the "
          f"log-sum-exp: ROADMAP.md queue 2); remat {base.remat} -> none; "
          f"width as published (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab})")
    tlm = TransformerLM(cfg)
    trainer = Trainer(tlm.loss, lambda gen: tlm.init(gen, device=DEVICE),
                      TrainConfig(lr=1e-5, warmup_steps=1,
                                  total_steps=g["steps"], log_every=1),
                      device=DEVICE)
    state = trainer.init_state(torch.Generator(DEVICE).manual_seed(0))
    data = lm_batches(synthetic_corpus(2_000_000, cfg.vocab, seed=0),
                      g["batch"], g["seq"], seed=0)
    logger = MetricLogger(tokens_per_step=g["batch"] * g["seq"],
                          log_fn=lambda *_: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lm.reset_launches()
    t0 = time.perf_counter()
    with BwdTap(limit=cfg.num_layers) as tap:
        state, logger = trainer.fit(state, data, steps=g["steps"],
                                    logger=logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lm.LAUNCHES)
    losses = [float(r["loss"]) for r in logger.history]
    check(len(losses) == g["steps"] and all(np.isfinite(losses)),
          f"granite-3-8b's training losses: {losses}")
    n = g["steps"] * cfg.num_layers
    want = {"flash_attention": n, "flash_attention.tf32": n,
            "flash_attention_bwd": n}
    check({k: launches.get(k, 0) for k in want} == want,
          f"granite-3-8b training launches {launches}, expected {want}")
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "params_b": sum(p.numel() for p in
                           (t for t in _leaves(state.params))) / 1e9,
           "losses": losses, "wall_s": wall,
           "step_ms": [1e3 * float(r.get("train_sec_per_step", 0.0))
                       for r in logger.history],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    print(f"LM training (b) {cfg.name} at full width, {cfg.num_layers} "
          f"layers, {out['params_b']:.3f} B f32 params, {g['steps']} steps "
          f"of {g['batch']} x {g['seq']} tokens: losses {losses}, wall "
          f"{wall:.2f} s, peak {out['peak_gb']:.2f} GB; launches {launches}")
    del state, trainer
    return {**out, "calls": tap.calls}


def _ms_or_none(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def lm_train_phase(card: str) -> dict:
    """Phase 22: (a) the LM example, (b) granite-3-8b at full width, (c)
    the K10 backward against its plain version on the edge cases and on
    every call of (a) and of (b)'s first step, timed beside its plain
    version, SDPA's backward and its bound."""
    k10b_build_report()
    a = lm_example_train(load_example("torch_train_lm"))
    b = granite_train()
    gen = torch.Generator().manual_seed(2222)
    edge = [k10b_check(*k10b_inputs(c, gen)) for c in K10B_EDGES]
    main = [k10b_check(args, kw) for args, kw in a["calls"] + b["calls"]]
    over = [e for e in main if e[1] > K10B_BAR]
    print(f"K10 backward vs autograd of ref.mha: {len(K10B_EDGES)} edge "
          f"cases max {max(e[1] for e in edge):.3e} of max |plain|; "
          f"{len(main)} main-path calls max {max(e[1] for e in main):.3e}, "
          f"{len(over)} over {K10B_BAR:g}; from float64 the kernel max "
          f"{max(e[2] for e in edge + main):.3e}, the plain version max "
          f"{max(e[3] for e in edge + main):.3e}, their largest ratio "
          f"{max(e[2] / max(e[3], 1e-30) for e in edge + main):.2f}; "
          f"every call's two launches bitwise equal")
    timed = {"granite": k10b_timings(b["calls"]),
             "example": k10b_timings(a["calls"][:16])}
    for label, t in timed.items():
        print(f"K10 backward at {label}'s shape ({t['timed']} kept calls): "
              f"{t['ms']:.4f} ms a call (device; dQ "
              f"{_ms_or_none(t['parts_ms']['dq'])}, dK/dV "
              f"{_ms_or_none(t['parts_ms']['dkdv'])}), plain {t['plain_ms']:.4f}, SDPA's "
              f"backward at f32 {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['flops'] / 1e9:.2f} GFLOP, {t['bytes'] / 1e6:.1f} MB)")
    g = timed["granite"]
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": ATTN_REPLACES["flash_attention"],
           "launches": (a["launches"]["flash_attention_bwd"]
                        + b["launches"]["flash_attention_bwd"]),
           "max_abs_err": max(e[0] for e in edge + main),
           "max_rel_err": max(e[1] for e in edge + main),
           "max_rel_err_f64": max(e[2] for e in edge + main),
           "plain_rel_err_f64": max(e[3] for e in edge + main),
           "calls_over_bar": len(over),
           "ms": g["ms"], "parts_ms": g["parts_ms"],
           "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
           "bound_by": g["bound_by"], "library_ms": g["library_ms"],
           "example_ms": timed["example"]["ms"],
           "example_bound_ms": timed["example"]["bound_ms"],
           "example_library_ms": timed["example"]["library_ms"]}
    out = {"example": {k: v for k, v in a.items() if k != "calls"},
           "granite": {k: v for k, v in b.items() if k != "calls"},
           "timed": timed, "card": card}
    print(f"lm_train: {json.dumps(out)}")
    return {**out, "rows": [row]}


def k2_row(kind: str, part: dict, launches: dict) -> dict:
    """K2's kernel row for kind ``kind``: ``launches`` counts the main
    path's levels that launched (its CUDA launches beside it); ``ms`` is
    device time, ``events_ms`` CUDA events; ``bound_ms`` prices the
    products as three TF32 products, ``bound_fma_ms`` at fp32 FMA."""
    name = f"{kind}_bwd_megastep"
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bwd_megastep_sm90.cu",
            "replaces": "src/repro/kernels/level_megastep_bwd.py:205",
            "launches": launches[name],
            "cuda_launches": launches[f"{name}.cuda_launches"],
            "max_abs_err": part["max_abs_err"], "ms": part["ms"],
            "events_ms": part["events_ms"], "plain_ms": part["plain_ms"],
            "bound_ms": part["bound_ms"], "bound_by": part["bound_by"],
            "bound_fma_ms": part["bound_fma_ms"], "library_ms": None}


def main() -> None:
    dev = device_phase()
    kern = kernel_phase()
    served = served_levels_phase()
    serve = serve_phase(dev["smi"])
    check(served["levels"] == serve["launches"],
          f"the tapped run had {served['levels']} levels, the main path "
          f"{serve['launches']} launches")
    profile_phase()
    levels = train_levels_phase()
    k1_build_report()
    k2_build_report()
    cell_build_report()
    train = train_phase(dev["smi"])
    cells = [cell_train_phase(p, dev["smi"]) for p in CELL_PHASES]
    k6_err = k6_phase()
    cont = continuous_tree_phase(dev["smi"])
    chains = chain_serving_phase(dev["smi"])
    decode = [decode_phase(c, dev["smi"]) for c in ("lstm", "gru")]
    opbyop = op_by_op_phase(dev["smi"], serve, decode[0])
    lmserve = lm_serving_phase(dev["smi"])
    mamba = mamba_serving_phase(dev["smi"])
    composed_train_phase(dev["smi"], train)
    spliced_serving_phase(dev["smi"])
    examples_phase(dev["smi"])
    trainer_phase(dev["smi"], train)
    lmtrain = lm_train_phase(dev["smi"])
    row = {"name": "treelstm_megastep", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/treelstm_megastep_sm90.cu",
           "replaces": "src/repro/kernels/level_megastep.py:181",
           "launches": serve["launches"],
           "max_abs_err": max(kern["max_abs_err"], served["max_abs_err"],
                              levels["fwd"]["max_abs_err"],
                              cont["megastep"]["max_abs_err"]),
           "ms": served["ms"], "events_ms": served["events_ms"],
           "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
           "bound_by": served["bound_by"],
           "bound_fma_ms": served["bound_fma_ms"], "library_ms": None}
    bwd, sc = levels["bwd"], levels["scatter"]
    rows = [row, k2_row("treelstm", bwd, train["launches"]), {
        "name": "scatter_add_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scatter_add_rows.cu",
        "replaces": "src/repro/kernels/level_megastep_bwd.py:108",
        "launches": train["launches"]["scatter_add_rows"],
        "max_abs_err": max([sc["max_abs_err"]] + [
            c["scatter"]["max_abs_err"] for c in cells]), "ms": sc["ms"],
        "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"],
        "bound_by": sc["bound_by"], "library_ms": sc["library_ms"]}]
    others = {"lstm": [chains["megastep"], decode[0]["tick"]],
              "gru": [decode[1]["tick"]]}
    for c in cells:
        k, part, name = c["kind"], c["fwd"], f"{c['kind']}_megastep"
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cell_megastep_sm90.cu",
            "replaces": FORWARD_REPLACES[k], "launches": c["launches"][name],
            "cuda_launches": c["fwd_cuda_launches"],
            "max_abs_err": max([part["max_abs_err"]] + [
                o["max_abs_err"] for o in others.get(k, [])]),
            "ms": part["ms"], "events_ms": part["events_ms"],
            "plain_ms": part["plain_ms"], "bound_ms": part["bound_ms"],
            "bound_by": part["bound_by"],
            "bound_fma_ms": part["bound_fma_ms"], "library_ms": None}
        rows += [row, k2_row(k, c["bwd"], c["launches"])]
    # K6a: the retiring windows of both continuous main paths; K6b: the
    # op-by-op continuous leg's ticks, timed on their own inputs (a fused
    # tick stores its own rows).
    for name, part, errs, replaces, launches in (
            ("gather_rows", cont["gather"], (cont, chains),
             "src/repro/kernels/gather_scatter.py:39",
             cont["launches"]["gather_rows"]
             + chains["continuous"]["launches"]["gather_rows"]),
            ("scatter_rows", chains["unfused"]["scatter"], (),
             "src/repro/kernels/gather_scatter.py:70",
             chains["unfused"]["launches"]["scatter_rows"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather_scatter.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max([part["max_abs_err"], k6_err] + [
                e["gather"]["max_abs_err"] for e in errs]),
            "ms": part["ms"], "plain_ms": part["plain_ms"],
            "bound_ms": part["bound_ms"], "bound_by": "bytes",
            "library_ms": part["library_ms"]})
    rows += opbyop["rows"] + lmserve["rows"] + mamba["rows"] \
        + lmtrain["rows"]
    k1 = {"served levels": served, "the training step's levels":
          levels["fwd"], "the tree frontier": cont["megastep"],
          f"the synthetic M {M_FULL} level": kern["synthetic"]}
    for label, part in k1.items():
        print(f"K1 at {label}: {part['ms']:.4f} ms a launch (device; events "
              f"{part['events_ms']:.4f}), plain {part['plain_ms']:.4f} ms, "
              f"bound {part['bound_ms']:.5f} ms by {part['bound_by']}"
              + (f"; {part['total_ms']:.4f} ms a step"
                 if "training" in label else ""))
    for c in cells:
        part = c["fwd"]
        print(f"{FWD_KERNELS[c['kind']][0]} at the {c['phase']} step's "
              f"{part['levels']} levels: {part['ms']:.4f} ms a launch "
              f"(device; events {part['events_ms']:.4f}), plain "
              f"{part['plain_ms']:.4f} ms, bound {part['bound_ms']:.5f} "
              f"ms by {part['bound_by']} (fp32 FMA "
              f"{part['bound_fma_ms']:.5f}); {part['total_ms']:.4f} ms "
              f"a step, {c['fwd_cuda_launches']} CUDA launches in "
              f"{c['steps']} steps")
        if c["kind"] == "treefc":
            print("K5 by level: " + "; ".join(
                f"{r['level']} (live {r['live']}) {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.5f} by {r['bound_by']}, error "
                f"{r['rel_err']:.2e}" for r in part["by_level"]))
    frontier = {"treelstm_megastep at the tree frontier": cont["megastep"],
                "lstm_megastep at the chain frontier": chains["megastep"],
                **{f"{d['kind']}_megastep at a decode tick": d["tick"]
                   for d in decode}}
    for label, part in frontier.items():
        print(f"{label}: {part['ms']:.4f} ms a launch, plain "
              f"{part['plain_ms']:.4f} ms, bound {part['bound_ms']:.5f} ms "
              f"by {part['bound_by']}, max_abs_err {part['max_abs_err']:.3e}")
    for label, part in (("the Tree-LSTM step", sc),
                        ("the duplicate-heavy case", sc["heavy"]),
                        *((c["phase"], c["scatter"]) for c in cells)):
        print(f"K7 at {label}: {part['ms']:.4f} ms of device time (add "
              f"{part['add_ms']:.4f}, combine {part['combine_ms']:.4f}), "
              f"index_add_ {part['library_ms']:.4f}, plain "
              f"{part['plain_ms']:.4f}, bound {part['bound_ms']:.5f} ms")
    print(f"scatter plans built in {sc['plan_ms']:.3f} ms (the Tree-LSTM "
          f"step's schedule), " + ", ".join(
              f"{c['phase']} {c['plan_ms']:.3f} ms" for c in cells)
          + " (host, once per schedule)")
    if PROFILER_OFFSETS_US:
        print(f"profiler sessions: {len(PROFILER_OFFSETS_US)}, least "
              f"launch-to-kernel time from {min(PROFILER_OFFSETS_US):.1f} to "
              f"{max(PROFILER_OFFSETS_US):.1f} µs (first "
              f"{PROFILER_OFFSETS_US[0]:.1f}, last "
              f"{PROFILER_OFFSETS_US[-1]:.1f}; below zero the card's clock "
              f"trails the host's)")
    print(dev["smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
