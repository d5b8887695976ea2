#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build, check, time, serve, train.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, one line each (a phase that fails ends the run with a non-zero
exit and no result line):

1. the device: name and power limit (``nvidia-smi``);
2. the build of every kernel in ``src/repro_torch/kernels/csrc``, then
   the SASS of the DYAD GEMM libraries (``dyad_mm``, ``dyad_mm_two``,
   ``dyad_dgrad``, ``dyad_dgrad_fused``, ``dyad_wgrad``), of the ff
   megakernels (``dyad_ff``), of the quantized GEMMs (``dyad_mm_q``) and
   of the flash forward and backward (``flash_prefill``, ``flash_bwd``;
   ``cuobjdump -sass``): each must hold ``HGMMA`` (wgmma) and, but for
   ``flash_prefill``, ``flash_bwd``, ``dyad_dgrad``, ``dyad_dgrad_fused``,
   ``dyad_wgrad`` and ``dyad_mm_two`` (both routes on wgmma), ``FFMA``
   (an fp32 route on FMA), counts on one line; the split-TF32
   instantiations (the fp32 DYAD GEMMs of ``dyad_mm`` and ``dyad_mm_two``,
   the fp32 dgrad GEMMs of ``dyad_dgrad`` and ``dyad_dgrad_fused``, the
   fp32 wgrad GEMM of ``dyad_wgrad`` for both out dtypes, the fp32 flash
   forward and the fp32 flash backward's dk/dv and dq kernels at HD 64
   and 128), the fp32-x quantized GEMM of ``dyad_mm_q`` (int8, fp8) and
   their bf16 twins, each one's HGMMA, FFMA, registers, spills and wgmma
   serialisation on one line (HGMMA in each, no spill, no FFMA in the fp32
   GEMMs, no more in an fp32 flash forward than in its bf16 twin and HD,
   none more in an fp32 flash backward kernel than in its twin); ptxas's
   registers,
   spills and wgmma serialisation of the tensor-core flash kernels, ff
   megakernel and quantized GEMM, one line each for the flash forward
   (``flash_fwd_tc_kernel``), the flash backward (bf16 and split TF32),
   the fp32 dgrad, fused dgrad and wgrad GEMMs, the ff megakernel
   (``dyad_ff_tc_kernel``, gated and not, over bf16, int8 and fp8
   weights) and the quantized GEMMs (``dyad_mm_q_tc_kernel`` and
   ``dyad_mm_q_tf32_kernel``, int8 and fp8; no spill and no serialised
   wgmma allowed); the split-key decode
   kernels' registers and spills at HD 128, paged and ring, with the
   shared memory of a block and the blocks an SM at the span of its cache
   dtype (no spill in any instantiation allowed); and the HGMMA count of
   each of those ff and quantized instantiations (none may lack it);
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16, at the OPT-125m and Qwen3-0.6B serving and training shapes and
   the edge cases (``dyad_mm_blocks`` also off the tensor-core tiles, n 2,
   3 and 4, with x rows off a multiple of 8 elements or off 16 bytes; the
   DYAD backward kernels also with the OT stride-n z2bar, off the
   tensor-core tiles and with a split row reduction, each wgrad repeated
   bitwise; ``dyad_mm_blocks`` and ``dyad_mm_dgrad_two`` on integer-valued
   bf16 inputs, whose fp32 sums are exact, bitwise against the plain
   version; the paged decode kernels also over bf16 and int8 pools, at
   head dims 16, 32, 80 and 128, with a poisoned scratch page, at the
   edges of the key splits, each slot of a batch of 8 alone bitwise equal
   to its batch row and the batch repeated bitwise; the ring decode also
   with q and cache dtypes apart, at h 16 and 80, and at Qwen3's and
   OPT's KV heads at the edges of its splits (wrapped rings, windows
   across the wrap point, a dead run inside a tile, idx 0) for every pair
   of q and cache dtypes, each slot alone bitwise equal to its batch row,
   a repeat bitwise with another shape launched between, NaN in every dead
   ring slot moving no bit, and one call at each engine's arguments
   launching one kernel with no cast beside it; the
   quantized-weight kernels over int8 and fp8 payloads, bf16 x on the
   tensor cores also repeated bitwise, on the FMA kernels through the C
   entries at Qwen3's shapes, fp32 x at OPT-125m's (the route phase 4
   times beside), fp32 x on the tensor cores also against float64 and
   repeated bitwise, and on payloads that cover every int8 and every
   finite e4m3 value with power-of-two scales and integer x (bf16 x, and
   fp32 x for the GEMMs; the ff: one-hot x, relu), whose sums are exact,
   bitwise against the plain version; bf16
   ``flash_prefill_grads`` also at h 80 and S < T, repeated bitwise at
   Qwen3's shape, and on integer-valued inputs with lse 0 whose sums are
   exact, bitwise against the plain version; bf16 ``flash_prefill`` also
   at h 80 with G 2 and at S < T with per-batch offsets and a window at
   h 128, repeated bitwise at Qwen3's shape, and with k = 0 and v in
   {-1, 0, 1}, whose sums are exact: o bitwise, lse within 1e-6
   relative; every ``flash_prefill`` case's fully-masked rows with the
   plain version's lse bits; the split-TF32 routes (fp32 ``flash_prefill``,
   ``flash_prefill_grads``, ``dyad_mm_dgrad_two``, ``dyad_mm_dgrad`` (the
   OT z2bar), ``dyad_mm_wgrad`` (IT and OT views, fp32 out),
   ``dyad_mm_blocks_two`` (OT and DT views) and fp32 ``dyad_mm_blocks``
   past the decode rows) and the quantized GEMMs' fp32 x on the tensor
   cores also against their plain versions run in float64 in every case
   whose outputs sum at least F64_MIN_TERMS products (at most F64_GATE x
   the plain fp32 version's error), repeated bitwise at OPT's shapes (and
   a strided x, the DT z2, h 80), fp32 ``flash_prefill`` on strided views
   at h 64 and 128, and all eight on operands +-(1 + 2^-12), within
   SPLIT_REL of float64 where one TF32 product is off by about 5e-4 (the
   quantized GEMMs' payloads are exact in TF32: x alone); bf16
   ``dyad_mm_blocks_two`` on integer
   inputs at Qwen3's split-route down shape and ragged shapes, and
   ``dyad_ff_fused`` with relu on integer inputs at Qwen3's widths, M 4096
   and 128, bitwise; the bf16 Qwen3 ``dyad_ff_fused`` cases also on the
   FMA kernel through the C entry, the parent's route that phase 4
   times); and at the shapes phases 15's and 16's families give the
   kernels (FAMILY_MM, FAMILY_FF, FAMILY_PREFILL, FAMILY_RING):
   ``dyad_mm_blocks`` on Mamba2's and Hymba's SSM in and out projections
   at M 8 and 1024 and on Whisper's ff up and down at M 8 x 1500 and 8,
   ``dyad_ff_fused`` on Hymba's ff (blocks 400 x 1376), the MoE's shared
   expert (512 x 1408) and Phi-3-vision's ff (768 x 2048) with fp32
   weights, ``flash_prefill`` over Hymba's in-flight K/V (S 1280 past the
   1024 window, and at per-batch offsets; K 5 x G 5, h 64), non-causal
   over Whisper's 1500 frames (h 64, a ragged last key tile) and causal
   at h 96 (Phi-3-vision's 576 patches + 128 text tokens, and its prefill
   over a 160-slot cache), ``flash_decode`` over Hymba's ring with the
   window across the wrap point (G 5) and at h 96 over Phi-3-vision's
   ring (one index, and one a slot), fp32 and bf16;
4. the time of each kernel, its plain version and a library yardstick
   (CUDA events around device work queued ahead, L2 flushed before each
   run, median of 25 after warm-up), under the kernel's name or, at
   another path's shapes, ``name@shape`` (``@qwen3``: the Qwen3-0.6B
   training rows in bf16, each also with no stride-n view,
   ``copied_views_ms``, and ``dyad_mm_dgrad_two`` with dx2 written in
   dx1's layout, ``contiguous_out_ms``; ``@qwen3_train``: one layer of
   Qwen3-0.6B's training attention in bf16, against SDPA, the backward
   with the wrapper's delta alone, ``delta_ms``, as at OPT's;
   ``dyad_mm_dgrad@opt_ot``: fp32 ``dyad_mm_dgrad`` at OPT-125m's OT dx,
   on split TF32); for the quantized-weight
   kernels the yardstick is torch.bmm over weights dequantized before the
   timing, and the same with the dequantization timed too, and beside
   each GEMM record at decode rows (M <= 8) both routes through the C
   entry, the FMA decode kernel (``fma_ms``) and the tensor cores
   (``tc_ms``), whichever the plan picks (``dyad_mm_blocks_q``: OPT's
   fp32 x, its records on the tensor cores bound at TWO_TF32_FLOPS;
   ``dyad_mm_blocks_q@split_up``: Qwen3's split-route up and gate),
   beside the bf16 ff's the FMA kernel (``fma_ms``);
   ``dyad_mm_blocks_two`` at OPT-125m's OT forward and
   ``dyad_mm_blocks_two@opt_dt`` at its DT forward (fp32, split TF32);
   ``dyad_ff_fused`` at Qwen3's training, prefill, prefill-chunk and
   decode rows (``@prefill``, ``@prefill_chunk``, ``@decode``), each
   beside the split route, a torch.bmm chain and the FMA kernel through
   the C entry (``fma_ms``, the parent's route); the paged decode over
   fp32, int8 and bf16 pools (``@bf16_pools``) against the gather and
   SDPA, and over each pool dtype at contexts 64 and 512 with the splits
   a slot takes (``time_pools``); ``dyad_mm_blocks_two`` at Qwen3's
   split-route down at M 4096 and 8 (``@qwen3_split``,
   ``@qwen3_split_M8``); the ring decode at Qwen3's batch step
   (``@qwen3_batch``) and dense-ring step (``@ring512``), bf16 q over an
   fp32 cache; ``flash_prefill`` at Qwen3's serving prefill over its fp32
   cache (``@qwen3_fp32_cache``, bf16 q cast up, against SDPA); the fp32
   routes of the ff megakernels, ``dyad_ff_fused`` and ``dyad_ff_fused_q``
   (int8), at one Qwen3 ff at M 8 and 128 (``@fp32_decode``,
   ``@fp32_chunk``, on FMA, beside the torch.bmm chain); the split-TF32
   routes' bounds at a third of the TF32 rate, the FMA bound beside
   (``fma_bound_ms``); the family shapes in bf16 over fp32 params and
   caches (``dyad_mm_blocks@mamba2``, ``@hymba``, ``@whisper``,
   ``dyad_ff_fused@hymba``, ``@moe_shared``, ``@phi3v``,
   ``flash_prefill@hymba_window``, ``@whisper_enc``, ``@phi3v_patches``,
   ``flash_decode@hymba_ring``, ``@phi3v_ring``);
5. the OPT serving path: OPT-125m at full width with ``dyad_it_4_kernel``,
   random weights from ``--seed``, ``Engine.generate`` at batch 8, prompt
   128, 32 new tokens, with the kernels' launch counters read around it;
   5b. a ``torch.profiler`` trace of one more generate: device-busy share
   and the kernels that take the most device time, its decode launches
   by kernel name (the ring kernel once a layer and step);
6. that serving path on the card against the same port on the CPU;
7. the OPT training path: OPT-125m at full width, fp32, through the train
   launcher's ``build_trainer`` (``make_train_step`` and ``Trainer``), B 8
   x S 512 of ``SyntheticLM``; 2 warm-up steps, one step with the launch
   counters read around it, then 5 timed steps: the step (``step_time_s``),
   the host's batch (``data_time_s``), the loop's wall time per step, and
   the card's SM clock and power draw over those steps (``nvidia-smi``
   every 100 ms: min/median/max);
   the same with ``--linear dense`` (the paper's comparison, printed, not
   claimed); 7b. a ``torch.profiler`` trace of one DYAD train step and
   one DENSE step, the DYAD one's fp32 launches by kernel name (the
   split-TF32 flash forward once a layer, the split-TF32 DYAD GEMM
   twice, no FMA prefill or tile kernel; the split-TF32 flash dk/dv and
   dq kernels once a layer each, the split-TF32 dgrad and wgrad GEMMs
   twice each, no FMA flash backward and no FMA GEMM);
   7c. the same training path with the OT and DT variants
   (``dyad_ot_4_kernel``, ``dyad_dt_4_kernel``) at full depth, their
   launch counters checked exactly, and a profiled OT step: the forward's
   split-TF32 GEMM with the components apart (``dyad_mm_blocks_two``),
   the fused split-TF32 dgrad and the split-TF32 wgrad twice a layer
   each, no FMA GEMM;
8. one train step of OPT-125m and Pythia-160m at full width and 2 layers
   on the card against the CPU port on the same params and batch, and on
   the card the kernel backward against the forced plain backward; where
   the two devices put a ReLU unit's pre-activation on either side of zero
   and every such unit is a tie (at most RELU_TIES_MAX a step, each within
   RELU_TIE of zero on both; ROADMAP C.8), the grads are held instead
   against the CPU step taken with just those units on the other branch,
   at the same bound (the units and both errors logged);
9. the Qwen3-0.6B serving path at full width with the ff megakernel
   (``dyad_it_4_kernel_ffused``, bf16 compute, fp32 cache): generate at
   batch 8, prompt 128, 32 new, launch counters checked exactly, and a
   profile of one more generate, its decode launches by kernel name as in
   5b;
10. the Qwen3-0.6B training path (full config, remat, bf16) at B 8 x
   S 512 as in phase 7, with the DENSE run and a profiled step of each,
   the DYAD one's flash launches by kernel name the tensor-core forward
   twice a layer (remat) and the dk/dv and dq kernels once a layer each,
   the FMA ones never, and its ff launches the tensor-core megakernel
   (``dyad_ff_tc_kernel``) twice a layer, the FMA one never;
11. Qwen3-0.6B at full width and 2 layers on the card against the CPU
   port: a train step in fp32 and in bf16, greedy tokens in fp32, the
   kernel backward against the plain one, the ``split`` ff route against
   ``fused``; and one OPT-125m train step each with the OT and DT
   variants at 2 layers;
12. the continuous-batching path: Qwen3-0.6B at full width and depth
   (bf16 compute, fp32 page pools, random weights from ``--seed``) in
   ``ContinuousBatchingEngine(n_slots=8, max_len=512, page_size=16,
   prefill_chunk=128, prefix_cache=True)``, 32 greedy requests (a shared
   64-token prefix and a 32-224-token tail each, 16-64 new tokens; the
   ff weights x 4 so that greedy tokens vary) with the launch counters
   checked exactly, then a profile of a window of its engine steps (taken
   again while its paged decode launches fall short of the counted calls,
   failing after three); the
   same trace on dense rings (``REPRO_PAGED_KV=off``, its window profiled
   the same way, the ring kernel's launches by name), with int8 pools,
   and with a pool cut so that preemption fires, each against the paged
   run by the bf16 tie rule; at 2 layers in fp32, a cut pool's greedy
   tokens equal to the unpressured run's exactly and dense rings against
   the paged run at the fp32 bound; and int8 pools at 2 layers on the
   card against the CPU port;
13. quantized serving: (a) OPT-125m at full width with int8 weight
   sidecars (``dyad_it_4_kernel_w8``) through ``Engine.generate`` as in
   phase 5, launch counters exact, its decode time in turns with the fp
   route on the same weights, profiled (its quantized GEMM launches by
   kernel name as mm_q_plan routes each projection: the fp32-x
   tensor-core kernel and its second pass, or the FMA decode kernel),
   and against the CPU port;
   (b) the README's quantized serving command on Qwen3-0.6B at full width
   and depth, int8 weights (quantized after the ff weights x 4) and int8
   pools, in phase 12's engine and trace, launch counters exact, then a
   profiled window whose ff launches by kernel name are the tensor-core
   megakernel's, one per counted ``dyad_ff_fused_q`` call of the window,
   with no FMA megakernel and no weight cast; (c) the same at 2 layers
   on the split ff route (``REPRO_KERNEL_FF=split``) with fp8 weights,
   held against the fused
   fp8 run by the bf16 tie rule; (d) at 2 layers in fp32 the card's
   greedy tokens against the CPU port's, int8 and fp8 weights, fused and
   split: exactly equal; (e) ``REPRO_KERNEL_QUANT=off`` at 2 layers in
   fp32: exactly the unquantized run's tokens and launches;
14. spans, route events and seeded faults (``repro_torch.obs``,
   ``repro_torch.faults``): (a) the train launcher on OPT-125m at full
   width and depth (fp32, ``dyad_it_4_kernel``, B 8 x S 512, OBS_TRAIN's
   12 steps) with ``--trace``, ``--metrics-json`` and ``--ckpt-dir`` in a
   temporary directory, under ``nan_loss`` at one step, ``slow_step`` at
   another sleeping 4x phase 7's median step, and ``ckpt_io:p=0.3``: one
   ``train_step`` span a step, one ``nonfinite_step`` instant at the armed
   step and the checkpointed params finite, exactly one ``straggler``
   instant, a ``ckpt_retry`` instant per ``ckpt_io`` fire, the route
   events a step printed; (b) phase 12's continuous engine, requests and
   weights under OBS_SERVE_FAULTS, traced: every request drains with
   ``demoted == []``, the trace's ``decode_step`` spans, ``nan_detected``,
   ``admit_backoff`` and ``slow_step_fault`` events match the engine's
   counts and the fault tallies, and the tokens match phase 12's
   unfaulted run by the bf16 tie rule; at 2 layers in fp32 the tokens
   equal the unfaulted run's exactly and the card's tallies the CPU
   port's; (c) ``kernel_nan:route=ff_fused`` at 2 layers: the first
   request retires ``FAULTED``, the ``ff`` rung demotes this engine, the
   next requests finish clean; (d) the OPT-125m IT step and Qwen3-0.6B's
   batch decode tok/s with the tracer off and on, in turns, the route
   events of one step and one decode step, and the ``train_step`` and
   ``decode_step`` span medians beside the profiled device-busy ms of a
   step (phases 7 and 12);
15. the moe, ssm and hybrid families (FAMILY): Qwen1.5-MoE-A2.7B,
   Mamba2-780m and Hymba-1.5B at their published widths and full depth,
   bf16 compute over fp32 params, random weights from ``--seed``, flash
   attention on and each config's own linear with ``use_kernel`` and
   ``fuse_ff_kernel`` (scope ``ff``, or ``ff+ssm``): ``Engine.generate``
   (MoE and Mamba2 at batch 8, prompt 128, 32 new; Hymba at batch 4 with
   1280-token prompts past its 1024 window, then 32 tokens across the
   ring's wrap), its launches exact, then a profiled generate; then
   ``ContinuousBatchingEngine`` (MoE over paged pools with chunked
   prefill and the prefix cache, 16 requests of phase 12's traffic;
   Mamba2 on dense slots, the same traffic; Hymba on dense slots, 8
   requests whose prompts alternate below and past the window), launches
   exact, then a profiled window of engine steps.  Each run prints
   decode tok/s, prefill seconds, ``torch.cuda.max_memory_allocated``,
   the device-busy share and the profile's launches by kernel name; it
   fails if a kernel its route takes shows no launch in the profile or
   any plain version (of a kernel, or the plain attention and ff
   dataflows) runs on the card.  Then each at full width and 2 layers
   in fp32 on the card against the CPU port: greedy tokens equal, or
   parting only after a step whose CPU top-2 logit margin is under
   LOGIT_TOL, or for the MoE after a router near-tie (ROUTER_TIE, its
   smallest gap printed); the phase's seconds;
16. the encdec and vlm families (MODAL): Whisper-medium (24 encoder and
   24 decoder layers, 1500 frames of 1024 a request) and
   Phi-3-vision-4.2B at their published widths and full depth, set up as
   in phase 15 with the ff weights x 4: ``Engine.generate`` at batch 8,
   prompt 128, 32 new (Whisper with its frames), its launches exact for
   the decoder's and the encoder's layers, then a profiled generate;
   Phi-3-vision's ``forward`` with 576 patches and 128 text tokens at
   batch 4 (``last_only``), launches exact, then profiled.  Each prints
   decode tok/s, prefill (or forward) seconds, peak memory, the
   device-busy share and the profile's launches by kernel name; it fails
   if a kernel its route takes shows no launch in the profile, if any
   plain version of a kernel or the plain self-attention runs on the
   card, or if cross-attention's einsum route (CROSS_SDPA, counted on its
   own) runs other than once a decoder layer and token.  Then each at
   full width and 2 layers (2 + 2 for Whisper) in fp32 on the card
   against the CPU port: greedy tokens equal, or parting only after a
   step whose CPU top-2 margin is under LOGIT_TOL, the prefill logits,
   and Phi-3-vision's patch forward logits, within LOGIT_TOL; the phase's
   seconds, then the whole run's;
17. the ``kernels`` JSON line (every record of phase 4), then the result
   line.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, the
# fp32 (non-tensor-core) FLOP/s and the bf16 and TF32 tensor-core FLOP/s,
# the peak rate for each input type.  The split-TF32 (3xTF32) fp32 routes
# run three TF32 products for each fp32 one: their fp32 work is bound at a
# third of the TF32 rate (and at FP32_FLOPS the FMA kernels were, printed
# beside as fma_bound_ms); the quantized GEMMs' fp32-x route runs two (x
# split, the payload exact in TF32): half the TF32 rate
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
SPLIT_TF32_FLOPS = TF32_FLOPS / 3
TWO_TF32_FLOPS = TF32_FLOPS / 2

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # x max(|plain|, 1)
# the split-TF32 kernels against a float64 product (the plain version run
# in float64): their largest error at most F64_GATE x the plain fp32
# version's (allow_tf32 off) against the same product; and on operands
# +-(1 + 2^-12), whose bits below TF32's 10-bit mantissa carry the answer,
# within SPLIT_REL x max|float64| (one TF32 product is off by about 5e-4)
F64_GATE = 4.0
SPLIT_REL = 1e-6
# The gate holds where each output sums enough products that fp32's own
# error is its sums'.  Over a handful of products fp32's error is a
# rounding or two, while a 3xTF32 product alone misses by up to about
# 2^-21 relative (its operands' hi + lo hold them to 2^-22): the 3-term
# dgrad case "prime" read 5.52x on an H100.  A case whose
# contraction is shorter than F64_MIN_TERMS is held to its plain version
# and repeated, not gated
F64_MIN_TERMS = 16
LOGIT_TOL = 1e-4                             # x max(|cpu logits|, 1)
# card vs CPU train step, fp32 both: loss relative; each grad leaf against
# max(|cpu leaf|, 1e-3) (sums over 512 tokens and the 50k vocabulary run
# in other orders on the two devices)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4

# card vs CPU train step in bf16: both round every activation to bf16
# (2^-8 relative) at other places, over 2 layers; the loss read 4.8e-5
# and the grads 1.6e-2 on an H100.  The run also prints, not gated, the
# card's bf16 step against the CPU's fp32 step: the gap that rounding
# alone opens
LOSS_TOL_BF16, GRAD_TOL_BF16 = 1e-3, 5e-2

SMOKE = {"B": 8, "S": 128, "new": 32}        # the serving path's batch
PARITY = {"B": 2, "S": 32, "new": 8}         # the card vs CPU comparison
TRAIN = {"B": 8, "S": 512, "warmup": 2, "timed": 5}   # the training path
TRAIN_PARITY = {"B": 2, "S": 256, "layers": 2}
# Qwen3-0.6B at 2 layers against the CPU: its 151936-word LM head makes
# the CPU side the slow one, so the batch is smaller (bf16 smaller still)
QWEN_PARITY = {"B": 2, "S": 128, "S_bf16": 64, "layers": 2}
QWEN_FF = "dyad_it_4_kernel_ffused"
# idle seconds between the profiler's start and a serving window's first
# launch, and between its last kernel and the profiler's stop: the
# profiler drops kernel records it finds out of its time range, fewer with
# this margin; and the profiles a window may take before one holds every
# counted launch
PROFILE_MARGIN_S = 0.25
PROFILE_TRIES = 3
# the continuous path's traffic: each prompt a shared prefix and a tail of
# a length drawn from ``tail``, each request up to ``max_new`` tokens
CONT = {"slots": 8, "max_len": 512, "page_size": 16, "chunk": 128,
        "requests": 32, "prefix": 64, "tail": (32, 224), "max_new": (16, 64),
        # the pool cut: 96 pages, where the unpressured run's high water
        # is about 120
        "cut_pages": 1 + 96,
        # engine steps [a, b) of the paged run traced by the profiler
        "profile_steps": (60, 90),
        # the ff weights x 4: at the init scale greedy decoding repeats one
        # token per request, which would leave the token comparisons blind
        "ff_scale": 4.0}
# fp32 compute and pools at 2 layers on the card: with the pool cut so
# that preemption fires, the greedy tokens must equal the unpressured
# run's exactly (the reference's contract, ``test_resilience.py:299``);
# dense rings against the paged run by the tie rule at LOGIT_TOL.  Each
# request reserves 4-8 pages, 4 slots want up to 32, the cut leaves 12
CONT_EXACT = {"layers": 2, "slots": 4, "max_len": 128, "page_size": 16,
              "chunk": 32, "requests": 12, "prefix": 32, "tail": (8, 40),
              "max_new": (16, 48), "cut_pages": 1 + 12, "ff_scale": 4.0}
# phase 14's train launcher run: OPT-125m at B 8 x S 512 for ``steps``
# steps, a checkpoint every ``ckpt_every``; the NaN strike at the trainer's
# check ``nan_at``; the straggler at ``slow_at``, past the 8 steps the
# watchdog needs before it judges one, sleeping 4x the IT step's median;
# ckpt_io's stream under ``fault_seed`` fires at the first of the 3 saves
OBS_TRAIN = {"steps": 12, "ckpt_every": 6, "nan_at": 3, "slow_at": 9,
             "slow_x": 4.0, "fault_seed": 2}
OBS_SERVE_FAULTS = "page_exhaustion:p=0.05;nan_logits:at_step=3;slow_step:ms=5"
# phase 14d: tracer off and on in turns, ``turns`` of each, ``steps``
# train steps a turn
OBS_COST = {"turns": 3, "steps": 5}
# int8 pools on the card against the CPU port, at 2 layers in fp32
CONT_PARITY = {"layers": 2, "slots": 4, "max_len": 128, "page_size": 16,
               "chunk": 32, "requests": 4, "prefix": 32, "tail": (8, 40),
               "max_new": (8, 8), "ff_scale": 4.0}
# token comparisons across routes: two runs may part only after a step
# whose top-2 logit margin is below this bound x max(|logits|, 1).  bf16
# compute rounds each activation at 2^-8 at other places on other routes
# (the megakernel's hidden split follows the row count, a chunked prefill
# differs from a one-shot one); an int8 K/V element that two devices' fp32
# sums put on either side of a rounding boundary moves by one quantum,
# 1/127 of its row's largest magnitude
LOGIT_TOL_BF16 = 2e-2
LOGIT_TOL_INT8 = 1e-2
# the quantized-weight kernels in phase 3, (M, n, d_in_b, d_out_b): OPT's
# up and down and Qwen3's up (and gate) and down projections at decode,
# prefill-chunk and prefill rows, then ragged edges (odd rows, dims off the
# tile and off a multiple of 4)
QUANT_MM_CASES = {
    "opt_up_M8": (8, 4, 192, 768), "opt_down_M8": (8, 4, 768, 192),
    "opt_up_M1024": (1024, 4, 192, 768), "opt_down_M1024": (1024, 4, 768, 192),
    "qwen3_up_M8": (8, 4, 256, 768), "qwen3_up_M128": (128, 4, 256, 768),
    "qwen3_down_M8": (8, 4, 768, 256), "qwen3_down_M1024": (1024, 4, 768, 256),
    "ragged_M77": (77, 3, 129, 67), "ragged_M5": (5, 2, 70, 131),
    "qwen3_down_M128": (128, 4, 768, 256)}
# (M, n, d_in_b, d_ff_b, d_out_b, act): Qwen3's ff at decode, prefill-chunk
# and prefill rows, swiglu and gelu, then ragged edges
QUANT_FF_CASES = {
    "qwen3_M8": (8, 4, 256, 768, 256, "swiglu"),
    "qwen3_M128": (128, 4, 256, 768, 256, "swiglu"),
    "qwen3_M1024": (1024, 4, 256, 768, 256, "swiglu"),
    "qwen3_gelu_M8": (8, 4, 256, 768, 256, "gelu"),
    "qwen3_gelu_M1024": (1024, 4, 256, 768, 256, "gelu"),
    "ragged_swiglu": (5, 2, 129, 130, 17, "swiglu"),
    "ragged_relu_wide_out": (45, 3, 33, 200, 300, "relu")}
# quantized serving at 2 layers (phase 13 c-e)
QUANT_LAYERS = 2
# phase 15: the moe, ssm and hybrid families at full width and depth, bf16
# compute over fp32 params, flash attention on, the kernel-routed linear
# of each config's own scope.  Per model: the batch run (B, prompt, new);
# the kernels each layer launches in it, by wrapper (n: new tokens, s:
# decode steps); the continuous run's engine and traffic and the kernels
# each layer launches per prefill call and decode step (besides the
# attention's); Qwen1.5-MoE serves from paged pools, the others from
# dense rings
FAMILY = {
    "qwen2_moe_a2_7b": dict(
        batch=(8, 128, 32),
        per_layer=lambda n, s: {"flash_prefill": 1, "flash_decode": s,
                                "dyad_ff_fused": n},
        cont_route="paged", cont_ff={"dyad_ff_fused": 1}),
    "mamba2_780m": dict(
        batch=(8, 128, 32),
        per_layer=lambda n, s: {"dyad_mm_blocks": 3 * n},
        cont_route=None, cont_ff={"dyad_mm_blocks": 3}),
    # a 1280-token prompt over the 1024 window: the S >= L ring prefill,
    # then 32 tokens across the ring's wrap
    "hymba_1_5b": dict(
        batch=(4, 1280, 32),
        per_layer=lambda n, s: {"flash_prefill": 1, "flash_decode": s,
                                "dyad_ff_fused": n, "dyad_mm_blocks": 3 * n},
        cont_route="dense", cont_ff={"dyad_ff_fused": 1,
                                     "dyad_mm_blocks": 3}),
}
# the new tokens of phase 15's profiled batch generate
FAMILY_PROFILE_NEW = 8
# the CUDA kernels each wrapper launches, as the profiler names them
KERNEL_NAMES = {
    "flash_prefill": r"flash_fwd_(tc|tf32)_kernel",
    "flash_decode": r"flash_decode_ring_kernel",
    "flash_decode_paged": r"flash_decode_paged_kernel",
    "dyad_ff_fused": r"dyad_ff(_tc)?_kernel",
    "dyad_mm_blocks": r"dyad_gemm_tc_kernel|dyad_mv_kernel"}
# the continuous runs: Qwen1.5-MoE and Mamba2 on 16 requests of phase 12's
# traffic; Hymba on 8 requests whose prompts alternate below the 1024
# window and past it (a shared 64-token prefix and a tail from ``tail``,
# then one from ``tail_long``), 4 slots of 1536 tokens; engine steps
# [a, b) of each profiled
FAM_CONT = dict(CONT, requests=16, profile_steps=(8, 16))
HYMBA_CONT = {"slots": 4, "max_len": 1536, "requests": 8, "prefix": 64,
              "tail": (200, 900), "tail_long": (1000, 1400),
              "max_new": (16, 32), "profile_steps": (8, 16)}
# card vs CPU at 2 layers and full width in fp32 (the ff and expert
# weights x 4, so that greedy tokens vary); Hymba's prompt past its window
FAM_PARITY = {"layers": 2, "B": 2, "S": 32, "S_hymba": 1040, "new": 8,
              "ff_scale": 4.0}
# a MoE layer's routing is discontinuous: where a token's k-th and
# (k+1)-th router probabilities lie within ROUTER_TIE, fp32 sums in
# another order (the router's 2048-term product, then the softmax over 60
# experts, each good to about 1e-7 relative) may pick the other expert.
# The card and the CPU may then part, without a small top-2 logit margin,
# at the next token or any later one
ROUTER_TIE = 1e-5
# phase 16: the encdec and vlm families at full width and depth, set up
# as phase 15's (bf16 compute over fp32 params, fp32 caches, flash
# attention, the config's linear with use_kernel and fuse_ff_kernel), the
# ff weights x 4.  Per model: the batch generate (B, prompt, new); the
# kernels each decoder layer launches in it, by wrapper (n: new tokens,
# s: decode steps), and each encoder layer; Whisper's frames (1500 of
# 1024 a request) drawn from the seed; Phi-3-vision's patch forward (B,
# text tokens after its 576 patches, ``last_only``) and the kernels each
# layer launches in it.  Whisper's ff has biases: no megakernel, its up
# and down through dyad_mm_blocks
MODAL = {
    "whisper_medium": dict(
        batch=(8, 128, 32),
        per_layer=lambda n, s: {"flash_prefill": 1, "flash_decode": s,
                                "dyad_mm_blocks": 2 * n},
        per_enc_layer={"flash_prefill": 1, "dyad_mm_blocks": 2}),
    "phi3_vision_4_2b": dict(
        batch=(8, 128, 32),
        per_layer=lambda n, s: {"flash_prefill": 1, "flash_decode": s,
                                "dyad_ff_fused": n},
        per_enc_layer={},
        forward=(4, 128),
        forward_per_layer={"flash_prefill": 1, "dyad_ff_fused": 1}),
}
MODAL_FF_SCALE = 4.0
# card vs CPU at full width and 2 layers (2 + 2 for Whisper) in fp32;
# Phi-3-vision's patch forward at ``patch_B`` x its 576 patches + S text
MODAL_PARITY = {"layers": 2, "B": 2, "S": 32, "new": 8, "patch_B": 2}
# the plain attention dataflow of cross-attention: the reference's own
# einsum route, counted on its own; the plain versions of kernels and the
# self-attention's plain dataflows must stay at 0 on the card
CROSS_SDPA = "repro_torch.layers.attention._cross_sdpa"


_T0 = time.perf_counter()


def log(phase: str, **kw) -> None:
    """One line per result, with the seconds since the script started."""
    print(f"[{phase}] t={time.perf_counter() - _T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def _close(got, want, tol: float):
    """(ok, max_abs_err, bound): error bound scaled to the plain magnitude."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    return err <= tol * scale, err, tol * scale


def timer(torch, flush_buf):
    """Median device time of ``fn`` in ms.  Before each run the L2 is
    flushed (the layer-by-layer caller finds it cold) and the device is
    kept busy for ~0.5 ms, so the host has enqueued all of ``fn`` before
    the start event fires: the events then time the device, not the host's
    launch overhead."""
    def time_ms(fn, warmup: int = 5, iters: int = 25) -> float:
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(iters):
            flush_buf.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)
    return time_ms


def _bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _time_ff_slice(torch, randn, record, time_ms, two_cases, ff_cases):
    """Phase 4 for the three kernels of the ff slice, at the shapes of
    the paths that launch them: dyad_mm_blocks_two at OPT-125m's OT
    forward (fp32 on split TF32, the OT train step: its bound at
    SPLIT_TF32_FLOPS, the FMA bound beside), at its DT forward (the
    stride-n x2, ``@opt_dt``) and at Qwen3's split-route down projection
    (bf16, at the training and the decode rows); dyad_mm_dgrad at Qwen3's
    down dh (bf16, the train
    step); dyad_ff_fused at Qwen3's training, prefill and decode rows (bf16
    x, the fp32 params), beside the split route and a torch.bmm chain,
    each a composition of several calls."""
    from repro_torch.kernels import dyad_mm

    bf16, f32 = torch.bfloat16, torch.float32

    def two(name, label, dt, rate, view="ot", dims=None):
        M, n, d_in, d_out = dims or two_cases[label]
        x = randn(M, n * d_in, dtype=dt)
        x1 = x.reshape(M, n, d_in)
        # OT: x2 = x1; DT: the stride-n view
        x2 = x1 if view == "ot" else x.reshape(M, d_in, n).transpose(1, 2)
        w1, w2 = (randn(n, d_out, d_in).to(dt) for _ in range(2))
        # yardstick: one torch.bmm over both components
        xc = torch.cat([x1, x2], dim=1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=0).transpose(1, 2).contiguous()
        nbytes = x1.element_size() * (M * n * d_in + 2 * n * d_out * d_in
                                      + 2 * M * n * d_out)
        flops = 4.0 * M * n * d_out * d_in
        kw = ({"fma_bound_ms": _bound_ms(nbytes, flops, FP32_FLOPS)[0]}
              if dt == f32 else {})
        record(name,
               time_ms(lambda: dyad_mm.dyad_mm_blocks_two(x1, x2, w1, w2)),
               time_ms(lambda: dyad_mm.dyad_mm_blocks_two_plain(
                   x1, x2, w1, w2)),
               time_ms(lambda: torch.bmm(xc, wc)), nbytes, flops, label,
               rate, str(dt)[6:], **kw)

    for view, name in (("ot", "dyad_mm_blocks_two"),
                       ("dt", "dyad_mm_blocks_two@opt_dt")):
        for label in ("opt_up_M4096", "opt_down_M4096"):
            two(name, label, f32, SPLIT_TF32_FLOPS, view)
    two("dyad_mm_blocks_two@qwen3_split", "qwen3_split_down_M4096", bf16,
        BF16_FLOPS)
    # the split route's down projection at Qwen3's decode rows
    two("dyad_mm_blocks_two@qwen3_split_M8", "qwen3_split_down_M8", bf16,
        BF16_FLOPS, dims=(8,) + two_cases["qwen3_split_down_M4096"][1:])

    # dyad_mm_dgrad: Qwen3's down projection dh at the training rows, the
    # OT cotangent views; yardstick: one torch.bmm over the contraction
    # of both components; copied_views_ms: z1 for both components (no
    # stride-n view to gather)
    M, n, d_ff, d_out = two_cases["qwen3_split_down_M4096"]
    g = randn(M, n * d_out, dtype=bf16)
    z1, z2 = g.reshape(M, n, d_out), g.reshape(M, d_out, n).transpose(1, 2)
    w1, w2 = (randn(n, d_out, d_ff).to(bf16) for _ in range(2))
    zc = torch.cat([z1, z2], dim=2).transpose(0, 1).contiguous()
    wc = torch.cat([w1, w2], dim=1).contiguous()
    record("dyad_mm_dgrad",
           time_ms(lambda: dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2)),
           time_ms(lambda: dyad_mm.dyad_mm_dgrad_plain(z1, z2, w1, w2)),
           time_ms(lambda: torch.bmm(zc, wc)),
           2 * (M * n * d_out + 2 * n * d_out * d_ff + M * n * d_ff),
           4.0 * M * n * d_out * d_ff, "qwen3_down_dh_M4096", BF16_FLOPS,
           "bfloat16", copied_views_ms=time_ms(
               lambda: dyad_mm.dyad_mm_dgrad(z1, z1, w1, w2)))

    # dyad_mm_dgrad in fp32 (split TF32: the bound at SPLIT_TF32_FLOPS, the
    # FMA bound beside) at OPT-125m's OT dx, one layer's up + down: the OT
    # cotangent views, z2 the stride-n z2bar
    for label in ("opt_up_M4096", "opt_down_M4096"):
        M, n, d_in, d_out = two_cases[label]
        g = randn(M, n * d_out)
        z1, z2 = g.reshape(M, n, d_out), g.reshape(M, d_out, n).transpose(
            1, 2)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        zc = torch.cat([z1, z2], dim=2).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=1).contiguous()
        nbytes = 4 * (M * n * d_out + 2 * n * d_out * d_in + M * n * d_in)
        flops = 4.0 * M * n * d_out * d_in
        record("dyad_mm_dgrad@opt_ot",
               time_ms(lambda: dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2)),
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_plain(z1, z2, w1, w2)),
               time_ms(lambda: torch.bmm(zc, wc)), nbytes, flops, label,
               SPLIT_TF32_FLOPS,
               fma_bound_ms=_bound_ms(nbytes, flops, FP32_FLOPS)[0])

    # dyad_ff_fused: bf16 x, fp32 params (the main path's inputs); beside
    # the wrapper (ff_plan's kernel), the FMA kernel through the entry
    # (fma_ms, the parent's route)
    for label, suffix in (("qwen3_M4096", ""), ("qwen3_M1024", "@prefill"),
                          ("qwen3_M128", "@prefill_chunk"),
                          ("qwen3_M8", "@decode")):
        M, n, d_in, d_ff, d_out, act = ff_cases[label]
        args = _ff_args(randn, M, n, d_in, d_ff, d_out, act, bf16, f32)
        x1, x2 = args[0], args[1]
        x = x1.reshape(M, n * d_in)
        wb = [a.to(bf16) for a in args[2:]]        # wu1 wu2 wd1 wd2 wg1 wg2
        # the split route, from bf16 weights: dyad_mm_blocks for up and
        # gate, silu * up, dyad_mm_blocks_two for down
        def split():
            u = dyad_mm.dyad_mm_blocks(x, wb[0], wb[1])
            h = torch.nn.functional.silu(dyad_mm.dyad_mm_blocks(
                x, wb[4], wb[5])) * u
            return dyad_mm.dyad_mm_blocks_two(h, h, wb[2], wb[3])
        # the same chain through torch.bmm over the -CAT operands
        xc = torch.cat([x1, x2], dim=2).transpose(0, 1).contiguous()
        wuc = torch.cat([wb[0], wb[1]], dim=2).transpose(1, 2).contiguous()
        wgc = torch.cat([wb[4], wb[5]], dim=2).transpose(1, 2).contiguous()
        wdc = torch.cat([wb[2], wb[3]], dim=1).transpose(1, 2).contiguous()
        def chain():
            h = torch.nn.functional.silu(torch.bmm(xc, wgc)) * torch.bmm(
                xc, wuc)
            return torch.bmm(h, wdc)
        flops = 2.0 * M * n * (4 * d_ff * d_in + 2 * d_out * d_ff)
        nbytes = (2 * M * n * d_in + 4 * (4 * n * d_ff * d_in
                                          + 2 * n * d_out * d_ff)
                  + 2 * 2 * M * n * d_out)
        record("dyad_ff_fused" + suffix,
               time_ms(lambda: dyad_mm.dyad_ff_fused(*args, act=act)),
               time_ms(lambda: dyad_mm.dyad_ff_fused_plain(*args, act=act)),
               None, nbytes, flops, label, BF16_FLOPS, "bfloat16",
               split_route_ms=time_ms(split), bmm_chain_ms=time_ms(chain),
               fma_ms=time_ms(_ff_fma_entry(args, act)[0]))


def _time_qwen3_bwd(torch, randn, record, time_ms, bwd_cases):
    """Phase 4 at the Qwen3-0.6B training rows (bf16, as its train step
    runs them; records ``...@qwen3``): dyad_mm_wgrad for up (the IT views,
    as gate) and down (the OT views: one input, the stride-n z2bar), fp32
    out for the fp32 params; dyad_mm_dgrad_two for up's dx; dyad_mm_blocks
    for up's forward, which the backward recomputes.  Yardstick: one
    torch.bmm over both components' concatenated operands (bf16 out).
    Beside each, the same work without the stride-n layouts:
    ``copied_views_ms`` (wgrad and dyad_mm_blocks with no stride-n view
    read) and ``contiguous_out_ms`` (dyad_mm_dgrad_two writing dx2 in dx1's
    layout)."""
    from repro_torch.kernels import dyad_mm

    bf16 = torch.bfloat16
    for label in ("qwen3_up_M4096", "qwen3_down_M4096"):
        M, n, d_in, d_out = bwd_cases[label]
        x, g = randn(M, n * d_in, dtype=bf16), randn(M, n * d_out, dtype=bf16)
        x1 = x.reshape(M, n, d_in)
        z = g.reshape(M, n, d_out)
        if label == "qwen3_up_M4096":
            xb, zb = x.reshape(M, d_in, n).transpose(1, 2), z
        else:
            xb, zb = x1, g.reshape(M, d_out, n).transpose(1, 2)
        flops = 4.0 * M * n * d_out * d_in
        zt = torch.cat([z, zb], dim=1).permute(1, 2, 0).contiguous()
        xc = torch.cat([x1, xb], dim=1).transpose(0, 1).contiguous()
        # copied_views_ms: the same call with no stride-n view (x1 and z1
        # for both components, so every operand is copied, none gathered)
        record("dyad_mm_wgrad@qwen3",
               time_ms(lambda: dyad_mm.dyad_mm_wgrad(
                   x1, xb, z, zb, out_dtype=torch.float32)),
               time_ms(lambda: dyad_mm.dyad_mm_wgrad_plain(
                   x1, xb, z, zb, out_dtype=torch.float32)),
               time_ms(lambda: torch.bmm(zt, xc)),
               # x and g read once (bf16), dw1 and dw2 written (fp32)
               2 * (M * n * d_in + M * n * d_out) + 4 * 2 * n * d_out * d_in,
               flops, label, BF16_FLOPS, "bfloat16 in, float32 out",
               copied_views_ms=time_ms(lambda: dyad_mm.dyad_mm_wgrad(
                   x1, x1, z, z, out_dtype=torch.float32)))
        if label != "qwen3_up_M4096":
            continue
        # up's dx (du_pre for both components) and its forward
        w1, w2 = (randn(n, d_out, d_in, dtype=bf16) for _ in range(2))
        zc = torch.cat([z, z], dim=1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=0).contiguous()
        # contiguous_out_ms: the C entry with dx2 in dx1's layout, not the
        # permuted one (single-element stores at stride n)
        dx = [torch.empty(M, n, d_in, dtype=bf16, device=z.device)
              for _ in range(2)]
        contiguous = _dgrad_two_entry(z, z, w1, w2, *dx)
        record("dyad_mm_dgrad_two@qwen3",
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_two(z, z, w1, w2)),
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_two_plain(z, z, w1, w2)),
               time_ms(lambda: torch.bmm(zc, wc)),
               2 * (M * n * d_out + 2 * n * d_out * d_in + 2 * M * n * d_in),
               flops, label, BF16_FLOPS, "bfloat16",
               contiguous_out_ms=time_ms(contiguous))
        xf = torch.cat([x1, xb], dim=-1).transpose(0, 1).contiguous()
        wf = torch.cat([w1, w2], dim=-1).transpose(1, 2).contiguous()
        # copied_views_ms: OT on the same x (x2 = x1, both copied)
        record("dyad_mm_blocks@qwen3",
               time_ms(lambda: dyad_mm.dyad_mm_blocks(x, w1, w2, "it")),
               time_ms(lambda: dyad_mm.dyad_mm_blocks_plain(x, w1, w2, "it")),
               time_ms(lambda: torch.bmm(xf, wf)),
               2 * (M * n * d_in + 2 * n * d_out * d_in + M * n * d_out),
               flops, label, BF16_FLOPS, "bfloat16",
               copied_views_ms=time_ms(
                   lambda: dyad_mm.dyad_mm_blocks(x, w1, w2, "ot")))


def _time_qwen3_attn(torch, randn, record, time_ms):
    """Phase 4 at one layer of Qwen3-0.6B's training attention (B 8, S 512,
    K 8 KV heads x G 2, h 128, causal, bf16; records ``...@qwen3_train``):
    flash_prefill with the lse its backward reads, and
    flash_prefill_grads with the wrapper's delta alone (``delta_ms``).
    Yardstick: F.scaled_dot_product_attention and its backward, with k and
    v expanded to the 16 query heads before the graph (so SDPA's dk and
    dv are per query head, not summed over G)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    bf16 = torch.bfloat16
    B, S, K, G, h = TRAIN["B"], TRAIN["S"], 8, 2, 128
    q, do = (randn(B, S, K, G, h, dtype=bf16) for _ in range(2))
    k, v = (randn(B, S, K, h, dtype=bf16) for _ in range(2))
    o, lse = flash_attn.flash_prefill(q, k, v, save_lse=True)
    sq = q.reshape(B, S, K * G, h).transpose(1, 2).detach().requires_grad_()
    sk, sv = (t.transpose(1, 2).repeat_interleave(G, dim=1).detach()
              .requires_grad_() for t in (k, v))
    sdo = do.reshape(B, S, K * G, h).transpose(1, 2)
    pairs = B * K * G * S * (S + 1) // 2        # causal (row, key) pairs
    rows, keys = B * S * K * G * h, B * S * K * h
    shape = f"B{B}_S{S}_K{K}_G{G}_h{h}_causal"
    record("flash_prefill@qwen3_train",
           time_ms(lambda: flash_attn.flash_prefill(q, k, v, save_lse=True)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, k, v,
                                                          save_lse=True)),
           time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                          is_causal=True)),
           # q, k, v read, o written (bf16); lse written (fp32)
           2 * (2 * rows + 2 * keys) + 4 * B * K * S * G,
           4.0 * h * pairs, shape, BF16_FLOPS, "bfloat16")
    sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    record("flash_prefill_grads@qwen3_train",
           time_ms(lambda: flash_attn.flash_prefill_grads(q, k, v, o, lse,
                                                          do)),
           time_ms(lambda: flash_attn.flash_prefill_grads_plain(
               q, k, v, o, lse, do)),
           time_ms(lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                               retain_graph=True)),
           # q, o, do, k, v read; dq, dk, dv written (bf16); lse (fp32)
           2 * (4 * rows + 4 * keys) + 4 * B * K * S * G,
           # recomputed scores, dp, dq, dk, dv: five 2h products per pair
           10.0 * h * pairs, shape, BF16_FLOPS, "bfloat16",
           delta_ms=time_ms(lambda: flash_attn._delta(o, do)))


def _time_qwen3_fp32_cache(torch, randn, record, time_ms):
    """Phase 4 at Qwen3-0.6B's serving prefill over its fp32 cache (B 8, a
    128-token prompt over the 160-slot cache, K 8 KV heads x G 2, h 128,
    causal; records ``flash_prefill@qwen3_fp32_cache``): bf16 q, which the
    wrapper casts up to the cache's fp32 (the split-TF32 route, the casts
    timed with it).  Yardstick: F.scaled_dot_product_attention on the same
    q cast to fp32 in the call, over the cache's k and v expanded to the 16
    query heads before the timing."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    B, S, K, G, h = SMOKE["B"], SMOKE["S"], 8, 2, 128
    L = S + SMOKE["new"]
    q = randn(B, S, K, G, h, dtype=torch.bfloat16)
    kc, vc = randn(B, L, K, h), randn(B, L, K, h)
    qt = q.reshape(B, S, K * G, h).transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1)
              for t in (kc, vc))
    pairs = B * K * G * S * (S + 1) // 2
    # q read, o written (bf16); the k, v rows of the band (fp32)
    nbytes = 2 * 2 * B * S * K * G * h + 4 * 2 * B * S * K * h
    record("flash_prefill@qwen3_fp32_cache",
           time_ms(lambda: flash_attn.flash_prefill(q, kc, vc, 0, 0)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, kc, vc, 0, 0)),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt.float(), kt, vt, is_causal=True)),
           nbytes, 4.0 * h * pairs, f"B{B}_S{S}_T{L}_K{K}_G{G}_h{h}_q_bf16",
           SPLIT_TF32_FLOPS,
           fma_bound_ms=_bound_ms(nbytes, 4.0 * h * pairs, FP32_FLOPS)[0])


# phase 3's and 4's cases at the shapes phase 15's families give the
# kernels: B.1 on Mamba2's and Hymba's SSM in projections (wz, wx) and out
# projection (wo), (M, n, d_in_b, d_out_b), at decode and prefill rows;
# B.8 on Hymba's ff (blocks 400 x 1376, off the 64-column tiles) and
# Qwen1.5-MoE's shared expert (2048 -> 5632), (M, n, d_in, d_ff, d_out);
# B.4 windowed over Hymba's in-flight K/V (S >= the window: queries and
# keys at the same per-batch offsets), K 5 x G 5, h 64; B.9 over Hymba's
# ring with the window across the wrap point.  Phase 16's families
# (MODAL): B.1 on Whisper's ff up (1024 -> 4096)
# and down at the encoder's rows (8 x 1500) and the decode rows; B.8 on
# Phi-3-vision's SwiGLU ff (blocks 768 x 2048, past the tensor-core
# kernel's d_in of 256: the FMA kernel); B.4 non-causal over Whisper's
# 1500 frames (h 64, a ragged last key tile), causal at h 96 over
# Phi-3-vision's 576 patches + 128 text tokens and over its fp32 cache
# (128 of 160 slots); B.9 at h 96 over its fp32 ring, bf16 q
FAMILY_MM = {
    "mamba2_in_M8": (8, 4, 384, 768), "mamba2_out_M8": (8, 4, 768, 384),
    "mamba2_in_M1024": (1024, 4, 384, 768),
    "mamba2_out_M1024": (1024, 4, 768, 384),
    "hymba_in_M8": (8, 4, 400, 800), "hymba_out_M8": (8, 4, 800, 400),
    "hymba_in_M1024": (1024, 4, 400, 800),
    "hymba_out_M1024": (1024, 4, 800, 400),
    "whisper_up_M12000": (12000, 4, 256, 1024),
    "whisper_down_M12000": (12000, 4, 1024, 256),
    "whisper_up_M8": (8, 4, 256, 1024), "whisper_down_M8": (8, 4, 1024, 256)}
FAMILY_FF = {
    "hymba_M8": (8, 4, 400, 1376, 400), "hymba_M1024": (1024, 4, 400, 1376,
                                                      400),
    "moe_shared_M8": (8, 4, 512, 1408, 512),
    "moe_shared_M1024": (1024, 4, 512, 1408, 512),
    "phi3v_M8": (8, 4, 768, 2048, 768),
    "phi3v_M1024": (1024, 4, 768, 2048, 768)}
FAMILY_PREFILL = {
    # Hymba's prefill of 1280-token prompts over the 1024 window, at the
    # per-slot offsets of a re-prefill (phase 4 times it at offset 0, the
    # batch prefill)
    "hymba_S1280": dict(B=4, S=1280, K=5, G=5, h=64, window=1024,
                        off=[0, 17, 600, 1290]),
    # a smaller window than the prompt's reach, at offsets
    "hymba_offsets": dict(B=3, S=300, K=5, G=5, h=64, window=256,
                          off=[0, 17, 600]),
    # Whisper's encoder: every frame sees every frame
    "whisper_enc": dict(B=8, S=1500, K=16, G=1, h=64, causal=False),
    # Phi-3-vision's patch forward, and its prefill over a 160-slot cache
    "phi3v_patches": dict(B=4, S=704, K=32, G=1, h=96),
    "phi3v_cache": dict(B=8, S=128, T=160, K=32, G=1, h=96)}
FAMILY_RING = {
    # Hymba's batch decode: 4 rings of 1024 slots, 1280 + 16 tokens written
    "hymba_batch": dict(B=4, L=1024, K=5, G=5, h=64, idx=1295, window=1024),
    # a ring smaller than its reach: the window across the wrap point
    "wrap_window": dict(B=4, L=64, K=5, G=5, h=64, idx=[70, 150, 64, 200],
                        window=48),
    # Phi-3-vision's batch decode: 160 slots, 128 + 30 tokens written
    "phi3v_batch": dict(B=8, L=160, K=32, G=1, h=96, idx=158, window=None),
    "phi3v_slots": dict(B=4, L=160, K=32, G=1, h=96, idx=[0, 63, 64, 159],
                        window=None)}


def _check_families(torch, gen, dyad_mm, flash_attn, check, max_err):
    """Phase 3 at the family shapes (FAMILY_*), fp32 and bf16, each kernel
    against its plain version on the card; ``gen`` draws the inputs, so
    the earlier cases keep theirs."""
    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]

        def note(name, err):
            if dt == torch.float32:
                max_err[name] = max(max_err[name], err)
        for label, (M, n, d_in, d_out) in FAMILY_MM.items():
            x = randn(M, n * d_in, dtype=dt)
            w1, w2 = ((randn(n, d_out, d_in) / (n * d_in) ** 0.5).to(dt)
                      for _ in range(2))
            note("dyad_mm_blocks", check(
                f"dyad_mm_blocks/{label}",
                dyad_mm.dyad_mm_blocks(x, w1, w2),
                dyad_mm.dyad_mm_blocks_plain(x, w1, w2), dn))
        for label, (M, n, d_in, d_ff, d_out) in FAMILY_FF.items():
            # the models' fp32 params under either compute dtype
            args = _ff_args(randn, M, n, d_in, d_ff, d_out, "swiglu", dt,
                            torch.float32)
            got = dyad_mm.dyad_ff_fused(*args, act="swiglu")
            want = dyad_mm.dyad_ff_fused_plain(*args, act="swiglu")
            note("dyad_ff_fused", max(
                check(f"dyad_ff_fused/{label}/{c}", g, w, dn)
                for c, g, w in zip(("z1", "z2"), got, want)))
        for label, c in FAMILY_PREFILL.items():
            B, S, K, G, h = c["B"], c["S"], c["K"], c["G"], c["h"]
            T = c.get("T", S)
            q = randn(B, S, K, G, h, dtype=dt)
            k, v = randn(B, T, K, h, dtype=dt), randn(B, T, K, h, dtype=dt)
            off = (torch.tensor(c["off"], device=dev) if "off" in c else 0)
            kw = dict(causal=c.get("causal", True), window=c.get("window"))
            note("flash_prefill", check(
                f"flash_prefill/{label}",
                flash_attn.flash_prefill(q, k, v, off, off, **kw)[0],
                flash_attn.flash_prefill_plain(q, k, v, off, off, **kw)[0],
                dn))
        for label, c in FAMILY_RING.items():
            B, L, K, G, h = c["B"], c["L"], c["K"], c["G"], c["h"]
            # bf16 q over the engines' fp32 cache, or fp32 both
            q = randn(B, 1, K, G, h, dtype=dt)
            kc, vc = randn(B, L, K, h), randn(B, L, K, h)
            idx = (c["idx"] if isinstance(c["idx"], int)
                   else torch.tensor(c["idx"], dtype=torch.int32,
                                     device=dev))
            note("flash_decode", check(
                f"flash_decode/{label}",
                flash_attn.flash_decode(q, kc, vc, idx, window=c["window"]),
                flash_attn.flash_decode_plain(q, kc, vc, idx,
                                              window=c["window"]), dn))


def _time_families(torch, randn, record, time_ms):
    """Phase 4 at the family shapes, bf16 compute over fp32 params and
    caches as phases 15 and 16 serve them: ``dyad_mm_blocks@mamba2`` and
    ``@hymba`` (the SSM in and out projections at M 1024 and 8),
    ``@whisper`` (the ff up and down at M 8 x 1500 and 8; yardstick
    torch.bmm over the -CAT operands), ``dyad_ff_fused@hymba``,
    ``@moe_shared`` and ``@phi3v`` (M 1024 and 8; no single call: the
    torch.bmm chain beside, ``bmm_chain_ms``),
    ``flash_prefill@hymba_window`` (Hymba's S 1280 prefill over its
    in-flight K/V, window 1024; yardstick SDPA
    with the band mask, k and v expanded to the 25 query heads) and
    ``flash_decode@hymba_ring`` (its decode step over the wrapped ring;
    yardstick SDPA over the ring's live slots); then
    :func:`_time_modal_attention`."""
    import torch.nn.functional as F

    from repro_torch.kernels import dyad_mm, flash_attn

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    for model, labels in (
            ("mamba2", ("in_M1024", "out_M1024", "in_M8", "out_M8")),
            ("hymba", ("in_M1024", "out_M1024", "in_M8", "out_M8")),
            ("whisper", ("up_M12000", "down_M12000", "up_M8", "down_M8"))):
        for label in (f"{model}_{lab}" for lab in labels):
            M, n, d_in, d_out = FAMILY_MM[label]
            x = randn(M, n * d_in, dtype=bf16)
            w1, w2 = (randn(n, d_out, d_in).to(bf16) for _ in range(2))
            x1 = x.reshape(M, n, d_in)
            x2 = x.reshape(M, d_in, n).transpose(1, 2)
            xc = torch.cat([x1, x2], dim=-1).transpose(0, 1).contiguous()
            wc = torch.cat([w1, w2], dim=-1).transpose(1, 2).contiguous()
            record(f"dyad_mm_blocks@{model}",
                   time_ms(lambda: dyad_mm.dyad_mm_blocks(x, w1, w2)),
                   time_ms(lambda: dyad_mm.dyad_mm_blocks_plain(x, w1, w2)),
                   time_ms(lambda: torch.bmm(xc, wc)),
                   2 * (M * n * d_in + 2 * n * d_out * d_in + M * n * d_out),
                   4.0 * M * n * d_out * d_in, label, BF16_FLOPS, "bfloat16")
    for model in ("hymba", "moe_shared", "phi3v"):
        for label in (f"{model}_M1024", f"{model}_M8"):
            M, n, d_in, d_ff, d_out = FAMILY_FF[label]
            args = _ff_args(randn, M, n, d_in, d_ff, d_out, "swiglu", bf16,
                            f32)
            x1, x2 = args[0], args[1]
            wb = [a.to(bf16) for a in args[2:]]
            xc = torch.cat([x1, x2], dim=2).transpose(0, 1).contiguous()
            wuc = torch.cat([wb[0], wb[1]], dim=2).transpose(1,
                                                             2).contiguous()
            wgc = torch.cat([wb[4], wb[5]], dim=2).transpose(1,
                                                             2).contiguous()
            wdc = torch.cat([wb[2], wb[3]], dim=1).transpose(1,
                                                             2).contiguous()

            def chain():
                h = F.silu(torch.bmm(xc, wgc)) * torch.bmm(xc, wuc)
                return torch.bmm(h, wdc)
            record(f"dyad_ff_fused@{model}",
                   time_ms(lambda: dyad_mm.dyad_ff_fused(*args,
                                                         act="swiglu")),
                   time_ms(lambda: dyad_mm.dyad_ff_fused_plain(
                       *args, act="swiglu")), None,
                   # x (bf16), the fp32 weights, z1 and z2 (bf16)
                   (2 * M * n * d_in + 4 * (4 * n * d_ff * d_in
                                            + 2 * n * d_out * d_ff)
                    + 2 * 2 * M * n * d_out),
                   2.0 * M * n * (4 * d_ff * d_in + 2 * d_out * d_ff), label,
                   BF16_FLOPS, "bfloat16", bmm_chain_ms=time_ms(chain))

    c = FAMILY_PREFILL["hymba_S1280"]
    B, S, K, G, h, W = c["B"], c["S"], c["K"], c["G"], c["h"], c["window"]
    q = randn(B, S, K, G, h, dtype=bf16)
    k, v = randn(B, S, K, h, dtype=bf16), randn(B, S, K, h, dtype=bf16)
    pos = torch.arange(S, device=dev)
    band = ((pos[None, :] <= pos[:, None])
            & (pos[:, None] - pos[None, :] < W))
    qt = q.reshape(B, S, K * G, h).transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1) for t in (k, v))
    pairs = B * K * G * int(band.sum())
    record("flash_prefill@hymba_window",
           time_ms(lambda: flash_attn.flash_prefill(q, k, v, 0, 0,
                                                    window=W)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, k, v, 0, 0,
                                                          window=W)),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=band)),
           2 * (2 * B * S * K * G * h + 2 * B * S * K * h),
           4.0 * h * pairs, f"B{B}_S{S}_K{K}_G{G}_h{h}_window{W}",
           BF16_FLOPS, "bfloat16")

    c = FAMILY_RING["hymba_batch"]
    B, L, K, G, h, idx = c["B"], c["L"], c["K"], c["G"], c["h"], c["idx"]
    q = randn(B, 1, K, G, h, dtype=bf16)
    kc, vc = randn(B, L, K, h), randn(B, L, K, h)
    amask = _ring_mask(torch, idx, B, L, dev)
    live = int(amask.sum())
    q4 = q[:, 0]

    def library():
        return F.scaled_dot_product_attention(
            q4.float(), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=amask)
    record("flash_decode@hymba_ring",
           time_ms(lambda: flash_attn.flash_decode(q, kc, vc, idx,
                                                   window=c["window"])),
           time_ms(lambda: flash_attn.flash_decode_plain(
               q, kc, vc, idx, window=c["window"])),
           time_ms(library), 2 * live * K * h * 4 + 2 * 2 * B * K * G * h,
           4.0 * h * G * K * live, f"B{B}_L{L}_K{K}_G{G}_h{h}_idx{idx}",
           FP32_FLOPS, "bfloat16 q, float32 cache")
    _time_modal_attention(torch, randn, record, time_ms)


def _time_modal_attention(torch, randn, record, time_ms):
    """Phase 4 at phase 16's attention shapes, bf16 as it serves them:
    ``flash_prefill@whisper_enc`` (the encoder's non-causal attention over
    1500 frames, h 64), ``flash_prefill@phi3v_patches`` (the causal patch
    forward, h 96; yardstick SDPA) and ``flash_decode@phi3v_ring`` (the
    decode step at h 96, bf16 q over the fp32 ring; yardstick SDPA over
    the ring's live slots, q cast to fp32)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    for label, name in (("whisper_enc", "flash_prefill@whisper_enc"),
                        ("phi3v_patches", "flash_prefill@phi3v_patches")):
        c = FAMILY_PREFILL[label]
        B, S, K, G, h = c["B"], c["S"], c["K"], c["G"], c["h"]
        causal = c.get("causal", True)
        q = randn(B, S, K, G, h, dtype=bf16)
        k, v = randn(B, S, K, h, dtype=bf16), randn(B, S, K, h, dtype=bf16)
        qt = q.reshape(B, S, K * G, h).transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1)
                  for t in (k, v))
        pairs = B * K * G * (S * (S + 1) // 2 if causal else S * S)
        record(name,
               time_ms(lambda: flash_attn.flash_prefill(q, k, v,
                                                        causal=causal)),
               time_ms(lambda: flash_attn.flash_prefill_plain(
                   q, k, v, causal=causal)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal)),
               2 * (2 * B * S * K * G * h + 2 * B * S * K * h),
               4.0 * h * pairs,
               f"B{B}_S{S}_K{K}_G{G}_h{h}_" + ("causal" if causal
                                               else "noncausal"),
               BF16_FLOPS, "bfloat16")

    c = FAMILY_RING["phi3v_batch"]
    B, L, K, G, h, idx = c["B"], c["L"], c["K"], c["G"], c["h"], c["idx"]
    q = randn(B, 1, K, G, h, dtype=bf16)
    kc, vc = randn(B, L, K, h), randn(B, L, K, h)
    amask = _ring_mask(torch, idx, B, L, dev)
    live = int(amask.sum())
    q4 = q[:, 0]

    def library():
        return F.scaled_dot_product_attention(
            q4.float(), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=amask)
    record("flash_decode@phi3v_ring",
           time_ms(lambda: flash_attn.flash_decode(q, kc, vc, idx)),
           time_ms(lambda: flash_attn.flash_decode_plain(q, kc, vc, idx)),
           time_ms(library), 2 * live * K * h * 4 + 2 * 2 * B * K * G * h,
           4.0 * h * G * K * live, f"B{B}_L{L}_K{K}_G{G}_h{h}_idx{idx}",
           FP32_FLOPS, "bfloat16 q, float32 cache")


@contextlib.contextmanager
def _plain_watch(torch):
    """Counts the calls of every plain version of a kernel, of the port's
    plain attention and ff dataflows, and (under CROSS_SDPA) of
    cross-attention's einsum route, made with a tensor on the card (a CPU
    call is the CPU route, not counted).  Yields the Counter."""
    from repro_torch.core import dyad
    from repro_torch.kernels import dyad_mm, flash_attn
    from repro_torch.layers import attention, mlp

    calls = collections.Counter()
    targets = [(mod, name) for mod in (dyad_mm, flash_attn)
               for name in dir(mod) if name.endswith("_plain")]
    targets += [(attention, name) for name in (
        "_naive_sdpa", "_chunked_sdpa", "_q_block_sdpa", "_cross_sdpa")]
    targets += [(mlp, "_fused_dyad_mlp"), (dyad, "_bmm")]
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def watched(*a, _fn=fn, _name=f"{mod.__name__}.{name}", **kw):
            if any(torch.is_tensor(t) and t.is_cuda
                   for t in (*a, *kw.values())):
                calls[_name] += 1
            return _fn(*a, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, watched)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _family_cfg(arch, **over):
    """``arch``'s published config served on the card: flash attention on
    (the reference's configs leave it off, which serves through plain
    torch attention) and the kernel-routed linear of the config's own
    scope (``ff+ssm`` for Mamba2 and Hymba)."""
    from repro_torch import configs

    cfg = configs.get(arch, **over)
    return cfg.replace(flash_attn=True, linear=cfg.linear.replace(
        use_kernel=True, fuse_ff_kernel=True))


def _kernel_launches(per_kernel: dict) -> dict:
    """The profile's launches by kernel name, for each wrapper of
    KERNEL_NAMES."""
    return {w: sum(n for name, (_, n) in per_kernel.items()
                   if re.search(rf"\b({pat})\b", name))
            for w, pat in KERNEL_NAMES.items()}


def _router_margin(torch, model, cfg, params, prompts, toks, steps: int,
                   max_len: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probabilities (the real experts') over every MoE layer of the CPU's
    teacher-forced prefill and its first ``steps`` decode steps, on the
    CPU's own tokens."""
    from repro_torch.layers import moe

    route, gaps = moe._route, []

    def recorded(params_, x, n_experts, top_k):
        out = route(params_, x, n_experts, top_k)
        vals = out[2][..., :n_experts].sort(dim=-1, descending=True).values
        gaps.append(float((vals[..., top_k - 1] - vals[..., top_k]).min()))
        return out

    moe._route = recorded
    try:
        with torch.no_grad():
            cache = model.init_cache(cfg, prompts.shape[0], max_len,
                                     torch.float32, torch.device("cpu"))
            _, cache = model.prefill(cfg, params, cache, prompts)
            for i in range(steps):
                _, cache = model.decode_step(cfg, params, cache,
                                             toks[:, i:i + 1])
    finally:
        moe._route = route
    return min(gaps)


def _check_integer_tc(torch, gen, dyad_mm, dyad_cases, bwd_cases, failures):
    """Phase 3: dyad_mm_blocks (IT, OT and DT) and dyad_mm_dgrad_two (IT
    and DT cotangents) on integer-valued bf16 inputs in [-2, 2] at Qwen3's
    up shape and edge shapes.  The products and their fp32 sums (at most
    768 * 4 in magnitude) are exact in any order, so the tensor-core routes
    must give the bits of the plain version summed in fp32 and rounded
    once."""
    bf16 = torch.bfloat16

    def randint(*shape):
        return torch.randint(-2, 3, shape, generator=gen,
                             device=gen.device).to(bf16)

    def exact(label, got, want):
        same = torch.equal(got, want)
        log("check", case=label, dtype="bfloat16", integer_inputs=True,
            bitwise=same, ok=same)
        if not same:
            failures.append(label)

    for label in ("qwen3_up_M4096", "tc_ragged_n3_dt", "tc_ldx_pad3_n4_it",
                  "tc_odd_din_n4_dt"):
        M, n, d_in, d_out, var, *view = dyad_cases[label]
        pad, off = view or (0, 0)
        x = randint(M, n * d_in + pad)[:, off:off + n * d_in]
        w1, w2 = randint(n, d_out, d_in), randint(n, d_out, d_in)
        for v in ("it", "ot", "dt") if label.startswith("qwen3") else (var,):
            exact(f"dyad_mm_blocks/{label}/{v}/integer",
                  dyad_mm.dyad_mm_blocks(x, w1, w2, v),
                  dyad_mm.dyad_mm_blocks_plain(x.float(), w1.float(),
                                               w2.float(), v).to(bf16))
    for label in ("qwen3_up_M4096", "ragged_M300", "aligned_n4_M200"):
        M, n, d_in, d_out = bwd_cases[label]
        g = randint(M, n * d_out)
        w1, w2 = randint(n, d_out, d_in), randint(n, d_out, d_in)
        z = g.reshape(M, n, d_out)
        for zl, zb in (("it", z),
                       ("dt", g.reshape(M, d_out, n).transpose(1, 2))):
            got = dyad_mm.dyad_mm_dgrad_two(z, zb, w1, w2)
            want = dyad_mm.dyad_mm_dgrad_two_plain(z, zb, w1, w2)
            for c in (0, 1):
                exact(f"dyad_mm_dgrad_two/{label}/{zl}/dx{c + 1}/integer",
                      got[c], want[c])


def _check_exact_grads(torch, gen, flash_attn, failures):
    """Phase 3: bf16 flash_prefill_grads on inputs whose sums are exact
    (G 2, causal, 400 folded rows): lse = 0 and k = 0 (or q = 0), so every
    score is 0 and p is exactly 1 on the valid pairs; q (or k), v, o and do
    in {-1, 0, 1}.  Then dv = sum do, and at h 64 (scale 1/8) ds =
    (dP - delta) / 8 is exact in bf16, so dk = sum ds q and dq = sum ds k
    are exact fp32 sums: the tensor-core kernels, which round p and ds to
    bf16 in registers, must give the plain version's bits.  At h 128 the
    scale is not a power of two and only dv is exact."""
    B, S, K, G = 2, 200, 2, 2

    def draw(*shape):
        return torch.randint(-1, 2, shape, generator=gen,
                             device=gen.device).to(torch.bfloat16)

    for h, exact in ((64, ("dq", "dk", "dv")), (128, ("dv",))):
        for zero in ("k", "q"):
            q, o, do = (draw(B, S, K, G, h) for _ in range(3))
            k, v = draw(B, S, K, h), draw(B, S, K, h)
            (k if zero == "k" else q).zero_()
            lse = torch.zeros(B, K, S * G, device=gen.device)
            got = flash_attn.flash_prefill_grads(q, k, v, o, lse, do)
            want = flash_attn.flash_prefill_grads_plain(q, k, v, o, lse, do)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                if name not in exact:
                    continue
                label = f"flash_prefill_grads/h{h}_{zero}0/{name}/integer"
                same = torch.equal(a, b)
                log("check", case=label, dtype="bfloat16",
                    integer_inputs=True, bitwise=same, ok=same)
                if not same:
                    failures.append(label)


def _check_exact_prefill(torch, gen, flash_attn, failures):
    """Phase 3: bf16 flash_prefill on inputs whose sums are exact (G 2,
    causal, 400 folded rows, with and without a window): k = 0, so every
    valid score is 0 and p is exactly 1, and v in {-1, 0, 1}.  Then
    o = (sum of v) / l is an exact fp32 sum divided once: the tensor-core
    kernel, which rounds p to bf16 in registers, must give the plain
    version's bits, and lse = log(l) within 1e-6 relative."""
    B, S, K, G = 2, 200, 2, 2
    for h in (64, 128):
        for window in (None, 70):
            q = torch.randn(B, S, K, G, h, generator=gen,
                            device=gen.device).to(torch.bfloat16)
            k = torch.zeros(B, S, K, h, device=gen.device,
                            dtype=torch.bfloat16)
            v = torch.randint(-1, 2, (B, S, K, h), generator=gen,
                              device=gen.device).to(torch.bfloat16)
            kw = dict(causal=True, window=window, save_lse=True)
            o, lse = flash_attn.flash_prefill(q, k, v, **kw)
            po, plse = flash_attn.flash_prefill_plain(q, k, v, **kw)
            label = f"flash_prefill/h{h}_window{window}_k0/exact"
            same = torch.equal(o, po)
            lse_ok = bool(((lse - plse).abs() <= 1e-6 * plse.abs()).all())
            log("check", case=label, dtype="bfloat16", bitwise=same,
                lse_rel_1e6=lse_ok, ok=same and lse_ok)
            if not (same and lse_ok):
                failures.append(label)


def _tf32(torch, t):
    """t rounded to TF32 as cvt.rna.tf32.f32 rounds it (10-bit mantissa,
    ties away from zero): the operand of one TF32 product."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _gate_f64(label, got, plain, exact, failures) -> float:
    """Phase 3's float64 gate of a split-TF32 kernel: its largest error
    against ``exact`` (the plain version in float64) at most F64_GATE x the
    plain fp32 version's.  Returns the ratio of the two."""
    err = float((got.double() - exact).abs().max())
    ref = float((plain.double() - exact).abs().max())
    ok = err <= F64_GATE * ref
    ratio = err / ref if ref else (0.0 if err == 0 else math.inf)
    log("check", case=label + "/float64", dtype="float32",
        max_abs_err=f"{err:.3e}", plain_fp32_err=f"{ref:.3e}",
        ratio=f"{ratio:.2f}", gate=F64_GATE, ok=ok)
    if not ok:
        failures.append(label + "/float64")
    return ratio


def _repeat_bitwise(torch, label, first, again, failures) -> None:
    """The same bits again (no atomics in the kernels)."""
    same = all((a is None and b is None) or bool(torch.equal(a, b))
               for a, b in zip(first, again))
    log("check", case=label + "/bitwise_repeat", dtype="float32", ok=same)
    if not same:
        failures.append(label + "/bitwise_repeat")


def _check_split_precision(torch, gen, dyad_mm, flash_attn, failures):
    """Phase 3: the split-TF32 kernels on operands +-(1 + 2^-12) with
    random signs, whose low bits TF32's 10-bit mantissa drops: each
    kernel within SPLIT_REL x max|float64| of its plain version run in
    float64.  Beside it (printed, and required to miss by 1e-4 or more, so
    that the case can tell the routes apart) one TF32 product: the plain
    version in float64 over operands rounded to TF32.  dyad_mm_blocks at
    OPT's up and down (M 1024, IT) and a ragged OT; flash_prefill causal at
    h 64 and 128 and at h 80 with G 2 and a window; flash_prefill_grads at
    those shapes (dq, dk and dv each; o and lse, which no product reads,
    the plain fp32 forward's); dyad_mm_dgrad_two at OPT's up and down dx
    (M 1024, the IT cotangent view) and a ragged shape with the DT strided
    z2; dyad_mm_dgrad at OPT's up and down OT dx (M 1024, the stride-n
    z2bar) and a ragged shape; dyad_mm_wgrad at OPT's up (M 1024, the IT
    views) and down (the OT views) and a ragged OT shape, fp32 out;
    dyad_mm_blocks_two at OPT's up and down (M 1024, the OT and the DT
    views) and a ragged shape; dyad_mm_blocks_q and dyad_mm_blocks_two_q
    over int8 and fp8 payloads quantized from such weights (the payloads
    exact in TF32: only x is rounded in the one-product case) at those
    shapes, the IT view."""
    def pm(*shape):
        sign = torch.randint(0, 2, shape, generator=gen,
                             device=gen.device) * 2 - 1
        return sign.float() * (1 + 2.0 ** -12)

    def gate(label, got, exact, one):
        scale = float(exact.abs().max())
        rel = float((got.double() - exact).abs().max()) / scale
        rel_one = float((one - exact).abs().max()) / scale
        ok = rel <= SPLIT_REL and rel_one >= 1e-4
        log("check", case=label + "/split_precision", dtype="float32",
            rel_err=f"{rel:.3e}", one_tf32_rel_err=f"{rel_one:.3e}",
            tol=SPLIT_REL, ok=ok)
        if not ok:
            failures.append(label + "/split_precision")

    plain = dyad_mm.dyad_mm_blocks_plain
    for label, (M, n, d_in, d_out, var) in (
            ("up_M1024", (1024, 4, 192, 768, "it")),
            ("down_M1024", (1024, 4, 768, 192, "it")),
            ("ragged_ot", (77, 3, 65, 130, "ot"))):
        x, w1, w2 = pm(M, n * d_in), pm(n, d_out, d_in), pm(n, d_out, d_in)
        gate(f"dyad_mm_blocks/{label}", dyad_mm.dyad_mm_blocks(x, w1, w2, var),
             plain(x.double(), w1.double(), w2.double(), var),
             plain(*(_tf32(torch, t).double() for t in (x, w1, w2)), var))
    for label, (B, S, K, G, h, window) in (
            ("h64", (2, 256, 2, 1, 64, None)),
            ("h128", (2, 256, 2, 2, 128, None)),
            ("h80_g2_window", (2, 150, 2, 2, 80, 40))):
        q, k, v = pm(B, S, K, G, h), pm(B, S, K, h), pm(B, S, K, h)
        kw = dict(causal=True, window=window)
        gate(f"flash_prefill/{label}",
             flash_attn.flash_prefill(q, k, v, **kw)[0],
             flash_attn.flash_prefill_plain(q.double(), k.double(),
                                            v.double(), **kw)[0],
             flash_attn.flash_prefill_plain(
                 *(_tf32(torch, t).double() for t in (q, k, v)), **kw)[0])
        do = pm(B, S, K, G, h)
        o, lse = flash_attn.flash_prefill_plain(q, k, v, save_lse=True,
                                                **kw)
        got = flash_attn.flash_prefill_grads(q, k, v, o, lse, do, **kw)
        exact = flash_attn.flash_prefill_grads_plain(
            q.double(), k.double(), v.double(), o.double(), lse.double(),
            do.double(), **kw)
        one = flash_attn.flash_prefill_grads_plain(
            *(_tf32(torch, t).double() for t in (q, k, v)), o.double(),
            lse.double(), _tf32(torch, do).double(), **kw)
        for name, a, e, t in zip(("dq", "dk", "dv"), got, exact, one):
            gate(f"flash_prefill_grads/{label}/{name}", a, e, t)
    dplain = dyad_mm.dyad_mm_dgrad_two_plain
    for label, (M, n, d_in, d_out, zl) in (
            ("up_M1024", (1024, 4, 192, 768, "it")),
            ("down_M1024", (1024, 4, 768, 192, "it")),
            ("ragged_dt", (77, 3, 65, 130, "dt"))):
        g = pm(M, n * d_out)
        z1 = g.reshape(M, n, d_out)
        z2 = z1 if zl == "it" else g.reshape(M, d_out, n).transpose(1, 2)
        w1, w2 = pm(n, d_out, d_in), pm(n, d_out, d_in)
        got = dyad_mm.dyad_mm_dgrad_two(z1, z2, w1, w2)
        exact = dplain(z1.double(), z2.double(), w1.double(), w2.double())
        one = dplain(*(_tf32(torch, t).double() for t in (z1, z2, w1, w2)))
        for c in (0, 1):
            gate(f"dyad_mm_dgrad_two/{label}/dx{c + 1}", got[c], exact[c],
                 one[c])
    fplain = dyad_mm.dyad_mm_dgrad_plain
    wplain = dyad_mm.dyad_mm_wgrad_plain
    for label, (M, n, d_in, d_out, view) in (
            ("up_M1024", (1024, 4, 192, 768, "it")),
            ("down_M1024", (1024, 4, 768, 192, "ot")),
            ("ragged_ot", (77, 3, 65, 130, "ot"))):
        g, x = pm(M, n * d_out), pm(M, n * d_in)
        z1, x1 = g.reshape(M, n, d_out), x.reshape(M, n, d_in)
        z2 = g.reshape(M, d_out, n).transpose(1, 2)
        w1, w2 = pm(n, d_out, d_in), pm(n, d_out, d_in)
        gate(f"dyad_mm_dgrad/{label}", dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2),
             fplain(z1.double(), z2.double(), w1.double(), w2.double()),
             fplain(*(_tf32(torch, t).double() for t in (z1, z2, w1, w2))))
        wargs = ((x1, x.reshape(M, d_in, n).transpose(1, 2), z1, z1)
                 if view == "it" else (x1, x1, z1, z2))
        got = dyad_mm.dyad_mm_wgrad(*wargs)
        exact = wplain(*(t.double() for t in wargs))
        one = wplain(*(_tf32(torch, t).double() for t in wargs))
        for c in (0, 1):
            gate(f"dyad_mm_wgrad/{label}/{view}/dw{c + 1}", got[c], exact[c],
                 one[c])
    from repro_torch import quant

    fwd_shapes = (("up_M1024", (1024, 4, 192, 768)),
                  ("down_M1024", (1024, 4, 768, 192)),
                  ("ragged", (77, 3, 65, 130)))
    tplain = dyad_mm.dyad_mm_blocks_two_plain
    for label, (M, n, d_in, d_out) in fwd_shapes:
        x, w1, w2 = pm(M, n * d_in), pm(n, d_out, d_in), pm(n, d_out, d_in)
        x1 = x.reshape(M, n, d_in)
        for view, x2 in (("ot", x1),
                         ("dt", x.reshape(M, d_in, n).transpose(1, 2))):
            got = dyad_mm.dyad_mm_blocks_two(x1, x2, w1, w2)
            exact = tplain(x1.double(), x2.double(), w1.double(), w2.double())
            one = tplain(*(_tf32(torch, t).double() for t in (x1, x2, w1, w2)))
            for c in (0, 1):
                gate(f"dyad_mm_blocks_two/{label}/{view}/z{c + 1}", got[c],
                     exact[c], one[c])
    for qdt in ("int8", "fp8"):
        for label, (M, n, d_in, d_out) in fwd_shapes:
            x = pm(M, n * d_in)
            x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(
                1, 2)
            (q1, s1), (q2, s2) = (quant.quantize_dyad_weight(
                pm(n, d_out, d_in), qdt) for _ in range(2))
            args = (x1, x2, q1, q2, s1, s2)
            dargs = (x1.double(), x2.double(), q1, q2, s1, s2)
            oargs = (_tf32(torch, x1).double(), _tf32(torch, x2).double(),
                     q1, q2, s1, s2)
            gate(f"dyad_mm_blocks_q/{label}/{qdt}",
                 dyad_mm.dyad_mm_blocks_q(*args),
                 dyad_mm.dyad_mm_blocks_q_plain(*dargs),
                 dyad_mm.dyad_mm_blocks_q_plain(*oargs))
            got = dyad_mm.dyad_mm_blocks_two_q(*args)
            exact = dyad_mm.dyad_mm_blocks_two_q_plain(*dargs)
            one = dyad_mm.dyad_mm_blocks_two_q_plain(*oargs)
            for c in (0, 1):
                gate(f"dyad_mm_blocks_two_q/{label}/{qdt}/z{c + 1}", got[c],
                     exact[c], one[c])


def _check_prefill_views_fp32(torch, gen, flash_attn, check, failures):
    """Phase 3: fp32 flash_prefill on strided views (q, k and v views into
    wider tensors: strides off a multiple of 4 elements, staged element by
    element; or 16-byte aligned strides of views that are not contiguous,
    copied by cp.async) at h 64 and 128, against the plain version on the
    same views and against float64."""
    B, S, K, G = 2, 90, 2, 2
    for h in (64, 128):
        for view in ("unaligned", "aligned"):
            if view == "unaligned":
                q = torch.randn(B, S, K, G, h + 3, generator=gen,
                                device=gen.device)[..., 1:h + 1]
                k, v = (torch.randn(B, S, K, h + 5, generator=gen,
                                    device=gen.device)[..., :h]
                        for _ in range(2))
            else:
                q = torch.randn(B, K, G, S, h, generator=gen,
                                device=gen.device).permute(0, 3, 1, 2, 4)
                k, v = (torch.randn(B, S, K, 2 * h, generator=gen,
                                    device=gen.device)[..., h:]
                        for _ in range(2))
            label = f"flash_prefill/views_{view}_h{h}"
            o, lse = flash_attn.flash_prefill(q, k, v, save_lse=True)
            po, plse = flash_attn.flash_prefill_plain(q, k, v, save_lse=True)
            check(label, o, po, "float32")
            check(label + "/lse", lse, plse, "float32")
            _gate_f64(label, o, po, flash_attn.flash_prefill_plain(
                q.double(), k.double(), v.double())[0], failures)


# the weight types of the tensor-core kernels' template arguments, as
# mangled
_MANGLED_TYPES = {"a": "int8", "13__nv_fp8_e4m3": "fp8",
                  "13__nv_bfloat16": "bf16"}


def _kernel_key(mangled: str, kernels):
    """``name<args>`` of a mangled entry function whose name holds one of
    ``kernels`` (its int or bool template argument, as 0/1, and its weight
    type), or None."""
    base = next((k for k in kernels if k in mangled), None)
    if base is None:
        return None
    hd = re.search(r"IL[ib](\d+)E", mangled)   # <HD> or <kGated>
    wt = re.search(r"[EI](a|13__nv_fp8_e4m3|13__nv_bfloat16)E", mangled)
    targs = [hd.group(1)] if hd else []
    targs += [_MANGLED_TYPES[wt.group(1)]] if wt else []
    return f"{base}<{','.join(targs) or '?'}>"


def _paged_key(mangled: str, kernels=None):
    """``paged<q,pool,HD,GM>`` (``,pad`` for a padded HD) of a mangled
    instantiation of the paged decode kernel, or None."""
    m = re.search(r"flash_decode_paged_kernelI(f|13__nv_bfloat16)(.+?)"
                  r"Lb[01]ELi(\d+)ELi(\d+)ELb([01])E", mangled)
    if m is None:
        return None
    names = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
    # a pool type other than float and int8 is bf16 (a repeated bf16 is
    # mangled as a substitution)
    return "paged<{},{},{},{}{}>".format(
        names[m.group(1)], names.get(m.group(2), "bf16"), m.group(3),
        m.group(4), ",pad" if m.group(5) == "1" else "")


def _ptxas(text: str, kernels, key=_kernel_key) -> dict:
    """Registers, spill bytes and wgmma serialisation warnings of each
    entry function of nvcc's ``-Xptxas -v`` output whose name holds one of
    ``kernels``, by ``key`` (``_kernel_key``)."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        key_ = key(mangled, kernels)
        if key_ is None:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        st = re.search(r"(\d+) bytes spill stores", chunk)
        ld = re.search(r"(\d+) bytes spill loads", chunk)
        out[key_] = {
            "regs": int(regs.group(1)) if regs else -1,
            "spill_stores": int(st.group(1)) if st else -1,
            "spill_loads": int(ld.group(1)) if ld else -1,
            "serialized": len(re.findall(
                rf"serialized[^\n]*{re.escape(mangled)}", text))}
    return out


def _sass_by_function(sass: str, kernel: str) -> dict:
    """HGMMA instructions of each instantiation of ``kernel`` in a
    library's SASS (``cuobjdump -sass``: one ``Function :`` header each),
    by ``_kernel_key``."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        key = _kernel_key(chunk.split(None, 1)[0], (kernel,))
        if key is not None:
            out[key] = len(re.findall(r"\bHGMMA\.", chunk))
    return out


# the sources whose fp32 route runs on split TF32 (no FMA kernel left)
SPLIT_SOURCES = ("flash_prefill", "flash_bwd", "dyad_dgrad",
                 "dyad_dgrad_fused", "dyad_wgrad", "dyad_mm_two")
# the split-TF32 instantiations and their bf16 twins: a mangled name's
# pattern, and its key
_SPLIT_FNS = {
    r"dyad_gemm_tc_kernelILb1ELb1EfLb1EfE": "dyad_gemm_tc<f32>",
    r"dyad_gemm_tc_kernelILb1ELb1E13__nv_bfloat16Lb1E": "dyad_gemm_tc<bf16>",
    r"dyad_gemm_tc_kernelILb1ELb1EfLb0EfE": "dyad_gemm_tc<f32,two>",
    r"dyad_gemm_tc_kernelILb1ELb1E13__nv_bfloat16Lb0E":
        "dyad_gemm_tc<bf16,two>",
    r"dyad_mm_q_tf32_kernelIaE": "dyad_mm_q_tf32<int8>",
    r"dyad_mm_q_tf32_kernelI13__nv_fp8_e4m3E": "dyad_mm_q_tf32<fp8>",
    r"dyad_mm_q_tc_kernelIaE": "dyad_mm_q_tc<int8>",
    r"dyad_mm_q_tc_kernelI13__nv_fp8_e4m3E": "dyad_mm_q_tc<fp8>",
    r"flash_fwd_tf32_kernelILi64E": "flash_fwd_tf32<64>",
    r"flash_fwd_tf32_kernelILi128E": "flash_fwd_tf32<128>",
    r"flash_fwd_tc_kernelILi64E": "flash_fwd_tc<64>",
    r"flash_fwd_tc_kernelILi128E": "flash_fwd_tc<128>",
    r"dyad_dgrad_tf32_kernelILb0E": "dyad_dgrad_tf32",
    r"dyad_gemm_tc_kernelILb1ELb0E13__nv_bfloat16Lb0E": "dyad_dgrad_tc<bf16>",
    r"dyad_dgrad_tf32_kernelILb1E": "dyad_dgrad_tf32<fuse>",
    r"dyad_gemm_tc_kernelILb1ELb0E13__nv_bfloat16Lb1E":
        "dyad_dgrad_tc<bf16,fuse>",
    r"dyad_wgrad_tf32_kernelIfL": "dyad_wgrad_tf32<f32>",
    r"dyad_wgrad_tf32_kernelI13__nv_bfloat16L": "dyad_wgrad_tf32<bf16>",
    r"dyad_gemm_tc_kernelILb0ELb0EfLb0E13__nv_bfloat16E":
        "dyad_wgrad_tc<bf16,f32>",
    r"dyad_gemm_tc_kernelILb0ELb0E13__nv_bfloat16Lb0E":
        "dyad_wgrad_tc<bf16,bf16>",
    r"flash_dkv_tf32_kernelILi64E": "flash_dkv_tf32<64>",
    r"flash_dkv_tf32_kernelILi128E": "flash_dkv_tf32<128>",
    r"flash_dq_tf32_kernelILi64E": "flash_dq_tf32<64>",
    r"flash_dq_tf32_kernelILi128E": "flash_dq_tf32<128>",
    r"flash_dkv_tc_kernelILi64E": "flash_dkv_tc<64>",
    r"flash_dkv_tc_kernelILi128E": "flash_dkv_tc<128>",
    r"flash_dq_tc_kernelILi64E": "flash_dq_tc<64>",
    r"flash_dq_tc_kernelILi128E": "flash_dq_tc<128>",
}


def _split_key(mangled: str):
    return next((key for pat, key in _SPLIT_FNS.items()
                 if re.search(pat, mangled)), None)


def _sass_split(build, dumps: dict) -> bool:
    """Phase 2 for the split-TF32 routes (dyad_mm_blocks past the decode
    rows, dyad_mm_blocks_two, dyad_mm_dgrad_two, dyad_mm_dgrad,
    dyad_mm_wgrad, flash_prefill and flash_prefill_grads in fp32), the
    quantized GEMMs' fp32-x route (two tf32 products a pair) and their
    bf16 twins: each instantiation's HGMMA and FFMA in the SASS (``dumps``:
    each library's, by source) and ptxas's registers, spills and wgmma
    serialisation, one line.
    Fails without HGMMA in each, with a spill or a serialised wgmma, with
    any FFMA in the fp32 GEMMs (their partial sums are added with FADD,
    the quantized one's scales multiply with FMUL),
    with more FFMA in an fp32 flash forward than in its bf16 twin (whose
    FFMA are the softmax's: the products are wgmma in both) and the HD / 2
    of the fp32 one's alpha O + P V merge, two code paths' worth: HD; or
    with more FFMA in an fp32 flash backward kernel than in its bf16 twin
    (whose FFMA are the probabilities': the fp32 one adds its partials
    with FADD)."""
    got, ptx = {}, {}
    for source in ("dyad_mm", "flash_prefill", "dyad_dgrad", "flash_bwd",
                   "dyad_dgrad_fused", "dyad_wgrad", "dyad_mm_two",
                   "dyad_mm_q"):
        for chunk in dumps[source].split("Function : ")[1:]:
            key = _split_key(chunk.split(None, 1)[0])
            if key:
                got[key] = (len(re.findall(r"\bHGMMA\.", chunk)),
                            len(re.findall(r"\bFFMA\b", chunk)))
        ptx.update(_ptxas((build.BUILD_DIR / f"{source}.log").read_text(),
                          (), key=lambda mangled, _: _split_key(mangled)))
    bad = [k for k in _SPLIT_FNS.values() if k not in got or k not in ptx]
    for k, (hgmma, ffma) in got.items():
        r = ptx.get(k, {})
        if not hgmma or r.get("spill_stores") or r.get("spill_loads") \
                or r.get("serialized"):
            bad.append(k)
    for k in ("dyad_gemm_tc<f32>", "dyad_gemm_tc<f32,two>", "dyad_dgrad_tf32",
              "dyad_dgrad_tf32<fuse>", "dyad_wgrad_tf32<f32>",
              "dyad_wgrad_tf32<bf16>", "dyad_mm_q_tf32<int8>",
              "dyad_mm_q_tf32<fp8>"):
        if got.get(k, (0, 1))[1]:
            bad.append(f"{k} FFMA")
    for hd in (64, 128):
        if got.get(f"flash_fwd_tf32<{hd}>", (0, 1 << 30))[1] > got.get(
                f"flash_fwd_tc<{hd}>", (0, 0))[1] + hd:
            bad.append(f"flash_fwd_tf32<{hd}> FFMA")
        for kern in ("dkv", "dq"):
            if got.get(f"flash_{kern}_tf32<{hd}>", (0, 1 << 30))[1] > \
                    got.get(f"flash_{kern}_tc<{hd}>", (0, 0))[1]:
                bad.append(f"flash_{kern}_tf32<{hd}> FFMA")
    log("sass_split", **{
        k: "HGMMA:{},FFMA:{},regs:{},spill_stores:{},spill_loads:{},"
           "wgmma_serialized:{}".format(
               *got.get(k, (-1, -1)),
               *(ptx.get(k, {}).get(f, -1) for f in (
                   "regs", "spill_stores", "spill_loads", "serialized")))
        for k in _SPLIT_FNS.values()}, ok=not bad)
    if bad:
        log("sass_split", failed=",".join(bad))
    return not bad


def _launches_by_name(per_kernel: dict, want: dict, key: str,
                      phase: str = "qwen3_train_profile") -> bool:
    """The profiled launches of each kernel of ``want`` by name, held to
    its count; one log line (``{key}_launches``, ``{key}_ms``)."""
    def hit(name, k):
        tail = r"\b" if name[-1].isalnum() or name[-1] == "_" else ""
        return re.search(rf"\b{re.escape(name)}{tail}", k)

    mine = {name: [v for k, v in per_kernel.items() if hit(name, k)]
            for name in want}
    got = {name: sum(cnt for _, cnt in v) for name, v in mine.items()}
    ok = bool(per_kernel) and got == want
    log(phase, **{
        f"{key}_launches": json.dumps(got, separators=(",", ":")),
        "want": json.dumps(want, separators=(",", ":")),
        f"{key}_ms": json.dumps({name: round(sum(ms for ms, _ in v), 3)
                                 for name, v in mine.items()},
                                separators=(",", ":"))}, ok=ok)
    return ok


def _ring_decode_split(steps: int, phase: str):
    """A ``profile_check`` for a profiled generate: its decode launches by
    kernel name, the split-key ring kernel once per layer and decode step
    and the paged kernel never (a cast around a call would show in the
    profile's ``copy_kernel_launches``)."""
    def check(per_kernel: dict, n_layers: int) -> bool:
        return _launches_by_name(
            per_kernel, {"flash_decode_ring_kernel": n_layers * steps,
                         "flash_decode_paged_kernel": 0}, "decode", phase)
    return check


def _ring_key(mangled: str, kernels=None):
    """``ring<q,cache,HD,GM>`` (``,pad`` for a padded HD) of a mangled
    instantiation of the ring decode kernel, or None."""
    m = re.search(r"flash_decode_ring_kernelI(f|13__nv_bfloat16)(f|.+?)"
                  r"Li(\d+)ELi(\d+)ELb([01])E", mangled)
    if m is None:
        return None
    names = {"f": "f32", "13__nv_bfloat16": "bf16"}
    # a cache type other than float is bf16 (a repeated bf16 is mangled as
    # a substitution)
    return "ring<{},{},{},{}{}>".format(
        names[m.group(1)], names.get(m.group(2), "bf16"), m.group(3),
        m.group(4), ",pad" if m.group(5) == "1" else "")


def _decode_occupancy(torch, build, flash_attn) -> bool:
    """Phase 2 for the split-key decode kernels, paged and ring: ptxas's
    registers and spills of each HD 128 instantiation, with the shared
    memory of a block and the blocks an SM holds at the span its cache
    dtype takes (the runtime's occupancy query); one line a source, and a
    spill in any instantiation fails."""
    import ctypes

    f32, bf16 = ("f32", torch.float32), ("bf16", torch.bfloat16)
    ok = True
    for kind, source, key, caches, span_of in (
            ("paged", "flash_decode_paged", _paged_key,
             (f32, bf16, ("int8", torch.int8)), flash_attn.PAGED_SPAN.get),
            ("ring", "flash_decode", _ring_key, (f32, bf16),
             lambda _: flash_attn.RING_SPAN)):
        ptx = _ptxas((build.BUILD_DIR / f"{source}.log").read_text(),
                     (f"flash_decode_{kind}_kernel",), key=key)
        occupancy = build.entry(f"{source}_occupancy")
        fields, bad = {}, [
            f"{k}(regs:{r['regs']},spill:{r['spill_stores']}/"
            f"{r['spill_loads']})"
            for k, r in ptx.items() if r["spill_stores"] or r["spill_loads"]]
        for qn, qcode in (("f32", 0), ("bf16", 1)):
            for code, (cn, cache) in enumerate(caches):
                for gm in (1, 2, 4, 8):
                    k = f"{kind}<{qn},{cn},128,{gm}>"
                    r = ptx.get(k)
                    if r is None:
                        bad.append(f"{k} no report")
                        continue
                    span = span_of(cache)
                    out = (ctypes.c_int * 2)()
                    err = occupancy(qcode, code, 128, gm, span, out)
                    if err:
                        bad.append(f"{k} occupancy error {err}")
                    fields[k] = (f"regs:{r['regs']},spill_stores:"
                                 f"{r['spill_stores']},spill_loads:"
                                 f"{r['spill_loads']},span:{span},"
                                 f"smem:{out[0]},blocks_sm:{out[1]}")
        log("ptxas", source=source, instantiations=len(ptx), **fields,
            ok=not bad)
        if bad:
            log("ptxas", failed=",".join(bad))
            ok = False
    return ok


def _qwen3_kernel_split(per_kernel: dict, n_layers: int) -> bool:
    """Phase 10: the profiled Qwen3 step's launches by kernel name: the
    tensor-core flash forward and ff megakernel twice a layer (remat
    recomputes the forward), the flash dk/dv and dq kernels once a layer
    each, the FMA ones never."""
    flash = {"flash_fwd_tc_kernel": 2 * n_layers, "flash_prefill_kernel": 0,
             "flash_dkv_tc_kernel": n_layers, "flash_dq_tc_kernel": n_layers,
             "flash_dkv_kernel": 0, "flash_dq_kernel": 0}
    ff = {"dyad_ff_tc_kernel": 2 * n_layers, "dyad_ff_kernel": 0}
    return all([_launches_by_name(per_kernel, flash, "flash"),
                _launches_by_name(per_kernel, ff, "ff")])


def _opt_kernel_split(per_kernel: dict, n_layers: int) -> bool:
    """Phase 7b: the profiled OPT-125m DYAD step's fp32 launches by kernel
    name: forward, the split-TF32 flash forward once a layer and the
    split-TF32 DYAD GEMM twice (up, down), no FMA prefill or tile kernel;
    backward, the split-TF32 flash dk/dv and dq kernels once a layer each
    and the split-TF32 dgrad and wgrad GEMMs twice each, no FMA flash
    backward and no FMA GEMM (``dyad_gemm_kernel``) at all."""
    return all([
        _launches_by_name(per_kernel, {
            "flash_fwd_tf32_kernel": n_layers, "flash_prefill_kernel": 0,
            "dyad_gemm_tc_kernel<true, true, float, true, float>":
                2 * n_layers,
            "dyad_mm_kernel": 0}, "fwd", "train_profile"),
        _launches_by_name(per_kernel, {
            "flash_dkv_tf32_kernel": n_layers,
            "flash_dq_tf32_kernel": n_layers, "flash_dkv_kernel": 0,
            "flash_dq_kernel": 0, "dyad_dgrad_tf32_kernel": 2 * n_layers,
            "dyad_wgrad_tf32_kernel": 2 * n_layers, "dyad_gemm_kernel": 0},
            "bwd", "train_profile")])


def _ot_kernel_split(per_kernel: dict, n_layers: int) -> bool:
    """Phase 7c: the profiled OPT-125m OT step's DYAD GEMMs by kernel name:
    its forward (dyad_mm_blocks_two, B.6) on the split-TF32 GEMM with the
    components apart twice a layer (up, down; the fused one, IT's, never),
    its input cotangent on the fused split-TF32 dgrad twice (the unfused
    one never), its weight cotangents on the split-TF32 wgrad twice, and
    no FMA GEMM (``dyad_gemm_kernel``, gone from the sources) at all."""
    return _launches_by_name(per_kernel, {
        "dyad_gemm_tc_kernel<true, true, float, false, float>": 2 * n_layers,
        "dyad_gemm_tc_kernel<true, true, float, true, float>": 0,
        "dyad_dgrad_tf32_kernel<true": 2 * n_layers,
        "dyad_dgrad_tf32_kernel<false": 0,
        "dyad_wgrad_tf32_kernel": 2 * n_layers,
        "dyad_gemm_kernel": 0}, "dyad", "ot_train_profile")


def _quant_opt_split(B: int, S: int, steps: int, sms: int):
    """A ``profile_check`` for phase 13a's profiled generate (OPT-125m,
    fp32 x over int8 payloads): its quantized GEMM launches by kernel name
    as mm_q_plan routes each projection, prefill (M = B S, one call a
    layer for up and down) and each decode step (M = B): the fp32-x
    tensor-core kernel (``dyad_mm_q_tf32_kernel``) or the FMA decode
    kernel (``dyad_mv_q_kernel``), the summed forward's second pass
    (``dyad_mm_q_reduce``) after each tensor-core launch, and never the
    bf16-x tensor-core kernel."""
    import torch
    from repro_torch.kernels import dyad_mm

    n, d, ff = 4, 768 // 4, 3072 // 4

    def check(per_kernel: dict, n_layers: int) -> bool:
        want = {"dyad_mm_q_tf32_kernel": 0, "dyad_mv_q_kernel": 0,
                "dyad_mm_q_reduce": 0, "dyad_mm_q_tc_kernel": 0}
        for M, calls in ((B * S, 1), (B, steps)):
            for d_in, d_out in ((d, ff), (ff, d)):
                kernel = dyad_mm.mm_q_plan(M, n, d_in, d_out, sms,
                                           torch.float32)[0]
                if kernel == "tc":
                    want["dyad_mm_q_tf32_kernel"] += calls * n_layers
                    want["dyad_mm_q_reduce"] += calls * n_layers
                else:
                    want["dyad_mv_q_kernel"] += calls * n_layers
        return _launches_by_name(per_kernel, want, "quant_gemm",
                                 "quant_opt_profile")
    return check


def _dgrad_two_entry(z1, z2, w1, w2, dx1, dx2):
    """dyad_mm_dgrad_two's C entry on the outputs given (the wrapper always
    writes dx2 permuted); returns the call, for timing.  Not counted."""
    from repro_torch.kernels import build, dyad_mm

    M, n, d_out = z1.shape
    d_in = w1.shape[2]
    fn = build.entry("dyad_dgrad")

    def call():
        build.check(fn(
            build.ptr(z1), build.ptr(z2), build.ptr(w1), build.ptr(w2),
            build.ptr(dx1), build.ptr(dx2), M, n, d_in, d_out,
            *z1.stride(), *z2.stride(), *dx1.stride(), *dx2.stride(),
            dyad_mm._DTYPES[z1.dtype], build.stream(z1.device)),
            "dyad_mm_dgrad_two")
    return call


def _ff_fma_entry(args, act: str):
    """dyad_ff_fused's C entry on the FMA kernel (the parent's route for
    bf16 x) with its hidden split, whatever ff_plan picks; returns (the
    call, its outputs), for timing and checking.  Not counted."""
    import torch
    from repro_torch.kernels import build, dyad_mm

    x1, x2 = args[0], args[1]
    M, n, d_in = x1.shape
    d_ff, d_out = args[2].shape[1], args[4].shape[1]
    split, span = dyad_mm.ff_split(M, n, d_ff, d_out,
                                   dyad_mm.sm_count(x1.device))
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=x1.device)
    z2 = dyad_mm._permuted_out(M, n, d_out, x1)
    part = (torch.empty(split, 2, M, n, d_out, dtype=torch.float32,
                        device=x1.device) if split > 1 else None)
    wu1, wu2, wd1, wd2, wg1, wg2 = args[2:]
    fn = build.entry("dyad_ff")

    def call():
        build.check(fn(
            build.ptr(x1), build.ptr(x2), build.ptr(wu1), build.ptr(wu2),
            build.ptr(wg1), build.ptr(wg2), build.ptr(wd1), build.ptr(wd2),
            build.ptr(z1), build.ptr(z2), build.ptr(part), None,
            M, n, d_in, d_ff, d_out, split, span, *x1.stride(),
            *x2.stride(), *z1.stride(), *z2.stride(),
            dyad_mm._ACT_CODES[act], dyad_mm._DTYPES[x1.dtype],
            dyad_mm._DTYPES[wu1.dtype], 0, build.stream(x1.device)),
            "dyad_ff_fused")
    return call, (z1, z2)


def _check_integer_ff_slice(torch, gen, dyad_mm, two_cases, failures):
    """Phase 3: bf16 dyad_mm_blocks_two (OT and the stride-n DT x2) at
    Qwen3's split-route down shape and ragged shapes, and dyad_ff_fused
    with relu at Qwen3's widths (the fp32 params the main path hands over)
    at M 4096 and 128, on integers in [-2, 2].  Every fp32 sum is exact
    (the up sums below 2048, the hidden an integer rounded to bf16 the same
    way on both sides, the down sums below 2^24), so the tensor-core
    routes must give the plain version's bits."""
    bf16 = torch.bfloat16

    def randint(*shape):
        return torch.randint(-2, 3, shape, generator=gen,
                             device=gen.device).to(bf16)

    def exact(label, got, want, **kw):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log("check", case=label, dtype="bfloat16", integer_inputs=True,
            **kw, bitwise=same, ok=same)
        if not same:
            failures.append(label)

    for label in ("qwen3_split_down_M4096", "ragged_M300",
                  "aligned_n4_M200"):
        M, n, d_in, d_out = two_cases[label]
        x = randint(M, n * d_in)
        w1, w2 = randint(n, d_out, d_in), randint(n, d_out, d_in)
        x1 = x.reshape(M, n, d_in)
        for xl, xb in (("ot", x1),
                       ("dt", x.reshape(M, d_in, n).transpose(1, 2))):
            exact(f"dyad_mm_blocks_two/{label}/{xl}/integer",
                  dyad_mm.dyad_mm_blocks_two(x1, xb, w1, w2),
                  dyad_mm.dyad_mm_blocks_two_plain(x1, xb, w1, w2))
    n, d_in, d_ff, d_out = 4, 256, 768, 256
    for M in (4096, 128):
        x = randint(M, n * d_in)
        x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(
            1, 2)
        ws = [randint(n, d_ff, d_in).float() for _ in range(2)] + [
            randint(n, d_out, d_ff).float() for _ in range(2)]
        exact(f"dyad_ff_fused/qwen3_relu_M{M}/integer",
              dyad_mm.dyad_ff_fused(x1, x2, *ws, act="relu"),
              dyad_mm.dyad_ff_fused_plain(x1, x2, *ws, act="relu"),
              plan=dyad_mm.ff_plan(M, n, d_in, d_ff, d_out,
                                   dyad_mm.sm_count(gen.device),
                                   bf16)[0])


def _mm_q_entry(args, two: bool, tc: bool):
    """dyad_mm_blocks_q's (``two``: dyad_mm_blocks_two_q's) C entry on the
    tensor-core route (``tc``, with mm_q_tc_split's ranges) or the FMA
    decode kernel (decode rows only), whatever mm_q_plan picks; returns
    (the call, its outputs), for timing and checking.  Not counted."""
    import torch
    from repro_torch.kernels import build, dyad_mm

    x1, x2, q1, q2, s1, s2 = args
    M, n, d_in = x1.shape
    d_out = q1.shape[1]
    dev = x1.device
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=dev)
    z2 = dyad_mm._permuted_out(M, n, d_out, x1)
    outs = (z1, z2) if two else (z1,)
    split, krows = (dyad_mm.mm_q_tc_split(M, n, d_in, d_out,
                                          dyad_mm.sm_count(dev), x1.dtype)
                    if tc else (1, d_in))
    part = (torch.empty(split, 2, n, M, d_out, dtype=torch.float32,
                        device=dev) if tc and (split > 1 or not two)
            else None)
    fn = build.entry("dyad_mm_two_q" if two else "dyad_mm_q")
    codes = (dyad_mm._DTYPES[x1.dtype], dyad_mm._PAYLOADS[q1.dtype], int(tc))

    def call():
        build.check(fn(
            *(build.ptr(t) for t in (x1, x2, q1, q2, s1, s2) + outs + (part,)),
            M, n, d_in, d_out, split, krows, *x1.stride(), *x2.stride(),
            *(st for t in outs for st in t.stride()), *codes,
            build.stream(dev)), "dyad_mm_blocks_q")
    return call, outs


def _ff_q_fma_entry(args, gate: dict, act: str):
    """dyad_ff_fused_q's C entry on the FMA kernel (the parent's route for
    bf16 x) with its hidden split, whatever ff_q_plan picks; returns (the
    call, its outputs).  Not counted."""
    import torch
    from repro_torch.kernels import build, dyad_mm

    x1, x2, wu1, wu2, wd1, wd2, su1, su2, sd1, sd2 = args
    M, n, d_in = x1.shape
    d_ff, d_out = wu1.shape[1], wd1.shape[1]
    split, span = dyad_mm.ff_split(M, n, d_ff, d_out,
                                   dyad_mm.sm_count(x1.device))
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=x1.device)
    z2 = dyad_mm._permuted_out(M, n, d_out, x1)
    part = (torch.empty(split, 2, M, n, d_out, dtype=torch.float32,
                        device=x1.device) if split > 1 else None)
    g = [gate.get(k) for k in ("wg1", "wg2", "sg1", "sg2")]
    fn = build.entry("dyad_ff_q")

    def call():
        build.check(fn(
            *(build.ptr(t) for t in (x1, x2, wu1, wu2, g[0], g[1], wd1, wd2,
                                     su1, su2, g[2], g[3], sd1, sd2, z1, z2,
                                     part)),
            M, n, d_in, d_ff, d_out, split, span, *x1.stride(),
            *x2.stride(), *z1.stride(), *z2.stride(),
            dyad_mm._ACT_CODES[act], dyad_mm._DTYPES[x1.dtype],
            dyad_mm._PAYLOADS[wu1.dtype], 0, build.stream(x1.device)),
            "dyad_ff_fused_q")
    return call, (z1, z2)


def _exact_payload(torch, shape, qdtype, device, salt=0):
    """(payload, exponent) of ``shape`` (n, rows, k) whose bytes cover
    every int8 value, or every finite e4m3 value, with sums that stay
    exact: int8 row r of block g holds the 256 values cyclically along k;
    an fp8 row holds one binade (exponent e = (r + g + salt) % 16, e 0 the
    subnormals) with every mantissa and both signs along k (the NaN code
    of e 15 replaced by 448's).  ``exponent`` is e (zeros for int8)."""
    n, rows, k = shape
    g = torch.arange(n, device=device)[:, None, None]
    r = torch.arange(rows, device=device)[None, :, None]
    kk = torch.arange(k, device=device)[None, None, :]
    if qdtype == "int8":
        q = ((kk + 7 * r + 13 * g + salt) % 256 - 128).to(torch.int8)
        return q, torch.zeros(n, rows, device=device, dtype=torch.long)
    e = (r + g + salt) % 16
    m = kk % 8
    m = torch.where((e == 15) & (m == 7), torch.full_like(m, 6), m)
    byte = ((kk // 8) % 2) << 7 | (e << 3) | m
    return byte.to(torch.uint8).view(torch.float8_e4m3fn), e[..., 0].expand(
        n, rows)


def _check_exact_quant(torch, gen, dyad_mm, failures):
    """Phase 3: the tensor-core routes of the quantized kernels on
    payloads that cover every int8 value and every finite e4m3 value
    (``_exact_payload``), power-of-two scales and integer x, whose fp32
    sums are exact, bitwise against the plain version: bf16 x, and for
    the GEMMs fp32 x too (its tf32 hi is x, its lo 0).
    dyad_mm_blocks_q and dyad_mm_blocks_two_q (IT and OT views) at Qwen3's
    split-route down (M 8, 128) and up (M 128): x in [-2, 2], every sum
    below 2^24 of its row's quantum (int8: 768 x 2 x 128; fp8: one binade
    a row, 768 x 2 x 16), the two components' scales within 8x.
    dyad_ff_fused_q with relu at Qwen3's widths (M 128, split into the
    serving rows' 12 ranges, and 1024): each row of x one +-1, placed so
    that one component at most feeds each block's up sum; the up scales
    bring each hidden value to a multiple of 2^-7 (int8) or 1/16 (fp8)
    below 1, exact in bf16, and the down sums stay below 768 x 128 (int8)
    or 768 x 2^8 (fp8) of their quantum.  Then fp32 x through both GEMMs
    at Qwen3's split-route down (M 8, 128) and OPT-125m's up and down at
    its quantized prefill rows (M 1024)."""
    bf16 = torch.bfloat16
    dev = gen.device

    def exact(label, got, want, dtype="bfloat16", **kw):
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log("check", case=label, dtype=dtype, exact_inputs=True,
            **kw, bitwise=same, ok=same)
        if not same:
            failures.append(label)

    def pow2(n, rows, c):
        o = torch.arange(rows, device=dev)[None, :]
        g = torch.arange(n, device=dev)[:, None]
        return torch.exp2(-((o + g + c) % 4).float()).contiguous()

    sms = dyad_mm.sm_count(dev)
    for qdt in ("int8", "fp8"):
        for label, (M, n, d_in, d_out) in (
                ("qwen3_down_M8", (8, 4, 768, 256)),
                ("qwen3_down_M128", (128, 4, 768, 256)),
                ("qwen3_up_M128", (128, 4, 256, 768))):
            x = torch.randint(-2, 3, (M, n * d_in), generator=gen,
                              device=dev).to(bf16)
            x1 = x.reshape(M, n, d_in)
            q1 = _exact_payload(torch, (n, d_out, d_in), qdt, dev)[0]
            q2 = _exact_payload(torch, (n, d_out, d_in), qdt, dev, 5)[0]
            if qdt == "fp8":   # both components' rows in one binade
                q2 = q1.view(torch.uint8).flip(-1).contiguous().view(
                    torch.float8_e4m3fn)
            s1, s2 = pow2(n, d_out, 0), pow2(n, d_out, 1)
            plan = dyad_mm.mm_q_plan(M, n, d_in, d_out, sms, bf16)
            for xl, xb in (("it", x.reshape(M, d_in, n).transpose(1, 2)),
                           ("ot", x1)):
                args = (x1, xb, q1, q2, s1, s2)
                exact(f"dyad_mm_blocks_q/{label}/{xl}/{qdt}/exact",
                      (dyad_mm.dyad_mm_blocks_q(*args),),
                      (dyad_mm.dyad_mm_blocks_q_plain(*args),),
                      kernel=plan[0], split=plan[1])
                exact(f"dyad_mm_blocks_two_q/{label}/{xl}/{qdt}/exact",
                      dyad_mm.dyad_mm_blocks_two_q(*args),
                      dyad_mm.dyad_mm_blocks_two_q_plain(*args),
                      kernel=plan[0], split=plan[1])
        n, d_in, d_ff, d_out = 4, 256, 768, 256
        for M in (128, 1024):
            m = torch.arange(M, device=dev)
            b = m % n
            k = (m * 37 + 1) % d_in
            k = torch.where(k % n == b, (k + 1) % d_in, k)
            x = torch.zeros(M, n * d_in, device=dev)
            x[m, b * d_in + k] = torch.where((m // 3) % 2 == 0, 1.0, -1.0)
            x = x.to(bf16)
            x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(
                1, 2)
            ups, su = [], []
            for c in range(2):
                q, e = _exact_payload(torch, (n, d_ff, d_in), qdt, dev, 3 * c)
                ups.append(q)
                su.append(torch.full((n, d_ff), 2.0 ** -7, device=dev)
                          if qdt == "int8" else
                          torch.exp2(torch.where(e > 0, 6 - e, 5).float()))
            downs = [_exact_payload(torch, (n, d_out, d_ff), qdt, dev, c)[0]
                     for c in range(2)]
            sd = [pow2(n, d_out, c) for c in range(2)]
            args = (x1, x2, ups[0], ups[1], downs[0], downs[1], su[0],
                    su[1], sd[0], sd[1])
            plan = dyad_mm.ff_q_plan(M, n, d_in, d_ff, d_out, sms, bf16)
            exact(f"dyad_ff_fused_q/qwen3_relu_M{M}/{qdt}/exact",
                  dyad_mm.dyad_ff_fused_q(*args, act="relu"),
                  dyad_mm.dyad_ff_fused_q_plain(*args, act="relu"),
                  kernel=plan[0], split=plan[1])
    # fp32 x (drawn after every bf16 case, which keeps its inputs)
    for qdt in ("int8", "fp8"):
        for label, (M, n, d_in, d_out) in (
                ("qwen3_down_M8", (8, 4, 768, 256)),
                ("qwen3_down_M128", (128, 4, 768, 256)),
                ("opt_up_M1024", (1024, 4, 192, 768)),
                ("opt_down_M1024", (1024, 4, 768, 192))):
            x = torch.randint(-2, 3, (M, n * d_in), generator=gen,
                              device=dev).float()
            x1 = x.reshape(M, n, d_in)
            q1 = _exact_payload(torch, (n, d_out, d_in), qdt, dev)[0]
            q2 = _exact_payload(torch, (n, d_out, d_in), qdt, dev, 5)[0]
            if qdt == "fp8":
                q2 = q1.view(torch.uint8).flip(-1).contiguous().view(
                    torch.float8_e4m3fn)
            s1, s2 = pow2(n, d_out, 0), pow2(n, d_out, 1)
            plan = dyad_mm.mm_q_plan(M, n, d_in, d_out, sms, torch.float32)
            for xl, xb in (("it", x.reshape(M, d_in, n).transpose(1, 2)),
                           ("ot", x1)):
                args = (x1, xb, q1, q2, s1, s2)
                exact(f"dyad_mm_blocks_q/{label}/{xl}/{qdt}/fp32_x/exact",
                      (dyad_mm.dyad_mm_blocks_q(*args),),
                      (dyad_mm.dyad_mm_blocks_q_plain(*args),),
                      dtype="float32", kernel=plan[0], split=plan[1])
                exact(f"dyad_mm_blocks_two_q/{label}/{xl}/{qdt}/fp32_x/exact",
                      dyad_mm.dyad_mm_blocks_two_q(*args),
                      dyad_mm.dyad_mm_blocks_two_q_plain(*args),
                      dtype="float32", kernel=plan[0], split=plan[1])


def _ring_cases(span: int) -> dict:
    """The ring decode's split-edge cases, {label: (L, idxs, window)}, at
    splits of ``span`` ring slots: L = 4 spans + 16 slots (the last split a
    partial one) but where named."""
    L = 4 * span + 16
    return {
        # unwrapped: a split's last slot, the next split's first, the last
        # slot, the first step
        "edges": (L, [span - 1, span, 2 * span - 1, 2 * span, L - 1, 0],
                  None),
        # wrapped rings, idx past one and two laps
        "wrapped": (L, [L, L + span - 1, L + span, 2 * L + 3, 3 * L - 1],
                    None),
        # the window's slots cross the wrap point, or empty the ring's
        # leading splits
        "window_wrap": (L, [L + 5, 2 * L + span, L + 3 * span + 5, L + 40],
                        span + 7),
        # a window of all but 10 slots: a dead run inside a tile
        "window_gap": (L, [L + 70, 2 * L + 8, 3 * L - 20], L - 10),
        "l_not_multiple": (3 * span + 7, [3 * span + 6, 3 * span + 9,
                                          7 * span + 20, 40], None),
        # one slot in one split beside one in every split
        "one_and_every": (L, [5, L - 1, 3 * L], None),
        "idx0": (L, [0, 0, 1], None),
    }


def _one_call_kernels(torch, fn) -> dict:
    """{device kernel name: launches} of one call of ``fn`` (warmed up
    first), profiled with PROFILE_MARGIN_S idle at each end."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return {ev.key: ev.count for ev in prof.key_averages()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")
            and (getattr(ev, "self_device_time_total", 0) or 0) > 0}


def _check_ring_decode(torch, gen, flash_attn, failures, max_err):
    """Phase 3 for the ring decode, at Qwen3's KV heads (K 8, G 2, h 128)
    and OPT's (K 12, G 1, h 64), inputs drawn from ``gen``: the split-edge
    cases for every pair of q and cache dtypes against the plain version,
    one line a pair; then, over bf16 q and an fp32 cache (Qwen3's serving
    pair) and fp32 over fp32 (OPT's), each slot of 8 alone bitwise equal to
    its batch row, a repeat call bitwise with a launch of another batch and
    ring length between, and NaN in every dead ring slot moving no bit; and
    one call at each engine's arguments launching one kernel, the ring
    kernel, with no cast beside it."""
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    decode, plain = flash_attn.flash_decode, flash_attn.flash_decode_plain

    def inputs(B, L, K, G, h, q_dt, cache_dt):
        def randn(*shape, dt):
            return torch.randn(*shape, generator=gen, device=dev).to(dt)
        return (randn(B, 1, K, G, h, dt=q_dt), randn(B, L, K, h, dt=cache_dt),
                randn(B, L, K, h, dt=cache_dt))

    def ivec(idxs):
        return torch.tensor(idxs, dtype=torch.int32, device=dev)

    shapes = {"qwen3": (8, 2, 128), "opt": (12, 1, 64)}
    for shape, (K, G, h) in shapes.items():
        for q_dt in (f32, bf16):
            for c_dt in (f32, bf16):
                exact = q_dt == c_dt == f32
                tol = TOL["float32" if exact else "bfloat16"]
                cases = _ring_cases(flash_attn.RING_SPAN)
                worst, bad = 0.0, []
                for case, (L, idxs, window) in cases.items():
                    q, k, v = inputs(len(idxs), L, K, G, h, q_dt, c_dt)
                    idx = ivec(idxs)
                    ok, err, bound = _close(
                        decode(q, k, v, idx, window=window),
                        plain(q, k, v, idx, window=window), tol)
                    worst = max(worst, err)
                    if not ok:
                        bad.append(case)
                label = (f"flash_decode/split_edges/{shape}/q_"
                         f"{str(q_dt)[6:]}_cache_{str(c_dt)[6:]}")
                log("check", case=label, cases=len(cases),
                    max_abs_err=f"{worst:.3e}",
                    tol=f"{tol:.0e} x max(|plain|, 1)", ok=not bad)
                if bad:
                    failures.append(f"{label}:{'+'.join(bad)}")
                if exact:
                    max_err["flash_decode"] = max(max_err["flash_decode"],
                                                  worst)

    span = flash_attn.RING_SPAN
    for shape, q_dt in (("qwen3", bf16), ("opt", f32)):
        K, G, h = shapes[shape]
        q, k, v = inputs(8, 512, K, G, h, q_dt, f32)
        idx = ivec([0, span - 1, span, 2 * span + 3, 300, 511, 600, 1500])
        alone = True
        for window in (None, 200):
            batch = decode(q, k, v, idx, window=window)
            alone = alone and all(torch.equal(decode(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], idx[i:i + 1],
                window=window), batch[i:i + 1]) for i in range(8))
        first = decode(q, k, v, idx)
        decode(*inputs(3, 160, K, G, h, q_dt, f32), 143, window=100)
        again = torch.equal(decode(q, k, v, idx), first)
        # NaN in the slots past idx, outside windows across the wrap point,
        # and in dead runs inside a tile (window 502 of 512)
        poisoned = True
        idx = ivec([582, 1000, 520, 70, 0, 143, 511, 37])
        j = torch.arange(512, device=dev)
        iv = idx.long()[:, None]
        pos = iv - torch.remainder(iv - j, 512)
        for window in (None, 150, 502):
            clean = decode(q, k, v, idx, window=window)
            dead = pos < 0
            if window is not None:
                dead |= iv - pos >= window
            kp, vp = k.clone(), v.clone()
            kp[dead] = float("nan")
            vp[dead] = float("nan")
            got = decode(q, kp, vp, idx, window=window)
            poisoned = (poisoned and torch.equal(got, clean)
                        and bool(torch.isfinite(got.float()).all()))
        zero = int(flash_attn._paged_counters[q.device].abs().sum()) == 0
        ok = alone and again and poisoned and zero
        log("check", case=f"flash_decode/bits/{shape}",
            dtype=f"q_{str(q_dt)[6:]}_cache_float32", alone_bitwise=alone,
            repeat_bitwise=again, poisoned_dead_rows_bitwise=poisoned,
            counters_zero=zero, ok=ok)
        if not ok:
            failures.append(f"flash_decode/bits/{shape}")

    # one call, one kernel: the batch engine's call (scalar idx) and the
    # continuous engine's over dense rings (an int32 (B,) idx), bf16 q over
    # an fp32 cache at Qwen3's shape
    q, k, v = inputs(8, 160, 8, 2, 128, bf16, f32)
    for label, idx in (("scalar_idx", 143), ("vector_idx", ivec([143] * 8))):
        kernels = _one_call_kernels(torch, lambda: decode(q, k, v, idx))
        ok = (list(kernels.values()) == [1] and
              "flash_decode_ring_kernel" in next(iter(kernels)))
        log("check", case=f"flash_decode/one_launch/{label}",
            kernels=json.dumps({n[:60]: c for n, c in kernels.items()}),
            ok=ok)
        if not ok:
            failures.append(f"flash_decode/one_launch/{label}")


def _ring_mask(torch, idx, B: int, L: int, device):
    """(B, 1, 1, L) live ring slots at write index ``idx`` (no window)."""
    iv = torch.as_tensor(idx, device=device).long().reshape(-1).expand(B)
    j = torch.arange(L, device=device)
    return (iv[:, None] - torch.remainder(iv[:, None] - j, L)
            >= 0)[:, None, None, :]


def _time_ring(torch, randn, record, time_ms):
    """Phase 4 for the ring decode at Qwen3's two serving shapes, bf16 q
    (the bf16 compute) over an fp32 cache (the engines' cache dtype), K 8,
    G 2, h 128: the batch engine's decode step mid-generation (8 rows of
    160 slots, prompt 128 + 32 new, idx 143) and the continuous engine's
    over dense rings (8 slots of 512, idx 511 as its int32 (B,) vector).
    Yardstick: F.scaled_dot_product_attention over the cache, the G query
    heads of each KV head as its query rows, with the ring's live mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    dev = torch.device("cuda")
    K, G, h = 8, 2, 128
    for name, B, L, idx in (
            ("flash_decode@qwen3_batch", 8, 160, 143),
            ("flash_decode@ring512", 8, 512,
             torch.full((8,), 511, dtype=torch.int32, device=dev))):
        q = randn(B, 1, K, G, h, dtype=torch.bfloat16)
        kc, vc = randn(B, L, K, h), randn(B, L, K, h)
        amask = _ring_mask(torch, idx, B, L, dev)
        live = int(amask.sum())                 # live rows of the batch
        q4 = q[:, 0]

        def library():
            return F.scaled_dot_product_attention(
                q4.float(), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=amask)

        # each live K/V row read once; q and o in bf16
        nbytes = 2 * live * K * h * 4 + 2 * 2 * B * K * G * h
        record(name,
               time_ms(lambda: flash_attn.flash_decode(q, kc, vc, idx)),
               time_ms(lambda: flash_attn.flash_decode_plain(q, kc, vc,
                                                              idx)),
               time_ms(library), nbytes, 4.0 * h * G * K * live,
               f"B{B}_L{L}_K{K}_G{G}_h{h}_idx{int(amask[0].sum()) - 1}",
               FP32_FLOPS, "bfloat16 q, float32 cache")


def _time_paged(torch, randn, record, time_ms):
    """Phase 4 for the paged decode kernels: one layer's decode step of
    the continuous path, Qwen3 at 8 slots with 512 tokens of context each,
    bf16 queries (the bf16 compute) over fp32 pools (the engine's cache
    dtype), over int8 pools and over bf16 pools (``@bf16_pools``).  Yardstick: the plain route's dataflow as
    library calls, the gather to a dense (B, NB * P, K, h) view (and the
    dequant for int8) plus F.scaled_dot_product_attention over it, the G
    query heads of each KV head as its query rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    ctx = CONT["max_len"]
    c = dict(B=CONT["slots"], K=8, G=2, h=128, P=CONT["page_size"],
             NB=ctx // CONT["page_size"], idx=[ctx - 1] * CONT["slots"],
             l_real=None, window=None)
    B, K, G, h, P, NB = (c[k] for k in ("B", "K", "G", "h", "P", "NB"))
    for name, pool_dt in (("flash_decode_paged", torch.float32),
                          ("flash_decode_paged_int8", torch.int8),
                          ("flash_decode_paged@bf16_pools", torch.bfloat16)):
        q, pk, pv, bt, idx, sc = _paged_inputs(torch, randn, c,
                                               torch.bfloat16, pool_dt)
        q4 = q[:, 0]
        pos = torch.arange(NB * P, device=q.device)
        amask = (pos[None, :] <= idx[:, None])[:, None, None, :]

        def library():
            b64 = bt.long()
            kd = pk[b64].reshape(B, NB * P, K, h)
            vd = pv[b64].reshape(B, NB * P, K, h)
            if sc:
                kd = kd.float() * sc["scales_k"][b64].reshape(
                    B, NB * P, K, 1)
                vd = vd.float() * sc["scales_v"][b64].reshape(
                    B, NB * P, K, 1)
            return F.scaled_dot_product_attention(
                q4.to(kd.dtype), kd.transpose(1, 2), vd.transpose(1, 2),
                attn_mask=amask)

        rows = B * ctx                  # live K/V rows, read once
        nbytes = (2 * rows * K * h * pk.element_size()
                  + (2 * rows * K * 4 if sc else 0)
                  + 2 * 2 * B * K * G * h + 4 * (B * NB + B))
        # scores and P.V, 2h operations each per key and query head; the
        # inputs' type: fp32 for fp32 pools (promoted), bf16 for int8 and
        # bf16 pools
        record(name,
               time_ms(lambda: flash_attn.flash_decode_paged(
                   q, pk, pv, bt, idx, **sc)),
               time_ms(lambda: flash_attn.flash_decode_paged_plain(
                   q, pk, pv, bt, idx, **sc)),
               time_ms(library), nbytes, 4.0 * h * G * K * rows,
               f"B{B}_ctx{ctx}_K{K}_G{G}_h{h}_P{P}",
               FP32_FLOPS if pool_dt == torch.float32 else BF16_FLOPS,
               "bfloat16 q, " + str(pool_dt)[6:] + " pools")
    # the kernel alone over each pool dtype at a short and the full context,
    # with the splits a slot takes there (of the grid's): a kernel that
    # waits on latency takes the same time over 4x fewer bytes
    for n in (64, ctx):
        c = dict(c, idx=[n - 1] * B)
        times = {}
        for pool_dt in (torch.float32, torch.bfloat16, torch.int8):
            q, pk, pv, bt, idx, sc = _paged_inputs(torch, randn, c,
                                                   torch.bfloat16, pool_dt)
            ms = time_ms(lambda: flash_attn.flash_decode_paged(
                q, pk, pv, bt, idx, **sc))
            span = flash_attn.PAGED_SPAN[pool_dt]
            times[str(pool_dt)[6:]] = (
                f"{ms:.4f}", -(-n // span),
                flash_attn.paged_splits(NB, P, None, span))
        log("time_pools", kernel="flash_decode_paged", context=n,
            **{f"ms_{k}": v[0] for k, v in times.items()},
            **{f"splits_{k}": f"{v[1]}/{v[2]}" for k, v in times.items()})


def _qweight(randn, shape, qdtype, scale=1.0):
    """(payload, scales) of a random weight at the init scale (times
    ``scale``), quantized per (block, out_row)."""
    from repro_torch import quant

    w = randn(*shape) * (scale / shape[-1] ** 0.5)
    return quant.quantize_dyad_weight(w, qdtype)


def _dequant(q, s, dtype):
    """The weight a payload stands for, in ``dtype`` (the yardsticks')."""
    return (q.float() * s[..., None]).to(dtype)


def _ff_q_args(randn, M, n, d_in, d_ff, d_out, act, dtype, qdtype):
    """dyad_ff_fused_q's arguments: the IT views of one (M, n * d_in)
    activation in ``dtype``, the up (and gate) payloads of weights x 4 (the
    scale the serving phases run at) and the down payloads, with scales."""
    x = randn(M, n * d_in, dtype=dtype)
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    ups = [_qweight(randn, (n, d_ff, d_in), qdtype, 4.0)
           for _ in range(4 if act == "swiglu" else 2)]
    downs = [_qweight(randn, (n, d_out, d_ff), qdtype) for _ in range(2)]
    gate = (dict(wg1=ups[2][0], wg2=ups[3][0], sg1=ups[2][1], sg2=ups[3][1])
            if act == "swiglu" else {})
    return ((x1, x2, ups[0][0], ups[1][0], downs[0][0], downs[1][0],
             ups[0][1], ups[1][1], downs[0][1], downs[1][1]), gate)


def _check_quant_kernels(torch, randn, check, failures, dt, max_err,
                         gate_f64):
    """Phase 3 for the quantized-weight kernels at x dtype ``dt``: int8 and
    fp8 payloads, dyad_mm_blocks_q and dyad_mm_blocks_two_q over the IT
    (stride-n x2) and OT views, dyad_ff_fused_q, each with a second call
    that must give the same bits (the split partials add in a fixed
    order); the GEMMs' fp32 x on the tensor cores also against their
    plain versions in float64 (``gate_f64``) where each output sums at
    least F64_MIN_TERMS products; at the decode rows (M <= 8) the route
    the plan does not pick through the C entries, since phase 4 times
    both there (fma_ms, tc_ms)."""
    from repro_torch.kernels import dyad_mm

    dn = str(dt).split(".")[1]
    bf16 = dt == torch.bfloat16
    sms = dyad_mm.sm_count(torch.device("cuda"))

    def note(name, err):
        if dt == torch.float32:
            max_err[name] = max(max_err[name], err)

    def repeat(label, got, again, **kw):
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log("check", case=f"{label}/bitwise_repeat", dtype=dn, **kw,
            ok=same)
        if not same:
            failures.append(f"{label}/bitwise_repeat")

    for qdt in ("int8", "fp8"):
        for label, (M, n, d_in, d_out) in QUANT_MM_CASES.items():
            x = randn(M, n * d_in, dtype=dt)
            x1 = x.reshape(M, n, d_in)
            (q1, s1), (q2, s2) = (_qweight(randn, (n, d_out, d_in), qdt)
                                  for _ in range(2))
            kernel, split, _ = dyad_mm.mm_q_plan(M, n, d_in, d_out, sms, dt)
            for xl, xb in (("it", x.reshape(M, d_in, n).transpose(1, 2)),
                           ("ot", x1)):
                args = (x1, xb, q1, q2, s1, s2)
                case = f"{label}/{xl}/{qdt}"
                got_q = dyad_mm.dyad_mm_blocks_q(*args)
                want_q = dyad_mm.dyad_mm_blocks_q_plain(*args)
                note("dyad_mm_blocks_q", check(
                    f"dyad_mm_blocks_q/{case}", got_q, want_q, dn))
                got = dyad_mm.dyad_mm_blocks_two_q(*args)
                want = dyad_mm.dyad_mm_blocks_two_q_plain(*args)
                for c in (0, 1):
                    note("dyad_mm_blocks_two_q", check(
                        f"dyad_mm_blocks_two_q/{case}/z{c + 1}", got[c],
                        want[c], dn))
                if not bf16 and kernel == "tc" and d_in >= F64_MIN_TERMS:
                    dargs = (x1.double(), xb.double(), q1, q2, s1, s2)
                    gate_f64("dyad_mm_blocks_q", case, got_q, want_q,
                             dyad_mm.dyad_mm_blocks_q_plain(*dargs))
                    exact = dyad_mm.dyad_mm_blocks_two_q_plain(*dargs)
                    for c in (0, 1):
                        gate_f64("dyad_mm_blocks_two_q", f"{case}/z{c + 1}",
                                 got[c], want[c], exact[c])
                repeat(f"dyad_mm_blocks_q/{case}", (got_q,),
                       (dyad_mm.dyad_mm_blocks_q(*args),), kernel=kernel,
                       split=split)
                repeat(f"dyad_mm_blocks_two_q/{case}", got,
                       dyad_mm.dyad_mm_blocks_two_q(*args), kernel=kernel,
                       split=split)
                if M <= dyad_mm._MV_ROWS:
                    other = "tc" if kernel == "fma" else "fma"
                    for two, name, ref in (
                            (False, "dyad_mm_blocks_q", (want_q,)),
                            (True, "dyad_mm_blocks_two_q", want)):
                        call, out = _mm_q_entry(args, two, other == "tc")
                        call()
                        for c, (a, b) in enumerate(zip(out, ref)):
                            check(f"{name}/{case}/{other}_kernel/z{c + 1}",
                                  a, b, dn)
        for label, (M, n, d_in, d_ff, d_out, act) in QUANT_FF_CASES.items():
            args, gate = _ff_q_args(randn, M, n, d_in, d_ff, d_out, act, dt,
                                    qdt)
            got = dyad_mm.dyad_ff_fused_q(*args, act=act, **gate)
            want = dyad_mm.dyad_ff_fused_q_plain(*args, act=act, **gate)
            for c in (0, 1):
                note("dyad_ff_fused_q", check(
                    f"dyad_ff_fused_q/{label}/{qdt}/z{c + 1}", got[c],
                    want[c], dn))
            kernel, split, _ = dyad_mm.ff_q_plan(M, n, d_in, d_ff, d_out, sms,
                                                 dt)
            repeat(f"dyad_ff_fused_q/{label}/{qdt}", got,
                   dyad_mm.dyad_ff_fused_q(*args, act=act, **gate),
                   kernel=kernel, split=split)
            if bf16 and label.startswith("qwen3"):
                call, out = _ff_q_fma_entry(args, gate, act)
                call()
                for c in (0, 1):
                    check(f"dyad_ff_fused_q/{label}/{qdt}/fma_kernel/"
                          f"z{c + 1}", out[c], want[c], dn)


def _time_quant(torch, randn, record, time_ms):
    """Phase 4 for the quantized-weight kernels, each at the shapes and
    with the payload of the path that launches it: dyad_mm_blocks_q at one
    OPT-125m layer's up + down (fp32 x, int8: phase 13a) at prefill and
    decode rows, and at Qwen3's split-route up (and gate) projection
    (bf16 x, fp8: phase 13c) at decode and prefill-chunk rows;
    dyad_mm_blocks_two_q at Qwen3's split-route down projection (bf16 x,
    fp8: phase 13c) at decode and prefill-chunk rows; dyad_ff_fused_q at
    one Qwen3 ff (bf16 x, int8: phase 13b) at decode, prefill-chunk and
    prefill rows.  Beside each GEMM record at decode rows (M <= 8) both
    routes through the C entry, the FMA decode kernel (fma_ms) and the
    tensor cores (tc_ms), and beside the ff's the FMA kernel (fma_ms).
    The fp32
    GEMM records on the tensor cores are bound at TWO_TF32_FLOPS (two
    TF32 products a pair), the FMA bound beside (fma_bound_ms).
    Yardstick: torch.bmm over the
    -CAT operands with the weights dequantized to x's dtype before the
    timing (library_ms), and the same with the dequantization timed too;
    for the ff, the quantized split route and both bmm chains.  Bounds:
    the inputs read once (one byte a payload, four a scale), the output
    written once, and the operations at the peak of x's type (the
    payloads counted as converted)."""
    from repro_torch.kernels import dyad_mm

    bf16, f32 = torch.bfloat16, torch.float32

    def mm(name, label, M, n, d_in, d_out, dt, qdt, two, x1, x2, **kw):
        (q1, s1), (q2, s2) = (_qweight(randn, (n, d_out, d_in), qdt)
                              for _ in range(2))
        args = (x1, x2, q1, q2, s1, s2)
        # one bmm over both components: their -CAT contraction for the
        # summed forward, the stacked blocks for the two outputs
        if two:
            xc = torch.cat([x1, x2], dim=1).transpose(0, 1).contiguous()
        else:
            xc = torch.cat([x1, x2], dim=-1).transpose(0, 1).contiguous()

        def wcat():
            dq = [_dequant(q1, s1, dt), _dequant(q2, s2, dt)]
            return torch.cat(dq, dim=0 if two else -1).transpose(1, 2)
        wc = wcat().contiguous()
        fn = (dyad_mm.dyad_mm_blocks_two_q if two
              else dyad_mm.dyad_mm_blocks_q)
        plain = (dyad_mm.dyad_mm_blocks_two_q_plain if two
                 else dyad_mm.dyad_mm_blocks_q_plain)
        es = x1.element_size()
        # both routes at the decode rows, whichever mm_q_plan picks
        if M <= dyad_mm._MV_ROWS:
            kw["fma_ms"] = time_ms(_mm_q_entry(args, two, False)[0])
            kw["tc_ms"] = time_ms(_mm_q_entry(args, two, True)[0])
        nbytes = (es * M * n * d_in + 2 * n * d_out * d_in + 4 * 2 * n * d_out
                  + es * (2 if two else 1) * M * n * d_out)
        flops = 4.0 * M * n * d_out * d_in
        rate = BF16_FLOPS
        if dt == f32:
            kernel = dyad_mm.mm_q_plan(M, n, d_in, d_out,
                                       dyad_mm.sm_count(x1.device), f32)[0]
            log("plan", kernel=name, shape=label, route=kernel)
            rate = TWO_TF32_FLOPS if kernel == "tc" else FP32_FLOPS
            kw["fma_bound_ms"] = _bound_ms(nbytes, flops, FP32_FLOPS)[0]
        record(name, time_ms(lambda: fn(*args)),
               time_ms(lambda: plain(*args)),
               time_ms(lambda: torch.bmm(xc, wc)), nbytes, flops, label, rate,
               f"{str(dt)[6:]} x, {qdt} payloads",
               dequant_bmm_ms=time_ms(lambda: torch.bmm(xc, wcat())), **kw)

    for label in ("opt_up_M1024", "opt_down_M1024", "opt_up_M8",
                  "opt_down_M8"):
        M, n, d_in, d_out = QUANT_MM_CASES[label]
        x = randn(M, n * d_in)
        mm("dyad_mm_blocks_q", label, M, n, d_in, d_out, f32, "int8", False,
           x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2))

    for label, M in (("qwen3_split_down_M8", 8),
                     ("qwen3_split_down_M128", 128)):
        _, n, d_in, d_out = QUANT_MM_CASES["qwen3_down_M8"]
        h = randn(M, n, d_in, dtype=bf16)
        mm("dyad_mm_blocks_two_q", label, M, n, d_in, d_out, bf16, "fp8",
           True, h, h)

    for label, M in (("qwen3_split_up_M8", 8),
                     ("qwen3_split_up_M128", 128)):
        _, n, d_in, d_out = QUANT_MM_CASES["qwen3_up_M8"]
        x = randn(M, n * d_in, dtype=bf16)
        log("plan", kernel="dyad_mm_blocks_q", shape=label,
            route=dyad_mm.mm_q_plan(M, n, d_in, d_out,
                                    dyad_mm.sm_count(x.device), bf16)[0])
        mm("dyad_mm_blocks_q@split_up", label, M, n, d_in, d_out, bf16,
           "fp8", False, x.reshape(M, n, d_in),
           x.reshape(M, d_in, n).transpose(1, 2))

    for label, suffix in (("qwen3_M8", ""), ("qwen3_M128", "@chunk"),
                          ("qwen3_M1024", "@prefill")):
        M, n, d_in, d_ff, d_out, act = QUANT_FF_CASES[label]
        args, gate = _ff_q_args(randn, M, n, d_in, d_ff, d_out, act, bf16,
                                "int8")
        x1, x2, wu1, wu2, wd1, wd2, su1, su2, sd1, sd2 = args
        wg1, wg2, sg1, sg2 = (gate[k] for k in ("wg1", "wg2", "sg1", "sg2"))

        def split():
            u = dyad_mm.dyad_mm_blocks_q(x1, x2, wu1, wu2, su1, su2)
            h = torch.nn.functional.silu(dyad_mm.dyad_mm_blocks_q(
                x1, x2, wg1, wg2, sg1, sg2)) * u
            return dyad_mm.dyad_mm_blocks_two_q(h, h, wd1, wd2, sd1, sd2)
        xc = torch.cat([x1, x2], dim=2).transpose(0, 1).contiguous()

        def weights():
            dq = [_dequant(q, s_, bf16) for q, s_ in
                  ((wu1, su1), (wu2, su2), (wg1, sg1), (wg2, sg2),
                   (wd1, sd1), (wd2, sd2))]
            return (torch.cat(dq[0:2], dim=2).transpose(1, 2),
                    torch.cat(dq[2:4], dim=2).transpose(1, 2),
                    torch.cat(dq[4:6], dim=1).transpose(1, 2))
        pre = [w.contiguous() for w in weights()]

        def chain(wuc, wgc, wdc):
            h = torch.nn.functional.silu(torch.bmm(xc, wgc)) * torch.bmm(
                xc, wuc)
            return torch.bmm(h, wdc)
        flops = 2.0 * M * n * (4 * d_ff * d_in + 2 * d_out * d_ff)
        nbytes = (2 * M * n * d_in + 4 * n * d_ff * d_in + 2 * n * d_out * d_ff
                  + 4 * (4 * n * d_ff + 2 * n * d_out) + 2 * 2 * M * n * d_out)
        record("dyad_ff_fused_q" + suffix,
               time_ms(lambda: dyad_mm.dyad_ff_fused_q(*args, act=act,
                                                       **gate)),
               time_ms(lambda: dyad_mm.dyad_ff_fused_q_plain(*args, act=act,
                                                             **gate)),
               None, nbytes, flops, label, BF16_FLOPS,
               "bfloat16 x, int8 payloads", split_route_ms=time_ms(split),
               bmm_chain_ms=time_ms(lambda: chain(*pre)),
               dequant_bmm_chain_ms=time_ms(lambda: chain(*weights())),
               fma_ms=time_ms(_ff_q_fma_entry(args, gate, act)[0]))


def _time_ff_fp32(torch, randn, record, time_ms):
    """Phase 4 for the fp32 routes of the ff megakernels (FMA), which the
    fp32 Qwen3 step (phase 11) and the fp32 quantized serving runs (phase
    13d-e) launch: dyad_ff_fused at one Qwen3 ff (fp32 x and params) and
    dyad_ff_fused_q (fp32 x, int8 payloads) at decode and prefill-chunk
    rows (records ``...@fp32_decode``, ``...@fp32_chunk``).  No single
    PyTorch call computes the ff: beside each, the torch.bmm chain over the
    -CAT operands (the weights dequantized before the timing for the
    quantized one); bounds at FP32_FLOPS."""
    from repro_torch.kernels import dyad_mm

    f32 = torch.float32
    for label, suffix in (("qwen3_M8", "@fp32_decode"),
                          ("qwen3_M128", "@fp32_chunk")):
        M, n, d_in, d_ff, d_out, act = QUANT_FF_CASES[label]
        args = _ff_args(randn, M, n, d_in, d_ff, d_out, act, f32, f32)
        qargs, gate = _ff_q_args(randn, M, n, d_in, d_ff, d_out, act, f32,
                                 "int8")
        x1, x2 = args[0], args[1]
        xc = torch.cat([x1, x2], dim=2).transpose(0, 1).contiguous()
        wu1, wu2, wd1, wd2, wg1, wg2 = args[2:]
        dq = {k: _dequant(q, s_, f32) for k, q, s_ in (
            ("u1", qargs[2], qargs[6]), ("u2", qargs[3], qargs[7]),
            ("d1", qargs[4], qargs[8]), ("d2", qargs[5], qargs[9]),
            ("g1", gate["wg1"], gate["sg1"]), ("g2", gate["wg2"],
                                               gate["sg2"]))}

        def cat(u1, u2, g1, g2, d1, d2):
            return (torch.cat([u1, u2], dim=2).transpose(1, 2).contiguous(),
                    torch.cat([g1, g2], dim=2).transpose(1, 2).contiguous(),
                    torch.cat([d1, d2], dim=1).transpose(1, 2).contiguous())

        def chain(wuc, wgc, wdc):
            h = torch.nn.functional.silu(torch.bmm(xc, wgc)) * torch.bmm(
                xc, wuc)
            return torch.bmm(h, wdc)
        fp = cat(wu1, wu2, wg1, wg2, wd1, wd2)
        qp = cat(*(dq[k] for k in ("u1", "u2", "g1", "g2", "d1", "d2")))
        flops = 2.0 * M * n * (4 * d_ff * d_in + 2 * d_out * d_ff)
        io = 4 * M * n * d_in + 4 * 2 * M * n * d_out
        record("dyad_ff_fused" + suffix,
               time_ms(lambda: dyad_mm.dyad_ff_fused(*args, act=act)),
               time_ms(lambda: dyad_mm.dyad_ff_fused_plain(*args, act=act)),
               None, io + 4 * (4 * n * d_ff * d_in + 2 * n * d_out * d_ff),
               flops, label, FP32_FLOPS, "float32",
               bmm_chain_ms=time_ms(lambda: chain(*fp)))
        record("dyad_ff_fused_q" + suffix,
               time_ms(lambda: dyad_mm.dyad_ff_fused_q(*qargs, act=act,
                                                       **gate)),
               time_ms(lambda: dyad_mm.dyad_ff_fused_q_plain(
                   *qargs, act=act, **gate)),
               None, io + 4 * n * d_ff * d_in + 2 * n * d_out * d_ff
               + 4 * (4 * n * d_ff + 2 * n * d_out), flops, label,
               FP32_FLOPS, "float32 x, int8 payloads",
               bmm_chain_ms=time_ms(lambda: chain(*qp)))


def _ff_args(randn, M, n, d_in, d_ff, d_out, act, dtype, wdtype):
    """dyad_ff_fused's arguments: the IT views of one (M, n * d_in)
    activation in ``dtype``, up (and gate) and down weights in ``wdtype``
    at the init scale."""
    x = randn(M, n * d_in, dtype=dtype)
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    n_up = 4 if act == "swiglu" else 2
    ups = [(randn(n, d_ff, d_in) / d_in ** 0.5).to(wdtype)
           for _ in range(n_up)]
    downs = [(randn(n, d_out, d_ff) / d_ff ** 0.5).to(wdtype)
             for _ in range(2)]
    gates = ups[2:] if act == "swiglu" else [None, None]
    return (x1, x2, ups[0], ups[1], downs[0], downs[1], *gates)


def _paged_inputs(torch, randn, c, q_dtype, pool_dtype, generator=None):
    """q (B, 1, K, G, h), pools of 1 + B * NB + 2 pages (two spare: the
    block tables are a random permutation, not the identity layout), the
    tables, idx, and for int8 pools the quantized pools and their scales;
    drawn from ``generator`` (default: ``randn``'s)."""
    from repro_torch import quant

    B, K, G, h, P, NB = (c[k] for k in ("B", "K", "G", "h", "P", "NB"))
    NP = 1 + B * NB + 2
    q = randn(B, 1, K, G, h, dtype=q_dtype, generator=generator)
    pk = randn(NP, P, K, h, generator=generator)
    pv = randn(NP, P, K, h, generator=generator)
    perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(
        NP))[:B * NB] + 1
    bt = perm.reshape(B, NB).to(torch.int32).to(q.device)
    idx = torch.tensor(c["idx"], dtype=torch.int32, device=q.device)
    if pool_dtype == torch.int8:
        (pk, sk), (pv, sv) = quant.quantize_kv_rows(pk), \
            quant.quantize_kv_rows(pv)
        return q, pk, pv, bt, idx, {"scales_k": sk, "scales_v": sv}
    return q, pk.to(pool_dtype), pv.to(pool_dtype), bt, idx, {}


def _dead_pages(bt, idx, n_pages: int, P: int):
    """Pages no slot may read: scratch page 0, every unreferenced page, and
    each slot's pages past the block of its write index."""
    live = set(bt.flatten().tolist())
    dead = [p for p in range(n_pages) if p not in live]
    for b, i in enumerate(idx.tolist()):
        dead += bt[b, i // P + 1:].tolist()
    return dead


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    t_run = time.perf_counter()
    # -- 1. the device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log("device", kind=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, dyad_mm, flash_attn

    # -- 2. the build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.ENTRIES:
        build.entry(name)
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        built=",".join(sorted(built)) or "none (cached)",
        dir=build.BUILD_DIR.relative_to(root))
    # the DYAD GEMMs', the ff megakernel's and the flash kernels' bf16
    # routes on the tensor cores (HGMMA is wgmma's SASS), their fp32 routes
    # on FMA but those of SPLIT_SOURCES (split TF32, HGMMA too; dyad_mm's
    # decode rows keep FMA)
    # each library's SASS, dumped once, all at a time (cuobjdump is one
    # process a library, some seconds each)
    names = ("dyad_mm", "dyad_mm_two", "dyad_dgrad", "dyad_dgrad_fused",
             "dyad_wgrad", "dyad_ff", "dyad_mm_q", "flash_prefill",
             "flash_bwd")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        dumps = dict(zip(names, pool.map(build.sass, names)))
    sass = {name: tuple(len(re.findall(op, dumps[name]))
                        for op in (r"\bHGMMA\.", r"\bFFMA\b"))
            for name in names}
    bad = [name for name, (hgmma, ffma) in sass.items()
           if not hgmma or not (ffma or name in SPLIT_SOURCES)]
    log("sass", **{name: f"HGMMA:{h},FFMA:{f}"
                   for name, (h, f) in sass.items()}, ok=not bad)
    if bad:
        log("sass", failed=",".join(bad))
        return 1
    # ptxas on the tensor-core flash forward and backward, the split-TF32
    # dgrad and wgrad GEMMs (by _SPLIT_FNS's keys), the tensor-core ff
    # megakernel (<1> gated, <0> not; bf16, int8 and fp8 weights) and the
    # quantized GEMMs (bf16 x and fp32 x, int8 and fp8): registers, no
    # spill, no wgmma serialised; and each ff and quantized instantiation's
    # HGMMA
    def split_tf32(mangled, _):
        return _split_key(mangled) if "tf32_kernel" in mangled else None
    for source, kernels, key in (
            ("flash_prefill", ("flash_fwd_tc_kernel",), _kernel_key),
            ("flash_bwd", ("flash_dkv_tc_kernel", "flash_dq_tc_kernel",
                           "flash_dkv_tf32_kernel", "flash_dq_tf32_kernel"),
             _kernel_key),
            ("dyad_dgrad", (), split_tf32),
            ("dyad_dgrad_fused", (), split_tf32),
            ("dyad_wgrad", (), split_tf32),
            ("dyad_ff", ("dyad_ff_tc_kernel",), _kernel_key),
            ("dyad_mm_q", ("dyad_mm_q_tc_kernel", "dyad_mm_q_tf32_kernel"),
             _kernel_key)):
        ptx = _ptxas((build.BUILD_DIR / f"{source}.log").read_text(),
                     kernels, key)
        spilled = [k for k, r in ptx.items()
                   if r["spill_stores"] or r["serialized"]] or (
            [] if ptx else ["no report"])
        log("ptxas", source=source, **{
            k: "regs:{regs},spill_stores:{spill_stores},spill_loads:"
               "{spill_loads},wgmma_serialized:{serialized}".format(**r)
            for k, r in ptx.items()}, ok=not spilled)
        if spilled:
            log("ptxas", failed=",".join(spilled))
            return 1
    if not _decode_occupancy(torch, build, flash_attn):
        return 1
    if not _sass_split(build, dumps):
        return 1
    per_fn = {}
    for source, kernel in (("dyad_ff", "dyad_ff_tc_kernel"),
                           ("dyad_mm_q", "dyad_mm_q_tc_kernel"),
                           ("dyad_mm_q", "dyad_mm_q_tf32_kernel")):
        per_fn.update(_sass_by_function(dumps[source], kernel))
    missing = [k for k, c in per_fn.items() if not c] or (
        [] if len(per_fn) == 10 else ["instantiations"])
    log("sass_tc", **{k: f"HGMMA:{c}" for k, c in per_fn.items()},
        ok=not missing)
    if missing:
        log("sass_tc", failed=",".join(missing))
        return 1

    # -- 3. each kernel against its plain version ----------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32, generator=None):
        g = gen if generator is None else generator
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # the inputs of checks added beside the first ones, so that those keep
    # their inputs
    aside = torch.Generator(device=dev).manual_seed(args.seed + 1)
    aside_fwd = torch.Generator(device=dev).manual_seed(args.seed + 2)
    aside_ff = torch.Generator(device=dev).manual_seed(args.seed + 3)
    aside_paged = torch.Generator(device=dev).manual_seed(args.seed + 4)
    aside_ring = torch.Generator(device=dev).manual_seed(args.seed + 5)
    aside_split = torch.Generator(device=dev).manual_seed(args.seed + 6)

    failures = []

    def check(label, got, want, dtype_name):
        ok, err, bound = _close(got, want, TOL[dtype_name])
        log("check", case=label, dtype=dtype_name, max_abs_err=f"{err:.3e}",
            tol=f"{bound:.3e}", ok=ok)
        if not ok:
            failures.append(label)
        return err

    D, FF, N = 768, 3072, 4
    dyad_cases = {
        # the training rows: B 8 x S 512
        "up_M4096": (4096, N, D // N, FF // N, "it"),
        "down_M4096": (4096, N, FF // N, D // N, "it"),
        "up_M1024": (1024, N, D // N, FF // N, "it"),
        "down_M1024": (1024, N, FF // N, D // N, "it"),
        "up_M8": (8, N, D // N, FF // N, "it"),
        "down_M8": (8, N, FF // N, D // N, "it"),
        "ragged_it": (64, 2, 129, 130, "it"),
        "ragged_ot": (64, 2, 129, 130, "ot"),
        "rows3_prime": (3, 3, 7, 5, "it"),       # the decode-row kernel
        "rows5_ragged_dt": (5, 2, 129, 130, "dt"),
        # Qwen3-0.6B's up (and gate) at the training rows, as the backward
        # recomputes them (bf16 in its step), and its down blocks
        "qwen3_up_M4096": (4096, N, 1024 // N, 3072 // N, "it"),
        "qwen3_down_M4096": (4096, N, 3072 // N, 1024 // N, "it"),
        # off the tensor-core tiles (bf16 past the decode rows: 128 x 128,
        # 64 deep): ragged rows and dims at n 2, 3 and 4 (at n 4 the
        # stride-n x2 loads 16-byte runs; odd d_in gathers every operand);
        # then (M, n, d_in, d_out, variant, pad, offset): x a view of
        # (M, n * d_in + pad) rows from column ``offset``, rows off a
        # multiple of 8 elements or a start off 16 bytes, so x is gathered
        "tc_M9": (9, N, 1024 // N, 3072 // N, "it"),
        "tc_ragged_n3_dt": (300, 3, 200, 130, "dt"),
        "tc_aligned_n4_it": (200, 4, 136, 72, "it"),
        "tc_n4_ot": (129, 4, 72, 136, "ot"),
        "tc_odd_din_n4_dt": (77, 4, 65, 33, "dt"),
        "tc_ldx_pad3_n4_it": (150, 4, 64, 96, "it", 3, 0),
        "tc_ldx_pad5_n2_ot": (150, 2, 40, 24, "ot", 5, 0),
        "tc_offset1_n4_dt": (100, 4, 64, 64, "dt", 8, 1),
    }
    max_err = {"dyad_mm_blocks": 0.0, "flash_prefill": 0.0,
               "flash_decode": 0.0, "dyad_mm_dgrad_two": 0.0,
               "dyad_mm_wgrad": 0.0, "flash_prefill_grads": 0.0,
               "dyad_mm_blocks_two": 0.0, "dyad_mm_dgrad": 0.0,
               "dyad_ff_fused": 0.0, "flash_decode_paged": 0.0,
               "flash_decode_paged_int8": 0.0, "dyad_mm_blocks_q": 0.0,
               "dyad_mm_blocks_two_q": 0.0, "dyad_ff_fused_q": 0.0}
    # the paged decode: Qwen3's decode step (8 slots, K 8, G 2, h 128, pages
    # of 16) with contexts of 1 to 512 tokens, and the edge cases of the
    # reference's tests: P not dividing l_real, a window, idx 0 on one page
    paged_cases = {
        "qwen3_decode": dict(B=8, K=8, G=2, h=128, P=16, NB=32,
                             idx=[0, 15, 16, 100, 255, 300, 480, 511],
                             l_real=None, window=None),
        "p_not_dividing": dict(B=3, K=2, G=2, h=64, P=8, NB=5,
                               idx=[5, 36, 20], l_real=37, window=None),
        "window": dict(B=1, K=2, G=2, h=64, P=4, NB=3, idx=[11], l_real=12,
                       window=5),
        "idx0_one_page": dict(B=2, K=2, G=4, h=64, P=16, NB=1, idx=[0, 7],
                              l_real=None, window=None),
        # head dims padded to the kernel's 32, 64 and 128: the smoke
        # configs' 16 (the launcher's paged smoke serve), 32 and 80
        "h16": dict(B=2, K=2, G=2, h=16, P=16, NB=3, idx=[0, 40],
                    l_real=None, window=None),
        "h32": dict(B=2, K=2, G=2, h=32, P=8, NB=4, idx=[31, 5],
                    l_real=None, window=None),
        "h80_window": dict(B=3, K=2, G=2, h=80, P=16, NB=4,
                           idx=[63, 10, 33], l_real=None, window=20),
        # the split edges of each span phase 4 times (64, 128 or 256
        # keys) at Qwen3's shape: idx at a split's last key and the next
        # split's first, a slot in one split beside one in every split (the
        # last key of NB * P); a window that empties a slot's leading
        # splits; drawn from aside_paged
        "split_edges": dict(B=8, K=8, G=2, h=128, P=16, NB=32,
                            idx=[0, 63, 64, 127, 128, 255, 256, 511],
                            l_real=None, window=None, aside=True),
        "window_leading_splits": dict(B=3, K=8, G=2, h=128, P=16, NB=32,
                                      idx=[300, 511, 100], l_real=None,
                                      window=40, aside=True),
    }
    # Qwen3-0.6B's ff: d 1024, d_ff 3072, n 4; blocks d_in 256, d_ff 768,
    # d_out 256
    QD, QFF = 1024, 3072
    # dyad_mm_blocks_two (x1 and both x2 views) and dyad_mm_dgrad (the OT
    # cotangent views): (M, n, d_in, d_out)
    two_cases = {
        "qwen3_split_down_M4096": (4096, N, QFF // N, QD // N),
        "opt_up_M4096": (4096, N, D // N, FF // N),
        "opt_down_M4096": (4096, N, FF // N, D // N),
        "ragged_M129": (129, 2, 13, 130),
        "prime": (7, 3, 5, 3),
        # off the tensor-core tiles (128 x 128, 64 deep): ragged rows and
        # dims on unaligned strides; 16-byte aligned strides, ragged copies
        # (at n 4 the stride-n views load 16-byte runs)
        "ragged_M300": (300, 3, 200, 130),
        "aligned_M200": (200, 2, 136, 72),
        "aligned_n4_M200": (200, 4, 136, 72),
    }
    # dyad_ff_fused: (M, n, d_in, d_ff, d_out, act); the Qwen3 cases at the
    # training, prefill, prefill-chunk and decode rows (all but the first
    # split the hidden), then ragged edges; the M 128 case draws its inputs
    # from aside_ff
    ff_cases = {
        "qwen3_M4096": (4096, N, QD // N, QFF // N, QD // N, "swiglu"),
        "qwen3_M1024": (1024, N, QD // N, QFF // N, QD // N, "swiglu"),
        "qwen3_M8": (8, N, QD // N, QFF // N, QD // N, "swiglu"),
        "ragged_gelu": (3, 2, 129, 130, 17, "gelu"),
        "ragged_relu_wide_out": (45, 3, 33, 200, 300, "relu"),
        "ragged_silu": (37, 2, 64, 100, 64, "silu"),
        "ragged_swiglu": (5, 2, 129, 130, 17, "swiglu"),
        "qwen3_M128": (128, N, QD // N, QFF // N, QD // N, "swiglu"),
    }
    # the backward kernels at the OPT-125m and Qwen3-0.6B training rows
    # (B 8 x S 512) and the edge cases, among them those off the
    # tensor-core tiles and a split row reduction: (M, n, d_in, d_out)
    bwd_cases = {
        "up_M4096": (4096, N, D // N, FF // N),
        "down_M4096": (4096, N, FF // N, D // N),
        "qwen3_up_M4096": (4096, N, QD // N, QFF // N),
        "qwen3_down_M4096": (4096, N, QFF // N, QD // N),
        "ragged_M129": (129, 2, 13, 130),
        "prime": (7, 3, 5, 3),
        "ragged_M300": (300, 3, 200, 130),
        "aligned_M200": (200, 2, 136, 72),
        "aligned_n4_M200": (200, 4, 136, 72),
        "split_M2048": (2048, 1, 64, 65),
    }
    # fp32 past the decode rows, every fp32 flash_prefill, and fp32
    # dyad_mm_blocks_two, dyad_mm_dgrad_two, dyad_mm_dgrad, dyad_mm_wgrad
    # and flash_prefill_grads on split TF32, and the quantized GEMMs' fp32
    # x on the tensor cores: each case also against float64 (F64_GATE),
    # the largest ratio here
    f64_ratio = {"dyad_mm_blocks": 0.0, "flash_prefill": 0.0,
                 "dyad_mm_dgrad_two": 0.0, "flash_prefill_grads": 0.0,
                 "dyad_mm_dgrad": 0.0, "dyad_mm_wgrad": 0.0,
                 "dyad_mm_blocks_two": 0.0, "dyad_mm_blocks_q": 0.0,
                 "dyad_mm_blocks_two_q": 0.0}

    def gate_f64(name, label, got, plain, exact):
        f64_ratio[name] = max(f64_ratio[name], _gate_f64(
            f"{name}/{label}", got, plain, exact, failures))
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for label, (M, n, d_in, d_out, var, *view) in dyad_cases.items():
            pad, off = view or (0, 0)
            x = randn(M, n * d_in + pad, dtype=dt)[:, off:off + n * d_in]
            k = 1.0 / (n * d_in) ** 0.5
            w1 = (randn(n, d_out, d_in) * k).to(dt)
            w2 = (randn(n, d_out, d_in) * k).to(dt)
            got = dyad_mm.dyad_mm_blocks(x, w1, w2, var)
            want = dyad_mm.dyad_mm_blocks_plain(x, w1, w2, var)
            err = check(f"dyad_mm_blocks/{label}", got, want, dn)
            if dt == torch.float32:
                max_err["dyad_mm_blocks"] = max(max_err["dyad_mm_blocks"],
                                                err)
            if dt == torch.float32 and M > 8:
                f64_ratio["dyad_mm_blocks"] = max(
                    f64_ratio["dyad_mm_blocks"], _gate_f64(
                        f"dyad_mm_blocks/{label}", got, want,
                        dyad_mm.dyad_mm_blocks_plain(
                            x.double(), w1.double(), w2.double(), var),
                        failures))
            if dt == torch.float32 and label in ("up_M4096",
                                                 "tc_ldx_pad3_n4_it"):
                dyad_mm.dyad_mm_blocks(x[:9], w1, w2, var)   # another shape
                _repeat_bitwise(torch, f"dyad_mm_blocks/{label}", (got,),
                                (dyad_mm.dyad_mm_blocks(x, w1, w2, var),),
                                failures)

        prefill_cases = {
            # the training attention of one layer: B 8, S = T = 512
            "train": dict(B=8, S=512, T=512, K=12, G=1, h=64, causal=True,
                          window=None, q_off=0, k_off=0),
            # the serving cache prefill: S = 128 prompt over the 160-slot cache
            "main": dict(B=8, S=128, T=160, K=12, G=1, h=64, causal=True,
                         window=None, q_off=0, k_off=0),
            # GQA, window, per-batch offsets; batch 3's queries (32..79)
            # sit before its first key (60): fully-masked rows
            "gqa_window_offsets": dict(
                B=4, S=48, T=80, K=3, G=2, h=64, causal=True, window=16,
                q_off=torch.tensor([0, 5, 17, 32], device=dev),
                k_off=torch.tensor([0, 0, 3, 60], device=dev)),
            "noncausal_h16": dict(B=2, S=37, T=37, K=2, G=2, h=16,
                                  causal=False, window=None, q_off=0,
                                  k_off=0),
            # Qwen3-0.6B: the training attention (K 8, G 2, h 128) and
            # the serving cache prefill
            "qwen3_train": dict(B=8, S=512, T=512, K=8, G=2, h=128,
                                causal=True, window=None, q_off=0, k_off=0),
            "qwen3_main": dict(B=8, S=128, T=160, K=8, G=2, h=128,
                               causal=True, window=None, q_off=0, k_off=0),
            # the tensor-core forward's edges (bf16): h 80 padded to 128,
            # and S < T with per-batch offsets and a window at h 128
            # (batch 2's first 20 queries sit before its first key)
            "h80_g2": dict(B=2, S=70, T=70, K=2, G=2, h=80, causal=True,
                           window=None, q_off=0, k_off=0, aside=True),
            "s_lt_t_offsets_window_h128": dict(
                B=3, S=40, T=100, K=2, G=2, h=128, causal=True, window=48,
                q_off=torch.tensor([60, 10, 0], device=dev),
                k_off=torch.tensor([0, 5, 20], device=dev), aside=True),
        }
        for label, c in prefill_cases.items():
            g = aside_fwd if c.get("aside") else None
            q = randn(c["B"], c["S"], c["K"], c["G"], c["h"], dtype=dt,
                      generator=g)
            kk = randn(c["B"], c["T"], c["K"], c["h"], dtype=dt, generator=g)
            vv = randn(c["B"], c["T"], c["K"], c["h"], dtype=dt, generator=g)
            kw = dict(causal=c["causal"], window=c["window"], save_lse=True)
            o, lse = flash_attn.flash_prefill(q, kk, vv, c["q_off"],
                                              c["k_off"], **kw)
            po, plse = flash_attn.flash_prefill_plain(q, kk, vv, c["q_off"],
                                                      c["k_off"], **kw)
            err = check(f"flash_prefill/{label}", o, po, dn)
            if dt == torch.float32:
                f64_ratio["flash_prefill"] = max(
                    f64_ratio["flash_prefill"], _gate_f64(
                        f"flash_prefill/{label}", o, po,
                        flash_attn.flash_prefill_plain(
                            q.double(), kk.double(), vv.double(),
                            c["q_off"], c["k_off"], causal=c["causal"],
                            window=c["window"])[0], failures))
            if dt == torch.float32 and label in ("train", "qwen3_main"):
                flash_attn.flash_prefill(q[:1], kk[:1], vv[:1])  # another
                _repeat_bitwise(torch, f"flash_prefill/{label}", (o, lse),
                                flash_attn.flash_prefill(
                                    q, kk, vv, c["q_off"], c["k_off"], **kw),
                                failures)
            if dt == torch.bfloat16 and label == "qwen3_train":
                # no atomics: the same bits again
                again = flash_attn.flash_prefill(q, kk, vv, c["q_off"],
                                                 c["k_off"], **kw)
                same = torch.equal(o, again[0]) and torch.equal(lse,
                                                                again[1])
                log("check", case=f"flash_prefill/{label}/bitwise_repeat",
                    dtype=dn, ok=same)
                if not same:
                    failures.append(f"flash_prefill/{label}/bitwise_repeat")
            # lse: rows with a valid key within tolerance; fully-masked rows
            # (lse = -1e30 + log 1e-30 = -1e30) the plain version's bits
            live = plse > -1e29
            check(f"flash_prefill/{label}/lse", lse[live], plse[live], dn)
            dead = int((~live).sum())
            dead_ok = (torch.equal(lse[~live], plse[~live])
                       and bool((o.float().abs().amax(dim=-1) == 0).sum()
                                >= dead))
            if label in ("gqa_window_offsets", "s_lt_t_offsets_window_h128"):
                dead_ok = dead_ok and dead > 0
            log("check", case=f"flash_prefill/{label}/fully_masked_rows",
                dtype=dn, rows=dead, ok=dead_ok)
            if not dead_ok:
                failures.append(f"flash_prefill/{label}/fully_masked_rows")
            if dt == torch.float32:
                max_err["flash_prefill"] = max(max_err["flash_prefill"], err)

        decode_cases = {
            "scalar_idx": dict(B=8, L=160, K=12, G=1, h=64, idx=143,
                               window=None),
            "vector_idx": dict(B=8, L=160, K=12, G=1, h=64,
                               idx=torch.tensor([0, 5, 77, 159, 130, 31, 32,
                                                 100], device=dev),
                               window=None),
            "wrapped_window": dict(B=4, L=64, K=3, G=2, h=64,
                                   idx=torch.tensor([70, 150, 64, 200],
                                                    device=dev), window=48),
            "qwen3": dict(B=8, L=160, K=8, G=2, h=128, idx=143, window=None),
            # the dense-ring continuous shape (512 slots a ring) past the
            # wrap, under a window; the head dims padded to the kernel's 32
            # and 128: the smoke configs' 16, and 80; drawn from aside_ring
            "qwen3_ring512_wrapped_window": dict(
                B=8, L=512, K=8, G=2, h=128,
                idx=torch.tensor([0, 127, 128, 511, 512, 700, 1030, 2000],
                                 device=dev), window=300, aside=True),
            "h16": dict(B=2, L=40, K=2, G=2, h=16,
                        idx=torch.tensor([0, 50], device=dev), window=None,
                        aside=True),
            "h80_window": dict(B=3, L=200, K=2, G=2, h=80,
                               idx=torch.tensor([199, 10, 300], device=dev),
                               window=20, aside=True),
        }
        for label, c in decode_cases.items():
            g = aside_ring if c.get("aside") else None
            q = randn(c["B"], 1, c["K"], c["G"], c["h"], dtype=dt,
                      generator=g)
            kk = randn(c["B"], c["L"], c["K"], c["h"], dtype=dt, generator=g)
            vv = randn(c["B"], c["L"], c["K"], c["h"], dtype=dt, generator=g)
            err = check(f"flash_decode/{label}",
                        flash_attn.flash_decode(q, kk, vv, c["idx"],
                                                window=c["window"]),
                        flash_attn.flash_decode_plain(q, kk, vv, c["idx"],
                                                      window=c["window"]), dn)
            if dt == torch.float32:
                max_err["flash_decode"] = max(max_err["flash_decode"], err)

        def note(name, err):
            if dt == torch.float32:
                max_err[name] = max(max_err[name], err)

        for label, (M, n, d_in, d_out) in bwd_cases.items():
            x = randn(M, n * d_in, dtype=dt)
            g = randn(M, n * d_out, dtype=dt)
            w1 = (randn(n, d_out, d_in) / d_out ** 0.5).to(dt)
            w2 = (randn(n, d_out, d_in) / d_out ** 0.5).to(dt)
            # the IT operands: x1, the stride-n x2, one cotangent view; and
            # a strided z2 (the DT cotangent layout)
            x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(
                1, 2)
            z, z2 = g.reshape(M, n, d_out), g.reshape(M, d_out, n).transpose(
                1, 2)
            for zl, zb in (("it", z), ("dt", z2)):
                got = dyad_mm.dyad_mm_dgrad_two(z, zb, w1, w2)
                want = dyad_mm.dyad_mm_dgrad_two_plain(z, zb, w1, w2)
                exact = (dyad_mm.dyad_mm_dgrad_two_plain(
                    z.double(), zb.double(), w1.double(), w2.double())
                    if dt == torch.float32 and d_out >= F64_MIN_TERMS
                    else None)
                for c in (0, 1):
                    note("dyad_mm_dgrad_two", check(
                        f"dyad_mm_dgrad_two/{label}/{zl}/dx{c + 1}", got[c],
                        want[c], dn))
                    if exact is not None:
                        gate_f64("dyad_mm_dgrad_two",
                                 f"{label}/{zl}/dx{c + 1}", got[c], want[c],
                                 exact[c])
                if dt == torch.float32 and label in ("up_M4096",
                                                     "down_M4096"):
                    dyad_mm.dyad_mm_dgrad_two(z[:9], zb[:9], w1, w2)
                    _repeat_bitwise(
                        torch, f"dyad_mm_dgrad_two/{label}/{zl}", got,
                        dyad_mm.dyad_mm_dgrad_two(z, zb, w1, w2), failures)
            # wgrad: the IT views (up, gate), and the OT down projection's
            # (one input for both components, the stride-n z2bar); fp32 (on
            # split TF32, either out dtype) against float64 too, with fp32
            # out, where each output sums M >= F64_MIN_TERMS products
            for wl, wargs in (("it", (x1, x2, z, z)), ("ot", (x1, x1, z, z2))):
                for out_dt in {dt, torch.float32}:
                    got = dyad_mm.dyad_mm_wgrad(*wargs, out_dtype=out_dt)
                    want = dyad_mm.dyad_mm_wgrad_plain(*wargs,
                                                       out_dtype=out_dt)
                    exact = (dyad_mm.dyad_mm_wgrad_plain(
                        *(t.double() for t in wargs))
                        if dt == out_dt == torch.float32
                        and M >= F64_MIN_TERMS else None)
                    for c in (0, 1):
                        tag = (f"{label}/{wl}/out_{str(out_dt)[6:]}/"
                               f"dw{c + 1}")
                        note("dyad_mm_wgrad", check(
                            f"dyad_mm_wgrad/{tag}", got[c], want[c], dn))
                        if exact is not None:
                            gate_f64("dyad_mm_wgrad", tag, got[c], want[c],
                                     exact[c])
                    if dt == torch.float32 and label in ("up_M4096",
                                                         "down_M4096"):
                        dyad_mm.dyad_mm_wgrad(*(t[:9] for t in wargs),
                                              out_dtype=out_dt)  # another
                        _repeat_bitwise(
                            torch, f"dyad_mm_wgrad/{label}/{wl}/out_"
                            f"{str(out_dt)[6:]}", got, dyad_mm.dyad_mm_wgrad(
                                *wargs, out_dtype=out_dt), failures)
                    # no atomics, partials added in a fixed order
                    again = dyad_mm.dyad_mm_wgrad(*wargs, out_dtype=out_dt)
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    log("check", case=f"dyad_mm_wgrad/{label}/{wl}/out_"
                        f"{str(out_dt)[6:]}/bitwise_repeat", dtype=dn,
                        split=dyad_mm.wgrad_split(
                            M, n, d_in, d_out, bf16=dt == torch.bfloat16)[0],
                        ok=same)
                    if not same:
                        failures.append(f"dyad_mm_wgrad/{label}/{wl}/"
                                        "bitwise_repeat")

        if dt == torch.bfloat16:
            _check_integer_tc(torch, gen, dyad_mm, dyad_cases, bwd_cases,
                              failures)
            _check_integer_ff_slice(
                torch, torch.Generator(device=dev).manual_seed(args.seed + 4),
                dyad_mm, two_cases, failures)
            _check_exact_quant(
                torch, torch.Generator(device=dev).manual_seed(args.seed + 5),
                dyad_mm, failures)

        grads_cases = {
            # the training attention of one layer: B 8, S 512, K 12, causal
            "main": dict(B=8, S=512, K=12, G=1, h=64, causal=True,
                         window=None, q_off=0, k_off=0),
            # GQA, window, per-batch offsets; batch 3's queries sit before
            # its first key: fully-masked rows, zero gradients
            "gqa_window_offsets": dict(
                B=4, S=48, K=3, G=2, h=64, causal=True, window=16,
                q_off=torch.tensor([0, 5, 17, 0], device=dev),
                k_off=torch.tensor([0, 0, 3, 60], device=dev)),
            "noncausal_h16": dict(B=2, S=37, K=2, G=2, h=16, causal=False,
                                  window=None, q_off=0, k_off=0),
            "ragged_h128": dict(B=2, S=45, K=1, G=4, h=128, causal=True,
                                window=None, q_off=3, k_off=3),
            "qwen3_train": dict(B=8, S=512, K=8, G=2, h=128, causal=True,
                                window=None, q_off=0, k_off=0),
            # (inputs from the aside generator) h 80, padded to 128 lanes;
            # S < T: the queries after a cached prefix of 60 keys
            "h80": dict(B=2, S=70, K=2, G=2, h=80, causal=True, window=None,
                        q_off=0, k_off=0, aside=True),
            "s_lt_t": dict(B=2, S=40, T=100, K=2, G=2, h=64, causal=True,
                           window=None, q_off=60, k_off=0, aside=True),
        }
        for label, c in grads_cases.items():
            T = c.get("T", c["S"])
            g = aside if c.get("aside") else None
            q = randn(c["B"], c["S"], c["K"], c["G"], c["h"], dtype=dt,
                      generator=g)
            kk = randn(c["B"], T, c["K"], c["h"], dtype=dt, generator=g)
            vv = randn(c["B"], T, c["K"], c["h"], dtype=dt, generator=g)
            do = randn(c["B"], c["S"], c["K"], c["G"], c["h"], dtype=dt,
                       generator=g)
            kw = dict(causal=c["causal"], window=c["window"])
            # each side's backward takes its own forward's o and lse, so a
            # wrong lse from the forward kernel shows here too
            o, lse = flash_attn.flash_prefill(q, kk, vv, c["q_off"],
                                              c["k_off"], save_lse=True, **kw)
            po, plse = flash_attn.flash_prefill_plain(
                q, kk, vv, c["q_off"], c["k_off"], save_lse=True, **kw)
            got = flash_attn.flash_prefill_grads(q, kk, vv, o, lse, do,
                                                 c["q_off"], c["k_off"], **kw)
            want = flash_attn.flash_prefill_grads_plain(
                q, kk, vv, po, plse, do, c["q_off"], c["k_off"], **kw)
            finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
            if not finite:
                failures.append(f"flash_prefill_grads/{label}/finite")
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                note("flash_prefill_grads", check(
                    f"flash_prefill_grads/{label}/{name}", a, b, dn))
            if dt == torch.float32:
                # against float64 on the kernel's own inputs (its forward's
                # o and lse), beside the plain fp32 version on them
                ins = (q, kk, vv, o, lse, do)
                plain = flash_attn.flash_prefill_grads_plain(
                    *ins, c["q_off"], c["k_off"], **kw)
                exact = flash_attn.flash_prefill_grads_plain(
                    *(t.double() for t in ins), c["q_off"], c["k_off"], **kw)
                for name, a, b, e in zip(("dq", "dk", "dv"), got, plain,
                                         exact):
                    gate_f64("flash_prefill_grads", f"{label}/{name}", a, b,
                             e)
                if label in ("main", "h80"):
                    flash_attn.flash_prefill_grads(
                        q[:1], kk[:1], vv[:1], o[:1], lse[:1], do[:1],
                        **kw)   # another shape between
                    _repeat_bitwise(
                        torch, f"flash_prefill_grads/{label}", got,
                        flash_attn.flash_prefill_grads(
                            q, kk, vv, o, lse, do, c["q_off"], c["k_off"],
                            **kw), failures)
            if dt == torch.bfloat16 and label == "qwen3_train":
                # no atomics: the same bits again
                again = flash_attn.flash_prefill_grads(
                    q, kk, vv, o, lse, do, c["q_off"], c["k_off"], **kw)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log("check", case=f"flash_prefill_grads/{label}/"
                    "bitwise_repeat", dtype=dn, ok=same)
                if not same:
                    failures.append(f"flash_prefill_grads/{label}/"
                                    "bitwise_repeat")
        if dt == torch.bfloat16:
            _check_exact_grads(torch, aside, flash_attn, failures)
            _check_exact_prefill(torch, aside_fwd, flash_attn, failures)

        if dt == torch.bfloat16:
            # bf16 queries against an fp32 cache (Qwen3's serving path):
            # the promoted product, as the plain versions compute it
            q = randn(8, 1, 8, 2, 128, dtype=dt)
            kk, vv = randn(8, 160, 8, 128), randn(8, 160, 8, 128)
            check("flash_decode/bf16_q_fp32_cache",
                  flash_attn.flash_decode(q, kk, vv, 143),
                  flash_attn.flash_decode_plain(q, kk, vv, 143), dn)
            # and fp32 queries over a bf16 cache, each in its own dtype in
            # the kernel (drawn from aside_ring)
            qf = randn(8, 1, 8, 2, 128, generator=aside_ring)
            kb = randn(8, 160, 8, 128, dtype=dt, generator=aside_ring)
            vb = randn(8, 160, 8, 128, dtype=dt, generator=aside_ring)
            check("flash_decode/fp32_q_bf16_cache",
                  flash_attn.flash_decode(qf, kb, vb, 143),
                  flash_attn.flash_decode_plain(qf, kb, vb, 143), dn)
            q = randn(8, 128, 8, 2, 128, dtype=dt)
            check("flash_prefill/bf16_q_fp32_cache",
                  flash_attn.flash_prefill(q, kk, vv)[0],
                  flash_attn.flash_prefill_plain(q, kk, vv)[0], dn)

        # the paged decode kernels: fp32/bf16 queries over fp32, bf16 and
        # int8 pools (int8: flash_decode_paged_int8); fp32 bounds where no
        # operand is bf16
        for pool_dt in (torch.float32, torch.bfloat16, torch.int8):
            pn = str(pool_dt).split(".")[1]
            name = ("flash_decode_paged_int8" if pool_dt == torch.int8
                    else "flash_decode_paged")
            exact = dt == torch.float32 and pool_dt != torch.bfloat16
            for label, c in paged_cases.items():
                q, pk, pv, bt, idx, sc = _paged_inputs(
                    torch, randn, c, dt, pool_dt,
                    aside_paged if c.get("aside") else None)
                kw = dict(l_real=c["l_real"], window=c["window"], **sc)
                err = check(f"{name}/{label}/pool_{pn}",
                            flash_attn.flash_decode_paged(q, pk, pv, bt, idx,
                                                          **kw),
                            flash_attn.flash_decode_paged_plain(
                                q, pk, pv, bt, idx, **kw),
                            "float32" if exact else "bfloat16")
                if exact:
                    max_err[name] = max(max_err[name], err)
            # scratch page 0, the unreferenced pages and the live pages past
            # each slot's write index poisoned: not one bit moves
            q, pk, pv, bt, idx, sc = _paged_inputs(
                torch, randn, paged_cases["qwen3_decode"], dt, pool_dt)
            clean = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **sc)
            dead = _dead_pages(bt, idx, pk.shape[0], pk.shape[1])
            for t in (pk, pv):
                t[dead] = 127 if pool_dt == torch.int8 else 1e30
            for t in sc.values():
                t[dead] = 1e30
            got = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **sc)
            same = (0 in dead and torch.equal(got, clean)
                    and bool(torch.isfinite(got.float()).all()))
            log("check", case=f"{name}/poisoned_scratch/pool_{pn}", dtype=dn,
                poisoned_pages=len(dead), ok=same)
            if not same:
                failures.append(f"{name}/poisoned_scratch/pool_{pn}")
            # each slot of the split edges alone gives its bits in the batch
            # of 8, and a second call the same bits (the counters reset)
            q, pk, pv, bt, idx, sc = _paged_inputs(
                torch, randn, paged_cases["split_edges"], dt, pool_dt,
                aside_paged)
            batch = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **sc)
            alone = all(torch.equal(flash_attn.flash_decode_paged(
                q[i:i + 1], pk, pv, bt[i:i + 1], idx[i:i + 1], **sc),
                batch[i:i + 1]) for i in range(q.shape[0]))
            again = torch.equal(
                flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **sc), batch)
            log("check", case=f"{name}/alone_vs_batch/pool_{pn}", dtype=dn,
                alone_bitwise=alone, repeat_bitwise=again, ok=alone and again)
            if not (alone and again):
                failures.append(f"{name}/alone_vs_batch/pool_{pn}")

        for label, (M, n, d_in, d_out) in two_cases.items():
            x = randn(M, n * d_in, dtype=dt)
            w1 = (randn(n, d_out, d_in) / d_in ** 0.5).to(dt)
            w2 = (randn(n, d_out, d_in) / d_in ** 0.5).to(dt)
            x1 = x.reshape(M, n, d_in)
            for xl, xb in (("ot", x1),
                           ("dt", x.reshape(M, d_in, n).transpose(1, 2))):
                got = dyad_mm.dyad_mm_blocks_two(x1, xb, w1, w2)
                want = dyad_mm.dyad_mm_blocks_two_plain(x1, xb, w1, w2)
                # fp32 on split TF32: each output sums d_in products
                exact = (dyad_mm.dyad_mm_blocks_two_plain(
                    x1.double(), xb.double(), w1.double(), w2.double())
                    if dt == torch.float32 and d_in >= F64_MIN_TERMS
                    else None)
                for c in (0, 1):
                    note("dyad_mm_blocks_two", check(
                        f"dyad_mm_blocks_two/{label}/{xl}/z{c + 1}", got[c],
                        want[c], dn))
                    if exact is not None:
                        gate_f64("dyad_mm_blocks_two", f"{label}/{xl}/z{c + 1}",
                                 got[c], want[c], exact[c])
                if dt == torch.float32 and label in ("opt_up_M4096",
                                                     "opt_down_M4096"):
                    dyad_mm.dyad_mm_blocks_two(x1[:9], xb[:9], w1, w2)
                    _repeat_bitwise(
                        torch, f"dyad_mm_blocks_two/{label}/{xl}", got,
                        dyad_mm.dyad_mm_blocks_two(x1, xb, w1, w2), failures)
            g = randn(M, n * d_out, dtype=dt)
            z1 = g.reshape(M, n, d_out)
            z2 = g.reshape(M, d_out, n).transpose(1, 2)
            got = dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2)
            want = dyad_mm.dyad_mm_dgrad_plain(z1, z2, w1, w2)
            note("dyad_mm_dgrad", check(f"dyad_mm_dgrad/{label}", got, want,
                                        dn))
            # fp32 on split TF32: each output sums both components' o
            if dt == torch.float32 and 2 * d_out >= F64_MIN_TERMS:
                gate_f64("dyad_mm_dgrad", label, got, want,
                         dyad_mm.dyad_mm_dgrad_plain(
                             z1.double(), z2.double(), w1.double(),
                             w2.double()))
            if dt == torch.float32 and label in ("opt_up_M4096",
                                                 "opt_down_M4096"):
                dyad_mm.dyad_mm_dgrad(z1[:9], z2[:9], w1, w2)   # another
                _repeat_bitwise(torch, f"dyad_mm_dgrad/{label}", (got,),
                                (dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2),),
                                failures)

        def randn_ff(*shape, dtype=torch.float32):
            return randn(*shape, dtype=dtype, generator=aside_ff)

        for label, (M, n, d_in, d_ff, d_out, act) in ff_cases.items():
            # the Qwen3 cases take what the main path gives the kernel: x
            # in the compute dtype, the fp32 params
            wdt = torch.float32 if label.startswith("qwen3") else dt
            ff_in = _ff_args(randn_ff if label == "qwen3_M128" else randn,
                             M, n, d_in, d_ff, d_out, act, dt, wdt)
            got = dyad_mm.dyad_ff_fused(*ff_in, act=act)
            want = dyad_mm.dyad_ff_fused_plain(*ff_in, act=act)
            for c in (0, 1):
                note("dyad_ff_fused", check(
                    f"dyad_ff_fused/{label}/z{c + 1}", got[c], want[c], dn))
            if dt == torch.bfloat16 and label.startswith("qwen3"):
                # the FMA kernel on bf16 x too, the parent's route that
                # phase 4 times beside (fma_ms)
                call, out = _ff_fma_entry(ff_in, act)
                call()
                for c in (0, 1):
                    check(f"dyad_ff_fused/{label}/fma_kernel/z{c + 1}",
                          out[c], want[c], dn)
            # the hidden split adds in a fixed order: the same bits again
            again = dyad_mm.dyad_ff_fused(*ff_in, act=act)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if wdt != dt:
                # fp32 weights rounded in the kernel = bf16 weights cast
                # before the call
                cast = [a if a is None or i < 2 else a.to(dt)
                        for i, a in enumerate(ff_in)]
                pre = dyad_mm.dyad_ff_fused(*cast, act=act)
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(got, pre))
            kernel, split, _ = dyad_mm.ff_plan(
                M, n, d_in, d_ff, d_out, dyad_mm.sm_count(dev), dt)
            log("check", case=f"dyad_ff_fused/{label}/bitwise_repeat",
                dtype=dn, kernel=kernel, split=split, ok=same)
            if not same:
                failures.append(f"dyad_ff_fused/{label}/bitwise_repeat")
        _check_quant_kernels(torch, randn, check, failures, dt, max_err,
                             gate_f64)
    _check_ring_decode(torch, aside_ring, flash_attn, failures, max_err)
    _check_prefill_views_fp32(torch, aside_split, flash_attn, check, failures)
    _check_split_precision(torch, aside_split, dyad_mm, flash_attn, failures)
    _check_families(torch, torch.Generator(device=dev).manual_seed(
        args.seed + 7), dyad_mm, flash_attn, check, max_err)
    log("check", split_tf32_f64_ratio_max=json.dumps(
        {k: round(v, 3) for k, v in f64_ratio.items()},
        separators=(",", ":")), gate=F64_GATE)
    torch.cuda.synchronize()
    if failures:
        log("check", failed=",".join(failures))
        return 1

    # -- 4. time each kernel at the main path's shapes (fp32) ----------------
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    time_ms = timer(torch, flush)
    f32 = 4
    timing = {}

    def record(name, ms, plain_ms, lib_ms, nbytes, flops, shape,
               rate=FP32_FLOPS, dtype="float32", **extra):
        """One timed shape of a kernel; ``lib_ms`` None where no single
        PyTorch call computes the function (``extra`` then holds the
        compositions timed instead)."""
        bound, by = _bound_ms(nbytes, flops, rate)
        t = timing.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "bytes": 0.0, "flops": 0.0,
                                     "shape": [], "rate": rate,
                                     "dtype": dtype})
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound),
                         ("bytes", nbytes), ("flops", flops)):
            t[key] = None if val is None or t[key] is None else t[key] + val
        for key, val in extra.items():
            t[key] = t.get(key, 0.0) + val
        t["shape"].append(shape)
        log("time", kernel=name, shape=shape, dtype=dtype, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}",
            library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by,
            **{k: f"{v:.4f}" for k, v in extra.items()})

    # dyad_mm_blocks: one layer's ff, up + down, at prefill and decode rows
    # (the kernels line); at the training rows under a name of its own.
    # Past the decode rows (split TF32) the bound is at SPLIT_TF32_FLOPS,
    # the FMA kernel's beside it (fma_bound_ms)
    for label in ("up_M1024", "down_M1024", "up_M8", "down_M8", "up_M4096",
                  "down_M4096"):
        M, n, d_in, d_out, var = dyad_cases[label]
        x = randn(M, n * d_in)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        x1 = x.reshape(M, n, d_in)
        x2 = x.reshape(M, d_in, n).transpose(1, 2)
        # the library yardstick: one torch.bmm over the -CAT operands
        xc = torch.cat([x1, x2], dim=-1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=-1).transpose(1, 2).contiguous()
        nbytes = f32 * (M * n * d_in + 2 * n * d_out * d_in + M * n * d_out)
        name = "dyad_mm_blocks" + ("@train" if M == 4096 else "")
        flops = 4.0 * M * n * d_out * d_in
        record(name, time_ms(lambda: dyad_mm.dyad_mm_blocks(x, w1, w2, var)),
               time_ms(lambda: dyad_mm.dyad_mm_blocks_plain(x, w1, w2, var)),
               time_ms(lambda: torch.bmm(xc, wc)), nbytes, flops, label,
               SPLIT_TF32_FLOPS if M > 8 else FP32_FLOPS,
               fma_bound_ms=_bound_ms(nbytes, flops, FP32_FLOPS)[0])

    # flash_prefill: one layer's training attention, under a name of its
    # own, with the lse the backward reads
    Bt, St, K, h = TRAIN["B"], TRAIN["S"], 12, 64
    q, kt, vt = (randn(Bt, St, K, 1, h), randn(Bt, St, K, h),
                 randn(Bt, St, K, h))
    qs, ks, vs = (q[:, :, :, 0].transpose(1, 2), kt.transpose(1, 2),
                  vt.transpose(1, 2))
    pairs = Bt * K * St * (St + 1) // 2
    nbytes = f32 * (4 * Bt * St * K * h + Bt * K * St)   # q, k, v, o; lse
    record("flash_prefill@train",
           time_ms(lambda: flash_attn.flash_prefill(q, kt, vt, save_lse=True)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, kt, vt,
                                                          save_lse=True)),
           time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                          is_causal=True)),
           nbytes, 4.0 * h * pairs, f"B{Bt}_S{St}_K{K}_h{h}_causal",
           SPLIT_TF32_FLOPS,
           fma_bound_ms=_bound_ms(nbytes, 4.0 * h * pairs, FP32_FLOPS)[0])

    # flash_prefill: the cache prefill of one layer (q_off = k_off = 0)
    B, S, new, K, h = SMOKE["B"], SMOKE["S"], SMOKE["new"], 12, 64
    L = S + new
    q = randn(B, S, K, 1, h)
    kc, vc = randn(B, L, K, h), randn(B, L, K, h)
    pairs = B * K * S * (S + 1) // 2            # causal (q, k) pairs in band
    nbytes = f32 * (2 * B * S * K * h + 2 * B * S * K * h)  # q, o, k/v rows
    qt, kt, vt = (q[:, :, :, 0].transpose(1, 2), kc.transpose(1, 2),
                  vc.transpose(1, 2))
    record("flash_prefill",
           time_ms(lambda: flash_attn.flash_prefill(q, kc, vc, 0, 0)),
           time_ms(lambda: flash_attn.flash_prefill_plain(q, kc, vc, 0, 0)),
           time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True)),
           nbytes, 4.0 * h * pairs, f"B{B}_S{S}_T{L}_K{K}_h{h}",
           SPLIT_TF32_FLOPS,
           fma_bound_ms=_bound_ms(nbytes, 4.0 * h * pairs, FP32_FLOPS)[0])
    _time_qwen3_fp32_cache(torch, randn, record, time_ms)

    # flash_decode: one decode step of one layer, mid-generation
    idx = S + new // 2 - 1
    q1 = randn(B, 1, K, 1, h)
    valid = idx + 1
    nbytes = f32 * (2 * B * K * h + 2 * B * valid * K * h)
    pos = torch.arange(L, device=dev)
    amask = (pos <= idx)[None, None, None, :]
    q1t = q1[:, 0].reshape(B, K, 1, h)
    record("flash_decode",
           time_ms(lambda: flash_attn.flash_decode(q1, kc, vc, idx)),
           time_ms(lambda: flash_attn.flash_decode_plain(q1, kc, vc, idx)),
           time_ms(lambda: F.scaled_dot_product_attention(
               q1t, kt, vt, attn_mask=amask)),
           nbytes, 4.0 * h * B * K * valid, f"B{B}_L{L}_K{K}_h{h}_idx{idx}")

    # dyad_mm_dgrad_two, dyad_mm_wgrad: one layer's ff backward, up + down,
    # at the training rows (the wgrad on the IT views).  Yardstick: one
    # torch.bmm over both components on contiguous operands.  Both run
    # split TF32: their bounds at SPLIT_TF32_FLOPS, the FMA kernel's beside
    # (fma_bound_ms)
    for label in ("up_M4096", "down_M4096"):
        M, n, d_in, d_out = bwd_cases[label]
        x, g = randn(M, n * d_in), randn(M, n * d_out)
        w1, w2 = randn(n, d_out, d_in), randn(n, d_out, d_in)
        x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
        z = g.reshape(M, n, d_out)
        flops = 4.0 * M * n * d_out * d_in
        zc = torch.cat([z, z], dim=1).transpose(0, 1).contiguous()
        wc = torch.cat([w1, w2], dim=0).contiguous()
        xc = torch.cat([x1, x2], dim=1).transpose(0, 1).contiguous()
        zt = zc.transpose(1, 2).contiguous()
        nbytes = f32 * (M * n * d_out + 2 * n * d_out * d_in
                        + 2 * M * n * d_in)
        record("dyad_mm_dgrad_two",
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_two(z, z, w1, w2)),
               time_ms(lambda: dyad_mm.dyad_mm_dgrad_two_plain(z, z, w1, w2)),
               time_ms(lambda: torch.bmm(zc, wc)), nbytes, flops, label,
               SPLIT_TF32_FLOPS,
               fma_bound_ms=_bound_ms(nbytes, flops, FP32_FLOPS)[0])
        nbytes = f32 * (M * n * d_in + M * n * d_out + 2 * n * d_out * d_in)
        record("dyad_mm_wgrad",
               time_ms(lambda: dyad_mm.dyad_mm_wgrad(x1, x2, z, z)),
               time_ms(lambda: dyad_mm.dyad_mm_wgrad_plain(x1, x2, z, z)),
               time_ms(lambda: torch.bmm(zt, xc)), nbytes, flops, label,
               SPLIT_TF32_FLOPS,
               fma_bound_ms=_bound_ms(nbytes, flops, FP32_FLOPS)[0])

    _time_qwen3_bwd(torch, randn, record, time_ms, bwd_cases)

    # flash_prefill_grads: one layer's attention backward at the training
    # shape, split TF32 (the FMA bound beside); delta_ms: the wrapper's
    # delta = rowsum(do * o) alone.  Yardstick: the backward of
    # F.scaled_dot_product_attention.
    Bt, St, K, h = TRAIN["B"], TRAIN["S"], 12, 64
    q, kt, vt, do = (randn(Bt, St, K, 1, h), randn(Bt, St, K, h),
                     randn(Bt, St, K, h), randn(Bt, St, K, 1, h))
    o, lse = flash_attn.flash_prefill(q, kt, vt, save_lse=True)
    sq, sk, sv = (t.reshape(Bt, St, K, h).transpose(1, 2).detach()
                  .requires_grad_() for t in (q, kt, vt))
    sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    sdo = do.reshape(Bt, St, K, h).transpose(1, 2)
    pairs = Bt * K * St * (St + 1) // 2
    # q, k, v, o, do read; dq, dk, dv written; lse
    nbytes = f32 * (8 * Bt * St * K * h + Bt * K * St)
    # recomputed scores, dp, dq, dk, dv: five 2h products per pair
    flops = 10.0 * h * pairs
    record("flash_prefill_grads",
           time_ms(lambda: flash_attn.flash_prefill_grads(q, kt, vt, o, lse,
                                                          do)),
           time_ms(lambda: flash_attn.flash_prefill_grads_plain(
               q, kt, vt, o, lse, do)),
           time_ms(lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                               retain_graph=True)),
           nbytes, flops, f"B{Bt}_S{St}_K{K}_h{h}_causal", SPLIT_TF32_FLOPS,
           delta_ms=time_ms(lambda: flash_attn._delta(o, do)),
           fma_bound_ms=_bound_ms(nbytes, flops, FP32_FLOPS)[0])
    _time_ff_slice(torch, randn, record, time_ms, two_cases, ff_cases)
    _time_ring(torch, randn, record, time_ms)
    _time_paged(torch, randn, record, time_ms)
    _time_quant(torch, randn, record, time_ms)
    _time_ff_fp32(torch, randn, record, time_ms)
    _time_qwen3_attn(torch, randn, record, time_ms)
    _time_families(torch, randn, record, time_ms)
    del flush, sout

    # -- 5. the OPT serving path ---------------------------------------------
    run = _Run(torch, dev, args.seed, _wrappers(dyad_mm, flash_attn))

    steps = new - 1
    serve_launches = run.serve("opt125m", "dyad_it_4_kernel", B, S, new,
                               {"dyad_mm_blocks": 2 * (1 + steps),
                                "flash_prefill": 1, "flash_decode": steps},
                               "main", "profile",
                               profile_check=_ring_decode_split(steps,
                                                                "profile"))
    if serve_launches is None:
        return 1

    # -- 7, 7b. the OPT training path ------------------------------------------
    train_launches = run.train("opt125m", "dyad_it_4_kernel", {
        "dyad_mm_blocks": 2, "dyad_mm_dgrad_two": 2, "dyad_mm_wgrad": 2,
        "flash_prefill": 1, "flash_prefill_grads": 1}, "train",
        profile_check=_opt_kernel_split)
    if train_launches is None:
        return 1

    # -- 7c. the OT and DT variants on the same path -------------------------
    # the forward of each ff projection is dyad_mm_blocks_two; its input
    # cotangent is dyad_mm_dgrad (OT: one accumulator) or dyad_mm_dgrad_two
    # (DT: the components apart, re-viewed); one OT step profiled
    variant_launches = {}
    for spec, dx, phase, prof in (
            ("dyad_ot_4_kernel", "dyad_mm_dgrad", "ot_train",
             _ot_kernel_split),
            ("dyad_dt_4_kernel", "dyad_mm_dgrad_two", "dt_train", None)):
        got = run.train("opt125m", spec, {
            "dyad_mm_blocks_two": 2, dx: 2, "dyad_mm_wgrad": 2,
            "flash_prefill": 1, "flash_prefill_grads": 1}, phase,
            compare=False, profile_check=prof)
        if got is None:
            return 1
        variant_launches[spec] = got

    # -- 8. a train step on the card against the CPU port --------------------
    tp = TRAIN_PARITY
    for arch in ("opt125m", "pythia160m"):
        if not run.train_parity(arch, "dyad_it_4_kernel", tp["B"], tp["S"],
                                n_layers=tp["layers"]):
            return 1

    # -- 9. the Qwen3-0.6B serving path -------------------------------------
    qserve = run.serve("qwen3_0_6b", QWEN_FF, B, S, new,
                       {"dyad_ff_fused": 1 + steps, "flash_prefill": 1,
                        "flash_decode": steps}, "qwen3_main",
                       "qwen3_profile",
                       profile_check=_ring_decode_split(steps,
                                                        "qwen3_profile"))
    if qserve is None:
        return 1

    # -- 10. the Qwen3-0.6B training path --------------------------------------
    # remat recomputes each block's forward once in the backward
    qtrain = run.train("qwen3_0_6b", QWEN_FF, {
        "dyad_ff_fused": 2, "dyad_mm_blocks": 2, "dyad_mm_dgrad": 1,
        "dyad_mm_wgrad": 3, "dyad_mm_dgrad_two": 2, "flash_prefill": 2,
        "flash_prefill_grads": 1}, "qwen3_train",
        profile_check=_qwen3_kernel_split)
    if qtrain is None:
        return 1

    # -- 11. Qwen3-0.6B and the OT/DT variants against the CPU port --------
    qp = QWEN_PARITY
    over = {"n_layers": qp["layers"], "compute_dtype": "float32"}
    if not (run.train_parity("qwen3_0_6b", QWEN_FF, qp["B"], qp["S"], **over)
            and run.train_parity("qwen3_0_6b", QWEN_FF, qp["B"],
                                 qp["S_bf16"], tol=(LOSS_TOL_BF16,
                                                    GRAD_TOL_BF16),
                                 fp32_control=True, n_layers=qp["layers"])
            and run.split_vs_fused(qp["B"], qp["S"], **over)
            and run.serve_parity("qwen3_0_6b", QWEN_FF, **over)):
        return 1
    for spec in ("dyad_ot_4_kernel", "dyad_dt_4_kernel"):
        if not run.train_parity("opt125m", spec, tp["B"], tp["S"],
                                n_layers=tp["layers"]):
            return 1

    # -- 12. the continuous engine on Qwen3-0.6B ----------------------------
    cont = run.continuous()
    if cont is None:
        return 1

    # -- 13. quantized serving -----------------------------------------------
    qopt = run.serve("opt125m", "dyad_it_4_kernel_w8", B, S, new,
                     {"dyad_mm_blocks_q": 2 * (1 + steps), "flash_prefill": 1,
                      "flash_decode": steps}, "quant_opt", "quant_opt_profile",
                     quant="int8", profile_check=_quant_opt_split(
                         B, S, steps, dyad_mm.sm_count(dev)))
    if qopt is None:
        return 1
    qcont = run.quant_continuous()
    if qcont is None:
        return 1

    # -- 14. spans, route events and seeded faults ----------------------------
    if not run.observe():
        return 1

    # -- 15. the moe, ssm and hybrid families --------------------------------
    fam = run.families()
    if fam is None:
        return 1

    # -- 16. the encdec and vlm families -------------------------------------
    modal = run.modal()
    if modal is None:
        return 1
    fam.update(modal)
    log("run", seconds=f"{time.perf_counter() - t_run:.1f}")

    # -- 17. the kernels line ------------------------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    files = {"dyad_mm_blocks": ("dyad_mm.cu", "dyad_mm.py:286"),
             "flash_prefill": ("flash_prefill.cu", "flash_attn.py:288"),
             "flash_decode": ("flash_decode.cu", "flash_attn.py:670"),
             "dyad_mm_dgrad_two": ("dyad_dgrad.cu", "dyad_mm.py:472"),
             "dyad_mm_wgrad": ("dyad_wgrad.cu", "dyad_mm.py:560"),
             "flash_prefill_grads": ("flash_bwd.cu", "flash_attn.py:531"),
             "dyad_mm_blocks_two": ("dyad_mm_two.cu", "dyad_mm.py:261"),
             "dyad_mm_dgrad": ("dyad_dgrad_fused.cu", "dyad_mm.py:443"),
             "dyad_ff_fused": ("dyad_ff.cu", "dyad_mm.py:812"),
             "flash_decode_paged": ("flash_decode_paged.cu",
                                    "flash_attn.py:920"),
             "flash_decode_paged_int8": ("flash_decode_paged.cu",
                                         "flash_attn.py:886"),
             "dyad_mm_blocks_q": ("dyad_mm_q.cu", "dyad_mm.py:991"),
             "dyad_mm_blocks_two_q": ("dyad_mm_q.cu", "dyad_mm.py:1020"),
             "dyad_ff_fused_q": ("dyad_ff.cu", "dyad_mm.py:1179")}
    # each kernel's launches come from the path that brought it in: OPT
    # serving for slice 1's, OPT training for slice 2's backward kernels,
    # the Qwen3 train step for the megakernel and dyad_mm_dgrad, the OPT
    # OT train step for dyad_mm_blocks_two, the continuous engine's paged
    # run (fp32 pools) and its int8 run for the paged decode kernels, the
    # quantized OPT generate, the quantized Qwen3 continuous run and its
    # split route for the quantized kernels; the ring decode's Qwen3 shapes
    # from the Qwen3 generate and the dense-ring continuous run; every
    # path's counts were checked exactly where it ran
    ot_train = variant_launches["dyad_ot_4_kernel"]
    main_path = {"dyad_mm_dgrad_two": train_launches,
                 "dyad_mm_wgrad": train_launches,
                 "flash_prefill_grads": train_launches,
                 "dyad_ff_fused": qtrain, "dyad_mm_dgrad": qtrain,
                 "dyad_mm_dgrad@opt_ot": ot_train,
                 "dyad_mm_blocks_two": ot_train,
                 "dyad_mm_blocks_two@opt_dt":
                     variant_launches["dyad_dt_4_kernel"],
                 "flash_decode@qwen3_batch": qserve,
                 "flash_prefill@qwen3_fp32_cache": qserve,
                 "flash_decode@ring512": cont["dense"],
                 "flash_decode_paged": cont["paged"],
                 "flash_decode_paged_int8": cont["int8"],
                 "dyad_mm_blocks_q": qopt,
                 "dyad_mm_blocks_q@split_up": qcont["split"],
                 "dyad_ff_fused_q": qcont["continuous"],
                 "dyad_mm_blocks_two_q": qcont["split"],
                 "dyad_mm_blocks@mamba2": fam["mamba2_780m_batch"],
                 "dyad_mm_blocks@hymba": fam["hymba_1_5b_batch"],
                 "dyad_ff_fused@hymba": fam["hymba_1_5b_batch"],
                 "dyad_ff_fused@moe_shared": fam["qwen2_moe_a2_7b_batch"],
                 "flash_prefill@hymba_window": fam["hymba_1_5b_batch"],
                 "flash_decode@hymba_ring": fam["hymba_1_5b_batch"],
                 "dyad_mm_blocks@whisper": fam["whisper_medium_batch"],
                 "flash_prefill@whisper_enc": fam["whisper_medium_batch"],
                 "dyad_ff_fused@phi3v": fam["phi3_vision_4_2b_batch"],
                 "flash_prefill@phi3v_patches":
                     fam["phi3_vision_4_2b_forward"],
                 "flash_decode@phi3v_ring": fam["phi3_vision_4_2b_batch"]}
    line = []
    # every timed record, under its kernel's name or a shape's
    # (``name@shape``); a record at OPT's training rows counts the OPT
    # train step, one at Qwen3's the Qwen3 train step
    for name, tm in timing.items():
        base, _, at = name.partition("@")
        src, replaces = files[base]
        path = main_path.get(name) or (
            train_launches if at == "train" else qtrain
            if at.startswith("qwen3") else
            main_path.get(base, serve_launches))
        _, by = _bound_ms(tm["bytes"], tm["flops"], tm["rate"])
        entry = {
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": path[base],
            "launches_serve": serve_launches[base],
            "launches_train_step": train_launches[base],
            "launches_qwen3_serve": qserve[base],
            "launches_qwen3_train_step": qtrain[base],
            "launches_ot_train_step": ot_train[base],
            "launches_dt_train_step":
                variant_launches["dyad_dt_4_kernel"][base],
            "launches_qwen3_continuous": cont["paged"][base],
            "launches_qwen3_continuous_int8": cont["int8"][base],
            "launches_qwen3_continuous_dense": cont["dense"][base],
            "launches_opt_quant_serve": qopt[base],
            "launches_qwen3_quant_continuous": qcont["continuous"][base],
            "launches_qwen3_quant_split_2_layers": qcont["split"][base],
            **{f"launches_{run_name}": counts[base]
               for run_name, counts in fam.items()},
            "max_abs_err": max_err[base], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": by, "library_ms": tm["library_ms"],
            "shape": "+".join(tm["shape"]), "dtype": tm["dtype"]}
        for key in ("split_route_ms", "bmm_chain_ms", "dequant_bmm_ms",
                    "dequant_bmm_chain_ms", "copied_views_ms",
                    "contiguous_out_ms", "delta_ms", "fma_ms", "tc_ms",
                    "fma_bound_ms"):
            if key in tm:
                entry[key] = tm[key]
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _wrappers(dyad_mm, flash_attn) -> dict:
    """Every kernel wrapper with a launch counter, by kernel name."""
    return {"dyad_mm_blocks": dyad_mm.dyad_mm_blocks,
            "flash_prefill": flash_attn.flash_prefill,
            "flash_decode": flash_attn.flash_decode,
            "dyad_mm_dgrad_two": dyad_mm.dyad_mm_dgrad_two,
            "dyad_mm_wgrad": dyad_mm.dyad_mm_wgrad,
            "flash_prefill_grads": flash_attn.flash_prefill_grads,
            "dyad_mm_blocks_two": dyad_mm.dyad_mm_blocks_two,
            "dyad_mm_dgrad": dyad_mm.dyad_mm_dgrad,
            "dyad_ff_fused": dyad_mm.dyad_ff_fused,
            "flash_decode_paged": flash_attn.flash_decode_paged,
            "flash_decode_paged_int8": flash_attn.flash_decode_paged_int8,
            "dyad_mm_blocks_q": dyad_mm.dyad_mm_blocks_q,
            "dyad_mm_blocks_two_q": dyad_mm.dyad_mm_blocks_two_q,
            "dyad_ff_fused_q": dyad_mm.dyad_ff_fused_q}


class _Run:
    """The main-path phases: serving and training runs with the launch
    counters read around them, and the card-vs-CPU comparisons."""

    def __init__(self, torch, dev, seed, wrappers):
        self.torch, self.dev, self.seed = torch, dev, seed
        self.wrappers = wrappers
        self.cpu = torch.device("cpu")
        # read by phase 14: the timed steps' medians by (arch, linear), the
        # profiled device-busy ms by phase, the continuous path's tokens
        self.step_ms, self.busy_ms = {}, {}
        self.cont_tokens = None

    def zero_counts(self):
        for w in self.wrappers.values():
            w.launches = 0

    def counts(self):
        return {name: w.launches for name, w in self.wrappers.items()}

    def want(self, per_layer, n_layers):
        want = dict.fromkeys(self.wrappers, 0)
        want.update({k: v * n_layers for k, v in per_layer.items()})
        return want

    def serve(self, arch, spec, B, S, new, per_layer, phase, prof_phase,
              quant=None, profile_check=None):
        """Engine.generate at full width, counted; then one profiled
        generate and the card against the CPU port.  ``quant``: the
        weights' sidecars are added (``quant.quantize_params``) before the
        engine is built.  ``profile_check(per_kernel, n_layers)`` holds the
        profile's launches by kernel name to account; a profile that fails
        it is taken again (the profiler drops a few records in some runs),
        up to PROFILE_TRIES times.  Returns the launch counts, None on a
        failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import configs
        from repro_torch import quant as quant_lib
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, dev = self.torch, self.dev
        cfg = configs.get(arch, linear=configs.linear_cfg(spec))
        pgen = torch.Generator(device=dev).manual_seed(self.seed)
        params = model.init_params(cfg, pgen, dev)
        if quant:
            params = quant_lib.quantize_params(params, quant)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=pgen,
                                device=dev)
        engine = Engine(cfg, params, max_len=S + new, device=dev)
        engine.generate(prompts, new)                     # warm-up
        self.zero_counts()
        toks = engine.generate(prompts, new)
        launches = self.counts()
        want = self.want(per_layer, cfg.n_layers)
        t = engine.timings
        steps = new - 1
        shape_ok = (tuple(toks.shape) == (B, new) and int(toks.min()) >= 0
                    and int(toks.max()) < cfg.vocab_size)
        log(phase, arch=cfg.name, linear=spec, dtype=cfg.compute_dtype,
            quant_weights=quant, batch=B, prompt=S, new=new,
            prefill_s=f"{t['prefill_s']:.4f}",
            decode_s=f"{t['decode_s']:.4f}",
            decode_tok_s=f"{B * steps / t['decode_s']:.1f}",
            tok_s=f"{B * new / (t['prefill_s'] + t['decode_s']):.1f}",
            launches=json.dumps(launches, separators=(",", ":")),
            tokens_ok=shape_ok)
        if launches != want or not shape_ok:
            log(phase, failed=f"launches {launches} want {want}")
            return None
        if quant:
            # the same weights on the fp route (no quant in the config),
            # in turns with the quantized route: fp, quant, quant, fp, twice
            fp = Engine(cfg.replace(linear=cfg.linear.replace(quant=None)),
                        params, max_len=S + new, device=dev)
            fp.generate(prompts, new)
            decode = {"fp": [], "quant": []}
            for name in ("fp", "quant", "quant", "fp") * 2:
                eng = fp if name == "fp" else engine
                eng.generate(prompts, new)
                decode[name].append(eng.timings["decode_s"])
            med = {k: statistics.median(v) for k, v in decode.items()}
            log(phase + "_vs_fp", decode_s_fp=",".join(
                f"{v:.4f}" for v in decode["fp"]), decode_s_quant=",".join(
                f"{v:.4f}" for v in decode["quant"]),
                quant_over_fp_decode_s=f"{med['quant'] / med['fp']:.3f}",
                note="printed, not gated")
            del fp
        for attempt in range(1, PROFILE_TRIES + 1):
            # device activity only: the host's some 80,000 op records
            # would take a minute to sort, and the busy time reads none
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                engine.generate(prompts, new)
                time.sleep(PROFILE_MARGIN_S)
            per_kernel = _log_profile(
                prof, (t["prefill_s"] + t["decode_s"]) * 1e3, prof_phase)
            if profile_check is None or profile_check(per_kernel,
                                                      cfg.n_layers):
                break
        else:
            log(prof_phase, failed=f"each of {PROFILE_TRIES} profiles fell "
                "short of the counted launches")
            return None
        if arch == "opt125m" and not self.serve_parity(
                arch, spec, params=params, prompts=prompts):
            return None
        del engine, params
        torch.cuda.empty_cache()
        return launches

    def serve_parity(self, arch, spec, params=None, prompts=None, **over):
        """Prefill logits and greedy tokens on the card against the CPU
        port, at PARITY's batch, on the same weights."""
        from repro_torch import configs
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, dev, cpu = self.torch, self.dev, self.cpu
        pb, ps, pn = PARITY["B"], PARITY["S"], PARITY["new"]
        cfg = configs.get(arch, linear=configs.linear_cfg(spec), **over)
        if params is None:
            pgen = torch.Generator(device=dev).manual_seed(self.seed)
            params = model.init_params(cfg, pgen, dev)
            prompts = torch.randint(0, cfg.vocab_size, (pb, ps),
                                    generator=pgen, device=dev)
        params_cpu = _tree_to(params, cpu)
        pprompts = prompts[:pb, :ps]
        with torch.no_grad():
            gl, _ = model.prefill(cfg, params, model.init_cache(
                cfg, pb, ps + pn, torch.float32, dev), pprompts,
                last_only=False)
            cl, _ = model.prefill(cfg, params_cpu, model.init_cache(
                cfg, pb, ps + pn, torch.float32, cpu), pprompts.cpu(),
                last_only=False)
        finite = bool(torch.isfinite(gl).all())
        ok, err, bound = _close(gl.cpu(), cl, LOGIT_TOL)
        gt = Engine(cfg, params, max_len=ps + pn, device=dev).generate(
            pprompts, pn).cpu()
        ct = Engine(cfg, params_cpu, max_len=ps + pn, device=cpu).generate(
            pprompts.cpu(), pn)
        same = bool((gt == ct).all())
        margin = None
        if not same:
            step = int((gt != ct).any(dim=0).nonzero()[0])
            margin = _top2_margin(model, cfg, params_cpu, pprompts.cpu(), ct,
                                  step, ps + pn)
        tie_ok = same or (margin is not None and margin < bound)
        log("parity", arch=cfg.name, linear=spec, dtype=cfg.compute_dtype,
            layers=cfg.n_layers, batch=pb, prompt=ps, new=pn,
            logits_max_abs_err=f"{err:.3e}", tol=f"{bound:.3e}",
            finite=finite, tokens_equal=same, top2_margin=margin,
            ok=ok and finite and tie_ok)
        return ok and finite and tie_ok

    def train(self, arch, spec, per_layer, phase, compare=True,
              profile_check=None):
        """The train launcher's trainer at full width, B x S of TRAIN: 2
        warm-up steps, one counted step, 5 timed; with ``compare``, the
        same with dense; with ``compare`` or ``profile_check``, one profiled
        step of each run, whose kernel table ``profile_check(per_kernel,
        n_layers)`` may hold to account.
        Returns the launch counts of the counted step, None on a
        failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import configs
        from repro_torch.launch.train import build_trainer

        torch = self.torch
        n_layers = configs.get(arch).n_layers
        step_s, launches = {}, None
        for lin in (spec, "dense") if compare else (spec,):
            tcfg, trainer = build_trainer(
                arch, linear=lin, steps=100, seq_len=TRAIN["S"],
                batch=TRAIN["B"], seed=self.seed, device=self.dev,
                log_fn=lambda *a: None)
            losses = []

            def traced(state, batch, inner=trainer.train_step):
                state, m = inner(state, batch)
                losses.append(m["loss"])
                return state, m

            trainer.train_step = traced
            w0, nt = TRAIN["warmup"], TRAIN["timed"]
            trainer.run(w0)
            self.zero_counts()
            trainer.run(w0 + 1)                 # one step, counted
            got = self.counts()
            stop_smi = _smi_sampler()
            try:
                t_loop = time.perf_counter()
                trainer.run(w0 + 1 + nt)
                loop_s = (time.perf_counter() - t_loop) / nt
            finally:
                sm_mhz, power_w = stop_smi()
            times = trainer.metrics.histogram("step_time_s").samples[-nt:]
            data_s = statistics.median(
                trainer.metrics.histogram("data_time_s").samples[-nt:])
            step_s[lin] = statistics.median(times)
            self.step_ms[(arch, lin)] = step_s[lin] * 1e3
            loss_vals = [float(v) for v in losses]
            finite = all(math.isfinite(v) for v in loss_vals)
            # dense: the flash kernels only, once per layer forward (twice
            # under remat) and once backward
            want = self.want(per_layer if lin == spec else {
                "flash_prefill": per_layer["flash_prefill"],
                "flash_prefill_grads": 1}, n_layers)
            tokens = TRAIN["B"] * TRAIN["S"]
            log(phase, arch=tcfg.name, linear=lin, batch=TRAIN["B"],
                seq=TRAIN["S"], dtype=tcfg.compute_dtype, remat=tcfg.remat,
                step_ms_median=f"{step_s[lin] * 1e3:.3f}",
                step_ms_all=",".join(f"{t * 1e3:.3f}" for t in times),
                tok_s=f"{tokens / step_s[lin]:.1f}",
                data_ms_median=f"{data_s * 1e3:.3f}",
                loop_ms_per_step=f"{loop_s * 1e3:.3f}",
                loop_tok_s=f"{tokens / loop_s:.1f}",
                sm_mhz_min_med_max=sm_mhz, power_w_min_med_max=power_w,
                peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                losses=",".join(f"{v:.4f}" for v in loss_vals),
                launches_per_step=json.dumps(got, separators=(",", ":")),
                finite=finite)
            if got != want or not finite:
                log(phase, failed=f"launches {got} want {want}, "
                    f"finite {finite}")
                return None
            if lin == spec:
                launches = got
            if compare or profile_check:
                # one profiled step each: the busy time beside the wall
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    trainer.run(trainer.step + 1)
                per_kernel = _log_profile(
                    prof, step_s[lin] * 1e3,
                    phase + ("_profile" if lin == spec else
                             "_dense_profile"))
                self.busy_ms[(arch, lin)] = sum(
                    ms for ms, _ in per_kernel.values())
                if (lin == spec and profile_check
                        and not profile_check(per_kernel, n_layers)):
                    return None
            del trainer, losses
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if compare:
            log(phase, dyad_over_dense_step_time=
                f"{step_s[spec] / step_s['dense']:.3f}",
                note="printed, not claimed")
        return launches

    def _step_inputs(self, arch, spec, B, S, **over):
        from repro_torch import configs
        from repro_torch.data import SyntheticLM
        from repro_torch.models import model

        pcfg = configs.get(arch, linear=configs.linear_cfg(spec), **over)
        p_dev = model.init_params(
            pcfg, self.torch.Generator(device=self.dev).manual_seed(
                self.seed), self.dev)
        batch = SyntheticLM(pcfg.vocab_size, S, B, seed=self.seed,
                            device=str(self.dev)).batch(0)
        return pcfg, p_dev, batch

    def train_parity(self, arch, spec, B, S, tol=(LOSS_TOL, GRAD_TOL),
                     fp32_control=False, **over):
        """One train step's loss and grads on the card against the CPU
        port on the same params and batch, and on the card the kernel
        backward against the forced plain backward.  With
        ``fp32_control``, also prints (not gated) the card's step against
        the CPU's step in fp32 compute.  Returns the launch counts of the
        card's step (a true dict), or {} on a failure."""
        from repro_torch import configs
        from repro_torch.train.step import loss_and_grads

        pcfg, p_dev, batch = self._step_inputs(arch, spec, B, S, **over)
        p_cpu = _tree_to(p_dev, self.cpu)
        b_cpu = _tree_to(batch, self.cpu)
        u_dev, u_cpu = [], []   # the ff ReLU's pre-activations, by call
        self.zero_counts()
        with relu_branch(record=u_dev):
            m_dev, g_dev = loss_and_grads(pcfg, p_dev, batch)
        launches = self.counts()
        with relu_branch(record=u_cpu):
            m_cpu, g_cpu = loss_and_grads(pcfg, p_cpu, b_cpu)
        os.environ["REPRO_KERNEL_BWD"] = "xla"
        try:
            _, g_plain = loss_and_grads(pcfg, p_dev, batch)
        finally:
            del os.environ["REPRO_KERNEL_BWD"]
        lg, lc = float(m_dev["loss"]), float(m_cpu["loss"])
        loss_err = abs(lg - lc) / abs(lc)
        cpu_err = rel_err(g_dev, g_cpu)
        plain_err = rel_err(g_dev, g_plain)
        finite = _finite(g_dev)
        loss_tol, grad_tol = tol
        # A ReLU unit whose pre-activation the two devices put on either
        # side of zero moves its gradient by a whole token's term: where
        # the only such units are ties (C.8), the CPU step is taken again
        # with those units, and no other, on the other branch, and its
        # grads must then agree
        ties = relu_ties(u_dev, u_cpu)
        branch_err = None
        if ties["differences"] and ties["all_ties"]:
            with relu_branch(masks=ties["masks"]):
                _, g_branch = loss_and_grads(pcfg, p_cpu, b_cpu)
            branch_err = rel_err(g_dev, g_branch)
        grad_ok = cpu_err <= grad_tol or (
            branch_err is not None and branch_err <= grad_tol)
        ok = (loss_err <= loss_tol and grad_ok and plain_err <= grad_tol
              and finite)
        control = {}
        if fp32_control:
            fcfg = configs.get(arch, linear=configs.linear_cfg(spec),
                               **{**over, "compute_dtype": "float32"})
            m_f, g_f = loss_and_grads(fcfg, p_cpu, _tree_to(batch, self.cpu))
            lf = float(m_f["loss"])
            control = {"control_loss_rel_err_vs_fp32_cpu":
                       f"{abs(lg - lf) / abs(lf):.3e}",
                       "control_grad_rel_err_vs_fp32_cpu":
                       f"{rel_err(g_dev, g_f):.3e}"}
        log("train_parity", arch=pcfg.name, linear=spec,
            dtype=pcfg.compute_dtype, layers=pcfg.n_layers, batch=B, seq=S,
            loss_card=f"{lg:.6f}", loss_cpu=f"{lc:.6f}",
            loss_rel_err=f"{loss_err:.3e}",
            grad_rel_err_vs_cpu=f"{cpu_err:.3e}",
            relu_sign_differences=ties["differences"],
            relu_ties=ties["units"],
            grad_rel_err_vs_cpu_on_card_relu_branch=(
                "n/a" if branch_err is None else f"{branch_err:.3e}"),
            grad_rel_err_kernel_vs_plain_bwd=f"{plain_err:.3e}",
            tol=f"{loss_tol:.0e}/{grad_tol:.0e}", finite=finite,
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")), **control, ok=ok)
        return launches if ok else {}

    def split_vs_fused(self, B, S, **over):
        """The ``split`` ff route (dyad_mm_blocks, the activation in
        torch, dyad_mm_blocks_two) against ``fused`` on the card: loss and
        grads of one Qwen3 step."""
        from repro_torch.train.step import loss_and_grads

        pcfg, p_dev, batch = self._step_inputs("qwen3_0_6b", QWEN_FF, B, S,
                                               **over)
        m_f, g_f = loss_and_grads(pcfg, p_dev, batch)
        os.environ["REPRO_KERNEL_FF"] = "split"
        try:
            self.zero_counts()
            m_s, g_s = loss_and_grads(pcfg, p_dev, batch)
            launches = self.counts()
        finally:
            del os.environ["REPRO_KERNEL_FF"]
        loss_err = abs(float(m_s["loss"]) - float(m_f["loss"])) / abs(
            float(m_f["loss"]))
        grad_err = rel_err(g_s, g_f)
        n = pcfg.n_layers
        # forward (twice under remat): two dyad_mm_blocks and one
        # dyad_mm_blocks_two per layer; the backward's remat adds two more
        routed = (launches["dyad_ff_fused"] == 0
                  and launches["dyad_mm_blocks_two"] == 2 * n)
        ok = (loss_err <= LOSS_TOL and grad_err <= GRAD_TOL and routed
              and _finite(g_s))
        log("split_vs_fused", arch=pcfg.name, layers=n, batch=B, seq=S,
            loss_rel_err=f"{loss_err:.3e}", grad_rel_err=f"{grad_err:.3e}",
            tol=f"{LOSS_TOL:.0e}/{GRAD_TOL:.0e}",
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")), ok=ok)
        return ok

    # -- 12. the continuous engine -------------------------------------------
    def _cont_setup(self):
        """(cfg, params, prompts, max_new, engine kwargs) of the
        continuous path: Qwen3-0.6B, random weights from the seed, the ff
        weights x 4, CONT's trace and engine."""
        from repro_torch import configs
        from repro_torch.models import model

        cfg = configs.get("qwen3_0_6b", linear=configs.linear_cfg(QWEN_FF))
        params = _scale_ff(model.init_params(
            cfg, self.torch.Generator(device=self.dev).manual_seed(
                self.seed), self.dev), CONT["ff_scale"])
        prompts, max_new = _trace(cfg.vocab_size, self.seed, CONT)
        kw = dict(n_slots=CONT["slots"], max_len=CONT["max_len"],
                  page_size=CONT["page_size"], prefill_chunk=CONT["chunk"],
                  prefix_cache=True)
        return cfg, params, prompts, max_new, kw

    def _profiled(self, phase, cfg, params, prompts, max_new, kw, route,
                  ff=None, whole=None):
        """A warm-up, the trace with its launch counts checked, then a
        profiled rerun over CONT's window of engine steps, ended there.
        The whole run launches some 700,000 kernels, which the profiler
        takes minutes to record and sort: it traces the window, device
        activity only, against the same window's wall time in the
        unprofiled run (the engine schedules both runs alike).  The
        profiler drops a few kernel records in some windows, as out of its
        time range, whatever its buffer size (fewer with PROFILE_MARGIN_S
        idle at each end of the window); so a profile counts only if its
        decode kernel's launches (``route``: paged, int8 or dense), and
        those of each kernel name of ``whole`` ({name: wrapper}), equal the
        window's counted calls.  It is taken again up to PROFILE_TRIES
        times, and the phase fails if none is whole.  Returns (run,
        profiled run, {kernel: (ms, launches)}), None on a failure."""
        from torch.profiler import ProfilerActivity, profile

        # the first calls at each shape pay one-time costs
        self._serve_trace(cfg, params, prompts[:2], [4, 4], **kw)
        window = CONT["profile_steps"]
        run = self._serve_trace(cfg, params, prompts, max_new, window=window,
                                **kw)
        if not self._check_trace(phase, cfg, run, route, ff=ff):
            return None
        kernel, wrapper = {
            "paged": ("flash_decode_paged_kernel", "flash_decode_paged"),
            "int8": ("flash_decode_paged_kernel", "flash_decode_paged_int8"),
            "dense": ("flash_decode_ring_kernel", "flash_decode")}[route]
        whole = {kernel: wrapper, **(whole or {})}
        for attempt in range(1, PROFILE_TRIES + 1):
            prof = profile(activities=[ProfilerActivity.CUDA])
            traced = self._serve_trace(cfg, params, prompts, max_new,
                                       window=window, prof=prof,
                                       window_only=True, **kw)
            per_kernel = _log_profile(prof, run["window_s"] * 1e3,
                                      phase + "_profile")
            seen = {k: sum(n for name, (_, n) in per_kernel.items()
                           if re.search(rf"\b{k}\b", name)) for k in whole}
            counted = {k: traced["window_launches"][w]
                       for k, w in whole.items()}
            decode_ms = sum(ms for name, (ms, _) in per_kernel.items()
                            if kernel in name)
            log(phase + "_profile", steps=f"{window[0]}-{window[1] - 1}",
                of_steps=run["engine_steps"], attempt=attempt,
                **{f"{route}_decode_ms": f"{decode_ms:.3f}"},
                **{f"{k}_launches": f"{seen[k]}/{counted[k]}"
                   for k in whole}, whole=seen == counted)
            if seen == counted:
                return run, traced, per_kernel
        log(phase + "_profile", failed=f"each of {PROFILE_TRIES} profiles "
            "dropped launch records")
        return None

    def continuous(self):
        """The continuous-batching path at full width and depth: the paged
        run with exact launch counts and its metrics, a profiled run, then
        the same trace on dense rings, with int8 pools and with a cut pool,
        each held against the paged run, and int8 pools at 2 layers on the
        card against the CPU port.  Returns the launch counts of the paged,
        int8 and dense runs, None on a failure."""
        cfg, params, prompts, max_new, kw = self._cont_setup()
        got = self._profiled("continuous", cfg, params, prompts, max_new, kw,
                             "paged")
        if got is None:
            return None
        paged = got[0]
        self.cont_tokens = paged["tokens"]
        a, b = CONT["profile_steps"]
        self.busy_ms["continuous_step"] = sum(
            ms for ms, _ in got[2].values()) / (b - a)

        got = self._profiled("continuous_dense", cfg, params, prompts,
                             max_new, dict(kw, env={"REPRO_PAGED_KV": "off"}),
                             "dense")
        if got is None:
            return None
        dense = got[0]
        qcfg = cfg.replace(kv_quant="int8")
        int8 = self._serve_trace(qcfg, params, prompts, max_new, **kw)
        cut = self._serve_trace(cfg, params, prompts, max_new,
                                **dict(kw, prefix_cache=False,
                                       n_pages=CONT["cut_pages"]))
        preempted = cut["summary"]["counters"].get("preemptions", 0)
        ok = (self._check_trace("continuous_int8", qcfg, int8, "int8")
              and self._check_trace("continuous_pool_cut", cfg, cut, "paged")
              and self._same_tokens("dense_vs_paged", cfg, params, prompts,
                                    dense["tokens"], paged["tokens"],
                                    LOGIT_TOL_BF16)
              and self._same_tokens("pool_cut_vs_paged", cfg, params,
                                    prompts, cut["tokens"], paged["tokens"],
                                    LOGIT_TOL_BF16))
        log("continuous_int8", token_match_rate_vs_fp_pools=
            f"{_match_rate(int8['tokens'], paged['tokens']):.4f}",
            note="printed, not gated")
        log("continuous_pool_cut", n_pages=CONT["cut_pages"],
            preemptions=preempted, ok=preempted > 0)
        if not ok or preempted == 0:
            return None
        del params
        self.torch.cuda.empty_cache()
        if not (self.continuous_exact() and self.continuous_parity()):
            return None
        return {"paged": paged["launches"], "int8": int8["launches"],
                "dense": dense["launches"]}

    def continuous_exact(self):
        """Qwen3 at full width and 2 layers in fp32 (compute and pools) on
        the card: a cut pool forces preemption, and each request's greedy
        tokens must equal the unpressured run's exactly, as the
        reference's contract says; the dense rings against the paged run
        by the tie rule at the fp32 bound."""
        ce = CONT_EXACT
        cfg, params, prompts, max_new, kw = self._exact_setup()
        paged = self._serve_trace(cfg, params, prompts, max_new, **kw)
        cut = self._serve_trace(cfg, params, prompts, max_new,
                                **dict(kw, n_pages=ce["cut_pages"]))
        dense = self._serve_trace(cfg, params, prompts, max_new,
                                  env={"REPRO_PAGED_KV": "off"}, **kw)
        if not (self._check_trace("exact_paged", cfg, paged, "paged")
                and self._check_trace("exact_pool_cut", cfg, cut, "paged")
                and self._check_trace("exact_dense", cfg, dense, "dense")):
            return False
        preempted = cut["summary"]["counters"].get("preemptions", 0)
        equal = sum(g == w for g, w in zip(cut["tokens"], paged["tokens"]))
        ok = preempted > 0 and equal == len(prompts)
        log("tokens", compare="pool_cut_vs_paged_fp32", requests=len(prompts),
            requests_equal=equal, n_pages=ce["cut_pages"],
            preemptions=preempted, rule="exact", ok=ok)
        return ok and self._same_tokens("dense_vs_paged_fp32", cfg, params,
                                        prompts, dense["tokens"],
                                        paged["tokens"], LOGIT_TOL)

    def continuous_parity(self):
        """int8 pools on the card against the CPU port: Qwen3 at full width
        and 2 layers in fp32, the same params and trace, greedy tokens."""
        from repro_torch import configs
        from repro_torch.models import model

        torch, dev, cp = self.torch, self.dev, CONT_PARITY
        cfg = configs.get("qwen3_0_6b", linear=configs.linear_cfg(QWEN_FF),
                          n_layers=cp["layers"], compute_dtype="float32",
                          kv_quant="int8")
        params = _scale_ff(model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(self.seed), dev),
            cp["ff_scale"])
        params_cpu = _tree_to(params, self.cpu)
        prompts, max_new = _trace(cfg.vocab_size, self.seed + 1, cp)
        kw = dict(n_slots=cp["slots"], max_len=cp["max_len"],
                  page_size=cp["page_size"], prefill_chunk=cp["chunk"],
                  prefix_cache=True)
        card = self._serve_trace(cfg, params, prompts, max_new, **kw)
        host = self._serve_trace(cfg, params_cpu, prompts, max_new,
                                 device=self.cpu, **kw)
        return (self._check_trace("continuous_int8_parity", cfg, card,
                                  "int8")
                and self._same_tokens("int8_card_vs_cpu", cfg, params_cpu,
                                      prompts, card["tokens"],
                                      host["tokens"], LOGIT_TOL_INT8,
                                      device=self.cpu))

    # -- 15. the moe, ssm and hybrid families --------------------------------
    def _busy(self, prof, wall_ms, phase, counted):
        """Log a profile's busy share and its launches by kernel name; a
        wrapper the run counted must show launches of its kernels.
        Returns (ok, device-busy ms, launches by wrapper)."""
        per_kernel = _log_profile(prof, wall_ms, phase)
        seen = _kernel_launches(per_kernel)
        busy = sum(ms for ms, _ in per_kernel.values())
        missing = [w for w, n in counted.items()
                   if n and w in seen and not seen[w]]
        log(phase, kernel_launches=json.dumps(seen, separators=(",", ":")),
            counted=json.dumps({k: v for k, v in counted.items() if v},
                               separators=(",", ":")),
            missing=",".join(missing) or "none", ok=bool(per_kernel)
            and not missing)
        return bool(per_kernel) and not missing, busy, seen

    def family_serve(self, arch, plain):
        """``Engine.generate`` at full width and depth, counted (the
        kernels FAMILY gives the route, exactly; no plain version on the
        card, ``plain`` the watch's counter), then a profiled generate of
        FAMILY_PROFILE_NEW tokens.  Returns (launches, params), None on a
        failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, dev = self.torch, self.dev
        fam = FAMILY[arch]
        B, S, new = fam["batch"]
        cfg = _family_cfg(arch)
        pgen = torch.Generator(device=dev).manual_seed(self.seed)
        params = model.init_params(cfg, pgen, dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=pgen,
                                device=dev)
        engine = Engine(cfg, params, max_len=S + new, device=dev)
        engine.generate(prompts, 2)           # warm-up: prefill and decode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain.clear()
        self.zero_counts()
        toks = engine.generate(prompts, new)
        launches = self.counts()
        t = engine.timings
        want = self.want(fam["per_layer"](new, new - 1), cfg.n_layers)
        shape_ok = (tuple(toks.shape) == (B, new) and int(toks.min()) >= 0
                    and int(toks.max()) < cfg.vocab_size)
        # the profile: a generate of FAMILY_PROFILE_NEW tokens, against
        # the wall of the same generate unprofiled (the whole one's 100,000
        # to 150,000 kernel records take the profiler tens of seconds)
        pnew = min(FAMILY_PROFILE_NEW, new)
        engine.generate(prompts, pnew)
        wall_ms = (engine.timings["prefill_s"]
                   + engine.timings["decode_s"]) * 1e3
        self.zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            engine.generate(prompts, pnew)
            time.sleep(PROFILE_MARGIN_S)
        ok, busy, _ = self._busy(prof, wall_ms, f"{arch}_profile",
                                 self.counts())
        log(f"{arch}_batch", arch=cfg.name, layers=cfg.n_layers,
            d_model=cfg.d_model, dtype=cfg.compute_dtype,
            scope=cfg.linear.scope, batch=B, prompt=S, new=new,
            profiled_new=pnew,
            window=cfg.window, prefill_s=f"{t['prefill_s']:.4f}",
            decode_s=f"{t['decode_s']:.4f}",
            decode_tok_s=f"{B * (new - 1) / t['decode_s']:.1f}",
            max_memory_allocated_gb=
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            device_busy_share=f"{busy / wall_ms:.3f}",
            distinct_tokens=len(set(toks.flatten().tolist())),
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")),
            plain_on_card=json.dumps(dict(plain)), tokens_ok=shape_ok)
        if launches != want or not shape_ok or plain or not ok:
            log(f"{arch}_batch", failed=f"launches {launches} want {want}, "
                f"plain on the card {dict(plain)}")
            return None
        del engine
        return launches, params

    def family_continuous(self, arch, params, plain):
        """The continuous engine at full width and depth on FAM_CONT's (or
        HYMBA_CONT's) traffic, launch counts exact, no plain version on the
        card, then a profiled window of engine steps.  Returns the launch
        counts, None on a failure."""
        import numpy as np
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fam = FAMILY[arch]
        cfg = _family_cfg(arch)
        if arch == "hymba_1_5b":
            spec = HYMBA_CONT
            prompts, max_new = _trace(cfg.vocab_size, self.seed, spec)
            rng = np.random.default_rng(self.seed + 1)
            lo, hi = spec["tail_long"]
            # every other prompt past the window
            prompts = [p if i % 2 == 0 else np.concatenate(
                [p[:spec["prefix"]], rng.integers(
                    0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))])
                .astype(np.int32) for i, p in enumerate(prompts)]
            kw = dict(n_slots=spec["slots"], max_len=spec["max_len"])
        else:
            spec = FAM_CONT
            prompts, max_new = _trace(cfg.vocab_size, self.seed, spec)
            kw = dict(n_slots=spec["slots"], max_len=spec["max_len"])
            if fam["cont_route"] == "paged":
                kw.update(page_size=spec["page_size"],
                          prefill_chunk=spec["chunk"], prefix_cache=True)
        self._serve_trace(cfg, params, prompts[:2], [4, 4], **kw)  # warm-up
        plain.clear()
        torch.cuda.reset_peak_memory_stats()
        window = spec["profile_steps"]
        run = self._serve_trace(cfg, params, prompts, max_new, window=window,
                                **kw)
        ok = self._check_trace(f"{arch}_continuous", cfg, run,
                               fam["cont_route"], ff=fam["cont_ff"])
        lengths = sorted(len(p) for p in prompts)
        log(f"{arch}_continuous", prompt_lengths=",".join(map(str, lengths)),
            max_memory_allocated_gb=
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            plain_on_card=json.dumps(dict(plain)))
        if not ok or plain:
            return None
        prof = profile(activities=[ProfilerActivity.CUDA])
        traced = self._serve_trace(cfg, params, prompts, max_new,
                                   window=window, prof=prof,
                                   window_only=True, **kw)
        ok, busy, _ = self._busy(prof, run["window_s"] * 1e3,
                                 f"{arch}_continuous_profile",
                                 traced["window_launches"])
        log(f"{arch}_continuous_profile",
            steps=f"{window[0]}-{window[1] - 1}",
            of_steps=run["engine_steps"],
            window_wall_ms=f"{run['window_s'] * 1e3:.3f}",
            device_busy_share=f"{busy / (run['window_s'] * 1e3):.3f}")
        return run["launches"] if ok else None

    def family_parity(self, arch):
        """Greedy tokens on the card against the CPU port at full width and
        FAM_PARITY's 2 layers in fp32, the same params (ff and expert
        weights x 4) and prompts: equal, or parting only after a step
        whose CPU top-2 logit margin is below LOGIT_TOL x max(|logits|, 1)
        or, for a MoE model, after a router tie (a token's k-th and
        (k+1)-th probabilities within ROUTER_TIE) at that step or before.
        The router's smallest gap is printed either way."""
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, dev, cpu, fp = self.torch, self.dev, self.cpu, FAM_PARITY
        # past attn_chunk keys (Hymba's 1040-token prompts over its 1024)
        # the CPU takes the reference's chunked einsum attention; the
        # card's flash route never reads the chunk
        cfg = _family_cfg(arch, n_layers=fp["layers"],
                          compute_dtype="float32")
        S = fp["S_hymba"] if arch == "hymba_1_5b" else fp["S"]
        B, new = fp["B"], fp["new"]
        pgen = torch.Generator(device=dev).manual_seed(self.seed)
        params = _scale_ff(model.init_params(cfg, pgen, dev),
                           fp["ff_scale"])
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=pgen,
                                device=dev)
        params_cpu = _tree_to(params, cpu)
        with torch.no_grad():
            gl, _ = model.prefill(cfg, params, model.init_cache(
                cfg, B, S + new, torch.float32, dev), prompts,
                last_only=False)
            cl, _ = model.prefill(cfg, params_cpu, model.init_cache(
                cfg, B, S + new, torch.float32, cpu), prompts.cpu(),
                last_only=False)
        finite = bool(torch.isfinite(gl).all())
        logits_ok, err, bound = _close(gl.cpu(), cl, LOGIT_TOL)
        gt = Engine(cfg, params, max_len=S + new, device=dev).generate(
            prompts, new).cpu()
        ct = Engine(cfg, params_cpu, max_len=S + new, device=cpu).generate(
            prompts.cpu(), new)
        same = bool((gt == ct).all())
        step = None if same else int((gt != ct).any(dim=0).nonzero()[0])
        margin = router = None
        if not same:
            margin = _top2_margin(model, cfg, params_cpu, prompts.cpu(), ct,
                                  step, S + new)
        if cfg.family == "moe":
            router = _router_margin(torch, model, cfg, params_cpu,
                                    prompts.cpu(), ct,
                                    new - 1 if same else step, S + new)
        tie_ok = same or (margin is not None and margin < bound) or (
            router is not None and router < ROUTER_TIE)
        ok = logits_ok and finite and tie_ok
        log(f"{arch}_parity", arch=cfg.name, layers=cfg.n_layers,
            dtype=cfg.compute_dtype, batch=B, prompt=S, new=new,
            logits_max_abs_err=f"{err:.3e}", tol=f"{bound:.3e}",
            finite=finite, tokens_equal=same, first_parting_step=step,
            top2_margin=margin, router_min_gap=router,
            router_tie=ROUTER_TIE if cfg.family == "moe" else None,
            distinct_tokens=len(set(ct.flatten().tolist())), ok=ok)
        return ok

    def families(self):
        """Phase 15: Qwen1.5-MoE-A2.7B, Mamba2-780m and Hymba-1.5B served
        at full width and depth (batch and continuous), then each at 2
        layers on the card against the CPU port.  Returns {run: launch
        counts}, None on a failure."""
        torch = self.torch
        t0 = time.perf_counter()
        out = {}
        with _plain_watch(torch) as plain:
            for arch in FAMILY:
                got = self.family_serve(arch, plain)
                if got is None:
                    return None
                # no reference to one model's params outlives its runs, so
                # the next model's peak memory is its own
                out[f"{arch}_batch"], params = got
                got = None
                cont = self.family_continuous(arch, params, plain)
                if cont is None:
                    return None
                out[f"{arch}_continuous"] = cont
                del params
                torch.cuda.empty_cache()
        for arch in FAMILY:
            if not self.family_parity(arch):
                return None
            torch.cuda.empty_cache()
        log("families", seconds=f"{time.perf_counter() - t0:.1f}")
        return out

    # -- 16. the encdec and vlm families ------------------------------------
    def _modal_model(self, arch, **over):
        """(cfg, params, prompts, frames) of MODAL's ``arch`` on the card:
        the family config served there (``_family_cfg``), random weights
        from the seed with the ff x MODAL_FF_SCALE, its batch's prompts
        and, for an encoder-decoder, its frames in the compute dtype."""
        from repro_torch.models import model

        torch, dev = self.torch, self.dev
        B, S, _ = MODAL[arch]["batch"]
        cfg = _family_cfg(arch, **over)
        pgen = torch.Generator(device=dev).manual_seed(self.seed)
        params = _scale_ff(model.init_params(cfg, pgen, dev), MODAL_FF_SCALE)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=pgen,
                                device=dev)
        frames = None
        if cfg.family == "encdec":
            frames = torch.randn(B, cfg.n_frames, cfg.frontend_dim,
                                 generator=pgen, device=dev).to(cfg.cdtype)
        return cfg, params, prompts, frames

    def modal_serve(self, arch, plain):
        """``Engine.generate`` at full width and depth (an encoder-decoder
        with its frames), counted: the kernels MODAL gives the decoder's
        and the encoder's layers, exactly; no plain version of a kernel
        and no plain self-attention on the card, cross-attention's einsum
        route (CROSS_SDPA) once a decoder layer and token.  Then a
        profiled generate of FAMILY_PROFILE_NEW tokens.  Returns (launches,
        cfg, params), None on a failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serve.engine import Engine

        torch = self.torch
        spec = MODAL[arch]
        B, S, new = spec["batch"]
        cfg, params, prompts, frames = self._modal_model(arch)
        engine = Engine(cfg, params, max_len=S + new, device=self.dev)
        engine.generate(prompts, 2, frames=frames)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain.clear()
        self.zero_counts()
        toks = engine.generate(prompts, new, frames=frames)
        launches = self.counts()
        t = engine.timings
        mem = torch.cuda.max_memory_allocated()
        want = self.want(spec["per_layer"](new, new - 1), cfg.n_layers)
        for k, v in spec["per_enc_layer"].items():
            want[k] += v * cfg.n_enc_layers
        cross = plain.pop(CROSS_SDPA, 0)
        want_cross = cfg.n_layers * new if cfg.family == "encdec" else 0
        shape_ok = (tuple(toks.shape) == (B, new) and int(toks.min()) >= 0
                    and int(toks.max()) < cfg.vocab_size)
        pnew = min(FAMILY_PROFILE_NEW, new)
        engine.generate(prompts, pnew, frames=frames)
        wall_ms = (engine.timings["prefill_s"]
                   + engine.timings["decode_s"]) * 1e3
        self.zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            engine.generate(prompts, pnew, frames=frames)
            time.sleep(PROFILE_MARGIN_S)
        ok, busy, _ = self._busy(prof, wall_ms, f"{arch}_profile",
                                 self.counts())
        plain.pop(CROSS_SDPA, 0)
        log(f"{arch}_batch", arch=cfg.name, layers=cfg.n_layers,
            enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
            head_dim=cfg.hd, dtype=cfg.compute_dtype, batch=B, prompt=S,
            new=new, frames=cfg.n_frames if frames is not None else 0,
            profiled_new=pnew, prefill_s=f"{t['prefill_s']:.4f}",
            decode_s=f"{t['decode_s']:.4f}",
            decode_tok_s=f"{B * (new - 1) / t['decode_s']:.1f}",
            max_memory_allocated_gb=f"{mem / 1e9:.2f}",
            device_busy_share=f"{busy / wall_ms:.3f}",
            distinct_tokens=len(set(toks.flatten().tolist())),
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")),
            cross_sdpa_calls=cross, want_cross=want_cross,
            plain_on_card=json.dumps(dict(plain)), tokens_ok=shape_ok)
        if (launches != want or not shape_ok or plain or not ok
                or cross != want_cross):
            log(f"{arch}_batch", failed=f"launches {launches} want {want}, "
                f"cross {cross} want {want_cross}, plain on the card "
                f"{dict(plain)}")
            return None
        del engine
        return launches, cfg, params

    def modal_forward(self, arch, cfg, params, plain):
        """A vision model's ``forward`` with its patches (MODAL's
        ``forward``: B requests of 576 patches and S text tokens,
        ``last_only``), counted exactly, no plain version on the card, then
        profiled.  Returns the launches, None on a failure."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import model

        torch, dev = self.torch, self.dev
        spec = MODAL[arch]
        B, S = spec["forward"]
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
        patches = torch.randn(B, cfg.n_patches, cfg.frontend_dim,
                              generator=gen, device=dev).to(cfg.cdtype)

        def fwd():
            out = model.forward(cfg, params, toks, patches=patches,
                                last_only=True)
            torch.cuda.synchronize()
            return out
        with torch.no_grad():
            fwd()                                       # warm-up
            torch.cuda.reset_peak_memory_stats()
            plain.clear()
            self.zero_counts()
            t0 = time.perf_counter()
            logits = fwd()
            fwd_s = time.perf_counter() - t0
            launches = self.counts()
            mem = torch.cuda.max_memory_allocated()
            self.zero_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                fwd()
                time.sleep(PROFILE_MARGIN_S)
        ok, busy, _ = self._busy(prof, fwd_s * 1e3, f"{arch}_forward_profile",
                                 self.counts())
        want = self.want(spec["forward_per_layer"], cfg.n_layers)
        shape_ok = (tuple(logits.shape) == (B, 1, cfg.vocab_size)
                    and bool(torch.isfinite(logits).all()))
        log(f"{arch}_forward", arch=cfg.name, layers=cfg.n_layers, batch=B,
            patches=cfg.n_patches, text=S, forward_s=f"{fwd_s:.4f}",
            tok_s=f"{B * (cfg.n_patches + S) / fwd_s:.1f}",
            max_memory_allocated_gb=f"{mem / 1e9:.2f}",
            device_busy_share=f"{busy / (fwd_s * 1e3):.3f}",
            launches=json.dumps({k: v for k, v in launches.items() if v},
                                separators=(",", ":")),
            plain_on_card=json.dumps(dict(plain)), logits_ok=shape_ok)
        if launches != want or not shape_ok or plain or not ok:
            log(f"{arch}_forward", failed=f"launches {launches} want {want}, "
                f"plain on the card {dict(plain)}")
            return None
        return launches

    def modal_parity(self, arch):
        """Greedy tokens on the card against the CPU port at full width and
        MODAL_PARITY's 2 layers (2 + 2 for an encoder-decoder) in fp32, the
        same params (ff x 4), prompts and frames: equal, or parting only
        after a step whose CPU top-2 logit margin is below LOGIT_TOL x
        max(|logits|, 1); the prefill logits within that bound; and a
        vision model's patch forward within it."""
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, cpu, mp = self.torch, self.cpu, MODAL_PARITY
        over = dict(n_layers=mp["layers"], compute_dtype="float32")
        if arch == "whisper_medium":
            over["n_enc_layers"] = mp["layers"]
        cfg, params, prompts, frames = self._modal_model(arch, **over)
        B, S, new = mp["B"], mp["S"], mp["new"]
        prompts = prompts[:B, :S].contiguous()
        frames = None if frames is None else frames[:B].contiguous()
        fcpu = None if frames is None else frames.cpu()
        params_cpu = _tree_to(params, cpu)
        with torch.no_grad():
            gl, _ = model.prefill(cfg, params, model.init_cache(
                cfg, B, S + new, torch.float32, self.dev), prompts,
                frames=frames, last_only=False)
            cl, _ = model.prefill(cfg, params_cpu, model.init_cache(
                cfg, B, S + new, torch.float32, cpu), prompts.cpu(),
                frames=fcpu, last_only=False)
        finite = bool(torch.isfinite(gl).all())
        logits_ok, err, bound = _close(gl.cpu(), cl, LOGIT_TOL)
        gt = Engine(cfg, params, max_len=S + new, device=self.dev).generate(
            prompts, new, frames=frames).cpu()
        ct = Engine(cfg, params_cpu, max_len=S + new, device=cpu).generate(
            prompts.cpu(), new, frames=fcpu)
        same = bool((gt == ct).all())
        step = margin = None
        if not same:
            step = int((gt != ct).any(dim=0).nonzero()[0])
            margin = _top2_margin(model, cfg, params_cpu, prompts.cpu(), ct,
                                  step, S + new, frames=fcpu)
        tie_ok = same or (margin is not None and margin < bound)
        patch = {}
        if cfg.family == "vlm":
            pb = mp["patch_B"]
            gen = torch.Generator(device=self.dev).manual_seed(self.seed + 2)
            patches = torch.randn(pb, cfg.n_patches, cfg.frontend_dim,
                                  generator=gen, device=self.dev)
            with torch.no_grad():
                gf = model.forward(cfg, params, prompts[:pb],
                                   patches=patches)
                cf = model.forward(cfg, params_cpu, prompts[:pb].cpu(),
                                   patches=patches.cpu())
            pok, perr, pbound = _close(gf.cpu(), cf, LOGIT_TOL)
            patch = dict(patch_logits_max_abs_err=f"{perr:.3e}",
                         patch_tol=f"{pbound:.3e}", patch_ok=pok)
            logits_ok = logits_ok and pok and bool(torch.isfinite(gf).all())
        ok = logits_ok and finite and tie_ok
        log(f"{arch}_parity", arch=cfg.name, layers=cfg.n_layers,
            enc_layers=cfg.n_enc_layers, dtype=cfg.compute_dtype, batch=B,
            prompt=S, new=new, logits_max_abs_err=f"{err:.3e}",
            tol=f"{bound:.3e}", finite=finite, tokens_equal=same,
            first_parting_step=step, top2_margin=margin,
            distinct_tokens=len(set(ct.flatten().tolist())), **patch, ok=ok)
        return ok

    def modal(self):
        """Phase 16: Whisper-medium and Phi-3-vision-4.2B served at full
        width and depth (the batch generate; Phi-3-vision's patch forward),
        then each at 2 layers on the card against the CPU port.  Returns
        {run: launch counts}, None on a failure."""
        torch = self.torch
        t0 = time.perf_counter()
        out = {}
        with _plain_watch(torch) as plain:
            for arch in MODAL:
                got = self.modal_serve(arch, plain)
                if got is None:
                    return None
                out[f"{arch}_batch"], cfg, params = got
                got = None
                if "forward" in MODAL[arch]:
                    fwd = self.modal_forward(arch, cfg, params, plain)
                    if fwd is None:
                        return None
                    out[f"{arch}_forward"] = fwd
                del params
                torch.cuda.empty_cache()
        for arch in MODAL:
            if not self.modal_parity(arch):
                return None
            torch.cuda.empty_cache()
        log("modal", seconds=f"{time.perf_counter() - t0:.1f}")
        return out

    # -- 13. quantized serving ---------------------------------------------
    def _quant_setup(self, spec, qdtype, **over):
        """(cfg, params): Qwen3-0.6B with ``spec``, random weights from the
        seed, the ff weights x 4 (CONT's scale), then the sidecars."""
        from repro_torch import configs, quant
        from repro_torch.models import model

        cfg = configs.get("qwen3_0_6b", linear=configs.linear_cfg(spec),
                          **over)
        params = _scale_ff(model.init_params(
            cfg, self.torch.Generator(device=self.dev).manual_seed(
                self.seed), self.dev), CONT["ff_scale"])
        return cfg, quant.quantize_params(params, qdtype)

    def quant_continuous(self):
        """Phase 13 (b)-(e).  Returns the launch counts of the full-depth
        run and of the split run, None on a failure."""
        torch = self.torch
        q_fused = {"dyad_ff_fused_q": 1}
        q_split = {"dyad_mm_blocks_q": 2, "dyad_mm_blocks_two_q": 1}
        # (b) the README's command: int8 weights and int8 pools, full depth
        cfg, params = self._quant_setup(QWEN_FF + "_w8", "int8",
                                        kv_quant="int8")
        prompts, max_new = _trace(cfg.vocab_size, self.seed, CONT)
        kw = dict(n_slots=CONT["slots"], max_len=CONT["max_len"],
                  page_size=CONT["page_size"], prefill_chunk=CONT["chunk"],
                  prefix_cache=True)
        got = self._profiled("quant_continuous", cfg, params, prompts,
                             max_new, kw, "int8", ff=q_fused,
                             whole={"dyad_ff_tc_kernel": "dyad_ff_fused_q"})
        if got is None:
            return None
        full, traced, per_kernel = got
        # the window's quantized ff calls on the tensor-core megakernel's
        # payload instantiation: no FMA megakernel, no weight cast
        calls = traced["window_launches"]["dyad_ff_fused_q"]
        if not (calls and _launches_by_name(
                per_kernel, {"dyad_ff_tc_kernel": calls, "dyad_ff_kernel": 0,
                             "dyad_ff_cast_kernel": 0}, "ff",
                "quant_continuous_profile")):
            log("quant_continuous_profile",
                failed=f"ff kernels by name, {calls} calls in the window")
            return None
        del params
        torch.cuda.empty_cache()

        # (c) the split ff route at 2 layers, fp8 weights, against the fused
        # route on the same weights by the bf16 tie rule
        cfg, params = self._quant_setup(QWEN_FF + "_wfp8", "fp8",
                                        kv_quant="int8",
                                        n_layers=QUANT_LAYERS)
        fused = self._serve_trace(cfg, params, prompts, max_new, **kw)
        split = self._serve_trace(cfg, params, prompts, max_new,
                                  env={"REPRO_KERNEL_FF": "split"}, **kw)
        if not (self._check_trace("quant_fused_fp8", cfg, fused, "int8",
                                  ff=q_fused)
                and self._check_trace("quant_split_fp8", cfg, split, "int8",
                                      ff=q_split)
                and self._same_tokens("quant_split_vs_fused_fp8", cfg, params,
                                      prompts, split["tokens"],
                                      fused["tokens"], LOGIT_TOL_BF16)):
            return None
        del params
        if not (self.quant_parity() and self.quant_off()):
            return None
        return {"continuous": full["launches"], "split": split["launches"]}

    def quant_parity(self):
        """(d) At 2 layers in fp32 (compute and pools), int8 and fp8
        weights, fused and split: the card's greedy tokens equal the CPU
        port's on the same weights and trace."""
        from repro_torch import configs

        cp = CONT_PARITY
        prompts, max_new = _trace(configs.get("qwen3_0_6b").vocab_size,
                                  self.seed + 1, cp)
        kw = dict(n_slots=cp["slots"], max_len=cp["max_len"],
                  page_size=cp["page_size"], prefill_chunk=cp["chunk"],
                  prefix_cache=True)
        ok = True
        for spec, qdt in ((QWEN_FF + "_w8", "int8"),
                          (QWEN_FF + "_wfp8", "fp8")):
            cfg, params = self._quant_setup(spec, qdt, n_layers=cp["layers"],
                                            compute_dtype="float32")
            params_cpu = _tree_to(params, self.cpu)
            for route, ff in (("fused", {"dyad_ff_fused_q": 1}),
                              ("split", {"dyad_mm_blocks_q": 2,
                                         "dyad_mm_blocks_two_q": 1})):
                env = {"REPRO_KERNEL_FF": route}
                card = self._serve_trace(cfg, params, prompts, max_new,
                                         env=env, **kw)
                host = self._serve_trace(cfg, params_cpu, prompts, max_new,
                                         env=env, device=self.cpu, **kw)
                phase = f"quant_parity_{qdt}_{route}"
                equal = sum(a == b for a, b in zip(card["tokens"],
                                                   host["tokens"]))
                good = (self._check_trace(phase, cfg, card, "paged", ff=ff)
                        and equal == len(prompts))
                log("tokens", compare=f"{qdt}_{route}_card_vs_cpu_fp32",
                    requests=len(prompts), requests_equal=equal,
                    rule="exact", ok=good)
                ok = ok and good
        return ok

    def quant_off(self):
        """(e) ``REPRO_KERNEL_QUANT=off`` at 2 layers in fp32: the
        quantized tree serves exactly the unquantized run's tokens, with
        its launches (the megakernel, no quantized kernel)."""
        from repro_torch import configs

        cp = CONT_PARITY
        prompts, max_new = _trace(configs.get("qwen3_0_6b").vocab_size,
                                  self.seed + 1, cp)
        kw = dict(n_slots=cp["slots"], max_len=cp["max_len"],
                  page_size=cp["page_size"], prefill_chunk=cp["chunk"],
                  prefix_cache=True)
        cfg, params = self._quant_setup(QWEN_FF + "_w8", "int8",
                                        n_layers=cp["layers"],
                                        compute_dtype="float32")
        off = self._serve_trace(cfg, params, prompts, max_new,
                                env={"REPRO_KERNEL_QUANT": "off"}, **kw)
        fp_cfg = cfg.replace(linear=cfg.linear.replace(quant=None))
        fp = self._serve_trace(fp_cfg, params, prompts, max_new, **kw)
        same = (off["tokens"] == fp["tokens"]
                and off["launches"] == fp["launches"])
        ok = (self._check_trace("quant_off", cfg, off, "paged")
              and self._check_trace("quant_off_fp", fp_cfg, fp, "paged")
              and same)
        log("tokens", compare="quant_off_vs_unquantized_fp32",
            requests=len(prompts), tokens_and_launches_equal=same,
            rule="exact", ok=ok)
        return ok

    # -- 14. spans, route events and seeded faults --------------------------
    def observe(self):
        """Phase 14 (the module docstring); True when every check passed.
        The tracer and the fault schedule are off again afterwards."""
        from repro_torch import faults, obs

        t0 = time.perf_counter()
        try:
            ok = (self.obs_train() and self.obs_continuous()
                  and self.obs_kernel_nan() and self.obs_cost())
        finally:
            obs.disable()
            faults.reset()
        log("observe", seconds=f"{time.perf_counter() - t0:.1f}", ok=ok)
        return ok

    def obs_train(self):
        """14a: the train launcher under faults, its trace and metrics."""
        import numpy as np

        from repro_torch import faults, obs
        from repro_torch.launch import train as train_launch

        ot = OBS_TRAIN
        slow_ms = round(ot["slow_x"]
                        * self.step_ms[("opt125m", "dyad_it_4_kernel")])
        spec = (f"nan_loss:at_step={ot['nan_at']};slow_step:at_step="
                f"{ot['slow_at']},ms={slow_ms};ckpt_io:p=0.3")
        handlers = {s: signal.getsignal(s)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        with tempfile.TemporaryDirectory() as d:
            trace, mj, ck = (os.path.join(d, n) for n in
                             ("train.json", "metrics.json", "ck"))
            obs.reset_route_counts()
            t = time.perf_counter()
            try:
                train_launch.main([
                    "--arch", "opt125m", "--linear", "dyad_it_4_kernel",
                    "--steps", str(ot["steps"]), "--seq-len",
                    str(TRAIN["S"]), "--batch", str(TRAIN["B"]),
                    "--ckpt-dir", ck, "--ckpt-every", str(ot["ckpt_every"]),
                    "--faults", spec, "--fault-seed", str(ot["fault_seed"]),
                    "--trace", trace, "--metrics-json", mj,
                    "--seed", str(self.seed), "--device", str(self.dev)])
            finally:
                obs.disable()
                faults.reset()
                for sig, h in handlers.items():
                    signal.signal(sig, h)
            wall = time.perf_counter() - t
            routes = obs.routes_snapshot()
            events = json.load(open(trace))["traceEvents"]
            metrics = json.load(open(mj))
            final = os.path.join(ck, f"ckpt_{ot['steps']}", "arrays.npz")
            with np.load(final) as z:
                finite = all(bool(np.isfinite(z[k]).all()) for k in z.files
                             if k.startswith("params/"))
        names = collections.Counter(e["name"] for e in events)
        at = {n: [e["args"]["step"] for e in events if e["name"] == n]
              for n in ("nonfinite_step", "straggler")}
        tallies = metrics["faults"]
        c = metrics["counters"]
        n_routes = sum(routes.values())
        checks = {
            "train_step_spans": names["train_step"] == ot["steps"],
            "nonfinite_step": at["nonfinite_step"] == [ot["nan_at"] + 1],
            "straggler": at["straggler"] == [ot["slow_at"]],
            "ckpt_retry": (names["ckpt_retry"]
                           == tallies["ckpt_io"]["fired"] >= 1),
            "params_finite": finite,
            "counters": (c.get("nonfinite_steps") == 1
                         and c.get("straggler_count") == 1),
            "routes_per_step": n_routes % ot["steps"] == 0}
        log("observe_train", arch="opt-125m", linear="dyad_it_4_kernel",
            steps=ot["steps"], faults=repr(spec),
            fault_seed=ot["fault_seed"], wall_s=f"{wall:.2f}",
            tallies=json.dumps(tallies, separators=(",", ":")),
            spans=json.dumps({k: names[k] for k in (
                "train_step", "checkpoint", "slow_step_fault")},
                separators=(",", ":")),
            instants=json.dumps({k: names[k] for k in (
                "nonfinite_step", "straggler", "ckpt_retry", "fault")},
                separators=(",", ":")),
            nonfinite_at=at["nonfinite_step"], straggler_at=at["straggler"],
            route_events_per_step=n_routes / ot["steps"],
            routes=json.dumps(routes, separators=(",", ":")),
            **checks)
        return all(checks.values())

    def obs_continuous(self):
        """14b: phase 12's continuous run under OBS_SERVE_FAULTS, traced,
        against phase 12's tokens; then at 2 layers in fp32 against the
        unfaulted run exactly and the CPU port's tallies."""
        from repro_torch import faults, obs

        cfg, params, prompts, max_new, kw = self._cont_setup()
        faults.configure(OBS_SERVE_FAULTS, seed=self.seed)
        obs.enable()
        try:
            r = self._serve_trace(cfg, params, prompts, max_new, **kw)
        finally:
            tracer = obs.disable()
            faults.reset()
        events = tracer.to_chrome_trace()["traceEvents"]
        names = collections.Counter(e["name"] for e in events)
        decode = sorted(e["dur"] / 1e3 for e in events
                        if e["name"] == "decode_step")
        tallies = r["summary"]["faults"]
        c = r["summary"]["counters"]
        checks = {
            "drained": [len(t) for t in r["tokens"]] == max_new,
            "pages_balance": r["free_pages_ok"],
            "not_demoted": r["demoted"] == [],
            "decode_step_spans": names["decode_step"] == r["steps"],
            "nan_detected": (names["nan_detected"] == c.get("nan_steps")
                             == tallies["nan_logits"]["fired"] == 1),
            "admit_backoff": (names["admit_backoff"]
                              == c.get("admission_backoffs", 0)
                              == tallies["page_exhaustion"]["fired"] >= 1),
            "slow_step": (names["slow_step_fault"]
                          == tallies["slow_step"]["fired"]
                          == tallies["slow_step"]["checks"])}
        self.obs_decode_ms = statistics.median(decode)
        log("observe_continuous", arch=cfg.name, layers=cfg.n_layers,
            faults=repr(OBS_SERVE_FAULTS), requests=len(prompts),
            wall_s=f"{r['wall_s']:.3f}", decode_steps=r["steps"],
            tallies=json.dumps(tallies, separators=(",", ":")),
            trace_events=len(events),
            decode_step_span_ms_p50=f"{self.obs_decode_ms:.3f}",
            **checks)
        ok = all(checks.values()) and self._same_tokens(
            "faulted_vs_paged", cfg, params, prompts, r["tokens"],
            self.cont_tokens, LOGIT_TOL_BF16)
        del params
        self.torch.cuda.empty_cache()
        return ok and self._obs_exact()

    def _exact_setup(self):
        """(cfg, params, prompts, max_new, kw) of CONT_EXACT: Qwen3 at
        full width and 2 layers in fp32, as ``continuous_exact``."""
        from repro_torch import configs
        from repro_torch.models import model

        ce = CONT_EXACT
        cfg = configs.get("qwen3_0_6b", linear=configs.linear_cfg(QWEN_FF),
                          n_layers=ce["layers"], compute_dtype="float32")
        params = _scale_ff(model.init_params(
            cfg, self.torch.Generator(device=self.dev).manual_seed(
                self.seed), self.dev), ce["ff_scale"])
        prompts, max_new = _trace(cfg.vocab_size, self.seed + 2, ce)
        kw = dict(n_slots=ce["slots"], max_len=ce["max_len"],
                  page_size=ce["page_size"], prefill_chunk=ce["chunk"])
        return cfg, params, prompts, max_new, kw

    def _obs_exact(self):
        from repro_torch import faults

        cfg, params, prompts, max_new, kw = self._exact_setup()
        clean = self._serve_trace(cfg, params, prompts, max_new, **kw)
        runs = {}
        for name, p, dev in (("card", params, None),
                             ("cpu", _tree_to(params, self.cpu), self.cpu)):
            faults.configure(OBS_SERVE_FAULTS, seed=self.seed)
            try:
                runs[name] = self._serve_trace(cfg, p, prompts, max_new,
                                               device=dev, **kw)
            finally:
                faults.reset()
        card, host = runs["card"], runs["cpu"]
        equal = sum(g == w for g, w in zip(card["tokens"], clean["tokens"]))
        checks = {
            "tokens_exact": equal == len(prompts),
            "tallies_card_eq_cpu": (card["summary"]["faults"]
                                    == host["summary"]["faults"]),
            "not_demoted": card["demoted"] == host["demoted"] == [],
            "drained": all([len(t) for t in r["tokens"]] == max_new
                           for r in (card, host))}
        log("observe_exact", arch=cfg.name, layers=cfg.n_layers,
            dtype=cfg.compute_dtype, requests=len(prompts),
            requests_equal=equal, tallies=json.dumps(
                card["summary"]["faults"], separators=(",", ":")),
            cpu_tallies=json.dumps(host["summary"]["faults"],
                                   separators=(",", ":")), **checks)
        return all(checks.values())

    def obs_kernel_nan(self):
        """14c: ``kernel_nan:route=ff_fused`` at 2 layers in fp32, on
        dense rings."""
        from repro_torch import faults, obs
        from repro_torch.serve.engine import ContinuousBatchingEngine

        cfg, params, prompts, _, kw = self._exact_setup()
        faults.configure("kernel_nan:route=ff_fused", seed=self.seed)
        obs.reset_route_counts()
        try:
            # dense rings, as the reference's test drives it: a paged pool
            # would hand the faulted request's NaN rows to the next ones
            # (ROADMAP C.11)
            eng = ContinuousBatchingEngine(
                cfg, params, n_slots=kw["n_slots"], max_len=kw["max_len"],
                device=self.dev)
            eng.submit(prompts[0], 8)
            eng.run()
            first = dict(eng.metrics_summary()["counters"])
            demoted = list(eng.demoted)
            uids = [eng.submit(p, 8) for p in prompts[1:4]]
            res = eng.run()
            tallies = faults.snapshot()
        finally:
            faults.reset()
        c = eng.metrics_summary()["counters"]
        routes = obs.routes_snapshot()
        vocab = cfg.vocab_size
        checks = {
            "first_faulted": first.get("retired_faulted") == 1,
            "ff_rung": demoted == ["quant", "ff"],
            "env_untouched": os.environ.get("REPRO_KERNEL_FF") is None,
            "next_clean": (all(len(res[u]) == 8 and all(0 <= t < vocab
                                                         for t in res[u])
                               for u in uids)
                           and c.get("retired_max_new") == 3
                           and c.get("retired_faulted") == 1),
            "split_route": (routes.get("demote:ff") == 1
                            and routes.get("ff:split", 0) > 0)}
        log("observe_kernel_nan", arch=cfg.name, layers=cfg.n_layers,
            route="ff_fused", demoted=demoted, tallies=json.dumps(
                tallies, separators=(",", ":")),
            routes=json.dumps(routes, separators=(",", ":")), **checks)
        return all(checks.values())

    def obs_cost(self):
        """14d: the tracer off and on in turns: the OPT-125m IT step and
        Qwen3's batch decode tok/s; route events per step and decode
        step; span medians beside the profiled busy ms."""
        from repro_torch import configs, obs
        from repro_torch.launch.train import build_trainer
        from repro_torch.models import model
        from repro_torch.serve.engine import Engine

        torch, oc = self.torch, OBS_COST
        _, trainer = build_trainer(
            "opt125m", linear="dyad_it_4_kernel", steps=100,
            seq_len=TRAIN["S"], batch=TRAIN["B"], seed=self.seed,
            device=self.dev, log_fn=lambda *a: None)
        trainer.run(TRAIN["warmup"])
        obs.reset_route_counts()
        trainer.run(trainer.step + 1)
        step_routes = obs.routes_snapshot()
        times, spans = {"off": [], "on": []}, []
        for mode in ("off", "on") * oc["turns"]:
            if mode == "on":
                obs.enable()
            trainer.run(trainer.step + oc["steps"])
            times[mode] += trainer.metrics.histogram(
                "step_time_s").samples[-oc["steps"]:]
            t = obs.disable()
            if t is not None:
                spans += [e["dur"] / 1e3 for e in t.to_chrome_trace()[
                    "traceEvents"] if e["name"] == "train_step"]
        del trainer
        torch.cuda.empty_cache()
        med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        busy = self.busy_ms[("opt125m", "dyad_it_4_kernel")]
        log("observe_cost", path="opt125m_it_train_step",
            step_ms_off=f"{med['off']:.3f}", step_ms_on=f"{med['on']:.3f}",
            on_over_off=f"{med['on'] / med['off']:.4f}",
            step_ms_off_all=",".join(f"{v * 1e3:.3f}" for v in times["off"]),
            step_ms_on_all=",".join(f"{v * 1e3:.3f}" for v in times["on"]),
            train_step_span_ms_p50=f"{statistics.median(spans):.3f}",
            profiled_busy_ms_per_step=f"{busy:.3f}",
            route_events_per_step=sum(step_routes.values()),
            routes=json.dumps(step_routes, separators=(",", ":")))

        B, S, new = SMOKE["B"], SMOKE["S"], SMOKE["new"]
        cfg = configs.get("qwen3_0_6b", linear=configs.linear_cfg(QWEN_FF))
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        params = model.init_params(cfg, gen, self.dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device=self.dev)
        engine = Engine(cfg, params, max_len=S + new, device=self.dev)
        engine.generate(prompts, new)                         # warm-up
        per = []
        for n in (1, 2):
            obs.reset_route_counts()
            engine.generate(prompts, n)
            per.append(obs.route_counts())
        decode_routes = {f"{op}:{r}": k - per[0].get((op, r), 0)
                         for (op, r), k in sorted(per[1].items())}
        rates = {"off": [], "on": []}
        for mode in ("off", "on") * oc["turns"]:
            if mode == "on":
                obs.enable()
            engine.generate(prompts, new)
            obs.disable()
            rates[mode].append(B * (new - 1) / engine.timings["decode_s"])
        del engine, params
        torch.cuda.empty_cache()
        rmed = {k: statistics.median(v) for k, v in rates.items()}
        log("observe_cost", path="qwen3_batch_decode",
            decode_tok_s_off=f"{rmed['off']:.1f}",
            decode_tok_s_on=f"{rmed['on']:.1f}",
            on_over_off=f"{rmed['on'] / rmed['off']:.4f}",
            decode_tok_s_off_all=",".join(f"{v:.1f}" for v in rates["off"]),
            decode_tok_s_on_all=",".join(f"{v:.1f}" for v in rates["on"]),
            route_events_per_decode_step=sum(decode_routes.values()),
            routes=json.dumps(decode_routes, separators=(",", ":")),
            continuous_decode_step_span_ms_p50=f"{self.obs_decode_ms:.3f}",
            continuous_profiled_busy_ms_per_step=
            f"{self.busy_ms['continuous_step']:.3f}")
        return True

    def _serve_trace(self, cfg, params, prompts, max_new, env=None,
                     device=None, window=None, prof=None, window_only=False,
                     **kw):
        """One run of the trace through ``ContinuousBatchingEngine``, with
        the launch counters set to 0 just before the first submit and read
        after the drain.  Prefill time is the host clock around each
        prefill call, synchronised; decode time the engine's
        ``decode_step_s`` samples (each ends in the step's token copy).
        ``window`` (a, b): the wall time of engine steps a to b - 1,
        synchronised at both ends, with ``prof`` running over them;
        ``window_only`` ends the run there (no tokens: None)."""
        from repro_torch.serve.engine import ContinuousBatchingEngine

        torch = self.torch
        device = device or self.dev
        saved = {k: os.environ.get(k) for k in (
            "REPRO_KERNEL_ATTN", "REPRO_PAGED_KV", "REPRO_KERNEL_FF",
            "REPRO_KERNEL_QUANT")}
        os.environ.update(env or {})
        try:
            eng = ContinuousBatchingEngine(cfg, params, device=device, **kw)
            name = "_chunk" if eng.paged else "_prefill_one"
            inner = getattr(eng, name)
            prefill = {"s": 0.0, "one": 0, "many": 0, "tokens": 0}

            def timed(*a):
                t = time.perf_counter()
                out = inner(*a)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                prefill["s"] += time.perf_counter() - t
                seq = a[1] if eng.paged else a[0]
                prefill["one" if len(seq) == 1 else "many"] += 1
                prefill["tokens"] += len(seq)
                return out

            setattr(eng, name, timed)
            if device.type == "cuda":
                torch.cuda.synchronize()
            self.zero_counts()
            t0 = time.perf_counter()
            uids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
            n_steps, bounds, at = 0, {}, {}
            while eng.slots.active or eng.queue:
                if window and n_steps in window:
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    bounds[n_steps] = time.perf_counter()
                    at[n_steps] = self.counts()
                    if prof is not None and n_steps == window[0]:
                        prof.start()
                        time.sleep(PROFILE_MARGIN_S)
                    elif prof is not None:
                        time.sleep(PROFILE_MARGIN_S)
                        prof.stop()
                    if window_only and n_steps == window[1]:
                        break
                eng.step()
                n_steps += 1
            # drained: collects the tokens
            res = None if window_only else eng.run()
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = self.counts()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        summary = eng.metrics_summary()
        steps = eng.metrics.histogram("decode_step_s")
        if window and len(bounds) != 2:
            raise RuntimeError(f"the run took {n_steps} engine steps, fewer "
                               f"than the profiled window {window}")
        return {"tokens": res and [res[u] for u in uids],
                "launches": launches,
                "wall_s": wall, "prefill": prefill, "steps": steps.count,
                "engine_steps": n_steps,
                "window_s": (bounds[window[1]] - bounds[window[0]]
                             if window else None),
                "window_launches": ({k: at[window[1]][k] - at[window[0]][k]
                                     for k in at[window[0]]}
                                    if window else None),
                "decode_s": steps.total, "summary": summary,
                "paged": eng.paged, "layers": cfg.n_layers,
                "stats": getattr(eng, "stats", {}), "device": device,
                "demoted": list(eng.demoted),
                "free_pages_ok": (not eng.paged or eng.pages.free_pages
                                  == eng.pages.n_pages - 1)}

    def _check_trace(self, phase, cfg, r, route, ff=None):
        """Log a trace's metrics and hold its launch counts: per layer one
        decode kernel per step (and per 1-token chunk), one flash_prefill
        per longer prefill call, and per prefill call and step the ff
        kernels ``ff`` ({kernel: launches per layer}; the megakernel once
        by default); every request drained with finite tokens."""
        n, pf = r["layers"], r["prefill"]
        counted = r["device"].type == "cuda"
        want = dict.fromkeys(self.wrappers, 0)
        if counted:
            calls = r["steps"] + pf["one"] + pf["many"]
            if route is not None:        # None: a model without attention
                decode = {"paged": "flash_decode_paged",
                          "dense": "flash_decode",
                          "int8": "flash_decode_paged_int8"}[route]
                want.update({decode: n * (r["steps"] + pf["one"]),
                             "flash_prefill": n * pf["many"]})
            want.update({k: v * n * calls for k, v in
                         (ff or {"dyad_ff_fused": 1}).items()})
        toks = r["tokens"]
        n_tok = sum(len(t) for t in toks)
        vocab = cfg.vocab_size
        tokens_ok = (all(t and all(0 <= x < vocab for x in t) for t in toks)
                     and r["free_pages_ok"])
        c, g, h = (r["summary"][k] for k in ("counters", "gauges",
                                              "histograms"))
        decode_tok = n_tok - len(toks)         # first tokens come from prefill
        log(phase, arch=cfg.name, layers=n, dtype=cfg.compute_dtype,
            kv=route or "none", device=r["device"].type,
            requests=len(toks),
            tokens=n_tok, distinct_tokens=len({x for t in toks for x in t}),
            wall_s=f"{r['wall_s']:.3f}",
            tok_s=f"{n_tok / r['wall_s']:.1f}",
            decode_steps=r["steps"], decode_s=f"{r['decode_s']:.3f}",
            decode_tok_s=f"{decode_tok / max(r['decode_s'], 1e-9):.1f}",
            prefill_calls=pf["one"] + pf["many"],
            prefill_s=f"{pf['s']:.3f}",
            prefill_tokens=pf["tokens"],
            prefill_tok_s=f"{pf['tokens'] / max(pf['s'], 1e-9):.1f}",
            ttft_ms_p50=f"{1e3 * h['ttft_s']['p50']:.2f}",
            ttft_ms_p99=f"{1e3 * h['ttft_s']['p99']:.2f}",
            decode_step_ms_p50=f"{1e3 * h['decode_step_s']['p50']:.2f}",
            prefix_hits=c.get("prefix_hits", 0),
            page_pool_used_max=g.get("page_pool_used", {}).get("max", 0),
            preemptions=c.get("preemptions", 0),
            launches=json.dumps({k: v for k, v in r["launches"].items()
                                 if v}, separators=(",", ":")),
            tokens_ok=tokens_ok)
        if counted and r["launches"] != want:
            log(phase, failed=f"launches {r['launches']} want {want}")
            return False
        if not tokens_ok:
            log(phase, failed="tokens out of range, empty or pages leaked")
        return tokens_ok

    def _same_tokens(self, label, cfg, params, prompts, got, want, tol,
                     device=None):
        """``got`` against ``want`` request by request: equal, or parting
        at a step whose top-2 logit margin, teacher-forced on ``want``'s
        tokens, is below ``tol`` x max(|logits|, 1)."""
        device = device or self.dev
        equal, ties, ok = 0, [], True
        for p, g, w in zip(prompts, got, want):
            if g == w:
                equal += 1
                continue
            step = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                        None)
            if step is None:                  # one stream is cut short
                ok = False
                continue
            margin, scale = _paged_margin(self.torch, cfg, params, p,
                                          w[:step], device)
            ties.append(f"{step}:{margin:.3e}/{tol * scale:.3e}")
            ok = ok and margin < tol * scale
        log("tokens", compare=label, requests=len(want),
            requests_equal=equal, first_divergence_margins=",".join(ties)
            or "none", ok=ok)
        return ok


def _smi_sampler():
    """Samples card 0's SM clock (MHz) and power draw (W) every 100 ms with
    one ``nvidia-smi`` process.  Returns ``stop()``, which ends it and
    gives ``(sm_mhz, power_w)`` as "min/median/max" strings, "not
    measured" where nvidia-smi gave no sample."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop():
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        cols = [[], []]
        for line in out.splitlines():
            try:
                vals = [float(v) for v in line.split(",")]
            except ValueError:
                continue
            if len(vals) == 2:
                cols[0].append(vals[0])
                cols[1].append(vals[1])
        return tuple(
            f"{min(c):.0f}/{statistics.median(c):.0f}/{max(c):.0f}" if c
            else "not measured" for c in cols)
    return stop


# A ReLU pre-activation within RELU_TIE x max(|its layer's|, 1) of zero
# on both devices is a tie (ROADMAP C.8): fp32 sums in another order may
# put it on either side.  The band is about the fp32 kernels' largest
# error against a float64 product at OPT's shapes (1.3e-6 to 2.8e-6 in
# phase 3's gate on an H100) and 3.6x the largest tie seen (2.8e-7); a
# step may hold at most RELU_TIES_MAX ties (the fp32 OPT steps of phases 8
# and 11 hold 2 and 1 on an H100): more, or one wider, fails the step
RELU_TIE = 1e-6
RELU_TIES_MAX = 2


@contextlib.contextmanager
def relu_branch(record=None, masks=None):
    """The ff's ReLU (``kernels.ref.ACTS``) with each call's
    pre-activations appended to ``record``, or each call on the branch of
    the next of ``masks`` (u * mask, whose gradient is the mask) instead
    of its own sign."""
    from repro_torch.kernels import ref

    relu = ref.ACTS["relu"]
    todo = iter(masks) if masks is not None else None

    def act(u):
        if record is not None:
            record.append(u.detach())
        if todo is None:
            return relu(u)
        return u * next(todo).to(u.dtype)

    ref.ACTS["relu"] = act
    try:
        yield
    finally:
        ref.ACTS["relu"] = relu


def relu_ties(u_dev, u_cpu) -> dict:
    """The ReLU units whose pre-activation the card and the CPU put on
    either side of zero: their count, whether they are ties (at most
    RELU_TIES_MAX of them, each within RELU_TIE x max(|layer|, 1) of zero
    on both devices), the CPU's branches with just those units flipped
    (``masks``, one a call), and up to four units as call/index:card
    value/CPU value."""
    diff, units, masks, all_ties = 0, [], [], True
    for i, (a, b) in enumerate(zip(u_dev, u_cpu)):
        a = a.cpu()
        flip = (a > 0) != (b > 0)
        masks.append((b > 0) ^ flip)
        n = int(flip.sum())
        if not n:
            continue
        diff += n
        bound = RELU_TIE * max(float(b.abs().max()), 1.0)
        worst = max(float(a[flip].abs().max()), float(b[flip].abs().max()))
        all_ties = all_ties and worst <= bound
        for idx in flip.nonzero()[:4 - len(units)].tolist():
            units.append(f"{i}/{'.'.join(map(str, idx))}:"
                         f"{float(a[tuple(idx)]):.3e}/"
                         f"{float(b[tuple(idx)]):.3e}")
    return {"differences": diff,
            "all_ties": all_ties and diff <= RELU_TIES_MAX,
            "masks": masks, "units": ",".join(units) or "none"}


def rel_err(got, want):
    """Largest |got - want| of any leaf over max(|want leaf|, 1e-3)."""
    from repro_torch import tree

    return max(float((a.cpu().float() - b.cpu().float()).abs().max())
               / max(float(b.float().abs().max()), 1e-3)
               for a, b in zip(tree.leaves(got), tree.leaves(want)))


def _finite(grads):
    from repro_torch import tree

    return all(bool(g.isfinite().all()) for g in tree.leaves(grads))


def _log_profile(prof, wall_ms: float, phase: str, top_n: int = 10) -> dict:
    """Device-busy time of a profiled run against the unprofiled wall time
    of the same work, and the kernels that took the most device time.
    Returns {kernel name: (device ms, launches)}, empty without device
    events."""
    per_kernel = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            per_kernel[ev.key] = (us / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    if busy_ms <= 0:
        log(phase, device_busy_ms="not measured (no device events)")
        return {}
    # the copy kernels, among them the casts of the fp32 params to the
    # compute dtype in every call
    copies = [(ms, cnt) for name, (ms, cnt) in per_kernel.items()
              if "copy" in name.lower()]
    log(phase, device_busy_ms=f"{busy_ms:.3f}",
        unprofiled_wall_ms=f"{wall_ms:.3f}",
        device_busy_share=f"{busy_ms / wall_ms:.3f}",
        device_kernel_launches=sum(c for _, c in per_kernel.values()),
        copy_kernel_launches=sum(c for _, c in copies),
        copy_kernel_ms=f"{sum(ms for ms, _ in copies):.3f}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    for name, (ms, cnt) in top:
        log(phase, kernel=repr(name[:70]), ms=f"{ms:.3f}", calls=cnt,
            share_of_busy=f"{ms / busy_ms:.3f}")
    return per_kernel


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _scale_ff(params, scale: float):
    """``params`` with every DYAD weight (w1, w2) of the ff modules (an
    encoder's too), the routed experts and the shared expert multiplied
    by ``scale``."""
    def walk(node):
        return {k: (walk(v) if isinstance(v, dict)
                    else v * scale if k in ("w1", "w2") else v)
                for k, v in node.items()}
    return dict(params, **{
        key: [{k: walk(v) if k in ("mlp", "moe") else v
               for k, v in lp.items()} for lp in params[key]]
        for key in ("layers", "enc_layers") if key in params})


def _trace(vocab: int, seed: int, spec):
    """The continuous path's requests, drawn from ``seed``: one shared
    prefix, then per request a tail length and a token budget."""
    import numpy as np

    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, spec["prefix"])
    lo, hi = spec["tail"]
    prompts = [np.concatenate([head, rng.integers(0, vocab, n)])
               .astype(np.int32)
               for n in rng.integers(lo, hi + 1, spec["requests"])]
    lo, hi = spec["max_new"]
    return prompts, [int(m) for m in rng.integers(lo, hi + 1,
                                                  spec["requests"])]


def _match_rate(got, want) -> float:
    """Share of ``want``'s tokens that ``got`` matches position by
    position."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return same / max(sum(len(w) for w in want), 1)


def _paged_margin(torch, cfg, params, prompt, toks, device):
    """(top-2 margin, max(|logits|, 1)) of the logits after ``prompt +
    toks``, teacher-forced through one paged prefill (int8 pools when the
    config says so): the logits that chose the next token."""
    import numpy as np

    from repro_torch.models import model

    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(toks, np.int64)])
    P = 16
    NB = -(-len(seq) // P)
    with torch.no_grad():
        cache = model.init_cache(cfg, 1, NB * P, torch.float32, device,
                                 page_size=P, n_pages=1 + NB)
        cache[0]["kv"]["block_table"].copy_(torch.arange(
            1, 1 + NB, dtype=torch.int32)[None])
        logits, _ = model.prefill(cfg, params, cache, torch.as_tensor(
            seq, device=device)[None])
    last = logits[0, -1].float()
    top2 = last.topk(2).values
    return (float(top2[0] - top2[1]),
            max(float(last.abs().max()), 1.0))


def _top2_margin(model, cfg, params, prompts, toks, step: int,
                 max_len: int, frames=None) -> float:
    """Gap between the two largest CPU logits at generation step ``step``,
    teacher-forced on the CPU's own tokens (an encoder-decoder's over its
    ``frames``): a gap under the logit tolerance makes a differing greedy
    token a tie, not a fault."""
    import torch

    with torch.no_grad():
        cache = model.init_cache(cfg, prompts.shape[0], max_len,
                                 torch.float32, torch.device("cpu"))
        logits, cache = model.prefill(cfg, params, cache, prompts,
                                      frames=frames)
        for i in range(step):
            logits, cache = model.decode_step(cfg, params, cache,
                                              toks[:, i:i + 1])
        top2 = logits[:, -1].topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


if __name__ == "__main__":
    sys.exit(main())
