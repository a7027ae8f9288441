#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`euler_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PREFIX]

Builds the port's CUDA kernels from `euler_tpu_torch/csrc/` (nvcc, sm_90a,
one process per source, all at once, into build/euler_tpu_torch/), then:
  1. checks the main path end to end at 64², and the same with each other
     marker route (`fuse_marker_pass=False`: K5 + K6;
     `marker_padded_store`: K4): the port on the GPU (kernels) against the
     port on the CPU (plain PyTorch versions), 2 frames;
  2. builds the 1024² dam break and advances it 4 warm-up frames;
  3. holds each kernel against its plain version on the card, on that
     state: K1 marker pass and K4 padded marker pass (the whole store
     bitwise, dead slots' zeros included), K5 march and K6 re-bin (the
     whole store bitwise; K6 also on an alive plane with holes), K2
     substep grid half, K3 MG-PCG solve (cold, warm, and capped at 3
     iterations, which it must take exactly; the Galerkin hierarchy and
     Chebyshev rows it builds bitwise equal to `mg_host_operands`; its
     coarse cycle in one launch a visit bitwise equal to one launch per
     level operation), K7 grid stage (bitwise, and its rainbow form's four
     planes), K8 Jacobi-PCG solve, K9 Jacobi projection, K10 Jacobi substep
     (and the stream syncs of one K8 and one K10 solve);
  4. times 20 frames of the main path (dam break, slot markers K=8,
     Galerkin MG-PCG to tol_rel 1e-4 with warm start, fused projection),
     with its peak device memory;
  5. times 20 frames of the Jacobi speed mode (`bench.py --precon
     jacobi`: 100 iterations, tol 1e-6, tol_rel 1e-6, no warm start) after
     4 warm-up frames;
  6. runs the secondary routes, 2 warm-up and 4 timed frames each:
     Jacobi unfused (K7, K8), Jacobi + rainbow (K7 in its rainbow form,
     K9), MG + rainbow (K7, K3), Jacobi unfused with `use_pallas_grid`
     (K7, K8), and the main path on the
     three marker routes from the same dam break, `marker_k1` (K1, K2,
     K3), `marker_unfused` (K5, K6, K2, K3) and `padded_store` (K4, K2,
     K3), the last two bitwise equal at their end to the first, the whole
     store included;
  7. times each kernel beside its plain version with CUDA events, and K5
     and K6 also on that state's markers in a store of 16 slots a cell;
  8. runs `bench.py --size 2048` (the main path's config at 2048², where
     the JAX package's size gates take the unfused grid stage, K7 on the
     card, and K11): 2 warm-up + 4 timed frames with its peak device
     memory, then K1 timed and K7 held bitwise and timed on that state,
     K11 (F = 2) against its plain version on that state,
     the hierarchy and rows it builds on the card bitwise equal to
     `stream_host_operands`, its stream syncs in one solve, K11 timed;
  9. runs `bench.py --size 4096 --precon jacobi` (K7 and K12): 1 warm-up
     + 2 timed frames with its peak device memory, then K1 timed and K7
     held bitwise and timed on that state, K12 and K11 (F = 4, with the
     MG config; its hierarchy bitwise as at 2048²) against their plain
     versions on that state, K12 timed;
 10. runs the text scenarios and the CLI: `python -m euler_tpu_torch
     scenarios/waterfall.txt --frames 50` (40 x 100, 60 sources: K1, S1,
     K7, K8), `... --size 1024x1024 --frames 4` (MG: K1, S1, K7, K3),
     `preset:dam_break --size 1024x1024 --frames 20` (K1, K2, K3), and
     where the MG levels need padding, `scenarios/waterfall.txt --size
     1080x1920 --frames 4` (K1, S1, K7, P3; no K2, K3, K4, K10 or K11)
     and `preset:dam_break --size 1200x1200 --frames 4` (K1, K7, P3),
     each as a process of its own (exit 0, its frames/s line) and in
     process (a warm-up frame, then the counted frames: no K2, K10 or K4
     with sources; P3 once a substep; the 1024² and 1080 x 1920
     waterfalls' div_inf off their source cells <= 1, the source cells
     keeping their inflow's divergence as in the JAX package, the 1200²
     dam break's <= 1); P3 against its plain version on the last two
     states (cold, warm, capped at 3 iterations, which it must take
     exactly; its hierarchy and rows bitwise against
     `mg_host_operands`, its coarse cycle bitwise against one launch per
     level operation) and timed at both; the waterfall on the
     card against the CPU, 2 frames (counts, alive, drops, RNG and
     colours bitwise, u and v within 5e-3); S1 bitwise against its plain
     version on the developed waterfall states (as they are, inactive,
     and exhausted part-way), and timed; K1 and K7 bitwise and K8 to its
     check at 40 x 100 and 40 x 99; draw_frame and
     draw_frame_downsampled of card states byte-equal to the CPU's
     render; a checkpoint round trip and resume on the card; then f64
     MG on one card (`run_f64_mg`): the CLI's converged 1024² dam break
     (K1, K7, P3) and 1080 x 1920 waterfall (K1, S1, K7, P3) with
     solver.dtype "float64", 1 warm-up frame on a copy and 2 timed frames
     beside the f32 config's (div_inf <= 1, off the sources on the
     waterfall; P3 once a substep; no K2, K3, K11 or plain version), P3
     in f64 against its plain version on the f64 states (cold, warm,
     capped at 3, which it must take exactly: the same iterations, p
     within 1e-8 of scale), its hierarchy, rows and packed level 0
     bitwise `mg_host_operands` in f64, its coarse cycle bitwise one
     launch per level operation, its plan (the coarse cycle from 64² at
     1024², where f32's starts at 128²), and timed beside its plain
     version and P3 in f32 on the f32 state's system (its device time is
     taken by the profiler at the end of the run);
 11. runs the global marker layout and the general solve: `python -m
     euler_tpu_torch scenarios/filter.txt --no-pallas --frames 50` (the
     reference's configuration: G1, G2, K7, K8, each once a substep) as a
     process and in process with the CLI's other runs; G1 (the march with
     the dt carry) and G2 (the refresh) bitwise against their plain
     versions on filter.txt past frame 26 (its own dt, and dt = 1, where
     the carry takes up to its 16 passes; G2 also with 5% of the markers
     doomed) and on the 1024² global dam break; S1's global form bitwise
     (as is, inactive, exhausted part-way); P1 against its plain version
     (f64 Jacobi, none and IC(0) at 40 x 100 to 1e-9 of scale, f32 Jacobi
     at 2204², beyond K8's gate with 2204 % 8 = 4, to 5e-4; iterations
     within 1); P2's apply at 40 x 100 and 256² to relative 1e-12; the
     1024² global dam break, 2 warm-up + 4 timed frames with f32 Jacobi
     (G1, G2, K7, K8) and f64 Jacobi (P1), with their syncs and peak
     memory; 2 frames of the IC(0) path at 40 x 100 (P1, P2); G1, G2, P1
     and P2 timed beside their plain versions (P2 at 40 x 100 and 256²);
 12. runs the single-card batch and the diagnostics: 8 dam breaks
     (seeds 0-7) at the main path's config through `HostBatchRunner`
     (bench.py --batch 8), 1 warm-up + 4 timed frames, with its aggregate
     cell-steps/s, peak memory and the MG workspace cache (one entry for
     the 8); K1, K2 and K3 8 x 8 x 4 times and no plain version;
     instances 0 and 7 stepped alone, every field bitwise equal to the
     batch's, instance 0 timed alone; the five text scenarios at 40 x 100
     (sources padded) through `step_frame_batched` on the card against
     the CPU, 2 frames (K1, S1, K7, K8 once a substep an instance; counts,
     alive, drops, RNG bitwise, u and v within 5e-3); `python -m
     euler_tpu_torch scenarios/waterfall.txt --frames 50` as a process,
     twice with `--sherlock` and twice without, in turn (exit 0, the
     frames/s of each); in process, a NaN in u raises FloatingPointError,
     the trap makes one torch sync a frame and none when off (torch's
     sync debug mode), the frame timed with it on and off;
     `dump_pressure_system` of a card state equal to the CPU's text; a
     `profiler_trace` of a frame holding K1's kernel;
 13. runs K1 per row shard (M12's row-sharded marker pass): the dam
     break at 256² and 1024², 3 frames on, cut into 4 and into 2 row
     shards, each shard's rows with 8 rows of each neighbour (what
     `parallel/cuda_shard.exchange_rows` delivers to a rank), K1 launched
     on each with clamp_ny = Y and row_offset = r Yl - 8: each shard
     bitwise its plain version, the interiors bitwise the unsharded K1
     (slots, counts, drops); the 4 and the 2 shards' launches at 1024²
     timed (device ms summed, beside the unsharded launch's and each
     shard's byte bound); then on a one-rank NCCL group (a `file://`
     store): 2 frames of the 1024² dam break with
     `make_sharded_marker_pass` in `step_frame` (K1 on [16, 1040, 1024],
     row_offset -8: once a substep, K2, K3, no plain version; every field
     bitwise the unsharded frames), `make_sharded_step` on the batch of 8
     for 2 frames (K1 and K2 8 x 8 x 2 times; bitwise
     `step_frame_batched`), `make_dp_substep_mg` bitwise
     `project_substep_mg`;
 14. runs the frame on row blocks (M12 part c), each block of a grid one
     thread of an in-process `comm.LocalGroup` on the card: P4 (the
     sharded PCG) on 1, 2 and 4 row blocks of the 1024² substep system,
     Jacobi at the speed mode's budget and block MG to tol_rel 1e-4,
     timed (CUDA events) and profiled (the summed spans of P4's kernels,
     after the column phase), against the unsharded P1 / P3 and (4
     blocks) the plain P4,
     and on a one-rank NCCL group bitwise the 1-block solve; K7 and S1
     on 4 row blocks at 1024², each block bitwise its plain version and
     the interiors bitwise the unsharded kernel, timed; the waterfall
     (Jacobi budget) and the dam break (speed mode) at 1024² on 4 blocks,
     1 + 2 frames (K1, S1, K7, P4 once a block a substep, no plain
     version), against 1 block of the same code (at most 4 cells'
     counts apart, every velocity within 1e-3); the 40 x 100 waterfall
     on 4 blocks of 10 rows, card against CPU (plain versions); then the
     frame on 2 x 2 ("y", "x") blocks (M12 part d's column blocks): K1,
     K7 and S1 on the blocks padded with 8 rows and columns at 1024²
     (`clamp_nx` / `col_offset`), each block bitwise its plain version
     and the cropped outputs bitwise the unsharded launch, timed (device
     ms summed beside one launch's); P4 (Jacobi, 100 iterations) on 2 x 2
     blocks of the substep system, its iterations those of 1 block, p
     within 1e-4 of scale, against the plain P4, timed and profiled; the
     1024² waterfall and dam break on 2 x 2 blocks against 1 block (at
     most 4 cells' counts apart, every velocity within 1e-3); the 40 x
     100 waterfall on 2 x 2 blocks of 20 x 50, card against CPU; then the
     frame's global MG solve on blocks (M12 part d item 1: P5,
     `parallel/spatial_mg.py`) on the 1024² substep system: on 1 x 1
     blocks bitwise P3 (`solve_pressure_general` called directly; p,
     iterations, residual; cold and warm), on 2 x 2 and 4 x 1 blocks its
     hierarchy, Chebyshev rows and one cycle bitwise P3's, its iterations
     within 1 of P3's and p within 5e-4 of scale, P3 and P5 timed cold
     and warm (CUDA events), the plain P5 once (2 x 2, warm); the 1024²
     MG waterfall and dam break on 2 x 2 blocks against 1 block, 2
     frames (K1, S1, K7, P5 once a block a substep, no P4 and no plain
     version; the waterfall at most 4 cells' counts apart and every
     velocity within 1e-3, each frame's figures logged); then the
     frame's global IC(0) solve on blocks (M12 part d item 2: P6,
     `parallel/spatial_ic0.py`) on the developed 256² IC(0) dam break
     (the golden solve, f64, cap 400): E_inv and one application on 2 x 2
     and 4 x 1 blocks bitwise P2's, f64 and f32; on 1 x 1 blocks bitwise
     P1 + P2 (p, iterations, residual; cold and warm), on 2 x 2 and 4 x 1
     iterations within 1 and p within 1e-9 of scale, each solve timed
     (CUDA events) beside P1 + P2; P6 against its plain version on the
     same card tensors at 40 x 100 on 2 x 2 blocks, both timed; the 256²
     dam break on 2 x 2 blocks, 2 frames, and on 4 x 1, 1 frame, against
     1 block (K1, K7, P6 once a block a substep, no P1, P4 or plain
     version; `frames_agree`); one cold solve of the 1024² system in f64
     on 2 x 2 blocks, timed beside P1 + P2; then rainbow colour and the
     global marker layout on 2 x 2 blocks (M12 part d): K7's
     extrapolated form on the padded blocks at 1024², each block bitwise
     its plain version and its four cropped outputs bitwise the
     unsharded launch's, timed, and `advect_p` on the padded blocks
     bitwise the whole plane's; the 1024² rainbow MG waterfall and dam
     break (K1, S1, K7, P5) against 1 block, 2 frames timed after 1
     warm-up frame on a copy of the start (`frames_agree`, colours
     within 5e-3); the 1024² global dam
     break with an f64 Jacobi solve (G1 and G2 on the gathered grid on
     every block, K7, P4) against 1 block, likewise: 0 cells apart, the
     store, alive mask, counts and RNG bitwise; G1 and G2 on the blocks'
     state bitwise their plain versions, their 4 launches (the whole
     grid's, each) on the device beside one launch; S1's global form on
     the blocks of the 1024² global waterfall bitwise its plain version
     and the whole grid's launch on each block's cells, timed; filter.txt
     and waterfall.txt in the reference's configuration (global, rainbow,
     `--no-pallas`) at 40 x 100 on 2 x 2 blocks, 3 frames, card against
     CPU (counts, alive, store order, drops, RNG bitwise; velocities,
     colours, positions within their tolerances); MG on blocks of an odd
     side (`run_odd_blocks`: P5 gathering at level 0 on 8 row blocks of
     1080 x 1920 and 3 x 3 of 999², P4's padded block MG, K1 / K7 / S1
     at odd row offsets, the 1080 x 1920 MG waterfall on 8 blocks); f64
     MG on blocks (`run_f64_blocks`: P5-f64 against P3-f64 on the f64
     1024² and 1080 x 1920 systems on 1 x 1, 2 x 2 and 8 x 1 blocks,
     cold and warm, bitwise on 1 x 1 and at gather level 0, else the
     same iterations and p within 1e-10 of scale, against its plain
     version, its plans and workspace bytes, timed beside P3-f64 and the
     f32 layout; P4's f64 block MG on 8 x 1 and 2 x 2 against its plain
     loop; the f64 1080 x 1920 MG waterfall on 8 x 1 blocks and 1024²
     dam break on 2 x 2 against 1 block); RB-GS and rediscretized MG on
     one card (`run_mg_smoothers`, after every other timed phase, on the
     CLI's 1024² dam break and 1080 x 1920 waterfall stepped as its
     in-process runs step them): 2 frames of the dam break with
     mg_smoother "rbgs" (K1, K7, P3) and with mg_scheme "rediscretize"
     (K1, K7, P7), each once a substep, no K2, K3, K11 or plain version,
     div_inf <= 1 (the solves that stopped at their cap counted); on
     those frames' end state and the waterfall's, P3-rbgs and P7
     against their plain versions (cold and warm: p within 5e-4 of
     scale, iterations within 1; f64 warm, both stopped at a residual of
     1e-10: 1e-10 of scale, iterations within 1), P7's hierarchy (masks,
     a_diag, inv_diag) bitwise `build_hierarchy` and one V-cycle at `v_cycle`'s
     (1e-6 / 1e-12 of scale), P3-rbgs's coarse cycle bitwise one launch
     per half-sweep and level operation, both in f32 and f64; capped at 3
     (exactly 3); each timed beside its plain version at 1080 x 1920;
     last, P4's, P5's, P6's, the f64 blocks', P3's (and P1 + P2's),
     P3-rbgs's and P7's device time from one profiled
     solve each: a profiler session over the blocks' threads slowed
     later host launches, so nothing is timed after it;
 15. runs the card tests, six pytest processes (`CARD_TESTS`, -k
     selections) started at once on the card after every timed phase:
     the Jacobi, marker, grid-stage and source card tests of
     tests/test_torch_cuda.py (K8's
     caps, non-finite and zero RHS on K8-K10, workspace reuse, two grids
     in turn; K1 and K4 on ragged grids at K = 4, 8 and 16, K5 and K6 at
     K = 8 and 16 (K6 also on alive planes with holes), bitwise; one
     launch a marker kernel call; the unfused passes keep the kernels'
     store as the state's; K7 bitwise on ragged grids and under other
     tiles, one launch a call, and K2's and K10's grid stage bitwise
     K7's; S1 bitwise on seeded cases; the waterfall card vs CPU), then
     tests/test_torch_cuda_global.py and the parity corpora on the card:
     tests/goldens to frame 50 (counts exact, u and v within 5e-3) and
     tests/goldens/ref_binary byte for byte to the JAX test's horizons,
     then P3's card tests that the P3 phase above does not repeat
     (tests/test_torch_cuda_mg_padded.py: 999², the 2160 x 3840
     hierarchy, a zero RHS and the cap, the workspace per grid, and every
     f64 case: the solves, hierarchies and cycles in f64 and the f64
     plan), P3-rbgs's and P7's (tests/test_torch_cuda_mg_rbgs.py: 999²
     and 1080 x 1920 in f32 and f64, P7's hierarchy and one V-cycle, a
     zero RHS and the cap, P3-rbgs's plan and its workspace apart from
     the Chebyshev one; tests/test_torch_cuda.py: P3-rbgs's coarse cycle
     bitwise one launch per operation at 256²), then the
     batch's (tests/test_torch_cuda_batch.py: each instance of an
     interleaved batch bitwise equal to it alone, on every solver
     workspace: K2/K3, K10, P3, K8, G1/G2 with K8, P1), then K1's
     row-shard card tests (tests/test_torch_cuda_shard.py: 2 and 4
     shards of the 256² dam break and of seeded full stores at 200 x 136,
     K = 8, and 120 x 72, K = 16, bitwise; the identity arguments), the
     row-block card tests there (K7 and S1 on row blocks bitwise, P4
     against its plain version, the 40 x 100 waterfall on 4 blocks card
     vs CPU), the column-block ones (K1, K7, S1 on 2 x 2 blocks bitwise,
     the 40 x 100 waterfall on 2 x 2 blocks card vs CPU), P5's (its
     hierarchy and a cycle on 2 x 2 and 4 x 1 blocks of the 256² system
     bitwise P3's, 1 x 1 blocks bitwise P3, the 64² MG dam break on 2 x 2
     blocks card vs CPU; in f64 too: the hierarchy and a cycle, 1 x 1
     bitwise P3-f64, the f64 plans of P4 and P5 at 1024²), P6's (its
     sweeps on 2 x 2 and 4 x 1 blocks of
     the 256² system bitwise P2's, 1 x 1 blocks bitwise P1 + P2, 40 x 100
     against its plain version, the 64² IC(0) dam break on 2 x 2 blocks
     card vs CPU) and `dryrun_multichip(1, "nccl")` (a spawned NCCL
     rank).
With --profile, the CLI runs are profiled too, and each profile logs the device kernel time of a frame (the
sum of kernel spans) and the idle share it leaves, as before; beside them
the device busy time (the union of kernel spans, which counts the
overlapping spans of K8-K10's sweeps once) and its idle share; and the
mean span of a Jacobi sweep launch (K8-K10's and K12's sweep_a, sweep_b;
K8-K10's start while the sweep before them finishes, so their spans
include that wait and are not kernel times); and the grid-stage spans
(K7's tiled launch, alone or inside K2 or K10; one a substep, though
the profiler on the card now and then drops a span).
Each path runs with the launch counts set to 0 just before it and read
just after: its kernels must have launched (K7 once a substep) and no
plain version may have run.  Prints one JSON line of per-kernel results, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.  Exits
non-zero, with no result, on any failure or when no CUDA device exists.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

SIZE = 1024        # bench.py's default grid (the main path)
WARMUP_FRAMES = 4  # bench.py's default warm-up (early dam-break window)
FRAMES = 20        # timed frames of the main path and the speed mode
ROUTE_WARMUP = 2   # warm-up frames of each secondary route
ROUTE_FRAMES = 4   # timed frames of each secondary route
REPS = 5           # timed calls per kernel and per plain version
LARGE = {          # size: (preconditioner, warm-up frames, timed frames,
    2048: ("mg", 2, 4, 3),          # timed calls per kernel)
    4096: ("jacobi", 1, 2, 2),
}

SLOTS = 8          # slots_per_cell of every path here

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s
# and f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f64 outside the tensor cores: NVIDIA's H100 SXM data sheet (the measuring
# guide's table gives no f64 rate)
F64_FLOP_PER_S = 34e12

# What each kernel must do at least, per cell of the [Y, X] grid (n
# cells), from the sources: bytes with every input read once and every
# output written once, and f32 operations.  `iters` is the PCG iteration
# count the timed call needed; `live` the live markers of K1's store.
# Every marker kernel returns a whole new store, dead slots included
# (their zeros, or K5's copies), so its bytes count the whole store out;
# only the live positions are read (8 bytes each), but K5 reads all.
#   grid stage + RHS + tail (extrapolate, two bilinear samples per face
#   component, gravity, divergence, clamp, face update, maxsq): ~100 flops
#   a Jacobi-PCG iteration: 5-point apply 7, two dot products 4, two
#   axpys 4, preconditioner and direction update 3, max|r| 1: 20 flops
#   an MG-PCG iteration: the level-0 sweeps (~40) plus the coarse levels'
#   truncated-W visits (~20): 60 flops
#   a marker step: two bilinear samples and the position update: 28 flops
#   a re-bin test of a live marker (two scalings, floors, offsets): 6 flops
#   the grid stage alone (K7: extrapolate, four bilinear samples, gravity):
#   ~70 flops
# A Jacobi-PCG iteration of K8-K10 in the three-pass form (As = A s of
# the updated s) needs 9.5 [Y, X] plane passes at the fewest, with the
# byte operator code, s_k computed in the sweep that applies A to it, and
# p's update deferred (csrc/jacobi_pcg.cu: sweep A code, r, s_{k-1}, p in
# and s_k, As, p out; sweep B code, r, As in and r out): the HBM time of
# that traffic is their sweep bound, an upper bound on their floor (the
# live planes fit the L2).  K12's two sweeps move 10.5 planes an
# iteration (csrc/jacobi_stream.cu: sweep A code, r, s, As, p in and s,
# As, p out; sweep B code, r, As in and r out), the fewest its recurrence
# needs.  K11: its four fine sweeps
# move 17 (mg_stream_kernel.py), and the resident cycle below its root is
# K3's at the root's size less the PCG step, a root plane counting 1/F².
# K3 and K2 (the MG-PCG main path): `mg_sweep_planes` counts an iteration
# of the cycle schedule at the main path's level shapes; SWEEP_CALL_PLANES
# counts what a call moves once (head, hierarchy, warm start, tail).


def mg_sweep_planes(size: int = 1024, min_size: int = 32, w: int = 2,
                    w_depth: int = 2):
    """(per iteration, hierarchy build) traffic of the degree-1 MG-PCG
    (csrc/mg_levels.cuh, csrc/mg_pcg.cu) in [Y, X] f32 plane equivalents:
    each operation reads its input planes once and writes its outputs
    once, a level-l plane counting 4^-l.  The operator is 1 plane at
    level 0 (packed) and 3 above (c, e, n).  Per visit of level l:
    pre-smooth + restriction (b, A in; x, b_c out), a restriction per
    extra visit (b, x, A in; b_c out), a prolongation per visit (z_c, x in,
    x out, and the packed plane at level 0), the post-smooth (b, x, A in;
    z out); the coarsest solve (b, c, e, n in; x out); and at level 0 the
    PCG step (z, s, As, packed in, s, As out; p, r, s, As in, p, r out).
    At 1024² (six levels, W at levels 0 and 1): level 0 29 planes, level 1
    2 x 21 level-1 planes (10.5), level 2 4 x 13.5 (3.375), level 3
    (0.84), level 4 (0.21), level 5 4 x 5 (0.02): ~43.95 planes, 184 MB.
    The hierarchy: level 0's Gershgorin pass (1), then per coarse level
    the finer level's operator and active flags in and its own out."""
    sizes = [size]
    while sizes[-1] > min_size:
        sizes.append(sizes[-1] // 2)
    L = len(sizes)

    def cycle(l):
        s = 4.0 ** -l
        if l == L - 1:
            return 5 * s
        a = 1 if l == 0 else 3
        visits = w if (l < w_depth and l + 1 < L - 1) else 1
        own = ((2 + a + 0.25) + (visits - 1) * (2 + a + 0.25)
               + visits * (2.25 + (1 if l == 0 else 0)) + (3 + a))
        return own * s + visits * cycle(l + 1)

    hier = 1 + sum((1 if l == 0 else 3.25 * 4.0 ** -l)
                   + 3.25 * 4.0 ** -(l + 1) for l in range(L - 1))
    return cycle(0) + 12, hier


K11_SIZE, K11_F = 2048, 2  # where K11 is timed: the 2048² path, root 1024²
SWEEP_PLANES = {"K8": 9.5, "K9": 9.5, "K10": 9.5, "K12": 10.5,
                "K11": 17 + (mg_sweep_planes(K11_SIZE // K11_F)[0] - 12)
                / K11_F ** 2,
                "K3": mg_sweep_planes()[0], "K2": mg_sweep_planes()[0]}
# once a call, besides the hierarchy: K3's head (a_diag i32 and fluid u8
# in, packed out: 2.25; b and x0 copied in: 4), init (r in, s and As out:
# 3), warm start (mask 3, residual 4), p copied out (2); K2's grid passes
# (A 4.75, B 4.5), RHS (6.5), init 3, warm start 7, tail (clamp 2.25,
# face update 5.5); K11's head (a_diag i32 and fluid u8 in, packed out:
# 2.25; b copied in: 2), init (r in, p, s and As out: 4), p copied out (2)
SWEEP_CALL_PLANES = {"K3": 18.25 + mg_sweep_planes()[1],
                     "K2": 33.5 + mg_sweep_planes()[1],
                     "K11": 10.25 + mg_sweep_planes(K11_SIZE)[1]}
GRID_FLOPS = 100
GRID_STAGE_FLOPS = 70
JACOBI_FLOPS = 20
MG_FLOPS = 60
MARKER_FLOPS = 28
REBIN_FLOPS = 6
SOURCE_OPS = 10       # a source's test and colour write
SOURCE_EMIT_OPS = 40  # two xorshift64* draws, two positions, the writes
IC0_FLOPS = 16        # E_inv build 6, forward solve 5, back solve 5 a cell
# operations a level-0 cell of an iteration of P3-rbgs and of P7: the
# loop's JACOBI_FLOPS and the cycle's (`rbgs_cycle_ops`), set by
# `run_mg_smoothers` from the timed system's levels
RBGS_FLOPS: dict = {}
GLOBAL_PER_CELL = 4   # markers_per_cell: the global store has 4 slots a cell
# the f64 kernels' operations count against the f64 rate
FLOP_RATES = {"P1": F64_FLOP_PER_S, "P2": F64_FLOP_PER_S,
              "P6": F64_FLOP_PER_S, "P3_f64": F64_FLOP_PER_S,
              "P4_f64": F64_FLOP_PER_S, "P5_f64": F64_FLOP_PER_S}
BOUNDS = {
    # u, v f32; fluid, solid, dead u8; count i32 in; live positions in;
    # the whole store, count, drop i32 out (K4: the same on the padded
    # store's interior)
    # (k: slots a cell)
    "K1": lambda n, iters, live, k=SLOTS: (23 * n + 8 * live + 8 * k * n,
                                           MARKER_FLOPS * live),
    "K4": lambda n, iters, live, k=SLOTS: (23 * n + 8 * live + 8 * k * n,
                                           MARKER_FLOPS * live),
    # u, v f32; fluid, solid u8; count i32 in; the whole store in and out
    # (the dead slots are copied through)
    "K5": lambda n, iters, live, k=SLOTS: (14 * n + 16 * k * n,
                                           MARKER_FLOPS * live),
    # alive [K] and dead u8 in; live positions in; alive' [K] u8, the
    # whole store, count, drop i32 out
    "K6": lambda n, iters, live, k=SLOTS: ((k + 1) * n + 8 * live
                                           + (9 * k + 8) * n,
                                           REBIN_FLOPS * live),
    # u, v, p0 f32; fl, pfl, so u8 in; u2, v2, p f32 out
    "K2": lambda n, iters, live: (27 * n, (GRID_FLOPS + MG_FLOPS * iters) * n),
    # b, x0 f32; a_diag i32; fluid u8 in; p f32 out
    "K3": lambda n, iters, live: (17 * n, MG_FLOPS * iters * n),
    # b f32; a_diag i32; fluid u8 in; p f32 out
    "K8": lambda n, iters, live: (13 * n, JACOBI_FLOPS * iters * n),
    # ut, vt f32; fluid, solid u8 in; u2, v2 f32 out
    "K9": lambda n, iters, live: (
        18 * n, (GRID_FLOPS // 4 + JACOBI_FLOPS * iters) * n),
    # u, v f32; fl, pfl, so u8 in; u2, v2 f32 out
    "K10": lambda n, iters, live: (
        19 * n, (GRID_FLOPS + JACOBI_FLOPS * iters) * n),
    # u, v f32; fl, pfl, so u8 in; ut, vt f32 out
    "K7": lambda n, iters, live: (19 * n, GRID_STAGE_FLOPS * n),
    # b f32; a_diag i32; fluid u8 in; p f32 out
    "K11": lambda n, iters, live: (13 * n, MG_FLOPS * iters * n),
    "K12": lambda n, iters, live: (13 * n, JACOBI_FLOPS * iters * n),
    # n = S sources, live = markers emitted: each source's (y, x), valid
    # and count read, its r, g, b written; each emission's position,
    # alive byte and count written; ~20 bytes of scalars (RNG, counts,
    # flags).  Integer and f32 operations (hsv_basis, two RNG draws an
    # emission), counted against the f32 rate
    "S1": lambda n, iters, live: (25 * n + 13 * live + 20,
                                  SOURCE_OPS * n + SOURCE_EMIT_OPS * live),
    # n cells, M = 4 n slots; iters = march passes: u, v f32, fluid, solid
    # u8; the store [2, M] f32 and alive u8 in, the store out; a march of
    # every live marker a pass
    "G1": lambda n, iters, live: (
        10 * n + 17 * GLOBAL_PER_CELL * n, MARKER_FLOPS * live * iters),
    # sink, solid u8; the store and alive in; the store, alive, counts i32
    # out; a cell test of every live marker
    "G2": lambda n, iters, live: (
        6 * n + 18 * GLOBAL_PER_CELL * n, REBIN_FLOPS * live),
    # f64: b f64, a_diag i32, fluid u8 in; p f64 out
    "P1": lambda n, iters, live: (21 * n, JACOBI_FLOPS * iters * n),
    # f64: a_diag i32, fluid u8, r f64 in; z f64 out
    "P2": lambda n, iters, live: (21 * n, IC0_FLOPS * n),
    # b, x0 f32; a_diag i32; fluid u8 in; p f32 out (P1's loop and the MG
    # cycle: K3's operations an iteration)
    "P3": lambda n, iters, live: (17 * n, MG_FLOPS * iters * n),
    # P3 in f64: b, x0 f64; a_diag i32; fluid u8 in; p f64 out (f32's
    # floating planes doubled), its operations at the f64 rate
    "P3_f64": lambda n, iters, live: (29 * n, MG_FLOPS * iters * n),
    # P3 with RB-GS: b, x0 f32; a_diag i32; fluid u8 in; p f32 out
    "P3_rbgs": lambda n, iters, live: (
        17 * n, RBGS_FLOPS["P3_rbgs"] * iters * n),
    # P7: b, x0 f32; a_diag i32; fluid, solid u8 in; p f32 out
    "P7": lambda n, iters, live: (18 * n, RBGS_FLOPS["P7"] * iters * n),
    # b f32; a_diag i32; fluid u8 in; p f32 out (P1's loop on blocks)
    "P4": lambda n, iters, live: (13 * n, JACOBI_FLOPS * iters * n),
    # P3's work on the same grid, whatever layout computes it
    "P5": lambda n, iters, live: (17 * n, MG_FLOPS * iters * n),
    # block MG on a block: b f32, a_diag i32, fluid u8 in, p f32 out; a
    # cycle an iteration (K3's operations a cell)
    "P4o": lambda n, iters, live: (13 * n, MG_FLOPS * iters * n),
    # the same in f64 (b, p f64), its operations at the f64 rate
    "P4_f64": lambda n, iters, live: (21 * n, MG_FLOPS * iters * n),
    # P3-f64's work on the same grid, whatever layout computes it
    "P5_f64": lambda n, iters, live: (29 * n, MG_FLOPS * iters * n),
    # P1 + P2's on the same grid (f64: b, a_diag i32, fluid u8 in; p out),
    # a loop iteration and an IC(0) application an iteration; its
    # dependent diagonal steps are logged beside it
    "P6": lambda n, iters, live: (21 * n,
                                  (JACOBI_FLOPS + IC0_FLOPS) * iters * n),
}


def window(rows: int, cols: int, before: int, after: int,
           split: bool) -> int:
    """The cells of a block of rows x cols cells with `before` cells
    before it and `after` after it along the rows, and along the columns
    too where `split` (column blocks; a row block spans the grid's
    width)."""
    return (rows + before + after) * (cols + (before + after) * split)


def k7_blocks_bound(rows: int, cols: int, n: int, split: bool):
    """(bytes, operations) of K7 on n blocks of rows x cols cells: each
    block reads the cells its own cells depend on (u, v with 2 of each
    neighbour's, the three masks with 2 before and 3 after:
    grid_stage.cuh's window) and writes its own cells of ut, vt once."""
    nbytes = n * (8 * window(rows, cols, 2, 2, split)
                  + 3 * window(rows, cols, 2, 3, split) + 8 * rows * cols)
    return nbytes, GRID_STAGE_FLOPS * n * rows * cols


def k1_blocks_bound(rows: int, cols: int, live: int, n: int,
                    k: int = SLOTS, split: bool = True):
    """(bytes, operations) of K1 on n blocks of rows x cols cells (column
    blocks; row blocks without `split`), `live` the live markers of the
    blocks' one-cell rings summed: each
    block reads what its own cells' arrivals depend on (the markers homed
    one cell around them, their positions and counts; u, v and solid
    within their 3x3 windows, 2 cells around; fluid 2 before and 3 after
    for the u/v properties; dead on its own cells) and writes its own
    cells' store, count and drop once; every live marker of a ring is
    marched."""
    nbytes = n * (8 * window(rows, cols, 2, 2, split)
                  + window(rows, cols, 2, 3, split)
                  + window(rows, cols, 2, 2, split)
                  + 4 * window(rows, cols, 1, 1, split)
                  + rows * cols * (1 + 8 * k + 8)) + 8 * live
    return nbytes, MARKER_FLOPS * live


def s1_blocks_bound(S: int, emitted: int, n: int):
    """(bytes, operations) of S1 on n blocks: every block reads the
    source list (y, x, valid), the all-reduced [S] counts and the
    scalars, and walks every source and emission; the colours of the S
    source cells and each emission's position, alive byte and count are
    written once, by the block that owns the cell."""
    nbytes = n * (13 * S + 20) + 12 * S + 13 * emitted
    return nbytes, n * (SOURCE_OPS * S + SOURCE_EMIT_OPS * emitted)


# P4's sweeps an iteration, at the fewest bytes its kernels move a cell
# (pcg_loop.cuh): Ad = A d (code, d in; ad out: 9), p and r (p, d, r, ad
# in; p, r out: 24), z and <z, r> (r, code in; z out: 9), d (z, d in; d
# out: 12)
P4_SWEEP_BYTES = 54
KERNELS = {
    "K1": ("marker_pass", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/marker_fused_kernel.py:941"),
    "K4": ("marker_pass_padded", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/marker_fused_kernel.py:1030"),
    # K1 per row shard: a call is the 4 shards' launches of the 1024² plane
    # (clamp_ny / row_offset); launches from the one-rank NCCL frames
    "K1s": ("marker_pass_row_shards", "euler_tpu_torch/csrc/marker_pass.cu",
            "euler_tpu/ops/pallas/marker_fused_kernel.py:941 "
            "(march_rebin_pallas with clamp_ny / row_offset, a launch per "
            "row shard: euler_tpu/parallel/pallas_shard.py:65 "
            "make_sharded_march_rebin)"),
    "K5": ("marker_march", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/marker_kernel.py:332"),
    "K6": ("marker_rebin", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/rebin_kernel.py:174"),
    "K2": ("substep_grid_stage", "euler_tpu_torch/csrc/grid_stage.cu",
           "euler_tpu/ops/pallas/substep_kernel.py:361"),
    "K3": ("mg_pcg", "euler_tpu_torch/csrc/mg_pcg.cu",
           "euler_tpu/ops/pallas/mg_kernel.py:727"),
    "K7": ("grid_stage", "euler_tpu_torch/csrc/grid_stage.cu",
           "euler_tpu/ops/pallas/grid_kernel.py:205"),
    "K8": ("jacobi_pcg_solve", "euler_tpu_torch/csrc/jacobi_pcg.cu",
           "euler_tpu/ops/pallas/pcg_kernel.py:178"),
    "K9": ("jacobi_project", "euler_tpu_torch/csrc/jacobi_pcg.cu",
           "euler_tpu/ops/pallas/pcg_kernel.py:417"),
    "K10": ("jacobi_substep", "euler_tpu_torch/csrc/jacobi_pcg.cu",
            "euler_tpu/ops/pallas/substep_kernel.py:441"),
    "K11": ("mg_stream_pcg", "euler_tpu_torch/csrc/mg_stream.cu",
            "euler_tpu/ops/pallas/mg_stream_kernel.py:464"),
    "K12": ("jacobi_stream_pcg", "euler_tpu_torch/csrc/jacobi_stream.cu",
            "euler_tpu/ops/pallas/pcg_stream_kernel.py:266"),
    # not a Pallas kernel: the JAX package runs this as a lax.scan
    "S1": ("source_emission", "euler_tpu_torch/csrc/sources.cu",
           "euler_tpu/ops/markers_slots.py:415 (update_fluid_sources_slots, "
           "a lax.scan, no pallas_call; the global form "
           "euler_tpu/ops/markers.py:308 update_fluid_sources)"),
    # not Pallas kernels: the JAX package runs these as jnp ops
    "G1": ("global_marker_march", "euler_tpu_torch/csrc/global_markers.cu",
           "euler_tpu/ops/markers.py:115 (advect_markers and _march_markers "
           ":177, jnp ops, no pallas_call)"),
    "G2": ("global_marker_refresh", "euler_tpu_torch/csrc/global_markers.cu",
           "euler_tpu/ops/markers.py:78 (refresh_marker_counts and "
           "_swap_remove_compact :49, jnp ops, no pallas_call)"),
    "P1": ("general_pcg", "euler_tpu_torch/csrc/pcg_general.cu",
           "euler_tpu/ops/project.py:115 (pcg_loop, a jnp while_loop, no "
           "pallas_call)"),
    "P2": ("ic0_preconditioner", "euler_tpu_torch/csrc/pcg_general.cu",
           "euler_tpu/ops/ic0.py:35 (make_ic0_preconditioner, jnp "
           "fori_loops, no pallas_call)"),
    "P3": ("padded_mg_pcg", "euler_tpu_torch/csrc/pcg_mg.cu",
           "euler_tpu/ops/project.py:115 (pcg_loop, a jnp while_loop, with "
           "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner on "
           "padded levels; no pallas_call)"),
    # the same solve in f64 (solver.dtype "float64"): a call is one warm
    # solve of the 1080 x 1920 waterfall's system; launches from its 2
    # timed f64 frames
    "P3_f64": ("padded_mg_pcg_f64", "euler_tpu_torch/csrc/pcg_mg.cu",
               "euler_tpu/ops/project.py:115 (pcg_loop in f64 with "
               "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner, its "
               "f64 hierarchy padded at :332-352 and its f64 Chebyshev rows "
               "at :395-427; every Pallas MG gate is f32 only, "
               "mg_kernel.py:753; no pallas_call)"),
    # RB-GS and rediscretized MG on one card: a call is one warm solve of
    # the 1080 x 1920 waterfall's system; launches from the 2 frames of the
    # 1024² dam break with the setting
    "P3_rbgs": ("padded_mg_pcg_rbgs", "euler_tpu_torch/csrc/pcg_mg.cu",
                "euler_tpu/ops/project.py:115 (pcg_loop with "
                "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner, "
                "mg_smoother \"rbgs\": cycle_galerkin :430-489 with "
                "smooth_edge :354-370 on the hierarchy padded at :332-352; "
                "every Pallas MG gate refuses it, mg_kernel.py:748-756; no "
                "pallas_call)"),
    "P7": ("rediscretized_mg_pcg", "euler_tpu_torch/csrc/pcg_mg_redisc.cu",
           "euler_tpu/ops/project.py:115 (pcg_loop with "
           "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner, "
           "mg_scheme \"rediscretize\": build_hierarchy :64-80 and v_cycle "
           ":166-184 with _smooth :96-123, _prolong / _restrict :126-163; "
           "every Pallas MG gate refuses it; no pallas_call)"),
    # the frame on row blocks: a call is the 4 blocks' launches at 1024²;
    # launches from the 4-block waterfall frames
    "K7s": ("grid_stage_row_blocks", "euler_tpu_torch/csrc/grid_stage.cu",
            "euler_tpu/ops/pallas/grid_kernel.py:205 (the grid stage of the "
            "row-sharded frame, euler_tpu/parallel/pallas_shard.py:133 "
            "make_spatial_step_pallas, which GSPMD partitions)"),
    "S1s": ("source_emission_row_blocks", "euler_tpu_torch/csrc/sources.cu",
            "euler_tpu/ops/markers_slots.py:415 (update_fluid_sources_slots "
            "in the row-sharded frame, a lax.scan, no pallas_call)"),
    "P4": ("sharded_pcg", "euler_tpu_torch/csrc/pcg_shard.cu",
           "euler_tpu/parallel/halo.py:88 (_pcg_sharded: pcg_loop under "
           "shard_map with psum / pmax and a ppermute halo, no "
           "pallas_call)"),
    # the frame on 2 x 2 ("y", "x") blocks: a call is the 4 blocks'
    # launches at 1024² (P4: one solve of the 4 blocks); launches from the
    # 2 x 2 waterfall frames
    "K1b": ("marker_pass_2x2_blocks", "euler_tpu_torch/csrc/marker_pass.cu",
            "euler_tpu/ops/pallas/marker_fused_kernel.py:941 "
            "(march_rebin_pallas with clamp_ny / row_offset, and the port's "
            "clamp_nx / col_offset: a launch per (y, x) block of the frame "
            "on blocks, euler_tpu/parallel/spatial.py:113 "
            "make_spatial_step, which GSPMD partitions)"),
    "K7b": ("grid_stage_2x2_blocks", "euler_tpu_torch/csrc/grid_stage.cu",
            "euler_tpu/ops/pallas/grid_kernel.py:205 (the grid stage of the "
            "frame on (y, x) blocks, euler_tpu/parallel/spatial.py:113 "
            "make_spatial_step, which GSPMD partitions)"),
    "S1b": ("source_emission_2x2_blocks", "euler_tpu_torch/csrc/sources.cu",
            "euler_tpu/ops/markers_slots.py:415 (update_fluid_sources_slots "
            "in the frame on (y, x) blocks, a lax.scan, no pallas_call)"),
    "P4b": ("sharded_pcg_2x2_blocks", "euler_tpu_torch/csrc/pcg_shard.cu",
            "euler_tpu/parallel/halo.py:88 (_pcg_sharded over (y, x): "
            "pcg_loop under shard_map with psum / pmax and a ppermute halo "
            "of rows and columns, no pallas_call)"),
    # the frame's global MG solve on blocks: a call is one warm solve of
    # the 2 x 2 blocks at 1024²; launches from the 2 x 2 MG waterfall
    # frames
    "P5": ("global_mg_pcg_2x2_blocks", "euler_tpu_torch/csrc/pcg_mg_blocks.cu",
           "euler_tpu/ops/project.py:115 (pcg_loop with "
           "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner, the "
           "whole grid's W-cycle, in the frame on (y, x) blocks, "
           "euler_tpu/parallel/spatial.py:113 make_spatial_step, which "
           "GSPMD partitions; no pallas_call)"),
    # MG on blocks of an odd side: a call of K1, K7, S1 is the 8 row blocks'
    # launches of 1080 x 1920 (135 rows, odd row offsets), of P5 one warm
    # solve of the 8 blocks, gathering at level 0; launches from the 2 timed
    # frames of the 1080 x 1920 MG waterfall on the 8 blocks
    "K1o": ("marker_pass_8_odd_row_blocks",
            "euler_tpu_torch/csrc/marker_pass.cu",
            "euler_tpu/ops/pallas/marker_fused_kernel.py:941 "
            "(march_rebin_pallas with clamp_ny / row_offset, a launch per "
            "row block of the frame on blocks, "
            "euler_tpu/parallel/spatial.py:113 make_spatial_step, which "
            "GSPMD partitions)"),
    "K7o": ("grid_stage_8_odd_row_blocks",
            "euler_tpu_torch/csrc/grid_stage.cu",
            "euler_tpu/ops/pallas/grid_kernel.py:205 (the grid stage of the "
            "frame on blocks, euler_tpu/parallel/spatial.py:113 "
            "make_spatial_step, which GSPMD partitions)"),
    "S1o": ("source_emission_8_odd_row_blocks",
            "euler_tpu_torch/csrc/sources.cu",
            "euler_tpu/ops/markers_slots.py:415 (update_fluid_sources_slots "
            "in the frame on blocks, a lax.scan, no pallas_call)"),
    "P5o": ("global_mg_pcg_8_odd_row_blocks_gather_0",
            "euler_tpu_torch/csrc/pcg_mg_blocks.cu",
            "euler_tpu/ops/project.py:115 (pcg_loop with "
            "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner, the "
            "whole grid's W-cycle on levels padded at :332-352, in the "
            "frame on blocks, euler_tpu/parallel/spatial.py:113 "
            "make_spatial_step, which GSPMD partitions; no pallas_call)"),
    # halo.py's block MG on 8 row blocks of 1080 x 1920, each block's level
    # 0 padded to 136 rows: a call is one cold solve of the 8 blocks;
    # launches from that solve and its warm-up
    "P4o": ("sharded_block_mg_pcg_8_odd_row_blocks",
            "euler_tpu_torch/csrc/pcg_shard.cu",
            "euler_tpu/parallel/halo.py:88 (_pcg_sharded with the block MG "
            "of :113-134, each block's hierarchy padded as "
            "euler_tpu/ops/multigrid.py:332-352 pads it: pcg_loop under "
            "shard_map, no pallas_call)"),
    # f64 MG on blocks (solver.dtype "float64"): a call of P5 is one warm
    # solve of the f64 1080 x 1920 waterfall's system on 8 row blocks
    # (gathering at level 0), launches from the 2 timed frames of the f64
    # 1080 x 1920 MG waterfall on the 8 blocks; a call of P4 one cold
    # solve of that system with halo.py's f64 block MG on the 8 blocks,
    # launches from that solve and its warm-up
    "P5_f64": ("global_mg_pcg_f64_8_odd_row_blocks_gather_0",
               "euler_tpu_torch/csrc/pcg_mg_blocks.cu",
               "euler_tpu/ops/project.py:115 (pcg_loop in f64 with "
               "euler_tpu/ops/multigrid.py:492 make_mg_preconditioner, its "
               "f64 hierarchy padded at :332-352 and its f64 Chebyshev rows "
               "at :395-427, in the frame on blocks, "
               "euler_tpu/parallel/spatial.py:113 make_spatial_step, which "
               "GSPMD partitions; no pallas_call)"),
    "P4_f64": ("sharded_block_mg_pcg_f64_8_odd_row_blocks",
               "euler_tpu_torch/csrc/pcg_shard.cu",
               "euler_tpu/parallel/halo.py:88 (_pcg_sharded in f64 with the "
               "block MG of :113-134, each block's f64 hierarchy padded as "
               "euler_tpu/ops/multigrid.py:332-352 pads it: pcg_loop under "
               "shard_map, no pallas_call)"),
    # the frame's global IC(0) solve on blocks: a call is one cold solve of
    # the 40 x 100 system on 2 x 2 blocks; launches from the 2 frames of
    # the 256² IC(0) dam break on 2 x 2 blocks
    "P6": ("global_ic0_pcg_2x2_blocks",
           "euler_tpu_torch/csrc/pcg_ic0_blocks.cu",
           "euler_tpu/ops/project.py:115 (pcg_loop with "
           "euler_tpu/ops/ic0.py:35 make_ic0_preconditioner, the whole "
           "grid's IC(0), in the frame on (y, x) blocks, "
           "euler_tpu/parallel/spatial.py:113 make_spatial_step, which "
           "GSPMD partitions; no pallas_call)"),
    # rainbow colour and the global layout on blocks: a call is the 2 x 2
    # blocks' launches at 1024²
    "K7r": ("grid_stage_rainbow_2x2_blocks",
            "euler_tpu_torch/csrc/grid_stage.cu",
            "euler_tpu/ops/pallas/grid_kernel.py:205 (the grid stage with "
            "the extrapolated velocities the colours are advected with, "
            "euler_tpu/sim.py:164-183, in the frame on (y, x) blocks, "
            "euler_tpu/parallel/mesh.py:89 make_sharded_step, which GSPMD "
            "partitions)"),
    "S1g": ("source_emission_global_2x2_blocks",
            "euler_tpu_torch/csrc/sources.cu",
            "euler_tpu/ops/markers.py:308 (update_fluid_sources in the "
            "frame on (y, x) blocks of the global layout, "
            "euler_tpu/parallel/mesh.py:89 make_sharded_step; jnp, no "
            "pallas_call)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Phase:
    """Times one phase and prints its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"   {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def main_config(size: int):
    from euler_tpu_torch.config import SimConfig, SolverConfig

    # bench.py's default run: slots K=8, Galerkin MG-PCG, tol_rel 1e-4,
    # warm start, 100-iteration cap, fused projection, no sources, mono
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, tol=1e-6, tol_rel=1e-4,
                            dtype="float32", preconditioner="mg",
                            warm_start=True, fuse_projection=True))


def speed_config(size: int, **over):
    """`bench.py --precon jacobi`: the reference's 100-iteration budget,
    tol 1e-6, tol_rel 1e-6, no warm start, fused projection."""
    cfg = main_config(size)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, preconditioner="jacobi", tol_rel=1e-6,
        warm_start=False), **over)


def marker_configs(cfg):
    """`cfg` on each marker route: {"K1": fused (as given), "K5+K6":
    fuse_marker_pass=False, "K4": marker_padded_store}."""
    return {"K1": cfg,
            "K5+K6": dataclasses.replace(cfg, fuse_marker_pass=False),
            "K4": dataclasses.replace(cfg, marker_padded_store=True)}


def div_inf(cfg, state, exclude=None):
    """max |div u| * h^2 rho on fluid cells after the last projection
    (bench.py's post_projection_div_inf), over the cells not in the
    `exclude` mask when one is given."""
    import torch

    from euler_tpu_torch.ops.project import divergence_rhs

    one = torch.ones((), dtype=state.u.dtype, device=state.u.device)
    div = divergence_rhs(cfg, state.u, state.v, state.fluid, one).abs()
    if exclude is not None:
        div = torch.where(exclude, 0.0, div)
    return float(div.max())


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ~10 ms of the card's clock: covers the enqueueing of a few dozen calls
SLEEP_CYCLES = 20_000_000


def device_ms(fn, reps: int) -> float:
    """The card's time a call of fn() with the host out of the way: `reps`
    calls enqueued behind a sleep kernel that outlasts their enqueueing,
    timed by CUDA events (so, unlike `cuda_ms`, no wait for the host
    between launches).  Where the sleep ended first (a slow host), again
    behind a sleep 4 times longer, up to 3 times; then raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for k in range(4):
        torch.cuda._sleep(SLEEP_CYCLES * 4 ** k)
        start.record()
        for _ in range(reps):
            fn()
        if not start.query():
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        torch.cuda.synchronize()
    check(False, "device_ms: the host enqueued slower than the sleep "
          "kernel lasted")


# the kernels that are one launch a call, whose device time `time_pair`
# also takes (`device_ms`)
ONE_LAUNCH = ("K1", "K4", "K5", "K6", "K7", "S1")
# the launch sequences with no host sync whose device time it takes too
# (P1 at its 100-iteration cap replays one batch of chunks: no sync)
NO_SYNC = ONE_LAUNCH + ("G1", "G2", "P1", "P2")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_peak() -> int:
    """Reset the peak-memory count; returns the bytes already allocated
    (tensors that earlier phases of this script still hold)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def record_peak(summary: dict, held: int) -> None:
    """Put the peak allocated since `reset_peak` into `summary`, with the
    `held` bytes that were allocated before the path began."""
    import torch

    from euler_tpu_torch.ops.cuda import mg_kernel

    peak = torch.cuda.max_memory_allocated()
    cached = mg_kernel.cached_bytes()
    summary["max_memory_allocated"] = peak
    summary["memory_held_before"] = held
    summary["mg_workspace_bytes"] = cached
    log(f"   torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB, of "
        f"which {held / 2**30:.3f} GiB was held before the path, "
        f"{cached / 2**30:.3f} GiB of it by {len(mg_kernel._WORKSPACES)} "
        f"cached MG workspaces")


def reset_counts() -> None:
    from euler_tpu_torch.ops.cuda import _build

    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()


def run_path(cfg, scn, state, frames: int, kernels, label: str,
             bypassed=()):
    """Step `frames` frames with the launch counts set to 0 just before
    and read just after; checks that `kernels` launched, that the
    `bypassed` ones and every plain version did not, and that the state
    stayed finite.  Returns (state, summary)."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import _build

    Y, X = cfg.ny, cfg.nx
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    n_active = torch.zeros((), dtype=torch.int32, device=state.u.device)
    pcg_iters = torch.zeros_like(n_active)
    for _ in range(frames):
        state, stats = sim.step_frame_stats(cfg, scn, state)
        n_active += stats["n_active"]
        pcg_iters += stats["pcg_iters"]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    plain = sum(_build.PLAIN_CALLS.values())
    summary = {
        "ms_per_frame": 1e3 * elapsed / frames,
        "cell_steps_per_s": Y * X * cfg.max_substeps * frames / elapsed,
        "active_substeps": int(n_active),
        "pcg_iters_per_active_substep": int(pcg_iters)
        / max(int(n_active), 1),
        "div_inf": div_inf(cfg, state),
        "dropped_markers": int(state.dropped_markers),
        "launches": launches,
    }
    log(f"   {label}: {summary['ms_per_frame']:.3f} ms/frame, "
        f"{summary['cell_steps_per_s']:.4g} cell-steps/s ({Y}x{X} x "
        f"{cfg.max_substeps} substeps x {frames} frames)")
    log(f"   active substeps {summary['active_substeps']} of "
        f"{cfg.max_substeps * frames}; PCG iterations per active substep "
        f"{summary['pcg_iters_per_active_substep']:.2f}; div_inf "
        f"{summary['div_inf']:.4g}; dropped_markers "
        f"{summary['dropped_markers']}; markers "
        f"{int(state.marker_count.sum())}")
    log(f"   launches {launches}; plain-version calls {plain}")
    for k in kernels:
        check(launches.get(k, 0) > 0, f"{label}: {k} did not launch")
    if "K7" in kernels:  # the grid stage of every substep
        check(launches["K7"] == cfg.max_substeps * frames,
              f"{label}: K7 launched {launches['K7']} times in {frames} "
              "frames")
    for k in bypassed:
        check(launches.get(k, 0) == 0, f"{label}: {k} launched")
    check(plain == 0, f"{label}: a plain version ran")
    names = ["u", "v", "p", "markers"] + (["r", "g", "b"] if cfg.rainbow
                                          else [])
    for name in names:
        check(bool(torch.isfinite(getattr(state, name)).all()),
              f"{label}: state.{name} not finite")
    from euler_tpu_torch.core.state import store_shape

    check(tuple(state.u.shape) == (Y, X)
          and tuple(state.markers.shape) == (2,) + store_shape(cfg),
          f"{label}: state shapes changed")
    return state, summary


def build_all():
    """Every kernel library, one nvcc per source, started together."""
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import pcg_kernel as k89
    from euler_tpu_torch.ops.cuda import pcg_stream_kernel as k12
    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.cuda import global_marker_kernel as g12
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12
    from euler_tpu_torch.ops.cuda import pcg_shard_kernel as p4
    from euler_tpu_torch.ops.cuda import pcg_mg_blocks_kernel as p5
    from euler_tpu_torch.ops.cuda import pcg_ic0_blocks_kernel as p6
    from euler_tpu_torch.native import get_lib as encoder_lib

    loaders = [k1.marker_lib, k7.grid_lib, k3._lib, k3._stream_lib,
               k89.jacobi_lib, k12.stream_lib, s1.source_lib, encoder_lib,
               g12.global_lib, p12.general_lib, p12.mg_lib, p12.redisc_lib,
               p4.shard_lib,
               p5.blocks_lib, p6.ic0_blocks_lib]
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    for name, rec in _build.BUILD_LOG.items():
        log(f"   {name}: nvcc {rec['seconds']:.1f} s")
        for line in rec["ptxas"].splitlines():
            entry = re.search(
                r"entry function '\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
            if entry:
                log(f"     {entry.group(2)[:int(entry.group(1))]}:")
            elif "registers" in line or "spill" in line:
                log(f"     {line.strip()}")


def bound_fields(nbytes, flops, rate=None):
    """`bound_ms` and `bound_by` of a call that moves `nbytes` and does
    `flops` operations (f32 unless `rate` says otherwise)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / (rate or F32_FLOP_PER_S)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed_pair(call, plain, plain_reps=REPS):
    """(kernel ms, plain ms, log text): CUDA events in turns, plain,
    kernel, kernel, plain, the best of each."""
    t_p1, t_k1 = cuda_ms(plain, plain_reps), cuda_ms(call, REPS)
    t_k2, t_p2 = cuda_ms(call, REPS), cuda_ms(plain, plain_reps)
    return (min(t_k1, t_k2), min(t_p1, t_p2),
            f"events {t_k1:.4f} / {t_k2:.4f} ms; plain {t_p1:.3f} / "
            f"{t_p2:.3f} ms")


def time_pair(results, name, kern, plain_fn, n_cells, n_live, reps):
    """Times the kernel and its plain version in turns with CUDA events
    (plain, kernel, kernel, plain) and fills results[name] with the best
    of each and the bound of the kernel's call; for a kernel of ONE_LAUNCH
    also its device time (`device_ms`, best of two rounds)."""
    out = kern()
    iters = 0 if name in ONE_LAUNCH + ("G2", "P2") else int(
        out[1] if name in ("K3", "K8", "K11", "K12", "P1", "P3", "P3_f64",
                           "P3_rbgs", "P7", "G1")
        else out[2])
    t_p1 = cuda_ms(plain_fn, reps)
    t_k1 = cuda_ms(kern, reps)
    t_k2 = cuda_ms(kern, reps)
    t_p2 = cuda_ms(plain_fn, reps)
    if name in NO_SYNC:
        results.setdefault(name, {})["device_ms"] = min(
            device_ms(kern, reps) for _ in range(2))
        log(f"   {name}: device time {results[name]['device_ms']:.4f} ms a "
            "call (calls queued behind a sleep kernel)")
    nbytes, flops = BOUNDS[name](n_cells, iters, n_live)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FLOP_RATES.get(name, F32_FLOP_PER_S)
    results.setdefault(name, {}).update(
        ms=min(t_k1, t_k2), plain_ms=min(t_p1, t_p2),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    log(f"   {name}: kernel {t_k1:.3f} / {t_k2:.3f} ms, plain "
        f"{t_p1:.3f} / {t_p2:.3f} ms; bound "
        f"{results[name]['bound_ms']:.4f} ms by "
        f"{results[name]['bound_by']} ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP, {iters} iterations, {n_cells} cells)")
    if name in SWEEP_PLANES:
        sweep = 4 * n_cells * (SWEEP_PLANES[name] * iters
                               + SWEEP_CALL_PLANES.get(name, 0))
        log(f"   {name}: sweep bound {1e3 * sweep / HBM_BYTES_PER_S:.3f}"
            f" ms ({sweep / 1e9:.2f} GB over {iters} iterations)")
        if iters:
            log(f"   {name}: {1e3 * min(t_k1, t_k2) / iters:.2f} us an "
                f"iteration (the call's time over its {iters} iterations)")


def holed(alive, seed: int):
    """`alive` with a seeded 30% of its live slots cleared: an alive plane
    with holes (not front-compacted) whose live markers all keep their
    real positions."""
    import torch

    g = torch.Generator(device=alive.device).manual_seed(seed)
    return alive & (torch.rand(alive.shape, generator=g,
                               device=alive.device) >= 0.3)


def check_marker_variants(cfg, scn, state, dt, o_k1, c_k1, d_k1):
    """K5, K6 and K4 against their plain versions on the card, on `state`
    with the substep's `dt`: K5's and K6's whole store, K6's alive,
    counts and drops bitwise, K6 also on an alive plane with holes; dt = 0
    an identity; K5 + K6 and K4's interior equal to K1's output (o_k1,
    c_k1, d_k1).  Returns each kernel's max error on the live positions
    (0.0: they are bitwise)."""
    import torch

    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6
    from euler_tpu_torch.ops.markers_slots import live_slots

    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    check(K == SLOTS, f"slots_per_cell {K}: the bounds assume {SLOTS}")
    args = (cfg, state.u, state.v, state.fluid, scn.solid)
    markers, count = state.markers, state.marker_count
    dead = scn.sink | scn.solid
    zero = torch.zeros_like(dt)

    def live_err(name, got, want, cnt):
        live = live_slots(cnt, K)
        err = max((a - b).abs()[live].max().item()
                  for a, b in zip(got, want))
        whole = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"   {name}: live positions max err {err:.3g} (bitwise: "
            f"{err == 0.0}; whole store bitwise: {whole})")
        check(err == 0.0, f"{name}: live positions differ from plain")
        return err

    errs = {}
    m_k = k5.advect_markers(*args, markers, dt, count)
    m_p = k5.advect_markers_plain(*args, markers, dt, count)
    errs["K5"] = live_err("K5", m_k, m_p, count)
    check(torch.equal(m_k, m_p), "K5: the store differs from plain (dead "
          "slots included)")
    check(torch.equal(m_k[:, ~state.alive], markers[:, ~state.alive]),
          "K5: dead slots were not copied through")
    m_0 = k5.advect_markers(*args, markers, zero, count)
    check(torch.equal(m_0, markers), "K5 with dt = 0 is not an identity")
    log("   K5: the whole store bitwise; dead slots copied through; dt = 0 "
        "is a bitwise identity")

    r_k = k6.rebin_markers(cfg, m_k, state.alive, dead)
    r_p = k6.rebin_markers_plain(cfg, m_k, state.alive, dead)
    for i, what in ((1, "alive"), (2, "counts"), (3, "drops")):
        check(torch.equal(r_k[i], r_p[i]), f"K6 {what} differ from plain")
    errs["K6"] = live_err("K6", r_k[0], r_p[0], r_p[2])
    check(torch.equal(r_k[0], r_p[0]), "K6: the store differs from plain "
          "(dead slots included)")
    check(torch.equal(r_k[2], c_k1) and torch.equal(r_k[3], d_k1)
          and torch.equal(r_k[0].reshape(o_k1.shape), o_k1),
          "K5 + K6 differ from K1")
    r_0 = k6.rebin_markers(cfg, markers, state.alive, dead)
    check(torch.equal(r_0[0], markers) and torch.equal(r_0[1], state.alive)
          and torch.equal(r_0[2], count) and int(r_0[3].sum()) == 0,
          "K6 on an unmoved store is not an identity")
    log("   K6: the whole store, alive, counts, drops bitwise; K5 + K6 give "
        "K1's output bit for bit; an unmoved store is a bitwise identity")
    alive_h = holed(state.alive, 9)
    check(not torch.equal(alive_h, live_slots(alive_h.sum(
        0, dtype=torch.int32), K)), "the holed alive plane is "
          "front-compacted")
    h_k = k6.rebin_markers(cfg, m_k, alive_h, dead)
    h_p = k6.rebin_markers_plain(cfg, m_k, alive_h, dead)
    for i, what in enumerate(("store", "alive", "counts", "drops")):
        check(torch.equal(h_k[i], h_p[i]),
              f"K6 on an alive plane with holes: {what} differ from plain")
    log(f"   K6 on an alive plane with holes ({int(alive_h.sum())} of "
        f"{int(state.alive.sum())} live slots kept): the whole store, "
        "alive, counts, drops bitwise")

    store = torch.full((2 * K, Y + 16, X + 256), float("nan"),
                       device=markers.device)
    inner = (slice(None), slice(8, 8 + Y), slice(128, 128 + X))
    store[inner] = state.markers.reshape(2 * K, Y, X)
    p_k = k1.march_rebin_padded(*args, store, dt, count, dead=dead)
    p_p = k1.march_rebin_padded_plain(*args, store, dt, count, dead=dead)
    check(torch.equal(p_k[1], p_p[1]), "K4 counts differ from plain")
    check(torch.equal(p_k[2], p_p[2]), "K4 drops differ from plain")
    o4 = p_k[0][inner]
    errs["K4"] = live_err("K4", (o4[:K], o4[K:]),
                          (p_p[0][inner][:K], p_p[0][inner][K:]), p_p[1])
    check(torch.equal(o4, p_p[0][inner]), "K4: the store's interior "
          "differs from plain (dead slots included)")
    check(torch.equal(o4, o_k1) and torch.equal(p_k[1], c_k1)
          and torch.equal(p_k[2], d_k1), "K4's interior differs from K1")
    p_0 = k1.march_rebin_padded(*args, store, zero, count, dead=dead)
    check(torch.equal(p_0[0][inner], store[inner])
          and torch.equal(p_0[1], count) and int(p_0[2].sum()) == 0,
          "K4 with dt = 0 is not an identity")
    log("   K4: counts, drops and the whole interior store equal to plain "
        "(NaN pads); interior equal to K1's output bit for bit; dt = 0 is "
        "a bitwise identity")
    return errs


# slots a cell of the wide store that K5 and K6 are also timed on (their
# tile plans change to 16 x 32 tiles there)
WIDE_SLOTS = 16


def time_unfused_wide(cfg, scn, state, dt, results) -> None:
    """K5's and K6's time a call on `state`'s markers in a store of
    WIDE_SLOTS slots a cell (the K live ones, then empty slots): each
    checked bitwise against its plain version (the whole store; K6's
    alive, counts and drops), then timed by device ms and CUDA events
    beside its bound, into results[name] as wide_device_ms and wide_ms."""
    import torch

    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6

    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    wcfg = dataclasses.replace(cfg, slots_per_cell=WIDE_SLOTS)
    markers = torch.cat([state.markers, state.markers.new_zeros(
        (2, WIDE_SLOTS - K, Y, X))], 1)
    alive = torch.cat([state.alive, state.alive.new_zeros(
        (WIDE_SLOTS - K, Y, X))])
    dead = scn.sink | scn.solid
    k5_args = (wcfg, state.u, state.v, state.fluid, scn.solid, markers, dt,
               state.marker_count)
    marched = k5.advect_markers(*k5_args)
    check(torch.equal(marched, k5.advect_markers_plain(*k5_args)),
          f"K5 at K = {WIDE_SLOTS}: the store differs from plain")
    got = k6.rebin_markers(wcfg, marched, alive, dead)
    want = k6.rebin_markers_plain(wcfg, marched, alive, dead)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"K6 at K = {WIDE_SLOTS}: store, alive, counts or drops differ "
          "from plain")
    n_live = int(state.marker_count.sum())
    calls = {"K5": lambda: k5.advect_markers(*k5_args),
             "K6": lambda: k6.rebin_markers(wcfg, marched, alive, dead)}
    for name, fn in calls.items():
        res = results[name]
        res["wide_ms"] = min(cuda_ms(fn, REPS) for _ in range(2))
        res["wide_device_ms"] = min(device_ms(fn, REPS) for _ in range(2))
        nbytes, _ = BOUNDS[name](Y * X, 0, n_live, WIDE_SLOTS)
        log(f"   {name} at K = {WIDE_SLOTS}: bitwise; {res['wide_ms']:.4f} ms "
            f"a call, device time {res['wide_device_ms']:.4f} ms; bound "
            f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms by bytes "
            f"({nbytes / 1e6:.1f} MB)")


def run_marker_routes(cfg, summaries, launches, dev, profile_prefix=None):
    """The main path at full size on its three marker routes, K1 (the
    reference), K5+K6 and K4, ROUTE_WARMUP + ROUTE_FRAMES frames each from
    the same dam break: each route's kernels launch 8 times a frame, the
    other marker kernels and every plain version never, and the K5+K6 and
    K4 routes end with counts, drops, u, v, p, alive and the whole store
    bitwise equal to the K1 route.  Profiled with a prefix."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.markers_slots import live_slots

    configs = marker_configs(cfg)
    ref = live = None
    for label, route in (("marker_k1", "K1"), ("marker_unfused", "K5+K6"),
                         ("padded_store", "K4")):
        rcfg = configs[route]
        kernels = route.split("+") + ["K2", "K3"]
        others = [k for k in ("K1", "K4", "K5", "K6") if k not in kernels]
        with Phase(f"route {label} {cfg.ny}²: {ROUTE_WARMUP} warm-up + "
                   f"{ROUTE_FRAMES} timed frames"):
            held = reset_peak()
            rscn, rstate = dam_break(rcfg, device=dev)
            check(sim.marker_route(rcfg, rscn) == route,
                  f"{label}: marker route {sim.marker_route(rcfg, rscn)}")
            for _ in range(ROUTE_WARMUP):
                rstate = sim.step_frame(rcfg, rscn, rstate)
            rstate, summaries[label] = run_path(
                rcfg, rscn, rstate, ROUTE_FRAMES, kernels, label,
                bypassed=others)
            record_peak(summaries[label], held)
            got = summaries[label]["launches"]
            for k in kernels:
                check(got.get(k, 0) == 8 * ROUTE_FRAMES,
                      f"{label}: {k} launched {got.get(k, 0)} times, not 8 "
                      "a frame")
            check(summaries[label]["div_inf"] < 1.0,
                  f"{label}: div_inf too large")
            if route == "K1":
                ref = rstate
                live = torch.cat([live_slots(ref.marker_count,
                                             cfg.slots_per_cell)] * 2)
            else:
                for k in route.split("+"):
                    launches[k] = got.get(k, 0)
                for name in ("marker_count", "dropped_markers", "u", "v",
                             "p", "alive"):
                    check(torch.equal(getattr(rstate, name),
                                      getattr(ref, name)),
                          f"{label}: {name} differs from the K1 route")
                mine = rstate.markers.reshape(live.shape)
                theirs = ref.markers.reshape(live.shape)
                check(torch.equal(mine, theirs),
                      f"{label}: the store differs from the K1 route")
                log(f"   {label}: counts, drops, u, v, p, alive and the "
                    f"whole store ({int(live.sum())} live positions) bitwise "
                    "equal to the K1 route")
        if profile_prefix:
            with Phase(f"{label}: profile"):
                profile(rcfg, rscn, rstate, f"{profile_prefix}.{label}.txt",
                        label)
        del rscn, rstate


def substep_system(cfg, scn, state):
    """A substep's own projection system on `state`: dt from its maxsq,
    the advected velocities (plain grid stage), their RHS and the
    diagonal."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    frame_time = torch.tensor(cfg.frame_time, device=state.u.device)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                          frame_time)
    ut, vt = grid_stage_plain(cfg, dt, state.u, state.v, state.fluid,
                              state.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, state.fluid, dt)
    a_diag = pressure_matrix_diag(cfg, scn.solid, state.fluid)
    return dt, ut, vt, b, a_diag


def check_solve(name, got, want, rel_tol, same_iters: bool):
    """Pressure within rel_tol of the plain version's scale; iterations
    equal or within 1."""
    (p_k, i_k, _), (p_p, i_p, _) = got, want
    scale = p_p.abs().max().item()
    err = (p_k - p_p).abs().max().item()
    log(f"   {name}: p max err {err:.3g} of scale {scale:.3g} (atol "
        f"{rel_tol:g}*scale); iters {int(i_k)} vs {int(i_p)}")
    check(int(i_p) > 0, f"{name}: the plain solve ran no iteration")
    check(err <= rel_tol * scale, f"{name} pressure differs > "
          f"{rel_tol:g}*scale")
    if same_iters:
        check(int(i_k) == int(i_p), f"{name} iterations differ")
    else:
        check(abs(int(i_k) - int(i_p)) <= 1, f"{name} iterations differ > 1")
    return err


def check_hierarchy(cfg, b, a_diag, fl) -> None:
    """The Galerkin hierarchy and Chebyshev rows K3 builds on the card for
    (a_diag, fl) bitwise equal to `mg_host_operands` (the packed plane,
    every coarse level's c, e, n planes, the rows); then one preconditioner
    application on b through the coarse cycle and through one launch per
    level operation, bitwise equal."""
    import torch

    from euler_tpu_torch.ops.cuda import mg_kernel as k3

    ws = k3.workspace(cfg, b.device)
    ws.load(a_diag, fl, b)
    ws.solve(warm=False)
    _, packed0, planes, rows = k3.mg_host_operands(cfg, a_diag, fl)
    check(torch.equal(ws.packed0, packed0), "K3: packed plane differs")
    for l, (want, got) in enumerate(zip(planes, ws.levels), start=1):
        for name, a, c in zip("cen", want, got):
            check(torch.equal(a, c), f"K3: hierarchy level {l} {name} "
                  "differs from mg_host_operands")
    check(torch.equal(ws.rows, rows), "K3: Chebyshev rows differ from "
          "mg_host_operands")
    log(f"   K3: hierarchy ({len(planes)} coarse levels) and Chebyshev rows "
        f"{tuple(rows.shape)} bitwise equal to mg_host_operands")
    ws.load(a_diag, fl, b)
    fused, per_op = ws.cycle(per_op=False), ws.cycle(per_op=True)
    check(bool(fused.abs().max() > 0), "K3: the cycle returned zero")
    check(torch.equal(fused, per_op), "K3: the coarse cycle in one launch "
          "differs from one launch per level operation")
    log("   K3: coarse cycle in one launch a visit bitwise equal to one "
        "launch per level operation")


def check_stream_hierarchy(cfg, b, a_diag, fl) -> None:
    """The Galerkin hierarchy and Chebyshev rows K11 builds on the card for
    (a_diag, fl) on its cached workspace bitwise equal to the plain build:
    every coarse level's c, e, n planes (`mg_host_operands`; those from the
    root down are `stream_host_operands`'), the packed plane, and the rows
    from the root down with the fine level's [it0, 0, ...] after them."""
    import torch

    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import mg_stream_kernel as k11

    _, ls, F = k11._root(cfg)
    ws = k3.workspace(cfg, b.device, ls)
    ws.stream_solve(a_diag, fl, b)
    _, packed0, planes, _ = k3.mg_host_operands(cfg, a_diag, fl)
    _, _, _, _, rows = k11.stream_host_operands(cfg, a_diag, fl)
    check(torch.equal(ws.packed0, packed0), "K11: packed plane differs")
    check(len(planes) == len(ws.levels), "K11: hierarchy depth differs")
    for l, (want, got) in enumerate(zip(planes, ws.levels), start=1):
        for name, a, c in zip("cen", want, got):
            check(torch.equal(a, c), f"K11: hierarchy level {l} {name} "
                  "differs from the plain build")
    check(torch.equal(ws.rows[ls:], rows), "K11: Chebyshev rows differ "
          "from stream_host_operands")
    log(f"   K11 (F = {F}): hierarchy ({len(planes)} coarse levels, root "
        f"level {ls}) and rows {tuple(rows.shape)} bitwise equal to "
        "stream_host_operands")
    log(f"   cached MG workspaces now: {len(k3._WORKSPACES)}, "
        f"{k3.cached_bytes() / 2**30:.3f} GiB (this one "
        f"{ws.nbytes / 2**30:.3f} GiB; bound "
        f"{k3._MAX_WORKSPACE_BYTES / 2**30:.3f} GiB)")


def stream_syncs(fn) -> int:
    """The host's stream synchronisations while `fn` enqueues its work
    (torch.profiler's count of cudaStreamSynchronize)."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "cudaStreamSynchronize")


def time_k1(cfg, scn, state, summary) -> None:
    """K1's time a call on `state` (best of two rounds of REPS calls, CUDA
    events) and its device time (`device_ms`) beside its bound, into
    `summary` as k1_ms and k1_device_ms."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.forces import max_speed_sq

    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                          torch.tensor(cfg.frame_time, device=state.u.device))
    args = (cfg, state.u, state.v, state.fluid, scn.solid,
            state.markers.reshape(2 * K, Y, X), dt, state.marker_count)
    dead = scn.sink | scn.solid

    def call():
        return k1.march_rebin(*args, dead=dead)

    ms = min(cuda_ms(call, REPS) for _ in range(2))
    dev = min(device_ms(call, REPS) for _ in range(2))
    n_live = int(state.marker_count.sum())
    nbytes, _ = BOUNDS["K1"](Y * X, 0, n_live)
    summary["k1_ms"] = ms
    summary["k1_device_ms"] = dev
    log(f"   K1 at {Y}x{X}: {ms:.4f} ms a call, device time {dev:.4f} ms; "
        f"bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms by bytes "
        f"({nbytes / 1e6:.1f} MB, {n_live} live markers)")


def check_k7(cfg, args, dt, label: str) -> float:
    """K7 against its plain version on the card, bit for bit: ut and vt,
    and the rainbow form's four planes (ut, vt and the extrapolated
    velocities).  Returns the max abs error (0.0)."""
    import torch

    from euler_tpu_torch.ops.cuda import grid_kernel as k7

    def bits(t):
        return t.contiguous().view(torch.int32)

    want = (k7.grid_stage_plain(cfg, dt, *args)
            + k7.extrapolate_zero(cfg, *args))
    err = 0.0
    for got in (k7.grid_stage(cfg, *args, dt),
                k7.grid_stage(cfg, *args, dt, extrapolated=True)):
        for g, w in zip(got, want):
            err = max(err, (g - w).abs().max().item())
            check(torch.equal(bits(g), bits(w)),
                  f"K7 at {label}: differs from its plain version")
    log(f"   K7 at {label}: ut, vt and the rainbow form's four planes "
        f"bitwise equal to the plain version (max err {err:.3g})")
    return err


def time_k7(cfg, scn, state, summary) -> None:
    """K7 on `state` bit for bit against its plain version, then its time
    a call (best of two rounds of REPS calls, CUDA events) and its device
    time (`device_ms`) beside its bound, into `summary` as k7_ms and
    k7_device_ms."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.forces import max_speed_sq

    Y, X = cfg.ny, cfg.nx
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                          torch.tensor(cfg.frame_time, device=state.u.device))
    args = (state.u, state.v, state.fluid, state.prev_fluid, scn.solid)
    check_k7(cfg, args, dt, f"{Y}x{X}")

    def call():
        return k7.grid_stage(cfg, *args, dt)

    ms = min(cuda_ms(call, REPS) for _ in range(2))
    dev = min(device_ms(call, REPS) for _ in range(2))
    nbytes, _ = BOUNDS["K7"](Y * X, 0, 0)
    summary["k7_ms"] = ms
    summary["k7_device_ms"] = dev
    log(f"   K7 at {Y}x{X}: {ms:.4f} ms a call, device time {dev:.4f} ms; "
        f"bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms by bytes "
        f"({nbytes / 1e6:.1f} MB)")


def run_large(size, results, summaries, launches, profile_prefix=None):
    """The paths beyond the fused kernels' gates: `bench.py --size 2048`
    (MG: the plain grid stage and K11) and `--size 4096 --precon jacobi`
    (K12), each from the seeded dam break (profiled with a prefix), then
    their solver against its plain version on the state they reached."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import mg_stream_kernel as k11
    from euler_tpu_torch.ops.cuda import pcg_stream_kernel as k12

    precon, warmup, frames, reps = LARGE[size]
    mg = precon == "mg"
    cfg = main_config(size) if mg else speed_config(size)
    kernel = "K11" if mg else "K12"
    label = f"{precon}_{size}"
    held = reset_peak()
    with Phase(f"{label}: {warmup} warm-up + {frames} timed frames"):
        scn, state = dam_break(cfg, device=torch.device("cuda", 0))
        check(sim.route(cfg, scn) == ("plain", kernel),
              f"{label}: route {sim.route(cfg, scn)}")
        for _ in range(warmup):
            state = sim.step_frame(cfg, scn, state)
        bypassed = ["K2", "K3"] if mg else ["K8", "K9", "K10"]
        state, summaries[label] = run_path(cfg, scn, state, frames,
                                           ["K1", "K7", kernel], label,
                                           bypassed)
        if mg:
            check(summaries[label]["div_inf"] < 1.0,
                  f"{label}: div_inf too large")
        launches[kernel] = summaries[label]["launches"].get(kernel, 0)
        record_peak(summaries[label], held)
    if profile_prefix:
        with Phase(f"{label}: profile"):
            profile(cfg, scn, state, f"{profile_prefix}.{label}.txt", label)

    with Phase(f"{label}: K1 and K7 on the path's state"):
        time_k1(cfg, scn, state, summaries[label])
        time_k7(cfg, scn, state, summaries[label])

    with Phase(f"{label}: solvers vs plain versions on the card"):
        dt, ut, vt, b, a_diag = substep_system(cfg, scn, state)
        fl = state.fluid
        mcfg = main_config(size)
        check(k11._root(mcfg)[2] == (2 if mg else 4), "K11: unexpected F")
        err = check_solve(f"K11 (F = {k11._root(mcfg)[2]})",
                          k11.solve_pressure_mg_stream(mcfg, b, a_diag, fl),
                          k11.solve_pressure_mg_stream_plain(mcfg, b, a_diag,
                                                             fl),
                          5e-4, same_iters=False)
        check_stream_hierarchy(mcfg, b, a_diag, fl)
        if mg:
            out = []
            syncs = stream_syncs(lambda: out.append(
                k11.solve_pressure_mg_stream(cfg, b, a_diag, fl)))
            iters = int(out[0][1])
            log(f"   K11: {syncs} stream syncs in one solve of {iters} "
                f"iterations ({-(-iters // 8)} chunks of 8)")
            summaries[label]["k11_syncs_per_solve"] = syncs
            results["K11"] = {"max_abs_err": err}
            time_pair(results, "K11",
                      lambda: k11.solve_pressure_mg_stream(cfg, b, a_diag,
                                                           fl),
                      lambda: k11.solve_pressure_mg_stream_plain(
                          cfg, b, a_diag, fl),
                      size * size, 0, reps)
        else:
            results["K12"] = {"max_abs_err": check_solve(
                "K12", k12.solve_pressure_stream(cfg, b, a_diag, fl),
                k12.solve_pressure_stream_plain(cfg, b, a_diag, fl),
                1e-4, same_iters=True)}
            time_pair(results, "K12",
                      lambda: k12.solve_pressure_stream(cfg, b, a_diag, fl),
                      lambda: k12.solve_pressure_stream_plain(cfg, b,
                                                              a_diag, fl),
                      size * size, 0, reps)
        zero = torch.zeros_like(b)
        solve = (k11.solve_pressure_mg_stream if mg
                 else k12.solve_pressure_stream)
        _, it0, res0 = solve(cfg, zero, a_diag, fl)
        check(int(it0) == 0 and float(res0) == 0.0,
              f"{kernel}: a zero RHS is not free")
        log(f"   {kernel}: a zero RHS exits with 0 iterations")


# The CLI's runs (python -m euler_tpu_torch): label -> (arguments,
# frames, the kernels its frames run, the kernels they must bypass).
# Sources take the unfused routes: never K2, K10 or K4.
CLI_RUNS = {
    "cli_waterfall": (["scenarios/waterfall.txt"], 50,
                      ["K1", "S1", "K7", "K8"], ["K2", "K10", "K4", "K3"]),
    "cli_waterfall_1024": (["scenarios/waterfall.txt", "--size",
                            "1024x1024"], 4, ["K1", "S1", "K7", "K3"],
                           ["K2", "K10", "K4"]),
    "cli_dam_break_1024": (["preset:dam_break", "--size", "1024x1024"], 20,
                           ["K1", "K2", "K3"], ["S1"]),
    # the converged mode where the MG levels do not halve evenly: P3
    "cli_waterfall_1080p": (["scenarios/waterfall.txt", "--size",
                             "1080x1920"], 4, ["K1", "S1", "K7", "P3"],
                            ["K2", "K3", "K4", "K10", "K11"]),
    "cli_dam_break_1200": (["preset:dam_break", "--size", "1200x1200"], 4,
                           ["K1", "K7", "P3"], ["K2", "K3", "K11", "S1"]),
    # the reference's own configuration: the global layout, Jacobi budget
    "cli_filter_no_pallas": (["scenarios/filter.txt", "--no-pallas"], 50,
                             ["G1", "G2", "K7", "K8"],
                             ["K1", "K2", "K3", "K4", "K5", "K6", "K9", "K10",
                              "K11", "K12", "P1", "P2", "S1"]),
}


def cli_state(argv, cpu=False):
    """(cfg, scn, state) as the CLI builds them from `argv`, on the card
    (on the CPU with `cpu`)."""
    from euler_tpu_torch import cli

    return cli._build(cli.parse_args(argv + (["--cpu"] if cpu else [])))


S1_FIELDS = ("markers", "alive", "marker_count", "r", "g", "b", "rng",
             "alive_count", "source_exhausted")


def s1_copy(st):
    """`st` with its own copy of every field S1 writes in place."""
    return st.replace(**{k: getattr(st, k).clone() for k in S1_FIELDS})


def to_cpu(scn, st):
    """The same scenario and state as CPU tensors."""
    from euler_tpu_torch import convert

    return (convert.scenario_from_numpy(convert.scenario_to_numpy(scn),
                                        device="cpu"),
            convert.state_from_numpy(
                convert.state_to_numpy(st), device="cpu",
                layout="global" if st.markers.ndim == 2 else "slots"))


def run_cli_subprocesses() -> dict:
    """Each CLI run as a user runs it, headless, in a process of its own:
    it must exit 0 and print its frames/s line.  Returns {label: line}."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    lines = {}
    for label, (argv, frames, _, _) in CLI_RUNS.items():
        cmd = [sys.executable, "-m", "euler_tpu_torch", *argv, "--frames",
               str(frames)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        log(f"   {label}: python -m euler_tpu_torch {' '.join(argv)} "
            f"--frames {frames}: rc {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s: {last}")
        check(proc.returncode == 0 and " frames/s, " in last,
              f"{label}: the CLI failed (rc {proc.returncode}):\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        lines[label] = last
    return lines


def check_small_kernels(cfg, scn, st, label: str) -> dict:
    """K1, K7 and K8 against their plain versions on the card at a small,
    ragged grid (`st` a developed waterfall state): K1's store, counts
    and drops and K7's planes bitwise; K8 (its reduction order is not the
    plain version's) to its standing check, the same iterations and p
    within 1e-3 of scale, and whether it is bitwise too.  Returns the
    max errors by kernel."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import pcg_kernel as k89
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device=st.u.device))
    dead = scn.sink | scn.solid
    args = (cfg, st.u, st.v, st.fluid, scn.solid,
            st.markers.reshape(2 * K, Y, X), dt, st.marker_count)
    got = k1.march_rebin(*args, dead=dead)
    want = k1.march_rebin_plain(*args, dead=dead)
    for g, w, what in zip(got, want, ("store", "counts", "drops")):
        check(torch.equal(g, w), f"K1 at {label}: {what} differ from the "
              "plain version")
    err = {"K1": (got[0] - want[0]).abs().max().item()}
    fl, pfl = st.fluid, st.prev_fluid
    err["K7"] = check_k7(cfg, (st.u, st.v, fl, pfl, scn.solid), dt, label)
    ut, vt = k7.grid_stage_plain(cfg, dt, st.u, st.v, fl, pfl, scn.solid)
    b = divergence_rhs(cfg, ut, vt, fl, dt)
    a_diag = pressure_matrix_diag(cfg, scn.solid, fl)
    p_k, i_k, _ = k89.solve_pressure_jacobi(cfg, b, a_diag, fl)
    p_p, i_p, _ = k89.solve_pressure_jacobi_plain(cfg, b, a_diag, fl)
    scale = p_p.abs().max().item()
    err["K8"] = (p_k - p_p).abs().max().item()
    check(int(i_k) == int(i_p), f"K8 at {label}: iterations differ")
    check(err["K8"] <= 1e-3 * scale, f"K8 at {label}: p differs > "
          "1e-3*scale")
    log(f"   K1 at {label}: store, counts and drops bitwise; K8: "
        f"{int(i_k)} iterations as the plain version, p max err "
        f"{err['K8']:.3g} of scale {scale:.3g} (bitwise: "
        f"{torch.equal(p_k, p_p)})")
    return err


def check_s1(cfg, scn, st, label: str) -> float:
    """S1 against its plain version on the card, from copies of `st`:
    as it is, with the substep inactive, and with alive_count at
    max_markers - 3 (the stream exhausted part-way): every field it
    writes bitwise.  Returns the max abs error of the store (0.0)."""
    import torch

    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.markers_slots import source_pass_slots

    err = 0.0
    for case in ("as is", "inactive", "exhaustion"):
        base = s1_copy(st)
        if case == "exhaustion":
            base.alive_count.fill_(cfg.max_markers - 3)
        act = torch.tensor(case != "inactive", device=st.u.device)
        got, want = s1_copy(base), s1_copy(base)
        s1.emit_sources(cfg, scn, got, act)
        source_pass_slots(cfg, scn, want, act)
        for k in S1_FIELDS:
            # the RNG compared as int64: uint32 has few torch ops
            a, b = getattr(got, k), getattr(want, k)
            check(torch.equal(a.to(torch.int64), b.to(torch.int64))
                  if k == "rng" else torch.equal(a, b),
                  f"S1 at {label} ({case}): {k} differs from the plain "
                  "version")
        err = max(err, (got.markers - want.markers).abs().max().item())
        emitted = int(got.alive_count) - int(base.alive_count)
        log(f"   S1 at {label} ({case}): every field bitwise the plain "
            f"version's; {emitted} markers emitted, exhausted "
            f"{bool(got.source_exhausted)}")
        if case == "inactive":
            check(emitted == 0 and torch.equal(got.markers, base.markers),
                  "S1: an inactive substep emitted")
        if case == "exhaustion":
            check(bool(got.source_exhausted)
                  and int(got.alive_count) == cfg.max_markers - 1,
                  "S1: the stream did not end at max_markers - 1")
    return err


def time_s1(cfg, scn, st, results) -> None:
    """S1 and its plain version timed on copies of `st` (each call emits
    into its own copy, so later calls find fuller cells), with its bound
    for the first call's work."""
    import torch

    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.markers_slots import source_pass_slots

    act = torch.ones((), dtype=torch.bool, device=st.u.device)
    probe = s1_copy(st)
    s1.emit_sources(cfg, scn, probe, act)
    emitted = int(probe.alive_count) - int(st.alive_count)
    k_state, p_state = s1_copy(st), s1_copy(st)
    time_pair(results, "S1",
              lambda: s1.emit_sources(cfg, scn, k_state, act),
              lambda: source_pass_slots(cfg, scn, p_state, act),
              scn.num_sources, emitted, REPS)
    log(f"   S1: {scn.num_sources} sources, {emitted} emitted in the first "
        "call")


def check_render(cfg, scn, st, label: str, windows) -> None:
    """draw_frame and draw_frame_downsampled of a card state byte-equal to
    the CPU's render of the same state, in mono and rainbow."""
    from euler_tpu_torch.render.ansi import draw_frame
    from euler_tpu_torch.render.downsample import draw_frame_downsampled

    scn_c, st_c = to_cpu(scn, st)
    for rainbow in (False, True):
        rcfg = dataclasses.replace(cfg, rainbow=rainbow)
        for rows, cols in windows:
            for fn in (draw_frame, draw_frame_downsampled):
                if fn is draw_frame and (cfg.ny - 2 > rows
                                         or cfg.nx - 2 > cols):
                    continue
                got = fn(rcfg, scn, st, rows, cols)
                check(got == fn(rcfg, scn_c, st_c, rows, cols),
                      f"{label}: {fn.__name__} ({rows}x{cols}, rainbow "
                      f"{rainbow}) differs from the CPU render")
    log(f"   {label}: draw_frame / draw_frame_downsampled byte-equal to the "
        f"CPU's render of the same state (windows {windows}, mono and "
        "rainbow)")


def check_checkpoint(cfg, scn, st, label: str) -> None:
    """save, load onto the card, bitwise; one frame from the loaded state
    bitwise the frame from the original."""
    import tempfile

    import torch

    from euler_tpu_torch import convert, sim
    from euler_tpu_torch.io import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ck.npz")
        checkpoint.save(path, cfg, scn, st)
        cfg2, scn2, st2 = checkpoint.load(path, device=st.u.device)
    check(cfg2 == cfg, f"{label}: the config did not round-trip")
    a, b = convert.state_to_numpy(st), convert.state_to_numpy(st2)
    for k in a:
        check(a[k].tobytes() == b[k].tobytes(),
              f"{label}: {k} did not round-trip")
    check(st2.u.is_cuda and st2.markers.is_cuda, f"{label}: not loaded "
          "onto the card")
    on = convert.state_to_numpy(sim.step_frame(cfg, scn, st))
    resumed = convert.state_to_numpy(sim.step_frame(cfg2, scn2, st2))
    for k in on:
        check(on[k].tobytes() == resumed[k].tobytes(),
              f"{label}: a resumed frame differs in {k}")
    torch.cuda.synchronize()
    log(f"   {label}: checkpoint round trip bitwise; a resumed frame "
        "bitwise the frame run on")


def run_text_scenarios(results, summaries, launches, profile_prefix=None):
    """The text scenarios, source emission and the CLI: the CLI's runs
    as subprocesses, then in process (a warm-up frame, as the CLI takes,
    then the counted frames); the waterfall against the CPU, S1, K1, K7
    and K8 against their plain versions at 40 x 100 and 40 x 99, the
    waterfalls' div_inf, the renderer and a checkpoint on card states;
    P3 on the 1080 x 1920 and 1200² states (`run_padded_mg`)."""
    import torch

    from euler_tpu_torch import sim

    with Phase("the CLI: its headless runs, a process each"):
        summaries["cli_lines"] = run_cli_subprocesses()

    with Phase("waterfall 40x100, CLI config: card vs CPU, 2 frames"):
        cfg, scn_g, st_g = cli_state(CLI_RUNS["cli_waterfall"][0])
        _, scn_c, st_c = cli_state(CLI_RUNS["cli_waterfall"][0], cpu=True)
        for _ in range(2):
            st_g = sim.step_frame(cfg, scn_g, st_g)
            st_c = sim.step_frame(cfg, scn_c, st_c)
        for name in ("marker_count", "alive", "alive_count",
                     "dropped_markers", "source_exhausted", "r", "g", "b"):
            check(torch.equal(getattr(st_g, name).cpu(),
                              getattr(st_c, name)),
                  f"waterfall: {name} differs between card and CPU")
        check(torch.equal(st_g.rng.cpu().to(torch.int64),
                          st_c.rng.to(torch.int64)),
              "waterfall: the RNG differs between card and CPU")
        du = (st_g.u.cpu() - st_c.u).abs().max().item()
        dv = (st_g.v.cpu() - st_c.v).abs().max().item()
        log(f"   counts, alive, alive_count, drops "
            f"({int(st_g.dropped_markers)}), RNG and colours bitwise; max "
            f"|du| {du:.3g}, |dv| {dv:.3g} (atol 5e-3)")
        check(du <= 5e-3 and dv <= 5e-3, "waterfall: velocities differ "
              "> 5e-3")

    states = {}
    for label, (argv, frames, kernels, bypassed) in CLI_RUNS.items():
        with Phase(f"{label} in process: 1 warm-up + {frames} frames"):
            held = reset_peak()
            cfg, scn, st = cli_state(argv)
            st = sim.step_frame(cfg, scn, st)
            st, summaries[label] = run_path(cfg, scn, st, frames, kernels,
                                            label, bypassed)
            record_peak(summaries[label], held)
            syncs = stream_syncs(lambda: sim.step_frame(cfg, scn, st))
            summaries[label]["syncs_per_frame"] = syncs
            log(f"   {label}: {syncs} stream syncs in a frame")
            if scn.num_sources:
                # a source cell keeps the divergence of its inflow (the
                # JAX package's too: max |div| = 3.0566 at source cells
                # 5 frames into the converged waterfall at 128² and 256²
                # in both), so the projection is judged away from them
                away = div_inf(cfg, st, scn.source)
                summaries[label]["div_inf_off_sources"] = away
                log(f"   {label}: div_inf {summaries[label]['div_inf']:.6g} "
                    f"on all fluid cells, {away:.6g} off the source cells")
            if label in ("cli_waterfall_1024", "cli_waterfall_1080p"):
                check(summaries[label]["div_inf_off_sources"] <= 1.0,
                      f"{label}: div_inf off the sources > 1")
            if label == "cli_dam_break_1200":
                check(summaries[label]["div_inf"] <= 1.0,
                      f"{label}: div_inf > 1")
            if "P3" in kernels:  # every substep's solve, active or not
                got = summaries[label]["launches"]["P3"]
                check(got == cfg.max_substeps * frames,
                      f"{label}: P3 launched {got} times in {frames} "
                      "frames")
            if label == "cli_filter_no_pallas":
                for k in kernels:  # once a substep, every substep
                    got = summaries[label]["launches"].get(k, 0)
                    check(got == cfg.max_substeps * frames,
                          f"{label}: {k} launched {got} times in {frames} "
                          "frames")
            states[label] = (cfg, scn, st)
        if profile_prefix:
            with Phase(f"{label}: profile"):
                profile(cfg, scn, st, f"{profile_prefix}.{label}.txt", label)
    launches["S1"] = summaries["cli_waterfall"]["launches"]["S1"]
    for k in ("G1", "G2"):
        launches[k] = summaries["cli_filter_no_pallas"]["launches"][k]

    with Phase("S1, K1, K7, K8 vs plain at 40x100 and 40x99; render; "
               "checkpoint"):
        cfg, scn, st = states["cli_waterfall"]
        errs = check_small_kernels(cfg, scn, st, "40x100")
        s1_err = check_s1(cfg, scn, st, "40x100")
        cfg99, scn99, st99 = cli_state(["scenarios/waterfall.txt", "--size",
                                        "40x99"])
        for _ in range(20):
            st99 = sim.step_frame(cfg99, scn99, st99)
        for k, e in check_small_kernels(cfg99, scn99, st99,
                                        "40x99").items():
            errs[k] = max(errs[k], e)
        s1_err = max(s1_err, check_s1(cfg99, scn99, st99, "40x99"))
        bcfg, bscn, bst = states["cli_waterfall_1024"]
        s1_err = max(s1_err, check_s1(bcfg, bscn, bst, "1024²"))
        results["S1"] = {"max_abs_err": s1_err}
        summaries["small_grid_max_abs_err"] = errs
        time_s1(cfg, scn, st, results)
        check_render(cfg, scn, st, "waterfall 40x100",
                     [(30, 110), (20, 50), (12, 40)])
        check_render(bcfg, bscn, bst, "waterfall 1024²", [(24, 80)])
        check_checkpoint(cfg, scn, st, "waterfall 40x100")
        check_checkpoint(bcfg, bscn, bst, "waterfall 1024²")

    run_padded_mg(results, summaries, launches, states)
    del states


def check_p3_hierarchy(cfg, b, a_diag, fl, label: str) -> None:
    """The packed level 0 (padded where the grid is odd), every coarse
    level's c, e, n planes and the Chebyshev rows P3 builds on the card
    for a solve of (b, a_diag, fl) bitwise equal to `mg_host_operands`
    (its levels padded as the JAX hierarchy pads them); then one
    preconditioner application on b through the coarse cycle and through
    one launch per level operation, bitwise equal."""
    import torch

    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    p12.solve_pressure_general(cfg, b, a_diag, fl)
    ws = p12.workspace(cfg, b.device)
    shapes, packed0, planes, rows = k3.mg_host_operands(cfg, a_diag, fl)
    check(ws.shapes == shapes, f"P3 at {label}: level plan {ws.shapes}")
    check(torch.equal(ws.packed0, packed0), f"P3 at {label}: packed plane "
          "differs")
    for l, (want, got) in enumerate(zip(planes, ws.levels), start=1):
        for name, a, c in zip("cen", want, got):
            check(torch.equal(a, c), f"P3 at {label}: hierarchy level {l} "
                  f"{name} differs from mg_host_operands")
    check(torch.equal(ws.rows, rows), f"P3 at {label}: Chebyshev rows "
          "differ from mg_host_operands")
    Y0, X0 = shapes[0]
    r = torch.nn.functional.pad(b, (0, X0 - cfg.nx, 0, Y0 - cfg.ny))
    fused, per_op = ws.cycle(r, per_op=False), ws.cycle(r, per_op=True)
    check(bool(fused.abs().max() > 0), f"P3 at {label}: the cycle returned "
          "zero")
    check(torch.equal(fused, per_op), f"P3 at {label}: the coarse cycle in "
          "one launch differs from one launch per level operation")
    log(f"   P3 at {label}: levels {shapes}; hierarchy and Chebyshev rows "
        f"{tuple(rows.shape)} bitwise equal to mg_host_operands; coarse "
        "cycle bitwise equal to one launch per level operation")


P3_TIMED = ("cli_dam_break_1200", "cli_waterfall_1080p")  # the line's last


def run_padded_mg(results, summaries, launches, states) -> None:
    """P3 on the states of the CLI's 1080 x 1920 waterfall and 1200² dam
    break: against its plain version (cold and warm, and capped at 3
    iterations, which it must take exactly), its hierarchy, rows and
    coarse cycle bitwise, then timed beside its plain version."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    systems = {}
    with Phase("P3 vs plain at 1080x1920 and 1200²: cold, warm, capped at "
               "3; hierarchy and coarse cycle bitwise"):
        err = 0.0
        for label in P3_TIMED:
            cfg, scn, st = states[label]
            check(sim.route(cfg, scn)[1] == "P3", f"{label}: not P3")
            _, _, _, b, a_diag = substep_system(cfg, scn, st)
            fl = st.fluid
            p0 = torch.where(fl, st.p, 0.0)
            systems[label] = (cfg, b, a_diag, fl, p0)
            for x0 in (None, p0):
                err = max(err, check_solve(
                    f"P3 {'warm' if x0 is not None else 'cold'} "
                    f"{cfg.ny}x{cfg.nx}",
                    p12.solve_pressure_general(cfg, b, a_diag, fl, x0=x0),
                    p12.solve_pressure_general_plain(cfg, b, a_diag, fl, x0),
                    5e-4, same_iters=False))
            check_p3_hierarchy(cfg, b, a_diag, fl, f"{cfg.ny}x{cfg.nx}")
        cfg, b, a_diag, fl, p0 = systems["cli_dam_break_1200"]
        capped = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, max_iterations=3))
        got = p12.solve_pressure_general(capped, b, a_diag, fl, x0=p0)
        want = p12.solve_pressure_general_plain(capped, b, a_diag, fl, p0)
        check(int(got[1]) == int(want[1]) == 3, "P3 capped at 3 iterations "
              "did not take exactly 3")
        err = max(err, check_solve("P3 (max_iterations 3) 1200x1200", got,
                                   want, 5e-4, same_iters=True))
        results["P3"] = {"max_abs_err": err}

    with Phase("P3 vs plain times at 1200² and 1080x1920 (CUDA events)"):
        for label in P3_TIMED:
            cfg, b, a_diag, fl, p0 = systems[label]
            timed = {}
            time_pair(timed, "P3",
                      lambda: p12.solve_pressure_general(cfg, b, a_diag, fl,
                                                         x0=p0),
                      lambda: p12.solve_pressure_general_plain(
                          cfg, b, a_diag, fl, p0),
                      cfg.ny * cfg.nx, 0, 2)
            summaries[f"p3_{label}"] = timed["P3"]
        # the kernels line keeps the 1080 x 1920 call
        results["P3"].update(timed["P3"])
    launches["P3"] = summaries["cli_waterfall_1080p"]["launches"]["P3"]


# RB-GS and rediscretized MG on one card: setting: (solver change, the
# solve's launch count, its KERNELS key)
SMOOTHERS = {
    "rbgs": (dict(mg_smoother="rbgs"), "P3", "P3_rbgs"),
    "rediscretize": (dict(mg_scheme="rediscretize"), "P7", "P7"),
}
SMOOTHER_FRAMES = 2   # frames of the 1024² dam break with each setting
SMOOTHER_SYSTEMS = ("cli_dam_break_1024", "cli_waterfall_1080p")
# p of an f64 solve against its plain version, over its scale
# (F64_BLOCK_RTOL's), both stopped at a residual of 1e-10 (P7's PCG
# amplifies rounding: at the CLI's tol of 1e-6 its f64 solve stopped
# 6.6e-6 of scale from the plain one at 1024²)
SMOOTHER_F64_RTOL = 1e-10
SMOOTHER_F64_RULE = dict(tol=1e-10, tol_rel=1e-10, max_iterations=400)


def rbgs_cycle_ops(cfg) -> float:
    """The operations a level-0 cell of one MG cycle with RB-GS smoothing
    (P3-rbgs: the Galerkin truncated W on the padded levels; P7: the
    rediscretized V) must do on cfg's levels, every cell of a level
    counted, each operation once.  A half-sweep updates one colour, half
    the cells, each with A x, the residual, its scaling by the inverse
    diagonal and the add: 8 at a 5-point level (a x, three adds and a
    subtract: P3's packed level 0, every P7 level), 12 at a Galerkin edge
    level (five products, four adds); the first pre half-sweep, from
    zero, is one product.  A restriction takes the residual once a fine
    cell (6 / 10) and its sum: P3 the 2x2 block sum (3 adds a coarse
    cell), P7 16 weighted terms (32 a coarse cell); a prolongation, P3 one
    add a fine cell, P7 four products and four adds.  The coarsest level
    takes 4 mg_coarse_iters half-sweeps, the first from zero."""
    from euler_tpu_torch.ops.cuda import mg_kernel as k3

    s = cfg.solver
    redisc = s.mg_scheme == "rediscretize"
    shapes = (k3.rediscretized_shapes if redisc else
              k3.padded_level_shapes)(cfg.ny, cfg.nx, s.mg_min_size)
    last = len(shapes) - 1
    w = 2 if not redisc and s.mg_cycle == "w" else 1
    ops, reach = 0.0, 1  # reach: the visits of level l a cycle
    for l, (Y, X) in enumerate(shapes):
        n = Y * X
        half = (8 if redisc or l == 0 else 12) * n / 2

        def sweeps(k, from_zero):
            return (n / 2 + (2 * k - 1) * half) if from_zero and k else (
                2 * k * half)

        if l == last:
            ops += reach * sweeps(2 * s.mg_coarse_iters, True)
            break
        nc = shapes[l + 1][0] * shapes[l + 1][1]
        v = w if l < s.mg_w_depth and l + 1 < last else 1
        resid = (8 if redisc or l == 0 else 12) - 2
        transfer = (resid * n + 32 * nc + 8 * n if redisc
                    else resid * n + 3 * nc + n)
        ops += reach * (sweeps(s.mg_pre_smooth, True) + v * transfer
                        + sweeps(s.mg_post_smooth, False))
        reach *= v
    return ops / (shapes[0][0] * shapes[0][1])


def with_solver(cfg, **change):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                               **change))


@contextlib.contextmanager
def solve_iterations(plain: bool = False):
    """Within: every general solve (`solve_pressure_general`, which
    `project()` calls for P1, P3 and P7) keeps its iteration count, a
    device tensor read once the block ends, into the list yielded; with
    `plain`, the solves run the plain version instead (on the card's
    tensors)."""
    import torch

    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    real, iters = p12.solve_pressure_general, []

    def solve(cfg, b, a_diag, fluid, x0=None, solid=None):
        out = (p12.solve_pressure_general_plain(cfg, b, a_diag, fluid, x0,
                                                solid)
               if plain else real(cfg, b, a_diag, fluid, x0=x0, solid=solid))
        iters.append(out[1])
        return out

    p12.solve_pressure_general = solve
    counts = []
    try:
        yield counts
    finally:
        p12.solve_pressure_general = real
        counts += [int(i) for i in torch.stack(iters).tolist()] if iters \
            else []


def check_smoother_build(cfg, b, a_diag, fl, solid, label: str) -> None:
    """After a solve of (b, a_diag, fl, solid): P7's hierarchy (every
    level's fluid and solid masks, a_diag and inv_diag) bitwise the plain
    `build_hierarchy` and its masks' coarsening, and one V-cycle on b
    within 1e-6 (f32) / 1e-12 (f64) of scale of `v_cycle`'s (the same
    operations in the same order); P3-rbgs's cycle through
    coarse_cycle_rbgs bitwise its cycle through one launch per half-sweep
    and level operation."""
    import torch

    from euler_tpu_torch.ops import multigrid
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    ws = p12.workspace(cfg, b.device)
    s = cfg.solver
    if s.mg_scheme == "rediscretize":
        want = multigrid.build_hierarchy(solid, fl, b.dtype,
                                         min_size=s.mg_min_size)
        check(len(want) == len(ws.levels), f"P7 {label}: {len(ws.levels)} "
              f"levels, the plain build {len(want)}")
        so = solid
        for l, (lw, got) in enumerate(zip(want, ws.levels)):
            if l:
                so = multigrid.coarsen_masks(so, want[l - 1].fluid)[0]
            for name, w, g in zip(("fluid", "solid", "a_diag", "inv_diag"),
                                  (lw.fluid, so, lw.a_diag, lw.inv_diag),
                                  got):
                check(torch.equal(w, g), f"P7 {label}: level {l} {name} "
                      "differs from build_hierarchy")
        got = ws.cycle(b)
        want = multigrid.make_mg_preconditioner(cfg, solid, fl, b.dtype)(b)
        scale = want.abs().max().item()
        e = (got - want).abs().max().item()
        rel = 1e-6 if b.dtype == torch.float32 else 1e-12
        check(scale > 0 and e <= rel * scale, f"P7 {label}: its V-cycle "
              f"differs from v_cycle by {e:.3g} (scale {scale:.3g})")
        log(f"   P7 {label}: levels {ws.shapes}; masks, a_diag and inv_diag "
            f"bitwise build_hierarchy; one V-cycle {e:.3g} from v_cycle "
            f"(scale {scale:.3g}, atol {rel:g}*scale; bitwise: "
            f"{torch.equal(got, want)})")
        return
    Y0, X0 = ws.shapes[0]
    r = torch.nn.functional.pad(b, (0, X0 - cfg.nx, 0, Y0 - cfg.ny))
    fused, per_op = ws.cycle(r, per_op=False), ws.cycle(r, per_op=True)
    check(bool(fused.abs().max() > 0), f"P3-rbgs {label}: the cycle "
          "returned zero")
    check(torch.equal(fused, per_op), f"P3-rbgs {label}: coarse_cycle_rbgs "
          "differs from one launch per level operation")
    plan = ws.plan()
    log(f"   P3-rbgs {label}: coarse cycle from level {plan['fused']} "
        f"{ws.shapes[plan['fused']]}, bitwise one launch per half-sweep and "
        "level operation")


def run_mg_smoothers(results, summaries, launches) -> dict:
    """RB-GS and rediscretized MG on one card (P3-rbgs, P7), after every
    other timed phase (its states and workspaces then change no earlier
    phase's allocations): the CLI's 1024² dam break and 1080 x 1920
    waterfall stepped as its in-process runs step them (a warm-up frame
    and their counted frames); 2 frames of the dam break with each
    setting from that state (K1,
    K7 and the solve once a substep; no K2, K3, K11 or plain version;
    div_inf <= 1, or where a solve stopped at its cap, at most twice the
    plain version's on the same frames); on that frame's end state and
    on the 1080 x 1920 waterfall's, the solve against its plain version,
    cold and warm (p within 5e-4 of scale, iterations within 1), warm in
    f64 stopped at a residual of 1e-10 (SMOOTHER_F64_RULE: 1e-10 of
    scale, iterations within 1; beside it, how far the f32 solve's p
    lies from that f64 one),
    P7's hierarchy bitwise and its V-cycle at the plain `v_cycle`'s,
    P3-rbgs's coarse cycle bitwise one launch per operation (f32 and
    f64), capped at 3 (exactly 3); then each timed beside its plain
    version on the 1080 x 1920 system.  Returns those systems, whose
    device time is taken at the end."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    with Phase("the CLI's 1024² dam break and 1080x1920 waterfall states "
               "for RB-GS and rediscretized MG"):
        states = {}
        for label in SMOOTHER_SYSTEMS:
            argv, frames = CLI_RUNS[label][:2]
            cfg, scn, st = cli_state(argv)
            for _ in range(1 + frames):
                st = sim.step_frame(cfg, scn, st)
            states[label] = (cfg, scn, st)
    systems = {}
    for kind, (change, name, key) in SMOOTHERS.items():
        other = "P7" if name == "P3" else "P3"
        label = f"{kind}_dam_break_1024"
        with Phase(f"{kind} MG ({name}): {SMOOTHER_FRAMES} frames of the "
                   f"1024² dam break; {name} vs plain on it and at 1080x1920 "
                   "(cold, warm, f64, capped at 3), its build bitwise"):
            cfg0, scn, st0 = states[SMOOTHER_SYSTEMS[0]]
            cfg = with_solver(cfg0, **change)
            sim.check_slice(cfg, scn)
            check(sim.route(cfg, scn) == ("plain", name),
                  f"{label}: route {sim.route(cfg, scn)}")
            held = reset_peak()
            with solve_iterations() as iters:
                st, summaries[label] = run_path(
                    cfg, scn, st0, SMOOTHER_FRAMES, ["K1", "K7", name],
                    label, ["K2", "K3", "K11", "K8", "K12", "P1", other,
                            "S1"])
            record_peak(summaries[label], held)
            got = summaries[label]["launches"][name]
            check(got == cfg.max_substeps * SMOOTHER_FRAMES,
                  f"{label}: {name} launched {got} times in "
                  f"{SMOOTHER_FRAMES} frames")
            capped = sum(i >= cfg.solver.max_iterations for i in iters)
            summaries[label].update(max_iterations_a_solve=max(iters),
                                    solves_at_cap=capped)
            limit = 1.0
            if capped:
                # a solve stopped at its cap: the frames are held to the
                # plain version's div_inf on the same card state
                with solve_iterations(plain=True):
                    st_p = st0
                    for _ in range(SMOOTHER_FRAMES):
                        st_p = sim.step_frame(cfg, scn, st_p)
                limit = max(limit, 2 * div_inf(cfg, st_p))
            log(f"   {label}: {capped} of {len(iters)} solves stopped at the "
                f"cap of {cfg.solver.max_iterations}, the most "
                f"{max(iters)} iterations; div_inf "
                f"{summaries[label]['div_inf']:.6g} (limit {limit:.6g})")
            check(summaries[label]["div_inf"] <= limit,
                  f"{label}: div_inf > {limit:.6g}")
            err = 0.0
            for sys_label in SMOOTHER_SYSTEMS:
                c0, s_scn, s_st = states[sys_label]
                if sys_label == SMOOTHER_SYSTEMS[0]:
                    s_st = st
                c = with_solver(c0, **change)
                _, _, _, b, a_diag = substep_system(c, s_scn, s_st)
                fl, so = s_st.fluid, s_scn.solid
                p0 = torch.where(fl, s_st.p, 0.0)
                tag = f"{c.ny}x{c.nx}"
                c64 = with_solver(c, dtype="float64", **SMOOTHER_F64_RULE)
                for cc, x0, what, rtol in (
                        (c, None, "cold", 5e-4), (c, p0, "warm", 5e-4),
                        (c64, p0, "f64 warm", SMOOTHER_F64_RTOL)):
                    bb = b.to(getattr(torch, cc.solver.dtype))
                    x0 = None if x0 is None else x0.to(bb.dtype)
                    got = p12.solve_pressure_general(cc, bb, a_diag, fl,
                                                     x0=x0, solid=so)
                    want = p12.solve_pressure_general_plain(cc, bb, a_diag,
                                                            fl, x0, so)
                    e = check_solve(f"{name} ({kind}) {what} {tag}", got,
                                    want, rtol, same_iters=False)
                    if cc is c:
                        err = max(err, e)
                        p32 = got[0]
                    else:
                        check(int(want[1]) < cc.solver.max_iterations,
                              f"{name} ({kind}) f64 {tag}: the plain solve "
                              "stopped at its cap")
                        gap = (p32.double() - want[0]).abs().max().item()
                        log(f"   {name} ({kind}) {tag}: the f32 warm solve's "
                            f"p {gap / want[0].abs().max().item():.3g} of "
                            "scale from the f64 plain one")
                    if x0 is not None:
                        check_smoother_build(cc, bb, a_diag, fl, so,
                                             f"{tag} {cc.solver.dtype}")
                systems[(kind, sys_label)] = (c, b, a_diag, fl, so, p0)
            c, b, a_diag, fl, so, p0 = systems[(kind, SMOOTHER_SYSTEMS[1])]
            capped = with_solver(c, max_iterations=3)
            got = p12.solve_pressure_general(capped, b, a_diag, fl, x0=p0,
                                             solid=so)
            want = p12.solve_pressure_general_plain(capped, b, a_diag, fl,
                                                    p0, so)
            check(int(got[1]) == int(want[1]) == 3, f"{name} ({kind}) capped "
                  "at 3 iterations did not take exactly 3")
            err = max(err, check_solve(f"{name} ({kind}, max_iterations 3) "
                                       f"{c.ny}x{c.nx}", got, want, 5e-4,
                                       same_iters=True))
            results[key] = {"max_abs_err": err}

        with Phase(f"{name} ({kind}) vs plain times at 1080x1920 (CUDA "
                   "events)"):
            RBGS_FLOPS[key] = JACOBI_FLOPS + rbgs_cycle_ops(c)
            log(f"   {key}: {RBGS_FLOPS[key]:.4f} operations a cell an "
                "iteration (the loop's and rbgs_cycle_ops)")
            timed = {}
            time_pair(timed, key,
                      lambda: p12.solve_pressure_general(c, b, a_diag, fl,
                                                         x0=p0, solid=so),
                      lambda: p12.solve_pressure_general_plain(
                          c, b, a_diag, fl, p0, so),
                      c.ny * c.nx, 0, 2)
            iters = int(p12.solve_pressure_general(c, b, a_diag, fl, x0=p0,
                                                   solid=so)[1])
            summaries[f"{key}_waterfall_1080p"] = dict(timed[key],
                                                       iterations=iters)
            results[key].update(timed[key])
        launches[key] = summaries[label]["launches"][name]
    return {kind: systems[(kind, SMOOTHER_SYSTEMS[1])] for kind in SMOOTHERS}


def smoother_profiles(results, systems) -> None:
    """P3-rbgs's and P7's device time: the kernel spans of one warm solve
    of the 1080 x 1920 system each (torch.profiler), taken after every
    timed phase."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    with Phase("P3-rbgs and P7: kernel spans of one warm solve "
               "(torch.profiler)"):
        for kind, (cfg, b, a_diag, fl, so, p0) in systems.items():
            key = SMOOTHERS[kind][2]
            spans = kernel_spans_ms(lambda: p12.solve_pressure_general(
                cfg, b, a_diag, fl, x0=p0, solid=so))
            log(f"   {key} {cfg.ny}x{cfg.nx}: " + (
                f"kernel spans {spans[0]:.4f} ms summed (torch's copies "
                f"{spans[1]:.4f} ms)" if spans else "not measured (the "
                "profiler recorded no kernel)"))
            results[key]["device_ms"] = spans[0] if spans else None


# f64 MG on one card (P3 in double precision): the CLI's converged runs
# with solver.dtype "float64", label: (the f32 CLI run beside it, the
# kernels its frames must launch, those they must not, the level where
# the f64 coarse cycle takes over: 64² at 1024², where 128²'s lower
# levels would need 368,640 bytes of shared memory in f64; 68 x 120 at
# 1080 x 1920, as in f32)
F64_RUNS = {
    "f64_dam_break_1024": ("cli_dam_break_1024", ["K1", "K7", "P3"],
                           ["K2", "K3", "K11", "S1"], 4),
    "f64_waterfall_1080p": ("cli_waterfall_1080p", ["K1", "S1", "K7", "P3"],
                            ["K2", "K3", "K4", "K10", "K11"], 4),
}
F64_FRAMES = 2  # timed frames of each, f64 and f32, after 1 warm-up


def check_p3_plan(cfg, ws, fused: int, label: str) -> dict:
    """P3's coarse-cycle plan on the card (`MgGeneralWorkspace.plan`):
    the level where its one cluster launch takes over must be `fused`,
    and its shared memory the 9 planes of every level below it in the
    solver dtype, within what a CTA may have."""
    import torch

    plan = ws.plan()
    item = torch.finfo(getattr(torch, cfg.solver.dtype)).bits // 8
    want = sum(9 * item * Y * X for Y, X in ws.shapes[fused + 1:])
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", None)
    log(f"   P3 plan {label}: coarse cycle from level {plan['fused']} "
        f"{ws.shapes[plan['fused']]} of {plan['levels']}, {plan['smem']} "
        f"bytes of shared memory (a CTA's opt-in: {optin})")
    check(plan["fused"] == fused, f"P3 {label}: coarse cycle from level "
          f"{plan['fused']}, not {fused}")
    check(plan["smem"] == want, f"P3 {label}: {plan['smem']} bytes of "
          f"shared memory, not {want}")
    check(optin is None or plan["smem"] <= optin,
          f"P3 {label}: shared memory over the opt-in")
    return plan


def run_f64_mg(results, summaries, launches) -> dict:
    """f64 MG on one card: the CLI's converged 1024² dam break (K1, K7,
    P3) and 1080 x 1920 waterfall (K1, S1, K7, P3) with solver.dtype
    "float64", each beside its f32 config (1 warm-up frame on a copy, then
    F64_FRAMES timed frames of each from the same state); on the f64
    state, P3-f64 against its plain version (cold, warm, capped at 3:
    the same iterations, p within 1e-8 of scale), its hierarchy, rows and
    packed level 0 bitwise `mg_host_operands` in f64, its coarse cycle
    bitwise one launch per level operation, its plan, and its time beside
    the plain version's and P3-f32's on the f32 state's system.  Returns
    the f64 systems, whose device time is taken at the end."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    systems, err = {}, 0.0
    results["P3_f64"] = {}
    for label, (f32_label, kernels, bypassed, fused) in F64_RUNS.items():
        f32_kernels, f32_bypassed = CLI_RUNS[f32_label][2:]
        with Phase(f"{label}: f64 MG and f32 beside it, 1 warm-up frame "
                   f"on a copy + {F64_FRAMES} timed frames each; P3-f64 "
                   "vs plain (cold, warm, capped at 3), its hierarchy, "
                   "rows and coarse cycle bitwise, its plan, timed"):
            cfg32, scn, st0 = cli_state(CLI_RUNS[f32_label][0])
            cfg = dataclasses.replace(cfg32, solver=dataclasses.replace(
                cfg32.solver, dtype="float64"))
            sim.check_slice(cfg, scn)
            check(sim.route(cfg, scn) == ("plain", "P3"),
                  f"{label}: route {sim.route(cfg, scn)}")
            states = {}
            for c, name, ks, byp in ((cfg32, f"{label}_f32", f32_kernels,
                                      f32_bypassed),
                                     (cfg, label, kernels, bypassed)):
                held = reset_peak()
                sim.step_frame(c, scn, st0)  # the warm-up, discarded
                st, summaries[name] = run_path(c, scn, st0, F64_FRAMES, ks,
                                               name, byp)
                record_peak(summaries[name], held)
                d = (div_inf(c, st, scn.source) if scn.num_sources
                     else summaries[name]["div_inf"])
                summaries[name]["div_inf_off_sources"] = d
                log(f"   {name}: div_inf {d:.6g}"
                    + (" off the source cells" if scn.num_sources else ""))
                check(d <= 1.0, f"{name}: div_inf > 1")
                states[c.solver.dtype] = st
            got = summaries[label]["launches"]["P3"]
            check(got == cfg.max_substeps * F64_FRAMES,
                  f"{label}: P3 launched {got} times in {F64_FRAMES} frames")
            st = states["float64"]
            _, _, _, b, a_diag = substep_system(cfg, scn, st)
            fl = st.fluid
            check(b.dtype == torch.float64, f"{label}: the RHS is {b.dtype}")
            p0 = torch.where(fl, st.p, 0.0).to(b.dtype)
            tag = f"{cfg.ny}x{cfg.nx}"
            for x0 in (None, p0):
                err = max(err, check_solve(
                    f"P3-f64 {'warm' if x0 is not None else 'cold'} {tag}",
                    p12.solve_pressure_general(cfg, b, a_diag, fl, x0=x0),
                    p12.solve_pressure_general_plain(cfg, b, a_diag, fl, x0),
                    1e-8, same_iters=True))
            capped = dataclasses.replace(cfg, solver=dataclasses.replace(
                cfg.solver, max_iterations=3))
            got = p12.solve_pressure_general(capped, b, a_diag, fl, x0=p0)
            want = p12.solve_pressure_general_plain(capped, b, a_diag, fl,
                                                    p0)
            check(int(got[1]) == int(want[1]) == 3, f"P3-f64 {tag} capped "
                  "at 3 iterations did not take exactly 3")
            err = max(err, check_solve(f"P3-f64 (max_iterations 3) {tag}",
                                       got, want, 1e-8, same_iters=True))
            check_p3_hierarchy(cfg, b, a_diag, fl, f"{tag} f64")
            ws = p12.workspace(cfg, b.device)
            summaries[f"p3_f64_plan_{label}"] = check_p3_plan(
                cfg, ws, fused, f"{tag} f64")
            # the f32 system beside it: P3-f32 on the same grid (at 1024²
            # the f32 frames run K2 / K3, but P3 takes the system too)
            st32 = states["float32"]
            _, _, _, b32, a32 = substep_system(cfg32, scn, st32)
            fl32 = st32.fluid
            p032 = torch.where(fl32, st32.p, 0.0)
            ws32 = p12.workspace(cfg32, b32.device)
            p12.solve_pressure_general(cfg32, b32, a32, fl32, x0=p032)
            plan32 = ws32.plan()
            log(f"   P3 plan {tag} f32: coarse cycle from level "
                f"{plan32['fused']} {ws32.shapes[plan32['fused']]}, "
                f"{plan32['smem']} bytes of shared memory")
            timed = {}
            time_pair(timed, "P3_f64",
                      lambda: p12.solve_pressure_general(cfg, b, a_diag, fl,
                                                         x0=p0),
                      lambda: p12.solve_pressure_general_plain(
                          cfg, b, a_diag, fl, p0),
                      cfg.ny * cfg.nx, 0, 2)
            it64 = int(p12.solve_pressure_general(cfg, b, a_diag, fl,
                                                  x0=p0)[1])
            call32 = lambda: p12.solve_pressure_general(  # noqa: E731
                cfg32, b32, a32, fl32, x0=p032)
            t32 = min(cuda_ms(call32, REPS) for _ in range(2))
            it32 = int(call32()[1])
            timed["P3_f64"]["f32_ms"] = t32
            log(f"   P3 warm {tag}: f64 {timed['P3_f64']['ms']:.3f} ms "
                f"({it64} iterations), f32 {t32:.3f} ms ({it32} "
                f"iterations, the f32 state's system), CUDA events")
            summaries[f"p3_f64_{label}"] = dict(
                timed["P3_f64"], iterations=it64, f32_iterations=it32)
            # the kernels line keeps the 1080 x 1920 call
            results["P3_f64"].update(timed["P3_f64"])
            systems[label] = (cfg, b, a_diag, fl, p0)
            del states, st, st32, st0, ws, ws32
    results["P3_f64"]["max_abs_err"] = err
    launches["P3_f64"] = summaries["f64_waterfall_1080p"]["launches"]["P3"]
    return systems


def f64_profiles(results, systems) -> None:
    """P3-f64's device time: the kernel spans of one warm solve of each
    f64 system (torch.profiler), taken after every timed phase."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    with Phase("P3-f64: kernel spans of one warm solve (torch.profiler)"):
        for label, (cfg, b, a_diag, fl, p0) in systems.items():
            spans = kernel_spans_ms(lambda: p12.solve_pressure_general(
                cfg, b, a_diag, fl, x0=p0))
            log(f"   P3-f64 {cfg.ny}x{cfg.nx}: " + (
                f"kernel spans {spans[0]:.4f} ms summed (torch's copies "
                f"{spans[1]:.4f} ms)" if spans else "not measured (the "
                "profiler recorded no kernel)"))
            if label == "f64_waterfall_1080p":
                results["P3_f64"]["device_ms"] = spans[0] if spans else None


# the card tests the script runs last: (what they check, pytest -k
# selection, files)
CARD_TESTS = (
    ("the Jacobi, marker, grid-stage and source tests",
     "jacobi or tiles or launch_once or march_bitwise or rebin_bitwise or "
     "kernels_store or grid or source", ("tests/test_torch_cuda.py",)),
    ("the global layout's tests and the parity corpora on the card: "
     "tests/goldens to frame 50, tests/goldens/ref_binary to the JAX "
     "test's horizons", "global or general or ic0 or slot or card",
     ("tests/test_torch_cuda_global.py", "tests/test_torch_goldens.py",
      "tests/test_torch_ref_binary.py")),
    ("P3's tests beside the 1200² and 1080x1920 checks above",
     "999 or 2160 or zero or workspace or f64",
     ("tests/test_torch_cuda_mg_padded.py",)),
    ("P3-rbgs's and P7's tests: 999² and 1080 x 1920, f32 and f64, P7's "
     "hierarchy and cycle, a zero RHS and the cap, P3-rbgs's plan and "
     "workspace, its coarse cycle bitwise one launch per operation",
     "rbgs or rediscretize or p7",
     ("tests/test_torch_cuda_mg_rbgs.py", "tests/test_torch_cuda.py")),
    ("the batch's tests: each instance of an interleaved batch bitwise "
     "equal to it alone", "alone", ("tests/test_torch_cuda_batch.py",)),
    ("the row-shard, row-block, column-block, P5 and P6 tests (f32 and "
     "f64) and the dry run on one NCCL rank",
     "shards or identity or dryrun or row_blocks or p4 or row_frame or "
     "col_blocks or col_frame or p5 or p6",
     ("tests/test_torch_cuda_shard.py",)),
)
CARD_TESTS_S = 900  # seconds the card tests may take, all at once


def run_card_tests(tests=CARD_TESTS) -> None:
    """Every (what, selection, files) of `tests`: the card tests of
    `files` that `selection` picks (pytest -k), each in a process of its
    own on the libraries built here, all started at once (they share the
    card; none is timed); fails unless every one of them passes.  Stops
    every process it started."""
    import tempfile

    root = Path(__file__).resolve().parent
    deadline = time.perf_counter() + CARD_TESTS_S
    running = []
    try:
        for what, selection, files in tests:
            out = tempfile.TemporaryFile("w+")
            proc = subprocess.Popen(
                [sys.executable, "-m", "pytest", "--noconftest", "-q",
                 "-p", "no:cacheprovider", *files, "-k", selection],
                cwd=root, stdout=out, stderr=subprocess.STDOUT, text=True)
            running.append((what, selection, proc, out))
        for what, selection, proc, out in running:
            try:
                rc = proc.wait(max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = None
            out.seek(0)
            text = out.read()
            log(f"   {what} (pytest -k \"{selection}\"):")
            for line in text.strip().splitlines()[-2:]:
                log(f"     {line}")
            check(rc == 0, f"card tests -k {selection} failed (rc {rc}):"
                  f"\n{text[-6000:]}")
    finally:
        for _, _, proc, out in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


GLOBAL_SIZE = 1024  # the global-layout dam break timed here
P1_SIZE = 2204      # beyond K8's gate, and 2204 % 8 = 4: no kernel but P1
IC0_SIZE = 256      # P2 beside the reference's 40 x 100


def golden_cfg(**over):
    """The JAX golden and ref-binary tests' configuration: the default
    `SimConfig` (global layout, Jacobi) with an f64 solve and
    max_iterations 400; `over` replaces SolverConfig fields."""
    from euler_tpu_torch.config import SimConfig, SolverConfig

    solver = dict(dtype="float64", max_iterations=400)
    solver.update(over)
    return SimConfig(solver=SolverConfig(**solver))


def check_g1(cfg, scn, st, dt, label: str) -> int:
    """G1 against its plain version on the card (`advect_plain` on the
    same card tensors): the marched store and the pass count bitwise.
    Returns the passes."""
    import torch

    from euler_tpu_torch.ops.cuda import global_marker_kernel as g12
    from euler_tpu_torch.ops.markers import advect_plain

    got, p_k = g12.advect_global(cfg, scn, st, dt)
    want, p_p = advect_plain(cfg, scn, st.u, st.v, st.fluid, st.markers,
                             st.alive, dt)
    check(int(p_k) == int(p_p), f"G1 at {label}: {int(p_k)} passes, the "
          f"plain version {int(p_p)}")
    check(torch.equal(got, want), f"G1 at {label}: the store differs from "
          "the plain version")
    log(f"   G1 at {label} (dt {float(dt):.6g}): store bitwise, "
        f"{int(p_k)} dt-carry passes as the plain version")
    return int(p_k)


def check_g2(cfg, scn, markers, alive, label: str) -> int:
    """G2 against `refresh_plain` on the card: store, alive, counts and
    the survivors bitwise.  Returns the markers it deleted."""
    import torch

    from euler_tpu_torch.ops.cuda import global_marker_kernel as g12
    from euler_tpu_torch.ops.markers import refresh_plain

    got = g12.refresh_global(cfg, scn, markers, alive)
    want = refresh_plain(cfg, scn, markers, alive)
    for g, w, what in zip(got, want, ("store", "alive", "counts", "n2")):
        check(torch.equal(g, w), f"G2 at {label}: {what} differs from the "
              "plain version")
    deleted = int(alive.sum()) - int(got[3])
    log(f"   G2 at {label}: store, alive, counts, n2 bitwise; {deleted} "
        "markers deleted")
    return deleted


def doomed(scn, st, seed: int):
    """`st` with a seeded 5% of its live markers (the first and the last
    included) moved into sink or solid cells: its refresh deletes markers
    below and above the survivors' count."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n = int(st.alive_count)
    dead = torch.nonzero(scn.sink | scn.solid).cpu()
    pick = torch.randperm(n, generator=g)[:max(4, n // 20)]
    pick[:2] = torch.tensor([0, n - 1])
    cells = dead[torch.randint(len(dead), (len(pick),), generator=g)]
    markers = st.markers.clone()
    dev = markers.device
    markers[0, pick.to(dev)] = cells[:, 1].to(dev, torch.float32) + 0.5
    markers[1, pick.to(dev)] = cells[:, 0].to(dev, torch.float32) + 0.5
    return markers


def check_s1_global(cfg, scn, st, label: str) -> None:
    """S1's global form against `source_pass_global` on the card, from
    copies of `st`: as it is, inactive, and with alive_count at
    max_markers - 3; every field it writes bitwise."""
    import torch

    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.markers import source_pass_global

    for case in ("as is", "inactive", "exhaustion"):
        base = s1_copy(st)
        if case == "exhaustion":
            base.alive_count.fill_(cfg.max_markers - 3)
        act = torch.tensor(case != "inactive", device=st.u.device)
        got, want = s1_copy(base), s1_copy(base)
        s1.emit_sources(cfg, scn, got, act)
        source_pass_global(cfg, scn, want, act)
        for k in S1_FIELDS:
            a, b = getattr(got, k), getattr(want, k)
            check(torch.equal(a.to(torch.int64), b.to(torch.int64))
                  if k == "rng" else torch.equal(a, b),
                  f"S1 (global) at {label} ({case}): {k} differs from the "
                  "plain version")
        emitted = int(got.alive_count) - int(base.alive_count)
        log(f"   S1 (global) at {label} ({case}): every field bitwise; "
            f"{emitted} markers emitted")
        if case != "as is":
            check(emitted == (0 if case == "inactive" else 2),
                  f"S1 (global) at {label} ({case}): {emitted} emitted")


def check_p2(a_diag, fl, dtype, label: str) -> float:
    """P2 (the IC(0) apply) against its plain version on the card, on a
    seeded r: within relative 1e-12 (f64).  Returns the max error."""
    import torch

    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12
    from euler_tpu_torch.ops.ic0 import make_ic0_preconditioner

    g = torch.Generator(device=fl.device).manual_seed(7)
    r = torch.where(fl, torch.randn(fl.shape, generator=g, device=fl.device,
                                    dtype=dtype), 0.0)
    z = p12.ic0_apply(a_diag, fl, r)
    want = make_ic0_preconditioner(a_diag, fl, dtype)(r)
    scale = want.abs().max().item()
    err = (z - want).abs().max().item()
    Y, X = fl.shape
    log(f"   P2 at {label}: max err {err:.3g} of scale {scale:.3g} (rtol "
        f"1e-12); {Y + X - 1} dependent diagonal steps a sweep")
    check(scale > 0 and err <= 1e-12 * scale, f"P2 at {label}: differs "
          "> 1e-12 relative")
    return err


def run_global(results, summaries, launches, profile_prefix=None):
    """The global layout and the general solve: G1, G2, S1's global form,
    P1 and P2 against their plain versions on the card; the 1024² global
    dam break timed with f32 Jacobi (G1, G2, K7, K8) and f64 Jacobi (P1);
    the IC(0) path (P1, P2) at 40 x 100; each new kernel timed beside its
    plain version."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.core.scenario import load_scenario
    from euler_tpu_torch.ops.cuda import global_marker_kernel as g12
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12
    from euler_tpu_torch.ops.markers import advect_plain, refresh_plain

    dev = torch.device("cuda", 0)
    errs = {"G1": 0.0, "G2": 0.0, "P1": 0.0, "P2": 0.0}
    with Phase("global layout: G1, G2, S1's global form, P1, P2 vs plain "
               "on the card"):
        cfg = golden_cfg()
        scn, st = load_scenario("scenarios/filter.txt", cfg, device=dev)
        states = {}
        for frame in range(1, 29):
            st = sim.step_frame(cfg, scn, st)
            if frame in (27, 28):
                states[frame] = st
        one = torch.ones((), device=dev)
        passes = []
        for frame, st in states.items():
            dt, *_ = substep_system(cfg, scn, st)
            passes.append(check_g1(cfg, scn, st, dt, f"filter frame {frame}"))
            passes.append(check_g1(cfg, scn, st, one,
                                   f"filter frame {frame}, dt 1"))
            check_g2(cfg, scn, st.markers, st.alive, f"filter frame {frame}")
            check_g2(cfg, scn, doomed(scn, st, frame), st.alive,
                     f"filter frame {frame}, 5% doomed")
        check(max(passes) > 1, "G1: no dt-carry event fired past frame 26")
        wcfg = golden_cfg()
        wscn, wst = load_scenario("scenarios/waterfall.txt", wcfg,
                                  device=dev)
        for _ in range(4):
            wst = sim.step_frame(wcfg, wscn, wst)
        check_s1_global(wcfg, wscn, wst, "waterfall frame 4")

        st27 = states[27]
        dt, ut, vt, b, a_diag = substep_system(cfg, scn, st27)
        fl = st27.fluid
        for precon in ("jacobi", "none", "ic0"):
            pcfg = golden_cfg(preconditioner=precon)
            errs["P1"] = max(errs["P1"], check_solve(
                f"P1 f64 {precon} 40x100",
                p12.solve_pressure_general(pcfg, b, a_diag, fl),
                p12.solve_pressure_general_plain(pcfg, b, a_diag, fl),
                1e-9, same_iters=False))
        errs["P2"] = check_p2(a_diag, fl, torch.float64, "40x100")

        gcfg = golden_cfg()
        gcfg = dataclasses.replace(gcfg, nx=IC0_SIZE, ny=IC0_SIZE)
        gscn, gst = dam_break(gcfg, device=dev)
        for _ in range(3):
            gst = sim.step_frame(gcfg, gscn, gst)
        from euler_tpu_torch.ops.project import pressure_matrix_diag

        ic0_systems = {"40x100": (a_diag, fl),
                       f"{IC0_SIZE}²": (pressure_matrix_diag(
                           gcfg, gscn.solid, gst.fluid), gst.fluid)}
        errs["P2"] = max(errs["P2"], check_p2(
            *ic0_systems[f"{IC0_SIZE}²"], torch.float64, f"{IC0_SIZE}²"))
        del states, gst, gscn

    with Phase(f"P1: f32 Jacobi at {P1_SIZE}² (beyond K8's gate, rows not "
               "a multiple of 8)"):
        from euler_tpu_torch.config import SimConfig

        jcfg = SimConfig(nx=P1_SIZE, ny=P1_SIZE)  # f32 Jacobi, global
        jscn, jst = dam_break(jcfg, device=dev)
        check(sim.route(jcfg, jscn)[1] == "P1",
              f"{P1_SIZE}²: route {sim.route(jcfg, jscn)}")
        _, _, _, b, a_diag = substep_system(jcfg, jscn, jst)
        errs["P1"] = max(errs["P1"], check_solve(
            f"P1 f32 jacobi {P1_SIZE}²",
            p12.solve_pressure_general(jcfg, b, a_diag, jst.fluid),
            p12.solve_pressure_general_plain(jcfg, b, a_diag, jst.fluid),
            5e-4, same_iters=False))
        del jscn, jst, b, a_diag
        torch.cuda.empty_cache()

    from euler_tpu_torch.config import SimConfig, SolverConfig

    size = GLOBAL_SIZE
    base = ["K1", "K2", "K3", "K4", "K5", "K6", "K9", "K10", "K11", "K12",
            "S1"]
    paths = {
        "global_f32": (SimConfig(nx=size, ny=size),
                       ["G1", "G2", "K7", "K8"], base + ["P1", "P2"]),
        "global_f64": (SimConfig(nx=size, ny=size, solver=SolverConfig(
            dtype="float64")), ["G1", "G2", "K7", "P1"],
            base + ["K8", "P2"]),
    }
    kept = {}
    for label, (pcfg, kernels, bypassed) in paths.items():
        with Phase(f"{label}: the {size}² dam break, global layout, "
                   f"{ROUTE_WARMUP} warm-up + {ROUTE_FRAMES} timed frames"):
            held = reset_peak()
            pscn, pst = dam_break(pcfg, device=dev)
            for _ in range(ROUTE_WARMUP):
                pst = sim.step_frame(pcfg, pscn, pst)
            pst, summaries[label] = run_path(pcfg, pscn, pst, ROUTE_FRAMES,
                                             kernels, label, bypassed)
            record_peak(summaries[label], held)
            syncs = stream_syncs(lambda: sim.step_frame(pcfg, pscn, pst))
            summaries[label]["syncs_per_frame"] = syncs
            log(f"   {label}: {syncs} stream syncs in a frame")
            for k in ("G1", "G2", "K7"):
                got = summaries[label]["launches"].get(k, 0)
                check(got == pcfg.max_substeps * ROUTE_FRAMES,
                      f"{label}: {k} launched {got} times")
            kept[label] = (pcfg, pscn, pst)
        if profile_prefix:
            with Phase(f"{label}: profile"):
                profile(pcfg, pscn, pst, f"{profile_prefix}.{label}.txt",
                        label)
    launches["P1"] = summaries["global_f64"]["launches"]["P1"]

    with Phase("G1, G2 at the 1024² global state; the IC(0) path at "
               "40x100 (P1, P2), 2 frames"):
        pcfg, pscn, pst = kept["global_f32"]
        dt, ut, vt, b, a_diag = substep_system(pcfg, pscn, pst)
        one = torch.ones((), device=dev)
        check_g1(pcfg, pscn, pst, dt, f"{size}²")
        check_g1(pcfg, pscn, pst, one, f"{size}², dt 1")
        marched, _ = g12.advect_global(pcfg, pscn, pst, dt)
        check_g2(pcfg, pscn, marched, pst.alive, f"{size}²")
        check_g2(pcfg, pscn, doomed(pscn, pst, 3), pst.alive,
                 f"{size}², 5% doomed")
        icfg = golden_cfg(preconditioner="ic0")
        iscn, ist = load_scenario("scenarios/filter.txt", icfg, device=dev)
        for _ in range(26):  # the first frames hold no pressure
            ist = sim.step_frame(icfg, iscn, ist)
        ist, summaries["ic0_40x100"] = run_path(
            icfg, iscn, ist, 2, ["G1", "G2", "K7", "P1", "P2"], "ic0_40x100",
            base + ["K8"])
        launches["P2"] = summaries["ic0_40x100"]["launches"]["P2"]
        for k in errs:
            results.setdefault(k, {})["max_abs_err"] = errs[k]

    with Phase("G1, G2, P1, P2 vs plain times (CUDA events)"):
        n_cells = pcfg.nx * pcfg.ny
        n_live = int(pst.alive_count)
        time_pair(results, "G1",
                  lambda: g12.advect_global(pcfg, pscn, pst, dt),
                  lambda: advect_plain(pcfg, pscn, pst.u, pst.v, pst.fluid,
                                       pst.markers, pst.alive, dt),
                  n_cells, n_live, REPS)
        time_pair(results, "G2",
                  lambda: g12.refresh_global(pcfg, pscn, marched, pst.alive),
                  lambda: refresh_plain(pcfg, pscn, marched, pst.alive),
                  n_cells, n_live, REPS)
        fcfg, fscn, fst = kept["global_f64"]
        _, _, _, fb, fa = substep_system(fcfg, fscn, fst)
        time_pair(results, "P1",
                  lambda: p12.solve_pressure_general(fcfg, fb, fa, fst.fluid),
                  lambda: p12.solve_pressure_general_plain(fcfg, fb, fa,
                                                           fst.fluid),
                  n_cells, 0, 2)
        from euler_tpu_torch.ops.ic0 import make_ic0_preconditioner

        # P2 at the reference's 40 x 100 and at 256², not on the 1024²
        # frame loop; the kernels line keeps the 256² call
        for label, (ia, ifl) in ic0_systems.items():
            g = torch.Generator(device=dev).manual_seed(7)
            r = torch.where(ifl, torch.randn(ifl.shape, generator=g,
                                             device=dev,
                                             dtype=torch.float64), 0.0)
            timed = {}
            time_pair(timed, "P2", lambda: p12.ic0_apply(ia, ifl, r),
                      lambda: make_ic0_preconditioner(ia, ifl,
                                                      torch.float64)(r),
                      ifl.numel(), 0, REPS)
            Y, X = ifl.shape
            steps = 3 * (Y + X - 1)
            log(f"   P2 at {label}: {steps} dependent diagonal steps (E_inv,"
                f" forward, back; one CTA), "
                f"{1e3 * timed['P2']['device_ms'] / steps:.2f} us a step of "
                "its device time; its bound counts bytes and operations "
                "only")
            summaries[f"p2_{label}"] = timed["P2"]
            results.setdefault("P2", {}).update(timed["P2"])
    del kept
    torch.cuda.empty_cache()


# BASELINE.json's "1024² headless scaled grid, batch of 8 scenarios"
# (bench.py --batch 8): B dam breaks, seeds 0..B-1, stepped round-robin
BATCH = 8
BATCH_WARMUP = 1
BATCH_FRAMES = 4
BATCH_ALONE = (0, 7)  # instances also stepped alone: bitwise the batch's
TEXT_BATCH = ("basic", "block", "filter", "waterfall", "weird-edges")
TEXT_BATCH_FRAMES = 2
SHERLOCK_FRAMES = 20
SHERLOCK_CLI_FRAMES = 50  # each CLI process, with and without --sherlock


def torch_syncs(fn) -> int:
    """The stream synchronisations torch itself makes while `fn` runs (its
    sync debug mode's warnings: a host read of a device value; the
    solvers' own flag reads, made in their C code, are not counted)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def run_batch(summaries, launches, dev) -> None:
    """The single-card batch: BATCH dam breaks at the main path's config
    through `HostBatchRunner` (K1, K2, K3 once a substep an instance, one
    MG workspace for all), instances 0 and 7 stepped alone and held
    bitwise to the batch, one instance timed alone; the five text
    scenarios through `step_frame_batched` on the card against the CPU."""
    import torch

    from euler_tpu_torch import cli, sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import mg_kernel
    from euler_tpu_torch.parallel.batch import (
        HostBatchRunner,
        build_batch,
        step_frame_batched,
    )

    cfg = main_config(SIZE)
    Y, X, S = cfg.ny, cfg.nx, cfg.max_substeps
    with Phase(f"batch of {BATCH} dam breaks {SIZE}² (HostBatchRunner): "
               f"{BATCH_WARMUP} warm-up + {BATCH_FRAMES} timed frames"):
        mg_kernel.clear_workspaces()
        torch.cuda.empty_cache()
        held = reset_peak()
        # the runner holds the only reference to the initial states, so the
        # peak is the batch's own; instances 0 and 7 are rebuilt from their
        # seeds for the alone check
        runner = HostBatchRunner(cfg, [dam_break(cfg, seed=i, device=dev)
                                       for i in range(BATCH)])
        nbytes = lambda x: sum(  # noqa: E731
            getattr(x, f.name).nbytes for f in dataclasses.fields(x))
        state_bytes = nbytes(runner.states[0])
        scn_bytes = nbytes(runner.scns[0])
        runner.run(BATCH_WARMUP)
        runner.sync()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        runner.run(BATCH_FRAMES)
        runner.sync()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        plain = sum(_build.PLAIN_CALLS.values())
        n_frames = BATCH * BATCH_FRAMES
        summary = {
            "instances": BATCH,
            "ms_per_instance_frame": 1e3 * elapsed / n_frames,
            "cell_steps_per_s": Y * X * S * n_frames / elapsed,
            "div_inf": max(div_inf(cfg, st) for st in runner.states),
            "dropped_markers": [int(st.dropped_markers)
                                for st in runner.states],
            "launches": got,
            "mg_workspaces": len(mg_kernel._WORKSPACES),
        }
        record_peak(summary, held)
        rest = (summary["max_memory_allocated"] - held
                - BATCH * (state_bytes + scn_bytes)
                - summary["mg_workspace_bytes"])
        summary.update(state_bytes=state_bytes, scenario_bytes=scn_bytes,
                       unattributed_bytes=rest)
        log(f"   the batch's peak above what was held: {BATCH} states of "
            f"{state_bytes} bytes, {BATCH} scenarios of {scn_bytes}, the MG "
            f"workspace {summary['mg_workspace_bytes']}, the rest {rest} "
            "(a frame's temporaries)")
        summaries["batch"] = summary
        log(f"   batch: {summary['ms_per_instance_frame']:.3f} ms an "
            f"instance-frame, {summary['cell_steps_per_s']:.4g} cell-steps/s "
            f"aggregate ({Y}x{X} x {S} substeps x {BATCH_FRAMES} frames x "
            f"{BATCH} instances in {elapsed:.3f} s); div_inf "
            f"{summary['div_inf']:.4g}; dropped {summary['dropped_markers']}")
        log(f"   launches {got}; plain-version calls {plain}; "
            f"{summary['mg_workspaces']} MG workspace(s) cached")
        for k in ("K1", "K2", "K3"):
            check(got.get(k, 0) == BATCH * S * BATCH_FRAMES,
                  f"batch: {k} launched {got.get(k, 0)} times, not "
                  f"{BATCH} x {S} x {BATCH_FRAMES}")
            launches[k] = max(launches[k], got[k])
        check(plain == 0, "batch: a plain version ran")
        check(summary["mg_workspaces"] == 1, "batch: the instances did not "
              "share one MG workspace")
        check(summary["div_inf"] < 1.0, "batch: div_inf too large")
        for st in runner.states:
            for name in ("u", "v", "p", "markers"):
                check(bool(torch.isfinite(getattr(st, name)).all()),
                      f"batch: state.{name} not finite")

    with Phase(f"instances {BATCH_ALONE} alone, {BATCH_WARMUP} + "
               f"{BATCH_FRAMES} frames: bitwise the batch's"):
        for i in BATCH_ALONE:
            scn, st = dam_break(cfg, seed=i, device=dev)
            for _ in range(BATCH_WARMUP):
                st = sim.step_frame(cfg, scn, st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BATCH_FRAMES):
                st = sim.step_frame(cfg, scn, st)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            for f in dataclasses.fields(st):
                a, b = getattr(st, f.name), getattr(runner.states[i], f.name)
                if a.dtype == torch.uint32:
                    a, b = a.to(torch.int64), b.to(torch.int64)
                check(torch.equal(a, b), f"batch instance {i}: {f.name} "
                      "differs from the instance stepped alone")
            if i == BATCH_ALONE[0]:
                summaries["batch_one_instance"] = {
                    "ms_per_frame": 1e3 * elapsed / BATCH_FRAMES,
                    "cell_steps_per_s": Y * X * S * BATCH_FRAMES / elapsed}
                log(f"   instance {i} alone: "
                    f"{1e3 * elapsed / BATCH_FRAMES:.3f} ms/frame, "
                    f"{Y * X * S * BATCH_FRAMES / elapsed:.4g} cell-steps/s")
            log(f"   instance {i}: every field (u, v, p, the store, counts, "
                "drops, RNG) bitwise equal alone and in the batch")
        del runner

    with Phase(f"text-scenario batch {TEXT_BATCH} 40x100 (CLI config, "
               f"sources padded), step_frame_batched: card vs CPU, "
               f"{TEXT_BATCH_FRAMES} frames"):
        root = Path(__file__).resolve().parent
        texts = [(root / "scenarios" / f"{n}.txt").read_bytes()
                 for n in TEXT_BATCH]
        tcfg = cli.build_config(cli.parse_args(["scenarios/waterfall.txt"]))
        scn_g, st_g = build_batch(texts, tcfg, device=dev)
        scn_c, st_c = build_batch(texts, tcfg, device="cpu")
        torch.cuda.synchronize()
        reset_counts()
        for _ in range(TEXT_BATCH_FRAMES):
            st_g = step_frame_batched(tcfg, scn_g, st_g)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        check(sum(_build.PLAIN_CALLS.values()) == 0,
              "text batch: a plain version ran on the card")
        n = len(texts) * tcfg.max_substeps * TEXT_BATCH_FRAMES
        for k in ("K1", "S1", "K7", "K8"):
            check(got.get(k, 0) == n, f"text batch: {k} launched "
                  f"{got.get(k, 0)} times, not {n}")
        for k in ("K2", "K10", "K4"):
            check(got.get(k, 0) == 0, f"text batch: {k} launched")
        for _ in range(TEXT_BATCH_FRAMES):
            st_c = step_frame_batched(tcfg, scn_c, st_c)
        for name in ("marker_count", "alive", "alive_count",
                     "dropped_markers", "source_exhausted"):
            check(torch.equal(getattr(st_g, name).cpu(),
                              getattr(st_c, name)),
                  f"text batch: {name} differs between card and CPU")
        check(torch.equal(st_g.rng.cpu().to(torch.int64),
                          st_c.rng.to(torch.int64)),
              "text batch: the RNG differs between card and CPU")
        du = (st_g.u.cpu() - st_c.u).abs().max().item()
        dv = (st_g.v.cpu() - st_c.v).abs().max().item()
        summaries["text_batch"] = {"launches": got, "max_abs_du": du,
                                   "max_abs_dv": dv}
        log(f"   launches {got}; counts, alive, alive_count, drops, "
            f"exhausted and RNG bitwise; max |du| {du:.3g}, |dv| {dv:.3g} "
            "(atol 5e-3)")
        check(du <= 5e-3 and dv <= 5e-3, "text batch: velocities differ "
              "> 5e-3")


def run_diagnostics(summaries) -> None:
    """The CLI as a process with and without --sherlock, in turn, at the
    same frame count; in process, the NaN trap raises on a NaN
    in u, makes one torch sync a frame on and none off, and its frame
    rate beside the switch off; `dump_pressure_system` of a card state
    equals the CPU's text; `profiler_trace` records K1's kernel."""
    import tempfile

    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.utils import diagnostics

    argv = ["scenarios/waterfall.txt"]
    with Phase(f"--sherlock: python -m euler_tpu_torch {argv[0]} --frames "
               f"{SHERLOCK_CLI_FRAMES} [--sherlock], 2 x each in turn; the "
               "trap in process; "
               "dump_pressure_system; profiler_trace"):
        root = Path(__file__).resolve().parent
        fps, lines = {}, {}
        for flags in (["--sherlock"], [], ["--sherlock"], []):
            cmd = [sys.executable, "-m", "euler_tpu_torch", *argv,
                   "--frames", str(SHERLOCK_CLI_FRAMES), *flags]
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=600,
                                  env=dict(os.environ, PYTHONPATH=str(root)))
            last = (proc.stdout.strip().splitlines() or [""])[-1]
            label = "on" if flags else "off"
            log(f"   CLI {' '.join(flags) or '(no --sherlock)'}: rc "
                f"{proc.returncode}: {last}")
            check(proc.returncode == 0 and " frames/s, " in last,
                  f"the CLI {flags} failed (rc {proc.returncode}):\n"
                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            rate = float(last.split(" frames/s, ")[0].split()[-1])
            fps.setdefault(label, []).append(rate)
            lines.setdefault(label, last)
        summary = {"cli_line": lines["on"], "cli_frames_per_s_on": fps["on"],
                   "cli_frames_per_s_off": fps["off"]}

        cfg, scn, st = cli_state(argv)
        for _ in range(4):
            st = sim.step_frame(cfg, scn, st)
        frame = lambda: sim.step_frame(cfg, scn, st)  # noqa: E731
        off = torch_syncs(frame)
        diagnostics.enable_fpmath_asserts()
        try:
            on = torch_syncs(frame)
            bad = st.replace(u=st.u.clone())
            ys, xs = torch.nonzero(st.fluid, as_tuple=True)
            bad.u[ys[len(ys) // 2], xs[len(xs) // 2]] = float("nan")
            try:
                sim.step_frame(cfg, scn, bad)
                raised = ""
            except FloatingPointError as e:
                raised = str(e)
            ms = {}
            for label, enabled in (("on", True), ("off", False),
                                   ("on", True), ("off", False)):
                diagnostics._fpmath_asserts = enabled
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = st
                for _ in range(SHERLOCK_FRAMES):
                    s = sim.step_frame(cfg, scn, s)
                torch.cuda.synchronize()
                t = 1e3 * (time.perf_counter() - t0) / SHERLOCK_FRAMES
                ms[label] = min(ms.get(label, t), t)
        finally:
            diagnostics._fpmath_asserts = False
        log(f"   torch syncs a frame: {off} with the trap off, {on} on; a "
            f"NaN in u: {raised!r}")
        log(f"   waterfall 40x100: {ms['off']:.3f} ms/frame with the trap "
            f"off, {ms['on']:.3f} on (best of 2 x {SHERLOCK_FRAMES} frames)")
        check(off == 0, "the frame read the device with the trap off")
        check(on == 1, f"the trap made {on} torch syncs a frame, not 1")
        check("u" in raised.split(": ")[-1], "a NaN in u did not raise "
              "FloatingPointError naming u")
        summary.update(torch_syncs_off=off, torch_syncs_on=on,
                       ms_per_frame_off=ms["off"], ms_per_frame_on=ms["on"])

        dt = 0.0123
        text = diagnostics.dump_pressure_system(cfg, scn, st, dt)
        text_cpu = diagnostics.dump_pressure_system(cfg, *to_cpu(scn, st),
                                                    dt)
        check(text == text_cpu, "dump_pressure_system: the card's text "
              "differs from the CPU's")
        log(f"   dump_pressure_system: {len(text)} characters, card equal "
            "to CPU")

        # a profiler session on the card now and then loses kernel records
        # (PERF.md §7): a trace without K1 is taken again, up to 3 times
        for tries in range(1, 4):
            with tempfile.TemporaryDirectory() as tmp:
                with diagnostics.profiler_trace(logdir=tmp):
                    sim.step_frame(cfg, scn, st)
                trace = (Path(tmp) / "trace.json").read_text()
            if "march_rebin_tiles" in trace:
                break
        check("march_rebin_tiles" in trace, "profiler_trace: K1's kernel "
              f"(march_rebin_tiles) is not in any of {tries} traces")
        log(f"   profiler_trace: {len(trace)} bytes, K1's "
            f"march_rebin_tiles in it (trace {tries})")
        summaries["sherlock"] = summary


SHARDS = (4, 2)      # the row shards K1 runs on at the main path's size
SHARD_CHECK = 256    # where each shard's K1 is held against its plain version
SHARD_DEVELOP = 3    # frames of the dam break before the shard checks
SHARD_FRAMES = 2     # frames of the one-rank NCCL runs


def k1_blocks(cfg, planes, n):
    """The n row shards of `planes` (u, v, fluid, solid, slots, count,
    dead) with their 8-row halo (what `exchange_rows` gives each rank), the
    shard's config and its K1 keyword arguments."""
    from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo

    Yl = cfg.ny // n
    cfg_l = dataclasses.replace(cfg, ny=Yl + 2 * H)
    return [(cfg_l, [block_with_halo(a, n, r) for a in planes],
             dict(clamp_ny=cfg.ny, row_offset=r * Yl - H)) for r in range(n)]


def k1_shard_call(blocks, dt, kernel):
    """`kernel` (K1's wrapper or its plain version) on every shard."""
    return [kernel(c, *b[:5], dt, b[5], dead=b[6], **kw)
            for c, b, kw in blocks]


def developed_planes(size: int, dev):
    """(cfg, scn, state, dt, K1's planes) of the dam break at size²,
    SHARD_DEVELOP frames on."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.forces import max_speed_sq

    cfg = main_config(size)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    scn, st = dam_break(cfg, device=dev)
    for _ in range(SHARD_DEVELOP):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device=dev))
    planes = (st.u, st.v, st.fluid, scn.solid,
              st.markers.reshape(2 * K, Y, X), st.marker_count,
              scn.sink | scn.solid)
    return cfg, scn, st, dt, planes


def equal_states(a, b) -> bool:
    import torch

    return all(torch.equal(x.to(torch.int64), y.to(torch.int64))
               if x.dtype == torch.uint32 else torch.equal(x, y)
               for x, y in ((getattr(a, f.name), getattr(b, f.name))
                            for f in dataclasses.fields(a)))


def run_shard(results, summaries, launches, dev) -> None:
    """K1 per row shard on the card (each shard's launch on its padded
    plane with clamp_ny / row_offset: interiors bitwise the unsharded K1
    at 1024², each shard bitwise its plain version at 256² and 1024²,
    timed), then on a one-rank NCCL group: the row-sharded marker pass in
    `step_frame`, `make_sharded_step` on the batch of 8 and
    `make_dp_substep_mg`, each bitwise its unsharded counterpart."""
    import tempfile

    import torch
    import torch.distributed as dist

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import substep_kernel as k2
    from euler_tpu_torch.parallel import cuda_shard, mesh, spatial
    from euler_tpu_torch.parallel.batch import stack, step_frame_batched

    summary = {}
    with Phase(f"K1 on {' and '.join(map(str, SHARDS))} row shards: "
               f"bitwise the unsharded K1 at {SIZE}², each shard bitwise "
               f"its plain version at {SHARD_CHECK}² and {SIZE}²; timed"):
        for size in (SHARD_CHECK, SIZE):
            cfg, scn, st, dt, planes = developed_planes(size, dev)
            whole = k1.march_rebin(cfg, *planes[:5], dt, planes[5],
                                   dead=planes[6])
            for n in SHARDS:
                Yl = size // n
                blocks = k1_blocks(cfg, planes, n)
                got = k1_shard_call(blocks, dt, k1.march_rebin)
                plain = k1_shard_call(blocks, dt, k1.march_rebin_plain)
                for r, (g, p) in enumerate(zip(got, plain)):
                    for a, b, w, name in zip(g, p, whole,
                                             ("slots", "count", "drop")):
                        check(torch.equal(a, b), f"{size}², shard {r} of "
                              f"{n}: K1's {name} differs from plain")
                        check(torch.equal(a[..., 8:8 + Yl, :],
                                          w[..., r * Yl:(r + 1) * Yl, :]),
                              f"{size}², shard {r} of {n}: K1's {name} "
                              "differs from the unsharded K1")
                log(f"   {size}², {n} shards of [{2 * SLOTS}, {Yl + 16}, "
                    f"{size}]: every shard bitwise its plain version; "
                    "interiors bitwise the unsharded K1 (slots, counts, "
                    "drops)")
        # the timing, on the 1024² state
        X = cfg.nx
        n_live = int(planes[5].sum())
        whole_call = lambda: k1.march_rebin(  # noqa: E731
            cfg, *planes[:5], dt, planes[5], dead=planes[6])
        whole_dev = min(device_ms(whole_call, REPS) for _ in range(2))
        whole_bytes = BOUNDS["K1"](SIZE * X, 0, n_live)[0]
        summary["unsharded"] = {"device_ms": whole_dev,
                                "bound_ms": 1e3 * whole_bytes
                                / HBM_BYTES_PER_S, "live": n_live}
        log(f"   unsharded K1 {SIZE}²: device {whole_dev:.4f} ms, bound "
            f"{summary['unsharded']['bound_ms']:.4f} ms by bytes "
            f"({whole_bytes / 1e6:.1f} MB, {n_live} live markers)")
        for n in SHARDS:
            blocks = k1_blocks(cfg, planes, n)
            call = lambda: k1_shard_call(  # noqa: E731
                blocks, dt, k1.march_rebin)
            plain = lambda: k1_shard_call(  # noqa: E731
                blocks, dt, k1.march_rebin_plain)
            t_p1, t_k1 = cuda_ms(plain, 2), cuda_ms(call, REPS)
            t_k2, t_p2 = cuda_ms(call, REPS), cuda_ms(plain, 2)
            dev_ms = min(device_ms(call, REPS) for _ in range(2))
            nbytes = flops = 0
            for c, b, kw in blocks:
                live = int(b[5].sum())
                nb, fl = BOUNDS["K1"](c.ny * X, 0, live)
                nbytes, flops = nbytes + nb, flops + fl
                log(f"   shard row_offset {kw['row_offset']}: [{2 * SLOTS}, "
                    f"{c.ny}, {X}], {live} live markers, byte bound "
                    f"{1e3 * nb / HBM_BYTES_PER_S:.4f} ms ({nb / 1e6:.1f} "
                    "MB)")
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / F32_FLOP_PER_S
            row = {"ms": min(t_k1, t_k2), "plain_ms": min(t_p1, t_p2),
                   "device_ms": dev_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations", "library_ms": None}
            summary[f"shards_{n}"] = row
            log(f"   {n} shards' K1 launches {SIZE}²: device {dev_ms:.4f} ms "
                f"summed (unsharded {whole_dev:.4f}); events "
                f"{t_k1:.4f} / {t_k2:.4f} ms; plain {t_p1:.3f} / "
                f"{t_p2:.3f} ms; bound {row['bound_ms']:.4f} ms by "
                f"{row['bound_by']} ({nbytes / 1e6:.1f} MB, the halos "
                "twice)")
            if n == 4:
                results["K1s"] = {"max_abs_err": 0.0, **row}
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"one-rank NCCL group: the row-sharded marker pass in "
               f"step_frame, make_sharded_step on the batch of {BATCH}, "
               f"make_dp_substep_mg; {SIZE}², {SHARD_FRAMES} frames"), \
            tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            ymesh = spatial.spatial_mesh(1, x=1)
            bscn, bst = spatial.shard_spatial(cfg, ymesh, scn, st)
            marker_pass = cuda_shard.make_sharded_marker_pass(cfg, ymesh)
            torch.cuda.synchronize()
            reset_counts()
            hooked = bst
            for _ in range(SHARD_FRAMES):
                hooked = sim.step_frame(cfg, bscn, hooked,
                                        marker_pass=marker_pass)
            torch.cuda.synchronize()
            got = dict(_build.LAUNCHES)
            plain = sum(_build.PLAIN_CALLS.values())
            ref = st
            for _ in range(SHARD_FRAMES):
                ref = sim.step_frame(cfg, scn, ref)
            log(f"   marker pass on a y of 1 rank: launches {got}, plain "
                f"calls {plain}; alive_count {int(hooked.alive_count)}, "
                f"dropped {int(hooked.dropped_markers)}")
            check(equal_states(hooked, ref), "the row-sharded marker pass "
                  "in step_frame differs from the unsharded frames")
            check(equal_states(spatial.gather_spatial(cfg, ymesh, hooked),
                               hooked), "gather_spatial on one rank")
            check(got.get("K1") == SHARD_FRAMES * cfg.max_substeps
                  and got.get("K2", 0) > 0 and got.get("K3", 0) > 0
                  and plain == 0, f"sharded marker pass frames: launches "
                  f"{got}, plain calls {plain}")
            launches["K1s"] = got["K1"]
            summary["marker_pass_launches"] = got

            dmesh = mesh.make_mesh(1, data=1)
            pairs = [dam_break(cfg, seed=i, device=dev) for i in range(BATCH)]
            scn8, st8 = (stack([p[i] for p in pairs]) for i in (0, 1))
            del pairs
            sscn, sst = mesh.shard_batch(dmesh, scn8, st8)
            step = mesh.make_sharded_step(cfg, dmesh)
            torch.cuda.synchronize()
            reset_counts()
            for _ in range(SHARD_FRAMES):
                sst = step(sscn, sst)
            torch.cuda.synchronize()
            got = dict(_build.LAUNCHES)
            plain = sum(_build.PLAIN_CALLS.values())
            for _ in range(SHARD_FRAMES):
                st8 = step_frame_batched(cfg, scn8, st8)
            per = BATCH * SHARD_FRAMES * cfg.max_substeps
            log(f"   data axis of 1 rank, batch of {BATCH}: launches {got}, "
                f"plain calls {plain}")
            check(equal_states(sst, st8), "make_sharded_step differs from "
                  "step_frame_batched")
            check(equal_states(mesh.gather_batch(dmesh, sst), sst),
                  "gather_batch on one rank")
            check(got.get("K1") == per and got.get("K2") == per
                  and got.get("K3", 0) > 0 and plain == 0,
                  f"make_sharded_step: launches {got}, plain calls {plain}")
            summary["data_axis_launches"] = got
            del scn8, st8, sscn, sst

            one = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid, st.p)
            reset_counts()
            out = cuda_shard.make_dp_substep_mg(cfg, dmesh)(
                dt, dt, *(a[None] for a in one))
            got = dict(_build.LAUNCHES)
            want = k2.project_substep_mg(cfg, dt, dt, *one)
            check(all(torch.equal(a[0], b) for a, b in zip(out, want)),
                  "make_dp_substep_mg differs from project_substep_mg")
            check(got.get("K2") == 1 and not _build.PLAIN_CALLS,
                  f"make_dp_substep_mg: launches {got}")
            log(f"   make_dp_substep_mg {SIZE}²: bitwise project_substep_mg "
                f"({int(out[2][0])} iterations), launches {got}")
        finally:
            dist.destroy_process_group()
    summaries["shard"] = summary


# the frame on row blocks (M12 part c): in-process blocks of one card
ROW_BLOCKS = (1, 2, 4)   # blocks of the P4 solves at SIZE²
ROW_N = 4                # blocks of the frames
ROW_WARMUP, ROW_TIMED = 1, 2  # frames of the 1024² waterfall on blocks
ROW_SMALL_FRAMES = 4     # frames of the 40 x 100 waterfall on blocks
# what the blocks' frames are held to against 1 block of the same code:
# the reductions of P4 fold the blocks in another order, so a velocity
# differs in its last bits (max |dv| 7.65e-5 on the dam break, 0 on the
# waterfall: PERF.md §6), and a marker near a cell's edge could then
# land in the other cell (0 cells on both).  So: at most this many cells'
# counts apart, and every velocity within ROW_FRAME_ATOL (~13x the
# reading)
ROW_FRAME_COUNT_CELLS = 4
ROW_FRAME_ATOL = 1e-3
# the 40 x 100 waterfall, card (kernels) vs CPU (plain versions) on the
# same blocks: counts, alive, RNG bitwise, velocities within
ROW_SMALL_ATOL = 1e-4
WATERFALL_JACOBI_1024 = ["scenarios/waterfall.txt", "--size", "1024x1024",
                         "--no-converged"]


def block_rank(cfg, b, a_diag, fl, n, plain=False, x=1):
    """A block's solve of (b, a_diag, fl) cut into n row blocks (and x
    column blocks): P4, or with `plain` its plain version
    `halo.pcg_sharded` on the same card tensors; for
    `comm.LocalGroup.run`."""
    from euler_tpu_torch.parallel import halo

    Yl, Xl = cfg.ny // n, cfg.nx // x
    axes = ("y", "x") if x > 1 else ("y",)

    def rank(comm):
        ry, rx = comm.rank("y"), comm.rank("x")
        cut = (slice(ry * Yl, (ry + 1) * Yl), slice(rx * Xl, (rx + 1) * Xl))
        args = [t[cut].contiguous() for t in (b, a_diag, fl)]
        if plain:
            return halo.pcg_sharded(cfg, comm, axes, *args)
        return halo.make_sharded_pressure_solver(cfg, comm, axes,
                                                 stats=True)(*args)

    return rank


def together(parts, x):
    """The blocks' [Yl, Xl] planes, in rank order, put back together."""
    import torch

    return torch.cat([torch.cat(parts[r:r + x], -1)
                      for r in range(0, len(parts), x)], -2)


def block_solve(cfg, b, a_diag, fl, n, dev, plain=False, x=1):
    """`block_rank`'s solve on n x x in-process blocks, once to warm up
    and once timed with CUDA events around the blocks' calls.  Returns
    (p put together, iterations, residual, ms)."""
    import torch

    from euler_tpu_torch.parallel.comm import LocalGroup

    rank = block_rank(cfg, b, a_diag, fl, n, plain, x)
    with LocalGroup(n, x, device=dev) as g:
        g.run(rank)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = g.run(rank)
        end.record()
        torch.cuda.synchronize()
    check(len({int(o[1]) for o in out}) == 1
          and len({float(o[2]) for o in out}) == 1,
          f"P4 on {n} x {x} blocks: the blocks' iterations or residuals "
          "differ")
    return (together([o[0] for o in out], x), int(out[0][1]),
            float(out[0][2]), start.elapsed_time(end))


def block_spans(cfg, b, a_diag, fl, n, dev, x=1):
    """`kernel_spans_ms` of one P4 solve on n x x in-process blocks, after
    one to warm up."""
    import torch

    from euler_tpu_torch.parallel.comm import LocalGroup

    rank = block_rank(cfg, b, a_diag, fl, n, x=x)
    with LocalGroup(n, x, device=dev) as g:
        g.run(rank)
        torch.cuda.synchronize()
        return kernel_spans_ms(lambda: g.run(rank))


def block_frames(cfg, scn, st, n, dev, warm: int, timed: int, x=1,
                 rewind=False):
    """`spatial.make_block_step` on n x x in-process blocks of (scn, st)
    on `dev`: `warm` frames, then `timed` frames with the launch counts
    set to 0 just before and read just after; with `rewind` the warm
    frames run on a copy of the blocks' states and the timed ones from
    the start again.  Returns (the state put together, ms a timed frame,
    launches, plain calls)."""
    import torch

    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.parallel import spatial
    from euler_tpu_torch.parallel.comm import LocalGroup

    cuda = torch.device(dev).type == "cuda"
    with LocalGroup(n, x, device=dev) as g:
        made = g.run(lambda comm: (spatial.make_block_step(cfg, comm),
                                   *spatial.shard_blocks(cfg, comm, scn,
                                                         st)))
        states = [m[2] for m in made]

        def advance(frames):
            def rank(comm):
                step, bscn, b = made[comm.r][0], made[comm.r][1], \
                    states[comm.r]
                for _ in range(frames):
                    b = step(bscn, b)
                states[comm.r] = b
            g.run(rank)

        start = list(states)
        if rewind:
            states[:] = [b.replace(**{f.name: getattr(b, f.name).clone()
                                      for f in dataclasses.fields(b)})
                         for b in start]
        advance(warm)
        if rewind:
            states[:] = start
        if cuda:
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        advance(timed)
        if cuda:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / max(timed, 1)
        launches = dict(_build.LAUNCHES)
        plain = sum(_build.PLAIN_CALLS.values())
        whole = g.run(lambda comm: spatial.gather_blocks(
            cfg, comm, states[comm.r]))[0]
    return whole, ms, launches, plain


def frame_diff(a, b) -> dict:
    """How far two states of one grid are apart: the cells whose count
    differs, the largest velocity difference, the alive counts."""
    import torch

    du = torch.maximum((a.u - b.u).abs(), (a.v - b.v).abs())
    return {"count_cells": int((a.marker_count != b.marker_count).sum()),
            "cells": a.u.numel(), "max_dv": float(du.max()),
            "alive": (int(a.alive_count), int(b.alive_count))}


def frames_agree(d: dict) -> bool:
    """Whether the blocks' frames are within what ROW_FRAME_COUNT_CELLS
    and ROW_FRAME_ATOL allow of 1 block's."""
    return (d["count_cells"] <= ROW_FRAME_COUNT_CELLS
            and d["max_dv"] <= ROW_FRAME_ATOL)


def k7_row_blocks(cfg, grid, dt, n: int, label: str) -> dict:
    """K7 on n row blocks of `grid` (u, v, fluid, prev_fluid, solid), each
    padded with H rows (`block_with_halo`, row offsets r Yl - H): every
    block's launch bitwise its plain version and its kept rows bitwise
    the unsharded launch's; timed in turns, and the device ms summed
    beside one unsharded launch's.  Returns the kernels-line row."""
    import torch

    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo

    Y, X = cfg.ny, cfg.nx
    Yl = Y // n
    cfg_h = dataclasses.replace(cfg, ny=Yl + 2 * H)
    blocks = [[block_with_halo(a, n, r) for a in grid] for r in range(n)]
    kw = [dict(clamp_ny=Y, row_offset=r * Yl - H) for r in range(n)]
    whole = k7.grid_stage(cfg, *grid, dt)

    def call():
        return [k7.grid_stage(cfg_h, *blocks[r], dt, **kw[r])
                for r in range(n)]

    def plain():
        return [k7.grid_stage_plain(cfg_h, dt, *blocks[r], **kw[r])
                for r in range(n)]

    for r, (got, want) in enumerate(zip(call(), plain())):
        for a, w_, u_, name in zip(got, want, whole, ("ut", "vt")):
            check(torch.equal(a, w_), f"K7 block {r}: {name} differs from "
                  "its plain version")
            check(torch.equal(a[H:H + Yl], u_[r * Yl:(r + 1) * Yl]),
                  f"K7 block {r}: {name} differs from the unsharded K7")
    t_k, t_p, events = timed_pair(call, plain)
    dev_ms = min(device_ms(call, REPS) for _ in range(2))
    one_ms = min(device_ms(lambda: k7.grid_stage(cfg, *grid, dt), REPS)
                 for _ in range(2))
    row = {"ms": t_k, "plain_ms": t_p, "device_ms": dev_ms,
           "device_ms_one_launch": one_ms, "max_abs_err": 0.0,
           "library_ms": None,
           **bound_fields(*k7_blocks_bound(Yl, X, n, False))}
    log(f"   K7 on {n} blocks of [{cfg_h.ny}, {X}] at {label} (row offsets "
        f"{[k['row_offset'] for k in kw]}): bitwise; device {dev_ms:.4f} ms "
        f"summed against {one_ms:.4f} for one launch; {events}; bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']}")
    return row


def s1_row_blocks(cfg, scn, st, n: int, dev, label: str) -> dict:
    """S1 on n row blocks of (scn, st), each with its row offset and the
    [S] counts all-reduced as the frame gives them: every block's launch
    bitwise its plain version and the unsharded S1's rows; timed in
    turns (each call emits into the same blocks, so later calls find
    fuller cells, as `time_s1`).  Returns the kernels-line row."""
    import torch

    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.markers_slots import source_pass_slots

    Yl = cfg.ny // n
    ys = scn.source_yx[:, 0].long()
    xs = scn.source_yx[:, 1].long()
    counts = torch.where(scn.source_valid, st.marker_count[ys, xs],
                         0).to(torch.int32)
    act = torch.ones((), dtype=torch.bool, device=dev)
    rows = [slice(r * Yl, (r + 1) * Yl) for r in range(n)]
    bscn = [dataclasses.replace(
        scn, **{k: getattr(scn, k)[rw].contiguous()
                for k in ("solid", "source", "sink")}) for rw in rows]

    def blocks():
        return [st.replace(**{
            k: getattr(st, k)[..., rw, :].clone(
                memory_format=torch.contiguous_format)
            for k in ("markers", "alive", "marker_count", "r", "g", "b")},
            **{k: getattr(st, k).clone()
               for k in ("rng", "alive_count", "source_exhausted")})
            for rw in rows]

    def emit(fn, blks):
        for r, blk in enumerate(blks):
            fn(cfg, bscn[r], blk, act, r * Yl, counts)
        return blks

    whole = s1_copy(st)
    s1.emit_sources(cfg, scn, whole, act)
    got = emit(s1.emit_sources, blocks())
    want = emit(source_pass_slots, blocks())
    for r, (g_, w_) in enumerate(zip(got, want)):
        for k in S1_FIELDS:
            a_, full = getattr(g_, k), getattr(whole, k)
            if full.dim() >= 2:
                full = full[..., rows[r], :]
            for other, what in ((getattr(w_, k), "its plain version"),
                                (full, "the unsharded S1")):
                check(torch.equal(a_.to(torch.int64), other.to(torch.int64))
                      if k == "rng" else torch.equal(a_, other),
                      f"S1 block {r}: {k} differs from {what}")
    emitted = int(whole.alive_count) - int(st.alive_count)
    holding = sorted({int(y) // Yl for y in ys.tolist()})
    k_blks, p_blks = blocks(), blocks()
    t_k, t_p, events = timed_pair(lambda: emit(s1.emit_sources, k_blks),
                                  lambda: emit(source_pass_slots, p_blks),
                                  1)
    row = {"ms": t_k, "plain_ms": t_p, "max_abs_err": 0.0,
           "library_ms": None,
           **bound_fields(*s1_blocks_bound(scn.num_sources, emitted, n))}
    log(f"   S1 on {n} row blocks of {label} ({scn.num_sources} sources in "
        f"blocks {holding}, {emitted} emitted): bitwise its plain version "
        f"and the unsharded S1; {events} the {n} launches; bound "
        f"{row['bound_ms']:.3g} ms")
    return row


def run_row_blocks(results, summaries, launches, dev) -> dict:
    """The frame on row blocks on the card (M12 part c: P4, K7 and S1 per
    row block, K1 per row shard), every block of a grid played by one
    thread of an in-process `comm.LocalGroup`: P4's solves of the 1024²
    substep system, the waterfall at 1024² and at 40 x 100 on 4 blocks.
    Returns what the column blocks' phases and the block profiles reuse:
    the states, the substep system, the 1-block solves and frames."""
    import tempfile

    import torch
    import torch.distributed as dist

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13
    from euler_tpu_torch.ops.project import apply_a
    from euler_tpu_torch.parallel import halo, spatial

    summary = {}
    cfg, scn, st, dt, planes = developed_planes(SIZE, dev)
    _, ut, vt, b, a_diag = substep_system(cfg, scn, st)
    fl = st.fluid
    n_cells = SIZE * SIZE
    configs = {"jacobi": speed_config(SIZE), "mg": main_config(SIZE)}
    shared = {"cfg": cfg, "scn": scn, "st": st, "dt": dt, "planes": planes,
              "b": b, "a_diag": a_diag, "fl": fl, "configs": configs,
              "unsharded": {}, "one_block": {}, "frames_1": {}}
    with Phase(f"P4 on 1, 2 and 4 in-process row blocks of the {SIZE}² "
               "substep system (Jacobi at the speed mode's budget, block "
               "MG to tol_rel 1e-4): against the unsharded P1 / P3 and "
               "the plain P4; a one-rank NCCL group bitwise 1 block"), \
            tempfile.TemporaryDirectory() as tmp:
        for label, c in configs.items():
            ref = p13.solve_pressure_general(c, b, a_diag, fl)
            t_ref = cuda_ms(lambda: p13.solve_pressure_general(
                c, b, a_diag, fl), REPS)
            scale = float(ref[0].abs().max())
            shared["unsharded"][label] = ref
            row = {"unsharded_ms": t_ref, "unsharded_iters": int(ref[1])}
            log(f"   {label}: unsharded {'P3' if label == 'mg' else 'P1'} "
                f"{t_ref:.3f} ms, {int(ref[1])} iterations, |p| {scale:.4g}")
            for n in ROW_BLOCKS:
                reset_counts()
                p, it, res, ms = block_solve(c, b, a_diag, fl, n, dev)
                check(_build.LAUNCHES["P4"] == 2 * n
                      and not _build.PLAIN_CALLS,
                      f"P4 {label} on {n} blocks: launches "
                      f"{dict(_build.LAUNCHES)}")
                err = float((p - ref[0]).abs().max()) / scale
                true_res = float((b - apply_a(a_diag, fl, p)).abs().max())
                if label == "jacobi":
                    # the cap: the same 100 iterations as P1, the order of
                    # the reductions apart
                    check(it == int(ref[1]) and err <= 1e-4,
                          f"P4 jacobi on {n} blocks: {it} iterations, p "
                          f"{err:.3g} of scale from P1")
                else:
                    # converged, as P3: its stop test met, the pressure
                    # within 1e-3 of P3's scale (f32, tol_rel 1e-4)
                    tol = max(c.solver.tol,
                              c.solver.tol_rel * float(b.abs().max()))
                    check(res <= tol and err <= 1e-3,
                          f"P4 mg on {n} blocks: resid {res:.3g} (tol "
                          f"{tol:.3g}), p {err:.3g} of scale from P3")
                row[f"blocks_{n}"] = {"ms": ms, "iters": it, "resid": res,
                                      "true_resid": true_res,
                                      "err_vs_unsharded": err}
                if n == 1:
                    shared["one_block"][label] = (p, it, res)
                log(f"   {label}, {n} blocks: {ms:.3f} ms a solve (CUDA "
                    f"events around the blocks' calls), {it} iterations, "
                    f"resid {res:.4g} (|b - A p| {true_res:.4g}), p within "
                    f"{err:.3g} of scale of the unsharded solve")
                if n == ROW_N:
                    q, it_q, res_q, ms_q = block_solve(c, b, a_diag, fl, n,
                                                       dev, plain=True)
                    kerr = float((p - q).abs().max())
                    check(abs(it - it_q) <= (0 if label == "jacobi" else 1)
                          and kerr <= (1e-4 if label == "jacobi" else 1e-3)
                          * scale,
                          f"P4 {label} on {n} blocks vs plain: {it} vs "
                          f"{it_q} iterations, p {kerr:.3g} apart")
                    row["plain"] = {"ms": ms_q, "iters": it_q,
                                    "max_abs_err": kerr}
                    log(f"   {label}, {n} blocks, plain P4: {ms_q:.3f} ms, "
                        f"{it_q} iterations; kernels vs plain p "
                        f"{kerr:.3g} apart")
            # one rank of NCCL: bitwise the 1-block in-process solve
            one = block_solve(c, b, a_diag, fl, 1, dev)
            dist.init_process_group(
                "nccl", init_method=f"file://{tmp}/store_{label}",
                world_size=1, rank=0)
            try:
                ymesh = spatial.spatial_mesh(1, x=1)
                solve = halo.make_sharded_pressure_solver(c, ymesh,
                                                          stats=True)
                got = solve(b, a_diag, fl)
                torch.cuda.synchronize()
                check(torch.equal(got[0], one[0]) and int(got[1]) == one[1]
                      and float(got[2]) == one[2],
                      f"P4 {label}: the one-rank NCCL solve differs from "
                      "1 in-process block")
            finally:
                dist.destroy_process_group()
            log(f"   {label}: one-rank NCCL solve bitwise the 1-block "
                f"in-process solve ({one[1]} iterations)")
            summary[f"p4_{label}"] = row
        jac, mg = summary["p4_jacobi"], summary["p4_mg"]
        log(f"   block MG iterations {[mg[f'blocks_{n}']['iters'] for n in ROW_BLOCKS]} "
            f"vs Jacobi's {[jac[f'blocks_{n}']['iters'] for n in ROW_BLOCKS]} "
            f"(1, 2, 4 blocks)")
        r4 = jac[f"blocks_{ROW_N}"]
        nbytes, flops = BOUNDS["P4"](n_cells, r4["iters"], 0)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / F32_FLOP_PER_S
        sweep = 1e3 * P4_SWEEP_BYTES * n_cells * r4["iters"] / HBM_BYTES_PER_S
        results["P4"] = {"ms": r4["ms"], "plain_ms": jac["plain"]["ms"],
                         "max_abs_err": jac["plain"]["max_abs_err"],
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations", "library_ms": None}
        summary["p4_sweep_bound_ms"] = sweep
        log(f"   P4 (Jacobi, {ROW_N} blocks): bound "
            f"{results['P4']['bound_ms']:.4f} ms by "
            f"{results['P4']['bound_by']}; its sweeps' bound ("
            f"{P4_SWEEP_BYTES} bytes a cell an iteration) {sweep:.4f} ms")
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"K7 and S1 per row block at {SIZE}²: each block's launch "
               "bitwise its plain version, the interiors bitwise the "
               "unsharded kernel; timed"):
        grid = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
        results["K7s"] = k7_row_blocks(cfg, grid, dt, ROW_N, f"{SIZE}²")
        wcfg, wscn, wst = cli_state(WATERFALL_JACOBI_1024)
        for _ in range(2):
            wst = sim.step_frame(wcfg, wscn, wst)
        results["S1s"] = s1_row_blocks(wcfg, wscn, wst, ROW_N, dev,
                                       f"the {SIZE}² waterfall")

    with Phase(f"the {SIZE}² waterfall (Jacobi budget) and dam break "
               f"(speed mode) on {ROW_N} row blocks: {ROW_WARMUP} warm-up "
               f"+ {ROW_TIMED} timed frames, K1, S1, K7, P4 and no plain "
               "version; against 1 block"):
        got, ms, got_l, plain = block_frames(wcfg, wscn, wst, ROW_N, dev,
                                             ROW_WARMUP, ROW_TIMED)
        log(f"   {ROW_N} blocks: {ms:.1f} ms a frame; launches {got_l}, "
            f"plain calls {plain}")
        check(all(got_l.get(k, 0) > 0 for k in ("K1", "S1", "K7", "P4"))
              and plain == 0, f"row blocks: launches {got_l}, plain "
              f"calls {plain}")
        per = ROW_N * wcfg.max_substeps * ROW_TIMED
        check(all(got_l.get(k) == per for k in ("K1", "S1", "K7", "P4")),
              f"row blocks: not one launch a block a substep: {got_l}")
        for k, name in (("K7s", "K7"), ("S1s", "S1"), ("P4", "P4")):
            launches[k] = got_l.get(name, 0)
        one, ms1, one_l, plain1 = block_frames(wcfg, wscn, wst, 1, dev,
                                               ROW_WARMUP, ROW_TIMED)
        shared["frames_1"]["waterfall"] = (wcfg, wscn, wst, one, ms1)
        d = frame_diff(got, one)
        log(f"   1 block: {ms1:.1f} ms a frame; {ROW_N} blocks vs 1: "
            f"{d['count_cells']} of {d['cells']} cells' counts differ "
            f"(<= {ROW_FRAME_COUNT_CELLS}), max |dv| {d['max_dv']:.3g} "
            f"(<= {ROW_FRAME_ATOL}); alive {d['alive']}")
        for name in ("u", "v", "p", "markers"):
            check(bool(torch.isfinite(getattr(got, name)).all()),
                  f"row blocks: {name} not finite")
        check(frames_agree(d), f"{ROW_N} blocks vs 1: {d}")
        summary["frame_1024"] = {"blocks": ROW_N, "ms_per_frame": ms,
                                 "ms_per_frame_1_block": ms1,
                                 "launches": got_l, "vs_1_block": d,
                                 "div_inf": div_inf(wcfg, got,
                                                    exclude=wscn.source)}
        log(f"   div_inf off the source cells "
            f"{summary['frame_1024']['div_inf']:.4g}")
        # the waterfall's fluid stays in the top block for these frames;
        # the dam break fills every block from its first frame
        dcfg = speed_config(SIZE)
        dscn, dst = dam_break(dcfg, device=dev)
        got, ms, got_l, plain = block_frames(dcfg, dscn, dst, ROW_N, dev,
                                             ROW_WARMUP, ROW_TIMED)
        one, ms1, _, _ = block_frames(dcfg, dscn, dst, 1, dev, ROW_WARMUP,
                                      ROW_TIMED)
        shared["frames_1"]["dam_break"] = (dcfg, dscn, dst, one, ms1)
        d = frame_diff(got, one)
        log(f"   dam break {SIZE}² (speed mode's solver): {ROW_N} blocks "
            f"{ms:.1f} ms a frame, 1 block {ms1:.1f}; launches {got_l}, "
            f"plain calls {plain}; {d['count_cells']} cells' counts "
            f"differ, max |dv| {d['max_dv']:.3g}; alive {d['alive']}")
        check(plain == 0 and got_l.get("K1") == per
              and got_l.get("P4") == per and got_l.get("K7") == per,
              f"dam break on row blocks: launches {got_l}")
        check(frames_agree(d), f"dam break, {ROW_N} blocks vs 1: {d}")
        summary["dam_break_1024"] = {"ms_per_frame": ms,
                                     "ms_per_frame_1_block": ms1,
                                     "vs_1_block": d,
                                     "div_inf": div_inf(dcfg, got)}
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"the 40 x 100 waterfall on {ROW_N} row blocks of 10 rows, "
               f"{ROW_SMALL_FRAMES} frames: card (kernels) vs CPU (plain "
               "versions) on the same blocks"):
        scfg_, sscn, sst = cli_state(["scenarios/waterfall.txt"])
        cscn, cst = to_cpu(sscn, sst)
        got, _, got_l, plain = block_frames(scfg_, sscn, sst, ROW_N, dev, 0,
                                            ROW_SMALL_FRAMES)
        want, _, _, _ = block_frames(scfg_, cscn, cst, ROW_N, "cpu", 0,
                                     ROW_SMALL_FRAMES)
        check(plain == 0 and all(got_l.get(k, 0) > 0
                                 for k in ("K1", "S1", "K7", "P4")),
              f"40 x 100 on blocks: launches {got_l}, plain calls {plain}")
        for name in ("marker_count", "alive", "alive_count",
                     "dropped_markers", "rng"):
            a_, b_ = getattr(got, name).cpu(), getattr(want, name)
            check(torch.equal(a_.to(torch.int64), b_.to(torch.int64)),
                  f"40 x 100 on blocks: {name} differs card vs CPU")
        dv = max(float((got.u.cpu() - want.u).abs().max()),
                 float((got.v.cpu() - want.v).abs().max()))
        check(dv <= ROW_SMALL_ATOL, f"40 x 100 on blocks: |dv| {dv:.3g}")
        log(f"   counts, alive, drops, RNG bitwise card vs CPU; max |dv| "
            f"{dv:.3g} (atol {ROW_SMALL_ATOL}); sources in rows "
            f"{sorted(set(sscn.source_yx[:, 0].tolist()))}; launches "
            f"{got_l}")

    summaries["row_blocks"] = summary
    return shared


# the frame on column blocks (M12 part d): 2 x 2 in-process blocks
COL_N = 2  # blocks a side
# The speed mode's 100 f32 Jacobi iterations stop far from convergence,
# so the order in which P4 folds its sums moves p by ~2e-6 of its scale
# a solve, and the dam break amplifies that: on 2 x 2 (and 1 x 2) blocks
# 16 cells' counts and max |dv| 1.07e-3 apart from 1 block after 3
# frames, on 4 x 1 blocks 4 cells and 4.2e-4 after 5 (an NVIDIA H100,
# tools/block_drift_lab.py; PERF.md §6).  With the solve in f64 the same
# frames stay 0 cells apart and within 1.2e-10 (2 x 2) over 5 frames:
# the layout computes the 1-block frame,
# the folds aside.  So the 2 x 2 dam break is held to 1 block with an
# f64 solve, counts equal and every velocity within COL_F64_ATOL (an
# f32 ulp at |v| ~ 10), and its f32 frames are timed and reported.
COL_F64_ATOL = 1e-6


def col_cut(k: int, rows: int, cols: int):
    """The cells of block k (rank order) of a COL_N x COL_N layout of
    rows x cols blocks."""
    r, c = divmod(k, COL_N)
    return (slice(r * rows, (r + 1) * rows), slice(c * cols, (c + 1) * cols))


def run_col_blocks(results, summaries, launches, dev, shared) -> None:
    """The frame on 2 x 2 ("y", "x") blocks on the card (M12 part d's
    column blocks: K1, K7 and S1 given column offsets, P4 over ("y",
    "x")), every block one thread of an in-process `comm.LocalGroup`:
    the kernels per block at 1024², P4's Jacobi solve of the 1024²
    substep system, the waterfall and the dam break at 1024² and the
    waterfall at 40 x 100.  Reuses the row phase's states, solves and
    1-block frames (`shared`)."""
    import torch

    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.markers_slots import source_pass_slots
    from euler_tpu_torch.ops.project import apply_a
    from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo

    summary = {}
    n = COL_N
    nb = n * n
    cfg, scn, st, dt, planes = (shared[k] for k in
                                ("cfg", "scn", "st", "dt", "planes"))
    Yl, Xl = cfg.ny // n, cfg.nx // n
    cfg_b = dataclasses.replace(cfg, ny=Yl + 2 * H, nx=Xl + 2 * H)
    kw = [dict(clamp_ny=cfg.ny, row_offset=r * Yl - H, clamp_nx=cfg.nx,
               col_offset=c * Xl - H) for r in range(n) for c in range(n)]
    crop = (..., slice(H, H + Yl), slice(H, H + Xl))

    def padded_blocks(arrays):
        return [[block_with_halo(a, n, r, H, n, c) for a in arrays]
                for r in range(n) for c in range(n)]

    with Phase(f"K1, K7 and S1 on {n} x {n} blocks at {SIZE}² (blocks "
               f"padded with {H} rows and columns): each block's launch "
               "bitwise its plain version, the cropped outputs bitwise "
               "the unsharded launch's cells; timed"):
        # K1 on the developed dam break
        k1b = padded_blocks(planes)
        whole = k1.march_rebin(cfg, *planes[:5], dt, planes[5],
                               dead=planes[6])
        k1_call = lambda: [k1.march_rebin(  # noqa: E731
            cfg_b, *p[:5], dt, p[5], dead=p[6], **kw[k])
            for k, p in enumerate(k1b)]
        k1_plain = lambda: [k1.march_rebin_plain(  # noqa: E731
            cfg_b, *p[:5], dt, p[5], dead=p[6], **kw[k])
            for k, p in enumerate(k1b)]
        for k, (g, p) in enumerate(zip(k1_call(), k1_plain())):
            for a, w_, u_, name in zip(g, p, whole,
                                       ("slots", "count", "drop")):
                check(torch.equal(a, w_), f"K1 block {k}: {name} differs "
                      "from its plain version")
                check(torch.equal(a[crop], u_[(..., *col_cut(k, Yl, Xl))]),
                      f"K1 block {k}: {name} differs from the unsharded K1")
        t_k, t_p, events = timed_pair(k1_call, k1_plain, 2)
        dev_ms = min(device_ms(k1_call, REPS) for _ in range(2))
        count = planes[5]
        live = sum(int(count[max(r * Yl - 1, 0):(r + 1) * Yl + 1,
                             max(c * Xl - 1, 0):(c + 1) * Xl + 1].sum())
                   for r in range(n) for c in range(n))
        results["K1b"] = {"ms": t_k, "plain_ms": t_p, "device_ms": dev_ms,
                          "max_abs_err": 0.0, "library_ms": None,
                          **bound_fields(*k1_blocks_bound(Yl, Xl, live, nb))}
        log(f"   K1 on {nb} blocks of [{2 * SLOTS}, {cfg_b.ny}, "
            f"{cfg_b.nx}]: bitwise; device {dev_ms:.4f} ms summed "
            f"(unsharded {results['K1'].get('device_ms', float('nan')):.4f}"
            f"); {events}; bound {results['K1b']['bound_ms']:.4f} ms by "
            f"{results['K1b']['bound_by']} ({live} live markers in the "
            "blocks' rings)")

        # K7 on the same state
        grid = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
        k7b = padded_blocks(grid)
        whole = k7.grid_stage(cfg, *grid, dt)
        k7_call = lambda: [k7.grid_stage(cfg_b, *p, dt, **kw[k])  # noqa: E731
                           for k, p in enumerate(k7b)]
        k7_plain = lambda: [k7.grid_stage_plain(  # noqa: E731
            cfg_b, dt, *p, **kw[k]) for k, p in enumerate(k7b)]
        for k, (g, p) in enumerate(zip(k7_call(), k7_plain())):
            for a, w_, u_, name in zip(g, p, whole, ("ut", "vt")):
                check(torch.equal(a, w_), f"K7 block {k}: {name} differs "
                      "from its plain version")
                check(torch.equal(a[crop], u_[col_cut(k, Yl, Xl)]),
                      f"K7 block {k}: {name} differs from the unsharded K7")
        t_k, t_p, events = timed_pair(k7_call, k7_plain)
        dev_ms = min(device_ms(k7_call, REPS) for _ in range(2))
        results["K7b"] = {"ms": t_k, "plain_ms": t_p, "device_ms": dev_ms,
                          "max_abs_err": 0.0, "library_ms": None,
                          **bound_fields(*k7_blocks_bound(Yl, Xl, nb, True))}
        log(f"   K7 on {nb} blocks of [{cfg_b.ny}, {cfg_b.nx}]: bitwise; "
            f"device {dev_ms:.4f} ms summed (unsharded "
            f"{results['K7'].get('device_ms', float('nan')):.4f}); "
            f"{events}; bound {results['K7b']['bound_ms']:.4f} ms by "
            f"{results['K7b']['bound_by']}")

        # S1 on the 1024² waterfall
        wcfg, wscn, wst = shared["frames_1"]["waterfall"][:3]
        ys = wscn.source_yx[:, 0].long()
        xs = wscn.source_yx[:, 1].long()
        counts = torch.where(wscn.source_valid, wst.marker_count[ys, xs],
                             0).to(torch.int32)
        act = torch.ones((), dtype=torch.bool, device=dev)
        wYl, wXl = wcfg.ny // n, wcfg.nx // n
        cuts = [col_cut(k, wYl, wXl) for k in range(nb)]
        bscn = [dataclasses.replace(
            wscn, **{f: getattr(wscn, f)[cut].contiguous()
                     for f in ("solid", "source", "sink")}) for cut in cuts]

        def s1_blocks():
            return [wst.replace(**{
                f: getattr(wst, f)[(..., *cut)].clone(
                    memory_format=torch.contiguous_format)
                for f in ("markers", "alive", "marker_count", "r", "g",
                          "b")}, **{
                f: getattr(wst, f).clone()
                for f in ("rng", "alive_count", "source_exhausted")})
                for cut in cuts]

        def s1_call(fn, blks):
            for k, blk in enumerate(blks):
                fn(wcfg, bscn[k], blk, act, cuts[k][0].start, counts,
                   cuts[k][1].start)
            return blks

        whole_s1 = s1_copy(wst)
        s1.emit_sources(wcfg, wscn, whole_s1, act)
        got = s1_call(s1.emit_sources, s1_blocks())
        want = s1_call(source_pass_slots, s1_blocks())
        for k, (g_, w_) in enumerate(zip(got, want)):
            for f in S1_FIELDS:
                a_, b_ = getattr(g_, f), getattr(w_, f)
                full = getattr(whole_s1, f)
                if full.dim() >= 2:
                    full = full[(..., *cuts[k])]
                for other, what in ((b_, "its plain version"),
                                    (full, "the unsharded S1")):
                    check(torch.equal(a_.to(torch.int64),
                                      other.to(torch.int64))
                          if f == "rng" else torch.equal(a_, other),
                          f"S1 block {k}: {f} differs from {what}")
        emitted = int(whole_s1.alive_count) - int(wst.alive_count)
        holding = sorted({divmod(int(y) // wYl * n + int(x) // wXl, n)
                          for y, x in wscn.source_yx.tolist()})
        k_blks, p_blks = s1_blocks(), s1_blocks()
        t_k, t_p, events = timed_pair(
            lambda: s1_call(s1.emit_sources, k_blks),
            lambda: s1_call(source_pass_slots, p_blks), 1)
        results["S1b"] = {"ms": t_k, "plain_ms": t_p, "max_abs_err": 0.0,
                          "library_ms": None,
                          **bound_fields(*s1_blocks_bound(wscn.num_sources,
                                                   emitted, nb))}
        log(f"   S1 on {nb} blocks of the {SIZE}² waterfall "
            f"({wscn.num_sources} sources in blocks {holding} (row, "
            f"column), {emitted} emitted): bitwise its plain version and "
            f"the unsharded S1; {events} the {nb} launches; bound "
            f"{results['S1b']['bound_ms']:.3g} ms")
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"P4 (Jacobi, the speed mode's budget) on {n} x {n} blocks "
               f"of the {SIZE}² substep system: against the 1-block solve "
               "and the plain P4"):
        c = shared["configs"]["jacobi"]
        b, a_diag, fl = shared["b"], shared["a_diag"], shared["fl"]
        ref = shared["unsharded"]["jacobi"]
        one = shared["one_block"]["jacobi"]
        scale = float(ref[0].abs().max())
        reset_counts()
        p, it, res, ms = block_solve(c, b, a_diag, fl, n, dev, x=n)
        check(_build.LAUNCHES["P4"] == 2 * nb and not _build.PLAIN_CALLS,
              f"P4 on {n} x {n} blocks: launches {dict(_build.LAUNCHES)}")
        err1 = float((p - one[0]).abs().max()) / scale
        err = float((p - ref[0]).abs().max()) / scale
        true_res = float((b - apply_a(a_diag, fl, p)).abs().max())
        check(it == one[1] == int(ref[1]) and err1 <= 1e-4 and err <= 1e-4,
              f"P4 on {n} x {n} blocks: {it} iterations (1 block "
              f"{one[1]}), p {err1:.3g} of scale from 1 block, {err:.3g} "
              "from P1")
        q, it_q, _, ms_q = block_solve(c, b, a_diag, fl, n, dev, plain=True,
                                       x=n)
        kerr = float((p - q).abs().max())
        check(it == it_q and kerr <= 1e-4 * scale,
              f"P4 on {n} x {n} blocks vs plain: {it} vs {it_q} "
              f"iterations, p {kerr:.3g} apart")
        row = {"ms": ms, "iters": it, "resid": res, "true_resid": true_res,
               "err_vs_1_block": err1, "err_vs_unsharded": err,
               "plain": {"ms": ms_q, "iters": it_q, "max_abs_err": kerr}}
        summary["p4_jacobi"] = {f"blocks_{n}x{n}": row}
        results["P4b"] = {"ms": ms, "plain_ms": ms_q, "max_abs_err": kerr,
                          "library_ms": None,
                          **bound_fields(*BOUNDS["P4"](cfg.ny * cfg.nx, it,
                                                       0))}
        rows_ms = summaries["row_blocks"]["p4_jacobi"][f"blocks_{ROW_N}"][
            "ms"]
        log(f"   {n} x {n} blocks: {ms:.3f} ms a solve (CUDA events around "
            f"the blocks' calls; {ROW_N} row blocks {rows_ms:.3f}), {it} "
            f"iterations as 1 block, p within {err1:.3g} of scale "
            f"of 1 block and {err:.3g} of P1; resid {res:.4g} (|b - A p| "
            f"{true_res:.4g}); plain P4 {ms_q:.3f} ms, {it_q} iterations, "
            f"p {kerr:.3g} apart")

    with Phase(f"the {SIZE}² waterfall (Jacobi budget) and dam break "
               f"(speed mode) on {n} x {n} blocks: {ROW_WARMUP} warm-up + "
               f"{ROW_TIMED} timed frames, K1, S1, K7, P4 and no plain "
               "version; against 1 block"):
        dcfg = shared["frames_1"]["dam_break"][0]
        f64 = dataclasses.replace(dcfg, solver=dataclasses.replace(
            dcfg.solver, dtype="float64"))
        for label, gate in (("waterfall", "f32"), ("dam_break", None),
                            ("dam_break_f64", "f64")):
            fcfg, fscn, fst, one, ms1 = shared["frames_1"][
                label.removesuffix("_f64")]
            if gate == "f64":
                fcfg = f64
                one, ms1, _, _ = block_frames(fcfg, fscn, fst, 1, dev,
                                              ROW_WARMUP, ROW_TIMED)
            per = nb * fcfg.max_substeps * ROW_TIMED
            got, ms, got_l, plain = block_frames(fcfg, fscn, fst, n, dev,
                                                 ROW_WARMUP, ROW_TIMED, x=n)
            names = (("K1", "S1", "K7", "P4") if fscn.num_sources
                     else ("K1", "K7", "P4"))
            check(plain == 0 and all(got_l.get(k) == per for k in names),
                  f"{label} on {n} x {n} blocks: not one launch a block a "
                  f"substep: {got_l}, plain calls {plain}")
            for name in ("u", "v", "p", "markers"):
                check(bool(torch.isfinite(getattr(got, name)).all()),
                      f"{label} on {n} x {n} blocks: {name} not finite")
            d = frame_diff(got, one)
            held = {"f32": f"<= {ROW_FRAME_COUNT_CELLS} cells, max |dv| <= "
                           f"{ROW_FRAME_ATOL}",
                    "f64": f"0 cells, max |dv| <= {COL_F64_ATOL}",
                    None: "reported: P4's f32 folds, see COL_F64_ATOL"}[gate]
            log(f"   {label}: {n} x {n} blocks {ms:.1f} ms a frame, 1 block "
                f"{ms1:.1f}; launches {got_l}; {d['count_cells']} of "
                f"{d['cells']} cells' counts differ, max |dv| "
                f"{d['max_dv']:.3g} ({held}); alive {d['alive']}")
            if gate == "f32":
                check(frames_agree(d), f"{label}, {n} x {n} blocks vs 1: "
                      f"{d}")
            elif gate == "f64":
                check(d["count_cells"] == 0 and d["max_dv"] <= COL_F64_ATOL,
                      f"{label}, {n} x {n} blocks vs 1: {d}")
            check(d["alive"][0] == d["alive"][1],
                  f"{label}, {n} x {n} blocks vs 1: alive {d['alive']}")
            summary[f"{label}_1024"] = {
                "ms_per_frame": ms, "ms_per_frame_1_block": ms1,
                "launches": got_l, "vs_1_block": d,
                "div_inf": div_inf(fcfg, got, exclude=fscn.source
                                   if fscn.num_sources else None)}
            if label == "waterfall":
                for k, name in (("K1b", "K1"), ("K7b", "K7"),
                                ("S1b", "S1"), ("P4b", "P4")):
                    launches[k] = got_l.get(name, 0)
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"the 40 x 100 waterfall on {n} x {n} blocks of 20 x 50, "
               f"{ROW_SMALL_FRAMES} frames: card (kernels) vs CPU (plain "
               "versions) on the same blocks"):
        scfg_, sscn, sst = cli_state(["scenarios/waterfall.txt"])
        cscn, cst = to_cpu(sscn, sst)
        got, _, got_l, plain = block_frames(scfg_, sscn, sst, n, dev, 0,
                                            ROW_SMALL_FRAMES, x=n)
        want, _, _, _ = block_frames(scfg_, cscn, cst, n, "cpu", 0,
                                     ROW_SMALL_FRAMES, x=n)
        check(plain == 0 and all(got_l.get(k, 0) > 0
                                 for k in ("K1", "S1", "K7", "P4")),
              f"40 x 100 on {n} x {n} blocks: launches {got_l}, plain "
              f"calls {plain}")
        for name in ("marker_count", "alive", "alive_count",
                     "dropped_markers", "rng"):
            a_, b_ = getattr(got, name).cpu(), getattr(want, name)
            check(torch.equal(a_.to(torch.int64), b_.to(torch.int64)),
                  f"40 x 100 on {n} x {n} blocks: {name} differs card vs "
                  "CPU")
        dv = max(float((got.u.cpu() - want.u).abs().max()),
                 float((got.v.cpu() - want.v).abs().max()))
        check(dv <= ROW_SMALL_ATOL,
              f"40 x 100 on {n} x {n} blocks: |dv| {dv:.3g}")
        summary["small_40x100"] = {"max_dv": dv, "launches": got_l}
        log(f"   counts, alive, drops, RNG bitwise card vs CPU; max |dv| "
            f"{dv:.3g} (atol {ROW_SMALL_ATOL}); launches {got_l}")
    summaries["col_blocks"] = summary


# the frame's global MG solve on blocks (M12 part d item 1: P5)
GMG_LAYOUTS = ((1, 1), (COL_N, COL_N), (4, 1))
GMG_REPS = 3      # timed P5 solves (a few hundred ms each, host-bound)
GMG_FRAMES = 2    # MG frames of the 1024² waterfall and dam break
WATERFALL_MG_1024 = ["scenarios/waterfall.txt", "--size", "1024x1024"]


def p5_group(cfg, b, a_diag, fl, x0, y, x, dev):
    """A `LocalGroup` of y x x blocks on `dev` and each block's cut of
    (b, a_diag, fl, fluid1, x0): fluid1 its fluid with one row (and
    column) of each neighbour's, x0 None for a cold start."""
    from euler_tpu_torch.parallel.comm import LocalGroup
    from euler_tpu_torch.parallel.cuda_shard import padded

    Yl, Xl = cfg.ny // y, cfg.nx // x

    def cut(comm):
        ry, rx = comm.rank("y"), comm.rank("x")
        c = (slice(ry * Yl, (ry + 1) * Yl), slice(rx * Xl, (rx + 1) * Xl))
        bb, aa, ff = (t[c].contiguous() for t in (b, a_diag, fl))
        return (bb, aa, ff, padded(ff, comm, 1),
                None if x0 is None else x0[c].contiguous())

    g = LocalGroup(y, x, device=dev)
    return g, g.run(cut)


def p5_solve(cfg, g, inputs, plain=False, gather=None):
    """One solve on the blocks of `g` (`p5_group`): P5 through
    `spatial_mg.solve_pressure_blocks` (with `gather`, through
    `solve_mg_blocks` on the plan forced to gather there), or with
    `plain` its plain version on the same card tensors.  Returns every
    block's (p, iterations, residual)."""
    from euler_tpu_torch.ops.cuda.pcg_mg_blocks_kernel import solve_mg_blocks
    from euler_tpu_torch.parallel import spatial_mg

    def rank(comm):
        axes = ("y", "x") if comm.size("x") > 1 else ("y",)
        b, a, fl, fl1, x0 = inputs[comm.r]
        ring = spatial_mg.fluid_ring(fl1, "x" in axes)
        if plain:
            return spatial_mg.pcg_blocks_plain(cfg, comm, axes, b, a, fl,
                                               ring, x0)
        if gather is not None:
            return solve_mg_blocks(
                cfg, comm, axes,
                spatial_mg.block_plan(cfg, comm, axes, gather), b, a, fl,
                ring, x0)
        return spatial_mg.solve_pressure_blocks(cfg, comm, axes, b, a, fl,
                                                fl1, x0)

    return g.run(rank)


def check_p5_hierarchy(cfg, g, inputs, ws3, z3, label: str,
                       gather=None) -> None:
    """The hierarchy P5 built in the blocks' last solve (the packed level 0
    and the distributed levels put together, the gathered levels, the
    Chebyshev rows; at a gather level of 0 the whole levels each block
    holds, level 0 at P3's padded shape) and one cycle of it on the
    blocks, bitwise P3's (`ws3`, its last solve of the same system, and
    `z3`, its cycle of the same RHS, cropped to the grid); `gather`: the
    forced plan's, as `p5_solve` takes it."""
    import torch

    from euler_tpu_torch.ops.cuda import pcg_mg_blocks_kernel as p5
    from euler_tpu_torch.parallel import spatial_mg

    def rank(comm):
        axes = ("y", "x") if comm.size("x") > 1 else ("y",)
        plan = spatial_mg.block_plan(cfg, comm, axes, gather)
        ws = p5.workspace(cfg, comm, plan, inputs[comm.r][0].device)

        def whole(t):
            return spatial_mg.gather_plane(t, comm, axes)

        G = plan.gather
        packed0 = ws.whole[0]["packed"] if G == 0 else whole(ws.packed0)
        levels = [tuple(whole(ws.block[l][k]) for k in "cen")
                  for l in range(1, G)]
        levels += [tuple(ws.whole[l][k] for k in "cen")
                   for l in range(max(G, 1), len(plan.shapes))]
        z = ws.cycle(comm, axes, inputs[comm.r][0])
        return G, packed0, levels, ws.rows.clone(), whole(z)

    gather, packed0, levels, rows, z = g.run(rank)[0]
    check(torch.equal(packed0, ws3.packed0), f"P5 {label}: packed level 0 "
          "differs from P3's")
    check(len(levels) == len(ws3.levels), f"P5 {label}: {len(levels)} "
          "coarse levels")
    for l, (got, want) in enumerate(zip(levels, ws3.levels), start=1):
        for name, a_, c_ in zip("cen", got, want[:3]):
            check(torch.equal(a_, c_), f"P5 {label}: level {l} {name} "
                  "differs from P3's")
    check(torch.equal(rows, ws3.rows), f"P5 {label}: Chebyshev rows differ "
          "from P3's")
    check(bool(z3.abs().max() > 0) and torch.equal(z, z3),
          f"P5 {label}: one cycle differs from P3's")
    log(f"   P5 {label}: gather level {gather}; packed level 0, "
        f"{len(levels)} coarse levels, the Chebyshev rows and one cycle "
        "bitwise P3's")
    return gather


def run_global_mg_blocks(results, summaries, launches, dev, shared) -> None:
    """The frame's global MG solve on ("y", "x") blocks on the card (M12
    part d item 1: P5, `parallel/spatial_mg.py`), every block one thread
    of an in-process `comm.LocalGroup`: on the 1024² substep system,
    against P3 (`pcg_general_kernel.solve_pressure_general` called
    directly: the 1024² route is K3) on 1 x 1, 2 x 2 and 4 x 1 blocks,
    bitwise where the function is P3's (the hierarchy, a cycle, 1 x 1
    blocks), timed; then the 1024² MG waterfall and dam break on 2 x 2
    blocks against 1 block, each frame held to `frames_agree` (the dam
    break is the case whose fluid crosses the blocks' edges).  Reuses the row phase's
    system and states (`shared`)."""
    import torch

    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13

    summary = {}
    c = shared["configs"]["mg"]
    b, a_diag, fl, st = (shared[k] for k in ("b", "a_diag", "fl", "st"))
    p0 = torch.where(fl, st.p, 0.0)
    starts = {"cold": None, "warm": p0}
    with Phase(f"P5 on {', '.join(f'{y} x {x}' for y, x in GMG_LAYOUTS)} "
               f"in-process blocks of the {SIZE}² substep system: hierarchy "
               "and one cycle bitwise P3's, 1 x 1 bitwise P3, iterations "
               "within 1 and p within 5e-4 of scale elsewhere; P3 and P5 "
               "timed cold and warm, the plain P5 once"):
        refs = {}
        for label, x0 in starts.items():
            refs[label] = p13.solve_pressure_general(c, b, a_diag, fl, x0=x0)
            t3 = cuda_ms(lambda: p13.solve_pressure_general(
                c, b, a_diag, fl, x0=x0), REPS)
            summary[f"p3_{label}"] = {"ms": t3, "iters": int(refs[label][1])}
            log(f"   P3 {label}: {t3:.3f} ms a solve (CUDA events), "
                f"{int(refs[label][1])} iterations")
        # P3's workspace keeps the hierarchy of its last solve (warm, the
        # same system)
        ws3 = p13.workspace(c, dev)
        z3 = ws3.cycle(b, per_op=False)
        scale = float(refs["warm"][0].abs().max())
        err_max = 0.0
        for y, x in GMG_LAYOUTS:
            for label, x0 in starts.items():
                ref = refs[label]
                g, inputs = p5_group(c, b, a_diag, fl, x0, y, x, dev)
                with g:
                    reset_counts()
                    out = p5_solve(c, g, inputs)
                    check(_build.LAUNCHES["P5"] == y * x
                          and not _build.PLAIN_CALLS,
                          f"P5 {y} x {x}: launches {dict(_build.LAUNCHES)}, "
                          f"plain {dict(_build.PLAIN_CALLS)}")
                    check(len({(int(o[1]), float(o[2])) for o in out}) == 1,
                          f"P5 {y} x {x}: the blocks' iterations or "
                          "residuals differ")
                    p = together([o[0] for o in out], x)
                    it, res = int(out[0][1]), float(out[0][2])
                    err = float((p - ref[0]).abs().max()) / scale
                    if (y, x) == (1, 1):
                        check(torch.equal(p, ref[0]) and it == int(ref[1])
                              and res == float(ref[2]),
                              f"P5 1 x 1 {label}: not P3's bits ({it} vs "
                              f"{int(ref[1])} iterations, p {err:.3g} of "
                              "scale)")
                    else:
                        check(abs(it - int(ref[1])) <= 1 and err <= 5e-4,
                              f"P5 {y} x {x} {label}: {it} iterations (P3 "
                              f"{int(ref[1])}), p {err:.3g} of scale")
                    ms = cuda_ms(lambda: p5_solve(c, g, inputs), GMG_REPS)
                    row = {"ms": ms, "iters": it, "resid": res,
                           "err_vs_p3": err}
                    if label == "warm" and (y, x) != (1, 1):
                        check_p5_hierarchy(c, g, inputs, ws3, z3,
                                           f"{y} x {x}")
                    if label == "warm" and (y, x) == (COL_N, COL_N):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        q = p5_solve(c, g, inputs, plain=True)
                        torch.cuda.synchronize()
                        ms_q = 1e3 * (time.perf_counter() - t0)
                        kerr = float((p - together([o[0] for o in q], x))
                                     .abs().max())
                        check(abs(it - int(q[0][1])) <= 1
                              and kerr <= 5e-4 * scale,
                              f"P5 {y} x {x} vs plain: {it} vs "
                              f"{int(q[0][1])} iterations, p {kerr:.3g} "
                              "apart")
                        row["plain"] = {"ms": ms_q, "iters": int(q[0][1]),
                                        "max_abs_err": kerr}
                        results["P5"] = {
                            "ms": ms, "plain_ms": ms_q, "max_abs_err": kerr,
                            "library_ms": None}
                        nbytes, flops = BOUNDS["P5"](c.ny * c.nx, it, 0)
                        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
                        t_ops = 1e3 * flops / F32_FLOP_PER_S
                        results["P5"].update(
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations")
                        log(f"   P5 {y} x {x} plain version (warm): "
                            f"{ms_q:.1f} ms, {int(q[0][1])} iterations, p "
                            f"{kerr:.3g} from P5; bound "
                            f"{results['P5']['bound_ms']:.4f} ms by "
                            f"{results['P5']['bound_by']} (P3's work)")
                summary[f"blocks_{y}x{x}_{label}"] = row
                if (y, x) != (1, 1):
                    err_max = max(err_max, err)
                log(f"   P5 {y} x {x} {label}: {ms:.2f} ms a solve (CUDA "
                    f"events around the blocks' calls; P3 "
                    f"{summary[f'p3_{label}']['ms']:.3f}), {it} iterations "
                    f"(P3 {int(ref[1])}), p within {err:.3g} of P3's scale")
        summary["max_err_vs_p3"] = err_max
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"the {SIZE}² MG waterfall and dam break on {COL_N} x "
               f"{COL_N} blocks (P5), {GMG_FRAMES} frames, against 1 block "
               "frame by frame"):
        nb = COL_N * COL_N
        wcfg = cli_state(WATERFALL_MG_1024)[0]
        check(wcfg.solver.preconditioner == "mg" and wcfg.solver.warm_start,
              f"the CLI's 1024² waterfall solves with {wcfg.solver}")
        wscn, wst = shared["frames_1"]["waterfall"][1:3]
        p5_launches = 0
        for label, (fcfg, fscn, fst) in (
                ("waterfall", (wcfg, wscn, wst)),
                ("dam_break", (shared["cfg"], shared["scn"], shared["st"]))):
            names = (("K1", "S1", "K7", "P5") if fscn.num_sources
                     else ("K1", "K7", "P5"))
            got, one, per_frame = fst, fst, []
            for frame in range(1, GMG_FRAMES + 1):
                got, ms, got_l, plain = block_frames(fcfg, fscn, got, COL_N,
                                                     dev, 0, 1, x=COL_N)
                per = nb * fcfg.max_substeps
                check(plain == 0 and all(got_l.get(k) == per for k in names)
                      and not got_l.get("P4"),
                      f"MG {label} on {COL_N} x {COL_N} blocks: not one "
                      f"launch a block a substep: {got_l}, plain {plain}")
                if label == "waterfall":
                    p5_launches += got_l["P5"]
                one, ms1, _, _ = block_frames(fcfg, fscn, one, 1, dev, 0, 1)
                for name in ("u", "v", "p", "markers"):
                    check(bool(torch.isfinite(getattr(got, name)).all()),
                          f"MG {label} on blocks: {name} not finite")
                d = frame_diff(got, one)
                d.update(ms_per_frame=ms, ms_per_frame_1_block=ms1)
                per_frame.append(d)
                log(f"   {label} frame {frame}: {COL_N} x {COL_N} blocks "
                    f"{ms:.1f} ms, 1 block {ms1:.1f} ms; {d['count_cells']} "
                    f"of {d['cells']} cells' counts apart, max |dv| "
                    f"{d['max_dv']:.3g}; alive {d['alive']}")
                check(frames_agree(d), f"MG {label}, {COL_N} x {COL_N} "
                      f"blocks vs 1, frame {frame}: {d}")
            summary[f"{label}_1024"] = {
                "frames": per_frame,
                "div_inf": div_inf(fcfg, got, exclude=fscn.source
                                   if fscn.num_sources else None)}
        launches["P5"] = p5_launches
        log(f"   nvidia-smi: {smi_line()}")
    summaries["global_mg_blocks"] = summary


# the frame's global IC(0) solve on blocks (M12 part d item 2: P6)
IC0_LAYOUTS = ((1, 1), (COL_N, COL_N), (4, 1))
IC0_SMALL = (40, 100)  # P6 against its plain version, 2 x 2 blocks
IC0_REPS = 2           # timed P6 solves (host-bound)
IC0_DEVELOP = 3        # frames of the 256² IC(0) dam break before the checks
# p of the 1024² solve, which stops at the cap of 400 unconverged, against
# P1 + P2's, in p's scale (1.37e-5 measured there on the H100)
IC0_CAPPED_RTOL = 1e-4


def ic0_slots_cfg(ny: int, nx: int, dtype: str = "float64"):
    """The golden configuration's solve with IC(0) (f64, cap 400, tol
    1e-6) on the slot layout at ny x nx, the solve in `dtype`."""
    return dataclasses.replace(
        golden_cfg(preconditioner="ic0", dtype=dtype), nx=nx, ny=ny,
        marker_layout="slots")


def p6_run(cfg, y, x, dev, fn, *planes):
    """fn(comm, axes, *cuts) on a `LocalGroup` of y x x blocks on `dev`,
    every block's result, with the group (open: close it)."""
    from euler_tpu_torch.parallel.comm import LocalGroup

    Yl, Xl = cfg.ny // y, cfg.nx // x
    cuts = []
    for r in range(y * x):
        c = (slice(r // x * Yl, (r // x + 1) * Yl),
             slice(r % x * Xl, (r % x + 1) * Xl))
        cuts.append([None if t is None else t[c].contiguous()
                     for t in planes])
    g = LocalGroup(y, x, device=dev)

    def rank(comm):
        return fn(comm, ("y", "x") if x > 1 else ("y",), *cuts[comm.r])

    return g, rank


def p6_solve(cfg, y, x, dev, b, a_diag, fl, x0=None, plain=False):
    """P6 on y x x blocks through `spatial_ic0.solve_pressure_blocks_ic0`,
    or with `plain` its plain version on the same card tensors: (the
    group, its rank function), whose `g.run(rank)` gives every block's
    (p, iterations, residual)."""
    from euler_tpu_torch.parallel import spatial_ic0
    from euler_tpu_torch.parallel.halo import pcg_sharded

    def fn(comm, axes, b_, a_, f_, x_):
        if plain:
            return pcg_sharded(cfg, comm, axes, b_, a_, f_, x_,
                               precon=spatial_ic0.block_ic0(
                                   cfg, comm, axes, a_, f_),
                               grid_order=True)
        return spatial_ic0.solve_pressure_blocks_ic0(cfg, comm, axes, b_,
                                                     a_, f_, x_)

    return p6_run(cfg, y, x, dev, fn, b, a_diag, fl, x0)


def events_ms(fn):
    """(fn(), its ms by CUDA events around the call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def p6_result(out, x):
    """(p put together, iterations, residual) of every block's solve,
    checked to agree on the iterations and residual."""
    check(len({(int(o[1]), float(o[2])) for o in out}) == 1,
          "P6: the blocks' iterations or residuals differ")
    return together([o[0] for o in out], x), int(out[0][1]), float(out[0][2])


def run_ic0_blocks(results, summaries, launches, dev, shared) -> None:
    """The frame's global IC(0) solve on ("y", "x") blocks on the card (M12
    part d item 2: P6, `parallel/spatial_ic0.py`), every block one thread
    of an in-process `comm.LocalGroup`: on the developed 256² IC(0) dam
    break, the sweeps (E_inv and one application) bitwise P2's, the solve
    against P1 + P2 (`pcg_general_kernel.solve_pressure_general`) on 1 x
    1, 2 x 2 and 4 x 1 blocks, bitwise on 1 x 1, timed; P6 against its
    plain version at 40 x 100; the 256² frames on 2 x 2 and 4 x 1 blocks
    against 1 block; one cold solve of the 1024² system (the row phase's,
    in f64) on 2 x 2 blocks, timed beside P1 + P2."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12
    from euler_tpu_torch.parallel import spatial_ic0

    summary = {}
    n = IC0_SIZE
    cfg = ic0_slots_cfg(n, n)
    with Phase(f"P6 on {', '.join(f'{y} x {x}' for y, x in IC0_LAYOUTS)} "
               f"in-process blocks of the {n}² IC(0) system: the sweeps "
               "bitwise P2's (f64, f32), 1 x 1 bitwise P1 + P2, iterations "
               "within 1 and p within 1e-9 of scale elsewhere; timed; the "
               f"plain P6 at {IC0_SMALL[0]} x {IC0_SMALL[1]}"):
        scn, st = dam_break(cfg, device=dev)
        for _ in range(IC0_DEVELOP):
            st = sim.step_frame(cfg, scn, st)
        dt, _, _, b, a_diag = substep_system(cfg, scn, st)
        fl = st.fluid
        p0 = torch.where(fl, st.p, 0.0).to(torch.float64)
        for dtype in ("float64", "float32"):
            dcfg = ic0_slots_cfg(n, n, dtype)
            r = b.to(getattr(torch, dtype))
            z2, e2 = p12.ic0_apply(a_diag, fl, r, e_inv=True)
            for y, x in IC0_LAYOUTS[1:]:
                g, rank = p6_run(dcfg, y, x, dev, lambda comm, axes, *t:
                                 spatial_ic0.precondition_blocks(
                                     dcfg, comm, axes, *t), a_diag, fl, r)
                with g:
                    reset_counts()
                    out = g.run(rank)
                check(_build.LAUNCHES["P6"] == y * x
                      and not _build.PLAIN_CALLS,
                      f"P6 sweeps {y} x {x}: launches "
                      f"{dict(_build.LAUNCHES)}, plain "
                      f"{dict(_build.PLAIN_CALLS)}")
                e_inv = together([o[0] for o in out], x)
                z = together([o[1] for o in out], x)
                check(bool(z2.abs().max() > 0) and torch.equal(e_inv, e2)
                      and torch.equal(z, z2), f"P6 sweeps {y} x {x} "
                      f"{dtype}: E_inv or z differs from P2's")
                log(f"   P6 sweeps on {y} x {x} blocks, {dtype}: E_inv and "
                    "one application bitwise P2's")
        starts = {"cold": None, "warm": p0}
        refs = {}
        for label, x0 in starts.items():
            refs[label] = p12.solve_pressure_general(cfg, b, a_diag, fl,
                                                     x0=x0)
            t12 = cuda_ms(lambda: p12.solve_pressure_general(
                cfg, b, a_diag, fl, x0=x0), REPS)
            summary[f"p1_p2_{label}"] = {"ms": t12,
                                         "iters": int(refs[label][1])}
            log(f"   P1 + P2 {label}: {t12:.3f} ms a solve (CUDA events), "
                f"{int(refs[label][1])} iterations")
        scale = float(refs["cold"][0].abs().max())
        for y, x in IC0_LAYOUTS:
            for label, x0 in starts.items():
                ref = refs[label]
                g, rank = p6_solve(cfg, y, x, dev, b, a_diag, fl, x0)
                with g:
                    reset_counts()
                    (p, it, res), ms = events_ms(lambda: p6_result(
                        g.run(rank), x))
                    check(_build.LAUNCHES["P6"] == y * x
                          and not _build.PLAIN_CALLS,
                          f"P6 {y} x {x}: launches {dict(_build.LAUNCHES)}, "
                          f"plain {dict(_build.PLAIN_CALLS)}")
                    err = float((p - ref[0]).abs().max()) / scale
                    if (y, x) == (1, 1):
                        check(torch.equal(p, ref[0]) and it == int(ref[1])
                              and res == float(ref[2]),
                              f"P6 1 x 1 {label}: not P1 + P2's bits ({it} "
                              f"vs {int(ref[1])} iterations, p {err:.3g} of "
                              "scale)")
                    else:
                        check(abs(it - int(ref[1])) <= 1 and err <= 1e-9,
                              f"P6 {y} x {x} {label}: {it} iterations (P1 + "
                              f"P2 {int(ref[1])}), p {err:.3g} of scale")
                summary[f"blocks_{y}x{x}_{label}"] = {
                    "ms": ms, "iters": it, "resid": res, "err_vs_p1_p2": err}
                log(f"   P6 {y} x {x} {label}: {ms:.2f} ms a solve (CUDA "
                    f"events around the blocks' calls, the cold one making "
                    f"the workspace; P1 + P2 "
                    f"{summary[f'p1_p2_{label}']['ms']:.3f}), {it} "
                    f"iterations (P1 + P2 {int(ref[1])}), p within "
                    f"{err:.3g} of scale")

        sy, sx = IC0_SMALL
        scfg = ic0_slots_cfg(sy, sx)
        sscn, sst = dam_break(scfg, device=dev)
        for _ in range(IC0_DEVELOP):
            sst = sim.step_frame(scfg, sscn, sst)
        _, _, _, sb, sa = substep_system(scfg, sscn, sst)
        sfl = sst.fluid
        g, rank = p6_solve(scfg, COL_N, COL_N, dev, sb, sa, sfl)
        gq, rank_q = p6_solve(scfg, COL_N, COL_N, dev, sb, sa, sfl,
                              plain=True)
        with g, gq:
            p, it, _ = p6_result(g.run(rank), COL_N)
            (q, it_q, _), ms_q = events_ms(lambda: p6_result(gq.run(rank_q),
                                                             COL_N))
            sscale = float(q.abs().max())
            kerr = float((p - q).abs().max())
            check(abs(it - it_q) <= 1 and kerr <= 1e-9 * sscale,
                  f"P6 {sy} x {sx} vs plain: {it} vs {it_q} iterations, p "
                  f"{kerr:.3g} apart (scale {sscale:.3g})")
            ms = cuda_ms(lambda: g.run(rank), IC0_REPS)
        nbytes, flops = BOUNDS["P6"](sy * sx, it, 0)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / FLOP_RATES["P6"]
        results["P6"] = {"ms": ms, "plain_ms": ms_q, "max_abs_err": kerr,
                         "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations"}
        steps = 2 * (2 * COL_N - 1) * (sy // COL_N + sx // COL_N - 1)
        summary[f"plain_{sy}x{sx}"] = {"ms": ms, "plain_ms": ms_q,
                                       "iters": it, "plain_iters": it_q,
                                       "max_abs_err": kerr,
                                       "dependent_steps_an_iteration": steps}
        log(f"   P6 {COL_N} x {COL_N} at {sy} x {sx}: {ms:.2f} ms a cold "
            f"solve, its plain version on the same card tensors {ms_q:.1f} "
            f"ms; {it} / {it_q} iterations, p {kerr:.3g} apart; bound "
            f"{results['P6']['bound_ms']:.4g} ms by "
            f"{results['P6']['bound_by']}, and {steps} dependent diagonal "
            "steps an iteration (forward and back, staged)")
        shared["ic0_small"] = (scfg, sb, sa, sfl)
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"the {n}² IC(0) dam break on {COL_N} x {COL_N} blocks "
               "(P6), 2 frames, and on 4 x 1 blocks, 1 frame, against 1 "
               "block frame by frame"):
        per_layout = {}
        p6_launches = 0
        for (y, x), frames in (((COL_N, COL_N), 2), ((4, 1), 1)):
            got, one, per_frame = st, st, []
            for frame in range(1, frames + 1):
                got, ms, got_l, plain = block_frames(cfg, scn, got, y, dev,
                                                     0, 1, x=x)
                per = y * x * cfg.max_substeps
                check(plain == 0 and all(got_l.get(k) == per
                                         for k in ("K1", "K7", "P6"))
                      and not got_l.get("P4") and not got_l.get("P1"),
                      f"IC(0) dam break on {y} x {x} blocks: not one launch "
                      f"a block a substep: {got_l}, plain {plain}")
                if (y, x) == (COL_N, COL_N):
                    p6_launches += got_l["P6"]
                one, ms1, _, _ = block_frames(cfg, scn, one, 1, dev, 0, 1)
                for name in ("u", "v", "p", "markers"):
                    check(bool(torch.isfinite(getattr(got, name)).all()),
                          f"IC(0) on blocks: {name} not finite")
                d = frame_diff(got, one)
                d.update(ms_per_frame=ms, ms_per_frame_1_block=ms1)
                per_frame.append(d)
                log(f"   {y} x {x} frame {frame}: blocks {ms:.1f} ms, 1 "
                    f"block {ms1:.1f} ms; {d['count_cells']} of {d['cells']}"
                    f" cells' counts apart, max |dv| {d['max_dv']:.3g}; "
                    f"alive {d['alive']}")
                check(frames_agree(d), f"IC(0) dam break, {y} x {x} blocks "
                      f"vs 1, frame {frame}: {d}")
            per_layout[f"{y}x{x}"] = per_frame
        summary[f"dam_break_{n}"] = per_layout
        launches["P6"] = p6_launches

    with Phase(f"one cold P6 solve of the {SIZE}² system (f64) on {COL_N} x "
               f"{COL_N} blocks against P1 + P2"):
        bcfg = ic0_slots_cfg(SIZE, SIZE)
        bb = shared["b"].to(torch.float64)
        ba, bfl = shared["a_diag"], shared["fl"]
        ref = p12.solve_pressure_general(bcfg, bb, ba, bfl)
        t12 = cuda_ms(lambda: p12.solve_pressure_general(bcfg, bb, ba, bfl),
                      1)
        g, rank = p6_solve(bcfg, COL_N, COL_N, dev, bb, ba, bfl)
        with g:
            (p, it, res), ms = events_ms(lambda: p6_result(g.run(rank),
                                                           COL_N))
        err = float((p - ref[0]).abs().max()) / float(ref[0].abs().max())
        # a solve that stops at the cap has not converged: there the
        # blocks' fold order, 400 iterations on, moves p by ~1e-5 of scale
        capped = int(ref[1]) >= bcfg.solver.max_iterations
        check(abs(it - int(ref[1])) <= 1
              and err <= (IC0_CAPPED_RTOL if capped else 1e-9),
              f"P6 {SIZE}² on {COL_N} x {COL_N}: {it} iterations (P1 + P2 "
              f"{int(ref[1])}), p {err:.3g} of scale")
        summary[f"solve_{SIZE}_{COL_N}x{COL_N}_cold"] = {
            "ms": ms, "iters": it, "resid": res, "err_vs_p1_p2": err,
            "p1_p2_ms": t12, "p1_p2_iters": int(ref[1]),
            "p1_p2_resid": float(ref[2]), "capped": capped}
        log(f"   P6 {SIZE}² on {COL_N} x {COL_N} blocks, cold: {ms:.1f} ms "
            f"(CUDA events, its first solve: the workspace made), {it} "
            f"iterations, residual {res:.4g}; P1 + P2 {t12:.2f} ms, "
            f"{int(ref[1])}, {float(ref[2]):.4g}; p within {err:.3g} of "
            "scale" + (" (both at the cap)" if capped else ""))
        log(f"   nvidia-smi: {smi_line()}")
        shared["ic0"] = (cfg, b, a_diag, fl, p0)
    summaries["ic0_blocks"] = summary


# rainbow colour and the global marker layout on blocks (M12 part d)
CG_FRAMES = 2        # frames (timed after ROW_WARMUP on a copy) of the
#                      1024² rainbow and global frames on blocks
CG_SMALL_FRAMES = 3  # frames of the 40 x 100 runs, card vs CPU
# colours card vs CPU on the same blocks (the CPU tests' rainbow tolerance
# against the JAX package)
CG_COLOR_ATOL = 5e-3
# live marker positions card vs CPU (the CPU tests' tolerance)
CG_POS_ATOL = 1e-4
WATERFALL_GLOBAL_1024 = ["scenarios/waterfall.txt", "--size", "1024x1024",
                         "--no-pallas"]


def color_diff(a, b) -> float:
    """The largest difference of r, g and b between two states."""
    return max(float((getattr(a, c).cpu() - getattr(b, c).cpu()).abs().max())
               for c in ("r", "g", "b"))


def run_color_global_blocks(results, summaries, launches, dev,
                            shared) -> None:
    """Rainbow colour and the global marker layout on 2 x 2 ("y", "x")
    blocks (M12 part d), every block one thread of an in-process
    `comm.LocalGroup`: K7's extrapolated form and `advect_p` on the
    padded blocks at 1024²; the 1024² rainbow MG waterfall and dam break
    and the 1024² global dam break (f64 Jacobi) against 1 block; G1 and
    G2 as every block runs them; S1's global form on the blocks of the
    1024² global waterfall; filter.txt and waterfall.txt in the
    reference's configuration at 40 x 100, card against CPU."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.config import SimConfig, SolverConfig
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.advect import advect_p
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import global_marker_kernel as g12
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import source_kernel as s1
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.markers import source_pass_global
    from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo

    summary = {}
    n = COL_N
    nb = n * n
    cfg, scn, st, dt = (shared[k] for k in ("cfg", "scn", "st", "dt"))
    Yl, Xl = cfg.ny // n, cfg.nx // n
    cfg_b = dataclasses.replace(cfg, ny=Yl + 2 * H, nx=Xl + 2 * H)
    kw = [dict(clamp_ny=cfg.ny, row_offset=r * Yl - H, clamp_nx=cfg.nx,
               col_offset=c * Xl - H) for r in range(n) for c in range(n)]
    crop = (..., slice(H, H + Yl), slice(H, H + Xl))

    def k7_plain(c, p, at):
        uu, vv = k7.extrapolate_zero(c, *p, **at)
        return (*k7.advect_forces(c, uu, vv, p[2], p[4], dt, **at), uu, vv)

    with Phase(f"K7's extrapolated form and advect_p on {n} x {n} blocks "
               f"at {SIZE}² (padded with {H} rows and columns): each "
               "block's K7 bitwise its plain version, the cropped outputs "
               "bitwise the unsharded launch's; timed"):
        grid = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
        k7b = [[block_with_halo(a, n, r, H, n, c) for a in grid]
               for r in range(n) for c in range(n)]
        whole = k7.grid_stage(cfg, *grid, dt, extrapolated=True)
        call = lambda: [k7.grid_stage(  # noqa: E731
            cfg_b, *p, dt, extrapolated=True, **kw[k])
            for k, p in enumerate(k7b)]
        plain = lambda: [k7_plain(cfg_b, p, kw[k])  # noqa: E731
                         for k, p in enumerate(k7b)]
        outs = call()
        for k, (g, p) in enumerate(zip(outs, plain())):
            for a, w_, u_, name in zip(g, p, whole,
                                       ("ut", "vt", "uu", "vv")):
                check(torch.equal(a, w_), f"K7 (extrapolated) block {k}: "
                      f"{name} differs from its plain version")
                check(torch.equal(a[crop], u_[col_cut(k, Yl, Xl)]),
                      f"K7 (extrapolated) block {k}: {name} differs from "
                      "the unsharded K7")
        t_k, t_p, events = timed_pair(call, plain)
        dev_ms = min(device_ms(call, REPS) for _ in range(2))
        nbytes, flops = k7_blocks_bound(Yl, Xl, nb, True)
        results["K7r"] = {"ms": t_k, "plain_ms": t_p, "device_ms": dev_ms,
                          "max_abs_err": 0.0, "library_ms": None,
                          **bound_fields(nbytes + 8 * nb * Yl * Xl, flops)}
        log(f"   K7 (extrapolated: ut, vt, uu, vv) on {nb} blocks of "
            f"[{cfg_b.ny}, {cfg_b.nx}]: bitwise; device {dev_ms:.4f} ms "
            f"summed; {events}; bound {results['K7r']['bound_ms']:.4f} ms "
            f"by {results['K7r']['bound_by']}")
        # the colours: a seeded plane advected with K7's padded uu, vv
        gen = torch.Generator(device=dev).manual_seed(11)
        q = torch.rand((cfg.ny, cfg.nx), generator=gen, device=dev)
        want = advect_p(cfg, q, whole[2], whole[3], st.fluid, dt)
        for k, (o, p) in enumerate(zip(outs, k7b)):
            r, c = divmod(k, n)
            got = advect_p(cfg_b, block_with_halo(q, n, r, H, n, c), o[2],
                           o[3], p[2], dt, **kw[k])
            check(torch.equal(got[crop], want[col_cut(k, Yl, Xl)]),
                  f"advect_p block {k}: differs from the whole plane's")
        changed = int((want != q).sum())
        check(changed > 0, "advect_p moved no colour")
        log(f"   advect_p on the {nb} padded blocks: bitwise the whole "
            f"plane's ({changed} cells changed)")
        summary["k7_extrapolated"] = {"ms": t_k, "plain_ms": t_p,
                                      "device_ms": dev_ms}

    def blocks_vs_one(label, fcfg, fscn, fst, names, frames):
        """`frames` frames on n x n blocks and on 1 block, each timed
        after ROW_WARMUP frames on a copy of the start (the compared
        frames are the first `frames`: the fold order of P4 and P5 on
        blocks moves more cells apart the more frames run); checks every
        kernel of `names` launched once a block a timed substep and no
        plain version ran; returns (blocks' state, 1 block's, row)."""
        per = nb * fcfg.max_substeps * frames
        got, ms, got_l, plain = block_frames(fcfg, fscn, fst, n, dev,
                                             ROW_WARMUP, frames, x=n,
                                             rewind=True)
        check(plain == 0 and all(got_l.get(k) == per for k in names),
              f"{label} on {n} x {n} blocks: not one launch a block a "
              f"substep: {got_l}, plain calls {plain}")
        one, ms1, _, _ = block_frames(fcfg, fscn, fst, 1, dev, ROW_WARMUP,
                                      frames, rewind=True)
        for name in ("u", "v", "p", "r", "g", "b", "markers"):
            check(bool(torch.isfinite(getattr(got, name)).all()),
                  f"{label} on {n} x {n} blocks: {name} not finite")
        d = frame_diff(got, one)
        d.update(max_dcolor=color_diff(got, one), ms_per_frame=ms,
                 ms_per_frame_1_block=ms1, launches=got_l)
        log(f"   {label}: {n} x {n} blocks {ms:.1f} ms a frame, 1 block "
            f"{ms1:.1f}; launches {got_l}; {d['count_cells']} of "
            f"{d['cells']} cells' counts apart, max |du|, |dv| "
            f"{d['max_dv']:.3g}, max |dr|, |dg|, |db| "
            f"{d['max_dcolor']:.3g}; alive {d['alive']}")
        return got, one, d

    with Phase(f"the {SIZE}² rainbow MG waterfall and dam break on {n} x "
               f"{n} blocks (K1, S1, K7's extrapolated form, P5), "
               f"{CG_FRAMES} frames, against 1 block"):
        wcfg, wscn, wst = cli_state(WATERFALL_MG_1024 + ["--rainbow"])
        check(wcfg.rainbow and wcfg.solver.preconditioner == "mg",
              f"the CLI's rainbow waterfall: {wcfg}")
        dcfg = dataclasses.replace(main_config(SIZE), rainbow=True)
        dscn, dst = dam_break(dcfg, device=dev)
        # the waterfall's sources all lie in one block; the dam break's
        # fluid and colours cross the blocks' edges from its first frame
        for label, (fcfg, fscn, fst) in (
                ("rainbow waterfall", (wcfg, wscn, wst)),
                ("rainbow dam break", (dcfg, dscn, dst))):
            names = ("K1", "S1", "K7", "P5") if fscn.num_sources else (
                "K1", "K7", "P5")
            got, one, d = blocks_vs_one(label, fcfg, fscn, fst, names,
                                        CG_FRAMES)
            check(frames_agree(d) and d["max_dcolor"] <= CG_COLOR_ATOL
                  and not d["launches"].get("P4"),
                  f"{label}, {n} x {n} blocks vs 1: {d}")
            check(color_diff(got, fst) > 0.0,
                  f"{label}: the colours did not move")
            summary[label.replace(" ", "_") + "_1024"] = d
        launches["K7r"] = summary["rainbow_waterfall_1024"]["launches"].get(
            "K7", 0)
        del got, one, wscn, wst, dscn, dst

    with Phase(f"the {SIZE}² global dam break (f64 Jacobi, P4) on {n} x "
               f"{n} blocks (G1 + G2 on the gathered grid on every block), "
               f"{CG_FRAMES} frames, against 1 block; G1 and G2 as the "
               "blocks run them, timed"):
        gcfg = SimConfig(nx=SIZE, ny=SIZE,
                         solver=SolverConfig(dtype="float64"))
        gscn, gst = dam_break(gcfg, device=dev)
        got, one, d = blocks_vs_one("global dam break", gcfg, gscn, gst,
                                    ("G1", "G2", "K7", "P4"), CG_FRAMES)
        check(not d["launches"].get("K1") and not d["launches"].get("S1"),
              f"global dam break on blocks: {d['launches']}")
        for name in ("marker_count", "alive", "alive_count",
                     "dropped_markers", "rng"):
            check(torch.equal(getattr(got, name).to(torch.int64),
                              getattr(one, name).to(torch.int64)),
                  f"global dam break, {n} x {n} blocks vs 1: {name} "
                  "differs")
        live = one.alive
        dpos = float((got.markers[:, live] - one.markers[:, live]).abs()
                     .max())
        d.update(store_bitwise=bool(torch.equal(got.markers, one.markers)),
                 max_dpos=dpos)
        check(d["count_cells"] == 0 and d["store_bitwise"],
              f"global dam break, {n} x {n} blocks vs 1: {d}")
        log("   the store (bitwise), alive mask, counts, RNG: equal")
        summary["global_dam_break_1024"] = d

        # every block runs the whole grid's G1 and G2: one launch each
        # against its plain version on this state, then the device time
        # of the nb launches the blocks make against one launch's
        gdt = sim._dt_from_msq(gcfg, max_speed_sq(gcfg, one.u, one.v),
                               torch.full((), gcfg.frame_time, device=dev))
        check_g1(gcfg, gscn, one, gdt, f"{SIZE}², the blocks' state")
        marched, _ = g12.advect_global(gcfg, gscn, one, gdt)
        check_g2(gcfg, gscn, marched, one.alive, f"{SIZE}², the blocks' "
                 "state")
        for name, kern in (
                ("G1", lambda: g12.advect_global(gcfg, gscn, one, gdt)),
                ("G2", lambda: g12.refresh_global(gcfg, gscn, marched,
                                                  one.alive))):
            call = lambda kern=kern: [kern() for _ in range(nb)]  # noqa
            dev_b = min(device_ms(call, REPS) for _ in range(2))
            dev_1 = min(device_ms(kern, REPS) for _ in range(2))
            d[f"{name.lower()}_device_ms"] = {"blocks": dev_b,
                                              "one_launch": dev_1}
            log(f"   {name} as {nb} blocks run it (the whole grid's, "
                f"{int(one.alive_count)} live markers): device "
                f"{dev_b:.4f} ms the {nb} launches, one launch {dev_1:.4f} "
                f"({dev_b / dev_1:.2f}x)")
        del got, one, gscn, gst, marched

    with Phase(f"S1's global form on {n} x {n} blocks of the {SIZE}² "
               "global waterfall: every block's launch bitwise its plain "
               "version and the whole grid's launch on its cells; timed"):
        gwcfg, gwscn, gwst = cli_state(WATERFALL_GLOBAL_1024)
        check(gwcfg.marker_layout == "global", f"{gwcfg.marker_layout}")
        for _ in range(2):
            gwst = sim.step_frame(gwcfg, gwscn, gwst)
        ys = gwscn.source_yx[:, 0].long()
        xs = gwscn.source_yx[:, 1].long()
        counts = torch.where(gwscn.source_valid, gwst.marker_count[ys, xs],
                             0).to(torch.int32)
        act = torch.ones((), dtype=torch.bool, device=dev)
        wYl, wXl = gwcfg.ny // n, gwcfg.nx // n
        cuts = [col_cut(k, wYl, wXl) for k in range(nb)]
        bscn = [dataclasses.replace(
            gwscn, **{f: getattr(gwscn, f)[cut].contiguous()
                      for f in ("solid", "source", "sink")}) for cut in cuts]
        planes = ("marker_count", "r", "g", "b")

        def s1_blocks():
            return [gwst.replace(
                **{f: getattr(gwst, f)[cut].clone() for f in planes},
                **{f: getattr(gwst, f).clone() for f in
                   ("markers", "alive", "rng", "alive_count",
                    "source_exhausted")}) for cut in cuts]

        def s1_call(fn, blks):
            for k, blk in enumerate(blks):
                fn(gwcfg, bscn[k], blk, act, cuts[k][0].start, counts,
                   cuts[k][1].start)
            return blks

        whole_s1 = s1_copy(gwst)
        s1.emit_sources(gwcfg, gwscn, whole_s1, act)
        reset_counts()
        got = s1_call(s1.emit_sources, s1_blocks())
        check(_build.LAUNCHES["S1"] == nb and not _build.PLAIN_CALLS,
              f"S1 global on blocks: {dict(_build.LAUNCHES)}")
        want = s1_call(source_pass_global, s1_blocks())
        for k, (g_, w_) in enumerate(zip(got, want)):
            for f in S1_FIELDS:
                a_, b_ = getattr(g_, f), getattr(w_, f)
                full = getattr(whole_s1, f)
                if f in planes:
                    full = full[cuts[k]]
                for other, what in ((b_, "its plain version"),
                                    (full, "the whole grid's S1")):
                    check(torch.equal(a_.to(torch.int64),
                                      other.to(torch.int64))
                          if f == "rng" else torch.equal(a_, other),
                          f"S1 global block {k}: {f} differs from {what}")
        emitted = int(whole_s1.alive_count) - int(gwst.alive_count)
        check(emitted > 0, "S1 global on blocks: nothing emitted")
        k_blks, p_blks = s1_blocks(), s1_blocks()
        t_k, t_p, events = timed_pair(
            lambda: s1_call(s1.emit_sources, k_blks),
            lambda: s1_call(source_pass_global, p_blks), 1)
        results["S1g"] = {"ms": t_k, "plain_ms": t_p, "max_abs_err": 0.0,
                          "library_ms": None,
                          **bound_fields(*s1_blocks_bound(
                              gwscn.num_sources, emitted, nb))}
        log(f"   S1 global on {nb} blocks of the {SIZE}² waterfall "
            f"({gwscn.num_sources} sources, {emitted} emitted): bitwise its "
            f"plain version and the whole grid's S1 on its cells; {events} "
            f"the {nb} launches; bound {results['S1g']['bound_ms']:.3g} ms")
        del gwscn, gwst, whole_s1, got, want, k_blks, p_blks
        torch.cuda.empty_cache()

    with Phase(f"filter.txt and waterfall.txt in the reference's "
               f"configuration (global, rainbow, --no-pallas) at 40 x 100 "
               f"on {n} x {n} blocks of 20 x 50, {CG_SMALL_FRAMES} frames: "
               "card (kernels) vs CPU (plain versions) on the same blocks"):
        s1_launches = 0
        for name in ("filter", "waterfall"):
            argv = [f"scenarios/{name}.txt", "--no-pallas", "--rainbow"]
            fcfg, fscn, fst = cli_state(argv)
            check(fcfg.marker_layout == "global" and fcfg.rainbow,
                  f"{name}: {fcfg}")
            cscn, cst = to_cpu(fscn, fst)
            got, _, got_l, plain = block_frames(fcfg, fscn, fst, n, dev, 0,
                                                CG_SMALL_FRAMES, x=n)
            want, _, _, _ = block_frames(fcfg, cscn, cst, n, "cpu", 0,
                                         CG_SMALL_FRAMES, x=n)
            names = ("G1", "G2", "K7", "P4") + (
                ("S1",) if fscn.num_sources else ())
            check(plain == 0 and all(got_l.get(k, 0) > 0 for k in names),
                  f"{name} 40 x 100 on blocks: launches {got_l}, plain "
                  f"calls {plain}")
            for f in ("marker_count", "alive", "alive_count",
                      "dropped_markers", "rng"):
                check(torch.equal(getattr(got, f).cpu().to(torch.int64),
                                  getattr(want, f).to(torch.int64)),
                      f"{name} 40 x 100 on blocks: {f} differs card vs "
                      "CPU")
            dv = max(float((got.u.cpu() - want.u).abs().max()),
                     float((got.v.cpu() - want.v).abs().max()))
            dc = color_diff(got, want)
            live = want.alive
            dpos = float((got.markers.cpu()[:, live]
                          - want.markers[:, live]).abs().max())
            log(f"   {name}: counts, alive, store order, drops, RNG bitwise "
                f"card vs CPU; max |du|, |dv| {dv:.3g} (atol "
                f"{ROW_SMALL_ATOL}), max |dr|, |dg|, |db| {dc:.3g} (atol "
                f"{CG_COLOR_ATOL}), live positions {dpos:.3g} (atol "
                f"{CG_POS_ATOL}); alive_count {int(want.alive_count)}; "
                f"launches {got_l}")
            check(dv <= ROW_SMALL_ATOL and dc <= CG_COLOR_ATOL
                  and dpos <= CG_POS_ATOL,
                  f"{name} 40 x 100 on blocks, card vs CPU: |dv| {dv:.3g}, "
                  f"|dc| {dc:.3g}, |dpos| {dpos:.3g}")
            summary[f"{name}_40x100"] = {"max_dv": dv, "max_dcolor": dc,
                                         "max_dpos": dpos,
                                         "launches": got_l}
            s1_launches += got_l.get("S1", 0)
        launches["S1g"] = s1_launches
        log(f"   nvidia-smi: {smi_line()}")
    summaries["color_global_blocks"] = summary


# MG on blocks of an odd side (M12 part d): P5 gathering at level 0 and
# P4's block MG on a padded level 0, with the CLI's 1080 x 1920 MG
# waterfall on 8 row blocks of 135 rows (K1, K7, S1 at odd row offsets)
ODD_N = 8           # row blocks of 1080 x 1920
ODD_GRID = 999      # an odd grid (level 0 stored as 1000²), on 3 x 3 blocks
ODD_GRID_N = 3
ODD_DEVELOP = 3     # frames of each state before its checks
ODD_WARMUP, ODD_TIMED = 1, 2  # frames of the waterfall on blocks
WATERFALL_MG_1080 = ["scenarios/waterfall.txt", "--size", "1080x1920"]
DAM_BREAK_1080 = ["preset:dam_break", "--size", "1080x1920"]


def developed(cfg, scn, st, frames: int = ODD_DEVELOP):
    from euler_tpu_torch import sim

    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    return st


def p5_bytes(cfg, g, inputs) -> int:
    """The bytes of the P5 workspaces the blocks of `g` hold for `cfg`'s
    plan (at gather level 0 each holds the whole grid's hierarchy)."""
    from euler_tpu_torch.ops.cuda import pcg_mg_blocks_kernel as p5
    from euler_tpu_torch.parallel import spatial_mg

    def rank(comm):
        axes = ("y", "x") if comm.size("x") > 1 else ("y",)
        plan = spatial_mg.block_plan(cfg, comm, axes)
        return p5.workspace(cfg, comm, plan, inputs[comm.r][0].device).nbytes

    return sum(g.run(rank))


def run_odd_blocks(results, summaries, launches, dev, shared) -> None:
    """MG on blocks with an odd side on the card (M12 part d), every block
    one thread of an in-process `comm.LocalGroup`: P5 gathering at level
    0 (the whole grid's hierarchy on every block) against P3 on the CLI's
    1080 x 1920 waterfall system on 8 row blocks and on a 999² dam-break
    system on 3 x 3 blocks, and forced to gather at level 0 on the 1024²
    system against the default plan; P4's block MG on the 8 row blocks
    (each block's level 0 padded) against its plain version; K1, K7 and
    S1 at the 8 blocks' odd row offsets against the unsharded launch; and
    the 1080 x 1920 MG waterfall on the 8 blocks against 1 block.  Puts
    the 1080 x 1920 system into `shared` for the profiles."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.parallel.cuda_shard import H

    summary = {}
    wcfg, wscn, wst = cli_state(WATERFALL_MG_1080)
    check(wcfg.solver.preconditioner == "mg" and wcfg.solver.warm_start
          and (wcfg.ny, wcfg.nx) == (1080, 1920),
          f"the CLI's 1080 x 1920 waterfall solves with {wcfg.solver}")
    wst = developed(wcfg, wscn, wst)
    ocfg = main_config(ODD_GRID)
    oscn, ost = dam_break(ocfg, device=dev)
    ost = developed(ocfg, oscn, ost)
    with Phase(f"P5 gathering at level 0: the 1080 x 1920 waterfall system "
               f"on {ODD_N} x 1 blocks of 135 rows and the {ODD_GRID}² dam "
               f"break system on {ODD_GRID_N} x {ODD_GRID_N} blocks against "
               "P3 (hierarchy, rows and a cycle bitwise, p within 5e-4 of "
               "scale, iterations equal / within 1), cold and warm; the "
               f"{SIZE}² system on 2 x 2 blocks forced to gather at level 0 "
               "bitwise the default plan"):
        cases = (("1080x1920", wcfg, wscn, wst, ODD_N, 1, 0),
                 (f"{ODD_GRID}x{ODD_GRID}", ocfg, oscn, ost, ODD_GRID_N,
                  ODD_GRID_N, 1))
        for label, c, scn_, st_, y, x, it_tol in cases:
            _, _, _, b, a_diag = substep_system(c, scn_, st_)
            fl = st_.fluid
            p0 = torch.where(fl, st_.p, 0.0)
            if label == "1080x1920":
                shared["odd"] = {"cfg": c, "b": b, "a_diag": a_diag,
                                 "fl": fl, "p0": p0}
            for start, x0 in (("cold", None), ("warm", p0)):
                ref = p13.solve_pressure_general(c, b, a_diag, fl, x0=x0)
                t3 = cuda_ms(lambda: p13.solve_pressure_general(
                    c, b, a_diag, fl, x0=x0), REPS)
                scale = float(ref[0].abs().max())
                g, inputs = p5_group(c, b, a_diag, fl, x0, y, x, dev)
                with g:
                    reset_counts()
                    out = p5_solve(c, g, inputs)
                    check(_build.LAUNCHES["P5"] == y * x
                          and not _build.PLAIN_CALLS,
                          f"P5 {label} on {y} x {x}: launches "
                          f"{dict(_build.LAUNCHES)}, plain "
                          f"{dict(_build.PLAIN_CALLS)}")
                    check(len({(int(o[1]), float(o[2])) for o in out}) == 1,
                          f"P5 {label} on {y} x {x}: the blocks' iterations "
                          "or residuals differ")
                    p = together([o[0] for o in out], x)
                    it, res = int(out[0][1]), float(out[0][2])
                    err = float((p - ref[0]).abs().max()) / scale
                    check(abs(it - int(ref[1])) <= it_tol and err <= 5e-4,
                          f"P5 {label} on {y} x {x} {start}: {it} "
                          f"iterations (P3 {int(ref[1])}), p {err:.3g} of "
                          "scale from P3's")
                    ms = cuda_ms(lambda: p5_solve(c, g, inputs), GMG_REPS)
                    row = {"ms": ms, "iters": it, "resid": res,
                           "err_vs_p3": err, "p3_ms": t3,
                           "p3_iters": int(ref[1])}
                    if start == "warm":
                        # P3's workspace holds its last solve's hierarchy:
                        # this system's
                        ws3 = p13.workspace(c, dev)
                        Y0, X0 = ws3.shapes[0]
                        z3 = ws3.cycle(torch.nn.functional.pad(
                            b, (0, X0 - c.nx, 0, Y0 - c.ny)),
                            per_op=False)[:c.ny, :c.nx]
                        gather = check_p5_hierarchy(c, g, inputs, ws3, z3,
                                                    f"{label} on {y} x {x}")
                        check(gather == 0, f"P5 {label} on {y} x {x}: "
                              f"gather level {gather}, not 0")
                        row.update(workspace_bytes=p5_bytes(c, g, inputs),
                                   p3_workspace_bytes=ws3.nbytes)
                        log(f"   P5 {label}: the {y * x} blocks' workspaces "
                            f"{row['workspace_bytes']} bytes (P3's "
                            f"{ws3.nbytes})")
                    if label == "1080x1920" and start == "warm":
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        q = p5_solve(c, g, inputs, plain=True)
                        torch.cuda.synchronize()
                        ms_q = 1e3 * (time.perf_counter() - t0)
                        kerr = float((p - together([o[0] for o in q], x))
                                     .abs().max())
                        check(abs(it - int(q[0][1])) <= 1
                              and kerr <= 5e-4 * scale,
                              f"P5 {label} vs plain: {it} vs {int(q[0][1])} "
                              f"iterations, p {kerr:.3g} apart")
                        row["plain"] = {"ms": ms_q, "iters": int(q[0][1]),
                                        "max_abs_err": kerr}
                        results["P5o"] = {
                            "ms": ms, "plain_ms": ms_q, "max_abs_err": kerr,
                            "library_ms": None,
                            **bound_fields(*BOUNDS["P5"](c.ny * c.nx, it,
                                                         0))}
                        log(f"   P5 {label} plain version (warm): "
                            f"{ms_q:.1f} ms, {int(q[0][1])} iterations, p "
                            f"{kerr:.3g} from P5; bound "
                            f"{results['P5o']['bound_ms']:.4f} ms by "
                            f"{results['P5o']['bound_by']} (P3's work)")
                summary[f"p5_{label}_{y}x{x}_{start}"] = row
                log(f"   P5 {label} on {y} x {x} {start}: {ms:.2f} ms a "
                    f"solve (P3 {t3:.3f}), {it} iterations (P3 "
                    f"{int(ref[1])}), p within {err:.3g} of P3's scale")

        c = shared["configs"]["mg"]
        b, a_diag, fl = shared["b"], shared["a_diag"], shared["fl"]
        p0 = torch.where(fl, shared["st"].p, 0.0)
        ref = p13.solve_pressure_general(c, b, a_diag, fl, x0=p0)
        ws3 = p13.workspace(c, dev)
        z3 = ws3.cycle(b, per_op=False)
        g, inputs = p5_group(c, b, a_diag, fl, p0, COL_N, COL_N, dev)
        with g:
            want = p5_solve(c, g, inputs)
            check_p5_hierarchy(c, g, inputs, ws3, z3, f"{SIZE}² on 2 x 2, "
                               "the default plan")
            reset_counts()
            got = p5_solve(c, g, inputs, gather=0)
            check(_build.LAUNCHES["P5"] == COL_N * COL_N
                  and not _build.PLAIN_CALLS,
                  f"P5 gathering at 0: launches {dict(_build.LAUNCHES)}")
            check(all(torch.equal(a_[0], w_[0]) and int(a_[1]) == int(w_[1])
                      and float(a_[2]) == float(w_[2])
                      for a_, w_ in zip(got, want)),
                  f"P5 {SIZE}² on 2 x 2 gathering at 0: not the default "
                  f"plan's bits ({int(got[0][1])} vs {int(want[0][1])} "
                  "iterations)")
            gather = check_p5_hierarchy(c, g, inputs, ws3, z3,
                                        f"{SIZE}² on 2 x 2, gathering at 0",
                                        gather=0)
            check(gather == 0, f"the forced plan gathers at {gather}")
            ms0 = cuda_ms(lambda: p5_solve(c, g, inputs, gather=0), GMG_REPS)
            ms = cuda_ms(lambda: p5_solve(c, g, inputs), GMG_REPS)
        summary[f"p5_{SIZE}_2x2_gather_0"] = {
            "ms": ms0, "ms_default_plan": ms, "iters": int(got[0][1]),
            "p3_iters": int(ref[1])}
        log(f"   P5 {SIZE}² on 2 x 2 gathering at 0: p, iterations "
            f"({int(got[0][1])}) and residual bitwise the default plan's; "
            f"{ms0:.2f} ms a solve against {ms:.2f}")
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"P4's block MG on {ODD_N} row blocks of the 1080 x 1920 "
               "waterfall system (each block's level 0 padded to 136 rows) "
               "against its plain version on the same card tensors"):
        c, b, a_diag, fl = (shared["odd"][k] for k in
                            ("cfg", "b", "a_diag", "fl"))
        reset_counts()
        p, it, res, ms = block_solve(c, b, a_diag, fl, ODD_N, dev)
        got_l = dict(_build.LAUNCHES)
        check(got_l.get("P4") == 2 * ODD_N and not _build.PLAIN_CALLS,
              f"P4 on {ODD_N} blocks: launches {got_l}, plain "
              f"{dict(_build.PLAIN_CALLS)}")
        q, it_q, res_q, ms_q = block_solve(c, b, a_diag, fl, ODD_N, dev,
                                           plain=True)
        scale = float(q.abs().max())
        kerr = float((p - q).abs().max())
        tol = max(c.solver.tol, c.solver.tol_rel * float(b.abs().max()))
        check(abs(it - it_q) <= 1 and kerr <= 1e-4 * scale and res <= tol,
              f"P4 block MG on {ODD_N} blocks vs plain: {it} vs {it_q} "
              f"iterations, p {kerr:.3g} apart (scale {scale:.3g}), resid "
              f"{res:.3g} (tol {tol:.3g})")
        launches["P4o"] = got_l["P4"]
        results["P4o"] = {"ms": ms, "plain_ms": ms_q, "max_abs_err": kerr,
                          "library_ms": None,
                          **bound_fields(*BOUNDS["P4o"](c.ny * c.nx, it,
                                                        0))}
        summary["p4_block_mg"] = {"ms": ms, "iters": it, "resid": res,
                                  "plain": {"ms": ms_q, "iters": it_q,
                                            "max_abs_err": kerr}}
        log(f"   P4 block MG, {ODD_N} blocks: {ms:.2f} ms a solve, {it} "
            f"iterations; plain {ms_q:.1f} ms, {it_q}; p {kerr:.3g} apart "
            f"({kerr / scale:.3g} of scale); bound "
            f"{results['P4o']['bound_ms']:.4f} ms by "
            f"{results['P4o']['bound_by']}")

    with Phase(f"K1, K7 and S1 on {ODD_N} row blocks of 1080 x 1920 (row "
               "offsets 127, 262, ...): each block's launch bitwise its "
               "plain version, the kept rows bitwise the unsharded launch; "
               "timed"):
        dcfg, dscn, dst = cli_state(DAM_BREAK_1080)
        dst = developed(dcfg, dscn, dst)
        Y, X, K = dcfg.ny, dcfg.nx, dcfg.slots_per_cell
        Yl = Y // ODD_N
        dt = sim._dt_from_msq(dcfg, max_speed_sq(dcfg, dst.u, dst.v),
                              torch.full((), dcfg.frame_time, device=dev))
        planes = (dst.u, dst.v, dst.fluid, dscn.solid,
                  dst.markers.reshape(2 * K, Y, X), dst.marker_count,
                  dscn.sink | dscn.solid)
        blocks = k1_blocks(dcfg, planes, ODD_N)
        offsets = [kw["row_offset"] for _, _, kw in blocks]
        whole = k1.march_rebin(dcfg, *planes[:5], dt, planes[5],
                               dead=planes[6])
        call = lambda: k1_shard_call(blocks, dt, k1.march_rebin)  # noqa: E731
        plain = lambda: k1_shard_call(  # noqa: E731
            blocks, dt, k1.march_rebin_plain)
        for r, (g_, p_) in enumerate(zip(call(), plain())):
            for a_, w_, u_, name in zip(g_, p_, whole,
                                        ("slots", "count", "drop")):
                check(torch.equal(a_, w_), f"K1 block {r}: {name} differs "
                      "from its plain version")
                check(torch.equal(a_[..., H:H + Yl, :],
                                  u_[..., r * Yl:(r + 1) * Yl, :]),
                      f"K1 block {r}: {name} differs from the unsharded K1")
        t_k, t_p, events = timed_pair(call, plain, 2)
        dev_ms = min(device_ms(call, REPS) for _ in range(2))
        one_ms = min(device_ms(lambda: k1.march_rebin(
            dcfg, *planes[:5], dt, planes[5], dead=planes[6]), REPS)
            for _ in range(2))
        count = planes[5]
        live = sum(int(count[max(r * Yl - 1, 0):(r + 1) * Yl + 1].sum())
                   for r in range(ODD_N))
        results["K1o"] = {"ms": t_k, "plain_ms": t_p, "device_ms": dev_ms,
                          "max_abs_err": 0.0, "library_ms": None,
                          **bound_fields(*k1_blocks_bound(
                              Yl, X, live, ODD_N, K, split=False))}
        summary["k1"] = {"device_ms": dev_ms, "device_ms_one_launch": one_ms,
                         "row_offsets": offsets, "live": int(count.sum())}
        log(f"   K1 on {ODD_N} blocks of [{2 * K}, {Yl + 2 * H}, {X}] "
            f"(row offsets {offsets}): bitwise; device {dev_ms:.4f} ms "
            f"summed against {one_ms:.4f} for one launch; {events}; bound "
            f"{results['K1o']['bound_ms']:.4f} ms by "
            f"{results['K1o']['bound_by']} ({int(count.sum())} live "
            "markers)")

        grid = (dst.u, dst.v, dst.fluid, dst.prev_fluid, dscn.solid)
        results["K7o"] = k7_row_blocks(dcfg, grid, dt, ODD_N,
                                       "the 1080 x 1920 dam break")
        results["S1o"] = s1_row_blocks(wcfg, wscn, wst, ODD_N, dev,
                                       "the 1080 x 1920 waterfall")
        log(f"   nvidia-smi: {smi_line()}")

    with Phase(f"the 1080 x 1920 MG waterfall on {ODD_N} row blocks (P5 "
               f"gathering at level 0) against 1 block: {ODD_WARMUP} "
               f"warm-up frame on a copy, {ODD_TIMED} timed; K1, S1, K7, P5 "
               "once a block a substep, no plain version"):
        got, ms, got_l, plain = block_frames(wcfg, wscn, wst, ODD_N, dev,
                                             ODD_WARMUP, ODD_TIMED,
                                             rewind=True)
        per = ODD_N * wcfg.max_substeps * ODD_TIMED
        names = ("K1", "S1", "K7", "P5")
        check(plain == 0 and all(got_l.get(k) == per for k in names)
              and not got_l.get("P4"),
              f"MG waterfall on {ODD_N} blocks: not one launch a block a "
              f"substep: {got_l}, plain {plain}")
        for k in names:
            launches[f"{k}o"] = got_l[k]
        one, ms1, _, _ = block_frames(wcfg, wscn, wst, 1, dev, ODD_WARMUP,
                                      ODD_TIMED, rewind=True)
        for name in ("u", "v", "p", "markers"):
            check(bool(torch.isfinite(getattr(got, name)).all()),
                  f"MG waterfall on {ODD_N} blocks: {name} not finite")
        d = frame_diff(got, one)
        check(frames_agree(d), f"MG waterfall, {ODD_N} blocks vs 1: {d}")
        summary["waterfall_1080"] = {
            "ms_per_frame": ms, "ms_per_frame_1_block": ms1,
            "launches": got_l, "vs_1_block": d,
            "div_inf": div_inf(wcfg, got, exclude=wscn.source)}
        log(f"   {ODD_N} blocks {ms:.1f} ms a frame, 1 block {ms1:.1f}; "
            f"{d['count_cells']} of {d['cells']} cells' counts apart, max "
            f"|dv| {d['max_dv']:.3g}; alive {d['alive']}; div_inf off the "
            f"sources {summary['waterfall_1080']['div_inf']:.4g}")
        log(f"   nvidia-smi: {smi_line()}")
    summaries["odd_blocks"] = summary


# f64 MG on blocks (M15 part b): P5 and P4's block MG in double precision
# on the f64 systems of `run_f64_mg` (its 1024² dam break and 1080 x 1920
# waterfall), each layout's gather level as `spatial_mg.block_plan` gives
# it: the 1024² system on 1 x 1 (G 4) and 2 x 2 (G 4: 128² on the blocks
# too, a level lower than f32's 3), the 1080 x 1920 system on 1 x 1 (G 3)
# and 8 x 1 (G 0, blocks of 135 rows)
F64_BLOCK_LAYOUTS = {"f64_dam_break_1024": ((1, 1), (COL_N, COL_N)),
                     "f64_waterfall_1080p": ((1, 1), (ODD_N, 1))}
# P4's block MG: the layout of each system it is held to its plain loop on
F64_P4_LAYOUTS = {"f64_waterfall_1080p": (ODD_N, 1),
                  "f64_dam_break_1024": (COL_N, COL_N)}
# the frames on blocks: each f64 CLI run's layout against 1 block
F64_BLOCK_FRAMES = {"f64_waterfall_1080p": (WATERFALL_MG_1080, ODD_N, 1),
                    "f64_dam_break_1024": (CLI_RUNS["cli_dam_break_1024"][0],
                                           COL_N, COL_N)}
F64_BLOCK_REPS = 2   # timed solves a layout (host-bound, 0.1-1 s each)
F64_BLOCK_RTOL = 1e-10  # p of P5-f64 / P4-f64 against P3-f64 / plain


def in_f32(cfg, *planes):
    """`cfg` with its solve in f32 and the floating planes rounded to f32
    (the f32 layout's solve of the same system)."""
    import torch

    c = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype="float32"))
    return (c, *(t.float() if t is not None and t.is_floating_point()
                 else t for t in planes))


def p5_plan(cfg, dev, comm):
    """This block's gather level and its P5 workspace's coarse-cycle plan
    (`BlocksWorkspace.cycle_plan`), for `comm.LocalGroup.run`."""
    from euler_tpu_torch.ops.cuda import pcg_mg_blocks_kernel as p5
    from euler_tpu_torch.parallel import spatial_mg

    axes = ("y", "x") if comm.size("x") > 1 else ("y",)
    plan = spatial_mg.block_plan(cfg, comm, axes)
    return plan.gather, p5.workspace(cfg, comm, plan, dev).cycle_plan()


def p4_bytes(cfg, y, x, dev) -> int:
    """The bytes of the P4 workspaces that y x x blocks of `cfg`'s grid
    hold for its solver (`ShardWorkspace.nbytes`)."""
    from euler_tpu_torch.ops.cuda import pcg_shard_kernel as p4
    from euler_tpu_torch.parallel.comm import LocalGroup

    shape = (cfg.ny // y, cfg.nx // x)
    with LocalGroup(y, x, device=dev) as g:
        return sum(g.run(lambda comm: p4.workspace(cfg, comm, shape,
                                                   dev).nbytes))


def run_f64_blocks(results, summaries, launches, dev, systems) -> dict:
    """f64 MG on blocks (M15 part b), every block one thread of an
    in-process `comm.LocalGroup`: P5-f64 against P3-f64 on `systems`
    (`run_f64_mg`'s f64 systems) on the layouts of F64_BLOCK_LAYOUTS, cold
    and warm (1 x 1 and gather level 0: P3-f64's hierarchy, rows,
    iterations and p bit for bit; elsewhere its hierarchy, rows and cycle
    bitwise, its iterations, p within F64_BLOCK_RTOL of scale), against
    its plain version on the same card tensors, each layout's gather
    level and coarse-cycle plan against P3-f64's, timed beside P3-f64 and
    P5 on the f32 layout (the same system rounded to f32), with the
    blocks' workspace bytes and the peak; P4's block MG in f64 against
    its plain loop; then the f64 CLI runs' frames on blocks against 1
    block.  Returns what `f64_block_profiles` profiles."""
    import torch

    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13

    summary, profiled = {}, {}
    with Phase("P5-f64 against P3-f64 on the f64 1024² dam break system "
               f"(1 x 1, {COL_N} x {COL_N}) and 1080 x 1920 waterfall system "
               f"(1 x 1, {ODD_N} x 1, gathering at level 0), cold and warm: "
               "1 x 1 and G = 0 bitwise P3-f64, elsewhere its hierarchy, "
               f"rows and cycle bitwise, its iterations, p within "
               f"{F64_BLOCK_RTOL:g} of scale; the plain P5-f64 once a "
               "system; plans, bytes, timed beside P3-f64 and f32"):
        err_max = 0.0
        for label, layouts in F64_BLOCK_LAYOUTS.items():
            c, b, a_diag, fl, p0 = systems[label]
            check(c.solver.dtype == "float64" and b.dtype == torch.float64,
                  f"{label}: not an f64 system")
            tag = f"{c.ny}x{c.nx}"
            c32, b32, p032 = in_f32(c, b, p0)
            ws3 = p13.workspace(c, dev)
            p3_plan = ws3.plan()
            for x0, start in ((None, "cold"), (p0, "warm")):
                ref = p13.solve_pressure_general(c, b, a_diag, fl, x0=x0)
                t3 = cuda_ms(lambda: p13.solve_pressure_general(
                    c, b, a_diag, fl, x0=x0), REPS)
                scale = float(ref[0].abs().max())
                if start == "warm":
                    # P3-f64's workspace holds this system's hierarchy
                    Y0, X0 = ws3.shapes[0]
                    z3 = ws3.cycle(torch.nn.functional.pad(
                        b, (0, X0 - c.nx, 0, Y0 - c.ny)),
                        per_op=False)[:c.ny, :c.nx]
                for y, x in layouts:
                    where = f"P5-f64 {tag} on {y} x {x} {start}"
                    g, inputs = p5_group(c, b, a_diag, fl, x0, y, x, dev)
                    with g:
                        held = reset_peak()
                        reset_counts()
                        out = p5_solve(c, g, inputs)
                        check(_build.LAUNCHES["P5"] == y * x
                              and not _build.PLAIN_CALLS,
                              f"{where}: launches {dict(_build.LAUNCHES)}, "
                              f"plain {dict(_build.PLAIN_CALLS)}")
                        check(len({(int(o[1]), float(o[2]))
                                   for o in out}) == 1,
                              f"{where}: the blocks' iterations or "
                              "residuals differ")
                        p = together([o[0] for o in out], x)
                        it, res = int(out[0][1]), float(out[0][2])
                        err = float((p - ref[0]).abs().max()) / scale
                        gather, plan = g.run(functools.partial(
                            p5_plan, c, dev))[0]
                        bitwise = (y, x) == (1, 1) or gather == 0
                        check(p.dtype == torch.float64, f"{where}: p is "
                              f"{p.dtype}")
                        if bitwise:
                            check(torch.equal(p, ref[0])
                                  and it == int(ref[1])
                                  and res == float(ref[2]),
                                  f"{where}: not P3-f64's bits ({it} vs "
                                  f"{int(ref[1])} iterations, p {err:.3g} "
                                  "of scale)")
                        else:
                            check(it == int(ref[1])
                                  and err <= F64_BLOCK_RTOL,
                                  f"{where}: {it} iterations (P3-f64 "
                                  f"{int(ref[1])}), p {err:.3g} of scale")
                            err_max = max(err_max, err)
                        check(plan["fused"] == p3_plan["fused"]
                              and plan["smem"] == p3_plan["smem"]
                              and plan["gather"] == gather
                              and gather <= plan["fused"],
                              f"{where}: gather level {gather}, coarse "
                              f"cycle {plan}, P3-f64's {p3_plan}")
                        ms = cuda_ms(lambda: p5_solve(c, g, inputs),
                                     F64_BLOCK_REPS)
                        row = {"ms": ms, "iters": it, "resid": res,
                               "err_vs_p3": err, "p3_ms": t3,
                               "p3_iters": int(ref[1]), "gather": gather,
                               "fused": plan["fused"],
                               "fused_smem": plan["smem"]}
                        if start == "warm":
                            check_p5_hierarchy(c, g, inputs, ws3, z3,
                                               f"f64 {tag} on {y} x {x}")
                            row.update(workspace_bytes=p5_bytes(c, g,
                                                                inputs),
                                       p3_workspace_bytes=ws3.nbytes)
                            record_peak(row, held)
                        if start == "warm" and (y, x) != (1, 1):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            q = p5_solve(c, g, inputs, plain=True)
                            torch.cuda.synchronize()
                            ms_q = 1e3 * (time.perf_counter() - t0)
                            kerr = float((p - together([o[0] for o in q], x))
                                         .abs().max())
                            check(it == int(q[0][1])
                                  and kerr <= F64_BLOCK_RTOL * scale,
                                  f"{where} vs plain: {it} vs "
                                  f"{int(q[0][1])} iterations, p "
                                  f"{kerr:.3g} apart")
                            row["plain"] = {"ms": ms_q,
                                            "iters": int(q[0][1]),
                                            "max_abs_err": kerr}
                            log(f"   {where} plain version: {ms_q:.1f} ms, "
                                f"{int(q[0][1])} iterations, p {kerr:.3g} "
                                "from P5-f64")
                            if (y, x) == (ODD_N, 1):
                                results["P5_f64"] = {
                                    "ms": ms, "plain_ms": ms_q,
                                    "max_abs_err": kerr, "library_ms": None,
                                    **bound_fields(*BOUNDS["P5_f64"](
                                        c.ny * c.nx, it, 0),
                                        FLOP_RATES["P5_f64"])}
                                profiled["p5"] = (label, y, x)
                    if start == "warm":
                        # the f32 layout: P5 on the same system in f32
                        g32, in32 = p5_group(c32, b32, a_diag, fl, p032, y,
                                             x, dev)
                        with g32:
                            o32 = p5_solve(c32, g32, in32)
                            row.update(
                                f32_ms=cuda_ms(lambda: p5_solve(
                                    c32, g32, in32), F64_BLOCK_REPS),
                                f32_iters=int(o32[0][1]),
                                f32_workspace_bytes=p5_bytes(c32, g32,
                                                             in32))
                        log(f"   {where}: the blocks' workspaces "
                            f"{row['workspace_bytes']} bytes (P3-f64's "
                            f"{row['p3_workspace_bytes']}, the f32 "
                            f"layout's {row['f32_workspace_bytes']}); f32 "
                            f"layout {row['f32_ms']:.2f} ms, "
                            f"{row['f32_iters']} iterations")
                    summary[f"p5_{tag}_{y}x{x}_{start}"] = row
                    agree = ("bitwise" if bitwise
                             else f"within {err:.3g} of scale")
                    log(f"   {where}: {ms:.2f} ms a solve (P3-f64 "
                        f"{t3:.3f}), {it} iterations (P3-f64 "
                        f"{int(ref[1])}), p {agree}; gather level "
                        f"{gather}, coarse cycle from level "
                        f"{plan['fused']} ({plan['smem']} bytes; P3-f64 "
                        f"{p3_plan['fused']})")
        summary["max_err_vs_p3"] = err_max
        log(f"   nvidia-smi: {smi_line()}")

    with Phase("P4's block MG in f64 on "
               + " and ".join(f"{y} x {x} blocks of the {systems[k][0].ny}"
                              f" x {systems[k][0].nx} f64 system"
                              for k, (y, x) in F64_P4_LAYOUTS.items())
               + " against its plain loop on the same card tensors (the "
               f"same iterations, p within {F64_BLOCK_RTOL:g} of scale), "
               "timed beside the f32 layout"):
        for label, (y, x) in F64_P4_LAYOUTS.items():
            c, b, a_diag, fl, _ = systems[label]
            tag = f"{c.ny}x{c.nx}"
            reset_counts()
            p, it, res, ms = block_solve(c, b, a_diag, fl, y, dev, x=x)
            got_l = dict(_build.LAUNCHES)
            check(got_l.get("P4") == 2 * y * x and not _build.PLAIN_CALLS,
                  f"P4-f64 on {y} x {x}: launches {got_l}, plain "
                  f"{dict(_build.PLAIN_CALLS)}")
            q, it_q, _, ms_q = block_solve(c, b, a_diag, fl, y, dev,
                                           plain=True, x=x)
            scale = float(q.abs().max())
            kerr = float((p - q).abs().max())
            tol = max(c.solver.tol, c.solver.tol_rel * float(b.abs().max()))
            check(p.dtype == torch.float64 and it == it_q
                  and kerr <= F64_BLOCK_RTOL * scale and res <= tol,
                  f"P4-f64 block MG {tag} on {y} x {x} vs plain: {it} vs "
                  f"{it_q} iterations, p {kerr:.3g} apart (scale "
                  f"{scale:.3g}), resid {res:.3g} (tol {tol:.3g})")
            c32, b32 = in_f32(c, b)
            _, it32, _, ms32 = block_solve(c32, b32, a_diag, fl, y, dev,
                                           x=x)
            row = {"ms": ms, "iters": it, "resid": res, "f32_ms": ms32,
                   "f32_iters": it32,
                   "workspace_bytes": p4_bytes(c, y, x, dev),
                   "f32_workspace_bytes": p4_bytes(c32, y, x, dev),
                   "p3_workspace_bytes": p13.workspace(c, dev).nbytes,
                   "plain": {"ms": ms_q, "iters": it_q,
                             "max_abs_err": kerr}}
            summary[f"p4_block_mg_{tag}_{y}x{x}"] = row
            if (y, x) == (ODD_N, 1):
                launches["P4_f64"] = got_l["P4"]
                results["P4_f64"] = {
                    "ms": ms, "plain_ms": ms_q, "max_abs_err": kerr,
                    "library_ms": None,
                    **bound_fields(*BOUNDS["P4_f64"](c.ny * c.nx, it, 0),
                                   FLOP_RATES["P4_f64"])}
                profiled["p4"] = (label, y, x)
            log(f"   P4-f64 block MG {tag}, {y} x {x} blocks: {ms:.2f} ms "
                f"a cold solve, {it} iterations; plain {ms_q:.1f} ms, "
                f"{it_q}; p {kerr:.3g} apart ({kerr / scale:.3g} of "
                f"scale); f32 layout {ms32:.2f} ms, {it32} iterations; "
                f"the blocks' workspaces {row['workspace_bytes']} bytes "
                f"(f32 layout {row['f32_workspace_bytes']}, P3-f64 "
                f"{row['p3_workspace_bytes']})")
        log(f"   nvidia-smi: {smi_line()}")

    with Phase("the f64 MG frames on blocks: "
               + " and ".join(f"{k} on {y} x {x}" for k, (_, y, x)
                              in F64_BLOCK_FRAMES.items())
               + f", {ODD_WARMUP} warm-up frame on a copy, {ODD_TIMED} "
               "timed, against 1 block; K1, (S1,) K7, P5 once a block a "
               "substep, no plain version"):
        for label, (argv, y, x) in F64_BLOCK_FRAMES.items():
            c32, scn, st = cli_state(argv)
            cfg = dataclasses.replace(c32, solver=dataclasses.replace(
                c32.solver, dtype="float64"))
            st = developed(cfg, scn, st)
            held = reset_peak()
            got, ms, got_l, plain = block_frames(cfg, scn, st, y, dev,
                                                 ODD_WARMUP, ODD_TIMED, x=x,
                                                 rewind=True)
            per = y * x * cfg.max_substeps * ODD_TIMED
            names = (("K1", "S1", "K7", "P5") if scn.num_sources
                     else ("K1", "K7", "P5"))
            check(plain == 0 and all(got_l.get(k) == per for k in names)
                  and not got_l.get("P4") and not got_l.get("P3"),
                  f"f64 {label} on {y} x {x}: not one launch a block a "
                  f"substep: {got_l}, plain {plain}")
            row = {"ms_per_frame": ms, "launches": got_l}
            record_peak(row, held)
            one, ms1, _, _ = block_frames(cfg, scn, st, 1, dev, ODD_WARMUP,
                                          ODD_TIMED, rewind=True)
            for name in ("u", "v", "p", "markers"):
                check(bool(torch.isfinite(getattr(got, name)).all()),
                      f"f64 {label} on {y} x {x}: {name} not finite")
            d = frame_diff(got, one)
            row.update(ms_per_frame_1_block=ms1, vs_1_block=d,
                       div_inf=div_inf(cfg, got, exclude=scn.source
                                       if scn.num_sources else None))
            summary[f"frames_{label}_{y}x{x}"] = row
            check(frames_agree(d), f"f64 {label}, {y} x {x} vs 1: {d}")
            if (y, x) == (ODD_N, 1):
                launches["P5_f64"] = got_l["P5"]
            log(f"   f64 {label} on {y} x {x}: {ms:.1f} ms a frame, 1 "
                f"block {ms1:.1f}; {d['count_cells']} of {d['cells']} "
                f"cells' counts apart, max |dv| {d['max_dv']:.3g}; alive "
                f"{d['alive']}; div_inf {row['div_inf']:.4g}"
                + (" off the sources" if scn.num_sources else ""))
            del got, one, st, scn
        log(f"   nvidia-smi: {smi_line()}")
    summaries["f64_blocks"] = summary
    return profiled


def f64_block_profiles(results, summaries, systems, profiled, dev) -> None:
    """The device time of P5-f64 (a warm solve) and P4's f64 block MG (a
    cold solve) on the layouts `run_f64_blocks` timed for the kernels
    line, and of the same calls in f32 (the system rounded): the summed
    kernel spans of one profiled solve each, after every timed phase."""
    import torch

    summary = summaries["f64_blocks"]
    with Phase("P5-f64 and P4-f64 block MG: kernel spans of one solve "
               "each, beside the f32 layout's (torch.profiler)"):
        for kind, (label, y, x) in profiled.items():
            c, b, a_diag, fl, p0 = systems[label]
            tag = f"{c.ny}x{c.nx}"
            for cfg, bb, x0 in ((c, b, p0), in_f32(c, b, p0)):
                if kind == "p5":
                    g, inputs = p5_group(cfg, bb, a_diag, fl, x0, y, x, dev)
                    with g:
                        p5_solve(cfg, g, inputs)
                        torch.cuda.synchronize()
                        spans = kernel_spans_ms(
                            lambda: p5_solve(cfg, g, inputs))
                    row = summary[f"p5_{tag}_{y}x{x}_warm"]
                else:
                    spans = block_spans(cfg, bb, a_diag, fl, y, dev, x)
                    row = summary[f"p4_block_mg_{tag}_{y}x{x}"]
                own, lib = spans if spans else (None, None)
                f64 = cfg.solver.dtype == "float64"
                pre = "" if f64 else "f32_"
                row.update({f"{pre}device_ms": own,
                            f"{pre}torch_device_ms": lib})
                if f64:
                    results[f"{kind.upper()}_f64"]["device_ms"] = own
                log(f"   {kind.upper()} {cfg.solver.dtype} {tag} on {y} x "
                    f"{x}: " + (f"its kernel spans {own:.4f} ms summed, "
                                f"torch's kernels and copies {lib:.4f} ms"
                                if spans else "not measured"))


def run_block_profiles(results, summaries, shared, dev) -> None:
    """P4's device time a solve of the 1024² substep system on 1, 2 and 4
    row blocks (Jacobi and block MG) and on 2 x 2 blocks (Jacobi), P5's
    (warm) on 1 x 1, 2 x 2 and 4 x 1 blocks, and P3's beside them: the
    summed kernel spans of one profiled solve each.  Run after every
    timing of the block phases: a profiler session over the blocks'
    threads slowed the host's later launches in this process (PERF.md
    §6), so nothing is timed after it."""
    b, a_diag, fl = shared["b"], shared["a_diag"], shared["fl"]
    layouts = [(label, n, 1) for label in shared["configs"]
               for n in ROW_BLOCKS] + [("jacobi", COL_N, COL_N)]
    with Phase(f"P4's device time a solve of the {SIZE}² substep system "
               "on 1, 2 and 4 row blocks and on 2 x 2 blocks, P5's on 1 x "
               "1, 2 x 2 and 4 x 1 blocks and P3's; at 1080 x 1920 P5 and "
               f"P4's block MG on {ODD_N} row blocks: the summed spans of "
               "one profiled solve"):
        for label, n, x in layouts:
            c = shared["configs"][label]
            key = "row_blocks" if x == 1 else "col_blocks"
            name = f"blocks_{n}" if x == 1 else f"blocks_{n}x{x}"
            row = summaries[key][f"p4_{label}"][name]
            spans = block_spans(c, b, a_diag, fl, n, dev, x)
            own, lib = spans if spans else (None, None)
            row.update(device_ms=own, torch_device_ms=lib)
            log(f"   {label}, {n} x {x} blocks: " + (
                f"P4's kernel spans {own:.4f} ms summed, torch's "
                f"kernels and copies (the group's folds and edge "
                f"copies) {lib:.4f} ms" if spans else
                "not measured (no kernel record in 3 profiles)"))
        results["P4"]["device_ms"] = \
            summaries["row_blocks"]["p4_jacobi"][f"blocks_{ROW_N}"][
                "device_ms"]
        results["P4b"]["device_ms"] = \
            summaries["col_blocks"]["p4_jacobi"][f"blocks_{COL_N}x{COL_N}"][
                "device_ms"]
        p5_profiles(results, summaries, shared, dev)
        p6_profiles(results, summaries, shared, dev)
        odd_profiles(results, summaries, shared, dev)


def p5_profiles(results, summaries, shared, dev) -> None:
    """P5's device time a warm solve (as the frame solves) of the 1024²
    substep system on 1 x 1, 2 x 2 and 4 x 1 blocks, and P3's beside
    it: the summed kernel spans of one profiled solve each."""
    import torch

    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13

    b, a_diag, fl = shared["b"], shared["a_diag"], shared["fl"]
    c = shared["configs"]["mg"]
    p0 = torch.where(fl, shared["st"].p, 0.0)
    gmg = summaries["global_mg_blocks"]
    spans = kernel_spans_ms(lambda: p13.solve_pressure_general(
        c, b, a_diag, fl, x0=p0))
    gmg["p3_warm"]["device_ms"] = spans[0] if spans else None
    log("   P3 warm: " + (f"kernel spans {spans[0]:.4f} ms summed"
                          if spans else "not measured"))
    for y, x in GMG_LAYOUTS:
        g, inputs = p5_group(c, b, a_diag, fl, p0, y, x, dev)
        with g:
            p5_solve(c, g, inputs)
            torch.cuda.synchronize()
            spans = kernel_spans_ms(lambda: p5_solve(c, g, inputs))
        own, lib = spans if spans else (None, None)
        gmg[f"blocks_{y}x{x}_warm"].update(device_ms=own,
                                           torch_device_ms=lib)
        log(f"   P5 warm, {y} x {x} blocks: " + (
            f"its kernel spans {own:.4f} ms summed, torch's kernels and "
            f"copies (the group's folds, edge copies and gathers) "
            f"{lib:.4f} ms" if spans else "not measured"))
    results["P5"]["device_ms"] = gmg[f"blocks_{COL_N}x{COL_N}_warm"][
        "device_ms"]


def odd_profiles(results, summaries, shared, dev) -> None:
    """On the 1080 x 1920 waterfall system: P5's device time a warm solve
    on 8 row blocks (gathering at level 0) and P3's beside it, and P4's
    block MG a cold solve on the 8 blocks: the summed kernel spans of one
    profiled solve each."""
    import torch

    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13

    c, b, a_diag, fl, p0 = (shared["odd"][k] for k in
                            ("cfg", "b", "a_diag", "fl", "p0"))
    odd = summaries["odd_blocks"]
    spans = kernel_spans_ms(lambda: p13.solve_pressure_general(
        c, b, a_diag, fl, x0=p0))
    p3 = spans[0] if spans else None
    g, inputs = p5_group(c, b, a_diag, fl, p0, ODD_N, 1, dev)
    with g:
        p5_solve(c, g, inputs)
        torch.cuda.synchronize()
        spans = kernel_spans_ms(lambda: p5_solve(c, g, inputs))
    own, lib = spans if spans else (None, None)
    odd[f"p5_1080x1920_{ODD_N}x1_warm"].update(
        device_ms=own, torch_device_ms=lib, p3_device_ms=p3)
    results["P5o"]["device_ms"] = own
    log(f"   P5 warm, {ODD_N} x 1 blocks of 1080 x 1920 (gathering at 0): "
        + (f"its kernel spans {own:.4f} ms summed, torch's kernels and "
           f"copies {lib:.4f} ms" if spans else "not measured")
        + (f"; P3 {p3:.4f} ms" if p3 is not None else "; P3 not measured"))
    spans = block_spans(c, b, a_diag, fl, ODD_N, dev)
    own, lib = spans if spans else (None, None)
    odd["p4_block_mg"].update(device_ms=own, torch_device_ms=lib)
    results["P4o"]["device_ms"] = own
    log(f"   P4 block MG, {ODD_N} row blocks of 1080 x 1920: " + (
        f"its kernel spans {own:.4f} ms summed, torch's kernels and copies "
        f"{lib:.4f} ms" if spans else "not measured"))


def p6_profiles(results, summaries, shared, dev) -> None:
    """P6's device time a warm solve of the 256² IC(0) system on 1 x 1, 2 x
    2 and 4 x 1 blocks, and P1 + P2's beside it, and of the kernels line's
    40 x 100 call: the summed kernel spans of one profiled solve each."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    cfg, b, a_diag, fl, p0 = shared["ic0"]
    summary = summaries["ic0_blocks"]
    spans = kernel_spans_ms(lambda: p12.solve_pressure_general(
        cfg, b, a_diag, fl, x0=p0))
    summary["p1_p2_warm"]["device_ms"] = spans[0] if spans else None
    log("   P1 + P2 warm: " + (f"kernel spans {spans[0]:.4f} ms summed"
                              if spans else "not measured"))
    for y, x in IC0_LAYOUTS:
        g, rank = p6_solve(cfg, y, x, dev, b, a_diag, fl, p0)
        with g:
            g.run(rank)
            spans = kernel_spans_ms(lambda: g.run(rank))
        own, lib = spans if spans else (None, None)
        summary[f"blocks_{y}x{x}_warm"].update(device_ms=own,
                                                torch_device_ms=lib)
        log(f"   P6 warm, {y} x {x} blocks: " + (
            f"its kernel spans {own:.4f} ms summed, torch's kernels and "
            f"copies (the group's folds and edge copies) {lib:.4f} ms"
            if spans else "not measured"))
    scfg, sb, sa, sfl = shared["ic0_small"]
    g, rank = p6_solve(scfg, COL_N, COL_N, dev, sb, sa, sfl)
    with g:
        g.run(rank)
        spans = kernel_spans_ms(lambda: g.run(rank))
    small = summary[f"plain_{IC0_SMALL[0]}x{IC0_SMALL[1]}"]
    small["device_ms"] = spans[0] if spans else None
    results["P6"]["device_ms"] = small["device_ms"]
    log(f"   P6 cold, {IC0_SMALL[0]} x {IC0_SMALL[1]} on {COL_N} x {COL_N} "
        "blocks: " + (f"its kernel spans {spans[0]:.4f} ms summed"
                      if spans else "not measured"))


def run(args) -> dict:
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import pcg_kernel as k89
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6
    from euler_tpu_torch.ops.cuda import substep_kernel as k2
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"nvidia-smi: {smi_line()}")

    with Phase("build kernels"):
        build_all()

    with Phase("main path at 64² on the three marker routes: GPU kernels "
               "vs CPU plain, 2 frames"):
        for route, cfg_s in marker_configs(main_config(64)).items():
            scn_g, st_g = dam_break(cfg_s, device=dev)
            scn_c, st_c = dam_break(cfg_s, device="cpu")
            check(sim.marker_route(cfg_s, scn_g) == route,
                  f"64²: marker route {sim.marker_route(cfg_s, scn_g)}")
            for _ in range(2):
                st_g = sim.step_frame(cfg_s, scn_g, st_g)
                st_c = sim.step_frame(cfg_s, scn_c, st_c)
            check(torch.equal(st_g.marker_count.cpu(), st_c.marker_count),
                  f"64² {route}: marker_count differs between GPU kernels "
                  "and CPU plain")
            du = (st_g.u.cpu() - st_c.u).abs().max().item()
            dv = (st_g.v.cpu() - st_c.v).abs().max().item()
            log(f"   {route}: counts equal; max |du| {du:.3g}, |dv| "
                f"{dv:.3g} (atol 5e-3); dropped "
                f"{int(st_g.dropped_markers)} vs {int(st_c.dropped_markers)}")
            check(du <= 5e-3 and dv <= 5e-3,
                  f"64² {route}: velocities differ > 5e-3")
            check(int(st_g.dropped_markers) == int(st_c.dropped_markers),
                  f"64² {route}: dropped_markers differ")

    cfg = main_config(SIZE)
    scfg = speed_config(SIZE)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    with Phase(f"dam break {SIZE}², {WARMUP_FRAMES} warm-up frames"):
        scn, state = dam_break(cfg, device=dev)
        for _ in range(WARMUP_FRAMES):
            state = sim.step_frame(cfg, scn, state)
        torch.cuda.synchronize()

    results = {}
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    with Phase("kernels vs plain versions on the card"):
        frame_time = torch.tensor(cfg.frame_time, device=dev)
        dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                              frame_time)
        log(f"   dt {dt.item():.6g}")
        dead = scn.sink | scn.solid
        slots = state.markers.reshape(2 * K, Y, X)
        k1_args = (cfg, state.u, state.v, state.fluid, scn.solid, slots, dt,
                   state.marker_count)
        o_k, c_k, d_k = k1.march_rebin(*k1_args, dead=dead)
        o_p, c_p, d_p = k1.march_rebin_plain(*k1_args, dead=dead)
        check(torch.equal(c_k, c_p), "K1 counts differ from plain")
        check(torch.equal(d_k, d_p), "K1 drops differ from plain")
        err1 = (o_k - o_p).abs().max().item()
        n_live = int(c_p.sum())
        log(f"   K1: counts, drops equal; whole store max err {err1:.3g} "
            f"(bitwise: {torch.equal(o_k, o_p)}; {n_live} live markers of "
            f"{K * Y * X} slots)")
        check(torch.equal(o_k, o_p), "K1: the store differs from plain "
              "(dead slots included)")
        o_0, c_0, d_0 = k1.march_rebin(cfg, state.u, state.v, state.fluid,
                                       scn.solid, slots, zero,
                                       state.marker_count, dead=dead)
        check(torch.equal(o_0, slots) and torch.equal(c_0, state.marker_count)
              and int(d_0.sum()) == 0, "K1 with dt = 0 is not an identity")
        log("   K1: dt = 0 is a bitwise identity")
        results["K1"] = {"max_abs_err": err1}

        for name, err in check_marker_variants(cfg, scn, state, dt, o_k, c_k,
                                               d_k).items():
            results[name] = {"max_abs_err": err}

        fl, pfl = c_k > 0, state.marker_count > 0
        k2_args = (cfg, dt, dt, state.u, state.v, fl, pfl, scn.solid,
                   state.p)
        u_k, v_k, it_k, _, msq_k, p_k = k2.project_substep_mg(*k2_args)
        u_p, v_p, it_p, _, msq_p, p_p = k2.project_substep_mg_plain(
            *k2_args)
        err2 = max((u_k - u_p).abs().max().item(),
                   (v_k - v_p).abs().max().item())
        rel_msq = abs(msq_k.item() - msq_p.item()) / max(msq_p.item(), 1e-30)
        log(f"   K2: u/v max err {err2:.3g} (atol 2e-3); iters "
            f"{int(it_k)} vs {int(it_p)}; msq rel err {rel_msq:.3g}")
        check(err2 <= 2e-3, "K2 velocities differ > 2e-3")
        check(abs(int(it_k) - int(it_p)) <= 1, "K2 iterations differ > 1")
        check(rel_msq <= 1e-3, "K2 msq differs > 1e-3 relative")
        u_i, v_i, it_i, res_i, msq_i, _ = k2.project_substep_mg(
            cfg, zero, inf, state.u, state.v, fl, pfl, scn.solid, state.p)
        check(int(it_i) == 0 and float(res_i) == 0.0
              and bool(torch.isfinite(u_i).all())
              and bool(torch.isfinite(v_i).all()),
              "K2 inactive substep is not free and finite")
        log("   K2: inactive substep exits with 0 iterations, finite")
        results["K2"] = {"max_abs_err": err2}

        # the substep's own system: the RHS of the advected velocities
        ut, vt = k7.grid_stage_plain(cfg, dt, state.u, state.v, fl, pfl,
                                     scn.solid)
        results["K7"] = {"max_abs_err": check_k7(
            cfg, (state.u, state.v, fl, pfl, scn.solid), dt, f"{SIZE}²")}
        b = divergence_rhs(cfg, ut, vt, fl, dt)
        a_diag = pressure_matrix_diag(cfg, scn.solid, fl)
        err3 = 0.0
        for x0 in (None, state.p):
            p3k, i3k, _ = k3.solve_pressure_mg(cfg, b, a_diag, fl, x0=x0)
            p3p, i3p, _ = k3.solve_pressure_mg_plain(cfg, b, a_diag, fl, x0)
            scale = p3p.abs().max().item()
            e = (p3k - p3p).abs().max().item()
            err3 = max(err3, e)
            log(f"   K3 ({'warm' if x0 is not None else 'cold'}): p max err "
                f"{e:.3g} of scale {scale:.3g} (atol 5e-4*scale); iters "
                f"{int(i3k)} vs {int(i3p)}")
            check(e <= 5e-4 * scale, "K3 pressure differs > 5e-4*scale")
            check(abs(int(i3k) - int(i3p)) <= 1, "K3 iterations differ > 1")
        capped = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, max_iterations=3))
        p3k, i3k, _ = k3.solve_pressure_mg(capped, b, a_diag, fl, x0=state.p)
        p3p, i3p, _ = k3.solve_pressure_mg_plain(capped, b, a_diag, fl,
                                                 state.p)
        e = (p3k - p3p).abs().max().item()
        scale = p3p.abs().max().item()
        log(f"   K3 (max_iterations 3): iters {int(i3k)} vs {int(i3p)}; p max "
            f"err {e:.3g} of scale {scale:.3g}")
        check(int(i3k) == int(i3p) == 3, "K3 capped at 3 iterations did not "
              "take exactly 3")
        check(e <= 5e-4 * scale, "K3 (capped) pressure differs > 5e-4*scale")
        err3 = max(err3, e)
        check_hierarchy(cfg, b, a_diag, fl)
        results["K3"] = {"max_abs_err": err3}

        # the Jacobi kernels on the same system, at the speed-mode budget
        p8k, i8k, _ = k89.solve_pressure_jacobi(scfg, b, a_diag, fl)
        p8p, i8p, _ = k89.solve_pressure_jacobi_plain(scfg, b, a_diag, fl)
        scale = p8p.abs().max().item()
        err8 = (p8k - p8p).abs().max().item()
        log(f"   K8: p max err {err8:.3g} of scale {scale:.3g} (atol "
            f"1e-3*scale); iters {int(i8k)} vs {int(i8p)}")
        check(int(i8k) == int(i8p), "K8 iterations differ")
        check(err8 <= 1e-3 * scale, "K8 pressure differs > 1e-3*scale")
        results["K8"] = {"max_abs_err": err8}
        jacobi_syncs = {
            "K8": stream_syncs(lambda: k89.solve_pressure_jacobi(
                scfg, b, a_diag, fl)),
            "K10": stream_syncs(lambda: k2.project_substep_jacobi(
                scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid))}
        log(f"   K8 / K10: {jacobi_syncs['K8']} / {jacobi_syncs['K10']} "
            f"stream syncs in one solve of {int(i8k)} iterations")

        jacobi_pairs = {
            "K9": (lambda: k89.project_jacobi(scfg, dt, ut, vt, fl,
                                              scn.solid),
                   lambda: k89.project_jacobi_plain(scfg, dt, ut, vt, fl,
                                                    scn.solid)),
            "K10": (lambda: k2.project_substep_jacobi(
                        scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid),
                    lambda: k2.project_substep_jacobi_plain(
                        scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid)),
        }
        for name, (kern, plain_fn) in jacobi_pairs.items():
            u_k, v_k, it_k, _, msq_k = kern()
            u_p, v_p, it_p, _, msq_p = plain_fn()
            err = max((u_k - u_p).abs().max().item(),
                      (v_k - v_p).abs().max().item())
            rel_msq = (abs(msq_k.item() - msq_p.item())
                       / max(msq_p.item(), 1e-30))
            log(f"   {name}: u/v max err {err:.3g} (atol 2e-3); iters "
                f"{int(it_k)} vs {int(it_p)}; msq rel err {rel_msq:.3g}")
            check(err <= 2e-3, f"{name} velocities differ > 2e-3")
            check(abs(int(it_k) - int(it_p)) <= 1,
                  f"{name} iterations differ > 1")
            check(rel_msq <= 1e-3, f"{name} msq differs > 1e-3 relative")
            results[name] = {"max_abs_err": err}
        u_i, v_i, it_i, res_i, msq_i = k2.project_substep_jacobi(
            scfg, zero, inf, state.u, state.v, fl, pfl, scn.solid)
        check(int(it_i) == 0 and float(res_i) == 0.0
              and all(bool(torch.isfinite(t).all())
                      for t in (u_i, v_i, msq_i)),
              "K10 inactive substep is not free and finite")
        log("   K10: inactive substep exits with 0 iterations, finite")
        torch.cuda.synchronize()

    summaries = {}
    launches = {}
    with Phase(f"main path: {FRAMES} timed frames"):
        held = reset_peak()
        state, summaries["mg"] = run_path(cfg, scn, state, FRAMES,
                                          ["K1", "K2", "K3"], "MG main path")
        record_peak(summaries["mg"], held)
        check(summaries["mg"]["div_inf"] < 1.0,
              "div_inf too large: the projection did not converge")
        for k in ("K1", "K2", "K3"):
            launches[k] = summaries["mg"]["launches"].get(k, 0)

    with Phase(f"speed mode {SIZE}²: {WARMUP_FRAMES} warm-up + {FRAMES} "
               "timed frames"):
        sscn, sstate = dam_break(scfg, device=dev)
        for _ in range(WARMUP_FRAMES):
            sstate = sim.step_frame(scfg, sscn, sstate)
        # no div_inf limit: the speed mode gives up at 100 iterations
        sstate, summaries["speed"] = run_path(scfg, sscn, sstate, FRAMES,
                                              ["K1", "K10"], "speed mode")
        summaries["speed"]["jacobi_syncs_per_solve"] = jacobi_syncs
        launches["K10"] = summaries["speed"]["launches"].get("K10", 0)

    unfused = dataclasses.replace(scfg, solver=dataclasses.replace(
        scfg.solver, fuse_projection=False))
    # route: (config, its kernels, the kernels whose launch count it gives)
    routes = {
        "jacobi_unfused": (unfused, ["K1", "K7", "K8"], ["K8"]),
        "jacobi_rainbow": (speed_config(SIZE, rainbow=True),
                           ["K1", "K7", "K9"], ["K9"]),
        "mg_rainbow": (dataclasses.replace(cfg, rainbow=True),
                       ["K1", "K7", "K3"], []),
        "jacobi_pallas_grid": (dataclasses.replace(
            unfused, use_pallas_grid=True), ["K1", "K7", "K8"], ["K7"]),
    }
    for route, (rcfg, kernels, counted) in routes.items():
        with Phase(f"route {route} {SIZE}²: {ROUTE_WARMUP} warm-up + "
                   f"{ROUTE_FRAMES} timed frames"):
            held = reset_peak()
            rscn, rstate = dam_break(rcfg, device=dev)
            for _ in range(ROUTE_WARMUP):
                rstate = sim.step_frame(rcfg, rscn, rstate)
            rstate, summaries[route] = run_path(rcfg, rscn, rstate,
                                                ROUTE_FRAMES, kernels, route)
            if route == "mg_rainbow":
                check(summaries[route]["div_inf"] < 1.0,
                      "mg_rainbow: div_inf too large")
            for k in counted:
                launches[k] = summaries[route]["launches"].get(k, 0)
            if "K7" in kernels:
                record_peak(summaries[route], held)
            del rscn, rstate

    run_marker_routes(cfg, summaries, launches, dev, args.profile)

    with Phase("kernel vs plain times (CUDA events)"):
        fl, pfl = state.fluid, state.prev_fluid
        slots = state.markers.reshape(2 * K, Y, X)
        dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                              frame_time)
        k1_args = (cfg, state.u, state.v, fl, scn.solid, slots, dt,
                   state.marker_count)
        k2_args = (cfg, dt, dt, state.u, state.v, fl, pfl, scn.solid,
                   state.p)
        k10_args = (scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid)
        a_diag = pressure_matrix_diag(cfg, scn.solid, fl)
        ut, vt = k7.grid_stage_plain(cfg, dt, state.u, state.v, fl, pfl,
                                     scn.solid)
        b = divergence_rhs(cfg, ut, vt, fl, dt)
        grid_args = (state.u, state.v, fl, pfl, scn.solid)
        k5_args = (cfg, state.u, state.v, fl, scn.solid, state.markers, dt,
                   state.marker_count)
        marched = k5.advect_markers(*k5_args)
        padded = k1.pad_slot_store(cfg, state.markers)
        k4_args = (cfg, state.u, state.v, fl, scn.solid, padded, dt,
                   state.marker_count)
        pairs = {
            "K1": (lambda: k1.march_rebin(*k1_args, dead=dead),
                   lambda: k1.march_rebin_plain(*k1_args, dead=dead)),
            "K4": (lambda: k1.march_rebin_padded(*k4_args, dead=dead),
                   lambda: k1.march_rebin_padded_plain(*k4_args,
                                                       dead=dead)),
            "K5": (lambda: k5.advect_markers(*k5_args),
                   lambda: k5.advect_markers_plain(*k5_args)),
            "K6": (lambda: k6.rebin_markers(cfg, marched, state.alive,
                                            dead),
                   lambda: k6.rebin_markers_plain(cfg, marched,
                                                  state.alive, dead)),
            "K2": (lambda: k2.project_substep_mg(*k2_args),
                   lambda: k2.project_substep_mg_plain(*k2_args)),
            "K3": (lambda: k3.solve_pressure_mg(cfg, b, a_diag, fl,
                                                x0=state.p),
                   lambda: k3.solve_pressure_mg_plain(cfg, b, a_diag, fl,
                                                      state.p)),
            "K7": (lambda: k7.grid_stage(cfg, *grid_args, dt),
                   lambda: k7.grid_stage_plain(cfg, dt, *grid_args)),
            "K8": (lambda: k89.solve_pressure_jacobi(scfg, b, a_diag, fl),
                   lambda: k89.solve_pressure_jacobi_plain(scfg, b, a_diag,
                                                           fl)),
            "K9": (lambda: k89.project_jacobi(scfg, dt, ut, vt, fl,
                                              scn.solid),
                   lambda: k89.project_jacobi_plain(scfg, dt, ut, vt, fl,
                                                    scn.solid)),
            "K10": (lambda: k2.project_substep_jacobi(*k10_args),
                    lambda: k2.project_substep_jacobi_plain(*k10_args)),
        }
        n_live = int(state.marker_count.sum())
        for name, (kern, plain_fn) in pairs.items():
            time_pair(results, name, kern, plain_fn, Y * X, n_live, REPS)
        time_unfused_wide(cfg, scn, state, dt, results)

    for size in LARGE:
        run_large(size, results, summaries, launches, args.profile)

    run_text_scenarios(results, summaries, launches, args.profile)

    f64_systems = run_f64_mg(results, summaries, launches)

    run_global(results, summaries, launches, args.profile)

    run_batch(summaries, launches, dev)

    run_diagnostics(summaries)

    run_shard(results, summaries, launches, dev)

    shared = run_row_blocks(results, summaries, launches, dev)

    run_col_blocks(results, summaries, launches, dev, shared)

    run_global_mg_blocks(results, summaries, launches, dev, shared)

    run_ic0_blocks(results, summaries, launches, dev, shared)

    run_color_global_blocks(results, summaries, launches, dev, shared)

    run_odd_blocks(results, summaries, launches, dev, shared)

    f64_profiled = run_f64_blocks(results, summaries, launches, dev,
                                  f64_systems)

    smoother_systems = run_mg_smoothers(results, summaries, launches)

    run_block_profiles(results, summaries, shared, dev)
    del shared

    f64_block_profiles(results, summaries, f64_systems, f64_profiled, dev)

    f64_profiles(results, f64_systems)
    del f64_systems

    smoother_profiles(results, smoother_systems)
    del smoother_systems

    if args.profile:
        with Phase("profile"):
            profile(cfg, scn, state, f"{args.profile}.mg.txt", "mg")
            profile(scfg, sscn, sstate, f"{args.profile}.speed.txt",
                    "speed")

    with Phase("the card tests (pytest, six processes at once): "
               + "; ".join(t[0] for t in CARD_TESTS)):
        torch.cuda.empty_cache()
        run_card_tests()

    kernels = []
    for key, (name, src, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        **results[key]})
    log(json.dumps({"summary": summaries}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}


def kernel_spans_ms(fn):
    """torch.profiler over one call of fn(): the summed spans, in ms, of
    the port's own kernels and of torch's kernels and copies (the
    in-process group's folds and edge copies), or None when the profiler
    recorded no kernel of the port in 3 tries (a profiler session on the
    card now and then loses its records, PERF.md §7)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        own = lib = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            span = e.end_ns() - e.start_ns()
            if "at::" in name or name.startswith(("Memcpy", "Memset")):
                lib += span
            else:
                own += span
        if own > 0:
            return own / 1e6, lib / 1e6
    return None


def device_busy_us(prof) -> float:
    """Device time in a profile covered by at least one kernel, copy or
    set (the union of their spans: launches that overlap, as K8-K10's
    sweeps do, count once)."""
    import torch

    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, start, end = 0, None, None
    for s, t in spans:
        if end is None or s > end:
            busy += 0 if end is None else end - start
            start, end = s, t
        else:
            end = max(end, t)
    return (busy + (0 if end is None else end - start)) / 1e3


def profile(cfg, scn, state, path: str, label: str) -> None:
    """torch.profiler over 2 frames from `state`: device kernel time by
    name, written to `path`, with launches and stream syncs per frame and
    the device's idle share of the same 2 frames' unprofiled wall time
    (they are deterministic, so they are stepped twice: timed, then
    profiled).  Device time is given twice: the sum of kernel spans (the
    measure of earlier runs) and the union of all spans (overlapping
    launches counted once), each with its idle share."""
    import torch
    from torch.profiler import ProfilerActivity

    from euler_tpu_torch import sim

    frames = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state
    for _ in range(frames):
        st, stats = sim.step_frame_stats(cfg, scn, st)
    torch.cuda.synchronize()
    ms_frame = 1e3 * (time.perf_counter() - t0) / frames
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st = state
        for _ in range(frames):
            st = sim.step_frame(cfg, scn, st)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "w") as fh:
        fh.write(table)
    dev_us = 0.0
    n_kernels = 0
    n_sync = 0
    n_grid = 0  # grid-stage spans: K7's tiled launch, alone or in K2 / K10
    for e in events:
        d = getattr(e, "device_time_total", None)
        if d is None:
            d = getattr(e, "cuda_time_total", 0.0)
        if e.key.startswith("cuda") or e.key.startswith("aten::"):
            if "Synchronize" in e.key:
                n_sync += e.count
            continue
        if d > 0:
            dev_us += d
            n_kernels += e.count
            if "grid_tiles" in e.key:
                n_grid += e.count
            if "sweep_a" in e.key or "sweep_b" in e.key:
                log(f"   {label}: {e.key[:48]}: {d / e.count:.2f} us a "
                    f"launch span, the wait for the kernel before it "
                    f"included ({e.count} launches)")
    dev_ms = dev_us / 1e3 / frames
    busy_ms = device_busy_us(prof) / 1e3 / frames
    log(f"   {label}: device kernel time {dev_ms:.3f} "
        f"ms/frame, {n_kernels / frames:.0f} kernel launches/frame, "
        f"{n_sync / frames:.0f} stream syncs/frame; the same frames "
        f"unprofiled {ms_frame:.3f} ms/frame ({int(stats['n_active'])} "
        f"active substeps in the last), idle share "
        f"{1 - dev_ms / ms_frame:.3f}; table in {path}")
    log(f"   {label}: device busy (union of spans) {busy_ms:.3f} ms/frame, "
        f"idle share {1 - busy_ms / ms_frame:.3f}; {n_grid} grid-stage "
        f"spans in {frames} frames of {cfg.max_substeps} substeps")
    for line in table.splitlines()[:20]:
        log(f"   {line}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, metavar="PREFIX",
                    help="write torch.profiler tables of 2 frames of the "
                         "MG main path, the speed mode, the three marker "
                         "routes and the 2048² and 4096² paths to "
                         "PREFIX.mg.txt, PREFIX.speed.txt, "
                         "PREFIX.marker_k1.txt, PREFIX.marker_unfused.txt, "
                         "PREFIX.padded_store.txt, PREFIX.mg_2048.txt, "
                         "PREFIX.jacobi_4096.txt, of the six CLI runs to "
                         "PREFIX.cli_waterfall.txt, "
                         "PREFIX.cli_waterfall_1024.txt, "
                         "PREFIX.cli_dam_break_1024.txt, "
                         "PREFIX.cli_waterfall_1080p.txt, "
                         "PREFIX.cli_dam_break_1200.txt and "
                         "PREFIX.cli_filter_no_pallas.txt, and of the 1024² "
                         "global dam break to PREFIX.global_f32.txt and "
                         "PREFIX.global_f64.txt")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's "
              "kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import euler_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (the "
              "euler_tpu_torch package was not found)", file=sys.stderr)
        return 2
    result = run(args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
