#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (no phase's exception is caught; any failure exits non-zero):
  1. device and build: the card's name and power limit, then every CUDA
     kernel built from the repo's sources (build time and the compiler's
     register/spill lines);
  2. each kernel against its plain PyTorch version on the same CUDA
     tensors: the live-frame kernels at the serving size (C=1024 tracks,
     M=256 measurements; assoc, waves and states bit for bit), the
     replay scans and bank steps at (N, T) = (5, 17) and at the replay
     size (N=131,072, T=300; IMM with 10% of the entries invalid and
     NaN, K=1 on cv9 and ekf; the single-model scan, ``katana_bank``
     and ``katana_bank_soa`` bit for bit);
  3. the submit path: ``TrackingEngine(..., device="cuda").submit`` over a
     150-frame dense-sky scene (200 targets, 20 clutter detections per
     frame) for the lkf, ekf and imm workloads, each frame held against
     the port's einsum route on the card (identical assoc and track ids)
     and the states against that route run in float64 (see ROUTE_SLACK),
     the launch counters equal to the frame count, the gated pairs and
     greedy waves of every frame; then the kernel, plain-version and
     einsum-route times at this shape (CUDA events), each CUDA kernel's
     device time (torch.profiler, every launch's event counted), the
     greedy's device time inside the frame both ways (CUDA events the
     kernel records around its launches, and torch.profiler), each
     frame's device time a launch (predict, cost tile, greedy, update:
     CUDA events it records between them, the device queued behind a
     spin) with the ptxas register and spill lines of its kernels, and
     the least time the frame's data needs (bound_ms);
  3b. the sensor fleet: ``ShardedBankEngine(model, 8, ..., devices=
     ("cuda",))`` for lkf, ekf and imm, 8 sensors each at phase 3's shape
     (C=1024, M=256, the dense-sky scene of seed 7 + s), T=150 frames:
     every fleet frame bit for bit with 8 single-sensor frame steps on the
     card (assoc, ids, x, P, mu, x_est) and the greedy waves per sensor
     (the imm fleet also split over two shards of the one card, bit for
     bit); then a fresh fleet timed over the scene: one launch count a
     fleet frame, fleet frames/s and sensor-frames/s on the host clock
     against phase 3's FPS and the >= 300 FPS limit, the fleet frame's
     device ms a launch (events between launches, device queued), its
     bound at S=8 and the ptxas lines of its S-aware kernels; the fleet
     replay (T=300 over 8 x 1024 lanes, 30% invalid) as one
     ``katana_imm_sequence`` launch a time chunk (the tile table's) bit for
     bit with 8 per-sensor calls;
  4. the replay path: ``TrackingEngine(..., device="cuda").replay`` over
     N=131,072 tracks (the batch of katana-lkf-pod / katana-ekf-pod) for
     T=300 frames, lkf, ekf and imm: launch counters, every frame of 64
     sample tracks against the float64 oracle (core/ref.py), replay FPS
     (host clock from numpy in to numpy out; the engine's own span too),
     the host<->card copies, the scan's times (CUDA events, the device
     queued behind a spin; also with the whole stream in one launch),
     bound and the share of it reached, and (lkf, ekf) its registers,
     waves and ptxas lines; then the lane of tests/data/imm_scan_lane.npz
     (ROADMAP §3) through the IMM scan kernel and its plain version on
     the card, bit for bit, NaNs included;
  5. the per-frame twins at that size: T ``katana_bank`` calls equal the
     scan's final state bit for bit; ``imm_bank_sequence`` against
     ``katana_imm_sequence``; the step kernels' times (``katana_bank``
     and ``katana_bank_soa`` by CUDA events with the device queued behind
     a spin), bounds and the share of them reached, and the ptxas
     register and spill lines of the single-model step's instantiations;
  5b. the stage ladder (``core/rewrites.py``) at the batches of
     ``configs/katana.py``, T=300: baseline, opt1, opt2 at N=1,
     batched_blockdiag and batched_lanes at N=200, batched_lanes,
     fused_scan, imm_bank and imm_scan at N=131,072, each through
     ``run_sequence`` at its default symmetrize=False against the float64
     oracle, with µs a step and steps/s (a Table I row); the kernel
     stages' launch counts; the timed run's own xs of those stages bit
     for bit with their plain versions over all 300 frames, and so again
     over 60 frames at symmetrize False and True on a seed P that is not
     symmetric to the bit; the symmetrize=False kernels' times, bounds,
     registers and spill beside the True ones; the live frames (lkf, ekf,
     imm at C=1024, M=256) and the K=4 IMM scan (8 x 1024 lanes, T=300,
     30% invalid, both tiles, one launch and chunks of 64) at both
     symmetrize values bit for bit with their plain versions on a seed P
     that is not symmetric to the bit, with their device ms, bounds,
     registers and spill; and the imm_scan rung on make_imm() (K=4, the
     full square) at N=131,072 against the float64 oracle, a Table I row;
  6. ``replay_imm_bank`` from the live IMM bank of phase 3 resumes a
     stream bit for bit and leaves the bank unchanged;
  7. LM serving: h2o-danube-1.8b at full width, random bf16 weights, B=4
     prompts of S=8192 tokens from ``LMDataPipeline`` prefilled through
     ``make_prefill_step`` (attn_impl "flash": 24 flash_attention
     launches), 32 greedy steps through ``make_decode_step`` (the same
     context: 24 flash_decode launches a step); prefill ms, decode
     ms/token and tokens/s (host clock around synchronised steps). Held:
     the LM kernels against their plain versions (float32 at small shapes;
     bf16 at one layer of the serving shape, within one bf16 ulp); the
     last-position logits and every layer's cache against the banded
     ``swa`` route, both measured from that route run in float32 (see
     phase_lm); flash_decode against ``decode_attention`` on decode step
     0's inputs of every layer (float32, 1e-5/1e-4); the share of greedy
     tokens equal to the reference route's is printed. Then each kernel's
     time (CUDA events per wrapper call at layer 0's inputs, and each
     launch's device time in the profiled prefill and decode step), bound
     and the share of it reached, plain and library
     times, its design (tiles, stages and MMA route of flash_attention;
     splits and blocks of flash_decode, which must exceed the card's SMs)
     and its ptxas register and spill lines;
  8. Mamba-2 serving: mamba2-130m at full width and depth, random bf16
     weights, B=8 prompts of S=32768 tokens from ``LMDataPipeline``
     prefilled through ``make_prefill_step`` (24 ssd_scan launches), 32
     greedy steps through ``make_decode_step`` (no launch: the decode step
     is the reference's one-step recurrence in torch ops); prefill ms and
     tokens/s, decode ms/token and tokens/s (host clock around
     synchronised steps), the device-busy share and largest kernels of one
     prefill and one decode step. Held: ssd_scan against its plain
     version (float32 at small shapes, 1e-5 + 1e-4|x|, with S < chunk,
     state0 and decays that would overflow above the diagonal; bf16 on
     layer 0's real prefill inputs, y within one bf16 ulp of the plain
     version that rounds as the tensor cores do and of the float32 one,
     the state within 1e-4 of its scale); the float32 prefill through the
     kernel against the same prefill with ``models.ssm.ssd_chunked`` in its
     place (logits and every layer's cache within 1e-4 of their scale); the
     bf16 kernel route no farther from that float32 run than max(2^-8, 2x)
     the bf16 ``ssd_chunked`` route (see phase_mamba). Then the kernel's time
     (CUDA events; also at 16, 32 and 64 columns of p a pass), its four
     launches' device times, bound and plain time, and the float32
     route's time on the same inputs;
  9. the streaming front end: ``StreamFrontEnd(model, StreamConfig(
     n_shards=2, lanes_per_shard=8, queue_depth=4, checkpoint_every=8,
     heartbeat_timeout_s=1.0), ..., devices=("cuda",))`` at phase 3's
     per-sensor shape, both shards on the one card, 8 tenants (phase 3's
     scene of seed 7 + t each), imm and lkf, a fake clock of 0.5 s a
     cycle, 100 cycles through ``ChaosDriver``: (a) uninterrupted; (b)
     shard 0 killed at cycle 40, every tenant's stream bit for bit (a)'s,
     4 failovers; (c) the same with checkpoint_every=1000 (the frame-0
     snapshot and a 40-frame WAL replayed through the survivor's fused
     step); (d) offered load 0.5x, 1x and 2x under the default ladder
     (``benchmarks/serving.py:_load_row``): pumps/s and tenant-frames/s on
     the host clock against the >= 300 limit a tenant, the served, shed
     and reject fractions, no tenant starved, the 1x pump's host ms split
     into dispatch, select, snapshot copies and checkpoint saves; (e)
     ``tests/test_chaos.py::test_everything_at_once``'s plan at this size.
     Every run: zero exceptions, dispatch errors and breaker trips, and
     the frame kernel's and the greedy's launches equal to the dispatches
     plus the WAL frames replayed; also one pump's dispatch: the frame
     kernel's device ms a launch at 8 lanes (events, device queued) and
     the whole step's ms;
  10. training: (a) flash_attention's gradient at danube's layer shape
     (B=1, S=8192, 32 heads over 8 kv heads of 80, causal, window 4096)
     in bf16 and float32: dq, dk, dv through ``FlashAttention`` (the
     backward kernel, flash_attention_bwd.cu: bf16 on wgmma, float32 by
     3xTF32; ptxas's registers and spill of each of its kernels) with the
     kernel's forward bit for bit with the plain forward's, two kernel
     calls bit for bit, the kernel against ``flash_attention_bwd_plain``
     by ``ref.bwd_excess`` (float32 2e-5 + 1e-4|x|; bf16 two ulps, dV
     also its P-rounding allowance) and against the float64 oracle (each
     within 2x the torch-op backward's distance; float32 also 2e-5 +
     1e-4|x|; SDPA's backward's own distance printed, not held), the
     kernel's, the torch-op backward's, the plain version's and SDPA's
     backward's ms (SDPA for the record: a line "meets" or "LOSES" a layer
     and dtype) there and at granite-moe's training layer (B=1, S=4096,
     16 over 8 heads of 64, causal), a ragged S=1,000 within 2e-5 +
     1e-4|x| of float64; (b)
     reduced danube (flash) and mamba2, 5 float32 steps of
     ``make_train_step`` on the card against the same on the CPU, each
     loss within 1e-4 relative; (c) h2o-danube-1.8b at full size, bf16,
     S=8192, a global batch of 2 in 2 microbatches, 3 steps: finite loss
     and grad norm, ms a step, tokens/s, peak memory, flash_attention
     launches = 24 x 2 x steps (x 2 under recompute), flash_attention_bwd
     launches = 24 x 2 x steps and no call of the torch-op backward; (d)
     mamba2-130m at full size through
     ``launch/train.py`` (S=2048, batch 4 in 2, 20 steps): a held-out
     batch's loss falls, ms a step, tokens/s, peak memory;
  11. MoE layers and the modality frontends: (a) flash_attention at one
     layer of granite-moe-1b-a400m (B=8, S=4096, 16 heads over 8 of 64,
     causal), internvl2-2b (B=4, S=4096, 16 over 8 of 128, causal) and
     hubert-xlarge (B=4, S=1500, 16 heads of 80, non-causal, S not a
     multiple of the tiles) and flash_decode over a full cache with no
     window at granite-moe's and internvl2's decode shapes, float32 (2e-5;
     1e-5 + 1e-4|x|) and bf16 (one ulp of the plain and the hi/lo plain
     versions) against their plain versions, timed beside them and SDPA;
     (b) reduced granite-moe, qwen3-moe and jamba (its Mamba layers on
     ssd_scan) in float32 on attn_impl "flash": a prefill, 3 decode steps
     and 3 train steps on the card against the same on the CPU (logits
     within 1e-4 of their scale, loss and aux within 1e-4 relative, every
     MoE call's top-k identical); (c) granite-moe-1b-a400m at full size:
     B=8 prompts of S=4096 through ``make_prefill_step`` (24
     flash_attention launches), 32 greedy steps (24 flash_decode launches
     a step), prefill ms, tokens/s, decode ms/token, the device-busy share
     and largest kernels, the flash route's logits on 2 prompts within
     max(2^-8, 2x) the bf16 full route's distance from a float32 run and
     the routing choices that differ between the routes; then trained
     through ``make_train_step`` (bf16 over float32 masters, S=4096, 2 in
     2 microbatches, remat none, 3 steps: finite loss, aux and grad norm,
     ms a step, tokens/s, peak memory, 24 x 2 x 3 flash_attention
     launches); (d) internvl2-2b at full size, B=4 prompts of 256 patch
     embeddings and 3840 text tokens, 32 decode steps, the same numbers
     and launch counts; (e) hubert-xlarge at full size through
     ``make_encode_step``, B=4 clips of 1500 frame embeddings (48
     flash_attention launches an encode), encode ms and frames/s, one
     clip's logits held to the bf16 and float32 full routes as (c);
  12. the jitted trackers, the serving CLI, the examples and the
     whole-step shares: (a) ``make_jitted_tracker`` /
     ``make_jitted_imm_tracker`` (the frame captured once in a
     ``torch.cuda.CUDAGraph`` and replayed) over phase 3's scene for lkf,
     ekf and imm, every frame's every tensor bit for bit with the eager
     frame step on the card, one capture, one frame launch (and one
     greedy) a frame, and the host ms a frame of the replayed and the
     eager step, each ending in a sync; then torch.profiler's events of
     50 replays of each tracker in one fresh process, one event of each
     kernel of the frame a replay, as many as the launches counted; (b) ``repro_torch.launch.serve``'s
     ``main`` on the card for lkf and ekf, its confirmed counts equal to
     the same call on the CPU; (c) ``examples/torch_tracking_pipeline.py``,
     ``torch_mot_demo.py`` and ``torch_serve_lm.py`` at their defaults on
     the card; (d) every whole step of phases 7, 8, 10 and 11 against the
     card's peaks (``roofline.analysis.MACHINES["h100"]``): its model FLOPs
     (``models/counting.py``) and mfu (FLOPs / (host s x bf16 peak)), and
     for the decode steps the analytic bytes (``roofline/memmodel.py``),
     their bound at the HBM rate and the share of it reached;
  13. the mesh: granite-moe-1b-a400m on a ('data' 2, 'model' 2) mesh of
     4 ranks (``repro_torch.launch.local_world``), every rank a process
     on the one card over a ``gloo`` group (its collectives staged through
     host buffers but ``all_reduce``): (a) the B=8 x S=4096 bf16 prefill
     (24 flash_attention launches a rank; serving's weights not
     FSDP-split, training's are), the logits
     within max(2^-8, 2x) the single card's bf16 distance from its float32
     run on the same weights; (b) 32 decode steps on the sequence-split
     cache (flash_decode_partial on each rank's block, the partials
     merged), teacher-forced with the single card's tokens, in the "gather"
     and "tp2d" moe modes, each step to the same limit, 24 x 32
     flash_decode launches a rank and mode, and rank 0's
     flash_decode_partial on its block against the plain version; (c) 4
     of granite-moe's 24 layers trained in float32 (S=2048, batch 8 in 2
     microbatches), 2 steps, saved from the mesh, restored onto ('data'
     4, 'model' 1) bit for bit, one more step there: loss and grad norm
     within 1e-4 relative of the single card's 3 steps; (d)
     ``compressed_psum`` over the 4 ranks on 2^24 float32 values bit for
     bit with its plain version, its int8 wire bytes against a float32
     ring's; the ms a prefill, decode step and train step of each rank
     and its staged bytes, labelled as a correctness run;
  13b. the SSM mixer and the frontends on the same mesh, each against the
     single card's same call on the same weights: (a) mamba2-130m's bf16
     prefill of B=8 x S=8192 (24 ssd_scan launches a rank, each on the
     rank's 4 rows and 12 of 24 heads; rank 0's layer-0 call against the
     plain versions by phase 8's rule) and 32 teacher-forced decode steps
     on each rank's block of the SSM state (no launch); (b) mamba2-130m
     trained in float32 (S=2048, batch 8 in 2 microbatches, 2 steps, FSDP
     on): loss and grad norm within 1e-4 relative; (c) internvl2-2b served
     on 4 x (256 patch embeddings + 3,840 tokens), 32 decode steps (24
     flash_attention a prefill, 24 flash_decode_partial a step a rank);
     (d) hubert-xlarge encoding 4 x 1,500 frames (48 flash_attention a
     rank); every prefill, decode step and encode within max(2^-8, 2x) the
     single card's bf16 distance from float32; the ms of each step a rank
     and the bytes staged a rank, labelled as a correctness run;
  14. the tile table (kernels/katana_bank/autotune.py): (a) every
     instantiated tile of scan.cu (64, 128, 256 tracks a block; lkf, ekf,
     cv9 at both symmetrize values, with and without a valid stream, one
     track's seed P asymmetric among symmetric ones), imm_step.cu (64,
     128, 256 lanes; K = 1 in both layouts, K = 4; both symmetrize
     values) and imm_scan.cu (32, 64 tracks) bit for bit with the plain
     version over 17 frames, and every (tile, time chunk) the tuner races
     bit for bit with one launch over 300 frames, at N = 1,000 and
     131,072; (b) ``tune.tune`` at N = 131,072, T = 300 into a temporary
     table: every candidate's device ms, the winner against the static
     default's; (c) the checked-in table's row for this card at the
     replay size (or none: the static defaults) and ``ops.LAST_CONFIG``
     showing the launch used it, with the tabled and static configs'
     times of the four bank kernels (phases 2-5b ran at the tabled
     configs);
  then one JSON line with the kernel table (row flash_attention also
     carries the training launches; row flash_attention_bwd the backward
     at both shapes and types, its training launches and phase 11's; rows
     flash_attention, flash_decode and ssd_scan phase 11's launches, and
     the first two phase 11's shapes; rows katana_frame, katana_imm_frame
     and greedy_assign phase 12's; rows flash_attention and flash_decode
     phase 13's, and those and ssd_scan phase 13b's, summed over the
     ranks; rows katana_bank_sequence, katana_imm_sequence, katana_bank
     and katana_bank_imm their tabled lane_tile and time_chunk, and
     phase 14's tuned_ms and static_ms), then the status line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import katana as kcfg  # noqa: E402
from repro_torch.core import bank as bank_lib  # noqa: E402
from repro_torch.core import filters, tracker  # noqa: E402
from repro_torch.core import ref as oracle  # noqa: E402
from repro_torch.core import rewrites  # noqa: E402
from repro_torch.data import trajectories as traj  # noqa: E402
from repro_torch.data.lm import LMDataPipeline  # noqa: E402
from repro_torch import profiling  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.kernels.katana_bank import ops, ref  # noqa: E402
from repro_torch.kernels.katana_bank import autotune, tune  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.roofline.analysis import MACHINES  # noqa: E402
from repro_torch.serving import stream as stream_mod  # noqa: E402
from repro_torch.serving.engine import ShardedBankEngine  # noqa: E402
from repro_torch.serving.engine import TrackingEngine  # noqa: E402
from repro_torch.serving.faults import ChaosDriver, FaultPlan  # noqa: E402
from repro_torch.serving.stream import Admission, ServiceTier  # noqa: E402
from repro_torch.serving.stream import StreamConfig  # noqa: E402
from repro_torch.serving.stream import StreamFrontEnd  # noqa: E402
from repro_torch.sharding.rules import ShardingContext  # noqa: E402

# the live scene's frames: 300 until the script's clock ran 1,080 s of its
# 1,200 on a slow host (phase 3 224 s of it), now 150 (the first cut of
# depth a growing script takes)
C_SERVE, M_SERVE, T_SERVE = 1024, 256, 150
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the bf16
# dense tensor-core rate from the port's roofline preset, float32
# operations/s outside the tensor cores, and the TF32 dense tensor-core
# rate (the float32 backward's 3xTF32 products)
HBM_BPS = MACHINES["h100"].mem_bw
BF16_OPS = MACHINES["h100"].peak_flops
F32_OPS = 67e12
TF32_OPS = 495e12
# kernel vs its plain version (the same op stream: measured bitwise)
TOL = {"lkf": 1e-4, "ekf": 1e-4, "imm": 5e-4}
# Route check. The two float32 routes each carry their own rounding
# error against exact arithmetic, and at this scene's scale (positions
# up to ~200, velocities estimated over dt = 1/30 s, coasting covariance
# entries in the thousands) that error alone can exceed TOL, so their
# gap is printed, not held to TOL. Each state field of the fused route
# is held to the einsum route run in float64, by the largest
# |d| / max(1, |float64 value|) over the bank and the frames: within TOL,
# or at most ROUTE_SLACK times the float32 einsum route's own error.
ROUTE_SLACK = 2.0
WINDOW = 50  # frames per line of the printed per-window errors
REPLACES = {
    "katana_frame": "src/repro/kernels/katana_bank/kernel.py:1280 "
                    "(katana_frame_step -> pallas_call :1297)",
    "katana_imm_frame": "src/repro/kernels/katana_bank/kernel.py:1323 "
                        "(katana_imm_frame_step -> pallas_call :1341)",
    "greedy_assign": "src/repro/kernels/katana_bank/kernel.py:1371 "
                     "(greedy_assign_step -> pallas_call :1391)",
    "katana_bank_sequence": "src/repro/kernels/katana_bank/kernel.py:1171 "
                            "(katana_bank_scan_step -> pallas_call :1193)",
    "katana_imm_sequence": "src/repro/kernels/katana_bank/kernel.py:1217 "
                           "(katana_bank_imm_scan_step -> pallas_call :1258)",
    "katana_bank": "src/repro/kernels/katana_bank/kernel.py:1100 "
                   "(katana_bank_step -> pallas_call :1110)",
    "katana_bank_imm": "src/repro/kernels/katana_bank/kernel.py:1132 "
                       "(katana_bank_imm_step -> pallas_call :1146)",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85 "
                       "(flash_attention_bhsd -> pallas_call :97)",
    "flash_attention_bwd": "src/repro/kernels/flash_attention/ops.py:53 "
                           "(_bwd of the custom_vjp; jnp, no pallas_call)",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:60 "
                    "(flash_decode_partial -> pallas_call :71)",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:59 "
                "(ssd_scan_bhsp -> pallas_call :69)",
}
_CSRC = "src/repro_torch/kernels/katana_bank/csrc/"
SOURCES = {
    "katana_frame": _CSRC + "frame.cu",
    "katana_imm_frame": _CSRC + "imm_frame.cu",
    "greedy_assign": _CSRC + "greedy.cu",
    "katana_bank_sequence": _CSRC + "scan.cu",
    "katana_imm_sequence": _CSRC + "imm_scan.cu",
    "katana_bank": _CSRC + "imm_step.cu",
    "katana_bank_imm": _CSRC + "imm_step.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention_bwd.cu",
    "flash_decode": "src/repro_torch/kernels/flash_decode/csrc/"
                    "flash_decode.cu",
    "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, spin: bool = False) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls.
    With ``spin`` the device first spins for ~50 ms, so the calls queue
    up behind it and the events time the device's own work, not the
    host's pace of launching it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(100_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _short(count, launches, iters):
    """{part: {kernel name: events}} for each part of a kernel name in
    ``launches`` ({part: launches a call}) whose kernels show another
    number of events than ``iters`` calls launched; empty when whole."""
    short = {}
    for part, n in (launches or {}).items():
        got = {k: c for k, c in count.items() if part in k}
        if not got or any(c != n * iters for c in got.values()):
            short[part] = got
    return short


def device_ms(fn, iters: int = 20, launches=None):
    """(device milliseconds per call by kernel name, from the kernel
    events of a torch.profiler session, and the events missing from them
    (``_short``), printed with each time read here). Called in a fresh
    process (``fresh_profile``): later sessions of a long process lose
    some or all of their kernel events (PERF.md §7)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(profiling.ACTIVITIES)) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms, count = profiling.kernel_events(prof)
    return ({k: v / iters for k, v in ms.items()},
            _short(count, launches, iters))


SERVE_WORKER = profiling.Worker(path=ROOT)


def fresh_profile(job, tensors, **spec):
    """One profiled job (``profile_job``) in a child process
    (``repro_torch.profiling``): later torch.profiler sessions of the long
    main process lose kernel events (PERF.md §7). The "serve" jobs of
    phases 7, 8 and 11 share one child, ``SERVE_WORKER``, whose nine
    sessions keep every event (``scripts/profiler_probe.py --serve``);
    the others run in a fresh process each. Returns the child's result:
    for "frame" and "ssd_scan" ``device_ms``'s pair, for "serve" {step:
    ``busy_profile``'s four values}, for "jitted" ``jitted_events``'s
    dict."""
    if job == "serve":
        return SERVE_WORKER.run("chip_smoke:profile_job", tensors, job=job,
                                **spec)
    return profiling.fresh("chip_smoke:profile_job", tensors, path=ROOT,
                           job=job, **spec)


def serve_profiles(spec, batch):
    """The "serve" job: ``spec["arch"]`` at full size with seed 0's bf16
    weights (as every serving phase draws them) on attn_impl "flash", one
    warm-up call, then ``busy_profile`` of one prefill and of the decode
    step after it (an encoder-only arch: one encode)."""
    from repro_torch.launch.steps import make_encode_step

    cfg = get_config(spec["arch"])
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    ctx = ShardingContext(attn_impl="flash")
    if cfg.is_encoder_only:
        encode = make_encode_step(cfg, ctx)
        encode(params, batch)
        return {"encode": busy_profile(lambda: encode(params, batch))}
    prefill, decode = make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
    prefill(params, batch)
    got = {}
    out = {"prefill": busy_profile(
        lambda: got.update(step=prefill(params, batch)))}
    logits, caches = got["step"]
    S = spec["S"]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    logits, caches = decode(params, {"token": tok, "cache_pos": S}, caches)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out["decode_step"] = busy_profile(lambda: decode(
        params, {"token": tok, "cache_pos": S + 1}, caches))
    return out


def profile_job(tensors, job, **spec):
    """The child's side of ``fresh_profile``: run ``job`` on ``tensors``
    (loaded onto the card)."""
    if job == "frame":
        kind = spec["kind"]
        model = (filters.make_imm() if kind == "imm"
                 else filters.get_filter(kind))
        fn = ops.katana_imm_frame if kind == "imm" else ops.katana_frame
        return device_ms(lambda: fn(model, *tensors), spec["iters"],
                         spec["launches"])
    if job == "ssd_scan":
        args, kw = tensors
        return device_ms(lambda: ssd_ops.ssd_scan(*args, **kw),
                         spec["iters"], spec["launches"])
    if job == "jitted":
        return jitted_events(tensors, spec["replays"])
    return serve_profiles(spec, tensors)


def event_pairs_ms(call, n: int = 50) -> float:
    """Mean ms between the two CUDA events that ``call(events)`` has the
    device record around a part of its work, over n calls (each its own
    pair, read after one synchronise). The device first spins for ~50 ms,
    so the calls queue up behind it and the events time the device's own
    work, not the host's pace of launching it."""
    def pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    call(pair())
    pairs = [pair() for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # clock cycles
    for evs in pairs:
        call(evs)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


FRAME_LAUNCHES = ("predict", "cost", "greedy", "update")
# the greedy's two kernels in a frame, by name part
GREEDY_KERNELS = ("greedy_candidates<katana::FrameTile>",
                  "greedy_candidate_waves")


def launch_events_ms(call, n: int = 50):
    """Mean device ms of each of a live frame's launches and of the
    whole frame, over n calls: ``call(events)`` has the device record five
    CUDA events, before its predict and after the predict, the cost tile,
    the greedy and the update. The device first spins for ~50 ms, so the
    calls queue up behind it and the events time the device's own work."""
    def five():
        return [torch.cuda.Event(enable_timing=True) for _ in range(5)]

    call(five())
    sets = [five() for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # clock cycles
    for evs in sets:
        call(evs)
    torch.cuda.synchronize()
    out = {nm: sum(e[i].elapsed_time(e[i + 1]) for e in sets) / n
           for i, nm in enumerate(FRAME_LAUNCHES)}
    out["frame"] = sum(e[0].elapsed_time(e[4]) for e in sets) / n
    out["events"] = n
    return out


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _rel(a, ref) -> float:
    """max |a - ref| / max |ref|: a distance on the values' scale."""
    return max_diff(a, ref) / float(ref.double().abs().max())


def max_rel(a, ref) -> float:
    """Largest |a - ref| / max(1, |ref|)."""
    ref = ref.double()
    return float(((a.double() - ref).abs() / ref.abs().clamp_min(1.0)).max())


# ---------------------------------------------------------------------------
# Least time for the work: bytes each input read once + each output written
# once over HBM, vs the float32 operations these inputs need over the peak.
# The operations are counted on the plain versions' op stream (ref.py, zero
# terms of F/Q/R pruned) and scaled by what this frame's data needs: the
# predict for each active track, the cost for each active x valid pair, the
# greedy's two argmin comparisons per such pair per wave run, the update
# for each assigned track.
# ---------------------------------------------------------------------------

class OpCount(TorchDispatchMode):
    """Counts the float operations of the torch ops run inside it: one
    per output element of each arithmetic op (``1.0 / x``, which torch
    runs as a reciprocal times 1.0, counts once)."""
    ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "exp",
             "log", "sin", "cos", "maximum", "minimum", "clamp_min"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        unit = (name == "mul" and len(args) == 2
                and isinstance(args[1], float) and args[1] == 1.0)
        if name in self.ARITH and not unit:
            self.ops += out.numel()
        return out


def _lanes(*shape):
    return [torch.rand(1) for _ in range(int(np.prod(shape)))]


def _square(n, lanes):
    return [[lanes[i * n + j] for j in range(n)] for i in range(n)]


def stream_ops(model, symmetrize=True):
    """Float operations of the frame's op stream (ref.py) per active
    track, per (active track, valid measurement) pair and per assigned
    track, for a FilterModel or a K>1 IMMModel (``symmetrize=False``:
    the full square's)."""
    n, m = model.n, model.m
    imm = isinstance(model, filters.IMMModel)
    obs = ref.check_selector(model.models[0] if imm else model)
    z = torch.rand(1, m)
    if imm:
        K = model.K
        entries, V = ref.plan_imm_tables(model.models)
        tabv = [torch.as_tensor(row, dtype=torch.float32) for row in V]
        Ftab, Qtab, Rtab = ([[c if isinstance(c, float) else tabv[c[1]]
                              for c in row] for row in entries[nm]]
                            for nm in ("F", "Q", "R"))
        Pi = [[float(v) for v in row] for row in np.asarray(model.trans)]
        xv = [torch.rand(K) for _ in range(n)]
        P = _square(n, [torch.rand(K) for _ in range(n * n)])
        mu = torch.full((K,), 1.0 / K)
        with OpCount() as track:
            x_mix, P_mix, cbar = ref._imm_mix(xv, P, mu, Pi, n, K, 1,
                                              symmetrize)
            xp = ref._matvec(Ftab, x_mix, n)
            Pp = ref._predict_cov(Ftab, P_mix, Qtab, n, symmetrize)
            inno = ref._innovation(Pp, Rtab, obs, n, m)
            # the combined estimate x_c of every track
            for d in range(n):
                ref._dot(cbar, [xp[d][k:k + 1] for k in range(K)], K)
        with OpCount() as pair:
            d = ref.cost_tile([xp[o] for o in obs], inno[1], z, m)
            ref._dot(cbar, [d[:, k] for k in range(K)], K)
        with OpCount() as upd:
            ll = ref._update(xp, Pp, [z[0, r].expand(K) for r in range(m)],
                             obs, n, m, inno, True, symmetrize)[2]
            ref._mode_posterior(cbar, ll, K, 1)
    else:
        R = [[float(v) for v in row] for row in np.asarray(model.R)]
        with OpCount() as track:
            xp, Pp = ref._predict_single(model, _lanes(n),
                                         _square(n, _lanes(n, n)),
                                         symmetrize)
            inno = ref._innovation(Pp, R, obs, n, m)
        with OpCount() as pair:
            ref.cost_tile([xp[o] for o in obs], inno[1], z, m)
        with OpCount() as upd:
            ref._update(xp, Pp, [z[0, r:r + 1] for r in range(m)], obs, n, m,
                        inno, False, symmetrize)
    # + the gate test of each pair
    return track.ops, pair.ops + 1, upd.ops


def frame_work(model, C, M, n_active, n_valid, n_assigned, waves,
               symmetrize=True):
    """(bytes, operations) of one frame call on this frame's data
    (``symmetrize=False``: the full square's operations)."""
    n, m, f = model.n, model.m, 4
    K = getattr(model, "K", 1)
    nbytes = (2 * K * C * (n + n * n) * f + M * m * f + M + C + C * f)
    if K > 1:
        nbytes += 2 * C * K * f + C * n * f  # mu in and out, x_c out
    per_track, per_pair, per_assigned = stream_ops(model, symmetrize)
    pairs = n_active * n_valid
    ops = (n_active * per_track + pairs * per_pair + 2 * pairs * waves
           + n_assigned * per_assigned)
    return nbytes, ops


def greedy_work(C, n_active, n_valid, gated, waves):
    """The frame's greedy: the active x valid cost entries read once,
    assoc out; two argmin comparisons per gated pair per wave run."""
    return n_active * n_valid * 4 + C * 4, 2 * gated * waves


def both_bounds(nbytes, ops) -> str:
    return (f"{nbytes} B = {nbytes / HBM_BPS * 1e3:.4f} ms, {ops} ops = "
            f"{ops / F32_OPS * 1e3:.4f} ms")


def bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------

def random_bank(rng, n, m, C, M, obs, K=None, spread=100.0):
    """C tracks (70% active), M measurements, two thirds of them near a
    track's observed coordinates, as CUDA tensors."""
    x0 = rng.uniform(-spread, spread, (C, n))
    A = rng.normal(size=(K or 1, C, n, n)) * 0.3
    P = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)).astype(np.float32)
    z = rng.uniform(-spread, spread, (M, m))
    k = min(M, C) * 2 // 3
    z[:k] = x0[rng.permutation(C)[:k]][:, obs] + 0.3 * rng.normal(size=(k, m))
    dev = torch.device("cuda")
    out = dict(
        z=torch.as_tensor(z[rng.permutation(M)], dtype=torch.float32,
                          device=dev),
        z_valid=torch.as_tensor(rng.random(M) < 0.9, device=dev),
        active=torch.as_tensor(rng.random(C) < 0.7, device=dev))
    if K is None:
        out["x"] = torch.as_tensor(x0, dtype=torch.float32, device=dev)
        out["P"] = torch.as_tensor(P[0], device=dev)
    else:
        x = x0[None] + 0.05 * rng.normal(size=(K, C, n))
        out["x"] = torch.as_tensor(x, dtype=torch.float32, device=dev)
        out["P"] = torch.as_tensor(P, device=dev)
        out["mu"] = torch.as_tensor(
            rng.dirichlet(np.ones(K), size=C), dtype=torch.float32,
            device=dev)
    return out


def phase_kernels_vs_plain():
    """Every kernel against its plain version on the same CUDA tensors."""
    rng = np.random.default_rng(0)
    C, M = C_SERVE, M_SERVE
    errs = {}
    cost = np.round(rng.uniform(0, 20, (C, M)) * 2) / 2
    cost_t = torch.as_tensor(cost, dtype=torch.float32, device="cuda")
    valid_t = torch.as_tensor(rng.random((C, M)) > 0.3, device="cuda")
    a, wa = ops.katana_greedy_assign(cost_t, valid_t, 6.0, M,
                                     return_waves=True)
    b, wb = ref.greedy_assign_plain(cost_t, valid_t, 6.0, M,
                                    return_waves=True)
    assert torch.equal(a, b), "greedy kernel != plain"
    assert int(wa) == wb
    errs["greedy_assign"] = max_diff(a, b)
    print(f"greedy_assign C={C} M={M} ties: assoc identical, "
          f"{int((a >= 0).sum())} assigned in {wb} waves")

    frame_err = 0.0
    for kind in ("lkf", "ekf"):
        model = filters.get_filter(kind)
        obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
        bk = random_bank(rng, model.n, model.m, C, M, obs)
        args = (bk["x"], bk["P"], bk["z"], bk["z_valid"], bk["active"],
                11.34 if model.m == 3 else 13.28, M)
        got = ops.katana_frame(model, *args, return_waves=True)
        want = ref.katana_frame_plain(model, *args, return_waves=True)
        assert torch.equal(got[2], want[2]), f"{kind}: assoc differs"
        assert int(got[3]) == want[3], (kind, int(got[3]), want[3])
        dx, dP = max_diff(got[0], want[0]), max_diff(got[1], want[1])
        # the kernel runs the plain version's op stream: bit for bit
        assert torch.equal(got[0], want[0]), (kind, dx)
        assert torch.equal(got[1], want[1]), (kind, dP)
        frame_err = max(frame_err, dx, dP)
        inst = ops.pick_pattern((model,)).name
        print(f"katana_frame {kind} ({inst}) C={C} M={M}: assoc and "
              f"{want[3]} waves identical ({int((got[2] >= 0).sum())} "
              "assigned), x', P' bitwise equal")
    errs["katana_frame"] = frame_err

    imm_err = 0.0
    imm = filters.make_imm()
    bk = random_bank(rng, 9, 3, C, M, [0, 1, 2], K=4)
    args = (bk["x"], bk["P"], bk["mu"], bk["z"], bk["z_valid"],
            bk["active"], 11.34, M)
    got = ops.katana_imm_frame(imm, *args)
    want = ref.katana_imm_frame_plain(imm, *args)
    assert torch.equal(got[4], want[4]), "imm: assoc differs"
    d = [max_diff(g, w) for g, w in zip(got[:4], want[:4])]
    assert max(d) <= TOL["imm"], d
    # the kernel runs the plain version's op stream: bit for bit
    assert all(torch.equal(g, w) for g, w in zip(got[:4], want[:4])), d
    imm_err = max(d)
    print(f"katana_imm_frame K=4 C={C} M={M}: assoc identical "
          f"({int((got[4] >= 0).sum())} assigned), x, P, mu, x_c bitwise "
          "equal, max|d| = " + " ".join(f"{v:.3g}" for v in d))
    ekf = filters.get_filter("ekf")
    bk = random_bank(rng, 8, 4, C, M, [0, 1, 2, 4], K=1)
    args = (bk["x"], bk["P"], bk["mu"], bk["z"], bk["z_valid"],
            bk["active"], 13.28, M)
    got = ops.katana_imm_frame(filters.as_imm(ekf), *args)
    want = ref.katana_imm_frame_plain(filters.as_imm(ekf), *args)
    single = ops.katana_frame(ekf, bk["x"][0], bk["P"][0], *args[3:])
    assert torch.equal(got[4], want[4]), "imm K=1: assoc differs"
    assert torch.equal(got[0][0], single[0]) and torch.equal(got[1][0],
                                                               single[1])
    d = [max_diff(g, w) for g, w in zip(got[:4], want[:4])]
    assert max(d) <= TOL["ekf"], d
    imm_err = max(imm_err, *d)
    print(f"katana_imm_frame K=1 (ekf) C={C} M={M}: assoc identical, "
          f"bitwise equal to katana_frame, max|d| vs plain = {max(d):.3g}")
    errs["katana_imm_frame"] = imm_err
    torch.cuda.synchronize()
    return errs


def padded(meas, m, M):
    z = torch.zeros((M, m), dtype=torch.float32)
    v = torch.zeros((M,), dtype=torch.bool)
    k = min(len(meas), M)
    z[:k] = torch.as_tensor(meas[:k], dtype=torch.float32)
    v[:k] = True
    return z.cuda(), v.cuda()


def states(res):
    """The state fields of a FrameResult that the route check compares."""
    out = dict(x=res.bank.x, P=res.bank.P)
    if res.mode_probs is not None:
        out.update(mu=res.mode_probs, x_est=res.x_est)
    return out


def phase_main_path(kind):
    """The engine over the T_SERVE-frame scene, each frame held against the
    einsum route on the card (float32 and float64); then the times at
    this shape."""
    model = filters.make_imm() if kind == "imm" else filters.get_filter(kind)
    smodel = filters.get_filter("cv9") if kind == "imm" else model
    assert ops.frame_kernel_supported(model), kind
    cfg = tracker.TrackerConfig(capacity=C_SERVE, max_meas=M_SERVE)
    cfg_e = dataclasses.replace(cfg, fused_frame=False)
    cfg_64 = dataclasses.replace(cfg_e, dtype="float64")
    scene = traj.SceneConfig(T=T_SERVE, max_targets=200, birth_rate=1.0,
                             death_rate=0.002, clutter_rate=20.0,
                             extent=200.0, max_meas=M_SERVE)
    z, valid, _ = traj.mot_scene(smodel, scene, seed=7)
    is_imm = kind == "imm"
    step = tracker.imm_frame_step if is_imm else tracker.frame_step
    init = bank_lib.init_imm_bank if is_imm else bank_lib.init_bank
    name = "katana_imm_frame" if is_imm else "katana_frame"

    eng = TrackingEngine(model, cfg, device="cuda")
    bank_e = eng.bank
    bank_64 = init(model, C_SERVE, dtype=torch.float64, device="cuda")
    # per frame and state field, max_rel of: fused vs einsum32 (gap),
    # fused vs einsum64, einsum32 vs einsum64; the float64 route is
    # compared while its association stays identical
    gap, err_f, err_32 = {}, {}, {}
    lockstep_64 = T_SERVE
    confirmed, assigned = 0, 0
    # per frame: the kernel's greedy waves (device tensors, read after the
    # run) and the gated pairs of the float32 einsum route's cost tile,
    # the pairs the kernel's candidate list holds (the two routes' tiles
    # round alike: their assoc is held equal every frame)
    frame_waves, frame_pairs = [], []
    kernel = getattr(tracker, name)
    greedy_ref = tracker.greedy_assign

    def kernel_spy(*a, **kw):
        out = kernel(*a, return_waves=True, **kw)
        frame_waves.append(out[-1])
        return out[:-1]

    def greedy_spy(cost, valid, gate, rounds):
        if cost.dtype == torch.float32:
            frame_pairs.append((valid & (cost <= gate)).sum())
        return greedy_ref(cost, valid, gate, rounds)

    spies = (mock.patch.object(tracker, name, kernel_spy),
             mock.patch.object(tracker, "greedy_assign", greedy_spy))
    for spy in spies:
        spy.start()
    ops.reset_launches()
    for t in range(T_SERVE):
        meas = z[t][valid[t]].astype(np.float32)
        confirmed += len(eng.submit(meas))
        launches = dict(ops.LAUNCHES)
        zt, vt = padded(meas, model.m, M_SERVE)
        res = step(model, cfg_e, bank_e, zt, vt)
        bank_e = res.bank
        assert torch.equal(eng.last.assoc, res.assoc), (kind, t, "assoc")
        assert torch.equal(eng.bank.track_id, bank_e.track_id), (kind, t)
        assigned += int((res.assoc >= 0).sum())
        s_f, s_32 = states(eng.last), states(res)
        for f in s_f:
            gap.setdefault(f, []).append(max_rel(s_f[f], s_32[f]))
        if t < lockstep_64:
            r64 = step(model, cfg_64, bank_64, zt.double(), vt)
            if not torch.equal(r64.assoc, res.assoc):
                lockstep_64 = t
                continue
            bank_64, s_64 = r64.bank, states(r64)
            for f in s_f:
                err_f.setdefault(f, []).append(max_rel(s_f[f], s_64[f]))
                err_32.setdefault(f, []).append(max_rel(s_32[f], s_64[f]))
    for spy in spies:
        spy.stop()
    waves_f = [int(w) for w in frame_waves]
    pairs_f = [int(p) for p in frame_pairs]
    assert len(waves_f) == len(pairs_f) == T_SERVE, (len(waves_f),
                                                    len(pairs_f))
    print(f"[{kind}] greedy per frame: gated pairs mean "
          f"{np.mean(pairs_f):.1f} (min {min(pairs_f)}, max {max(pairs_f)}), "
          f"waves mean {np.mean(waves_f):.2f} (min {min(waves_f)}, max "
          f"{max(waves_f)}) over {T_SERVE} frames of C={C_SERVE} x "
          f"M={M_SERVE} = {C_SERVE * M_SERVE} entries")
    print(f"[{kind}] {T_SERVE} frames: launches {launches}; "
          f"assoc and track ids identical to the einsum route every frame; "
          f"the float64 einsum route's assoc identical for {lockstep_64} "
          "frames")
    assert launches[name] == T_SERVE and launches["greedy_assign"] == T_SERVE
    assert lockstep_64 > 0, kind

    def windows(v):
        return [max(v[i:i + WINDOW]) for i in range(0, len(v), WINDOW)]

    route = {}
    for f in gap:
        route[f] = dict(gap=windows(gap[f]), fused_vs_f64=windows(err_f[f]),
                        einsum_vs_f64=windows(err_32[f]))
        print(f"[{kind}] {f} max|d|/max(1,|ref|) per {WINDOW} frames: "
              + "; ".join(f"{k} " + " ".join(f"{v:.3g}" for v in vs)
                          for k, vs in route[f].items()))
        e_f, e_32 = max(err_f[f]), max(err_32[f])
        assert e_f <= max(TOL[kind], ROUTE_SLACK * e_32), (kind, f, e_f, e_32)
    fps = eng.stats.fps

    # times at this shape on the last frame's inputs (final bank)
    bank = eng.bank
    zt, vt = padded(z[T_SERVE - 1][valid[T_SERVE - 1]], model.m, M_SERVE)
    gate, rounds = tracker.CHI2_99[model.m], min(C_SERVE, M_SERVE)
    n_active, n_valid = int(bank.active.sum()), int(vt.sum())
    if is_imm:
        kargs = (bank.x, bank.P, bank.mu, zt, vt, bank.active, gate, rounds)
        kern = lambda: ops.katana_imm_frame(model, *kargs)  # noqa: E731
        plain = lambda: ref.katana_imm_frame_plain(model, *kargs)  # noqa
        out = ops.katana_imm_frame(model, *kargs, return_waves=True)
        n_assigned, waves = int((out[4] >= 0).sum()), int(out[5])
    else:
        kargs = (bank.x, bank.P, zt, vt, bank.active, gate, rounds)
        kern = lambda: ops.katana_frame(model, *kargs)  # noqa: E731
        plain = lambda: ref.katana_frame_plain(model, *kargs)  # noqa: E731
        out = ops.katana_frame(model, *kargs, return_waves=True)
        n_assigned, waves = int((out[2] >= 0).sum()), int(out[3])
    nb, nops = frame_work(model, C_SERVE, M_SERVE, n_active, n_valid,
                          n_assigned, waves)
    ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(plain, 3, warmup=1)
    einsum_ms = cuda_ms(lambda: step(model, cfg_e, bank, zt, vt), 3,
                        warmup=1)
    bms, by = bound(nb, nops)
    prof, prof_short = fresh_profile(
        "frame", kargs, kind=kind, iters=20,
        launches={k: 1 for k in GREEDY_KERNELS})
    greedy_prof = sum(v for k, v in prof.items()
                      if any(g in k for g in GREEDY_KERNELS))
    # the same from CUDA events the kernel records around its greedy
    greedy_ev = event_pairs_ms(lambda evs: (
        ops.katana_imm_frame if is_imm else ops.katana_frame)(
            model, *kargs, greedy_events=evs))
    # each launch's device time from events the frame records between its
    # launches, and its registers
    if is_imm:
        launch_ms = launch_events_ms(lambda evs: ops.katana_imm_frame(
            model, *kargs, launch_events=evs))
        inst = ops.pick_pattern(model.models).name
        source = "imm_frame.cu"
        entries = (("imm_predict", f"{len(inst)}{inst}ELi4ELb1E"),
                   ("imm_cost", "Lb0E"),
                   ("imm_update", f"{len(inst)}{inst}ELi4ELb0ELb1E"))
    else:
        launch_ms = launch_events_ms(lambda evs: ops.katana_frame(
            model, *kargs, launch_events=evs))
        inst = ops.pick_pattern((model,)).name
        source = "frame.cu"
        nl = "Lb0" if model.is_linear else "Lb1"
        entries = (("frame_predict", f"{len(inst)}{inst}E{nl}ELb1E"),
                   ("frame_cost", f"ILi{model.m}ELb0E"),
                   ("frame_update", f"ILi{model.n}ELi{model.m}ELb0ELb1E"))
    print(f"[{kind}] {name} ({inst}) device ms a launch by CUDA events "
          f"(mean of {launch_ms['events']} frames, device queued): "
          + ", ".join(f"{k} {launch_ms[k]:.4f}" for k in FRAME_LAUNCHES)
          + f"; the frame {launch_ms['frame']:.4f}")
    _print_ptxas_of(source, *entries)
    launch_regs = {e[0]: ptxas_registers(source, *e) for e in entries}
    with mock.patch.object(tracker, "greedy_assign", greedy_spy):
        step(model, cfg_e, bank, zt, vt)  # the gated pairs of these inputs
    gated = int(frame_pairs[-1])
    gb, gby = bound(*greedy_work(C_SERVE, n_active, n_valid, gated, waves))
    row = dict(frames=T_SERVE, fps=fps, ms_per_frame=1e3 / fps,
               mean_confirmed=confirmed / T_SERVE,
               mean_assigned=assigned / T_SERVE, kernel_ms=ms,
               plain_ms=plain_ms, einsum_frame_ms=einsum_ms, bound_ms=bms,
               bound_by=by, bytes=nb, operations=nops, waves=waves,
               active_last=n_active, valid_last=n_valid,
               assigned_last=n_assigned, launches=launches[name],
               greedy_launches=launches["greedy_assign"],
               greedy_device_ms=greedy_ev, greedy_profiler_ms=greedy_prof,
               greedy_profile_whole=not prof_short,
               greedy_bound_ms=gb, greedy_bound_by=gby,
               gated_pairs_per_frame=pairs_f, waves_per_frame=waves_f,
               float64_lockstep_frames=lockstep_64, route=route,
               device_ms=prof, launch_device_ms=launch_ms,
               launch_registers=launch_regs)
    print(f"[{kind}] fps={fps:.1f} ms/frame={1e3 / fps:.3f} "
          f"mean confirmed={confirmed / T_SERVE:.1f} | {name}: {ms:.4f} ms "
          f"(plain {plain_ms:.3f} ms, einsum frame {einsum_ms:.3f} ms, "
          f"bound {bms:.6f} ms by {by}: {nb} B, {nops} ops for "
          f"{n_active} active x {n_valid} valid, {n_assigned} assigned, "
          f"{waves} waves)")
    print(f"[{kind}] device ms per call: " + ", ".join(
        f"{k[:60]}={v:.4f}" for k, v in sorted(prof.items(),
                                                key=lambda kv: -kv[1])))
    whole = ("every launch's event recorded" if not prof_short else
             f"events missing: {prof_short} of 20 calls")
    print(f"[{kind}] the greedy inside the frame: {greedy_ev:.4f} ms by CUDA "
          f"events the kernel records around its launches (mean of 50 "
          f"frames), {greedy_prof:.4f} ms by torch.profiler (its two "
          f"kernels; {whole}); {gated} gated pairs, {waves} waves; bound "
          f"{gb:.6f} ms by {gby}")

    greedy = None
    if kind == "lkf":
        # the in-frame greedy's device time is the main path's; beside it
        # the plain greedy and the standalone kernel on this frame's cost
        # (the canonical (C, M) layout of tracker.mahalanobis_cost)
        bank_p, z_pred, _S, Sinv, _ = bank_lib.predict_bank(model, bank)
        cost = tracker.mahalanobis_cost(z_pred, Sinv, zt).contiguous()
        pv = (bank.active[:, None] & vt[None, :]).contiguous()
        a, w = ops.katana_greedy_assign(cost, pv, gate, rounds,
                                        return_waves=True)
        b, wb = ref.greedy_assign_plain(cost, pv, gate, rounds,
                                        return_waves=True)
        assert torch.equal(a, b) and int(w) == wb
        g_ms = cuda_ms(lambda: ops.katana_greedy_assign(cost, pv, gate,
                                                        rounds), 50)
        g_plain = cuda_ms(lambda: ref.greedy_assign_plain(cost, pv, gate,
                                                          rounds), 3,
                          warmup=1)
        greedy = dict(kernel_ms=row["greedy_device_ms"], plain_ms=g_plain,
                      bound_ms=gb, bound_by=gby, waves=waves,
                      profiler_ms=row["greedy_profiler_ms"],
                      standalone_ms=g_ms, standalone_waves=wb)
        print(f"[lkf] greedy_assign in the frame: {greedy['kernel_ms']:.4f} "
              f"ms device (plain {g_plain:.3f} ms, bound {gb:.6f} ms by "
              f"{gby}, {waves} waves); standalone kernel on the (C, M) cost "
              f"{g_ms:.4f} ms")
    return row, greedy, eng


# ---------------------------------------------------------------------------
# Phase 3b: the sensor fleet (ShardedBankEngine) at the reference's S = 8
# sensors (benchmarks/frame.py's sharded rows, batching.py's imm_sensors),
# each at phase 3's per-sensor shape (C = 1,024, M = 256, the dense-sky
# scene; sensor s of seed 7 + s). T = 150 frames, as phase 3's. The fleet
# replay runs phase 4's T = 300 over S x C = 8,192 lanes.
# ---------------------------------------------------------------------------

S_FLEET, T_FLEET, T_FLEET_REPLAY = 8, 150, 300
FLEET_DROP = 0.3   # share of the fleet replay's (frame, slot) entries invalid


def fleet_scene(kind):
    """(z (T, S, M, m) float32, valid (T, S, M)) numpy: sensor s sees
    phase 3's dense-sky scene drawn from seed 7 + s."""
    smodel = (filters.get_filter("cv9") if kind == "imm"
              else filters.get_filter(kind))
    scene = traj.SceneConfig(T=T_FLEET, max_targets=200, birth_rate=1.0,
                             death_rate=0.002, clutter_rate=20.0,
                             extent=200.0, max_meas=M_SERVE)
    per = [traj.mot_scene(smodel, scene, seed=7 + s)[:2]
           for s in range(S_FLEET)]
    return (np.stack([p[0] for p in per], 1).astype(np.float32),
            np.stack([p[1] for p in per], 1))


def fleet_equal(res, singles, axes):
    """Every state field of a fleet FrameResult against S single-sensor
    FrameResults, bit for bit: assoc, confirmed, unassigned, the bank
    (ids, counters, x, P, mu) and x_est."""
    for a, name in zip(axes, res.bank._fields):
        got = getattr(res.bank, name)
        want = torch.stack([getattr(r.bank, name) for r in singles], a)
        assert torch.equal(got, want), name
    for f in ("assoc", "confirmed", "unassigned", "mode_probs", "x_est"):
        got = getattr(res, f)
        if got is not None:
            assert torch.equal(got, torch.stack([getattr(r, f)
                                                 for r in singles])), f


def fleet_memory(model, S, C, M):
    """Bytes of the fleet's P, of its (S, M, C) cost tile and of the
    greedy's S candidate lists (ops._greedy_scratch)."""
    K = getattr(model, "K", 1)
    return dict(P=4 * K * S * C * model.n ** 2, cost_tile=4 * S * M * C,
                greedy_scratch=(12 * C * M + 4) * S)


def phase_fleet(kind, single):
    """ShardedBankEngine over S = 8 sensors for T = 150 frames: each fleet
    frame bit for bit with S single-sensor steps on the card (the imm
    fleet also split over two shards of the one card), waves per sensor;
    then a fresh fleet timed over the scene (fleet frames/s on the host
    clock, one launch count a frame), each launch's device time at S = 8,
    its bound, ptxas lines, and the fleet replay (one launch over S x C
    lanes) bit for bit with per-sensor katana_imm_sequence calls."""
    t_phase = time.perf_counter()
    model = replay_model(kind)
    is_imm = kind == "imm"
    S, C, M, T = S_FLEET, C_SERVE, M_SERVE, T_FLEET
    cfg = tracker.TrackerConfig(capacity=C, max_meas=M)
    z, valid = fleet_scene(kind)
    step = tracker.imm_frame_step if is_imm else tracker.frame_step
    init = bank_lib.init_imm_bank if is_imm else bank_lib.init_bank
    name = "katana_imm_frame" if is_imm else "katana_frame"
    kernel = getattr(tracker, name)
    axes = bank_lib.bank_sensor_axes(init(model, 1, device="cuda"))

    # 1. the checked run
    eng = ShardedBankEngine(model, S, cfg, devices=("cuda",))
    two = (ShardedBankEngine(model, S, cfg, devices=("cuda", "cuda"))
           if is_imm else None)
    singles = [init(model, C, device="cuda") for _ in range(S)]
    waves = []

    def spy(*a, **kw):
        out = kernel(*a, return_waves=True, **kw)
        waves.append(torch.as_tensor(out[-1]).reshape(-1))
        return out[:-1]

    wave_rows = []
    with mock.patch.object(tracker, name, spy):
        for t in range(T):
            n0 = len(waves)
            res = eng.frame(z[t], valid[t])
            fleet_w = waves[n0]
            if two is not None:
                n1 = len(waves)
                res2 = two.frame(z[t], valid[t])
                split_w = torch.cat(waves[n1:])
                assert all(torch.equal(a, b) for a, b in zip(res2.bank,
                                                             res.bank))
                for f in ("assoc", "confirmed", "mode_probs", "x_est"):
                    assert torch.equal(getattr(res2, f), getattr(res, f)), f
            n2 = len(waves)
            outs = []
            for s in range(S):
                r = step(model, cfg, singles[s],
                         torch.from_numpy(z[t, s]).cuda(),
                         torch.from_numpy(valid[t, s]).cuda())
                singles[s] = r.bank
                outs.append(r)
            fleet_equal(res, outs, axes)
            wave_rows.append((fleet_w, torch.cat(waves[n2:]),
                              split_w if two is not None else fleet_w))
    fw = torch.stack([w[0] for w in wave_rows]).cpu()
    assert fw.shape == (T, S), fw.shape
    assert torch.equal(fw, torch.stack([w[1] for w in wave_rows]).cpu())
    assert torch.equal(fw, torch.stack([w[2] for w in wave_rows]).cpu())
    t_check = time.perf_counter() - t_phase
    print(f"[fleet {kind}] S={S} x C={C}, M={M}, T={T}: every fleet frame "
          f"bit for bit with {S} single-sensor {step.__name__} calls on the "
          "card (assoc, ids, counters, x, P"
          + (", mu, x_est" if is_imm else "") + "); greedy waves per "
          f"sensor equal the single-sensor ones (mean by sensor "
          + " ".join(f"{v:.2f}" for v in fw.double().mean(0).tolist())
          + ")" + ("; two shards on the one card bit for bit with one"
                   if is_imm else "") + f" ({t_check:.1f} s)")

    # 2. the timed run: a fresh fleet over the same scene
    timed = ShardedBankEngine(model, S, cfg, devices=("cuda",))
    ops.reset_launches()
    t0 = time.perf_counter()
    for t in range(T):
        res = timed.frame(z[t], valid[t])
    host_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    assert launches[name] == T and launches["greedy_assign"] == T, launches
    assert all(torch.equal(a, b) for a, b in zip(timed.banks, eng.banks))
    fps = T / host_s
    # one sensor the same way: sensor 0's scene through TrackingEngine.submit
    # back to back (phase 3 times its frames between its route checks)
    solo = TrackingEngine(model, cfg, device="cuda")
    t0 = time.perf_counter()
    for t in range(T):
        solo.submit(z[t, 0][valid[t, 0]])
    solo_fps = T / (time.perf_counter() - t0)
    limit = 300.0
    verdict = "meets" if fps >= limit else "MISSES"
    print(f"[fleet {kind}] {T} fleet frames: launches {launches} (one a "
          f"fleet frame, not {S}); {fps:.1f} fleet frames/s, "
          f"{fps * S:.1f} sensor-frames/s, {1e3 / fps:.3f} ms a fleet frame "
          f"(host clock over the loop; engine's own {timed.stats.fps:.1f}); "
          f"one sensor back to back {solo_fps:.1f} FPS (engine's own "
          f"{solo.stats.fps:.1f}): {fps / solo_fps:.3f}x; phase 3's "
          f"{single['fps']:.1f} FPS: {fps / single['fps']:.3f}x; each "
          f"sensor {fps:.1f} FPS {verdict} the >= {limit:.0f} FPS limit")

    # 3. the fleet frame's kernel at S = 8 on the final banks and the last
    # frame's measurements
    banks = timed.banks
    zt = torch.from_numpy(z[T - 1]).cuda()
    vt = torch.from_numpy(valid[T - 1]).cuda()
    gate, rounds = tracker.CHI2_99[model.m], min(C, M)
    if is_imm:
        kargs = (banks.x, banks.P, banks.mu, zt, vt, banks.active, gate,
                 rounds)
        kfn, pfn = ops.katana_imm_frame, ref.katana_imm_frame_plain
    else:
        kargs = (banks.x, banks.P, zt, vt, banks.active, gate, rounds)
        kfn, pfn = ops.katana_frame, ref.katana_frame_plain
    out = kfn(model, *kargs, return_waves=True)
    want, plain_ms = timed_once(lambda: pfn(model, *kargs,
                                            return_waves=True))
    assert all(torch.equal(a, b) for a, b in zip(out[:-1], want[:-1]))
    fwaves = [int(w) for w in out[-1]]
    assert fwaves == want[-1]
    assoc = out[-2]
    nb, nops = 0, 0
    for s in range(S):
        b, o = frame_work(model, C, M, int(banks.active[s].sum()),
                          int(vt[s].sum()), int((assoc[s] >= 0).sum()),
                          fwaves[s])
        nb, nops = nb + b, nops + o
    bms, by = bound(nb, nops)
    ms = cuda_ms(lambda: kfn(model, *kargs), 50)
    launch_ms = launch_events_ms(lambda evs: kfn(model, *kargs,
                                                 launch_events=evs))
    one = single["launch_device_ms"]
    print(f"[fleet {kind}] {name} at S={S}: plain {plain_ms:.3f} ms, bit "
          f"for bit; {ms:.4f} ms a call at the host's pace; device ms a "
          f"launch by CUDA events (mean of {launch_ms['events']} frames, "
          "device queued): " + ", ".join(
              f"{k} {launch_ms[k]:.4f} (one sensor {one[k]:.4f})"
              for k in FRAME_LAUNCHES)
          + f"; the fleet frame {launch_ms['frame']:.4f} (one sensor "
          f"{one['frame']:.4f}); bound {bms:.6f} ms by {by} ({nb} B, "
          f"{nops} ops for waves {fwaves})")
    mem = fleet_memory(model, S, C, M)
    print(f"[fleet {kind}] memory: P {mem['P'] / 1e6:.1f} MB, cost tile "
          f"{mem['cost_tile'] / 1e6:.1f} MB, greedy scratch "
          f"{mem['greedy_scratch'] / 1e6:.1f} MB")
    if is_imm:
        inst = ops.pick_pattern(model.models).name
        source = "imm_frame.cu"
        entries = (("imm_cost", "Lb1E"),
                   ("imm_update", f"{len(inst)}{inst}ELi4ELb1ELb1E"),
                   ("greedy_candidates", "FleetTile"))
    else:
        source = "frame.cu"
        entries = (("frame_cost", f"ILi{model.m}ELb1E"),
                   ("frame_update", f"ILi{model.n}ELi{model.m}ELb1ELb1E"),
                   ("greedy_candidates", "FleetTile"))
    print(f"[fleet {kind}] ptxas of the S-aware kernels (Fleet = true; the "
          "predict and the waves are the single-sensor ones):")
    _print_ptxas_of(source, *entries)
    regs = {e[0]: ptxas_registers(source, *e) for e in entries}

    # 4. the fleet replay from the checked fleet's live banks
    imm1 = filters.as_imm(model)
    Tr = T_FLEET_REPLAY
    # the first S x C lanes of phase 4's stream (drawn once for both)
    zs = replay_stream(kind)[0][:Tr, :S * C].reshape(Tr, S, C, model.m)
    vmask = np.random.default_rng(23).random((Tr, S, C)) >= FLEET_DROP
    zs = np.where(vmask[..., None], zs, np.nan).astype(np.float32)
    before = [t.clone() for t in eng.banks]
    ops.reset_launches()
    t0 = time.perf_counter()
    xs = eng.replay(zs, vmask)
    replay_ms = (time.perf_counter() - t0) * 1e3
    r_launches = dict(ops.LAUNCHES)
    assert r_launches["katana_imm_sequence"] == chunk_launches(
        "katana_imm_sequence", Tr), r_launches
    r_tile = ops.LAST_CONFIG["katana_imm_sequence"]["lane_tile"]
    assert all(torch.equal(a, b) for a, b in zip(before, eng.banks))
    assert np.isfinite(xs).all()
    zs_t, v_t = torch.from_numpy(zs).cuda(), torch.from_numpy(vmask).cuda()
    for s in range(S):
        b1 = bank_lib.slice_sensor_bank(eng.banks, s)
        want = ops.katana_imm_sequence(imm1, zs_t[:, s].contiguous(), b1.x,
                                       b1.P, mu0=b1.mu if is_imm else None,
                                       valid=v_t[:, s].contiguous())
        assert torch.equal(torch.from_numpy(xs[:, s]), want.cpu()), s
    src = "imm_scan.cu" if is_imm else "scan.cu"
    print(f"[fleet {kind}] replay (T={Tr}, {S} x {C} = {S * C} lanes, "
          f"{FLEET_DROP:.0%} of the entries invalid, NaN): "
          f"{r_launches['katana_imm_sequence']} katana_imm_sequence "
          f"launch(es) ({src}, {r_tile} tracks a block), bit for bit with "
          f"{S} "
          f"per-sensor calls; {replay_ms:.1f} ms numpy in to numpy out; live "
          "banks unchanged")
    phase_s = time.perf_counter() - t_phase
    print(f"[fleet {kind}] phase 3b part: {phase_s:.1f} s")
    return dict(sensors=S, frames=T, fleet_fps=fps, sensor_frames_per_s=fps
                * S, ms_per_fleet_frame=1e3 / fps, engine_fps=timed.stats.fps,
                single_fps=single["fps"], solo_fps=solo_fps,
                solo_engine_fps=solo.stats.fps, fps_ratio=fps / solo_fps,
                limit_fps=limit, meets_limit=fps >= limit,
                launches=launches[name],
                greedy_launches=launches["greedy_assign"],
                kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=nb, operations=nops, waves_last=fwaves,
                mean_waves_by_sensor=fw.double().mean(0).tolist(),
                launch_device_ms=launch_ms, registers=regs, memory=mem,
                replay_launches=r_launches["katana_imm_sequence"],
                replay_ms=replay_ms, replay_frames=Tr, replay_lanes=S * C,
                seconds=phase_s)


# ---------------------------------------------------------------------------
# Offline replay (TrackingEngine.replay -> the replay scans) and the
# per-frame bank steps, at the pod batch of katana-lkf-pod / katana-ekf-pod
# (the port's configs/katana.py: N = 131,072) over T = 300 frames (10 s at
# 30 FPS).
# ---------------------------------------------------------------------------

N_REPLAY, T_REPLAY = kcfg.LKF_POD.batch, 300
N_BASE = 1024      # targets the generators draw; lanes tile them
N_SAMPLE = 64      # tracks held against the float64 oracle every frame
SMALL = (5, 17)    # (N, T) of the small-shape kernel checks
DROP = 0.1         # share of (frame, track) entries invalid in the checks
REF_HORIZON = 48   # frames of the reference's driver-vs-scan test
DEV = "cuda"
_ORACLE = {}       # kind -> (sample lanes, float64 xs, float32 xs)


def replay_model(kind):
    return filters.make_imm() if kind == "imm" else filters.get_filter(kind)


_STREAMS = {}


def replay_stream(kind, N=None, T=None):
    """(zs (T, N, m) float32, x0 (N, n), P0 (N, n, n)) numpy: lane k
    follows target k % N_BASE of the port's seeded generators
    (``batched_targets`` for lkf/ekf, ``maneuvering_batch`` for imm),
    measured with its own seeded noise of the model's measurement
    sigma; x0/P0 are the model's prior (the engine's default seeds)."""
    N, T = N or N_REPLAY, T or T_REPLAY
    key = (kind, N, T)
    if key not in _STREAMS:
        model = replay_model(kind)
        nb = min(N, N_BASE)
        if kind == "imm":
            truth, _ = traj.maneuvering_batch(T, nb, seed=5)
            obs, sigma = [0, 1, 2], 0.3
        else:
            truth, _ = traj.batched_targets(model, T, nb, seed=5)
            obs = ref.check_selector(model)
            sigma = np.sqrt(np.diag(model.R))
        pos = truth[:, :, obs].astype(np.float32)
        rng = np.random.default_rng(11)
        zs = np.ascontiguousarray(np.tile(pos, (1, -(-N // nb), 1))[:, :N])
        zs += (np.asarray(sigma, np.float32)
               * rng.standard_normal(zs.shape, dtype=np.float32))
        x0 = np.tile(model.x0, (N, 1)).astype(np.float32)
        P0 = np.tile(model.P0, (N, 1, 1)).astype(np.float32)
        _STREAMS[key] = (zs, x0, P0)
    return _STREAMS[key]


def dev_(*arrays):
    return [torch.as_tensor(a).to(DEV) for a in arrays]


def ops_of(fn) -> int:
    with OpCount() as c:
        fn()
    return c.ops


def scan_work(model, N, T, symmetrize=True):
    """(bytes, operations) of one replay of T frames for N tracks: zs in,
    the seeds in, xs and the finals out (IMM: x and P per model, mu in
    and out); operations per track-frame counted on the plain op stream
    at one track (``symmetrize=False``: the full square's)."""
    n, m, f = model.n, model.m, 4
    imm = isinstance(model, filters.IMMModel)
    K = model.K if imm else 1
    nbytes = (T * N * m + T * N * n + 2 * K * N * (n + n * n)) * f
    x1 = torch.as_tensor(np.asarray(model.x0), dtype=torch.float32)
    P1 = torch.as_tensor(np.asarray(model.P0), dtype=torch.float32)
    z1 = torch.zeros((1, 1, m))
    if imm:
        nbytes += 2 * N * K * f
        mu1 = torch.as_tensor(np.asarray(model.mu0),
                              dtype=torch.float32)[None]
        per = ops_of(lambda: ref.katana_bank_imm_scan_plain(
            model, x1.expand(K, 1, n), P1.expand(K, 1, n, n), mu1, z1,
            symmetrize=symmetrize))
    else:
        per = ops_of(lambda: ref.katana_bank_scan_plain(
            model, x1[None], P1[None], z1, symmetrize=symmetrize))
    return nbytes, per * N * T


def step_work(model, N, symmetrize=True):
    """(bytes, operations) of one bank step (IMM: K lanes a track, loglik
    out; ``symmetrize=False``: the full square's operations)."""
    n, m, f = model.n, model.m, 4
    imm = isinstance(model, filters.IMMModel)
    K = model.K if imm else 1
    nbytes = (2 * K * N * (n + n * n) + N * m + (K * N if imm else 0)) * f
    x1 = torch.as_tensor(np.asarray(model.x0), dtype=torch.float32)
    P1 = torch.as_tensor(np.asarray(model.P0), dtype=torch.float32)
    z1 = torch.zeros((1, m))
    if imm:
        per = ops_of(lambda: ref.katana_bank_imm_step_plain(
            model, x1.expand(K, 1, n), P1.expand(K, 1, n, n), z1,
            symmetrize))
    else:
        per = ops_of(lambda: ref.katana_bank_step_plain(model, x1[None],
                                                        P1[None], z1,
                                                        symmetrize))
    return nbytes, per * N


def timed_host(fn):
    """(result, host ms of one call), the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def timed_once(fn):
    """(result, milliseconds) of one call, CUDA events around it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_equal(name, got, want, tol):
    """max |d| over the outputs, held to ``tol``; returns it."""
    d = max(max_diff(a, b) for a, b in zip(got, want))
    assert d <= tol, (name, d)
    return d


def phase_replay_kernels_vs_plain():
    """The replay scans and bank steps against their plain versions on the
    same CUDA tensors, at the small shape and at the replay size; the IMM
    streams drop DROP of the (frame, track) entries and write NaN there.
    Returns (max |d| by kernel, plain ms at the replay size by case)."""
    errs = dict(katana_bank_sequence=0.0, katana_imm_sequence=0.0,
                katana_bank=0.0, katana_bank_imm=0.0)
    plain_ms = {}
    imm = replay_model("imm")
    for N, T in (SMALL, (N_REPLAY, T_REPLAY)):
        big = N == N_REPLAY
        rng = np.random.default_rng(N + T)
        for kind in ("lkf", "ekf"):
            model = replay_model(kind)
            zs, x0, P0 = dev_(*replay_stream(kind, N, T))
            got = ops.katana_bank_sequence(model, zs, x0, P0,
                                           return_final=True)
            want, ms = timed_once(lambda: ref.katana_bank_scan_plain(
                model, x0, P0, zs))
            d = check_equal(kind, (got[0],) + got[1], want, TOL[kind])
            # the scan runs katana_bank's lane code on the plain version's
            # op stream: bit for bit
            assert all(torch.equal(a, b) for a, b in zip(
                (got[0],) + got[1], want)), (kind, d)
            errs["katana_bank_sequence"] = max(errs["katana_bank_sequence"],
                                               d)
            if big:
                plain_ms[f"scan_{kind}"] = ms
            step = ops.katana_bank(model, x0, P0, zs[0])
            want, ms = timed_once(lambda: ref.katana_bank_step_plain(
                model, x0, P0, zs[0]))
            d2 = check_equal(kind, step, want, TOL[kind])
            soa = ops.katana_bank_soa(model, x0.T.contiguous(),
                                      P0.permute(1, 2, 0).contiguous(),
                                      zs[0].T.contiguous())
            # the step runs the plain version's op stream (its pattern,
            # pruned.cuh), the struct-of-arrays route the same lane code
            assert all(torch.equal(a, b) for a, b in zip(step, want)), kind
            assert (torch.equal(soa[0].T, step[0])
                    and torch.equal(soa[1].permute(2, 0, 1), step[1])), kind
            errs["katana_bank"] = max(errs["katana_bank"], d2)
            if big:
                plain_ms[f"step_{kind}"] = ms
            print(f"katana_bank_sequence {kind} N={N} T={T} "
                  f"({ops.pick_pattern((model,)).name}): bitwise equal to "
                  "plain; katana_bank: bitwise, katana_bank_soa bitwise "
                  "equal to it")
        zs_np, x0_np, P0_np = replay_stream("imm", N, T)
        valid_np = rng.random((T, N)) >= DROP
        zs_nan = zs_np.copy()
        zs_nan[~valid_np] = np.nan
        zs, x0, P0, valid = dev_(zs_nan, x0_np, P0_np, valid_np)
        mu0 = torch.as_tensor(rng.dirichlet(np.ones(imm.K), size=N),
                              dtype=torch.float32, device=DEV)
        got = ops.katana_imm_sequence(imm, zs, x0, P0, mu0, valid,
                                      return_final=True)
        inputs = ops.imm_sequence_inputs(imm, zs, x0, P0, mu0, valid)
        want, ms = timed_once(lambda: ref.katana_bank_imm_scan_plain(
            imm, *inputs))
        assert bool(torch.isfinite(got[0]).all())
        d = check_equal("imm", (got[0],) + got[1], want, TOL["imm"])
        errs["katana_imm_sequence"] = max(errs["katana_imm_sequence"], d)
        if big:
            plain_ms["scan_imm"] = ms
        line = (f"katana_imm_sequence K=4 N={N} T={T} ({int((~valid).sum())} "
                f"NaN entries coasting): max|d| vs plain {d:.3g}")
        for kind in ("cv9", "ekf"):
            model = filters.get_filter(kind)
            src = "ekf" if kind == "ekf" else "imm"
            zs1, x1, P1 = dev_(*replay_stream(src, N, T))
            zs1 = torch.where(valid[:, :, None], zs1, float("nan"))
            a1 = filters.as_imm(model)
            got = ops.katana_imm_sequence(a1, zs1, x1, P1, valid=valid,
                                          return_final=True)
            want = ref.katana_bank_imm_scan_plain(
                a1, *ops.imm_sequence_inputs(a1, zs1, x1, P1, None, valid))
            d = check_equal(kind, (got[0],) + got[1], want, TOL[
                "ekf" if kind == "ekf" else "lkf"])
            # K = 1 runs the single-model scan with the valid stream
            assert all(torch.equal(a, b) for a, b in zip(
                (got[0],) + got[1], want)), (kind, d)
            errs["katana_bank_sequence"] = max(errs["katana_bank_sequence"],
                                               d)
            line += f"; K=1 {kind} (the scan, valid stream): bitwise"
        print(line)
        K = imm.K
        xK = (x0[None] + torch.as_tensor(0.05 * rng.normal(
            size=(K, N, imm.n)), dtype=torch.float32, device=DEV)
              ).contiguous()
        PK = P0[None].expand(K, N, imm.n, imm.n).contiguous()
        z0 = torch.nan_to_num(zs[0])
        got = ops.katana_bank_imm(imm, xK, PK, z0)
        want, ms = timed_once(lambda: ref.katana_bank_imm_step_plain(
            imm, xK, PK, z0))
        d = check_equal("imm step", got, want, TOL["imm"])
        ekf1 = filters.as_imm(filters.get_filter("ekf"))
        zs1, x1, P1 = dev_(*replay_stream("ekf", N, T))
        got = ops.katana_bank_imm(ekf1, x1[None].contiguous(),
                                  P1[None].contiguous(), zs1[0])
        want = ref.katana_bank_imm_step_plain(ekf1, x1[None], P1[None],
                                              zs1[0])
        d2 = check_equal("ekf K=1 step", got, want, TOL["ekf"])
        errs["katana_bank_imm"] = max(errs["katana_bank_imm"], d, d2)
        if big:
            plain_ms["step_imm"] = ms
        print(f"katana_bank_imm K=4 N={N}: max|d| vs plain {d:.3g}; "
              f"K=1 ekf: {d2:.3g}")
    torch.cuda.synchronize()
    return errs, plain_ms


def phase_replay(kind, plain_ms):
    """The replay path: ``TrackingEngine(model, device="cuda").replay`` over
    the pod-scale stream, the launch counters, every frame of N_SAMPLE
    tracks against the float64 oracle (and the same oracle in float32);
    then the kernel's times at this size and its bound."""
    model = replay_model(kind)
    is_imm = kind == "imm"
    name = "katana_imm_sequence" if is_imm else "katana_bank_sequence"
    zs, x0, P0 = replay_stream(kind)
    T, N, _ = zs.shape
    eng = TrackingEngine(model, tracker.TrackerConfig(capacity=C_SERVE,
                                                      max_meas=M_SERVE),
                         device=DEV)
    ops.reset_launches()
    # PERF.md's replay metric: host clock from the numpy stream in to the
    # numpy states out; the engine's own span ends when the stream is done
    # on the card, before the copy back
    t0 = time.perf_counter()
    out = eng.replay(zs)
    host_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # the launch shape the tile table gave this card at this N
    tile, chunk = (ops.LAST_CONFIG[name][k] for k in ("lane_tile",
                                                       "time_chunk"))
    assert launches[name] == chunk_launches(name, T), (kind, launches)
    assert eng.stats.frames == 0 and eng.stats.replay_frames == T
    assert out.shape == (T, N, model.n) and np.isfinite(out).all()
    fps = T / host_s
    assert eng.stats.replay_latency_s < host_s

    # the finals of the same stream, and the kernel's times
    zs_t, x0_t, P0_t = dev_(zs, x0, P0)
    seq = ops.katana_imm_sequence if is_imm else ops.katana_bank_sequence
    xs_t, fin = seq(model, zs_t, x0_t, P0_t, return_final=True)
    assert np.array_equal(xs_t.cpu().numpy(), out), kind
    h2d_ms = timed_host(lambda: torch.from_numpy(zs).to(DEV))[1]
    d2h_ms = timed_host(lambda: xs_t.cpu())[1]
    # CUDA events only, the device queued behind a spin: torch.profiler
    # sessions this late in the run have recorded none or part of the
    # scans' launches
    ms = cuda_ms(lambda: seq(model, zs_t, x0_t, P0_t), 10, spin=True)
    # the whole stream in one launch, and (IMM) in the reference's chunks
    # of 64 frames, beside the time_chunk default
    ms_one = cuda_ms(lambda: seq(model, zs_t, x0_t, P0_t, time_chunk=T), 10,
                     spin=True)
    ms_64 = (cuda_ms(lambda: seq(model, zs_t, x0_t, P0_t, time_chunk=64), 10,
                     spin=True) if is_imm else None)
    nb, nops = scan_work(model, N, T)
    bms, by = bound(nb, nops)

    # every frame of N_SAMPLE tracks against the oracle, float64 and float32
    pick = np.sort(np.random.default_rng(3).choice(N, N_SAMPLE,
                                                   replace=False))
    zp = zs[:, pick].astype(np.float64)
    got = dict(x=out[:, pick])
    exact, f32 = {}, {}
    if is_imm:
        for dst, dt in ((exact, np.float64), (f32, np.float32)):
            xc, mus = oracle.run_imm_batched(model, zp, x0[pick], P0[pick],
                                             dtype=dt)
            dst.update(x=xc, mu=mus[-1])
        got["mu"] = fin[2][torch.as_tensor(pick)].cpu().numpy()
    else:
        for dst, dt in ((exact, np.float64), (f32, np.float32)):
            xo, _, Pf = oracle.run_batched(model, zp, x0[pick], P0[pick],
                                           dtype=dt)
            dst.update(x=xo, P_T=Pf)
        got["P_T"] = fin[1][torch.as_tensor(pick)].cpu().numpy()
    _ORACLE[kind] = (pick, exact["x"], f32["x"])
    check = {}
    for f in got:
        g, e, e32 = (torch.as_tensor(np.asarray(a, np.float64))
                     for a in (got[f], exact[f], f32[f]))
        if f == "x":
            win = [(max_rel(g[t:t + WINDOW], e[t:t + WINDOW]),
                    max_rel(e32[t:t + WINDOW], e[t:t + WINDOW]))
                   for t in range(0, T, WINDOW)]
            print(f"[replay {kind}] x max|d|/max(1,|ref|) per {WINDOW} frames "
                  "(kernel vs float64; float32 oracle vs float64): "
                  + "; ".join(f"{a:.3g} {b:.3g}" for a, b in win))
        err, err32 = max_rel(g, e), max_rel(e32, e)
        check[f] = dict(kernel_vs_f64=err, f32_oracle_vs_f64=err32)
        print(f"[replay {kind}] {f}: kernel {err:.3g}, float32 oracle "
              f"{err32:.3g} from float64")
        assert err <= max(TOL[kind], ROUTE_SLACK * err32), (kind, f, err,
                                                            err32)
    row = dict(N=N, T=T, replay_fps=fps, track_frames_per_s=fps * N,
               replay_s=host_s, engine_replay_s=eng.stats.replay_latency_s,
               engine_replay_fps=eng.stats.replay_fps, h2d_zs_ms=h2d_ms,
               d2h_xs_ms=d2h_ms, kernel_ms=ms, one_launch_ms=ms_one,
               plain_ms=plain_ms[f"scan_{kind}"], bound_ms=bms, bound_by=by,
               bytes=nb, operations=nops, launches=launches[name],
               lane_tile=tile, time_chunk=chunk, oracle=check)
    if is_imm:
        inst = ops.pick_pattern(model.models).name
        row.update(instantiation=inst, chunk64_ms=ms_64,
                   bound_share=bms / ms,
                   registers=ptxas_registers("imm_scan.cu", "imm_scan",
                                             f"{len(inst)}{inst}ELb1E",
                                             tile_part(tile)))
        print(f"[replay imm] katana_imm_sequence, instantiation {inst}, "
              f"{tile} tracks a block ({row['registers']} registers): "
              f"{ms:.3f} ms by events "
              f"(device queued) in {launches[name]} launch(es) of up to "
              f"{chunk} frames; in chunks of 64: {ms_64:.3f} ms; bound "
              f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it reached")
    else:
        inst = ops.pick_pattern((model,)).name
        nl = "Lb0" if model.is_linear else "Lb1"
        entry = ("bank_scan", f"{len(inst)}{inst}E{nl}ELb0ELb1E",
                 tile_part(tile))
        regs = ptxas_registers("scan.cu", *entry)
        # resident blocks of `tile` threads an SM at these registers, and
        # the waves of the launch's blocks on the card's SMs
        per_sm = min(2048 // tile, 65536 // (tile * regs)) if regs else None
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        waves = -(-N // tile) / (per_sm * sms) if per_sm else None
        row.update(instantiation=inst, bound_share=bms / ms,
                   registers=regs, blocks_per_sm=per_sm, waves=waves)
        waves_s = "?" if waves is None else f"{waves:.2f}"
        print(f"[replay {kind}] katana_bank_sequence, instantiation {inst} "
              f"({regs} registers, {per_sm} blocks of {tile} an SM, {waves_s} "
              f"waves on {sms} SMs): {ms:.3f} ms by events (device queued) "
              f"in {launches[name]} launch(es); bound {bms:.4f} ms by {by}, "
              f"{bms / ms:.1%} of it reached")
        _print_ptxas_of("scan.cu", entry,
                        ("first_frame", f"{len(inst)}{inst}E{nl}ELb0E",
                         tile_part(tile)))
    print(f"[replay {kind}] N={N} T={T}: {fps:.1f} frames/s, "
          f"{fps * N:.4g} track-frames/s (host clock from numpy in to numpy "
          f"out: {host_s * 1e3:.1f} ms; the engine's span, zs in to the "
          f"stream done: {eng.stats.replay_latency_s * 1e3:.1f} ms, "
          f"{eng.stats.replay_fps:.1f} frames/s; the copies alone "
          f"{h2d_ms:.1f} ms in, {d2h_ms:.1f} ms out) | "
          f"{name}: {ms:.3f} ms (plain {row['plain_ms']:.1f} ms, bound "
          f"{bms:.4f} ms by {by}: {both_bounds(nb, nops)}), "
          f"{launches[name]} launch(es) of up to {chunk} frames, {tile} "
          f"tracks a block; the stream in one launch {ms_one:.3f} ms")
    return row


def phase_per_frame(plain_ms):
    """The per-frame twins at the replay size: T calls of katana_bank give
    the scan's final (x, P) bit for bit (lkf, ekf); imm_bank_sequence
    tracks katana_imm_sequence within atol 5e-5, rtol 5e-4 (the
    reference's test_imm_scan.py:58) over that test's 48 frames, and
    both stay as close to the float64 oracle as the replay path must over
    all T. Launches reset before and read after each."""
    rows = {}
    for kind in ("lkf", "ekf"):
        model = replay_model(kind)
        zs, x0, P0 = dev_(*replay_stream(kind))
        T, N, _ = zs.shape
        _, (xf, Pf) = ops.katana_bank_sequence(model, zs, x0, P0,
                                               return_final=True)
        ops.reset_launches()
        x, P = x0, P0
        for t in range(T):
            x, P = ops.katana_bank(model, x, P, zs[t])
        launches = ops.LAUNCHES["katana_bank"]
        assert launches == T
        assert torch.equal(x, xf) and torch.equal(P, Pf), kind
        # device time: the calls queued behind a spin
        ms = cuda_ms(lambda: ops.katana_bank(model, x0, P0, zs[0]), 50,
                     spin=True)
        xT, PT, zT = (x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
                      zs[0].T.contiguous())
        soa_ms = cuda_ms(lambda: ops.katana_bank_soa(model, xT, PT, zT), 50,
                         spin=True)
        work = step_work(model, N)
        bms, by = bound(*work)
        inst = ops.pick_pattern((model,)).name
        tile = ops.LAST_CONFIG["katana_bank"]["lane_tile"]
        soa_tile = ops.LAST_CONFIG["katana_bank_soa"]["lane_tile"]
        rows[kind] = dict(kernel_ms=ms, plain_ms=plain_ms[f"step_{kind}"],
                          bound_ms=bms, bound_by=by, launches=launches,
                          bound_share=bms / ms, soa_ms=soa_ms,
                          soa_bound_share=bms / soa_ms, instantiation=inst,
                          lane_tile=tile, soa_lane_tile=soa_tile,
                          registers=ptxas_registers(
                              "imm_step.cu", "imm_step",
                              f"{len(inst)}{inst}ELb0ELb1E", tile_part(tile)),
                          soa_registers=ptxas_registers(
                              "imm_step.cu", "bank_step_soa",
                              f"{len(inst)}{inst}ELb1E", tile_part(soa_tile)))
        print(f"[per-frame {kind}] {T} katana_bank calls == the scan's final "
              f"(x, P) bitwise; instantiation {inst}: {ms:.4f} ms a call by "
              f"events (device queued), {bms / ms:.1%} of the bound; "
              f"katana_bank_soa {soa_ms:.4f} ms, {bms / soa_ms:.1%} (plain "
              f"{rows[kind]['plain_ms']:.2f} ms, bound {bms:.5f} ms by {by}: "
              f"{both_bounds(*work)})")
        _print_ptxas_of("imm_step.cu",
                        ("imm_step", f"{len(inst)}{inst}ELb0ELb1E",
                         tile_part(tile)),
                        ("bank_step_soa", f"{len(inst)}{inst}ELb1E",
                         tile_part(soa_tile)))
    imm = replay_model("imm")
    zs, x0, P0 = dev_(*replay_stream("imm"))
    T, N, _ = zs.shape
    fused = ops.katana_imm_sequence(imm, zs, x0, P0)
    ops.reset_launches()
    drv = ops.imm_bank_sequence(imm, zs, x0, P0)
    launches = ops.LAUNCHES["katana_bank_imm"]
    assert launches == T
    # The reference's tolerance holds over the reference test's horizon
    # (48 frames of the maneuvering scene). Later the two float32
    # formulations of the mixing drift apart in the velocity and
    # acceleration entries (rounding amplified by 1/dt, 1/dt^2), as each
    # does from float64: over the whole stream both are held to the
    # float64 oracle on the sample tracks, and the gap is printed.
    h = min(T, REF_HORIZON)
    torch.testing.assert_close(drv[:h], fused[:h], atol=5e-5, rtol=5e-4)
    over = ((drv - fused).abs() > 5e-5 + 5e-4 * fused.abs())
    gap = max_diff(drv, fused)
    pick, exact, f32 = _ORACLE["imm"]
    e32 = max_rel(torch.as_tensor(f32), torch.as_tensor(exact))
    for nm, v in (("imm_bank_sequence", drv), ("katana_imm_sequence", fused)):
        err = max_rel(v[:, torch.as_tensor(pick, device=v.device)].cpu(),
                      torch.as_tensor(exact))
        print(f"[per-frame imm] {nm} vs float64 on {len(pick)} tracks: "
              f"{err:.3g} (float32 oracle {e32:.3g})")
        assert err <= max(TOL["imm"], ROUTE_SLACK * e32), (nm, err, e32)
    print(f"[per-frame imm] imm_bank_sequence vs katana_imm_sequence: within "
          f"atol 5e-5, rtol 5e-4 over the first {h} frames; over {T} frames "
          f"max|d| per {WINDOW}: " + " ".join(
              f"{max_diff(drv[t:t + WINDOW], fused[t:t + WINDOW]):.3g}"
              for t in range(0, T, WINDOW))
          + f"; {int(over.sum())} of {over.numel()} entries outside that "
          "tolerance")
    K = imm.K
    xK = x0[None].expand(K, N, imm.n).contiguous()
    PK = P0[None].expand(K, N, imm.n, imm.n).contiguous()
    ms = cuda_ms(lambda: ops.katana_bank_imm(imm, xK, PK, zs[0]), 50,
                 spin=True)
    drv_ms = cuda_ms(lambda: ops.imm_bank_sequence(imm, zs, x0, P0), 1,
                     warmup=0)
    work = step_work(imm, N)
    bms, by = bound(*work)
    inst = ops.pick_pattern(imm.models).name
    tile = ops.LAST_CONFIG["katana_bank_imm"]["lane_tile"]
    rows["imm"] = dict(kernel_ms=ms, plain_ms=plain_ms["step_imm"],
                       bound_ms=bms, bound_by=by, launches=launches,
                       driver_ms=drv_ms, driver_vs_scan_max_abs=gap,
                       outside_ref_tolerance=int(over.sum()),
                       instantiation=inst, bound_share=bms / ms,
                       lane_tile=tile,
                       registers=ptxas_registers("imm_step.cu", "imm_step",
                                                 f"{len(inst)}{inst}"
                                                 "ELb1ELb1E", tile_part(tile)))
    print(f"[per-frame imm] katana_bank_imm, instantiation {inst} "
          f"({rows['imm']['registers']} registers): {ms:.4f} ms a launch by "
          f"events (device queued); {launches} launches in "
          f"imm_bank_sequence, {drv_ms:.1f} ms the stream; bound {bms:.5f} "
          f"ms by {by}, {bms / ms:.1%} of it reached")
    print(f"[per-frame imm] imm_bank_sequence ({launches} katana_bank_imm "
          f"launches, {drv_ms:.1f} ms) vs katana_imm_sequence: max|d| "
          f"{gap:.3g}; katana_bank_imm {ms:.4f} ms a call (plain "
          f"{rows['imm']['plain_ms']:.2f} ms, bound {bms:.5f} ms by {by}: "
          f"{both_bounds(*work)})")
    return rows


def phase_resumed_bank(eng):
    """``replay_imm_bank`` from the live IMM bank after the serving run, at
    its capacity: half the stream, a bank reseeded from its finals, the
    rest equals the whole stream's second half bit for bit; the live bank
    is unchanged."""
    imm = eng.model
    bank = eng.bank
    C = bank.x.shape[1]
    before = [t.clone() for t in bank]
    zs_np, _, _ = replay_stream("imm", C, T_REPLAY)
    valid = torch.as_tensor(np.random.default_rng(17).random((T_REPLAY, C))
                            >= DROP, device=DEV)
    zs = torch.where(valid[:, :, None], torch.as_tensor(zs_np, device=DEV),
                     float("nan"))
    whole = bank_lib.replay_imm_bank(imm, bank, zs, valid)
    h = T_REPLAY // 2
    _, (xh, Ph, muh) = bank_lib.replay_imm_bank(imm, bank, zs[:h], valid[:h],
                                                return_final=True)
    rest = bank_lib.replay_imm_bank(imm, bank._replace(x=xh, P=Ph, mu=muh),
                                    zs[h:], valid[h:])
    assert torch.equal(rest, whole[h:])
    assert bool(torch.isfinite(whole).all())
    assert all(torch.equal(a, b) for a, b in zip(before, bank))
    print(f"[resumed bank] replay_imm_bank C={C} T={T_REPLAY} from the live "
          f"bank ({int(bank.active.sum())} active): resumed half == whole "
          "stream's second half bitwise; live bank unchanged")


# ---------------------------------------------------------------------------
# The paper's stage ladder (core/rewrites.py) at the batches of the port's
# configs/katana.py, T = 300 frames at the configs' 30 FPS dt: the
# single-filter stages at N = 1, the batched ones at the paper's N = 200
# (Table I), the lanes and kernel stages at the pod's N = 131,072. Each
# stage runs at its default symmetrize=False, as the reference's do.
# ---------------------------------------------------------------------------

STAGE_T = 300
# frames of the asymmetric-seed cases of the pod-size kernel stages (the
# timed run's own xs are held over all STAGE_T): the plain ekf imm_bank
# takes ~6 s for 300 frames on the H100
STAGE_ASYM_T = 60
STAGE_TIERS = (("single", ("baseline", "opt1", "opt2")),
               ("batched", ("batched_blockdiag", "batched_lanes")),
               ("pod", ("batched_lanes", "fused_scan", "imm_bank",
                        "imm_scan")))
_TIER_SUFFIX = {"single": "", "batched": "-batched", "pod": "-pod"}
# the kernels of the ladder's main path: stage -> (the wrapper ops.LAUNCHES
# counts, its launches a run (None: one a time chunk of the tile table's),
# the kernels row of the kernel it launches): imm_scan's K = 1
# katana_imm_sequence launches scan.cu's bank_scan
STAGE_KERNELS = {"fused_scan": ("katana_bank_sequence", None,
                                "katana_bank_sequence"),
                 "imm_bank": ("katana_bank_imm", STAGE_T, "katana_bank_imm"),
                 "imm_scan": ("katana_imm_sequence", None,
                              "katana_bank_sequence")}


def stage_inputs(kind, tier, N):
    """(zs (T, N, m), x0, P0) numpy: N = 1 one ``single_target`` track;
    otherwise the first N lanes of the replay phase's stream (lane k
    follows target k % N_BASE of ``batched_targets``, its own noise),
    seeded at the model's prior."""
    model = replay_model(kind)
    if tier == "single":
        _, z = traj.single_target(model, STAGE_T, seed=0)
        return (z[:, None].astype(np.float32), model.x0[None].astype(
            np.float32), model.P0[None].astype(np.float32))
    zs, x0, P0 = replay_stream(kind, max(N, N_REPLAY), STAGE_T)
    return zs[:, :N], x0[:N], P0[:N]


def stage_oracle(kind, zs, x0, P0):
    """(sample lanes, float64 xs) of the oracle (core/ref.py): every lane
    up to N_SAMPLE of them, else a seeded sample of N_SAMPLE (at the
    replay size the replay phase's)."""
    N = zs.shape[1]
    if (N, STAGE_T) == (N_REPLAY, T_REPLAY) and kind in _ORACLE:
        return _ORACLE[kind][:2]
    pick = (np.arange(N) if N <= N_SAMPLE else np.sort(
        np.random.default_rng(3).choice(N, N_SAMPLE, replace=False)))
    run = oracle.run_imm_batched if kind == "imm" else oracle.run_batched
    exact = run(replay_model(kind), zs[:, pick].astype(np.float64), x0[pick],
                P0[pick])[0]
    return pick, exact


def ptxas_spill(source, *parts):
    """Bytes of spill stores ptxas reported for the entry of ``source``
    whose mangled name holds every one of ``parts``, or None."""
    entry = None
    for ln in build.BUILD_LOG.get(source, {}).get("ptxas", []):
        if "Compiling entry" in ln:
            entry = ln
        elif entry and "spill stores" in ln and all(p in entry
                                                    for p in parts):
            return int(ln.split("bytes spill stores")[0].split(",")[-1])
    return None


def tile_part(tile):
    """The part of a mangled kernel name that its last template argument,
    the tile (tracks or lanes a block), makes."""
    return f"Li{tile}EE"


def chunk_launches(name, T):
    """Launches of wrapper ``name``'s last call over T frames: one a time
    chunk, the chunk the tile table (or the caller) chose."""
    return -(-T // ops.LAST_CONFIG[name]["time_chunk"])


def phase_stages():
    """The stage ladder through ``rewrites.run_sequence`` / ``build_stage``
    on the card: every (filter, stage, N) within TOL of the float64
    oracle by |d| / max(1, |ref|), with its host ms a run (steady state:
    after a warm-up run, the whole stream for the one-launch stages), µs
    a step and steps/s (a Table I row); the launch counts of the kernel
    stages at the pod size; those stages bit for bit with their plain
    versions on the card (``stage_kernels_bitwise``); the
    symmetrize=False kernels' times, bounds, registers and spill beside
    the True ones. Returns (the rows, the ladder's launches by kernels
    row and stage, the symmetrize=False rows)."""
    t_phase = time.perf_counter()
    # the dense block-diagonal GEMMs of batched_blockdiag hold the oracle's
    # band only in full float32 (TF32 keeps ~3 decimal digits)
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    rows, launches, full = [], {}, {}
    for kind in ("lkf", "ekf"):
        model = replay_model(kind)
        for tier, stages in STAGE_TIERS:
            cfg = kcfg.ALL[f"katana-{kind}{_TIER_SUFFIX[tier]}"]
            assert (cfg.filter_kind, cfg.state_dim, cfg.meas_dim) == (
                kind, model.n, model.m) and cfg.dt == model.dt
            N = cfg.batch
            host = stage_inputs(kind, tier, N)
            zs, x0, P0 = dev_(*host)
            pick, exact = stage_oracle(kind, *host)
            timed = {}  # the kernel stages' xs, held against plain below
            for stage in stages:
                # warm-up: the one-launch stages allocate the whole
                # stream's xs, the others a frame's temporaries
                warm = zs if stage in ("fused_scan", "imm_scan") else zs[:2]
                rewrites.run_sequence(model, stage, warm, x0, P0, device=DEV)
                ops.reset_launches()
                xs, ms = timed_host(lambda: rewrites.run_sequence(
                    model, stage, zs, x0, P0, device=DEV))
                counts = dict(ops.LAUNCHES)
                want = 0
                if stage in STAGE_KERNELS:
                    name, want, kernel = STAGE_KERNELS[stage]
                    if want is None:  # a scan: one launch a time chunk
                        want = chunk_launches(name, STAGE_T)
                    assert counts[name] == want, (stage, counts)
                    by_stage = launches.setdefault(kernel, {})
                    by_stage[stage] = by_stage.get(stage, 0) + counts[name]
                    timed[stage] = xs
                assert sum(counts.values()) == want, (stage, counts)
                err = max_rel(xs[:, torch.as_tensor(pick, device=DEV)].cpu(),
                              torch.as_tensor(exact))
                assert err <= TOL[kind], (kind, stage, N, err)
                row = dict(filter=kind, stage=stage, N=N, T=STAGE_T,
                           config=cfg.name, ms=ms,
                           us_per_step=ms * 1e3 / STAGE_T,
                           steps_per_s=STAGE_T / ms * 1e3,
                           max_rel_vs_f64=err, oracle_lanes=len(pick))
                rows.append(row)
                print(f"[stages] {kind} {stage:17s} N={N:<6d} "
                      f"{row['us_per_step']:10.1f} µs/step "
                      f"{row['steps_per_s']:10.1f} steps/s  vs float64 "
                      f"{err:.3g} ({len(pick)} lanes)")
            if tier == "pod":
                # one build_stage("fused_scan") step: one katana_bank
                step, _ = rewrites.build_stage(model, "fused_scan", N=N,
                                               device=DEV)
                ops.reset_launches()
                step(x0, P0, zs[0])
                assert ops.LAUNCHES["katana_bank"] == 1 and sum(
                    ops.LAUNCHES.values()) == 1
                by_stage = launches.setdefault("katana_bank", {})
                by_stage["fused_scan step"] = by_stage.get(
                    "fused_scan step", 0) + 1
                full[kind] = stage_kernels_bitwise(model, zs, x0, P0, timed)
                del timed
    full["imm"] = imm_step_full_square()
    full["frames"] = frames_full_square()
    full["imm_scan"] = imm_scan_full_square()
    full["imm_scan"]["rung"] = imm_scan_rung(launches)
    rows.append(full["imm_scan"]["rung"])
    print(f"[stages] launches of the kernel stages: {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return rows, launches, full


def _plain_bank_imm(imm, x, P, z, symmetrize=True, lane_tile=0):
    return ref.katana_bank_imm_step_plain(imm, x, P, z, symmetrize)


def stage_kernels_bitwise(model, zs, x0, P0, timed):
    """The pod-size kernel stages bit for bit with their plain versions
    on the card. First the timed run's own xs over all T frames of zs
    (``timed``: run_sequence's default symmetrize=False, the model's
    prior P0): fused_scan and imm_scan (K = 1: the same scan) against
    ``katana_bank_scan_plain``, imm_bank against ``imm_bank_sequence`` on
    the plain step. Then so again over STAGE_ASYM_T frames at symmetrize
    False and True from a seed P that is symmetric only to rounding, and
    fused_scan's step against ``katana_bank_step_plain``. Then the
    symmetrize=False times of the scan and the step (CUDA events, the
    device queued), their bounds, registers and spill, beside the True
    ones. Returns them."""
    kind = "ekf" if not model.is_linear else "lkf"
    t_check = time.perf_counter()
    N, n = x0.shape

    def plain_imm_bank(z, P, sym):
        with mock.patch.object(ops, "katana_bank_imm", _plain_bank_imm):
            return ops.imm_bank_sequence(filters.as_imm(model), z, x0, P,
                                         symmetrize=sym)

    want = ref.katana_bank_scan_plain(model, x0, P0, zs, symmetrize=False)[0]
    for stage in ("fused_scan", "imm_scan"):
        assert torch.equal(timed[stage], want), (kind, stage, "timed run")
    del want
    assert torch.equal(timed["imm_bank"], plain_imm_bank(zs, P0, False)), (
        kind, "imm_bank", "timed run")
    zb = zs[:STAGE_ASYM_T].contiguous()
    rng = np.random.default_rng(41)
    P0a = (P0 + torch.as_tensor(1e-3 * rng.standard_normal(
        (N, n, n), dtype=np.float32), device=DEV)).contiguous()
    xs_by = {}
    for sym in (False, True):
        want = ref.katana_bank_scan_plain(model, x0, P0a, zb, symmetrize=sym)
        for stage in ("fused_scan", "imm_scan"):
            got = rewrites.run_sequence(model, stage, zb, x0, P0a,
                                        symmetrize=sym, device=DEV)
            assert torch.equal(got, want[0]), (kind, stage, sym)
        xs_by[sym] = want[0]
        got = rewrites.run_sequence(model, "imm_bank", zb, x0, P0a,
                                    symmetrize=sym, device=DEV)
        assert torch.equal(got, plain_imm_bank(zb, P0a, sym)), (
            kind, "imm_bank", sym)
        step, _ = rewrites.build_stage(model, "fused_scan", N=N,
                                       symmetrize=sym, device=DEV)
        got = step(x0, P0a, zb[0])
        want = ref.katana_bank_step_plain(model, x0, P0a, zb[0], sym)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (kind, sym)
        assert not torch.equal(got[1], got[1].transpose(1, 2)) or sym
    gap = max_diff(xs_by[False], xs_by[True])
    assert gap > 0, kind  # the two contracts part on this seed
    torch.cuda.synchronize()
    t_check = time.perf_counter() - t_check
    inst = ops.pick_pattern((model,)).name
    nl = "Lb0" if model.is_linear else "Lb1"
    out = {}
    for sym in (False, True):
        b = f"Lb{int(sym)}E"
        scan_ms = cuda_ms(lambda: ops.katana_bank_sequence(
            model, zs, x0, P0, symmetrize=sym), 10, spin=True)
        scan_t = ops.LAST_CONFIG["katana_bank_sequence"]["lane_tile"]
        step_ms = cuda_ms(lambda: ops.katana_bank(
            model, x0, P0, zs[0], symmetrize=sym), 50, spin=True)
        step_t = ops.LAST_CONFIG["katana_bank"]["lane_tile"]
        scan_b = bound(*scan_work(model, N, zs.shape[0], sym))
        step_b = bound(*step_work(model, N, sym))
        scan_e = ("bank_scan", f"{len(inst)}{inst}E{nl}ELb0E{b}",
                  tile_part(scan_t))
        step_e = ("imm_step", f"{len(inst)}{inst}ELb0E{b}", tile_part(step_t))
        out["sym" if sym else "full_square"] = dict(
            scan_ms=scan_ms, scan_bound_ms=scan_b[0], scan_bound_by=scan_b[1],
            scan_registers=ptxas_registers("scan.cu", *scan_e),
            scan_spill=ptxas_spill("scan.cu", *scan_e),
            step_ms=step_ms, step_bound_ms=step_b[0],
            step_bound_by=step_b[1],
            step_registers=ptxas_registers("imm_step.cu", *step_e),
            step_spill=ptxas_spill("imm_step.cu", *step_e))
        _print_ptxas_of("scan.cu", scan_e)
        _print_ptxas_of("imm_step.cu", step_e,
                        ("bank_step_soa", f"{len(inst)}{inst}E{b}",
                         tile_part(step_t)))
    for key, r in out.items():
        print(f"[stages] {kind} {key} (instantiation {inst}): "
              f"katana_bank_sequence {r['scan_ms']:.3f} ms (bound "
              f"{r['scan_bound_ms']:.4f} by {r['scan_bound_by']}, "
              f"{r['scan_registers']} registers, {r['scan_spill']} B spill), "
              f"katana_bank {r['step_ms']:.4f} ms (bound "
              f"{r['step_bound_ms']:.5f} by {r['step_bound_by']}, "
              f"{r['step_registers']} registers, {r['step_spill']} B spill)")
    print(f"[stages] {kind} N={N}: the timed run's fused_scan, imm_scan "
          f"and imm_bank bitwise equal to their plain versions over all "
          f"{zs.shape[0]} frames (symmetrize=False, the prior P0); so "
          f"again over {STAGE_ASYM_T} frames, and fused_scan's step, at "
          f"symmetrize False and True (seed P asymmetric by 1e-3); the two "
          f"contracts part by "
          f"{gap:.3g}; checks {t_check:.1f} s")
    return out


def imm_step_full_square():
    """katana_bank_imm at K = 4 (imm9) on the replay size with
    symmetrize=False: bit for bit with its plain version on an asymmetric
    P, its time beside symmetrize=True's, bounds, registers, spill."""
    imm = replay_model("imm")
    zs, x0, P0 = dev_(*replay_stream("imm"))
    K, N, n = imm.K, x0.shape[0], imm.n
    rng = np.random.default_rng(43)
    xK = (x0[None] + torch.as_tensor(0.05 * rng.standard_normal(
        (K, N, n), dtype=np.float32), device=DEV)).contiguous()
    PK = P0[None].expand(K, N, n, n).contiguous()
    PKa = (PK + torch.as_tensor(1e-3 * rng.standard_normal(
        (K, N, n, n), dtype=np.float32), device=DEV)).contiguous()
    for sym in (False, True):
        got = ops.katana_bank_imm(imm, xK, PKa, zs[0], symmetrize=sym)
        want = ref.katana_bank_imm_step_plain(imm, xK, PKa, zs[0], sym)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), sym
    out = {}
    inst = ops.pick_pattern(imm.models).name
    for sym in (False, True):
        ms = cuda_ms(lambda: ops.katana_bank_imm(imm, xK, PK, zs[0],
                                                 symmetrize=sym), 50,
                     spin=True)
        bms, by = bound(*step_work(imm, N, sym))
        e = ("imm_step", f"{len(inst)}{inst}ELb1ELb{int(sym)}E",
             tile_part(ops.LAST_CONFIG["katana_bank_imm"]["lane_tile"]))
        out["sym" if sym else "full_square"] = dict(
            step_ms=ms, step_bound_ms=bms, step_bound_by=by,
            step_registers=ptxas_registers("imm_step.cu", *e),
            step_spill=ptxas_spill("imm_step.cu", *e))
        _print_ptxas_of("imm_step.cu", e)
        print(f"[stages] imm K={K} N={N} katana_bank_imm symmetrize={sym}: "
              f"{ms:.4f} ms (bound {bms:.5f} by {by}, {bms / ms:.1%}); "
              "bitwise equal to its plain version on an asymmetric P")
    return out


def _asym(P, seed):
    """P plus 1e-3 noise: a seed P that is not symmetric to the bit."""
    rng = np.random.default_rng(seed)
    return (P + torch.as_tensor(1e-3 * rng.standard_normal(
        tuple(P.shape), dtype=np.float32), device=P.device)).contiguous()


def _sym_entries(source, parts):
    """{"sym" / "full_square": (registers, spill)} of the entry of
    ``source`` whose mangled name holds every part of ``parts(s)``, s the
    Sym flag's 0 or 1; the ptxas lines printed."""
    out = {}
    for sym in (True, False):
        e = parts(int(sym))
        _print_ptxas_of(source, e)
        out["sym" if sym else "full_square"] = (
            ptxas_registers(source, *e), ptxas_spill(source, *e))
    return out


def frames_full_square():
    """katana_frame (lkf, ekf) and katana_imm_frame (imm, K = 4) at phase
    3's shape (C = 1,024, M = 256) on a seed P that is not symmetric to
    the bit, at symmetrize False and True: assoc, waves, x', P' (and mu',
    x_c) bit for bit with the plain version; each frame's device ms a
    launch by the events it records (the device queued), its bound on
    this frame's data (``frame_work``, the full square's operations), and
    the predict's and the update's registers and spill for each Sym."""
    rng = np.random.default_rng(51)
    C, M = C_SERVE, M_SERVE
    out = {}
    for kind in ("lkf", "ekf", "imm"):
        model = replay_model(kind)
        is_imm = kind == "imm"
        obs = [0, 1, 2, 4] if kind == "ekf" else [0, 1, 2]
        bk = random_bank(rng, model.n, model.m, C, M, obs,
                         K=model.K if is_imm else None)
        P = _asym(bk["P"], 52)
        gate = 11.34 if model.m == 3 else 13.28
        if is_imm:
            args = (bk["x"], P, bk["mu"], bk["z"], bk["z_valid"],
                    bk["active"], gate, M)
            call, plain = ops.katana_imm_frame, ref.katana_imm_frame_plain
            inst = ops.pick_pattern(model.models).name
            source = "imm_frame.cu"
            parts = {"predict": lambda s: ("imm_predict",
                                           f"{len(inst)}{inst}ELi4ELb{s}E"),
                     "update": lambda s: ("imm_update",
                                          f"{len(inst)}{inst}ELi4ELb0ELb{s}E")}
        else:
            args = (bk["x"], P, bk["z"], bk["z_valid"], bk["active"], gate,
                    M)
            call, plain = ops.katana_frame, ref.katana_frame_plain
            inst = ops.pick_pattern((model,)).name
            source = "frame.cu"
            nl = "Lb0" if model.is_linear else "Lb1"
            n, m = model.n, model.m
            parts = {"predict": lambda s: ("frame_predict",
                                           f"{len(inst)}{inst}E{nl}ELb{s}E"),
                     "update": lambda s: ("frame_update",
                                          f"ILi{n}ELi{m}ELb0ELb{s}E")}
        na = 4 if is_imm else 2  # index of assoc in the outputs
        res, waves, n_assigned = {}, {}, {}
        for sym in (False, True):
            got = call(model, *args, return_waves=True, symmetrize=sym)
            want = plain(model, *args, return_waves=True, symmetrize=sym)
            assert torch.equal(got[na], want[na]), (kind, sym, "assoc")
            assert int(got[na + 1]) == want[na + 1], (kind, sym, "waves")
            for a, b in zip(got[:na], want[:na]):
                assert torch.equal(a, b), (kind, sym, max_diff(a, b))
            res[sym], waves[sym] = got, want[na + 1]
            n_assigned[sym] = int(((got[na] >= 0) & bk["active"]).sum())
        P2 = res[False][1]
        assert not torch.equal(P2, P2.transpose(-1, -2)), kind
        assert not torch.equal(P2, res[True][1]), kind
        n_active = int(bk["active"].sum())
        n_valid = int(bk["z_valid"].sum())
        regs = {k: _sym_entries(source, f) for k, f in parts.items()}
        for sym in (False, True):
            key = "sym" if sym else "full_square"
            ev = launch_events_ms(lambda evs: call(
                model, *args, launch_events=evs, symmetrize=sym))
            bms, by = bound(*frame_work(model, C, M, n_active, n_valid,
                                        n_assigned[sym], waves[sym], sym))
            out.setdefault(kind, {})[key] = dict(
                launch_device_ms=ev, ms=ev["frame"], bound_ms=bms,
                bound_by=by, instantiation=inst,
                registers={k: v[key][0] for k, v in regs.items()},
                spill={k: v[key][1] for k, v in regs.items()})
            print(f"[stages] {kind} {call.__name__} C={C} M={M} symmetrize="
                  f"{sym}: device {ev['frame']:.4f} ms a frame (predict "
                  f"{ev['predict']:.4f}, cost {ev['cost']:.4f}, greedy "
                  f"{ev['greedy']:.4f}, update {ev['update']:.4f}); bound "
                  f"{bms:.6f} by {by}; predict / update registers "
                  f"{regs['predict'][key][0]} / {regs['update'][key][0]}, "
                  f"spill {regs['predict'][key][1]} / "
                  f"{regs['update'][key][1]} B")
        print(f"[stages] {kind} {call.__name__} ({inst}) C={C} M={M}: assoc, "
              f"{waves[False]} waves and every state bitwise equal to the "
              f"plain version at symmetrize False and True, seed P "
              f"asymmetric by 1e-3; {n_assigned[False]} assigned")
    return out


def imm_scan_full_square():
    """katana_imm_sequence at K = 4, symmetrize=False, on phase 3b's fleet
    replay shape (8 x 1,024 lanes, T = 300, FLEET_DROP of the entries
    invalid and NaN), mode-conditioned seeds whose P is not symmetric to
    the bit: at both tiles, in one launch and in chunks of 64 frames,
    bit for bit with the plain version; the launch's device ms at both
    symmetrize values (events, the device queued), bounds (``scan_work``)
    and the registers and spill of every tile's Sym and full-square
    instantiation."""
    imm = replay_model("imm")
    K, n = imm.K, imm.n
    N, T = S_FLEET * C_SERVE, T_FLEET_REPLAY
    zs, x0, P0 = dev_(*replay_stream("imm", N, T))
    rng = np.random.default_rng(53)
    valid = torch.as_tensor(rng.random((T, N)) >= FLEET_DROP, device=DEV)
    zs = torch.where(valid[:, :, None], zs, torch.tensor(float("nan"),
                                                         device=DEV))
    xK = (x0[None] + torch.as_tensor(0.05 * rng.standard_normal(
        (K, N, n), dtype=np.float32), device=DEV)).contiguous()
    PK = _asym(P0[None].expand(K, N, n, n), 54)
    mu0 = torch.as_tensor(rng.dirichlet(np.ones(K), size=N),
                          dtype=torch.float32, device=DEV)
    seq = (imm, zs, xK, PK, mu0, valid)
    want, plain_ms = timed_host(lambda: ref.katana_bank_imm_scan_plain(
        imm, *ops.imm_sequence_inputs(*seq), symmetrize=False))
    assert bool(torch.isfinite(want[0]).all())
    assert not torch.equal(want[2], want[2].transpose(2, 3))
    inst = ops.pick_pattern(imm.models).name
    out = dict(N=N, T=T, drop=FLEET_DROP, instantiation=inst,
               plain_ms=plain_ms, tiles={})
    for tile in ops.LANE_TILES["katana_imm_sequence"]:
        for chunk in (T, 64):
            ops.reset_launches()
            xs, fin = ops.katana_imm_sequence(
                *seq, return_final=True, time_chunk=chunk, lane_tile=tile,
                symmetrize=False)
            assert ops.LAUNCHES["katana_imm_sequence"] == -(-T // chunk)
            for a, b in zip((xs,) + fin, want):
                assert torch.equal(a, b), (tile, chunk, max_diff(a, b))
        row = {}
        for sym in (False, True):
            key = "sym" if sym else "full_square"
            ms = cuda_ms(lambda: ops.katana_imm_sequence(
                *seq, time_chunk=T, lane_tile=tile, symmetrize=sym), 5,
                spin=True)
            bms, by = bound(*scan_work(imm, N, T, sym))
            e = ("imm_scan", f"{len(inst)}{inst}ELb{int(sym)}E",
                 tile_part(tile))
            _print_ptxas_of("imm_scan.cu", e)
            row[key] = dict(ms=ms, bound_ms=bms, bound_by=by,
                            registers=ptxas_registers("imm_scan.cu", *e),
                            spill=ptxas_spill("imm_scan.cu", *e))
            print(f"[stages] imm katana_imm_sequence K={K} N={N} T={T} "
                  f"{tile} tracks a block, symmetrize={sym}: {ms:.3f} ms in "
                  f"one launch (events, device queued); bound {bms:.4f} ms "
                  f"by {by}, {bms / ms:.1%} of it reached; "
                  f"{row[key]['registers']} registers, {row[key]['spill']} "
                  "B spill")
        out["tiles"][tile] = row
    print(f"[stages] imm katana_imm_sequence ({inst}) K={K} N={N} T={T}, "
          f"{FLEET_DROP:.0%} invalid: symmetrize=False at "
          f"{ops.LANE_TILES['katana_imm_sequence']} tracks a block, in one "
          f"launch and in chunks of 64, bitwise equal to the plain version "
          f"({plain_ms:.1f} ms) on seeds whose P is asymmetric by 1e-3")
    return out


def imm_scan_rung(launches):
    """The ladder's imm_scan rung on the multi-model IMM: ``run_sequence(
    make_imm(), "imm_scan")`` at the pod's N, T = STAGE_T, its default
    symmetrize=False (imm_scan.cu's full square at K = 4), one launch a
    time chunk; its host ms a run and µs a step (a Table I row), the
    launch's device ms at both symmetrize values (events, the device
    queued) and bounds. Held to the float64 oracle on N_SAMPLE lanes by
    the rule of the IMM states (PERF.md §2): within TOL, or ROUTE_SLACK
    times the distance of the same rung at symmetrize=True (the triangle
    route phase 4's replay holds to TOL) -- the float32 IMM on this
    maneuvering stream is chaotic at that level: one ill-conditioned
    lane's velocity sets the maximum, and last-bit differences (the CPU's
    exp against the card's) move it either way for either contract. The
    float32 oracle's distance is printed beside them. Adds its launches to
    ``launches``; returns the row."""
    imm = replay_model("imm")
    N = kcfg.LKF_POD.batch
    host = stage_inputs("imm", "pod", N)
    zs, x0, P0 = dev_(*host)
    pick, exact = stage_oracle("imm", *host)
    rewrites.run_sequence(imm, "imm_scan", zs, x0, P0, device=DEV)
    ops.reset_launches()
    xs, ms = timed_host(lambda: rewrites.run_sequence(
        imm, "imm_scan", zs, x0, P0, device=DEV))
    counts = dict(ops.LAUNCHES)
    want = chunk_launches("katana_imm_sequence", STAGE_T)
    assert counts["katana_imm_sequence"] == want, counts
    assert sum(counts.values()) == want, counts
    by_stage = launches.setdefault("katana_imm_sequence", {})
    by_stage["imm_scan"] = by_stage.get("imm_scan", 0) + want
    lanes = torch.as_tensor(pick, device=DEV)
    err = max_rel(xs[:, lanes].cpu(), torch.as_tensor(exact))
    err_sym = max_rel(rewrites.run_sequence(
        imm, "imm_scan", zs, x0, P0, symmetrize=True, device=DEV)[
            :, lanes].cpu(), torch.as_tensor(exact))
    err32 = max_rel(torch.as_tensor(oracle.run_imm_batched(
        imm, host[0][:, pick].astype(np.float64), host[1][pick],
        host[2][pick], dtype=np.float32)[0]), torch.as_tensor(exact))
    assert err <= max(TOL["imm"], ROUTE_SLACK * err_sym), (
        "imm", "imm_scan", N, err, err_sym)
    kern = {}
    for sym in (False, True):
        kms = cuda_ms(lambda: ops.katana_imm_sequence(
            imm, zs, x0, P0, symmetrize=sym), 5, spin=True)
        bms, by = bound(*scan_work(imm, N, STAGE_T, sym))
        kern["sym" if sym else "full_square"] = dict(
            ms=kms, bound_ms=bms, bound_by=by,
            lane_tile=ops.LAST_CONFIG["katana_imm_sequence"]["lane_tile"])
    row = dict(filter="imm", stage="imm_scan", N=N, T=STAGE_T,
               config=f"make_imm() at {kcfg.LKF_POD.name}'s N", ms=ms,
               us_per_step=ms * 1e3 / STAGE_T,
               steps_per_s=STAGE_T / ms * 1e3, max_rel_vs_f64=err,
               sym_max_rel_vs_f64=err_sym, f32_oracle_max_rel_vs_f64=err32,
               oracle_lanes=len(pick), launches=want, kernel=kern)
    print(f"[stages] imm {'imm_scan':17s} N={N:<6d} "
          f"{row['us_per_step']:10.1f} µs/step "
          f"{row['steps_per_s']:10.1f} steps/s  vs float64 "
          f"{err:.3g} ({len(pick)} lanes; symmetrize=True {err_sym:.3g}, "
          f"the float32 oracle {err32:.3g}); K=4 in {want} launch(es); the "
          "launch " + ", ".join(
              f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.4f} by "
              f"{v['bound_by']}, {v['bound_ms'] / v['ms']:.1%})"
              for k, v in kern.items()))
    return row


# ---------------------------------------------------------------------------
# LM serving: h2o-danube-1.8b at full width (src/repro_torch/configs/
# h2o_danube_1_8b.py, arXiv:2401.16818: 24 layers, d 2560, 32 heads over 8
# kv heads of 80, SwiGLU 6912, vocab 32000, window 4096), random bf16
# weights from a seeded generator, B = 4 prompts of S = 8192 tokens (S > W:
# the window mask and the prefill cache cut both run), 32 greedy decode
# steps over the 4096-long cache.
# ---------------------------------------------------------------------------

LM_ARCH, LM_B, LM_S, LM_STEPS = "h2o-danube-1.8b", 4, 8192, 32
SMALL_ATTN = [  # (B, S, H, KH, d, causal, window): kernels vs plain, float32
    (2, 128, 4, 4, 32, True, None), (2, 200, 8, 2, 80, True, 64),
    (1, 77, 4, 1, 128, False, None), (1, 300, 2, 2, 8, False, 40)]
SMALL_DECODE = [(2, 4, 2, 128, 32), (2, 32, 8, 256, 80), (1, 48, 1, 128, 128)]


def bf16_ulp_excess(a, b) -> float:
    """max of |a - b| / (one bf16 ulp of max(|a|, |b|, 2^-6)): <= 1 means
    the two agree to one ulp of the output (near zero the float32 sums of
    two orders differ by ~1e-8, more than a bf16 ulp of the value)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp_min(2 ** -6))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a),
                                              e - 8)).max())


def attention_work(B, S, H, KH, d, window, itemsize):
    """(bytes, operations) of one causal flash_attention call: q, k, v read
    once, o written once; 4 d operations (QK^T and PV) per visible
    (query, key) pair."""
    pairs = sum(min(q + 1, window or S) for q in range(S))
    return (2 * B * S * (H + KH) * d * itemsize, 4 * d * pairs * B * H)


def tf32x3_excess(got, q, k, v, scale, causal, window) -> float:
    """The float32 flash_attention kernel against its own arithmetic
    (``ref.flash_attention_tf32x3_plain``: 3xTF32 products in another
    order): max |d| / (2e-5 + 1e-4 |x|), <= 1 passes."""
    want = fa_ref.flash_attention_tf32x3_plain(q, k, v, scale, causal,
                                               window)
    return float(((got - want).abs() / (2e-5 + 1e-4 * want.abs())).max())


def lm_kernels_vs_plain():
    """Each LM kernel against its plain version at small shapes in float32
    (flash_attention 2e-5, as tests/test_kernels.py, and 2e-5 + 1e-4|x| of
    the 3xTF32 plain version; flash_decode's normalised output and m
    1e-5/1e-4, l rtol 1e-4)."""
    rng = np.random.default_rng(13)
    err_a = err_d = ex3 = 0.0
    for B, S, H, KH, d, causal, window in SMALL_ATTN:
        q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                                   dtype=torch.float32, device=DEV)
                   for h in (H, KH, KH))
        got = fa_ops.flash_attention(q, k, v, d ** -0.5, causal, window)
        want = fa_ref.flash_attention_plain(q, k, v, d ** -0.5, causal,
                                            window)
        e = max_diff(got, want)
        assert e <= 2e-5, ("flash_attention", B, S, H, KH, d, e)
        x3 = tf32x3_excess(got, q, k, v, d ** -0.5, causal, window)
        assert x3 <= 1.0, ("flash_attention vs 3xTF32 plain", B, S, H, KH, d,
                           x3)
        err_a, ex3 = max(err_a, e), max(ex3, x3)
    for B, H, KH, T, d in SMALL_DECODE:
        q = torch.as_tensor(rng.normal(size=(B, H, d)), dtype=torch.float32,
                            device=DEV)
        k, v = (torch.as_tensor(rng.normal(size=(B, T, KH, d)),
                                dtype=torch.float32, device=DEV)
                for _ in range(2))
        acc, m, l = fd_ops.flash_decode_partial(q, k, v, scale=d ** -0.5,
                                                block_k=T)
        acc_p, m_p, l_p = fd_ref.flash_decode_partial_plain(q, k, v,
                                                            d ** -0.5)
        torch.testing.assert_close(acc / l, acc_p / l_p, atol=1e-5,
                                   rtol=1e-4)
        torch.testing.assert_close(m, m_p, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(l, l_p, atol=0, rtol=1e-4)
        err_d = max(err_d, max_diff(acc / l, acc_p / l_p))
    print(f"LM kernels vs plain, float32: flash_attention max|d| "
          f"{err_a:.3g} over {len(SMALL_ATTN)} shapes (<= 2e-5), "
          f"{ex3:.3g} of 2e-5 + 1e-4|x| from the 3xTF32 plain version; "
          f"flash_decode out max|d| {err_d:.3g} over {len(SMALL_DECODE)} "
          "shapes (<= 1e-5 + 1e-4|x|)")
    return err_a, err_d


def sdpa_ms(q, k, v, mask, iters):
    """The library call's time (for the record; the port never calls it):
    ``scaled_dot_product_attention`` on the memory-efficient backend with
    the kv heads repeated, (B, S, H, d) in. None if it refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), iters)
    except RuntimeError as exc:
        print(f"  library call refused: {str(exc).splitlines()[0][:160]}")
        return None


def busy_profile(fn):
    """(host ms, device-busy share, {kernel name: device ms}, {kernel
    name: events}) of one synchronised call of ``fn`` under
    torch.profiler: the CUDA kernels' durations summed (one stream: they
    do not overlap) against the host clock around the call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(profiling.ACTIVITIES)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by, count = profiling.kernel_events(prof)
    return wall, sum(by.values()) / wall, by, count


def print_profile(what, wall, share, by, count, card, top=6, tag="lm"):
    total = sum(by.values())
    print(f"[{tag}] {what}: {wall:.2f} ms host, device busy {share:.4f} "
          f"({total:.2f} ms in {len(by)} kernel names, "
          f"{sum(count.values())} kernel events); top: " + "; ".join(
              f"{k[:48]} {v:.2f} ms" for k, v in sorted(
                  by.items(), key=lambda kv: -kv[1])[:top]) + f" | {card}")


def _dev_line(by_name) -> str:
    """Device ms by kernel name (torch.profiler), short names."""
    return ", ".join(f"{k.split('(')[0].removeprefix('void ')[:40]} "
                     f"{v:.4f} ms" for k, v in sorted(by_name.items(),
                                                     key=lambda kv: -kv[1]))


def per_launch(by_name, part, n):
    """{kernel name: device ms a launch} of the kernels whose name holds
    ``part``, from a profile of a step that launched each n times."""
    return {k: v / n for k, v in by_name.items() if part in k}


def ptxas_registers(source, *parts):
    """Registers ptxas gave the entry of ``source`` whose mangled name
    holds every one of ``parts`` (phase 1's build log), or None."""
    entry = None
    for ln in build.BUILD_LOG.get(source, {}).get("ptxas", []):
        if "Compiling entry" in ln:
            entry = ln
        elif entry and "registers" in ln and all(p in entry for p in parts):
            return int(ln.split("Used ")[1].split()[0])
    return None


def _print_ptxas_of(source, *entries):
    """The ptxas spill and register lines of each entry of ``source``
    whose mangled name holds every part of one of ``entries``."""
    entry = None
    for ln in build.BUILD_LOG.get(source, {}).get("ptxas", []):
        if "Compiling entry" in ln:
            entry = ln
        elif entry and any(all(p in entry for p in parts)
                           for parts in entries):
            print(f"  {source} {entry.split(chr(39))[1]}: {ln}")


def _print_ptxas(source):
    print(f"  {source} (ptxas):")
    for ln in build.BUILD_LOG.get(source, {}).get("ptxas", []):
        print(f"    {ln}")


def fwd_registers():
    """ptxas's registers and spill stores of each forward kernel of
    flash_attention.cu at each width, by kernel name."""
    regs = {}
    for dp in (16, 32, 64, 80, 128):
        for name, part in ((f"flash_fwd_tf32x3<{dp}>",
                            f"16flash_fwd_tf32x3ILi{dp}E"),
                           (f"flash_fwd_wgmma<{dp}>",
                            f"15flash_fwd_wgmmaILi{dp}E")):
            regs[name] = dict(
                registers=ptxas_registers("flash_attention.cu", part),
                spill_stores=ptxas_spill("flash_attention.cu", part))
    return regs


def phase_lm(cfg, B, S, steps, card):
    """LM serving through the port's entry points: prefill on
    flash_attention, greedy decode on flash_decode; then the checks
    against the torch-op routes and the kernels' numbers."""
    acfg = cfg.attention
    H, KH, d, W = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim, \
        acfg.sliding_window
    err_a, err_d = lm_kernels_vs_plain()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    prompts = torch.as_tensor(LMDataPipeline(cfg.vocab, S, B, seed=0)
                              .next_batch()["tokens"], device=DEV).long()
    serve = ShardingContext(attn_impl="flash")
    prefill = make_prefill_step(cfg, serve)
    decode = make_decode_step(cfg, serve)
    prefill(params, {"tokens": prompts[:, :128]})  # load, warm up
    torch.cuda.synchronize()

    # -- the main path, counters reset just before and read just after --
    fa_ops.reset_launches()
    fd_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache0 = {n: type(c)(c.k.clone(), c.v.clone()) for n, c in caches.items()}
    tok = logits[:, -1].argmax(-1, keepdim=True)
    toks, step_ms = [tok], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, caches = decode(params, {"token": tok, "cache_pos": S + i},
                             caches)
        tok = out[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    launches = {**fa_ops.LAUNCHES, **fd_ops.LAUNCHES}
    assert launches["flash_attention"] == cfg.n_layers, launches
    assert launches["flash_decode"] == cfg.n_layers * steps, launches
    assert logits.shape == (B, 1, cfg.vocab) and out.shape == logits.shape
    assert bool(torch.isfinite(logits).all() and torch.isfinite(out).all())
    assert caches["layer0"].k.shape[2] == min(S, W or S)
    decode_ms = float(np.mean(step_ms))
    print(f"[lm] {cfg.name} B={B} S={S}: prefill {prefill_ms:.1f} ms "
          f"({B * S / prefill_ms * 1e3:.4g} tokens/s); decode {steps} steps "
          f"{decode_ms:.3f} ms/token ({B * 1e3 / decode_ms:.1f} tokens/s, "
          f"steps {min(step_ms):.3f}-{max(step_ms):.3f} ms); launches "
          f"{launches} | {card}")

    # -- prefill against the banded swa route (bf16) and float32 truth --
    logits_swa, caches_swa = make_prefill_step(
        cfg, ShardingContext(attn_impl="swa"))(params, {"tokens": prompts})
    p32 = _tree_map(lambda t: t.float(), params)
    logits_32, caches_32 = make_prefill_step(
        cfg, ShardingContext(attn_impl="swa"))(p32, {"tokens": prompts})
    del p32
    torch.cuda.empty_cache()

    e_flash, e_swa = _rel(logits, logits_32), _rel(logits_swa, logits_32)
    gap = _rel(logits, logits_swa)
    print(f"[lm] last-position logits, max|d| / max|float32 swa|: flash "
          f"route {e_flash:.4g}, bf16 swa route {e_swa:.4g}; flash vs swa "
          f"{gap:.4g}")
    # Held: the flash route within ROUTE_SLACK x the bf16 swa route's own
    # error from the float32 run, or within one bf16 ulp of the scale
    # (2^-8): the same rule for every layer's cache.
    assert e_flash <= max(2 ** -8, ROUTE_SLACK * e_swa), (e_flash, e_swa)
    cache_rows = []
    for name in caches_swa:
        for f in ("k", "v"):
            a = getattr(cache0[name], f)
            b = getattr(caches_swa[name], f)
            c = getattr(caches_32[name], f)
            for g in range(a.shape[0]):
                ef, es = _rel(a[g], c[g]), _rel(b[g], c[g])
                assert ef <= max(2 ** -8, ROUTE_SLACK * es), (f, g, ef, es)
                cache_rows.append((f, g, ef, es))
    worst = max(cache_rows, key=lambda r: r[2])
    print(f"[lm] caches ({len(cache_rows)} layer tensors of "
          f"{tuple(cache0['layer0'].k.shape[1:])}): layer 0 k flash == swa "
          f"{torch.equal(cache0['layer0'].k[0], caches_swa['layer0'].k[0])}; "
          f"worst flash-route error {worst[2]:.4g} ({worst[0]} layer "
          f"{worst[1]}; swa route there {worst[3]:.4g}); every layer within "
          f"max(2^-8, {ROUTE_SLACK} x swa)")
    del caches_32, logits_32
    torch.cuda.empty_cache()

    # -- greedy tokens of the reference route (swa prefill, dense decode) --
    dense = make_decode_step(cfg, ShardingContext(attn_impl="swa"))
    tok_r = logits_swa[:, -1].argmax(-1, keepdim=True)
    toks_r = [tok_r]
    for i in range(steps):
        out_r, caches_swa = dense(params, {"token": tok_r,
                                           "cache_pos": S + i}, caches_swa)
        tok_r = out_r[:, -1].argmax(-1, keepdim=True)
        toks_r.append(tok_r)
    same = float((torch.cat(toks, 1) == torch.cat(toks_r, 1)).float().mean())
    first = int((torch.cat(toks, 1) != torch.cat(toks_r, 1)).any(0)
                .nonzero()[0]) if same < 1 else None
    print(f"[lm] greedy tokens identical to the reference route: "
          f"{same:.4f} of {B} x {steps + 1} (first differing step: "
          f"{first})")
    del caches_swa
    torch.cuda.empty_cache()

    # -- flash_decode on decode step 0's real inputs, every layer --
    captured = []
    real = attn_lib.flash_decode

    def spy(q, kc, vc, kn, vn, **kw):
        captured.append(tuple(t.clone() for t in (q, kc, vc, kn, vn)))
        return real(q, kc, vc, kn, vn, **kw)

    attn_lib.flash_decode = spy
    try:
        decode(params, {"token": toks[0], "cache_pos": S}, cache0)
    finally:
        attn_lib.flash_decode = real
    assert len(captured) == cfg.n_layers
    scale = d ** -0.5
    bk = math.gcd(captured[0][1].shape[1], 1024)
    d32 = dbf = 0.0
    for q, kc, vc, kn, vn in captured:
        f32 = [t.float() for t in (q, kc, vc, kn, vn)]
        got = fd_ops.flash_decode(*f32, scale=scale, block_k=bk)
        want = fd_ref.flash_decode_ref(*f32, scale=scale)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        d32 = max(d32, max_diff(got, want))
        dbf = max(dbf, max_diff(fd_ops.flash_decode(q, kc, vc, kn, vn,
                                                    scale=scale, block_k=bk),
                                fd_ref.flash_decode_ref(q, kc, vc, kn, vn,
                                                        scale=scale)))
    print(f"[lm] flash_decode vs decode_attention on decode step 0's inputs "
          f"of all {len(captured)} layers: float32 max|d| {d32:.3g} "
          f"(1e-5/1e-4); bf16 max|d| {dbf:.3g} (printed: the dense route "
          "rounds p to bf16 before PV)")

    # -- where the time goes: one prefill, one decode step (profiled) --
    profs = fresh_profile("serve", {"tokens": prompts}, arch=cfg.name, S=S)
    prof_prefill, prof_decode = profs["prefill"], profs["decode_step"]
    print_profile("prefill profile", *prof_prefill, card)
    print_profile("decode step profile", *prof_decode, card)

    # -- the kernels at one layer of the serving shape, bf16 --
    rng = np.random.default_rng(21)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                               dtype=torch.float32, device=DEV).bfloat16()
               for h in (H, KH, KH))
    got = fa_ops.flash_attention(q, k, v, scale, True, W)
    want, a_plain = timed_once(lambda: fa_ref.flash_attention_plain(
        q, k, v, scale, True, W))
    ulps = bf16_ulp_excess(got, want)
    assert ulps <= 1.0, ("flash_attention bf16", ulps)
    a_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, scale, True, W),
                   5, warmup=1)
    a_dev = per_launch(prof_prefill[2], "flash_fwd", cfg.n_layers)
    assert any(fa_ops.KERNELS[torch.bfloat16] in n for n in a_dev), a_dev
    band = fa_ref.mask(S, S, True, W, DEV)
    a_lib = sdpa_ms(q, k, v, band, 5)
    nb, nops = attention_work(B, S, H, KH, d, W, 2)
    a_bound = max(nb / HBM_BPS, nops / BF16_OPS) * 1e3
    a_by = "bytes" if nb / HBM_BPS >= nops / BF16_OPS else "operations"
    a_cfg = fa_ops.config(torch.bfloat16, d)
    f_cfg = fa_ops.config(torch.float32, d)
    q_at = ("in registers" if f_cfg["q_in_registers"]
            else "from shared memory")
    kv_at = ("at staging" if f_cfg["kv_split_at_staging"]
             else "as each fragment loads")
    a_design = (f"{fa_ops.KERNELS[torch.bfloat16]}: {a_cfg['block_q']}-query "
                f"tiles ({a_cfg['block_q'] // 64} consumer warpgroups) x "
                f"{a_cfg['block_k']}-key "
                f"tiles, {a_cfg['threads']} threads, TMA ring of "
                f"{a_cfg['stages']} stages; wgmma m64n64k16 for QK^T, 2 x "
                f"m64n{a_cfg['pv_mma_n']}k16 (p hi + lo) for PV; grid "
                f"{B * H} x {-(-S // a_cfg['block_q'])}; float32 runs "
                f"{fa_ops.KERNELS[torch.float32]}: "
                f"{f_cfg['block_q']}-query tiles x {f_cfg['block_k']}-key "
                f"tiles, {f_cfg['threads']} threads, {f_cfg['instruction']} "
                f"(3xTF32) for QK^T and PV, Q's split fragments {q_at}, K "
                f"and V split {kv_at}, {f_cfg['stages']} cp.async "
                f"stage(s)")
    print(f"[lm] flash_attention B={B} S={S} H={H} KH={KH} d={d} W={W} bf16: "
          f"{a_ms:.3f} ms (device {_dev_line(a_dev)}; plain {a_plain:.1f} "
          f"ms, library {a_lib if a_lib is None else round(a_lib, 3)} ms), "
          f"max|d| vs plain {max_diff(got, want):.3g} = {ulps:.3g} bf16 ulp; "
          f"bound {a_bound:.4f} ms by {a_by} at the bf16 tensor-core peak "
          f"({nb} B, {nops} ops; float32's 3xTF32 at the TF32 peak "
          f"{3 * nops / TF32_OPS * 1e3:.2f} ms), {a_bound / a_ms:.4f} of "
          f"the bound | {card}")
    print(f"[lm] flash_attention design: {a_design}")
    _print_ptxas("flash_attention.cu")

    q0, kc, vc, kn, vn = captured[0]
    acc_got = fd_ops.flash_decode_partial(q0[:, 0], kc, vc, scale=scale,
                                          block_k=bk)
    acc_want, d_plain = timed_once(lambda: fd_ref.flash_decode_partial_plain(
        q0[:, 0], kc, vc, scale))
    out_got = acc_got[0] / acc_got[2]
    out_want = acc_want[0] / acc_want[2]
    torch.testing.assert_close(out_got, out_want, atol=1e-5, rtol=1e-4)
    d_ms = cuda_ms(lambda: fd_ops.flash_decode_partial(
        q0[:, 0], kc, vc, scale=scale, block_k=bk), 50)
    d_dev = per_launch(prof_decode[2], "fd::decode_", cfg.n_layers)
    T = kc.shape[1]
    kfull, vfull = torch.cat([kc, kn], 1), torch.cat([vc, vn], 1)
    d_lib = sdpa_ms(q0, kfull, vfull, None, 50)
    nb_d = (2 * B * T * KH * d + B * H * d) * 2 + (B * H * d + 2 * B * H) * 4
    nops_d = 4 * d * T * B * H
    d_bound = max(nb_d / HBM_BPS, nops_d / BF16_OPS) * 1e3
    d_by = "bytes" if nb_d / HBM_BPS >= nops_d / BF16_OPS else "operations"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = fd_ops.choose_split(B, KH, T, H // KH, sms)
    n_split = -(-T // split)
    d_cfg = fd_ops.config()
    d_design = (f"pass 1 decode_split: {n_split} splits of {split} keys x "
                f"{KH} kv heads x {B} batches = {n_split * KH * B} blocks of "
                f"{d_cfg['threads']} threads, the split's K and V staged by "
                f"16-byte cp.async (budget {d_cfg['smem_budget']} B); scores "
                f"a thread a key row, PV a half-warp a key row, "
                f"{d_cfg['chunk']} values a lane; "
                f"pass 2 decode_merge: {B * H} blocks; one kv head a block")
    assert n_split * KH * B > sms, (sms, d_design)
    print(f"[lm] flash_decode B={B} T={T} H={H} KH={KH} d={d} bf16 (layer 0, "
          f"decode step 0): {d_ms:.4f} ms by events per wrapper call "
          f"(device {_dev_line(d_dev)}; plain {d_plain:.3f} ms, library "
          f"over cache + self {d_lib if d_lib is None else round(d_lib, 4)} "
          f"ms), out max|d| vs plain {max_diff(out_got, out_want):.3g}; "
          f"bound {d_bound:.5f} ms by {d_by} ({nb_d} B), {d_bound / d_ms:.4f} "
          f"of the bound by events, {d_bound / sum(d_dev.values()):.4f} by "
          f"device time | {card}")
    print(f"[lm] flash_decode design: {d_design} ({sms} SMs)")
    _print_ptxas("flash_decode.cu")
    row = dict(arch=cfg.name, B=B, S=S, decode_steps=steps,
               prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               decode_tokens_per_s=B * 1e3 / decode_ms, step_ms=step_ms,
               launches=launches, logits_err_flash=e_flash,
               logits_err_swa=e_swa, logits_gap=gap, token_share=same,
               first_token_difference=first, decode_f32_max_abs=d32,
               decode_bf16_max_abs=dbf,
               profile={k: dict(host_ms=v[0], device_busy=v[1],
                                kernels_ms=v[2])
                        for k, v in (("prefill", prof_prefill),
                                     ("decode_step", prof_decode))})
    kern = dict(
        flash_attention=dict(ms=a_ms, plain_ms=a_plain, library_ms=a_lib,
                             bound_ms=a_bound, bound_by=a_by,
                             launches=launches["flash_attention"],
                             max_abs_err=max(err_a, max_diff(got, want)),
                             bf16_ulps=ulps, bytes=nb, operations=nops,
                             bound_share=a_bound / a_ms, device_ms=a_dev,
                             design=a_design, registers=fwd_registers(),
                             shape=f"B={B} S={S} H={H} KH={KH} d={d} "
                                   f"window={W} bf16, causal; bound at the "
                                   "bf16 tensor-core peak"),
        flash_decode=dict(ms=d_ms, plain_ms=d_plain, library_ms=d_lib,
                          bound_ms=d_bound, bound_by=d_by,
                          launches=launches["flash_decode"],
                          max_abs_err=max(err_d, d32),
                          bytes=nb_d, operations=nops_d,
                          bound_share=d_bound / d_ms, device_ms=d_dev,
                          design=d_design,
                          shape=f"B={B} T={T} H={H} KH={KH} d={d} bf16 "
                                "(layer 0's cache at decode step 0)"))
    return row, kern


# ---------------------------------------------------------------------------
# Phase 8: Mamba-2 serving (mamba2-130m) through ssd_scan
# ---------------------------------------------------------------------------

MAMBA_ARCH, MAMBA_B, MAMBA_S, MAMBA_STEPS = "mamba2-130m", 8, 32768, 32
MAMBA_CHECK_B = 2  # prompts of the float32 and bf16 route checks
# the bf16 route's launches (csrc/ssd_scan.cu)
SSD_KERNELS = ("ssd_cum", "ssd_chunk_state", "ssd_state_pass",
               "ssd_chunk_out")
SMALL_SSD = [  # (B, S, H, P, N, chunk, state0, dt scale): float32
    (2, 512, 4, 64, 128, 256, False, 0.5), (1, 100, 2, 16, 16, 256, True, 0.5),
    (2, 96, 3, 32, 64, 32, True, 0.5), (1, 384, 2, 128, 32, 128, False, 0.5),
    (2, 128, 2, 16, 16, 64, True, 20.0)]


def ssd_inputs(rng, B, S, H, P, N, dtype, dt_scale=0.5, state=False):
    """x, dt (softplus of a normal, times dt_scale), Bm, Cm, A (H,)
    negative and state0 (or None), as the model hands them to ssd_scan."""
    def mk(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=DEV)

    dt = torch.nn.functional.softplus(mk(B, S, H)) * dt_scale
    return (mk(B, S, H, P).to(dtype), dt, mk(B, S, N).to(dtype),
            mk(B, S, N).to(dtype), -torch.exp(mk(H)),
            mk(B, H, P, N) if state else None)


def ssd_kernel_vs_plain():
    """ssd_scan against ssd_scan_plain at small shapes in float32: y and
    the final state within 1e-5 + 1e-4|x|. The last shape's dt A reaches
    about -40 a step, so exp(cum_i - cum_j) above the diagonal would
    overflow to inf: the outputs must stay finite."""
    rng = np.random.default_rng(17)
    err = 0.0
    for B, S, H, P, N, chunk, state, scale in SMALL_SSD:
        args = ssd_inputs(rng, B, S, H, P, N, torch.float32, scale, state)
        got = ssd_ops.ssd_scan(*args[:5], chunk=chunk, state0=args[5])
        want = ssd_ref.ssd_scan_plain(*args[:5], chunk, args[5])
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all()), ("ssd_scan", B, S, N)
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
            err = max(err, max_diff(g, w))
    print(f"ssd_scan vs plain, float32: max|d| {err:.3g} over "
          f"{len(SMALL_SSD)} shapes (S < chunk, state0, overflowing decay; "
          "<= 1e-5 + 1e-4|x|)")
    return err


def ssd_work(B, S, H, P, N, Q, itemsize):
    """(bytes, operations) of one ssd_scan call: x, dt, B, C, A read once,
    y and the final state written once; C B^T on the diagonal and below
    once per (batch, chunk) (B and C are shared by the heads), then per
    (batch, head, chunk) the weighted product W x on the diagonal and
    below, the state's read (C state^T) and its update (x^T B), 2
    operations a multiply-add."""
    nc = S // Q
    tri = Q * (Q + 1) // 2
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * itemsize + \
        B * S * H * 4 + H * 4 + B * H * P * N * 4
    ops_ = 2 * B * nc * tri * N + 2 * B * H * nc * (tri * P + 2 * Q * P * N)
    return nbytes, ops_


def _ssd_chunked_as_scan(x, dt, Bm, Cm, A, chunk=256, state0=None,
                         interpret=True):
    """ops.ssd_scan's signature on models.ssm.ssd_chunked (the reference's
    pure function): the route the checks measure the kernel against."""
    return ssm_lib.ssd_chunked(x, dt, Bm, Cm, A, chunk, state0)


def phase_mamba(cfg, B, S, steps, card):
    """Mamba-2 serving through the port's entry points: prefill on
    ssd_scan, greedy decode on the one-step recurrence; then the checks
    against ``ssd_chunked`` and the kernel's numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, H, P = ssm_lib.ssm_dims(cfg.ssm, cfg.d_model)
    N = cfg.ssm.d_state
    Q = min(cfg.ssm.chunk, S)
    err_small = ssd_kernel_vs_plain()
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.as_tensor(LMDataPipeline(cfg.vocab, S, B, seed=0)
                              .next_batch()["tokens"], device=DEV).long()
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    # warm-up at the serving shape, keeping layer 0's ssd_scan inputs
    captured = []
    real = ssm_lib.ops.ssd_scan

    def spy(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return real(*args, **kw)

    with mock.patch.object(ssm_lib.ops, "ssd_scan", spy):
        prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()

    # -- the main path, counters reset just before and read just after --
    ssd_ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = ssd_ops.LAUNCHES["ssd_scan"]
    check = {n: type(c)(*(t[:, :MAMBA_CHECK_B].clone() for t in c))
             for n, c in caches.items()}
    tok = logits[:, -1].argmax(-1, keepdim=True)
    step_ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, caches = decode(params, {"token": tok, "cache_pos": S + i},
                             caches)
        tok = out[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ssd_ops.LAUNCHES["ssd_scan"]
    assert after_prefill == cfg.n_layers, after_prefill
    assert launches == cfg.n_layers, ("decode launched ssd_scan", launches)
    assert logits.shape == (B, 1, cfg.vocab) and out.shape == logits.shape
    assert bool(torch.isfinite(logits).all() and torch.isfinite(out).all())
    assert caches["layer0"].state.shape == (cfg.n_layers, B, H, P, N)
    decode_ms = float(np.mean(step_ms))
    print(f"[mamba] {cfg.name} ({n_params / 1e6:.1f} M parameters) B={B} "
          f"S={S}: prefill {prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:.4g}"
          f" tokens/s); decode {steps} steps {decode_ms:.3f} ms/token "
          f"({B * 1e3 / decode_ms:.1f} tokens/s, steps {min(step_ms):.3f}-"
          f"{max(step_ms):.3f} ms); ssd_scan launches {after_prefill} in the "
          f"prefill, {launches - after_prefill} in the decode | {card}")

    # -- float32: the kernel route against ssd_chunked in its place --
    few = {"tokens": prompts[:MAMBA_CHECK_B]}
    p32 = _tree_map(lambda t: t.float(), params)
    logits_k32, caches_k32 = prefill(p32, few)
    with mock.patch.object(ssm_lib.ops, "ssd_scan", _ssd_chunked_as_scan):
        logits_32, caches_32 = prefill(p32, few)
        logits_c16, caches_c16 = prefill(params, few)
    del p32
    torch.cuda.empty_cache()
    e32 = _rel(logits_k32, logits_32)
    c32 = max(_rel(a[g], b[g]) for n in caches_32
              for a, b in zip(caches_k32[n], caches_32[n])
              for g in range(cfg.n_layers))
    print(f"[mamba] float32 prefill of {MAMBA_CHECK_B} prompts, kernel vs "
          f"ssd_chunked, max|d| / max|value|: logits {e32:.3g}, worst cache "
          f"tensor of a layer {c32:.3g} (<= 1e-4)")
    assert e32 <= 1e-4 and c32 <= 1e-4, (e32, c32)

    # -- bf16: the kernel route and ssd_chunked's, both from float32 --
    # Held: the kernel route within ROUTE_SLACK x the bf16 ssd_chunked
    # route's own error, or within one bf16 ulp of the scale (2^-8); the
    # same rule for every layer's cache tensors.
    e_k = _rel(logits[:MAMBA_CHECK_B], logits_32)
    e_c = _rel(logits_c16, logits_32)
    assert e_k <= max(2 ** -8, ROUTE_SLACK * e_c), (e_k, e_c)
    rows = []
    for n in caches_32:
        for f, a, b, c in zip(caches_32[n]._fields, check[n], caches_c16[n],
                              caches_32[n]):
            for g in range(cfg.n_layers):
                ek, ec = _rel(a[g], c[g]), _rel(b[g], c[g])
                assert ek <= max(2 ** -8, ROUTE_SLACK * ec), (f, g, ek, ec)
                rows.append((f, g, ek, ec))
    worst = max(rows, key=lambda r: r[2])
    print(f"[mamba] bf16 routes from float32, max|d| / max|value|: logits "
          f"kernel {e_k:.4g}, ssd_chunked {e_c:.4g}; worst cache tensor "
          f"{worst[2]:.4g} ({worst[0]} layer {worst[1]}; ssd_chunked there "
          f"{worst[3]:.4g}); all {len(rows)} within max(2^-8, "
          f"{ROUTE_SLACK} x ssd_chunked)")
    del caches_32, caches_c16, caches_k32, check
    torch.cuda.empty_cache()

    # -- where the time goes: one prefill, one decode step (profiled) --
    profs = fresh_profile("serve", {"tokens": prompts}, arch=cfg.name, S=S)
    prof_prefill, prof_decode = profs["prefill"], profs["decode_step"]
    print_profile("prefill profile", *prof_prefill, card, tag="mamba")
    print_profile("decode step profile", *prof_decode, card, tag="mamba")

    # -- the kernel on layer 0's real prefill inputs, bf16 --
    args, kw = captured[0]
    x, dt, Bm, Cm, A = args[:5]
    assert x.shape == (B, S, H, P) and x.dtype == torch.bfloat16
    y, st = ssd_ops.ssd_scan(*args, **kw)
    # held to the plain version that rounds as the tensor cores do, and
    # to the float32 one
    (y_p, st_p), s_plain = timed_once(
        lambda: ssd_ref.ssd_scan_hilo_plain(x, dt, Bm, Cm, A, Q))
    ulps = bf16_ulp_excess(y, y_p)
    st_err = _rel(st, st_p)
    assert ulps <= 1.0 and st_err <= 1e-4, ("ssd_scan bf16", ulps, st_err)
    y_f, st_f = ssd_ref.ssd_scan_plain(x, dt, Bm, Cm, A, Q)
    ulps_f, st_err_f = bf16_ulp_excess(y, y_f), _rel(st, st_f)
    assert ulps_f <= 1.0 and st_err_f <= 1e-4, ("ssd_scan bf16 vs float32 "
                                                "plain", ulps_f, st_err_f)
    del y_f, st_f
    pb = ssd_ops.block_p(P, N, Q, x.dtype)
    s_ms = cuda_ms(lambda: ssd_ops.ssd_scan(*args, **kw), 5, warmup=1)
    by_pb = {w: cuda_ms(lambda: ssd_ops._launch(x, dt, Bm, Cm, A, Q, None,
                                                w), 3, warmup=1)
             for w in ssd_ops.P_BLOCKS}
    # the four launches' device times
    s_dev, s_short = fresh_profile("ssd_scan", (args, kw), iters=3,
                                   launches={k: 1 for k in SSD_KERNELS})
    s_dev = {k: v for k, v in s_dev.items()
             if any(p in k for p in SSD_KERNELS)}
    # the float32 check route (the CUDA-core kernel) on the same inputs
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    f32_ms = cuda_ms(lambda: ssd_ops.ssd_scan(x32, dt, B32, C32, A, chunk=Q),
                     2, warmup=1)
    del x32, B32, C32
    torch.cuda.empty_cache()
    nb, nops = ssd_work(B, S, H, P, N, Q, 2)
    s_bound = max(nb / HBM_BPS, nops / BF16_OPS) * 1e3
    s_by = "bytes" if nb / HBM_BPS >= nops / BF16_OPS else "operations"
    print(f"[mamba] ssd_scan B={B} S={S} H={H} P={P} N={N} Q={Q} bf16 (layer "
          f"0's prefill inputs): {s_ms:.3f} ms at {pb} columns of p a pass "
          f"(" + ", ".join(f"{w}: {v:.3f}" for w, v in by_pb.items()) +
          f" ms; device ms a launch: {_dev_line(s_dev)}"
          f"{f' (events missing: {s_short})' if s_short else ''}; plain "
          f"{s_plain:.1f} "
          f"ms, no library call), y vs the hi/lo plain {ulps:.3g} bf16 ulp, "
          f"state {st_err:.3g} of its scale (float32 plain: {ulps_f:.3g} "
          f"ulp, {st_err_f:.3g}); bound {s_bound:.4f} ms by {s_by} ({nb} B, "
          f"{nops} ops; at the float32 CUDA-core peak "
          f"{nops / F32_OPS * 1e3:.2f} ms); the float32 route (CUDA cores) "
          f"{f32_ms:.3f} ms | {card}")
    prefill_dev = per_launch(prof_prefill[2], "ssd_", cfg.n_layers)
    prefill_n = {k: c for k, c in prof_prefill[3].items() if "ssd_" in k}
    print(f"[mamba] ssd_scan in the profiled prefill, device ms a launch: "
          f"{_dev_line(prefill_dev)}; events recorded "
          f"{sorted(prefill_n.values())} of {cfg.n_layers} launches each")
    row = dict(arch=cfg.name, B=B, S=S, decode_steps=steps,
               params=n_params, prefill_ms=prefill_ms,
               prefill_tokens_per_s=B * S / prefill_ms * 1e3,
               decode_ms_per_token=decode_ms,
               decode_tokens_per_s=B * 1e3 / decode_ms, step_ms=step_ms,
               launches_prefill=after_prefill,
               launches_decode=launches - after_prefill,
               f32_logits_err=e32, f32_cache_err=c32,
               bf16_logits_err_kernel=e_k, bf16_logits_err_chunked=e_c,
               bf16_worst_cache=worst,
               profile={k: dict(host_ms=v[0], device_busy=v[1],
                                kernels_ms=v[2])
                        for k, v in (("prefill", prof_prefill),
                                     ("decode_step", prof_decode))})
    kern = dict(ms=s_ms, plain_ms=s_plain, library_ms=None,
                bound_ms=s_bound, bound_by=s_by, launches=launches,
                max_abs_err=max(err_small, max_diff(y, y_p)),
                bf16_ulps=ulps, state_rel_err=st_err,
                bf16_ulps_vs_f32_plain=ulps_f,
                state_rel_err_vs_f32_plain=st_err_f,
                bytes=nb, operations=nops, ms_by_block_p=by_pb, block_p=pb,
                device_ms=s_dev, profile_whole=not s_short,
                prefill_device_ms=prefill_dev,
                prefill_events=prefill_n,
                f32_route_ms=f32_ms,
                shape=f"B={B} S={S} H={H} P={P} N={N} chunk={Q} bf16 (layer "
                      "0's prefill inputs; four launches: cum, chunk "
                      "states, state passing, outputs); plain_ms is the "
                      "hi/lo plain version's; bound at the bf16 tensor-core "
                      "peak; no single PyTorch call computes the SSD scan")
    return row, kern


# ---------------------------------------------------------------------------
# Phase 9: the streaming front end (serving/stream.py, serving/faults.py)
# on the card. Eight tenants on two shards of eight lanes (four each, so
# that the survivor can take a dead shard's four), both shards on the one
# card, each pump one fused frame call a live shard over its 8 lanes at
# phase 3's per-sensor shape (C = 1,024, M = 256). Tenant t submits phase
# 3's dense-sky scene of seed 7 + t, its valid rows a frame. Fake clock,
# dt 0.5 s; checkpoints in a temporary directory the phase deletes.
# ---------------------------------------------------------------------------

STREAM_TENANTS, STREAM_CYCLES, STREAM_KILL = 8, 100, 40
STREAM_DT = 0.5
STREAM_LOADS = (0.5, 1.0, 2.0)
STREAM_CFG = dict(n_shards=2, lanes_per_shard=8, queue_depth=4,
                  checkpoint_every=8, heartbeat_timeout_s=1.0)
# the bitwise runs stay at the FULL tier while a dead shard's queues back
# up, so the ladder is pushed out of reach there (as tests/test_chaos.py)
NO_LADDER = dict(degrade_at=5.0, coast_at=6.0, reject_at=7.0)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def stream_scenes(kind, T):
    """tenant name -> scene(i): the valid rows of frame i (k, m) of phase
    3's dense-sky scene drawn from seed 7 + t, T frames."""
    smodel = (filters.get_filter("cv9") if kind == "imm"
              else filters.get_filter(kind))
    scene = traj.SceneConfig(T=T, max_targets=200, birth_rate=1.0,
                             death_rate=0.002, clutter_rate=20.0,
                             extent=200.0, max_meas=M_SERVE)
    out = {}
    for t in range(STREAM_TENANTS):
        z, v = traj.mot_scene(smodel, scene, seed=7 + t)[:2]
        out[f"t{t}"] = [np.ascontiguousarray(z[i][v[i]], np.float32)
                        for i in range(T)].__getitem__
    return out


def stream_front(model, root, tag, t0=0.0, **kw):
    cfg = dict(STREAM_CFG, **kw)
    return StreamFrontEnd(model, StreamConfig(**cfg),
                          tracker.TrackerConfig(capacity=C_SERVE,
                                                max_meas=M_SERVE),
                          ckpt_dir=f"{root}/{tag}", clock=FakeClock(t0),
                          devices=("cuda",))


def count_wal(front):
    """A list whose one entry counts the WAL frames the front end's
    failovers replay (each one fused step over the survivor's lanes)."""
    steps = [0]
    restore = front._restore_tenant

    def counted(t, s, lane):
        steps[0] += len(t.wal)
        return restore(t, s, lane)

    front._restore_tenant = counted
    return steps


def stream_drive(front, scenes, plan, cycles, rate=1, budget=None):
    """ChaosDriver over ``cycles``, then the backlog drained: (report,
    launches of the run, WAL frames replayed). Every launch count is 0
    just before the run and read just after it."""
    for t in scenes:
        assert front.attach(t) == Admission.ACCEPTED
    wal = count_wal(front)
    drv = ChaosDriver(front, plan, scenes, front.clock.advance,
                      dt_s=STREAM_DT, deadline_budget_s=budget,
                      offered_rate=rate)
    ops.reset_launches()
    rep = drv.run(cycles)
    for _ in range(40):
        ups = front.pump()
        if not ups:
            break
        for t, u in ups.items():
            rep.updates[t].append(u)
        front.clock.advance(STREAM_DT)
    torch.cuda.synchronize()
    return rep, dict(ops.LAUNCHES), wal[0]


def stream_checks(tag, front, rep, launches, wal, name):
    """What every phase 9 run without an injected dispatch fault holds: no
    exception, no dispatch error, no breaker trip, and one frame launch
    (and one greedy) a dispatch or a replayed WAL frame."""
    s = front.stats
    assert rep.exceptions == [], (tag, rep.exceptions)
    assert s.dispatch_errors == 0 and front.breaker.trips == 0, (tag, s)
    want = s.dispatches + wal
    assert launches[name] == want and launches["greedy_assign"] == want, (
        tag, launches, s.dispatches, wal)
    for ups in rep.updates.values():
        for u in ups:
            for snap in u.snapshots:
                assert np.isfinite(snap.state).all(), (tag, u.tenant)
    print(f"[stream] {tag}: {s.dispatches} dispatches + {wal} WAL frames "
          f"replayed = {want} {name} launches ({launches[name]}) and "
          f"greedy_assign ({launches['greedy_assign']}); applied "
          f"{s.applied} (served {s.served}, coasted {s.coasted}, shed "
          f"{s.shed}), expired {s.expired}, duplicates {s.duplicates}, "
          f"rejected {s.rejected_overload + s.rejected_queue_full}, "
          f"checkpoints {s.checkpoints}, failovers {s.failovers}, "
          "dispatch errors 0, breaker trips 0, exceptions 0")
    return want


def streams_bitwise(ref, got):
    """Every tenant's TenantUpdate stream of ``got`` bit for bit the one
    of ``ref``: kinds, seqs, ids, hits, ages, states, mode_probs."""
    n = 0
    for t, ru in ref.updates.items():
        gu = got.updates[t]
        assert len(ru) == len(gu), (t, len(ru), len(gu))
        for r, g in zip(ru, gu):
            assert (r.frame, r.seq, r.kind, r.tier) == \
                (g.frame, g.seq, g.kind, g.tier), (t, r.frame)
            assert [(s.track_id, s.hits, s.age) for s in r.snapshots] == \
                [(s.track_id, s.hits, s.age) for s in g.snapshots], (
                    t, r.frame)
            for rs, gs in zip(r.snapshots, g.snapshots):
                assert np.array_equal(rs.state, gs.state), (t, r.frame)
                assert (rs.mode_probs is None) == (gs.mode_probs is None)
                if rs.mode_probs is not None:
                    assert np.array_equal(rs.mode_probs, gs.mode_probs)
                n += 1
    return n


class HostSplit:
    """Host seconds of a front end's pumps, split into the dispatch (its
    own span: the copy of zb and vb, the step, the stream's sync), the
    lane select, the snapshot copies and the checkpoint saves."""

    def __init__(self, front):
        self.s = dict(pump=0.0, dispatch=0.0, select=0.0, snapshots=0.0,
                      checkpoints=0.0)
        self.pumps = 0
        record = front.stragglers.record

        def dispatched(host, dt):
            self.s["dispatch"] += dt
            record(host, dt)

        front.stragglers.record = dispatched
        for part, attr in (("snapshots", "_host_fields"),
                           ("snapshots", "_lane_snapshots"),
                           ("checkpoints", "_checkpoint")):
            setattr(front, attr, self._timed(part, getattr(front, attr)))
        self.select = self._timed("select", stream_mod._select_lanes)
        pump = self._timed("pump", front.pump)

        def counted():
            self.pumps += 1
            return pump()

        front.pump = counted

    def _timed(self, part, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[part] += time.perf_counter() - t0
        return timed

    def ms_a_pump(self):
        out = {k: 1e3 * v / self.pumps for k, v in self.s.items()}
        out["rest"] = out["pump"] - sum(out[k] for k in (
            "dispatch", "select", "snapshots", "checkpoints"))
        return out


def stream_load_row(model, root, scenes, x, name, split=False):
    """``benchmarks/serving.py:_load_row`` on the card: offered load x
    (frames a tenant a pump) under StreamConfig's default ladder, the
    clock 0.05 s a cycle, both tiers' steps warmed up before the clock;
    the backlog drained at the end."""
    front = stream_front(model, root, f"load{x}")
    for t in sorted(scenes):
        front.attach(t)
    L, M, m = STREAM_CFG["lanes_per_shard"], M_SERVE, model.m
    zb, vb = np.zeros((L, M, m), np.float32), np.zeros((L, M), bool)
    for tier in (ServiceTier.FULL, ServiceTier.WIDE_GATE):
        front._dispatch(front.shards[0].device, tier, front.shards[0].banks,
                        zb, vb)
    torch.cuda.synchronize()
    host = HostSplit(front) if split else None
    patch = (mock.patch.object(stream_mod, "_select_lanes", host.select)
             if split else contextlib.nullcontext())
    counts = {t: 0 for t in scenes}
    updates = {t: [] for t in scenes}
    exceptions = []
    acc, pumps = 0.0, 0
    ops.reset_launches()
    with patch:
        t0 = time.perf_counter()
        for cycle in range(STREAM_CYCLES + 4 * front.cfg.queue_depth):
            drain = cycle >= STREAM_CYCLES
            try:
                acc += 0.0 if drain else x
                while acc >= 1.0 - 1e-9:
                    acc -= 1.0
                    for t, scene in scenes.items():
                        front.submit(t, scene(counts[t]))
                        counts[t] += 1
                ups = front.pump()
            except Exception as e:  # noqa: BLE001 — counted, asserted 0
                exceptions.append(e)
                continue
            pumps += 1
            for t, u in ups.items():
                updates[t].append(u)
            front.clock.advance(0.05)
            if drain and not ups:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s = front.stats
    assert exceptions == [], exceptions
    assert s.dispatch_errors == 0 and front.breaker.trips == 0, s
    assert launches[name] == s.dispatches == launches["greedy_assign"], (
        launches, s.dispatches)
    streaks = {}
    for t, ups in updates.items():
        streak = longest = 0
        for u in ups:
            streak = streak + 1 if u.kind == "shed" else 0
            longest = max(longest, streak)
        streaks[t] = longest
    assert all(ups for ups in updates.values()), {
        t: len(u) for t, u in updates.items()}
    assert max(streaks.values()) <= front.cfg.starve_limit, streaks
    applied = sum(len(u) for u in updates.values())
    assert applied == s.applied
    tiers = sorted({int(u.tier) for ups in updates.values() for u in ups})
    row = dict(offered_x=x, tenants=len(scenes), cycles=STREAM_CYCLES,
               pumps=pumps, wall_s=wall, pumps_per_s=pumps / wall,
               tenant_frames_per_s=applied / wall, applied=applied,
               submitted=s.submitted,
               served_fraction=s.served / s.applied,
               shed_fraction=(s.shed + s.replaced_oldest + s.expired)
               / s.submitted,
               reject_fraction=(s.rejected_overload + s.rejected_queue_full)
               / s.submitted,
               tiers=tiers, longest_shed_streak=max(streaks.values()),
               min_frames_a_tenant=min(len(u) for u in updates.values()),
               dispatches=s.dispatches, launches=launches[name],
               exceptions=0)
    if split:
        row["host_ms_a_pump"] = host.ms_a_pump()
    return row


def phase_stream(kind, fleet):
    """The streaming front end on the card for one model: (a) 100 cycles
    uninterrupted; (b) shard 0 killed at cycle 40, every tenant's stream
    bit for bit (a)'s, 4 failovers, shard1 alone alive; (c) the same with
    checkpoint_every=1000 (the frame-0 snapshot + a 40-frame WAL); (d)
    offered load 0.5x, 1x, 2x under the default ladder (pumps/s, tenant
    frames/s, the served / shed / reject fractions, no tenant starved; the
    1x run's host ms a pump split); (e) test_everything_at_once's plan.
    Each run: launches = dispatches + WAL frames replayed, no dispatch
    error, no breaker trip, no exception."""
    t_phase = time.perf_counter()
    model = filters.make_imm() if kind == "imm" else filters.get_filter(kind)
    name = "katana_imm_frame" if kind == "imm" else "katana_frame"
    root = tempfile.mkdtemp(prefix="katana_stream_")
    row = dict(tenants=STREAM_TENANTS, cycles=STREAM_CYCLES,
               kill_cycle=STREAM_KILL, **STREAM_CFG)
    total = 0
    try:
        scenes = stream_scenes(kind, 2 * STREAM_CYCLES)
        t_scene = time.perf_counter() - t_phase
        # (a) uninterrupted
        front_a = stream_front(model, root, "a", **NO_LADDER)
        ref_run, la, wa = stream_drive(front_a, scenes, FaultPlan(),
                                       STREAM_CYCLES)
        total += stream_checks(f"{kind} (a) uninterrupted", front_a,
                               ref_run, la, wa, name)
        # (b) shard 0 killed at cycle 40
        front_b = stream_front(model, root, "b", **NO_LADDER)
        got, lb, wb = stream_drive(
            front_b, scenes, FaultPlan(kill_shards={STREAM_KILL: 0}),
            STREAM_CYCLES)
        total += stream_checks(f"{kind} (b) kill shard0 at cycle 40",
                               front_b, got, lb, wb, name)
        n_b = streams_bitwise(ref_run, got)
        assert front_b.stats.failovers == 4, front_b.stats
        assert front_b.shards_alive() == ["shard1"]
        assert len(got.recovered_at) == 4, got.recovered_at
        # (c) the stale checkpoint: frame 0's + a 40-frame WAL
        front_c = stream_front(model, root, "c", checkpoint_every=1000,
                               **NO_LADDER)
        got_c, lc, wc = stream_drive(
            front_c, scenes, FaultPlan(kill_shards={STREAM_KILL: 0}),
            STREAM_CYCLES)
        total += stream_checks(f"{kind} (c) kill, checkpoint_every=1000",
                               front_c, got_c, lc, wc, name)
        assert wc == 4 * STREAM_KILL, wc
        n_c = streams_bitwise(ref_run, got_c)
        assert front_c.stats.failovers == 4
        recovery = {t: got.recovered_at[t] - STREAM_KILL
                    for t in got.recovered_at}
        print(f"[stream {kind}] (b), (c): every tenant's stream bit for bit "
              f"(a)'s ({n_b}, {n_c} track snapshots: ids, hits, ages, "
              "states" + (", mode_probs" if kind == "imm" else "") + "); "
              f"failovers 4, alive {front_b.shards_alive()}; WAL frames "
              f"replayed (b) {wb}, (c) {wc}; cycles from the kill to each "
              f"moved tenant's next update {recovery}")
        row.update(wal_frames_b=wb, wal_frames_c=wc, bitwise_snapshots_b=n_b,
                   bitwise_snapshots_c=n_c, recovery_cycles=recovery,
                   checkpoints_a=front_a.stats.checkpoints)

        # the device time of one pump's dispatch at S = 8: the fused frame
        # kernel on shard 1's live lanes and a pump's measurements
        sh = front_a.shards[1]
        banks = sh.banks
        L, C, M = STREAM_CFG["lanes_per_shard"], C_SERVE, M_SERVE
        zb = np.zeros((L, M, model.m), np.float32)
        vb = np.zeros((L, M), bool)
        for t, tn in front_a.tenants.items():
            if tn.shard == 1:
                z = scenes[t](STREAM_CYCLES - 1)[:M]
                zb[tn.lane, :len(z)], vb[tn.lane, :len(z)] = z, True
        zt, vt = torch.from_numpy(zb).cuda(), torch.from_numpy(vb).cuda()
        gate, rounds = tracker.CHI2_99[model.m], min(C, M)
        if kind == "imm":
            kargs = (banks.x, banks.P, banks.mu, zt, vt, banks.active, gate,
                     rounds)
            kfn = ops.katana_imm_frame
        else:
            kargs = (banks.x, banks.P, zt, vt, banks.active, gate, rounds)
            kfn = ops.katana_frame
        launch_ms = launch_events_ms(lambda evs: kfn(model, *kargs,
                                                     launch_events=evs))
        dispatch_ms = cuda_ms(lambda: front_a._dispatch(
            sh.device, ServiceTier.FULL, banks, zb, vb), 20)
        print(f"[stream {kind}] one pump's dispatch over {L} lanes: {name} "
              "device ms a launch by CUDA events (mean of "
              f"{launch_ms['events']} frames, device queued): " + ", ".join(
                  f"{k} {launch_ms[k]:.4f}" for k in FRAME_LAUNCHES)
              + f", the frame {launch_ms['frame']:.4f} (phase 3b's fleet "
              f"frame {fleet['launch_device_ms']['frame']:.4f}); the whole "
              f"step (zb, vb in, kernel, glue) {dispatch_ms:.4f} ms at the "
              "host's pace (CUDA events)")
        row.update(launch_device_ms=launch_ms, dispatch_ms=dispatch_ms)

        # (d) offered load under the default ladder
        loads = []
        for x in STREAM_LOADS:
            lrow = stream_load_row(model, root, scenes, x, name,
                                   split=x == 1.0)
            total += lrow["launches"]
            loads.append(lrow)
            print(f"[stream {kind}] (d) offered {x}x: {lrow['pumps']} pumps "
                  f"in {lrow['wall_s']:.3f} s: {lrow['pumps_per_s']:.1f} "
                  f"pumps/s, {lrow['tenant_frames_per_s']:.1f} tenant-"
                  f"frames/s (host clock, warm-up excluded); served "
                  f"{lrow['served_fraction']:.4f}, shed "
                  f"{lrow['shed_fraction']:.4f}, reject "
                  f"{lrow['reject_fraction']:.4f} of the submitted "
                  f"{lrow['submitted']}; tiers {lrow['tiers']}; longest shed "
                  f"streak {lrow['longest_shed_streak']} (limit "
                  f"{StreamConfig().starve_limit}), fewest frames a "
                  f"tenant {lrow['min_frames_a_tenant']}; launches "
                  f"{lrow['launches']} = dispatches; exceptions 0")
        one = next(r for r in loads if r["offered_x"] == 1.0)
        split = one["host_ms_a_pump"]
        limit = 300.0
        verdict = "meets" if one["pumps_per_s"] >= limit else "MISSES"
        print(f"[stream {kind}] host ms a pump at 1x (mean of "
              f"{one['pumps']}): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items())
              + f"; {one['pumps_per_s']:.1f} pumps/s (each tenant one frame "
              f"a pump) {verdict} the >= {limit:.0f} limit a tenant")
        row.update(loads=loads, host_ms_a_pump=split, limit=limit,
                   meets_limit=one["pumps_per_s"] >= limit)

        # (e) tests/test_chaos.py::test_everything_at_once at this size
        front_e = stream_front(model, root, "e", t0=50.0, queue_depth=6,
                               degrade_at=0.4, coast_at=0.7, reject_at=0.95)
        plan = FaultPlan(kill_shards={9: 0}, dropouts={"t1": (4, 8)},
                         corruptions={("t2", 5): "nan", ("t2", 6): "inf"},
                         duplicates=(("t0", 3), ("t1", 11)),
                         skews_s={"t2": 0.5})
        got_e, le, we = stream_drive(front_e, scenes, plan, 20, rate=2,
                                     budget=30.0)
        total += stream_checks(f"{kind} (e) everything at once", front_e,
                               got_e, le, we, name)
        assert front_e.stats.shards_lost == 1
        assert all(got_e.frames_applied(t) > 0 for t in scenes)
        for sh in front_e.shards:
            if sh.alive:
                assert torch.isfinite(sh.banks.x).all()
                assert torch.isfinite(sh.banks.P).all()
        row.update(sink=dataclasses.asdict(front_e.stats),
                   sink_tiers=sorted({int(u.tier) for ups in
                                      got_e.updates.values() for u in ups}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = total
    row["seconds"] = time.perf_counter() - t_phase
    print(f"[stream {kind}] {total} {name} launches in phase 9's runs; "
          f"scenes {t_scene:.1f} s; part {row['seconds']:.1f} s")
    return row


# ---------------------------------------------------------------------------
# Phase 4's lane: the IMM scan on tests/data/imm_scan_lane.npz
# ---------------------------------------------------------------------------

IMM_LANE = ROOT / "tests" / "data" / "imm_scan_lane.npz"


def _same_or_both_nan(a, b) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _first_non_finite(xs):
    bad = (~torch.isfinite(xs).all(-1)).nonzero()
    return int(bad[0, 0]) if len(bad) else None


def imm_scan_lane():
    """The lane of ROADMAP §3's reclassified entry (a float32-conditioned
    IMM lane, tests/test_torch_imm_scan_lane.py) through the kernel and
    through its plain version on the card: bit for bit, NaNs included;
    each one's first non-finite frame, and the plain version's on the
    CPU, printed."""
    d = np.load(IMM_LANE)
    imm = filters.as_imm(filters.make_imm())
    args = [torch.as_tensor(d["zs"][:, None].copy()),
            torch.as_tensor(d["x0"]), torch.as_tensor(d["P0"])]
    kw = dict(mu0=torch.as_tensor(d["mu0"][None].copy()),
              valid=torch.as_tensor(d["valid"][:, None].copy()))
    on = [a.to(DEV) for a in args]
    kw_on = {k: v.to(DEV) for k, v in kw.items()}
    ops.reset_launches()
    kern = ops.katana_imm_sequence(imm, *on, **kw_on)
    assert ops.LAUNCHES["katana_imm_sequence"] == chunk_launches(
        "katana_imm_sequence", on[0].shape[0]), ops.LAUNCHES
    with mock.patch.object(build, "on_cuda", lambda t: False):
        plain = ops.katana_imm_sequence(imm, *on, **kw_on)
    cpu = ops.katana_imm_sequence(imm, *args, **kw)
    assert _same_or_both_nan(kern, plain), "imm lane: kernel vs plain"
    row = dict(kernel_first_non_finite=_first_non_finite(kern),
               plain_card_first_non_finite=_first_non_finite(plain),
               plain_cpu_first_non_finite=_first_non_finite(cpu))
    print(f"[imm lane] T=300, K=4: kernel bit for bit with its plain "
          f"version on the card (NaNs included); first non-finite frame: "
          f"kernel {row['kernel_first_non_finite']}, plain on the card "
          f"{row['plain_card_first_non_finite']}, plain on the CPU "
          f"{row['plain_cpu_first_non_finite']} (the reference's float32 "
          "order; ROADMAP §3)")
    return row


# ---------------------------------------------------------------------------
# Phase 10: training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_S, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = (
    "h2o-danube-1.8b", 8192, 2, 2, 3)
# the danube step's recompute (PERF.md §6 reckons the memory of each)
TRAIN_REMAT = "none"
MAMBA_TRAIN_ARGV = ["--arch", "mamba2-130m", "--seq", "2048", "--batch",
                    "4", "--microbatches", "2", "--steps", "20"]
# (B, S, H, KH, d, window) of the gradient checks: danube's layer, and a
# ragged S against the float64 oracle
GRAD_SHAPE = (1, 8192, 32, 8, 80, 4096)
GRAD_RAGGED = (1, 1000, 32, 8, 80, 300)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
# granite-moe-1b-a400m's training layer (phase 11 trains at S = 4,096)
GRAD_MOE = (1, 4096, 16, 8, 64, None)
SMALL_TRAIN = [("h2o-danube-1.8b", "flash"), ("mamba2-130m", "auto")]
SMALL_TRAIN_S, SMALL_TRAIN_B, SMALL_TRAIN_STEPS = 128, 4, 5


def _grad_inputs(rng, B, S, H, KH, d, dtype):
    return [torch.as_tensor(rng.normal(size=(B, S, h, d)), dtype=torch.float32
                            ).to(DEV, dtype) for h in (H, KH, KH, H)]


def flash_grads(q, k, v, do, scale, window, forward):
    """(dq, dk, dv) through ``FlashAttention`` with ``forward`` (the
    kernel's ``flash_attention_fwd`` or the plain version), causal."""
    t = [x.detach().requires_grad_() for x in (q, k, v)]
    o = fa_ops.FlashAttention.apply(*t, scale, True, window, 512, forward)
    return torch.autograd.grad(o, t, do)


def dense_grads64(q, k, v, do, scale, window):
    """Autograd of dense causal, windowed softmax attention in float64,
    one kv head's group of query heads at a time (danube's layer is 32
    (8,192 x 8,192) score matrices)."""
    G = q.shape[2] // k.shape[2]
    ok = fa_ref.mask(q.shape[1], k.shape[1], True, window, q.device)
    out = [torch.empty(x.shape, dtype=torch.float64, device=x.device)
           for x in (q, k, v)]
    for kh in range(k.shape[2]):
        hs = slice(kh * G, (kh + 1) * G)
        t = [x.detach().double().requires_grad_()
             for x in (q[:, :, hs], k[:, :, kh:kh + 1], v[:, :, kh:kh + 1])]
        kb, vb = (x.expand(-1, -1, G, -1) for x in t[1:])
        s = torch.einsum("bqhd,bkhd->bhqk", t[0], kb) * scale
        p = torch.softmax(s.masked_fill(~ok, -1e30), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vb)
        g = torch.autograd.grad(o, t, do[:, :, hs].double())
        out[0][:, :, hs], out[1][:, :, kh:kh + 1], out[2][:, :, kh:kh + 1] = g
        del t, kb, vb, s, p, o, g
    return out


def sdpa_forward(q, k, v, scale, window):
    """(leaves, output) of ``scaled_dot_product_attention`` on the memory-
    efficient backend (for the record; the port never calls it): q, k, v
    as leaves, the kv heads repeated, the causal window as a mask, the
    output in (B, H, S, d). None if it refuses."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    G = q.shape[2] // k.shape[2]
    t = [x.detach().requires_grad_() for x in (q, k, v)]
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in t[1:])
    mask = fa_ref.mask(q.shape[1], k.shape[1], True, window, q.device)
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return t, sdpa(t[0].transpose(1, 2), kt, vt, attn_mask=mask,
                           scale=scale)
    except RuntimeError as exc:
        print(f"  library call refused: {str(exc).splitlines()[0][:160]}")
        return None


def sdpa_grads(q, k, v, do, scale, window):
    """(dq, dk, dv) of ``sdpa_forward`` (dk, dv summed over each kv head's
    group), or None."""
    run = sdpa_forward(q, k, v, scale, window)
    if run is None:
        return None
    t, o = run
    return torch.autograd.grad(o, t, do.transpose(1, 2))


def hold_grads(q, k, v, do, scale, window, got):
    """dq, dk, dv of the backward kernel (``got``) against its plain
    version by ``fa_ref.bwd_excess`` (dV with its P-rounding allowance),
    and against the float64 oracle beside the torch-op backward on the
    same inputs: each at most 2x that route's distance, and in float32
    also within GRAD_TOL. SDPA's backward's own float64 distance is kept
    beside them for the record and gates nothing. The distances and
    excesses, by gradient."""
    *plain, flip = fa_ref.flash_attention_bwd_plain(q, k, v, do, scale, True,
                                                    window, flips=True)
    torch_ops = fa_ops.flash_attention_bwd(q, k, v, do, scale, True, window,
                                           512)
    oracle = dense_grads64(q, k, v, do, scale, window)
    lib = sdpa_grads(q, k, v, do, scale, window)
    row = dict(vs_plain={}, excess={}, err64={}, ops_err64={},
               sdpa_err64=None if lib is None else {})
    for i, (name, a, b, c, o, fl) in enumerate(zip(
            "qkv", got, plain, torch_ops, oracle, (0.0, 0.0, flip))):
        row["vs_plain"][name] = max_diff(a, b)
        row["excess"][name] = fa_ref.bwd_excess(a, b, fl)
        row["err64"][name] = max_diff(a.double(), o)
        row["ops_err64"][name] = max_diff(c.double(), o)
        if lib is not None:
            row["sdpa_err64"][name] = max_diff(lib[i].double(), o)
        assert row["excess"][name] <= 1.0, ("plain", name, row)
        assert row["err64"][name] <= 2 * row["ops_err64"][name], (
            "float64", name, row)
        if q.dtype == torch.float32:
            torch.testing.assert_close(a.double(), o, **GRAD_TOL)
    row["max_abs_err"] = max(row["vs_plain"].values())
    return row


def bwd_bound(B, S, H, KH, d, window, dtype):
    """(bound ms, by, bytes, operations) of one flash_attention backward:
    10 d operations a visible causal (query, key) pair (five products of
    d) at the bf16 tensor-core peak; in float32 three times that (each
    product as three TF32 products, the kernel's 3xTF32) at the TF32
    tensor-core peak; q, dO, dq and k, v, dk, dv each read or written
    once."""
    item = torch.finfo(dtype).bits // 8
    pairs = sum(min(i + 1, window or S) for i in range(S))
    nb, nops = (3 * H + 4 * KH) * B * S * d * item, 10 * d * pairs * B * H
    peak = BF16_OPS
    if dtype != torch.bfloat16:
        nops, peak = 3 * nops, TF32_OPS
    by = "bytes" if nb / HBM_BPS >= nops / peak else "operations"
    return max(nb / HBM_BPS, nops / peak) * 1e3, by, nb, nops


def sdpa_bwd_ms(q, k, v, do, scale, window, iters):
    """The library's backward alone (for the record; the port never calls
    it): ``sdpa_forward`` run once with the graph kept, then its backward
    timed. None if it refuses."""
    run = sdpa_forward(q, k, v, scale, window)
    if run is None:
        return None
    t, o = run
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(o, t, dot, retain_graph=True),
                   iters, warmup=1)


def bwd_times(q, k, v, do, scale, window, iters=10):
    """ms of the backward kernel, of the torch-op backward, and of SDPA's
    backward on the same inputs, and the kernel's bound."""
    B, S, H, d = q.shape
    kern = cuda_ms(lambda: fa_ops.flash_attention_bwd_kernel(
        q, k, v, do, scale, True, window), iters, warmup=1)
    ops_ms = cuda_ms(lambda: fa_ops.flash_attention_bwd(
        q, k, v, do, scale, True, window, 512), 3, warmup=1)
    lib = sdpa_bwd_ms(q, k, v, do, scale, window, 3)
    bms, by, nb, nops = bwd_bound(B, S, H, k.shape[2], d, window, q.dtype)
    return dict(kernel_ms=kern, bwd_ms=ops_ms, sdpa_bwd_ms=lib, bound_ms=bms,
                bound_by=by, bytes=nb, operations=nops,
                bound_share=bms / kern)


def print_sdpa_verdict(layer, tag, row, card):
    """One line: the backward kernel "meets" SDPA's backward (no slower)
    or "LOSES" to it, at this layer and dtype; for the record."""
    lib = row["sdpa_bwd_ms"]
    verdict = ("SDPA refused" if lib is None else
               "meets" if row["kernel_ms"] <= lib else "LOSES")
    print(f"[train] flash_attention_bwd {layer} {tag}: {verdict} against "
          f"SDPA's backward (kernel {row['kernel_ms']:.3f} ms, SDPA "
          f"{'-' if lib is None else f'{lib:.3f}'} ms) | {card}")


def train_grad_check(card):
    """(a) flash_attention's gradient at danube's layer shape in bf16 and
    float32 through the backward kernel: dq, dk, dv from the kernel's
    forward bit for bit with those from the plain forward on the card (the
    backward reads q, k, v, not the output), two kernel calls bit for
    bit, the kernel against its plain version and against the float64
    oracle beside the torch-op backward; the times of the kernel, the
    torch-op backward, the plain version and SDPA's backward there and at
    granite-moe's layer; a ragged S against the float64 oracle."""
    rng = np.random.default_rng(31)
    B, S, H, KH, d, W = GRAD_SHAPE
    scale = d ** -0.5
    out = {}
    _print_ptxas_of("flash_attention_bwd.cu", ("flash_bwd",))
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        design = fa_ops.bwd_config(dtype, d)
        print(f"[train] flash_attention_bwd.cu {tag} d={d}: {design}")
        q, k, v, do = _grad_inputs(rng, B, S, H, KH, d, dtype)
        fa_ops.reset_launches()
        got = flash_grads(q, k, v, do, scale, W, fa_ops.flash_attention_fwd)
        assert fa_ops.LAUNCHES == {"flash_attention": 1,
                                   "flash_attention_bwd": 1}, fa_ops.LAUNCHES
        want = flash_grads(q, k, v, do, scale, W,
                           fa_ref.flash_attention_plain)
        again = fa_ops.flash_attention_bwd_kernel(q, k, v, do, scale, True, W)
        for name, a, b, c in zip("qkv", got, want, again):
            assert torch.equal(a, b), ("flash gradient", dtype, name)
            assert torch.equal(a, c), ("two backward calls", dtype, name)
        del want
        row = hold_grads(q, k, v, do, scale, W, got)
        row["design"] = design
        row["plain_ms"] = cuda_ms(lambda: fa_ref.flash_attention_bwd_plain(
            q, k, v, do, scale, True, W), 1, warmup=0)
        row.update(bwd_times(q, k, v, do, scale, W))
        out[tag] = row
        lib = row["sdpa_bwd_ms"]
        print(f"[train] flash_attention gradient B={B} S={S} H={H} KH={KH} "
              f"d={d} W={W} {tag}: dq, dk, dv from the backward kernel, bit "
              f"for bit through the kernel's and the plain forward and from "
              f"call to call; max|d| from flash_attention_bwd_plain "
              f"{row['vs_plain']} (ref.bwd_excess {row['excess']}, held "
              f"<= 1); from float64: kernel {row['err64']}, torch-op "
              f"backward {row['ops_err64']} (held: <= 2x the torch-op "
              f"backward{', and 2e-5 + 1e-4|x|' if dtype == torch.float32 else ''}), "
              f"SDPA's backward {row['sdpa_err64']} (not held); "
              f"backward kernel {row['kernel_ms']:.3f} ms (bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
              f"{row['bound_share']:.3f} of it), torch-op backward "
              f"{row['bwd_ms']:.3f} ms, plain version {row['plain_ms']:.1f} "
              f"ms, SDPA's backward "
              f"{'refused' if lib is None else f'{lib:.3f} ms'} | {card}")
        print_sdpa_verdict("danube", tag, row, card)
        del q, k, v, do, got
        torch.cuda.empty_cache()
    mB, mS, mH, mKH, md, mW = GRAD_MOE
    out["granite-moe"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        q, k, v, do = _grad_inputs(rng, mB, mS, mH, mKH, md, dtype)
        got = fa_ops.flash_attention_bwd_kernel(q, k, v, do, md ** -0.5,
                                                True, mW)
        row = hold_grads(q, k, v, do, md ** -0.5, mW, got)
        row.update(bwd_times(q, k, v, do, md ** -0.5, mW))
        out["granite-moe"][tag] = row
        lib = row["sdpa_bwd_ms"]
        print(f"[train] flash_attention backward at granite-moe's layer "
              f"B={mB} S={mS} H={mH} KH={mKH} d={md} causal {tag}: max|d| "
              f"from flash_attention_bwd_plain {row['vs_plain']} "
              f"(ref.bwd_excess {row['excess']}, held <= 1); from float64: "
              f"kernel {row['err64']}, torch-op backward {row['ops_err64']} "
              f"(held <= 2x), SDPA's backward {row['sdpa_err64']} (not "
              f"held); kernel "
              f"{row['kernel_ms']:.3f} ms (bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}, {row['bound_share']:.3f} of it), torch-op "
              f"backward {row['bwd_ms']:.3f} ms, SDPA's backward "
              f"{'refused' if lib is None else f'{lib:.3f} ms'} | {card}")
        print_sdpa_verdict("granite-moe", tag, row, card)
        del q, k, v, do, got
    B, S, H, KH, d, W = GRAD_RAGGED
    q, k, v, do = _grad_inputs(rng, B, S, H, KH, d, torch.float32)
    got = flash_grads(q, k, v, do, scale, W, fa_ops.flash_attention_fwd)
    want = dense_grads64(q, k, v, do, scale, W)
    err = 0.0
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a.double(), b, **GRAD_TOL)
        err = max(err, max_diff(a.double(), b))
    out["ragged_max_abs_err"] = err
    print(f"[train] ragged S={S} (query tiles of 64: {S // 64} + {S % 64}) H={H} "
          f"KH={KH} d={d} W={W} float32 through the backward kernel against "
          f"the float64 oracle: max|d| {err:.3g} (<= 2e-5 + 1e-4|x|)")
    return out


def _bwd_spy():
    """(calls, spy): ``spy`` stands in for the torch-op backward
    ``flash_attention_bwd`` and records the device of each call."""
    calls, real = [], fa_ops.flash_attention_bwd

    def spy(*args, **kw):
        calls.append(args[0].device.type)
        return real(*args, **kw)
    return calls, spy


def _to_cpu_state(state):
    from repro_torch.optim import adamw

    return adamw.TrainState(*(None if f is None else adamw.tree_map(
        lambda t: t.detach().cpu().clone(), f) for f in state))


def train_port_vs_cpu(card):
    """(b) reduced danube (flash) and reduced mamba2, 5 float32 steps on
    the card and the same on the CPU (the plain versions) from the same
    state and batches: each step's loss within 1e-4 relative."""
    from repro_torch.configs import RunConfig, reduced
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    out = {}
    for arch, impl in SMALL_TRAIN:
        cfg = reduced(get_config(arch), seq=SMALL_TRAIN_S)
        if cfg.attention is not None:  # GQA: 4 query heads on 2 kv heads
            cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
                cfg.attention, n_kv_heads=2))
        params = init_params(cfg, torch.Generator(DEV).manual_seed(5), DEV)
        state = adamw.init_train_state(params)
        cpu_state = _to_cpu_state(state)
        run = RunConfig(microbatches=2, learning_rate=1e-2, warmup_steps=2,
                        total_steps=SMALL_TRAIN_STEPS, remat="none")
        step = make_train_step(cfg, run, ShardingContext(attn_impl=impl),
                               torch.float32)
        data = LMDataPipeline(cfg.vocab, SMALL_TRAIN_S, SMALL_TRAIN_B,
                              seed=3, microbatches=2)
        batches = [data.next_batch() for _ in range(SMALL_TRAIN_STEPS)]
        fa_ops.reset_launches()
        card_loss, cpu_loss = [], []
        for b in batches:
            state, m = step(state, b)
            card_loss.append(float(m["loss"]))
        launches = fa_ops.LAUNCHES["flash_attention"]
        bwd_launches = fa_ops.LAUNCHES["flash_attention_bwd"]
        for b in batches:
            cpu_state, m = step(cpu_state, b)
            cpu_loss.append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
        assert rel <= 1e-4, (arch, card_loss, cpu_loss)
        want = (cfg.n_layers * 2 * SMALL_TRAIN_STEPS
                if cfg.attention is not None else 0)
        assert launches == want, (arch, launches, want)
        assert bwd_launches == want, (arch, bwd_launches, want)
        out[arch] = dict(card_loss=card_loss, cpu_loss=cpu_loss,
                         max_rel=rel, flash_launches=launches,
                         bwd_launches=bwd_launches)
        print(f"[train] reduced {arch} ({impl}) float32, {SMALL_TRAIN_STEPS} "
              f"steps: loss on the card {[round(x, 6) for x in card_loss]}, "
              f"on the CPU {[round(x, 6) for x in cpu_loss]}; max rel "
              f"{rel:.3g} (<= 1e-4); flash_attention launches {launches}, "
              f"flash_attention_bwd {bwd_launches}")
    return out


def train_danube(card):
    """(c) h2o-danube-1.8b at full size through ``make_train_step``:
    bf16 compute, attn_impl "flash", S = 8192, a global batch of 2 in 2
    microbatches, TRAIN_STEPS steps; finite loss and grad norm, ms a
    step, tokens/s, peak memory, the flash_attention launches."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(microbatches=TRAIN_MB, remat=TRAIN_REMAT)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV)
    n_params = sum(t.numel() for t in _leaves(params))
    state = adamw.init_train_state(params)
    del params
    torch.cuda.empty_cache()
    data = LMDataPipeline(cfg.vocab, TRAIN_S, TRAIN_BATCH, seed=0,
                          microbatches=TRAIN_MB)
    step = make_train_step(cfg, run, ShardingContext(attn_impl="flash"))
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()
    ms, losses, norms = [], [], []
    calls, spy = _bwd_spy()
    with mock.patch.object(fa_ops, "flash_attention_bwd", spy):
        for _ in range(TRAIN_STEPS):
            batch = data.next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = fa_ops.LAUNCHES["flash_attention"]
    bwd_launches = fa_ops.LAUNCHES["flash_attention_bwd"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = cfg.n_layers * TRAIN_MB * TRAIN_STEPS * (
        1 if TRAIN_REMAT == "none" else 2)
    assert launches == want, (launches, want)
    assert bwd_launches == cfg.n_layers * TRAIN_MB * TRAIN_STEPS, (
        bwd_launches, cfg.n_layers * TRAIN_MB * TRAIN_STEPS)
    assert not calls, ("the torch-op backward ran", calls)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses,
                                                                   norms)
    steady = float(np.mean(ms[1:]))
    tok_s = TRAIN_BATCH * TRAIN_S / (steady / 1e3)
    print(f"[train] {TRAIN_ARCH} ({n_params / 1e9:.3f} B params) bf16, "
          f"S={TRAIN_S}, batch {TRAIN_BATCH} in {TRAIN_MB} microbatches, "
          f"remat {TRAIN_REMAT}: loss {[round(x, 4) for x in losses]}, grad "
          f"norm {[round(x, 4) for x in norms]}; ms a step "
          f"{[round(x, 1) for x in ms]} (steady {steady:.1f}), {tok_s:.1f} "
          f"tokens/s, peak memory {peak:.2f} GiB, flash_attention launches "
          f"{launches}, flash_attention_bwd {bwd_launches} (the torch-op "
          f"backward called {len(calls)} times); steady step against "
          f"6,482.8 ms on the torch-op backward (PERF.md §5) | {card}")
    del state, m
    torch.cuda.empty_cache()
    return dict(params=n_params, losses=losses, grad_norms=norms, ms=ms,
                steady_ms=steady, tokens_per_s=tok_s, peak_gib=peak,
                launches=launches, bwd_launches=bwd_launches,
                torch_op_bwd_calls=len(calls), remat=TRAIN_REMAT)


def train_mamba(card):
    """(d) mamba2-130m at full size through ``launch/train.py``: 20 steps;
    ms a step, tokens/s, peak memory. The loss must fall, held on a batch
    the run never trains on (the pipeline at the next seed): its loss
    under the trained weights below its loss under the initial ones (one
    batch both times, so the batch-to-batch spread of ~0.01 at a loss
    near ln(vocab) does not decide it, and no batch the run memorised);
    the last step's loss against the first's is printed too."""
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw

    argv = MAMBA_TRAIN_ARGV
    seq, batch = int(argv[argv.index("--seq") + 1]), int(
        argv[argv.index("--batch") + 1])
    steps = int(argv[argv.index("--steps") + 1])
    held = {}
    real_make = train_lib.make_train_step

    def held_out_loss(state, cfg, run):
        data = LMDataPipeline(cfg.vocab, seq, batch, seed=run.seed + 1,
                              microbatches=run.microbatches)
        b = data.next_batch()
        with torch.no_grad():
            params = adamw.compute_params(state, torch.bfloat16)
            return float(np.mean([float(model_lib.loss_fn(
                params, cfg, {k: torch.as_tensor(v[i], device=DEV).long()
                              for k, v in b.items()}, None, run.remat)[0])
                for i in range(run.microbatches)]))

    def with_held_out_losses(cfg, run, ctx):
        step = real_make(cfg, run, ctx)

        def wrapped(state, b):
            if "before" not in held:
                held["before"] = held_out_loss(state, cfg, run)
            state, m = step(state, b)
            held.update(state=state, cfg=cfg, run=run)
            return state, m
        return wrapped

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(train_lib, "make_train_step",
                           with_held_out_losses):
        losses = train_lib.main(argv)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = held_out_loss(held["state"], held["cfg"], held["run"])
    before = held["before"]
    assert len(losses) == steps and after < before, (losses, before, after)
    ms = wall / steps
    tok_s = batch * seq / (ms / 1e3)
    print(f"[train] mamba2-130m via launch/train.py {' '.join(argv)}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (the last step's below the "
          f"first's: {losses[-1] < losses[0]}); a held-out batch's loss "
          f"{before:.4f} -> {after:.4f}; {ms:.1f} ms a step (wall over "
          f"{steps} steps, build, the held-out loss and the first step "
          f"included), {tok_s:.1f} tokens/s, peak memory {peak:.2f} GiB "
          f"| {card}")
    held.clear()
    torch.cuda.empty_cache()
    return dict(losses=losses, held_out_before=before, held_out_after=after,
                ms=ms, tokens_per_s=tok_s, peak_gib=peak, wall_ms=wall)


def phase_train(card):
    """Phase 10: training on the card, (a) to (d)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads = train_grad_check(card)
    small = train_port_vs_cpu(card)
    danube = train_danube(card)
    mamba = train_mamba(card)
    return dict(grads=grads, small=small, danube=danube, mamba=mamba)


# ---------------------------------------------------------------------------
# Phase 11: MoE layers and the modality frontends. granite-moe-1b-a400m
# (hf:ibm-granite/granite-3.0-1b-a400m-base: 24 layers, d 1024, 16 heads
# over 8 kv heads of 64, 32 experts, top-8, d_ff_expert 512, vocab 49155,
# no window) served at B = 8 x 4,096 (granite-3.0's context) and trained at
# S = 4,096; internvl2-2b (arXiv:2404.16821: 24 layers, d 2048, 16 over 8
# heads of 128) served with 256 patch embeddings before 3,840 text tokens;
# hubert-xlarge (arXiv:2106.07447: 48 layers, d 1280, 16 heads of 80,
# non-causal) encoding 30-s clips of 1,500 frame embeddings (50 Hz). Random
# bf16 weights from seeded generators; nothing cut but the batch.
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_B, MOE_S, MOE_STEPS = "granite-moe-1b-a400m", 8, 4096, 32
MOE_TRAIN_S, MOE_TRAIN_BATCH, MOE_TRAIN_MB, MOE_TRAIN_STEPS = 4096, 2, 2, 3
MOE_CHECK_B = 2  # prompts held to the full routes
VLM_ARCH, VLM_B, VLM_TEXT, VLM_STEPS = "internvl2-2b", 4, 3840, 32
AUDIO_ARCH, AUDIO_B, AUDIO_S = "hubert-xlarge", 4, 1500
# one layer of each arch at full size: (arch, B, S, H, KH, d, causal)
MOE_ATTN = [(MOE_ARCH, MOE_B, MOE_S, 16, 8, 64, True),
            (VLM_ARCH, VLM_B, 256 + VLM_TEXT, 16, 8, 128, True),
            (AUDIO_ARCH, AUDIO_B, AUDIO_S, 16, 16, 80, False)]
# one decode step over a full cache with no window: (arch, B, T, H, KH, d)
MOE_DECODE = [(MOE_ARCH, MOE_B, MOE_S, 16, 8, 64),
              (VLM_ARCH, VLM_B, 256 + VLM_TEXT, 16, 8, 128)]
SMALL_MOE = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
             "jamba-1.5-large-398b")
SMALL_MOE_S, SMALL_MOE_B, SMALL_MOE_STEPS = 128, 4, 3


def attention_bound(B, S, H, KH, d, causal, dtype):
    """(bound ms, by, bytes, operations) of one flash_attention call: q,
    k, v read once, o written once; 4 d operations a visible (query, key)
    pair (QK^T and PV) at the bf16 tensor-core peak; in float32 three times
    that (each product as three TF32 products, the kernel's 3xTF32) at the
    TF32 tensor-core peak."""
    item = torch.finfo(dtype).bits // 8
    pairs = S * (S + 1) // 2 if causal else S * S
    nb, nops = 2 * B * S * (H + KH) * d * item, 4 * d * pairs * B * H
    peak = BF16_OPS
    if dtype != torch.bfloat16:
        nops, peak = 3 * nops, TF32_OPS
    by = "bytes" if nb / HBM_BPS >= nops / peak else "operations"
    return max(nb / HBM_BPS, nops / peak) * 1e3, by, nb, nops


def moe_attention_shapes(card):
    """(a) flash_attention at one layer of each arch, float32 (2e-5 of the
    plain version, 2e-5 + 1e-4|x| of the 3xTF32 plain version) and bf16
    (one ulp of the plain and the hi/lo plain versions), timed beside the
    plain version and SDPA's forward, with a "meets" / "LOSES" line
    against SDPA a shape and dtype."""
    rng = np.random.default_rng(41)
    rows = {}
    for arch, B, S, H, KH, d, causal in MOE_ATTN:
        q32, k32, v32 = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                                         dtype=torch.float32, device=DEV)
                         for h in (H, KH, KH))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            scale = d ** -0.5
            got = fa_ops.flash_attention(q, k, v, scale, causal, None)
            want, plain = timed_once(lambda: fa_ref.flash_attention_plain(
                q, k, v, scale, causal, None))
            err = max_diff(got, want)
            if dtype == torch.float32:
                ulps = None
                assert err <= 2e-5, (arch, "flash_attention float32", err)
                x3 = tf32x3_excess(got, q, k, v, scale, causal, None)
                assert x3 <= 1.0, (arch, "flash_attention vs 3xTF32", x3)
            else:
                ulps = bf16_ulp_excess(got, want)
                hilo = max(bf16_ulp_excess(
                    got[b:b + 1], fa_ref.flash_attention_hilo_plain(
                        q[b:b + 1], k[b:b + 1], v[b:b + 1], scale, causal))
                    for b in range(B))
                assert ulps <= 1.0 and hilo <= 1.0, (arch, ulps, hilo)
                ulps = max(ulps, hilo)
            ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, scale,
                                                        causal, None),
                         5, warmup=1)
            mask = fa_ref.mask(S, S, True, None, DEV) if causal else None
            lib = sdpa_ms(q, k, v, mask, 5)
            bms, by, nb, nops = attention_bound(B, S, H, KH, d, causal,
                                                dtype)
            tag = str(dtype).removeprefix("torch.")
            rows[f"{arch} {tag}"] = dict(
                shape=f"B={B} S={S} H={H} KH={KH} d={d} "
                      f"{'causal' if causal else 'non-causal'} {tag}",
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err, bf16_ulps=ulps,
                tf32x3_excess=x3 if dtype == torch.float32 else None,
                verdict=None if lib is None else
                "meets" if ms <= lib else "LOSES")
            print(f"[moe] flash_attention {arch} B={B} S={S} H={H} KH={KH} "
                  f"d={d} {'causal' if causal else 'non-causal'} {tag}: "
                  f"{ms:.3f} ms (plain {plain:.1f} ms, SDPA "
                  f"{'refused' if lib is None else f'{lib:.3f} ms'}), "
                  f"max|d| vs plain {err:.3g}"
                  + ("" if ulps is None else f" = {ulps:.3g} bf16 ulp "
                     "(plain and hi/lo plain)")
                  + ("" if ulps is not None else
                     f", {x3:.3g} of 2e-5 + 1e-4|x| from the 3xTF32 plain")
                  + f"; bound {bms:.4f} ms by {by} ({nb} B, {nops} ops), "
                  f"{bms / ms:.4f} of it | {card}")
            verdict = rows[f"{arch} {tag}"]["verdict"]
            print(f"[moe] flash_attention {arch} {tag} against SDPA's "
                  f"forward: {verdict or 'SDPA refused'} ({ms:.3f} vs "
                  f"{'-' if lib is None else f'{lib:.3f}'} ms) | {card}")
            del q, k, v, got, want
        del q32, k32, v32
        torch.cuda.empty_cache()
    return rows


def moe_decode_shapes(card):
    """(a) flash_decode over a full cache with no window at G = 2, float32
    and bf16: the normalised output and m within 1e-5 + 1e-4|x|, l within
    1e-4 relative of the plain version; timed beside it and SDPA."""
    rng = np.random.default_rng(43)
    rows = {}
    for arch, B, T, H, KH, d in MOE_DECODE:
        q32 = torch.as_tensor(rng.normal(size=(B, H, d)), dtype=torch.float32,
                              device=DEV)
        k32, v32 = (torch.as_tensor(rng.normal(size=(B, T, KH, d)),
                                    dtype=torch.float32, device=DEV)
                    for _ in range(2))
        bk = math.gcd(T, 1024)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            scale = d ** -0.5
            acc, m, l = fd_ops.flash_decode_partial(q, k, v, scale=scale,
                                                    block_k=bk)
            (acc_p, m_p, l_p), plain = timed_once(
                lambda: fd_ref.flash_decode_partial_plain(q, k, v, scale))
            torch.testing.assert_close(acc / l, acc_p / l_p, atol=1e-5,
                                       rtol=1e-4)
            torch.testing.assert_close(m, m_p, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(l, l_p, atol=0, rtol=1e-4)
            err = max_diff(acc / l, acc_p / l_p)
            ms = cuda_ms(lambda: fd_ops.flash_decode_partial(
                q, k, v, scale=scale, block_k=bk), 50)
            lib = sdpa_ms(q[:, None], k, v, None, 50)
            item = torch.finfo(dtype).bits // 8
            nb = (2 * B * T * KH * d + B * H * d) * item + (
                B * H * d + 2 * B * H) * 4
            nops = 4 * d * T * B * H
            peak = BF16_OPS if dtype == torch.bfloat16 else F32_OPS
            bms = max(nb / HBM_BPS, nops / peak) * 1e3
            by = "bytes" if nb / HBM_BPS >= nops / peak else "operations"
            tag = str(dtype).removeprefix("torch.")
            rows[f"{arch} {tag}"] = dict(
                shape=f"B={B} T={T} H={H} KH={KH} d={d} {tag}, no window",
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err)
            print(f"[moe] flash_decode {arch} B={B} T={T} H={H} KH={KH} "
                  f"d={d} {tag}: {ms:.4f} ms by events a wrapper call "
                  f"(plain {plain:.3f} ms, SDPA over the cache "
                  f"{'refused' if lib is None else f'{lib:.4f} ms'}), out "
                  f"max|d| vs plain {err:.3g}; bound {bms:.5f} ms by {by} "
                  f"({nb} B), {bms / ms:.4f} of it | {card}")
        del q32, k32, v32
    return rows


@contextlib.contextmanager
def routes_seen():
    """Records the top-k indices of every ``apply_moe`` call (on the
    CPU) while it is open."""
    from repro_torch.models import moe as moe_lib

    seen, real = [], moe_lib._route

    def spy(*args):
        out = real(*args)
        seen.append(out[2].cpu())
        return out

    moe_lib._route = spy
    try:
        yield seen
    finally:
        moe_lib._route = real


def _launch_counts():
    return {"flash_attention": fa_ops.LAUNCHES["flash_attention"],
            "flash_attention_bwd": fa_ops.LAUNCHES["flash_attention_bwd"],
            "flash_decode": fd_ops.LAUNCHES["flash_decode"],
            "ssd_scan": ssd_ops.LAUNCHES["ssd_scan"]}


def _reset_lm_launches():
    fa_ops.reset_launches()
    fd_ops.reset_launches()
    ssd_ops.reset_launches()


def moe_port_vs_cpu(card):
    """(b) reduced granite-moe, qwen3-moe and jamba in float32 on
    attn_impl "flash" (jamba's Mamba layers on ssd_scan): a prefill and
    SMALL_MOE_STEPS decode steps, then SMALL_MOE_STEPS train steps, on the
    card and on the CPU from the same parameters and inputs: logits within
    1e-4 of their scale, each loss and aux within 1e-4 relative, every MoE
    call's top-k identical."""
    from repro_torch.configs import RunConfig, reduced
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    out, launches = {}, dict.fromkeys(_launch_counts(), 0)
    for arch in SMALL_MOE:
        cfg = reduced(get_config(arch), seq=SMALL_MOE_S)
        params = init_params(cfg, torch.Generator(DEV).manual_seed(7), DEV,
                             torch.float32)
        cpu_params = _tree_map(lambda t: t.cpu(), params)
        ctx = ShardingContext(attn_impl="flash")
        prefill, decode = make_prefill_step(cfg, ctx), make_decode_step(cfg,
                                                                        ctx)
        prompts = torch.as_tensor(LMDataPipeline(
            cfg.vocab, SMALL_MOE_S, 2, seed=4).next_batch()["tokens"]).long()
        S = SMALL_MOE_S

        def serve(p, dev, toks=None):
            logits, caches = prefill(p, {"tokens": prompts.to(dev)})
            got, fed = [logits.cpu()], []
            for i in range(SMALL_MOE_STEPS):
                tok = (logits[:, -1].argmax(-1, keepdim=True).cpu()
                       if toks is None else toks[i])
                fed.append(tok)
                logits, caches = decode(p, {"token": tok.to(dev),
                                            "cache_pos": S + i}, caches)
                got.append(logits.cpu())
            return got, fed

        with routes_seen() as cpu_routes:
            want, fed = serve(cpu_params, "cpu")
        _reset_lm_launches()
        with routes_seen() as card_routes:
            got, _ = serve(params, DEV, fed)
        serve_launches = _launch_counts()
        n_attn = cfg.layer_kinds().count("attn")
        assert serve_launches["flash_attention"] == n_attn, serve_launches
        assert serve_launches["flash_decode"] == n_attn * SMALL_MOE_STEPS
        assert serve_launches["ssd_scan"] == cfg.n_layers - n_attn
        serve_err = max(_rel(a, b) for a, b in zip(got, want))
        assert serve_err <= 1e-4, (arch, serve_err)

        run = RunConfig(microbatches=2, learning_rate=1e-2, warmup_steps=2,
                        total_steps=SMALL_MOE_STEPS, remat="none")
        step = make_train_step(cfg, run, ctx, torch.float32)
        data = LMDataPipeline(cfg.vocab, S, SMALL_MOE_B, seed=3,
                              microbatches=2)
        batches = [data.next_batch() for _ in range(SMALL_MOE_STEPS)]
        state = adamw.init_train_state(params)
        cpu_state = _to_cpu_state(state)
        _reset_lm_launches()
        with routes_seen() as card_train:
            card_m = []
            for b in batches:
                state, m = step(state, b)
                card_m.append({k: float(m[k]) for k in ("loss", "aux")})
        train_launches = _launch_counts()
        assert train_launches["flash_attention"] == (
            n_attn * 2 * SMALL_MOE_STEPS), train_launches
        assert train_launches["flash_attention_bwd"] == (
            n_attn * 2 * SMALL_MOE_STEPS), train_launches
        with routes_seen() as cpu_train:
            cpu_m = []
            for b in batches:
                cpu_state, m = step(cpu_state, b)
                cpu_m.append({k: float(m[k]) for k in ("loss", "aux")})
        train_err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                        zip(card_m, cpu_m) for k in ("loss", "aux"))
        assert train_err <= 1e-4, (arch, card_m, cpu_m)
        routes = (card_routes + card_train, cpu_routes + cpu_train)
        assert len(routes[0]) == len(routes[1]) > 0, arch
        same = all(torch.equal(a, b) for a, b in zip(*routes))
        assert same, (arch, "top-k differs between the card and the CPU")
        for k in launches:
            launches[k] += serve_launches[k] + train_launches[k]
        out[arch] = dict(serve_max_rel=serve_err, train_max_rel=train_err,
                         card=card_m, cpu=cpu_m, moe_calls=len(routes[0]),
                         serve_launches=serve_launches,
                         train_launches=train_launches)
        print(f"[moe] reduced {arch} float32 on the card vs the CPU: "
              f"prefill + {SMALL_MOE_STEPS} decode steps, logits max rel "
              f"{serve_err:.3g}; {SMALL_MOE_STEPS} train steps, loss "
              f"{[round(m['loss'], 6) for m in card_m]} aux "
              f"{[round(m['aux'], 6) for m in card_m]}, max rel "
              f"{train_err:.3g} (<= 1e-4); top-k identical in all "
              f"{len(routes[0])} MoE calls; launches serve {serve_launches},"
              f" train {train_launches}")
        del params, cpu_params, state, cpu_state
        torch.cuda.empty_cache()
    return out, launches


def _serve_numbers(tag, B, S, prefill_ms, step_ms, launches, card):
    decode_ms = float(np.mean(step_ms))
    print(f"[moe] {tag} B={B} S={S}: prefill {prefill_ms:.1f} ms "
          f"({B * S / prefill_ms * 1e3:.4g} tokens/s); decode "
          f"{len(step_ms)} steps {decode_ms:.3f} ms/token ("
          f"{B * 1e3 / decode_ms:.1f} tokens/s, steps {min(step_ms):.3f}-"
          f"{max(step_ms):.3f} ms); launches {launches} | {card}")
    return dict(B=B, S=S, prefill_ms=prefill_ms,
                prefill_tokens_per_s=B * S / prefill_ms * 1e3,
                decode_ms_per_token=decode_ms,
                decode_tokens_per_s=B * 1e3 / decode_ms, step_ms=step_ms,
                launches=launches)


def _serve_main_path(cfg, params, batch, S, steps):
    """The main path with the counters reset just before and read just
    after: one prefill, ``steps`` greedy decode steps (host clock around
    synchronised steps). Returns (logits, prefill ms, step ms, launches,
    the caches after the prefill's first decode input)."""
    ctx = ShardingContext(attn_impl="flash")
    prefill, decode = make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
    _reset_lm_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits[:, -1].argmax(-1, keepdim=True)
    step_ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, caches = decode(params, {"token": tok, "cache_pos": S + i},
                             caches)
        tok = out[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launch_counts()
    assert launches["flash_attention"] == cfg.n_layers, launches
    assert launches["flash_decode"] == cfg.n_layers * steps, launches
    assert bool(torch.isfinite(logits).all() and torch.isfinite(out).all())
    return logits, prefill_ms, step_ms, launches, (prefill, decode, tok,
                                                   caches)


def _profiles(arch, card, batch, S):
    """{step: host ms, device-busy share, kernel ms and events} of one
    profiled prefill and decode step of ``arch`` (an encode for hubert),
    in a fresh process (``fresh_profile``)."""
    prof = {}
    for what, p in fresh_profile("serve", batch, arch=arch, S=S).items():
        print_profile(f"{arch} {what} profile", *p, card, tag="moe")
        prof[what] = dict(host_ms=p[0], device_busy=p[1], kernels_ms=p[2],
                          events=p[3])
    return prof


def _flips(a, b):
    """(tokens x layers whose top-k set differs, tokens x layers) between
    two runs' lists of top-k indices."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    return diff, sum(x.shape[0] for x in a)


def moe_serve(card):
    """(c) granite-moe-1b-a400m served at full size, then its flash route
    held to the bf16 and float32 ``full`` routes on MOE_CHECK_B prompts."""
    cfg = get_config(MOE_ARCH)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.as_tensor(LMDataPipeline(cfg.vocab, MOE_S, MOE_B, seed=0)
                              .next_batch()["tokens"], device=DEV).long()
    make_prefill_step(cfg, ShardingContext(attn_impl="flash"))(
        params, {"tokens": prompts[:, :128]})  # load, warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, prefill_ms, step_ms, launches, (prefill, decode, tok, caches) = \
        _serve_main_path(cfg, params, {"tokens": prompts}, MOE_S, MOE_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = _serve_numbers(f"{MOE_ARCH} ({n_params / 1e9:.3f} B params)",
                         MOE_B, MOE_S, prefill_ms, step_ms, launches, card)
    assert caches["layer0"].k.shape[2] == MOE_S  # no window: S slots
    print(f"[moe] peak memory of the served batch {peak:.2f} GiB | {card}")
    row.update(params=n_params, peak_gib=peak)
    row["profile"] = _profiles(MOE_ARCH, card, {"tokens": prompts}, MOE_S)
    del caches
    torch.cuda.empty_cache()

    # -- the flash route against the full routes on MOE_CHECK_B prompts --
    two = {"tokens": prompts[:MOE_CHECK_B]}
    full = make_prefill_step(cfg, ShardingContext(attn_impl="full"))
    with routes_seen() as r_flash:
        l_flash, _ = prefill(params, two)
    with routes_seen() as r_full:
        l_full, _ = full(params, two)
    p32 = _tree_map(lambda t: t.float(), params)
    with routes_seen() as r_32:
        l_32, _ = full(p32, two)
    del p32
    torch.cuda.empty_cache()
    e_flash, e_full = _rel(l_flash, l_32), _rel(l_full, l_32)
    assert e_flash <= max(2 ** -8, ROUTE_SLACK * e_full), (e_flash, e_full)
    same_b = torch.equal(l_flash, logits[:MOE_CHECK_B])
    flips_full, n_dec = _flips(r_flash, r_full)
    flips_32, _ = _flips(r_flash, r_32)
    flips_ref, _ = _flips(r_full, r_32)
    print(f"[moe] last-position logits on {MOE_CHECK_B} prompts, max|d| / "
          f"max|float32 full|: flash route {e_flash:.4g}, bf16 full route "
          f"{e_full:.4g} (held: flash <= max(2^-8, {ROUTE_SLACK} x full)); "
          f"the {MOE_CHECK_B}-prompt flash logits equal the batch's "
          f"{same_b}; routing choices (token x layer top-{cfg.moe.top_k} "
          f"sets, of "
          f"{n_dec}) that differ: flash vs bf16 full {flips_full}, flash vs "
          f"float32 full {flips_32}, bf16 full vs float32 full {flips_ref} "
          "(a flip at a near tie of the router's probabilities, where the "
          "routes' rounding decides, is not a fault)")
    row.update(logits_err_flash=e_flash, logits_err_full=e_full,
               route_flips=dict(flash_vs_full=flips_full,
                                flash_vs_f32=flips_32,
                                full_vs_f32=flips_ref, decisions=n_dec))
    del params, logits, l_flash, l_full, l_32
    torch.cuda.empty_cache()
    return row


def moe_train(card):
    """(c) granite-moe-1b-a400m trained at full size: bf16 compute over
    float32 master weights, S = MOE_TRAIN_S, a global batch of 2 in 2
    microbatches, remat "none", MOE_TRAIN_STEPS steps."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import adamw

    cfg = get_config(MOE_ARCH)
    run = RunConfig(microbatches=MOE_TRAIN_MB, remat="none")
    params = init_params(cfg, torch.Generator(DEV).manual_seed(1), DEV)
    state = adamw.init_train_state(params)
    del params
    torch.cuda.empty_cache()
    data = LMDataPipeline(cfg.vocab, MOE_TRAIN_S, MOE_TRAIN_BATCH, seed=2,
                          microbatches=MOE_TRAIN_MB)
    step = make_train_step(cfg, run, ShardingContext(attn_impl="flash"))
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_launches()
    ms, metrics = [], []
    calls, spy = _bwd_spy()
    with mock.patch.object(fa_ops, "flash_attention_bwd", spy):
        for _ in range(MOE_TRAIN_STEPS):
            batch = data.next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(m[k]) for k in ("loss", "aux",
                                                     "grad_norm")})
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = cfg.n_layers * MOE_TRAIN_MB * MOE_TRAIN_STEPS
    assert launches["flash_attention"] == want, (launches, want)
    assert launches["flash_attention_bwd"] == want, (launches, want)
    assert not calls, ("the torch-op backward ran", calls)
    assert all(np.isfinite(list(m.values())).all() for m in metrics), metrics
    steady = float(np.mean(ms[1:]))
    tok_s = MOE_TRAIN_BATCH * MOE_TRAIN_S / (steady / 1e3)
    print(f"[moe] {MOE_ARCH} trained bf16 over float32 masters, S="
          f"{MOE_TRAIN_S}, batch {MOE_TRAIN_BATCH} in {MOE_TRAIN_MB} "
          f"microbatches, remat none, capacity \"factor\" C="
          f"{moe_lib._capacity(cfg.moe, MOE_TRAIN_S, 'factor')}: "
          f"loss {[round(m['loss'], 4) for m in metrics]}, aux "
          f"{[round(m['aux'], 4) for m in metrics]}, grad norm "
          f"{[round(m['grad_norm'], 4) for m in metrics]}; ms a step "
          f"{[round(x, 1) for x in ms]} (steady {steady:.1f}; 1,318.2 on "
          f"the torch-op backward, PERF.md §5), {tok_s:.1f} tokens/s, peak "
          f"memory {peak:.2f} GiB, "
          f"launches {launches}, the torch-op backward called {len(calls)} "
          f"times | {card}")
    del state, m
    torch.cuda.empty_cache()
    return dict(metrics=metrics, ms=ms, steady_ms=steady,
                tokens_per_s=tok_s, peak_gib=peak, launches=launches,
                torch_op_bwd_calls=len(calls))


def vlm_serve(card):
    """(d) internvl2-2b served at full size: VLM_B prompts of 256 patch
    embeddings (random bf16) before VLM_TEXT text tokens, then VLM_STEPS
    greedy decode steps."""
    cfg = get_config(VLM_ARCH)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    n_front = cfg.frontend_positions
    gen = torch.Generator(DEV).manual_seed(5)
    embeds = torch.randn((VLM_B, n_front, cfg.d_model), generator=gen,
                         device=DEV).bfloat16()
    text = torch.as_tensor(LMDataPipeline(cfg.vocab, VLM_TEXT, VLM_B, seed=1)
                           .next_batch()["tokens"], device=DEV).long()
    batch = {"embeds": embeds, "tokens": text}
    S = n_front + VLM_TEXT
    make_prefill_step(cfg, ShardingContext(attn_impl="flash"))(
        params, {"embeds": embeds[:, :64], "tokens": text[:, :64]})
    torch.cuda.synchronize()
    logits, prefill_ms, step_ms, launches, (prefill, decode, tok, caches) = \
        _serve_main_path(cfg, params, batch, S, VLM_STEPS)
    row = _serve_numbers(f"{VLM_ARCH} ({n_front} patch embeddings + "
                         f"{VLM_TEXT} text tokens)", VLM_B, S, prefill_ms,
                         step_ms, launches, card)
    assert logits.shape == (VLM_B, 1, cfg.vocab)
    row["profile"] = _profiles(VLM_ARCH, card, batch, S)
    del params, caches, logits
    torch.cuda.empty_cache()
    return row


def audio_encode(card):
    """(e) hubert-xlarge through ``make_encode_step``: AUDIO_B clips of
    AUDIO_S frame embeddings on flash_attention (non-causal; S is not a
    multiple of the kernel's tiles, so the key-length mask decides);
    every position's logits on one clip held to the bf16 and float32
    ``full`` routes as phase 7's rule."""
    from repro_torch.launch.steps import make_encode_step

    cfg = get_config(AUDIO_ARCH)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    gen = torch.Generator(DEV).manual_seed(6)
    embeds = torch.randn((AUDIO_B, AUDIO_S, cfg.d_model), generator=gen,
                         device=DEV).bfloat16()
    encode = make_encode_step(cfg, ShardingContext(attn_impl="flash"))
    encode(params, {"embeds": embeds[:, :100]})  # load, warm up
    _reset_lm_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = encode(params, {"embeds": embeds})
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    assert launches["flash_attention"] == cfg.n_layers, launches
    assert logits.shape == (AUDIO_B, AUDIO_S, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    frames_s = AUDIO_B * AUDIO_S / encode_ms * 1e3
    print(f"[moe] {AUDIO_ARCH} encode B={AUDIO_B} S={AUDIO_S}: "
          f"{encode_ms:.1f} ms ({frames_s:.4g} frames/s, "
          f"{AUDIO_B * AUDIO_S / 50 / (encode_ms / 1e3):.4g} s of audio a "
          f"second); launches {launches} | {card}")
    one = {"embeds": embeds[:1]}
    full = make_encode_step(cfg, ShardingContext(attn_impl="full"))
    l_full = full(params, one)
    p32 = _tree_map(lambda t: t.float(), params)
    l_32 = full(p32, {"embeds": embeds[:1].float()})
    del p32
    e_flash, e_full = _rel(logits[:1], l_32), _rel(l_full, l_32)
    assert e_flash <= max(2 ** -8, ROUTE_SLACK * e_full), (e_flash, e_full)
    print(f"[moe] {AUDIO_ARCH} logits of every position on one clip, max|d|"
          f" / max|float32 full|: flash route {e_flash:.4g}, bf16 full "
          f"route {e_full:.4g} (held: flash <= max(2^-8, {ROUTE_SLACK} x "
          "full))")
    prof = _profiles(AUDIO_ARCH, card, {"embeds": embeds}, AUDIO_S)
    del params, logits, l_full, l_32
    torch.cuda.empty_cache()
    return dict(B=AUDIO_B, S=AUDIO_S, encode_ms=encode_ms,
                frames_per_s=frames_s, launches=launches,
                logits_err_flash=e_flash, logits_err_full=e_full,
                profile=prof)


def phase_moe(card):
    """Phase 11: MoE layers and the modality frontends, (a) to (e)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn = moe_attention_shapes(card)
    dec = moe_decode_shapes(card)
    small, small_launches = moe_port_vs_cpu(card)
    serve = moe_serve(card)
    train = moe_train(card)
    vlm = vlm_serve(card)
    audio = audio_encode(card)
    launches = {k: small_launches[k] + sum(r["launches"][k] for r in (
        serve, train, vlm, audio)) for k in small_launches}
    return dict(attention_shapes=attn, decode_shapes=dec, small=small,
                serve=serve, train=train, vlm=vlm, audio=audio,
                launches=launches)


# ---------------------------------------------------------------------------
# Phase 12: the jitted trackers on CUDA graphs, the serving CLI, the
# examples, and the whole-step shares of phases 7, 8, 10 and 11 from the
# analytic models (models/counting.py, roofline/memmodel.py).
# ---------------------------------------------------------------------------

CLI_KINDS = ("lkf", "ekf")
JIT_PROFILED = 50  # replays of each tracker read by torch.profiler in (a)
# the kernels of one frame by name part: the frame's predict, cost and
# update launches and the greedy's two
JIT_KERNELS = {"frame": ("frame_predict", "frame_cost", "frame_update"),
               "imm": ("imm_predict", "imm_cost", "imm_update")}
EXAMPLES = ("torch_tracking_pipeline", "torch_mot_demo", "torch_serve_lm")


def _frame_tensors(res):
    """Every tensor of a FrameResult: the bank's fields, assoc,
    unassigned, confirmed, and for IMM mode_probs and x_est."""
    return [t for t in list(res.bank) + list(res[1:]) if t is not None]


def _jit_setup(kind):
    """(model, tracker config, make, launch-count name) of (a)."""
    model = filters.make_imm() if kind == "imm" else filters.get_filter(kind)
    cfg = tracker.TrackerConfig(capacity=C_SERVE, max_meas=M_SERVE)
    if kind == "imm":
        return model, cfg, tracker.make_jitted_imm_tracker, "katana_imm_frame"
    return model, cfg, tracker.make_jitted_tracker, "katana_frame"


def jit_frames(kind):
    """Phase 3's scene as the padded (z, valid) frames of ``kind``."""
    model = _jit_setup(kind)[0]
    smodel = filters.get_filter("cv9") if kind == "imm" else model
    scene = traj.SceneConfig(T=T_SERVE, max_targets=200, birth_rate=1.0,
                             death_rate=0.002, clutter_rate=20.0,
                             extent=200.0, max_meas=M_SERVE)
    z, valid, _ = traj.mot_scene(smodel, scene, seed=7)
    return [padded(z[t][valid[t]].astype(np.float32), model.m, M_SERVE)
            for t in range(T_SERVE)]


def jitted_events(frames, replays):
    """The "jitted" job: for each kind of ``frames`` ({kind: frames}) a
    jitted tracker captures frame 0; then one torch.profiler session holds
    ``replays`` replays of the frames after it, kind after kind (one
    session: later sessions of a process lose events). Returns each
    tracker's captures and replays, the launches ``ops.LAUNCHES`` counted
    in the session and its events of each kernel of the frames
    (``JIT_KERNELS``, ``GREEDY_KERNELS``)."""
    steps = {}
    for kind, fr in frames.items():
        model, cfg, make, _ = _jit_setup(kind)
        init, step = make(model, cfg, device="cuda")
        steps[kind] = (step, step(init(), *fr[0]).bank)
    torch.cuda.synchronize()
    ops.reset_launches()
    with torch.profiler.profile(activities=list(profiling.ACTIVITIES)) as prof:
        for kind, (step, bank) in steps.items():
            for zt, vt in frames[kind][1:replays + 1]:
                bank = step(bank, zt, vt).bank
        torch.cuda.synchronize()
    _, count = profiling.kernel_events(prof)
    parts = JIT_KERNELS["frame"] + JIT_KERNELS["imm"] + GREEDY_KERNELS
    return dict(captures={k: s.captures for k, (s, _) in steps.items()},
                replays={k: s.replays for k, (s, _) in steps.items()},
                launches={n: ops.LAUNCHES[n] for n in (
                    "katana_frame", "katana_imm_frame", "greedy_assign")},
                events={p: sum(c for k, c in count.items() if p in k)
                        for p in parts})


def jitted_profile(frames, card):
    """(a), last: torch.profiler's kernel events of ``JIT_PROFILED``
    replays of each jitted tracker, in one fresh process
    (``jitted_events``): one event of each kernel of the frame a replay,
    as many as the launches ``ops.LAUNCHES`` counted over them."""
    n = JIT_PROFILED
    prof = fresh_profile("jitted", {k: f[:n + 1] for k, f in frames.items()},
                         replays=n)
    n_imm = sum(k == "imm" for k in frames)
    want = {"katana_frame": n * (len(frames) - n_imm),
            "katana_imm_frame": n * n_imm, "greedy_assign": n * len(frames)}
    assert set(prof["captures"].values()) == {1}, prof
    assert set(prof["replays"].values()) == {n}, prof
    assert prof["launches"] == want, prof
    of = {p: name for name, parts in (
        ("katana_frame", JIT_KERNELS["frame"]),
        ("katana_imm_frame", JIT_KERNELS["imm"]),
        ("greedy_assign", GREEDY_KERNELS)) for p in parts}
    for part, events in prof["events"].items():
        assert events == want[of[part]], (part, prof)
    print(f"[jit] {n} replays of each of {', '.join(frames)} in one fresh "
          "process: torch.profiler's kernel events "
          + ", ".join(f"{k} {e}" for k, e in prof["events"].items())
          + f", as many as the launches counted {prof['launches']} | {card}")
    return prof


def jitted_tracker(kind, frames, card):
    """(a) ``make_jitted_tracker`` / ``make_jitted_imm_tracker`` over phase
    3's scene (C = 1,024, M = 256, T = 300): one capture, one frame launch
    (and one greedy) a frame with the counts reset just before and read
    just after; then the eager frame step over the same frames, every
    tensor of every frame bit for bit with the replayed graph's. The host
    ms a frame of each, every frame ending in a sync as ``submit`` does
    (frame 0, which captures, left out of the replayed mean)."""
    model, cfg, make, name = _jit_setup(kind)
    is_imm = kind == "imm"
    eager = tracker.imm_frame_step if is_imm else tracker.frame_step
    init, step = make(model, cfg, device="cuda")

    def drive(fn):
        bank, out, ms = init(), [], []
        torch.cuda.synchronize()
        for zt, vt in frames:
            t0 = time.perf_counter()
            res = fn(bank, zt, vt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(res)
            bank = res.bank
        return out, ms

    ops.reset_launches()
    got, ms_g = drive(step)
    launches = dict(ops.LAUNCHES)
    assert step.captures == 1, (kind, step.captures)
    assert step.replays == T_SERVE - 1, (kind, step.replays)
    assert launches[name] == T_SERVE, (kind, launches)
    assert launches["greedy_assign"] == T_SERVE, (kind, launches)
    want, ms_e = drive(lambda b, zt, vt: eager(model, cfg, b, zt, vt))
    for t, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(_frame_tensors(a), _frame_tensors(b)):
            assert torch.equal(x, y), (kind, t)
    confirmed = int(want[-1].confirmed.sum())
    replay_ms, eager_ms = float(np.mean(ms_g[1:])), float(np.mean(ms_e[1:]))
    print(f"[jit] {kind} C={C_SERVE} M={M_SERVE} T={T_SERVE}: every frame "
          f"bit for bit with the eager frame step ({confirmed} confirmed at "
          f"the end); captures {step.captures}, replays {step.replays}, "
          f"{name} launches {launches[name]}, greedy "
          f"{launches['greedy_assign']}"
          f"; host ms a frame with a sync: replayed {replay_ms:.4f}, eager "
          f"{eager_ms:.4f} (frame 0 with the capture {ms_g[0]:.1f}) | {card}")
    return dict(captures=step.captures, replays=step.replays,
                launches={name: launches[name],
                          "greedy_assign": launches["greedy_assign"]},
                replay_ms=replay_ms, eager_ms=eager_ms,
                capture_frame_ms=ms_g[0], confirmed=confirmed)


def serve_cli(card):
    """(b) ``python -m repro_torch.launch.serve``'s ``main`` on the card
    for lkf and ekf: its confirmed-track count every frame equal to the
    same call with ``--device cpu``."""
    from repro_torch.launch import serve

    out = {}
    for kind in CLI_KINDS:
        got = serve.main(["--filter", kind])
        want = serve.main(["--filter", kind, "--device", "cpu"])
        if got != want:
            diff = [(t, a, b) for t, (a, b) in enumerate(zip(got, want))
                    if a != b]
            print(f"[cli] {kind}: card and CPU differ at (frame, card, CPU) "
                  f"{diff}")
        assert got == want, kind
        print(f"[cli] {kind}: {len(got)} frames, n_conf_hist equal to the "
              f"CPU's (final {got[-1]}) | {card}")
        out[kind] = got
    return out


def run_examples(card):
    """(c) the three examples at their defaults on the card."""
    import importlib.util

    out = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main([])
        out[name] = (time.perf_counter() - t0) * 1e3
        print(f"[examples] {name} ran at its defaults on the card in "
              f"{out[name]:.1f} ms | {card}")
    return out


def step_shares(lm, mamba, train, moe, card):
    """(d) Each whole step of phases 7, 8, 10 and 11 against the card's
    peaks: its model FLOPs (``counting.model_flops``) and the share of
    the bf16 peak its host time reached (mfu = FLOPs / (host s x
    BF16_OPS)); for the decode steps also the analytic bytes a step
    (``memmodel.analytic_bytes_dev`` on one card), their bound at HBM_BPS
    and the share of it reached."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.counting import model_flops
    from repro_torch.roofline.memmodel import analytic_bytes_dev

    argv = MAMBA_TRAIN_ARGV
    m_arch, m_seq, m_batch = (argv[argv.index(f) + 1]
                              for f in ("--arch", "--seq", "--batch"))
    steps = [  # (phase, arch, kind, B, S, host ms)
        ("7", LM_ARCH, "prefill", lm["B"], lm["S"], lm["prefill_ms"]),
        ("7", LM_ARCH, "decode", lm["B"], lm["S"], lm["decode_ms_per_token"]),
        ("8", MAMBA_ARCH, "prefill", mamba["B"], mamba["S"],
         mamba["prefill_ms"]),
        ("8", MAMBA_ARCH, "decode", mamba["B"], mamba["S"],
         mamba["decode_ms_per_token"]),
        ("10", TRAIN_ARCH, "train", TRAIN_BATCH, TRAIN_S,
         train["danube"]["steady_ms"]),
        ("10", m_arch, "train", int(m_batch), int(m_seq),
         train["mamba"]["ms"]),
    ] + [("11", arch, kind, r["B"], r["S"], r[key])
         for arch, r in ((MOE_ARCH, moe["serve"]), (VLM_ARCH, moe["vlm"]))
         for kind, key in (("prefill", "prefill_ms"),
                           ("decode", "decode_ms_per_token"))] + [
        ("11", MOE_ARCH, "train", MOE_TRAIN_BATCH, MOE_TRAIN_S,
         moe["train"]["steady_ms"]),
        ("11", AUDIO_ARCH, "prefill", moe["audio"]["B"], moe["audio"]["S"],
         moe["audio"]["encode_ms"])]
    rows = []
    for phase, arch, kind, B, S, ms in steps:
        cfg = get_config(arch)
        shape = ShapeConfig(f"{kind}_{S}", S, B, kind)
        flops = model_flops(cfg, shape)
        mfu = flops / (ms / 1e3 * BF16_OPS)
        row = dict(phase=phase, arch=arch, kind=kind, B=B, S=S, host_ms=ms,
                   model_flops=flops, mfu=mfu)
        what = "encode" if cfg.is_encoder_only else kind
        line = (f"[shares] phase {phase} {arch} {what} B={B} S={S}: model "
                f"FLOPs {flops:.4e}, host {ms:.3f} ms, mfu {mfu:.6f}")
        if kind == "decode":
            nbytes = analytic_bytes_dev(cfg, shape, RunConfig(), 1, 1)
            bound = nbytes / HBM_BPS * 1e3
            row.update(analytic_bytes=nbytes, byte_bound_ms=bound,
                       byte_bound_share=bound / ms)
            line += (f"; analytic bytes {nbytes:.4e}, byte bound "
                     f"{bound:.4f} ms, {bound / ms:.4f} of it reached")
        print(f"{line} | {card}")
        rows.append(row)
    return rows


def phase_jitted(lm, mamba, train, moe, card):
    """Phase 12, (a) to (d)."""
    frames = {kind: jit_frames(kind) for kind in ("lkf", "ekf", "imm")}
    jit = {kind: jitted_tracker(kind, frames[kind], card) for kind in frames}
    events = jitted_profile(frames, card)["events"]
    cli = serve_cli(card)
    examples = run_examples(card)
    shares = step_shares(lm, mamba, train, moe, card)
    return dict(jitted=jit, jitted_events=events, cli=cli,
                examples_ms=examples, shares=shares)


# ---------------------------------------------------------------------------
# Phase 13: the mesh on the card. granite-moe-1b-a400m on a ('data' 2,
# 'model' 2) mesh of 4 ranks, every rank a process on the one H100 over a
# ``gloo`` group (NCCL refuses two ranks on one card), its CUDA tensors
# staged through host buffers for every collective but ``all_reduce``
# (``distributed/collectives.py``). The parent makes the single-card runs
# on the same seeded weights; ``repro_torch.launch.local_world`` runs the
# ranks (``mesh_job``) with a deadline.
# ---------------------------------------------------------------------------

MESH_SHAPE, MESH_RANKS = (2, 2), 4
# phase 11's shape; 16 decode steps (phase 11 runs 32): the script's time
# limit, every step a few hundred ms through host-staged collectives
MESH_B, MESH_S, MESH_STEPS = MOE_B, MOE_S, 16
# serving's weights are not FSDP-split (training's are): gathering
# granite-moe's experts through host buffers every token would time the
# staging, not the mesh; tp2d (experts x FFN, no weight movement) is the
# reference's decode layout
MESH_SERVE_FSDP = False
MESH_TRAIN_LAYERS, MESH_TRAIN_S = 4, 2048
MESH_TRAIN_BATCH, MESH_TRAIN_MB, MESH_TRAIN_STEPS = 8, 2, 2
MESH_PSUM_N = 2 ** 24
MESH_DEADLINE = 300.0
MESH_TRAIN_TOL = 1e-4
MESH_TIMING = ("4 ranks sharing one H100 over gloo (host-staged): a "
               "correctness run, not a scaling number")


def _mesh_run():
    """The reference's default schedule (lr 3e-4 after 100 warmup steps):
    with lr 1e-3 from the first step, AdamW's first updates (lr x the sign
    of each gradient) turn the float32 sums' order into weight changes of
    lr where a gradient is rounding noise, and the grad norm of step 3 on
    the mesh parted from the one card's by 7.3e-4 (PERF.md, PR 27)."""
    from repro_torch.configs import RunConfig

    return RunConfig(microbatches=MESH_TRAIN_MB, remat="none")


def _mesh_train_cfg():
    return dataclasses.replace(get_config(MOE_ARCH),
                               n_layers=MESH_TRAIN_LAYERS)


def mesh_serve_reference(cfg, batch, S, steps, forced=None):
    """The single card on seed 0's weights: a flash prefill of ``batch``
    (S positions) and ``steps`` decode steps, greedy in bf16 (their input
    tokens are the mesh's forced ones), or in float32 on ``forced``.
    Returns the logits of every step (host) and the tokens."""
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    if forced is not None:
        params = _tree_map(lambda t: t.float(), params)
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items()}
    ctx = ShardingContext(attn_impl="flash")
    prefill, decode = make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
    logits, caches = prefill(params, batch)
    out, toks = [logits.float().cpu()], []
    for i in range(steps):
        tok = (logits[:, -1].argmax(-1, keepdim=True) if forced is None
               else forced[:, i:i + 1].to(DEV))
        toks.append(tok)
        logits, caches = decode(params, {"token": tok, "cache_pos": S + i},
                                caches)
        out.append(logits.float().cpu())
    del params, caches
    torch.cuda.empty_cache()
    return out, torch.cat(toks, dim=1).cpu()


def hold_steps(what, got, one, f32, errs, over):
    """Every step's logits of the mesh (``got``) held to phase 11's limit
    on the one card's bf16 distance (``one``) from float32 (``f32``) over
    the run, its largest step: the distances of two bf16 runs part step by
    step (the first run had the mesh at 0.0506 where the one card was at
    0.0189 of a run whose steps span 0.0189-0.0811, PERF.md §6).
    Records the distances in ``errs[what]`` and each step past the limit
    in ``over``."""
    e_mesh = [_rel(g, w) for g, w in zip(got, f32)]
    e_one = [_rel(o, w) for o, w in zip(one, f32)]
    limit = max(2 ** -8, ROUTE_SLACK * max(e_one))
    share = [m / limit for m in e_mesh]
    over += [(what, i, m, limit) for i, (m, sh) in enumerate(
        zip(e_mesh, share)) if sh > 1]
    errs[what] = dict(
        vs_f32=max(e_mesh), one_card_vs_f32=max(e_one),
        vs_one_card=max(_rel(g, o) for g, o in zip(got, one)),
        share_of_limit=max(share), steps_vs_f32=e_mesh,
        steps_one_card_vs_f32=e_one, steps=len(e_mesh),
        steps_over_twice_the_one_card=sum(
            m > max(2 ** -8, ROUTE_SLACK * o) for m, o in zip(e_mesh, e_one)))
    print(f"[mesh] {what}: max|d| / max|f32| a step, mesh "
          f"{[round(x, 4) for x in e_mesh]}, one card "
          f"{[round(x, 4) for x in e_one]}; the worst step at "
          f"{max(share):.3f} of the limit {limit:.4g}; steps past 2x the one "
          f"card's same step {errs[what]['steps_over_twice_the_one_card']}")


def mesh_train_reference(batches):
    """The single card: MESH_TRAIN_STEPS + 1 float32 steps of the cut
    granite-moe on seed 1's weights. In the first MESH_TRAIN_STEPS each of
    the mesh's microbatches is cut into its 2 data blocks, one microbatch
    each: on ('data' 2, 'model' 2) the MoE capacity and aux come from each
    block's tokens (the reference's local capacity and pmean), and every
    term of the loss is a mean over equal blocks, so this is the mesh's
    step on one card. The last step, on ('data' 4, 'model' 1), runs the
    reference's one-device MoE on the whole microbatch: the batch as it
    is."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg, D = _mesh_train_cfg(), MESH_SHAPE[0]
    state = adamw.init_train_state(init_params(
        cfg, torch.Generator(DEV).manual_seed(1), DEV, torch.float32))
    ctx = ShardingContext(attn_impl="flash")
    blocks = make_train_step(cfg, dataclasses.replace(
        _mesh_run(), microbatches=MESH_TRAIN_MB * D), ctx,
        compute_dtype=torch.float32)
    whole = make_train_step(cfg, _mesh_run(), ctx,
                            compute_dtype=torch.float32)
    out = []
    for i, b in enumerate(batches):
        if i < MESH_TRAIN_STEPS:
            b = {k: v.reshape((MESH_TRAIN_MB * D, -1) + v.shape[2:])
                 for k, v in b.items()}
            state, m = blocks(state, b)
        else:
            state, m = whole(state, b)
        out.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
    del state
    torch.cuda.empty_cache()
    return out


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _mesh_serve(rank, mesh, tensors, out):
    """(a) the prefill, (b) MESH_STEPS decode steps in each moe mode on the
    sequence-split cache, and one rank's flash_decode_partial on its block
    against the plain version."""
    import torch.distributed as dist

    from repro_torch.launch import specs as specs_lib
    from repro_torch.models.attention import KVCache
    from repro_torch.sharding import rules

    cfg = get_config(MOE_ARCH)
    full = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                       torch.bfloat16)
    ctx = rules.make_context(mesh, fsdp=MESH_SERVE_FSDP, attn_impl="flash")
    params = rules.shard_tree(full, specs_lib.param_shardings(cfg, ctx), ctx)
    prompts = tensors["prompts"].to(DEV)
    prefill = make_prefill_step(cfg, ctx)
    prefill(params, {"tokens": prompts[:, :128]})  # load, warm up
    _reset_lm_launches()
    dist.barrier()
    (logits, caches), out["prefill_ms"] = _synced_ms(
        lambda: prefill(params, {"tokens": prompts}))
    out["prefill_launches"] = _launch_counts()
    if rank == 0:
        out["prefill_logits"] = logits.float().cpu()
    out["cache_block"] = tuple(caches["layer0"].k.shape)
    del params
    forced = tensors["forced"].to(DEV)
    for mode in ("gather", "tp2d"):
        dctx = rules.make_context(mesh, fsdp=MESH_SERVE_FSDP,
                                  attn_impl="flash", moe_weight_mode=mode)
        params = rules.shard_tree(full, specs_lib.param_shardings(cfg, dctx),
                                  dctx)
        c = {k: KVCache(v.k.clone(), v.v.clone()) for k, v in caches.items()}
        decode = make_decode_step(cfg, dctx)
        _reset_lm_launches()
        dist.barrier()
        logits_all, ms = [], []
        for i in range(MESH_STEPS):
            (logits, c), t = _synced_ms(lambda: decode(
                params, {"token": forced[:, i:i + 1],
                         "cache_pos": MESH_S + i}, c))
            if rank == 0:  # the mesh's logits (every rank holds them)
                logits_all.append(logits.float().cpu())
            ms.append(t)
        out[f"decode_{mode}"] = dict(logits=logits_all, step_ms=ms,
                                     launches=_launch_counts())
        if mode == "gather" and rank == 0:
            k, v = c["layer0"].k[0], c["layer0"].v[0]
            B, _, KH, d = k.shape
            q = torch.randn((B, cfg.attention.n_heads, d),
                            generator=torch.Generator(DEV).manual_seed(7),
                            device=DEV).to(k.dtype)
            fd_ops.reset_launches()
            acc, m, l = fd_ops.flash_decode_partial(
                q, k, v, scale=d ** -0.5, block_k=math.gcd(k.shape[1], 1024))
            assert fd_ops.LAUNCHES["flash_decode"] == 1
            acc_p, m_p, l_p = fd_ref.flash_decode_partial_plain(q, k, v,
                                                                d ** -0.5)
            torch.testing.assert_close(acc / l, acc_p / l_p, atol=1e-5,
                                       rtol=1e-4)
            torch.testing.assert_close(m, m_p, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(l, l_p, atol=0, rtol=1e-4)
            out["partial_check"] = dict(
                shape=f"B={B} T={k.shape[1]} H={q.shape[1]} KH={KH} d={d} "
                      "bf16, rank 0's block of layer 0",
                max_abs_err=max_diff(acc / l, acc_p / l_p))
        del params, c
    del full, caches
    torch.cuda.empty_cache()


def _mesh_train(rank, mesh, tensors, out, root):
    """(c) MESH_TRAIN_STEPS float32 steps on the mesh, a save from it (the
    full arrays gathered on rank 0), the restore onto the same mesh bit
    for bit with the state, the restore of the same file onto ('data' 4,
    'model' 1) (each rank's blocks cut from it, as the CPU tests hold to
    the gathered state) and one more step there."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import abstract_params
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules

    cfg, run = _mesh_train_cfg(), _mesh_run()
    ctx = rules.make_context(mesh, attn_impl="flash")
    specs = specs_lib.state_shardings(cfg, run, ctx)
    state = rules.shard_tree(adamw.init_train_state(init_params(
        cfg, torch.Generator(DEV).manual_seed(1), DEV, torch.float32)),
        specs, ctx)
    torch.cuda.empty_cache()
    step = make_train_step(cfg, run, ctx, compute_dtype=torch.float32)
    metrics, ms = [], []
    batches = tensors["batches"]
    _reset_lm_launches()
    for b in batches[:MESH_TRAIN_STEPS]:
        (state, m), t = _synced_ms(lambda: step(state, b))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "aux")})
        ms.append(t)
    launches = _launch_counts()["flash_attention"]
    _, save_ms = _synced_ms(lambda: ckpt.save(root, MESH_TRAIN_STEPS, state,
                                              ctx=ctx, specs=specs))
    like = adamw.abstract_train_state(abstract_params(cfg, torch.float32))
    # the checkpoint restored onto this mesh is the state, bit for bit
    (back, _), restore_ms = _synced_ms(lambda: ckpt.restore(
        root, like, device=DEV, ctx=ctx, specs=specs))
    same = all(torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(back.master) + adamw.tree_leaves(back.m)
        + adamw.tree_leaves(back.v) + [back.step],
        adamw.tree_leaves(state.master) + adamw.tree_leaves(state.m)
        + adamw.tree_leaves(state.v) + [state.step]))
    del back, state
    torch.cuda.empty_cache()
    # and onto ('data' 4, 'model' 1): each rank's blocks of the same file
    mesh41 = make_mesh((4, 1), ("data", "model"), DEV)
    ctx41 = rules.make_context(mesh41, attn_impl="flash")
    specs41 = specs_lib.state_shardings(cfg, run, ctx41)
    restored, _ = ckpt.restore(root, like, device=DEV, ctx=ctx41,
                               specs=specs41)
    step41 = make_train_step(cfg, run, ctx41, compute_dtype=torch.float32)
    _reset_lm_launches()
    (restored, m), t = _synced_ms(lambda: step41(restored,
                                                 batches[MESH_TRAIN_STEPS]))
    metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
    ms.append(t)
    launches += _launch_counts()["flash_attention"]
    out["train"] = dict(metrics=metrics, step_ms=ms, save_ms=save_ms,
                        restore_ms=restore_ms, restored_bitwise=same,
                        flash_launches=launches)
    del restored
    torch.cuda.empty_cache()
    return mesh41


def _mesh_psum(rank, mesh41, out):
    """(d) compressed_psum over the 4 ranks of ('data' 4, 'model' 1) on
    MESH_PSUM_N float32 values, bit for bit with its plain version."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compression import compressed_psum

    x = torch.randn(MESH_PSUM_N, device=DEV,
                    generator=torch.Generator(DEV).manual_seed(100 + rank))
    compressed_psum(x[:1024], mesh41, "data")  # warm up
    got, ms = _synced_ms(lambda: compressed_psum(x, mesh41, "data"))
    every = coll.all_gather(x[None], mesh41, "data", dim=0)
    smax = torch.clamp(every.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(every / smax), -127, 127).to(torch.int8)
    plain = q.float().sum(0) * smax
    out["psum"] = dict(bitwise=torch.equal(got, plain), ms=ms,
                       n=MESH_PSUM_N,
                       wire_bytes=(MESH_RANKS - 1) * MESH_PSUM_N,
                       f32_ring_bytes=(MESH_RANKS - 1) * MESH_PSUM_N * 4,
                       max_abs_err_vs_f32=float(
                           (got - every.sum(0)).abs().max()))


def mesh_job(rank, tensors, ckpt_dir):
    """One rank of phase 13 (``local_world.run``): (a)-(d) on this rank;
    returns its numbers, rank 0 also its logits."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh

    coll.reset_staged()
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), DEV)
    out = dict(rank=rank)
    t0 = time.perf_counter()
    _mesh_serve(rank, mesh, tensors, out)
    out["serve_s"] = time.perf_counter() - t0
    mesh41 = _mesh_train(rank, mesh, tensors, out, ckpt_dir)
    _mesh_psum(rank, mesh41, out)
    out["staged_bytes"] = coll.STAGED_BYTES["bytes"]
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_mesh(card):
    """Phase 13: (a) prefill, (b) decode in both moe modes, (c) training
    with the save and the restore onto (4, 1), (d) compressed_psum on a
    4-rank mesh of one card, against the single card."""
    from repro_torch.launch import local_world

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    prompts = torch.as_tensor(LMDataPipeline(cfg.vocab, MESH_S, MESH_B,
                                             seed=0).next_batch()["tokens"],
                              device=DEV).long()
    ref = {}
    ref["bf16"], forced = mesh_serve_reference(cfg, {"tokens": prompts},
                                               MESH_S, MESH_STEPS)
    data = LMDataPipeline(cfg.vocab, MESH_TRAIN_S, MESH_TRAIN_BATCH, seed=2,
                          microbatches=MESH_TRAIN_MB)
    batches = [data.next_batch() for _ in range(MESH_TRAIN_STEPS + 1)]
    t_world = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        world = local_world.start(
            "chip_smoke:mesh_job", MESH_RANKS, dict(ckpt_dir=tmp),
            tensors=dict(prompts=prompts.cpu(), forced=forced,
                         batches=batches),
            path=ROOT, deadline=MESH_DEADLINE)
        # the float32 and training references while the ranks run
        try:
            ref["f32"], _ = mesh_serve_reference(cfg, {"tokens": prompts},
                                                 MESH_S, MESH_STEPS, forced)
            train_ref = mesh_train_reference(batches)
        finally:
            ref_s = time.perf_counter() - t0
            ranks = world.wait()
    world_s = time.perf_counter() - t_world
    r0 = ranks[0]
    # (a), (b): the limit of phase 11 against the single card's float32
    errs, over = {}, []
    hold_steps("prefill", [r0["prefill_logits"]], ref["bf16"][:1],
               ref["f32"][:1], errs, over)
    for mode in ("gather", "tp2d"):
        hold_steps(f"decode {mode}", r0[f"decode_{mode}"]["logits"],
                   ref["bf16"][1:], ref["f32"][1:], errs, over)
    n_layers, bad = cfg.n_layers, []
    for r in ranks:
        want = {"flash_attention": n_layers, "flash_decode": 0}
        if {k: r["prefill_launches"][k] for k in want} != want:
            bad.append(("prefill launches", r["rank"], r["prefill_launches"]))
        for mode in ("gather", "tp2d"):
            got = r[f"decode_{mode}"]["launches"]
            if (got["flash_decode"], got["flash_attention"]) != (
                    n_layers * MESH_STEPS, 0):
                bad.append((f"decode {mode} launches", r["rank"], got))
        for flag in ("restored_bitwise",):
            if not r["train"][flag]:
                bad.append((flag, r["rank"]))
        if not r["psum"]["bitwise"]:
            bad.append(("compressed_psum not bit for bit", r["rank"]))
        # every rank reports the same global training metrics
        if r["train"]["metrics"] != r0["train"]["metrics"]:
            bad.append(("train metrics differ between ranks", r["rank"]))
    # (c): loss and grad norm within MESH_TRAIN_TOL of the single card
    train_rel = [{k: abs(got[k] - want[k]) / abs(want[k])
                  for k in ("loss", "grad_norm")}
                 for got, want in zip(r0["train"]["metrics"], train_ref)]
    bad += [("train", i, rel) for i, rel in enumerate(train_rel)
            if max(rel.values()) > MESH_TRAIN_TOL]
    staged = [r["staged_bytes"] for r in ranks]
    prefill_ms = [r["prefill_ms"] for r in ranks]
    decode_ms = {mode: [float(np.mean(r[f"decode_{mode}"]["step_ms"][1:]))
                        for r in ranks] for mode in ("gather", "tp2d")}
    train_ms = [r["train"]["step_ms"] for r in ranks]
    print(f"[mesh] {MOE_ARCH} on ('data' 2, 'model' 2), B={MESH_B} "
          f"S={MESH_S}, bf16, cache block {r0['cache_block']} a rank: "
          f"prefill logits max|d| / max|f32| {errs['prefill']['vs_f32']:.4g}"
          f" (one card {errs['prefill']['one_card_vs_f32']:.4g}; held: <= "
          f"max(2^-8, {ROUTE_SLACK} x one card)); {MESH_STEPS} decode "
          f"steps, worst step vs f32: gather "
          f"{errs['decode gather']['vs_f32']:.4g}, tp2d "
          f"{errs['decode tp2d']['vs_f32']:.4g} (one card "
          f"{errs['decode gather']['one_card_vs_f32']:.4g}); launches a "
          f"rank: flash_attention {n_layers} a prefill, flash_decode "
          f"{n_layers * MESH_STEPS} a mode | {card}")
    print(f"[mesh] rank 0's flash_decode_partial on its block "
          f"({r0['partial_check']['shape']}): out max|d| vs plain "
          f"{r0['partial_check']['max_abs_err']:.3g} (1e-5 + 1e-4|x|)")
    print(f"[mesh] training {MESH_TRAIN_LAYERS} of {n_layers} layers, "
          f"float32, S={MESH_TRAIN_S}, batch {MESH_TRAIN_BATCH} in "
          f"{MESH_TRAIN_MB}: loss / grad norm mesh "
          + ", ".join(f"{m['loss']:.6f} / {m['grad_norm']:.6f}"
                      for m in r0["train"]["metrics"])
          + " against one card " + ", ".join(
              f"{m['loss']:.6f} / {m['grad_norm']:.6f}" for m in train_ref)
          + f" (step {MESH_TRAIN_STEPS + 1} on ('data' 4, 'model' 1) after "
          f"the restore; saved and restored onto (2, 2) bit for bit: "
          f"{r0['train']['restored_bitwise']}; "
          f"held within {MESH_TRAIN_TOL} relative); save "
          f"{r0['train']['save_ms']:.0f} ms, restore "
          f"{r0['train']['restore_ms']:.0f} ms | {card}")
    ps = r0["psum"]
    print(f"[mesh] compressed_psum over 4 ranks, {ps['n']} float32: bit for "
          f"bit with its plain version on every rank; int8 wire "
          f"{ps['wire_bytes']} B a rank against {ps['f32_ring_bytes']} B "
          f"for a float32 ring; max|d| vs the float32 sum "
          f"{ps['max_abs_err_vs_f32']:.4g}; {ps['ms']:.1f} ms")
    print(f"[mesh] {MESH_TIMING} | {card}: prefill ms a rank "
          f"{[round(x, 1) for x in prefill_ms]}; decode ms a step (mean of "
          f"steps 2-{MESH_STEPS}) gather "
          f"{[round(x, 2) for x in decode_ms['gather']]}, tp2d "
          f"{[round(x, 2) for x in decode_ms['tp2d']]}; train ms a step "
          f"{[[round(x, 1) for x in t] for t in train_ms]}; staged bytes a "
          f"rank {staged}; the one-card references {ref_s:.1f} s, the world "
          f"{world_s:.1f} s (the ranks' work "
          f"{max(r['seconds'] for r in ranks):.1f} s, of it serving "
          f"{max(r['serve_s'] for r in ranks):.1f} s)")
    print(f"[mesh] training's relative distance from the one card a step: "
          f"{train_rel}")
    assert not over and not bad, (
        "phase 13", "logits past max(2^-8, 2 x the one card's)", over, bad)
    return dict(errs=errs, prefill_ms=prefill_ms, decode_ms=decode_ms,
                train_ms=train_ms, train=r0["train"]["metrics"],
                train_ref=train_ref, staged_bytes=staged, psum=ps,
                partial_check=r0["partial_check"],
                cache_block=list(r0["cache_block"]),
                launches=dict(
                    flash_attention=sum(
                        r["prefill_launches"]["flash_attention"]
                        + r["train"]["flash_launches"] for r in ranks),
                    flash_decode=sum(
                        r[f"decode_{m}"]["launches"]["flash_decode"]
                        for r in ranks for m in ("gather", "tp2d"))),
                timing=MESH_TIMING, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Phase 13b: the SSM mixer and the frontends on the mesh. mamba2-130m served
# (phase 8's arch, S cut) and trained, internvl2-2b served and hubert-xlarge
# encoded (phase 11's shapes) on phase 13's ('data' 2, 'model' 2) mesh of 4
# ranks on the one H100 over ``gloo``, each held to the single card's same
# call on the same seeded weights. Serving's weights are not FSDP-split
# (phase 13's rule), training's are.
# ---------------------------------------------------------------------------

# S cut from phase 8's 32,768: each layer's float32 partial sum crosses
# gloo at 0.26-0.62 GB/s (PERF.md §6); the decode steps (mamba2's and
# internvl2's) and the training's S cut to 16 and 1,024 for the script's
# time limit
MF_SSM_B, MF_SSM_S, MF_STEPS = MAMBA_B, 8192, 16
MF_TRAIN_S, MF_TRAIN_BATCH, MF_TRAIN_STEPS = 1024, 8, 2
MF_DEADLINE = 300.0


def _mf_inputs():
    """The prompts of (a), (c), (d) on the card and (b)'s batches."""
    gen = torch.Generator(DEV).manual_seed(5)
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    mamba = get_config(MAMBA_ARCH)
    data = LMDataPipeline(mamba.vocab, MF_TRAIN_S, MF_TRAIN_BATCH, seed=2,
                          microbatches=MESH_TRAIN_MB)
    return dict(
        mamba={"tokens": torch.as_tensor(LMDataPipeline(
            mamba.vocab, MF_SSM_S, MF_SSM_B, seed=0).next_batch()["tokens"],
            device=DEV).long()},
        vlm={"embeds": torch.randn(
                (VLM_B, vlm.frontend_positions, vlm.d_model), generator=gen,
                device=DEV).bfloat16(),
             "tokens": torch.as_tensor(LMDataPipeline(
                 vlm.vocab, VLM_TEXT, VLM_B, seed=1).next_batch()["tokens"],
                 device=DEV).long()},
        audio={"embeds": torch.randn((AUDIO_B, AUDIO_S, audio.d_model),
                                     generator=gen, device=DEV).bfloat16()},
        batches=[data.next_batch() for _ in range(MF_TRAIN_STEPS)])


def _mf_serve(mesh, arch, batch, forced, spy=None):
    """One rank's prefill of ``batch`` and the decode steps fed ``forced``
    on the mesh (bf16, flash): each step's logits (every rank holds the
    global ones), ms a step and the launches of the prefill and of the
    decode steps, the counters reset just before each and read just
    after. ``spy`` wraps ssd_scan in the prefill (it launches nothing of
    its own)."""
    import torch.distributed as dist

    from repro_torch.launch import specs as specs_lib
    from repro_torch.sharding import rules

    cfg = get_config(arch)
    ctx = rules.make_context(mesh, fsdp=MESH_SERVE_FSDP, attn_impl="flash")
    params = rules.shard_tree(
        init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                    torch.bfloat16), specs_lib.param_shardings(cfg, ctx),
        ctx)
    torch.cuda.empty_cache()
    prefill, decode = make_prefill_step(cfg, ctx), make_decode_step(cfg, ctx)
    prefill(params, {k: v[:, :64] for k, v in batch.items()})  # warm up
    S = sum(v.shape[1] for v in batch.values())
    _reset_lm_launches()
    dist.barrier()
    with (mock.patch.object(ssm_lib.ops, "ssd_scan", spy) if spy
          else contextlib.nullcontext()):
        (logits, caches), prefill_ms = _synced_ms(
            lambda: prefill(params, batch))
    out = dict(prefill_ms=prefill_ms, prefill_launches=_launch_counts(),
               logits=[logits.float().cpu()], step_ms=[],
               cache_block=[list(t.shape) for t in caches["layer0"]])
    forced = forced.to(DEV)
    _reset_lm_launches()
    for i in range(forced.shape[1]):
        (logits, caches), t = _synced_ms(lambda: decode(
            params, {"token": forced[:, i:i + 1], "cache_pos": S + i},
            caches))
        out["logits"].append(logits.float().cpu())
        out["step_ms"].append(t)
    out["decode_launches"] = _launch_counts()
    del params, caches
    torch.cuda.empty_cache()
    return out


def _mf_ssd_check(args, kw):
    """Rank 0's ssd_scan on layer 0's prefill inputs (its block of rows and
    its 12 of 24 heads) against the plain versions, phase 8's rule: y
    within one bf16 ulp of the hi/lo plain version and of the float32 one,
    the state within 1e-4 of its scale."""
    cfg = get_config(MAMBA_ARCH)
    _, H, P = ssm_lib.ssm_dims(cfg.ssm, cfg.d_model)
    x, dt, Bm, Cm, A = args[:5]
    assert x.shape == (MF_SSM_B // MESH_SHAPE[0], MF_SSM_S,
                       H // MESH_SHAPE[1], P), x.shape
    Q = min(cfg.ssm.chunk, MF_SSM_S)
    y, st = ssd_ops.ssd_scan(*args, **kw)
    y_p, st_p = ssd_ref.ssd_scan_hilo_plain(x, dt, Bm, Cm, A, Q)
    y_f, st_f = ssd_ref.ssd_scan_plain(x, dt, Bm, Cm, A, Q)
    out = dict(shape=list(x.shape), ulps=bf16_ulp_excess(y, y_p),
               state_rel_err=_rel(st, st_p),
               ulps_vs_f32_plain=bf16_ulp_excess(y, y_f),
               state_rel_err_vs_f32_plain=_rel(st, st_f),
               max_abs_err=max_diff(y, y_p))
    assert (out["ulps"] <= 1.0 and out["state_rel_err"] <= 1e-4
            and out["ulps_vs_f32_plain"] <= 1.0
            and out["state_rel_err_vs_f32_plain"] <= 1e-4), out
    return out


def _mf_train(mesh, batches):
    """(b) MF_TRAIN_STEPS float32 steps of mamba2-130m on the mesh, FSDP
    on: each step's metrics and ms, and its ssd_scan launches (0: training
    runs ``ssd_chunked``)."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules

    cfg, run = get_config(MAMBA_ARCH), _mesh_run()
    ctx = rules.make_context(mesh)
    state = rules.shard_tree(adamw.init_train_state(init_params(
        cfg, torch.Generator(DEV).manual_seed(1), DEV, torch.float32)),
        specs_lib.state_shardings(cfg, run, ctx), ctx)
    torch.cuda.empty_cache()
    step = make_train_step(cfg, run, ctx, compute_dtype=torch.float32)
    metrics, ms = [], []
    _reset_lm_launches()
    for b in batches:
        (state, m), t = _synced_ms(lambda: step(state, b))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        ms.append(t)
    out = dict(metrics=metrics, step_ms=ms, launches=_launch_counts())
    del state
    torch.cuda.empty_cache()
    return out


def _mf_encode(mesh, batch):
    """(d) hubert-xlarge's encode step on the mesh: every position's
    logits, its ms and launches."""
    import torch.distributed as dist

    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.steps import make_encode_step
    from repro_torch.sharding import rules

    cfg = get_config(AUDIO_ARCH)
    ctx = rules.make_context(mesh, fsdp=MESH_SERVE_FSDP, attn_impl="flash")
    params = rules.shard_tree(
        init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                    torch.bfloat16), specs_lib.param_shardings(cfg, ctx),
        ctx)
    encode = make_encode_step(cfg, ctx)
    encode(params, {"embeds": batch["embeds"][:, :100]})  # warm up
    _reset_lm_launches()
    dist.barrier()
    logits, ms = _synced_ms(lambda: encode(params, batch))
    out = dict(ms=ms, launches=_launch_counts(), logits=logits.float().cpu())
    del params
    torch.cuda.empty_cache()
    return out


def mesh_front_job(rank, tensors):
    """One rank of phase 13b (``local_world.run``): (a)-(d) on this rank;
    returns its numbers, rank 0 also its logits and its ssd_scan check."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_mesh

    coll.reset_staged()
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), DEV)
    out, captured = dict(rank=rank), []
    real = ssm_lib.ops.ssd_scan

    def spy(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return real(*args, **kw)

    t0 = time.perf_counter()
    inp = {k: _tree_map(lambda t: t.to(DEV), v) if isinstance(v, dict)
           else v for k, v in tensors.items()}
    out["mamba"] = _mf_serve(mesh, MAMBA_ARCH, inp["mamba"],
                             tensors["forced_mamba"], spy)
    if rank == 0:
        out["ssd_check"] = _mf_ssd_check(*captured[0])
    del captured[:]
    out["train"] = _mf_train(mesh, tensors["batches"])
    out["vlm"] = _mf_serve(mesh, VLM_ARCH, inp["vlm"], tensors["forced_vlm"])
    out["audio"] = _mf_encode(mesh, inp["audio"])
    if rank:  # every rank holds the global logits: rank 0's are kept
        for k in ("mamba", "vlm", "audio"):
            out[k].pop("logits")
    out["staged_bytes"] = coll.STAGED_BYTES["bytes"]
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_front_train_reference(batches):
    """(b) on the single card: the same steps from the same weights."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = get_config(MAMBA_ARCH)
    state = adamw.init_train_state(init_params(
        cfg, torch.Generator(DEV).manual_seed(1), DEV, torch.float32))
    step = make_train_step(cfg, _mesh_run(), ShardingContext(),
                           compute_dtype=torch.float32)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    del state
    torch.cuda.empty_cache()
    return out


def mesh_front_encode_reference(batch):
    """(d) on the single card: the bf16 and float32 encodes."""
    from repro_torch.launch.steps import make_encode_step

    cfg = get_config(AUDIO_ARCH)
    params = init_params(cfg, torch.Generator(DEV).manual_seed(0), DEV,
                         torch.bfloat16)
    encode = make_encode_step(cfg, ShardingContext(attn_impl="flash"))
    bf16 = encode(params, batch).float().cpu()
    params = _tree_map(lambda t: t.float(), params)
    f32 = encode(params, {"embeds": batch["embeds"].float()}).float().cpu()
    del params
    torch.cuda.empty_cache()
    return bf16, f32


def phase_mesh_front(card):
    """Phase 13b: (a) mamba2-130m served, (b) trained, (c) internvl2-2b
    served, (d) hubert-xlarge encoded on a 4-rank mesh of one card, against
    the single card."""
    from repro_torch.launch import local_world

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = _mf_inputs()
    cfgs = {k: get_config(a) for k, a in (("mamba", MAMBA_ARCH),
                                          ("vlm", VLM_ARCH))}
    steps = {"mamba": MF_STEPS, "vlm": MF_STEPS}
    S = {k: sum(v.shape[1] for v in inp[k].values()) for k in steps}
    ref, forced = {}, {}
    for k in steps:
        ref[k + "/bf16"], forced[k] = mesh_serve_reference(
            cfgs[k], inp[k], S[k], steps[k])
    host = {k: _tree_map(lambda t: t.cpu(), inp[k])
            for k in ("mamba", "vlm", "audio")}
    t_world = time.perf_counter()
    world = local_world.start(
        "chip_smoke:mesh_front_job", MESH_RANKS, {},
        tensors=dict(host, batches=inp["batches"],
                     forced_mamba=forced["mamba"], forced_vlm=forced["vlm"]),
        path=ROOT, deadline=MF_DEADLINE)
    # the single card's float32 runs and the training while the ranks run
    try:
        for k in steps:
            ref[k + "/f32"], _ = mesh_serve_reference(
                cfgs[k], inp[k], S[k], steps[k], forced[k])
        train_ref = mesh_front_train_reference(inp["batches"])
        ref["audio/bf16"], ref["audio/f32"] = mesh_front_encode_reference(
            inp["audio"])
    finally:
        ref_s = time.perf_counter() - t0
        ranks = world.wait()
    world_s = time.perf_counter() - t_world
    r0 = ranks[0]
    errs, over, bad = {}, [], []
    for k, name in (("mamba", MAMBA_ARCH), ("vlm", VLM_ARCH)):
        got = r0[k]["logits"]
        hold_steps(f"{name} prefill", got[:1], ref[k + "/bf16"][:1],
                   ref[k + "/f32"][:1], errs, over)
        hold_steps(f"{name} decode", got[1:], ref[k + "/bf16"][1:],
                   ref[k + "/f32"][1:], errs, over)
    hold_steps(f"{AUDIO_ARCH} encode", [r0["audio"]["logits"]],
               [ref["audio/bf16"]], [ref["audio/f32"]], errs, over)
    # the launches of every rank: ssd_scan a layer in mamba2's prefill and
    # none in its decode steps or training; flash_attention a layer in
    # internvl2's prefill and hubert's encode, flash_decode a layer a step
    m_layers, v_layers = cfgs["mamba"].n_layers, cfgs["vlm"].n_layers
    a_layers = get_config(AUDIO_ARCH).n_layers
    for r in ranks:
        want = {("mamba", "prefill_launches"): (m_layers, 0, 0),
                ("mamba", "decode_launches"): (0, 0, 0),
                ("train", "launches"): (0, 0, 0),
                ("vlm", "prefill_launches"): (0, v_layers, 0),
                ("vlm", "decode_launches"): (0, 0, v_layers * MF_STEPS),
                ("audio", "launches"): (0, a_layers, 0)}
        for (k, f), w in want.items():
            got = r[k][f]
            if (got["ssd_scan"], got["flash_attention"],
                    got["flash_decode"]) != w:
                bad.append((k, f, r["rank"], got))
        if r["train"]["metrics"] != r0["train"]["metrics"]:
            bad.append(("train metrics differ between ranks", r["rank"]))
    train_rel = [{k: abs(got[k] - want[k]) / abs(want[k])
                  for k in ("loss", "grad_norm")}
                 for got, want in zip(r0["train"]["metrics"], train_ref)]
    bad += [("train", i, rel) for i, rel in enumerate(train_rel)
            if max(rel.values()) > MESH_TRAIN_TOL]
    n_checked = sum(e["steps"] for e in errs.values()) + len(train_rel)
    sc = r0["ssd_check"]
    print(f"[mesh] rank 0's ssd_scan on layer 0's prefill block "
          f"{sc['shape']} bf16: y vs the hi/lo plain {sc['ulps']:.3g} bf16 "
          f"ulp, state {sc['state_rel_err']:.3g} of its scale (float32 "
          f"plain: {sc['ulps_vs_f32_plain']:.3g} ulp, "
          f"{sc['state_rel_err_vs_f32_plain']:.3g}; held: 1 ulp, 1e-4)")
    print(f"[mesh] {MAMBA_ARCH} trained on ('data' 2, 'model' 2), float32, "
          f"S={MF_TRAIN_S}, batch {MF_TRAIN_BATCH} in {MESH_TRAIN_MB}: loss "
          "/ grad norm mesh " + ", ".join(
              f"{m['loss']:.6f} / {m['grad_norm']:.6f}"
              for m in r0["train"]["metrics"]) + " against one card "
          + ", ".join(f"{m['loss']:.6f} / {m['grad_norm']:.6f}"
                      for m in train_ref)
          + f"; relative distance {train_rel} (held within "
          f"{MESH_TRAIN_TOL}) | {card}")
    print(f"[mesh] phase 13b on ('data' 2, 'model' 2): {MAMBA_ARCH} B="
          f"{MF_SSM_B} S={MF_SSM_S} (state block "
          f"{r0['mamba']['cache_block'][0]} a rank), {VLM_ARCH} B={VLM_B} "
          f"S={S['vlm']}, {AUDIO_ARCH} B={AUDIO_B} S={AUDIO_S}; "
          f"{n_checked} steps checked, every one within its limit: "
          f"{not over and not bad}; launches a rank: ssd_scan {m_layers} a "
          f"prefill, flash_attention {v_layers} / {a_layers}, flash_decode "
          f"{v_layers * MF_STEPS} | {card}")

    def per_rank(k, f):
        return [r[k][f] for r in ranks]

    print(f"[mesh] {MESH_TIMING} | {card}: {MAMBA_ARCH} prefill ms a rank "
          f"{[round(x, 1) for x in per_rank('mamba', 'prefill_ms')]}, "
          f"decode ms a step (mean of steps 2-{MF_STEPS}) "
          f"{[round(float(np.mean(r['mamba']['step_ms'][1:])), 2) for r in ranks]}"
          f", train ms a step "
          f"{[[round(x, 1) for x in r['train']['step_ms']] for r in ranks]}; "
          f"{VLM_ARCH} prefill "
          f"{[round(x, 1) for x in per_rank('vlm', 'prefill_ms')]}, decode "
          f"{[round(float(np.mean(r['vlm']['step_ms'][1:])), 2) for r in ranks]}"
          f"; {AUDIO_ARCH} encode "
          f"{[round(x, 1) for x in per_rank('audio', 'ms')]}; staged bytes a "
          f"rank {[r['staged_bytes'] for r in ranks]}; the one-card "
          f"references {ref_s:.1f} s, the world {world_s:.1f} s (the ranks' "
          f"work {max(r['seconds'] for r in ranks):.1f} s)")
    assert not over and not bad, (
        "phase 13b", "logits past max(2^-8, 2 x the one card's)", over, bad)
    launches = {k: sum(r[p][f][k] for r in ranks for p, f in (
        ("mamba", "prefill_launches"), ("mamba", "decode_launches"),
        ("train", "launches"), ("vlm", "prefill_launches"),
        ("vlm", "decode_launches"), ("audio", "launches")))
        for k in ("ssd_scan", "flash_attention", "flash_decode")}
    return dict(
        errs=errs, train=r0["train"]["metrics"], train_ref=train_ref,
        train_rel=train_rel, steps_checked=n_checked, ssd_check=sc,
        prefill_ms={k: per_rank(k, "prefill_ms") for k in ("mamba", "vlm")},
        decode_ms={k: [float(np.mean(r[k]["step_ms"][1:])) for r in ranks]
                   for k in ("mamba", "vlm")},
        train_ms=[r["train"]["step_ms"] for r in ranks],
        encode_ms=per_rank("audio", "ms"),
        staged_bytes=[r["staged_bytes"] for r in ranks],
        cache_block=r0["mamba"]["cache_block"], launches=launches,
        timing=MESH_TIMING, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Phase 14, the tile table (kernels/katana_bank/autotune.py, tune.py): the
# launch shapes of scan.cu, imm_step.cu and imm_scan.cu bit for bit at
# every tile and chunk, a race at the replay size, and the checked-in
# table's rows driving this card's launches.
# ---------------------------------------------------------------------------

TUNE_NS = (1000, None)  # (a)'s bank sizes: None is N_REPLAY
TUNE_T = 17             # (a)'s frames of the tile sweep
TUNE_KINDS = {"katana_bank_sequence": "lkf", "katana_imm_sequence": "imm",
              "katana_bank": "lkf", "katana_bank_imm": "imm"}


def _one_asymmetric(P0, seed=47):
    """P0 with its middle track's P symmetric only to rounding, among
    tracks symmetric to the bit (first_frame marks a whole block)."""
    P0 = P0.clone()
    c = P0.shape[0] // 2
    rng = np.random.default_rng(seed)
    P0[c] += torch.as_tensor(1e-3 * rng.standard_normal(
        tuple(P0[c].shape), dtype=np.float32), device=P0.device)
    return P0.contiguous()


def _same(got, want, what):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), what


def tile_sweep(N):
    """(a) at bank size N: every tile of scan.cu (lkf, ekf, cv9; both
    symmetrize values; with and without a valid stream, through the
    K = 1 IMM replay; one track's seed P asymmetric), imm_step.cu (K = 1
    both layouts, K = 4; both symmetrize values, an asymmetric P) and
    imm_scan.cu (with and without a valid stream) over TUNE_T frames bit
    for bit with the plain version; then every (tile, chunk) the tuner
    races over T_REPLAY frames bit for bit with one launch at the static
    tile (lkf, ekf, imm). Returns the count of cases."""
    cases = 0
    scan_tiles = ops.LANE_TILES["katana_bank_sequence"]
    for kind in ("lkf", "ekf", "cv9"):
        model = filters.get_filter(kind)
        src = "imm" if kind == "cv9" else kind
        zs, x0, P0 = dev_(*replay_stream(src, N, TUNE_T))
        P0 = _one_asymmetric(P0)
        valid = torch.as_tensor(np.random.default_rng(N).random(
            (TUNE_T, N)) >= DROP, device=DEV)
        a1 = filters.as_imm(model)
        for sym in (True, False):
            want = ref.katana_bank_scan_plain(model, x0, P0, zs,
                                              symmetrize=sym)
            inputs = ops.imm_sequence_inputs(a1, zs, x0, P0, None, valid)
            want_v = ref.katana_bank_scan_plain(model, x0, P0, inputs[3],
                                                inputs[4], symmetrize=sym)
            for tile in scan_tiles:
                got = ops.katana_bank_sequence(model, zs, x0, P0,
                                               return_final=True,
                                               symmetrize=sym, lane_tile=tile)
                _same((got[0],) + got[1], want, (kind, sym, tile))
                got = ops.katana_imm_sequence(a1, zs, x0, P0, valid=valid,
                                              return_final=True,
                                              symmetrize=sym, lane_tile=tile)
                _same((got[0], got[1][0][0], got[1][1][0]), want_v,
                      (kind, sym, tile, "valid"))
                cases += 2
            z0 = zs[0]
            want = ref.katana_bank_step_plain(model, x0, P0, z0, sym)
            layout = (x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
                      z0.T.contiguous())
            for tile in ops.LANE_TILES["katana_bank"]:
                _same(ops.katana_bank(model, x0, P0, z0, symmetrize=sym,
                                      lane_tile=tile), want,
                      (kind, sym, tile, "step"))
                soa = ops.katana_bank_soa(model, *layout, symmetrize=sym,
                                          lane_tile=tile)
                _same((soa[0].T, soa[1].permute(2, 0, 1)), want,
                      (kind, sym, tile, "soa"))
                cases += 2
    imm = replay_model("imm")
    zs_np, x0_np, P0_np = replay_stream("imm", N, TUNE_T)
    rng = np.random.default_rng(N + 1)
    vmask = rng.random((TUNE_T, N)) >= DROP
    zs, x0, P0, valid = dev_(zs_np, x0_np, P0_np, vmask)
    mu0 = torch.as_tensor(rng.dirichlet(np.ones(imm.K), size=N),
                          dtype=torch.float32, device=DEV)
    for vs in (None, valid):
        want = ref.katana_bank_imm_scan_plain(
            imm, *ops.imm_sequence_inputs(imm, zs, x0, P0, mu0, vs))
        for tile in ops.LANE_TILES["katana_imm_sequence"]:
            got = ops.katana_imm_sequence(imm, zs, x0, P0, mu0, vs,
                                          return_final=True, lane_tile=tile)
            _same((got[0],) + got[1], want, ("imm scan", vs is None, tile))
            cases += 1
    K, n = imm.K, imm.n
    xK = (x0[None] + torch.as_tensor(0.05 * rng.standard_normal(
        (K, N, n), dtype=np.float32), device=DEV)).contiguous()
    PK = (P0[None].expand(K, N, n, n) + torch.as_tensor(
        1e-3 * rng.standard_normal((K, N, n, n), dtype=np.float32),
        device=DEV)).contiguous()
    for sym in (True, False):
        want = ref.katana_bank_imm_step_plain(imm, xK, PK, zs[0], sym)
        for tile in ops.LANE_TILES["katana_bank_imm"]:
            _same(ops.katana_bank_imm(imm, xK, PK, zs[0], symmetrize=sym,
                                      lane_tile=tile), want,
                  ("imm step", sym, tile))
            cases += 1
    # every raced (tile, chunk) against one launch at the static tile
    for kind in ("lkf", "ekf", "imm"):
        model = replay_model(kind)
        name = "katana_imm_sequence" if kind == "imm" else (
            "katana_bank_sequence")
        seq = getattr(ops, name)
        zs, x0, P0 = dev_(*replay_stream(kind, N, T_REPLAY))
        one = seq(model, zs, x0, P0, return_final=True,
                  time_chunk=T_REPLAY,
                  lane_tile=tune.static_config(name)["lane_tile"])
        for cfg in tune.candidates(name):
            _same((lambda r: (r[0],) + r[1])(seq(model, zs, x0, P0,
                                                 return_final=True, **cfg)),
                  (one[0],) + one[1], (kind, cfg))
            cases += 1
    torch.cuda.synchronize()
    return cases


def tabled_vs_static(name):
    """(tabled ms, static ms, the tabled config) of wrapper ``name`` at the
    replay size (T_REPLAY frames for the scans, one frame for the steps),
    CUDA events with the device queued, in turns tabled, static, static,
    tabled; the tabled call at lane_tile=0 / time_chunk=0."""
    model = replay_model(TUNE_KINDS[name])
    zs, x0, P0 = dev_(*replay_stream(TUNE_KINDS[name]))
    static = dict(autotune.STATIC_DEFAULTS[name])
    if name == "katana_bank_imm":
        K, N, n = model.K, x0.shape[0], model.n
        xK = x0[None].expand(K, N, n).contiguous()
        PK = P0[None].expand(K, N, n, n).contiguous()
        call = (lambda **kw: ops.katana_bank_imm(model, xK, PK, zs[0],
                                                 **kw))
    elif name == "katana_bank":
        call = lambda **kw: ops.katana_bank(model, x0, P0, zs[0], **kw)
    else:
        call = lambda **kw: getattr(ops, name)(model, zs, x0, P0, **kw)
    call()
    cfg = dict(ops.LAST_CONFIG[name])
    iters = 50 if "time_chunk" not in static else 3
    times = {"tabled": [], "static": []}
    for which in ("tabled", "static", "static", "tabled"):
        kw = {} if which == "tabled" else static
        times[which].append(cuda_ms(lambda: call(**kw), iters, spin=True))
    return (float(np.mean(times["tabled"])), float(np.mean(times["static"])),
            cfg)


def phase_autotune(card):
    """Phase 14: (a) ``tile_sweep`` at N = 1,000 and N_REPLAY; (b)
    ``tune.tune`` at N_REPLAY, T_REPLAY frames, into a temporary table,
    every candidate's device ms and the winner against the static
    default's; (c) for each tuned kernel the checked-in table's row for
    this card's key at N_REPLAY and the configuration ``ops.LAST_CONFIG``
    shows the launch used (the static defaults where the card has no
    row), and the tabled and static configs' times of the four bank
    kernels. Returns {kernel: its row of numbers}."""
    t_phase = time.perf_counter()
    sweep = {}
    for N in TUNE_NS:
        N = N or N_REPLAY
        t0 = time.perf_counter()
        sweep[N] = tile_sweep(N)
        print(f"[autotune] (a) N={N}: {sweep[N]} cases bit for bit at every "
              f"tile (scan.cu {ops.LANE_TILES['katana_bank_sequence']}, "
              f"imm_step.cu {ops.LANE_TILES['katana_bank']}, imm_scan.cu "
              f"{ops.LANE_TILES['katana_imm_sequence']}) and chunk "
              f"{tune.TIME_CHUNKS} ({time.perf_counter() - t0:.1f} s)")
    report = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tuned.json"
        entries = tune.tune(Ns=(N_REPLAY,), T=T_REPLAY, rounds=5,
                            device=DEV, report=report)
        autotune.write_table(entries, path)
        raced = {k: autotune.best_config(k, N_REPLAY, DEV, path=path)
                 for k in tune.KERNELS}
    race_s = time.perf_counter() - t0
    key = autotune.device_key(DEV)
    out = {"key": key, "sweep_cases": sweep, "race_s": race_s}
    for kernel in tune.KERNELS:
        frames = 1 if kernel == "katana_bank" else T_REPLAY
        ms = {json.dumps(c, sort_keys=True): us * frames / 1e3
              for k, _, c, us in report
              if k == kernel and isinstance(us, float)}
        best = raced[kernel]
        static_ms = ms[json.dumps(tune.static_config(kernel),
                                  sort_keys=True)]
        print(f"[autotune] (b) {kernel} N={N_REPLAY}: device ms a call "
              + ", ".join(f"{c} {v:.4f}" for c, v in ms.items()))
        won = {k: best[k] for k in ("lane_tile", "time_chunk") if k in best}
        print(f"[autotune] (b) {kernel}: winner {won} "
              f"{best['us_per_frame'] * frames / 1e3:.4f} ms against the "
              f"static default's {static_ms:.4f} ms ({card})")
        out[kernel] = dict(race_ms=ms, race_best=best, race_static_ms=static_ms)
    t0 = time.perf_counter()
    for name in TUNE_KINDS:
        tabled_ms, static_ms, cfg = tabled_vs_static(name)
        N = cfg["N"]
        row = autotune.best_config(name, N, key)
        want = dict(autotune.STATIC_DEFAULTS[name])
        want.update({k: row[k] for k in ("lane_tile", "time_chunk")
                     if k in row})
        assert cfg["key"] == key and all(
            cfg[k] == v for k, v in want.items()), (name, cfg, row)
        print(f"[autotune] (c) {name} N={N}: "
              + (f"the table's row for {key} (N={row['N']}): {row}"
                 if row else f"no row for {key}: the static defaults")
              + f"; the launch used lane_tile {cfg['lane_tile']}"
              + (f", time_chunk {cfg['time_chunk']}"
                 if cfg["time_chunk"] else "")
              + f" (ops.LAST_CONFIG); {tabled_ms:.4f} ms tabled, "
              f"{static_ms:.4f} ms at the static defaults ({card})")
        out.setdefault(name, {}).update(
            lane_tile=cfg["lane_tile"], time_chunk=cfg["time_chunk"],
            tuned_ms=tabled_ms, static_ms=static_ms, table_row=row or None)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[autotune] phase 14: {out['seconds']:.1f} s ((b)'s race "
          f"{race_s:.1f} s, (c) {time.perf_counter() - t0:.1f} s)")
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree.values() for t in _leaves(v)]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}


def bwd_row(train, moe):
    """The backward kernel's row of the kernel table: danube's layer in
    bf16 as the row's numbers, float32 and granite-moe's layer beside
    them; the launches on the main path are phase 10 (c)'s."""
    grads = train["grads"]
    bf = grads["bfloat16"]
    return dict(
        ms=bf["kernel_ms"], plain_ms=bf["plain_ms"],
        library_ms=bf["sdpa_bwd_ms"], bound_ms=bf["bound_ms"],
        bound_by=bf["bound_by"], launches=train["danube"]["bwd_launches"],
        max_abs_err=bf["max_abs_err"],
        shape=f"B={GRAD_SHAPE[0]} S={GRAD_SHAPE[1]} H={GRAD_SHAPE[2]} "
              f"KH={GRAD_SHAPE[3]} d={GRAD_SHAPE[4]} window={GRAD_SHAPE[5]} "
              "bf16, causal; bound 10 d operations a visible pair at the "
              "bf16 tensor-core peak; library_ms SDPA's backward",
        torch_op_ms=bf["bwd_ms"], bound_share=bf["bound_share"],
        design=bf["design"], err64=bf["err64"],
        torch_op_err64=bf["ops_err64"],
        float32={k: grads["float32"][k] for k in (
            "kernel_ms", "plain_ms", "bwd_ms", "sdpa_bwd_ms", "bound_ms",
            "bound_by", "bound_share", "max_abs_err", "err64")},
        granite_moe=grads["granite-moe"],
        ragged_max_abs_err=grads["ragged_max_abs_err"],
        small_train_launches=sum(r["bwd_launches"]
                                 for r in train["small"].values()),
        moe_launches=moe["launches"]["flash_attention_bwd"],
        registers={name: dict(
            registers=ptxas_registers("flash_attention_bwd.cu", part),
            spill_stores=ptxas_spill("flash_attention_bwd.cu", part))
                   for name, part in (
                       (f"{ns}::flash_bwd_{k}<{dp}>",
                        f"{len(ns)}{ns}{len(k) + 10}flash_bwd_{k}ILi{dp}E")
                       for ns in ("wg", "tf32x3") for dp in (64, 80, 128)
                       for k in ("prep", "dkdv", "dq"))},
        step_ms={TRAIN_ARCH: train["danube"]["steady_ms"],
                 MOE_ARCH: moe["train"]["steady_ms"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = smi_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} sources "
          "(parallel nvcc)")
    for src, log in logs.items():
        print(f"  {src}: {log['seconds']:.1f} s")
        for ln in log["ptxas"]:
            print(f"    {ln}")

    seconds = {"build": time.perf_counter() - t0}
    mark = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        seconds[phase] = now - mark[0]
        mark[0] = now
        print(f"phase {phase}: {seconds[phase]:.1f} s")

    errs = phase_kernels_vs_plain()
    errs_r, plain_r = phase_replay_kernels_vs_plain()
    errs.update(errs_r)
    lap("2")

    rows, greedy, engines = {}, None, {}
    for kind in ("lkf", "ekf", "imm"):
        rows[kind], g, engines[kind] = phase_main_path(kind)
        greedy = greedy or g
    lap("3")
    fleet = {kind: phase_fleet(kind, rows[kind])
             for kind in ("lkf", "ekf", "imm")}
    lap("3b")
    replay = {kind: phase_replay(kind, plain_r)
              for kind in ("lkf", "ekf", "imm")}
    lane = imm_scan_lane()
    lap("4")
    per_frame = phase_per_frame(plain_r)
    lap("5")
    stages, ladder, full_sq = phase_stages()
    lap("5b")
    phase_resumed_bank(engines["imm"])
    lap("6")
    lm, lm_kern = phase_lm(get_config(LM_ARCH), LM_B, LM_S, LM_STEPS, card)
    lap("7")
    mamba, lm_kern["ssd_scan"] = phase_mamba(
        get_config(MAMBA_ARCH), MAMBA_B, MAMBA_S, MAMBA_STEPS, card)
    lap("8")
    stream = {kind: phase_stream(kind, fleet[kind])
              for kind in ("lkf", "imm")}
    lap("9")
    train = phase_train(card)
    lap("10")
    moe = phase_moe(card)
    SERVE_WORKER.close()  # phase 11's were the last serving profiles
    lap("11")
    jitted = phase_jitted(lm, mamba, train, moe, card)
    lap("12")
    mesh = phase_mesh(card)
    lap("13")
    mesh_front = phase_mesh_front(card)
    lap("13b")
    tuned = phase_autotune(card)
    lap("14")
    lm_kern["flash_attention"].update(
        train_launches=(sum(r["flash_launches"]
                            for r in train["small"].values())
                        + train["danube"]["launches"]))
    lm_kern["flash_attention_bwd"] = bwd_row(train, moe)
    # phase 11's own launches and its shapes (the MoE and frontend archs)
    lm_kern["flash_attention"].update(
        moe_launches=moe["launches"]["flash_attention"],
        moe_shapes=moe["attention_shapes"])
    lm_kern["flash_decode"].update(
        moe_launches=moe["launches"]["flash_decode"],
        moe_shapes=moe["decode_shapes"])
    lm_kern["ssd_scan"].update(moe_launches=moe["launches"]["ssd_scan"])
    # phase 13's own launches, summed over its 4 ranks
    lm_kern["flash_attention"].update(
        mesh_launches=mesh["launches"]["flash_attention"])
    lm_kern["flash_decode"].update(
        mesh_launches=mesh["launches"]["flash_decode"])
    # phase 13b's own launches, summed over its 4 ranks
    for name in ("ssd_scan", "flash_attention", "flash_decode"):
        lm_kern[name].update(
            mesh_front_launches=mesh_front["launches"][name])
    lm_kern["ssd_scan"].update(mesh_front_check=mesh_front["ssd_check"])
    errs.update({k: v.pop("max_abs_err") for k, v in lm_kern.items()})

    # the sensor fleet's own launches (phase 3b), apart from the main
    # path's: its frames, and its replays (katana_imm_sequence; at K = 1,
    # lkf and ekf, it launches scan.cu's bank_scan, row katana_bank_sequence)
    fleet_launches = {
        "katana_frame": fleet["lkf"]["launches"] + fleet["ekf"]["launches"],
        "katana_imm_frame": fleet["imm"]["launches"],
        "greedy_assign": sum(f["greedy_launches"] for f in fleet.values()),
        "katana_imm_sequence": fleet["imm"]["replay_launches"],
        "katana_bank_sequence": (fleet["lkf"]["replay_launches"]
                                 + fleet["ekf"]["replay_launches"])}

    def fleet_row(kind):
        f = fleet[kind]
        return {k: f[k] for k in (
            "sensors", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "launch_device_ms", "registers", "fleet_fps", "solo_fps",
            "fps_ratio")}

    # the streaming front end's own launches (phase 9): one frame launch
    # (and one greedy) a dispatch or a replayed WAL frame
    stream_launches = {
        "katana_frame": stream["lkf"]["launches"],
        "katana_imm_frame": stream["imm"]["launches"],
        "greedy_assign": stream["lkf"]["launches"]
        + stream["imm"]["launches"]}

    # the jitted trackers' own launches (phase 12 (a)): one frame launch
    # (and one greedy) a captured or replayed frame
    jit = jitted["jitted"]
    jitted_launches = {
        "katana_frame": sum(jit[k]["launches"]["katana_frame"]
                            for k in ("lkf", "ekf")),
        "katana_imm_frame": jit["imm"]["launches"]["katana_imm_frame"],
        "greedy_assign": sum(j["launches"]["greedy_assign"]
                             for j in jit.values())}

    def entry(name, ms, plain_ms, bms, by, launches, extra, library_ms=None):
        # the stage ladder's, the sensor fleet's, the stream's and the
        # jitted trackers' own launches of the kernel (phase_stages,
        # phase_fleet, phase_stream, phase_jitted), apart from the main
        # path's ``launches``; the bank kernels' launch shape from the
        # tile table, its time and the static shape's (phase 14)
        if name in TUNE_KINDS:
            extra = dict(extra, **{k: tuned[name][k] for k in (
                "lane_tile", "time_chunk", "tuned_ms", "static_ms")})
        if name in jitted_launches:
            extra = dict(extra, jitted_launches=jitted_launches[name])
        if name in ladder:
            extra = dict(extra, ladder_launches=ladder[name])
        if name in fleet_launches:
            extra = dict(extra, fleet_launches=fleet_launches[name])
        if name in stream_launches:
            extra = dict(extra, stream_launches=stream_launches[name])
        return dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches,
                    max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=library_ms,
                    card=card, **extra)

    lkf, ekf, imm = rows["lkf"], rows["ekf"], rows["imm"]
    kernels = [
        entry("katana_frame", lkf["kernel_ms"], lkf["plain_ms"],
              lkf["bound_ms"], lkf["bound_by"],
              lkf["launches"] + ekf["launches"],
              dict(shape=f"lkf C={C_SERVE} M={M_SERVE}; ms by events at "
                         "the host's pace, launch_device_ms by events with "
                         "the device queued",
                   launch_device_ms=lkf["launch_device_ms"],
                   registers=lkf["launch_registers"],
                   full_square={k: full_sq["frames"][k]
                                for k in ("lkf", "ekf")},
                   fleet={k: fleet_row(k) for k in ("lkf", "ekf")}, by_model={
                  k: {f: rows[k][f] for f in (
                      "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                      "launches", "launch_device_ms", "launch_registers")}
                  for k in ("lkf", "ekf")})),
        entry("katana_imm_frame", imm["kernel_ms"], imm["plain_ms"],
              imm["bound_ms"], imm["bound_by"], imm["launches"],
              dict(shape=f"imm K=4 C={C_SERVE} M={M_SERVE}; ms by events "
                         "at the host's pace, launch_device_ms by events "
                         "with the device queued",
                   launch_device_ms=imm["launch_device_ms"],
                   registers=imm["launch_registers"],
                   full_square=full_sq["frames"]["imm"],
                   fleet=fleet_row("imm"))),
        entry("greedy_assign", greedy["kernel_ms"], greedy["plain_ms"],
              greedy["bound_ms"], greedy["bound_by"],
              sum(r["greedy_launches"] for r in rows.values()),
              dict(shape=f"in the lkf frame, (M, C) cost tile C={C_SERVE} "
                         f"M={M_SERVE}, {greedy['waves']} waves; ms is "
                         "device time (CUDA events the kernel records "
                         "around its launches)",
                   profiler_ms=greedy["profiler_ms"],
                   standalone_ms=greedy["standalone_ms"],
                   fleet_device_ms={k: fleet[k]["launch_device_ms"]["greedy"]
                                    for k in fleet})),
        entry("katana_bank_sequence", replay["lkf"]["kernel_ms"],
              replay["lkf"]["plain_ms"], replay["lkf"]["bound_ms"],
              replay["lkf"]["bound_by"],
              replay["lkf"]["launches"] + replay["ekf"]["launches"],
              dict(shape=f"lkf N={N_REPLAY} T={T_REPLAY}; ms by events "
                         "with the device queued",
                   bound_share=replay["lkf"]["bound_share"], by_model={
                  k: {f: replay[k][f] for f in (
                      "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                      "bound_share", "launches", "replay_fps",
                      "instantiation", "registers", "waves")}
                  for k in ("lkf", "ekf")},
                   full_square={k: {f: v for f, v in full_sq[k][
                       "full_square"].items() if f.startswith("scan")}
                       for k in ("lkf", "ekf")})),
        entry("katana_imm_sequence", replay["imm"]["kernel_ms"],
              replay["imm"]["plain_ms"], replay["imm"]["bound_ms"],
              replay["imm"]["bound_by"], replay["imm"]["launches"],
              dict(shape=f"imm K=4 N={N_REPLAY} T={T_REPLAY}, time_chunk "
                         f"{replay['imm']['time_chunk']}",
                   replay_fps=replay["imm"]["replay_fps"],
                   one_launch_ms=replay["imm"]["one_launch_ms"],
                   chunk64_ms=replay["imm"]["chunk64_ms"],
                   instantiation=replay["imm"]["instantiation"],
                   registers=replay["imm"]["registers"],
                   full_square=full_sq["imm_scan"])),
        entry("katana_bank", per_frame["lkf"]["kernel_ms"],
              per_frame["lkf"]["plain_ms"], per_frame["lkf"]["bound_ms"],
              per_frame["lkf"]["bound_by"],
              per_frame["lkf"]["launches"] + per_frame["ekf"]["launches"],
              dict(shape=f"lkf N={N_REPLAY}, one frame; ms by events with "
                         "the device queued; soa_ms: katana_bank_soa",
                   bound_share=per_frame["lkf"]["bound_share"],
                   soa_ms=per_frame["lkf"]["soa_ms"],
                   registers=per_frame["lkf"]["registers"], by_model={
                       k: per_frame[k] for k in ("lkf", "ekf")},
                   full_square={k: {f: v for f, v in full_sq[k][
                       "full_square"].items() if f.startswith("step")}
                       for k in ("lkf", "ekf")})),
        entry("katana_bank_imm", per_frame["imm"]["kernel_ms"],
              per_frame["imm"]["plain_ms"], per_frame["imm"]["bound_ms"],
              per_frame["imm"]["bound_by"], per_frame["imm"]["launches"],
              dict(shape=f"imm K=4 N={N_REPLAY}, one frame (in "
                         "imm_bank_sequence)",
                   driver_ms=per_frame["imm"]["driver_ms"],
                   instantiation=per_frame["imm"]["instantiation"],
                   registers=per_frame["imm"]["registers"],
                   full_square=full_sq["imm"]["full_square"])),
    ] + [entry(name, k.pop("ms"), k.pop("plain_ms"), k.pop("bound_ms"),
               k.pop("bound_by"), k.pop("launches"), k,
               library_ms=k.pop("library_ms"))
         for name, k in lm_kern.items()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, torch=torch.__version__, rows=rows,
                 greedy=greedy, fleet=fleet, replay=replay,
                 per_frame=per_frame,
                 stages=stages, stage_kernels=full_sq,
                 lm=lm, mamba=mamba, stream=stream, imm_lane=lane,
                 train=train, moe=moe, jitted=jitted, mesh=mesh,
                 mesh_front=mesh_front, autotune=tuned,
                 kernels=kernels,
                 phase_seconds=seconds,
                 seconds=time.perf_counter() - t_start), indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
