"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each of which makes the script exit non-zero when it fails:

  (a) build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
      per source, all started together), and read the flash kernel's SASS:
      tensor-core HMMA with bf16 operands in every bf16 instantiation, none
      in the f32 ones;
  (b) hold the read kernels against their plain PyTorch versions on the
      card at deepseek_7b's read shapes (and transpose, #_d = 13 and
      row-offset variants; the raw read's decode at every batch 1-8) and
      the managed read at qwen3_14b's (prefill B 2000 and decode B 2,
      contractions in 2 and 5 segments, the 151936-row unembed; NM off and
      on): max |diff| against the stated tolerance, equal saturation
      flags; and the grid read (one #1 launch per block) against the plain
      grid read at deepseek_7b's 11008x4096, forward and transpose, B 4
      and 128, on grids 2x2 and 3x1 (rows padded to 11010);
  (c) serve the full-size deepseek_7b (30 layers, d 4096, vocab 102400,
      random weights from a seed) through ``repro_torch.launch.serve`` under
      two-phase bound management, launch counters read around the run;
  (d) the same under the paper's iterative bound management; in one
      profiled decode step every raw read is one ordinary kernel launch
      (no fill, memset or flag conversion beside it);
  (r) the smoke-size model on the card (kernels) against the CPU (plain
      versions): equal greedy tokens, logits within 1e-4;
  (f) hold each training kernel (conv read, pulse counts, fused dense and
      conv backward+update), and the raw and managed reads at the shapes
      the SEPARATE and ITERATIVE steps give them, against its plain version
      on the card at LeNet's shapes (K1, K2 with #_d 1 and 13, W3, W4; NM
      and two-phase BM on and off; BL 1 and 10 (K1 at BL 10: 360 slot
      parts meet at one device tile); a row offset; rows saturating on one
      read and on both; each fused entry also called twice back to back
      with different inputs and no synchronise between, so the second call
      finds the scratch as the first left it): counts bitwise, reads within
      1e-5 of the largest sum |x||w| with equal saturation flags; the raw
      read with its seed in device memory and with a true predicate
      bitwise its by-value read, as is a by-value read after one whose
      predicate is false;
  (g) train the full-width LeNet through ``repro_torch.train.cnn`` under
      the FUSED, SEPARATE and PAPER policies (20 steps each) and ITERATIVE
      (5 steps): launches per kind per step, no plain-version call on the
      card, steps/s, images/s, and one step's wall time, device time and
      idle share; in that profiled step every conv read, fused
      backward+update (and ITERATIVE's raw reads) one ordinary kernel
      launch, and the analog kernels of a FUSED or PAPER step 8 launches
      and no memset or copy;
  (g2) the epoch engine (``repro_torch.train.engine``): under FUSED,
      SEPARATE and PAPER, 20 steps through ``engine="python"`` (twice from
      one state: the loop is bitwise equal to itself; no plain-version
      call) and through
      ``engine="scan"`` (one CUDA graph replay per step, its keys and seeds
      from the key-schedule kernel) from the same tiles, keys and batches:
      every tile bitwise equal; the key-schedule kernel's tables bitwise
      its plain evaluator for those 20 steps; the captured step's nodes
      (its DOT dump): 8 analog kernels for FUSED and PAPER plus one
      key-schedule launch and no memset or copy; the epoch's launches, each
      replay adding what its capture recorded (a warm-up step's analog
      kernels, then 20 replays' and 20 key schedules); a second epoch of each
      engine timed (steps/s, images/s; tiles still equal), and one
      replayed step profiled beside one loop step (wall, device busy,
      idle share).  ITERATIVE (the paper's iterative BM, at alpha 1 so
      that the first steps' reads saturate) the same way: its captured
      step holds every read's 11 predicated raw reads (88), the 4 pulse
      counts and one key schedule; and a counted epoch of each engine
      (``management.count_retries``) shows retries ran, as many in the
      graphed steps as in the loop's;
  (g3) the full-width LeNet on a 2x2 grid of sub-tiles (``core/
      tile_grid.py``: each read one #1 launch per block, each update one
      #4 launch over the padded streams) as g2 runs it, under GRID_2P
      (two-phase BM: 64 raw reads and 4 pulse counts a step) and GRID_IT
      (the paper's iterative BM at alpha 0.5, where the first steps'
      block reads saturate and retry: 352 predicated raw reads and 4
      pulse counts): graphed tiles bitwise the loop's over 20 steps, the
      captured step's nodes (only #1 and #4 among the analog kernels, and
      no copy or memset beside #4's own), both engines' steps/s, a
      replayed step's profile, retries counted in both engines; then one
      GRID_2P step on the card against the CPU (as r2);
  (g4) the streaming chunks (``conv_stream_chunk=384:update_chunk=3``:
      K1's 4608 positions in 12 chunks, K2's 512 in 2, W3's and W4's 8
      update rows in 3): #1, #2 and #4 on chunks of a read or an update
      bitwise the whole one; under SEPARATE, BL-10 two-phase BM and
      GRID_2P, 20 graphed chunked steps bitwise 20 graphed materialized
      ones and the chunked loop's, the chunked capture's launches per kind
      (#4 20 a step; #2 18 for SEPARATE, #1 256 for GRID_2P) and nodes (no
      memset or copy beyond the materialized step's), steps/s of both;
      FUSED with chunks bitwise FUSED at 8 analog launches; ITERATIVE and
      GRID_IT with chunks graphed bitwise the loop, retries counted in
      both; noise-free iterative chunked bitwise materialized; one chunked
      SEPARATE step card vs CPU; the peak allocated memory of one loop
      step and of one capture plus replay at batch 1024 under BL-10
      two-phase BM, materialized against chunks of 4096 and 256 (the
      chunked peak must be lower);
  (p1) the paper's figure pair 1 through ``repro_torch.benchmarks.
      cnn_suite`` at its band protocol (6 epochs of 2048 images), seed 0:
      fig3a_baseline (no management) and fig3b_nm_bm (NM and the paper's
      iterative BM, through the epoch engine); fig3b_nm_bm inside its JAX
      seed band and the pair in JAX's order
      (``repro_torch/benchmarks/bands.py``);
  (l) the analog LSTM/GRU copy-task trainer (``repro_torch.recurrent``,
      ``launch/train.py``): #1, #2 at the recurrent reads (wx 128x9 and wh
      128x32 at B 8 and 16, the readout 8x33 at 272 and 160 rows; forward
      and transpose) and #6 at wx and wh (stream rows at 0 and 33 x 8)
      against their plain versions, #4 accumulated over 34 timesteps at
      ``row_offset = t * 8`` bitwise one count over the 272 stacked rows;
      ``train_sequence`` at full width (hidden 32, T 34, batch 8, one epoch
      of 25 steps and an evaluation) through both engines, launch
      counters set to 0 before each run and read after it, under SEQ_IT
      (the paper's iterative BM at alpha 1 on #1 and #4) and SEQ_FUSED
      (two-phase BM on #2 and #6) for the LSTM and SEQ_FUSED for the GRU:
      graphed tiles bitwise the loop's, no plain-version call; for both
      LSTM policies two epochs of the engine against the loop with
      ``count_retries`` (equal retries in the second, not zero under
      SEQ_IT), the launches per replay, the captured step's nodes and key
      tape, both engines' steps/s and a replayed step's profile; one
      SEQ_FUSED step card vs CPU; and the recurrent sequel's figure
      (``benchmarks/lstm_management.py``) at its protocol, seeds 0-2, on
      the kernels: every curve inside its JAX seed band and managed ending
      at least 0.1 above unmanaged at every seed;
  (h) train 2 epochs of 1024 synthetic images under nm_bm with two-phase
      BM and the fused update through ``engine="scan"``: final test error
      below 0.4;
  (k) kill and resume: ``repro_torch.train.cnn.train`` with checkpoints
      (full-width LeNet, batch 8, 512 training and 256 test images, 3
      epochs, a checkpoint per epoch) in subprocesses on the card, each
      under its own timeout: FUSED and ITERATIVE at alpha 1 run
      uninterrupted (the oracles); FUSED is SIGKILLed at the epoch-2
      boundary twice and resumed under ``engine="scan"`` and under
      ``engine="python"``, and SIGKILLed while step 2's write is held open
      (``sigkill_mid_save``: ``latest_step`` must be 1), resumed under
      scan; ITERATIVE killed at the epoch-2 boundary and resumed under
      scan.  Every final checkpoint's per-leaf (key, shape, dtype, crc32)
      and history equal its oracle's, no ``.tmp`` partial is left, no run
      calls a plain version; the FUSED oracle's final checkpoint restored
      onto the CPU and onto the card is bitwise equal, and saved again
      from the card gives the same bytes;
  (r2) one FUSED training step on the card against the plain CPU step on
      the same parameters, images and key: logits, x_bar, new weights;
  (b8) hold the flash-attention kernel against its plain version on the
      card: the JAX package's five flash cases, qwen3's prefill shape (B 2,
      S 1000, 40 heads over 8 kv heads, D 128) and a window case with rows
      that see no key, each in float32 and bfloat16;
  (f5) hold the fused pulse-update kernel against its plain version at the
      JAX package's PULSE_CASES and LeNet's K2 with 13 devices per weight
      (ctoc 0: within an ulp; ctoc 0.3: rtol 1e-5, atol 1e-6), every output
      within +-bound, and drive its one entry (``ops.pulse_update_fused``)
      through 20 update cycles with launch counters read around them;
  (s) serve the full-size qwen3_14b (40 layers, d 5120, vocab 151936,
      random weights from a seed) with the flash kernel under two-phase
      bound management: batch 2, prompt 1000, 16 new tokens; launches per
      kind, no plain-version call, tok/s, one prefill's wall and device time
      and the flash kernel's share, one decode step's (each managed read one
      gemv kernel, no epilogue kernel beside it); then one digital
      (bfloat16) prefill;
  (r3) the qwen3 smoke model on the card against the CPU with the flash
      kernel off and on: equal greedy tokens, logits within 1e-4;
  (t) the analog LM trainer (``repro_torch.train.lm``, the engine's
      ``scan_steps``, ``launch/train.py``): #1 and #2 at the LM step's
      reads (1016 rows: q 4096x4097, wg 11008x4097, wo 4096x11009 and the
      unembed 102400x4097, forward and transposed, 2 to 25 contraction
      segments), #6 at q and wo and #4 at wg's and the unembed's counts
      (1016 slots) against their plain versions; the full-width
      deepseek_7b cut to 4 layers (batch 8, seq 128) under FUSED_LM and
      ITERATIVE_LM: 3 loop steps and 3 graphed steps from the same
      weights, params, AdamW state and losses bitwise, the launches per
      replay against the count the code gives, the captured step's nodes,
      both engines' steps/s, a replayed step's profile and the peak
      memory; the CLI entry ``train("deepseek_7b", smoke=True)`` for 20
      steps; and ``benchmarks/analog_lm_convergence.py`` at seeds 0-2
      against the JAX rule ``a1 < 0.85 a0`` and the JAX seed bands;
  (s3) serve the full-size stablelm_3b (32 layers, d 2560, vocab 50304)
      under two-phase BM: batch 4, prompt 32, 16 tokens through
      ``engine.greedy_generate``, one #2 launch per analog read (225 a
      forward pass), no plain-version call, tok/s, a prefill's and a
      decode step's wall and device time, the peak memory;
  (m) mamba2_130m at full width (24 SSD layers, d 768, tied embeddings):
      (i) two-phase BM, batch 4, prompt 512, 32 tokens (48 #2 launches a
      pass); (ii) ``*ssm*=nm_bm:use_pallas=true`` (no update management:
      the prefill's projections read once per prompt position through
      ``recurrent.temporal``), batch 4, prompt 256: at least 12288 #1
      launches in one prefill, its wall time, then 16 tokens through
      ``launch.serve.serve``; (iii) the smoke model under both policies,
      card against CPU: prefill and 4 decode steps, logits and every cache
      leaf within 1e-4, greedy tokens equal;
  (y) hymba_1_5b at full width (32 layers of sliding-window attention,
      25 heads over 5, D 64, window 1024, beside an SSD branch) with the
      flash kernel under two-phase BM: batch 2, prompt 1100, 16 tokens;
      32 #8 launches a prefill and 289 #2 a pass, the ring cache (32, 2,
      1024, 5, 64); #8 at the prefill's own q, k, v (layer 0) against its
      plain version (rtol = atol = 2e-5) and the dtype they reach it in;
      the smoke model (window 32, prompt 40), card against CPU, flash off
      and on;
  (q) ``launch.serve.serve_continuous`` at full width on hymba_1_5b, two-
      phase BM: 4 slots, 12 requests of 627-1191 prompt tokens (both ring
      cases in one pool) and 9-16 new tokens; every request completes;
      the stream again through a scheduler that checks one tick with a
      free slot (the live rows' logits bitwise unmoved when the free rows'
      caches are NaN; each live row within 4x the noise of a batch-1
      decode from its cache row) gives the same completions; the first 6
      requests it admitted, alone, repeat its event log and tokens; every
      first token equals a batch-1 ``greedy_generate``'s; req/s, tok/s and
      how many requests match a per-request oracle (printed, not gated);
      then #2 at mamba2's and hymba's in_proj (B = batch and batch x
      prompt), #1 at the temporal route's per-position read and #8 at
      hymba's prefill against SDPA with the same window mask, timed;
  (e) each kernel's time against its bound, its plain version and one
      PyTorch call on the same shapes (yardstick only): ``torch.matmul``
      for the reads and the count products, ``F.conv2d`` for the conv read,
      ``F.scaled_dot_product_attention`` for the flash kernel, two
      ``torch.matmul`` and the elementwise finalize for the fused update;
      the managed read also at qwen3_14b's read shapes (B 2000 and 2), the
      raw read at the shapes of LeNet's ITERATIVE step, #1, #2, #4 and #6
      at the full-width LSTM's shapes, and where the time
      of one call goes (#2's and #1's decode read, #3's K1 read, #6 at W4,
      #7 at K2 with 13 devices per weight: host enqueue, wall, device time,
      kernels, launches and allocations per call); the key-schedule kernel
      is timed in g2, at the FUSED step's tape;
  (t2) training the ssm and hybrid families (``launch.train.lm_config``,
      ``train/lm.py``, the engine's ``scan_steps``): #1 and #2 at
      mamba2's and hymba's tiles (1016 rows, forward and transposed), #6
      at the tiles of at most 4096 rows and #4 at the others' counts, #1
      at the temporal route's per-position reads (8 rows, device seed and
      predicate) and #4 accumulated over 127 positions at ``row_offset = t
      * 8`` bitwise one count, against their plain versions; then batch 8,
      seq 128, seed 0, published widths: mamba2_130m at all 24 layers
      under FUSED_LM and ITERATIVE_LM and at 2 layers with its SSD
      projections on the temporal route (``*ssm*=nm_bm``: a read per
      position, each read twice under remat), hymba_1_5b at 4 of 32 layers
      under FUSED_LM and at 1 with its SSD branch on the temporal route;
      each run 3 loop
      steps against a warm-up and 3 graph replays, params, optimizer state
      and losses bitwise, finite losses, the launches per replay equal to
      ``lm_per_step``'s reckoning, the key schedule at the captured
      tape (up to 46987 derivations: keys in device memory) bitwise its
      plain evaluator, both engines' steps/s, the graph's nodes, its
      warm-up and capture seconds, a replay's profile and the peak memory;
  (s4) serve the full-size seamless_m4t_medium (12 encoder and 12 decoder
      layers, d 1024, vocab 256206) under two-phase BM with the flash
      kernel: batch 2, 1000 prompt tokens and 1000 stub frames, 16 tokens;
      launches per kind (36 #8 a prefill: 12 bidirectional, 12 causal, 12
      cross), prefill logits within 1e-3 of the chunked attention's and
      the same first token; #8 at the prefill's own bidirectional and
      cross inputs and at Sq 1000 over Sk 1500, #1 and #2 at its reads
      (the 256206x1025 unembed at B 2), against their plain versions; the
      smoke model, card against CPU, flash off and on; then the slice's
      kernel times (t2's and s4's shapes; #8 against SDPA without a mask);
  (s5) serve qwen1_5_110b at full width (d 8192, 64/8 heads of 128,
      d_ff 49152, vocab 152064, QKV bias) cut to 8 of its 80 layers under
      two-phase BM with the flash kernel: batch 2, 1000 prompt tokens, 16
      new, twice from the same params and keys, the KV cache float and
      ``kv_cache_quant``'s int8; launches per kind (#2 per read, #8 once
      a layer a prefill), no plain-version call, the int8 leaves' dtype,
      the int8 prefill cache bitwise ``quantize_kv`` of the float one, the
      first decode step's next-token distribution over the int8 cache
      within 0.05 of the float cache's, the cache's bytes, tok/s and the
      prefill's and a decode step's profile; #8 at the prefill's own inputs and #1/#2 at
      its reads against their plain versions; the smoke model with the
      int8 cache card against CPU; then the slice's kernel times (s5's
      reads and #8 against causal SDPA; t3's shapes);
  (t3) training seamless_m4t_medium at full width (d 1024, vocab 256206)
      with both stacks cut to 6 layers, batch 8, seq 128, the JAX
      trainer's 64 zero stub frames a row: #1, #2, #6 at the encoder's
      and the cross attentions' 512-row reads and #1, #2, #4 at the
      unembed's 1016 rows against their plain versions; under FUSED_LM
      and ITERATIVE_LM through ``lm_train`` as in t2 (the encoder's, the
      adapter's and the cross attentions' reads counted inside the
      replay); one FUSED_LM step of the smoke model card against CPU; the
      CLI on the smoke model for 60 graphed steps at the LM convergence
      benchmark's batch and seq, whose last 10 losses average below 0.85
      of the first 10's (the full-width runs' 3 steps from random weights
      are not held to a falling loss).

The line before the card line is the kernels' JSON summary; the last line
is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # H100 SXM int8 tensor cores, dense
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
SIGMA, ALPHA = 0.06, 12.0        # lm_managed read noise / integrator bound
POLICY_2P = "lm_managed:use_pallas=true:bm_mode=two_phase"
POLICY_IT = "lm_managed:use_pallas=true"
BATCH, PROMPT, GEN = 4, 32, 16
READS_PER_PASS = 7 * 30 + 1      # 7 projections x 30 layers + unembed
DEV = "cuda"
# (name, rows, cols, contraction segments) of the serving path's reads
TIME_SHAPES = [("q/k/v/o 4096x4096", 4096, 4096, 1),
               ("wg/wi 11008x4096", 11008, 4096, 1),
               ("wo 4096x11008", 4096, 11008, 3),
               ("unembed 102400x4096", 102400, 4096, 1)]
# qwen3_14b's managed reads: (name, rows, cols, segments, batches), at the
# prefill's B = 2 x 1000 and the decode's B = 2
QWEN_TIME_SHAPES = [("qwen3 q/o 5120x5120", 5120, 5120, 2, (2000, 2)),
                    ("qwen3 k/v 1024x5120", 1024, 5120, 2, (2000, 2)),
                    ("qwen3 wg/wi 17408x5120", 17408, 5120, 2, (2000, 2)),
                    ("qwen3 wo 5120x17408", 5120, 17408, 5, (2000, 2)),
                    ("qwen3 unembed 151936x5120", 151936, 5120, 2, (2,))]
SMOKE = False                    # full published size

# LeNet training (slice 2): policies and their launches per step
FUSED = "managed:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
SEPARATE = "managed:use_pallas=true:bm_mode=two_phase"
PAPER = ("K2=k2_multi_device:use_pallas=true:bm_mode=two_phase"
         ":fuse_bwd_update=true,*=" + FUSED)
ITERATIVE = "nm_bm:use_pallas=true"
# the first steps of a LeNet read nothing past alpha 12: at alpha 1 they
# saturate, and the engine's check sees retries run
ITERATIVE_A1 = ITERATIVE + ":out_bound=1"
LEARN = "nm_bm:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
# LeNet on a 2x2 grid of sub-tiles (slice 11): every read one #1 launch per
# block, every update one #4 launch over the padded streams
GRID_2P = "managed:use_pallas=true:bm_mode=two_phase:tile_grid=2x2"
GRID_IT = "nm_bm:use_pallas=true:tile_grid=2x2"
# a block integrates part of the contraction: at alpha 1 no block read of
# the first steps saturates, at alpha 0.5 they retry
GRID_IT_A05 = GRID_IT + ":out_bound=0.5"
LENET_BATCH, LENET_STEPS, ITERATIVE_STEPS = 8, 20, 5
PER_STEP = {
    "fused": {"managed_read": 2, "managed_read_conv": 2, "bwd_update": 2,
              "bwd_update_conv": 2},
    "separate": {"managed_read": 6, "managed_read_conv": 2,
                 "pulse_counts": 4},
    "paper": {"managed_read": 2, "managed_read_conv": 2, "bwd_update": 2,
              "bwd_update_conv": 2},
    # 8 reads (K1-W4 forward and transpose), each a first read and
    # bm_max_iters = 10 predicated retries; 4 pulse counts
    "iterative": {"noisy_read": 88, "pulse_counts": 4},
    # 8 managed reads x 2 two-phase reads x 4 blocks; 4 pulse counts
    "grid_2p": {"noisy_read": 64, "pulse_counts": 4},
    # 8 managed reads x 11 predicated reads x 4 blocks; 4 pulse counts
    "grid_it": {"noisy_read": 352, "pulse_counts": 4},
}
# deepseek_7b's wg/wi read (11008x4096) on sub-tile grids, at the decode's
# and the prefill's batch: (grid, B, transpose); (3, 1) pads 11008 rows to
# 11010, (2, 2) reads each 5504-row transpose block in 2 segments
GRID_READ_CASES = [(grid, b, tr) for grid in ((2, 2), (3, 1))
                   for b in (BATCH, 128) for tr in (False, True)]

# qwen3_14b serving with the flash-attention prefill (slice 3)
QWEN_BATCH, QWEN_PROMPT, QWEN_GEN = 2, 1000, 16
# (case, B, Sq, Sk, H, Hkv, D, causal, window, block_k): the JAX package's
# five flash cases (tests/test_flash_attention.py), qwen3's prefill, and a
# causal window past the keys' end (rows with no valid key)
FLASH_CASES = [
    ("causal 128", 2, 128, 128, 2, 2, 64, True, 0, 64),
    ("causal 200 non-aligned", 1, 200, 200, 3, 3, 32, True, 0, 64),
    ("bidirectional 128", 2, 128, 128, 2, 2, 64, False, 0, 64),
    ("window 96", 1, 256, 256, 2, 2, 64, True, 96, 64),
    ("cross 64/256", 1, 64, 256, 2, 2, 64, False, 0, 64),
    ("qwen3 prefill", QWEN_BATCH, QWEN_PROMPT, QWEN_PROMPT, 40, 8, 128, True,
     0, 128),
    ("window 40, 300/100", 1, 300, 100, 2, 2, 64, True, 40, 128),
]
# (case, m, n, batch, bl, ctoc): the JAX package's PULSE_CASES
# (tests/test_kernels.py) and LeNet's K2 with 13 devices per weight
PULSE_CASES = [("16x26", 16, 26, 8, 10, 0.3), ("32x401", 32, 401, 16, 1, 0.3),
               ("128x513", 128, 513, 4, 10, 0.0),
               ("130x260", 130, 260, 64, 2, 0.3),
               ("10x129", 10, 129, 1, 40, 0.3),
               ("K2 #_d=13", 416, 401, 512, 1, 0.3)]
PULSE_ENTRY_CYCLES = 20

# name -> its source, the TPU kernel it replaces, its launch kind, the run
# whose launches the summary reports and the timed shape it reports
KERNELS = {
    "noisy_mvm": dict(route="cuda",
                      source="src/repro_torch/csrc/noisy_mvm.cu",
                      replaces="src/repro/kernels/noisy_mvm.py:127",
                      kind="noisy_read", run="engine_iterative",
                      shape="wg/wi 11008x4096"),
    "managed_mvm": dict(route="cuda",
                        source="src/repro_torch/csrc/managed_mvm.cu",
                        replaces="src/repro/kernels/managed_mvm.py:187",
                        kind="managed_read", run="serve_two_phase",
                        shape="wg/wi 11008x4096"),
    "conv_mvm": dict(route="cuda", source="src/repro_torch/csrc/conv_mvm.cu",
                     replaces="src/repro/kernels/conv_mvm.py:157",
                     kind="managed_read_conv", run="train_fused",
                     shape="K1"),
    "pulse_counts": dict(route="cuda",
                         source="src/repro_torch/csrc/pulse_counts.cu",
                         replaces="src/repro/kernels/pulse_update.py:112",
                         kind="pulse_counts", run="train_separate",
                         shape="K1 BL=1"),
    "pulse_update": dict(route="cuda",
                         source="src/repro_torch/csrc/pulse_update.cu",
                         replaces="src/repro/kernels/pulse_update.py:166",
                         kind="pulse_update", run="pulse_update_entry",
                         shape="K2 #_d=13"),
    "bwd_update_mvm": dict(route="cuda",
                           source="src/repro_torch/csrc/bwd_update_mvm.cu",
                           replaces="src/repro/kernels/bwd_update_mvm.py:222",
                           kind="bwd_update", run="train_fused", shape="W3"),
    "conv_bwd_update": dict(route="cuda",
                            source="src/repro_torch/csrc/bwd_update_mvm.cu",
                            replaces="src/repro/kernels/bwd_update_mvm.py:473",
                            kind="bwd_update_conv", run="train_fused",
                            shape="K1"),
    "flash_attention": dict(route="cuda",
                            source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:83",
                            kind="flash_attention", run="serve_qwen3",
                            shape="qwen3 prefill float32"),
    # no TPU kernel: the threefry XLA runs inside the jitted epoch
    # (fold_in_keys and the key tree under each step key)
    "key_schedule": dict(route="cuda",
                         source="src/repro_torch/csrc/key_schedule.cu",
                         replaces="src/repro/train/engine.py:53",
                         kind="key_schedule", run="engine_fused",
                         shape="LeNet FUSED step"),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def phase(name):
    print(f"\n=== phase {name} ===", flush=True)


# ---------------------------------------------------------------------------
# (a) build
# ---------------------------------------------------------------------------

def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    dt = time.perf_counter() - t0
    for name, path in paths.items():
        print(f"[build] {name}: {path.name}")
        entry = "?"
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                usage = line.strip().removeprefix("ptxas info").strip(" :")
                print(f"  {entry}: {usage}")
    print(f"[build] {len(paths)} kernels in {dt:.1f}s (parallel nvcc)")
    sass_check(paths["flash_attention"])
    return dt


def _sass_functions(lib):
    """{function name: its SASS} of a built library (``cuobjdump -sass``)."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    tool = str(cuobjdump) if cuobjdump.exists() else "cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def sass_check(lib):
    """The flash kernel's bf16 instantiations multiply on the tensor cores
    (HMMA with bf16 operands), its f32 ones never touch them (no HMMA, so
    no TF32)."""
    funcs = _sass_functions(lib)
    tc = {k: v.count("HMMA") for k, v in funcs.items() if "2tc6kernel" in k}
    fp = {k: v.count("HMMA") for k, v in funcs.items() if "2fp6kernel" in k}
    bf16 = {k: ("BF16" in v) for k, v in funcs.items() if "2tc6kernel" in k}
    print(f"[sass] flash bf16 kernels: HMMA per instantiation "
          f"{sorted(tc.values())}, bf16 operands in all: "
          f"{all(bf16.values())}; f32 kernels: HMMA {sorted(fp.values())}")
    check(len(tc) == 8 and all(n > 0 for n in tc.values())
          and all(bf16.values()),
          "the bf16 flash kernels do not run on the tensor cores")
    check(len(fp) == 8 and not any(fp.values()),
          "an f32 flash kernel uses the tensor cores")


# ---------------------------------------------------------------------------
# (b) kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(b, rows, cols, transpose, seed):
    """Weights ~ N(0, 1/K) and input rows at scales 1, 8 and 300, so some
    rows never saturate, some saturate on the first read only and some on
    both two-phase reads — every flag far from the bound.  Two rows take
    scales 8 and 300: one saturates on one read, one on both."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    k = rows if transpose else cols
    w = torch.randn(rows, cols, generator=g, device=DEV) * k ** -0.5
    x = torch.randn(b, k, generator=g, device=DEV)
    scales = torch.tensor([1.0, 8.0, 300.0] if b > 2 else [8.0, 300.0],
                          device=DEV)
    x = x * scales[torch.arange(b, device=DEV) % len(scales)][:, None]
    return w.contiguous(), x.contiguous()


def _cases():
    """(name, B, rows, cols, n_seg, transpose, d_avg, row_offset, total_rows,
    kernels, NM settings): deepseek_7b's reads (both kernels, NM on every
    other case), then qwen3_14b's at the shapes its serving path gives the
    managed read — the prefill's B = 2 x 1000 (a partial 64-row tile), the
    decode's B = 2, contractions of 5120 and 17408 split over 4096-column
    arrays (n_seg 2 and 5) — each with NM off (rows saturate on one read
    and on both) and on."""
    both = ("noisy_mvm", "managed_mvm")
    ds = [
        ("q 4096x4096 B=4", 4, 4096, 4096, 1, False, 1, 0, None),
        ("q 4096x4096 B=128", 128, 4096, 4096, 1, False, 1, 0, None),
        ("wi 11008x4096 B=4", 4, 11008, 4096, 1, False, 1, 0, None),
        ("wo 4096x11008 B=4 n_seg=3", 4, 4096, 11008, 3, False, 1, 0, None),
        ("wo 4096x11008 B=128 n_seg=3", 128, 4096, 11008, 3, False, 1, 0,
         None),
        ("unembed 102400x4096 B=4", 4, 102400, 4096, 1, False, 1, 0, None),
        ("transpose 4096x4096 B=4", 4, 4096, 4096, 1, True, 1, 0, None),
        ("transpose 11008x4096 B=128 n_seg=3", 128, 11008, 4096, 3, True, 1,
         0, None),
        ("d_avg=13 416x401 B=96", 96, 416, 401, 1, False, 13, 0, None),
        ("row_offset 4096x4096 B=7 @1000/2048", 7, 4096, 4096, 1, False, 1,
         1000, 2048),
    ]
    cases = [c + (both if c[6] == 1 else both[1:], (bool(i % 2),))
             for i, c in enumerate(ds)]
    # the raw read's one-launch decode at every batch 1-8 (wo: 3 segments,
    # the unaligned segment bound 3670)
    cases += [(f"raw decode wo 4096x11008 B={b} n_seg=3", b, 4096, 11008, 3,
               False, 1, 0, None, both[:1], (False,)) for b in range(1, 9)]
    pre, dec = QWEN_BATCH * QWEN_PROMPT, QWEN_BATCH
    for name, r, c, n_seg, bs in (
            ("qwen3 q/o 5120x5120", 5120, 5120, 2, (pre, dec)),
            ("qwen3 k/v 1024x5120", 1024, 5120, 2, (pre, dec)),
            ("qwen3 wg/wi 17408x5120", 17408, 5120, 2, (pre,)),
            ("qwen3 wo 5120x17408", 5120, 17408, 5, (pre, dec)),
            ("qwen3 unembed 151936x5120", 151936, 5120, 2, (dec,))):
        for b in bs:
            cases.append((f"{name} B={b} n_seg={n_seg}", b, r, c, n_seg,
                          False, 1, 0, None, both[1:], (False, True)))
    return cases


def kernels_vs_plain(results):
    import torch
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[check] torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    ok = True
    for i, (name, b, r, c, n_seg, tr, d, off, tot, kernels,
            nms) in enumerate(_cases()):
        w, x = _inputs(b, r, c, tr, seed=100 + i)
        kw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=n_seg, transpose=tr,
                  row_offset=off, total_rows=tot)
        # largest accumulated sum_k |x_k w_k|: fp32 reassociation over K
        # terms moves a dot product by ~sqrt(K) * 2^-24 of it (< 8e-6 at
        # K = 17408), so 1e-5 of it bounds the kernel-vs-cuBLAS difference
        mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
        for kname, nm_on in ((k, n) for k in kernels for n in nms):
            if kname == "noisy_mvm":
                y, s = kn.noisy_mvm(w, x, 0x1234ABCD, **kw)
                yp, sp = kn.noisy_mvm_plain(w, x, 0x1234ABCD, **kw)
            else:
                nm = torch.amax(x.abs(), dim=1, keepdim=True) \
                    if nm_on else torch.ones(b, 1, device=DEV)
                mkw = dict(kw, two_phase=True, retry_scale=16.0, d_avg=d)
                y, s = km.managed_mvm(w, x, nm, (11, 2 ** 32 - 5), **mkw)
                yp, sp = km.managed_mvm_plain(w, x, nm, (11, 2 ** 32 - 5),
                                              **mkw)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max())
            tol = 1e-5 * max(1.0, mag)
            agree = int((s == sp).sum())
            good = (err <= tol and agree == b and bool(torch.isfinite(y).all())
                    and y.shape == yp.shape)
            ok &= good
            case = name + (" NM" if kname == "managed_mvm" and nm_on else "")
            print(f"[check] {kname:<11} {case:<38} max|diff|={err:.3e} "
                  f"tol={tol:.3e} sat agree {agree}/{b} "
                  f"(set: {int(sp.sum())}) {'ok' if good else 'FAIL'}")
            results.setdefault("checks", []).append(dict(
                kernel=kname, case=case, max_abs_err=err, tol=tol,
                sat_agree=agree, rows=b, sat_set=int(sp.sum()), ok=good))
            del y, s, yp, sp
        del w, x
    check(ok, "a kernel disagrees with its plain version")
    grid_reads_vs_plain(results)


def grid_reads_vs_plain(results):
    """The grid read (``core/tile_grid.py``: one #1 launch per block, the
    partial reads added in contraction-block order) against the plain grid
    read (the same function with ``use_pallas`` off) on the card, at
    GRID_READ_CASES: within 1e-5 of the largest sum |x||w|, equal flags,
    one launch per block."""
    import torch
    from repro_torch.core import device as dev
    from repro_torch.core import tile_grid
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.utils import prng

    ok = True
    for i, (grid, b, tr) in enumerate(GRID_READ_CASES):
        w, x = _inputs(b, 11008, 4096, tr, seed=300 + i)
        cfg = dev.RPUConfig(read_noise=SIGMA, out_bound=ALPHA,
                            tile_grid=grid, use_pallas=True)
        mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
        n0 = kn.launches
        y, s = tile_grid.grid_analog_mvm(w, x, prng.key(11), cfg,
                                         transpose=tr)
        launched = kn.launches - n0
        yp, sp = tile_grid.grid_analog_mvm(
            w, x, prng.key(11), dataclasses.replace(cfg, use_pallas=False),
            transpose=tr)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        tol = 1e-5 * max(1.0, mag)
        agree = int((s == sp).sum())
        good = (err <= tol and agree == b and launched == grid[0] * grid[1]
                and bool(torch.isfinite(y).all()) and y.shape == yp.shape)
        ok &= good
        case = (f"grid {grid[0]}x{grid[1]} {'transpose ' if tr else ''}"
                f"11008x4096 B={b}")
        print(f"[check] noisy_mvm   {case:<38} max|diff|={err:.3e} "
              f"tol={tol:.3e} sat agree {agree}/{b} (set: {int(sp.sum())}) "
              f"launches {launched} {'ok' if good else 'FAIL'}")
        results.setdefault("checks", []).append(dict(
            kernel="noisy_mvm", case=case, max_abs_err=err, tol=tol,
            sat_agree=agree, rows=b, sat_set=int(sp.sum()),
            launches=launched, ok=good))
        del w, x, y, s, yp, sp
    check(ok, "a grid read disagrees with the plain grid read")


# ---------------------------------------------------------------------------
# (c), (d) full-size serving
# ---------------------------------------------------------------------------

def serve_full(policy, results, label):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    cfg = S.build_cfg("deepseek_7b", SMOKE, policy)
    check(SMOKE or (cfg.n_layers, cfg.d_model, cfg.vocab)
          == (30, 4096, 102400), "not the published deepseek_7b")
    t0 = time.perf_counter()
    params, akey = S.init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _tensors(params))
    print(f"[{label}] init {n_params / 1e9:.2f} B params on the card in "
          f"{t_init:.1f}s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    kw = dict(batch=BATCH, prompt_len=PROMPT, params=params, akey=akey,
              analog_policy=policy)
    kw["smoke"] = SMOKE
    kw["device"] = DEV
    S.serve("deepseek_7b", gen=2, **kw)                      # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = S.serve("deepseek_7b", gen=GEN, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    tok_s = BATCH * GEN / dt
    print(f"[{label}] tokens {toks.shape}, launches {counts}, "
          f"{tok_s:.2f} tok/s after warm-up ({dt:.2f}s for prefill + "
          f"{GEN - 1} decode steps)")
    check(toks.shape == (BATCH, GEN), "wrong token shape")
    check(((toks >= 0) & (toks < cfg.vocab)).all(), "token out of range")

    # logits of the same prompts are finite (outside the counted window)
    prompts = S.make_prompts(cfg, BATCH, PROMPT, 0, DEV)
    with torch.no_grad():
        logits, _ = engine.prefill(params, prompts, cfg,
                                   max_seq=PROMPT + GEN, akey=akey)
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(tuple(logits.shape) == (BATCH, 1, cfg.vocab), "logit shape")

    prof = _profile_decode(params, cfg, akey, prompts,
                           () if policy == POLICY_2P else ("noisy_read",))
    results[label] = dict(policy=policy, tokens_shape=list(toks.shape),
                          launches=counts, tok_per_s=tok_s, seconds=dt,
                          init_s=t_init, n_params=n_params,
                          decode_profile=prof)
    del params, logits, kw
    torch.cuda.empty_cache()
    return counts


def _tensors(tree):
    from repro_torch.analog.modules import AnalogState
    if isinstance(tree, AnalogState):
        yield tree.w
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def _profile_decode(params, cfg, akey, prompts, reads=()):
    """One decode step: its wall time and device time (``_profile_step``)."""
    import torch
    from repro_torch.serve import engine
    with torch.no_grad():
        _, cache = engine.prefill(params, prompts, cfg, max_seq=PROMPT + GEN,
                                  akey=akey)
        tok = prompts[:, -1:]
        return _profile_step(
            lambda: engine.serve_step(params, tok, cache, cfg,
                                      akey=engine.decode_step_key(akey, 0)),
            "one decode step", reads)


def _profile_step(step, what, reads=(), kinds=()):
    """``what``: its wall time (host clock around a synchronised call, no
    profiler), and the device time of each CUDA kernel in a second,
    profiled call (None when the profiler records no device time).  For
    each kind in ``reads`` the profiled call must make one ordinary kernel
    launch per call (``_one_launch_per_read``); the runtime calls inside
    the ranges of ``kinds`` are totalled (``_analog_calls``)."""
    import torch
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = _profiled(step)
    report = _profile_report(_device_rows(step, prof), wall, what)
    report["reads"] = {k: _one_launch_per_read(prof, k) for k in reads}
    if kinds:
        report["analog_calls"] = _analog_calls(prof, kinds)
    return report


# launch kind -> the kernel whose records its calls leave
READ_KERNELS = {"noisy_read": "raw_", "managed_read_conv": "conv_read_kernel",
                "bwd_update": "fused::kernel<analog::DenseA",
                "bwd_update_conv": "fused::kernel<analog::ConvA"}


def _calls_in_ranges(prof, kind):
    """The ``kind`` ranges of one profiled call: how many, the sorted CUDA
    runtime calls (launches, memsets, copies) inside each range (host
    time, same thread) counted per distinct tuple, and the records of the
    kind's kernel (READ_KERNELS, else 0)."""
    ranges, calls, records = [], [], 0
    for e in prof.events():
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        if on_device:
            records += READ_KERNELS.get(kind, "\0") in e.name
        elif e.name == kind:
            ranges.append(e)
        elif e.name.startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy")):
            calls.append(e)
    by_thread = {}
    for c in sorted(calls, key=lambda c: c.time_range.start):
        by_thread.setdefault(c.thread, []).append(c)
    starts = {t: [c.time_range.start for c in cs]
              for t, cs in by_thread.items()}
    per_read = {}
    for r in ranges:
        cs = by_thread.get(r.thread, [])
        i = bisect.bisect_left(starts.get(r.thread, []), r.time_range.start)
        inside = []
        while i < len(cs) and cs[i].time_range.start <= r.time_range.end:
            if cs[i].time_range.end <= r.time_range.end:
                inside.append(cs[i].name)
            i += 1
        key = tuple(sorted(inside))
        per_read[key] = per_read.get(key, 0) + 1
    return len(ranges), per_read, records


def _one_launch_per_read(prof, kind):
    """Each ``kind`` call of one profiled call is one ordinary kernel launch
    and nothing else: inside every ``kind`` range the CUDA runtime calls
    are exactly one ``cudaLaunchKernel`` (no cooperative launch, memset,
    copy or second launch: no fill before the kernel and no flag
    conversion after it), and the kind's kernel records number at most the
    calls (the profiler may drop kernel records, even every one of a few
    calls, but never runtime records).  Fails otherwise."""
    n, per_read, records = _calls_in_ranges(prof, kind)
    print(f"[launches] {kind}: {n} calls in one profiled call, "
          f"runtime calls per call {per_read}, {records} kernel records")
    check(n and per_read == {("cudaLaunchKernel",): n} and records <= n,
          f"a {kind} call is not one ordinary kernel launch")
    return dict(reads=n, kernel_records=records,
                calls_per_read={" ".join(k): c for k, c in per_read.items()})


def _analog_calls(prof, kinds):
    """The CUDA runtime calls, by name, inside every range of ``kinds`` in
    one profiled call."""
    total = {}
    for kind in kinds:
        _, per_read, _ = _calls_in_ranges(prof, kind)
        for calls, reps in per_read.items():
            for c in calls:
                total[c] = total.get(c, 0) + reps
    print(f"[launches] runtime calls of the analog kernels "
          f"({', '.join(kinds)}) in one profiled call: {total}")
    return total


def _profiled(step):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    return prof


def _device_rows(step, prof=None):
    """(kernel, calls, device ms) of each CUDA kernel of one profiled call
    of ``step`` (or of the profile ``prof``), longest first; empty when the
    profiler records no device time."""
    prof = _profiled(step) if prof is None else prof
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a host op (aten::mul) also carries the
        # device time of the kernels it launched, and a profiler range
        # carries the time of the kernels inside it
        dev = getattr(ev, "self_device_time_total", 0) or 0
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev > 0 and on_device and not getattr(ev, "is_user_annotation",
                                                 False):
            rows.append((ev.key, ev.count, dev / 1e3))
    rows.sort(key=lambda r: -r[2])
    return rows


def _profile_report(rows, wall, what):
    if not rows:
        print("[profile] torch.profiler recorded no device time")
        return dict(wall_ms=wall, device_busy_ms=None, top=[])
    busy = sum(r[2] for r in rows)
    print(f"[profile] {what}: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.2f}")
    for key, n, ms in rows[:8]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:70]}")
    return dict(wall_ms=wall, device_busy_ms=busy,
                top=[dict(kernel=k, count=n, ms=ms) for k, n, ms in rows[:12]],
                kernels={k: n for k, n, _ in rows})


# ---------------------------------------------------------------------------
# (r) small-input reference: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def _to(tree, device):
    from repro_torch.analog.modules import AnalogState
    if isinstance(tree, AnalogState):
        return AnalogState(tree.w.to(device), None, tree.seed, tree.meta)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def smoke_reference(results):
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer
    from repro_torch.serve import engine
    from repro_torch.utils import prng

    for policy in (POLICY_2P, POLICY_IT):
        cfg = dataclasses.replace(S.build_cfg("deepseek_7b", True, policy),
                                  act_dtype=torch.float32)
        p_cpu = transformer.init_lm(0, cfg, device="cpu")
        p_gpu = _to(p_cpu, DEV)
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 12)))
        outs = {}
        for dev, p in (("cpu", p_cpu), (DEV, p_gpu)):
            with torch.no_grad():
                lg, _ = engine.prefill(p, toks.to(dev), cfg, max_seq=20,
                                       akey=prng.key(5))
                gen, _ = engine.greedy_generate(p, toks.to(dev), cfg,
                                                n_steps=6, max_seq=20,
                                                akey=prng.key(5))
            outs[dev] = (lg.cpu(), gen.cpu())
        err = float((outs["cpu"][0] - outs[DEV][0]).abs().max())
        same = torch.equal(outs["cpu"][1], outs[DEV][1])
        print(f"[reference] smoke {policy}: logits max|diff| {err:.2e} "
              f"(tol 1e-4), greedy tokens equal: {same}")
        results.setdefault("reference", []).append(
            dict(policy=policy, logit_err=err, tokens_equal=same))
        check(err <= 1e-4 and same, "card disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# (e) kernel times against bound, plain version and torch.matmul
# ---------------------------------------------------------------------------

def _event_ms(fn, iters=20):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, iters=10):
    """Device time per call of ``fn`` from torch.profiler: every device
    operation its calls make (kernels, fills, memsets; profiler ranges are
    not device work), with the records it kept and the operations made:
    ``(ms, kept, made)``, ms None without device time.  The profiler can
    drop records (7 of 10 launches of one kernel in one run), so each
    operation's time is its mean over the records kept, times its count per
    call."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    tot, kept, made = 0.0, 0, 0
    for ev in prof.key_averages():
        dev = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev > 0 and on_device and not getattr(ev, "is_user_annotation",
                                                 False):
            per_call = max(1, round(ev.count / iters))
            tot += dev / ev.count * per_call
            kept += ev.count
            made += per_call * iters
    return (tot if tot > 0 else None), kept, made


def _kernel_time(fk):
    """A wrapper's time per call: the profiler's device time of its
    kernels and CUDA events around 20 back-to-back calls (the kernels plus
    the wrapper's own allocations and launch gaps).  ``ms`` is the larger:
    the profiler has read a kernel at half its event time, and events
    read the host where its enqueue outlasts the kernel."""
    dev_ms, kept, made = _device_ms(fk)
    ev_ms = _event_ms(fk)
    by_events = dev_ms is None or ev_ms > dev_ms
    return dict(ms=ev_ms if by_events else dev_ms,
                ms_source="events" if by_events else "profiler",
                profiler_ms=dev_ms, profiler_records=f"{kept}/{made}",
                event_ms=ev_ms)


def _time_text(row):
    prof = ("no record" if row["profiler_ms"] is None
            else f"{row['profiler_ms']:.4f}")
    return (f"kernel {row['ms']:.4f} ms ({row['ms_source']}; profiler "
            f"{prof}, records {row['profiler_records']}; events "
            f"{row['event_ms']:.4f})")


def kernel_times(results):
    import torch
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn

    rows = []
    for b in (BATCH, BATCH * PROMPT):
        for name, r, c, n_seg in TIME_SHAPES:
            if name.startswith("unembed") and b > BATCH:
                continue               # the unembed reads the last position
            w, x = _inputs(b, r, c, False, seed=7)
            nm = torch.ones(b, 1, device=DEV)
            kw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=n_seg)
            mkw = dict(kw, two_phase=True, retry_scale=16.0)
            fns = {
                "noisy_mvm": (lambda: kn.noisy_mvm(w, x, 1, **kw),
                              lambda: kn.noisy_mvm_plain(w, x, 1, **kw)),
                "managed_mvm": (
                    lambda: km.managed_mvm(w, x, nm, (1, 2), **mkw),
                    lambda: km.managed_mvm_plain(w, x, nm, (1, 2), **mkw)),
            }
            flops = 2.0 * b * r * c
            lib_ms = _event_ms(lambda: torch.matmul(x, w.T))
            for kname, (fk, fp) in fns.items():
                out_b = 4 * b * r + 4 * b
                byts = 4 * (r * c + b * c) + out_b + (
                    4 * b if kname == "managed_mvm" else 0)
                bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
                row = dict(kernel=kname, shape=name, batch=b,
                           **_kernel_time(fk), plain_ms=_event_ms(fp),
                           library_ms=lib_ms, bound_ms=bound * 1e3,
                           bound_by="bytes" if byts / HBM_BYTES_PER_S
                           >= flops / FP32_FLOPS_PER_S else "operations")
                rows.append(row)
                print(f"[time] {kname:<11} {name:<22} B={b:<4} "
                      f"{_time_text(row)} bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain "
                      f"{row['plain_ms']:.4f} ms matmul {lib_ms:.4f} ms")
            del w, x
    for name, r, c, n_seg, batches in QWEN_TIME_SHAPES:
        for b in batches:
            w, x = _inputs(b, r, c, False, seed=8)
            nm = torch.ones(b, 1, device=DEV)
            mkw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=n_seg, two_phase=True,
                       retry_scale=16.0)
            flops = 2.0 * b * r * c
            byts = 4 * (r * c + b * c + b * r + 2 * b)
            bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
            row = dict(kernel="managed_mvm", shape=name, batch=b,
                       **_kernel_time(
                           lambda: km.managed_mvm(w, x, nm, (1, 2), **mkw)),
                       plain_ms=_event_ms(
                           lambda: km.managed_mvm_plain(w, x, nm, (1, 2),
                                                        **mkw), iters=3),
                       library_ms=_event_ms(lambda: torch.matmul(x, w.T)),
                       bound_ms=bound * 1e3,
                       bound_by="bytes" if byts / HBM_BYTES_PER_S
                       >= flops / FP32_FLOPS_PER_S else "operations")
            row["tflops"] = flops / row["ms"] / 1e9
            rows.append(row)
            print(f"[time] managed_mvm {name:<26} B={b:<4} {_time_text(row)} "
                  f"({row['tflops']:.1f} TFLOP/s) bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain "
                  f"{row['plain_ms']:.4f} ms matmul "
                  f"{row['library_ms']:.4f} ms")
            del w, x
    results["times"] = results.get("times", []) + rows
    results["read_split"] = read_split()
    return rows


def read_split(iters=50):
    """Where the time of one call goes, for one decode read of #2 (wo
    4096x11008, B = 4, where events and the profiler disagreed most for
    its two-launch design) and of #1 (the same shape), one K1 conv read of
    #3 (batch 8), and one call of #6 at W4 and of #7 at K2 with 13 devices
    per weight (batch 8, the PAPER policy's): the host time of one wrapper
    call without a synchronise (allocations, the ctypes call and the
    launch: the enqueue), the wall time per call of back-to-back calls,
    the device time of its kernels, the CUDA kernels, launches and
    allocations per call, and the host ops the profiler saw, per call.
    Fails unless #2's read is one cooperative launch, and the others one
    ordinary launch with no memset."""
    import torch
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import conv_mvm as kc
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    w, x = _inputs(BATCH, 4096, 11008, False, seed=9)
    nm = torch.ones(BATCH, 1, device=DEV)
    kw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=3)
    mkw = dict(kw, two_phase=True, retry_scale=16.0)
    name, vol, k, out = CONV_LAYERS[0]
    geom, wc, xc = _conv_case(name, vol, k, out, 1, seed=9)
    nm_c = torch.ones(geom.positions, 1, device=DEV)
    ckw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True)
    g = torch.Generator(device=DEV).manual_seed(9)
    w4 = torch.randn(10, 129, generator=g, device=DEV)
    x4 = torch.randn(LENET_BATCH, 129, generator=g, device=DEV)
    d4 = torch.randn(LENET_BATCH, 10, generator=g, device=DEV)
    nm4 = torch.ones(LENET_BATCH, 1, device=DEV)
    name2, vol2, k2, out2 = CONV_LAYERS[1]
    geom2, w2, x2 = _conv_case(name2, vol2, k2, out2, 13, seed=9)
    d2 = torch.randn(geom2.positions, out2 * 13, generator=g, device=DEV)
    nm2 = torch.ones(geom2.positions, 1, device=DEV)
    gains = torch.tensor([1.0, 1.0], device=DEV)
    bkw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, bl=1)
    reads = [
        ("managed_mvm", "decode read wo 4096x11008 B=4",
         lambda: km.managed_mvm(w, x, nm, (1, 2), **mkw),
         {"cudaLaunchCooperativeKernel": iters}),
        ("noisy_mvm", "decode read wo 4096x11008 B=4",
         lambda: kn.noisy_mvm(w, x, 1, **kw), {"cudaLaunchKernel": iters}),
        ("conv_mvm", f"K1 read {name} batch {vol[0]}",
         lambda: kc.conv_managed_mvm(wc, xc, geom, nm_c, (1, 2), **ckw),
         {"cudaLaunchKernel": iters}),
        ("bwd_update_mvm", "W4 B=8 10x129",
         lambda: kb.bwd_update_mvm(w4, d4, x4, nm4, (1, 2), (3, 4, 0),
                                   gains, **bkw),
         {"cudaLaunchKernel": iters}),
        ("conv_bwd_update", f"{name2} #_d=13 batch {vol2[0]} 416x401",
         lambda: kb.conv_bwd_update(w2, x2, d2, geom2, nm2, (1, 2), (3, 4),
                                    gains, **bkw),
         {"cudaLaunchKernel": iters}),
    ]
    out = {}
    for kname, what, read, want in reads:
        out[kname] = _split(kname, what, read, want, iters)
    return out


def _split(kname, what, read, want, iters):
    import torch
    read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        read()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / iters * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            read()
        torch.cuda.synchronize()
    kernels, host_ops = {}, {}
    for ev in prof.key_averages():
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        dev = (getattr(ev, "self_device_time_total", 0) or 0)
        if on_device and dev > 0:
            kernels[ev.key] = dict(per_read=ev.count / iters,
                                   us=dev / ev.count)
        elif not on_device:
            host_ops[ev.key] = dict(
                per_read=ev.count / iters,
                us=(getattr(ev, "self_cpu_time_total", 0) or 0) / iters)
    device_us = sum(k["us"] * k["per_read"] for k in kernels.values())
    allocs = sum(v["per_read"] for k, v in host_ops.items()
                 if k.startswith("aten::empty"))
    launched = {k: round(v["per_read"] * iters) for k, v in host_ops.items()
                if k.startswith(("cudaLaunch", "cudaMemset"))}
    print(f"[split] {kname} {what}: host {host_us:.1f} us per call "
          f"(enqueue), wall {wall_us:.1f} us per read back-to-back, device "
          f"{device_us:.1f} us; launches per read "
          + ", ".join(f"{k} x{n / iters:.2f}" for k, n in launched.items())
          + f"; allocations per read {allocs:.2f}; kernels per read "
          + ", ".join(f"{k[:60]} x{v['per_read']:.2f} ({v['us']:.1f} us)"
                      for k, v in kernels.items()))
    top = sorted(host_ops.items(), key=lambda kv: -kv[1]["us"])[:8]
    print(f"[split] {kname} host ops per read: " + ", ".join(
        f"{k[:40]} x{v['per_read']:.2f} {v['us']:.1f} us" for k, v in top))
    check(launched == want, f"{iters} {kname} reads made the launches "
          f"{launched}, expected {want}")
    return dict(host_us=host_us, wall_us=wall_us, device_us=device_us,
                launches=launched, allocations=allocs, kernels=kernels,
                host_ops=dict(top))


# ---------------------------------------------------------------------------
# (f) training kernels against their plain versions
# ---------------------------------------------------------------------------

# (name, volume (B, H, W, C), kernel, out channels) at LeNet's widths
CONV_LAYERS = [("K1", (LENET_BATCH, 28, 28, 1), 5, 16),
               ("K2", (LENET_BATCH, 12, 12, 16), 5, 32)]
DENSE_LAYERS = [("W3", 512, 128), ("W4", 128, 10)]


def _scaled_rows(g, rows, cols, scales=(1.0, 8.0, 300.0)):
    """Gaussian rows at scales 1, 8 and 300 in turn: some rows never
    saturate, some on the first read only, some on both two-phase reads."""
    import torch
    v = torch.randn(rows, cols, generator=g, device=DEV)
    s = torch.tensor(scales, device=DEV)
    return (v * s[torch.arange(rows, device=DEV) % len(scales)][:, None]
            ).contiguous()


def _conv_case(name, vol, k, out, d, seed):
    """Weights ~ N(0, 1/K) and a volume whose images are scaled 1, 8, 300."""
    import torch
    from repro_torch.core import conv_mapping as cm
    g = torch.Generator(device=DEV).manual_seed(seed)
    geom = cm.conv_geometry(vol, k)
    w = (torch.randn(out * d, geom.cols, generator=g, device=DEV)
         * geom.cols ** -0.5).contiguous()
    x = _scaled_rows(g, vol[0], vol[1] * vol[2] * vol[3]).reshape(vol)
    return geom, w, x.contiguous()


def _read_check(results, kernel, case, y, yp, s, sp, mag, extra=""):
    import torch
    torch.cuda.synchronize()
    err = float((y - yp).abs().max())
    tol = 1e-5 * max(1.0, mag)
    agree = int((s == sp).sum())
    good = (err <= tol and agree == s.numel() and y.shape == yp.shape
            and bool(torch.isfinite(y).all()))
    print(f"[check] {kernel:<15} {case:<34} max|diff|={err:.3e} "
          f"tol={tol:.3e} sat agree {agree}/{s.numel()} "
          f"(set: {int(sp.sum())}){extra} {'ok' if good else 'FAIL'}")
    results.setdefault("checks", []).append(dict(
        kernel=kernel, case=case, max_abs_err=err, tol=tol, sat_agree=agree,
        rows=s.numel(), sat_set=int(sp.sum()), ok=good))
    return good


def _seed_and_predicate_check(results, case, w, x, seed, kw, y, s):
    """#1 with its seed in device memory, with a true predicate, and again
    by value after a read whose predicate is false (which must neither
    write nor leave the scratch dirty): each bitwise the by-value read
    ``(y, s)``."""
    import torch
    from repro_torch.kernels import noisy_mvm as kn
    seed_t = torch.tensor(seed, dtype=torch.int64, device=DEV)
    go = {v: torch.tensor(v, device=DEV) for v in (True, False)}
    reads = [kn.noisy_mvm(w, x, seed_t, **kw),
             kn.noisy_mvm(w, x, seed_t, go=go[True], **kw)]
    kn.noisy_mvm(w, x, seed_t, go=go[False], **kw)
    reads.append(kn.noisy_mvm(w, x, seed, **kw))
    torch.cuda.synchronize()
    good = all(torch.equal(a, y) and torch.equal(b, s) for a, b in reads)
    print(f"[check] noisy_mvm       {case:<34} device seed, go=1, and by "
          f"value after a go=0 read: bitwise {'ok' if good else 'FAIL'}")
    results.setdefault("checks", []).append(dict(
        kernel="noisy_mvm", case=f"{case} device seed and predicate",
        max_abs_err=0.0 if good else float("inf"), tol=0.0, ok=good))
    return good


def _count_check(results, kernel, case, up, dn, upp, dnp):
    import torch
    torch.cuda.synchronize()
    good = torch.equal(up, upp) and torch.equal(dn, dnp)
    err = float(torch.maximum((up - upp).abs().max(),
                              (dn - dnp).abs().max()))
    print(f"[check] {kernel:<15} {case:<34} counts up {int(upp.sum())} dn "
          f"{int(dnp.sum())} bitwise {'ok' if good else 'FAIL'}")
    results.setdefault("checks", []).append(dict(
        kernel=kernel, case=case, max_abs_err=err, tol=0.0, ok=good))
    return good


def _lenet_reads(seed):
    """(case, w, x, transpose) of the dense reads that the SEPARATE and
    ITERATIVE steps give kernels #1 and #2: K1 and K2 forward over the
    gathered position columns and transposed over the position errors, W3
    and W4 both ways at batch 8.  Rows are scaled 1, 8 and 300 in turn (the
    conv columns per image), so some saturate on one read and some on
    both."""
    import torch
    from repro_torch.core import conv_mapping as cm
    out = []
    for name, vol, k, n_out in CONV_LAYERS:
        geom, w, x = _conv_case(name, vol, k, n_out, 1, seed)
        g = torch.Generator(device=DEV).manual_seed(seed)
        seed += 1
        out += [(f"{name} fwd B={geom.positions}", w,
                 cm.gather_columns(x, geom, 0, geom.positions).contiguous(),
                 False),
                (f"{name} transpose B={geom.positions}", w,
                 _scaled_rows(g, geom.positions, n_out), True)]
    for name, n_in, n_out in DENSE_LAYERS:
        g = torch.Generator(device=DEV).manual_seed(seed)
        seed += 1
        w = (torch.randn(n_out, n_in + 1, generator=g, device=DEV)
             * (n_in + 1) ** -0.5).contiguous()
        out += [(f"{name} fwd B={LENET_BATCH}", w,
                 _scaled_rows(g, LENET_BATCH, n_in + 1), False),
                (f"{name} transpose B={LENET_BATCH}", w,
                 _scaled_rows(g, LENET_BATCH, n_out), True)]
    return out


def _fused_checks(results, kernel, case, calls, fk, fp, w, kw):
    """The fused backward+update ``fk`` against its plain version ``fp``:
    every call of ``calls`` (errors, NM scale, read seeds, update seeds,
    label) is launched first, with no synchronise between them, so a
    later call finds the scratch as the one before left it; then each
    result is held against the plain version: the read within 1e-5 of the
    largest sum |d||w| with equal flags (the first read's saturated rows
    shown beside them), the counts bitwise."""
    got = [fk(d_, n_, rs, us, **kw) for d_, n_, rs, us, _ in calls]
    ok = True
    for (d_, n_, rs, us, label), (z, s, up, dn) in zip(calls, got):
        zp, sp, upp, dnp = fp(d_, n_, rs, us, **kw)
        first = int(fp(d_, n_, rs, us, **dict(kw, two_phase=False))[1].sum())
        mag = float((d_.abs() @ w.abs()).max())
        ok &= _read_check(results, kernel, case + label, z, zp, s, sp, mag,
                          f" first-read sat {first}")
        ok &= _count_check(results, kernel, case + label, up, dn, upp, dnp)
    return ok


def training_kernels_vs_plain(results):
    import torch
    from repro_torch.core import conv_mapping as cm
    from repro_torch.core import update
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import conv_mvm as kc
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    ok = True
    seed = 300
    # #1 raw and #2 managed reads at LeNet's shapes (ITERATIVE, SEPARATE)
    for case, w, x, tr in _lenet_reads(seed):
        seed += 1
        mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
        kw = dict(sigma=SIGMA, alpha=ALPHA, transpose=tr)
        y, s = kn.noisy_mvm(w, x, 0x5EED + seed, **kw)
        yp, sp = kn.noisy_mvm_plain(w, x, 0x5EED + seed, **kw)
        ok &= _read_check(results, "noisy_mvm", case, y, yp, s, sp, mag)
        ok &= _seed_and_predicate_check(results, case, w, x, 0x5EED + seed,
                                        kw, y, s)
        for nm in (False, True):
            nm_s = (x.abs().amax(1, keepdim=True) if nm
                    else torch.ones(x.shape[0], 1, device=DEV))
            mkw = dict(kw, two_phase=True, retry_scale=16.0)
            y, s = km.managed_mvm(w, x, nm_s, (seed, 77), **mkw)
            yp, sp = km.managed_mvm_plain(w, x, nm_s, (seed, 77), **mkw)
            first = int(km.managed_mvm_plain(
                w, x, nm_s, (seed, 77), **dict(mkw, two_phase=False))[1].sum())
            ok &= _read_check(results, "managed_mvm", f"{case} nm={int(nm)}",
                              y, yp, s, sp, mag, f" first-read sat {first}")
    # #3 conv read and #7 conv backward+update
    for name, vol, k, out in CONV_LAYERS:
        for d in ((1, 13) if name == "K2" else (1,)):
            geom, w, x = _conv_case(name, vol, k, out, d, seed)
            seed += 1
            cols = cm.gather_columns(x, geom, 0, geom.positions)
            mag = float((cols.abs() @ w.abs().T).max())
            for nm, tp in ((False, True), (True, True), (False, False),
                           (True, False)):
                case = f"{name} #_d={d} nm={int(nm)} 2p={int(tp)}"
                nm_s = (cm._conv_nm_scale(x, geom) if nm
                        else torch.ones(geom.positions, 1, device=DEV))
                kw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=tp, d_avg=d)
                y, s = kc.conv_managed_mvm(w, x, geom, nm_s, (21, 22), **kw)
                yp, sp = kc.conv_managed_mvm_plain(w, x, geom, nm_s,
                                                   (21, 22), **kw)
                first = int(kc.conv_managed_mvm_plain(
                    w, x, geom, nm_s, (21, 22), **dict(
                        kw, two_phase=False))[1].sum())
                ok &= _read_check(results, "conv_mvm", case, y, yp, s, sp,
                                  mag, f" first-read sat {first}")
            g = torch.Generator(device=DEV).manual_seed(seed)
            dr = _scaled_rows(g, geom.positions, out).repeat(1, d)
            dr2 = _scaled_rows(g, geom.positions, out,
                               (300.0, 1.0, 8.0)).repeat(1, d)
            for nm, tp, bl in ((True, True, 1), (False, True, 1),
                               (False, True, 10), (False, False, 10),
                               (True, False, 10)):
                case = f"{name} #_d={d} nm={int(nm)} 2p={int(tp)} BL={bl}"
                nm_s = (dr.abs().amax(1, keepdim=True) if nm
                        else torch.ones(geom.positions, 1, device=DEV))
                calls = [(dr, nm_s, (31, 32), (41, 42), "")]
                if not nm and tp:  # back to back, no synchronise between
                    calls.append((dr2, nm_s, (33, 34), (43, 44),
                                  " 2nd of 2"))
                    calls[0] = calls[0][:4] + (" 1st of 2",)
                ok &= _fused_checks(
                    results, "conv_bwd_update", case, calls,
                    lambda d_, n_, rs, us, **kw: kb.conv_bwd_update(
                        w, x, d_, geom, n_, rs, us,
                        torch.tensor([0.9, 1.3], device=DEV), **kw),
                    lambda d_, n_, rs, us, **kw: kb.conv_bwd_update_plain(
                        w, x, d_, geom, n_, rs, us,
                        torch.tensor([0.9, 1.3], device=DEV), **kw),
                    w, dict(sigma=SIGMA, alpha=ALPHA, two_phase=tp, bl=bl))
    # #6 dense backward+update
    for name, n_in, out in DENSE_LAYERS:
        g = torch.Generator(device=DEV).manual_seed(seed)
        seed += 1
        w = (torch.randn(out, n_in + 1, generator=g, device=DEV)
             * out ** -0.5).contiguous()
        x = _scaled_rows(g, LENET_BATCH, n_in + 1, (1.0,))
        dd = _scaled_rows(g, LENET_BATCH, out)
        dd2 = _scaled_rows(g, LENET_BATCH, out, (300.0, 1.0, 8.0))
        for nm, tp, bl, row0 in ((True, True, 1, 0), (False, False, 10, 0),
                                 (False, True, 10, 2 ** 32 - 5),
                                 (True, False, 1, 1000), (False, True, 1, 0)):
            case = f"{name} nm={int(nm)} 2p={int(tp)} BL={bl} row0={row0}"
            nm_s = (dd.abs().amax(1, keepdim=True) if nm
                    else torch.ones(LENET_BATCH, 1, device=DEV))
            calls = [(dd, nm_s, (51, 52), (61, 62, row0), "")]
            if not nm and tp and row0 == 0:  # back to back
                calls = [calls[0][:4] + (" 1st of 2",),
                         (dd2, nm_s, (53, 54), (63, 64, 0), " 2nd of 2")]
            ok &= _fused_checks(
                results, "bwd_update_mvm", case, calls,
                lambda d_, n_, rs, us, **kw: kb.bwd_update_mvm(
                    w, d_, x, n_, rs, us,
                    torch.tensor([1.1, 0.7], device=DEV), **kw),
                lambda d_, n_, rs, us, **kw: kb.bwd_update_mvm_plain(
                    w, d_, x, n_, rs, us,
                    torch.tensor([1.1, 0.7], device=DEV), **kw),
                w, dict(sigma=SIGMA, alpha=ALPHA, two_phase=tp, bl=bl))
    # #4 pulse counts of digitally sampled streams
    for case, t, m, n in _count_shapes():
        g = torch.Generator(device=DEV).manual_seed(seed)
        seed += 1
        rows, cols = _streams(g, t, m, n)
        up, dn = kp.pulse_counts(rows, cols)
        upp, dnp = kp.pulse_counts_plain(rows, cols)
        ok &= _count_check(results, "pulse_counts", case, up, dn, upp, dnp)
    check(ok, "a training kernel disagrees with its plain version")


def _count_shapes():
    """(case, T, M, N) of the update cycle's count contractions at LeNet's
    widths and batch 8: BL = 1 (managed) and 10 (nm_bm)."""
    out = []
    for bl in (1, 10):
        out += [(f"K1 BL={bl}", 4608 * bl, 16, 26),
                (f"K2 BL={bl}", 512 * bl, 32, 401),
                (f"W3 BL={bl}", 8 * bl, 128, 513),
                (f"W4 BL={bl}", 8 * bl, 10, 129)]
    out.append(("K2 #_d=13 BL=1", 512, 416, 401))
    return out


def _streams(g, t, m, n):
    """Signed streams of drivers N(0, 1) at gain 0.8, sampled as the update
    cycle samples them (``update.signed_streams``)."""
    import torch
    from repro_torch.core import update
    gain = torch.tensor(0.8, device=DEV)
    rows = update.signed_streams(7, torch.randn(t, m, generator=g,
                                                device=DEV), gain, 1)
    cols = update.signed_streams(8, torch.randn(t, n, generator=g,
                                                device=DEV), gain, 1)
    return rows.reshape(t, m).contiguous(), cols.reshape(t, n).contiguous()


# ---------------------------------------------------------------------------
# (g) LeNet training on the card
# ---------------------------------------------------------------------------

class _PlainCalls:
    """Counts calls of the kernels' plain versions while active (on the
    card every wrapper must launch its kernel instead)."""

    def __init__(self):
        from repro_torch.kernels import (bwd_update_mvm, conv_mvm,
                                         flash_attention, key_schedule,
                                         managed_mvm, noisy_mvm,
                                         pulse_update)
        self.mods = (noisy_mvm, managed_mvm, conv_mvm, pulse_update,
                     bwd_update_mvm, flash_attention, key_schedule)
        self.calls = 0
        self.saved = []

    def __enter__(self):
        for mod in self.mods:
            for name in dir(mod):
                fn = getattr(mod, name)
                if name.endswith("_plain") and callable(fn):
                    self.saved.append((mod, name, fn))
                    setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def wrapper(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return wrapper

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _lenet_images(n, seed):
    import torch
    from repro_torch.data import synthetic_mnist
    x, y = synthetic_mnist.make_dataset(n, seed=seed)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV)


def lenet_train(label, policy, steps, results):
    """``steps`` training steps of the full-width LeNet under ``policy``;
    returns the launches per kind per step."""
    import torch
    from repro_torch.analog import presets
    from repro_torch.kernels import ops
    from repro_torch.models import lenet
    from repro_torch.train import cnn
    from repro_torch.utils import prng

    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    params = lenet.init(prng.key(0), cfg, device=DEV)
    shapes = {n: tuple(params[n].w.shape) for n in lenet.LAYERS}
    xs, ys = _lenet_images((steps + 1) * LENET_BATCH, seed=1)
    step = cnn.make_train_step(cfg)
    k_train = prng.key(2)
    b = LENET_BATCH
    batch = lambda s: (xs[s * b:(s + 1) * b], ys[s * b:(s + 1) * b])
    step(params, *batch(steps), prng.fold_in(k_train, 10 ** 6))  # warm-up
    torch.cuda.synchronize()
    with _PlainCalls() as plain:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for s in range(steps):
            loss = step(params, *batch(s), prng.fold_in(k_train, s))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
    per_step = {k: v / steps for k, v in counts.items() if v}
    print(f"[{label}] {policy}: tiles {shapes}")
    print(f"[{label}] {steps} steps in {dt:.3f}s: {steps / dt:.1f} steps/s, "
          f"{steps * b / dt:.1f} images/s, launches per step {per_step}, "
          f"plain-version calls {plain.calls}, last loss {float(loss):.4f}")
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    check(bool(torch.isfinite(loss)), "non-finite loss")
    for n in lenet.LAYERS:
        w = params[n].w
        check(bool(torch.isfinite(w).all()) and
              bool((w.abs() <= params[n].maps.bound).all()),
              f"{n}: weights not finite or outside the device bounds")
    reads = tuple(k for k in READ_KERNELS if counts[k])
    prof = _profile_step(
        lambda: step(params, *batch(steps), prng.fold_in(k_train, 10 ** 6)),
        f"one {label} step", reads, tuple(k for k in counts if counts[k]))
    results[label] = dict(policy=policy, steps=steps, seconds=dt,
                          steps_per_s=steps / dt,
                          images_per_s=steps * b / dt, launches=counts,
                          per_step=per_step, plain_calls=plain.calls,
                          tiles=shapes, step_profile=prof)
    return counts


def lenet_training(results):
    for name, policy in (("fused", FUSED), ("separate", SEPARATE),
                         ("paper", PAPER)):
        counts = lenet_train(f"train_{name}", policy, LENET_STEPS, results)
        want = {k: v * LENET_STEPS for k, v in PER_STEP[name].items()}
        got = {k: v for k, v in counts.items() if v}
        check(got == want, f"{name}: launches {got}, expected {want}")
        if name != "separate":  # SEPARATE's pulse counts zero by memset
            calls = results[f"train_{name}"]["step_profile"]["analog_calls"]
            n = sum(v for k, v in calls.items() if k.startswith("cudaLaunch"))
            want = sum(PER_STEP[name].values())
            check(n == want and n == sum(calls.values()),
                  f"{name}: one step's analog kernels made {calls}, expected "
                  f"{want} launches and nothing else")
    counts = lenet_train("train_iterative", ITERATIVE, ITERATIVE_STEPS,
                         results)
    n = ITERATIVE_STEPS
    check(counts["pulse_counts"] == 4 * n and counts["noisy_read"] >= 8 * n
          and counts["managed_read"] == counts["managed_read_conv"] == 0
          and counts["bwd_update"] == counts["bwd_update_conv"] == 0,
          f"iterative: launches {counts}, expected 4 pulse_counts and at "
          "least 8 noisy reads per step, nothing else")


# ---------------------------------------------------------------------------
# (g2) the epoch engine: one CUDA graph replay per step
# ---------------------------------------------------------------------------

ENGINE_POLICIES = (("fused", FUSED), ("separate", SEPARATE), ("paper", PAPER),
                   ("iterative", ITERATIVE_A1))
# analog kernel nodes of one captured step (a tiled managed read is two
# kernels: tile and finish; ITERATIVE's 88 raw reads and 4 pulse counts)
GRAPH_ANALOG = {"fused": 8, "paper": 8, "separate": 16, "iterative": 92,
                "grid_2p": 68, "grid_it": 356}
GRID_POLICIES = (("grid_2p", GRID_2P), ("grid_it", GRID_IT_A05))
GRID_STEPS = tuple(name for name, _ in GRID_POLICIES)
# the steps whose pulse counts zero their output by memset
MEMSET_STEPS = ("separate", "iterative") + GRID_STEPS


def _graph_census(graph, path):
    """Nodes of a captured graph from its DOT dump:
    ``{"analog": n, "raw_read": n, "pulse_counts": n, "key_schedule": n,
    "kernel": n, "memset": n, "memcpy": n, "other": n}``.  Analog kernels
    are those of namespace ``analog`` (mangled ``6analog``); raw reads
    (#1) and pulse counts (#4) are among them."""
    import re
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    graph.debug_dump(str(path))
    text = Path(path).read_text()
    census = dict(analog=0, raw_read=0, pulse_counts=0, key_schedule=0,
                  kernel=0, memset=0, memcpy=0, other=0)
    for label in re.findall(r'label="\{(.*?)"\]', text, flags=re.S):
        head = label.upper()
        if "MEMSET" in head:
            census["memset"] += 1
        elif "MEMCPY" in head:
            census["memcpy"] += 1
        elif "KERNEL" in head:
            census["kernel"] += 1
            census["key_schedule"] += "key_schedule_kernel" in label
            census["raw_read"] += ("raw_gemv_kernel" in label
                                   or "raw_tile_kernel" in label)
            census["pulse_counts"] += "pulse_counts_kernel" in label
            census["analog"] += ("6analog" in label or "analog::" in label)
        else:
            census["other"] += 1
    return census


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def engine_parity(name, policy, results):
    """20 steps through ``engine="python"`` (twice, to show the loop
    deterministic) and through ``engine="scan"`` from the same tiles, keys
    and batches: every tile bitwise equal; the key-schedule kernel's tables
    bitwise its plain evaluator for each of those steps; the captured
    step's nodes; then one more epoch of each engine, timed, and one
    replayed step profiled beside one loop step."""
    import torch
    from repro_torch.analog import presets
    from repro_torch.kernels import key_schedule as ks
    from repro_torch.kernels import ops
    from repro_torch.models import lenet
    from repro_torch.train import cnn, engine
    from repro_torch.utils import prng

    label = f"engine_{name}"
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    xs, ys = _lenet_images(LENET_STEPS * LENET_BATCH, seed=1)
    k_data, k_train = prng.key(3), prng.key(2)
    step = cnn.make_train_step(cfg)
    loops = []
    with _PlainCalls() as plain:
        for _ in range(2):
            p = lenet.init(prng.key(0), cfg, device=DEV)
            cnn.python_epoch(step, p, xs, ys, k_data, k_train, 0,
                             LENET_BATCH)
            loops.append(p)
    torch.cuda.synchronize()
    same = {n: torch.equal(loops[0][n].w, loops[1][n].w) for n in lenet.LAYERS}
    print(f"[{label}] loop twice from one state, bitwise equal: {same}; "
          f"plain-version calls {plain.calls}")
    check(all(same.values()), f"{name}: the loop differs from itself")
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")

    p_scan = lenet.init(prng.key(0), cfg, device=DEV)
    run = engine.make_cnn_epoch_fn(cfg, batch=LENET_BATCH)
    with _PlainCalls() as plain:
        ops.reset_launch_counts()
        build_s = _timed(lambda: run(p_scan, xs, ys, k_data, k_train, 0))
        counts = ops.launch_counts()
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    equal = {n: torch.equal(loops[0][n].w, p_scan[n].w) for n in lenet.LAYERS}
    prog = run.program
    print(f"[{label}] {LENET_STEPS} graphed steps (capture included, "
          f"{build_s:.2f}s) vs {LENET_STEPS} loop steps, every tile bitwise "
          f"equal: {equal}; launches (the warm-up step's and "
          f"{LENET_STEPS} replays') { {k: v for k, v in counts.items() if v} }"
          f", per replay {prog.captured}")
    check(all(equal.values()), f"{name}: graphed steps differ from the loop")
    # the warm-up step that records the tape launches one step's kernels
    # through the wrappers; each replay launches what its capture recorded
    per_replay = dict(PER_STEP[name], key_schedule=1)
    check(prog.captured == per_replay,
          f"{name}: the capture recorded {prog.captured}, expected "
          f"{per_replay}")
    want = {k: LENET_STEPS * v + PER_STEP[name].get(k, 0)
            for k, v in per_replay.items()}
    check({k: v for k, v in counts.items() if v} == want,
          f"{name}: the epoch launched {counts}, expected {want}")

    tape = prog.tape
    n_keys, n_seeds = len(tape.recorded[0]) + 1, len(tape.recorded[2])
    err = 0
    for s in range(LENET_STEPS):
        prog.ctr[1].fill_(s)
        ks.key_schedule(tape, prog.base, prog.ctr[1])
        keys, seeds = ks.evaluate_plain(tape, k_train, s)
        got_k = tape.keys[:n_keys].cpu().tolist()
        got_s = tape.seeds[:n_seeds].cpu().tolist()
        err = max([err] + [abs(a - b) for ka, kb in zip(got_k, keys)
                           for a, b in zip(ka, kb)]
                  + [abs(a - b) for a, b in zip(got_s, seeds)])
    print(f"[{label}] key tape: {n_keys - 1} derivations, {n_seeds} seeds, "
          f"{tape.program()[4]} levels; kernel tables vs plain evaluator over "
          f"{LENET_STEPS} steps: max |diff| {err}")
    check(err == 0, f"{name}: the key-schedule kernel disagrees with its "
          "plain evaluator")
    census = _graph_census(prog.graph,
                           ROOT / "build" / "graphs" / f"{name}.dot")
    print(f"[{label}] captured step's nodes: {census}")
    check(census["key_schedule"] == 1
          and census["analog"] == GRAPH_ANALOG[name]
          and census["raw_read"] == PER_STEP[name].get("noisy_read", 0)
          and census["pulse_counts"] == PER_STEP[name].get(
              "pulse_counts", 0),
          f"{name}: the captured step holds {census}")
    if name not in MEMSET_STEPS:
        check(census["memset"] == census["memcpy"] == 0,
              f"{name}: the captured step holds a memset or copy: {census}")
    if name in GRID_STEPS:
        # #4 zeroes its two outputs by memset; nothing else copies or
        # zeroes, so no block read brings a copy or a memset
        check(census["memcpy"] == 0
              and census["memset"] == 2 * census["pulse_counts"],
              f"{name}: the captured step holds {census['memset']} memsets "
              f"and {census['memcpy']} copies, expected only the pulse "
              "counts' two memsets each")

    # one more epoch of each engine, timed (both warm)
    loop_s = _timed(lambda: cnn.python_epoch(step, loops[0], xs, ys, k_data,
                                             k_train, 1, LENET_BATCH))
    scan_s = _timed(lambda: run(p_scan, xs, ys, k_data, k_train, 1))
    equal2 = all(torch.equal(loops[0][n].w, p_scan[n].w)
                 for n in lenet.LAYERS)
    rate = {k: dict(steps_per_s=LENET_STEPS / t,
                    images_per_s=LENET_STEPS * LENET_BATCH / t, seconds=t)
            for k, t in (("python", loop_s), ("scan", scan_s))}
    print(f"[{label}] epoch 2, {LENET_STEPS} steps: python "
          f"{rate['python']['steps_per_s']:.1f} steps/s "
          f"{rate['python']['images_per_s']:.1f} images/s, scan "
          f"{rate['scan']['steps_per_s']:.1f} steps/s "
          f"{rate['scan']['images_per_s']:.1f} images/s; tiles still bitwise "
          f"equal: {equal2}")
    check(equal2, f"{name}: the engines part in their second epoch")

    prog.ctr.copy_(torch.tensor([0, 2 * prog.spe]))
    replay = _profile_step(prog.run, f"one replayed {name} step")
    recs = {k: sum(n for kern, n in replay.get("kernels", {}).items()
                   if any(w in kern for w in words))
            for k, words in (("analog", ("analog::",)),
                             ("key_schedule", ("key_schedule",)),
                             ("memset_or_copy", ("Memset", "Memcpy")))}
    print(f"[{label}] the profiler's records of that replay: {recs} (it "
          "may drop records; the graph's nodes above are the check)")
    x8, y8 = xs[:LENET_BATCH], ys[:LENET_BATCH]
    loop = _profile_step(
        lambda: step(loops[0], x8, y8, prng.fold_in(k_train, 10 ** 6)),
        f"one {name} loop step")
    results[label] = dict(policy=policy, steps=LENET_STEPS, tiles_equal=True,
                          loop_deterministic=True, launches=counts,
                          per_replay=prog.captured,
                          capture_s=build_s, key_tape=dict(
                              derivations=n_keys - 1, seeds=n_seeds,
                              max_abs_err=err),
                          graph_nodes=census, replay_records=recs,
                          rates=rate, replayed_step=replay, loop_step=loop)
    return tape, prog


def lenet_engines(results):
    for name, policy in ENGINE_POLICIES:
        tape, prog = engine_parity(name, policy, results)
        if name == "fused":
            key_schedule_time(results, tape, prog)
    engine_retries(ITERATIVE_A1, results)


def lenet_grid_engines(results):
    """(g3) the full-width LeNet on a 2x2 grid of sub-tiles under GRID_2P
    and GRID_IT_A05 through both engines (``engine_parity``), the retries of
    the graphed iterative grid steps, and one GRID_2P step on the card
    against the CPU."""
    for name, policy in GRID_POLICIES:
        engine_parity(name, policy, results)
    engine_retries(GRID_IT_A05, results, label="engine_retries_grid")
    step_vs_cpu("GRID_2P", GRID_2P, "grid_step_reference", results)


def engine_retries(policy, results, label="engine_retries"):
    """Iterative BM's retries in graphed steps: from the same tiles, two
    epochs of each engine with the retry counter on
    (``management.count_retries``); the second epoch's counts (the graph's
    20 replays; its warm-up step is in the first) equal, and not zero, and
    every tile bitwise equal."""
    import torch
    from repro_torch.analog import presets
    from repro_torch.core import management
    from repro_torch.models import lenet
    from repro_torch.train import cnn, engine
    from repro_torch.utils import prng

    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    xs, ys = _lenet_images(LENET_STEPS * LENET_BATCH, seed=4)
    k_data, k_train = prng.key(5), prng.key(6)
    step = cnn.make_train_step(cfg)
    p_loop = lenet.init(prng.key(1), cfg, device=DEV)
    p_scan = lenet.init(prng.key(1), cfg, device=DEV)
    run = engine.make_cnn_epoch_fn(cfg, batch=LENET_BATCH)
    loop_n, scan_n = (management.count_retries(DEV) for _ in range(2))
    counts = []
    for epoch in (0, 1):
        with loop_n:
            cnn.python_epoch(step, p_loop, xs, ys, k_data, k_train, epoch,
                             LENET_BATCH)
        with scan_n:
            run(p_scan, xs, ys, k_data, k_train, epoch)
        torch.cuda.synchronize()
        counts.append((int(loop_n.n), int(scan_n.n)))
        loop_n.n.zero_()
        scan_n.n.zero_()
    equal = {k: torch.equal(p_loop[k].w, p_scan[k].w) for k in lenet.LAYERS}
    (loop0, scan0), (loop1, scan1) = counts
    print(f"[{label}] {policy}: BM retries, epoch 1 loop {loop0} / "
          f"graph {scan0} (its warm-up step included); epoch 2 loop "
          f"{loop1} / graph {scan1} ({LENET_STEPS} replays); tiles bitwise "
          f"equal after 2 epochs: {equal}")
    results[label] = dict(policy=policy, counts=counts, tiles_equal=equal)
    check(all(equal.values()), "iterative: graphed steps differ from the "
          "loop in the counted epochs")
    check(loop1 == scan1 > 0,
          f"iterative: {scan1} retries in the graph's epoch, {loop1} in the "
          "loop's (they must be equal and not zero)")
    return run


# ---------------------------------------------------------------------------
# (g4) streaming chunks: chunked steps against the materialized ones
# ---------------------------------------------------------------------------

# at batch 8: K1's 4608 positions in 12 chunks of 384, K2's 512 in 2 (the
# last 128), the 8 update rows of W3 and W4 in chunks of 3 (3, 3, 2)
STREAM = ":conv_stream_chunk=384:update_chunk=3"
BL10_2P = "nm_bm:use_pallas=true:bm_mode=two_phase"
ITERATIVE_NF = ITERATIVE_A1 + ":read_noise=0"
STREAM_POLICIES = (("separate", SEPARATE), ("bl10_2p", BL10_2P),
                   ("grid_2p", GRID_2P))
# launches per chunked step: the conv reads take every column in one
# launch; a transpose pass reads K1 in 12 chunks, K2 in 2; an update is
# one #4 launch per chunk (K1 12, K2 2, W3 3, W4 3)
_SEP_STREAM = {"managed_read": 2 + 12 + 2 + 2, "managed_read_conv": 2,
               "pulse_counts": 20}
STREAM_PER_STEP = {
    "separate": _SEP_STREAM, "bl10_2p": _SEP_STREAM,
    # 32 managed reads (K1 12 + 12, K2 2 + 2, W3 2, W4 2) x 2 two-phase
    # reads x 4 blocks
    "grid_2p": {"noisy_read": 256, "pulse_counts": 20},
    # the fused kernels take every column whatever the chunk
    "fused": PER_STEP["fused"],
    # 32 reads x 11 predicated raw reads (x 4 blocks on the grid)
    "iterative": {"noisy_read": 352, "pulse_counts": 20},
    "grid_it": {"noisy_read": 1408, "pulse_counts": 20},
}
# analog kernel nodes of a captured chunked step: a tiled managed read is
# two kernels, the gemv one (W3's and W4's forward at B = 8)
STREAM_GRAPH_ANALOG = {"separate": 56, "bl10_2p": 56, "grid_2p": 276,
                       "fused": 8}
# the memory check: batch 1024, materialized against these chunks
MEM_BATCH, MEM_STREAM = 1024, ":conv_stream_chunk=4096:update_chunk=256"


def _graphed_epochs(policy, epochs=2):
    """``epochs`` epochs of ``LENET_STEPS`` graphed steps from g2's tiles,
    keys and batches: the tiles after the first epoch, the launches of
    that epoch (warm-up step and replays), its program and the steps/s of
    the last epoch (None for one epoch)."""
    import torch
    from repro_torch.analog import presets
    from repro_torch.kernels import ops
    from repro_torch.models import lenet
    from repro_torch.train import engine
    from repro_torch.utils import prng
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    xs, ys = _lenet_images(LENET_STEPS * LENET_BATCH, seed=1)
    p = lenet.init(prng.key(0), cfg, device=DEV)
    run = engine.make_cnn_epoch_fn(cfg, batch=LENET_BATCH)
    with _PlainCalls() as plain:
        ops.reset_launch_counts()
        run(p, xs, ys, prng.key(3), prng.key(2), 0)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    tiles = {n: p[n].w.detach().clone() for n in lenet.LAYERS}
    rate = None
    for epoch in range(1, epochs):
        dt = _timed(lambda: run(p, xs, ys, prng.key(3), prng.key(2), epoch))
        rate = LENET_STEPS / dt
    return tiles, counts, run.program, rate


def _loop_epoch(policy):
    """One epoch of the per-step loop (``engine="python"``) from the same
    tiles, keys and batches as :func:`_graphed_epochs`: the tiles."""
    from repro_torch.analog import presets
    from repro_torch.models import lenet
    from repro_torch.train import cnn
    from repro_torch.utils import prng
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    xs, ys = _lenet_images(LENET_STEPS * LENET_BATCH, seed=1)
    p = lenet.init(prng.key(0), cfg, device=DEV)
    with _PlainCalls() as plain:
        cnn.python_epoch(cnn.make_train_step(cfg), p, xs, ys, prng.key(3),
                         prng.key(2), 0, LENET_BATCH)
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    return {n: p[n].w for n in lenet.LAYERS}


def _equal(a, b):
    import torch
    return {n: torch.equal(a[n], b[n]) for n in a}


def stream_chunk_reads(results):
    """#1, #2 and #4 on chunks of a read or an update against the whole
    one on the card, bitwise: the raw read of K1's columns (4608 rows) and
    the managed transpose read of K2's errors (512 rows, two-phase BM) in
    chunks of 384 and a last short chunk (below the gemv's 8 rows among
    them), each with its rows' offset and the whole read's row count; the
    counts of K1's streams (BL 10) chunk by chunk into one pair of
    outputs."""
    import torch
    from repro_torch.kernels import managed_mvm, noisy_mvm, ops
    from repro_torch.kernels import pulse_update as pk
    g = torch.Generator(device=DEV).manual_seed(41)
    rows = []

    def chunks(total):
        return [(0, 384), (384, 7), (total - 5, 5)]

    w1 = (torch.randn(16, 26, generator=g, device=DEV) * 0.3).contiguous()
    x1 = torch.randn(4608, 26, generator=g, device=DEV)
    kw1 = dict(sigma=0.06, alpha=3.0, n_seg=1)
    y, s = noisy_mvm.noisy_mvm(w1, x1, 5, **kw1)
    ok1 = all(
        torch.equal(yc, y[a:a + n]) and torch.equal(sc, s[a:a + n])
        for a, n in chunks(4608)
        for yc, sc in [noisy_mvm.noisy_mvm(w1, x1[a:a + n].contiguous(), 5,
                                           row_offset=a, total_rows=4608,
                                           **kw1)])
    w2 = (torch.randn(32, 401, generator=g, device=DEV) * 0.3).contiguous()
    d2 = torch.randn(512, 32, generator=g, device=DEV)
    nm = d2.abs().amax(dim=1, keepdim=True)
    kw2 = dict(sigma=0.06, alpha=0.05, transpose=True, two_phase=True)
    z, r = managed_mvm.managed_mvm(w2, d2, nm, (6, 7), **kw2)
    ok2 = all(
        torch.equal(zc, z[a:a + n]) and torch.equal(rc, r[a:a + n])
        for a, n in chunks(512)
        for zc, rc in [managed_mvm.managed_mvm(
            w2, d2[a:a + n].contiguous(), nm[a:a + n].contiguous(), (6, 7),
            row_offset=a, total_rows=512, **kw2)])
    sa = (torch.rand(46080, 26, generator=g, device=DEV) < 0.3).float()
    sb = torch.sign(torch.randn(46080, 16, generator=g, device=DEV)) * (
        torch.rand(46080, 16, generator=g, device=DEV) < 0.3).float()
    up, dn = ops.pulse_counts(sb, sa)
    acc = None
    for a in range(0, 46080, 3840):
        acc = pk.pulse_counts(sb[a:a + 3840], sa[a:a + 3840], acc)
    ok4 = torch.equal(acc[0], up) and torch.equal(acc[1], dn)
    torch.cuda.synchronize()
    sat = int(s.sum()), int(r.sum())
    print(f"[stream_reads] chunks of a read vs the whole read, bitwise: #1 "
          f"K1 4608x26->16 {ok1}, #2 K2 transpose 512 rows two-phase {ok2} "
          f"(saturated rows {sat}); #4 K1 BL 10 counts in 12 accumulated "
          f"launches vs one {ok4}")
    results["stream_reads"] = dict(noisy_read=ok1, managed_read=ok2,
                                   pulse_counts=ok4, saturated=sat)
    check(ok1 and ok2 and ok4, "a chunk of a read or an update differs from "
          "the whole one on the card")
    check(min(sat) > 0, "the chunked reads saturate nowhere")
    for kernel, case, err in (("noisy_mvm", "K1 chunk rows vs whole", ok1),
                              ("managed_mvm", "K2ᵀ chunk rows vs whole", ok2),
                              ("pulse_counts", "K1 accumulated chunks", ok4)):
        results.setdefault("checks", []).append(dict(
            kernel=kernel, case=case, max_abs_err=0.0 if err else 1.0,
            tol=0.0))


def stream_engines(results):
    """(g4) the streaming chunks (``STREAM``) on the full-width LeNet: for
    SEPARATE, BL-10 two-phase BM and GRID_2P, 20 graphed chunked steps
    bitwise 20 graphed materialized ones and 20 chunked loop steps, the
    captured chunked step's launches and nodes (no memset or copy beyond
    the materialized step's), both engines' steps/s; FUSED with chunks
    bitwise FUSED at its 8 analog launches; ITERATIVE and GRID_IT with
    chunks graphed bitwise the loop with retries counted (g2's
    ``engine_retries``), noise-free iterative chunked bitwise materialized;
    one chunked SEPARATE step on the card against the CPU; the peak memory
    of a materialized and a chunked step at batch 1024."""
    stream_chunk_reads(results)
    graphs = ROOT / "build" / "graphs"
    for name, policy in STREAM_POLICIES + (("fused", FUSED),):
        label = f"stream_{name}"
        mat, mat_counts, mat_prog, mat_rate = _graphed_epochs(policy)
        got, counts, prog, rate = _graphed_epochs(policy + STREAM)
        same = _equal(got, mat)
        loop = None if name == "fused" else _equal(got, _loop_epoch(
            policy + STREAM))
        want = dict(STREAM_PER_STEP[name], key_schedule=1)
        census = _graph_census(prog.graph, graphs / f"{label}.dot")
        base = _graph_census(mat_prog.graph, graphs / f"{label}_mat.dot")
        print(f"[{label}] {policy}{STREAM}: {LENET_STEPS} graphed chunked "
              f"steps vs {LENET_STEPS} graphed materialized, bitwise "
              f"{same}; vs {LENET_STEPS} chunked loop steps {loop}; per "
              f"replay {prog.captured} (materialized {mat_prog.captured}); "
              f"nodes {census} (materialized {base}); scan steps/s chunked "
              f"{rate:.1f}, materialized {mat_rate:.1f}")
        results[label] = dict(policy=policy + STREAM, equal=same, loop=loop,
                              per_replay=prog.captured, launches=counts,
                              graph_nodes=census, graph_nodes_mat=base,
                              steps_per_s=rate, steps_per_s_mat=mat_rate)
        check(all(same.values()), f"{name}: chunked steps differ from the "
              "materialized steps")
        check(loop is None or all(loop.values()),
              f"{name}: graphed chunked steps differ from the loop's")
        check(prog.captured == want, f"{name}: the chunked capture recorded "
              f"{prog.captured}, expected {want}")
        check(census["analog"] == STREAM_GRAPH_ANALOG[name]
              and census["raw_read"] == want.get("noisy_read", 0)
              and census["pulse_counts"] == want.get("pulse_counts", 0),
              f"{name}: the chunked step's nodes {census}")
        check(census["memset"] <= base["memset"]
              and census["memcpy"] <= base["memcpy"],
              f"{name}: the chunked step holds more memsets or copies "
              f"({census}) than the materialized one ({base})")
    # iterative BM: retries chunk-local, graphed = loop, counted
    for name, policy in (("iterative", ITERATIVE_A1),
                         ("grid_it", GRID_IT_A05)):
        run = engine_retries(policy + STREAM, results,
                             label=f"stream_retries_{name}")
        want = dict(STREAM_PER_STEP[name], key_schedule=1)
        captured = run.program.captured
        print(f"[stream_{name}] per replay {captured}")
        results[f"stream_retries_{name}"]["per_replay"] = captured
        check(captured == want, f"{name}: the chunked capture recorded "
              f"{captured}, expected {want}")
    nf, _, _, _ = _graphed_epochs(ITERATIVE_NF, epochs=1)
    nf_c, nf_counts, _, _ = _graphed_epochs(ITERATIVE_NF + STREAM, epochs=1)
    same = _equal(nf_c, nf)
    results["stream_iterative"] = dict(policy=ITERATIVE_NF + STREAM,
                                       launches=nf_counts, equal=same)
    print(f"[stream_noise_free] {ITERATIVE_NF}: graphed chunked vs "
          f"materialized, bitwise {same}; launches {nf_counts}")
    check(all(same.values()), "noise-free iterative chunked steps differ "
          "from the materialized ones")
    step_vs_cpu("SEPARATE chunked", SEPARATE + STREAM,
                "stream_step_reference", results)
    stream_memory(results)


def stream_memory(results):
    """Peak allocated device memory of one loop step and of one capture
    plus replay (``make_cnn_epoch_fn`` over one batch) at batch 1024 under
    BL-10 two-phase BM, materialized against ``MEM_STREAM``."""
    import gc
    import torch
    from repro_torch.analog import presets
    from repro_torch.models import lenet
    from repro_torch.train import cnn, engine
    from repro_torch.utils import prng
    xs, ys = _lenet_images(MEM_BATCH, seed=7)
    peaks = {}
    for label, policy in (("materialized", BL10_2P),
                          ("chunked", BL10_2P + MEM_STREAM)):
        cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
        row = {}
        for what in ("loop", "graph"):
            p = lenet.init(prng.key(0), cfg, device=DEV)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if what == "loop":
                cnn.make_train_step(cfg)(p, xs, ys, prng.key(1))
            else:
                run = engine.make_cnn_epoch_fn(cfg, batch=MEM_BATCH)
                run(p, xs, ys, prng.key(3), prng.key(2), 0)
            torch.cuda.synchronize()
            row[what] = dict(peak=torch.cuda.max_memory_allocated(),
                             above_start=torch.cuda.max_memory_allocated()
                             - base, seconds=time.perf_counter() - t0)
            del p
            run = None
        peaks[label] = row
        print(f"[stream_memory] {policy}, batch {MEM_BATCH}: one loop step "
              f"peak {row['loop']['peak'] / 2**20:.1f} MiB "
              f"({row['loop']['above_start'] / 2**20:.1f} above its start), "
              f"capture + replay peak {row['graph']['peak'] / 2**20:.1f} MiB "
              f"({row['graph']['above_start'] / 2**20:.1f} above)")
    results["stream_memory"] = dict(batch=MEM_BATCH, peaks=peaks)
    for what in ("loop", "graph"):
        check(peaks["chunked"][what]["peak"]
              < peaks["materialized"][what]["peak"],
              f"chunked {what} peak {peaks['chunked'][what]['peak']} not "
              f"below the materialized {peaks['materialized'][what]['peak']}")


def _key_schedule_work(tape):
    """``(bytes, operations)`` of one evaluation of ``tape``.  Bytes: base,
    counter, the tape (parent, data, level, seed slots), keys and seeds
    out; operations: 77 integer operations per threefry block (20 rounds
    of add, rotate, xor; 5 key injections; 2 initial adds) and 14 per seed
    (two splitmix32 finalizers), each charged as one operation at the fp32
    rate (no int32 peak is used here; the card's int32 rate is lower, so
    this bound is a lower one)."""
    n_ops, n_seeds = len(tape.recorded[0]), len(tape.recorded[2])
    byts = 16 + 8 + 12 * n_ops + 4 * n_seeds + 16 * (n_ops + 1) + 8 * n_seeds
    return byts, 77 * (n_ops + 1) + 14 * n_seeds


def key_schedule_time(results, tape, prog):
    """The key-schedule kernel at the FUSED step's tape: its time, its plain
    evaluator's (host Python), its bound; its check row (the largest
    difference of g2's table comparisons)."""
    from repro_torch.kernels import key_schedule as ks
    counter = prog.ctr[1]
    _time_row(results.setdefault("times", []), "key_schedule",
              "LeNet FUSED step",
              lambda: ks.key_schedule(tape, prog.base, counter),
              lambda: ks.evaluate_plain(tape, (0, 2), 0), None,
              *_key_schedule_work(tape), 0.0, batch=None)
    results.setdefault("checks", []).append(dict(
        kernel="key_schedule", case="LeNet FUSED step, 20 steps",
        max_abs_err=float(results["engine_fused"]["key_tape"]["max_abs_err"]),
        tol=0.0))


# ---------------------------------------------------------------------------
# (p1) the paper's figure pair 1 against the JAX package's seed band
# ---------------------------------------------------------------------------

def figure_pair(results):
    """fig3a_baseline and fig3b_nm_bm at the band protocol, seed 0, through
    the suite's command-line path (``cnn_suite.run_one``: the kernels, the
    epoch engine): fig3b_nm_bm inside its JAX band, the pair in JAX's
    order."""
    from repro_torch.benchmarks import bands, cnn_suite
    pair = cnn_suite.PAIRS[0]
    port, runs = {}, {}
    for name in pair:
        r = cnn_suite.run_one(name, 0, "band",
                              out=str(ROOT / "chiprun_out" / "figure_pair"),
                              device=DEV)
        port[name] = [r["mean_last5"]]
        runs[name] = dict(test_error=r["test_error"],
                          mean_last5=r["mean_last5"],
                          steps_per_s=r["steps_per_sec"],
                          seconds=r["wallclock_s"], kernels=r["kernels"])
        print(f"[figure_pair] {name}: test error per epoch "
              f"{[round(e, 4) for e in r['test_error']]}, mean_last5 "
              f"{r['mean_last5']:.4f}, {r['steps_per_sec']:.1f} steps/s "
              f"(training and evaluation, captures included), "
              f"{r['wallclock_s']:.1f}s")
    v = bands.decide(pair, port, bands.load())
    print(f"[figure_pair] {bands.describe(v)}")
    results["figure_pair"] = dict(runs=runs, verdict=v)
    check(v["in_band"][1], f"{pair[1]} {v['port'][1]:.4f} outside its JAX "
          f"band {v['band_b']}")
    check(v["order_ok"], f"{pair}: the port's order {v['port']} is not "
          f"JAX's {v['jax']}")


# ---------------------------------------------------------------------------
# (h) learning
# ---------------------------------------------------------------------------

def lenet_learning(results):
    from repro_torch.analog import presets
    from repro_torch.models import lenet
    from repro_torch.train import cnn
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(LEARN))
    r = cnn.train(cfg, epochs=2, batch=LENET_BATCH, n_train=1024,
                  n_test=256, seed=0, device=DEV, engine="scan")
    print(f"[learn] {LEARN}, engine {r['engine']}: test error per epoch "
          f"{r['test_error']}, {r['steps_per_sec']:.1f} steps/s (training "
          "and evaluation, the graphs' capture included)")
    results["learn"] = dict(policy=LEARN, engine=r["engine"],
                            test_error=r["test_error"],
                            steps_per_s=r["steps_per_sec"],
                            seconds=r["wallclock_s"])
    check(r["final_error"] < 0.4,
          f"final test error {r['final_error']} is not below 0.4")


# ---------------------------------------------------------------------------
# (k) kill and resume
# ---------------------------------------------------------------------------

RESUME_EPOCHS, RESUME_TRAIN, RESUME_TEST = 3, 512, 256
RESUME_TIMEOUT_S = 300
RESUME_DIR = ROOT / "build" / "resume"
_RESUME_ENV = ("REPRO_FAULT_MODE", "REPRO_FAULT_STEP", "REPRO_FAULT_DROP",
               "REPRO_CKPT_WRITE_DELAY")
SIGKILL_AT_2 = {"REPRO_FAULT_MODE": "sigkill", "REPRO_FAULT_STEP": 2}
# step 2's write held open (0.2 s a leaf, 20 leaves) while the kill lands
MID_SAVE_AT_1 = {"REPRO_FAULT_MODE": "sigkill_mid_save",
                 "REPRO_FAULT_STEP": 1, "REPRO_CKPT_WRITE_DELAY": 0.2}
# (name, policy, ckpt dir, killed by, resumed under): the oracle of a policy
# is its scan run without a fault; every other run is killed under scan
# and restarted under the engine named
RESUME_RUNS = (
    ("fused_oracle", FUSED, "fused_oracle", None, None),
    ("fused_kill_scan", FUSED, "fused_a", SIGKILL_AT_2, "scan"),
    ("fused_kill_python", FUSED, "fused_b", SIGKILL_AT_2, "python"),
    ("fused_mid_save", FUSED, "fused_c", MID_SAVE_AT_1, "scan"),
    ("iterative_oracle", ITERATIVE_A1, "iterative_oracle", None, None),
    ("iterative_kill_scan", ITERATIVE_A1, "iterative_a", SIGKILL_AT_2,
     "scan"),
)


def resume_worker(policy, engine, ckpt_dir, device):
    """One ``cnn.train`` run with checkpoints (a subprocess of phase k):
    prints its launches, plain-version calls and history as JSON."""
    from repro_torch.analog import presets
    from repro_torch.kernels import ops
    from repro_torch.models import lenet
    from repro_torch.train import cnn
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    with _PlainCalls() as plain:
        r = cnn.train(cfg, epochs=RESUME_EPOCHS, batch=LENET_BATCH,
                      n_train=RESUME_TRAIN, n_test=RESUME_TEST, seed=0,
                      engine=engine, ckpt_dir=ckpt_dir, device=device)
    print("[resume_worker] " + json.dumps(dict(
        launches=ops.launch_counts(), plain_calls=plain.calls,
        history=r["test_error"], seconds=r["wallclock_s"])), flush=True)


def _start_resume(name, policy, engine, ckpt_dir, env=None):
    import os
    e = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    for k in _RESUME_ENV:
        e.pop(k, None)
    e.update({k: str(v) for k, v in (env or {}).items()})
    code = (f"import chip_smoke; chip_smoke.resume_worker({policy!r}, "
            f"{engine!r}, {str(ckpt_dir)!r}, {DEV!r})")
    with open(RESUME_DIR / f"{name}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                                env=e, stdout=log, stderr=subprocess.STDOUT)


def _run_stage(runs):
    """Start every run of a stage at once (one process each, all on the
    one card), each under its own timeout, and wait for all; returns
    {name: output}.  A run that outlives its timeout or ends otherwise
    than it should (SIGKILL where a fault was set, exit 0 where none was)
    fails the phase."""
    import signal
    procs = {}
    try:
        for name, policy, engine, ckpt_dir, env in runs:
            procs[name] = (_start_resume(name, policy, engine, ckpt_dir,
                                         env), time.perf_counter())
        outs = {}
        for name, _, _, _, env in runs:
            proc, t0 = procs[name]
            try:
                proc.wait(timeout=max(
                    1.0, t0 + RESUME_TIMEOUT_S - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise PhaseError(f"{name}: no end within "
                                 f"{RESUME_TIMEOUT_S}s") from None
            outs[name] = (RESUME_DIR / f"{name}.log").read_text()
            want = -signal.SIGKILL if env is not None else 0
            check(proc.returncode == want,
                  f"{name}: exit {proc.returncode}, expected {want}\n"
                  f"{outs[name][-3000:]}")
        return outs
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _worker_report(name, out):
    """The run's report line, checked: no plain-version call, kernels
    launched."""
    line = next((ln for ln in out.splitlines()
                 if ln.startswith("[resume_worker] ")), None)
    check(line is not None, f"{name}: no report line\n{out[-1500:]}")
    rep = json.loads(line.split(" ", 1)[1])
    check(rep["plain_calls"] == 0,
          f"{name}: {rep['plain_calls']} plain-version calls on the card")
    check(sum(rep["launches"].values()) > 0, f"{name}: no kernel launched")
    return rep


def _ckpt_fingerprint(ckpt_dir, step):
    with open(Path(ckpt_dir) / f"step_{step:010d}" / "index.json") as f:
        idx = json.load(f)
    return ([(e["key"], tuple(e["shape"]), e["dtype"], e["crc32"])
             for e in idx["leaves"]], idx["meta"]["history"])


def _readback(policy, ckpt_dir, results):
    """The card-written final checkpoint restored onto the CPU and onto the
    card: bitwise equal; saved again from the card: the same bytes."""
    import torch
    from repro_torch.analog import presets
    from repro_torch.checkpoint import store
    from repro_torch.models import lenet
    from repro_torch.utils import prng
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    like = (lenet.init(prng.key(0), cfg, device=DEV), ())
    (on_cpu, _), _ = store.restore(str(ckpt_dir), RESUME_EPOCHS, like,
                                   device="cpu")
    (on_card, _), meta = store.restore(str(ckpt_dir), RESUME_EPOCHS, like,
                                       device=DEV)
    for n in lenet.LAYERS:
        a, b = on_cpu[n], on_card[n]
        for f, x, y in [("w", a.w, b.w)] + [
                (f, getattr(a.maps, f), getattr(b.maps, f))
                for f in ("dw_up", "dw_dn", "bound")]:
            check(x.device.type == "cpu"
                  and y.device.type == torch.device(DEV).type
                  and torch.equal(x, y.cpu()),
                  f"{n}.{f}: restored on the CPU and on the card differ")
        check(a.seed == b.seed, f"{n}: seeds differ")
    again = RESUME_DIR / "readback"
    store.save(str(again), RESUME_EPOCHS, (on_card, ()), meta)
    same = (_ckpt_fingerprint(again, RESUME_EPOCHS)
            == _ckpt_fingerprint(ckpt_dir, RESUME_EPOCHS))
    check(same, "the card's restore saved again gives other bytes")
    results["resume"]["readback"] = dict(resaved_equal=same)
    print(f"[resume] readback of {Path(ckpt_dir).name}/step_"
          f"{RESUME_EPOCHS:010d}: restored on the CPU and on the card "
          "bitwise equal; saved again from the card, the same crc32 per "
          "leaf")


def kill_and_resume(results):
    """Stage 1: the two oracles and four runs killed under scan; stage 2:
    each killed run restarted (under scan, or python), resuming from its
    newest complete checkpoint.  Every final checkpoint's per-leaf (key,
    shape, dtype, crc32) and history equal its oracle's."""
    import shutil
    from repro_torch.checkpoint import store
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    RESUME_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    outs = _run_stage([(name, policy, "scan", RESUME_DIR / d, env)
                       for name, policy, d, env, _ in RESUME_RUNS])
    t1 = time.perf_counter()
    rec = results.setdefault("resume", {"runs": {}})
    oracles = {policy: RESUME_DIR / d for _, policy, d, env, _ in RESUME_RUNS
               if env is None}
    latest = {}
    for name, policy, d, env, engine in RESUME_RUNS:
        if env is None:
            rep = _worker_report(name, outs[name])
            rec["runs"][name] = dict(policy=policy, **rep)
            continue
        latest[name] = store.latest_step(str(RESUME_DIR / d))
        check(latest[name] in ((1,) if env is MID_SAVE_AT_1 else (1, 2)),
              f"{name}: latest step {latest[name]} after the kill")
    outs = _run_stage([(f"{name}_resumed", policy, engine, RESUME_DIR / d,
                        None) for name, policy, d, env, engine in RESUME_RUNS
                       if env is not None])
    t2 = time.perf_counter()
    for name, policy, d, env, engine in RESUME_RUNS:
        if env is None:
            continue
        out = outs[f"{name}_resumed"]
        check(f"[cnn] resumed after epoch {latest[name]}" in out,
              f"{name}: no resume after epoch {latest[name]}\n{out[-1500:]}")
        rep = _worker_report(name, out)
        oracle = oracles[policy]
        leaves, hist = _ckpt_fingerprint(RESUME_DIR / d, RESUME_EPOCHS)
        want_leaves, want_hist = _ckpt_fingerprint(oracle, RESUME_EPOCHS)
        left = [n for n in (RESUME_DIR / d).iterdir()
                if n.name.endswith(".tmp")]
        rec["runs"][name] = dict(policy=policy, resumed_under=engine,
                                 latest_after_kill=latest[name],
                                 leaves_equal=leaves == want_leaves,
                                 history_equal=hist == want_hist,
                                 partials_left=len(left), **rep)
        print(f"[resume] {name}: killed ({env['REPRO_FAULT_MODE']} at "
              f"{env['REPRO_FAULT_STEP']}), latest_step {latest[name]}, "
              f"resumed under {engine}: {len(leaves)} leaves "
              f"{'equal' if leaves == want_leaves else 'DIFFERENT'} to the "
              f"oracle's, history {hist} vs {want_hist}")
        check(len(leaves) == 20 and leaves == want_leaves,
              f"{name}: final checkpoint differs from the oracle's")
        check(hist == want_hist, f"{name}: history {hist} != {want_hist}")
        check(not left, f"{name}: partials left: {left}")
    _readback(FUSED, RESUME_DIR / "fused_oracle", results)
    rec.update(stage1_s=t1 - t0, stage2_s=t2 - t1)
    print(f"[resume] stage 1 (2 oracles, 4 killed runs) {t1 - t0:.1f}s, "
          f"stage 2 (4 resumed runs) {t2 - t1:.1f}s, one process each, "
          "all of a stage at once on the card")


# ---------------------------------------------------------------------------
# (r2) one training step: the card against the plain CPU step
# ---------------------------------------------------------------------------

# logits: f32 reassociation through four managed reads (the card's blocked
# FMA sums vs the CPU's matmul); x_bar: the same through the backward reads
# and col2im; weights: an activation an ulp off can flip a Bernoulli draw
# at u ~ p, so at most 0.1% of a tile's entries may differ by more than
# 1e-6, each by at most a few coincidences' dw (3e-3)
STEP_LOGIT_ATOL = 1e-5
STEP_XBAR_RTOL = 1e-4
STEP_W_ATOL, STEP_W_SHARE, STEP_W_MAX = 1e-6, 1e-3, 3e-3


def _one_step(params, x, y, key, cfg):
    import torch
    from repro_torch.models import lenet
    from repro_torch.optim import optimizers
    from repro_torch.train import engine
    ws = engine.trainable(params)
    x = x.clone().requires_grad_()
    logits = lenet.apply(params, x, key, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.sum(torch.gather(logp, 1, y.long()[:, None]))
    grads = torch.autograd.grad(loss, ws + [x])
    optimizers.analog_sgd(ws, grads[:-1])
    return logits.detach().cpu(), grads[-1].cpu(), {
        n: params[n].w.detach().cpu() for n in lenet.LAYERS}


def step_reference(results):
    step_vs_cpu("FUSED", FUSED, "step_reference", results)


def step_vs_cpu(what, policy, label, results):
    """One training step under ``policy`` on the card against the plain CPU
    step on the same parameters, images and key."""
    from repro_torch.analog import presets
    from repro_torch.models import lenet
    from repro_torch.utils import prng
    cfg = lenet.LeNetConfig.from_policy(presets.parse_policy(policy))
    p_cpu = lenet.init(prng.key(7), cfg, device="cpu")
    p_gpu = lenet.init(prng.key(7), cfg, device=DEV)
    x, y = _lenet_images(LENET_BATCH, seed=5)
    cpu = _one_step(p_cpu, x.cpu(), y.cpu(), prng.key(8), cfg)
    gpu = _one_step(p_gpu, x, y, prng.key(8), cfg)
    lerr = float((cpu[0] - gpu[0]).abs().max())
    xerr = float((cpu[1] - gpu[1]).abs().max() / cpu[1].abs().max())
    ok = lerr <= STEP_LOGIT_ATOL and xerr <= STEP_XBAR_RTOL
    rows = {}
    for n in lenet.LAYERS:
        diff = (cpu[2][n] - gpu[2][n]).abs()
        share = float((diff > STEP_W_ATOL).float().mean())
        rows[n] = dict(share=share, max=float(diff.max()))
        ok &= share <= STEP_W_SHARE and rows[n]["max"] <= STEP_W_MAX
    print(f"[reference] {what} step, card vs CPU: logits max|diff| {lerr:.2e}"
          f" (tol {STEP_LOGIT_ATOL}), x_bar max|diff|/max|x_bar| "
          f"{xerr:.2e} (tol {STEP_XBAR_RTOL}), weights "
          + ", ".join(f"{n}: {r['share']:.1e} of entries > 1e-6, max "
                      f"{r['max']:.1e}" for n, r in rows.items()))
    results[label] = dict(policy=policy, logit_err=lerr, xbar_rel_err=xerr,
                          weights=rows, ok=ok)
    check(ok, "the card's training step disagrees with the CPU step")


# ---------------------------------------------------------------------------
# (b8) flash attention against its plain version
# ---------------------------------------------------------------------------

def _qkv(g, b, sq, sk, h, hkv, d, dtype):
    import torch
    mk = lambda s, nh: (torch.randn(b, s, nh, d, generator=g, device=DEV)
                        * 0.5).to(dtype)
    return mk(sq, h), mk(sk, hkv), mk(sk, hkv)


def flash_vs_plain(results):
    """float32: within rtol = atol = 2e-5 (the JAX package's own flash test;
    f32 reassociation of the score and P V sums).  bfloat16: P rounds to
    bf16 at the same block's running max on both sides, so a score an f32
    ulp apart can flip one P entry's rounding (2^-8 of it) and the output
    rounds to bf16 (2^-9 of |out| each side): within 2^-7 of each output's
    sum_k a_k |v_k| (the float32 attention of |v|)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    ok = True
    for i, (case, b, sq, sk, h, hkv, d, causal, win, bk) in enumerate(
            FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=DEV).manual_seed(500 + i)
            q, k, v = _qkv(g, b, sq, sk, h, hkv, d, dtype)
            kw = dict(causal=causal, window=win, block_k=bk)
            y = fa.flash_attention(q, k, v, **kw)
            yp = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            y, yp = y.float(), yp.float()
            if dtype == torch.float32:
                tol = 2e-5 + 2e-5 * yp.abs()
            else:
                tol = 2.0 ** -7 * fa.flash_attention_plain(
                    q.float(), k.float(), v.float().abs(), **kw)
            diff = (y - yp).abs()
            worst = float((diff / tol).max())
            good = (worst <= 1.0 and y.shape == yp.shape
                    and bool(torch.isfinite(y).all()))
            ok &= good
            name = f"{case} {str(dtype)[6:]}"
            print(f"[check] {'flash_attention':<15} {name:<34} max|diff|="
                  f"{float(diff.max()):.3e} worst |diff|/tol={worst:.3f} "
                  f"{'ok' if good else 'FAIL'}")
            results.setdefault("checks", []).append(dict(
                kernel="flash_attention", case=name,
                max_abs_err=float(diff.max()), worst_ratio=worst,
                tol="rtol=atol=2e-5" if dtype == torch.float32
                else "2^-7 sum|a v|", ok=good))
    check(ok, "the flash-attention kernel disagrees with its plain version")


# ---------------------------------------------------------------------------
# (f5) the fused pulse update against its plain version, and its entry
# ---------------------------------------------------------------------------

def _pulse_case(m, n, b, bl, ctoc, seed):
    """Device maps, weights and signed streams of an update cycle sampled as
    ``core/update.py`` samples them (drivers N(0, 1) x 0.3 and 0.1, gain
    1)."""
    import torch
    from repro_torch.core import device, update
    from repro_torch.utils import prng
    cfg = device.RPUConfig(bl=bl, dw_min_ctoc=ctoc, use_pallas=True)
    maps = device.sample_device_maps(prng.key(seed), m, n, cfg, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = (torch.randn(m, n, generator=g, device=DEV) * 0.1).contiguous()
    x = torch.randn(b, n, generator=g, device=DEV) * 0.3
    d = torch.randn(b, m, generator=g, device=DEV) * 0.1
    one = torch.tensor(1.0, device=DEV)
    k_a, k_b, k_c = prng.split(prng.key(seed + 1), 3)
    cols = update.sample_signed_streams(k_a, x, one, bl)
    rows = update.sample_signed_streams(k_b, d, one, bl)
    return cfg, maps, w, rows, cols, k_c


def pulse_update_vs_plain(results):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import pulse_update as kp
    from repro_torch.utils import fastrng

    ok = True
    for i, (case, m, n, b, bl, ctoc) in enumerate(PULSE_CASES):
        cfg, maps, w, rows, cols, key = _pulse_case(m, n, b, bl, ctoc,
                                                    600 + i)
        got = ops.pulse_update_fused(w, maps, rows, cols, key, cfg)
        want = kp.pulse_update_plain(
            w, maps.dw_up, maps.dw_dn, maps.bound, rows.reshape(-1, m),
            cols.reshape(-1, n), fastrng.key_to_seed(key), ctoc)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if ctoc == 0.0:
            tol = torch.finfo(torch.float32).eps * torch.maximum(
                want.abs(), torch.full_like(want, 2.0 ** -126))
            rule = "1 ulp"
        else:
            tol = 1e-6 + 1e-5 * want.abs()
            rule = "rtol 1e-5, atol 1e-6"
        inside = bool((got.abs() <= maps.bound).all())
        clipped = int((got.abs() == maps.bound).sum())
        good = (bool((diff <= tol).all()) and inside
                and bool(torch.isfinite(got).all()))
        ok &= good
        print(f"[check] {'pulse_update':<15} {case + f' T={b * bl}':<34} "
              f"max|diff|={float(diff.max()):.3e} ({rule}), within +-bound: "
              f"{inside} ({clipped} at it) {'ok' if good else 'FAIL'}")
        results.setdefault("checks", []).append(dict(
            kernel="pulse_update", case=case, max_abs_err=float(diff.max()),
            tol=rule, within_bound=inside, ok=good))
    check(ok, "the fused pulse-update kernel disagrees with its plain "
          "version")


def pulse_update_entry(results):
    """The fused update's one entry, ``ops.pulse_update_fused``, driven
    through PULSE_ENTRY_CYCLES update cycles of LeNet's K2 tile with 13
    devices per weight: streams sampled by ``core/update.py`` each cycle
    from the cycle's keys, launch counters read around the cycles."""
    import torch
    from repro_torch.core import update
    from repro_torch.kernels import ops
    from repro_torch.utils import prng

    case, m, n, b, bl, ctoc = PULSE_CASES[-1]
    cfg, maps, w, _, _, _ = _pulse_case(m, n, b, bl, ctoc, 650)
    g = torch.Generator(device=DEV).manual_seed(651)
    x = torch.randn(b, n, generator=g, device=DEV) * 0.3
    d = torch.randn(b, m, generator=g, device=DEV) * 0.1
    one = torch.tensor(1.0, device=DEV)
    w0 = w.clone()
    torch.cuda.synchronize()
    with _PlainCalls() as plain:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for c in range(PULSE_ENTRY_CYCLES):
            k_a, k_b, k_c = prng.split(prng.fold_in(prng.key(652), c), 3)
            cols = update.sample_signed_streams(k_a, x, one, bl)
            rows = update.sample_signed_streams(k_b, d, one, bl)
            w = ops.pulse_update_fused(w, maps, rows, cols, k_c, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
    got = {k: v for k, v in counts.items() if v}
    moved = float((w - w0).abs().mean())
    print(f"[pulse_update_entry] {case} T={b * bl}: {PULSE_ENTRY_CYCLES} "
          f"cycles in {dt * 1e3:.1f} ms, launches {got}, plain-version "
          f"calls {plain.calls}, mean |w - w0| {moved:.3e}")
    results["pulse_update_entry"] = dict(case=case, cycles=PULSE_ENTRY_CYCLES,
                                         seconds=dt, launches=counts,
                                         plain_calls=plain.calls,
                                         mean_abs_change=moved)
    check(got == {"pulse_update": PULSE_ENTRY_CYCLES},
          f"expected {PULSE_ENTRY_CYCLES} pulse_update launches and nothing "
          f"else, got {got}")
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    check(bool(torch.isfinite(w).all()) and bool((w.abs() <= maps.bound)
                                                 .all()) and moved > 0,
          "weights not finite, outside the device bounds or not updated")


# ---------------------------------------------------------------------------
# (s) full-size qwen3_14b serving with the flash-attention prefill
# ---------------------------------------------------------------------------

def _free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_qwen3(results):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    cfg = S.build_cfg("qwen3_14b", False, POLICY_2P)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.qk_norm)
          == (40, 5120, 40, 8, 128, 17408, 151936, True),
          "not the published qwen3_14b")
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, akey = S.init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    blocks = sum(t.numel() for t in _tensors(params["layers"]))
    unembed = params["unembed"].w.numel()
    embed = params["embed"]["table"]
    param_bytes = torch.cuda.memory_allocated() - mem0
    reckoned = 4 * (blocks + unembed) + embed.numel() * embed.element_size()
    print(f"[serve_qwen3] init in {t_init:.1f}s: {blocks / 1e9:.2f} B block "
          f"and {unembed / 1e9:.2f} B unembed parameters as f32 tiles, "
          f"embedding {embed.numel() / 1e9:.2f} B {embed.dtype}; reckoned "
          f"{reckoned / 1e9:.2f} GB, allocated {param_bytes / 1e9:.2f} GB")

    prompts = S.make_prompts(cfg, QWEN_BATCH, QWEN_PROMPT, 0, DEV)
    max_seq = QWEN_PROMPT + QWEN_GEN
    with torch.no_grad():
        engine.greedy_generate(params, prompts, cfg, n_steps=2,
                               max_seq=max_seq, akey=akey)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _PlainCalls() as plain:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            toks, cache = engine.greedy_generate(
                params, prompts, cfg, n_steps=QWEN_GEN, max_seq=max_seq,
                akey=akey)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("k", "v"))
    toks = toks.cpu()
    tok_s = QWEN_BATCH * QWEN_GEN / dt
    got = {k: v for k, v in counts.items() if v}
    # one flash launch per layer in the prefill; 7 reads per layer and the
    # unembed's per forward pass (prefill + 15 decode steps)
    want = {"flash_attention": cfg.n_layers,
            "managed_read": (7 * cfg.n_layers + 1) * QWEN_GEN}
    print(f"[serve_qwen3] tokens {tuple(toks.shape)}, launches {got}, "
          f"plain-version calls {plain.calls}, {tok_s:.2f} tok/s after "
          f"warm-up ({dt:.2f}s for prefill + {QWEN_GEN - 1} decode steps); "
          f"KV cache {kv_bytes / 1e9:.3f} GB, peak allocated "
          f"{peak / 1e9:.2f} GB")
    check(got == want, f"launches {got}, expected {want}")
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    check(tuple(toks.shape) == (QWEN_BATCH, QWEN_GEN), "wrong token shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "token out of range")
    del cache

    # one prefill: wall time (host clock) and its logits, then device time
    # per kernel from a profiled prefill
    prefill = lambda: engine.prefill(params, prompts, cfg, max_seq=max_seq,
                                     akey=akey)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check(tuple(logits.shape) == (QWEN_BATCH, 1, cfg.vocab),
              "logit shape")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        step = lambda: engine.serve_step(
            params, tok, cache, cfg, akey=engine.decode_step_key(akey, 0))
        decode = _profile_step(step, "one qwen3 decode step (B 2)")
        _one_launch_reads(step, 7 * cfg.n_layers + 1)
        del logits, cache
        rows = _device_rows(prefill)
    prof = _profile_report(rows, wall, "one qwen3 prefill (B 2, S 1000)")
    # the profiler may drop kernel records: the flash time is its mean
    # over the records kept times the prefill's launches (one per layer)
    flash = [(n, ms) for key, n, ms in rows if "flash" in key]
    kept = sum(n for n, _ in flash)
    flash_ms = (sum(ms for _, ms in flash) / kept * cfg.n_layers
                if kept else 0.0)
    share = flash_ms / prof["device_busy_ms"] if rows else None
    if rows:
        print(f"[serve_qwen3] flash kernel: {flash_ms:.2f} ms "
              f"({kept}/{cfg.n_layers} records) of the prefill's "
              f"{prof['device_busy_ms']:.1f} ms device time "
              f"(share {share:.4f})")
    results["serve_qwen3"] = dict(
        policy=POLICY_2P, batch=QWEN_BATCH, prompt=QWEN_PROMPT,
        gen=QWEN_GEN, tokens_shape=list(toks.shape), launches=counts,
        plain_calls=plain.calls, tok_per_s=tok_s, seconds=dt, init_s=t_init,
        params_reckoned_gb=reckoned / 1e9, params_allocated_gb=param_bytes
        / 1e9, kv_cache_gb=kv_bytes / 1e9, peak_allocated_gb=peak / 1e9,
        prefill_profile=prof, flash_ms=flash_ms, flash_share=share,
        decode_profile=decode)
    del params, prefill
    _free()

    # the digital model (bf16 activations): one prefill through the kernel
    cfg_d = dataclasses.replace(S.build_cfg("qwen3_14b", False, None),
                                use_flash_kernel=True)
    params, _ = S.init(cfg_d, seed=0, device=DEV)
    with torch.no_grad(), _PlainCalls() as plain:
        engine.prefill(params, prompts, cfg_d, max_seq=max_seq)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = engine.prefill(params, prompts, cfg_d, max_seq=max_seq)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
    got = {k: v for k, v in counts.items() if v}
    print(f"[serve_qwen3_bf16] one digital prefill ({logits.dtype}): "
          f"{wall:.1f} ms wall, launches {got}, plain-version calls "
          f"{plain.calls}")
    check(got == {"flash_attention": cfg_d.n_layers},
          f"digital prefill launches {got}")
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    check(bool(torch.isfinite(logits).all()), "non-finite bf16 logits")
    results["serve_qwen3_bf16"] = dict(prefill_wall_ms=wall, launches=counts,
                                       logits_dtype=str(logits.dtype))
    del params, logits
    _free()


def _one_launch_reads(step, reads):
    """A decode step's managed reads are one kernel launch each.  In one
    profiled step the managed-read counter and the host's
    ``cudaLaunchCooperativeKernel`` records (runtime-API records, which
    the profiler keeps where it drops kernel records; nothing else in a
    decode step launches cooperatively) must both equal ``reads``, the
    gemv kernel must have records, and #2's tiled and epilogue kernels
    none.  It fails when the profiler kept no kernel record at all."""
    import torch
    from repro_torch.kernels import ops
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ops.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    counted = ops.launch_counts()["managed_read"]
    kern, host = {}, {}
    for ev in prof.key_averages():
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        (kern if on_device else host)[ev.key] = ev.count
    check(kern, "the profiler kept no kernel record of the decode step")
    coop = sum(n for k, n in host.items()
               if k.startswith("cudaLaunchCooperativeKernel"))
    gemv = sum(n for k, n in kern.items() if "gemv_kernel" in k)
    other = {k: n for k, n in kern.items()
             if "gemm::" in k and "gemv_kernel" not in k}
    print(f"[serve_qwen3] decode step: {reads} managed reads, counter "
          f"{counted}, cooperative launches {coop}, gemv kernel records "
          f"{gemv}, other read kernels {other}")
    check(counted == reads and coop == reads and 0 < gemv <= reads
          and not other, "a decode read is not one cooperative gemv launch")


# ---------------------------------------------------------------------------
# (r3) the qwen3 smoke model: the card against the CPU, flash off and on
# ---------------------------------------------------------------------------

def smoke_reference_qwen3(results):
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer
    from repro_torch.serve import engine
    from repro_torch.utils import prng

    cfg0 = dataclasses.replace(S.build_cfg("qwen3_14b", True, POLICY_2P),
                               act_dtype=torch.float32)
    p_cpu = transformer.init_lm(0, cfg0, device="cpu")
    p_gpu = _to(p_cpu, DEV)
    # 150 tokens: two softmax blocks of 128, the second padded
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg0.vocab, (2, 150)))
    tokens = {}
    for flash in (False, True):
        cfg = dataclasses.replace(cfg0, use_flash_kernel=flash)
        outs = {}
        for dev, p in (("cpu", p_cpu), (DEV, p_gpu)):
            with torch.no_grad():
                lg, _ = engine.prefill(p, toks.to(dev), cfg, max_seq=160,
                                       akey=prng.key(5))
                gen, _ = engine.greedy_generate(p, toks.to(dev), cfg,
                                                n_steps=6, max_seq=160,
                                                akey=prng.key(5))
            outs[dev] = (lg.cpu(), gen.cpu())
        err = float((outs["cpu"][0] - outs[DEV][0]).abs().max())
        same = torch.equal(outs["cpu"][1], outs[DEV][1])
        tokens[flash] = outs[DEV][1]
        state = "on" if flash else "off"
        print(f"[reference] qwen3 smoke, flash kernel {state}: logits "
              f"max|diff| {err:.2e} (tol 1e-4), greedy tokens equal: {same}")
        results.setdefault("reference_qwen3", []).append(
            dict(flash=flash, logit_err=err, tokens_equal=same))
        check(err <= 1e-4 and same, "card disagrees with the CPU reference")
    same = torch.equal(tokens[False], tokens[True])
    print(f"[reference] qwen3 smoke on the card: tokens with the flash kernel "
          f"equal those without: {same}")
    check(same, "the flash kernel changes the greedy tokens")


# ---------------------------------------------------------------------------
# (l) the analog LSTM/GRU copy-task trainer: temporal weight reuse
# ---------------------------------------------------------------------------

# the trainer's full width: hidden 32, vocab 8, seq 16 (T = 34), batch 8
SEQ_T, SEQ_B, SEQ_SEQ = 34, 8, 16
# (tile, rows, cols) and the batches each read runs at: the cells' per-
# timestep reads (B 8, and the figure's 16) and the readout over T x B rows
# (272, and the figure's 10 x 16 = 160)
SEQ_TILES = [("wx", 128, 9, (8, 16)), ("wh", 128, 32, (8, 16)),
             ("readout", 8, 33, (272, 160))]
# the paper's iterative BM on the kernels.  At the figure's alpha 2 no read
# of a full-width epoch saturates (no retry in 4 steps on the CPU); at
# alpha 1 they retry
SEQ_IT = "nm_bm:use_pallas=true:out_bound=1"
SEQ_FUSED = "nm_bm:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
# (label, arch, train_sequence's policy arguments): the GRU takes SEQ_FUSED
# through the trainer's flags (bare --analog on rpu_nm_bm)
SEQ_RUNS = (("seq_it", "lstm", dict(analog_policy=SEQ_IT)),
            ("seq_fused", "lstm", dict(analog_policy=SEQ_FUSED)),
            ("gru_fused", "gru", dict(analog=True, bm_mode="two_phase",
                                      use_pallas=True,
                                      fuse_bwd_update=True)))
# launches per replayed step: 69 managed reads each way (wx and wh at each
# of 34 timesteps, the readout once), each under iterative BM a first raw
# read and 10 predicated retries; 69 pulse counts (one per tile per
# timestep, the readout's one) or 69 fused backward+updates
SEQ_PER_STEP = {
    "seq_it": {"noisy_read": 2 * 69 * 11, "pulse_counts": 69},
    "seq_fused": {"managed_read": 69, "bwd_update": 69},
    "gru_fused": {"managed_read": 69, "bwd_update": 69},
}
SEQ_ACT_ATOL = 1e-5              # tests/test_torch_recurrent.py


def seq_kernels_vs_plain(results):
    """#1 and #2 at the recurrent reads (wx 128x9, wh 128x32, readout 8x33;
    forward and transpose; NM off and on for #2), #6 at wx and wh with the
    stream counters at row 0 and at the last timestep's 33 x 8, and #4
    accumulated over 34 timesteps at ``row_offset = t * 8`` bitwise one
    count over the 272 stacked rows (and its plain version)."""
    import torch
    from repro_torch.core import update
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    ok, seed = True, 900
    for name, rows, cols, batches in SEQ_TILES:
        for b in batches:
            for tr in (False, True):
                seed += 1
                g = torch.Generator(device=DEV).manual_seed(seed)
                k = rows if tr else cols
                w = (torch.randn(rows, cols, generator=g, device=DEV)
                     * k ** -0.5).contiguous()
                x = _scaled_rows(g, b, k)
                case = f"LSTM {name} {'transpose' if tr else 'fwd'} B={b}"
                mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
                kw = dict(sigma=SIGMA, alpha=2.0, transpose=tr)
                y, s = kn.noisy_mvm(w, x, 0x5EED + seed, **kw)
                yp, sp = kn.noisy_mvm_plain(w, x, 0x5EED + seed, **kw)
                ok &= _read_check(results, "noisy_mvm", case, y, yp, s, sp,
                                  mag)
                ok &= _seed_and_predicate_check(results, case, w, x,
                                                0x5EED + seed, kw, y, s)
                for nm in (False, True):
                    nm_s = (x.abs().amax(1, keepdim=True) if nm
                            else torch.ones(b, 1, device=DEV))
                    mkw = dict(kw, two_phase=True, retry_scale=16.0)
                    y, s = km.managed_mvm(w, x, nm_s, (seed, 77), **mkw)
                    yp, sp = km.managed_mvm_plain(w, x, nm_s, (seed, 77),
                                                  **mkw)
                    ok &= _read_check(results, "managed_mvm",
                                      f"{case} nm={int(nm)}", y, yp, s, sp,
                                      mag)
    gains = torch.tensor([1.1, 0.7], device=DEV)
    for name, rows, cols, _ in SEQ_TILES[:2]:
        seed += 1
        g = torch.Generator(device=DEV).manual_seed(seed)
        w = (torch.randn(rows, cols, generator=g, device=DEV)
             * rows ** -0.5).contiguous()
        x = _scaled_rows(g, SEQ_B, cols, (1.0,))
        dd = _scaled_rows(g, SEQ_B, rows)
        nm_s = dd.abs().amax(1, keepdim=True)
        for row0 in (0, (SEQ_T - 1) * SEQ_B):
            ok &= _fused_checks(
                results, "bwd_update_mvm", f"LSTM {name} B=8 row0={row0}",
                [(dd, nm_s, (51, 52), (61, 62, row0), "")],
                lambda d_, n_, rs, us, **kw: kb.bwd_update_mvm(
                    w, d_, x, n_, rs, us, gains, **kw),
                lambda d_, n_, rs, us, **kw: kb.bwd_update_mvm_plain(
                    w, d_, x, n_, rs, us, gains, **kw),
                w, dict(sigma=SIGMA, alpha=2.0, two_phase=True, bl=10))
    gain = torch.tensor(0.8, device=DEV)
    for name, rows, cols, _ in SEQ_TILES[:2]:
        seed += 1
        g = torch.Generator(device=DEV).manual_seed(seed)
        drv = torch.randn(SEQ_T, SEQ_B, cols, generator=g, device=DEV)
        err = torch.randn(SEQ_T, SEQ_B, rows, generator=g, device=DEV)
        acc = None
        for t in range(SEQ_T):
            r = update.signed_streams(7, err[t], gain, 10,
                                      row_offset=t * SEQ_B)
            c = update.signed_streams(8, drv[t], gain, 10,
                                      row_offset=t * SEQ_B)
            acc = kp.pulse_counts(r.reshape(-1, rows).contiguous(),
                                  c.reshape(-1, cols).contiguous(), acc)
        r = update.signed_streams(7, err.reshape(-1, rows), gain, 10)
        c = update.signed_streams(8, drv.reshape(-1, cols), gain, 10)
        r, c = r.reshape(-1, rows).contiguous(), c.reshape(-1, cols
                                                           ).contiguous()
        case = f"LSTM {name} 34 x B=8, BL=10"
        ok &= _count_check(results, "pulse_counts", case + " accumulated",
                           *acc, *kp.pulse_counts(r, c))
        ok &= _count_check(results, "pulse_counts", case, *acc,
                           *kp.pulse_counts_plain(r, c))
    check(ok, "a kernel disagrees with its plain version at the recurrent "
          "shapes")


def _seq_build(kind, policy, device=None):
    """``launch.train.build`` at the trainer's full width, ``policy``
    train_sequence's policy arguments."""
    from repro_torch.launch import train as tl
    kw = dict(analog=False, analog_policy=None, bm_mode="iterative",
              use_pallas=False, fuse_bwd_update=False)
    return tl.build(kind, batch=SEQ_B, seq=SEQ_SEQ, smoke=False, lr=0.01,
                    time_chunk=1, seed=0,
                    device=DEV if device is None else device,
                    **dict(kw, **policy))


def _leaves(params):
    from repro_torch.optim import optimizers
    return [t.detach() for t, _ in optimizers.leaves(params)]


def seq_train(label, kind, policy, results):
    """The main path: one epoch of ``launch.train.train_sequence`` at full
    width (25 steps and one evaluation) under ``engine="python"`` and under
    ``engine="scan"`` from the same seed; the launch counters set to 0
    before each run and read after it; no plain-version call; every tile
    and the accuracy bitwise equal."""
    import torch
    from repro_torch.core import management
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_sequence
    runs = {}
    for engine in ("python", "scan"):
        with _PlainCalls() as plain, management.count_retries(DEV) as n:
            ops.reset_launch_counts()
            r = train_sequence(kind, steps=1, batch=SEQ_B, seq=SEQ_SEQ,
                               smoke=False, device=DEV, engine=engine,
                               return_params=True, verbose=False, **policy)
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
        check(plain.calls == 0,
              f"{label}: {plain.calls} plain-version calls on the card")
        runs[engine] = dict(result=r, launches=counts, retries=int(n))
    loop, scan = runs["python"], runs["scan"]
    equal = [torch.equal(a, b) for a, b in zip(
        _leaves(loop["result"]["params"]), _leaves(scan["result"]["params"]))]
    same_acc = loop["result"]["accuracies"] == scan["result"]["accuracies"]
    print(f"[{label}] train_sequence({kind!r}, {policy}), "
          f"one epoch of 25 steps at T={SEQ_T}, batch {SEQ_B}: tiles bitwise "
          f"equal {equal}, accuracy {scan['result']['accuracies']} (equal: "
          f"{same_acc}); launches python {loop['launches']}, scan "
          f"{scan['launches']}; retries (evaluation and the scan's warm-up "
          f"steps included) python {loop['retries']} scan {scan['retries']};"
          f" steps/s with evaluation and captures: python "
          f"{loop['result']['steps_per_sec']:.1f}, scan "
          f"{scan['result']['steps_per_sec']:.1f}")
    check(all(equal) and same_acc,
          f"{label}: train_sequence's graphed epoch differs from the loop")
    missing = [k for k in SEQ_PER_STEP[label] if not scan["launches"].get(k)]
    check(not missing and scan["launches"].get("key_schedule"),
          f"{label}: the kernels {missing} of the path never launched")
    results[f"seq_train_{label}"] = dict(
        policy=policy, kind=kind, launches=scan["launches"],
        loop_launches=loop["launches"], tiles_equal=True,
        accuracies=scan["result"]["accuracies"],
        steps_per_s={e: runs[e]["result"]["steps_per_sec"] for e in runs},
        retries={e: runs[e]["retries"] for e in runs})


def seq_engine_detail(label, kind, policy, results):
    """The graphed step of :func:`seq_train` up close: two epochs of each
    engine from the same tiles (``make_seq_epoch_fn`` against the loop of
    ``make_seq_step_fn``) under ``management.count_retries``: tiles bitwise
    after each, the second epoch's retries equal (its 25 replays against
    25 loop steps), the launches per replay and the captured step's
    nodes, the time of the first graphed epoch (warm-up step, capture and
    25 replays) and both engines' steps/s in the second, and one replayed
    step profiled beside one loop step."""
    import torch
    from repro_torch.core import management
    from repro_torch.train import cnn, engine
    from repro_torch.utils import prng
    scfg, p_loop, opt_l, (tok, tgt), _ = _seq_build(kind, policy)
    _, p_scan, opt_s, _, _ = _seq_build(kind, policy)
    step = engine.make_seq_step_fn(scfg, opt_l)
    run = engine.make_seq_epoch_fn(scfg, opt_s, batch=SEQ_B)
    k_data, k_train = prng.key(3), prng.key(2)
    loop_n, scan_n = (management.count_retries(DEV) for _ in range(2))
    secs, counts = [], []
    with _PlainCalls() as plain:
        for epoch in (0, 1):
            with loop_n:
                t_loop = _timed(lambda: cnn.python_epoch(
                    step, p_loop, tok, tgt, k_data, k_train, epoch, SEQ_B))
            with scan_n:
                t_scan = _timed(lambda: run(p_scan, tok, tgt, k_data,
                                            k_train, epoch))
            secs.append((t_loop, t_scan))
            counts.append((int(loop_n.n), int(scan_n.n)))
            loop_n.n.zero_()
            scan_n.n.zero_()
            equal = all(torch.equal(a, b) for a, b in zip(
                _leaves(p_loop), _leaves(p_scan)))
            check(equal, f"{label}: graphed epoch {epoch} differs from the "
                  "loop")
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    prog = run.program
    spe = prog.spe
    per_replay = dict(SEQ_PER_STEP[label], key_schedule=1)
    (loop0, scan0), (loop1, scan1) = counts
    rate = {"python": spe / secs[1][0], "scan": spe / secs[1][1]}
    print(f"[{label}_engine] {spe}-step epochs: tiles bitwise equal after "
          f"each; first graphed epoch (warm-up step, capture, {spe} "
          f"replays) {secs[0][1]:.2f}s against the loop's {secs[0][0]:.2f}s;"
          f" second epoch python {rate['python']:.1f} steps/s, scan "
          f"{rate['scan']:.1f} steps/s; per replay {prog.captured}; "
          f"retries epoch 1 loop {loop0} / graph {scan0} (its warm-up step "
          f"included), epoch 2 loop {loop1} / graph {scan1}")
    check(prog.captured == per_replay, f"{label}: the capture recorded "
          f"{prog.captured}, expected {per_replay}")
    check(loop1 == scan1, f"{label}: {scan1} retries in the graph's epoch, "
          f"{loop1} in the loop's")
    if "noisy_read" in per_replay:
        check(scan1 > 0, f"{label}: no read retried (the check sees none)")
    tape = prog.tape
    n_keys, n_seeds = len(tape.recorded[0]), len(tape.recorded[2])
    census = _graph_census(prog.graph,
                           ROOT / "build" / "graphs" / f"{label}.dot")
    nodes = sum(census.values())
    print(f"[{label}_engine] key tape: {n_keys} derivations of "
          f"{len(tape.keys) - 1}, {n_seeds} seeds; captured step's nodes "
          f"({nodes}): {census}")
    check(census["key_schedule"] == 1
          and census["raw_read"] == per_replay.get("noisy_read", 0)
          and census["pulse_counts"] == per_replay.get("pulse_counts", 0),
          f"{label}: the captured step holds {census}")
    prog.ctr.copy_(torch.tensor([0, 2 * spe]))
    replay = _profile_step(prog.run, f"one replayed {label} step")
    loop = _profile_step(
        lambda: step(p_loop, tok[:SEQ_B], tgt[:SEQ_B],
                     prng.fold_in(k_train, 10 ** 6)),
        f"one {label} loop step")
    results[f"seq_engine_{label}"] = dict(
        policy=policy, kind=kind, per_replay=prog.captured,
        graph_nodes=census, nodes=nodes,
        key_tape=dict(derivations=n_keys, seeds=n_seeds),
        first_epoch_s=dict(python=secs[0][0], scan=secs[0][1]),
        rates=rate, retries=counts, replayed_step=replay, loop_step=loop)


def seq_step_vs_cpu(results):
    """One full-width SEQ_FUSED LSTM step on the card against the plain
    CPU step on the same parameters, tokens and key: the logits within
    SEQ_ACT_ATOL, the updated tiles by r2's rule."""
    import torch
    from repro_torch.recurrent import model as seq_model
    from repro_torch.train import engine
    from repro_torch.utils import prng
    out = {}
    for dev in ("cpu", DEV):
        scfg, params, opt, (tok, tgt), _ = _seq_build(
            "lstm", dict(analog_policy=SEQ_FUSED), device=dev)
        key = prng.key(8)
        with torch.no_grad():
            logits = seq_model.apply(params, tok[:SEQ_B], key, scfg).cpu()
        engine.make_seq_step_fn(scfg, opt)(params, tok[:SEQ_B],
                                           tgt[:SEQ_B], key)
        out[dev] = logits, [t.cpu() for t in _leaves(params)]
    lerr = float((out["cpu"][0] - out[DEV][0]).abs().max())
    ok = lerr <= SEQ_ACT_ATOL
    rows = []
    for a, b in zip(out["cpu"][1], out[DEV][1]):
        diff = (a - b).abs()
        rows.append(dict(share=float((diff > STEP_W_ATOL).float().mean()),
                         max=float(diff.max())))
        ok &= rows[-1]["share"] <= STEP_W_SHARE and \
            rows[-1]["max"] <= STEP_W_MAX
    print(f"[seq_reference] SEQ_FUSED LSTM step (T={SEQ_T}, batch {SEQ_B}),"
          f" card vs CPU: logits max|diff| {lerr:.2e} (tol {SEQ_ACT_ATOL}), "
          "tiles wx, wh, readout: " + ", ".join(
              f"{r['share']:.1e} of entries > 1e-6, max {r['max']:.1e}"
              for r in rows))
    results["seq_step_reference"] = dict(logit_err=lerr, tiles=rows, ok=ok)
    check(ok, "the card's LSTM step disagrees with the CPU step")


def lstm_figure(results):
    """The recurrent sequel's figure (``benchmarks/lstm_management.py``) at
    its protocol, seeds 0-2, on the kernels: every curve's pair inside the
    JAX seed bands and the paper's verdict at every seed."""
    from repro_torch.benchmarks import lstm_management as lm
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        res = lm.run_lstm_management(**lm.PROTOCOL, seeds=(0, 1, 2),
                                     device=DEV)
        dt = time.perf_counter() - t0
    for line in lm.report_lstm_management(res):
        print(f"[lstm_figure] {line}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lstm_management.json").write_text(json.dumps(res, indent=1))
    print(f"[lstm_figure] 9 runs in {dt:.1f}s; steps/s (training, "
          f"evaluation and captures) {res['steps_per_sec']}")
    results["lstm_figure"] = dict(
        curves=res["curves"], steps_per_s=res["steps_per_sec"], seconds=dt,
        bands=lm.band_verdicts(res), verdict=lm.verdict(res),
        policies=res["policies"])
    check(plain.calls == 0, f"{plain.calls} plain-version calls on the card")
    check(lm.passed(res), "the LSTM figure misses a JAX band or the paper's "
          "verdict")


def recurrent(results):
    seq_kernels_vs_plain(results)
    for label, kind, policy in SEQ_RUNS:
        seq_train(label, kind, policy, results)
    for label, kind, policy in SEQ_RUNS[:2]:
        seq_engine_detail(label, kind, policy, results)
    seq_step_vs_cpu(results)
    lstm_figure(results)


# ---------------------------------------------------------------------------
# (t) the analog LM trainer at full width
# ---------------------------------------------------------------------------

# full-width deepseek_7b (d 4096, d_ff 11008, vocab 102400) cut to 4 layers:
# the tiles, their w_bar and the embed's AdamW moments of 30 layers pass
# 60 GB before the finalize's temporaries
LM_LAYERS, LM_B, LM_S, LM_STEPS = 4, 8, 128, 3
LM_TIMED = 2                     # steps of each engine timed after those
LM_ROWS = LM_B * (LM_S - 1)      # 1016 rows a read: tokens[:, :-1]
T2_POSITIONS = LM_S - 1          # the temporal route's reads a sequence
FUSED_LM = "lm_managed:use_pallas=true:bm_mode=two_phase:fuse_bwd_update=true"
ITERATIVE_LM = "lm_managed:use_pallas=true"
LM_POLICIES = (("lm_fused", FUSED_LM), ("lm_iterative", ITERATIVE_LM))
# (name, rows, cols) of the LM's tiles (a bias column on every one)
LM_TILES = [("q", 4096, 4097), ("wg", 11008, 4097), ("wo", 4096, 11009),
            ("unembed", 102400, 4097)]
LM_CLI_POLICY = "*attn*=managed,*mlp*=rpu_baseline"
ARRAY = 4096                     # max_array_rows = max_array_cols


def _n_seg(k):
    return -(-k // ARRAY)


def lm_per_step(cfg, policy):
    """The analog launches one graphed LM step of any trained family makes,
    from the code's routes.  Each dense site of a block (7 per attention +
    MLP layer, 2 per SSD block; an encoder-decoder's encoder layers the
    same, its decoder blocks 4 more for the cross attention), an adapter
    and the untied unembed, under the rule of ``policy`` that matches its
    path: a block's forward reads (an encoder layer's too) run twice under
    remat (the forward and its recompute), the adapter's and the unembed's
    once; an
    SSD projection with no update management takes the temporal route, one
    read per position (``T2_POSITIONS``) forward and transposed and one
    count launch per position at ``row_offset = t * B``; a tile of at most
    ``max_array_rows`` rows under two-phase BM and ``fuse_bwd_update``
    takes #6 (one launch per position on the temporal route), the others
    a transpose read and #4; a managed read is one #2 under two-phase BM,
    a first raw read and ``bm_max_iters`` predicated retries under
    iterative BM."""
    from repro_torch.analog.presets import parse_policy
    from repro_torch.models import ssm
    pol = parse_policy(policy)
    d, hd = cfg.d_model, cfg.head_dim
    kv = cfg.n_kv_heads * hd
    attn = [("attn/q", cfg.n_heads * hd), ("attn/k", kv), ("attn/v", kv),
            ("attn/o", d)]
    sites = []
    if cfg.family != "ssm":
        sites += attn + [("mlp/wi", cfg.d_ff), ("mlp/wg", cfg.d_ff),
                         ("mlp/wo", d)]
    if cfg.family in ("ssm", "hybrid"):
        d_in, h, _, n = ssm.dims(cfg)
        sites += [("ssm/in_proj", 2 * d_in + 2 * n + h), ("ssm/out_proj", d)]
    enc = [(f"enc_layers/{p}", r, cfg.encoder_layers) for p, r in sites
           if cfg.encoder_layers]
    if cfg.encoder_layers:
        # a decoder block's cross attention: q of the decoder's rows, k and
        # v of the encoder's output
        sites += [("cross/" + p.split("/")[1], r) for p, r in attn]
    sites = [(f"layers/{p}", r, cfg.n_layers) for p, r in sites] + enc
    if cfg.frontend != "none":
        sites.append(("adapter", d, 1))
    if not cfg.tie_embeddings:
        sites.append(("unembed", cfg.vocab, 1))
    out = {}
    for path, rows, copies in sites:
        rule = pol.match(path)
        if rule is None or rule.cfg is None:
            continue
        rpu = rule.cfg
        two_phase = rpu.bm_mode == "two_phase"
        kind, per_read = (("managed_read", 1) if two_phase
                          else ("noisy_read", rpu.bm_max_iters + 1))
        positions = (T2_POSITIONS if "/ssm/" in path
                     and not rpu.update_management else 1)
        fused = (rpu.fuse_bwd_update and two_phase
                 and rows <= rpu.max_array_rows)
        fwd = 2 if cfg.remat and path.startswith(("layers", "enc_")) else 1
        reads = positions * (fwd + (0 if fused else 1))
        out[kind] = out.get(kind, 0) + copies * reads * per_read
        upd = "bwd_update" if fused else "pulse_counts"
        out[upd] = out.get(upd, 0) + copies * positions
    return out


def _lm_checks(results, prefix, b, reads, fused, counts, seed):
    """#1 and #2 at ``reads`` ((name, rows, cols): forward and transposed,
    ``b`` rows, contractions in ``ARRAY``-wide segments; #2 with NM's
    scale and two-phase BM), #6 at ``fused`` (``b`` rows, BL 1) and #4 at
    ``counts`` (``b`` slots, BL 1) against their plain versions: reads
    within 1e-5 of the largest sum |x||w| with equal flags, counts
    bitwise.  Returns whether every check held."""
    import torch
    from repro_torch.core import update
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    ok = True
    for name, rows, cols in reads:
        for tr in (False, True):
            seed += 1
            g = torch.Generator(device=DEV).manual_seed(seed)
            k = rows if tr else cols
            w = (torch.randn(rows, cols, generator=g, device=DEV)
                 * k ** -0.5).contiguous()
            x = _scaled_rows(g, b, k)
            case = f"{prefix} {name} {rows}x{cols}{' T' if tr else ''} " \
                   f"B={b} n_seg={_n_seg(k)}"
            mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
            kw = dict(sigma=SIGMA, alpha=ALPHA, transpose=tr,
                      n_seg=_n_seg(k))
            y, s = kn.noisy_mvm(w, x, 0xA11 + seed, **kw)
            yp, sp = kn.noisy_mvm_plain(w, x, 0xA11 + seed, **kw)
            ok &= _read_check(results, "noisy_mvm", case, y, yp, s, sp, mag)
            del y, s, yp, sp
            nm_s = x.abs().amax(1, keepdim=True)
            mkw = dict(kw, two_phase=True, retry_scale=16.0)
            y, s = km.managed_mvm(w, x, nm_s, (seed, 91), **mkw)
            yp, sp = km.managed_mvm_plain(w, x, nm_s, (seed, 91), **mkw)
            ok &= _read_check(results, "managed_mvm", f"{case} nm=1", y, yp,
                              s, sp, mag)
            del y, s, yp, sp, w, x
    gains = torch.tensor([0.9, 1.2], device=DEV)
    for name, rows, cols in fused:
        seed += 1
        g = torch.Generator(device=DEV).manual_seed(seed)
        w = (torch.randn(rows, cols, generator=g, device=DEV)
             * rows ** -0.5).contiguous()
        x = _scaled_rows(g, b, cols, (1.0,))
        dd = _scaled_rows(g, b, rows)
        nm_s = dd.abs().amax(1, keepdim=True)
        ok &= _fused_checks(
            results, "bwd_update_mvm", f"{prefix} {name} {rows}x{cols} "
            f"B={b}", [(dd, nm_s, (71, 72), (81, 82, 0), "")],
            lambda d_, n_, rs, us, **kw: kb.bwd_update_mvm(
                w, d_, x, n_, rs, us, gains, **kw),
            lambda d_, n_, rs, us, **kw: kb.bwd_update_mvm_plain(
                w, d_, x, n_, rs, us, gains, **kw),
            w, dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, bl=1))
        del w, x, dd
    gain = torch.tensor(0.7, device=DEV)
    for name, rows, cols in counts:
        seed += 1
        g = torch.Generator(device=DEV).manual_seed(seed)
        r = update.signed_streams(seed, torch.randn(
            b, rows, generator=g, device=DEV), gain, 1).reshape(b, rows)
        c = update.signed_streams(seed + 1, torch.randn(
            b, cols, generator=g, device=DEV), gain, 1).reshape(b, cols)
        up, dn = kp.pulse_counts(r.contiguous(), c.contiguous())
        upp, dnp = kp.pulse_counts_plain(r.contiguous(), c.contiguous())
        ok &= _count_check(results, "pulse_counts",
                           f"{prefix} {name} {rows}x{cols} {b} slots BL=1",
                           up, dn, upp, dnp)
        del r, c, up, dn, upp, dnp
        _free()
    return ok


def lm_kernels_vs_plain(results):
    """#1 and #2 at the LM step's reads (1016 rows: every tile forward and
    transposed, contractions in 2, 3 and 25 segments), #6 at q and wo
    (1016 rows, BL 1) and #4 at wg's and the unembed's counts (1016 slots)
    against their plain versions: reads within 1e-5 of the largest sum
    |x||w| with equal flags, counts bitwise."""
    check(_lm_checks(results, "LM", LM_ROWS, LM_TILES,
                     (LM_TILES[0], LM_TILES[2]), (LM_TILES[1], LM_TILES[3]),
                     1500),
          "a kernel disagrees with its plain version at the LM training "
          "shapes")


def _lm_tree_leaves(*trees):
    """The tensors of param and optimizer-state trees, in key order."""
    import torch
    from repro_torch.optim import optimizers
    out = []
    for tree in trees:
        optimizers.tree_map(lambda t: out.append(t) if isinstance(
            t, torch.Tensor) else None, tree)
    return out


def _lm_state(policy, arch="deepseek_7b", layers=LM_LAYERS):
    """The full-width ``arch`` (the 4-layer deepseek_7b) under ``policy``:
    ``(cfg, opt, params, opt_state)`` on the card, weights from seed 0; an
    encoder-decoder's encoder cut to ``layers`` as well."""
    import dataclasses as dc
    from repro_torch.launch import train as tl
    from repro_torch.train import lm
    cfg = tl.lm_config(arch, smoke=False, analog_policy=policy)
    cfg = dc.replace(cfg, n_layers=layers, encoder_layers=(
        layers if cfg.encoder_layers else 0))
    opt = lm.default_optimizer(cfg)
    params, state = lm.init_train_state(0, cfg, opt, device=DEV)
    return cfg, opt, params, state


def _lm_batches(cfg, start, n):
    import numpy as np
    import torch
    from repro_torch.data.tokens import SyntheticTokenSource, \
        TokenPipelineConfig
    src = SyntheticTokenSource(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=LM_S, global_batch=LM_B, seed=0))
    return torch.from_numpy(np.stack([src.batch_at(i)
                                      for i in range(start, start + n)]))


def lm_train(label, policy, results, arch="deepseek_7b", layers=LM_LAYERS):
    """The main path: ``train/lm.py``'s step on the full-width 4-layer
    deepseek_7b (or ``arch`` at ``layers``), ``LM_STEPS`` steps through the
    loop (``make_train_step``, host keys ``fold_in(key(1), s)``) and
    through the engine
    (``make_scan_train_step``: one CUDA graph replay per step) from the
    same weights; launch counters set to 0 before each and read after
    it; no plain-version call; params, optimizer state and losses bitwise
    equal; the launches per replay against :func:`lm_per_step`; the key
    schedule at the captured tape bitwise its plain evaluator; the
    captured step's nodes; the loop's steps/s over its steps after the
    first and the engine's over ``LM_TIMED`` more replays; one replay
    profiled; the peak memory of the loop steps and of the capture with its
    replays."""
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tl
    from repro_torch.train import lm
    from repro_torch.utils import prng

    _free()
    key_base = prng.key(1)
    cfg, opt, p_loop, s_loop = _lm_state(policy, arch, layers)
    step, _ = lm.make_train_step(cfg, opt)
    toks = _lm_batches(cfg, 0, LM_STEPS + LM_TIMED)
    batch = lambda t: tl._build_batch(cfg, t, LM_S)  # noqa: E731
    launches, mem, secs = {}, {}, {}
    with _PlainCalls() as plain:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        loop_losses, loop_s = [], []
        for i in range(LM_STEPS):
            t0 = time.perf_counter()
            _, _, m = step(p_loop, s_loop, batch(toks[i].to(DEV)),
                           prng.fold_in(key_base, i))
            loop_losses.append(float(m["loss"]))    # synchronises
            loop_s.append(time.perf_counter() - t0)
        secs["python_steps"] = loop_s
        launches["python"] = {k: v for k, v in ops.launch_counts().items()
                              if v}
        mem["python_step_peak_gb"] = (torch.cuda.max_memory_allocated()
                                      - base) / 2 ** 30
        mem["state_gb"] = base / 2 ** 30
        _free()                   # the loop's cached blocks, before capture
        _, _, p_scan, s_scan = _lm_state(policy, arch, layers)
        multi, _ = lm.make_scan_train_step(cfg, opt)
        torch.cuda.reset_peak_memory_stats()
        base2 = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, m = multi(p_scan, s_scan, batch(toks[:LM_STEPS]), key_base,
                        0)
        torch.cuda.synchronize()
        secs["scan_first"] = time.perf_counter() - t0
        launches["scan"] = {k: v for k, v in ops.launch_counts().items()
                            if v}
        mem["capture_and_replays_peak_gb"] = (
            torch.cuda.max_memory_allocated() - base2) / 2 ** 30
        scan_losses = m["loss"].tolist()
        a = _lm_tree_leaves(p_loop, s_loop)
        b = _lm_tree_leaves(p_scan, s_scan)
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        enc = (f" and {cfg.encoder_layers} encoder layers"
               if cfg.encoder_layers else "")
        print(f"[{label}] {arch} d {cfg.d_model} x {layers} layers{enc}, "
              f"batch {LM_B}, seq {LM_S}, {policy}: {LM_STEPS} loop steps vs "
              f"{LM_STEPS} graphed: params and optimizer state ({len(a)} "
              f"tensors) bitwise equal {equal}, losses loop {loop_losses} "
              f"graph {scan_losses}; launches loop {launches['python']}, "
              f"graph (warm-up step and {LM_STEPS} replays) "
              f"{launches['scan']}")
        check(equal and loop_losses == scan_losses,
              f"{label}: the graphed LM steps differ from the loop")
        # a random model's first loss is near ln(vocab); at the lm_managed
        # pulse gains (lr 1 in the reads' update) the loss then climbs
        check(all(math.isfinite(v) for v in scan_losses)
              and abs(scan_losses[0] - math.log(cfg.vocab)) < 1.0,
              f"{label}: losses {scan_losses}")
        prog = multi.program
        want = dict(lm_per_step(cfg, policy), key_schedule=1)
        print(f"[{label}] per replay {prog.captured}, from the code {want}")
        check(prog.captured == want, f"{label}: the capture recorded "
              f"{prog.captured}, expected {want}")
        missing = [k for k in want if not launches["scan"].get(k)]
        check(not missing, f"{label}: the kernels {missing} never launched")
        t0 = time.perf_counter()
        census = _graph_census(prog.graph,
                               ROOT / "build" / "graphs" / f"{label}.dot")
        secs["census"] = time.perf_counter() - t0
        tape = dict(derivations=len(prog.tape.recorded[0]),
                    seeds=len(prog.tape.recorded[2]))
        print(f"[{label}] captured step's nodes ({sum(census.values())}): "
              f"{census}; key tape {tape}; host seconds {prog.seconds}")
        # the loop's state goes: the graph's pool and a loop step's
        # temporaries do not fit beside two states
        del a, b, p_loop, s_loop
        _free()
        more = batch(toks[LM_STEPS:LM_STEPS + LM_TIMED])
        secs["scan"] = _timed(lambda: multi(p_scan, s_scan, more, key_base,
                                            LM_STEPS))
        # the loop's rate over its steps after the first (cuBLAS and the
        # allocator warm in the first)
        rate = {"python": (LM_STEPS - 1) / sum(loop_s[1:]),
                "scan": LM_TIMED / secs["scan"]}
        # one more replay, profiled; its wall the timed replays' mean
        t0 = time.perf_counter()
        replay = _profile_report(_device_rows(prog.run), secs["scan"]
                                 / LM_TIMED * 1e3,
                                 f"one replayed {label} step")
        secs["profile"] = time.perf_counter() - t0
    check(plain.calls == 0, f"{label}: {plain.calls} plain-version calls on "
          "the card")
    _tape_check(results, label, prog)
    print(f"[{label}] steps/s python {rate['python']:.3f}, scan "
          f"{rate['scan']:.3f} (loop steps {[round(t, 2) for t in loop_s]}"
          f" s; scan's first {LM_STEPS} with warm-up and capture "
          f"{secs['scan_first']:.1f}s; the node census {secs['census']:.1f}s,"
          f" the profiled replay {secs['profile']:.1f}s); memory: state "
          f"{mem['state_gb']:.2f} "
          f"GB per copy, peak above it {mem['python_step_peak_gb']:.2f} GB "
          f"in loop steps, {mem['capture_and_replays_peak_gb']:.2f} GB in "
          f"the capture and replays")
    results[f"lm_train_{label}"] = dict(
        arch=arch, policy=policy, layers=layers, batch=LM_B, seq=LM_S,
        launches=launches["scan"], loop_launches=launches["python"],
        per_replay=prog.captured, per_step_from_code=want,
        graph_nodes=census, key_tape=tape, build_seconds=prog.seconds,
        losses=scan_losses,
        steps_per_s=rate,
        seconds=secs, memory_gb=mem, replayed_step=replay)
    del p_scan, s_scan, multi, prog
    _free()


def lm_cli(results):
    """The CLI entry ``launch.train.train("deepseek_7b", smoke=True)`` on
    the card (the README's policy, on the kernels): 20 graphed steps,
    finite losses, the analog kernels launched."""
    import math
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tl
    ops.reset_launch_counts()
    r = tl.train("deepseek_7b", smoke=True, steps=20, batch=LM_B, seq=LM_S,
                 analog_policy=LM_CLI_POLICY, use_pallas=True, log_every=10,
                 device=DEV)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"[lm_cli] 20 steps: losses {r['losses'][0]:.4f} -> "
          f"{r['final_loss']:.4f}, {r['steps_per_sec']:.1f} steps/s on "
          f"{r['device']} (engine {r['engine']}), launches {counts}")
    check(len(r["losses"]) == 20 and all(math.isfinite(v)
                                         for v in r["losses"]),
          "the LM CLI run's losses")
    check(counts.get("noisy_read") and counts.get("key_schedule"),
          f"the LM CLI run launched {counts}")
    results["lm_cli"] = dict(losses=r["losses"], launches=counts,
                             steps_per_s=r["steps_per_sec"])


def lm_convergence(results):
    """``benchmarks/analog_lm_convergence.py`` on the card at seeds 0-2:
    the JAX pass rule ``a1 < 0.85 a0`` at every seed and both runs' last
    10 losses inside their JAX seed bands (``jax_lm_bands.json``)."""
    from repro_torch.benchmarks import analog_lm_convergence as conv
    from repro_torch.benchmarks import bands
    t0 = time.perf_counter()
    runs = {s: conv.run(s, DEV) for s in conv.SEEDS}
    v = conv.verdict(runs, bands.load(bands.LM_PATH))
    for seed, r in runs.items():
        (d0, d1), (a0, a1) = (conv.head_tail(r[m]) for m in conv.MODES)
        print(f"[lm_convergence] seed {seed}: digital {d0:.4f} -> {d1:.4f},"
              f" analog {a0:.4f} -> {a1:.4f} (a1 < 0.85 a0: "
              f"{v['learned'][seed]})")
    print(f"[lm_convergence] {bands.describe(v['band'], percent=False)} "
          f"({time.perf_counter() - t0:.1f}s)")
    results["lm_convergence"] = dict(
        verdict=dict(learned=v["learned"], band=v["band"], ok=v["ok"]),
        losses={s: {m: r[m][::5] for m in r} for s, r in runs.items()})
    check(v["ok"], "the analog LM convergence runs miss the JAX rule or "
          "bands")


def lm_kernel_times(results):
    """#1 and #2 at the LM's q forward, wg transposed (3 segments) and the
    unembed transposed (25 segments), #6 at q and wo, #4 at wg's and the
    unembed's counts: 1016 rows or slots each.  #2's bound counts the
    second phase's reads of the rows the first saturates (none at NM's
    scale), #6's the same of its transpose read."""
    import torch
    from repro_torch.core import update
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    rows_out = results["times"]
    g = torch.Generator(device=DEV).manual_seed(1700)
    b = LM_ROWS
    for (name, r, c), tr in ((LM_TILES[0], False), (LM_TILES[1], True),
                             (LM_TILES[3], True)):
        k, n_out = (r, c) if tr else (c, r)
        w = torch.randn(r, c, generator=g, device=DEV) * k ** -0.5
        x = torch.randn(b, k, generator=g, device=DEV)
        nm_s = x.abs().amax(1, keepdim=True)
        kw = dict(sigma=SIGMA, alpha=ALPHA, transpose=tr, n_seg=_n_seg(k))
        mkw = dict(kw, two_phase=True, retry_scale=16.0)
        shape = f"LM {name}{'T' if tr else ''} {r}x{c} B={b}"
        byts = 4 * (w.numel() + x.numel() + b * n_out) + b
        flops = 2.0 * b * k * n_out
        # the second phase re-reads only the rows the first saturates
        again = int(km.managed_mvm_plain(w, x, nm_s, (1, 2), **dict(
            mkw, two_phase=False))[1].sum())
        lib = lambda: torch.matmul(x, w if tr else w.T)  # noqa: E731
        _time_row(rows_out, "noisy_mvm", shape,
                  lambda: kn.noisy_mvm(w, x, 1, **kw),
                  lambda: kn.noisy_mvm_plain(w, x, 1, **kw), lib,
                  byts, flops, 0.0, batch=b)
        _time_row(rows_out, "managed_mvm", shape,
                  lambda: km.managed_mvm(w, x, nm_s, (1, 2), **mkw),
                  lambda: km.managed_mvm_plain(w, x, nm_s, (1, 2), **mkw),
                  lib, byts + 4 * b, flops * (1 + again / b), 0.0, batch=b)
        del w, x
        _free()
    gains = torch.tensor([1.0, 1.0], device=DEV)
    for name, r, c in (LM_TILES[0], LM_TILES[2]):
        w = torch.randn(r, c, generator=g, device=DEV) * r ** -0.5
        x = torch.randn(b, c, generator=g, device=DEV)
        dd = torch.randn(b, r, generator=g, device=DEV)
        nm_s = dd.abs().amax(1, keepdim=True)
        sa = (torch.rand(b, c, device=DEV) < 0.5).float()
        sb = (torch.rand(b, r, device=DEV) < 0.5).float()
        bkw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, bl=1)
        again = int(kb.bwd_update_mvm_plain(
            w, dd, x, nm_s, (1, 2), (3, 4, 0), gains,
            **dict(bkw, two_phase=False))[1].sum())
        _time_row(
            rows_out, "bwd_update_mvm", f"LM {name} {r}x{c} B={b} BL=1",
            lambda: kb.bwd_update_mvm(w, dd, x, nm_s, (1, 2), (3, 4, 0),
                                      gains, **bkw),
            lambda: kb.bwd_update_mvm_plain(w, dd, x, nm_s, (1, 2),
                                            (3, 4, 0), gains, **bkw),
            lambda: (torch.matmul(dd, w), torch.matmul(sb.T, sa),
                     torch.matmul(sb.abs().T, sa.abs())),
            4 * (w.numel() + dd.numel() + x.numel() + b + 2 + 2 * w.numel()),
            2.0 * b * r * c * (1 + again / b), 4.0 * b * r * c, batch=b)
        del w, x, dd, sa, sb
        _free()
    gain = torch.tensor(0.7, device=DEV)
    for name, r, c in (LM_TILES[1], LM_TILES[3]):
        rws = update.signed_streams(5, torch.randn(b, r, generator=g,
                                                   device=DEV), gain,
                                    1).reshape(b, r).contiguous()
        cls = update.signed_streams(6, torch.randn(b, c, generator=g,
                                                   device=DEV), gain,
                                    1).reshape(b, c).contiguous()
        _time_row(rows_out, "pulse_counts", f"LM {name} {r}x{c} {b} slots",
                  lambda: kp.pulse_counts(rws, cls),
                  lambda: kp.pulse_counts_plain(rws, cls),
                  lambda: (torch.matmul(rws.T, cls),
                           torch.matmul(rws.abs().T, cls.abs())),
                  4 * (b * (r + c) + 2 * r * c), 0.0, 4.0 * b * r * c,
                  batch=b)
        del rws, cls
        _free()


def lm_training(results):
    lm_kernels_vs_plain(results)
    for label, policy in LM_POLICIES:
        lm_train(label, policy, results)
    lm_cli(results)
    lm_convergence(results)
    lm_kernel_times(results)


# ---------------------------------------------------------------------------
# (e) training kernels: times against bound, plain version and PyTorch
# ---------------------------------------------------------------------------

def _bound(byts, flops, count_ops, flop_rate=FP32_FLOPS_PER_S):
    """Least time in ms: the bytes over HBM's rate, or the multiply-adds
    (at ``flop_rate``: fp32 for the reads) plus the count products'
    operations, whichever is longer.  The count products multiply {0, +-1}
    streams, exact on the int8 tensor cores, so they are charged at that
    rate."""
    by_bytes = byts / HBM_BYTES_PER_S
    by_ops = flops / flop_rate + count_ops / INT8_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _time_row(rows, kernel, shape, fk, fp, flib, byts, flops, count_ops,
              flop_rate=FP32_FLOPS_PER_S, batch=LENET_BATCH):
    bound_ms, bound_by = _bound(byts, flops, count_ops, flop_rate)
    row = dict(kernel=kernel, shape=shape, batch=batch,
               **_kernel_time(fk), plain_ms=_event_ms(fp),
               library_ms=None if flib is None else _event_ms(flib),
               bound_ms=bound_ms, bound_by=bound_by)
    rows.append(row)
    lib = ("none" if flib is None else f"{row['library_ms']:.4f} ms")
    print(f"[time] {kernel:<15} {shape:<12} {_time_text(row)} bound "
          f"{bound_ms:.3g} ms ({bound_by}) plain {row['plain_ms']:.4f} ms "
          f"library {lib}")


def training_kernel_times(results):
    import torch
    import torch.nn.functional as F
    from repro_torch.core import conv_mapping as cm
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import conv_mvm as kc
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    rows = results["times"]
    # #1 at the shapes the ITERATIVE step gives it (forward over the conv
    # columns, transposed, W3/W4 both ways)
    for case, w, x, tr in _lenet_reads(seed=13):
        b, k_dim = x.shape
        n_out = w.shape[1] if tr else w.shape[0]
        kw = dict(sigma=SIGMA, alpha=ALPHA, transpose=tr)
        _time_row(rows, "noisy_mvm", f"LeNet {case}",
                  lambda: kn.noisy_mvm(w, x, 1, **kw),
                  lambda: kn.noisy_mvm_plain(w, x, 1, **kw),
                  lambda: torch.matmul(x, w if tr else w.T),
                  4 * (w.numel() + x.numel() + b * n_out) + b,
                  2.0 * b * k_dim * n_out, 0.0, batch=b)
    gains = torch.tensor([1.0, 1.0], device=DEV)
    for name, vol, k, out in CONV_LAYERS:
        for d in ((1, 13) if name == "K2" else (1,)):
            shape = name if d == 1 else f"{name} #_d={d}"
            geom, w, x = _conv_case(name, vol, k, out, d, seed=9)
            p, m = geom.positions, out * d
            nm_s = torch.ones(p, 1, device=DEV)
            kw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, d_avg=d)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            w_oihw = w[:out, :geom.features].reshape(
                out, geom.c, k, k).contiguous()
            bias = w[:out, geom.features].contiguous()
            _time_row(
                rows, "conv_mvm", shape,
                lambda: kc.conv_managed_mvm(w, x, geom, nm_s, (1, 2), **kw),
                lambda: kc.conv_managed_mvm_plain(w, x, geom, nm_s, (1, 2),
                                                  **kw),
                lambda: F.conv2d(x_nchw, w_oihw, bias),
                4 * (x.numel() + w.numel() + p + p * out + p),
                2.0 * p * geom.cols * m, 0.0)
            dr = torch.randn(p, m, device=DEV)
            bkw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, bl=1)
            cols = cm.gather_columns(x, geom, 0, geom.positions)
            sa = (torch.rand_like(cols) < 0.5).float()
            sb = (torch.rand_like(dr) < 0.5).float()
            _time_row(
                rows, "conv_bwd_update", shape,
                lambda: kb.conv_bwd_update(w, x, dr, geom, nm_s, (1, 2),
                                           (3, 4), gains, **bkw),
                lambda: kb.conv_bwd_update_plain(w, x, dr, geom, nm_s,
                                                 (1, 2), (3, 4), gains,
                                                 **bkw),
                lambda: (torch.matmul(dr, w), torch.matmul(sb.T, sa),
                         torch.matmul(sb.abs().T, sa.abs())),
                4 * (w.numel() + dr.numel() + x.numel() + p + 2
                     + p * geom.cols + p + 2 * w.numel()),
                2.0 * p * m * geom.cols, 4.0 * p * m * geom.cols)
    g = torch.Generator(device=DEV).manual_seed(11)
    for name, n_in, out in DENSE_LAYERS:
        w = torch.randn(out, n_in + 1, generator=g, device=DEV)
        x = torch.randn(LENET_BATCH, n_in + 1, generator=g, device=DEV)
        dd = torch.randn(LENET_BATCH, out, generator=g, device=DEV)
        nm_s = torch.ones(LENET_BATCH, 1, device=DEV)
        bkw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, bl=1)
        sa = (torch.rand_like(x) < 0.5).float()
        sb = (torch.rand_like(dd) < 0.5).float()
        b = LENET_BATCH
        _time_row(
            rows, "bwd_update_mvm", name,
            lambda: kb.bwd_update_mvm(w, dd, x, nm_s, (1, 2), (3, 4, 0),
                                      gains, **bkw),
            lambda: kb.bwd_update_mvm_plain(w, dd, x, nm_s, (1, 2),
                                            (3, 4, 0), gains, **bkw),
            lambda: (torch.matmul(dd, w), torch.matmul(sb.T, sa),
                     torch.matmul(sb.abs().T, sa.abs())),
            4 * (w.numel() + dd.numel() + x.numel() + b + 2 + x.numel() + b
                 + 2 * w.numel()),
            2.0 * b * out * (n_in + 1), 4.0 * b * out * (n_in + 1))
    for case, t, m, n in _count_shapes():
        rws, cls = _streams(g, t, m, n)
        _time_row(rows, "pulse_counts", case,
                  lambda: kp.pulse_counts(rws, cls),
                  lambda: kp.pulse_counts_plain(rws, cls),
                  lambda: (torch.matmul(rws.T, cls),
                           torch.matmul(rws.abs().T, cls.abs())),
                  4 * (t * (m + n) + 2 * m * n), 0.0,
                  4.0 * t * m * n)


def seq_kernel_times(results):
    """#1 and #2 at the full-width LSTM's reads (wx 128x9 and wh 128x32 at
    B 8, the readout 8x33 over 272 rows; forward and transpose), #6 at wx
    and wh (B 8, BL 10) and #4 at one timestep's counts (8 x 10 slots)."""
    import torch
    from repro_torch.kernels import bwd_update_mvm as kb
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    rows = results["times"]
    g = torch.Generator(device=DEV).manual_seed(990)
    for name, r, c, batches in SEQ_TILES:
        b = batches[0]
        w = torch.randn(r, c, generator=g, device=DEV) * c ** -0.5
        for tr in (False, True):
            k, n_out = (r, c) if tr else (c, r)
            x = torch.randn(b, k, generator=g, device=DEV)
            nm_s = x.abs().amax(1, keepdim=True)
            kw = dict(sigma=SIGMA, alpha=2.0, transpose=tr)
            mkw = dict(kw, two_phase=True, retry_scale=16.0)
            shape = f"LSTM {name}{'T' if tr else ''} B={b}"
            byts = 4 * (w.numel() + x.numel() + b * n_out) + b
            flops = 2.0 * b * k * n_out
            lib = lambda: torch.matmul(x, w if tr else w.T)  # noqa: E731
            _time_row(rows, "noisy_mvm", shape,
                      lambda: kn.noisy_mvm(w, x, 1, **kw),
                      lambda: kn.noisy_mvm_plain(w, x, 1, **kw), lib,
                      byts, flops, 0.0, batch=b)
            _time_row(rows, "managed_mvm", shape,
                      lambda: km.managed_mvm(w, x, nm_s, (1, 2), **mkw),
                      lambda: km.managed_mvm_plain(w, x, nm_s, (1, 2),
                                                   **mkw), lib,
                      byts + 4 * b, 2 * flops, 0.0, batch=b)
    gains = torch.tensor([1.0, 1.0], device=DEV)
    bl, b = 10, SEQ_B
    for name, r, c, _ in SEQ_TILES[:2]:
        w = torch.randn(r, c, generator=g, device=DEV) * r ** -0.5
        x = torch.randn(b, c, generator=g, device=DEV)
        dd = torch.randn(b, r, generator=g, device=DEV)
        nm_s = dd.abs().amax(1, keepdim=True)
        sa = (torch.rand(b * bl, c, device=DEV) < 0.5).float()
        sb = (torch.rand(b * bl, r, device=DEV) < 0.5).float()
        bkw = dict(sigma=SIGMA, alpha=2.0, two_phase=True, bl=bl)
        _time_row(
            rows, "bwd_update_mvm", f"LSTM {name} BL=10",
            lambda: kb.bwd_update_mvm(w, dd, x, nm_s, (1, 2), (3, 4, 264),
                                      gains, **bkw),
            lambda: kb.bwd_update_mvm_plain(w, dd, x, nm_s, (1, 2),
                                            (3, 4, 264), gains, **bkw),
            lambda: (torch.matmul(dd, w), torch.matmul(sb.T, sa),
                     torch.matmul(sb.abs().T, sa.abs())),
            4 * (w.numel() + dd.numel() + x.numel() + b + 2 + 2 * w.numel()),
            4.0 * b * r * c, 4.0 * b * bl * r * c)
        rws, cls = _streams(g, b * bl, r, c)
        _time_row(rows, "pulse_counts", f"LSTM {name} BL=10 one timestep",
                  lambda: kp.pulse_counts(rws, cls),
                  lambda: kp.pulse_counts_plain(rws, cls),
                  lambda: (torch.matmul(rws.T, cls),
                           torch.matmul(rws.abs().T, cls.abs())),
                  4 * (b * bl * (r + c) + 2 * r * c), 0.0,
                  4.0 * b * bl * r * c)


def slice3_kernel_times(results):
    """Flash attention at qwen3's prefill shape (float32: the analog path;
    bfloat16: the digital one) and the fused update at the f5 shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pulse_update as kp

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = results["times"]
    case, b, sq, sk, h, hkv, d, causal, win, bk = FLASH_CASES[5]
    # (q, k) pairs the causal mask keeps: the multiply-adds the work needs
    pairs = sum(min(i + 1, sk) for i in range(sq))
    for dtype, rate in ((torch.float32, FP32_FLOPS_PER_S),
                        (torch.bfloat16, BF16_FLOPS_PER_S)):
        g = torch.Generator(device=DEV).manual_seed(700)
        q, k, v = _qkv(g, b, sq, sk, h, hkv, d, dtype)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        byts = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        _time_row(rows, "flash_attention", f"{case} {str(dtype)[6:]}",
                  lambda: fa.flash_attention(q, k, v),
                  lambda: fa.flash_attention_plain(q, k, v),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True),
                  byts, 4.0 * pairs * d * b * h, 0.0,
                  flop_rate=rate, batch=b)
        del q, k, v, qt, kt, vt
    for case, m, n, bsz, bl, ctoc in PULSE_CASES:
        cfg, maps, w, rws, cls, key = _pulse_case(m, n, bsz, bl, ctoc, 700)
        t = bsz * bl
        rws, cls = rws.reshape(t, m), cls.reshape(t, n)
        up, dn, bound = maps.dw_up, maps.dw_dn, maps.bound
        xi = torch.randn(m, n, device=DEV)

        def library():
            net = torch.matmul(rws.T, cls)
            tot = torch.matmul(rws.abs().T, cls.abs())
            cu, cd = 0.5 * (tot + net), 0.5 * (tot - net)
            dw = cu * up - cd * dn + ctoc * torch.sqrt(
                cu * up * up + cd * dn * dn) * xi
            return torch.clamp(w + dw, -bound, bound)

        _time_row(rows, "pulse_update", f"{case} T={t}",
                  lambda: kp.pulse_update(w, up, dn, bound, rws, cls, 1,
                                          ctoc=ctoc),
                  lambda: kp.pulse_update_plain(w, up, dn, bound, rws, cls,
                                                1, ctoc),
                  library,
                  4 * (t * (m + n) + 5 * m * n), 0.0, 4.0 * t * m * n,
                  batch=None)


# ---------------------------------------------------------------------------
# (s3, m, y, q) stablelm_3b, the ssm and hybrid families, continuous
# batching
# ---------------------------------------------------------------------------

STABLE_BATCH, STABLE_PROMPT, STABLE_GEN = 4, 32, 16
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_GEN = 4, 512, 32
# no update management: the SSD projections' prefill reads go through the
# temporal route, one read per prompt position (iterative BM on #1)
MAMBA_TEMPORAL = "*ssm*=nm_bm:use_pallas=true"
MAMBA_T_PROMPT, MAMBA_T_GEN = 256, 16
HYMBA_BATCH, HYMBA_PROMPT, HYMBA_GEN = 2, 1100, 16
Q_SLOTS, Q_REQUESTS, Q_PROMPT, Q_GEN, Q_REPLAY = 4, 12, 1200, 16, 6
# card vs CPU on the smoke models: tests/test_torch_families.py's
# LOGIT_ATOL on logits and every float cache leaf; an int8 cache's codes
# equal
FAMILY_ATOL = 1e-4
# s3's dense pool: a request that fills its linear cache (prompt + new =
# max_seq) and a later one that decodes on while the first one's slot is
# free, its pos running past the cache
S3_STREAM = ((STABLE_PROMPT, STABLE_GEN, 0), (STABLE_PROMPT // 2,
                                             STABLE_GEN, 3))
PUBLISHED = {
    "stablelm_3b": dict(n_layers=32, d_model=2560, n_heads=32,
                        n_kv_heads=32, d_ff=6912, vocab=50304),
    "mamba2_130m": dict(n_layers=24, d_model=768, vocab=50280,
                        tie_embeddings=True),
    "hymba_1_5b": dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
                       d_head=64, d_ff=5504, vocab=32001, swa_window=1024),
}


# the runs whose launches the summary line reports per kernel
FAMILY_RUNS = ("serve_stablelm", "serve_mamba", "serve_mamba_temporal",
               "serve_hymba", "serve_continuous")


def _load(label, arch, policy, **over):
    """The published ``arch`` under ``policy`` on the card: (cfg, params,
    akey); prints its size, the seconds it took and the memory it holds."""
    import torch
    from repro_torch.launch import serve as S
    cfg = S.build_cfg(arch, SMOKE, policy)
    for k, v in PUBLISHED[arch].items():
        check(SMOKE or getattr(cfg, k) == v, f"not the published {arch}: {k}")
    cfg = dataclasses.replace(cfg, **over)
    _free()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, akey = S.init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n = sum(t.numel() for t in _tensors(params))
    print(f"[{label}] {arch}: {n / 1e9:.3f} B parameters on the card in "
          f"{t_init:.1f}s, {(torch.cuda.memory_allocated() - mem0) / 1e9:.2f}"
          f" GB (reckoned param_count {cfg.param_count() / 1e9:.3f} B)")
    return cfg, params, akey, dict(init_s=t_init, n_params=n)


def _peak(label, row):
    import torch
    row["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{label}] peak allocated {row['peak_allocated_gb']:.2f} GB")


def _generate(label, cfg, params, akey, batch, prompt, gen, want=None):
    """Warm-up, then one counted, timed ``greedy_generate`` (no plain
    version may run); then one prefill's and one decode step's wall and
    device time.  ``want``: the launches per kind it must make.  An
    encoder-decoder reads the driver's stub frames (``make_frames``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    prompts = S.make_prompts(cfg, batch, prompt, 0, DEV)
    frames = S.make_frames(cfg, batch, prompt, 0, DEV)
    max_seq = prompt + gen
    with torch.no_grad():
        engine.greedy_generate(params, prompts, cfg, n_steps=2,
                               max_seq=max_seq, enc_embeds=frames,
                               akey=akey)                     # warm-up
        torch.cuda.synchronize()
        with _PlainCalls() as plain:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            toks, cache = engine.greedy_generate(
                params, prompts, cfg, n_steps=gen, max_seq=max_seq,
                enc_embeds=frames, akey=akey)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = ops.launch_counts()
        toks = toks.cpu()
        got = {k: v for k, v in counts.items() if v}
        print(f"[{label}] tokens {tuple(toks.shape)}, launches {got}, "
              f"plain-version calls {plain.calls}, {batch * gen / dt:.2f} "
              f"tok/s after warm-up ({dt:.2f}s for prefill + {gen - 1} "
              f"decode steps)")
        check(plain.calls == 0, f"{plain.calls} plain-version calls")
        check(tuple(toks.shape) == (batch, gen), "wrong token shape")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              "token out of range")
        if want is not None:
            check(got == want, f"launches {got}, expected {want}")
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        del cache
        prefill = lambda: engine.prefill(params, prompts, cfg,  # noqa
                                         max_seq=max_seq,
                                         enc_embeds=frames, akey=akey)
        logits, cache = prefill()
        check(tuple(logits.shape) == (batch, 1, cfg.vocab), "logit shape")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pre = _profile_step(prefill, f"one {cfg.name} prefill (B {batch}, "
                            f"S {prompt})")
        dec = _profile_step(lambda: engine.serve_step(
            params, tok, cache, cfg, akey=engine.decode_step_key(akey, 0)),
            f"one {cfg.name} decode step (B {batch})")
        del logits, cache
    return dict(batch=batch, prompt=prompt, gen=gen, launches=counts,
                first_tokens=toks[:, 0].tolist(),
                plain_calls=plain.calls, tok_per_s=batch * gen / dt,
                seconds=dt, cache_shapes=shapes, prefill_profile=pre,
                decode_profile=dec)


def _per_pass(cfg):
    """Analog reads of one forward pass (prefill or decode step) under a
    policy that converts every dense site: 7 per attention + MLP layer, 2
    per SSD block, and the untied unembed."""
    per_layer = {"dense": 7, "ssm": 2, "hybrid": 9}[cfg.family]
    return per_layer * cfg.n_layers + (0 if cfg.tie_embeddings else 1)


def serve_stablelm(results):
    cfg, params, akey, meta = _load("serve_stablelm", "stablelm_3b",
                                    POLICY_2P)
    row = _generate("serve_stablelm", cfg, params, akey, STABLE_BATCH,
                    STABLE_PROMPT, STABLE_GEN,
                    want={"managed_read": _per_pass(cfg) * STABLE_GEN})
    row["continuous"] = _dense_pool("serve_stablelm", cfg, params, akey)
    _peak("serve_stablelm", row)
    results["serve_stablelm"] = dict(policy=POLICY_2P, **meta, **row)
    del params
    _free()


def _dense_pool(label, cfg, params, akey):
    """S3_STREAM through a 2-slot pool over linear caches: the first
    request fills its cache and its free row decodes on past the cache's
    end (a write that must land nowhere); every request completes, its
    first token is the batch-1 prefill's, and its tokens are finite ids."""
    import numpy as np
    import torch
    from repro_torch.serve import engine
    from repro_torch.serve import scheduler as sched

    max_seq = STABLE_PROMPT + STABLE_GEN
    rng = np.random.default_rng(0)
    reqs = [sched.Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=p)
                          .astype(np.int32), max_new_tokens=n, arrival=t)
            for i, (p, n, t) in enumerate(S3_STREAM)]
    s = sched.ContinuousBatchingScheduler(params, cfg, slots=2,
                                          max_seq=max_seq, akey=akey)
    t0 = time.perf_counter()
    done = {c.rid: c for c in s.run(reqs)}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pos = [int(p) for p in s._cache["pos"].cpu()]
    first, oracle = 0, 0
    with torch.no_grad():
        for r in reqs:
            out, _ = engine.greedy_generate(
                params, torch.as_tensor(r.prompt, dtype=torch.int64,
                                        device=DEV)[None],
                cfg, n_steps=r.max_new_tokens, max_seq=max_seq, akey=akey)
            out = [int(t) for t in out[0].cpu()]
            first += out[0] == done[r.rid].tokens[0]
            oracle += out == done[r.rid].tokens
    print(f"[{label}] continuous, 2 slots over linear caches of {max_seq}: "
          f"{len(done)}/{len(reqs)} requests in {dt:.2f}s, final pos {pos} "
          f"(slot 0 past its cache), first tokens equal to batch-1 "
          f"greedy_generate's {first}/{len(reqs)}; all tokens equal "
          f"(not gated: the pool's reads draw other noise) "
          f"{oracle}/{len(reqs)}")
    check(sorted(done) == [r.rid for r in reqs]
          and all(len(done[r.rid].tokens) == r.max_new_tokens
                  for r in reqs), "the dense pool left a request short")
    check(pos[0] > max_seq, f"slot 0's pos {pos[0]} never passed the cache")
    check(all(0 <= t < cfg.vocab for c in done.values() for t in c.tokens),
          "token out of range")
    check(first == len(reqs), "a first token differs from the batch-1 "
                              "prefill's")
    return dict(max_seq=max_seq, final_pos=pos, seconds=dt,
                first_tokens_equal=first, oracle_equal=oracle)


def _cache_err(label, a, b):
    """The largest difference over the float leaves of two cache trees
    (the same leaves, shapes and dtypes; positions and int8 codes
    equal)."""
    import torch
    worst = 0.0
    check(set(a) == set(b), f"{label}: cache leaves {set(a)} vs {set(b)}")
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        check(x.shape == y.shape and x.dtype == y.dtype, f"{label}: {k}")
        if k == "pos":
            check(torch.equal(x, y), f"{label}: positions differ")
        elif x.dtype == torch.int8:
            check(torch.equal(x, y), f"{label}: {k} codes differ in "
                  f"{int((x != y).sum())} places")
        else:
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst


def _smoke_vs_cpu(label, arch, policy, results, steps=4, prompt=40,
                  flash=(False,), **over):
    """The smoke model (``over`` replacing config fields) on the card
    against the CPU: prefill plus ``steps`` decode steps from the same
    weights, tokens and keys; logits and every float cache leaf within
    FAMILY_ATOL, an int8 cache's codes equal, greedy tokens equal."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer
    from repro_torch.serve import engine
    from repro_torch.utils import prng

    cfg0 = dataclasses.replace(S.build_cfg(arch, True, policy),
                               act_dtype=torch.float32, **over)
    p_cpu = transformer.init_lm(0, cfg0, device="cpu")
    p_gpu = _to(p_cpu, DEV)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg0.vocab, (2, prompt)))
    frames = (torch.as_tensor(rng.normal(0, 0.5, (2, prompt, cfg0.d_model)),
                              dtype=torch.float32)
              if cfg0.encoder_layers else None)
    for fl in flash:
        cfg = dataclasses.replace(cfg0, use_flash_kernel=fl)
        runs = {}
        for dev, p in (("cpu", p_cpu), (DEV, p_gpu)):
            key = prng.key(5)
            with torch.no_grad():
                lg, cache = engine.prefill(
                    p, toks.to(dev), cfg, max_seq=prompt + steps + 1,
                    enc_embeds=None if frames is None else frames.to(dev),
                    akey=key)
                out, caches = [lg.cpu()], [{k: v.cpu()
                                            for k, v in cache.items()}]
                for i in range(steps):
                    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                    lg, cache = engine.serve_step(
                        p, tok, cache, cfg,
                        akey=engine.decode_step_key(key, i))
                    out.append(lg.cpu())
                    caches.append({k: v.cpu() for k, v in cache.items()})
            runs[dev] = (out, caches)
        err = max(float((a - b).abs().max())
                  for a, b in zip(runs["cpu"][0], runs[DEV][0]))
        cerr = max(_cache_err(label, a, b)
                   for a, b in zip(runs["cpu"][1], runs[DEV][1]))
        same = all(torch.equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(runs["cpu"][0], runs[DEV][0]))
        what = f"{arch} smoke {policy}" + (f", flash {'on' if fl else 'off'}"
                                            if len(flash) > 1 else "") + (
            "".join(f", {k}={v}" for k, v in over.items()))
        print(f"[reference] {what}: prefill + {steps} decode steps, logits "
              f"max|diff| {err:.2e}, cache leaves {cerr:.2e} (tol "
              f"{FAMILY_ATOL:g}; leaves {sorted(runs[DEV][1][0])}; int8 "
              f"codes equal), greedy tokens equal: {same}")
        results.setdefault("reference_families", []).append(dict(
            arch=arch, policy=policy, flash=fl, logit_err=err,
            cache_err=cerr, tokens_equal=same, **over))
        check(err <= FAMILY_ATOL and cerr <= FAMILY_ATOL and same,
              f"{what}: the card disagrees with the CPU reference")


def serve_mamba(results):
    """(i) two-phase BM over single-shot reads; (ii) the temporal route:
    one #1 read per prompt position and projection in the prefill;
    (iii) the smoke model, card against CPU."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    cfg, params, akey, meta = _load("serve_mamba", "mamba2_130m", POLICY_2P)
    row = _generate("serve_mamba", cfg, params, akey, MAMBA_BATCH,
                    MAMBA_PROMPT, MAMBA_GEN,
                    want={"managed_read": _per_pass(cfg) * MAMBA_GEN})
    want = {k: tuple(v.shape) for k, v in engine.init_cache(
        cfg, MAMBA_BATCH, MAMBA_PROMPT + MAMBA_GEN, device="meta").items()}
    print(f"[serve_mamba] cache {row['cache_shapes']}")
    check(row["cache_shapes"] == want and "k" not in want,
          f"cache {row['cache_shapes']}, init_cache's {want}")
    _peak("serve_mamba", row)
    results["serve_mamba"] = dict(policy=POLICY_2P, **meta, **row)
    del params
    _free()

    cfg, params, akey, meta = _load("serve_mamba_temporal", "mamba2_130m",
                                    MAMBA_TEMPORAL)
    prompts = S.make_prompts(cfg, MAMBA_BATCH, MAMBA_T_PROMPT, 0, DEV)
    max_seq = MAMBA_T_PROMPT + MAMBA_T_GEN
    with torch.no_grad(), _PlainCalls() as plain:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(params, prompts, cfg,
                                       max_seq=max_seq, akey=akey)
        torch.cuda.synchronize()
        pre_wall = time.perf_counter() - t0
        pre = ops.launch_counts()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks = S.serve("mamba2_130m", batch=MAMBA_BATCH,
                       prompt_len=MAMBA_T_PROMPT, gen=MAMBA_T_GEN,
                       params=params, akey=akey, smoke=SMOKE,
                       analog_policy=MAMBA_TEMPORAL, device=DEV)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run = ops.launch_counts()
    want = 2 * cfg.n_layers * MAMBA_T_PROMPT
    print(f"[serve_mamba_temporal] one prefill (B {MAMBA_BATCH}, S "
          f"{MAMBA_T_PROMPT}): {pre['noisy_read']} #1 launches (at least "
          f"{want}: one read per position, projection and layer, each with "
          f"its iterative-BM retries), {pre_wall * 1e3:.1f} ms wall; the "
          f"serve entry (prefill + {MAMBA_T_GEN - 1} decode steps) "
          f"{run['noisy_read']} #1 launches, {MAMBA_BATCH * MAMBA_T_GEN / dt:.2f}"
          f" tok/s; plain-version calls {plain.calls}")
    check(pre["noisy_read"] >= want and pre["managed_read"] == 0,
          f"prefill launches {pre}")
    check(run["noisy_read"] >= want + 2 * cfg.n_layers * (MAMBA_T_GEN - 1),
          f"serve launches {run}")
    check(plain.calls == 0, f"{plain.calls} plain-version calls")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(toks.shape == (MAMBA_BATCH, MAMBA_T_GEN), "wrong token shape")
    row = dict(policy=MAMBA_TEMPORAL, **meta, prompt=MAMBA_T_PROMPT,
               prefill_launches=pre, prefill_wall_ms=pre_wall * 1e3,
               launches=run, tok_per_s=MAMBA_BATCH * MAMBA_T_GEN / dt,
               seconds=dt)
    _peak("serve_mamba_temporal", row)
    results["serve_mamba_temporal"] = row
    del params, logits, cache
    _free()
    for policy in (POLICY_2P, MAMBA_TEMPORAL):
        _smoke_vs_cpu("reference_mamba", "mamba2_130m", policy, results)


class _FlashCalls:
    """Records the mode of every flash-attention call of one prefill while
    active and keeps the inputs of each mode's first call: ``causal``, and
    without the causal mask ``bidirectional`` (the encoder's layers, which
    run before any causal call) or ``cross`` (the decoder's, after)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        self.fa, self.fn = fa, fa.flash_attention
        self.modes, self.first = [], {}

        def keep(q, k, v, **kw):
            mode = ("causal" if kw.get("causal", True) else "cross"
                    if "causal" in self.modes else "bidirectional")
            self.modes.append(mode)
            if mode not in self.first:
                self.first[mode] = (q.clone(), k.clone(), v.clone(), kw)
            return self.fn(q, k, v, **kw)
        fa.flash_attention = keep
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.fn
        return False


def serve_hymba(results):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    cfg, params, akey, meta = _load("serve_hymba", "hymba_1_5b", POLICY_2P,
                                    use_flash_kernel=True)
    n = cfg.n_layers
    row = _generate("serve_hymba", cfg, params, akey, HYMBA_BATCH,
                    HYMBA_PROMPT, HYMBA_GEN,
                    want={"flash_attention": n,
                          "managed_read": _per_pass(cfg) * HYMBA_GEN})
    ring = (n, HYMBA_BATCH, cfg.swa_window, cfg.n_kv_heads, cfg.head_dim)
    check(row["cache_shapes"]["k"] == ring == row["cache_shapes"]["v"],
          f"ring cache {row['cache_shapes']}")
    print(f"[serve_hymba] ring cache k/v {ring}; ssm_conv "
          f"{row['cache_shapes']['ssm_conv']}, ssm_state "
          f"{row['cache_shapes']['ssm_state']}")
    # the prefill's flash share
    rows = row["prefill_profile"].get("top", [])
    busy = row["prefill_profile"]["device_busy_ms"]
    flash = [r for r in row["prefill_profile"].get("kernels", {}).items()
             if "flash" in r[0]]
    print(f"[serve_hymba] flash kernel records in the profiled prefill: "
          f"{flash}; top device operations {[r['kernel'][:40] for r in rows[:3]]}"
          f", busy {busy}")
    _peak("serve_hymba", row)

    # #8 at this prefill's own q, k, v (layer 0), against its plain version
    prompts = S.make_prompts(cfg, HYMBA_BATCH, HYMBA_PROMPT, 0, DEV)
    with torch.no_grad(), _FlashCalls() as kept:
        engine.prefill(params, prompts, cfg,
                       max_seq=HYMBA_PROMPT + HYMBA_GEN, akey=akey)
    q, k, v, kw = kept.first["causal"]
    check(kw.get("window") == cfg.swa_window and kw.get("causal"),
          f"flash called with {kw}")
    y = fa.flash_attention(q, k, v, **kw)
    yp = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (y.float() - yp.float()).abs()
    tol = 2e-5 + 2e-5 * yp.float().abs()
    worst = float((diff / tol).max())
    good = worst <= 1.0 and bool(torch.isfinite(y).all())
    case = (f"hymba prefill {tuple(q.shape)} over {tuple(k.shape)} "
            f"{str(q.dtype)[6:]} window {kw['window']}")
    print(f"[check] flash_attention {case}: max|diff|={float(diff.max()):.3e}"
          f" worst |diff|/tol={worst:.3f} (rtol=atol=2e-5) "
          f"{'ok' if good else 'FAIL'}; q, k, v reach the kernel as "
          f"{q.dtype} (param_dtype {cfg.param_dtype}, act_dtype "
          f"{cfg.act_dtype})")
    results.setdefault("checks", []).append(dict(
        kernel="flash_attention", case=case, max_abs_err=float(diff.max()),
        worst_ratio=worst, tol="rtol=atol=2e-5", ok=good))
    check(good, "flash attention disagrees with its plain version at "
                "hymba's prefill")
    results["serve_hymba"] = dict(policy=POLICY_2P, **meta, **row,
                                  ring_cache=list(ring),
                                  swa_window=cfg.swa_window,
                                  qkv_dtype=str(q.dtype))
    del params, q, k, v, y, yp, kept
    _free()
    _smoke_vs_cpu("reference_hymba", "hymba_1_5b", POLICY_2P, results,
                  flash=(False, True))


def _checked_scheduler():
    """The scheduler with one row check at the first decode tick where a
    slot is free and another live.  For each live row r, the same step
    with every other row's cache (live and free) set to NaN: row r's
    logits must stay bitwise unmoved, so each live row decodes as a batch-1
    decode would at the pool's shape and under its step key.  Batch-1
    decodes from each live row (and the same under a second key) are
    printed beside it, ungated: a batch-1 read draws other noise (a read's
    counters run over its rows)."""
    import torch
    from repro_torch.serve import engine
    from repro_torch.serve import scheduler as sched

    class Checked(sched.ContinuousBatchingScheduler):
        report = None

        def _decode_tokens(self, last):
            live = [i for i, a in enumerate(self._active) if a is not None]
            if self.report is None and 0 < len(live) < self.slots:
                self.report = self._row_check(last, live)
            return super()._decode_tokens(last)

        def _row_check(self, last, live):
            toks = torch.as_tensor(last, device=DEV)[:, None]
            key = engine.decode_step_key(self.akey, self._step)
            other = engine.decode_step_key(self.akey, self._step + 100000)
            step = lambda t, c, k: engine.serve_step(  # noqa: E731
                self.params, t, c, self.cfg, akey=k)[0]
            free = [i for i in range(self.slots) if i not in live]
            with torch.no_grad():
                lb = step(toks, self._cache, key)
                alone = []
                for r in live:
                    rest = [i for i in range(self.slots) if i != r]
                    nan = {}
                    for k, v in self._cache.items():
                        v = v.clone()
                        if k != "pos":
                            v[:, rest] = float("nan")
                        nan[k] = v
                    alone.append(torch.equal(step(toks, nan, key)[r], lb[r]))
                dist, redraw = [], []
                for r in live:
                    c1 = {k: v[r:r + 1] if k == "pos" else v[:, r:r + 1]
                          for k, v in self._cache.items()}
                    l1 = step(toks[r:r + 1], c1, key)
                    l2 = step(toks[r:r + 1], c1, other)
                    dist.append(float((lb[r] - l1[0]).abs().max()))
                    redraw.append(float((l2[0] - l1[0]).abs().max()))
            rep = dict(tick=self._tick, live=live, free=free,
                       rows_alone_unmoved=alone, dist=dist, redraw=redraw,
                       finite=bool(torch.isfinite(lb[live]).all()))
            print(f"[serve_continuous] row check at tick {self._tick} "
                  f"(live {live}, free {free}): each live row's logits with "
                  f"every other row's cache NaN bitwise unmoved: {alone}; "
                  f"not gated: max|batched - batch-1| "
                  f"{[f'{d:.3g}' for d in dist]}, two batch-1 keys' "
                  f"{[f'{d:.3g}' for d in redraw]}")
            return rep

    return Checked


def serve_continuous(results):
    """``launch/serve.py --continuous`` at full width on hymba_1_5b."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    cfg, params, akey, meta = _load("serve_continuous", "hymba_1_5b",
                                    POLICY_2P)
    reqs = S.make_requests(cfg, n_requests=Q_REQUESTS, prompt_len=Q_PROMPT,
                           gen=Q_GEN, slots=Q_SLOTS, seed=0)
    lens = sorted(len(r.prompt) for r in reqs)
    print(f"[serve_continuous] {Q_REQUESTS} requests, prompts {lens[0]}-"
          f"{lens[-1]} tokens (window {cfg.swa_window}: "
          f"{sum(n > cfg.swa_window for n in lens)} past it), "
          f"{sum(r.max_new_tokens for r in reqs)} new tokens")
    max_seq = Q_PROMPT + Q_GEN
    Checked = _checked_scheduler()
    with _PlainCalls() as plain:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = S.serve_continuous(
            "hymba_1_5b", slots=Q_SLOTS, n_requests=Q_REQUESTS,
            prompt_len=Q_PROMPT, gen=Q_GEN, params=params, akey=akey,
            smoke=SMOKE, analog_policy=POLICY_2P, device=DEV)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
    check(plain.calls == 0, f"{plain.calls} plain-version calls")
    n_tok = sum(len(c.tokens) for c in done)
    check(sorted(c.rid for c in done) == list(range(Q_REQUESTS)),
          "not every request completed")
    by_rid = {r.rid: r for r in reqs}
    check(all(len(c.tokens) == by_rid[c.rid].max_new_tokens for c in done),
          "a request stopped short")

    # the same stream through the checked scheduler: its event log and
    # tokens, then the first requests it admitted alone
    from repro_torch.serve import scheduler as sched
    s1 = Checked(params, cfg, slots=Q_SLOTS, max_seq=max_seq, akey=akey)
    d1 = s1.run(reqs)
    check([dataclasses.astuple(c) for c in d1]
          == [dataclasses.astuple(c) for c in done],
          "a second run of the stream differs from the first")
    first = [e.rid for e in s1.events if e.kind == "admit"][:Q_REPLAY]
    s2 = sched.ContinuousBatchingScheduler(params, cfg, slots=Q_SLOTS,
                                           max_seq=max_seq, akey=akey)
    d2 = s2.run([by_rid[i] for i in first])
    same_events = s2.events == [e for e in s1.events if e.rid in first]
    tok1 = {c.rid: c.tokens for c in d1}
    same_tokens = all(c.tokens == tok1[c.rid] for c in d2)
    print(f"[serve_continuous] the first {Q_REPLAY} requests admitted "
          f"({first}) alone: event log equal to the full run's: "
          f"{same_events}, tokens equal: {same_tokens}")
    rep = s1.report
    check(rep is not None, "no tick had a free and a live slot")
    check(all(rep["rows_alone_unmoved"]) and rep["finite"],
          "another row's state moved a live row's logits")
    check(same_events and same_tokens, "the replay differs")

    # per-request oracles: the first token gated, the rest counted
    first_equal, oracle_equal = 0, 0
    with torch.no_grad():
        for c in done:
            r = by_rid[c.rid]
            out, _ = engine.greedy_generate(
                params, torch.as_tensor(r.prompt, dtype=torch.int64,
                                        device=DEV)[None],
                cfg, n_steps=r.max_new_tokens, max_seq=max_seq, akey=akey)
            out = [int(t) for t in out[0].cpu()]
            first_equal += out[0] == c.tokens[0]
            oracle_equal += out == c.tokens
    print(f"[serve_continuous] {len(done)}/{Q_REQUESTS} requests, {n_tok} "
          f"tokens over {Q_SLOTS} slots in {dt:.2f}s: {len(done) / dt:.3f} "
          f"req/s, {n_tok / dt:.2f} tok/s; launches "
          f"{ {k: v for k, v in counts.items() if v} }; first tokens equal "
          f"to batch-1 greedy_generate's: {first_equal}/{len(done)}; all "
          f"tokens equal to the per-request oracle's (not gated: the pool's "
          f"reads draw other noise): {oracle_equal}/{len(done)}")
    check(first_equal == len(done), "a first token differs from the "
                                    "batch-1 prefill's")
    row = dict(policy=POLICY_2P, **meta, slots=Q_SLOTS,
               requests=Q_REQUESTS, prompt_len=Q_PROMPT, gen=Q_GEN,
               seconds=dt, req_per_s=len(done) / dt, tok_per_s=n_tok / dt,
               launches=counts, plain_calls=plain.calls, replay=first,
               row_check=rep, first_tokens_equal=first_equal,
               oracle_equal=oracle_equal)
    _peak("serve_continuous", row)
    results["serve_continuous"] = row
    del params
    _free()
    slice16_kernel_times(results)


def _sdpa_backend(sdpa, q, k, v, mask, causal=False):
    """The backend SDPA's dispatcher picks for these inputs, and the device
    kernels five profiled calls ran (a single call can leave no record)."""
    import torch
    try:
        from torch.nn.attention import SDPBackend
        choice = SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0,
                                                    causal)).name
    except Exception as e:             # a private API: name what failed
        choice = f"not read ({type(e).__name__})"
    prof = _profiled(lambda: [sdpa() for _ in range(5)])
    kernels = sorted({ev.key[:60] for ev in prof.key_averages()
                      if str(getattr(ev, "device_type", "")).endswith("CUDA")
                      and (getattr(ev, "self_device_time_total", 0) or 0)})
    return dict(choice=choice, kernels=kernels)


def slice16_kernel_times(results):
    """#2 at mamba2's and hymba's in_proj shapes (B = batch and batch x
    prompt), #1 at the temporal route's per-position read, and #8 at
    hymba's prefill (float32, window 1024) against SDPA with the same
    mask, naming the kernel SDPA ran."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = results.setdefault("times", [])
    # (name, rows, cols with the bias column, batches): the tiles'
    # physical shapes
    reads = [("mamba2 in_proj 3352x769", 3352, 769,
              (MAMBA_BATCH, MAMBA_BATCH * MAMBA_PROMPT)),
             ("hymba in_proj 6482x1601", 6482, 1601,
              (HYMBA_BATCH, HYMBA_BATCH * HYMBA_PROMPT))]
    for name, r, c, batches in reads:
        for b in batches:
            w, x = _inputs(b, r, c, False, seed=16)
            nm = torch.amax(x.abs(), dim=1, keepdim=True)
            mkw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=1, two_phase=True,
                       retry_scale=16.0)
            y, s = km.managed_mvm(w, x, nm, (3, 4), **mkw)
            yp, sp = km.managed_mvm_plain(w, x, nm, (3, 4), **mkw)
            mag = float((x.abs() @ w.abs().T).max())
            check(_read_check(results, "managed_mvm", f"{name} B={b} NM", y,
                              yp, s, sp, mag), "#2 disagrees")
            _time_row(rows, "managed_mvm", f"{name} B={b}",
                      lambda: km.managed_mvm(w, x, nm, (3, 4), **mkw),
                      lambda: km.managed_mvm_plain(w, x, nm, (3, 4), **mkw),
                      lambda: torch.matmul(x, w.T),
                      4 * (r * c + b * c + b * r + 2 * b), 2.0 * b * r * c,
                      0.0, batch=b)
            del w, x, y, yp
    r, c, b = 3352, 769, MAMBA_BATCH
    w, x = _inputs(b, r, c, False, seed=17)
    kw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=1)
    y, s = kn.noisy_mvm(w, x, 99, **kw)
    yp, sp = kn.noisy_mvm_plain(w, x, 99, **kw)
    mag = float((x.abs() @ w.abs().T).max())
    check(_read_check(results, "noisy_mvm", f"mamba2 in_proj temporal B={b}",
                      y, yp, s, sp, mag), "#1 disagrees")
    _time_row(rows, "noisy_mvm", f"mamba2 in_proj 3352x769 temporal B={b}",
              lambda: kn.noisy_mvm(w, x, 99, **kw),
              lambda: kn.noisy_mvm_plain(w, x, 99, **kw),
              lambda: torch.matmul(x, w.T),
              4 * (r * c + b * c + b * r + b), 2.0 * b * r * c, 0.0,
              batch=b)
    del w, x, y, yp

    b, sq, h, hkv, d, win = HYMBA_BATCH, HYMBA_PROMPT, 25, 5, 64, 1024
    g = torch.Generator(device=DEV).manual_seed(716)
    q, k, v = _qkv(g, b, sq, sq, h, hkv, d, torch.float32)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
    i = torch.arange(sq, device=DEV)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < win)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,  # noqa
                                                  attn_mask=mask)
    lib_err = float((sdpa().transpose(1, 2) - fa.flash_attention_plain(
        q, k, v, window=win)).abs().max())
    backend = _sdpa_backend(sdpa, qt, kt, vt, mask)
    pairs = sum(min(j + 1, win) for j in range(sq))
    _time_row(rows, "flash_attention",
              f"hymba prefill float32 window {win}",
              lambda: fa.flash_attention(q, k, v, window=win),
              lambda: fa.flash_attention_plain(q, k, v, window=win), sdpa,
              (2 * q.numel() + k.numel() + v.numel()) * 4,
              4.0 * pairs * d * b * h, 0.0, batch=b)
    rows[-1].update(library_kernels=backend, library_max_abs_err=lib_err)
    print(f"[time] SDPA with the window mask ran {backend}; max|SDPA - "
          f"plain| {lib_err:.2e}")
    del q, k, v, qt, kt, vt
    _free()


# ---------------------------------------------------------------------------
# (t2) training the ssm and hybrid families; (s4) serving the
# encoder-decoder
# ---------------------------------------------------------------------------

# the SSD projections on the temporal route: nm_bm (no update management)
# reads once per position under the paper's iterative BM, on #1
T2_TEMPORAL = "*ssm*=nm_bm:use_pallas=true"
# (label, arch, layers, policy): mamba2 at all 24 layers on
# the single-shot route; hymba cut to 4 of 32 layers, as phase t cuts
# deepseek; the temporal route at 2 layers of mamba2 and 1 of hymba: a
# layer's SSD projections make 8382 #1 launches a replay (762 reads of 11
# predicated launches), and at 4 layers the warm-up and capture took the
# host 34-49 s a run
T2_RUNS = (
    ("t2_mamba_fused", "mamba2_130m", 24, FUSED_LM),
    ("t2_mamba_iterative", "mamba2_130m", 24, ITERATIVE_LM),
    ("t2_mamba_temporal", "mamba2_130m", 2, T2_TEMPORAL),
    ("t2_hymba_fused", "hymba_1_5b", 4, FUSED_LM),
    ("t2_hymba_temporal", "hymba_1_5b", 1, f"{T2_TEMPORAL},*={FUSED_LM}"),
)
# (name, rows, cols) of the new tiles, a bias column on each
T2_MAMBA = [("in_proj", 3352, 769), ("out_proj", 768, 1537)]
T2_HYMBA = [("q", 1600, 1601), ("k", 320, 1601), ("o", 1600, 1601),
            ("wi", 5504, 1601), ("wo", 1600, 5505), ("in_proj", 6482, 1601),
            ("out_proj", 1600, 3201), ("unembed", 32001, 1601)]
SEAMLESS_BATCH, SEAMLESS_PROMPT, SEAMLESS_GEN = 2, 1000, 16
# prefill logits with the flash kernel against the chunked attention (the
# two sum a row's scores in another order: float32 reassociation through
# 24 layers)
S4_LOGIT_ATOL = 1e-3
FLASH_RTOL = FLASH_ATOL = 2e-5   # tests/test_torch_flash.py
PUBLISHED["seamless_m4t_medium"] = dict(
    n_layers=12, encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, frontend="audio_stub")


def t2_kernels_vs_plain(results):
    """The new training shapes against the plain versions.  Single-shot
    (1016 rows): #1 and #2 at mamba2's and hymba's tiles forward and
    transposed (hymba's wi, wo and in_proj in 2 segments, its unembed in
    8), #6 at the tiles of at most 4096 rows, #4 at the others' counts
    (BL 1).  Temporal (8 rows a position): #1 at each SSD projection
    forward and transposed, with its seed in device memory and under a
    predicate as the graph reads it; #4 accumulated over the 127 positions
    at ``row_offset = t * 8`` (BL 10) bitwise one count over the 1016
    stacked rows."""
    import torch
    from repro_torch.core import update
    from repro_torch.kernels import noisy_mvm as kn
    from repro_torch.kernels import pulse_update as kp

    ok = _lm_checks(results, "t2 mamba2", LM_ROWS, T2_MAMBA, T2_MAMBA, (),
                    2500)
    ok &= _lm_checks(results, "t2 hymba", LM_ROWS, T2_HYMBA,
                     [t for t in T2_HYMBA if t[1] <= ARRAY],
                     [t for t in T2_HYMBA if t[1] > ARRAY], 2600)
    seed = 2700
    temporal = [("mamba2 " + n, r, c) for n, r, c in T2_MAMBA] + [
        ("hymba in_proj", 6482, 1601), ("hymba out_proj", 1600, 3201)]
    for name, rows, cols in temporal:
        for tr in (False, True):
            seed += 1
            g = torch.Generator(device=DEV).manual_seed(seed)
            k = rows if tr else cols
            w = (torch.randn(rows, cols, generator=g, device=DEV)
                 * k ** -0.5).contiguous()
            x = _scaled_rows(g, LM_B, k)
            case = f"t2 temporal {name}{' T' if tr else ''} B={LM_B}"
            mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
            kw = dict(sigma=SIGMA, alpha=ALPHA, transpose=tr,
                      n_seg=_n_seg(k))
            y, s = kn.noisy_mvm(w, x, 0xB22 + seed, **kw)
            yp, sp = kn.noisy_mvm_plain(w, x, 0xB22 + seed, **kw)
            ok &= _read_check(results, "noisy_mvm", case, y, yp, s, sp, mag)
            ok &= _seed_and_predicate_check(results, case, w, x,
                                            0xB22 + seed, kw, y, s)
    gain = torch.tensor(0.8, device=DEV)
    for name, rows, cols in temporal[::2]:
        seed += 1
        g = torch.Generator(device=DEV).manual_seed(seed)
        drv = torch.randn(T2_POSITIONS, LM_B, cols, generator=g, device=DEV)
        err = torch.randn(T2_POSITIONS, LM_B, rows, generator=g, device=DEV)
        acc = None
        for t in range(T2_POSITIONS):
            r = update.signed_streams(7, err[t], gain, 10,
                                      row_offset=t * LM_B)
            c = update.signed_streams(8, drv[t], gain, 10,
                                      row_offset=t * LM_B)
            acc = kp.pulse_counts(r.reshape(-1, rows).contiguous(),
                                  c.reshape(-1, cols).contiguous(), acc)
        r = update.signed_streams(7, err.reshape(-1, rows), gain, 10)
        c = update.signed_streams(8, drv.reshape(-1, cols), gain, 10)
        r, c = (a.reshape(-1, a.shape[-1]).contiguous() for a in (r, c))
        case = f"t2 temporal {name} {T2_POSITIONS} x B={LM_B}, BL=10"
        ok &= _count_check(results, "pulse_counts", case + " accumulated",
                           *acc, *kp.pulse_counts(r, c))
        ok &= _count_check(results, "pulse_counts", case, *acc,
                           *kp.pulse_counts_plain(r, c))
        del drv, err, r, c, acc
        _free()
    check(ok, "a kernel disagrees with its plain version at the ssm and "
          "hybrid training shapes")


def _tape_check(results, label, prog):
    """The key-schedule kernel at a captured step's tape, run once more at
    the step counter it was left at, bitwise its plain evaluator (host
    Python): every key and seed; timed at a tape whose keys live in device
    memory."""
    import torch
    from repro_torch.kernels import key_schedule as ks
    tape = prog.tape
    ks.key_schedule(tape, prog.base, prog.ctr[1])
    torch.cuda.synchronize()
    base = tuple(int(v) & 0xFFFFFFFF for v in prog.base.tolist())
    keys, seeds = ks.evaluate_plain(tape, base, int(prog.ctr[1]))
    got_k = [tuple(k) for k in tape.keys[:len(keys)].cpu().tolist()]
    got_s = tape.seeds[:len(seeds)].cpu().tolist()
    good = got_k == [tuple(k) for k in keys] and got_s == list(seeds)
    where = "shared" if len(keys) <= 6144 else "device"
    print(f"[check] key_schedule    {label} tape: {len(keys) - 1} "
          f"derivations, {len(seeds)} seeds (keys in {where} memory) "
          f"bitwise the plain evaluator {'ok' if good else 'FAIL'}")
    results.setdefault("checks", []).append(dict(
        kernel="key_schedule", case=f"{label} tape", tol=0.0, ok=good,
        max_abs_err=0.0 if good else float("inf")))
    check(good, f"{label}: the key schedule differs from its plain "
          "evaluator")
    if where == "device":
        _time_row(results.setdefault("times", []), "key_schedule",
                  f"t2 {label} tape",
                  lambda: ks.key_schedule(tape, prog.base, prog.ctr[1]),
                  lambda: ks.evaluate_plain(tape, base, 0), None,
                  *_key_schedule_work(tape), 0.0, batch=None)


def family_training(results):
    """(t2) mamba2_130m and hymba_1_5b through ``lm_train``: the kernels
    at their shapes, then each run of T2_RUNS, graphed bitwise the loop,
    its launches per replay against :func:`lm_per_step`."""
    t2_kernels_vs_plain(results)
    for label, arch, layers, policy in T2_RUNS:
        t0 = time.perf_counter()
        lm_train(label, policy, results, arch=arch, layers=layers)
        results[f"lm_train_{label}"]["phase_s"] = time.perf_counter() - t0
        print(f"[{label}] {time.perf_counter() - t0:.1f}s", flush=True)


def _flash_check(results, case, q, k, v, kw):
    """#8 against its plain version on the same inputs, rtol = atol =
    2e-5."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    y = fa.flash_attention(q, k, v, **kw)
    yp = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (y.float() - yp.float()).abs()
    worst = float((diff / (FLASH_ATOL + FLASH_RTOL * yp.float().abs()))
                  .max())
    good = worst <= 1.0 and bool(torch.isfinite(y).all())
    print(f"[check] flash_attention {case}: max|diff|="
          f"{float(diff.max()):.3e} worst |diff|/tol={worst:.3f} "
          f"(rtol=atol=2e-5) {'ok' if good else 'FAIL'}")
    results.setdefault("checks", []).append(dict(
        kernel="flash_attention", case=case, max_abs_err=float(diff.max()),
        worst_ratio=worst, tol="rtol=atol=2e-5", ok=good))
    return good


def _seamless_per_pass(cfg):
    """Analog reads of a prefill and of a decode step under a policy that
    converts every dense site: the encoder's 7 a layer and the adapter,
    the decoder's 7 and its cross attention's 4 a layer (its decode reads
    only q and o: the static K/V are the prefill's), and the unembed."""
    prefill = 7 * cfg.encoder_layers + 1 + 11 * cfg.n_layers + 1
    return prefill, 9 * cfg.n_layers + 1


def serve_seamless(results):
    """(s4) seamless_m4t_medium at full width (12 encoder and 12 decoder
    layers, d 1024, vocab 256206) under two-phase BM with the flash
    kernel: batch 2, 1000 prompt tokens and 1000 stub frames, 16 tokens."""
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.serve import engine

    cfg, params, akey, meta = _load("serve_seamless", "seamless_m4t_medium",
                                    POLICY_2P, use_flash_kernel=True)
    n = cfg.n_layers
    pre, dec = _seamless_per_pass(cfg)
    b, p, gen = SEAMLESS_BATCH, SEAMLESS_PROMPT, SEAMLESS_GEN
    row = _generate("serve_seamless", cfg, params, akey, b, p, gen,
                    want={"flash_attention": 3 * n,
                          "managed_read": pre + (gen - 1) * dec})
    cross = (n, b, p, cfg.n_kv_heads, cfg.head_dim)
    check(row["cache_shapes"]["cross_k"] == cross
          == row["cache_shapes"]["cross_v"],
          f"cross cache {row['cache_shapes']}")
    _peak("serve_seamless", row)

    prompts = S.make_prompts(cfg, b, p, 0, DEV)
    frames = S.make_frames(cfg, b, p, 0, DEV)
    with torch.no_grad(), _FlashCalls() as calls:
        on, _ = engine.prefill(params, prompts, cfg, max_seq=p + gen,
                               enc_embeds=frames, akey=akey)
    modes = {m: calls.modes.count(m) for m in set(calls.modes)}
    print(f"[serve_seamless] #8 launches in one prefill by mode {modes}")
    check(modes == {"bidirectional": n, "causal": n, "cross": n},
          f"#8 modes {modes}")
    off_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    with torch.no_grad():
        off, _ = engine.prefill(params, prompts, off_cfg, max_seq=p + gen,
                                enc_embeds=frames, akey=akey)
    err = float((on - off).abs().max())
    first_on, first_off = (t[:, -1].argmax(-1).cpu() for t in (on, off))
    print(f"[serve_seamless] prefill logits flash on vs off: max|diff| "
          f"{err:.3e} (tol {S4_LOGIT_ATOL:g}), first tokens "
          f"{first_on.tolist()} vs {first_off.tolist()}; generated first "
          f"tokens "
          f"{row['first_tokens']}")
    check(err <= S4_LOGIT_ATOL, "prefill logits: flash on and off differ")
    check(torch.equal(first_on, first_off)
          and row["first_tokens"] == first_off.tolist(),
          "the first token differs between flash on and off")
    ok = True
    for mode in ("bidirectional", "cross"):
        q, k, v, kw = calls.first[mode]
        check(not kw["causal"] and kw["window"] == 0, f"{mode}: {kw}")
        ok &= _flash_check(results, f"seamless prefill {mode} "
                           f"{tuple(q.shape)} over {tuple(k.shape)} "
                           f"{str(q.dtype)[6:]}", q, k, v, kw)
    g = torch.Generator(device=DEV).manual_seed(1817)
    q, k, v = _qkv(g, b, p, 1500, 16, 16, 64, torch.float32)
    ok &= _flash_check(results, "seamless cross Sq 1000 over Sk 1500 "
                       "float32", q, k, v, dict(causal=False, window=0))
    check(ok, "flash attention disagrees with its plain version at "
          "seamless's shapes")
    del q, k, v, calls, on, off
    ok = _lm_checks(results, "s4 seamless", b,
                    [("unembed", 256206, 1025), ("q", 1024, 1025)], (), (),
                    2800)
    ok &= _lm_checks(results, "s4 seamless", b * p,
                     [("wi", 4096, 1025), ("wo", 1024, 4097)], (), (), 2810)
    check(ok, "a read disagrees with its plain version at seamless's "
          "shapes")
    results["serve_seamless"] = dict(policy=POLICY_2P, **meta, **row,
                                     flash_modes=modes, logit_err=err,
                                     cross_cache=list(cross))
    del params
    _free()
    _smoke_vs_cpu("reference_seamless", "seamless_m4t_medium", POLICY_2P,
                  results, flash=(False, True))


def _read_rows(rows_out, g, shape, r, c, b, tr, kinds):
    """``kinds`` of #1 (``noisy_mvm``) and #2 (``managed_mvm``: NM's scale,
    two-phase BM) at one read of an ``r x c`` tile (``tr``: transposed), B
    ``b``, against their plain versions and ``torch.matmul``; #2's bound
    counts the second read of the rows the first saturates."""
    import torch
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn
    k, n_out = (r, c) if tr else (c, r)
    w = torch.randn(r, c, generator=g, device=DEV) * k ** -0.5
    x = torch.randn(b, k, generator=g, device=DEV)
    nm_s = x.abs().amax(1, keepdim=True)
    kw = dict(sigma=SIGMA, alpha=ALPHA, transpose=tr, n_seg=_n_seg(k))
    mkw = dict(kw, two_phase=True, retry_scale=16.0)
    byts = 4 * (w.numel() + x.numel() + b * n_out) + b
    flops = 2.0 * b * k * n_out
    lib = lambda: torch.matmul(x, w if tr else w.T)  # noqa: E731
    if "noisy_mvm" in kinds:
        _time_row(rows_out, "noisy_mvm", shape,
                  lambda: kn.noisy_mvm(w, x, 1, **kw),
                  lambda: kn.noisy_mvm_plain(w, x, 1, **kw), lib,
                  byts, flops, 0.0, batch=b)
    if "managed_mvm" in kinds:
        again = int(km.managed_mvm_plain(w, x, nm_s, (1, 2), **dict(
            mkw, two_phase=False))[1].sum())
        _time_row(rows_out, "managed_mvm", shape,
                  lambda: km.managed_mvm(w, x, nm_s, (1, 2), **mkw),
                  lambda: km.managed_mvm_plain(w, x, nm_s, (1, 2), **mkw),
                  lib, byts + 4 * b, flops * (1 + again / b), 0.0, batch=b)
    del w, x
    _free()


def _fused_row(rows_out, g, shape, r, c, b):
    """#6 (two-phase BM, BL 1) at an ``r x c`` tile and ``b`` rows against
    its plain version and the three products it replaces."""
    import torch
    from repro_torch.kernels import bwd_update_mvm as kb
    gains = torch.tensor([1.0, 1.0], device=DEV)
    w = torch.randn(r, c, generator=g, device=DEV) * r ** -0.5
    x = torch.randn(b, c, generator=g, device=DEV)
    dd = torch.randn(b, r, generator=g, device=DEV)
    nm_s = dd.abs().amax(1, keepdim=True)
    sa = (torch.rand(b, c, device=DEV) < 0.5).float()
    sb = (torch.rand(b, r, device=DEV) < 0.5).float()
    bkw = dict(sigma=SIGMA, alpha=ALPHA, two_phase=True, bl=1)
    again = int(kb.bwd_update_mvm_plain(
        w, dd, x, nm_s, (1, 2), (3, 4, 0), gains,
        **dict(bkw, two_phase=False))[1].sum())
    _time_row(
        rows_out, "bwd_update_mvm", f"{shape} B={b} BL=1",
        lambda: kb.bwd_update_mvm(w, dd, x, nm_s, (1, 2), (3, 4, 0),
                                  gains, **bkw),
        lambda: kb.bwd_update_mvm_plain(w, dd, x, nm_s, (1, 2),
                                        (3, 4, 0), gains, **bkw),
        lambda: (torch.matmul(dd, w), torch.matmul(sb.T, sa),
                 torch.matmul(sb.abs().T, sa.abs())),
        4 * (w.numel() + dd.numel() + x.numel() + b + 2 + 2 * w.numel()),
        2.0 * b * r * c * (1 + again / b), 4.0 * b * r * c, batch=b)
    del w, x, dd, sa, sb
    _free()


def _count_row(rows_out, g, shape, r, c, slots, bl):
    """#4 over ``slots`` vector pairs at BL ``bl`` for an ``r x c`` tile
    against its plain version and two fp32 products."""
    import torch
    from repro_torch.core import update
    from repro_torch.kernels import pulse_update as kp
    gain = torch.tensor(0.7, device=DEV)
    rws = update.signed_streams(5, torch.randn(slots, r, generator=g,
                                               device=DEV), gain,
                                bl).reshape(-1, r).contiguous()
    cls = update.signed_streams(6, torch.randn(slots, c, generator=g,
                                               device=DEV), gain,
                                bl).reshape(-1, c).contiguous()
    m = rws.shape[0]
    _time_row(rows_out, "pulse_counts", f"{shape} {m} slots",
              lambda: kp.pulse_counts(rws, cls),
              lambda: kp.pulse_counts_plain(rws, cls),
              lambda: (torch.matmul(rws.T, cls),
                       torch.matmul(rws.abs().T, cls.abs())),
              4 * (m * (r + c) + 2 * r * c), 0.0, 4.0 * m * r * c,
              batch=slots)
    del rws, cls
    _free()


def _flash_row(rows_out, g, shape, b, sq, sk, h, hkv, d, causal):
    """#8 float32 against its plain version and SDPA (K/V heads repeated;
    ``is_causal`` for a causal row, no mask otherwise), naming the kernel
    SDPA ran; the bound counts the pairs the mask keeps."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(g, b, sq, sk, h, hkv, d, torch.float32)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal)
    lib_err = float((sdpa().transpose(1, 2) - fa.flash_attention_plain(
        q, k, v, causal=causal)).abs().max())
    backend = _sdpa_backend(sdpa, qt, kt, vt, None, causal)
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    _time_row(rows_out, "flash_attention", shape,
              lambda: fa.flash_attention(q, k, v, causal=causal),
              lambda: fa.flash_attention_plain(q, k, v, causal=causal),
              sdpa, (2 * q.numel() + k.numel() + v.numel()) * 4,
              4.0 * pairs * d * b * h, 0.0, batch=b)
    rows_out[-1].update(library_kernels=backend, library_max_abs_err=lib_err)
    print(f"[time] SDPA ({'causal' if causal else 'no mask'}) ran "
          f"{backend}; max|SDPA - plain| {lib_err:.2e}")
    del q, k, v, qt, kt, vt
    _free()


def slice17_kernel_times(results):
    """#1 and #2 at mamba2's in_proj and hymba's transposed unembed (1016
    rows), #6 at mamba2's in_proj and hymba's out_proj, #4 at hymba's
    in_proj (1016 slots, BL 1) and the temporal route's per-position count
    (8 rows, BL 10), #1 at the temporal route's per-position read of
    hymba's in_proj (B 8); #2 at seamless's unembed (B 2) and #8 at
    seamless's prefill, bidirectional and cross (Sk 1000 and 1500),
    against SDPA without a mask."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    rows_out = results.setdefault("times", [])
    g = torch.Generator(device=DEV).manual_seed(1717)
    both = ("noisy_mvm", "managed_mvm")
    _read_rows(rows_out, g, "t2 mamba2 in_proj 3352x769", 3352, 769,
               LM_ROWS, False, both)
    _read_rows(rows_out, g, "t2 hymba unembedT 32001x1601", 32001, 1601,
               LM_ROWS, True, both)
    _read_rows(rows_out, g, "t2 temporal hymba in_proj 6482x1601", 6482,
               1601, LM_B, False, ("noisy_mvm",))
    _read_rows(rows_out, g, "seamless unembed 256206x1025", 256206, 1025,
               SEAMLESS_BATCH, False, ("managed_mvm",))
    _fused_row(rows_out, g, "t2 mamba2 in_proj 3352x769", 3352, 769,
               LM_ROWS)
    _fused_row(rows_out, g, "t2 hymba out_proj 1600x3201", 1600, 3201,
               LM_ROWS)
    _count_row(rows_out, g, "t2 hymba in_proj 6482x1601", 6482, 1601,
               LM_ROWS, 1)
    _count_row(rows_out, g, "t2 temporal mamba2 in_proj 3352x769", 3352,
               769, LM_B, 10)
    b, sq, h, d = SEAMLESS_BATCH, SEAMLESS_PROMPT, 16, 64
    for case, sk in (("bidirectional", sq), ("cross", sq),
                     ("cross Sk 1500", 1500)):
        _flash_row(rows_out, g, f"seamless prefill {case} float32 Sq {sq} "
                   f"Sk {sk}", b, sq, sk, h, h, d, False)


# ---------------------------------------------------------------------------
# (s5) qwen1_5_110b with its QKV bias and the int8 KV cache; (t3) training
# the encoder-decoder
# ---------------------------------------------------------------------------

# full-width qwen1_5_110b (d 8192, 64/8 heads of 128, d_ff 49152, vocab
# 152064) cut to 8 of its 80 layers: the 80 layers' f32 tiles pass 435 GB;
# 8 layers, the unembed and the f32 embedding hold ~53.5 GB
QWEN15_LAYERS = 8
QWEN15_BATCH, QWEN15_PROMPT, QWEN15_GEN = 2, 1000, 16
# tests/test_torch_kvquant.py's (and the JAX package's) bound on the int8
# cache's first decode step against the float cache's, in probability
S5_PROB_ATOL = 0.05
PUBLISHED["qwen1_5_110b"] = dict(
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab=152064, qkv_bias=True, rope_theta=1e6)
# (name, rows, cols) of qwen1_5_110b's new read shapes, a bias column on each
QWEN15_WI = ("wi", 49152, 8193)
QWEN15_WO = ("wo", 8192, 49153)
QWEN15_UNEMBED = ("unembed", 152064, 8193)
# seamless_m4t_medium trains at full width with both stacks cut evenly
# from 12 + 12 layers to 6 + 6: at 12 + 12 the phase took 249 s (a FUSED_LM
# replay 3.38 s, 208 k graph nodes; the profile of one replay 31-44 s),
# past the 200 s it may take beside the rest of the script.  An encoder
# read has B x S_src = 8 x 64 rows (the JAX trainer's stub frames,
# max(seq // 2, 8))
T3_LAYERS = 6
T3_ROWS_ENC = LM_B * max(LM_S // 2, 8)
T3_RUNS = (("t3_seamless_fused", FUSED_LM),
           ("t3_seamless_iterative", ITERATIVE_LM))
T3_ENC_WI = ("enc wi", 4096, 1025)
T3_CROSS_K = ("cross k", 1024, 1025)
T3_UNEMBED = ("unembed", 256206, 1025)
T3_CLI_STEPS = 60


def _kv_bytes(cache):
    return sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v"))


def serve_qwen15(results):
    """(s5) qwen1_5_110b at full width, cut to QWEN15_LAYERS layers, under
    two-phase BM with the flash prefill: batch 2, 1000 prompt tokens, 16
    new, from the same params and keys with ``kv_cache_quant`` off and on;
    then #2 and #8 at its shapes against their plain versions, and the
    smoke model with the int8 cache on the card against the CPU."""
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import attention
    from repro_torch.serve import engine

    cfg, params, akey, meta = _load("serve_qwen15", "qwen1_5_110b",
                                    POLICY_2P, n_layers=QWEN15_LAYERS,
                                    use_flash_kernel=True)
    n = cfg.n_layers
    b, p, gen = QWEN15_BATCH, QWEN15_PROMPT, QWEN15_GEN
    attn = params["layers"][0]["attn"]
    check([tuple(attn[k].shape) for k in ("qb", "kb", "vb")]
          == [(8192,), (1024,), (1024,)], "the QKV biases' shapes")
    # #2 per read (7 a layer and the unembed, a pass), #8 once a layer a
    # prefill (64/8 heads, causal, float32)
    want = {"managed_read": _per_pass(cfg) * gen, "flash_attention": n}
    cfgs = {q: dataclasses.replace(cfg, kv_cache_quant=q)
            for q in (False, True)}
    runs, caches = {}, {}
    for quant, c in cfgs.items():
        label = "serve_qwen15" + ("_int8" if quant else "")
        torch.cuda.reset_peak_memory_stats()
        runs[quant] = _generate(label, c, params, akey, b, p, gen, want=want)
        _peak(label, runs[quant])
    prompts = S.make_prompts(cfg, b, p, 0, DEV)
    prefill_logits, step_logits = {}, {}
    with torch.no_grad():
        with _FlashCalls() as calls:
            for quant, c in cfgs.items():
                prefill_logits[quant], caches[quant] = engine.prefill(
                    params, prompts, c, max_seq=p + gen, akey=akey)
        # the first decode step over each cache, from the same token and
        # key: the int8 one dequantizes its 1000 prefill entries and
        # quantizes the new one
        tok = torch.argmax(prefill_logits[False][:, -1], dim=-1)[:, None]
        for quant, c in cfgs.items():
            step_logits[quant], _ = engine.serve_step(
                params, tok, caches[quant], c,
                akey=engine.decode_step_key(akey, 0))
    del params
    _free()
    f, q = caches[False], caches[True]
    modes = {m: calls.modes.count(m) for m in set(calls.modes)}
    qq, kk, vv, kw = calls.first["causal"]
    print(f"[serve_qwen15] #8 launches in two prefills by mode {modes}, q "
          f"{tuple(qq.shape)} k {tuple(kk.shape)} {qq.dtype}")
    check(modes == {"causal": 2 * n} and qq.dtype == torch.float32
          and tuple(qq.shape) == (b, p, 64, 128)
          and tuple(kk.shape) == (b, p, 8, 128), f"#8 calls {modes}")
    bitwise = all(torch.equal(q[k], attention.quantize_kv(f[k]))
                  for k in ("k", "v"))
    clipped = float(sum((q[k].abs() == 127).sum() for k in ("k", "v"))
                    / (2 * q["k"].numel()))
    cache_bytes = {"float": _kv_bytes(f), "int8": _kv_bytes(q)}
    print(f"[serve_qwen15] prefill caches: k/v {f['k'].dtype} "
          f"{tuple(f['k'].shape)} and {q['k'].dtype}; int8 bitwise "
          f"quantize_kv of the float cache {bitwise}; codes at +-127 "
          f"{clipped:.2e}; k/v bytes {cache_bytes}; first tokens "
          f"{runs[False]['first_tokens']} and {runs[True]['first_tokens']};"
          f" tok/s {runs[False]['tok_per_s']:.2f} and "
          f"{runs[True]['tok_per_s']:.2f}")
    check(q["k"].dtype == q["v"].dtype == torch.int8
          and f["k"].dtype != torch.int8, "the int8 cache's dtypes")
    check(bitwise and torch.equal(q["pos"], f["pos"]),
          "the int8 prefill cache is not quantize_kv of the float one")
    # JAX's test_kv_quant_decode_close_to_fp rule: the first decode
    # step's next-token distribution within S5_PROB_ATOL of the float
    # cache's
    pq, pf = (torch.softmax(step_logits[qt][:, -1].float(), -1)
              for qt in (True, False))
    dist = float((pq - pf).abs().max())
    step_err = float((step_logits[True] - step_logits[False]).abs().max())
    same_next = torch.equal(pq.argmax(-1), pf.argmax(-1))
    print(f"[serve_qwen15] first decode step, int8 against float cache: "
          f"next-token distribution max|diff| {dist:.3e} (tol "
          f"{S5_PROB_ATOL:g}; largest probability {float(pf.max()):.3e}), "
          f"logits max|diff| {step_err:.3e}, greedy token equal "
          f"{same_next}; prefill logits equal "
          f"{torch.equal(prefill_logits[True], prefill_logits[False])}")
    check(bool(torch.isfinite(step_logits[True]).all()),
          "non-finite decode logits over the int8 cache")
    check(dist <= S5_PROB_ATOL, "the int8 cache's first decode step "
          "strays from the float cache's")
    del prefill_logits, step_logits, pq, pf
    check(_flash_check(results, f"qwen1.5 prefill causal {tuple(qq.shape)} "
                       f"over {tuple(kk.shape)} float32", qq, kk, vv, kw),
          "#8 disagrees with its plain version at qwen1.5's prefill")
    del f, q, caches, calls, qq, kk, vv
    _free()
    ok = _lm_checks(results, "s5 qwen1.5", b * p, [QWEN15_WI], (), (), 3200)
    ok &= _lm_checks(results, "s5 qwen1.5", b, [QWEN15_WO, QWEN15_UNEMBED],
                     (), (), 3210)
    check(ok, "a read disagrees with its plain version at qwen1.5's shapes")
    results["serve_qwen15"] = dict(
        policy=POLICY_2P, layers=n, **meta, **runs[False],
        int8=runs[True], cache_bytes=cache_bytes, clipped_share=clipped,
        flash_modes=modes, int8_step_prob_err=dist,
        int8_step_logit_err=step_err, int8_step_token_equal=same_next)
    # flash off: the smoke model's head dim 8 is below #8's smallest (16)
    _smoke_vs_cpu("reference_qwen15", "qwen1_5_110b", POLICY_2P, results,
                  kv_cache_quant=True)


def slice19_kernel_times(results):
    """s5's: #2 at qwen1_5_110b's wi (B 2000 and 2), wo (B 2000, 13
    segments) and unembed (B 2), #8 at its prefill (B 2, S 1000, 64/8
    heads of 128, causal, float32) against causal SDPA; t3's: #1 and #2 at
    seamless's encoder wi (512 rows) and transposed unembed (1016 rows, 63
    segments), #6 at a cross attention's k (512 rows), #4 at the unembed's
    counts (1016 slots, BL 1)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    rows_out = results.setdefault("times", [])
    g = torch.Generator(device=DEV).manual_seed(1919)
    two = ("managed_mvm",)
    b, p = QWEN15_BATCH, QWEN15_PROMPT
    for (name, r, c), batches in ((QWEN15_WI, (b * p, b)),
                                  (QWEN15_WO, (b * p,)),
                                  (QWEN15_UNEMBED, (b,))):
        for bb in batches:
            _read_rows(rows_out, g, f"qwen1.5 {name} {r}x{c}", r, c, bb,
                       False, two)
    _flash_row(rows_out, g, f"qwen1.5 prefill causal float32 Sq {p} H 64/8 "
               "D 128", b, p, p, 64, 8, 128, True)
    both = ("noisy_mvm", "managed_mvm")
    name, r, c = T3_ENC_WI
    _read_rows(rows_out, g, f"t3 {name} {r}x{c}", r, c, T3_ROWS_ENC, False,
               both)
    name, r, c = T3_UNEMBED
    _read_rows(rows_out, g, f"t3 {name}T {r}x{c}", r, c, LM_ROWS, True,
               both)
    name, r, c = T3_CROSS_K
    _fused_row(rows_out, g, f"t3 {name} {r}x{c}", r, c, T3_ROWS_ENC)
    name, r, c = T3_UNEMBED
    _count_row(rows_out, g, f"t3 {name} {r}x{c}", r, c, LM_ROWS, 1)


def t3_kernels_vs_plain(results):
    """The new training shapes against the plain versions: #1 and #2 at
    the encoder's wi and a cross attention's k (512 rows), forward and
    transposed, #6 at the cross k (512 rows, BL 1); #1 and #2 at the
    unembed (1016 rows; transposed, 63 segments) and #4 at its counts
    (1016 slots, BL 1)."""
    ok = _lm_checks(results, "t3 seamless", T3_ROWS_ENC,
                    [T3_ENC_WI, T3_CROSS_K], [T3_CROSS_K], (), 3300)
    ok &= _lm_checks(results, "t3 seamless", LM_ROWS, [T3_UNEMBED], (),
                     [T3_UNEMBED], 3310)
    check(ok, "a kernel disagrees with its plain version at the "
          "encoder-decoder's training shapes")


def t3_step_vs_cpu(results):
    """One FUSED_LM training step of the smoke seamless on the card
    against the CPU from the same weights, batch (seeded stub frames) and
    key: the loss within 1e-5; every parameter leaf, tiles and AdamW's
    digital leaves, as r2 holds a tile (at most 1e-3 of its entries beyond
    1e-6, none beyond 3e-3: a read an ulp off can flip a pulse draw)."""
    import numpy as np
    import torch
    from repro_torch.launch import train as tl
    from repro_torch.train import lm
    from repro_torch.utils import prng

    cfg = tl.lm_config("seamless_m4t_medium", smoke=True,
                       analog_policy=FUSED_LM)
    step, opt = lm.make_train_step(cfg)
    rng = np.random.default_rng(19)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32))),
             "enc_embeds": torch.as_tensor(rng.normal(
                 0, 0.5, (2, 16, cfg.d_model)), dtype=torch.float32)}
    p_cpu = lm.init_train_state(0, cfg, opt, device="cpu")[0]
    p_gpu = _to(p_cpu, DEV)
    losses, leaves = {}, {}
    for dev, p in (("cpu", p_cpu), (DEV, p_gpu)):
        _, _, m = step(p, opt.init(p), {k: v.to(dev) for k, v in
                                        batch.items()}, prng.key(8))
        losses[dev] = float(m["loss"])
        leaves[dev] = [t.detach().cpu() for t in _lm_tree_leaves(p)]
    lerr = abs(losses["cpu"] - losses[DEV])
    share, worst = 0.0, 0.0
    for a, b in zip(leaves["cpu"], leaves[DEV]):
        if a.is_floating_point():
            diff = (a - b).abs()
            share = max(share, float((diff > STEP_W_ATOL).float().mean()))
            worst = max(worst, float(diff.max()))
    ok = (lerr <= 1e-5 and share <= STEP_W_SHARE and worst <= STEP_W_MAX
          and len(leaves["cpu"]) == len(leaves[DEV]))
    print(f"[reference] seamless smoke FUSED_LM step, card vs CPU: loss "
          f"{losses[DEV]:.6f} vs {losses['cpu']:.6f} (|diff| {lerr:.1e}, "
          f"tol 1e-5); {len(leaves[DEV])} parameter leaves: largest share "
          f"of entries > 1e-6 {share:.1e}, max |diff| {worst:.1e}")
    results["t3_step_reference"] = dict(policy=FUSED_LM, loss_err=lerr,
                                        share=share, max=worst, ok=ok)
    check(ok, "the card's seamless training step disagrees with the CPU's")


def t3_cli(results):
    """The CLI entry ``launch.train.train("seamless_m4t_medium",
    smoke=True, analog=True)`` on the card at the LM convergence
    benchmark's policy, batch and seq (bare ``--analog``: NM, BM and UM at
    BL 1 on the block projections, pulse-SGD; batch 4, seq 128) for
    T3_CLI_STEPS graphed steps, not its 150: finite losses, the benchmark's rule that the last 10
    steps' mean loss falls below 0.85 of the first 10's, the analog
    kernels launched."""
    import math
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tl
    ops.reset_launch_counts()
    r = tl.train("seamless_m4t_medium", smoke=True, steps=T3_CLI_STEPS,
                 batch=4, seq=LM_S, analog=True, use_pallas=True,
                 log_every=20, device=DEV)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    losses = r["losses"]
    head, tail = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    print(f"[t3_cli] {T3_CLI_STEPS} steps: every 5th loss "
          f"{[round(v, 4) for v in losses[::5]]}, the first 10's mean "
          f"{head:.4f}, the last 10's {tail:.4f} (must fall below 0.85 of "
          f"it); {r['steps_per_sec']:.1f} steps/s (engine {r['engine']}), "
          f"launches {counts}")
    check(len(losses) == T3_CLI_STEPS
          and all(math.isfinite(v) for v in losses), "t3 CLI losses")
    check(tail < 0.85 * head, "the seamless CLI run's loss does not fall")
    check(counts.get("noisy_read") and counts.get("key_schedule"),
          f"the seamless CLI run launched {counts}")
    results["t3_cli"] = dict(losses=losses, launches=counts, head=head,
                             tail=tail, steps_per_s=r["steps_per_sec"])


def encdec_training(results):
    """(t3) seamless_m4t_medium (6 + 6 layers) through ``lm_train`` under
    FUSED_LM and ITERATIVE_LM: the kernels at its shapes, each run graphed
    bitwise the loop with its launches per replay against
    :func:`lm_per_step` (the encoder's, the adapter's and the cross
    attentions' reads inside the replay), a smoke step card vs CPU and the
    CLI's falling loss."""
    t3_kernels_vs_plain(results)
    for label, policy in T3_RUNS:
        t0 = time.perf_counter()
        lm_train(label, policy, results, arch="seamless_m4t_medium",
                 layers=T3_LAYERS)
        results[f"lm_train_{label}"]["phase_s"] = time.perf_counter() - t0
        print(f"[{label}] {time.perf_counter() - t0:.1f}s", flush=True)
    t3_step_vs_cpu(results)
    t3_cli(results)


def summary_line(results):
    """One entry per kernel at the shape named in KERNELS (decode wg/wi
    11008x4096, B=4, for the read kernels; LeNet's K1, W3 or K1 BL=1 for the
    training kernels; K2 #_d=13 for the fused update; qwen3's float32
    prefill for flash attention), with the launches of the run named
    there; ``ms`` is the larger of ``profiler_ms``, the profiler's device
    time of the kernels, and ``event_ms``, CUDA events around back-to-back
    calls of the wrapper."""
    kernels = []
    for kname, meta in KERNELS.items():
        t = next(r for r in results["times"] if r["kernel"] == kname
                 and r["shape"].startswith(meta["shape"])
                 and r["batch"] in (BATCH, LENET_BATCH, QWEN_BATCH, None))
        err = max(c["max_abs_err"] for c in results["checks"]
                  if c["kernel"] == kname)
        kernels.append(dict(
            name=kname, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"],
            launches=results[meta["run"]]["launches"][meta["kind"]],
            max_abs_err=err, ms=t["ms"], profiler_ms=t["profiler_ms"],
            event_ms=t["event_ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"]))
        if meta["kind"] in ("noisy_read", "pulse_counts"):
            # the same kernel's launches in g3's 20-step grid epochs
            kernels[-1]["launches_grid"] = {
                name: results[f"engine_{name}"]["launches"][meta["kind"]]
                for name in GRID_STEPS}
        if meta["kind"] in ("noisy_read", "managed_read", "pulse_counts",
                            "bwd_update", "key_schedule"):
            # and in l's one-epoch train_sequence runs (scan engine: warm-up
            # step, 25 replays and an evaluation), with a time at the
            # full-width LSTM's shape
            kernels[-1]["launches_seq"] = {
                name: results[f"seq_train_{name}"]["launches"][meta["kind"]]
                for name, _, _ in SEQ_RUNS
                if results[f"seq_train_{name}"]["launches"].get(meta["kind"])}
            t = next((r for r in results["times"] if r["kernel"] == kname
                      and r["shape"].startswith("LSTM")), None)
            if t is not None:
                kernels[-1]["seq_time"] = {k: t[k] for k in (
                    "shape", "batch", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}
        if meta["kind"] in ("noisy_read", "managed_read", "pulse_counts",
                            "bwd_update", "key_schedule"):
            # and in t's full-width LM runs (warm-up step and 3 replays),
            # with a time at an LM training shape
            kernels[-1]["launches_lm"] = {
                name: results[f"lm_train_{name}"]["launches"][meta["kind"]]
                for name, _ in LM_POLICIES
                if results[f"lm_train_{name}"]["launches"].get(meta["kind"])}
            t = next((r for r in results["times"] if r["kernel"] == kname
                      and r["shape"].startswith("LM")), None)
            if t is not None:
                kernels[-1]["lm_time"] = {k: t[k] for k in (
                    "shape", "batch", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}
        if meta["kind"] in ("noisy_read", "managed_read",
                            "flash_attention"):
            # and in the serving runs of s3, m, y and q (each a counted
            # greedy_generate, the temporal route's serve entry, q's first
            # run of the stream), with times at their shapes
            kernels[-1]["launches_families"] = {
                name: results[name]["launches"][meta["kind"]]
                for name in FAMILY_RUNS
                if results[name]["launches"].get(meta["kind"])}
            kernels[-1]["families_time"] = [
                {k: r[k] for k in ("shape", "batch", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in results["times"] if r["kernel"] == kname
                and r["shape"].startswith(("mamba2", "hymba"))]
            if meta["kind"] == "flash_attention":
                kernels[-1]["window"] = results["serve_hymba"][
                    "swa_window"]
        if meta["kind"] in ("noisy_read", "managed_read", "pulse_counts",
                            "bwd_update", "key_schedule"):
            # and in t2's mamba2 and hymba runs (warm-up step and 3
            # replays), with times at their shapes
            kernels[-1]["launches_t2"] = {
                label: results[f"lm_train_{label}"]["launches"][meta["kind"]]
                for label, *_ in T2_RUNS
                if results[f"lm_train_{label}"]["launches"].get(meta["kind"])}
            kernels[-1]["t2_time"] = [
                {k: r[k] for k in ("shape", "batch", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in results["times"] if r["kernel"] == kname
                and r["shape"].startswith("t2 ")]
        if meta["kind"] in ("managed_read", "flash_attention"):
            # and in s4's seamless run (a counted greedy_generate)
            kernels[-1]["launches_s4"] = results["serve_seamless"][
                "launches"][meta["kind"]]
            kernels[-1]["s4_time"] = [
                {k: r[k] for k in ("shape", "batch", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in results["times"] if r["kernel"] == kname
                and r["shape"].startswith("seamless")]
        if meta["kind"] in ("managed_read", "flash_attention"):
            # and in s5's qwen1_5_110b runs (a counted greedy_generate with
            # the float and the int8 cache)
            s5 = results["serve_qwen15"]
            kernels[-1]["launches_s5"] = {
                "float": s5["launches"][meta["kind"]],
                "int8": s5["int8"]["launches"][meta["kind"]]}
            kernels[-1]["s5_time"] = [
                {k: r[k] for k in ("shape", "batch", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in results["times"] if r["kernel"] == kname
                and r["shape"].startswith("qwen1.5")]
        if meta["kind"] in ("noisy_read", "managed_read", "pulse_counts",
                            "bwd_update", "key_schedule"):
            # and in t3's seamless runs (warm-up step and 3 replays), with
            # times at its shapes
            kernels[-1]["launches_t3"] = {
                label: results[f"lm_train_{label}"]["launches"][meta["kind"]]
                for label, _ in T3_RUNS
                if results[f"lm_train_{label}"]["launches"].get(meta["kind"])}
            kernels[-1]["t3_time"] = [
                {k: r[k] for k in ("shape", "batch", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in results["times"] if r["kernel"] == kname
                and r["shape"].startswith("t3 ")]
        if meta["kind"] in ("noisy_read", "managed_read", "pulse_counts"):
            # and in g4's chunked 20-step epochs (warm-up step included)
            kernels[-1]["launches_stream"] = {
                name: results[f"stream_{name}"]["launches"][meta["kind"]]
                for name in ("separate", "bl10_2p", "grid_2p", "iterative")
                if results[f"stream_{name}"]["launches"].get(meta["kind"])}
    return {"kernels": kernels}


def serve_two_phase(results):
    counts = serve_full(POLICY_2P, results, "serve_two_phase")
    want = READS_PER_PASS * GEN
    check(counts["managed_read"] == want and counts["noisy_read"] == 0,
          f"expected {want} managed reads and no noisy read, got {counts}")


def serve_iterative(results):
    counts = serve_full(POLICY_IT, results, "serve_iterative")
    want = READS_PER_PASS * GEN
    check(counts["noisy_read"] >= want and counts["managed_read"] == 0,
          f"expected >= {want} noisy reads and no managed read, "
          f"got {counts}")


def kernel_times_all(results):
    kernel_times(results)
    training_kernel_times(results)
    seq_kernel_times(results)
    slice3_kernel_times(results)


# (key, title, function): every phase, in the order they run
PHASES = [
    ("a", "build", lambda results: results.update(
        build_s=build_kernels())),
    ("b", "kernels vs plain versions", kernels_vs_plain),
    ("b8", "flash attention vs its plain version", flash_vs_plain),
    ("f5", "fused pulse update vs its plain version, and its entry",
     lambda results: (pulse_update_vs_plain(results),
                      pulse_update_entry(results))),
    ("c", "full-size serve, two-phase BM", serve_two_phase),
    ("d", "full-size serve, iterative BM", serve_iterative),
    ("s", "full-size qwen3_14b serve with the flash kernel", serve_qwen3),
    ("s3", "full-size stablelm_3b serve, two-phase BM", serve_stablelm),
    ("m", "full-size mamba2_130m serve: single-shot and temporal reads; "
     "the smoke model, card vs CPU", serve_mamba),
    ("y", "full-size hymba_1_5b serve with the windowed flash kernel; the "
     "smoke model, card vs CPU, flash off and on", serve_hymba),
    ("q", "continuous batching at full width on hymba_1_5b, and the "
     "slice's kernel times", serve_continuous),
    ("r", "small-input reference (card vs CPU)", smoke_reference),
    ("r3", "qwen3 smoke model, card vs CPU, flash off and on",
     smoke_reference_qwen3),
    ("f", "training kernels vs plain versions", training_kernels_vs_plain),
    ("g", "LeNet training on the card", lenet_training),
    ("g2", "the epoch engine: graphed steps vs the loop", lenet_engines),
    ("g3", "LeNet on a 2x2 grid of sub-tiles: graphed steps vs the loop",
     lenet_grid_engines),
    ("g4", "streaming chunks: chunked steps vs materialized, graphed",
     stream_engines),
    ("p1", "figure pair 1 in its JAX seed band", figure_pair),
    ("h", "learning", lenet_learning),
    ("k", "kill and resume: SIGKILLed runs resume bit-exact",
     kill_and_resume),
    ("r2", "one training step, card vs CPU", step_reference),
    ("e", "kernel times", kernel_times_all),
    ("t", "the analog LM trainer at full width: graphed steps vs the loop, "
     "the convergence runs in their JAX bands", lm_training),
    # s4 before t2: s4 times the slice's kernels, and t2 profiles replays
    # of up to 2.4 x 10^5 nodes (after t's profile the profiler already
    # keeps few device records: those times fall back to events)
    ("s4", "full-size seamless_m4t_medium serve: the encoder-decoder with "
     "#8 bidirectional and cross; the slice's kernel times",
     lambda results: (serve_seamless(results),
                      slice17_kernel_times(results))),
    # s5 times s5's and t3's kernels before t2's and t3's profiles
    ("s5", "qwen1_5_110b serve at full width (8 of 80 layers) with its QKV "
     "bias, the KV cache in float and in int8; the slice's kernel times",
     lambda results: (serve_qwen15(results),
                      slice19_kernel_times(results))),
    ("t2", "training the ssm and hybrid families: mamba2_130m and "
     "hymba_1_5b graphed vs the loop, single-shot and temporal routes",
     family_training),
    ("t3", "training the encoder-decoder seamless_m4t_medium at full "
     "width (6 + 6 layers): graphed vs the loop under FUSED_LM and "
     "ITERATIVE_LM; the smoke model card vs CPU and through the CLI",
     encdec_training),
    # last: after its profile of a 28k-node replay, the profiler kept no
    # device record of most of e's kernels (49 of 73 rows, where the
    # parent's runs lost 0-2)
    ("l", "the analog LSTM/GRU trainer: graphed steps vs the loop, the "
     "LSTM figure in its JAX bands", recurrent),
]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    results = {"device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    results["nvidia_smi"] = smi
    print(f"[env] {results['device']} torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}")

    phase_s = results.setdefault("phase_seconds", {})
    for key, title, fn in PHASES:
        phase(f"{key}: {title}")
        t0 = time.perf_counter()
        fn(results)
        phase_s[key] = time.perf_counter() - t0
        print(f"[phase {key}] {phase_s[key]:.1f}s", flush=True)
    results["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(f"\n[done] {results['seconds']:.1f}s")
    print(json.dumps(summary_line(results)))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
