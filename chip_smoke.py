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
      is timed in g2, at the FUSED step's tape.

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


def key_schedule_time(results, tape, prog):
    """The key-schedule kernel at the FUSED step's tape: its time, its plain
    evaluator's (host Python), its bound; its check row (the largest
    difference of g2's table comparisons)."""
    from repro_torch.kernels import key_schedule as ks
    n_ops, n_seeds = len(tape.recorded[0]), len(tape.recorded[2])
    counter = prog.ctr[1]
    # bytes: base, counter, the tape (parent, data, level, seed slots),
    # keys and seeds out; operations: 77 integer operations per threefry
    # block (20 rounds of add, rotate, xor; 5 key injections; 2 initial
    # adds) and 14 per seed (two splitmix32 finalizers), each charged as
    # one operation at the fp32 rate (no int32 peak is used here; the
    # card's int32 rate is lower, so this bound is a lower one)
    byts = 16 + 8 + 12 * n_ops + 4 * n_seeds + 16 * (n_ops + 1) + 8 * n_seeds
    int_ops = 77 * (n_ops + 1) + 14 * n_seeds
    _time_row(results.setdefault("times", []), "key_schedule",
              "LeNet FUSED step",
              lambda: ks.key_schedule(tape, prog.base, counter),
              lambda: ks.evaluate_plain(tape, (0, 2), 0), None, byts,
              int_ops, 0.0, batch=None)
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
