"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each of which makes the script exit non-zero when it fails:

  (a) build every CUDA kernel of the serving path from ``src/repro_torch/
      csrc`` (one ``nvcc`` per source, all started together);
  (b) hold each kernel against its plain PyTorch version on the card at the
      serving path's shapes (and transpose, #_d = 13 and row-offset
      variants): max |diff| against the stated tolerance, equal saturation
      flags;
  (c) serve the full-size deepseek_7b (30 layers, d 4096, vocab 102400,
      random weights from a seed) through ``repro_torch.launch.serve`` under
      two-phase bound management, launch counters read around the run;
  (d) the same under the paper's iterative bound management;
  (r) the smoke-size model on the card (kernels) against the CPU (plain
      versions): equal greedy tokens, logits within 1e-4;
  (e) each kernel's time against its bound, its plain version and one
      ``torch.matmul`` call on the same shapes (yardstick only).

The line before the card line is the kernels' JSON summary; the last line
is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
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
SMOKE = False                    # full published size

KERNELS = {
    "noisy_mvm": dict(route="cuda",
                      source="src/repro_torch/csrc/noisy_mvm.cu",
                      replaces="src/repro/kernels/noisy_mvm.py:127",
                      kind="noisy_read"),
    "managed_mvm": dict(route="cuda",
                        source="src/repro_torch/csrc/managed_mvm.cu",
                        replaces="src/repro/kernels/managed_mvm.py:187",
                        kind="managed_read"),
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
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
    print(f"[build] {len(paths)} kernels in {dt:.1f}s (parallel nvcc)")
    return dt


# ---------------------------------------------------------------------------
# (b) kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(b, rows, cols, transpose, seed):
    """Weights ~ N(0, 1/K) and input rows at scales 1, 8 and 300, so some
    rows never saturate, some saturate on the first read only and some on
    both two-phase reads — every flag far from the bound."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    k = rows if transpose else cols
    w = torch.randn(rows, cols, generator=g, device=DEV) * k ** -0.5
    x = torch.randn(b, k, generator=g, device=DEV)
    scales = torch.tensor([1.0, 8.0, 300.0], device=DEV)
    x = x * scales[torch.arange(b, device=DEV) % 3][:, None]
    return w.contiguous(), x.contiguous()


def _cases():
    # name, B, rows, cols, n_seg, transpose, d_avg, row_offset, total_rows
    return [
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


def kernels_vs_plain(results):
    import torch
    from repro_torch.kernels import managed_mvm as km
    from repro_torch.kernels import noisy_mvm as kn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[check] torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    ok = True
    for i, (name, b, r, c, n_seg, tr, d, off, tot) in enumerate(_cases()):
        w, x = _inputs(b, r, c, tr, seed=100 + i)
        kw = dict(sigma=SIGMA, alpha=ALPHA, n_seg=n_seg, transpose=tr,
                  row_offset=off, total_rows=tot)
        # largest accumulated sum_k |x_k w_k|: fp32 reassociation over K
        # terms moves a dot product by ~sqrt(K) * 2^-24 of it (< 7e-6 at
        # K = 11008), so 1e-5 of it bounds the kernel-vs-cuBLAS difference
        mag = float((x.abs() @ (w.abs() if tr else w.abs().T)).max())
        for kname in ("noisy_mvm", "managed_mvm"):
            if kname == "noisy_mvm" and d > 1:
                continue
            if kname == "noisy_mvm":
                y, s = kn.noisy_mvm(w, x, 0x1234ABCD, **kw)
                yp, sp = kn.noisy_mvm_plain(w, x, 0x1234ABCD, **kw)
            else:
                nm = torch.amax(x.abs(), dim=1, keepdim=True) \
                    if i % 2 else torch.ones(b, 1, device=DEV)
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
            print(f"[check] {kname:<11} {name:<38} max|diff|={err:.3e} "
                  f"tol={tol:.3e} sat agree {agree}/{b} "
                  f"(set: {int(sp.sum())}) {'ok' if good else 'FAIL'}")
            results.setdefault("checks", []).append(dict(
                kernel=kname, case=name, max_abs_err=err, tol=tol,
                sat_agree=agree, rows=b, sat_set=int(sp.sum()), ok=good))
    check(ok, "a kernel disagrees with its plain version")


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

    prof = _profile_decode(params, cfg, akey, prompts)
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


def _profile_decode(params, cfg, akey, prompts):
    """One decode step: its wall time (host clock around a synchronised
    step, no profiler), and the device time of each CUDA kernel in a second,
    profiled step (None when the profiler records no device time)."""
    import torch
    from repro_torch.serve import engine
    with torch.no_grad():
        _, cache = engine.prefill(params, prompts, cfg, max_seq=PROMPT + GEN,
                                  akey=akey)
        tok = prompts[:, -1:]
        step = lambda: engine.serve_step(params, tok, cache, cfg,
                                         akey=engine.decode_step_key(akey, 0))
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step()
            torch.cuda.synchronize()
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
    if not rows:
        print("[profile] torch.profiler recorded no device time")
        return dict(wall_ms=wall, device_busy_ms=None, top=[])
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"[profile] one decode step: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.2f}")
    for key, n, ms in rows[:8]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:70]}")
    return dict(wall_ms=wall, device_busy_ms=busy,
                top=[dict(kernel=k, count=n, ms=ms) for k, n, ms in rows[:12]])


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


def _device_ms(fn, names, iters=10):
    """Device time per call of the CUDA kernels whose names contain one of
    ``names`` (profiler ranges are not kernels), from torch.profiler (None
    without device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    tot = 0.0
    for ev in prof.key_averages():
        if "kernel" in ev.key and any(n in ev.key for n in names):
            tot += (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
    return tot / iters if tot > 0 else None


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
                              lambda: kn.noisy_mvm_plain(w, x, 1, **kw),
                              ("noisy_",)),
                "managed_mvm": (
                    lambda: km.managed_mvm(w, x, nm, (1, 2), **mkw),
                    lambda: km.managed_mvm_plain(w, x, nm, (1, 2), **mkw),
                    ("managed_",)),
            }
            flops = 2.0 * b * r * c
            lib_ms = _event_ms(lambda: torch.matmul(x, w.T))
            for kname, (fk, fp, names) in fns.items():
                out_b = 4 * b * r + 4 * b
                byts = 4 * (r * c + b * c) + out_b + (
                    4 * b if kname == "managed_mvm" else 0)
                bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
                dev_ms = _device_ms(fk, names)
                row = dict(kernel=kname, shape=name, batch=b,
                           ms=dev_ms if dev_ms is not None else _event_ms(fk),
                           ms_source="profiler" if dev_ms is not None
                           else "events",
                           event_ms=_event_ms(fk), plain_ms=_event_ms(fp),
                           library_ms=lib_ms, bound_ms=bound * 1e3,
                           bound_by="bytes" if byts / HBM_BYTES_PER_S
                           >= flops / FP32_FLOPS_PER_S else "operations")
                rows.append(row)
                print(f"[time] {kname:<11} {name:<22} B={b:<4} "
                      f"kernel {row['ms']:.4f} ms ({row['ms_source']}; "
                      f"events {row['event_ms']:.4f}) bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain "
                      f"{row['plain_ms']:.4f} ms matmul {lib_ms:.4f} ms")
            del w, x
    results["times"] = rows
    return rows


def summary_line(results):
    """One entry per kernel, at the decode shape most reads of the path
    take (wg/wi 11008x4096, B=4); launches from the two-phase (managed) and
    iterative (noisy) serving runs."""
    kernels = []
    for kname, meta in KERNELS.items():
        t = next(r for r in results["times"] if r["kernel"] == kname
                 and r["shape"].startswith("wg/wi") and r["batch"] == BATCH)
        err = max(c["max_abs_err"] for c in results["checks"]
                  if c["kernel"] == kname)
        run = "serve_two_phase" if kname == "managed_mvm" \
            else "serve_iterative"
        kernels.append(dict(
            name=kname, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"],
            launches=results[run]["launches"][meta["kind"]],
            max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"]))
    return {"kernels": kernels}


def main():
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
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

    phase("a: build")
    results["build_s"] = build_kernels()
    phase("b: kernels vs plain versions")
    kernels_vs_plain(results)
    phase("c: full-size serve, two-phase BM")
    counts = serve_full(POLICY_2P, results, "serve_two_phase")
    want = READS_PER_PASS * GEN
    check(counts["managed_read"] == want and counts["noisy_read"] == 0,
          f"expected {want} managed reads and no noisy read, got {counts}")
    phase("d: full-size serve, iterative BM")
    counts = serve_full(POLICY_IT, results, "serve_iterative")
    check(counts["noisy_read"] >= want and counts["managed_read"] == 0,
          f"expected >= {want} noisy reads and no managed read, "
          f"got {counts}")
    phase("r: small-input reference (card vs CPU)")
    smoke_reference(results)
    phase("e: kernel times")
    kernel_times(results)
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
