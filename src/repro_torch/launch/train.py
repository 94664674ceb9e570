"""Training driver: the analog LM trainer (the JAX package's
``launch/train.py``) and the analog recurrent cells (its ``train_sequence``).

  python -m repro_torch.launch.train --arch deepseek_7b --smoke \
      --steps 20 --batch 8 --seq 128 \
      --analog-policy "*attn*=managed,*mlp*=rpu_baseline"
  python -m repro_torch.launch.train --arch lstm --analog --steps 5

LM archs (the dense ``deepseek_7b``, ``qwen1_5_110b``, ``stablelm_3b`` and
``qwen3_14b``, the ssm ``mamba2_130m``, the hybrid ``hymba_1_5b`` and the
encoder-decoder ``seamless_m4t_medium``, whose encoder reads the JAX
trainer's zero stub frames each step): the deterministic
token pipeline (``data/tokens.py``), digital AdamW or per-layer analog
training (``--analog-policy`` rules, or bare ``--analog``: the uniform
NM+BM+UM(BL=1) config on the block projections, stepped by pure
``analog_sgd``; either way the resolved per-layer table prints at startup
and the params are float32), ``--engine scan`` (default: chunks of up to
``--scan-chunk`` steps, each step one CUDA graph replay, ``train/engine.py``
``scan_steps``) or ``--engine python`` (the per-step loop, the oracle: both
give the same bits), async checkpoints in the JAX store's stacked layout
every ``--ckpt-every`` steps (a rerun resumes: ``[train] restored step
N``), a straggler watchdog, SIGTERM-safe shutdown and restart-with-retry
(``--max-restarts``).  Step ``s`` trains on ``batch_at(s)`` under
``fold_in(key(seed + 1), s)``; params and tile seeds come from ``key(seed)``
(the weights from a ``torch.Generator``, ``models/transformer.py``).  One
card holds no mesh: ``--multi-pod`` changes nothing, as on the JAX driver
with fewer than 4 devices, and ``--tile-mesh R,C`` runs every grid
serially (``core/tile_grid.py``).  After a device loss the run restarts
from its newest checkpoint on the same card; the elastic re-shard is not
ported.

Recurrent cells (``lstm``, ``gru``): ``--steps`` counts *epochs* over a
fixed synthetic split (the copy task is tiny).  Every step runs the cell's
time loop: temporal weight reuse on the same tiles every timestep, one
accumulated pulse update per sequence batch (1806.00166's setting on this
package's RPU substrate), ``--engine`` as above.  Bare ``--analog`` puts
every site on ``rpu_nm_bm`` (NM and BM, no UM: update management needs
global error extrema, which a temporal accumulation never has), with
``--bm-mode``, ``--use-pallas`` and ``--fuse-bwd-update`` setting its
fields; ``--analog-policy`` takes the JAX package's spec language instead.
The key layout is the JAX package's: params from ``key(seed)``, ``k_data,
k_train, k_eval = split(key(seed + 1), 3)``, evaluation after epoch ``e``
under ``fold_in(k_eval, e)``.  The epoch shuffle is the port's
(``engine.epoch_permutation``).

Runs on ``cuda`` unless the caller passes ``device="cpu"`` (``--device
cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.data.tokens import SyntheticTokenSource, TokenPipelineConfig
from repro_torch.distributed import fault as fault_lib
from repro_torch.distributed.fault import (DeviceLossError, FaultInjector,
                                           PreemptionHandler,
                                           StragglerWatchdog)
from repro_torch.train import engine as eng
from repro_torch.utils import prng

SEQ_ARCHS = ("lstm", "gru")
#: The LM families ``lm_config`` trains.
TRAIN_FAMILIES = ("dense", "ssm", "hybrid", "audio")


def build(kind: str, *, batch: int, seq: int, smoke: bool, analog: bool,
          analog_policy: Optional[str], lr: float, bm_mode: str,
          use_pallas: bool, fuse_bwd_update: bool, time_chunk: int,
          seed: int, device):
    """The trainer's config, params (converted when analog), optimizer and
    the two splits as device tensors: ``(scfg, params, opt, train, eval)``
    with each split ``(tokens, targets)``."""
    from repro_torch.analog.convert import convert_to_analog
    from repro_torch.analog.policy import AnalogPolicy, AnalogRule
    from repro_torch.analog.presets import parse_policy
    from repro_torch.core.device import rpu_nm_bm
    from repro_torch.data import sequences
    from repro_torch.optim import optimizers
    from repro_torch.recurrent import model as seq_model

    seq_len = 4 if smoke else max(2, min(seq, 16))
    scfg = seq_model.SeqConfig(kind=kind, seq_len=seq_len, lr=lr,
                               hidden=16 if smoke else 32,
                               time_chunk=time_chunk)
    n_train = batch * (2 if smoke else 25)
    n_eval = max(batch, 64)
    splits = [sequences.copy_task(n, seq_len=scfg.seq_len, delay=scfg.delay,
                                  vocab=scfg.vocab, seed=s)
              for n, s in ((n_train, seed), (n_eval, seed + 1))]
    params = seq_model.init(prng.key(seed), scfg, device=device)
    pol = None
    if analog_policy:
        pol = parse_policy(analog_policy)
    elif analog:
        rpu = dataclasses.replace(rpu_nm_bm(), bm_mode=bm_mode,
                                  use_pallas=use_pallas,
                                  fuse_bwd_update=fuse_bwd_update)
        pol = AnalogPolicy(rules=(AnalogRule("*", rpu, "nm_bm"),))
    if pol is not None:
        params = convert_to_analog(params, pol, key=prng.key(seed))
    # with no analog leaf, mixed_analog is sgd(lr) itself
    opt = optimizers.mixed_analog(functools.partial(optimizers.sgd, lr=lr))
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    train, ev = ((as_t(tok), as_t(tgt)) for tok, tgt in splits)
    return scfg, params, opt, train, ev


def python_eval(scfg, params, tokens: torch.Tensor, targets: torch.Tensor,
                key: prng.Key, batch: int) -> float:
    """``engine="python"``'s evaluation: :func:`engine.make_seq_eval_fn`'s
    batches and keys (``fold_in(key, start)``), one Python call each."""
    from repro_torch.recurrent import model as seq_model
    counts = torch.zeros(2, device=tokens.device)
    with torch.no_grad():
        for start in range(0, tokens.shape[0], batch):
            t, g = tokens[start:start + batch], targets[start:start + batch]
            pad = batch - t.shape[0]
            if pad:
                t = torch.cat([t, t.new_zeros((pad, t.shape[1]))])
                g = torch.cat([g, g.new_full((pad, g.shape[1]), -1)])
            logits = seq_model.apply(params, t, prng.fold_in(key, start),
                                     scfg)
            counts.add_(torch.stack(seq_model.hits(logits, g)))
    return float(counts[0] / torch.clamp_min(counts[1], 1.0))


def train_sequence(kind: str, *, steps: int, batch: int, seq: int,
                   smoke: bool, analog: bool = False,
                   analog_policy: Optional[str] = None, lr: float = 0.01,
                   bm_mode: str = "iterative", use_pallas: bool = False,
                   fuse_bwd_update: bool = False, time_chunk: int = 1,
                   seed: int = 0, log_every: int = 1, device="cuda",
                   engine: str = "scan", return_params: bool = False,
                   verbose: bool = True) -> Dict:
    """Analog recurrent trainer: LSTM/GRU on the delayed-copy task.

    Returns the JAX package's ``{"losses", "final_loss", "accuracies"}``
    (``losses`` are ``1 - accuracy`` per epoch) plus ``"wallclock_s"``,
    ``"steps_per_sec"``, ``"engine"``, ``"device"`` (and ``"params"`` on
    request)."""
    from repro_torch.train import cnn
    if kind not in SEQ_ARCHS:
        raise ValueError(f"unknown sequence arch {kind!r}")
    if engine not in ("scan", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    scfg, params, opt, (tok, tgt), (ev_tok, ev_tgt) = build(
        kind, batch=batch, seq=seq, smoke=smoke, analog=analog,
        analog_policy=analog_policy, lr=lr, bm_mode=bm_mode,
        use_pallas=use_pallas, fuse_bwd_update=fuse_bwd_update,
        time_chunk=time_chunk, seed=seed, device=device)
    eval_batch = max(batch, 64)
    if engine == "scan":
        run_epoch = eng.make_seq_epoch_fn(scfg, opt, batch=batch)
        evaluate = eng.make_seq_eval_fn(scfg, batch=eval_batch)
    else:
        run_epoch = functools.partial(
            cnn.python_epoch, eng.make_seq_step_fn(scfg, opt), batch=batch)
        evaluate = functools.partial(python_eval, scfg, batch=eval_batch)
    k_data, k_train, k_eval = prng.split(prng.key(seed + 1), 3)

    accs = []
    t0 = time.perf_counter()
    for epoch in range(steps):
        run_epoch(params, tok, tgt, k_data, k_train, epoch)
        acc = evaluate(params, ev_tok, ev_tgt, prng.fold_in(k_eval, epoch))
        accs.append(acc)
        if verbose and (epoch % log_every == 0 or epoch == steps - 1):
            print(f"[train {kind}] epoch {epoch} copy-task accuracy "
                  f"{acc:.3f}", flush=True)
    wallclock = time.perf_counter() - t0
    result = {"losses": [1.0 - a for a in accs],
              "final_loss": 1.0 - accs[-1] if accs else None,
              "accuracies": accs, "wallclock_s": wallclock,
              "steps_per_sec": (steps * (tok.shape[0] // batch) / wallclock
                                if wallclock > 0 else None),
              "engine": engine, "device": str(torch.device(device))}
    if return_params:
        result["params"] = params
    return result


def _build_batch(cfg, toks, seq):
    """The train-step batch dict of ``toks``: (B, S) for a step, (chunk, B,
    S) for the engine's chunk.  An encoder-decoder's stub frames
    ``enc_embeds`` are the JAX trainer's zeros (``*lead, max(seq // 2, 8),
    d_model``) in the act dtype, after the same leading axes."""
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.zeros(
            (*toks.shape[:-1], max(seq // 2, 8), cfg.d_model),
            dtype=cfg.act_dtype, device=toks.device)
    return batch


def _parse_tile_mesh(tile_mesh: Optional[str]):
    if not tile_mesh:
        return None
    try:
        gr, gc = (int(v) for v in tile_mesh.split(","))
    except ValueError:
        raise ValueError(
            f"--tile-mesh expects 'R,C' (two comma-separated "
            f"integers), got {tile_mesh!r}") from None
    print(f"[train] tile grid {gr}x{gc}: serial oracle (one card; the "
          "port places no grid on a crossbar mesh)")
    return gr, gc


def _build_analog_policy(analog_policy: str, bm_mode: str,
                         use_pallas: bool, tile_mesh: Optional[str],
                         update_chunk: Optional[int],
                         fuse_bwd_update: bool = False):
    """The per-layer policy of ``--analog-policy``: a preset name (with
    ``:field=value`` modifiers), inline ``pattern=preset`` rules or a JSON
    rules file.  The global knobs (--bm-mode, --use-pallas,
    --fuse-bwd-update, --tile-mesh, --update-chunk) apply to every rule,
    but only those that were set: a default --bm-mode never overrides a
    rule's ``:bm_mode=...``."""
    from repro_torch.analog import presets

    pol = presets.parse_policy(analog_policy)
    grid = _parse_tile_mesh(tile_mesh)
    if update_chunk:
        print(f"[train] streaming update cycle: chunk={update_chunk} "
              "(bit-identical, constant pulse-stream memory)")

    def override(c):
        if bm_mode != "iterative":
            c = dataclasses.replace(c, bm_mode=bm_mode)
        if use_pallas:
            c = dataclasses.replace(c, use_pallas=True)
        if fuse_bwd_update:
            c = dataclasses.replace(c, fuse_bwd_update=True)
        if update_chunk:
            c = c.with_streaming(update_chunk=update_chunk)
        if grid:
            c = c.with_tile_grid(*grid)
        return c

    if (bm_mode != "iterative" or use_pallas or fuse_bwd_update
            or update_chunk or grid):
        pol = pol.map_configs(override)
    return pol


def _print_policy_table(params) -> None:
    from repro_torch.launch.serve import print_policy_table
    print_policy_table(params, who="train")


def _policy_tile_grids(cfg) -> List:
    """Distinct tile grids any analog rule of ``cfg`` could route through."""
    grids = set()
    pol = getattr(cfg, "analog_policy", None)
    if pol is not None:
        for rule in pol.rules:
            if rule.cfg is not None and rule.cfg.tile_grid is not None:
                grids.add(tuple(rule.cfg.tile_grid))
    c = getattr(cfg, "analog", None)
    if c is not None and c.tile_grid is not None:
        grids.add(tuple(c.tile_grid))
    return sorted(grids)


def lm_config(arch: str, *, smoke: bool, analog: bool = False,
              analog_policy: Optional[str] = None, bm_mode: str = "iterative",
              use_pallas: bool = False, fuse_bwd_update: bool = False,
              tile_mesh: Optional[str] = None,
              update_chunk: Optional[int] = None):
    """The LM config of the driver's flags, with the JAX driver's refusals;
    analog configs train float32 params."""
    trained = [a for a in registry.ARCH_IDS
               if registry.get_config(a).family in TRAIN_FAMILIES]
    try:
        cfg = registry.get_config(arch, smoke=smoke)
    except KeyError:
        cfg = None
    if cfg is None or cfg.family not in TRAIN_FAMILIES:
        raise NotImplementedError(
            f"--arch {arch!r}: the port trains the LMs {trained} and the "
            f"recurrent cells {SEQ_ARCHS}; the MoE and VLM families wait "
            "(ROADMAP Queue 1, item 6)")
    if fuse_bwd_update and not use_pallas and not analog_policy:
        raise ValueError("--fuse-bwd-update requires --use-pallas (the "
                         "fused backward+update cycle is a kernel launch)")
    if analog_policy:
        pol = _build_analog_policy(analog_policy, bm_mode, use_pallas,
                                   tile_mesh, update_chunk,
                                   fuse_bwd_update=fuse_bwd_update)
        return dataclasses.replace(cfg, analog_policy=pol,
                                   param_dtype=torch.float32)
    if analog:
        # bare --analog: the uniform managed config on the block
        # projections (the legacy ModelConfig.analog scope: never the
        # unembed), trained with pure analog_sgd
        from repro_torch.core.device import rpu_nm_bm_um_bl1
        rpu = dataclasses.replace(rpu_nm_bm_um_bl1(), bm_mode=bm_mode,
                                  use_pallas=use_pallas,
                                  fuse_bwd_update=fuse_bwd_update)
        if update_chunk:
            rpu = rpu.with_streaming(update_chunk=update_chunk)
            print(f"[train] streaming update cycle: chunk={update_chunk} "
                  "(bit-identical, constant pulse-stream memory)")
        grid = _parse_tile_mesh(tile_mesh)
        if grid:
            rpu = rpu.with_tile_grid(*grid)
        return dataclasses.replace(cfg, analog=rpu,
                                   param_dtype=torch.float32)
    if tile_mesh:
        raise ValueError("--tile-mesh requires --analog (it shards the "
                         "analog crossbar tiles, not fp weights)")
    if update_chunk:
        raise ValueError("--update-chunk requires --analog (it chunks the "
                         "pulse-stream update cycle)")
    return cfg


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          analog: bool = False, analog_policy: Optional[str] = None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          multi_pod: bool = False, lr: float = 3e-4, log_every: int = 1,
          seed: int = 0, engine: str = "scan", scan_chunk: int = 10,
          bm_mode: str = "iterative", use_pallas: bool = False,
          fuse_bwd_update: bool = False, tile_mesh: Optional[str] = None,
          update_chunk: Optional[int] = None, time_chunk: int = 1,
          max_restarts: int = 0, device="cuda", verbose: bool = True,
          return_params: bool = False, jax_weights: bool = False) -> Dict:
    """Train ``arch`` for ``steps`` steps (epochs for ``lstm``/``gru``).

    Returns the JAX package's ``{"losses", "final_loss"}`` plus
    ``"wallclock_s"``, ``"steps_per_sec"``, ``"engine"``, ``"device"`` (and
    ``"params"``, with ``"opt_state"`` for an LM, on request).
    ``multi_pod`` is accepted and changes nothing on one card;
    ``jax_weights`` starts an LM from the JAX package's initial weights
    (drawn on the host: for small configs)."""
    if arch in SEQ_ARCHS:
        return train_sequence(
            arch, steps=steps, batch=batch, seq=seq, smoke=smoke,
            analog=analog, analog_policy=analog_policy, lr=lr,
            bm_mode=bm_mode, use_pallas=use_pallas,
            fuse_bwd_update=fuse_bwd_update, time_chunk=time_chunk,
            seed=seed, log_every=log_every, device=device, engine=engine,
            return_params=return_params, verbose=verbose)
    if engine not in ("scan", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    from repro_torch.analog.convert import stack_layers, unstack_layers
    from repro_torch.train import lm

    cfg = lm_config(arch, smoke=smoke, analog=analog,
                    analog_policy=analog_policy, bm_mode=bm_mode,
                    use_pallas=use_pallas, fuse_bwd_update=fuse_bwd_update,
                    tile_mesh=tile_mesh, update_chunk=update_chunk)
    analog = cfg.uses_analog
    say = print if verbose else (lambda *a, **k: None)
    pipeline = SyntheticTokenSource(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))
    opt = lm.default_optimizer(cfg, lr)
    watchdog = StragglerWatchdog()
    preempt = PreemptionHandler().install()
    injector = FaultInjector.from_env()
    key_base = prng.key(seed + 1)
    dev = torch.device(device)

    # Per-step losses survive restarts: a step re-run after rolling back to
    # the newest checkpoint overwrites its own slot.
    losses_by_step: Dict[int, float] = {}
    printed_policy: List[bool] = []
    final: Dict = {}

    def make_state():
        """(Re)build the step function and the state, restoring the newest
        complete checkpoint: called per attempt."""
        if engine == "scan":
            fn, _ = lm.make_scan_train_step(cfg, opt)
        else:
            fn, _ = lm.make_train_step(cfg, opt)
        params, opt_state = lm.init_train_state(seed, cfg, opt, device=dev,
                                                jax_weights=jax_weights)
        start = 0
        if ckpt_dir:
            latest = store.latest_step(ckpt_dir)
            if latest is not None:
                like = stack_layers((params, opt_state))
                del params, opt_state
                restored, _ = store.restore(ckpt_dir, latest, like)
                params, opt_state = unstack_layers(
                    restored, cfg.n_layers, cfg.encoder_layers)
                start = latest
                say(f"[train] restored step {latest}")
        if analog and verbose and not printed_policy:
            _print_policy_table(params)
            printed_policy.append(True)
        return {"step_fn": fn, "params": params, "opt_state": opt_state,
                "start": start,
                "ckpt": store.AsyncCheckpointer(ckpt_dir)
                if ckpt_dir else None}

    def run(state):
        step_fn, ckpt = state["step_fn"], state["ckpt"]
        params, opt_state = state["params"], state["opt_state"]
        final.update(params=params, opt_state=opt_state)
        step = state["start"]
        while step < steps:
            t0 = time.perf_counter()
            if engine == "scan":
                # a chunk of graphed steps, clipped so that checkpoints land
                # on the ckpt_every cadence and an injected fault fires at
                # its exact step boundary
                chunk = min(scan_chunk, steps - step)
                if ckpt and ckpt_every > 0:
                    chunk = min(chunk, ckpt_every - (step % ckpt_every))
                if injector and step < injector.fault_step:
                    chunk = min(chunk, injector.fault_step - step)
                toks = torch.from_numpy(np.stack(
                    [pipeline.batch_at(i) for i in range(step, step + chunk)]))
                params, opt_state, metrics = step_fn(
                    params, opt_state, _build_batch(cfg, toks, seq),
                    key_base, step)
                chunk_losses = metrics["loss"].tolist()
            else:
                chunk = 1
                toks = torch.from_numpy(pipeline.batch_at(step)).to(dev)
                params, opt_state, metrics = step_fn(
                    params, opt_state, _build_batch(cfg, toks, seq),
                    prng.fold_in(key_base, step))
                chunk_losses = [float(metrics["loss"])]
            for i, v in enumerate(chunk_losses):
                losses_by_step[step + i] = v
            loss = chunk_losses[-1]
            step += chunk
            rep = watchdog.observe(step - 1,
                                   (time.perf_counter() - t0) / chunk)
            if (step - chunk) % log_every == 0 or chunk > 1:
                flag = " STRAGGLER" if rep.is_straggler else ""
                say(f"[train {arch}] step {step - 1} loss {loss:.4f} "
                    f"({rep.step_time * 1e3:.0f} ms/step){flag}", flush=True)
            if ckpt and (step % ckpt_every == 0
                         or preempt.preemption_requested()
                         or step == steps):
                ckpt.save(step, stack_layers((params, opt_state)),
                          {"arch": arch, "loss": loss})
                if injector:
                    injector.check(step, saving=True)
            if injector:
                injector.check(step, flush=ckpt)
            if preempt.preemption_requested():
                say("[train] preemption requested -> checkpointed, exiting")
                break
        if ckpt:
            ckpt.wait()

    def on_restart(attempt, exc):
        if isinstance(exc, DeviceLossError):
            say(f"[train] lost {exc.n_lost} device(s) -> restart {attempt}/"
                f"{max_restarts} from the newest checkpoint on this card "
                "(no re-shard: the port has no elastic device pool)",
                flush=True)
            for grid in _policy_tile_grids(cfg):
                say(f"[train] tile grid {grid[0]}x{grid[1]} -> serial "
                    "oracle", flush=True)
        else:
            say(f"[train] restart {attempt}/{max_restarts} after "
                f"{type(exc).__name__}: {exc}", flush=True)
        # the restarted run captures its step again: its first steps must
        # not be judged against the earlier EWMA
        watchdog.reset()

    t0 = time.perf_counter()
    fault_lib.run_with_restarts(make_state, run, max_restarts=max_restarts,
                                on_restart=on_restart)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wallclock = time.perf_counter() - t0
    losses = [losses_by_step[i] for i in sorted(losses_by_step)]
    result = {"losses": losses, "final_loss": losses[-1] if losses else None,
              "wallclock_s": wallclock,
              "steps_per_sec": (len(losses) / wallclock if wallclock > 0
                                else None),
              "engine": engine, "device": str(dev)}
    if return_params:
        result.update(params=final["params"], opt_state=final["opt_state"])
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="an LM of the registry (deepseek_7b, "
                         "qwen1_5_110b, stablelm_3b, qwen3_14b, "
                         "mamba2_130m, hymba_1_5b, seamless_m4t_medium) "
                         "or a recurrent cell "
                         f"({', '.join(SEQ_ARCHS)})")
    ap.add_argument("--steps", type=int, default=100,
                    help="train steps (epochs over the copy-task split for "
                         "lstm/gru)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="LM sequence length; for lstm/gru the payload "
                         "length, capped at 16 (T = 2 seq + 2)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--analog", action="store_true",
                    help="train projections on analog RPU tiles; without "
                         "--analog-policy an LM takes the managed config "
                         "(NM + BM + UM, BL 1) on its block projections and "
                         "pure analog pulse-SGD, a recurrent cell rpu_nm_bm "
                         "(NM + BM, no UM) on every site")
    ap.add_argument("--analog-policy", type=str, default=None,
                    metavar="SPEC",
                    help="per-layer analog policy (implies --analog): a "
                         "preset name ('managed', 'rpu_baseline', ...), "
                         "inline first-match-wins rules like "
                         "'*attn*=managed,*mlp*=rpu_baseline' (unmatched "
                         "layers stay digital; presets take "
                         "':field=value' modifiers, e.g. "
                         "'lm_managed:use_pallas=true:bm_mode=two_phase'), "
                         "or a JSON rules file")
    ap.add_argument("--multi-pod", action="store_true",
                    help="accepted; one card holds no mesh")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="restart-with-retry budget: after a failure (e.g. "
                         "a simulated device loss) rebuild the step, "
                         "restore the newest complete checkpoint and "
                         "continue, up to this many times")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--engine", choices=("scan", "python"), default="scan",
                    help="scan: one CUDA graph replay per step; python: "
                         "the per-step loop (the oracle)")
    ap.add_argument("--scan-chunk", type=int, default=10,
                    help="LM steps per chunk (one loss read-back) with "
                         "--engine scan")
    ap.add_argument("--bm-mode", choices=("iterative", "two_phase"),
                    default="iterative",
                    help="with --analog: the paper's halve-and-retry loop "
                         "or the fixed-latency two-phase retry (one managed "
                         "read launch with --use-pallas)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="with --analog: reads and updates on the CUDA "
                         "kernels")
    ap.add_argument("--fuse-bwd-update", action="store_true",
                    help="with --analog: each eligible layer's transpose "
                         "read and pulse update in one kernel launch "
                         "(needs --use-pallas and a fixed-latency BM mode)")
    ap.add_argument("--tile-mesh", type=str, default=None, metavar="R,C",
                    help="with --analog: every analog tile as an RxC grid "
                         "of sub-tiles, run serially on the card")
    ap.add_argument("--update-chunk", type=int, default=None,
                    help="with --analog: stream the update cycle's pulse "
                         "streams in chunks of this many vector pairs "
                         "(bit-identical to the materialized cycle)")
    ap.add_argument("--time-chunk", type=int, default=1,
                    help="with --arch lstm|gru: timesteps per chunk of the "
                         "JAX package's scan; must divide T, changes no bit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                smoke=args.smoke, analog=args.analog,
                analog_policy=args.analog_policy, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, multi_pod=args.multi_pod,
                lr=args.lr, log_every=args.log_every, seed=args.seed,
                engine=args.engine, scan_chunk=args.scan_chunk,
                bm_mode=args.bm_mode, use_pallas=args.use_pallas,
                fuse_bwd_update=args.fuse_bwd_update,
                tile_mesh=args.tile_mesh, update_chunk=args.update_chunk,
                time_chunk=args.time_chunk,
                max_restarts=args.max_restarts, device=args.device)
    print(f"[train] done; final loss {res['final_loss']:.4f} "
          f"({res['steps_per_sec']:.1f} steps/s on {res['device']}, "
          f"engine {res['engine']})")


if __name__ == "__main__":
    main()
