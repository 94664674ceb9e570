"""The epoch engine of the LeNet trainer: one CUDA graph replay per step.

Port of the CNN part of the JAX package's ``train/engine.py``
(``fold_in_keys`` :53, ``make_cnn_step_fn`` :159, ``make_cnn_epoch_fn``
:183, ``make_cnn_eval_fn`` :221).  There the whole epoch is one jitted XLA
program: the shuffle gather runs on the device, and the step keys
``fold_in(k_train, epoch * spe + s)`` are derived inside the scan.
PyTorch's counterpart of a jitted scan is a CUDA graph, captured once and
replayed once per step:

* static buffers hold the split, the epoch's permutation and a device step
  counter (step of the epoch, global step);
* the captured step is the key-schedule launch (every key and seed of the
  step from the global counter, ``kernels/key_schedule.py``), the
  minibatch gather ``perm.view(spe, batch)[step]`` by ``index_select``,
  the loss, ``torch.autograd.grad``, the optimizer's in-place update and
  the counter's ``add_``;
* the step's key tree is recorded on a :class:`~repro_torch.utils.prng.
  KeyTape` by one warm-up step on copies of the tiles, on the capture's
  side stream and with host synchronisations made errors; the capture
  records it again and checks that it is the same.  The seeds reach the
  kernels as views of the tape's seed table, never as launch-time ints.

On the CPU the same program runs uncaptured: the key schedule's plain
version fills the seed table before each step, and the kernels' plain
versions read it.  Either way the epoch is bit-identical to
``cnn.train(engine="python")``: the same batches and the same keys.

Under the paper's iterative bound management the step's reads take the
predicated form of the retry loop (``with_bound_management_predicated`` in
``core/management.py``: every retry unrolled, each on a device predicate,
its keys on the tape), so that step too is one graph replay.

The streaming chunks (``update_chunk``, ``conv_stream_chunk``) are host
loops with host-int row offsets inside the layers' cycles, so the capture
records one launch per chunk (and, under iterative BM, each chunk's
predicated retries), and the graph's private memory pool reuses one
chunk's buffers for the next.  A chunked epoch gives the bits of the
materialized one under BM off and two-phase BM.

The sequence engines (``make_seq_step_fn`` :264, ``make_seq_epoch_fn``
:284, ``make_seq_eval_fn`` :321) run the copy-task LSTM/GRU of
``repro_torch.recurrent`` on the same graphed step: the cell's time loop
is a host loop, so the captured step records every timestep's reads, the
backward sweep's transpose reads and count launches (``row_offset = t *
B``) and each tile's one finalize; under iterative BM every managed read
of every timestep takes the predicated retries.
The LM trainer's :func:`scan_steps` (``scan_steps`` :362) runs a chunk of
``train/lm.py`` steps on the same graphed step: the captured step is the
key schedule (root ``fold_in(base, step)``), the loss, its gradients (each
block recomputed under remat), the optimizer's in-place update of params
and state (AdamW's count included) and the counter's ``add_``; each
replay's batch (the tokens, and an encoder-decoder's stub frames
``enc_embeds``, whose encoder reads, adapter read and cross attention reads
the step records with their keys) comes from static device buffers its
caller fills, and the chunk's losses are read back once.
The data-parallel split is not ported.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analog.modules import AnalogState
from repro_torch.kernels import gemm, ops
from repro_torch.kernels.key_schedule import key_schedule
from repro_torch.models import lenet
from repro_torch.optim import optimizers
from repro_torch.utils import prng

_M32 = 0xFFFFFFFF
Params = Dict[str, AnalogState]


def fold_in_keys(key: prng.Key, indices: Sequence[int]) -> np.ndarray:
    """Batched ``fold_in``: the key data ``(n, 2)`` uint32 of
    ``fold_in(key, i)`` for each index, the step keys of the JAX package's
    engines.  The key-schedule kernel derives a step's root key the same
    way, from the device counter."""
    idx = np.asarray(indices, dtype=np.int64).reshape(-1)
    return np.array([prng.fold_in(key, int(i) & _M32) for i in idx],
                    dtype=np.uint32).reshape(-1, 2)


def trainable(params: Params) -> List[torch.Tensor]:
    """The tiles' physical weights, made leaves that take a gradient."""
    return [params[name].w.requires_grad_() for name in lenet.LAYERS]


def epoch_permutation(k_data: prng.Key, epoch: int, n: int) -> torch.Tensor:
    """The epoch's shuffle: ``torch.randperm`` under a generator seeded from
    the key data of ``fold_in(k_data, epoch)``."""
    k0, k1 = prng.fold_in(k_data, epoch)
    g = torch.Generator().manual_seed((k0 << 32) | k1)
    return torch.randperm(n, generator=g)


def make_cnn_step_fn(cfg: lenet.LeNetConfig,
                     opt: Optional[Callable] = None) -> Callable:
    """``step(params, x, y, key)``: one SGD step in place, ``opt(ws,
    grads)`` (default ``analog_sgd`` in analog mode, ``sgd(lr)`` in
    digital mode); returns the summed loss (a device scalar).  ``key`` is
    a host key or a device key (``prng.DeviceKey``)."""
    if opt is None:
        opt = (optimizers.analog_sgd if cfg.mode == "analog"
               else functools.partial(optimizers.sgd, lr=cfg.lr))

    def step(params, x, y, key):
        ws = trainable(params)
        loss = lenet.loss_fn(params, x, y, key, cfg)
        opt(ws, torch.autograd.grad(loss, ws))
        return loss.detach()

    return step


class _Graphed:
    """A step function over static buffers, with its key tree on a tape
    whose root is ``fold_in(base, ctr[1])``: captured into one CUDA graph
    on a card, run as it is on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.tape = prng.KeyTape(self.device)
        self.base = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.ctr = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.graph = self.stream = self.out = None
        self.captured: Dict[str, int] = {}  # launches per replay, by kind
        # host seconds of the warm-up step and of the capture (with its
        # instantiation)
        self.seconds: Dict[str, float] = {}

    def body(self, state, root: prng.DeviceKey) -> torch.Tensor:
        """One step on ``state`` under the tape's root key; returns its
        output tensor."""
        raise NotImplementedError

    def _recorded(self, state):
        root = self.tape.begin()
        out = self.body(state, root)
        self.tape.end()
        return out

    def build(self, warm_state, state) -> None:
        """Record the tape by one step on ``warm_state``; on a card, capture
        the key schedule and one step on ``state`` into the graph."""
        if self.device.type != "cuda":
            self._recorded(warm_state)
            self.state = state
            return
        t0 = time.perf_counter()
        s = self.stream = torch.cuda.Stream(self.device)
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._recorded(warm_state)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self.tape.program()           # the tape's upload, before capture
        torch.cuda.current_stream(self.device).wait_stream(s)
        t1 = time.perf_counter()
        # keep_graph: the captured nodes stay readable (graph.debug_dump
        # writes what a replay launches); it keeps the node list on the
        # host, and a replay runs the instantiated graph either way
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = ops.launch_counts()
        # An earlier program that is garbage in a reference cycle frees its
        # graph when the cycle collector runs; a graph destroyed during this
        # capture would invalidate it (CUDA error 901), so the collector is
        # off while capturing.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=s):
                key_schedule(self.tape, self.base, self.ctr[1])
                self.out = self._recorded(state)
        finally:
            if collecting:
                gc.enable()
        self.graph.instantiate()
        self.seconds = dict(warm_up=t1 - t0,
                            capture=time.perf_counter() - t1)
        # the wrappers counted at the capture, which launches nothing; each
        # replay launches what they counted
        self.captured = {k: n - before[k]
                         for k, n in ops.launch_counts().items()
                         if n != before[k]}
        ops.add_launch_counts({k: -n for k, n in self.captured.items()})
        # the scratch the captured reads point at (kernels/gemm.py), held
        # so that it outlives a regrowth for another user of the stream
        self.scratch = gemm.scratch(self.device, s.cuda_stream, 0, 0)

    def run(self) -> torch.Tensor:
        """One step: a graph replay on a card, else the plain key schedule
        and the step."""
        if self.graph is not None:
            self.graph.replay()
            ops.add_launch_counts(self.captured)
            return self.out
        key_schedule(self.tape, self.base, self.ctr[1])
        return self._recorded(self.state)


class _EpochStep(_Graphed):
    def __init__(self, step, xs, ys, batch):
        super().__init__(xs.device)
        self.step, self.batch = step, batch
        self.spe = xs.shape[0] // batch
        self.xs, self.ys = torch.empty_like(xs), torch.empty_like(ys)
        self.perm = torch.zeros(self.spe * batch, dtype=torch.int64,
                                device=self.device)

    def body(self, params, root):
        rows = self.perm.view(self.spe, self.batch).index_select(
            0, self.ctr[:1]).view(-1)
        loss = self.step(params, self.xs.index_select(0, rows),
                         self.ys.index_select(0, rows), root)
        self.ctr.add_(1)
        return loss


def _nodes(tree):
    """The tiles and plain tensors of a parameter tree, in key order."""
    if isinstance(tree, (AnalogState, torch.Tensor)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _nodes(v)


def _signature(params, xs: torch.Tensor, ys: torch.Tensor):
    """What a captured step bakes in: the tiles' and tensors' storage and
    the split's shape, type and device."""
    return (tuple((n.w.data_ptr(), id(n.maps)) if isinstance(n, AnalogState)
                  else n.data_ptr() for n in _nodes(params)),
            tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype, xs.device)


def _copies(tree):
    """The parameter tree with every trained tensor cloned (maps, seeds and
    metadata shared)."""
    if isinstance(tree, AnalogState):
        return AnalogState(tree.w.detach().clone(), tree.maps, tree.seed,
                           tree.meta)
    if isinstance(tree, dict):
        return {k: _copies(v) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and not all(
            type(v) is int for v in tree)):     # a host key is a leaf
        return type(tree)(_copies(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def make_cnn_epoch_fn(cfg: lenet.LeNetConfig, opt: Optional[Callable] = None,
                      *, batch: int) -> Callable:
    """``run_epoch(params, xs, ys, k_data, k_train, epoch)``: one epoch of
    ``len(xs) // batch`` steps over the device-resident split, shuffled by
    :func:`epoch_permutation`, step ``s`` under
    ``fold_in(k_train, epoch * spe + s)``; the tiles are updated in place
    (and returned).  The first call captures the step (again whenever the
    tiles or the split's shape change); every step is then one
    graph replay.  ``run_epoch.program`` is the captured step (its graph,
    whose nodes ``program.graph.debug_dump`` writes as a DOT file, the
    launches per replay by kind, tape, counter and buffers).  A replay adds
    its launches to ``ops.launch_counts``."""
    return _epoch_fn(make_cnn_step_fn(cfg, opt), batch)


def _epoch_fn(step: Callable, batch: int) -> Callable:
    """The graphed epoch of ``step(params, x, y, key)`` over a split."""

    def run_epoch(params, xs: torch.Tensor, ys: torch.Tensor,
                  k_data: prng.Key, k_train: prng.Key, epoch: int):
        sig = _signature(params, xs, ys)
        prog = run_epoch.program
        new = prog is None or run_epoch.sig != sig
        if new:
            prog = _EpochStep(step, xs, ys, batch)
        prog.xs.copy_(xs)
        prog.ys.copy_(ys)
        if new:
            prog.build(_copies(params), params)
            run_epoch.program, run_epoch.sig = prog, sig
        perm = epoch_permutation(k_data, epoch, xs.shape[0])
        prog.perm.copy_(perm[:prog.perm.numel()])
        prog.base.copy_(torch.tensor(k_train, dtype=torch.int64))
        prog.ctr.copy_(torch.tensor([0, epoch * prog.spe]))
        for _ in range(prog.spe):
            prog.run()
        return params

    run_epoch.program = run_epoch.sig = None
    return run_epoch


class _EvalStep(_Graphed):
    def __init__(self, cfg, xs, ys, batch):
        super().__init__(xs.device)
        self.cfg, self.batch = cfg, batch
        n = xs.shape[0]
        self.nb = -(-n // batch)
        pad = self.nb * batch - n
        self.xs = torch.cat([xs, xs.new_zeros((pad,) + tuple(xs.shape[1:]))])
        self.ys = torch.cat([ys, ys.new_zeros((pad,))])
        self.wt = torch.cat([torch.ones(n, device=self.device),
                             torch.zeros(pad, device=self.device)])
        self.advance = torch.tensor([1, batch], device=self.device)
        self.correct = torch.zeros((), device=self.device)

    def body(self, params, root):
        i = self.ctr[:1]
        pick = lambda t: t.view(self.nb, self.batch,  # noqa: E731
                                *t.shape[1:]).index_select(0, i)[0]
        with torch.no_grad():
            logits = lenet.apply(params, pick(self.xs), root, self.cfg)
            hit = (torch.argmax(logits, dim=-1) == pick(self.ys)).float()
            self.correct.add_(torch.sum(hit * pick(self.wt)))
        self.ctr.add_(self.advance)
        return self.correct


def make_cnn_eval_fn(cfg: lenet.LeNetConfig, *, batch: int = 256
                     ) -> Callable:
    """``evaluate(params, xs, ys, key) -> error``: the split padded to a
    batch multiple with weight-0 images, batch ``i`` read under
    ``fold_in(key, i * batch)`` (the reference's schedule, and
    ``cnn.make_eval``'s), one graph replay per batch; the error is
    ``1 - correct / n`` (one read-back per call)."""

    def evaluate(params: Params, xs: torch.Tensor, ys: torch.Tensor,
                 key: prng.Key) -> float:
        sig = _signature(params, xs, ys)
        prog = evaluate.program
        if prog is None or evaluate.sig != sig:
            prog = _EvalStep(cfg, xs, ys, batch)
            prog.build(params, params)
            evaluate.program, evaluate.sig = prog, sig
        else:
            prog.xs[:xs.shape[0]].copy_(xs)
            prog.ys[:ys.shape[0]].copy_(ys)
        prog.base.copy_(torch.tensor(key, dtype=torch.int64))
        prog.ctr.zero_()
        prog.correct.zero_()
        for _ in range(prog.nb):
            prog.run()
        return 1.0 - float(prog.correct) / xs.shape[0]

    evaluate.program = evaluate.sig = None
    return evaluate


# ---------------------------------------------------------------------------
# The recurrent (sequence) engines: the cell's time loop inside the step
# ---------------------------------------------------------------------------

def make_seq_step_fn(cfg, opt: Callable) -> Callable:
    """``step(params, tokens, targets, key)``: one sequence-model step
    (``repro_torch.recurrent.model``) in place, ``opt(params, grads)``
    (``optimizers.mixed_analog``) with the gradients of the tree's
    ``optimizers.leaves``; returns the summed loss (a device scalar).  The
    backward runs the cell's temporal-reuse cycles: per-timestep transpose
    reads, counts accumulated across the sequence, ONE ``finalize_counts``
    per tile."""
    from repro_torch.recurrent import model as seq_model

    def step(params, tokens, targets, key):
        ws = [t.requires_grad_() for t, _ in optimizers.leaves(params)]
        loss = seq_model.loss_fn(params, tokens, targets, key, cfg)
        opt(params, torch.autograd.grad(loss, ws))
        return loss.detach()

    return step


def make_seq_epoch_fn(cfg, opt: Callable, *, batch: int) -> Callable:
    """``run_epoch(params, tokens, targets, k_data, k_train, epoch)``: one
    epoch of the sequence trainer on the graphed step (as
    :func:`make_cnn_epoch_fn`): ``len(tokens) // batch`` steps, shuffled by
    :func:`epoch_permutation`, step ``s`` under ``fold_in(k_train, epoch *
    spe + s)``, one CUDA graph replay each on a card."""
    return _epoch_fn(make_seq_step_fn(cfg, opt), batch)


class _SeqEvalStep(_Graphed):
    def __init__(self, cfg, tokens, targets, batch):
        super().__init__(tokens.device)
        self.cfg, self.batch = cfg, batch
        n = tokens.shape[0]
        self.nb = -(-n // batch)
        pad = self.nb * batch - n
        self.tokens = torch.cat([tokens, tokens.new_zeros(
            (pad, tokens.shape[1]))])
        # padded rows carry all-IGNORE targets: they add no answer span
        self.targets = torch.cat([targets, targets.new_full(
            (pad, targets.shape[1]), -1)])
        self.advance = torch.tensor([1, batch], device=self.device)
        self.counts = torch.zeros(2, device=self.device)

    def body(self, params, root):
        from repro_torch.recurrent import model as seq_model
        i = self.ctr[:1]
        pick = lambda t: t.view(self.nb, self.batch,  # noqa: E731
                                -1).index_select(0, i)[0]
        with torch.no_grad():
            logits = seq_model.apply(params, pick(self.tokens), root,
                                     self.cfg)
            self.counts.add_(torch.stack(seq_model.hits(
                logits, pick(self.targets))))
        self.ctr.add_(self.advance)
        return self.counts


def make_seq_eval_fn(cfg, *, batch: int = 256) -> Callable:
    """``evaluate(params, tokens, targets, key) -> accuracy``: answer-span
    accuracy over a token split padded to a batch multiple (zero tokens,
    all-IGNORE targets), batch ``i`` read under ``fold_in(key, i *
    batch)`` (the JAX package's schedule), one graph replay per batch;
    inference runs the same noisy analog forward as training."""

    def evaluate(params, tokens: torch.Tensor, targets: torch.Tensor,
                 key: prng.Key) -> float:
        sig = _signature(params, tokens, targets)
        prog = evaluate.program
        if prog is None or evaluate.sig != sig:
            prog = _SeqEvalStep(cfg, tokens, targets, batch)
            prog.build(params, params)
            evaluate.program, evaluate.sig = prog, sig
        else:
            prog.tokens[:tokens.shape[0]].copy_(tokens)
            prog.targets[:targets.shape[0]].copy_(targets)
        prog.base.copy_(torch.tensor(key, dtype=torch.int64))
        prog.ctr.zero_()
        prog.counts.zero_()
        for _ in range(prog.nb):
            prog.run()
        return float(prog.counts[0] / torch.clamp_min(prog.counts[1], 1.0))

    evaluate.program = evaluate.sig = None
    return evaluate


# ---------------------------------------------------------------------------
# The LM trainer's chunks of steps
# ---------------------------------------------------------------------------

class _LMStep(_Graphed):
    def __init__(self, step, batch: Dict[str, torch.Tensor], device):
        super().__init__(device)
        self.step = step
        # one static buffer per leaf of a step's batch dict
        self.batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype,
                                     device=self.device)
                      for k, v in batch.items()}

    def fill(self, batches: Dict[str, torch.Tensor], i: int) -> None:
        for k, buf in self.batch.items():
            buf.copy_(batches[k][i])

    def body(self, state, root):
        params, opt_state = state
        _, _, metrics = self.step(params, opt_state, self.batch, root)
        self.ctr.add_(1)
        return metrics["loss"]


def scan_steps(step_fn: Callable) -> Callable:
    """Lift one LM train step into a chunk of graphed steps.

    ``step_fn(params, opt_state, batch, key) -> (params, opt_state,
    metrics)`` (in place) becomes ``multi(params, opt_state, batches, base,
    step0) -> (params, opt_state, metrics)``: ``batches`` a batch dict
    whose every leaf leads with the chunk axis (``tokens`` (chunk, B, S);
    an encoder-decoder's ``enc_embeds`` (chunk, B, S_src, d) beside them;
    host or device), step ``i`` of the chunk on the batch of
    ``batches[.][i]`` under ``fold_in(base, step0 + i)``, the JAX
    package's ``fold_in_keys(key_base, arange(step0, step0 + chunk))``.
    The first call captures the step (again whenever the state's tensors
    or the batch's leaves, shapes or dtypes change); each step is then one
    graph replay on a card (run as it is on the CPU), its batch copied
    into the capture's static buffers.  ``metrics["loss"]`` is the chunk's
    losses, one host read-back per call.  ``multi.program`` is the
    captured step.
    """
    def multi(params, opt_state, batches, base: prng.Key, step0: int):
        batches = {k: torch.as_tensor(v) for k, v in batches.items()}
        chunk = batches["tokens"].shape[0]
        dev = next(n.w.device if isinstance(n, AnalogState) else n.device
                   for n in _nodes(params))
        sig = (tuple((n.w.data_ptr(), id(n.maps))
                     if isinstance(n, AnalogState) else n.data_ptr()
                     for n in _nodes((params, opt_state))),
               tuple((k, tuple(v.shape[1:]), v.dtype)
                     for k, v in batches.items()), dev)
        prog = multi.program
        if prog is None or multi.sig != sig:
            multi.program = None          # its graph's pool goes first
            prog = _LMStep(step_fn, {k: v[0] for k, v in batches.items()},
                           dev)
            prog.fill(batches, 0)
            prog.build((_copies(params), _copies(opt_state)),
                       (params, opt_state))
            multi.program, multi.sig = prog, sig
        prog.base.copy_(torch.tensor(base, dtype=torch.int64))
        prog.ctr.copy_(torch.tensor([0, step0]))
        losses = torch.empty(chunk, device=dev)
        for i in range(chunk):
            prog.fill(batches, i)
            losses[i].copy_(prog.run())
        return params, opt_state, {"loss": losses.cpu()}

    multi.program = multi.sig = None
    return multi
