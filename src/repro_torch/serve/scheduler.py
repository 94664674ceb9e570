"""Continuous batching: admit requests mid-decode into freed cache slots.

The static serving path (``engine.greedy_generate``) decodes one fixed
batch to completion.  This scheduler keeps one batched decode loop over a
fixed pool of ``slots`` cache rows and rotates a request stream through
it:

  queued --admit--> prefill into a free slot --decode--> batched
  ``serve_step`` over all slots --finish (EOS / max-new)--> slot freed -->
  head of the queue admitted into it, mid-decode.

Admission is FIFO over submission order, a freed slot is always the lowest
free index, and analog decode keys derive from ``engine.decode_step_key``
over the scheduler's global step counter, so the same (params, requests,
slots, seed) always gives the same event log.  Batched decode rows are
computed independently, so every request's tokens match a per-request
``greedy_generate`` for digital params and noise-free analog configs;
noisy reads are replayable but draw noise that depends on the batch.

Free slots decode token 0 from whatever their rows hold (stale or zero
state), as in the JAX package: their rows are never read.

The slot pool is one card's memory: a :class:`MeshPlan` with more than one
data device raises (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve import engine

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """One generation request.  ``arrival`` is the scheduler tick at which
    the request becomes admissible (``run``'s synthetic-traffic clock)."""
    rid: int
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int
    arrival: int = 0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]                  # all emitted tokens, EOS included
    reason: str                        # 'eos' | 'length'
    admitted_step: int
    finished_step: int
    slot: int


@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """Replay-log entry; the property tests audit slot lifecycles on it."""
    kind: str                          # 'admit' | 'finish'
    step: int
    rid: int
    slot: int
    reason: str = ""


@dataclasses.dataclass
class _Active:
    rid: int
    last_token: int
    emitted: List[int]
    max_new_tokens: int
    admitted_step: int


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The data axis of the JAX package's mesh plan: ``data`` devices
    would each hold a share of the cache slots."""
    data: int = 1


class ContinuousBatchingScheduler:
    """Slot-rotating batched decode over a fixed cache pool.

    The two model-touching steps are :meth:`_admit_slot` (prefill one
    request, write its cache into a slot) and :meth:`_decode_tokens` (one
    batched ``serve_step`` and greedy argmax); everything else is slot and
    queue bookkeeping, which the property tests drive through a stub
    engine that overrides exactly those two methods.
    """

    def __init__(self, params: Any, cfg: ModelConfig, *, slots: int,
                 max_seq: int, eos_id: Optional[int] = None,
                 akey=None, plan: Optional[MeshPlan] = None):
        self._init_bookkeeping(slots, eos_id)
        if cfg.encoder_layers > 0:
            raise NotImplementedError(
                "continuous batching does not thread encoder memories yet; "
                "enc-dec models serve through the static "
                "engine.greedy_generate path")
        if plan is not None and plan.data > 1:
            raise NotImplementedError(
                f"mesh plan {plan}: the slot pool lives on one card; "
                "sharding the cache slots over devices waits for "
                "scale-out (ROADMAP Queue 1, item 4)")
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.akey = akey
        # built lazily from the first prefill's cache tree (zeros over the
        # slot axis): the model decides the leaves' dtypes (an f32 analog
        # policy over a bf16 activation config)
        self._cache: Optional[Dict[str, Tensor]] = None

    def _init_bookkeeping(self, slots: int, eos_id: Optional[int]) -> None:
        """Queue and slot state only (a stub-engine subclass calls this and
        overrides the two model-touching methods)."""
        if slots < 1:
            raise ValueError(f"need at least one cache slot, got {slots}")
        self.slots = slots
        self.eos_id = eos_id
        self.queue: "deque[Request]" = deque()
        self.events: List[SlotEvent] = []
        self.completions: List[Completion] = []
        self._active: List[Optional[_Active]] = [None] * slots
        self._step = 0                 # global decode-step counter (keys)
        self._tick = 0                 # scheduler ticks (arrival clock)

    # --- model-touching internals (override points for the stub engine) --

    def _insert_impl(self, cache: Dict[str, Tensor],
                     cache1: Dict[str, Tensor], slot: int) -> None:
        """Write a batch-1 prefill cache into slot ``slot`` of the pool,
        in place.  Every leaf carries batch on axis 1 under a leading
        layers axis, except ``pos`` (batch on axis 0)."""
        for k, dst in cache.items():
            src = cache1[k]
            if dst.dim() == 1:         # pos: (batch,)
                dst[slot] = src[0]
            else:
                dst[:, slot] = src[:, 0]

    def _ensure_pool(self, cache1: Dict[str, Tensor]) -> None:
        """Materialise the slot pool from a batch-1 prefill cache tree."""
        if self._cache is not None:
            return
        pool = {}
        for k, src in cache1.items():
            shape = ((self.slots,) if src.dim() == 1
                     else (src.shape[0], self.slots) + tuple(src.shape[2:]))
            pool[k] = torch.zeros(shape, dtype=src.dtype, device=src.device)
        self._cache = pool

    def _device(self):
        return self.params["embed"]["table"].device

    def _admit_slot(self, req: Request, slot: int) -> int:
        """Prefill ``req`` and park its cache in ``slot``; first token."""
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self._device())[None]
        with torch.no_grad():
            logits, cache1 = engine.prefill(self.params, prompt, self.cfg,
                                            max_seq=self.max_seq,
                                            akey=self.akey)
            self._ensure_pool(cache1)
            self._insert_impl(self._cache, cache1, slot)
        return int(torch.argmax(logits[0, -1]))

    def _decode_tokens(self, last_tokens: np.ndarray) -> np.ndarray:
        """One batched decode step; per-slot greedy next tokens (slots,)."""
        toks = torch.as_tensor(last_tokens, dtype=torch.int64,
                               device=self._device())[:, None]
        step_key = engine.decode_step_key(self.akey, self._step)
        with torch.no_grad():
            logits, self._cache = engine.serve_step(
                self.params, toks, self._cache, self.cfg, akey=step_key)
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    # --- queue / slot bookkeeping ----------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def submit_many(self, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(r)

    @property
    def idle(self) -> bool:
        return not self.queue and all(a is None for a in self._active)

    @property
    def n_free(self) -> int:
        return sum(a is None for a in self._active)

    def _finish(self, slot: int, reason: str) -> Completion:
        a = self._active[slot]
        assert a is not None
        comp = Completion(rid=a.rid, tokens=list(a.emitted), reason=reason,
                          admitted_step=a.admitted_step,
                          finished_step=self._tick, slot=slot)
        self.events.append(SlotEvent("finish", self._tick, a.rid, slot,
                                     reason))
        self.completions.append(comp)
        self._active[slot] = None
        return comp

    def _token_finishes(self, a: _Active, tok: int) -> Optional[str]:
        if self.eos_id is not None and tok == self.eos_id:
            return "eos"
        if len(a.emitted) >= a.max_new_tokens:
            return "length"
        return None

    def step(self) -> List[Completion]:
        """One scheduler tick: admissions, then one batched decode step.

        Returns the requests that finished during this tick (possibly at
        admission: a one-token request, or a first token that is EOS).
        """
        finished: List[Completion] = []

        # 1. admission: FIFO queue into the lowest free slots; a request
        # that completes at its first (prefill) token frees its slot for
        # the next queued request within the same tick
        while self.queue and self.n_free > 0:
            req = self.queue.popleft()
            slot = next(i for i, a in enumerate(self._active) if a is None)
            first = self._admit_slot(req, slot)
            a = _Active(rid=req.rid, last_token=first, emitted=[first],
                        max_new_tokens=max(1, req.max_new_tokens),
                        admitted_step=self._tick)
            self._active[slot] = a
            self.events.append(SlotEvent("admit", self._tick, req.rid, slot))
            reason = self._token_finishes(a, first)
            if reason is not None:
                finished.append(self._finish(slot, reason))

        # 2. one batched decode step over the whole pool (free slots decode
        # rows that are never read)
        if any(a is not None for a in self._active):
            last = np.asarray([a.last_token if a is not None else 0
                               for a in self._active], np.int64)
            nxt = self._decode_tokens(last)
            self._step += 1
            for slot, a in enumerate(self._active):
                if a is None:
                    continue
                tok = int(nxt[slot])
                a.last_token = tok
                a.emitted.append(tok)
                reason = self._token_finishes(a, tok)
                if reason is not None:
                    finished.append(self._finish(slot, reason))

        self._tick += 1
        return finished

    def run(self, requests: Sequence[Request],
            max_ticks: Optional[int] = None) -> List[Completion]:
        """Drive a whole synthetic-traffic trace to completion: requests
        enter the queue at their ``arrival`` tick, in the order given (FIFO
        among same-tick arrivals)."""
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        done: List[Completion] = []
        while pending or not self.idle:
            while pending and pending[0].arrival <= self._tick:
                self.submit(pending.popleft())
            done.extend(self.step())
            if max_ticks is not None and self._tick >= max_ticks:
                break
        return done
