"""Sequence model over the analog recurrent cell: copy-task LSTM/GRU.

Port of the JAX package's ``recurrent/model.py``: one recurrent cell and a
dense readout, sized for the delayed-copy task (``data/sequences.py``), so
that the managed-vs-unmanaged reproduction of the LSTM-on-RPU sequel paper
(1806.00166) runs in seconds.  Every projection is a *dense site*:
:func:`init` builds digital params (the JAX package's draws from the same
key), and ``repro_torch.analog.convert.convert_to_analog`` under an
``AnalogPolicy`` rewrites any subset of ``{cell/wx, cell/wh, readout}``
onto crossbar tiles (path-keyed seeds, as in JAX).  :func:`apply` is
parameter-typed: the same function runs the FP baseline and the RPU
configuration.

The loss is the repo-wide SUMMED cross-entropy, masked to the answer span:
each sequence's error vectors enter the pulse-update cycle unscaled.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.recurrent.cell import CellSpec, cell_apply, init_cell
from repro_torch.utils import prng

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    kind: str = "lstm"                   # 'lstm' | 'gru'
    vocab: int = 8
    hidden: int = 32
    seq_len: int = 4                     # payload symbols
    delay: int = 2                       # blank gap (incl. GO marker slot)
    time_chunk: Optional[int] = 1        # the JAX scan's chunk (no bit)
    lr: float = 0.01

    @property
    def spec(self) -> CellSpec:
        return CellSpec(kind=self.kind, hidden=self.hidden,
                        time_chunk=self.time_chunk)

    @property
    def t_total(self) -> int:
        return 2 * self.seq_len + self.delay


def init(key: prng.Key, cfg: SeqConfig, *, device="cpu") -> Params:
    """Digital params; convert with an AnalogPolicy after.  The readout is
    the JAX package's ``dense_init``: a truncated normal at scale
    ``hidden ** -0.5`` and a zero bias."""
    k_cell, k_out = prng.split(key)
    cell_p = init_cell(k_cell, cfg.vocab, cfg.spec, device=device)
    w = np.float32(cfg.hidden ** -0.5) * prng.truncated_normal(
        k_out, -2.0, 2.0, (cfg.hidden, cfg.vocab))
    out_p = {"w": torch.from_numpy(w).to(device),
             "b": torch.zeros(cfg.vocab, dtype=torch.float32,
                              device=device)}
    return {"cell": cell_p, "readout": out_p}


def one_hot(tokens: Tensor, vocab: int) -> Tensor:
    """(B, T) tokens -> (T, B, V) float32 one-hot (a comparison with the
    symbol ids: no host check of the token range)."""
    ids = torch.arange(vocab, device=tokens.device)
    return (tokens.T[..., None] == ids).to(torch.float32)


def apply(params: Params, tokens: Tensor, key: Optional[prng.AnyKey],
          cfg: SeqConfig) -> Tensor:
    """tokens (B, T) int -> logits (T, B, V) (time-major, like the cell).

    ``key`` may be ``None`` only when every site is digital.
    """
    xs = one_hot(tokens, cfg.vocab)
    k_cell = k_out = None
    if key is not None:
        k_cell, k_out = prng.split(key)
    hs, _h_t, _c_t = cell_apply(params["cell"], xs, cfg.spec, key=k_cell,
                                lr=cfg.lr)
    return L.dense_apply(params["readout"], hs, key=k_out, lr=cfg.lr)


def loss_fn(params: Params, tokens: Tensor, targets: Tensor,
            key: Optional[prng.AnyKey], cfg: SeqConfig) -> Tensor:
    """Summed masked softmax cross-entropy over the answer span."""
    logits = apply(params, tokens, key, cfg)            # (T, B, V)
    tgt = targets.T.long()                              # (T, B)
    mask = (tgt >= 0).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt.clamp_min(0)[..., None])[..., 0]
    return torch.sum(nll * mask)


def hits(logits: Tensor, targets: Tensor):
    """``(correct, answered)`` float32 counts of the answer span."""
    tgt = targets.T.long()
    mask = tgt >= 0
    hit = (torch.argmax(logits, dim=-1) == tgt) & mask
    return hit.sum(dtype=torch.float32), mask.sum(dtype=torch.float32)


def accuracy(params: Params, tokens: Tensor, targets: Tensor,
             key: Optional[prng.AnyKey], cfg: SeqConfig) -> Tensor:
    """Fraction of answer-span symbols predicted correctly (noisy forward:
    inference runs on the same analog arrays)."""
    correct, total = hits(apply(params, tokens, key, cfg), targets)
    return correct / torch.clamp_min(total, 1.0)
