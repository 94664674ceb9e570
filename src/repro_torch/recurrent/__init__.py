"""Analog recurrent training: temporal weight reuse on RPU tiles.

The temporal counterpart of the conv mapping's spatial weight sharing
(after "Training LSTM Networks with Resistive Cross-Point Devices",
1806.00166): one tile read and transpose-read every timestep, pulse
counts accumulated across the unrolled sequence, finalized once per
training step, bit for bit the fully unrolled oracle.

* :mod:`repro_torch.recurrent.cell`     — LSTM/GRU cells (autograd time loop)
* :mod:`repro_torch.recurrent.oracle`   — the unrolled single-shot reference
* :mod:`repro_torch.recurrent.model`    — copy-task sequence model + loss
* :mod:`repro_torch.recurrent.temporal` — non-recurrent accumulate-across-
  time dense
"""

from repro_torch.recurrent.cell import CellSpec, cell_apply, init_cell  # noqa: F401
from repro_torch.recurrent.model import SeqConfig  # noqa: F401
from repro_torch.recurrent.temporal import (temporal_dense_apply,  # noqa: F401
                                            temporal_eligible)
