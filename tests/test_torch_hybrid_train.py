"""Training the hybrid family: the port's LM trainer on hymba_1_5b against
the JAX package's, at the smoke size (2 layers of sliding-window attention,
window 32, beside an SSD branch; d 64, vocab 256; batch 2, seq 32), float32
parameters, through ``test_torch_ssm_train.py``'s checks and tolerances:

* the digital ``loss_fn`` and its gradients (loss at rtol 1e-5, every
  gradient leaf, the SSD branch's ``A_log``, ``D``, ``dt_bias`` and
  ``conv_w`` included, at rtol 1e-4 and atol 1e-5); the attention trains
  through the chunked online-softmax path with the window mask;
* one analog step from JAX's weights under ``SINGLE_2P``, ``SINGLE_IT``
  and ``TEMPORAL`` (the SSD branch's projections on each route under each
  BM mode; the attention's, the MLP's and the unembed's tiles
  single-shot): the loss
  within 1e-5, the 10 tiles within the LM bounds (at most 1e-3 of a tile's
  entries beyond 1e-6, none beyond 3e-3, every tile moved);
* the scan engine bitwise the python loop on the CPU (2 steps) under
  ``SINGLE_2P`` and ``TEMPORAL``;
* the CLI trains 2 steps on the CPU.

Four JAX programs are compiled here, each once.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_ssm_train import (SINGLE_2P, SPEC_IDS, SPECS, TEMPORAL,
                                  check_analog_step, check_cli,
                                  check_digital, check_engines)

ARCH = "hymba_1_5b"


def test_digital_loss_and_grads_match_jax():
    check_digital(ARCH)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_analog_step_matches_jax(spec):
    check_analog_step(ARCH, spec, n_tiles=10)


@pytest.mark.parametrize("spec", [SINGLE_2P, TEMPORAL],
                         ids=["single_two_phase", "temporal"])
def test_scan_engine_is_the_loop_bitwise(spec):
    check_engines(ARCH, spec)


def test_cli_trains_on_the_cpu(capsys):
    check_cli(ARCH, capsys)
