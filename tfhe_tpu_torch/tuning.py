"""Tuning knobs: one frozen config, read where a path is chosen.

Counterpart of `tfhe_tpu/tuning.py`, with the same names and defaults for
the knobs that choose a path this package has:

* `karatsuba_depth`: block-Karatsuba depth for new bootstrap keys; 0 bakes
  the dense block-Toeplitz key.
* `bs_bake_budget`: -1 always bakes, 0 forces the compact prepared form,
  > 0 bakes only if the baked key fits that many bytes.

The environment (`TFHE_TPU_KARATSUBA_DEPTH`, `TFHE_TPU_BS_BAKE_BUDGET`) is
parsed only here; `set_tuning` or the `override(...)` context manager
installs an explicit config that takes precedence. The reference's batch
tile, DMA slot and VMEM knobs describe the TPU kernels' schedule and have
no counterpart. Its caveat about jit caching does not apply either: torch
runs eagerly and caches no trace, so a knob is read on every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    karatsuba_depth: int = 2
    bs_bake_budget: int = -1


_ENV = {
    "karatsuba_depth": "TFHE_TPU_KARATSUBA_DEPTH",
    "bs_bake_budget": "TFHE_TPU_BS_BAKE_BUDGET",
}

_OVERRIDE: list = []


def from_env() -> TuningConfig:
    """Parse the TFHE_TPU_* environment into a TuningConfig."""
    kw = {name: int(os.environ[var]) for name, var in _ENV.items()
          if var in os.environ}
    return TuningConfig(**kw)


def get_tuning() -> TuningConfig:
    """The active config: the innermost override if one is installed, else
    the environment."""
    if _OVERRIDE:
        return _OVERRIDE[-1]
    return from_env()


def set_tuning(cfg: TuningConfig | None) -> None:
    """Install (or, with None, clear) a process-wide explicit config."""
    _OVERRIDE.clear()
    if cfg is not None:
        _OVERRIDE.append(cfg)


@contextlib.contextmanager
def override(**kwargs):
    """Context manager: temporarily replace the named knobs."""
    _OVERRIDE.append(dataclasses.replace(get_tuning(), **kwargs))
    try:
        yield _OVERRIDE[-1]
    finally:
        _OVERRIDE.pop()
