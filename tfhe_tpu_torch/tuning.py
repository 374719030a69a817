"""Tuning knobs: one frozen config, read where a path is chosen.

Counterpart of `tfhe_tpu/tuning.py`, with the same names and defaults for
the knobs that choose a path or a key form this package has:

* `karatsuba_depth`: block-Karatsuba depth for new bootstrap keys; 0 bakes
  the dense block-Toeplitz key.
* `bs_bake_budget`: -1 always bakes, 0 forces the compact prepared form,
  > 0 bakes only if the baked key fits that many bytes.
* `mk_bake_budget`: bytes for the multi-key T <= 64 bake that the CPU path
  uses; -1 = the caller's default (6 GiB), 0 forces the prepared form.
* `mk_sparse_limbs`: "auto" | "0" | "1": store only the nonzero blocks of
  the multi-key operand (auto: on a CUDA device when the dense prepared
  key passes 8 GiB).
* `mk_cmux`: "auto" | "expand" | "prepared" | "xla": the multi-key rotation
  through the sparse-expansion kernels (auto: when the key is on a CUDA
  device) or through the prepared external product.
* `mk_compact`: "auto" | "0" | "1": one call per party from the compact
  limbs with the expansion inside (auto: on a CUDA device).
* `mk_mega`: "auto" | "0" | "1": otherwise, chunks of steps per call (auto:
  4 parties and more) instead of one call per step.
* `mk_chunk`: steps per chunk; 0 = the largest divisor of n up to 20 whose
  expanded chunk stays under 1 GiB.
* `mk_progressive`: the triangular rotation, which skips the blocks of
  parties not yet processed. Every value of every multi-key knob gives the
  same bits.
* `radix_manylut`: radix integers evaluate a pair of lookup tables on one
  input with one blind rotation (`pbs.programmable_bootstrap_many`, q = 2)
  instead of two. The one knob here that changes results: the many-LUT
  modulus switch rounds to a grid twice as coarse, so the output words
  differ (the decrypted integers do not).
* `debug`: the opt-in safe mode of `debug.py`: every blind rotation runs
  both through its dispatcher and through the step-by-step `mux_rotate`
  loop, raises `FHEDebugError` on any differing word, and returns the
  loop's result. Off unless asked for.

`result_fingerprint()` is the JSON of the knobs that change results, with
the reference's keys (`debug`, `pipe_ablate`, `radix_manylut`), so that a
job checkpoint's fingerprint is the same in both packages. The port has no
`pipe_ablate` (a TPU timing ablation), so that key is always "".

The environment (`TFHE_TPU_*`, the reference's names) is parsed only here;
`set_tuning` or the `override(...)` context manager installs an explicit
config that takes precedence. The reference's batch tile, DMA slot and VMEM
knobs (`mk_btk` and `mk_group_mb` among them) describe the TPU kernels'
schedule and have no counterpart. Its caveat about jit caching does not
apply either: torch runs eagerly and caches no trace, so a knob is read on
every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    karatsuba_depth: int = 2
    bs_bake_budget: int = -1
    mk_bake_budget: int = -1
    mk_sparse_limbs: str = "auto"
    mk_cmux: str = "auto"
    mk_chunk: int = 0
    mk_mega: str = "auto"
    mk_compact: str = "auto"
    mk_progressive: bool = True
    radix_manylut: bool = True
    debug: bool = False

    RESULT_AFFECTING = ("radix_manylut", "pipe_ablate", "debug")

    @property
    def pipe_ablate(self) -> str:
        """The reference's timing-ablation knob, which this package does
        not have: always off."""
        return ""

    def result_fingerprint(self) -> str:
        """The knobs a checkpoint must not silently change under."""
        return json.dumps({k: getattr(self, k) for k in self.RESULT_AFFECTING},
                          sort_keys=True)

    def describe(self) -> dict:
        """Every knob by name, for logs."""
        return dataclasses.asdict(self)


_ENV = {
    "karatsuba_depth": "TFHE_TPU_KARATSUBA_DEPTH",
    "bs_bake_budget": "TFHE_TPU_BS_BAKE_BUDGET",
    "mk_bake_budget": "TFHE_TPU_MK_BAKE_BUDGET",
    "mk_sparse_limbs": "TFHE_TPU_MK_SPARSE_LIMBS",
    "mk_cmux": "TFHE_TPU_MK_CMUX",
    "mk_chunk": "TFHE_TPU_MK_CHUNK",
    "mk_mega": "TFHE_TPU_MK_MEGA",
    "mk_compact": "TFHE_TPU_MK_COMPACT",
    "mk_progressive": "TFHE_TPU_MK_PROGRESSIVE",
    "radix_manylut": "TFHE_TPU_RADIX_MANYLUT",
    "debug": "TFHE_TPU_DEBUG",
}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")

_OVERRIDE: list = []


def _parse(field: dataclasses.Field, var: str, raw: str):
    if field.type == "int":
        return int(raw)
    if field.type == "bool":
        low = raw.strip().lower()
        if low not in _TRUE + _FALSE:
            raise ValueError(f"{var}={raw!r}: expected a boolean "
                             "(1/true/yes/on or 0/false/no/off)")
        return low in _TRUE
    return raw


def from_env() -> TuningConfig:
    """Parse the TFHE_TPU_* environment into a TuningConfig."""
    kw = {f.name: _parse(f, _ENV[f.name], os.environ[_ENV[f.name]])
          for f in dataclasses.fields(TuningConfig)
          if _ENV[f.name] in os.environ}
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


# --- environment reads that are not knobs, kept here so that the package
# reads the environment in one module ---

def env_str(name: str, default: str | None = None) -> str | None:
    return os.environ.get(name, default)


def env_int(name: str, default: int | None = None) -> int | None:
    raw = os.environ.get(name)
    return default if raw is None else int(raw)
