"""Profiling and roofline counters.

Counterpart of `tfhe_tpu/utils/profiling.py`:

* `trace(log_dir)`: a context manager around `torch.profiler` (host and,
  where there is a card, CUDA activity) that writes a Chrome trace,
  `trace.json`, into `log_dir` (open it in Perfetto or chrome://tracing);
* `bootstrap_roofline(...)`: the work of a batched gate bootstrap's blind
  rotation counted from its shapes, and the least time one H100 could take
  for it, so that a measured time becomes a utilization.

The reference's `enable_xla_dump` has no counterpart: there is no XLA
here. The port's compiler step is the nvcc build of `ops/_build.py`,
whose `build.log` holds ptxas's register and shared-memory report.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

import torch

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
# full 700 W power limit): int8 tensor-core operations (a multiply-add is
# two) and HBM bytes per second.
H100_INT8_OPS = 1979e12
H100_HBM_BYTES = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block; on exit write `log_dir`/trace.json.
    log_dir defaults to a directory under the temporary directory."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "tfhe_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Work counters of one batched blind rotation, with the card's
    floors."""

    byte_macs: int        # int8 multiply-adds
    hbm_bytes: int        # bytes the rotation must move
    alu_elems: int        # int32 elementwise results outside the dots
    int8_floor_s: float   # 2 * byte_macs / the int8 peak
    hbm_floor_s: float    # hbm_bytes / the memory rate

    def utilization(self, measured_s: float) -> dict:
        """The share of each floor that a measured time reaches."""
        return {
            "int8": self.int8_floor_s / measured_s,
            "hbm": self.hbm_floor_s / measured_s,
            "floor_s": max(self.int8_floor_s, self.hbm_floor_s),
        }


def bootstrap_roofline(params, batch: int, depth: int = 2,
                       block: int = 128) -> Roofline:
    """Counters of the blind rotations of `batch` gate bootstraps.

    Per CMUX step the Karatsuba plan's `macs_superblocks` int8 products of
    [B, P*T] x [P*T, K*4*T], each once (as the port's dots kernels run
    them); the bytes are the function's own: the baked key read once (one
    K-major pass), the accumulator read and written once, the rotation
    amounts read once. The elementwise count is the reference's (rotation,
    digits, recombination and fold). The reference's `cells` argument, the
    TPU's per-cell re-streaming of the key, has no counterpart.
    """
    from ..ops.karatsuba import karatsuba_plan

    n = params.tlwe_polynomial_degree
    k1 = params.tlwe_mask_size + 1
    l = params.bs_decomp_length
    steps = params.lwe_size
    m = n // block
    pt = k1 * l * block
    cols = k1 * 4 * block

    plan = karatsuba_plan(m, min(depth, m.bit_length() - 1),
                          params.bs_log2_base)
    byte_macs = batch * steps * plan.macs_superblocks * pt * cols
    key_bytes = steps * plan.total_rows * pt * cols
    hbm = key_bytes + 2 * batch * k1 * n * 4 + batch * steps * 4

    stages = (n - 1).bit_length()
    alu_row_step = (
        k1 * (2 * stages + 3) * n      # rotation + subtraction
        + k1 * l * 2 * n               # digit shift/mask/store
        + plan.macs_superblocks * 2 * cols // 4  # recombine + fold
    )
    return Roofline(
        byte_macs=int(byte_macs),
        hbm_bytes=int(hbm),
        alu_elems=int(batch * steps * alu_row_step),
        int8_floor_s=2.0 * byte_macs / H100_INT8_OPS,
        hbm_floor_s=hbm / H100_HBM_BYTES,
    )
