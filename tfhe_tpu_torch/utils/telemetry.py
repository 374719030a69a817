"""Observability: noise-margin telemetry and throughput accounting.

Counterpart of `tfhe_tpu/utils/telemetry.py`:

* `noise_margin`: the decrypted phases' distance from the ideal +-1/8
  encoding and from the decision boundary, for a batch of ciphertexts (it
  needs the secret key: a client-side or test-time diagnostic of the gate
  contract, noise < 1/16 of the torus);
* `GateThroughput`: wall-clock gates per second of a batched run, ended
  by `block_on`, which waits for the card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..api import SecretKey
from ..lwe import LweSample, lwe_phase
from ..numeric import encode_message


@dataclasses.dataclass
class NoiseReport:
    """Phase-margin statistics of a ciphertext batch (fractions of the
    torus)."""

    mean_error: float
    max_error: float
    margin: float  # distance of the worst sample from the decision boundary
    failures: int  # samples whose phase sign no longer matches +-mu

    def healthy(self, budget: float = 1.0 / 16) -> bool:
        """The gate contract: noise < 1/16 of the torus."""
        return self.failures == 0 and self.max_error < budget


def noise_margin(key: SecretKey, sample: LweSample,
                 expected=None) -> NoiseReport:
    """How far each phase sits from the ideal +-1/8 encoding.

    expected: optional bool[...] of the true plaintexts; without it the
    nearest encoding is taken as right (failures are then 0).
    """
    phase = lwe_phase(sample, key.key).cpu().numpy().astype(np.int64)
    mu = np.int64(encode_message(1, 8))

    def circ_dist(d):
        # circular torus distance: reduce mod 2^32 into [-2^31, 2^31)
        return np.abs(((d + 2**31) & 0xFFFFFFFF) - 2**31)

    err_pos = circ_dist(phase - mu)
    err_neg = circ_dist(phase + mu)
    err = np.minimum(err_pos, err_neg)
    failures = 0
    if expected is not None:
        want = (expected.cpu().numpy() if isinstance(expected, torch.Tensor)
                else np.asarray(expected)).astype(bool)
        failures = int(((phase > 0) != want).sum())
        err = np.where(want, err_pos, err_neg)
    scale = float(2**32)
    return NoiseReport(
        mean_error=float(err.mean()) / scale,
        max_error=float(err.max()) / scale,
        margin=float(mu - err.max()) / scale,
        failures=failures,
    )


def _tensors(tree):
    """The tensors in nested tuples, lists, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


class GateThroughput:
    """Wall-clock gates/s: `with GateThroughput(n) as t: ...`; call
    `t.block_on(result)` last inside the block."""

    def __init__(self, n_gates: int):
        self.n_gates = n_gates
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @property
    def gates_per_second(self) -> float:
        return self.n_gates / self.elapsed if self.elapsed else float("inf")

    def block_on(self, tree):
        """Wait for the devices of the tensors in `tree` before the clock
        stops (the card runs behind the host)."""
        for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        return tree
