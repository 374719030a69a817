"""A unit of work besides the NAND gate, to show that one is added as
files alone: (x + y) mod 4 on one base-4 digit, in the programmable
bootstrap's encoding m/(2S) with S = 8 (one padding bit, a carry's
headroom), as one radix digit of `tfhe_tpu_torch.radix` is. A row is one
digit; a unit adds two digits (their sum below S) and reduces the sum mod
4 by one table lookup, `pbs.programmable_bootstrap` (single key only).
The reference is the plain bootstrap of `benchmark/reference/tfhe.py`
with the table's test polynomial."""

from __future__ import annotations

import torch

from benchmark.reference.tfhe import wrap32

SPACE = 8  # S: messages in [0, S), phase m/(2S)
DIGIT = 4
TABLE = [m % DIGIT for m in range(SPACE)]
SHIFT = 32 - 4  # m/(2S) = m * 2^(32 - log2(2S))


def draw(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, DIGIT, shape, generator=gen)


def phase(plain: torch.Tensor) -> torch.Tensor:
    return wrap32(plain.to(torch.int64) << SHIFT)


def apply(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x + y) % DIGIT


def decrypt(phase: torch.Tensor) -> torch.Tensor:
    """The nearest message in [0, 2S); one at S or above is a failure."""
    near = (phase.to(torch.int64) + (1 << (SHIFT - 1))) >> SHIFT
    return torch.remainder(near, 2 * SPACE)


def program(scheme: str):
    if scheme != "cggi":
        raise ValueError(f"add4 runs under one key, not {scheme!r}")
    from tfhe_tpu_torch.pbs import programmable_bootstrap

    def add(ck, x, y):
        return programmable_bootstrap(ck.bootstrap_key, ck.keyswitch_key,
                                      TABLE, x + y, SPACE)

    return add


def reference(ref, x_a, x_b, y_a, y_b):
    n_poly = ref.p["tlwe_polynomial_degree"]
    w = n_poly // SPACE  # each entry repeated over its window of w
    c_a = wrap32(x_a.to(torch.int64) + y_a.to(torch.int64))
    c_b = wrap32(x_b.to(torch.int64) + y_b.to(torch.int64))
    test = phase(torch.tensor(TABLE, device=c_b.device)).repeat_interleave(w)
    return ref.bootstrap(c_a, c_b, test.expand(c_b.shape[0], n_poly),
                         barb_offset=w // 2)


def rotations_per_row(p: dict) -> int:
    return 1
