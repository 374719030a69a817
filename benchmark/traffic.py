"""The one traffic generator: a workload file's parameters and a seed give
the plaintext bits, the operand pool and the order of the work.

A workload file (`benchmark/workloads/<cell>.json`) holds:

* `config`: the configuration's name;
* `gate`: the gate every unit runs (`nand`);
* `batch`: gates a unit runs together;
* `loop`: `chained` (each unit is a layer of `batch` gates on the previous
  layer's outputs, layers kept queued, the window's rate is the metric)
  or `closed` (one client: each unit is a request, issued when the last
  one's output is on the host, the latencies are the metric);
* `pool`: the second operand of unit u is pool ciphertext slot(u), with
  `pool` slots of `batch` ciphertexts encrypted in set-up;
* `period`: units after which the drawn order repeats;
* `keep_rows` (chained): rows of each layer whose operands and outputs are
  kept for the comparison with the reference;
* `check_sample`: gates the reference recomputes after the window;
* `trace_units`: units the traced run profiles.

Every seed gives the same sizes and the same amount of work; only the bits,
the order of the pool and the kept rows change.
"""

from __future__ import annotations

import dataclasses

import torch

LOOPS = ("chained", "closed")


@dataclasses.dataclass
class Traffic:
    loop: str
    batch: int
    first_bits: torch.Tensor  # bool[batch]: the first unit's first operand
    pool_bits: torch.Tensor  # bool[pool, batch]
    slots: list  # pool slot of unit u % period
    rows: torch.Tensor  # int64[period, keep_rows]: rows kept of unit u

    def slot(self, u: int) -> int:
        return self.slots[u % len(self.slots)]

    def expected(self, units: int) -> torch.Tensor:
        """bool[units, batch]: the plaintext of every unit's output,
        NAND(previous output, pool bits)."""
        out, x = [], self.first_bits
        for u in range(units):
            x = ~(x & self.pool_bits[self.slot(u)])
            out.append(x)
        return torch.stack(out) if out else torch.zeros(
            (0, self.batch), dtype=torch.bool)


def make_traffic(w: dict, seed: int) -> Traffic:
    if w["loop"] not in LOOPS or w["gate"] != "nand":
        raise ValueError(f"workload: loop {w['loop']!r}, gate {w['gate']!r}")
    gen = torch.Generator().manual_seed(seed)
    batch, period = w["batch"], w["period"]
    first = torch.randint(0, 2, (batch,), generator=gen).bool()
    pool = torch.randint(0, 2, (w["pool"], batch), generator=gen).bool()
    slots = torch.randint(0, w["pool"], (period,), generator=gen).tolist()
    keep = min(w.get("keep_rows", batch), batch)
    rows = torch.randint(0, batch, (period, keep), generator=gen)
    return Traffic(w["loop"], batch, first, pool, slots, rows)
