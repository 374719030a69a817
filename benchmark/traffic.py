"""The one traffic generator: a workload file's parameters, its unit of
work and a seed give the plaintexts, the operand pool and the order of the
work.

A workload file (`benchmark/workloads/<cell>.json`) holds:

* `config`: the configuration's name;
* `gate`: the unit of work, the file `units/<gate>.py` (`nand`; see
  `benchmark/run.py:load_unit`): it draws the plaintexts and computes
  what each row's output decrypts to;
* `batch`: rows a unit runs together;
* `loop`: `chained` (each unit is a layer of `batch` rows on the previous
  layer's outputs, layers kept queued, the window's rate is the metric)
  or `closed` (one client: each unit is a request, issued when the last
  one's output is on the host, the latencies are the metric);
* `pool`: the second operand of unit u is pool ciphertext slot(u), with
  `pool` slots of `batch` ciphertexts encrypted in set-up;
* `period`: units after which the drawn order repeats;
* `keep_rows` (chained): rows of each layer whose operands and outputs are
  kept for the comparison with the reference;
* `check_sample`: rows the reference recomputes after the window;
* `trace_units`: units the traced run profiles.

Every seed gives the same sizes and the same amount of work; only the
plaintexts, the order of the pool and the kept rows change.
"""

from __future__ import annotations

import dataclasses
import types

import torch

LOOPS = ("chained", "closed")


@dataclasses.dataclass
class Traffic:
    loop: str
    batch: int
    unit: types.ModuleType
    first: torch.Tensor  # [batch]: the first unit's first operand
    pool: torch.Tensor  # [pool, batch]
    slots: list  # pool slot of unit u % period
    rows: torch.Tensor  # int64[period, keep_rows]: rows kept of unit u

    def slot(self, u: int) -> int:
        return self.slots[u % len(self.slots)]

    def expected(self, units: int) -> torch.Tensor:
        """[units, batch]: the plaintext of every unit's output, the unit's
        function of the previous output and the pool's plaintexts."""
        out, x = [], self.first
        for u in range(units):
            x = self.unit.apply(x, self.pool[self.slot(u)])
            out.append(x)
        return torch.stack(out) if out else self.first.new_empty(
            (0, self.batch))


def make_traffic(w: dict, seed: int, unit: types.ModuleType) -> Traffic:
    if w["loop"] not in LOOPS:
        raise ValueError(f"workload: loop {w['loop']!r}")
    gen = torch.Generator().manual_seed(seed)
    batch, period = w["batch"], w["period"]
    first = unit.draw(gen, (batch,))
    pool = unit.draw(gen, (w["pool"], batch))
    slots = torch.randint(0, w["pool"], (period,), generator=gen).tolist()
    keep = min(w.get("keep_rows", batch), batch)
    rows = torch.randint(0, batch, (period, keep), generator=gen)
    return Traffic(w["loop"], batch, unit, first, pool, slots, rows)
