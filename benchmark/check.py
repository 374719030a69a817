"""The comparison that decides `correct`.

During the window a `Recorder` keeps, from what the timed path produced,
the operands and outputs of the kept rows of every layer (chained loop)
or every request's output on the host (closed loop), and the decryption
of every output. A row is what the cell's unit of work
(`benchmark/units/<gate>.py`) runs on one input: a gate's bit, a radix
word's digits; its words are its ciphertexts' `a` and `b`. After the
window, with the program's state freed, `judge` takes the first unit's
kept rows and a sample of the others drawn from the seed, and has the
reference recompute each, through the unit, from its operands and the
raw key material. A unit's operands are the outputs of the unit before
it, so the reference follows the program layer by layer; the first unit
starts from the benchmark's own encryptions, and the decryption of every
output against the plaintext chain checks the chain as a whole. Two
numbers are compared, each with its limit:

* `mismatched_gates`: sampled rows whose output words differ from the
  reference's anywhere. The arithmetic is exact mod 2^32, so the limit
  is 0.
* `wrong_decryptions`: outputs, of every row in the run, that do not
  decrypt to the unit's function of their operands' plaintexts. The
  configuration states its failure rate (`guarantees`), far below one in
  the rows of any run, so the limit is 0.
"""

from __future__ import annotations

import torch

from . import inputs
from .reference.tfhe import reference_for

LIMITS = {"mismatched_gates": 0, "wrong_decryptions": 0}
BLOCK_ROWS = 256


class Recorder:
    """What the window keeps of the timed path's outputs. Nothing it keeps
    grows on the card as the window runs: the kept rows of the first
    `period` layers go to a buffer on the host (pinned, copied without a
    synchronise), and the wrong decryptions add up in one counter on the
    card, beside the expected plaintexts of the current layer."""

    def __init__(self, p: dict, keys: dict, traffic, x0, pool):
        self.p, self.keys, self.traffic = p, keys, traffic
        self.unit = traffic.unit
        self.x0, self.pool = x0, pool  # the benchmark's own words (a, b)
        dev = x0[0].device
        # a row's words: its a, then its b
        self.row = tuple(x0[1].shape[1:])
        self.row_a = x0[0][0].numel()
        self.words = self.row_a + x0[1][0].numel()
        # the traffic's tables on the device before the window: no copy
        # from the host in it
        self.rows = traffic.rows.to(dev)
        self.pool_plain = traffic.pool.to(dev)
        if traffic.loop == "chained":
            period, keep = self.rows.shape
            self.kept = torch.empty((period, 2, keep, self.words),
                                    dtype=torch.int32,
                                    pin_memory=dev.type == "cuda")
        self.reset()

    def reset(self):
        """Forget the units kept so far (after the warm unit)."""
        self.expect = self.traffic.first.to(self.pool_plain.device)
        self.wrong = torch.zeros((), dtype=torch.int64,
                                 device=self.pool_plain.device)
        self.host = []  # closed: int32[batch, words] per request, on host
        self.units = 0

    def keep_layer(self, u: int, x, out):
        if u < self.kept.shape[0]:
            rows = self.rows[u]
            for i, (a, b) in enumerate((x, out)):
                words = torch.cat([a.index_select(0, rows).reshape(
                    rows.numel(), -1), b.index_select(0, rows).reshape(
                        rows.numel(), -1)], 1)
                self.kept[u, i].copy_(words, non_blocking=True)
        self.expect = self.unit.apply(
            self.expect, self.pool_plain[self.traffic.slot(u)])
        got = self.unit.decrypt(inputs.phase(self.p, self.keys, *out))
        self.wrong += (got != self.expect).sum()
        self.units = u + 1

    def keep_request(self, u: int, host_words: torch.Tensor):
        self.host.append(host_words)
        self.units = u + 1

    def _pool_words(self, slots, rows) -> torch.Tensor:
        """int32[len(slots), words]: pool rows (slots[i], rows[i])."""
        dev = self.pool[0].device
        slots, rows = slots.to(dev), rows.to(dev)
        return torch.cat([self.pool[0][slots, rows].reshape(
            slots.numel(), -1), self.pool[1][slots, rows].reshape(
                slots.numel(), -1)], 1).cpu()

    def _gates(self):
        """Every kept row: x, y operands and the output, as words
        int32[rows, words] each."""
        if self.traffic.loop == "chained":
            units = min(self.units, self.kept.shape[0])
            kept = self.kept[:units]  # [units, 2, keep, words]
            keep = kept.shape[2]
            rows = self.traffic.rows[:units].reshape(-1)
            slots = torch.tensor([self.traffic.slot(u) for u in range(units)]
                                 ).repeat_interleave(keep)
            x = kept[:, 0].reshape(-1, self.words)
            out = kept[:, 1].reshape(-1, self.words)
        else:
            out = torch.stack(self.host)  # [units, batch, words]
            batch = out.shape[1]
            x0 = torch.cat([self.x0[0].reshape(batch, -1),
                            self.x0[1].reshape(batch, -1)], 1).cpu()
            x = torch.cat([x0[None], out[:-1]]).reshape(-1, self.words)
            out = out.reshape(-1, self.words)
            slots = torch.tensor([self.traffic.slot(u)
                                  for u in range(len(self.host))]
                                 ).repeat_interleave(batch)
            rows = torch.arange(batch).repeat(len(self.host))
        return x, self._pool_words(slots, rows), out

    def _split(self, words: torch.Tensor):
        """Rows of words -> (a [rows, *row, ...], b [rows, *row])."""
        a = words[:, :self.row_a].reshape(
            (-1,) + tuple(self.x0[0].shape[1:]))
        return a, words[:, self.row_a:].reshape((-1,) + self.row)

    def wrong_decryptions(self) -> int:
        if self.traffic.loop == "chained":
            return int(self.wrong)
        want = self.traffic.expected(self.units)
        _, _, out = self._gates()
        got = self.unit.decrypt(inputs.phase(
            self.p, {k: v.cpu() for k, v in self.keys.items()
                     if k in ("lwe_key", "lwe_keys")}, *self._split(out)))
        return int((got.reshape(want.shape) != want).sum())

    def judge(self, sample: int, seed: int, device, dtype=torch.float64):
        """The compared numbers, and how many rows the reference
        recomputed."""
        gates = self._gates()
        total = gates[0].shape[0]
        # the first unit's rows, whose operands are the benchmark's own
        # encryptions, always; the rest a sample drawn from the seed
        first = min(self.rows.shape[1], total)
        gen = torch.Generator().manual_seed(seed)
        rest = torch.randperm(total - first, generator=gen)[:sample - first]
        pick = torch.cat([torch.arange(first), first + rest])
        ref = reference_for(self.p, self.keys, dtype)
        bad = 0
        for i in range(0, pick.numel(), BLOCK_ROWS):
            idx = pick[i:i + BLOCK_ROWS]
            x, y, out = (t[idx].to(device) for t in gates)
            want = self.unit.reference(ref, *self._split(x), *self._split(y))
            got = self._split(out)
            diff = torch.zeros(idx.numel(), dtype=torch.bool, device=device)
            for w, g in zip(want, got):
                diff |= (w.reshape(idx.numel(), -1)
                         != g.reshape(idx.numel(), -1)).any(1)
            bad += int(diff.sum())
        return {"mismatched_gates": bad,
                "wrong_decryptions": self.wrong_decryptions()}, pick.numel()
