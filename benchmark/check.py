"""The comparison that decides `correct`.

During the window a `Recorder` keeps, from what the timed path produced,
the operands and outputs of the kept rows of every gate layer (chained
loop) or every request's output on the host (closed loop), and the
decryption of every output. After the window, with the program's state
freed, `judge` takes the first unit's kept gates and a sample of the
others drawn from the seed, and has the reference recompute each from its
operands and the raw key material. A unit's operands are the outputs of
the unit before it, so the reference follows the program layer by layer;
the first unit starts from the benchmark's own encryptions, and the
decryption of every output against the plaintext chain checks the chain
as a whole. Two numbers are compared, each with its limit:

* `mismatched_gates`: sampled gates whose output words differ from the
  reference's anywhere. The arithmetic is exact mod 2^32, so the limit
  is 0.
* `wrong_decryptions`: outputs, of every gate in the run, that do not
  decrypt to the NAND of their operands' plaintexts. The configuration
  states its failure rate per gate (`guarantees`), far below one in the
  gates of any run, so the limit is 0.
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
    card, beside the expected bits of the current layer."""

    def __init__(self, p: dict, keys: dict, traffic, x0, pool):
        self.p, self.keys, self.traffic = p, keys, traffic
        self.x0, self.pool = x0, pool  # the benchmark's own words (a, b)
        dev = x0[0].device
        # the traffic's tables on the device before the window: no copy
        # from the host in it
        self.rows = traffic.rows.to(dev)
        self.pool_bits = traffic.pool_bits.to(dev)
        if traffic.loop == "chained":
            period, keep = self.rows.shape
            self.kept = torch.empty((period, 2, keep, x0[0][0].numel() + 1),
                                    dtype=torch.int32,
                                    pin_memory=dev.type == "cuda")
        self.reset()

    def reset(self):
        """Forget the units kept so far (after the warm unit)."""
        self.expect = self.traffic.first_bits.to(self.pool_bits.device)
        self.wrong = torch.zeros((), dtype=torch.int64,
                                 device=self.pool_bits.device)
        self.host = []  # closed: int32[words] per request, on the host
        self.units = 0

    def keep_layer(self, u: int, x, out):
        if u < self.kept.shape[0]:
            rows = self.rows[u]
            for i, (a, b) in enumerate((x, out)):
                words = torch.cat([a.index_select(0, rows).reshape(
                    rows.numel(), -1), b.index_select(0, rows)[:, None]], 1)
                self.kept[u, i].copy_(words, non_blocking=True)
        self.expect = ~(self.expect & self.pool_bits[self.traffic.slot(u)])
        got = inputs.phase_bits(self.p, self.keys, *out)
        self.wrong += (got != self.expect).sum()
        self.units = u + 1

    def keep_request(self, u: int, host_words: torch.Tensor):
        self.host.append(host_words)
        self.units = u + 1

    def _gates(self):
        """Every kept gate: x, y operands and the output, as words."""
        if self.traffic.loop == "chained":
            units = min(self.units, self.kept.shape[0])
            kept = self.kept[:units]  # [units, 2, keep, words]
            keep = kept.shape[2]
            rows = self.traffic.rows[:units].reshape(-1)
            slots = torch.tensor([self.traffic.slot(u) for u in range(units)]
                                 ).repeat_interleave(keep)
            x, out = kept[:, 0].reshape(-1, kept.shape[3]), \
                kept[:, 1].reshape(-1, kept.shape[3])
            dev = self.pool[0].device
            y_a = self.pool[0][slots.to(dev), rows.to(dev)].cpu()
            y_b = self.pool[1][slots.to(dev), rows.to(dev)].cpu()
        else:
            out = torch.stack(self.host)  # [units, words]
            x0 = torch.cat([self.x0[0].reshape(1, -1).cpu(),
                            self.x0[1].reshape(1, 1).cpu()], dim=1)
            x = torch.cat([x0, out[:-1]])
            slots = [self.traffic.slot(u) for u in range(len(self.host))]
            y_a = self.pool[0][slots, 0].reshape(len(slots), -1).cpu()
            y_b = self.pool[1][slots, 0].cpu()
        n_a = out.shape[1] - 1
        return (x[:, :n_a], x[:, n_a], y_a.reshape(len(y_b), -1), y_b,
                out[:, :n_a], out[:, n_a])

    def wrong_decryptions(self) -> int:
        if self.traffic.loop == "chained":
            return int(self.wrong)
        want = self.traffic.expected(self.units)
        _, _, _, _, out_a, out_b = self._gates()
        shape = self.x0[0].shape[1:]  # [n] or [parties, n]
        got = inputs.phase_bits(
            self.p, {k: v.cpu() for k, v in self.keys.items()
                     if k in ("lwe_key", "lwe_keys")},
            out_a.reshape((-1,) + tuple(shape)), out_b).reshape(-1, 1)
        return int((got != want).sum())

    def judge(self, sample: int, seed: int, device, dtype=torch.float64):
        """The compared numbers, and how many gates the reference
        recomputed."""
        gates = self._gates()
        total = gates[0].shape[0]
        # the first unit's gates, whose operands are the benchmark's own
        # encryptions, always; the rest a sample drawn from the seed
        first = min(self.rows.shape[1], total)
        gen = torch.Generator().manual_seed(seed)
        rest = torch.randperm(total - first, generator=gen)[:sample - first]
        pick = torch.cat([torch.arange(first), first + rest])
        ref = reference_for(self.p, self.keys, dtype)
        shape = tuple(self.x0[0].shape[1:])
        bad = 0
        for i in range(0, pick.numel(), BLOCK_ROWS):
            idx = pick[i:i + BLOCK_ROWS]
            x_a, x_b, y_a, y_b, out_a, out_b = (t[idx].to(device)
                                                for t in gates)
            want_a, want_b = ref.nand(x_a.reshape((-1,) + shape), x_b,
                                      y_a.reshape((-1,) + shape), y_b)
            diff = (want_a.reshape(idx.numel(), -1)
                    != out_a.reshape(idx.numel(), -1)).any(1) \
                | (want_b != out_b)
            bad += int(diff.sum())
        return {"mismatched_gates": bad,
                "wrong_decryptions": self.wrong_decryptions()}, pick.numel()
