"""Restartable encrypted batch job: a ripple-adder netlist with checkpoints.

    python -m tfhe_tpu_torch.tools.batch_job [--bits 8] [--batch 64]
        [--every 2] [--ckpt PATH] [--preempt-after N] [--params toy|80]
        [--device cpu]

The twin of the reference's `tools/batch_job.py`, on
`utils.jobs.run_checkpointed`: a checkpoint after every `--every`
scheduled batches. Kill it at any point, or pass `--preempt-after N` to
exit (code 17) after N checkpoints of a run that started afresh, then run
it again with the same arguments: it resumes at the last checkpoint
("resuming at batch i/n"), runs to the end, and the final sums decrypt
correctly. A resumed run is not preempted again (the reference compares
N with the batches done, so its rerun with the same arguments is
preempted at its first checkpoint). The last line reads
"done in S s: C/B sums correct"; the exit code is 1 if a sum is wrong.
The checkpoint defaults to tfhe_job.ckpt in the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .. import api, circuits, netlist
from .. import params as presets
from ..lwe import LweSample
from ..utils import jobs
from ..utils.entry import add_device_argument, device_name, entry_device

PREEMPTED = 17


def ripple_sum(bits: int):
    """The ripple-carry sum netlist: (circuit, a wires, b wires, sum wires)."""
    circ = netlist.Circuit()
    a_w = circ.inputs(bits)
    b_w = circ.inputs(bits)
    carry, sum_w = None, []
    for i in range(bits):
        axb = circ.xor(a_w[i], b_w[i])
        if carry is None:
            sum_w.append(axb)
            carry = circ.and_(a_w[i], b_w[i])
        else:
            sum_w.append(circ.xor(axb, carry))
            if i + 1 < bits:
                carry = circ.mux(axb, carry, a_w[i])
    return circ, a_w, b_w, sum_w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "tfhe_job.ckpt"))
    ap.add_argument("--preempt-after", type=int, default=0)
    ap.add_argument("--params", default="toy", choices=["toy", "80"])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = entry_device(args.device)

    params = (presets.tfhe_parameters_toy() if args.params == "toy"
              else presets.tfhe_parameters_80())
    gen = torch.Generator(device=dev).manual_seed(123)
    sk, ck = api.make_key_pair(gen, params)

    circ, a_w, b_w, sum_w = ripple_sum(args.bits)
    sched = circ.compile(outputs=sum_w)

    rng = np.random.default_rng(7)
    mod = 1 << args.bits
    a_vals = torch.as_tensor(rng.integers(0, mod, args.batch), device=dev)
    b_vals = torch.as_tensor(rng.integers(0, mod, args.batch), device=dev)
    ct_a = circuits.encrypt_word(gen, sk, a_vals, args.bits)
    ct_b = circuits.encrypt_word(gen, sk, b_vals, args.bits)
    inputs = {}
    for i in range(args.bits):
        inputs[a_w[i]] = LweSample(ct_a.a[:, i], ct_a.b[:, i], ct_a.cv[:, i])
        inputs[b_w[i]] = LweSample(ct_b.a[:, i], ct_b.b[:, i], ct_b.cv[:, i])

    batch_shape = (args.batch,)
    resumed = jobs.load_checkpoint(
        args.ckpt, jobs.job_fingerprint(sched, params, batch_shape), dev)
    if resumed is not None:
        print(f"resuming at batch {resumed[0]}/{sched.n_batches} on "
              f"{device_name(dev)}", flush=True)
    else:
        print(f"starting {sched.n_batches} batches on {device_name(dev)}",
              flush=True)
    preempt_after = 0 if resumed is not None else args.preempt_after
    t0 = time.perf_counter()
    written = 0

    def report(done, total):
        nonlocal written
        written += 1
        print(f"checkpoint: {done}/{total} batches "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if preempt_after and written >= preempt_after:
            print("simulated preemption: exiting (rerun to resume)",
                  flush=True)
            os._exit(PREEMPTED)

    state = jobs.run_checkpointed(
        sched, ck, inputs, args.ckpt, batch_shape=batch_shape,
        every=args.every, on_chunk=report)

    bits = torch.stack([api.decrypt(sk, sched.wire(state, w)) for w in sum_w],
                       dim=-1)
    got = circuits.bits_to_int(bits)
    ok = int((got == (a_vals + b_vals) % mod).sum())
    print(f"done in {time.perf_counter() - t0:.1f}s: {ok}/{args.batch} sums "
          f"correct", flush=True)
    return 0 if ok == args.batch else 1


if __name__ == "__main__":
    raise SystemExit(main())
