"""Entry points of a compile check: one batched NAND on one card, and a
multi-rank dry run.

    python -m tfhe_tpu_torch.graft_entry --backend gloo   # one card
    python -m tfhe_tpu_torch.graft_entry                  # 8 cards, NCCL
    python -m tfhe_tpu_torch.graft_entry --device cpu

The twin of the reference's `__graft_entry__.py`. `entry()` returns a
batched bootstrapped-NAND step on the flagship configuration with key
material of the real shapes; `dryrun_multichip(n)` runs one sharded NAND
over n ranks. `python -m` runs `dryrun_multichip(8)` and then `entry()`,
as the reference's `__main__` does.

`_fake_cloud_key` departs from the reference in one place, the Karatsuba
depth. The reference clamps it to `bit_length(N/T) - 2`
(`__graft_entry__.py:39`) where keygen clamps to `bit_length(N/T) - 1`
(`tfhe_tpu/bootstrap.py:159`), so at N = 256 (M = 2: the toy and
128_fast presets) its fake key is the dense depth-0 bake (5,120 rows at
128_fast) and its compile check runs the dense step, not the main path's
kernel. Here the depth is keygen's (`bootstrap.bootstrap_key_from_raw`):
depth 1 and the Karatsuba bake (3,840 rows) at 128_fast, the shapes real
keygen gives, as the reference's docstring promises. The words do not
differ: with an all-zero key every external product is zero, whatever the
key's form, so the accumulator never changes.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from . import gates
from . import params as presets
from .api import CloudKey
from .bootstrap import BootstrapKey, default_block
from .keyswitch import KeyswitchKey
from .lwe import LweSample
from .ops.conv import _round_up
from .ops.karatsuba import karatsuba_plan
from .tuning import get_tuning
from .utils.entry import add_device_argument, barrier, entry_device, log


def fake_key_shapes(params, device_type: str) -> dict:
    """Shapes of the key material keygen makes for `params` on a device
    of this type, without allocating: the baked bootstrap key (K-major
    int8[n, K, 4, T, rows] on a card, int8[n, rows, K*4*T] on the CPU),
    its block and depth, and the keyswitch limbs int8[n_in*l*2^b,
    4*cols_p]."""
    n, N, k = params.lwe_size, params.tlwe_polynomial_degree, \
        params.tlwe_mask_size
    l, b = params.bs_decomp_length, params.bs_log2_base
    t = default_block(N)
    depth = min(get_tuning().karatsuba_depth, (N // t).bit_length() - 1)
    groups = karatsuba_plan(N // t, depth, b).total_rows if depth \
        else 2 * (N // t)
    rows = groups * (k + 1) * l * t
    baked = (n, k + 1, 4, t, rows) if device_type == "cuda" and t == 128 \
        else (n, rows, (k + 1) * 4 * t)
    cols_p = _round_up(n + 1, 128)  # keyswitch output columns: a (n), b (1)
    ks = (N * k * params.ks_decomp_length * (1 << params.ks_log2_base),
          4 * cols_p)
    return {"baked": baked, "block": t, "depth": depth, "keyswitch": ks}


def _fake_cloud_key(params, device: torch.device) -> CloudKey:
    """Zero-filled key material of the real shapes (compile and kernel
    checks only), allocated directly: no keygen, no relayout. Zeros are
    runtime inputs like any key, so the same kernels run."""
    shapes = fake_key_shapes(params, device.type)
    baked = torch.zeros(shapes["baked"], dtype=torch.int8, device=device)
    limbs = torch.zeros(shapes["keyswitch"], dtype=torch.int8, device=device)
    bk = BootstrapKey(baked, params.bs_decomp_length, params.bs_log2_base,
                      params.tlwe_polynomial_degree, params.tlwe_mask_size,
                      shapes["block"], shapes["depth"],
                      balanced=params.gadget_balanced)
    ks = KeyswitchKey(limbs, params.tlwe_polynomial_degree
                      * params.tlwe_mask_size, params.lwe_size,
                      params.ks_decomp_length, params.ks_log2_base)
    return CloudKey(params, bk, ks)


def entry(device: str = "cuda"):
    """(fn, (ck, x, y)): the batched bootstrapped NAND and its arguments.

    128_fast on the card (the bench's default preset), toy on the CPU (a
    baked production key is GBs); batch TFHE_ENTRY_BATCH (default 16);
    x and y uniform int32 words from generators seeded 1 and 2, cv zero.
    Exits with a message when `device` is "cuda" and there is no card."""
    dev = entry_device(device)
    params = presets.tfhe_parameters_128_fast() if dev.type == "cuda" \
        else presets.tfhe_parameters_toy()
    batch = int(os.environ.get("TFHE_ENTRY_BATCH", "16"))
    ck = _fake_cloud_key(params, dev)

    def make_ct(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        lo, hi = -(2**31), 2**31 - 1
        a = torch.randint(lo, hi, (batch, params.lwe_size), generator=gen,
                          dtype=torch.int32, device=dev)
        b = torch.randint(lo, hi, (batch,), generator=gen, dtype=torch.int32,
                          device=dev)
        return LweSample(a, b, torch.zeros(batch, device=dev))

    return gates.gate_nand, (ck, make_ct(1), make_ct(2))


def mesh_shape(n_devices: int) -> tuple:
    """("data", "model") = (n/2, 2) when n is even, else (n, 1)."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model, model


def rank_backend(dev: torch.device, n_ranks: int,
                 backend: str | None) -> str:
    """The backend the ranks join with: gloo on the CPU; on the card NCCL
    (one rank a card) unless the caller names gloo (ranks sharing the
    cards). Never chosen after a failure."""
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs a card; the CPU ranks use gloo")
        return "gloo"
    cards = torch.cuda.device_count()
    if backend in (None, "nccl") and n_ranks > cards:
        raise ValueError(f"{n_ranks} ranks over NCCL need {n_ranks} cards, "
                         f"and there are {cards}: pass backend 'gloo' for "
                         f"ranks sharing the cards")
    return backend or "nccl"


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None) -> None:
    """One sharded batched NAND over n ranks (`parallel/dryrun.py`).

    Mesh (n/2, 2) when possible (the data-parallel rotation, the
    all-gather regroup and the all-reduced row-blocked keyswitch), else
    (n, 1). The toy key and x = (i % 2 == 0), y = ~x at batch 2n are made
    here and handed to the ranks as files in the wire format; rank 0
    writes the output, which must decrypt to all-true."""
    from .api import decrypt
    from .parallel import dryrun
    from .utils import serialization as ser

    dev = entry_device(device)
    data, model = mesh_shape(n_devices)
    backend = rank_backend(dev, n_devices, backend)
    with tempfile.TemporaryDirectory(prefix="tfhe_graft_") as tmp:
        plan = dryrun.default_plan(tmp, dev.type, data, model,
                                   batch=2 * n_devices)
        plan_path = os.path.join(tmp, "plan.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        ranks = dryrun.launch(["--device", dev.type, "--backend", backend,
                               "--plan", plan_path, "--out", tmp], n_devices,
                              dryrun.TIMEOUT_S)
        sk = ser.load(plan[0]["secret"], dev)
        out = ser.load(os.path.join(tmp, plan[0]["name"] + ".bin"), dev)
    head = next(r for r in ranks if r["rank"] == 0)["results"][0]
    if not (head["equal"] and bool(decrypt(sk, out).all())):
        raise RuntimeError(f"sharded NAND(x, ~x) must decrypt to all-true "
                           f"and equal the unsharded gate: {head}")
    print(f"dryrun_multichip({n_devices}): mesh=({data},{model}) OK",
          flush=True)


def main(argv=None) -> int:
    from .ops import build_seconds, launches, reset_launches

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the dry run's ranks: nccl (one a card, the "
                         "default on a card) or gloo (ranks sharing them)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    dryrun_multichip(8, args.device, args.backend)

    fn, fn_args = entry(args.device)
    wrappers = reset_launches()
    out = fn(*fn_args)
    barrier(dev)
    log(f"entry() kernel launches: {launches(wrappers)}")
    log(f"entry() builds, host s: {build_seconds()}")
    print("entry(): compiled + ran, out batch", tuple(out.b.shape),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
