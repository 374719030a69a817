"""Weak scaling of batched NAND: gates/s against the number of devices.

    python -m tfhe_tpu_torch.tools.scaling_bench [per_device_batch]
    python -m tfhe_tpu_torch.tools.scaling_bench --virtual-devices 2
    python -m tfhe_tpu_torch.tools.scaling_bench --device cpu

The twin of the reference's `tools/scaling_bench.py`. For d = 1, 2, 4, 8,
16, 32 up to the device count, one sharded NAND layer
(`parallel/mesh.py:make_gate_nand_sharded`) at mesh (d, 1) and batch
per_device_batch * d (default 64 a device): the launcher makes the key
once (`tfhe_parameters_128` on the card, toy on the CPU, as a seeded cloud
key in the wire format) and the inputs of each size, then starts d ranks
of this module (`parallel/dryrun.py:launch`). Each rank expands the key on
its device, runs the layer once untimed and once timed, and rank 0
decrypts the gathered outputs (every one must be right). A size's rate is
its batch over the slowest rank's timed call. Prints one line a size,
then the reference's JSON line: metric, per_device_batch, rates and
efficiency_at_max (the largest size's rate over d times the 1-device
rate).

The device count is `torch.cuda.device_count()` on the card, one rank a
card over NCCL. `--virtual-devices N` stands for XLA's virtual CPU
devices (`--xla_force_host_platform_device_count`), which the reference's
note names: N ranks over gloo, which share the device where there is one
(the CPU, or a single card). Ranks that share one device share its cores
or its SMs, so an efficiency figure from them is not a scaling figure;
they prove the code path end to end, and the tool is meant for several
cards.

With TFHE_NPROC set (and TFHE_COORD, TFHE_PID, as
`parallel/multihost.py:initialize` reads them) the process is one rank of
a world started outside, one process a card across hosts. A mesh spans
the whole world (`mesh.make_mesh`), so such a world runs its own size
only, d = the world size; rank 0 makes the key and inputs and sends them
to the others in the wire format, and prints the lines (efficiency_at_max
is null when d = 1 was not run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from .. import api
from .. import params as presets
from ..utils.entry import add_device_argument, entry_device, log

SEED = 123
SIZES = (1, 2, 4, 8, 16, 32)


def params_for(device_type: str):
    return presets.tfhe_parameters_toy() if device_type == "cpu" \
        else presets.tfhe_parameters_128()


def make_inputs(dev: torch.device, sk, batch: int) -> dict:
    """A size's inputs: x = (i % 2 == 0), y = ~x at `batch`."""
    gen = torch.Generator(device=dev).manual_seed(SEED + batch)
    bits = torch.arange(batch, device=dev) % 2 == 0
    return {"x": api.encrypt(gen, sk, bits), "y": api.encrypt(gen, sk, ~bits)}


def file_names(world: int) -> dict:
    """The files a size's ranks load: the key and the secret key once for
    every size, the inputs by size."""
    return {"key": "key.bin", "secret": "secret.bin", "x": f"x{world}.bin",
            "y": f"y{world}.bin"}


def make_key(dev: torch.device):
    """(secret key, seeded cloud key) from SEED."""
    from ..compressed import make_seeded_cloud_key

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk = api.make_secret_key(gen, params_for(dev.type))
    return sk, make_seeded_cloud_key(gen, sk)


def run_size(r, objs: dict, world: int) -> dict:
    """This rank's part of one size: the sharded layer once untimed, once
    timed; rank 0 also decrypts the gathered outputs."""
    from ..compressed import expand_cloud_key
    from ..parallel.dryrun import _gather
    from ..parallel.mesh import (make_gate_nand_sharded, make_mesh,
                                 shard_batch, shard_cloud_key)

    ck = expand_cloud_key(objs["key"])
    x, y = objs["x"], objs["y"]
    mesh = make_mesh(world, 1, devices=r.device.type)
    ck_sh = shard_cloud_key(ck, mesh)
    nand = make_gate_nand_sharded(mesh, ck.params)
    xs, ys = shard_batch(x, mesh), shard_batch(y, mesh)
    nand(ck_sh, xs, ys)
    t0 = r.start()
    out = nand(ck_sh, xs, ys)
    res = r.read(t0)
    whole = _gather(out, mesh.get_group("data"))
    batch = x.b.shape[0]
    res.update(rank=r.rank, devices=world, batch=batch)
    if r.rank == 0:
        bits = torch.arange(batch, device=r.device) % 2 == 0
        got = api.decrypt(objs["secret"], whole)
        res["correct"] = int((got == ~(bits & ~bits)).sum())
    return res


def rank_main(args) -> int:
    """One rank: of a size the launcher started (`--files`), or of a
    world started outside."""
    import torch.distributed as dist

    from ..parallel.dryrun import Rank
    from ..parallel.multihost import initialize
    from ..utils import serialization as ser

    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize(backend=args.backend)
    world = dist.get_world_size()
    r = Rank(dist.get_rank(), args.device)
    if args.files:
        objs = {name: ser.load(os.path.join(args.files, file), r.device)
                for name, file in file_names(world).items()}
    else:
        blobs = [None]
        if r.rank == 0:
            sk, key = make_key(r.device)
            made = {"key": key, "secret": sk,
                    **make_inputs(r.device, sk, args.per_device * world)}
            blobs = [{name: ser.dumps(obj) for name, obj in made.items()}]
        dist.broadcast_object_list(blobs, src=0)
        objs = {name: ser.loads(blob, r.device)
                for name, blob in blobs[0].items()}
    res = run_size(r, objs, world)
    if args.files:
        print(json.dumps(res), flush=True)
    else:
        results = [None] * world
        dist.all_gather_object(results, res)
        if r.rank == 0:
            rates = {}
            size_line(rates, results)
            json_line(args.per_device, rates)
    dist.destroy_process_group()
    return 0


def size_line(rates: dict, ranks: list) -> None:
    """Add a size's rate (its batch over the slowest rank's timed call) to
    `rates` and print its line; raises on a wrong output."""
    head = next(x for x in ranks if x["rank"] == 0)
    d, batch = head["devices"], head["batch"]
    rates[d] = batch / max(x["seconds"] for x in ranks)
    eff = f"{100 * rates[d] / (rates[1] * d):5.1f}%" if 1 in rates else "n/a"
    print(f"devices={d:2d} batch={batch:5d}: {rates[d]:9.1f} gates/s "
          f"(efficiency {eff})", flush=True)
    if head["correct"] != batch:
        raise RuntimeError(f"devices={d}: {head['correct']}/{batch} outputs "
                           f"correct")


def json_line(per_device: int, rates: dict) -> None:
    top = max(rates)
    print(json.dumps({
        "metric": "scaling_efficiency",
        "per_device_batch": per_device,
        "rates": {str(d): r for d, r in rates.items()},
        "efficiency_at_max": (rates[top] / (rates[1] * top)
                              if 1 in rates else None),
    }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("per_device", nargs="?", type=int, default=64,
                    metavar="per_device_batch")
    ap.add_argument("--virtual-devices", type=int, default=None,
                    help="N ranks sharing one device over gloo stand for N "
                         "devices (XLA's virtual CPU devices); not a "
                         "scaling figure")
    add_device_argument(ap)
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--files", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    if "TFHE_NPROC" in os.environ:
        return rank_main(args)
    return launch_sizes(args, dev)


def launch_sizes(args, dev: torch.device) -> int:
    from ..parallel.dryrun import TIMEOUT_S, launch
    from ..utils import serialization as ser

    if args.virtual_devices:
        count, backend = args.virtual_devices, "gloo"
        log(f"{count} ranks share {dev.type}: the rates prove the path; "
            f"an efficiency from them is not a scaling figure")
    elif dev.type == "cuda":
        count, backend = torch.cuda.device_count(), "nccl"
    else:
        count, backend = 1, "gloo"
    sizes = [d for d in SIZES if d <= count]
    with tempfile.TemporaryDirectory(prefix="tfhe_scaling_") as tmp:
        sk, key = make_key(dev)
        ser.save(key, os.path.join(tmp, "key.bin"))
        ser.save(sk, os.path.join(tmp, "secret.bin"))
        for d in sizes:
            for name, obj in make_inputs(dev, sk, args.per_device * d).items():
                ser.save(obj, os.path.join(tmp, file_names(d)[name]))
        del sk, key
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the ranks share this card
        rates = {}
        for d in sizes:
            t0 = time.perf_counter()
            ranks = launch(["--device", dev.type, "--backend", backend,
                            "--files", tmp, str(args.per_device)], d,
                           TIMEOUT_S,
                           module="tfhe_tpu_torch.tools.scaling_bench")
            log(f"devices={d}: {time.perf_counter() - t0:.1f} s with "
                f"start-up")
            for r in ranks:
                log(f"devices={d} rank {r['rank']} kernel launches: "
                    f"{r['launches']}")
            size_line(rates, ranks)
    json_line(args.per_device, rates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
