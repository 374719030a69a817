"""Multi-rank dry run of the sharded paths: the port's `dryrun_multichip`.

    python -m tfhe_tpu_torch.parallel.dryrun --device cpu --backend gloo \\
        --data 2 --model 2
    python -m tfhe_tpu_torch.parallel.dryrun --device cuda --backend nccl \\
        --data 1 --model 1 --plan plan.json

Without `--rank` this is the launcher: it starts data*model rank
processes of itself (`multihost.initialize` through TFHE_COORD, a
`file://` store in a temporary directory, TFHE_NPROC and TFHE_PID), waits
for them with a time limit, and prints each rank's one JSON line. It fails
(exit 1) when any rank exits non-zero, prints no result line, or the time
limit passes; the other ranks are then killed.

Without `--plan` it runs one sharded NAND layer of the toy preset at mesh
(data, model): the launcher makes the key and the inputs from a seed and
writes them in the wire format (`utils/serialization.py`), so every rank
loads the same words. A plan is a JSON list of cases that name their key
and input files; cases may use other meshes of the same world. Each case
runs the sharded function on every rank (its kernels on a card), the
unsharded one on the same inputs (on rank 0, or per rank for the
rotation), and reports: bit equality, decrypt-correct counts, kernel
launches on this rank, collective calls and staged bytes, peak device
memory, seconds. Case kinds:

* nand, pbs: `make_gate_nand_sharded` / `make_pbs_sharded` on `key` (a
  CloudKey, or a seeded one that is expanded on load) and `x` (`y`);
  rank 0 compares with `gates.gate_nand` / `pbs.programmable_bootstrap`
  and decrypts with `secret`;
* mk_nand: `shard_mk_cloud_key` then `mk_gate_nand` on each rank's shard,
  against the unsharded `mk_gate_nand` (rank 0, before sharding); `secret`
  holds the parties' secret keys;
* radix_add: `radix_add` on each rank's words (data-parallel), against the
  whole batch's on rank 0;
* rotate: `make_blind_rotate_model_sharded` on `shard_bootstrap_key_model`
  of `key`; each rank compares its data rows with `bootstrap.blind_rotate`
  on the whole key; inputs from `inputs` (acc, bara) or built from the
  NAND inputs `x`, `y` (then extracted, keyswitched and decrypted);
* wrap: the int32 all-reduce over `model` of partials near +-2^31;
* roundtrip: `multihost.host_local_batch_to_global` and back.

`--out DIR` makes rank 0 write each case's whole output there
(`<name>.bin`, the wire format), for the tests that compare with the
reference. `tuning` in a case is applied (`tuning.override`) around its
key's load and its run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from .. import instrument
from ..ops import kernel_wrappers, reset_launches

SEED = 123
TIMEOUT_S = 600  # the command line's limit on its ranks


# --- the launcher ---


def launch(argv: list, world: int, timeout: float,
           module: str = "tfhe_tpu_torch.parallel.dryrun") -> list:
    """Start `world` ranks of `module` (this one by default) with `argv`
    (plus `--rank i`), wait at most `timeout` seconds, and return each
    rank's result dict: the last line of its stdout that starts with "{".
    Raises RuntimeError on a rank that fails or a time limit that
    passes, after killing every rank still running."""
    with tempfile.TemporaryDirectory(prefix="tfhe_dryrun_") as tmp:
        env = dict(os.environ, TFHE_COORD=f"file://{tmp}/store",
                   TFHE_NPROC=str(world))
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        procs, logs = [], []
        for rank in range(world):
            out = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--rank", str(rank)],
                env=dict(env, TFHE_PID=str(rank)), stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dry run: ranks still running after "
                               f"{timeout:.0f} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results, failed = [], []
        for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
            out.seek(0)
            err.seek(0)
            text, errors = out.read(), err.read()
            out.close()
            err.close()
            lines = [ln for ln in text.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                failed.append(f"rank {rank} exited {p.returncode}:\n"
                              f"{(text + errors)[-3000:]}")
                continue
            results.append(json.loads(lines[-1]))
    if failed:
        raise RuntimeError("dry run failed:\n" + "\n".join(failed))
    return results


def default_plan(tmp: str, device: str, data: int, model: int,
                 batch: int | None = None) -> list:
    """Toy key and NAND inputs x = (i % 2 == 0), y = ~x from SEED (batch
    default: 4 a rank), written to `tmp`; one NAND case at mesh (data,
    model)."""
    import tfhe_tpu_torch as tp
    from tfhe_tpu_torch.utils import serialization as ser

    batch = batch or 4 * data * model
    gen = torch.Generator(device=device).manual_seed(SEED)
    sk, ck = tp.make_key_pair(gen, tp.tfhe_parameters_toy())
    bits = torch.arange(batch, device=device) % 2 == 0
    files = {"key": ck, "secret": sk, "x": tp.encrypt(gen, sk, bits),
             "y": tp.encrypt(gen, sk, ~bits)}
    case = {"kind": "nand", "name": "nand", "mesh": [data, model]}
    for name, obj in files.items():
        case[name] = os.path.join(tmp, f"{name}.bin")
        ser.save(obj, case[name])
    return [case]


# --- one rank ---


class Rank:
    """This process's place in the world and what a case measures."""

    def __init__(self, rank: int, device: str):
        self.rank = rank
        self.device = torch.device(device, torch.cuda.current_device()) \
            if device == "cuda" else torch.device("cpu")
        self.wrappers = kernel_wrappers()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def start(self):
        """Zero the launch counters, the collective counters and the peak
        memory; returns the clock."""
        from .mesh import traffic

        reset_launches()
        traffic.reset()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.sync()
        return time.perf_counter()

    def read(self, t0) -> dict:
        """Seconds since `start`, and what ran on this rank meanwhile."""
        from .mesh import traffic

        self.sync()
        seconds = time.perf_counter() - t0
        return {
            "seconds": seconds,
            "launches": instrument.counts(self.wrappers),
            "collectives": traffic.calls,
            "staged_bytes": traffic.staged_bytes,
            "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                           if self.device.type == "cuda" else None),
        }

    def load(self, path: str):
        """A key or a sample from the wire format, on this rank's device;
        a seeded cloud key is expanded."""
        from .. import compressed
        from ..utils import serialization as ser

        obj = ser.load(path, self.device)
        if isinstance(obj, compressed.SeededCloudKey):
            obj = compressed.expand_cloud_key(obj)
        return obj


def _gather(x, group):
    """Whole batch of a sample (or tensor) whose local rows are this
    rank's, rows ordered by `group` rank."""
    from .mesh import _local, all_gather_rows

    if isinstance(x, tuple):
        return type(x)(*(_gather(f, group) for f in x))
    return all_gather_rows(_local(x), group)


def _equal(got, want) -> bool:
    if isinstance(got, tuple):
        return all(_equal(g, w) for g, w in zip(got, want))
    return torch.equal(got.cpu(), want.cpu())


def _words_equal(got, want) -> bool:
    """The ciphertext words a and b; the sharded keyswitch leaves cv as
    the reference's does (mesh.py's docstring), so cv is reported apart."""
    return _equal(got.a, want.a) and _equal(got.b, want.b)


def _rows(x, n):
    return type(x)(*(f[:n] for f in x))


def run_case(r: Rank, case: dict, out_dir: str | None) -> dict:
    """Run one case on this rank; returns its result dict."""
    import torch.distributed as dist

    from .. import tuning
    from .mesh import make_mesh

    mesh = make_mesh(*case["mesh"], devices=r.device.type)
    with tuning.override(**case.get("tuning", {})):
        res, whole = _CASES[case["kind"]](r, case, mesh)
    res.update(name=case["name"], kind=case["kind"], mesh=case["mesh"])
    if out_dir and r.rank == 0 and whole is not None:
        from ..utils import serialization as ser

        ser.save(whole, os.path.join(out_dir, case["name"] + ".bin"))
    del whole
    if r.device.type == "cuda":
        torch.cuda.empty_cache()  # the ranks may share one card
    dist.barrier()
    return res


def _single_key(r: Rank, case, mesh, kind):
    from .. import gates, pbs
    from .mesh import (make_gate_nand_sharded, make_pbs_sharded,
                       shard_batch, shard_cloud_key)

    ck = r.load(case["key"])
    x = r.load(case["x"])
    if kind == "nand":
        y = r.load(case["y"])
        fn = make_gate_nand_sharded(mesh, ck.params)
        args = (shard_batch(x, mesh), shard_batch(y, mesh))

        def unsharded():
            return gates.gate_nand(ck, x, y)
    else:
        space, table = case["space"], case["table"]
        lut = torch.tensor(table, dtype=torch.int32, device=r.device)
        fn = make_pbs_sharded(mesh, ck.params, space)
        args = (lut, shard_batch(x, mesh))

        def unsharded():
            return pbs.programmable_bootstrap(ck.bootstrap_key,
                                              ck.keyswitch_key, lut, x, space)
    want = unsharded() if r.rank == 0 else None
    ck_sh = shard_cloud_key(ck, mesh)
    # `repeat` > 1: the fastest of that many sharded calls, and on rank 0
    # the fastest of as many unsharded ones, in turns
    repeat = case.get("repeat", 1)
    res, plain_s = None, []
    for _ in range(repeat):
        t0 = r.start()
        out = fn(ck_sh, *args)
        run = r.read(t0)
        if res is None or run["seconds"] < res["seconds"]:
            res = run
        if r.rank == 0 and repeat > 1:
            r.sync()
            t0 = time.perf_counter()
            unsharded()
            r.sync()
            plain_s.append(time.perf_counter() - t0)
    whole = _gather(out, mesh.get_group("data"))
    if r.rank == 0:
        if plain_s:
            res["unsharded_seconds"] = min(plain_s)
        res["equal"] = _words_equal(whole, want)
        res["cv_equal"] = _equal(whole.cv, want.cv)
        sk = r.load(case["secret"])
        if kind == "nand":
            from ..api import decrypt

            truth = ~(decrypt(sk, x) & decrypt(sk, y))
            got = decrypt(sk, whole)
        else:
            msgs = pbs.decrypt_pbs(sk, x, space)
            truth = lut[msgs % space]
            got = pbs.decrypt_pbs(sk, whole, space)
        res["correct"] = int((got == truth).sum())
        res["of"] = int(truth.numel())
    res["key_bytes"] = _nbytes(ck_sh.keyswitch_key.table_limbs)
    return res, whole


def _nbytes(x) -> int:
    from .mesh import _local

    x = _local(x)
    return x.numel() * x.element_size()


def _mk_nand(r: Rank, case, mesh):
    import torch.distributed as dist

    from ..mk import mk_decrypt, mk_gate_nand
    from ..mk.internals import MKLweSample
    from .mesh import _local_sample, shard_mk_batch, shard_mk_cloud_key

    ck = r.load(case["key"])
    x, y = r.load(case["x"]), r.load(case["y"])
    want = mk_gate_nand(ck, x, y) if r.rank == 0 else None
    full_bytes = _nbytes(ck.bootstrap_key.limbs) if not \
        ck.bootstrap_key.sparse else sum(map(_nbytes, ck.bootstrap_key.limbs))
    ck_sh = shard_mk_cloud_key(ck, mesh)
    del ck
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    xl = _local_sample(shard_mk_batch(x, mesh))
    yl = _local_sample(shard_mk_batch(y, mesh))
    t0 = r.start()
    out = mk_gate_nand(ck_sh, xl, yl)
    res = r.read(t0)
    bk = ck_sh.bootstrap_key
    res["key_bytes"] = _nbytes(bk.limbs)
    res["full_key_bytes"] = full_bytes
    whole = MKLweSample(*_gather(out, dist.group.WORLD))
    if r.rank == 0:
        res["equal"] = _equal(whole, want)
        sks = r.load(case["secret"])
        truth = ~(mk_decrypt(sks, x) & mk_decrypt(sks, y))
        res["correct"] = int((mk_decrypt(sks, whole) == truth).sum())
        res["of"] = int(truth.numel())
    return res, whole


def _radix_add(r: Rank, case, mesh):
    import torch.distributed as dist

    from .. import radix
    from .mesh import _local_sample, shard_batch

    ck = r.load(case["key"])
    a, b = r.load(case["x"]), r.load(case["y"])
    want = radix.radix_add(ck, a, b) if r.rank == 0 else None
    al = _local_sample(shard_batch(a, mesh))
    bl = _local_sample(shard_batch(b, mesh))
    t0 = r.start()
    out = radix.radix_add(ck, al, bl)
    res = r.read(t0)
    whole = _gather(out, dist.group.WORLD)
    if r.rank == 0:
        res["equal"] = _equal(whole, want)
        sk = r.load(case["secret"])
        mod = 1 << (radix.BITS_PER_DIGIT * a.b.shape[-1])
        truth = (radix.decrypt_radix(sk, a) + radix.decrypt_radix(sk, b)) \
            % mod
        res["correct"] = int((radix.decrypt_radix(sk, whole) == truth).sum())
        res["of"] = int(truth.numel())
    return res, whole


def _rotate_inputs(r: Rank, case, ck):
    """(acc int32[B, K, N], bara int32[B, n], NAND inputs or None)."""
    from ..lwe import lwe_noiseless_trivial
    from ..numeric import decode_message, encode_message
    from ..polynomial import mul_by_monomial
    from ..tlwe import tlwe_noiseless_trivial

    if "inputs" in case:
        acc, bara = r.load(case["inputs"])
        return acc, bara, None
    batch = case["batch"]
    x, y = _rows(r.load(case["x"]), batch), _rows(r.load(case["y"]), batch)
    params = ck.params
    mu = encode_message(1, 8)
    res = lwe_noiseless_trivial(mu, params.lwe_size, (batch,), r.device) \
        - x - y
    n2 = 2 * params.tlwe_polynomial_degree
    bara = decode_message(res.a, n2)
    barb = decode_message(res.b, n2)
    testv = torch.full((batch, params.tlwe_polynomial_degree), mu,
                       dtype=torch.int32, device=r.device)
    acc = tlwe_noiseless_trivial(mul_by_monomial(testv, -barb),
                                 params.tlwe_mask_size).a.contiguous()
    return acc, bara, (x, y)


def _rotate(r: Rank, case, mesh):
    from ..bootstrap import blind_rotate
    from ..keyswitch import keyswitch
    from ..tlwe import TLweSample, tlwe_extract_sample
    from .mesh import (_shard, make_blind_rotate_model_sharded,
                       shard_bootstrap_key_model)

    ck = r.load(case["key"])
    acc, bara, nand_inputs = _rotate_inputs(r, case, ck)
    acc_rows = _shard(acc, mesh, ("data",)).to_local()
    bara_rows = _shard(bara, mesh, ("data",)).to_local()
    t0 = r.start()
    zeros = torch.zeros(acc_rows.shape[0], dtype=torch.float32,
                        device=r.device)
    want = blind_rotate(TLweSample(acc_rows, zeros), ck.bootstrap_key,
                        bara_rows).a
    ref = r.read(t0)
    full_bytes = _nbytes(ck.bootstrap_key.baked)
    bk_sh = shard_bootstrap_key_model(ck.bootstrap_key, mesh)
    ks = ck.keyswitch_key
    del ck
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    rotate = make_blind_rotate_model_sharded(mesh)
    t0 = r.start()
    got = rotate(bk_sh, acc, bara)
    res = r.read(t0)
    local = got.to_local()
    res.update(equal=_equal(local, want), key_bytes=_nbytes(bk_sh.baked),
               full_key_bytes=full_bytes,
               reference_launches=ref["launches"],
               reference_seconds=ref["seconds"])
    group = mesh.get_group("data")
    if nand_inputs is None:
        return res, _gather(got, group)
    out = keyswitch(ks, tlwe_extract_sample(
        TLweSample(local, torch.zeros(local.shape[0], device=r.device))))
    whole = _gather(out, group)
    if r.rank == 0:
        from ..api import decrypt

        sk = r.load(case["secret"])
        x, y = nand_inputs
        truth = ~(decrypt(sk, x) & decrypt(sk, y))
        res["correct"] = int((decrypt(sk, whole) == truth).sum())
        res["of"] = int(truth.numel())
    return res, whole


def _wrap(r: Rank, case, mesh):
    """Partials near +-2^31 summed over `model`; the result must equal
    the sum mod 2^32 (two's complement), as `lax.psum` gives it."""
    import numpy as np

    from .mesh import AXES, all_reduce_sum

    m = mesh.get_local_rank("model")
    model = mesh.size(AXES.index("model"))
    parts = np.array([[2**31 - 1 - i, -(2**31) + i, 2**30 + i, -1 - i]
                      for i in range(model)], np.int64)
    x = torch.tensor(parts[m].astype(np.int32), device=r.device)
    got = all_reduce_sum(x, mesh.get_group("model"))
    want = parts.sum(axis=0).astype(np.uint32).view(np.int32)
    return {"equal": bool(np.array_equal(got.cpu().numpy(), want)),
            "sum": got.cpu().tolist(),
            "partials": parts.tolist()}, got.cpu()


def _roundtrip(r: Rank, case, mesh):
    """A per-rank block through host_local_batch_to_global and back, and
    redistributed to the data rows."""
    from .mesh import AXES, _rank_rows
    from .multihost import (global_mesh, global_to_host_local,
                            host_local_batch_to_global)

    mesh = global_mesh(*case["mesh"], devices=r.device.type)
    rows, n = 4, 3
    index, count = _rank_rows(mesh, (AXES,))
    full = torch.arange(rows * count * n, dtype=torch.int32,
                        device=r.device).reshape(rows * count, n)
    local = full[index * rows:(index + 1) * rows]
    g = host_local_batch_to_global(local, mesh, (AXES, None))
    back = global_to_host_local(g, mesh, (AXES, None))
    data = mesh.size(AXES.index("data"))
    d = mesh.get_local_rank("data")
    blk = rows * count // data
    by_data = global_to_host_local(g, mesh, ("data", None))
    return {"equal": bool(tuple(g.shape) == tuple(full.shape)
                          and torch.equal(back, local)
                          and torch.equal(by_data,
                                          full[d * blk:(d + 1) * blk]))}, None


_CASES = {
    "nand": lambda r, c, m: _single_key(r, c, m, "nand"),
    "pbs": lambda r, c, m: _single_key(r, c, m, "pbs"),
    "mk_nand": _mk_nand,
    "radix_add": _radix_add,
    "rotate": _rotate,
    "wrap": _wrap,
    "roundtrip": _roundtrip,
}


def rank_main(args) -> int:
    import torch.distributed as dist

    from .multihost import initialize

    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize(backend=args.backend)
    r = Rank(dist.get_rank(), args.device)
    with open(args.plan) as f:
        plan = json.load(f)
    results = [run_case(r, case, args.out) for case in plan]
    print(json.dumps({"rank": r.rank, "device": str(r.device),
                      "results": results}), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--plan", help="JSON list of cases (default: one toy "
                                   "NAND at (data, model))")
    ap.add_argument("--out", help="rank 0 writes each case's output here")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    world = args.data * args.model
    with tempfile.TemporaryDirectory(prefix="tfhe_plan_") as tmp:
        plan = args.plan
        if plan is None:
            plan = os.path.join(tmp, "plan.json")
            with open(plan, "w") as f:
                json.dump(default_plan(tmp, args.device, args.data,
                                       args.model), f)
        argv = ["--device", args.device, "--plan", plan]
        if args.backend:
            argv += ["--backend", args.backend]
        if args.out:
            argv += ["--out", args.out]
        results = launch(argv, world, TIMEOUT_S)
    ok = True
    for res in results:
        print(json.dumps(res))
        for case in res["results"]:
            ok &= case.get("equal", True) \
                and case.get("correct", 0) == case.get("of", 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
