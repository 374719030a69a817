"""Smoke run of tfhe_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero, nothing falls back):

1. Device: the card's name and power limit from nvidia-smi.
2. Build: compile the CUDA kernel from csrc/ (seconds, ptxas report).
3. Kernel against plain: `blind_rotate_kernel` against `blind_rotate_plain`
   on the card, `torch.equal`, at the 128_fast shape (B = 256 and 300),
   the toy shape and N = 1024 at depth 2, with random accumulators, random
   baked keys and random bara including 0 and negatives; then both timed at
   the 128_fast shape at B = 4096.
4. Main path: `make_key_pair(tfhe_parameters_128_fast)` on the card,
   `encrypt` of 4096 bits, 5 chained `gate_nand` layers, `decrypt`;
   requires 4096/4096 correct and one kernel launch per layer, and the
   kernel's rotation equal to the plain version's on 64 real ciphertexts.
5. The kernels' JSON line, then the result line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SEED = 123
BATCH = 4096
LAYERS = 5  # the first NAND plus 4 chained ones, as bench.py runs them


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the current stream, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_case(gen, k1, n, l, b, depth, n_steps, batch):
    """Random accumulator, baked key and bara for one kernel shape."""
    from tfhe_tpu_torch.bootstrap import default_block
    from tfhe_tpu_torch.ops.karatsuba import karatsuba_plan

    t = default_block(n)
    plan = karatsuba_plan(n // t, depth, b)
    pt = k1 * l * t
    dev = gen.device
    acc = torch.randint(-(2**31), 2**31, (batch, k1, n), dtype=torch.int32,
                        generator=gen, device=dev)
    key = torch.randint(-128, 128, (n_steps, plan.total_rows * pt,
                                    k1 * 4 * t),
                        dtype=torch.int8, generator=gen, device=dev)
    bara_t = torch.randint(-n, n, (n_steps, batch), dtype=torch.int32,
                           generator=gen, device=dev)
    bara_t[:, 0] = 0
    bara_t[0, 1:] = 0
    return acc, key, bara_t, dict(l=l, b=b, t=t, plan=plan,
                                  balanced=(b == 8))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import tfhe_tpu_torch as tp
    from tfhe_tpu_torch.lwe import lwe_noiseless_trivial
    from tfhe_tpu_torch.numeric import decode_message, encode_message
    from tfhe_tpu_torch.ops import _build
    from tfhe_tpu_torch.ops.blind_rotate import (
        blind_rotate_kernel,
        blind_rotate_plain,
    )
    from tfhe_tpu_torch.tlwe import tlwe_noiseless_trivial
    from tfhe_tpu_torch.polynomial import mul_by_monomial

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             (lib_path.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] {build_s:.2f} s | " + " | ".join(ptxas), flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0
    shapes = [  # (name, k1, N, l, b, depth, n_steps, batch)
        ("128_fast", 5, 256, 2, 8, 1, 8, 256),
        ("128_fast", 5, 256, 2, 8, 1, 8, 300),
        ("toy", 2, 256, 3, 7, 1, 8, 64),
        ("N1024_depth2", 2, 1024, 3, 7, 2, 4, 64),
    ]
    for name, k1, n, l, b, depth, n_steps, batch in shapes:
        acc, key, bara_t, kw = random_case(gen, k1, n, l, b, depth, n_steps,
                                           batch)
        got = blind_rotate_kernel(acc, key, bara_t, **kw)
        want = blind_rotate_plain(acc, key, bara_t, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"kernel != plain at {name} B={batch} (max |diff| {err})")
        print(f"[3 kernel=plain] {name} K={k1} N={n} l={l} b={b} "
              f"depth={depth} steps={n_steps} B={batch}: equal", flush=True)

    acc, key, bara_t, kw = random_case(gen, 5, 256, 2, 8, 1, 8, BATCH)
    kernel_ms = cuda_ms(lambda: blind_rotate_kernel(acc, key, bara_t, **kw))
    plain_ms = cuda_ms(lambda: blind_rotate_plain(acc, key, bara_t, **kw))
    print(f"[3 timing] 128_fast B={BATCH}, 8 steps: kernel {kernel_ms:.3f} ms "
          f"({kernel_ms / 8:.3f} ms/step), plain {plain_ms:.3f} ms "
          f"({plain_ms / 8:.3f} ms/step) | {card}", flush=True)
    del acc, key, bara_t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tp.tfhe_parameters_128_fast()
    keygen_gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    sk, ck = tp.make_key_pair(keygen_gen, params)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    bk = ck.bootstrap_key
    check(tuple(bk.baked.shape) == (630, 3840, 2560) and bk.depth == 1,
          f"unexpected baked key {tuple(bk.baked.shape)} depth {bk.depth}")

    idx = torch.arange(BATCH, device=dev)
    bits_x, bits_y = idx % 2 == 0, idx % 3 == 0
    ct_x = tp.encrypt(keygen_gen, sk, bits_x)
    ct_y = tp.encrypt(keygen_gen, sk, bits_y)
    torch.cuda.synchronize()

    blind_rotate_kernel.launches = 0
    t0 = time.perf_counter()
    out = tp.gate_nand(ck, ct_x, ct_y)
    for _ in range(LAYERS - 1):
        out = tp.gate_nand(ck, out, ct_y)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    launches = blind_rotate_kernel.launches
    check(launches == LAYERS,
          f"{launches} kernel launches in {LAYERS} NAND layers")

    want = ~(bits_x & bits_y)
    for _ in range(LAYERS - 1):
        want = ~(want & bits_y)
    got = tp.decrypt(sk, out)
    correct = int((got == want).sum())
    check(out.a.shape == (BATCH, params.lwe_size) and out.b.shape == (BATCH,),
          "output shape")
    check(bool(torch.isfinite(out.cv).all()), "non-finite noise variance")
    check(correct == BATCH, f"{correct}/{BATCH} decrypt correctly")
    gates_per_s = BATCH * LAYERS / chain_s
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # The kernel's rotation on real ciphertexts against the plain version:
    # the accumulator of the first NAND layer's first 64 gates.
    small = 64
    mu = encode_message(1, 8)
    first = [tp.LweSample(*(f[:small] for f in ct)) for ct in (ct_x, ct_y)]
    x = lwe_noiseless_trivial(mu, params.lwe_size, (small,), dev) \
        - first[0] - first[1]
    bara_t = decode_message(x.a, 2 * params.N).t().contiguous()
    barb = decode_message(x.b, 2 * params.N)
    testv = torch.full((small, params.N), mu, dtype=torch.int32, device=dev)
    acc0 = tlwe_noiseless_trivial(mul_by_monomial(testv, -barb),
                                  params.k).a.contiguous()
    kw = dict(l=bk.decomp_length, b=bk.log2_base, t=bk.block, plan=bk.plan,
              balanced=bk.balanced)
    got_rot = blind_rotate_kernel(acc0, bk.baked, bara_t, **kw)
    want_rot = blind_rotate_plain(acc0, bk.baked, bara_t, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got_rot, want_rot),
          "kernel != plain on the real 128_fast key")

    print(f"[4 main path] 128_fast keygen {keygen_s:.2f} s | {LAYERS} NAND "
          f"layers x {BATCH} in {chain_s:.3f} s = {gates_per_s:.1f} gates/s | "
          f"{correct}/{BATCH} correct | kernel launches {launches} "
          f"(expected {LAYERS}) | peak {peak_gb:.2f} GB | real-key rotation "
          f"kernel=plain on {small} | {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "blind_rotate",
        "route": "cuda",
        "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
        "replaces": "tfhe_tpu/ops/pallas_cmux.py:645",
        "also_replaces": "tfhe_tpu/ops/pallas_cmux.py:1420",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
