"""The port's blind rotation equals the reference's.

* `blind_rotate_plain` (through `bootstrap.blind_rotate`) against
  `tfhe_tpu.bootstrap.blind_rotate` on the CPU (the XLA path, which
  tests/test_pallas_cmux.py holds bit-equal to the Pallas kernels).
* An emulation of the CUDA kernel's table-driven arithmetic
  (`kernel_tables`, as csrc/blind_rotate.cu reads them) against
  `blind_rotate_plain`, at the plans the kernel must take.
* On a CUDA card only: the kernel itself against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import tlwe as j_tlwe
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import interop
from tfhe_tpu_torch.ops.blind_rotate import (
    blind_rotate_kernel,
    blind_rotate_plain,
    kernel_tables,
)
from tfhe_tpu_torch.ops.conv import i8_matmul
from tfhe_tpu_torch.ops.karatsuba import bake_karatsuba, karatsuba_plan
from tfhe_tpu_torch.tgsw import decomp_offset, prepare_tgsw

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n,l,b,t,depth,k1", [
    (64, 2, 8, 32, 1, 5),     # the 128_fast family: k=4, M=2, b=8
    (256, 3, 7, 128, 1, 2),   # toy geometry: T=128, M=2
    (256, 3, 7, 32, 2, 2),    # M=8 at depth 2
    (128, 2, 10, 32, 2, 2),   # the 80-bit gadget: b=10, two-limb digits
    (64, 2, 10, 32, 1, 2),    # b=10 at depth 1
])
def test_blind_rotate_matches_reference(n, l, b, t, depth, k1):
    rng = np.random.default_rng(n + depth)
    n_lwe, batch = 4, 3
    gsw = words(rng, (n_lwe, l, k1, k1, n))
    acc0 = words(rng, (batch, k1, n))
    bara = rng.integers(0, 2 * n, (batch, n_lwe)).astype(np.int32)
    bara[0, :] = 0  # a lane whose every step is the no-op
    cv = np.full((batch,), 1e-6, np.float32)

    bk_j = j_bs.bootstrap_key_from_raw(jnp.asarray(gsw), l, b, block=t,
                                       depth=depth, noise_stddev=2.0**-25,
                                       balanced=(b == 8))
    bk_p = p_bs.bootstrap_key_from_raw(torch.from_numpy(gsw), l, b, block=t,
                                       depth=depth, noise_stddev=2.0**-25,
                                       balanced=(b == 8))
    np.testing.assert_array_equal(bk_p.baked.numpy(), np.asarray(bk_j.baked))

    want = j_bs.blind_rotate(j_tlwe.TLweSample(jnp.asarray(acc0),
                                               jnp.asarray(cv)),
                             bk_j, jnp.asarray(bara))
    got = p_bs.blind_rotate(interop.tlwe_sample_from_numpy(acc0, cv), bk_p,
                            torch.from_numpy(bara))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv), rtol=1e-6)
    assert np.array_equal(got.a.numpy()[0], acc0[0])  # bara == 0: unchanged


def emulate_kernel(acc, e_all, bara_t, *, l, b, t, plan, balanced):
    """The CUDA kernel's arithmetic, step by step, from its tables."""
    bsz, k1, n = acc.shape
    m, pt = n // t, k1 * l * t
    combos, terms, term_start, lhs_rows = kernel_tables(plan, k1 * l, t)
    offset = decomp_offset(l, b, balanced)
    acc = acc.to(torch.int64)
    for s in range(e_all.shape[0]):
        sh = bara_t[s].to(torch.int64) & (2 * n - 1)
        src = (torch.arange(n)[None, :] - sh[:, None]) & (2 * n - 1)
        doubled = torch.cat([acc, -acc], dim=-1)
        rot = torch.gather(doubled, -1, src[:, None, :].expand(bsz, k1, n))
        shifted = (rot - acc + offset) & 0xFFFFFFFF
        lhs = torch.zeros((bsz, lhs_rows, pt), dtype=torch.int64)
        for j in range(k1):
            for il in range(l):
                d = ((shifted[:, j] >> (32 - (il + 1) * b))
                     & ((1 << b) - 1)) - (1 << (b - 1))
                for i in range(m):
                    seg = slice((j * l + il) * t, (j * l + il + 1) * t)
                    lhs[:, i, seg] = d[:, i * t:(i + 1) * t]
        for dst, mask, two, hi in combos:
            v = sum(lhs[:, blk] for blk in range(m) if mask >> blk & 1)
            if two:
                lo = ((v & 127) ^ 64) - 64
                lhs[:, dst], lhs[:, hi] = lo, (v - lo) // 128
            else:
                lhs[:, dst] = v
        if b > 8:  # the kernel holds wide raw digits in shared memory only
            assert all(lseg >= m for _, lseg, *_ in terms)
            lhs[:, :m] = 0
        assert lhs.min() >= -128 and lhs.max() <= 127
        lhs8 = lhs.to(torch.int8).reshape(bsz, lhs_rows * pt)
        for posm in range(m):
            total = torch.zeros((bsz, e_all.shape[-1]), dtype=torch.int64)
            for _, lseg, eseg, nseg, shift, sign in \
                    terms[term_start[posm]:term_start[posm + 1]]:
                prod = i8_matmul(lhs8[:, lseg * pt:(lseg + nseg) * pt],
                                 e_all[s, eseg * pt:(eseg + nseg) * pt])
                total += sign * (prod.to(torch.int64) << shift)
            total = total.reshape(bsz, k1, 4, t)
            word = sum(total[:, :, limb] << (8 * limb) for limb in range(4))
            acc[:, :, posm * t:(posm + 1) * t] += word
        acc = ((acc + 2**31) & 0xFFFFFFFF) - 2**31
    return acc.to(torch.int32)


@pytest.mark.parametrize("k1,n,l,b,depth", [
    (5, 256, 2, 8, 1),   # 128_fast
    (2, 256, 3, 7, 1),   # toy
    (2, 1024, 3, 7, 2),  # N=1024 at depth 2, 9 leaves
    (2, 1024, 2, 10, 2),  # the 80-bit shape: b=10, every leaf two limbs
    (9, 128, 2, 8, 0),   # 128_fast8: M=1, one leaf, one row, K=9
])
def test_kernel_tables_emulation_matches_plain(k1, n, l, b, depth):
    rng = np.random.default_rng(k1 * n)
    n_lwe, batch, t = 2, 3, 128
    gsw = torch.from_numpy(words(rng, (n_lwe, l, k1, k1, n)))
    # the operand the compact rotation expands: the plan's own bake, which
    # at depth 0 (M = 1) is not the dense key bootstrap_key_from_raw builds
    plan = karatsuba_plan(n // t, depth, b)
    baked = bake_karatsuba(prepare_tgsw(gsw, l, b), t, plan)
    acc = torch.from_numpy(words(rng, (batch, k1, n)))
    bara_t = torch.from_numpy(rng.integers(-n, n, (n_lwe, batch)).astype(np.int32))
    bara_t[:, 0] = 0
    kw = dict(l=l, b=b, t=t, plan=plan, balanced=(b == 8))
    want = blind_rotate_plain(acc, baked, bara_t, **kw)
    got = emulate_kernel(acc, baked, bara_t, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_refuses_cpu_tensors():
    gsw = torch.zeros((1, 3, 2, 2, 256), dtype=torch.int32)
    bk = p_bs.bootstrap_key_from_raw(gsw, 3, 7)
    acc = torch.zeros((2, 2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        blind_rotate_kernel(acc, bk.baked, torch.zeros((1, 2), dtype=torch.int32),
                            l=3, b=7, t=128, plan=bk.plan, balanced=False)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs a CUDA card and nvcc; chip_smoke.py runs the same comparison
    at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    rng = np.random.default_rng(11)
    for k1, n, l, b, n_lwe, batch in [(5, 256, 2, 8, 3, 300),
                                      (2, 256, 3, 7, 3, 17),
                                      (2, 1024, 2, 10, 2, 17)]:
        gsw = torch.from_numpy(words(rng, (n_lwe, l, k1, k1, n))).to(dev)
        bk = p_bs.bootstrap_key_from_raw(gsw, l, b)
        assert bk.depth >= 1
        acc = torch.from_numpy(words(rng, (batch, k1, n))).to(dev)
        bara_t = torch.from_numpy(
            rng.integers(-n, n, (n_lwe, batch)).astype(np.int32)).to(dev)
        kw = dict(l=l, b=b, t=bk.block, plan=bk.plan, balanced=(b == 8))
        got = blind_rotate_kernel(acc, bk.baked, bara_t, **kw)
        want = blind_rotate_plain(acc, bk.baked, bara_t, **kw)
        assert torch.equal(got, want)
