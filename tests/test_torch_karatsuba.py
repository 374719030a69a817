"""The port's Karatsuba plan, bake, delta and kernel-plan lowering equal the
reference's (`tfhe_tpu/ops/karatsuba.py`, `pallas_cmux._kernel_plan`)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import conv as j_conv
from tfhe_tpu.ops import karatsuba as j_kar
from tfhe_tpu.ops.pallas_cmux import _kernel_plan
from tfhe_tpu_torch.ops import conv as p_conv
from tfhe_tpu_torch.ops import karatsuba as p_kar
from tfhe_tpu_torch.ops.blind_rotate import kernel_plan

torch.set_num_threads(2)


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("log2_base", [7, 8, 10])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_karatsuba_plan_fields(m, log2_base):
    for depth in range(4):
        ref = j_kar.karatsuba_plan(m, depth, log2_base)
        got = p_kar.karatsuba_plan(m, depth, log2_base)
        assert (got.m, got.depth, got.log2_base, got.total_rows) == \
            (ref.m, ref.depth, ref.log2_base, ref.total_rows)
        assert len(got.leaves) == len(ref.leaves)
        for lg, lr in zip(got.leaves, ref.leaves):
            assert dataclasses.asdict(lg) == dataclasses.asdict(lr)
        assert got.macs_superblocks == ref.macs_superblocks


@pytest.mark.parametrize("m,depth,log2_base,p", [
    (2, 1, 8, 10),   # 128_fast: the sum leaf needs two limbs
    (2, 1, 7, 6),    # toy: every leaf one limb
    (8, 2, 7, 6),    # N=1024 at depth 2
    (8, 3, 7, 6),
    (4, 2, 10, 4),
])
def test_kernel_plan_lowering(m, depth, log2_base, p):
    plan_j = j_kar.karatsuba_plan(m, depth, log2_base)
    plan_p = p_kar.karatsuba_plan(m, depth, log2_base)
    assert kernel_plan(plan_p, p, 128) == _kernel_plan(plan_j, p, 128)


@pytest.mark.parametrize("n,t,depth,log2_base", [
    (64, 32, 1, 8), (256, 32, 2, 7), (256, 128, 1, 7),
])
def test_bake_and_delta(n, t, depth, log2_base):
    rng = np.random.default_rng(n + depth)
    steps, p, k, b = 3, 4, 2, 5
    key = words(rng, (steps, p, k, n))
    key[0, 0, 0, :3] = -(2**31)
    half = 1 << (log2_base - 1)
    digits = rng.integers(-half, half, (b, p, n)).astype(np.int32)
    digits[0, 0, :4] = [-half, half - 1, -half, half - 1]

    plan_j = j_kar.karatsuba_plan(n // t, depth, log2_base)
    plan_p = p_kar.karatsuba_plan(n // t, depth, log2_base)
    e_j = j_kar.bake_karatsuba(j_conv.prepare_shared_torus(jnp.asarray(key)),
                               t, plan_j)
    e_p = p_kar.bake_karatsuba(
        p_conv.prepare_shared_torus(torch.from_numpy(key)), t, plan_p, chunk=2)
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_j))

    want = j_kar.karatsuba_delta(jnp.asarray(digits), e_j[1], t, plan_j)
    got = p_kar.karatsuba_delta(torch.from_numpy(digits), e_p[1], t, plan_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
