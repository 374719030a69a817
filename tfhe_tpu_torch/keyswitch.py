"""LWE-to-LWE key switching as one int8 one-hot contraction.

Counterpart of `tfhe_tpu/keyswitch.py`. The digit table gets an explicit
zero row at digit 0, so the whole accumulation is one int8 matrix product
of the batched digit one-hots against a limb-split key table. The
reference runs this as a plain int8 dot outside any kernel; here it is
`torch._int_mm` (ops/conv.py:i8_matmul) on either device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .lwe import LweSample
from .noise import keyswitch_var
from .numeric import dtot32, rand_gaussian_float, rand_uniform_torus32
from .ops.conv import _round_up, i8_matmul, split_torus_limbs


@dataclasses.dataclass(frozen=True)
class KeyswitchKey:
    """Prepared keyswitch key.

    table_limbs: int8[l*base*n_in, 4*cols_p], the (j, h, i) row-ordered
    table of LWE samples Enc(s_in[i] * h * 2^(32-(j+1)*b)), a zero row at
    h=0, each int32 word split into 4 balanced limbs; cols_p = n_out+1
    rounded up to a multiple of 128.
    """

    table_limbs: torch.Tensor
    n_in: int
    n_out: int
    decomp_length: int
    log2_base: int
    noise_stddev: float = 0.0


def prepare_keyswitch_table(ks_a: torch.Tensor, ks_b: torch.Tensor,
                            n_out: int) -> torch.Tensor:
    """Pack ks_a: int32[base-1, l, n_in, n_out] and ks_b: int32[base-1, l,
    n_in] into the matmul operand described on KeyswitchKey."""
    bm1, l, n_in, _ = ks_a.shape
    cols = n_out + 1
    cols_p = _round_up(cols, 128)
    tbl = torch.cat([ks_a, ks_b.unsqueeze(-1)], dim=-1)  # [base-1, l, n_in, cols]
    tbl = F.pad(tbl, (0, cols_p - cols, 0, 0, 0, 0, 1, 0))  # zero h=0 row
    tbl = tbl.permute(1, 0, 2, 3).reshape(l * (bm1 + 1) * n_in, cols_p)
    limbs = split_torus_limbs(tbl)  # [4, rows, cols_p]
    return limbs.permute(1, 0, 2).reshape(-1, 4 * cols_p).contiguous()


def keyswitch_key_core(in_key: torch.Tensor, out_key: torch.Tensor,
                       a_uniform: torch.Tensor, noise_t32: torch.Tensor,
                       decomp_length: int, log2_base: int,
                       noise_stddev: float = 0.0) -> KeyswitchKey:
    """Keyswitch keygen with injected randomness.

    in_key: int32[n_in]; out_key: int32[n_out]; a_uniform: int32[base-1, l,
    n_in, n_out]; noise_t32: int32[base-1, l, n_in].
    ks[h, j, i] = Enc(s_in[i] * (h+1) * 2^(32-(j+1)*b)).
    """
    base = 1 << log2_base
    dev = in_key.device
    h = torch.arange(1, base, dtype=torch.int32, device=dev)
    shifts = 32 - torch.arange(1, decomp_length + 1, dtype=torch.int32,
                               device=dev) * log2_base
    message = (in_key[None, None, :] * h[:, None, None]) << shifts[None, :, None]
    b = message + noise_t32
    b = b + torch.sum(a_uniform * out_key, dim=-1, dtype=torch.int32)
    return KeyswitchKey(
        prepare_keyswitch_table(a_uniform, b, out_key.shape[0]),
        in_key.shape[0], out_key.shape[0], decomp_length, log2_base,
        noise_stddev)


def keyswitch_key_gen(generator: torch.Generator, alpha: float,
                      in_key: torch.Tensor, out_key: torch.Tensor,
                      decomp_length: int, log2_base: int) -> KeyswitchKey:
    """Fresh keyswitch key: N(0, alpha^2) noise of shape (n_in, l, base-1),
    recentred to zero mean, then truncated to the torus."""
    base = 1 << log2_base
    n_in, n_out = in_key.shape[0], out_key.shape[0]
    noise = rand_gaussian_float(generator, alpha,
                                (n_in, decomp_length, base - 1))
    noise = noise - noise.mean()
    a = rand_uniform_torus32(generator, (base - 1, decomp_length, n_in, n_out))
    return keyswitch_key_core(in_key, out_key, a,
                              dtot32(noise.permute(2, 1, 0)),
                              decomp_length, log2_base, noise_stddev=alpha)


def keyswitch_digits(a: torch.Tensor, decomp_length: int,
                     log2_base: int) -> torch.Tensor:
    """Round a[..., n_in] to l*b bits and cut unsigned digits
    [..., l, n_in] in [0, base)."""
    prec_offset = 1 << (32 - (1 + log2_base * decomp_length))
    mask = (1 << log2_base) - 1
    aibar = a.to(torch.int32) + prec_offset
    shifts = torch.tensor(
        [32 - (j + 1) * log2_base for j in range(decomp_length)],
        dtype=torch.int32, device=a.device)
    return (aibar.unsqueeze(-2) >> shifts[:, None]) & mask


def keyswitch_onehot(a: torch.Tensor, decomp_length: int,
                     log2_base: int) -> torch.Tensor:
    """One-hot digit operand int8[..., l*base*n_in] in the table's (j, h, i)
    row order."""
    base = 1 << log2_base
    digits = keyswitch_digits(a, decomp_length, log2_base)  # [..., l, n_in]
    levels = torch.arange(base, dtype=torch.int32, device=a.device)
    onehot = (digits.unsqueeze(-2) == levels[:, None]).to(torch.int8)
    return onehot.reshape(onehot.shape[:-3] + (-1,))


def keyswitch(ks: KeyswitchKey, sample: LweSample) -> LweSample:
    """Switch a batch of n_in-dim samples to the out-key's n_out-dim space:
    (0, b) - sum_{i,j} ks[digit_ij, j, i], as one int8 contraction."""
    l, b = ks.decomp_length, ks.log2_base
    base = 1 << b
    cols_p = ks.table_limbs.shape[-1] // 4
    batch_shape = sample.b.shape

    onehot = keyswitch_onehot(sample.a, l, b).reshape(-1, l * base * ks.n_in)
    prods = i8_matmul(onehot, ks.table_limbs).reshape(-1, 4, cols_p)
    acc = prods[:, 0].clone()
    for limb in range(1, 4):
        acc += prods[:, limb] << (8 * limb)
    acc = acc.reshape(batch_shape + (cols_p,))

    a_out = -acc[..., :ks.n_out]
    b_out = sample.b - acc[..., ks.n_out]
    cv = sample.cv + keyswitch_var(ks.n_in, l, b, ks.noise_stddev)
    return LweSample(a_out, b_out, cv)
