"""Radix-encoded integer arithmetic: one bootstrap per bit.

Counterpart of `tfhe_tpu/radix.py`. Words are split into base-4 digits (2
bits each) carried in the programmable-bootstrapping encoding (pbs.py) with
message space S = 8: a digit holds values 0..3, and the headroom up to 7
absorbs digit + digit + carry before the LUT bootstrap re-normalises. An add
of a w-bit word costs w/2 digit positions x 2 LUT evaluations: one blind
rotation per bit, or half of one with `tuning.radix_manylut` (both tables
from one rotation).

Layout: a radix word batch is one LweSample with batch dims
[..., n_digits], least-significant digit first. The digit loop is the carry
chain; the word batch is the rotation kernels' batch dimension.

Noise margin: the PBS input is digit + digit + carry, three bootstrap-fresh
samples, against the 1/(4S) = 1/32 decision margin. Run radix arithmetic on
`tfhe_parameters_128_radix` (model failure 7.9e-5 per 8-bit word) or on
`tfhe_parameters_128_radix_reliable` with `radix_manylut=False` (1.6e-10
per word).

Integers cross this module's edge as int64 tensors holding values mod 2^32
(torch has no full uint32 arithmetic); `decrypt_radix_signed` returns int32.
Tables and constants are created on the device of the ciphertexts.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import CloudKey, SecretKey
from .lwe import LweSample, lwe_noiseless_trivial
from .numeric import encode_message, input_device
from .pbs import (
    decrypt_pbs,
    encrypt_pbs,
    programmable_bootstrap,
    programmable_bootstrap_many,
)
from .tuning import get_tuning


def _use_many_lut() -> bool:
    """Evaluate same-input LUT pairs with one blind rotation (many-LUT,
    pbs.py) instead of a stacked two-rotation call. Costs a q = 2 coarser
    modulus switch. `tuning.radix_manylut = False` takes the stacked path."""
    return get_tuning().radix_manylut


BITS_PER_DIGIT = 2
DIGIT_BASE = 1 << BITS_PER_DIGIT  # 4
SPACE = 2 * DIGIT_BASE  # 8: one carry bit of headroom inside the padded half


def _words64(values, device=None) -> torch.Tensor:
    """Integers of any signedness as int64 values mod 2^32, placed as
    `numeric.input_device` says."""
    device = input_device(values, device)
    if not isinstance(values, torch.Tensor):
        values = np.asarray(values).astype(np.int64)
    return torch.as_tensor(values, device=device).to(torch.int64) & 0xFFFFFFFF


def int_to_digits(values, n_digits: int, device=None) -> torch.Tensor:
    """int[...] -> int32[..., n_digits] base-4 digits, LSB first, on
    `device`, or else the device of a tensor `values`, or else the card."""
    values = _words64(values, device)
    shifts = torch.arange(n_digits, device=values.device) * BITS_PER_DIGIT
    return ((values[..., None] >> shifts) & (DIGIT_BASE - 1)).to(torch.int32)


def digits_to_int(digits: torch.Tensor) -> torch.Tensor:
    """int32[..., n_digits] -> int64[...] holding the word mod 2^32
    (wrap-exact for words up to 16 digits, the full torus word width)."""
    digits = _words64(digits)
    shifts = torch.arange(digits.shape[-1],
                          device=digits.device) * BITS_PER_DIGIT
    return torch.sum(digits << shifts, dim=-1) & 0xFFFFFFFF


def encrypt_radix(generator: torch.Generator, key: SecretKey, values,
                  bits: int) -> LweSample:
    """Encrypt int[...] as [..., bits/2] base-4 PBS digits."""
    assert bits % BITS_PER_DIGIT == 0
    digits = int_to_digits(values, bits // BITS_PER_DIGIT, generator.device)
    return encrypt_pbs(generator, key, digits, SPACE)


def decrypt_radix(key: SecretKey, word: LweSample) -> torch.Tensor:
    """Decrypt a radix word batch back to int64[...] values mod 2^32."""
    digits = decrypt_pbs(key, word, SPACE)
    # maximum-likelihood decode: clean digits are in [0, 4); folding mod 4
    # maps a noise-corrupted digit to some wrong value (never an exception)
    return digits_to_int(digits % DIGIT_BASE)


def _digit(word: LweSample, i: int) -> LweSample:
    return LweSample(word.a[..., i, :], word.b[..., i], word.cv[..., i])


def _stack_digits(digit_list) -> LweSample:
    return LweSample(
        torch.stack([d.a for d in digit_list], dim=-2),
        torch.stack([d.b for d in digit_list], dim=-1),
        torch.stack([d.cv for d in digit_list], dim=-1),
    )


def _second_to_last(x: LweSample, i: int) -> LweSample:
    """Entry i of the batch axis before the digit axis."""
    return LweSample(x.a[..., i, :, :], x.b[..., i, :], x.cv[..., i, :])


def _dup(x: LweSample, a_dim: int) -> LweSample:
    """Stack two copies of x on a new batch axis, at `a_dim` of a (and one
    position later in b and cv)."""
    return LweSample(torch.stack([x.a, x.a], dim=a_dim),
                     torch.stack([x.b, x.b], dim=a_dim + 1),
                     torch.stack([x.cv, x.cv], dim=a_dim + 1))


def _trivial_digit(value: int, like: LweSample) -> LweSample:
    """Noiseless digit constant shaped like one digit slice of a word, on
    its device."""
    return lwe_noiseless_trivial(
        encode_message(int(value), 2 * SPACE), like.a.shape[-1],
        tuple(like.b.shape), like.a.device)


def _table(rows, like: LweSample) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int32, device=like.a.device)


def _pbs(ck: CloudKey, table, x: LweSample) -> LweSample:
    return programmable_bootstrap(ck.bootstrap_key, ck.keyswitch_key, table,
                                  x, SPACE)


# Per-position LUTs over the s = digit+digit+carry range [0, 8): the
# renormalised digit and the outgoing carry, evaluated together as one
# PBS call with a stacked per-sample table axis.
_SUM_CARRY_TABLES = [
    [s % DIGIT_BASE for s in range(SPACE)],  # sum digit
    [s // DIGIT_BASE for s in range(SPACE)],  # carry out (0/1)
]


def _add_chain(ck: CloudKey, a: LweSample, b: LweSample,
               carry: LweSample):
    """Shared ripple core: per digit, s = a_i + b_i + carry, then one PBS
    batch evaluating (s mod 4, s div 4). Returns (word, carry_out)."""
    d = a.b.shape[-1]
    tables = _table(_SUM_CARRY_TABLES, a)  # [2, S]
    many = _use_many_lut()
    out = []
    for i in range(d):
        s = _digit(a, i) + _digit(b, i) + carry
        if many:  # sum and carry from one rotation
            res = programmable_bootstrap_many(
                ck.bootstrap_key, ck.keyswitch_key, tables, s, SPACE, 2)
        else:
            res = _pbs(ck, tables, _dup(s, -2))
        out.append(_digit(res, 0))
        carry = _digit(res, 1)
    return _stack_digits(out), carry


def radix_add(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """a + b mod 4^d over radix words: one blind rotation per bit."""
    return _add_chain(ck, a, b, _trivial_digit(0, _digit(a, 0)))[0]


def radix_scalar_add(ck: CloudKey, a: LweSample, scalar: int) -> LweSample:
    """a + plaintext scalar (mod 4^d), same carry chain."""
    d = a.b.shape[-1]
    b = _stack_digits([
        _trivial_digit((int(scalar) >> (BITS_PER_DIGIT * i)) & (DIGIT_BASE - 1),
                       _digit(a, 0))
        for i in range(d)
    ])
    return radix_add(ck, a, b)


def _complement(b: LweSample) -> LweSample:
    """Digit-wise 3 - b_i: exact affine (negation plus a trivial constant)."""
    return _trivial_digit(DIGIT_BASE - 1, b) - b


def radix_sub(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """a - b mod 4^d via a + complement(b) + 1 (borrow-free two's complement)."""
    return _add_chain(ck, a, _complement(b),
                      _trivial_digit(1, _digit(a, 0)))[0]


def radix_geq(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted [a >= b] as a 0/1 radix digit: the subtraction chain's
    carry-out, at no extra cost beyond the subtract."""
    return _add_chain(ck, a, _complement(b),
                      _trivial_digit(1, _digit(a, 0)))[1]


def _scaled_flag(ck: CloudKey, flag: LweSample) -> LweSample:
    """Re-encode a 0/1 flag digit as {0, 4} with one LUT rotation.

    Scaling by 4 inside the LUT instead of multiplying the LWE sample by 4
    keeps the flag's noise at one fresh-bootstrap sigma; a scalar multiply
    would amplify it 4x past the 1/32 margin."""
    lut = [(DIGIT_BASE if s == 1 else 0) for s in range(SPACE)]
    return _pbs(ck, _table(lut, flag), flag)


# Bivariate select LUTs over u = digit + flag4 in [0, 8): the top half of
# the window is "flag set". Evaluated as one stacked-table PBS per digit.
_PICK_TABLES = [
    [u - DIGIT_BASE if u >= DIGIT_BASE else 0 for u in range(SPACE)],  # f*d
    [0 if u >= DIGIT_BASE else u for u in range(SPACE)],  # (1-f)*d
]


def radix_select(ck: CloudKey, flag4: LweSample, a: LweSample,
                 b: LweSample) -> LweSample:
    """Digit-wise flag4 ? a : b for a {0,4}-encoded flag (cf. _scaled_flag).

    Per digit: f*a_i + (1-f)*b_i via two bivariate LUTs on digit+flag4 (no
    ciphertext-by-scalar products, so each output digit is the sum of two
    bootstrap-fresh samples)."""
    d = a.b.shape[-1]
    tables = _table(_PICK_TABLES, a)
    out = []
    for i in range(d):
        res = _pbs(ck, tables, _stack_digits([_digit(a, i) + flag4,
                                              _digit(b, i) + flag4]))
        out.append(_digit(res, 0) + _digit(res, 1))
    return _stack_digits(out)


def radix_min(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted minimum: [a >= b] selects b. About 2 rotations per bit."""
    flag4 = _scaled_flag(ck, radix_geq(ck, a, b))
    return radix_select(ck, flag4, b, a)


def radix_max(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted maximum: [a >= b] selects a."""
    flag4 = _scaled_flag(ck, radix_geq(ck, a, b))
    return radix_select(ck, flag4, a, b)


# Bit-extraction LUTs: a clean digit's two bits, pre-scaled to the {0, 4}
# flag encoding (so they can gate bivariate selects without a noisy
# scalar multiply). Entries for u >= 4 never occur on clean digits.
_BIT_FLAG_TABLES = [
    [DIGIT_BASE * ((u % DIGIT_BASE) & 1) for u in range(SPACE)],
    [DIGIT_BASE * ((u % DIGIT_BASE) >> 1) for u in range(SPACE)],
]

# Gated doubling LUTs over u = digit + flag4: the low/high digits of
# 2*digit when the flag is set, zero otherwise ((2*3)=6 spans two digits).
_DOUBLE_TABLES = [
    [(2 * (u - DIGIT_BASE)) % DIGIT_BASE if u >= DIGIT_BASE else 0
     for u in range(SPACE)],
    [(2 * (u - DIGIT_BASE)) // DIGIT_BASE if u >= DIGIT_BASE else 0
     for u in range(SPACE)],
]


def _word_plus_flag(word: LweSample, flag4: LweSample) -> LweSample:
    """Broadcast-add one flag sample onto every digit of a word."""
    return LweSample(
        word.a + flag4.a[..., None, :],
        word.b + flag4.b[..., None],
        word.cv + flag4.cv[..., None],
    )


def _low_digits(word: LweSample, count: int) -> LweSample:
    return LweSample(word.a[..., :count, :], word.b[..., :count],
                     word.cv[..., :count])


def _pad_low(word: LweSample, t: int, d: int) -> LweSample:
    """Shift a word up by t digit positions (pad t trivial zeros at the
    bottom), truncating to d digits."""
    if t == 0:
        return word
    zero = lwe_noiseless_trivial(0, word.a.shape[-1],
                                 tuple(word.b.shape[:-1]) + (t,),
                                 word.a.device)
    return LweSample(
        torch.cat([zero.a, word.a], dim=-2)[..., :d, :],
        torch.cat([zero.b, word.b], dim=-1)[..., :d],
        torch.cat([zero.cv, word.cv], dim=-1)[..., :d],
    )


def radix_mul(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """x * y mod 4^d over radix words.

    Schoolbook over the bits of y: each bit is extracted as a {0, 4} flag
    (one stacked-table PBS per y digit), each partial product is a
    flag-gated select/double of x's digits (one stacked-table PBS per
    (bit, digit) diagonal), and the partials are summed with the radix
    carry chain.
    """
    d = x.b.shape[-1]
    bit_tables = _table(_BIT_FLAG_TABLES, x)
    pick_high = _table(_PICK_TABLES[0], x)
    dbl_tables = _table(_DOUBLE_TABLES, x)[:, None, :]  # [2, 1, S]

    # bits of y as flag4 samples, LSB first
    flags = []
    for i in range(d):
        res = _pbs(ck, bit_tables, _dup(_digit(y, i), -2))
        flags.append(_digit(res, 0))
        flags.append(_digit(res, 1))

    partials = []
    for j, f in enumerate(flags):
        t, odd = divmod(j, 2)
        if d - t <= 0:
            break
        src = _word_plus_flag(_low_digits(x, d - t), f)
        if not odd:
            partials.append(_pad_low(_pbs(ck, pick_high, src), t, d))
        else:
            res = _pbs(ck, dbl_tables, _dup(src, -3))
            lo, hi = _second_to_last(res, 0), _second_to_last(res, 1)
            partials.append(_pad_low(lo, t, d))
            if t + 1 < d:
                partials.append(_pad_low(_low_digits(hi, d - t - 1),
                                         t + 1, d))
    acc = partials[0]
    for p in partials[1:]:
        acc = radix_add(ck, acc, p)
    return acc


# Unconditional doubling LUTs: low/high digits of 2*digit (6 = 2*3 spans
# two digit positions). Mirrored across the unused top window half.
_DBL_LO = [(2 * (u % DIGIT_BASE)) % DIGIT_BASE for u in range(SPACE)]
_DBL_HI = [(2 * (u % DIGIT_BASE)) // DIGIT_BASE for u in range(SPACE)]

# Unscaled bit extraction (0/1 outputs, usable as a carry-in digit).
_BIT_TABLES = [
    [(u % DIGIT_BASE) & 1 for u in range(SPACE)],
    [(u % DIGIT_BASE) >> 1 for u in range(SPACE)],
]


def radix_divide(ck: CloudKey, num: LweSample, den: LweSample):
    """Unsigned restoring division: returns (quotient, remainder).

    Bit-serial over the numerator (MSB first): r <- 2r + n_bit, then a
    trial subtract r - den whose carry-out is the quotient bit and selects
    the restored or updated remainder. The doubling and the trial subtract
    both ride the radix carry chain. Division by zero returns quotient
    all-ones and remainder num, like the bit-level `circuits.divide`.
    """
    d = num.b.shape[-1]
    bit_tables = _table(_BIT_TABLES, num)[:, None, :]  # [2, 1, S]
    dbl_tables = _table([_DBL_LO, _DBL_HI], num)[:, None, :]
    ident = _table([u % DIGIT_BASE for u in range(SPACE)], num)

    # numerator bits as 0/1 digits, one stacked PBS over the digit axis
    res = _pbs(ck, bit_tables, _dup(num, -3))
    n_bits = []  # LSB first
    for i in range(d):
        n_bits.append(_digit(_second_to_last(res, 0), i))
        n_bits.append(_digit(_second_to_last(res, 1), i))

    zero = _trivial_digit(0, _digit(num, 0))
    r = _stack_digits([zero] * d)
    neg_den = _complement(den)
    one = _trivial_digit(1, zero)
    q_bits = []
    for i in reversed(range(2 * d)):
        # r <- 2r + n_bit_i: doubling LUTs + one carry chain with the bit
        # as carry-in (lo digits are even, so lo + hi<<1 + bit <= 7)
        dbl = _pbs(ck, dbl_tables, _dup(r, -3))
        lo, hi = _second_to_last(dbl, 0), _second_to_last(dbl, 1)
        r2 = _add_chain(ck, lo, _pad_low(_low_digits(hi, d - 1), 1, d),
                        n_bits[i])[0]
        # trial subtract: carry-out is the quotient bit, diff the candidate
        diff, geq = _add_chain(ck, r2, neg_den, one)
        q_bits.append(geq)
        r = radix_select(ck, _scaled_flag(ck, geq), diff, r2)

    # assemble quotient bits (MSB-first collected) into clean digits
    q_bits = q_bits[::-1]  # LSB first
    q_digits = [_pbs(ck, ident, q_bits[2 * i] + q_bits[2 * i + 1] * 2)
                for i in range(d)]
    return _stack_digits(q_digits), r


def radix_eq(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted [a == b] as a 0/1 radix digit.

    Per digit, a_i - b_i == 0 is read off the difference digit with an
    is-zero LUT; the indicator digits are then summed (at most 7 per group
    fits the S = 8 headroom) and collapsed with an is-d LUT, log-tree style
    for wide words.
    """
    d = a.b.shape[-1]
    diff = radix_sub(ck, a, b)
    is_zero = _table([1 if s == 0 else 0 for s in range(SPACE)], a)
    flags = _pbs(ck, is_zero, diff)
    flag_list = [_digit(flags, i) for i in range(d)]
    while len(flag_list) > 1:
        groups = [flag_list[i:i + 7] for i in range(0, len(flag_list), 7)]
        next_flags = []
        for g in groups:
            total = g[0]
            for f in g[1:]:
                total = total + f
            if len(g) == 1:
                next_flags.append(total)
                continue
            is_all = _table([1 if s == len(g) else 0 for s in range(SPACE)],
                            a)
            next_flags.append(_pbs(ck, is_all, total))
        flag_list = next_flags
    return flag_list[0]


# --- Bitwise logic and plaintext shifts on radix words ---
#
# Bitwise ops are digit-local (no carry chain), so every digit of the word
# rides one batched PBS: stage 1 extracts b's two bits scaled into the
# selector position (4*bit, the _scaled_flag trick), stage 2 evaluates the
# 1-bit x 2-bit bivariate LUT t = a + 4*bit_b for the lo and hi output bits
# together. Outputs are sums of two bootstrap-fresh samples.


_EXTRACT_BITS4 = [
    [4 * ((v % DIGIT_BASE) & 1) for v in range(SPACE)],   # 4 * lo bit
    [4 * ((v % DIGIT_BASE) >> 1) for v in range(SPACE)],  # 4 * hi bit
]


def _bitwise(ck: CloudKey, a: LweSample, b: LweSample, op) -> LweSample:
    """Digit-wise bitwise combination out = op(a, b) bit by bit."""
    extract = _table(_EXTRACT_BITS4, a)  # [2, S]
    # t = a_digit + 4*b_bit in [0, 8): t%4 recovers a, t//4 the b bit.
    lo_tbl = [int(op((t % DIGIT_BASE) & 1, t // DIGIT_BASE))
              for t in range(SPACE)]
    hi_tbl = [2 * int(op((t % DIGIT_BASE) >> 1, t // DIGIT_BASE))
              for t in range(SPACE)]
    combine = _table([lo_tbl, hi_tbl], a)  # [2, S]
    if _use_many_lut():  # both of b's bits from one rotation per digit
        sel = programmable_bootstrap_many(
            ck.bootstrap_key, ck.keyswitch_key, extract, b, SPACE, 2)
    else:
        sel = _pbs(ck, extract, _dup(b, -2))
    res = _pbs(ck, combine, _dup(a, -2) + sel)
    return _digit(res, 0) + _digit(res, 1)


def radix_and(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Bitwise a & b over radix words."""
    return _bitwise(ck, a, b, lambda x, y: x & y)


def radix_or(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Bitwise a | b over radix words."""
    return _bitwise(ck, a, b, lambda x, y: x | y)


def radix_xor(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Bitwise a ^ b over radix words."""
    return _bitwise(ck, a, b, lambda x, y: x ^ y)


def radix_not(b: LweSample) -> LweSample:
    """Bitwise complement: 3 - digit flips both bits; exact affine, free."""
    return _complement(b)


def _shift_digits(a: LweSample, ds: int) -> LweSample:
    """Shift whole digits (left for ds > 0), zero-filling: free relabeling."""
    d = a.b.shape[-1]
    zero = _trivial_digit(0, _digit(a, 0))
    if ds >= 0:
        src = [zero] * min(ds, d) + [_digit(a, i) for i in range(d - ds)]
    else:
        src = [_digit(a, i) for i in range(-ds, d)] + [zero] * min(-ds, d)
    return _stack_digits(src[:d])


def _one_table_per_digit(ck: CloudKey, row, a: LweSample) -> LweSample:
    """One [1, S] table over a word given a trailing batch axis of 1."""
    res = _pbs(ck, _table([row], a),
               LweSample(a.a[..., None, :], a.b[..., None], a.cv[..., None]))
    return _digit(res, 0)


_HALVE_COMBINE = [((t % DIGIT_BASE) >> 1) + 2 * (t // DIGIT_BASE)
                  for t in range(SPACE)]


def radix_shift_left(ck: CloudKey, a: LweSample, k: int) -> LweSample:
    """Logical left shift by plaintext k bits (mod 4^d).

    Even shifts are free digit relabeling; an odd shift adds one bit-carry
    pass: out_i = 2*(a_i & 1) + hi(a_{i-1}) via the same extract +
    bivariate-combine PBS pair as the bitwise ops.
    """
    assert k >= 0
    d = a.b.shape[-1]
    a = _shift_digits(a, k // BITS_PER_DIGIT)
    if k % BITS_PER_DIGIT == 0 or k >= d * BITS_PER_DIGIT:
        return a
    h = _one_table_per_digit(ck, _EXTRACT_BITS4[1], a)  # 4 * hi bit
    h_prev = _shift_digits(h, 1)  # hi bit of the digit below (0 into digit 0)
    combine = _table(
        [2 * ((t % DIGIT_BASE) & 1) + t // DIGIT_BASE for t in range(SPACE)],
        a)
    return _pbs(ck, combine, a + h_prev)


def radix_shift_right(ck: CloudKey, a: LweSample, k: int) -> LweSample:
    """Logical right shift by plaintext k bits (zero fill).

    Mirror of the left shift: out_i = (a_i >> 1) + 2*lo(a_{i+1}).
    """
    assert k >= 0
    d = a.b.shape[-1]
    a = _shift_digits(a, -(k // BITS_PER_DIGIT))
    if k % BITS_PER_DIGIT == 0 or k >= d * BITS_PER_DIGIT:
        return a
    lo = _one_table_per_digit(ck, _EXTRACT_BITS4[0], a)  # 4 * lo bit
    lo_next = _shift_digits(lo, -1)  # lo bit of the digit above (0 into top)
    return _pbs(ck, _table(_HALVE_COMBINE, a), a + lo_next)


# --- Signed (two's complement) views ---
#
# Radix words are residues mod 4^d, so add/sub/mul/eq and the bitwise ops
# are sign-agnostic; the signed view only changes encoding at the client
# edge (sign extension) and the order operations: comparison goes through
# the offset-binary map x -> x + 2^(bits-1) (top digit + 2 mod 4, one LUT
# on one digit), after which the unsigned machinery applies as it is.


def encrypt_radix_signed(generator: torch.Generator, key: SecretKey, values,
                         bits: int) -> LweSample:
    """Encrypt signed int[...] in [-2^(bits-1), 2^(bits-1)) (two's
    complement mod 4^d, the same ciphertext layout as unsigned words)."""
    return encrypt_radix(generator, key, values, bits)


def decrypt_radix_signed(key: SecretKey, word: LweSample) -> torch.Tensor:
    """Decrypt a radix word batch to signed int32[...] (sign-extended)."""
    u = decrypt_radix(key, word)  # int64
    bits = word.b.shape[-1] * BITS_PER_DIGIT
    half = 1 << (bits - 1)
    return torch.where(u >= half, u - (half << 1), u).to(torch.int32)


def _flip_top(ck: CloudKey, a: LweSample) -> LweSample:
    """Offset-binary map: top digit -> (digit + 2) mod 4, one LUT rotation."""
    d = a.b.shape[-1]
    lut = _table([(t % DIGIT_BASE + 2) % DIGIT_BASE for t in range(SPACE)], a)
    top = _pbs(ck, lut, _digit(a, d - 1))
    return _stack_digits([_digit(a, i) for i in range(d - 1)] + [top])


def radix_geq_signed(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted signed [a >= b]: unsigned compare after offset-binary."""
    return radix_geq(ck, _flip_top(ck, a), _flip_top(ck, b))


def radix_min_signed(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted signed minimum."""
    flag4 = _scaled_flag(ck, radix_geq_signed(ck, a, b))
    return radix_select(ck, flag4, b, a)


def radix_max_signed(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """Encrypted signed maximum."""
    flag4 = _scaled_flag(ck, radix_geq_signed(ck, a, b))
    return radix_select(ck, flag4, a, b)


def radix_neg(ck: CloudKey, a: LweSample) -> LweSample:
    """Two's-complement negation: 0 - a through the borrow-free chain."""
    d = a.b.shape[-1]
    zero = _stack_digits([_trivial_digit(0, _digit(a, 0))] * d)
    return _add_chain(ck, zero, _complement(a),
                      _trivial_digit(1, _digit(a, 0)))[0]


def _sign_flag4(ck: CloudKey, a: LweSample) -> LweSample:
    """{0,4}-encoded sign bit (hi bit of the top digit), one LUT rotation."""
    d = a.b.shape[-1]
    return _pbs(ck, _table(_BIT_FLAG_TABLES[1], a), _digit(a, d - 1))


def radix_abs(ck: CloudKey, a: LweSample) -> LweSample:
    """|a| (two's complement; -2^(bits-1) maps to itself, as in hardware)."""
    return radix_select(ck, _sign_flag4(ck, a), radix_neg(ck, a), a)


def radix_shift_right_arith(ck: CloudKey, a: LweSample, k: int) -> LweSample:
    """Arithmetic right shift by plaintext k bits (sign fill)."""
    assert k >= 0
    if k == 0:
        return a
    d = a.b.shape[-1]
    s4 = _sign_flag4(ck, a)
    fill_lut = _table(
        [DIGIT_BASE - 1 if u >= DIGIT_BASE else 0 for u in range(SPACE)],
        a)  # sign ? 0b11 : 0b00
    fill = _pbs(ck, fill_lut, s4)
    ds, r = divmod(k, BITS_PER_DIGIT)
    if k >= d * BITS_PER_DIGIT:
        return _stack_digits([fill] * d)
    a = _stack_digits(
        [_digit(a, i) for i in range(ds, d)] + [fill] * min(ds, d))
    if r == 0:
        return a
    lo = _one_table_per_digit(ck, _EXTRACT_BITS4[0], a)
    # incoming lo bit for the top digit is the sign itself ({0,4} = 4*bit)
    lo_next = _stack_digits([_digit(lo, i) for i in range(1, d)] + [s4])
    return _pbs(ck, _table(_HALVE_COMBINE, a), a + lo_next)
