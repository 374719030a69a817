"""Encrypted integer circuits over batched bootstrapped gates.

Counterpart of `tfhe_tpu/circuits.py`: the comparator chain and the
encrypted minimum of the reference's tutorial, ripple-carry add and
subtract, restoring division, shift-and-add multiplication and equality. A
word batch is one LweSample with batch dims [..., n_words, bits]; each
circuit stage applies a gate to a [n_words]-batched bit slice, so the
rotation kernels' batch dimension is the word batch while the bit or carry
chain is the (inherently sequential) Python loop.

Integers cross this module's edge as int64 tensors holding values mod 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import CloudKey, SecretKey, decrypt, encrypt
from .gates import (
    gate_and,
    gate_constant,
    gate_mux,
    gate_not,
    gate_xnor,
    gate_xor,
)
from .lwe import LweSample
from .numeric import input_device


def int_to_bits(values, bits: int, device=None) -> torch.Tensor:
    """int[...] -> bool[..., bits], LSB first, on `device`, or else the
    device of a tensor `values`, or else the card."""
    device = input_device(values, device)
    if not isinstance(values, torch.Tensor):
        values = np.asarray(values).astype(np.int64)
    values = torch.as_tensor(values, device=device).to(torch.int64)
    shifts = torch.arange(bits, device=values.device)
    return ((values[..., None] >> shifts) & 1) != 0


def bits_to_int(bit_array: torch.Tensor) -> torch.Tensor:
    """bool[..., bits] -> int64[...], LSB first."""
    bits = bit_array.shape[-1]
    weights = torch.ones((), dtype=torch.int64, device=bit_array.device) \
        << torch.arange(bits, device=bit_array.device)
    return torch.sum(bit_array.to(torch.int64) * weights, dim=-1)


def encrypt_word(generator: torch.Generator, key: SecretKey, values,
                 bits: int) -> LweSample:
    """Encrypt int[...] as LweSample with batch [..., bits] (LSB first)."""
    return encrypt(generator, key,
                   int_to_bits(values, bits, generator.device))


def decrypt_word(key: SecretKey, word: LweSample) -> torch.Tensor:
    """Decrypt a word ciphertext back to int64[...]."""
    return bits_to_int(decrypt(key, word))


def _bit(word: LweSample, i: int) -> LweSample:
    return LweSample(word.a[..., i, :], word.b[..., i], word.cv[..., i])


def _stack_bits(bits_list) -> LweSample:
    return LweSample(
        torch.stack([b.a for b in bits_list], dim=-2),
        torch.stack([b.b for b in bits_list], dim=-1),
        torch.stack([b.cv for b in bits_list], dim=-1),
    )


def compare_bit(ck: CloudKey, a: LweSample, b: LweSample,
                lsb_carry: LweSample) -> LweSample:
    """Elementary comparator: lsb_carry if a == b, else a (XNOR then MUX)."""
    tmp = gate_xnor(ck, a, b)
    return gate_mux(ck, tmp, lsb_carry, a)


def encrypted_greater_than(ck: CloudKey, a: LweSample,
                           b: LweSample) -> LweSample:
    """a > b on word ciphertexts [..., bits] -> single-bit ciphertext.

    The running carry is the comparison of the bits seen so far, with the
    most significant differing bit deciding.
    """
    bits = a.b.shape[-1]
    carry = gate_constant(ck, False, tuple(a.b.shape[:-1]))
    for i in range(bits):
        carry = compare_bit(ck, _bit(a, i), _bit(b, i), carry)
    return carry


def encrypted_minimum(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """min(a, b) on word ciphertexts [..., bits]."""
    bits = a.b.shape[-1]
    carry = encrypted_greater_than(ck, a, b)
    # carry == 1 iff a is larger -> select the other word per bit
    return _stack_bits(
        [gate_mux(ck, carry, _bit(b, i), _bit(a, i)) for i in range(bits)]
    )


def encrypted_maximum(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """max(a, b) on word ciphertexts [..., bits]."""
    bits = a.b.shape[-1]
    carry = encrypted_greater_than(ck, a, b)
    return _stack_bits(
        [gate_mux(ck, carry, _bit(a, i), _bit(b, i)) for i in range(bits)]
    )


def ripple_carry_add(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """a + b (mod 2^bits) on word ciphertexts [..., bits].

    Full adder per bit: s = a ^ b ^ c; c' = MUX(a ^ b, c, a): when the
    inputs differ the carry propagates, otherwise it equals the inputs.
    """
    bits = a.b.shape[-1]
    carry = gate_constant(ck, False, tuple(a.b.shape[:-1]))
    out = []
    for i in range(bits):
        ai, bi = _bit(a, i), _bit(b, i)
        axb = gate_xor(ck, ai, bi)
        out.append(gate_xor(ck, axb, carry))
        if i + 1 < bits:
            carry = gate_mux(ck, axb, carry, ai)
    return _stack_bits(out)


def _sub_chain(ck: CloudKey, a: LweSample, b: LweSample, last_carry: bool):
    """a + ~b + 1: (difference bits, carry after the last bit or, without
    `last_carry`, after the one before it)."""
    bits = a.b.shape[-1]
    carry = gate_constant(ck, True, tuple(a.b.shape[:-1]))
    out = []
    for i in range(bits):
        ai, bi = _bit(a, i), gate_not(ck, _bit(b, i))
        axb = gate_xor(ck, ai, bi)
        out.append(gate_xor(ck, axb, carry))
        if last_carry or i + 1 < bits:
            carry = gate_mux(ck, axb, carry, ai)
    return _stack_bits(out), carry


def ripple_carry_sub(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """a - b (mod 2^bits) on word ciphertexts [..., bits].

    Two's complement: a + ~b + 1. The NOT is a free (non-bootstrapped)
    negation and the +1 is the initial carry, so the cost equals one
    addition.
    """
    return _sub_chain(ck, a, b, last_carry=False)[0]


def _sub_with_borrow(ck: CloudKey, a: LweSample, b: LweSample):
    """(a - b mod 2^bits, no_borrow); no_borrow decrypts to a >= b."""
    return _sub_chain(ck, a, b, last_carry=True)


def divide(ck: CloudKey, n: LweSample, d: LweSample):
    """(n // d, n % d) on word ciphertexts [..., bits], unsigned restoring
    division. Undefined for d == 0 (as in plaintext). Each of the `bits`
    rounds is one borrow-out subtraction plus one batched MUX restore."""
    bits = n.b.shape[-1]
    zero = gate_constant(ck, False, tuple(n.b.shape[:-1]))
    r = [zero] * bits
    q = [zero] * bits
    for i in reversed(range(bits)):
        r = [_bit(n, i)] + r[:-1]  # R = (R << 1) | n_i  (LSB-first)
        diff, ge = _sub_with_borrow(ck, _stack_bits(r), d)
        q[i] = ge
        restored = gate_mux(ck, _broadcast_bit(ge, bits), diff,
                            _stack_bits(r))
        r = [_bit(restored, j) for j in range(bits)]
    return _stack_bits(q), _stack_bits(r)


def _select_bits(word: LweSample, lo: int, hi: int) -> LweSample:
    return LweSample(word.a[..., lo:hi, :], word.b[..., lo:hi],
                     word.cv[..., lo:hi])


def _broadcast_bit(bit: LweSample, width: int) -> LweSample:
    """One bit broadcast across a width-sized bit axis (zero-copy views; the
    gates combine them with other samples, which materialises them)."""
    return LweSample(
        bit.a[..., None, :].expand(tuple(bit.a.shape[:-1])
                                   + (width, bit.a.shape[-1])),
        bit.b[..., None].expand(tuple(bit.b.shape) + (width,)),
        bit.cv[..., None].expand(tuple(bit.cv.shape) + (width,)),
    )


def multiply(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """a * b (mod 2^bits) on word ciphertexts [..., bits].

    Shift-and-add: partial product j is one batched AND of a's low
    (bits - j) bits against b_j, then a truncated ripple add into the
    accumulator at offset j. Gate count is bits^2 ANDs plus about bits^2
    adder gates.
    """
    bits = a.b.shape[-1]
    acc = [
        _bit(gate_and(ck, a, _broadcast_bit(_bit(b, 0), bits)), i)
        for i in range(bits)
    ]
    for j in range(1, bits):
        width = bits - j
        pp = gate_and(ck, _select_bits(a, 0, width),
                      _broadcast_bit(_bit(b, j), width))
        carry = None
        for i in range(width):
            s, p = acc[j + i], _bit(pp, i)
            x = gate_xor(ck, s, p)
            if carry is None:
                acc[j + i] = x
                if i + 1 < width:
                    carry = gate_and(ck, s, p)
            else:
                acc[j + i] = gate_xor(ck, x, carry)
                if i + 1 < width:
                    carry = gate_mux(ck, x, carry, s)
    return _stack_bits(acc)


def encrypted_equal(ck: CloudKey, a: LweSample, b: LweSample) -> LweSample:
    """a == b on word ciphertexts [..., bits] -> single-bit ciphertext.

    One batched XNOR over the whole word, then a log-depth AND tree whose
    levels are each one batched gate call over the surviving pairs.
    """
    cur = gate_xnor(ck, a, b)
    m = cur.b.shape[-1]
    while m > 1:
        half = m // 2
        merged = gate_and(ck, _select_bits(cur, 0, half),
                          _select_bits(cur, half, 2 * half))
        if m % 2:
            merged = LweSample(
                torch.cat([merged.a, cur.a[..., -1:, :]], dim=-2),
                torch.cat([merged.b, cur.b[..., -1:]], dim=-1),
                torch.cat([merged.cv, cur.cv[..., -1:]], dim=-1),
            )
        cur = merged
        m = cur.b.shape[-1]
    return _bit(cur, 0)
