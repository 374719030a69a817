"""The work of a gate bootstrap's rotation counted from its shapes, and the
card's peaks: the yardstick of the roofline shares.

Operations: the fewest int8 multiply-adds that the exact four-limb scheme
needs. The negacyclic N x N Toeplitz of a key polynomial splits into
T x T blocks (T = 128, the card's tile, M = N/T blocks), one external
product is a polynomial product over the block index, and block-level
Karatsuba cuts the M^2 block products to 3 per level. A product of a
digit-side combo against a key-side combo costs (digit rows) x (4 key
limbs) x T^2 multiply-adds per limb of the digit combo: one limb while a
sum of L digits stays in [-128, 127] (2^(b-1) * L <= 128), two beyond.
The count takes the least over every depth that M allows, so no
implementation of the same arithmetic reads above 100%.

Bytes: the key's words read once, as int8 limbs (4 bytes a word): for a
single key the raw TGSW samples, for MK the nonzero blocks of each step's
expanded operand that the triangular rotation touches.

This is a frozen copy of the block arithmetic of the port's Karatsuba plan;
a change of the program's plan does not move it.
"""

from __future__ import annotations

import functools

# Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# data sheet): int8 tensor-core operations a second (a multiply-add is two)
# and HBM bytes a second.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
BLOCK = 128


@functools.lru_cache(maxsize=None)
def superblock_products(m: int, depth: int, log2_base: int) -> int:
    """Block products (limb sets counted) of one external-product column
    under a depth-`depth` Karatsuba split of length-m block sequences."""
    total = 0

    def leaf(entries):
        nonlocal total
        width = len(entries)
        limbs = 1 if (1 << (log2_base - 1)) * len(entries[0]) <= 128 else 2
        total += limbs * width * width

    def rec(entries, d):
        if d == 0 or len(entries) == 1:
            leaf(entries)
            return
        h = len(entries) // 2
        lo, hi = entries[:h], entries[h:]
        rec(lo, d - 1)
        rec(hi, d - 1)
        rec(tuple(lo[j] + hi[j] for j in range(h)), d - 1)

    rec(tuple((i,) for i in range(m)), depth)
    return total


def fewest_superblocks(m: int, log2_base: int) -> int:
    """The least block products over every depth that m allows."""
    return min(superblock_products(m, d, log2_base)
               for d in range(m.bit_length()))


def mk_active_blocks(party: int, parties: int) -> int:
    """Nonzero (component row, output column) blocks of party `party`'s
    expanded operand that touch only the components its loop has made
    nonzero (the parties before it, itself and the body)."""
    body = parties
    active = set(range(party + 1)) | {body}
    pairs = set()
    for i in range(parties):
        if i != party:
            pairs.add((i, i))
        pairs.add((i, party))
        pairs.add((i, body))
    pairs.update({(body, party), (body, body)})
    return sum(1 for j, k in pairs if j in active and k in active)


def rotation_work(p: dict, batch: int) -> tuple:
    """(int8 operations, key bytes) of the blind rotations of `batch` gate
    bootstraps (one gate layer)."""
    n, nn = p["lwe_size"], p["tlwe_polynomial_degree"]
    l, b = p["bs_decomp_length"], p["bs_log2_base"]
    m = nn // BLOCK
    s = fewest_superblocks(m, b)
    t2 = BLOCK * BLOCK
    if p["scheme"] == "cggi":
        k1 = p["tlwe_mask_size"] + 1
        macs = batch * n * s * (k1 * l) * (k1 * 4) * t2
        key_bytes = n * (k1 * l) * k1 * nn * 4
        return 2 * macs, key_bytes
    parties = p["parties"]
    blocks = sum(mk_active_blocks(q, parties) for q in range(parties))
    macs = batch * n * blocks * s * l * 4 * t2
    return 2 * macs, n * blocks * l * nn * 4


def steps_per_rotation(p: dict) -> int:
    return p["lwe_size"] * (p["parties"] if p["scheme"] == "mktfhe" else 1)
