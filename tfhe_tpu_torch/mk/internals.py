"""Multi-key TFHE internals: MK samples, key material, expansion, MK CMUX.

Counterpart of `tfhe_tpu/mk/internals.py` (the Chen-Chillotti-Song scheme,
mask size k = 1). Batched struct-of-arrays throughout. An MK-TLWE sample
[B, parties+1, N] has the shape of a TLWE sample with mask size `parties`,
so the single-key polynomial machinery applies unchanged; the expanded TGSW
sample is assembled at key time into a block-structured [P, K, N] operand
(P = (parties+1)*l, K = parties+1) whose zero blocks encode the sparsity of
the expanded matrix. Integer limb convolutions are exact, so every path and
every summation order gives identical bits.

Every function that draws randomness takes a `torch.Generator`; keys and
ciphertexts live on that generator's device. The blind rotation of a key
that lives on a CUDA device runs through the hand-written kernels of
`ops/mk_cmux.py`; on the CPU it is the plain torch version.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import polynomial
from ..instrument import count, span, spanned
from ..keyswitch import keyswitch_onehot
from ..noise import keyswitch_var, mk_blind_rotate_var
from ..numeric import (
    decode_message,
    dtot32,
    rand_gaussian_float,
    rand_uniform_bool,
    rand_uniform_torus32,
)
from ..ops import conv
from ..ops.blind_rotate import KERNEL_BLOCK
from ..ops.cmux_step import mux_rotate_baked
from ..ops.karatsuba import karatsuba_plan, select_nz_limbs
from ..ops.mk_cmux import (
    cmux_step_sparse,
    e_step_rows,
    expand_sparse,
    mk_blind_rotate_chunk,
    mk_blind_rotate_compact,
)
from ..tgsw import decompose, gadget_values, tgsw_extern_mul_prepared
from ..tlwe import TLweSample
from ..tuning import get_tuning

# --- MK-LWE ---


class MKLweSample(NamedTuple):
    """Batch of MK-LWE ciphertexts: per-party masks and one joint body.

    a: int32[..., parties, n]; b: int32[...]; cv: float32[...].
    """

    a: torch.Tensor
    b: torch.Tensor
    cv: torch.Tensor

    @property
    def parties(self) -> int:
        return self.a.shape[-2]

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    def __add__(self, other: "MKLweSample") -> "MKLweSample":
        return MKLweSample(self.a + other.a, self.b + other.b,
                           self.cv + other.cv)

    def __sub__(self, other: "MKLweSample") -> "MKLweSample":
        return MKLweSample(self.a - other.a, self.b - other.b,
                           self.cv + other.cv)

    def __neg__(self) -> "MKLweSample":
        return MKLweSample(-self.a, -self.b, self.cv)

    def __mul__(self, c: int) -> "MKLweSample":
        """Integer scalar multiple (exact int32 wraparound), variance c^2."""
        return MKLweSample(self.a * c, self.b * c, self.cv * (c * c))

    __rmul__ = __mul__


def mk_lwe_phase(sample: MKLweSample, lwe_keys: torch.Tensor) -> torch.Tensor:
    """b - sum_p <a_p, s_p>. lwe_keys: int32[parties, n]."""
    dots = torch.sum(sample.a * lwe_keys, dim=(-1, -2), dtype=torch.int32)
    return sample.b - dots


def mk_lwe_noiseless_trivial(mu, n: int, parties: int, batch_shape=(),
                             device: torch.device | str = "cuda"
                             ) -> MKLweSample:
    """(0, ..., 0, mu): a trivial sample anyone can decrypt."""
    batch_shape = tuple(batch_shape)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=device)
    return MKLweSample(
        torch.zeros(batch_shape + (parties, n), dtype=torch.int32,
                    device=device),
        mu.expand(batch_shape).clone(),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
    )


# --- MK-TLWE: a TLweSample with mask rows = parties (body last) ---


def mk_tlwe_noiseless_trivial(mu: torch.Tensor, parties: int) -> TLweSample:
    """(0, ..., 0, mu) for a torus polynomial mu: int32[..., N]."""
    mu = mu.to(torch.int32)
    zeros = torch.zeros(mu.shape[:-1] + (parties,) + mu.shape[-1:],
                        dtype=torch.int32, device=mu.device)
    full = torch.cat([zeros, mu.unsqueeze(-2)], dim=-2)
    return TLweSample(full, torch.zeros(mu.shape[:-1], dtype=torch.float32,
                                        device=mu.device))


def mk_tlwe_extract_sample(sample: TLweSample) -> MKLweSample:
    """The constant coefficient as an MK-LWE sample (one mask per party)."""
    rev = polynomial.reverse_polynomial(sample.mask)  # [..., parties, N]
    b = sample.body[..., 0]
    return MKLweSample(rev, b, sample.cv.expand(b.shape))


# --- Shared / public keys ---


def shared_key_gen(generator: torch.Generator, decomp_length: int,
                   poly_degree: int) -> torch.Tensor:
    """l uniform torus polynomials, common to all parties: int32[l, N]."""
    return rand_uniform_torus32(generator, (decomp_length, poly_degree))


def public_key_core(tlwe_key: torch.Tensor, shared_a: torch.Tensor,
                    noise_t32: torch.Tensor) -> torch.Tensor:
    """b_i = s * a_i + e_i. tlwe_key: int32[1, N] (k = 1); shared_a, noise:
    int32[l, N]."""
    prods = conv.poly_mul_batched_torus(shared_a[:, None, :], tlwe_key)
    return prods + noise_t32.to(torch.int32)


def public_key_gen(generator: torch.Generator, tlwe_key: torch.Tensor,
                   alpha: float, shared_a: torch.Tensor) -> torch.Tensor:
    noise = dtot32(rand_gaussian_float(generator, alpha, shared_a.shape))
    return public_key_core(tlwe_key, shared_a, noise)


# --- Uni-encryption ---


class MKTGswUESample(NamedTuple):
    """RGSW.UniEnc output: six l-vectors of torus polynomials,
    int32[..., 6, l, N], stacked in the order (c0, c1, d0, d1, f0, f1)."""

    cd: torch.Tensor

    @property
    def c0(self):
        return self.cd[..., 0, :, :]

    @property
    def c1(self):
        return self.cd[..., 1, :, :]

    @property
    def d0(self):
        return self.cd[..., 2, :, :]

    @property
    def d1(self):
        return self.cd[..., 3, :, :]

    @property
    def f0(self):
        return self.cd[..., 4, :, :]

    @property
    def f1(self):
        return self.cd[..., 5, :, :]


def mk_tgsw_encrypt_core(message, r, c1, f1, noise_c0, noise_d0, noise_d1,
                         noise_f0, tlwe_key, shared_a, pk_b,
                         decomp_length: int, log2_base: int) -> MKTGswUESample:
    """Deterministic RGSW.UniEnc with injected randomness.

    message: int32 scalar or [...]; r: int32[..., N] binary; c1, f1 uniform
    torus [..., l, N]; noises [..., l, N]; tlwe_key int32[1, N]; shared_a,
    pk_b [l, N].
    """
    l = decomp_length
    n = r.shape[-1]
    dev = r.device
    g = torch.tensor(gadget_values(l, log2_base), dtype=torch.int32,
                     device=dev)
    message = torch.as_tensor(message, dtype=torch.int32, device=dev)
    batch = tuple(r.shape[:-1])

    unit = torch.zeros((n,), dtype=torch.int32, device=dev)
    unit[0] = 1
    # [..., l, N]: m * g on the constant coefficient
    const_mg = (message[..., None, None] * g[:, None]) * unit

    def s_mul(polys):  # conv with the party's ring key, batched over [..., l]
        flat = polys.reshape(-1, 1, n)
        return conv.poly_mul_batched_torus(flat, tlwe_key).reshape(polys.shape)

    # r * t for t in {shared_a, pk_b}: the l torus polynomials are shared by
    # the batch while the binary r varies, so this is the shared-torus
    # contraction with digits = r (one 1-bit limb).
    def r_conv(torus_polys):  # [l, N] shared
        prods = conv.poly_mul_batched_small(r.reshape(-1, 1, n),
                                            torus_polys[None], 1)
        return prods.reshape(batch + (l, n))

    c0 = noise_c0 + s_mul(c1) + const_mg
    d1 = noise_d1 + r_conv(shared_a) + const_mg
    d0 = noise_d0 + r_conv(pk_b)
    rg = r[..., None, :] * g[:, None]  # r * g[i], every coefficient
    f0 = noise_f0 + s_mul(f1) + rg
    return MKTGswUESample(torch.stack([c0, c1, d0, d1, f0, f1], dim=-3))


def mk_tgsw_encrypt(generator: torch.Generator, message, alpha: float,
                    tlwe_key, shared_a, pk_b, decomp_length: int,
                    log2_base: int, batch_shape=()) -> MKTGswUESample:
    """Fresh uni-encryption(s). message broadcastable to batch_shape."""
    l = decomp_length
    n = shared_a.shape[-1]
    batch_shape = tuple(batch_shape)
    r = rand_uniform_bool(generator, batch_shape + (n,))
    c1 = rand_uniform_torus32(generator, batch_shape + (l, n))
    f1 = rand_uniform_torus32(generator, batch_shape + (l, n))

    def gauss():
        return dtot32(rand_gaussian_float(generator, alpha,
                                          batch_shape + (l, n)))

    return mk_tgsw_encrypt_core(
        message, r, c1, f1, gauss(), gauss(), gauss(), gauss(), tlwe_key,
        shared_a, pk_b, decomp_length, log2_base)


# --- Expansion ---


class MKTGswExpSample(NamedTuple):
    """Sparse storage of the expanded (parties+1)^2 block matrix:
    x, y: [..., l, parties, N]; c0, c1: [..., l, N]."""

    x: torch.Tensor
    y: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor


def mk_tgsw_expand(ue: MKTGswUESample, party: int, pk_bs: torch.Tensor,
                   decomp_length: int, log2_base: int) -> MKTGswExpSample:
    """RGSW.Expand: extend a party's uni-encryption against all public keys.

    ue: batch [..., 6, l, N]; pk_bs: [parties, l, N].
    """
    parties, l, n = pk_bs.shape
    batch = tuple(ue.cd.shape[:-3])

    diff = pk_bs[:, None] - pk_bs[None, :]  # [i, party', l, N]
    dec = decompose(diff[:, party], decomp_length, log2_base)
    # dec: [parties(i), l(j), l(dec), N], shared by the batch, while f0/f1
    # vary per uni-encryption: sum_dec conv(dec[i, j, dec], f{0,1}[dec]) is
    # one multi-output shared-small-operand contraction.
    f01 = torch.stack([ue.f0, ue.f1], dim=-3)  # [..., 2, l_dec, N]
    flat_f = f01.reshape(-1, decomp_length, n)
    s_shared = dec.reshape(parties * l, decomp_length, n)  # K = (i, j)
    adds = conv.poly_mul_batched_torus_multi(flat_f, s_shared)
    adds = adds.reshape(batch + (2, parties, l, n))  # [..., {x,y}, i, j, N]
    x_add = torch.movedim(adds[..., 0, :, :, :], -3, -2)  # [..., l, i, N]
    y_add = torch.movedim(adds[..., 1, :, :, :], -3, -2)

    x = ue.d0[..., :, None, :] + x_add
    y = y_add.clone()
    # the party's own column: x = d0, y = d1 (no cross terms)
    x[..., :, party, :] = ue.d0
    y[..., :, party, :] = ue.d1
    return MKTGswExpSample(x, y, ue.c0, ue.c1)


def build_extern_operand(exp: MKTGswExpSample, party: int, parties: int,
                         decomp_length: int) -> torch.Tensor:
    """Assemble the expanded sample into the block [P, K, N] contraction
    operand (P = (parties+1)*l rows (j, l'), K = parties+1 outputs), then
    limb-prepare it. Returns int8[..., 4, P, K, 2N].

    Block structure:
      col i != party:  rows (j=i, l') = y[l', party]
      col party:       rows (j, l')   = y[l', j];  rows (body, l') = c1[l']
      col body (last): rows (j, l')   = x[l', j];  rows (body, l') = c0[l']
    """
    l = decomp_length
    x, y, c0, c1 = exp
    batch = tuple(c0.shape[:-2])
    n = c0.shape[-1]
    kk = parties + 1
    t = torch.zeros(batch + (kk, l, kk, n), dtype=torch.int32,
                    device=c0.device)  # rows (j, l'), cols k
    for i in range(parties):
        if i != party:
            t[..., i, :, i, :] = y[..., :, party, :]
        t[..., i, :, party, :] = y[..., :, i, :]
        t[..., i, :, kk - 1, :] = x[..., :, i, :]
    t[..., kk - 1, :, party, :] = c1
    t[..., kk - 1, :, kk - 1, :] = c0
    return conv.prepare_shared_torus(t.reshape(batch + (kk * l, kk, n)))


def build_extern_operand_sparse(exp: MKTGswExpSample, party: int,
                                parties: int, decomp_length: int,
                                nz) -> torch.Tensor:
    """Like `build_extern_operand`, but only the nonzero blocks, stacked in
    `nz` = mk_nonzero_blocks order: int8[..., 4, NZ, l, 2N]. What makes the
    8-party key fit the card (3*parties+1 of (parties+1)^2 blocks)."""
    x, y, c0, c1 = exp
    kk = parties + 1

    def block(j, k):
        if j < parties:
            if k == kk - 1:
                return x[..., :, j, :]
            if k == party:
                return y[..., :, j, :]
            return y[..., :, party, :]  # k == j != party
        return c1 if k == party else c0  # body row

    t = torch.stack([block(j, k) for (j, k) in nz], dim=-3)
    return conv.prepare_shared_torus(t)  # [..., 4, NZ, l, 2N]


# --- MK keyswitch ---


@spanned("tfhe.keyswitch")
def mk_keyswitch(ks_keys, sample: MKLweSample) -> MKLweSample:
    """Per-party keyswitch of each mask column: the single-key one-hot int8
    contraction, once per party (there is no int8 batched matmul on CUDA;
    the arithmetic per party is the single-key `keyswitch`'s, so the result
    is bit-identical to the reference's batched contraction). Runs in a
    `tfhe.keyswitch` span.

    ks_keys: `parties` KeyswitchKeys (party-local out keys) of one geometry.
    """
    ks0 = ks_keys[0]
    l, b = ks0.decomp_length, ks0.log2_base
    parties = len(ks_keys)
    if not all(k.table_limbs.shape == ks0.table_limbs.shape
               and (k.decomp_length, k.log2_base) == (l, b) for k in ks_keys):
        raise ValueError("party keyswitch geometries differ")

    batch_shape = tuple(sample.b.shape)
    onehot = keyswitch_onehot(sample.a, l, b)  # [..., parties, R] int8
    oh = onehot.reshape(-1, parties, onehot.shape[-1])
    acc = torch.stack([
        conv.recombine_limbs(conv.i8_matmul(oh[:, party], key.table_limbs))
        for party, key in enumerate(ks_keys)])  # [parties, B, C]
    a_out = torch.movedim(-acc[..., :ks0.n_out], 0, 1).reshape(
        batch_shape + (parties, ks0.n_out))
    b_out = sample.b - torch.sum(acc[..., ks0.n_out], dim=0,
                                 dtype=torch.int32).reshape(batch_shape)
    cv = sample.cv + sum(
        keyswitch_var(k.n_in, l, b, k.noise_stddev) for k in ks_keys)
    return MKLweSample(a_out, b_out, cv)


# --- MK bootstrap ---

_SPARSE_ABOVE = 8 * 2**30  # dense prepared bytes past which a key goes sparse
_BAKE_BUDGET = 6 * 2**30  # default budget of the T <= 64 bake


def _expand_geometry(n: int) -> bool:
    """The sparse-expansion path runs at the kernels' block T = 128 and
    needs at least two blocks per polynomial."""
    return n % KERNEL_BLOCK == 0 and n // KERNEL_BLOCK >= 2


@dataclasses.dataclass(frozen=True)
class MKBootstrapKey:
    """Expanded MK bootstrap key, party-major step order (party outer loop,
    key bit inner).

    Three storage forms:
    * block == 0, sparse=False: prepared limbs int8[parties*n, 4, P, K, 2N]:
      compact (grows as parties^2). The expansion path expands per step; the
      prepared fallback gathers a Toeplitz at gate time.
    * block == 0, sparse=True: the nonzero blocks only, a tuple of `parties`
      tensors int8[n, 4, NZ, l, 2N] with NZ = 3*parties+1 in
      `mk_nonzero_blocks` order. Expansion path only.
    * block == T > 0: baked block-Toeplitz int8[parties*n, 2M*P*T, K*4*T]
      (ops/conv.py:bake_block_toeplitz): gather-free dense matmuls at gate
      time, T times the storage (the CPU's form).
    """

    limbs: torch.Tensor | tuple
    parties: int
    lwe_size: int
    decomp_length: int
    log2_base: int
    polynomial_degree: int
    block: int = 0
    noise_stddev: float = 0.0  # party keygen sigma, feeds the cv model
    sparse: bool = False
    balanced: bool = False  # gate-time nearest-rounding gadget (tgsw.py)

    @property
    def device(self) -> torch.device:
        limbs = self.limbs
        return (limbs[0] if isinstance(limbs, tuple) else limbs).device


def _is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def party_limbs(bk: MKBootstrapKey, party: int) -> torch.Tensor:
    """One party's key: its n steps of a dense or baked key, or its entry
    of a sparse-stored one. A key sharded over a mesh's `model` axis
    (`parallel.shard_mk_cloud_key`: each rank holds a run of whole steps
    or parties) fetches them from the ranks that hold them into a buffer of
    one party (`parallel.mesh.fetch_rows`, a collective: every rank of the
    model group asks for the same party in the same order, as the
    party-major rotation does)."""
    n = bk.lwe_size
    if _is_dtensor(bk.limbs):
        from ..parallel.mesh import fetch_rows

        if bk.sparse:
            return fetch_rows(bk.limbs, party, party + 1)[0]
        return fetch_rows(bk.limbs, party * n, (party + 1) * n)
    if bk.sparse:
        return bk.limbs[party]
    return bk.limbs[party * n:(party + 1) * n]


def _mk_bake_block(steps: int, p: int, kk: int, n: int,
                   budget_bytes: int) -> int:
    """Largest block T in {64, 32, 16} whose baked key fits the budget
    (steps * 2N * P * K*4 * T bytes); 0 = stay on the prepared path."""
    knob = get_tuning().mk_bake_budget
    budget = budget_bytes if knob < 0 else knob  # 0 forces the prepared path
    for t in (64, 32, 16):
        if n % t or n // t < 2:
            continue
        if steps * 2 * n * p * kk * 4 * t <= budget:
            return t
    return 0


def mk_bootstrap_key(parts_ue, pk_bs: torch.Tensor, decomp_length: int,
                     log2_base: int, noise_stddev: float = 0.0,
                     balanced: bool = False) -> MKBootstrapKey:
    """Server-side expansion of all parties' uni-encrypted key bits.

    parts_ue: `parties` MKTGswUESample batches [n, 6, l, N]; pk_bs:
    [parties, l, N]. On a CUDA device with a 128-divisible ring the prepared
    form feeds the expansion kernels directly, and only the nonzero blocks
    are stored once the dense prepared form passes 8 GiB (8 parties: 21 GB
    dense, 6.6 GB sparse). Elsewhere the block-Toeplitz form is baked when
    it fits the budget, for the torch fallback.
    """
    parties = pk_bs.shape[0]
    n_lwe = parts_ue[0].cd.shape[0]
    steps = parties * n_lwe
    kk = parties + 1
    p = kk * decomp_length
    n = pk_bs.shape[-1]
    fast = pk_bs.is_cuda and _expand_geometry(n)
    dense_bytes = steps * 4 * p * kk * 2 * n
    sparse_knob = get_tuning().mk_sparse_limbs
    if sparse_knob == "auto":
        sparse = fast and dense_bytes > _SPARSE_ABOVE
    else:
        sparse = bool(int(sparse_knob))

    all_limbs = []
    for party in range(parties):
        exp = mk_tgsw_expand(parts_ue[party], party, pk_bs, decomp_length,
                             log2_base)
        if sparse:
            nz = mk_nonzero_blocks(party, parties)
            limbs = build_extern_operand_sparse(exp, party, parties,
                                                decomp_length, nz)
        else:
            limbs = build_extern_operand(exp, party, parties, decomp_length)
        all_limbs.append(limbs.contiguous())
    # Sparse keys stay a per-party tuple: each party's loop reads its own
    # tensor, and no concatenation doubles the 6.6 GB 8-party key.
    limbs = tuple(all_limbs) if sparse else torch.cat(all_limbs, dim=0)

    t = 0 if (fast or sparse) else _mk_bake_block(steps, p, kk, n,
                                                  _BAKE_BUDGET)
    if t:
        limbs = conv.bake_block_toeplitz(limbs, t)
    return MKBootstrapKey(limbs, parties, n_lwe, decomp_length, log2_base, n,
                          t, noise_stddev, sparse, balanced)


def mk_nonzero_blocks(party: int, parties: int) -> tuple:
    """Static nonzero (block row j, output column k) pairs of a party's
    expanded operand; the complement is structurally zero (see
    `build_extern_operand`): block row i touches only columns {i, party,
    body}; the body row touches {party, body}. NZ = 3*parties+1 of
    (parties+1)^2: 7/9 at 2 parties, 13/25 at 4, 25/81 at 8."""
    kk = parties + 1
    pairs = set()
    for i in range(parties):
        if i != party:
            pairs.add((i, i))
        pairs.add((i, party))
        pairs.add((i, kk - 1))
    pairs.add((kk - 1, party))
    pairs.add((kk - 1, kk - 1))
    return tuple(sorted(pairs))


def _use_mk_expand_kernel(bk: MKBootstrapKey) -> bool:
    """The sparse-expansion path: prepared (block == 0) keys with a
    128-divisible ring degree, when the key lives on a CUDA device or
    `tuning.mk_cmux` forces it."""
    mode = get_tuning().mk_cmux
    if bk.block != 0 or not _expand_geometry(bk.polynomial_degree):
        return False
    if bk.sparse:  # sparse limbs exist only for the expansion path
        return True
    if mode == "expand":
        return True
    if mode in ("xla", "prepared"):
        return False
    return bk.device.type == "cuda"


def active_plan(party: int, parties: int, progressive: bool):
    """The triangular rotation's restriction for one party's n-step loop.

    The rotation is party-major and the external product writes mask
    component i only from blocks whose digits come from component i itself
    (the (i, i) diagonal), so while party p is processed the accumulator
    components of parties p+1.. are structurally zero (decompose(0) == 0 in
    both gadget modes), their digit rows are zero, and every block touching
    them adds exactly zero. Dropping those blocks and running on the active
    [masks 0..p, body] slice of the accumulator is bit-identical and cuts
    the blocks per step from 3P+1 to 3p+4.

    Returns (nz_orig, nz_kern, sel, k_act): the blocks in the dense
    operand's indices, the same blocks remapped to the active slice (body at
    k_act - 1; what the step is planned on), their positions in the stored
    sparse axis (None: all of it), and the active component count.
    """
    full = mk_nonzero_blocks(party, parties)
    k1 = parties + 1
    k_act = party + 2
    if not progressive or k_act >= k1:
        return full, full, None, k1
    active = set(range(party + 1)) | {parties}

    def remap(i):
        return i if i <= party else k_act - 1

    nz_orig, nz_kern, sel = [], [], []
    for pos, (j, kc) in enumerate(full):
        if j in active and kc in active:
            nz_orig.append((j, kc))
            nz_kern.append((remap(j), remap(kc)))
            sel.append(pos)
    return tuple(nz_orig), tuple(nz_kern), tuple(sel), k_act


def select_compact(bk: MKBootstrapKey, limbs_p: torch.Tensor, nz_orig,
                   sel) -> torch.Tensor:
    """A party's nz-selected compact limbs, contiguous
    int8[n, 4, NZ, l, 2N], for the compact rotation (which expands per
    step itself)."""
    if bk.sparse:
        return limbs_p if sel is None else limbs_p[:, :, list(sel)].contiguous()
    return select_nz_limbs(limbs_p, nz_orig, bk.decomp_length)


def chunk_len(n_lwe: int, e_step_bytes: int) -> int:
    """Steps per chunk: `tuning.mk_chunk` when it divides n, else the
    largest divisor of n up to 20 whose expanded chunk stays under 1 GiB
    (an 8-party step is 236 MB)."""
    cap = get_tuning().mk_chunk
    if cap:
        return cap if n_lwe % cap == 0 else 1
    best = 1
    for d in range(2, 21):
        if n_lwe % d == 0 and d * e_step_bytes <= 2**30:
            best = d
    return best


def _rotate_expand(acc_a: torch.Tensor, bk: MKBootstrapKey,
                   bara_t: torch.Tensor, progressive: bool) -> torch.Tensor:
    """The rotation through per-step sparse expansion (the key cannot be
    pre-baked at T = 128, and its block matrix is mostly zeros). Steps are
    party-major, so each party's n-step loop has its own static
    nonzero-block pattern; the knobs choose between one call per party from
    the compact limbs, chunks of pre-expanded steps, and one call per
    step. Counts `path.mk_compact`, `path.mk_chunk` or `path.mk_step` once
    for each path its party loops took."""
    l, b, n = bk.decomp_length, bk.log2_base, bk.polynomial_degree
    t = KERNEL_BLOCK
    tuning = get_tuning()
    depth = max(1, min(tuning.karatsuba_depth or 2,
                       (n // t).bit_length() - 1))
    plan = karatsuba_plan(n // t, depth, b)
    k1 = bk.parties + 1
    n_lwe = bk.lwe_size
    on_card = acc_a.is_cuda
    use_mega = (bk.parties >= 4 if tuning.mk_mega == "auto"
                else tuning.mk_mega == "1")
    use_compact = (tuning.mk_compact == "1"
                   or (tuning.mk_compact == "auto" and on_card))
    paths = set()

    for party in range(bk.parties):
        nz_orig, nz_kern, sel, k_act = active_plan(party, bk.parties,
                                                   progressive)
        kw = dict(l=l, b=b, t=t, plan=plan, nz=nz_kern, balanced=bk.balanced)
        p0 = party * n_lwe
        limbs_p = party_limbs(bk, party)
        bara_p = bara_t[p0:p0 + n_lwe]
        if k_act < k1:
            # active slice: masks 0..party and the body (the rest are zero)
            acc_run = torch.cat([acc_a[:, :party + 1], acc_a[:, k1 - 1:]],
                                dim=1)
        else:
            acc_run = acc_a.contiguous()

        def expand_one(limbs_i):
            if bk.sparse:
                if sel is not None:
                    limbs_i = limbs_i[:, list(sel)]
                return expand_sparse(limbs_i, t=t, plan=plan, nz=nz_kern, l=l,
                                     preselected=True)
            return expand_sparse(limbs_i, t=t, plan=plan, nz=nz_orig, l=l,
                                 preselected=False)

        s_chunk = 1
        if use_mega and not use_compact:
            s_chunk = chunk_len(n_lwe,
                                e_step_rows(plan, l, t, nz_kern) * 4 * t)
        if use_compact:
            paths.add("mk_compact")
            acc_run = mk_blind_rotate_compact(
                acc_run, select_compact(bk, limbs_p, nz_orig, sel), bara_p,
                **kw)
        elif s_chunk > 1:
            paths.add("mk_chunk")
            for s0 in range(0, n_lwe, s_chunk):
                e_chunk = torch.stack([expand_one(limbs_p[s])
                                       for s in range(s0, s0 + s_chunk)])
                acc_run = mk_blind_rotate_chunk(
                    acc_run, e_chunk, bara_p[s0:s0 + s_chunk], **kw)
        else:
            paths.add("mk_step")
            for s in range(n_lwe):
                acc_run = cmux_step_sparse(acc_run, expand_one(limbs_p[s]),
                                           bara_p[s], **kw)
        if k_act < k1:
            zeros = torch.zeros((acc_run.shape[0], k1 - k_act, n),
                                dtype=torch.int32, device=acc_run.device)
            acc_a = torch.cat([acc_run[:, :party + 1], zeros,
                               acc_run[:, -1:]], dim=1)
        else:
            acc_a = acc_run
    for path in paths:
        count(f"path.{path}")
    return acc_a


def mk_blind_rotate(accum: TLweSample, bk: MKBootstrapKey,
                    bara: torch.Tensor, segments: int = 1,
                    trivial_masks: bool = True) -> TLweSample:
    """parties x n CMUX steps; accum: [B, parties+1, N]; bara:
    int32[B, parties, n]. Branchless, as in the single-key path.

    segments: the reference splits its scan into that many separately
    compiled programs for devices with a program-duration limit, with
    identical bits; torch runs eagerly, so this is one loop whatever the
    value.

    trivial_masks: the accumulator's mask components start zero (true for
    every bootstrap: the accumulator is the noiseless-trivial test vector).
    This allows the triangular rotation (`active_plan`, under
    `tuning.mk_progressive`). Pass False for an arbitrary accumulator.

    Runs in a `tfhe.rotation` span; the loop of the prepared or baked key
    (no expansion) counts `path.mk_plain`.
    """
    del segments
    with span("tfhe.rotation"):
        return _mk_blind_rotate(accum, bk, bara, trivial_masks)


def _mk_blind_rotate(accum: TLweSample, bk: MKBootstrapKey,
                     bara: torch.Tensor, trivial_masks: bool) -> TLweSample:
    l, b = bk.decomp_length, bk.log2_base
    steps = bk.parties * bk.lwe_size
    bsz = accum.a.shape[0]
    bara_t = bara.to(torch.int32).reshape(bsz, steps).t().contiguous()
    cv_out = accum.cv + mk_blind_rotate_var(
        bk.parties, bk.lwe_size, l, b, bk.polynomial_degree, bk.noise_stddev,
        bk.balanced)

    if _use_mk_expand_kernel(bk):
        progressive = trivial_masks and get_tuning().mk_progressive
        return TLweSample(_rotate_expand(accum.a, bk, bara_t, progressive),
                          cv_out)

    if bk.sparse:
        raise ValueError("a sparse-stored key has only the expansion path, "
                         f"which needs N = {bk.polynomial_degree} to be a "
                         f"multiple of {KERNEL_BLOCK} with N/{KERNEL_BLOCK} "
                         ">= 2")
    count("path.mk_plain")
    acc_a = accum.a
    for party in range(bk.parties):
        bara_p = bara_t[party * bk.lwe_size:(party + 1) * bk.lwe_size]
        for limbs_i, bara_i in zip(party_limbs(bk, party), bara_p):
            if bk.block:
                acc_a = mux_rotate_baked(acc_a, limbs_i, bara_i, l, b,
                                         bk.block, bk.balanced)
            else:
                rot = polynomial.mul_by_monomial(acc_a, bara_i[:, None])
                temp = TLweSample(rot - acc_a, accum.cv)
                acc_a = acc_a + tgsw_extern_mul_prepared(temp, limbs_i, l, b,
                                                         bk.balanced).a
    return TLweSample(acc_a, cv_out)


def mk_blind_rotate_and_extract(v: torch.Tensor, bk: MKBootstrapKey,
                                barb: torch.Tensor, bara: torch.Tensor,
                                segments: int = 1) -> MKLweSample:
    """v: int32[B, N] test polynomial; barb: int32[B]; bara:
    int32[B, parties, n]."""
    with span("tfhe.modswitch"):
        accum = _mk_test_accumulator(v, barb, bk.parties)
    return _mk_rotate_and_extract(accum, bk, bara, segments)


def _mk_test_accumulator(v: torch.Tensor, barb: torch.Tensor,
                         parties: int) -> TLweSample:
    testvectbis = polynomial.mul_by_monomial(v, -barb.to(torch.int32))
    return mk_tlwe_noiseless_trivial(testvectbis, parties)


def _mk_rotate_and_extract(accum: TLweSample, bk: MKBootstrapKey,
                           bara: torch.Tensor, segments: int) -> MKLweSample:
    accum = mk_blind_rotate(accum, bk, bara, segments)
    with span("tfhe.extract"):
        return mk_tlwe_extract_sample(accum)


def mk_bootstrap_wo_keyswitch(bk: MKBootstrapKey, mu: int, x: MKLweSample,
                              segments: int = 1) -> MKLweSample:
    """MK-LWE(mu) iff phase(x) > 0 else MK-LWE(-mu), in the extracted
    N-dim space per party. x: any batch shape [..., parties, n]. Its
    stages run in the spans `tfhe.modswitch`, `tfhe.rotation` and
    `tfhe.extract`."""
    p_degree = bk.polynomial_degree
    batch_shape = tuple(x.b.shape)
    flat_a = x.a.reshape((-1,) + tuple(x.a.shape[-2:]))
    flat_b = x.b.reshape(-1)
    with span("tfhe.modswitch"):
        bara = decode_message(flat_a, p_degree * 2)  # [B, parties, n]
        barb = decode_message(flat_b, p_degree * 2)  # [B]
        testvect = torch.full(flat_b.shape + (p_degree,), mu,
                              dtype=torch.int32, device=flat_b.device)
        accum = _mk_test_accumulator(testvect, barb, bk.parties)
    out = _mk_rotate_and_extract(accum, bk, bara, segments)
    return MKLweSample(out.a.reshape(batch_shape + tuple(out.a.shape[-2:])),
                       out.b.reshape(batch_shape),
                       out.cv.reshape(batch_shape))


def mk_bootstrap(bk: MKBootstrapKey, ks_keys, mu: int, x: MKLweSample,
                 segments: int = 1) -> MKLweSample:
    u = mk_bootstrap_wo_keyswitch(bk, mu, x, segments)
    return mk_keyswitch(ks_keys, u)
