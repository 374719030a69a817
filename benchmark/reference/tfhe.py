"""Plain reference of the bootstrap, single-key and multi-key.

A batched rewrite, in plain torch, of the NumPy spec of TFHE gate
bootstrapping and of MK-TFHE (Chen-Chillotti-Song): the modulus switch to
2N, the blind rotation by CMUX steps against the coefficient-domain TGSW
key, the sample extraction and the LWE keyswitch. The single-key
bootstrap takes any test polynomial (a gate's constant, a lookup table),
so a unit of work (`benchmark/units/`) writes its reference against it;
the NAND gate is its first caller, and the MK reference's own.
It starts from the raw key material that the benchmark draws from its seed
(`benchmark/inputs.py`) and works out everything else itself: the TGSW key
as TGSW samples, the keyswitch bodies, and for MK the public keys, the
uni-encryptions and their expansion.

Torus words are int32, arithmetic mod 2^32. Every negacyclic product is a
float matrix product against the negacyclic Toeplitz matrix of its
key-side polynomial. In float64 it is exact: each product and each
partial sum is an integer below 2^53, which `_check_exact` proves from the
shapes. `dtype=torch.float32` computes the same in the precision below,
which is the control of the comparison that decides `correct` (with TF32
switched off by the caller).

Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

_EXACT = 2**53


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Integers (any int dtype, or integral floats) mod 2^32, as int32."""
    if x.is_floating_point():
        x = torch.remainder(x, 2.0**32).to(torch.int64)
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _check_exact(dtype, digit_bound: int, terms: int, what: str):
    if dtype == torch.float64 and digit_bound * 2**31 * terms >= _EXACT:
        raise ValueError(f"{what}: {terms} terms of {digit_bound} x 2^31 "
                         "leave float64's exact integers")


def negacyclic_matrix(key: torch.Tensor, dtype) -> torch.Tensor:
    """key: int[..., R, C, N] -> the matrix [..., R*N, C*N] with
    (d @ M)[c*N + i] = sum_r (d_r * key[r, c])[i] mod (X^N + 1) for digit
    rows d: [..., R*N]. Entry [r*N + j, c*N + i] = key[r, c, i - j] for
    i >= j and -key[r, c, i - j + N] below."""
    n = key.shape[-1]
    kf = key.to(dtype)
    doubled = torch.cat([-kf, kf], dim=-1)  # index N + s holds key[s]
    windows = doubled.unfold(-1, n, 1)  # [..., R, C, N+1, N]: w[s] = d[s:s+N]
    rows = n - torch.arange(n, device=key.device)  # row j reads window N-j
    mat = windows.index_select(-2, rows)  # [..., R, C, N(j), N(i)]
    mat = mat.movedim(-3, -2)  # [..., R, N(j), C, N(i)]
    return mat.reshape(mat.shape[:-4] + (mat.shape[-4] * n,
                                         mat.shape[-2] * n))


def poly_mul(digits: torch.Tensor, key: torch.Tensor, dtype) -> torch.Tensor:
    """sum_r digits[..., r, :] * key[r, c, :] mod (X^N + 1) for every c:
    digits int[S, R, N], key int[R, C, N] -> int32[S, C, N]."""
    s, r, n = digits.shape
    out = digits.reshape(s, r * n).to(dtype) @ negacyclic_matrix(key, dtype)
    return wrap32(out.reshape(s, -1, n))


def mul_by_monomial(p: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """p[S, ..., N] * X^shift[S] mod (X^N + 1)."""
    n = p.shape[-1]
    doubled = torch.cat([p, wrap32(-p.to(torch.int64))], dim=-1)
    idx = torch.remainder(torch.arange(n, device=p.device)
                          - shift.to(torch.int64).reshape(
                              (-1,) + (1,) * (p.dim() - 1)), 2 * n)
    return torch.gather(doubled, -1, idx.expand(p.shape))


def reverse_polynomial(p: torch.Tensor) -> torch.Tensor:
    """p(X) -> p(1/X) mod (X^N + 1): out[0] = p[0], out[r] = -p[N - r]."""
    rolled = torch.roll(torch.flip(p, dims=(-1,)), 1, dims=-1).to(torch.int64)
    rolled[..., 1:] = -rolled[..., 1:]
    return wrap32(rolled)


def gadget(l: int, b: int) -> list:
    return [1 << (32 - (i + 1) * b) for i in range(l)]


def decompose(p: torch.Tensor, l: int, b: int,
              balanced: bool = False) -> torch.Tensor:
    """Signed base-2^b digits int64[..., l, N] in [-2^(b-1), 2^(b-1)),
    the gadget's offset trick (with the half-ulp rounding when
    `balanced`)."""
    offset = sum(gadget(l, b)) * (1 << (b - 1))
    if balanced and l * b < 32:
        offset += 1 << (31 - l * b)
    shifted = wrap32(p.to(torch.int64) + offset).to(torch.int64)
    shifts = torch.tensor([32 - (i + 1) * b for i in range(l)],
                          device=p.device)
    digits = (shifted.unsqueeze(-2) >> shifts[:, None]) & ((1 << b) - 1)
    return digits - (1 << (b - 1))


def mod_switch(words: torch.Tensor, two_n: int) -> torch.Tensor:
    """Round torus words to Z / 2N: (w + 2^(31 - log 2N)) >> (32 - log 2N)
    on int32, an arithmetic shift."""
    log2 = two_n.bit_length() - 1
    w = wrap32(words.to(torch.int64) + (1 << (32 - log2 - 1)))
    return w.to(torch.int64) >> (32 - log2)


def keyswitch_table(ks_a: torch.Tensor, ks_noise: torch.Tensor,
                    key_in: torch.Tensor, key_out: torch.Tensor,
                    b: int) -> torch.Tensor:
    """The keyswitch key's samples as rows (h, j, i) -> [a | body]:
    int32[(base-1) * l * n_in, n_out + 1], sample (h, j, i) encrypting
    key_in[i] * (h+1) * 2^(32 - (j+1)*b) under key_out.
    ks_a: int32[base-1, l, n_in, n_out]; ks_noise: int32[base-1, l, n_in]."""
    bm1, l, n_in, n_out = ks_a.shape
    dev = ks_a.device
    h = torch.arange(1, bm1 + 1, device=dev).reshape(bm1, 1, 1)
    g = torch.tensor(gadget(l, b), device=dev).reshape(1, l, 1)
    message = key_in.to(torch.int64).reshape(1, 1, n_in) * h * g
    dots = (ks_a.to(torch.int64) * key_out.to(torch.int64)).sum(-1)
    body = wrap32(message + ks_noise.to(torch.int64) + dots)
    table = torch.cat([ks_a, body.unsqueeze(-1)], dim=-1)
    return table.reshape(bm1 * l * n_in, n_out + 1)


def keyswitch(table: torch.Tensor, a: torch.Tensor, l: int, b: int,
              dtype) -> torch.Tensor:
    """sum over (i, j) of table[digit_ij - 1, j, i] for the nonzero digits
    of a[S, n_in] rounded to l*b bits: int32[S, n_out + 1]."""
    s, n_in = a.shape
    base = 1 << b
    _check_exact(dtype, 1, l * n_in, "keyswitch")
    rounded = wrap32(a.to(torch.int64) + (1 << (32 - (1 + b * l))))
    shifts = torch.tensor([32 - (j + 1) * b for j in range(l)],
                          device=a.device)
    digits = (rounded.to(torch.int64).unsqueeze(-2)
              >> shifts[:, None]) & (base - 1)  # [S, l, n_in]
    levels = torch.arange(1, base, device=a.device).reshape(1, base - 1, 1, 1)
    onehot = (digits.unsqueeze(1) == levels).to(dtype)  # [S, base-1, l, n_in]
    return wrap32(onehot.reshape(s, -1) @ table.to(dtype))


def cmux_rotate(acc: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                l: int, b: int, balanced: bool, dtype) -> torch.Tensor:
    """acc += key (x) [(X^bara - 1) * acc]: acc int32[S, K, N]; key
    int32[K*l, K, N] with rows (component j, digit i), j-major."""
    rot = mul_by_monomial(acc, bara)
    temp = wrap32(rot.to(torch.int64) - acc.to(torch.int64))
    digits = decompose(temp, l, b, balanced)  # [S, K, l, N]
    s, k1, _, n = digits.shape
    delta = poly_mul(digits.reshape(s, k1 * l, n), key, dtype)
    return wrap32(acc.to(torch.int64) + delta.to(torch.int64))


# --- single key (CGGI) ---


def tgsw_rows(gsw: torch.Tensor) -> torch.Tensor:
    """Raw TGSW samples int32[n, l, K(j), K(c), N] -> the external
    product's key int32[n, K*l, K, N], rows (j, i) j-major."""
    n, l, k1, _, nn = gsw.shape
    return gsw.permute(0, 2, 1, 3, 4).reshape(n, k1 * l, k1, nn)


class CggiReference:
    """The single-key bootstrap from raw material: raw = {"lwe_key",
    "tlwe_key", "gsw", "ks_a", "ks_noise"} (see `benchmark/inputs.py`),
    p = the configuration's numbers."""

    def __init__(self, p: dict, raw: dict, dtype=torch.float64):
        self.p, self.dtype = p, dtype
        self.key = tgsw_rows(raw["gsw"])
        n_rows = self.key.shape[1]
        _check_exact(dtype, 1 << (p["bs_log2_base"] - 1),
                     n_rows * p["tlwe_polynomial_degree"], "external product")
        self.table = keyswitch_table(raw["ks_a"], raw["ks_noise"],
                                     raw["tlwe_key"].reshape(-1),
                                     raw["lwe_key"], p["ks_log2_base"])

    def bootstrap(self, c_a, c_b, test_vector, barb_offset: int = 0,
                  q: int = 1):
        """LWE(test_vector[p]) with p = barb + barb_offset - <bara, s> mod
        2N, keyswitched: c_a int32[S, n], c_b int32[S], test_vector
        int32[S, N] -> int32 (a[S, n], b[S]). With q > 1 (many-LUT) the
        modulus switch rounds to the 2N/q grid and coefficients 0..q-1 of
        the rotated accumulator are extracted: (a[S, q, n], b[S, q])."""
        p, dtype = self.p, self.dtype
        n_poly, k = p["tlwe_polynomial_degree"], p["tlwe_mask_size"]
        bara = mod_switch(c_a, 2 * n_poly // q) * q  # [S, n]
        barb = mod_switch(c_b, 2 * n_poly // q) * q + barb_offset
        s = c_b.shape[0]
        acc = torch.zeros((s, k + 1, n_poly), dtype=torch.int32,
                          device=c_b.device)
        acc[:, k] = mul_by_monomial(test_vector, -barb)
        for step in range(self.key.shape[0]):
            acc = cmux_rotate(acc, bara[:, step], self.key[step],
                              p["bs_decomp_length"], p["bs_log2_base"],
                              p["gadget_balanced"], dtype)
        # coefficient r of acc is coefficient 0 of acc * X^-r
        acc = torch.stack([acc] + [mul_by_monomial(acc, torch.full(
            (s,), -r, device=c_b.device)) for r in range(1, q)], 1)
        ext_a = reverse_polynomial(acc[:, :, :k]).reshape(s * q, k * n_poly)
        ext_b = acc[:, :, k, 0].reshape(s * q)
        sums = keyswitch(self.table, ext_a, p["ks_decomp_length"],
                         p["ks_log2_base"], dtype)
        n_out = sums.shape[1] - 1
        out_a = wrap32(-sums[:, :n_out].to(torch.int64))
        out_b = wrap32(ext_b.to(torch.int64) - sums[:, n_out].to(torch.int64))
        if q == 1:
            return out_a, out_b
        return out_a.reshape(s, q, n_out), out_b.reshape(s, q)

    def nand(self, x_a, x_b, y_a, y_b):
        """NAND(x, y) = bootstrap((0, 1/8) - x - y) of the constant test
        polynomial 1/8: int32 (a[S, n], b[S])."""
        c_a = wrap32(-x_a.to(torch.int64) - y_a.to(torch.int64))
        c_b = wrap32((1 << 29) - x_b.to(torch.int64) - y_b.to(torch.int64))
        test = torch.full((c_b.shape[0], self.p["tlwe_polynomial_degree"]),
                          1 << 29, dtype=torch.int32, device=c_b.device)
        return self.bootstrap(c_a, c_b, test)


# --- multi-key (MK-TFHE) ---


def _conv_shared(polys: torch.Tensor, shared: torch.Tensor,
                 dtype) -> torch.Tensor:
    """polys[..., N] * shared[N] for each leading index, mod (X^N + 1)."""
    n = polys.shape[-1]
    flat = polys.reshape(-1, 1, n)
    return poly_mul(flat, shared.reshape(1, 1, n), dtype).reshape(polys.shape)


class MkReference:
    """The MK NAND gate bootstrap from raw material: raw = {"lwe_keys",
    "tlwe_keys", "shared_a", "pk_noise", "r", "c1", "f1", "ue_noise",
    "ks_a", "ks_noise"} (see `benchmark/inputs.py`). Works out the public
    keys, each party's uni-encryptions of its key bits, their expansion
    against every public key and the block operand of each step."""

    def __init__(self, p: dict, raw: dict, dtype=torch.float64):
        self.p, self.dtype = p, dtype
        l, b = p["bs_decomp_length"], p["bs_log2_base"]
        parties = raw["lwe_keys"].shape[0]
        k1 = parties + 1
        n_poly = p["tlwe_polynomial_degree"]
        _check_exact(dtype, 1 << (b - 1), k1 * l * n_poly,
                     "MK external product")
        exact = torch.float64  # the key material is the configuration's
        g = torch.tensor(gadget(l, b), device=raw["shared_a"].device)
        pk = torch.stack([
            wrap32(_conv_shared(raw["shared_a"], raw["tlwe_keys"][q], exact)
                   .to(torch.int64) + raw["pk_noise"][q].to(torch.int64))
            for q in range(parties)])  # [parties, l, N]
        self.steps = []
        for q in range(parties):
            self.steps.append(self._party_operands(q, parties, raw, pk, g,
                                                   exact))
        self.tables = [keyswitch_table(raw["ks_a"][q], raw["ks_noise"][q],
                                       raw["tlwe_keys"][q], raw["lwe_keys"][q],
                                       p["ks_log2_base"])
                       for q in range(parties)]
        self.parties = parties

    def _party_operands(self, q, parties, raw, pk, g, exact):
        """Party q's n steps as external-product keys int32[n, K*l, K, N]:
        rows (component j, digit i), columns the output components (the
        parties' masks, then the body)."""
        p = self.p
        l, b = p["bs_decomp_length"], p["bs_log2_base"]
        z = raw["tlwe_keys"][q]
        msg = raw["lwe_keys"][q].to(torch.int64)  # [n]
        r = raw["r"][q]  # [n, N]
        c1, f1 = raw["c1"][q], raw["f1"][q]  # [n, l, N]
        e_c0, e_d0, e_d1, e_f0 = (raw["ue_noise"][q, i].to(torch.int64)
                                  for i in range(4))
        n_lwe, n_poly = r.shape
        dev = r.device
        mg = torch.zeros((n_lwe, l, n_poly), dtype=torch.int64, device=dev)
        mg[:, :, 0] = msg[:, None] * g
        c0 = wrap32(e_c0 + _conv_shared(c1, z, exact).to(torch.int64) + mg)
        shared = raw["shared_a"].unsqueeze(0)
        d1 = wrap32(e_d1 + poly_mul(r.unsqueeze(1), shared,
                                    exact).to(torch.int64) + mg)
        d0 = wrap32(e_d0 + poly_mul(r.unsqueeze(1), pk[q].unsqueeze(0),
                                    exact).to(torch.int64))
        f0 = wrap32(e_f0 + _conv_shared(f1, z, exact).to(torch.int64)
                    + r.to(torch.int64).unsqueeze(1) * g[:, None])
        # expansion: x[j, i], y[j, i] for each party i (j the gadget row)
        x = torch.empty((n_lwe, l, parties, n_poly), dtype=torch.int32,
                        device=dev)
        y = torch.empty_like(x)
        for i in range(parties):
            if i == q:
                x[:, :, i], y[:, :, i] = d0, d1
                continue
            diff = wrap32(pk[i].to(torch.int64) - pk[q].to(torch.int64))
            dec = decompose(diff, l, b)  # [l(j), l(dec), N]
            key = dec.permute(1, 0, 2)  # rows: dec; columns: j
            x[:, :, i] = wrap32(d0.to(torch.int64)
                                + poly_mul(f0, key, exact).to(torch.int64))
            y[:, :, i] = poly_mul(f1, key, exact)
        k1 = parties + 1
        op = torch.zeros((n_lwe, k1, l, k1, n_poly), dtype=torch.int32,
                         device=dev)  # rows (j, l'), columns k
        for i in range(parties):
            if i != q:
                op[:, i, :, i] = y[:, :, q]
            op[:, i, :, q] = y[:, :, i]
            op[:, i, :, k1 - 1] = x[:, :, i]
        op[:, k1 - 1, :, q] = c1
        op[:, k1 - 1, :, k1 - 1] = c0
        return op.reshape(n_lwe, k1 * l, k1, n_poly)

    def nand(self, x_a, x_b, y_a, y_b):
        """NAND(x, y) = MK bootstrap((0, ..., 1/8) - x - y):
        x_a, y_a int32[S, parties, n] -> int32 (a[S, parties, n], b[S])."""
        p, dtype = self.p, self.dtype
        n_poly = p["tlwe_polynomial_degree"]
        parties = self.parties
        c_a = wrap32(-x_a.to(torch.int64) - y_a.to(torch.int64))
        c_b = wrap32((1 << 29) - x_b.to(torch.int64) - y_b.to(torch.int64))
        bara = mod_switch(c_a, 2 * n_poly)  # [S, parties, n]
        barb = mod_switch(c_b, 2 * n_poly)
        s = c_b.shape[0]
        acc = torch.zeros((s, parties + 1, n_poly), dtype=torch.int32,
                          device=c_b.device)
        test = torch.full((s, n_poly), 1 << 29, dtype=torch.int32,
                          device=c_b.device)
        acc[:, parties] = mul_by_monomial(test, -barb)
        for q in range(parties):
            for step, key in enumerate(self.steps[q]):
                acc = cmux_rotate(acc, bara[:, q, step], key,
                                  p["bs_decomp_length"], p["bs_log2_base"],
                                  p["gadget_balanced"], dtype)
        ext_a = reverse_polynomial(acc[:, :parties])  # [S, parties, N]
        out_b = acc[:, parties, 0].to(torch.int64)
        outs = []
        for q in range(parties):
            sums = keyswitch(self.tables[q], ext_a[:, q],
                             p["ks_decomp_length"], p["ks_log2_base"], dtype)
            n_out = sums.shape[1] - 1
            outs.append(wrap32(-sums[:, :n_out].to(torch.int64)))
            out_b = out_b - sums[:, n_out].to(torch.int64)
        return torch.stack(outs, dim=1), wrap32(out_b)


REFERENCES = {"cggi": CggiReference, "mktfhe": MkReference}


def reference_for(p: dict, raw: dict, dtype=torch.float64):
    """The reference of the configuration's scheme (`p["scheme"]`)."""
    return REFERENCES[p["scheme"]](p, raw, dtype)
