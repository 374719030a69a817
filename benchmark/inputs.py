"""Every input of a run, drawn from its seed in plain torch.

The keys and the raw key material of a configuration (`draw_keys`), the
ciphertexts of its traffic's phases (`encrypt`; the unit of work encodes
its plaintexts as phases) and the decryption back to phases (`phase`). One
`torch.Generator` on the run's device, seeded with `--seed`, draws them in
a few large calls, so the same seed gives the same inputs on that device.
The program receives the raw material (`benchmark/system.py`), and the
reference (`benchmark/reference/`) works everything else out from it
again.

Noise: N(0, sigma^2) on the torus, drawn in float64 and rounded to the
nearest 2^-32.
"""

from __future__ import annotations

import torch

from .reference.tfhe import gadget, poly_mul, wrap32


def _bits(gen, shape):
    return torch.randint(0, 2, shape, dtype=torch.int32, generator=gen,
                         device=gen.device)


def _uniform(gen, shape):
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32,
                         generator=gen, device=gen.device)


def _noise(gen, sigma: float, shape):
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    device=gen.device)
    return wrap32(torch.round(x * (sigma * 2.0**32)))


def _ks_raw(gen, p: dict, n_in: int, n_out: int, lead=()):
    base = 1 << p["ks_log2_base"]
    l = p["ks_decomp_length"]
    return (_uniform(gen, lead + (base - 1, l, n_in, n_out)),
            _noise(gen, p["ks_noise_stddev"], lead + (base - 1, l, n_in)))


def draw_keys(p: dict, gen: torch.Generator) -> dict:
    """The configuration's secret keys and raw key material (int32).

    cggi: lwe_key [n], tlwe_key [k, N], gsw [n, l, K, K, N] (TGSW samples
    of the LWE key bits: rows (i, j) encrypt zero under the TLWE key, plus
    bit * 2^(32-(i+1)b) on the constant coefficient of component j), ks_a
    [base-1, l_ks, k*N, n] and ks_noise [base-1, l_ks, k*N].
    mktfhe: per party lwe_keys [P, n], tlwe_keys [P, N]; the shared
    shared_a [l, N]; pk_noise [P, l, N]; the uni-encryptions' draws r [P,
    n, N] (binary), c1, f1 [P, n, l, N] and ue_noise [P, 4, n, l, N] (c0,
    d0, d1, f0); ks_a [P, base-1, l_ks, N, n], ks_noise [P, base-1, l_ks,
    N]."""
    n, nn = p["lwe_size"], p["tlwe_polynomial_degree"]
    l = p["bs_decomp_length"]
    if p["scheme"] == "cggi":
        k = p["tlwe_mask_size"]
        lwe_key = _bits(gen, (n,))
        tlwe_key = _bits(gen, (k, nn))
        masks = _uniform(gen, (n, l, k + 1, k, nn))
        noise = _noise(gen, p["bs_noise_stddev"], (n, l, k + 1, nn))
        body = poly_mul(masks.reshape(-1, k, nn), tlwe_key.unsqueeze(1),
                        torch.float64).reshape(n, l, k + 1, nn)
        body = wrap32(body.to(torch.int64) + noise.to(torch.int64))
        gsw = torch.cat([masks, body.unsqueeze(-2)], dim=-2).to(torch.int64)
        g = torch.tensor(gadget(l, p["bs_log2_base"]), device=gen.device)
        for j in range(k + 1):
            gsw[:, :, j, j, 0] += lwe_key.to(torch.int64)[:, None] * g
        ks_a, ks_noise = _ks_raw(gen, p, k * nn, n)
        return dict(lwe_key=lwe_key, tlwe_key=tlwe_key, gsw=wrap32(gsw),
                    ks_a=ks_a, ks_noise=ks_noise)
    parties = p["parties"]
    lwe_keys = _bits(gen, (parties, n))
    tlwe_keys = _bits(gen, (parties, nn))
    ks_a, ks_noise = _ks_raw(gen, p, nn, n, (parties,))
    sigma = p["bs_noise_stddev"]
    return dict(
        lwe_keys=lwe_keys, tlwe_keys=tlwe_keys,
        shared_a=_uniform(gen, (l, nn)),
        pk_noise=_noise(gen, sigma, (parties, l, nn)),
        r=_bits(gen, (parties, n, nn)),
        c1=_uniform(gen, (parties, n, l, nn)),
        f1=_uniform(gen, (parties, n, l, nn)),
        ue_noise=_noise(gen, sigma, (parties, 4, n, l, nn)),
        ks_a=ks_a, ks_noise=ks_noise)


def encrypt(p: dict, keys: dict, phases: torch.Tensor,
            gen: torch.Generator):
    """Fresh encryptions of the torus phases[...] (int32): int32 (a, b)
    with a [..., n] (cggi) or [..., P, n] (mktfhe) and b [...]."""
    mu = phases.to(gen.device, torch.int64)
    noise = _noise(gen, p["lwe_noise_stddev"], tuple(phases.shape))
    if p["scheme"] == "cggi":
        key = keys["lwe_key"]
        a = _uniform(gen, tuple(phases.shape) + (p["lwe_size"],))
        dots = (a.to(torch.int64) * key.to(torch.int64)).sum(-1)
    else:
        key = keys["lwe_keys"]
        a = _uniform(gen, tuple(phases.shape) + tuple(key.shape))
        dots = (a.to(torch.int64) * key.to(torch.int64)).sum((-1, -2))
    return a, wrap32(mu + noise.to(torch.int64) + dots)


def phase(p: dict, keys: dict, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Decryption to the phase b - <a, s> (int32[...])."""
    key = keys["lwe_key" if p["scheme"] == "cggi" else "lwe_keys"]
    dims = (-1,) if p["scheme"] == "cggi" else (-1, -2)
    dots = (a.to(torch.int64) * key.to(a.device, torch.int64)).sum(dims)
    return wrap32(b.to(torch.int64) - dots)
