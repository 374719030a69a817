"""Core-SVP security estimates for every shipped parameter preset.

The twin of the reference's `tools/security_estimate.py` on the port's
presets (`tfhe_tpu_torch.params`, `tfhe_tpu_torch.mk`, the same field
names): the same formulas, so each preset rates to the same bits.
`python -m tfhe_tpu_torch.bench` prints the benchmarked preset's figure
(`security_core_svp_bits`) beside its throughput.

Model (named, standard, published):

* **Core-SVP** (Alkim-Ducas-Poppelmann-Schwabe, "Post-quantum key exchange
  - a new hope", USENIX 2016, section 6): the cost of BKZ with block size
  b is the cost of ONE call to an SVP oracle in dimension b, rated at
  2^(0.292 b) classically (BDGL16 sieving) and 2^(0.265 b) quantumly
  (Laarhoven). Polynomial factors and the number of BKZ tours are ignored
  (conservative for the defender).
* **Primal (uSVP)** attack via the Bai-Galbraith embedding with secret
  rebalancing for the binary secret: BKZ-b succeeds on the embedded
  lattice of dimension d = m + n + 1 and volume q^m * xi^n
  (xi = sigma/s_s, s_s = 1/2 for uniform binary) iff

      sigma * sqrt(b) <= delta(b)^(2b - d - 1) * (q^m * xi^n)^(1/d)

  (the ADPS16 section 6.3 win condition).
* **Dual** distinguishing attack: a short (x, y) in
  L = {(x, y) in Z^(m+n) : A^T x = y mod q}, the secret coordinates
  rescaled by 1/xi; BKZ-b finds ell = delta^(d-1) * Vol^(1/d), the
  advantage is eps = exp(-2 pi^2 tau^2) with tau = ell * sigma / q, and the
  attack repeats ~1/eps^2 times, amortized by the 2^(0.2075 b) short
  vectors one sieve outputs.
* delta(b) = ((pi b)^(1/b) * b / (2 pi e))^(1/(2(b-1))) (Chen13).

Both attacks are optimized over the number of samples m and the block
size b; an instance costs the MINIMUM over attacks, and a preset the
minimum over its instances: the LWE key (dimension n, the smaller of the
fresh and keyswitch noise) and the ring key (dimension k*N, the bootstrap
key's noise; a module-LWE instance rated as unstructured LWE).

    python -m tfhe_tpu_torch.tools.security_estimate   # the markdown table
"""

from __future__ import annotations

import math
from dataclasses import dataclass

LOG2_Q = 32  # Torus32: everything lives mod 2^32 (src/numeric-functions.jl:1)
SECRET_STDDEV = 0.5  # uniform binary secret (src/lwe.jl:10-13, tlwe.jl:15-20)

C_CLASSICAL = 0.292  # BDGL16 sieve, log2 cost per SVP-b call
C_QUANTUM = 0.265  # Laarhoven quantum sieve
C_SIEVE_OUTPUTS = 0.2075  # log2 #short-vectors one sieve call yields


def log2_delta(b: int) -> float:
    """log2 of the root Hermite factor of BKZ with block size b (Chen13)."""
    if b < 50:
        raise ValueError("asymptotic delta(b) needs b >= 50")
    return math.log2((math.pi * b) ** (1.0 / b) * b / (2 * math.pi * math.e)) \
        / (2.0 * (b - 1))


@dataclass(frozen=True)
class Instance:
    """One attacker-visible LWE instance: dimension n, modulus 2^32,
    binary secret, discrete-Gaussian-ish noise of absolute stddev sigma."""

    name: str
    n: int
    sigma: float  # absolute (units of torus steps, i.e. stddev_frac * 2^32)


def primal_bits(inst: Instance, quantum: bool = False,
                m_max: int = 4096, b_max: int = 1400) -> float:
    """Minimum log2 cost of the primal uSVP attack over (m, b)."""
    import numpy as np

    n = inst.n
    log2_sigma = math.log2(inst.sigma)
    # Bai-Galbraith rebalance: scale secret columns by xi = sigma / s_s
    # (secret small relative to noise -> heavier secret columns, larger
    # volume, easier attack; ADPS16/Kyber-script convention).
    log2_xi = log2_sigma - math.log2(SECRET_STDDEV)
    c = C_QUANTUM if quantum else C_CLASSICAL

    m = np.arange(1, m_max + 1, dtype=np.float64)
    d = m + n + 1
    log2_vol = m * LOG2_Q + n * log2_xi
    best = math.inf
    for b in range(50, b_max + 1):
        cost = c * b
        if cost >= best:
            break
        ld = log2_delta(b)
        lhs = log2_sigma + 0.5 * math.log2(b)
        rhs = (2 * b - d - 1) * ld + log2_vol / d
        if np.any(lhs <= rhs):
            best = cost
    return best


def dual_bits(inst: Instance, quantum: bool = False,
              m_max: int = 4096, b_max: int = 1400) -> float:
    """Minimum log2 cost of the dual distinguishing attack over (m, b)."""
    import numpy as np

    n = inst.n
    log2_sigma = math.log2(inst.sigma)
    log2_xi = log2_sigma - math.log2(SECRET_STDDEV)
    c = C_QUANTUM if quantum else C_CLASSICAL

    m = np.arange(1, m_max + 1, dtype=np.float64)
    d = m + n
    # det of the rescaled dual lattice: q^n / xi^n (secret coords shrunk
    # by 1/xi so BKZ equalizes the x.e and y.s error contributions).
    log2_vol = n * (LOG2_Q - log2_xi)
    best = math.inf
    for b in range(50, b_max + 1):
        if c * b >= best:
            break
        ld = log2_delta(b)
        log2_ell = (d - 1) * ld + log2_vol / d
        log2_tau = np.minimum(log2_ell + log2_sigma - LOG2_Q, 16.0)
        tau = 2.0**log2_tau
        # eps = exp(-2 pi^2 tau^2); repeats = 1/eps^2, amortized by the
        # 2^(0.2075 b) vectors one sieve emits.
        log2_eps = -2 * math.pi**2 * tau**2 / math.log(2)
        repeats = np.maximum(0.0, -2 * log2_eps - C_SIEVE_OUTPUTS * b)
        cost = c * b + float(repeats.min())
        if cost < best:
            best = cost
    return best


def instance_bits(inst: Instance, quantum: bool = False) -> float:
    return min(primal_bits(inst, quantum), dual_bits(inst, quantum))


def preset_instances(params) -> list[Instance]:
    """The attacker-visible LWE instances of a SchemeParameters preset."""
    q = 2.0**LOG2_Q
    sigma_lwe = min(params.lwe_noise_stddev, params.ks_noise_stddev) * q
    sigma_ring = params.bs_noise_stddev * q
    return [
        Instance("lwe", params.lwe_size, sigma_lwe),
        Instance("ring", params.tlwe_mask_size * params.tlwe_polynomial_degree,
                 sigma_ring),
    ]


def estimate_preset(params, quantum: bool = False) -> dict:
    """Per-instance and overall (min) core-SVP cost in bits."""
    out = {}
    for inst in preset_instances(params):
        out[inst.name] = {
            "n": inst.n,
            "log2_sigma_frac": math.log2(inst.sigma) - LOG2_Q,
            "primal": primal_bits(inst, quantum),
            "dual": dual_bits(inst, quantum),
        }
        out[inst.name]["bits"] = min(out[inst.name]["primal"],
                                     out[inst.name]["dual"])
    out["bits"] = min(v["bits"] for v in out.values() if isinstance(v, dict))
    return out


def shipped_presets() -> dict:
    """The presets the reference rates, by the reference's labels."""
    from .. import params as p
    from ..mk import api as mk_api

    return {
        "80 (reference, src/api.jl:30-45)": p.tfhe_parameters_80(),
        "128 (reference, src/api.jl:55-69)": p.tfhe_parameters_128(),
        "128_fast (TPU retune, k=4 N=256)": p.tfhe_parameters_128_fast(),
        "128_pbs (TPU retune, k=2 N=512)": p.tfhe_parameters_128_pbs(),
        "128_radix (TPU retune, ks l4b4)": p.tfhe_parameters_128_radix(),
        "128_radix_reliable (TPU retune)":
            p.tfhe_parameters_128_radix_reliable(),
        "mk 2party (src/mk_api.jl:4-10)": mk_api.mktfhe_parameters_2party(),
        "mk 2party_lownoise (TPU)": mk_api.mktfhe_parameters_2party_lownoise(),
        "mk 4party (src/mk_api.jl:14-20)": mk_api.mktfhe_parameters_4party(),
        "mk 8party (src/mk_api.jl:24-34)": mk_api.mktfhe_parameters_8party(),
    }


def main():
    rows = []
    for name, params in shipped_presets().items():
        est_c = estimate_preset(params, quantum=False)
        est_q = estimate_preset(params, quantum=True)
        lwe, ring = est_c["lwe"], est_c["ring"]
        rows.append(
            f"| {name} | ({lwe['n']}, 2^{lwe['log2_sigma_frac']:.1f})"
            f" | {lwe['primal']:.0f}/{lwe['dual']:.0f}"
            f" | ({ring['n']}, 2^{ring['log2_sigma_frac']:.1f})"
            f" | {ring['primal']:.0f}/{ring['dual']:.0f}"
            f" | **{est_c['bits']:.0f}** | {est_q['bits']:.0f} |"
        )
    print("| Preset | LWE inst (n, sigma) | LWE primal/dual"
          " | Ring inst (n, sigma) | ring primal/dual"
          " | classical bits | quantum bits |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(r)


if __name__ == "__main__":
    main()
