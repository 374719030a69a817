"""Radix-mode encrypted arithmetic: min, add and compare of 16-bit words.

    python -m tfhe_tpu_torch.examples.radix_arithmetic [--production]
        [--device cpu]

The twin of the reference's `examples/radix_arithmetic.py`: words are
base-4 digit vectors in the programmable-bootstrapping encoding
(`radix.py`), so a minimum costs ~2 blind rotations a bit instead of the
bit-level comparator chain's gate bootstraps, and an add exactly one
rotation a bit. Toy parameters by default; `--production` takes the
reference's 128-bit preset (`tfhe_parameters_128`).
"""

import torch

from .. import api, pbs, radix
from .. import params as presets
from . import example_args


def main(argv=None) -> int:
    production, dev = example_args(__doc__, argv)
    params = (presets.tfhe_parameters_128() if production
              else presets.tfhe_parameters_toy())
    gen = torch.Generator(device=dev).manual_seed(321)

    # [client] key generation + encryption (16-bit words -> 8 base-4 digits)
    secret_key, cloud_key = api.make_key_pair(gen, params)
    a_plain, b_plain = 2017, 42
    ct_a = radix.encrypt_radix(gen, secret_key,
                               torch.tensor(a_plain, device=dev), 16)
    ct_b = radix.encrypt_radix(gen, secret_key,
                               torch.tensor(b_plain, device=dev), 16)

    # [server] homomorphic ops: sees only ciphertexts + the cloud key
    ct_min = radix.radix_min(cloud_key, ct_a, ct_b)
    ct_sum = radix.radix_add(cloud_key, ct_a, ct_b)
    ct_geq = radix.radix_geq(cloud_key, ct_a, ct_b)

    # [client] decryption
    got_min = int(radix.decrypt_radix(secret_key, ct_min))
    got_sum = int(radix.decrypt_radix(secret_key, ct_sum))
    got_geq = int(pbs.decrypt_pbs(secret_key, ct_geq, radix.SPACE))
    print(f"min({a_plain}, {b_plain}) = {got_min}")
    print(f"{a_plain} + {b_plain} = {got_sum} (mod 2^16)")
    print(f"[{a_plain} >= {b_plain}] = {got_geq}")
    assert got_min == min(a_plain, b_plain)
    assert got_sum == (a_plain + b_plain) % 65536
    assert got_geq == int(a_plain >= b_plain)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
