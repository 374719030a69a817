"""Encrypted minimum of two 16-bit integers: the tutorial example.

    python -m tfhe_tpu_torch.examples.tutorial [--production] [--device cpu]

The twin of the reference's `examples/tutorial.py` (itself a port of the
reference library's examples/tutorial.jl): the client makes a key pair
and encrypts two 16-bit words; the server computes min(a, b) under
encryption through an XNOR/MUX comparator chain; the client decrypts.
Toy parameters by default; `--production` takes the 80-bit preset.
"""

import torch

from .. import api, circuits
from .. import params as presets
from . import example_args


def main(argv=None) -> int:
    production, dev = example_args(__doc__, argv)
    params = (presets.tfhe_parameters_80() if production
              else presets.tfhe_parameters_toy())
    gen = torch.Generator(device=dev).manual_seed(123)

    # [client] key generation + encryption
    secret_key, cloud_key = api.make_key_pair(gen, params)
    a_plain, b_plain = 2017, 42
    ct_a = circuits.encrypt_word(gen, secret_key,
                                 torch.tensor(a_plain, device=dev), 16)
    ct_b = circuits.encrypt_word(gen, secret_key,
                                 torch.tensor(b_plain, device=dev), 16)

    # [server] homomorphic minimum: sees only ciphertexts + the cloud key
    ct_min = circuits.encrypted_minimum(cloud_key, ct_a, ct_b)

    # [client] decryption
    answer = int(circuits.decrypt_word(secret_key, ct_min))
    print(f"min({a_plain}, {b_plain}) = {answer}")
    assert answer == min(a_plain, b_plain)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
