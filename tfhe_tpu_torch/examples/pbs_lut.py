"""Programmable bootstrapping: a lookup table evaluated under encryption.

    python -m tfhe_tpu_torch.examples.pbs_lut [--production] [--device cpu]

The twin of the reference's `examples/pbs_lut.py`. The blind rotation
evaluates an arbitrary S-entry function in ONE bootstrap by encoding the
table into the test polynomial. The client encrypts digits in [0, 4); the
server, holding only the cloud key, applies f and then g from plaintext
tables; the client decrypts g(f(m)). Outputs carry the same encoding, so
table evaluations chain (each bootstrap refreshes the noise). Toy
parameters by default; `--production` takes the 80-bit preset.
"""

import torch

from .. import api, pbs
from .. import params as presets
from . import example_args


def main(argv=None) -> int:
    production, dev = example_args(__doc__, argv)
    params = (presets.tfhe_parameters_80() if production
              else presets.tfhe_parameters_toy())
    gen = torch.Generator(device=dev).manual_seed(123)

    # [client] keys + encrypted digits
    secret_key, cloud_key = api.make_key_pair(gen, params)
    space = 4
    digits = torch.tensor([0, 1, 2, 3, 3, 1], dtype=torch.int32, device=dev)
    ct = pbs.encrypt_pbs(gen, secret_key, digits, space)

    # [server] two plaintext tables, applied under encryption: f a
    # permutation, g a lossy map
    f = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=dev)
    g = torch.tensor([1, 1, 0, 2], dtype=torch.int32, device=dev)
    bk, ks = cloud_key.bootstrap_key, cloud_key.keyswitch_key
    ct_f = pbs.programmable_bootstrap(bk, ks, f, ct, space)
    ct_gf = pbs.programmable_bootstrap(bk, ks, g, ct_f, space)

    # [client] decrypt and check
    got = pbs.decrypt_pbs(secret_key, ct_gf, space).cpu()
    want = g[f[digits]].cpu()
    print(f"digits     : {digits.tolist()}")
    print(f"g(f(m))    : {got.tolist()}")
    print(f"plaintext  : {want.tolist()}")
    assert torch.equal(got.to(want.dtype), want), "decryption mismatch"
    print("OK: two chained encrypted table evaluations decrypt correctly")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
