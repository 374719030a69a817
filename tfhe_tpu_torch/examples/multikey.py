"""2-party multi-key NAND: the MK ceremony example.

    python -m tfhe_tpu_torch.examples.multikey [--production] [--device cpu]

The twin of the reference's `examples/multikey.py` (a port of the
reference library's examples/multikey.jl): each party holds its own
secret key; the server assembles an evaluation key from the parties'
public contributions and evaluates NAND on jointly encrypted bits; then
distributed decryption, where no secret key leaves its party. Toy
parameters by default; `--production` takes the reference-fidelity
2-party preset (`mktfhe_parameters_2party`, ~1.5% of its gates fail by
design: docs/mk_noise_budget.md).
"""

import torch

from .. import api, mk
from . import example_args


def main(argv=None) -> int:
    production, dev = example_args(__doc__, argv)
    parties = 2
    params = (mk.mktfhe_parameters_2party() if production
              else mk.mktfhe_parameters_toy(parties))
    gen = torch.Generator(device=dev).manual_seed(0)

    # [server] the shared key
    shared_key = mk.make_shared_key(gen, params)

    # [each party, independently] secret key + cloud key part
    secret_keys, parts = [], []
    for _ in range(parties):
        sk = api.make_secret_key(gen, params)
        secret_keys.append(sk)
        parts.append(mk.make_cloud_key_part(gen, sk, shared_key))

    # [server] assembly: only public material crosses this boundary
    cloud_key = mk.make_mk_cloud_key(parts)

    trials = 10
    m1 = torch.rand(trials, generator=gen, device=dev) < 0.5
    m2 = ~m1
    enc1 = mk.mk_encrypt(gen, secret_keys, m1)
    enc2 = mk.mk_encrypt(gen, secret_keys, m2)

    enc_out = mk.mk_gate_nand(cloud_key, enc1, enc2)
    out = mk.mk_decrypt(secret_keys, enc_out)
    want = ~(m1 & m2)
    for t in range(trials):
        print(f"Trial {t}: {bool(m1[t])} NAND {bool(m2[t])} = "
              f"{bool(out[t])}")
    assert torch.equal(out, want)
    print("all trials correct")

    # Distributed decryption: each party publishes one smudged share and
    # anyone combines them. A BOOTSTRAPPED 2-party ciphertext carries
    # ~0.05 phase noise, so smudging-lemma flooding is impossible on the
    # 32-bit torus; the explicit stddev floods at the fresh-encryption
    # scale (see `mk_partial_decrypt`).
    shares = [
        mk.mk_partial_decrypt(
            torch.Generator(device=dev).manual_seed(900 + p),
            secret_keys[p], enc_out, p, smudging_stddev=2.0**-15)
        for p in range(parties)
    ]
    dist = mk.mk_combine_shares(enc_out, shares)
    assert torch.equal(dist, want)
    print("distributed decryption matches")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
