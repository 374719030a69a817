"""Wire formats: seeded keys and ciphertexts, and public-key encryption.

    python -m tfhe_tpu_torch.examples.wire_format [--production]
        [--device cpu]

The twin of the reference's `examples/wire_format.py`, the flow a
deployment runs: a client generates keys and ships the server a SEEDED
evaluation key (a fraction of the expanded size) and a seeded public key;
untrusted writers encrypt with the public key; the server computes on
gates; the client decrypts. The sizes printed are the bytes of the
artifacts as `utils.serialization.dumps` writes them. Toy parameters by
default; `--production` takes the 80-bit preset.
"""

import torch

from .. import api, compressed, public
from ..gates import gate_and
from .. import params as presets
from ..utils import serialization
from . import example_args


def seeded(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def main(argv=None) -> int:
    production, dev = example_args(__doc__, argv)
    params = (presets.tfhe_parameters_80() if production
              else presets.tfhe_parameters_toy())

    # [client] keygen: everything that travels is a seeded artifact
    sk = api.make_secret_key(seeded(dev, 0), params)
    seeded_ck = compressed.make_seeded_cloud_key(seeded(dev, 1), sk)
    seeded_pk = public.make_public_key_seeded(seeded(dev, 2), sk)
    ck_wire = serialization.dumps(seeded_ck)
    pk_wire = serialization.dumps(seeded_pk)

    # [server] expand once into the baked form
    ck = compressed.expand_cloud_key(serialization.loads(ck_wire, dev))
    full_ck_bytes = len(serialization.dumps(ck))
    print(f"evaluation key wire: {len(ck_wire):,} B "
          f"(expanded serialized: {full_ck_bytes:,} B, "
          f"{full_ck_bytes / len(ck_wire):.0f}x)")

    # [any writer] encrypt with the public key: no secret key involved
    pk = public.expand_public_key(serialization.loads(pk_wire, dev))
    full_pk = public.make_public_key(seeded(dev, 2), sk)
    print(f"public key wire: {len(pk_wire):,} B "
          f"(unseeded: {len(serialization.dumps(full_pk)):,} B)")
    xs = torch.tensor([True, True, False, False], device=dev)
    ys = torch.tensor([True, False, True, False], device=dev)
    ct_x = public.encrypt_public(seeded(dev, 3), pk, xs)
    ct_y = public.encrypt_public(seeded(dev, 4), pk, ys)

    # [client] a seeded ciphertext batch: one torus word a bit
    seeded_bits = compressed.encrypt_seeded(seeded(dev, 5), sk, xs)
    bit_wire = serialization.dumps(seeded_bits)
    full_bits = serialization.dumps(compressed.expand_lwe(seeded_bits))
    print(f"4-bit ciphertext wire: {len(bit_wire):,} B "
          f"(unseeded: {len(full_bits):,} B)")

    # [server] compute; [client] decrypt
    out = api.decrypt(sk, gate_and(ck, ct_x, ct_y))
    want = xs & ys
    print(f"AND over public-key inputs: {out.tolist()} "
          f"(expected {want.tolist()})")
    assert torch.equal(out, want)
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
