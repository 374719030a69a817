"""Multi-tenant serving: many tenants' keys resident on one card.

    python -m tfhe_tpu_torch.examples.multitenant [--production]
        [--device cpu]

The twin of the reference's `examples/multitenant.py`. The baked
bootstrap key is the throughput form, T=128 times the prepared bytes
(6.2 GB at `tfhe_parameters_128_fast`). The COMPACT form
(`tuning.bs_bake_budget=0`) keeps each tenant's key as prepared limbs and
expands each blind-rotation step's operand at gate time, so many tenants'
keys fit one card. This prints the compact key's bytes and how many such
tenants an 80 GB card holds at a 75% budget (the reference's budget,
which it applied to a 16 GB chip), then serves one NAND per tenant under
its own key. Toy parameters (3 tenants) by default; `--production` takes
128_fast with 4 tenants.
"""

import time

import torch

from .. import api, gates, tuning
from .. import params as presets
from ..utils.entry import barrier
from . import example_args

CARD_BYTES = 80 * 2**30
BUDGET = 0.75


def main(argv=None) -> int:
    production, dev = example_args(__doc__, argv)
    params = (presets.tfhe_parameters_128_fast() if production
              else presets.tfhe_parameters_toy())
    tenants = 4 if production else 3

    # each tenant's key pair; the server keeps the compact evaluation key
    keys = []
    with tuning.override(bs_bake_budget=0):
        for i in range(tenants):
            gen = torch.Generator(device=dev).manual_seed(1000 + i)
            keys.append(api.make_key_pair(gen, params))
    bk = keys[0][1].bootstrap_key
    assert bk.compact
    key_bytes = bk.baked.numel()  # int8
    ks_bytes = keys[0][1].keyswitch_key.table_limbs.numel()
    per_tenant = key_bytes + ks_bytes
    print(f"compact evaluation key: {key_bytes / 2**20:.1f} MB bootstrap "
          f"+ {ks_bytes / 2**20:.1f} MB keyswitch per tenant")
    print(f"-> ~{int(CARD_BYTES * BUDGET / per_tenant)} tenants per 80 GB "
          f"card ({BUDGET:.0%} budget)")

    # serve one gate per tenant, each under its own key
    for i, (sk, ck) in enumerate(keys):
        bits_x = torch.tensor([True, False], device=dev)
        bits_y = torch.tensor([True, True], device=dev)
        gen = torch.Generator(device=dev).manual_seed(2 * i)
        cx = api.encrypt(gen, sk, bits_x)
        cy = api.encrypt(gen, sk, bits_y)
        barrier(dev)
        t0 = time.perf_counter()
        out = gates.gate_nand(ck, cx, cy)
        barrier(dev)
        ms = (time.perf_counter() - t0) * 1e3
        dec = api.decrypt(sk, out)
        want = ~(bits_x & bits_y)
        status = "ok" if torch.equal(dec, want) else "WRONG"
        print(f"tenant {i}: NAND {dec.tolist()} [{status}] ({ms:.1f} ms, "
              f"the first call of a tenant)")
        assert torch.equal(dec, want)

    print("multi-tenant serving round-trip: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
