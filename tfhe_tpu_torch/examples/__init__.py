"""The reference's examples on the port, one module each:

    python -m tfhe_tpu_torch.examples.<name> [--production] [--device cpu]

`tutorial` (encrypted minimum of two 16-bit words), `pbs_lut` (lookup
tables under encryption), `radix_arithmetic` (radix min/add/compare),
`multikey` (the 2-party ceremony and distributed decryption),
`wire_format` (seeded keys, public-key encryption, the file format) and
`multitenant` (compact keys of several tenants on one card). Toy
parameters by default; `--production` takes the example's real preset.
Each checks its results and fails (non-zero exit) on a wrong one.
"""

from __future__ import annotations

import argparse

import torch

from ..utils.entry import add_device_argument, entry_device


def example_args(doc: str, argv=None) -> tuple[bool, torch.device]:
    """(production, device) from an example's command line."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--production", action="store_true",
                    help="the example's real preset (default: toy)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    return args.production, entry_device(args.device)
