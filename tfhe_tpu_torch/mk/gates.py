"""Multi-key bootstrapped gates, batched.

Counterpart of `tfhe_tpu/mk/gates.py`. The affine-plus-bootstrap structure
is the single-key gate library's (`gates.py`), on MK-LWE samples with
message +-1/8: every two-input gate is one affine combination plus one MK
bootstrap with mu = 1/8. Every bootstrapped gate runs in a `tfhe.gate`
span (`instrument.spanned`).
"""

from __future__ import annotations

from ..instrument import spanned
from ..numeric import encode_message
from .api import MKCloudKey
from .internals import (
    MKLweSample,
    mk_bootstrap,
    mk_bootstrap_wo_keyswitch,
    mk_keyswitch,
    mk_lwe_noiseless_trivial,
)

_MU = encode_message(1, 8)  # +1/8
_NEG_MU = encode_message(-1, 8)  # -1/8
_QUARTER = encode_message(1, 4)  # +1/4
_NEG_QUARTER = encode_message(-1, 4)  # -1/4
_gate = spanned("tfhe.gate")


def _trivial(mu: int, ck: MKCloudKey, x: MKLweSample) -> MKLweSample:
    return mk_lwe_noiseless_trivial(mu, x.n, ck.parties, x.b.shape,
                                    x.a.device)


def _bootstrap(ck: MKCloudKey, result: MKLweSample,
               segments: int = 1) -> MKLweSample:
    return mk_bootstrap(ck.bootstrap_key, ck.keyswitch_keys, _MU, result,
                        segments)


@_gate
def mk_gate_nand(ck: MKCloudKey, x: MKLweSample, y: MKLweSample,
                 segments: int = 1) -> MKLweSample:
    """NAND = mk_bootstrap(1/8 - x - y). `segments` is accepted for the
    reference's signature (see `mk_blind_rotate`)."""
    return _bootstrap(ck, _trivial(_MU, ck, x) - x - y, segments)


@_gate
def mk_gate_and(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    """AND = mk_bootstrap(-1/8 + x + y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, ck, x) + x + y)


@_gate
def mk_gate_or(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    """OR = mk_bootstrap(1/8 + x + y)."""
    return _bootstrap(ck, _trivial(_MU, ck, x) + x + y)


def mk_gate_not(ck: MKCloudKey, x: MKLweSample) -> MKLweSample:
    """NOT = negation; no bootstrap needed."""
    return -x


@_gate
def mk_gate_xor(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    """XOR = mk_bootstrap(1/4 + 2(x + y)). The doubling doubles the input
    noise, so XOR and XNOR fail more often than NAND where the margin is
    thin (the reference-fidelity 2-party preset)."""
    return _bootstrap(ck, _trivial(_QUARTER, ck, x) + (x + y) * 2)


@_gate
def mk_gate_xnor(ck: MKCloudKey, x: MKLweSample,
                 y: MKLweSample) -> MKLweSample:
    """XNOR = mk_bootstrap(-1/4 - 2(x + y))."""
    return _bootstrap(ck, _trivial(_NEG_QUARTER, ck, x) - (x + y) * 2)


@_gate
def mk_gate_nor(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    """NOR = mk_bootstrap(-1/8 - x - y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, ck, x) - x - y)


@_gate
def mk_gate_andny(ck: MKCloudKey, x: MKLweSample,
                  y: MKLweSample) -> MKLweSample:
    """AND(NOT(x), y) = mk_bootstrap(-1/8 - x + y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, ck, x) - x + y)


@_gate
def mk_gate_andyn(ck: MKCloudKey, x: MKLweSample,
                  y: MKLweSample) -> MKLweSample:
    """AND(x, NOT(y)) = mk_bootstrap(-1/8 + x - y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, ck, x) + x - y)


@_gate
def mk_gate_orny(ck: MKCloudKey, x: MKLweSample,
                 y: MKLweSample) -> MKLweSample:
    """OR(NOT(x), y) = mk_bootstrap(1/8 - x + y)."""
    return _bootstrap(ck, _trivial(_MU, ck, x) - x + y)


@_gate
def mk_gate_oryn(ck: MKCloudKey, x: MKLweSample,
                 y: MKLweSample) -> MKLweSample:
    """OR(x, NOT(y)) = mk_bootstrap(1/8 + x - y)."""
    return _bootstrap(ck, _trivial(_MU, ck, x) + x - y)


@_gate
def mk_gate_mux(ck: MKCloudKey, x: MKLweSample, y: MKLweSample,
                z: MKLweSample) -> MKLweSample:
    """MUX(x, y, z) = x ? y : z via 2 MK blind rotations and 1 MK
    keyswitch; the intermediate sums stay in the extracted space."""
    bk, ks = ck.bootstrap_key, ck.keyswitch_keys
    u1 = mk_bootstrap_wo_keyswitch(bk, _MU, _trivial(_NEG_MU, ck, x) + x + y)
    u2 = mk_bootstrap_wo_keyswitch(bk, _MU, _trivial(_NEG_MU, ck, x) - x + z)
    t3 = mk_lwe_noiseless_trivial(_MU, u1.n, ck.parties, u1.b.shape,
                                  u1.a.device) + u1 + u2
    return mk_keyswitch(ks, t3)
