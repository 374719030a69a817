"""Bootstrapped boolean gates, batched.

Counterpart of `tfhe_tpu/gates.py`. Inputs and outputs are LWE samples
with message +-1/8 (positive phase is `true`). Every two-input gate is one
affine combination plus one bootstrap with mu = 1/8.
"""

from __future__ import annotations

import torch

from .api import CloudKey
from .bootstrap import bootstrap, bootstrap_wo_keyswitch
from .keyswitch import keyswitch
from .lwe import LweSample, lwe_noiseless_trivial
from .numeric import encode_message

_MU = encode_message(1, 8)  # +1/8
_NEG_MU = encode_message(-1, 8)  # -1/8
_QUARTER = encode_message(1, 4)  # +1/4
_NEG_QUARTER = encode_message(-1, 4)  # -1/4


def _trivial(mu: int, x: LweSample) -> LweSample:
    return lwe_noiseless_trivial(mu, x.n, x.batch_shape, x.a.device)


def _bootstrap(ck: CloudKey, result: LweSample) -> LweSample:
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _MU, result)


def gate_nand(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """NAND = bootstrap(1/8 - x - y)."""
    return _bootstrap(ck, _trivial(_MU, x) - x - y)


def gate_or(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """OR = bootstrap(1/8 + x + y)."""
    return _bootstrap(ck, _trivial(_MU, x) + x + y)


def gate_and(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """AND = bootstrap(-1/8 + x + y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) + x + y)


def gate_xor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """XOR = bootstrap(1/4 + 2(x + y))."""
    return _bootstrap(ck, _trivial(_QUARTER, x) + (x + y) * 2)


def gate_xnor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """XNOR = bootstrap(-1/4 - 2(x + y))."""
    return _bootstrap(ck, _trivial(_NEG_QUARTER, x) - (x + y) * 2)


def gate_not(ck: CloudKey, x: LweSample) -> LweSample:
    """NOT = negation; no bootstrap needed."""
    return -x


def gate_constant(ck: CloudKey, value: torch.Tensor) -> LweSample:
    """Noiseless trivial sample of plaintext bool(s) `value`; not
    encrypted."""
    mu = torch.where(value.to(torch.bool), _MU, _NEG_MU).to(torch.int32)
    out = lwe_noiseless_trivial(0, ck.params.lwe_size, tuple(mu.shape),
                                value.device)
    return out._replace(b=mu)


def gate_nor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """NOR = bootstrap(-1/8 - x - y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) - x - y)


def gate_andny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """AND(NOT(x), y) = bootstrap(-1/8 - x + y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) - x + y)


def gate_andyn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """AND(x, NOT(y)) = bootstrap(-1/8 + x - y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) + x - y)


def gate_orny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """OR(NOT(x), y) = bootstrap(1/8 - x + y)."""
    return _bootstrap(ck, _trivial(_MU, x) - x + y)


def gate_oryn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """OR(x, NOT(y)) = bootstrap(1/8 + x - y)."""
    return _bootstrap(ck, _trivial(_MU, x) + x - y)


def gate_mux(ck: CloudKey, x: LweSample, y: LweSample,
             z: LweSample) -> LweSample:
    """MUX(x, y, z) = x ? y : z via 2 blind rotations and 1 keyswitch; the
    intermediate sums stay in the extracted (k*N)-dim space."""
    bk, ks = ck.bootstrap_key, ck.keyswitch_key
    u1 = bootstrap_wo_keyswitch(bk, _MU, _trivial(_NEG_MU, x) + x + y)
    u2 = bootstrap_wo_keyswitch(bk, _MU, _trivial(_NEG_MU, x) - x + z)
    t3 = lwe_noiseless_trivial(_MU, u1.n, u1.batch_shape, u1.a.device) \
        + u1 + u2
    return keyswitch(ks, t3)
