"""Bootstrapped boolean gates, batched.

Counterpart of `tfhe_tpu/gates.py`. Inputs and outputs are LWE samples
with message +-1/8 (positive phase is `true`). Every two-input gate is one
affine combination plus one bootstrap with mu = 1/8. Every bootstrapped
gate runs in a `tfhe.gate` span (`instrument.spanned`).
"""

from __future__ import annotations

import torch

from .api import CloudKey
from .bootstrap import bootstrap, bootstrap_wo_keyswitch
from .instrument import spanned
from .keyswitch import keyswitch
from .lwe import LweSample, lwe_noiseless_trivial
from .numeric import encode_message

_MU = encode_message(1, 8)  # +1/8
_NEG_MU = encode_message(-1, 8)  # -1/8
_QUARTER = encode_message(1, 4)  # +1/4
_NEG_QUARTER = encode_message(-1, 4)  # -1/4
_gate = spanned("tfhe.gate")


def _trivial(mu: int, x: LweSample) -> LweSample:
    return lwe_noiseless_trivial(mu, x.n, x.batch_shape, x.a.device)


def _bootstrap(ck: CloudKey, result: LweSample) -> LweSample:
    return bootstrap(ck.bootstrap_key, ck.keyswitch_key, _MU, result)


@_gate
def gate_nand(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """NAND = bootstrap(1/8 - x - y)."""
    return _bootstrap(ck, _trivial(_MU, x) - x - y)


@_gate
def gate_or(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """OR = bootstrap(1/8 + x + y)."""
    return _bootstrap(ck, _trivial(_MU, x) + x + y)


@_gate
def gate_and(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """AND = bootstrap(-1/8 + x + y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) + x + y)


@_gate
def gate_xor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """XOR = bootstrap(1/4 + 2(x + y))."""
    return _bootstrap(ck, _trivial(_QUARTER, x) + (x + y) * 2)


@_gate
def gate_xnor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """XNOR = bootstrap(-1/4 - 2(x + y))."""
    return _bootstrap(ck, _trivial(_NEG_QUARTER, x) - (x + y) * 2)


def gate_not(ck: CloudKey, x: LweSample) -> LweSample:
    """NOT = negation; no bootstrap needed."""
    return -x


def gate_constant(ck: CloudKey, value, batch_shape=()) -> LweSample:
    """Noiseless trivial sample of plaintext bool(s) `value` (a Python
    bool, a numpy array or a tensor), broadcast to `batch_shape` (default:
    the shape of `value`); not encrypted. The result lies on the cloud
    key's device."""
    device = ck.keyswitch_key.table_limbs.device
    value = torch.as_tensor(value, device=device).to(torch.bool)
    mu = torch.where(value, _MU, _NEG_MU).to(torch.int32)
    batch_shape = tuple(batch_shape) or tuple(mu.shape)
    return lwe_noiseless_trivial(mu, ck.params.lwe_size, batch_shape, device)


@_gate
def gate_nor(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """NOR = bootstrap(-1/8 - x - y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) - x - y)


@_gate
def gate_andny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """AND(NOT(x), y) = bootstrap(-1/8 - x + y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) - x + y)


@_gate
def gate_andyn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """AND(x, NOT(y)) = bootstrap(-1/8 + x - y)."""
    return _bootstrap(ck, _trivial(_NEG_MU, x) + x - y)


@_gate
def gate_orny(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """OR(NOT(x), y) = bootstrap(1/8 - x + y)."""
    return _bootstrap(ck, _trivial(_MU, x) - x + y)


@_gate
def gate_oryn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
    """OR(x, NOT(y)) = bootstrap(1/8 + x - y)."""
    return _bootstrap(ck, _trivial(_MU, x) + x - y)


@_gate
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
