"""tfhe_tpu_torch: the PyTorch and CUDA port of tfhe_tpu.

TFHE gate bootstrapping on torch tensors, with the blind rotation of every
single-key form of the bootstrap key (Karatsuba-baked, compact, dense) as
hand-written CUDA kernels for Hopper (ops/blind_rotate.py, ops/compact.py,
ops/cmux_step.py, csrc/), and multi-key TFHE in the subpackage `mk` (key
ceremony, `mk_encrypt`, the 12 `mk_gate_*`, `mk_decrypt`; its blind rotation
through the kernels of ops/mk_cmux.py). Module names mirror `tfhe_tpu`; every
word of every ciphertext and key equals the reference's for the same inputs.
This package never imports JAX.
"""

from . import tuning
from .params import (
    SchemeParameters,
    tfhe_parameters_80,
    tfhe_parameters_128,
    tfhe_parameters_128_fast,
    tfhe_parameters_128_fast8,
    tfhe_parameters_128_pbs,
    tfhe_parameters_128_radix,
    tfhe_parameters_128_radix_reliable,
    tfhe_parameters_toy,
)
from .lwe import LweSample
from .tlwe import TLweSample
from .keyswitch import KeyswitchKey
from .bootstrap import BootstrapKey
from .api import (
    CloudKey,
    SecretKey,
    decrypt,
    encrypt,
    make_cloud_key,
    make_key_pair,
    make_secret_key,
)
from .gates import (
    gate_and,
    gate_andny,
    gate_andyn,
    gate_constant,
    gate_mux,
    gate_nand,
    gate_nor,
    gate_not,
    gate_or,
    gate_orny,
    gate_oryn,
    gate_xnor,
    gate_xor,
)
from . import mk

__all__ = [name for name in dir() if not name.startswith("_")]
