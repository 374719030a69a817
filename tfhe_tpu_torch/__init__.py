"""tfhe_tpu_torch: the PyTorch and CUDA port of tfhe_tpu.

TFHE gate bootstrapping on torch tensors, with the blind rotation of every
single-key form of the bootstrap key (Karatsuba-baked, compact, dense) as
hand-written CUDA kernels for Hopper (ops/blind_rotate.py, ops/compact.py,
ops/cmux_step.py, ops/fused_step.py, csrc/), multi-key TFHE in the subpackage
`mk` (key ceremony, `mk_encrypt`, the 12 `mk_gate_*`, `mk_decrypt`; its blind
rotation through the kernels of ops/mk_cmux.py), and the workloads on the
bootstrap: programmable bootstrapping (`pbs`), radix integers (`radix`), bit
circuits (`circuits`) and the netlist executor (`netlist`); and the wire and
serving modules: seeded keys and modulus-switched results (`compressed`,
whose masks expand through the threefry twin `threefry`), public-key
encryption (`public`), re-keying (`rekey`), the file format, checkpointed
jobs, telemetry and profiling (`utils`), and the opt-in debug mode
(`debug`). Module names mirror `tfhe_tpu`; every
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
from .numeric import encode_message, decode_message, dtot32
from .lwe import (
    LweSample,
    lwe_encrypt,
    lwe_phase,
    lwe_noiseless_trivial,
    lwe_key_gen,
)
from .tlwe import (
    TLweSample,
    tlwe_key_gen,
    extract_lwe_key,
    tlwe_extract_sample,
    tlwe_encrypt_zero,
    tlwe_noiseless_trivial,
    tlwe_mul_by_monomial,
)
from .tgsw import (
    decompose,
    gadget_values,
    tgsw_encrypt,
    tgsw_extern_mul,
    tgsw_extern_mul_prepared,
    prepare_tgsw,
)
# The `keyswitch` and `bootstrap` functions are not re-exported: they would
# shadow their submodules, which are bound last (as in the reference).
from .keyswitch import KeyswitchKey, keyswitch_key_gen
from .bootstrap import BootstrapKey, bootstrap_key_gen
from . import keyswitch, bootstrap  # noqa: F811
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
from . import polynomial
from . import circuits
from . import compressed
from . import public
from . import rekey
from . import netlist
from . import pbs
from . import radix
from . import mk
from .ops import conv

__all__ = [name for name in dir() if not name.startswith("_")]
