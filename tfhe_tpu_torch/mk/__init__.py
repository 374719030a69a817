"""Multi-key TFHE (Chen-Chillotti-Song) on torch tensors.

Counterpart of `tfhe_tpu/mk/`: shared and public keys, uni-encryption,
ciphertext expansion, the MK external product, MK blind rotation and
keyswitch, the key ceremony, and the bootstrapped MK gates. On a CUDA
device the blind rotation runs through the hand-written kernels of
`ops/mk_cmux.py` (`csrc/mk_cmux.cu`).
"""

from .api import (
    CloudKeyPart,
    MKCloudKey,
    SharedKey,
    make_cloud_key_part,
    make_mk_cloud_key,
    make_shared_key,
    mk_combine_shares,
    mk_decrypt,
    mk_encrypt,
    mk_partial_decrypt,
    mktfhe_parameters_2party,
    mktfhe_parameters_2party_lownoise,
    mktfhe_parameters_4party,
    mktfhe_parameters_8party,
    mktfhe_parameters_toy,
)
from .internals import (
    MKBootstrapKey,
    MKLweSample,
    MKTGswExpSample,
    MKTGswUESample,
    mk_blind_rotate,
    mk_bootstrap,
    mk_bootstrap_wo_keyswitch,
    mk_keyswitch,
    mk_lwe_noiseless_trivial,
    mk_lwe_phase,
    mk_tgsw_encrypt,
    mk_tgsw_expand,
)
from .gates import (
    mk_gate_and,
    mk_gate_andny,
    mk_gate_andyn,
    mk_gate_mux,
    mk_gate_nand,
    mk_gate_nor,
    mk_gate_not,
    mk_gate_or,
    mk_gate_orny,
    mk_gate_oryn,
    mk_gate_xnor,
    mk_gate_xor,
)

__all__ = [name for name in dir() if not name.startswith("_")]
