"""The system under test: the port's key set-up and the timed call of the
cell's unit of work, fed the benchmark's inputs.

With the unit files' `program` (`benchmark/units/<gate>.py`), the only
code of the harness that imports the program. It hands the raw key
material of `benchmark/inputs.py` to the port's functions that take raw
material (`bootstrap.bootstrap_key_from_raw`, the keyswitch core, and for
MK `public_key_core`, `mk_tgsw_encrypt_core` and `mk_bootstrap_key`), so
that the bake, the K-major relayout and the MK expansion are the
program's set-up. The timed call is the unit's (`gates.gate_nand` or
`mk.gates.mk_gate_nand` for `nand`).
"""

from __future__ import annotations

import time

import torch

from tfhe_tpu_torch import api, bootstrap, keyswitch, ops, tuning
from tfhe_tpu_torch.lwe import LweSample
from tfhe_tpu_torch.mk import internals as mk_internals
from tfhe_tpu_torch.mk.api import MKCloudKey
from tfhe_tpu_torch.params import SchemeParameters

_FIELDS = ("lwe_size", "lwe_noise_stddev", "tlwe_polynomial_degree",
           "tlwe_mask_size", "bs_decomp_length", "bs_log2_base",
           "bs_noise_stddev", "ks_decomp_length", "ks_log2_base",
           "ks_noise_stddev", "max_parties", "gadget_balanced")


def build_kernels() -> None:
    """Build (first run in a checkout) and load the CUDA kernels."""
    from tfhe_tpu_torch.ops import _build

    _build.load()


def use_tuning(p: dict) -> None:
    """The program's default knobs with the configuration's own, whatever
    the environment says."""
    tuning.set_tuning(tuning.TuningConfig(**p.get("tuning", {})))


def reset_launches() -> dict:
    return ops.reset_launches()


def read_launches(wrappers: dict) -> dict:
    return ops.launches(wrappers)


class System:
    """One configuration's cloud key, made by the program from the raw key
    material, and the unit of work's timed call; `setup` records the
    seconds of each part."""

    def __init__(self, p: dict, keys: dict, setup: dict, unit):
        self.p = p
        self.scheme = p["scheme"]
        self.call = unit.program(self.scheme)
        params = SchemeParameters(**{f: p[f] for f in _FIELDS})
        sync = _sync_for(keys["lwe_key" if self.scheme == "cggi"
                              else "lwe_keys"].device)
        t0 = time.perf_counter()
        if self.scheme == "cggi":
            bk = bootstrap.bootstrap_key_from_raw(
                keys["gsw"], p["bs_decomp_length"], p["bs_log2_base"],
                noise_stddev=p["bs_noise_stddev"],
                balanced=p["gadget_balanced"])
            sync()
            t1 = time.perf_counter()
            setup["bake_and_relayout_s"] = t1 - t0
            ks = keyswitch.keyswitch_key_core(
                keys["tlwe_key"].reshape(-1), keys["lwe_key"], keys["ks_a"],
                keys["ks_noise"], p["ks_decomp_length"], p["ks_log2_base"],
                p["ks_noise_stddev"])
            self.ck = api.CloudKey(params, bk, ks)
            self.key_tensors = [bk.baked, ks.table_limbs]
            self.form = f"{bk.layout}, depth {bk.depth}, block {bk.block}"
        else:
            parties = p["parties"]
            l, b = p["bs_decomp_length"], p["bs_log2_base"]
            pks, ues = [], []
            for q in range(parties):
                z = keys["tlwe_keys"][q].unsqueeze(0)
                pk = mk_internals.public_key_core(z, keys["shared_a"],
                                                  keys["pk_noise"][q])
                noise = keys["ue_noise"][q]
                ues.append(mk_internals.mk_tgsw_encrypt_core(
                    keys["lwe_keys"][q], keys["r"][q], keys["c1"][q],
                    keys["f1"][q], noise[0], noise[1], noise[2], noise[3],
                    z, keys["shared_a"], pk, l, b))
                pks.append(pk)
            sync()
            t1 = time.perf_counter()
            setup["uni_encryption_s"] = t1 - t0
            bk = mk_internals.mk_bootstrap_key(
                ues, torch.stack(pks), l, b, noise_stddev=p["bs_noise_stddev"],
                balanced=p["gadget_balanced"])
            sync()
            t2 = time.perf_counter()
            setup["mk_expansion_s"] = t2 - t1
            t1 = t2
            ks = tuple(keyswitch.keyswitch_key_core(
                keys["tlwe_keys"][q], keys["lwe_keys"][q], keys["ks_a"][q],
                keys["ks_noise"][q], p["ks_decomp_length"],
                p["ks_log2_base"], p["ks_noise_stddev"])
                for q in range(parties))
            self.ck = MKCloudKey(params, parties, bk, ks)
            limbs = bk.limbs if isinstance(bk.limbs, tuple) else (bk.limbs,)
            self.key_tensors = [*limbs, *(k.table_limbs for k in ks)]
            self.form = (f"MK {'sparse' if bk.sparse else 'dense'} prepared "
                         f"limbs, block {bk.block}")
        sync()
        setup["keyswitch_prep_s"] = time.perf_counter() - t1

    @property
    def key_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.key_tensors)

    def wrap(self, a: torch.Tensor, b: torch.Tensor):
        """The program's ciphertext for words (a, b)."""
        cv = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        if self.scheme == "cggi":
            return LweSample(a, b, cv)
        return mk_internals.MKLweSample(a, b, cv)

    def gate(self, x, y):
        """The timed call: one unit of work over the batch."""
        return self.call(self.ck, x, y)

    @staticmethod
    def words(sample):
        return sample.a, sample.b


def _sync_for(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None
