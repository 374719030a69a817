"""The file format in both directions between `tfhe_tpu` and the port.

Bytes that `tfhe_tpu.utils.serialization.dumps` writes load in
`tfhe_tpu_torch.utils.serialization.loads` with equal words, and the
reverse, for every type of the serialization table that holds arrays: the
secret key, the keyswitch key, the cloud key in its three forms (baked,
dense, compact), LWE and TLWE samples, the multi-key shared key, cloud key
part, sparse-stored cloud key (a per-party tuple) and sample, and keys the
port makes itself. A key the card holds K-major
is written in the reference layout; here that is emulated on CPU tensors
through `to_kmajor`. The seeded and compressed types are in
`tests/test_torch_compressed.py` and `tests/test_torch_public_rekey.py`.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import mk as j_mk
from tfhe_tpu.mk import internals as j_mki
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu.utils import serialization as js
from tfhe_tpu_torch.ops.dots import from_kmajor, to_kmajor
from tfhe_tpu_torch.utils import serialization as ps

torch.set_num_threads(2)


def same(port, ref, where="obj"):
    """Every leaf of `port` (tensors) equals `ref`'s (jax or numpy arrays),
    with the same structure, field names and static values."""
    if isinstance(port, torch.Tensor):
        want = np.asarray(ref)
        got = port.cpu().numpy()
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif dataclasses.is_dataclass(port):
        assert type(port).__name__ == type(ref).__name__, where
        for f in dataclasses.fields(port):
            same(getattr(port, f.name), getattr(ref, f.name),
                 f"{where}.{f.name}")
    elif hasattr(port, "_fields"):
        assert port._fields == ref._fields, where
        for name in port._fields:
            same(getattr(port, name), getattr(ref, name), f"{where}.{name}")
    elif isinstance(port, (tuple, list)):
        assert len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            same(p, r, f"{where}[{i}]")
    else:
        assert port == ref, where


def words(rng, shape):
    return jnp.asarray(rng.integers(-(2**31), 2**31, shape, dtype=np.int64)
                       .astype(np.int32))


@pytest.fixture(scope="module")
def ref_objects():
    """Reference objects of every array-holding type, made once from random
    words where the type's arithmetic is not what is tested."""
    params = tt.tfhe_parameters_toy()
    rng = np.random.default_rng(1)
    sk = tt.make_secret_key(jax.random.PRNGKey(3), params)
    ks = tt.keyswitch.keyswitch_key_core(
        words(rng, (256,)) & 1, sk.key, words(rng, (3, 8, 256, 16)),
        words(rng, (3, 8, 256)), 8, 2, noise_stddev=1e-5)
    gsw = words(rng, (4, 3, 2, 2, 256))
    forms = {}
    for form, knobs in (("baked", {}), ("dense", dict(karatsuba_depth=0)),
                        ("compact", dict(bs_bake_budget=0))):
        with j_tuning.override(**knobs):
            bk = tt.bootstrap.bootstrap_key_from_raw(gsw, 3, 7,
                                                     noise_stddev=1e-9)
        forms[form] = tt.CloudKey(params, bk, ks)
    lwe = tt.encrypt(jax.random.PRNGKey(4), sk, jnp.asarray([True, False]))
    tlwe = tt.TLweSample(words(rng, (3, 2, 256)),
                         jnp.full((3,), 1e-6, jnp.float32))
    mk_params = j_mk.mktfhe_parameters_toy(2)
    shared = j_mk.SharedKey(mk_params, words(rng, (4, 256)))
    part = j_mk.CloudKeyPart(mk_params, words(rng, (4, 256)),
                             j_mki.MKTGswUESample(words(rng, (16, 6, 4, 256))),
                             ks)
    ue = [j_mki.MKTGswUESample(words(rng, (3, 6, 4, 32))) for _ in range(2)]
    with j_tuning.override(mk_sparse_limbs="1"):
        bk = j_mki.mk_bootstrap_key(ue, words(rng, (2, 4, 32)), 4, 7,
                                    noise_stddev=1e-9)
    assert bk.sparse and isinstance(bk.limbs, tuple)
    mk_sparse = j_mk.MKCloudKey(mk_params, 2, bk, (ks, ks))
    mk_ct = j_mki.MKLweSample(words(rng, (5, 2, 16)), words(rng, (5,)),
                              jnp.zeros((5,), jnp.float32))
    return dict(sk=sk, ks=ks, **forms, lwe=lwe, tlwe=tlwe, shared=shared,
                part=part, mk_sparse=mk_sparse, mk_ct=mk_ct)


NAMES = ["sk", "ks", "baked", "dense", "compact", "lwe", "tlwe", "shared",
         "part", "mk_sparse", "mk_ct"]


@pytest.mark.parametrize("name", NAMES)
def test_reference_bytes_load_in_the_port(ref_objects, name):
    ref = ref_objects[name]
    port = ps.loads(js.dumps(ref), device="cpu")
    same(port, ref)


@pytest.mark.parametrize("name", NAMES)
def test_port_bytes_load_in_the_reference(ref_objects, name):
    ref = ref_objects[name]
    port = ps.loads(js.dumps(ref), device="cpu")
    same(port, js.loads(ps.dumps(port)))


def test_port_made_keys_load_in_the_reference():
    g = torch.Generator().manual_seed(2)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    same((sk, ck), js.loads(ps.dumps((sk, ck))))


def test_kmajor_key_is_written_in_the_reference_layout(ref_objects):
    """A baked key as the card holds it (K-major, 5-dim), emulated on CPU
    tensors: the file holds the reference layout, and loading it for the
    CPU gives that layout back, equal to from_kmajor of the held key."""
    port = ps.loads(js.dumps(ref_objects["baked"]), device="cpu")
    bk = port.bootstrap_key
    held = dataclasses.replace(bk, baked=to_kmajor(bk.baked))
    assert held.layout == "kmajor"
    data = ps.dumps(dataclasses.replace(port, bootstrap_key=held))
    same(ps.loads(data, device="cpu"), ref_objects["baked"])
    np.testing.assert_array_equal(
        np.asarray(js.loads(data).bootstrap_key.baked),
        torch.stack([from_kmajor(s) for s in held.baked]).numpy())


def test_version_check(ref_objects):
    data = js.dumps(ref_objects["lwe"])
    with np.load(io.BytesIO(data)) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("__manifest__")).decode())
    manifest["version"] = 1
    buf = io.BytesIO()
    np.savez(buf, __manifest__=np.frombuffer(json.dumps(manifest).encode(),
                                             np.uint8), **arrays)
    for mod in (ps, js):
        with pytest.raises(ValueError, match="unsupported format version"):
            mod.loads(buf.getvalue())
    assert ps.FORMAT_VERSION == js.FORMAT_VERSION == 2


def test_save_and_load_a_file(ref_objects, tmp_path):
    path = str(tmp_path / "sk.npz")
    js.save(ref_objects["sk"], path)
    same(ps.load(path, device="cpu"), ref_objects["sk"])
    ps.save(ps.load(path, device="cpu"), path)
    same(ps.load(path, device="cpu"), js.load(path))
