"""The low-level twins of the port against `tfhe_tpu` and the NumPy spec.

* `ops/conv.negacyclic_mul`, `tgsw.tgsw_extern_mul` and the three
  `bootstrap.mux_rotate*` CMUX forms: array-equal to the reference, to
  `spec/oracle.py` and to the committed `spec/vectors/spec_vectors.npz`
  (read as `tests/test_reference_vectors.py` reads it);
* `constant_polynomial`, `lwe_encrypt_with_noise`, `Torus32`,
  `rand_gaussian_torus32`, the package-level re-exports and the new tuning
  names;
* every public name of the reference modules the port mirrors has a twin
  in the port, but for the names listed below with the reason.
"""

import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from spec import oracle
from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import tuning as j_tuning
from tfhe_tpu.ops import conv as j_conv
from tfhe_tpu.ops import karatsuba as j_kara
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import tuning as p_tuning
from tfhe_tpu_torch.ops import conv as p_conv
from tfhe_tpu_torch.ops import karatsuba as p_kara

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(REPO, "spec", "vectors", "spec_vectors.npz")


def words(rng, shape):
    return rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64) \
        .astype(np.int32)


def t(x):
    return torch.from_numpy(np.array(x))


# --- the name sets -----------------------------------------------------------

# Reference names with no twin, each with its reason.
NOT_PORTED = {
    "tuning": {
        "append_xla_flag": "an XLA flag: there is no XLA (ROADMAP: do not "
                           "port)",
    },
    "utils.profiling": {
        "enable_xla_dump": "there is no XLA; the nvcc build of "
                           "ops/_build.py is the compiler step",
        "V5E_INT8_MACS": "a TPU v5e's peak; the port names the H100's",
        "V5E_HBM_BYTES": "a TPU v5e's memory rate; the port names the H100's",
    },
    "ops.karatsuba": {
        "karatsuba_delta_cols": "only parallel/mesh.py calls it: the "
                                "multi-device slice",
    },
}
# Names that are aliases of another package's type in the reference.
ALIASES = {"numeric": {"Torus32"}}
MODULES = ["", "tuning", "numeric", "polynomial", "lwe", "ops.conv", "tgsw",
           "bootstrap", "compressed", "public", "rekey", "debug",
           "ops.karatsuba", "utils.serialization", "utils.jobs",
           "utils.telemetry", "utils.profiling"]


def public_names(mod) -> set:
    """Names a reference module defines: its own functions and classes,
    its constants, and for the package every public re-export."""
    out = set(ALIASES.get(mod.__name__.partition(".")[2], ()))
    for name in dir(mod):
        obj = getattr(mod, name)
        if name.startswith("_") or name == "annotations" \
                or isinstance(obj, types.ModuleType):
            continue
        if mod.__name__ == "tfhe_tpu" or not callable(obj) \
                or getattr(obj, "__module__", None) == mod.__name__:
            out.add(name)
    return out


@pytest.mark.parametrize("name", MODULES)
def test_every_reference_name_has_a_twin(name):
    ref = importlib.import_module("tfhe_tpu" + ("." + name if name else ""))
    port = importlib.import_module("tfhe_tpu_torch"
                                   + ("." + name if name else ""))
    skip = NOT_PORTED.get(name, {})
    missing = sorted(n for n in public_names(ref) - set(skip)
                     if not hasattr(port, n))
    assert not missing, f"{name or 'tfhe_tpu'}: no twin for {missing}"
    assert all(n in public_names(ref) for n in skip), "stale exception"


def test_package_reexports_are_the_same_objects():
    for name in public_names(tt):
        if isinstance(getattr(tt, name), types.ModuleType):
            continue
        port = getattr(tp, name)
        home = importlib.import_module(port.__module__) \
            if callable(port) else tp
        assert getattr(home, name, port) is port
    assert isinstance(tp.keyswitch, types.ModuleType)
    assert isinstance(tp.bootstrap, types.ModuleType)
    assert tp.conv is p_conv


# --- the twins ---------------------------------------------------------------


@pytest.mark.parametrize("n,lead", [(16, ()), (64, (3,)), (256, (2, 2))])
def test_negacyclic_mul(n, lead):
    rng = np.random.default_rng(n)
    x = rng.integers(-512, 512, size=lead + (n,)).astype(np.int32)
    y = words(rng, lead + (n,))
    got = p_conv.negacyclic_mul(t(x), t(y)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_conv.negacyclic_mul(jnp.asarray(x),
                                              jnp.asarray(y))))
    flat_x, flat_y = x.reshape(-1, n), y.reshape(-1, n)
    np.testing.assert_array_equal(
        got.reshape(-1, n),
        np.stack([oracle.negacyclic_mul(a, b) for a, b in zip(flat_x,
                                                               flat_y)]))


@pytest.mark.parametrize("l,b,balanced", [(3, 7, False), (2, 8, True)])
def test_tgsw_extern_mul(l, b, balanced):
    rng = np.random.default_rng(l)
    k1, n, batch = 2, 64, 3
    acc = words(rng, (batch, k1, n))
    gsw = words(rng, (l, k1, k1, n))
    got = tp.tgsw_extern_mul(
        tp.TLweSample(t(acc), torch.zeros(batch)), t(gsw), l, b,
        balanced).a.numpy()
    want = tt.tgsw_extern_mul(
        tt.TLweSample(jnp.asarray(acc), jnp.zeros(batch)), jnp.asarray(gsw),
        l, b, balanced).a
    np.testing.assert_array_equal(got, np.asarray(want))
    for i in range(batch):
        np.testing.assert_array_equal(
            got[i], oracle.tgsw_extern_mul(acc[i], gsw, l, b, balanced))


def test_mux_rotate_three_forms():
    """mux_rotate (prepared), mux_rotate_baked (dense) and
    mux_rotate_karatsuba (baked) on one TGSW step against the reference and
    the oracle, bara 0 and negative included."""
    rng = np.random.default_rng(3)
    k1, n, l, b, t_blk, batch = 2, 64, 3, 7, 16, 4
    gsw = words(rng, (1, l, k1, k1, n))
    acc = words(rng, (batch, k1, n))
    barai = np.array([0, 5, -7, 2 * n - 1], np.int32)
    cv = np.zeros(batch, np.float32)
    limbs = tp.prepare_tgsw(t(gsw), l, b)
    got = p_bs.mux_rotate(tp.TLweSample(t(acc), t(cv)), limbs[0], t(barai),
                          l, b).a.numpy()
    want = j_bs.mux_rotate(tt.TLweSample(jnp.asarray(acc), jnp.asarray(cv)),
                           tt.prepare_tgsw(jnp.asarray(gsw), l, b)[0],
                           jnp.asarray(barai), l, b).a
    np.testing.assert_array_equal(got, np.asarray(want))
    for i in range(batch):
        np.testing.assert_array_equal(
            got[i], oracle.mux_rotate(acc[i], gsw[0], int(barai[i]) % (2 * n),
                                      l, b))
    dense = p_conv.bake_block_toeplitz(limbs, t_blk)[0]
    np.testing.assert_array_equal(
        p_bs.mux_rotate_baked(t(acc), dense, t(barai), l, b, t_blk).numpy(),
        got)
    plan = p_kara.karatsuba_plan(n // t_blk, 2, b)
    baked = p_kara.bake_karatsuba(limbs, t_blk, plan)[0]
    np.testing.assert_array_equal(
        p_bs.mux_rotate_karatsuba(t(acc), baked, t(barai), l, b, t_blk,
                                  plan).numpy(), got)
    j_plan = j_kara.karatsuba_plan(n // t_blk, 2, b)
    np.testing.assert_array_equal(baked.numpy(), np.asarray(
        j_kara.bake_karatsuba(tt.prepare_tgsw(jnp.asarray(gsw), l, b), t_blk,
                              j_plan))[0])


@pytest.fixture(scope="module")
def vec():
    return dict(np.load(VECTORS))


def test_spec_vectors(vec):
    """The committed vectors, read as tests/test_reference_vectors.py reads
    them: negacyclic_mul, tgsw_extern_mul and mux_rotate."""
    _, _, _, l, b = [int(x) for x in vec["params"]]
    np.testing.assert_array_equal(
        p_conv.negacyclic_mul(t(vec["tm_x"]), t(vec["tm_y"])).numpy(),
        vec["tm_out"])
    acc = tp.TLweSample(t(vec["em_acc"])[None], torch.zeros(1))
    np.testing.assert_array_equal(
        tp.tgsw_extern_mul(acc, t(vec["bk_raw"][0]), l, b).a[0].numpy(),
        vec["em_out"])
    limbs = tp.prepare_tgsw(t(vec["bk_raw"][1]), l, b)
    acc = tp.TLweSample(t(vec["mr_acc"])[None], torch.zeros(1))
    np.testing.assert_array_equal(
        p_bs.mux_rotate(acc, limbs, t(vec["mr_barai"]), l, b).a[0].numpy(),
        vec["mr_out"])


def test_constant_polynomial_and_torus32():
    got = tp.polynomial.constant_polynomial(-5, 8, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(tt.polynomial.constant_polynomial(-5, 8)))
    assert got.dtype == tp.numeric.Torus32 == torch.int32
    assert np.dtype(tt.numeric.Torus32) == np.int32


def test_lwe_encrypt_with_noise():
    """The phase is message + dtot32(noise), as the reference's is for the
    same message and noise; cv is alpha^2."""
    rng = np.random.default_rng(4)
    key = rng.integers(0, 2, 16).astype(np.int32)
    msg = words(rng, (5,))
    noise = (rng.standard_normal(5) * 1e-3).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    got = tp.lwe.lwe_encrypt_with_noise(g, t(msg), t(noise), 1e-3, t(key))
    want = tt.lwe.lwe_encrypt_with_noise(jax.random.PRNGKey(1),
                                         jnp.asarray(msg), jnp.asarray(noise),
                                         1e-3, jnp.asarray(key))
    np.testing.assert_array_equal(
        tp.lwe_phase(got, t(key)).numpy(),
        np.asarray(tt.lwe_phase(want, jnp.asarray(key))))
    np.testing.assert_allclose(got.cv.numpy(), np.asarray(want.cv))


def test_rand_gaussian_torus32():
    """message + dtot32(the generator's normal draws * sigma), dtot32 the
    reference's."""
    g = torch.Generator().manual_seed(9)
    state = g.get_state()
    got = tp.numeric.rand_gaussian_torus32(g, 1000, 0.01, (64,))
    g.set_state(state)
    draws = torch.randn((64,), generator=g) * 0.01
    want = 1000 + np.asarray(tt.dtot32(jnp.asarray(draws.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


def test_tuning_names(monkeypatch):
    for knobs in ({}, dict(debug=True), dict(radix_manylut=False)):
        with j_tuning.override(**knobs) as j, p_tuning.override(**knobs) as p:
            assert p.result_fingerprint() == j.result_fingerprint()
            assert p.RESULT_AFFECTING == j.RESULT_AFFECTING
            assert set(p.describe()) <= set(j.describe())
    monkeypatch.setenv("TFHE_TPU_DEBUG", "yes")
    assert p_tuning.get_tuning().debug is True
    monkeypatch.setenv("TFHE_TPU_DEBUG", "maybe")
    with pytest.raises(ValueError):
        p_tuning.get_tuning()
    monkeypatch.setenv("SOME_COUNT", "12")
    for f in ("env_int", "env_str"):
        assert getattr(p_tuning, f)("SOME_COUNT") \
            == getattr(j_tuning, f)("SOME_COUNT")
        assert getattr(p_tuning, f)("NOT_SET_X", 3) \
            == getattr(j_tuning, f)("NOT_SET_X", 3)
