"""The port's gates, end to end, at toy parameters.

* Keys and ciphertexts made by `tfhe_tpu`, converted through
  `tfhe_tpu_torch.interop`: `bootstrap` and `gate_nand` return the same
  words as the reference.
* The port's own keygen and encryption: decrypted truth tables of all 13
  gates.
* `import tfhe_tpu_torch` leaves JAX and `tfhe_tpu` unimported.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_tpu as tt
import tfhe_tpu_torch as tp
from tfhe_tpu import bootstrap as j_bs
from tfhe_tpu import gates as j_gates
from tfhe_tpu_torch import bootstrap as p_bs
from tfhe_tpu_torch import gates as p_gates
from tfhe_tpu_torch import interop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fields(obj):
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


def to_port(sample):
    return interop.lwe_sample_from_numpy(*(np.asarray(x) for x in sample),
                                         device="cpu")


def same_sample(port, ref):
    np.testing.assert_array_equal(port.a.numpy(), np.asarray(ref.a))
    np.testing.assert_array_equal(port.b.numpy(), np.asarray(ref.b))
    np.testing.assert_allclose(port.cv.numpy(), np.asarray(ref.cv), rtol=1e-6)


@pytest.fixture(scope="module")
def shared_keys():
    params = tt.tfhe_parameters_toy()
    sk, ck = tt.make_key_pair(jax.random.PRNGKey(7), params)
    ck_p = interop.cloud_key_from_numpy(
        tp.tfhe_parameters_toy(), fields(ck.bootstrap_key),
        fields(ck.keyswitch_key), device="cpu")
    xs = jnp.asarray([False, False, True, True, True, False])
    ys = jnp.asarray([False, True, False, True, True, True])
    ct_x = tt.encrypt(jax.random.PRNGKey(1), sk, xs)
    ct_y = tt.encrypt(jax.random.PRNGKey(2), sk, ys)
    sk_p = interop.secret_key_from_numpy(tp.tfhe_parameters_toy(),
                                         np.asarray(sk.key), device="cpu")
    return ck, ck_p, ct_x, ct_y, sk, sk_p


def test_interop_keys_equal(shared_keys):
    ck, ck_p = shared_keys[:2]
    np.testing.assert_array_equal(ck_p.bootstrap_key.baked.numpy(),
                                  np.asarray(ck.bootstrap_key.baked))
    assert ck_p.bootstrap_key.plan.leaves == tuple(
        type(ck_p.bootstrap_key.plan.leaves[0])(**dataclasses.asdict(lf))
        for lf in ck.bootstrap_key.plan.leaves)


def test_interop_defaults_to_the_card_and_keeps_cpu_keys_in_reference_layout(
        shared_keys):
    """Every converter puts its result on a CUDA card unless asked for
    another device; a key asked onto the CPU keeps the reference layout
    the plain versions read."""
    import inspect

    converters = [fn for name, fn in vars(interop).items()
                  if name.endswith("_from_numpy")]
    assert len(converters) == 11
    for fn in converters:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    bk = shared_keys[1].bootstrap_key
    assert bk.layout == "reference" and bk.baked.dim() == 3


def test_bootstrap_matches_reference(shared_keys):
    ck, ck_p, ct_x = shared_keys[:3]
    mu = tt.encode_message(1, 8)
    want = j_bs.bootstrap(ck.bootstrap_key, ck.keyswitch_key, mu, ct_x)
    got = p_bs.bootstrap(ck_p.bootstrap_key, ck_p.keyswitch_key, mu,
                         to_port(ct_x))
    same_sample(got, want)


def test_gate_nand_matches_reference(shared_keys):
    ck, ck_p, ct_x, ct_y, sk, sk_p = shared_keys
    want = j_gates.gate_nand(ck, ct_x, ct_y)
    got = p_gates.gate_nand(ck_p, to_port(ct_x), to_port(ct_y))
    same_sample(got, want)
    np.testing.assert_array_equal(tp.decrypt(sk_p, got).numpy(),
                                  np.asarray(tt.decrypt(sk, want)))


def test_unported_key_forms_raise():
    """Every key form the reference builds is ported now, so neither entry
    point raises NotImplementedError any more: `interop` takes a compact
    key as it is, and N == T (M = 1) builds the dense depth-0 key."""
    bk = interop.bootstrap_key_from_numpy(
        baked=np.zeros((1, 4, 2, 2, 256), np.int8), decomp_length=1,
        log2_base=7, polynomial_degree=128, mask_size=1, block=128,
        depth=0, compact=True, device="cpu")
    assert bk.compact and bk.depth == 0 and bk.plan.total_rows == 1
    bk = p_bs.bootstrap_key_from_raw(torch.zeros((1, 2, 2, 2, 128),
                                                 dtype=torch.int32), 2, 8)
    assert not bk.compact and bk.depth == 0
    assert tuple(bk.baked.shape) == (1, 2 * 4 * 128, 2 * 4 * 128)
    for path in ("tfhe_tpu_torch/bootstrap.py", "tfhe_tpu_torch/interop.py"):
        with open(os.path.join(REPO, path)) as f:
            assert "NotImplementedError" not in f.read(), path


GATES_2IN = [
    ("gate_nand", lambda x, y: not (x and y)),
    ("gate_or", lambda x, y: x or y),
    ("gate_and", lambda x, y: x and y),
    ("gate_xor", lambda x, y: x != y),
    ("gate_xnor", lambda x, y: x == y),
    ("gate_nor", lambda x, y: not (x or y)),
    ("gate_andny", lambda x, y: (not x) and y),
    ("gate_andyn", lambda x, y: x and (not y)),
    ("gate_orny", lambda x, y: (not x) or y),
    ("gate_oryn", lambda x, y: x or (not y)),
]


@pytest.fixture(scope="module")
def port_keys():
    g = torch.Generator().manual_seed(2024)
    sk, ck = tp.make_key_pair(g, tp.tfhe_parameters_toy())
    return g, sk, ck


def test_all_gates_truth_tables(port_keys):
    g, sk, ck = port_keys
    xs = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], dtype=torch.bool)
    ys = torch.tensor([0, 1, 0, 1, 0, 1, 0, 1], dtype=torch.bool)
    zs = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.bool)
    cx, cy, cz = (tp.encrypt(g, sk, v) for v in (xs, ys, zs))
    for name, fn in GATES_2IN:
        got = tp.decrypt(sk, getattr(tp, name)(ck, cx, cy))
        want = torch.tensor([fn(bool(x), bool(y)) for x, y in zip(xs, ys)])
        assert torch.equal(got, want), name
    assert torch.equal(tp.decrypt(sk, tp.gate_not(ck, cx)), ~xs)
    assert torch.equal(tp.decrypt(sk, tp.gate_constant(ck, ys)), ys)
    mux = tp.decrypt(sk, tp.gate_mux(ck, cx, cy, cz))
    assert torch.equal(mux, torch.where(xs, ys, zs))


def test_port_imports_no_jax():
    # every module of the package, walked: a module added later is held too
    code = (
        "import sys, importlib, pkgutil\n"
        "import tfhe_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tfhe_tpu_torch.__path__, 'tfhe_tpu_torch.')]\n"
        "for m in names:\n"
        "    importlib.import_module(m)\n"
        "assert {'tfhe_tpu_torch.parallel.dryrun', 'tfhe_tpu_torch.bench',\n"
        "        'tfhe_tpu_torch.examples.multikey',\n"
        "        'tfhe_tpu_torch.graft_entry',\n"
        "        'tfhe_tpu_torch.tools.profile_bootstrap',\n"
        "        'tfhe_tpu_torch.tools.pbs_bench',\n"
        "        'tfhe_tpu_torch.tools.scaling_bench'} <= set(names), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'tfhe_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("clean")
