"""Versioned serialization for keys and ciphertexts.

Counterpart of `tfhe_tpu/utils/serialization.py`, and the same file format:
one `.npz` archive holding every array leaf (named by its path in the
object) plus a JSON manifest (`__manifest__`) with the format version, the
object's type tree under the reference's class names, and its static
fields. So bytes written by either package load in the other:

* `dumps` writes every tensor as the numpy array the reference writes. A
  baked or dense bootstrap key that a CUDA card holds K-major is written in
  the reference layout (`ops/dots.py:from_kmajor`, step by step);
* `loads(data, device=...)` returns tensors on `device` ("cuda" unless the
  caller names another), and relays a baked or dense bootstrap key for that
  device (`bootstrap.on_device_layout`: K-major on a card);
* a sparse-stored multi-key bootstrap key (one array per party) goes
  through the `tuple` kind, as the reference's does.

`loads` reads only what `np.load` reads without pickles.
"""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch

FORMAT_VERSION = 2  # v2: keyswitch table rows ordered (j, h, i)


def _type_table():
    from .. import api, bootstrap, compressed, keyswitch, lwe, public, tlwe
    from ..mk import api as mk_api
    from ..mk import internals as mk_internals
    from ..params import SchemeParameters

    return {
        "SchemeParameters": SchemeParameters,
        "SeededLweSample": compressed.SeededLweSample,
        "SeededKeyswitchKey": compressed.SeededKeyswitchKey,
        "SeededBootstrapKey": compressed.SeededBootstrapKey,
        "SeededCloudKey": compressed.SeededCloudKey,
        "SeededSharedKey": compressed.SeededSharedKey,
        "SeededCloudKeyPart": compressed.SeededCloudKeyPart,
        "CompressedLweSample": compressed.CompressedLweSample,
        "LwePublicKey": public.LwePublicKey,
        "SeededLwePublicKey": public.SeededLwePublicKey,
        "SecretKey": api.SecretKey,
        "CloudKey": api.CloudKey,
        "BootstrapKey": bootstrap.BootstrapKey,
        "KeyswitchKey": keyswitch.KeyswitchKey,
        "LweSample": lwe.LweSample,
        "TLweSample": tlwe.TLweSample,
        "SharedKey": mk_api.SharedKey,
        "CloudKeyPart": mk_api.CloudKeyPart,
        "MKCloudKey": mk_api.MKCloudKey,
        "MKBootstrapKey": mk_internals.MKBootstrapKey,
        "MKLweSample": mk_internals.MKLweSample,
        "MKTGswUESample": mk_internals.MKTGswUESample,
        "MKTGswExpSample": mk_internals.MKTGswExpSample,
    }


def _reference_baked(key: torch.Tensor) -> np.ndarray:
    """A K-major key int8[n, K, 4, T, rows] as the reference's
    int8[n, rows, K*4*T], one step at a time on its device."""
    from ..ops.dots import from_kmajor

    n, k1, four, t, rows = key.shape
    out = np.empty((n, rows, k1 * four * t), np.int8)
    for s in range(n):
        out[s] = from_kmajor(key[s]).cpu().numpy()
    return out


def _encode(obj, path, arrays, table_rev):
    """Recursively encode `obj` into a JSON-able spec + array dict."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"k": "scalar", "v": obj}
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        name = "/".join(path)
        arrays[name] = (obj.detach().cpu().numpy()
                        if isinstance(obj, torch.Tensor) else obj)
        return {"k": "array", "v": name}
    cls_name = table_rev.get(type(obj))
    if cls_name is not None:
        if cls_name == "BootstrapKey" and obj.layout == "kmajor":
            obj = dataclasses.replace(obj, baked=_reference_baked(obj.baked))
        names = ([f.name for f in dataclasses.fields(obj)]
                 if dataclasses.is_dataclass(obj) else obj._fields)
        fields = {name: _encode(getattr(obj, name), path + (name,), arrays,
                                table_rev)
                  for name in names}
        return {"k": "obj", "t": cls_name, "v": fields}
    if isinstance(obj, (tuple, list)):
        return {
            "k": "tuple" if isinstance(obj, tuple) else "list",
            "v": [_encode(e, path + (str(i),), arrays, table_rev)
                  for i, e in enumerate(obj)],
        }
    raise TypeError(f"cannot serialize {type(obj)!r} at {'/'.join(path)}")


def _decode(spec, arrays, table, device):
    kind = spec["k"]
    if kind == "scalar":
        return spec["v"]
    if kind == "array":
        return torch.from_numpy(arrays[spec["v"]]).to(device)
    if kind == "obj":
        cls = table[spec["t"]]
        fields = {n: _decode(s, arrays, table, device)
                  for n, s in spec["v"].items()}
        obj = cls(**fields)
        if spec["t"] == "BootstrapKey" and not obj.compact:
            from ..bootstrap import on_device_layout

            obj = dataclasses.replace(
                obj, baked=on_device_layout(obj.baked, obj.block))
        return obj
    if kind == "tuple":
        return tuple(_decode(s, arrays, table, device) for s in spec["v"])
    if kind == "list":
        return [_decode(s, arrays, table, device) for s in spec["v"]]
    raise ValueError(f"unknown spec kind {kind!r}")


def dumps(obj) -> bytes:
    """Serialize a key, ciphertext or seeded artifact to bytes (npz)."""
    table = _type_table()
    table_rev = {v: k for k, v in table.items()}
    arrays: dict = {}
    spec = _encode(obj, (), arrays, table_rev)
    manifest = json.dumps({"version": FORMAT_VERSION, "spec": spec})
    buf = io.BytesIO()
    np.savez(buf, __manifest__=np.frombuffer(manifest.encode(), np.uint8),
             **arrays)
    return buf.getvalue()


def loads(data: bytes, device: torch.device | str = "cuda"):
    """Reconstruct an object from bytes, its tensors on `device`."""
    with np.load(io.BytesIO(data)) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        if manifest["version"] != FORMAT_VERSION:
            raise ValueError(
                f"unsupported format version {manifest['version']}")
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    return _decode(manifest["spec"], arrays, _type_table(), device)


def save(obj, path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(obj))


def load(path: str, device: torch.device | str = "cuda"):
    with open(path, "rb") as f:
        return loads(f.read(), device)
