"""Device-mesh scale-out for batched gate bootstrapping.

Counterpart of `tfhe_tpu/parallel/mesh.py`, with the same ten functions
and signatures.

Design: SPMD on `torch.distributed`, one process per device. The reference
is single-controller SPMD: one program, `shard_map` over a
`Mesh(("data", "model"))` of every device. PyTorch's idiom is one process
per device, each running the same program on its own shard, so the port
maps it as follows:

| Reference | Port |
| --- | --- |
| `Mesh(devs, ("data", "model"))` | `init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))` over a world of exactly data*model ranks (`make_mesh`) |
| `NamedSharding` / a global `jax.Array` | a `torch.distributed.tensor.DTensor`: `P(("data", "model"))` is `[Shard(0), Shard(0)]` (data-major rows), `P("data")` is `[Shard(0), Replicate()]`, `P()` is `[Replicate(), Replicate()]` (`placements`) |
| a `shard_map` body | plain code on `.to_local()` tensors through the port's normal entry points, so the CUDA kernels run on each rank's shard |
| `lax.psum` / `lax.all_gather(tiled=True)` over `model` | `all_reduce_sum` / `all_gather_rows` on `mesh.get_group("model")` |

A replicated key is the plain tensor every rank holds. Every rank holds the
same full batch (loaded from the same file, or made from the same seed), so
sharding a batch or a key keeps this rank's slice and makes no collective
call (`DTensor.from_local`); `distribute_tensor` would scatter from rank 0,
which gloo cannot do for CUDA tensors.

The collectives go through the small helpers below. Where the group's
backend is gloo and the tensor lies on a card, they stage it through host
memory: chosen by the backend, never after a failure. That is how several
ranks share one card (NCCL refuses two ranks on one GPU), and how the CPU
tests run. They count their calls and staged bytes (`traffic`). An int32
sum wraps mod 2^32 on both backends, as `lax.psum` does, so the reduction
order changes no bit.

Two gaps of the reference are kept or repaired knowingly:
* the sharded keyswitch returns the extracted sample's `cv` unchanged
  (reference `mesh.py:105`), where the unsharded `keyswitch` adds
  `keyswitch_var`: the words are equal, the advisory variance is the
  reference's;
* `shard_mk_cloud_key` carries every field of the key; the reference
  rebuilds it without `sparse` and `balanced` (`mesh.py:262-266`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..api import CloudKey
from ..bootstrap import bootstrap_wo_keyswitch
from ..keyswitch import KeyswitchKey, keyswitch_onehot
from ..lwe import LweSample
from ..ops.conv import i8_matmul, recombine_limbs

AXES = ("data", "model")


# --- collectives ---


@dataclasses.dataclass
class Traffic:
    """What the collective helpers did: calls, and bytes staged through
    host memory (each staged tensor counted once, at its size)."""

    calls: int = 0
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls = 0
        self.staged_bytes = 0


traffic = Traffic()


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in place (int32 wraps mod 2^32); returns x."""
    traffic.calls += 1
    if not _staged(x, group):
        dist.all_reduce(x, group=group)
        return x
    host = x.cpu()
    traffic.staged_bytes += host.nbytes
    dist.all_reduce(host, group=group)
    return x.copy_(host)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in group-rank order
    (`lax.all_gather(..., tiled=True)`)."""
    traffic.calls += 1
    staged = _staged(x, group)
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    if not staged:
        return out
    traffic.staged_bytes += src.nbytes
    return out.to(x.device)


def broadcast_from(x: torch.Tensor, owner: int, group) -> torch.Tensor:
    """Overwrite `x` on every rank of `group` with the copy of group rank
    `owner`; returns x."""
    traffic.calls += 1
    src = dist.get_global_rank(group, owner)
    if not _staged(x, group):
        dist.broadcast(x, src=src, group=group)
        return x
    host = x.cpu()
    traffic.staged_bytes += host.nbytes
    dist.broadcast(host, src=src, group=group)
    return x.copy_(host)


def fetch_rows(x: DTensor, i0: int, i1: int) -> torch.Tensor:
    """Rows [i0, i1) of a tensor sharded along dim 0 over the `model` axis,
    on every rank of the model group: each piece is broadcast from the rank
    that holds it, into a buffer of i1 - i0 rows (the owner of the whole
    range reads its own rows in place). A collective: every rank of the
    group asks for the same rows."""
    mesh = x.device_mesh
    group = mesh.get_group("model")
    me = mesh.get_local_rank("model")
    local = x.to_local()
    blk = local.shape[0]
    owners = range(i0 // blk, (i1 - 1) // blk + 1)
    if len(owners) == 1:
        owner = owners[0]
        lo = i0 - owner * blk
        piece = (local[lo:lo + i1 - i0] if owner == me else
                 torch.empty((i1 - i0,) + local.shape[1:], dtype=local.dtype,
                             device=local.device))
        return broadcast_from(piece, owner, group)
    out = torch.empty((i1 - i0,) + local.shape[1:], dtype=local.dtype,
                      device=local.device)
    for owner in owners:
        lo, hi = max(i0, owner * blk), min(i1, (owner + 1) * blk)
        piece = out[lo - i0:hi - i0]
        if owner == me:
            piece.copy_(local[lo - owner * blk:hi - owner * blk])
        broadcast_from(piece, owner, group)
    return out


# --- meshes, placements, shards ---


def make_mesh(data: int, model: int = 1, devices=None) -> DeviceMesh:
    """A ("data", "model") mesh over the whole process group, whose world
    must be exactly data*model ranks (`multihost.initialize` joins it).
    `devices` is the device type the ranks compute on, "cuda" unless the
    caller names "cpu"."""
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(devices or "cuda", (data, model),
                            mesh_dim_names=AXES)


def placements(spec) -> list:
    """A PartitionSpec-like tuple (one entry per tensor dim: None, an axis
    name, or a tuple of axis names) as DTensor placements over
    ("data", "model"): ("data", "model") on one dim is [Shard(d), Shard(d)],
    data-major."""
    out = [Replicate(), Replicate()]
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for axis in axes:
            if axis is not None:
                out[AXES.index(axis)] = Shard(dim)
    return out


def _rank_rows(mesh: DeviceMesh, spec) -> tuple:
    """(index, count) of this rank's block along the sharded dim of a spec
    that shards one dim over one or both axes, data-major."""
    index, count = 0, 1
    for axis, plc in zip(AXES, placements(spec)):
        if isinstance(plc, Shard):
            size = mesh.size(AXES.index(axis))
            index = index * size + mesh.get_local_rank(axis)
            count *= size
    return index, count


def _shard(t: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """This rank's block of a tensor every rank holds whole, as a DTensor
    (no collective). The block is a copy, so the whole tensor is freed
    once the caller drops it."""
    plc = placements(spec)
    dims = {p.dim for p in plc if isinstance(p, Shard)}
    local = t
    if dims:
        (dim,) = dims
        index, count = _rank_rows(mesh, spec)
        if t.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over {count} ranks")
        blk = t.shape[dim] // count
        local = t.narrow(dim, index * blk, blk).clone(
            memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, plc, run_check=False)


def _local(x):
    """A DTensor's local tensor; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _local_sample(x):
    return type(x)(*(_local(f) for f in x))


def shard_cloud_key(ck: CloudKey, mesh: DeviceMesh) -> CloudKey:
    """Place the key material: the bootstrap key replicated (every rank
    keeps it whole), the keyswitch table row-blocked over `model`: each
    rank keeps rows [m*R/model, (m+1)*R/model) of the (j, h, i)-ordered
    int8[R, 4*cols_p] table (R = l*2^b*n_in)."""
    ks = ck.keyswitch_key
    table = _shard(ks.table_limbs, mesh, ("model", None))
    return CloudKey(ck.params, ck.bootstrap_key,
                    dataclasses.replace(ks, table_limbs=table))


def shard_batch(x: LweSample, mesh: DeviceMesh) -> LweSample:
    """Shard a ciphertext batch over all ranks (both axes flattened,
    data-major)."""
    rows = (AXES,)
    return LweSample(*(_shard(f, mesh, rows) for f in x))


def _keyswitch_tp(ks: KeyswitchKey, u: LweSample, mesh: DeviceMesh
                  ) -> LweSample:
    """Keyswitch with the table row-blocked on `model`.

    u's batch is whole across `model`; the rank's table block meets the
    one-hot columns [start, start + block) at its position along `model`,
    and the int32 partial products meet in an all-reduce before the limbs
    recombine. cv passes through unchanged, as in the reference.
    """
    l, b = ks.decomp_length, ks.log2_base
    table = _local(ks.table_limbs)
    block = table.shape[0]
    k_dim = ks.n_in * l * (1 << b)

    onehot = keyswitch_onehot(u.a, l, b).reshape(-1, k_dim)
    start = mesh.get_local_rank("model") * block
    partial = i8_matmul(onehot[:, start:start + block], table)
    acc = recombine_limbs(all_reduce_sum(partial, mesh.get_group("model")))
    return LweSample(-acc[:, :ks.n_out], u.b - acc[:, ks.n_out], u.cv)


def _gather_keyswitch(ks: KeyswitchKey, u: LweSample, mesh: DeviceMesh
                      ) -> LweSample:
    """Regroup the model-axis batch shards within each data row, run the
    row-blocked keyswitch, and return the batch sharded over `data`."""
    group = mesh.get_group("model")
    u = LweSample(*(all_gather_rows(f, group) for f in u))
    out = _keyswitch_tp(ks, u, mesh)
    plc = placements(("data",))
    return LweSample(*(DTensor.from_local(f, mesh, plc, run_check=False)
                       for f in out))


def make_bootstrap_sharded(mesh: DeviceMesh, params):
    """The SPMD batched bootstrap: the blind rotation data-parallel over
    every rank (each rank's shard through `bootstrap_wo_keyswitch`, its
    kernels on a card), an all-gather over `model`, then the row-blocked
    keyswitch with an all-reduce.

    Returns f(ck, mu, x) -> LweSample: ck from `shard_cloud_key`; x from
    `shard_batch` (or this rank's local shard); the result's fields are
    DTensors sharded over `data` (`[Shard(0), Replicate()]`).
    """
    def fn(ck: CloudKey, mu, x: LweSample) -> LweSample:
        u = bootstrap_wo_keyswitch(ck.bootstrap_key, mu, _local_sample(x))
        return _gather_keyswitch(ck.keyswitch_key, u, mesh)

    return fn


def shard_bootstrap_key_model(bk, mesh: DeviceMesh):
    """Shard a Karatsuba-baked bootstrap key's output column groups over
    `model`: each rank keeps groups [m*G/model, (m+1)*G/model) of the
    G = (k+1)*4 (k, limb) groups of every step, 1/model of the key bytes,
    in the reference layout int8[n, rows, G/model*T] that
    `karatsuba_delta_cols` reads (cut from a card's K-major key step by
    step, `ops/karatsuba.py:bake_column_shard`). Consumed by
    `make_blind_rotate_model_sharded`.
    """
    from ..ops.karatsuba import bake_column_shard

    if bk.depth <= 0:
        raise ValueError("model sharding targets the Karatsuba bake")
    if bk.compact:
        raise ValueError("compact (prepared) keys have no baked columns")
    model = mesh.size(AXES.index("model"))
    n_groups = (bk.mask_size + 1) * 4
    if n_groups % model:
        raise ValueError(f"{n_groups} column groups over {model} ranks")
    g_per = n_groups // model
    g0 = mesh.get_local_rank("model") * g_per
    local = bake_column_shard(bk.baked, g0, g_per, bk.block)
    cols = DTensor.from_local(local, mesh, placements((None, None, "model")),
                              run_check=False)
    return dataclasses.replace(bk, baked=cols)


def make_blind_rotate_model_sharded(mesh: DeviceMesh):
    """SPMD blind rotation with the bootstrap key column-sharded on `model`.

    The batch rides `data`; each model rank computes the partial CMUX delta
    of its (k, limb) column groups (`karatsuba_delta_cols`) and the ranks
    meet in an int32 all-reduce per step, exact mod 2^32, so the result is
    bit-identical to the unsharded rotation. Like the reference's scan of
    jnp, this runs no hand-written kernel: it buys 1/model of the key
    bytes per rank for an all-reduce of [B_data, k+1, N] words a step.

    Returns f(bk, acc_a, bara) -> acc_a' : bk from
    `shard_bootstrap_key_model`; acc_a int32[B, k+1, N] and bara
    int32[B, n], the whole batch (each rank keeps its data block) or
    DTensors sharded over `data`; the result a DTensor sharded over
    `data`.
    """
    def fn(bk, acc_a, bara):
        from ..ops.karatsuba import karatsuba_delta_cols
        from ..polynomial import mul_by_monomial
        from ..tgsw import decompose

        model = mesh.size(AXES.index("model"))
        k1 = bk.mask_size + 1
        n_groups = k1 * 4
        if n_groups % model:
            raise ValueError(f"{n_groups} column groups over {model} ranks")
        g_per = n_groups // model
        g0 = mesh.get_local_rank("model") * g_per
        gids = tuple(((g0 + j) // 4, (g0 + j) % 4) for j in range(g_per))
        l, b, t = bk.decomp_length, bk.log2_base, bk.block
        plan = bk.plan
        group = mesh.get_group("model")

        def data_rows(x):
            return _local(x if isinstance(x, DTensor)
                          else _shard(x, mesh, ("data",)))

        acc = data_rows(acc_a).contiguous()
        bara_t = data_rows(bara).to(torch.int32).t().contiguous()
        for e_i, bara_i in zip(_local(bk.baked), bara_t):
            rot = mul_by_monomial(acc, bara_i[:, None])
            # bk.balanced must ride through: with gadget_balanced presets
            # the truncating gadget's bias is fatal at l*b = 16, and
            # dropping it would make the sharded rotation diverge bit-wise
            # from blind_rotate.
            digits = decompose(rot - acc, l, b, bk.balanced)
            digits = digits.reshape(acc.shape[0], k1 * l, acc.shape[-1])
            delta = karatsuba_delta_cols(digits, e_i, t, plan, gids, k1)
            acc = acc + all_reduce_sum(delta, group)
        return DTensor.from_local(acc, mesh, placements(("data",)),
                                  run_check=False)

    return fn


def shard_mk_cloud_key(ck, mesh: DeviceMesh):
    """Place the multi-key evaluation key on the mesh.

    The expanded MK bootstrap key (party-major steps; grows as parties^2)
    is sharded over `model` along its step dimension: each model rank
    keeps a contiguous run of parties*n/model steps (int8[parties*n/model,
    4, P, K, 2N] prepared, or the baked rows on the CPU), or, stored
    sparse, parties/model whole parties of the tuple (stacked). The
    rotation fetches one party's block from its owners when it reaches
    that party (`mk.internals.party_limbs`), so a rank holds 1/model of
    the key plus one party: the port's form of the reference's "XLA
    regathers each step's slice". Every field of the key is carried.

    The parties' keyswitch tables stay whole on every rank: `mk_gate_nand`
    runs on each rank's own batch shard, which a row-blocked table would
    have to regather every gate (GSPMD does that for the reference). Pass
    `mk_gate_nand` the sharded key unchanged and the local shards of
    `shard_mk_batch`.
    """
    from ..mk.api import MKCloudKey

    bk = ck.bootstrap_key
    model = mesh.size(AXES.index("model"))
    steps = (AXES[1],)
    if bk.sparse:
        if bk.parties % model:
            raise ValueError(f"{bk.parties} parties over {model} ranks")
        per = bk.parties // model
        m = mesh.get_local_rank("model")
        local = torch.stack(bk.limbs[m * per:(m + 1) * per])
        limbs = DTensor.from_local(local, mesh, placements(steps),
                                   run_check=False)
    else:
        limbs = _shard(bk.limbs, mesh, steps)
    return MKCloudKey(ck.params, ck.parties,
                      dataclasses.replace(bk, limbs=limbs),
                      ck.keyswitch_keys)


def shard_mk_batch(x, mesh: DeviceMesh):
    """Shard an MKLweSample batch over all ranks (both axes flattened)."""
    from ..mk.internals import MKLweSample

    rows = (AXES,)
    return MKLweSample(*(_shard(f, mesh, rows) for f in x))


def make_pbs_sharded(mesh: DeviceMesh, params, space: int):
    """SPMD programmable bootstrap: the LUT blind rotation data-parallel,
    then the row-blocked keyswitch, as `make_bootstrap_sharded`; the
    plaintext LUT (int[S], one table for the batch) is replicated.
    Returns f(ck, table, x) -> LweSample sharded over `data`."""
    from ..pbs import programmable_bootstrap_wo_keyswitch

    def fn(ck: CloudKey, table, x: LweSample) -> LweSample:
        u = programmable_bootstrap_wo_keyswitch(
            ck.bootstrap_key, table, _local_sample(x), space)
        return _gather_keyswitch(ck.keyswitch_key, u, mesh)

    return fn


def make_gate_nand_sharded(mesh: DeviceMesh, params):
    """Batched sharded NAND: the affine combination on the local shards,
    then the sharded bootstrap. Returns f(ck, x, y) -> LweSample sharded
    over `data`. Reference semantics: src/gates.jl:15-18."""
    from ..lwe import lwe_noiseless_trivial
    from ..numeric import encode_message

    bootstrap_fn = make_bootstrap_sharded(mesh, params)
    mu = encode_message(1, 8)

    def fn(ck: CloudKey, x: LweSample, y: LweSample) -> LweSample:
        x, y = _local_sample(x), _local_sample(y)
        result = lwe_noiseless_trivial(mu, x.n, x.batch_shape,
                                       x.a.device) - x - y
        return bootstrap_fn(ck, mu, result)

    return fn
