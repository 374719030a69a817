"""Restartable encrypted-circuit jobs: checkpointed Schedule execution.

Counterpart of `tfhe_tpu/utils/jobs.py`. A long netlist job has one piece
of mutable state, the stacked wire-state LweSample, and the boundaries of
the scheduled batches are exact resume points
(`netlist.Schedule.run_batches`). `run_checkpointed` runs a compiled
Schedule in chunks of `every` scheduled batches and after each chunk
writes (job fingerprint, next batch, wire state) to disk through
`utils/serialization.py` with an atomic replace. A restarted process with
the same arguments resumes at the last finished chunk and ends with the
same words as an uninterrupted run; a checkpoint of another job (circuit,
schedule, batch shape, parameters or a result-affecting knob changed) has
another fingerprint and is ignored.

The fingerprint hashes the same bytes as the reference's (the same arrays,
`repr(params)`, and `tuning.result_fingerprint()`'s JSON with the
reference's keys), so a checkpoint file carries over between the packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Callable, Optional

import numpy as np

from ..lwe import LweSample
from . import serialization


def job_fingerprint(schedule, params, batch_shape) -> str:
    """Digest of everything that determines a job's execution plan."""
    from ..tuning import get_tuning

    circ = schedule.circuit
    h = hashlib.sha256()
    for arr in (
        np.asarray(circ.gate_type, np.int32),
        np.asarray(circ.fanin, np.int32),
        np.asarray(circ.out_wire, np.int32),
        np.asarray(schedule.gate_order, np.int32),
        np.asarray(schedule.batch_start, np.int32),
        np.asarray(schedule.batch_type, np.int32),
    ):
        h.update(arr.tobytes())
        h.update(b"|")
    h.update(json.dumps(sorted(
        (int(k), bool(v)) for k, v in circ.const_value.items())).encode())
    if schedule.wire_slot is not None:
        h.update(np.asarray(schedule.wire_slot, np.int32).tobytes())
    h.update(repr(tuple(batch_shape)).encode())
    h.update(repr(params).encode())  # a frozen dataclass: a stable repr
    # result-affecting knobs only: the others give the same words
    h.update(get_tuning().result_fingerprint().encode())
    return h.hexdigest()


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    serialization.save(obj, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, fingerprint: str, device="cuda"):
    """(next_batch, state on `device`) from a valid checkpoint of this job,
    else None."""
    if not os.path.exists(path):
        return None
    try:
        saved_fp, next_batch, state = serialization.load(path, device)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # a truncated or corrupt file: start afresh
    if saved_fp != fingerprint:
        return None
    return int(next_batch), state


def run_checkpointed(
    schedule,
    ck,
    inputs,
    checkpoint_path: str,
    *,
    batch_shape=(),
    every: int = 8,
    on_chunk: Optional[Callable[[int, int], None]] = None,
) -> LweSample:
    """Execute `schedule` with a checkpoint after every `every` scheduled
    batches; resume from the checkpoint if one of this job exists.

    on_chunk(done_batches, total_batches) is called after each checkpoint
    write (progress, or raising to simulate a preemption in tests).
    Returns the final wire state (as `Schedule.run`) on the cloud key's
    device; the checkpoint file is removed on completion.
    """
    device = ck.keyswitch_key.table_limbs.device
    fp = job_fingerprint(schedule, ck.params, batch_shape)
    resumed = load_checkpoint(checkpoint_path, fp, device)
    if resumed is not None:
        start, state = resumed
    else:
        start, state = 0, schedule.init_state(ck, inputs, batch_shape)

    nb = schedule.n_batches
    while start < nb:
        hi = min(start + every, nb)
        state = schedule.run_batches(ck, state, start, hi)
        # the copy to the host waits for the chunk: no checkpoint is
        # written before the chunk has really finished
        host = LweSample(state.a.cpu(), state.b.cpu(), state.cv.cpu())
        _save_atomic((fp, hi, host), checkpoint_path)
        start = hi
        if on_chunk is not None:
            on_chunk(start, nb)
    if os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    return state
