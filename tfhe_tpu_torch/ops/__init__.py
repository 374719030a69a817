"""Kernels and exact integer contractions of the port."""

from .. import instrument


def kernel_wrappers() -> dict:
    """Every CUDA kernel wrapper of the port, by name. Each adds one to the
    counter of its name (`instrument.count`) where it launches its kernel
    (on CUDA tensors), and nowhere else: reset the counters before a run
    and read them after to see which kernels the run went through."""
    from . import blind_rotate, cmux_step, compact, fused_step, mk_cmux

    return {
        "cmux_step_karatsuba": fused_step.cmux_step_karatsuba_kernel,
        "blind_rotate": blind_rotate.blind_rotate_kernel,
        "blind_rotate_compact": compact.blind_rotate_compact_kernel,
        "expand_karatsuba_step": compact.expand_step_kernel,
        "rotate_decompose": cmux_step.rotate_decompose_kernel,
        "rotate_decompose_rows": blind_rotate.digit_rows_kernel,
        "cmux_matmul": cmux_step.cmux_matmul_kernel,
        "cmux_step_sparse": mk_cmux.cmux_step_sparse_kernel,
        "mk_blind_rotate_chunk": mk_cmux.mk_blind_rotate_chunk_kernel,
        "mk_blind_rotate_compact": mk_cmux.mk_blind_rotate_compact_kernel,
    }


def reset_launches() -> dict:
    """Set every counter of `instrument` to 0; returns `kernel_wrappers()`."""
    instrument.reset()
    return kernel_wrappers()


def launches(wrappers: dict) -> dict:
    """The nonzero counters since the reset, by name: the launches of the
    kernels of `wrappers`, and every other counter of `instrument`
    (`path.*`, `built.*`). `instrument.counts(wrappers)` is the launches
    alone."""
    kernels = kernel_wrappers()
    return {name: n for name, n in instrument.counts().items()
            if name in wrappers or name not in kernels}


def build_seconds() -> dict:
    """Host seconds of the cached table and library builds since the
    reset, by `built.*` counter, to the millisecond."""
    return {name: round(s, 3) for name, s in instrument.seconds().items()}
