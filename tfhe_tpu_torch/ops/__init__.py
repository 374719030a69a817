"""Kernels and exact integer contractions of the port."""


def kernel_wrappers() -> dict:
    """Every CUDA kernel wrapper of the port, by name. Each adds one to its
    `.launches` where it launches its kernel (on CUDA tensors), and nowhere
    else: set them to 0 before a run and read them after to see which
    kernels the run went through."""
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
    """Set every wrapper's launch count to 0; returns `kernel_wrappers()`."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def launches(wrappers: dict) -> dict:
    """The nonzero launch counts of `wrappers`, by name."""
    return {name: fn.launches for name, fn in wrappers.items() if fn.launches}
