"""Device ops of the port: the CUDA kernels (gather_rows, binned_sgd,
binned_scatter_add, stochastic_round) and the plain tensor ops around them."""


def kernel_wrappers() -> dict:
    """Each CUDA kernel entry's wrapper, by name. A wrapper's ``launches``
    counts where it launches its kernel, never where it runs its plain
    version."""
    from cachedembedding_tpu_torch.ops.binned_scatter import binned_scatter_add, binned_sgd_update
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
    from cachedembedding_tpu_torch.ops.rounding import stochastic_astype, stochastic_sgd_round_

    return {"gather_rows": gather_rows, "binned_sgd": binned_sgd_update,
            "binned_scatter_add": binned_scatter_add, "stochastic_round": stochastic_astype,
            "stochastic_sgd_round": stochastic_sgd_round_}


def launch_counts() -> dict:
    """CUDA kernel launches of this process so far, by entry."""
    return {name: w.launches for name, w in kernel_wrappers().items()}
