"""Device ops of the port: the CUDA kernels (gather_rows, binned_sgd with its
SGD and Adagrad entries, binned_scatter_add, stochastic_round,
ordered_scatter_add with its ordered_grad_update entry) and the plain tensor
ops around them."""


def kernel_wrappers() -> dict:
    """Each CUDA kernel entry's wrapper, by name. A wrapper's ``launches``
    counts where it launches its kernel, never where it runs its plain
    version."""
    from cachedembedding_tpu_torch.ops.binned_scatter import (
        binned_adagrad_update,
        binned_scatter_add,
        binned_sgd_update,
    )
    from cachedembedding_tpu_torch.ops.gather_rows import gather_rows
    from cachedembedding_tpu_torch.ops.ordered_scatter import ordered_grad_update_, ordered_scatter_add_
    from cachedembedding_tpu_torch.ops.rounding import stochastic_astype, stochastic_sgd_round_

    return {"gather_rows": gather_rows, "binned_sgd": binned_sgd_update, "binned_adagrad": binned_adagrad_update,
            "binned_scatter_add": binned_scatter_add, "stochastic_round": stochastic_astype,
            "stochastic_sgd_round": stochastic_sgd_round_, "ordered_scatter_add": ordered_scatter_add_,
            "ordered_grad_update": ordered_grad_update_}


def launch_counts() -> dict:
    """CUDA kernel launches of this process so far, by entry."""
    return {name: w.launches for name, w in kernel_wrappers().items()}
