"""Whole step: the DLRM step's operations an example
(``roofline.dlrm_example_flops``: towers and interaction, forward and
backward) times the run's examples a second, over the card's bf16 dense
peak, in %."""

from perfbench import roofline


def read(run):
    cfg = run.cfg
    f = roofline.dlrm_example_flops(cfg.num_sparse_features, cfg.embedding_dim, cfg.dense_in_features,
                                    list(cfg.dense_arch_layer_sizes), list(cfg.over_arch_layer_sizes))
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * f * run.examples_per_s / roofline.BF16_DENSE_FLOPS
