"""Whole step: the dense model's operations an example (its reference's
``example_flops``, for DLRM the towers and the interaction, forward and
backward) times the run's examples a second, over the card's bf16 dense
peak, in %."""

from perfbench import roofline


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * run.example_flops * run.examples_per_s / roofline.BF16_DENSE_FLOPS
