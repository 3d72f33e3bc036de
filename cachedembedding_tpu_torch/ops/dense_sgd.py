"""The dense towers' SGD step, the one every layout takes: the one-card
trainer (``train/trainer.py``), the column-wise mesh window
(``train/mesh_window.py``), and the table-wise, row-sharded and hybrid steps
(``parallel/``). Each calls it after the backward, on a mesh after the dense
grads are summed over the ranks (``parallel/collectives.all_reduce_grads``).

Plain tensor ops, two launches a parameter: ``p - lr * g`` in place, then
the grad dropped, so the next backward writes a fresh one.
"""

import torch


@torch.no_grad()
def dense_sgd_(params, lr: float) -> None:
    """``p -= lr * p.grad`` for each parameter in order, its grad then None."""
    for p in params:
        p.sub_(p.grad * lr)
        p.grad = None
