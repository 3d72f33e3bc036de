"""The yardstick of the kernel and step shares: the card's published peaks,
the names by which each kernel shows in a device trace, and the bytes and
operations each kernel's call and each training example need, from shapes.

Bytes follow one rule: each input byte is read once and each output byte
written once, counting what these inputs need and not what a kernel reads
again. A row that a step's ids name several times is read once: ``U`` is
the step's count of distinct ids, ``L`` its count of ids.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_FLOPS = 989e12

# device-trace kernel names of each kernel (demangled or mangled), and of
# the cuBLAS/CUTLASS matrix products of the dense towers and the interaction
KERNEL_PATTERNS = {
    "gather_rows": re.compile(r"gather_rows_kernel"),
    "binned_sgd": re.compile(r"(chunk_kernel|finish_kernel).*SgdEpilogue"),
    "ordered_scatter": re.compile(r"classify_kernel|sort_kernel|heavy_kernel|light_kernel"),
    "gemm": re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE),
}
_OWN = ("gather_rows", "binned_sgd", "ordered_scatter")


def kernel_of(name: str):
    """The kernel a device-trace name belongs to, or None: the port's own
    kernels first, then the matrix products."""
    for k in (*_OWN, "gemm"):
        if KERNEL_PATTERNS[k].search(name):
            return k
    return None


def gather_rows_bytes(L: int, U: int, D: int, row_bytes: int) -> int:
    """Kernel 1, one step: reads the L int32 ids and the U distinct rows of
    D elements of ``row_bytes``; writes the (L, D) gathered rows."""
    return 4 * L + U * D * row_bytes + L * D * row_bytes


def update_bytes(L: int, U: int, D: int, row_bytes: int, grad_bytes: int) -> int:
    """Kernels 2 (``binned_sgd``) and 5 (``ordered_scatter``), one step:
    read the L gradient rows (D elements of ``grad_bytes``), the plan's two
    int32 streams of L (the permutation and the sorted row ids), and the U
    touched rows; write the U touched rows."""
    return L * D * grad_bytes + 2 * 4 * L + 2 * U * D * row_bytes


def linear_flops(sizes_in_out, first_takes_grad: bool) -> int:
    """Per example, a tower of ``Linear`` layers ``[(in, out), ...]``:
    forward ``2 in out`` a layer, the weight gradient ``2 in out``, the
    input gradient ``2 in out`` on every layer but a first whose input
    takes no gradient."""
    f = 0
    for i, (a, b) in enumerate(sizes_in_out):
        f += 2 * a * b * (3 if (i or first_takes_grad) else 2)
    return f


def dlrm_example_flops(num_tables: int, dim: int, dense_in: int, bottom, top) -> int:
    """Operations per training example of the DLRM step (forward and
    backward), from its shapes: the bottom tower (its first layer's input,
    the dense features, takes no gradient), the ``P = n (n - 1) / 2``
    pairwise dots of the ``n = F + 1`` vectors of D (forward ``2 P D``;
    backward, each pair's cotangent into both vectors, ``4 P D``), and the
    top tower from ``D + P`` inputs. Bias, activation and loss terms are
    linear in the widths and left out (under 0.1% of the total)."""
    b_sizes = list(zip([dense_in, *bottom[:-1]], bottom))
    n = num_tables + 1
    P = n * (n - 1) // 2
    t_sizes = list(zip([dim + P, *top[:-1]], top))
    return linear_flops(b_sizes, False) + 6 * P * dim + linear_flops(t_sizes, True)


def memory_share(bytes_per_step: float, steps: int, seconds: float) -> float:
    """Bytes of ``steps`` calls over their device seconds, in % of the
    card's memory rate."""
    return 100.0 * bytes_per_step * steps / seconds / HBM_BYTES_PER_S
