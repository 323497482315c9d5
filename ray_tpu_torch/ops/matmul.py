"""Matrix products with float32 results from low-precision operands.

The JAX package writes ``einsum(..., preferred_element_type=float32)``
for the products whose result feeds a softmax: attention scores, the
tied-embedding logits and the cross-entropy weight gradient.  A bf16
``torch.matmul`` rounds its result to bf16, so the port goes the other
way: it upcasts the bf16 operands to float32 and multiplies in float32.
That loses nothing against JAX (only the summation order differs).

On the card the float32 product runs on the tensor cores in TF32, and
that too is exact here: a bf16 (or fp16) value has at most 11
significant bits and TF32 keeps 11, so the operands reach the tensor
cores unchanged, each product of two is exact in float32 and the sum
accumulates in float32.  TF32 is switched on only around these products
and only when both operands were bf16 or fp16; a genuine float32
operand keeps full float32.
"""

from __future__ import annotations

import contextlib

import torch

_TF32_EXACT = (torch.bfloat16, torch.float16)


@contextlib.contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, exact products and float32
    accumulation, whatever the operands' float type."""
    exact_in_tf32 = a.dtype in _TF32_EXACT and b.dtype in _TF32_EXACT
    a, b = a.float(), b.float()
    if exact_in_tf32 and a.is_cuda:
        with _tf32():
            return torch.matmul(a, b)
    return torch.matmul(a, b)
