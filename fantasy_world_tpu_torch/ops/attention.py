"""Single attention dispatch (``ops/attention.py:dot_product_attention``).

Layout (B, L, H, D); RoPE is applied by callers. A CPU tensor takes the
plain PyTorch version; a CUDA tensor takes a hand-written Hopper kernel
(``ops/flash_attention.py``) or raises. There is no fallback between them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None) -> torch.Tensor:
    """Dense bidirectional attention; q: (B, Lq, H, D), k/v: (B, Lk, H, D)
    -> (B, Lq, H, D) in q.dtype, softmax statistics in f32."""
    return flash_attention(q, k, v, scale=scale)
