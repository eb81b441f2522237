"""Single attention dispatch (``ops/attention.py:dot_product_attention``).

Layout (B, L, H, D); RoPE is applied by callers. A CPU tensor takes the
plain PyTorch version; a CUDA tensor takes a hand-written Hopper kernel
(``ops/flash_attention.py``) or raises. There is no fallback between them.

On a mesh, a caller whose keys are this rank's part of a sequence split
over the seq group passes the splits (``parallel/sharding.py:TokenSplit``)
and the call goes through ``parallel/ulysses.py``: the k/v gather, or,
inside ``ulysses_context``, Ulysses or the ring.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_stats


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None,
                          q_split=None, kv_split=None) -> torch.Tensor:
    """Dense bidirectional attention; q: (B, Lq, H, D), k/v: (B, Lk, H, D)
    -> (B, Lq, H, D) in q.dtype, softmax statistics in f32. Differentiable
    (the flash-attention backward kernels on the card).

    ``kv_split`` / ``q_split``: k/v (q) hold this rank's tokens of
    sequences split over a seq group of more than one rank; the result is
    this rank's queries over every rank's keys."""
    if kv_split is not None and kv_split.n > 1:
        from ..parallel.ulysses import sequence_parallel_attention
        return sequence_parallel_attention(q, k, v, q_split=q_split,
                                           kv_split=kv_split, scale=scale)
    return flash_attention(q, k, v, scale=scale)


def attention_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None):
    """Attention that also returns its softmax statistics: (o, m2, l) with
    m2/l (B, Lq, H) f32 in the base-2 domain -- s2 = log2(e)*scale*(q.k),
    m2 = max_k s2, l = sum_k exp2(s2 - m2). Partial results over key shards
    merge exactly: m = max(m_a, m_b), w_x = l_x * exp2(m_x - m),
    o = (w_a*o_a + w_b*o_b) / (w_a + w_b). Forward only: the primitive the
    ring's forward (``parallel/ring.py``) is built from; the ring's
    backward (``RingAttention``) runs the backward kernels per part."""
    return flash_attention_stats(q, k, v, scale=scale)
