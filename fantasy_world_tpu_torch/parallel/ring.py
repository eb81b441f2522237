"""Ring attention (``parallel/ring.py``): the queries stay on their rank
and the key/value parts travel round the seq group.

In each of n steps every rank attends its queries to one key/value part
through the stats forward (``ops/attention.py:attention_with_stats``,
which reaches the hand kernels' (m2, l) output on the card) and passes the
part on to the previous rank (``RingShift``: one send and one receive,
or the shared staging buffers for ranks on one card over gloo) while the
next step's part arrives. The partial outputs merge exactly in the base-2
domain:

    m = max(m_a, m_b),  w_x = l_x * exp2(m_x - m),
    o = (w_a * o_a + w_b * o_b) / (w_a + w_b).

Ragged splits: each part is zero-padded to the largest for the hop. A
zero key scores exactly 0, so a part with p padded keys is corrected in
closed form after its step -- l' = l - p * exp2(-m2), o' = o * l / l' --
the zero-pad correction of the flash kernel, lifted one level up. A rank
without a key would leave l' = 0; that split takes the gather path
(``ulysses.gather_attention``) instead.

The ring moves 2 * (L/n)*H*D * (n-1)/n bytes per rank, no more than
Ulysses, and has no head constraint; ``ulysses_attention`` falls through
to it when the heads do not divide.
"""
from __future__ import annotations

from typing import Optional

import torch

from .distributed import RingShift, _pad_dim
from .sharding import TokenSplit


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   kv_split: TokenSplit,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: this rank's queries (b, Lq, H, D), any H; k/v: its
    (b, kv_split.local, H, D) keys and values. Returns the attention of its
    queries over every rank's keys, in q.dtype."""
    from ..ops.attention import attention_with_stats
    from ..ops.flash_attention import flash_attention
    from .ulysses import gather_attention
    n = kv_split.n
    if n == 1:
        return flash_attention(q, k, v, scale=scale)
    if min(kv_split.sizes) == 0:
        return gather_attention(q, k, v, kv_split=kv_split, scale=scale)
    big = max(kv_split.sizes)
    kv = torch.stack([_pad_dim(k, 1, big), _pad_dim(v, 1, big)])
    o_acc = m_acc = l_acc = None
    for t in range(n):
        part = (kv_split.index + t) % n
        hop = RingShift(kv, kv_split.group) if t < n - 1 else None
        o_t, m_t, l_t = attention_with_stats(q, kv[0], kv[1], scale=scale)
        o_t = o_t.float()
        pad = big - kv_split.sizes[part]
        if pad:
            l_new = l_t - pad * torch.exp2(-m_t)
            o_t = o_t * (l_t / l_new)[..., None]
            l_t = l_new
        if o_acc is None:
            o_acc, m_acc, l_acc = o_t, m_t, l_t
        else:
            m_new = torch.maximum(m_acc, m_t)
            w_a = l_acc * torch.exp2(m_acc - m_new)
            w_t = l_t * torch.exp2(m_t - m_new)
            l_new = w_a + w_t
            o_acc = (o_acc * (w_a / l_new)[..., None]
                     + o_t * (w_t / l_new)[..., None])
            m_acc, l_acc = m_new, l_new
        if hop is not None:
            kv = hop.wait()
    return o_acc.to(q.dtype)
