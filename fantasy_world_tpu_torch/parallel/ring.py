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
(``ulysses.gather_attention``) instead, forward and backward.

The ring moves 2 * (L/n)*H*D * (n-1)/n bytes per rank, no more than
Ulysses, and has no head constraint; ``ulysses_attention`` falls through
to it when the heads do not divide.

The backward (``RingAttention``, what XLA derives for the JAX package from
``ppermute`` and the merge) is a second ring over the saved q, this rank's
k/v, the merged o and lse2 = m2 + log2 l: at each hop ``fa_bwd_dq``
adds the part's share of dq (accumulated in f32: the kernel writes, it
does not add) and ``fa_bwd_dkv`` this rank's queries' share of the part's
dk/dv, into f32 accumulators that travel round the ring with the part and
are home after n hops. A padded key is zero, so it adds nothing to dq; its
dk/dv rows are cut. On the CPU the same ring runs the plain backward.
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
    queries over every rank's keys, in q.dtype. Differentiable
    (``RingAttention``) when grad mode is on and an input requires grad."""
    from ..ops.flash_attention import flash_attention
    from .ulysses import gather_attention
    n = kv_split.n
    if n == 1:
        return flash_attention(q, k, v, scale=scale)
    if min(kv_split.sizes) == 0:
        return gather_attention(q, k, v, kv_split=kv_split, scale=scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return RingAttention.apply(q, k, v, kv_split, scale)
    return _ring_forward(q, k, v, kv_split, scale)[0]


def _ring_forward(q, k, v, kv_split: TokenSplit, scale: float):
    """(o in q.dtype, lse2 = m2 + log2 l as (b, Lq, H) f32) of this rank's
    queries over every rank's keys."""
    from ..ops.attention import attention_with_stats
    n = kv_split.n
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
    return o_acc.to(q.dtype), (m_acc + torch.log2(l_acc)).contiguous()


class RingAttention(torch.autograd.Function):
    """The ring forward, saving (q, k, v, o, lse2); the backward ring on
    ``fa_bwd_dq`` / ``fa_bwd_dkv`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_split: TokenSplit, scale: float):
        o, lse2 = _ring_forward(q, k, v, kv_split, scale)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.kv_split, ctx.scale = kv_split, scale
        return o

    @staticmethod
    def backward(ctx, do):
        from ..ops.flash_attention import flash_attention_backward_part
        q, k, v, o, lse2 = ctx.saved_tensors
        split, scale = ctx.kv_split, ctx.scale
        n, big = split.n, max(split.sizes)
        do = do.contiguous()
        kv = torch.stack([_pad_dim(k, 1, big), _pad_dim(v, 1, big)])
        # the dk/dv of the part this rank holds, travelling with it
        acc = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        delta = None
        for t in range(n):
            hop = RingShift(kv, split.group) if t < n - 1 else None
            dq_t, dk_t, dv_t, delta = flash_attention_backward_part(
                q, kv[0], kv[1], o, lse2, do, scale, delta)
            dq += dq_t.float()
            acc[0] += dk_t.float()
            acc[1] += dv_t.float()
            if hop is not None:
                kv = hop.wait()
            # one exchange in flight at a time; after the last part, this
            # hop brings each part's accumulators home to its owner
            acc = RingShift(acc, split.group).wait()
        acc = acc[:, :, :split.local]
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None)
