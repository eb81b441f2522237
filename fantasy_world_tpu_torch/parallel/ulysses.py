"""Ulysses sequence-parallel attention (``parallel/ulysses.py``): the head
re-shard of the reference's xfuser USP, over ``all_to_all`` of the seq
group.

Every rank holds its tokens (``TokenSplit``) of every head. Around the
attention one all-to-all re-shards q, k and v to "all tokens, H/n heads",
this rank's kernel runs over the whole sequence, and the inverse all-to-all
restores the token split:

  bytes per rank     (L tokens, H heads, D head dim, n = seq ranks)
    k/v gather:       2 * L*H*D * (n-1)/n
    Ulysses:          4 * (L/n)*H*D * (n-1)/n    (q, k, v in; o out)

Ragged splits (the production 16,317 and 16,422 tokens, split at frame
boundaries): each rank's part is zero-padded to the largest for the
all-to-all, and the padding is cut off again right after it -- the key
side before the attention (no masking needed), the query side after the
output all-to-all.

When the head count does not divide by n (the 12 bicross heads at 8 seq
ranks) the call goes to ``ring_attention``, which has no head constraint.

``ulysses_context`` turns the re-shard on for a region: the fusion forward
enters it under ``ulysses=True``, and ``sequence_parallel_attention``
(reached from ``ops/attention.py:dot_product_attention`` whenever the keys
are split over the seq group) then re-shards every such attention. Only
whole-sequence attentions split their keys (DiT self, VGGT global,
bicross); the text and image keys of the cross-attentions stay whole on
every rank, so the JAX package's query-length threshold has nothing to
keep local here and the port has none. Outside the context, a split
attention gathers the keys and values of every rank instead -- what GSPMD
does in the JAX package without Ulysses.

Training differentiates all three: the all-to-all's backward is the same
exchange of the gradients (``distributed.all_to_all``), the gather's sums
the ranks' k/v gradients at their owner, and the ring has a backward ring
of its own (``ring.RingAttention``). ``ulysses_context`` is a region of the
forward; a block recomputed on the backward (``models/fusion/model.py:
_run``) re-enters the context it ran in.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from .distributed import _pad_dim, all_to_all
from .sharding import TokenSplit


def _to_heads(ts: List[torch.Tensor], split: TokenSplit
              ) -> List[torch.Tensor]:
    """Each (b, local, H, D) -> (b, L, H/n, D): this rank's head group of
    the whole sequence, in one all-to-all."""
    n, big = split.n, max(split.sizes)
    x = torch.stack([_pad_dim(t, 1, big) for t in ts])     # (c, b, big, H, D)
    c, b, _, H, D = x.shape
    x = x.view(c, b, big, n, H // n, D).permute(3, 0, 1, 2, 4, 5)
    y = all_to_all(x.contiguous(), split.group)   # y[j]: rank j's tokens
    whole = torch.cat([y[j, :, :, :split.sizes[j]] for j in range(n)], dim=2)
    return list(whole.unbind(0))


def _to_tokens(o: torch.Tensor, split: TokenSplit) -> torch.Tensor:
    """(b, L, H/n, D) -> (b, local, H, D): this rank's tokens of every head
    group."""
    n, big = split.n, max(split.sizes)
    x = torch.stack([_pad_dim(c, 1, big)
                     for c in torch.split(o, list(split.sizes), dim=1)])
    y = all_to_all(x, split.group)[:, :, :split.local]   # y[j]: heads of j
    b, loc, h, D = y.shape[1:]
    return y.permute(1, 2, 0, 3, 4).reshape(b, loc, n * h, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_split: TokenSplit,
                      kv_split: Optional[TokenSplit] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel dense attention. q: this rank's (b, q_split.local,
    H, D) tokens, k/v: its (b, kv_split.local, H, D) (``kv_split``
    defaults to ``q_split``: self-attention). Returns this rank's tokens of
    ``dot_product_attention`` over the whole sequences. H % n != 0 goes to
    ``ring_attention``."""
    from ..ops.flash_attention import flash_attention
    kv_split = kv_split or q_split
    n = q_split.n
    if n == 1:
        return flash_attention(q, k, v, scale=scale)
    if q.shape[2] % n:
        from .ring import ring_attention
        return ring_attention(q, k, v, kv_split=kv_split, scale=scale)
    (qh,) = _to_heads([q], q_split)
    kh, vh = _to_heads([k, v], kv_split)
    return _to_tokens(flash_attention(qh, kh, vh, scale=scale), q_split)


def gather_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_split: TokenSplit,
                     scale: Optional[float] = None) -> torch.Tensor:
    """This rank's queries against every rank's keys and values, gathered
    in one collective (each rank's queries use them: the backward sums the
    ranks' k/v gradients and keeps this rank's part)."""
    from ..ops.flash_attention import flash_attention
    kv = kv_split.gather(torch.stack([k, v]), dim=2, grad="reduce_scatter")
    return flash_attention(q, kv[0], kv[1], scale=scale)


def attention_mode(num_heads: int, q_split: Optional[TokenSplit],
                   kv_split: TokenSplit) -> str:
    """How an attention with keys split over ``kv_split`` runs: "ulysses"
    (under ``ulysses_context``, queries split too, heads dividing), "ring"
    (the same, heads not dividing), else "gather"; "ring" becomes "gather"
    where a rank holds no key."""
    if (current_ulysses() is None or q_split is None
            or q_split.n != kv_split.n):
        return "gather"
    if num_heads % q_split.n == 0:
        return "ulysses"
    return "ring" if min(kv_split.sizes) > 0 else "gather"


def sequence_parallel_attention(q, k, v, *, q_split: Optional[TokenSplit],
                                kv_split: TokenSplit,
                                scale: Optional[float] = None):
    """The dispatch for keys split over the seq group (``attention_mode``).
    """
    mode = attention_mode(q.shape[2], q_split, kv_split)
    if mode == "ulysses":
        return ulysses_attention(q, k, v, q_split=q_split, kv_split=kv_split,
                                 scale=scale)
    if mode == "ring":
        from .ring import ring_attention
        return ring_attention(q, k, v, kv_split=kv_split, scale=scale)
    return gather_attention(q, k, v, kv_split=kv_split, scale=scale)


# ---------------------------------------------------------------------------
# context: model code passes its token splits and no mesh; the fusion
# forward turns the re-shard on for its block stack
# ---------------------------------------------------------------------------

_STATE = threading.local()


def current_ulysses():
    """The mesh inside ``ulysses_context``, else None."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def ulysses_context(mesh):
    """Re-shard every split attention through Ulysses (or the ring) while
    the context is open; ``mesh`` None turns it off."""
    prev = current_ulysses()
    _STATE.ctx = mesh
    try:
        yield
    finally:
        _STATE.ctx = prev
