"""The Hopper attention kernels against their plain PyTorch version, on the
card. Skipped without a CUDA device. The machine with the card has no JAX,
so run these without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from fantasy_world_tpu_torch.chipcheck.common import (MESH_TRAIN_SHAPES,
                                                      SHAPES, grad_tol)
from fantasy_world_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# Bound for unit-variance bf16 inputs: kernel and plain version round q and
# P to bf16 at the same points, so they differ only by f32 summation order
# and one-ulp flips of the bf16 output (at most 2^-7 of the largest |o|).
# The bound is two such ulps, and never more than TOL: at thousands of keys
# |o| is a few hundredths, so TOL alone would pass a dropped key tile.
TOL = 1.5e-2
OUT_RTOL = 2 ** -6
# Statistics are f32 on both sides from the same bf16 logits: only the
# summation order of l and exp2 differ (relative, l >= 1).
STATS_RTOL = 1e-4
# Gradients are held to chipcheck.common.grad_tol: two bf16 ulps of the largest
# |gradient| (the kernels and the plain version round ds and p to bf16 at
# the same points), never looser than 1e-2 of max(1, largest).


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _out_err(out, ref):
    """max |out - ref| over its bound (<= 1 passes)."""
    err = (out.float() - ref.float()).abs().max().item()
    return err / min(TOL, OUT_RTOL * ref.float().abs().max().item())


def _qkv(shape_q, lk, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    B, Lq, H, D = shape_q
    q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
    k = torch.randn((B, lk, H, D), generator=g, device=device).bfloat16()
    v = torch.randn((B, lk, H, D), generator=g, device=device).bfloat16()
    return q, k, v


# (B, Lq, H, D, Lk, expected route): ragged tails in both axes, every
# kernel, every padded head dim; generic and d64 at and around their
# 128-row query blocks and 128-key tiles (1, 127, 128, 129, 255 rows)
SMALL = [
    (1, 1, 2, 64, 1, "d64"),
    (1, 127, 2, 64, 127, "d64"),
    (1, 128, 2, 64, 128, "d64"),
    (2, 129, 2, 64, 129, "d64"),
    (1, 255, 2, 64, 255, "d64"),
    (1, 1, 2, 64, 255, "d64"),
    (1, 255, 2, 64, 1, "d64"),
    (2, 200, 4, 64, 300, "d64"),
    (1, 129, 2, 48, 65, "d64"),            # D padded 48 -> 64
    (2, 130, 3, 128, 81, "onekv"),
    (1, 70, 2, 128, 2048, "onekv"),
    (1, 33, 3, 80, 257, "onekv"),          # D padded 80 -> 128
    (1, 1, 2, 128, 2049, "generic"),
    (1, 127, 2, 128, 2175, "generic"),
    (1, 128, 2, 128, 2176, "generic"),
    (1, 129, 1, 128, 2177, "generic"),
    (2, 255, 1, 128, 2303, "generic"),
    (1, 257, 2, 96, 2100, "generic"),
    (1, 2300, 2, 96, 4100, "generic"),     # Lq != Lk, both orders
    (1, 4100, 2, 96, 2300, "generic"),
    (1, 65, 3, 72, 2200, "generic"),       # D padded 72 -> 96
]


@pytest.mark.parametrize("B,Lq,H,D,Lk,kernel", SMALL)
def test_kernel_matches_plain(device, B, Lq, H, D, Lk, kernel):
    assert fa.route(H, D, Lk) == kernel
    q, k, v = _qkv((B, Lq, H, D), Lk, device)
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 2
    assert torch.equal(out, again)             # no order-dependent sums
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _out_err(out, ref) <= 1


# the Wan2.2 denoise at 480x832 and MoGe's DINOv2: 32k rows and keys (a
# per-head stride product of 32865 * 40 * 128 passes 2^27), ragged tails
# (MoGe's 3556 keys leave 100 in the last 128-key tile)
LONG = [(name, shape, lk, kernel) for name, shape, lk, kernel in SHAPES
        if name.startswith(("wan22_", "moge_"))]


@pytest.mark.parametrize("name,shape,Lk,kernel", LONG,
                         ids=[s[0] for s in LONG])
def test_kernel_at_wan22_and_moge_shapes(device, name, shape, Lk, kernel):
    B, Lq, H, D = shape
    assert fa.route(H, D, Lk) == kernel
    q, k, v = _qkv(shape, Lk, device, seed=7)
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 1
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _out_err(out, ref) <= 1


# TI2V-5B at 704x1280x121: 27,280 rows (a ragged last 128-row tile) of 24
# heads, over themselves (generic) and over 512 text keys (onekv)
TI2V = [(name, shape, lk, kernel) for name, shape, lk, kernel in SHAPES
        if name.startswith("ti2v_")]


@pytest.mark.parametrize("name,shape,Lk,kernel", TI2V,
                         ids=[s[0] for s in TI2V])
def test_kernel_at_ti2v_shapes(device, name, shape, Lk, kernel):
    B, Lq, H, D = shape
    assert fa.route(H, D, Lk) == kernel and Lq % 128
    q, k, v = _qkv(shape, Lk, device, seed=11)
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 1
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _out_err(out, ref) <= 1


# FLF2V's text cross-attention over 769 keys (a new remainder of onekv's
# key tiles) and the track head's four attentions, 8 heads of 48 that the
# wrapper zero-pads to d64's 64
FLF2V_TRACK = [(name, shape, lk, kernel) for name, shape, lk, kernel in SHAPES
               if name.startswith(("flf2v_", "track_"))]


@pytest.mark.parametrize("name,shape,Lk,kernel", FLF2V_TRACK,
                         ids=[s[0] for s in FLF2V_TRACK])
def test_kernel_at_flf2v_and_track_shapes(device, name, shape, Lk, kernel):
    B, Lq, H, D = shape
    assert fa.route(H, D, Lk) == kernel
    q, k, v = _qkv(shape, Lk, device, seed=13)
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 1
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape == q.shape
    assert out.dtype == torch.bfloat16
    assert _out_err(out, ref) <= 1


# the single-card options at 336x592, 81 frames: the 'latent_split' pose
# attention (42 frame rows of 777 tokens, 40 heads, over 777 keys) and
# temporal bicross both ways (12 heads of 96 that the wrapper zero-pads to
# onekv's 128, over 782 and 777 keys): key counts off onekv's tiles
OPTIONS = [(name, shape, lk, kernel) for name, shape, lk, kernel in SHAPES
           if name.startswith(("pose_", "bicross_temporal_"))]


@pytest.mark.parametrize("name,shape,Lk,kernel", OPTIONS,
                         ids=[s[0] for s in OPTIONS])
def test_kernel_at_option_shapes(device, name, shape, Lk, kernel):
    B, Lq, H, D = shape
    assert fa.route(H, D, Lk) == kernel == "onekv"
    q, k, v = _qkv(shape, Lk, device, seed=17)
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 1
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape == q.shape
    assert out.dtype == torch.bfloat16
    assert _out_err(out, ref) <= 1


# the multi-GPU path, one rank's calls at 336x592, 81 frames: the DiT at 20
# of 40 heads (mesh_model 2, or Ulysses at mesh_seq 2), Ulysses' bicross at
# 6 of 12 heads and VGGT global at 8 of 16, and the ring's stats calls at
# mesh_seq 2 (11 frames against a part of 11)
MESH = [(name, shape, lk, kernel) for name, shape, lk, kernel in SHAPES
        if name.startswith(("mesh_", "ulysses_", "ring_"))]


@pytest.mark.parametrize("name,shape,Lk,kernel", MESH,
                         ids=[s[0] for s in MESH])
def test_kernel_at_mesh_shapes(device, name, shape, Lk, kernel):
    B, Lq, H, D = shape
    assert fa.route(H, D, Lk) == kernel
    q, k, v = _qkv(shape, Lk, device, seed=19)
    scale = D ** -0.5
    if name.startswith("ring_"):
        before = fa.LAUNCHES[f"{kernel}_stats"]
        o, m2, l = fa.flash_attention_stats(q, k, v)
        torch.cuda.synchronize()
        assert fa.LAUNCHES[f"{kernel}_stats"] == before + 1
        ro, rm, rl = fa.attention_plain_stats(q, k, v, scale)
        assert _out_err(o, ro) <= 1
        assert ((m2 - rm).abs() / rm.abs().clamp_min(1.0)).max() <= STATS_RTOL
        assert ((l - rl).abs() / rl).max() <= STATS_RTOL
        return
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 1
    assert _out_err(out, fa.attention_plain(q, k, v, scale)) <= 1


@pytest.mark.parametrize("D,kernel", [(64, "d64"), (128, "generic"),
                                      (128, "onekv")])
def test_kernel_reads_strided_views(device, D, kernel):
    """q, k, v as views of a fused qkv projection (VGGT, the camera trunk)
    and swapped q/k roles (bicross): no copies, same result as contiguous
    inputs."""
    B, L, H = 2, 150, 4
    g = torch.Generator(device=device).manual_seed(3)
    qkv = torch.randn((B, L, 3, H, D), generator=g, device=device).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = D ** -0.5
    out = fa.launch(kernel, q, k, v, scale)
    ref = fa.launch(kernel, q.contiguous(), k.contiguous(), v.contiguous(),
                    scale)
    assert torch.equal(out, ref)
    out_t = fa.launch(kernel, k, q, v, scale)
    ref_t = fa.attention_plain(k, q, v, scale)
    assert _out_err(out_t, ref_t) <= 1


# the edges of onekv's 128-row query blocks and 64-key tiles, and of its
# eight K slots (512 keys: every tile keeps its slot; 513: a streamed ring)
ONEKV_LQ = (1, 127, 128, 129, 255)
ONEKV_LK = (1, 63, 64, 65, 127, 128, 129, 256, 257, 511, 512, 513, 2048)


@pytest.mark.parametrize("D", (128, 80))
@pytest.mark.parametrize("Lk", ONEKV_LK)
@pytest.mark.parametrize("Lq", ONEKV_LQ)
def test_onekv_tile_edges(device, Lq, Lk, D):
    """onekv (D 80 padded to 128) at and around its tiles and its
    shared-memory limit (batch 2, 2 heads): two calls bit-equal, within
    out_tol of the plain version."""
    assert fa.route(2, D, Lk) == "onekv"
    q, k, v = _qkv((2, Lq, 2, D), Lk, device, seed=Lq * 10000 + Lk)
    before = fa.LAUNCHES["onekv"]
    out = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["onekv"] == before + 2
    assert torch.equal(out, again)
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _out_err(out, ref) <= 1


@pytest.mark.parametrize("D", (128, 80))
@pytest.mark.parametrize("Lk", ONEKV_LK)
@pytest.mark.parametrize("Lq", ONEKV_LQ)
def test_onekv_stats_tile_edges(device, Lq, Lk, D):
    """The stats forward of onekv at the same shapes: o within out_tol, m2
    and l within STATS_RTOL of the plain version."""
    q, k, v = _qkv((2, Lq, 2, D), Lk, device, seed=Lq * 10000 + Lk + 1)
    before = fa.LAUNCHES["onekv_stats"]
    o, m2, l = fa.flash_attention_stats(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["onekv_stats"] == before + 1
    ro, rm2, rl = fa.attention_plain_stats(q, k, v, D ** -0.5)
    assert m2.shape == l.shape == (2, Lq, 2) and m2.dtype == torch.float32
    assert _out_err(o, ro) <= 1
    torch.testing.assert_close(m2, rm2, rtol=STATS_RTOL, atol=STATS_RTOL)
    torch.testing.assert_close(l, rl, rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("Lq", (256, 257, 258))
def test_onekv_at_clip_self_attention(device, Lq):
    """CLIP's self-attention (one image, 16 heads of 80 over 257 keys) and
    the query counts around it: onekv and its stats forward within out_tol
    (o) and STATS_RTOL (m2, l) of the plain version."""
    assert fa.route(16, 80, 257) == "onekv"
    q, k, v = _qkv((1, Lq, 16, 80), 257, device, seed=Lq)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v)
    o, m2, l = fa.flash_attention_stats(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["onekv"] == before["onekv"] + 1
    assert fa.LAUNCHES["onekv_stats"] == before["onekv_stats"] + 1
    ro, rm2, rl = fa.attention_plain_stats(q, k, v, 80 ** -0.5)
    assert out.shape == ro.shape == (1, Lq, 16, 80)
    assert _out_err(out, ro) <= 1 and _out_err(o, ro) <= 1
    assert m2.shape == l.shape == (1, Lq, 16)
    torch.testing.assert_close(m2, rm2, rtol=STATS_RTOL, atol=STATS_RTOL)
    torch.testing.assert_close(l, rl, rtol=STATS_RTOL, atol=0)


def test_kernel_rejects_what_it_does_not_take(device):
    q, k, v = _qkv((1, 16, 2, 128), 16, device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.launch("d64", q, k, v, 0.1)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])


@pytest.mark.parametrize("B,Lq,H,D,Lk,kernel", SMALL)
def test_stats_kernel_matches_plain(device, B, Lq, H, D, Lk, kernel):
    q, k, v = _qkv((B, Lq, H, D), Lk, device, seed=1)
    before = fa.LAUNCHES[f"{kernel}_stats"]
    o, m2, l = fa.flash_attention_stats(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"{kernel}_stats"] == before + 1
    ro, rm2, rl = fa.attention_plain_stats(q, k, v, D ** -0.5)
    assert m2.shape == l.shape == (B, Lq, H) and m2.dtype == torch.float32
    assert _out_err(o, ro) <= 1
    torch.testing.assert_close(m2, rm2, rtol=STATS_RTOL, atol=STATS_RTOL)
    torch.testing.assert_close(l, rl, rtol=STATS_RTOL, atol=0)


def _bwd_err(got, ref):
    """max |g - ref| over its grad_tol, the largest of dq, dk, dv (<= 1
    passes)."""
    return max((g.float() - r.float()).abs().max().item() / grad_tol(r)
               for g, r in zip(got, ref))


@pytest.mark.parametrize("B,Lq,H,D,Lk,kernel", SMALL)
def test_backward_kernels_match_plain(device, B, Lq, H, D, Lk, kernel):
    """dq and dk/dv at ragged shapes in both axes, every head dim (padded
    ones through the route's kernel width)."""
    q, k, v = _qkv((B, Lq, H, D), Lk, device, seed=2)
    do = torch.randn((B, Lq, H, D), device=device).bfloat16()
    o, m2, l = fa.flash_attention_stats(q, k, v)
    lse2 = m2 + torch.log2(l)
    dk_ = fa.kernel_dim(H, D, Lk)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_backward(q, k, v, o, lse2, do, D ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"bwd_dq_{dk_}"] == before[f"bwd_dq_{dk_}"] + 1
    assert fa.LAUNCHES[f"bwd_dkv_{dk_}"] == before[f"bwd_dkv_{dk_}"] + 1
    ref = fa.attention_backward_plain(q, k, v, o, lse2, do, D ** -0.5)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g).all())
    assert _bwd_err(got, ref) <= 1


def test_autograd_through_strided_views(device):
    """The training path: grads of a fused-qkv view (VGGT) through the
    FlashAttention Function equal the plain backward's, and the Function
    launched the stats forward and both backward kernels."""
    B, L, H, D = 1, 300, 4, 64
    g = torch.Generator(device=device).manual_seed(4)
    qkv = torch.randn((B, L, 3, H, D), generator=g, device=device
                      ).bfloat16().requires_grad_()
    do = torch.randn((B, L, H, D), generator=g, device=device).bfloat16()
    fa.reset_launch_counts()
    out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["d64_stats"] == 1 and fa.LAUNCHES["d64"] == 0
    assert fa.LAUNCHES["bwd_dq_64"] == fa.LAUNCHES["bwd_dkv_64"] == 1
    q, k, v = (qkv.detach()[:, :, i] for i in range(3))
    o, m2, l = fa.attention_plain_stats(q, k, v, D ** -0.5)
    ref = fa.attention_backward_plain(q, k, v, o, m2 + torch.log2(l), do,
                                      D ** -0.5)
    got = [qkv.grad[:, :, i] for i in range(3)]
    assert _bwd_err(got, ref) <= 1


# the edges of the backward's tiles: dq's 128-row query blocks over 64-key
# tiles, dk/dv's 128-row key blocks over 64-query tiles
EDGES = (1, 63, 64, 65, 127, 128, 129, 255)


def _backward_case(device, B, Lq, Lk, H, D, seed, qkv=None):
    """Launch dq then dk/dv at head dim D on (q, k, v) -- given, or seeded
    -- with the plain stats forward's lse2; check the launch counters and
    return (grads, the plain backward's)."""
    q, k, v = qkv or _qkv((B, Lq, H, D), Lk, device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=device).bfloat16()
    scale = D ** -0.5
    o, m2, l = fa.attention_plain_stats(q, k, v, scale)
    lse2 = m2 + torch.log2(l)
    before = dict(fa.LAUNCHES)
    got = fa.launch_backward(q, k, v, o, lse2, do, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"bwd_dq_{D}"] == before[f"bwd_dq_{D}"] + 1
    assert fa.LAUNCHES[f"bwd_dkv_{D}"] == before[f"bwd_dkv_{D}"] + 1
    ref = fa.attention_backward_plain(q, k, v, o, lse2, do, scale)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        assert bool(torch.isfinite(a).all())
    return got, ref


@pytest.mark.parametrize("D", fa.BWD_D)
@pytest.mark.parametrize("Lk", EDGES)
@pytest.mark.parametrize("Lq", EDGES)
def test_backward_tile_edges(device, Lq, Lk, D):
    """Every head dim the backward is built for, at and around its tiles'
    edges in both axes (batch 2, 2 heads)."""
    got, ref = _backward_case(device, 2, Lq, Lk, 2, D, seed=Lq * 1000 + Lk)
    assert _bwd_err(got, ref) <= 1


def test_backward_swapped_views_d96(device):
    """Bicross at D 96: q and k swapped, all three views of a fused
    projection -- the same gradients as contiguous copies, bit for bit, and
    within grad_tol of the plain backward."""
    B, L, H, D = 1, 300, 3, 96
    g = torch.Generator(device=device).manual_seed(6)
    qkv = torch.randn((B, L, 3, H, D), generator=g, device=device).bfloat16()
    k, q, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got, ref = _backward_case(device, B, L, L, H, D, 7, qkv=(q, k, v))
    again, _ = _backward_case(device, B, L, L, H, D, 7,
                              qkv=(q.contiguous(), k.contiguous(),
                                   v.contiguous()))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert _bwd_err(got, ref) <= 1


def test_backward_one_key_last_tile(device):
    """DiT cross-attention against CLIP's 257 keys at 40 heads: the last key
    tile of dq and the last key block of dk/dv hold one key."""
    got, ref = _backward_case(device, 1, 300, 257, 40, 128, seed=8)
    assert _bwd_err(got, ref) <= 1


PIPE_TRAIN = [(name, shape, lk, kernel) for name, shape, lk, kernel
              in MESH_TRAIN_SHAPES if name.startswith("pipe_")]


@pytest.mark.parametrize("name,shape,Lk,kernel", PIPE_TRAIN,
                         ids=[c[0] for c in PIPE_TRAIN])
def test_backward_kernels_at_pipe_train_shapes(device, name, shape, Lk,
                                               kernel):
    """The pipeline trainer's microbatch (Bm = 1 at 480x832x81), and with 2
    seq ranks a stage its Ulysses head group and a rank's queries: the
    stats forward and dq, dk/dv against their plain versions."""
    B, Lq, H, D = shape
    assert fa.route(H, D, Lk) == kernel
    q, k, v = _qkv(shape, Lk, device, seed=5)
    do = torch.randn(shape, device=device).bfloat16()
    o, m2, l = fa.flash_attention_stats(q, k, v)
    ro, rm2, rl = fa.attention_plain_stats(q, k, v, D ** -0.5)
    assert _out_err(o, ro) <= 1
    torch.testing.assert_close(m2, rm2, rtol=STATS_RTOL, atol=STATS_RTOL)
    lse2 = m2 + torch.log2(l)
    got = fa.flash_attention_backward(q, k, v, o, lse2, do, D ** -0.5)
    ref = fa.attention_backward_plain(q, k, v, o, lse2, do, D ** -0.5)
    assert _bwd_err(got, ref) <= 1
