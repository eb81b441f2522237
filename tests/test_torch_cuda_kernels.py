"""The Hopper attention kernels against their plain PyTorch version, on the
card. Skipped without a CUDA device. The machine with the card has no JAX,
so run these without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""
import pytest
import torch

from fantasy_world_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# Bound for unit-variance bf16 inputs: kernel and plain version round q and
# P to bf16 at the same points, so they differ only by f32 summation order
# and the bf16 rounding of the output.
TOL = 1.5e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape_q, lk, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    B, Lq, H, D = shape_q
    q = torch.randn((B, Lq, H, D), generator=g, device=device).bfloat16()
    k = torch.randn((B, lk, H, D), generator=g, device=device).bfloat16()
    v = torch.randn((B, lk, H, D), generator=g, device=device).bfloat16()
    return q, k, v


# (B, Lq, H, D, Lk, expected route): ragged tails in both axes, every
# kernel, every padded head dim
SMALL = [
    (1, 1, 2, 64, 1, "d64"),
    (2, 200, 4, 64, 300, "d64"),
    (1, 129, 2, 48, 65, "d64"),            # D padded 48 -> 64
    (2, 130, 3, 128, 81, "onekv"),
    (1, 70, 2, 128, 2048, "onekv"),
    (1, 33, 3, 80, 257, "onekv"),          # D padded 80 -> 128
    (1, 257, 2, 96, 2100, "generic"),
    (1, 100, 1, 128, 2049, "generic"),
    (1, 65, 3, 72, 2200, "generic"),       # D padded 72 -> 96
]


@pytest.mark.parametrize("B,Lq,H,D,Lk,kernel", SMALL)
def test_kernel_matches_plain(device, B, Lq, H, D, Lk, kernel):
    assert fa.route(H, D, Lk) == kernel
    q, k, v = _qkv((B, Lq, H, D), Lk, device)
    before = fa.LAUNCHES[kernel]
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel] == before + 1
    ref = fa.attention_plain(q, k, v, D ** -0.5)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL, err


def test_kernel_reads_strided_views(device):
    """v as a view of a fused qkv projection (VGGT) and swapped q/k roles
    (bicross): no copies, same result as contiguous inputs."""
    B, L, H, D = 2, 150, 4, 64
    g = torch.Generator(device=device).manual_seed(3)
    qkv = torch.randn((B, L, 3, H, D), generator=g, device=device).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, ref)
    out_t = fa.flash_attention(k, q, v)
    ref_t = fa.attention_plain(k, q, v, D ** -0.5)
    assert (out_t.float() - ref_t.float()).abs().max().item() <= TOL


def test_kernel_rejects_what_it_does_not_take(device):
    q, k, v = _qkv((1, 16, 2, 128), 16, device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.launch("d64", q, k, v, 0.1)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
