"""The yardstick arithmetic of ``chip_smoke.py`` on the CPU: the least time
the card could take for each attention kernel call (FLOP at the bf16 peak
against bytes at the HBM rate), the configuration's layers per denoise step
of each shape, the library yardstick and the forward's error bound."""
import os
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind,dims,tflop,bound_ms,bound_by", [
    # DiT self-attention, CFG pair: 4 B H Lq Lk D
    ("fwd", (2, 16317, 16317, 40, 128), 10.905, 11.027, "operations"),
    # bicross video -> geometry
    ("fwd", (2, 16317, 16422, 12, 96), 2.4695, 2.4970, "operations"),
    # VGGT global
    ("fwd", (2, 16422, 16422, 16, 64), 2.2092, 2.2338, "operations"),
    # VGGT frame: 42 frames of 782 tokens, still bound by FLOP, not bytes
    ("fwd", (42, 782, 782, 16, 64), 0.10520, 0.10637, "operations"),
    # DiT cross-attention against 512 text keys
    ("fwd", (2, 16317, 512, 40, 128), 0.34219, 0.34600, "operations"),
    # against 257 CLIP keys: q in and o out, 668 of 679 MB, bind
    ("fwd", (2, 16317, 257, 40, 128), 0.17176, 0.20265, "bytes"),
    # the camera-head trunk: 81 tokens, bound by bytes
    ("fwd", (2, 81, 81, 16, 128), 1.07495e-4, 7.9230e-4, "bytes"),
    # training, batch 1: the backward kernels' 6 and 8 units
    ("dq", (1, 16317, 16317, 40, 128), 8.1790, 8.2700, "operations"),
    ("dkv", (1, 16317, 16317, 40, 128), 10.905, 11.027, "operations"),
])
def test_attention_bound_matches_hand_numbers(kind, dims, tflop, bound_ms,
                                               bound_by):
    b = cs.attention_bound(kind, *dims)
    assert b["flop"] / 1e12 == pytest.approx(tflop, rel=1e-4)
    assert b["bound_ms"] == pytest.approx(bound_ms, rel=1e-4)
    assert b["bound_by"] == bound_by


def test_attention_bound_counts_each_tensor_once():
    """q, k, v and o bf16 once each; the stats forward adds m2 and l, dq
    reads o, do, lse2 and writes dq, delta; dk/dv reads do, lse2, delta and
    writes dk, dv."""
    B, Lq, Lk, H, D = 3, 100, 70, 4, 64
    q, kv, row = 2 * B * Lq * H * D, 2 * B * Lk * H * D, 4 * B * Lq * H
    want = {"fwd": 2 * q + 2 * kv, "stats": 2 * q + 2 * kv + 2 * row,
            "dq": 4 * q + 2 * kv + 2 * row, "dkv": 2 * q + 4 * kv + 2 * row}
    for kind, nbytes in want.items():
        b = cs.attention_bound(kind, B, Lq, Lk, H, D)
        assert b["bytes"] == nbytes, kind
        assert b["bound_ms"] == pytest.approx(max(
            b["flop"] / cs.PEAK_FLOPS, nbytes / cs.PEAK_BYTES) * 1e3)


def test_shape_launches_agree_with_expected_launches():
    """Per denoise step, the layers of the shapes of each route sum to
    what one more step adds to ``expected_launches``."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    cfg = FusionConfig()
    per_shape = cs.layers_per_step(cfg)
    assert set(per_shape) == {name for name, *_ in cs.SHAPES}
    one, two = cs.expected_launches(cfg, 1), cs.expected_launches(cfg, 2)
    for kernel in ("generic", "onekv", "d64"):
        got = sum(per_shape[name] for name, _, _, k in cs.SHAPES
                  if k == kernel)
        assert got == two[kernel] - one[kernel], kernel
    assert per_shape["dit_self"] == 40 and per_shape["vggt_global"] == 24


def test_chip_smoke_imports_no_torch_at_module_level():
    """The yardstick arithmetic runs without torch (and without JAX)."""
    code = ("import sys, chip_smoke as c\n"
            "c.attention_bound('fwd', 1, 8, 8, 1, 64)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'fantasy_world_tpu')]\n"
            "assert not bad, bad\nprint('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_ptxas_summary_reads_registers_and_spills():
    """The build line names each kernel with its registers and spill
    bytes (stores plus loads; 0 where ptxas prints no spill line)."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__fc81885e"
        "_23_flash_attention_sm90_cu_1270f60b12fa_fwd_wgmmaILi96EEEv14CUtensor"
        "Map_stS1_S1_NS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN...",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__4b6cd109"
        "_22_flash_attention_bwd_cu_fb55a1a516fa_bwd_dq_kernelILi64EEEvNS_9"
        "BwdParamsE' for 'sm_90a'",
        "ptxas info    : Used 72 registers, used 1 barriers"])
    assert cs.ptxas_summary(log) == ("fa_fwd_wgmma<96>:168:12|"
                                     "fa_bwd_dq_kernel<64>:72:0")
    assert cs.ptxas_summary("") == ""


def test_best_library_takes_the_fastest_backend_that_ran():
    dims = (2, 16317, 16317, 40, 128)
    for library, want in (({"flash": 30.5, "cudnn": 19.0}, 19.0),
                          ({"flash": 2.0, "cudnn": None}, 2.0),
                          ({"flash": None, "cudnn": None}, None)):
        y = cs.yardsticks("fwd", dims, 20.0, library)
        assert y["library_ms"] == want
        assert y["library_ms_by_backend"] == library
    # 10.905 TFLOP in 20 ms; the bound 11.027 ms
    assert y["tflops"] == pytest.approx(545.2, rel=1e-3)
    assert y["share"] == pytest.approx(11.027 / 20.0, rel=1e-4)


@pytest.mark.parametrize("peak,tol", [
    (0.078125, 0.078125 / 64),   # many keys: |o| small, two ulps of it
    (0.5, 0.5 / 64),
    (4.0, cs.KERNEL_TOL),   # few keys: never more than the absolute bound
])
def test_out_tol_is_two_ulps_of_the_largest_output(peak, tol):
    import torch
    ref = torch.tensor([[0.001, -peak], [peak / 3, 0.0]], dtype=torch.bfloat16)
    assert cs.out_tol(ref) == pytest.approx(tol)


@pytest.mark.parametrize("fault", ["tail_dropped", "v_panel_swapped"])
def test_out_tol_catches_key_and_value_faults(fault):
    """At DiT self-attention's 16,317 keys |o| is ~0.013, under KERNEL_TOL:
    a kernel that skips the 61-key tail tile, or reads one 64-column V
    panel of one key tile from the next tile, stays under KERNEL_TOL but
    not under out_tol."""
    import torch
    g = torch.Generator().manual_seed(0)
    B, Lq, H, D, Lk = 1, 256, 2, 128, 16317
    q, k, v = (torch.randn((B, n, H, D), generator=g).bfloat16()
               for n in (Lq, Lk, Lk))

    def attention(k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                            v.float()).bfloat16()

    ref = attention(k, v)
    if fault == "tail_dropped":
        bad = attention(k[:, :127 * 128], v[:, :127 * 128])
    else:
        v2 = v.clone()
        v2[:, 640:768, :, 64:] = v[:, 768:896, :, 64:]
        bad = attention(k, v2)
    err = (bad.float() - ref.float()).abs().max().item()
    assert err < cs.KERNEL_TOL
    assert err > 2 * cs.out_tol(ref)


@pytest.mark.parametrize("peak,tol", [
    (0.078125, 0.078125 / 64),   # long shapes: two ulps of the largest
    (0.5, 0.5 / 64),
    (4.0, 4.0 * cs.BWD_RTOL),    # never looser than 1e-2 of max(1, peak)
    (1e-7, cs.GRAD_ATOL),        # a vanishing gradient: f32 noise floor
])
def test_grad_tol_is_two_ulps_of_the_largest_gradient(peak, tol):
    import torch
    ref = torch.tensor([[0.001 * peak, -peak], [peak / 3, 0.0]],
                       dtype=torch.bfloat16)
    assert cs.grad_tol(ref) == pytest.approx(tol, rel=1e-2)


@pytest.mark.parametrize("largest,err", [(0.13, 4.9e-4), (2.0, 1.6e-2)])
def test_grad_tol_holds_one_ulp_kernel_errors(largest, err):
    """The kernels' errors are one bf16 ulp of the largest gradient: 4.9e-4
    at DiT self-attention (largest ~0.13), 1.6e-2 where it is ~2."""
    import torch
    assert err <= cs.grad_tol(torch.tensor([largest, -largest / 2]))


@pytest.fixture(scope="module")
def long_backward():
    """DiT self-attention's 16,317 queries and keys at one head (D 128):
    seeded bf16 inputs, the plain stats forward and the plain backward."""
    import torch
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    L, D = 16317, 128
    q, k, v, do = (torch.randn((1, L, 1, D), generator=g).bfloat16()
                   for _ in range(4))
    scale = D ** -0.5
    o, m2, l = fa.attention_plain_stats(q, k, v, scale, chunk_elems=1 << 24)
    lse2 = m2 + torch.log2(l)

    def backward(q=q, k=k, v=v, o=o, lse2=lse2, do=do):
        return dict(zip(("dq", "dk", "dv"), fa.attention_backward_plain(
            q, k, v, o, lse2, do, scale, chunk_elems=1 << 24)))

    return {"q": q, "k": k, "v": v, "o": o, "lse2": lse2, "do": do,
            "backward": backward, "ref": backward()}


def _fault(case, fault):
    """The gradients a tile-sized fault of a backward kernel would give,
    and which of them it corrupts."""
    q, k, v, o, lse2, do = (case[n] for n in ("q", "k", "v", "o", "lse2",
                                              "do"))
    bwd = case["backward"]
    if fault == "query_rows_lost":        # dk/dv: 8 rows of query tile 10
        keep = list(range(640)) + list(range(648, q.shape[1]))
        return bwd(q=q[:, keep], o=o[:, keep], lse2=lse2[:, keep],
                   do=do[:, keep]), ("dk", "dv")
    if fault == "keys_lost":              # dq: 8 keys of key tile 10
        keep = list(range(640)) + list(range(648, k.shape[1]))
        return bwd(k=k[:, keep], v=v[:, keep]), ("dq",)
    if fault == "tail_tile_skipped":      # dk/dv: the 61-query tail tile
        n = 254 * 64
        return bwd(q=q[:, :n], o=o[:, :n], lse2=lse2[:, :n],
                   do=do[:, :n]), ("dk", "dv")
    # dv: one 64-column panel of the tail tile's do from the tile before
    do2 = do.clone()
    do2[:, 16256:16317, :, 64:] = do[:, 16192:16253, :, 64:]
    return bwd(do=do2), ("dv",)


@pytest.mark.parametrize("fault", ["query_rows_lost", "keys_lost",
                                   "tail_tile_skipped", "do_panel_swapped"])
def test_grad_tol_catches_tile_faults(long_backward, fault):
    """At 16,317 queries and keys every gradient is below 0.1, so the
    former bound, 1e-2 absolute, passed tile-sized faults by 1.05-1.9x;
    grad_tol (two bf16 ulps of the largest gradient) catches each by more
    than 4x."""
    bad, hit = _fault(long_backward, fault)
    for name in hit:
        ref = long_backward["ref"][name]
        err = (bad[name].float() - ref.float()).abs().max().item()
        assert err > 4 * cs.grad_tol(ref), (name, err, cs.grad_tol(ref))


@pytest.mark.parametrize("mangled,want", [
    ("_ZN55_GLOBAL__N__4b6cd109_22_flash_attention_bwd_cu_fb55a1a516fa_bwd_"
     "dkv_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_NS_9BwdParamsE",
     "fa_bwd_dkv_wgmma<128>:168:16"),
    ("_ZN55_GLOBAL__N__4b6cd109_22_flash_attention_bwd_cu_fb55a1a515fa_bwd_"
     "dq_wgmmaILi96EEEv14CUtensorMap_stS1_S1_S1_NS_9BwdParamsE",
     "fa_bwd_dq_wgmma<96>:168:16"),
    ("_ZN57_GLOBAL__N__3b9c8d21_24_flash_attention_onekv_cu_5e2a7f1018fa_fwd_"
     "onekv_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE",
     "fa_fwd_onekv_wgmma<128>:168:16"),
])
def test_ptxas_summary_reads_the_wgmma_backward(mangled, want):
    """The TMA/wgmma backward and one-key-block kernels' build lines, as
    ptxas prints them
    (an advisory about injected warpgroup.arrive names the kernel too, and
    must not open an entry of its own)."""
    log = "\n".join([
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line "
        f"8389 by compiler to allow use of registers in GMMA in function "
        f"'{mangled}'",
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled}",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 2 barriers, 8 bytes "
        "cumulative stack size"])
    assert cs.ptxas_summary(log) == want


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::fa_bwd_dkv_wgmma<128>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous "
     "namespace)::BwdParams)", "attention bwd dkv"),
    ("void (anonymous namespace)::fa_bwd_dq_wgmma<64>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous "
     "namespace)::BwdParams)", "attention bwd dq"),
    ("void (anonymous namespace)::fa_fwd_wgmma<96>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
     "attention fwd wgmma (generic, d64)"),
    ("void (anonymous namespace)::fa_fwd_onekv_wgmma<128>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous "
     "namespace)::Params)", "attention fwd wgmma (onekv)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "matmul (cuBLAS)"),
])
def test_profile_families_attribute_the_attention_kernels(name, family):
    assert cs.family(name) == family
