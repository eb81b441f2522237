"""The yardstick arithmetic of ``chip_smoke.py`` on the CPU: the least time
the card could take for each attention kernel call (FLOP at the bf16 peak
against bytes at the HBM rate), the configuration's layers per denoise step
of each shape, the library yardstick and the forward's error bound."""
import os
import subprocess
import sys

import pytest

from fantasy_world_tpu_torch.chipcheck.common import (BWD_RTOL, GRAD_ATOL,
                                                      KERNEL_TOL, PEAK_BYTES,
                                                      PEAK_FLOPS, SERVE_CLIPS,
                                                      SHAPES, TRACK_FRAMES,
                                                      TRACK_POINTS,
                                                      attention_bound,
                                                      grad_tol, out_tol,
                                                      ptxas_summary,
                                                      qlinear_bound,
                                                      yardsticks)
from fantasy_world_tpu_torch.chipcheck.inputs import (NEG_PROMPT, PROMPT,
                                                      clip_inputs,
                                                      conditioning,
                                                      install_tokenizer,
                                                      small_clip_configs,
                                                      small_configs,
                                                      small_wan22_configs,
                                                      tea_threshold)
from fantasy_world_tpu_torch.chipcheck.launches import (
    encoder_launches, expected_launches, expected_window_launches,
    joint_launches, layers_per_step, moge_tokens, pose_dit_launches,
    small_option_launches, temporal_launches, ti2v_launches, track_launches)
from fantasy_world_tpu_torch.chipcheck.profile import family
from fantasy_world_tpu_torch.chipcheck.small import (scheduler_ladders,
                                                     small_option_runs,
                                                     small_options_setup)

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
    # TI2V-5B at 704x1280x121, CFG pair: DiT self over 27,280 tokens of
    # 24 heads, and cross-attention against 512 text keys
    ("fwd", (2, 27280, 27280, 24, 128), 18.2894, 18.4928, "operations"),
    ("fwd", (2, 27280, 512, 24, 128), 0.34326, 0.34708, "operations"),
    # training, batch 1: the backward kernels' 6 and 8 units
    ("dq", (1, 16317, 16317, 40, 128), 8.1790, 8.2700, "operations"),
    ("dkv", (1, 16317, 16317, 40, 128), 10.905, 11.027, "operations"),
])
def test_attention_bound_matches_hand_numbers(kind, dims, tflop, bound_ms,
                                               bound_by):
    b = attention_bound(kind, *dims)
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
        b = attention_bound(kind, B, Lq, Lk, H, D)
        assert b["bytes"] == nbytes, kind
        assert b["bound_ms"] == pytest.approx(max(
            b["flop"] / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3)


def test_shape_launches_agree_with_expected_launches():
    """Per denoise step, the layers of the shapes of each route sum to
    what one more step adds to ``expected_launches``."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    cfg = FusionConfig()
    per_shape = layers_per_step(cfg)
    assert set(per_shape) == {name for name, *_ in SHAPES}
    one, two = expected_launches(cfg, 1), expected_launches(cfg, 2)
    for kernel in ("generic", "onekv", "d64"):
        got = sum(per_shape[name] for name, _, _, k in SHAPES
                  if k == kernel)
        assert got == two[kernel] - one[kernel], kernel
    assert per_shape["dit_self"] == 40 and per_shape["vggt_global"] == 24


def test_ti2v_shapes_and_launches():
    """TI2V-5B's two attention shapes route as their kernel says, hold
    31 x 22 x 40 tokens, and a step launches each once per block; no Wan
    denoise step counts them."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.models.wan.dit import TI2V_5B
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    shapes = {name: rest for name, *rest in SHAPES
              if name.startswith("ti2v_")}
    assert set(shapes) == {"ti2v_dit_self", "ti2v_dit_cross_text"}
    for (b, lq, h, d), lk, kernel in shapes.values():
        assert (b, lq, h, d) == (2, 31 * 22 * 40, TI2V_5B.num_heads,
                                 TI2V_5B.head_dim)
        assert fa.route(h, d, lk) == kernel
    assert layers_per_step(FusionConfig())["ti2v_dit_self"] == 0
    two = ti2v_launches(TI2V_5B, 2)
    assert {k: v for k, v in two.items() if v} == {"generic": 60,
                                                   "onekv": 60}


def test_flf2v_and_track_cells():
    """FLF2V's text keys are the end image's 257 and umT5's 512; the track
    head's cells hold TRACK_POINTS points and 64 virtual tracks over the
    81 frames the feature-only DPT makes of 21 latent frames, 8 heads of
    48 on d64; a forward launches d64 once per attention per block per
    iteration (96 at TrackConfig()), and no denoise step counts them."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.models.vggt.model import VGGTConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    shapes = {name: rest for name, *rest in SHAPES
              if name.startswith(("flf2v_", "track_"))}
    assert shapes["flf2v_dit_cross_text"] == [(2, 16317, 40, 128),
                                              257 + 512, "onekv"]
    tc = VGGTConfig().track
    assert TRACK_FRAMES == 81 and TRACK_POINTS == 256
    nv, hd = tc.num_virtual_tracks, tc.hidden_size // tc.num_heads
    assert hd == 48 and fa.kernel_dim(tc.num_heads, hd, 81) == 64
    assert shapes["track_time"] == [(256 + nv, 81, 8, 48), 81, "d64"]
    assert shapes["track_virtual_to_point"] == [(81, nv, 8, 48), 256, "d64"]
    assert shapes["track_virtual_self"] == [(81, nv, 8, 48), nv, "d64"]
    assert shapes["track_point_to_virtual"] == [(81, 256, 8, 48), nv, "d64"]
    for (b, lq, h, d), lk, kernel in shapes.values():
        assert fa.route(h, d, lk) == kernel
    assert track_launches(tc)["d64"] == 96
    per_step = layers_per_step(FusionConfig())
    assert all(per_step[name] == 0 for name in shapes)


def test_option_cells_and_launches():
    """The options' cells at 336x592, 81 frames (21 latent frames of 777
    tokens): the 'latent_split' pose attention per latent frame and temporal
    bicross at T = R = 21 (782 geometry tokens a frame), both on onekv, the
    bicross pair padded from D 96; no denoise step counts them. The
    full-width forwards' launches: camera tokens launch what a plain
    ``joint_forward`` does (88 generic, 80 onekv, 48 d64), ``uncond`` drops
    the IRG blocks' 48 bicross attentions, each latent method adds one
    pose attention on each of the 25 adapter blocks (latent_split over a
    frame's 777 keys on onekv, latent_overall over all 16,317 on
    generic), temporal bicross launches onekv twice."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    cfg = FusionConfig()
    f, tokens = 21, 21 * 21 * 37
    M = tokens // f + cfg.vggt.aggregator.patch_start_idx
    shapes = {name: rest for name, *rest in SHAPES
              if name.startswith(("pose_", "bicross_temporal_"))}
    hd = cfg.bicross.head_dim
    assert shapes == {
        "pose_split": [(2 * f, tokens // f, 40, 128), tokens // f, "onekv"],
        "bicross_temporal_video_to_geometry": [(2 * f, tokens // f, 12, hd),
                                               M, "onekv"],
        "bicross_temporal_geometry_to_video": [(2 * f, M, 12, hd),
                                               tokens // f, "onekv"]}
    for (b, lq, h, d), lk, kernel in shapes.values():
        assert fa.route(h, d, lk) == kernel
        assert fa.kernel_dim(h, d, lk) == 128
    per_step = layers_per_step(cfg)
    assert all(per_step[name] == 0 for name in shapes)
    plain = {"generic": 88, "onekv": 80, "d64": 48}

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}
    assert nonzero(joint_launches(cfg)) == plain
    assert nonzero(joint_launches(cfg, uncond=True)) == dict(
        plain, generic=40)
    import dataclasses
    for method, want in (("latent_split", {"generic": 40, "onekv": 105}),
                         ("latent_overall", {"generic": 65, "onekv": 80})):
        dcfg = dataclasses.replace(cfg.dit, pose_inject_method=method)
        assert nonzero(pose_dit_launches(dcfg, tokens, f)) == want
    assert nonzero(temporal_launches(cfg.bicross, f, tokens // f, f,
                                     M)) == {"onekv": 2}


def test_small_options_launch_contract(monkeypatch):
    """``small_options``' runs on the CPU, every attention recorded by the
    route it takes on the card: the counts the phase holds the card to
    (uncond drops its bicross calls; camera tokens launch a plain
    forward's), each output finite; the schedule ladders run."""
    import torch
    import fantasy_world_tpu_torch.ops.attention as att
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(fa, "LAUNCHES", {k: 0 for k in fa.LAUNCHES})

    def record(q, k, v, *, scale=None):
        fa.LAUNCHES[fa.route(q.shape[2], q.shape[3], k.shape[1])] += 1
        return fa.attention_plain(q, k, v, scale or q.shape[-1] ** -0.5)

    monkeypatch.setattr(att, "flash_attention", record)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        fusion, dits, inputs = small_options_setup()
        runs = small_option_runs(fusion, dits, inputs, "cpu",
                                 torch.float32)
        ladders = scheduler_ladders("cpu")
    finally:
        torch.set_num_threads(threads)
    want = small_option_launches(fusion, dits, inputs)
    assert set(runs) == set(want) == {"camera_token", "uncond", "temporal",
                                      "latent_split", "latent_overall"}
    for name, (outs, launches) in runs.items():
        assert launches == want[name], name
        assert all(bool(torch.isfinite(o).all()) for o in outs), name
    n_x = len(fusion.cfg.xattn_set())
    assert want["uncond"]["generic"] == want["camera_token"]["generic"] \
        - 2 * n_x
    # the reduced widths still take both pose routes and pad the bicross
    # pair into onekv
    assert want["latent_split"]["onekv"] > want["latent_overall"]["onekv"]
    assert want["temporal"]["onekv"] == 2
    assert set(ladders) == {"ddim", "continuous_ode"}
    assert all(bool(torch.isfinite(v).all()) for v in ladders.values())


def test_window_launches_agree_with_expected_launches():
    """One window over all 21 latent frames launches what a step without
    the heads does; the full-width windowed step's two windows of 11
    frames take the same routes."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    cfg = FusionConfig()
    whole = expected_window_launches(cfg, [(0, 21)], 336, 592, 2)
    want = expected_launches(cfg, 2)
    want["onekv"] -= 4 * cfg.vggt.camera_head.trunk_depth
    assert whole == want
    two = expected_window_launches(cfg, [(0, 11), (10, 21)], 336, 592, 1)
    assert two == whole


def test_serve_shapes_are_the_denoise_shapes_at_the_serve_batch():
    """Each Wan2.1 denoise attention has a ``serve_`` counterpart at
    ``SERVE_CLIPS`` times its rows (the CFG pair of each clip of
    full_serve's batch) on the same kernel; no step of the CFG pair's
    denoise counts them."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    shapes = {name: rest for name, *rest in SHAPES}
    per_step = layers_per_step(FusionConfig())
    denoise = [n for n, c in per_step.items() if c]
    assert SERVE_CLIPS == 2 and len(denoise) == 7
    for name in denoise + ["camera_trunk"]:
        (b, lq, h, d), lk, kernel = shapes[name]
        assert shapes["serve_" + name] == [(b * SERVE_CLIPS, lq, h, d),
                                           lk, kernel], name
        assert per_step["serve_" + name] == 0
    assert shapes["serve_vggt_frame"][0] == (84, 782, 16, 64)
    assert sum(n.startswith("serve_") for n in shapes) == 8


def test_chip_smoke_imports_no_torch_at_module_level():
    """``chip_smoke.py`` and the yardstick arithmetic run without torch (and
    without JAX)."""
    code = ("import sys, chip_smoke\n"
            "from fantasy_world_tpu_torch.chipcheck import common\n"
            "common.attention_bound('fwd', 1, 8, 8, 1, 64)\n"
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
    assert ptxas_summary(log) == ("fa_fwd_wgmma<96>:168:12|"
                                  "fa_bwd_dq_kernel<64>:72:0")
    assert ptxas_summary("") == ""


def test_best_library_takes_the_fastest_backend_that_ran():
    dims = (2, 16317, 16317, 40, 128)
    for library, want in (({"flash": 30.5, "cudnn": 19.0}, 19.0),
                          ({"flash": 2.0, "cudnn": None}, 2.0),
                          ({"flash": None, "cudnn": None}, None)):
        y = yardsticks("fwd", dims, 20.0, library)
        assert y["library_ms"] == want
        assert y["library_ms_by_backend"] == library
    # 10.905 TFLOP in 20 ms; the bound 11.027 ms
    assert y["tflops"] == pytest.approx(545.2, rel=1e-3)
    assert y["share"] == pytest.approx(11.027 / 20.0, rel=1e-4)


@pytest.mark.parametrize("peak,tol", [
    (0.078125, 0.078125 / 64),   # many keys: |o| small, two ulps of it
    (0.5, 0.5 / 64),
    (4.0, KERNEL_TOL),   # few keys: never more than the absolute bound
])
def test_out_tol_is_two_ulps_of_the_largest_output(peak, tol):
    import torch
    ref = torch.tensor([[0.001, -peak], [peak / 3, 0.0]], dtype=torch.bfloat16)
    assert out_tol(ref) == pytest.approx(tol)


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
    assert err < KERNEL_TOL
    assert err > 2 * out_tol(ref)


@pytest.mark.parametrize("peak,tol", [
    (0.078125, 0.078125 / 64),   # long shapes: two ulps of the largest
    (0.5, 0.5 / 64),
    (4.0, 4.0 * BWD_RTOL),    # never looser than 1e-2 of max(1, peak)
    (1e-7, GRAD_ATOL),        # a vanishing gradient: f32 noise floor
])
def test_grad_tol_is_two_ulps_of_the_largest_gradient(peak, tol):
    import torch
    ref = torch.tensor([[0.001 * peak, -peak], [peak / 3, 0.0]],
                       dtype=torch.bfloat16)
    assert grad_tol(ref) == pytest.approx(tol, rel=1e-2)


@pytest.mark.parametrize("largest,err", [(0.13, 4.9e-4), (2.0, 1.6e-2)])
def test_grad_tol_holds_one_ulp_kernel_errors(largest, err):
    """The kernels' errors are one bf16 ulp of the largest gradient: 4.9e-4
    at DiT self-attention (largest ~0.13), 1.6e-2 where it is ~2."""
    import torch
    assert err <= grad_tol(torch.tensor([largest, -largest / 2]))


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
        assert err > 4 * grad_tol(ref), (name, err, grad_tol(ref))


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
    assert ptxas_summary(log) == want


@pytest.mark.parametrize("name,want", [
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
def test_profile_families_attribute_the_attention_kernels(name, want):
    assert family(name) == want


def test_attention_bound_at_clip_self_attention():
    """CLIP's self-attention, by hand: one image, 257 queries and keys, 16
    heads. At the kernel's padded D 128: 4 * 16 * 257^2 * 128 = 541,073,408
    FLOP (0.547 us at 989 TFLOP/s) against 4 * 2 * 257 * 16 * 128 =
    4,210,688 bytes (1.2569 us at 3.35 TB/s): bound by bytes. At the
    function's own D 80, which chip_smoke reports: 338,170,880 FLOP and
    2,631,680 bytes, 0.7856 us."""
    b = attention_bound("fwd", 1, 257, 257, 16, 128)
    assert b["flop"] == 541_073_408 and b["bytes"] == 4_210_688
    assert b["bound_ms"] == pytest.approx(4_210_688 / 3.35e12 * 1e3)
    assert b["bound_ms"] == pytest.approx(1.2569e-3, rel=1e-4)
    assert b["bound_by"] == "bytes"
    b80 = attention_bound("fwd", 1, 257, 257, 16, 80)
    assert b80["flop"] == 338_170_880 and b80["bytes"] == 2_631_680
    assert b80["bound_ms"] == pytest.approx(7.8558e-4, rel=1e-4)
    assert ("clip_self", (1, 257, 16, 80), 257, "onekv") in SHAPES


def test_expected_launches_count_clip():
    """CLIP runs 31 of its 32 blocks once per clip, each one onekv launch,
    beside the denoise's."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    cfg = FusionConfig()
    plain = expected_launches(cfg, 2)
    with_clip = expected_launches(cfg, 2, clip=CLIPVisionConfig())
    assert with_clip == dict(plain, onekv=plain["onekv"] + 31)
    assert with_clip["onekv"] == 2 * 80 + 16 + 31


def test_small_clip_configs_route_clip_to_onekv():
    """The reduced CLIP keeps heads of 80 over 257 keys, so it takes onekv
    as the full one does, and its tokens are the width the DiT takes."""
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    fusion, _, t5, clip, vae = small_clip_configs()
    for c in (clip, CLIPVisionConfig()):
        assert c.dim // c.num_heads == 80 and c.num_patches + 1 == 257
        assert fa.route(c.num_heads, 80, 257) == "onekv"
        assert fa.kernel_dim(c.num_heads, 80, 257) == 128
    assert fusion.dit.clip_feature_dim == clip.dim
    assert fusion.dit.text_dim == t5.dim and vae.z_dim == fusion.dit.out_dim
    assert expected_launches(fusion, 2, clip=clip)["onekv"] == \
        expected_launches(fusion, 2)["onekv"] + clip.num_layers - 1


def test_small_clip_launch_contract(monkeypatch, tmp_path):
    """The reduced clip through ``FantasyWorldSampler.generate_video`` on the
    CPU, every attention recorded by the route it takes on the card: the
    counts chip_smoke's small_clip phase holds the card to."""
    import torch
    import fantasy_world_tpu_torch.ops.attention as att
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    seen = {k: 0 for k in fa.LAUNCHES}

    def record(q, k, v, *, scale=None):
        seen[fa.route(q.shape[2], q.shape[3], k.shape[1])] += 1
        return fa.attention_plain(q, k, v, scale or q.shape[-1] ** -0.5)

    monkeypatch.setattr(att, "flash_attention", record)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _small_clip_on_cpu(seen, str(tmp_path))
    finally:
        torch.set_num_threads(threads)


def _small_clip_on_cpu(seen, workdir):
    import torch
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVision
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.sampler import FantasyWorldSampler
    fcfg, pcfg, t5c, clipc, vaec = small_clip_configs()
    g = torch.Generator().manual_seed(0)
    mods = [build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                  generator=g)
            for c, cfg in ((FusionModel, fcfg), (CameraPoseEncoder, pcfg),
                           (T5Encoder, t5c), (CLIPVision, clipc),
                           (WanVAE, vaec))]
    pipe = FantasyWorldPipeline(mods[0], mods[1], t5=mods[2], clip=mods[3],
                                vae=mods[4])
    # the pipeline's own tokenize, through transformers' AutoTokenizer
    assert install_tokenizer(pipe, t5c.vocab, workdir) == \
        "transformers-wordlevel"
    h, w, nf = 256, 384, 21
    image, cams = clip_inputs(h, w, nf)
    video, pred = FantasyWorldSampler(pipe).generate_video(
        PROMPT, NEG_PROMPT, image=image, camera_params=cams, seed=0,
        height=h, width=w, num_frames=nf, sample_steps=1)
    assert video.shape == (nf, h, w, 3)
    assert seen == expected_launches(fcfg, 1, clip=clipc)
    assert all(seen[r] for r in fa.ROUTES)


def test_wan22_shape_launches_agree_with_expected_launches():
    """The Wan2.2 configuration counts the ``wan22_`` shapes, text-only
    cross-attention among them, and they sum per route to what one more
    step adds to ``expected_launches``."""
    from fantasy_world_tpu_torch.convert.checkpoint import wan22_fusion_config
    cfg = wan22_fusion_config()
    per_shape = layers_per_step(cfg)
    assert set(per_shape) == {name for name, *_ in SHAPES}
    assert all(v == 0 for k, v in per_shape.items()
               if not k.startswith("wan22_"))
    one, two = expected_launches(cfg, 1), expected_launches(cfg, 2)
    for kernel in ("generic", "onekv", "d64"):
        got = sum(per_shape[name] for name, _, _, k in SHAPES
                  if k == kernel)
        assert got == two[kernel] - one[kernel], kernel
    assert two == dict(one, generic=2 * 88, onekv=2 * 40 + 16, d64=2 * 48)


def test_moge_tokens_and_launches():
    """The example 592x336 image at MoGe's 3600-token level is a 45 x 79
    patch grid plus the class token; DINOv2-L adds one d64 launch per
    block."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.models.moge.model import MoGeConfig
    m = MoGeConfig()
    assert moge_tokens(m, (336, 592)) == 45 * 79 + 1 == 3556
    assert ("moge_dinov2", (1, 3556, 16, 64), 3556, "d64") in SHAPES
    plain = expected_launches(FusionConfig(), 2)
    assert expected_launches(FusionConfig(), 2, moge=(m, 3556)) == dict(
        plain, d64=plain["d64"] + 24)
    b = attention_bound("fwd", 1, 3556, 3556, 16, 64)
    assert b["flop"] == 4 * 16 * 3556 ** 2 * 64 and b["bound_by"] == \
        "operations"


def test_small_wan22_launch_contract(monkeypatch, tmp_path):
    """The reduced Wan2.2 clip through ``Wan22Sampler.generate_video`` on
    the CPU (one step, MoGe, an end image), every attention recorded by
    the route it takes on the card: the counts chip_smoke's small_wan22
    phase holds the card to, every route among them."""
    import torch
    import fantasy_world_tpu_torch.ops.attention as att
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.moge.model import MoGe
    from fantasy_world_tpu_torch.models.wan.t5 import T5Encoder
    from fantasy_world_tpu_torch.models.wan.vae import WanVAE
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    from fantasy_world_tpu_torch.pipelines.wan_video_22 import (
        DualModelDenoiser)
    from fantasy_world_tpu_torch.sampler import Wan22Sampler
    seen = {k: 0 for k in fa.LAUNCHES}

    def record(q, k, v, *, scale=None):
        seen[fa.route(q.shape[2], q.shape[3], k.shape[1])] += 1
        return fa.attention_plain(q, k, v, scale or q.shape[-1] ** -0.5)

    monkeypatch.setattr(att, "flash_attention", record)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        fcfg, t5c, vaec, mcfg = small_wan22_configs()
        g = torch.Generator().manual_seed(0)
        high, low, t5, vae, moge = (
            build(lambda: c(cfg), device="cpu", dtype=torch.float32,
                  generator=g)
            for c, cfg in ((FusionModel, fcfg), (FusionModel, fcfg),
                           (T5Encoder, t5c), (WanVAE, vaec), (MoGe, mcfg)))
        assert fcfg.dit.text_dim == t5c.dim and vaec.z_dim == \
            fcfg.dit.out_dim
        pipe = FantasyWorldPipeline(t5=t5, vae=vae)
        install_tokenizer(pipe, t5c.vocab, str(tmp_path))
        h, w, nf = 256, 384, 21
        image, cams = clip_inputs(h, w, nf)
        video, pred = Wan22Sampler(pipe, DualModelDenoiser(high, low),
                                   moge).generate_video(
            PROMPT, NEG_PROMPT, image=image, end_image=image[::-1],
            camera_params=cams, seed=0, height=h, width=w, num_frames=nf,
            sample_steps=1)
    finally:
        torch.set_num_threads(threads)
    assert video.shape == (nf, h, w, 3)
    assert seen == expected_launches(
        fcfg, 1, moge=(mcfg, moge_tokens(mcfg, image.shape[:2])))
    assert all(seen[r] for r in fa.ROUTES)


@pytest.mark.parametrize("rows,k,n,mode,bound_ms,bound_by", [
    # the DiT FFN in at the CFG pair: int8 at 1979 TOP/s, bf16 at 989
    (2 * 16317, 5120, 13824, "int8", 2.3336, "operations"),
    (2 * 16317, 5120, 13824, "bf16", 4.6696, "operations"),
    (2 * 16317, 5120, 5120, "fp8", 1.7295, "operations"),
    # a few rows: the weight's bytes bind
    (16, 5120, 5120, "int8", 7.9230e-3, "bytes"),
])
def test_qlinear_bound_matches_hand_numbers(rows, k, n, mode, bound_ms,
                                            bound_by):
    got, by = qlinear_bound(rows, k, n, mode)
    assert got == pytest.approx(bound_ms, rel=1e-3) and by == bound_by


def test_expected_launches_add_encoders_and_drop_skipped_steps():
    """A clip's encoders add their launches once; a TeaCache-skipped step
    launches nothing (its block stack is replaced), the heads' trunk runs
    on the last step all the same."""
    from fantasy_world_tpu_torch.models.fusion.model import FusionConfig
    from fantasy_world_tpu_torch.models.moge.model import MoGeConfig
    from fantasy_world_tpu_torch.models.wan.clip import CLIPVisionConfig
    cfg, clip, moge = FusionConfig(), CLIPVisionConfig(), (MoGeConfig(),
                                                           3556)
    enc = encoder_launches(clip, moge)
    assert enc == {"onekv": 31, "d64": 24}
    both = expected_launches(cfg, 2, clip=clip, moge=moge)
    plain = expected_launches(cfg, 2)
    assert both == dict(plain, onekv=plain["onekv"] + 31,
                        d64=plain["d64"] + 24)
    assert expected_launches(cfg, 4, skipped=2) == plain
    assert expected_launches(cfg, 1, skipped=1) == dict(
        plain, generic=0, onekv=16, d64=0)


def test_tea_serve_launch_contract(monkeypatch):
    """A reduced TeaCache denoise on the CPU at chip_smoke's threshold
    rule, every attention recorded by the route it takes on the card: the
    plan skips the second of 4 steps, and the launches are those of 3
    steps without TeaCache (a skipped step launches nothing), as
    ``expected_launches(..., skipped=1)`` counts."""
    import torch
    import fantasy_world_tpu_torch.ops.attention as att
    from fantasy_world_tpu_torch.core.params import build
    from fantasy_world_tpu_torch.models.fusion.model import FusionModel
    from fantasy_world_tpu_torch.models.wan.camera import CameraPoseEncoder
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    from fantasy_world_tpu_torch.pipelines.wan_video import (
        FantasyWorldPipeline)
    seen = {k: 0 for k in fa.LAUNCHES}

    def record(q, k, v, *, scale=None):
        seen[fa.route(q.shape[2], q.shape[3], k.shape[1])] += 1
        return fa.attention_plain(q, k, v, scale or q.shape[-1] ** -0.5)

    monkeypatch.setattr(att, "flash_attention", record)
    fcfg, pcfg = small_configs()
    g = torch.Generator().manual_seed(0)
    pipe = FantasyWorldPipeline(
        build(lambda: FusionModel(fcfg), device="cpu", dtype=torch.float32,
              generator=g),
        build(lambda: CameraPoseEncoder(pcfg), device="cpu",
              dtype=torch.float32, generator=g))
    thresh, plan = tea_threshold(pipe.fusion.dit, 4)
    assert plan.tolist() == [False, True, False, False]
    h, w, nf = 128, 192, 9
    cond = conditioning(fcfg.dit, h, w, nf, g, 16)
    counts = []
    for steps, tea in ((4, thresh), (3, None)):
        for k in seen:
            seen[k] = 0
        pipe.denoise(*cond[:4], h, w, num_frames=nf,
                     num_inference_steps=steps, seed=0,
                     plucker_fea=pipe.encode_plucker(cond[4]),
                     tea_cache_l1_thresh=tea)
        counts.append(dict(seen))
    assert counts[0] == counts[1] and any(counts[0].values())


@pytest.mark.parametrize("per_shard", [False, True],
                         ids=["whole_width", "per_shard"])
def test_mesh_norm_check_catches_a_per_shard_norm(tmp_path, per_shard):
    """full_mesh's q/k norm check on two gloo ranks: the port's column
    split within its bound, a norm over each rank's own columns far
    beyond it."""
    import json

    import torch_mesh_workers as workers
    from fantasy_world_tpu_torch.parallel import distributed
    out = tmp_path / "norm.json"
    distributed.spawn(workers.norm_check_case, 2, per_shard, str(out))
    err, bound = json.loads(out.read_text())
    if per_shard:
        assert err > 10 * bound
    else:
        assert err <= bound
