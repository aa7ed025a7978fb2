"""The port's CUDA kernels and its CUDA path, held against the plain
PyTorch versions on the card. Every test needs an NVIDIA GPU and skips
without one. This file imports neither jax nor the JAX package, so it also
runs on a machine without jax (``tests/conftest.py`` imports jax; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: mel 1e-4 (the front-end's fp32 bound); attention forward
and backward fp32 2e-5 (fp32 sums in other orders), bf16 2e-2 compared in
fp32 (bf16 rounds the probabilities, ds and the outputs at ~4e-3
relative), lse 1e-4; the fp32 model on the card against the same model on
the CPU rtol 2e-4, atol 2e-5; the train step as its docstring says.
"""

import math

import numpy as np
import pytest
import torch

from maest_tpu_torch.api import get_maest
from maest_tpu_torch.dsp.mel import frame_waveforms
from maest_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_reference,
    attention_reference,
    attention_reference_lse,
    flash_attention,
    flash_attention_fwd_lse,
)
from maest_tpu_torch.ops.attention_probe import (
    VARIANTS,
    attention_probe,
    attention_probe_reference,
)
from maest_tpu_torch.ops import mel_kernel
from maest_tpu_torch.ops.mel_kernel import (
    fused_logmel_fft_reference,
    fused_logmel_from_frames,
    fused_logmel_from_frames_fma,
    fused_logmel_from_frames_reference,
)
from maest_tpu_torch.serve import TagService

pytestmark = pytest.mark.cuda

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TINY = dict(pretrained=False, embed_dim=128, depth=2, num_heads=2, input_t=62,
            n_classes=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32) * scale)


def test_mel_kernel_matches_plain(cuda_device):
    wave = _rand((3, 5 * 16000 + 123), 3, 0.2).to(cuda_device)
    frames = frame_waveforms(wave).reshape(-1, 512).contiguous()
    before = fused_logmel_from_frames.launches
    out = fused_logmel_from_frames(frames)
    ref = fused_logmel_from_frames_reference(frames)
    torch.cuda.synchronize()
    assert fused_logmel_from_frames.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4


def test_mel_kernel_rejects_what_it_does_not_take(cuda_device):
    frames = torch.zeros(4 * 512 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fused_logmel_from_frames(frames[1:].view(4, 512))
    with pytest.raises(ValueError, match="contiguous"):
        fused_logmel_from_frames(torch.zeros(512, 4, device=cuda_device).t())
    with pytest.raises(TypeError, match="float32"):
        fused_logmel_from_frames(torch.zeros(4, 512, device=cuda_device,
                                             dtype=torch.float64))
    with pytest.raises(ValueError, match="n_fft"):
        fused_logmel_from_frames(torch.zeros(4, 256, device=cuda_device),
                                 n_fft=256)
    with pytest.raises(ValueError, match="at most 128 bands"):
        fused_logmel_from_frames(torch.zeros(4, 512, device=cuda_device),
                                 n_mels=200)
    for bad in (frames[1:].view(4, 512),
                torch.zeros(4, 512, device=cuda_device, dtype=torch.float64)):
        with pytest.raises((ValueError, TypeError)):
            fused_logmel_from_frames_fma(bad)


# the batch's frames of 32 clips of 30 s, and two ragged counts: the FFT
# kernel's groups are 8 frames, so 60025 ends in a group of 1
@pytest.mark.parametrize("m", [60032, 60025, 1])
def test_mel_fft_kernel_matches_both_plain_versions(cuda_device, m):
    frames = _rand((m, 512), 5, 0.1).to(cuda_device)
    before = (fused_logmel_from_frames.launches,
              fused_logmel_from_frames_fma.launches)
    out = fused_logmel_from_frames(frames)
    plain = fused_logmel_from_frames_reference(frames)
    route = fused_logmel_fft_reference(frames)
    torch.cuda.synchronize()
    assert (fused_logmel_from_frames.launches,
            fused_logmel_from_frames_fma.launches) == (before[0] + 1,
                                                       before[1])
    assert out.shape == (m, 96) and bool(torch.isfinite(out).all())
    assert (out - plain).abs().max().item() <= 1e-4
    assert (out - route).abs().max().item() <= 1e-4
    raw = fused_logmel_from_frames(frames, normalize=False)
    assert (raw - fused_logmel_from_frames_reference(
        frames, normalize=False)).abs().max().item() <= 1e-4


def test_mel_fft_kernel_on_silence_and_tones(cuda_device):
    t = np.arange(16000)
    waves = np.stack([np.zeros(16000), 0.5 * np.sin(2 * np.pi * 40 * t / 512),
                      np.full(16000, 0.5), 0.5 * (-1.0) ** t]).astype(
                          np.float32)
    frames = frame_waveforms(torch.from_numpy(waves).to(cuda_device)).reshape(
        -1, 512).contiguous()
    out = fused_logmel_from_frames(frames)
    ref = fused_logmel_from_frames_reference(frames)
    assert (out - ref).abs().max().item() <= 1e-4
    silent = out[:frames.shape[0] // 4]
    assert bool((silent == silent[0, 0]).all())  # log10(1) everywhere


def test_mel_fma_control_still_runs_and_agrees(cuda_device):
    frames = _rand((60032, 512), 6, 0.1).to(cuda_device)
    before = (fused_logmel_from_frames.launches,
              fused_logmel_from_frames_fma.launches)
    out = fused_logmel_from_frames_fma(frames)
    torch.cuda.synchronize()
    assert (fused_logmel_from_frames.launches,
            fused_logmel_from_frames_fma.launches) == (before[0],
                                                       before[1] + 1)
    ref = fused_logmel_from_frames_reference(frames)
    assert (out - ref).abs().max().item() <= 1e-4
    assert (out - fused_logmel_from_frames(frames)).abs().max().item() <= 1e-4


def test_mel_control_hook_routes_the_front_end(cuda_device, monkeypatch):
    wave = _rand((2, 16000), 7, 0.2).to(cuda_device)
    monkeypatch.setattr(mel_kernel, "_K1_CONTROL", True)
    before = (fused_logmel_from_frames.launches,
              fused_logmel_from_frames_fma.launches)
    frames = frame_waveforms(wave).reshape(-1, 512).contiguous()
    out = fused_logmel_from_frames(frames)
    assert (fused_logmel_from_frames.launches,
            fused_logmel_from_frames_fma.launches) == (before[0],
                                                       before[1] + 1)
    assert (out - fused_logmel_from_frames_reference(frames)).abs().max(
    ).item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,n_real", [(2, 200, None), (2, 256, 190),
                                        (1, 1, None), (3, 130, 129),
                                        (2, 1676, None)])
def test_attention_kernel_matches_plain(cuda_device, b, n, n_real, dtype):
    x = _rand((b, n, 3, 12, 64), 2).to(cuda_device, dtype)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = flash_attention.launches
    out = flash_attention(q, k, v, n_real=n_real)
    ref = attention_reference(q, k, v, n_real=n_real)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], err


def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    """head_dim 32 runs K2 on inputs zero-padded to 64, head_dim 128 its
    D = 128 instance, 256 its D = 256 instance and 320 its runtime-width
    (_dn) instance (each the plain version's result), and under every 8-bit
    mode head_dim 300 and 320 run K5/K6's _dn instance (within 2 bf16 ulps
    of the plain version's max|o|, as at 64). What stays refused: float16,
    rows off 16-byte boundaries, tensors on two devices."""
    from maest_tpu_torch.ops import attention as A

    for d in (32, 128, 256, 320):
        x = _rand((1, 8, 3, 2, d), 3).to(cuda_device)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        before = flash_attention.launches
        out = flash_attention(q, k, v)
        assert flash_attention.launches == before + 1 and out.shape == q.shape
        err = (out - attention_reference(q, k, v)).abs().max().item()
        assert err <= ATTN_TOL[torch.float32], (d, err)
    for d in (300, 320):
        x = _rand((1, 8, 3, 2, d), 3).to(cuda_device, torch.bfloat16)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        for quant in Q8_MODES:
            wrap = (A.attention_fwd_int8 if quant.startswith("qk8")
                    else A.attention_fwd_fp8)
            before = wrap.launches
            out = flash_attention(q, k, v, quant=quant)
            ref = A.attention_q8_reference(q, k, v, None, quant)[0]
            torch.cuda.synchronize()
            assert wrap.launches == before + 1 and out.shape == q.shape
            top = ref.float().abs().max().item()
            tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
            assert (out.float() - ref.float()).abs().max().item() <= tol
    x = torch.zeros(1, 8, 3, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2])
    x = torch.zeros(1, 8, 2, 65, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(x[..., 1:], x[..., 1:], x[..., 1:])
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(x.to(cuda_device), x, x.to(cuda_device))


def test_model_on_card_matches_cpu(cuda_device):
    """The fp32 tier on the card (both kernels) against the same weights
    on the CPU (both plain versions), through ``predict_labels`` and the
    embedding tap."""
    cpu = get_maest(device="cpu", **TINY)
    with torch.no_grad():
        cpu.net.head[1].weight.copy_(_rand((16, 128), 1, 0.2))
    gpu = get_maest(device="cuda", **TINY)
    gpu.net.load_state_dict(cpu.net.state_dict())
    wave = _rand(3 * 16000 + 77, 4, 0.3).numpy()
    np.testing.assert_allclose(gpu.predict_labels(wave)[0],
                               cpu.predict_labels(wave)[0],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        gpu(wave, transformer_block=1)[1].cpu().numpy(),
        cpu(wave, transformer_block=1)[1].numpy(), rtol=2e-4, atol=2e-5)


def test_bf16_service_on_card(cuda_device):
    """The bf16 tier through TagService on the card: fused wave, pcm16 and
    chunked requests, each against ``predict_labels`` (1e-2: a bucket of
    another size may take other cuBLAS kernels)."""
    model = get_maest(device="cuda", dtype=torch.bfloat16, **TINY)
    with torch.no_grad():
        model.net.head[1].weight.copy_(_rand((16, 128), 1, 0.2))
    svc = TagService(model, buckets=(1, 2, 4), max_wait_ms=0.0)
    try:
        native = svc.wave_programs.native_len
        wave = _rand(native, 5, 0.3).numpy()
        pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
        for x in (wave, pcm, _rand(3 * 16000, 6, 0.3).numpy()):
            acts, _ = svc.tag(x)
            ref, _ = model.predict_labels(x)
            assert np.isfinite(acts).all()
            np.testing.assert_allclose(acts, ref, atol=1e-2)
    finally:
        svc.close()


# --- training: K3a (forward with lse), K3b / K4 (backward) ----------------
# lse 1e-4 (fp32 log2-sum-exp of sums in other orders); gradients as the
# forward: fp32 2e-5, bf16 2e-2 compared in fp32.
LSE_TOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,n_real", [(2, 200, None), (2, 256, 190),
                                        (1, 1, None), (3, 130, 129),
                                        (1, 4500, 4400)])
def test_train_kernels_match_plain(cuda_device, b, n, n_real, dtype):
    """K3a against attention_reference_lse, and the backward (one design
    for K3b's and K4's regimes, here up to N 4500) against
    attention_bwd_reference on the same saved tensors."""
    x = _rand((b, n, 3, 12, 64), 7).to(cuda_device, dtype)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    g = _rand((b, n, 12, 64), 8).to(cuda_device, dtype)
    counts = (flash_attention_fwd_lse.launches, attention_bwd.launches)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real=n_real)
    ro, rlse = attention_reference_lse(q, k, v, n_real)
    grads = attention_bwd(q, k, v, ro, rlse, g, n_real)
    ref = attention_bwd_reference(q, k, v, ro, rlse, g, n_real)
    torch.cuda.synchronize()
    assert (flash_attention_fwd_lse.launches, attention_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert lse.shape == (b, 12, n) and lse.dtype == torch.float32
    assert (lse - rlse).abs().max().item() <= LSE_TOL
    assert (o.float() - ro.float()).abs().max().item() <= ATTN_TOL[dtype]
    for ours, want in zip(grads, ref):
        assert ours.shape == q.shape and ours.dtype == dtype
        err = (ours.float() - want.float()).abs().max().item()
        assert err <= ATTN_TOL[dtype], err
    if n_real is not None and n_real < n:
        assert not grads[1][:, n_real:].any() and not grads[2][:, n_real:].any()


def test_autograd_on_card_matches_cpu(cuda_device):
    """flash_attention under autograd: K3a forward, K3b backward on the
    card, the plain versions on the CPU, same fp32 inputs."""
    x = _rand((2, 150, 3, 4, 64), 9).requires_grad_(True)
    xg = x.detach().to(cuda_device).requires_grad_(True)
    for t in (x, xg):
        out = flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2], n_real=140)
        (out * out).sum().backward()
    np.testing.assert_allclose(xg.grad.cpu().numpy(), x.grad.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_backward_rejects_a_bad_lse(cuda_device):
    x = torch.zeros(1, 8, 3, 2, 64, device=cuda_device)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    with pytest.raises(ValueError, match="lse"):
        attention_bwd(q, k, v, q, torch.zeros(1, 8, 2, device=cuda_device), q)


def test_train_step_on_card_matches_cpu(cuda_device):
    """Two fp32 train steps of a tiny model (masking and mixup off) on the
    card (K3a, K3b) and on the CPU: losses rtol 1e-5; every parameter
    within Adam's bound, 2 lr a step (Adam divides each coordinate's
    gradient by its own magnitude, so a coordinate whose gradient is near
    zero moves by its fp32 noise: the key bias, whose gradient is zero in
    exact arithmetic, and a few others); all but 1e-4 of the coordinates
    (the key bias aside) within rtol 1e-4 / atol 2e-6."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.train import (
        AugmentConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=128, depth=2,
                       num_heads=2, input_t=206, n_classes=16,
                       s_patchout_t_indices=(3, 7))
    rng = np.random.default_rng(10)
    batch = {"x": rng.standard_normal((4, 96, 206)).astype("f4"),
             "y": (rng.random((4, 16)) < 0.3).astype("f4")}
    aug = AugmentConfig(masking=False, mixup_alpha=0.0)
    runs = {}
    for dev in ("cpu", cuda_device):
        net = MAESTNet(cfg, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            net.head[1].weight.copy_(_rand((16, 128), 11, 0.2))
        net.to(dev)
        tx = make_optimizer(lr_schedule=1e-3)
        st = TrainState.create(net, tx)
        step = make_train_step(net, tx, aug)
        gen = torch.Generator().manual_seed(0)
        losses = [step(st, batch, gen)[1]["train_loss"] for _ in range(2)]
        runs[str(dev)] = (losses, {k: p.detach().cpu() for k, p in
                                   net.named_parameters()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = runs["cpu"], runs[str(cuda_device)]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    adam_bound = 2 * 2 * 1e-3  # 2 lr a step, 2 steps
    far = total = 0
    for k, a in p_gpu.items():
        a, b = a.numpy(), p_cpu[k].numpy()
        assert np.abs(a - b).max() <= adam_bound, k
        if k.endswith("attn.qkv.bias"):
            a, b = np.delete(a, np.s_[128:256]), np.delete(b, np.s_[128:256])
        far += int((np.abs(a - b) > 2e-6 + 1e-4 * np.abs(b)).sum())
        total += a.size
    print(f"train step on the card against the CPU: {far} of {total} "
          f"coordinates beyond rtol 1e-4 / atol 2e-6 (at most "
          f"{1e-4 * total:.1f})")
    assert far <= 1e-4 * total, (far, total)


@pytest.mark.parametrize("policy,fwd", [(None, 1), ("full", 2), ("dots", 2),
                                        ("attn_out", 1)])
def test_remat_launch_counts_on_card(cuda_device, policy, fwd):
    """Training forward launches a layer: one without remat and under
    attn_out (the backward reuses the saved o and lse), two under full and
    dots (the block, attention included, is recomputed); one backward."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=128, depth=2,
                       num_heads=2, input_t=206, n_classes=16,
                       remat=policy is not None,
                       remat_policy=policy or "full")
    net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=cuda_device)
    x = _rand((2, 1, 96, 206), 12).to(cuda_device)
    before = (flash_attention.launches, flash_attention_fwd_lse.launches,
              attention_bwd.launches)
    net(x, train=True, generator=torch.Generator().manual_seed(0))[0].float(
        ).sum().backward()
    torch.cuda.synchronize()
    grew = [a - b for a, b in zip((flash_attention.launches,
                                   flash_attention_fwd_lse.launches,
                                   attention_bwd.launches), before)]
    assert grew == [0, fwd * cfg.depth, cfg.depth]


# --- the 8-bit modes: K5 / K6 (forward), K7 (int8 backward) ---------------
# K5/K6 against attention_q8_reference on the same key tiles (the route's:
# 128 keys in bf16 at head_dim 64, the wgmma kernel; 64 elsewhere) and K7
# against attention_bwd_int8_reference: 2e-2 compared in fp32 (bf16
# outputs; an exp2 ulp may flip the rounding of one 8-bit p or ds), K7
# relative to each gradient's max.
Q8_MODES = ("qk8", "qk8pv8", "fp8", "fp8pv8")


@pytest.mark.parametrize("b,n,n_real", [(2, 300, 290), (1, 1, None),
                                        (3, 130, 129), (1, 1676, None)])
@pytest.mark.parametrize("mode", Q8_MODES)
def test_q8_forward_kernels_match_plain(cuda_device, mode, b, n, n_real):
    from maest_tpu_torch.ops import attention as A

    x = _rand((b, n, 3, 12, 64), 10).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    wrap = A.attention_fwd_int8 if mode.startswith("qk8") else A.attention_fwd_fp8
    before = wrap.launches
    o, lse = wrap(q, k, v, n_real, mode.endswith("pv8"), with_lse=True)
    ro, rlse = A.attention_q8_reference(q, k, v, n_real, mode)
    torch.cuda.synchronize()
    assert wrap.launches == before + 1
    assert o.dtype == torch.bfloat16 and lse.shape == (b, 12, n)
    assert (o.float() - ro.float()).abs().max().item() <= 2e-2
    assert (lse - rlse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("b,n,n_real", [(2, 300, 290), (2, 1800, 1790),
                                        (4, 866, None), (1, 1, None)])
def test_int8_backward_kernel_matches_plain(cuda_device, b, n, n_real):
    from maest_tpu_torch.ops import attention as A

    x = _rand((b, n, 3, 12, 64), 11).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    g = _rand((b, n, 12, 64), 12).to(cuda_device, torch.bfloat16)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real)
    before = A.attention_bwd_int8.launches
    got = A.attention_bwd_int8(q, k, v, o, lse, g, n_real)
    ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g, n_real)
    torch.cuda.synchronize()
    assert A.attention_bwd_int8.launches == before + 1
    for ours, want in zip(got, ref):
        top = want.float().abs().max().item()
        assert (ours.float() - want.float()).abs().max().item() <= 2e-2 * top
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


def test_q8_autograd_on_card_matches_cpu(cuda_device):
    """quant and bwd_quant together under autograd: K5 with lse and K7 on
    the card, the plain versions on the CPU, the same bf16 inputs."""
    x = _rand((2, 150, 3, 4, 64), 13).to(torch.bfloat16).requires_grad_(True)
    xg = x.detach().to(cuda_device).requires_grad_(True)
    for t in (x, xg):
        out = flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2], n_real=140,
                              quant="qk8", bwd_quant="int8")
        out.float().square().sum().backward()
    top = x.grad.float().abs().max().item()
    assert (xg.grad.cpu().float() - x.grad.float()).abs().max().item() <= (
        2e-2 * top)


def test_q8_modes_refuse_fp32_on_card(cuda_device):
    """fp32 under an 8-bit mode, once refused on the card, runs the fp32
    instances of K5/K6 and K7: qk8 and fp8 (p unrounded times fp32 v)
    within relative L2 1e-5 of plain, the pv8 modes within 2 bf16 ulps of
    max|o|, K7 within 2e-2 of each gradient's max; head_dim 32 on inputs
    zero-padded to 64."""
    from maest_tpu_torch.ops import attention as A

    for d in (64, 32):
        x = _rand((2, 300, 4, 3, d), 14).to(cuda_device)
        q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
        for mode in Q8_MODES:
            wrap = (A.attention_fwd_int8 if mode.startswith("qk8")
                    else A.attention_fwd_fp8)
            before = wrap.launches
            o, lse = wrap(q, k, v, 290, mode.endswith("pv8"), with_lse=True)
            ro, rlse = A.attention_q8_reference(q, k, v, 290, mode)
            torch.cuda.synchronize()
            assert wrap.launches == before + 1 and o.dtype == torch.float32
            assert o.shape == q.shape
            if mode.endswith("pv8"):
                top = ro.abs().max().item()
                tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
                assert (o - ro).abs().max().item() <= tol, mode
            else:
                assert ((o - ro).norm() / ro.norm()).item() <= 1e-5, mode
            assert (lse - rlse).abs().max().item() <= LSE_TOL
        o, lse = flash_attention_fwd_lse(q, k, v, 290)
        before = A.attention_bwd_int8.launches
        got = A.attention_bwd_int8(q, k, v, o, lse, g, 290)
        ref = A.attention_bwd_int8_reference(q, k, v, o, lse, g, 290)
        torch.cuda.synchronize()
        assert A.attention_bwd_int8.launches == before + 1
        for ours, want in zip(got, ref):
            assert ours.dtype == torch.float32 and ours.shape == q.shape
            top = want.abs().max().item()
            assert (ours - want).abs().max().item() <= 2e-2 * top


@pytest.mark.parametrize("mode", Q8_MODES)
def test_q8_wgmma_route_matches_plain_and_control(cuda_device, mode):
    """The wgmma 8-bit forward (bf16, head_dim 64) at (2, 300) n_real 290:
    its pass equal to ``q8_pass_reference`` (NaN as NaN), o within 2 bf16
    ulps of max|o| of plain at the route's 128-key tile and lse within
    LSE_TOL, with and without lse; the control (``attention_fwd_q8_mma``)
    within the same bound of plain at its 64-key tile; each counted."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((2, 300, 3, 12, 64), 40).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    got = A.q8_pass_views(*A.launch_q8_pass(q, k, v, mode), 2, 300, 12, mode)
    for key, want in A.q8_pass_reference(q, k, v, mode).items():
        assert (got[key] is None) == (want is None), key
        if want is not None:
            a, w = got[key].float(), want.float()
            assert torch.equal(torch.isnan(a), torch.isnan(w)), key
            assert torch.equal(a[~torch.isnan(a)], w[~torch.isnan(w)]), key
    wrap = A.attention_fwd_int8 if mode.startswith("qk8") else A.attention_fwd_fp8
    before = (wrap.launches, A.attention_fwd_q8_mma.launches)
    o, none = wrap(q, k, v, 290, mode.endswith("pv8"))
    o2, lse = wrap(q, k, v, 290, mode.endswith("pv8"), with_lse=True)
    co, clse = A.attention_fwd_q8_mma(q, k, v, 290, mode, with_lse=True)
    torch.cuda.synchronize()
    assert (wrap.launches, A.attention_fwd_q8_mma.launches) == (
        before[0] + 2, before[1] + 1) and none is None
    for out, out_lse, block_k in ((o, None, 128), (o2, lse, 128),
                                  (co, clse, 64)):
        ro, rlse = A.attention_q8_reference(q, k, v, 290, mode, block_k)
        top = ro.float().abs().max().item()
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        assert (out.float() - ro.float()).abs().max().item() <= tol
        if out_lse is not None:
            assert (out_lse - rlse).abs().max().item() <= LSE_TOL


def test_q8_control_hook_routes_the_model(cuda_device, monkeypatch):
    """With the private hook ``_Q8_CONTROL`` set, every 8-bit forward in
    bf16 at head_dim 64 launches the mma.sync control (counted in
    attention_fwd_q8_mma) and not the wgmma route, and the tagging
    activations stay within 1e-2 of the route's."""
    from maest_tpu_torch.ops import attention as A

    wave = _rand(3 * 16000 + 77, 84, 0.3).numpy()
    for mode in Q8_MODES:
        monkeypatch.setattr(A, "_Q8_CONTROL", False)
        model = get_maest(device=cuda_device, dtype=torch.bfloat16,
                          attention_quant=mode, **TINY)
        with torch.no_grad():  # zero heads would hide every difference
            model.net.head[1].weight.copy_(_rand((16, 128), 2, 0.2))
        ours = model.predict_labels(wave)[0]
        wrap = (A.attention_fwd_int8 if mode.startswith("qk8")
                else A.attention_fwd_fp8)
        before = (wrap.launches, A.attention_fwd_q8_mma.launches)
        monkeypatch.setattr(A, "_Q8_CONTROL", True)
        ctrl = model.predict_labels(wave)[0]
        grew = (wrap.launches - before[0],
                A.attention_fwd_q8_mma.launches - before[1])
        assert grew[0] == 0 and grew[1] > 0, (mode, grew)
        assert np.abs(ours - ctrl).max() <= 1e-2, mode


# --- the decomposition probes P6a-d (ops/attention_probe.py) --------------
# against attention_probe_reference on the same 64-key tiles: 2 bf16 ulps of
# the largest |o| (both round one fp32 output to bf16; the fp32 values
# differ by sums in other orders).
@pytest.mark.parametrize("b,n", [(2, 100), (2, 866), (2, 1676)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_probe_kernels_match_plain(cuda_device, variant, b, n):
    x = _rand((b, n, 3, 12, 64), 15).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    for n_real in (None, None if variant == "mxu_only" else n - 7):
        before = attention_probe.launches[variant]
        out = attention_probe(q, k, v, variant, n_real)
        ref = attention_probe_reference(q, k, v, variant, n_real)
        torch.cuda.synchronize()
        assert attention_probe.launches[variant] == before + 1
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        top = ref.float().abs().max().item()
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        assert (out.float() - ref.float()).abs().max().item() <= tol


def test_probe_kernels_reject_what_they_do_not_take(cuda_device):
    x = _rand((1, 64, 3, 2, 64), 16).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    with pytest.raises(TypeError, match="bfloat16"):
        attention_probe(q.float(), k.float(), v.float(), "noexp_max")
    y = torch.zeros(1, 8, 3, 2, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_probe(y[:, :, 0], y[:, :, 1], y[:, :, 2], "novmax")
    with pytest.raises(ValueError, match="unknown attention probe variant"):
        attention_probe(q, k, v, "gh8")
    with pytest.raises(ValueError, match="n_real = N only"):
        attention_probe(q, k, v, "mxu_only", n_real=60)
    z = torch.zeros(1, 8, 2, 65, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_probe(z[..., 1:], z[..., 1:], z[..., 1:], "novmax")
    with pytest.raises(ValueError, match="one device"):
        attention_probe(q, k.cpu(), v, "bf16s")


def test_rig_times_graphs_and_splits_bf16s_on_the_card(cuda_device, capsys):
    """The rig's graph times, and bf16s's control (bf16s_mma) split into its
    kernel alone and its pass; bf16s on the wgmma kernel has no pass."""
    from maest_tpu_torch.probes import attn_profile

    out = attn_profile.main(["--batch", "2", "--heads", "2", "--shapes",
                             "200", "--iters", "4", "--variants",
                             "flash,mxu_only,bf16s_mma,wgmma,bf16s,plain"])
    rows = out["200"]
    for variant in ("flash", "mxu_only", "bf16s_mma", "wgmma", "bf16s"):
        assert rows[variant]["graph_ms"] > 0
        assert rows[variant]["idle"] == pytest.approx(
            1 - rows[variant]["graph_ms"] / rows[variant]["ms"])
    assert rows["plain"]["graph_ms"] is None
    assert 0 < rows["bf16s_mma"]["kernel_ms"] < rows["bf16s_mma"]["ms"]
    assert 0 < rows["bf16s_mma"]["pass_ms"] < rows["bf16s_mma"]["ms"]
    assert "kernel_ms" not in rows["bf16s"]
    text = capsys.readouterr().out
    assert "ms (graphs); its kernel alone" in text
    assert "bf16s - wgmma = " in text and "bf16s_mma - flash = " in text


def test_launch_probe_is_the_kernel_alone(cuda_device):
    """launch_probe on a pre-scaled q is bf16s's control
    (attention_probe_mma, the mma.sync kernel behind the PyTorch pass); it
    launches on CUDA tensors only."""
    from maest_tpu_torch.ops.attention_probe import (
        attention_probe_mma,
        launch_probe,
        prescale_q,
    )

    x = _rand((2, 130, 3, 2, 64), 17).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    assert torch.equal(launch_probe(prescale_q(q), k, v, "bf16s"),
                       attention_probe_mma(q, k, v, "bf16s"))
    assert torch.equal(launch_probe(q, k, v, "novmax"),
                       attention_probe(q, k, v, "novmax"))
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        launch_probe(q.cpu(), k.cpu(), v.cpu(), "novmax")


# --- P6d on K2's wgmma kernel and its mma.sync control ----------------------
# the route against its plain version at the wgmma kernel's key tiles (96 or
# 112), the control against its own on 64-key tiles: 2 bf16 ulps of the
# largest |o|, as above; each launch counted on its own wrapper
@pytest.mark.parametrize("b,n,n_real", [(2, 100, None), (3, 100, 90),
                                        (2, 866, None), (2, 1676, 1600),
                                        (1, 200, 185)])
def test_bf16s_wgmma_route_and_control_match_plain(cuda_device, b, n,
                                                   n_real):
    from maest_tpu_torch.ops.attention_probe import (
        attention_probe_mma,
        attention_probe_mma_reference,
    )

    x = _rand((b, n, 3, 12, 64), 18 + n).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = (attention_probe.launches["bf16s"], attention_probe_mma.launches)
    pairs = ((attention_probe(q, k, v, "bf16s", n_real),
              attention_probe_reference(q, k, v, "bf16s", n_real)),
             (attention_probe_mma(q, k, v, "bf16s", n_real),
              attention_probe_mma_reference(q, k, v, "bf16s", n_real)))
    torch.cuda.synchronize()
    assert (attention_probe.launches["bf16s"],
            attention_probe_mma.launches) == (before[0] + 1, before[1] + 1)
    for out, ref in pairs:
        top = ref.float().abs().max().item()
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        assert (out.float() - ref.float()).abs().max().item() <= tol


def _planted_gap(tmp_path, lib_name, header, old, new, code):
    """Build ``csrc/<lib_name>.cu`` from a copy of csrc/ whose ``header`` has
    the line ``old`` replaced by ``new``, then run ``code`` (which prints a
    JSON value last) in a process of its own with that library as
    ``lib_name``: a second copy of a kernel launched here would not take its
    dynamic shared-memory limit."""
    import json
    import shutil
    import subprocess
    import sys

    from maest_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    text = (src / header).read_text()
    assert text.count(old) == 1
    (src / header).write_text(text.replace(old, new))
    lib = tmp_path / f"{lib_name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / f"{lib_name}.cu")], check=True,
                   capture_output=True)
    proc = subprocess.run([sys.executable, "-c", (
        "import ctypes, sys, torch\n"
        f"sys.path.insert(0, {str(_build.CSRC.parents[1])!r})\n"
        "from maest_tpu_torch.ops import _build\n"
        f"_build._libs[{lib_name!r}] = ctypes.CDLL({str(lib)!r})\n" + code)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


_BF16S_GAP = (
    "import json, numpy as np\n"
    "from maest_tpu_torch.ops.attention import flash_attention\n"
    "from maest_tpu_torch.ops.attention_probe import attention_probe, "
    "attention_probe_reference\n"
    "x = torch.from_numpy(np.random.default_rng(19).standard_normal("
    "(2, 866, 3, 12, 64)).astype(np.float32)).cuda().bfloat16()\n"
    "q, k, v = x.unbind(2)\n"
    "o = attention_probe(q, k, v, 'bf16s', 850).float()\n"
    "r = attention_probe_reference(q, k, v, 'bf16s', 850).float()\n"
    "k2 = flash_attention(q, k, v, n_real=850).float()\n"
    "print(json.dumps([(o - r).abs().max().item(), r.abs().max().item(), "
    "(o - k2).abs().max().item(), (o - r).abs().mean().item(), "
    "(o - k2).abs().mean().item()]))\n")


def _bf16s_holds(err, top, k2, mean, mean_k2):
    """Within 2 bf16 ulps of the largest |o| of plain, and nearer plain than
    K2's output: in max, and 4 times in mean |difference| (chip_smoke.py
    PROBE_NEAR)."""
    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return err <= tol and k2 > err and mean_k2 > 4 * mean


def test_bf16s_check_refuses_the_score_rounding_dropped(cuda_device,
                                                         tmp_path):
    """The wgmma bf16s kernel built with the bf16 rounding of its scores
    left out (bf16_round2 returning at once: K2's softmax on the pre-scaled
    q): the checks that hold the sound kernel to plain refuse it. Run with
    -s to see the gaps."""
    import json
    import subprocess
    import sys

    from maest_tpu_torch.ops import _build

    sound = subprocess.run([sys.executable, "-c", (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(_build.CSRC.parents[1])!r})\n"
        + _BF16S_GAP)], capture_output=True, text=True, timeout=300)
    assert sound.returncode == 0, sound.stderr
    good = json.loads(sound.stdout.strip().splitlines()[-1])
    bad = _planted_gap(
        tmp_path, "attention_probe", "attn_fwd_wgmma.cuh",
        "  const uint32_t u = pack_bf16(a, b);  // a in the low half",
        "  const uint32_t u = 0u; return;", _BF16S_GAP)
    print(f"planted: bf16s without its score rounding: (max|o - plain|, "
          f"max|plain|, max|o - K2|, mean|o - plain|, mean|o - K2|) {bad} "
          f"(sound {good})")
    assert _bf16s_holds(*good) and not _bf16s_holds(*bad)


# --- K3b at head_dim 256 on wgmma (csrc/attn_bwd_d256_wgmma.cuh) ------------
# each gradient within 1e-2 of max(1, its max |x|) of the tiled plain version
# and of plain (tests/test_torch_bwd_wgmma.py's bf16 bound)
D256_REL = 1e-2


def _d256_rel(got, want):
    return max(((a.float() - z.float()).abs().max() / max(
        1.0, z.float().abs().max().item())).item() for a, z in zip(got, want))


def _d256_schedule(q, k, v, o, lse, do, n_real):
    from maest_tpu_torch.ops import attention as A

    d = q.shape[-1]
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    return tuple(g[..., :d] for g in A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, n_real, scale,
        key_tile=A.BWD_D256_KEY_TILE, q_tile=A.BWD_D256_Q_TILE))


@pytest.mark.parametrize("b,n,n_real,h,d", [
    (2, 200, 190, 3, 256), (32, 866, None, 3, 256), (2, 300, 281, 2, 192),
    (2, 130, 1, 2, 256), (1, 70, None, 1, 256), (2, 1000, 997, 1, 256)])
def test_d256_wgmma_backward_matches_plain_and_control(cuda_device, b, n,
                                                       n_real, h, d):
    """K3b at head_dim 256 (and 192, zero-padded) through attention_bwd,
    each call counted, on strided views of one fused q/k/v/do: within the
    bound of its plain version and of plain, two launches torch.equal,
    masked dk/dv exactly zero; the mma.sync control (through
    _K3B_CONTROL) within the same bound of plain."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((b, n, 4, h, d), 40 + n + d).to(cuda_device, torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real)
    before = (A.attention_bwd.launches, A.attention_bwd_mma.launches)
    got = attention_bwd(q, k, v, o, lse, do, n_real)
    again = attention_bwd(q, k, v, o, lse, do, n_real)
    A._K3B_CONTROL = True
    try:
        ctrl = attention_bwd(q, k, v, o, lse, do, n_real)
    finally:
        A._K3B_CONTROL = False
    ref = attention_bwd_reference(q, k, v, o, lse, do, n_real)
    tiled = _d256_schedule(q, k, v, o, lse, do, n_real)
    torch.cuda.synchronize()
    assert (A.attention_bwd.launches - before[0],
            A.attention_bwd_mma.launches - before[1]) == (2, 1)
    assert all(torch.equal(a, z) for a, z in zip(got, again))
    assert _d256_rel(got, ref) <= D256_REL and _d256_rel(got, tiled) <= D256_REL
    assert _d256_rel(ctrl, ref) <= D256_REL
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


def test_d256_check_refuses_dv_last_tile_dropped(cuda_device, tmp_path):
    """The head_dim-256 wgmma backward built with dV's products of the last
    q tile left out: at N 256 that tile is a quarter of every key's rows,
    and the check that holds the sound kernels to their plain version
    refuses it. Run with -s to see the gap."""
    code = (
        "import json, numpy as np\n"
        "from maest_tpu_torch.ops import attention as A\n"
        "x = torch.from_numpy(np.random.default_rng(41).standard_normal("
        "(2, 256, 4, 3, 256)).astype(np.float32)).cuda().bfloat16()\n"
        "q, k, v, do = x.unbind(2)\n"
        "o, lse = A.flash_attention_fwd_lse(q, k, v, 250)\n"
        "g = A.attention_bwd(q, k, v, o, lse, do, 250)\n"
        "r = A.attention_bwd_tiled_reference(q, k, v, o, lse, do, 250, "
        "key_tile=A.BWD_D256_KEY_TILE, q_tile=A.BWD_D256_Q_TILE)\n"
        "print(json.dumps(max(((a.float() - z.float()).abs().max() / max("
        "1.0, z.float().abs().max().item())).item() for a, z in zip(g, r))))\n")
    line = ("        wgmma_rs_n64_t(acc[c], af[kj], sw128_desc(rows + c * CHUNK) "
            "+ kj * 128);")
    bad = _planted_gap(tmp_path, "attention_bwd", "attn_bwd_d256_wgmma.cuh",
                       line, line.replace("        wgmma_rs", (
                           "        if (wg != 0 || it + 1 < n_qt) wgmma_rs")),
                       code)
    x = _rand((2, 256, 4, 3, 256), 41).to(cuda_device, torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = flash_attention_fwd_lse(q, k, v, 250)
    good = _d256_rel(attention_bwd(q, k, v, o, lse, do, 250),
                     _d256_schedule(q, k, v, o, lse, do, 250))
    print(f"planted: dV without the last q tile: relative gap {bad:.4g} "
          f"against {D256_REL} (sound {good:.4g})")
    assert good <= D256_REL < bad


def test_k3b_control_hook_routes_head_dim_256(cuda_device, monkeypatch):
    """With the private hook set, the bf16 backward at head_dim 256 (one
    head of a 256-wide model) launches the mma.sync kernels, counted in
    attention_bwd_mma, and not the wgmma ones; every parameter's gradient
    stays within 1e-2 of its largest |g| (at least 1e-2 of the largest of
    all) of the wgmma route's."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops import attention as A

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=256, depth=2,
                       num_heads=1, input_t=206, n_classes=16)
    net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=cuda_device,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # zero heads would hide every difference
        net.head[1].weight.copy_(_rand((16, 256), 14, 0.2))
    x = _rand((2, 1, 96, 206), 15).to(cuda_device)
    grads = {}
    for control in (False, True):
        monkeypatch.setattr(A, "_K3B_CONTROL", control)
        net.zero_grad()
        before = (A.attention_bwd.launches, A.attention_bwd_mma.launches)
        net(x, train=True, generator=torch.Generator().manual_seed(0))[
            0].float().square().sum().backward()
        torch.cuda.synchronize()
        grew = (A.attention_bwd.launches - before[0],
                A.attention_bwd_mma.launches - before[1])
        assert grew == ((0, cfg.depth) if control else (cfg.depth, 0))
        grads[control] = {k: p.grad.detach().clone()
                          for k, p in net.named_parameters()
                          if p.grad is not None}
    big = max(g.abs().max().item() for g in grads[False].values())
    for k, g in grads[False].items():
        top = max(g.abs().max().item(), 1e-2 * big)
        assert (grads[True][k] - g).abs().max().item() <= 1e-2 * top, k


# --- K3b above head_dim 256 (csrc/attn_bwd_dn_wgmma.cuh) and K2/K3a at 256
# (csrc/attn_fwd_d256_wgmma.cuh) on wgmma -----------------------------------
def _dn_schedule(q, k, v, o, lse, do, n_real):
    from maest_tpu_torch.ops import attention as A

    d = q.shape[-1]
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    return tuple(g[..., :d] for g in A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, n_real, scale,
        key_tile=A.BWD_DN_KEY_TILE, q_tile=A.BWD_DN_Q_TILE))


@pytest.mark.parametrize("b,n,n_real,h,d", [
    (2, 300, 281, 2, 320), (2, 300, 281, 2, 384), (2, 200, 190, 2, 512),
    (2, 200, 190, 1, 1024), (1, 4500, 4400, 2, 320), (2, 100, 90, 2, 300),
    (3, 64, 1, 2, 384), (4, 866, None, 2, 384)])
def test_dn_wgmma_backward_matches_plain_and_control(cuda_device, b, n,
                                                     n_real, h, d):
    """K3b above head_dim 256 (and 300, zero-padded to 320) through
    attention_bwd, each call counted, on strided views of one fused
    q/k/v/do: within D256_REL of its plain version and of plain, two
    launches torch.equal, masked dk/dv exactly zero; the mma.sync control
    (through _K3B_CONTROL) within the same bound of plain."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((b, n, 4, h, d), 60 + n + d).to(cuda_device, torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real)
    before = (A.attention_bwd.launches, A.attention_bwd_mma.launches)
    got = attention_bwd(q, k, v, o, lse, do, n_real)
    again = attention_bwd(q, k, v, o, lse, do, n_real)
    A._K3B_CONTROL = True
    try:
        ctrl = attention_bwd(q, k, v, o, lse, do, n_real)
    finally:
        A._K3B_CONTROL = False
    ref = attention_bwd_reference(q, k, v, o, lse, do, n_real)
    tiled = _dn_schedule(q, k, v, o, lse, do, n_real)
    torch.cuda.synchronize()
    assert (A.attention_bwd.launches - before[0],
            A.attention_bwd_mma.launches - before[1]) == (2, 1)
    assert all(torch.equal(a, z) for a, z in zip(got, again))
    assert _d256_rel(got, ref) <= D256_REL and _d256_rel(got, tiled) <= D256_REL
    assert _d256_rel(ctrl, ref) <= D256_REL
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


# the planted faults' lines: the dv/dk products leave out the last q tile;
# the head_dim-256 forward drops its key mask
DN_PLANT = ("  const int n_k = ((TRANS_A ? n_real : n) + 63) / 64;",
            "  const int n_k = ((TRANS_A ? n_real : n) + 63) / 64 - !TRANS_A;")
D256_FWD_PLANT = (
    "        const float x = key < n_real ? s[nt][e] * sl : NEG_INF;",
    "        const float x = s[nt][e] * sl;")


def test_dn_check_refuses_the_last_q_tile_dropped(cuda_device, tmp_path):
    """The wgmma backward above 256 built with dv's and dk's products of
    the last q tile left out: at N 256 that tile is a quarter of every
    key's rows, and the check that holds the sound kernels to their plain
    version refuses it. Run with -s to see the gap."""
    code = (
        "import json, numpy as np\n"
        "from maest_tpu_torch.ops import attention as A\n"
        "x = torch.from_numpy(np.random.default_rng(46).standard_normal("
        "(2, 256, 4, 2, 384)).astype(np.float32)).cuda().bfloat16()\n"
        "q, k, v, do = x.unbind(2)\n"
        "o, lse = A.flash_attention_fwd_lse(q, k, v, 250)\n"
        "g = A.attention_bwd(q, k, v, o, lse, do, 250)\n"
        "r = A.attention_bwd_tiled_reference(q, k, v, o, lse, do, 250, "
        "key_tile=A.BWD_DN_KEY_TILE, q_tile=A.BWD_DN_Q_TILE)\n"
        "print(json.dumps(max(((a.float() - z.float()).abs().max() / max("
        "1.0, z.float().abs().max().item())).item() for a, z in zip(g, r))))\n")
    bad = _planted_gap(tmp_path, "attention_bwd", "attn_bwd_dn_wgmma.cuh",
                       *DN_PLANT, code)
    x = _rand((2, 256, 4, 2, 384), 46).to(cuda_device, torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = flash_attention_fwd_lse(q, k, v, 250)
    good = _d256_rel(attention_bwd(q, k, v, o, lse, do, 250),
                     _dn_schedule(q, k, v, o, lse, do, 250))
    print(f"planted: dv and dk without the last q tile: relative gap "
          f"{bad:.4g} against {D256_REL} (sound {good:.4g})")
    assert good <= D256_REL < bad


D256_FWD_SHAPES = ((2, 1000, 997, 3, 256), (4, 866, None, 3, 256),
                   (2, 300, 281, 3, 192), (4, 130, 2, 2, 256),
                   (2, 1676, None, 3, 256))


@pytest.mark.parametrize("b,n,n_real,h,d", D256_FWD_SHAPES)
def test_d256_wgmma_forward_matches_plain_and_control(cuda_device, b, n,
                                                      n_real, h, d):
    """K2 and K3a at head_dim 256 (and 192, zero-padded) on the wgmma
    kernel, each launch counted, on strided views of a fused qkv: within
    the bf16 bound of plain and of the tiled plain version, taken relative
    to max(1, max |o|) (with 2 real keys |o| reaches 4-8, where one bf16
    ulp is 0.03125), lse within LSE_TOL, K2's o torch.equal to K3a's; the
    mma.sync control within the same bounds of plain."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((b, n, 3, h, d), 70 + n + d).to(cuda_device, torch.bfloat16)
    q, k, v = x.unbind(2)
    before = (flash_attention.launches, flash_attention_fwd_lse.launches)
    with torch.inference_mode():
        o = flash_attention(q, k, v, n_real=n_real)
    ol, lse = flash_attention_fwd_lse(q, k, v, n_real)
    r, rl = attention_reference_lse(q, k, v, n_real)
    (qp, kp, vp), scale = A.pad_head_dim(q, k, v)
    t, tl = A.attention_fwd_tiled_reference(qp, kp, vp, n_real, scale)
    c, cl = A.attention_fwd_mma(qp, kp, vp, n_real, with_lse=True) \
        if d == 256 else (r, rl)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_fwd_lse.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(o, ol) and o.shape == q.shape
    tol = ATTN_TOL[torch.bfloat16]
    for ours, want in ((o, r), (o, t[..., :d]), (c[..., :d], r)):
        assert (ours.float() - want.float()).abs().max().item() <= tol * max(
            1.0, want.float().abs().max().item())
    for got_lse in (lse, cl):
        assert (got_lse - rl).abs().max().item() <= LSE_TOL


def test_d256_check_refuses_the_mask_dropped(cuda_device, tmp_path):
    """The head_dim-256 wgmma forward built with its key mask dropped: with
    v = 8 past n_real 900 of 1000 the check that holds the sound kernel to
    plain refuses it. Run with -s to see the gap."""
    code = (
        "import json, numpy as np\n"
        "from maest_tpu_torch.ops import attention as A\n"
        "x = torch.from_numpy(np.random.default_rng(47).standard_normal("
        "(2, 1000, 3, 3, 256)).astype(np.float32)).cuda().bfloat16()\n"
        "x[:, 900:, 2] = 8.0\n"
        "q, k, v = x.unbind(2)\n"
        "o = A.flash_attention(q, k, v, n_real=900)\n"
        "r = A.attention_reference(q, k, v, 900)\n"
        "print(json.dumps((o.float() - r.float()).abs().max().item()))\n")
    bad = _planted_gap(tmp_path, "attention_fwd", "attn_fwd_d256_wgmma.cuh",
                       *D256_FWD_PLANT, code)
    x = _rand((2, 1000, 3, 3, 256), 47).to(cuda_device, torch.bfloat16)
    x[:, 900:, 2] = 8.0
    q, k, v = x.unbind(2)
    good = (flash_attention(q, k, v, n_real=900).float()
            - attention_reference(q, k, v, 900).float()).abs().max().item()
    print(f"planted: the head_dim-256 forward without its key mask: "
          f"max|o - plain| {bad:.4g} against {ATTN_TOL[torch.bfloat16]} "
          f"(sound {good:.4g})")
    assert good <= ATTN_TOL[torch.bfloat16] < bad


@pytest.mark.parametrize("heads", [3, 2], ids=["d256", "d384"])
def test_controls_route_a_training_step_above_128(cuda_device, monkeypatch,
                                                  heads):
    """With both private hooks set, a bf16 training forward and backward of
    a 768-wide model at 3 heads (head_dim 256) or 2 (384) launches the
    mma.sync controls, counted in attention_fwd_mma and attention_bwd_mma,
    and not the wgmma kernels; every parameter's gradient stays within
    1e-2 of its largest |g| (at least 1e-2 of the largest of all) of the
    wgmma routes'."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops import attention as A

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=768, depth=2,
                       num_heads=heads, input_t=206, n_classes=16)
    net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=cuda_device,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # zero heads would hide every difference
        net.head[1].weight.copy_(_rand((16, 768), 16, 0.2))
    x = _rand((2, 1, 96, 206), 17).to(cuda_device)
    counted = (flash_attention_fwd_lse, attention_bwd, A.attention_fwd_mma,
               A.attention_bwd_mma)
    grads = {}
    for control in (False, True):
        monkeypatch.setattr(A, "_K2_CONTROL", control)
        monkeypatch.setattr(A, "_K3B_CONTROL", control)
        net.zero_grad()
        before = [f.launches for f in counted]
        net(x, train=True, generator=torch.Generator().manual_seed(0))[
            0].float().square().sum().backward()
        torch.cuda.synchronize()
        grew = [f.launches - c for f, c in zip(counted, before)]
        assert grew == ([0, 0, cfg.depth, cfg.depth] if control
                        else [cfg.depth, cfg.depth, 0, 0])
        grads[control] = {k: p.grad.detach().clone()
                          for k, p in net.named_parameters()
                          if p.grad is not None}
    big = max(g.abs().max().item() for g in grads[False].values())
    for k, g in grads[False].items():
        top = max(g.abs().max().item(), 1e-2 * big)
        assert (grads[True][k] - g).abs().max().item() <= 1e-2 * top, k


# --- P6e (gh), P6f (int8) and the P5 kinds --------------------------------
# gh: torch.equal to K2's wgmma kernel, its control to K2's mma.sync kernel
# (each head runs K2's arithmetic on the same key tiles). int8 (fp32 out):
# each row within one p flip of plain, max|v| / (127 l), + 1e-5 of max|o|.
# P5 against plain: attention_vpu.plain_gap, 2 bf16 ulps of max|o| (bf16sm,
# fp8sm, fp8nomask add 2^-7 max|o|: the packed ex2's relative error in each
# p, against the plain version's bf16 rounding) and relative L2 1e-2.
@pytest.mark.parametrize("b,n,n_real", [(2, 1676, None), (4, 272, None),
                                        (2, 300, 290), (2, 1, None)])
def test_gh_kernels_equal_k2(cuda_device, b, n, n_real):
    from maest_tpu_torch.ops.attention_probe import (
        GROUPS,
        attention_probe_gh,
        attention_probe_gh_mma,
    )

    from maest_tpu_torch.ops.attention import attention_fwd_mma

    x = _rand((b, n, 3, 12, 64), 18).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    # the route is K2's wgmma kernel with G heads a block; its control K2's
    # mma.sync template with G heads a block
    k2 = flash_attention(q, k, v, n_real=n_real)
    k2_mma = attention_fwd_mma(q, k, v, n_real)[0]
    for g in GROUPS:
        before = (attention_probe_gh.launches[g],
                  attention_probe_gh_mma.launches[g])
        out = attention_probe_gh(q, k, v, g, n_real)
        ctl = attention_probe_gh_mma(q, k, v, g, n_real)
        torch.cuda.synchronize()
        assert (attention_probe_gh.launches[g],
                attention_probe_gh_mma.launches[g]) == (before[0] + 1,
                                                        before[1] + 1)
        assert torch.equal(out, k2), g
        assert torch.equal(ctl, k2_mma), g


@pytest.mark.parametrize("b,n,n_real", [(3, 100, None), (2, 1676, None),
                                        (2, 300, 290), (1, 1, None)])
def test_int8_kernel_matches_plain(cuda_device, b, n, n_real):
    from maest_tpu_torch.ops.attention_probe import (
        attention_probe_int8,
        attention_probe_int8_reference,
        int8_rig_pass,
        launch_int8,
    )

    x = _rand((b, n, 3, 12, 64), 19, 0.5).to(cuda_device)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = attention_probe_int8.launches
    out = attention_probe_int8(q, k, v, n_real)
    ref, l = attention_probe_int8_reference(q, k, v, n_real, with_l=True)
    torch.cuda.synchronize()
    assert attention_probe_int8.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    top = ref.abs().max().item()
    tol = v.abs().max().item() / (127 * l) + 1e-5 * top
    assert bool(((out - ref).abs().amax(-1) <= tol).all())
    assert torch.equal(launch_int8(int8_rig_pass(q, k, v), n_real), out)
    att = attention_reference(q, k, v, n_real)
    assert (out * 127 - att).abs().max().item() <= 1e-2


@pytest.mark.parametrize("b,n", [(3, 100), (2, 1676), (2, 300)])
@pytest.mark.parametrize("kind", ["bf16sm", "fp8sm", "fp8noexp", "fp8nomask",
                                  "fp8lean"])
def test_vpu_kernels_match_plain(cuda_device, kind, b, n):
    from maest_tpu_torch.ops.attention_vpu import (
        PLAIN_REL_L2,
        attention_vpu_probe,
        attention_vpu_probe_reference,
        launch_vpu,
        plain_gap,
        vpu_pass,
    )

    x = _rand((b, n, 3, 12, 64), 20, 0.3).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    n_real = None if kind == "fp8nomask" else n - 5
    before = attention_vpu_probe.launches[kind]
    out = attention_vpu_probe(q, k, v, kind, n_real)
    ref = attention_vpu_probe_reference(q, k, v, kind, n_real)
    torch.cuda.synchronize()
    assert attention_vpu_probe.launches[kind] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    err, tol, rel = plain_gap(kind, out, ref)
    assert err <= tol and rel <= PLAIN_REL_L2
    assert torch.equal(launch_vpu(vpu_pass(q, k, v, kind), kind, n_real), out)


# faults planted in a copy of the packed-ex2 softmax (attn_fwd_bf16.cuh
# softmax_bf16, shared by bf16sm, fp8sm and fp8nomask): the key mask off,
# or the correction corr held at 1; "zeros" stands for a kernel that writes
# nothing. Each must fail plain_gap in every kind it touches.
_FAULTS = {
    "mask_off": ("if constexpr (MASK) {", "if constexpr (false) {"),
    "corr_1": ("    m[r] = mr;\n    l[r] *= corr[r];",
               "    m[r] = mr;\n    corr[r] = 1.0f;\n    l[r] *= corr[r];"),
}
_HIT = {"zeros": ("bf16sm", "fp8sm", "fp8noexp", "fp8nomask", "fp8lean"),
        "mask_off": ("bf16sm", "fp8sm"),
        "corr_1": ("bf16sm", "fp8sm", "fp8nomask")}


@pytest.mark.parametrize("fault", ["zeros", "mask_off", "corr_1"])
def test_vpu_check_refuses_planted_faults(cuda_device, tmp_path, monkeypatch,
                                          fault):
    """plain_gap refuses each planted fault in every kind it touches at
    (3, 100) and (2, 1676), and passes the kinds it leaves alone. Run with
    -s to see each kind's gap."""
    import ctypes
    import shutil
    import subprocess

    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops.attention_vpu import (
        KINDS,
        PLAIN_REL_L2,
        attention_vpu_probe,
        attention_vpu_probe_reference,
        plain_gap,
    )

    if fault in _FAULTS:
        src = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, src)
        header = src / "attn_fwd_bf16.cuh"
        text = header.read_text()
        old, new = _FAULTS[fault]
        assert text.count(old) == 1
        header.write_text(text.replace(old, new))
        lib = tmp_path / "attention_probe.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src / "attention_probe.cu")], check=True,
                       capture_output=True)
        monkeypatch.setitem(_build._libs, "attention_probe",
                            ctypes.CDLL(str(lib)))
    for b, n in ((3, 100), (2, 1676)):
        x = _rand((b, n, 3, 12, 64), 22, 0.3).to(cuda_device, torch.bfloat16)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        for kind in KINDS:
            ref = attention_vpu_probe_reference(q, k, v, kind)
            out = (torch.zeros_like(ref) if fault == "zeros"
                   else attention_vpu_probe(q, k, v, kind))
            err, tol, rel = plain_gap(kind, out, ref)
            within = err <= tol and rel <= PLAIN_REL_L2
            print(f"planted {fault} {kind} ({b}, {n}): max|o - plain| "
                  f"{err:.3e} (bound {tol:.3e}), relative L2 {rel:.3e} "
                  f"(bound {PLAIN_REL_L2}): {'within' if within else 'refused'}")
            assert within != (kind in _HIT[fault]), (fault, kind, b, n)


def test_vpu_kernels_reject_what_they_do_not_take(cuda_device):
    from maest_tpu_torch.ops.attention_probe import attention_probe_gh
    from maest_tpu_torch.ops.attention_vpu import attention_vpu_probe

    x = _rand((1, 64, 3, 6, 64), 21).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    with pytest.raises(ValueError, match="not divisible by the group 4"):
        attention_probe_gh(q, k, v, 4)
    with pytest.raises(ValueError, match="multiple of 64"):
        attention_vpu_probe(q, k, v, "fp8nomask", n_pad=100)
    with pytest.raises(ValueError, match="one device"):
        attention_vpu_probe(q, k.cpu(), v, "fp8sm")
    z = torch.zeros(1, 8, 2, 65, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        attention_vpu_probe(z[..., 1:], z[..., 1:], z[..., 1:], "bf16sm")


def test_rigs_time_gh_int8_and_the_vpu_kinds_on_the_card(cuda_device, capsys):
    """attn_profile's gh<G> and int8 (with int8's kernel alone and pass),
    and attn_vpu's kinds, each with a graph time."""
    from maest_tpu_torch.probes import attn_profile, attn_vpu

    out = attn_profile.main(["--batch", "2", "--heads", "4", "--shapes",
                             "200", "--iters", "4", "--variants",
                             "flash,wgmma,gh2,gh8,gh8_mma,int8",
                             "--rounds", "2"])
    rows = out["200"]
    assert all(r["graph_ms"] > 0 for r in rows.values())
    assert all(len(r["rounds_ms"]) == 2 and r["round_median"] > 0
               for r in rows.values())
    # at this size the pass (~30 small ops) is host-bound and reads as long
    # as the whole wrapper within the noise
    assert 0 < rows["int8"]["kernel_ms"] < rows["int8"]["ms"]
    assert rows["int8"]["pass_ms"] > 0
    vpu = attn_vpu.main(["--batch", "2", "--tokens", "200", "--heads", "4",
                         "--iters", "4", "--rounds", "2"])
    assert all(r["graph_ms"] > 0 for r in vpu.values())
    assert all(vpu[k]["kernel_graph_ms"] > 0 for k in vpu if k.startswith("fp8"))
    text = capsys.readouterr().out
    assert "gh8 - wgmma = " in text and "gh8_mma - flash = " in text
    assert "quantization pass" in text and "200 interleaved medians" in text
    assert "product bound (fp8/fp8)" in text


# --- head_dim below 64: the kernels on zero-padded inputs -------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [16, 32])
def test_padded_head_dim_matches_plain(cuda_device, d, dtype):
    """K2, K3a and K3b at head_dim d on strided views of a fused qkv, each
    launched once, against the plain versions at d (their own scale)."""
    x = _rand((2, 281, 4, 6, d), 30 + d).to(cuda_device, dtype)
    q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    counts = [f.launches for f in (flash_attention, flash_attention_fwd_lse,
                                   attention_bwd)]
    o2 = flash_attention(q, k, v, n_real=270)
    o, lse = flash_attention_fwd_lse(q, k, v)
    ro, rlse = attention_reference_lse(q, k, v)
    grads = attention_bwd(q, k, v, ro, rlse, g)
    ref = attention_bwd_reference(q, k, v, ro, rlse, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention, flash_attention_fwd_lse,
                                 attention_bwd)] == [c + 1 for c in counts]
    tol = ATTN_TOL[dtype]
    pairs = [(o2, attention_reference(q, k, v, n_real=270)), (o, ro),
             *zip(grads, ref)]
    for ours, want in pairs:
        assert ours.shape == q.shape and ours.dtype == dtype
        assert (ours.float() - want.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= LSE_TOL


# --- head_dim 65-256: the kernels' D = 128 and D = 256 instances -----------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [96, 128, 192, 256])
def test_wide_head_dim_matches_plain(cuda_device, d, dtype):
    """K2, K3a, K3b, K5/K6 in every mode (with lse) and K7 at head_dim d
    (96 zero-padded to 128, 192 to 256), each launched once, against the plain
    versions, within the bounds head_dim 64 is held to: K2-K3b as
    test_padded_head_dim_matches_plain; the 8-bit forward 2e-2 in bf16
    (test_q8_forward_kernels_match_plain) and, in fp32, relative L2 1e-5
    (qk8, fp8) or 2 bf16 ulps of max|o| (pv8 modes); K7 2e-2 of each
    gradient's max."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((2, 300, 4, 4, d), 40 + d).to(cuda_device, dtype)
    q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    counts = [f.launches for f in (flash_attention, flash_attention_fwd_lse,
                                   attention_bwd)]
    o2 = flash_attention(q, k, v, n_real=290)
    o, lse = flash_attention_fwd_lse(q, k, v)
    ro, rlse = attention_reference_lse(q, k, v)
    grads = attention_bwd(q, k, v, ro, rlse, g)
    ref = attention_bwd_reference(q, k, v, ro, rlse, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention, flash_attention_fwd_lse,
                                 attention_bwd)] == [c + 1 for c in counts]
    for ours, want in [(o2, attention_reference(q, k, v, n_real=290)),
                       (o, ro), *zip(grads, ref)]:
        assert ours.shape == q.shape and ours.dtype == dtype
        assert (ours.float() - want.float()).abs().max().item() <= (
            ATTN_TOL[dtype])
    assert (lse - rlse).abs().max().item() <= LSE_TOL
    for mode in Q8_MODES:
        wrap = (A.attention_fwd_int8 if mode.startswith("qk8")
                else A.attention_fwd_fp8)
        before = wrap.launches
        o8, l8 = wrap(q, k, v, 290, mode.endswith("pv8"), with_lse=True)
        r8, rl8 = A.attention_q8_reference(q, k, v, 290, mode)
        torch.cuda.synchronize()
        assert wrap.launches == before + 1 and o8.shape == q.shape
        if dtype == torch.bfloat16:
            assert (o8.float() - r8.float()).abs().max().item() <= 2e-2, mode
        elif mode.endswith("pv8"):
            top = r8.abs().max().item()
            tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
            assert (o8 - r8).abs().max().item() <= tol, mode
        else:
            assert ((o8 - r8).norm() / r8.norm()).item() <= 1e-5, mode
        assert (l8 - rl8).abs().max().item() <= LSE_TOL
    before = A.attention_bwd_int8.launches
    got = A.attention_bwd_int8(q, k, v, ro, rlse, g, 290)
    want8 = A.attention_bwd_int8_reference(q, k, v, ro, rlse, g, 290)
    torch.cuda.synchronize()
    assert A.attention_bwd_int8.launches == before + 1
    for ours, want in zip(got, want8):
        assert ours.shape == q.shape and ours.dtype == dtype
        top = want.float().abs().max().item()
        assert (ours.float() - want.float()).abs().max().item() <= 2e-2 * top
    assert not got[1][:, 290:].any() and not got[2][:, 290:].any()


# --- head_dim above 256: every kernel's _dn instance ------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [320, 384, 512, 1024])
def test_dn_head_dim_matches_plain(cuda_device, d, dtype):
    """K2, K3a and K3b at head_dim d through the runtime-width (_dn)
    instances (in bf16 K2/K3a's wgmma kernel, csrc/attn_fwd_dn_wgmma.cuh,
    q resident up to 768 and streamed at 1024), each launched once,
    against the plain versions within the
    bounds head_dim 64 is held to; K7 under bwd_quant="int8" through its
    _dn instance, launched once: bf16 within 2e-2 of each gradient's max,
    fp32 within 1e-5 of it but for at most 4 rows (b, n, h), all within
    2e-2: delta sums d products in another order than plain, so the
    q-block's max |ds| may move by an ulp and flip one ds8 code, which
    moves one row of dq and one of dk."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((2, 200, 4, 2, d), 50 + d).to(cuda_device, dtype)
    q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    counts = [f.launches for f in (flash_attention, flash_attention_fwd_lse,
                                   attention_bwd)]
    o2 = flash_attention(q, k, v, n_real=190)
    o, lse = flash_attention_fwd_lse(q, k, v)
    ro, rlse = attention_reference_lse(q, k, v)
    grads = attention_bwd(q, k, v, ro, rlse, g, 190)
    ref = attention_bwd_reference(q, k, v, ro, rlse, g, 190)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention, flash_attention_fwd_lse,
                                 attention_bwd)] == [c + 1 for c in counts]
    for ours, want in [(o2, attention_reference(q, k, v, n_real=190)),
                       (o, ro), *zip(grads, ref)]:
        assert ours.shape == q.shape and ours.dtype == dtype
        assert (ours.float() - want.float()).abs().max().item() <= (
            ATTN_TOL[dtype])
    assert (lse - rlse).abs().max().item() <= LSE_TOL
    assert not grads[1][:, 190:].any() and not grads[2][:, 190:].any()
    before = A.attention_bwd_int8.launches
    got = A.attention_bwd_int8(q, k, v, ro, rlse, g, 190)
    want = A.attention_bwd_int8_reference(q, k, v, ro, rlse, g, 190)
    torch.cuda.synchronize()
    assert A.attention_bwd_int8.launches == before + 1
    for ours, r in zip(got, want):
        assert ours.shape == q.shape and ours.dtype == dtype
        top = r.float().abs().max().item()
        err = (ours.float() - r.float()).abs()
        assert err.max().item() <= 2e-2 * top
        if dtype == torch.float32:
            assert int((err.amax(dim=-1) > 1e-5 * top).sum()) <= 4
    assert not got[1][:, 190:].any() and not got[2][:, 190:].any()


@pytest.mark.parametrize("d", [384, 1024])
def test_dn_forward_control_matches_plain(cuda_device, d):
    """The control of the bf16 _dn forward (attention_fwd_mma, the mma.sync
    kernel, entry maest_attn_fwd_bf16_dn_mma) at head_dim d with and
    without lse, on strided views of a fused qkv, against plain within the
    bf16 bound and LSE_TOL, each launch counted in attention_fwd_mma and
    none in the route's counters; with _K2_CONTROL a forward at that width
    launches the control, not the wgmma kernel."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((2, 200, 3, 2, d), 90 + d).to(cuda_device, torch.bfloat16)
    q, k, v = x.unbind(2)
    counted = (A.attention_fwd_mma, flash_attention, flash_attention_fwd_lse)
    before = [f.launches for f in counted]
    o, none = A.attention_fwd_mma(q, k, v, 190)
    ol, lse = A.attention_fwd_mma(q, k, v, 190, with_lse=True)
    r, rl = attention_reference_lse(q, k, v, 190)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(counted, before)] == [2, 0, 0]
    assert none is None and torch.equal(o, ol) and o.shape == q.shape
    assert (o.float() - r.float()).abs().max().item() <= ATTN_TOL[
        torch.bfloat16]
    assert (lse - rl).abs().max().item() <= LSE_TOL
    A._K2_CONTROL = True
    try:
        hooked = flash_attention(q, k, v, n_real=190)
    finally:
        A._K2_CONTROL = False
    assert torch.equal(hooked, o)
    assert [f.launches - c for f, c in zip(counted, before)] == [3, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [320, 512, 1024])
@pytest.mark.parametrize("mode", Q8_MODES)
def test_q8_dn_forward_matches_plain(cuda_device, mode, d, dtype):
    """K5/K6 at head_dim d through their runtime-width (_dn) instances,
    with and without lse, against attention_q8_reference on the same
    64-key tiles, each launch counted: bf16 within 2 bf16 ulps of max|o|
    (as at 64: one fp32 output rounded on both sides, an exp2 ulp may flip
    one 8-bit p); fp32 qk8 and fp8 within relative L2 1e-5, the pv8 modes
    within 2 bf16 ulps; lse within LSE_TOL."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((2, 200, 3, 2, d), 60 + d).to(cuda_device, dtype)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    wrap = A.attention_fwd_int8 if mode.startswith("qk8") else A.attention_fwd_fp8
    pv8 = mode.endswith("pv8")
    before = wrap.launches
    o, none = wrap(q, k, v, 190, pv8)
    o2, lse = wrap(q, k, v, 190, pv8, with_lse=True)
    ro, rlse = A.attention_q8_reference(q, k, v, 190, mode)
    torch.cuda.synchronize()
    assert wrap.launches == before + 2 and none is None
    top = ro.float().abs().max().item()
    ulps = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    for out in (o, o2):
        assert out.shape == q.shape and out.dtype == dtype
        err = (out.float() - ro.float()).abs().max().item()
        if dtype == torch.float32 and not pv8:
            assert ((out - ro).norm() / ro.norm()).item() <= 1e-5
        else:
            assert err <= ulps, (err, ulps)
    assert (lse - rlse).abs().max().item() <= LSE_TOL


# --- K2/K3a on wgmma and TMA (csrc/attn_fwd_wgmma.cuh) ----------------------
# Against plain as every bf16 forward (2e-2, lse 1e-4), and lse within 1e-5
# of the mma.sync control's: the same running max, and l the same fp32 p
# summed in another order (96-key tiles against 64), a few fp32 ulps of
# log2(l) (measured at most 1.9e-6 on an H100).
WG_LSE_TOL = 1e-5
WG_SHAPES = [(32, 1676, None), (32, 1792, 1676), (32, 866, None),
             (100, 281, None), (2, 1000, 997)]


def _wgmma_cfg(cfg, q, k, v, n_real=None, with_lse=False):
    from maest_tpu_torch.ops import attention as A

    return A.launch_fwd_entry("attention_fwd", "maest_attn_fwd_bf16_wgmma",
                              (cfg,), q, k, v, n_real, with_lse,
                              q.shape[-1]**-0.5)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("b,n,n_real", WG_SHAPES)
def test_wgmma_forward_matches_plain_and_control(cuda_device, b, n, n_real,
                                                 layout):
    """K2 and K3a (the wgmma kernel, through flash_attention and
    flash_attention_fwd_lse, each launched once) at the main path's
    shapes, on strided views of a fused qkv and on contiguous q, k, v:
    within the bf16 bound of plain, lse within LSE_TOL of plain and
    WG_LSE_TOL of the control's, the two outputs equal."""
    from maest_tpu_torch.ops.attention import attention_fwd_mma

    x = _rand((b, n, 3, 12, 64), 70 + n).to(cuda_device, torch.bfloat16)
    q, k, v = x.unbind(2)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = (flash_attention.launches, flash_attention_fwd_lse.launches)
    with torch.inference_mode():
        o = flash_attention(q, k, v, n_real=n_real)
    ol, lse = flash_attention_fwd_lse(q, k, v, n_real)
    c, cl = attention_fwd_mma(q, k, v, n_real, with_lse=True)
    r, rl = attention_reference_lse(q, k, v, n_real)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_fwd_lse.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(o, ol) and o.shape == q.shape
    tol = ATTN_TOL[torch.bfloat16]
    assert (o.float() - r.float()).abs().max().item() <= tol
    assert (c.float() - r.float()).abs().max().item() <= tol
    assert (lse - rl).abs().max().item() <= LSE_TOL
    assert (lse - cl).abs().max().item() <= WG_LSE_TOL


# head_dim 128 on wgmma: K2 and K3a (the route, through flash_attention and
# flash_attention_fwd_lse) against plain, at a ragged N past n_real, the 30 s
# recipe's N and head_dim 96 zero-padded; the control (attention_fwd_mma at
# 128) within the same bound; every sweep configuration within it, the
# 64-key ones equal to the control bit for bit (the same tiles and sums)
D128_SHAPES = ((2, 1000, 997, 128), (4, 866, None, 128), (2, 300, 281, 96))


@pytest.mark.parametrize("b,n,n_real,d", D128_SHAPES)
def test_d128_wgmma_forward_matches_plain_and_control(cuda_device, b, n,
                                                      n_real, d):
    from maest_tpu_torch.ops.attention import attention_fwd_mma

    x = _rand((b, n, 3, 6, d), 90 + d).to(cuda_device, torch.bfloat16)
    q, k, v = x.unbind(2)
    before = (flash_attention.launches, flash_attention_fwd_lse.launches)
    with torch.inference_mode():
        o = flash_attention(q, k, v, n_real=n_real)
    ol, lse = flash_attention_fwd_lse(q, k, v, n_real)
    r, rl = attention_reference_lse(q, k, v, n_real)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_fwd_lse.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(o, ol) and o.shape == q.shape
    tol = ATTN_TOL[torch.bfloat16]
    assert (o.float() - r.float()).abs().max().item() <= tol
    assert (lse - rl).abs().max().item() <= LSE_TOL
    if d == 128:
        c, cl = attention_fwd_mma(q, k, v, n_real, with_lse=True)
        assert (c.float() - r.float()).abs().max().item() <= tol
        assert (cl - rl).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("cfg", range(9))
def test_d128_wgmma_sweep_configurations_match_plain(cuda_device, cfg):
    from maest_tpu_torch.ops import attention as A

    x = _rand((2, 1000, 3, 6, 128), 95).to(cuda_device, torch.bfloat16)
    q, k, v = x.unbind(2)
    o, lse = A.launch_fwd_entry("attention_fwd",
                                "maest_attn_fwd_bf16_d128_wgmma", (cfg,), q,
                                k, v, 997, True, 128**-0.5)
    r, rl = attention_reference_lse(q, k, v, 997)
    c, cl = A.attention_fwd_mma(q, k, v, 997, with_lse=True)
    torch.cuda.synchronize()
    assert (o.float() - r.float()).abs().max().item() <= ATTN_TOL[
        torch.bfloat16]
    assert (lse - rl).abs().max().item() <= LSE_TOL
    if cfg in (0, 1, 6):  # 64-key tiles
        assert torch.equal(o, c) and torch.equal(lse, cl)


@pytest.mark.parametrize("cfg", range(8))
def test_wgmma_sweep_configurations_match_plain(cuda_device, cfg):
    """Every configuration of the tile sweep (maest_attn_fwd_bf16_wgmma)
    within the bf16 bound of plain with and without lse, at a ragged N
    and n_real; the production route takes 112-key tiles (4) where they
    pad n_real less than 96-key ones (0): at 997 (1008 against 1056) and
    at 281 not (336 against 288); 2 (64-key tiles) equals the control
    bit for bit."""
    from maest_tpu_torch.ops.attention import attention_fwd_mma

    x = _rand((2, 1000, 3, 12, 64), 80).to(cuda_device, torch.bfloat16)
    q, k, v = x.unbind(2)
    o, lse = _wgmma_cfg(cfg, q, k, v, 997, True)
    o2, none = _wgmma_cfg(cfg, q, k, v, 997, False)
    r, rl = attention_reference_lse(q, k, v, 997)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o, o2)
    tol = ATTN_TOL[torch.bfloat16]
    assert (o.float() - r.float()).abs().max().item() <= tol
    assert (lse - rl).abs().max().item() <= LSE_TOL
    if cfg == 4:
        assert torch.equal(o, flash_attention(q, k, v, n_real=997))
    if cfg == 0:
        o281 = _wgmma_cfg(cfg, q, k, v, 281)[0]
        assert torch.equal(o281, flash_attention(q, k, v, n_real=281))
    if cfg == 2:
        c, cl = attention_fwd_mma(q, k, v, 997, with_lse=True)
        assert torch.equal(o, c) and torch.equal(lse, cl)


def test_wgmma_check_refuses_the_mask_dropped(cuda_device, tmp_path):
    """The wgmma kernel built with its key mask dropped (a copy of csrc/ in
    a temporary directory): the keys at or past n_real in the last tile
    take mass. With v = 8 past n_real 900 of 1000, the check that holds the
    sound kernel to plain refuses it. The copy runs in a process of its
    own: a second copy of a kernel this process has launched does not take
    its dynamic shared-memory limit (its launch fails). Run with -s to see
    the gap."""
    import json
    import shutil
    import subprocess
    import sys

    from maest_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "attn_fwd_wgmma.cuh"
    text = header.read_text()
    old = "            const float x = key < n_real ? s[nt][e] * sl : NEG_INF;"
    assert text.count(old) == 1
    header.write_text(text.replace(
        old, "            const float x = s[nt][e] * sl;"))
    lib = tmp_path / "attention_fwd.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / "attention_fwd.cu")], check=True,
                   capture_output=True)
    def inputs():
        x = _rand((2, 1000, 3, 12, 64), 81).to(cuda_device, torch.bfloat16)
        x[:, 900:, 2] = 8.0
        return x.unbind(2)

    q, k, v = inputs()
    r = attention_reference(q, k, v, 900)
    sound = (flash_attention(q, k, v, n_real=900).float()
             - r.float()).abs().max().item()
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(_build.CSRC.parents[1])!r})\n"
        "import numpy as np\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_fwd'] = ctypes.CDLL({str(lib)!r})\n"
        "x = torch.from_numpy(np.random.default_rng(81).standard_normal("
        "(2, 1000, 3, 12, 64)).astype(np.float32)).cuda().bfloat16()\n"
        "x[:, 900:, 2] = 8.0\n"
        "q, k, v = x.unbind(2)\n"
        "bad = A.launch_fwd_entry('attention_fwd', 'maest_attn_fwd_bf16', (),"
        " q, k, v, 900, False, 0.125)[0]\n"
        "r = A.attention_reference(q, k, v, 900)\n"
        "print(json.dumps((bad.float() - r.float()).abs().max().item()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    gap = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"planted: the wgmma kernel without its key mask: max|out - plain| "
          f"{gap:.4g} against the bound {ATTN_TOL[torch.bfloat16]} (sound "
          f"{sound:.4g})")
    assert sound <= ATTN_TOL[torch.bfloat16] < gap


def test_k2_control_hook_routes_the_model(cuda_device, monkeypatch):
    """The private hook that lets a measurement time the model with the
    control: with it set, the bf16 forward at head_dim 64 launches the
    mma.sync kernel (counted in attention_fwd_mma) and not the wgmma one,
    and the tagging activations stay within 1e-2 of the wgmma route's."""
    from maest_tpu_torch.ops import attention as A

    model = get_maest(device=cuda_device, dtype=torch.bfloat16, **TINY)
    with torch.no_grad():  # zero heads would hide every difference
        model.net.head[1].weight.copy_(_rand((16, 128), 1, 0.2))
    wave = _rand(3 * 16000 + 77, 83, 0.3).numpy()
    ours = model.predict_labels(wave)[0]
    before = (A.flash_attention.launches, A.attention_fwd_mma.launches)
    monkeypatch.setattr(A, "_K2_CONTROL", True)
    ctrl = model.predict_labels(wave)[0]
    grew = (A.flash_attention.launches - before[0],
            A.attention_fwd_mma.launches - before[1])
    assert grew[0] == 0 and grew[1] > 0, grew
    assert np.abs(ours - ctrl).max() <= 1e-2


# --- K3b/K4 on wgmma and TMA (csrc/attn_bwd_wgmma.cuh) ----------------------
# Against plain and the tiled plain version as every bf16 backward (2e-2,
# compared in fp32), masked dk/dv exactly zero, two launches bit-equal.
BWD_WG_SHAPES = [(32, 866, None), (32, 896, 866), (100, 281, None),
                 (2, 4500, 4400)]


def _bwd_wgmma_cfg(cfg, q, k, v, o, lse, do, n_real=None):
    from maest_tpu_torch.ops import attention as A

    return A.launch_bwd_entry("maest_attn_bwd_bf16_wgmma", (cfg,), q, k, v, o,
                              lse, do, n_real, q.shape[-1]**-0.5).unbind(2)


def _bwd_gap(got, want):
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


@pytest.mark.parametrize("b,n,n_real", BWD_WG_SHAPES)
def test_wgmma_backward_matches_plain_and_control(cuda_device, b, n, n_real):
    """K3b/K4 (the wgmma kernel, through attention_bwd, each call counted)
    at the main path's shapes and K4's on strided views of one fused
    q/k/v/do: within the bf16 bound of attention_bwd_reference and of the
    tiled plain version, masked dk/dv exactly zero, two launches
    torch.equal; the mma.sync control within the same bound of plain."""
    from maest_tpu_torch.ops.attention import (
        attention_bwd_mma,
        attention_bwd_tiled_reference,
    )

    x = _rand((b, n, 4, 12, 64), 90 + n).to(cuda_device, torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real)
    before = attention_bwd.launches
    got = attention_bwd(q, k, v, o, lse, do, n_real)
    again = attention_bwd(q, k, v, o, lse, do, n_real)
    ctrl = attention_bwd_mma(q, k, v, o, lse, do, n_real)
    ref = attention_bwd_reference(q, k, v, o, lse, do, n_real)
    tiled = attention_bwd_tiled_reference(q, k, v, o, lse, do, n_real)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 2
    assert all(torch.equal(a, z) for a, z in zip(got, again))
    tol = ATTN_TOL[torch.bfloat16]
    assert _bwd_gap(got, ref) <= tol and _bwd_gap(got, tiled) <= tol
    assert _bwd_gap(ctrl, ref) <= tol
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


@pytest.mark.parametrize("cfg", range(4))
def test_wgmma_backward_sweep_configurations_match_plain(cuda_device, cfg):
    """Every configuration of the backward's sweep
    (maest_attn_bwd_bf16_wgmma: q rows 64 or 128 a tile, with or without
    turns) within the bf16 bound of plain at a ragged N and n_real, masked
    dk/dv exactly zero; 0 is the production route bit for bit."""
    x = _rand((2, 1000, 4, 12, 64), 91).to(cuda_device, torch.bfloat16)
    q, k, v, do = x.unbind(2)
    o, lse = flash_attention_fwd_lse(q, k, v, 997)
    got = _bwd_wgmma_cfg(cfg, q, k, v, o, lse, do, 997)
    ref = attention_bwd_reference(q, k, v, o, lse, do, 997)
    torch.cuda.synchronize()
    assert _bwd_gap(got, ref) <= ATTN_TOL[torch.bfloat16]
    assert not got[1][:, 997:].any() and not got[2][:, 997:].any()
    if cfg == 0:
        want = attention_bwd(q, k, v, o, lse, do, 997)
        assert all(torch.equal(a, z) for a, z in zip(got, want))


def test_wgmma_backward_check_refuses_the_mask_dropped(cuda_device, tmp_path):
    """The wgmma backward built with its key mask dropped (a copy of csrc/
    in a temporary directory): the keys at or past n_real take mass. With
    k = 4 past n_real 900 of 1000, the check that holds the sound kernel
    to plain refuses it, and the masked keys get dk and dv. The copy runs
    in a process of its own (as the forward's planted fault). Run with -s
    to see the gap."""
    import json
    import shutil
    import subprocess
    import sys

    from maest_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "attn_bwd_wgmma.cuh"
    text = header.read_text()
    old = "    const bool live0 = key0 < n_real, live1 = key0 + 8 < n_real;"
    assert text.count(old) == 1
    header.write_text(text.replace(
        old, "    const bool live0 = key0 < n, live1 = key0 + 8 < n;"))
    lib = tmp_path / "attention_bwd.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / "attention_bwd.cu")], check=True,
                   capture_output=True)
    make = ("x = torch.from_numpy(np.random.default_rng(92).standard_normal("
            "(2, 1000, 4, 12, 64)).astype(np.float32)).cuda().bfloat16()\n"
            "x[:, 900:, 1] = 4.0\n"
            "q, k, v, do = x.unbind(2)\n"
            "o, lse = A.flash_attention_fwd_lse(q, k, v, 900)\n")
    scope = {}
    exec("import numpy as np, torch\n"
         "from maest_tpu_torch.ops import attention as A\n" + make, scope)
    sound = _bwd_gap(attention_bwd(*(scope[n] for n in (
        "q", "k", "v", "o", "lse", "do")), 900), attention_bwd_reference(
        *(scope[n] for n in ("q", "k", "v", "o", "lse", "do")), 900))
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(_build.CSRC.parents[1])!r})\n"
        "import numpy as np\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_bwd'] = ctypes.CDLL({str(lib)!r})\n"
        + make +
        "bad = A.launch_bwd_entry('maest_attn_bwd_bf16', (), q, k, v, o, lse,"
        " do, 900, 0.125).unbind(2)\n"
        "ref = A.attention_bwd_reference(q, k, v, o, lse, do, 900)\n"
        "print(json.dumps([max((a.float() - r.float()).abs().max().item() "
        "for a, r in zip(bad, ref)), max(g[:, 900:].float().abs().max()"
        ".item() for g in bad[1:])]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    gap, masked = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"planted: the wgmma backward without its key mask: max|grads - "
          f"plain| {gap:.4g} against the bound {ATTN_TOL[torch.bfloat16]}, "
          f"masked dk/dv up to {masked:.4g} (sound {sound:.4g})")
    assert sound <= ATTN_TOL[torch.bfloat16] < gap and masked > 0


def test_k3b_control_hook_routes_a_training_step(cuda_device, monkeypatch):
    """The private hook that lets a measurement time the model's training
    steps with the control: with it set, the bf16 backward at head_dim 64
    launches the mma.sync kernels (counted in attention_bwd_mma) and not
    the wgmma one, and every parameter's gradient stays within 1e-2 of its
    largest |g| (at least 1e-2 of the largest of all) of the wgmma
    route's."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops import attention as A

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=128, depth=2,
                       num_heads=2, input_t=206, n_classes=16)
    net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=cuda_device,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # zero heads would hide every difference
        net.head[1].weight.copy_(_rand((16, 128), 14, 0.2))
    x = _rand((2, 1, 96, 206), 15).to(cuda_device)
    grads = {}
    for control in (False, True):
        monkeypatch.setattr(A, "_K3B_CONTROL", control)
        net.zero_grad()
        before = (A.attention_bwd.launches, A.attention_bwd_mma.launches)
        net(x, train=True, generator=torch.Generator().manual_seed(0))[
            0].float().square().sum().backward()
        torch.cuda.synchronize()
        grew = (A.attention_bwd.launches - before[0],
                A.attention_bwd_mma.launches - before[1])
        assert grew == ((0, cfg.depth) if control else (cfg.depth, 0))
        grads[control] = {k: p.grad.detach().clone()
                          for k, p in net.named_parameters()
                          if p.grad is not None}
    # a gradient that is zero in exact arithmetic (the key bias's) is fp32
    # noise on both routes: its floor is 1e-2 of the largest gradient's max
    big = max(g.abs().max().item() for g in grads[False].values())
    for k, g in grads[False].items():
        top = max(g.abs().max().item(), 1e-2 * big)
        assert (grads[True][k] - g).abs().max().item() <= 1e-2 * top, k


# --- K7 on wgmma (csrc/attn_bwd_q8_wgmma.cuh) --------------------------------
# chip_smoke.py's phase 15 draws at smaller batches: the 30 s recipe's N,
# padded with n_real, the 10 s recipe's, three 640-row q-blocks, normal x
# 0.5; K7_TOL of each gradient's max and a cosine of K7_COS, as there
K7_WG_CASES = [(2, 866, None, 1.0), (2, 896, 866, 1.0), (4, 281, None, 1.0),
               (1, 1800, 1790, 1.0), (2, 866, None, 0.5)]
K7_TOL, K7_COS = 2e-2, 0.9999


def _k7_ok(got, want):
    for a, r in zip(got, want):
        a, r = a.double().flatten(), r.double().flatten()
        top = r.abs().max().item()
        cos = (a @ r / (a.norm() * r.norm())).item()
        if (a - r).abs().max().item() > K7_TOL * top or cos < K7_COS:
            return False
    return True


@pytest.mark.parametrize("b,n,n_real,scale", K7_WG_CASES)
def test_k7_wgmma_matches_plain_and_control(cuda_device, b, n, n_real, scale):
    """The int8 backward in bf16 at head_dim 64 (the wgmma kernels, through
    attention_bwd_int8, each call counted) on strided views of one fused
    q/k/v: within K7_TOL and K7_COS of attention_bwd_int8_reference and of
    its tiled plain version, two launches torch.equal (dq's int32 sums are
    order-free), masked dk/dv exactly zero; the mma.sync control
    (attention_bwd_int8_mma) within the same bound of plain."""
    from maest_tpu_torch.ops import attention as A

    x = _rand((b, n, 3, 12, 64), 95 + n, scale).to(cuda_device,
                                                   torch.bfloat16)
    q, k, v = x.unbind(2)
    do = _rand((b, n, 12, 64), 96 + n).to(cuda_device, torch.bfloat16)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real)
    before = (A.attention_bwd_int8.launches, A.attention_bwd_int8_mma.launches)
    got = A.attention_bwd_int8(q, k, v, o, lse, do, n_real)
    again = A.attention_bwd_int8(q, k, v, o, lse, do, n_real)
    ctrl = A.attention_bwd_int8_mma(q, k, v, o, lse, do, n_real)
    ref = A.attention_bwd_int8_reference(q, k, v, o, lse, do, n_real)
    tiled = A.attention_bwd_int8_tiled_reference(q, k, v, o, lse, do, n_real)
    torch.cuda.synchronize()
    assert (A.attention_bwd_int8.launches,
            A.attention_bwd_int8_mma.launches) == (before[0] + 2,
                                                   before[1] + 1)
    assert all(torch.equal(a, z) for a, z in zip(got, again))
    assert _k7_ok(got, ref) and _k7_ok(got, tiled) and _k7_ok(ctrl, ref)
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


def test_k7_wgmma_check_refuses_the_dq_drop(cuda_device, tmp_path):
    """The wgmma K7 built with key tile 1's bulk dq adds dropped (a copy of
    csrc/ in a temporary directory): dq misses keys 128..255 of every head,
    and the check that holds the sound kernel to plain refuses it. The copy
    runs in a process of its own (as the other planted faults). Run with
    -s to see the gap."""
    import json
    import shutil
    import subprocess
    import sys

    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops import attention as A

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "attn_bwd_q8_wgmma.cuh"
    text = header.read_text()
    old = ("          bulk_add_s32(dq_acc + (static_cast<long long>(bh) * n_pad"
           " + it * QW_BQ) * 64,")
    assert text.count(old) == 1
    header.write_text(text.replace(old, "          if (kb != 1) " + old[10:]))
    lib = tmp_path / "attention_bwd_q8.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / "attention_bwd_q8.cu")], check=True,
                   capture_output=True)
    make = ("x = torch.from_numpy(np.random.default_rng(97).standard_normal("
            "(2, 866, 4, 12, 64)).astype(np.float32) * 0.5).cuda().bfloat16()\n"
            "q, k, v, do = x.unbind(2)\n"
            "o, lse = A.flash_attention_fwd_lse(q, k, v)\n")
    scope = {}
    exec("import numpy as np, torch\n"
         "from maest_tpu_torch.ops import attention as A\n" + make, scope)
    args = [scope[n] for n in ("q", "k", "v", "o", "lse", "do")]
    sound = _k7_ok(A.attention_bwd_int8(*args),
                   A.attention_bwd_int8_reference(*args))
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(_build.CSRC.parents[1])!r})\n"
        "import numpy as np\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        f"_build._libs['attention_bwd_q8'] = ctypes.CDLL({str(lib)!r})\n"
        + make +
        "bad = A.attention_bwd_int8(q, k, v, o, lse, do)\n"
        "ref = A.attention_bwd_int8_reference(q, k, v, o, lse, do)\n"
        "print(json.dumps([((a.float() - r.float()).abs().max() / r.float()"
        ".abs().max()).item() for a, r in zip(bad, ref)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    gap = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"planted: the wgmma K7 without key tile 1's dq adds: max|grad - "
          f"plain| / max|plain| dq {gap[0]:.4g}, dk {gap[1]:.4g}, dv "
          f"{gap[2]:.4g} against the bound {K7_TOL} (sound passes: {sound})")
    assert sound and gap[0] > K7_TOL


def test_k7_control_hook_routes_a_training_step(cuda_device, monkeypatch):
    """The private hook that lets a measurement time the model's training
    steps with K7's control: with it set, the int8 backward in bf16 at
    head_dim 64 launches the mma.sync kernels (counted in
    attention_bwd_int8_mma) and not the wgmma ones, and every parameter's
    gradient stays within 1e-2 of its largest |g| (at least 1e-2 of the
    largest of all) of the wgmma route's."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops import attention as A

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=128, depth=2,
                       num_heads=2, input_t=206, n_classes=16,
                       attention_bwd_quant="int8")
    net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                   device=cuda_device,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # zero heads would hide every difference
        net.head[1].weight.copy_(_rand((16, 128), 16, 0.2))
    x = _rand((2, 1, 96, 206), 17).to(cuda_device)
    grads = {}
    for control in (False, True):
        monkeypatch.setattr(A, "_K7_CONTROL", control)
        net.zero_grad()
        before = (A.attention_bwd_int8.launches,
                  A.attention_bwd_int8_mma.launches)
        net(x, train=True, generator=torch.Generator().manual_seed(0))[
            0].float().square().sum().backward()
        torch.cuda.synchronize()
        grew = (A.attention_bwd_int8.launches - before[0],
                A.attention_bwd_int8_mma.launches - before[1])
        assert grew == ((0, cfg.depth) if control else (cfg.depth, 0))
        grads[control] = {k: p.grad.detach().clone()
                          for k, p in net.named_parameters()
                          if p.grad is not None}
    big = max(g.abs().max().item() for g in grads[False].values())
    for k, g in grads[False].items():
        top = max(g.abs().max().item(), 1e-2 * big)
        assert (grads[True][k] - g).abs().max().item() <= 1e-2 * top, k


# --- P4: the backward rig's kernels (ops/bwd_probe.py) ----------------------
@pytest.mark.parametrize("kind", ["ctrl", "int8", "fp8"])
def test_bwd_rig_kernels_match_plain(cuda_device, kind):
    """Each kind at the rig's N_PAD 896 and 2 heads against its plain
    version, launched once: int8 by int8_gap (the plain codes against the
    codes on the kernel's own delta, counted; its outputs equal to those
    codes'), fp8 by fp8_gap and ctrl by ctrl_gap (2 bf16 ulps of each
    output's max)."""
    from maest_tpu_torch.ops import bwd_probe as P
    from maest_tpu_torch.probes import bwd_int8

    ops = bwd_int8.operands(kind, cuda_device, 1, 2)
    before = P.bwd_probe.launches[kind]
    out = P.bwd_probe(*ops, kind)
    ref = P.bwd_probe_reference(*ops, kind)
    torch.cuda.synchronize()
    assert P.bwd_probe.launches[kind] == before + 1
    assert [(t.shape, t.dtype) for t in out] == [(t.shape, t.dtype)
                                                 for t in ref]
    if kind == "int8":
        alt = P.int8_codes(*ops, delta=P.bwd_pass(*ops, kind)[-1])
        gap = P.int8_gap(out, ref, P.int8_codes(*ops), alt)
        assert gap["ok"], gap
        for a, b in zip(out, P.int8_outputs(ops[0], ops[1], ops[3], *alt)):
            assert torch.equal(a, b)
    elif kind == "fp8":
        gap = P.fp8_gap(out, ref)
        assert gap["ok"], gap
    else:
        gap = P.ctrl_gap(out, ref)
        assert gap["ok"], gap
    q, kt, v, do, o, lse = ops
    kt = kt[..., :32] if kind == "ctrl" else kt[:, :32]
    with pytest.raises(ValueError, match="head_dim 64"):
        P.bwd_probe(q[..., :32], kt, v[..., :32], do[..., :32], o[..., :32],
                    lse, kind)


def test_bwd_rig_check_refuses_planted_to_s8(cuda_device, tmp_path,
                                            monkeypatch):
    """int8_gap refuses the int8 kind built with the wrapping to_s8 in
    place of the saturating conversion (a copy of csrc/ in a temporary
    directory): ds8 leaves the int8 range at the rig's inputs. Run with -s
    to see the gap."""
    import ctypes
    import shutil
    import subprocess

    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops import bwd_probe as P
    from maest_tpu_torch.probes import bwd_int8

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    source = src / "attention_bwd_q8.cu"
    text = source.read_text()
    old = "    return to_s8_sat(x);"
    assert text.count(old) == 1
    source.write_text(text.replace(old, "    return to_s8(x);"))
    lib = tmp_path / "attention_bwd_q8.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(source)], check=True, capture_output=True)
    ops = bwd_int8.operands("int8", cuda_device, 1, 2)
    ref = P.bwd_probe_reference(*ops, "int8")
    codes = P.int8_codes(*ops)
    monkeypatch.setitem(_build._libs, "attention_bwd_q8", ctypes.CDLL(str(lib)))
    made = P.bwd_pass(*ops, "int8")
    gap = P.int8_gap(P.launch_pass(made, "int8"), ref, codes,
                     P.int8_codes(*ops, delta=made[-1]))
    print(f"planted: int8 with to_s8 (wrapping) for ds8: max|out - plain| "
          f"{max(gap['err'].values()):.4g}: "
          f"{'within' if gap['ok'] else 'refused'}")
    assert not gap["ok"]


def test_bwd_rig_on_the_card(cuda_device, capsys):
    from maest_tpu_torch.probes import bwd_int8

    res = bwd_int8.main(["--iters", "2", "--rounds", "2"])
    assert set(res) == {"ctrl", "int8", "fp8"}
    assert all(r["ms"] > 0 and r["alone_ms"] > 0 for r in res.values())
    assert res["ctrl"]["library_ms"] > 0 and res["int8"]["library_ms"] is None
    out = capsys.readouterr().out
    assert "not gradients" in out and "20 % gate" in out


# --- P1 and P8: the product kernel (ops/mma_probe.py) -----------------------
# the wgmma kernel (the route) and its mma.sync control against the plain
# versions at the rigs' shapes, two programs: 2 bf16 ulps of max|out| (both
# sum exact products in fp32, in other orders, and round once to bf16; the
# wgmma kernel's e4m3 sums keep fewer bits within 128 values of K, then add
# into fp32) and a relative L2 of at most 1e-2, in e4m3 at most 7.5e-4
# (chip_smoke.py's MMA_E4M3_REL_L2: e4m3 sums kept on the tensor core
# across the stages exceed it).
MMA_ULPS, MMA_REL_L2, MMA_E4M3_REL_L2 = 2, 1e-2, 7.5e-4


def _mma_close(out, ref, rel=MMA_REL_L2):
    ref = ref.float()
    top = ref.abs().max().item()
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() <= MMA_ULPS * 2.0 ** (
        math.floor(math.log2(top)) - 7)
    assert ((out.float() - ref).norm() / ref.norm()).item() <= rel


@pytest.mark.parametrize("route", ["wgmma", "control"])
@pytest.mark.parametrize("kind", ["k64", "k64w", "pv", "pvwide", "ctrl",
                                  "ctrlbig", "k64big", "pvbig"])
def test_mxu_kernel_matches_plain(cuda_device, kind, route):
    from maest_tpu_torch.ops import mma_probe as M
    from maest_tpu_torch.probes import mxu

    a, b = mxu.operands(kind, 2, cuda_device)
    wrap = M.mxu_probe if route == "wgmma" else M.mxu_probe_mma
    before = (M.mxu_probe.launches, M.mxu_probe_mma.launches)
    out = wrap(a, b, kind)
    torch.cuda.synchronize()
    assert (M.mxu_probe.launches - before[0],
            M.mxu_probe_mma.launches - before[1]) == (
        (1, 0) if route == "wgmma" else (0, 1))
    _mma_close(out, M.mxu_probe_reference(a, b, kind))


@pytest.mark.parametrize("route", ["wgmma", "control"])
@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("shape", ["fc1", "fc2", "qkv"])
def test_mlp_kernel_matches_plain(cuda_device, shape, dtype, route):
    from maest_tpu_torch.ops import mma_probe as M
    from maest_tpu_torch.probes import fp8_mlp

    a, b = fp8_mlp.operands(shape, dtype, 2, cuda_device)
    wrap = M.mlp_probe if route == "wgmma" else M.mlp_probe_mma
    before = (M.mlp_probe.launches, M.mlp_probe_mma.launches)
    typed = (wrap.launches_bf16, wrap.launches_e4m3)
    out = wrap(a, b)
    torch.cuda.synchronize()
    assert (M.mlp_probe.launches - before[0],
            M.mlp_probe_mma.launches - before[1]) == (
        (1, 0) if route == "wgmma" else (0, 1))
    assert (wrap.launches_bf16 - typed[0], wrap.launches_e4m3 - typed[1]) == (
        (1, 0) if dtype == "bf16" else (0, 1))
    _mma_close(out, M.mlp_probe_reference(a, b),
               MMA_E4M3_REL_L2 if dtype == "fp8" else MMA_REL_L2)
    # a row-major e4m3 b is copied into the kernels' layout: the same result
    if dtype == "fp8":
        assert torch.equal(wrap(a, b.contiguous()), out)


def test_mma_wrappers_count_by_route_and_type(cuda_device):
    """Each product wrapper counts only its own launches: ``mxu_probe`` and
    ``mlp_probe`` the wgmma kernel's, ``mxu_probe_mma`` and
    ``mlp_probe_mma`` the control's, and the P8 wrappers each operand type
    apart (the kernels line prints the e4m3 row's own count)."""
    from maest_tpu_torch.ops import mma_probe as M
    from maest_tpu_torch.probes import fp8_mlp, mxu

    def counts():
        return [M.mxu_probe.launches, M.mxu_probe_mma.launches] + [
            getattr(f, c) for f in (M.mlp_probe, M.mlp_probe_mma)
            for c in ("launches", "launches_bf16", "launches_e4m3")]

    a, b = mxu.operands("k64", 2, cuda_device)
    a8, b8 = fp8_mlp.operands("qkv", "fp8", 2, cuda_device)
    a16, b16 = fp8_mlp.operands("qkv", "bf16", 2, cuda_device)
    before = counts()
    M.mxu_probe(a, b, "k64")
    M.mlp_probe(a8, b8)
    M.mlp_probe(a8, b8)
    M.mlp_probe_mma(a16, b16)
    torch.cuda.synchronize()
    assert [x - y for x, y in zip(counts(), before)] == [
        1, 0, 2, 0, 2, 1, 1, 0]


def test_mma_kernel_refuses_what_it_has_no_instance_of(cuda_device):
    from maest_tpu_torch.ops import mma_probe as M
    from maest_tpu_torch.ops.mma_probe import mlp_probe, mxu_probe

    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    a = torch.zeros(1, 100, 64, **bf)
    b = torch.zeros(1, 64, 256, **bf)
    with pytest.raises(ValueError, match="multiple of 128"):
        mxu_probe(a, b, "k64w")
    with pytest.raises(ValueError, match="fold of 1, 7, 56"):
        mxu_probe(torch.zeros(1, 128, 64, **bf),
                  torch.zeros(1, 64, 3 * 256, **bf), "k64")
    with pytest.raises(ValueError, match="K of 64"):
        mlp_probe(torch.zeros(2, 128, 96, device=cuda_device).to(
            torch.float8_e4m3fn), torch.zeros(96, 128, device=cuda_device).to(
            torch.float8_e4m3fn))
    # the wgmma kernel's own tiles: 256 bf16 columns, K of at most 256
    # over a fold, 128 e4m3 columns; the control takes the first two
    with pytest.raises(ValueError, match="output columns of 256"):
        mxu_probe(torch.zeros(1, 128, 64, **bf),
                  torch.zeros(1, 64, 384, **bf), "k64w")
    with pytest.raises(ValueError, match="at most 256"):
        mxu_probe(torch.zeros(1, 128, 320, **bf),
                  torch.zeros(1, 320, 7 * 256, **bf), "ctrl")
    with pytest.raises(ValueError, match="output columns of 128"):
        mlp_probe(torch.zeros(2, 128, 128, device=cuda_device).to(
            torch.float8_e4m3fn), torch.zeros(128, 192, device=cuda_device).to(
            torch.float8_e4m3fn))
    assert M.mxu_probe_mma(torch.zeros(1, 128, 64, **bf),
                           torch.zeros(1, 64, 384, **bf), "k64w").shape == (
        1, 128, 384)
    # the library refuses what the wrappers would have: a shape or an
    # instance it has no kernel of (cudaErrorInvalidValue, raised)
    out = torch.empty(1, 128, 384, **bf)
    with pytest.raises(RuntimeError, match="CUDA error"):
        M._run_entry("maest_mma_probe_wgmma", M.BF16, 128, 1,
                     torch.zeros(1, 128, 64, **bf),
                     torch.zeros(1, 64, 384, **bf), out, 64 * 384)


def test_mma_rigs_on_the_card(cuda_device, capsys):
    from maest_tpu_torch.probes import fp8_mlp, mxu

    res = mxu.main(["--programs", "4", "--iters", "2", "--kinds",
                    "k64,pv,k64big"])
    assert all(r["ms"] > 0 and r["tflops"] > 0 for r in res.values())
    assert set(res) == {"k64", "pv", "k64big", "library_k64big"}
    assert all(res[k]["control_ms"] > 0 and len(res[k]["rounds"]["wgmma"])
               == 2 for k in ("k64", "pv", "k64big"))
    res = fp8_mlp.main(["--programs", "2", "--iters", "2"])
    assert {"library_fc1_bf16", "library_fc1_fp8"} <= set(res)
    assert all(res[f"{s}_{d}"]["control_ms"] > 0 for s in fp8_mlp.SHAPES
               for d in fp8_mlp.DTYPES)
    out = capsys.readouterr().out
    assert "TFLOP/s" in out and "torch._scaled_mm" in out


# --- P2 and P3: the int8 product rigs (ops/int8_probe.py) -------------------
# every kind's kernel against its plain version at the rigs' N with two
# programs, within ops/int8_probe.py plain_gap's bound: exact for int32
# outputs, one p8 a row one apart for mix_i8, 1 (k64_i8q) or 2 bf16 ulps of
# max|out| for the rest, and relative L2 1e-2 for the bf16 and e4m3 kinds.
def _int8_kinds():
    from maest_tpu_torch.ops.int8_probe import P2_KINDS, P3_KINDS
    return [(k, "p2") for k in P2_KINDS] + [(k, "p3") for k in P3_KINDS]


@pytest.mark.parametrize("kind,rig", _int8_kinds())
def test_int8_rig_kernels_match_plain(cuda_device, kind, rig):
    from maest_tpu_torch.ops import int8_probe as I
    from maest_tpu_torch.probes import int8, int8_2

    mod, wrap, ref_fn = ((int8, I.int8_probe, I.int8_probe_reference)
                         if rig == "p2" else
                         (int8_2, I.int8_big_probe,
                          I.int8_big_probe_reference))
    a, b = int8.operands(kind, 2, cuda_device, mod.shapes)
    before = wrap.launches
    out = wrap(a, b, kind)
    ref = ref_fn(a, b, kind)
    torch.cuda.synchronize()
    assert wrap.launches == before + 1
    assert out.shape == ref.shape and out.dtype == I.out_dtype(kind)
    err, tol, ok = I.plain_gap(kind, out, ref)
    assert ok, (kind, err, tol)
    if kind == "k64_i8q":  # the maxima the codes were taken with
        _, amax = I.launch_i8q(a, b)
        want = torch.stack([a.float().abs().amax(dim=(1, 2)),
                            b.float().abs().amax(dim=(1, 2))], dim=1)
        assert torch.equal(amax, want)


def test_int8_checks_refuse_planted_faults(cuda_device, tmp_path,
                                           monkeypatch):
    """plain_gap refuses k64big_i8 with one of its 56 column blocks
    skipped (b's block 13 zeroed, as a kernel that skipped it) and mix_i8
    built with the wrapping to_s8 in place of the saturating conversion
    (a copy of csrc/ in a temporary directory). Run with -s to see the
    gaps."""
    import ctypes
    import shutil
    import subprocess

    from maest_tpu_torch.ops import _build
    from maest_tpu_torch.ops import int8_probe as I
    from maest_tpu_torch.probes import int8, int8_2

    a, b = int8.operands("k64big_i8", 2, cuda_device, int8_2.shapes)
    skipped = b.clone()
    skipped[..., 13 * 256:14 * 256] = 0
    err, tol, ok = I.plain_gap("k64big_i8", I.int8_big_probe(a, skipped,
                                                             "k64big_i8"),
                               I.int8_big_probe_reference(a, b, "k64big_i8"))
    print(f"planted: k64big_i8 block 13 of 56 skipped: max|out - plain| "
          f"{err:.0f} (bound {tol:.0f}): {'within' if ok else 'refused'}")
    assert not ok
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "attn_fwd_q8.cuh"
    text = header.read_text()
    old = "x[nn][e] = to_s8_sat(__fmul_rn(pv, 127.f));"
    assert text.count(old) == 1
    header.write_text(text.replace(old, "x[nn][e] = to_s8(__fmul_rn(pv, "
                                        "127.f));"))
    lib = tmp_path / "attention_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / "attention_probe.cu")], check=True,
                   capture_output=True)
    monkeypatch.setitem(_build._libs, "attention_probe", ctypes.CDLL(str(lib)))
    a, b = int8.operands("mix_i8", 2, cuda_device)
    err, tol, ok = I.plain_gap("mix_i8", I.int8_probe(a, b, "mix_i8"),
                               I.int8_probe_reference(a, b, "mix_i8"))
    print(f"planted: mix_i8 with to_s8 (wrapping) for p8: max|out - plain| "
          f"{err:.0f} (bound {tol:.0f}): {'within' if ok else 'refused'}")
    assert not ok


def test_int8_rigs_on_the_card(cuda_device, capsys):
    from maest_tpu_torch.probes import int8, int8_2

    res = int8.main(["--programs", "2", "--iters", "2"])
    assert all(r["ms"] > 0 and r["alone_ms"] > 0 for r in res.values())
    assert 0 < res["mix_i8"]["saturated"] < 1
    res = int8_2.main(["--programs", "2", "--iters", "2"])
    assert res["k64big_i8cvt"]["library_ms"] is None
    out = capsys.readouterr().out
    assert "torch._int_mm" in out and "torch._scaled_mm" in out


# --- P9 and P7: K2 and K3b at other tiles (ops/attention_probe.py) ----------
# forwards against their plain versions (the key tile's walk) within 2 bf16
# ulps of max|o|, and equal to K2 / K3a where their arithmetic is K2's;
# backward tiles within K3b's bf16 bound, (64, 64) equal to K3b.
@pytest.mark.parametrize("b,n", [(2, 281), (4, 272), (2, 1676)])
def test_qpad_and_tiles_match_plain_and_k2(cuda_device, b, n):
    from maest_tpu_torch.ops import attention_probe as P

    from maest_tpu_torch.ops.attention import attention_fwd_mma

    x = _rand((b, n, 3, 12, 64), 31).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    # K2 and K3a's mma.sync kernel, the template qpad and the tiles change
    # (the wgmma kernel's control)
    k2 = attention_fwd_mma(q, k, v)[0]
    k3a = attention_fwd_mma(q, k, v, with_lse=True)
    for g in P.QPAD_GROUPS:
        if b * 12 % g:
            continue
        before = P.attention_probe_qpad.launches[g]
        o = P.attention_probe_qpad(q, k, v, g)[0]
        ol, lse = P.attention_probe_qpad(q, k, v, g, with_lse=True)
        torch.cuda.synchronize()
        assert P.attention_probe_qpad.launches[g] == before + 2
        assert torch.equal(o, k2) and torch.equal(ol, k3a[0])
        assert torch.equal(lse, k3a[1]), g
    for kt in P.KEY_TILES:
        r, rl = P.attention_probe_tile_reference(q, k, v, 128, kt, True)
        top = r.float().abs().max().item()
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        for qr in P.Q_ROWS:
            before = P.attention_probe_tile.launches[(qr, kt)]
            o, lse = P.attention_probe_tile(q, k, v, qr, kt, True)
            torch.cuda.synchronize()
            assert P.attention_probe_tile.launches[(qr, kt)] == before + 1
            assert (o.float() - r.float()).abs().max().item() <= tol
            assert (lse - rl).abs().max().item() <= LSE_TOL
            if kt == 64:
                assert torch.equal(o, k2) and torch.equal(lse, k3a[1])


@pytest.mark.parametrize("b,n", [(2, 281), (2, 866)])
def test_bwd_tiles_match_plain_and_k3b(cuda_device, b, n):
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.ops import attention_probe as P

    x = _rand((b, n, 4, 12, 64), 32).to(cuda_device, torch.bfloat16)
    q, k, v, g = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    o, lse = flash_attention_fwd_lse(q, k, v)
    # K3b's mma.sync kernels, whose tiles these are (the wgmma backward's
    # control)
    k3b = A.attention_bwd_mma(q, k, v, o, lse, g)
    ref = attention_bwd_reference(q, k, v, o, lse, g)
    for rows in P.BWD_TILES:
        for tile in P.BWD_TILES:
            before = P.attention_bwd_tile.launches[(rows, tile)]
            got = P.attention_bwd_tile(q, k, v, o, lse, g, rows, tile)
            torch.cuda.synchronize()
            assert P.attention_bwd_tile.launches[(rows, tile)] == before + 1
            for ours, want in zip(got, ref):
                err = (ours.float() - want.float()).abs().max().item()
                assert err <= ATTN_TOL[torch.bfloat16], (rows, tile, err)
            # a tile moves a warp's rows between blocks, not its sums
            assert all(torch.equal(a, r) for a, r in zip(got, k3b)), (
                rows, tile)


def test_tune_rigs_on_the_card(cuda_device, capsys):
    """Both rigs at a small size, each line with its time and control."""
    from maest_tpu_torch.probes import attn_tune, qpad

    out = qpad.main(["--shapes", "2x281", "--iters", "3"])
    assert all(ms > 0 for k, ms in out["2x281"].items() if k != "max_err")
    fwd = attn_tune.main(["--archs", "5s", "--batch", "2", "--heads", "2",
                          "--iters", "3"])
    bwd = attn_tune.main(["--archs", "5s", "--batch", "2", "--heads", "2",
                          "--iters", "3", "--bwd"])
    assert len(fwd["5s"]) == len(bwd["5s"]) == 10
    runs = [*fwd["5s"].values(), *bwd["5s"].values()]
    assert all(len(r) == attn_tune.ROUNDS and min(r) > 0 for r in runs)
    text = capsys.readouterr().out
    assert "each equal to K2" in text and "% of 989" in text


# --- fp32 K2/K3a and K3b/K4 on tf32 wgmma (csrc/attn_*_tf32.cuh) -------------
# Against plain at the fp32 tier's bounds (2e-5, lse 1e-4), masked dk/dv
# exactly zero, two backward launches bit-equal; the scalar FMA controls
# within the same bounds.
TF32_FWD_SHAPES = [(2, 1676, None), (2, 1792, 1676), (4, 866, None),
                   (8, 281, None), (1, 4500, 4400)]
TF32_BWD_SHAPES = [(2, 866, None), (2, 896, 866), (8, 281, None),
                   (1, 4500, 4400)]


@pytest.mark.parametrize("b,n,n_real", TF32_FWD_SHAPES)
def test_tf32_forward_matches_plain_and_control(cuda_device, b, n, n_real):
    """fp32 K2 and K3a (the tf32 kernel, each call counted) on strided views
    of one fused q/k/v: o within 2e-5 of attention_reference_lse, lse
    within 1e-4, K2's o torch.equal to K3a's; the scalar FMA control
    (attention_fwd_fp32_fma) within the same bounds."""
    from maest_tpu_torch.ops.attention import attention_fwd_fp32_fma

    x = _rand((b, n, 3, 12, 64), 120 + n).to(cuda_device)
    q, k, v = x.unbind(2)
    before = (flash_attention.launches, flash_attention_fwd_lse.launches)
    o2 = flash_attention(q, k, v, n_real)
    o, lse = flash_attention_fwd_lse(q, k, v, n_real)
    co, cl = attention_fwd_fp32_fma(q, k, v, n_real, with_lse=True)
    ro, rl = attention_reference_lse(q, k, v, n_real)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_fwd_lse.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(o2, o)
    for out, out_lse in ((o, lse), (co, cl)):
        assert (out - ro).abs().max().item() <= ATTN_TOL[torch.float32]
        assert (out_lse - rl).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,n,n_real", TF32_BWD_SHAPES)
def test_tf32_backward_matches_plain_and_control(cuda_device, b, n, n_real):
    """fp32 K3b/K4 (the tf32 kernels, through attention_bwd, each call
    counted) on strided views of one fused q/k/v/do: within 2e-5 of
    attention_bwd_reference, masked dk/dv exactly zero, two launches
    torch.equal; the scalar FMA control within the same bound."""
    from maest_tpu_torch.ops.attention import attention_bwd_fp32_fma

    x = _rand((b, n, 4, 12, 64), 130 + n).to(cuda_device)
    q, k, v, do = x.unbind(2)
    o, lse = attention_reference_lse(q, k, v, n_real)
    before = attention_bwd.launches
    got = attention_bwd(q, k, v, o, lse, do, n_real)
    again = attention_bwd(q, k, v, o, lse, do, n_real)
    ctrl = attention_bwd_fp32_fma(q, k, v, o, lse, do, n_real)
    ref = attention_bwd_reference(q, k, v, o, lse, do, n_real)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 2
    assert all(torch.equal(a, z) for a, z in zip(got, again))
    tol = ATTN_TOL[torch.float32]
    assert _bwd_gap(got, ref) <= tol and _bwd_gap(ctrl, ref) <= tol
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


def test_tf32_checks_refuse_one_product(cuda_device, tmp_path):
    """The tf32 kernels built with one tf32 product (TF_3X false, a copy of
    csrc/ in a temporary directory): the checks that hold the sound kernels
    to plain at 2e-5 refuse the forward and the backward so built. The
    copies run in a process of their own (a second library of a launched
    kernel misses its shared-memory setting). Run with -s to see the
    gaps."""
    import json
    import shutil
    import subprocess
    import sys

    from maest_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "tf32_wgmma.cuh"
    text = header.read_text()
    old = "constexpr bool TF_3X = true;"
    assert text.count(old) == 1
    header.write_text(text.replace(old, "constexpr bool TF_3X = false;"))
    libs = {}
    for lib in ("attention_fwd", "attention_bwd"):
        libs[lib] = tmp_path / f"{lib}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(libs[lib]), str(src / f"{lib}.cu")], check=True,
                       capture_output=True)
    make = ("x = torch.from_numpy(np.random.default_rng(132).standard_normal("
            "(2, 1000, 4, 12, 64)).astype(np.float32)).cuda()\n"
            "q, k, v, do = x.unbind(2)\n"
            "ro, rl = A.attention_reference_lse(q, k, v, 997)\n")
    scope = {}
    exec("import numpy as np, torch\n"
         "from maest_tpu_torch.ops import attention as A\n" + make, scope)
    q, k, v, do, ro, rl = (scope[n] for n in ("q", "k", "v", "do", "ro", "rl"))
    sound = ((flash_attention(q, k, v, 997) - ro).abs().max().item(),
             _bwd_gap(attention_bwd(q, k, v, ro, rl, do, 997),
                      attention_bwd_reference(q, k, v, ro, rl, do, 997)))
    code = (
        "import ctypes, json, sys, torch\n"
        f"sys.path.insert(0, {str(_build.CSRC.parents[1])!r})\n"
        "import numpy as np\n"
        "from maest_tpu_torch.ops import _build, attention as A\n"
        + "".join(f"_build._libs[{lib!r}] = ctypes.CDLL({str(path)!r})\n"
                  for lib, path in libs.items())
        + make +
        "o = A.flash_attention(q, k, v, 997)\n"
        "g = A.attention_bwd(q, k, v, ro, rl, do, 997)\n"
        "r = A.attention_bwd_reference(q, k, v, ro, rl, do, 997)\n"
        "print(json.dumps([(o - ro).abs().max().item(), max((a - b).abs()"
        ".max().item() for a, b in zip(g, r))]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    fwd, bwd = json.loads(proc.stdout.strip().splitlines()[-1])
    tol = ATTN_TOL[torch.float32]
    print(f"planted: the tf32 kernels with one tf32 product: forward "
          f"max|o - plain| {fwd:.4g}, backward max|grads - plain| {bwd:.4g} "
          f"against the bound {tol} (sound {sound[0]:.4g}, {sound[1]:.4g})")
    assert max(sound) <= tol < min(fwd, bwd)


def test_f32_control_hook_routes_a_training_step(cuda_device, monkeypatch):
    """The private hook that lets a measurement time the model's fp32 steps
    with the controls: with it set, fp32 at head_dim 64 launches the scalar
    FMA kernels (counted in attention_fwd_fp32_fma and
    attention_bwd_fp32_fma) and not the tf32 ones, and every parameter's
    gradient stays within 1e-4 of its largest |g| (at least 1e-4 of the
    largest of all) of the tf32 route's."""
    from maest_tpu_torch.models.registry import build_config
    from maest_tpu_torch.models.vit import MAESTNet
    from maest_tpu_torch.ops import attention as A

    cfg = build_config("discogs-maest-30s-pw-129e", embed_dim=128, depth=2,
                       num_heads=2, input_t=206, n_classes=16)
    net = MAESTNet(cfg, dtype=torch.float32, param_dtype=torch.float32,
                   device=cuda_device,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # zero heads would hide every difference
        net.head[1].weight.copy_(_rand((16, 128), 16, 0.2))
    x = _rand((2, 1, 96, 206), 17).to(cuda_device)
    counts = (A.flash_attention_fwd_lse, A.attention_bwd,
              A.attention_fwd_fp32_fma, A.attention_bwd_fp32_fma)
    grads = {}
    for control in (False, True):
        monkeypatch.setattr(A, "_F32_CONTROL", control)
        net.zero_grad()
        before = [f.launches for f in counts]
        net(x, train=True, generator=torch.Generator().manual_seed(0))[
            0].float().square().sum().backward()
        torch.cuda.synchronize()
        grew = tuple(f.launches - b for f, b in zip(counts, before))
        d = cfg.depth
        assert grew == ((0, 0, d, d) if control else (d, d, 0, 0))
        grads[control] = {k: p.grad.detach().clone()
                          for k, p in net.named_parameters()
                          if p.grad is not None}
    big = max(g.abs().max().item() for g in grads[False].values())
    for k, g in grads[False].items():
        top = max(g.abs().max().item(), 1e-4 * big)
        assert (grads[True][k] - g).abs().max().item() <= 1e-4 * top, k


def test_device_prefetch_pins_and_copies_on_a_side_stream(cuda_device,
                                                          monkeypatch):
    """Every array under ``keys`` is pinned and copied to the card; what
    the consumer reads on its own stream, with no explicit synchronize,
    equals the input; host entries pass through."""
    from maest_tpu_torch.data import device_prefetch

    pinned = []
    pin = torch.Tensor.pin_memory

    def spy(self, *a, **k):
        out = pin(self, *a, **k)
        pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((12, 96, 625)).astype("float16"),
                "y": (rng.random((12, 400)) < 0.1).astype("float16"),
                "filename": [f"f{i}_{j}" for j in range(12)], "_n": 12}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), cuda_device))
    assert pinned == [True] * 10
    for a, b in zip(out, batches):
        assert a["filename"] == b["filename"] and a["_n"] == 12
        for k in ("x", "y"):
            assert a[k].device.type == "cuda" and a[k].dtype == torch.float16
            np.testing.assert_array_equal(a[k].cpu().numpy(), b[k])


def test_tiny_trainer_epoch_on_the_card(cuda_device, tmp_path):
    """One epoch of a tiny model in bf16 through ``Trainer(device="cuda")``
    on a synthetic corpus: the run completes, its metrics are finite, the
    train step launched K3a and K3b once a block and the eval K2."""
    import json
    import pickle

    from maest_tpu_torch import configs
    from maest_tpu_torch.ops import attention as A
    from maest_tpu_torch.train import Trainer

    rng = np.random.default_rng(0)
    gt = {}
    for i in range(8):
        (rng.standard_normal((62 + 20 * i, 96)) + 2.0).astype(
            "float16").tofile(tmp_path / f"c{i}.mmap")
        gt[f"c{i}.mmap"] = (np.arange(8) % 8 == i).astype("float16")
    for split in ("train", "val"):
        with open(tmp_path / f"gt_{split}.pk", "wb") as f:
            pickle.dump(gt, f)
    cfg = configs.build_experiment_config([], [
        f"datamodule.base_dir='{tmp_path}'",
        f"datamodule.groundtruth_train='{tmp_path}/gt_train.pk'",
        f"datamodule.groundtruth_val='{tmp_path}/gt_val.pk'",
        "datamodule.clip_length=1", "datamodule.batch_size_train=2",
        "datamodule.batch_size_test=4", "datamodule.sampler.epoch_len=8",
        "maest.input_t=62", "maest.embed_dim=128", "maest.depth=2",
        "maest.num_heads=2", "maest.n_classes=8", "maest.s_patchout_t=1",
        "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
        "module.swa_epoch_start=0",
        f"trainer.default_root_dir='{tmp_path}/runs'"])
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda" and trainer.dtype == torch.bfloat16
    counts = (A.flash_attention, A.flash_attention_fwd_lse, A.attention_bwd)
    before = [f.launches for f in counts]
    assert trainer.fit() == {"done": True}
    grew = [f.launches - b for f, b in zip(counts, before)]
    assert grew == [2 * 2 * 2, 2 * 4, 2 * 4]  # 2 val batches x live + SWA
    lines = [json.loads(s) for s in
             (trainer.run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [m["value"] for m in lines if m["name"] == "train_loss"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert {m["name"] for m in lines} >= {"val_loss", "val_ap", "val_roc",
                                          "val_loss_swa"}
    assert all(np.isfinite(m["value"]) for m in lines
               if m["name"].startswith("val_loss"))
    record = json.loads((trainer.run_dir / "run.json").read_text())
    assert record["status"] == "COMPLETED"


# --- serving on CUDA graphs: one graph per bucket and family ---------------
# A replay runs the kernels the eager call runs, on the same buffers: held
# to the eager run within the tier's bound (bf16 1e-2, fp32 2e-5; zero is
# expected). The host counters tick once at capture, never on a replay: the
# profiler counts the kernels a replay runs by name.

SERVE_KERNELS = {"K1": r"logmel_fft_kernel", "K1_control": r"logmel_kernel",
                 "K2": r"attn_fwd_wgmma_kernel",
                 "K2_control": r"attn_fwd_bf16_kernel",
                 "K2_fp32": r"attn_fwd_tf32_kernel",
                 "K2_fp32_control": r"attn_fwd_fp32_kernel"}
SERVE_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def _served_model(dtype):
    model = get_maest(device="cuda", dtype=dtype, **TINY)
    with torch.no_grad():
        model.net.head[1].weight.copy_(_rand((16, 128), 1, 0.2))
    return model


def _elements(progs, n, seed):
    x = _rand((n, *progs.elem_shape), seed, 0.3).numpy()
    if progs.pcm16:
        return (np.clip(x, -1, 1) * 32767).astype(np.int16)
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("family", ["chunk", "wave", "pcm16"])
def test_graph_replay_matches_eager(cuda_device, family, dtype):
    from maest_tpu_torch.serve import BucketPrograms, pick_bucket
    from maest_tpu_torch.utils.profiling import KERNEL_TRACES, kernel_launches

    model = _served_model(dtype)
    progs = BucketPrograms(model, (1, 2, 4), fused_wave=family != "chunk",
                           pcm16=family == "pcm16")
    assert progs.graphs
    progs.warmup()
    assert sorted(progs._graphs) == [1, 2, 4]
    k2 = "K2" if dtype == torch.bfloat16 else "K2_fp32"
    want = {k: 0 for k in SERVE_KERNELS}
    want.update(K1=int(family != "chunk"), **{k2: 2})
    for b in progs.buckets:  # each bucket's graph, by the profiler
        batch = _elements(progs, b, 30 + b)
        seen = kernel_launches(lambda: progs.run(batch), SERVE_KERNELS)
        assert {k: seen[k] for k in SERVE_KERNELS} == want, (b, seen)
    traced = 2 * KERNEL_TRACES  # two calls a trace
    assert progs.replays == {1: traced, 2: traced, 4: traced}
    before = flash_attention.launches
    for n in (1, 2, 3, 4):
        batch = _elements(progs, n, 10 + n)
        got = progs.run(batch)
        bucket = pick_bucket(n, progs.buckets)
        padded = np.concatenate([batch, np.zeros(
            (bucket - n, *progs.elem_shape), batch.dtype)])
        want = progs.eager(padded)[:n]
        assert got.shape == (n, 16) and np.isfinite(got).all()
        assert np.abs(got - want).max() <= SERVE_TOL[dtype]
    assert progs.replays == {1: traced + 1, 2: traced + 1, 4: traced + 2}
    # the eager calls tick the counter; the replays did not
    assert flash_attention.launches == before + 2 * 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_graph_replay_runs_k1_and_k2(cuda_device, dtype):
    """A replayed wave batch runs K1 once and K2 once a block (the tf32
    kernel in fp32), and no control, by the profiler's kernel names."""
    from maest_tpu_torch.serve import BucketPrograms
    from maest_tpu_torch.utils.profiling import KERNEL_TRACES, kernel_launches

    progs = BucketPrograms(_served_model(dtype), (2,), fused_wave=True)
    progs.warmup()
    batch = _elements(progs, 2, 20)
    seen = kernel_launches(lambda: progs.run(batch), SERVE_KERNELS)
    k2 = "K2" if dtype == torch.bfloat16 else "K2_fp32"
    want = {k: 0 for k in SERVE_KERNELS}
    want.update(K1=1, **{k2: 2})
    assert {k: seen[k] for k in SERVE_KERNELS} == want, seen
    assert progs.replays == {2: 2 * KERNEL_TRACES}  # two calls a trace


def test_service_captures_on_its_dispatchers(cuda_device):
    """No warmup: each family captures a bucket at its first batch, on its
    own dispatcher thread, while the others run; every answer against
    ``predict_labels``, and each graph holds its own kernels only."""
    import threading

    from maest_tpu_torch.utils.profiling import kernel_launches

    model = _served_model(torch.bfloat16)
    svc = TagService(model, buckets=(1, 2, 4), max_wait_ms=2.0)
    try:
        native = svc.wave_programs.native_len
        reqs = [_rand(native, s, 0.3).numpy() for s in (30, 31, 32)]
        reqs += [(np.clip(r, -1, 1) * 32767).astype(np.int16)
                 for r in reqs[:2]]
        reqs += [_rand(int(2.6 * 16000), 33, 0.3).numpy(),
                 _rand(8000, 34, 0.3).numpy()]
        outs = [None] * len(reqs)

        def worker(i):
            outs[i] = svc.tag(reqs[i], timeout=300)[0]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        for got, x in zip(outs, reqs):
            np.testing.assert_allclose(got, model.predict_labels(x)[0],
                                       atol=1e-2)
        for progs in (svc.wave_programs, svc.pcm16_programs, svc.programs):
            assert progs._graphs and sum(progs.replays.values()) >= 1
            for b in progs._graphs:
                batch = _elements(progs, b, 35 + b)
                seen = kernel_launches(lambda: progs.run(batch),
                                       SERVE_KERNELS)
                want = {k: 0 for k in SERVE_KERNELS}
                want.update(K1=int(progs.fused_wave), K2=2)
                assert {k: seen[k] for k in SERVE_KERNELS} == want, (
                    progs.kind, b, seen)
    finally:
        svc.close()


def test_short_clip_during_a_lazy_capture(cuda_device, monkeypatch):
    """A clip shorter than one window runs eagerly on another thread while
    the wave family captures its bucket at its first batch (no warmup):
    both answers against ``predict_labels``, and the graph holds its own
    kernels only, none of the other thread's."""
    import threading

    from maest_tpu_torch.utils.profiling import kernel_launches

    model = _served_model(torch.bfloat16)
    svc = TagService(model, buckets=(1,), max_wait_ms=0.0)
    progs = svc.wave_programs
    short = _rand(8000, 50, 0.3).numpy()
    native = _rand(progs.native_len, 51, 0.3).numpy()
    got = {}
    run = progs._activations

    def ask_short():
        got["short"] = svc.tag(short, timeout=300)[0]

    def capturing(x):
        if torch.cuda.is_current_stream_capturing() and not got:
            got["during"] = True
            t = threading.Thread(target=ask_short)
            t.start()
            t.join(timeout=300)
        return run(x)

    monkeypatch.setattr(progs, "_activations", capturing)
    try:
        got["native"] = svc.tag(native, timeout=300)[0]
        assert got.get("during") and "short" in got
        assert sorted(progs._graphs) == [1]
        for name, x in (("short", short), ("native", native)):
            np.testing.assert_allclose(got[name], model.predict_labels(x)[0],
                                       atol=1e-2)
        seen = kernel_launches(lambda: progs.run(native[None]),
                               SERVE_KERNELS)
        want = {k: 0 for k in SERVE_KERNELS}
        want.update(K1=1, K2=2)
        assert {k: seen[k] for k in SERVE_KERNELS} == want, seen
    finally:
        svc.close()


def test_failed_capture_raises(cuda_device, monkeypatch):
    """A forward that cannot be captured (a device synchronise inside)
    raises; nothing falls back to an eager run, nothing is kept."""
    from maest_tpu_torch.serve import BucketPrograms

    progs = BucketPrograms(_served_model(torch.bfloat16), (1,))
    run = progs._activations

    def unsafe(x):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return run(x)

    monkeypatch.setattr(progs, "_activations", unsafe)
    with pytest.raises(RuntimeError):
        progs.run(_elements(progs, 1, 40))
    assert progs._graphs == {} and progs.replays == {}
    torch.cuda.synchronize()  # the card goes on
    monkeypatch.setattr(progs, "_activations", run)
    assert progs.run(_elements(progs, 1, 41)).shape == (1, 16)
