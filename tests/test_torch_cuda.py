"""The port's CUDA kernels and its CUDA path, held against the plain
PyTorch versions on the card. Every test needs an NVIDIA GPU and skips
without one. This file imports neither jax nor the JAX package, so it also
runs on a machine without jax (``tests/conftest.py`` imports jax; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: mel 1e-4 (the front-end's fp32 bound); attention fp32 2e-5
(fp32 sums in other orders), bf16 2e-2 compared in fp32 (bf16 rounds the
probabilities and the output at ~4e-3 relative); the fp32 model on the
card against the same model on the CPU rtol 2e-4, atol 2e-5.
"""

import numpy as np
import pytest
import torch

from maest_tpu_torch.api import get_maest
from maest_tpu_torch.dsp.mel import frame_waveforms
from maest_tpu_torch.ops.attention import attention_reference, flash_attention
from maest_tpu_torch.ops.mel_kernel import (
    fused_logmel_from_frames,
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
    x = torch.zeros(1, 8, 3, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2])
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
