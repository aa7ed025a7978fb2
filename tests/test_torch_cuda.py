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
# K5/K6 against attention_q8_reference on the same 64-key tiles and K7
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
    """The CUDA 8-bit kernels take bf16; fp32 with a mode is refused on
    the card (it runs on the CPU, as the JAX package's does)."""
    x = _rand((1, 64, 3, 2, 64), 14).to(cuda_device)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    for mode in Q8_MODES:
        with pytest.raises(NotImplementedError, match="8-bit attention"):
            flash_attention(q, k, v, quant=mode)
    xg = x.detach().requires_grad_(True)
    out = flash_attention(xg[:, :, 0], xg[:, :, 1], xg[:, :, 2],
                          bwd_quant="int8")
    with pytest.raises(NotImplementedError, match="8-bit attention"):
        out.sum().backward()


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
    """The rig's graph times, and bf16s's kernel alone and its pass."""
    from maest_tpu_torch.probes import attn_profile

    out = attn_profile.main(["--batch", "2", "--heads", "2", "--shapes",
                             "200", "--iters", "4", "--variants",
                             "flash,mxu_only,bf16s,plain"])
    rows = out["200"]
    for variant in ("flash", "mxu_only", "bf16s"):
        assert rows[variant]["graph_ms"] > 0
        assert rows[variant]["idle"] == pytest.approx(
            1 - rows[variant]["graph_ms"] / rows[variant]["ms"])
    assert rows["plain"]["graph_ms"] is None
    assert 0 < rows["bf16s"]["kernel_ms"] < rows["bf16s"]["ms"]
    assert 0 < rows["bf16s"]["pass_ms"] < rows["bf16s"]["ms"]
    assert "ms (graphs); its kernel alone" in capsys.readouterr().out


def test_launch_probe_is_the_kernel_alone(cuda_device):
    """launch_probe on a pre-scaled q is attention_probe's bf16s; it
    launches on CUDA tensors only."""
    from maest_tpu_torch.ops.attention_probe import launch_probe, prescale_q

    x = _rand((2, 130, 3, 2, 64), 17).to(cuda_device, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    assert torch.equal(launch_probe(prescale_q(q), k, v, "bf16s"),
                       attention_probe(q, k, v, "bf16s"))
    assert torch.equal(launch_probe(q, k, v, "novmax"),
                       attention_probe(q, k, v, "novmax"))
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        launch_probe(q.cpu(), k.cpu(), v.cpu(), "novmax")
