"""Attention forward and backward of the PyTorch port against the JAX
package's Pallas flash kernels, run in interpret mode on the CPU.

Tolerances: fp32 atol 2e-5 (two fp32 softmax pipelines that sum in other
orders); bf16 atol 2e-2, compared in fp32 (bf16 keeps 8 mantissa bits, so
the probabilities and the output each round at ~4e-3 relative).

On the CPU the port's wrapper runs its plain version;
tests/test_torch_cuda.py holds the kernel to it on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.ops.attention import flash_attention as jax_flash
from maest_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_int8_reference,
    attention_bwd_reference,
    attention_q8_reference,
    attention_reference,
    attention_reference_lse,
    flash_attention,
    flash_attention_fwd_lse,
)

ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(b, n, h, d=64, seed=0):
    """One fused (B, N, 3, H, D) projection; the tests slice q, k, v out of
    it as strided views, the layout the model hands over."""
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3, h, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,n_real", [(200, None), (256, 190)],
                         ids=["n200", "n256_real190"])
def test_matches_jax_flash_interpret(n, n_real, dtype):
    x = _qkv(2, n, 2)
    xt = torch.from_numpy(x).to(dtype)
    ours = flash_attention(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2],
                           n_real=n_real)
    xj = jnp.asarray(x).astype(JNP[dtype])
    ref = jax_flash(xj[:, :, 0], xj[:, :, 1], xj[:, :, 2], n_real=n_real,
                    interpret=True)
    assert ours.shape == (2, n, 2, 64) and ours.dtype == dtype
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[dtype], rtol=0)


def test_masked_keys_get_no_mass():
    """n_real=40 of 64 keys: every query row (padded ones included) sees
    exactly the first 40 keys."""
    x = torch.from_numpy(_qkv(1, 64, 2, seed=1)).double()
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k[:, :40]) / 8.0, -1)
    expect = torch.einsum("bhnm,bmhd->bnhd", p, v[:, :40])
    out = flash_attention(q.float(), k.float(), v.float(), n_real=40)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), atol=2e-6)


def test_api_errors():
    x = torch.from_numpy(_qkv(1, 16, 1))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    # "none" is the config-file spelling of off
    torch.testing.assert_close(flash_attention(q, k, v, quant="none"),
                               flash_attention(q, k, v))
    with pytest.raises(ValueError, match="unknown attention quant"):
        flash_attention(q, k, v, quant="int4")
    # the 8-bit modes run: on the CPU, their plain version
    for mode in ("qk8", "qk8pv8", "fp8", "fp8pv8"):
        torch.testing.assert_close(flash_attention(q, k, v, quant=mode),
                                   attention_q8_reference(q, k, v, None,
                                                          mode)[0],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        flash_attention(q, k, v, n_real=17)
    with pytest.raises(ValueError, match="at least 1"):
        flash_attention(q, k, v, n_real=0)
    with pytest.raises(ValueError, match="one .B, N, H, D. shape"):
        flash_attention(q, k[:, :8], v)


def test_cpu_takes_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_qkv(2, 50, 3))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = flash_attention.launches
    out = flash_attention(q, k, v, n_real=33)
    assert flash_attention.launches == before
    assert torch.equal(out, attention_reference(q, k, v, n_real=33))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_control_takes_plain_version_and_matches_jax(dtype, monkeypatch):
    """``attention_fwd_mma``, the mma.sync kernel kept as the control of
    K2/K3a's wgmma kernel: on the CPU its plain versions, o and lse against
    the JAX package's Pallas kernel in interpret mode (the tolerances
    above; lse fp32 1e-5), no launch counted; the private hook that routes
    the bf16 forward through it on the card leaves the CPU path as it is.
    On the card it takes bf16 at head_dim 64, 128, 256 and the multiples
    of 64 above 256 only (here on meta tensors, which take the card's
    route)."""
    from maest_tpu.ops.attention import _flash_fwd_lse
    from maest_tpu_torch.ops import attention as A

    x = _qkv(2, 256, 2, seed=7)
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    before = (A.attention_fwd_mma.launches, flash_attention.launches)
    o, lse = A.attention_fwd_mma(q, k, v, 190, with_lse=True)
    o2, none = A.attention_fwd_mma(q, k, v, 190)
    assert (A.attention_fwd_mma.launches, flash_attention.launches) == before
    assert none is None
    assert torch.equal(o2, attention_reference(q, k, v, 190))
    assert torch.equal(o, attention_reference_lse(q, k, v, 190)[0])
    monkeypatch.setattr(A, "_K2_CONTROL", True)
    assert torch.equal(flash_attention(q, k, v, n_real=190), o2)
    xj = jnp.asarray(x).astype(JNP[dtype])
    ref, ref_lse = _flash_fwd_lse(xj[:, :, 0], xj[:, :, 1], xj[:, :, 2],
                                  block_q=896, block_k=448, interpret=True,
                                  n_real=190)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(ref_lse).reshape(2, 2, -1)[:, :, :256],
        atol=1e-5, rtol=0)
    for bad in (torch.zeros(1, 8, 2, 64, device="meta"),
                torch.zeros(1, 8, 2, 192, device="meta",
                            dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="bf16 q, k, v at head_dim 64"):
            A.attention_fwd_mma(bad, bad, bad)


def _fwd_recorder(seen):
    def launch(lib_name, name, lead, q, k, v, n_real, with_lse, scale):
        seen.append((name, lead, q.dtype, q.shape[-1]))
        b, n, h, _ = q.shape
        lse = (torch.empty((b, h, n), device=q.device) if with_lse else None)
        return torch.empty_like(q), lse
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_forward_route_names_the_dn_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: bf16 at head_dim 320, 384 and
    1024 (and 300, zero-padded to 320) names ``maest_attn_fwd_bf16_dn``,
    the wgmma kernel, with its width, counted in ``flash_attention`` and
    ``flash_attention_fwd_lse``; with ``_K2_CONTROL`` it names
    ``maest_attn_fwd_bf16_dn_mma``, counted in ``attention_fwd_mma``, as
    head_dim 64 names ``maest_attn_fwd_bf16_mma`` and head_dim 128 (96
    zero-padded too) ``maest_attn_fwd_bf16_d128_mma`` in place of the
    wgmma kernel's ``maest_attn_fwd_bf16_d128`` and head_dim 256
    ``maest_attn_fwd_bf16_d256_mma`` in place of ``maest_attn_fwd_bf16_d256``.
    fp32 keeps its entries either way. ``attention_fwd_mma`` takes head_dim
    128, 256 and the widths above 256 and refuses fp32 and head_dim 192
    (a width the caller pads)."""
    from maest_tpu_torch.ops import attention as A

    seen = []
    monkeypatch.setattr(A, "launch_fwd_entry", _fwd_recorder(seen))
    monkeypatch.setattr(A, "_K2_CONTROL", control)
    counted = (A.flash_attention, A.flash_attention_fwd_lse,
               A.attention_fwd_mma)
    for f in counted:
        monkeypatch.setattr(f, "launches", 0)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = ((bf16, 320), (bf16, 384), (bf16, 1024), (bf16, 300), (bf16, 64),
             (fp32, 384), (bf16, 128), (bf16, 256), (bf16, 96))
    for dtype, d in cases:
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        o = A.flash_attention(x, x, x)
        o2, lse = A.flash_attention_fwd_lse(x, x, x)
        assert o.shape == o2.shape == x.shape and lse.shape == (1, 2, 4)
    sfx = "_mma" if control else ""
    want = {
        (bf16, 320): ("maest_attn_fwd_bf16_dn" + sfx, (320,), 320),
        (bf16, 384): ("maest_attn_fwd_bf16_dn" + sfx, (384,), 384),
        (bf16, 1024): ("maest_attn_fwd_bf16_dn" + sfx, (1024,), 1024),
        (bf16, 300): ("maest_attn_fwd_bf16_dn" + sfx, (320,), 320),
        (bf16, 64): ("maest_attn_fwd_bf16" + sfx, (), 64),
        (fp32, 384): ("maest_attn_fwd_fp32_dn", (384,), 384),
        (bf16, 128): ("maest_attn_fwd_bf16_d128" + sfx, (), 128),
        (bf16, 256): ("maest_attn_fwd_bf16_d256" + sfx, (), 256),
        (bf16, 96): ("maest_attn_fwd_bf16_d128" + sfx, (), 128)}
    assert seen == [(want[c][0], want[c][1], c[0], want[c][2])
                    for c in cases for _ in range(2)]
    assert [f.launches for f in counted] == ([1, 1, 16] if control
                                             else [9, 9, 0])
    seen.clear()
    for d in (128, 256, 384, 1024):
        x = torch.zeros(1, 4, 2, d, dtype=bf16, device="meta")
        assert A.attention_fwd_mma(x, x, x, with_lse=True)[1].shape == (1, 2,
                                                                         4)
    assert seen == [("maest_attn_fwd_bf16_d128_mma", (), bf16, 128),
                    ("maest_attn_fwd_bf16_d256_mma", (), bf16, 256)] + [
        ("maest_attn_fwd_bf16_dn_mma", (d,), bf16, d) for d in (384, 1024)]
    assert A.attention_fwd_mma.launches == (20 if control else 4)
    for bad in (torch.zeros(1, 8, 2, 384, device="meta"),
                torch.zeros(1, 8, 2, 192, device="meta", dtype=bf16)):
        with pytest.raises(ValueError, match="bf16 q, k, v at head_dim 64, "
                           "128, 256 or a multiple of 64 above 256"):
            A.attention_fwd_mma(bad, bad, bad)


# --- training: forward with lse (K3a) and backward (K3b, K4) -------------
# Tolerances, as the JAX package's own (tests/test_flash_attention.py):
# fp32 rtol 1e-3 / atol 1e-4; bf16 2e-2 (absolute and relative), compared
# in fp32.
GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,n_real", [(200, None), (256, 190)],
                         ids=["n200", "n256_real190"])
def test_lse_and_grads_match_jax_flash_interpret(n, n_real, dtype):
    """The port's Function (forward with lse, backward) against the JAX
    custom VJP with its Pallas kernels in interpret mode."""
    import jax

    from maest_tpu.ops.attention import _flash_fwd_lse

    x = _qkv(2, n, 2, seed=3)
    g = np.random.default_rng(4).standard_normal((2, n, 2, 64)).astype("f4")
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = flash_attention(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], n_real=n_real)
    out.backward(torch.from_numpy(g).to(dtype))
    _, lse = flash_attention_fwd_lse(*(xt[:, :, i].detach() for i in range(3)),
                                     n_real=n_real)

    xj = jnp.asarray(x).astype(JNP[dtype])
    q, k, v = xj[:, :, 0], xj[:, :, 1], xj[:, :, 2]
    ref, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, n_real=n_real, interpret=True),
        q, k, v)
    grads = vjp(jnp.asarray(g).astype(JNP[dtype]))
    _, ref_lse = _flash_fwd_lse(q, k, v, block_q=896, block_k=448,
                                interpret=True, n_real=n_real)
    # the TPU lse is (B*H, 1, N_pad): compare its first N rows
    ref_lse = np.asarray(ref_lse).reshape(2, 2, -1)[:, :, :n]
    assert lse.shape == (2, 2, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, **GRAD_TOL[torch.float32])
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **GRAD_TOL[dtype])
    for i in range(3):
        assert xt.grad.dtype == dtype
        np.testing.assert_allclose(xt.grad[:, :, i].float().numpy(),
                                   np.asarray(grads[i].astype(jnp.float32)),
                                   **GRAD_TOL[dtype])
    if n_real is not None:  # masked keys get exactly zero dk / dv
        assert not xt.grad[:, n_real:, 1:].any()


def test_backward_matches_jax_split_kernels():
    """The split backward (the TPU's path for n_pad > 4096) at N 300, driven
    directly as tests/test_flash_attention.py drives it."""
    from maest_tpu.ops.attention import _flash_bwd_split, _flash_fwd_lse

    x = _qkv(1, 300, 2, seed=5)
    g = np.random.default_rng(6).standard_normal((1, 300, 2, 64)).astype("f4")
    xj = jnp.asarray(x)
    q, k, v = xj[:, :, 0], xj[:, :, 1], xj[:, :, 2]
    o, lse = _flash_fwd_lse(q, k, v, block_q=128, block_k=128, interpret=True)
    ref = _flash_bwd_split(q, k, v, o, lse, jnp.asarray(g), block_q=128,
                           block_k=128, interpret=True)

    xt = torch.from_numpy(x)
    qt, kt, vt = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    ot, lse_t = flash_attention_fwd_lse(qt, kt, vt)
    ours = attention_bwd(qt, kt, vt, ot, lse_t, torch.from_numpy(g))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)


def test_backward_plain_version_matches_autograd():
    """attention_bwd_reference equals autograd through the plain forward of
    the same fp32 inputs (fp32 sums in other orders: atol 2e-6)."""
    x = torch.from_numpy(_qkv(2, 37, 3, seed=7)).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 37, 3, 64)).astype("f4"))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    attention_reference(q, k, v, n_real=30).backward(g)
    o, lse = attention_reference_lse(q.detach(), k.detach(), v.detach(), 30)
    ours = attention_bwd_reference(q.detach(), k.detach(), v.detach(), o, lse,
                                   g, 30)
    for i in range(3):
        np.testing.assert_allclose(ours[i].numpy(), x.grad[:, :, i].numpy(),
                                   rtol=1e-5, atol=2e-6)


def test_bwd_quant_errors():
    """The int8 backward (K7) runs its own arithmetic, not the bf16
    backward; unknown modes are refused."""
    x = torch.from_numpy(_qkv(1, 16, 1)).requires_grad_(True)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    torch.testing.assert_close(flash_attention(q, k, v, bwd_quant="none"),
                               flash_attention(q, k, v))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 16, 1, 64)).astype("f4"))
    flash_attention(q, k, v, bwd_quant="int8").backward(g)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o, lse = attention_reference_lse(qd, kd, vd)
    want = attention_bwd_int8_reference(qd, kd, vd, o, lse, g)
    bf16_path = attention_bwd_reference(qd, kd, vd, o, lse, g)
    for i in range(3):
        assert torch.equal(x.grad[:, :, i], want[i])
        assert not torch.equal(want[i], bf16_path[i])
    with pytest.raises(ValueError, match="unknown attention bwd_quant"):
        flash_attention(q, k, v, bwd_quant="int4")


def test_inference_path_saves_nothing_and_counts_no_launch():
    """With gradients off the forward takes the lse-free path; on the CPU
    no launch is counted either way."""
    x = torch.from_numpy(_qkv(1, 20, 2)).requires_grad_(True)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    counts = (flash_attention.launches, flash_attention_fwd_lse.launches,
              attention_bwd.launches)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert counts == (flash_attention.launches,
                      flash_attention_fwd_lse.launches, attention_bwd.launches)
