"""The plain version of the wgmma backward's schedule
(``attention_bwd_tiled_reference``: K3b/K4 walked over the kernel's key
and q tiles in its order) against the JAX package's Pallas backward
kernels in interpret mode and against ``attention_bwd_reference``, and the
route that sends the bf16 backward at head_dim 64 to the wgmma kernel or,
under the private hook ``_K3B_CONTROL``, to its mma.sync control.

Tolerances: against the Pallas kernels, the JAX package's own
(tests/test_flash_attention.py): fp32 rtol 1e-3 / atol 1e-4, bf16 2e-2
absolute and relative, compared in fp32 (bf16 rounds p and ds at ~4e-3
relative, at other places than XLA); against ``attention_bwd_reference``,
relative to max(1, the gradient's max |x|), fp32 5e-6 (the same products
summed in another order: key tiles and q tiles instead of one einsum) and
bf16 1e-2 (an fp32 sum in another order may round p, ds or an output to
the neighbouring bf16 value, 2^-8 relative). Masked keys get
exactly zero dk and dv. tests/test_torch_cuda.py holds the kernel to this
plain version on the card."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu_torch.ops import attention as A

GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PLAIN_TOL = {torch.float32: 5e-6, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(b, n, h, seed):
    """(B, N, 3, H, 64) fused q/k/v and a (B, N, H, 64) output gradient,
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3, h, 64)).astype(np.float32),
            rng.standard_normal((b, n, h, 64)).astype(np.float32))


def _jax_saved(x, dtype, n_real, block):
    """q, k, v (strided views of one fused array), o and lse (B*H, 1,
    N_pad) of the JAX package's forward in interpret mode."""
    from maest_tpu.ops.attention import _flash_fwd_lse

    xj = jnp.asarray(x).astype(JNP[dtype])
    q, k, v = xj[:, :, 0], xj[:, :, 1], xj[:, :, 2]
    o, lse = _flash_fwd_lse(q, k, v, block_q=block, block_k=block,
                            interpret=True, n_real=n_real)
    return q, k, v, o, lse


def _ours(x, g, o, lse, dtype, n_real, **kw):
    """attention_bwd_tiled_reference on the JAX forward's o and lse."""
    b, n, _, h, _ = x.shape
    xt = torch.from_numpy(x).to(dtype)
    o_t = torch.from_numpy(np.array(o.astype(jnp.float32))).to(dtype)
    lse_t = torch.from_numpy(np.asarray(lse).reshape(b, h, -1)[:, :, :n]
                             .copy())
    return A.attention_bwd_tiled_reference(
        xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], o_t, lse_t,
        torch.from_numpy(g).to(dtype), n_real, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,n_real", [(100, 90), (281, None), (300, 281)],
                         ids=["n100_real90", "n281", "n300_real281"])
def test_tiled_reference_matches_jax_flash_bwd_interpret(n, n_real, dtype):
    """The full-K backward K3b (``_flash_bwd``, reached through the JAX
    custom VJP with its Pallas kernels in interpret mode, as
    tests/test_torch_attention.py runs it) against the plain version of
    the wgmma schedule on the port's plain forward's o and lse."""
    import jax

    from maest_tpu.ops.attention import flash_attention as jax_flash

    x, g = _inputs(2, n, 2, seed=n)
    xj = jnp.asarray(x).astype(JNP[dtype])
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, n_real=n_real, interpret=True),
        xj[:, :, 0], xj[:, :, 1], xj[:, :, 2])
    ref = vjp(jnp.asarray(g).astype(JNP[dtype]))
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    o, lse = A.attention_reference_lse(q, k, v, n_real)
    ours = A.attention_bwd_tiled_reference(q, k, v, o, lse,
                                           torch.from_numpy(g).to(dtype),
                                           n_real)
    for a, r in zip(ours, ref):
        assert a.dtype == dtype and a.shape == (2, n, 2, 64)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   **GRAD_TOL[dtype])
    if n_real is not None:  # masked keys get exactly zero dk / dv
        assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


@pytest.mark.parametrize("key_tile,q_tile", [(128, 64), (128, 128), (64, 64)])
def test_tiled_reference_matches_jax_split_kernels(key_tile, q_tile):
    """The split backward K4 (``_flash_bwd_split``, the TPU's path past
    n_pad 4096) at a small split shape, N 300 with n_real 290 in 128-row
    blocks, driven directly as tests/test_torch_attention.py drives it; the
    plain version at the kernel's tiles and at the sweep's others."""
    from maest_tpu.ops.attention import _flash_bwd_split

    x, g = _inputs(1, 300, 2, seed=5)
    q, k, v, o, lse = _jax_saved(x, torch.float32, 290, 128)
    ref = _flash_bwd_split(q, k, v, o, lse, jnp.asarray(g), block_q=128,
                           block_k=128, interpret=True, n_real=290)
    ours = _ours(x, g, o, lse, torch.float32, 290, key_tile=key_tile,
                 q_tile=q_tile)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-4)
    assert not ours[1][:, 290:].any() and not ours[2][:, 290:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,n_real", [(37, None), (200, 130), (300, 257),
                                      (300, 1)],
                         ids=["n37", "n200_real130", "n300_real257",
                              "n300_real1"])
def test_tiled_reference_matches_plain_version(n, n_real, dtype):
    """Against ``attention_bwd_reference`` (one einsum over materialised
    (N, N) scores) on strided views of one fused q/k/v, with key tiles
    that end past n_real, wholly past it, and at it."""
    x, g = _inputs(2, n, 3, seed=11 + n)
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(dtype)
    o, lse = A.attention_reference_lse(q, k, v, n_real)
    ref = A.attention_bwd_reference(q, k, v, o, lse, do, n_real)
    ours = A.attention_bwd_tiled_reference(q, k, v, o, lse, do, n_real)
    for a, r in zip(ours, ref):
        assert a.dtype == dtype
        bound = PLAIN_TOL[dtype] * max(1.0, r.float().abs().max().item())
        assert (a.float() - r.float()).abs().max().item() <= bound
    if n_real is not None:
        assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


def _recorder(seen):
    def launch(name, lead, q, k, v, o, lse, do, n_real, scale):
        seen.append((name, lead, q.dtype, q.shape[-1]))
        return torch.empty(q.shape[:2] + (3,) + q.shape[2:], dtype=q.dtype,
                           device=q.device)
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_backward_route_names_the_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: bf16 at head_dim 64 (and at 16,
    zero-padded to 64) names ``maest_attn_bwd_bf16``, the wgmma kernel,
    counted in ``attention_bwd``; with ``_K3B_CONTROL`` it names
    ``maest_attn_bwd_bf16_mma``, counted in ``attention_bwd_mma``; bf16 at
    head_dim 256 and 320 moves with the hook too, to
    ``maest_attn_bwd_bf16_d256_mma`` and ``maest_attn_bwd_bf16_dn_mma``
    (tests/test_torch_bwd_d256_wgmma.py and tests/test_torch_bwd_dn_wgmma.py
    hold those routes). fp32 and head_dim 128 keep their entries either
    way, and the forward is not moved by the hook."""
    seen = []
    monkeypatch.setattr(A, "launch_bwd_entry", _recorder(seen))
    monkeypatch.setattr(A, "_K3B_CONTROL", control)
    monkeypatch.setattr(A.attention_bwd, "launches", 0)
    monkeypatch.setattr(A.attention_bwd_mma, "launches", 0)
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 16),
                     (torch.float32, 64), (torch.bfloat16, 128),
                     (torch.bfloat16, 256), (torch.bfloat16, 320),
                     (torch.float32, 128)):
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        lse = torch.zeros(1, 2, 4, device="meta")
        grads = A.attention_bwd(x, x, x, x, lse, x)
        assert all(t.shape == x.shape for t in grads)
    k3b = "maest_attn_bwd_bf16_mma" if control else "maest_attn_bwd_bf16"
    assert seen == [
        (k3b, (), torch.bfloat16, 64), (k3b, (), torch.bfloat16, 64),
        ("maest_attn_bwd_fp32", (), torch.float32, 64),
        ("maest_attn_bwd_bf16_d128", (), torch.bfloat16, 128),
        ("maest_attn_bwd_bf16_d256_mma" if control else
         "maest_attn_bwd_bf16_d256", (), torch.bfloat16, 256),
        ("maest_attn_bwd_bf16_dn_mma" if control else
         "maest_attn_bwd_bf16_dn", (320,), torch.bfloat16, 320),
        ("maest_attn_bwd_fp32_d128", (), torch.float32, 128)]
    assert (A.attention_bwd.launches, A.attention_bwd_mma.launches) == (
        (3, 4) if control else (7, 0))
    assert A._K2_CONTROL is False


def test_control_takes_plain_version_on_the_cpu():
    """``attention_bwd_mma`` on CPU tensors is the plain version, counts no
    launch, and refuses no dtype there; the scratch of the wgmma entries
    is sized by the library, the other entries' is delta (B, H, N)."""
    x, g = _inputs(1, 50, 2, seed=13)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(torch.bfloat16)
    o, lse = A.attention_reference_lse(q, k, v, 45)
    before = A.attention_bwd_mma.launches
    got = A.attention_bwd_mma(q, k, v, o, lse, do, 45)
    want = A.attention_bwd_reference(q, k, v, o, lse, do, 45)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert A.attention_bwd_mma.launches == before
    assert A._bwd_scratch(None, "maest_attn_bwd_bf16_mma", 2, 50, 3) == 300
    # an entry X that takes scratch exports X_scratch (a stand-in library)
    lib = types.SimpleNamespace(**{
        f"{e}_scratch": lambda b, n, h: 7 * b * n * h
        for e in ("maest_attn_bwd_bf16", "maest_attn_bwd_bf16_wgmma")})
    for e in ("maest_attn_bwd_bf16", "maest_attn_bwd_bf16_wgmma"):
        assert A._bwd_scratch(lib, e, 2, 50, 3) == 2100
    assert A._bwd_scratch(lib, "maest_attn_bwd_bf16_mma", 2, 50, 3) == 300
