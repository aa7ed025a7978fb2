"""K2/K3a at head_dim 256 on the ``wgmma`` kernel
(``csrc/attn_fwd_d256_wgmma.cuh``, entry ``maest_attn_fwd_bf16_d256``) and
its ``mma.sync`` control (entry ``maest_attn_fwd_bf16_d256_mma``), on the
CPU.

- The route's plain version as the card takes it: q, k, v zero-padded to
  256 (head_dim 192 too) with the unpadded head_dim's scale, the forward
  walked over the kernel's 64-key tiles (``attention_fwd_tiled_reference``:
  the running max and sum, p rounded to bf16 against the running max), o
  sliced back (``padded_fwd``), against the JAX package's Pallas forward
  (``_flash_fwd_lse``) in interpret mode at N 100 with n_real 90 and N 300
  with n_real 281, o and lse, and against ``attention_reference_lse``.
  Tolerances: against Pallas, o fp32 rtol 1e-3 / atol 1e-4 and bf16 2e-2
  absolute and relative, compared in fp32; lse 1e-5 (fp32 log2-sum-exp of
  the same fp32 scores, sums in other orders). Against plain, relative to
  max(1, max |o|), fp32 5e-6 and bf16 1e-2 (plain rounds the normalised p
  to bf16, the kernel the unnormalised one); lse 1e-5.
- ``_has_fwd_control`` takes 256, and the private hook ``_K2_CONTROL``
  routes head_dim 256 (and 192, zero-padded) to the control's entry, on
  meta tensors with the launcher replaced by a recorder; the control
  refuses what no kernel of its takes.
- Each C entry names its kernel, read from the source.

``tests/test_torch_cuda.py`` holds the kernel to the plain version on the
card, and ``chip_smoke.py`` phase 44 times it beside the control and SDPA."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu_torch.ops import attention as A

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "maest_tpu_torch" / "csrc"
O_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
         torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PLAIN_TOL = {torch.float32: 5e-6, torch.bfloat16: 1e-2}
LSE_TOL = 1e-5
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _route_plain(q, k, v, n_real):
    """(o, lse) of the head_dim-256 route with the kernel replaced by its
    plain version: pad to 256, the tiled forward with lse at the unpadded
    head_dim's scale, slice."""
    def plain(q, k, v, n_real, with_lse, scale):
        assert q.shape[-1] == 256 and with_lse
        return A.attention_fwd_tiled_reference(q, k, v, n_real, scale)
    return A.padded_fwd(plain, q, k, v, n_real, True)


def _qkv(b, n, h, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3, h, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("n,n_real", [(100, 90), (300, 281)],
                         ids=["n100_real90", "n300_real281"])
def test_route_plain_version_matches_jax_flash_interpret(n, n_real, d, dtype):
    from maest_tpu.ops.attention import _flash_fwd_lse

    x = _qkv(2, n, 2, d, seed=26 + n + d)
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    o, lse = _route_plain(q, k, v, n_real)
    assert o.shape == (2, n, 2, d) and o.dtype == dtype
    assert lse.shape == (2, 2, n) and lse.dtype == torch.float32
    xj = jnp.asarray(x).astype(JNP[dtype])
    ref, ref_lse = _flash_fwd_lse(xj[:, :, 0], xj[:, :, 1], xj[:, :, 2],
                                  block_q=896, block_k=448, interpret=True,
                                  n_real=n_real)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **O_TOL[dtype])
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(ref_lse).reshape(2, 2, -1)[:, :, :n],
        atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("n,n_real", [(100, 90), (300, 281), (70, None),
                                      (200, 1)],
                         ids=["n100_real90", "n300_real281", "n70",
                              "n200_real1"])
def test_route_plain_version_matches_plain(n, n_real, d, dtype):
    """Against ``attention_reference_lse`` on strided views of one fused
    q/k/v: a last key tile of 6 keys (N 70), key tiles past n_real, one
    real key; the CPU route itself is that plain version."""
    x = _qkv(2, n, 3, d, seed=44 + n + d)
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    o, lse = _route_plain(q, k, v, n_real)
    r, rl = A.attention_reference_lse(q, k, v, n_real)
    bound = PLAIN_TOL[dtype] * max(1.0, r.float().abs().max().item())
    assert (o.float() - r.float()).abs().max().item() <= bound
    assert (lse - rl).abs().max().item() <= LSE_TOL
    o2, lse2 = A.flash_attention_fwd_lse(q, k, v, n_real=n_real)
    assert torch.equal(o2, r) and torch.equal(lse2, rl)


def test_key_tile_is_the_kernels():
    """The plain version's key tile is the kernel's (F2_BK), and the kernel
    is built for head_dim 256 with 128 query rows a block."""
    src = (CSRC / "attn_fwd_d256_wgmma.cuh").read_text()
    assert f"constexpr int F2_BK = {A.FWD_D256_KEY_TILE};" in src
    assert "constexpr int F2_D = 256;" in src
    assert "constexpr int F2_BQ = 128;" in src
    assert "constexpr int F2_THREADS = 256;" in src  # no producer warp


def test_control_takes_head_dim_256():
    assert A._has_fwd_control(256)
    for d in (64, 128, 320, 384, 1024):
        assert A._has_fwd_control(d)
    for d in (192, 96, 300, 32, 136):
        assert not A._has_fwd_control(d)


def _recorder(seen):
    def launch(lib_name, name, lead, q, k, v, n_real, with_lse, scale):
        seen.append((name, lead, q.shape[-1], round(scale, 6)))
        b, n, h, _ = q.shape
        lse = torch.empty((b, h, n), device=q.device) if with_lse else None
        return torch.empty_like(q), lse
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_head_dim_256_routes_name_their_entries(control, monkeypatch):
    """bf16 at head_dim 256, 192 and 136 (zero-padded to 256, each with its
    own scale) names ``maest_attn_fwd_bf16_d256`` (the wgmma kernel),
    counted in ``flash_attention`` / ``flash_attention_fwd_lse``; under
    ``_K2_CONTROL`` ``maest_attn_fwd_bf16_d256_mma``, counted in
    ``attention_fwd_mma``; ``attention_fwd_mma`` names the control at 256
    either way, and fp32 at 256 keeps its entry."""
    seen = []
    monkeypatch.setattr(A, "launch_fwd_entry", _recorder(seen))
    monkeypatch.setattr(A, "_K2_CONTROL", control)
    counted = (A.flash_attention, A.flash_attention_fwd_lse,
               A.attention_fwd_mma)
    for f in counted:
        monkeypatch.setattr(f, "launches", 0)
    for d in (256, 192, 136):
        x = torch.zeros(2, 8, 3, d, dtype=torch.bfloat16, device="meta")
        assert A.flash_attention(x, x, x).shape == x.shape
        o, lse = A.flash_attention_fwd_lse(x, x, x, n_real=7)
        assert o.shape == x.shape and lse.shape == (2, 3, 8)
    entry = "maest_attn_fwd_bf16_d256" + ("_mma" if control else "")
    assert seen == [(entry, (), 256, round(d**-0.5, 6))
                    for d in (256, 192, 136) for _ in range(2)]
    assert [f.launches for f in counted] == ([0, 0, 6] if control
                                             else [3, 3, 0])
    seen.clear()
    x = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16, device="meta")
    A.attention_fwd_mma(x, x, x, with_lse=True)
    x32 = torch.zeros(1, 8, 2, 256, device="meta")
    A.flash_attention(x32, x32, x32)
    assert seen == [("maest_attn_fwd_bf16_d256_mma", (), 256,
                     round(256**-0.5, 6)),
                    ("maest_attn_fwd_fp32_d256", (), 256,
                     round(256**-0.5, 6))]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 256),
                                     (torch.bfloat16, 192),
                                     (torch.bfloat16, 300)])
def test_control_refuses_what_it_has_no_kernel_for(dtype, d):
    """Off the CPU ``attention_fwd_mma`` refuses, before any launch, what
    no mma.sync control kernel takes: fp32, and bf16 at a width that is no
    kernel's (192 and 300: the callers pad them); no launch is counted."""
    x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
    before = A.attention_fwd_mma.launches
    with pytest.raises(ValueError, match="head_dim 64, 128, 256 or a "
                       "multiple of 64 above 256"):
        A.attention_fwd_mma(x, x, x)
    assert A.attention_fwd_mma.launches == before


def _body(src: str, signature: str) -> str:
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_entries_name_their_kernels():
    """Read from ``csrc/attention_fwd.cu``: the route launches the wgmma
    kernel of attn_fwd_d256_wgmma.cuh, the control the mma.sync template's
    FLASH instance at D_ = 256."""
    src = (CSRC / "attention_fwd.cu").read_text()
    route = _body(src, "int maest_attn_fwd_bf16_d256(")
    assert "launch_fwd_d256_wgmma(" in route and "launch_fwd<" not in route
    control = _body(src, "int maest_attn_fwd_bf16_d256_mma(")
    assert "launch_fwd<FLASH, 1, WARPS, MK, false, 256>" in control
    assert "wgmma" not in control
    assert '#include "attn_fwd_d256_wgmma.cuh"' in src
