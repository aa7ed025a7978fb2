"""K2/K3a at head_dim 128 on the ``wgmma`` kernel (``csrc/attn_fwd_wgmma.cuh``
at D = 128, entry ``maest_attn_fwd_bf16_d128``) and its ``mma.sync`` control
(entry ``maest_attn_fwd_bf16_d128_mma``), on the CPU.

- The route's plain version as the card takes it: q, k, v zero-padded to
  128 (head_dim 96 too) with the unpadded head_dim's scale, the plain
  forward with lse, o sliced back (``padded_fwd``), against the JAX
  package's Pallas forward (``_flash_fwd_lse``) in interpret mode at N 200
  with n_real 190, o and lse. Tolerances: o in bf16 within 2e-2 absolute
  and relative, compared in fp32 (the JAX package's own bf16 bound: the
  Pallas kernel rounds the unnormalised p to bf16 for P.V, the plain
  version the normalised one); lse within 1e-5 (fp32 log2-sum-exp of the
  same fp32 scores, sums in other orders).
- ``_has_fwd_control`` takes 128, and the private hook ``_K2_CONTROL``
  routes head_dim 128 (and 96, zero-padded) to the control's entry, on
  meta tensors with the launcher replaced by a recorder.
- Each C entry names its kernel, read from the source.

``tests/test_torch_cuda.py`` holds the kernel to the plain version on the
card, and ``chip_smoke.py`` phase 43 times it beside the control and SDPA."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu_torch.ops import attention as A

ROOT = Path(__file__).resolve().parent.parent
O_TOL = dict(rtol=2e-2, atol=2e-2)
LSE_TOL = 1e-5


def _route_plain(q, k, v, n_real):
    """(o, lse) of the head_dim-128 route with the kernel replaced by its
    plain version: pad to 128, plain forward with lse at the unpadded
    head_dim's scale, slice."""
    def plain(q, k, v, n_real, with_lse, scale):
        assert q.shape[-1] == 128 and with_lse
        return A.attention_reference_lse(q, k, v, n_real, scale)
    return A.padded_fwd(plain, q, k, v, n_real, True)


@pytest.mark.parametrize("d", [128, 96])
def test_route_plain_version_matches_jax_flash_interpret(d):
    from maest_tpu.ops.attention import _flash_fwd_lse

    n, n_real = 200, 190
    x = np.random.default_rng(25 + d).standard_normal(
        (2, n, 3, 2, d)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    o, lse = _route_plain(q, k, v, n_real)
    assert o.shape == (2, n, 2, d) and o.dtype == torch.bfloat16
    assert lse.shape == (2, 2, n) and lse.dtype == torch.float32
    # the CPU route is the unpadded plain version: zero columns change only
    # the order of the sums over head_dim
    o2, lse2 = A.flash_attention_fwd_lse(q, k, v, n_real=n_real)
    assert (o.float() - o2.float()).abs().max().item() <= 2 ** -7
    assert (lse - lse2).abs().max().item() <= 1e-6

    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref, ref_lse = _flash_fwd_lse(xj[:, :, 0], xj[:, :, 1], xj[:, :, 2],
                                  block_q=896, block_k=448, interpret=True,
                                  n_real=n_real)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **O_TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(ref_lse).reshape(2, 2, -1)[:, :, :n],
        atol=LSE_TOL, rtol=0)


def test_control_takes_head_dim_128():
    assert A._has_fwd_control(128) and A._has_fwd_control(64)
    assert A._has_fwd_control(384) and A._has_fwd_control(320)
    assert A._has_fwd_control(256)
    for d in (96, 192, 32, 300):
        assert not A._has_fwd_control(d)


def _recorder(seen):
    def launch(lib_name, name, lead, q, k, v, n_real, with_lse, scale):
        seen.append((name, lead, q.shape[-1], round(scale, 6)))
        b, n, h, _ = q.shape
        lse = torch.empty((b, h, n), device=q.device) if with_lse else None
        return torch.empty_like(q), lse
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_head_dim_128_routes_name_their_entries(control, monkeypatch):
    """bf16 at head_dim 128 and 96 (zero-padded to 128, the scale 96^-0.5)
    names ``maest_attn_fwd_bf16_d128`` (the wgmma kernel), counted in
    ``flash_attention`` / ``flash_attention_fwd_lse``; under
    ``_K2_CONTROL`` ``maest_attn_fwd_bf16_d128_mma``, counted in
    ``attention_fwd_mma``; ``attention_fwd_mma`` names the control at 128
    either way."""
    seen = []
    monkeypatch.setattr(A, "launch_fwd_entry", _recorder(seen))
    monkeypatch.setattr(A, "_K2_CONTROL", control)
    counted = (A.flash_attention, A.flash_attention_fwd_lse,
               A.attention_fwd_mma)
    for f in counted:
        monkeypatch.setattr(f, "launches", 0)
    for d in (128, 96):
        x = torch.zeros(2, 8, 6, d, dtype=torch.bfloat16, device="meta")
        assert A.flash_attention(x, x, x).shape == x.shape
        o, lse = A.flash_attention_fwd_lse(x, x, x, n_real=7)
        assert o.shape == x.shape and lse.shape == (2, 6, 8)
    entry = "maest_attn_fwd_bf16_d128" + ("_mma" if control else "")
    assert seen == [(entry, (), 128, round(d**-0.5, 6))
                    for d in (128, 96) for _ in range(2)]
    assert [f.launches for f in counted] == ([0, 0, 4] if control
                                             else [2, 2, 0])
    seen.clear()
    x = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16, device="meta")
    A.attention_fwd_mma(x, x, x, with_lse=True)
    assert seen == [("maest_attn_fwd_bf16_d128_mma", (), 128,
                     round(128**-0.5, 6))]


def _body(src: str, signature: str) -> str:
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_entries_name_their_kernels():
    """Read from ``csrc/attention_fwd.cu``: the route launches the wgmma
    kernel at D = 128 with two consumer warpgroups taking turns, the
    control the mma.sync template's FLASH instance at D_ = 128, and every
    configuration of the sweep entry is a D = 128 wgmma instance."""
    src = (ROOT / "maest_tpu_torch" / "csrc" / "attention_fwd.cu").read_text()
    route = _body(src, "int maest_attn_fwd_bf16_d128(")
    assert "if (wg128_key_tile(n_real) == 96)" in route
    for bk in (80, 96):
        assert f"launch_fwd_wgmma<{bk}, 2, true, false, 1, 128>" in route
    assert "launch_fwd<" not in route
    control = _body(src, "int maest_attn_fwd_bf16_d128_mma(")
    assert "launch_fwd<FLASH, 1, WARPS, MK, false, 128>" in control
    assert "wgmma" not in control
    sweep = _body(src, "int maest_attn_fwd_bf16_d128_wgmma(")
    assert "launch_fwd_wgmma<BK, 2, true, false, 1, 128, ST>" in sweep
    assert sweep.count("case ") == 9 and "launch_fwd<" not in sweep
    header = (ROOT / "maest_tpu_torch" / "csrc" / "attn_fwd_wgmma.cuh"
              ).read_text()
    assert 'static_assert(D == 64 || D == 128, "head_dim 64 or 128");' in \
        header


def test_key_tile_rule_is_the_kernels():
    """``wg128_key_tile`` is the header's rule: 96 keys where they pad
    n_real less than 80 do, else 80 (80 at tagging's 1676 and the 30 s
    recipe's 866, 96 at the 10 s recipe's 281)."""
    assert A.WG128_KEY_TILES == (80, 96)
    assert [A.wg128_key_tile(n) for n in (1676, 866, 281, 80, 96, 1, 192)] \
        == [80, 80, 96, 80, 96, 80, 96]
    header = (ROOT / "maest_tpu_torch" / "csrc" / "attn_fwd_wgmma.cuh"
              ).read_text()
    assert ("return (n_real + 95) / 96 * 96 < (n_real + 79) / 80 * 80 ? 96 "
            ": 80;") in header
    for n in range(1, 2000):
        pad96, pad80 = -(-n // 96) * 96, -(-n // 80) * 80
        assert A.wg128_key_tile(n) == (96 if pad96 < pad80 else 80)

