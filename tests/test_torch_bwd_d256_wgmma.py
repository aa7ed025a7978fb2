"""The plain version of the head_dim-256 wgmma backward's schedule
(``attention_bwd_tiled_reference`` at ``BWD_D256_KEY_TILE`` keys and
``BWD_D256_Q_TILE`` q rows: the dk/dv kernel's key blocks and q tiles,
the dq kernel's key tiles summed in increasing order) against the JAX
package's Pallas backward in interpret mode and against
``attention_bwd_reference``, at head_dim 256 and at 192 (zero-padded to
256 with the unpadded head_dim's scale, as the port's route pads it), and
the route that sends the bf16 backward at head_dim 129-256 to the wgmma
kernels (``maest_attn_bwd_bf16_d256``) or, under the private hook
``_K3B_CONTROL``, to their mma.sync control
(``maest_attn_bwd_bf16_d256_mma``).

Tolerances are tests/test_torch_bwd_wgmma.py's: against the Pallas
kernels fp32 rtol 1e-3 / atol 1e-4 and bf16 2e-2 absolute and relative,
compared in fp32; against ``attention_bwd_reference``, relative to max(1,
the gradient's max |x|), fp32 5e-6 and bf16 1e-2. Masked keys get exactly
zero dk and dv. tests/test_torch_cuda.py holds the kernels to this plain
version on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from maest_tpu_torch.ops import attention as A

GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PLAIN_TOL = {torch.float32: 5e-6, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(b, n, h, d, seed):
    """(B, N, 3, H, d) fused q/k/v and a (B, N, H, d) output gradient,
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3, h, d)).astype(np.float32),
            rng.standard_normal((b, n, h, d)).astype(np.float32))


def _schedule(q, k, v, o, lse, do, n_real):
    """The kernels' plain version on the route's inputs: zero-padded to 256
    along head_dim with the unpadded head_dim's scale, sliced back."""
    d = q.shape[-1]
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    assert qp.shape[-1] == 256
    grads = A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, n_real, scale,
        key_tile=A.BWD_D256_KEY_TILE, q_tile=A.BWD_D256_Q_TILE)
    return tuple(g[..., :d] for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("n,n_real", [(100, 90), (300, 281)],
                         ids=["n100_real90", "n300_real281"])
def test_d256_schedule_matches_jax_flash_bwd_interpret(n, n_real, d, dtype):
    """The full-K backward (``_flash_bwd``, reached through the JAX custom
    VJP with its Pallas kernels in interpret mode) against the plain
    version of the head_dim-256 wgmma schedule on the port's plain
    forward's o and lse."""
    from maest_tpu.ops.attention import flash_attention as jax_flash

    x, g = _inputs(1, n, 2, d, seed=n + d)
    xj = jnp.asarray(x).astype(JNP[dtype])
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, n_real=n_real, interpret=True),
        xj[:, :, 0], xj[:, :, 1], xj[:, :, 2])
    ref = vjp(jnp.asarray(g).astype(JNP[dtype]))
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    o, lse = A.attention_reference_lse(q, k, v, n_real)
    ours = _schedule(q, k, v, o, lse, torch.from_numpy(g).to(dtype), n_real)
    for a, r in zip(ours, ref):
        assert a.dtype == dtype and a.shape == (1, n, 2, d)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   **GRAD_TOL[dtype])
    assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("n,n_real", [(100, 90), (300, 281), (70, None),
                                      (200, 1)],
                         ids=["n100_real90", "n300_real281", "n70",
                              "n200_real1"])
def test_d256_schedule_matches_plain_version(n, n_real, d, dtype):
    """Against ``attention_bwd_reference`` (one einsum over materialised
    (N, N) scores) on strided views of one fused q/k/v: a last q tile of 6
    rows (N 70), key blocks that end past n_real and wholly past it."""
    x, g = _inputs(2, n, 2, d, seed=31 + n + d)
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(dtype)
    o, lse = A.attention_reference_lse(q, k, v, n_real)
    ref = A.attention_bwd_reference(q, k, v, o, lse, do, n_real)
    ours = _schedule(q, k, v, o, lse, do, n_real)
    for a, r in zip(ours, ref):
        assert a.dtype == dtype
        bound = PLAIN_TOL[dtype] * max(1.0, r.float().abs().max().item())
        assert (a.float() - r.float()).abs().max().item() <= bound
    if n_real is not None:
        assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


def test_d256_tiles_are_the_kernels():
    """The plain version's tiles are the kernels' (csrc/attn_bwd_d256_
    wgmma.cuh B2_KEYS, B2_BQ, B2_BK: 64 keys a dk/dv block, 64-row q
    tiles, dq summed over 64-key tiles)."""
    from pathlib import Path

    src = (Path(A.__file__).parent.parent / "csrc" /
           "attn_bwd_d256_wgmma.cuh").read_text()
    for name, value in (("B2_KEYS", A.BWD_D256_KEY_TILE),
                        ("B2_BQ", A.BWD_D256_Q_TILE),
                        ("B2_BK", A.BWD_D256_KEY_TILE)):
        assert f"constexpr int {name} = {value};" in src, name


def _recorder(seen):
    def launch(name, lead, q, k, v, o, lse, do, n_real, scale):
        seen.append((name, lead, q.dtype, q.shape[-1], round(scale, 6)))
        return torch.empty(q.shape[:2] + (3,) + q.shape[2:], dtype=q.dtype,
                           device=q.device)
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_d256_route_names_the_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: bf16 at head_dim 256, and at 192
    and 136 zero-padded to 256 with their own scale, names
    ``maest_attn_bwd_bf16_d256`` (the wgmma kernels), counted in
    ``attention_bwd``; with ``_K3B_CONTROL`` it names
    ``maest_attn_bwd_bf16_d256_mma``, counted in ``attention_bwd_mma``.
    fp32 at 256 and bf16 at 128 keep their entries either way; the
    control's own wrapper names the control's entry at 256."""
    seen = []
    monkeypatch.setattr(A, "launch_bwd_entry", _recorder(seen))
    monkeypatch.setattr(A, "_K3B_CONTROL", control)
    monkeypatch.setattr(A.attention_bwd, "launches", 0)
    monkeypatch.setattr(A.attention_bwd_mma, "launches", 0)
    for dtype, d in ((torch.bfloat16, 256), (torch.bfloat16, 192),
                     (torch.bfloat16, 136), (torch.float32, 256),
                     (torch.bfloat16, 128)):
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        lse = torch.zeros(1, 2, 4, device="meta")
        grads = A.attention_bwd(x, x, x, x, lse, x)
        assert all(t.shape == x.shape for t in grads)
    x = torch.zeros(1, 4, 2, 256, dtype=torch.bfloat16, device="meta")
    A.attention_bwd_mma(x, x, x, x, torch.zeros(1, 2, 4, device="meta"), x)
    k3b = ("maest_attn_bwd_bf16_d256_mma" if control
           else "maest_attn_bwd_bf16_d256")
    assert seen == [
        (k3b, (), torch.bfloat16, 256, round(256**-0.5, 6)),
        (k3b, (), torch.bfloat16, 256, round(192**-0.5, 6)),
        (k3b, (), torch.bfloat16, 256, round(136**-0.5, 6)),
        ("maest_attn_bwd_fp32_d256", (), torch.float32, 256,
         round(256**-0.5, 6)),
        ("maest_attn_bwd_bf16_d128", (), torch.bfloat16, 128,
         round(128**-0.5, 6)),
        ("maest_attn_bwd_bf16_d256_mma", (), torch.bfloat16, 256,
         round(256**-0.5, 6))]
    assert (A.attention_bwd.launches, A.attention_bwd_mma.launches) == (
        (2, 4) if control else (5, 1))


def test_control_refuses_what_it_has_no_kernel_for():
    """``attention_bwd_mma`` off the CPU takes bf16 at head_dim 64, 256 and
    the multiples of 64 above 256 only (the widths whose wgmma kernels
    replaced mma.sync ones): fp32, and bf16 at 128, 192 and 300 (the
    caller pads them) are refused before any launch; on the CPU it is the
    plain version at any width."""
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 128),
                     (torch.bfloat16, 192), (torch.bfloat16, 300)):
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        lse = torch.zeros(1, 2, 4, device="meta")
        with pytest.raises(ValueError, match="head_dim 64, 256 or a "
                           "multiple of 64 above 256"):
            A.attention_bwd_mma(x, x, x, x, lse, x)
    x, g = _inputs(1, 40, 2, 192, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(torch.bfloat16)
    o, lse = A.attention_reference_lse(q, k, v, 33)
    before = A.attention_bwd_mma.launches
    got = A.attention_bwd_mma(q, k, v, o, lse, do, 33)
    want = A.attention_bwd_reference(q, k, v, o, lse, do, 33)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert A.attention_bwd_mma.launches == before


def test_d256_padding_slices_back_the_route_gradients():
    """On the CPU the route at head_dim 192 is the plain version of 192,
    and the schedule on the zero-padded inputs gives zero gradient columns
    past 192 (so slicing them off loses nothing)."""
    x, g = _inputs(1, 64, 2, 192, seed=4)
    xt = torch.from_numpy(x)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g)
    o, lse = A.attention_reference_lse(q, k, v, 60)
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    grads = A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, 60, scale, key_tile=A.BWD_D256_KEY_TILE,
        q_tile=A.BWD_D256_Q_TILE)
    assert all(not t[..., 192:].any() for t in grads)
    route = A.attention_bwd(q, k, v, o, lse, do, 60)
    ref = A.attention_bwd_reference(q, k, v, o, lse, do, 60)
    assert all(torch.equal(a, b) for a, b in zip(route, ref))
    assert all((a - b[..., :192]).abs().max().item() <= 5e-6 * max(
        1.0, a.abs().max().item()) for a, b in zip(ref, grads))
    assert F.pad(q, (0, 64)).shape == qp.shape
