"""The plain version of the wgmma backward above head_dim 256
(``attention_bwd_tiled_reference`` at ``BWD_DN_KEY_TILE`` keys and
``BWD_DN_Q_TILE`` q rows: p and ds rounded to bf16 as the scores kernel
writes them, dv and dk summed over the q tiles and dq over the key tiles
in increasing order, as the product kernels sum them) against the JAX
package's Pallas backward in interpret mode and against
``attention_bwd_reference``, at head_dim 384 and at 300 (zero-padded to
320 with the unpadded head_dim's scale, as the port's route pads it), and
the route that sends the bf16 backward at every width above 256 to the
wgmma kernels (``maest_attn_bwd_bf16_dn``) or, under the private hook
``_K3B_CONTROL``, to their mma.sync control (``maest_attn_bwd_bf16_dn_mma``).

Tolerances are tests/test_torch_bwd_wgmma.py's: against the Pallas
kernels fp32 rtol 1e-3 / atol 1e-4 and bf16 2e-2 absolute and relative,
compared in fp32; against ``attention_bwd_reference``, relative to max(1,
the gradient's max |x|), fp32 5e-6 and bf16 1e-2. Masked keys get exactly
zero dk and dv. tests/test_torch_cuda.py holds the kernels to this plain
version on the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu_torch.ops import attention as A

GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PLAIN_TOL = {torch.float32: 5e-6, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
HEADER = Path(A.__file__).parent.parent / "csrc" / "attn_bwd_dn_wgmma.cuh"


def _inputs(b, n, h, d, seed):
    """(B, N, 3, H, d) fused q/k/v and a (B, N, H, d) output gradient,
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3, h, d)).astype(np.float32),
            rng.standard_normal((b, n, h, d)).astype(np.float32))


def _schedule(q, k, v, o, lse, do, n_real):
    """The kernels' plain version on the route's inputs: zero-padded along
    head_dim to the next multiple of 64 with the unpadded head_dim's
    scale, sliced back."""
    d = q.shape[-1]
    (qp, kp, vp, op, dop), scale = A.pad_head_dim(q, k, v, o, do)
    assert qp.shape[-1] == A.padded_dim(d) and qp.shape[-1] % 64 == 0
    grads = A.attention_bwd_tiled_reference(
        qp, kp, vp, op, lse, dop, n_real, scale,
        key_tile=A.BWD_DN_KEY_TILE, q_tile=A.BWD_DN_Q_TILE)
    return tuple(g[..., :d] for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [384, 300])
@pytest.mark.parametrize("n,n_real", [(100, 90), (300, 281)],
                         ids=["n100_real90", "n300_real281"])
def test_dn_schedule_matches_jax_flash_bwd_interpret(n, n_real, d, dtype):
    """The full-K backward (``_flash_bwd``, reached through the JAX custom
    VJP with its Pallas kernels in interpret mode) against the plain
    version of the wgmma schedule above 256 on the port's plain forward's
    o and lse."""
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
@pytest.mark.parametrize("d", [384, 300, 512])
@pytest.mark.parametrize("n,n_real", [(100, 90), (300, 281), (70, None),
                                      (200, 1)],
                         ids=["n100_real90", "n300_real281", "n70",
                              "n200_real1"])
def test_dn_schedule_matches_plain_version(n, n_real, d, dtype):
    """Against ``attention_bwd_reference`` (one einsum over materialised
    (N, N) scores) on strided views of one fused q/k/v: a last q tile of 6
    rows (N 70), key tiles that end past n_real and wholly past it."""
    x, g = _inputs(2, n, 2, d, seed=37 + n + d)
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


def test_dn_tiles_are_the_kernels():
    """The plain version's tiles and the route's constants are the
    kernels' (csrc/attn_bwd_dn_wgmma.cuh): 128 keys a scores block, 64-row
    q tiles, k-steps of 64 in the products, BD_NW 64-column chunks a
    product block, N padded to 128 for the planes."""
    src = HEADER.read_text()
    for name, value in (("BD_KEYS", A.BWD_DN_KEYS), ("BD_BQ", A.BWD_DN_Q_TILE),
                        ("BD_NW", A.BWD_DN_COLS // 64),
                        ("BD_PAD", A.BWD_DN_KEYS)):
        assert f"constexpr int {name} = {value};" in src, name
    # the products' k-steps: 64 q rows (dv, dk) or 64 keys (dq) a stage
    assert A.BWD_DN_KEY_TILE == A.BWD_DN_Q_TILE == 64
    assert "64 * kt" in src
    assert "const int n_k = ((TRANS_A ? n_real : n) + 63) / 64;" in src


@pytest.mark.parametrize("b,n,h", [(2, 866, 2), (1, 4500, 2), (3, 100, 1)])
def test_dn_scratch_is_the_headers_rule(b, n, h):
    """The scratch the entry exports (``maest_attn_bwd_bf16_dn_scratch``):
    lse and delta of N_pad rows and the p^T and ds^T planes (N_pad^2 bf16
    each), N_pad = round_up(N, 128); a stand-in library exports it by the
    header's formula, and ``_bwd_scratch`` sizes the buffer by it."""
    import types

    src = " ".join(HEADER.read_text().split())
    assert ("return 2LL * batch * heads * np + static_cast<long long>(batch) "
            "* heads * np * np;") in src
    assert "return (n + BD_PAD - 1) / BD_PAD * static_cast<long long>(BD_PAD);" \
        in src
    np_ = -(-n // 128) * 128

    def floats(b_, n_, h_):
        p = -(-n_ // 128) * 128
        return 2 * b_ * h_ * p + b_ * h_ * p * p
    lib = types.SimpleNamespace(maest_attn_bwd_bf16_dn_scratch=floats)
    assert A._bwd_scratch(lib, "maest_attn_bwd_bf16_dn", b, n, h) == (
        2 * b * h * np_ + b * h * np_ * np_)
    assert A._bwd_scratch(lib, "maest_attn_bwd_bf16_dn_mma", b, n, h) == (
        b * h * n)


def _recorder(seen):
    def launch(name, lead, q, k, v, o, lse, do, n_real, scale):
        seen.append((name, lead, q.dtype, q.shape[-1], round(scale, 6)))
        return torch.empty(q.shape[:2] + (3,) + q.shape[2:], dtype=q.dtype,
                           device=q.device)
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_dn_route_names_the_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: bf16 at head_dim 320, 384 and
    1024, and at 300 zero-padded to 320 with its own scale, names
    ``maest_attn_bwd_bf16_dn`` (the wgmma kernels) with its width, counted
    in ``attention_bwd``; with ``_K3B_CONTROL`` it names
    ``maest_attn_bwd_bf16_dn_mma``, counted in ``attention_bwd_mma``.
    fp32 at 384 keeps its entry either way; the control's own wrapper
    names the control's entry at 384."""
    seen = []
    monkeypatch.setattr(A, "launch_bwd_entry", _recorder(seen))
    monkeypatch.setattr(A, "_K3B_CONTROL", control)
    monkeypatch.setattr(A.attention_bwd, "launches", 0)
    monkeypatch.setattr(A.attention_bwd_mma, "launches", 0)
    cases = ((torch.bfloat16, 320), (torch.bfloat16, 384),
             (torch.bfloat16, 1024), (torch.bfloat16, 300),
             (torch.float32, 384))
    for dtype, d in cases:
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        lse = torch.zeros(1, 2, 4, device="meta")
        grads = A.attention_bwd(x, x, x, x, lse, x)
        assert all(t.shape == x.shape for t in grads)
    x = torch.zeros(1, 4, 2, 384, dtype=torch.bfloat16, device="meta")
    A.attention_bwd_mma(x, x, x, x, torch.zeros(1, 2, 4, device="meta"), x)
    k3b = "maest_attn_bwd_bf16_dn" + ("_mma" if control else "")
    assert seen == [
        (k3b, (320,), torch.bfloat16, 320, round(320**-0.5, 6)),
        (k3b, (384,), torch.bfloat16, 384, round(384**-0.5, 6)),
        (k3b, (1024,), torch.bfloat16, 1024, round(1024**-0.5, 6)),
        (k3b, (320,), torch.bfloat16, 320, round(300**-0.5, 6)),
        ("maest_attn_bwd_fp32_dn", (384,), torch.float32, 384,
         round(384**-0.5, 6)),
        ("maest_attn_bwd_bf16_dn_mma", (384,), torch.bfloat16, 384,
         round(384**-0.5, 6))]
    assert (A.attention_bwd.launches, A.attention_bwd_mma.launches) == (
        (1, 5) if control else (5, 1))


@pytest.mark.parametrize("d", [320, 448, 1024])
def test_control_entry_by_width(d):
    """``_bwd_control``: the mma.sync entry each bf16 kernel width keeps
    (64, 256, and every multiple of 64 above 256 with the width as its
    leading argument), None where no wgmma kernel replaced one."""
    assert A._bwd_control(d) == ("maest_attn_bwd_bf16_dn_mma", (d,))
    assert A._bwd_control(64) == ("maest_attn_bwd_bf16_mma", ())
    assert A._bwd_control(256) == ("maest_attn_bwd_bf16_d256_mma", ())
    for other in (128, 192, d + 32, 16):
        assert A._bwd_control(other) is None


@pytest.mark.parametrize("dtype,d", [(torch.float32, 384),
                                     (torch.bfloat16, 300),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64)])
def test_control_refuses_what_it_has_no_kernel_for(dtype, d):
    """Off the CPU ``attention_bwd_mma`` refuses, before any launch, what
    no mma.sync control kernel takes: fp32, and bf16 at a width that is no
    kernel's (300: the caller pads it to 320) or whose kernel was never
    replaced (128); no launch is counted."""
    x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
    lse = torch.zeros(1, 2, 4, device="meta")
    before = A.attention_bwd_mma.launches
    with pytest.raises(ValueError, match="head_dim 64, 256 or a multiple of "
                       "64 above 256"):
        A.attention_bwd_mma(x, x, x, x, lse, x)
    assert A.attention_bwd_mma.launches == before


def test_control_is_the_plain_version_on_the_cpu():
    """On CPU tensors ``attention_bwd_mma`` at 384 is the plain version and
    counts no launch; the route there is the same plain version."""
    x, g = _inputs(1, 40, 2, 384, seed=5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(torch.bfloat16)
    o, lse = A.attention_reference_lse(q, k, v, 33)
    before = A.attention_bwd_mma.launches
    got = A.attention_bwd_mma(q, k, v, o, lse, do, 33)
    want = A.attention_bwd_reference(q, k, v, o, lse, do, 33)
    route = A.attention_bwd(q, k, v, o, lse, do, 33)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(route, want))
    assert A.attention_bwd_mma.launches == before


def test_entries_name_their_kernels():
    """Read from ``csrc/attention_bwd.cu``: the bf16 _dn entry runs the
    wgmma kernels and exports its scratch, the control the mma.sync _dn
    kernels it ran before."""
    src = (HEADER.parent / "attention_bwd.cu").read_text()

    def body(signature):
        b = src[src.index(signature):]
        return b[:b.index("\n}\n")]
    route = body("int maest_attn_bwd_bf16_dn(")
    assert "launch_bwd_dn_wgmma(dp," in route and "launch_bwd_dn<" not in route
    assert "return bd_scratch_floats(batch, n, heads);" in body(
        "long long maest_attn_bwd_bf16_dn_scratch(")
    control = body("int maest_attn_bwd_bf16_dn_mma(")
    assert "launch_bwd_dn<bf16>(dp," in control and "wgmma" not in control
    assert '#include "attn_bwd_dn_wgmma.cuh"' in src
