"""The fp32 attention kernels' 3xTF32 arithmetic (``csrc/attn_fwd_tf32.cuh``,
``csrc/attn_bwd_tf32.cuh``) emulated on the CPU: ``attention_tf32_reference``
and ``attention_bwd_tf32_reference`` walk the kernels' tiles with every
product split into tf32 parts (round to nearest, ties away from zero),
each part product exact and the sums in fp32. With three products they
hold the fp32 tier's tolerance against the plain versions and the JAX
package's Pallas kernels in interpret mode; with one product (1xTF32, the
planted fault) they miss it, so the tolerance sees a dropped term. Then
the permuted sequence order of the transposed copies (``tf32_pos``) by
index arithmetic over the tf32 ``wgmma`` fragment layouts, and the route
that sends fp32 at head_dim 64 to the tf32 entries or, under the private
hook ``_F32_CONTROL``, to the scalar FMA controls.

Tolerances: ATTN_TOL = 2e-5 absolute (the fp32 tier's, chip_smoke.py and
tests/test_torch_attention.py), lse 1e-4 (chip_smoke.py's LSE_TOL); the
integer products of the permutation test exact. tests/test_torch_cuda.py
holds the kernels to the plain versions on the card."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.ops.attention import _flash_fwd_lse
from maest_tpu.ops.attention import flash_attention as jax_flash
from maest_tpu_torch.ops import attention as A

ATTN_TOL = 2e-5
LSE_TOL = 1e-4


def _inputs(b, n, h, seed):
    """(B, N, 3, H, 64) fused q/k/v and a (B, N, H, 64) output gradient,
    unit normal, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3, h, 64)).astype(np.float32),
            rng.standard_normal((b, n, h, 64)).astype(np.float32))


def _gap(got, want):
    return max((a.double() - b.double()).abs().max().item()
               for a, b in zip(got, want))


def test_tf32_round_is_round_to_nearest_ties_away():
    """tf32_round keeps 10 mantissa bits, rounds to nearest with ties away
    from zero (cvt.rna), carries into the exponent; tf32_split gives hi +
    lo within 2^-22 of x with both parts on the tf32 grid."""
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 2 - ulp / 2, 3.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 2.0,
                         3.0, -0.0])
    assert torch.equal(A.tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32) * 10)
    hi, lo = A.tf32_split(y)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - y).abs() <= y.abs() * 2.0**-22).all()


@pytest.mark.parametrize("n,n_real", [(200, None), (300, 281)],
                         ids=["n200", "n300_real281"])
def test_emulated_forward_holds_the_fp32_tolerance(n, n_real):
    """3xTF32 over the kernel's 64-key tiles against attention_reference_lse
    and against the JAX package's _attn_kernel (interpret mode) within
    2e-5, lse within 1e-4; one tf32 product misses 2e-5."""
    x, _ = _inputs(2, n, 2, seed=11)
    xt = torch.from_numpy(x)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    o, lse = A.attention_tf32_reference(q, k, v, n_real)
    ref, ref_lse = A.attention_reference_lse(q, k, v, n_real)
    assert _gap([o], [ref]) <= ATTN_TOL
    assert _gap([lse], [ref_lse]) <= LSE_TOL
    xj = jnp.asarray(x)
    want = jax_flash(xj[:, :, 0], xj[:, :, 1], xj[:, :, 2], n_real=n_real,
                     interpret=True)
    assert _gap([o], [torch.from_numpy(np.array(want))]) <= ATTN_TOL
    o1, _ = A.attention_tf32_reference(q, k, v, n_real, terms=1)
    assert _gap([o1], [ref]) > ATTN_TOL


@pytest.mark.parametrize("n,n_real", [(200, None), (300, 281)],
                         ids=["n200", "n300_real281"])
def test_emulated_backward_holds_the_fp32_tolerance(n, n_real):
    """3xTF32 over the dq kernel's 32-key tiles and the dk/dv kernel's
    32-row q tiles against attention_bwd_reference and against the JAX
    custom VJP's Pallas backward (interpret mode, on its own forward's o
    and lse) within 2e-5; masked keys exactly zero dk and dv; one tf32
    product misses 2e-5."""
    x, g = _inputs(2, n, 2, seed=12)
    xt = torch.from_numpy(x)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g)
    o, lse = A.attention_reference_lse(q, k, v, n_real)
    got = A.attention_bwd_tf32_reference(q, k, v, o, lse, do, n_real)
    assert _gap(got, A.attention_bwd_reference(q, k, v, o, lse, do,
                                               n_real)) <= ATTN_TOL
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()
    one = A.attention_bwd_tf32_reference(q, k, v, o, lse, do, n_real,
                                         terms=1)
    assert _gap(one, got) > ATTN_TOL

    xj = jnp.asarray(x)
    qj, kj, vj = xj[:, :, 0], xj[:, :, 1], xj[:, :, 2]
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, n_real=n_real,
                                               interpret=True), qj, kj, vj)
    want = [torch.from_numpy(np.array(w)) for w in vjp(jnp.asarray(g))]
    oj, lj = _flash_fwd_lse(qj, kj, vj, block_q=896, block_k=448,
                            interpret=True, n_real=n_real)
    oj = torch.from_numpy(np.array(oj))
    lj = torch.from_numpy(np.asarray(lj).reshape(2, 2, -1)[:, :, :n].copy())
    ours = A.attention_bwd_tf32_reference(q, k, v, oj, lj, do, n_real)
    assert _gap(ours, want) <= ATTN_TOL


def _fragments(x, kj):
    """The tf32 register-A fragments that the kernels pack from the fp32
    accumulator x (64 rows x N columns, its C layout) for the 8-deep
    k-step kj, as the (64 x 8) matrix the product reads: warp w, lane 4 g
    + t holds x[16 w + g + 8 (e >> 1), 8 j + 2 t + (e & 1)] at accumulator
    register (j, e); tf_pack puts registers e = 0, 2, 1, 3 of chunk kj in
    fragment registers r = 0, 1, 2, 3; fragment register r is A's row 16 w
    + g + 8 (r & 1), column (k) t + 4 (r >> 1) (the tf32 A layout of
    m16n8k8, a warp's 16 rows, which the tf32 wgmma shares)."""
    a = np.zeros((64, 8), dtype=np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r, e in enumerate((0, 2, 1, 3)):
                row_acc = 16 * w + g + 8 * (e >> 1)
                col_acc = 8 * kj + 2 * t + (e & 1)
                row_a = 16 * w + g + 8 * (r & 1)
                assert row_acc == row_a  # a thread packs its own rows
                a[row_a, t + 4 * (r >> 1)] = x[row_acc, col_acc]
    return a


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_pos_order_makes_the_accumulator_the_register_a_operand(seed):
    """P.V (the forward), dV += P^T.dO and dK += dS^T.Q (the dk/dv kernel)
    and dQ += dS.K (the dq kernel) on the kernels' operands: the
    accumulator packed as it lies, contracted with the transposed copy in
    the tf32_pos order (_tf32_by_position), gives the plain product over a
    64-deep tile (the forward's key tile; two of the backward's 32-deep
    tiles); in the natural order it does not."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-1000, 1000, size=(64, 64))   # rows x contracted
    y = rng.integers(-1000, 1000, size=(64, 64))   # contracted x d
    want = p @ y
    by_pos = A._tf32_by_position(torch.from_numpy(y), 64).numpy()  # d x pos
    got = sum(_fragments(p, kj) @ by_pos[:, 8 * kj:8 * kj + 8].T
              for kj in range(8))
    assert np.array_equal(got, want)
    natural = sum(_fragments(p, kj) @ y[8 * kj:8 * kj + 8]
                  for kj in range(8))
    assert not np.array_equal(natural, want)


def test_tf32_pos_is_the_kernels_permutation_within_8_row_groups():
    """Row 2 a + c of an 8-row group sits at 4 c + a (tf_pos_of), its
    inverse the kernels' tf_key_at (position p holds row 2 (p % 4) + p //
    4); the transposed copy holds row r at tf32_pos(r), zeros past N."""
    r = torch.arange(64)
    pos = A.tf32_pos(r)
    assert torch.equal(torch.sort(pos).values, r)
    assert torch.equal(pos // 8, r // 8)
    for p in range(8):
        row = ((p & 3) << 1) | (p >> 2)  # tf_key_at
        assert A.tf32_pos(8 + row) == 8 + p
    for a in range(4):
        for c in range(2):
            assert A.tf32_pos(2 * a + c) == 4 * c + a
    x = torch.arange(50 * 3).reshape(50, 3)
    copy = A._tf32_by_position(x, 64)
    assert copy.shape == (3, 64)
    assert torch.equal(copy[:, A.tf32_pos(torch.arange(50))], x.T)
    assert not copy[:, A.tf32_pos(torch.arange(50, 64))].any()


def _fwd_recorder(seen):
    def launch(lib, name, lead, q, k, v, n_real, with_lse, scale):
        seen.append((name, lead, q.dtype, q.shape[-1]))
        b, n, h, d = q.shape
        lse = (torch.empty((b, h, n), device=q.device) if with_lse else None)
        return torch.empty_like(q), lse
    return launch


def _bwd_recorder(seen):
    def launch(name, lead, q, k, v, o, lse, do, n_real, scale):
        seen.append((name, lead, q.dtype, q.shape[-1]))
        return torch.empty(q.shape[:2] + (3,) + q.shape[2:], dtype=q.dtype,
                           device=q.device)
    return launch


@pytest.mark.parametrize("control", [False, True], ids=["tf32", "control"])
def test_fp32_route_names_the_tf32_entries(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launchers replaced by recorders: fp32 at head_dim 64 (and at 16,
    zero-padded to 64) names ``maest_attn_fwd_fp32`` and
    ``maest_attn_bwd_fp32``, the tf32 kernels, counted in
    ``flash_attention``, ``flash_attention_fwd_lse`` and ``attention_bwd``;
    with ``_F32_CONTROL`` it names the scalar FMA controls
    ``maest_attn_fwd_fp32_fma`` and ``maest_attn_bwd_fp32_fma``, counted
    in ``attention_fwd_fp32_fma`` and ``attention_bwd_fp32_fma``. bf16,
    fp32 at head_dim 128 and 320 keep their entries either way."""
    seen_f, seen_b = [], []
    monkeypatch.setattr(A, "launch_fwd_entry", _fwd_recorder(seen_f))
    monkeypatch.setattr(A, "launch_bwd_entry", _bwd_recorder(seen_b))
    monkeypatch.setattr(A, "_F32_CONTROL", control)
    for f in (A.flash_attention, A.flash_attention_fwd_lse, A.attention_bwd,
              A.attention_fwd_fp32_fma, A.attention_bwd_fp32_fma):
        monkeypatch.setattr(f, "launches", 0)
    cases = ((torch.float32, 64), (torch.float32, 16), (torch.bfloat16, 64),
             (torch.float32, 128), (torch.float32, 320))
    for dtype, d in cases:
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        lse = torch.zeros(1, 2, 4, device="meta")
        assert A.flash_attention(x, x, x).shape == x.shape
        o, lse_out = A.flash_attention_fwd_lse(x, x, x)
        assert o.shape == x.shape and lse_out.shape == (1, 2, 4)
        assert all(t.shape == x.shape
                   for t in A.attention_bwd(x, x, x, x, lse, x))
    fwd = "maest_attn_fwd_fp32_fma" if control else "maest_attn_fwd_fp32"
    bwd = "maest_attn_bwd_fp32_fma" if control else "maest_attn_bwd_fp32"
    want_f = [(fwd, (), torch.float32, 64)] * 4 + [
        ("maest_attn_fwd_bf16", (), torch.bfloat16, 64)] * 2 + [
        ("maest_attn_fwd_fp32_d128", (), torch.float32, 128)] * 2 + [
        ("maest_attn_fwd_fp32_dn", (320,), torch.float32, 320)] * 2
    want_b = [(bwd, (), torch.float32, 64)] * 2 + [
        ("maest_attn_bwd_bf16", (), torch.bfloat16, 64),
        ("maest_attn_bwd_fp32_d128", (), torch.float32, 128),
        ("maest_attn_bwd_fp32_dn", (320,), torch.float32, 320)]
    assert seen_f == want_f and seen_b == want_b
    counts = (A.flash_attention.launches, A.flash_attention_fwd_lse.launches,
              A.attention_bwd.launches, A.attention_fwd_fp32_fma.launches,
              A.attention_bwd_fp32_fma.launches)
    assert counts == ((3, 3, 3, 4, 2) if control else (5, 5, 5, 0, 0))
    assert A._K2_CONTROL is False and A._K3B_CONTROL is False


def test_controls_take_the_plain_version_on_the_cpu():
    """The fp32 controls on CPU tensors are the plain versions and count no
    launch; the tf32 entries' scratch is sized by the library, the
    control's is delta (B, H, N)."""
    x, g = _inputs(1, 50, 2, seed=13)
    xt = torch.from_numpy(x)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g)
    before = (A.attention_fwd_fp32_fma.launches,
              A.attention_bwd_fp32_fma.launches)
    o, lse = A.attention_fwd_fp32_fma(q, k, v, 45, with_lse=True)
    want_o, want_lse = A.attention_reference_lse(q, k, v, 45)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert A.attention_fwd_fp32_fma(q, k, v, 45)[1] is None
    got = A.attention_bwd_fp32_fma(q, k, v, o, lse, do, 45)
    want = A.attention_bwd_reference(q, k, v, o, lse, do, 45)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (A.attention_fwd_fp32_fma.launches,
            A.attention_bwd_fp32_fma.launches) == before
    assert A._bwd_scratch(None, "maest_attn_bwd_fp32_fma", 2, 50, 3) == 300
    # the tf32 entries export X_scratch (a stand-in library); the controls
    # do not
    lib = types.SimpleNamespace(
        maest_attn_fwd_fp32_scratch=lambda b, n, h: 11,
        maest_attn_bwd_fp32_scratch=lambda b, n, h: 13)
    assert A._scratch_floats(lib, "maest_attn_fwd_fp32", 2, 50, 3) == 11
    assert A._scratch_floats(lib, "maest_attn_fwd_fp32_fma", 2, 50, 3) is None
    assert A._bwd_scratch(lib, "maest_attn_bwd_fp32", 2, 50, 3) == 13
    assert A._bwd_scratch(lib, "maest_attn_bwd_fp32_fma", 2, 50, 3) == 300
