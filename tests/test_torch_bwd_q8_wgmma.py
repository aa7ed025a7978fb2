"""The plain version of the ``wgmma`` K7's schedule
(``attention_bwd_int8_tiled_reference``: the int8 backward walked over the
kernel's key and q tiles, its operands in the kernel's permuted order)
against ``attention_bwd_int8_reference`` and against the JAX package's
``_flash_bwd_q8`` in interpret mode; the permuted sequence order
(``seq_pos``) by index arithmetic over the s8 ``wgmma`` fragments; and the
route that sends the int8 backward in bf16 at head_dim 64 to the wgmma
kernels or, under the private hook ``_K7_CONTROL``, to their mma.sync
control.

Tolerances: against ``attention_bwd_int8_reference`` exact (torch.equal):
every product is an integer sum, exact in float64, and every other step
the same fp32 arithmetic in the same order. Against the Pallas kernel the
bounds of tests/test_torch_attention_q8.py (XLA's exp2 on the CPU differs
from PyTorch's by up to 17 ulp, which flips the rounding of a few p8 / ds8
codes): every gradient within 1e-3 of its max except at most four rows,
all within 1e-2, and closer to JAX's int8 gradients than JAX's int8
gradients are to its bf16 ones. tests/test_torch_cuda.py holds the kernel
to this plain version on the card."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.ops import attention as J
from maest_tpu_torch.ops import attention as A


def _inputs(b, n, h, seed, scale=0.5):
    """(B, N, 3, H, 64) fused q/k/v (normal x scale) and a (B, N, H, 64)
    output gradient, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n, 3, h, 64)) * scale).astype(np.float32),
            rng.standard_normal((b, n, h, 64)).astype(np.float32))


def _fragments(x, kk):
    """The s8 register-A fragments that the kernel packs from the s32
    accumulator x (64 rows x 64 columns, its C layout) for the 32-deep
    k-step kk, as the (64 x 32) matrix they form: warp w, lane 4 g + t
    holds x[16 w + g + 8 (e >> 1), 8 j + 2 t + (e & 1)] at accumulator
    register (j, e); pack_a puts the codes of n-tiles 4 kk + 2 (r >> 1) +
    {0, 1} of register r of the fragment in its bytes i = 2 (i >> 1) + (i
    & 1) as (n-tile 4 kk + 2 (r >> 1) + (i >> 1), e = 2 (r & 1) + (i &
    1)); the fragment's register r, byte i is A's row 16 w + g + 8 (r & 1),
    column (k) 16 (r >> 1) + 4 t + i (mma.sync's m16n8k32 A layout a warp,
    which the s8 wgmma shares)."""
    a = np.zeros((64, 32), dtype=np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in range(4):
                for i in range(4):
                    j = 4 * kk + 2 * (r >> 1) + (i >> 1)
                    e = 2 * (r & 1) + (i & 1)
                    row_acc = 16 * w + g + 8 * (e >> 1)
                    col_acc = 8 * j + 2 * t + (e & 1)
                    row_a = 16 * w + g + 8 * (r & 1)
                    assert row_acc == row_a  # a thread packs its own rows
                    a[row_a, 16 * (r >> 1) + 4 * t + i] = x[row_acc, col_acc]
    return a


@pytest.mark.parametrize("seed", [0, 1])
def test_seq_pos_order_makes_the_accumulator_the_register_a_operand(seed):
    """dV += P8^T.dO8 on the kernel's operands: the accumulator of S^T
    packed as it lies (p8^T, keys x q rows) contracted with the transposed
    copy of dO8 in the seq_pos order (``_by_position``) gives the plain
    integer product over a 64-row q tile; in the natural order it does
    not."""
    rng = np.random.default_rng(seed)
    p8 = rng.integers(-127, 128, size=(64, 64))   # keys x q rows
    do8 = rng.integers(-127, 128, size=(64, 64))  # q rows x d
    want = p8 @ do8
    by_pos = A._by_position(torch.from_numpy(do8), 64).numpy()  # d x positions
    got = sum(_fragments(p8, kk) @ by_pos[:, 32 * kk:32 * kk + 32].T
              for kk in range(2))
    assert np.array_equal(got, want)
    natural = sum(_fragments(p8, kk) @ do8[32 * kk:32 * kk + 32]
                  for kk in range(2))
    assert not np.array_equal(natural, want)


def test_seq_pos_is_a_permutation_within_16_row_groups():
    """Row 8 a + 2 t + c of a 16-row group sits at 4 t + 2 a + c, and the
    transposed copy holds row r at seq_pos(r), zeros past N."""
    r = torch.arange(128)
    pos = A.seq_pos(r)
    assert torch.equal(torch.sort(pos).values, r)
    assert torch.equal(pos // 16, r // 16)
    for a in range(2):
        for t in range(4):
            for c in range(2):
                assert A.seq_pos(16 + 8 * a + 2 * t + c) == 16 + 4 * t + 2 * a + c
    x = torch.arange(50 * 3).reshape(50, 3)
    copy = A._by_position(x, 64)
    assert copy.shape == (3, 64)
    assert torch.equal(copy[:, A.seq_pos(torch.arange(50))], x.T)
    assert not copy[:, A.seq_pos(torch.arange(50, 64))].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,h,n_real", [(1, 200, 2, None), (2, 300, 1, 281),
                                          (1, 1200, 1, 1190)],
                         ids=["n200", "n300_real281", "n1200_2blocks"])
def test_tiled_reference_equals_the_int8_reference(b, n, h, n_real, dtype):
    """The plain version of the wgmma schedule is the int8 backward's plain
    version, bit for bit (N 1200: two 640-row q-blocks of scales, so dk
    and dv fold at a q-block boundary)."""
    x, g = _inputs(b, n, h, seed=n)
    xt = torch.from_numpy(x).to(dtype)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(dtype)
    o, lse = A.attention_reference_lse(q, k, v, n_real)
    assert (n == 1200) == (-(-n // A.bwd_q_block(n)) == 2)
    got = A.attention_bwd_int8_tiled_reference(q, k, v, o, lse, do, n_real)
    want = A.attention_bwd_int8_reference(q, k, v, o, lse, do, n_real)
    for a, w in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, w)
    if n_real is not None:
        assert not got[1][:, n_real:].any() and not got[2][:, n_real:].any()


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("b,n,h,n_real", [(1, 200, 2, None), (1, 300, 2, 290),
                                          (1, 1200, 1, 1190)],
                         ids=["n200", "n300_real290", "n1200_2blocks"])
def test_tiled_reference_matches_jax_flash_bwd_q8(b, n, h, n_real):
    """Identical (q, k, v, o, lse, do) into the JAX package's _flash_bwd_q8
    (its Pallas kernel in interpret mode, the TPU's q-blocks) and the
    tiled plain version."""
    x, g = _inputs(b, n, h, seed=40 + n)
    q, k, v = (jnp.asarray(x[:, :, i]) for i in range(3))
    o, lse = J._flash_fwd_lse(q, k, v, block_q=896, block_k=448,
                              interpret=True, n_real=n_real, bwd_quant="int8")
    bq = J._pick_bwd_block(-(-n // 128) * 128)
    assert A.bwd_q_block(n) == bq
    ref = J._flash_bwd_q8(q, k, v, o, lse, jnp.asarray(g), block_q=bq,
                          interpret=True, n_real=n_real)
    ref16 = J._flash_bwd(q, k, v, o, lse, jnp.asarray(g), block_q=bq,
                         block_k=1 << 30, interpret=True, n_real=n_real)
    xt = torch.from_numpy(x)
    lse_t = torch.from_numpy(np.array(lse)).reshape(b, h, -1)[:, :, :n]
    ours = A.attention_bwd_int8_tiled_reference(
        xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], torch.from_numpy(np.array(o)),
        lse_t.contiguous(), torch.from_numpy(g), n_real)
    for name, a, r, r16 in zip(("dq", "dk", "dv"), ours, ref, ref16):
        a, r, r16 = a.float().numpy(), _f32(r), _f32(r16)
        top = np.abs(r).max()
        err = np.abs(a - r)
        assert int((err.max(axis=-1) > 1e-3 * top).sum()) <= 4, name
        assert err.max() <= 1e-2 * top, (name, err.max() / top)
        assert err.max() < np.abs(r16 - r).max(), name
    if n_real is not None:
        assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_int8_backward_route_names_the_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: the int8 backward in bf16 at
    head_dim 64 (and at 16, zero-padded to 64) takes the route's entry
    (the launcher's default, ``maest_attn_bwd_q8``: the wgmma kernels),
    counted in ``attention_bwd_int8``; with ``_K7_CONTROL`` it names
    ``maest_attn_bwd_q8_mma``, counted in ``attention_bwd_int8_mma``. fp32
    and head_dim 128 keep their instances either way, and the bf16
    backward's route is not moved by the hook."""
    seen = []

    def record(q, k, v, o, lse, do, n_real, scale, name=None):
        seen.append((name, q.dtype, q.shape[-1]))
        b, n, h, d = q.shape
        return torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)

    monkeypatch.setattr(A, "_launch_bwd_q8", record)
    monkeypatch.setattr(A, "_K7_CONTROL", control)
    monkeypatch.setattr(A.attention_bwd_int8, "launches", 0)
    monkeypatch.setattr(A.attention_bwd_int8_mma, "launches", 0)
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 16),
                     (torch.float32, 64), (torch.bfloat16, 128)):
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        lse = torch.zeros(1, 2, 4, device="meta")
        grads = A.attention_bwd_int8(x, x, x, x, lse, x)
        assert all(t.shape == x.shape for t in grads)
    k7 = "maest_attn_bwd_q8_mma" if control else None
    assert seen == [(k7, torch.bfloat16, 64), (k7, torch.bfloat16, 64),
                    (None, torch.float32, 64), (None, torch.bfloat16, 128)]
    assert (A.attention_bwd_int8.launches,
            A.attention_bwd_int8_mma.launches) == ((2, 2) if control
                                                  else (4, 0))
    assert A._K3B_CONTROL is False
    # the route's entry at head_dim 64 is the one whose scratch the library
    # sizes (X_scratch; a stand-in library), the fp32 instance's is delta
    assert A._instance("maest_attn_bwd_q8", 64) == ("maest_attn_bwd_q8", ())
    lib = types.SimpleNamespace(maest_attn_bwd_q8_scratch=lambda b, n, h: 9)
    assert A._scratch_floats(lib, "maest_attn_bwd_q8", 1, 4, 2) == 9
    assert A._scratch_floats(lib, "maest_attn_bwd_q8_fp32", 1, 4, 2) is None


def test_control_takes_plain_version_on_the_cpu():
    """``attention_bwd_int8_mma`` on CPU tensors is the int8 backward's
    plain version and counts no launch."""
    x, g = _inputs(1, 90, 2, seed=13)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    do = torch.from_numpy(g).to(torch.bfloat16)
    o, lse = A.attention_reference_lse(q, k, v, 80)
    before = A.attention_bwd_int8_mma.launches
    got = A.attention_bwd_int8_mma(q, k, v, o, lse, do, 80)
    want = A.attention_bwd_int8_reference(q, k, v, o, lse, do, 80)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert A.attention_bwd_int8_mma.launches == before


@pytest.mark.parametrize("d", [64, 128])
def test_k7_delta_sums_in_the_kernels_order(d):
    """``k7_delta``, the fp32 K7's delta, equals a scalar loop in the quant
    pass's order (four lanes of 16 columns of each 64, FMA as the product
    and sum in float64 rounded to fp32, then (0 + 1) + (2 + 3)) and lies
    within fp32's summation bound (d eps sum |do o|) of plain's delta; the
    int8 backward's plain version
    given plain's delta is the one that sums its own, bit for bit."""
    rng = np.random.default_rng(21 + d)
    o = rng.standard_normal((1, 6, 2, d)).astype(np.float32)
    do = rng.standard_normal((1, 6, 2, d)).astype(np.float32)
    got = A.k7_delta(torch.from_numpy(o), torch.from_numpy(do))
    assert got.shape == (1, 2, 6) and got.dtype == torch.float32
    want = np.empty((1, 2, 6), np.float32)
    for h in range(2):
        for n in range(6):
            lanes = []
            for j in range(4):
                acc = np.float32(0)
                for hh in range(d // 64):
                    for i in range(16):
                        c = hh * 64 + 16 * j + i
                        acc = np.float32(np.float64(do[0, n, h, c])
                                         * np.float64(o[0, n, h, c])
                                         + np.float64(acc))
                lanes.append(acc)
            want[0, h, n] = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    assert np.array_equal(got.numpy(), want)
    prod = (torch.from_numpy(do) * torch.from_numpy(o)).transpose(1, 2)
    bound = d * torch.finfo(torch.float32).eps * prod.abs().sum(-1)
    assert ((got - prod.sum(-1)).abs() <= bound).all()

    x, g = _inputs(1, 90, 2, seed=14)
    xt = torch.from_numpy(x)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    gt = torch.from_numpy(g)
    o, lse = A.attention_reference_lse(q, k, v, 80)
    own = A.attention_bwd_int8_reference(q, k, v, o, lse, gt, 80)
    given = A.attention_bwd_int8_reference(
        q, k, v, o, lse, gt, 80,
        delta=(gt * o).sum(-1).transpose(1, 2))
    assert all(torch.equal(a, b) for a, b in zip(own, given))
