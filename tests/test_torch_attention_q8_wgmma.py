"""The ``wgmma`` route of the 8-bit attention forwards (K5: "qk8",
"qk8pv8"; K6: "fp8", "fp8pv8"; ``csrc/attn_fwd_q8_wgmma.cuh``, bf16 at
head_dim 64) on the CPU: the plain version of its quantisation pass
(``q8_pass_reference``: the layouts the pass writes) against
``quantize_rows`` / ``to_e4m3``, the JAX package's casts and the
``seq_pos`` order; the route's plain version, ``attention_q8_reference``
at the route's 128-key tile (``q8_block_k``), against the JAX package's
``flash_attention`` / ``_flash_fwd_lse`` in interpret mode on the same
128-key blocks; the route naming the wgmma entries and, under the private
hook ``_Q8_CONTROL``, the ``mma.sync`` control; the control's plain
version on the CPU.

Tolerances: the pass's layouts exact (its codes are integers or e4m3
bytes; its scales the same fp32 divisions). Against the Pallas kernel,
those of tests/test_torch_attention_q8.py for bf16 inputs on the same key
blocks: o within one bf16 ulp (rtol 2^-7: the fp32 sums run in other
orders and the last rounding to bf16 may go the other way) and atol 1e-4
(XLA's exp2 on the CPU differs from PyTorch's by a few ulps, which can
flip the rounding of one 8-bit or bf16 p); lse within 1e-5 (fp32
log2-sum-exp over the same blocks). tests/test_torch_cuda.py and
chip_smoke.py (phases 13 and 35) hold the kernel to this plain version on
the card."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.ops import attention as J
from maest_tpu_torch.ops import attention as A

MODES = ("qk8", "qk8pv8", "fp8", "fp8pv8")
O_TOL = dict(rtol=2**-7, atol=1e-4)
LSE_TOL = 1e-5


def _qkv(b, n, h, seed, scale=0.5):
    """(B, N, 3, H, 64) fused q/k/v, normal x scale, drawn with numpy."""
    return (np.random.default_rng(seed).standard_normal((b, n, 3, h, 64))
            * scale).astype(np.float32)


def _split(x):
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def _wrapper(mode):
    return A.attention_fwd_int8 if mode.startswith("qk8") else A.attention_fwd_fp8


def _same(a, b):
    """torch.equal, NaN equal to NaN (the e4m3 overflow)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


# --- the quantisation pass's layouts ---------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_pass_layouts_are_the_quantisation_in_seq_pos_order(mode):
    """``q8_pass_reference`` on bf16 (B, N, H, 64) at N 150 (N_pad 256),
    with an all-zero q row and k row (the 1e-30 floor keeps their scales
    finite and their codes 0), and q, k, v values of 450 and 464 (e4m3:
    448) and 466, 470 (e4m3: NaN): q8, k8 are ``quantize_rows``' codes
    (uint8) or ``to_e4m3``'s values (as bf16, which the kernel multiplies
    on bf16 tensor cores) of each head's rows, and the JAX package's
    ``_quantize_rows`` / e4m3 cast, with zero rows past N; qsl, sk the
    rows' scales (q's times scale log2(e)), zero past N; vmax max|v| a
    column; v8t v's codes with row r at column ``seq_pos(r)``, zeros past
    N. ``q8_pass_views`` reads the same dict back from the buffers in the
    route's order."""
    b, n, h = 2, 150, 3
    x = _qkv(b, n, h, seed=40, scale=1.0)
    x[0, 7, 0, 1] = 0.0       # an all-zero q row
    x[1, 30, 1, 2] = 0.0      # and k row
    x[0, 3, 0, 0, 5] = 450.0
    x[0, 4, 1, 0, 9] = 464.0
    x[1, 5, 0, 2, 1] = 466.0
    x[1, 6, 1, 1, 0] = -470.0
    x[0, 8, 2, 0, 3] = 450.0
    x[1, 9, 2, 1, 2] = 470.0
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = _split(xt)
    got = A.q8_pass_reference(q, k, v, mode)
    n_pad = A.q8_n_pad(n)
    assert n_pad == 256
    rows = lambda t: t.transpose(1, 2).reshape(b * h, n, 64)  # noqa: E731
    int8 = mode.startswith("qk8")
    for name, t in (("q8", q), ("k8", k)):
        plane = got[name]
        assert plane.shape == (b * h, n_pad, 64) and plane.dtype == (
            torch.uint8 if int8 else torch.bfloat16)
        assert not plane[:, n:].any()
        if int8:
            codes, scales = A.quantize_rows(rows(t))
            assert torch.equal(plane[:, :n], codes.view(torch.uint8))
            rj, sj = J._quantize_rows(jnp.asarray(rows(t).float().numpy()))
            assert np.array_equal(plane[:, :n].view(torch.int8).numpy(),
                                  np.asarray(rj))
            want = scales * (64**-0.5 * A._LOG2E) if name == "q8" else scales
            row = got["qsl" if name == "q8" else "sk"]
            assert row.shape == (b * h, n_pad) and row.dtype == torch.float32
            assert torch.equal(row[:, :n], want) and not row[:, n:].any()
            assert np.array_equal(scales.numpy(), np.asarray(sj))
        else:
            e4 = plane[:, :n].float()
            assert _same(e4, A.to_e4m3(rows(t)).float())
            ej = np.asarray(jnp.asarray(rows(t).float().numpy()).astype(
                jnp.float8_e4m3fn).astype(jnp.float32))
            assert np.array_equal(np.isnan(e4.numpy()), np.isnan(ej))
            assert np.array_equal(np.nan_to_num(e4.numpy()), np.nan_to_num(ej))
            assert got["qsl"] is None and got["sk"] is None
    if int8:  # the all-zero rows: the floor, codes 0
        zq, zk = 0 * h + 1, 1 * h + 2
        assert not got["q8"][zq, 7].any() and not got["k8"][zk, 30].any()
        assert got["sk"][zk, 30].item() == np.float32(1e-30) / np.float32(127)
    else:  # 450 and 464 -> 448; 466, 470 -> NaN
        qe, ke = got["q8"].float(), got["k8"].float()
        assert qe[0 * h + 0, 3, 5].item() == 448.0
        assert ke[0 * h + 0, 4, 9].item() == 448.0
        assert torch.isnan(qe[1 * h + 2, 5, 1]) and torch.isnan(ke[1 * h + 1, 6, 0])
    if mode.endswith("pv8"):
        vt = got["v8t"]
        assert vt.shape == (b * h, 64, n_pad) and vt.dtype == torch.uint8
        pos = A.seq_pos(torch.arange(n))
        assert not vt[:, :, A.seq_pos(torch.arange(n, n_pad))].any()
        if mode == "qk8pv8":
            vmax = rows(v).float().abs().amax(dim=1)
            assert torch.equal(got["vmax"], vmax)
            sv = A._div(torch.clamp_min(vmax, 1e-30), 127.0)
            codes = torch.round(rows(v).float() / sv[:, None]).to(torch.int8)
            assert torch.equal(vt[:, :, pos], codes.view(torch.uint8).transpose(1, 2))
        else:
            assert got["vmax"] is None
            ve = vt[:, :, pos].view(torch.float8_e4m3fn).float()
            assert _same(ve, A.to_e4m3(rows(v)).float().transpose(1, 2))
            assert ve[0 * h + 0, 3, 8].item() == 448.0
            assert torch.isnan(ve[1 * h + 1, 2, 9])
    else:
        assert got["v8t"] is None and got["vmax"] is None
    # the buffers in the route's order read back as the same dict
    bh = b * h
    planes = [got["q8"].reshape(-1).view(torch.uint8),
              got["k8"].reshape(-1).view(torch.uint8),
              (got["v8t"] if got["v8t"] is not None
               else torch.zeros(bh, 64, n_pad, dtype=torch.uint8)).reshape(-1)]
    floats = [t.reshape(-1) if t is not None else torch.zeros(size)
              for t, size in ((got["qsl"], bh * n_pad), (got["sk"], bh * n_pad),
                              (got["vmax"], bh * 64))]
    views = A.q8_pass_views(torch.cat(planes), torch.cat(floats), b, n, h, mode)
    for name, t in got.items():
        assert (views[name] is None) == (t is None), name
        if t is not None:
            assert _same(views[name].float(), t.float()), name


def _fragments(x, kk):
    """The 8-bit register-A fragment a consumer packs (``pack_a``) from its
    accumulator x (64 rows x 128 key columns, the C layout of an m64n128
    product) for the 32-key k-step kk, as the (64 x 32) matrix it forms:
    thread (w, g, t) holds x[16 w + g + 8 (e >> 1), 8 j + 2 t + (e & 1)]
    at register (j, e); register r, byte i of the fragment is that of
    n-tile 4 kk + 2 (r >> 1) + (i >> 1), e = 2 (r & 1) + (i & 1), and
    stands at A's row 16 w + g + 8 (r & 1), k 16 (r >> 1) + 4 t + i."""
    a = np.zeros((64, 32), dtype=np.int64)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for r in range(4):
                    for i in range(4):
                        j = 4 * kk + 2 * (r >> 1) + (i >> 1)
                        e = 2 * (r & 1) + (i & 1)
                        row = 16 * w + g + 8 * (e >> 1)
                        assert row == 16 * w + g + 8 * (r & 1)
                        a[row, 16 * (r >> 1) + 4 * t + i] = x[row,
                                                              8 * j + 2 * t + (e & 1)]
    return a


@pytest.mark.parametrize("seed", [0, 1])
def test_v8t_in_seq_pos_order_meets_the_packed_scores(seed):
    """P8.V8 over one 128-key tile as the kernel forms it: the score
    accumulator's p8 codes packed as they lie, four k-steps of 32 keys,
    against the pass's v8^T (``_by_position``, the seq_pos order), is the
    plain integer product; against v8 in the natural order it is not."""
    rng = np.random.default_rng(seed)
    p8 = rng.integers(0, 128, size=(64, 128))      # q rows x keys
    v8 = rng.integers(-127, 128, size=(128, 64))   # keys x d
    want = p8 @ v8
    vt = A._by_position(torch.from_numpy(v8), 128).numpy()  # d x positions
    got = sum(_fragments(p8, kk) @ vt[:, 32 * kk:32 * kk + 32].T
              for kk in range(4))
    assert np.array_equal(got, want)
    natural = sum(_fragments(p8, kk) @ v8[32 * kk:32 * kk + 32]
                  for kk in range(4))
    assert not np.array_equal(natural, want)


# --- the route's plain version against the JAX package's kernel -------------

@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o_lse"])
@pytest.mark.parametrize("mode", MODES)
def test_route_plain_version_matches_jax_on_128_key_blocks(mode, with_lse):
    """bf16 (2, 300, 2, 64) with n_real 290 (three key tiles, the last one
    partly masked) through the public wrapper on the CPU, which runs the
    route's plain version (``attention_q8_reference`` at ``q8_block_k`` =
    128), against ``flash_attention`` (o) and ``_flash_fwd_lse`` (o, lse)
    of the JAX package in interpret mode with block_q = block_k = 128; the
    64-key plain version (the control's) lies farther from the Pallas
    kernel in the pv8 modes."""
    b, n, h, n_real = 2, 300, 2, 290
    x = _qkv(b, n, h, seed=41)
    q, k, v = _split(torch.from_numpy(x).to(torch.bfloat16))
    assert A.q8_block_k(q) == A.Q8_WG_BLOCK_K == 128
    o, lse = _wrapper(mode)(q, k, v, n_real, mode.endswith("pv8"),
                            with_lse=with_lse)
    ro, rlse = A.attention_q8_reference(q, k, v, n_real, mode, block_k=128)
    assert torch.equal(o, ro) and o.dtype == torch.bfloat16
    xj = _split(jnp.asarray(x).astype(jnp.bfloat16))
    if with_lse:
        oj, lj = J._flash_fwd_lse(*xj, block_q=128, block_k=128,
                                  interpret=True, quant=mode, n_real=n_real)
        lj = np.asarray(lj).reshape(b, h, -1)[:, :, :n]
        np.testing.assert_allclose(lse.numpy(), lj, rtol=0, atol=LSE_TOL)
        assert torch.equal(lse, rlse)
    else:
        assert lse is None
        oj = J.flash_attention(*xj, block_q=128, block_k=128, interpret=True,
                               quant=mode, n_real=n_real)
    oj = np.asarray(jnp.asarray(oj).astype(jnp.float32))
    np.testing.assert_allclose(o.float().numpy(), oj, **O_TOL)
    if mode.endswith("pv8"):
        o64, _ = A.attention_q8_reference(q, k, v, n_real, mode, block_k=64)
        assert (np.abs(o64.float().numpy() - oj).max()
                > np.abs(o.float().numpy() - oj).max())


# --- the route -------------------------------------------------------------

@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_route_names_the_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: every 8-bit mode in bf16 at
    head_dim 64 (and at 16, zero-padded to 64) names the wgmma entry
    ``maest_attn_fwd_<mode>``, counted in ``attention_fwd_int8`` /
    ``attention_fwd_fp8``; under ``_Q8_CONTROL`` it names
    ``maest_attn_fwd_<mode>_mma``, counted in ``attention_fwd_q8_mma``. fp32
    and head_dim 128 keep their mma.sync instances either way, and the
    other hooks are untouched."""
    seen = []

    def record(q, k, v, n_real, with_lse, scale, quant, control=False):
        seen.append((A.q8_entry(quant, q.dtype, q.shape[-1], control),
                     with_lse))
        b, n, h, d = q.shape
        lse = torch.empty((b, h, n), device=q.device) if with_lse else None
        return torch.empty_like(q), lse

    monkeypatch.setattr(A, "_launch_fwd_q8", record)
    monkeypatch.setattr(A, "_Q8_CONTROL", control)
    for f in (A.attention_fwd_int8, A.attention_fwd_fp8,
              A.attention_fwd_q8_mma):
        monkeypatch.setattr(f, "launches", 0)
    want = []
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 16),
                     (torch.float32, 64), (torch.bfloat16, 128)):
        x = torch.zeros(1, 4, 2, d, dtype=dtype, device="meta")
        for mode in MODES:
            o, lse = _wrapper(mode)(x, x, x, None, mode.endswith("pv8"),
                                    with_lse=True)
            assert o.shape == x.shape and lse.shape == (1, 2, 4)
            wg = dtype == torch.bfloat16 and d <= 64
            suffix = ("_mma" if control else "") if wg else (
                "_fp32" if dtype == torch.float32 else "_d128")
            want.append(((f"maest_attn_fwd_{mode}{suffix}", ()), True))
    assert seen == want
    routed = 8 if control else 0
    assert (A.attention_fwd_int8.launches, A.attention_fwd_fp8.launches,
            A.attention_fwd_q8_mma.launches) == (8 - routed // 2,
                                                8 - routed // 2, routed)
    assert A._K2_CONTROL is False and A._K7_CONTROL is False
    assert A.q8_entry("fp8pv8", torch.bfloat16, 384) == (
        "maest_attn_fwd_fp8pv8_dn", (384,))
    # the route's scratch, by the libraries' rule (a stand-in library)
    lib = types.SimpleNamespace(maest_attn_fwd_qk8_bytes=lambda b, n, h: 7,
                                maest_attn_fwd_qk8_scratch=lambda b, n, h: 9)
    bytes8, scratch = A._q8_scratch(lib, "maest_attn_fwd_qk8",
                                    torch.zeros(1, 4, 2, 64))
    assert (bytes8.shape, bytes8.dtype) == ((7,), torch.uint8)
    assert (scratch.shape, scratch.dtype) == ((9,), torch.float32)


def test_control_takes_plain_version_on_the_cpu():
    """``attention_fwd_q8_mma`` on CPU tensors is the plain version at the
    control's 64-key tile in every mode (o, and lse with it) and counts no
    launch; an unquantised call is refused."""
    x = _qkv(1, 200, 2, seed=42)
    q, k, v = _split(torch.from_numpy(x).to(torch.bfloat16))
    before = A.attention_fwd_q8_mma.launches
    for mode in MODES:
        o, none = A.attention_fwd_q8_mma(q, k, v, 190, mode)
        o2, lse = A.attention_fwd_q8_mma(q, k, v, 190, mode, with_lse=True)
        ro, rlse = A.attention_q8_reference(q, k, v, 190, mode, A.Q8_BLOCK_K)
        assert none is None and torch.equal(o, ro) and torch.equal(o2, ro)
        assert torch.equal(lse, rlse)
    assert A.attention_fwd_q8_mma.launches == before
    with pytest.raises(ValueError, match="8-bit mode"):
        A.attention_fwd_q8_mma(q, k, v, 190, None)
