"""The port's 8-bit attention modes against the JAX package's, on the CPU:
the int8 / e4m3 forward (K5, K6: ``quant`` "qk8", "qk8pv8", "fp8",
"fp8pv8") and the int8 backward (K7: ``bwd_quant="int8"``), with the
Pallas kernels in interpret mode, as the JAX package's own tests run them.

Tolerances, and why:

* quantization (int8 values, scales, e4m3 casts): exact.
* forward, the same key blocks on both sides (``block_k=128``): fp32 atol
  1e-4 (measured <= 2e-7; the bound leaves room for an exp2 ulp that
  flips the rounding of one 8-bit p); bf16 outputs one bf16 ulp (rtol
  2^-7: the fp32 sums are taken in other orders, and the last rounding to
  bf16 may then go the other way), atol 1e-4 (the same flip of one p
  rounded to bf16 moves a small output by up to ~5e-5, measured).
* forward with the port's own 64-key tile against the fp32 oracle: the
  JAX test's band for each mode (tests/test_flash_attention.py).
* lse: 1e-5 (fp32 log2-sum-exp, the same blocks).
* the int8 backward: XLA's exp2 on the CPU differs from PyTorch's by up to
  17 ulp (measured on 10^6 inputs), which flips the rounding of a few of
  the millions of p8 / ds8 values; one flip moves one int8 term, so one row
  of dq and one of dk / dv. So: every gradient within 1e-3 of its max
  except at most four rows, all within 1e-2, and closer to JAX's int8
  gradients than JAX's int8 gradients are to its bf16 ones.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.ops import attention as A
from maest_tpu_torch.ops.attention import (
    attention_bwd_int8,
    attention_bwd_int8_reference,
    attention_fwd_fp8,
    attention_fwd_int8,
    attention_bwd_reference,
    attention_q8_reference,
    bwd_q_block,
    flash_attention,
    flash_attention_fwd_lse,
    quantize_rows,
    quantize_tensor,
    to_e4m3,
)

MODES = ("qk8", "qk8pv8", "fp8", "fp8pv8")
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# tests/test_flash_attention.py: each mode against the fp32 oracle
BAND = {"qk8": 6e-4, "qk8pv8": 2e-3, "fp8": 3e-3, "fp8pv8": 2e-2}
FWD_TOL = {torch.float32: dict(rtol=0, atol=1e-4),
           torch.bfloat16: dict(rtol=2**-7, atol=1e-4)}
GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _qkv(b, n, h, seed, scale=0.5, d=64):
    return (np.random.default_rng(seed).standard_normal(
        (b, n, 3, h, d)) * scale).astype(np.float32)


def _split(x):
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --- quantization --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_quantize_rows_and_tensor_match_jax(dtype):
    x = np.random.default_rng(0).standard_normal((3, 40, 64)).astype("f4")
    x[1, 7] = 0.0  # an all-zero row: the 1e-30 floor keeps it finite
    x[2] = 0.0     # an all-zero tensor slice
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(JNP[dtype])
    q8, s = quantize_rows(xt)
    rq8, rs = A._quantize_rows(xj)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(rq8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    for i in range(3):
        t8, ts = quantize_tensor(xt[i])
        r8, r = A._q8_tensor(xj[i])
        np.testing.assert_array_equal(t8.numpy(), np.asarray(r8))
        assert ts.item() == float(r)
    # the per-slice form used by the backward equals the whole-tensor one
    t8, ts = quantize_tensor(xt, dim=(1, 2))
    for i in range(3):
        np.testing.assert_array_equal(t8[i].numpy(),
                                      quantize_tensor(xt[i])[0].numpy())
        assert ts[i, 0, 0].item() == quantize_tensor(xt[i])[1].item()


def test_e4m3_cast_follows_jax_beyond_the_range():
    """e4m3's largest finite value is 448: JAX rounds 470 and -600 to NaN,
    torch's own cast saturates them to +-448; the port follows JAX."""
    x = np.array([300.0, 464.0, 470.0, 1e4, -600.0, -464.0, 0.3, 1e-4,
                  449.0, np.inf], np.float32)
    ours = to_e4m3(torch.from_numpy(x)).float().numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn).astype(
        jnp.float32))
    np.testing.assert_array_equal(ours, ref)  # NaN where JAX has NaN
    assert np.isnan(ours[[2, 3, 4, 9]]).all() and ours[1] == 448.0
    assert torch.from_numpy(x[[2, 4]]).to(torch.float8_e4m3fn).float(
    ).abs().tolist() == [448.0, 448.0]
    # an overflowing q element makes its row NaN in both packages
    xq = _qkv(1, 130, 1, seed=9)
    xq[0, 5, 0, 0, 3] = 470.0
    o, _ = attention_q8_reference(*_split(torch.from_numpy(xq)), None, "fp8",
                                  block_k=128)
    rj = A.flash_attention(*_split(jnp.asarray(xq)), block_q=128,
                           block_k=128, interpret=True, quant="fp8")
    np.testing.assert_array_equal(np.isnan(o.numpy()), np.isnan(np.asarray(rj)))
    assert np.isnan(o[0, 5].numpy()).all() and not np.isnan(o[0, 6].numpy()).any()


# --- the forward (K5, K6) -----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 200, 4, None), (1, 300, 2, 290)],
                         ids=["n200", "n300_real290"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax_on_the_same_key_blocks(mode, shape, dtype):
    b, n, h, n_real = shape
    x = _qkv(b, n, h, seed=1)
    o, _ = attention_q8_reference(*_split(torch.from_numpy(x).to(dtype)),
                                  n_real, mode, block_k=128)
    ref = A.flash_attention(*_split(jnp.asarray(x).astype(JNP[dtype])),
                            block_q=128, block_k=128, interpret=True,
                            quant=mode, n_real=n_real)
    assert o.dtype == dtype and o.shape == (b, n, h, 64)
    np.testing.assert_allclose(o.float().numpy(), _f32(ref), **FWD_TOL[dtype])


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("mode", MODES)
def test_forward_at_wide_head_dim_matches_jax(mode, d):
    """head_dim 320 and 512, widths of K5/K6's runtime-width (_dn)
    instances on the card: the plain version (its 64-column chunks give the
    card the same sums) against the JAX package's kernel in interpret mode
    on the same 128-key blocks, fp32, N 300 with n_real 290, lse too."""
    b, n, h, n_real = 1, 300, 2, 290
    x = _qkv(b, n, h, seed=20 + d, d=d)
    o, lse = attention_q8_reference(*_split(torch.from_numpy(x)), n_real, mode,
                                    block_k=128)
    xj = _split(jnp.asarray(x))
    ref = A.flash_attention(*xj, block_q=128, block_k=128, interpret=True,
                            quant=mode, n_real=n_real)
    _, rj = A._flash_fwd_lse(*xj, block_q=128, block_k=128, interpret=True,
                             quant=mode, n_real=n_real)
    assert o.shape == (b, n, h, d)
    np.testing.assert_allclose(o.numpy(), _f32(ref), **FWD_TOL[torch.float32])
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(rj).reshape(b, h, -1)[:, :, :n], rtol=0,
        atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_forward_with_its_own_tile_stays_in_the_jax_band(mode):
    """The port's public path (64-key tiles) against the fp32 oracle, in
    the band the JAX package holds its own kernel to."""
    x = _qkv(2, 200, 4, seed=2)
    xt = torch.from_numpy(x)
    ours = flash_attention(*_split(xt), quant=mode)
    oracle = A.attention_reference(*_split(jnp.asarray(x)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), rtol=0,
                               atol=BAND[mode])
    # the wrappers of the two kernels take the same path on the CPU
    wrap = attention_fwd_int8 if mode.startswith("qk8") else attention_fwd_fp8
    o, lse = wrap(*_split(xt), pv8=mode.endswith("pv8"))
    assert lse is None and torch.equal(o, ours)


@pytest.mark.parametrize("mode", MODES)
def test_lse_matches_jax(mode):
    b, n, h, n_real = 1, 300, 2, 290
    x = _qkv(b, n, h, seed=3)
    wrap = attention_fwd_int8 if mode.startswith("qk8") else attention_fwd_fp8
    _, lse = wrap(*_split(torch.from_numpy(x)), n_real, mode.endswith("pv8"),
                  with_lse=True)
    _, ref = attention_q8_reference(*_split(torch.from_numpy(x)), n_real,
                                    mode)
    assert torch.equal(lse, ref)  # the wrapper's CPU path is the plain one
    _, rj = A._flash_fwd_lse(*_split(jnp.asarray(x)), block_q=128,
                             block_k=128, interpret=True, quant=mode,
                             n_real=n_real)
    ours = attention_q8_reference(*_split(torch.from_numpy(x)), n_real, mode,
                                  block_k=128)[1]
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(rj).reshape(b, h, -1)[:, :, :n], rtol=0,
        atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_training_with_quant_matches_jax_grad(mode, dtype):
    """quant set under autograd: the 8-bit forward with lse, then the
    bf16 backward on its saved (o, lse), straight through. At N 64 both
    sides walk one key block (the JAX package's 128-key block of its
    padded keys, the port's one 64-key tile), so the forward's p rounds
    alike and the gradients are held to GRAD_TOL."""
    b, n, h = 2, 64, 2
    x = _qkv(b, n, h, seed=4)
    g = np.random.default_rng(5).standard_normal((b, n, h, 64)).astype("f4")
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = flash_attention(*_split(xt), quant=mode)
    out.backward(torch.from_numpy(g).to(dtype))
    xj = jnp.asarray(x).astype(JNP[dtype])
    ref, vjp = jax.vjp(lambda q, k, v: A.flash_attention(
        q, k, v, interpret=True, quant=mode), *_split(xj))
    grads = vjp(jnp.asarray(g).astype(JNP[dtype]))
    np.testing.assert_allclose(out.detach().float().numpy(), _f32(ref),
                               **FWD_TOL[dtype])
    for i in range(3):
        assert xt.grad.dtype == dtype
        np.testing.assert_allclose(xt.grad[:, :, i].float().numpy(),
                                   _f32(grads[i]), **GRAD_TOL[dtype])


# --- the int8 backward (K7) ---------------------------------------------

def _assert_int8_grads(ours, ref, ref_bf16):
    for name, a, r, r16 in zip(("dq", "dk", "dv"), ours, ref, ref_bf16):
        a, r, r16 = a.float().numpy(), _f32(r), _f32(r16)
        top = np.abs(r).max()
        err = np.abs(a - r)
        rows_off = int((err.max(axis=-1) > 1e-3 * top).sum())
        assert rows_off <= 4, (name, rows_off)
        assert err.max() <= 1e-2 * top, (name, err.max() / top)
        assert err.max() < np.abs(r16 - r).max(), name


@pytest.mark.parametrize("shape", [(1, 150, 2, None), (1, 300, 2, 290),
                                   (1, 1800, 1, 1790)],
                         ids=["n150", "n300_real290", "n1800_3blocks"])
def test_int8_backward_matches_jax_kernel(shape):
    """Identical (q, k, v, o, lse, do) into _flash_bwd_q8 and the port's
    plain K7; N 1800 has three 640-row q-blocks of scales."""
    b, n, h, n_real = shape
    x = _qkv(b, n, h, seed=6)
    g = np.random.default_rng(7).standard_normal((b, n, h, 64)).astype("f4")
    q, k, v = _split(jnp.asarray(x))
    o, lse = A._flash_fwd_lse(q, k, v, block_q=896, block_k=448,
                              interpret=True, n_real=n_real, bwd_quant="int8")
    n_pad = -(-n // 128) * 128
    bq = A._pick_bwd_block(n_pad)
    assert bwd_q_block(n) == bq and (n_pad // bq == 3) == (n == 1800)
    ref = A._flash_bwd_q8(q, k, v, o, lse, jnp.asarray(g), block_q=bq,
                          interpret=True, n_real=n_real)
    ref16 = A._flash_bwd(q, k, v, o, lse, jnp.asarray(g), block_q=bq,
                         block_k=1 << 30, interpret=True, n_real=n_real)
    xt = torch.from_numpy(x)
    lse_t = torch.from_numpy(np.array(lse)).reshape(b, h, -1)[:, :, :n]
    ours = attention_bwd_int8(*_split(xt), torch.from_numpy(np.array(o)),
                              lse_t.contiguous(), torch.from_numpy(g), n_real)
    _assert_int8_grads(ours, ref, ref16)
    if n_real is not None:  # masked keys get exactly zero dk / dv
        assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


def test_int8_backward_at_head_dim_320_matches_jax_kernel():
    """head_dim 320, a width of K7's runtime-width (_dn) instance on the
    card: identical (q, k, v, o, lse, do) into _flash_bwd_q8 in interpret
    mode and the port's plain K7, held as at 64 (_assert_int8_grads)."""
    b, n, h, n_real, d = 1, 300, 2, 290, 320
    x = _qkv(b, n, h, seed=26, d=d)
    g = np.random.default_rng(27).standard_normal((b, n, h, d)).astype("f4")
    q, k, v = _split(jnp.asarray(x))
    o, lse = A._flash_fwd_lse(q, k, v, block_q=896, block_k=448,
                              interpret=True, n_real=n_real, bwd_quant="int8")
    bq = A._pick_bwd_block(-(-n // 128) * 128)
    ref = A._flash_bwd_q8(q, k, v, o, lse, jnp.asarray(g), block_q=bq,
                          interpret=True, n_real=n_real)
    ref16 = A._flash_bwd(q, k, v, o, lse, jnp.asarray(g), block_q=bq,
                         block_k=1 << 30, interpret=True, n_real=n_real)
    lse_t = torch.from_numpy(np.array(lse)).reshape(b, h, -1)[:, :, :n]
    ours = attention_bwd_int8(*_split(torch.from_numpy(x)),
                              torch.from_numpy(np.array(o)),
                              lse_t.contiguous(), torch.from_numpy(g), n_real)
    assert ours[0].shape == (b, n, h, d)
    _assert_int8_grads(ours, ref, ref16)
    assert not ours[1][:, n_real:].any() and not ours[2][:, n_real:].any()


@pytest.mark.parametrize("quant", [None, "qk8"], ids=["bf16_fwd", "qk8_fwd"])
@pytest.mark.parametrize("shape", [(1, 150, 2, None), (2, 300, 2, 290)],
                         ids=["n150", "n300_real290"])
def test_int8_backward_path_matches_jax_grad(shape, quant):
    """flash_attention with bwd_quant="int8" (alone: the bf16 forward with
    lse, bit-equal to the plain training forward; with quant: the 8-bit
    forward) against jax.grad of the JAX flash path."""
    b, n, h, n_real = shape
    x = _qkv(b, n, h, seed=8)
    g = np.random.default_rng(9).standard_normal((b, n, h, 64)).astype("f4")
    xt = torch.from_numpy(x).requires_grad_(True)
    out = flash_attention(*_split(xt), n_real=n_real, quant=quant,
                          bwd_quant="int8")
    out.backward(torch.from_numpy(g))
    if quant is None:
        assert torch.equal(out.detach(), flash_attention_fwd_lse(
            *_split(xt.detach()), n_real)[0])
    fj = functools.partial(A.flash_attention, interpret=True, n_real=n_real,
                           quant=quant)
    grads = jax.vjp(lambda q, k, v: fj(q, k, v, bwd_quant="int8"),
                    *_split(jnp.asarray(x)))[1](jnp.asarray(g))
    ref16 = jax.vjp(fj, *_split(jnp.asarray(x)))[1](jnp.asarray(g))
    if quant is None:
        _assert_int8_grads(_split(xt.grad), grads, ref16)
    else:  # the JAX forward's other key blocks move p, and so the scales
        for a, r, r16 in zip(_split(xt.grad), grads, ref16):
            r = _f32(r)
            rel = np.abs(a.numpy() - r).max() / np.abs(r).max()
            assert rel < 0.05 and rel < np.abs(_f32(r16) - r).max() / np.abs(
                r).max() * 2, rel


def test_int8_backward_beyond_the_full_k_limit_is_the_bf16_one():
    """round_up(N, 128) > 4096: the TPU package's int8 backward is full-K
    only, so its caller runs the bf16 one; so does the port."""
    x = torch.from_numpy(_qkv(1, 4100, 1, seed=10))
    q, k, v = _split(x)
    o, lse = flash_attention_fwd_lse(q, k, v)
    g = torch.ones_like(q)
    a = attention_bwd_int8_reference(q, k, v, o, lse, g)
    b = attention_bwd_reference(q, k, v, o, lse, g)
    for u, w in zip(a, b):
        assert torch.equal(u, w)


def test_cpu_counts_no_launch():
    x = torch.from_numpy(_qkv(1, 70, 2, seed=11)).requires_grad_(True)
    counts = lambda: (attention_fwd_int8.launches,  # noqa: E731
                      attention_fwd_fp8.launches,
                      attention_bwd_int8.launches)
    before = counts()
    for mode in MODES:
        flash_attention(*_split(x), quant=mode, bwd_quant="int8").sum(
        ).backward()
    assert counts() == before


# --- model level ----------------------------------------------------------

# N = 9 x 14 + 2 = 128 tokens: a multiple of 128, so the JAX model's
# pad-once stream adds no rows (padded rows would enter sv and the int8
# backward's scales); train mode drops one of 15 time columns to the same N
GEOM = dict(patch_size=16, stride=(10, 10), in_chans=1, embed_dim=128,
            depth=2, num_heads=2, mlp_ratio=4.0, num_classes=10,
            distilled=True, distilled_type="mean")


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX model on its Pallas flash path, in interpret mode."""
    monkeypatch.setattr(A, "use_flash", lambda n, d: True)
    monkeypatch.setattr(A, "flash_attention",
                        functools.partial(A.flash_attention, interpret=True))


def _models(img, head_std=0.3, **over):
    from maest_tpu.models.config import MAESTConfig as JaxConfig
    from maest_tpu.models.vit import MAESTNet as JaxNet
    from maest_tpu.models.vit import init_params
    from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
    from maest_tpu_torch.models.config import MAESTConfig
    from maest_tpu_torch.models.vit import MAESTNet

    geom = {**GEOM, **over}
    jcfg = JaxConfig(img_size=img, **geom)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(12)
    params["head_linear"]["kernel"] = rng.standard_normal(
        (geom["embed_dim"], 10)).astype("f4") * np.float32(head_std)
    tcfg = MAESTConfig(img_size=img, **geom)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg))
    return JaxNet(jcfg), params, net


@pytest.mark.parametrize("mode", MODES)
def test_model_logits_in_each_mode_match_jax(mode, jax_flash):
    """Tiny MAEST (embed 128, 2 heads of 64, depth 2, N 128) in fp32 with
    ``attention_quant``: logits against the JAX model's within the mode's
    band (the two packages tile the keys differently: 64 against 128)."""
    _model_logits_match_jax(mode, 128)


@pytest.mark.parametrize("mode", MODES)
def test_model_at_head_dim_320_in_each_mode_matches_jax(mode, jax_flash,
                                                        monkeypatch):
    """As at 64, at embed 640 with 2 heads of 320 (K5/K6's runtime-width
    instances on the card), the head's weights drawn with the standard
    deviation scaled by sqrt(128 / 640), so the logits keep the embed-128
    scale the band is for. Both packages walk the same 128-key block here
    (the port's plain version told to, as the kernel tests above do): at
    head_dim 320 the pv8 modes' p, rounded against the running max of 64
    keys on one side and of 128 on the other, move the logits past the
    band (up to 7e-2 in fp8pv8), which is the tiling, not the route."""
    from maest_tpu_torch.ops import attention as PA

    monkeypatch.setattr(PA, "attention_q8_reference", functools.partial(
        PA.attention_q8_reference, block_k=128))
    _model_logits_match_jax(mode, 640)


def _model_logits_match_jax(mode, width):
    jnet, params, net = _models((96, 146), 0.3 * (128 / width)**0.5,
                                attention_quant=mode, embed_dim=width)
    x = np.random.default_rng(13).standard_normal((2, 1, 96, 146)).astype("f4")
    with torch.inference_mode():
        ours = net.eval()(torch.from_numpy(x))[0]
    ref = jnet.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1),
                     train=False)[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=BAND[mode])


def test_model_int8_backward_gradients_match_jax(jax_flash):
    """One fp32 step's gradients with ``attention_bwd_quant="int8"``: the
    BCE loss of the tiny model (train-mode geometry, one of 15 time columns
    dropped: N 128) and every parameter's gradient against jax.grad of the
    JAX model. The loss is the forward's alone (rtol 1e-6); the gradient
    norms rtol 1e-3, each gradient within 1e-2 of its max (rounding flips
    of p8 / ds8, as in the kernel tests)."""
    _model_int8_grads_match_jax(128)


def test_model_int8_backward_at_head_dim_320_matches_jax(jax_flash):
    """As at 64, at embed 640 with 2 heads of 320 (K7's runtime-width
    instance on the card), the head's weights scaled as in the forward's
    head_dim-320 test."""
    _model_int8_grads_match_jax(640)


def _model_int8_grads_match_jax(width):
    from maest_tpu_torch.checkpoints import state_from_jax_params

    jnet, params, net = _models((96, 156), 0.3 * (128 / width)**0.5,
                                attention_bwd_quant="int8",
                                s_patchout_t_indices=(1,), embed_dim=width)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 96, 156)).astype("f4")
    y = (rng.random((2, 10)) < 0.3).astype("f4")

    def jloss(p):
        logits = jnet.apply({"params": p}, jnp.asarray(x)[..., None],
                            train=True, rngs={"dropout": jax.random.PRNGKey(0)})[0]
        return optax_bce(logits, jnp.asarray(y))

    def optax_bce(z, t):
        return jnp.mean(jnp.maximum(z, 0) - z * t + jnp.log1p(jnp.exp(-jnp.abs(z))))

    jl, jg = jax.value_and_grad(jloss)(params)
    from maest_tpu_torch.models.vit import TrainDraws
    net.train()
    logits = net(torch.from_numpy(x)[:, None], train=True,
                 draws=TrainDraws())[0]
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    ref = state_from_jax_params(jax.tree.map(np.asarray, jg), net.cfg)
    named = dict(net.named_parameters())
    checked = 0
    for k, r in ref.items():
        if named[k].grad is None:
            continue
        a, r = named[k].grad.numpy(), r.numpy()
        top = np.abs(r).max()
        if top == 0:
            continue
        np.testing.assert_allclose(np.linalg.norm(a), np.linalg.norm(r),
                                   rtol=1e-3, err_msg=k)
        assert np.abs(a - r).max() <= 1e-2 * top, k
        checked += 1
    assert checked > 20
