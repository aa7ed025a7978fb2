"""The attention routes the port takes where the JAX package computes
(ROADMAP queue 3), held on the CPU against the JAX package:

- head_dim other than the kernels' 64, 128 and 256: on the card the kernels
  run on q, k, v (and o, do) zero-padded to the next width with the
  unpadded head_dim's softmax scale (``ops/attention.py pad_head_dim``,
  ``padded_fwd``, ``padded_bwd``): 64, 128, 256, and above 256 the next
  multiple of 64, which every kernel takes as a runtime argument (its
  ``_dn`` entry). Here the same helpers run with the plain versions in the
  kernels' place: pad, plain, slice equals plain within 1e-6 (fp32; zero
  columns change only the order of the sums over head_dim), in every mode
  and in the backward (K3b's and K7's arithmetic), at head_dim 16 and 32
  (to 64), 80, 96 and 128 (to 128), 160, 192 and 256 (to 256), 300 (to
  320), 320 and 512; the tiny model at head_dim 16, 96, 128, 192, 256, 320
  and 512 through them gives the JAX package's logits within 1e-5; on meta
  tensors, which take the card's route, every 8-bit mode and K7 pad 300 to
  320 and name their ``_dn`` entries;
- head_dim 128, 256, 320 and 512: the plain forward and backward against
  the JAX package's Pallas kernels (``_flash_fwd_lse``, ``_flash_bwd``) in
  interpret mode, as ``tests/test_torch_attention.py`` holds them at 64
  (the 8-bit modes at 320 and 512: ``tests/test_torch_attention_q8.py``);
- ``attention_impl="xla"``: the materialised softmax, within 1e-5 of the
  JAX package's XLA path at head_dim 64 and 16;
- ``attention_impl="flash"`` with attention dropout in train mode raises,
  as the JAX package does.

``tests/test_torch_cuda.py`` holds the padded kernels to the plain versions
on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.vit import MAESTNet
from maest_tpu_torch.ops import attention as A

LOGIT_TOL = 1e-5
PAD_TOL = 1e-6
MODES = (None, "qk8", "qk8pv8", "fp8", "fp8pv8")


def _geom(embed, heads):
    return dict(img_size=(26, 46), patch_size=16, stride=(10, 10), in_chans=1,
                embed_dim=embed, depth=2, num_heads=heads, mlp_ratio=4.0,
                num_classes=10, distilled=True)


def _pair(embed, heads, head_std=0.3, **over):
    """The JAX net, its params (random heads, N(0, head_std^2)) and the
    port with them."""
    geom = _geom(embed, heads)
    jcfg = JaxConfig(**geom, **over)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    params["head_linear"]["kernel"] = rng.standard_normal(
        (embed, 10)).astype("f4") * np.float32(head_std)
    tcfg = MAESTConfig(**geom, **over)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg)).eval()
    return JaxNet(jcfg), params, net


def _logits(embed, heads, head_std=0.3, **over):
    jnet, params, net = _pair(embed, heads, head_std, **over)
    x = np.random.default_rng(6).standard_normal((2, 1, 26, 46)).astype("f4")
    ref = jnet.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1),
                     train=False)[0]
    with torch.inference_mode():
        ours = net(torch.from_numpy(x))[0]
    return ours.numpy(), np.asarray(ref)


def _plain_fwd(q, k, v, n_real, with_lse, scale, quant=None):
    """The plain versions in a kernel's place: (o, lse or None) on inputs of
    a kernel width, 64, 128, 256 or a multiple of 64 above."""
    assert q.shape[-1] == A.padded_dim(q.shape[-1])
    if quant is not None:
        o, lse = A.attention_q8_reference(q, k, v, n_real, quant, scale=scale)
        return o, (lse if with_lse else None)
    if with_lse:
        return A.attention_reference_lse(q, k, v, n_real, scale)
    return A.attention_reference(q, k, v, n_real, scale), None


def _plain_bwd(q, k, v, o, lse, do, n_real, scale, int8=False):
    assert q.shape[-1] == A.padded_dim(q.shape[-1])
    ref = A.attention_bwd_int8_reference if int8 else A.attention_bwd_reference
    return torch.stack(ref(q, k, v, o, lse, do, n_real, scale), dim=2)


@pytest.mark.parametrize("route", ["plain", "padded"])
def test_model_at_head_dim_16_matches_jax(route, monkeypatch):
    """The CPU tier's own geometry (embed 64, 4 heads: head_dim 16). With
    "padded" every attention call goes through the helpers the card's
    route uses, the plain versions in the kernels' place."""
    if route == "padded":
        monkeypatch.setattr(
            A, "_fwd", lambda q, k, v, n_real, quant, with_lse:
            A.padded_fwd(_plain_fwd, q, k, v, n_real, with_lse))
    ours, ref = _logits(64, 4)
    assert np.abs(ours - ref).max() <= LOGIT_TOL, np.abs(ours - ref).max()


@pytest.mark.parametrize("route", ["plain", "padded"])
@pytest.mark.parametrize("embed,heads",
                         [(256, 2), (192, 2), (512, 2), (384, 2), (640, 2),
                          (512, 1)],
                         ids=["d128", "d96", "d256", "d192", "d320", "d512"])
def test_model_at_wide_head_dim_matches_jax(embed, heads, route,
                                            monkeypatch):
    """head_dim 128 (embed 256, 2 heads) and 96 (embed 192, 2 heads),
    depth 2, fp32: the kernels' D = 128 instance on the card; head_dim 256
    (embed 512) and 192 (embed 384): the D = 256 instance; head_dim 320
    (embed 640, 2 heads) and 512 (embed 512, 1 head): the runtime-width
    instance at 320 and 512. Here, with
    "padded", the helpers of that route with the plain versions in the
    kernels' place (96 zero-padded to 128, 192 to 256). Past embed 256 the
    head's weights are drawn with the standard deviation scaled by
    sqrt(256 / embed), so the logits keep the scale of the embed-256 case
    (|logit| up to ~10), where the 1e-5 bound is ~10 fp32 ulps of the
    largest logit: both sides sum the same fp32 products in other orders,
    and wider features give proportionally larger logits and roundoff."""
    if route == "padded":
        monkeypatch.setattr(
            A, "_fwd", lambda q, k, v, n_real, quant, with_lse:
            A.padded_fwd(_plain_fwd, q, k, v, n_real, with_lse))
    ours, ref = _logits(embed, heads, 0.3 * min(1.0, (256 / embed)**0.5))
    assert np.abs(ours - ref).max() <= LOGIT_TOL, np.abs(ours - ref).max()


@pytest.mark.parametrize("embed,heads", [(64, 1), (64, 4)], ids=["d64", "d16"])
def test_xla_impl_matches_jax(embed, heads):
    """attention_impl="xla" builds (it raised before) and gives the JAX
    package's XLA path, which ignores attention_quant, as the port does."""
    ours, ref = _logits(embed, heads, attention_impl="xla")
    assert np.abs(ours - ref).max() <= LOGIT_TOL, np.abs(ours - ref).max()
    quant, _ = _logits(embed, heads, attention_impl="xla",
                       attention_quant="qk8")
    np.testing.assert_array_equal(quant, ours)


def test_xla_impl_takes_no_kernel_route(monkeypatch):
    import maest_tpu_torch.models.vit as V

    def kernel_route(*args, **kwargs):
        raise AssertionError("attention_impl='xla' reached the kernel route")

    monkeypatch.setattr(V, "flash_attention_qkv", kernel_route)
    _, _, net = _pair(64, 4, attention_impl="xla")
    with torch.inference_mode():
        assert net(torch.zeros(1, 1, 26, 46))[0].shape == (1, 10)


def test_flash_impl_with_attention_dropout_raises_as_jax_does():
    x = np.zeros((1, 1, 26, 46), "f4")
    _, params, _ = _pair(64, 4)  # init on the XLA path: no Pallas on the CPU
    jnet = JaxNet(JaxConfig(**_geom(64, 4), attention_impl="flash",
                            attn_drop_rate=0.1))
    k = jax.random.PRNGKey(0)
    with pytest.raises(ValueError, match="cannot apply attn_drop_rate"):
        jnet.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1),
                   train=True, rngs={"patchout": k, "droppath": k,
                                     "dropout": k})
    tcfg = MAESTConfig(**_geom(64, 4), attention_impl="flash",
                       attn_drop_rate=0.1)
    net = MAESTNet(tcfg)
    with pytest.raises(ValueError, match="cannot apply attn_drop_rate"):
        net(torch.from_numpy(x), train=True)
    with torch.inference_mode():  # eval applies no dropout: the kernels run
        assert net(torch.from_numpy(x))[0].shape == (1, 10)
    auto = MAESTNet(MAESTConfig(**_geom(64, 4), attn_drop_rate=0.1))
    assert auto(torch.from_numpy(x), train=True)[0].shape == (1, 10)


def test_unknown_impl_is_refused():
    with pytest.raises(ValueError, match="unknown attention_impl"):
        MAESTNet(MAESTConfig(**_geom(64, 4), attention_impl="pallas"))


def _qkv(b, n, h, d, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, n, 5, h, d)).astype(np.float32))
    return x.unbind(2)


# padded to 64 (16, 32), 128 (80, 96) or 256 (160, 192); above 256 to the
# next multiple of 64 (300 to 320)
WIDTHS = [16, 32, 80, 96, 128, 160, 192, 256]
WIDE = [300, 320, 512]


@pytest.mark.parametrize("d,quant",
                         [(d, m) for m in MODES for d in WIDTHS + WIDE],
                         ids=[f"{d}-{m}" for m in MODES
                              for d in WIDTHS + WIDE])
def test_padded_forward_is_the_plain_version(d, quant):
    """pad -> plain -> slice within 1e-6 of plain at head_dim d, lse too;
    the 8-bit scales of zero-padded rows are the unpadded rows' (zeros
    never raise a max)."""
    q, k, v, _, _ = _qkv(2, 90, 3, d, seed=d)
    for n_real in (None, 77):
        o, lse = A.padded_fwd(_plain_fwd, q, k, v, n_real, True, quant=quant)
        ro, rlse = (A.attention_q8_reference(q, k, v, n_real, quant) if quant
                    else A.attention_reference_lse(q, k, v, n_real))
        assert o.shape == q.shape and lse.shape == (2, 3, 90)
        assert (o - ro).abs().max().item() <= PAD_TOL
        assert (lse - rlse).abs().max().item() <= PAD_TOL
    padded, scale = A.pad_head_dim(q)
    assert padded[0].shape[-1] == (64 if d <= 64 else 128 if d <= 128
                                   else 256 if d <= 256 else -(-d // 64) * 64)
    assert scale == d**-0.5
    assert torch.equal(padded[0][..., :d], q) and not padded[0][..., d:].any()


@pytest.mark.parametrize("d,int8",
                         [(d, i8) for i8 in (False, True)
                          for d in WIDTHS + WIDE],
                         ids=[f"{d}-{n}" for n in ("bf16_path", "int8")
                              for d in WIDTHS + WIDE])
def test_padded_backward_is_the_plain_version(d, int8):
    """The (B, N, 3, H, d) gradients through pad -> plain -> slice within
    1e-6 of plain, in K3b's arithmetic and in K7's."""
    q, k, v, do, _ = _qkv(2, 90, 3, d, seed=10 + d)
    o, lse = A.attention_reference_lse(q, k, v, 80)
    got = A.padded_bwd(_plain_bwd, q, k, v, o, lse, do, 80, int8=int8)
    ref = (A.attention_bwd_int8_reference if int8
           else A.attention_bwd_reference)(q, k, v, o, lse, do, 80)
    assert got.shape == (2, 90, 3, 3, d) and got.is_contiguous()
    for i in range(3):
        assert (got[:, :, i] - ref[i]).abs().max().item() <= PAD_TOL


def test_wide_heads_are_refused(monkeypatch):
    """Above head_dim 256 no mode is refused on the card any more: every
    8-bit mode (K5/K6) and K7 run their runtime-width instances. Here on
    meta tensors, which take the card's route up to the launch, with the
    two 8-bit launchers replaced by recorders: head_dim 300 reaches them
    zero-padded to 320 with 300's softmax scale, and each names its ``_dn``
    C entry with 320 as its first argument, as bf16 and fp32 do."""
    seen = []

    def fwd(q, k, v, n_real, with_lse, scale, quant):
        seen.append((quant, q.shape[-1], scale))
        return torch.empty_like(q), None

    def bwd(q, k, v, o, lse, do, n_real, scale):
        seen.append(("int8", q.shape[-1], scale))
        return torch.empty(q.shape[:2] + (3,) + q.shape[2:], device=q.device)

    monkeypatch.setattr(A, "_launch_fwd_q8", fwd)
    monkeypatch.setattr(A, "_launch_bwd_q8", bwd)
    for wrap in (A.attention_fwd_int8, A.attention_fwd_fp8,
                 A.attention_bwd_int8):
        monkeypatch.setattr(wrap, "launches", 0)
    x = torch.zeros(1, 4, 2, 300, device="meta")
    for quant in MODES[1:]:
        assert A.flash_attention(x, x, x, quant=quant).shape == x.shape
    lse = torch.zeros(1, 2, 4, device="meta")
    assert all(g.shape == x.shape
               for g in A.attention_bwd_int8(x, x, x, x, lse, x))
    assert seen == [(m, 320, 300**-0.5) for m in MODES[1:] + ("int8",)]
    assert (A.attention_fwd_int8.launches, A.attention_fwd_fp8.launches,
            A.attention_bwd_int8.launches) == (2, 2, 1)
    assert A.padded_dim(320) == A.padded_dim(300) == 320
    for dtype in (torch.float32, torch.bfloat16):
        padded, scale = A.pad_head_dim(torch.ones(1, 4, 2, 300, dtype=dtype))
        assert padded[0].shape[-1] == 320 and scale == 300**-0.5
        fp32 = dtype == torch.float32
        for name in ("maest_attn_fwd", "maest_attn_bwd"):
            tier = f"{name}_{'fp32' if fp32 else 'bf16'}"
            assert A._instance(tier, 320) == (f"{tier}_dn", (320,))
        for name in [f"maest_attn_fwd_{m}" for m in MODES[1:]] + [
                "maest_attn_bwd_q8"]:
            entry = name + ("_fp32" if fp32 else "")
            assert A._instance(entry, 320) == (f"{entry}_dn", (320,))
            assert A._instance(entry, 256) == (f"{entry}_d256", ())


# as tests/test_torch_attention.py: fp32 rtol 1e-3 / atol 1e-4; bf16 2e-2
# (absolute and relative), compared in fp32, the JAX package's own
GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_head_dim_128_matches_jax_flash_interpret(dtype):
    """The port's Function at head_dim 128 (forward with lse, backward; on
    the CPU their plain versions) against the JAX custom VJP with its Pallas
    kernels in interpret mode, which take the whole head_dim as a block's
    last axis, at N 200 with n_real 190."""
    _vs_jax_flash(128, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_head_dim_256_matches_jax_flash_interpret(dtype):
    """As at 128, at head_dim 256 (the D = 256 instances' width)."""
    _vs_jax_flash(256, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [320, 384, 512])
def test_wide_head_dim_matches_jax_flash_interpret(d, dtype):
    """As at 128, at head_dim 320, 384 and 512 (the runtime-width instances'
    widths on the card; 384 is ``get_maest(embed_dim=768, num_heads=2)``'s)."""
    _vs_jax_flash(d, dtype)


def _vs_jax_flash(d, dtype):
    from maest_tpu.ops.attention import _flash_fwd_lse
    from maest_tpu.ops.attention import flash_attention as jax_flash

    n, n_real = 200, 190
    x = np.random.default_rng(21).standard_normal(
        (2, n, 3, 2, d)).astype(np.float32)
    g = np.random.default_rng(22).standard_normal(
        (2, n, 2, d)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = A.flash_attention(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2],
                            n_real=n_real)
    out.backward(torch.from_numpy(g).to(dtype))
    _, lse = A.flash_attention_fwd_lse(
        *(xt[:, :, i].detach() for i in range(3)), n_real=n_real)

    xj = jnp.asarray(x).astype(JNP[dtype])
    q, k, v = xj[:, :, 0], xj[:, :, 1], xj[:, :, 2]
    ref, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, n_real=n_real, interpret=True),
        q, k, v)
    grads = vjp(jnp.asarray(g).astype(JNP[dtype]))
    _, ref_lse = _flash_fwd_lse(q, k, v, block_q=896, block_k=448,
                                interpret=True, n_real=n_real)
    ref_lse = np.asarray(ref_lse).reshape(2, 2, -1)[:, :, :n]
    np.testing.assert_allclose(lse.numpy(), ref_lse, **GRAD_TOL[torch.float32])
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **GRAD_TOL[dtype])
    for i in range(3):
        np.testing.assert_allclose(xt.grad[:, :, i].float().numpy(),
                                   np.asarray(grads[i].astype(jnp.float32)),
                                   **GRAD_TOL[dtype])
    assert not xt.grad[:, n_real:, 1:].any()  # masked keys: zero dk, dv
