"""The port's train forward (``MAESTNet(..., train=True)``) against the
JAX package's, at a tiny geometry (embed 64, depth 2, 4 heads, 36 x 66
input: a 3 x 6 patch grid, large enough that each random patchout's kept
set can be read back from JAX's own draw), with the same weights. Random
streams differ between the packages, so the port is handed JAX's draws.
Tolerance rtol 2e-4, atol 2e-5 (fp32 tier on both sides); remat gradients
against the plain train forward's rtol/atol 1e-6 (the same arithmetic,
recomputed)."""

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
from maest_tpu_torch.models.vit import MAESTNet, TrainDraws, drop_path

TOL = dict(rtol=2e-4, atol=2e-5)
GEOM = dict(img_size=(26, 46), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_classes=10,
            distilled=True)
TRAIN_GEOM = dict(GEOM, img_size=(36, 66))


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **TOL)


def _train_pair(**over):
    jcfg = JaxConfig(**TRAIN_GEOM, **over)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(7)
    params["head_linear"]["kernel"] = rng.standard_normal((64, 10)).astype("f4")
    tcfg = MAESTConfig(**TRAIN_GEOM, **over)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg))
    return JaxNet(jcfg), params, net


def _match_rows(sub, full):
    """Index into ``full`` (M, E) of each row of ``sub`` (K, E)."""
    d = np.abs(sub[:, None, :] - full[None, :, :]).max(-1)
    assert (d.min(1) == 0).all(), "a kept token is not a grid token"
    return d.argmin(1)


@pytest.mark.parametrize("over", [dict(s_patchout_t=2), dict(s_patchout_f=1),
                                  dict(u_patchout=5)],
                         ids=["time", "freq", "unstructured"])
def test_train_forward_matches_jax_with_injected_patchout(over):
    """JAX ``apply(train=True)`` (dropout off) against the port's train
    forward handed JAX's own patchout draw, read back from JAX's
    ``forward_mode="front"`` tokens (same rngs, so the same draw)."""
    jnet, params, tnet = _train_pair(**over)
    x = np.random.default_rng(8).standard_normal((2, 1, 36, 66)).astype("f4")
    xh = jnp.asarray(x).transpose(0, 2, 3, 1)
    k = jax.random.PRNGKey(3)
    rngs = {"patchout": k, "droppath": k, "dropout": k}
    apply = lambda **kw: jnet.apply({"params": params}, xh, rngs=rngs, **kw)
    full = np.asarray(apply(train=False, forward_mode="front")[0])[0, 2:]
    kept = np.asarray(apply(train=True, forward_mode="front")[0])[0, 2:]
    idx = _match_rows(kept, full)  # flat (f, t) grid positions, f-major
    f_idx, t_idx = np.divmod(idx, 6)
    draws = TrainDraws()
    if "s_patchout_t" in over:
        draws.keep_t = torch.from_numpy(np.unique(t_idx))
    elif "s_patchout_f" in over:
        draws.keep_f = torch.from_numpy(np.unique(f_idx))
    else:
        draws.keep_u = torch.from_numpy(idx)
    ref = apply(train=True)[0]
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x), train=True, draws=draws)[0]
    _close(ours, ref)


def test_train_time_crop_matches_jax():
    """A 5-patch input on the 6-entry time table: JAX's random crop picks
    offset 0 or 1; the port with that offset gives JAX's logits and the
    other offset does not."""
    jnet, params, tnet = _train_pair()
    x = np.random.default_rng(9).standard_normal((2, 1, 36, 64)).astype("f4")
    k = jax.random.PRNGKey(4)
    ref = np.asarray(jnet.apply(
        {"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1), train=True,
        rngs={"patchout": k, "droppath": k, "dropout": k})[0])
    with torch.no_grad():
        outs = [tnet(torch.from_numpy(x), train=True,
                     draws=TrainDraws(time_offset=o))[0].numpy() for o in (0, 1)]
    hits = [np.allclose(o, ref, **TOL) for o in outs]
    assert sorted(hits) == [False, True]


def test_draw_train_shapes_and_ranges():
    cfg = MAESTConfig(**TRAIN_GEOM, s_patchout_t=2, s_patchout_f=1,
                      u_patchout=3, drop_rate=0.1)
    net = MAESTNet(cfg)
    d = net.draw_train(torch.Generator().manual_seed(0), 3, 5)
    assert d.time_offset in (0, 1) and d.seed is not None
    assert d.keep_t.tolist() == sorted(set(d.keep_t.tolist()))
    assert len(d.keep_t) == 3 and len(d.keep_f) == 2 and len(d.keep_u) == 3
    assert int(d.keep_u.max()) < 2 * 3
    out = net(torch.zeros(2, 1, 36, 56), train=True, draws=d)[0]
    assert out.shape == (2, 10)
    d.seed = None  # dropout is configured: its masks need a seed
    with pytest.raises(ValueError, match="seed"):
        net(torch.zeros(2, 1, 36, 56), train=True, draws=d)


def _grads(net, x, draws):
    net.zero_grad()
    out = net(x, train=True, draws=draws)
    (out[0].square().sum() + out[1].sum()).backward()
    return {k: p.grad.clone() for k, p in net.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("policy", ["full", "dots", "attn_out"])
def test_remat_policies_match_no_remat(policy, monkeypatch):
    """Each remat policy gives the gradients of the plain train forward
    (rtol/atol 1e-6; the masks of dropout and drop_path are redrawn from
    the same seeds), and re-runs the attention forward exactly as often as
    its policy says: full and dots twice per layer, attn_out once."""
    from maest_tpu_torch.ops import attention as A

    over = dict(drop_rate=0.1, drop_path_rate=0.2, s_patchout_t=1)
    _, _, plain = _train_pair(**over)
    _, _, remat = _train_pair(**over, remat=True, remat_policy=policy)
    x = torch.from_numpy(
        np.random.default_rng(10).standard_normal((2, 1, 36, 66)).astype("f4"))
    draws = plain.draw_train(torch.Generator().manual_seed(1), 3, 6)

    calls = []
    real = A.attention_reference_lse
    monkeypatch.setattr(A, "attention_reference_lse",
                        lambda *a: calls.append(1) or real(*a))
    ref = _grads(plain, x, draws)
    assert len(calls) == 2
    calls.clear()
    ours = _grads(remat, x, draws)
    assert len(calls) == (2 if policy == "attn_out" else 4)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_attn_out_remat_replays_the_8bit_forward(monkeypatch):
    """Under attention_quant and attention_bwd_quant="int8", attn_out remat
    records the 8-bit forward's (o, lse) once a layer and replays them
    unchanged: the gradients equal those of the plain train forward
    (rtol/atol 1e-6, as above)."""
    from maest_tpu_torch.ops import attention as A

    over = dict(s_patchout_t=1, attention_quant="qk8pv8",
                attention_bwd_quant="int8")
    _, _, plain = _train_pair(**over)
    _, _, remat = _train_pair(**over, remat=True, remat_policy="attn_out")
    x = torch.from_numpy(
        np.random.default_rng(11).standard_normal((2, 1, 36, 66)).astype("f4"))
    draws = plain.draw_train(torch.Generator().manual_seed(2), 3, 6)
    calls = []
    real = A.attention_q8_reference
    monkeypatch.setattr(A, "attention_q8_reference",
                        lambda *a: calls.append(a[-1]) or real(*a))
    ref = _grads(plain, x, draws)
    assert calls == ["qk8pv8"] * 2
    calls.clear()
    ours = _grads(remat, x, draws)
    assert calls == ["qk8pv8"] * 2
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_attention_dropout_takes_the_materialised_path():
    """attn_drop_rate > 0 in train mode: the softmax is materialised and
    dropped (no flash call); remat still reproduces its masks."""
    over = dict(attn_drop_rate=0.2)
    _, _, plain = _train_pair(**over)
    _, _, remat = _train_pair(**over, remat=True)
    x = torch.from_numpy(
        np.random.default_rng(11).standard_normal((2, 1, 36, 66)).astype("f4"))
    draws = plain.draw_train(torch.Generator().manual_seed(2), 3, 6)
    ref, ours = _grads(plain, x, draws), _grads(remat, x, draws)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    with torch.no_grad():  # eval ignores every rate
        np.testing.assert_array_equal(
            plain(x)[0].numpy(),
            _train_pair()[2](x)[0].numpy())


def test_drop_path_is_per_sample():
    x = torch.ones(64, 3, 5)
    out = drop_path(x, 0.5, torch.Generator().manual_seed(0))
    per_sample = out.reshape(64, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 2).all(1)).all()
    assert 10 < int((per_sample[:, 0] == 0).sum()) < 54
    assert drop_path(x, 0.5, None) is x


def test_fp32_parameters_under_bf16_compute():
    """param_dtype splits storage from compute: fp32 parameters, bf16
    activations, fp32 gradients; the default stores in the compute dtype
    (serving keeps its bf16 weights)."""
    cfg = MAESTConfig(**GEOM)
    net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=torch.float32)
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    out = net(torch.randn(2, 1, 26, 46), train=True)
    assert out[0].dtype == torch.bfloat16
    out[0].float().sum().backward()
    assert net.blocks[0].attn.qkv.weight.grad.dtype == torch.float32
    assert {p.dtype for p in MAESTNet(cfg, dtype=torch.bfloat16).parameters()
            } == {torch.bfloat16}
