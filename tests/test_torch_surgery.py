"""The per-frequency patch embedding, non-distilled configs and
``maest_tpu_torch/models/surgery.py`` against the JAX package, at a tiny
geometry (embed 64, depth 2, 4 heads, 36 x 66 input: a 3 x 6 patch grid),
with the same weights carried across by ``state_from_jax_params``.

The per-frequency weights come from the JAX surgery
``per_freq_params_from_conv`` and then each row is perturbed by its own
seeded draw: the surgery copies one conv into every row, so a port that
took the rows or the features in another order would pass on the
unperturbed weights. Tolerance rtol 2e-4, atol 2e-5, the bound of
tests/test_torch_vit.py, for outputs and gradients alike (fp32 on both
sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.models import surgery as jsurgery
from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu.checkpoints.convert import torch_to_jax_params
from maest_tpu.train.state import TrainState as JaxState
from maest_tpu.train.state import make_optimizer as jax_optimizer
from maest_tpu.train.steps import AugmentConfig as JaxAugment
from maest_tpu.train.steps import bce_with_logits as jax_bce
from maest_tpu.train.steps import make_train_step as jax_train_step
from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
from maest_tpu_torch.checkpoints.convert import _find
from maest_tpu_torch.models import surgery
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.vit import MAESTNet
from maest_tpu_torch.train import (
    AugmentConfig,
    TrainState,
    make_optimizer,
    make_train_step,
)
from maest_tpu_torch.train.steps import bce_with_logits

TOL = dict(rtol=2e-4, atol=2e-5)
GEOM = dict(img_size=(36, 66), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_classes=10)
KINDS = ("per_freq", "non_distilled", "per_freq_non_distilled")


def _close(ours, ref, err_msg=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref),
                               err_msg=err_msg, **TOL)


def _perturb_rows(params, seed=11):
    """Each per-frequency row's kernel and bias moved by its own draw."""
    rng = np.random.default_rng(seed)
    k = np.array(params["patch_embed_freq_kernel"])
    b = np.array(params["patch_embed_freq_bias"])
    k += rng.standard_normal(k.shape).astype("f4") * 0.05
    b += rng.standard_normal(b.shape).astype("f4") * 0.05
    return dict(params, patch_embed_freq_kernel=k, patch_embed_freq_bias=b)


def _jax_params(kind, distilled_type="mean", **over):
    """(JAX params, JAX config, port config) of ``kind``: a tiny model
    whose heads are random (they start at zero)."""
    distilled = kind == "per_freq"
    kw = dict(GEOM, distilled=distilled, distilled_type=distilled_type,
              **over)
    jcfg = JaxConfig(**kw)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    if kind.startswith("per_freq"):
        params, jcfg = jsurgery.per_freq_params_from_conv(params, jcfg)
        params = _perturb_rows(params)
    rng = np.random.default_rng(5)
    for name in ("head_linear", "head_dist"):
        if name in params:
            params[name] = {
                "kernel": rng.standard_normal((64, 10)).astype("f4") * 0.3,
                "bias": rng.standard_normal(10).astype("f4") * 0.1}
    tcfg = MAESTConfig(**dict(kw, per_freq_patch_embed=jcfg.per_freq_patch_embed))
    return params, jcfg, tcfg


def _pair(kind, distilled_type="mean", **over):
    params, jcfg, tcfg = _jax_params(kind, distilled_type, **over)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg)).eval()
    return JaxNet(jcfg), params, net


def _x(seed=6, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 1, *GEOM["img_size"])).astype("f4")


def _jax(net, params, x, **kw):
    return net.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1),
                     train=False, **kw)


def _torch(net, x, **kw):
    with torch.inference_mode():
        return net(torch.from_numpy(x), **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_state_layout(kind):
    """The port's module holds the keys ``state_from_jax_params`` writes:
    per-frequency rows in place of the conv, no dist token or dist head
    without distillation."""
    params, _, tcfg = _jax_params(kind, "separated")
    state = state_from_jax_params(params, tcfg)
    assert sorted(MAESTNet(tcfg).state_dict()) == sorted(state)
    assert ("patch_embed.freq_kernel" in state) == kind.startswith("per_freq")
    assert ("patch_embed.proj.weight" in state) != kind.startswith("per_freq")
    assert ("dist_token" in state) == (kind == "per_freq")
    assert ("head_dist.weight" in state) == (kind == "per_freq")
    if kind.startswith("per_freq"):
        assert tuple(state["patch_embed.freq_kernel"].shape) == (3, 256, 64)
        assert tuple(state["patch_embed.freq_bias"].shape) == (3, 64)
    assert tuple(state["new_pos_embed"].shape) == (1, tcfg.num_tokens, 64)


@pytest.mark.parametrize("distilled_type", ["mean", "separated"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind, distilled_type):
    jnet, params, tnet = _pair(kind, distilled_type)
    x = _x()
    ours, ref = _torch(tnet, x), _jax(jnet, params, x)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("self_attn", [False, True], ids=["tokens", "attn"])
@pytest.mark.parametrize("kind", KINDS)
def test_transformer_block_taps(kind, block, self_attn):
    jnet, params, tnet = _pair(kind)
    x = _x()
    kw = dict(transformer_block=block, return_self_attention=self_attn)
    (jn, je), (tn, te) = _jax(jnet, params, x, **kw), _torch(tnet, x, **kw)
    assert jn is None and tn is None
    assert te.shape == (2, tnet.cfg.num_tokens * 64 + 64)
    _close(te, je)


@pytest.mark.parametrize("kind", KINDS)
def test_tap_block_layer_tokens_and_seams(kind):
    """``tap_block`` and ``return_layer_tokens`` against JAX; front ->
    blocks -> tail is the full forward bit for bit."""
    jnet, params, tnet = _pair(kind)
    x = _x()
    for a, b in zip(_torch(tnet, x, tap_block=1),
                    _jax(jnet, params, x, tap_block=1)):
        _close(a, b)
    ours = _torch(tnet, x, return_layer_tokens=True)
    ref = _jax(jnet, params, x, return_layer_tokens=True)
    _close(ours[0], ref[0])
    for a, b in zip(ours[-1], ref[-1]):
        assert a.shape == (2, tnet.cfg.num_tokens + 18, 64)
        _close(a, b)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        tokens, n = tnet(xt, forward_mode="front")
        assert n == tnet.stream_length(xt.shape) == tnet.cfg.num_tokens + 18
        for i in range(GEOM["depth"]):
            tokens = tnet.run_block(i, tokens)
        for a, b in zip(tnet(tokens, forward_mode="tail"), tnet(xt)):
            assert torch.equal(a, b)


def _loss_and_grads_jax(jnet, params, x, y):
    def loss(p):
        out = jnet.apply({"params": p}, jnp.asarray(x).transpose(0, 2, 3, 1),
                         train=True, rngs={"patchout": jax.random.PRNGKey(0)})
        return jax_bce(out[0], y)

    value, grads = jax.value_and_grad(loss)(params)
    return float(value), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", KINDS)
def test_train_forward_loss_and_gradients(kind, remat):
    """The train forward (static patchout indices, so neither side draws)
    and its gradients, with and without remat, against JAX's
    ``value_and_grad``; every gradient, the per-frequency rows among
    them."""
    over = dict(s_patchout_t_indices=(1, 4), remat=remat)
    jnet, params, tnet = _pair(kind, **over)
    x = _x(8)
    y = (np.random.default_rng(9).random((2, 10)) > 0.6).astype("f4")
    ref_loss, ref_grads = _loss_and_grads_jax(jnet, params, x, y)
    tnet.train()
    out = tnet(torch.from_numpy(x), train=True,
               generator=torch.Generator().manual_seed(0))
    loss = bce_with_logits(out[0], torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    ref = state_from_jax_params(ref_grads, tnet.cfg)
    # the "mean" head never reads head_dist, which JAX's tree leaves out
    got = {k: p.grad for k, p in tnet.named_parameters()
           if p.grad is not None}
    assert sorted(got) == sorted(ref)
    for k, g in ref.items():
        if k == "patch_embed.freq_kernel":  # every row has a gradient
            assert all(float(g[r].abs().max()) > 0 for r in range(3))
        _close(got[k].numpy(), g.numpy(), k)


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_matches_jax(kind):
    """One fp32 AdamW step through ``make_train_step`` against the JAX
    step: its loss and its gradients, read from Adam's first moment
    (0.1 g after one step). The parameters after the step are not
    compared element by element: Adam's first step moves each by about
    lr sign(g), so a gradient within roundoff of zero moves by anything
    up to 2 lr on one side and not the other."""
    over = dict(s_patchout_t_indices=(1,))
    params, jcfg, tcfg = _jax_params(kind, **over)
    jtx = jax_optimizer(lr_schedule=1e-3)
    jstate = JaxState.create(params, jtx, with_swa=False)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg))
    net_before = {k: v.clone() for k, v in net.state_dict().items()}
    ttx = make_optimizer(lr_schedule=1e-3)
    tstate = TrainState.create(net, ttx, with_swa=False)
    aug = dict(masking=False, mixup_alpha=0.0)
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 36, 66)).astype("f4") * 2 + 2,
             "y": (rng.random((4, 10)) > 0.7).astype("f4")}
    jstate, jm = jax_train_step(JaxNet(jcfg), jtx, JaxAugment(**aug),
                                donate=False)(jstate, batch,
                                              jax.random.PRNGKey(1))
    tstate, tm = make_train_step(net, ttx, AugmentConfig(**aug))(tstate,
                                                                 batch)
    np.testing.assert_allclose(tm["train_loss"], float(jm["train_loss"]),
                               rtol=1e-5)
    assert tm["nonfinite_skipped"] == 0.0 and tstate.count == 1
    mu = _find(jax.tree.map(np.asarray, jstate.opt_state), "mu", "nu",
               "count").mu
    ref = state_from_jax_params(mu, tcfg)
    named = dict(tstate.model.named_parameters())
    got = {k: tstate.optimizer.state[p]["exp_avg"] for k, p in named.items()
           if p in tstate.optimizer.state}
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        _close(got[k].numpy() / 0.1, v.numpy() / 0.1, k)
        assert not torch.equal(tstate.params[k], net_before[k]) or not bool(
            v.abs().max()), k


def test_per_freq_model_loads_a_shared_conv_checkpoint():
    """A shared-conv state dict loaded into a per-frequency model fills
    every row with the conv (the JAX loader's expansion), so it gives the
    conv model's outputs and the JAX per-frequency model's; the rows are
    not left at their random initialization."""
    _, jcfg, tcfg = _jax_params("per_freq")
    conv_cfg = tcfg.replace(per_freq_patch_embed=False)
    conv = MAESTNet(conv_cfg, generator=torch.Generator().manual_seed(3))
    for lin in (conv.head[1], conv.head_dist):
        torch.nn.init.normal_(lin.weight, std=0.3,
                              generator=torch.Generator().manual_seed(4))
    sd = {k: v.clone() for k, v in conv.state_dict().items()}
    net = MAESTNet(tcfg, generator=torch.Generator().manual_seed(9))
    before = net.patch_embed.freq_kernel.detach().clone()
    load_into(net, sd)
    assert not torch.equal(before, net.patch_embed.freq_kernel)
    x = _x(12)
    ref = torch_to_jax_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    jl = _jax(JaxNet(jcfg), ref, x)
    for a, b, c in zip(_torch(net.eval(), x), _torch(conv.eval(), x), jl):
        _close(a, b)
        _close(a, c)


def test_per_freq_params_from_conv_matches_jax():
    params, jcfg, tcfg = _jax_params("non_distilled")
    conv_state = state_from_jax_params(params, tcfg)
    ours, cfg = surgery.per_freq_params_from_conv(conv_state, tcfg)
    jp, jc = jsurgery.per_freq_params_from_conv(params, jcfg)
    assert cfg.per_freq_patch_embed and jc.per_freq_patch_embed
    ref = state_from_jax_params(jp, cfg)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert isinstance(ours[k], torch.Tensor), k
        np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)
    # numpy states stay numpy
    np_state = {k: v.numpy() for k, v in conv_state.items()}
    out, _ = surgery.per_freq_params_from_conv(np_state, tcfg)
    assert isinstance(out["patch_embed.freq_kernel"], np.ndarray)
    with pytest.raises(KeyError, match="patch_embed.proj"):
        surgery.per_freq_params_from_conv(ours, cfg)


@pytest.mark.parametrize("embed", ["default", "freq_embed", "overlap",
                                   "am_keepconv", "other"])
def test_fix_embedding_layer(embed):
    params, jcfg, tcfg = _jax_params("non_distilled")
    state = state_from_jax_params(params, tcfg)
    if embed in ("overlap", "am_keepconv"):
        for fn, args in ((surgery.fix_embedding_layer, (state, tcfg)),
                         (jsurgery.fix_embedding_layer, (params, jcfg))):
            with pytest.raises(NotImplementedError, match="undefined"):
                fn(*args, embed=embed)
        return
    if embed == "other":
        with pytest.raises(ValueError, match="unknown embed"):
            surgery.fix_embedding_layer(state, tcfg, embed)
        return
    ours, cfg = surgery.fix_embedding_layer(state, tcfg, embed)
    jp, jc = jsurgery.fix_embedding_layer(params, jcfg, embed)
    assert cfg.per_freq_patch_embed == jc.per_freq_patch_embed
    ref = state_from_jax_params(jp, cfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


LIGHTEN = [(0, 1), (0, 3), (1, 0), (2, 0), (3, 1), (-1, 0), (-2, 0), (-3, 0),
           (-2, 2), (4, 0)]


@pytest.mark.parametrize("cut_depth,remove_n", LIGHTEN)
def test_lighten_model_matches_jax(cut_depth, remove_n):
    """Blocks kept, in order and renumbered, as the JAX surgery keeps them
    (depth 6), and the lightened port model computes what the JAX one
    does."""
    params, jcfg, tcfg = _jax_params("per_freq", depth=6)
    state = state_from_jax_params(params, tcfg)
    ours, cfg = surgery.lighten_model(state, tcfg, cut_depth=cut_depth,
                                      remove_n_blocks=remove_n)
    jp, jc = jsurgery.lighten_model(params, jcfg, cut_depth=cut_depth,
                                    remove_n_blocks=remove_n)
    assert cfg.depth == jc.depth
    ref = state_from_jax_params(jp, cfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    net = load_into(MAESTNet(cfg), ours).eval()
    x = _x(13)
    _close(_torch(net, x)[0], _jax(JaxNet(jc), jp, x)[0])


@pytest.mark.parametrize("cut_depth,remove_n", [(5, 0), (0, 6), (0, -1),
                                                (-1, 6)])
def test_lighten_model_refusals(cut_depth, remove_n):
    params, jcfg, tcfg = _jax_params("non_distilled", depth=6)
    state = state_from_jax_params(params, tcfg)
    with pytest.raises(ValueError) as ours:
        surgery.lighten_model(state, tcfg, cut_depth=cut_depth,
                              remove_n_blocks=remove_n)
    with pytest.raises(ValueError) as ref:
        jsurgery.lighten_model(params, jcfg, cut_depth=cut_depth,
                               remove_n_blocks=remove_n)
    assert str(ours.value) == str(ref.value)
