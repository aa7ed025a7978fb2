"""The port's MAESTNet against the JAX package's, at a tiny geometry
(embed 64, depth 2, 4 heads, 26 x 46 input), with the same weights:
JAX ``init_params`` (heads perturbed so logits are not trivially zero)
-> ``state_from_jax_params`` -> the port. Tolerance rtol 2e-4, atol 2e-5,
the bound of tests/test_torch_parity.py (fp32 tier on both sides). The
train mode is held in tests/test_torch_vit_train.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu.models.surgery import per_freq_params_from_conv as per_freq_params_jax
from maest_tpu.packaging.hf_ast import jax_to_torch_state
from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.surgery import per_freq_params_from_conv
from maest_tpu_torch.models.vit import MAESTNet

TOL = dict(rtol=2e-4, atol=2e-5)
GEOM = dict(img_size=(26, 46), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_classes=10,
            distilled=True)


def _jax_params():
    """JAX init with random heads (they start at zero)."""
    cfg = JaxConfig(**GEOM, distilled_type="separated")
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for name in ("head_linear", "head_dist"):
        params[name]["kernel"] = rng.standard_normal((64, 10)).astype("f4") * 0.3
        params[name]["bias"] = rng.standard_normal(10).astype("f4") * 0.1
    params["head_norm"]["scale"] = 1 + rng.standard_normal(64).astype("f4") * 0.1
    return params


@pytest.fixture(scope="module")
def setup():
    params = _jax_params()
    x = np.random.default_rng(6).standard_normal((2, 1, 26, 46)).astype("f4")
    return params, x


def _pair(params, distilled_type="mean", **over):
    jcfg = JaxConfig(**GEOM, distilled_type=distilled_type, **over)
    tcfg = MAESTConfig(**GEOM, distilled_type=distilled_type, **over)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg)).eval()
    return JaxNet(jcfg), net


def _jax(net, params, x, **kw):
    return net.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 1),
                     train=False, **kw)


def _torch(net, x, **kw):
    with torch.inference_mode():
        return net(torch.from_numpy(x), **kw)


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **TOL)


def test_state_matches_jax_to_torch_state(setup):
    params, _ = setup
    cfg = MAESTConfig(**GEOM, distilled_type="separated")
    ours = state_from_jax_params(params, cfg)
    ref = jax_to_torch_state(params, cfg)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # the port's module holds exactly that key layout
    assert sorted(MAESTNet(cfg).state_dict()) == sorted(ref)


def test_logits_and_features(setup):
    params, x = setup
    jnet, tnet = _pair(params)
    (jl, jf), (tl, tf) = _jax(jnet, params, x), _torch(tnet, x)
    assert tl.shape == (2, 10) and tf.shape == (2, 64)
    _close(tl, jl)
    _close(tf, jf)


def test_separated_heads(setup):
    params, x = setup
    jnet, tnet = _pair(params, "separated")
    for ours, ref in zip(_torch(tnet, x), _jax(jnet, params, x)):
        _close(ours, ref)


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("self_attn", [False, True], ids=["tokens", "attn"])
def test_transformer_block_taps(setup, block, self_attn):
    params, x = setup
    jnet, tnet = _pair(params)
    kw = dict(transformer_block=block, return_self_attention=self_attn)
    (jn, je), (tn, te) = _jax(jnet, params, x, **kw), _torch(tnet, x, **kw)
    assert jn is None and tn is None and te.shape == (2, 3 * 64)
    _close(te, je)


def test_tap_block_and_layer_tokens(setup):
    params, x = setup
    jnet, tnet = _pair(params)
    ours = _torch(tnet, x, tap_block=0)
    ref = _jax(jnet, params, x, tap_block=0)
    for a, b in zip(ours, ref):
        _close(a, b)
    ours = _torch(tnet, x, return_layer_tokens=True)
    ref = _jax(jnet, params, x, return_layer_tokens=True)
    _close(ours[0], ref[0])
    assert len(ours[2]) == 2
    for a, b in zip(ours[2], ref[2]):
        assert a.shape == (2, 2 + 2 * 4, 64)
        _close(a, b)


def test_static_patchout_indices(setup):
    params, x = setup
    jnet, tnet = _pair(params, s_patchout_t_indices=(1, 2),
                       s_patchout_f_interleaved=2)
    _close(_torch(tnet, x)[0], _jax(jnet, params, x)[0])


def test_shorter_input_cuts_time_table(setup):
    params, x = setup
    jnet, tnet = _pair(params)
    short = x[..., :36]  # 3 time patches of the table's 4
    _close(_torch(tnet, short)[0], _jax(jnet, params, short)[0])


def test_range_checks_and_unported_modes(setup):
    params, x = setup
    _, tnet = _pair(params)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="out of range"):
        tnet(xt, transformer_block=2)
    with pytest.raises(ValueError, match="out of range"):
        tnet(xt, tap_block=-1)
    with pytest.raises(ValueError, match="exclusive"):
        tnet(xt, tap_block=0, return_layer_tokens=True)
    with pytest.raises(ValueError, match="time pos-embed"):
        tnet(torch.zeros(1, 1, 26, 66))
    # the train forward and the 8-bit attention modes are ported; unknown
    # modes and remat policies are refused when the module is built
    assert tnet(xt, train=True)[0].shape == (2, 10)
    q8net = MAESTNet(MAESTConfig(**GEOM, attention_quant="qk8pv8",
                                 attention_bwd_quant="int8"))
    assert q8net(xt, train=True)[0].shape == (2, 10)
    with pytest.raises(ValueError, match="attention_bwd_quant"):
        MAESTNet(MAESTConfig(**GEOM, attention_bwd_quant="fp8"))
    with pytest.raises(ValueError, match="attention_quant"):
        MAESTNet(MAESTConfig(**GEOM, attention_quant="int4"))
    with pytest.raises(ValueError, match="remat_policy"):
        MAESTNet(MAESTConfig(**GEOM, remat_policy="everything"))
    # the pipeline seams: front -> blocks -> tail is the forward, bit
    # for bit, and the seams take no tap
    with torch.inference_mode():
        tokens, n = tnet(xt, forward_mode="front")
        assert tokens.shape == (2, n, 64) and n == tnet.stream_length(xt.shape)
        for i in range(GEOM["depth"]):
            tokens = tnet.run_block(i, tokens)
        for a, b in zip(tnet(tokens, forward_mode="tail"), tnet(xt)):
            assert torch.equal(a, b)
    for kw in ({"tap_block": 0}, {"return_layer_tokens": True},
               {"transformer_block": 1}, {"return_self_attention": True}):
        with pytest.raises(ValueError, match="front/tail"):
            tnet(xt, forward_mode="front", **kw)
    with pytest.raises(ValueError, match="forward_mode"):
        tnet(xt, forward_mode="middle")
    # the per-frequency patch embedding is ported: the port's surgery on
    # the port's state gives the JAX surgery's model
    jp, jcfg = per_freq_params_jax(params, JaxConfig(**GEOM))
    state, pcfg = per_freq_params_from_conv(
        state_from_jax_params(params, MAESTConfig(**GEOM)), MAESTConfig(**GEOM))
    pnet = load_into(MAESTNet(pcfg), state).eval()
    _close(_torch(pnet, x)[0], _jax(JaxNet(jcfg), jp, x)[0])
    with pytest.raises(ValueError, match="distilled_type"):
        MAESTNet(MAESTConfig(**GEOM, distilled_type="max"))
