"""The port's train step against the JAX package's, on the CPU at a tiny
geometry (embed 64, depth 2, 4 heads, 26 x 46 input).

Random streams differ between the packages, so the augmentation tests
hand the port the draws JAX makes (the same key splits), and the step
tests run with masking off, mixup alpha 0 and fixed patchout indices.

Tolerances: augmentation and schedules are exact (the same fp32 / float32
arithmetic). A train step's loss rtol 1e-5; its parameters rtol 1e-4,
atol 2e-6 (XLA and PyTorch sum in other orders). One exception: the key
bias, whose gradient is exactly zero in exact arithmetic (each softmax row
is invariant to the shift q.b_k), so both packages' fp32 noise there is
what Adam normalises; it is held to Adam's bound instead, 2 lr per step.
Logits after a step: rtol 1e-4, atol 5e-5 (the ~1e-7 parameter
differences, amplified through the network).

The full-width golden of ``chip_smoke.py`` is made by this file:

    JAX_PLATFORMS=cpu python tests/test_torch_train.py --make-golden
"""

import dataclasses
import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: the packages of this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu.ops import augment as jaug
from maest_tpu.train import schedules as jsched
from maest_tpu.train.state import TrainState as JaxState
from maest_tpu.train.state import make_optimizer as jax_optimizer
from maest_tpu.train.state import swa_update as jax_swa_update
from maest_tpu.train.steps import AugmentConfig as JaxAugment
from maest_tpu.train.steps import make_eval_step as jax_eval_step
from maest_tpu.train.steps import make_predict_step as jax_predict_step
from maest_tpu.train.steps import make_train_step as jax_train_step
from maest_tpu_torch.checkpoints import (
    load_into,
    state_from_jax_params,
    train_state_from_jax,
)
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.vit import MAESTNet
from maest_tpu_torch.ops import augment as taug
from maest_tpu_torch.train import schedules as tsched
from maest_tpu_torch.train import (
    AugmentConfig,
    TrainState,
    augment_config,
    make_eval_step,
    make_optimizer,
    make_predict_step,
    make_train_step,
    swa_update,
)

ROOT = Path(__file__).resolve().parent.parent
GEOM = dict(img_size=(26, 46), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_classes=8,
            distilled=True)
STEP_TOL = dict(rtol=1e-4, atol=2e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=5e-5)


# --- augmentation with JAX's draws -----------------------------------------

def test_mixup_with_jax_draws():
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 1, 5, 7)).astype("f4")
    ys = (rng.random((6, 4)).astype("f4"), rng.random((6, 4)).astype("f4"))
    ref_x, ref_y = jaug.mixup(key, jnp.asarray(x), tuple(map(jnp.asarray, ys)),
                              0.3)
    k_perm, k_lam = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, 6))
    lam = np.asarray(jax.random.beta(k_lam, 0.3, 0.3, (6,)))
    lam = np.maximum(lam, 1.0 - lam)
    ours_x, ours_y = taug.apply_mixup(
        torch.from_numpy(x), tuple(map(torch.from_numpy, ys)),
        torch.from_numpy(perm.copy()), torch.from_numpy(lam))
    np.testing.assert_allclose(ours_x.numpy(), np.asarray(ref_x), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(ours_y, ref_y):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    # alpha <= 0 is off
    xt = torch.from_numpy(x)
    assert taug.mixup(xt, (), 0.0)[0] is xt


def test_mixup_draws_follow_the_folded_beta():
    """The port's own draws: a permutation, and lambda distributed as
    max(L, 1 - L) for L ~ Beta(0.3, 0.3) (moments against numpy's Beta
    sampler over 20000 draws, 3 standard errors)."""
    perm, lam = taug.mixup_draws(20000, 0.3, torch.Generator().manual_seed(1))
    assert sorted(perm.tolist()) == list(range(20000))
    ref = np.random.default_rng(2).beta(0.3, 0.3, 200000)
    ref = np.maximum(ref, 1.0 - ref)
    lam = lam.double().numpy()
    assert lam.min() >= 0.5 and lam.max() <= 1.0
    se = ref.std() / np.sqrt(20000)
    assert abs(lam.mean() - ref.mean()) < 3 * se
    assert abs(lam.std() - ref.std()) < 0.01


@pytest.mark.parametrize("iid", [True, False], ids=["iid", "shared"])
def test_spec_augment_with_jax_draws(iid):
    key = jax.random.PRNGKey(5)
    x = np.random.default_rng(3).standard_normal((4, 96, 187)).astype("f4")
    kw = dict(time_mask_param=8, freq_mask_param=5, p=0.2)
    ref = jaug.spec_augment(key, jnp.asarray(x), time_masks=20, freq_masks=8,
                            iid_masks=iid, **kw)
    b = 4 if iid else 1
    draws = []
    for k, m in zip(jax.random.split(key), (20, 8)):
        k_w, k_s = jax.random.split(k)
        draws.append(tuple(torch.from_numpy(np.asarray(
            jax.random.uniform(kk, (m, b)))) for kk in (k_w, k_s)))
    ours = taug.apply_spec_augment(torch.from_numpy(x), draws, **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (ours.numpy() == 0).any()
    # a 4-D (B, C, F, T) batch takes the same masks
    ours4 = taug.apply_spec_augment(torch.from_numpy(x)[:, None], draws, **kw)
    np.testing.assert_array_equal(ours4[:, 0].numpy(), ours.numpy())


def test_roll_with_jax_draw():
    key = jax.random.PRNGKey(7)
    x = np.arange(2 * 3 * 11, dtype="f4").reshape(2, 3, 11)
    ref = jaug.roll_augment(key, jnp.asarray(x), 5)
    shift = int(jax.random.randint(key, (), -5, 6))
    ours = taug.roll_augment(torch.from_numpy(x), 5, shift=shift)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    drawn = taug.roll_augment(torch.from_numpy(x), 5,
                              generator=torch.Generator().manual_seed(0))
    assert any(np.array_equal(drawn.numpy(), np.roll(x, s, -1))
               for s in range(-5, 6))


# --- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("exp_rampup", (5,)),
    ("linear_rampdown", (50, 100, 0.01)),
    ("exp_warmup_linear_down", (5, 50, 50, 0.01)),
    ("cosine_cycle", (5, 100, 0.01)),
    ("cosine_cycle", (20, 100, 0.01)),
])
def test_epoch_multipliers_match_jax(name, args):
    ours, ref = getattr(tsched, name)(*args), getattr(jsched, name)(*args)
    assert [ours(e) for e in range(200)] == [ref(e) for e in range(200)]


@pytest.mark.parametrize("mode", ["exp_lin", "cos_cyc", "constant"])
@pytest.mark.parametrize("swa", [False, True], ids=["plain", "swa"])
def test_make_schedule_matches_jax(mode, swa):
    kw = dict(warm_up_len=5, ramp_down_start=50, ramp_down_len=50,
              last_lr_value=0.01, do_swa=swa, swa_epoch_start=50,
              swa_lr=2e-5, swa_anneal_epochs=10)
    # 2.5 optimizer steps an epoch: fractional under accumulation
    ours = tsched.make_schedule(mode, 1e-4, 2.5, **kw)
    ref = jsched.make_schedule(mode, 1e-4, 2.5, **kw)
    steps = list(range(0, 500)) + [10**6]
    assert [ours(s) for s in steps] == [float(ref(s)) for s in steps]
    with pytest.raises(ValueError, match="unknown"):
        tsched.make_schedule("linear", 1e-4, 1)


@pytest.mark.parametrize("anneal", [0, 10])
def test_swa_lr_overlay_matches_jax(anneal):
    lam = tsched.exp_warmup_linear_down(5, 50, 50, 0.01)
    table = np.array([1e-4 * lam(e) for e in range(200)], np.float32)
    kw = dict(swa_epoch_start=50, swa_lr=2e-5, anneal_epochs=anneal)
    np.testing.assert_array_equal(
        tsched.swa_lr_overlay(table.copy(), 1e-4, lam, **kw),
        jsched.swa_lr_overlay(table.copy(), 1e-4,
                              jsched.exp_warmup_linear_down(5, 50, 50, 0.01),
                              **kw))


# --- the train step ------------------------------------------------------------

def _batch(b=4, classes=8, seed=0, teacher=False):
    rng = np.random.default_rng(seed)
    out = {"x": rng.standard_normal((b, 26, 46)).astype("f4") * 2 + 2,
           "y": (rng.random((b, classes)) > 0.7).astype("f4")}
    if teacher:
        out["y_teacher"] = rng.random((b, classes)).astype("f4")
    return out


def _setup(distilled_type="mean", accumulate=1, lr=1e-3, with_swa=True,
           **over):
    """JAX and port states from the same initial parameters, both with
    masking off, mixup off and the fixed patchout indices (1,)."""
    kw = dict(GEOM, distilled_type=distilled_type, s_patchout_t_indices=(1,),
              **over)
    jcfg, tcfg = JaxConfig(**kw), MAESTConfig(**kw)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    for name in ("head_linear", "head_dist"):
        if name in params:  # heads start at zero: give them a gradient path
            params[name]["kernel"] = rng.standard_normal(
                params[name]["kernel"].shape).astype("f4") * 0.2
    sched = jsched.make_schedule("exp_lin", lr, 1, warm_up_len=2)
    jtx = jax_optimizer(lr_schedule=sched, accumulate_steps=accumulate)
    jstate = JaxState.create(params, jtx, with_swa=with_swa)
    ttx = make_optimizer(lr_schedule=tsched.make_schedule(
        "exp_lin", lr, 1, warm_up_len=2), accumulate_steps=accumulate)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg))
    tstate = TrainState.create(net, ttx, with_swa=with_swa)
    return (JaxNet(jcfg), jtx, jstate), (net, ttx, tstate), tcfg


AUG_OFF = dict(masking=False, mixup_alpha=0.0)


def _assert_params(ours, jparams, tcfg, lr_sum):
    """Every tensor of ``ours`` (name -> tensor) within STEP_TOL of the JAX
    tree, the key bias within 2 lr a step (``lr_sum``: the learning rates
    of the steps taken)."""
    ref = state_from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    e = tcfg.embed_dim
    for k, v in ref.items():
        a, b = ours[k].detach().numpy(), v.numpy()
        if k.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                       atol=2 * lr_sum, err_msg=k)
            a, b = np.delete(a, np.s_[e:2 * e]), np.delete(b, np.s_[e:2 * e])
        np.testing.assert_allclose(a, b, err_msg=k, **STEP_TOL)


def test_three_fp32_steps_match_jax():
    """Loss and every parameter after each of 3 AdamW steps (warmup
    schedule, so the learning rate changes every step)."""
    (jnet, jtx, jst), (net, ttx, tst), tcfg = _setup()
    jstep = jax_train_step(jnet, jtx, JaxAugment(**AUG_OFF), donate=False)
    tstep = make_train_step(net, ttx, AugmentConfig(**AUG_OFF))
    key = jax.random.PRNGKey(1)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(seed=i)
        jst, jm = jstep(jst, batch, key)
        tst, tm = tstep(tst, batch)
        lr_sum += ttx.lr(i)
        assert tm["nonfinite_skipped"] == 0.0 and tst.step == i + 1
        np.testing.assert_allclose(tm["train_loss"], float(jm["train_loss"]),
                                   rtol=1e-5)
        _assert_params(tst.params, jst.params, tcfg, lr_sum)
    assert tst.count == 3


def test_teacher_student_step_matches_jax():
    (jnet, jtx, jst), (net, ttx, tst), tcfg = _setup("separated")
    jstep = jax_train_step(jnet, jtx, JaxAugment(**AUG_OFF),
                           teacher_student=True, donate=False)
    tstep = make_train_step(net, ttx, AugmentConfig(**AUG_OFF),
                            teacher_student=True)
    batch = _batch(teacher=True)
    jst, jm = jstep(jst, batch, jax.random.PRNGKey(1))
    tst, tm = tstep(tst, batch)
    assert set(tm) == set(jm)
    for k in ("train_loss", "train_loss_standard", "train_loss_teacher"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(
        tm["train_loss"],
        (tm["train_loss_standard"] + tm["train_loss_teacher"]) / 2, rtol=1e-6)
    _assert_params(tst.params, jst.params, tcfg, ttx.lr(0))
    with pytest.raises(ValueError, match="separated"):
        make_train_step(MAESTNet(MAESTConfig(**GEOM)), ttx,
                        teacher_student=True)


def _snapshot(state):
    params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    opt = {id(p): {k: v.clone() for k, v in s.items()}
           for p, s in state.optimizer.state.items()}
    return params, opt, {k: v.clone() for k, v in state.accum.items()}


def _assert_same(state, snap):
    params, opt, accum = snap
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k
    assert set(opt) == {id(p) for p in state.optimizer.state}
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt[id(p)][k]), k
    for k, v in state.accum.items():
        assert torch.equal(v, accum[k]), k


@pytest.mark.parametrize("accumulate", [1, 2])
def test_nan_guard(accumulate):
    """A non-finite batch leaves parameters, optimizer state and
    accumulator unchanged; the step counter still advances."""
    _, (net, ttx, tst), _ = _setup(accumulate=accumulate)
    step = make_train_step(net, ttx, AugmentConfig(**AUG_OFF))
    tst, _ = step(tst, _batch())  # a good step first: live moments
    snap = _snapshot(tst)
    mini = tst.mini_step
    bad = dict(_batch(seed=1))
    bad["x"] = np.full_like(bad["x"], np.nan)
    tst, m = step(tst, bad)
    assert m["nonfinite_skipped"] == 1.0 and tst.step == 2
    assert tst.mini_step == mini
    _assert_same(tst, snap)


def test_accumulate_two_half_batches_equal_one_full_batch():
    """accumulate_steps 2 over two halves of a batch gives the update of
    one step over the full batch (as tests/test_grad_accum.py), and the
    parameters stay frozen between optimizer steps."""
    _, (net_a, tx_a, full), tcfg = _setup()
    _, (net_b, tx_b, acc), _ = _setup(accumulate=2)
    batch = _batch(b=8)
    full, _ = make_train_step(net_a, tx_a, AugmentConfig(**AUG_OFF))(full, batch)
    step = make_train_step(net_b, tx_b, AugmentConfig(**AUG_OFF))
    before = {k: p.detach().clone() for k, p in net_b.named_parameters()}
    acc, _ = step(acc, {k: v[:4] for k, v in batch.items()})
    for k, p in net_b.named_parameters():
        assert torch.equal(p.detach(), before[k]), k
    acc, _ = step(acc, {k: v[4:] for k, v in batch.items()})
    assert acc.count == 1 and acc.mini_step == 0
    for (k, a), b in zip(net_a.named_parameters(), net_b.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_resume_jax_state_for_one_step(accumulate):
    """train_state_from_jax: a JAX state after one step (live Adam moments,
    a swa_update, and for MultiSteps a half-full accumulator) continues in
    both packages to the same parameters and SWA weights."""
    (jnet, jtx, jst), (net, ttx, _), tcfg = _setup(accumulate=accumulate)
    jstep = jax_train_step(jnet, jtx, JaxAugment(**AUG_OFF), donate=False)
    key = jax.random.PRNGKey(1)
    jst, _ = jstep(jst, _batch(seed=0), key)
    jst = jax_swa_update(jst)
    tst = train_state_from_jax(jax.tree.map(np.asarray, jst), tcfg, ttx)
    assert (tst.step, tst.swa_n) == (1, 1)
    assert tst.count == (1 if accumulate == 1 else 0)
    assert tst.mini_step == (0 if accumulate == 1 else 1)
    jst, jm = jstep(jst, _batch(seed=1), key)
    tst, tm = make_train_step(tst.model, ttx, AugmentConfig(**AUG_OFF))(
        tst, _batch(seed=1))
    np.testing.assert_allclose(tm["train_loss"], float(jm["train_loss"]),
                               rtol=1e-5)
    _assert_params(tst.params, jst.params, tcfg, ttx.lr(0) + ttx.lr(1))
    jst, tst = jax_swa_update(jst), swa_update(tst)
    _assert_params(tst.swa_params, jst.swa_params, tcfg,
                   ttx.lr(0) + ttx.lr(1))


def test_eval_and_predict_steps_match_jax():
    (jnet, jtx, jst), (net, ttx, tst), tcfg = _setup()
    step = make_train_step(net, ttx, AugmentConfig(**AUG_OFF))
    jstep = jax_train_step(jnet, jtx, JaxAugment(**AUG_OFF), donate=False)
    tst, _ = step(tst, _batch())
    jst, _ = jstep(jst, _batch(), jax.random.PRNGKey(1))
    x = _batch(seed=3)["x"]
    ours, ref = make_eval_step(net)(tst, x), jax_eval_step(jnet)(jst, x)
    assert set(ours) == {"", "swa"} and ours[""].dtype == torch.float32
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   **LOGIT_TOL)
    # SWA holds the initial weights: its logits are not the live ones
    assert not np.allclose(ours[""].numpy(), ours["swa"].numpy())
    ours = make_predict_step(net)(tst.params, {"x": x}, 1)
    ref = jax_predict_step(jnet)(jst.params, {"x": x}, 1)
    for k in ("logits", "embeddings"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   **LOGIT_TOL)


def test_swa_update_running_mean_and_no_buffer():
    _, (net, ttx, tst), _ = _setup()
    w = net.norm.weight
    for i in range(3):
        with torch.no_grad():
            w.fill_(float(i))
        swa_update(tst)
    assert tst.swa_n == 3
    assert torch.allclose(tst.swa_params["norm.weight"], torch.ones_like(w))
    _, (_, _, bare), _ = _setup(with_swa=False)
    assert bare.swa_params == {}


def test_augment_config_matches_jax_loop():
    from maest_tpu.configs import build_experiment_config
    from maest_tpu.train.loop import _augment_config
    from maest_tpu_torch.configs import build_experiment_config as ours

    cfg = build_experiment_config(["maest_30s_from_passt_pretrain"],
                                  ["maest.pretrained=False"])
    assert cfg == ours(["maest_30s_from_passt_pretrain"],
                       ["maest.pretrained=False"])
    assert dataclasses.asdict(augment_config(cfg)) == dataclasses.asdict(
        _augment_config(cfg))
    assert dataclasses.asdict(AugmentConfig()) == dataclasses.asdict(
        JaxAugment())


# --- repairs ---------------------------------------------------------------

def test_fp32_parameters_keep_a_small_adamw_step():
    """An lr 1e-5 AdamW step on a weight near 1 is below bf16's spacing
    there (2^-7): a bf16-stored parameter loses it, an fp32 parameter under
    the same bf16 compute keeps it."""
    cfg = MAESTConfig(**GEOM)
    moved = {}
    for store in (torch.bfloat16, torch.float32):
        net = MAESTNet(cfg, dtype=torch.bfloat16, param_dtype=store,
                       generator=torch.Generator().manual_seed(0))
        with torch.no_grad():  # a live head, so the norms get gradients
            net.head[1].weight.normal_(0, 0.2, generator=torch.Generator(
                ).manual_seed(1))
        tx = make_optimizer(lr_schedule=1e-5)
        st = TrainState.create(net, tx, with_swa=False)
        assert bool((net.norm.weight == 1).all())
        st, m = make_train_step(net, tx, AugmentConfig(**AUG_OFF))(st, _batch())
        assert m["nonfinite_skipped"] == 0.0
        moved[store] = float((net.norm.weight.detach().float() - 1).abs().max())
    assert moved[torch.bfloat16] == 0.0
    assert 5e-6 < moved[torch.float32] < 2e-5


def test_int8_backward_is_refused():
    """attention_bwd_quant="int8" once built and trained on the bf16
    backward without a word, then was refused; now it reaches the model
    from get_maest and the train step runs the int8 backward (the plain
    K7 on the CPU), and an unknown mode is refused."""
    from maest_tpu_torch import get_maest
    from maest_tpu_torch.ops import attention as A

    m = get_maest(pretrained=False, device="cpu", embed_dim=64, depth=1,
                  num_heads=1, attention_bwd_quant="int8",
                  attention_quant="qk8")
    assert (m.net.cfg.attention_bwd_quant, m.net.cfg.attention_quant) == (
        "int8", "qk8")
    from maest_tpu_torch.configs import build_experiment_config
    from maest_tpu_torch.train import model_config
    mc = model_config(build_experiment_config([], [
        "maest.attention_quant=fp8pv8", "maest.attention_bwd_quant=int8"]))
    assert (mc.attention_quant, mc.attention_bwd_quant) == ("fp8pv8", "int8")
    (jn, jtx, js), (net, ttx, tst), tcfg = _setup(attention_bwd_quant="int8")
    calls = []
    orig = A.attention_bwd_int8_reference
    try:
        A.attention_bwd_int8_reference = lambda *a: calls.append(1) or orig(*a)
        tst, tm = make_train_step(net, ttx, AugmentConfig(**AUG_OFF))(
            tst, _batch())
    finally:
        A.attention_bwd_int8_reference = orig
    assert len(calls) == tcfg.depth and np.isfinite(tm["train_loss"])
    assert tm["nonfinite_skipped"] == 0.0
    with pytest.raises(ValueError, match="attention_bwd_quant"):
        get_maest(pretrained=False, device="cpu", embed_dim=64, depth=1,
                  num_heads=1, attention_bwd_quant="int4")


# --- full-width golden -------------------------------------------------------

GOLDEN = ROOT / "tests" / "golden" / "vitb_30s_train_step.npz"
GOLDEN_SEED = 20261016
GOLDEN_LR = 1e-4


def make_golden():
    """One fp32 JAX train step of ViT-B at the 30 s geometry, batch 2: the
    seeded torch-layout state of ``torch_oracle.make_state``, masking and
    mixup off, the 90 dropped time columns of the recipe given as
    ``s_patchout_t_indices`` (N = 9 * 96 + 2 = 866). Stores the loss, the
    L2 norm of every gradient, the full gradients of the tensors of at most
    768 values, the time pos-embed crop offset JAX drew, and the logits of
    the stepped parameters on the same batch."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_oracle import make_state

    from maest_tpu.checkpoints import merge_params, torch_to_jax_params
    from maest_tpu.models.registry import build_config
    from maest_tpu.train.steps import _prepare, bce_with_logits

    rng = np.random.default_rng(GOLDEN_SEED)
    drop = np.sort(rng.choice(186, 90, replace=False))
    cfg = build_config("discogs-maest-30s-pw-129e",
                       s_patchout_t_indices=tuple(int(i) for i in drop))
    sd = make_state(rng, cfg)
    x = rng.standard_normal((2, 96, 1875)).astype("f4") + 2.0
    y = (rng.random((2, 400)) < 0.05).astype("f4")
    params = merge_params(init_params(cfg, jax.random.PRNGKey(0)),
                          torch_to_jax_params({k: v.numpy() for k, v in sd.items()},
                                              cfg))
    net = JaxNet(cfg)
    aug = JaxAugment(**AUG_OFF)
    tx = jax_optimizer(lr_schedule=GOLDEN_LR, weight_decay=1e-4)
    state = JaxState.create(params, tx, with_swa=False)
    key = jax.random.PRNGKey(0)

    # the crop offset of the time pos-embed table (187 entries, 186 time
    # patches): the step's patchout key, as make_train_step splits it
    k_patch = jax.random.split(jax.random.fold_in(key, 0), 5)[2]
    xp = _prepare(jnp.asarray(x), aug, None, train=False)
    front = lambda train: np.asarray(net.apply(  # noqa: E731
        {"params": params}, xp, train=train, forward_mode="front",
        rngs={"patchout": k_patch, "droppath": k_patch, "dropout": k_patch})[0])
    offset = 0 if np.array_equal(front(True), front(False)) else 1

    def loss_fn(p):  # the step's loss: the same rngs and prepared batch
        out = net.apply({"params": p}, xp, train=True,
                        rngs={"patchout": k_patch, "droppath": k_patch,
                              "dropout": k_patch})
        return bce_with_logits(out[0], jnp.asarray(y))

    grads = jax.jit(jax.grad(loss_fn))(params)
    state, m = jax_train_step(net, tx, aug, donate=False)(
        state, {"x": x, "y": y}, key)
    logits = np.asarray(jax.jit(lambda p: net.apply({"params": p}, xp)[0])(
        state.params))
    g = state_from_jax_params(jax.tree.map(np.asarray, grads), cfg)
    out = {"seed": np.int64(GOLDEN_SEED), "lr": np.float64(GOLDEN_LR),
           "drop_t": drop.astype(np.int64), "time_offset": np.int64(offset),
           "loss": np.float32(m["train_loss"]), "logits": logits,
           "nonfinite_skipped": np.float32(m["nonfinite_skipped"])}
    for k, v in g.items():
        out["norm:" + k] = np.float64(np.linalg.norm(v.numpy().astype("f8")))
        if v.numel() <= 768:
            out["grad:" + k] = v.numpy()
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: loss {out['loss']:.6f}, time offset {offset}, "
          f"{sum(k.startswith('grad:') for k in out)} small gradients")


if __name__ == "__main__":
    if "--make-golden" not in sys.argv:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_train.py "
                 "--make-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    make_golden()
