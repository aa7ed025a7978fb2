"""The port's GPipe pipeline across real processes (gloo on the CPU)
against the JAX package's single-device step over the same global batch,
its pipelined forward, and the port's one process.

Geometry: ``tests/test_torch_parallel.py``'s tiny model (embed 64, 4
heads, 8 classes, 36 x 46 input with the fixed time patchout index 1, 11
tokens) at depth 4, so 2 stages hold 2 blocks each. Global batch 4, 3
AdamW steps on a warmup schedule.

One spawn per world size runs every mode inside it: at 2 processes pp
(2 stages) with 2 and with 4 microbatches; at 4 dp+pp (data 2), pp+tp
(model 2 in each stage) and dp+pp+fsdp (FSDP2 over each stage's data
ranks), 2 microbatches; at 8 dp+pp+tp. Each rank first runs one
pipelined eval forward (M = 1) on the initial weights, then steps on its
rows of the global batches, and writes its losses and the whole
parameters gathered from every stage and shard.

Tolerances, as ``tests/test_torch_parallel.py``: losses rtol 1e-5;
parameters rtol 1e-4, atol 2e-6, and within 2 lr a step the elements
whose gradient is fp32 noise, which Adam's first update normalises to a
whole step of the noise's sign: there the key bias (zero in exact
arithmetic), and at depth 4 also some 75 other elements of the 217864
whose first gradient lies below 1e-4 of its tensor's median (the port's
one process departs from the JAX step in one of them,
``blocks.2.mlp.fc1.weight``, first gradient 1.8e-8 against a median of
9e-3; a pipeline, whose microbatches sum in another order, in others).
The
eval logits against JAX ``make_pipeline_forward`` on the 8 virtual
devices at rtol 1e-5, atol 1e-6 (``tests/test_pipeline_parallel.py``'s
bound for the pipelined forward against the sequential one). Every
rank's gathered parameters are equal bit for bit.

With randomness on (SpecAugment, mixup, random time patchout,
unstructured patchout, dropout, attention dropout), with remat under
dropout, and teacher-student: the ranks against the port's one process
at the same tolerances (the JAX package draws its pipeline's dropout
from other keys).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu.parallel.pipeline import make_pipeline_forward as jax_pp_forward
from maest_tpu.parallel.pipeline import make_pipeline_mesh as jax_pp_mesh
from maest_tpu.train import schedules as jsched
from maest_tpu.train.state import TrainState as JaxState
from maest_tpu.train.state import make_optimizer as jax_optimizer
from maest_tpu.train.steps import AugmentConfig as JaxAugment
from maest_tpu.train.steps import make_train_step as jax_train_step
from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.vit import MAESTNet
from maest_tpu_torch.parallel import pipeline
from maest_tpu_torch.parallel.launch import spawn
from maest_tpu_torch.train import schedules as tsched

import torch_parallel_worker as W

GEOM = dict(img_size=(36, 46), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=4, num_heads=4, mlp_ratio=4.0, num_classes=8,
            distilled=True, distilled_type="mean", s_patchout_t_indices=(1,))
AUG_OFF = dict(masking=False, mixup_alpha=0.0)
RANDOM_AUG = dict(time_mask_param=4, freq_mask_param=3, mixup_alpha=0.3)
STEP_TOL = dict(rtol=1e-4, atol=2e-6)
EVAL_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
STEPS = 3
TIMEOUT = 180.0


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The initial weights (JAX's, class head drawn), 3 global batches of
    4 with teacher targets, an eval batch of 4, the JAX single-device run
    over the batches (losses, parameters) and JAX's pipelined forward of
    the eval batch over 2 stages of the 8 virtual devices."""
    jcfg = JaxConfig(**GEOM)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    params["head_linear"]["kernel"] = np.random.default_rng(9).standard_normal(
        params["head_linear"]["kernel"].shape).astype("f4") * 0.2
    rng = np.random.default_rng(0)
    batches = [{"x": (rng.standard_normal((4, 36, 46)) * 2 + 2).astype("f4"),
                "y": (rng.random((4, 8)) > 0.7).astype("f4")}
               for _ in range(STEPS)]
    teacher = [(rng.random((4, 8)) > 0.6).astype("f4") for _ in range(STEPS)]
    eval_x = rng.standard_normal((4, 1, 36, 46)).astype("f4")
    jtx = jax_optimizer(lr_schedule=jsched.make_schedule(
        "exp_lin", LR, 1, warm_up_len=2))
    jstate = JaxState.create(params, jtx, with_swa=False)
    jstep = jax_train_step(JaxNet(jcfg), jtx, JaxAugment(**AUG_OFF),
                           donate=False)
    losses = []
    for batch in batches:
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(1))
        losses.append(float(m["train_loss"]))
    fwd = jax_pp_forward(JaxNet(jcfg), jax_pp_mesh(8, num_stages=2),
                         num_microbatches=1)
    jax_eval = np.asarray(fwd(params, jnp.asarray(eval_x).transpose(
        0, 2, 3, 1))[0])
    tcfg = MAESTConfig(**GEOM)
    out = tmp_path_factory.mktemp("pipeline")
    s = dict(geom=GEOM, random_geom={}, state=state_from_jax_params(params,
                                                                    tcfg),
             batches=batches, teacher_targets=teacher, eval_x=eval_x, lr=LR,
             seed=5, aug=AUG_OFF, random_aug=RANDOM_AUG)
    torch.save(s, out / "spec.pt")
    lr_sum = sum(tsched.make_schedule("exp_lin", LR, 1, warm_up_len=2)(i)
                 for i in range(STEPS))
    return dict(spec=s, path=out / "spec.pt", out=out, jax_losses=losses,
                noise=_noise(s),
                jax_params=state_from_jax_params(
                    jax.tree.map(np.asarray, jstate.params), tcfg),
                jax_eval=jax_eval, jax_net=JaxNet(jcfg), params=params,
                lr_sum=lr_sum)


RUNS = {2: ["pp", "pp-m4", "pp:random", "pp:remat", "pp:ts"],
        4: ["dp+pp", "pp+tp", "dp+pp+fsdp", "dp+pp:random"],
        8: ["dp+pp+tp"]}


@pytest.fixture(scope="module")
def runs(spec):
    """One spawn per world size, every mode inside it: mode -> the list
    of each rank's record."""
    out = {}
    for world, modes in RUNS.items():
        spawn(W.run_pipeline_modes, world, str(spec["path"]),
              str(spec["out"]), modes, timeout=TIMEOUT)
        for mode in modes:
            out[mode] = [torch.load(spec["out"] / f"{mode}.{r}.pt")
                         for r in range(world)]
    return out


def _noise(spec) -> dict:
    """name -> the elements whose first gradient (the port's one process,
    fp32) lies below 1e-4 of its tensor's median magnitude."""
    from maest_tpu_torch.train.steps import AugmentConfig, _prepare
    from maest_tpu_torch.train.steps import bce_with_logits

    net = load_into(MAESTNet(MAESTConfig(**GEOM)), spec["state"])
    batch = spec["batches"][0]
    x = _prepare(torch.as_tensor(batch["x"]), AugmentConfig(**AUG_OFF), None,
                 train=True)
    bce_with_logits(net(x, train=True)[0],
                    torch.as_tensor(batch["y"])).backward()
    return {k: (p.grad.abs() < 1e-4 * p.grad.abs().median()).numpy()
            for k, p in net.named_parameters() if p.grad is not None}


def _assert_params(ours: dict, ref: dict, lr_sum: float, noise: dict):
    """STEP_TOL, the elements of ``noise`` within 2 lr a step."""
    assert set(ref) <= set(ours)
    for k, v in ref.items():
        a, b = ours[k].numpy(), v.numpy()
        z = noise.get(k, np.zeros(b.shape, bool))
        np.testing.assert_allclose(a[z], b[z], rtol=0, atol=2 * lr_sum,
                                   err_msg=k)
        np.testing.assert_allclose(a[~z], b[~z], err_msg=k, **STEP_TOL)


def _assert_ranks_equal(ranks: list):
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


def _stage_of(mode, world, rank):
    stages, model, _, _ = W.PIPE_MODES[world][mode]
    return rank // model % stages


@pytest.mark.parametrize("mode", ["pp", "pp-m4", "dp+pp", "pp+tp",
                                  "dp+pp+fsdp", "dp+pp+tp"])
def test_mode_matches_jax_single_device(runs, spec, mode):
    ranks = runs[mode]
    world = len(ranks)
    stages, model, fsdp, _ = W.PIPE_MODES[world][mode]
    desc = ranks[0]["describe"]
    assert f"pipe {stages}" in desc and f"model {model}" in desc
    assert "gloo" in desc and ("fsdp" in desc) == fsdp
    # each rank holds the embeddings, the heads and its stage's blocks
    for r, rec in enumerate(ranks):
        s = _stage_of(mode, world, r)
        blocks = {int(k.split(".")[1]) for k in rec["held"]
                  if k.startswith("blocks.")}
        assert blocks == {2 * s, 2 * s + 1}, (r, blocks)
        assert "patch_embed.proj.weight" in rec["held"]
        assert "head.1.weight" in rec["held"]
    np.testing.assert_allclose(ranks[0]["losses"], spec["jax_losses"],
                               rtol=1e-5)
    _assert_params(ranks[0]["params"], spec["jax_params"], spec["lr_sum"],
                   spec["noise"])
    _assert_ranks_equal(ranks)


def test_eval_matches_jax_pipeline_forward(runs, spec):
    """One pipelined eval (M = 1) at pp 2 on the initial weights against
    JAX ``make_pipeline_forward`` over 2 stages of the 8 virtual
    devices; every stage returns the last stage's logits."""
    ranks = runs["pp"]
    for rec in ranks:
        np.testing.assert_allclose(rec["logits"].numpy(), spec["jax_eval"],
                                   **EVAL_TOL)
    assert torch.equal(ranks[0]["logits"], ranks[1]["logits"])
    # dp+pp: each data rank's rows
    rows = [runs["dp+pp"][r]["logits"] for r in (0, 2)]
    np.testing.assert_allclose(torch.cat(rows).numpy(), spec["jax_eval"],
                               **EVAL_TOL)


@pytest.mark.parametrize("mode", ["pp:random", "dp+pp:random", "pp:remat",
                                  "pp:ts"])
def test_pipeline_matches_one_process(runs, spec, mode):
    """Randomness on (SpecAugment, mixup, patchout, dropout), remat under
    dropout, teacher-student: the ranks against the port's one process
    with the same seeded generators."""
    ranks = runs[mode]
    variant = mode.partition(":")[2]
    losses, params = W.one_process(spec["spec"], False, variant=variant)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    _assert_params(ranks[0]["params"], params, spec["lr_sum"],
                   spec["noise"])
    _assert_ranks_equal(ranks)
    if variant == "random":  # the draws are on
        assert not np.allclose(losses, spec["jax_losses"], rtol=1e-3)


def test_front_blocks_tail_match_jax(spec):
    """The seams against JAX ``forward_mode`` front/tail in eval, and
    front -> blocks -> tail against the port's forward bit for bit in a
    train forward with dropout, patchout and remat."""
    params = spec["params"]
    net = load_into(MAESTNet(MAESTConfig(**GEOM)), spec["spec"]["state"])
    x = spec["spec"]["eval_x"]
    jnet = spec["jax_net"]
    jx = jnp.asarray(x).transpose(0, 2, 3, 1)
    jtok, jn = jnet.apply({"params": params}, jx, forward_mode="front")
    jout = jnet.apply({"params": params}, jtok, forward_mode="tail")
    with torch.no_grad():
        tok, n = net(torch.from_numpy(x), forward_mode="front")
        assert n == jn == tok.shape[1] == 11
        np.testing.assert_allclose(tok.numpy(), np.asarray(jtok)[:, :n],
                                   rtol=1e-5, atol=1e-6)
        out = net(torch.from_numpy(np.asarray(jtok)), forward_mode="tail")
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)

    cfg = MAESTConfig(**dict(GEOM, s_patchout_t_indices=(), s_patchout_t=1,
                             u_patchout=2, drop_rate=0.1, attn_drop_rate=0.1,
                             remat=True))
    net = load_into(MAESTNet(cfg), spec["spec"]["state"])
    xt = torch.from_numpy(x)
    draws = net.draw_train(torch.Generator().manual_seed(3),
                           *net.patch_grid(xt.shape))
    ref = net(xt, train=True, draws=draws)
    tok, n = net(xt, train=True, draws=draws, forward_mode="front")
    assert n == net.stream_length(xt.shape, draws) == 9
    seeds = net.block_seeds(draws)
    for i in range(cfg.depth):
        tok = net.run_block(i, tok, seeds[i], n, remat=True)
    for a, b in zip(net(tok, forward_mode="tail"), ref):
        assert torch.equal(a, b)


class _Par:
    """A rank's place, as ``Parallel`` gives it, for the refusals."""

    def __init__(self, data=1, pipe=2, model=1, sp=False):
        self.data, self.pipe, self.model = data, pipe, model
        self.sequence_parallel = sp


@pytest.mark.parametrize("change, par, match", [
    (dict(depth=3), _Par(), "depth 3 not divisible by pipe=2"),
    (dict(num_heads=2, embed_dim=64), _Par(model=4),
     "num_heads 2 not divisible by model=4"),
    (dict(mlp_ratio=4.015625), _Par(model=2),
     "MLP hidden dim 257 not divisible by model=2"),
    ({}, _Par(model=2, sp=True), "sequence_parallel composes with TP, not PP"),
])
def test_model_refusals(change, par, match):
    """What ``pipeline_trunk`` and ``make_pipeline_train_step`` refuse
    (maest_tpu/parallel/pipeline.py:348-380, 547-551), in their words."""
    cfg = MAESTConfig(**dict(GEOM, **change))
    with pytest.raises(ValueError, match=match):
        pipeline.check_model(cfg, par)


def test_call_refusals():
    cfg = MAESTConfig(**dict(GEOM, drop_path_rate=0.1))
    with pytest.raises(NotImplementedError, match="stochastic depth"):
        pipeline.check_batch(cfg, _Par(), 4, 2, train=True)
    pipeline.check_batch(cfg, _Par(), 4, 2, train=False)  # eval: no draws
    with pytest.raises(ValueError, match="batch 6 not divisible by data "
                       "shards x microbatches = 2 x 2"):
        pipeline.check_batch(MAESTConfig(**GEOM), _Par(data=2), 6, 2, False)
    with pytest.raises(ValueError, match="depth 4 not divisible by 3 stages"):
        pipeline.stage_range(4, 3, 0)


def test_pipeline_mesh_refusals():
    with pytest.raises(ValueError, match="only 1 ranks"):
        pipeline.make_pipeline_mesh(2, 2, device_type="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by "
                       "num_stages x model_parallel = 2 x 1"):
        pipeline.make_pipeline_mesh(1, 2, device_type="cpu")
