"""The port's parallel train step across real processes (gloo on the CPU)
against the JAX package's single-device step over the same global batch.

Geometry: ``tests/test_torch_train.py``'s tiny model (embed 64, depth 2,
4 heads, 8 classes) on a 36 x 46 input with the fixed time patchout index
1: 3 x 3 patches and the cls/dist tokens, 11 tokens, so sequence
parallelism over 2 model ranks pads the stream to 12. Global batch 4, 3
AdamW steps on a warmup schedule.

One spawn per world size runs every mode inside it: at 2 processes data
parallelism (dp), FSDP2 (fsdp), tensor parallelism (tp) and tp with
sequence parallelism (tp+sp); at 4 processes dp+tp, dp+tp+sp and
fsdp+tp. Each rank steps on its rows of the global batches, and writes
its losses and the whole parameters gathered from its shards.

Tolerances, as ``tests/test_torch_train.py``: losses rtol 1e-5;
parameters rtol 1e-4, atol 2e-6, the key bias within 2 lr a step (its
gradient is zero in exact arithmetic, so Adam normalises fp32 noise).
Every rank's gathered parameters are equal bit for bit.

With randomness on (SpecAugment, mixup, random time patchout,
unstructured patchout, dropout, attention dropout, drop_path), 2 and 4
ranks against the port's one process with the same seeded generators:
every draw is the global batch's, cut to the rank's rows, so losses and
parameters match at the same tolerances.
"""

import time

import numpy as np
import pytest
import torch

import jax

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu.train import schedules as jsched
from maest_tpu.train.state import TrainState as JaxState
from maest_tpu.train.state import make_optimizer as jax_optimizer
from maest_tpu.train.steps import AugmentConfig as JaxAugment
from maest_tpu.train.steps import make_train_step as jax_train_step
from maest_tpu_torch.checkpoints import state_from_jax_params
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.parallel import mesh as pmesh
from maest_tpu_torch.parallel.launch import spawn
from maest_tpu_torch.train import schedules as tsched

import torch_parallel_worker as W

GEOM = dict(img_size=(36, 46), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_classes=8,
            distilled=True, distilled_type="mean", s_patchout_t_indices=(1,))
RANDOM_GEOM = dict(s_patchout_t_indices=(), s_patchout_t=1, u_patchout=2,
                   drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2)
AUG_OFF = dict(masking=False, mixup_alpha=0.0)
RANDOM_AUG = dict(time_mask_param=4, freq_mask_param=3, mixup_alpha=0.3)
STEP_TOL = dict(rtol=1e-4, atol=2e-6)
LR = 1e-3
STEPS = 3
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The initial weights (JAX's, class head drawn), 3 global batches of
    4, and the JAX single-device run over them: losses and parameters."""
    jcfg = JaxConfig(**GEOM)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    params["head_linear"]["kernel"] = np.random.default_rng(9).standard_normal(
        params["head_linear"]["kernel"].shape).astype("f4") * 0.2
    rng = np.random.default_rng(0)
    batches = [{"x": (rng.standard_normal((4, 36, 46)) * 2 + 2).astype("f4"),
                "y": (rng.random((4, 8)) > 0.7).astype("f4")}
               for _ in range(STEPS)]
    jtx = jax_optimizer(lr_schedule=jsched.make_schedule(
        "exp_lin", LR, 1, warm_up_len=2))
    jstate = JaxState.create(params, jtx, with_swa=False)
    jstep = jax_train_step(JaxNet(jcfg), jtx, JaxAugment(**AUG_OFF),
                           donate=False)
    losses = []
    for batch in batches:
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(1))
        losses.append(float(m["train_loss"]))
    tcfg = MAESTConfig(**GEOM)
    out = tmp_path_factory.mktemp("parallel")
    s = dict(geom=GEOM, random_geom=RANDOM_GEOM,
             state=state_from_jax_params(params, tcfg), batches=batches,
             lr=LR, seed=5, aug=AUG_OFF, random_aug=RANDOM_AUG)
    torch.save(s, out / "spec.pt")
    lr_sum = sum(tsched.make_schedule("exp_lin", LR, 1, warm_up_len=2)(i)
                 for i in range(STEPS))
    return dict(spec=s, path=out / "spec.pt", out=out, jax_losses=losses,
                jax_params=state_from_jax_params(
                    jax.tree.map(np.asarray, jstate.params), tcfg),
                lr_sum=lr_sum)


RUNS = {2: ["dp", "fsdp", "tp", "tp+sp", "dp:random", "tp+sp:random",
            "fsdp:accum"],
        4: ["dp+tp", "dp+tp+sp", "fsdp+tp", "dp+tp+sp:random",
            "dp+tp+sp:accum"]}


@pytest.fixture(scope="module")
def runs(spec):
    """One spawn per world size, every mode inside it: mode -> the list
    of each rank's (losses, whole parameters)."""
    out = {}
    for world, modes in RUNS.items():
        spawn(W.run_modes, world, str(spec["path"]), str(spec["out"]),
              modes, timeout=TIMEOUT)
        for mode in modes:
            out[mode] = [torch.load(spec["out"] / f"{mode}.{r}.pt")
                         for r in range(world)]
    return out


def _assert_params(ours: dict, ref: dict, lr_sum: float):
    e = GEOM["embed_dim"]
    assert set(ref) <= set(ours)
    for k, v in ref.items():
        a, b = ours[k].numpy(), v.numpy()
        if k.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                       atol=2 * lr_sum, err_msg=k)
            a, b = np.delete(a, np.s_[e:2 * e]), np.delete(b, np.s_[e:2 * e])
        np.testing.assert_allclose(a, b, err_msg=k, **STEP_TOL)


def _assert_ranks_equal(ranks: list):
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


@pytest.mark.parametrize("mode", ["dp", "fsdp", "tp", "tp+sp", "dp+tp",
                                  "dp+tp+sp", "fsdp+tp"])
def test_mode_matches_jax_single_device(runs, spec, mode):
    ranks = runs[mode]
    world = len(ranks)
    want = dict(zip(("model", "fsdp", "sp"), W.MODES[world][mode]))
    desc = ranks[0]["describe"]
    assert f"model {want['model']}" in desc and "gloo" in desc
    assert ("fsdp" in desc) == want["fsdp"] and ("sp" in desc) == want["sp"]
    np.testing.assert_allclose(ranks[0]["losses"], spec["jax_losses"],
                               rtol=1e-5)
    _assert_params(ranks[0]["params"], spec["jax_params"], spec["lr_sum"])
    _assert_ranks_equal(ranks)


@pytest.mark.parametrize("mode", ["dp", "tp+sp", "dp+tp+sp"])
def test_random_draws_match_one_process(runs, spec, mode):
    """Randomness on: the ranks against the port's one process, the
    same seeded generators (mixup pairs rows across the data ranks)."""
    ranks = runs[f"{mode}:random"]
    losses, params = W.one_process(spec["spec"], random=True)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    _assert_params(ranks[0]["params"], params, spec["lr_sum"])
    _assert_ranks_equal(ranks)
    # the draws are on: the one process's losses are not the plain ones
    plain, _ = W.one_process(spec["spec"], random=False)
    assert not np.allclose(losses, plain, rtol=1e-3)


@pytest.mark.parametrize("mode", ["fsdp", "dp+tp+sp"])
def test_accumulation_matches_one_process(runs, spec, mode):
    """accumulate_steps 2: each rank accumulates the mean of 2 global
    micro-batches' gradients, as one process does (one update after
    steps 2; the third step's gradient waits in the accumulator)."""
    ranks = runs[f"{mode}:accum"]
    losses, params = W.one_process(spec["spec"], random=False, accumulate=2)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    _assert_params(ranks[0]["params"], params, spec["lr_sum"])
    _assert_ranks_equal(ranks)


def test_gather_across_hosts_in_rank_order(tmp_path):
    spawn(W.gather_rows, 2, str(tmp_path), timeout=TIMEOUT)
    want = np.concatenate([np.full((r + 1, 3), r) for r in range(2)])
    for r in range(2):
        for name in ("gather", "regather"):  # re-formed group, same answer
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{name}.{r}.npy"), want)


def test_init_distributed_fails_fast_without_an_address(monkeypatch):
    """WORLD_SIZE or RANK without MASTER_ADDR raises: the ranks never
    train as independent single runs (maest_tpu/parallel/mesh.py:20-65)."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed("cpu") == 0  # one process: a no-op
    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.setenv(key, "2" if key == "WORLD_SIZE" else "1")
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            pmesh.init_distributed("cpu")
        monkeypatch.delenv(key)
    assert not torch.distributed.is_initialized()


def test_make_mesh_checks():
    with pytest.raises(ValueError, match="only 1 ranks"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        pmesh.make_mesh(1, 2)


@pytest.mark.parametrize("size", [2, 4])
def test_tensor_parallel_slices_are_head_aligned(size):
    """Each model rank's qkv rows are whole heads of q, k and v (the
    trap at maest_tpu/parallel/mesh.py:100-115), and the slices of every
    parameter reassemble to the whole."""
    heads, d, e = 4, 16, 64
    full = torch.arange(3 * e * e, dtype=torch.float32).view(3 * e, e)
    parts = [pmesh.tp_slice("blocks.0.attn.qkv.weight", full, heads, r, size)
             for r in range(size)]
    local = heads // size
    for r, part in enumerate(parts):
        want = full.view(3, heads, d, e)[:, r * local:(r + 1) * local]
        assert torch.equal(part, want.reshape(-1, e))
    assert torch.equal(pmesh.tp_unslice("blocks.0.attn.qkv.weight", parts,
                                         heads), full)
    shapes = {"blocks.0.attn.qkv.bias": (3 * e,),
              "blocks.0.attn.proj.weight": (e, e),
              "blocks.0.attn.proj.bias": (e,),
              "blocks.0.mlp.fc1.weight": (4 * e, e),
              "blocks.0.mlp.fc1.bias": (4 * e,),
              "blocks.0.mlp.fc2.weight": (e, 4 * e),
              "blocks.0.norm1.weight": (e,), "head.1.weight": (8, e)}
    for name, shape in shapes.items():
        t = torch.randn(shape)
        ps = [pmesh.tp_slice(name, t, heads, r, size) for r in range(size)]
        assert torch.equal(pmesh.tp_unslice(name, ps, heads), t), name
        split = any(p.shape != t.shape for p in ps)
        assert split == (name in TP_SPLIT), name


# the parameters tensor parallelism splits (maest_tpu/parallel/mesh.py's
# param_spec "model" axes): qkv and fc1 their outputs, proj and fc2 their
# inputs
TP_SPLIT = {"blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias",
            "blocks.0.attn.proj.weight", "blocks.0.mlp.fc1.weight",
            "blocks.0.mlp.fc1.bias", "blocks.0.mlp.fc2.weight"}


def test_spawn_fails_with_the_failing_ranks_traceback():
    """A rank that raises fails the launch with its traceback, and the
    ranks still running are killed; at the timeout every rank is."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        spawn(W.fail_or_wait, 3, 1, 600.0, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="did not finish in 5.0 s"):
        spawn(W.fail_or_wait, 2, -1, 600.0, timeout=5.0)
    assert time.monotonic() - t0 < TIMEOUT
    assert spawn(W.fail_or_wait, 2, -1, 0.0, timeout=TIMEOUT) == [0, 1]


def test_recovery_reforms_the_group_when_the_trainer_fails_to_build():
    """``fit_with_recovery`` across 2 CPU ranks whose first Trainer fails
    before it exists: the group is formed again over gloo on the
    device the caller named, and the second attempt reduces over it."""
    got = spawn(W.recover_before_the_trainer, 2, timeout=TIMEOUT)
    assert got == [({"done": True, "sum": 2.0, "restarts": 1}, 2)] * 2
