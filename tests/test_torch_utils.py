"""The port's utilities (``maest_tpu_torch/utils``) on the CPU: the
parameter counts against the JAX package's on the same model, the step
timer's warmup and the profiler trace."""


import jax
import numpy as np
import pytest
import torch

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import init_params
from maest_tpu.utils.params import count_non_zero_params as jax_nonzero
from maest_tpu.utils.params import count_params as jax_count
from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.vit import MAESTNet
from maest_tpu_torch.utils import (StepTimer, count_non_zero_params, count_params,
                                   force, trace)

GEOM = dict(img_size=(26, 46), patch_size=16, stride=(10, 10), in_chans=1,
            embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_classes=8,
            distilled=True, distilled_type="separated")


def test_param_counts_match_jax():
    """The JAX tree's parameters loaded into the port's module: the same
    element count and the same non-zero count (the zero heads and biases)."""
    params = jax.tree.map(np.asarray, init_params(JaxConfig(**GEOM),
                                                  jax.random.PRNGKey(0)))
    cfg = MAESTConfig(**GEOM)
    net = MAESTNet(cfg)
    load_into(net, state_from_jax_params(params, cfg))
    assert count_params(net) == jax_count(params) == sum(
        p.numel() for p in net.parameters())
    assert count_non_zero_params(net) == jax_nonzero(params)
    named = dict(net.named_parameters())
    assert count_params(named) == count_params(net)
    ours = count_non_zero_params(named)
    assert 0.0 < ours["sparsity"] < 1.0 and ours["total"] == jax_count(params)


def test_step_timer_keeps_steps_after_warmup():
    timer = StepTimer(warmup=2)
    assert np.isnan(timer.mean) and np.isnan(timer.throughput(4))
    for _ in range(5):
        timer.start()
        assert timer.stop() >= 0.0
    assert len(timer.times) == 3
    assert timer.mean == pytest.approx(np.mean(timer.times))
    assert timer.throughput(8) == pytest.approx(8 / timer.mean)
    assert not timer.cuda and not StepTimer(device="cpu").cuda


def test_force_and_trace(tmp_path):
    assert force(torch.tensor([[2.5, 1.0]])) == 2.5
    assert force(np.array([3.0, 4.0])) == 3.0
    with trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(4).sum()
    assert log_dir == str(tmp_path / "trace")
    assert list((tmp_path / "trace").glob("*.json"))
