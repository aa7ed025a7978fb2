"""The tensor-core rate rigs' products (``ops/mma_probe.py``
``mxu_probe``, ``mlp_probe``) against the TPU rigs they port,
``scripts/mxu_probe.py`` (P1) and ``scripts/fp8_mlp_probe.py`` (P8), whose
Pallas kernels run here in interpret mode on the CPU: ``_probe_kernel`` in
every kind, with the rig's block specs (one program a grid step, the whole
operands a block), and ``_mm_kernel`` in bf16 and e4m3 at a reduced (N, K,
M), b shared by the programs. k64 and pv keep the rig's N 1792 (k64 folds
b's 7 blocks of 256 columns, pv sums 7 slices of 256); the other kinds
take N 256, set as the rig's module global (its accumulators' rows) and
put back. Then both rigs of ``maest_tpu_torch.probes`` with ``--device
cpu``, and the wrappers' refusals.

Tolerance: two bf16 ulps of the largest |out|. Both sides sum exact
products of bf16 (or e4m3) values in fp32 and round once to bf16; the sums
run in other orders (the rig's dots and their folds against the port's
fp32 matmuls), so an element may round one ulp apart, never two.

On the CPU the wrappers run their plain versions; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernel to them on the card."""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu_torch.ops import mma_probe as M
from maest_tpu_torch.probes import fp8_mlp, mxu

ROOT = Path(__file__).resolve().parent.parent
RIG_N = {"k64": 1792, "pv": 1792}  # the other kinds at N 256


def _load(name):
    """scripts/<name>.py, loaded by path. Its import puts a directory on
    sys.path and points JAX's compilation cache into the home directory;
    both are put back at once, so nothing else on this worker sees them."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture(scope="module")
def mxu_rig():
    return _load("mxu_probe")


@pytest.fixture(scope="module")
def mlp_rig():
    return _load("fp8_mlp_probe")


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _pallas(kernel, a, b, out_shape, programs, shared_b=False):
    """One program a grid step, the whole operands a block, as the rigs'
    calls (mxu_probe.py:106-121, fp8_mlp_probe.py:220-232), in interpret
    mode; the bf16 output as fp32 numpy."""
    from jax.experimental import pallas as pl

    def spec(shape, fixed=False):
        r = len(shape) - 1
        return pl.BlockSpec((1,) + tuple(shape[1:]),
                            lambda i: (0 if fixed else i,) + (0,) * r)

    (out,) = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((programs,) + out_shape,
                                        jnp.bfloat16)],
        grid=(programs,),
        in_specs=[spec(a.shape), spec(b.shape, shared_b)],
        out_specs=[spec((programs,) + out_shape)], interpret=True,
    )(a, b)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("kind", M.KINDS)
def test_mxu_kind_matches_the_rig(kind, mxu_rig):
    import functools

    n = RIG_N.get(kind, 256)
    programs = 2 if kind in ("k64w", "pvwide", "ctrl") else 1
    sa, sb, so = mxu.shapes(kind, n)
    rng = np.random.default_rng(len(kind))
    a = (rng.standard_normal((programs,) + sa) * 0.1).astype(np.float32)
    b = (rng.standard_normal((programs,) + sb) * 0.1).astype(np.float32)
    saved = mxu_rig.N
    mxu_rig.N = n
    try:
        ref = _pallas(functools.partial(mxu_rig._probe_kernel, kind=kind),
                      jnp.asarray(a, jnp.bfloat16),
                      jnp.asarray(b, jnp.bfloat16), so, programs)
    finally:
        mxu_rig.N = saved
    ours = M.mxu_probe(torch.from_numpy(a).to(torch.bfloat16),
                       torch.from_numpy(b).to(torch.bfloat16), kind)
    assert ours.shape == (programs,) + so and ours.dtype == torch.bfloat16
    err = np.abs(ours.float().numpy() - ref).max()
    assert err <= 2 * _bf16_ulp(np.abs(ref).max()), (kind, err)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_mlp_matches_the_rig(dtype, mlp_rig):
    """_mm_kernel at (N, K, M) = (128, 256, 384), two programs, one b."""
    jdt = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}[dtype]
    tdt = fp8_mlp.DTYPES[dtype]
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((2, 128, 256)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    ref = _pallas(mlp_rig._mm_kernel, jnp.asarray(a, jdt),
                  jnp.asarray(b, jdt)[None], (128, 384), 2, shared_b=True)
    at, bt = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    # the same operand values on both sides (round to nearest even)
    np.testing.assert_array_equal(
        at.float().numpy(), np.asarray(jnp.asarray(a, jdt), np.float32))
    ours = M.mlp_probe(at, bt)
    assert ours.shape == (2, 128, 384) and ours.dtype == torch.bfloat16
    err = np.abs(ours.float().numpy() - ref).max()
    assert err <= 2 * _bf16_ulp(np.abs(ref).max()), err


def test_mxu_rig_on_the_cpu(capsys):
    res = mxu.main(["--device", "cpu", "--programs", "1", "--iters", "1",
                    "--kinds", "k64w,pvwide,ctrl"])
    assert set(res) == {"k64w", "pvwide", "ctrl"}
    lines = capsys.readouterr().out.splitlines()
    for kind in res:
        assert any(line.startswith(kind) and "plain version" in line
                   for line in lines), lines
    # the bounds the rig prints at its default 48 programs
    assert mxu.bound("k64big", 48)[1] == "operations"
    assert abs(mxu.bound("k64big", 48)[0] - 0.1596) < 1e-4
    assert abs(mxu.bound("pvbig", 48)[0] - 0.3944) < 1e-4
    with pytest.raises(ValueError, match="unknown kind"):
        mxu.main(["--device", "cpu", "--kinds", "k32"])


def test_mlp_rig_on_the_cpu(capsys):
    res = fp8_mlp.main(["--device", "cpu", "--programs", "1", "--iters",
                        "1"])
    assert set(res) == {f"{s}_{d}" for s in fp8_mlp.SHAPES
                        for d in fp8_mlp.DTYPES}
    out = capsys.readouterr().out
    assert out.count("plain version") == 6 and "library" not in out
    assert abs(fp8_mlp.bound("fc1", "bf16", 32)[0] - 0.2736) < 1e-4
    assert abs(fp8_mlp.bound("qkv", "fp8", 32)[0] - 0.1025) < 1e-4


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    a = torch.randn(1, 256, 64).to(torch.bfloat16)
    b = torch.randn(1, 64, 7 * 256).to(torch.bfloat16)
    before = (M.mxu_probe.launches, M.mlp_probe.launches)
    assert torch.equal(M.mxu_probe(a, b, "ctrl"),
                       M.mxu_probe_reference(a, b, "ctrl"))
    w = torch.randn(64, 384).to(torch.float8_e4m3fn)
    a8 = a[..., :64].to(torch.float8_e4m3fn)
    assert torch.equal(M.mlp_probe(a8, w), M.mlp_probe_reference(a8, w))
    assert before == (M.mxu_probe.launches, M.mlp_probe.launches)


def test_shapes_without_an_instance_are_refused():
    """On a device other than the CPU the wrappers check the kernel's tiles
    before any launch (meta tensors stand in for the card's here)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        M.mxu_probe(torch.empty(1, 100, 64, **meta),
                    torch.empty(1, 64, 256, **meta), "k64w")
    with pytest.raises(ValueError, match="fold of 1, 7, 56"):
        M.mxu_probe(torch.empty(1, 128, 64, **meta),
                    torch.empty(1, 64, 3 * 256, **meta), "k64")
    with pytest.raises(ValueError, match="unsupported device"):
        M.mxu_probe(torch.empty(1, 128, 64, **meta),
                    torch.empty(1, 64, 7 * 256, **meta), "k64")
    with pytest.raises(ValueError, match="K of 64"):
        M.mlp_probe(torch.empty(2, 128, 96, device="meta",
                                dtype=torch.float8_e4m3fn),
                    torch.empty(96, 128, device="meta",
                                dtype=torch.float8_e4m3fn))
    with pytest.raises(ValueError, match="unknown product kind"):
        M.mxu_probe(torch.zeros(1, 128, 64, dtype=torch.bfloat16),
                    torch.zeros(1, 64, 256, dtype=torch.bfloat16), "k32")
    with pytest.raises(TypeError, match="bfloat16"):
        M.mxu_probe(torch.zeros(1, 128, 64), torch.zeros(1, 64, 256), "k64w")
