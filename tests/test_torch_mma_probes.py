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


def _recorder(seen):
    """Stands in for ``_run_entry``, the launcher that loads the library:
    records what would be launched."""
    def run(entry, kind_type, bn, fold, a, b, out, b_batch):
        seen.append((entry, kind_type, bn, fold, tuple(b.shape),
                     tuple(out.shape), b_batch))
    return run


@pytest.mark.parametrize("control", [False, True], ids=["wgmma", "control"])
def test_route_names_the_wgmma_entry(control, monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: every P1 kind and P8 in bf16 and
    e4m3 name ``maest_mma_probe_wgmma`` with its tile (bf16 256 columns, 64
    for the p.v kinds' 64-wide output, e4m3 128) through ``mxu_probe`` and
    ``mlp_probe``, counted there; through ``mxu_probe_mma`` and
    ``mlp_probe_mma`` they name the mma.sync control ``maest_mma_probe``
    (128 or 64), counted there. The P8 wrappers also count by operand
    type. The int8 rigs' bf16 kinds and k64big_fp8 take the wgmma entry,
    their int8 products the control's."""
    from maest_tpu_torch.ops import int8_probe as I

    seen = []
    monkeypatch.setattr(M, "_run_entry", _recorder(seen))
    for f in (M.mxu_probe, M.mxu_probe_mma, M.mlp_probe, M.mlp_probe_mma):
        monkeypatch.setattr(f, "launches", 0)
    for f in (M.mlp_probe, M.mlp_probe_mma):
        monkeypatch.setattr(f, "launches_bf16", 0)
        monkeypatch.setattr(f, "launches_e4m3", 0)
    w1, w8 = ((M.mxu_probe_mma, M.mlp_probe_mma) if control
              else (M.mxu_probe, M.mlp_probe))
    meta = dict(device="meta", dtype=torch.bfloat16)
    entry = "maest_mma_probe" if control else "maest_mma_probe_wgmma"
    wide = 128 if control else 256
    want = []
    for kind in M.KINDS:
        sa, sb, so = mxu.shapes(kind)
        out = w1(torch.empty((2,) + sa, **meta),
                 torch.empty((2,) + sb, **meta), kind)
        assert out.shape == (2,) + so
        fold = sb[-1] // M.BLOCK if kind in M.FOLD_KINDS else 1
        bn = 64 if so[-1] == 64 else wide
        lead = 8 if kind == "pvbig" else 2  # pvbig: 4 heads a program
        want.append((entry, M.BF16, bn, fold, (lead,) + sb[-2:],
                     (lead,) + so[-2:], math.prod(sb[-2:])))
    for dt, kind_type in (("bf16", M.BF16), ("fp8", M.E4M3), ("fp8",
                                                               M.E4M3)):
        (n, k), (_, m) = fp8_mlp.SHAPES["fc1"]
        a = torch.empty(2, n, k, device="meta", dtype=fp8_mlp.DTYPES[dt])
        b = torch.empty(k, m, device="meta", dtype=fp8_mlp.DTYPES[dt])
        assert w8(a, b).shape == (2, n, m)
        bn = 128 if control or dt == "fp8" else 256
        want.append((entry, kind_type, bn, 1, (m, k) if dt == "fp8"
                     else (k, m), (2, n, m), 0))
    counts = (M.mxu_probe.launches, M.mxu_probe_mma.launches,
              M.mlp_probe.launches, M.mlp_probe_mma.launches)
    assert counts == ((0, 8, 0, 3) if control else (8, 0, 3, 0))
    assert (w8.launches_bf16, w8.launches_e4m3) == (1, 2)
    other = M.mlp_probe if control else M.mlp_probe_mma
    assert (other.launches_bf16, other.launches_e4m3) == (0, 0)
    assert seen == want
    # the int8 rigs' kernels on the copies int8_pass makes (B^T rows for
    # the 8-bit products): k64_bf16 is P1's k64w, k64big_fp8 an e4m3 fold
    seen.clear()
    a = torch.empty(2, 1792, 64, **meta)
    I.launch_pass(a, torch.empty(2, 64, 1792, **meta), None, "k64_bf16")
    a8 = torch.empty(2, 1792, 64, device="meta", dtype=torch.float8_e4m3fn)
    I.launch_pass(a8, torch.empty(2, 56 * 256, 64, device="meta",
                                  dtype=torch.float8_e4m3fn), None,
                  "k64big_fp8")
    s8 = dict(device="meta", dtype=torch.int8)
    I.launch_pass(torch.empty(2, 1792, 64, **s8),
                  torch.empty(2, 1792, 64, **s8), None, "k64_i8")
    assert [(e, t, bn, f) for e, t, bn, f, *_ in seen] == [
        ("maest_mma_probe_wgmma", M.BF16, 256, 1),
        ("maest_mma_probe_wgmma", M.E4M3, 128, 56),
        ("maest_mma_probe", M.S8_I32, 128, 1)]


def test_wgmma_tiles_refuse_shapes_they_do_not_take(monkeypatch):
    """The wgmma kernel's instances (``tile``): M a multiple of 128, output
    columns of 256 in bf16 (64 for a 64-wide output) and 128 in e4m3, K a
    positive multiple of 64, a fold of 1, 7 or 56, and over a fold of more
    than one column block K of at most 512 bytes a row (A stays in shared
    memory) and no 64-wide output. The control takes some of what the
    wgmma kernel refuses; the wrappers refuse on meta tensors before any
    launch, and the control's wrappers send those shapes to it."""
    for args, what in (((128, 64, 384, 1, M.BF16), "output columns of 256"),
                       ((128, 128, 64, 1, M.E4M3), "output columns of 128"),
                       ((128, 320, 256, 7, M.BF16), "at most 256"),
                       ((128, 576, 128, 56, M.E4M3), "at most 512"),
                       ((128, 64, 64, 7, M.BF16), "output columns of 64"),
                       ((128, 0, 256, 1, M.BF16), "K of 64"),
                       ((64, 64, 256, 1, M.BF16), "multiple of 128"),
                       ((128, 64, 256, 3, M.BF16), "fold of 1, 7, 56")):
        with pytest.raises(ValueError, match=what):
            M.tile(*args)
    assert M.tile(128, 64, 384, 1, M.BF16, "control") == 128
    assert M.tile(128, 320, 256, 7, M.BF16, "control") == 128
    assert M.tile(128, 512, 256, 7, M.E4M3) == 128
    assert M.tile(128, 256, 64, 1, M.BF16) == 64
    assert [M.route(t) for t in (M.BF16, M.E4M3, M.S8_I32, M.S8_CVT)] == [
        "wgmma", "wgmma", "control", "control"]
    meta = dict(device="meta", dtype=torch.bfloat16)
    a, b = torch.empty(1, 128, 64, **meta), torch.empty(1, 64, 384, **meta)
    with pytest.raises(ValueError, match="output columns of 256"):
        M.mxu_probe(a, b, "k64w")
    with pytest.raises(ValueError, match="at most 256"):
        M.mxu_probe(torch.empty(1, 128, 320, **meta),
                    torch.empty(1, 320, 7 * 256, **meta), "ctrl")
    with pytest.raises(ValueError, match="output columns of 128"):
        M.mlp_probe(torch.empty(2, 128, 128, device="meta",
                                dtype=torch.float8_e4m3fn),
                    torch.empty(128, 192, device="meta",
                                dtype=torch.float8_e4m3fn))
    seen = []
    monkeypatch.setattr(M, "_run_entry", _recorder(seen))
    monkeypatch.setattr(M.mxu_probe_mma, "launches", 0)
    M.mxu_probe_mma(a, b, "k64w")
    assert [s[:4] for s in seen] == [("maest_mma_probe", M.BF16, 128, 1)]
    assert M.mxu_probe_mma.launches == 1


def test_folded_library_product_is_k64big():
    """``probes.mxu.library_fn``, the yardstick the card run times beside
    k64big (one product of a repeated along K and b's column blocks
    stacked along K), computes k64big's function: within 2 bf16 ulps of
    the plain version at N 256; no other kind has one."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy((rng.standard_normal((1,) + s) * 0.1).astype(
        np.float32)).to(torch.bfloat16) for s in mxu.shapes("k64big", 256)[:2])
    ref = M.mxu_probe_reference(a, b, "k64big").float()
    got = mxu.library_fn("k64big", a, b)().float()
    top = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 2 * _bf16_ulp(top)
    assert mxu.library_fn("k64", a, b) is None
