"""The int8 product rigs' kernels (``ops/int8_probe.py`` ``int8_probe``,
``int8_big_probe``) against the TPU rigs they port,
``scripts/int8_probe.py`` (P2) and ``scripts/int8_probe2.py`` (P3), whose
``_probe_kernel`` runs here in interpret mode on the CPU in every kind,
with the rigs' block specs (one program a grid step, the whole operands a
block) and their operands (int8 from ``integers(-127, 127)``, bf16 and
e4m3 from N(0, 0.1^2)). P2 keeps its N 1792 (its kernel reads no module
global); P3 takes N 256, set as the rig's module global (its accumulators'
rows) and put back. Then both rigs of ``maest_tpu_torch.probes`` with
``--device cpu``, the saturating conversion, and the wrappers' refusals.

Tolerances, each against the rig on the same operand values:
- int32 outputs (k64_i8, pv_i8, k64big_i8, pvbig_i8): equal. Both sides
  sum exact integer products.
- k64_i8q: 1 bf16 ulp of max|out|: the same codes (fp32 maxima and IEEE
  divisions on both sides), exact sums, one rounding to bf16.
- the bf16 and e4m3 products and k64big_i8cvt: 2 bf16 ulps of max|out|
  (fp32 sums, or k64big_i8cvt's rounded fold steps, in other orders, one
  rounding to bf16).
- mix_bf16, columns 0-63: 2 bf16 ulps of max|out|; s is fp32 sums of
  exact products in other orders, so bf16(p) may round apart where s
  differs in its last bits, which moves an element by ~2^-9 |v|, far
  below a bf16 ulp of out.
- mix_i8, columns 0-63: s is exact on both sides, so p8 differs only where
  JAX's and PyTorch's fp32 exp2 differ by an ulp at a rounding boundary of
  p 127. The test counts those p8 (at most 1e-5 of them) and holds every
  element within 127 times the p8 of its row that differ (each moves it by
  one times a b value, |b| <= 127).
The rig's columns 64 and up are NaN in interpret mode; the test records
that (the plain versions fill them so; on the card they are undefined).

On the CPU the wrappers run their plain versions; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels to them on the card."""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu_torch.ops import int8_probe as I
from maest_tpu_torch.probes import int8 as P2
from maest_tpu_torch.probes import int8_2 as P3
from test_torch_mma_probes import _load

N3 = 256  # P3's N here
JDT = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16,
       torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.int32: jnp.int32,
       torch.float32: jnp.float32}


@pytest.fixture(scope="module")
def p2_rig():
    return _load("int8_probe")


@pytest.fixture(scope="module")
def p3_rig():
    return _load("int8_probe2")


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _operands(kind, shapes, programs, seed):
    """(jax a, jax b, torch a, torch b) of the rig's kind: the same values
    on both sides (the torch operands are the JAX ones, exactly)."""
    rng = np.random.default_rng(seed)
    sa, sb = shapes[:2]
    dt = I.operand_dtype(kind)
    if dt == torch.int8:
        a, b = (rng.integers(-127, 127, (programs,) + s).astype(np.int8)
                for s in (sa, sb))
        return (jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a),
                torch.from_numpy(b))
    a, b = (jnp.asarray(rng.standard_normal((programs,) + s) * 0.1, JDT[dt])
            for s in (sa, sb))
    return a, b, *(torch.from_numpy(np.array(x.astype(jnp.float32))).to(dt)
                   for x in (a, b))


def _pallas(kernel, a, b, out_shape, out_dtype, programs):
    """One program a grid step, the whole operands a block, as the rigs'
    calls (int8_probe.py:110-125, int8_probe2.py:108-123), in interpret
    mode; the output as numpy."""
    from jax.experimental import pallas as pl

    def spec(shape):
        r = len(shape) - 1
        return pl.BlockSpec((1,) + tuple(shape[1:]), lambda i: (i,) + (0,) * r)

    (out,) = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((programs,) + out_shape,
                                        JDT[out_dtype])],
        grid=(programs,), in_specs=[spec(a.shape), spec(b.shape)],
        out_specs=[spec((programs,) + out_shape)], interpret=True,
    )(a, b)
    if out_dtype == torch.bfloat16:
        out = out.astype(jnp.float32)
    return np.asarray(out)


def _hold(kind, ours, ref, ja=None, jb=None):
    """Hold the port's plain output to the rig's at the kind's bound."""
    ours = ours.float().numpy() if ours.dtype != torch.int32 else ours.numpy()
    if kind.startswith("mix"):
        assert np.isnan(ref[..., I.MIX_COLS:]).all()  # what the rig leaves
        assert np.isnan(ours[..., I.MIX_COLS:]).all()
        ours, ref = ours[..., :I.MIX_COLS], ref[..., :I.MIX_COLS]
    if I.out_dtype(kind) == torch.int32:
        np.testing.assert_array_equal(ours, ref)
        return
    err = np.abs(ours - ref)
    top = float(np.abs(ref).max())
    if kind == "mix_i8":
        # the p8 that round apart, JAX's exp2 against PyTorch's
        s = np.asarray(jnp.einsum("pnk,pkm->pnm", ja.astype(jnp.int32),
                                  jb.astype(jnp.int32)))
        p8_jax = np.asarray(jnp.round(jnp.exp2(
            jnp.asarray(s, jnp.float32) * 1e-4 - 1.0) * 127.0).astype(
                jnp.int8))
        p8_ours = I.to_int8(torch.exp2(torch.from_numpy(s.copy()).float()
                                       * 1e-4 - 1.0) * 127.0).numpy()
        apart = (p8_jax != p8_ours)
        assert apart.sum() <= 1e-5 * apart.size, apart.sum()
        assert np.abs(p8_jax.astype(int) - p8_ours).max(initial=0) <= 1
        per_row = apart.sum(axis=-1, keepdims=True) * I.MIX_FLIP
        assert (err <= per_row).all(), (err.max(), per_row.max())
        return
    tol = _bf16_ulp(top) if kind == "k64_i8q" else 2 * _bf16_ulp(top)
    assert err.max() <= tol, (kind, err.max(), tol)


@pytest.mark.parametrize("kind", I.P2_KINDS)
def test_p2_kind_matches_the_rig(kind, p2_rig):
    programs = 1 if kind.startswith("pv") else 2
    sa, sb, so, _ = P2.shapes(kind)
    ja, jb, ta, tb = _operands(kind, (sa, sb), programs, len(kind))
    ref = _pallas(functools.partial(p2_rig._probe_kernel, kind=kind), ja, jb,
                  so, I.out_dtype(kind), programs)
    ours = I.int8_probe(ta, tb, kind)
    assert ours.shape == (programs,) + so and ours.dtype == I.out_dtype(kind)
    _hold(kind, ours, ref, ja, jb)


@pytest.mark.parametrize("kind", I.P3_KINDS)
def test_p3_kind_matches_the_rig(kind, p3_rig):
    programs = 1 if kind.startswith("pvbig") else 2
    sa, sb, so, _ = P3.shapes(kind, N3)
    ja, jb, ta, tb = _operands(kind, (sa, sb), programs, 7 + len(kind))
    saved = p3_rig.N
    p3_rig.N = N3
    try:
        ref = _pallas(functools.partial(p3_rig._probe_kernel, kind=kind), ja,
                      jb, so, I.out_dtype(kind), programs)
    finally:
        p3_rig.N = saved
    ours = I.int8_big_probe(ta, tb, kind)
    assert ours.shape == (programs,) + so and ours.dtype == I.out_dtype(kind)
    _hold(kind, ours, ref)


def test_int8_conversion_saturates_as_jax_does():
    """jnp.round(x).astype(int8): half to even, saturated, NaN to 0; the
    port's to_int8 is the same on values past the int8 range."""
    x = np.array([1440.0, -1440.0, np.nan, 0.5, 1.5, 126.5, 127.5, -128.5,
                  -0.5, 2.5, 1e30, -np.inf], np.float32)
    want = np.asarray(jnp.round(jnp.asarray(x)).astype(jnp.int8))
    np.testing.assert_array_equal(want, [127, -128, 0, 0, 2, 126, 127, -128,
                                         0, 2, 127, -128])
    np.testing.assert_array_equal(I.to_int8(torch.from_numpy(x)).numpy(),
                                  want)


def test_mix_i8_plain_version_saturates_p8():
    """All-127 operands: s = 64 127^2, p = 2^102.2, round(p 127) far past
    127 saturates to 127 (a wrapping conversion would give -1 there), so
    out[:, :64] = 127 . 127 . N exactly; a ds-like negative past -128 gives
    -128."""
    n = 128
    a = torch.full((1, n, 64), 127, dtype=torch.int8)
    b = torch.full((1, 64, n), 127, dtype=torch.int8)
    out = I.int8_probe_reference(a, b, "mix_i8")
    assert (out[..., :64] == 127 * 127 * n).all()
    assert torch.isnan(out[..., 64:]).all()
    assert I.to_int8(torch.tensor([-300.0])).item() == -128


def test_p2_rig_on_the_cpu(capsys):
    res = P2.main(["--device", "cpu", "--programs", "1", "--iters", "1"])
    assert set(res) == set(I.P2_KINDS)
    lines = capsys.readouterr().out.splitlines()
    for kind in res:
        assert any(line.startswith(kind) and "plain version" in line
                   for line in lines), lines
    # the bounds at the rig's 48 programs: single int8 products are bound
    # by their bytes (k64_i8's 616 MB int32 output), not their operations
    assert P2.bound("k64_i8", 48)[1] == "bytes"
    assert abs(P2.bound("k64_i8", 48)[0] - 0.1873) < 1e-4
    assert P2.bound("mix_i8", 48)[1] == "operations"
    with pytest.raises(ValueError, match="unknown kind"):
        P2.main(["--device", "cpu", "--kinds", "k32_i8"])


def test_p3_rig_on_the_cpu(capsys):
    res = P3.main(["--device", "cpu", "--programs", "1", "--iters", "1",
                   "--kinds", "k64big_i8,k64big_i8cvt,pvbig_i8"])
    assert set(res) == {"k64big_i8", "k64big_i8cvt", "pvbig_i8"}
    out = capsys.readouterr().out
    assert out.count("plain version") == 3
    assert P3.bound("k64big_i8", 8) == pytest.approx((0.013293, "operations"),
                                                     rel=1e-4)
    assert P3.bound("pvbig_i8", 8)[1] == "bytes"


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    a = torch.randint(-127, 127, (1, 128, 64), dtype=torch.int8)
    b = torch.randint(-127, 127, (1, 64, 56 * 256), dtype=torch.int8)
    before = (I.int8_probe.launches, I.int8_big_probe.launches)
    assert torch.equal(I.int8_big_probe(a, b, "k64big_i8"),
                       I.int8_big_probe_reference(a, b, "k64big_i8"))
    assert torch.equal(I.int8_probe(a, b[..., :128], "k64_i8"),
                       I.int8_probe_reference(a, b[..., :128], "k64_i8"))
    assert before == (I.int8_probe.launches, I.int8_big_probe.launches)


def test_shapes_without_an_instance_are_refused():
    """On a device other than the CPU the wrappers check the kernels' tiles
    before any copy or launch (meta tensors stand in for the card's)."""
    i8 = dict(device="meta", dtype=torch.int8)
    bf = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        I.int8_probe(torch.empty(1, 100, 64, **i8),
                     torch.empty(1, 64, 128, **i8), "k64_i8")
    with pytest.raises(ValueError, match="K of 64"):
        I.int8_probe(torch.empty(1, 128, 96, **i8),
                     torch.empty(1, 96, 64, **i8), "pv_i8")
    with pytest.raises(ValueError, match="K of 64 exactly"):
        I.int8_probe(torch.empty(1, 128, 128, **bf),
                     torch.empty(1, 128, 128, **bf), "k64_i8q")
    with pytest.raises(ValueError, match="columns of 128"):
        I.int8_big_probe(torch.empty(1, 128, 64, **i8),
                         torch.empty(1, 64, 56 * 96, **i8), "k64big_i8")
    with pytest.raises(ValueError, match="unsupported device"):
        I.int8_probe(torch.empty(1, 128, 64, **i8),
                     torch.empty(1, 64, 128, **i8), "k64_i8")
    with pytest.raises(ValueError, match="unknown kind"):
        I.int8_probe(torch.zeros(1, 128, 64, dtype=torch.int8),
                     torch.zeros(1, 64, 128, dtype=torch.int8), "k32_i8")
    with pytest.raises(TypeError, match="int8"):
        I.int8_probe(torch.zeros(1, 128, 64), torch.zeros(1, 64, 128),
                     "k64_i8")
    with pytest.raises(ValueError, match="56 blocks"):
        I.int8_big_probe(torch.zeros(1, 128, 64, dtype=torch.int8),
                         torch.zeros(1, 64, 100, dtype=torch.int8),
                         "k64big_i8")
