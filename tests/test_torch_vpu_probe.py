"""The softmax-arithmetic probes of the port (``ops/attention_vpu.py``,
``probes/attn_vpu.py``) against the TPU rig they port,
``scripts/attn_vpu_probe.py``, whose Pallas kernel ``_variant_kernel`` runs
here in interpret mode on the CPU, built as its ``build_variant`` builds it
(:145-171: the casts, the pre-scaled q of fp8lean, one program per head),
with the rig's module globals N_REAL, N_PAD and BK set to the test's
length, its padding and the port's 64-key tile, and put back afterwards.

Tolerance: two bf16 ulps of the largest |o|. Both sides round one fp32
output to bf16; their p round at the same points (bf16 kinds: the scores,
x - m and exp2 to bf16; fp8lean: p to e4m3), and an exp2 a few fp32 ulps
apart (XLA's against PyTorch's) moves one p by one rounding step, a
relative 2^-8 (bf16) or 2^-4 (e4m3) of one weight of a mean of ~100
values, far under an ulp of the output.

On the CPU ``attention_vpu_probe`` runs its plain version;
``tests/test_torch_cuda.py`` holds the kernels to it on the card.
"""

import contextlib
import functools
import importlib.util
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu_torch.ops.attention import flash_attention
from maest_tpu_torch.ops.attention_vpu import (
    BLOCK_K,
    KINDS,
    attention_vpu_probe,
    attention_vpu_probe_reference,
    PLAIN_REL_L2,
    launch_vpu,
    plain_gap,
    vpu_pass,
)
from maest_tpu_torch.probes import attn_vpu

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rig():
    """scripts/attn_vpu_probe.py, loaded by path. Its import puts "." on
    sys.path and points JAX's compilation cache into the home directory;
    both are put back at once, so nothing else on this worker sees them."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            "attn_vpu_probe", ROOT / "scripts" / "attn_vpu_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@contextlib.contextmanager
def _globals(mod, **values):
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def _tpu_kind(rig, kind, x, n_pad):
    """``build_variant``'s runner for ``kind`` on bf16 x (B, N, 3, H, 64),
    in interpret mode, N_REAL = N and N_PAD = n_pad."""
    from jax.experimental import pallas as pl

    b, n, _, h, d = x.shape
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    q, k, v = xj[:, :, 0], xj[:, :, 1], xj[:, :, 2]
    in_dtype = jnp.float8_e4m3fn if kind.startswith("fp8") else jnp.bfloat16
    scale = d**-0.5
    with _globals(rig, N_REAL=n, N_PAD=n_pad, BK=BLOCK_K):
        qf, kf, vf = (jnp.pad(jnp.swapaxes(t, 1, 2).reshape(b * h, n, d),
                              ((0, 0), (0, n_pad - n), (0, 0)))
                      for t in (q, k, v))
        if kind == "fp8lean":
            qf = qf.astype(jnp.float32) * (scale * rig._LOG2E)
            vf = vf.astype(jnp.float8_e4m3fn)
        kt = jnp.swapaxes(kf.astype(in_dtype), 1, 2)
        (out,) = pl.pallas_call(
            functools.partial(rig._variant_kernel, scale=scale, kind=kind),
            out_shape=[jax.ShapeDtypeStruct((b * h, n_pad, d), q.dtype)],
            grid=(b * h,),
            in_specs=[
                pl.BlockSpec((1, n_pad, d), lambda i: (i, 0, 0)),
                pl.BlockSpec((1, d, n_pad), lambda i: (i, 0, 0)),
                pl.BlockSpec((1, n_pad, d), lambda i: (i, 0, 0)),
            ],
            out_specs=[pl.BlockSpec((1, n_pad, d), lambda i: (i, 0, 0))],
            interpret=True,
        )(qf.astype(in_dtype), kt, vf)
    out = jnp.swapaxes(out[:, :n].reshape(b, h, n, d), 1, 2)
    return np.asarray(out.astype(jnp.float32))


def _qkv(b, n, h, seed, scale=0.3):
    """The rig's inputs: N(0, 0.3^2), as (B, N, 3, H, 64) fp32."""
    return (np.random.default_rng(seed).standard_normal((b, n, 3, h, 64))
            * scale).astype(np.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _split(x):
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def test_rig_kinds_and_shapes_are_the_ported_ones(rig):
    """The port's rig runs the TPU rig's kinds (its default list, and
    fp8lean, which its kernel holds) at its shape by default."""
    import inspect

    assert rig._variant_kernel.__name__ == "_variant_kernel"
    default = re.search(r'default="(ctrl,[\w,]+)"', inspect.getsource(rig.main))
    assert set(default.group(1).split(",")) | {"fp8lean"} == set(attn_vpu.ALL)
    assert '"fp8lean"' in inspect.getsource(rig._variant_kernel)
    assert (rig.B, rig.N_REAL, rig.H, rig.D) == (
        attn_vpu.BATCH, attn_vpu.TOKENS, attn_vpu.HEADS, 64)
    assert rig.N_PAD == -(-attn_vpu.TOKENS // 128) * 128


# n_pad - n < 64 at (100, 128), as in the rig at (1676, 1792), and 56 at
# (200, 256): fp8nomask's zero keys, and the kinds' masks, are exercised in
# a tile that holds real keys
@pytest.mark.parametrize("b,n,n_pad", [(1, 100, 128), (2, 200, 256)])
@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_tpu_rig_interpret(rig, kind, b, n, n_pad):
    x = _qkv(b, n, 2, seed=n + b)
    want = _tpu_kind(rig, kind, x, n_pad)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = attention_vpu_probe(*_split(xt), kind,
                              n_pad=n_pad if kind == "fp8nomask" else None)
    assert got.shape == (b, n, 2, 64) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all()
    top = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2 * _bf16_ulp(top), (err, top)


def test_kinds_against_k2():
    """Relative L2 distance from K2 (its plain version here) on the rig's
    inputs: the kinds that compute attention lie within 5 % (fp8lean's e4m3
    v and p cost ~3.6 %); fp8nomask's zero keys take 1 - 200 / 256 of the
    mass at (200, 256), so it lies far outside."""
    x = torch.from_numpy(_qkv(2, 200, 3, seed=3)).to(torch.bfloat16)
    q, k, v = _split(x)
    k2 = flash_attention(q, k, v).float()
    rel = {kind: ((attention_vpu_probe(q, k, v, kind).float() - k2).norm()
                  / k2.norm()).item() for kind in KINDS}
    assert max(rel[k] for k in ("bf16sm", "fp8sm", "fp8noexp")) < 1e-2, rel
    assert rel["fp8lean"] < 5e-2 < 0.1 < rel["fp8nomask"], rel


def test_nomask_without_padding_is_fp8sm():
    """With n_pad = N (a multiple of 64) no zero key is walked and no key
    is masked: fp8nomask computes fp8sm's function; padding shrinks o by
    the zero keys' share of the mass."""
    x = torch.from_numpy(_qkv(1, 128, 2, seed=4)).to(torch.bfloat16)
    q, k, v = _split(x)
    sm = attention_vpu_probe(q, k, v, "fp8sm")
    assert torch.equal(attention_vpu_probe(q, k, v, "fp8nomask", n_pad=128), sm)
    padded = attention_vpu_probe(q, k, v, "fp8nomask", n_pad=256).float()
    ratio = (padded * sm.float()).sum() / (sm.float() ** 2).sum()
    assert 0.4 < ratio.item() < 0.6  # 128 real keys of 256, near-even mass


@pytest.mark.parametrize("kind", KINDS)
def test_kind_on_the_cpu_is_the_plain_version_and_counts_no_launch(kind):
    x = torch.from_numpy(_qkv(2, 90, 3, seed=1)).to(torch.bfloat16)
    q, k, v = _split(x)
    n_real = None if kind == "fp8nomask" else 77
    before = dict(attention_vpu_probe.launches)
    got = attention_vpu_probe(q, k, v, kind, n_real)
    assert torch.equal(got, attention_vpu_probe_reference(q, k, v, kind, n_real))
    assert attention_vpu_probe.launches == before
    if kind != "fp8nomask":  # masked keys get no mass
        y = x.clone()
        y[:, 77:, 1:] = 3.0
        assert torch.equal(got, attention_vpu_probe(*_split(y), kind, 77))


def test_plain_gap_passes_rounding_and_refuses_a_dropped_mask():
    """The card's check of a kernel against its plain version: each
    element one bf16 ulp of its own off passes; fp8sm's function with its mask off (fp8nomask over
    the 128 keys of the last tile at N 100) and a zero output do not."""
    x = torch.from_numpy(_qkv(2, 100, 3, seed=5)).to(torch.bfloat16)
    q, k, v = _split(x)
    ref = attention_vpu_probe_reference(q, k, v, "fp8sm")
    top = ref.float().abs().max().item()
    err, tol, rel = plain_gap("fp8sm", ref, ref)
    assert err == rel == 0 and tol == 2 * _bf16_ulp(top) + top / 128
    assert plain_gap("fp8lean", ref, ref)[1] == 2 * _bf16_ulp(top)
    bumped = ref.float() * (1 + 2.0**-8)
    err, tol, rel = plain_gap("fp8sm", bumped, ref)
    assert err <= tol and rel <= PLAIN_REL_L2
    no_mask = attention_vpu_probe_reference(q, k, v, "fp8nomask", n_pad=128)
    for out in (no_mask, torch.zeros_like(ref)):
        err, tol, rel = plain_gap("fp8sm", out, ref)
        assert err > tol and rel > PLAIN_REL_L2


def test_kinds_reject_what_their_kernels_do_not_take():
    x = torch.zeros(1, 100, 3, 2, 64, dtype=torch.bfloat16)
    q, k, v = _split(x)
    with pytest.raises(ValueError, match="unknown attention vpu probe kind"):
        attention_vpu_probe(q, k, v, "ctrl")
    with pytest.raises(TypeError, match="bfloat16"):
        attention_vpu_probe(q.float(), k.float(), v.float(), "fp8sm")
    with pytest.raises(ValueError, match="takes no n_pad"):
        attention_vpu_probe(q, k, v, "bf16sm", n_pad=128)
    with pytest.raises(ValueError, match="n_real = N only"):
        attention_vpu_probe(q, k, v, "fp8nomask", n_real=90)
    for n_pad in (64, 160):
        with pytest.raises(ValueError, match="multiple of 64 at or past"):
            attention_vpu_probe(q, k, v, "fp8nomask", n_pad=n_pad)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        attention_vpu_probe(q, k, v, "fp8lean", n_real=101)
    y = torch.zeros(1, 16, 3, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_vpu_probe(*_split(y), "fp8noexp")
    with pytest.raises(ValueError, match="unsupported device"):
        vpu_pass(q, k, v, "fp8sm")
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        launch_vpu((q, k, v), "bf16sm")


def test_rig_prints_numerics_rounds_and_a_summary(capsys):
    out = attn_vpu.main(["--device", "cpu", "--batch", "1", "--tokens", "100",
                         "--heads", "2", "--iters", "1", "--rounds", "2"])
    text = capsys.readouterr().out
    assert list(out) == ["ctrl", *KINDS]
    for kind in KINDS:
        assert re.search(rf"numerics {kind}\s+max\|dout\| vs ctrl = ", text)
        assert out[kind]["max_dout"] >= 0 and out[kind]["rel_l2"] >= 0
    for kind in out:
        assert len(re.findall(rf"round \d {kind}\s+[\d.]+ ms/call \(host", text)) == 2
        assert out[kind]["ms"] > 0 and out[kind]["graph_ms"] is None
    assert out["fp8nomask"]["rel_l2"] > 0.1 > out["fp8sm"]["rel_l2"]
    assert "TFLOP/s" not in text  # no device rate from a host clock


def test_rig_refuses_unknown_kinds_and_a_missing_card():
    with pytest.raises(ValueError, match="unknown kind"):
        attn_vpu.main(["--device", "cpu", "--kinds", "ctrl,fp8pv8"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            attn_vpu.main([])


def test_product_bounds_are_the_kinds_types():
    """The summary's product bound: bf16 at 989 TFLOP/s, e4m3 at 1979, at
    (32, 1676) 0.279 ms in bf16, 0.209 with e4m3 q.k, 0.140 with both."""
    flop = 2 * 32 * 12 * 1676 * 1676 * 64
    got = {k: attn_vpu.product_bound_ms(k, flop) for k in attn_vpu.ALL}
    assert got["ctrl"] == got["bf16sm"] == pytest.approx(0.2795, abs=5e-4)
    assert got["fp8sm"] == got["fp8noexp"] == pytest.approx(0.2097, abs=5e-4)
    assert got["fp8lean"] == pytest.approx(0.1398, abs=5e-4)
