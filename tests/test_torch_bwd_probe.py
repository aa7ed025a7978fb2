"""The backward rig's kernels (``ops/bwd_probe.py`` ``bwd_probe``) against
the TPU rig they port, ``scripts/bwd_int8_probe.py`` (P4). Its Pallas
kernel ``_bwd_rig_kernel`` runs here in interpret mode on the CPU, with the
rig's block specs cut to one head a program, on the first 2 heads of the
rig's own operands (its ``build``, at N_PAD 896); ctrl's ``_flash_bwd``
runs in interpret mode at (1, 866, 2, 64) with block_q 896, as the rig
calls it. Then the saturation of ds8, the check that refuses a wrapping
ds8, the rig of ``maest_tpu_torch.probes`` with ``--device cpu``, and the
wrapper's refusals.

Tolerances, each against the rig on the same operand values:
- int8: every int32 sum is exact on both sides (|sum| <= 896 x 128 x 127
  < 2^24, so the fp32 values are exact too), so the outputs can differ
  only where a p8 or ds8 code rounds apart: JAX's and PyTorch's fp32 exp2,
  or delta's fp32 sums taken in another order, at a rounding boundary. The
  test takes the rig's codes from a kernel of its own lines in interpret
  mode (checked to give its outputs exactly), counts the codes that differ
  from the plain version's (none more than 1 apart) and holds dq,
  dk and dv equal wherever no code of their row (dq) or column (dk, dv)
  differs, within 1.27 per differing code otherwise (127 x 1e-2, plus one
  bf16 ulp of the element for dq): ``bwd_probe.int8_gap``.
- fp8: exact e4m3 and bf16 products summed in fp32 in other orders, p and
  ds rounded to bf16 (an fp32 ulp apart at a boundary moves one by a bf16
  ulp), dq once more: each output within 2 bf16 ulps of its largest
  |element| (``bwd_probe.fp8_gap``).
- ctrl: both sides round dq, dk, dv to bf16, and ``_flash_bwd`` rounds p
  and ds to bf16 as well: each output within 2 bf16 ulps of its largest
  |element| (``bwd_probe.ctrl_gap``), a bound relative to the output's
  size, since at the rig's inputs the gradients are small (|dk| near
  0.03). The check is shown to refuse dq zeroed and lse's second 64-entry
  tile misplaced.

On the CPU the wrapper runs its plain version; ``chip_smoke.py`` (phase
29) and ``tests/test_torch_cuda.py`` hold the kernels to it on the card."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu_torch.ops import bwd_probe as P
from maest_tpu_torch.ops.int8_probe import to_int8
from maest_tpu_torch.probes import bwd_int8
from test_torch_mma_probes import _load

HEADS = 2  # of the rig's 384
JDT = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}


@pytest.fixture(scope="module")
def rig():
    return _load("bwd_int8_probe")


def _to_torch(x):
    """A jax array as a torch tensor of the same values and type."""
    if x.dtype == jnp.float8_e4m3fn:
        raw = np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint8))
        return torch.from_numpy(raw).view(torch.float8_e4m3fn)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _rig_operands(kind):
    """The first HEADS heads of the rig's ``build(kind)`` operands (q, kt,
    v, do, o, lse), as jax arrays and as torch tensors."""
    mod = _load("bwd_int8_probe")
    ops = tuple(x[:HEADS] for x in mod.build(kind)[1])
    return ops, tuple(_to_torch(x) for x in ops)


def _interpret(rig, kind, ops):
    """``_bwd_rig_kernel`` in interpret mode, one head a program (the rig's
    block specs with G = 1); (dq, dk, dv) as torch tensors."""
    from jax.experimental import pallas as pl

    bh, n, d = ops[0].shape

    def spec(shape):
        return pl.BlockSpec((1,) + tuple(shape[1:]), lambda i: (i, 0, 0))

    outs = pl.pallas_call(
        functools.partial(rig._bwd_rig_kernel, kind=kind),
        out_shape=[jax.ShapeDtypeStruct((bh, n, d), jnp.bfloat16),
                   jax.ShapeDtypeStruct((bh, n, d), jnp.float32),
                   jax.ShapeDtypeStruct((bh, n, d), jnp.float32)],
        grid=(bh,), in_specs=[spec(x.shape) for x in ops],
        out_specs=[spec((bh, n, d))] * 3, interpret=True)(*ops)
    return tuple(_to_torch(x) for x in outs)


def _interpret_codes(rig, ops):
    """(p8, ds8) of the int8 kind as the rig's kernel forms them: a kernel
    of its lines up to ds8 (bwd_int8_probe.py:58-81, 65-68, 79-80) in
    interpret mode, writing the codes (the test checks they give the rig's
    outputs exactly)."""
    from jax.experimental import pallas as pl

    def codes_kernel(q_ref, kt_ref, v_ref, do_ref, o_ref, lse_ref, p8_ref,
                     ds8_ref):
        sl = rig.SCALE * rig.A._LOG2E
        for h in range(q_ref.shape[0]):
            q = q_ref[h]
            do = do_ref[h]
            lse = lse_ref[h, 0][:, None]
            delta = jnp.sum(do.astype(jnp.float32)
                            * o_ref[h].astype(jnp.float32), axis=-1,
                            keepdims=True)
            s = jnp.dot(q, kt_ref[h], preferred_element_type=jnp.int32
                        ).astype(jnp.float32) * (sl * 1e-4)
            p = jnp.exp2(s - lse)
            p8_ref[h] = jnp.round(p * 127.0).astype(jnp.int8)
            dp = jax.lax.dot_general(
                do, v_ref[h], (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32).astype(jnp.float32) * 1e-4
            ds8_ref[h] = jnp.round(p * (dp - delta) * (rig.SCALE * 127.0)
                                   ).astype(jnp.int8)

    bh, n, _ = ops[0].shape

    def spec(shape):
        return pl.BlockSpec((1,) + tuple(shape[1:]), lambda i: (i, 0, 0))

    codes = pl.pallas_call(
        codes_kernel, out_shape=[jax.ShapeDtypeStruct((bh, n, n), jnp.int8)] * 2,
        grid=(bh,), in_specs=[spec(x.shape) for x in ops],
        out_specs=[spec((bh, n, n))] * 2, interpret=True)(*ops)
    return tuple(torch.from_numpy(np.array(c)) for c in codes)


def test_int8_matches_tpu_rig_interpret(rig):
    jops, tops = _rig_operands("int8")
    out = _interpret(rig, "int8", jops)
    ref = P.bwd_probe(*tops, "int8")  # the plain version on the CPU
    jcodes = _interpret_codes(rig, jops)
    for a, b in zip(P.int8_outputs(tops[0], tops[1], tops[3], *jcodes), out):
        assert torch.equal(a, b)  # the codes are the rig's
    gap = P.int8_gap(out, ref, P.int8_codes(*tops), jcodes)
    assert gap["ok"], gap
    assert gap["p8"] + gap["ds8"] <= 1e-5 * 2 * jcodes[0].numel(), gap
    for a, r in zip(out, ref):
        assert a.shape == r.shape and a.dtype == r.dtype


def test_fp8_matches_tpu_rig_interpret(rig):
    jops, tops = _rig_operands("fp8")
    out = _interpret(rig, "fp8", jops)
    ref = P.bwd_probe(*tops, "fp8")
    gap = P.fp8_gap(out, ref)
    assert gap["ok"], gap
    for a, r in zip(out, ref):
        assert a.shape == r.shape and a.dtype == r.dtype


def test_ctrl_matches_flash_bwd_interpret(rig):
    """ctrl's plain version (K3b's, on the first 866 entries of the rig's
    lse draw) against ``_flash_bwd`` in interpret mode, called as the rig
    calls it: (1, 866, 2, 64) bf16, block_q 896, lse (2, 1, 896)."""
    q, k, v, do, o, lse = bwd_int8.operands("ctrl", "cpu", 1, HEADS)
    jq, jk, jv, jdo, jo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                           for t in (q, k, v, do, o))
    want = rig.A._flash_bwd(jq, jk, jv, jo, jnp.asarray(lse.numpy()), jdo,
                            block_q=896, block_k=1 << 30, interpret=True,
                            n_real=bwd_int8.N)
    got = P.bwd_probe(q, k, v, do, o, lse, "ctrl")
    for a in got:
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
    gap = P.ctrl_gap(got, [torch.from_numpy(np.array(w.astype(jnp.float32)))
                           for w in want])
    print("ctrl vs _flash_bwd: " + ", ".join(
        f"{w} {gap['err'][w]:.3e} <= {gap['bound'][w]:.3e}"
        for w in ("dq", "dk", "dv")))
    assert gap["ok"], gap


@pytest.mark.parametrize("fault", ["dq_zeroed", "lse_tile_misplaced"])
def test_ctrl_check_refuses_faults(fault):
    """ctrl_gap refuses dq zeroed and the plain ctrl on lse with its second
    64-entry tile replaced by the third, at (1, 866, 2, 64), both against
    the plain ctrl on the rig's lse. Run with -s to see the readings."""
    q, k, v, do, o, lse = bwd_int8.operands("ctrl", "cpu", 1, HEADS)
    ref = P.bwd_probe(q, k, v, do, o, lse, "ctrl")
    if fault == "dq_zeroed":
        bad = (torch.zeros_like(ref[0]), *ref[1:])
    else:
        moved = lse.clone()
        moved[..., 64:128] = lse[..., 128:192]
        bad = P.bwd_probe(q, k, v, do, o, moved, "ctrl")
    gap = P.ctrl_gap(bad, ref)
    print(f"ctrl, {fault}: " + ", ".join(
        f"{w} {gap['err'][w]:.3e} (bound {gap['bound'][w]:.3e})"
        for w in ("dq", "dk", "dv")))
    assert not gap["ok"]


def test_ds8_saturates_as_jnp_does():
    """On the rig's inputs p (dp - delta) SCALE 127 leaves the int8 range;
    the plain ds8 takes 127 and -128 there, as jnp's round(x).astype(int8)
    gives them, and equals jnp's conversion of the same values."""
    _, (q, kt, v, do, o, lse) = _rig_operands("int8")
    p8, ds8 = P.int8_codes(q, kt, v, do, o, lse)
    scale = q.shape[-1]**-0.5
    s = P._exact(q, kt).float() * P._f32(scale * P._LOG2E * 1e-4, q)
    p = torch.exp2(s - lse.transpose(1, 2))
    dp = P._exact(do, v.transpose(1, 2)).float() * P._f32(1e-4, q)
    x = p * (dp - P._delta(do, o)) * P._f32(scale * 127.0, q)
    hi, lo = x > 127.5, x < -128.5
    assert hi.any() and lo.any()
    assert (ds8[hi] == 127).all() and (ds8[lo] == -128).all()
    want = jnp.round(jnp.asarray(x.numpy())).astype(jnp.int8)
    assert torch.equal(ds8, torch.from_numpy(np.asarray(want)))
    assert torch.equal(to_int8(x), ds8)
    assert p8.max() <= 127 and (p * 127.0).max() < 127.5  # p8 never saturates


def test_int8_check_refuses_a_wrapping_ds8():
    """int8_gap refuses the outputs of ds8 converted with wraparound (as
    csrc/mma_8bit.cuh's to_s8 would convert it) in place of saturation."""
    _, tops = _rig_operands("int8")
    codes = P.int8_codes(*tops)
    q, kt, v, do, o, lse = tops
    scale = q.shape[-1]**-0.5
    s = P._exact(q, kt).float() * P._f32(scale * P._LOG2E * 1e-4, q)
    p = torch.exp2(s - lse.transpose(1, 2))
    dp = P._exact(do, v.transpose(1, 2)).float() * P._f32(1e-4, q)
    x = torch.round(p * (dp - P._delta(do, o)) * P._f32(scale * 127.0, q))
    wrapped = ((x.long() + 128) % 256 - 128).to(torch.int8)
    assert (wrapped != codes[1]).any()
    bad = P.int8_outputs(q, kt, do, codes[0], wrapped)
    ref = P.int8_outputs(q, kt, do, *codes)
    assert P.int8_gap(ref, ref, codes, codes)["ok"]
    assert not P.int8_gap(bad, ref, codes, codes)["ok"]


def test_rig_runs_on_the_cpu(capsys):
    res = bwd_int8.main(["--device", "cpu", "--iters", "1", "--rounds", "1"])
    assert set(res) == set(P.KINDS)
    assert all(r["ms"] > 0 for r in res.values())
    assert res["int8"]["bound_by"] == "bytes"
    assert abs(res["int8"]["bound_ms"] - 0.1056) < 5e-4
    assert abs(res["fp8"]["bound_ms"] - 0.1596) < 5e-4
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(P.KINDS)


def test_rig_operands_are_the_tpu_rigs(rig):
    """The port's draw gives the rig's values (first heads of a cut draw:
    q is drawn first, so its first heads agree)."""
    for kind in ("int8", "fp8"):
        _, tops = _rig_operands(kind)
        mine = bwd_int8.operands(kind, "cpu", 1, HEADS)
        if kind == "int8":
            assert torch.equal(mine[0], tops[0])
        else:
            assert torch.equal(mine[0].view(torch.uint8),
                               tops[0].view(torch.uint8))


def test_refusals():
    x = torch.zeros(HEADS, 896, 32, dtype=torch.int8, device="meta")
    kt = torch.zeros(HEADS, 32, 896, dtype=torch.int8, device="meta")
    o = torch.zeros(HEADS, 896, 32, dtype=torch.bfloat16, device="meta")
    lse = torch.zeros(HEADS, 1, 896, device="meta")
    with pytest.raises(ValueError, match="head_dim 64"):
        P.bwd_probe(x, kt, x, x, o, lse, "int8")
    with pytest.raises(ValueError, match="unknown kind"):
        P.bwd_probe(x, kt, x, x, o, lse, "int4")
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        P.bwd_probe(x, kt, x, x, o, lse, "fp8")
    with pytest.raises(ValueError, match="unknown kind"):
        bwd_int8.main(["--device", "cpu", "--kinds", "ctrl,int4"])
    y = torch.zeros(1, 866, HEADS, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim 64"):
        P.bwd_probe(y, y, y, y, y, lse, "ctrl")
