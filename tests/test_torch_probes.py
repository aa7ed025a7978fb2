"""The attention-decomposition variants of the port (``ops/attention_probe.py``,
``probes/attn_profile.py``) against the TPU rig they port,
``scripts/attn_profile_r2.py``, whose Pallas kernels run here in interpret
mode on the CPU, built as its ``time_variant``, ``time_gh`` and
``time_int8`` build them (q pre-scaled for bf16s, G heads a program for
gh, the rig's quantization for int8), with the port kernel's key tile as
``block_k``: 64, and for bf16s and gh, whose routes are K2's ``wgmma``
kernel, its 96 or 112 (``wg_key_tile``); their ``mma.sync`` controls
(``attention_probe_mma``, ``attention_probe_gh_mma``) keep 64.

Tolerances: two bf16 ulps of the largest |o| for the bf16 variants and gh.
Both sides round one fp32 output to bf16, and their fp32 values differ
only by sums taken in other orders (and XLA's exp2 against PyTorch's, a
few fp32 ulps), so an element may round one ulp apart, never two. int8
(fp32 output): each row within one p flip of the rig, max|v| / (127 l)
(an exp2 ulp may round one p8 the other way), plus 1e-5 of max|o| for
sums in other orders; its output times 127 within 1e-2 of fp32 attention
(int8 rounds q, k, v and p to 1/254 of their maxima).

On the CPU ``attention_probe`` runs its plain version;
``tests/test_torch_cuda.py`` holds the kernels to it on the card."""

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

from maest_tpu_torch.ops.attention import (
    WG_KEY_TILES,
    attention_reference,
    flash_attention,
    wg_key_tile,
)
from maest_tpu_torch.ops.attention_probe import (
    BLOCK_K,
    GROUPS,
    VARIANTS,
    attention_probe,
    attention_probe_gh,
    attention_probe_gh_mma,
    attention_probe_gh_mma_reference,
    attention_probe_gh_reference,
    attention_probe_int8,
    attention_probe_int8_reference,
    attention_probe_mma,
    attention_probe_mma_reference,
    attention_probe_reference,
)
from maest_tpu_torch.probes import attn_profile

ROOT = Path(__file__).resolve().parent.parent
KERNEL_OF = {"mxu_only": "_mxu_only_kernel", "noexp_max": "_noexp_max_kernel",
             "novmax": "_novmax_kernel", "bf16s": "_bf16_scores_kernel"}


@pytest.fixture(scope="module")
def rig():
    """scripts/attn_profile_r2.py, loaded by path. Its import puts "." on
    sys.path and points JAX's compilation cache into the home directory;
    both are put back at once, so nothing else on this worker sees them."""
    path, cache = list(sys.path), jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            "attn_profile_r2", ROOT / "scripts" / "attn_profile_r2.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def _qkv(b, n, h, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3, h, 64)).astype(np.float32)


def _port_block_k(variant, n_real):
    """The key tile of the port's route for ``variant``."""
    return wg_key_tile(n_real) if variant == "bf16s" else BLOCK_K


def _tpu_variant(rig, variant, x, block_k=BLOCK_K, n_real=None):
    """The rig's Pallas kernel for ``variant`` on bf16 x (B, N, 3, H, 64),
    keys >= n_real (default N) masked, padded to a multiple of 128 (of
    ``block_k`` where that does not divide 128), one q block per head."""
    from jax.experimental import pallas as pl

    A = rig.A
    b, n, _, h, d = x.shape
    step = 128 if 128 % block_k == 0 else block_k
    n_pad = -(-n // step) * step
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    qf, kf, vf = A._flatten_pad(n_pad, xj[:, :, 0], xj[:, :, 1], xj[:, :, 2])
    if variant in rig.PREFOLD_SCALE:
        qf = (qf.astype(jnp.float32) * (d**-0.5 * A._LOG2E)).astype(qf.dtype)
    kt = jnp.swapaxes(kf, 1, 2)
    (out,) = pl.pallas_call(
        functools.partial(rig.KERNELS[variant], scale=d**-0.5,
                          n_real=n if n_real is None else n_real,
                          block_k=block_k),
        out_shape=[jax.ShapeDtypeStruct((b * h, n_pad, d), jnp.bfloat16)],
        grid=(b * h, 1),
        in_specs=[
            pl.BlockSpec((1, n_pad, d), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, d, n_pad), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, n_pad, d), lambda i, j: (i, 0, 0)),
        ],
        out_specs=[pl.BlockSpec((1, n_pad, d), lambda i, j: (i, 0, 0))],
        interpret=True,
    )(qf, kt, vf)
    return np.asarray(A._unflatten(out, b, n, h, d).astype(jnp.float32))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def test_rig_kernels_are_the_ported_ones(rig):
    assert set(KERNEL_OF) == set(VARIANTS)
    for variant, name in KERNEL_OF.items():
        assert rig.KERNELS[variant].__name__ == name
    assert rig.PREFOLD_SCALE == {"bf16s"}
    assert attn_profile.ARCH_N == rig.ARCH_N


# n - n_pad < 64 at both lengths (100 -> 128, 200 -> 256): the TPU kernel
# walks every key block up to n_pad, and a block wholly past n would give
# its masked keys p = exp2(-1e30 - (-1e30)) = 1 under novmax; the port's
# loop ends at the last tile that holds a real key.
@pytest.mark.parametrize("b,n", [(1, 100), (2, 200)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_probe_matches_tpu_rig_interpret(rig, variant, b, n):
    x = _qkv(b, n, 2, seed=n + b)
    want = _tpu_variant(rig, variant, x, _port_block_k(variant, n))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = attention_probe(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], variant)
    assert got.shape == (b, n, 2, 64) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all()
    top = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2 * _bf16_ulp(top), (err, top)
    # and the port's other variants lie well away from this one: bf16s and
    # noexp_max differ by less than the bound (~6e-3 against 7.8e-3 here)
    for other in VARIANTS:
        if other != variant:
            far = attention_probe(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], other)
            assert float(np.abs(far.float().numpy() - want).max()) > 4 * err


# bf16s's route is K2's wgmma kernel: its plain version walks that kernel's
# key tile, 96 or 112 keys (wg_key_tile), each taken here, with and
# without keys masked past n_real
BF16S_CASES = [(1, 90, None), (2, 180, None), (1, 100, None), (2, 200, None),
               (2, 200, 185), (2, 300, 281), (1, 220, 215)]


def test_bf16s_cases_take_both_wgmma_key_tiles():
    """wg_key_tile takes 112 keys where they pad n_real less than 96 do,
    as the kernels' entries choose (K2's: 112 at the 30 s recipe's 866 and
    tagging's 1676, 96 at the 10 s recipe's 281; the header's
    ``wg_key_tile``, which both entries call), and the cases above take
    each tile."""
    assert {wg_key_tile(n if r is None else r)
            for _, n, r in BF16S_CASES} == set(WG_KEY_TILES)
    assert [wg_key_tile(n) for n in (866, 1676, 281, 96, 112, 1)] == [
        112, 112, 96, 96, 112, 96]
    # one rule, in the header that both C entries call
    csrc = ROOT / "maest_tpu_torch" / "csrc"
    assert "constexpr int wg_key_tile(int n_real)" in (
        csrc / "attn_fwd_wgmma.cuh").read_text()
    for entry in ("attention_fwd.cu", "attention_probe.cu"):
        assert "if (wg_key_tile(n_real) == 112)" in (csrc / entry).read_text()


@pytest.mark.parametrize("b,n,n_real", BF16S_CASES)
def test_bf16s_route_matches_tpu_rig_at_its_key_tile(rig, b, n, n_real):
    """The route's plain version (``attention_probe`` on CPU tensors)
    against the rig's ``_bf16_scores_kernel`` in interpret mode at the
    same ``block_k``, keys >= n_real masked on both sides: within two bf16
    ulps of the largest |o|."""
    nr = n if n_real is None else n_real
    x = _qkv(b, n, 2, seed=3 * n + b)
    want = _tpu_variant(rig, "bf16s", x, wg_key_tile(nr), nr)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = attention_probe(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], "bf16s",
                          n_real)
    assert got.shape == (b, n, 2, 64) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all()
    top = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2 * _bf16_ulp(top), (err, top)


@pytest.mark.parametrize("b,n,n_real", [(1, 100, None), (2, 200, 185)])
def test_bf16s_control_matches_tpu_rig_at_64(rig, b, n, n_real):
    """bf16s's control (``attention_probe_mma``, the mma.sync kernel behind
    the PyTorch pre-scaling pass) keeps its 64-key tiles: on CPU tensors
    its plain version, within two bf16 ulps of the rig at block_k 64."""
    nr = n if n_real is None else n_real
    x = _qkv(b, n, 2, seed=5 * n + b)
    want = _tpu_variant(rig, "bf16s", x, BLOCK_K, nr)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = attention_probe_mma(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2], "bf16s",
                              n_real)
    top = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 2 * _bf16_ulp(
        top)


def test_bf16s_control_on_the_cpu_is_plain_and_takes_bf16s_only():
    """On CPU tensors the control is ``attention_probe_mma_reference`` (64-key
    tiles) and counts no launch; it refuses every other variant, on the
    CPU as on the card."""
    x = torch.from_numpy(_qkv(2, 150, 3, seed=6)).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = (dict(attention_probe.launches), attention_probe_mma.launches)
    got = attention_probe_mma(q, k, v, "bf16s", 140)
    assert torch.equal(got, attention_probe_mma_reference(q, k, v, "bf16s",
                                                          140))
    # the route's plain version walks 96-key tiles at 140 keys, the
    # control's 64: the same function, rounded against other running maxima
    route = attention_probe(q, k, v, "bf16s", 140)
    top = route.float().abs().max().item()
    assert (got.float() - route.float()).abs().max().item() <= 2 * _bf16_ulp(
        top)
    assert (dict(attention_probe.launches), attention_probe_mma.launches) == \
        before
    for variant in ("mxu_only", "noexp_max", "novmax", "flash"):
        with pytest.raises(ValueError, match="control of bf16s only"):
            attention_probe_mma(q, k, v, variant)
        with pytest.raises(ValueError, match="control of bf16s only"):
            attention_probe_mma_reference(q, k, v, variant)


def test_bf16s_route_names_the_wgmma_entry(monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: ``attention_probe(..., "bf16s")``
    names ``maest_attn_probe_bf16s_wgmma`` (no variant argument) on the
    unscaled q, counted in ``attention_probe.launches``; its control names
    ``maest_attn_probe_bf16``'s variant 4 on the pre-scaled q, counted in
    ``attention_probe_mma.launches``; the other variants keep their
    mma.sync entry."""
    from maest_tpu_torch.ops import attention_probe as P

    seen = []

    def record(name, select, q, k, v, n_real, sl):
        seen.append((name, select, n_real, round(sl, 6)))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    monkeypatch.setattr(P, "launch_bf16", record)
    monkeypatch.setattr(P, "prescale_q", lambda q: q)  # no meta arithmetic
    monkeypatch.setattr(P.attention_probe, "launches",
                        dict.fromkeys(VARIANTS, 0))
    monkeypatch.setattr(P.attention_probe_mma, "launches", 0)
    x = torch.zeros(2, 300, 2, 64, dtype=torch.bfloat16, device="meta")
    sl = round(64**-0.5 * 1.4426950408889634, 6)
    assert P.attention_probe(x, x, x, "bf16s", 281).shape == x.shape
    P.attention_probe_mma(x, x, x, "bf16s")
    P.attention_probe(x, x, x, "novmax")
    assert seen == [("maest_attn_probe_bf16s_wgmma", None, 281, sl),
                    ("maest_attn_probe_bf16", 4, 300, sl),
                    ("maest_attn_probe_bf16", 3, 300, sl)]
    assert P.attention_probe.launches == {"mxu_only": 0, "noexp_max": 0,
                                          "novmax": 1, "bf16s": 1}
    assert P.attention_probe_mma.launches == 1
    with pytest.raises(ValueError, match="control of bf16s only"):
        P.attention_probe_mma(x, x, x, "novmax")


def test_probe_on_the_cpu_is_the_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_qkv(2, 90, 3, seed=1)).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = dict(attention_probe.launches)
    for variant in VARIANTS:
        n_real = None if variant == "mxu_only" else 77
        assert torch.equal(attention_probe(q, k, v, variant, n_real),
                           attention_probe_reference(q, k, v, variant, n_real))
    assert attention_probe.launches == before


def test_softmax_variants_are_attention_and_the_others_are_not():
    """noexp_max and bf16s compute softmax attention (bf16s on rounded
    scores); novmax weighs each 64-key tile by its own max; mxu_only takes
    no softmax at all."""
    x = torch.from_numpy(_qkv(2, 300, 2, seed=2)).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    ref = attention_reference(q.float(), k.float(), v.float(), n_real=290)
    err = {var: (attention_probe(q, k, v, var, None if var == "mxu_only"
                                 else 290).float() - ref).abs().max().item()
           for var in VARIANTS}
    assert err["noexp_max"] <= 1e-2 and err["bf16s"] <= 1e-2, err
    assert err["novmax"] > 1e-1 and err["mxu_only"] > 1.0, err
    # masked keys get no mass: keys and values past n_real change nothing
    y = x.clone()
    y[:, 290:, 1:] = 7.0
    for var in ("noexp_max", "novmax", "bf16s"):
        assert torch.equal(
            attention_probe(q, k, v, var, 290),
            attention_probe(y[:, :, 0], y[:, :, 1], y[:, :, 2], var, 290)), var


def test_probe_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 16, 3, 2, 64, dtype=torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    with pytest.raises(TypeError, match="bfloat16"):
        attention_probe(q.float(), k.float(), v.float(), "noexp_max")
    y = torch.zeros(1, 16, 3, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention_probe(y[:, :, 0], y[:, :, 1], y[:, :, 2], "novmax")
    with pytest.raises(ValueError, match="unknown attention probe variant"):
        attention_probe(q, k, v, "flash")
    with pytest.raises(ValueError, match="n_real = N only"):
        attention_probe(q, k, v, "mxu_only", n_real=8)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        attention_probe(q, k, v, "bf16s", n_real=17)
    # n_real = N is no mask, for mxu_only too
    assert torch.equal(attention_probe(q, k, v, "mxu_only", n_real=16),
                       attention_probe(q, k, v, "mxu_only"))


def test_rig_prints_each_variant_and_the_decomposition(capsys):
    out = attn_profile.main(["--device", "cpu", "--batch", "1", "--heads", "2",
                             "--shapes", "100,70", "--iters", "1"])
    text = capsys.readouterr().out
    variants = ("flash", *VARIANTS, "plain")
    assert list(out) == ["100", "70"]
    assert set(out["100"]) == set(attn_profile.DEFAULT_VARIANTS.split(","))
    assert all(t["ms"] > 0 and t["graph_ms"] is None
               for row in out.values() for t in row.values())
    for variant in variants:
        lines = [s for s in text.splitlines()
                 if re.match(rf"\s+{variant}\s+[\d.]+ ms", s)]
        assert len(lines) == 2 and all("cpu" in s for s in lines), variant
    for a, b, _ in attn_profile.DIFFS:
        assert text.count(f"{a} - {b} = ") == 2
    assert "TFLOP/s" not in text  # no device rate from a host clock


def test_rig_check_prints_a_diff_per_variant(capsys):
    variants = ["flash", *VARIANTS, "plain"]
    diffs = attn_profile.main(["--device", "cpu", "--heads", "2", "--shapes",
                               "150", "--check", "--variants",
                               ",".join(variants)])
    text = capsys.readouterr().out
    assert list(diffs) == variants
    for variant in variants:
        assert f"check {variant:10s} max|diff|" in text
    for variant in ("flash", "noexp_max", "bf16s", "plain"):
        assert diffs[variant] <= 1e-2, diffs
    assert diffs["novmax"] > 1e-2 and diffs["mxu_only"] > 1.0


def test_rig_runs_gh_and_int8_and_prints_their_differences(capsys):
    out = attn_profile.main(["--device", "cpu", "--batch", "2", "--heads",
                             "2", "--shapes", "64,90", "--iters", "1",
                             "--variants",
                             "flash,wgmma,gh1,gh2,gh4,gh2_mma,int8"])
    text = capsys.readouterr().out
    assert list(out) == ["64", "90"]
    for row in out.values():
        assert set(row) == {"flash", "wgmma", "gh1", "gh2", "gh4", "gh2_mma",
                            "int8"}
        assert all(t["ms"] > 0 and t["graph_ms"] is None
                   for t in row.values())
    for g in (1, 2, 4):
        assert text.count(f"gh{g} - wgmma = ") == 2
    assert text.count("gh2_mma - flash = ") == 2
    assert len(re.findall(r"\s+int8\s+[\d.]+ ms \(host clock", text)) == 2


def test_rig_check_prints_int8_times_127(capsys):
    diffs = attn_profile.main(["--device", "cpu", "--heads", "2", "--shapes",
                               "120", "--check", "--variants",
                               "flash,gh2,int8"])
    text = capsys.readouterr().out
    assert "the rig's output is attention / 127" in text
    assert diffs["gh2"] <= 1e-2 and diffs["flash"] <= 1e-2
    # on --check's N(0, 1) inputs int8's rounding of the scores costs more
    # than on the rig's N(0, 0.5^2) (~2e-2 against ~2e-3)
    assert diffs["int8 x 127"] <= 5e-2 < 0.5 < diffs["int8"]


@pytest.mark.parametrize("variant", ["gh3", "gh16", "gh", "int4", "gh3_mma",
                                     "gh_mma", "gh2_ctl"])
def test_rig_refuses_groups_it_has_no_kernel_for(variant):
    with pytest.raises(ValueError, match="unknown variant"):
        attn_profile.main(["--device", "cpu", "--variants", f"flash,{variant}",
                           "--shapes", "64", "--batch", "1", "--heads", "1"])


def test_rig_refuses_unknown_variants_shapes_and_a_missing_card():
    with pytest.raises(ValueError, match="unknown variant"):
        attn_profile.main(["--device", "cpu", "--variants", "xla"])
    with pytest.raises(ValueError, match="unknown shape"):
        attn_profile.main(["--device", "cpu", "--shapes", "45s"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            attn_profile.main([])


def test_flash_variant_is_k2():
    """The rig's flash is flash_attention: on the CPU its plain version."""
    x = torch.from_numpy(_qkv(1, 40, 2, seed=3)).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    assert torch.equal(attn_profile.variant_fn("flash", q, k, v)(),
                       flash_attention(q, k, v))


def test_launch_probe_refuses_cpu_tensors():
    """The kernel alone runs on the card only: on CPU tensors
    attention_probe is the plain version and launch_probe raises."""
    from maest_tpu_torch.ops.attention_probe import launch_probe

    x = torch.from_numpy(_qkv(1, 40, 2, seed=4)).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        launch_probe(q, k, v, "bf16s")
    with pytest.raises(ValueError, match="unknown attention probe variant"):
        launch_probe(q, k, v, "flash")


# --- P6e (gh) and P6f (int8) against the rig's Pallas kernels -------------
def _tpu_gh(rig, x, g, block_k=BLOCK_K, n_real=None):
    """The rig's ``_gh_kernel`` on bf16 x (B, N, 3, H, 64) as ``time_gh``
    builds it (:188-209): G heads a program, keys >= n_real (default N)
    masked, padded to a multiple of 128 (of ``block_k`` where that does not
    divide 128, as ``_tpu_variant`` pads for bf16s)."""
    from jax.experimental import pallas as pl

    A = rig.A
    b, n, _, h, d = x.shape
    step = 128 if 128 % block_k == 0 else block_k
    n_pad, bh = -(-n // step) * step, b * h
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    qf, kf, vf = A._flatten_pad(n_pad, xj[:, :, 0], xj[:, :, 1], xj[:, :, 2])
    kt = jnp.swapaxes(kf, 1, 2)
    qg = qf.reshape(bh // g, g, n_pad, 64)
    ktg = kt.reshape(bh // g, g, 64, n_pad)
    vg = vf.reshape(bh // g, g, n_pad, 64)
    (out,) = pl.pallas_call(
        functools.partial(rig._gh_kernel, scale=64**-0.5,
                          n_real=n if n_real is None else n_real,
                          block_k=block_k),
        out_shape=[jax.ShapeDtypeStruct((bh // g, g, n_pad, 64),
                                        jnp.bfloat16)],
        grid=(bh // g,),
        in_specs=[
            pl.BlockSpec((1, g, n_pad, 64), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((1, g, 64, n_pad), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((1, g, n_pad, 64), lambda i: (i, 0, 0, 0)),
        ],
        out_specs=[pl.BlockSpec((1, g, n_pad, 64), lambda i: (i, 0, 0, 0))],
        interpret=True,
    )(qg, ktg, vg)
    out = A._unflatten(out.reshape(bh, n_pad, 64), b, n, h, 64)
    return np.asarray(out.astype(jnp.float32))


def _tpu_int8(rig, q, k, v):
    """The rig's ``_int8_kernel`` on fp32 (B, N, H, 64) with ``time_int8``'s
    quantization and call (:288-321), one q block per head."""
    from jax.experimental import pallas as pl

    A = rig.A
    b, n, h, _ = q.shape
    n_pad, bh = -(-n // 128) * 128, b * h
    qf, kf, vf = A._flatten_pad(n_pad, *(jnp.asarray(t) for t in (q, k, v)))
    qs = jnp.max(jnp.abs(qf), axis=2, keepdims=True)
    qs = jnp.maximum(qs, 1e-6)
    q8 = jnp.round(qf / qs * 127.0).astype(jnp.int8)
    ks = jnp.max(jnp.abs(kf), axis=2, keepdims=True)
    ks = jnp.maximum(ks, 1e-6)
    k8 = jnp.round(kf / ks * 127.0).astype(jnp.int8)
    vs = jnp.max(jnp.abs(vf), axis=1, keepdims=True)
    vs = jnp.maximum(vs, 1e-6)
    v8 = jnp.round(vf / vs * 127.0).astype(jnp.int8)
    kt8 = jnp.swapaxes(k8, 1, 2)
    kst = jnp.swapaxes(ks, 1, 2)
    qsc = qs / 127.0 / 127.0
    vsc = vs / 127.0 / 127.0
    (out,) = pl.pallas_call(
        functools.partial(rig._int8_kernel, scale=64**-0.5, n_real=n,
                          block_k=BLOCK_K),
        out_shape=[jax.ShapeDtypeStruct((bh, n_pad, 64), jnp.float32)],
        grid=(bh, 1),
        in_specs=[
            pl.BlockSpec((1, n_pad, 64), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, 64, n_pad), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, n_pad, 64), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, n_pad, 1), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, 1, n_pad), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, 1, 64), lambda i, j: (i, 0, 0)),
        ],
        out_specs=[pl.BlockSpec((1, n_pad, 64), lambda i, j: (i, j, 0))],
        interpret=True,
    )(q8, kt8, v8, qsc, kst, vsc)
    return np.asarray(A._unflatten(out, b, n, h, 64))


def test_rig_gh_and_int8_kernels_are_the_ported_ones(rig):
    assert rig._gh_kernel.__name__ == "_gh_kernel"
    assert rig._int8_kernel.__name__ == "_int8_kernel"
    assert "int8" not in rig.KERNELS and not any(
        name.startswith("gh") for name in rig.KERNELS)


@pytest.mark.parametrize("b,n,h,g", [(2, 100, 2, 2), (1, 200, 4, 4)])
def test_gh_matches_tpu_rig_interpret(rig, b, n, h, g):
    """The route (K2's wgmma kernel with G heads a block; on CPU tensors its
    plain version) against the rig's ``_gh_kernel`` at the route's key
    tile: within two bf16 ulps of the largest |o|."""
    x = _qkv(b, n, h, seed=n + g)
    want = _tpu_gh(rig, x, g, wg_key_tile(n))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    got = attention_probe_gh(q, k, v, g)
    assert got.shape == (b, n, h, 64) and got.dtype == torch.bfloat16
    top = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 2 * _bf16_ulp(top)
    # the group moves heads between blocks, not the arithmetic
    for other in GROUPS:
        if b * h % other == 0:
            assert torch.equal(attention_probe_gh(q, k, v, other), got)


# gh's route at G 1, 2, 4 and 8, keys masked past n_real, taking each of
# the wgmma kernel's key tiles (96 at 185 and 90 keys, 112 at 215 and 100)
GH_CASES = [(1, 200, 8, 1, 185), (1, 100, 4, 2, 90), (2, 220, 2, 4, 215),
            (1, 112, 8, 8, 100)]


def test_gh_cases_take_both_wgmma_key_tiles():
    assert {wg_key_tile(r) for *_, r in GH_CASES} == set(WG_KEY_TILES)
    assert {g for _, _, _, g, _ in GH_CASES} == set(GROUPS)


@pytest.mark.parametrize("b,n,h,g,n_real", GH_CASES)
def test_gh_route_matches_tpu_rig_at_its_key_tile(rig, b, n, h, g, n_real):
    """``attention_probe_gh`` on CPU tensors (the route's plain version, on
    the wgmma kernel's key tile) against the rig's ``_gh_kernel`` in
    interpret mode at ``block_k = wg_key_tile(n_real)``, keys >= n_real
    masked on both sides: within two bf16 ulps of the largest |o|; keys
    past n_real change nothing."""
    x = _qkv(b, n, h, seed=11 * n + g)
    want = _tpu_gh(rig, x, g, wg_key_tile(n_real), n_real)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    got = attention_probe_gh(q, k, v, g, n_real)
    assert got.shape == (b, n, h, 64) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all()
    top = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 2 * _bf16_ulp(
        top)
    y = xt.clone()
    y[:, n_real:, 1:] = 7.0
    assert torch.equal(attention_probe_gh(y[:, :, 0], y[:, :, 1], y[:, :, 2],
                                          g, n_real), got)


@pytest.mark.parametrize("g", GROUPS)
def test_gh_control_matches_tpu_rig_at_64(rig, g):
    """The gh control (``attention_probe_gh_mma``, K2's mma.sync template
    with G heads a block) keeps its 64-key tiles: on CPU tensors its plain
    version, within two bf16 ulps of the rig's ``_gh_kernel`` at block_k
    64 with keys masked past n_real, and equal for every group."""
    b, n, h, n_real = 1, 150, 8, 140
    x = _qkv(b, n, h, seed=13 + g)
    want = _tpu_gh(rig, x, g, BLOCK_K, n_real)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, k, v = xt[:, :, 0], xt[:, :, 1], xt[:, :, 2]
    got = attention_probe_gh_mma(q, k, v, g, n_real)
    top = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= 2 * _bf16_ulp(
        top)
    assert torch.equal(got, attention_probe_gh_mma(q, k, v, 1, n_real))


def test_gh_control_on_the_cpu_is_plain_and_counts_no_launch():
    """On CPU tensors the control is ``attention_probe_gh_mma_reference``
    (64-key tiles) and counts no launch; it is the route's function on the
    route's 96- or 112-key tiles within two bf16 ulps; it refuses what the
    route refuses."""
    x = torch.from_numpy(_qkv(2, 150, 4, seed=17)).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = (dict(attention_probe_gh.launches),
              dict(attention_probe_gh_mma.launches))
    for g in GROUPS:
        got = attention_probe_gh_mma(q, k, v, g, 140)
        assert torch.equal(got, attention_probe_gh_mma_reference(q, k, v, g,
                                                                 140))
        route = attention_probe_gh(q, k, v, g, 140)
        top = route.float().abs().max().item()
        assert (got.float() - route.float()).abs().max().item() <= \
            2 * _bf16_ulp(top)
    assert (attention_probe_gh.launches, attention_probe_gh_mma.launches) == \
        before
    with pytest.raises(ValueError, match="attention_probe_gh_mma takes a "
                       "group of 1, 2, 4, 8"):
        attention_probe_gh_mma(q, k, v, 3)
    with pytest.raises(ValueError, match="not divisible by the group 8"):
        attention_probe_gh_mma(q[:1, :, :2], k[:1, :, :2], v[:1, :, :2], 8)


def test_gh_routes_name_their_entries(monkeypatch):
    """On meta tensors, which take the card's route up to the launch, with
    the launcher replaced by a recorder: ``attention_probe_gh`` names
    ``maest_attn_probe_gh`` (the wgmma kernel, G heads a block) with its
    group, counted in ``attention_probe_gh.launches``; its control names
    ``maest_attn_probe_gh_mma``, counted in
    ``attention_probe_gh_mma.launches``; an unknown group is refused before
    any launch, never run on another kernel."""
    from maest_tpu_torch.ops import attention_probe as P

    seen = []

    def record(name, select, q, k, v, n_real, sl):
        seen.append((name, select, n_real, round(sl, 6)))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    monkeypatch.setattr(P, "launch_bf16", record)
    monkeypatch.setattr(P.attention_probe_gh, "launches",
                        dict.fromkeys(GROUPS, 0))
    monkeypatch.setattr(P.attention_probe_gh_mma, "launches",
                        dict.fromkeys(GROUPS, 0))
    x = torch.zeros(2, 300, 4, 64, dtype=torch.bfloat16, device="meta")
    sl = round(64**-0.5 * 1.4426950408889634, 6)
    for g in GROUPS:
        assert P.attention_probe_gh(x, x, x, g, 281).shape == x.shape
        P.attention_probe_gh_mma(x, x, x, g)
    assert seen == [entry for g in GROUPS for entry in (
        ("maest_attn_probe_gh", g, 281, sl),
        ("maest_attn_probe_gh_mma", g, 300, sl))]
    assert P.attention_probe_gh.launches == dict.fromkeys(GROUPS, 1)
    assert P.attention_probe_gh_mma.launches == dict.fromkeys(GROUPS, 1)
    for bad in (3, 16, 0):
        for fn in (P.attention_probe_gh, P.attention_probe_gh_mma):
            with pytest.raises(ValueError, match="group of 1, 2, 4, 8"):
                fn(x, x, x, bad)
    assert len(seen) == 2 * len(GROUPS)


def test_gh_entries_name_their_kernels():
    """The C entries, read from the source: ``maest_attn_probe_gh`` runs K2's
    wgmma kernel (``launch_fwd_wgmma`` with G heads a block) at K2's key
    tile rule, ``maest_attn_probe_gh_mma`` the mma.sync template (FLASH)."""
    src = (ROOT / "maest_tpu_torch" / "csrc" / "attention_probe.cu"
           ).read_text()
    route = src[src.index("int launch_gh_wgmma("):]
    route = route[:route.index("\n}\n")]
    assert "if (wg_key_tile(n_real) == 112)" in route
    assert "launch_fwd_wgmma<112, 3, true, false, G>" in route
    assert "launch_fwd_wgmma<96, 3, true, false, G>" in route
    entry = src[src.index("int maest_attn_probe_gh(int group"):]
    entry = entry[:entry.index("\n}\n")]
    assert all(f"launch_gh_wgmma<{g}>" in entry for g in GROUPS)
    assert "attn_fwd_bf16_kernel" not in entry
    control = src[src.index("int maest_attn_probe_gh_mma(int group"):]
    control = control[:control.index("\n}\n")]
    assert all(f"attn_fwd_bf16_kernel<FLASH, {g}>" in control for g in GROUPS)
    assert "launch_fwd_wgmma" not in control


@pytest.mark.parametrize("b,n,h", [(1, 100, 2), (2, 200, 2), (1, 64, 3)])
def test_int8_matches_tpu_rig_interpret(rig, b, n, h):
    x = _qkv(b, n, h, seed=7 * n + b) * 0.5  # the rig's N(0, 0.5^2)
    q, k, v = (np.ascontiguousarray(x[:, :, i]) for i in range(3))
    want = _tpu_int8(rig, q, k, v)
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    got, l = attention_probe_int8_reference(qt, kt, vt, with_l=True)
    assert torch.equal(attention_probe_int8(qt, kt, vt), got)
    assert got.shape == (b, n, h, 64) and got.dtype == torch.float32
    top = float(np.abs(want).max())
    row_err = np.abs(got.numpy() - want).max(axis=-1)
    row_tol = np.abs(v).max() / (127 * l.numpy()) + 1e-5 * top
    assert (row_err <= row_tol).all(), (row_err.max(), row_tol.min())
    # the rig's output is attention / 127: pinned by the port and the rig
    att = attention_reference(qt, kt, vt).numpy()
    assert np.abs(want * 127 - att).max() <= 1e-2
    assert np.abs(got.numpy() * 127 - att).max() <= 1e-2
    assert 120 < np.abs(att).max() / top < 135


def test_gh_and_int8_on_the_cpu_are_plain_and_count_no_launch():
    x = torch.from_numpy(_qkv(2, 90, 4, seed=5))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    before = (dict(attention_probe_gh.launches), attention_probe_int8.launches)
    for g in GROUPS:
        assert torch.equal(attention_probe_gh(qb, kb, vb, g, 77),
                           attention_probe_gh_reference(qb, kb, vb, g, 77))
    assert torch.equal(attention_probe_int8(q, k, v, 77),
                       attention_probe_int8_reference(q, k, v, 77))
    assert (attention_probe_gh.launches, attention_probe_int8.launches) == before
    # gh is K2's online softmax on the same tiles as bf16s, without its
    # roundings; both are softmax attention
    ref = attention_reference(q, k, v, n_real=77)
    assert (attention_probe_gh(qb, kb, vb, 2, 77).float() - ref).abs().max() < 1e-2
    # keys past n_real change nothing (their values do: v's scale is taken
    # over the whole sequence, as the rig takes it)
    y = x.clone()
    y[:, 77:, 1] = 5.0
    assert torch.equal(attention_probe_int8(q, k, v, 77),
                       attention_probe_int8(y[:, :, 0], y[:, :, 1], y[:, :, 2],
                                            77))


def test_gh_and_int8_reject_what_their_kernels_do_not_take():
    from maest_tpu_torch.ops.attention_probe import int8_rig_pass, launch_int8

    x = torch.zeros(1, 16, 3, 6, 64)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    with pytest.raises(ValueError, match="group of 1, 2, 4, 8"):
        attention_probe_gh(qb, kb, vb, 3)
    with pytest.raises(ValueError, match="not divisible by the group 4"):
        attention_probe_gh(qb, kb, vb, 4)
    with pytest.raises(TypeError, match="bfloat16"):
        attention_probe_gh(q, k, v, 2)
    with pytest.raises(TypeError, match="float32"):
        attention_probe_int8(qb, kb, vb)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        attention_probe_int8(q, k, v, 17)
    y = torch.zeros(1, 16, 3, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        attention_probe_int8(y[:, :, 0], y[:, :, 1], y[:, :, 2])
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        launch_int8(int8_rig_pass(q, k, v))


def test_int8_rig_pass_makes_the_kernels_inputs():
    """The pass's quantization is the rig's: division first, floors at
    1e-6, the folds of /127^2, v transposed in seq_pos order."""
    from maest_tpu_torch.ops.attention import _seq_major
    from maest_tpu_torch.ops.attention_probe import _LOG2E, int8_rig_pass

    x = torch.from_numpy(_qkv(1, 70, 2, seed=6))
    x[0, 3, 0, 1] = 0.0  # an all-zero q row: scale 1e-6, values 0
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    q8, k8, qsl, ks, v8t, vsc = int8_rig_pass(q, k, v)
    qs = q.abs().amax(-1).clamp_min(1e-6)
    assert torch.equal(q8, torch.round(q / qs[..., None] * 127.0).to(torch.int8))
    assert not q8[0, 3, 1].any()
    assert torch.equal(qsl, (qs / 127.0 / 127.0 * (64**-0.5 * _LOG2E))
                       .transpose(1, 2))
    assert torch.equal(ks, k.abs().amax(-1).transpose(1, 2))
    vs = v.abs().amax(1)  # (B, H, 64): over the sequence
    assert torch.equal(vsc, vs / 127.0 / 127.0)
    v8 = torch.round(v / vs[:, None] * 127.0).to(torch.int8)
    assert torch.equal(v8t, _seq_major(v8.transpose(1, 2)))
    assert q8.is_contiguous() and k8.is_contiguous() and v8t.shape == (
        1, 2, 64, 128)
