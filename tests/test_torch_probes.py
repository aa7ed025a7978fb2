"""The attention-decomposition variants of the port (``ops/attention_probe.py``,
``probes/attn_profile.py``) against the TPU rig they port,
``scripts/attn_profile_r2.py``, whose Pallas kernels run here in interpret
mode on the CPU, built as its ``time_variant`` builds them (grid (B*H, 1),
q pre-scaled for bf16s), with the port's 64-key tile as ``block_k``.

Tolerance: two bf16 ulps of the largest |o|. Both sides round one fp32
output to bf16, and their fp32 values differ only by sums taken in other
orders (and XLA's exp2 against PyTorch's, a few fp32 ulps), so an element
may round one ulp apart, never two.

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

from maest_tpu_torch.ops.attention import attention_reference, flash_attention
from maest_tpu_torch.ops.attention_probe import (
    BLOCK_K,
    VARIANTS,
    attention_probe,
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


def _tpu_variant(rig, variant, x):
    """The rig's Pallas kernel for ``variant`` on bf16 x (B, N, 3, H, 64),
    n_real = N, keys padded to a multiple of 128, one q block per head."""
    from jax.experimental import pallas as pl

    A = rig.A
    b, n, _, h, d = x.shape
    n_pad = -(-n // 128) * 128
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    qf, kf, vf = A._flatten_pad(n_pad, xj[:, :, 0], xj[:, :, 1], xj[:, :, 2])
    if variant in rig.PREFOLD_SCALE:
        qf = (qf.astype(jnp.float32) * (d**-0.5 * A._LOG2E)).astype(qf.dtype)
    kt = jnp.swapaxes(kf, 1, 2)
    (out,) = pl.pallas_call(
        functools.partial(rig.KERNELS[variant], scale=d**-0.5, n_real=n,
                          block_k=BLOCK_K),
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
    want = _tpu_variant(rig, variant, x)
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


@pytest.mark.parametrize("variant", ["gh8", "int8"])
def test_rig_refuses_the_kernels_not_ported(variant):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
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
