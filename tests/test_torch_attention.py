"""Attention forward of the PyTorch port against the JAX package's Pallas
flash kernel, run in interpret mode on the CPU.

Tolerances: fp32 atol 2e-5 (two fp32 softmax pipelines that sum in other
orders); bf16 atol 2e-2, compared in fp32 (bf16 keeps 8 mantissa bits, so
the probabilities and the output each round at ~4e-3 relative).

On the CPU the port's wrapper runs its plain version;
tests/test_torch_cuda.py holds the kernel to it on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maest_tpu.ops.attention import flash_attention as jax_flash
from maest_tpu_torch.ops.attention import attention_reference, flash_attention

ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(b, n, h, d=64, seed=0):
    """One fused (B, N, 3, H, D) projection; the tests slice q, k, v out of
    it as strided views, the layout the model hands over."""
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3, h, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,n_real", [(200, None), (256, 190)],
                         ids=["n200", "n256_real190"])
def test_matches_jax_flash_interpret(n, n_real, dtype):
    x = _qkv(2, n, 2)
    xt = torch.from_numpy(x).to(dtype)
    ours = flash_attention(xt[:, :, 0], xt[:, :, 1], xt[:, :, 2],
                           n_real=n_real)
    xj = jnp.asarray(x).astype(JNP[dtype])
    ref = jax_flash(xj[:, :, 0], xj[:, :, 1], xj[:, :, 2], n_real=n_real,
                    interpret=True)
    assert ours.shape == (2, n, 2, 64) and ours.dtype == dtype
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[dtype], rtol=0)


def test_masked_keys_get_no_mass():
    """n_real=40 of 64 keys: every query row (padded ones included) sees
    exactly the first 40 keys."""
    x = torch.from_numpy(_qkv(1, 64, 2, seed=1)).double()
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k[:, :40]) / 8.0, -1)
    expect = torch.einsum("bhnm,bmhd->bnhd", p, v[:, :40])
    out = flash_attention(q.float(), k.float(), v.float(), n_real=40)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), atol=2e-6)


def test_api_errors():
    x = torch.from_numpy(_qkv(1, 16, 1))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    # "none" is the config-file spelling of off
    torch.testing.assert_close(flash_attention(q, k, v, quant="none"),
                               flash_attention(q, k, v))
    with pytest.raises(ValueError, match="unknown attention quant"):
        flash_attention(q, k, v, quant="int4")
    for mode in ("qk8", "qk8pv8", "fp8", "fp8pv8"):
        with pytest.raises(NotImplementedError, match="K5|K6"):
            flash_attention(q, k, v, quant=mode)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        flash_attention(q, k, v, n_real=17)
    with pytest.raises(ValueError, match="at least 1"):
        flash_attention(q, k, v, n_real=0)
    with pytest.raises(ValueError, match="one .B, N, H, D. shape"):
        flash_attention(q, k[:, :8], v)


def test_cpu_takes_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_qkv(2, 50, 3))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = flash_attention.launches
    out = flash_attention(q, k, v, n_real=33)
    assert flash_attention.launches == before
    assert torch.equal(out, attention_reference(q, k, v, n_real=33))
