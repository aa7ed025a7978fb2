"""Checkpoints of the PyTorch port against the JAX package: HF AST (hub)
layout files and the release fetch.

``from_hf_ast_state`` inverts the state JAX's ``to_hf_ast_state`` writes,
equal to JAX's own inverse bit for bit; ``get_maest`` on an AST ``.pt``
(also a 30 s export loaded into a 10 s config, whose time table is then
resized) gives JAX ``get_maest``'s logits on the same file within 1e-4 at
a tiny geometry (embed 64, depth 2, 4 heads, 16 classes, fp32).
``fetch_checkpoint`` and ``get_maest(pretrained=True)`` fetch from
``file://`` URLs into a temporary ``MAEST_TPU_CACHE``.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from maest_tpu.api import get_maest as jax_get_maest
from maest_tpu.models import registry as jax_registry
from maest_tpu.models.vit import init_params
from maest_tpu.packaging import hf_ast as jax_hf
from maest_tpu_torch.api import get_maest
from maest_tpu_torch.checkpoints import normalize_state
from maest_tpu_torch.checkpoints.fetch import FetchError, fetch_checkpoint
from maest_tpu_torch.models import registry
from maest_tpu_torch.packaging import from_hf_ast_state, to_hf_ast_state

ARCH = "discogs-maest-30s-pw-129e"
ARCH_10S = "discogs-maest-10s-pw-129e"
TINY = dict(embed_dim=64, depth=2, num_heads=4, n_classes=16)
ATOL = 1e-4


def _jax_state(arch, seed, **geom):
    """A JAX-initialised tiny model's torch-layout state, heads drawn."""
    cfg = jax_registry.build_config(arch, **TINY, **geom)
    params = jax.tree.map(np.asarray,
                          init_params(cfg, jax.random.PRNGKey(seed)))
    params["head_linear"]["kernel"] = np.random.default_rng(seed).normal(
        0.0, 0.5, params["head_linear"]["kernel"].shape).astype("f4")
    return jax_hf.jax_to_torch_state(params, cfg)


def _save(path, state):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
               path)
    return str(path)


def _wave(seconds, seed):
    return np.random.default_rng(seed).standard_normal(
        int(seconds * 16000)).astype(np.float32) * 0.3


@pytest.fixture(scope="module")
def ast_ckpt(tmp_path_factory):
    state = _jax_state(ARCH, 11, input_t=62)
    ast = jax_hf.to_hf_ast_state(state)
    return _save(tmp_path_factory.mktemp("ast") / "ast.pt", ast), state, ast


def test_from_hf_ast_state_equals_jax(ast_ckpt):
    _, state, ast = ast_ckpt
    cfg = registry.build_config(ARCH, input_t=62, **TINY)
    ours = from_hf_ast_state(ast, cfg)
    ref = jax_hf.from_hf_ast_state(
        ast, jax_registry.build_config(ARCH, input_t=62, **TINY))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k],
                                                                ref[k]), k
    # the round trip: the decoupled tables' sum back within fp32 rounding
    # (freq + c and time - c export alike), every other tensor exactly
    def joint(sd):
        return (np.asarray(sd["freq_new_pos_embed"])
                + np.asarray(sd["time_new_pos_embed"]))

    np.testing.assert_allclose(joint(ours), joint(state), atol=1e-6)
    for k in state:
        if "pos_embed" not in k and k in ours:
            assert np.array_equal(ours[k], np.asarray(state[k])), k
    back = to_hf_ast_state(ours)
    assert sorted(back) == sorted(ast)
    for k in ast:
        np.testing.assert_allclose(back[k], ast[k], atol=1e-6)
    routed = normalize_state(ast, cfg, swa_weights=True)
    assert all(np.array_equal(routed[k], ours[k]) for k in ours)


@pytest.mark.parametrize("arch,input_t", [(ARCH, 62), (ARCH_10S, None)])
def test_get_maest_on_ast_checkpoint(ast_ckpt, tmp_path, arch, input_t):
    """The 30 s export at its own geometry, and into the 10 s config (its
    default 626 frames: 62 time patches from the export's 5)."""
    path, _, _ = ast_ckpt
    kw = dict(pretrained=False, checkpoint=path, input_t=input_t, **TINY)
    ours = get_maest(arch, device="cpu", **kw)
    ref = jax_get_maest(arch, **kw)
    wave = _wave(3.3 if input_t else 10.5, 12)
    lo, fo = ours(wave)
    lr, fr = ref(wave)
    np.testing.assert_allclose(lo.numpy(), np.asarray(lr), atol=ATOL)
    np.testing.assert_allclose(fo.numpy(), np.asarray(fr), atol=ATOL)
    assert float(lo.std()) > 0.1  # the drawn head, not zeros


@pytest.fixture()
def file_specs(tmp_path, monkeypatch):
    """The 30 s arch's release as a ``file://`` URL (net_swa.-prefixed
    Lightning layout) in both packages' registries; a fresh cache."""
    monkeypatch.setenv("MAEST_TPU_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("MAEST_TPU_OFFLINE", raising=False)
    state = _jax_state(ARCH, 13)
    src = tmp_path / "release.ckpt"
    torch.save({"state_dict": {"net_swa." + k: torch.from_numpy(np.array(v))
                               for k, v in state.items()}}, src)
    spec = dataclasses.replace(registry.ARCHS[ARCH], url=src.as_uri())
    monkeypatch.setitem(registry.ARCHS, ARCH, spec)
    monkeypatch.setitem(jax_registry.ARCHS, ARCH, dataclasses.replace(
        jax_registry.ARCHS[ARCH], url=src.as_uri()))
    return spec


def test_fetch_commits_into_cache(file_specs):
    dest = fetch_checkpoint(file_specs)
    assert dest == registry.cached_checkpoint_path(file_specs)
    assert dest.read_bytes() == open(file_specs.url[len("file://"):],
                                     "rb").read()
    assert list(dest.parent.glob("*.tmp.*")) == []
    broken = dataclasses.replace(file_specs, url="file:///nonexistent/x.ckpt")
    assert fetch_checkpoint(broken, dest=dest) == dest  # it is there: no fetch


def test_fetch_refusals_commit_nothing(file_specs, monkeypatch):
    wrong = dataclasses.replace(file_specs, sha256="0" * 64)
    with pytest.raises(FetchError, match="digest mismatch"):
        fetch_checkpoint(wrong)
    dest = registry.cached_checkpoint_path(file_specs)
    assert not dest.exists() and list(dest.parent.glob("*")) == []
    import hashlib

    good = hashlib.sha256(open(file_specs.url[len("file://"):], "rb").read())
    fetch_checkpoint(dataclasses.replace(file_specs, sha256=good.hexdigest()))
    assert dest.exists()
    dest.unlink()
    with pytest.raises(FetchError, match="failed to download"):
        fetch_checkpoint(dataclasses.replace(
            file_specs, url="file:///nonexistent/x.ckpt"))
    monkeypatch.setenv("MAEST_TPU_OFFLINE", "1")
    with pytest.raises(FetchError, match="MAEST_TPU_OFFLINE"):
        fetch_checkpoint(file_specs)
    assert list(dest.parent.glob("*")) == []


def test_concurrent_fetches_both_land(file_specs):
    results, errors = [], []

    def fetch():
        try:
            results.append(fetch_checkpoint(file_specs))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=fetch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    dest = registry.cached_checkpoint_path(file_specs)
    assert results == [dest, dest]
    assert list(dest.parent.glob("*.tmp.*")) == []


def test_get_maest_pretrained_fetches(file_specs):
    ours = get_maest(ARCH, pretrained=True, device="cpu", **TINY)
    assert registry.cached_checkpoint_path(file_specs).exists()
    ref = jax_get_maest(ARCH, pretrained=True, **TINY)
    wave = _wave(30.0, 14)
    np.testing.assert_allclose(ours(wave)[0].numpy(), np.asarray(ref(wave)[0]),
                               atol=ATOL)


def test_get_maest_pretrained_offline_raises(file_specs, monkeypatch):
    monkeypatch.setenv("MAEST_TPU_OFFLINE", "1")
    with pytest.raises(FileNotFoundError, match="auto-download"):
        get_maest(ARCH, pretrained=True, device="cpu", **TINY)
