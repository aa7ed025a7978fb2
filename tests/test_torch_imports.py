"""The PyTorch port imports no JAX, and shares its framework-free tables
(architectures, labels, mel filterbank) with the JAX package."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np

import maest_tpu_torch
from maest_tpu import labels as jax_labels
from maest_tpu.dsp import filterbank as jax_fb
from maest_tpu.models import registry as jax_registry
from maest_tpu_torch.dsp import filterbank as torch_fb

ROOT = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = ("import sys, maest_tpu_torch, maest_tpu_torch.serve, "
            "maest_tpu_torch.apps.serve; "
            "print(sorted(m for m in ('jax', 'jaxlib', 'flax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_archs_match():
    assert set(maest_tpu_torch.ARCHS) == set(jax_registry.ARCHS)
    for name, spec in jax_registry.ARCHS.items():
        ours = maest_tpu_torch.ARCHS[name]
        assert (ours.url, ours.num_classes, ours.default_input_t, ours.kind) == (
            spec.url, spec.num_classes, spec.default_input_t, spec.kind)
    assert maest_tpu_torch.list_architectures() == jax_registry.list_architectures()
    cfg = maest_tpu_torch.build_config("discogs-maest-30s-pw-129e")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_registry.build_config("discogs-maest-30s-pw-129e"))
    assert cfg.img_size == (96, 1875) and cfg.num_classes == 400


def test_labels_match():
    for n in (400, 519):
        assert maest_tpu_torch.labels_for(n) == jax_labels.labels_for(n)
        assert len(maest_tpu_torch.labels_for(n)) == n
    assert maest_tpu_torch.labels_for(16) is None


def test_filterbank_matches():
    ours, ref = torch_fb.mel_filterbank(), jax_fb.mel_filterbank()
    assert ours.shape == (257, 96)
    np.testing.assert_array_equal(ours, ref)
    for a, b in zip(torch_fb.dft_matrices(512), jax_fb.dft_matrices(512)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(torch_fb.hann_window(512),
                                  jax_fb.hann_window(512))
