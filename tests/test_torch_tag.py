"""The port's tagging CLI and its audio loader against the JAX package's.

``maest_tpu_torch.apps.tag`` and ``maest_tpu.apps.tag`` tag the same wav
files (16 kHz and 44.1 kHz, 3 s and 2.5 s) from one checkpoint that JAX's
``jax_to_torch_state`` writes, at a tiny geometry (embed 64, depth 2, 2
heads, 62-frame windows), fp32: the same ranked labels, activations within
1e-4 (the JSON rounds them to 4 decimals), embeddings within 1e-4, a
repeated basename suffixed ``.1`` by both. ``--devices 2`` (two gloo ranks
on the CPU) against ``--devices 1``. The loader, the resample and the
numpy log-mel are scipy and numpy on both sides: equal bit for bit, and so
is ``extract_one``'s ``.mmap``.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from maest_tpu.apps import extract_mel as jax_extract
from maest_tpu.apps.tag import main as jax_main
from maest_tpu.dsp.mel import log_mel_spectrogram_np as jax_mel_np
from maest_tpu.models.registry import build_config
from maest_tpu.models.vit import init_params
from maest_tpu.packaging.hf_ast import jax_to_torch_state
from maest_tpu_torch.apps import extract_mel
from maest_tpu_torch.apps.tag import main
from maest_tpu_torch.dsp import log_mel_spectrogram_np

ARCH = "discogs-maest-30s-pw-129e"
TINY = ["--embed-dim", "64", "--depth", "2", "--num-heads", "2",
        "--input-t", "62"]
ATOL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-written checkpoint (heads drawn, so activations differ) and
    three wavs: 3 s at 16 kHz, 2.5 s at 44.1 kHz, and the first again
    under the same basename in another directory."""
    root = tmp_path_factory.mktemp("tag")
    cfg = build_config(ARCH, embed_dim=64, depth=2, num_heads=2, input_t=62)
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    params["head_linear"]["kernel"] = rng.standard_normal(
        params["head_linear"]["kernel"].shape).astype("f4") * 0.5
    state = jax_to_torch_state(params, cfg)
    ckpt = root / "tiny.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
               ckpt)
    a, b = root / "a.wav", root / "b.wav"
    wavfile.write(a, 16000,
                  (rng.standard_normal(3 * 16000) * 8000).astype(np.int16))
    wavfile.write(b, 44100, (rng.standard_normal(int(2.5 * 44100))
                             * 0.3).astype(np.float32))
    (root / "other").mkdir()
    again = root / "other" / "a.wav"
    shutil.copy(a, again)
    return {"ckpt": str(ckpt), "wavs": [str(a), str(b), str(again)]}


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.strip().splitlines()]


def _tags_close(ours: list[dict], ref: list[dict]):
    assert [o["file"] for o in ours] == [r["file"] for r in ref]
    for o, r in zip(ours, ref):
        assert list(o["tags"]) == list(r["tags"])
        np.testing.assert_allclose(list(o["tags"].values()),
                                   list(r["tags"].values()), atol=ATOL + 1e-9)


def test_json_matches_jax(files, capsys):
    args = files["wavs"][:2] + ["--checkpoint", files["ckpt"], "--json",
                                "--top-k", "8"] + TINY
    assert jax_main(args) == 0
    ref = _json_lines(capsys.readouterr().out)
    assert main(args + ["--device", "cpu"]) == 0
    ours = _json_lines(capsys.readouterr().out)
    assert len(ours) == 2 and all(len(o["tags"]) == 8 for o in ours)
    _tags_close(ours, ref)
    assert main(files["wavs"][:1] + ["--checkpoint", files["ckpt"], "--top-k",
                                     "2", "--device", "cpu"] + TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == files["wavs"][0] and len(lines) == 3
    assert lines[1].split(None, 1)[1] == list(ours[0]["tags"])[0]


def test_embeddings_match_jax(files, tmp_path, capsys):
    args = files["wavs"] + ["--checkpoint", files["ckpt"], "--block", "1"]
    assert jax_main(args + ["--embeddings-dir", str(tmp_path / "jax")]
                    + TINY) == 0
    assert main(args + ["--embeddings-dir", str(tmp_path / "torch"),
                        "--device", "cpu"] + TINY) == 0
    out = capsys.readouterr().out
    assert "a.1.embeddings.npy" in out
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == ["a.1.embeddings.npy", "a.embeddings.npy",
                     "b.embeddings.npy"]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for n in names:
        ours = np.load(tmp_path / "torch" / n)
        ref = np.load(tmp_path / "jax" / n)
        assert ours.shape == ref.shape and ours.shape[1] == 3 * 64
        np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_array_equal(
        np.load(tmp_path / "torch" / "a.embeddings.npy"),
        np.load(tmp_path / "torch" / "a.1.embeddings.npy"))


def test_two_ranks_match_one(files, tmp_path, capsys):
    """``--devices 2``: two gloo ranks on the CPU, each file's chunks
    split over them; rank 0 alone prints and writes."""
    args = files["wavs"][:2] + ["--checkpoint", files["ckpt"], "--json",
                                "--top-k", "8", "--device", "cpu"] + TINY
    assert main(args) == 0
    one = _json_lines(capsys.readouterr().out)
    assert main(args + ["--devices", "2"]) == 0
    two = _json_lines(capsys.readouterr().out)
    _tags_close(two, one)
    emb = files["wavs"][:2] + ["--checkpoint", files["ckpt"], "--block", "0",
                               "--device", "cpu"] + TINY
    assert main(emb + ["--embeddings-dir", str(tmp_path / "one")]) == 0
    assert main(emb + ["--embeddings-dir", str(tmp_path / "two"),
                       "--devices", "2"]) == 0
    for n in ("a.embeddings.npy", "b.embeddings.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "two" / n),
                                   np.load(tmp_path / "one" / n), atol=1e-5)


def test_load_audio_and_resample_match_jax(files, tmp_path):
    for path in files["wavs"][:2]:
        ours = extract_mel.load_audio(Path(path))
        ref = jax_extract.load_audio(Path(path))
        assert ours.dtype == np.float32 and ours.ndim == 1
        np.testing.assert_array_equal(ours, ref)
    x = np.random.default_rng(3).standard_normal(22050).astype(np.float32)
    for sr in (44100, 22050, 16000, 8000):
        np.testing.assert_array_equal(extract_mel._resample(x, sr),
                                      jax_extract._resample(x, sr))
    stereo = np.random.default_rng(4).standard_normal((400, 2)).astype("f4")
    np.save(tmp_path / "s.npy", stereo)
    np.testing.assert_array_equal(
        extract_mel.load_audio(tmp_path / "s.npy"),
        jax_extract.load_audio(tmp_path / "s.npy"))


def test_compressed_audio_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    (tmp_path / "x.mp3").write_bytes(b"\0" * 16)
    with pytest.raises(RuntimeError) as ours:
        extract_mel.load_audio(tmp_path / "x.mp3")
    with pytest.raises(RuntimeError) as ref:
        jax_extract.load_audio(tmp_path / "x.mp3")
    assert str(ours.value) == str(ref.value)
    assert "ffmpeg" in str(ours.value)


def test_numpy_mel_matches_jax():
    rng = np.random.default_rng(5)
    for x in (rng.standard_normal(16000).astype("f4"),
              rng.standard_normal((2, 5000)).astype("f4")):
        for normalize in (True, False):
            ours = log_mel_spectrogram_np(x, normalize=normalize)
            assert ours.dtype == np.float32
            assert np.array_equal(ours, jax_mel_np(x, normalize=normalize))


def test_extract_one_matches_jax(files, tmp_path):
    for path in files["wavs"][:2]:
        ours = extract_mel.extract_one(path, str(tmp_path / "torch"))
        ref = jax_extract.extract_one(path, str(tmp_path / "jax"))
        assert Path(ours).name == Path(ref).name
        assert Path(ours).read_bytes() == Path(ref).read_bytes()
    assert (extract_mel.output_names(files["wavs"])
            == jax_extract.output_names(files["wavs"]))
    extract_mel.main([files["wavs"][1], "--out-dir", str(tmp_path / "cli"),
                      "--workers", "1"])
    assert ((tmp_path / "cli" / "b.mmap").read_bytes()
            == (tmp_path / "jax" / "b.mmap").read_bytes())
    with pytest.raises(ValueError, match="duplicate"):
        extract_mel.output_names([files["wavs"][0], files["wavs"][0]])
