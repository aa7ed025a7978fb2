"""``get_maest`` of the PyTorch port against the JAX package's, both built
from one checkpoint file at a tiny geometry (embed 64, depth 2, 4 heads,
62-frame windows, 16 classes). Every input rank, int16 PCM, multi-chunk
audio, the checkpoint layouts and the error cases. Activations agree to
atol 1e-4 (fp32 tier on both sides)."""

import numpy as np
import pytest
import torch

from maest_tpu.api import get_maest as jax_get_maest
from maest_tpu.models.registry import build_config
from maest_tpu_torch.api import get_maest

from torch_oracle import make_state

ARCH = "discogs-maest-30s-pw-129e"
TINY = dict(embed_dim=64, depth=2, num_heads=4, n_classes=16)
SR = 16000
ATOL = 1e-4


def _save(path, state):
    torch.save(state, path)
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = build_config(ARCH, input_t=62, **TINY)
    state = make_state(np.random.default_rng(3), cfg, scale=0.1)
    return _save(tmp_path_factory.mktemp("ckpt") / "tiny.pt", state)


@pytest.fixture(scope="module")
def models(ckpt):
    kw = dict(pretrained=False, checkpoint=ckpt, input_t=62, **TINY)
    return get_maest(ARCH, device="cpu", **kw), jax_get_maest(ARCH, **kw)


def _wave(seconds, seed=0):
    return np.random.default_rng(seed).standard_normal(
        int(seconds * SR)).astype(np.float32) * 0.3


def _acts_close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kind", ["wave_1chunk", "wave_3chunks", "wave_short",
                                  "wave_batch", "mel_2d", "mel_3d", "mel_4d"])
def test_input_ranks(models, kind):
    ours, ref = models
    rng = np.random.default_rng(4)
    x, kw = {
        "wave_1chunk": (_wave(1.0), {}),
        "wave_3chunks": (_wave(3.3, seed=1), {}),
        "wave_short": (_wave(0.6, seed=2), {}),
        "wave_batch": (np.stack([_wave(62 * 256 / SR, seed=s)
                                 for s in (3, 4)]), {}),
        "mel_2d": (rng.standard_normal((96, 200)).astype("f4"),
                   {"melspectrogram_input": True}),
        "mel_3d": (rng.standard_normal((2, 96, 62)).astype("f4"), {}),
        "mel_4d": (rng.standard_normal((2, 1, 96, 62)).astype("f4"), {}),
    }[kind]
    lo, fo = ours(x, **kw)
    lr, fr = ref(x, **kw)
    assert tuple(lo.shape) == lr.shape and tuple(fo.shape) == fr.shape
    _acts_close(lo, lr)
    _acts_close(fo, fr)
    if not kw:
        acts, labels = ours.predict_labels(x)
        racts, rlabels = ref.predict_labels(x)
        assert acts.shape == (16,) and acts.dtype == np.float32
        assert labels is None and rlabels is None
        _acts_close(acts, racts)


def test_int16_pcm_and_embedding_tap(models):
    ours, ref = models
    pcm = (np.clip(_wave(2.2, seed=5), -1, 1) * 32767).astype(np.int16)
    _acts_close(ours.predict_labels(pcm)[0], ref.predict_labels(pcm)[0])
    _acts_close(ours.predict_labels(pcm)[0],
                ours.predict_labels(pcm.astype(np.float32) / 32768.0)[0])
    wave = _wave(1.0, seed=6)
    for block, attn in ((0, False), (1, True)):
        _acts_close(
            ours(wave, transformer_block=block, return_self_attention=attn)[1],
            ref(wave, transformer_block=block, return_self_attention=attn)[1])
    _acts_close(ours.forward(wave)[0], ref.forward(wave)[0])


def test_melspectrogram_and_chunking(models):
    ours, ref = models
    wave = _wave(2.5, seed=7)
    mel = ours.melspectrogram(wave)
    _acts_close(mel, ref.melspectrogram(wave))
    chunks = ours._chunk_melspec(mel)
    assert tuple(chunks.shape) == (2, 1, 96, 62)  # the remainder is trimmed
    _acts_close(chunks, ref._chunk_melspec(ref.melspectrogram(wave)))


def test_errors(models):
    ours, _ = models
    with pytest.raises(ValueError, match="empty"):
        ours(np.zeros(0, np.float32))
    with pytest.raises(TypeError, match="ambiguous"):
        ours(np.zeros(20000, np.int32))
    with pytest.raises(TypeError, match="array"):
        ours([0.0] * 20000)
    with pytest.raises(ValueError, match="melspectrogram_input"):
        ours(_wave(1.0), melspectrogram_input=True)
    with pytest.raises(ValueError, match="rank"):
        ours(np.zeros((1, 1, 1, 96, 62), np.float32))


def test_pretrained_needs_cached_file(tmp_path, monkeypatch):
    # offline: a missing release is fetched on first use otherwise
    monkeypatch.setenv("MAEST_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("MAEST_TPU_OFFLINE", "1")
    with pytest.raises(FileNotFoundError, match="discogs-maest-30s-pw-129e"):
        get_maest(ARCH, pretrained=True, device="cpu", **TINY)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        get_maest(ARCH, pretrained=False, device="cuda", **TINY)


def test_checkpoint_layouts(tmp_path):
    """Lightning net./net_swa. prefixes (SWA by default), .safetensors, a
    time-grid retarget and a head of another size, each as the JAX
    package loads it."""
    cfg = build_config(ARCH, input_t=62, **TINY)
    rng = np.random.default_rng(8)
    live, swa = make_state(rng, cfg, 0.1), make_state(rng, cfg, 0.1)
    lightning = {**{"net." + k: v for k, v in live.items()},
                 **{"net_swa." + k: v for k, v in swa.items()}}
    path = _save(tmp_path / "lightning.ckpt", {"state_dict": lightning})
    wave = _wave(1.0, seed=9)
    for kw in ({}, {"checkpoint_swa_weights": False}, {"input_t": 80},
               {"n_classes": 8, "checkpoint_discard_head": True}):
        args = dict(pretrained=False, checkpoint=path, **{**TINY, "input_t": 62,
                                                          **kw})
        ours = get_maest(ARCH, device="cpu", **args)
        ref = jax_get_maest(ARCH, **args)
        _acts_close(ours(wave)[1], ref(wave)[1])
        if "n_classes" not in kw:
            _acts_close(ours(wave)[0], ref(wave)[0])

    from safetensors.torch import save_file

    st = str(tmp_path / "swa.safetensors")
    save_file({k: v.contiguous() for k, v in swa.items()}, st)
    a = get_maest(ARCH, pretrained=False, checkpoint=st, device="cpu",
                  input_t=62, **TINY)
    b = get_maest(ARCH, pretrained=False, checkpoint=path, device="cpu",
                  input_t=62, **TINY)
    torch.testing.assert_close(a(wave)[0], b(wave)[0], rtol=0, atol=0)
