"""The port's data pipeline against the JAX package's, on the CPU: the
chunk datasets, the sampler and ``BatchLoader`` must give what the JAX
package gives, exactly; the native reader what numpy reads; the CPU
``device_prefetch`` its input as tensors, host entries untouched."""

import pickle

import numpy as np
import pytest
import torch

from maest_tpu import data as jdata
from maest_tpu_torch import data as tdata
from maest_tpu_torch import native

CLIP = 62  # DatasetConfig(clip_length=1): 16000 // 256 frames


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """.mmap and .npy files shorter and longer than a clip, a groundtruth
    of 8 classes and teacher logits for every file."""
    root = tmp_path_factory.mktemp("corpus")
    teacher = tmp_path_factory.mktemp("teacher")
    rng = np.random.default_rng(0)
    gt = {}
    for i, frames in enumerate((30, 61, 62, 63, 150, 400, 40, 200)):
        suffix = ".npy" if i >= 6 else ".mmap"
        name = f"clip{i}{suffix}"
        mel = (rng.standard_normal((frames, 96)) * 1.3 + 2.0).astype("float16")
        if suffix == ".npy":
            np.save(root / name, mel)
        else:
            mel.tofile(root / name)
        y = (rng.random(8) > 0.6).astype("float16")
        y[i % 8] = 1.0
        gt[name] = y
        np.save(teacher / f"{name}.logits.npy",
                rng.standard_normal(8).astype("f4"))
    with open(root / "gt.pk", "wb") as f:
        pickle.dump(gt, f)
    mmap_only = {k: v for k, v in gt.items() if k.endswith(".mmap")}
    with open(root / "gt_mmap.pk", "wb") as f:
        pickle.dump(mmap_only, f)
    return root, teacher


def _pair(cls_name, corpus, gt="gt.pk", **kw):
    root, teacher = corpus
    if cls_name.endswith("TS"):
        kw.update(teacher_target_base_dir=str(teacher),
                  teacher_target_threshold=0.45)
    out = []
    for pkg in (jdata, tdata):
        cfg = pkg.DatasetConfig(clip_length=1)
        out.append(getattr(pkg, cls_name)(root / gt, root, cfg, **kw))
    return out


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("cls_name", ["MelChunkDataset", "MelChunkDatasetTS"])
@pytest.mark.parametrize("seeded", ["rng", "crop_seed"])
def test_chunk_datasets_match_jax(corpus, cls_name, seeded):
    """Random crops from an explicit generator (the same draws in both)
    or per-item crop seeds, on every file: .mmap and .npy, shorter and
    longer than a clip."""
    if seeded == "rng":  # one generator each, seeded alike
        ref = _pair(cls_name, corpus, rng=np.random.default_rng(3))[0]
        ours = _pair(cls_name, corpus, rng=np.random.default_rng(3))[1]
    else:
        ref, ours = _pair(cls_name, corpus, crop_seed=7)
    assert len(ours) == len(ref) == 8
    for _ in range(3):  # three draws per item
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a["x"].shape == (96, CLIP)
            _assert_items_equal(a, b)
    idx = [5, 0, 3]
    _assert_items_equal(ours.targets_for(idx), ref.targets_for(idx))


@pytest.mark.parametrize("cls_name",
                         ["ExhaustiveMelDataset", "ExhaustiveMelDatasetTS"])
@pytest.mark.parametrize("half", [False, True], ids=["hop", "half-overlap"])
def test_exhaustive_datasets_match_jax(corpus, cls_name, half):
    ref, ours = _pair(cls_name, corpus, half_overlapped_inference=half)
    assert ours.entries == ref.entries and len(ours) == len(ref) > 8
    for i in range(len(ref)):
        _assert_items_equal(ours[i], ref[i])
    # a batch with a .npy file takes the per-item path in both
    assert ours.batch_spec(range(len(ours))) is None
    assert ref.batch_spec(range(len(ref))) is None
    ours_m, ref_m = _pair(cls_name, corpus, gt="gt_mmap.pk",
                          half_overlapped_inference=half)
    a, b = ours_m.batch_spec(range(len(ours_m))), ref_m.batch_spec(
        range(len(ref_m)))
    assert a[0] == b[0] and a[1] == b[1]
    for x, y in zip(a[2], b[2]):
        _assert_items_equal(x, y)


@pytest.mark.parametrize("replacement", [False, True],
                         ids=["without-replacement", "with-replacement"])
def test_sampler_matches_jax(corpus, replacement):
    root, _ = corpus
    with open(root / "gt.pk", "rb") as f:
        gt = pickle.load(f)
    names = list(gt)
    for offset, wsum in ((100.0, True), (3.0, False)):
        w = tdata.class_balanced_weights_streaming(gt, names, offset, wsum,
                                                   chunk_size=3)
        ref = jdata.class_balanced_weights_streaming(gt, names, offset, wsum,
                                                     chunk_size=3)
        np.testing.assert_array_equal(w, ref)
        np.testing.assert_array_equal(
            tdata.class_balanced_weights(np.stack(list(gt.values())), offset,
                                         wsum), ref)
        for epoch in range(3):
            a = tdata.weighted_epoch_indices(w, 6, seed=4, epoch=epoch,
                                             replacement=replacement)
            b = jdata.weighted_epoch_indices(ref, 6, seed=4, epoch=epoch,
                                             replacement=replacement)
            assert len(a) == 6
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_batch_loader_matches_jax(corpus, use_native):
    """Whole batches (the native batch read where every item is .mmap),
    with a ragged last batch kept or dropped."""
    for gt in ("gt.pk", "gt_mmap.pk"):
        ref_ds, ours_ds = _pair("ExhaustiveMelDataset", corpus, gt=gt)
        for drop_last in (False, True):
            ref = list(jdata.BatchLoader(ref_ds, 4, num_workers=2,
                                         drop_last=drop_last,
                                         use_native=use_native))
            ours = list(tdata.BatchLoader(ours_ds, 4, num_workers=2,
                                          drop_last=drop_last,
                                          use_native=use_native))
            assert len(ours) == len(ref) > 1
            for a, b in zip(ours, ref):
                _assert_items_equal(a, b)
                assert a["x"].shape[1:] == (96, CLIP)


def test_native_chunks_equal_the_numpy_read(corpus, monkeypatch):
    """The port's C++ reader (built with g++ into build/maest_tpu_torch/
    native) against numpy's memmap read and center pad, at offsets inside
    the file and past its end."""
    assert native.available()
    root, _ = corpus
    ds = tdata.MelChunkDataset(root / "gt_mmap.pk", root,
                               tdata.DatasetConfig(clip_length=1))
    cases = []
    for name in ds.filenames:
        path = root / name
        frames = ds._file_frames(path)
        assert native.file_frames(str(path)) == frames
        for offset in sorted({0, max(frames - CLIP, 0), max(frames - 10, 0)}):
            cases.append((path, offset, frames))
    ours = [ds._read_chunk(p, o, f) for p, o, f in cases]
    batch = native.load_batch([str(p) for p, _, _ in cases],
                              [o for _, o, _ in cases], CLIP, threads=3)
    monkeypatch.setattr(native, "available", lambda: False)
    ref = [ds._read_chunk(p, o, f) for p, o, f in cases]
    for (p, o, _), a, b, c in zip(cases, ours, ref, batch):
        np.testing.assert_array_equal(a, b, err_msg=f"{p.name} at {o}")
        np.testing.assert_array_equal(c, b, err_msg=f"{p.name} at {o}")
    with pytest.raises(RuntimeError, match="failed to read 1 of 2"):
        native.load_batch([str(cases[0][0]), str(root / "missing.mmap")],
                          [0, 0], CLIP)


def test_cpu_device_prefetch_passes_batches_through(corpus):
    """On the CPU the arrays under ``keys`` become tensors equal to them;
    filenames and ``_n`` pass through; an early break unwinds cleanly."""
    _, ds = _pair("ExhaustiveMelDataset", corpus, gt="gt_mmap.pk")
    batches = list(tdata.BatchLoader(ds, 3, num_workers=1))
    for b in batches:
        b["_n"] = len(b["filename"])
    out = list(tdata.device_prefetch(iter(batches), "cpu", keys=("x", "y")))
    assert len(out) == len(batches)
    for a, b in zip(out, batches):
        assert a.keys() == b.keys()
        for k in ("x", "y"):
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])
        assert a["filename"] == b["filename"] and a["_n"] == b["_n"]
    only_x = next(tdata.device_prefetch(iter(batches), "cpu", keys=("x",)))
    assert isinstance(only_x["x"], torch.Tensor)
    assert isinstance(only_x["y"], np.ndarray)
    gen = tdata.device_prefetch(tdata.BatchLoader(ds, 1).iter_indices(
        range(len(ds))), "cpu")
    next(gen)
    gen.close()
