"""MagnaTagATune (MTT) dataset preparation, port of
``maest_tpu/apps/mtt_prepare.py`` (the mels decoded by the port's
``apps/extract_mel.py``).

Equivalent of the reference's MTT pipeline (reference:
datasets/mtt/preprocess.py:19-94): download the three split zips, join +
extract, decode every clip to a mel ``.mmap`` via ``extract_mel``, and build
the groundtruth pickles (``groundtruth-{train,validation,test,all}.pk``:
dict filename -> multi-hot numpy array over the top-50 tags, plus a
binarizer object ``ohe.pk``) consumed by the data pipeline and the
transfer-learning probe.

Downloading needs the network: where there is none, place the files
under ``--root`` and pass ``--skip-download``.

Usage:
    python -m maest_tpu_torch.apps.mtt_prepare --root /data/mtt [--skip-download]
"""

from __future__ import annotations

import argparse
import csv
import pickle
import subprocess
import sys
import zipfile
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

MTT_BASE = "https://mirg.city.ac.uk/datasets/magnatagatune"
MTT_ZIPS = ["mp3.zip.001", "mp3.zip.002", "mp3.zip.003"]
MTT_ANNOTATIONS = "annotations_final.csv"
N_TAGS = 50

# canonical MTT split by top-level directory hex digit
# (0..b train / c validation / d..f test — the split used by the probe the
# reference evaluates against)
_VAL_DIRS = {"c"}
_TEST_DIRS = {"d", "e", "f"}


class MultiHotBinarizer:
    """Minimal stand-in for the pickled sklearn MultiLabelBinarizer
    (reference ships ``datasets/mtt/ohe.pk``)."""

    def __init__(self, classes):
        self.classes_ = list(classes)
        self._index = {c: i for i, c in enumerate(self.classes_)}

    def transform(self, rows):
        out = np.zeros((len(rows), len(self.classes_)), dtype=bool)
        for i, labels in enumerate(rows):
            for l in labels:
                j = self._index.get(l)
                if j is not None:
                    out[i, j] = True
        return out

    def inverse_transform(self, matrix):
        return [
            tuple(c for c, m in zip(self.classes_, row) if m) for row in matrix
        ]


def download(root: Path):
    import urllib.request

    root.mkdir(parents=True, exist_ok=True)
    for name in MTT_ZIPS + [MTT_ANNOTATIONS]:
        dest = root / name
        if dest.exists():
            continue
        url = f"{MTT_BASE}/{name}"
        print(f"downloading {url}")
        urllib.request.urlretrieve(url, dest)


def extract_zips(root: Path):
    joined = root / "mp3_all.zip"
    if not joined.exists():
        with open(joined, "wb") as out:
            for name in MTT_ZIPS:
                with open(root / name, "rb") as part:
                    out.write(part.read())
    audio_dir = root / "audio"
    if not audio_dir.exists():
        with zipfile.ZipFile(joined) as zf:
            zf.extractall(audio_dir)
    return audio_dir


def read_annotations(csv_path: Path):
    """Returns (clip rows, top-50 tag list). Rows: (mp3_path, [tags])."""
    with open(csv_path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        tag_names = header[1:-1]  # clip_id ... mp3_path
        counts = np.zeros(len(tag_names), dtype=np.int64)
        rows = []
        for row in reader:
            flags = np.array([v == "1" for v in row[1:-1]], dtype=bool)
            counts += flags
            rows.append((row[-1], flags))
    top = np.argsort(-counts)[:N_TAGS]
    top_tags = [tag_names[i] for i in top]
    out = []
    for path, flags in rows:
        labels = [tag_names[i] for i in top if flags[i]]
        out.append((path, labels))
    return out, top_tags


def split_of(mp3_path: str) -> str:
    d = mp3_path.split("/", 1)[0].lower()
    if d in _VAL_DIRS:
        return "validation"
    if d in _TEST_DIRS:
        return "test"
    return "train"


def build_groundtruth(rows, tags, out_dir: Path, mel_suffix: str = ".mmap"):
    binarizer = MultiHotBinarizer(tags)
    split_dicts = {"train": {}, "validation": {}, "test": {}, "all": {}}
    for path, labels in rows:
        if not labels:
            continue
        target = binarizer.transform([labels])[0]
        mel_name = Path(path).stem + mel_suffix
        split_dicts[split_of(path)][mel_name] = target
        split_dicts["all"][mel_name] = target
    out_dir.mkdir(parents=True, exist_ok=True)
    for split, d in split_dicts.items():
        with open(out_dir / f"groundtruth-{split}.pk", "wb") as f:
            pickle.dump(d, f)
    with open(out_dir / "ohe.pk", "wb") as f:
        pickle.dump(binarizer, f)
    return split_dicts


def main(argv=None):
    from .extract_mel import extract_one

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="MTT working directory")
    ap.add_argument("--skip-download", action="store_true")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    root = Path(args.root)

    if not args.skip_download:
        try:
            download(root)
        except Exception as e:
            print(
                f"download failed ({e}); place {MTT_ZIPS + [MTT_ANNOTATIONS]} "
                f"under {root} and re-run with --skip-download",
                file=sys.stderr,
            )
            raise SystemExit(1)

    audio_dir = extract_zips(root)
    rows, tags = read_annotations(root / MTT_ANNOTATIONS)

    mel_dir = root / "mels"
    mel_dir.mkdir(exist_ok=True)
    clips = [audio_dir / p for p, _ in rows if (audio_dir / p).exists()]
    print(f"extracting {len(clips)} clips -> {mel_dir}")
    with ProcessPoolExecutor(max_workers=args.workers) as pool:
        futures = [pool.submit(extract_one, str(c), str(mel_dir)) for c in clips]
        done = 0
        for f in futures:
            try:
                f.result()
            except Exception as e:
                print(f"FAILED: {e}", file=sys.stderr)
            done += 1
            if done % 500 == 0:
                print(f"{done}/{len(clips)}")

    # groundtruth only for clips whose mel file actually exists: MTT ships
    # a handful of missing/corrupt mp3s and per-clip extraction failures
    # are non-fatal above — a dangling .mmap reference would crash the
    # training loader later (reference keeps them, datasets/mtt/preprocess.py)
    ok_rows = [(p, labels) for p, labels in rows
               if (mel_dir / (Path(p).stem + ".mmap")).exists()]
    if len(ok_rows) != len(rows):
        print(f"dropping {len(rows) - len(ok_rows)} clips without mels "
              "from the groundtruth pickles", file=sys.stderr)
    build_groundtruth(ok_rows, tags, root)


if __name__ == "__main__":
    main()
