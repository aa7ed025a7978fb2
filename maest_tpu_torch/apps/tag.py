"""Tag audio files from the command line, port of ``maest_tpu/apps/tag.py``.

The reference exposes tagging only through the Python API (reference:
README.md usage, models/maest.py:935-939); this CLI wraps the same
``get_maest`` -> ``predict_labels`` stack so a shell user can go from an
audio file to ranked style labels (or an embeddings ``.npy``) in one
command:

    python -m maest_tpu_torch.apps.tag song.wav [song2.wav ...] \\
        [--arch discogs-maest-30s-pw-129e] [--top-k 10] [--json] \\
        [--checkpoint ckpt.pt] [--embeddings-dir out/ --block 7] \\
        [--device cuda] [--devices N]

Accepts ``.wav`` / ``.npy`` waveforms (16 kHz mono after the built-in
resample); other formats decode through ffmpeg when available.
``--checkpoint`` takes a Lightning, plain or HF AST (hub) layout file;
without it the released weights are read from the cache, fetched on first
use. ``--devices N`` spreads each file's chunks over N ranks (data
parallel): spawned here, one a card, or joined from a torchrun launch
(ranks that share a card); only rank 0 prints and writes.

The JAX package turns on XLA's persistent compilation cache here
(``maest_tpu/utils/cache.py``); the port has no counterpart by design: it
compiles no program per shape, and its kernels are built once by ``nvcc``
into the git-ignored build directory (``ops/_build.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ..parallel.launch import launched, spawn_ranks


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="maest-tag-torch",
        description="MAEST music tagging (PyTorch/CUDA)")
    ap.add_argument("audio", nargs="+", help=".wav/.npy (ffmpeg for others)")
    ap.add_argument("--arch", default="discogs-maest-30s-pw-129e")
    ap.add_argument("--checkpoint", default=None,
                    help="local .ckpt/.pt/safetensors (else cached release)")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--json", action="store_true",
                    help="one JSON object per file on stdout")
    ap.add_argument("--embeddings-dir", default=None,
                    help="write <name>.embeddings.npy instead of tagging")
    ap.add_argument("--block", type=int, default=7,
                    help="transformer block for --embeddings-dir taps")
    ap.add_argument("--random-weights", action="store_true",
                    help="skip weight loading (smoke tests)")
    ap.add_argument("--devices", type=int, default=1,
                    help="spread inference over N ranks (data-parallel)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on")
    # dev/test overrides (tiny models run fast on the CPU)
    ap.add_argument("--embed-dim", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--depth", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--num-heads", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--input-t", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def tag(args) -> list[str]:
    """Tag (or embed) ``args.audio``; returns rank 0's output lines (other
    ranks of a mesh: none). Rank 0 alone writes the embeddings."""
    from ..api import get_maest
    from ..parallel.mesh import make_mesh_for
    from .extract_mel import load_audio

    extra = {k: v for k, v in (
        ("embed_dim", args.embed_dim), ("depth", args.depth),
        ("num_heads", args.num_heads), ("input_t", args.input_t),
    ) if v is not None}
    mesh = make_mesh_for(args.devices, args.device)
    model = get_maest(
        arch=args.arch,
        pretrained=not (args.random_weights or args.checkpoint),
        checkpoint=args.checkpoint, device=args.device, mesh=mesh,
        **extra,
    )
    lead = mesh is None or mesh.get_rank() == 0

    emb_dir = Path(args.embeddings_dir) if args.embeddings_dir else None
    if emb_dir is not None and lead:
        emb_dir.mkdir(parents=True, exist_ok=True)
    used_names: dict[str, int] = {}
    lines: list[str] = []

    for path in args.audio:
        wave = load_audio(Path(path))
        if emb_dir is not None:
            # block tap returns (None, embeddings)
            emb = model(wave, transformer_block=args.block)[1].cpu().numpy()
            # same-basename inputs from different dirs must not overwrite
            stem = Path(path).stem
            n_seen = used_names.get(stem, 0)
            used_names[stem] = n_seen + 1
            if n_seen:
                stem = f"{stem}.{n_seen}"
            out = emb_dir / (stem + ".embeddings.npy")
            if lead:
                np.save(out, emb)
            lines.append(f"{path}: {emb.shape} -> {out}")
            continue
        activations, labels = model.predict_labels(wave)
        order = np.argsort(activations)[::-1][: args.top_k]
        if args.json:
            lines.append(json.dumps({
                "file": path,
                "tags": {labels[i]: round(float(activations[i]), 4)
                         for i in order},
            }))
        else:
            lines.append(path)
            lines += [f"  {activations[i]:.3f}  {labels[i]}" for i in order]
    return lines if lead else []


def _rank_main(rank: int, world: int, argv) -> list[str]:
    return tag(build_argparser().parse_args(argv))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if args.devices > 1 and not launched():
        lines = spawn_ranks(_rank_main, args.devices, args.device, argv,
                            what="--devices")[0]
    else:
        lines = tag(args)
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
