"""Export a training checkpoint as release artifacts, port of
``maest_tpu/apps/export_release.py``.

Bridges the training side (the port Trainer's checkpoint directories,
``torch.save`` snapshots with ``params`` and the live-averaged
``swa_params``) to the packaging side — the workflow the reference splits
across manual scripts (packaging/safetensors_to_pytorch.py,
packaging/push_to_hub.py, packaging/convert_to_onnx.sh):

    python -m maest_tpu_torch.apps.export_release \\
        <run_dir/checkpoints/epoch-N> --format torch|hf|onnx \\
        [--swa/--no-swa] --out PATH [--arch discogs-maest-30s-pw-129e] \\
        [--device cuda|cpu] [geometry overrides ...]

Formats:
  torch  MAEST-layout ``.pt`` state dict loadable by the upstream repo and
         ``get_maest(checkpoint=...)`` (``--swa-prefix`` stores
         ``net_swa.*`` keys like released files)
  hf     HF AST model directory (config.json + model.safetensors +
         preprocessor_config.json + feature_extraction_maest.py)
  onnx   ONNX model with the Essentia signature

The weights are loaded into the model on ``--device`` (the card unless
asked otherwise), which checks them against the geometry before anything
is written. The JAX package's ``tf`` format (a TF SavedModel through
jax2tf) has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

FORMATS = ("torch", "hf", "onnx", "tf")


def load_training_checkpoint(path: str, *, with_opt_state: bool = False
                             ) -> dict:
    """A Trainer checkpoint directory's snapshot on the host
    (``train/loop.py state_snapshot``: ``params``, ``swa_params``,
    ``swa_n``, ``step``). The optimizer state (Adam's moments, twice the
    parameters' bytes, which ``select_params`` never reads) is dropped
    unless ``with_opt_state``."""
    from ..train.loop import read_checkpoint

    state = dict(read_checkpoint(path))
    if not with_opt_state:
        state.pop("opt_state", None)
    return state


def run_config_for(checkpoint: str) -> dict | None:
    """The training config recorded next to the checkpoints
    (<run_dir>/config.json, written by ``Trainer.__init__``), the source of
    truth for the model geometry of this run."""
    cfg_path = Path(checkpoint).parent.parent / "config.json"
    if not cfg_path.exists():
        return None
    return json.loads(cfg_path.read_text())


def select_params(state: dict, *, swa: bool) -> tuple[dict, str]:
    """Pick SWA or raw params from a restored training state; returns
    (params, which) where ``which`` labels what was actually chosen. Falls
    back to raw params when SWA never started (swa_n == 0)."""
    if swa:
        swa_n = int(np.asarray(state.get("swa_n", 0)))
        if swa_n > 0:
            return state["swa_params"], "swa"
        return state["params"], "raw (swa unavailable: swa_n == 0)"
    return state["params"], "raw"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="maest-export-release",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint",
                    help="Trainer checkpoint dir (run_dir/checkpoints/<tag>)")
    ap.add_argument("--format", choices=FORMATS, default="torch")
    ap.add_argument("--out", required=True,
                    help="output file (torch, onnx) or dir (hf)")
    ap.add_argument("--arch", default=None,
                    help="defaults to the run's recorded config.json, then "
                         "discogs-maest-30s-pw-129e")
    ap.add_argument("--swa", dest="swa", action="store_true", default=True,
                    help="export the SWA average (default; released "
                         "checkpoints are -swa files)")
    ap.add_argument("--no-swa", dest="swa", action="store_false")
    ap.add_argument("--swa-prefix", action="store_true",
                    help="torch only: store net_swa.* keys")
    ap.add_argument("--device", default="cuda",
                    help="where the weights are loaded and checked")
    # geometry overrides matching get_maest / the training config
    ap.add_argument("--n-classes", type=int, default=None)
    ap.add_argument("--input-t", type=int, default=None)
    ap.add_argument("--embed-dim", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--num-heads", type=int, default=None)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.format == "tf":
        raise SystemExit(
            "export_release: --format tf writes a TF SavedModel through "
            "jax2tf, which needs JAX; the PyTorch port has no counterpart "
            "(use --format onnx)")

    import torch

    from ..checkpoints.convert import load_into
    from ..models.registry import build_config
    from ..models.vit import MAESTNet

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch finds no CUDA "
                           "device; pass --device cpu")
    # geometry defaults come from the run's own config.json (one dir above
    # the checkpoints): exporting with another geometry would write a
    # broken artifact (e.g. a 400-label config over a 519-row head)
    maest_cfg = (run_config_for(args.checkpoint) or {}).get("maest", {})
    arch = args.arch or maest_cfg.get("arch") or "discogs-maest-30s-pw-129e"
    over = {}
    for key, cli_val in (
        ("n_classes", args.n_classes), ("input_t", args.input_t),
        ("embed_dim", args.embed_dim), ("depth", args.depth),
        ("num_heads", args.num_heads),
    ):
        val = cli_val if cli_val is not None else maest_cfg.get(key)
        if val is not None:
            over[key] = val
    cfg = build_config(arch, **over)

    params, which = select_params(load_training_checkpoint(args.checkpoint),
                                  swa=args.swa)
    net = MAESTNet(cfg, dtype=torch.float32, device=device)
    missing = sorted(set(net.state_dict()) - set(params))
    if missing:
        raise ValueError(f"checkpoint lacks {missing} for {arch} {over}")
    load_into(net, params)

    if args.format == "torch":
        from ..packaging.hf_ast import save_torch_checkpoint

        out = save_torch_checkpoint(net, None, args.out,
                                    swa_prefix=args.swa_prefix)
    elif args.format == "hf":
        from ..packaging.hf_ast import save_pretrained

        out = save_pretrained(net, None, args.out)
    else:
        from ..packaging.onnx_export import export_onnx

        out = export_onnx(net, args.out)
    print(f"exported {args.format} ({which}) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
