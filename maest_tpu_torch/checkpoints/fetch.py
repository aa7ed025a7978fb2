"""Checkpoint auto-download into the local cache, port of
``maest_tpu/checkpoints/fetch.py``.

The reference downloads release weights on first use: timm
``load_pretrained`` fetches the ``default_cfgs`` URL inside
``build_model_with_cfg`` (reference: models/helpers/vit_helpers.py:261,
URL table models/maest.py:64-153). ``get_maest(pretrained=True)`` mirrors
that here: if the released ``.ckpt`` is not already in the cache dir, it
is fetched from ``ArchSpec.url`` and committed atomically.

Offline environments: set ``MAEST_TPU_OFFLINE=1`` to skip the network
attempt entirely (the clear pre-place-the-file error is raised instead),
or drop the files into ``MAEST_TPU_CACHE`` yourself.
"""

from __future__ import annotations

import hashlib
import http.client
import os
import tempfile
import urllib.error
import urllib.request
from pathlib import Path

from ..models.registry import ArchSpec, cached_checkpoint_path

__all__ = ["fetch_checkpoint", "offline", "FetchError"]


class FetchError(OSError):
    """A checkpoint download failed (no egress, HTTP error, timeout)."""


def offline() -> bool:
    return os.environ.get("MAEST_TPU_OFFLINE", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


def fetch_checkpoint(spec: ArchSpec, dest: str | os.PathLike | None = None,
                     timeout: float = 30.0) -> Path:
    """Ensure ``spec``'s released checkpoint exists locally; return its path.

    Downloads to a sibling temp file and ``os.replace``s into place, so a
    partially-written file can never be mistaken for a checkpoint and
    concurrent fetches of the same arch both land safely.
    """
    dest = Path(dest) if dest is not None else cached_checkpoint_path(spec)
    if dest.exists():
        return dest
    if offline():
        raise FetchError(
            f"MAEST_TPU_OFFLINE is set; not downloading {spec.url}")
    dest.parent.mkdir(parents=True, exist_ok=True)
    # Unique staging file per fetch (tempfile, not PID): two threads in one
    # process fetching the same arch must not interleave bytes in a shared
    # .tmp file before os.replace commits it.
    fd, tmp_name = tempfile.mkstemp(
        prefix=dest.name + ".tmp.", dir=dest.parent)
    tmp = Path(tmp_name)
    try:
        digest = hashlib.sha256()
        # fdopen takes ownership of fd; open it FIRST so an early urlopen
        # failure cannot leak the descriptor (retried fetches during an
        # outage would otherwise accumulate fds toward EMFILE)
        with os.fdopen(fd, "wb") as out, \
                urllib.request.urlopen(spec.url, timeout=timeout) as resp:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                digest.update(chunk)
                out.write(chunk)
        _verify_digest(spec, digest.hexdigest())
        # mkstemp creates 0600; restore umask-governed perms so a shared
        # MAEST_TPU_CACHE stays readable by other users, as the previous
        # plain-open staging did
        os.chmod(tmp, 0o666 & ~_UMASK)
        os.replace(tmp, dest)
    except FetchError:
        # _verify_digest's mismatch: an integrity failure, NOT a download
        # failure — FetchError subclasses OSError, so without this clause
        # the handler below would re-wrap it as "failed to download",
        # inviting pointless retries of a non-retryable condition
        raise
    except (urllib.error.URLError, TimeoutError, OSError,
            http.client.HTTPException) as err:
        # http.client.HTTPException (e.g. IncompleteRead on a truncated
        # download) is not an OSError subclass; without it here the caller's
        # friendly FileNotFoundError wrapper is bypassed.
        raise FetchError(f"failed to download {spec.url}: {err}") from err
    finally:
        tmp.unlink(missing_ok=True)
    return dest


def _read_umask() -> int:
    # /proc/self/status avoids the os.umask(0)/os.umask(mask) flip, which
    # mutates PROCESS-global state: another thread creating a file inside
    # that window (the checkpoint writer's thread, a concurrent fetch's
    # mkdir) would get world-writable modes. The flip fallback runs once at import,
    # before worker threads exist, not per fetch.
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("Umask:"):
                    return int(line.split()[1], 8)
    except (OSError, ValueError, IndexError):
        pass
    mask = os.umask(0)
    os.umask(mask)
    return mask


_UMASK = _read_umask()


def _verify_digest(spec: ArchSpec, got: str) -> None:
    """Check the downloaded bytes against ``spec.sha256`` when pinned.

    The fetched file is later deserialized by ``torch.load`` — an unpickle
    that can execute arbitrary code — so an implicit network fetch must be
    integrity-checked before it is committed to the cache. Digests are
    pinned per arch in the registry; ``None`` means no pin is available
    (the release digests have not been computed yet), in which case
    the fetch proceeds but the mismatch guard below still protects every
    pinned arch.
    """
    expected = getattr(spec, "sha256", None)
    if expected is not None and got != expected.lower():
        raise FetchError(
            f"checkpoint digest mismatch for {spec.name}: expected sha256 "
            f"{expected}, downloaded file hashes to {got}; refusing to "
            f"commit it to the cache")
