"""Spawn the ranks of a run on this host, as torchrun would.

``spawn(target, world, *args)`` starts ``world`` processes, each with
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) set, runs
``target(rank, world, *args)`` in each and returns their results in rank
order. A rank that raises, or dies on a signal, fails the launch with its
traceback; the other ranks are then killed, as they all are at
``timeout``. ``init_distributed`` in the target joins the group.
``spawn_ranks`` does so for an entry point's ``N`` ranks, one a card;
``launched`` tells a rank of a launch (torchrun's or this one's).
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional


_TORCHRUN = ("WORLD_SIZE", "RANK")


def launched() -> bool:
    """Whether this process is a rank of a launch (torchrun's variables)."""
    return any(os.environ.get(k) for k in _TORCHRUN)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(target, rank: int, world: int, port: int, args, results):
    """One rank: torchrun's variables, ``target``, its result or its
    traceback to the launcher, the process group torn down."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()  # a rank that dies on a signal shows where
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        results.put((rank, "ok", target(rank, world, *args)))
    except BaseException:  # noqa: BLE001 — reported to the launcher
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def spawn(target: Callable, world: int, *args,
          timeout: Optional[float] = None) -> list:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    and return each rank's result, in rank order. Raises ``RuntimeError``
    naming the first rank that failed (with its traceback) or the
    timeout; every rank still alive is then killed."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(target, r, world, port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out, failure = {}, None

    def take(rank, status, value):
        nonlocal failure
        if status == "error":
            failure = f"rank {rank} failed:\n{value}"
        else:
            out[rank] = value

    try:
        while len(out) < world and failure is None:
            if deadline is not None and time.monotonic() > deadline:
                failure = f"the ranks did not finish in {timeout} s"
                break
            try:
                take(*results.get(timeout=0.2))
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)]
            if dead:
                # a rank that raised has sent its traceback before exiting
                try:
                    while failure is None:
                        take(*results.get(timeout=1.0))
                except queue.Empty:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join()
    if failure is not None:
        raise RuntimeError(f"launch of {world} ranks: {failure}")
    return [out[r] for r in range(world)]


def spawn_ranks(target: Callable, n: int, device, *args,
                what: str = "devices", timeout: Optional[float] = None
                ) -> list:
    """``spawn`` of ``n`` ranks of ``target`` on this host, one a visible
    card on CUDA (on the CPU ``n`` processes over gloo). ``what`` names
    the option that asked for ``n`` in the refusal of more ranks than
    cards (ranks that share a card are launched with torchrun)."""
    if str(device).startswith("cuda"):
        import torch

        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device='cuda' requested but torch finds no "
                               "CUDA device")
        if n > cards:
            raise ValueError(
                f"{what}={n} but {cards} cards are visible: one rank a card "
                "(ranks that share a card: launch them with torchrun)")
    return spawn(target, n, *args, timeout=timeout)
