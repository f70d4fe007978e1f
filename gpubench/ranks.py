"""Ranks held for the run: one process group over several cards, formed
once at a cell's set-up and driven pass after pass.

Rank 0 is the harness's own process, so the taps, the program's spans and
the profiler see what it runs.  Ranks 1 to n-1 are child processes, forked
from the standard library's forkserver that the port's ``_dist`` starts its
ranks from (told once to preload torch): the harness has initialised CUDA,
so forking it is out, and n fresh interpreters importing torch at once
would cost every core seconds of set-up.  Every rank joins through the port's own
``_dist.init(device, rank, n, store)``, on a ``FileStore`` in a temporary
directory: NCCL on the cards, gloo on the CPU.

* :meth:`Ranks.open` resolves every function the entry will run, before
  any child starts: a checkout that lacks one fails at once;
* :meth:`Ranks.run` runs one of them on every rank at once and returns
  rank 0's result;
* :meth:`Ranks.peaks` reads each rank's memory peak on its own card;
* :meth:`Ranks.close` destroys the group and ends the children, and
  raises where a child has loaded JAX, jaxlib, flax or the JAX package
  (``harness.forbidden_modules``, read in each child as it closes).

Failures are bounded.  A child that raises or dies breaks the ranks: the
group is aborted and the children are ended at once, so that rank 0's
collective returns with an error instead of waiting out the group's
timeout (five minutes), and the call raises :class:`RanksError` with the
child's own error first.  Every later call raises at once: the harness
ends the run there, with exit code 3 and no result.  Where rank 0
is still inside the call :data:`RELEASE_S` after the abort, the process
ends with exit code 3 and the cause on standard error.  Rank 0 waits at
most :data:`REPLY_S` for the children once its own part has ended.
"""

from __future__ import annotations

import dataclasses
import importlib
import multiprocessing
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

# how long rank 0 waits for the children's replies once its own part of a
# call has ended: a rank still in a collective that rank 0 left is stuck
REPLY_S = 30.0
# how long rank 0 may stay inside a call once the ranks were broken under
# it, before the process ends
RELEASE_S = 30.0
# how long close() waits for each child, and for rank 0's own group
CLOSE_S = 10.0
# a child's error as it reaches rank 0, at most
ERROR_CHARS = 1000
# exit code of a process whose rank 0 never came back from a broken call
STUCK_EXIT = 3
# once one child has failed, how long the others get to report before the
# ranks are broken: the cause then comes before what its peers saw of it
SETTLE_S = 2.0


class RanksError(RuntimeError):
    """A function the ranks should run is missing, or a child failed."""


def resolve(target: str) -> Callable[..., Any]:
    """The function ``package.module:function`` names."""
    module_name, _, name = target.partition(":")
    try:
        fn = getattr(importlib.import_module(module_name), name)
    except (ImportError, AttributeError) as e:
        raise RanksError(f"no function {target}: {e}") from e
    if not callable(fn):
        raise RanksError(f"{target} is not a function")
    return fn


def _failed(e: BaseException) -> tuple:
    """A child's reply to a call it failed: its error and where it was
    raised, and whether the error is only what a peer's failure looks like
    here (``_dist._transport``, the port's own rule)."""
    from tpu_operator_torch.validator import _dist

    text = f"{type(e).__name__}: {e}"
    frames = traceback.extract_tb(e.__traceback__)
    if frames:
        text += f" (at {frames[-1].filename}:{frames[-1].lineno})"
    return ("error", text[:ERROR_CHARS], _dist._transport(e, text))


def _peak(device) -> int:
    import torch

    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def _child(rank: int, n: int, device: str, store_path: str, conn) -> None:
    """Rank ``rank``: join the group, then run what rank 0 sends (``run``:
    a function by name and its arguments; ``peak``; ``close``), replying
    ``("ok", value)`` or :func:`_failed`'s to each; ``close``'s value is
    the forbidden modules loaded here."""
    import torch
    import torch.distributed as dist

    from gpubench.harness import forbidden_modules
    from tpu_operator_torch.validator import _dist

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)    # the ranks share the host's cores
    try:
        dev = _dist.init(device, rank, n, dist.FileStore(store_path, n))
    except Exception as e:
        conn.send(_failed(e))
        return
    conn.send(("ok", None))
    try:
        while True:
            try:
                message = conn.recv()
            except EOFError:        # rank 0 has gone
                return
            if message[0] == "close":
                conn.send(("ok", forbidden_modules()))
                return
            try:
                if message[0] == "peak":
                    out = _peak(dev)
                else:
                    _, target, args = message
                    resolve(target)(*args)
                    out = None
            except Exception as e:
                conn.send(_failed(e))
            else:
                conn.send(("ok", out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop_servers() -> None:
    """End the forkserver, then the resource tracker it started beside
    this process, and wait for each: no process outlives the run (each
    would end once this process has, a moment later, and be left to a pid
    1 that may never reap it)."""
    from multiprocessing import forkserver, resource_tracker

    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(server, "_stop", None)
        if stop is not None:
            stop()


@dataclasses.dataclass
class _Child:
    rank: int
    process: Any
    conn: Any


@dataclasses.dataclass
class _Call:
    """One call across the ranks, as the watcher sees it."""
    waiting: Dict[int, _Child]
    replies: Dict[int, Any] = dataclasses.field(default_factory=dict)
    failures: List[str] = dataclasses.field(default_factory=list)
    rank0_done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    rank0_failed: bool = False


class Ranks:
    """``n`` ranks on ``device`` (``cuda``: rank k on card k; ``cpu``:
    gloo), able to run the functions ``functions`` names
    (``package.module:function``)."""

    def __init__(self, n: int, device: str, functions: Sequence[str]) -> None:
        if n < 2:
            raise ValueError(f"held ranks need two or more, got {n}")
        self.n, self.device = n, device
        self.functions = list(functions)
        self._children: List[_Child] = []
        self._tmp: Optional[str] = None
        self._dev = None
        self._in_group = False
        self._broken = ""

    @property
    def pids(self) -> List[int]:
        """The children's process ids, rank 1 first."""
        return [c.process.pid for c in self._children]

    def open(self) -> "Ranks":
        for target in self.functions:
            resolve(target)
        import torch.distributed as dist

        from tpu_operator_torch.validator import _dist

        ctx = multiprocessing.get_context(_dist._forkserver())
        self._tmp = tempfile.mkdtemp(prefix="gpubench-ranks-")
        store_path = os.path.join(self._tmp, "store")
        try:
            for rank in range(1, self.n):
                mine, theirs = ctx.Pipe()
                process = ctx.Process(
                    target=_child, name=f"gpubench-rank-{rank}", daemon=True,
                    args=(rank, self.n, self.device, store_path, theirs))
                process.start()
                theirs.close()
                self._children.append(_Child(rank, process, mine))

            def join():
                self._in_group = True
                return _dist.init(self.device, 0, self.n,
                                  dist.FileStore(store_path, self.n))
            self._dev = self._call(None, join, "joining the group")[0]
        except BaseException:
            self.close()
            raise
        return self

    def run(self, target: str, *args: Any) -> Any:
        """``target``'s function on every rank at once, with ``args``;
        rank 0's result.  Rank 0's own exception is raised as it is where
        every child ended its part; a child's failure raises
        :class:`RanksError` and breaks the ranks."""
        if target not in self.functions:
            raise RanksError(f"{target} was not named when the ranks opened")
        return self._call(("run", target, args),
                          lambda: resolve(target)(*args), target)[0]

    def peaks(self) -> List[int]:
        """Each rank's ``torch.cuda.max_memory_allocated`` on its own card,
        rank 0 first (0 on the CPU)."""
        replies = self._call(("peak",), lambda: _peak(self._dev), "peaks")
        return [replies[0]] + [replies[c.rank] for c in self._children]

    def close(self) -> None:
        """Destroy the group and end the children; never waits longer than
        :data:`CLOSE_S` for any of them.  Once every process has ended,
        raises :class:`RanksError` where a child of sound ranks has loaded
        a forbidden module, or gave no account of its modules."""
        for c in self._children:
            try:
                c.conn.send(("close",))
            except OSError:
                pass                # a child that has gone
        loaded = (self._loaded() if self._dev is not None and not self._broken
                  else [])
        self._leave_group()
        self._end_children(CLOSE_S)
        if not any(c.process.is_alive() for c in self._children):
            # a child that outlived SIGKILL (an uninterruptible wait) holds the
            # servers' pipes open: stopping them would wait on it
            _stop_servers()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None
        if loaded:
            raise RanksError("loaded in the held ranks: " + "; ".join(loaded))

    # ------------------------------------------------------------------
    def _call(self, message, own: Callable[[], Any], what: str
              ) -> Dict[int, Any]:
        """Send ``message`` to every child (None: they act unasked) and run
        ``own`` here as rank 0; rank -> reply, rank 0's the result of
        ``own``."""
        if self._broken:
            raise RanksError(self._broken)
        call = _Call(waiting={c.rank: c for c in self._children})
        for c in self._children:
            if message is None:
                continue
            try:
                c.conn.send(message)
            except OSError:
                pass                # a child that has died: the watcher's
        watcher = threading.Thread(target=self._watch, args=(call, what),
                                   name="gpubench-ranks-watch", daemon=True)
        watcher.start()
        try:
            call.replies[0] = own()
        except BaseException as e:
            call.rank0_failed = True
            call.rank0_done.set()
            watcher.join()
            if call.failures:
                # the cause, then what rank 0 saw of it
                raise RanksError(self._broken) from e
            raise
        call.rank0_done.set()
        watcher.join()
        if call.failures:
            raise RanksError(self._broken)
        return call.replies

    def _watch(self, call: _Call, what: str) -> None:
        """Collect the children's replies to ``call``; at a child's error
        or death (and :data:`SETTLE_S` for the others to report), or once
        rank 0 has ended its part and a child has not replied within
        :data:`REPLY_S`, break the ranks under rank 0."""
        failures: List[tuple] = []      # (lost peer, text), as seen
        deadline = settle = None
        while call.waiting:
            now = time.monotonic()
            if settle is not None and now > settle:
                break
            if deadline is None and call.rank0_done.is_set():
                deadline = now + REPLY_S
            if settle is None and deadline is not None and now > deadline:
                failures.append((False, (
                    f"rank(s) {sorted(call.waiting)} gave no reply to {what} "
                    f"within {REPLY_S:.0f} s of rank 0's "
                    + ("failure" if call.rank0_failed else "end"))))
                break
            children = list(call.waiting.values())
            multiprocessing.connection.wait(
                [c.conn for c in children]
                + [c.process.sentinel for c in children], timeout=0.2)
            for c in children:
                reply = None
                if c.conn.poll():
                    try:
                        reply = c.conn.recv()
                    except EOFError:
                        pass            # the child has gone: below
                if reply is not None and reply[0] == "ok":
                    call.replies[c.rank] = reply[1]
                    del call.waiting[c.rank]
                elif reply is not None:
                    failures.append((reply[2], f"rank {c.rank} failed in "
                                     f"{what}: {reply[1]}"
                                     + (" (a lost peer)" if reply[2]
                                        else "")))
                    del call.waiting[c.rank]
                elif not c.process.is_alive():
                    c.process.join(1.0)
                    failures.append((False, f"rank {c.rank} died in {what} "
                                     f"(exit code {c.process.exitcode})"))
                    del call.waiting[c.rank]
            if failures and settle is None:
                settle = time.monotonic() + SETTLE_S
        if not failures:
            return
        failures.sort(key=lambda f: f[0])     # causes first, as seen
        call.failures = [text for _, text in failures]
        self._break("; ".join(call.failures))
        if not call.rank0_done.wait(RELEASE_S):
            print(f"gpubench: rank 0 is still inside {what} {RELEASE_S:.0f} "
                  f"s after the ranks broke: {self._broken}", file=sys.stderr,
                  flush=True)
            os._exit(STUCK_EXIT)

    def _break(self, why: str) -> None:
        """No more calls: abort rank 0's group, so that a collective it is
        inside returns, and end the children."""
        self._broken = why
        import torch.distributed as dist

        if dist.is_initialized():
            try:
                from torch.distributed import distributed_c10d

                distributed_c10d._abort_process_group()
            except (RuntimeError, ValueError, AttributeError):
                pass                # a backend without abort: gloo
        self._end_children(0.0)

    def _loaded(self) -> List[str]:
        """Each child's reply to ``close``: the forbidden modules loaded in
        it, ``rank k: name, ...``, or that it gave none within
        :data:`CLOSE_S`."""
        found = []
        deadline = time.monotonic() + CLOSE_S
        for c in self._children:
            reply = None
            try:
                if c.conn.poll(max(0.0, deadline - time.monotonic())):
                    reply = c.conn.recv()
            except (EOFError, OSError):
                pass                # the child has gone: no account
            if reply is None or reply[0] != "ok":
                found.append(f"rank {c.rank}: no account of its modules")
            elif reply[1]:
                found.append(f"rank {c.rank}: {', '.join(reply[1])}")
        return found

    def _end_children(self, wait_s: float) -> None:
        for c in self._children:
            c.process.join(wait_s)
            if c.process.is_alive():
                c.process.terminate()
                c.process.join(CLOSE_S)
            if c.process.is_alive():
                c.process.kill()
                c.process.join(CLOSE_S)
            c.conn.close()

    def _leave_group(self) -> None:
        """Destroy rank 0's group, in a thread given :data:`CLOSE_S`: a
        communicator whose peers are gone must not hold the run."""
        import torch.distributed as dist

        if not (self._in_group and dist.is_initialized()):
            return
        self._in_group = False
        leave = threading.Thread(target=dist.destroy_process_group,
                                 name="gpubench-ranks-leave", daemon=True)
        leave.start()
        leave.join(CLOSE_S)
