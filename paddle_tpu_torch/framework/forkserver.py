"""A fork server for the port's worker processes: a fresh process that
imports the heavy modules once (torch and the parts of it the workers
import, ``PRELOAD``), then forks a child for each launch, so a child starts
with them already imported instead of importing them again (8.5-12.4 s a
process on the card's host, more under load).

``ForkServer(preload=...)`` rides ``multiprocessing``'s ``forkserver``
start method: the server is a new interpreter (never a fork of the caller,
which may hold a CUDA context) that imports ``preload`` and never touches
CUDA; each child is forked from it and then runs its command as a fresh
process would. ``popen(cmd, ...)`` takes the command line ``subprocess``
takes (``[python, ["-u"], "-m", module, *args]`` or ``[python, ["-u"],
script, *args]``) and returns a :class:`ForkedProcess` with ``Popen``'s
surface (``pid``, ``returncode``, ``stdout``, ``poll``, ``wait``,
``send_signal``, ``terminate``, ``kill``).

In the child, before the command runs: the working directory, the
environment (replaced whole), standard output and error (a file, or
``subprocess.PIPE`` for stdout) and the import path are the command's;
``sitecustomize`` is imported again from the child's ``PYTHONPATH`` (the
server imported its own at start); standard output is line buffered. At
its end the child runs its ``atexit`` handlers and exits with the
command's code (an uncaught exception prints its traceback and exits 1).
Only the preloaded modules differ from a fresh process: they were
imported before the child's environment was set, so a preloaded module
must not read the environment at import (torch and numpy do not read what
the port's workers set; nothing of the port is imported before the child's
environment is set: the child's code reaches the child through the builtin
``exec``, not through an import of this module).

``stop()`` ends the server (its children run on) and the resource tracker
started with it; both also exit with the process that started them.
"""
from __future__ import annotations

import contextlib
import io
import os
import signal
import subprocess
import sys
import types
from typing import List, Optional, Sequence

__all__ = ["ForkServer", "ForkedProcess", "PRELOAD"]

# torch, and what the port's workers import of it at start: dynamo and
# inductor's config (pulled in by torch's flop counter and checkpointing),
# the export serializer (a served artifact's load)
PRELOAD = ("torch", "numpy", "torch._dynamo", "torch._inductor.config",
           "torch._export.serde.serialize")


class _Fd:
    """A file descriptor handed to the forked child: pickled (while a launch
    is prepared) as ``multiprocessing``'s own duplicate-for-the-child
    handle, whose ``detach()`` gives the child its copy."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        import copyreg
        from multiprocessing import reduction
        dup = reduction.DupFd(self.fd)
        return (copyreg._reconstructor, (type(dup), object, None),
                dict(vars(dup)))


@contextlib.contextmanager
def _no_main():
    """Hide this process's ``__main__`` while a launch is prepared:
    ``multiprocessing`` would import it again in every child (the caller's
    script, which the child's command replaces)."""
    real = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = real


def _parse(cmd: Sequence[str]):
    """(kind, target, argv) of a python command line."""
    args = list(cmd)[1:]
    while args and args[0] == "-u":
        args.pop(0)
    if not args:
        raise ValueError(f"no script or module in {list(cmd)!r}")
    if args[0] == "-m":
        if len(args) < 2:
            raise ValueError(f"-m without a module in {list(cmd)!r}")
        return "module", args[1], args[2:]
    if args[0].startswith("-"):
        raise ValueError(f"unsupported interpreter option {args[0]!r}")
    return "script", args[0], args[1:]


# The forked child's code. It runs through the builtin ``exec``, so that
# unpickling the launch imports nothing of this package: the port's
# modules must read the child's environment when the command imports them.
_CHILD = """
def _main(kind, target, argv, env, cwd, out_fd, err_fd):
    import atexit, os, runpy, sys, threading, traceback
    for fd, dst in ((out_fd, 1), (err_fd, 2)):
        if fd is not None:
            fd = fd.detach()
            os.dup2(fd, dst)
            os.close(fd)
    if cwd:
        os.chdir(cwd)
    os.environ.clear()
    os.environ.update(env)
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.reconfigure(line_buffering=True)
        except (AttributeError, ValueError):
            pass
    extra = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    first = (os.getcwd() if kind == "module"
             else os.path.dirname(os.path.abspath(target)))
    sys.path[:0] = [first] + [p for p in extra if p not in sys.path]
    sys.modules.pop("sitecustomize", None)
    code = 0
    try:
        try:
            import sitecustomize  # the child's own
        except ImportError:
            pass
        sys.argv = [target] + list(argv)
        if kind == "module":
            runpy.run_module(target, run_name="__main__", alter_sys=True)
        else:
            runpy.run_path(target, run_name="__main__")
    except SystemExit as e:
        if e.code is None:
            code = 0
        elif isinstance(e.code, int):
            code = e.code
        else:
            print(e.code, file=sys.stderr)
            code = 1
    except BaseException:
        traceback.print_exc()
        code = 1
    try:
        threading._shutdown()
        atexit._run_exitfuncs()
    except Exception:
        traceback.print_exc()
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):
            pass
    os._exit(code & 0xFF)


_main(*ARGS)
"""


class ForkedProcess:
    """A child of the fork server, with ``subprocess.Popen``'s surface."""

    def __init__(self, proc, stdout):
        self._proc = proc
        self.pid = proc.pid
        self.stdout = stdout
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            code = self._proc.exitcode
            if code is not None:
                self.returncode = code
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        self._proc.join(timeout)
        if self.poll() is None:
            raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
        return self.returncode

    def send_signal(self, sig):
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)


class ForkServer:
    """The fork server of this process (``multiprocessing`` keeps one a
    process: the first ``ForkServer``'s ``preload`` is the one that
    applies)."""

    def __init__(self, preload: Sequence[str] = PRELOAD):
        import multiprocessing as mp
        self.preload: List[str] = list(preload)
        self._ctx = mp.get_context("forkserver")
        self._ctx.set_forkserver_preload(self.preload)
        self.launches = 0

    def start(self) -> "ForkServer":
        """Start the server now (it imports ``preload`` in the background:
        the first launch waits for that)."""
        from multiprocessing import forkserver
        with _no_main():
            forkserver.ensure_running()
        return self

    def popen(self, cmd: Sequence[str], *, env=None, cwd=None, stdout=None,
              stderr=None, text: bool = False) -> ForkedProcess:
        """Launch ``cmd`` (a python command line) as a forked child.
        ``stdout`` may be ``subprocess.PIPE``, ``subprocess.DEVNULL``, a
        file or None (this process's); ``stderr`` likewise, or
        ``subprocess.STDOUT``."""
        kind, target, argv = _parse(cmd)
        env = dict(os.environ if env is None else env)
        opened, read_end = [], None

        def fd_of(spec, is_err=False):
            nonlocal read_end
            if spec is None:
                return None
            if spec == subprocess.DEVNULL:
                f = open(os.devnull, "wb")
                opened.append(f)
                return _Fd(f.fileno())
            if spec == subprocess.PIPE and not is_err:
                r, w = os.pipe()
                read_end = r
                opened.append(w)
                return _Fd(w)
            if spec == subprocess.STDOUT and is_err:
                return out
            if isinstance(spec, int):
                return _Fd(spec)
            return _Fd(spec.fileno())

        out = fd_of(stdout)
        err = fd_of(stderr, is_err=True)
        proc = self._ctx.Process(
            target=exec, args=(_CHILD, {"__name__": "__forked__", "ARGS": (
                kind, target, argv, env, cwd or os.getcwd(), out, err)}),
            daemon=False)
        try:
            with _no_main():
                proc.start()
        finally:
            for f in opened:
                if isinstance(f, int):
                    os.close(f)
                else:
                    f.close()
        self.launches += 1
        pipe = None
        if read_end is not None:
            pipe = io.open(read_end, "r" if text else "rb",
                           **({"encoding": "utf-8", "errors": "replace"}
                              if text else {}))
        return ForkedProcess(proc, pipe)

    @staticmethod
    def stop():
        """End this process's fork server and the resource tracker
        ``multiprocessing`` started beside it (a no-op when none runs; a
        later user of the tracker starts it again)."""
        from multiprocessing import forkserver, resource_tracker
        server = getattr(forkserver, "_forkserver", None)
        if server is not None and getattr(server, "_forkserver_pid", None):
            server._stop()
        tracker = resource_tracker._resource_tracker
        if getattr(tracker, "_pid", None) is not None:
            tracker._stop()
