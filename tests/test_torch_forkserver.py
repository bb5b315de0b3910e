"""The fork server the port's drills and fleet use for worker processes
(``paddle_tpu_torch/framework/forkserver.py``), on the CPU: a forked child
runs its command as a fresh process would (arguments, environment,
working directory, standard streams, ``sitecustomize``, ``atexit``, exit
code and signals), with torch already imported; and a fleet stub worker
forked from it serves behind the router like a spawned one.
"""
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from paddle_tpu_torch.framework.forkserver import ForkServer
from paddle_tpu_torch.serving import fleet as pfleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = textwrap.dedent('''
    import os, sys, time
    print("ARGS", sys.argv[1:])
    print("ENV", os.environ.get("FORK_TEST"), os.getcwd())
    print("TORCH", "torch" in sys.modules)
    sys.stderr.write("to stderr\\n")
    if sys.argv[1] == "sleep":
        time.sleep(120)
    if sys.argv[1] == "raise":
        raise RuntimeError("boom")
    sys.exit(int(sys.argv[1]))
''')
SITE = textwrap.dedent('''
    import atexit, os
    atexit.register(lambda: open(os.environ["FORK_AT_EXIT"], "w").write(
        "ran"))
''')


def _children():
    kids = []
    for task in os.listdir(f"/proc/{os.getpid()}/task"):
        with open(f"/proc/{os.getpid()}/task/{task}/children") as f:
            kids += [int(x) for x in f.read().split()]
    return set(kids)


@pytest.fixture(scope="module")
def server():
    before = _children()
    fs = ForkServer().start()
    yield fs
    ForkServer.stop()
    # the server and the resource tracker beside it are gone
    assert _children() <= before


def _child(tmp_path, server, arg, **kw):
    (tmp_path / "fork_child.py").write_text(CHILD)
    env = {"FORK_TEST": "yes", "PYTHONPATH": str(tmp_path)}
    return server.popen([sys.executable, "-u", "-m", "fork_child", arg],
                        env=env, cwd=str(tmp_path), **kw)


def test_a_forked_child_runs_its_command(tmp_path, server):
    err = open(tmp_path / "err.txt", "w")
    p = _child(tmp_path, server, "3", stdout=subprocess.PIPE, stderr=err,
               text=True)
    lines = [line.strip() for line in p.stdout]
    assert p.wait(60) == 3 and p.returncode == 3
    err.close()
    assert lines == ["ARGS ['3']", f"ENV yes {tmp_path}", "TORCH True"]
    assert (tmp_path / "err.txt").read_text() == "to stderr\n"
    p = _child(tmp_path, server, "raise", stdout=subprocess.DEVNULL,
               stderr=subprocess.DEVNULL)
    assert p.wait(60) == 1


def test_signals_and_waits(tmp_path, server):
    p = _child(tmp_path, server, "sleep", stdout=subprocess.DEVNULL,
               stderr=subprocess.DEVNULL)
    with pytest.raises(subprocess.TimeoutExpired):
        p.wait(0.3)
    assert p.poll() is None
    p.kill()
    assert p.wait(30) == -signal.SIGKILL
    q = _child(tmp_path, server, "sleep", stdout=subprocess.DEVNULL,
               stderr=subprocess.DEVNULL)
    q.terminate()
    assert q.wait(30) == -signal.SIGTERM


def test_the_childs_sitecustomize_and_atexit_run(tmp_path, server):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE)
    (tmp_path / "fork_child.py").write_text(CHILD)
    marker = tmp_path / "exit.txt"
    p = server.popen([sys.executable, str(tmp_path / "fork_child.py"), "0"],
                     env={"PYTHONPATH": str(site),
                          "FORK_AT_EXIT": str(marker)},
                     stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    assert p.wait(60) == 0
    assert marker.read_text() == "ran"
    with pytest.raises(ValueError):
        server.popen([sys.executable, "-c", "pass"])


def test_the_ports_modules_read_the_childs_environment(tmp_path, server):
    """Nothing of the port is imported before the child's environment is
    set: its flags take their values from it."""
    (tmp_path / "flag_child.py").write_text(textwrap.dedent('''
        import sys
        print("PRELOADED", "paddle_tpu_torch" in sys.modules)
        from paddle_tpu_torch.framework.flags import flag_value
        print("FLAG", flag_value("FLAGS_compile_cache_dir"))
    '''))
    p = server.popen([sys.executable, "-m", "flag_child"],
                     env={"PYTHONPATH": str(tmp_path) + os.pathsep + REPO,
                          "FLAGS_compile_cache_dir": str(tmp_path / "cc")},
                     cwd=str(tmp_path), stdout=subprocess.PIPE, text=True,
                     stderr=subprocess.DEVNULL)
    lines = [line.strip() for line in p.stdout]
    assert p.wait(60) == 0
    assert lines == ["PRELOADED False", f"FLAG {tmp_path / 'cc'}"]


def test_a_forked_stub_worker_serves_behind_the_router(tmp_path, server):
    fac = pfleet.ProcessReplicaFactory(
        extra_args=["--stub", "--stub-device-ms", "1"],
        env={"PYTHONPATH": REPO + os.pathsep +
             os.environ.get("PYTHONPATH", "")},
        announce_dir=str(tmp_path), forkserver=server)
    sup = pfleet.ReplicaSupervisor(fac, 1, name="t_fork").start()
    router = pfleet.FleetRouter(supervisor=sup, name="t_fork", start=False)
    try:
        assert router.wait_ready(1, timeout=120)
        assert server.launches >= 1
        x = np.full((2, 4), 1.5, np.float32)
        scale = pfleet.StubBackend._scale_of("v0")
        np.testing.assert_array_equal(router.submit([x]).result(60)[0],
                                      x * scale)
        proc = sup._managed[0].proc
        t0 = time.monotonic()
        proc.kill()
        assert proc.wait(30) == -signal.SIGKILL
        assert time.monotonic() - t0 < 30
    finally:
        router.shutdown()
        sup.stop()
