"""The static race gate over the port: ``tools/graftrace`` run over
``ont_tcrconsensus_tpu_torch`` reports only the findings its expected list
(``tests/torch_graftrace_expected.json``) justifies, which are the JAX
package's five justified signal-path findings at the port's lines; and
``ops/_build.py`` holds its lock across no ``nvcc`` start, wait or rename,
while threads asking for the same library at once still build it once,
also when a build ends between one thread's look at the disk and its claim."""

import concurrent.futures
import json
import os
import sys
import threading
import types

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ont_tcrconsensus_tpu_torch.ops import _build  # noqa: E402
from tools.graftrace.cli import DEFAULT_EXPECT  # noqa: E402
from tools.graftrace.cli import main as graftrace_main  # noqa: E402

EXPECT = os.path.join(REPO, "tests", "torch_graftrace_expected.json")


def test_port_is_clean_modulo_its_expected_list(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc = graftrace_main(["ont_tcrconsensus_tpu_torch", "--expect", EXPECT])
    assert rc == 0, capsys.readouterr()


def test_expected_list_is_the_jax_packages_justified_five():
    """Each entry is a JAX entry at the port's path, its justification
    carried over; the port adds none of its own."""
    with open(EXPECT) as fh:
        port = json.load(fh)["findings"]
    with open(DEFAULT_EXPECT) as fh:
        jax_entries = json.load(fh)["findings"]

    def key(entry, package):
        rel = entry["path"].removeprefix(package + "/")
        return rel, entry["rule"], entry["message"].replace(package + ".", "")

    want = {key(e, "ont_tcrconsensus_tpu"): e["justification"] for e in jax_entries}
    got = {key(e, "ont_tcrconsensus_tpu_torch"): e["justification"] for e in port}
    assert got == want
    assert all(e["path"].startswith("ont_tcrconsensus_tpu_torch/") for e in port)


def test_one_nvcc_a_library_none_under_the_lock(monkeypatch, tmp_path):
    """Eight threads build every library at once, the interpreter switching
    threads often: one ``nvcc`` a library, started, waited for and renamed
    into place with the lock free."""
    starts, renames = [], []
    real_replace = os.replace

    class OwnedLock:
        """``_build._lock`` that knows which thread holds it."""

        def __init__(self):
            self._lock, self.owner = threading.Lock(), None

        def __enter__(self):
            self._lock.acquire()
            self.owner = threading.get_ident()

        def __exit__(self, *exc):
            self.owner = None
            self._lock.release()

        def mine(self):
            return self.owner == threading.get_ident()

    lock = OwnedLock()

    class FakeNvcc:
        def __init__(self, cmd, **_):
            assert not lock.mine(), "nvcc started under the lock"
            self.out = cmd[-1]
            starts.append(self.out)
            self.returncode = 0

        def communicate(self):
            assert not lock.mine(), "nvcc waited for under the lock"
            with open(self.out, "w") as fh:
                fh.write("built")
            return "ptxas info: 0 registers", None

    def replace(src, dst):
        assert not lock.mine(), "library renamed under the lock"
        renames.append(dst)
        real_replace(src, dst)

    monkeypatch.setattr(_build, "_lock", lock)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "_nvcc_command", lambda name, out: ["nvcc", "-o", out])
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.os, "replace", replace)
    n = 8
    barrier = threading.Barrier(n)
    logs, errors = [], []

    def build():
        try:
            barrier.wait(timeout=30)
            logs.append(_build.build_all())
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(starts) == len(renames) == len(_build.KERNELS)
    assert sorted(renames) == sorted(_build.library_path(k) for k in _build.KERNELS)
    # each library's report went to the thread that built it, '' to the others
    for name in _build.KERNELS:
        assert sorted(log[name] for log in logs) == [""] * (n - 1) + ["ptxas info: 0 registers"]
    # a later call finds every library in place and starts nothing
    assert set(_build.build_all().values()) == {""}
    assert len(starts) == len(_build.KERNELS)


def test_a_build_ending_between_the_check_and_the_claim_is_not_run_again(monkeypatch, tmp_path):
    """One thread is held where ``_start`` has looked for the library and
    not yet claimed its build, while another thread finishes that build.
    The held thread must take the finished build: one ``nvcc`` start and
    one ``kernel_built`` report for the library, not a second build renamed
    over the first."""
    from ont_tcrconsensus_tpu_torch.obs import device as obs_device

    name = "dovetail"
    path = os.path.join(str(tmp_path), "lib.so")
    starts, reports, errors = [], [], []
    nvcc_started, release_nvcc = threading.Event(), threading.Event()
    held, build_done = threading.Event(), threading.Event()
    held_ident = []

    class FakeNvcc:
        def __init__(self, cmd, **_):
            self.out = cmd[-1]
            starts.append(self.out)
            self.returncode = 0
            nvcc_started.set()

        def communicate(self):
            assert release_nvcc.wait(30)
            with open(self.out, "w") as fh:
                fh.write("built")
            return "ptxas info: 0 registers", None

    def holding():
        """True (once) for the held thread: it then waits for the build."""
        if held_ident == [threading.get_ident()] and not held.is_set():
            held.set()
            assert build_done.wait(30)

    real_exists = os.path.exists

    def exists(p):
        found = real_exists(p)
        if p == path:
            holding()  # between the look at the disk and the claim
        return found

    class HoldingFuture(concurrent.futures.Future):
        def result(self, timeout=None):
            holding()  # a claim seen in flight: wait on it
            return super().result(timeout)

    class FakeLib:
        def __getattr__(self, attr):
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    monkeypatch.setattr(_build, "library_path", lambda n: path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc_command", lambda n, out: ["nvcc", "-o", out])
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda p: FakeLib())
    monkeypatch.setattr(_build.os.path, "exists", exists)
    monkeypatch.setattr(_build.concurrent.futures, "Future", HoldingFuture)
    monkeypatch.setattr(obs_device, "kernel_built",
                        lambda n, s, built: reports.append((n, built)))

    def load(hold):
        try:
            if hold:
                held_ident.append(threading.get_ident())
            _build.load(name)
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    first = threading.Thread(target=load, args=(False,))
    first.start()
    assert nvcc_started.wait(30)
    waiter = threading.Thread(target=load, args=(True,))
    waiter.start()
    assert held.wait(30)
    release_nvcc.set()
    first.join(30)
    build_done.set()
    waiter.join(30)
    assert not first.is_alive() and not waiter.is_alive() and errors == []
    assert starts == [path + f".{os.getpid()}.{first.ident}.tmp"]
    assert reports == [(name, True)]


def test_a_failed_build_raises_and_can_run_again(monkeypatch, tmp_path):
    class FailingNvcc:
        def __init__(self, cmd, **_):
            self.returncode = 2

        def communicate(self):
            return "error: refused", None

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build.subprocess, "Popen", FailingNvcc)
    for _ in range(2):  # the failure releases the claim: the second call builds again
        with pytest.raises(RuntimeError, match="nvcc failed for sw_banded"):
            _build.build_all()
    assert _build._builds == {}

