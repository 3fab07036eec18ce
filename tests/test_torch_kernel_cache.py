"""The kernel library's build directory (``karpenter_tpu_torch/kernels.py``)
on the CPU: where a library is built and loaded from, and who builds it.

- ``Library.library_path()`` is resolved when it is asked for, not at
  import: ``KT_JIT_CACHE`` when it is set and neither empty nor ``"0"``
  (the CLI's ``--jit-cache-dir`` sets it when it is not), else
  ``karpenter_tpu_torch/_build/``;
- the library's name hashes its whole compile: a changed flag or another
  compiler version names another file;
- the warm path (``warm_startup`` / ``precompile_buckets``) loads every
  kernel library on a CUDA scheduler of backend ``auto`` or ``tpu``, and
  builds nothing on a CPU scheduler or on the oracle;
- two processes building one library into one directory at once each load
  a whole library, and the directory ends with the library alone; two
  threads of one process compile it once.  The compiler here is the host's
  C compiler on a small C source (the same ``build`` path ``nvcc`` takes
  on the card).

Tolerance: equal.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch import kernels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ROOT / "karpenter_tpu_torch" / "_build"


@pytest.fixture
def clean(monkeypatch):
    # set, then delete: the CLI writes os.environ itself, and monkeypatch
    # restores only a variable it recorded
    monkeypatch.setenv("KT_JIT_CACHE", "")
    monkeypatch.delenv("KT_JIT_CACHE")


@pytest.mark.parametrize("env,cli,where", [
    (None, None, "default"),
    ("ENV", None, "env"),
    ("0", None, "default"),
    ("", None, "default"),
    (None, "CLI", "cli"),
    ("ENV", "CLI", "env"),
    ("0", "CLI", "cli"),
    (None, "0", "default"),
    (None, "", "default"),
])
def test_library_path_follows_the_cache_settings(clean, monkeypatch,
                                                 tmp_path, env, cli, where):
    dirs = {"ENV": tmp_path / "env", "CLI": tmp_path / "cli"}
    if env is not None:
        monkeypatch.setenv("KT_JIT_CACHE", str(dirs.get(env, env)))
    if cli is not None:
        from karpenter_tpu_torch import cli as port_cli

        port_cli._jit_cache(str(dirs.get(cli, cli)))
    want = {"default": DEFAULT, "env": dirs["ENV"],
            "cli": dirs["CLI"]}[where]
    lib = kernels.PACKED_SCORE_LIB
    assert kernels.build_dir() == want
    assert lib.library_path().parent == want
    assert lib.library_path().name.startswith("libpacked_score_")


def test_the_directory_is_resolved_when_asked(clean, monkeypatch, tmp_path):
    before = kernels.PACKED_SCORE_LIB.library_path()
    monkeypatch.setenv("KT_JIT_CACHE", str(tmp_path))
    after = kernels.PACKED_SCORE_LIB.library_path()
    assert before.parent == DEFAULT and after.parent == tmp_path
    assert before.name == after.name


@pytest.mark.parametrize("change", ["flag", "compiler"])
def test_the_name_hashes_the_whole_compile(clean, monkeypatch, change):
    """A shared cache never hands one compile's library to another: a
    changed flag or another toolkit names another file."""
    lib = kernels.PACKED_SCORE_LIB
    before = lib.library_path()
    assert lib.library_path() == before
    if change == "flag":
        monkeypatch.setattr(kernels, "NVCC_FLAGS",
                            kernels.NVCC_FLAGS + ("-use_fast_math",))
    else:
        monkeypatch.setattr(kernels, "compiler_version",
                            lambda: "Cuda compilation tools, release 99.9")
    after = lib.library_path()
    assert after.parent == before.parent and after != before
    assert after.name.startswith("libpacked_score_")


def _warm(sched):
    from karpenter_tpu_torch.models.catalog import generate_catalog
    from karpenter_tpu_torch.models.provisioner import Provisioner

    return sched.precompile_buckets(
        [Provisioner(name="default").with_defaults()],
        generate_catalog(full=False), profiles=((2, 8, False),),
        mega_slots=(), wait=True, timeout=120)


class _Built(Exception):
    pass


@pytest.mark.parametrize("backend", ["tpu", "auto", "oracle"])
def test_a_cpu_warm_builds_nothing(clean, monkeypatch, backend):
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    calls = []
    monkeypatch.setattr(kernels, "build", lambda ks: calls.append(ks))
    sched = BatchScheduler(backend=backend, device="cpu")
    try:
        _warm(sched)
    finally:
        sched.stop_warms()
    assert calls == []


@pytest.mark.parametrize("backend,loads", [("tpu", True), ("auto", True),
                                           ("oracle", False)])
def test_a_card_warm_loads_every_library_first(clean, monkeypatch, backend,
                                               loads):
    """On a CUDA scheduler the warm asks for every kernel library before
    any warm solve (the build is stubbed: no card here)."""
    from karpenter_tpu_torch.solver.scheduler import BatchScheduler

    calls = []

    def build(ks):
        calls.append(list(ks))
        raise _Built

    monkeypatch.setattr(kernels, "build", build)
    sched = BatchScheduler(backend=backend, device="cpu")
    sched.device = torch.device("cuda")
    try:
        if loads:
            with pytest.raises(_Built):
                _warm(sched)
            assert calls == [kernels.ALL]
        else:
            assert _warm(sched) == 0 and calls == []
    finally:
        sched.stop_warms()


_C_SOURCE = "int answer(void) { return 42; }\n"

#: the host C compiler standing in for nvcc: slow enough that two
#: builders overlap; "-o" is where ``build`` puts its temporary file
_SLOW_CC = ["sh", "-c", 'sleep 1; exec cc -shared -fPIC -o "$2" "$3"', "sh",
            "-o"]

_CHILD = textwrap.dedent("""
    import ctypes, json, sys
    from pathlib import Path
    from karpenter_tpu_torch import kernels
    lib = kernels.Library("answer", "packed_score.cu")
    lib.source = Path(sys.argv[1])
    lib.compile_command = lambda: {cc!r} + [str(lib.library_path()),
                                           str(lib.source)]
    k = kernels.Kernel("answer", lib, "answer", [])
    kernels.build([k])
    fn = k.launcher()
    print(json.dumps({{"answer": fn(), "built": lib.build_s is not None,
                      "path": str(lib.library_path())}}))
""")


def _fake_library(src: Path, calls: list) -> "kernels.Library":
    lib = kernels.Library("answer", "packed_score.cu")
    lib.source = src

    def cmd():
        calls.append(1)
        return _SLOW_CC + [str(lib.library_path()), str(lib.source)]

    lib.compile_command = cmd
    return lib


def test_two_processes_building_at_once_each_load_a_whole_library(
        tmp_path):
    src = tmp_path / "answer.c"
    src.write_text(_C_SOURCE)
    cache = tmp_path / "cache"
    env = dict(os.environ, KT_JIT_CACHE=str(cache), PYTHONPATH=str(ROOT))
    child = _CHILD.format(cc=_SLOW_CC)
    procs = [subprocess.Popen([sys.executable, "-c", child, str(src)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [g["answer"] for g in got] == [42, 42]
    # both started before either finished, so both compiled
    assert [g["built"] for g in got] == [True, True]
    assert len({g["path"] for g in got}) == 1
    assert sorted(p.name for p in cache.iterdir()) == [
        Path(got[0]["path"]).name]


def test_two_threads_compile_once(tmp_path, clean, monkeypatch):
    src = tmp_path / "answer.c"
    src.write_text(_C_SOURCE)
    monkeypatch.setenv("KT_JIT_CACHE", str(tmp_path / "cache"))
    calls = []
    entries = [kernels.Kernel("answer", _fake_library(src, calls), "answer",
                              []) for _ in range(2)]
    errors = []

    def go(k):
        try:
            kernels.build([k])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(k,)) for k in entries]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(calls) == 1
    assert [k.launcher()() for k in entries] == [42, 42]
    assert [k.library.load_s is not None for k in entries] == [True, True]
