"""The lock across processes of the port's builds (`ogmm_tpu_torch/buildlock.py`):
several processes that find a library missing at once run the compiler
once between them, and every one loads the result. A fake compiler on PATH
(a script that counts its runs and builds a small real shared library with
the system's g++) stands in for `nvcc` and for the host library's `g++`;
the processes point the build directory at a temporary one."""
import os
import stat

import pytest

from ogmm_tpu_torch.parallel.launch import run_ranks

import torch_dist_cases as cases

WORLD = 4


def _fake_compiler(tmp_path, name):
    """A `name` on PATH that appends a line to runs.log, sleeps (so that
    the processes overlap), and compiles a one-function library to the
    path after -o with the real g++."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    stub = tmp_path / "stub.cc"
    stub.write_text('extern "C" int ogmm_fake(void) { return 7; }\n')
    script = bindir / name
    script.write_text(
        "#!/bin/sh\n"
        f"echo run >> {tmp_path}/runs.log\n"
        "sleep 1\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'exec /usr/bin/g++ -shared -fPIC -o "$out" {stub}\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return bindir


@pytest.mark.parametrize("which", ["kernels", "host"])
def test_one_build_runs_and_every_process_loads_it(tmp_path, monkeypatch,
                                                   which):
    if not os.path.exists("/usr/bin/g++"):
        pytest.skip("needs the system g++ to build the fake library")
    bindir = _fake_compiler(tmp_path, "nvcc" if which == "kernels" else "g++")
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    build = tmp_path / "build"
    res = run_ranks(cases.build_case, WORLD, args=(which, str(build)),
                    timeout=120)
    runs = (tmp_path / "runs.log").read_text().split()
    assert len(runs) == 1, runs
    assert res == [7] * WORLD
    libs = [p.name for p in build.iterdir() if p.suffix == ".so"]
    assert len(libs) == 1 and not any(p.suffix == ".tmp"
                                      for p in build.iterdir())
