"""What the A/B scripts of this directory share (`dense_k_ab.py`,
`em_ab.py`, `bwd_rows_ab.py`, `f32_forms_ab.py`, and `bwd_classes.py`'s
build).

An A/B script times kernels in one or more trees of this repository (the
working tree, a parent unpacked by `git archive`), in the order given:

    python3 scripts/<script>.py _parent . . _parent

`main` runs `<script> --one TREE` in a process of its own from each tree, so
that each imports its own package and builds its own kernels, echoes the
JSON line each prints last, and ends with the card's name and power limit.
`cuda_ms` times a call with CUDA events; `build_ptxas` builds libraries of
`ogmm_tpu_torch/ops/dispatch.py` with ptxas's report of the registers and
spills of every `__global__`.
"""
import json
import os
import re
import subprocess
import sys
import time


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(script, doc, one, flags=(), summary=None):
    """The entry of an A/B script at path `script`: `--one TREE` calls
    `one(tree, *flags_given)` (a bool for each of `flags`); otherwise each
    argument but the flags is a tree, run in turn with the flags given, and
    `summary(runs)`, if given, gets the parsed last lines before the card's
    line is printed."""
    args = sys.argv[1:]
    given = [a for a in args if a in flags]
    rest = [a for a in args if a not in flags]
    if len(rest) == 2 and rest[0] == "--one":
        return one(rest[1], *(f in given for f in flags))
    if not rest:
        sys.exit(doc)
    runs = []
    for tree in map(os.path.abspath, rest):
        proc = subprocess.run([sys.executable, os.path.abspath(script), "--one", tree,
                               *given], cwd=tree, check=True, stdout=subprocess.PIPE,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    if summary is not None:
        summary(runs)
    print(card())
    return runs


def cuda_ms(fn, reps=10, rounds=3):
    """The least of `rounds` rounds of `reps` calls of fn, ms a call by CUDA
    events after one warm call, and every round's ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return min(times), times


def ptxas_report(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} of the
    `__global__`s in an `nvcc -Xptxas -v` log."""
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            kernels[current] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            kernels[current]["spill_stores"] = int(m.group(1))
            kernels[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[current]["registers"] = int(m.group(1))
    return kernels


def build_ptxas(dispatch, names):
    """Each library of `names` built where `dispatch` loads it from, one
    `nvcc -Xptxas -v` each, all started together; ({name: {"seconds",
    "kernels": ptxas_report}}, the seconds of all). Raises with the logs of
    any that failed."""
    procs, t0 = {}, time.perf_counter()
    for name in names:
        out = dispatch._lib_path(name)
        source, defines = dispatch._source(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, *defines, "-Xptxas", "-v",
               "-o", str(tmp), str(source)]
        procs[name] = (out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res, failed = {}, {}
    for name, (out, tmp, start, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed[name] = log[:3000]
            continue
        os.replace(tmp, out)
        res[name] = {"seconds": round(time.perf_counter() - start, 1),
                     "kernels": ptxas_report(log)}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{log}"
                                                      for n, log in failed.items()))
    return res, time.perf_counter() - t0
