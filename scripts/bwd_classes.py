#!/usr/bin/env python3
"""The DGCNN backward kernels' row classes on one card.

    python3 scripts/bwd_classes.py [--sweep] [--json PATH]

  build   one `nvcc -Xptxas -v` a row class of `csrc/dgcnn_bwd.cu`
          (`dgcnn_bwd_k<KP>`, all started together, as `ops/dispatch.py`
          builds them): the seconds of each and of all, and ptxas's
          registers and spill bytes of each kernel of each class
  sweep   every k from 1 to 32 (the class of each), bf16 and float32: the
          five backward calls (reduce, stages 4, 3, 2, edge) on seeded
          inputs of B = 3 clouds at N = k, 37 and 300 points, each kernel
          against its plain version under chip_smoke.py's LIM_BWD_* limits
          and launched twice (bit for bit); also a case where every real
          row's h is 0 and beta > 0 (a padded row of z = 0 would win the
          argmax and the sums if the kernels did not mask it)

Prints one JSON line of the results (also written to PATH with --json),
then the card's name and power limit. Needs one CUDA device and nvcc.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from ab_trees import build_ptxas, card  # noqa: E402

from ogmm_tpu_torch.ops import cuda_dgcnn_bwd as bwd  # noqa: E402
from ogmm_tpu_torch.ops import dispatch  # noqa: E402

LIM_F32, LIM_DZ_BF16, LIM_SUM_BF16 = 1e-4, 2.0 ** -6, 2e-2   # chip_smoke.py
STAGES = ((256, 128, 0), (128, 64, 256), (64, 64, 128))


def build():
    """Each class's library with ptxas's report, timed; {name: {...}}."""
    res, total = build_ptxas(dispatch, list(dispatch.VARIANTS))
    print(f"built {len(res)} classes in {total:.1f} s: "
          + ", ".join(f"{n} {r['seconds']} s" for n, r in res.items()))
    for name, r in res.items():
        for kern, v in r["kernels"].items():
            if "stage" in kern or "edge" in kern or "reduce" in kern:
                print(f"  {name} {kern[:70]}: {v}")
    return {"seconds": round(total, 1), "classes": res}


def _stage_inputs(g, B, k, N, C, dt, dead=False):
    z = (g(B, k, N, C) * 0.7 + g(C) * 0.2).to(dt)
    zf = z.float()
    mean, var = zf.mean((0, 1, 2)), zf.var((0, 1, 2), unbiased=False)
    gamma = torch.rand(C, device="cuda") + 0.5
    beta = g(C) * 0.1
    if dead:
        # the first 8 channels: every real row's BN output (-12 + 10) gamma
        # + 0.5 < 0 (h = 0), while a row of z = 0 would give 10 gamma + 0.5
        z[..., :8] = -12.0
        mean[:8], var[:8], beta[:8] = -10.0, 1.0 - 1e-5, 0.5
    dtap = (g(B, N, C) * 0.1).to(dt)
    return z, dtap, mean, var, gamma, beta


def _calls(g, B, k, N, dt, dead=False):
    """The five calls' arguments on seeded inputs: (name, args, kwargs)."""
    st = {C: _stage_inputs(g, B, k, N, C, dt, dead) for C in (256, 128, 64)}
    st1 = _stage_inputs(g, B, k, N, 64, dt, dead)
    w = lambda a, b: g(a, b) / np.sqrt(a)
    calls = [("bwd_reduce", st[256], {})]
    ws = {256: w(128, 256), 128: w(64, 128), 64: w(64, 64)}
    for C, cin, cn in STAGES:
        prev = st1 if C == 64 else st[cin]
        s12 = g(2, C) * 3
        dzn = (g(B, k, N, cn) * 0.05).to(dt) if cn else None
        calls.append(("bwd_stage", (*st[C], s12, ws[C], prev[0], *prev[2:], prev[1]),
                      dict(dznext=dzn, wnext=ws[cn] if cn else None)))
    e = (g(B, k, N, 6) * 0.3).to(dt)
    idx = torch.randint(0, N, (B, N, k), device="cuda", dtype=torch.int32)
    calls.append(("bwd_edge", (*st1, g(2, 64) * 3, (g(B, k, N, 64) * 0.05).to(dt),
                               w(64, 64), e, w(6, 64), idx), {}))
    return calls


FNS = {"bwd_reduce": (bwd.bwd_reduce, bwd.bwd_reduce_reference),
       "bwd_stage": (bwd.bwd_stage, bwd.bwd_stage_reference),
       "bwd_edge": (bwd.bwd_edge, bwd.bwd_edge_reference)}


def _outs(out):
    return [out] if torch.is_tensor(out) else list(out)


def sweep():
    """Every k at three N, both dtypes: the largest error as a share of its
    limit, and whether every relaunch was bit-equal; every failure listed
    before the sweep raises."""
    worst, cases, failed = {}, 0, []
    for k in range(1, 33):
        for N in (k, 37, 300):
            for dt in (torch.float32, torch.bfloat16):
                for dead in (False, True):
                    torch.manual_seed(1000 * k + N)
                    g = lambda *s: torch.randn(*s, device="cuda")
                    tag = "f32" if dt == torch.float32 else "bf16"
                    for name, a, kw in _calls(g, 3, k, N, dt, dead):
                        kern, plain = FNS[name]
                        try:
                            got, again = _outs(kern(*a, **kw)), _outs(kern(*a, **kw))
                            torch.cuda.synchronize()
                        except RuntimeError as err:
                            failed.append((name, k, N, tag, dead, str(err)[:200]))
                            continue
                        ref = _outs(plain(*a, **kw))
                        for i, (x, x2, r) in enumerate(zip(got, again, ref)):
                            scale = max(r.float().abs().max().item(), 1e-30)
                            lim = (LIM_F32 if dt == torch.float32 else
                                   LIM_DZ_BF16 if (name == "bwd_stage" and i == 0)
                                   else LIM_SUM_BF16) * scale
                            share = (x.float() - r.float()).abs().max().item() / lim
                            key = f"{name}[{i}] {tag}"
                            if not share <= worst.get(key, (0.0,))[0]:
                                worst[key] = (share, k, N, dead)
                            if not (share <= 1.0 and torch.equal(x, x2)
                                    and torch.isfinite(x.float()).all()):
                                failed.append((name, i, k, N, tag, dead, share,
                                               torch.equal(x, x2)))
                        cases += 1
    print(f"sweep: {cases} calls at k = 1..32, N = k, 37, 300, bf16 and float32, "
          "with and without dead channels; the largest error as a share of its "
          "limit:")
    for key, v in sorted(worst.items()):
        print(f"  {key}: {v[0]:.3g} (k={v[1]}, N={v[2]}, dead={v[3]})")
    print(f"sweep: {len(failed)} failures", *failed[:60], sep="\n  ")
    assert not failed, "the sweep failed"
    return {"calls": cases, "worst_share_of_limit": worst}


def main():
    out = {"build": build()}
    if "--sweep" in sys.argv:
        out["sweep"] = sweep()
    print(json.dumps(out))
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    print(card())


if __name__ == "__main__":
    main()
