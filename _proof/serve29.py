"""Phase 2's bf16 served-fold unit, phase 12 (e) and phase 19 (a) with (d)
of chip_smoke.py alone, on the card (the new arms' numbers and seconds
before the whole script runs).

    python _proof/serve29.py --out FILE.json [k e d]   # from the repository root
"""
import argparse
import json
import sys
import time

sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--out", required=True, help="the numbers, as JSON")
ap.add_argument("what", nargs="*", default=["k", "e", "d"],
                help="k: phase 2's bf16 serve unit (and E = 2 in float32); "
                "e: phase 12 (e); d: phase 19 (a) and (d)")
args = ap.parse_args()
card = cs.card_line()
print("card:", card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
print("build", build.build_all(), flush=True)
build.load("subcge_apply")
tiny = archs.get(cs.SERVE_ARCH)
T, out = {}, {}
if "k" in args.what:
    t = time.perf_counter()
    es = {"serve": cs.phase_kernels_serve(tiny),
          "serve_bf16": cs.phase_kernels_serve(tiny, "serve bf16", True)}
    for k, e in es.items():
        for x in e.values():
            print("[2]", k, x.line(), flush=True)
    out["kernels"] = {k: {n: x.summary() for n, x in e.items()}
                      for k, e in es.items()}
    cs.phase_prng()
    T["k"] = time.perf_counter() - t
    torch.cuda.empty_cache()
if "e" in args.what:
    t = time.perf_counter()
    out["e"] = cs.phase_serve_bf16(tiny, card)
    T["e"] = time.perf_counter() - t
if "d" in args.what:
    t = time.perf_counter()
    out["d"] = cs.bf16_internvl(archs.get(cs.BF16_ARCH), card)
    T["d"] = time.perf_counter() - t
print("seconds", T, "all", time.perf_counter() - t0, flush=True)
with open(args.out, "w") as f:
    json.dump(out, f, indent=1, default=str)
