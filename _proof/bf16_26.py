"""Phase 2's bf16 units (with the tensor-core witness), phase 19 and phase
18 (b), (c) of chip_smoke.py alone, on the card (timings of the new phases
before the whole script runs).

    python _proof/bf16_26.py --out FILE.json [k a b c pod cli]   # from the repository root
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
ap.add_argument("what", nargs="*", default=["k", "a", "b", "c", "cli"],
                help="k: phase 2's bf16 units; a, b, c: phase 19; pod: 18 (b); "
                "cli: 18 (c)")
args = ap.parse_args()
card = cs.card_line()
print("card:", card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
print("build", build.build_all(), flush=True)
for n in ("rank1_matmul", "subcge_apply", "selective_scan"):
    build.load(n)
T = {}
what = args.what
vl, qwen, jamba = (archs.get("internvl2-26b"), archs.get("qwen1.5-0.5b"),
                   archs.jamba_cut())
out = {}
if "k" in what:
    t = time.perf_counter()
    es = cs.phase_kernels_bf16(vl, qwen, jamba)
    for k, e in es.items():
        for x in e.values():
            print("[2]", k, x.line(), flush=True)
    out["kernels"] = {k: {n: x.summary() for n, x in e.items()}
                      for k, e in es.items()}
    out["witness"] = cs.WITNESS
    print("[2] tensor-core witness", json.dumps(cs.WITNESS), flush=True)
    T["k"] = time.perf_counter() - t
    torch.cuda.empty_cache()
if "a" in what:
    t = time.perf_counter()
    out["a"] = cs.bf16_internvl(vl, card)
    T["a"] = time.perf_counter() - t
if "b" in what:
    t = time.perf_counter()
    out["b"] = cs.buffer_vs_fold(qwen, card)
    T["b"] = time.perf_counter() - t
if "c" in what:
    t = time.perf_counter()
    out["c"] = cs.bf16_jamba(jamba, card)
    T["c"] = time.perf_counter() - t
if "pod" in what:
    t = time.perf_counter()
    out["pod"] = cs.pod_run(archs.internvl_cut(), card)
    T["pod"] = time.perf_counter() - t
if "cli" in what:
    t = time.perf_counter()
    out["cli"] = cs.cli_run(card)
    T["cli"] = time.perf_counter() - t
print("seconds", T, "all", time.perf_counter() - t0, flush=True)
with open(args.out, "w") as f:
    json.dump(out, f, indent=1, default=str)
