"""Phase 20 of chip_smoke.py alone, on the card: (a) MeZO's dense replay
against SubCGE at OPT-125M's full width (Fig. 5 / Table 4) and (b) the
per-client reference path beside the batched one on Qwen1.5-0.5B whole,
with each part's seconds.  ``ops`` (no card needed) counts the PyTorch
ops one chunk of ``prng.normal`` dispatches, and the elements and chunks
of one MeZO message at OPT-125M's width.

    python _proof/rest30.py --out FILE.json [a b]   # from the repository root
    python _proof/rest30.py --out FILE.json ops
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
ap.add_argument("what", nargs="*", default=["a", "b"],
                help="a: phase 20 (a); b: phase 20 (b); ops: alone, the "
                "PRNG's op count (CPU)")
args = ap.parse_args()
if args.what == ["ops"]:
    import math
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf
    key = prng.PRNGKey(torch.tensor([1]))
    prng.normal_root(key, (1000,))
    with profile(activities=[ProfilerActivity.CPU]) as pr:
        prng.normal_root(key, (1000,))
    ops = sum(1 for e in pr.events()
              if e.name.startswith("aten::") and e.cpu_parent is None)
    sizes = [math.prod(s.shape) for s in tf.arch_spec(
        archs.get("opt-125m")).values()]
    out = {"ops_per_chunk": ops, "chunk": prng._CHUNK,
           "elements": sum(sizes),
           "chunks": sum(-(-n // prng._CHUNK) for n in sizes)}
    print(out)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    sys.exit(0)
card = cs.card_line()
print("card:", card, flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
print("build", build.build_all(), flush=True)
T, out = {}, {"card": card}
if "a" in args.what:
    t = time.perf_counter()
    out["a"] = cs.phase_fig5(archs.get("opt-125m"), card)
    T["a"] = time.perf_counter() - t
if "b" in args.what:
    t = time.perf_counter()
    _, out["b"] = cs.phase_per_client(archs.get("qwen1.5-0.5b"), card)
    T["b"] = time.perf_counter() - t
out["seconds"] = T
print("seconds", T, "all", time.perf_counter() - t0, flush=True)
with open(args.out, "w") as f:
    json.dump(out, f, indent=1, default=str)
