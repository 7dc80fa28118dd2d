"""Parent against change on one card: the steady SeedFlood step and peak of
``chip_smoke.py`` phases 14 (a) (Gemma 3 1B whole, 8 clients on a ring) and
15 (the Qwen2-72B cut, 4 clients), each tree in a process of its own, in the
order parent, change, change, parent.

    git archive <parent commit> | tar -x -C _proof/parent   # git-ignored
    python _proof/pair23.py --trees _proof/parent . --out FILE.json
"""
import argparse
import json
import subprocess
import sys

CODE = """
import json, sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.configs import archs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all()
card = cs.card_line()
out = {}
for key, arch, clients, ledger in (
        ("gemma", archs.get(cs.GEMMA_ARCH), cs.SLICE_CLIENTS,
         cs.LEDGER_RING8_3STEPS),
        ("qwen2", archs.qwen2_cut(), cs.QWEN2_CLIENTS,
         cs.LEDGER_RING4_3STEPS)):
    _, o = cs.run_slice(arch, key, "pair", card, clients, ledger=ledger)
    out[key] = {k: o[k] for k in ("step_ms", "steady_step_s", "peak_gib")}
    torch.cuda.empty_cache()
print("PAIR " + json.dumps(out))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True,
                    help="the parent's tree, then the change's")
    ap.add_argument("--out", required=True, help="the numbers, as JSON")
    args = ap.parse_args()
    parent, change = args.trees
    runs = []
    for tag, tree in (("parent", parent), ("change", change),
                      ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True, check=True)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("PAIR ")][-1]
        runs.append({"tree": tag, **json.loads(line[5:])})
        print(tag, runs[-1], flush=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
