"""Phase 17 of ``chip_smoke.py`` alone on one card, with the phase-2 units it
adds: the kernels at the Jamba cut's shapes and at the serving shapes of
the Jamba cut and Falcon Mamba 7B, then the Jamba cut trained (17 (a)),
served (17 (b)) and Falcon Mamba 7B served whole (17 (c)), and phase 16
(b) through the shared serving check; seconds per part.

    python _proof/jamba24.py --out FILE.json   # from the repository root
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the numbers, as JSON")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    secs, out = {}, {"card": card}
    t0 = time.perf_counter()
    build.build_all()
    secs["build"] = time.perf_counter() - t0
    jamba, falcon = archs.jamba_cut(), archs.get("falcon-mamba-7b")
    t0 = time.perf_counter()
    entries = {"jamba": cs.phase_kernels_jamba(jamba, cs.JAMBA_CLIENTS,
                                               cs.SLICE_B, 33)}
    torch.cuda.empty_cache()
    for key, arch in (("jamba_serve", jamba), ("falcon_serve", falcon)):
        entries[key] = cs.phase_kernels_mamba_serve(arch, cs.MAMBA_SERVE_B,
                                                    cs.MAMBA_PROMPT)
    torch.cuda.empty_cache()
    for key, es in entries.items():
        for e in es.values():
            cs.log(f"[2] {key} {e.line()}")
    out["kernels"] = {k: {n: e.summary() for n, e in es.items()}
                      for k, es in entries.items()}
    secs["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key, (ln, dt) in cs.phase_jamba(jamba, falcon, card).items():
        out[key] = dt
    secs["phase17"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out["deepseek_serve"] = cs.serve_cached(
        cs.deepseek_serving(archs.deepseek_cut()), card, "16b",
        cs.DEEPSEEK_SERVE_B, cs.DEEPSEEK_PROMPT, cs.DEEPSEEK_NEW)
    secs["16b"] = time.perf_counter() - t0
    out["seconds"] = secs
    cs.log(f"seconds {secs}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
