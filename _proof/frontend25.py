"""Phase 18 of ``chip_smoke.py`` alone on one card, with the phase-2 units
and the phase-8 half it adds: the kernels at MusicGen-medium's shapes (8
clients) and at the InternVL2-26B cut's pod shapes (8 clients sharing one
model; the projector's unit apart), the reduced frontend archs card
against CPU, then phase 18 (a)-(d); seconds per part.

    python _proof/frontend25.py --out FILE.json   # from the repository root
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
    musicgen, internvl = archs.get(cs.MUSICGEN_ARCH), archs.internvl_cut()
    t0 = time.perf_counter()
    entries = {"musicgen": cs.phase_kernels_dense(musicgen, cs.SLICE_CLIENTS,
                                                  cs.SLICE_B * 33, 8,
                                                  "musicgen")}
    torch.cuda.empty_cache()
    entries.update({"internvl_" + k: es for k, es in cs.phase_kernels_pod(
        internvl, cs.POD_CLIENTS, cs.POD_B, cs.POD_TEXT).items()})
    torch.cuda.empty_cache()
    for key, es in entries.items():
        for e in es.values():
            cs.log(f"[2] {key} {e.line()}")
    out["kernels"] = {k: {n: e.summary() for n, e in es.items()}
                      for k, es in entries.items()}
    secs["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.phase_small_frontend()
    secs["small"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key, (ln, dt) in cs.phase_frontend(musicgen, internvl, card).items():
        out[key] = dt
    secs["phase18"] = time.perf_counter() - t0
    out["seconds"] = secs
    cs.log(f"seconds {secs}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
