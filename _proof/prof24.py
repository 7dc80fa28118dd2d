"""Where the time goes in phase 17 of ``chip_smoke.py`` on one card:
torch.profiler over one steady SeedFlood step of 17 (a) (the Jamba cut, 3
clients on a ring, B 8, T 33) and over one decode step of 17 (b) (one
model of the Jamba cut) and of 17 (c) (Falcon Mamba 7B whole), each after
a 512-token prefill of 8 sequences: host spans, device-busy share,
launches, top kernels (``chip_smoke.phase_profile`` / ``profile_step``).

    python _proof/prof24.py --out FILE.json   # from the repository root
"""
import argparse
import json
import sys

sys.path[:0] = [".", "src"]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402


def decode_profile(arch, B: int, P: int) -> dict:
    """One steady decode step of ``arch`` (SERVE_SEED weights) after a
    P-token prefill of B sequences and three decode steps."""
    view = {k: t[None] for k, t in tf.init_params(arch, cs.SERVE_SEED,
                                                  "cuda").items()}
    prompts = torch.as_tensor(np.random.default_rng(cs.SERVE_SEED).integers(
        0, arch.vocab, (B, P)), device="cuda")
    decode = steps.build_decode_step(arch)
    with torch.no_grad():
        last, cache = steps.build_prefill_step(
            arch, B, P + cs.MAMBA_NEW)(view, prompts)
        tok = [last.argmax(-1)[:, None]]
        pos = [P]

        def one_step():
            lg, _ = decode(view, cache, tok[0], pos[0])
            tok[0], pos[0] = lg.argmax(-1)[:, None], pos[0] + 1

        for _ in range(3):
            one_step()
        out = cs.profile_step(one_step)
    del view, cache
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the numbers, as JSON")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    jamba = archs.jamba_cut()
    out = {"card": card}
    out["jamba"] = cs.phase_profile(jamba, cs.JAMBA_CLIENTS, cs.SLICE_B,
                                    "cuda")
    torch.cuda.empty_cache()
    cs.log(f"[p] one steady jamba step ({card}): {out['jamba']}")
    for key, arch in (("jamba_decode", jamba),
                      ("falcon_decode", archs.get("falcon-mamba-7b"))):
        out[key] = decode_profile(arch, cs.MAMBA_SERVE_B, cs.MAMBA_PROMPT)
        cs.log(f"[p] one {arch.name} decode step, {cs.MAMBA_SERVE_B} "
               f"sequences ({card}): {out[key]}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
