"""Where the time goes in the DeepSeek-V2 cell on one card: torch.profiler
over one steady SeedFlood step of ``chip_smoke.py`` phase 16 (a) (the
DeepSeek-V2 cut, 4 clients on a ring, B 8, T 33) and over one absorbed
decode step of phase 16 (b) (one model, 8 sequences after a 512-token
prefill into the compressed cache): host spans, device-busy share,
launches, top kernels (``chip_smoke.phase_profile`` / ``profile_step``).

    python _proof/prof23.py --out FILE.json   # from the repository root
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the numbers, as JSON")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    ds = archs.deepseek_cut()
    out = {"card": card}
    out["deepseek"] = cs.phase_profile(ds, cs.DEEPSEEK_CLIENTS, cs.SLICE_B,
                                       "cuda")
    torch.cuda.empty_cache()
    cs.log(f"[p] one steady deepseek step ({card}): {out['deepseek']}")

    arch = cs.deepseek_serving(ds)
    B, P = cs.DEEPSEEK_SERVE_B, cs.DEEPSEEK_PROMPT
    view = {k: t[None] for k, t in tf.init_params(arch, cs.SERVE_SEED,
                                                  "cuda").items()}
    prompts = torch.as_tensor(np.random.default_rng(cs.SERVE_SEED).integers(
        0, arch.vocab, (B, P)), device="cuda")
    decode = steps.build_decode_step(arch)
    with torch.no_grad():
        last, cache = steps.build_prefill_step(
            arch, B, P + cs.DEEPSEEK_NEW)(view, prompts)
        tok = [last.argmax(-1)[:, None]]
        pos = [P]

        def one_step():
            lg, _ = decode(view, cache, tok[0], pos[0])
            tok[0], pos[0] = lg.argmax(-1)[:, None], pos[0] + 1

        for _ in range(3):
            one_step()
        out["deepseek_decode"] = cs.profile_step(one_step)
    cs.log(f"[p] one absorbed deepseek decode step, {B} sequences ({card}): "
           f"{out['deepseek_decode']}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
