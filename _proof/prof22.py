"""Where the time goes in the Gemma 3 1B and Qwen2-72B cells, on one card:
torch.profiler over one steady step of phase 14 (a) (Gemma 3 1B, 8 clients,
T 33), of phase 14 (b) (4 clients, B 2, 641 tokens) and of phase 15 (the
Qwen2-72B cut, 4 clients), and over one steady decode step of phase 14 (c)
(8 slots, prompts of 520-700 tokens): host spans, device-busy share,
launches, top kernels (``chip_smoke.phase_profile`` / ``profile_step``).

    python _proof/prof22.py --out FILE.json   # from the repository root, ~4 min
"""
import argparse
import json
import sys

sys.path[:0] = [".", "src"]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import DecodeServer, Request, ServeConfig  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the numbers, as JSON")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    gemma, qwen2 = archs.get(cs.GEMMA_ARCH), archs.qwen2_cut()
    long_task = synthetic.TaskConfig(vocab=gemma.vocab, **cs.LONG_TASK)
    out = {"card": card}
    for key, arch, clients, batch, kw in (
            ("gemma", gemma, cs.SLICE_CLIENTS, cs.SLICE_B, {}),
            ("gemma_long", gemma, cs.LONG_CLIENTS, cs.LONG_B,
             dict(steps=cs.LONG_STEPS, task=long_task)),
            ("qwen2", qwen2, cs.QWEN2_CLIENTS, cs.SLICE_B, {})):
        out[key] = cs.phase_profile(arch, clients, batch, "cuda", **kw)
        torch.cuda.empty_cache()
        cs.log(f"[p] one steady {key} step ({card}): {out[key]}")
    params = tf.init_params(gemma, cs.SERVE_SEED, "cuda")
    srv = DecodeServer(gemma, params, ServeConfig(**cs.GEMMA_SERVE),
                       device="cuda")
    for rid, p in enumerate(cs.serve_prompts(gemma.vocab, cs.GEMMA_REQUESTS,
                                             cs.GEMMA_PROMPT)):
        srv.submit(Request(rid=rid, prompt=p, max_new=cs.SERVE_NEW))
    for _ in range(3):
        srv.step()
    out["gemma_decode"] = cs.profile_step(srv.step)
    cs.log(f"[p] one steady gemma decode step, 8 slots ({card}): "
           f"{out['gemma_decode']}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
