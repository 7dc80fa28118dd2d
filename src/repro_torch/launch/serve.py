"""Serving CLI: continuous-batching decode over a paged KV cache
(repro_torch.serve).  Requests admit and evict per step, prefill scatters
into reserved pages, and decode runs one paged step per step — the same
steps the serve swarm simulator drives under churn.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --batch 4 --prompt-len 32 --new 16

``--sampling temperature --temperature 0.8`` switches to temperature
sampling (keyed per (request, position), so a run is deterministic).
``--reduced`` serves the arch's smoke variant; ``--device cpu`` runs the
plain versions on the CPU (the default is the card, and without one the
CLI raises).  Weights are random, from seed 0, in float32.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import archs
from repro_torch.core import prng
from repro_torch.launch import steps as steplib
from repro_torch.models import transformer as tf
from repro_torch.serve import SAMPLING_KINDS, DecodeServer, Request, \
    ServeConfig
from repro_torch.serve.server import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tinyllama-1.1b",
                   choices=sorted(archs.REGISTRY))
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--requests", type=int, default=None,
                   help="total requests to serve (default: --batch)")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new", type=int, default=16)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--sampling", choices=SAMPLING_KINDS, default="greedy")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = archs.get(args.arch)
    if args.reduced:
        cfg = archs.reduced(cfg)
    dev = resolve_device(args.device)

    n_req = args.requests if args.requests is not None else args.batch
    seq = args.prompt_len + args.new
    page, ppr, n_pages = steplib.paged_geometry(
        seq, args.batch, min(args.page_size, seq))
    serve = ServeConfig(max_batch=args.batch, page_size=page,
                        n_pages=n_pages, max_seq=ppr * page,
                        sampling=args.sampling,
                        temperature=args.temperature)

    params = tf.init_params(cfg, 0, dev)
    prompts = prng.randint(prng.PRNGKey(0), (n_req, args.prompt_len), 0,
                           cfg.vocab).numpy()

    srv = DecodeServer(cfg, params, serve, device=dev)
    for b in range(n_req):
        srv.submit(Request(rid=b, prompt=np.asarray(prompts[b], np.int32),
                           max_new=args.new))
    t0 = time.perf_counter()
    results = srv.run()
    dt = time.perf_counter() - t0

    emitted = sum(len(v) for v in results.values())
    print(f"{cfg.name} on {dev}: {n_req} requests x {args.new} new tokens "
          f"({args.sampling}); {emitted / dt:.1f} tok/s; "
          f"stats={srv.stats()}")
    for b in range(n_req):
        print(f"  req{b}: {results[b]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
