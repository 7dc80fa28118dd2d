"""Pod training CLI: the SeedFlood pod step (``launch.steps``) in a loop
over one model shared by ``--n-clients`` logical clients.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --steps 20 --batch 8 --seq 64 \\
        --device cpu

The synthetic ``classify`` corpus is partitioned across the clients, as
the JAX CLI partitions it; a frontend arch's batch also carries stubbed
embeddings drawn from the step (``launch.steps.make_train_batch``), so
its ``--seq`` positions are P embeddings and ``seq − P`` tokens.  The
final test accuracy is the text-only forward's.  Checkpoints (the
parameters, the step and the arch: ZO keeps no optimizer state) land in
``--ckpt-dir`` every ``--ckpt-every`` steps, in the JAX package's layout
(``repro_torch.checkpoint.ckpt``; bf16 leaves as their ``::bf16`` bits).
Parameters are bf16 unless ``--reduced``, as the JAX CLI makes them: the
pod step then runs the kernels' bf16 paths.  There is no mesh: the n
clients share one card, and their flood is the step's own sum.  The
default ``--device cuda`` raises without a card.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import archs
from repro_torch.data import synthetic
from repro_torch.dtrain.api import resolve_device
from repro_torch.launch import steps as steplib
from repro_torch.models import transformer as tf


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns the final ``params``, the step
    ``losses``, the training ``seconds``, the test ``accuracy`` and the
    ``checkpoints`` written."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tinyllama-1.1b",
                   choices=sorted(archs.REGISTRY))
    p.add_argument("--reduced", action="store_true",
                   help="reduced config (CPU-scale)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8, help="global batch")
    p.add_argument("--seq", type=int, default=64,
                   help="positions per sequence, a frontend's embeddings "
                        "included")
    p.add_argument("--n-clients", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--ckpt-dir", default=os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "seedflood_pod"))
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions); "
                        "parameters are bf16, float32 with --reduced")
    args = p.parse_args(argv)

    cfg = archs.get(args.arch)
    if args.reduced:
        cfg = archs.reduced(cfg)
    dev = resolve_device(args.device)
    pod = steplib.PodConfig(lr=args.lr, rank=args.rank,
                            n_clients=args.n_clients,
                            param_dtype=torch.float32 if args.reduced
                            else torch.bfloat16)
    shapes = steplib.train_inputs(cfg, args.seq, args.batch, pod)
    text = shapes["tokens"][-1]
    if text < 2:
        raise SystemExit(f"--seq {args.seq} leaves {text} text positions "
                         "after the frontend's embeddings (need 2)")
    step_fn = steplib.build_seedflood_train_step(cfg, pod)

    # synthetic corpus, partitioned across the logical clients
    task = synthetic.TaskConfig(vocab=cfg.vocab, seq_len=text - 1,
                                n_train=max(256, args.batch * 8))
    train, _, test = synthetic.make_splits(task)
    parts = synthetic.partition(train, args.n_clients)

    params = tf.init_params(cfg, 0, dev, pod.param_dtype)
    per_client = args.batch // args.n_clients
    # throughput timing only: data and perturbations key off (base_seed,
    # client, step), so a re-run is bit-identical
    losses, saved = [], []
    t0 = time.time()
    for step in range(args.steps):
        batch = {"tokens": torch.as_tensor(np.stack([
            synthetic.client_batch(train, parts[i], i, step, per_client)
            for i in range(args.n_clients)]), device=dev)}
        if "embeds" in shapes:
            batch["embeds"] = steplib.make_train_batch(
                cfg, args.seq, args.batch, pod, seed=step,
                device=dev)["embeds"]
        params, metrics = step_fn(params, batch, step)
        losses.append(float(metrics["loss"]))
        if step % max(1, args.steps // 10) == 0:
            print(f"step {step:>5}  loss {float(metrics['loss']):.4f}  "
                  f"alpha_rms {float(metrics['alpha_rms']):.4f}", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            path = os.path.join(args.ckpt_dir, f"step{step + 1}.npz")
            ckpt.save(path, params, {"step": step + 1, "arch": cfg.name})
            saved.append(path)
            print(f"  saved {path}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    acc = synthetic.accuracy(cfg, params, test, forward_fn=tf.forward)
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s); test accuracy {acc:.4f}")
    return {"params": params, "losses": losses, "seconds": dt,
            "accuracy": acc, "checkpoints": saved}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
