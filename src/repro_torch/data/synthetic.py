"""Synthetic task + deterministic client partitioning (the port's copy of
``repro/data/synthetic.py``, uniform partition only).

Data is made with numpy from the task seed, bitwise the same as the JAX
package's; batches move to the device at the call site.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    kind: str = "classify"         # classify (the only task ported)
    vocab: int = 256
    seq_len: int = 32
    n_classes: int = 4
    n_train: int = 1024            # paper: 1,024 training samples
    n_valid: int = 500
    n_test: int = 1000
    seed: int = 0
    concentration: float = 0.3     # class-distribution peakiness


@dataclasses.dataclass
class Dataset:
    tokens: np.ndarray             # (N, T) int32 — includes the label slot
    labels: np.ndarray             # (N,) int32
    task: TaskConfig

    def __len__(self) -> int:
        return self.tokens.shape[0]


def make_splits(task: TaskConfig) -> tuple[Dataset, Dataset, Dataset]:
    """Train / valid / test splits of the classify task: C latent classes,
    class-conditional tokens, and the class token in the last slot."""
    if task.kind != "classify":
        raise ValueError(f"task '{task.kind}' is not ported")
    rng = np.random.default_rng(task.seed)
    usable = task.vocab - task.n_classes  # class tokens live at the top
    dists = rng.dirichlet(np.full(usable, task.concentration),
                          size=task.n_classes)

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        cls = rng.integers(task.n_classes, size=n)
        toks = np.stack([rng.choice(usable, size=task.seq_len, p=dists[c])
                         for c in cls]).astype(np.int32)
        label_tok = (usable + cls).astype(np.int32)
        return np.concatenate([toks, label_tok[:, None]], axis=1), label_tok

    return tuple(Dataset(*sample(n), task)  # type: ignore[return-value]
                 for n in (task.n_train, task.n_valid, task.n_test))


def partition(ds: Dataset, n_clients: int, *, seed: int = 0) -> list[np.ndarray]:
    """Uniform partition: shuffle, then split evenly (the paper's setting)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return [np.sort(a) for a in np.array_split(idx, n_clients)]


def client_batch(ds: Dataset, part: np.ndarray, client: int, step: int,
                 batch_size: int, seed: int = 0) -> np.ndarray:
    """Stateless minibatch B_{i,t}: deterministic in (client, step)."""
    rng = np.random.default_rng((seed * 1_000_003 + step) * 131 + client)
    take = rng.choice(part, size=min(batch_size, len(part)),
                      replace=len(part) < batch_size)
    return ds.tokens[take]


def stacked_batches(ds: Dataset, parts: list[np.ndarray], step: int,
                    batch_size: int, seed: int = 0) -> np.ndarray:
    """All clients' minibatches on a leading client axis: (C, B, T) int32."""
    return np.stack([client_batch(ds, parts[i], i, step, batch_size, seed)
                     for i in range(len(parts))])


@torch.no_grad()
def accuracy(cfg, params: dict, ds: Dataset, *, forward_fn,
             batch_size: int = 128) -> float:
    """Accuracy of the label position restricted to the class tokens.
    ``params`` has no client axis; ``forward_fn`` returns (logits, aux)."""
    task = ds.task
    n_cls = task.n_classes
    dev = next(iter(params.values())).device
    one = {p: t[None] for p, t in params.items()}
    correct = 0
    for i in range(0, len(ds), batch_size):
        toks = torch.as_tensor(ds.tokens[i:i + batch_size], device=dev)
        last = forward_fn(cfg, one, toks[None, :, :-1])[0][0, :, -1]
        pred = torch.argmax(last[:, task.vocab - n_cls:], dim=-1) \
            + (task.vocab - n_cls)
        labels = torch.as_tensor(ds.labels[i:i + batch_size], device=dev)
        correct += int((pred == labels).sum())
    return correct / len(ds)
