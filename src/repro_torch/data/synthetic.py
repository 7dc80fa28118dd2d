"""Synthetic tasks + deterministic client partitioning (the port's copy of
``repro/data/synthetic.py``).

* ``classify`` — C latent classes, class-conditional tokens, and the class
  token in the last slot; the metric is the label position's accuracy
  over the class tokens (the paper's task-performance analogue).
* ``markov``   — an order-1 Markov language; the metric is next-token
  accuracy at the last position.  Its transition matrix is vocab x vocab
  float64 on the host.

Partitions are deterministic in (seed, n_clients): uniform (the paper's
setting) or Dirichlet non-IID.  Data is made with numpy from the task seed,
bitwise the same as the JAX package's; batches move to the device at the
call site.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    kind: str = "classify"         # classify | markov
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
    labels: np.ndarray             # (N,) int32 — the last token
    task: TaskConfig

    def __len__(self) -> int:
        return self.tokens.shape[0]


def make_splits(task: TaskConfig) -> tuple[Dataset, Dataset, Dataset]:
    """Train / valid / test splits, drawn from one ``default_rng(task.seed)``
    stream in the JAX package's order."""
    rng = np.random.default_rng(task.seed)
    if task.kind == "classify":
        usable = task.vocab - task.n_classes  # class tokens live at the top
        dists = rng.dirichlet(np.full(usable, task.concentration),
                              size=task.n_classes)

        def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
            cls = rng.integers(task.n_classes, size=n)
            toks = np.stack([rng.choice(usable, size=task.seq_len, p=dists[c])
                             for c in cls]).astype(np.int32)
            label_tok = (usable + cls).astype(np.int32)
            return np.concatenate([toks, label_tok[:, None]], axis=1), label_tok
    elif task.kind == "markov":
        # sparse-ish random transition matrix, shared across splits
        P = rng.dirichlet(np.full(task.vocab, 0.05), size=task.vocab)

        def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
            toks = np.zeros((n, task.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(task.vocab, size=n)
            for t in range(1, task.seq_len + 1):
                u = rng.random((n, 1))
                cdf = np.cumsum(P[toks[:, t - 1]], axis=1)
                toks[:, t] = (u > cdf).sum(axis=1)
            return toks, toks[:, -1].copy()
    else:
        raise ValueError(f"unknown task '{task.kind}'")
    return tuple(Dataset(*sample(n), task)  # type: ignore[return-value]
                 for n in (task.n_train, task.n_valid, task.n_test))


def partition(ds: Dataset, n_clients: int, *, scheme: str = "uniform",
              dirichlet_alpha: float = 0.5, seed: int = 0) -> list[np.ndarray]:
    """Index sets per client.  ``uniform`` shuffles, then splits evenly (the
    paper's setting); ``dirichlet`` skews each client's share of every
    label (non-IID)."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    if scheme == "uniform":
        idx = rng.permutation(n)
        return [np.sort(a) for a in np.array_split(idx, n_clients)]
    if scheme == "dirichlet":
        classes = np.unique(ds.labels)
        props = rng.dirichlet(np.full(n_clients, dirichlet_alpha),
                              size=len(classes))
        owner = np.zeros(n, np.int32)
        for ci, c in enumerate(classes):
            members = np.where(ds.labels == c)[0]
            rng.shuffle(members)
            cuts = (np.cumsum(props[ci])[:-1] * len(members)).astype(int)
            for k, part in enumerate(np.split(members, cuts)):
                owner[part] = k
        return [np.sort(np.where(owner == k)[0]) for k in range(n_clients)]
    raise ValueError(f"unknown partition scheme '{scheme}'")


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
    """classify: accuracy of the label position over the class tokens;
    markov: next-token accuracy at the last position.  ``params`` has no
    client axis; ``forward_fn`` returns (logits, aux)."""
    task = ds.task
    n_cls = task.n_classes
    dev = next(iter(params.values())).device
    one = {p: t[None] for p, t in params.items()}
    correct = 0
    for i in range(0, len(ds), batch_size):
        toks = torch.as_tensor(ds.tokens[i:i + batch_size], device=dev)
        last = forward_fn(cfg, one, toks[None, :, :-1])[0][0, :, -1]
        if task.kind == "classify":
            pred = torch.argmax(last[:, task.vocab - n_cls:], dim=-1) \
                + (task.vocab - n_cls)
        else:
            pred = torch.argmax(last, dim=-1)
        labels = torch.as_tensor(ds.labels[i:i + batch_size], device=dev)
        correct += int((pred == labels).sum())
    return correct / len(ds)
