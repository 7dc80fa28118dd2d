"""Fused rank-1 perturbed forward machinery.

The counterpart of ``repro/models/perturb.py``.  A client's ZO forward
differs from the plain one only by its SubCGE perturbation, rank-1 per 2D
leaf: ``W_eff = W + s·u v^T`` with ``u = U[:, i]``, ``v = V[:, j]``.  The
rank-1 term is fused into each matmul (``kernels.ops.rank1_matmul``):

    x (W + s u v^T)  =  x W  +  s · (x u) v^T

Port conventions: parameters, coordinates and dense Gaussians carry a
leading client axis C (JAX introduces it with ``vmap``); the shared
subspace has none.  Everything is keyed by the JAX path strings, flat —
the port needs no nested trees.  ``pert=None`` gives the plain forward.

Types.  The subspace, the coordinates' columns u and v, the scale and the
dense Gaussians are float32; a perturbed leaf of another type (bf16
parameters) takes them as the reference does: the fused products read u,
v and s as float32 (the kernels' operands), while the embedding's rank-1
term, ``matw`` and ``vec`` cast each operand to the leaf's type first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import seeds as seedlib
from repro_torch.core import subcge
from repro_torch.core.subcge import LeafMeta, SubCGEConfig
from repro_torch.kernels import ops as kops


class Pert(NamedTuple):
    """All clients' perturbations for one forward."""
    ij: dict      # path -> (i, j), each (C, *batch_shape) int32
    zv: dict      # path -> (C, *shape) float32 dense Gaussian (vector leaves)
    scale: float  # ±ε (the dual forward flips the sign)

    def with_scale(self, s: float) -> "Pert":
        return Pert(self.ij, self.zv, float(s))


def sample_pert(meta: dict[str, LeafMeta], cfg: SubCGEConfig,
                message_seeds: torch.Tensor, scale: float) -> Pert:
    """RNG_S for each client's message seed (``message_seeds`` (C,)).  A
    frozen leaf gets neither coordinates nor a Gaussian, so ``Bundle``
    reads it unperturbed (a frozen matrix through the plain product)."""
    coords = subcge.sample_coords(meta, cfg, message_seeds)
    key = seedlib.message_key(message_seeds)
    zv = {}
    for path in seedlib.path_order(meta):
        m = meta[path]
        if not (m.frozen or m.is_matrix):
            zv[path] = seedlib.gaussian_like(seedlib.leaf_key(key, path),
                                             m.shape)
    return Pert(coords, zv, float(scale))


def epoch_subspace(meta: dict[str, LeafMeta], cfg: SubCGEConfig,
                   global_seed: int, step: int, device="cpu") -> dict:
    """The shared (U, V) per matrix leaf for the τ-epoch governing ``step``.
    A message's coordinates and Gaussians depend on its seed alone, so this
    subspace, regenerated at the SENDER's epoch, is all a replay needs."""
    return subcge.subspace_at_step(meta, cfg, global_seed, step, device)


class Bundle:
    """Params + subspace + perturbation view of one layer (or the embed
    block): ``prefix`` selects the leaves (``"g0/s0/"``), ``layer`` the
    index into their stacked layer axis (None for unstacked leaves)."""

    __slots__ = ("p", "sub", "pert", "prefix", "layer")

    def __init__(self, params: dict, sub: dict | None, pert: Pert | None,
                 prefix: str, layer: int | None = None):
        self.p = params
        self.sub = sub
        self.pert = pert
        self.prefix = prefix
        self.layer = layer

    def _leaf(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.layer is None else t[:, self.layer]

    def _rank1(self, k: str):
        """(u (C, *inst, rows), v (C, *inst, cols), s (C,)) for a perturbed
        leaf, else None: each client's canonical columns gathered from the
        shared subspace.  Residual instance dims (experts) come before the
        row, where the JAX package puts them last (``u (rows, E)``)."""
        path = self.prefix + k
        if self.pert is None or self.sub is None or path not in self.pert.ij:
            return None
        i, j = (self._leaf(c) for c in self.pert.ij[path])
        U, V = self.sub[path]
        u = U.t()[i.long()]
        v = V.t()[j.long()]
        s = torch.full((u.shape[0],), self.pert.scale, dtype=torch.float32,
                       device=u.device)
        return u, v, s

    def dense(self, k: str, x: torch.Tensor, bias: str | None = None):
        """y = x @ W (+b) per client; x (C, ..., n), W (C, n, m).  Perturbed:
        one ``rank1_matmul`` launch for all clients."""
        W = self.raw(k)
        r1 = self._rank1(k)
        C, n = x.shape[0], x.shape[-1]
        if r1 is not None:
            y = kops.rank1_matmul(x.reshape(C, -1, n).contiguous(), W, *r1)
            y = y.reshape(x.shape[:-1] + (W.shape[-1],))
        else:
            y = torch.bmm(x.reshape(C, -1, n), W).reshape(
                x.shape[:-1] + (W.shape[-1],))
        if bias is not None:
            b = self.vec(bias)
            y = y + b.reshape((C,) + (1,) * (y.ndim - 2) + (b.shape[-1],))
        return y

    def dense_t(self, k: str, x: torch.Tensor):
        """y = x @ W^T per client (tied logits); W (C, m, n), x (C, ..., n).
        Perturbed: one ``rank1_matmul_t`` launch for all clients."""
        W = self.raw(k)
        r1 = self._rank1(k)
        C, n = x.shape[0], x.shape[-1]
        xf = x.reshape(C, -1, n).contiguous()
        if r1 is not None:
            y = kops.rank1_matmul_t(xf, W, *r1)
        else:
            y = torch.bmm(xf, W.transpose(1, 2))
        return y.reshape(x.shape[:-1] + (W.shape[-2],))

    def expert_dense(self, k: str, x: torch.Tensor):
        """y[c, e] = x[c, e] @ W[c, e] with per-expert rank-1 perturbations;
        x (C, E, cap, n), W the (C, E, n, m) view of the stacked leaf at this
        layer.  Perturbed: one ``rank1_matmul_expert`` launch for all
        clients and experts; unperturbed: a plain batched matmul (the JAX
        package leaves it to XLA outside any kernel)."""
        W = self.raw(k)
        r1 = self._rank1(k)
        if r1 is not None:
            return kops.rank1_matmul_expert(x, W, *r1)
        return torch.matmul(x, W)

    def embed(self, k: str, ids: torch.Tensor):
        """(E + s u v^T)[ids] = E[ids] + s·u[ids]·v^T; ids (C, B, T)."""
        E = self.raw(k)
        C = ids.shape[0]
        cidx = torch.arange(C, device=ids.device).reshape(
            (C,) + (1,) * (ids.ndim - 1))
        out = E[cidx, ids]
        r1 = self._rank1(k)
        if r1 is not None:
            u, v, s = (t.to(out.dtype) for t in r1)
            vb = v.reshape((C,) + (1,) * (ids.ndim - 1) + (v.shape[-1],))
            sb = s.reshape((C,) + (1,) * ids.ndim)
            out = out + (sb * u[cidx, ids][..., None]) * vb
        return out

    def matw(self, k: str) -> torch.Tensor:
        """Materialised perturbed weight ``W + s·u v^T`` per client,
        (C, rows, cols), for the small leaves (conv kernel, ``A_log``) that
        the JAX package does not fuse into a matmul either; plain PyTorch in
        the JAX order: the outer product first, then its scale."""
        W = self.raw(k)
        r1 = self._rank1(k)
        if r1 is None:
            return W
        u, v, s = r1
        z = (u[..., :, None] * v[..., None, :]).to(W.dtype)
        return W + s.to(W.dtype).reshape((-1,) + (1,) * (z.ndim - 1)) * z

    def raw(self, k: str) -> torch.Tensor:
        """The leaf as stored (C, ...) at this layer, with no perturbation:
        the JAX package's ``b.p[k]``, which MLA reads ``wukv`` through."""
        return self._leaf(self.p[self.prefix + k])

    def vec(self, k: str) -> torch.Tensor:
        """Vector leaf (C, dim) with its dense-Gaussian perturbation."""
        path = self.prefix + k
        b = self._leaf(self.p[path])
        if self.pert is None or path not in self.pert.zv:
            return b
        # the scale rounded to the leaf's type, as the reference casts it
        scale = float(torch.tensor(self.pert.scale).to(b.dtype))
        return b + scale * self._leaf(self.pert.zv[path]).to(b.dtype)
