"""SubCGE — Subspace Canonical-basis Gradient Estimation (paper §3.4).

The counterpart of ``repro/core/subcge.py``.  Every 2D weight
``W ∈ R^{n×m}`` gets a shared Gaussian subspace ``U ∈ R^{n×r}``,
``V ∈ R^{m×r}`` regenerated every τ steps from the global seed; a message
perturbs one canonical coordinate ``z = U[:, i] V[:, j]^T`` per layer
instance, and K messages aggregate into ``ΔW = U A V^T`` with
``A = Σ_k α_k E_{i_k j_k}``.  Non-2D leaves take a dense Gaussian.

Port conventions (where JAX would ``vmap``): parameters are a flat dict of
tensors stacked on a leading client axis ``C``; message seeds, coefficients
and sender steps are ``(C, K)`` matrices, one row per client.  Updates are
applied in place — the counterpart of the JAX package's donated buffers.
Parameters may be float32 or bf16: subspaces, coefficients, A and the
buffers stay float32, and an update reaches a leaf as the reference's does
(a matrix through ``subcge_apply``: ``f32(W) + U A V^T`` cast once; a
vector leaf: ``leaf + upd.astype(leaf.dtype)``).
A frozen leaf (``LeafMeta.frozen``: a stub frontend's weights) takes no
perturbation and no update on any path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng, seeds as seedlib
from repro_torch.core.messages import pad_pow2
from repro_torch.kernels import ops as kops


class UV(NamedTuple):
    U: torch.Tensor  # (rows, r)
    V: torch.Tensor  # (cols, r)


class IJ(NamedTuple):
    i: torch.Tensor  # (*seed_shape, *batch_dims) int32
    j: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """Static description of one parameter leaf: ``n_batch_dims`` leading
    dims are layer instances; an unfrozen leaf is a SubCGE matrix iff the
    rest is 2D (otherwise it takes a dense Gaussian); a frozen one takes
    neither."""
    shape: tuple[int, ...]
    n_batch_dims: int = 0
    frozen: bool = False

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.shape[: self.n_batch_dims]

    @property
    def inst_shape(self) -> tuple[int, ...]:
        return self.shape[self.n_batch_dims:]

    @property
    def is_matrix(self) -> bool:
        return not self.frozen and len(self.inst_shape) == 2


def infer_meta(params: dict, n_batch_dims_fn=None,
               frozen_fn=None) -> dict[str, LeafMeta]:
    """LeafMeta of every leaf of a flat path-keyed dict of one model's
    tensors (no client axis).  By default a leaf of ndim >= 2 is a matrix on
    its last two dims with everything before them batch dims;
    ``n_batch_dims_fn(path, leaf)`` overrides that, and ``frozen_fn(path)``
    marks frozen leaves."""
    meta = {}
    for path, leaf in params.items():
        nb = (n_batch_dims_fn(path, leaf) if n_batch_dims_fn is not None
              else max(0, leaf.ndim - 2))
        frz = bool(frozen_fn(path)) if frozen_fn is not None else False
        meta[path] = LeafMeta(tuple(leaf.shape), nb, frz)
    return meta


def update_shapes(meta: dict[str, LeafMeta], n_clients: int) -> list:
    """(batch, n, m, count) of every matrix leaf that one update of the
    stacked ``n_clients``-client params visits (``apply_messages``,
    ``apply_messages_epoch``): batch is (clients, *layer instances), and
    ``count`` leaves of the same shape are merged into one entry."""
    out: dict[tuple, int] = {}
    for m in meta.values():
        if m.is_matrix:
            key = ((n_clients,) + m.batch_shape, *m.inst_shape)
            out[key] = out.get(key, 0) + 1
    return [(b, n, mm, k) for (b, n, mm), k in out.items()]


@dataclasses.dataclass(frozen=True)
class SubCGEConfig:
    rank: int = 32
    refresh_period: int = 1000   # τ
    eps: float = 1e-3            # perturbation scale ε


# ---------------------------------------------------------------------------
# subspaces and coordinates
# ---------------------------------------------------------------------------

def refresh_step(step: int, cfg: SubCGEConfig) -> int:
    """The refresh step governing ``step``: τ·⌊t/τ⌋."""
    return (int(step) // cfg.refresh_period) * cfg.refresh_period


def make_subspace(meta: dict[str, LeafMeta], cfg: SubCGEConfig,
                  global_seed: int, step: int, device="cpu"):
    """path -> (U (rows, r), V (cols, r)) for every matrix leaf, generated
    at refresh step ``step`` (identical on every client)."""
    out = {}
    for path in seedlib.path_order(meta):
        m = meta[path]
        if not m.is_matrix:
            continue
        rows, cols = m.inst_shape
        ku, kv = prng.split(seedlib.subspace_key(global_seed, step, path,
                                                 device)).unbind(-2)
        out[path] = UV(prng.normal(ku, (rows, cfg.rank)),
                       prng.normal(kv, (cols, cfg.rank)))
    return out


def subspace_at_step(meta, cfg: SubCGEConfig, global_seed: int, step: int,
                     device="cpu"):
    return make_subspace(meta, cfg, global_seed, refresh_step(step, cfg),
                         device)


def sample_coords(meta: dict[str, LeafMeta], cfg: SubCGEConfig,
                  message_seeds: torch.Tensor):
    """RNG_S for a tensor of message seeds: path -> (i, j), each of shape
    ``message_seeds.shape + batch_shape`` (int32)."""
    key = seedlib.message_key(message_seeds)
    out = {}
    for path in seedlib.path_order(meta):
        m = meta[path]
        if m.is_matrix:
            out[path] = IJ(*seedlib.coord_sample(
                seedlib.leaf_key(key, path), m.batch_shape, cfg.rank))
    return out


def _outer_from_coords(uv: UV, ij: IJ) -> torch.Tensor:
    """z = U[:, i] ⊗ V[:, j] for every index of ``ij``: (*ij, rows, cols)."""
    u = uv.U[:, ij.i.long()].movedim(0, -1)
    v = uv.V[:, ij.j.long()].movedim(0, -1)
    return u[..., :, None] * v[..., None, :]


def materialize_z(params: dict, meta: dict[str, LeafMeta], cfg: SubCGEConfig,
                  subspace: dict, message_seeds: torch.Tensor) -> dict:
    """The full perturbation z of each client's message (RNG_S of
    Algorithm 1): ``message_seeds`` (C,), leaves (C, *shape).

    Matrix leaves: canonical-coordinate rank-1 outer products.  Other
    leaves: the dense Gaussian of the message seed (drawn in float32 and
    cast, as ``apply_messages`` draws it).  Frozen leaves: zeros.  For the
    simulator and tests only: the training paths never materialise z (the
    rank-1 term is fused into the products)."""
    coords = sample_coords(meta, cfg, message_seeds)
    key = seedlib.message_key(message_seeds)
    out = {}
    for path in seedlib.path_order(params):
        m, leaf = meta[path], params[path]
        if m.frozen:
            out[path] = torch.zeros_like(leaf)
        elif m.is_matrix:
            out[path] = _outer_from_coords(subspace[path],
                                           coords[path]).to(leaf.dtype)
        else:
            out[path] = seedlib.gaussian_like(seedlib.leaf_key(key, path),
                                              m.shape).to(leaf.dtype)
    return out


# ---------------------------------------------------------------------------
# aggregation: scatter into A, apply U A V^T (paper eq. 10)
# ---------------------------------------------------------------------------

def scatter_A(i: torch.Tensor, j: torch.Tensor, coefs: torch.Tensor,
              rank: int) -> torch.Tensor:
    """Σ_k coef_k · E_{i_k j_k} per client and layer instance.

    i, j  : (C, K, *B) int — coordinates of K messages per client
    coefs : (C, K) float32
    returns (C, *B, rank, rank)

    Deterministic: messages are added one at a time in k order (the order
    the JAX scatter-add sums duplicates in); within one k every (client,
    instance) row receives exactly one index, so no two adds collide.
    """
    C, K = i.shape[:2]
    B = tuple(i.shape[2:])
    nb = int(np.prod(B, dtype=np.int64))
    A = torch.zeros((C, nb, rank * rank), dtype=torch.float32,
                    device=coefs.device)
    flat = (i.long() * rank + j.long()).reshape(C, K, nb, 1)
    for k in range(K):
        A.scatter_add_(2, flat[:, k],
                       coefs[:, k, None, None].expand(C, nb, 1).contiguous())
    return A.reshape((C,) + B + (rank, rank))


def apply_A(leaf: torch.Tensor, uv: UV, A: torch.Tensor) -> torch.Tensor:
    """leaf + U A V^T over the leaf's leading axes, through ``subcge_apply``
    (a new tensor; the leaf is left as it was)."""
    return kops.subcge_apply(leaf, uv.U, A, uv.V)


def delta_from_A(uv: UV, A: torch.Tensor, dtype) -> torch.Tensor:
    """U A V^T alone, in ``dtype`` (``kernels.ops.subcge_delta``)."""
    return kops.subcge_delta(uv.U, A, uv.V, dtype)


def _vector_update(path: str, m: LeafMeta, message_seeds: torch.Tensor,
                   coefs: torch.Tensor) -> torch.Tensor:
    """Σ_k coef_k · N(seed_k) for a dense-Gaussian leaf, accumulated in
    message order as the JAX ``lax.scan`` does: (C, *shape) float32."""
    C, K = message_seeds.shape
    keys = seedlib.leaf_key(seedlib.message_key(message_seeds), path)
    acc = torch.zeros((C,) + m.shape, dtype=torch.float32,
                      device=coefs.device)
    bshape = (C,) + (1,) * len(m.shape)
    for k in range(K):
        z = seedlib.gaussian_like(keys[:, k], m.shape)
        acc = acc + coefs[:, k].reshape(bshape) * z
    return acc


def apply_messages(params: dict, meta: dict[str, LeafMeta],
                   cfg: SubCGEConfig, subspace: dict,
                   message_seeds: torch.Tensor, coefs: torch.Tensor) -> dict:
    """Apply K seed-scalar messages per client, in place.

    ``message_seeds`` (C, K) uint32 values (int64), ``coefs`` (C, K) float32
    already carrying the -η·α/n convention.  Matrix leaves: one scatter and
    one fused ``subcge_apply`` over every client and layer instance.
    """
    coords = sample_coords(meta, cfg, message_seeds)
    cf = coefs.float()
    for path in seedlib.path_order(meta):
        m = meta[path]
        if m.frozen:
            continue
        if m.is_matrix:
            i, j = coords[path]
            A = scatter_A(i, j, cf, cfg.rank)
            U, V = subspace[path]
            kops.subcge_apply(params[path], U, A, V, inplace=True)
        else:
            params[path] += _vector_update(path, m, message_seeds,
                                           cf).to(params[path].dtype)
    return params


# ---------------------------------------------------------------------------
# epoch-correct replay: apply each message under ITS SENDER's subspace
# ---------------------------------------------------------------------------

#: Sentinel for unused epoch slots (matches no real refresh step).
EPOCH_PAD = -1


def epoch_slots(steps, cfg: SubCGEConfig, minimum: int = 1) -> np.ndarray:
    """Host-side: the distinct refresh steps governing a batch of sender
    steps, padded with :data:`EPOCH_PAD` to a power-of-two length.
    Negative entries (payload padding) are ignored."""
    steps = np.asarray(steps)
    tau = int(cfg.refresh_period)
    valid = steps[steps >= 0]
    uniq = np.unique((valid // tau) * tau).astype(np.int32)
    out = np.full(pad_pow2(uniq.size, minimum), EPOCH_PAD, np.int32)
    out[:uniq.size] = uniq
    return out


def apply_messages_epoch(params: dict, meta: dict[str, LeafMeta],
                         cfg: SubCGEConfig, global_seed: int,
                         message_seeds: torch.Tensor, coefs: torch.Tensor,
                         steps: torch.Tensor, epochs) -> dict:
    """Apply K messages per client, each under the subspace of its SENDER's
    τ-epoch, in place.

    message_seeds, coefs, steps : (C, K); zero coefficients are exact no-ops
    epochs : refresh-step slots from :func:`epoch_slots`; every live
             message's epoch must appear there.  Padding slots carry no
             message, so no subspace is generated for them.

    Matrix leaves: one scatter per live epoch and ONE fused
    ``subcge_apply_epochs`` visit of each weight for all epochs.  Dense
    Gaussian leaves depend on the seed only and are applied once.
    """
    dev = coefs.device
    coords = sample_coords(meta, cfg, message_seeds)
    cf = coefs.float()
    tau = cfg.refresh_period
    msg_epoch = torch.div(steps.long(), tau, rounding_mode="floor") * tau
    live = [int(e) for e in np.asarray(epochs) if int(e) != EPOCH_PAD]
    slot_coefs = [torch.where(msg_epoch == e, cf, torch.zeros_like(cf))
                  for e in live]
    slot_subs = [make_subspace(meta, cfg, global_seed, e, dev) for e in live]
    for path in seedlib.path_order(meta):
        m = meta[path]
        if m.frozen:
            continue
        if m.is_matrix:
            if not live:
                continue
            i, j = coords[path]
            A = torch.stack([scatter_A(i, j, c_e, cfg.rank)
                             for c_e in slot_coefs])
            U = torch.stack([sub[path][0] for sub in slot_subs])
            V = torch.stack([sub[path][1] for sub in slot_subs])
            kops.subcge_apply_epochs(params[path], U, A, V, inplace=True)
        else:
            params[path] += _vector_update(path, m, message_seeds,
                                           cf).to(params[path].dtype)
    return params


# ---------------------------------------------------------------------------
# buffer mode (paper Appendix A): accumulate A, fold lazily
# ---------------------------------------------------------------------------
#
# The matrix leaves' updates accumulate as float32 coordinates in r×r
# A-buffers and reach W only when folded, W ← W + U A V^T under the subspace
# they accumulated against (before a τ-refresh): a bf16 W then takes one
# rounding per fold instead of one per step, where a step's −lr/n·α·UAV^T
# is mostly lost.  The forward reads the effective weights W + U A V^T.

def apply_vector_messages(params: dict, meta: dict[str, LeafMeta],
                          cfg: SubCGEConfig, message_seeds: torch.Tensor,
                          coefs: torch.Tensor) -> dict:
    """Apply K messages per client to the NON-matrix leaves only, in place
    (buffer mode keeps the matrix updates in A-buffers; the paper's App. A
    follows MeZO directly for 1D tensors, so they apply at once)."""
    cf = coefs.float()
    for path in seedlib.path_order(meta):
        m = meta[path]
        if m.frozen or m.is_matrix:
            continue
        params[path] += _vector_update(path, m, message_seeds,
                                       cf).to(params[path].dtype)
    return params


def accumulate_buffers(buffers: dict, meta: dict[str, LeafMeta],
                       cfg: SubCGEConfig, message_seeds: torch.Tensor,
                       coefs: torch.Tensor) -> dict:
    """Coordinate updates only, O(K) per leaf (App. A's 'coordinate update'
    row of Table 4): a new dict of ``buffer + Σ_k coef_k E_{i_k j_k}`` per
    matrix leaf, the scatter summed in k order first, as the reference
    sums it.  ``buffers`` (C, *B, r, r), seeds and coefs (C, K)."""
    coords = sample_coords(meta, cfg, message_seeds)
    cf = coefs.float()
    out = dict(buffers)
    for path in buffers:
        i, j = coords[path]
        out[path] = buffers[path] + scatter_A(i, j, cf, cfg.rank)
    return out


def fold_buffers(params: dict, meta: dict[str, LeafMeta], subspace: dict,
                 buffers: dict, *, inplace: bool = False) -> dict:
    """W + U A V^T for every leaf that has a buffer, through
    ``subcge_apply`` in the parameters' type: a new dict (the other leaves
    shared), or the leaves themselves updated with ``inplace``.  Must run
    before any subspace refresh (a buffer is valid only against the U, V it
    accumulated under); the caller zeroes the buffers."""
    out = dict(params)
    for path, A in buffers.items():
        U, V = subspace[path]
        out[path] = kops.subcge_apply(params[path], U, A, V, inplace=inplace)
    return out


def effective_params(params: dict, meta: dict[str, LeafMeta], subspace: dict,
                     buffers: dict) -> dict:
    """Buffer mode's effective weights W + U A V^T, materialised in the
    parameters' type (a second copy of every matrix leaf; the vector leaves
    are the parameters themselves), as the reference computes them."""
    return fold_buffers(params, meta, subspace, buffers)


# ---------------------------------------------------------------------------
# beyond-paper: subspace momentum
# ---------------------------------------------------------------------------
#
# Under SubCGE every update lives in the shared r×r coefficient space, so a
# velocity μ_ℓ ∈ R^{*B,r,r} per leaf gives momentum-SGD semantics at O(r²)
# state:  μ ← β μ + A_t,  W ← W + U μ V^T.  μ is a deterministic function of
# the message stream (consensus-safe) and only meaningful within one
# subspace window: the caller resets it at τ-refresh boundaries.  Non-2D
# leaves keep plain SGD.

def zero_buffers(meta: dict[str, LeafMeta], cfg: SubCGEConfig,
                 n_models: int = 1, device="cpu") -> dict:
    """Zero float32 r×r buffers for every matrix leaf: (n_models, *B, r,
    r): buffer mode's A-buffers, or momentum's velocity."""
    return {p: torch.zeros((n_models,) + meta[p].batch_shape
                           + (cfg.rank, cfg.rank), device=device)
            for p in seedlib.path_order(meta) if meta[p].is_matrix}


def momentum_apply(params: dict, meta: dict[str, LeafMeta],
                   cfg: SubCGEConfig, subspace: dict, velocity: dict,
                   message_seeds: torch.Tensor, coefs: torch.Tensor,
                   beta: float = 0.9):
    """One momentum step from K messages per model, in place on ``params``;
    returns (params, new_velocity).

    Matrix leaves: μ ← β μ + Σ_k coef_k E_{i_k j_k};  W += U μ V^T through
    ``subcge_apply`` with the dense μ as its A.  Vector leaves: plain
    (momentum-free) application.
    """
    coords = sample_coords(meta, cfg, message_seeds)
    cf = coefs.float()
    new_vel = {}
    for path in seedlib.path_order(meta):
        m = meta[path]
        if m.frozen:
            continue
        if m.is_matrix:
            i, j = coords[path]
            mu = beta * velocity[path] + scatter_A(i, j, cf, cfg.rank)
            new_vel[path] = mu
            U, V = subspace[path]
            kops.subcge_apply(params[path], U, mu, V, inplace=True)
        else:
            params[path] += _vector_update(path, m, message_seeds,
                                           cf).to(params[path].dtype)
    return params, new_vel
