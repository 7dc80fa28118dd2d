"""Parameter specs, deterministic init, SubCGE metadata, numpy interchange.

The counterpart of ``repro/models/params.py`` without sharding.  Parameters
are a flat ``dict`` keyed by the JAX package's path strings
(``"g0/s0/wq"``): the seed derivation hashes those strings, so the same
path gives the same initial weights and the same perturbation stream on
both sides.  A model first produces a spec dict (path -> ``LeafSpec``);
everything else derives from it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import prng, seeds as seedlib
from repro_torch.core.subcge import LeafMeta


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: tuple[int, ...]
    n_batch_dims: int = 0                 # leading scan/instance dims
    init: str = "normal"                  # normal | zeros | ones | dt_bias | s4d
    scale: float | None = None            # None -> 1/sqrt(fan_in)
    frozen: bool = False                  # excluded from ZO perturbation

    @property
    def fan_in(self) -> int:
        if len(self.shape) >= 2:
            return self.shape[-2]
        return self.shape[-1]


def matrix(rows: int, cols: int, stack: tuple[int, ...] = (), **kw) -> LeafSpec:
    """A (possibly stacked) 2D weight — SubCGE's bread and butter."""
    return LeafSpec(tuple(stack) + (rows, cols), n_batch_dims=len(stack), **kw)


def vector(dim: int, stack: tuple[int, ...] = (), init: str = "zeros",
           **kw) -> LeafSpec:
    return LeafSpec(tuple(stack) + (dim,), n_batch_dims=len(stack), init=init,
                    **kw)


def init_params(specs: dict[str, LeafSpec], seed: int, device="cpu",
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Weights of ``dtype``, bitwise the JAX package's ``init_params`` on
    the CPU (same threefry streams, same float32 rounding): every leaf is
    made in float32 and cast, as the reference draws its Gaussians in
    float32 and casts them (bf16: both round to nearest even)."""
    key = prng.PRNGKey(seed, device)
    out: dict[str, torch.Tensor] = {}
    for path in seedlib.path_order(specs):
        spec = specs[path]
        if spec.init == "zeros":
            out[path] = torch.zeros(spec.shape, device=device)
        elif spec.init == "ones":
            out[path] = torch.ones(spec.shape, device=device)
        elif spec.init == "dt_bias":
            # softplus^-1(0.01) ≈ -4.6: small initial step sizes
            out[path] = torch.full(spec.shape, -4.6, device=device)
        elif spec.init == "s4d":
            # Mamba A_log: log(1..N) broadcast over channels, through XLA
            # CPU's float32 log (torch.log rounds some of them differently)
            row = prng.log_xla(torch.arange(1, spec.shape[-1] + 1,
                                            dtype=torch.float32, device=device))
            out[path] = row.expand(spec.shape).contiguous()
        elif spec.init == "normal":
            scale = (spec.scale if spec.scale is not None
                     else 1.0 / math.sqrt(spec.fan_in))
            out[path] = prng.normal(seedlib.leaf_key(key, path),
                                    spec.shape, scale, dtype)
        else:
            raise ValueError(f"{path}: init '{spec.init}' is not ported")
        out[path] = out[path].to(dtype)
    return out


def n_params(specs: dict[str, LeafSpec]) -> int:
    return sum(math.prod(s.shape) for s in specs.values())


def subcge_meta(specs: dict[str, LeafSpec]) -> dict[str, LeafMeta]:
    return {p: LeafMeta(tuple(s.shape), s.n_batch_dims, s.frozen)
            for p, s in specs.items()}


# ---------------------------------------------------------------------------
# path utilities and numpy interchange with the JAX package
# ---------------------------------------------------------------------------

def nest(flat: dict[str, Any]) -> dict[str, Any]:
    """{'a/b': x} -> {'a': {'b': x}}."""
    out: dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    """Inverse of :func:`nest`."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def from_numpy(tree: dict[str, Any], device="cpu") -> dict[str, torch.Tensor]:
    """A nested dict of arrays (e.g. the JAX package's params through
    ``np.asarray``) -> the port's flat path-keyed tensors."""
    return {p: torch.as_tensor(np.array(v), device=device)
            for p, v in flatten(tree).items()}


def to_numpy(params: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The port's flat tensors -> a nested dict of numpy arrays."""
    return nest({p: t.detach().cpu().numpy() for p, t in params.items()})
