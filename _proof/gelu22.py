"""Where the gelu decoder's SeedFlood gap to the JAX package comes from (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python _proof/gelu22.py      # ~2 min

1. XLA CPU's float32 ``tanh`` against a copy in torch (Eigen's rational
   approximation clamped at +-7.99881172180175781, numerator and
   denominator by Horner with fused multiply-adds emulated in float64),
   and ``jax.nn.gelu`` against ``0.5 (1 + tanh(k fma(c, x^3, x))) x`` on
   that copy: mismatching bits on 2^20 inputs each (and torch's own
   ``tanh`` / tanh-gelu beside them).
2. The d32 one-layer SeedFlood run of ``repro.dtrain.runner.run`` against
   the port's (4 clients on a ring, 3 steps, B 2), the largest final
   parameter gap, for: silu, silu with a window of 8, gelu with a window
   of 8 (torch's gelu and the bitwise copy), at rank 16 / tau 1000 (the
   run defaults) and at rank 4 / tau 2 (the method tests' run).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.synthetic import TaskConfig as JTask
from repro.dtrain.api import sim_arch as jsim_arch
from repro.dtrain.runner import DTrainConfig as JConfig, run as jrun
from repro_torch.data.synthetic import TaskConfig
from repro_torch.dtrain.api import sim_arch
from repro_torch.dtrain.runner import DTrainConfig, run
from repro_torch.models import layers as L, params as tplib


def f32(v):
    return float(np.float32(v))


NUM = [f32(c) for c in (-2.76076847742355e-16, 2.00018790482477e-13,
                        -8.60467152213735e-11, 5.12229709037114e-08,
                        1.48572235717979e-05, 6.37261928875436e-04,
                        4.89352455891786e-03)]
DEN = [f32(c) for c in (1.19825839466702e-06, 1.18534705686654e-04,
                        2.26843463243900e-03, 4.89352518554385e-03)]
CLAMP = f32(7.99881172180175781)
K_CUBE, K_SCALE = f32(0.044714998453855515), f32(0.7978845834732056)


def fma(a, b, c):
    def d(v):
        return v.double() if torch.is_tensor(v) else v
    return (d(a) * d(b) + d(c)).float()


def tanh_xla(x):
    xc = x.clamp(-CLAMP, CLAMP)
    x2 = xc * xc
    p = torch.full_like(x, NUM[0])
    for c in NUM[1:]:
        p = fma(x2, p, c)
    q = torch.full_like(x, DEN[0])
    for c in DEN[1:]:
        q = fma(x2, q, c)
    return torch.where(x.abs() < 0.0004, x, xc * p / q)


def gelu_xla(x):
    return x * (0.5 * (1 + tanh_xla(K_SCALE * fma(K_CUBE, (x * x) * x, x))))


def differ(a, b):
    return int((np.asarray(a).view(np.int32)
                != np.asarray(b).view(np.int32)).sum())


def bits():
    x = np.random.default_rng(0).standard_normal(1 << 20).astype(np.float32)
    x *= 3
    t = torch.from_numpy(x)
    print("tanh: XLA vs copy", differ(jax.jit(jnp.tanh)(x), tanh_xla(t)),
          "| XLA vs torch", differ(jax.jit(jnp.tanh)(x), torch.tanh(t)))
    print("gelu: XLA vs copy", differ(jax.jit(jax.nn.gelu)(x), gelu_xla(t)),
          "| XLA vs torch",
          differ(jax.jit(jax.nn.gelu)(x),
                 torch.nn.functional.gelu(t, approximate="tanh")))


def arch(sim, act, window):
    a = sim(d_model=32, n_layers=1, n_heads=2, d_ff=64)
    (g,) = a.groups
    (s,) = g.slots
    s = dataclasses.replace(s, attn=dataclasses.replace(s.attn, window=window))
    return dataclasses.replace(a, act=act,
                               groups=(dataclasses.replace(g, slots=(s,)),))


def gaps():
    task = dict(vocab=256, n_valid=8, n_test=64)
    torch_gelu = functools.partial(torch.nn.functional.gelu,
                                   approximate="tanh")
    for run_kw in (dict(), dict(subcge_rank=4, subcge_tau=2)):
        kw = dict(n_clients=4, steps=3, batch_size=2, **run_kw)
        for act, window, copy in (("silu", None, False), ("silu", 8, False),
                                  ("gelu", 8, False), ("gelu", 8, True)):
            L.ACTS["gelu"] = gelu_xla if copy else torch_gelu
            rj = jrun(JConfig(arch=arch(jsim_arch, act, window),
                              task=JTask(**task), **kw))
            rt = run(DTrainConfig(arch=arch(sim_arch, act, window),
                                  task=TaskConfig(**task), device="cpu", **kw))
            want = tplib.flatten(jax.tree.map(np.asarray,
                                              rj.extra["final_stacked"]))
            gap = max(float(np.abs(rt.extra["final_stacked"][p].numpy()
                                   - w).max()) for p, w in want.items())
            print(run_kw or "rank 16, tau 1000", act, "window", window,
                  "XLA gelu copy" if copy else "", "param gap", gap,
                  flush=True)
    L.ACTS["gelu"] = torch_gelu


if __name__ == "__main__":
    torch.set_num_threads(1)
    bits()
    gaps()
