"""Where the MLA SeedFlood run's gap to the JAX package comes from, on the
CPU: for each size tried, a 3-step run on 4 clients through the JAX
Trainer (recording each step's coefficients), the port's run with its own
coefficients, and the port's run fed the JAX run's; prints the largest
coefficient gap and each run's largest final-parameter gap as a fraction
of the leaf's update (``tests/test_torch_mla.py`` holds the one-layer case).

    PYTHONPATH=src JAX_PLATFORMS=cpu python _proof/mla23.py   # ~4 min
"""
import dataclasses
import sys

sys.path[:0] = ["tests", "src"]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from _torch_parity import jax_method_run, record_coefficients  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.models import params as tplib  # noqa: E402

DS = "deepseek-v2-236b"
TASK = dict(vocab=256, n_valid=8, n_test=64)
RUN = dict(n_clients=4, steps=3, batch_size=2)


def arch(mod, d, layers):
    """The reduced DeepSeek-V2 of ``mod`` at width d: both layers, or only
    its MLA + MoE layer (``layers == "moe"``)."""
    a = mod.reduced(mod.get(DS), d_model=d)
    if layers == "moe":
        (g,) = a.groups
        a = dataclasses.replace(a, groups=(dataclasses.replace(
            g, slots=g.slots[1:]),))
    return a


def gap(rt, want, init):
    got = rt.extra["final_stacked"]
    return max(float(np.abs(got[p].numpy() - w).max())
               / float(np.abs(w - init[p][None]).max())
               for p, w in want.items())


def main():
    torch.set_num_threads(1)
    for d, layers, kw in ((32, "moe", {}), (32, "both", {}),
                          (32, "both", dict(subcge_rank=4, subcge_tau=2)),
                          (64, "both", {})):
        aj, at = arch(jarchs, d, layers), arch(tarchs, d, layers)
        jc, own, fed = {}, {}, {}
        rj = jax_method_run(JConfig(arch=aj, task=JTask(**TASK), **RUN,
                                    **kw), coefs=jc)
        runs = {}
        mp = pytest.MonkeyPatch()
        for key, rec, feed in (("own", own, None), ("fed", fed, jc)):
            record_coefficients(mp, rec, feed)
            runs[key] = run(DTrainConfig(arch=at, task=TaskConfig(**TASK),
                                         device="cpu", **RUN, **kw))
        mp.undo()
        want = tplib.flatten(jax.tree.map(np.asarray,
                                          rj.extra["final_stacked"]))
        init = tplib.flatten(jax.tree.map(np.asarray,
                                          jtf.init_params(aj, 0)))
        dc = max(float(np.abs(own[t] - c).max()) for t, c in jc.items())
        print(f"d{d} {layers} {kw or ''}: coefficients max |gap| {dc:.3e}; "
              f"final params max gap / update: own coefficients "
              f"{gap(runs['own'], want, init):.3e}, JAX's "
              f"{gap(runs['fed'], want, init):.3e}", flush=True)


if __name__ == "__main__":
    main()
