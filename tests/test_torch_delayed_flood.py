"""The port's delayed-flooding SeedFlood run (flood_k=1, τ=2, drain) against
``repro.dtrain.runner.run``: messages arrive late enough to cross τ-epoch
boundaries, so the replay must run under each sender's subspace.

Tolerances (each side draws its own weights and subspaces from the seed;
those Gaussians are bitwise equal, see test_torch_prng, so the gaps below
come from float32 summation order in the two forwards):

* byte ledger and message count: equal (host-side flood, same protocol);
* loss curve: rtol 1e-4;
* final params: allclose at atol 3e-5 — the ZO coefficient is a finite
  difference (L+ − L−) / 2ε, which turns float32 rounding differences of
  the two forwards (~1e-6 relative) into ~1e-3 relative coefficient
  differences, then scales them by U[:, i] V[:, j];
* consensus inside the port: < 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig, run as jrun  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.models import params as tplib  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

# one torch thread per test: under pytest-xdist the intra-op pools of the
# workers wait on each other (tests/_torch_parity.py::one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = dict(d_model=32, n_layers=2, n_heads=2, d_ff=64)
# a short test split keeps the final accuracy pass cheap; the training
# split comes first from the task's rng, so it is the default one
TASK = dict(vocab=256, n_valid=8, n_test=64)
RUN = dict(n_clients=4, steps=3, batch_size=2)
DELAYED = dict(flood_k=1, subcge_tau=2, drain=True)


def test_delayed_flood_run_matches_jax():
    kw = {**RUN, **DELAYED}
    rj = jrun(JConfig(arch=jsim_arch(**ARCH), task=JTask(**TASK), **kw))
    rt = run(DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                          device="cpu", **kw))
    assert rt.total_bytes == rj.total_bytes
    assert rt.bytes_per_edge == rj.bytes_per_edge
    assert rt.extra["n_messages"] == rj.extra["n_messages"]
    np.testing.assert_allclose(rt.loss_curve, rj.loss_curve, rtol=1e-4)
    assert rt.consensus_error < 1e-10
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    got = rt.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p].numpy(), w, atol=3e-5, err_msg=p)
