"""SeedFlood under churn at the default sim width (d64, two layers, 8
clients, 6 steps), the port against the JAX package.

At this width the two packages' final params end ~1e-4 apart, past the 3e-5
tolerance of ``assert_run_matches``, while the loss curves agree to ~1e-6.
The ZO coefficient ``-lr (l+ - l-) / (2 eps n_eff)`` is where they part:
the two float32 forwards round l+ and l- differently, and the difference
of two nearby losses over 2 eps turns a relative 1e-6 between the loss
curves into up to 1e-2 between a client's coefficients.  This file shows
that the coefficient is the only source of the gap: fed the JAX run's own
coefficients (each client's message, step by step), the port's own update,
flood, catch-up and epoch replay end within ``assert_run_matches`` of the
JAX run at the same tolerance.  The run left to its own coefficients is
held to the ledger and the loss curve, and its parameter gap is printed
beside the fed run's (``pytest -s``).

The JAX run is compile-bound (~50 s alone), so it has a file of its own
and pytest-xdist's ``--dist loadfile`` schedules it beside the others.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.topology import dynamic as jdyn  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.topology import dynamic  # noqa: E402

from _torch_parity import (assert_run_matches, jax_method_run,  # noqa: E402,F401
                           one_thread, record_coefficients)

pytestmark = pytest.mark.usefixtures("one_thread")

TASK = dict(vocab=256, n_valid=8, n_test=64)
RUN = dict(n_clients=8, steps=6, batch_size=2, subcge_tau=3,
           flood_backend="python")


def _script(CS):
    """test_torch_churn.py's script: client 3 misses steps 1-3 and catches
    up across a τ boundary at 4; the ring splits at 2 and heals at 3."""
    return (CS.leave_rejoin((3,), 1, 4)
            + CS.partition((range(0, 4), range(4, 8)), 2, 3))


def _port_run():
    return run(DTrainConfig(arch=sim_arch(), task=TaskConfig(**TASK),
                            churn=_script(dynamic.ChurnSchedule),
                            device="cpu", **RUN))


def _param_gap(rt, rj) -> float:
    import jax
    from repro_torch.models import params as tplib
    want = tplib.flatten(jax.tree.map(np.asarray, rj.extra["final_stacked"]))
    return max(float(np.abs(rt.extra["final_stacked"][p].numpy() - w).max())
               for p, w in want.items())


def test_seedflood_churn_d64_gap_is_the_coefficients(monkeypatch):
    jax_coefs, own_coefs, fed_coefs = {}, {}, {}
    rj = jax_method_run(JConfig(arch=jsim_arch(), task=JTask(**TASK),
                                churn=_script(jdyn.ChurnSchedule), **RUN),
                        coefs=jax_coefs)
    record_coefficients(monkeypatch, own_coefs)
    own = _port_run()
    assert own.total_bytes == rj.total_bytes
    assert own.extra["sync_bytes"] == rj.extra["sync_bytes"]
    np.testing.assert_allclose(own.loss_curve, rj.loss_curve, rtol=1e-4)
    record_coefficients(monkeypatch, fed_coefs, fed=jax_coefs)
    fed = _port_run()
    assert_run_matches(fed, rj)
    assert fed.extra["n_syncs"] == rj.extra["n_syncs"] > 0
    for t, c in jax_coefs.items():
        assert np.array_equal(fed_coefs[t], c), t
    jc = np.stack([jax_coefs[t] for t in sorted(jax_coefs)])
    oc = np.stack([own_coefs[t] for t in sorted(own_coefs)])
    sent = jc != 0
    loss_gap = np.abs(np.subtract(own.loss_curve, rj.loss_curve)) \
        / np.abs(rj.loss_curve)
    print(f"d64 churn run, port against JAX: loss curve max relative gap "
          f"{loss_gap.max():.4e}; coefficients max relative gap "
          f"{(np.abs(oc - jc)[sent] / np.abs(jc[sent])).max():.4e}; final "
          f"params max |gap|, own coefficients {_param_gap(own, rj):.4e}, "
          f"JAX's coefficients {_param_gap(fed, rj):.4e}")
