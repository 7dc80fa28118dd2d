"""Checkpoints in the port: the file layout against the JAX package, and
bitwise resume inside the port.

* ``ckpt.save`` / ``ckpt.load``: a round trip keeps every leaf exact
  (float32 tensors, int64 and float64 arrays, bf16 through the uint16
  marker), ``like=`` casts to the reference and refuses a tree whose paths
  differ, naming the missing and extra keys; files written by either
  package load in the other.
* The Trainer's checkpoint of a dzsgd run under churn holds the same npz
  keys and metadata keys as the JAX Trainer's.
* Resume: a run restarted from its step-2 checkpoint ends bitwise equal to
  the uninterrupted run (every final leaf, the loss and consensus curves
  and the ledger) for seedflood under churn on both flood engines (τ = 2:
  the resumed half crosses an epoch, with a client offline at the
  checkpoint), dzsgd and choco (Choco's surrogates ``x_hat``) under churn,
  central_zo with subspace momentum 0.9, and gossip_sr.  A checkpoint of
  another method is refused; the checkpoint fields' rules are the JAX
  package's, message for message.

(A checkpoint the JAX Trainer wrote mid-run, resumed by the port, is in
``tests/test_torch_churn.py``, which makes that JAX run anyway.)
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig  # noqa: E402
from repro.dtrain.runner import validate_config as jvalidate  # noqa: E402
from repro.topology import dynamic as jdyn  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run, validate_config  # noqa: E402
from repro_torch.topology import dynamic  # noqa: E402

from _torch_parity import jax_method_run, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = dict()  # the default sim width: d64, two layers
TASK = dict(vocab=256, n_valid=8, n_test=64)


def _tree(rng):
    bf = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    return {"method": {"stacked": {
                "embed": {"tok": torch.from_numpy(
                    rng.standard_normal((2, 4, 6)).astype(np.float32))},
                "half": bf.to(torch.bfloat16)}},
            "transport": {"msgs": {
                "seed": rng.integers(0, 2**32, 7, dtype=np.int64),
                "coef": rng.standard_normal(7)},
                "catchup0": np.array([3, 1, 2], np.int64),
                "bits": [np.array([5, 255], np.uint8)]}}


def test_ckpt_round_trip_is_exact(tmp_path):
    tree = _tree(np.random.default_rng(0))
    path = str(tmp_path / "a" / "step000001.npz")
    ckpt.save(path, tree, metadata={"step": 1, "curve": [0.5, 0.25]})
    got, meta = ckpt.load(path)
    assert meta == {"step": 1, "curve": [0.5, 0.25]}
    st, gt = tree["method"]["stacked"], got["method"]["stacked"]
    assert gt["embed"]["tok"].dtype == np.float32
    assert (gt["embed"]["tok"] == st["embed"]["tok"].numpy()).all()
    assert gt["half"].dtype == torch.bfloat16
    assert torch.equal(gt["half"].view(torch.int16),
                       st["half"].view(torch.int16))
    for k in ("seed", "coef"):
        w, g = tree["transport"]["msgs"][k], got["transport"]["msgs"][k]
        assert g.dtype == w.dtype and (g == w).all(), k
    assert (got["transport"]["catchup0"] == [3, 1, 2]).all()
    assert (got["transport"]["bits"]["0"] == [5, 255]).all()
    # like=: each leaf takes the reference's dtype, shape and device
    like = {"method": {"stacked": {"embed": {"tok": torch.zeros(2, 4, 6)},
                                   "half": torch.zeros(3, 5,
                                                       dtype=torch.bfloat16)}},
            "transport": tree["transport"]}
    got, _ = ckpt.load(path, like=like)
    assert torch.equal(got["method"]["stacked"]["embed"]["tok"],
                       st["embed"]["tok"])
    del like["transport"]["catchup0"]
    like["transport"]["catchup1"] = np.zeros(3, np.int64)
    with pytest.raises(ValueError, match=r"missing=\['transport/catchup1'\] "
                                         r"extra=\['transport/catchup0'\]"):
        ckpt.load(path, like=like)


def test_ckpt_files_cross_between_packages(tmp_path):
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((2, 3)).astype(np.float32)
    bf = rng.standard_normal((4,)).astype(np.float32)
    i64 = np.array([2**40, -3], np.int64)
    jckpt.save(str(tmp_path / "j.npz"),
               {"w": jnp.asarray(f32), "h": jnp.asarray(bf, jnp.bfloat16),
                "n": {"i": i64}}, metadata={"from": "jax"})
    got, meta = ckpt.load(str(tmp_path / "j.npz"))
    # numpy and torch only: no JAX array reaches the port
    assert isinstance(got["w"], np.ndarray)
    assert isinstance(got["h"], torch.Tensor)
    assert meta == {"from": "jax"} and (got["w"] == f32).all()
    assert got["n"]["i"].dtype == np.int64 and (got["n"]["i"] == i64).all()
    assert torch.equal(got["h"].float(),
                       torch.from_numpy(bf).to(torch.bfloat16).float())
    ckpt.save(str(tmp_path / "t.npz"),
              {"w": torch.from_numpy(f32),
               "h": torch.from_numpy(bf).to(torch.bfloat16),
               "n": {"i": i64}}, metadata={"from": "torch"})
    back, meta = jckpt.load(str(tmp_path / "t.npz"), to_jax=False)
    assert meta == {"from": "torch"} and (back["w"] == f32).all()
    assert back["n"]["i"].dtype == np.int64 and (back["n"]["i"] == i64).all()
    assert back["h"].dtype == jnp.bfloat16
    assert (np.asarray(back["h"], np.float32)
            == np.asarray(jnp.asarray(bf, jnp.bfloat16), np.float32)).all()


def test_trainer_checkpoint_layout_matches_jax(tmp_path):
    """The same dzsgd churn run checkpointed by both Trainers: the same npz
    keys, shapes and metadata keys, and the same step, curves' lengths and
    ledger."""
    kw = dict(method="dzsgd", n_clients=4, steps=2, batch_size=2,
              local_iters=1, checkpoint_every=2)
    jax_method_run(JConfig(arch=jsim_arch(**ARCH), task=JTask(**TASK),
                           churn=jdyn.ChurnSchedule.leave_rejoin((1,), 1, 3),
                           checkpoint_dir=str(tmp_path / "j"), **kw))
    run(DTrainConfig(arch=sim_arch(**ARCH), task=TaskConfig(**TASK),
                     churn=dynamic.ChurnSchedule.leave_rejoin((1,), 1, 3),
                     checkpoint_dir=str(tmp_path / "t"), device="cpu", **kw))
    files = {}
    for side in ("j", "t"):
        with np.load(tmp_path / side / "step000002.npz") as z:
            files[side] = {k: z[k].shape for k in z.files}
        files[side + "meta"] = json.loads(
            (tmp_path / side / "step000002.npz.meta.json").read_text())
    assert files["t"] == files["j"]
    mt, mj = files["tmeta"], files["jmeta"]
    assert set(mt) == set(mj)
    assert set(mt["transport_meta"]) == set(mj["transport_meta"])
    for k in ("step", "method", "method_meta"):
        assert mt[k] == mj[k], k
    assert mt["transport_meta"]["ledger"] == mj["transport_meta"]["ledger"]
    assert mt["transport_meta"]["topo"] == mj["transport_meta"]["topo"]
    assert len(mt["loss_curve"]) == len(mj["loss_curve"]) == 2


RESUME_CASES = {
    "seedflood-python": dict(method="seedflood", flood_backend="python",
                             subcge_tau=2, churn=True),
    "seedflood-numpy": dict(method="seedflood", flood_backend="numpy",
                            subcge_tau=2, churn=True),
    "dzsgd": dict(method="dzsgd", local_iters=1, churn=True),
    "choco": dict(method="choco", local_iters=1, churn=True),
    "central_zo-momentum": dict(method="central_zo", momentum=0.9,
                                subcge_tau=2),
    "gossip_sr": dict(method="gossip_sr", local_iters=1, subcge_tau=2),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_is_bitwise(case, tmp_path):
    """Client 1 leaves at step 1 and rejoins at 3: the step-2 checkpoint
    holds it offline, its flood frontier dropped, and the resumed half
    runs the anti-entropy catch-up."""
    kw = dict(RESUME_CASES[case])
    churn = kw.pop("churn", False)
    base = dict(arch=sim_arch(**ARCH), task=TaskConfig(**TASK), n_clients=4,
                steps=5, batch_size=2, eval_every=1, device="cpu", **kw)
    if churn:
        base["churn"] = dynamic.ChurnSchedule.leave_rejoin((1,), 1, 3)
    whole = run(DTrainConfig(checkpoint_every=2,
                             checkpoint_dir=str(tmp_path), **base))
    resumed = run(DTrainConfig(resume_from=str(tmp_path / "step000002.npz"),
                               **base))
    got, want = resumed.extra["final_stacked"], whole.extra["final_stacked"]
    assert set(got) == set(want)
    for p, w in want.items():
        assert torch.equal(got[p], w), p
    assert resumed.loss_curve == whole.loss_curve
    assert resumed.acc_curve == whole.acc_curve
    assert resumed.extra["consensus_curve"] == whole.extra["consensus_curve"]
    assert resumed.total_bytes == whole.total_bytes
    for k in ("n_messages", "sync_bytes", "n_syncs", "reconstructions"):
        assert resumed.extra.get(k) == whole.extra.get(k), k
    if churn and kw["method"] == "seedflood":
        assert whole.extra["n_syncs"] > 0


def test_resume_refuses_another_methods_checkpoint(tmp_path):
    base = dict(arch=sim_arch(**ARCH), task=TaskConfig(**TASK), n_clients=4,
                steps=2, batch_size=2, device="cpu")
    run(DTrainConfig(checkpoint_every=2, checkpoint_dir=str(tmp_path),
                     **base))
    with pytest.raises(ValueError, match="checkpoint was written by method "
                       "'seedflood', cannot resume a 'dzsgd' run from it"):
        run(DTrainConfig(method="dzsgd", resume_from=str(
            tmp_path / "step000002.npz"), **base))


@pytest.mark.parametrize("kw", [dict(checkpoint_every=2),
                                dict(checkpoint_dir="ck")],
                         ids=["every-without-dir", "dir-without-every"])
def test_checkpoint_rules_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        jvalidate(JConfig(**kw))
    with pytest.raises(ValueError) as et:
        validate_config(DTrainConfig(**kw))
    assert str(et.value) == str(ej.value)
