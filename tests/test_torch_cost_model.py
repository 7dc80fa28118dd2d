"""The port's input shapes, parameter counts and cost model against the
JAX package's, for every arch of the registry (CPU arithmetic,
milliseconds).

* ``step_cost`` equal by ``==`` (FLOPs and bytes as Python floats, the same
  arithmetic in the same order) for every arch x ``INPUT_SHAPES`` x step
  kind, after ``for_shape``, at ``db`` 2 and 4;
* ``count_params`` equal for every arch;
* ``INPUT_SHAPES``, ``for_shape`` and ``with_sliding_window`` equal field
  for field;
* the H100's peaks in place of the TPU's, and ``bound_ms``.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.roofline import cost_model as jcm  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.roofline import cost_model as tcm  # noqa: E402

KINDS = ("train", "train_dsgd", "prefill", "decode")


def _same_arch(t, j):
    """Field for field, the slots' sub-configs as dicts (the JAX MambaCfg's
    ``chunk``, a jnp memory knob, is not the port's)."""
    for f in dataclasses.fields(t):
        if f.name in ("groups", "frontend"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), (t.name, f.name)
    assert (t.frontend is None) == (j.frontend is None)
    if t.frontend is not None:
        assert dataclasses.asdict(t.frontend) == dataclasses.asdict(j.frontend)
    assert [g.reps for g in t.groups] == [g.reps for g in j.groups]
    for st, sj in zip(t.layer_cfgs(), j.layer_cfgs(), strict=True):
        dt, dj = dataclasses.asdict(st), dataclasses.asdict(sj)
        if dj["mamba"] is not None:
            dj["mamba"].pop("chunk")
        assert dt == dj, t.name


def test_shapes_and_for_shape_match_jax():
    assert list(tbase.INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, s in tbase.INPUT_SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jbase.INPUT_SHAPES[name])
    assert sorted(tarchs.REGISTRY) == sorted(jarchs.REGISTRY)
    windowed = 0
    for name in jarchs.REGISTRY:
        at, aj = tarchs.get(name), jarchs.get(name)
        _same_arch(at, aj)
        _same_arch(at.with_sliding_window(512), aj.with_sliding_window(512))
        for s in tbase.INPUT_SHAPES.values():
            vt, vj = at.for_shape(s), aj.for_shape(jbase.INPUT_SHAPES[s.name])
            _same_arch(vt, vj)
            windowed += vt is not at
    # long_500k windows the full-attention archs only
    native = [n for n in jarchs.REGISTRY
              if jarchs.get(n).long_context_mode == "native"]
    assert sorted(native) == ["falcon-mamba-7b", "gemma3-1b",
                              "jamba-1.5-large-398b"]
    assert windowed == len(jarchs.REGISTRY) - len(native)


def test_count_params_matches_jax():
    for name in jarchs.REGISTRY:
        assert ttf.count_params(tarchs.get(name)) \
            == jtf.count_params(jarchs.get(name)), name
    assert ttf.count_params(tarchs.get("internvl2-26b")) == 19_880_921_088


@pytest.mark.parametrize("db", [2, 4])
def test_step_cost_equals_jax(db):
    """13 archs x 4 shapes x 4 kinds: FLOPs and bytes equal as floats."""
    n = 0
    for name in jarchs.REGISTRY:
        for s in tbase.INPUT_SHAPES.values():
            sj = jbase.INPUT_SHAPES[s.name]
            at, aj = tarchs.get(name).for_shape(s), jarchs.get(name).for_shape(sj)
            for kind in KINDS:
                got = tcm.step_cost(at, s, kind, db=db)
                want = jcm.step_cost(aj, sj, kind, db=db)
                assert type(got.flops) is float and type(got.bytes) is float
                assert (got.flops, got.bytes) == (want.flops, want.bytes), \
                    (name, s.name, kind)
                n += 1
    assert n == 13 * 4 * 4


def test_h100_peaks_and_bound():
    """The H100 SXM's peaks (not the TPU v5e's), and the bound of one bf16
    decode step of InternVL2-26B whole at B 4 and a context of 1,057
    (1,024 patches, a prompt and new tokens): every weight but the token
    table (of which the model reads B rows) and the projector (which a
    decode step does not read) streams once."""
    assert (tcm.PEAK_F32_FLOPS, tcm.PEAK_BF16_FLOPS, tcm.PEAK_HBM_BYTES) \
        == (67e12, 989e12, 3.35e12)
    c = tcm.Cost(flops=67e12, bytes=3.35e12 / 2)
    assert tcm.bound_ms(c) == 1000.0
    assert tcm.bound_ms(c, tcm.PEAK_BF16_FLOPS) == 500.0
    arch = tarchs.get("internvl2-26b")
    shape = tbase.InputShape("serve", 1_057, 4, "decode")
    cost = tcm.step_cost(arch, shape, "decode", db=2)
    streamed = ttf.count_params(arch) - (92_553 + 3200) * 6144
    assert 2 * streamed < cost.bytes < 2 * streamed * 1.01
    assert abs(tcm.bound_ms(cost, tcm.PEAK_BF16_FLOPS) - 11.55) < 0.01
