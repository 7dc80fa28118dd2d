"""Gemma 3 1B (gated tanh-gelu, 5:1 sliding-window / global attention,
head_dim 256, tied 262,144 vocabulary) and Qwen2-72B in the port, against
the JAX package on the CPU.

* the registry entries, their reduced variants and the one-card Qwen2 cut:
  the JAX package's fields, slot by slot (the port leaves out the pod's
  ``sharding_policy`` and ``long_context_mode``);
* the window binds: the reduced Gemma's loss at 33 tokens moves when its
  window is taken away, and at 16 tokens (the window) it is bitwise the
  same;
* a SeedFlood run of a gelu, windowed d32 one-layer decoder (window 8 at
  33 tokens) against ``repro.dtrain.runner.run``, at the width and run of
  the other method tests (rank 4, τ 2): ledger equal, loss curve rtol
  1e-4, final params atol 3e-5.  The ZO coefficient turns float32 loss
  rounding into a parameter gap (ROADMAP Queue 3): at rank 16 and τ 1000
  this decoder ends 3.9e-5 from JAX, and 3.7e-5 with a gelu that is
  bitwise XLA's, so the gap is the coefficient's, not gelu's;
* a prompt past the window (24 tokens, window 16): prefill and 4
  monolithic decode steps within atol 1e-5 of JAX's monolithic path and of
  JAX's no-cache forward; the port's paged decode within atol 1e-5 of its
  own monolithic decode, token for token, with the pages the window reads
  holding the ring's last 16 positions.  JAX's own paged path is off there
  by far more: its prefill scatter assumes ring slot s holds position s
  (the reference's fault the port does not copy, ROADMAP Queue 3);
* serving the reduced Gemma with prompts past the window through
  ``DecodeServer`` and the CLI: the paged greedy streams equal the
  monolithic ones and a no-cache recompute, token for token.

``lm_loss`` of the reduced Gemma, the mini Gemma and the reduced Qwen2-72B
against JAX is a case of tests/test_torch_model.py; a prompt shorter than
the window, of tests/test_torch_serve_model.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.data.synthetic import TaskConfig as JTask  # noqa: E402
from repro.dtrain.api import sim_arch as jsim_arch  # noqa: E402
from repro.dtrain.runner import DTrainConfig as JConfig, run as jrun  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.data.synthetic import TaskConfig  # noqa: E402
from repro_torch.dtrain.api import sim_arch  # noqa: E402
from repro_torch.dtrain.runner import DTrainConfig, run  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.serve import (DecodeServer, Request,  # noqa: E402
                               ServeConfig, bucket_pages, pages_needed)

from _torch_parity import assert_run_matches, one_thread, weights  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOGIT_ATOL = 1e-5
WINDOW = 16                  # the reduced Gemma's (JAX reduced: 16)
B, PL, NEW = 3, 24, 4        # the prompt runs 8 tokens past the window
CAP = PL + NEW + 2           # monolithic capacity (the local ring: 16)
PAGE, N_PAGES = 4, 16


def _gemma():
    return (jarchs.reduced(jarchs.get("gemma3-1b")),
            tarchs.reduced(tarchs.get("gemma3-1b")))


def _slots(cfg):
    return [s for g in cfg.groups for s in g.slots]


def test_configs_match_jax():
    # the port keeps every field it has with the JAX package's value
    for name in ("gemma3-1b", "qwen2-72b"):
        for shrink in (False, True):
            arch_j, arch_t = jarchs.get(name), tarchs.get(name)
            if shrink:
                arch_j, arch_t = jarchs.reduced(arch_j), tarchs.reduced(arch_t)
            for f in dataclasses.fields(arch_t):
                if f.name != "groups":
                    assert getattr(arch_t, f.name) == getattr(arch_j, f.name)
            assert [g.reps for g in arch_t.groups] \
                == [g.reps for g in arch_j.groups]
            for sj, st in zip(_slots(arch_j), _slots(arch_t), strict=True):
                assert (st.mixer, st.ffn, st.d_ff) == (sj.mixer, sj.ffn,
                                                       sj.d_ff)
                for f in dataclasses.fields(st.attn):
                    assert getattr(st.attn, f.name) == getattr(sj.attn,
                                                               f.name)
    gemma = tarchs.get("gemma3-1b")
    windows = [s.attn.window for s in _slots(gemma)]
    assert gemma.n_layers == 26 and windows == [512] * 5 + [None] + [512]
    assert tarchs.reduced(gemma).groups[0].slots[0].attn.window == WINDOW
    # the same leaves, of the same shapes, as the JAX package's spec
    spec = ttf.arch_spec(gemma)
    want = tplib.flatten(jtf.arch_spec(jarchs.get("gemma3-1b")))
    assert {p: s.shape for p, s in spec.items()} \
        == {p: s.shape for p, s in want.items()}
    assert "embed/out" not in spec and spec["g0/s0/wq"].shape == (4, 1152,
                                                                   1024)
    assert 0.99e9 < tplib.n_params(spec) < 1.01e9
    # the one-card cut: every width and the untied vocabulary, 1 of 80
    cut = tarchs.qwen2_cut()
    assert cut.n_layers == tarchs.QWEN2_LAYERS == 1
    assert _slots(cut) == _slots(tarchs.get("qwen2-72b"))
    cspec = ttf.arch_spec(cut)
    assert cspec["embed/out"].shape == (8192, 152_064)
    assert 3.36e9 < tplib.n_params(cspec) < 3.38e9


def test_window_changes_the_loss():
    arch = tarchs.reduced(tarchs.get("gemma3-1b"))
    glob = dataclasses.replace(arch, groups=tuple(
        dataclasses.replace(g, slots=tuple(
            dataclasses.replace(s, attn=dataclasses.replace(s.attn,
                                                            window=None))
            for s in g.slots)) for g in arch.groups))
    params = {p: t[None] for p, t in ttf.init_params(arch, 0).items()}
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, arch.vocab, (1, 2, 33)))
    long_w, long_g = (float(ttf.lm_loss(a, params, toks)[0])
                      for a in (arch, glob))
    assert long_w != long_g
    short = toks[..., :WINDOW]
    assert torch.equal(ttf.lm_loss(arch, params, short),
                       ttf.lm_loss(glob, params, short))


def _windowed_gelu(sim):
    """The d32 one-layer sim decoder (``sim``: a package's ``sim_arch``)
    with gated tanh-gelu and a window of 8."""
    a = sim(d_model=32, n_layers=1, n_heads=2, d_ff=64)
    (g,) = a.groups
    (s,) = g.slots
    s = dataclasses.replace(s, attn=dataclasses.replace(s.attn, window=8))
    return dataclasses.replace(
        a, act="gelu", groups=(dataclasses.replace(g, slots=(s,)),))


def test_seedflood_run_matches_jax():
    # the run of tests/test_torch_methods_zo.py (rank 4, τ 2)
    task = dict(vocab=256, n_valid=8, n_test=64)
    kw = dict(n_clients=4, steps=3, batch_size=2, subcge_rank=4,
              subcge_tau=2)
    rj = jrun(JConfig(arch=_windowed_gelu(jsim_arch),
                      task=JTask(**task), **kw))
    rt = run(DTrainConfig(arch=_windowed_gelu(sim_arch),
                          task=TaskConfig(**task), device="cpu", **kw))
    assert_run_matches(rt, rj)
    assert rt.extra["n_messages"] == rj.extra["n_messages"]
    assert rt.consensus_error < 1e-10


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL, err_msg=what)


def test_decode_past_the_window_matches_jax():
    arch_j, arch_t = _gemma()
    (jp,), tp = weights(arch_j, 1, seed=1)
    fwd = jax.jit(jtf.forward, static_argnums=0)
    prompts = np.random.default_rng(4).integers(
        0, arch_t.vocab, (B, PL)).astype(np.int32)

    # monolithic: prefill over a ring of 16, then 4 decode steps
    jc = jtf.init_cache(arch_j, B, CAP, jnp.float32)
    jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(prompts)}, cache=jc,
                    pos=0)
    tc = ttf.init_cache(arch_t, B, CAP)
    assert tc["g0/s0"]["k"].shape[2] == WINDOW
    tl, _ = ttf.forward(arch_t, tp, torch.as_tensor(prompts)[None],
                        cache=tc, pos=0)
    _close(tl[0], jl, "prefill")
    ring = {k: t.clone() for k, t in tc["g0/s0"].items()}
    fed, mono = [], []
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(NEW):
        fed.append(tok)
        jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(tok)}, cache=jc,
                        pos=jnp.int32(PL + i))
        tl, _ = ttf.forward(arch_t, tp, torch.as_tensor(tok)[None],
                            cache=tc, pos=PL + i)
        _close(tl[0], jl, f"monolithic decode {i}")
        mono.append(tl[0, :, 0])
        tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
        assert (mono[-1].argmax(-1).numpy() == tok[:, 0]).all()
    np.testing.assert_array_equal(tc["g0/s0"]["kpos"].numpy(),
                                  np.asarray(jc["g0"]["s0"]["kpos"]))
    # JAX's no-cache forward over prompt + the fed tokens: its logits at
    # positions PL .. PL + NEW - 1 are the decode steps'
    full = np.concatenate([prompts] + fed, axis=1)
    jfull = fwd(arch_j, jp, {"tokens": jnp.asarray(full)})[0]
    for i in range(NEW):
        _close(mono[i], jfull[:, PL + i], f"decode {i} vs no-cache forward")

    # paged: rows 0 and 2 live, row 1 idle (the dump page)
    ppr = CAP // PAGE + 1
    table = np.full((B, ppr), N_PAGES, np.int64)
    table[0] = [3, 0, 7, 1, 9, 11, 13, 15]
    table[2] = [5, 2, 4, 6, 8, 10, 12, 14]
    live = [0, 2]
    tpool = ttf.init_paged_pool(arch_t, N_PAGES, PAGE)
    prefill = tsteps.build_paged_prefill_step(arch_t, 2, PL, PAGE)
    _, tpool = prefill(tp, tpool, torch.as_tensor(prompts[live]).long(),
                       torch.as_tensor(table[live]))
    # each of the ring's 16 positions sits in its page; older ones are
    # never written (the window hides them from every decode query)
    for pos in range(PL):
        phys, off = table[live, pos // PAGE], pos % PAGE
        got = tpool["g0/s0"]["k"][:, phys, off]
        if pos < PL - WINDOW:
            assert not got.any()
        else:
            assert torch.equal(got, ring["k"][:, :, pos % WINDOW][:, live])
    decode = tsteps.build_paged_decode_step(arch_t)
    for i in range(NEW):
        tok = fed[i].copy()
        tok[1] = 0
        pos = np.array([PL + i, 0, PL + i])
        bucket = bucket_pages(pages_needed(PL + i + 1, PAGE), ppr)
        tl, tpool = decode(tp, tpool, torch.as_tensor(tok).long(),
                           torch.as_tensor(table[:, :bucket]),
                           torch.as_tensor(pos))
        _close(tl[live], mono[i][live], f"paged vs monolithic decode {i}")
        assert torch.equal(tl[live].argmax(-1), mono[i][live].argmax(-1))

    # the reference's paged path on the same prompts: its scatter puts the
    # ring's positions on the wrong pages
    jpool = jtf.init_paged_pool(arch_j, N_PAGES, PAGE, jnp.float32)
    jc = jtf.init_cache(arch_j, 2, PL, jnp.float32)
    _, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(prompts[live])},
                   cache=jc, pos=0)
    jpool = jtf.write_prefill_to_pages(arch_j, jc, jpool,
                                       jnp.asarray(table[live], jnp.int32),
                                       PAGE)
    bucket = bucket_pages(pages_needed(PL + 1, PAGE), ppr)
    jl, _, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(fed[0][live])},
                   cache=jpool, pos=jnp.full((2,), PL, jnp.int32),
                   paged_table=jnp.asarray(table[live, :bucket], jnp.int32))
    assert float(np.abs(np.asarray(jl[:, 0]) - mono[0][live].numpy()).max()) \
        > 1e3 * LOGIT_ATOL


def _streams(arch, params, prompts, n_new):
    """Greedy streams by monolithic decode over a ring of 64, and by a
    no-cache forward over prompt + generated at every step."""
    view = {k: t[None] for k, t in params.items()}
    decode = tsteps.build_decode_step(arch)
    mono, plain = [], []
    for p in prompts:
        last, cache = tsteps.build_prefill_step(arch, 1, 64)(
            view, torch.as_tensor(p).long()[None])
        out = [int(last[0].argmax())]
        for i in range(n_new - 1):
            lg, cache = decode(view, cache, torch.tensor([[out[-1]]]),
                               len(p) + i)
            out.append(int(lg[0].argmax()))
        mono.append(out)
        seq = list(p)
        for _ in range(n_new):
            lg, _ = ttf.forward(arch, view, torch.as_tensor(seq)[None, None])
            seq.append(int(lg[0, 0, -1].argmax()))
        plain.append(seq[len(p):])
    return mono, plain


def test_serving_past_the_window(capsys):
    arch = tarchs.reduced(tarchs.get("gemma3-1b"))
    params = ttf.init_params(arch, 0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, arch.vocab, n).astype(np.int32)
               for n in (20, 33, 27, 41)]
    n_new = 6
    srv = DecodeServer(arch, params, ServeConfig(
        max_batch=2, page_size=8, n_pages=16, max_seq=64), device="cpu")
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid=rid, prompt=p, max_new=n_new))
    res = srv.run()
    mono, plain = _streams(arch, params, prompts, n_new)
    assert [res[r] for r in range(len(prompts))] == mono == plain
    assert srv.stats()["evicted"] == len(prompts)
    # the CLI serves the reduced Gemma on the CPU, prompts past the window
    assert tcli.main(["--arch", "gemma3-1b", "--reduced", "--batch", "2",
                      "--requests", "3", "--prompt-len", "20", "--new", "3",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("gemma3-1b-reduced on cpu: 3 requests x 3 new")
    assert "'emitted': 9" in out[0] and len(out) == 4
