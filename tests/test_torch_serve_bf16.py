"""Serving in bf16, as the JAX serve CLI runs it by default, against the
JAX package at the reduced TinyLlama on the CPU.

* the paged prefill and decode steps' bf16 logits against JAX's
  ``build_paged_prefill_step`` / ``build_paged_decode_step`` with a bf16
  ``PodConfig``: within 4 bf16 ulps of the largest logit, at most 5 % of
  the elements past one (``test_bf16_lm_loss_matches_jax``'s limits; the
  gap measured here is in the test's docstring); and the monolithic steps
  in bf16 (Mamba, MLA, a frontend arch) against JAX's cached ``forward``
  in bf16 within 4 ulps, the MLA layer bitwise JAX's run op by op;
* the bridge's fold of bf16 weights at E = 2 against JAX's
  ``LiveUpdateBridge.fold`` in bf16: within one bf16 ulp, written in place;
* a bf16 ``DecodeServer`` against JAX's, greedy and at temperature 0.8:
  streams equal wherever the logits leave no doubt (the top-2 margin past
  the measured logit gap for greedy, bitwise rows for temperature, which
  needs the bf16 ``categorical``);
* the swarm in bf16: every server's weights and pool bf16, two runs equal
  bitwise;
* the CLI: ``--reduced`` serves float32 on the CPU, and without it the
  parsed config serves bf16 (no full-width model is built here).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs.base import InputShape as JInputShape  # noqa: E402
from repro.core.seeds import client_seed  # noqa: E402
from repro.core.subcge import SubCGEConfig as JSubCGE  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import layers as jlayers, transformer as jtf  # noqa: E402
from repro.models.perturb import Bundle as JBundle  # noqa: E402
from repro.serve import DecodeServer as JServer, Request as JRequest  # noqa: E402
from repro.serve import LiveUpdateBridge as JBridge  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.subcge import SubCGEConfig  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.models.perturb import Bundle  # noqa: E402
from repro_torch.serve import (DecodeServer, LiveUpdateBridge,  # noqa: E402
                               Request, ServeConfig, ServeSwarmSim)
from repro_torch.topology.dynamic import ChurnSchedule  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = torch.bfloat16
# the logits' limits, in bf16 ulps of the largest logit
MAX_ULPS, MAX_PAST_ONE = 4, 0.05
SERVE = dict(max_batch=2, page_size=4, n_pages=12, max_seq=20)
SCFG = dict(rank=4, refresh_period=2, eps=1e-3)
GSEED = 7


@pytest.fixture(scope="module")
def llama():
    """The reduced TinyLlama, random float32 weights rounded to bf16 on
    both sides (round to nearest even in both packages)."""
    arch_j = jarchs.reduced(jarchs.get("tinyllama-1.1b"))
    arch_t = tarchs.reduced(tarchs.get("tinyllama-1.1b"))
    rng = np.random.default_rng(0)
    w32 = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)
                                  ).astype(np.float32), jtf.arch_spec(arch_j))
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), w32)
    pt = {p: torch.from_numpy(a).to(BF16)
          for p, a in tplib.flatten(w32).items()}
    return arch_j, arch_t, pj, pt


def _f32(x) -> torch.Tensor:
    """A JAX or torch array as a float32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _ulp_of_max(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude in ``t``."""
    return 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 7)


def _ordered(t: torch.Tensor) -> torch.Tensor:
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def test_bf16_serving_steps_match_jax(llama):
    """A paged prefill of 2 prompts of 10 tokens, then 4 paged decode steps
    (slot 1 of 3 idle on the dump page), the port's bf16 logits against the
    JAX steps' (jitted on a 1 x 1 host mesh, ``PodConfig(param_dtype=
    bfloat16)``), the same tokens fed to both.  Measured: at most 1.5 bf16
    ulps of the largest logit, 0.6 % of a step's elements past one ulp
    (the packages sum in other orders, and bf16 activations round each
    difference to a whole ulp); the limits are 4 ulps and 5 %.  Then the
    monolithic steps in bf16 against JAX's (``_monolithic_bf16_steps``)."""
    arch_j, arch_t, pj, pt = llama
    mesh, pod = make_host_mesh(1, 1), jsteps.PodConfig(param_dtype=jnp.bfloat16)
    B, PL, NEW, PAGE, N_PAGES = 3, 10, 4, 4, 12
    ppr = (PL + NEW + 2) // PAGE
    table = np.full((B, ppr), N_PAGES, np.int32)
    table[0], table[2] = [3, 0, 7, 1], [5, 2, 4, 6]
    live = [0, 2]
    prompts = np.random.default_rng(0).integers(
        0, arch_t.vocab, (B, PL)).astype(np.int32)
    geo = dict(page_size=PAGE, n_pages=N_PAGES)

    def jit(build, shape, **kw):
        step, _, in_sh, out_sh = build(arch_j, shape, mesh, pod, **geo, **kw)
        return jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)

    with mesh:
        jpool = jtf.init_paged_pool(arch_j, N_PAGES, PAGE, jnp.bfloat16)
        jlast, jpool = jit(jsteps.build_paged_prefill_step,
                           JInputShape("serve", PL, 2, "prefill"),
                           pages_per_req=ppr)(
            pj, jpool, jnp.asarray(prompts[live]), jnp.asarray(table[live]))
    view = {p: t[None] for p, t in pt.items()}
    tlast, tpool = tsteps.build_paged_prefill_step(arch_t, 2, PL, PAGE)(
        view, ttf.init_paged_pool(arch_t, N_PAGES, PAGE, BF16),
        torch.as_tensor(prompts[live]).long(),
        torch.as_tensor(table[live]).long())
    assert tlast.dtype == BF16 and all(
        t.dtype == BF16 for c in tpool.values() for t in c.values())
    pairs = [(tlast, jlast)]
    decode = tsteps.build_paged_decode_step(arch_t)
    jdecode = jit(jsteps.build_paged_decode_step,
                  JInputShape("serve", ppr * PAGE, B, "decode"),
                  pages_per_req=ppr)
    tok = np.zeros((B, 1), np.int32)
    tok[live, 0] = np.asarray(jnp.argmax(jlast, -1))
    for i in range(NEW):
        pos = np.array([PL + i, 0, PL + i], np.int32)
        with mesh:
            jl, jpool = jdecode(pj, jpool, jnp.asarray(tok),
                                jnp.asarray(table), jnp.asarray(pos))
        tl, tpool = decode(view, tpool, torch.as_tensor(tok).long(),
                           torch.as_tensor(table).long(),
                           torch.as_tensor(pos).long())
        assert tl.dtype == BF16
        pairs.append((tl[live], np.asarray(jl)[live]))
        tok[live, 0] = np.asarray(jnp.argmax(jl, -1))[live]
    for i, (got, want) in enumerate(pairs):
        got, want = _f32(got), _f32(want)
        ulp, gap = _ulp_of_max(want), (got - want).abs()
        assert float(gap.max()) <= MAX_ULPS * ulp, i
        assert int((gap > ulp).sum()) <= MAX_PAST_ONE * gap.numel(), i
    _monolithic_bf16_steps()


def _monolithic_bf16_steps():
    """The monolithic steps in bf16 for the slot kinds the paged ones
    refuse (the reduced Falcon Mamba, DeepSeek-V2's MLA, InternVL with its
    embeddings), against JAX's cached ``forward`` in bf16 (jitted, its
    cache from ``init_cache(..., bfloat16)``, as the JAX serving steps run
    it): the cache's leaves in JAX's types (a Mamba slot's ``h`` float32,
    its ``conv`` bf16), and a prefill and 3 decode steps within 4 bf16 ulps
    of the largest logit.  Mamba and InternVL also within 5 % of elements
    past one ulp; measured: at most 1 ulp, none past one (on another seed
    InternVL's prefill 2 ulps, 4.3 % past one).
    MLA, measured: at most 3 ulps, 3-14 % past one, and JAX's own forward
    run op by op (``jax.disable_jit``) is as far from its jitted one (3.5
    ulps, 14.5 %): XLA fuses the bf16 einsums of the absorbed decode and
    skips their roundings.  So the MLA layer is also held bitwise to JAX's
    with those roundings kept (``_mla_layer_bitwise``)."""
    fwd = jax.jit(jtf.forward, static_argnums=0)
    B, PL, NEW = 2, 6, 3
    for name in ("falcon-mamba-7b", "deepseek-v2-236b", "internvl2-26b"):
        # the JAX decode step turns moe_gather_weights off
        arch_j = dataclasses.replace(jarchs.reduced(jarchs.get(name)),
                                     moe_gather_weights=False)
        arch_t = tarchs.reduced(tarchs.get(name))
        rng = np.random.default_rng(1)
        pj, view = _bf16_weights(arch_j, rng)
        fe = arch_t.frontend
        n_e = fe.n_embeds if fe else 0
        cap = n_e + PL + NEW
        toks = rng.integers(0, arch_t.vocab, (B, PL)).astype(np.int32)
        batch, emb = {"tokens": jnp.asarray(toks)}, None
        if fe is not None:
            emb = torch.from_numpy(rng.standard_normal(
                (B, n_e, fe.embed_dim)).astype(np.float32)).to(BF16)
            batch["embeds"] = jnp.asarray(emb.float().numpy(), jnp.bfloat16)
        jc = jtf.init_cache(arch_j, B, cap, jnp.bfloat16)
        jl, jc, _ = fwd(arch_j, pj, batch, cache=jc, pos=jnp.int32(0))
        last, cache = tsteps.build_prefill_step(arch_t, B, cap)(
            view, torch.as_tensor(toks).long(), emb)
        for path, slot in cache.items():
            g, s = path.split("/")
            for k, t in slot.items():
                assert str(t.dtype).split(".")[1] == \
                    str(jc[g][s][k].dtype).replace("int32", "int64"), \
                    (name, path, k)
        pairs = [(last, jl[:, -1])]
        decode = tsteps.build_decode_step(arch_t)
        for i in range(NEW):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(
                np.int32)
            jl, jc, _ = fwd(arch_j, pj, {"tokens": jnp.asarray(tok)},
                            cache=jc, pos=jnp.int32(n_e + PL + i))
            got, cache = decode(view, cache, torch.as_tensor(tok).long(),
                                n_e + PL + i)
            pairs.append((got, jl[:, 0]))
        for i, (got, want) in enumerate(pairs):
            assert got.dtype == BF16, (name, i)
            got, want = got.float(), _f32(want)
            ulp, gap = _ulp_of_max(want), (got - want).abs()
            assert float(gap.max()) <= MAX_ULPS * ulp, (name, i)
            if name != "deepseek-v2-236b":
                assert int((gap > ulp).sum()) <= MAX_PAST_ONE * gap.numel(), \
                    (name, i)
    _mla_layer_bitwise()


def _bf16_weights(arch_j, rng):
    """Random float32 weights rounded to bf16 on both sides: the JAX tree
    and the port's one-model view."""
    w32 = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)
                                  ).astype(np.float32), jtf.arch_spec(arch_j))
    return (jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), w32),
            {p: torch.from_numpy(a).to(BF16)[None]
             for p, a in tplib.flatten(w32).items()})


def _mla_layer_bitwise():
    """The reduced DeepSeek-V2's first MLA layer in bf16, a prefill of 9
    positions into its compressed ring and one absorbed decode step,
    against JAX's ``mla_attention`` compiled with every bf16 rounding its
    code writes (``xla_allow_excess_precision`` off: the same as its run
    op by op): output and ring bitwise, so the port rounds q's absorption,
    the logits and the probabilities to bf16 where JAX's code does."""
    arch_j = jarchs.reduced(jarchs.get("deepseek-v2-236b"))
    arch_t = tarchs.reduced(tarchs.get("deepseek-v2-236b"))
    rng = np.random.default_rng(2)
    pj, view = _bf16_weights(arch_j, rng)
    jb = JBundle(jax.tree.map(lambda a: a[0], pj["g0"])["s0"], kb="jnp")
    tb = Bundle(view, None, None, "g0/s0/", 0)
    acfg_j, acfg_t = (a.groups[0].slots[0].attn for a in (arch_j, arch_t))
    B, S = 2, 10
    x = rng.standard_normal((B, S, arch_j.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)[None]
    jc = jax.tree.map(lambda a: a[0],
                      jtf.init_cache(arch_j, B, S + 2, jnp.bfloat16)["g0"]["s0"])
    tc = ttf.init_cache(arch_t, B, S + 2, BF16, "cpu")["g0/s0"]
    tc = {k: t[0] for k, t in tc.items()}
    layer = jax.jit(lambda c, xs, pos: jlayers.mla_attention(
        jb, xs, acfg_j, pos, c, arch_j.rope_theta))
    for lo, hi in ((0, S - 1), (S - 1, S)):
        args = (jc, jx[:, lo:hi], jnp.int32(lo))
        jy, jc = layer.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
        ty = tlayers.mla_attention(tb, tx[:, :, lo:hi], acfg_t,
                                   arch_t.rope_theta, lo, tc)[0]
        assert torch.equal(ty.float(), _f32(jy)), lo
        for k in ("ckv", "krope"):
            assert torch.equal(tc[k].float(), _f32(jc[k])), (lo, k)


def test_bf16_bridge_fold_matches_jax(llama):
    """One fold of 5 messages across a τ boundary (E = 2) into bf16
    weights against JAX's bridge on the Pallas bodies (interpret mode: the
    delta summed in float32, added to W and rounded to bf16 once, the
    arithmetic of the port's kernel): every element within one bf16 ulp of
    the larger of its weight before the fold and JAX's after it (where the
    fold cancels a weight the float32 sums' order shows in the residue:
    measured at most 2 bf16 ulps of a residue of 1.5e-6, 1.2e-4 of an ulp
    of the weight), the vector leaves bitwise; the port's fold in place
    (the served tensors themselves), and the messages move the weights."""
    arch_j, arch_t, pj, pt = llama
    steps = np.asarray([1, 2, 2, 3, 3], np.int32)
    msgs = (np.array([client_seed(GSEED, int(s), i % 2)
                      for i, s in enumerate(steps)], np.uint32),
            np.full(steps.shape, 0.05, np.float32), steps)
    jb = JBridge(arch_j, JSubCGE(**SCFG, kernel_backend="interpret"), GSEED,
                 0)
    tb = LiveUpdateBridge(arch_t, SubCGEConfig(**SCFG), GSEED, 0)
    own = {p: t.clone() for p, t in pt.items()}
    ptrs = {p: t.data_ptr() for p, t in own.items()}
    jb.ingest_arrays(*msgs)
    tb.ingest_arrays(*msgs)
    want = tplib.flatten(jb.fold(pj))
    assert tb.fold(own) is own
    for p, t in own.items():
        assert t.dtype == BF16 and t.data_ptr() == ptrs[p], p
        w = _f32(want[p])
        scale = torch.maximum(w.abs(), pt[p].float().abs())
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
        assert bool(((t.float() - w).abs() <= ulp).all()), p
        if t.dim() == 1:
            assert torch.equal(t.float(), w), p
        assert not torch.equal(t, pt[p]), p


def _recording_servers(arch_j, arch_t, pj, pt, sampling):
    """A JAX and a port bf16 server on the same script, each recording the
    logits row of every token it samples, keyed by (rid, position)."""
    kw = dict(SERVE, sampling=sampling, temperature=0.8, sample_seed=3)
    jsrv = JServer(arch_j, pj, JServeConfig(**kw, param_dtype=jnp.bfloat16))
    tsrv = DecodeServer(arch_t, {p: t.clone() for p, t in pt.items()},
                        ServeConfig(**kw, param_dtype=BF16), device="cpu")
    rows = ({}, {})
    jsample, tsample = jsrv._sample, tsrv._sample

    def jrec(row, rid, pos):
        rows[0][(rid, pos)] = _f32(row)
        return jsample(row, rid, pos)

    def trec(logits, rids, emit_pos):
        rows[1].update({(r, p): logits[i].float()
                        for i, (r, p) in enumerate(zip(rids, emit_pos))})
        return tsample(logits, rids, emit_pos)
    jsrv._sample, tsrv._sample = jrec, trec
    rng = np.random.default_rng(4)
    for rid, (L, n) in enumerate(zip((6, 9, 6, 9), (5, 3, 4, 5))):
        prompt = rng.integers(0, arch_t.vocab, L).astype(np.int32)
        jsrv.submit(JRequest(rid=rid, prompt=prompt, max_new=n))
        tsrv.submit(Request(rid=rid, prompt=prompt, max_new=n))
    return jsrv, tsrv, rows


def test_bf16_server_streams_match_jax(llama):
    """4 requests through 2 slots (admission, eviction, page reuse), greedy
    and at temperature 0.8.  The two servers' bf16 rows are not bitwise
    (the packages sum in other orders): measured at most 0.0234 apart,
    0 of 17 rows bitwise.  Greedy: each stream equals JAX's up to its
    first token whose top-2 margin is no wider than that gap (measured: 13
    of the 17 tokens checked, at least 12 asserted).  Temperature: the
    port's sampler, given JAX's bf16 rows, draws JAX's token from every
    one (bf16 Gumbels, as ``jax.random.categorical`` draws them), where
    float32 Gumbels draw other tokens; and the streams equal JAX's whole
    (measured, in both samplings)."""
    arch_j, arch_t, pj, pt = llama
    for sampling in ("greedy", "temperature"):
        jsrv, tsrv, (jrows, trows) = _recording_servers(arch_j, arch_t, pj,
                                                        pt, sampling)
        want, got = jsrv.run(), tsrv.run()
        assert got == want and tsrv.stats() == jsrv.stats()
        assert set(jrows) == set(trows) and len(trows) == 17
        gap = max(float((trows[k] - jrows[k]).abs().max()) for k in trows)
        if sampling == "greedy":
            checked = 0
            for rid, stream in want.items():
                start = min(p for r, p in jrows if r == rid)
                for i, tok in enumerate(stream):
                    top2 = torch.topk(jrows[(rid, start + i)], 2).values
                    if float(top2[0] - top2[1]) <= gap:
                        break
                    assert got[rid][i] == tok, (rid, i)
                    checked += 1
            assert checked >= 12, checked
            continue
        keys = sorted(jrows)
        rows = torch.stack([jrows[k] for k in keys]).to(BF16)
        drawn = tsrv._sample(rows, [r for r, _ in keys], [p for _, p in keys])
        assert drawn == [want[r][p - min(q for s, q in keys if s == r)]
                         for r, p in keys]
        tkeys = prng.fold_in(prng.fold_in(
            prng.PRNGKey(3), torch.tensor([r for r, _ in keys])),
            torch.tensor([p for _, p in keys]))
        temp = prng.rounded(0.8, BF16)
        f32 = torch.argmax(prng.gumbel(tkeys, rows.shape[-1:])
                           + (rows / temp).float(), -1)
        assert f32.tolist() != drawn


def test_bf16_swarm_builds_bf16_and_replays(llama):
    """``ServeSwarmSim`` with a bf16 ``ServeConfig``: every server's
    weights and KV pool in bf16; under churn (server 3 away for step 1) two
    runs equal bitwise: tokens, ledger, stats and the folded weights."""
    _, arch_t, _, _ = llama
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, arch_t.vocab, 8).astype(np.int32)
               for _ in range(4)]

    def run():
        sim = ServeSwarmSim(arch_t, SubCGEConfig(**SCFG),
                            ServeConfig(**SERVE, param_dtype=BF16),
                            n_trainers=2, n_servers=2, train_steps=4,
                            global_seed=GSEED,
                            churn=ChurnSchedule.leave_rejoin((3,), 1, 2),
                            device="cpu")
        for srv in sim.servers.values():
            assert all(t.dtype == BF16 for t in srv.params.values())
            assert all(t.dtype == BF16 for c in srv.pool.values()
                       for t in c.values())
        for rid, p in enumerate(prompts):
            sim.submit(2 + rid // 2, Request(rid=rid, prompt=p, max_new=6))
        return sim.run(), sim.servers

    (a, sa), (b, sb) = run(), run()
    assert a["tokens"] == b["tokens"] and a["ledger"] == b["ledger"]
    assert a["servers"] == b["servers"]
    assert a["servers"][3]["suspends"] >= 1
    for node in sa:
        assert sa[node].bridge.stats()["messages_folded"] >= 1
        for p, t in sa[node].params.items():
            assert torch.equal(t.view(torch.int16),
                               sb[node].params[p].view(torch.int16)), p


def test_cli_dtype_rule(capsys):
    """As the JAX serve CLI: float32 with ``--reduced`` (served here on the
    CPU, the dtype on the first line), bf16 without it (the parsed config
    only: TinyLlama-1.1B whole is not built on the CPU)."""
    args = ["--batch", "2", "--requests", "3", "--prompt-len", "6", "--new",
            "3", "--device", "cpu"]
    assert tcli.main(["--reduced"] + args) == 0
    out = capsys.readouterr().out.splitlines()
    assert "float32 weights" in out[0] and "'emitted': 9" in out[0]
    _, cfg, serve = tcli.parse(args)
    assert serve.param_dtype == BF16 and cfg.name == "tinyllama-1.1b"
    _, cfg, serve = tcli.parse(["--reduced"] + args)
    assert serve.param_dtype == torch.float32
    assert cfg.name == "tinyllama-1.1b-reduced"
