"""The decode halves of the port's forward, the live-update bridge and
decoding under live updates, against the JAX package, at the reduced
TinyLlama (plus one reduced OPT-125M case for learned positions and one
reduced Kimi K2 case for the MoE FFN).

* prefill, then 4 monolithic and 4 paged decode steps: logits within
  atol 1e-5 of JAX's ``forward`` on the same weights (float32 sums in
  other orders; the two packages' tokens agree);
* a bridge fold: params within atol 1e-6 of the JAX fold on the same inbox;
* decoding under live updates equals folding offline at the same step
  boundaries and decoding monolithically, token for token, and the folded
  weights are bitwise the offline ones.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.core.seeds import client_seed  # noqa: E402
from repro.core.subcge import SubCGEConfig as JSubCGE  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import LiveUpdateBridge as JBridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core.subcge import SubCGEConfig  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import params as tplib, transformer as ttf  # noqa: E402
from repro_torch.serve import (DecodeServer, LiveUpdateBridge,  # noqa: E402
                               Request, ServeConfig, bucket_pages,
                               pages_needed)

from _torch_parity import one_thread, weights  # noqa: E402,F401

LOGIT_ATOL = 1e-5
FOLD_ATOL = 1e-6
B, PL, NEW = 3, 10, 4
CAP = PL + NEW + 2          # monolithic ring capacity
PAGE, N_PAGES = 4, 12


def _pair(name):
    return (jarchs.reduced(jarchs.get(name)),
            tarchs.reduced(tarchs.get(name)))


@pytest.fixture(scope="module")
def llama():
    arch_j, arch_t = _pair("tinyllama-1.1b")
    (jparams,), _ = weights(arch_j, 1)
    return arch_j, arch_t, jparams, tplib.from_numpy(jparams)


def _prompts(vocab, n=B, L=PL, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, L)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the decode halves of the forward against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-1.1b", "opt-125m",
                                  "kimi-k2-1t-a32b", "gemma3-1b"])
def test_prefill_and_decode_logits_match_jax(name, one_thread):
    """Prefill, 4 monolithic decode steps over a ring, and 4 paged decode
    steps over a pool filled by write_prefill_to_pages (slot 1 of 3 idle,
    pointing at the dump page), each against JAX's forward.  The reduced
    Gemma's window (16) is longer than the prompt (10) here: JAX's paged
    path is right there (tests/test_torch_gemma.py holds the prompt past
    the window)."""
    arch_j, arch_t = _pair(name)
    # the JAX decode steps turn moe_gather_weights off
    arch_j = dataclasses.replace(arch_j, moe_gather_weights=False)
    (jp,), tp = weights(arch_j, 1, seed=1)
    fwd = jax.jit(jtf.forward, static_argnums=0)
    prompts = _prompts(arch_t.vocab)

    def close(got, want, what):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=what)

    # monolithic: prefill then decode over a ring of capacity CAP
    jc = jtf.init_cache(arch_j, B, CAP, jnp.float32)
    jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(prompts)},
                    cache=jc, pos=0)
    tc = ttf.init_cache(arch_t, B, CAP)
    tl, _ = ttf.forward(arch_t, tp, torch.as_tensor(prompts)[None],
                        cache=tc, pos=0)
    close(tl[0], jl, "prefill")
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(NEW):
        jl, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(tok)},
                        cache=jc, pos=jnp.int32(PL + i))
        tl, _ = ttf.forward(arch_t, tp, torch.as_tensor(tok)[None],
                            cache=tc, pos=PL + i)
        close(tl[0], jl, f"monolithic decode {i}")
        assert (tl[0, :, 0].argmax(-1).numpy()
                == np.asarray(jnp.argmax(jl[:, 0], -1))).all()
        tok = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None].astype(np.int32)
    for key, c in tc.items():
        np.testing.assert_array_equal(
            c["kpos"].numpy(), np.asarray(jc["g0"][key.split("/")[1]]["kpos"]))

    # paged: rows 0 and 2 hold requests, row 1 is idle (dump page)
    ppr = CAP // PAGE
    table = np.full((B, ppr), N_PAGES, np.int32)
    table[0] = [3, 0, 7, 1]
    table[2] = [5, 2, 4, 6]
    live = [0, 2]
    jpool = jtf.init_paged_pool(arch_j, N_PAGES, PAGE, jnp.float32)
    tpool = ttf.init_paged_pool(arch_t, N_PAGES, PAGE)
    jc = jtf.init_cache(arch_j, 2, PL, jnp.float32)
    _, jc, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(prompts[live])},
                   cache=jc, pos=0)
    jpool = jtf.write_prefill_to_pages(arch_j, jc, jpool,
                                       jnp.asarray(table[live]), PAGE)
    prefill = tsteps.build_paged_prefill_step(arch_t, 2, PL, PAGE)
    _, tpool = prefill(tp, tpool, torch.as_tensor(prompts[live]).long(),
                       torch.as_tensor(table[live]).long())
    for key, pl in tpool.items():
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                pl[kv][:, :N_PAGES].numpy(),
                np.asarray(jpool["g0"][key.split("/")[1]][kv])[:, :N_PAGES],
                rtol=0, atol=LOGIT_ATOL)
    decode = tsteps.build_paged_decode_step(arch_t)
    tok = prompts[:, -1:].copy()
    tok[1] = 0
    for i in range(NEW):
        pos = np.array([PL + i, 0, PL + i], np.int32)
        bucket = bucket_pages(pages_needed(PL + i + 1, PAGE), ppr)
        jl, jpool, _ = fwd(arch_j, jp, {"tokens": jnp.asarray(tok)},
                           cache=jpool, pos=jnp.asarray(pos),
                           paged_table=jnp.asarray(table[:, :bucket]))
        tl, tpool = decode(tp, tpool, torch.as_tensor(tok).long(),
                           torch.as_tensor(table[:, :bucket]).long(),
                           torch.as_tensor(pos).long())
        close(tl[live], np.asarray(jl[:, 0])[live], f"paged decode {i}")
        tok[live] = np.asarray(jnp.argmax(jl[:, 0], -1))[live, None]
        assert (tl[live].argmax(-1).numpy() == tok[live, 0]).all()


# ---------------------------------------------------------------------------
# live updates
# ---------------------------------------------------------------------------

SCFG = dict(rank=4, refresh_period=2, eps=1e-3)
GSEED = 7


def _msg_batch(steps):
    steps = np.asarray(steps, np.int32)
    seeds = np.array([client_seed(GSEED, int(s), i % 2)
                      for i, s in enumerate(steps)], np.uint32)
    return seeds, np.full(steps.shape, 0.05, np.float32), steps


B1 = _msg_batch([0, 0, 1, 1])          # epochs {0}
B2 = _msg_batch([1, 2, 2, 3, 3])       # epochs {0, 2}: crosses τ = 2


def test_bridge_fold_matches_jax(llama, one_thread):
    arch_j, arch_t, jparams, _ = llama
    jb = JBridge(arch_j, JSubCGE(**SCFG, kernel_backend="jnp"), GSEED, 0)
    tb = LiveUpdateBridge(arch_t, SubCGEConfig(**SCFG), GSEED, 0)
    tparams = tplib.from_numpy(jparams)
    # one fold whose messages cross a τ boundary (E = 2), one JAX compile
    assert jb.ingest_arrays(*B2) == tb.ingest_arrays(*B2) == 5
    jparams = jb.fold(jparams)
    assert tb.fold(tparams) is tparams
    want = tplib.flatten(jax.tree.map(np.asarray, jparams))
    for p, t in tparams.items():
        np.testing.assert_allclose(t.numpy(), want[p], rtol=0,
                                   atol=FOLD_ATOL, err_msg=p)
    assert tb.stats() == jb.stats() == {"messages_folded": 5, "n_folds": 1,
                                        "pending": 0}
    # inbox padding (step -1) is skipped
    assert tb.ingest_arrays(np.array([3, 0], np.uint32),
                            np.array([0.1, 0.0], np.float32),
                            np.array([0, -1], np.int32)) == 1


def _monolithic(arch, params, prompts, fold_at):
    """Greedy prefill + decode over a ring of capacity CAP, switching to
    ``fold_at[i]`` at decode-step boundary i (0 = before the prefill)."""
    def view(p):
        return {k: t[None] for k, t in p.items()}
    decode = tsteps.build_decode_step(arch)
    p = view(fold_at.get(0, params))
    cache = ttf.init_cache(arch, len(prompts), CAP)
    lg, _ = ttf.forward(arch, p, torch.as_tensor(prompts).long()[None],
                        cache=cache, pos=0)
    tok = lg[0, :, -1].argmax(-1)[:, None]
    out = [tok]
    for i in range(NEW - 1):
        if i + 1 in fold_at:
            p = view(fold_at[i + 1])
        lg, cache = decode(p, cache, tok, PL + i)
        tok = lg.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, 1).numpy()


def test_decode_under_live_updates_matches_offline_fold(llama, one_thread):
    _, arch, _, base = llama
    prompts = _prompts(arch.vocab, n=4, seed=2)
    scfg = SubCGEConfig(**SCFG)
    ref_bridge = LiveUpdateBridge(arch, scfg, GSEED, 0)
    p1 = {p: t.clone() for p, t in base.items()}
    ref_bridge.ingest_arrays(*B1)
    ref_bridge.fold(p1)
    p2 = {p: t.clone() for p, t in p1.items()}
    ref_bridge.ingest_arrays(*B2)
    ref_bridge.fold(p2)
    ref = _monolithic(arch, base, prompts, {0: p1, 2: p2})
    assert not np.array_equal(ref, _monolithic(arch, base, prompts, {}))

    serve = ServeConfig(max_batch=4, page_size=PAGE, n_pages=16, max_seq=CAP)
    bridge = LiveUpdateBridge(arch, scfg, GSEED, 0)
    own = {p: t.clone() for p, t in base.items()}
    srv = DecodeServer(arch, own, serve, bridge=bridge, device="cpu")
    for b in range(4):
        srv.submit(Request(rid=b, prompt=prompts[b], max_new=NEW))
    bridge.ingest_arrays(*B1)
    srv.step()                                  # fold B1 -> prefill + decode 1
    bridge.ingest_arrays(*B2)
    srv.step()                                  # fold B2 -> decode 2
    srv.step()                                  # decode 3
    assert srv.sched.done
    np.testing.assert_array_equal(
        np.array([srv.results[b] for b in range(4)]), ref)
    for p, t in own.items():
        assert torch.equal(t, p2[p]), p
    assert srv.stats()["bridge"] == {"messages_folded": 9, "n_folds": 2,
                                     "pending": 0}


