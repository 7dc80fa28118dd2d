"""Host-side units and sampling of the port's serving path
(``repro_torch.serve``, ``core.prng``) against the JAX package.

* page allocator and scheduler: tables, free lists, admission order and
  decode inputs equal to the JAX package's on the same script;
* ``ServeConfig``'s refusals (float16 among them: it serves float32 and
  bf16);
* ``prng.gumbel`` / ``categorical``: bitwise ``jax.random``.

The serving tests are split into files of at most five tests (under
``pytest -n --dist loadfile`` files with more tests are dispatched first,
so these run after the suite's long files of few tests):
``test_torch_serve_model.py`` (the decode forward, the bridge fold, live
updates), ``test_torch_serve_entry.py`` (the CLI, the refusals of the
entry points) and ``test_torch_serve_swarm.py`` (the server and the swarm
against the JAX package's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import Request as JRequest, Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.serve import (PageAllocator, Request, Scheduler,  # noqa: E402
                               ServeConfig, bucket_pages, pages_needed)


# ---------------------------------------------------------------------------
# host-side units against the JAX package
# ---------------------------------------------------------------------------

def test_page_allocator_and_buckets_match_jax():
    from repro.serve import PageAllocator as JAlloc
    from repro.serve import bucket_pages as jbucket, pages_needed as jneeded
    for n in range(0, 20):
        for ps in (1, 4, 16):
            assert pages_needed(n, ps) == jneeded(n, ps)
        for ppr in (1, 5, 8):
            assert bucket_pages(n, ppr) == jbucket(n, ppr)
    a, j = (PageAllocator(9, 4, 3, 4), JAlloc(9, 4, 3, 4))
    for op, slot, k in (("alloc", 0, 3), ("alloc", 1, 4), ("release", 0, 0),
                        ("alloc", 2, 2), ("alloc", 0, 1), ("release", 1, 0),
                        ("alloc", 1, 4)):
        got = getattr(a, op)(slot, k) if op == "alloc" else a.release(slot)
        want = getattr(j, op)(slot, k) if op == "alloc" else j.release(slot)
        assert got == want
        np.testing.assert_array_equal(a.table, j.table)
        assert a._free == j._free and a.dump == j.dump == 9
    with pytest.raises(ValueError):
        PageAllocator(3, 4, 1, 4)


def test_scheduler_matches_jax_on_a_script():
    kw = dict(max_batch=2, page_size=4, n_pages=6, max_seq=16)
    s, j = Scheduler(ServeConfig(**kw)), JScheduler(JServeConfig(**kw))
    lens = [6, 6, 2, 9, 3]
    for rid, L in enumerate(lens):
        s.submit(Request(rid=rid, prompt=np.arange(L), max_new=3))
        j.submit(JRequest(rid=rid, prompt=np.arange(L), max_new=3))
    with pytest.raises(ValueError):
        s.submit(Request(rid=9, prompt=np.arange(14), max_new=3))
    tok = 0
    while not s.done:
        got = [(i, r.rid) for i, r in s.admit()]
        assert got == [(i, r.rid) for i, r in j.admit()]
        for x, y in zip(s.decode_inputs(), j.decode_inputs()):
            np.testing.assert_array_equal(x, y)
        assert s.decode_bucket() == j.decode_bucket()
        for slot in s.active_slots():
            tok += 1
            assert s.record_emit(slot, tok) == j.record_emit(slot, tok)
            if s.slots[slot] is not None:
                s.advance(slot)
                j.advance(slot)
        np.testing.assert_array_equal(s.alloc.table, j.alloc.table)
        assert s.alloc._free == j.alloc._free
    assert j.done and s.n_evicted == j.n_evicted == len(lens)


def test_serve_config_validation():
    assert ServeConfig().pages_per_req == 128 // 16
    # float32 and bf16 serve, as in the JAX package; no kernel of the port
    # takes float16
    assert ServeConfig(param_dtype=torch.bfloat16).param_dtype \
        == torch.bfloat16
    for bad in (dict(sampling="nucleus"), dict(max_seq=100, page_size=16),
                dict(sampling="temperature", temperature=0.0),
                dict(param_dtype=torch.float16)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ServeConfig(param_dtype=torch.float16)


# ---------------------------------------------------------------------------
# sampling: bitwise jax.random
# ---------------------------------------------------------------------------

def test_gumbel_and_categorical_bitwise_jax():
    for seed in (0, 7, 2**32 - 1):
        key = jax.random.PRNGKey(jnp.uint32(seed))
        want = np.asarray(jax.random.gumbel(key, (4096,)))
        got = prng.gumbel(prng.PRNGKey(seed), (4096,)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        # the server's keys: fold_in(fold_in(PRNGKey(seed), rid), pos)
        rids, pos = np.array([0, 3, 5]), np.array([11, 12, 40])
        lg = np.random.default_rng(seed).standard_normal((3, 256)).astype(
            np.float32)
        want = [int(jax.random.categorical(
            jax.random.fold_in(jax.random.fold_in(key, r), p),
            jnp.asarray(lg[i]) / 0.8)) for i, (r, p) in enumerate(zip(rids,
                                                                     pos))]
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed),
                                         torch.as_tensor(rids)),
                            torch.as_tensor(pos))
        assert prng.categorical(keys, torch.as_tensor(lg) / 0.8).tolist() \
            == want


