"""Pair run of the bf16 rank-1 products: an older commit's
``rank1_gemm_bf16`` against this tree's, in one process on one card, and
phase 19 (a)'s InternVL2-26B pod step in both trees.

Before the chip call, put the older commit's files beside this script
(``REF`` is that commit, e.g. the parent of the change)::

    git show REF:src/repro_torch/kernels/csrc/rank1_matmul.cu \\
        > _proof/parent_rank1_matmul.cu
    mkdir -p _proof/parent && git archive REF | tar -x -C _proof/parent

``--kernels`` builds the older kernel with its own C signature and split
plan (``_proof/parent/src/repro_torch/kernels/rank1_matmul.py``) into
``_proof/_build_parent`` and, at every bf16 product unit of phase 2
(InternVL2-26B's pod: seven projections and the untied logits, 8 clients
over one W, M = 2114; its projector; Qwen1.5-0.5B's tied logits; the Jamba
cut's experts), checks both kernels against the plain version summed over
each kernel's own K ranges (one bf16 ulp + atol + ``tensor_core_atol``),
this tree's bitwise across two calls, and times them in turns (old, new,
new, old) with CUDA events, ``baddbmm`` in bf16 once beside them.
``--steps`` runs ``chip_smoke.bf16_internvl`` (phase 19 (a)) in the older
tree and this one, in turns (``--step-turns``: old, new[, new, old]), each
in its own process.  Results go to ``--out`` as JSON.

    python _proof/pair27.py --kernels --steps --out results/pair27.json
"""
import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rank1_matmul as r1  # noqa: E402

HERE = Path(__file__).resolve().parent


def parent_module():
    """The older tree's rank1_matmul.py (its split plan), as its own
    module."""
    path = HERE / "parent/src/repro_torch/kernels/rank1_matmul.py"
    spec = importlib.util.spec_from_file_location("parent_r1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parent():
    out = HERE / "_build_parent"
    out.mkdir(exist_ok=True)
    so = out / "parent_rank1.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
           str(HERE / "parent_rank1_matmul.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    r.check_returncode()
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rank1_matmul_bf16.argtypes = [P] * 8 + [I] * 8 + [L] * 10 + [P]
    lib.rank1_matmul_bf16.restype = I
    return lib


def parent_gemm(lib, pr1, x, W, u, v, s, E, trans):
    """The older kernel on x (C, [E,] M, K), W (C, [E,] K, N) or (C, O, K)
    (``trans``), with its own plan; returns y and (splits, kper)."""
    C, M, K = x.shape[0], x.shape[-2], x.shape[-1]
    N = W.shape[-2] if trans else W.shape[-1]
    cvec, ovec = (v, u) if trans else (u, v)
    splits, kper = pr1.split_plan(C * E, M, N, K, bf16=True)
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    part = None if splits == 1 else torch.empty(
        splits * C * E * M * (N + 1), dtype=torch.float32, device=x.device)
    pad = None
    if not trans and N % 8:
        copies = (1 if W.stride(0) == 0 else C) * E
        pad = torch.empty(copies * K * (-(-N // 8) * 8),
                          dtype=torch.bfloat16, device=x.device)
    if E == 1:
        st = (x.stride(0), 0, W.stride(0), 0, cvec.stride(0), 0,
              ovec.stride(0), 0, M * N, 0)
    else:
        st = (*x.stride()[:2], *W.stride()[:2], *cvec.stride()[:2],
              *ovec.stride()[:2], E * M * N, M * N)
    err = lib.rank1_matmul_bf16(
        x.data_ptr(), W.data_ptr(), cvec.data_ptr(), ovec.data_ptr(),
        s.data_ptr(), y.data_ptr(), None if part is None else part.data_ptr(),
        None if pad is None else pad.data_ptr(), C, E, M, N, K, splits, kper,
        int(trans), *st, build.stream_of(x))
    build.check(err, "parent rank1_matmul_bf16")
    return y, (splits, kper)


def units():
    """(unit, kind, C, E, M, K, N, count, shared) of every bf16 product
    shape of phase 2."""
    vl, qwen, jamba = (archs.get("internvl2-26b"), archs.get("qwen1.5-0.5b"),
                       archs.jamba_cut())
    slot = vl.groups[0].slots[0]
    a, d, ff = slot.attn, vl.d_model, slot.d_ff
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    P = vl.frontend.n_embeds
    M = cs.POD_B * (P + cs.POD_TEXT)
    layer: dict = {}
    for shape in ([(d, q), (d, kv), (d, kv), (q, d), (d, ff)]
                  + [(d, ff)] * vl.gated_mlp + [(ff, d), (d, vl.vocab)]):
        layer[shape] = layer.get(shape, 0) + 1
    out = [("internvl_pod", "n", cs.POD_CLIENTS, 1, M, K, N, n, True)
           for (K, N), n in layer.items()]
    out.append(("internvl_proj", "n", cs.POD_CLIENTS, 1, cs.POD_B * P,
                vl.frontend.embed_dim, d, 1, True))
    out.append(("qwen_tied", "t", cs.SLICE_CLIENTS, 1, cs.SLICE_B * 33,
                qwen.d_model, qwen.vocab, 1, True))
    mo = next(s for grp in jamba.groups for s in grp.slots if s.moe).moe
    cap = max(1, math.ceil(cs.SLICE_B * 33 * mo.top_k / mo.n_experts
                           * mo.capacity_factor))
    for (K, N), n in (((jamba.d_model, mo.d_ff_expert), 2),
                      ((mo.d_ff_expert, jamba.d_model), 1)):
        out.append(("jamba_experts", "e", cs.JAMBA_CLIENTS, mo.n_experts,
                    cap, K, N, n, False))
    return out


def kernels(reps):
    lib, pr1 = build_parent(), parent_module()
    build.build_all()
    for rep in cs.ptxas_report("rank1_matmul"):
        print("ptxas new:", rep, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    rows = []
    for unit, kind, C, E, M, K, N, count, shared in units():
        trans = kind == "t"
        lead = (C, E) if kind == "e" else (C,)
        x = randn(*lead, M, K).bfloat16()
        CW = 1 if shared else C
        wsh = (N, K) if trans else (K, N)
        W = randn(CW, *lead[1:], *wsh, scale=K ** -0.5).bfloat16()
        W = W.expand(*lead, *wsh)
        cvec, ovec = randn(*lead, K, scale=K ** -0.5), randn(*lead, N)
        u, v = (ovec, cvec) if trans else (cvec, ovec)
        s = torch.tensor(([1e-3, -1e-3] * C)[:C], device=dev)
        fn = {"n": ops.rank1_matmul, "t": ops.rank1_matmul_t,
              "e": ops.rank1_matmul_expert}[kind]
        plain = {"n": r1.rank1_matmul_plain, "t": r1.rank1_matmul_t_plain,
                 "e": r1.rank1_matmul_expert_plain}[kind]

        def new():
            return fn(x, W, u, v, s)

        def old():
            return parent_gemm(lib, pr1, x, W, u, v, s, E, trans)[0]
        got, again = new(), new()
        cs.same_bits(got, again, "new kernel")
        ref, old_plan = parent_gemm(lib, pr1, x, W, u, v, s, E, trans)
        fold = r1.folds(C, E, M, K, x.stride(0), W.stride(0))
        new_plan = r1.gemm_plan(C, E, M, N, K, bf16=True, fold=fold)
        xf, Wf = r1.to_f32(x), r1.to_f32(W)
        checks = {}
        for tag, out, (splits, kper) in (("new", got, new_plan),
                                         ("old", ref, old_plan)):
            if trans:
                def chunk(k0, k1):
                    return plain(xf[..., k0:k1], Wf[..., k0:k1], u,
                                 v[..., k0:k1], s)
            else:
                def chunk(k0, k1):
                    return plain(xf[..., k0:k1], Wf[..., k0:k1, :],
                                 u[..., k0:k1], v, s)
            want = cs.plain_split(chunk, K, kper).bfloat16()
            checks[tag] = cs.bf16_excess(out, want, cs.tensor_core_atol(K))
            del want
        del xf, Wf, got, again, ref
        torch.cuda.empty_cache()
        t = [cs.time_ms(old if w == "old" else new, reps, 1)
             for w in ("old", "new", "new", "old")]
        xb = x.reshape(-1, M, K)
        Wn = (W.transpose(-1, -2) if trans else W).reshape(-1, K, N)
        R = torch.zeros((xb.shape[0], M, N), dtype=x.dtype, device=dev)
        lib_ms = cs.time_ms(lambda: cs.cublas_f32_sums(
            lambda: torch.baddbmm(R, xb, Wn)), reps, 1)
        B = C * E
        flops = 2 * B * M * K * (N + 1) + 3 * B * M * N
        nbytes = 2 * (B * M * K + CW * E * K * N + B * M * N) \
            + 4 * (B * K + B * N + C)
        bound = cs.bound(nbytes, flops, cs.PEAK_BF16_FLOPS)[0]
        new_ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        row = {"unit": unit, "kind": kind, "C": C, "E": E, "M": M, "K": K,
               "N": N, "count": count, "shared": shared, "fold": fold,
               "plan_new": new_plan, "plan_old": old_plan,
               "ms_old_new_new_old": t, "old_ms": old_ms, "new_ms": new_ms,
               "baddbmm_ms": lib_ms, "bound_ms": bound,
               "new_share": bound / new_ms, "old_share": bound / old_ms,
               "new_tflops": flops / new_ms / 1e9,
               "checks": {k: {n: c[n] for n in ("bad", "past_ulp", "excess",
                                                "same")}
                          for k, c in checks.items()}}
        print(json.dumps(row), flush=True)
        if any(c["bad"] for c in checks.values()):
            raise AssertionError(f"{unit} {K}x{N}: a kernel disagrees with "
                                 f"the plain version: {row['checks']}")
        rows.append(row)
        del x, W, u, v, cvec, ovec, R, xb, Wn
        torch.cuda.empty_cache()
    sums = {}
    for r in rows:
        u = sums.setdefault(r["unit"], {"old_ms": 0.0, "new_ms": 0.0,
                                        "baddbmm_ms": 0.0, "bound_ms": 0.0})
        for k in u:
            u[k] += r["count"] * r[k]
    for name, u in sums.items():
        u["new_share"] = u["bound_ms"] / u["new_ms"]
        u["old_share"] = u["bound_ms"] / u["old_ms"]
        u["new_vs_baddbmm"] = u["new_ms"] / u["baddbmm_ms"]
        u["old_vs_baddbmm"] = u["old_ms"] / u["baddbmm_ms"]
        print("unit", name, json.dumps(u), flush=True)
    return {"shapes": rows, "units": sums}


STEP_CODE = """
import json, sys
sys.path[:0] = ['.', 'src']
import torch
import chip_smoke as cs
from repro_torch.configs import archs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
out = cs.bf16_internvl(archs.get(cs.BF16_ARCH), cs.card_line())
print('JSON' + json.dumps({k: out[k] for k in ('step_s', 'steady_step_ms',
      'peak_gib', 'launches', 'profile', 'init_s')}, default=str))
"""


def steps(turns):
    res = []
    order = ("parent", "child", "child", "parent")[:turns]
    for tag in order:
        tree = HERE / "parent" if tag == "parent" else Path(".")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", STEP_CODE], cwd=tree,
                           capture_output=True, text=True, timeout=900)
        print(tag, "rc", r.returncode, f"{time.perf_counter() - t0:.1f} s",
              r.stdout[-1500:], r.stderr[-2500:], flush=True)
        r.check_returncode()
        line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][-1]
        res.append({"tree": tag, **json.loads(line[4:])})
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--step-turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="results/pair27.json")
    args = ap.parse_args()
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card}
    if args.kernels:
        out["kernels"] = kernels(args.reps)
    if args.steps:
        out["steps"] = steps(args.step_turns)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print("OK")


if __name__ == "__main__":
    main()
