"""Pair run of the SubCGE update: an older commit's ``subcge_apply.cu`` and
wrapper against this tree's, in one process on one card, at every update
unit of ``chip_smoke.py`` phase 2; and phase 19 (a)'s InternVL2-26B pod
step in both trees.

Before the chip call, put the older commit's files beside this script
(``REF`` is that commit, e.g. the parent of the change)::

    git show REF:src/repro_torch/kernels/csrc/subcge_apply.cu \\
        > _proof/parent_subcge_apply.cu
    mkdir -p _proof/parent && git archive REF | tar -x -C _proof/parent

``--kernels`` builds the older kernel with its own C signature into
``_proof/_build_parent`` and takes its plan (``update_plan`` and, past rank
32, ``rank_blocks``) from ``_proof/parent/src/repro_torch/kernels/
subcge_apply.py``.  At every leaf of every phase-2 update unit it times
both in turns (old, new, new, old; CUDA events, out of place) and
  * float32 at r <= 32 (the stream both trees keep): checks that the new
    tree's output is bitwise the older one's;
  * bf16, and r = 64 (the tensor-core kernel): holds both against the plain
    version (float32 rtol / atol 1e-5; bf16 one ulp + 1e-5), records the
    share of elements bitwise the plain version's, checks the new one
    bitwise across two calls, and times ``baddbmm`` (in W's type) once.
``--steps`` runs ``chip_smoke.bf16_internvl`` (phase 19 (a)) in the older
tree and this one, in turns (``--step-turns``: old, new[, new, old]), each
in its own process.  Results go to ``--out`` as JSON.

    python _proof/pair28.py --kernels --steps --out results/pair28.json
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
from repro_torch.kernels import subcge_apply as sa  # noqa: E402

HERE = Path(__file__).resolve().parent


def parent_module():
    """The older tree's subcge_apply.py (its plan), as its own module."""
    path = HERE / "parent/src/repro_torch/kernels/subcge_apply.py"
    spec = importlib.util.spec_from_file_location("parent_sa", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_sa"] = mod   # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def build_parent():
    out = HERE / "_build_parent"
    out.mkdir(exist_ok=True)
    so = out / "parent_subcge_apply.so"
    src = HERE / "parent_subcge_apply.cu"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in ("subcge_apply_f32", "subcge_apply_bf16"):
        getattr(lib, fn).argtypes = [P] * 5 + [I] * 11 + [L] * 2 + [P]
        getattr(lib, fn).restype = I
    return lib


def parent_update(lib, psa, W, blocks):
    """The older kernel out of place on W (nb, n, m) with the rank-blocked
    (U, A, V) of ``blocks``."""
    U, A, V = blocks
    E, n, r = U.shape
    nb, m = W.shape[0], V.shape[1]
    plan = psa.update_plan(nb, n, m, r, E)
    out = torch.empty_like(W)
    fn = lib.subcge_apply_bf16 if W.dtype == torch.bfloat16 \
        else lib.subcge_apply_f32
    err = fn(W.data_ptr(), out.data_ptr(), U.data_ptr(), A.data_ptr(),
             V.data_ptr(), E, nb, n, m, r, plan.bc.bit_length() - 1,
             plan.chunks, plan.per, plan.blocks, plan.groups,
             plan.smem_bytes, W.stride(0), out.stride(0), build.stream_of(W))
    build.check(err, "parent subcge_apply")
    return out


def units():
    """(unit, arch, clients, E, r, bf16) of every phase-2 update unit."""
    qwen, opt = archs.get("qwen1.5-0.5b"), archs.get("opt-125m")
    C = cs.SLICE_CLIENTS
    out = []
    for tag, arch, n, extra in (
            ("qwen", qwen, C, (2, 4)), ("kimi", archs.kimi_cut(), C, ()),
            ("falcon", archs.falcon_cut(), C, ()),
            ("opt", opt, cs.PAPER_CLIENTS, (2,)),
            ("gemma", archs.get(cs.GEMMA_ARCH), C, ()),
            ("qwen2", archs.qwen2_cut(), cs.QWEN2_CLIENTS, ()),
            ("deepseek", archs.deepseek_cut(), cs.DEEPSEEK_CLIENTS, ()),
            ("jamba", archs.jamba_cut(), cs.JAMBA_CLIENTS, ()),
            ("musicgen", archs.get(cs.MUSICGEN_ARCH), C, ()),
            ("internvl_pod", archs.internvl_cut(), 1, ())):
        out.append((tag, arch, n, 1, 16, False))
        out += [(f"{tag}_e{E}", arch, n, E, 16, False) for E in extra]
    for tag, arch in (("serve", archs.get(cs.SERVE_ARCH)),
                      ("gemma_serve", archs.get(cs.GEMMA_ARCH))):
        out += [(tag, arch, 1, 1, 16, False),
                (f"{tag}_e{cs.SERVE_FOLD_E}", arch, 1, cs.SERVE_FOLD_E, 16,
                 False)]
    out += [("internvl_pod_bf16", archs.get(cs.BF16_ARCH), 1, 1, 16, True),
            ("qwen_bf16_e2", qwen, 1, 2, 16, True)]
    for E, tag in ((1, "qwen_r64"), (2, "qwen_r64_e2")):
        out += [(tag, qwen, 1, E, cs.RANK_SWEEP, False),
                (tag + "_bf16", qwen, 1, E, cs.RANK_SWEEP, True)]
    return out


def close(got, want, bf16):
    """(max abs error, elements past the tolerance, share bitwise)."""
    if bf16:
        x = cs.bf16_excess(got, want, 0.0)
        return x["err"], x["bad"], x["same"]
    diff = (got - want).abs()
    bad = int((diff > cs.ATOL + cs.RTOL * want.abs()).sum())
    same = float((got.view(torch.int32) == want.view(torch.int32))
                 .float().mean())
    return float(diff.max()), bad, same


def kernels(reps):
    lib, psa = build_parent(), parent_module()
    build.build_all()
    for rep in cs.ptxas_report("subcge_apply"):
        print("ptxas new:", rep, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    rows = []
    for unit, arch, C, E, r, bf16 in units():
        dt, esz = (torch.bfloat16, 2) if bf16 else (torch.float32, 4)
        changed = sa.uses_tensor_cores(bf16, r)
        for batch, n, m, count in cs.update_leaves(arch, C):
            nb = math.prod(batch)
            step = max(1, cs.CHECK_SLICE_BYTES // (4 * n * m))
            W = torch.empty((nb, n, m), dtype=dt, device=dev)
            for lo in range(0, nb, step):
                W[lo:lo + step] = randn(min(nb, lo + step) - lo, n, m,
                                        scale=0.05)
            U, V = randn(E, n, r), randn(E, m, r)
            A = randn(E, nb, r, r, scale=1e-2)
            blocks = psa.rank_blocks(U, A, V)

            def new():
                return ops.subcge_apply_epochs(W, U, A, V)

            def old():
                return parent_update(lib, psa, W, blocks)
            got = new()
            cs.same_bits(got, new(), "new kernel")
            ref = old()
            row = {"unit": unit, "E": E, "r": r, "dtype": str(dt),
                   "W": [nb, n, m], "count": count, "tensor_cores": changed}
            if not changed:
                row["bitwise_parent"] = bool(torch.equal(
                    cs.bits(got), cs.bits(ref)))
                if not row["bitwise_parent"]:
                    raise AssertionError(f"{unit} {row['W']}: the float32 "
                                         f"stream is not the parent's")
            else:
                res = {"new": [0.0, 0, 0.0], "old": [0.0, 0, 0.0]}
                for lo in range(0, nb, step):
                    hi = min(nb, lo + step)
                    want = sa.subcge_apply_epochs_plain(W[lo:hi], U,
                                                        A[:, lo:hi], V)
                    for tag, out in (("new", got), ("old", ref)):
                        err, bad, same = close(out[lo:hi], want, bf16)
                        x = res[tag]
                        x[0] = max(x[0], err)
                        x[1] += bad
                        x[2] += same * (hi - lo) / nb
                    del want
                row["checks"] = {k: {"max_abs_err": v[0], "bad": v[1],
                                     "same": v[2]} for k, v in res.items()}
                if res["new"][1] or res["old"][1]:
                    raise AssertionError(f"{unit} {row['W']}: disagrees "
                                         f"with the plain version: "
                                         f"{row['checks']}")
            del got, ref
            torch.cuda.empty_cache()
            t = [cs.time_ms(old if w == "old" else new, reps, 1)
                 for w in ("old", "new", "new", "old")]
            nbytes = esz * 2 * nb * n * m \
                + 4 * E * (n * r + m * r + nb * r * r)
            flops = 2 * E * nb * (n * m * r + n * r * r)
            row.update({"ms_old_new_new_old": t,
                        "old_ms": (t[0] + t[3]) / 2,
                        "new_ms": (t[1] + t[2]) / 2,
                        "bound_ms": cs.bound(nbytes, flops,
                                             cs.PEAK_BF16_FLOPS if bf16
                                             else cs.PEAK_F32_FLOPS)[0]})
            if changed:
                UA = torch.einsum("enr,ebrs->bnes", U, A).reshape(
                    nb, n, E * r).to(dt)
                Vt = V.permute(0, 2, 1).reshape(E * r, m).expand(
                    nb, E * r, m).to(dt)
                row["baddbmm_ms"] = cs.time_ms(
                    lambda: torch.baddbmm(W, UA, Vt), reps, 1)
                row["tf32_tflops"] = 6 * nb * n * m * E * (-(-r // 8) * 8) \
                    / row["new_ms"] / 1e9
                del UA, Vt
            print(json.dumps(row), flush=True)
            rows.append(row)
            del W, U, V, A, blocks
            torch.cuda.empty_cache()
    sums = {}
    for r in rows:
        u = sums.setdefault(r["unit"], {"old_ms": 0.0, "new_ms": 0.0,
                                        "bound_ms": 0.0, "baddbmm_ms": 0.0,
                                        "spread": 0.0})
        for k in ("old_ms", "new_ms", "bound_ms", "baddbmm_ms"):
            u[k] += r["count"] * r.get(k, 0.0)
        t = r["ms_old_new_new_old"]
        u["spread"] += r["count"] * max(abs(t[0] - t[3]), abs(t[1] - t[2]))
    for name, u in sums.items():
        u["new_share"] = u["bound_ms"] / u["new_ms"]
        u["old_share"] = u["bound_ms"] / u["old_ms"]
        if u["baddbmm_ms"]:
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
    ap.add_argument("--out", default="results/pair28.json")
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
