"""Pair run of the scan's backward: an older commit's kernel against this
tree's, in one process on one card, and phase 9's Mamba first-order arms
in both trees.

Before the chip call, put the older commit's files beside this script
(``REF`` is that commit, e.g. the parent of the change)::

    git show REF:src/repro_torch/kernels/csrc/selective_scan_bwd.cu \
        > _proof/parent_selective_scan_bwd.cu
    mkdir -p _proof/parent && git archive REF | tar -x -C _proof/parent

``--kernels`` builds the older kernel with its own C signature (one
partial per 256-thread block, ``selective_scan_bwd_blocks``) into
``_proof/_build_parent`` and, at every phase-2 shape, checks da, dbx and
dh0 bitwise between the two kernels and across two calls of the new one,
prints each kernel's distance to the float64 plain reverse scan, and times
them in turns (old, new, new, old) with CUDA events.  ``--steps`` runs
``chip_smoke.phase_mamba_fo`` (dsgd and choco through the Falcon Mamba
cut) in the older tree and this one, in turns (old, new, new, old), each
in its own process.  Results go to ``--out`` as JSON.

    python _proof/pair21.py --kernels --steps --out results/pair21.json
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402

HERE = Path(__file__).resolve().parent
CH = ss.BWD_CHUNK
SHAPES = [(32, 33, 8192, 16), (24, 33, 8192, 16), (4, 3 * CH + 5, 8192, 16),
          (3, 37, 200, 16), (2, 7, 8, 4), (2, 9, 40, 1), (1, 5, 24, 32),
          (2, 11, 37, 2), (3, 1, 200, 16), (2, CH, 72, 16),
          (2, CH + 1, 72, 16), (2, 3 * CH + 5, 72, 16), (4, 33, 1024, 16)]


def build_parent():
    out = HERE / "_build_parent"
    out.mkdir(exist_ok=True)
    so = out / "parent_bwd.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
           str(HERE / "parent_selective_scan_bwd.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    print("parent ptxas:", r.stdout[-1500:], r.stderr[-1500:], flush=True)
    r.check_returncode()
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_bwd_f32.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.selective_scan_bwd_f32.restype = I
    lib.selective_scan_bwd_blocks.argtypes = [I, I]
    lib.selective_scan_bwd_blocks.restype = I
    return lib


def parent_bwd(lib, a, bx, c, h0, dy, dh):
    B, T, D, N = a.shape
    nblk = lib.selective_scan_bwd_blocks(D, N)
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    dc = torch.empty((B, T, N), device=a.device)
    dh0 = torch.empty_like(h0)
    part = torch.empty((B, T, nblk, N), dtype=torch.float64, device=a.device)
    err = lib.selective_scan_bwd_f32(
        a.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
        dy.data_ptr(), dh.data_ptr(), da.data_ptr(), dbx.data_ptr(),
        dc.data_ptr(), dh0.data_ptr(), part.data_ptr(), B, T, D, N,
        build.stream_of(a))
    build.check(err, "parent selective_scan_bwd")
    return da, dbx, dc, dh0


def kernels(reps, quick):
    lib = build_parent()
    build.build_all()
    for rep in cs.ptxas_report("selective_scan_bwd"):
        print("ptxas new:", rep, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    rows = []
    for shape in (SHAPES[:3] if quick else SHAPES):
        B, T, D, N = shape
        a = torch.sigmoid(randn(B, T, D, N))
        bx, c, h0 = randn(B, T, D, N, scale=0.1), randn(B, T, N), \
            randn(B, D, N)
        dy, dh = randn(B, T, D), randn(B, D, N)
        args = (a, bx, c, h0, dy, dh)
        new = ss.selective_scan_bwd(*args)
        again = ss.selective_scan_bwd(*args)
        old = parent_bwd(lib, *args)
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
                for n, x, y in zip(("da", "dbx", "dc", "dh0"), new, old)}
        repeat = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                     for x, y in zip(new, again))
        oracle = ss.selective_scan_bwd_plain(*(x.double() for x in args))
        d_new = [float((x.double() - o).abs().max()) for x, o in
                 zip(new, oracle)]
        d_old = [float((x.double() - o).abs().max()) for x, o in
                 zip(old, oracle)]
        del oracle, new, again, old
        torch.cuda.empty_cache()
        t = []
        for which in ("old", "new", "new", "old"):
            fn = (lambda: parent_bwd(lib, *args)) if which == "old" else \
                (lambda: ss.selective_scan_bwd(*args))
            t.append(cs.time_ms(fn, reps, 3))
        plan = ss.scan_bwd_plan(*shape)
        BTDN = B * T * D * N
        fn_bytes = 4 * (4 * BTDN + 2 * B * T * N + 3 * B * D * N + B * T * D)
        moved = cs.scan_bwd_design_bytes(plan, *shape)
        old_moved = 4 * (7 * BTDN + B * T * D + 2 * B * T * N
                         + 3 * B * D * N) + 2 * 8 * B * T * N * \
            lib.selective_scan_bwd_blocks(D, N)
        bound = cs.bound(fn_bytes, 8 * BTDN)[0]
        row = {"shape": shape, "bitwise_vs_parent": same,
               "bitwise_repeat": repeat,
               "max_abs_to_f64_new": dict(zip(("da", "dbx", "dc", "dh0"),
                                              d_new)),
               "max_abs_to_f64_old": dict(zip(("da", "dbx", "dc", "dh0"),
                                              d_old)),
               "ms_old_new_new_old": t, "old_ms": (t[0] + t[3]) / 2,
               "new_ms": (t[1] + t[2]) / 2, "bound_ms": bound,
               "new_share": bound / ((t[1] + t[2]) / 2),
               "old_share": bound / ((t[0] + t[3]) / 2),
               "moved_new": moved, "moved_old": old_moved,
               "tbs_new": moved / ((t[1] + t[2]) / 2) / 1e9,
               "tbs_old": old_moved / ((t[0] + t[3]) / 2) / 1e9,
               "part_bytes_new": 8 * B * T * plan.partials * N,
               "part_bytes_old": 8 * B * T * N *
               lib.selective_scan_bwd_blocks(D, N),
               "plan": str(plan)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del a, bx, c, h0, dy, dh, args
        torch.cuda.empty_cache()
    return rows


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
tot, out = cs.phase_mamba_fo(archs.falcon_cut(), 8, cs.card_line())
print('JSON' + json.dumps({m: {k: out[m][k] for k in ('step_ms',
      'steady_step_s', 'total_bytes', 'losses', 'launches', 'peak_gib')}
      for m in out}))
"""


def steps():
    res = []
    for tag, tree in (("parent", HERE / "parent"), ("child", Path(".")),
                      ("child", Path(".")), ("parent", HERE / "parent")):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", STEP_CODE], cwd=tree,
                           capture_output=True, text=True, timeout=900)
        print(tag, "rc", r.returncode, f"{time.perf_counter() - t0:.1f} s",
              r.stdout[-2500:], r.stderr[-2500:], flush=True)
        r.check_returncode()
        line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][-1]
        res.append({"tree": tag, **json.loads(line[4:])})
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="results/pair21.json")
    args = ap.parse_args()
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    out = {"card": card}
    if args.kernels:
        out["kernels"] = kernels(args.reps, args.quick)
    if args.steps:
        out["steps"] = steps()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print("OK")


if __name__ == "__main__":
    main()
