"""Variants of the tensor-core update kernel, timed in one process on one
card: where a tile's time goes.

Each variant is ``csrc/subcge_apply.cu`` with one part cut out by a text
edit, built by its own ``nvcc`` into ``_proof/_build_variants`` and called
through its C entry with this tree's plan (``subcge_apply.stream_plan``):

* ``base``: the kernel as it is;
* ``no_mma``: no products (the delta is garbage): the stream, U loads and
  the epilogue alone;
* ``no_u``: U not loaded (zeros): the products and the stream;
* ``no_epi``: the stage stored back unchanged (no read-modify-write of W
  in shared memory): loads, products and TMA stores;
* ``no_build``: A V^T never formed (garbage);
* ``prof``: the kernel with clock64 spans (the consumers' A V^T builds,
  waits for the products and for W, their epilogue and product issue; the
  producer's waits for the consumers and for its stores), per warp
  group.

Times (CUDA events, median of 5) at main-path leaves beside ``copy_`` of
the same W and the byte bound; ``ptxas`` registers and spills of each.

    python _proof/variants28.py --out results/variants28.json
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path[:0] = [".", "src"]
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import subcge_apply as sa  # noqa: E402

HERE = Path(__file__).resolve().parent
SRC = Path("src/repro_torch/kernels/csrc/subcge_apply.cu")

CUTS = {
    "no_mma": [("      wgmma_tf32_m64n64k8(cor, lo, dh, 1);\n"
                "      wgmma_tf32_m64n64k8(cor, hi, dl, 1);\n"
                "      wgmma_tf32_m64n64k8(acc, hi, dh, 1);\n", ""),
               ("          wgmma_tf32_m64n64k8(acc, lo[s4], dh, 1);\n"
                "          wgmma_tf32_m64n64k8(acc, hi[s4], dl, 1);\n"
                "          wgmma_tf32_m64n64k8(acc, hi[s4], dh, 1);\n", "")],
    "no_u": [("? __ldg(U + ((long long)e * g.n + rr) * g.r + pp)", "? 0.f")],
    "no_epi": [("          if constexpr (S::ESZ == 2) {\n"
                "            const uint32_t w =", "          if (false) {\n"
                "            const uint32_t w ="),
               ("          } else {\n"
                "            const float2 w = *reinterpret_cast<const float2*>(at);",
                "          } else if (false) {\n"
                "            const float2 w = *reinterpret_cast<const float2*>(at);")],
    "no_build": [("    for (int j = 0; j < c.ns; ++j) {\n      unsigned char *hi",
                  "    for (int j = 0; j < 0; ++j) {\n      unsigned char *hi")],
}

# "prof": clock64 spans summed over threads 0 and 128 (the consumer warp
# groups' first) and 256 (the producer) into a device array read back
PROF_SLOTS = ["build", "finish_wait", "full_wait", "epilogue", "issue",
              "consumer_total", "empty_wait", "store_read_wait",
              "producer_total"]
CONSUMER_SLOTS = 6
CUTS["prof"] = [
    ("namespace tc {\n\nusing namespace hopper;\n",
     "namespace tc {\n\nusing namespace hopper;\n"
     "__device__ unsigned long long tc_prof[9];\n"
     "#define PROF(i, v) if (threadIdx.x % 128 == 0) "
     "atomicAdd(&tc_prof[i], (unsigned long long)(v))\n"),
    ("      if (need_av) build(nxt, 0, false, 8 * NS);",
     "      { long long c_ = clock64(); if (need_av) build(nxt, 0, false, 8 * NS);"
     " PROF(0, clock64() - c_); }"),
    ("      if (i + 1 < count) wgmma_wait<1>();   // tile i's products are done\n"
     "      else wgmma_wait<0>();\n",
     "      { long long c_ = clock64();\n"
     "      if (i + 1 < count) wgmma_wait<1>();\n"
     "      else wgmma_wait<0>();\n PROF(1, clock64() - c_); }\n"),
    ("    mbar_wait(&full[s], (i / S::STAGES) & 1);\n    unsigned char* st = ring",
     "    { long long c_ = clock64(); mbar_wait(&full[s], (i / S::STAGES) & 1);"
     " PROF(2, clock64() - c_); }\n    unsigned char* st = ring"),
    ("      epilogue(acc, cur, i);\n      cur.next(g);\n    };",
     "      { long long c_ = clock64(); epilogue(acc, cur, i);"
     " PROF(3, clock64() - c_); }\n      cur.next(g);\n    };"),
    ("      if (i + 1 < count) issue(acc1, i + 1);",
     "      { long long c_ = clock64(); if (i + 1 < count) issue(acc1, i + 1);"
     " PROF(4, clock64() - c_); }"),
    ("      if (i + 2 < count) issue(acc0, i + 2);",
     "      { long long c_ = clock64(); if (i + 2 < count) issue(acc0, i + 2);"
     " PROF(4, clock64() - c_); }"),
    ("  regs_inc<CONSUMER_REGS>();\n",
     "  regs_inc<CONSUMER_REGS>();\n  const long long c_start = clock64();\n"),
    ("\n}\n\ntemplate <typename T>\nint launch(",
     "\n  PROF(5, clock64() - c_start);\n}\n\ntemplate <typename T>\nint launch("),
    ("        mbar_wait(&empty[s], (js / S::STAGES) & 1);",
     "        { long long c_ = clock64(); mbar_wait(&empty[s], (js / S::STAGES) & 1);"
     " PROF(6, clock64() - c_); }"),
    ("        bulk_wait_read<1>();\n",
     "        { long long c_ = clock64(); bulk_wait_read<1>();"
     " PROF(7, clock64() - c_); }\n"),
    ("    const uint64_t policy = l2_evict_first();\n    if (!FLAT) {\n      prefetch_map(&wmap);",
     "    const long long p_start = clock64();\n"
     "    const uint64_t policy = l2_evict_first();\n    if (!FLAT) {\n      prefetch_map(&wmap);"),
    ("    if (!FLAT) bulk_wait_all();   // the last stores have landed\n    return;",
     "    if (!FLAT) bulk_wait_all();   // the last stores have landed\n"
     "    PROF(8, clock64() - p_start);\n    return;"),
]
PROF_TAIL = """
extern "C" int tc_prof_io(unsigned long long* host, int zero) {
  if (zero) {
    unsigned long long z[9] = {0};
    return (int)cudaMemcpyToSymbol(tc::tc_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, tc::tc_prof, 9 * sizeof(unsigned long long));
}
"""

LEAVES = [("bf16", 1, 16, (24, 1024, 2816)), ("bf16", 1, 16, (48, 6144, 6144)),
          ("bf16", 2, 16, (24, 1024, 2816)), ("bf16", 1, 16, (1, 6144, 92553)),
          ("f32", 1, 64, (24, 1024, 2816)), ("bf16", 1, 64, (24, 1024, 2816)),
          ("bf16", 2, 64, (24, 1024, 2816))]


def build_variant(name: str):
    text = SRC.read_text()
    for old, new in CUTS.get(name, []):
        if old not in text:
            raise SystemExit(f"variant {name}: edit not found: {old[:60]!r}")
        text = text.replace(old, new)
    out = HERE / "_build_variants"
    out.mkdir(exist_ok=True)
    cu = out / f"{name}.cu"
    if name == "prof":
        text += PROF_TAIL
    cu.write_text(text.replace('#include "hopper.cuh"',
                               f'#include "{SRC.parent.resolve()}/hopper.cuh"'))
    so = out / f"{name}.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    regs = re.findall(r"update_tc_kernel.*?Used (\d+) registers", r.stdout +
                      r.stderr, re.S)
    spills = re.findall(r"(\d+) bytes spill stores", r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    for fn in ("subcge_update_tc_f32", "subcge_update_tc_bf16"):
        getattr(lib, fn).argtypes = build._SIGNATURES["subcge_apply"][fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, {"registers": regs, "spill_stores": spills}


def launch(lib, W, U, A, V):
    E, n, r = U.shape
    nb, m = W.shape[0], W.shape[2]
    plan = sa.stream_plan(nb, n, m, r, E, W.element_size())
    fn = lib.subcge_update_tc_bf16 if W.dtype == torch.bfloat16 \
        else lib.subcge_update_tc_f32
    err = fn(W.data_ptr(), W.data_ptr(), U.data_ptr(), A.data_ptr(),
             V.data_ptr(), E, nb, n, m, r, plan.rp, plan.k, plan.kgroup,
             plan.chunks, plan.tiles, plan.sub, plan.per, plan.blocks,
             plan.smem_bytes,
             W.stride(0), W.stride(0), build.stream_of(W))
    if err:
        raise RuntimeError(f"CUDA error {err}")


def time_ms(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/variants28.json")
    ap.add_argument("--variants", default="base,no_mma,no_u,no_epi,no_build")
    args = ap.parse_args()
    names = args.variants.split(",")
    libs = {n: build_variant(n) for n in names}
    for n in names:
        print(n, libs[n][1], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dt, E, r, (nb, n, m) in LEAVES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        W = (torch.randn((nb, n, m), generator=g, device="cuda") * 0.05
             ).to(dtype)
        U = torch.randn((E, n, r), generator=g, device="cuda")
        V = torch.randn((E, m, r), generator=g, device="cuda")
        A = torch.randn((E, nb, r, r), generator=g, device="cuda") * 1e-2
        out = torch.empty_like(W)
        c_ms = time_ms(lambda: out.copy_(W))
        bound = 2 * W.numel() * W.element_size() / 3.35e9
        row = {"dtype": dt, "E": E, "r": r, "W": [nb, n, m], "copy_ms": c_ms,
               "bound_ms": bound}
        for name in names:
            row[name] = time_ms(lambda: launch(libs[name][0], W, U, A, V))
            if name == "prof":
                lib = libs[name][0]
                buf = (ctypes.c_ulonglong * 9)()
                lib.tc_prof_io(buf, 1)
                launch(lib, W, U, A, V)
                torch.cuda.synchronize()
                lib.tc_prof_io(buf, 0)
                blocks = sa.stream_plan(nb, n, m, r, E,
                                        W.element_size()).blocks
                # per consumer warp group (two a block), per producer
                row["prof_cycles"] = {
                    k: buf[i] / ((2 if i < CONSUMER_SLOTS else 1) * blocks)
                    for i, k in enumerate(PROF_SLOTS)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del W, U, V, A, out
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"ptxas": {n: libs[n][1] for n in names}, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
