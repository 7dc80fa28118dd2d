"""Where a bf16 product's time goes: this tree's ``rank1_gemm_bf16`` against
variants of it built from the same source with one edit each, timed in
turns on the card at three shapes (Qwen1.5-0.5B's tied logits, K = 1024;
InternVL2-26B's pod q and k/v projections, 8 clients over one W).

* ``no_epilogue``: the tile's epilogue skipped (y is not written: timing
  only), the ceiling of what the epilogue costs;
* ``direct``: y stored from the accumulators by each thread, not staged
  through shared memory and TMA stores;
* ``stages3``: a 3-stage ring in place of 4.

    python _proof/variants27.py        # from the repository root, ~1 min
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

sys.path[:0] = [".", "src"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

CSRC = Path("src/repro_torch/kernels/csrc")
VARIANTS = {
    "no_epilogue": [("      if (g.S == 1) {\n        float r[2];",
                     "      if (g.K > 0) continue;\n"
                     "      if (g.S == 1) {\n        float r[2];")],
    "direct": [("  const int tma_y = splits == 1 &&",
                "  const int tma_y = 0 && splits == 1 &&")],
    "stages3": [("constexpr int STAGES = 4;                    // slabs",
                 "constexpr int STAGES = 3;                    // slabs")],
}
SHAPES = (("tied logits, K 1024", (8, 264, 1024, 151936, True)),
          ("pod q, 6144 x 6144", (8, 2114, 6144, 6144, False)),
          ("pod k/v, 6144 x 1024", (8, 2114, 6144, 1024, False)))


def build_variants(out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "hopper.cuh", out / "hopper.cuh")
    src = (CSRC / "rank1_matmul.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise AssertionError(f"{name}: {a!r} not in the source")
            text = text.replace(a, b)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in build._SIGNATURES["rank1_matmul"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    print(cs.card_line(), flush=True)
    build.build_all()
    libs = {"this tree": build.load("rank1_matmul"),
            **build_variants(Path("_proof/_variants"))}
    real = libs["this tree"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for label, (C, M, K, N, trans) in SHAPES:
        x = torch.randn(C, M, K, generator=g, device=dev).bfloat16()
        sh = (N, K) if trans else (K, N)
        W = (torch.randn(1, *sh, generator=g, device=dev) * K ** -0.5) \
            .bfloat16().expand(C, *sh)
        u = torch.randn(C, N if trans else K, generator=g, device=dev)
        v = torch.randn(C, K if trans else N, generator=g, device=dev)
        s = torch.full((C,), 1e-3, device=dev)
        fn = ops.rank1_matmul_t if trans else ops.rank1_matmul
        bound = cs.bound(0, 2 * C * M * K * N, cs.PEAK_BF16_FLOPS)[0]
        row = {}
        for name in ("this tree", *VARIANTS, "this tree"):
            build._LIBS["rank1_matmul"] = libs[name]
            row.setdefault(name, []).append(
                cs.time_ms(lambda: fn(x, W, u, v, s), 5, 2))
        build._LIBS["rank1_matmul"] = real
        print(label, {k: [f"{t:.4f} ms ({bound / t:.1%})" for t in ts]
                      for k, ts in row.items()}, flush=True)
        del x, W
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
