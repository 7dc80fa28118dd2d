"""The scan backward's time at (32, 33, 8192, 16) on the card, measured
three ways, in a fresh process and again after ``chip_smoke.py``'s Qwen
and Kimi kernel phases: the host time of one wrapper call (and of its
allocations and its C call alone), ``chip_smoke.time_ms`` (CUDA events
around each call, so the host's time to enqueue is counted when the card
waits for it), and 20 back-to-back calls between two events (the card's
time alone); the older kernel of ``_proof/pair21.py`` beside it, and the
SM clock, power and temperature from ``nvidia-smi``.  Needs the older
kernel's source placed as ``_proof/pair21.py`` says.

    python _proof/ctx21.py
"""
import subprocess
import sys

sys.path[:0] = [".", "src", "_proof"]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pair21  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402


def clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def back_to_back(fn, n=20):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def measure(lib, tag):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, T, D, N = 32, 33, 8192, 16
    a = torch.sigmoid(torch.randn((B, T, D, N), generator=g, device=dev))
    bx = 0.1 * torch.randn((B, T, D, N), generator=g, device=dev)
    c = torch.randn((B, T, N), generator=g, device=dev)
    h0 = torch.randn((B, D, N), generator=g, device=dev)
    dy = torch.randn((B, T, D), generator=g, device=dev)
    dh = torch.randn((B, D, N), generator=g, device=dev)
    args = (a, bx, c, h0, dy, dh)
    new = lambda: ss.selective_scan_bwd(*args)  # noqa: E731
    import time
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    lib_new = build.load("selective_scan_bwd")
    plan = ss.scan_bwd_plan(B, T, D, N)
    outs = [torch.empty_like(a), torch.empty_like(a),
            torch.empty((B, T, N), device=dev), torch.empty_like(h0),
            torch.empty(plan.part_shape, dtype=torch.float64, device=dev)]
    host = {}
    for name, fn in (
            ("wrapper", new),
            ("empties", lambda: [torch.empty_like(a), torch.empty_like(a),
                                 torch.empty((B, T, N), device=dev),
                                 torch.empty_like(h0),
                                 torch.empty(plan.part_shape,
                                             dtype=torch.float64,
                                             device=dev)]),
            ("c_call", lambda: lib_new.selective_scan_bwd_f32(
                a.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
                dy.data_ptr(), dh.data_ptr(), *(o.data_ptr() for o in outs),
                None, B, T, D, N, plan.cols, plan.chunk, plan.per,
                plan.partials, plan.smem_bytes, 1,
                torch.cuda.current_stream().cuda_stream))):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        host[name] = sorted(ts)[2]
    torch.cuda.synchronize()
    print(tag, "host us (median of 5):", host, flush=True)
    old = lambda: pair21.parent_bwd(lib, *args)  # noqa: E731
    for rnd in range(2):
        print(tag, rnd, "clock", clocks(),
              "per-call new %.4f old %.4f" % (cs.time_ms(new), cs.time_ms(old)),
              "back-to-back new %.4f old %.4f" % (back_to_back(new),
                                                  back_to_back(old)),
              flush=True)
    del a, bx, c, h0, dy, dh, args
    torch.cuda.empty_cache()


def main():
    print("card:", cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = pair21.build_parent()
    measure(lib, "alone")
    cs.phase_kernels_dense(archs.get("qwen1.5-0.5b"), 8, 8 * 33, 0, "qwen",
                           (2, 4))
    torch.cuda.empty_cache()
    cs.phase_kernels_kimi(archs.kimi_cut(), 8, 8 * 33)
    torch.cuda.empty_cache()
    measure(lib, "after qwen+kimi")


if __name__ == "__main__":
    main()
