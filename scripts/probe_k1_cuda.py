"""Where K1's tf32x3 regime and K1b's dx entry spend their time, on the
card (the port, ``values_tpu_torch``; imports no JAX).

    python scripts/probe_k1_cuda.py

Prints the card's name and power limit, then:

1. the dx entry at the training path's largest dx (expand_1_1: B 8,
   64^3, G 1, 8 -> 16 channels), bf16 and f32, by what it does: no
   fold, the leaky fold, with the folded cotangent written, with db
   (bf16: also in ``tile16``); beside K1's forward of the same shape on
   the flipped weight;
2. K1's tf32x3 kernel at the test_3d chunk's expand_1_1 (B 12, 64^3, G 5,
   16 -> 8, no prologue) at each tile, beside edited builds of the
   source under ``build/kernels/probe/`` (nvcc by hand, the library's
   flags): one TF32 product a step instead of three, no product at all
   (the loads and splits kept live), no split pass over the staged tile,
   the tile split as it is read at every tile (not once, as staged; this
   one's sums are right); and the CUDA-core kernel and the bf16 kernels
   at the same shape.

Each line gives one call's time three ways: torch.profiler's device
time (10 calls under the profiler, over 10; K1's kernel alone, with its
count of records, and every kernel of the call, the dx entry's db
zeroing included); CUDA events around 10 calls queued behind a spin
kernel, so that the card runs them back to back (device time, gaps
between kernels included); and the host clock, CUDA events around 10
back-to-back calls, which for a call shorter than the host's work
around it measures the host. The edited builds give wrong sums and only
say what each part costs.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from values_tpu_torch.ops.kernels import build  # noqa: E402
from values_tpu_torch.ops.kernels import conv3d as K  # noqa: E402

# the edits: (name, the source text, its replacement)
_PRODUCTS = """        mma_tf32(part[i][j], as, bb[j][0], bb[j][1], part[i][j]);
        mma_tf32(part[i][j], ab, bs[j][0], bs[j][1], part[i][j]);
        mma_tf32(part[i][j], ab, bb[j][0], bb[j][1], part[i][j]);"""
_SPLIT_PASS = """  if constexpr (presplit<C, T>()) {
    split_units<C>(s_in, C::HVOX << p.lq, tile_bytes);
    __syncthreads();
  }"""
EDITS = [
    ("one_product", _PRODUCTS,
     "        mma_tf32(part[i][j], ab, bb[j][0], bb[j][1], part[i][j]);"),
    ("no_product", _PRODUCTS,
     "        for (int e = 0; e < 4; ++e) part[i][j][e] += __uint_as_float("
     "ab[e] ^ as[e] ^ bb[j][e & 1] ^ bs[j][e & 1]);"),
    ("no_split_pass", _SPLIT_PASS, ""),
    ("split_as_read", "return std::is_same<T, float>::value && C::BM > 64;",
     "return false;"),
]
CALLS = 10


def host_ms(fn, queued: bool = False) -> float:
    """Median of 7 samples of CUDA events around CALLS back-to-back
    calls, over CALLS; ``queued``: the calls enqueued behind a 25 ms spin
    kernel, so that the card does not wait for the host."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(7):
        if queued:
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)  # cycles: 25 ms at 1980 MHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def device_ms(fn):
    """(K1's kernels, their records, every kernel) device ms of one call:
    CALLS calls under torch.profiler, over CALLS."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    k1 = every = 0.0
    records = 0
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        every += e.self_device_time_total
        if "conv3d_" in e.key:
            k1 += e.self_device_time_total
            records += e.count
    return k1 / CALLS / 1e3, records, every / CALLS / 1e3


def report(what: str, fn) -> None:
    k1, records, every = device_ms(fn)
    print(f"{what}: profiler {k1:.4f} ms (K1's kernel, {records} records), "
          f"{every:.4f} ms (every kernel); queued events "
          f"{host_ms(fn, queued=True):.4f} ms; host clock "
          f"{host_ms(fn):.4f} ms", flush=True)


def dx_entry() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.rand((8, 64, 64, 64, 16), generator=gen,
                       device="cuda").to(dtype)
        w = (torch.rand((3, 3, 3, 16, 8), generator=gen, device="cuda")
             / 12).to(dtype)
        y = K.conv3d_fused(x, w, None, 1, activation="leaky")
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
        wt = K.flip_transpose_weight(w, 1)
        runs = {
            "K1 forward, same shape": lambda: K.conv3d_fused(dy, wt, None, 1),
            "entry, no fold": lambda: K.conv3d_fused_dx(dy, w, 1),
            "entry, leaky": lambda: K.conv3d_fused_dx(dy, w, 1, y=y,
                                                      fold="leaky"),
            "entry, leaky + cotangent": lambda: K.conv3d_fused_dx(
                dy, w, 1, y=y, fold="leaky", cotangent=True),
            "entry, leaky + cotangent + db": lambda: K.conv3d_fused_dx(
                dy, w, 1, y=y, fold="leaky", cotangent=True, bias_grad=True),
        }
        launch = K.plan_dx(dtype, 64, 64, 64, 1, 8, 16)
        if dtype == torch.bfloat16:  # the same entry in tile16, by hand
            runs["entry, leaky + cotangent + db, tile16"] = _dx_in(
                K.REGIMES["tile16"], K._TILES["tile16"], 16, dy, y, w)
        for name, fn in runs.items():
            report(f"dx {str(dtype)[6:]} ({launch.regime}) {name}", fn)


def _dx_in(regime, tile, bn, dy, y, w):
    """The dx entry with the leaky fold, the cotangent and db out, in a
    regime and tile of one's choosing."""
    lib = K.load_kernel()
    b, d, h, wd, cin = dy.shape
    cout = w.shape[3]

    def run():
        dx = torch.empty((b, d, h, wd, cout), dtype=dy.dtype, device="cuda")
        g = torch.empty_like(dy)
        db = torch.zeros(cin, device="cuda")
        rc = lib.conv3d_fused_dx_launch(
            1, regime, *tile, bn, dy.data_ptr(), y.data_ptr(), w.data_ptr(),
            None, None, K.FOLDS["leaky"], dx.data_ptr(), g.data_ptr(),
            db.data_ptr(), b, d, h, wd, 1, cin, cout,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    return run


def _edited_libraries() -> dict:
    src = (build.CSRC / "conv3d_fused.cu").read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, old, new in [("as is", "", "")] + EDITS:
        if old and old not in src:
            raise RuntimeError(f"the edit {name!r} no longer applies")
        path = out_dir / f"{name.replace(' ', '_')}.cu"
        path.write_text(src.replace(old, new) if old else src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *flags, "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name.replace(' ', '_')}.so"))
        lib.conv3d_fused_launch.restype = ctypes.c_int
        lib.conv3d_fused_launch.argtypes = K.load_kernel(
        ).conv3d_fused_launch.argtypes
        libs[name] = lib
    return libs


def tf32x3_ablation() -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, g, c = 12, 5, 8
    x = torch.rand((b, 64, 64, 64, g * 2 * c), generator=gen, device="cuda")
    w = torch.rand((3, 3, 3, 2 * c, g * c), generator=gen, device="cuda") / 12
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, dtype, regime, tile):
        xx, ww = (x, w) if dtype == 0 else (x.bfloat16(), w.bfloat16())
        out = torch.empty((b, 64, 64, 64, g * c), device="cuda",
                          dtype=xx.dtype)

        def run():
            rc = lib.conv3d_fused_launch(
                dtype, regime, *tile, 8, xx.data_ptr(), None, ww.data_ptr(),
                None, None, None, None, out.data_ptr(), None, None, b, 64,
                64, 64, g, 2 * c, 0, c, 0, stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
        return run

    tiles = (K._TILES["tile16"], K._TILES["tile8"], K._TILES["tile4"])
    libs = _edited_libraries()
    for name, lib in libs.items():
        for tile in tiles:
            report(f"tf32x3 {name} tile {tile}",
                   launch(lib, 0, K.REGIMES["tf32x3"], tile))
    lib = libs["as is"]
    report("f32 CUDA-core kernel", launch(lib, 0, K.REGIMES["f32"],
                                          (4, 8, 8)))
    for tile in tiles:
        report(f"bf16 tile {tile}", launch(lib, 1, K.REGIMES["tile8"], tile))
    report("bf16 shallow", launch(lib, 1, K.REGIMES["shallow"], (4, 8, 16)))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dx_entry()
    tf32x3_ablation()
    return 0


if __name__ == "__main__":
    sys.exit(main())
