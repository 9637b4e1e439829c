#!/usr/bin/env python3
"""The card's rate of min-plus candidates: FP32 add + min against DPX.

    python3 tools/addmin_rate.py

The min-plus kernel (``src/repro_torch/kernels/csrc/minplus_mm.cu``) spends
two instructions per candidate, ``fminf(acc, __fadd_rn(d, w))``.  Hopper's
DPX instruction ``__viaddmin_s32(d, w, acc)`` (``min(d + w, acc)`` on
int32) does the same on integers in one.  This compiles one kernel of each
(``nvcc`` for ``sm_90a`` into the git-ignored ``kernels/_build``), runs each
over the whole card with 32 independent accumulators per thread (the min-plus
kernel's micro-tile keeps 64), and prints candidates per second and their
share of 16.75e12, half the card's 33.5e12 non-FMA FP32 instructions/s (the
min-plus bound: two instructions per candidate).  Each kernel's result is
checked against the same sums done by the other on integral inputs.  The last
line is one JSON object with the card's name and power limit.  It needs CUDA
and exits nonzero without it.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_NONFMA = 33.5e12
ACC = 32            # accumulators per thread
ITERS = 4096        # k-steps per thread
BLOCKS_PER_SM, THREADS = 8, 256
REPS = 9

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

constexpr int ACC = %(acc)d;

// acc[j] = min(acc[j], x[j] + y) over ITERS values of y; x, y integral
// floats, so the float and integer kernels compute the same numbers.
__global__ void __launch_bounds__(256) fp32_addmin(const float* in,
                                                   float* out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float x[ACC], acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    x[j] = in[(t + j) %% 1024];
    acc[j] = __int_as_float(0x7f800000);
  }
  float y = in[t %% 1024];
  for (int it = 0; it < iters; ++it) {
    y = __fadd_rn(y, -1.0f);
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = fminf(acc[j], __fadd_rn(x[j], y));
  }
  float r = acc[0];
#pragma unroll
  for (int j = 1; j < ACC; ++j) r = fminf(r, acc[j]);
  out[t] = r;
}

__global__ void __launch_bounds__(256) dpx_addmin(const float* in,
                                                  float* out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int x[ACC], acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    x[j] = (int)in[(t + j) %% 1024];
    acc[j] = 1 << 29;
  }
  int y = (int)in[t %% 1024];
  for (int it = 0; it < iters; ++it) {
    y -= 1;
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = __viaddmin_s32(x[j], y, acc[j]);
  }
  int r = acc[0];
#pragma unroll
  for (int j = 1; j < ACC; ++j) r = min(r, acc[j]);
  out[t] = (float)r;
}

extern "C" int run(int which, const float* in, float* out, int blocks,
                   int iters, cudaStream_t stream) {
  if (which == 0)
    fp32_addmin<<<blocks, 256, 0, stream>>>(in, out, iters);
  else
    dpx_addmin<<<blocks, 256, 0, stream>>>(in, out, iters);
  return (int)cudaGetLastError();
}
"""


def build(build_dir: str) -> str:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild

    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "addmin_rate.cu")
    lib = os.path.join(build_dir, "addmin_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE % {"acc": ACC})
    flags = [f for f in kbuild.NVCC_FLAGS if f != "-ldl"]
    res = subprocess.run([kbuild._nvcc(), *flags, "-o", lib, src],
                         capture_output=True, text=True)
    print("\n".join(ln.strip() for ln in (res.stdout + res.stderr)
                    .splitlines() if "registers" in ln or "spill" in ln
                    or "error" in ln), flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("addmin_rate: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = ctypes.CDLL(build(os.path.join(ROOT, "src", "repro_torch",
                                         "kernels", "_build")))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = BLOCKS_PER_SM * sms
    g = torch.Generator(device="cuda").manual_seed(0)
    inp = torch.randint(0, 1000, (1024,), generator=g,
                        device="cuda").float()
    outs = [torch.empty(blocks * THREADS, device="cuda") for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    candidates = float(blocks) * THREADS * ITERS * ACC
    row = {"device": smi, "sms": sms, "candidates": candidates}
    for which, name in ((0, "fp32_add_min"), (1, "dpx_viaddmin_s32")):
        def launch():
            err = lib.run(which, inp.data_ptr(), outs[which].data_ptr(),
                          blocks, ITERS, stream)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError_t {err}")
        launch()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            launch()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = statistics.median(times)
        rate = candidates / (ms * 1e-3)
        row[name] = {"ms": ms, "candidates_per_s": rate,
                     "share_of_fp32_bound": rate / (FP32_NONFMA / 2)}
        print(f"  {name}: {ms:.3f} ms, {rate:.4g} candidates/s, "
              f"{rate / (FP32_NONFMA / 2):.3f} of 16.75e12", flush=True)
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("the FP32 and DPX kernels disagree")
    row["dpx_over_fp32"] = (row["dpx_viaddmin_s32"]["candidates_per_s"]
                            / row["fp32_add_min"]["candidates_per_s"])
    print(f"  DPX / FP32: {row['dpx_over_fp32']:.3f}; results equal",
          flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
