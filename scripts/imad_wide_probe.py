"""How many IMAD-pipe issue slots an IMAD.WIDE.U32 takes on one card: three
loops of independent multiply-add chains, timed with CUDA events.

    python3 scripts/imad_wide_probe.py [--out chiprun_out/imad_wide_probe.json]

The loops (built here with nvcc for sm_90a, a plain C interface loaded
with ctypes):

  * `imad`: 8 chains of x <- x * a + b in 32 bits (IMAD);
  * `wide`: 8 chains of x <- lo(x) * a + x in 64 bits (IMAD.WIDE.U32);
  * `mix`: 4 chains of each.

Each thread runs its chains independently, 2,048 threads an SM on every
SM, so the loops are bound by throughput, not by latency.  The SASS of
each loop body (chip_smoke.py's `sass_functions` and `main_loop`;
cuobjdump is required) gives the instructions a trip, ptxas's carries
included, and with them each loop's issue bound (chip_smoke.py's
`issue_bound`, pipe by pipe) twice: with an IMAD.WIDE as two slots of
the IMAD pipe (`twice`, the bound model's count) and as one (`once`).
The measured time says which count the card keeps.  Prints one JSON
line with each loop's least ms over REPS launches, its SASS (`as_built`:
whole trips, one IMAD or IMAD.WIDE a step, of the expected kind), both
bounds, lane-steps a clock an SM at the model's 1.98 GHz, the SM clock
and power draw that nvidia-smi read under the loop's load, and the
card's name and power limit; the same goes to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "imad_wide_probe")
KINDS = ("imad", "wide", "mix")
CHAINS, UNROLL, THREADS, BLOCKS_AN_SM, TRIPS, REPS = 8, 4, 256, 8, 4000, 100

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kChains = %(chains)d, kUnroll = %(unroll)d;

__device__ __forceinline__ void step32(uint32_t& x, uint32_t a, uint32_t b) {
  asm volatile("mad.lo.u32 %%0, %%0, %%1, %%2;" : "+r"(x) : "r"(a), "r"(b));
}

__device__ __forceinline__ void step64(uint64_t& x, uint32_t a) {
  asm volatile("{\n.reg .u32 lo, hi;\nmov.b64 {lo, hi}, %%0;\n"
               "mad.wide.u32 %%0, lo, %%1, %%0;\n}" : "+l"(x) : "r"(a));
}

// WIDE chains of the 64-bit step, the rest of the 32-bit one
template <int WIDE>
__device__ __forceinline__ void chains(uint32_t* out, uint32_t a, uint32_t b, int trips) {
  uint32_t x[kChains];
  uint64_t y[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) x[j] = y[j] = threadIdx.x + j;
  for (int t = 0; t < trips; ++t) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        if (j < WIDE) step64(y[j], a);
        else step32(x[j], a, b);
      }
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    s ^= j < WIDE ? uint32_t(y[j] ^ (y[j] >> 32)) : x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" __global__ void imad_loop(uint32_t* o, uint32_t a, uint32_t b,
                                     int t) { chains<0>(o, a, b, t); }
extern "C" __global__ void wide_loop(uint32_t* o, uint32_t a, uint32_t b,
                                     int t) { chains<kChains>(o, a, b, t); }
extern "C" __global__ void mix_loop(uint32_t* o, uint32_t a, uint32_t b,
                                    int t) { chains<kChains / 2>(o, a, b, t); }

// the least ms of `reps` launches of loop `kind` (0 imad, 1 wide, 2 mix)
extern "C" int probe_ms(int kind, int blocks, int threads, int trips,
                        int reps, float* ms) {
  void (*k)(uint32_t*, uint32_t, uint32_t, int) =
      kind == 0 ? imad_loop : kind == 1 ? wide_loop : mix_loop;
  uint32_t* out;
  if (cudaMalloc(&out, sizeof(uint32_t) * blocks * threads)) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  k<<<blocks, threads>>>(out, 0x9E3779B9u, 0x7F4A7C15u, trips);
  *ms = 1e30f;
  for (int r = 0; r < reps; ++r) {
    cudaEventRecord(e0);
    k<<<blocks, threads>>>(out, 0x9E3779B9u, 0x7F4A7C15u, trips);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float t;
    cudaEventElapsedTime(&t, e0, e1);
    if (t < *ms) *ms = t;
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return cudaGetLastError();
}
""" % {"chains": CHAINS, "unroll": UNROLL}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build() -> str:
    """Compile SOURCE into BUILD/probe.so; returns its path."""
    os.makedirs(BUILD, exist_ok=True)
    src, lib = os.path.join(BUILD, "probe.cu"), os.path.join(BUILD,
                                                             "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    return lib


def loaded_clock(run) -> dict:
    """The SM clock (MHz) and power draw (W) that nvidia-smi reads every
    50 ms while `run` runs: the sample of the highest draw."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        run()
    finally:
        smi.terminate()
        text, _ = smi.communicate()
    samples = []
    for line in text.splitlines():
        try:
            samples.append(tuple(float(v) for v in line.split(",")))
        except ValueError:
            continue
    mhz, watts = max(samples, key=lambda v: v[1], default=(None, None))
    return {"sm_mhz": mhz, "watts": watts}


def wide_as_imad(ops: dict) -> dict:
    """ops with every IMAD.WIDE counted as a plain IMAD (one slot)."""
    out = {}
    for o, c in ops.items():
        key = "IMAD" if o.startswith("IMAD.WIDE") else o
        out[key] = out.get(key, 0) + c
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "imad_wide_probe.json"))
    args = ap.parse_args(argv)
    cs = _chip_smoke()
    lib_path = build()
    lib = ctypes.CDLL(lib_path)
    lib.probe_ms.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(
        ctypes.c_float)]
    funcs = cs.sass_functions(lib_path)
    blocks = 132 * BLOCKS_AN_SM
    lanes_an_sm = BLOCKS_AN_SM * THREADS
    out = {}
    for i, kind in enumerate(KINDS):
        ms = ctypes.c_float()
        rc = []
        smi = loaded_clock(lambda: rc.append(lib.probe_ms(
            i, blocks, THREADS, TRIPS, REPS, ctypes.byref(ms))))
        cs.require(rc == [0], ("launch", kind, rc))
        body = {}
        for op in cs.main_loop(funcs[f"{kind}_loop"]):
            body[op] = body.get(op, 0) + 1
        # ptxas may unroll the loop over trips: its body is then whole
        # trips of CHAINS * UNROLL steps, one instruction each
        imad = sum(c for o, c in body.items() if o.split(".")[0] == "IMAD")
        wide = sum(c for o, c in body.items() if o.startswith("IMAD.WIDE"))
        steps = CHAINS * UNROLL
        share = (0, 1, 0.5)[i]
        clocks = ms.value * 1e-3 * cs.SM_CLOCKS_PER_S / 132
        # the loop's instructions over the launch, one thread an element
        ops = {o: c * TRIPS * steps / imad for o, c in body.items()}
        n = 132 * lanes_an_sm
        out[kind] = {"ms": ms.value, "loop": body,
                     "trips_a_loop": imad / steps,
                     "as_built": imad % steps == 0 and wide == imad * share,
                     "issue_bound_ms": {
                         "once": cs.issue_bound(wide_as_imad(ops), n, 0)[
                             "issue_bound_ms"],
                         "twice": cs.issue_bound(ops, n, 0)[
                             "issue_bound_ms"]},
                     "lanes_a_clock_an_sm":
                     lanes_an_sm * TRIPS * steps / clocks, **smi}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    line = {**out, "wide_over_imad": out["wide"]["ms"] / out["imad"]["ms"],
            "mix_over_imad": out["mix"]["ms"] / out["imad"]["ms"],
            "threads_an_sm": lanes_an_sm, "trips": TRIPS,
            "nvidia_smi": smi}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
