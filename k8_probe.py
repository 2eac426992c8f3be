"""Where K8's time goes on the card (naviflow_tpu_torch/csrc/assembly.cu), at
2048^2 with the Gershgorin maxima and with the consistent fold:

* ``kernel``: the kernel as the library builds it;
* ``no_stores``: the same source with every coefficient and d store
  skipped (a guard no value meets): its arithmetic and loads alone (the
  fold's operator pass still runs);
* ``stores_strips`` / ``stores_flat``: a store-only kernel that writes the
  same outputs (and reads u, v, p once) in the kernel's order (warp strips
  of 64 columns, two a lane, 8-byte stores, the v rows leaning onto whole
  lines) and in flat order (one thread an element): the stores alone.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 k8_probe.py

It builds the two sources with the library's nvcc flags into
naviflow_tpu_torch/_build/probe/ and prints one JSON line a measurement
(device ms from CUDA events around launches queued behind a device sleep,
chip_smoke.device_ms) after the card's name and power limit.
"""

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from naviflow_tpu_torch.ops import _cuda, assembly

N = 2048

STORES = r'''
#include "common.cuh"
namespace {
struct Out {
  const float *u, *v, *p;
  float* o[23];  // the 16 coefficient arrays, d_u, d_v, the operator's five
  int nx, ny, fold, ti, tiles_j, tiles;
};
__global__ void __launch_bounds__(128) strips(Out P) {
  const int lane = threadIdx.x & 31, j0w = 64 * (threadIdx.x >> 5);
  for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
    const int row = t / P.tiles_j, i0 = row * P.ti, j0 = (t - row * P.tiles_j) * 256 + j0w;
    const int rows = min(P.ti, P.nx - i0), j = j0 + 2 * lane;
    for (int k = 0; k < rows; ++k) {
      const int i = i0 + k;
      if (j + 1 < P.ny) {
        const int g = i * P.ny + j;
        const float2 x = *reinterpret_cast<const float2*>(P.u + g);
        for (int a = 0; a < 8; ++a) *reinterpret_cast<float2*>(P.o[a] + g) = x;
        if (P.fold) {
          *reinterpret_cast<float2*>(P.o[16] + g) = x;
          for (int a = 18; a < 23; ++a) *reinterpret_cast<float2*>(P.o[a] + g) = x;
        }
      }
      const int c = j - (i & 63);  // the kernel's lean (ny % 64 == 0)
      if (c >= 0 && c + 1 <= P.ny) {
        const int g = i * (P.ny + 1) + c;
        const float2 x = *reinterpret_cast<const float2*>(P.v + g);
        for (int a = 8; a < 16; ++a) *reinterpret_cast<float2*>(P.o[a] + g) = x;
        if (P.fold) *reinterpret_cast<float2*>(P.o[17] + g) = x;
      }
    }
  }
}
__global__ void __launch_bounds__(256) flat(Out P) {
  const int g = blockIdx.x * 256 + threadIdx.x;
  const int nu = (P.nx + 1) * P.ny, nv = P.nx * (P.ny + 1), np = P.nx * P.ny;
  if (g < nu) {
    const float x = P.u[g];
    for (int a = 0; a < 8; ++a) P.o[a][g] = x;
    if (P.fold) P.o[16][g] = x;
  }
  if (g < nv) {
    const float x = P.v[g];
    for (int a = 8; a < 16; ++a) P.o[a][g] = x;
    if (P.fold) P.o[17][g] = x;
  }
  if (P.fold && g < np) {
    const float x = P.p[g];
    for (int a = 18; a < 23; ++a) P.o[a][g] = x;
  }
}
}  // namespace
// ptrs: K8's 27 slots (the maxima pair unused); ip: nx, ny, fold, flat, blocks
NF_EXPORT int nf_k8_stores(const long long* ptrs, const int* ip, const float* fp, void* s) {
  Out P;
  P.u = reinterpret_cast<const float*>(ptrs[0]);
  P.v = reinterpret_cast<const float*>(ptrs[1]);
  P.p = reinterpret_cast<const float*>(ptrs[2]);
  for (int a = 0; a < 16; ++a) P.o[a] = reinterpret_cast<float*>(ptrs[3 + a]);
  for (int a = 16; a < 23; ++a) P.o[a] = reinterpret_cast<float*>(ptrs[4 + a]);
  P.nx = ip[0]; P.ny = ip[1]; P.fold = ip[2];
  P.ti = 16; P.tiles_j = (P.ny / 64 + 4) / 4; P.tiles = P.tiles_j * ((P.nx + 15) / 16);
  if (ip[3]) {
    flat<<<((P.nx + 1) * (P.ny + 1) + 255) / 256, 256, 0, (cudaStream_t)s>>>(P);
  } else {
    strips<<<P.tiles < ip[4] ? P.tiles : ip[4], 128, 0, (cudaStream_t)s>>>(P);
  }
  return (int)cudaGetLastError();
}
NF_EXPORT const char* nf_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
'''

# the kernel's store_pair, returning before any store unless a value is one
# no face has: the arithmetic stays, the stores go
NO_STORES = ("  constexpr int N = FOLD ? 9 : 8;\n",
             "  constexpr int N = FOLD ? 9 : 8;\n"
             "  if (!(f0.a[7] == 1.2345e-30f && f1.a[7] == 1.2345e-30f)) return;\n")


def build():
    out = _cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "assembly.cu").read_text()
    if NO_STORES[0] not in src:
        raise RuntimeError("csrc/assembly.cu's store_pair has changed; update NO_STORES")
    error_string = STORES[STORES.index("NF_EXPORT const char* nf_error_string"):]
    sources = {"no_stores": src.replace(*NO_STORES) + error_string, "stores": STORES}
    libs = {}
    for name, text in sources.items():
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-shared",
                        "-o", str(so), str(cu)], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("nf_fused_assembly_pair", "nf_k8_stores"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = _cuda._ARGS
                getattr(lib, fn).restype = ctypes.c_int
        lib.nf_error_string.argtypes = [ctypes.c_int]
        lib.nf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.emit(dict(phase="device", nvidia_smi=cs.nvidia_smi()))
    main_lib = _cuda.library()
    libs = build()
    u, v, p, kw = cs.cavity_fields(N, dev)
    stream = _cuda.stream_of(u)
    layout, total = assembly.output_layout(N, N, True)
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_longlong * 27)(u.data_ptr(), v.data_ptr(), p.data_ptr(),
                                    *[buf.data_ptr() + 4 * off for off, _ in layout])
    resident = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    for bounds, variant in ((True, None), (False, "consistent")):
        args = dict(alpha=0.7, with_bounds=bounds, poisson_variant=variant, **kw)
        row = dict(phase="k8_probe", n=N, with_bounds=bounds, poisson_variant=variant,
                   work_bound_ms=cs.bound(*cs.assembly_work(N, variant is not None))[0])
        for name, lib in (("kernel", main_lib), ("no_stores", libs["no_stores"])):
            _cuda.library = lambda lib=lib: lib
            row[f"{name}_ms"] = cs.device_ms(
                lambda: assembly.fused_assembly_pair(u, v, p, **args))
        _cuda.library = lambda: main_lib
        for name, is_flat in (("stores_strips", 0), ("stores_flat", 1)):
            ip = (ctypes.c_int * 5)(N, N, int(variant is not None), is_flat, resident)

            def stores(ip=ip):
                _cuda.check(libs["stores"].nf_k8_stores(ptrs, ip, None, stream), "k8 stores")
            row[f"{name}_ms"] = cs.device_ms(stores)
        cs.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
