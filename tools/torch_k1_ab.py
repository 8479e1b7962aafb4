#!/usr/bin/env python3
"""Time two builds of the port's K1 (starlet forward and adjoint) on one
CUDA card, in turns, and the floor of the cluster design.

    python3 tools/torch_k1_ab.py --old PATH/starlet.cu

``--old`` is the ``csrc/starlet.cu`` of an earlier commit of
``lightcurver_tpu_torch``: one whose kernels took one block per image
(``starlet_forward(x, out, batch, m, n_scales, stream)``, as at 67ce9a8),
or a variant of the cluster kernels with the checkout's interface (which
also takes C; it then runs at the C the checkout runs at). Unpack it from
git first, e.g. ``git archive 67ce9a8 lightcurver_tpu_torch/csrc/starlet.cu
| tar -x -C build/parent``. The new kernels are the checkout's, launched
with the cluster size C that ``ops/starlet_cuda.py`` picks.

At (m, batch) in {64, 128} x {1, 500}, forward and adjoint, both kernels
are held to the plain twin first (max|diff| <= 1e-5 max|input|), then
timed in the order old, new, new, old, each two ways, ``--reps`` launches
after a warm-up:
- ``ms``: a loop of launches between two CUDA events;
- ``graph_ms``: the same launches captured in one CUDA graph and replayed
  between two CUDA events: the device time a launch, without the host's
  cost of issuing it (which a loop of short kernels may wait on).
Both kernels are called through ctypes on preallocated outputs, so
neither pays the wrapper's Python. Then the new kernels at every C
(``--clusters``) that fits, and the skeleton: an empty cluster launch of
the same geometry and shared memory with one ``cluster.sync()`` a level
and one before exit (the floor of this design). Prints the card line, one
line per case and one JSON line.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, graph_ms  # noqa: E402
from lightcurver_tpu_torch.core import starlet as plain  # noqa: E402
from lightcurver_tpu_torch.ops import (cuda_build, enforce_fp32,  # noqa: E402
                                       starlet_cuda)

TOL = 1e-5

# The skeleton: csrc/starlet.cu's launch geometry (one thread a column, as
# many rows as fit 1024 threads, at most R; 3 R m floats and 3 m ints of
# shared memory) and its barriers, nothing else.
SKELETON = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024) k1_skeleton_kernel(int n_scales) {
  extern __shared__ float smem[];
  const cg::cluster_group cl = cg::this_cluster();
  for (int j = 0; j < n_scales; ++j) {
    cl.sync();
    __syncthreads();
  }
  cl.sync();
}

extern "C" int k1_skeleton(int batch, int m, int n_scales, int cluster,
                           void* stream) {
  static bool configured = false;
  if (!configured) {
    int device = 0, optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    cudaFuncSetAttribute(k1_skeleton_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    cudaFuncSetAttribute(k1_skeleton_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    configured = true;
  }
  const int R = (m + cluster - 1) / cluster;
  const int bx = (m + 31) / 32 * 32;
  const int by = R < 1024 / bx ? R : 1024 / bx;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(bx, by);
  cfg.dynamicSmemBytes = 4 * (3 * R * m + 3 * m);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k1_skeleton_kernel, n_scales);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
"""


def load(source, n_ints):
    """ctypes library of a starlet source whose two entry points take two
    pointers, ``n_ints`` ints and the stream."""
    lib = ctypes.CDLL(str(cuda_build.build(source)))
    for name in ("starlet_forward", "starlet_adjoint"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def load_skeleton():
    out = ROOT / "build" / "k1_ab"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "k1_skeleton.cu"
    cu.write_text(SKELETON)
    lib = ctypes.CDLL(str(cuda_build.build(cu)))
    lib.k1_skeleton.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.k1_skeleton.restype = ctypes.c_int
    return lib


def checked(fn, *args):
    """A launcher of ``fn(*args, stream)`` on the current stream."""
    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
    return run


def both(fn, reps):
    return {"ms": cuda_ms(fn, reps), "graph_ms": graph_ms(fn, reps)}


def show(timings):
    """'a / b ms (graph c / d ms)' for a list of :func:`both` results."""
    def join(key):
        return " / ".join(f"{t[key]:.4f}" for t in timings)
    return f"{join('ms')} ms (graph {join('graph_ms')} ms)"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", required=True, type=Path)
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--clusters", type=int, nargs="+",
                        default=list(starlet_cuda.CLUSTER_SIZES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    enforce_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    new = load(starlet_cuda.SOURCE, 4)
    old = load(args.old, 3)
    old_takes_c = hasattr(old, "starlet_cta_bytes")
    if old_takes_c:
        old = load(args.old, 4)
    skeleton = load_skeleton()
    optin = new.starlet_smem_optin(torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    results = []
    for m in (64, 128):
        J = plain.n_starlet_scales(m)
        for batch in (1, 500):
            reps = args.reps if batch == 1 else max(args.reps // 10, 10)
            chosen = starlet_cuda.cluster_for(dev, m, batch)
            x = torch.randn(batch, m, m, generator=gen).cuda()
            g = torch.randn(batch, J + 1, m, m, generator=gen).cuda()
            cases = (("forward", x, torch.empty_like(g),
                      plain.starlet_transform(x)),
                     ("adjoint", g, torch.empty_like(x),
                      plain.starlet_adjoint(g)))
            for name, inp, out, want in cases:
                ptrs = (inp.data_ptr(), out.data_ptr(), batch, m, J)

                def run_new(c):
                    return checked(getattr(new, f"starlet_{name}"), *ptrs, c)

                runs = {"old": checked(getattr(old, f"starlet_{name}"),
                                       *ptrs,
                                       *((chosen,) if old_takes_c else ())),
                        "new": run_new(chosen)}
                bar = TOL * inp.abs().max().item()
                errs = {}
                for label, fn in runs.items():
                    out.zero_()
                    fn()
                    torch.cuda.synchronize()
                    errs[label] = (out - want).abs().max().item()
                    if errs[label] > bar:
                        print(f"FAIL: {label} {name} m={m} B={batch}: "
                              f"max|diff| {errs[label]:.3e} > {bar:.3e}",
                              flush=True)
                        return 1
                times = {"old": [], "new": []}
                for label in ("old", "new", "new", "old"):
                    times[label].append(both(runs[label], reps))
                sweep = {}
                for c in args.clusters:
                    if starlet_cuda.cta_bytes(m, c) > optin:
                        continue
                    sweep[c] = {"kernel": both(run_new(c), reps),
                                "skeleton": both(checked(
                                    skeleton.k1_skeleton, batch, m, J, c),
                                    reps)}
                row = {"direction": name, "m": m, "batch": batch,
                       "cluster": chosen, "old": times["old"],
                       "new": times["new"], "max_abs_err": errs,
                       "clusters": sweep}
                results.append(row)
                print(f"{name} m={m} B={batch} C={chosen} (order old, new, "
                      f"new, old): old {show(times['old'])}, new "
                      f"{show(times['new'])}; max|diff| old "
                      f"{errs['old']:.2e}, new {errs['new']:.2e}", flush=True)
                for c, t in sweep.items():
                    print(f"    C={c:2d}: kernel {show([t['kernel']])}, "
                          f"skeleton {show([t['skeleton']])}", flush=True)
    print(json.dumps({"card": card, "k1_ab": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
