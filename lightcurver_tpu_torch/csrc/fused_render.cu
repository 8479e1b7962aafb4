// The fused render of the deconvolution model (K2), forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lightcurver_tpu/ops/experimental/fused_render.py
// (_fwd_kernel, launched by _fused_render_fwd_impl) and adds the backward
// that the JAX package never built. Per epoch e, with 2M = C rank-1 terms:
//
//   spec   = sum_c u[c] (x) v[c]                        (L, Lh), complex
//   X      = spec * (t_hat * r_hat) [+ h_hat * (t_hat * (pc + i ps))]
//   A + iB = (Ayp + i Byp) X                            (n, Lh)
//   out    = Re{(A + iB)(Cxp + i Sxp)} = A Cxp - B Sxp  (n, n)
//
// The backward, with G the (n, n) cotangent of the epoch:
//   dA = G Cxp^T, dB = -G Sxp^T
//   dXr = Ayp^T dA + Byp^T dB,  dXi = Ayp^T dB - Byp^T dA
//   dspec = dX * conj(t_hat * r_hat)
//   du_re[c] = sum_j dspec_re[:, j] v[c, j],  du_im likewise with dspec_im
//   dv[c]    = sum_k dspec_re[k] u_re[c, k] + dspec_im[k] u_im[c, k]
//   dh_hat   = sum_e dX_e * conj(t_hat_e * (pc + i ps))   (across epochs)
//
// What bounds the forward. Per epoch 4 n L Lh + 2 n^2 Lh multiply-adds in
// the two products and 2 C L Lh in the spectrum: at N 100, n 64, L 256,
// Lh 129, C 8 that is 1.00 G multiply-adds, 30 us on the CUDA cores in
// fp32 (67 TFLOP/s). The products in 3xTF32 on the tensor cores
// (3 x 1.90 GFLOP at 495 TFLOP/s) take 12 us. Reading every operand once
// (30.8 MB, almost all of it t_hat) takes 9.2 us at 3.35 TB/s. So it is
// bound by operations, and only the tensor cores bring that bound near the
// memory floor. Plain TF32 products are off limits (the JAX package's
// 0.15 % flux systematic of reduced-precision products): each operand x
// is split into hi = tf32(x) and lo = tf32(x - hi), and every product is
// hi*hi + hi*lo + lo*hi, summed in fp32, which keeps float32 accuracy.
//
// What the forward's design (k2_forward_rows) does about it, point by
// point against the tile design it replaced (one block per 32 columns of
// the half axis, fp32 FMAs, a second launch summing the tiles' shares):
// 1. Stage 1 was load-bound: one global load of Ayp, Byp per two FMAs.
//    Now both products run on the tensor cores, mma.sync m16n8k8 TF32
//    with fp32 accumulators, as real products: stage 1 is [A; B] =
//    [[Ayp, -Byp], [Byp, Ayp]] [Xr; Xi], stage 2 out = [A, -B] [Cxp; Sxp].
//    Operands come from shared memory at conflict-free strides and are
//    split into hi and lo in registers; a tensor-core warp holds 16 rows
//    of A and of B for up to 9 n-tiles of 8 columns, 6 at ROI-100
//    (register blocking: each fragment it loads feeds 6 or 12 products). Each k-step's four
//    products are summed on the tensor cores from zero and added to the
//    running sums on the CUDA cores, rounded to nearest: the tensor cores'
//    own fp32 sums truncate, which over a running sum of 512 terms cost
//    7e-6 of max|out| on an H100, against 6e-7 this way.
// 2. Stage 2 read Cxp, Sxp from device memory in its inner loop. Now all
//    rows of Cxp, Sxp for 64 output columns come into shared memory at
//    once (cp.async), and stage 2 runs on the tensor cores like stage 1.
// 3. The ragged last tile (one column of 32 at L 256). Now a block owns
//    whole output rows (R = 64, or 32 at n <= 32): one epoch, all of k
//    and j. The half axis is padded inside the block with zero columns to
//    Lhp, a multiple of 8; the grid has no ragged tile.
// 4. The partial-sum round trip (8.2 MB and a second launch). Stage 1 and
//    stage 2 are independent per output row, so the block writes final
//    rows of out: one launch, no scratch, no atomics, and sums in a fixed
//    order (the same bits from run to run).
// 5. Nothing used Hopper's hardware. Now, besides the tensor cores: X is
//    streamed in chunks of 16 rows of k (8 for wide L), double-buffered
//    in shared memory. Of the 20 warps, 8 build chunk c + 1 (the rank-1
//    spectrum and its products with t_hat r_hat and the h channel, fp32
//    on the CUDA cores) while 12 contract chunk c on the tensor cores,
//    handing buffers over with named barriers (bar.sync / bar.arrive).
//    12 / 8 beat 8 / 8 (fewer tiles a warp) and 12 / 4 (too few warps
//    building) on an H100; tools/torch_k2_forward_probe.py times them.
//    The building warps bring their raw rows of t_hat, r_hat, pc, ps,
//    h_hat and u with cp.async one chunk ahead, the tensor-core warps
//    their Ayp, Byp rows likewise; the chunks of k are taken from chunk e
//    on, so blocks of other epochs read other rows of the shared planes.
//    Waves: at n 64, L 256 a block takes 178 KB of shared memory and 640
//    threads (96 registers each), one block per SM, and the 100 blocks
//    of N 100 run in one wave with X built once per epoch (R 32 would
//    build it twice, in two waves of 200 blocks).
// What is left (tools/torch_k2_forward_probe.py times the parts on the
// card): at ROI-100 the chunk pipeline alone (launch, the cp.async traffic
// and the hand-overs of 16 chunks, with no building and no products)
// takes about a third of the time; the building and the tensor-core work
// of stage 1 each take about as long again when run alone and overlap
// only in part; stage 2 about an eighth. Larger chunks need more shared
// memory than the double buffers leave; sharing the epoch-independent
// planes (r_hat, pc, ps, h_re, h_im: 66 of the 92 MB that reach the SMs
// per call) across the blocks of a cluster, and wgmma, come next.
//
// What bounds the backward. The same two products as the forward,
// transposed: [dA | dB] = G [Cxp^T | -Sxp^T] (2 n^2 Lh multiply-adds per
// epoch) and [dXr; dXi] = [[Ayp^T, Byp^T], [-Byp^T, Ayp^T]] [dA; dB]
// (4 n L Lh), then on the CUDA cores dspec, dh_hat and the reductions for
// du and dv (4 C L Lh): 1.06 M, 8.45 M and 1.06 M multiply-adds per epoch
// at ROI-100. At N 100, n 64,
// L 256 that is 11.5 us in 3xTF32 on the tensor cores against 32.6 us in
// fp32 on the CUDA cores; the bytes take 9.9 us.
//
// The backward's design (k2_backward_slab<KC>), against the tile design it
// replaced (one block per 32 columns of the half axis, fp32 FMAs fed by
// float4 loads of Ayp, Byp from L2, every tile recomputing its share of du
// for a second launch to sum):
// 1. A block owns one epoch and one slab of the half axis j: a run of
//    columns, a multiple of 8, as wide as shared memory and the register
//    tiles allow (kMaxSlab), the slabs of one call equal within 8 columns
//    (the wrapper's rule, ops/fused_render_cuda.py::backward_slabs). At
//    ROI-100 and at n 32 one slab covers all of Lh padded to a multiple of
//    8: no ragged tile, no column computed twice. Grid (slabs, N), 512
//    threads: at ROI-100 one block per SM, whose 16 warps hide more of the
//    latency of the tensor cores and of device memory than 8 did (0.18
//    against 0.23 ms at ROI-100 with h, where chunks of 16 rows took 0.26
//    and cp.async prefetching of t_hat, Ayp and Byp 0.23 at 256 threads;
//    tools/torch_k2_backward_ab.py, PERF.md).
// 2. Phase A, on the tensor cores: G and the slab's rows of Cxp, Sxp come
//    into shared memory, and [dA | dB] for the slab is computed there,
//    where it stays for the whole block.
// 3. Phase B, in chunks of KC rows of k, each between block barriers (the
//    synchronous form: no copy overlaps the products): the chunk's
//    columns of Ayp, Byp and u come into shared memory; the warps compute
//    the chunk's [dXr; dXi] on the tensor cores (the A fragments read Ayp,
//    Byp transposed), then all warps, on the CUDA cores, turn it into
//    dspec and, with h, the epoch's rows of dh_part, sum du for the
//    chunk's rows over the slab's columns, and add to dv's running sums.
// 4. Precision as in the forward: operands split hi/lo in registers, each
//    k-step's three products summed from zero on the tensor cores and
//    added in fp32 on the CUDA cores. Strides keep the fragment loads free
//    of bank conflicts: A operands 4 mod 8 (G) or, read transposed, 8 mod
//    16 (Ayp, Byp); B operands 8 mod 16 (dA, dB) or, read transposed,
//    4 mod 8 (the rows of Cxp, Sxp).
// 5. With one slab a block's du and dv are complete and written once: one
//    launch, no du scratch. With more, each slab writes its share of du to
//    du_part, which sum_middle adds up. dh_hat is summed over epochs from
//    dh_part by sum_middle, in epoch order. No float atomics anywhere:
//    every result is the same from run to run.
// What is left (tools/torch_k2_backward_probe.py times the kernel with
// parts switched off): at ROI-100 with h, 0.18 ms, of which switching off
// the elementwise pass saves about 60 us (its loads of t_hat, r_hat, pc,
// ps wait on memory, and it writes the 26 MB of dh_part), the chunks'
// products about 50 us, the du and dv sums 30 us and phase A 10 us; the
// launch, the staging and the barriers alone take 20 us and the dh sum
// 9 us. Without h, 0.12 ms. Warp specialisation with a cp.async chunk
// pipeline (as in the forward), wgmma, and a dh sum without dh_part come
// next.
//
// The k axis (L) is taken in steps of 8. An odd stamp at s = 2 gives
// L = 4 mod 8, so the wrapper pads k with zeros to a multiple of 8 (zero
// columns of u, Ayp, Byp, zero rows of the planes: the same sums) and
// passes the padded L with the Lh of the unpadded one.
//
// Interface: plain C, bound with ctypes. Each call runs on the caller's
// stream, allocates nothing (the wrapper passes any scratch), does not
// synchronise, and returns cudaGetLastError() as an int.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// The backward, k2_backward_slab<KC>
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdChunk = 32;       // KC: rows of k per chunk
constexpr int kMaxSlab = 160;       // columns of a slab: 20 n-tiles of 8

// The forward, k2_forward_rows<NT, R>: R = 64 or 32 output rows per block,
// 640 threads: 12 warps on the tensor cores, 8 building X
constexpr int kPassCols = 64;           // stage 2: output columns per pass
constexpr int kCStride = kPassCols + 8; // = 8 mod 16: B fragments conflict-free
constexpr int kMmaWarps = 12;
constexpr int kBuildWarps = 8;
constexpr int kFwdThreads = 32 * (kMmaWarps + kBuildWarps);
constexpr int kStage2Warps = 16;        // stage 2: 8 x-tiles a row group
constexpr int kMaxNT = 9;               // n-tiles per warp: L <= 430 at R 64
constexpr int kPlanes = 7;              // t_re, t_im, r_hat, pc, ps, h_re, h_im
constexpr int kSmemLimit = 227 * 1024;  // an H100 block's opt-in maximum

// Layout of one forward block's shared memory, in floats. Throughout: v
// (C, vs). Stage 1, the region after it, two buffers of each: the raw
// chunk as cp.async brings it for the building warps (the kPlanes planes'
// rows k0 ... k0 + kc, one span each, and u_re, u_im (C, kc)); X re, im
// (kc, xs), fp32; the chunk's Ayp, Byp rows (R, as1), fp32, brought by the
// tensor-core warps. Stage 2 reuses the region: A, B (R, as), then the
// Cxp, Sxp rows of one pass (lhp, kCStride).
struct FwdGeom {
  int kc;       // rows k per chunk, 16 or (for wide L) 8
  int lhp;      // Lh padded with zero columns to a multiple of 8
  int nt;       // n-tiles of 8 columns per tensor-core warp in stage 1
  int nq;       // columns of 32 per lane of a building warp
  int xs;       // row stride of X, = 8 mod 16
  int as1;      // row stride of the Ayp, Byp rows, kc + 4 = 4 mod 8
  int as;       // row stride of A, B in stage 2, = 4 mod 8
  int vs;       // row stride of v, 32 nq
  int span;     // floats of one plane's chunk, kc Lh rounded up to 4
  int raw;      // floats of one raw buffer
  int xbuf;     // floats of one X buffer
  int abuf;     // floats of one Ayp, Byp buffer
  int total;    // floats of the block
};

__host__ __device__ inline FwdGeom fwd_geom_kc(int C, int L, int Lh, int R,
                                               int kc) {
  FwdGeom g;
  const int groups = kMmaWarps / (R / 16);   // n-groups of the mma warps
  g.kc = kc;
  g.lhp = (Lh + 7) / 8 * 8;
  g.nt = (g.lhp / 8 + groups - 1) / groups;
  g.nq = (g.nt * groups + 3) / 4;
  g.xs = g.lhp % 16 == 8 ? g.lhp : g.lhp + 8;
  g.as1 = kc + 4;
  g.as = g.lhp + 4;
  g.vs = 32 * g.nq;
  g.span = (kc * Lh + 3) / 4 * 4;
  g.raw = kPlanes * g.span + 2 * C * kc;
  g.xbuf = 2 * kc * g.xs;
  g.abuf = 2 * R * g.as1;
  const int stage1 = 2 * (g.raw + g.xbuf + g.abuf);
  const int stage2 = 2 * R * g.as + 2 * g.lhp * kCStride;
  g.total = C * g.vs + (stage1 > stage2 ? stage1 : stage2);
  return g;
}

// Chunks of 16 rows of k where they fit the block's shared memory, else 8
__host__ __device__ inline FwdGeom fwd_geom(int C, int L, int Lh, int R) {
  const FwdGeom g = fwd_geom_kc(C, L, Lh, R, 16);
  return g.total * 4 <= kSmemLimit ? g : fwd_geom_kc(C, L, Lh, R, 8);
}

// Rows of the forward's blocks: 64 above n = 32 (X built once per epoch
// at n 64) where the n-tiles fit the registers, else 32; -1 where there
// is no instance.
inline int fwd_rows(int L, int Lh, int n) {
  const int R = n > 32 && fwd_geom(1, L, Lh, 64).nt <= kMaxNT ? 64 : 32;
  return fwd_geom(1, L, Lh, R).nt <= kMaxNT ? R : -1;
}

// Layout of one backward block's shared memory, in floats, for slabs of at
// most w columns. Throughout: v of the slab (w, c4), dv's running sums
// (c4 / 4, w, 4), dA and dB (ny, ds). Phase A, the region after them: G
// (ny, gs) and the slab's rows of Cxp, Sxp (w, gs). Phase B reuses the
// region: the chunk's columns of Ayp, Byp (ny, as), of u_re, u_im (KC, c4)
// and dX re, im (KC, ds), which becomes dspec. The python twin is
// ops/fused_render_cuda.py::backward_smem_bytes.
struct BwdGeom {
  int ny;       // rows y of G, dA, dB: n rounded up to 16, zero past n
  int c4;       // terms c: C rounded up to 4, zero past C
  int w;        // columns of the widest slab, a multiple of 8
  int gs;       // row stride of G and of the Cxp, Sxp rows, ny + 4
  int ds;       // row stride of dA, dB and dX, = 8 mod 16
  int as;       // row stride of the Ayp, Byp columns, KC + 8
  int total;    // floats of the block
};

__host__ __device__ inline BwdGeom bwd_geom(int C, int n, int w, int kc) {
  BwdGeom g;
  g.ny = (n + 15) / 16 * 16;
  g.c4 = (C + 3) / 4 * 4;
  g.w = w;
  g.gs = g.ny + 4;
  g.ds = w % 16 == 8 ? w : w + 8;
  g.as = kc + 8;
  const int phase_a = g.ny * g.gs + 2 * w * g.gs;
  const int phase_b = 2 * g.ny * g.as + 2 * kc * g.c4 + 2 * kc * g.ds;
  g.total = 2 * w * g.c4 + 2 * g.ny * g.ds +
            (phase_a > phase_b ? phase_a : phase_b);
  return g;
}

// Columns of the widest of n_slabs slabs over Lh padded to a multiple of 8
__host__ __device__ inline int bwd_slab_width(int Lh, int n_slabs) {
  const int units = (Lh + 7) / 8;
  return 8 * ((units + n_slabs - 1) / n_slabs);
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product with fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: lo*hi + hi*lo + hi*hi, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// The A fragment of an m16n8k8 product from a row-major fp32 tile at p,
// split into hi and lo on the way: rows g, g + 8 and columns t, t + 4 of
// the lane (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float* p, int stride) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * stride], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * stride + 4], hi[3], lo[3]);
}

// Asynchronous copies into shared memory (cp.async); a thread waits for
// its own with cp_async_wait, and a barrier after that shows them to all
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// rows x cols floats from src (row stride ss) to dst (row stride ds) by
// threads tid = 0 ... count - 1: 16 bytes a copy where both sides allow it
__device__ __forceinline__ void copy_rows(float* dst, int ds, const float* src,
                                          size_t ss, int rows, int cols,
                                          int tid, int count) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                    (ss | ds | cols) % 4 == 0;
  const int w = wide ? 4 : 1;
  const int per_row = cols / w;
  for (int p = tid; p < rows * per_row; p += count) {
    const int r = p / per_row;
    const int q = (p - r * per_row) * w;
    if (wide)
      cp_async16(dst + r * ds + q, src + r * ss + q);
    else
      cp_async4(dst + r * ds + q, src + r * ss + q);
  }
}

// The same for one contiguous span of `size` floats
__device__ __forceinline__ void copy_span(float* dst, const float* src,
                                          int size, int tid, int count) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0 && size % 4 == 0) {
    for (int q = 4 * tid; q < size; q += 4 * count)
      cp_async16(dst + q, src + q);
  } else {
    for (int q = tid; q < size; q += count) cp_async4(dst + q, src + q);
  }
}

// The B fragment (k rows t, t + 4 of column g) from a k-major fp32 tile
// at p, split into hi and lo on the way
__device__ __forceinline__ void load_b_split(uint32_t (&hi)[2],
                                             uint32_t (&lo)[2],
                                             const float* p, int stride) {
  split(p[0], hi[0], lo[0]);
  split(p[4 * stride], hi[1], lo[1]);
}

// The A fragment from a column-major tile at p (element (row m, column k)
// at p[k * stride + m]): p points at row g, column t of the lane
__device__ __forceinline__ void load_at_split(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float* p, int stride) {
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * stride], hi[2], lo[2]);
  split(p[4 * stride + 8], hi[3], lo[3]);
}

// The B fragment from an n-major tile at p (element (k, column n) at
// p[n * stride + k]): p points at k row t of column g of the lane
__device__ __forceinline__ void load_bt_split(uint32_t (&hi)[2],
                                              uint32_t (&lo)[2],
                                              const float* p) {
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// Named barriers between the warps that build X and those that contract
// it: bar.sync waits for `count` threads, bar.arrive only counts itself
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

constexpr int kFull = 1;    // + buffer: X of the chunk is built
constexpr int kEmpty = 3;   // + buffer: the tensor cores are done with it
constexpr int kBuilt = 5;   // the building warps alone

// Epoch blockIdx.y, output rows y0 = blockIdx.x * R ... of out (N, n, n),
// written whole. NT = fwd_geom(C, L, Lh, R).nt; kFwdThreads threads.
template <int NT, int R>
__global__ void __launch_bounds__(kFwdThreads, 1)
k2_forward_rows(const float* __restrict__ u_re, const float* __restrict__ u_im,
                const float* __restrict__ v, const float* __restrict__ t_re,
                const float* __restrict__ t_im,
                const float* __restrict__ r_hat, const float* __restrict__ pc,
                const float* __restrict__ ps, const float* __restrict__ h_re,
                const float* __restrict__ h_im, const float* __restrict__ ayp,
                const float* __restrict__ byp, const float* __restrict__ cxp,
                const float* __restrict__ sxp, float* __restrict__ out,
                int C, int L, int Lh, int n, int include_h) {
  constexpr int kGroups = R / 16;                 // row groups of 16
  constexpr int kNGroups = kMmaWarps / kGroups;   // n-groups, mma warps
  constexpr int kNQ = (NT * kNGroups + 3) / 4;
  constexpr int kMmaThreads = 32 * kMmaWarps;
  constexpr int kBuildThreads = 32 * kBuildWarps;
  extern __shared__ float smem[];
  const FwdGeom geo = fwd_geom(C, L, Lh, R);
  const int e = blockIdx.y;
  const int y0 = blockIdx.x * R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;     // the fragments' row / column group
  const int tig = lane & 3;      // and the lane within it
  const int kcm = geo.kc, lhp = geo.lhp, xs = geo.xs, vs = geo.vs;
  const int as1 = geo.as1, span = geo.span;
  const int rows_in = min(R, n - y0);

  float* sv = smem;
  float* region = sv + C * vs;
  auto raw_buf = [&](int b) { return region + b * geo.raw; };
  auto x_buf = [&](int b) { return region + 2 * geo.raw + b * geo.xbuf; };
  auto ab_buf = [&](int b) {
    return region + 2 * (geo.raw + geo.xbuf) + b * geo.abuf;
  };

  for (int p = threadIdx.x; p < C * vs; p += kFwdThreads) {
    const int c = p / vs;
    const int j = p - c * vs;
    sv[p] = j < Lh ? v[(static_cast<size_t>(e) * C + c) * Lh + j] : 0.f;
  }
  __syncthreads();

  // Stage 1 in chunks of kc rows of k, taken from chunk e on, wrapping
  // around (blocks of other epochs read other rows of the shared planes at
  // any one time). The building warps turn chunk `it` into X in buffer
  // it % 2, from raw rows that cp.async brought while they built the last
  // chunk, while the tensor-core warps contract chunk it - 1 from the other
  // buffer, with Ayp, Byp rows that they brought themselves the same way.
  const int n_chunks = (L + kcm - 1) / kcm;
  auto chunk_k0 = [&](int it) { return (it + e) % n_chunks * kcm; };
  float acc_a[NT][4], acc_b[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_a[i][q] = acc_b[i][q] = 0.f;
  const int wm = warp % kGroups;   // tensor-core warp: rows wm * 16 ...
  const int wn = warp / kGroups;   // and the n-tiles wn + kNGroups i

  if (warp >= kMmaWarps) {
    const int bt = threadIdx.x - kMmaThreads;
    const int bw = warp - kMmaWarps;
    const int n_planes = include_h ? kPlanes : 3;
    const size_t te = static_cast<size_t>(e) * L * Lh;
    const size_t ue = static_cast<size_t>(e) * C * L;
    auto fetch = [&](int it) {
      const int k0 = chunk_k0(it);
      const int kc = min(kcm, L - k0);
      const size_t o = static_cast<size_t>(k0) * Lh;
      const float* planes[kPlanes] = {t_re + te + o, t_im + te + o,
                                      r_hat + o, pc + o, ps + o, h_re + o,
                                      h_im + o};
      float* dst = raw_buf(it & 1);
#pragma unroll
      for (int i = 0; i < kPlanes; ++i)
        if (i < n_planes)
          copy_span(dst + i * span, planes[i], kc * Lh, bt, kBuildThreads);
      float* du = dst + kPlanes * span;
      copy_rows(du, kcm, u_re + ue + k0, L, C, kc, bt, kBuildThreads);
      copy_rows(du + C * kcm, kcm, u_im + ue + k0, L, C, kc, bt,
                kBuildThreads);
      cp_async_commit();
    };
    fetch(0);
    for (int it = 0; it < n_chunks; ++it) {
      const int b = it & 1;
      const int kc = min(kcm, L - chunk_k0(it));   // a multiple of 8
      cp_async_wait();
      bar_sync(kBuilt, kBuildThreads);   // raw rows in; the last ones read
      if (it + 1 < n_chunks) fetch(it + 1);
      if (it >= 2) bar_sync(kEmpty + b, kFwdThreads);
      const float* raw = raw_buf(b);
      const float* ru = raw + kPlanes * span;
      float* sxr = x_buf(b);
      float* sxi = sxr + kcm * xs;
      // X rows kk = bw, bw + kBuildWarps, ...; lane: the columns
      // lane + 32 q, zero from Lh on
      for (int kk = bw; kk < kc; kk += kBuildWarps) {
        float sr[kNQ], si[kNQ];
#pragma unroll
        for (int q = 0; q < kNQ; ++q) sr[q] = si[q] = 0.f;
        for (int c = 0; c < C; ++c) {
          const float ur = ru[c * kcm + kk];
          const float ui = ru[(C + c) * kcm + kk];
#pragma unroll
          for (int q = 0; q < kNQ; ++q) {
            const float vc = sv[c * vs + lane + 32 * q];
            sr[q] = fmaf(ur, vc, sr[q]);
            si[q] = fmaf(ui, vc, si[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          const int j = lane + 32 * q;
          if (j >= lhp) break;
          float xr = 0.f, xi = 0.f;
          if (j < Lh) {
            const int o = kk * Lh + j;
            const float tr = raw[o], ti = raw[span + o];
            const float r = raw[2 * span + o];
            const float pr = tr * r, pi = ti * r;
            xr = sr[q] * pr - si[q] * pi;
            xi = sr[q] * pi + si[q] * pr;
            if (include_h) {
              const float cr = raw[3 * span + o], ci = raw[4 * span + o];
              const float gr = tr * cr - ti * ci;
              const float gi = tr * ci + ti * cr;
              const float hr = raw[5 * span + o], hi = raw[6 * span + o];
              xr += hr * gr - hi * gi;
              xi += hr * gi + hi * gr;
            }
          }
          sxr[kk * xs + j] = xr;
          sxi[kk * xs + j] = xi;
        }
      }
      bar_arrive(kFull + b, kFwdThreads);
    }
  } else {
    auto fetch_ab = [&](int it) {
      const int k0 = chunk_k0(it);
      const int kc = min(kcm, L - k0);
      const size_t o = static_cast<size_t>(y0) * L + k0;
      float* dst = ab_buf(it & 1);
      copy_rows(dst, as1, ayp + o, L, rows_in, kc, threadIdx.x, kMmaThreads);
      copy_rows(dst + R * as1, as1, byp + o, L, rows_in, kc, threadIdx.x,
                kMmaThreads);
      cp_async_commit();
    };
    fetch_ab(0);
    // A += Ayp Xr - Byp Xi,  B += Byp Xr + Ayp Xi. Each of the four
    // products of a k-step is summed on the tensor cores from zero and
    // added to the running sums on the CUDA cores, rounded to nearest: the
    // tensor cores' fp32 sums truncate, which over a long running sum
    // costs ~1e-5.
    for (int it = 0; it < n_chunks; ++it) {
      const int b = it & 1;
      const int kc = min(kcm, L - chunk_k0(it));
      cp_async_wait();
      // X built, the Ayp, Byp rows in, every mma warp done with the last
      // chunk (so its Ayp, Byp buffer may be refilled)
      bar_sync(kFull + b, kFwdThreads);
      if (it + 1 < n_chunks) fetch_ab(it + 1);
      const float* sxr = x_buf(b);
      const float* sxi = sxr + kcm * xs;
      const float* sa = ab_buf(b);
      const float* sb = sa + R * as1;
      for (int ks = 0; ks < kc; ks += 8) {
        const int ar = (wm * 16 + gid) * as1 + ks + tig;
        uint32_t ah[4], al[4], bh[4], bl[4];
        load_a_split(ah, al, sa + ar, as1);
        load_a_split(bh, bl, sb + ar, as1);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int col = (wn + kNGroups * i) * 8;
          if (col >= lhp) break;
          const int xb = (ks + tig) * xs + col + gid;
          uint32_t xrh[2], xrl[2], xih[2], xil[2];
          load_b_split(xrh, xrl, sxr + xb, xs);
          load_b_split(xih, xil, sxi + xb, xs);
          float p1[4] = {}, p2[4] = {}, p3[4] = {}, p4[4] = {};
          mma3(p1, ah, al, xrh, xrl);
          mma3(p2, bh, bl, xih, xil);
          mma3(p3, bh, bl, xrh, xrl);
          mma3(p4, ah, al, xih, xil);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc_a[i][q] += p1[q] - p2[q];
            acc_b[i][q] += p3[q] + p4[q];
          }
        }
      }
      if (it + 2 < n_chunks) bar_arrive(kEmpty + b, kFwdThreads);
    }
  }
  __syncthreads();   // stage 1 is done: the region is free

  // A, B to shared memory, fp32: accumulator element q of tile i is row
  // gid + 8 (q / 2), column 2 tig + q % 2
  const int as = geo.as;
  float* sA = region;
  float* sB = sA + R * as;
  if (warp < kMmaWarps) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int col = (wn + kNGroups * i) * 8;
      if (col >= lhp) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = (wm * 16 + gid + 8 * (q >> 1)) * as + col + 2 * tig +
                      (q & 1);
        sA[s] = acc_a[i][q];
        sB[s] = acc_b[i][q];
      }
    }
  }

  // stage 2: out = A Cxp - B Sxp on kStage2Warps warps, kPassCols output
  // columns per pass, all rows j of Cxp, Sxp brought at once by cp.async
  // (by all warps); warp (mt, wx) takes rows mt * 16 ... + 15 and the
  // x-tiles wx + kXStep i
  constexpr int kXStep = kStage2Warps / kGroups;   // warps per row group
  constexpr int kXTiles = 8 / kXStep;        // x-tiles per warp and pass
  float* sc = sB + R * as;
  float* ss = sc + lhp * kCStride;
  const int mt = warp % kGroups;
  const int wx = warp / kGroups;
  float* oute = out + static_cast<size_t>(e) * n * n;
  for (int x0 = 0; x0 < n; x0 += kPassCols) {
    __syncthreads();   // A, B written; the last pass's rows read
    const int cols = min(kPassCols, n - x0);
    copy_rows(sc, kCStride, cxp + x0, n, Lh, cols, threadIdx.x, kFwdThreads);
    copy_rows(ss, kCStride, sxp + x0, n, Lh, cols, threadIdx.x, kFwdThreads);
    cp_async_commit();
    for (int p = threadIdx.x; p < (lhp - Lh) * kCStride; p += kFwdThreads) {
      sc[Lh * kCStride + p] = 0.f;   // the padding rows: zero, not stale
      ss[Lh * kCStride + p] = 0.f;
    }
    cp_async_wait();
    __syncthreads();
    if (warp >= kStage2Warps) continue;
    float acc[kXTiles][4] = {};
    for (int ks = 0; ks < lhp; ks += 8) {
      const int ar = (mt * 16 + gid) * as + ks + tig;
      uint32_t ah[4], al[4], bh[4], bl[4];
      load_a_split(ah, al, sA + ar, as);
      load_a_split(bh, bl, sB + ar, as);
#pragma unroll
      for (int i = 0; i < kXTiles; ++i) {
        const int col = (wx + kXStep * i) * 8;
        if (col >= cols) break;
        const int cb = (ks + tig) * kCStride + col + gid;
        uint32_t ch[2], cl[2], sh[2], sl[2];
        load_b_split(ch, cl, sc + cb, kCStride);
        load_b_split(sh, sl, ss + cb, kCStride);
        float p1[4] = {}, p2[4] = {};
        mma3(p1, ah, al, ch, cl);
        mma3(p2, bh, bl, sh, sl);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += p1[q] - p2[q];
      }
    }
#pragma unroll
    for (int i = 0; i < kXTiles; ++i) {
      const int col = x0 + (wx + kXStep * i) * 8 + 2 * tig;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int y = y0 + mt * 16 + gid + 8 * (q >> 1);
        const int x = col + (q & 1);
        if (y < n && x < n) oute[static_cast<size_t>(y) * n + x] = acc[i][q];
      }
    }
  }
}

// Epoch blockIdx.y, slab blockIdx.x of gridDim.x over the half axis (the
// slabs split Lh padded to a multiple of 8 into runs of 8 columns, equal
// within one run). du: (2, N, slabs, C, L), the slabs' shares of du_re and
// du_im, which with one slab is du itself, (2, N, C, L); dv: (N, C, Lh),
// written whole; dh_part: (2, N, L, Lh), the epoch's share of dh_hat.
template <int KC>
__global__ void __launch_bounds__(kBwdThreads, 1)
k2_backward_slab(const float* __restrict__ g, const float* __restrict__ u_re,
                 const float* __restrict__ u_im, const float* __restrict__ v,
                 const float* __restrict__ t_re,
                 const float* __restrict__ t_im,
                 const float* __restrict__ r_hat,
                 const float* __restrict__ pc, const float* __restrict__ ps,
                 const float* __restrict__ ayp, const float* __restrict__ byp,
                 const float* __restrict__ cxp, const float* __restrict__ sxp,
                 float* __restrict__ du, float* __restrict__ dv,
                 float* __restrict__ dh_part, int C, int L, int Lh, int n,
                 int include_h) {
  constexpr int kMGroups = KC / 16;                 // m-tiles of a chunk
  constexpr int kNGroups = kBwdWarps / kMGroups;    // n-groups of warps
  constexpr int kNT = (kMaxSlab / 8 + kNGroups - 1) / kNGroups;
  extern __shared__ float smem[];
  const int N = gridDim.y;
  const int n_slabs = gridDim.x;
  const int e = blockIdx.y;
  const int slab = blockIdx.x;
  const int units = (Lh + 7) / 8;
  const int base = units / n_slabs, rem = units % n_slabs;
  const int j0 = 8 * (slab * base + min(slab, rem));
  const int w = 8 * (base + (slab < rem ? 1 : 0));   // this slab's columns
  const BwdGeom geo = bwd_geom(C, n, bwd_slab_width(Lh, n_slabs), KC);
  const int ny = geo.ny, c4 = geo.c4, gs = geo.gs, ds = geo.ds, as = geo.as;
  const int cgs = c4 / 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;     // the fragments' row / column group
  const int tig = lane & 3;      // and the lane within it

  float* sv = smem;                     // v: [jj][c]
  float* sdv = sv + geo.w * c4;         // dv: [c / 4][jj][c % 4]
  float* sda = sdv + geo.w * c4;
  float* sdb = sda + ny * ds;
  float* region = sdb + ny * ds;
  float* sg = region;                   // phase A
  float* scx = sg + ny * gs;
  float* ssx = scx + geo.w * gs;
  float* say = region;                  // phase B
  float* sby = say + ny * as;
  float* sur = sby + ny * as;           // u: [kk][c]
  float* sui = sur + KC * c4;
  float* sxr = sui + KC * c4;           // dX, then dspec: [kk][jj]
  float* sxi = sxr + KC * ds;

  const float* ge = g + static_cast<size_t>(e) * n * n;
  for (int p = tid; p < ny * gs; p += kBwdThreads) {
    const int y = p / gs;
    const int x = p - y * gs;
    sg[p] = y < n && x < n ? ge[y * n + x] : 0.f;
  }
  for (int p = tid; p < w * gs; p += kBwdThreads) {
    const int jj = p / gs;
    const int x = p - jj * gs;
    const bool in = j0 + jj < Lh && x < n;
    const size_t q = static_cast<size_t>(j0 + jj) * n + x;
    scx[p] = in ? cxp[q] : 0.f;
    ssx[p] = in ? sxp[q] : 0.f;
  }
  for (int p = tid; p < geo.w * c4; p += kBwdThreads) {
    const int c = p / geo.w;
    const int jj = p - c * geo.w;
    sv[jj * c4 + c] = c < C && j0 + jj < Lh
                          ? v[(static_cast<size_t>(e) * C + c) * Lh + j0 + jj]
                          : 0.f;
    sdv[p] = 0.f;
  }
  __syncthreads();

  // Phase A: dA = G Cxp^T, dB = -G Sxp^T for the slab's columns; a warp
  // takes (m-tile of 16 rows y, n-tile of 8 columns) jobs, k = x in steps
  // of 8, G and the Cxp, Sxp rows zero past n
  const int mtiles = ny / 16;
  for (int job = warp; job < mtiles * (w / 8); job += kBwdWarps) {
    const int mt = job % mtiles;
    const int col = job / mtiles * 8;
    float acc_a[4] = {}, acc_b[4] = {};
    for (int ks = 0; ks < ny; ks += 8) {
      uint32_t gh[4], gl[4], ch[2], cl[2], sh[2], sl[2];
      load_a_split(gh, gl, sg + (mt * 16 + gid) * gs + ks + tig, gs);
      const int cb = (col + gid) * gs + ks + tig;
      load_bt_split(ch, cl, scx + cb);
      load_bt_split(sh, sl, ssx + cb);
      float pa[4] = {}, pb[4] = {};
      mma3(pa, gh, gl, ch, cl);
      mma3(pb, gh, gl, sh, sl);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc_a[q] += pa[q];
        acc_b[q] -= pb[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = (mt * 16 + gid + 8 * (q >> 1)) * ds + col + 2 * tig +
                    (q & 1);
      sda[s] = acc_a[q];
      sdb[s] = acc_b[q];
    }
  }
  __syncthreads();   // G and the Cxp, Sxp rows are dead from here on

  // Phase B, chunks of KC rows of k. Warp (bm, bn) of the product takes
  // rows bm * 16 ... of the chunk and the n-tiles bn + kNGroups i.
  const int bm = warp % kMGroups;
  const int bn = warp / kMGroups;
  const size_t te = static_cast<size_t>(e) * L * Lh;
  const size_t plane = static_cast<size_t>(L) * Lh;
  const size_t cl = static_cast<size_t>(C) * L;
  float* du_re = du + (static_cast<size_t>(e) * n_slabs + slab) * cl;
  float* du_im = du_re + static_cast<size_t>(N) * n_slabs * cl;
  for (int k0 = 0; k0 < L; k0 += KC) {
    const int kc = min(KC, L - k0);   // a multiple of 8
    for (int p = tid; p < ny * KC; p += kBwdThreads) {
      const int y = p / KC;
      const int kk = p - y * KC;
      const bool in = y < n && kk < kc;
      const size_t q = static_cast<size_t>(y) * L + k0 + kk;
      say[y * as + kk] = in ? ayp[q] : 0.f;
      sby[y * as + kk] = in ? byp[q] : 0.f;
    }
    for (int p = tid; p < c4 * KC; p += kBwdThreads) {
      const int c = p / KC;
      const int kk = p - c * KC;
      const bool in = c < C && kk < kc;
      const size_t q = (static_cast<size_t>(e) * C + c) * L + k0 + kk;
      sur[kk * c4 + c] = in ? u_re[q] : 0.f;
      sui[kk * c4 + c] = in ? u_im[q] : 0.f;
    }
    __syncthreads();

    // dXr = Ayp^T dA + Byp^T dB, dXi = Ayp^T dB - Byp^T dA, k = y in steps
    // of 8; rows of the chunk past L are zero (Ayp, Byp staged as zero)
    {
      float acc_r[kNT][4], acc_i[kNT][4];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_r[i][q] = acc_i[i][q] = 0.f;
      for (int ks = 0; ks < ny; ks += 8) {
        const int ar = (ks + tig) * as + bm * 16 + gid;
        uint32_t ah[4], al[4], bh[4], bl[4];
        load_at_split(ah, al, say + ar, as);
        load_at_split(bh, bl, sby + ar, as);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const int col = (bn + kNGroups * i) * 8;
          if (col >= w) break;
          const int xb = (ks + tig) * ds + col + gid;
          uint32_t dah[2], dal[2], dbh[2], dbl[2];
          load_b_split(dah, dal, sda + xb, ds);
          load_b_split(dbh, dbl, sdb + xb, ds);
          float p1[4] = {}, p2[4] = {}, p3[4] = {}, p4[4] = {};
          mma3(p1, ah, al, dah, dal);
          mma3(p2, bh, bl, dbh, dbl);
          mma3(p3, ah, al, dbh, dbl);
          mma3(p4, bh, bl, dah, dal);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc_r[i][q] += p1[q] + p2[q];
            acc_i[i][q] += p3[q] - p4[q];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int col = (bn + kNGroups * i) * 8;
        if (col >= w) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = (bm * 16 + gid + 8 * (q >> 1)) * ds + col + 2 * tig +
                        (q & 1);
          sxr[s] = acc_r[i][q];
          sxi[s] = acc_i[i][q];
        }
      }
    }
    __syncthreads();

    // dspec = dX conj(t_hat r_hat) in place and, with h, the epoch's rows
    // of dh_part; zero past Lh. Warp: rows kk; lane: columns jj.
    for (int kk = warp; kk < kc; kk += kBwdWarps) {
      const size_t row = static_cast<size_t>(k0 + kk) * Lh;
      for (int jj = lane; jj < w; jj += 32) {
        const int j = j0 + jj;
        const int s = kk * ds + jj;
        float dsr = 0.f, dsi = 0.f;
        if (j < Lh) {
          const float dxr = sxr[s], dxi = sxi[s];
          const size_t q = row + j;
          const float tr = t_re[te + q], ti = t_im[te + q], r = r_hat[q];
          const float pr = tr * r, pi = ti * r;
          dsr = dxr * pr + dxi * pi;
          dsi = dxi * pr - dxr * pi;
          if (include_h) {
            const float cr = pc[q], ci = ps[q];
            const float gr = tr * cr - ti * ci;
            const float gi = tr * ci + ti * cr;
            dh_part[te + q] = dxr * gr + dxi * gi;
            dh_part[N * plane + te + q] = dxi * gr - dxr * gi;
          }
        }
        sxr[s] = dsr;
        sxi[s] = dsi;
      }
    }
    __syncthreads();

    // du[c, k0 + kk] = sum_jj dspec[kk, jj] v[c, jj]: eight lanes share
    // (kk, four terms c), each summing every eighth column, and their sums
    // are added by shuffles in a fixed order. The item count is a multiple
    // of 32, so every warp runs whole.
    for (int p = tid; p < KC * cgs * 8; p += kBwdThreads) {
      const int part = p & 7;
      const int item = p >> 3;
      const int kk = item / cgs;
      const int cg = item - kk * cgs;
      float ar[4] = {}, ai[4] = {};
      for (int jj = part; jj < w; jj += 8) {
        const float xr = sxr[kk * ds + jj], xi = sxi[kk * ds + jj];
        const float4 vc = *reinterpret_cast<const float4*>(sv + jj * c4 +
                                                           4 * cg);
        const float vq[4] = {vc.x, vc.y, vc.z, vc.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[q] = fmaf(xr, vq[q], ar[q]);
          ai[q] = fmaf(xi, vq[q], ai[q]);
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[q] += __shfl_xor_sync(0xffffffffu, ar[q], o);
          ai[q] += __shfl_xor_sync(0xffffffffu, ai[q], o);
        }
      if (part == 0 && kk < kc) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * cg + q;
          if (c < C) {
            du_re[static_cast<size_t>(c) * L + k0 + kk] = ar[q];
            du_im[static_cast<size_t>(c) * L + k0 + kk] = ai[q];
          }
        }
      }
    }

    // dv[c, jj] += sum_kk dspec_re[kk, jj] u_re[c, kk] + dspec_im u_im: a
    // thread owns (four terms c, column jj) in every chunk, so the running
    // sums need no barrier of their own
    for (int p = tid; p < cgs * w; p += kBwdThreads) {
      const int cg = p / w;
      const int jj = p - cg * w;
      float4* run = reinterpret_cast<float4*>(sdv + (cg * geo.w + jj) * 4);
      float a[4] = {run->x, run->y, run->z, run->w};
      for (int kk = 0; kk < kc; ++kk) {
        const float xr = sxr[kk * ds + jj], xi = sxi[kk * ds + jj];
        const float4 ur = *reinterpret_cast<const float4*>(sur + kk * c4 +
                                                           4 * cg);
        const float4 ui = *reinterpret_cast<const float4*>(sui + kk * c4 +
                                                           4 * cg);
        a[0] = fmaf(xr, ur.x, fmaf(xi, ui.x, a[0]));
        a[1] = fmaf(xr, ur.y, fmaf(xi, ui.y, a[1]));
        a[2] = fmaf(xr, ur.z, fmaf(xi, ui.z, a[2]));
        a[3] = fmaf(xr, ur.w, fmaf(xi, ui.w, a[3]));
      }
      *run = make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncthreads();   // the chunk's buffers are free
  }

  // dv of the slab, complete; each thread writes the sums it owns
  for (int p = tid; p < cgs * w; p += kBwdThreads) {
    const int cg = p / w;
    const int jj = p - cg * w;
    if (j0 + jj >= Lh) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * cg + q;
      if (c < C)
        dv[(static_cast<size_t>(e) * C + c) * Lh + j0 + jj] =
            sdv[(cg * geo.w + jj) * 4 + q];
    }
  }
}

// out[o, i] = sum_t in[o, t, i] for t = 0 .. mid - 1, in that order.
__global__ void sum_middle(const float* __restrict__ in,
                           float* __restrict__ out, int outer, int mid,
                           int inner) {
  const size_t total = static_cast<size_t>(outer) * inner;
  for (size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < total; p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t o = p / inner;
    const size_t i = p - o * inner;
    const float* src = in + o * mid * inner + i;
    float acc = 0.f;
    for (int t = 0; t < mid; ++t) acc += src[static_cast<size_t>(t) * inner];
    out[p] = acc;
  }
}

cudaError_t launch_sum_middle(const float* in, float* out, int outer,
                              int mid, int inner, cudaStream_t stream) {
  const long long total = static_cast<long long>(outer) * inner;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 16 ? total / 256 + 1 : 132 * 16);
  sum_middle<<<blocks, 256, 0, stream>>>(in, out, outer, mid, inner);
  return cudaGetLastError();
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` when needed.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

int g_forward_smem[2][kMaxNT + 1] = {};
int g_backward_smem = 0;

template <int NT, int R>
cudaError_t launch_forward(const float* u_re, const float* u_im,
                           const float* v, const float* t_re,
                           const float* t_im, const float* r_hat,
                           const float* pc, const float* ps,
                           const float* h_re, const float* h_im,
                           const float* ayp, const float* byp,
                           const float* cxp, const float* sxp, float* out,
                           int N, int C, int L, int Lh, int n, int include_h,
                           int smem, cudaStream_t s) {
  cudaError_t e = allow_smem(k2_forward_rows<NT, R>, smem,
                             &g_forward_smem[R / 64][NT]);
  if (e != cudaSuccess) return e;
  k2_forward_rows<NT, R><<<dim3((n + R - 1) / R, N), kFwdThreads, smem, s>>>(
      u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im, ayp, byp, cxp,
      sxp, out, C, L, Lh, n, include_h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt in to on `device`, in
// bytes, or -1 on error.
int k2_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Dynamic shared memory of one block of the forward (backward = 0) or
// backward (backward = 1, over n_slabs slabs of the half axis) kernel, in
// bytes; -1 where the forward has no instance (L too wide for its register
// tiles) or a backward slab would be wider than kMaxSlab.
int k2_smem_bytes(int backward, int C, int L, int Lh, int n, int n_slabs) {
  const int bytes = static_cast<int>(sizeof(float));
  if (backward) {
    const int w = bwd_slab_width(Lh, n_slabs);
    if (n_slabs < 1 || w > kMaxSlab) return -1;
    return bwd_geom(C, n, w, kBwdChunk).total * bytes;
  }
  const int R = fwd_rows(L, Lh, n);
  if (R < 0) return -1;
  return fwd_geom(C, L, Lh, R).total * bytes;
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: (N, n, n), written whole by one launch. h_re, h_im are not read
// when include_h is 0.
int k2_forward(const float* u_re, const float* u_im, const float* v,
               const float* t_re, const float* t_im, const float* r_hat,
               const float* pc, const float* ps, const float* h_re,
               const float* h_im, const float* ayp, const float* byp,
               const float* cxp, const float* sxp, float* out, int N, int C,
               int L, int Lh, int n, int include_h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = k2_smem_bytes(0, C, L, Lh, n, 0);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int R = fwd_rows(L, Lh, n);
#define K2_ARGS                                                             \
  u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im, ayp, byp, cxp, sxp, \
      out, N, C, L, Lh, n, include_h, smem, s
#define K2_FORWARD(NT, R)                                                   \
  case NT:                                                                  \
    return static_cast<int>(launch_forward<NT, R>(K2_ARGS))
  if (R == 64) {
    switch (fwd_geom(C, L, Lh, 64).nt) {
      K2_FORWARD(1, 64);
      K2_FORWARD(2, 64);
      K2_FORWARD(3, 64);
      K2_FORWARD(4, 64);
      K2_FORWARD(5, 64);
      K2_FORWARD(6, 64);
      K2_FORWARD(7, 64);
      K2_FORWARD(8, 64);
      K2_FORWARD(9, 64);
    }
  } else {
    switch (fwd_geom(C, L, Lh, 32).nt) {
      K2_FORWARD(1, 32);
      K2_FORWARD(2, 32);
      K2_FORWARD(3, 32);
      K2_FORWARD(4, 32);
      K2_FORWARD(5, 32);
      K2_FORWARD(6, 32);
      K2_FORWARD(7, 32);
      K2_FORWARD(8, 32);
      K2_FORWARD(9, 32);
    }
  }
#undef K2_FORWARD
#undef K2_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// n_slabs: slabs of the half axis, one block each per epoch
// (ops/fused_render_cuda.py::backward_slabs). du_part: scratch
// (2, N, n_slabs, C, L), not touched (and may be null) with one slab;
// du: (2, N, C, L) = du_re, du_im; dv: (N, C, Lh); dh_part: scratch
// (2, N, L, Lh); dh: (2, L, Lh) = dh_re, dh_im. dh_part and dh are not
// touched when include_h is 0. One launch, plus one sum_middle for du with
// more than one slab and one for dh with h.
int k2_backward(const float* g, const float* u_re, const float* u_im,
                const float* v, const float* t_re, const float* t_im,
                const float* r_hat, const float* pc, const float* ps,
                const float* ayp, const float* byp, const float* cxp,
                const float* sxp, float* du_part, float* du, float* dv,
                float* dh_part, float* dh, int N, int C, int L, int Lh, int n,
                int include_h, int n_slabs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = k2_smem_bytes(1, C, L, Lh, n, n_slabs);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(k2_backward_slab<kBwdChunk>, smem,
                             &g_backward_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k2_backward_slab<kBwdChunk><<<dim3(n_slabs, N), kBwdThreads, smem, s>>>(
      g, u_re, u_im, v, t_re, t_im, r_hat, pc, ps, ayp, byp, cxp, sxp,
      n_slabs > 1 ? du_part : du, dv, dh_part, C, L, Lh, n, include_h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_slabs > 1) {
    // du over slabs, for re and im at once: outer 2 N
    e = launch_sum_middle(du_part, du, 2 * N, n_slabs, C * L, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!include_h) return static_cast<int>(cudaSuccess);
  // dh_hat over epochs, in epoch order
  return static_cast<int>(launch_sum_middle(dh_part, dh, 2, N, L * Lh, s));
}

}  // extern "C"
