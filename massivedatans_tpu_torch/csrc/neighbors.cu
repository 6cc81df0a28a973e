// Region-membership kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// massivedatans_tpu/ops/pallas_neighbors.py:
//
//   count_within_pallas            -> mdt_count_within
//   bootstrapped_sq_radius_pallas  -> mdt_bootstrap_radius
//
// What bounds them on this card. Neither is a matrix product worth tensor
// cores (ndim <= 8; the work is subtract, square, compare and min, not
// multiply-add chains) and TF32 is ruled out, so the ceiling is the fp32
// pipe: 67 TFLOP/s. The inputs are a few tens of KB, so bytes bound nothing.
// - The radius is O(M^2 * nb) fp32 work: 2.8 M pairs at the member cap
//   M = 1664, 268 M at M = 16384. Its bound is the operations, about
//   0.7-0.9 us at M = 1664 (ndim 3-5); a launch and a cross-block merge cost
//   more than that, so the design spreads the pairs over every SM and
//   merges in one pass.
// - The count is 512 x 1664 pairs per proposal round, a bound of about
//   0.1 us, far below the launch floor of a few us. Its design goal is one
//   launch per round that writes each count once.
//
// bootstrap radius (mdt_bootstrap_radius), what the design does:
// - nb is a template parameter: the default 10 rounds run exactly 10 min
//   slots per column; one generic instantiation serves any nb <= 32. ndim is
//   a template parameter too, so the coordinate loop has no dead slots.
// - A 2-D grid of row tiles x column spans. A block owns 64 rows (each
//   thread 2 rows, so every column read from shared memory feeds 2
//   distance chains) and one span of the columns; its 8 warps split the
//   span's columns. At M = 1664 the grid is 26 x 8 blocks of 256 threads.
// - The column spans of one row tile form a thread-block cluster (at most 8
//   blocks, the portable size). Each block merges its warps' per-(row,
//   round) minima in shared memory; the cluster's leader then reads the
//   other blocks' minima through distributed shared memory
//   (cooperative_groups::this_cluster().map_shared_rank), takes the
//   out-of-bag max of its rows, and does one atomicMax. min and max are
//   exact in any order, so the result is bitwise the plain version's.
// - A block stages only its own span, in 256-column tiles that are double
//   buffered with cp.async, and packs the in-bag bits of those columns
//   only.
// - No zero-fill launch: the leaders merge into a two-word workspace (max
//   bits, ticket). The leader that draws the last ticket writes the result
//   and resets both words, so the workspace is zero again for the next
//   launch on the stream.
//
// count within (mdt_count_within), what the design does:
// - The caller counts both proposal halves of a round in one call (512
//   points), so a round launches this kernel once and nothing else.
// - A warp owns 2 points; its 32 lanes split the members and sum with
//   __reduce_add_sync, and lane 0 writes each count once: no atomics and no
//   zero-fill. A block of 4 warps (8 points) walks the whole member set
//   through shared memory, coordinate-major so that lanes read
//   consecutive words. Up to 2,048 members sit in shared memory at once
//   (21 KB at M = 1664, ndim 3); larger sets stream through two
//   cp.async buffers of 2,048.
//
// Arithmetic: squared distances are explicit differences summed over the
// coordinates in order k = 0..ndim-1, in fp32 with round-to-nearest
// intrinsics (__fsub_rn/__fmul_rn/__fadd_rn). The intrinsics stop nvcc from
// contracting d*d + acc into an FMA, so every distance is bitwise the same as
// the plain PyTorch versions in ops/neighbors.py compute, and the two agree
// exactly, not only up to a tie band. No TF32 and no tensor cores anywhere.
//
// Launchers have a plain C interface (pointers, sizes, a cudaStream_t passed
// as void*), launch on the caller's stream, allocate nothing, do not
// synchronise, and return the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNbMax = 32;         // the wrapper rejects nbootstraps > 32
constexpr int kNbDefault = 10;     // RunConfig.nbootstraps
constexpr float kPosBig = 1e30f;   // "no in-bag neighbour yet" sentinel

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d2 = sum_k (a_k - b_k)^2 in order, no FMA: the plain version's arithmetic
template <int NDIM>
__device__ __forceinline__ float sq_dist(const float* a, const float* b) {
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    const float d = __fsub_rn(a[k], b[k]);
    d2 = __fadd_rn(d2, __fmul_rn(d, d));
  }
  return d2;
}

// ---------------------------------------------------------------- count ---

constexpr int kCountWarps = 4;
constexpr int kCountPoints = 2;  // points per warp
constexpr int kCountThreads = 32 * kCountWarps;
constexpr int kCountBlockPoints = kCountWarps * kCountPoints;
constexpr int kCountTile = 2048;  // members per shared-memory buffer

// dynamic shared memory: [nbuf][NDIM][tile] floats, then [nbuf][tile] bytes
template <int NDIM>
__global__ void __launch_bounds__(kCountThreads)
    count_within_kernel(const float* __restrict__ points, int n,
                        const float* __restrict__ members,
                        const uint8_t* __restrict__ mask, int m, int tile,
                        const float* __restrict__ radius,
                        int* __restrict__ out) {
  extern __shared__ float s_count[];
  const int ntiles = (m + tile - 1) / tile;
  const int nbuf = ntiles > 1 ? 2 : 1;
  float* s_w = s_count;
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_count + nbuf * NDIM * tile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto stage = [&](int buf, int base, int cnt) {
    float* dst = s_w + buf * NDIM * tile;
    const float* src = members + (size_t)base * NDIM;
    for (int e = tid; e < cnt * NDIM; e += kCountThreads) {
      const int j = e / NDIM;
      cp_async4(dst + (e - j * NDIM) * tile + j, src + e);
    }
    cp_async_commit();
    uint8_t* dm = s_mask + buf * tile;
    for (int j = tid; j < cnt; j += kCountThreads) dm[j] = mask[base + j];
  };
  if (ntiles > 0) stage(0, 0, min(tile, m));

  // r^2 is formed here from the device scalar (as jnp.square(radius) in the
  // TPU kernel): reading radius on the host would sync every proposal round
  const float r = radius[0];
  const float r2 = __fmul_rn(r, r);
  const int i0 = (blockIdx.x * kCountWarps + warp) * kCountPoints;
  float p[kCountPoints][NDIM];
#pragma unroll
  for (int q = 0; q < kCountPoints; ++q) {
#pragma unroll
    for (int k = 0; k < NDIM; ++k) {
      p[q][k] = (i0 + q < n) ? points[(size_t)(i0 + q) * NDIM + k] : 0.f;
    }
  }
  unsigned cnt[kCountPoints] = {};

  for (int t = 0; t < ntiles; ++t) {
    const int base = t * tile;
    const int len = min(tile, m - base);
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      stage(buf ^ 1, base + tile, min(tile, m - base - tile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sw = s_w + buf * NDIM * tile;
    const uint8_t* sm = s_mask + buf * tile;
    for (int j = lane; j < len; j += 32) {
      float mj[NDIM];
#pragma unroll
      for (int k = 0; k < NDIM; ++k) mj[k] = sw[k * tile + j];
      const bool valid = sm[j] != 0;
#pragma unroll
      for (int q = 0; q < kCountPoints; ++q) {
        // strict <, as cneighbors.c:95-119 and the TPU kernel
        cnt[q] += (sq_dist<NDIM>(p[q], mj) < r2 && valid) ? 1u : 0u;
      }
    }
    __syncthreads();  // the buffer is restaged two tiles on
  }

#pragma unroll
  for (int q = 0; q < kCountPoints; ++q) {
    const unsigned total = __reduce_add_sync(0xffffffffu, cnt[q]);
    if (lane == 0 && i0 + q < n) out[i0 + q] = static_cast<int>(total);
  }
}

// --------------------------------------------------------------- radius ---

constexpr int kRadiusWarps = 8;
constexpr int kRadiusThreads = 32 * kRadiusWarps;
constexpr int kRowsPerThread = 2;
constexpr int kRadiusRows = 32 * kRowsPerThread;  // rows per block
constexpr int kRadiusTile = 256;                  // columns per stage
constexpr int kClusterMax = 8;                    // portable cluster size
constexpr int kMinSpan = 32;                      // columns per span, least

// NB > 0: exactly NB rounds; NB == 0: nb_rt rounds at run time (<= 32).
// ws: two words, zero between launches (max bits, ticket).
template <int NDIM, int NB>
__global__ void __launch_bounds__(kRadiusThreads)
    bootstrap_radius_kernel(const float* __restrict__ w,
                            const uint8_t* __restrict__ mask,
                            const uint8_t* __restrict__ inbag, int m,
                            int nb_rt, int span, float* __restrict__ out,
                            unsigned* __restrict__ ws) {
  constexpr int NBMAX = NB > 0 ? NB : kNbMax;
  const int nb = NB > 0 ? NB : nb_rt;
  __shared__ float s_w[2][kRadiusTile * NDIM];
  __shared__ uint32_t s_bag[2][kRadiusTile];
  __shared__ uint32_t s_min[NBMAX * kRadiusRows];  // float bits, >= 0
  __shared__ uint32_t s_rowbag[kRadiusRows];
  __shared__ uint8_t s_rowok[kRadiusRows];
  __shared__ float s_red[kRadiusWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * kRadiusRows;

  for (int t = tid; t < NBMAX * kRadiusRows; t += kRadiusThreads) {
    s_min[t] = __float_as_uint(kPosBig);
  }
  if (rank == 0 && tid < kRadiusRows) {  // the leader's rows: bag bits, mask
    const int i = row0 + tid;
    uint32_t bits = 0;
    bool ok = false;
    if (i < m) {
      ok = mask[i] != 0;
      for (int b = 0; b < nb; ++b) {
        bits |= (inbag[(size_t)b * m + i] != 0 ? 1u : 0u) << b;
      }
    }
    s_rowbag[tid] = bits;
    s_rowok[tid] = ok;
  }

  float p[kRowsPerThread][NDIM];
  bool active[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + lane + 32 * r;
    active[r] = i < m;
#pragma unroll
    for (int k = 0; k < NDIM; ++k) {
      p[r][k] = active[r] ? w[(size_t)i * NDIM + k] : 0.f;
    }
  }
  float nearest[kRowsPerThread][NBMAX];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int b = 0; b < NBMAX; ++b) nearest[r][b] = kPosBig;
  }

  const int c0 = static_cast<int>(rank) * span;
  const int c1 = min(m, c0 + span);
  const int ntiles = c1 > c0 ? (c1 - c0 + kRadiusTile - 1) / kRadiusTile : 0;
  auto stage = [&](int buf, int base, int cnt) {
    const float* src = w + (size_t)base * NDIM;
    for (int e = tid; e < cnt * NDIM; e += kRadiusThreads) {
      cp_async4(&s_w[buf][e], src + e);
    }
    cp_async_commit();
    for (int t = tid; t < cnt; t += kRadiusThreads) {
      uint32_t bits = 0;
      for (int b = 0; b < nb; ++b) {
        bits |= (inbag[(size_t)b * m + base + t] != 0 ? 1u : 0u) << b;
      }
      s_bag[buf][t] = bits;
    }
  };
  if (ntiles > 0) stage(0, c0, min(kRadiusTile, c1 - c0));
  __syncthreads();  // s_min initialised before any warp merges into it

  for (int t = 0; t < ntiles; ++t) {
    const int base = c0 + t * kRadiusTile;
    const int len = min(kRadiusTile, c1 - base);
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      stage(buf ^ 1, base + kRadiusTile, min(kRadiusTile, c1 - base - kRadiusTile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int j = warp; j < len; j += kRadiusWarps) {
      const uint32_t bag = s_bag[buf][j];  // one column per warp: uniform
      if (bag == 0) continue;  // column in no bag: never a neighbour
      const float* wj = &s_w[buf][j * NDIM];
      float d2[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) d2[r] = sq_dist<NDIM>(p[r], wj);
#pragma unroll
      for (int b = 0; b < NBMAX; ++b) {
        if ((NB > 0 || b < nb) && ((bag >> b) & 1u)) {
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            nearest[r][b] = fminf(nearest[r][b], d2[r]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged two tiles on
  }

  // the warps' minima into the block's (non-negative floats order like
  // their unsigned bit patterns; min is exact in any order)
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int b = 0; b < NBMAX; ++b) {
      if (active[r] && (NB > 0 || b < nb) && nearest[r][b] < kPosBig) {
        atomicMin(&s_min[b * kRadiusRows + lane + 32 * r],
                  __float_as_uint(nearest[r][b]));
      }
    }
  }
  cluster.sync();  // every block's minima are complete and visible

  if (rank == 0) {
    const unsigned nblocks = cluster.num_blocks();
    float rmax = 0.f;
    for (int idx = tid; idx < nb * kRadiusRows; idx += kRadiusThreads) {
      const int row = idx % kRadiusRows;
      const int b = idx / kRadiusRows;
      if (!s_rowok[row] || ((s_rowbag[row] >> b) & 1u)) continue;  // in bag
      uint32_t v = s_min[idx];
#pragma unroll
      for (unsigned s = 1; s < kClusterMax; ++s) {  // loads issued together
        if (s < nblocks) v = min(v, cluster.map_shared_rank(s_min, s)[idx]);
      }
      // out-of-bag row; a round whose bag is empty leaves nearest at BIG
      // and contributes 0 (pallas_neighbors.py:152-153)
      const float f = __uint_as_float(v);
      rmax = fmaxf(rmax, f >= kPosBig ? 0.f : f);
    }
    for (int off = 16; off > 0; off >>= 1) {
      rmax = fmaxf(rmax, __shfl_down_sync(0xffffffffu, rmax, off));
    }
    if (lane == 0) s_red[warp] = rmax;
    __syncthreads();
    if (tid == 0) {
      for (int k = 1; k < kRadiusWarps; ++k) rmax = fmaxf(rmax, s_red[k]);
      atomicMax(ws, __float_as_uint(rmax));
      __threadfence();
      const unsigned ticket = atomicAdd(ws + 1, 1u);
      if (ticket == gridDim.y - 1) {  // the last cluster: every max is in
        __threadfence();
        out[0] = __uint_as_float(atomicExch(ws, 0u));
        atomicExch(ws + 1, 0u);
      }
    }
  }
  cluster.sync();  // no block leaves while the leader reads its minima
}

template <int NDIM>
cudaError_t launch_count(const float* points, int n, const float* members,
                         const uint8_t* mask, int m, const float* radius,
                         int* out, cudaStream_t stream) {
  const int tile = m > 0 ? min(m, kCountTile) : 1;
  const int nbuf = m > kCountTile ? 2 : 1;
  const size_t smem = (size_t)nbuf * tile * (NDIM * sizeof(float) + 1);
  if (smem > 48 * 1024) {  // large member sets only: above the default cap
    const cudaError_t set = cudaFuncSetAttribute(
        count_within_kernel<NDIM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (set != cudaSuccess) return set;
  }
  const int grid = (n + kCountBlockPoints - 1) / kCountBlockPoints;
  count_within_kernel<NDIM><<<grid, kCountThreads, smem, stream>>>(
      points, n, members, mask, m, tile, radius, out);
  return cudaGetLastError();
}

template <int NDIM, int NB>
cudaError_t launch_radius(const float* w, const uint8_t* mask,
                          const uint8_t* inbag, int m, int nb, float* out,
                          unsigned* ws, cudaStream_t stream) {
  const int row_tiles = m > 0 ? (m + kRadiusRows - 1) / kRadiusRows : 1;
  const int spans = max(1, min(kClusterMax, (m + kMinSpan - 1) / kMinSpan));
  const int span = (m + spans - 1) / spans;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(spans, row_tiles, 1);
  cfg.blockDim = dim3(kRadiusThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = spans;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, bootstrap_radius_kernel<NDIM, NB>, w, mask, inbag, m, nb, span,
      out, ws);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

template <int NDIM>
cudaError_t launch_radius_nb(const float* w, const uint8_t* mask,
                             const uint8_t* inbag, int m, int nb, float* out,
                             unsigned* ws, cudaStream_t stream) {
  if (nb == kNbDefault) {
    return launch_radius<NDIM, kNbDefault>(w, mask, inbag, m, nb, out, ws,
                                           stream);
  }
  return launch_radius<NDIM, 0>(w, mask, inbag, m, nb, out, ws, stream);
}

}  // namespace

extern "C" {

// out: int32[n], written in full. radius: one float on the device.
int mdt_count_within(const void* points, int n, const void* members,
                     const void* mask, int m, int ndim, const void* radius,
                     void* out, void* stream) {
  if (n <= 0) return 0;
  const auto* p = static_cast<const float*>(points);
  const auto* mem = static_cast<const float*>(members);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* r = static_cast<const float*>(radius);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (ndim) {
    case 1: rc = launch_count<1>(p, n, mem, mk, m, r, o, s); break;
    case 2: rc = launch_count<2>(p, n, mem, mk, m, r, o, s); break;
    case 3: rc = launch_count<3>(p, n, mem, mk, m, r, o, s); break;
    case 4: rc = launch_count<4>(p, n, mem, mk, m, r, o, s); break;
    case 5: rc = launch_count<5>(p, n, mem, mk, m, r, o, s); break;
    case 6: rc = launch_count<6>(p, n, mem, mk, m, r, o, s); break;
    case 7: rc = launch_count<7>(p, n, mem, mk, m, r, o, s); break;
    case 8: rc = launch_count<8>(p, n, mem, mk, m, r, o, s); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

// out: one float, written by the kernel. inbag: uint8[nb, m], 1 <= nb <= 32.
// workspace: two 32-bit words on the device, zero before the first launch;
// the kernel leaves them zero. Launches sharing a workspace must be ordered
// (one stream).
int mdt_bootstrap_radius(const void* w, const void* mask, const void* inbag,
                         int m, int ndim, int nb, void* out, void* workspace,
                         void* stream) {
  if (nb < 1 || nb > kNbMax) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pw = static_cast<const float*>(w);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const auto* ib = static_cast<const uint8_t*>(inbag);
  auto* o = static_cast<float*>(out);
  auto* ws = static_cast<unsigned*>(workspace);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (ndim) {
    case 1: rc = launch_radius_nb<1>(pw, mk, ib, m, nb, o, ws, s); break;
    case 2: rc = launch_radius_nb<2>(pw, mk, ib, m, nb, o, ws, s); break;
    case 3: rc = launch_radius_nb<3>(pw, mk, ib, m, nb, o, ws, s); break;
    case 4: rc = launch_radius_nb<4>(pw, mk, ib, m, nb, o, ws, s); break;
    case 5: rc = launch_radius_nb<5>(pw, mk, ib, m, nb, o, ws, s); break;
    case 6: rc = launch_radius_nb<6>(pw, mk, ib, m, nb, o, ws, s); break;
    case 7: rc = launch_radius_nb<7>(pw, mk, ib, m, nb, o, ws, s); break;
    case 8: rc = launch_radius_nb<8>(pw, mk, ib, m, nb, o, ws, s); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

}  // extern "C"
