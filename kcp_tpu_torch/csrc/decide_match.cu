// decide_and_match for Hopper (sm_90a): the spec/status decision and the
// label fan-out of the reconcile tick in one pass over the two mirrors.
//
// Replaces the Pallas TPU kernel kcp_tpu/ops/pallas_kernels.py
// decide_and_match (body _decide_match_kernel, pl.pallas_call at :184).
//
// What it computes, per row r of B rows with S slots:
//   decision[r] = CREATE(1) if up exists and down does not,
//                 DELETE(3) if down exists and up does not,
//                 UPDATE(2) if both exist and a spec slot differs,
//                 NOOP(0) otherwise;
//   upsync[r]   = both exist and a status slot differs;
// and per selector c of C, counts[c] = the number of resident up rows whose
// L label pair hashes contain sel[c].
//
// What bounds it: bytes. Every input byte is read once and the outputs
// are O(B + C), with a few integer ops per byte loaded. At the serving
// shape (B=131,072, S=64, per-row bool mask, L=1, C=8) one call moves
// 76,546,112 B: 2*B*S*4 mirrors + B*S mask + B*L*4 pair hashes + 2*B
// exists flags + 2*B output bytes (76,546,048 B of row data) + 64 B of
// selectors and counts. That is 22.85 us at 3.35 TB/s, the bound.
//
// Design. The TPU kernel walked a sequential grid and carried the count
// accumulator across grid steps in VMEM; on the GPU blocks run in parallel,
// so:
//   - rows map to groups of G lanes (G = 32 when S >= 32, else the power
//     of two >= S, so a warp covers 32/G rows); the lanes stride over the
//     row's S int32 bit views (coalesced), OR neq&~mask and neq&mask into
//     per-lane flags, and one __ballot_sync per flag, cut to the group's
//     bits, gives the row's spec_dirty/status_dirty;
//   - the status mask is read through one stride: 0 for the bucket-wide
//     [S] form, S for the per-row [B,S] form;
//   - a lane of the group owns a fixed set of selectors (c = lane, lane+G,
//     ...), counts its hits in registers over every row the block visits,
//     and folds them into a per-block shared [C] histogram; the block then
//     atomicAdds its non-zero counts into the global [C]. The kernel only
//     ever adds into counts: the unsharded wrapper zeroes them first, and
//     the sharded wrapper (decide_and_match_sharded, which replaces the
//     shard_map + psum of pallas_kernels.py:223) hands one zeroed buffer
//     to every row shard on a device, so that buffer accumulates the
//     shards' counts. Integer atomics are exact in any order, so the
//     kernel and the plain PyTorch version agree bit for bit;
//   - a grid-stride loop over row tiles with a grid of at most 8 blocks per
//     SM keeps the global atomics to ~8k per call.
// Plain C entry point, built with nvcc and loaded with ctypes (see
// kcp_tpu_torch/ops/cuda_kernels.py). The launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegSelectors = 4;  // selector slots a lane counts in registers

__global__ void __launch_bounds__(kThreads)
decide_match_kernel(const int32_t* __restrict__ up,
                    const int32_t* __restrict__ down,
                    const uint8_t* __restrict__ up_exists,
                    const uint8_t* __restrict__ down_exists,
                    const uint8_t* __restrict__ mask, long long mask_stride,
                    const int32_t* __restrict__ pair,
                    const int32_t* __restrict__ sel,
                    uint8_t* __restrict__ decision,
                    uint8_t* __restrict__ upsync,
                    int32_t* __restrict__ counts,
                    long long rows, int s, int l, int c, int group) {
  extern __shared__ int32_t smem[];
  int32_t* s_sel = smem;      // [C] selector hashes
  int32_t* s_cnt = smem + c;  // [C] this block's hit counts
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_sel[i] = sel[i];
    s_cnt[i] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int rows_per_warp = 32 / group;
  const int sub = lane / group;     // which of the warp's rows
  const int g_lane = lane % group;  // lane within that row's group
  const unsigned gmask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (sub * group);
  const long long step = (long long)gridDim.x * warps * rows_per_warp;

  int acc[kRegSelectors];
#pragma unroll
  for (int k = 0; k < kRegSelectors; ++k) acc[k] = 0;

  // the loop bound depends only on the warp, so every lane reaches both
  // ballots together
  for (long long base = ((long long)blockIdx.x * warps + warp) * rows_per_warp;
       base < rows; base += step) {
    const long long row = base + sub;
    const bool live = row < rows;
    bool spec = false, stat = false;
    if (live) {
      const int32_t* u = up + row * s;
      const int32_t* d = down + row * s;
      const uint8_t* m = mask + row * mask_stride;
      for (int j = g_lane; j < s; j += group) {
        const bool neq = u[j] != d[j];
        const bool st = m[j] != 0;
        spec |= neq && !st;
        stat |= neq && st;
      }
    }
    const unsigned spec_bits = __ballot_sync(0xffffffffu, spec) & gmask;
    const unsigned stat_bits = __ballot_sync(0xffffffffu, stat) & gmask;
    if (!live) continue;
    const bool ue = up_exists[row] != 0;
    const bool de = down_exists[row] != 0;
    if (g_lane == 0) {
      uint8_t code = 0;
      if (ue && !de) code = 1;
      else if (!ue && de) code = 3;
      else if (ue && de && spec_bits) code = 2;
      decision[row] = code;
      upsync[row] = (ue && de && stat_bits) ? 1 : 0;
    }
    if (!ue) continue;  // only resident up rows fan out
    const int32_t* p = pair + row * l;
#pragma unroll
    for (int k = 0; k < kRegSelectors; ++k) {
      const int sc = g_lane + k * group;
      if (sc < c) {
        const int32_t want = s_sel[sc];
        bool hit = false;
        for (int q = 0; q < l; ++q) hit |= p[q] == want;
        acc[k] += hit;
      }
    }
    for (int sc = g_lane + kRegSelectors * group; sc < c; sc += group) {
      const int32_t want = s_sel[sc];
      bool hit = false;
      for (int q = 0; q < l; ++q) hit |= p[q] == want;
      if (hit) atomicAdd(&s_cnt[sc], 1);
    }
  }
#pragma unroll
  for (int k = 0; k < kRegSelectors; ++k) {
    const int sc = g_lane + k * group;
    if (sc < c && acc[k]) atomicAdd(&s_cnt[sc], acc[k]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const int32_t v = s_cnt[i];
    if (v) atomicAdd(&counts[i], v);
  }
}

}  // namespace

extern "C" int kcp_decide_match(const void* up, const void* down,
                                const void* up_exists, const void* down_exists,
                                const void* mask, long long mask_stride,
                                const void* pair, const void* sel,
                                void* decision, void* upsync, void* counts,
                                long long rows, int s, int l, int c,
                                void* stream) {
  if (rows <= 0) return 0;
  int group = 32;
  while (group > 1 && group / 2 >= s) group /= 2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)(kThreads / 32) * (32 / group);
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const long long max_blocks = 8LL * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t smem = 2 * (size_t)c * sizeof(int32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decide_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decide_match_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const int32_t*)up, (const int32_t*)down, (const uint8_t*)up_exists,
      (const uint8_t*)down_exists, (const uint8_t*)mask, mask_stride,
      (const int32_t*)pair, (const int32_t*)sel, (uint8_t*)decision,
      (uint8_t*)upsync, (int32_t*)counts, rows, s, l, c, group);
  return (int)cudaGetLastError();
}
