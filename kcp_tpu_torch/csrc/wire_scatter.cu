// wire_scatter for Hopper (sm_90a): the reconcile step's side lanes and delta
// scatters, read straight off the packed wire, in two launches of one kernel.
//
// Replaces no Pallas kernel. The reference does this work with XLA's
// drop-mode scatters (kcp_tpu/models/reconcile_model.py apply_mask_stamps
// :283-303, the acks copy in reconcile_step_packed :334-345,
// apply_seg_stamps :400-412; kcp_tpu/ops/diff.py apply_deltas :74-94), which
// XLA fuses into the step's one program. The port's eager PyTorch form of
// them (kcp_tpu_torch/ops/diff.py scatter_rows_drop, some twenty ops a call,
// eight calls a step) stays the CPU path; on the card each call cost the
// host a launch per op, and those launches, not the device, paced the tick.
//
// The wire is the int32 view of the uint32 [D, S+2] packed array: S value
// columns, the row index (column S) and the flags (column S+1: bit 0
// exists, bit 1 side, bit 2 valid, bit 3 mask stamp, bits 8..23 the
// stamp's segment id). A wire row index below 0 counts from the end (+B);
// a row outside [0, B) after that drops.
//
// Stage 0 (stamps), items [0, D) the wire's entries, [D, D + A) the acks:
//   an entry with valid and mask-stamp bits: seg_ids[row] = flags >> 8 &
//   0xFFFF (fleet form) and, for a per-row mask, status_mask[row, :] =
//   value columns != 0;
//   an ack r with 0 <= r < B (no wrap: -1 is padding): down_vals[r, :] =
//   up_vals[r, :], down_exists[r] = up_exists[r].
//   It writes seg_ids, status_mask and the down mirrors and reads only the
//   wire, the acks and the up mirrors, so no item reads what another
//   writes.
// Stage 1 (deltas), items [0, D):
//   an entry with the valid bit and no mask-stamp bit writes its value
//   columns into row `row` of the up mirror (side bit clear) or the down
//   mirror (side bit set), and its exists bit into that mirror's flag;
//   block 0 also writes `applied` = the number of such entries, in range or
//   not (the step's stats[7]).
//   It runs after stage 0 on one stream: the acks copy reads the up rows
//   before any up delta lands, and a down delta on an acked row wins.
// Entries that are not valid write nothing. Two valid entries on one row of
// one lane are unspecified, as in the reference (the host dedups by key).
//
// What bounds it: launches, not bytes. At the served shape (D = 64-128
// entries, S = 64, A = 1,024 acks) a stage reads the entries' index and
// flags and the acks (under 5 KB) and moves ~0.5 KB for each real ack,
// stamp or delta: tens of KB, ~0.01-0.1 us at 3.35 TB/s, while the launch
// itself costs a few us on the card and ~30 us of the host's time. So the design is the plainest that keeps every write exact: a
// warp per item, each lane a strided run of the row's S columns (coalesced
// 4-byte accesses), lane 0 the row's flag byte; no shared memory beyond
// block 0's count, no atomics on global memory, no second pass.
//
// Plain C entry point, built with nvcc into the same library as
// decide_match.cu and loaded with ctypes. The launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int32_t kValid = 4;
constexpr int32_t kSide = 2;
constexpr int32_t kExists = 1;
constexpr int32_t kMaskStamp = 8;  // MASK_STAMP_BIT
constexpr int kSegShift = 8;
constexpr int32_t kSegField = 0xFFFF;

struct Params {
  const int32_t* packed;  // [d, s + 2]
  const int32_t* acks;    // [n_acks], stage 0 only
  int32_t* up;            // [b, s]
  uint8_t* up_exists;     // [b]
  int32_t* down;          // [b, s]
  uint8_t* down_exists;   // [b]
  uint8_t* mask;          // per-row [b, s], or null (bucket-wide mask)
  int32_t* seg;           // [b], or null outside the fleet form
  int32_t* applied;       // [1], stage 1 only
  long long b;
  int d, s, n_acks, stage;
};

// The wire's row index as a row of [0, b), or -1 where it drops.
__device__ __forceinline__ long long wire_row(int32_t idx, long long b) {
  const long long r = idx < 0 ? (long long)idx + b : (long long)idx;
  return r >= 0 && r < b ? r : -1;
}

__global__ void __launch_bounds__(kThreads) wire_scatter_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long w = (long long)p.s + 2;

  if (p.stage == 1 && blockIdx.x == 0) {
    __shared__ int total;
    if (threadIdx.x == 0) total = 0;
    __syncthreads();
    int n = 0;
    for (int i = threadIdx.x; i < p.d; i += kThreads) {
      const int32_t f = p.packed[i * w + p.s + 1];
      n += (f & kValid) != 0 && (f & kMaskStamp) == 0;
    }
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
    if (lane == 0 && n) atomicAdd(&total, n);
    __syncthreads();
    if (threadIdx.x == 0) *p.applied = total;
  }

  if (item < p.d) {
    const int32_t* e = p.packed + item * w;
    const int32_t f = e[p.s + 1];
    if (!(f & kValid)) return;
    const bool stamp = (f & kMaskStamp) != 0;
    if (stamp != (p.stage == 0)) return;
    const long long row = wire_row(e[p.s], p.b);
    if (row < 0) return;
    if (p.stage == 0) {
      if (p.seg != nullptr && lane == 0) p.seg[row] = (f >> kSegShift) & kSegField;
      if (p.mask != nullptr) {
        uint8_t* m = p.mask + row * p.s;
        for (int j = lane; j < p.s; j += 32) m[j] = e[j] != 0;
      }
    } else {
      const bool down = (f & kSide) != 0;
      int32_t* v = (down ? p.down : p.up) + row * p.s;
      for (int j = lane; j < p.s; j += 32) v[j] = e[j];
      if (lane == 0) (down ? p.down_exists : p.up_exists)[row] = (f & kExists) != 0;
    }
  } else if (p.stage == 0 && item < (long long)p.d + p.n_acks) {
    const long long r = p.acks[item - p.d];
    if (r < 0 || r >= p.b) return;
    const int32_t* src = p.up + r * p.s;
    int32_t* dst = p.down + r * p.s;
    for (int j = lane; j < p.s; j += 32) dst[j] = src[j];
    if (lane == 0) p.down_exists[r] = p.up_exists[r];
  }
}

}  // namespace

// One launch of stage 0 (stamps) or 1 (deltas) on the current card, over a
// wire of d entries of s value columns and b resident rows. mask == nullptr
// skips the mask stamps (a bucket-wide mask), seg == nullptr the segment
// stamps, n_acks == 0 the acks copy. Stage 1 writes *applied; stage 0 never
// reads it. A stage or size the kernel cannot take is refused with
// cudaErrorInvalidValue before any launch. At least one block always runs,
// so stage 1 writes *applied for an empty wire too.
extern "C" int kcp_wire_scatter(int stage, const void* packed, int d, int s,
                                long long b, void* up, void* up_exists,
                                void* down, void* down_exists, void* mask,
                                void* seg, const void* acks, int n_acks,
                                void* applied, void* stream) {
  if ((stage != 0 && stage != 1) || d < 0 || s < 0 || b < 0 || n_acks < 0 ||
      (stage == 1 && applied == nullptr) ||
      (stage == 0 && n_acks > 0 && acks == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.packed = (const int32_t*)packed;
  p.acks = stage == 0 ? (const int32_t*)acks : nullptr;
  p.up = (int32_t*)up;
  p.up_exists = (uint8_t*)up_exists;
  p.down = (int32_t*)down;
  p.down_exists = (uint8_t*)down_exists;
  p.mask = stage == 0 ? (uint8_t*)mask : nullptr;
  p.seg = stage == 0 ? (int32_t*)seg : nullptr;
  p.applied = (int32_t*)applied;
  p.b = b;
  p.d = d;
  p.s = s;
  p.n_acks = stage == 0 ? n_acks : 0;
  p.stage = stage;
  const long long items = (long long)d + p.n_acks;
  const long long grid = items > 0 ? (items + kWarps - 1) / kWarps : 1;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wire_scatter_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
