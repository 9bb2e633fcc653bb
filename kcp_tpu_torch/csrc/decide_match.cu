// decide_and_match for Hopper (sm_90a): the spec/status decision, the label
// fan-out and (fleet form) the per-segment live-row count of the reconcile
// tick in one pass over the two mirrors.
//
// Replaces the Pallas TPU kernel kcp_tpu/ops/pallas_kernels.py
// decide_and_match (body _decide_match_kernel, pl.pallas_call at :184), and
// with it the drop-mode segment add that follows it in the fleet step
// (kcp_tpu/models/reconcile_model.py reconcile_step_fleet, :433-434). One
// launch takes a group of up to kMaxShards row shards that lie on one card,
// which replaces decide_and_match_sharded (:223-271: a shard_map of the
// kernel above, one launch per row shard, and a psum of the counts): the
// counts of the group's shards are summed in the kernel's histograms.
//
// What it computes, per row r of each shard's rows, S slots a row:
//   decision[r] = CREATE(1) if up exists and down does not,
//                 DELETE(3) if down exists and up does not,
//                 UPDATE(2) if both exist and a spec slot differs,
//                 NOOP(0) otherwise;
//   upsync[r]   = both exist and a status slot differs;
// per selector c of C, counts[c] += the number of resident up rows whose L
// label pair hashes contain sel[c]; and in the fleet form, per segment g of
// cap, seg_counts[g] += the number of resident up rows whose segment id,
// with a negative id taken from the end (id + cap), is g (ids outside
// [0, cap) drop). The kernel only ever adds into counts and seg_counts.
//
// What bounds it: bytes. Every input byte is read once and the outputs are
// O(B + C + cap), with a few integer ops per byte loaded. At the serving
// shape (B=131,072, S=64, per-row bool mask, L=1, C=8) one call moves
// 76,546,112 B: 2*B*S*4 mirrors + B*S mask + B*L*4 pair hashes + 2*B exists
// flags + 2*B output bytes + 64 B of selectors and counts, 22.85 us at
// 3.35 TB/s. The fleet form adds B*4 segment ids and cap*4 counts:
// 77,070,432 B at cap=8, 23.01 us.
//
// Design: keep enough bytes in flight per SM (Little's law at 3.35 TB/s
// asks for ~15-20 KB) without spending threads or registers on addresses.
//   - Persistent grid: two blocks per SM (the host's plan; measured
//     against one block with a deeper ring, which its own consumers pace);
//     block k walks the group's tiles t = k, k + grid, ... A tile is T
//     consecutive rows of one shard, T a multiple of 16, so each input's
//     tile is one contiguous byte range whose size and start are multiples
//     of 16. The global tile order puts every bulk tile first (shard 0's,
//     then shard 1's, ...), then every plain-path tile in shard order;
//     producer and consumers map a tile to its shard with one function
//     (locate), and the ring's stage and phase run on across shards.
//   - The group table (a kMaxShards array of shard descriptors) lies in the
//     launch parameters as a __grid_constant__, so the kernel indexes it
//     with a runtime shard number in place: no local-memory copy, and
//     nothing is copied to the card per call.
//   - A ring of `stages` tiles in shared memory, fed by one elected
//     producer thread with one 1-D bulk copy per range
//     (cp.async.bulk ... mbarrier::complete_tx::bytes; no tensor map). The
//     stage's "full" mbarrier is armed with the stage's byte count; the
//     8 consumer warps wait on it, compute from shared memory and arrive on
//     the stage's "empty" mbarrier, which the producer waits on before it
//     refills the stage. Each side keeps its phase parity in a register.
//   - Consumers read the tile as a flat run of T*S slots in 16-byte
//     vectors (4 up, 4 down). Only a vector that differs costs more: each
//     differing slot looks up its status-mask byte (per-row tile, or its
//     shard's own copy of the bucket-wide [S] mask in global memory) and
//     ORs spec (1) or status (2) into its row's flag word in shared memory.
//     After one barrier among the consumers, one thread per row writes
//     decision and upsync (coalesced) and counts its segment into a shared
//     [cap] histogram (one atomic per distinct segment per warp), and the
//     (row, selector) pairs of the tile are spread over all consumers,
//     adding hits into a shared [C] histogram.
//   - The histograms are zeroed once per block and, at its end, the block
//     adds each non-zero bin into the global [C] and [cap] outputs, over
//     every tile of every shard it took: ~grid*(C + cap) integer atomics
//     per call, exact in any order, so the counts are the group's sum and
//     the kernel agrees with the plain PyTorch version bit for bit.
//   - Rows the bulk path cannot take go through a plain-load path in this
//     kernel: each shard's last partial tile, every tile of a shard whose
//     base pointers are not 16-byte aligned, and every tile when S is so
//     large that two stages of 16 rows do not fit. The host makes the plan
//     (kcp_tpu_torch/ops/cuda_kernels.py _group_plan) and passes it in.
//   - Every wait on an mbarrier traps after ~2^34 cycles, so a fault in
//     the pipeline fails the launch instead of hanging the card.
// Plain C entry point, built with nvcc and loaded with ctypes. The launch
// goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxShards = 16;  // shards one launch takes (cuda_kernels.MAX_SHARDS)
constexpr unsigned kBarBytes = 2 * kMaxStages * 8;  // full + empty mbarriers
constexpr long long kWaitTrapCycles = 1LL << 34;

// One row shard of a launch: its inputs and outputs, rows and tiles.
struct Shard {
  const int32_t* up;
  const int32_t* down;
  const uint8_t* up_exists;
  const uint8_t* down_exists;
  const uint8_t* mask;  // [rows, S] per row, or the bucket-wide [S]
  const int32_t* pair;
  const int32_t* seg;  // null outside the fleet form
  uint8_t* decision;
  uint8_t* upsync;
  long long rows;
  long long bulk_tiles;   // its tiles [0, bulk_tiles) come through bulk copies
  long long bulk_first;   // global index of its first bulk tile
  long long plain_first;  // its first plain-path tile among the group's
};

struct Params {
  Shard shard[kMaxShards];
  int n;                  // shards in the group
  const int32_t* sel;     // the group's replicated [C] selectors
  int32_t* counts;
  int32_t* seg_counts;    // null outside the fleet form
  long long mask_stride;  // S for the per-row [rows, S] mask, 0 for [S]
  int s, l, c, cap;
  int tile;               // T rows per tile
  int stages;             // ring depth (0: no bulk tiles)
  long long bulk_tiles;   // global tiles [0, bulk_tiles) are bulk-copied
  long long tiles;        // every shard's ceil(rows / T), summed
};

// Where global tile t lies: its shard and the shard's own tile index. The
// producer and the consumers both map tiles through this function alone.
struct Loc {
  int k;
  long long tile;
};

__device__ __forceinline__ Loc locate(const Params& p, long long t) {
  const bool bulk = t < p.bulk_tiles;
  const long long u = bulk ? t : t - p.bulk_tiles;
  int k = 0;  // the last shard whose first tile is at or before u
  while (k + 1 < p.n &&
         u >= (bulk ? p.shard[k + 1].bulk_first : p.shard[k + 1].plain_first))
    ++k;
  const Shard& sh = p.shard[k];
  return {k, bulk ? u - sh.bulk_first : sh.bulk_tiles + (u - sh.plain_first)};
}

// Byte offsets of one stage: up, down, mask, exists, pair, seg.
struct StageLayout {
  unsigned up, down, mask, ue, de, pair, seg, bytes;
};

__host__ __device__ inline StageLayout stage_layout(int t, int s, int l,
                                                    bool per_row, bool fleet) {
  StageLayout o;
  const unsigned ts = (unsigned)t * (unsigned)s;
  o.up = 0;
  o.down = 4 * ts;
  o.mask = 8 * ts;
  o.ue = o.mask + (per_row ? ts : 0);
  o.de = o.ue + t;
  o.pair = o.de + t;
  o.seg = o.pair + 4u * t * l;
  o.bytes = o.seg + (fleet ? 4u * t : 0);
  return o;
}

// Byte offsets of a block's shared memory: mbarriers, two row-flag
// buffers, selectors, selector and segment histograms, then the ring.
struct SmemLayout {
  unsigned flags, sel, cnt, segc, ring, total;
};

__host__ __device__ inline SmemLayout smem_layout(int t, int c, int cap, int stages,
                                                  unsigned stage_bytes) {
  SmemLayout m;
  m.flags = kBarBytes;
  m.sel = m.flags + 8u * t;
  m.cnt = m.sel + 4u * c;
  m.segc = m.cnt + 4u * c;
  m.ring = (m.segc + 4u * cap + 127) / 128 * 128;
  m.total = m.ring + (unsigned)stages * stage_bytes;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > kWaitTrapCycles) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n"
               " mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One 1-D bulk copy global -> shared, completing on `bar`'s transaction
// count. Sizes and both addresses are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// One tile's rows, in shared memory (bulk path) or global memory (plain).
struct Tile {
  const int32_t* up;
  const int32_t* down;
  const uint8_t* mask;
  long long mstride;
  const uint8_t* ue;
  const uint8_t* de;
  const int32_t* pair;
  const int32_t* seg;
};

// OR spec (1) or status (2) into the flag word of the row of every set
// bit of `bits` (slot e0 + bit of the tile's flat run).
__device__ __forceinline__ void mark(const Tile& v, int e0, unsigned bits,
                                     int s, int32_t* flags) {
  while (bits) {
    const int e = e0 + __ffs(bits) - 1;
    bits &= bits - 1;
    const int row = e / s;
    const int j = e - row * s;
    const bool status = v.mask[row * v.mstride + j] != 0;
    atomicOr(&flags[row], status ? 2 : 1);
  }
}

// The flat slot scan of a staged tile: 16-byte vectors from shared memory.
__device__ __forceinline__ void scan_vec(const Tile& v, int n_slots, int s,
                                         int32_t* flags, int ctid) {
  const int4* u4 = reinterpret_cast<const int4*>(v.up);
  const int4* d4 = reinterpret_cast<const int4*>(v.down);
  const int nvec = n_slots >> 2;
#pragma unroll 2
  for (int k = ctid; k < nvec; k += kConsumers) {
    const int4 a = u4[k];
    const int4 b = d4[k];
    const unsigned bits = (unsigned)(a.x != b.x) | ((unsigned)(a.y != b.y) << 1) |
                          ((unsigned)(a.z != b.z) << 2) |
                          ((unsigned)(a.w != b.w) << 3);
    if (bits) mark(v, 4 * k, bits, s, flags);
  }
}

// The flat slot scan of a tile read straight from global memory.
__device__ __forceinline__ void scan_plain(const Tile& v, int n_slots, int s,
                                           int32_t* flags, int ctid) {
  for (int e = ctid; e < n_slots; e += kConsumers) {
    if (v.up[e] != v.down[e]) mark(v, e, 1u, s, flags);
  }
}

// After the scan: decision, upsync and the segment count per row (one
// thread per row), then the selector hits over the tile's (row, selector)
// pairs. Resets the row flags it read.
__device__ __forceinline__ void finish_rows(const Params& p, const Shard& sh,
                                            const Tile& v, int n, long long r0,
                                            int32_t* flags,
                                            const int32_t* s_sel,
                                            int32_t* s_cnt, int32_t* s_seg,
                                            int ctid) {
  const int lane = ctid & 31;
  for (int rb = ctid - lane; rb < n; rb += kConsumers) {  // warp-uniform
    const int r = rb + lane;
    int key = -1;
    if (r < n) {
      const bool ue = v.ue[r] != 0;
      const bool de = v.de[r] != 0;
      const int f = flags[r];
      flags[r] = 0;
      uint8_t code = 0;
      if (ue && !de) code = 1;
      else if (!ue && de) code = 3;
      else if (ue && de && (f & 1)) code = 2;
      sh.decision[r0 + r] = code;
      sh.upsync[r0 + r] = (ue && de && (f & 2)) ? 1 : 0;
      if (v.seg != nullptr && ue) {
        int g = v.seg[r];
        if (g < 0) g += p.cap;
        if (g >= 0 && g < p.cap) key = g;
      }
    }
    if (v.seg != nullptr) {
      const unsigned same = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == __ffs(same) - 1) atomicAdd(&s_seg[key], __popc(same));
    }
  }
  const int c = p.c, l = p.l;
  const int items = n * c;
  for (int w = ctid; w < items; w += kConsumers) {
    const int r = w / c;
    const int k = w - r * c;
    if (v.ue[r] == 0) continue;  // only resident up rows fan out
    const int32_t want = s_sel[k];
    const int32_t* pr = v.pair + (long long)r * l;
    bool hit = false;
    for (int q = 0; q < l; ++q) hit |= pr[q] == want;
    if (hit) atomicAdd(&s_cnt[k], 1);
  }
}

__global__ void __launch_bounds__(kThreads)
decide_match_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const bool per_row = p.mask_stride != 0;
  const bool fleet = p.seg_counts != nullptr;
  const bool bulk = p.bulk_tiles > 0;
  const int T = p.tile;
  const StageLayout lo = stage_layout(T, p.s, p.l, per_row, fleet);
  const SmemLayout sm = smem_layout(T, p.c, p.cap, bulk ? p.stages : 0, lo.bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int32_t* s_flags = reinterpret_cast<int32_t*>(smem + sm.flags);
  int32_t* s_sel = reinterpret_cast<int32_t*>(smem + sm.sel);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(smem + sm.cnt);
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem + sm.segc);
  uint8_t* ring = smem + sm.ring;

  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * T; i += kThreads) s_flags[i] = 0;
  for (int i = tid; i < p.c; i += kThreads) {
    s_sel[i] = p.sel[i];
    s_cnt[i] = 0;
  }
  for (int i = tid; i < p.cap; i += kThreads) s_seg[i] = 0;
  if (tid == 0 && bulk) {
    for (int k = 0; k < p.stages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (warp == kConsumerWarps) {
    // the producer: one elected thread keeps the ring full
    if (lane != 0 || !bulk) return;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < p.bulk_tiles; t += gridDim.x) {
      const Loc at = locate(p, t);
      const Shard& sh = p.shard[at.k];
      mbar_wait(&empty[stage], phase ^ 1);  // passes at once in round 0
      uint8_t* st = ring + (size_t)stage * lo.bytes;
      uint64_t* bar = &full[stage];
      mbar_arrive_expect_tx(bar, lo.bytes);
      const long long r0 = at.tile * T;
      const long long e0 = r0 * p.s;
      const unsigned ts = (unsigned)T * (unsigned)p.s;
      bulk_load(st + lo.up, sh.up + e0, 4 * ts, bar);
      bulk_load(st + lo.down, sh.down + e0, 4 * ts, bar);
      if (per_row) bulk_load(st + lo.mask, sh.mask + e0, ts, bar);
      bulk_load(st + lo.ue, sh.up_exists + r0, T, bar);
      bulk_load(st + lo.de, sh.down_exists + r0, T, bar);
      bulk_load(st + lo.pair, sh.pair + r0 * p.l, 4u * T * p.l, bar);
      if (fleet) bulk_load(st + lo.seg, sh.seg + r0, 4u * T, bar);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the consumers
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;
  for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
    int32_t* flags = s_flags + (it & 1) * T;
    const Loc at = locate(p, t);
    const Shard& sh = p.shard[at.k];
    const long long r0 = at.tile * T;
    if (t < p.bulk_tiles) {
      mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + (size_t)stage * lo.bytes;
      Tile v;
      v.up = reinterpret_cast<const int32_t*>(st + lo.up);
      v.down = reinterpret_cast<const int32_t*>(st + lo.down);
      v.mask = per_row ? st + lo.mask : sh.mask;
      v.mstride = per_row ? p.s : 0;
      v.ue = st + lo.ue;
      v.de = st + lo.de;
      v.pair = reinterpret_cast<const int32_t*>(st + lo.pair);
      v.seg = fleet ? reinterpret_cast<const int32_t*>(st + lo.seg) : nullptr;
      scan_vec(v, T * p.s, p.s, flags, tid);
      consumer_sync();
      finish_rows(p, sh, v, T, r0, flags, s_sel, s_cnt, s_seg, tid);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    } else {
      const int n = (int)(sh.rows - r0 < T ? sh.rows - r0 : T);
      Tile v;
      v.up = sh.up + r0 * p.s;
      v.down = sh.down + r0 * p.s;
      v.mask = sh.mask + r0 * p.mask_stride;
      v.mstride = p.mask_stride;
      v.ue = sh.up_exists + r0;
      v.de = sh.down_exists + r0;
      v.pair = sh.pair + r0 * p.l;
      v.seg = fleet ? sh.seg + r0 : nullptr;
      scan_plain(v, n * p.s, p.s, flags, tid);
      consumer_sync();
      finish_rows(p, sh, v, n, r0, flags, s_sel, s_cnt, s_seg, tid);
    }
  }
  consumer_sync();
  for (int i = tid; i < p.c; i += kConsumers) {
    const int32_t x = s_cnt[i];
    if (x) atomicAdd(&p.counts[i], x);
  }
  for (int i = tid; i < p.cap; i += kConsumers) {
    const int32_t x = s_seg[i];
    if (x) atomicAdd(&p.seg_counts[i], x);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// A block's shared-memory bytes under a plan (mirrored on the host by
// cuda_kernels._smem_bytes).
long long plan_smem(int s, int l, int c, int cap, bool per_row, bool fleet,
                    int tile, int stages, bool bulk) {
  const StageLayout lo = stage_layout(tile, s, l, per_row, fleet);
  return smem_layout(tile, c, cap, bulk ? stages : 0, lo.bytes).total;
}

}  // namespace

// One shard as the host describes it: eleven 8-byte words in this order
// (cuda_kernels._descriptors).
struct KcpShardDesc {
  const void* up;
  const void* down;
  const void* up_exists;
  const void* down_exists;
  const void* mask;
  const void* pair;
  const void* seg;
  void* decision;
  void* upsync;
  long long rows;
  long long bulk_tiles;
};

// The number of SMs of the current device.
extern "C" int kcp_sm_count(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
}

// One launch over `n` row shards on the current card (a single call is a
// group of one). seg_counts == nullptr: the 3-output form; otherwise every
// shard's seg ids count into seg_counts. Every shard adds into the one
// counts (and seg_counts) buffer; sel is the group's. The plan (tile,
// stages, grid, each shard's bulk_tiles) comes from the host; a plan the
// kernel cannot run is refused with cudaErrorInvalidValue before any
// launch. No rows: nothing is launched.
extern "C" int kcp_decide_match(const KcpShardDesc* shards, int n,
                                long long mask_stride, const void* sel,
                                void* counts, void* seg_counts, int s, int l,
                                int c, int cap, int tile, int stages, int grid,
                                void* stream) {
  const bool per_row = mask_stride != 0;
  const bool fleet = seg_counts != nullptr;
  if (n <= 0 || n > kMaxShards || tile <= 0 || tile % 16 != 0 || grid <= 0 ||
      stages < 0 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  long long bulk = 0, plain = 0;
  for (int k = 0; k < n; ++k) {
    const KcpShardDesc& d = shards[k];
    if (d.rows < 0 || d.bulk_tiles < 0 || d.bulk_tiles * tile > d.rows ||
        (fleet && d.rows > 0 && d.seg == nullptr))
      return (int)cudaErrorInvalidValue;
    if (d.bulk_tiles > 0 &&
        (stages < 2 ||
         !(aligned16(d.up) && aligned16(d.down) && (!per_row || aligned16(d.mask)) &&
           aligned16(d.up_exists) && aligned16(d.down_exists) &&
           (l == 0 || aligned16(d.pair)) && (!fleet || aligned16(d.seg)))))
      return (int)cudaErrorInvalidValue;
    Shard& sh = p.shard[k];
    sh.up = (const int32_t*)d.up;
    sh.down = (const int32_t*)d.down;
    sh.up_exists = (const uint8_t*)d.up_exists;
    sh.down_exists = (const uint8_t*)d.down_exists;
    sh.mask = (const uint8_t*)d.mask;
    sh.pair = (const int32_t*)d.pair;
    sh.seg = fleet ? (const int32_t*)d.seg : nullptr;
    sh.decision = (uint8_t*)d.decision;
    sh.upsync = (uint8_t*)d.upsync;
    sh.rows = d.rows;
    sh.bulk_tiles = d.bulk_tiles;
    sh.bulk_first = bulk;
    sh.plain_first = plain;
    bulk += d.bulk_tiles;
    plain += (d.rows + tile - 1) / tile - d.bulk_tiles;
  }
  if (bulk + plain == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!fleet) cap = 0;
  const long long smem = plan_smem(s, l, c, cap, per_row, fleet, tile, stages, bulk > 0);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  static bool raised[64];
  if (smem > 48 * 1024 && (dev >= 64 || !raised[dev])) {
    err = cudaFuncSetAttribute(decide_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  p.n = n;
  p.sel = (const int32_t*)sel;
  p.counts = (int32_t*)counts;
  p.seg_counts = (int32_t*)seg_counts;
  p.mask_stride = mask_stride;
  p.s = s;
  p.l = l;
  p.c = c;
  p.cap = cap;
  p.tile = tile;
  p.stages = stages;
  p.bulk_tiles = bulk;
  p.tiles = bulk + plain;
  decide_match_kernel<<<(unsigned)grid, kThreads, (size_t)smem,
                        (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
