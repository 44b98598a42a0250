// Gap-DP fill + traceback on an NVIDIA Hopper GPU, called from JAX through
// the XLA foreign function interface (target "sedef_gap_dp").
//
// Same recurrence and traceback as ops/wavefront.py (wavefront_np +
// backtrack_np, i.e. ksw2's extz2 difference recurrence with full band):
// one row per anti-diagonal r, lane t = target index i, query index
// j = r - t.  The CIGARs are bit-identical to the NumPy reference.
//
// Layout:
//  * one thread block per problem (a block loops over problems when the
//    batch has more problems than scratch slots);
//  * each thread owns K = 8 contiguous target lanes in registers; the t-1
//    neighbour crosses strip boundaries by __shfl_up_sync inside a warp and
//    through a double-buffered shared-memory slot between warps, with one
//    __syncthreads per diagonal;
//  * each diagonal computes only its in-band lanes [max(0, r-ql+1),
//    min(r, tl-1)] of the problem's true lengths, so padding to the size
//    class costs no cells;
//  * direction bytes go to the block's scratch slot, row r stored over the
//    8-aligned lane range [lo8(r), hi8(r)) so each thread writes its strip
//    with one 64-bit store;
//  * thread 0 then walks the traceback over its own block's rows (still in
//    L2) and emits the 2-bit packed op stream of wavefront_cigar_scan:
//    row r at byte r / 4, bits 2 * (r % 4): 0 = M, 1 = I, 2 = D, 3 = row
//    not consumed.
//
// Build: python -m sedef_tpu.native.build --cuda

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int K = 8;          // target lanes per thread
constexpr int WILD = 4;       // wildcard code: scores 0 against anything
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ int row_lo8(int r, int ql) {
  return max(0, r - ql + 1) & ~7;
}

__device__ __forceinline__ int row_width(int r, int ql, int tl) {
  return ((min(r, tl - 1) | 7) + 1) - row_lo8(r, ql);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
gap_dp_kernel(const int8_t* __restrict__ qseq, const int8_t* __restrict__ tgt,
              const int32_t* __restrict__ qlen,
              const int32_t* __restrict__ tlen, uint8_t* __restrict__ ops,
              uint8_t* __restrict__ scratch, int B, int S_q, int S_t,
              int n_pack, int64_t slot_bytes, int match, int mis, int gapo,
              int gape) {
  extern __shared__ int smem[];
  int* xslot = smem;                                 // [2][32]
  int* vslot = smem + 64;                            // [2][32]
  int8_t* sq = reinterpret_cast<int8_t*>(smem + 128);  // [S_q]

  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const bool multi_warp = blockDim.x > 32;
  const int t0 = tid * K;
  const int qe2 = 2 * (gapo + gape);
  const int max_sc = match + qe2;
  uint8_t* dir = scratch + static_cast<int64_t>(blockIdx.x) * slot_bytes;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int ql = qlen[b];
    const int tl = tlen[b];
    for (int k = tid; k < S_q; k += blockDim.x)
      sq[k] = qseq[static_cast<int64_t>(b) * S_q + k];
    uint8_t* out = ops + static_cast<int64_t>(b) * n_pack;
    for (int k = tid; k < n_pack; k += blockDim.x) out[k] = 0xFF;
    uint64_t tc = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      const uint64_t c = t < S_t
          ? static_cast<uint8_t>(tgt[static_cast<int64_t>(b) * S_t + t])
          : WILD;
      tc |= c << (8 * k);
    }
    int u[K], v[K], x[K], y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = v[k] = x[k] = y[k] = 0;
    __syncthreads();

    const int n_diag = ql + tl - 1;
    int64_t base = 0;
    for (int r = 0; r < n_diag; ++r) {
      const int lo = max(0, r - ql + 1);
      const int hi = min(r, tl - 1);
      const int lo8 = lo & ~7;
      // state of lane t0 - 1 after diagonal r - 1
      int xl = __shfl_up_sync(0xffffffffu, x[K - 1], 1);
      int vl = __shfl_up_sync(0xffffffffu, v[K - 1], 1);
      if (lane_id == 0 && warp > 0) {
        xl = xslot[(r & 1) * 32 + warp - 1];
        vl = vslot[(r & 1) * 32 + warp - 1];
      }
      const int bq = r > 0 ? gapo : 0;
      if (t0 + K - 1 >= lo && t0 <= hi) {
        uint64_t dbits = 0;
        // descending lanes: lane k reads lane k-1's previous-diagonal state
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
          const int t = t0 + k;
          int xs = k ? x[k > 0 ? k - 1 : 0] : xl;
          int vs = k ? v[k > 0 ? k - 1 : 0] : vl;
          if (t == 0) {
            xs = 0;
            vs = bq;
          }
          const bool inj = t == r;
          const int ub = inj ? bq : u[k];
          const int yb = inj ? 0 : y[k];
          const bool act = t >= lo && t <= hi;
          const int qc = act ? sq[r - t] : WILD;
          const int tk = static_cast<int>((tc >> (8 * k)) & 0xFF);
          const int sc = (qc >= WILD || tk >= WILD) ? 0
                                                    : (qc == tk ? match : mis);
          int z = sc + qe2;
          const int a = xs + vs;
          const int bb = yb + ub;
          int d = a > z ? 1 : 0;
          z = max(z, a);
          d = bb > z ? 2 : d;
          z = max(z, bb);
          z = min(z, max_sc);
          const int z2 = z - gapo;
          const int a2 = a - z2;
          const int b2 = bb - z2;
          d |= (a2 > 0 ? 8 : 0) | (b2 > 0 ? 16 : 0);
          if (act) {
            u[k] = z - vs;
            v[k] = z - ub;
            x[k] = max(a2, 0);
            y[k] = max(b2, 0);
          }
          dbits |= static_cast<uint64_t>(d) << (8 * k);
        }
        *reinterpret_cast<uint64_t*>(dir + base + (t0 - lo8)) = dbits;
      }
      if (multi_warp) {
        if (lane_id == 31) {
          xslot[((r + 1) & 1) * 32 + warp] = x[K - 1];
          vslot[((r + 1) & 1) * 32 + warp] = v[K - 1];
        }
        __syncthreads();
      } else {
        __syncwarp();
      }
      base += ((hi | 7) + 1) - lo8;
    }

    if (tid == 0) {
      int i = tl - 1, j = ql - 1, state = 0;
      int row = n_diag - 1;
      int64_t rbase = base - row_width(row, ql, tl);
      int cur_idx = -1;
      unsigned cur = 0xFF;
      while (i >= 0 && j >= 0) {
        const int r = i + j;
        while (row > r) {
          --row;
          rbase -= row_width(row, ql, tl);
        }
        const int tmp = dir[rbase + i - row_lo8(r, ql)];
        if (state == 0) {
          state = tmp & 7;
        } else if (!((tmp >> (state + 2)) & 1)) {
          state = 0;
        }
        if (state == 0) state = tmp & 7;
        int op;
        if (state == 0) {
          op = 0;
          --i;
          --j;
        } else if (state == 1 || state == 3) {
          op = 1;
          --i;
        } else {
          op = 2;
          --j;
        }
        const int bi = r >> 2;
        const int sh = (r & 3) * 2;
        if (bi != cur_idx) {
          if (cur_idx >= 0) out[cur_idx] = static_cast<uint8_t>(cur);
          cur_idx = bi;
          cur = 0xFF;
        }
        cur = (cur & ~(3u << sh)) | (static_cast<unsigned>(op) << sh);
      }
      if (cur_idx >= 0) out[cur_idx] = static_cast<uint8_t>(cur);
    }
    __syncthreads();
  }
}

ffi::Error GapDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> qseq,
                     ffi::Buffer<ffi::S8> tgt, ffi::Buffer<ffi::S32> qlen,
                     ffi::Buffer<ffi::S32> tlen,
                     ffi::ResultBuffer<ffi::U8> ops,
                     ffi::ResultBuffer<ffi::U8> scratch, int32_t match,
                     int32_t mis, int32_t gapo, int32_t gape) {
  const auto qd = qseq.dimensions();
  const auto td = tgt.dimensions();
  const auto od = ops->dimensions();
  const auto sd = scratch->dimensions();
  if (qd.size() != 2 || td.size() != 2 || od.size() != 2 || sd.size() != 2)
    return ffi::Error::InvalidArgument("sedef_gap_dp: rank-2 buffers expected");
  const int64_t B = qd[0], S_q = qd[1], S_t = td[1];
  if (td[0] != B || od[0] != B ||
      qlen.element_count() != static_cast<size_t>(B) ||
      tlen.element_count() != static_cast<size_t>(B))
    return ffi::Error::InvalidArgument("sedef_gap_dp: batch sizes differ");
  if (od[1] * 4 < S_q + S_t - 1)
    return ffi::Error::InvalidArgument("sedef_gap_dp: op buffer too short");
  if (sd[1] % 8 != 0 || sd[1] < S_q * S_t + 16 * (S_q + S_t))
    return ffi::Error::InvalidArgument("sedef_gap_dp: scratch slot too small");
  const int64_t threads = ((S_t + K - 1) / K + 31) / 32 * 32;
  if (threads > MAX_THREADS)
    return ffi::Error::InvalidArgument("sedef_gap_dp: S_t above 8192");
  if (B == 0) return ffi::Error::Success();
  const size_t smem = 128 * sizeof(int) + static_cast<size_t>(S_q);
  gap_dp_kernel<<<static_cast<unsigned>(sd[0]), static_cast<unsigned>(threads),
                  smem, stream>>>(
      qseq.typed_data(), tgt.typed_data(), qlen.typed_data(),
      tlen.typed_data(), ops->typed_data(), scratch->typed_data(),
      static_cast<int>(B), static_cast<int>(S_q), static_cast<int>(S_t),
      static_cast<int>(od[1]), sd[1], match, mis, gapo, gape);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sedef_gap_dp: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SedefGapDp, GapDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mis")
                                  .Attr<int32_t>("gapo")
                                  .Attr<int32_t>("gape"));
