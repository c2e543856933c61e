// Layered normalized min-sum LDPC decoder for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA foreign function interface.
//
// One thread block decodes one codeblock; thread t owns lifting index t of
// every check row.  The a-posteriori LLRs of the decoded columns live in
// shared memory for all iterations (38 columns x Z=384 x 4 B = 58 KB at the
// 100 MHz LBRM flagship), and a circulant shift is a rotated shared-memory
// index: thread t reads column c at (t + shift) mod Z.  The check-to-variable
// messages are kept as the compressed min-sum state of each check row
// (scaled min1, scaled min2, argmin edge, per-edge sign bits) in a global
// scratch buffer that stays in L2; each thread prefetches the next layer's
// state before the layer barrier.
//
// Arithmetic is the plain XLA decoder's (ops/ldpc/decoder.py) operation for
// operation -- f32 state, input clamp +-64, scaling 0.8f, same min/second-min
// tie rule -- with explicit round-to-nearest intrinsics so that no multiply
// and add is contracted into an FMA.  Without early stop the hard bits are
// identical to the plain decoder's.
//
// Early stop: each layer accumulates the parity of the hard decisions that
// enter it; an iteration in which every check of the block was satisfied
// ends the decode for that codeblock (per block, no cross-block reduction).

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxEdges = 320;   // BG1 has 316 edges, BG2 197
constexpr int kMaxLayers = 46;   // BG1 check rows
constexpr int kMaxDegree = 19;   // BG1 row 0..3 degree
constexpr float kScaling = 0.8f;
constexpr float kInputClamp = 64.0f;

// The (truncated) lifted graph, passed by value in the kernel's parameter
// space: every thread reads the same entry at the same time (broadcast).
struct Graph {
  int16_t col[kMaxEdges];
  int16_t shift[kMaxEdges];
  int16_t row_start[kMaxLayers + 1];
};

__device__ __forceinline__ float clamp_llr(float x) {
  return fminf(fmaxf(x, -kInputClamp), kInputClamp);
}

__global__ void ldpc_layered_min_sum(const int8_t* __restrict__ llr,
                                     uint8_t* __restrict__ bits,
                                     int32_t* __restrict__ iters_out,
                                     float* __restrict__ state, const Graph g,
                                     int z, int kb, int nof_layers, int ncols,
                                     int in_width, int in_used,
                                     int nof_iterations, int early_stop) {
  extern __shared__ float app[];  // ncols * z
  const int cb = blockIdx.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const bool active = t < z;

  // Channel LLRs: two punctured columns (0), then the circular buffer.
  const int8_t* in = llr + static_cast<int64_t>(cb) * in_width;
  for (int i = t; i < ncols * z; i += nthreads) {
    const int j = i - 2 * z;
    float v = 0.0f;
    if (j >= 0 && j < in_used) v = clamp_llr(static_cast<float>(in[j]));
    app[i] = v;
  }

  // Compressed message state of row (layer, t): scaled min1, scaled min2,
  // and (argmin << 24 | message sign bits).  All zero = no message yet.
  float* st = state + static_cast<int64_t>(cb) * nof_layers * 3 * z;
  if (active) {
    for (int l = 0; l < nof_layers; ++l) {
      st[(l * 3 + 0) * z + t] = 0.0f;
      st[(l * 3 + 1) * z + t] = 0.0f;
      st[(l * 3 + 2) * z + t] = 0.0f;
    }
  }
  __syncthreads();

  float s1 = 0.0f, s2 = 0.0f;
  uint32_t meta = 0u;
  int it = 0;
  while (it < nof_iterations) {
    int odd = 0;  // some check entering a layer had odd parity
    for (int l = 0; l < nof_layers; ++l) {
      // Prefetch the next layer's state (written by this same thread).
      const int ln = (l + 1 == nof_layers) ? 0 : l + 1;
      float n1 = 0.0f, n2 = 0.0f;
      uint32_t nmeta = 0u;
      if (active) {
        const int e0 = g.row_start[l];
        const int deg = g.row_start[l + 1] - e0;
        const int old_amin = static_cast<int>(meta >> 24);
        // Pass 1: variable-to-check messages, their minima and signs.
        float m1 = INFINITY, m2 = INFINITY;
        int amin = 0;
        uint32_t negmask = 0u;
        int hard_par = 0;
        for (int e = 0; e < deg; ++e) {
          int pos = t + g.shift[e0 + e];
          if (pos >= z) pos -= z;
          const float a = app[g.col[e0 + e] * z + pos];
          const float mag = (e == old_amin) ? s2 : s1;
          const float r_old = ((meta >> e) & 1u) ? -mag : mag;
          const float v = __fsub_rn(a, r_old);
          hard_par ^= (a < 0.0f);
          const uint32_t neg = v < 0.0f;
          negmask |= neg << e;
          const float av = fabsf(v);
          if (av < m1) {
            m2 = m1;
            m1 = av;
            amin = e;
          } else if (av < m2) {
            m2 = av;
          }
        }
        if (deg < 2) m2 = m1;
        const uint32_t parity = __popc(negmask) & 1u;
        const float ns1 = __fmul_rn(kScaling, m1);
        const float ns2 = __fmul_rn(kScaling, m2);
        const uint32_t rsign =
            parity ? (negmask ^ ((1u << deg) - 1u)) : negmask;
        // Pass 2: new messages and a-posteriori update.
        for (int e = 0; e < deg; ++e) {
          int pos = t + g.shift[e0 + e];
          if (pos >= z) pos -= z;
          const int idx = g.col[e0 + e] * z + pos;
          const float a = app[idx];
          const float mag = (e == old_amin) ? s2 : s1;
          const float r_old = ((meta >> e) & 1u) ? -mag : mag;
          const float v = __fsub_rn(a, r_old);
          const float nmag = (e == amin) ? ns2 : ns1;
          const float r_new = ((rsign >> e) & 1u) ? -nmag : nmag;
          app[idx] = __fadd_rn(v, r_new);
        }
        st[(l * 3 + 0) * z + t] = ns1;
        st[(l * 3 + 1) * z + t] = ns2;
        st[(l * 3 + 2) * z + t] =
            __uint_as_float((static_cast<uint32_t>(amin) << 24) | rsign);
        odd |= hard_par;
        n1 = st[(ln * 3 + 0) * z + t];
        n2 = st[(ln * 3 + 1) * z + t];
        nmeta = __float_as_uint(st[(ln * 3 + 2) * z + t]);
      }
      s1 = n1;
      s2 = n2;
      meta = nmeta;
      __syncthreads();
    }
    ++it;
    if (early_stop) {
      if (!__syncthreads_or(odd)) break;
    }
  }

  uint8_t* out = bits + static_cast<int64_t>(cb) * kb * z;
  for (int i = t; i < kb * z; i += nthreads) out[i] = app[i] < 0.0f;
  if (t == 0) iters_out[cb] = it;
}

ffi::Error LdpcDecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> llr,
                          ffi::ResultBuffer<ffi::U8> bits,
                          ffi::ResultBuffer<ffi::S32> iters,
                          ffi::ResultBuffer<ffi::F32> state,
                          ffi::Span<const int32_t> row_start,
                          ffi::Span<const int32_t> edge_col,
                          ffi::Span<const int32_t> edge_shift, int32_t z,
                          int32_t kb, int32_t ncols, int32_t nof_iterations,
                          int32_t early_stop) {
  const auto dims = llr.dimensions();
  if (dims.size() < 1) return ffi::Error::InvalidArgument("llr must be >= 1-D");
  const int64_t in_width = dims.back();
  int64_t nof_cbs = 1;
  for (size_t i = 0; i + 1 < dims.size(); ++i) nof_cbs *= dims[i];
  const int nof_layers = static_cast<int>(row_start.size()) - 1;
  if (nof_layers < 1 || nof_layers > kMaxLayers ||
      static_cast<int>(edge_col.size()) > kMaxEdges ||
      edge_col.size() != edge_shift.size()) {
    return ffi::Error::InvalidArgument("graph exceeds the kernel's limits");
  }
  Graph g = {};
  for (size_t i = 0; i < edge_col.size(); ++i) {
    g.col[i] = static_cast<int16_t>(edge_col[i]);
    g.shift[i] = static_cast<int16_t>(edge_shift[i]);
  }
  for (int l = 0; l <= nof_layers; ++l) {
    g.row_start[l] = static_cast<int16_t>(row_start[l]);
    if (l > 0 && row_start[l] - row_start[l - 1] > kMaxDegree) {
      return ffi::Error::InvalidArgument("row degree exceeds the kernel's limit");
    }
  }
  if (nof_cbs == 0) return ffi::Error::Success();
  const int in_used =
      static_cast<int>(in_width < (ncols - 2) * z ? in_width : (ncols - 2) * z);
  const int threads = ((z + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(ncols) * z * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_layered_min_sum, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  ldpc_layered_min_sum<<<static_cast<unsigned>(nof_cbs), threads, smem,
                         stream>>>(
      llr.typed_data(), bits->typed_data(), iters->typed_data(),
      state->typed_data(), g, z, kb, nof_layers, ncols,
      static_cast<int>(in_width), in_used, nof_iterations, early_stop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SrsranLdpcDecode, LdpcDecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<ffi::Span<const int32_t>>("row_start")
                                  .Attr<ffi::Span<const int32_t>>("edge_col")
                                  .Attr<ffi::Span<const int32_t>>("edge_shift")
                                  .Attr<int32_t>("z")
                                  .Attr<int32_t>("kb")
                                  .Attr<int32_t>("ncols")
                                  .Attr<int32_t>("nof_iterations")
                                  .Attr<int32_t>("early_stop"));
