// The layout probe's sixteen cases on Hopper (sm_90a). Replaces the Pallas
// kernels of scripts/probe_mosaic_casts.py:19 (`run`, one tiny one-block
// pallas_call per case, the kernels being the sixteen lambdas of `main`):
// squeeze, trailing and middle expand, broadcast_in_dim (0, 2) and (0, 1),
// 1-D to 3-D rows, reshape merge and split, concat on the minor and the
// middle axis, iota compare, minor slice, batched and outer dot, keepdims
// reduce and minor transpose. On the TPU each case asked whether Mosaic
// lowers that shape cast; here each one writes the same output as the JAX
// lambda, selected by a case index.
//
// Bound. A few kilobytes per case (x, y (B, N, N) f32 in, at most
// (B, N, 2N) out): a launch moves ~0.1 MB at B = 32, N = 24, so every case is
// bound by the launch, not by bytes or operations. Design: one thread per
// output element in a grid-stride loop; the two dots and the reduction sum
// their N terms in index order. The three pure copies (squeeze, reshape
// merge and split) and the minor-axis concat move a float4 a thread where
// N is a multiple of 4 and the pointers are 16-byte aligned (copy4_kernel):
// with a float a thread they read 0.2-0.5 us slower than PyTorch's own
// vectorized copy of the same bytes (H100 80GB HBM3, probes phase).

#include <cuda_runtime.h>

namespace {

enum {
  C_SQUEEZE = 0, C_EXPAND_TRAIL, C_EXPAND_MID, C_BCAST_02, C_BCAST_01,
  C_ROWS_1D, C_MERGE, C_SPLIT, C_CONCAT_MINOR, C_CONCAT_MID, C_IOTA_EQ,
  C_SLICE_MINOR, C_BATCHED_DOT, C_OUTER, C_REDUCE_MINOR, C_TRANSPOSE,
  C_COUNT
};

__global__ void layout_kernel(int which, const float* __restrict__ x,
                              const float* __restrict__ y,
                              float* __restrict__ out, int B, int N,
                              int total) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    float v = 0.0f;
    switch (which) {
      case C_SQUEEZE:        // (1, B, N) -> (B, N)
      case C_MERGE:          // (B, N, N) -> (B N, N)
      case C_SPLIT:          // (B, N, N) -> (B / 2, 2, N, N)
        v = x[e];
        break;
      case C_EXPAND_TRAIL:   // x[:, :, None] + 0: o[b, i, j] = x[b, i]
      case C_BCAST_01:
        v = x[e / N] + 0.0f;
        break;
      case C_EXPAND_MID: {   // x[:, None, :] + 0: o[b, i, j] = x[b, j]
        const int b = e / (N * N);
        v = x[b * N + e % N] + 0.0f;
        break;
      }
      case C_BCAST_02: {     // broadcast_in_dim (0, 2): o[b, i, j] = x[b, j]
        const int b = e / (N * N);
        v = x[b * N + e % N];
        break;
      }
      case C_ROWS_1D:        // x[:, None, None] + 0
        v = x[e / (N * N)] + 0.0f;
        break;
      case C_CONCAT_MINOR: { // (B, N, 2N)
        const int row = e / (2 * N);
        const int j = e % (2 * N);
        v = j < N ? x[row * N + j] : y[row * N + j - N];
        break;
      }
      case C_CONCAT_MID: {   // (B, 2N, N)
        const int b = e / (2 * N * N);
        const int r = e % (2 * N * N);
        v = r < N * N ? x[b * N * N + r] : y[b * N * N + r - N * N];
        break;
      }
      case C_IOTA_EQ: {      // x + (i == j)
        const int i = (e / N) % N;
        const int j = e % N;
        v = x[e] + (i == j ? 1.0f : 0.0f);
        break;
      }
      case C_SLICE_MINOR:    // x[:, :, :4]
        v = x[(e / 4) * N + e % 4];
        break;
      case C_BATCHED_DOT: {  // o[b, i, k] = sum_j x[b, i, j] y[b, j, k]
        const int b = e / (N * N);
        const int i = (e / N) % N;
        const int k = e % N;
        const float* xr = x + (b * N + i) * N;
        const float* yc = y + b * N * N + k;
        float acc = 0.0f;
        for (int j = 0; j < N; ++j) acc = fmaf(xr[j], yc[j * N], acc);
        v = acc;
        break;
      }
      case C_OUTER: {        // o[b, i, j] = x[b, i] y[b, j]
        const int b = e / (N * N);
        v = x[e / N] * y[b * N + e % N];
        break;
      }
      case C_REDUCE_MINOR: { // x - sum(x, axis=2, keepdims=True)
        const float* xr = x + (e / N) * N;
        float acc = 0.0f;
        for (int j = 0; j < N; ++j) acc += xr[j];
        v = x[e] - acc;
        break;
      }
      case C_TRANSPOSE: {    // swapaxes(x, 1, 2)
        const int b = e / (N * N);
        const int i = (e / N) % N;
        const int j = e % N;
        v = x[(b * N + j) * N + i];
        break;
      }
    }
    out[e] = v;
  }
}

// out = x (mode 0) or, for the minor-axis concat, out[row] = [x[row],
// y[row]] with n4 float4 per input row (mode 1); total4 float4 outputs.
__global__ void copy4_kernel(int mode, const float4* __restrict__ x,
                             const float4* __restrict__ y,
                             float4* __restrict__ out, int n4, int total4) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total4;
       e += gridDim.x * blockDim.x) {
    if (mode == 0) {
      out[e] = x[e];
    } else {
      const int row = e / (2 * n4);
      const int j = e - row * 2 * n4;
      out[e] = j < n4 ? x[row * n4 + j] : y[row * n4 + j - n4];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* vsm_layout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One case `which` on `stream`: x and y device pointers of the case's inputs
// (y unused by the one-input cases), out of `total` elements; returns
// cudaGetLastError() (0 on success).
int vsm_layout_case_f32(int which, const float* x, const float* y,
                        float* out, int B, int N, int total, void* stream) {
  if (which < 0 || which >= C_COUNT || B < 1 || N < 1 || total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool copy = which == C_SQUEEZE || which == C_MERGE ||
                    which == C_SPLIT || which == C_CONCAT_MINOR;
  const int threads = 256;
  if (total > 0 && copy && N % 4 == 0 && total % 4 == 0 && aligned16(x) &&
      aligned16(y) && aligned16(out)) {
    const int total4 = total / 4;
    int blocks = (total4 + threads - 1) / threads;
    if (blocks > 1024) blocks = 1024;
    copy4_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        which == C_CONCAT_MINOR ? 1 : 0, reinterpret_cast<const float4*>(x),
        reinterpret_cast<const float4*>(y), reinterpret_cast<float4*>(out),
        N / 4, total4);
  } else if (total > 0) {
    int blocks = (total + threads - 1) / threads;
    if (blocks > 1024) blocks = 1024;
    layout_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        which, x, y, out, B, N, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
