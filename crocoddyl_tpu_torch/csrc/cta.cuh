// CTA-level primitives shared by the kernels that keep their step inputs in
// a shared-memory double buffer (the rollouts through rollout_step.cuh, the
// Riccati passes through riccati_pass.cuh) and by the node kernel.
//
// A Cta gives tid() in [0, size()), sync() (a barrier of the whole CTA that
// also orders its memory accesses), any(p) (a barrier that returns whether
// p held on any thread), and for the 32 lanes of a warp, each of which
// calls them: wsync() (the warp's barrier) and shfl(x, src) (lane src's
// x).  A Pipe copies one element into shared memory (copy), closes a batch
// of copies (commit) and waits for this thread's copies and then for the
// whole CTA (wait).  The host
// builds of tests/test_torch_fused_scans.py and test_torch_fused_node.py
// bring their own Cta and Pipe on std::threads.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cuda_pipeline.h>

namespace croc {

struct BlockCta {
  __device__ int tid() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool any(bool p) const { return __syncthreads_or(p) != 0; }
  __device__ void wsync() const { __syncwarp(); }
  template <class S> __device__ S shfl(S x, int src) const {
    return __shfl_sync(0xffffffffu, x, src);
  }
};

// cp.async of one element into shared memory; wait drains this thread's
// copies and then meets the CTA at a barrier, so every thread's copies are
// visible and every thread is done with the buffer the next copies reuse.
struct AsyncPipe {
  template <class T> __device__ void copy(T* dst, const T* src) const {
    __pipeline_memcpy_async(dst, src, sizeof(T));
  }
  __device__ void commit() const { __pipeline_commit(); }
  __device__ void wait() const {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

}  // namespace croc
#endif  // __CUDACC__
