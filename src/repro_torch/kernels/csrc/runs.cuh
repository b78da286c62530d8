// The sorted-run scatter-add pass of the reverse megasteps, shared by
// treelstm_bwd_megastep.cu and cell_bwd_megastep.cu (Hopper, sm_90a).
//
// Each destination row of a level's child-row cotangents is one run of the
// level's sorted child ids (sort_perm / sorted_child_ids / run_head,
// precomputed on the host by pack_batch).  One block per sorted position:
// the block at the head of a run seeds from g, adds the run's
// contributions in sorted order and writes the row once.  No float
// atomics, so two runs of the same backward give the same bits.  The
// sentinel run (absent children) is skipped, so the sentinel row is left
// as it came in.
//
// Contribution j is row sort_perm[j] / row_div of `contrib` (rows of S
// floats): row_div = 1 where each child has its own cotangent row
// (treelstm, treefc), A where every child of a slot receives the slot's
// one row (lstm, gru: the reference broadcasts the predecessor's
// cotangent over the slot's existing children).

#pragma once

#include <cuda_runtime.h>

namespace runs {

constexpr int NT_RUN = 256;               // threads of a scatter_runs block

__global__ void __launch_bounds__(NT_RUN)
scatter_runs_kernel(float* __restrict__ g, int g_stride,
                    const float* __restrict__ contrib,
                    const int* __restrict__ sort_perm,
                    const int* __restrict__ sorted_child_ids,
                    const int* __restrict__ run_head,
                    int n, int S, int row_div, int sentinel) {
  const int i = blockIdx.x;
  if (run_head[i] == 0) return;
  const int dest = sorted_child_ids[i];
  if (dest == sentinel) return;
  int end = i + 1;
  while (end < n && run_head[end] == 0) ++end;
  float* out = g + (size_t)dest * g_stride;
  for (int col = threadIdx.x; col < S; col += NT_RUN) {
    float acc = out[col];
    for (int j = i; j < end; ++j)
      acc += contrib[(size_t)(sort_perm[j] / row_div) * S + col];
    out[col] = acc;
  }
}

// Launches the pass over the n = M*A sorted positions of one level.
inline cudaError_t scatter_runs(float* g, int g_stride, const float* contrib,
                                const int* sort_perm,
                                const int* sorted_child_ids,
                                const int* run_head, int n, int S,
                                int row_div, int sentinel,
                                cudaStream_t stream) {
  scatter_runs_kernel<<<n, NT_RUN, 0, stream>>>(
      g, g_stride, contrib, sort_perm, sorted_child_ids, run_head, n, S,
      row_div, sentinel);
  return cudaGetLastError();
}

}  // namespace runs
