// One side of the four-step split N = N1 * N2 that csrc/dft_cluster.cu and
// csrc/dft_staged.cu run as batches of FFTs (dft_batched.cuh): its passes,
// one per radix of ops/dft.py::fft_plan, and where their roots lie. Plain
// C++, so that the host builds the plans with it (dft_cluster_plan.cuh).

#pragma once

constexpr int MAX_PASSES = 12;

struct Side {  // the batched FFTs of one side of the split
  int n, n_passes, tw_off;     // tw_off: the side's pass roots in shared memory
  int radix[MAX_PASSES];
  int ns[MAX_PASSES];          // product of the earlier radices
  int pass_off[MAX_PASSES];    // the pass's roots from tw_off
};
