// xla_order.cuh — XLA's CPU summation order for rows of more than 32 x 32
// terms, shared by the kernels whose sums follow the reference's bits
// (kernels/ops.py::sum_sq_win32).
//
// Windows of 32 over the row padded by (32 W - n) / 2 zeros in front, each
// window summed in index order; the W window sums are summed the same way
// in turn, level by level, until at most 32 remain, which are added in
// order.  The terms stream in index order: a level's element that closes
// its window passes the window's sum up one level.  Every add is
// __fadd_rn, which nvcc never contracts.

#pragma once

constexpr int kTreeLevels = 7;  // 32^7 > 2^31: enough for any int width

// sum over j < d of term(j) in XLA's tree order
template <typename Term>
__device__ float tree_sum(Term term, int d) {
  int len[kTreeLevels], pad[kTreeLevels], next[kTreeLevels];
  float acc[kTreeLevels];
  int top = 0;
  len[0] = d;
  while (len[top] > 32) {
    const int w = (len[top] + 31) / 32;
    pad[top] = (32 * w - len[top]) / 2;
    len[++top] = w;
  }
  for (int l = 0; l <= top; ++l) next[l] = 0, acc[l] = 0.f;
  for (int j = 0; j < d; ++j) {
    float v = term(j);
    for (int l = 0;; ++l) {
      const int i = next[l]++;
      if (l == top) {
        acc[l] = i == 0 ? v : __fadd_rn(acc[l], v);
        break;
      }
      const bool first = i == 0 || (i + pad[l]) % 32 == 0;
      acc[l] = first ? v : __fadd_rn(acc[l], v);
      if (i != len[l] - 1 && (i + pad[l]) % 32 != 31) break;
      v = acc[l];
    }
  }
  return acc[top];
}
