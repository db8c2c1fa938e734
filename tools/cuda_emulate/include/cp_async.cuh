// cp_async.cuh for the CPU emulation (cuda_stub_core.h): each copy happens
// at once, so a group is complete as soon as it is committed.
#pragma once
#include <cstring>

inline void cp_async16_bytes(float* dst, const float* src, int bytes) {
  std::memset(dst, 0, 16);
  if (bytes > 0) std::memcpy(dst, src, (size_t)bytes);
}
inline void cp_async16(float* dst, const float* src, bool pred) { cp_async16_bytes(dst, src, pred ? 16 : 0); }
inline void cp_async4(float* dst, const float* src, bool pred) { *dst = pred ? *src : 0.f; }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
