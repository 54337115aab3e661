// The series/continued-fraction incomplete gamma (common.cuh gammainc_sc)
// with the lower series' early exit against its fixed loop, lane by lane:
// the check that the exit leaves every result bit for bit as it was, on the
// card's own arithmetic, before a generated reference-tier kernel relies on
// it (ops/codegen.py `kSeriesExit`), and the two loops' times. Not part of
// the library: tools/reference_tune.py builds it as a unit of its own at
// first use (`series_unit`), both types in one unit.
//
// cloudy_series_check_{f32,f64}(a, x, fixed, exit, n, n_iters, which,
// stream): P(a[i], x[i]) at n_iters iterations, lgamma(a) by the Lanczos
// lgamma and log x after the clamp at 1e6, as the F2 grid takes them
// (coal_body.cuh f2_gamma_grid); `which` 0 writes the fixed loop's result to
// `fixed`, 1 the early exit's to `exit`, 2 both from one launch.
//
// No fast-math: division stays IEEE-accurate and denormals are kept.

#pragma once

#include "common.cuh"

namespace cloudy {

template <typename T>
__global__ void series_check_kernel(const T* __restrict__ a, const T* __restrict__ x,
                                    T* __restrict__ fixed, T* __restrict__ exit,
                                    long long n, int n_iters, int which) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T ai = a[i], xi = x[i];
  const T lga = lgamma_lanczos(ai);
  const T log_x = dlog(vmax(vmin(xi, T(1e6)), Lim<T>::tiny()));
  if (which != 1) fixed[i] = gammainc_sc<false>(ai, xi, n_iters, lga, log_x);
  if (which != 0) exit[i] = gammainc_sc<true>(ai, xi, n_iters, lga, log_x);
}

template <typename T>
int launch_series_check(const void* a, const void* x, void* fixed, void* exit,
                        long long n, int n_iters, int which, void* stream) {
  if (n <= 0 || which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  constexpr int threads = 256;
  series_check_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const T*)a, (const T*)x, (T*)fixed, (T*)exit, n, n_iters, which);
  return (int)cudaGetLastError();
}

}  // namespace cloudy

extern "C" {

int cloudy_series_check_f32(const void* a, const void* x, void* fixed, void* exit,
                            long long n, int n_iters, int which, void* stream) {
  return cloudy::launch_series_check<float>(a, x, fixed, exit, n, n_iters, which, stream);
}

int cloudy_series_check_f64(const void* a, const void* x, void* fixed, void* exit,
                            long long n, int n_iters, int which, void* stream) {
  return cloudy::launch_series_check<double>(a, x, fixed, exit, n, n_iters, which, stream);
}

}  // extern "C"
