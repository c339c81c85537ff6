/* matinv.h — C API of libmatinv_tpu.so, the product library.
 *
 * The reference ships Matlab/mat_inv_32.h:1-5 as the consumer-facing
 * contract of its MATLAB static library; this header is the equivalent for
 * C / C++ / Fortran / MATLAB-loadlibrary consumers. Plain C so MATLAB's
 * loadlibrary() header parser accepts it verbatim.
 *
 * Status convention (mirrors the reference's empty-vector contract,
 * mat_inv_32.cpp:206-215, :389-394):
 *   0  success — `out` holds the row-major result
 *   1  invalid input (n <= 0, null pointer) or singular matrix; `out`
 *      untouched (the reference returns an empty vector here)
 *  <0  internal error (embedded interpreter / backend failure)
 */
#ifndef MATINV_H
#define MATINV_H

#ifdef __cplusplus
extern "C" {
#endif

/* Optional eager initialization of the embedded Python/JAX runtime; the
 * first inversion initializes lazily otherwise. Returns 0 on success. */
int matinv_tpu_init(void);

/* FP32 inverse of a row-major n x n matrix (reference matrix_inv_32,
 * Matlab/mat_inv_32.h:4). Writes n*n floats to `out` on success. */
int matrix_inv_32(const float* data, int n, float* out);

/* FP64 inverse (reference matrix_inversion_FP64, headers.h:9). */
int matrix_inv_64(const double* data, int n, double* out);

/* Solve A x = b for k right-hand sides without forming the inverse:
 * A is row-major n x n, b is row-major n x k, `out` receives n x k. */
int matrix_solve_32(const float* a, const float* b, int n, int k,
                    float* out);

#ifdef __cplusplus
}
#endif

#endif /* MATINV_H */
