// The row former (fhmcanalysis_torch/csrc/mb_rows.cuh) on the CPU, one
// bin per iteration, as the kernel runs one bin per thread.  Built with
// g++ -ffp-contract=off (the library's -fmad=false) by
// tests/test_torch_mb_rows.py, which holds it to pipeline._mb_rows bit
// for bit.
#include <string.h>

#include "mb_rows.cuh"

extern "C" int mb_rows_host_table_ints() { return (int)(sizeof(mbrows::Table) / sizeof(int)); }

extern "C" void mb_rows_host_run(const int* table, const double* mom, const double* op, const double* beta, const double* mu,
                                 double* xrows, double* krows, int N) {
  mbrows::Table t;
  memcpy(&t, table, sizeof t);
  for (int i = 0; i < N; ++i) mbrows::form_bin(t, mom, op, beta, mu, xrows, krows, N, i);
}
