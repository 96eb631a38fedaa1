// Launchers whose prototypes the fixture's SIGNATURES disagree with.
#include <cuda_runtime.h>

extern "C" int counts_launch(const long long* rows, int L, long long n,
                             int* counts, void* stream) {
  return 0;
}

extern "C" int scatter_launch(const long long* rows, int L, int* out,
                              long long n, void* stream) {
  return 0;
}
