// Launchers whose prototypes the fixture's SIGNATURES match.
#include <cuda_runtime.h>

extern "C" int counts_launch(const long long* rows, int L, long long n,
                             int* counts, void* stream) {
  return 0;
}

extern "C" int scale_launch(const long long* rows, int L, float recip,
                            void* stream) {
  return 0;
}
