// kernel-registry golden fixture: the launch entries of a fake ops/ module.
// Parsed by pinotlint only, never built.
#include <cuda_runtime.h>

// a host query: no stream, so not a launch entry
extern "C" int fx_plan(int n, int* blocks) {
  *blocks = n;
  return 0;
}

extern "C" int fx_registered(const void* x, long long n, void* stream) { return 0; }

extern "C" int fx_unwrapped(const void* x, long long n, void* stream) { return 0; }

extern "C" int fx_unregistered(const void* x, long long n, void* stream) { return 0; }

extern "C" int fx_dynamic_name(const void* x, long long n, void* stream) { return 0; }

extern "C" int fx_by_reference(const void* x, long long n, void* stream) { return 0; }

// line 22: VIOLATION launched-entry, no wrapper calls it (the finding cites its extern "C" line)
extern "C" int fx_dead(const void* x,
                       cudaStream_t s) {
  return 0;
}

// extern "C" int fx_commented(void* stream) { return 0; }
/* extern "C" int fx_block_commented(void* stream) { return 0; } */
extern "C" int fx_declared(void* stream);
