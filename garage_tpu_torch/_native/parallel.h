// Shared thread-partitioning for the native hot paths.  One definition so
// gf8.cpp and blake3.cpp cannot drift, and so no exception ever crosses
// the ctypes FFI boundary (this code's contract is "degrades performance,
// never correctness" — thread-resource exhaustion falls back to serial).
#pragma once

#include <cstddef>
#include <thread>
#include <vector>

namespace garage_native {

// Split [0, n) into contiguous ranges across up to 8 threads and run
// fn(begin, end) on each.  `work_per_item` scales the serial-fallback
// threshold by how expensive one item is (bytes hashed, r*q table ops,
// ...): threads only spawn when each would get >= min_work work units.
template <typename F>
inline void parallel_ranges(size_t n, size_t work_per_item, size_t min_work,
                            F fn) {
    unsigned hw = std::thread::hardware_concurrency();
    size_t nthreads = hw ? hw : 1;
    if (nthreads > 8) nthreads = 8;
    size_t total = n * (work_per_item ? work_per_item : 1);
    if (nthreads > 1 && total / nthreads < min_work)
        nthreads = total / min_work ? total / min_work : 1;
    if (nthreads <= 1 || n < 2) {
        fn((size_t)0, n);
        return;
    }
    size_t step = (n + nthreads - 1) / nthreads;
    std::vector<std::thread> workers;
    size_t spawned_to = 0;
    try {
        for (size_t k = 0; k < nthreads; k++) {
            size_t b0 = k * step;
            size_t b1 = b0 + step < n ? b0 + step : n;
            if (b0 >= b1) break;
            workers.emplace_back([=, &fn] { fn(b0, b1); });
            spawned_to = b1;
        }
    } catch (...) {
        // std::thread construction failed (pids/thread limit): finish the
        // rest serially instead of letting the exception cross the FFI
        for (auto& w : workers) w.join();
        if (spawned_to < n) fn(spawned_to, n);
        return;
    }
    for (auto& w : workers) w.join();
}

}  // namespace garage_native
