// Native real-time executor core for the asynchronous MPC actor loop: a
// copy of trajoptkp_tpu/mpc/native/executor.cpp, built by
// trajoptkp_tpu_torch/mpc/native_executor.py into the port's own build
// directory.
//
// The reference's real-time loop is a C++ thread with a sleep-compensated
// timer and a mutex-guarded control buffer (the reference's
// src/main.cpp:425-744).  This library provides the same runtime services,
// callable from Python via ctypes:
//
//   * ControlBuffer: a seqlock-style latest-plan buffer.  The planner
//     publishes whole plans (H x nu doubles + start index); the actor pops
//     the next control without ever blocking the publisher - no GIL, no
//     mutex convoy on the real-time path.
//   * rt_ticker: monotonic-clock absolute-deadline pacing (clock_nanosleep
//     TIMER_ABSTIME) - tighter than Python's time.sleep compensation loop.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o <lib>.so executor.cpp

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

extern "C" {

struct ControlBuffer {
    int horizon;
    int nu;
    std::atomic<uint64_t> seq;       // even = stable, odd = writing
    std::atomic<int> index;          // next control to apply
    std::vector<double> plan;        // horizon * nu
    std::atomic<uint64_t> plans_published;
    std::atomic<uint64_t> controls_consumed;
    std::atomic<uint64_t> underruns; // pops past the end of the plan
};

ControlBuffer* cb_create(int horizon, int nu) {
    auto* b = new ControlBuffer();
    b->horizon = horizon;
    b->nu = nu;
    b->seq.store(0);
    b->index.store(horizon);  // empty until first publish
    b->plan.assign((size_t)horizon * nu, 0.0);
    b->plans_published.store(0);
    b->controls_consumed.store(0);
    b->underruns.store(0);
    return b;
}

void cb_destroy(ControlBuffer* b) { delete b; }

// Planner side: publish a whole plan and the index to start applying from.
void cb_publish(ControlBuffer* b, const double* plan, int start_index) {
    uint64_t s = b->seq.load(std::memory_order_relaxed);
    b->seq.store(s + 1, std::memory_order_release);          // mark writing
    std::memcpy(b->plan.data(), plan,
                sizeof(double) * (size_t)b->horizon * b->nu);
    b->index.store(start_index, std::memory_order_relaxed);
    b->seq.store(s + 2, std::memory_order_release);          // stable again
    b->plans_published.fetch_add(1, std::memory_order_relaxed);
}

// Actor side: pop the next control into `out`.
// Returns 1 on success, 0 if the buffer is exhausted (caller falls back to
// gravity compensation, mirroring main.cpp:498-509).
int cb_next(ControlBuffer* b, double* out) {
    for (;;) {
        uint64_t s0 = b->seq.load(std::memory_order_acquire);
        if (s0 & 1) continue;  // writer active; spin (publish is rare+fast)
        int i = b->index.fetch_add(1, std::memory_order_relaxed);
        if (i >= b->horizon) {
            b->index.store(b->horizon, std::memory_order_relaxed);
            b->underruns.fetch_add(1, std::memory_order_relaxed);
            return 0;
        }
        std::memcpy(out, b->plan.data() + (size_t)i * b->nu,
                    sizeof(double) * b->nu);
        uint64_t s1 = b->seq.load(std::memory_order_acquire);
        if (s0 == s1) {
            b->controls_consumed.fetch_add(1, std::memory_order_relaxed);
            return 1;
        }
        // plan changed mid-read; retry with the fresh plan
    }
}

int cb_consumed_index(ControlBuffer* b) {
    return b->index.load(std::memory_order_relaxed);
}

uint64_t cb_stat(ControlBuffer* b, int which) {
    switch (which) {
        case 0: return b->plans_published.load();
        case 1: return b->controls_consumed.load();
        case 2: return b->underruns.load();
    }
    return 0;
}

// ---------------------------------------------------------------------
// Real-time ticker: absolute-deadline pacing on CLOCK_MONOTONIC.
// ---------------------------------------------------------------------

struct RtTicker {
    struct timespec next;
    long period_ns;
    uint64_t ticks;
    uint64_t overruns;
};

RtTicker* ticker_create(double period_s) {
    auto* t = new RtTicker();
    clock_gettime(CLOCK_MONOTONIC, &t->next);
    t->period_ns = (long)(period_s * 1e9);
    t->ticks = 0;
    t->overruns = 0;
    return t;
}

void ticker_destroy(RtTicker* t) { delete t; }

// Sleep until the next absolute deadline; returns lateness in seconds
// (0.0 when on time).  Deadlines advance by exactly one period per call,
// so timing error does not accumulate (unlike relative sleeps).
double ticker_wait(RtTicker* t) {
    t->next.tv_nsec += t->period_ns;
    while (t->next.tv_nsec >= 1000000000L) {
        t->next.tv_nsec -= 1000000000L;
        t->next.tv_sec += 1;
    }
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    double late = (now.tv_sec - t->next.tv_sec) +
                  (now.tv_nsec - t->next.tv_nsec) * 1e-9;
    t->ticks++;
    if (late > 0) {
        t->overruns++;
        // too slow: rebase deadlines to now so we don't burst
        t->next = now;
        return late;
    }
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &t->next, nullptr);
    return 0.0;
}

uint64_t ticker_overruns(RtTicker* t) { return t->overruns; }
uint64_t ticker_ticks(RtTicker* t) { return t->ticks; }

}  // extern "C"
