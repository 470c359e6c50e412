// Native CPU benchmark/QA CLI for nbody_tpu_torch (a copy of nbody_tpu's).
//
// The reference's --cpu mode is a fully native C++ path
// (the reference's src/nbody/compute_cpu.cpp, bodysystemcpu.cpp — behavior
// re-derived); this is its counterpart in this framework: a standalone
// binary driving the same oracle engine (nbody_oracle.cpp), with the
// reference's benchmark output format and metric formulas
// (interactions/s = N^2 * freq * 1e-9; GFLOP/s at 20 fp32 / 30 fp64 flops,
// the reference's src/nbody/compute.cpp:105-121).
//
// Flags: --benchmark --numbodies N -i K --fp64 --compare --seed S
//        --integrator euler|leapfrog|hermite
// --compare runs one dt=0.001 fp32 step against the fp64 engine from the
// same state (with the chosen integrator) and applies the 5e-4 position
// criterion.
//
// Build: python -m nbody_tpu_torch.oracle.build (produces build/nbody_tpu_torch/nbody_cli_<hash>).

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

extern "C" {
void nbody_step_f32(float*, float*, std::int64_t, float, float, float);
void nbody_step_f64(double*, double*, std::int64_t, double, double, double);
void nbody_step_leapfrog_f32(float*, float*, std::int64_t, float, float, float);
void nbody_step_leapfrog_f64(double*, double*, std::int64_t, double, double, double);
void nbody_step_hermite_f32(float*, float*, std::int64_t, float, float, float);
void nbody_step_hermite_f64(double*, double*, std::int64_t, double, double, double);
int nbody_oracle_num_threads();
}

namespace {

// shell-configuration initial conditions (same geometry as nbody_tpu_torch.ic:
// uniform sphere direction, per-coordinate radius in [2.5, 4]*scale,
// tangential velocity = cross(pos, z-hat) * vscale)
template <typename T>
void shell_init(std::vector<T>& pos, std::vector<T>& vel, std::int64_t n,
                T cluster_scale, T velocity_scale, unsigned seed) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> u01(0.0, 1.0);
    std::uniform_real_distribution<double> u11(-1.0, 1.0);
    const double inner = 2.5 * cluster_scale;
    const double outer = 4.0 * cluster_scale;
    const double vscale = cluster_scale * velocity_scale;
    for (std::int64_t i = 0; i < n; ++i) {
        double x, y, z, r2;
        do {
            x = u11(rng); y = u11(rng); z = u11(rng);
            r2 = x * x + y * y + z * z;
        } while (r2 > 1.0 || r2 < 1e-12);
        const double inv = 1.0 / std::sqrt(r2);
        x *= inv; y *= inv; z *= inv;
        const double px = x * (inner + (outer - inner) * u01(rng));
        const double py = y * (inner + (outer - inner) * u01(rng));
        const double pz = z * (inner + (outer - inner) * u01(rng));
        pos[4 * i + 0] = static_cast<T>(px);
        pos[4 * i + 1] = static_cast<T>(py);
        pos[4 * i + 2] = static_cast<T>(pz);
        pos[4 * i + 3] = T{1};
        // cross(p, z-hat) = (py, -px, 0)
        vel[4 * i + 0] = static_cast<T>(py * vscale);
        vel[4 * i + 1] = static_cast<T>(-px * vscale);
        vel[4 * i + 2] = T{0};
        vel[4 * i + 3] = T{0};
    }
}

enum class Integrator { kEuler, kLeapfrog, kHermite };

template <typename T>
void step_dispatch(Integrator integ, T* pos, T* vel, std::int64_t n, T dt,
                   T softening, T damping) {
    if constexpr (sizeof(T) == 4) {
        auto* p = reinterpret_cast<float*>(pos);
        auto* v = reinterpret_cast<float*>(vel);
        switch (integ) {
            case Integrator::kEuler: nbody_step_f32(p, v, n, dt, softening, damping); break;
            case Integrator::kLeapfrog: nbody_step_leapfrog_f32(p, v, n, dt, softening, damping); break;
            case Integrator::kHermite: nbody_step_hermite_f32(p, v, n, dt, softening, damping); break;
        }
    } else {
        auto* p = reinterpret_cast<double*>(pos);
        auto* v = reinterpret_cast<double*>(vel);
        switch (integ) {
            case Integrator::kEuler: nbody_step_f64(p, v, n, dt, softening, damping); break;
            case Integrator::kLeapfrog: nbody_step_leapfrog_f64(p, v, n, dt, softening, damping); break;
            case Integrator::kHermite: nbody_step_hermite_f64(p, v, n, dt, softening, damping); break;
        }
    }
}

template <typename T>
double run_benchmark(std::int64_t n, int iters, T dt, T softening, T damping,
                     unsigned seed, Integrator integ) {
    std::vector<T> pos(4 * n), vel(4 * n);
    shell_init<T>(pos, vel, n, T{1.54}, T{8.0}, seed);

    auto step = [&]() {
        step_dispatch<T>(integ, pos.data(), vel.data(), n, dt, softening,
                         damping);
    };

    step();  // warm-up (untimed, like the reference)
    const auto t0 = std::chrono::steady_clock::now();
    for (int k = 0; k < iters; ++k) {
#if defined(__x86_64__)
        // cycles-per-interaction per step, like the reference CPU engine's
        // rdtsc print (the reference's src/nbody/bodysystemcpu.cpp:61-63,302)
        const auto c0 = __builtin_ia32_rdtsc();
        step();
        const auto c1 = __builtin_ia32_rdtsc();
        std::printf("%.3f cycles per interaction\n",
                    static_cast<double>(c1 - c0) /
                        (static_cast<double>(n) * static_cast<double>(n - 1)));
#else
        step();
#endif
    }
    const auto t1 = std::chrono::steady_clock::now();
    return std::chrono::duration<double, std::milli>(t1 - t0).count();
}

int run_compare(std::int64_t n, unsigned seed, Integrator integ) {
    std::vector<double> pos64(4 * n), vel64(4 * n);
    shell_init<double>(pos64, vel64, n, 1.54, 8.0, seed);
    std::vector<float> pos32(4 * n), vel32(4 * n);
    for (std::int64_t i = 0; i < 4 * n; ++i) {
        pos32[i] = static_cast<float>(pos64[i]);
        vel32[i] = static_cast<float>(vel64[i]);
    }
    step_dispatch<float>(integ, pos32.data(), vel32.data(), n, 0.001f, 0.1f, 1.0f);
    step_dispatch<double>(integ, pos64.data(), vel64.data(), n, 0.001, 0.1, 1.0);
    double max_err = 0;
    for (std::int64_t i = 0; i < n; ++i)
        for (int c = 0; c < 3; ++c)
            max_err = std::max(max_err,
                               std::abs(pos64[4 * i + c] - pos32[4 * i + c]));
    const bool ok = max_err <= 5e-4;
    std::printf("fp32 vs fp64 compare: max |dpos| = %.3e (tolerance 5e-4) -> %s\n",
                max_err, ok ? "OK" : "FAILED");
    return ok ? 0 : 1;
}

}  // namespace

int main(int argc, char** argv) {
    std::int64_t n = 4096;
    int iters = 10;
    bool fp64 = false, benchmark = false, compare = false;
    unsigned seed = 42;
    Integrator integ = Integrator::kEuler;

    for (int a = 1; a < argc; ++a) {
        const std::string arg = argv[a];
        auto next = [&]() -> const char* {
            if (a + 1 >= argc) { std::fprintf(stderr, "missing value for %s\n", arg.c_str()); std::exit(2); }
            return argv[++a];
        };
        if (arg == "--numbodies") n = std::atoll(next());
        else if (arg == "-i" || arg == "--iterations") iters = std::atoi(next());
        else if (arg == "--fp64") fp64 = true;
        else if (arg == "--benchmark") benchmark = true;
        else if (arg == "--compare" || arg == "--qatest") compare = true;
        else if (arg == "--seed") seed = static_cast<unsigned>(std::atoi(next()));
        else if (arg == "--integrator") {
            const std::string v = next();
            if (v == "euler") integ = Integrator::kEuler;
            else if (v == "leapfrog") integ = Integrator::kLeapfrog;
            else if (v == "hermite") integ = Integrator::kHermite;
            else { std::fprintf(stderr, "unknown integrator %s\n", v.c_str()); return 2; }
        }
        else if (arg == "--help" || arg == "-h") {
            std::printf("usage: nbody_cli [--benchmark] [--compare] [--numbodies N] "
                        "[-i K] [--fp64] [--seed S] "
                        "[--integrator euler|leapfrog|hermite]\n");
            return 0;
        } else {
            std::fprintf(stderr, "unknown flag %s\n", arg.c_str());
            return 2;
        }
    }
    if (n <= 0 || iters <= 0) { std::fprintf(stderr, "bad N or iterations\n"); return 2; }

    std::printf("nbody_cli: native CPU engine, %d OpenMP threads\n",
                nbody_oracle_num_threads());

    if (compare) return run_compare(n, seed, integ);

    if (benchmark) {
        const double ms = fp64
            ? run_benchmark<double>(n, iters, 0.016, 0.1, 1.0, seed, integ)
            : run_benchmark<float>(n, iters, 0.016f, 0.1f, 1.0f, seed, integ);
        const double freq = iters * 1000.0 / ms;
        const double inter = static_cast<double>(n) * n * 1e-9 * freq;
        const int flops = fp64 ? 30 : 20;
        std::printf("%lld bodies, total time for %d iterations: %.3f ms\n",
                    static_cast<long long>(n), iters, ms);
        std::printf("= %.3f billion interactions per second\n", inter);
        std::printf("= %.3f %s-precision GFLOP/s at %d flops per interaction\n",
                    inter * flops, fp64 ? "double" : "single", flops);
        return 0;
    }

    std::printf("nothing to do: pass --benchmark or --compare\n");
    return 0;
}
