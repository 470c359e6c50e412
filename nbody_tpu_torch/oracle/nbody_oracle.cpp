// Native CPU N-body oracle engine for nbody_tpu_torch (a copy of nbody_tpu's).
//
// Plays the role of the reference's BodySystemCPU golden oracle
// (the reference's src/nbody/bodysystemcpu.cpp — behavior re-derived, not
// copied): all-pairs Plummer-softened gravity with 1/r^3 falloff, then the
// damped semi-implicit Euler update v=(v+a*dt)*damping; p+=v*dt.
//
// Layout at the C ABI is AoS (N,4): pos = [x,y,z,mass]*N, vel = [vx,vy,vz,w]*N,
// matching the framework's canonical state. Internally we transpose to SoA so
// the compiler can auto-vectorize the j-loop; the i-loop is OpenMP-parallel.
//
// Built at first use by nbody_tpu_torch/oracle/build.py (g++ -O3 -march=native -fopenmp)

#include <cmath>
#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

template <typename T>
void accel_impl(const T* pos, std::int64_t n, T softening, T* acc) {
    const T eps2 = softening * softening;

    // AoS -> SoA staging for vectorizable inner loops.
    std::vector<T> xs(n), ys(n), zs(n), ms(n);
    for (std::int64_t j = 0; j < n; ++j) {
        xs[j] = pos[4 * j + 0];
        ys[j] = pos[4 * j + 1];
        zs[j] = pos[4 * j + 2];
        ms[j] = pos[4 * j + 3];
    }

#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        const T xi = xs[i], yi = ys[i], zi = zs[i];
        T ax = 0, ay = 0, az = 0;
#pragma omp simd reduction(+ : ax, ay, az)
        for (std::int64_t j = 0; j < n; ++j) {
            const T dx = xs[j] - xi;
            const T dy = ys[j] - yi;
            const T dz = zs[j] - zi;
            const T r2 = dx * dx + dy * dy + dz * dz + eps2;
            const T d = std::sqrt(r2);
            const T s = ms[j] / (d * r2);  // m / r^3
            ax += dx * s;
            ay += dy * s;
            az += dz * s;
        }
        acc[3 * i + 0] = ax;
        acc[3 * i + 1] = ay;
        acc[3 * i + 2] = az;
    }
}

template <typename T>
void step_impl(T* pos, T* vel, std::int64_t n, T dt, T softening, T damping) {
    std::vector<T> acc(3 * n);
    accel_impl(pos, n, softening, acc.data());
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        for (int c = 0; c < 3; ++c) {
            const T v = (vel[4 * i + c] + acc[3 * i + c] * dt) * damping;
            vel[4 * i + c] = v;
            pos[4 * i + c] += v * dt;
        }
    }
}

// (acc, jerk) for the Hermite scheme: jerk_i = sum_j m_j (dv/r^3
// - 3 (dx.dv) dx / r^5) — the time derivative of the softened force,
// same formula as the device kernels and the NumPy oracle
// (the reference has no Hermite path; its CPU engine is Euler-only,
// the reference's src/nbody/bodysystemcpu.cpp:244-299).
template <typename T>
void accel_jerk_impl(const T* pos, const T* vel, std::int64_t n, T softening,
                     T* acc, T* jerk) {
    const T eps2 = softening * softening;

    std::vector<T> xs(n), ys(n), zs(n), ms(n), us(n), vs(n), ws(n);
    for (std::int64_t j = 0; j < n; ++j) {
        xs[j] = pos[4 * j + 0];
        ys[j] = pos[4 * j + 1];
        zs[j] = pos[4 * j + 2];
        ms[j] = pos[4 * j + 3];
        us[j] = vel[4 * j + 0];
        vs[j] = vel[4 * j + 1];
        ws[j] = vel[4 * j + 2];
    }

#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        const T xi = xs[i], yi = ys[i], zi = zs[i];
        const T ui = us[i], vi = vs[i], wi = ws[i];
        T ax = 0, ay = 0, az = 0, jx = 0, jy = 0, jz = 0;
#pragma omp simd reduction(+ : ax, ay, az, jx, jy, jz)
        for (std::int64_t j = 0; j < n; ++j) {
            const T dx = xs[j] - xi;
            const T dy = ys[j] - yi;
            const T dz = zs[j] - zi;
            const T du = us[j] - ui;
            const T dv = vs[j] - vi;
            const T dw = ws[j] - wi;
            const T r2 = dx * dx + dy * dy + dz * dz + eps2;
            const T d = std::sqrt(r2);
            const T s = ms[j] / (d * r2);  // m / r^3
            const T q = T{3} * s * (dx * du + dy * dv + dz * dw) / r2;
            ax += dx * s;
            ay += dy * s;
            az += dz * s;
            jx += du * s - q * dx;
            jy += dv * s - q * dy;
            jz += dw * s - q * dz;
        }
        acc[3 * i + 0] = ax;
        acc[3 * i + 1] = ay;
        acc[3 * i + 2] = az;
        jerk[3 * i + 0] = jx;
        jerk[3 * i + 1] = jy;
        jerk[3 * i + 2] = jz;
    }
}

// Symplectic DKD leapfrog: drift dt/2, kick with the mid-point force,
// drift dt/2 — the framework's 2nd-order integrator (mirrors
// ops.reference.nbody_step_leapfrog / oracle.numpy_oracle).
template <typename T>
void step_leapfrog_impl(T* pos, T* vel, std::int64_t n, T dt, T softening,
                        T damping) {
    const T half = dt / 2;
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i)
        for (int c = 0; c < 3; ++c)
            pos[4 * i + c] += vel[4 * i + c] * half;
    std::vector<T> acc(3 * n);
    accel_impl(pos, n, softening, acc.data());
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        for (int c = 0; c < 3; ++c) {
            const T v = (vel[4 * i + c] + acc[3 * i + c] * dt) * damping;
            vel[4 * i + c] = v;
            pos[4 * i + c] += v * half;
        }
    }
}

// 4th-order Hermite P(EC): predict with (a0, j0), re-evaluate at the
// prediction, correct (mirrors ops.reference.nbody_step_hermite /
// oracle.numpy_oracle.step_numpy_hermite).
template <typename T>
void step_hermite_impl(T* pos, T* vel, std::int64_t n, T dt, T softening,
                       T damping) {
    std::vector<T> a0(3 * n), j0(3 * n), a1(3 * n), j1(3 * n);
    std::vector<T> pp(4 * n), vp(4 * n);
    accel_jerk_impl(pos, vel, n, softening, a0.data(), j0.data());
    const T dt2 = dt * dt;
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        for (int c = 0; c < 3; ++c) {
            pp[4 * i + c] = pos[4 * i + c] + vel[4 * i + c] * dt +
                            a0[3 * i + c] * (dt2 / 2) +
                            j0[3 * i + c] * (dt2 * dt / 6);
            vp[4 * i + c] = vel[4 * i + c] + a0[3 * i + c] * dt +
                            j0[3 * i + c] * (dt2 / 2);
        }
        pp[4 * i + 3] = pos[4 * i + 3];
        vp[4 * i + 3] = vel[4 * i + 3];
    }
    accel_jerk_impl(pp.data(), vp.data(), n, softening, a1.data(), j1.data());
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        for (int c = 0; c < 3; ++c) {
            const T v0 = vel[4 * i + c];
            const T v1 = (v0 +
                          (dt / 2) * (a0[3 * i + c] + a1[3 * i + c]) +
                          (dt2 / 12) * (j0[3 * i + c] - j1[3 * i + c])) *
                         damping;
            pos[4 * i + c] += (dt / 2) * (v0 + v1) +
                              (dt2 / 12) * (a0[3 * i + c] - a1[3 * i + c]);
            vel[4 * i + c] = v1;
        }
    }
}

}  // namespace

extern "C" {

void nbody_accel_f32(const float* pos, std::int64_t n, float softening, float* acc) {
    accel_impl<float>(pos, n, softening, acc);
}

void nbody_accel_f64(const double* pos, std::int64_t n, double softening, double* acc) {
    accel_impl<double>(pos, n, softening, acc);
}

void nbody_step_f32(float* pos, float* vel, std::int64_t n, float dt, float softening, float damping) {
    step_impl<float>(pos, vel, n, dt, softening, damping);
}

void nbody_step_f64(double* pos, double* vel, std::int64_t n, double dt, double softening, double damping) {
    step_impl<double>(pos, vel, n, dt, softening, damping);
}

void nbody_accel_jerk_f32(const float* pos, const float* vel, std::int64_t n, float softening, float* acc, float* jerk) {
    accel_jerk_impl<float>(pos, vel, n, softening, acc, jerk);
}

void nbody_accel_jerk_f64(const double* pos, const double* vel, std::int64_t n, double softening, double* acc, double* jerk) {
    accel_jerk_impl<double>(pos, vel, n, softening, acc, jerk);
}

void nbody_step_leapfrog_f32(float* pos, float* vel, std::int64_t n, float dt, float softening, float damping) {
    step_leapfrog_impl<float>(pos, vel, n, dt, softening, damping);
}

void nbody_step_leapfrog_f64(double* pos, double* vel, std::int64_t n, double dt, double softening, double damping) {
    step_leapfrog_impl<double>(pos, vel, n, dt, softening, damping);
}

void nbody_step_hermite_f32(float* pos, float* vel, std::int64_t n, float dt, float softening, float damping) {
    step_hermite_impl<float>(pos, vel, n, dt, softening, damping);
}

void nbody_step_hermite_f64(double* pos, double* vel, std::int64_t n, double dt, double softening, double damping) {
    step_hermite_impl<double>(pos, vel, n, dt, softening, damping);
}

// Multi-step entry points so benchmark loops don't pay per-step FFI overhead.
void nbody_rollout_f32(float* pos, float* vel, std::int64_t n, float dt, float softening, float damping, std::int64_t steps) {
    for (std::int64_t s = 0; s < steps; ++s) nbody_step_f32(pos, vel, n, dt, softening, damping);
}

void nbody_rollout_f64(double* pos, double* vel, std::int64_t n, double dt, double softening, double damping, std::int64_t steps) {
    for (std::int64_t s = 0; s < steps; ++s) nbody_step_f64(pos, vel, n, dt, softening, damping);
}

void nbody_rollout_leapfrog_f32(float* pos, float* vel, std::int64_t n, float dt, float softening, float damping, std::int64_t steps) {
    for (std::int64_t s = 0; s < steps; ++s) nbody_step_leapfrog_f32(pos, vel, n, dt, softening, damping);
}

void nbody_rollout_leapfrog_f64(double* pos, double* vel, std::int64_t n, double dt, double softening, double damping, std::int64_t steps) {
    for (std::int64_t s = 0; s < steps; ++s) nbody_step_leapfrog_f64(pos, vel, n, dt, softening, damping);
}

void nbody_rollout_hermite_f32(float* pos, float* vel, std::int64_t n, float dt, float softening, float damping, std::int64_t steps) {
    for (std::int64_t s = 0; s < steps; ++s) nbody_step_hermite_f32(pos, vel, n, dt, softening, damping);
}

void nbody_rollout_hermite_f64(double* pos, double* vel, std::int64_t n, double dt, double softening, double damping, std::int64_t steps) {
    for (std::int64_t s = 0; s < steps; ++s) nbody_step_hermite_f64(pos, vel, n, dt, softening, damping);
}

int nbody_oracle_num_threads() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
