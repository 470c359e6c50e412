// Native tipsy galaxy-file loader for nbody_tpu_torch (a copy of nbody_tpu's).
//
// The reference's data loader is native C++ (the reference's src/nbody/
// tipsy.cpp — format re-derived, see nbody_tpu_torch/io/tipsy.py for the record
// layouts); this is the fast path for large files, exposed via ctypes with
// the NumPy reader as fallback/cross-check.
//
// Protocol: nbody_tipsy_count(path) -> padded body count (multiple of 256)
// or -1 on error; nbody_tipsy_read(path, pos, vel) fills caller-allocated
// AoS float64 buffers of shape (count, 4): pos = [x,y,z,mass],
// vel = [vx,vy,vz,eps]; padding bodies are zero-mass.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

#pragma pack(push, 4)
struct DarkParticle {  // 36 bytes
    float mass;
    float pos[3];
    float vel[3];
    float eps;
    std::int32_t phi;
};

struct StarParticle {  // 44 bytes
    float mass;
    float pos[3];
    float vel[3];
    float metals;
    float tform;
    float eps;
    std::int32_t phi;
};
#pragma pack(pop)

constexpr std::int64_t kPad = 256;
constexpr std::size_t kHeaderBytes = 32;  // Dump struct padded to 32

struct Header {
    double time;
    std::int32_t nbodies, ndim, nsph, ndark, nstar;
};

bool read_header(std::FILE* f, Header& h) {
    unsigned char raw[kHeaderBytes];
    if (std::fread(raw, 1, kHeaderBytes, f) != kHeaderBytes) return false;
    std::memcpy(&h.time, raw, 8);
    std::memcpy(&h.nbodies, raw + 8, 4);
    std::memcpy(&h.ndim, raw + 12, 4);
    std::memcpy(&h.nsph, raw + 16, 4);
    std::memcpy(&h.ndark, raw + 20, 4);
    std::memcpy(&h.nstar, raw + 24, 4);
    return true;
}

}  // namespace

extern "C" {

std::int64_t nbody_tipsy_count(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    Header h{};
    const bool ok = read_header(f, h);
    std::fclose(f);
    if (!ok || h.nbodies < 0 || h.ndark < 0 || h.ndark > h.nbodies) return -1;
    return ((h.nbodies + kPad - 1) / kPad) * kPad;
}

int nbody_tipsy_read(const char* path, double* pos, double* vel) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    Header h{};
    if (!read_header(f, h) || h.nbodies < 0 || h.ndark < 0 || h.ndark > h.nbodies) {
        std::fclose(f);
        return 2;
    }
    const std::int64_t n_total = h.nbodies;
    const std::int64_t n_dark = h.ndark;
    const std::int64_t n_padded = ((n_total + kPad - 1) / kPad) * kPad;

    std::vector<DarkParticle> dark(n_dark);
    if (n_dark && std::fread(dark.data(), sizeof(DarkParticle), n_dark, f)
                      != static_cast<std::size_t>(n_dark)) {
        std::fclose(f);
        return 3;
    }
    const std::int64_t n_star = n_total - n_dark;
    std::vector<StarParticle> star(n_star);
    if (n_star && std::fread(star.data(), sizeof(StarParticle), n_star, f)
                      != static_cast<std::size_t>(n_star)) {
        std::fclose(f);
        return 3;
    }
    std::fclose(f);

    std::memset(pos, 0, sizeof(double) * 4 * n_padded);
    std::memset(vel, 0, sizeof(double) * 4 * n_padded);
    for (std::int64_t i = 0; i < n_dark; ++i) {
        const auto& d = dark[i];
        pos[4 * i + 0] = d.pos[0];
        pos[4 * i + 1] = d.pos[1];
        pos[4 * i + 2] = d.pos[2];
        pos[4 * i + 3] = d.mass;
        vel[4 * i + 0] = d.vel[0];
        vel[4 * i + 1] = d.vel[1];
        vel[4 * i + 2] = d.vel[2];
        vel[4 * i + 3] = d.eps;
    }
    for (std::int64_t i = 0; i < n_star; ++i) {
        const auto& s = star[i];
        const std::int64_t j = n_dark + i;
        pos[4 * j + 0] = s.pos[0];
        pos[4 * j + 1] = s.pos[1];
        pos[4 * j + 2] = s.pos[2];
        pos[4 * j + 3] = s.mass;
        vel[4 * j + 0] = s.vel[0];
        vel[4 * j + 1] = s.vel[1];
        vel[4 * j + 2] = s.vel[2];
        vel[4 * j + 3] = s.eps;
    }
    return 0;
}

}  // extern "C"
