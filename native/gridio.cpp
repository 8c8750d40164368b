// Binary NDT-grid codec ("NGF" format) — native map file IO.
//
// The reference persists NDT maps as binary .jff files
// (NDTMap::writeToJFF / loadFromJFF, used by the fuser save path,
// fuser_hmt.cpp:20-49).  NGF is its analogue here: a versioned
// little-endian container for the dense sufficient-statistics grid
// (origin, count, psum, outer, occ), written by native code so map
// checkpoints stream at disk speed without the Python pickle/zip path.
//
// Layout (all little-endian):
//   magic   "NGF1"            4 bytes
//   h, w                      int32 x2
//   origin                    float32 x2
//   resolution                float32
//   count                     float32[h*w]
//   psum                      float32[h*w*2]
//   outer                     float32[h*w*4]
//   occ                       float32[h*w]

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {
constexpr char kMagic[4] = {'N', 'G', 'F', '1'};
}

extern "C" {

// Returns 0 on success.
int ngf_write(const char *path, int h, int w, const float *origin,
              float resolution, const float *count, const float *psum,
              const float *outer, const float *occ) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return 1;
  int ok = 1;
  ok &= std::fwrite(kMagic, 1, 4, f) == 4;
  int32_t hw[2] = {h, w};
  ok &= std::fwrite(hw, sizeof(int32_t), 2, f) == 2;
  ok &= std::fwrite(origin, sizeof(float), 2, f) == 2;
  ok &= std::fwrite(&resolution, sizeof(float), 1, f) == 1;
  const size_t n = static_cast<size_t>(h) * w;
  ok &= std::fwrite(count, sizeof(float), n, f) == n;
  ok &= std::fwrite(psum, sizeof(float), n * 2, f) == n * 2;
  ok &= std::fwrite(outer, sizeof(float), n * 4, f) == n * 4;
  ok &= std::fwrite(occ, sizeof(float), n, f) == n;
  std::fclose(f);
  return ok ? 0 : 2;
}

// Header probe: returns 0 and fills h/w/origin/resolution.
int ngf_header(const char *path, int *h, int *w, float *origin,
               float *resolution) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return 1;
  char magic[4];
  int ok = std::fread(magic, 1, 4, f) == 4 &&
           std::memcmp(magic, kMagic, 4) == 0;
  int32_t hw[2];
  ok = ok && std::fread(hw, sizeof(int32_t), 2, f) == 2;
  ok = ok && std::fread(origin, sizeof(float), 2, f) == 2;
  ok = ok && std::fread(resolution, sizeof(float), 1, f) == 1;
  std::fclose(f);
  if (!ok) return 2;
  *h = hw[0];
  *w = hw[1];
  return 0;
}

// Full read into caller-allocated buffers (sizes from ngf_header).
int ngf_read(const char *path, float *count, float *psum, float *outer,
             float *occ) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return 1;
  int32_t hw[2];
  float head[3];
  char magic[4];
  int ok = std::fread(magic, 1, 4, f) == 4;
  ok = ok && std::fread(hw, sizeof(int32_t), 2, f) == 2;
  ok = ok && std::fread(head, sizeof(float), 3, f) == 3;
  const size_t n = ok ? static_cast<size_t>(hw[0]) * hw[1] : 0;
  ok = ok && std::fread(count, sizeof(float), n, f) == n;
  ok = ok && std::fread(psum, sizeof(float), n * 2, f) == n * 2;
  ok = ok && std::fread(outer, sizeof(float), n * 4, f) == n * 4;
  ok = ok && std::fread(occ, sizeof(float), n, f) == n;
  std::fclose(f);
  return ok ? 0 : 2;
}

}  // extern "C"
