// CARMEN log-format (.clf) parser — native data loader.
//
// Native replacement for the reference's dataset path
// (perception_oru LaserBagReader, ndt_graph_offline.cpp:458-479): the
// host-side IO stays native C++ (like the reference's), producing
// packed arrays the JAX pipeline consumes zero-copy via ctypes.
//
// Supported records (classic CARMEN logs: intel.clf, fr079.clf, ...):
//   FLASER n r1..rn x y theta odom_x odom_y odom_theta ts host lts
//   ROBOTLASER1 type start fov res maxr acc remission n r1..rn ...
//               laser_x laser_y laser_th rob_x rob_y rob_th ... ts
//   ODOM x y theta tv rv accel ts host lts
//
// C ABI: two-pass (count, fill) so the caller allocates numpy buffers.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Scan {
  std::vector<float> ranges;
  float odom[3];
  double time;
};

struct ParsedLog {
  std::vector<Scan> scans;
  int max_beams = 0;
};

bool parse_flaser(std::istringstream &ss, Scan *out) {
  int n;
  if (!(ss >> n) || n <= 0 || n > 100000) return false;
  out->ranges.resize(n);
  for (int i = 0; i < n; ++i) {
    if (!(ss >> out->ranges[i])) return false;
  }
  float x, y, th;
  if (!(ss >> x >> y >> th)) return false;  // laser pose (unused)
  if (!(ss >> out->odom[0] >> out->odom[1] >> out->odom[2]))
    return false;
  if (!(ss >> out->time)) out->time = 0.0;
  return true;
}

bool parse_robotlaser1(std::istringstream &ss, Scan *out) {
  int type;
  double start, fov, res, maxr, acc;
  int remission;
  if (!(ss >> type >> start >> fov >> res >> maxr >> acc >> remission))
    return false;
  int n;
  if (!(ss >> n) || n <= 0 || n > 100000) return false;
  out->ranges.resize(n);
  for (int i = 0; i < n; ++i)
    if (!(ss >> out->ranges[i])) return false;
  int nrem;
  if (!(ss >> nrem)) return false;
  double tmp;
  for (int i = 0; i < nrem; ++i)
    if (!(ss >> tmp)) return false;
  double lx, ly, lth, rx, ry, rth;
  if (!(ss >> lx >> ly >> lth >> rx >> ry >> rth)) return false;
  out->odom[0] = static_cast<float>(rx);
  out->odom[1] = static_cast<float>(ry);
  out->odom[2] = static_cast<float>(rth);
  // skip 5 motion fields, then timestamp
  for (int i = 0; i < 5 && (ss >> tmp); ++i) {
  }
  if (!(ss >> out->time)) out->time = 0.0;
  return true;
}

ParsedLog *parse_file(const char *path) {
  std::ifstream f(path);
  if (!f.is_open()) return nullptr;
  auto *log = new ParsedLog();
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string tag;
    ss >> tag;
    Scan s{};
    bool ok = false;
    if (tag == "FLASER") {
      ok = parse_flaser(ss, &s);
    } else if (tag == "ROBOTLASER1") {
      ok = parse_robotlaser1(ss, &s);
    }
    if (ok) {
      if (static_cast<int>(s.ranges.size()) > log->max_beams)
        log->max_beams = static_cast<int>(s.ranges.size());
      log->scans.push_back(std::move(s));
    }
  }
  return log;
}

}  // namespace

extern "C" {

// Returns an opaque handle (or nullptr); fills n_scans / max_beams.
void *clf_open(const char *path, int *n_scans, int *max_beams) {
  ParsedLog *log = parse_file(path);
  if (!log) return nullptr;
  *n_scans = static_cast<int>(log->scans.size());
  *max_beams = log->max_beams;
  return log;
}

// Fill caller-allocated buffers:
//   ranges:  n_scans * max_beams floats (padded with max_range_pad)
//   beam_counts: n_scans ints
//   odom:    n_scans * 3 floats (absolute odometry pose)
//   times:   n_scans doubles
void clf_fill(void *handle, float *ranges, int *beam_counts, float *odom,
              double *times, float max_range_pad) {
  auto *log = static_cast<ParsedLog *>(handle);
  const int mb = log->max_beams;
  for (size_t k = 0; k < log->scans.size(); ++k) {
    const Scan &s = log->scans[k];
    const int n = static_cast<int>(s.ranges.size());
    beam_counts[k] = n;
    for (int i = 0; i < mb; ++i)
      ranges[k * mb + i] = (i < n) ? s.ranges[i] : max_range_pad;
    std::memcpy(odom + k * 3, s.odom, 3 * sizeof(float));
    times[k] = s.time;
  }
}

void clf_close(void *handle) {
  delete static_cast<ParsedLog *>(handle);
}

}  // extern "C"
