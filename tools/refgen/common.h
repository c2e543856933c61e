// Golden-vector generator support: binary .dat writers (file_vector format:
// raw little-endian, no header — reference include/srsran/support/file_vector.h:63-81)
// plus a minimal JSON manifest builder. The generators drive the REFERENCE
// implementation (compiled from /root/reference) to produce conformance
// vectors; this framework's pytest `vectortest` suite diffs against them.
#pragma once

#include <cstdint>
#include <cstdio>
#include <random>
#include <string>
#include <sys/stat.h>
#include <vector>

namespace refgen {

inline std::string g_outdir;

inline void set_outdir(const std::string& dir) {
  g_outdir = dir;
  ::mkdir(dir.c_str(), 0755);
}

template <typename T>
void write_dat(const std::string& name, const T* data, size_t count) {
  std::string path = g_outdir + "/" + name;
  FILE* f = ::fopen(path.c_str(), "wb");
  if (!f) { ::perror(path.c_str()); ::exit(1); }
  if (count && ::fwrite(data, sizeof(T), count, f) != count) { ::perror("fwrite"); ::exit(1); }
  ::fclose(f);
}

template <typename T>
void write_dat(const std::string& name, const std::vector<T>& v) {
  write_dat(name, v.data(), v.size());
}

// Tiny append-only JSON manifest: an array of case objects.
class manifest {
public:
  explicit manifest(const std::string& name) : path_(g_outdir + "/" + name) { body_ = "[\n"; }
  void begin_case() { if (ncases_++) body_ += ",\n"; body_ += "{"; nfields_ = 0; }
  void field(const std::string& k, long long v) { sep(); body_ += "\"" + k + "\": " + std::to_string(v); }
  void field(const std::string& k, double v) {
    sep();
    char buf[48];
    ::snprintf(buf, sizeof buf, "%.17g", v);
    body_ += "\"" + k + "\": " + buf;
  }
  void field(const std::string& k, const std::string& v) { sep(); body_ += "\"" + k + "\": \"" + v + "\""; }
  void raw_field(const std::string& k, const std::string& v) { sep(); body_ += "\"" + k + "\": " + v; }
  void end_case() { body_ += "}"; }
  void flush() {
    body_ += "\n]\n";
    FILE* f = ::fopen(path_.c_str(), "w");
    if (!f) { ::perror(path_.c_str()); ::exit(1); }
    ::fwrite(body_.data(), 1, body_.size(), f);
    ::fclose(f);
    ::printf("wrote %s (%d cases)\n", path_.c_str(), ncases_);
  }

private:
  void sep() { if (nfields_++) body_ += ", "; }
  std::string path_;
  std::string body_;
  int ncases_ = 0;
  int nfields_ = 0;
};

// Deterministic RNG per suite.
inline std::mt19937 make_rng(uint32_t seed) { return std::mt19937(seed); }

inline std::vector<uint8_t> random_bits(std::mt19937& rng, size_t n) {
  std::vector<uint8_t> out(n);
  std::uniform_int_distribution<int> d(0, 1);
  for (auto& b : out) b = (uint8_t)d(rng);
  return out;
}

inline std::vector<uint8_t> random_bytes(std::mt19937& rng, size_t n) {
  std::vector<uint8_t> out(n);
  std::uniform_int_distribution<int> d(0, 255);
  for (auto& b : out) b = (uint8_t)d(rng);
  return out;
}

} // namespace refgen
