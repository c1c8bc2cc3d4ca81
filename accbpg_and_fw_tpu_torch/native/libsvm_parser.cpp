// Fast LIBSVM/svmlight parser.
//
// The port's copy of the JAX package's native parser
// (accbpg_and_fw_tpu/native/libsvm_parser.cpp), built by the port's own
// loader (accbpg_and_fw_tpu_torch/native/__init__.py).  It replaces the
// reference's pure-Python line parser (accbpg/utils.py:22-95): one pass
// over an mmapped file, producing CSR arrays (data/indices/indptr) plus the
// label vector, exposed as a C ABI consumed from Python through ctypes.
//
// Contract mirrors the reference parser:
//   * '#' starts a comment that runs to end of line
//   * first token of a row is the label, then idx:value pairs
//   * indices must be strictly increasing within a row (error otherwise)
//   * negative indices are an error
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libsvm_parser.so libsvm_parser.cpp

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct ParseResult {
  std::vector<double> data;
  std::vector<int64_t> indices;
  std::vector<int64_t> indptr;
  std::vector<double> labels;
  std::string error;
};

// Parse the buffer [p, end).  Returns false and sets r.error on failure.
// Every token in [p, end) must be followed by a terminator byte readable at
// or before *end (a newline inside the buffer, or a NUL at end) — strtod /
// strtoll scan past the token and the caller must guarantee that scan stays
// in mapped memory (see parse_file_impl).  Appends to r; r.indptr must
// already hold its leading 0.
bool parse_buffer(const char* p, const char* end, ParseResult& r) {
  while (p < end) {
    // find end of line, respecting '#' comments
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (eol == nullptr) eol = end;
    const char* hash = static_cast<const char*>(memchr(p, '#', eol - p));
    const char* stop = hash ? hash : eol;

    // skip leading whitespace
    while (p < stop && isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= stop) {  // blank / comment-only line
      p = eol + 1;
      continue;
    }

    // label
    char* next = nullptr;
    double label = strtod(p, &next);
    if (next == p) {
      r.error = "malformed label";
      return false;
    }
    p = next;
    r.labels.push_back(label);

    // idx:value pairs
    int64_t prev_idx = -1;
    for (;;) {
      while (p < stop && isspace(static_cast<unsigned char>(*p))) ++p;
      if (p >= stop) break;
      errno = 0;
      long long idx = strtoll(p, &next, 10);
      if (next == p || *next != ':') {
        r.error = "malformed index:value pair";
        return false;
      }
      if (idx < 0) {
        r.error = "Invalid (negative) index in LibSVM data file.";
        return false;
      }
      if (idx <= prev_idx) {
        r.error = "Feature indices in LibSVM data file should be sorted and unique.";
        return false;
      }
      p = next + 1;  // past ':'
      double value = strtod(p, &next);
      if (next == p) {
        r.error = "malformed feature value";
        return false;
      }
      p = next;
      r.indices.push_back(idx);
      r.data.push_back(value);
      prev_idx = idx;
    }

    r.indptr.push_back(static_cast<int64_t>(r.data.size()));
    p = eol + 1;
  }
  return true;
}

ParseResult* parse_file_impl(const char* path, std::string& err) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    err = "cannot open file";
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    err = "cannot stat file";
    return nullptr;
  }
  auto* r = new ParseResult();
  if (st.st_size == 0) {
    r->indptr.push_back(0);
    close(fd);
    return r;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) {
    delete r;
    err = "mmap failed";
    return nullptr;
  }
  const char* p = static_cast<const char*>(map);
  const char* end = p + st.st_size;
  r->indptr.push_back(0);
  // strtod/strtoll scan one byte past each token looking for a terminator;
  // when the file lacks a trailing newline and exactly fills its last page,
  // that scan would run off the mapping.  Parse the mmapped region only up
  // to its last newline, and the remaining partial line from a
  // NUL-terminated copy.
  const char* last_nl =
      static_cast<const char*>(memrchr(map, '\n', st.st_size));
  bool ok;
  if (last_nl == end - 1) {
    ok = parse_buffer(p, end, *r);
  } else {
    const char* head_end = last_nl ? last_nl + 1 : p;
    ok = parse_buffer(p, head_end, *r);
    if (ok) {
      std::string tail(head_end, end);  // data() is NUL-terminated (C++11)
      ok = parse_buffer(tail.data(), tail.data() + tail.size(), *r);
    }
  }
  munmap(map, st.st_size);
  if (!ok) {
    err = r->error;
    delete r;
    return nullptr;
  }
  return r;
}

thread_local std::string g_error;

}  // namespace

extern "C" {

// Parse `path`; on success returns an opaque handle (free with
// libsvm_free).  On failure returns nullptr; message via libsvm_last_error.
void* libsvm_parse(const char* path) {
  g_error.clear();
  ParseResult* r = parse_file_impl(path, g_error);
  return r;
}

const char* libsvm_last_error() { return g_error.c_str(); }

int64_t libsvm_nnz(void* h) {
  return static_cast<int64_t>(static_cast<ParseResult*>(h)->data.size());
}

int64_t libsvm_rows(void* h) {
  return static_cast<int64_t>(static_cast<ParseResult*>(h)->labels.size());
}

// Copy out CSR arrays; caller allocates (numpy) buffers of the right size.
void libsvm_fill(void* h, double* data, int64_t* indices, int64_t* indptr,
                 double* labels) {
  auto* r = static_cast<ParseResult*>(h);
  memcpy(data, r->data.data(), r->data.size() * sizeof(double));
  memcpy(indices, r->indices.data(), r->indices.size() * sizeof(int64_t));
  memcpy(indptr, r->indptr.data(), r->indptr.size() * sizeof(int64_t));
  memcpy(labels, r->labels.data(), r->labels.size() * sizeof(double));
}

void libsvm_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
