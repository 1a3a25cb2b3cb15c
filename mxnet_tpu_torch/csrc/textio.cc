// Compiled text-format parsers for the IO subsystem: CSV and LibSVM.
//
// Reference: src/io/iter_csv.cc and src/io/iter_libsvm.cc — the
// reference parses these formats in C++ inside its threaded iterator
// stack; the Python stand-ins (numpy.loadtxt / str.split) pay Python
// object overhead per token. These parsers are GIL-free and
// multithreaded: the file is read once, split into line-aligned chunks,
// and each chunk is parsed by a worker with strtof/strtol; results are
// stitched in order. The JAX package's native/textio.cc, copied: the
// port builds its own (mxnet_tpu_torch/_native.py, g++ at first use).
//
// C ABI (consumed by mxnet_tpu_torch/io via ctypes):
//   csv_parse(path) -> handle | NULL      csv_free(handle)
//   csv_rows/csv_cols(handle)             csv_data(handle) -> float*
//   svm_parse(path, inline_labels) -> handle | NULL   svm_free(handle)
//   svm_rows/svm_nnz(handle)
//   svm_data/svm_labels -> float*, svm_indices/svm_indptr -> int64*
//   textio_last_error() -> const char* (thread-local)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <exception>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#define TEXTIO_API extern "C" __attribute__((visibility("default")))

namespace {

std::string& last_error() {
  thread_local std::string err;
  return err;
}

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) {
    last_error() = std::string("cannot open ") + path;
    return false;
  }
  long n = -1;
  if (std::fseek(f, 0, SEEK_END) == 0) n = std::ftell(f);
  if (n < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
    // directories and unseekable streams land here; a catchable error
    // beats resize((size_t)-1) aborting the host process
    std::fclose(f);
    last_error() = std::string("not a regular readable file: ") + path;
    return false;
  }
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(n)) {
    last_error() = std::string("short read on ") + path;
    return false;
  }
  return true;
}

// split [0, size) into up to `parts` chunks aligned to '\n'
std::vector<std::pair<size_t, size_t>> line_chunks(const std::string& buf,
                                                   unsigned parts) {
  std::vector<std::pair<size_t, size_t>> out;
  size_t size = buf.size();
  if (size == 0) return out;
  size_t per = std::max<size_t>(size / std::max(1u, parts), 1);
  size_t begin = 0;
  while (begin < size) {
    size_t end = std::min(begin + per, size);
    while (end < size && buf[end] != '\n') ++end;
    if (end < size) ++end;  // include the newline
    out.emplace_back(begin, end);
    begin = end;
  }
  return out;
}

unsigned n_workers() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? std::min(hw, 16u) : 4u;
}

struct CsvResult {
  std::vector<float> data;
  int64_t rows = 0;
  int64_t cols = 0;
};

struct SvmResult {
  std::vector<float> data;
  std::vector<int64_t> indices;
  std::vector<int64_t> indptr;  // rows+1
  std::vector<float> labels;
  int64_t rows = 0;
};

bool parse_csv_chunk(const char* p, const char* end,
                     std::vector<float>* vals, std::vector<int64_t>* rows,
                     std::string* err) {
  // rows gets the running column count per line for shape validation
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    const char* next_line = line_end;
    // '#' starts a comment (numpy.loadtxt-compatible; whole-line or
    // trailing) — the line is truncated there
    const char* hash = static_cast<const char*>(
        std::memchr(p, '#', static_cast<size_t>(line_end - p)));
    if (hash != nullptr) line_end = hash;
    bool blank = true;
    for (const char* q = p; q < line_end; ++q)
      if (!std::isspace(static_cast<unsigned char>(*q))) { blank = false; break; }
    if (!blank) {
      int64_t ncol = 0;
      while (p < line_end) {
        char* next = nullptr;
        float v = std::strtof(p, &next);
        if (next == p) {
          *err = "malformed CSV number near '" +
                 std::string(p, std::min<size_t>(16, line_end - p)) + "'";
          return false;
        }
        vals->push_back(v);
        ++ncol;
        p = next;
        while (p < line_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p < line_end && *p == ',') {
          ++p;
          while (p < line_end && (*p == ' ' || *p == '\t')) ++p;
        }
      }
      rows->push_back(ncol);
    }
    p = (next_line < end) ? next_line + 1 : end;
  }
  return true;
}

bool parse_svm_chunk(const char* p, const char* end, bool inline_labels,
                     SvmResult* out, std::string* err) {
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    while (p < line_end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p < line_end) {
      if (inline_labels) {
        char* next = nullptr;
        float lab = std::strtof(p, &next);
        if (next == p) {
          *err = "malformed libsvm label";
          return false;
        }
        out->labels.push_back(lab);
        p = next;
      }
      while (p < line_end) {
        while (p < line_end &&
               std::isspace(static_cast<unsigned char>(*p))) ++p;
        if (p >= line_end || *p == '#') break;  // trailing comment
        char* next = nullptr;
        long idx = std::strtol(p, &next, 10);
        if (next == p || next >= line_end || *next != ':') {
          *err = "malformed libsvm token near '" +
                 std::string(p, std::min<size_t>(16, line_end - p)) + "'";
          return false;
        }
        p = next + 1;
        float v = std::strtof(p, &next);
        if (next == p) {
          *err = "malformed libsvm value";
          return false;
        }
        out->indices.push_back(idx);
        out->data.push_back(v);
        p = next;
      }
      out->indptr.push_back(static_cast<int64_t>(out->indices.size()));
      ++out->rows;
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  return true;
}

}  // namespace

TEXTIO_API const char* textio_last_error() { return last_error().c_str(); }

namespace {

void* csv_parse_impl(const char* path) {
  std::string buf;
  if (!read_file(path, &buf)) return nullptr;
  auto chunks = line_chunks(buf, n_workers());
  std::vector<std::vector<float>> vals(chunks.size());
  std::vector<std::vector<int64_t>> rows(chunks.size());
  std::vector<std::string> errs(chunks.size());
  std::vector<char> ok(chunks.size(), 1);
  std::vector<std::thread> threads;
  for (size_t i = 0; i < chunks.size(); ++i) {
    threads.emplace_back([&, i] {
      ok[i] = parse_csv_chunk(buf.data() + chunks[i].first,
                              buf.data() + chunks[i].second, &vals[i],
                              &rows[i], &errs[i]);
    });
  }
  for (auto& t : threads) t.join();
  for (size_t i = 0; i < chunks.size(); ++i) {
    if (!ok[i]) {
      last_error() = errs[i];
      return nullptr;
    }
  }
  auto* res = new CsvResult();
  for (auto& r : rows) {
    for (int64_t ncol : r) {
      if (res->cols == 0) res->cols = ncol;
      if (ncol != res->cols) {
        last_error() = "ragged CSV: row with " + std::to_string(ncol) +
                       " columns, expected " + std::to_string(res->cols);
        delete res;
        return nullptr;
      }
      ++res->rows;
    }
  }
  size_t total = 0;
  for (auto& v : vals) total += v.size();
  res->data.reserve(total);
  for (auto& v : vals)
    res->data.insert(res->data.end(), v.begin(), v.end());
  return res;
}

}  // namespace

TEXTIO_API void* csv_parse(const char* path) {
  // no C++ exception may cross the C ABI (std::terminate otherwise)
  try {
    return csv_parse_impl(path);
  } catch (const std::exception& e) {
    last_error() = e.what();
    return nullptr;
  }
}

TEXTIO_API int64_t csv_rows(void* h) {
  return static_cast<CsvResult*>(h)->rows;
}
TEXTIO_API int64_t csv_cols(void* h) {
  return static_cast<CsvResult*>(h)->cols;
}
TEXTIO_API const float* csv_data(void* h) {
  return static_cast<CsvResult*>(h)->data.data();
}
TEXTIO_API void csv_free(void* h) { delete static_cast<CsvResult*>(h); }

namespace {

void* svm_parse_impl(const char* path, int inline_labels) {
  std::string buf;
  if (!read_file(path, &buf)) return nullptr;
  auto chunks = line_chunks(buf, n_workers());
  std::vector<SvmResult> parts(chunks.size());
  std::vector<std::string> errs(chunks.size());
  std::vector<char> ok(chunks.size(), 1);
  std::vector<std::thread> threads;
  for (size_t i = 0; i < chunks.size(); ++i) {
    threads.emplace_back([&, i] {
      ok[i] = parse_svm_chunk(buf.data() + chunks[i].first,
                              buf.data() + chunks[i].second,
                              inline_labels != 0, &parts[i], &errs[i]);
    });
  }
  for (auto& t : threads) t.join();
  for (size_t i = 0; i < chunks.size(); ++i) {
    if (!ok[i]) {
      last_error() = errs[i];
      return nullptr;
    }
  }
  auto* res = new SvmResult();
  res->indptr.push_back(0);
  for (auto& p : parts) {
    int64_t base = static_cast<int64_t>(res->indices.size());
    res->data.insert(res->data.end(), p.data.begin(), p.data.end());
    res->indices.insert(res->indices.end(), p.indices.begin(),
                        p.indices.end());
    res->labels.insert(res->labels.end(), p.labels.begin(),
                       p.labels.end());
    for (int64_t ip : p.indptr) res->indptr.push_back(base + ip);
    res->rows += p.rows;
  }
  return res;
}

}  // namespace

TEXTIO_API void* svm_parse(const char* path, int inline_labels) {
  try {
    return svm_parse_impl(path, inline_labels);
  } catch (const std::exception& e) {
    last_error() = e.what();
    return nullptr;
  }
}

TEXTIO_API int64_t svm_rows(void* h) {
  return static_cast<SvmResult*>(h)->rows;
}
TEXTIO_API int64_t svm_nnz(void* h) {
  return static_cast<int64_t>(static_cast<SvmResult*>(h)->data.size());
}
TEXTIO_API const float* svm_data(void* h) {
  return static_cast<SvmResult*>(h)->data.data();
}
TEXTIO_API const int64_t* svm_indices(void* h) {
  return static_cast<SvmResult*>(h)->indices.data();
}
TEXTIO_API const int64_t* svm_indptr(void* h) {
  return static_cast<SvmResult*>(h)->indptr.data();
}
TEXTIO_API const float* svm_labels(void* h) {
  return static_cast<SvmResult*>(h)->labels.data();
}
TEXTIO_API void svm_free(void* h) { delete static_cast<SvmResult*>(h); }
