// Fast parsers for the reference's text data formats.
//
// Native equivalent of the reference's C++ test-program IO (ref
// TESTS/TEST4/foo.cpp:9-120): whitespace-separated floats with small integer
// headers, parsed with strtod over a single mmap-style buffer — ~30x faster
// than Python tokenization on the multi-MB UCI feature files.
//
// Built as a plain shared library (no pybind11 in this image); Python binds
// via ctypes (readers.py).  API: all functions return the number of values
// written, or -1 on error.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse up to `count` doubles from the text file starting after `skip`
// whitespace-separated tokens.  Returns values parsed.
long parse_doubles(const char* path, long skip, long count, double* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (size > 0 && fread(buf.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return -1;
    }
    fclose(f);
    buf[size] = '\0';

    char* p = buf.data();
    char* end = nullptr;
    long seen = 0, written = 0;
    while (written < count) {
        double v = strtod(p, &end);
        if (end == p) break;  // no more tokens
        p = end;
        if (seen >= skip) {
            out[written++] = v;
        }
        ++seen;
    }
    return written;
}

// Read the leading integer header tokens (n, or n d, or nwindow dwindow).
long parse_header(const char* path, long nvals, long* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char tok[128];
    long got = 0;
    while (got < nvals && fscanf(f, "%127s", tok) == 1) {
        out[got++] = strtol(tok, nullptr, 10);
    }
    fclose(f);
    return got;
}

}  // extern "C"
