// Fast vessel-graph CSV parser.
//
// The reference parses graph CSVs per training sample with Python's
// csv.DictReader + string splitting of "[x y z]" coordinate fields
// (data/data_transforms.py:358-387, tree2img.py:70-76) — a hot host-side
// path, since graphs are re-rasterized per sample per epoch. This parser
// reads the whole file with a single pass over the bytes.
//
// Format: header line, then rows "[x y z],[x y z],r". Output: 7 doubles per
// edge (node1 xyz, node2 xyz, radius).
//
// Built by octa_tpu_torch/native/__init__.py at first use:
//   g++ -O3 -shared -fPIC -o build/native/libgraph_csv_<hash>.so graph_csv.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses the csv at `path`. Writes at most `cap` edges (7 doubles each)
// into `out`. Returns the number of edges parsed, or -1 on IO error,
// -2 on parse error.
int64_t parse_graph_csv(const char* path, double* out, int64_t cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return -1; }
    size_t got = fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[got] = '\0';

    char* p = buf;
    // skip header line
    while (*p && *p != '\n') p++;
    if (*p) p++;

    int64_t n = 0;
    while (*p && n < cap) {
        // skip whitespace / empty lines
        while (*p == '\r' || *p == '\n' || *p == ' ') p++;
        if (!*p) break;
        double vals[7];
        int k = 0;
        char* line_end = strchr(p, '\n');
        if (!line_end) line_end = buf + got;
        while (p < line_end && k < 7) {
            // skip non-numeric separators: '[', ']', ',', spaces
            while (p < line_end &&
                   !((*p >= '0' && *p <= '9') || *p == '-' || *p == '+'
                     || *p == '.')) {
                p++;
            }
            if (p >= line_end) break;
            char* end = nullptr;
            vals[k] = strtod(p, &end);
            if (end == p) break;
            p = end;
            k++;
        }
        if (k == 7) {
            memcpy(out + n * 7, vals, sizeof(vals));
            n++;
        } else if (k != 0) {
            free(buf);
            return -2;
        }
        p = (line_end < buf + got) ? line_end + 1 : line_end;
    }
    free(buf);
    return n;
}

// Count data lines (upper bound on edges) for buffer sizing.
int64_t count_graph_csv_rows(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t lines = 0;
    char chunk[1 << 16];
    size_t got;
    while ((got = fread(chunk, 1, sizeof(chunk), f)) > 0) {
        for (size_t i = 0; i < got; i++)
            if (chunk[i] == '\n') lines++;
    }
    fclose(f);
    return lines;  // includes header; >= number of edges
}

}  // extern "C"
