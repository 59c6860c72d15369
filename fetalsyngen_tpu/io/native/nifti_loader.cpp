// Native NIfTI-1 loader: zlib decode + header parse + typed voxel decode,
// with a pthread pool for batch loads.
//
// Role (SURVEY §7 hard-part #5): the generator streams 4 seed NIfTIs per
// sample; Python-side gzip+parse is the host bottleneck when feeding an
// accelerator. This is the runtime-native counterpart of the reference's C++/CUDA
// extensions — the compute kernels moved to XLA, the IO path moves
// to C++. Exposed to Python through ctypes (fetalsyngen_tpu/io/native.py);
// no pybind11 dependency.
//
// Build: cc -O3 -shared -fPIC nifti_loader.cpp -lz -lpthread -o libnifti_loader.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>
#include <zlib.h>

namespace {

struct Header {
    int32_t dims[8];
    int16_t datatype;
    int16_t bitpix;
    float pixdim[8];
    int32_t vox_offset;
    float scl_slope;
    float scl_inter;
    int16_t sform_code;
    float srow[12];
};

// Read a whole (possibly gzipped) file into memory. gzread handles both raw
// and gzip streams transparently.
char* read_all(const char* path, size_t* out_size) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    // large direct buffer reduces inflate call overhead
    gzbuffer(f, 1 << 20);
    size_t cap = 1 << 22;
    size_t size = 0;
    char* buf = (char*)malloc(cap);
    for (;;) {
        if (size == cap) {
            cap *= 2;
            buf = (char*)realloc(buf, cap);
        }
        int n = gzread(f, buf + size, (unsigned)(cap - size));
        if (n < 0) {
            free(buf);
            gzclose(f);
            return nullptr;
        }
        size += (size_t)n;
        if (n == 0) break;
    }
    gzclose(f);
    *out_size = size;
    return buf;
}

bool parse_header(const char* raw, size_t size, Header* h) {
    if (size < 352) return false;
    int32_t sizeof_hdr;
    memcpy(&sizeof_hdr, raw, 4);
    if (sizeof_hdr != 348) return false;  // non-little-endian unsupported
    int16_t dim[8];
    memcpy(dim, raw + 40, 16);
    for (int i = 0; i < 8; i++) h->dims[i] = dim[i];
    memcpy(&h->datatype, raw + 70, 2);
    memcpy(&h->bitpix, raw + 72, 2);
    memcpy(h->pixdim, raw + 76, 32);
    float vox_offset;
    memcpy(&vox_offset, raw + 108, 4);
    h->vox_offset = (int32_t)vox_offset;
    memcpy(&h->scl_slope, raw + 112, 4);
    memcpy(&h->scl_inter, raw + 116, 4);
    memcpy(&h->sform_code, raw + 254, 2);
    memcpy(h->srow, raw + 280, 48);
    return true;
}

// Decode voxels to float32 (applying scl) or raw int32 labels.
template <typename T>
void decode_to_f32(const char* src, float* dst, size_t n, float slope, float inter) {
    const T* s = (const T*)src;
    if (slope == 0.0f) slope = 1.0f;
    for (size_t i = 0; i < n; i++) dst[i] = (float)s[i] * slope + inter;
}

template <typename T>
void decode_to_i32(const char* src, int32_t* dst, size_t n) {
    const T* s = (const T*)src;
    for (size_t i = 0; i < n; i++) dst[i] = (int32_t)s[i];
}

struct LoadTask {
    const char* path;
    float* out_f32;      // either f32 output...
    int32_t* out_i32;    // ...or i32 output (labels)
    int64_t capacity;    // max voxels the output buffer holds
    int64_t* shape_out;  // (3,)
    float* affine_out;   // (12,) srow
    int32_t status;      // 0 ok
};

int load_one(LoadTask* t) {
    size_t size;
    char* raw = read_all(t->path, &size);
    if (!raw) return 1;
    Header h;
    if (!parse_header(raw, size, &h)) {
        free(raw);
        return 2;
    }
    int nd = h.dims[0] < 3 ? h.dims[0] : 3;
    size_t n = 1;
    for (int i = 0; i < 3; i++) {
        int64_t d = i < nd ? h.dims[i + 1] : 1;
        t->shape_out[i] = d;
        n *= (size_t)d;
    }
    memcpy(t->affine_out, h.srow, 48);
    if ((int64_t)n > t->capacity) {  // caller's buffer too small
        free(raw);
        return 5;
    }
    const char* vox = raw + h.vox_offset;
    if ((size_t)h.vox_offset + n * (h.bitpix / 8) > size) {
        free(raw);
        return 3;
    }
    float sl = h.scl_slope, in = h.scl_inter;
    if (sl == 1.0f && in == 0.0f) sl = 0.0f, in = 0.0f, sl = 1.0f;  // normalized
    int rc = 0;
    if (t->out_f32) {
        switch (h.datatype) {
            case 2: decode_to_f32<uint8_t>(vox, t->out_f32, n, sl, in); break;
            case 4: decode_to_f32<int16_t>(vox, t->out_f32, n, sl, in); break;
            case 8: decode_to_f32<int32_t>(vox, t->out_f32, n, sl, in); break;
            case 16: decode_to_f32<float>(vox, t->out_f32, n, sl, in); break;
            case 64: decode_to_f32<double>(vox, t->out_f32, n, sl, in); break;
            case 256: decode_to_f32<int8_t>(vox, t->out_f32, n, sl, in); break;
            case 512: decode_to_f32<uint16_t>(vox, t->out_f32, n, sl, in); break;
            default: rc = 4;
        }
    } else {
        switch (h.datatype) {
            case 2: decode_to_i32<uint8_t>(vox, t->out_i32, n); break;
            case 4: decode_to_i32<int16_t>(vox, t->out_i32, n); break;
            case 8: decode_to_i32<int32_t>(vox, t->out_i32, n); break;
            case 16: decode_to_i32<float>(vox, t->out_i32, n); break;
            case 256: decode_to_i32<int8_t>(vox, t->out_i32, n); break;
            default: rc = 4;
        }
    }
    free(raw);
    return rc;
}

void* worker(void* arg) {
    LoadTask* t = (LoadTask*)arg;
    t->status = load_one(t);
    return nullptr;
}

}  // namespace

extern "C" {

// Load one volume. Exactly one of out_f32 / out_i32 must be non-null and
// sized for max_voxels. Returns 0 on success.
int nifti_load(const char* path, float* out_f32, int32_t* out_i32, int64_t capacity,
               int64_t* shape_out, float* affine_out) {
    LoadTask t{path, out_f32, out_i32, capacity, shape_out, affine_out, 0};
    return load_one(&t);
}

// Load a batch of volumes concurrently (one pthread each; callers batch in
// groups of <= 16 — seed loads are 4-8 files). Outputs are per-volume
// contiguous blocks of stride `stride` elements. Returns the first non-zero
// status, 0 if all succeeded.
int nifti_load_batch_i32(const char** paths, int n, int32_t* out, int64_t stride,
                         int64_t* shapes_out, float* affines_out) {
    if (n <= 0) return 0;
    LoadTask* tasks = (LoadTask*)calloc((size_t)n, sizeof(LoadTask));
    pthread_t* threads = (pthread_t*)malloc(sizeof(pthread_t) * (size_t)n);
    for (int i = 0; i < n; i++) {
        tasks[i] = LoadTask{paths[i], nullptr, out + (size_t)i * stride, stride,
                            shapes_out + i * 3, affines_out + i * 12, 0};
        pthread_create(&threads[i], nullptr, worker, &tasks[i]);
    }
    int rc = 0;
    for (int i = 0; i < n; i++) {
        pthread_join(threads[i], nullptr);
        if (tasks[i].status && !rc) rc = tasks[i].status;
    }
    free(threads);
    free(tasks);
    return rc;
}

// ---------------------------------------------------------------------------
// Writer: gzip-compressed NIfTI save with a thread per file. The header is
// assembled by the Python side (same 352-byte layout `io/nifti.py:save`
// emits); this side only owns the zlib stream — the host-CPU cost of batch
// exports (scripts/resample.py, resize_seeds.py write whole cohorts).
// ---------------------------------------------------------------------------

namespace {

struct SaveTask {
    const char* path;
    const char* header;
    int64_t header_size;
    const char* data;
    int64_t data_size;
    int level;
    int32_t status;
};

int save_one(SaveTask* t) {
    char mode[8];
    snprintf(mode, sizeof(mode), "wb%d", t->level);
    gzFile f = gzopen(t->path, mode);
    if (!f) return 1;
    gzbuffer(f, 1 << 20);
    if (gzwrite(f, t->header, (unsigned)t->header_size) != (int)t->header_size) {
        gzclose(f);
        return 2;
    }
    // write in <=256 MB chunks (gzwrite takes unsigned lengths)
    int64_t off = 0;
    while (off < t->data_size) {
        unsigned chunk = (unsigned)((t->data_size - off) > (1 << 28)
                                        ? (1 << 28)
                                        : (t->data_size - off));
        if (gzwrite(f, t->data + off, chunk) != (int)chunk) {
            gzclose(f);
            return 3;
        }
        off += chunk;
    }
    return gzclose(f) == Z_OK ? 0 : 4;
}

void* save_worker(void* arg) {
    SaveTask* t = (SaveTask*)arg;
    t->status = save_one(t);
    return nullptr;
}

}  // namespace

// Save a batch of gzip NIfTI files concurrently (one pthread each; callers
// chunk to <= 16). Returns the first non-zero status, 0 if all succeeded.
int nifti_save_batch(const char** paths, const char** headers,
                     const int64_t* header_sizes, const char** datas,
                     const int64_t* data_sizes, int n, int level) {
    if (n <= 0) return 0;
    SaveTask* tasks = (SaveTask*)calloc((size_t)n, sizeof(SaveTask));
    pthread_t* threads = (pthread_t*)malloc(sizeof(pthread_t) * (size_t)n);
    for (int i = 0; i < n; i++) {
        tasks[i] = SaveTask{paths[i],       headers[i], header_sizes[i],
                            datas[i],       data_sizes[i],
                            level,          0};
        pthread_create(&threads[i], nullptr, save_worker, &tasks[i]);
    }
    int rc = 0;
    for (int i = 0; i < n; i++) {
        pthread_join(threads[i], nullptr);
        if (tasks[i].status && !rc) rc = tasks[i].status;
    }
    free(threads);
    free(tasks);
    return rc;
}

}  // extern "C"
