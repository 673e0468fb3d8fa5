// audioio — native audio decode + resample for the host data pipeline.
//
// The reference framework leans on compiled external code for its data path
// (torchaudio/soundfile decoders inside audiolm_pytorch's SoundDataset);
// this library is the TPU build's native equivalent: WAV (PCM 8/16/24/32 +
// IEEE float) and FLAC (subset: constant/verbatim/fixed/LPC subframes, all
// stereo decorrelation modes, 8/16/24-bit) decoding plus a windowed-sinc
// polyphase resampler. MP3 and Ogg/Vorbis decode through the system codecs
// (libmpg123 / libvorbisfile, dlopen'd lazily against their stable
// documented ABIs — no headers or link-time deps), covering the remaining
// torchaudio container formats the reference's SoundDataset accepts.
// Exposed to Python via ctypes (see naturalspeech2_tpu/native/__init__.py).
//
// C ABI:
//   int  audio_load(path, &samples, &len, &sr)   -> 0 ok / negative error
//   int  audio_resample(in, len, sr_in, sr_out, &out, &out_len)
//   void audio_free(ptr)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#include <dlfcn.h>

namespace {

// ---------------------------------------------------------------- utils

struct Bytes {
    std::vector<uint8_t> data;
    bool ok = false;
};

Bytes read_file(const char* path) {
    Bytes b;
    FILE* f = fopen(path, "rb");
    if (!f) return b;
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (n <= 0) { fclose(f); return b; }
    b.data.resize((size_t)n);
    b.ok = fread(b.data.data(), 1, (size_t)n, f) == (size_t)n;
    fclose(f);
    return b;
}

uint32_t rd_u32le(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
uint16_t rd_u16le(const uint8_t* p) {
    return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}
uint32_t rd_u24be(const uint8_t* p) {
    return ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | (uint32_t)p[2];
}

// ---------------------------------------------------------------- WAV

int decode_wav(const Bytes& file, std::vector<float>& mono, int* sr) {
    const uint8_t* d = file.data.data();
    size_t n = file.data.size();
    if (n < 44 || memcmp(d, "RIFF", 4) != 0 || memcmp(d + 8, "WAVE", 4) != 0)
        return -2;

    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    const uint8_t* pcm = nullptr;
    size_t pcm_len = 0;

    size_t pos = 12;
    while (pos + 8 <= n) {
        const uint8_t* chunk = d + pos;
        uint32_t chunk_len = rd_u32le(chunk + 4);
        const uint8_t* body = chunk + 8;
        if (pos + 8 + chunk_len > n) chunk_len = (uint32_t)(n - pos - 8);

        if (memcmp(chunk, "fmt ", 4) == 0 && chunk_len >= 16) {
            fmt = rd_u16le(body);
            channels = rd_u16le(body + 2);
            rate = rd_u32le(body + 4);
            bits = rd_u16le(body + 14);
            if (fmt == 0xFFFE && chunk_len >= 40)  // WAVE_FORMAT_EXTENSIBLE
                fmt = rd_u16le(body + 24);
        } else if (memcmp(chunk, "data", 4) == 0) {
            pcm = body;
            pcm_len = chunk_len;
        }
        pos += 8 + chunk_len + (chunk_len & 1);
    }
    if (!pcm || channels == 0 || rate == 0) return -3;

    size_t bytes_per = bits / 8;
    if (bytes_per == 0) return -3;
    size_t frames = pcm_len / (bytes_per * channels);
    mono.resize(frames);

    for (size_t i = 0; i < frames; i++) {
        double acc = 0.0;
        for (int c = 0; c < channels; c++) {
            const uint8_t* s = pcm + (i * channels + c) * bytes_per;
            double v = 0.0;
            if (fmt == 3 && bits == 32) {  // IEEE float
                float fv;
                memcpy(&fv, s, 4);
                v = fv;
            } else if (fmt == 3 && bits == 64) {
                double dv;
                memcpy(&dv, s, 8);
                v = dv;
            } else if (bits == 8) {
                v = ((int)s[0] - 128) / 128.0;
            } else if (bits == 16) {
                int16_t x = (int16_t)rd_u16le(s);
                v = x / 32768.0;
            } else if (bits == 24) {
                int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                      ((uint32_t)s[2] << 16));
                if (x & 0x800000) x |= ~0xFFFFFF;
                v = x / 8388608.0;
            } else if (bits == 32) {
                int32_t x = (int32_t)rd_u32le(s);
                v = x / 2147483648.0;
            } else {
                return -4;
            }
            acc += v;
        }
        mono[i] = (float)(acc / channels);
    }
    *sr = (int)rate;
    return 0;
}

// ---------------------------------------------------------------- FLAC

struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t bytepos = 0;
    int bitpos = 0;  // bits consumed of current byte (msb-first)
    bool error = false;

    BitReader(const uint8_t* d, size_t l) : data(d), len(l) {}

    uint32_t bit() {
        if (bytepos >= len) { error = true; return 0; }
        uint32_t b = (data[bytepos] >> (7 - bitpos)) & 1u;
        if (++bitpos == 8) { bitpos = 0; bytepos++; }
        return b;
    }

    uint64_t bits(int nbits) {
        uint64_t v = 0;
        for (int i = 0; i < nbits; i++) v = (v << 1) | bit();
        return v;
    }

    int64_t sbits(int nbits) {  // two's complement signed
        uint64_t v = bits(nbits);
        if (nbits > 0 && (v >> (nbits - 1)) & 1u)
            v |= ~((1ull << nbits) - 1);
        return (int64_t)v;
    }

    uint64_t unary() {
        uint64_t q = 0;
        while (!error && bit() == 0) q++;
        return q;
    }

    void align() {
        if (bitpos) { bitpos = 0; bytepos++; }
    }
};

int64_t rice_read(BitReader& br, int param) {
    uint64_t q = br.unary();
    uint64_t u = (q << param) | br.bits(param);
    return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag
}

// decode one residual partition set into warmup-prefixed buffer
bool decode_residual(BitReader& br, int pred_order, size_t block_size,
                     std::vector<int64_t>& out) {
    int method = (int)br.bits(2);
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 15 : 31;
    int part_order = (int)br.bits(4);
    size_t n_parts = 1ull << part_order;
    // partition sizes must tile the block exactly and the first partition
    // must fit its warmup samples; the frame-sync scan will try to decode at
    // any 0xFFF8 byte pair, so corrupt input reaches here routinely
    size_t part_size = block_size >> part_order;
    if (part_size < (size_t)pred_order) return false;
    if ((part_size << part_order) != block_size) return false;
    size_t idx = pred_order;
    for (size_t p = 0; p < n_parts; p++) {
        size_t count = part_size - (p == 0 ? (size_t)pred_order : 0);
        if (idx + count > out.size()) return false;
        int param = (int)br.bits(param_bits);
        if (param == escape) {
            int raw_bits = (int)br.bits(5);
            for (size_t i = 0; i < count; i++) out[idx++] = br.sbits(raw_bits);
        } else {
            for (size_t i = 0; i < count; i++) out[idx++] = rice_read(br, param);
        }
        if (br.error) return false;
    }
    return true;
}

const int FIXED_COEFFS[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader& br, size_t block_size, int bps,
                     std::vector<int64_t>& out) {
    if (br.bit() != 0) return false;  // padding bit
    int type = (int)br.bits(6);
    int wasted = 0;
    if (br.bit()) wasted = 1 + (int)br.unary();
    bps -= wasted;
    if (bps <= 0 || bps > 33 || wasted > 32) return false;

    out.assign(block_size, 0);

    if (type == 0) {  // constant
        int64_t v = br.sbits(bps);
        for (size_t i = 0; i < block_size; i++) out[i] = v;
    } else if (type == 1) {  // verbatim
        for (size_t i = 0; i < block_size; i++) out[i] = br.sbits(bps);
    } else if (type >= 8 && type <= 12) {  // fixed, order 0..4
        int order = type - 8;
        for (int i = 0; i < order; i++) out[i] = br.sbits(bps);
        if (!decode_residual(br, order, block_size, out)) return false;
        for (size_t i = order; i < block_size; i++) {
            int64_t pred = 0;
            for (int k = 0; k < order; k++)
                pred += (int64_t)FIXED_COEFFS[order][k] * out[i - 1 - k];
            out[i] += pred;
        }
    } else if (type >= 32) {  // LPC, order 1..32
        int order = (type & 31) + 1;
        for (int i = 0; i < order; i++) out[i] = br.sbits(bps);
        int precision = (int)br.bits(4) + 1;
        int shift = (int)br.sbits(5);
        if (shift < 0) return false;  // negative shift is invalid FLAC; >> UB
        std::vector<int64_t> coeffs(order);
        for (int i = 0; i < order; i++) coeffs[i] = br.sbits(precision);
        if (!decode_residual(br, order, block_size, out)) return false;
        for (size_t i = order; i < block_size; i++) {
            int64_t pred = 0;
            for (int k = 0; k < order; k++) pred += coeffs[k] * out[i - 1 - k];
            out[i] += pred >> shift;
        }
    } else {
        return false;
    }
    for (size_t i = 0; i < block_size; i++) out[i] <<= wasted;
    return !br.error;
}

int decode_flac(const Bytes& file, std::vector<float>& mono, int* sr) {
    const uint8_t* d = file.data.data();
    size_t n = file.data.size();
    if (n < 42 || memcmp(d, "fLaC", 4) != 0) return -2;

    size_t pos = 4;
    int sample_rate = 0, channels = 0, bps = 0;
    uint64_t total_samples = 0;

    // metadata blocks
    bool last = false;
    while (!last && pos + 4 <= n) {
        last = (d[pos] & 0x80) != 0;
        int type = d[pos] & 0x7F;
        uint32_t block_len =
            ((uint32_t)d[pos + 1] << 16) | ((uint32_t)d[pos + 2] << 8) | d[pos + 3];
        pos += 4;
        if (type == 0 && block_len >= 34 && pos + 34 <= n) {  // STREAMINFO
            const uint8_t* s = d + pos;
            sample_rate = (int)((((uint32_t)s[10] << 16) | ((uint32_t)s[11] << 8) |
                                 s[12]) >> 4);
            channels = (int)(((s[12] >> 1) & 0x7) + 1);
            bps = (int)((((s[12] & 1) << 4) | (s[13] >> 4)) + 1);
            total_samples = ((uint64_t)(s[13] & 0x0F) << 32) |
                            ((uint64_t)s[14] << 24) | ((uint64_t)s[15] << 16) |
                            ((uint64_t)s[16] << 8) | s[17];
        }
        pos += block_len;
    }
    if (sample_rate == 0 || channels == 0 || channels > 8) return -3;

    mono.clear();
    // corrupt STREAMINFO can claim up to 2^36 samples; never reserve more
    // than the compressed file could plausibly expand to
    if (total_samples && total_samples <= (uint64_t)n * 4)
        mono.reserve((size_t)total_samples);

    static const int SR_TABLE[12] = {0,      88200, 176400, 192000, 8000, 16000,
                                     22050,  24000, 32000,  44100,  48000, 96000};
    static const int BS_TABLE[16] = {0,   192, 576,  1152, 2304, 4608, 0,    0,
                                     256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
    static const int BPS_TABLE[8] = {0, 8, 12, 0, 16, 20, 24, 32};

    std::vector<std::vector<int64_t>> ch(channels);

    // frames
    while (pos + 5 < n) {
        // sync code 11111111 111110xx
        if (d[pos] != 0xFF || (d[pos + 1] & 0xFC) != 0xF8) { pos++; continue; }
        BitReader br(d + pos, n - pos);
        br.bits(14);          // sync
        br.bit();             // reserved
        int blocking = (int)br.bit();  // 0 fixed, 1 variable
        int bs_code = (int)br.bits(4);
        int sr_code = (int)br.bits(4);
        int ch_code = (int)br.bits(4);
        int bps_code = (int)br.bits(3);
        br.bit();  // reserved

        // UTF-8 coded frame/sample number
        uint32_t first = (uint32_t)br.bits(8);
        int extra = 0;
        if (first >= 0xF0) extra = blocking ? 6 : 3;  // coarse: count bytes
        else if (first >= 0xE0) extra = 2;
        else if (first >= 0xC0) extra = 1;
        for (int i = 0; i < extra; i++) br.bits(8);

        size_t block_size;
        if (bs_code == 6) block_size = br.bits(8) + 1;
        else if (bs_code == 7) block_size = br.bits(16) + 1;
        else block_size = (size_t)BS_TABLE[bs_code];
        if (block_size == 0) { pos++; continue; }

        if (sr_code == 12) br.bits(8);
        else if (sr_code == 13 || sr_code == 14) br.bits(16);
        int frame_sr = sr_code < 12 ? SR_TABLE[sr_code] : sample_rate;
        (void)frame_sr;

        int frame_bps = bps_code ? BPS_TABLE[bps_code] : bps;
        br.bits(8);  // header CRC

        int nch = channels;
        int decorrelation = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
        if (ch_code <= 7) nch = ch_code + 1;
        else { nch = 2; decorrelation = ch_code - 7; }

        bool ok = true;
        for (int c = 0; c < nch && ok; c++) {
            int sub_bps = frame_bps;
            if ((decorrelation == 1 && c == 1) || (decorrelation == 2 && c == 0) ||
                (decorrelation == 3 && c == 1))
                sub_bps += 1;
            if ((int)ch.size() < nch) ch.resize(nch);
            ok = decode_subframe(br, block_size, sub_bps, ch[c]);
        }
        if (!ok) { pos++; continue; }
        br.align();
        br.bits(16);  // frame CRC

        // undo stereo decorrelation
        if (decorrelation == 1) {  // left/side
            for (size_t i = 0; i < block_size; i++) ch[1][i] = ch[0][i] - ch[1][i];
        } else if (decorrelation == 2) {  // right/side: ch0=side, ch1=right
            for (size_t i = 0; i < block_size; i++) ch[0][i] = ch[1][i] + ch[0][i];
        } else if (decorrelation == 3) {  // mid/side
            for (size_t i = 0; i < block_size; i++) {
                int64_t mid = ch[0][i], side = ch[1][i];
                mid = (mid << 1) | (side & 1);
                ch[0][i] = (mid + side) >> 1;
                ch[1][i] = (mid - side) >> 1;
            }
        }

        double scale = 1.0 / (double)(1ll << (frame_bps - 1));
        for (size_t i = 0; i < block_size; i++) {
            double acc = 0;
            for (int c = 0; c < nch; c++) acc += (double)ch[c][i];
            mono.push_back((float)(acc / nch * scale));
        }
        pos += br.bytepos;
    }

    if (mono.empty()) return -5;
    if (total_samples && mono.size() > total_samples)
        mono.resize((size_t)total_samples);
    *sr = sample_rate;
    return 0;
}

// ------------------------------------------------------------ resampler

double sinc(double x) {
    if (std::fabs(x) < 1e-12) return 1.0;
    double px = M_PI * x;
    return std::sin(px) / px;
}

// --------------------------------------------------------- MP3 (libmpg123)
//
// Prototypes follow the stable mpg123 ABI (documented in mpg123.h); the
// library is loaded at first use so WAV/FLAC paths never pay for it and
// hosts without the codec fail with a clear error (-8) for .mp3 only.

struct Mpg123Api {
    int (*init)(void) = nullptr;
    void* (*new_)(const char*, int*) = nullptr;
    int (*open)(void*, const char*) = nullptr;
    int (*getformat)(void*, long*, int*, int*) = nullptr;
    int (*format_none)(void*) = nullptr;
    int (*format)(void*, long, int, int) = nullptr;
    int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
    int (*close)(void*) = nullptr;
    void (*delete_)(void*) = nullptr;
    bool ok = false;
};

const Mpg123Api& mpg123_api() {
    static Mpg123Api api;
    static bool tried = false;
    if (tried) return api;
    tried = true;
    void* dl = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!dl) return api;
    api.init = (int (*)(void))dlsym(dl, "mpg123_init");
    api.new_ = (void* (*)(const char*, int*))dlsym(dl, "mpg123_new");
    api.open = (int (*)(void*, const char*))dlsym(dl, "mpg123_open");
    api.getformat =
        (int (*)(void*, long*, int*, int*))dlsym(dl, "mpg123_getformat");
    api.format_none = (int (*)(void*))dlsym(dl, "mpg123_format_none");
    api.format = (int (*)(void*, long, int, int))dlsym(dl, "mpg123_format");
    api.read = (int (*)(void*, unsigned char*, size_t, size_t*))dlsym(
        dl, "mpg123_read");
    api.close = (int (*)(void*))dlsym(dl, "mpg123_close");
    api.delete_ = (void (*)(void*))dlsym(dl, "mpg123_delete");
    api.ok = api.init && api.new_ && api.open && api.getformat &&
             api.format_none && api.format && api.read && api.close &&
             api.delete_;
    if (api.ok) api.init();
    return api;
}

// mpg123.h constants (stable ABI)
constexpr int MPG123_OK_ = 0;
constexpr int MPG123_DONE_ = -12;
constexpr int MPG123_NEW_FORMAT_ = -11;
// signed 16-bit: the one output encoding every libmpg123 build supports
constexpr int MPG123_ENC_SIGNED_16_ = 0x040 | 0x080 | 0x10;

int decode_mp3(const char* path, std::vector<float>& mono, int* sr) {
    const Mpg123Api& api = mpg123_api();
    if (!api.ok) return -8;  // codec library unavailable on this host
    int err = 0;
    void* h = api.new_(nullptr, &err);
    if (!h) return -2;
    int rc = -2;
    long rate = 0;
    int channels = 0, enc = 0;
    if (api.open(h, path) == MPG123_OK_ &&
        api.getformat(h, &rate, &channels, &enc) == MPG123_OK_ &&
        channels > 0 && rate > 0) {
        api.format_none(h);
        api.format(h, rate, channels, MPG123_ENC_SIGNED_16_);
        std::vector<unsigned char> buf(1 << 16);
        size_t done = 0;
        rc = 0;
        for (;;) {
            int r = api.read(h, buf.data(), buf.size(), &done);
            size_t n = done / sizeof(int16_t) / (size_t)channels;
            const int16_t* pcm = (const int16_t*)buf.data();
            for (size_t i = 0; i < n; i++) {
                float acc = 0.f;
                for (int c = 0; c < channels; c++)
                    acc += (float)pcm[i * channels + c];
                mono.push_back(acc / channels / 32768.0f);
            }
            if (r == MPG123_DONE_) break;
            if (r != MPG123_OK_ && r != MPG123_NEW_FORMAT_) {
                rc = mono.empty() ? -3 : 0;  // truncated tail is tolerated
                break;
            }
        }
        *sr = (int)rate;
        if (mono.empty()) rc = -3;
    }
    api.close(h);
    api.delete_(h);
    return rc;
}

// --------------------------------------------------- Ogg/Vorbis (vorbisfile)

struct VorbisApi {
    int (*fopen)(const char*, void*) = nullptr;
    void* (*info)(void*, int) = nullptr;
    long (*read_float)(void*, float***, int, int*) = nullptr;
    int (*clear)(void*) = nullptr;
    bool ok = false;
};

const VorbisApi& vorbis_api() {
    static VorbisApi api;
    static bool tried = false;
    if (tried) return api;
    tried = true;
    void* dl = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!dl) return api;
    api.fopen = (int (*)(const char*, void*))dlsym(dl, "ov_fopen");
    api.info = (void* (*)(void*, int))dlsym(dl, "ov_info");
    api.read_float =
        (long (*)(void*, float***, int, int*))dlsym(dl, "ov_read_float");
    api.clear = (int (*)(void*))dlsym(dl, "ov_clear");
    api.ok = api.fopen && api.info && api.read_float && api.clear;
    return api;
}

// leading fields of vorbis_info (stable ABI: codec.h)
struct VorbisInfoPrefix {
    int version;
    int channels;
    long rate;
};

int decode_ogg(const char* path, std::vector<float>& mono, int* sr) {
    const VorbisApi& api = vorbis_api();
    if (!api.ok) return -8;
    // OggVorbis_File is ~944 bytes on x86-64; over-allocate for safety
    // since we only ever hand the pointer back to the library
    std::vector<unsigned char> vf(16384, 0);
    if (api.fopen(path, vf.data()) != 0) return -2;
    const VorbisInfoPrefix* vi =
        (const VorbisInfoPrefix*)api.info(vf.data(), -1);
    if (!vi || vi->channels <= 0 || vi->rate <= 0) {
        api.clear(vf.data());
        return -2;
    }
    int channels = vi->channels;
    *sr = (int)vi->rate;
    int bitstream = 0;
    for (;;) {
        float** pcm = nullptr;
        long n = api.read_float(vf.data(), &pcm, 4096, &bitstream);
        if (n == 0) break;      // EOF
        if (n < 0) continue;    // hole in stream: skip, keep decoding
        for (long i = 0; i < n; i++) {
            float acc = 0.f;
            for (int c = 0; c < channels; c++) acc += pcm[c][i];
            mono.push_back(acc / channels);
        }
    }
    api.clear(vf.data());
    return mono.empty() ? -3 : 0;
}

}  // namespace

extern "C" {

int audio_load(const char* path, float** out_samples, int64_t* out_len,
               int* out_sr) {
    Bytes file = read_file(path);
    if (!file.ok) return -1;

    std::vector<float> mono;
    int sr = 0;
    int rc;
    // never let bad_alloc/length_error from corrupt input escape the C ABI
    try {
        const uint8_t* d = file.data.data();
        size_t n = file.data.size();
        bool is_ogg = n >= 4 && memcmp(d, "OggS", 4) == 0;
        bool is_mp3 =
            (n >= 3 && memcmp(d, "ID3", 3) == 0) ||
            (n >= 2 && d[0] == 0xFF && (d[1] & 0xE0) == 0xE0 &&
             (d[1] & 0x18) != 0x08);  // MPEG sync, valid version bits
        if (n >= 4 && memcmp(d, "fLaC", 4) == 0)
            rc = decode_flac(file, mono, &sr);
        else if (is_ogg)
            rc = decode_ogg(path, mono, &sr);
        else if (is_mp3)
            rc = decode_mp3(path, mono, &sr);
        else
            rc = decode_wav(file, mono, &sr);
    } catch (...) {
        return -7;
    }
    if (rc != 0) return rc;

    float* buf = (float*)malloc(mono.size() * sizeof(float));
    if (!buf) return -6;
    memcpy(buf, mono.data(), mono.size() * sizeof(float));
    *out_samples = buf;
    *out_len = (int64_t)mono.size();
    *out_sr = sr;
    return 0;
}

// Windowed-sinc (Blackman-Harris) polyphase resampler, 32 taps per phase.
int audio_resample(const float* in, int64_t in_len, int sr_in, int sr_out,
                   float** out, int64_t* out_len) {
    if (sr_in <= 0 || sr_out <= 0 || in_len <= 0) return -1;
    if (sr_in == sr_out) {
        float* buf = (float*)malloc((size_t)in_len * sizeof(float));
        memcpy(buf, in, (size_t)in_len * sizeof(float));
        *out = buf;
        *out_len = in_len;
        return 0;
    }

    const int HALF_TAPS = 16;
    double ratio = (double)sr_out / sr_in;
    double cutoff = std::min(1.0, ratio) * 0.95;  // anti-alias for downsample
    int64_t n_out = (int64_t)std::floor((double)in_len * ratio);
    float* buf = (float*)malloc((size_t)n_out * sizeof(float));
    if (!buf) return -6;

    for (int64_t i = 0; i < n_out; i++) {
        double center = (double)i / ratio;
        int64_t left = (int64_t)std::floor(center) - HALF_TAPS + 1;
        double acc = 0.0, wsum = 0.0;
        for (int64_t j = left; j < left + 2 * HALF_TAPS; j++) {
            double x = (center - (double)j) * cutoff;
            double t = (double)(j - left) / (2 * HALF_TAPS - 1);
            // Blackman window
            double w = 0.42 - 0.5 * std::cos(2 * M_PI * t) +
                       0.08 * std::cos(4 * M_PI * t);
            double k = sinc(x) * w * cutoff;
            int64_t jj = std::min(std::max(j, (int64_t)0), in_len - 1);
            acc += in[jj] * k;
            wsum += k;
        }
        buf[i] = (float)(wsum > 1e-9 ? acc / wsum * std::min(1.0, 1.0) : acc);
    }
    *out = buf;
    *out_len = n_out;
    return 0;
}

void audio_free(float* p) { free(p); }

}  // extern "C"
