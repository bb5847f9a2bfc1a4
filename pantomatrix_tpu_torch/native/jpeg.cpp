// Baseline JPEG entropy coder: quantized DCT blocks -> Huffman-coded scan bytes.
//
// The host half of pantomatrix_tpu_torch/viz/jpeg.py. The colour conversion, the DCT
// and the quantization run in PyTorch on the frames' device; this file takes their
// int16 coefficients (zigzag order, blocks in interleaved MCU order) and writes one
// scan per frame: DC differences per component, AC run lengths with ZRL and EOB, the
// caller's Huffman tables (code and length per symbol), 0xFF byte stuffing, and 1-bit
// padding of the last byte (ITU-T T.81, F.1.2). Frames are coded in parallel with
// std::thread, one frame per task.
//
// C ABI for ctypes; built with g++ at first use by pantomatrix_tpu_torch/native/__init__.py.
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct BitWriter {
    std::vector<uint8_t>& out;
    uint64_t acc = 0;  // pending bits, right-aligned
    int n = 0;         // number of pending bits

    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

    void put(uint32_t code, int size) {
        if (size == 0) return;
        acc = (acc << size) | (code & ((1u << size) - 1));
        n += size;
        while (n >= 8) {
            n -= 8;
            const uint8_t byte = static_cast<uint8_t>(acc >> n);
            out.push_back(byte);
            if (byte == 0xFF) out.push_back(0x00);
        }
        acc &= (uint64_t(1) << n) - 1;
    }

    void flush() {  // pad the last byte with 1-bits
        if (n > 0) put((1u << (8 - n)) - 1, 8 - n);
    }
};

inline int magnitude_bits(int v) {
    const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
    return a ? 32 - __builtin_clz(a) : 0;
}

// One frame's scan. tables: 4 Huffman tables of 256 symbols (codes and sizes);
// block_comp / block_dc / block_ac: component, DC table and AC table of each block
// position in an MCU.
void encode_frame(const int16_t* coefs, int n_mcus, int blocks_per_mcu, const int* block_comp,
                  const int* block_dc, const int* block_ac, const uint16_t* codes,
                  const uint8_t* sizes, std::vector<uint8_t>& out) {
    BitWriter bw(out);
    int pred[4] = {0, 0, 0, 0};
    for (int m = 0; m < n_mcus; ++m) {
        for (int b = 0; b < blocks_per_mcu; ++b) {
            const int16_t* blk = coefs + (static_cast<size_t>(m) * blocks_per_mcu + b) * 64;
            const uint16_t* dc_code = codes + 256 * block_dc[b];
            const uint8_t* dc_size = sizes + 256 * block_dc[b];
            const uint16_t* ac_code = codes + 256 * block_ac[b];
            const uint8_t* ac_size = sizes + 256 * block_ac[b];
            const int c = block_comp[b];
            const int diff = blk[0] - pred[c];
            pred[c] = blk[0];
            int nbits = magnitude_bits(diff);
            bw.put(dc_code[nbits], dc_size[nbits]);
            if (nbits) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nbits);
            // the nonzero AC positions as a bit mask, walked lowest first; most blocks of
            // a render are flat, so an all-zero AC part is caught first
            int any = 0;
            for (int k = 1; k < 64; ++k) any |= blk[k];
            uint64_t nonzero = 0;
            if (any)
                for (int k = 1; k < 64; ++k) nonzero |= static_cast<uint64_t>(blk[k] != 0) << k;
            int last = 0;
            while (nonzero) {
                const int k = __builtin_ctzll(nonzero);
                nonzero &= nonzero - 1;
                int run = k - last - 1;
                while (run > 15) {
                    bw.put(ac_code[0xF0], ac_size[0xF0]);
                    run -= 16;
                }
                const int v = blk[k];
                nbits = magnitude_bits(v);
                const int sym = (run << 4) | nbits;
                bw.put(ac_code[sym], ac_size[sym]);
                bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nbits);
                last = k;
            }
            if (last != 63) bw.put(ac_code[0x00], ac_size[0x00]);  // EOB
        }
    }
    bw.flush();
}

struct Scans {
    std::vector<std::vector<uint8_t>> frames;
};

}  // namespace

extern "C" {

// coefs: (n_frames, n_mcus * blocks_per_mcu, 64) int16, zigzag order. Returns a handle
// holding each frame's scan bytes; read them with jpeg_scans_sizes / jpeg_scans_copy and
// release it with jpeg_scans_free.
void* jpeg_encode_scans(const int16_t* coefs, int n_frames, int n_mcus, int blocks_per_mcu,
                        const int* block_comp, const int* block_dc, const int* block_ac,
                        const uint16_t* codes, const uint8_t* sizes, int n_threads) {
    Scans* scans = new Scans();
    scans->frames.resize(n_frames);
    if (n_threads < 1) n_threads = 1;
    const size_t per_frame = static_cast<size_t>(n_mcus) * blocks_per_mcu * 64;
    std::atomic<int> next{0};
    auto worker = [&]() {
        while (true) {
            const int f = next.fetch_add(1);
            if (f >= n_frames) break;
            scans->frames[f].reserve(per_frame / 8);
            encode_frame(coefs + f * per_frame, n_mcus, blocks_per_mcu, block_comp, block_dc,
                         block_ac, codes, sizes, scans->frames[f]);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return scans;
}

void jpeg_scans_sizes(void* handle, int64_t* sizes) {
    const Scans* scans = static_cast<const Scans*>(handle);
    for (size_t f = 0; f < scans->frames.size(); ++f) sizes[f] = scans->frames[f].size();
}

// Writes the scans back to back into out (the sum of jpeg_scans_sizes bytes).
void jpeg_scans_copy(void* handle, uint8_t* out) {
    const Scans* scans = static_cast<const Scans*>(handle);
    for (const auto& frame : scans->frames) {
        if (!frame.empty()) std::memcpy(out, frame.data(), frame.size());
        out += frame.size();
    }
}

void jpeg_scans_free(void* handle) { delete static_cast<Scans*>(handle); }

}  // extern "C"
