// Software mesh rasterizer (the port's own copy of the JAX package's
// native/rasterizer.cpp: the same algorithm, constants and C ABI).
//
// Orthographic camera (xmag/ymag), z-buffered triangle fill, smooth (per-vertex
// normal) Lambertian shading with a single directional light: the reference scene's
// configuration (OrthographicCamera(1,1), DirectionalLight intensity 4, uniform-color
// mesh, black background). Frames are rendered in parallel with std::thread, one frame
// per task.
//
// C ABI for ctypes; built with g++ at first use by pantomatrix_tpu_torch/native/__init__.py.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 normalize(const Vec3& v) {
    float n = std::sqrt(dot(v, v));
    if (n < 1e-12f) return {0, 0, 0};
    return {v.x / n, v.y / n, v.z / n};
}

// Render one frame: vertices already in CAMERA space.
void render_frame(const float* verts, int n_verts, const int* faces, int n_faces,
                  int width, int height, float xmag, float ymag,
                  const float* light_dir_cam, float light_intensity,
                  const unsigned char* color, float ambient,
                  unsigned char* out_rgb) {
    std::vector<float> zbuf(static_cast<size_t>(width) * height,
                            -std::numeric_limits<float>::infinity());
    std::memset(out_rgb, 0, static_cast<size_t>(width) * height * 3);

    // Per-vertex normals: area-weighted face normals (smooth shading).
    std::vector<Vec3> normals(n_verts, {0, 0, 0});
    for (int f = 0; f < n_faces; ++f) {
        const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
        Vec3 v0 = {verts[3 * i0], verts[3 * i0 + 1], verts[3 * i0 + 2]};
        Vec3 v1 = {verts[3 * i1], verts[3 * i1 + 1], verts[3 * i1 + 2]};
        Vec3 v2 = {verts[3 * i2], verts[3 * i2 + 1], verts[3 * i2 + 2]};
        Vec3 fn = cross(sub(v1, v0), sub(v2, v0));  // area-weighted
        normals[i0].x += fn.x; normals[i0].y += fn.y; normals[i0].z += fn.z;
        normals[i1].x += fn.x; normals[i1].y += fn.y; normals[i1].z += fn.z;
        normals[i2].x += fn.x; normals[i2].y += fn.y; normals[i2].z += fn.z;
    }
    for (auto& n : normals) n = normalize(n);

    Vec3 L = normalize({light_dir_cam[0], light_dir_cam[1], light_dir_cam[2]});

    // Project to pixels: x_pix = (x/xmag + 1)/2 * w; y flipped.
    std::vector<float> px(n_verts), py(n_verts);
    for (int v = 0; v < n_verts; ++v) {
        px[v] = (verts[3 * v] / xmag + 1.0f) * 0.5f * width;
        py[v] = (1.0f - (verts[3 * v + 1] / ymag + 1.0f) * 0.5f) * height;
    }

    for (int f = 0; f < n_faces; ++f) {
        const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
        const float x0 = px[i0], y0 = py[i0], x1 = px[i1], y1 = py[i1];
        const float x2 = px[i2], y2 = py[i2];
        const float z0 = verts[3 * i0 + 2], z1 = verts[3 * i1 + 2], z2 = verts[3 * i2 + 2];

        const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
        if (std::fabs(area) < 1e-12f) continue;
        const float inv_area = 1.0f / area;

        int min_x = std::max(0, (int)std::floor(std::min({x0, x1, x2})));
        int max_x = std::min(width - 1, (int)std::ceil(std::max({x0, x1, x2})));
        int min_y = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
        int max_y = std::min(height - 1, (int)std::ceil(std::max({y0, y1, y2})));
        if (min_x > max_x || min_y > max_y) continue;

        // Pre-shade the three corners (Gouraud — matches pyrender's smooth look
        // closely at this mesh density).
        float s0 = std::max(0.0f, dot(normals[i0], L));
        float s1 = std::max(0.0f, dot(normals[i1], L));
        float s2 = std::max(0.0f, dot(normals[i2], L));

        for (int y = min_y; y <= max_y; ++y) {
            for (int x = min_x; x <= max_x; ++x) {
                const float cx = x + 0.5f, cy = y + 0.5f;
                float w0 = ((x1 - cx) * (y2 - cy) - (x2 - cx) * (y1 - cy)) * inv_area;
                float w1 = ((x2 - cx) * (y0 - cy) - (x0 - cx) * (y2 - cy)) * inv_area;
                float w2 = 1.0f - w0 - w1;
                if (w0 < 0 || w1 < 0 || w2 < 0) continue;
                const float z = w0 * z0 + w1 * z1 + w2 * z2;  // camera looks down -z
                float& zb = zbuf[static_cast<size_t>(y) * width + x];
                if (z <= zb) continue;
                zb = z;
                float shade = w0 * s0 + w1 * s1 + w2 * s2;
                float lum = std::min(1.0f, ambient + shade * light_intensity * 0.25f);
                unsigned char* p = out_rgb + (static_cast<size_t>(y) * width + x) * 3;
                p[0] = (unsigned char)(color[0] * lum);
                p[1] = (unsigned char)(color[1] * lum);
                p[2] = (unsigned char)(color[2] * lum);
            }
        }
    }
}

}  // namespace

extern "C" {

// vertices: (n_frames, n_verts, 3) float32 CAMERA-space; faces: (n_faces, 3) int32;
// light_dir_cam: direction TOWARD the light in camera space; out: (n_frames, h, w, 3).
void render_mesh_frames(const float* vertices, int n_frames, int n_verts,
                        const int* faces, int n_faces, int width, int height,
                        float xmag, float ymag, const float* light_dir_cam,
                        float light_intensity, const unsigned char* color,
                        float ambient, unsigned char* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next{0};
    auto worker = [&]() {
        while (true) {
            int f = next.fetch_add(1);
            if (f >= n_frames) break;
            render_frame(vertices + static_cast<size_t>(f) * n_verts * 3, n_verts,
                         faces, n_faces, width, height, xmag, ymag, light_dir_cam,
                         light_intensity, color, ambient,
                         out + static_cast<size_t>(f) * width * height * 3);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

}  // extern "C"
