// Native host ops for the com_tpu_torch input pipeline (the port's copy of
// com_tpu/ops/native/src/com_native.cpp; the C signatures are unchanged).
//
// The reference's CPU-side native code: the spconv Point2VoxelCPU3d
// voxelizer used by the data processor
// (pcdet/datasets/processor/data_processor.py:15-60) and the iou3d_nms CPU
// kernels (pcdet/ops/iou3d_nms/src/iou3d_cpu.cpp — rotated-box overlap via
// polygon clipping) used by the GT-Aug collision test.  Plain C ABI, loaded
// via ctypes.  The numpy versions in com_tpu_torch/ops/host_boxes.py and
// ops/voxelize.py are its oracle in the tests (same first-come voxel
// ordering, same cell formula); the library has no fallback.
//
// Built at first use by com_tpu_torch/ops/host_native.py (g++ -O3 -shared
// -fPIC -ffp-contract=off) into build/host/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Hard voxelization: first-come voxel order, per-voxel point cap.
// Returns the number of voxels written (<= max_voxels).
// ---------------------------------------------------------------------------
int64_t voxelize(
    const float* points,       // (n, f) row-major
    int64_t n, int64_t f,
    const float* pc_range,     // (6,)
    const float* voxel_size,   // (3,)
    int64_t max_points_per_voxel,
    int64_t max_voxels,
    float* voxels,             // (max_voxels, max_points_per_voxel, f) zeroed
    int32_t* coords,           // (max_voxels, 3) zyx
    int32_t* num_points)       // (max_voxels,)
{
    // float32 arithmetic exactly like the numpy path (ops/voxelize.py:60):
    // (p - range0) / voxel_size in f32, then floor — bit-equal cell ids.
    const float vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
    const int64_t nx = (int64_t)std::llround(((double)pc_range[3] - pc_range[0]) / vx);
    const int64_t ny = (int64_t)std::llround(((double)pc_range[4] - pc_range[1]) / vy);
    const int64_t nz = (int64_t)std::llround(((double)pc_range[5] - pc_range[2]) / vz);

    // Dense grid lookup when the grid is small enough (the pillar case:
    // 468x468x1); hash map for large 3D grids (SECOND 0.1 m voxels).
    const int64_t grid_cells = nx * ny * nz;
    const bool dense = grid_cells > 0 && grid_cells <= (int64_t)16 << 20;
    // thread_local reusable grid: a fresh assign() of up to 64 MB per call
    // would dominate the dataloader hot path; instead the buffer persists
    // per worker thread and only the cells TOUCHED this call are reset at
    // the end (O(num_voxels), see cleanup below)
    static thread_local std::vector<int32_t> grid_slot;
    std::unordered_map<int64_t, int64_t> voxel_of;
    if (dense) {
        if ((int64_t)grid_slot.size() < grid_cells)
            grid_slot.assign((size_t)grid_cells, -1);
    } else {
        voxel_of.reserve((size_t)std::min<int64_t>(n, max_voxels) * 2);
    }
    int64_t num_voxels = 0;

    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * f;
        int64_t ix = (int64_t)std::floor((float)((p[0] - pc_range[0]) / vx));
        int64_t iy = (int64_t)std::floor((float)((p[1] - pc_range[1]) / vy));
        int64_t iz = (int64_t)std::floor((float)((p[2] - pc_range[2]) / vz));
        if (ix < 0 || ix >= nx || iy < 0 || iy >= ny || iz < 0 || iz >= nz)
            continue;
        int64_t key = (iz * ny + iy) * nx + ix;
        int64_t slot;
        if (dense) {
            int32_t s = grid_slot[(size_t)key];
            if (s < 0) {
                if (num_voxels >= max_voxels) continue;
                slot = num_voxels++;
                grid_slot[(size_t)key] = (int32_t)slot;
                coords[slot * 3 + 0] = (int32_t)iz;
                coords[slot * 3 + 1] = (int32_t)iy;
                coords[slot * 3 + 2] = (int32_t)ix;
                num_points[slot] = 0;
            } else {
                slot = s;
            }
        } else {
            auto it = voxel_of.find(key);
            if (it == voxel_of.end()) {
                if (num_voxels >= max_voxels) continue;
                slot = num_voxels++;
                voxel_of.emplace(key, slot);
                coords[slot * 3 + 0] = (int32_t)iz;
                coords[slot * 3 + 1] = (int32_t)iy;
                coords[slot * 3 + 2] = (int32_t)ix;
                num_points[slot] = 0;
            } else {
                slot = it->second;
            }
        }
        int32_t cnt = num_points[slot];
        if (cnt < max_points_per_voxel) {
            std::memcpy(voxels + (slot * max_points_per_voxel + cnt) * f, p,
                        sizeof(float) * (size_t)f);
            num_points[slot] = cnt + 1;
        }
    }
    // Zero only the unwritten point slots of written voxels, so callers can
    // allocate the (max_voxels, T, f) buffer with np.empty instead of
    // paying a full zero-fill (60 MB at Waymo scale).
    for (int64_t s = 0; s < num_voxels; ++s) {
        int32_t cnt = num_points[s];
        if (cnt < max_points_per_voxel) {
            std::memset(voxels + (s * max_points_per_voxel + cnt) * f, 0,
                        sizeof(float) * (size_t)((max_points_per_voxel - cnt) * f));
        }
    }
    if (dense) {
        // reset only the touched cells so the thread_local grid is clean
        // for the next call without a full 64 MB refill
        for (int64_t s = 0; s < num_voxels; ++s) {
            const int64_t iz = coords[s * 3 + 0];
            const int64_t iy = coords[s * 3 + 1];
            const int64_t ix = coords[s * 3 + 2];
            grid_slot[(size_t)((iz * ny + iy) * nx + ix)] = -1;
        }
    }
    return num_voxels;
}

// ---------------------------------------------------------------------------
// Rotated BEV IoU via convex polygon intersection (Sutherland–Hodgman clip).
// boxes: (x, y, z, dx, dy, dz, heading)
// ---------------------------------------------------------------------------
struct P2 { double x, y; };

static void box_corners(const float* b, P2* c) {
    const double cx = b[0], cy = b[1], dx = b[3] / 2.0, dy = b[4] / 2.0;
    const double co = std::cos((double)b[6]), si = std::sin((double)b[6]);
    const double lx[4] = { dx, -dx, -dx, dx };
    const double ly[4] = { dy, dy, -dy, -dy };
    for (int i = 0; i < 4; ++i) {
        c[i].x = lx[i] * co - ly[i] * si + cx;
        c[i].y = lx[i] * si + ly[i] * co + cy;
    }
}

static double polygon_area(const P2* poly, int n) {
    double a = 0;
    for (int i = 0; i < n; ++i) {
        int j = (i + 1) % n;
        a += poly[i].x * poly[j].y - poly[j].x * poly[i].y;
    }
    return std::fabs(a) * 0.5;
}

static double intersection_area(const P2* ca, const P2* cb) {
    // clip polygon A against each edge of (convex, ccw) polygon B
    P2 poly[16], next_poly[16];
    int n = 4;
    std::memcpy(poly, ca, sizeof(P2) * 4);
    // ensure B is ccw
    P2 b[4];
    std::memcpy(b, cb, sizeof(P2) * 4);
    double cross = (b[1].x - b[0].x) * (b[2].y - b[1].y)
                 - (b[1].y - b[0].y) * (b[2].x - b[1].x);
    if (cross < 0) std::swap(b[1], b[3]);
    for (int e = 0; e < 4 && n > 0; ++e) {
        const P2 p1 = b[e], p2 = b[(e + 1) % 4];
        const double ex = p2.x - p1.x, ey = p2.y - p1.y;
        int m = 0;
        for (int i = 0; i < n; ++i) {
            const P2 cur = poly[i], nxt = poly[(i + 1) % n];
            // CCW polygon: interior is the left side of each edge (cross >= 0)
            const double dc = ex * (cur.y - p1.y) - ey * (cur.x - p1.x);
            const double dn = ex * (nxt.y - p1.y) - ey * (nxt.x - p1.x);
            const bool in_c = dc >= 0, in_n = dn >= 0;
            if (in_c) next_poly[m++] = cur;
            if (in_c != in_n) {
                const double t = dc / (dc - dn);
                next_poly[m].x = cur.x + t * (nxt.x - cur.x);
                next_poly[m].y = cur.y + t * (nxt.y - cur.y);
                ++m;
            }
        }
        n = m;
        std::memcpy(poly, next_poly, sizeof(P2) * (size_t)m);
    }
    return n >= 3 ? polygon_area(poly, n) : 0.0;
}

void boxes_iou_bev(const float* boxes_a, int64_t na,
                   const float* boxes_b, int64_t nb,
                   float* iou /* (na, nb) */)
{
    std::vector<P2> ca(4 * (size_t)na), cb(4 * (size_t)nb);
    for (int64_t i = 0; i < na; ++i) box_corners(boxes_a + i * 7, &ca[4 * (size_t)i]);
    for (int64_t j = 0; j < nb; ++j) box_corners(boxes_b + j * 7, &cb[4 * (size_t)j]);
    for (int64_t i = 0; i < na; ++i) {
        const double area_a = (double)boxes_a[i * 7 + 3] * boxes_a[i * 7 + 4];
        for (int64_t j = 0; j < nb; ++j) {
            const double area_b = (double)boxes_b[j * 7 + 3] * boxes_b[j * 7 + 4];
            const double inter = intersection_area(&ca[4 * (size_t)i], &cb[4 * (size_t)j]);
            const double u = area_a + area_b - inter;
            iou[i * nb + j] = (float)(u > 1e-8 ? inter / u : 0.0);
        }
    }
}

// ---------------------------------------------------------------------------
// Points in rotated boxes: mask (n, m) of containment.
// ---------------------------------------------------------------------------
void points_in_rbbox(const float* points, int64_t n, int64_t stride,
                     const float* boxes, int64_t m,
                     uint8_t* mask /* (n, m) */)
{
    for (int64_t j = 0; j < m; ++j) {
        const float* b = boxes + j * 7;
        const double co = std::cos(-(double)b[6]), si = std::sin(-(double)b[6]);
        const double hx = b[3] / 2.0, hy = b[4] / 2.0, hz = b[5] / 2.0;
        for (int64_t i = 0; i < n; ++i) {
            const double px = points[i * stride + 0] - b[0];
            const double py = points[i * stride + 1] - b[1];
            const double pz = points[i * stride + 2] - b[2];
            const double lx = px * co - py * si;
            const double ly = px * si + py * co;
            mask[i * m + j] =
                (std::fabs(lx) <= hx && std::fabs(ly) <= hy && std::fabs(pz) <= hz)
                    ? 1 : 0;
        }
    }
}

}  // extern "C"
