// Line Segment Detector equal to OpenCV's cv::createLineSegmentDetector()
// with its defaults (LSD_REFINE_STD, scale 0.8, sigma_scale 0.6, quant 2,
// ang_th 22.5, density_th 0.7, n_bins 1024): the same segments in the same
// order, float32 endpoints equal.
//
// Stages, each as OpenCV computes it:
//   * GaussianBlur of the 8-bit image with its bit-exact fixed-point
//     kernel (8 fraction bits, error-diffused rounding) and reflect-101
//     borders, then resize by the scale with INTER_LINEAR_EXACT (8-bit
//     fixed-point coefficients, 16-bit accumulation);
//   * 2x2 integer gradients, the norm sqrt((gx^2+gy^2)/4), the angle by
//     cv::fastAtan2 (a float polynomial in degrees), NOTDEF at or below
//     rho = quant / sin(ang_th);
//   * seeds: the norms in 1024 bins (int(norm * 1023 / max)), sorted
//     descending, equal bins in row-major order (a stable sort: OpenCV
//     5.0's seed order, which an unstable introsort misses on images
//     with many equal bins);
//   * region growing, region2rect, refine (density, reduced angle
//     tolerance, reduced radius), then +0.5 and division by the scale.
// The order of the double operations follows OpenCV's; build with
// -ffp-contract=off so no multiply-add is fused.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const double PI = 3.14159265358979323846;   // CV_PI
const double M_3_2_PI = (3 * PI) / 2;
const double M_2__PI = (2 * PI);
const double NOTDEF = -1024.0;
const double DEG_TO_RADS = PI / 180;
const unsigned char NOTUSED = 0;
const unsigned char USED = 1;

// cv::fastAtan2 (degrees, [0, 360))
const float atan2_p1 = 0.9997878412794807f * (float)(180 / PI);
const float atan2_p3 = -0.3258083974640975f * (float)(180 / PI);
const float atan2_p5 = 0.1555786518463281f * (float)(180 / PI);
const float atan2_p7 = -0.04432655554792128f * (float)(180 / PI);

float fast_atan2(float y, float x) {
  float ax = std::abs(x), ay = std::abs(y);
  float a, c, c2;
  if (ax >= ay) {
    c = ay / (ax + (float)DBL_EPSILON);
    c2 = c * c;
    a = (((atan2_p7 * c2 + atan2_p5) * c2 + atan2_p3) * c2 + atan2_p1) * c;
  } else {
    c = ax / (ay + (float)DBL_EPSILON);
    c2 = c * c;
    a = 90.f -
        (((atan2_p7 * c2 + atan2_p5) * c2 + atan2_p3) * c2 + atan2_p1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

int reflect101(int p, int len) {
  if (len == 1) return 0;
  while ((unsigned)p >= (unsigned)len) {
    if (p < 0)
      p = -p;
    else
      p = len - 1 - (p - len) - 1;
  }
  return p;
}

// The 8.8 fixed-point Gaussian kernel of OpenCV's bit-exact GaussianBlur
// (getGaussianKernelBitExact + getGaussianKernelFixedPoint_ED).
std::vector<int> fixed_gaussian_kernel(int n, double sigma) {
  int n2 = (n - 1) / 2;
  double scale2x = -0.125 / (sigma * sigma);
  std::vector<double> values(n2 + 1);
  double sum = 0;
  for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
    double t = std::exp(double(x * x) * scale2x);
    values[i] = t;
    sum += t;
  }
  sum *= 2;
  sum += 1;
  double mul1 = 1 / sum;
  std::vector<double> kern(n);
  for (int i = 0; i < n2; i++) {
    kern[i] = values[i] * mul1;
    kern[n - 1 - i] = kern[i];
  }
  kern[n2] = 1 * mul1;
  std::vector<int> out(n);
  double err = 0;
  int64_t total = 0;
  for (int i = 0; i < n2; i++) {
    double adj = kern[i] * 256.0 + err;
    int64_t v0 = (int64_t)std::nearbyint(adj);
    err = adj - double(v0);
    out[i] = out[n - 1 - i] = (int)v0;
    total += v0;
  }
  out[n2] = (int)(256 - 2 * total);
  return out;
}

}  // namespace

extern "C" {

// GaussianBlur(src, dst, (n, n), sigma) for 8-bit, BORDER_DEFAULT.
void lsd_gaussian_blur(const uint8_t* src, int h, int w, int n, double sigma,
                       uint8_t* dst) {
  if (h == 1 && w == 1) {
    dst[0] = src[0];
    return;
  }
  std::vector<int> k = fixed_gaussian_kernel(n, sigma);
  int nx = w == 1 ? 1 : n, ny = h == 1 ? 1 : n;
  std::vector<int> kx = nx == 1 ? std::vector<int>{256} : k;
  std::vector<int> ky = ny == 1 ? std::vector<int>{256} : k;
  int rx = nx / 2, ry = ny / 2;
  std::vector<uint32_t> rows((size_t)h * w);
  for (int y = 0; y < h; y++) {
    const uint8_t* s = src + (size_t)y * w;
    for (int x = 0; x < w; x++) {
      uint32_t acc = 0;
      for (int j = 0; j < nx; j++)
        acc += (uint32_t)kx[j] * s[reflect101(x + j - rx, w)];
      rows[(size_t)y * w + x] = acc;
    }
  }
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      uint32_t acc = 0;
      for (int i = 0; i < ny; i++)
        acc += (uint32_t)ky[i] * rows[(size_t)reflect101(y + i - ry, h) * w + x];
      uint32_t v = (acc + 32768) >> 16;
      dst[(size_t)y * w + x] = (uint8_t)(v > 255 ? 255 : v);
    }
  }
}

}  // extern "C"

namespace {

// INTER_LINEAR_EXACT coefficients along one axis: offset and the 8.8
// fixed-point weight of the second tap (-1: clamped to the first sample,
// -2: clamped to the last).
void linear_exact_coeffs(int src_size, int dst_size, double inv_scale,
                         std::vector<int>& ofs, std::vector<int>& c1) {
  double scale = 1.0 / inv_scale;
  ofs.assign(dst_size, 0);
  c1.assign(dst_size, 0);
  for (int d = 0; d < dst_size; d++) {
    double f = scale * (double(d) + 0.5) - 0.5;
    int i = (int)std::floor(f);
    if (i >= 0 && src_size > 1) {
      if (i < src_size - 1) {
        ofs[d] = i;
        c1[d] = (int)std::nearbyint((f - double(i)) * 256.0);
      } else {
        ofs[d] = src_size - 1;
        c1[d] = -2;
      }
    } else {
      ofs[d] = 0;
      c1[d] = -1;
    }
  }
}

}  // namespace

extern "C" {

// resize(src, dst, (dw, dh), interpolation=INTER_LINEAR_EXACT) for 8-bit,
// with the scale factors as given to cv::resize (fx, fy).
void lsd_resize_linear_exact(const uint8_t* src, int h, int w, uint8_t* dst,
                             int dh, int dw, double fx, double fy) {
  std::vector<int> xo, xc, yo, yc;
  linear_exact_coeffs(w, dw, fx, xo, xc);
  linear_exact_coeffs(h, dh, fy, yo, yc);
  // horizontal pass of a source row, 8 fraction bits
  auto hrow = [&](int y, std::vector<uint32_t>& out) {
    const uint8_t* s = src + (size_t)y * w;
    out.resize(dw);
    for (int d = 0; d < dw; d++) {
      if (xc[d] < 0) {
        out[d] = (uint32_t)s[xo[d]] << 8;
      } else {
        uint32_t c1 = (uint32_t)xc[d], c0 = 256 - c1;
        out[d] = c0 * s[xo[d]] + c1 * s[xo[d] + 1];
      }
    }
  };
  std::vector<uint32_t> r0, r1;
  for (int d = 0; d < dh; d++) {
    uint8_t* o = dst + (size_t)d * dw;
    if (yc[d] < 0) {
      hrow(yo[d], r0);
      for (int x = 0; x < dw; x++) o[x] = (uint8_t)((r0[x] + 128) >> 8);
    } else {
      hrow(yo[d], r0);
      hrow(yo[d] + 1, r1);
      uint32_t c1 = (uint32_t)yc[d], c0 = 256 - c1;
      for (int x = 0; x < dw; x++) {
        uint32_t v = (c0 * r0[x] + c1 * r1[x] + 32768) >> 16;
        o[x] = (uint8_t)(v > 255 ? 255 : v);
      }
    }
  }
}

}  // extern "C"

namespace {

struct RegionPoint {
  int x, y;
  unsigned char* used;
  double angle, modgrad;
};

struct NormPoint {
  int x, y;
  int norm;
};

bool compare_norm(const NormPoint& a, const NormPoint& b) {
  return a.norm > b.norm;
}

struct Rect {
  double x1, y1, x2, y2, width, x, y, theta, dx, dy, prec, p;
};

inline double dist_sq(double x1, double y1, double x2, double y2) {
  return (x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1);
}

inline double dist(double x1, double y1, double x2, double y2) {
  return std::sqrt(dist_sq(x1, y1, x2, y2));
}

inline double angle_diff_signed(double a, double b) {
  double diff = a - b;
  while (diff <= -PI) diff += M_2__PI;
  while (diff > PI) diff -= M_2__PI;
  return diff;
}

inline double angle_diff(double a, double b) {
  return std::fabs(angle_diff_signed(a, b));
}

class Detector {
 public:
  Detector(const uint8_t* img, int h, int w) : img_(img), h_(h), w_(w) {}

  void run(double scale, std::vector<float>& out) {
    const double quant = 2.0, ang_th = 22.5, density_th = 0.7;
    const int n_bins = 1024;
    const double prec = PI * ang_th / 180;
    const double p = ang_th / 180;
    const double rho = quant / std::sin(prec);
    ll_angle(rho, n_bins);
    const double log_nt = 5 * (std::log10(double(w_)) + std::log10(double(h_))) /
                              2 + std::log10(11.0);
    const size_t min_reg_size = size_t(-log_nt / std::log10(p));
    used_.assign((size_t)w_ * h_, NOTUSED);
    std::vector<RegionPoint> reg;
    for (size_t i = 0; i < ordered_.size(); ++i) {
      int x = ordered_[i].x, y = ordered_[i].y;
      if (used_[idx(x, y)] == NOTUSED && angles_[idx(x, y)] != NOTDEF) {
        double reg_angle;
        region_grow(x, y, reg, reg_angle, prec);
        if (reg.size() < min_reg_size) continue;
        Rect rec;
        region2rect(reg, reg_angle, prec, p, rec);
        if (!refine(reg, reg_angle, prec, p, rec, density_th)) continue;
        rec.x1 += 0.5;
        rec.y1 += 0.5;
        rec.x2 += 0.5;
        rec.y2 += 0.5;
        if (scale != 1) {
          rec.x1 /= scale;
          rec.y1 /= scale;
          rec.x2 /= scale;
          rec.y2 /= scale;
        }
        out.push_back(float(rec.x1));
        out.push_back(float(rec.y1));
        out.push_back(float(rec.x2));
        out.push_back(float(rec.y2));
      }
    }
  }

 private:
  const uint8_t* img_;
  int h_, w_;
  std::vector<double> angles_, modgrad_;
  std::vector<unsigned char> used_;
  std::vector<NormPoint> ordered_;

  size_t idx(int x, int y) const { return (size_t)y * w_ + x; }

  void ll_angle(double threshold, int n_bins) {
    angles_.assign((size_t)w_ * h_, 0.0);
    modgrad_.assign((size_t)w_ * h_, 0.0);
    for (int x = 0; x < w_; x++) angles_[idx(x, h_ - 1)] = NOTDEF;
    for (int y = 0; y < h_; y++) angles_[idx(w_ - 1, y)] = NOTDEF;
    double max_grad = -1;
    for (int y = 0; y < h_ - 1; ++y) {
      const uint8_t* row = img_ + (size_t)y * w_;
      const uint8_t* next = img_ + (size_t)(y + 1) * w_;
      for (int x = 0; x < w_ - 1; ++x) {
        int DA = next[x + 1] - row[x];
        int BC = row[x + 1] - next[x];
        int gx = DA + BC;
        int gy = DA - BC;
        double norm = std::sqrt((gx * gx + gy * gy) / 4.0);
        modgrad_[idx(x, y)] = norm;
        if (norm <= threshold) {
          angles_[idx(x, y)] = NOTDEF;
        } else {
          angles_[idx(x, y)] = fast_atan2(float(gx), float(-gy)) * DEG_TO_RADS;
          if (norm > max_grad) max_grad = norm;
        }
      }
    }
    double bin_coef = (max_grad > 0) ? double(n_bins - 1) / max_grad : 0;
    ordered_.clear();
    ordered_.reserve((size_t)(w_ - 1 > 0 ? w_ - 1 : 0) *
                     (h_ - 1 > 0 ? h_ - 1 : 0));
    for (int y = 0; y < h_ - 1; ++y)
      for (int x = 0; x < w_ - 1; ++x) {
        NormPoint pt;
        pt.x = x;
        pt.y = y;
        pt.norm = int(modgrad_[idx(x, y)] * bin_coef);
        ordered_.push_back(pt);
      }
    // equal bins keep their row-major order
    std::stable_sort(ordered_.begin(), ordered_.end(), compare_norm);
  }

  bool is_aligned(int x, int y, double theta, double prec) const {
    if (x < 0 || y < 0 || x >= w_ || y >= h_) return false;
    double a = angles_[idx(x, y)];
    if (a == NOTDEF) return false;
    double n_theta = theta - a;
    if (n_theta < 0) n_theta = -n_theta;
    if (n_theta > M_3_2_PI) {
      n_theta -= M_2__PI;
      if (n_theta < 0) n_theta = -n_theta;
    }
    return n_theta <= prec;
  }

  void region_grow(int sx, int sy, std::vector<RegionPoint>& reg,
                   double& reg_angle, double prec) {
    reg.clear();
    RegionPoint seed;
    seed.x = sx;
    seed.y = sy;
    seed.used = &used_[idx(sx, sy)];
    reg_angle = angles_[idx(sx, sy)];
    seed.angle = reg_angle;
    seed.modgrad = modgrad_[idx(sx, sy)];
    reg.push_back(seed);
    float sumdx = float(std::cos(reg_angle));
    float sumdy = float(std::sin(reg_angle));
    *seed.used = USED;
    for (size_t i = 0; i < reg.size(); i++) {
      const int rx = reg[i].x, ry = reg[i].y;
      int xx_min = std::max(rx - 1, 0), xx_max = std::min(rx + 1, w_ - 1);
      int yy_min = std::max(ry - 1, 0), yy_max = std::min(ry + 1, h_ - 1);
      for (int yy = yy_min; yy <= yy_max; ++yy) {
        for (int xx = xx_min; xx <= xx_max; ++xx) {
          unsigned char& is_used = used_[idx(xx, yy)];
          if (is_used != USED && is_aligned(xx, yy, reg_angle, prec)) {
            const double angle = angles_[idx(xx, yy)];
            is_used = USED;
            RegionPoint rp;
            rp.x = xx;
            rp.y = yy;
            rp.used = &is_used;
            rp.modgrad = modgrad_[idx(xx, yy)];
            rp.angle = angle;
            reg.push_back(rp);
            // float overloads of cos/sin, as OpenCV's unqualified calls
            // on a float argument resolve to
            sumdx += std::cos(float(angle));
            sumdy += std::sin(float(angle));
            reg_angle = fast_atan2(sumdy, sumdx) * DEG_TO_RADS;
          }
        }
      }
    }
  }

  double get_theta(const std::vector<RegionPoint>& reg, double x, double y,
                   double reg_angle, double prec) const {
    double Ixx = 0.0, Iyy = 0.0, Ixy = 0.0;
    for (size_t i = 0; i < reg.size(); ++i) {
      const double regx = reg[i].x;
      const double regy = reg[i].y;
      const double weight = reg[i].modgrad;
      double dx = regx - x;
      double dy = regy - y;
      Ixx += dy * dy * weight;
      Iyy += dx * dx * weight;
      Ixy -= dx * dy * weight;
    }
    double lambda =
        0.5 * (Ixx + Iyy - std::sqrt((Ixx - Iyy) * (Ixx - Iyy) + 4.0 * Ixy * Ixy));
    double theta = (std::fabs(Ixx) > std::fabs(Iyy))
                       ? double(fast_atan2(float(lambda - Ixx), float(Ixy)))
                       : double(fast_atan2(float(Ixy), float(lambda - Iyy)));
    theta *= DEG_TO_RADS;
    if (angle_diff(theta, reg_angle) > prec) theta += PI;
    return theta;
  }

  void region2rect(const std::vector<RegionPoint>& reg, double reg_angle,
                   double prec, double p, Rect& rec) const {
    double x = 0, y = 0, sum = 0;
    for (size_t i = 0; i < reg.size(); ++i) {
      const double weight = reg[i].modgrad;
      x += double(reg[i].x) * weight;
      y += double(reg[i].y) * weight;
      sum += weight;
    }
    x /= sum;
    y /= sum;
    double theta = get_theta(reg, x, y, reg_angle, prec);
    double dx = std::cos(theta);
    double dy = std::sin(theta);
    double l_min = 0, l_max = 0, w_min = 0, w_max = 0;
    for (size_t i = 0; i < reg.size(); ++i) {
      double regdx = double(reg[i].x) - x;
      double regdy = double(reg[i].y) - y;
      double l = regdx * dx + regdy * dy;
      double w = -regdx * dy + regdy * dx;
      if (l > l_max)
        l_max = l;
      else if (l < l_min)
        l_min = l;
      if (w > w_max)
        w_max = w;
      else if (w < w_min)
        w_min = w;
    }
    rec.x1 = x + l_min * dx;
    rec.y1 = y + l_min * dy;
    rec.x2 = x + l_max * dx;
    rec.y2 = y + l_max * dy;
    rec.width = w_max - w_min;
    rec.x = x;
    rec.y = y;
    rec.theta = theta;
    rec.dx = dx;
    rec.dy = dy;
    rec.prec = prec;
    rec.p = p;
    if (rec.width < 1.0) rec.width = 1.0;
  }

  bool refine(std::vector<RegionPoint>& reg, double reg_angle, double prec,
              double p, Rect& rec, double density_th) {
    double density =
        double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
    if (density >= density_th) return true;
    double xc = double(reg[0].x);
    double yc = double(reg[0].y);
    const double ang_c = reg[0].angle;
    double sum = 0, s_sum = 0;
    int n = 0;
    for (size_t i = 0; i < reg.size(); ++i) {
      *(reg[i].used) = NOTUSED;
      if (dist(xc, yc, reg[i].x, reg[i].y) < rec.width) {
        const double angle = reg[i].angle;
        double ang_d = angle_diff_signed(angle, ang_c);
        sum += ang_d;
        s_sum += ang_d * ang_d;
        ++n;
      }
    }
    double mean_angle = sum / double(n);
    double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean_angle * sum) / double(n) +
                                 mean_angle * mean_angle);
    region_grow(reg[0].x, reg[0].y, reg, reg_angle, tau);
    if (reg.size() < 2) return false;
    region2rect(reg, reg_angle, prec, p, rec);
    density =
        double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
    if (density < density_th)
      return reduce_region_radius(reg, reg_angle, prec, p, rec, density,
                                  density_th);
    return true;
  }

  bool reduce_region_radius(std::vector<RegionPoint>& reg, double reg_angle,
                            double prec, double p, Rect& rec, double density,
                            double density_th) {
    double xc = double(reg[0].x);
    double yc = double(reg[0].y);
    double rad_sq1 = dist_sq(xc, yc, rec.x1, rec.y1);
    double rad_sq2 = dist_sq(xc, yc, rec.x2, rec.y2);
    double rad_sq = rad_sq1 > rad_sq2 ? rad_sq1 : rad_sq2;
    while (density < density_th) {
      rad_sq *= 0.75 * 0.75;
      for (size_t i = 0; i < reg.size(); ++i) {
        if (dist_sq(xc, yc, double(reg[i].x), double(reg[i].y)) > rad_sq) {
          *(reg[i].used) = NOTUSED;
          std::swap(reg[i], reg[reg.size() - 1]);
          reg.pop_back();
          --i;
        }
      }
      if (reg.size() < 2) return false;
      region2rect(reg, reg_angle, prec, p, rec);
      density = double(reg.size()) /
                (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
    }
    return true;
  }
};

}  // namespace

extern "C" {
// Detects the segments of an 8-bit image [h, w] as OpenCV's default LSD
// does at `scale` (0.8 by default; 1 skips the blur and the resize).
// Writes up to `cap` segments (x1, y1, x2, y2 float32) into `out` and
// returns the number found (more than `cap`: call again with more room),
// or -1 for an image too small to blur and resize.
int lsd_detect(const uint8_t* img, int h, int w, double scale, float* out,
               int cap) {
  std::vector<uint8_t> scaled;
  const uint8_t* src = img;
  int sh = h, sw = w;
  if (scale != 1) {
    const double sigma_scale = 0.6;
    const double sigma = (scale < 1) ? (sigma_scale / scale) : sigma_scale;
    const double sprec = 3;
    const unsigned int hk =
        (unsigned int)(std::ceil(sigma * std::sqrt(2 * sprec * std::log(10.0))));
    std::vector<uint8_t> blurred((size_t)h * w);
    lsd_gaussian_blur(img, h, w, 1 + 2 * hk, sigma, blurred.data());
    sw = (int)std::nearbyint(w * scale);
    sh = (int)std::nearbyint(h * scale);
    if (sw <= 0 || sh <= 0) return -1;
    scaled.resize((size_t)sh * sw);
    lsd_resize_linear_exact(blurred.data(), h, w, scaled.data(), sh, sw,
                            scale, scale);
    src = scaled.data();
  }
  std::vector<float> segs;
  Detector det(src, sh, sw);
  det.run(scale, segs);
  int n = (int)(segs.size() / 4);
  if (n <= cap) std::memcpy(out, segs.data(), segs.size() * sizeof(float));
  return n;
}

}  // extern "C"
