// Line Segment Detector on the host (a helper of utility/vanishing_point.py,
// not a device kernel; it replaces no TPU kernel).
//
// The JAX package finds line segments with cv2.createLineSegmentDetector()
// at its defaults. This is that detector as OpenCV's imgproc/lsd.cpp runs
// it (von Gioi et al.'s LSD with OpenCV's changes), so that the segments
// come out equal and in the same order: the vanishing point's RANSAC picks
// segments by index. The defaults: refine LSD_REFINE_STD (no NFA test, so
// log_eps is unused), scale 0.8, sigma_scale 0.6, quant 2.0, ang_th 22.5,
// density_th 0.7, n_bins 1024. What OpenCV does that the paper does not:
//   - the 8-bit image blurred by GaussianBlur (7x7, sigma 0.6 / 0.8,
//     BORDER_REFLECT_101) and resized by 0.8 (INTER_LINEAR_EXACT), both in
//     OpenCV's bit-exact 8-bit fixed point, then converted to double;
//   - gradient angles from cv::fastAtan2 (degrees, a float polynomial),
//     times pi/180;
//   - the pseudo-ordering by 1024 gradient-norm bins, highest first, each
//     bin in raster order (the paper's linked lists);
//   - the region's mean angle from float sums of cosf/sinf and fastAtan2.
// Region growing is sequential, so it stays on the host; the caller's
// math on the segments runs in torch.
//
// ingp_lsd_detect returns the segment count n and writes min(n, cap)
// segments (x1, y1, x2, y2) as floats; the caller retries with a larger
// cap when n > cap.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const double kPi = 3.1415926535897932384626433832795;   // CV_PI
const double k3_2Pi = (3 * kPi) / 2;
const double k2Pi = 2 * kPi;
const double kNotDef = -1024.0;
const double kDegToRad = kPi / 180;
const uint8_t kNotUsed = 0, kUsed = 1;

// cv::createLineSegmentDetector()'s defaults
const double kScale = 0.8, kQuant = 2.0, kAngTh = 22.5, kDensityTh = 0.7;
const int kBins = 1024;
// cv::getGaussianKernel(7, 0.6 / 0.8, CV_64F), OpenCV's bit-exact kernel
// (its soft-float exp rounds two entries otherwise than libm's); the 8-bit
// blur takes it in 8-bit fixed point (gaussian_q8)
const double kGauss[7] = {0x1.763496d347539p-13, 0x1.f1e23259cfdc7p-7,
                          0x1.bfd7fac1bd5a9p-3,  0x1.10562a79786afp-1,
                          0x1.bfd7fac1bd5a9p-3,  0x1.f1e23259cfdc7p-7,
                          0x1.763496d347539p-13};

// cv::fastAtan2: degrees in [0, 360)
const float kP1 = 0.9997878412794807f * (float)(180 / kPi);
const float kP3 = -0.3258083974640975f * (float)(180 / kPi);
const float kP5 = 0.1555786518463281f * (float)(180 / kPi);
const float kP7 = -0.04432655554792128f * (float)(180 / kPi);

float fast_atan2(float y, float x) {
  float ax = std::fabs(x), ay = std::fabs(y), a, c, c2;
  if (ax >= ay) {
    c = ay / (ax + (float)2.220446049250313e-16);
    c2 = c * c;
    a = (((kP7 * c2 + kP5) * c2 + kP3) * c2 + kP1) * c;
  } else {
    c = ax / (ay + (float)2.220446049250313e-16);
    c2 = c * c;
    a = 90.f - (((kP7 * c2 + kP5) * c2 + kP3) * c2 + kP1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * n - 2 - i;
  return i;
}

// The kernel in 8 fraction bits as OpenCV's fixed-point GaussianBlur
// rounds it: error diffusion from the outer taps in, the centre taking what
// makes the sum 256 ({0, 4, 56, 136, 56, 4, 0})
void gaussian_q8(int64_t q[7]) {
  double err = 0;
  int64_t sum = 0;
  for (int i = 0; i < 3; ++i) {
    double adj = kGauss[i] * 256 + err;
    int64_t v = std::llrint(adj);
    err = adj - (double)v;
    q[i] = q[6 - i] = v;
    sum += v;
  }
  q[3] = 256 - 2 * sum;
}

// cv::GaussianBlur of an 8-bit image, (7, 7), sigma 0.75: rows then
// columns in exact fixed point (Q8.8, then Q16.16), rounded once
std::vector<uint8_t> gaussian_blur_u8(const uint8_t* src, int h, int w) {
  int64_t q[7];
  gaussian_q8(q);
  std::vector<int64_t> rows((size_t)h * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int64_t acc = 0;
      for (int k = 0; k < 7; ++k)
        acc += q[k] * src[(size_t)y * w + reflect101(x + k - 3, w)];
      rows[(size_t)y * w + x] = acc;
    }
  std::vector<uint8_t> out((size_t)h * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int64_t acc = 0;
      for (int k = 0; k < 7; ++k)
        acc += q[k] * rows[(size_t)reflect101(y + k - 3, h) * w + x];
      out[(size_t)y * w + x] = (uint8_t)std::min<int64_t>((acc + 0x8000) >> 16,
                                                          255);
    }
  return out;
}

// one axis of resize's bit-exact bilinear map for 8-bit images: source
// index and the next one's weight in 8 fraction bits, at
// (d + 0.5) / 0.8 - 0.5; positions left of 0 take the first sample
// (d < lo), from the last sample on the last (d >= hi)
struct Taps {
  std::vector<int> at;
  std::vector<int64_t> frac;
  int lo = 0, hi = 0;
};

Taps exact_taps(int n, int dn) {
  Taps t;
  t.at.assign(dn, 0);
  t.frac.assign(dn, 0);
  t.hi = dn;
  const double scale = 1. / kScale;
  for (int d = 0; d < dn; ++d) {
    double f = scale * (d + 0.5) - 0.5;
    int i = (int)std::floor(f);
    if (i >= 0 && n > 1) {
      if (i < n - 1) {
        t.at[d] = i;
        t.frac[d] = std::llrint((f - i) * 256);
      } else {
        t.at[d] = n - 1;
        t.hi = std::min(t.hi, d);
      }
    } else {
      t.lo = std::max(t.lo, d + 1);
    }
  }
  return t;
}

// cv::resize(..., fx = fy = 0.8, INTER_LINEAR_EXACT) of an 8-bit image
std::vector<uint8_t> resize_exact_u8(const std::vector<uint8_t>& src, int h,
                                     int w, int dh, int dw) {
  Taps tx = exact_taps(w, dw), ty = exact_taps(h, dh);
  std::vector<int64_t> hrow((size_t)h * dw);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = &src[(size_t)y * w];
    for (int d = 0; d < dw; ++d) {
      int64_t v;
      if (d < tx.lo) v = (int64_t)s[0] << 8;
      else if (d < tx.hi)
        v = (256 - tx.frac[d]) * s[tx.at[d]] + tx.frac[d] * s[tx.at[d] + 1];
      else v = (int64_t)s[tx.at[dw - 1]] << 8;
      hrow[(size_t)y * dw + d] = v;
    }
  }
  std::vector<uint8_t> out((size_t)dh * dw);
  for (int d = 0; d < dh; ++d)
    for (int x = 0; x < dw; ++x) {
      int64_t v;
      if (d < ty.lo || d >= ty.hi) {
        int row = d < ty.lo ? 0 : ty.at[d];
        v = (hrow[(size_t)row * dw + x] + 128) >> 8;
      } else {
        v = ((256 - ty.frac[d]) * hrow[(size_t)ty.at[d] * dw + x] +
             ty.frac[d] * hrow[(size_t)(ty.at[d] + 1) * dw + x] + 0x8000) >> 16;
      }
      out[(size_t)d * dw + x] = (uint8_t)std::min<int64_t>(v, 255);
    }
  return out;
}

// the image the detector works on: blurred and resized in 8 bits, then
// converted to double
std::vector<double> scaled_image(const uint8_t* img, int h, int w, int* dh,
                                 int* dw) {
  *dh = (int)std::lrint(h * kScale);
  *dw = (int)std::lrint(w * kScale);
  std::vector<uint8_t> s = resize_exact_u8(gaussian_blur_u8(img, h, w), h, w,
                                           *dh, *dw);
  return std::vector<double>(s.begin(), s.end());
}

struct RegionPoint {
  int x, y;
  uint8_t* used;
  double angle, modgrad;
};

// a pixel and its gradient norm's bin
struct NormPoint {
  int x, y, norm;
};

struct Rect {
  double x1, y1, x2, y2, width, x, y, theta, dx, dy, prec, p;
};

double dist_sq(double x1, double y1, double x2, double y2) {
  return (x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1);
}

double dist(double x1, double y1, double x2, double y2) {
  return std::sqrt(dist_sq(x1, y1, x2, y2));
}

double angle_diff_signed(double a, double b) {
  double diff = a - b;
  while (diff <= -kPi) diff += k2Pi;
  while (diff > kPi) diff -= k2Pi;
  return diff;
}

double angle_diff(double a, double b) {
  return std::fabs(angle_diff_signed(a, b));
}

class Lsd {
 public:
  Lsd(const uint8_t* img, int h, int w) {
    image_ = scaled_image(img, h, w, &height_, &width_);
  }

  void detect(std::vector<float>* lines) {
    const double prec = kPi * kAngTh / 180;
    const double p = kAngTh / 180;
    const double rho = kQuant / std::sin(prec);
    ll_angle(rho);
    const double log_nt = 5 * (std::log10((double)width_) +
                               std::log10((double)height_)) / 2 +
                          std::log10(11.0);
    const size_t min_reg_size = (size_t)(-log_nt / std::log10(p));
    used_.assign((size_t)width_ * height_, kNotUsed);
    std::vector<RegionPoint> reg;
    for (const NormPoint& pt : ordered_) {
      size_t at = (size_t)pt.y * width_ + pt.x;
      if (used_[at] != kNotUsed || angles_[at] == kNotDef) continue;
      double reg_angle;
      region_grow(pt.x, pt.y, &reg, &reg_angle, prec);
      if (reg.size() < min_reg_size) continue;
      Rect rec;
      region2rect(reg, reg_angle, prec, p, &rec);
      if (!refine(&reg, reg_angle, prec, p, &rec)) continue;
      rec.x1 += 0.5; rec.y1 += 0.5; rec.x2 += 0.5; rec.y2 += 0.5;
      rec.x1 /= kScale; rec.y1 /= kScale; rec.x2 /= kScale; rec.y2 /= kScale;
      lines->push_back((float)rec.x1);
      lines->push_back((float)rec.y1);
      lines->push_back((float)rec.x2);
      lines->push_back((float)rec.y2);
    }
  }

 private:
  void ll_angle(double threshold) {
    const int w = width_, h = height_;
    angles_.assign((size_t)w * h, 0.0);
    modgrad_.assign((size_t)w * h, 0.0);
    for (int x = 0; x < w; ++x) angles_[(size_t)(h - 1) * w + x] = kNotDef;
    for (int y = 0; y < h; ++y) angles_[(size_t)y * w + w - 1] = kNotDef;
    double max_grad = -1;
    for (int y = 0; y < h - 1; ++y)
      for (int x = 0; x < w - 1; ++x) {
        const double* row = &image_[(size_t)y * w];
        const double* next = &image_[(size_t)(y + 1) * w];
        double da = next[x + 1] - row[x];
        double bc = row[x + 1] - next[x];
        double gx = da + bc, gy = da - bc;
        double norm = std::sqrt((gx * gx + gy * gy) / 4);
        size_t at = (size_t)y * w + x;
        modgrad_[at] = norm;
        if (norm <= threshold) {
          angles_[at] = kNotDef;
        } else {
          angles_[at] = fast_atan2((float)gx, (float)-gy) * kDegToRad;
          if (norm > max_grad) max_grad = norm;
        }
      }
    double bin_coef = max_grad > 0 ? double(kBins - 1) / max_grad : 0;
    ordered_.clear();
    for (int y = 0; y < h - 1; ++y)
      for (int x = 0; x < w - 1; ++x)
        ordered_.push_back({x, y, (int)(modgrad_[(size_t)y * w + x] * bin_coef)});
    std::stable_sort(ordered_.begin(), ordered_.end(),
              [](const NormPoint& a, const NormPoint& b) {
                return a.norm > b.norm;
              });
  }

  bool aligned(int x, int y, double theta, double prec) const {
    if (x < 0 || y < 0 || x >= width_ || y >= height_) return false;
    double a = angles_[(size_t)y * width_ + x];
    if (a == kNotDef) return false;
    double n_theta = theta - a;
    if (n_theta < 0) n_theta = -n_theta;
    if (n_theta > k3_2Pi) {
      n_theta -= k2Pi;
      if (n_theta < 0) n_theta = -n_theta;
    }
    return n_theta <= prec;
  }

  void region_grow(int sx, int sy, std::vector<RegionPoint>* reg,
                   double* reg_angle, double prec) {
    reg->clear();
    size_t at = (size_t)sy * width_ + sx;
    *reg_angle = angles_[at];
    reg->push_back({sx, sy, &used_[at], *reg_angle, modgrad_[at]});
    float sumdx = (float)std::cos(*reg_angle);
    float sumdy = (float)std::sin(*reg_angle);
    used_[at] = kUsed;
    for (size_t i = 0; i < reg->size(); ++i) {
      const int rx = (*reg)[i].x, ry = (*reg)[i].y;
      int xx_min = std::max(rx - 1, 0), xx_max = std::min(rx + 1, width_ - 1);
      int yy_min = std::max(ry - 1, 0), yy_max = std::min(ry + 1, height_ - 1);
      for (int yy = yy_min; yy <= yy_max; ++yy)
        for (int xx = xx_min; xx <= xx_max; ++xx) {
          size_t j = (size_t)yy * width_ + xx;
          if (used_[j] != kUsed && aligned(xx, yy, *reg_angle, prec)) {
            double angle = angles_[j];
            used_[j] = kUsed;
            reg->push_back({xx, yy, &used_[j], angle, modgrad_[j]});
            sumdx += std::cos((float)angle);
            sumdy += std::sin((float)angle);
            *reg_angle = fast_atan2(sumdy, sumdx) * kDegToRad;
          }
        }
    }
  }

  double get_theta(const std::vector<RegionPoint>& reg, double x, double y,
                   double reg_angle, double prec) const {
    double ixx = 0.0, iyy = 0.0, ixy = 0.0;
    for (const RegionPoint& r : reg) {
      const double wgt = r.modgrad;
      double dx = (double)r.x - x, dy = (double)r.y - y;
      ixx += dy * dy * wgt;
      iyy += dx * dx * wgt;
      ixy -= dx * dy * wgt;
    }
    double lambda = 0.5 * (ixx + iyy - std::sqrt((ixx - iyy) * (ixx - iyy) +
                                                 4.0 * ixy * ixy));
    double theta = std::fabs(ixx) > std::fabs(iyy)
                       ? (double)fast_atan2((float)(lambda - ixx), (float)ixy)
                       : (double)fast_atan2((float)ixy, (float)(lambda - iyy));
    theta *= kDegToRad;
    if (angle_diff(theta, reg_angle) > prec) theta += kPi;
    return theta;
  }

  void region2rect(const std::vector<RegionPoint>& reg, double reg_angle,
                   double prec, double p, Rect* rec) const {
    double x = 0, y = 0, sum = 0;
    for (const RegionPoint& r : reg) {
      x += (double)r.x * r.modgrad;
      y += (double)r.y * r.modgrad;
      sum += r.modgrad;
    }
    x /= sum;
    y /= sum;
    double theta = get_theta(reg, x, y, reg_angle, prec);
    double dx = std::cos(theta), dy = std::sin(theta);
    double l_min = 0, l_max = 0, w_min = 0, w_max = 0;
    for (const RegionPoint& r : reg) {
      double rdx = (double)r.x - x, rdy = (double)r.y - y;
      double l = rdx * dx + rdy * dy;
      double wd = -rdx * dy + rdy * dx;
      if (l > l_max) l_max = l;
      else if (l < l_min) l_min = l;
      if (wd > w_max) w_max = wd;
      else if (wd < w_min) w_min = wd;
    }
    rec->x1 = x + l_min * dx;
    rec->y1 = y + l_min * dy;
    rec->x2 = x + l_max * dx;
    rec->y2 = y + l_max * dy;
    rec->width = w_max - w_min;
    rec->x = x;
    rec->y = y;
    rec->theta = theta;
    rec->dx = dx;
    rec->dy = dy;
    rec->prec = prec;
    rec->p = p;
    if (rec->width < 1.0) rec->width = 1.0;
  }

  bool refine(std::vector<RegionPoint>* reg, double reg_angle, double prec,
              double p, Rect* rec) {
    double density = (double)reg->size() /
                     (dist(rec->x1, rec->y1, rec->x2, rec->y2) * rec->width);
    if (density >= kDensityTh) return true;
    double xc = (double)(*reg)[0].x, yc = (double)(*reg)[0].y;
    const double ang_c = (*reg)[0].angle;
    double sum = 0, s_sum = 0;
    int n = 0;
    for (RegionPoint& r : *reg) {
      *r.used = kNotUsed;
      if (dist(xc, yc, r.x, r.y) < rec->width) {
        double ang_d = angle_diff_signed(r.angle, ang_c);
        sum += ang_d;
        s_sum += ang_d * ang_d;
        ++n;
      }
    }
    double mean_angle = sum / (double)n;
    double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean_angle * sum) / (double)n +
                                 mean_angle * mean_angle);
    int sx = (*reg)[0].x, sy = (*reg)[0].y;
    region_grow(sx, sy, reg, &reg_angle, tau);
    if (reg->size() < 2) return false;
    region2rect(*reg, reg_angle, prec, p, rec);
    density = (double)reg->size() /
              (dist(rec->x1, rec->y1, rec->x2, rec->y2) * rec->width);
    if (density < kDensityTh)
      return reduce_region_radius(reg, reg_angle, prec, p, rec, density);
    return true;
  }

  bool reduce_region_radius(std::vector<RegionPoint>* reg, double reg_angle,
                            double prec, double p, Rect* rec,
                            double density) {
    double xc = (double)(*reg)[0].x, yc = (double)(*reg)[0].y;
    double rad1 = dist_sq(xc, yc, rec->x1, rec->y1);
    double rad2 = dist_sq(xc, yc, rec->x2, rec->y2);
    double rad = rad1 > rad2 ? rad1 : rad2;
    while (density < kDensityTh) {
      rad *= 0.75 * 0.75;
      for (size_t i = 0; i < reg->size(); ++i) {
        if (dist_sq(xc, yc, (double)(*reg)[i].x, (double)(*reg)[i].y) > rad) {
          *(*reg)[i].used = kNotUsed;
          std::swap((*reg)[i], (*reg)[reg->size() - 1]);
          reg->pop_back();
          --i;
        }
      }
      if (reg->size() < 2) return false;
      region2rect(*reg, reg_angle, prec, p, rec);
      density = (double)reg->size() /
                (dist(rec->x1, rec->y1, rec->x2, rec->y2) * rec->width);
    }
    return true;
  }

  int width_ = 0, height_ = 0;
  std::vector<double> image_, angles_, modgrad_;
  std::vector<uint8_t> used_;
  std::vector<NormPoint> ordered_;
};

}  // namespace

extern "C" {

int64_t ingp_lsd_detect(const uint8_t* img, int64_t h, int64_t w, float* out,
                        int64_t cap) {
  std::vector<float> lines;
  Lsd((const uint8_t*)img, (int)h, (int)w).detect(&lines);
  int64_t n = (int64_t)lines.size() / 4;
  std::memcpy(out, lines.data(), sizeof(float) * 4 * std::min(n, cap));
  return n;
}

}  // extern "C"
