// Native Mie scattering core (Bohren–Huffman series), host C++.
//
// The port's own copy of the JAX package's csrc/miecore.cpp: Mie
// coefficients via the downward logarithmic-derivative recurrence and the
// S1/S2 angular sums over many scattering angles, for the host-side phase
// table builds of the log-normal and monodisperse Mie models.  No device
// kernel: the tables are built once per scenario on the host, as in the
// JAX package.  Exposed as a plain C ABI consumed through ctypes
// (sos_rt_tpu_torch/models/_native.py); results must match the NumPy twin
// in sos_rt_tpu_torch/models/miecore.py to ~1e-12 (tests/test_torch_mie.py).
//
// Build (done at first use by _native.py):
//   g++ -O3 -shared -fPIC -o libsosmie.so miecore.cpp

#include <cmath>
#include <complex>
#include <cstdint>
#include <vector>

using cd = std::complex<double>;

extern "C" {

// Number of series terms (Wiscombe criterion).
int64_t mie_nstop(double x) {
    return (int64_t)std::ceil(x + 4.05 * std::cbrt(x) + 2.0);
}

// Mie coefficients a_n, b_n for n = 1..nmax (arrays of length nmax).
void mie_ab(double m_re, double m_im, double x, int64_t nmax,
            double* a_re, double* a_im, double* b_re, double* b_im) {
    const cd m(m_re, m_im);
    const cd mx = m * x;
    const int64_t nmx = std::max<int64_t>(nmax, (int64_t)std::abs(mx)) + 16;

    std::vector<cd> d(nmx + 1, cd(0.0, 0.0));
    for (int64_t n = nmx; n >= 1; --n) {
        const cd nn = cd((double)n, 0.0);
        d[n - 1] = nn / mx - 1.0 / (d[n] + nn / mx);
    }

    double psi_nm1 = std::cos(x), psi_n = std::sin(x);
    double chi_nm1 = -std::sin(x), chi_n = std::cos(x);
    cd xi_n(psi_n, -chi_n);
    for (int64_t n = 1; n <= nmax; ++n) {
        const double fn = (2.0 * n - 1.0) / x;
        const double psi = fn * psi_n - psi_nm1;
        const double chi = fn * chi_n - chi_nm1;
        const cd xi(psi, -chi);
        const cd da = d[n] / m + (double)n / x;
        const cd db = d[n] * m + (double)n / x;
        const cd a = (da * psi - psi_n) / (da * xi - xi_n);
        const cd b = (db * psi - psi_n) / (db * xi - xi_n);
        a_re[n - 1] = a.real();
        a_im[n - 1] = a.imag();
        b_re[n - 1] = b.real();
        b_im[n - 1] = b.imag();
        psi_nm1 = psi_n; psi_n = psi;
        chi_nm1 = chi_n; chi_n = chi;
        xi_n = xi;
    }
}

// S1(µ), S2(µ) sums over the series for n_mu angles.
// s{1,2}_{re,im} are output arrays of length n_mu.
void mie_s1s2(const double* a_re, const double* a_im,
              const double* b_re, const double* b_im, int64_t nmax,
              const double* mu, int64_t n_mu,
              double* s1_re, double* s1_im, double* s2_re, double* s2_im) {
    for (int64_t k = 0; k < n_mu; ++k) {
        const double u = mu[k];
        double pi_nm1 = 0.0, pi_n = 1.0;
        cd s1(0.0, 0.0), s2(0.0, 0.0);
        for (int64_t n = 1; n <= nmax; ++n) {
            const double tau_n = n * u * pi_n - (n + 1) * pi_nm1;
            const double f = (2.0 * n + 1.0) / (double)(n * (n + 1));
            const cd a(a_re[n - 1], a_im[n - 1]);
            const cd b(b_re[n - 1], b_im[n - 1]);
            s1 += f * (a * pi_n + b * tau_n);
            s2 += f * (a * tau_n + b * pi_n);
            const double pi_next =
                ((2.0 * n + 1.0) * u * pi_n - (n + 1) * pi_nm1) / (double)n;
            pi_nm1 = pi_n; pi_n = pi_next;
        }
        s1_re[k] = s1.real(); s1_im[k] = s1.imag();
        s2_re[k] = s2.real(); s2_im[k] = s2.imag();
    }
}

// (Qext, Qsca, Qback, g) from the coefficient arrays.
void mie_efficiencies(const double* a_re, const double* a_im,
                      const double* b_re, const double* b_im, int64_t nmax,
                      double x, double* out4) {
    double qext = 0.0, qsca = 0.0, gq = 0.0;
    cd back(0.0, 0.0);
    for (int64_t n = 1; n <= nmax; ++n) {
        const cd a(a_re[n - 1], a_im[n - 1]);
        const cd b(b_re[n - 1], b_im[n - 1]);
        const double tn = 2.0 * n + 1.0;
        qext += tn * (a.real() + b.real());
        qsca += tn * (std::norm(a) + std::norm(b));
        back += tn * ((n % 2) ? -1.0 : 1.0) * (a - b);
        gq += tn / (double)(n * (n + 1)) * (a * std::conj(b)).real();
        if (n < nmax) {
            const cd a1(a_re[n], a_im[n]);
            const cd b1(b_re[n], b_im[n]);
            gq += (double)(n * (n + 2)) / (double)(n + 1)
                  * ((a * std::conj(a1)).real() + (b * std::conj(b1)).real());
        }
    }
    const double x2 = x * x;
    out4[0] = 2.0 / x2 * qext;
    out4[1] = 2.0 / x2 * qsca;
    out4[2] = std::norm(back) / x2;
    out4[3] = (out4[1] > 0.0) ? (4.0 / x2 * gq) / out4[1] : 0.0;
}

}  // extern "C"
