"""Complex error functions for Voigt line shapes, on complex torch tensors.

Counterpart of the JAX package's ``absorption/voigt.py``, expression for
expression: the production CEF is the Humlicek/Weideman combination
(HumlicekWeidemann32SDErrorFunction): Humlicek (1982) region II for
|x| + y >= 8, Weideman (1994, SIAM J. Numer. Anal. 31, eq. 38.I / Table I,
32 terms) otherwise. Regions are chosen with ``torch.where``, so every
branch is evaluated at every point, as ``jnp.where`` does in JAX. Inputs
are complex128 tensors on any device.
"""

import numpy as np
import torch

_SQRT_PI_INV = 1.0 / np.sqrt(np.pi)

# Weideman (1994) 32-term rational-approximation coefficients (Table I).
_WEIDEMAN32_A = np.array([
    2.5722534081245696e+00, 2.2635372999002676e+00, 1.8256696296324824e+00,
    1.3455441692345453e+00, 9.0192548936480144e-01, 5.4601397206393498e-01,
    2.9544451071508926e-01, 1.4060716226893769e-01, 5.7304403529837900e-02,
    1.9006155784845689e-02, 4.5195411053501429e-03, 3.9259136070122748e-04,
    -2.4532980269928922e-04, -1.3075449254548613e-04, -2.1409619200870880e-05,
    6.8210319440412389e-06, 4.4015317319048931e-06, 4.2558331390536872e-07,
    -4.1840763666294341e-07, -1.4813078891201116e-07, 2.2930439569075392e-08,
    2.3797557105844622e-08, 8.1248960947953431e-10, -3.2080150458594088e-09,
    -5.2310170266050247e-10, 4.1537465934749353e-10, 1.1658312885903929e-10,
    -5.5441820344468828e-11, -2.1542618451370239e-11, 8.0314997274316680e-12,
    3.7424975634801558e-12, -1.3031797863050087e-12])
_L32 = float(np.sqrt(32.0 / np.sqrt(2.0)))


def humlicek1(z):
    """Humlicek (1982) region I (|x|+y > 15)."""
    return 1j * _SQRT_PI_INV * z / (z * z - 0.5)


def humlicek2(z):
    """Humlicek (1982) region II."""
    t = z.imag - 1j * z.real
    u = t * t
    return (t * (1.410474 + u * _SQRT_PI_INV)) / (0.75 + u * (3.0 + u))


def _weideman(z, L, coeffs):
    """Weideman's rational approximation with ``coeffs`` (a_1..a_n),
    Horner-evaluated."""
    iz = 1j * z.real - z.imag
    rec = 1.0 / (L - iz)
    Z = (L + iz) * rec
    poly = torch.zeros_like(Z) + coeffs[-1]
    for a in coeffs[-2::-1]:
        poly = poly * Z + a
    return (_SQRT_PI_INV + 2.0 * poly * rec) * rec


def weideman32(z):
    """Weideman (1994) 32-term rational approximation."""
    return _weideman(z, _L32, _WEIDEMAN32_A)


def cef_humlicek_weideman32(z):
    """HumlicekWeidemann32SDErrorFunction (complex_error_functions.jl:255-263):
    Humlicek region II for |x|+y >= 8, Weideman-32 otherwise."""
    s = z.real.abs() + z.imag
    return torch.where(s >= 8.0, humlicek2(z), weideman32(z))


def humlicek_w4(z):
    """Full Humlicek (1982) w4 selector (regions I-IV)."""
    t = z.imag - 1j * z.real
    u = t * t
    w3 = ((16.4955 + t * (20.20933 + t * (11.96482 + t * (3.778987 + 0.5642236 * t))))
          / (16.4955 + t * (38.82363 + t * (39.27121 + t * (21.69274 + t * (6.699398 + t))))))
    nom = t * (36183.31 - u * (3321.99 - u * (1540.787 - u * (
        219.031 - u * (35.7668 - u * (1.320522 - u * .56419))))))
    den = 32066.6 - u * (24322.8 - u * (9022.23 - u * (
        2186.18 - u * (364.219 - u * (61.5704 - u * (1.84144 - u))))))
    w4 = torch.exp(u) - nom / den
    s = z.real.abs() + z.imag
    inner = torch.where(z.imag >= 0.195 * z.real.abs() - 0.176, w3, w4)
    return torch.where(s > 15.0, humlicek1(z),
                       torch.where(s > 5.5, humlicek2(z), inner))


# --- CPF12 (Humlicek 1979) ------------------------------------------------
# (complex_error_functions.jl:97-232: 12-pole rational approximation, with
# the exp(-x^2)-corrected variant in the far-wing low-y region.)
_CPF12_T = np.array([0.3142403762544, 0.9477883912402, 1.5976826351526,
                     2.2795070805011, 3.0206370251209, 3.88972489786978])
_CPF12_A = np.array([-1.393236997981977, -0.2311524061886763,
                     0.1553514656420944, -0.006218366236965554,
                     9.190829861057117e-5, 6.275259577e-7])
_CPF12_B = np.array([1.011728045548831, -0.7519714696746353,
                     0.01255772699323164, 0.01002200814515897,
                     -2.420681348155727e-4, 5.008480613664576e-7])


def cpf12a(z):
    """CPF12 region a: y > 0.85 or |x| < 18.1 y + 1.65."""
    x, y = z.real, z.imag
    ry = 1.5 + y
    ryy = ry * ry
    wk = torch.zeros_like(x)
    wl = torch.zeros_like(x)
    for t, a, b in zip(_CPF12_T, _CPF12_A, _CPF12_B):
        dm, dp = x - t, x + t
        qm, qp = dm * dm + ryy, dp * dp + ryy
        wk = wk + (a * dm + b * ry) / qm - (a * dp - b * ry) / qp
        wl = wl + (b * dm - a * ry) / qm + (b * dp + a * ry) / qp
    return wk + 1j * wl


def cpf12b(z):
    """CPF12 region b: exp(-x^2) + correction terms (far wing, small y)."""
    x, y = z.real, z.imag
    cr, crr = 1.5, 2.25
    ry = cr + y
    y2r = y + 2 * cr
    rry = cr * ry
    ryry = ry * ry
    wk = torch.zeros_like(x)
    wl = torch.zeros_like(x)
    for t, a, b in zip(_CPF12_T, _CPF12_A, _CPF12_B):
        dm, dp = x - t, x + t
        dm2, dp2 = dm * dm, dp * dp
        wk = wk + (b * (dm2 - rry) - a * dm * y2r) / ((dm2 + crr) * (dm2 + ryry)) \
            + (b * (dp2 - rry) + a * dp * y2r) / ((dp2 + crr) * (dp2 + ryry))
        wl = wl + (b * dm - a * ry) / (dm2 + ryry) \
            + (b * dp + a * ry) / (dp2 + ryry)
    return torch.exp(-x * x) + y * wk + 1j * wl


def cef_cpf12(z):
    """CPF12ErrorFunction (complex_error_functions.jl:224-232)."""
    in_a = (z.real.abs() < 18.1 * z.imag + 1.65) | (z.imag > 0.85)
    return torch.where(in_a, cpf12a(z), cpf12b(z))


# --- erfc-based family ----------------------------------------------------
def weideman_coeffs(n: int) -> np.ndarray:
    """Weideman (1994) rational-approximation coefficients, eq. (38.I), by
    FFT (the published Table I values for n = 32 reproduce to ~1e-15).
    Ascending order a_1..a_n, as the Horner loop of ``weideman32`` takes
    them."""
    m = 2 * n
    L = np.sqrt(n / np.sqrt(2.0))
    k = np.arange(-m + 1, m)
    theta = k * np.pi / m
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t * t) * (L * L + t * t)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return a[1:n + 1]


_WEIDEMAN64_A = weideman_coeffs(64)
_L64 = float(np.sqrt(64.0 / np.sqrt(2.0)))


def weideman64(z):
    """64-term Weideman Faddeeva function: erfcx(-iz) to ~1e-14 for y >= 0,
    the stand-in for the reference's erfc-based CEFs
    (complex_error_functions.jl:270-300)."""
    return _weideman(z, _L64, _WEIDEMAN64_A)


CEFS = {
    "HumlicekWeidemann32SDErrorFunction": cef_humlicek_weideman32,
    "HumlicekWeidemann32VoigtErrorFunction":
        lambda z: torch.where(z.real.abs() + z.imag > 15.0,
                              humlicek1(z), weideman32(z)),
    "HumlicekErrorFunction": humlicek_w4,
    "CPF12ErrorFunction": cef_cpf12,
    "ErfcErrorFunction": weideman64,
    "ErfcHumliErrorFunctionVoigt":
        lambda z: torch.where(z.real.abs() + z.imag > 15.0,
                              humlicek1(z), weideman64(z)),
    "ErfcHumliErrorFunctionSD":
        lambda z: torch.where(z.real.abs() + z.imag >= 8.0,
                              humlicek2(z), weideman64(z)),
}
